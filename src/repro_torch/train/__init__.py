"""Training substrate: optimizer, state, step, compression."""
