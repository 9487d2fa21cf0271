"""Sharding hooks of the models (see rules.py)."""
