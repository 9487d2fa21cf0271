"""The single-device part of ``repro/sharding/rules.py``.

The JAX package maps logical activation axes onto the ambient device mesh.
Off a mesh its ``constrain`` returns its input unchanged and ``dp_size`` /
``tp_size`` return 1 (``repro/sharding/rules.py:222-249``); the port runs
its models on one device, so that is all of their behaviour here.  The
models call ``constrain`` where JAX's do, so the mesh rules (ROADMAP
A.13c) fill in one module.
"""
from __future__ import annotations


def dp_size() -> int:
    """Size of the data-parallel axes: 1 on one device."""
    return 1


def tp_size() -> int:
    """Size of the model axis: 1 on one device."""
    return 1


def constrain(x, rule: str):
    """JAX's sharding constraint for activations of kind ``rule``; the
    identity on one device."""
    return x
