"""Invariant guards (the reference's panic layer)."""
