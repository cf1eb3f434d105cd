"""Invariant guards (the reference's panic layer), stage timings and the
track cache."""
