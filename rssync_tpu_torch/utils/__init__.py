"""Invariant guards (the reference's panic layer), stage timings, the
span and counter recorder, and the track cache."""
