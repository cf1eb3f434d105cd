"""Synthetic engine problems with a known delay, for tests and smoke runs."""
