"""Fail-fast invariant guards.

Rebuild of the reference's `panic_to_file` layer
(ref: src/core_support/panic.cpp:7-15 and its 9 call sites in
src/core/core_private.cpp): on violated invariants the reference writes
`panic.txt`, asserts and exits. Here the same contract is a raised
Python exception at stage boundaries (host-side, where data enters or
leaves the device), per SURVEY §5.3.
"""

from __future__ import annotations

import numpy as np


class SyncPanic(RuntimeError):
    """Invariant violation — equivalent of the reference's panic_to_file."""


def check_finite(name: str, arr) -> None:
    """Raise unless every element of `arr` is finite
    (ref: core_private.cpp:76-83, 186-188, 199-202)."""
    a = np.asarray(arr)
    if not np.all(np.isfinite(a)):
        raise SyncPanic(f"non-finite numbers in {name}")


def check_monotonic(name: str, ts) -> None:
    """Raise if timestamps decrease
    (ref: core_private.cpp:157-164)."""
    t = np.asarray(ts)
    bad = np.nonzero(t[:-1] > t[1:])[0]
    if bad.size:
        i = int(bad[0]) + 1
        raise SyncPanic(
            f"{name}: timestamps out of order at pos {i} "
            f"({t[i - 1]} > {t[i]})"
        )
