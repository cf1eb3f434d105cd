"""Lens-profile text database loader.

Rebuild of `lens_load` (ref: src/core_testcode.cpp:164-181; format
README.md:52-60): whitespace-separated rows

    <name> <readout_s> <fx> <fy> <cx> <cy> <k1> <k2> <k3> <k4>

The reference scans linearly and stops at the first matching preset; so
does this. A copy of rssync_tpu/frontend/lens_profiles.py onto the
port's `ops/lens.Lens`.
"""

from __future__ import annotations

from rssync_tpu_torch.ops.lens import Lens


def load_lens_profile(path: str, preset_name: str) -> Lens:
    with open(path, "r") as f:
        tokens = f.read().split()
    i = 0
    while i + 10 <= len(tokens):
        name = tokens[i]
        vals = [float(v) for v in tokens[i + 1 : i + 10]]
        if name == preset_name:
            return Lens(
                ro=vals[0], fx=vals[1], fy=vals[2], cx=vals[3], cy=vals[4],
                k1=vals[5], k2=vals[6], k3=vals[7], k4=vals[8],
            )
        i += 10
    raise RuntimeError(f"Could not load preset {preset_name!r} from {path}")
