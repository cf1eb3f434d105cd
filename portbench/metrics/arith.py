"""The benchmark's arithmetic: statistics over requests, the device's
busy time from a trace, and the work a request needs of kernels K2
and K3, each counted from the request's shapes.

Copied, not imported, from the program's tools so that a later change
to the program cannot move the yardstick:
- `union_s`: the union of device intervals of
  `rssync_tpu_torch/testing/profile_engine.py::_union_us`;
- `bound_s`, `score_ops_s`: chip_smoke.py's `bound` and `score_bound`
  (H100 SXM peaks at 700 W, operations at the peak of their type);
- `k3_bytes`: `rssync_tpu_torch/testing/profile_strips.py::strips_bytes`;
- `strip_covered_blocks`: the strip placement of
  `rssync_tpu_torch/frontend/tracking.py::_lk_iterate`.
"""

from __future__ import annotations

import math
import statistics

#: published H100 SXM peaks at 700 W: HBM bytes/s; operations/s outside
#: the tensor cores in float32 and bfloat16
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
BF16_OPS_S = 133.8e12
#: operations per (row, hypothesis, valid feature) of the RANSAC
#: scoring (K1/K2), each with the peak of its type: the residual, its
#: square, the tree sum and the max in float32; one bf16 quantization;
#: 12 compare-and-count rounds of 2 in bf16
SCORE_OPS = ((8, F32_OPS_S), (1, BF16_OPS_S), (24, BF16_OPS_S))

#: the search strip: rows (the largest fine-level window plus the
#: <= 7-row residual of quantizing its top row to 8) and 128-byte lanes
STRIP_ROWS = 40
LANE = 128
#: bottom rows of edge padding a fine level carries
STRIP_PAD = 24


def percentile(values, q: int) -> float:
    """The q-th percentile of all values (linear between order
    statistics, both ends included)."""
    vals = sorted(values)
    if len(vals) == 1:
        return float(vals[0])
    return float(statistics.quantiles(vals, n=100, method="inclusive")[q - 1])


def per_request(window_s: float, completed: int) -> float | None:
    """Seconds of the window over the requests completed in it."""
    return window_s / completed if completed else None


def union_s(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    busy, reach = 0.0, -math.inf
    for start, end in sorted(intervals):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy


def idle_gaps(intervals, t0: float, t1: float) -> list[tuple[float, float]]:
    """The (start, end) stretches of [t0, t1] that no interval covers."""
    gaps, reach = [], t0
    for start, end in sorted(intervals):
        if start > reach:
            gaps.append((reach, min(start, t1)))
        reach = max(reach, end)
        if reach >= t1:
            break
    if reach < t1:
        gaps.append((reach, t1))
    return [g for g in gaps if g[1] > g[0]]


def bound_s(n_bytes: float, n_ops: float, ops_s: float = F32_OPS_S) -> float:
    """The least seconds the card could take: bytes over the HBM rate or
    operations over `ops_s`, whichever is longer."""
    return max(n_bytes / HBM_BYTES_S, n_ops / ops_s)


def score_ops_s(rows: int, hypotheses: int, valid_features: int, features: int) -> float:
    """bound_s of the RANSAC scoring of `rows` rows of `features`
    slots, `valid_features` valid in all, against `hypotheses`
    hypotheses each: every input read once, the output written once,
    SCORE_OPS for each (row, hypothesis, valid feature)."""
    n_bytes = 4 * (3 * rows * features + 3 * rows * hypotheses + rows + rows * hypotheses)
    n_feat = hypotheses * valid_features
    n = sum(k for k, _ in SCORE_OPS)
    return bound_s(n_bytes, n * n_feat, n / sum(k / rate for k, rate in SCORE_OPS))


def k3_bytes(covered_blocks: int, pairs: int, points: int, itemsize: int = 1) -> int:
    """Bytes the strip fetch must move for `pairs` pairs of `points`
    strips: every image lane block the strips cover read once, the
    strips written once, the indices read."""
    return (covered_blocks * LANE * itemsize + pairs * points * STRIP_ROWS * 2 * LANE * itemsize
            + 4 * (2 * pairs * points + pairs))


def level_dims(height: int, width: int, level: int) -> tuple[int, int]:
    """Stored (rows, lane blocks) of a fine pyramid level: the logical
    size halved per level, rows padded by STRIP_PAD to a multiple of 8,
    the width to whole lanes."""
    h, w = height, width
    for lvl in range(level):
        h, w = (h // 2, w // 2) if lvl == 0 else ((h - 1) // 2 + 1, (w - 1) // 2 + 1)
    return -(-(h + STRIP_PAD) // 8) * 8, -(-w // LANE)


def strip_covered_blocks(points, height: int, width: int, level: int, radius: int,
                         margin: int) -> int:
    """Lane blocks one pair's strips cover at `level` when each point's
    search region sits at the point itself (zero motion): top row
    floor(y / 2^level) - radius - margin quantized down to 8, leftmost
    block floor(x / 2^level - radius - margin) / 128, both clamped so
    the 40-row, 2-block strip stays inside the stored level."""
    Hp, NB = level_dims(height, width, level)
    scale = 2.0 ** level
    blocks = set()
    for x, y in points:
        oy = math.floor(y / scale) - (radius + margin)
        ox = math.floor(x / scale) - (radius + margin)
        oyq = min(max(oy // 8, 0), (Hp - STRIP_ROWS) // 8)
        obx = min(max(ox // LANE, 0), NB - 2)
        for r in range(8 * oyq, 8 * oyq + STRIP_ROWS):
            blocks.add((r, obx))
            blocks.add((r, obx + 1))
    return len(blocks)
