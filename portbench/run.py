"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with as many CUDA cards as
the cell asks for; without them it exits 1 and prints no result. Sets
up (renders the cell's frames from the seed, one warm-up request),
runs one closed-loop client for `--seconds` seconds, then compares
every request's answers with the plain reference. The last line on
stdout is one JSON object (`correct`, `attempted`, `failed`, `metrics`,
`device`, with --trace 1 `breakdown`, and `checks`: each number
compared with its limit); the last lines on stderr are the same
checks. --trace 0 reports the cell's end-to-end metrics, --trace 1 its
per-layer metrics.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: compile caches at fixed paths inside the checkout, so that only the
#: first run in a checkout compiles (the port builds its CUDA kernels
#: into rssync_tpu_torch/build/ itself)
CACHE = ROOT / "portbench" / ".cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    cell = harness.find_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s), found {n}",
              file=sys.stderr)
        return 1
    out = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0",
                      ROOT, T_PROCESS)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
