"""Plotting tools: sync-quality plot and generic CSV plot.

The reference's analysis layer (ref: python/plot_sync.py,
python/plot_any.py); a copy of rssync_tpu/analysis/plot.py. The sync
plot shows per-window gyro delay, its linear least-squares fit, and
|fit - measured| on twin axes with the RMSE annotated (the reference's
headline accuracy figure, thesis fig. 9-10); plot_any is a bare
column-0-vs-column-1 CSV plot used for DebugPreSync loss surfaces.

Usage:
    python -m rssync_tpu_torch.analysis.plot sync sync_GX012440.csv [--fps 60]
    python -m rssync_tpu_torch.analysis.plot any debug.csv
"""

from __future__ import annotations

import argparse

import numpy as np

from rssync_tpu_torch.analysis.metrics import sync_rmse


def plot_sync(csv_path: str, fps: float = 60.0, out_path: str | None = None,
              err_range: float = 2.0, delay_range: float = 10.0):
    """Delay + fit + |residual| plot with RMSE annotation
    (ref: plot_sync.py:11-50; fps was hardcoded 60 there)."""
    import matplotlib

    if out_path:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = np.loadtxt(csv_path, delimiter=",", ndmin=2)
    frames, delays_ms = data[:, 0], data[:, 1]
    q = sync_rmse(frames, delays_ms)
    fit = q.intercept + q.slope * frames
    tsec = frames / fps

    fig, ax1 = plt.subplots(figsize=(8, 4.5))
    ax2 = ax1.twinx()
    ax1.set_ylim(0, err_range)
    mid = 0.5 * (fit.min() + fit.max())
    ax2.set_ylim(mid - delay_range, mid + delay_range)

    l1 = ax1.plot(tsec, np.abs(q.residuals), color="green", alpha=0.3,
                  label="difference")[0]
    l2 = ax2.plot(tsec, fit, color="orange", alpha=0.7,
                  label="least squares fit on gyro delay")[0]
    l3 = ax2.plot(tsec, delays_ms, color="red", label="gyro delay")[0]

    ax1.set_xlabel("Video time (sec)")
    ax2.set_ylabel("Gyro delay (ms)")
    ax1.set_ylabel("Gyro delay error (ms)")
    ax2.grid(axis="y")
    ax1.grid(axis="x")
    ax1.legend(handles=[l1], loc="upper left")
    ax2.legend(handles=[l2, l3], loc="upper right")
    plt.text(0.8, -0.15, f"RMSE={q.rmse:.3f}", color="darkred", size=14,
             transform=ax1.transAxes)
    fig.tight_layout()
    print("rms error:", q.rmse)
    if out_path:
        fig.savefig(out_path, dpi=120)
        plt.close(fig)
    else:
        plt.show()
    return q


def plot_any(csv_path: str, out_path: str | None = None):
    """Column-0 vs column-1 plot (ref: plot_any.py) — used for
    DebugPreSync loss surfaces (debug.csv)."""
    import matplotlib

    if out_path:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = np.loadtxt(csv_path, delimiter=",", ndmin=2)
    fig, ax = plt.subplots()
    ax.plot(data[:, 0], data[:, 1])
    ax.set_xlabel("column 0")
    ax.set_ylabel("column 1")
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=120)
        plt.close(fig)
    else:
        plt.show()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rssync_tpu_torch.analysis.plot")
    sub = ap.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("sync", help="sync-quality plot + RMSE")
    ps.add_argument("csv")
    ps.add_argument("--fps", type=float, default=60.0)
    ps.add_argument("--out", default=None)
    pa = sub.add_parser("any", help="generic 2-column CSV plot")
    pa.add_argument("csv")
    pa.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.cmd == "sync":
        plot_sync(args.csv, fps=args.fps, out_path=args.out)
    else:
        plot_any(args.csv, out_path=args.out)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
