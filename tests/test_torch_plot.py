"""The port's plots (rssync_tpu_torch/analysis/plot.py) on the CPU with
matplotlib's Agg backend: PNGs written, the SyncQuality of plot_sync
equal to rssync_tpu's on the same CSV, and the CLI's `main`."""

import numpy as np
import pytest

from rssync_tpu_torch.analysis import SyncQuality, sync_rmse_from_csv
from rssync_tpu_torch.analysis import plot as P

pytest.importorskip("matplotlib")


@pytest.fixture
def sync_csv(tmp_path):
    """tests/test_aux.py's drifting sync CSV (frame, delay_ms)."""
    frames = np.arange(0, 600, 60)
    delays = 3.0 + 0.002 * frames + np.sin(frames * 0.1) * 0.05
    path = tmp_path / "sync.csv"
    np.savetxt(path, np.column_stack([frames, delays]), delimiter=",")
    return path


def test_plot_sync_and_any_write_pngs(sync_csv, tmp_path):
    out = tmp_path / "sync.png"
    q = P.plot_sync(str(sync_csv), fps=30.0, out_path=str(out))
    assert isinstance(q, SyncQuality)
    assert out.exists() and out.stat().st_size > 1000
    assert q.rmse < 0.1
    same = sync_rmse_from_csv(str(sync_csv))
    assert (q.slope, q.intercept, q.rmse) == (same.slope, same.intercept, same.rmse)
    out2 = tmp_path / "any.png"
    P.plot_any(str(sync_csv), out_path=str(out2))
    assert out2.exists() and out2.stat().st_size > 1000


def test_plot_sync_quality_equals_jax(sync_csv, tmp_path):
    pytest.importorskip("jax")
    from rssync_tpu.analysis.plot import plot_sync as jax_plot_sync

    got = P.plot_sync(str(sync_csv), fps=30.0, out_path=str(tmp_path / "a.png"))
    want = jax_plot_sync(str(sync_csv), fps=30.0, out_path=str(tmp_path / "b.png"))
    assert got.rmse == want.rmse and got.slope == want.slope
    assert got.intercept == want.intercept
    np.testing.assert_array_equal(got.residuals, want.residuals)


@pytest.mark.parametrize("cmd", ["sync", "any"])
def test_main_writes_png(sync_csv, tmp_path, cmd):
    out = tmp_path / f"{cmd}.png"
    argv = [cmd, str(sync_csv), "--out", str(out)]
    if cmd == "sync":
        argv += ["--fps", "60"]
    assert P.main(argv) == 0
    assert out.exists() and out.stat().st_size > 1000
