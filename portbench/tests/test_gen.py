"""The frozen generator against the port's renderer it was copied from."""

import numpy as np
import pytest
import torch

from portbench.gen import synthclip
from rssync_tpu_torch.testing.synthvideo import make_clip


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_frames_and_gyro_bit_equal_to_make_clip(seed):
    kw = dict(fps=30.0, width=96, height=72)
    clip = make_clip(seed=seed, true_delay=0.031, n_frames=6, readout=0.01111, pad=2.0,
                     device="cpu", **kw)
    idx = [1, 4, 5]
    got = synthclip.render_frames(seed, idx, kw["fps"], kw["width"], kw["height"], 0.01111,
                                  "cpu")
    assert torch.equal(got, clip.frames[idx])
    ts, rates = synthclip.gyro_log(seed, 6 / 30.0, 0.031, 2.0, 200.0)
    np.testing.assert_array_equal(ts, clip.gyro_ts)
    np.testing.assert_array_equal(rates, clip.gyro_rates)
    lens = synthclip.hero6_lens(96, 72, 0.01111)
    assert tuple(vars(lens).values()) == tuple(vars(clip.lens).values())


def test_drift_is_a_slower_gyro_clock():
    """At drift k, gyro sample i shows render time (i / rate - d0) /
    (1 + k): the steady log of a clock ticking at rate * (1 + k) with
    delay d0 / (1 + k), its rates per gyro second scaled by 1 / (1 + k)."""
    k, d, pad, rate = 1e-2, 0.03, 2.0, 200.0
    _, drifting = synthclip.gyro_log(3, 2.0, d, pad, rate, drift=k)
    _, steady = synthclip.gyro_log(3, 2.0, (d + pad / 2) / (1 + k) - pad / 2, pad,
                                   rate * (1 + k))
    np.testing.assert_allclose(drifting[1:300], steady[1:300] / (1 + k), rtol=1e-3, atol=1e-5)
