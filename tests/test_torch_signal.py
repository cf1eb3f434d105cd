"""The port's gyro DSP (ops/signal.py) against rssync_tpu's on the same
float32 inputs, and tests/test_signal.py's behavioural checks on the
port."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rssync_tpu.ops import signal as jsignal
from rssync_tpu_torch.ops import signal

torch.set_num_threads(2)

#: float32 recurrences in the scan's order on both sides; XLA may contract
#: a product and a sum into one rounding, so outputs agree to a few ulps
#: of the filter's gain (measured: <= 3.2e-6 at divider 33 on unit noise)
RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture
def two_tone():
    """Low tone (2 Hz) + high tone (80 Hz) at 200 Hz sample rate."""
    t = np.arange(1000) / 200.0
    lo = np.sin(2 * np.pi * 2.0 * t)
    hi = np.sin(2 * np.pi * 80.0 * t)
    sig = np.stack([lo + hi, lo, hi])
    return t, lo, hi, sig


def _noise(n, seed=0):
    return np.random.default_rng(seed).normal(size=(3, n)).astype(np.float32)


@pytest.mark.parametrize("divider", [1, 2, 3, 8, 33])
@pytest.mark.parametrize("n", [4, 5, 6, 2000])
def test_lowpass_matches_jax(divider, n):
    x = _noise(n, seed=divider)
    want = np.asarray(jsignal.gyro_lowpass(jnp.asarray(x), divider))
    got = signal.gyro_lowpass(torch.tensor(x), divider)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # the two-sample write lag: the first and last two columns stay raw
    np.testing.assert_array_equal(got[:, :2].numpy(), x[:, :2])
    np.testing.assert_array_equal(got[:, -2:].numpy(), x[:, -2:])


@pytest.mark.parametrize("multiplier", [1, 2, 3, 4])
def test_upsample_matches_jax(multiplier):
    x = _noise(300, seed=multiplier)
    want = np.asarray(jsignal.gyro_upsample(jnp.asarray(x), multiplier))
    got = signal.gyro_upsample(torch.tensor(x), multiplier).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("divider", [1, 2, 4, 7])
def test_decimate_matches_jax(divider):
    x = _noise(101)
    want = np.asarray(jsignal.gyro_decimate(jnp.asarray(x), divider))
    np.testing.assert_array_equal(signal.gyro_decimate(torch.tensor(x), divider).numpy(), want)


def test_interpolate_matches_jax(rng):
    ts = np.cumsum(rng.uniform(0.8, 1.2, 2000)) / 213.0
    g = np.stack([np.sin(ts), np.cos(3 * ts), ts * 0.1])
    for got, want in zip(signal.gyro_interpolate(ts, g), jsignal.gyro_interpolate(ts, g)):
        np.testing.assert_array_equal(got, want)


def test_lowpass_keeps_low_kills_high(two_tone):
    t, lo, hi, sig = two_tone
    out = signal.gyro_lowpass(torch.tensor(sig, dtype=torch.float32), divider=8).numpy()
    mid = slice(200, 800)
    assert np.abs(out[1, mid] - lo[mid]).max() < 0.05
    assert np.abs(out[2, mid]).max() < 0.15 * np.abs(hi[mid]).max()


def test_lowpass_zero_phase(two_tone):
    t, lo, _, _ = two_tone
    out = signal.gyro_lowpass(torch.tensor(lo[None]), divider=8)[0].numpy()
    mid = slice(200, 800)
    lags = range(-5, 6)
    corr = [np.dot(out[mid], np.roll(lo, k)[mid]) for k in lags]
    assert lags[int(np.argmax(corr))] == 0


def test_lowpass_computes_in_the_input_dtype(two_tone):
    _, _, _, sig = two_tone
    x = torch.tensor(sig)  # float64
    out = signal.gyro_lowpass(x, divider=8)
    assert out.dtype == torch.float64
    np.testing.assert_allclose(
        out.numpy(), signal.gyro_lowpass(x.float(), divider=8).double().numpy(), atol=1e-5)


def test_upsample_reconstructs_samples(two_tone):
    t, lo, _, _ = two_tone
    out = signal.gyro_upsample(torch.tensor(lo[None, :200], dtype=torch.float32), 4).numpy()
    assert out.shape == (1, 800)
    # zero-stuffing divides the gain by the multiplier (the reference's
    # behaviour); after x4 the filtered signal reproduces the original
    # at the stuffing positions
    ks = np.arange(20, 180)
    np.testing.assert_allclose(4.0 * out[0, 4 * ks + 2], lo[ks], atol=0.1)


def test_interpolate_rounds_to_50hz(rng):
    ts = np.cumsum(rng.uniform(0.8, 1.2, 2000)) / 207.0  # ~207 Hz jittered
    g = np.stack([np.sin(ts), np.cos(ts), ts * 0.1])
    new_ts, new_g, rate = signal.gyro_interpolate(ts, g)
    assert rate == 200
    np.testing.assert_allclose(np.diff(new_ts), 1.0 / 200, atol=1e-12)
    np.testing.assert_allclose(new_g[0], np.sin(new_ts), atol=1e-4)
