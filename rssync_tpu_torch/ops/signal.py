"""Gyro-signal DSP: zero-phase low-pass, upsample, decimate, and
rate-rounding linear resample (ref: src/core_support/signal.cpp:3-85).

In the reference only `gyro_interpolate` is reachable (from the driver's
disabled fixed-rate path, core_testcode.cpp:20-35); the four are the
public math surface. Signals are (C, N), channels x time, and are
computed in their own dtype on their own device. The biquad recurrence
runs sample by sample over time, vectorized over channels, in the order
of rssync_tpu's `lax.scan` (the feed-forward sum is formed for all
samples at once first: it does not depend on the output). Forward plus
time-reversed passes give the reference's zero-phase response.
"""

from __future__ import annotations

import numpy as np
import torch


def _biquad_coeffs(divider: int):
    """2nd-order Butterworth-flavored low-pass at f_nyquist/divider
    (ref: signal.cpp:5-9)."""
    ita = 1.0 / np.tan(np.pi / divider)
    q = np.sqrt(2.0)
    b0 = 1.0 / (1.0 + q * ita + ita * ita)
    b1 = 2.0 * b0
    b2 = b0
    a1 = 2.0 * (ita * ita - 1.0) * b0
    a2 = -(1.0 - q * ita + ita * ita) * b0
    return b0, b1, b2, a1, a2


def _biquad_forward(x: torch.Tensor, coeffs) -> torch.Tensor:
    """One causal pass, y[i] = b.x + a1 y[i-1] + a2 y[i-2], channels
    vectorized; the first two outputs are the inputs (ref
    signal.cpp:11-13). Coefficients are rounded to x's dtype first, as
    JAX rounds its weakly typed Python scalars."""
    b0, b1, b2, a1, a2 = (
        torch.tensor(c, dtype=torch.float64).to(x.dtype).item() for c in coeffs
    )
    if x.shape[1] <= 2:
        return x.clone()
    # (b0 x_i + b1 x_{i-1}) + b2 x_{i-2}, the scan's first three terms
    ff = b0 * x[:, 2:] + b1 * x[:, 1:-1] + b2 * x[:, :-2]
    ys = [x[:, 0], x[:, 1]]
    for i in range(ff.shape[1]):
        ys.append(ff[:, i] + a1 * ys[-1] + a2 * ys[-2])
    return torch.stack(ys, dim=1)


def gyro_lowpass(samples: torch.Tensor, divider: int) -> torch.Tensor:
    """Zero-phase low-pass: forward + time-reversed biquad
    (ref: signal.cpp:3-31). samples: (C, N); divider < 2 is identity.

    The reference filters in place with a two-sample write lag
    (``samples.col(i-2) = out[0]``), so after the forward pass the last
    two columns remain raw inputs and seed the reverse pass, and the
    reverse pass never overwrites the first/last two columns either:
    output = [x0, x1, filtered..., x_{N-2}, x_{N-1}].
    """
    samples = torch.as_tensor(samples)
    if divider < 2 or samples.shape[1] < 5:
        return samples  # the reference's loop bodies degenerate below 5
    coeffs = _biquad_coeffs(divider)
    fwd = _biquad_forward(samples, coeffs)
    fwd[:, -2:] = samples[:, -2:]
    rev = _biquad_forward(fwd.flip(1), coeffs).flip(1)
    return torch.cat([samples[:, :2], rev[:, 2:-2], samples[:, -2:]], dim=1)


def gyro_upsample(samples: torch.Tensor, multiplier: int) -> torch.Tensor:
    """Zero-stuffing upsample + low-pass at the new Nyquist/(4*mult)
    (ref: signal.cpp:33-51). Like the reference, the pass-band gain is
    not compensated: zero-stuffing divides it by `multiplier`."""
    samples = torch.as_tensor(samples)
    if multiplier < 2:
        return samples
    C, N = samples.shape
    out = samples.new_zeros((C, N * multiplier))
    half = multiplier // 2
    # the reference keeps samples where (i + mult/2) % mult == 0
    out[:, (multiplier - half) % multiplier::multiplier] = samples
    return gyro_lowpass(out, multiplier * 4)


def gyro_decimate(samples: torch.Tensor, divider: int) -> torch.Tensor:
    """Keep every divider-th sample (no pre-filter: the reference
    decimates raw, signal.cpp:53-60)."""
    samples = torch.as_tensor(samples)
    if divider < 2:
        return samples
    return samples[:, ::divider]


def gyro_interpolate(
    timestamps: np.ndarray, gyro: np.ndarray
) -> tuple[np.ndarray, np.ndarray, int]:
    """Linear resample of (3, N) rate data onto a uniform grid at the
    mean rate rounded to the nearest 50 Hz (ref: signal.cpp:62-85).
    Host float64 (ingest path). Returns (new_timestamps (M,),
    new_gyro (3, M), rounded_rate_hz)."""
    ts = np.asarray(timestamps, np.float64).reshape(-1)
    g = np.asarray(gyro, np.float64)
    actual_sr = ts.size / (ts[-1] - ts[0])
    rounded_sr = int(round(actual_sr / 50.0) * 50)
    first = np.ceil(ts[0] * rounded_sr)
    new_ts = []
    s = first
    while s / rounded_sr < ts[-1]:
        new_ts.append(s / rounded_sr)
        s += 1.0
    new_ts = np.asarray(new_ts)
    new_g = np.stack([np.interp(new_ts, ts, g[r]) for r in range(g.shape[0])])
    return new_ts, new_g, rounded_sr
