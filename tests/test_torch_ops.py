"""Parity of the PyTorch port's ops (quaternions, robust helpers, spline
evaluation) with rssync_tpu's, on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rssync_tpu.ops import quat as jquat
from rssync_tpu.ops import robust as jrobust
from rssync_tpu.ops import spline as jspline
from rssync_tpu_torch.ops import quat as tquat
from rssync_tpu_torch.ops import robust as trobust
from rssync_tpu_torch.ops import spline as tspline
from rssync_tpu_torch.utils.checks import SyncPanic, check_finite, check_monotonic

torch.set_num_threads(2)

#: float32 elementwise math on O(1) values; the two frameworks may
#: round transcendental functions and fused products differently
ATOL = 1e-6


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[0] = [1.0, 0.0, 0.0, 0.0]      # identity
    q[1] = [-0.3, 0.5, -0.2, 0.78]   # w < 0
    return q.astype(np.float32)


def test_axis_angle_roundtrip_matches_jax():
    rng = np.random.default_rng(1)
    aa = rng.normal(size=(32, 3)).astype(np.float32)
    aa[0] = 0.0  # the small-angle branch
    aa[1] = [1e-20, 0.0, 0.0]
    np.testing.assert_allclose(
        tquat.from_axis_angle(_t(aa)).numpy(),
        np.asarray(jquat.from_axis_angle(jnp.asarray(aa))), atol=ATOL,
    )
    q = _quats(rng, 32)
    np.testing.assert_allclose(
        tquat.to_axis_angle(_t(q)).numpy(),
        np.asarray(jquat.to_axis_angle(jnp.asarray(q))), atol=ATOL,
    )


@pytest.mark.parametrize("name", ["mul", "rotate_point"])
def test_binary_quat_ops_match_jax(name):
    rng = np.random.default_rng(2)
    p = _quats(rng, 32)
    if name == "mul":
        q = _quats(rng, 32)[::-1].copy()
    else:
        p = p * 1.3  # non-unit q scales by |q|^2, as in the reference
        q = rng.normal(size=(32, 3)).astype(np.float32)
    got = getattr(tquat, name)(_t(p), _t(q)).numpy()
    want = np.asarray(getattr(jquat, name)(jnp.asarray(p), jnp.asarray(q)))
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("name", ["conj", "normalize"])
def test_unary_quat_ops_match_jax(name):
    q = _quats(np.random.default_rng(3), 16) * 2.5
    got = getattr(tquat, name)(_t(q)).numpy()
    want = np.asarray(getattr(jquat, name)(jnp.asarray(q)))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_slerp_matches_jax():
    rng = np.random.default_rng(4)
    p = _quats(rng, 24)
    q = _quats(rng, 24)
    q[2] = -p[2]        # antipodal: flipped, then identical
    q[3] = p[3]         # theta == 0: the lerp fallback
    t = rng.uniform(0, 1, size=24).astype(np.float32)
    got = tquat.slerp(_t(p), _t(q), _t(t)).numpy()
    want = np.asarray(jquat.slerp(jnp.asarray(p), jnp.asarray(q), jnp.asarray(t)))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_robust_helpers_match_jax():
    rng = np.random.default_rng(5)
    v = rng.normal(size=(10, 3)).astype(np.float32)
    v[0] = 1e-14  # below the safe_normalize threshold: left as is
    k = np.asarray([0.5, 10.0, 55.0, 1e3, 5e4], np.float32)
    np.testing.assert_array_equal(
        trobust.clamp_k(_t(k)).numpy(), np.asarray(jrobust.clamp_k(jnp.asarray(k))))
    np.testing.assert_allclose(
        trobust.safe_normalize(_t(v)).numpy(),
        np.asarray(jrobust.safe_normalize(jnp.asarray(v))), atol=ATOL)
    np.testing.assert_allclose(
        trobust.safe_norm(_t(v), dim=-1).numpy(),
        np.asarray(jrobust.safe_norm(jnp.asarray(v), axis=-1)), atol=ATOL)


def _packed_table(n=24):
    """Spline table of a smooth random quaternion path (host f64 fit)."""
    rng = np.random.default_rng(6)
    t = np.arange(n) / 10.0
    y = np.stack([np.cos(t * (1 + r)) + 0.1 * rng.normal() for r in range(4)])
    packed = jspline.pack_table(jspline.fit_natural_cubic(y))
    np.testing.assert_array_equal(
        packed, tspline.pack_table(tspline.fit_natural_cubic(y)))
    return packed.astype(np.float32)


def test_eval_spline_packed_matches_jax_with_extrapolation():
    """Interior, x < 0, n-2 < x < n and x >= n (the reference's jump at
    x == n), with the position split as int32 base + f32 offset."""
    packed = _packed_table()
    n = packed.shape[1]
    x = np.concatenate([
        np.linspace(-3.7, -0.01, 7),           # below the table
        np.linspace(0.0, n - 2.0, 13),         # interior
        np.linspace(n - 1.99, n - 0.01, 9),    # last segment
        [n, n + 0.25, n + 1.5, n + 3.9],       # past the end
    ])
    i0 = np.floor(x).astype(np.int32) - 2
    p = (x - i0).astype(np.float32)
    got = tspline.eval_spline_packed(
        torch.as_tensor(packed), torch.as_tensor(i0), torch.as_tensor(p)).numpy()
    want = np.asarray(jspline.eval_spline_packed(
        jnp.asarray(packed), jnp.asarray(i0), jnp.asarray(p)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=ATOL)


def test_checks_raise_sync_panic():
    check_finite("ok", [1.0, 2.0])
    with pytest.raises(SyncPanic, match="rays"):
        check_finite("rays", [1.0, np.nan])
    with pytest.raises(SyncPanic, match="out of order at pos 2"):
        check_monotonic("ts", np.asarray([1, 2, 1]))
