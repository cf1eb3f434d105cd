"""The hybrid chunk structure of the port's chunked tracker
(`lk_track_video_chunked(hybrid=True)`, rssync_tpu_torch/frontend/tracking.py)
on the CPU, on tests/test_tracking.py:270's case (9 frames of 260x400
random u8, 4-pair chunks, grid step 80):

- hybrid tracks are bit-identical to the block structure's: the hoisted
  pyramid and templates are per-frame math, and the level-0 strips
  fetched from the whole clip at per-pair frame indices are the rows
  the sliced block would hold;
- both are within TRACK_ATOL (2e-3 px, the port's tracker limit) of
  rssync_tpu's hybrid run;
- a spy on the strip fetch shows level 0 really read the whole clip
  with a `fidx` of `chunk` indices (the fallback is silent, so equal
  tracks alone could be block against block);
- points off the integer grid fail the predicate and take the block
  structure, in the port and in rssync_tpu.
"""

import numpy as np
import pytest
import torch

from rssync_tpu_torch.frontend import tracking as T

torch.set_num_threads(2)

TRACK_ATOL = 2e-3
H, W, CHUNK, STEP = 260, 400, 4, 80


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(0).integers(0, 255, (9, H, W)).astype(np.uint8)


def _spy(monkeypatch, calls):
    """Record (frames in the image, fidx or None) of every strip and
    block fetch the tracker makes."""
    strips, blocks = T.gather_strips, T.gather_blocks

    def note(imgs, fidx):
        calls.append((imgs.shape[0], None if fidx is None else fidx.tolist()))

    def spy_strips(imgs, oyq, obx, fidx=None):
        note(imgs, fidx)
        return strips(imgs, oyq, obx, fidx)

    def spy_blocks(imgs, oy, obx, S, fidx=None):
        note(imgs, fidx)
        return blocks(imgs, oy, obx, S, fidx)

    monkeypatch.setattr(T, "gather_strips", spy_strips)
    monkeypatch.setattr(T, "gather_blocks", spy_blocks)


def _port(frames, hybrid, pts=None):
    return T.lk_track_video_chunked(torch.as_tensor(frames), pts=pts, chunk=CHUNK,
                                    grid_step=STEP, hybrid=hybrid)


def test_hybrid_bit_identical_to_block_and_reads_whole_clip(frames, monkeypatch):
    block = _port(frames, False)
    calls = []
    _spy(monkeypatch, calls)
    hybrid = _port(frames, True)
    assert torch.equal(hybrid, block)
    assert block.shape == (8, len(T.grid_points(W, H, STEP)), 2)
    with_fidx = [c for c in calls if c[1] is not None]
    # one level-0 fetch a chunk, over all 9 frames, pair b at frame s + 1 + b
    assert with_fidx == [(9, [1, 2, 3, 4]), (9, [5, 6, 7, 8])]
    assert all(n == CHUNK for n, f in calls if f is None)  # the small levels


def test_hybrid_and_block_match_jax(frames):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from rssync_tpu.frontend import tracking as JT

    want = np.asarray(JT.lk_track_video_chunked(jnp.asarray(frames), chunk=CHUNK,
                                                grid_step=STEP, hybrid=True))
    for hybrid in (False, True):
        np.testing.assert_allclose(_port(frames, hybrid).numpy(), want, rtol=0,
                                   atol=TRACK_ATOL)


def test_off_grid_points_take_the_block_structure(frames, monkeypatch):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from rssync_tpu.frontend import tracking as JT

    pts = T.grid_points(W, H, STEP) + np.float32(0.5)
    calls = []
    _spy(monkeypatch, calls)
    got = _port(frames, True, pts)
    assert calls and all(f is None for _, f in calls)
    assert torch.equal(got, _port(frames, False, pts))

    # rssync_tpu's predicate: its strip fetch is traced without fidx
    jcalls = []
    orig = JT._gather_strips

    def jspy(imgs, oyq, obx, fidx=None, **kw):
        jcalls.append(fidx is not None)
        return orig(imgs, oyq, obx, fidx=fidx, **kw)

    monkeypatch.setattr(JT, "_gather_strips", jspy)
    want = np.asarray(JT.lk_track_video_chunked(jnp.asarray(frames), pts=pts, chunk=CHUNK,
                                                hybrid=True))
    assert jcalls and not any(jcalls)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TRACK_ATOL)


@pytest.mark.parametrize("hw", [(2028, 2704), (1080, 1920), (480, 640), (H, W)])
def test_pyramid_sums_are_exact_in_float64(hw):
    """The premise of the hybrid's bit-identity on any device: for u8
    levels, each of build_pyramid_sparse's two float64 GEMMs sums
    exactly. Row GEMM outputs are multiples of the row weights' finest
    bf16 step below 2^9 (u8 times weights whose rows sum under 2); the
    column GEMM's are multiples of both steps' product below 2^9; both
    fit float64's 53 significant bits."""
    h, w = hw
    levels = T.auto_levels(h, w)
    need, plan, fine0 = T._level_plan(levels, T.LK_ITERS, T.LK_RADIUS)
    store = T._stored_dims(h, w, "fine" if fine0 else "lane")
    prev, dims = 0, (h, w)
    for lvl in need[1:]:
        out = [T._lvl_size(n, prev, lvl) for n in dims]
        out_store = T._stored_dims(*out, plan.get(lvl))
        steps = []
        for n, n_store, o in zip(dims, store, out_store):
            m = T._down_weights(n, prev, lvl, n_store, o, torch.device("cpu")).numpy()
            assert m.dtype == np.float64 and float(np.abs(m).sum(1).max()) < 2.0
            nz = np.abs(m[m != 0])
            steps.append(int(np.floor(np.log2(nz)).min()) - 7)  # bf16: 8 significant bits
        assert 9 - steps[0] <= 53 and 9 - steps[0] - steps[1] <= 53, (lvl, steps)
        prev, dims, store = lvl, out, out_store


def test_pyramid_levels_equal_integer_arithmetic():
    """build_pyramid_sparse's u8 levels at the 2704x2028 operating point
    (levels 0 -> 2 -> 5 -> 7) equal the exact sums done in integers
    (weights scaled by their finest bf16 step; the banded matrices as
    scipy sparse ones), rounded half to even and clipped: nothing is
    left to summation order."""
    from scipy import sparse

    h, w = 2028, 2704
    levels = T.auto_levels(h, w)
    need, plan, fine0 = T._level_plan(levels, T.LK_ITERS, T.LK_RADIUS)
    hp, wp = T._stored_dims(h, w, "fine" if fine0 else "lane")
    clip = torch.randint(0, 256, (2, hp, wp), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(0))  # as chip_smoke's noise
    pyr = T.build_pyramid_sparse(clip, levels, need, (h, w), plan)
    prev, dims = 0, (h, w)
    for lvl in need[1:]:
        src = pyr[prev].numpy().astype(np.int64)
        out = [T._lvl_size(n, prev, lvl) for n in dims]
        out_store = T._stored_dims(*out, plan.get(lvl))
        ints, shift = [], 0
        for n, n_store, o in zip(dims, src.shape[1:], out_store):
            m = T._down_weights(n, prev, lvl, n_store, o, torch.device("cpu")).numpy()
            k = -(int(np.floor(np.log2(np.abs(m[m != 0]))).min()) - 7)
            mi = np.round(m * 2.0**k).astype(np.int64)
            assert np.array_equal(mi / 2.0**k, m)  # the scaling is exact
            ints.append(sparse.csr_matrix(mi))
            shift += k
        z = np.stack([(ints[1] @ (ints[0] @ f).T).T for f in src])  # exact, x 2^shift
        q, r = np.divmod(z, 1 << shift)
        half = 1 << (shift - 1)
        q += (r > half) | ((r == half) & (q % 2 == 1))  # round half to even
        np.testing.assert_array_equal(np.clip(q, 0, 255), pyr[lvl].numpy(), err_msg=str(lvl))
        prev, dims = lvl, out
