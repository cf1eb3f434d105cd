"""The port's RANSAC scoring (kernels K1/K2 of rssync_tpu/ops/pallas_score.py).

On the CPU: the plain PyTorch version against rssync_tpu's XLA
bisection and its Pallas kernels in interpret mode. On a card
(`-m cuda`): the CUDA kernel against the plain version. This file
imports JAX only inside the fixture of the parity tests, so the card
tests run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_score.py
"""

import numpy as np
import pytest
import torch

from rssync_tpu_torch.core.presync import PRESYNC_RANSAC_ITERS, delay_chunk
from rssync_tpu_torch.core.sync import SYNC_RANSAC_ITERS
from rssync_tpu_torch.ops import score as S

torch.set_num_threads(2)

#: the bracket's initial hi rests on an order-sensitive f32 mean; the
#: XLA, Pallas-interpret and PyTorch sums may round it 1 ulp apart
RTOL = 2e-6


@pytest.fixture(scope="module")
def ref():
    """rssync_tpu's scoring functions (JAX on the CPU)."""
    pytest.importorskip("jax")
    from rssync_tpu.ops import pallas_score

    return pallas_score


def _problem(seed, F, N, I, B=None):
    """nP (3, F, N) row-normalized with zeroed padding, v (3, F, I)
    unit, counts (F,) with rows of 0 and 1 valid features; a leading
    batch axis when B is given."""
    rng = np.random.default_rng(seed)
    lead = () if B is None else (B,)
    P = rng.normal(size=(*lead, 3, F, N)).astype(np.float32) * 0.1
    counts = rng.integers(min(5, N), N + 1, size=(*lead, F)).astype(np.int32)
    counts[..., 0] = 0
    counts[..., 1] = 1
    mask = np.arange(N) < counts[..., None]
    P *= mask[..., None, :, :]
    Pn2 = np.sum(P * P, axis=-3)
    inv = np.where(Pn2 < 1e-24, 1.0, 1.0 / np.sqrt(np.maximum(Pn2, 1e-30)))
    nP = (P * inv[..., None, :, :]).astype(np.float32)
    v = rng.normal(size=(*lead, 3, F, I)).astype(np.float32)
    v /= np.maximum(np.linalg.norm(v, axis=-3, keepdims=True), 1e-12)
    return nP, v, counts


@pytest.mark.parametrize("F,N,I", [(7, 40, 20), (37, 24, 200)])
def test_plain_matches_xla_and_pallas(ref, F, N, I):
    import jax.numpy as jnp

    nP, v, counts = _problem(0, F, N, I)
    got = S.score_quartile(*map(torch.as_tensor, (nP, v, counts))).numpy()
    args = tuple(map(jnp.asarray, (nP, v, counts)))
    xla = np.asarray(ref.score_quartile_xla(*args))
    pallas = np.asarray(ref.score_quartile_pallas(*args, interpret=True))
    np.testing.assert_allclose(got, xla, rtol=RTOL, atol=0)
    several = counts != 1
    np.testing.assert_allclose(got[several], pallas[several], rtol=RTOL, atol=0)
    # With one valid feature the bracket is that residual itself, and
    # the interpret-mode kernel contracts v.nP into FMAs on the CPU;
    # under cancellation that moves it up to 3.4e-5 from the XLA path
    # (and from the port, which rounds every product like XLA does).
    np.testing.assert_allclose(got[~several], pallas[~several], rtol=1e-4, atol=0)
    assert np.all(got[0] == 0.0)  # no valid feature: hi = 0


def test_batched_plain_matches_pallas_batched(ref):
    import jax.numpy as jnp

    nP, v, counts = _problem(1, 7, 40, 20, B=5)
    got = S.score_quartile_batched(*map(torch.as_tensor, (nP, v, counts))).numpy()
    want = np.asarray(ref.score_quartile_pallas_batched(
        *map(jnp.asarray, (nP, v, counts)), interpret=True, b_tile=2))
    several = counts != 1  # see test_plain_matches_xla_and_pallas
    np.testing.assert_allclose(got[several], want[several], rtol=RTOL, atol=0)
    np.testing.assert_allclose(got[~several], want[~several], rtol=1e-4, atol=0)
    xla = np.stack([np.asarray(ref.score_quartile_xla(
        *map(jnp.asarray, (nP[b], v[b], counts[b])))) for b in range(5)])
    np.testing.assert_allclose(got, xla, rtol=RTOL, atol=0)
    one = S.score_quartile(*map(torch.as_tensor, (nP[3], v[3], counts[3]))).numpy()
    np.testing.assert_array_equal(got[3], one)


@pytest.mark.parametrize("n", [1, 5, 32, 130])
def test_tree_sum_order_is_padding_invariant(n):
    """The kernel pads the features past N with zeros and sums in the
    halving order; extra zero padding must not change a bit."""
    x = torch.as_tensor(np.random.default_rng(n).exponential(size=(9, n)).astype(np.float32))
    base = S.tree_sum(x)
    for extra in (1, 40, 300):
        padded = torch.nn.functional.pad(x, (0, extra))
        assert torch.equal(S.tree_sum(padded), base)
    np.testing.assert_allclose(base.numpy(), x.double().sum(-1).numpy(), rtol=1e-6)


def _pow2_at_least(x):
    return 1 << max(x - 1, 0).bit_length()


def _register_route_sum(x, words):
    """csrc/score_quartile.cu's register route: `words` packed words of
    (even, odd) slots, the even and the odd slots each summed by the
    compile-time recursion over the words (class R mod S splits into R
    and R + S mod 2S, a class whose least word is >= `words` pruned),
    then the two roots added."""
    x = torch.nn.functional.pad(x, (0, 2 * words - x.shape[-1]))
    wp = _pow2_at_least(words)

    def walk(r, s):
        if s == wp:
            return x[..., 2 * r], x[..., 2 * r + 1]
        a = walk(r, 2 * s)
        if r + s >= words:
            return a
        b = walk(r + s, 2 * s)
        return a[0] + b[0], a[1] + b[1]

    even, odd = walk(0, 1)
    return even + odd


def _wide_route_sum(x):
    """The wide route: the slots in bit-reversed order over P = 2^k >= N,
    zero past N, one stack of partial sums that merges as a binary
    counter carries."""
    n = x.shape[-1]
    logp = max(n - 1, 0).bit_length()
    stack = []
    for q in range(1 << logp):
        j = int(f"{q:0{logp}b}"[::-1], 2) if logp else 0
        s2 = x[..., j] if j < n else torch.zeros_like(x[..., 0])
        m = q + 1
        while m % 2 == 0:
            s2 = stack.pop() + s2
            m //= 2
        stack.append(s2)
    return stack[0]


@pytest.mark.parametrize("n", [1, 5, 32, 130, 131, 700])
def test_kernel_summation_order_matches_tree_sum(n):
    """The kernel's own summation order (the register route up to 256
    features, with ceil(N/2) words rounded up to 8; the wide route above)
    is bit-equal to tree_sum, on rows whose valid count is below N (zeros
    past it)."""
    rng = np.random.default_rng(100 + n)
    x = rng.exponential(size=(9, n)).astype(np.float32)
    x *= np.arange(n) < rng.integers(0, n + 1, size=(9, 1))
    x = torch.as_tensor(x)
    want = S.tree_sum(x)
    if n <= 256:
        words = -(-((n + 1) // 2) // 8) * 8
        assert torch.equal(_register_route_sum(x, words), want)
    assert torch.equal(_wide_route_sum(x), want)


def test_wrappers_check_shapes():
    nP, v, counts = map(torch.as_tensor, _problem(2, 4, 9, 6))
    with pytest.raises(ValueError, match="shape mismatch"):
        S.score_quartile(nP, v[:, :3], counts)
    with pytest.raises(ValueError, match="bad ranks"):
        S.score_quartile_batched(nP, v, counts)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda")


def _main_path_shape(case, dev):
    """(B, F, N, I) of a kernel launch on the engine's main path at the
    operating point chip_smoke.py drives: 30 windows, 130 features, 200
    PreSync delays. Its tracks cover each window's 60 frames only, so
    the closed Sync windows hold 60 frames too."""
    W, F, N, D = 30, 60, 130, 200
    if case == "presync_batched":  # batched_presync: a delay chunk x windows
        return delay_chunk(dev, D, W * F * N) * W, F, N, PRESYNC_RANSAC_ITERS
    if case == "sync_batched":  # batched Sync GuessMotion
        return W, F, N, SYNC_RANSAC_ITERS
    if case == "window_sync":  # SyncProblem.sync's GuessMotion
        return 1, F, N, SYNC_RANSAC_ITERS
    if case == "window_presync":  # presync_scan: a delay chunk's rows of one window
        return 1, delay_chunk(dev, D, F * N) * F, N, PRESYNC_RANSAC_ITERS
    return EDGE_SHAPES[case]


#: (B, F, N, I) shapes at the edges of the kernel's geometry: a task
#: count that is no multiple of the block, one hypothesis a row, a row
#: straddling warps, odd and tiny N, the register route's last N (256)
#: and the shared-memory route from one past it to several hundred
EDGE_SHAPES = {
    "ragged_tasks": (7, 13, 130, 20),
    "one_hypothesis": (3, 11, 130, 1),
    "straddling_rows": (3, 7, 130, 33),
    "n1": (2, 9, 1, 20),
    "n5": (2, 9, 5, 20),
    "n131": (2, 9, 131, 20),
    "register_cap": (2, 9, 256, 20),
    "past_register_cap": (2, 9, 257, 20),
    "wide_rows": (3, 5, 700, 33),
}


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case", ["presync_batched", "sync_batched", "window_sync", "window_presync", *EDGE_SHAPES]
)
def test_kernel_matches_plain_on_card(cuda, case):
    B, F, N, I = _main_path_shape(case, cuda)
    nP, v, counts = _problem(3, F, N, I, B=B)
    args = [torch.as_tensor(x, device=cuda) for x in (nP, v, counts)]
    before = dict(S.LAUNCHES)
    got = S.score_quartile_batched(*args)
    want = S.score_quartile_batched_ref(*args)
    torch.cuda.synchronize()
    assert S.LAUNCHES["score_quartile_batched"] == before["score_quartile_batched"] + 1
    # one summation order and bf16 compares on both sides: bit-equal
    assert torch.equal(got, want)
    one = S.score_quartile(args[0][0], args[1][0], args[2][0])
    assert torch.equal(one, got[0])
