"""The port's probe kernels E5-E8 and their harnesses
(rssync_tpu_torch/ops/{convert,blockcopy,score}.py,
rssync_tpu_torch/experiments/), held to the Pallas kernels of
experiments/r4_{u8pass,u8pass2,slice2,i16score}.py.

On the CPU the wrappers take their plain versions and the Pallas kernels
run in interpret mode with the experiments' own kernel bodies and block
specs. The experiment modules are loaded from their files
(`experiments/` is no package), and JAX only inside the `ref` fixture,
so the card tests run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_probes.py
"""

import importlib.util
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rssync_tpu_torch.experiments import r4_i16score, r4_slice2, r4_u8pass, r4_u8pass2
from rssync_tpu_torch.ops import blockcopy as BC
from rssync_tpu_torch.ops import convert as CV
from rssync_tpu_torch.ops import score as S

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
#: tests/test_torch_score.py's bounds against the interpret-mode
#: scoring kernels: the bracket's initial hi rests on an order-sensitive
#: f32 mean (RTOL), and with one valid feature the interpret-mode kernel
#: contracts v.nP into FMAs (ONE_FEATURE_RTOL)
RTOL, ONE_FEATURE_RTOL = 2e-6, 1e-4


@pytest.fixture(scope="module")
def ref():
    """The four experiment modules and Pallas (JAX on the CPU)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))  # the experiments import rssync_tpu

    class Ref:
        pass

    r = Ref()
    r.jax, r.jnp, r.pl, r.pltpu = jax, jnp, pl, pltpu
    for name in ("r4_u8pass", "r4_u8pass2", "r4_slice2", "r4_i16score"):
        spec = importlib.util.spec_from_file_location(
            f"experiments_{name}", REPO / "experiments" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        setattr(r, name, mod)
    return r


def _u8(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


def _bf16_as_f32(x) -> np.ndarray:
    """A bf16 array or tensor as float32 numpy (bf16 -> f32 is exact)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype("float32"))


# ---------------------------------------------------------------------------
# E5 / E6: u8 -> bf16


def _pallas_convert(r, kernel, x):
    """pallas_convert of r4_u8pass(2) in interpret mode: that kernel body
    over the experiment's (1, 256, Wp) row blocks."""
    Tn, Hp, Wp = x.shape
    spec = r.pl.BlockSpec((1, 256, Wp), lambda t, b: (t, b, 0))
    return r.pl.pallas_call(
        kernel, grid=(Tn, Hp // 256), in_specs=[spec], out_specs=spec,
        out_shape=r.jax.ShapeDtypeStruct((Tn, Hp, Wp), r.jnp.bfloat16), interpret=True,
    )(r.jnp.asarray(x))


@pytest.mark.parametrize("probe", ["r4_u8pass", "r4_u8pass2"])
def test_u8_to_bf16_matches_pallas_convert(ref, probe):
    x = _u8(1, 2, 512, 256)
    want = _pallas_convert(ref, getattr(ref, probe)._conv_kernel, x)
    got = CV.u8_to_bf16(torch.as_tensor(x))
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    np.testing.assert_array_equal(_bf16_as_f32(got), _bf16_as_f32(want))


def test_u8_to_bf16_converts_every_row(ref):
    """At a height that is no multiple of 256 the TPU grid (Hp // 256
    blocks) skips the last rows; the port converts all of them, equal to
    astype(bfloat16)."""
    x = _u8(2, 3, 300, 384)
    got = CV.u8_to_bf16(torch.as_tensor(x))
    want = ref.jnp.asarray(x).astype(ref.jnp.bfloat16)
    np.testing.assert_array_equal(_bf16_as_f32(got), _bf16_as_f32(want))
    np.testing.assert_array_equal(_bf16_as_f32(got), x.astype(np.float32))


def test_u8_to_bf16_checks_its_input():
    with pytest.raises(TypeError, match="uint8"):
        CV.u8_to_bf16(torch.zeros(4, dtype=torch.int16))
    before = dict(CV.LAUNCHES)
    assert CV.u8_to_bf16(torch.zeros((0, 3), dtype=torch.uint8)).shape == (0, 3)
    assert CV.LAUNCHES == before  # the plain version launches nothing


# ---------------------------------------------------------------------------
# E7: block copy


def _pallas_copy(r, frames, start, n):
    """dma_block of r4_slice2 in interpret mode: its kernel body with its
    PrefetchScalarGridSpec."""
    grid_spec = r.pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(1,),
        in_specs=[r.pl.BlockSpec(memory_space=r.pl.ANY)],
        out_specs=r.pl.BlockSpec(memory_space=r.pl.ANY),
        scratch_shapes=[r.pltpu.SemaphoreType.DMA],
    )
    return np.asarray(r.pl.pallas_call(
        r.r4_slice2._copy_block_kernel,
        out_shape=r.jax.ShapeDtypeStruct((n, *frames.shape[1:]), frames.dtype),
        grid_spec=grid_spec, interpret=True,
    )(r.jnp.asarray([start], r.jnp.int32), r.jnp.asarray(frames)))


@pytest.mark.parametrize("start,n", [(0, 3), (4, 3), (6, 3), (2, 1)])
def test_copy_block_matches_pallas_dma_block(ref, start, n):
    frames = _u8(3, 9, 40, 256)
    want = _pallas_copy(ref, frames, start, n)
    got = BC.copy_block(torch.as_tensor(frames), torch.tensor([start], dtype=torch.int32), n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, frames[start : start + n])


def test_copy_block_checks_its_inputs():
    frames = torch.as_tensor(_u8(4, 5, 8, 32))
    one = torch.tensor([1], dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        BC.copy_block(frames, one.long(), 2)
    with pytest.raises(ValueError, match="n=6"):
        BC.copy_block(frames, one, 6)
    with pytest.raises(ValueError, match="outside"):
        BC.copy_block(frames, torch.tensor([4], dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="outside"):
        BC.copy_block(frames, torch.tensor([-1], dtype=torch.int32), 2)
    got = BC.copy_block(frames, torch.tensor([3], dtype=torch.int32), 2)
    assert torch.equal(got, frames[3:5]) and got.data_ptr() != frames[3].data_ptr()


#: E7's block sizes (bytes) and SM counts for its launch plan: one
#: 16-byte frame, blocks under a stage, exactly one stage a CTA, a ragged
#: last chunk, the probe's 98.4 MB block (17 of 2056x2816 u8)
_STAGE = BC.STAGE_BYTES
_PROBE_BLOCK = 17 * 2056 * 2816
_PLAN_CASES = [(16, 132), (16 * 1000, 132), (132 * _STAGE, 132), (132 * _STAGE + 16, 132),
               (3 * _STAGE + 48, 1), (_PROBE_BLOCK, 132), (_PROBE_BLOCK, 1), (16 * 12345, 7)]
#: and the block of each of the card tests' edge cases (blockcopy.copy_edges)
_PLAN_CASES += [(n * int(np.prod(shape[1:])) * (4 if dtype == "float32" else 1), 132)
                for _, shape, dtype, _, n in BC.copy_edges(132)]


@pytest.mark.parametrize("total,sms", _PLAN_CASES)
def test_copy_plan_covers_the_block_once(total, sms):
    ctas = BC.copy_plan(total, sms)
    assert 1 <= ctas <= sms
    chunks = BC.plan_chunks(ctas, total)
    assert all(o % 16 == 0 and 16 <= n <= _STAGE and n % 16 == 0 for _, o, n in chunks)
    offsets = sorted((o, n) for _, o, n in chunks)
    assert offsets[0][0] == 0 and sum(n for _, n in offsets) == total
    assert all(o + n == o2 for (o, n), (o2, _) in zip(offsets, offsets[1:]))
    # round-robin: chunk i of the block, at i * STAGE_BYTES, goes to CTA
    # i % ctas, so no CTA idles and their chunk counts differ by at most one
    assert all(o == i * _STAGE and c == i % ctas
               for i, (c, o, _) in enumerate(sorted(chunks, key=lambda ch: ch[1])))
    counts = [sum(c2 == c for c2, _, _ in chunks) for c in range(ctas)]
    assert min(counts) >= 1 and max(counts) - min(counts) <= 1


def test_copy_plan_refuses_unaligned_sizes():
    for total in (0, 8, 24, 16 * 1000 + 4):
        with pytest.raises(ValueError, match="multiple of 16"):
            BC.copy_plan(total, 132)


def test_copy_plan_stage_is_the_kernels():
    """plan_chunks models the kernel's walk only while STAGE_BYTES is
    csrc/copy_block.cu's kStageBytes."""
    src = (Path(BC.__file__).parent.parent / "csrc" / "copy_block.cu").read_text()
    m = re.search(r"constexpr uint32_t kStageBytes = (\d+) \* (\d+);", src)
    assert m and int(m[1]) * int(m[2]) == BC.STAGE_BYTES


# ---------------------------------------------------------------------------
# E8: int16-compare scoring


def _score_problem(seed, B, F, N, I):
    """tests/test_torch_score.py's inputs: rows with 0 and 1 valid
    features included."""
    rng = np.random.default_rng(seed)
    P = rng.normal(size=(B, 3, F, N)).astype(np.float32) * 0.1
    counts = rng.integers(min(5, N), N + 1, size=(B, F)).astype(np.int32)
    counts[:, 0] = 0
    counts[:, 1] = 1
    P *= (np.arange(N) < counts[..., None])[:, None]
    Pn2 = np.sum(P * P, axis=1)
    inv = np.where(Pn2 < 1e-24, 1.0, 1.0 / np.sqrt(np.maximum(Pn2, 1e-30)))
    nP = (P * inv[:, None]).astype(np.float32)
    v = rng.normal(size=(B, 3, F, I)).astype(np.float32)
    v /= np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)
    return nP, v, counts


@pytest.mark.parametrize("B,F,N,I", [(5, 7, 40, 20), (3, 6, 33, 50)])
def test_i16_plain_matches_pallas_score_i16(ref, B, F, N, I):
    nP, v, counts = _score_problem(B * N, B, F, N, I)
    got = S.score_quartile_i16_ref(*map(torch.as_tensor, (nP, v, counts))).numpy()
    want = np.asarray(ref.r4_i16score.score_i16(
        *map(ref.jnp.asarray, (nP, v, counts)), interpret=True, b_tile=2))
    several = counts != 1
    np.testing.assert_allclose(got[several], want[several], rtol=RTOL, atol=0)
    np.testing.assert_allclose(got[~several], want[~several], rtol=ONE_FEATURE_RTOL, atol=0)
    assert np.all(got[:, 0] == 0.0)  # no valid feature: hi = 0


@pytest.mark.parametrize("B,F,N,I", [(5, 7, 40, 20), (2, 9, 131, 33), (4, 3, 1, 6)])
def test_i16_plain_is_bit_equal_to_k2_plain(B, F, N, I):
    """Finite inputs: the int16 compare of bf16 bits orders as the float
    compare of the bf16 values, so the brackets agree bit for bit, on
    rows with 0 and 1 valid features too."""
    args = list(map(torch.as_tensor, _score_problem(7 + N, B, F, N, I)))
    i16 = S.score_quartile_i16(*args)
    assert torch.equal(i16, S.score_quartile_i16_ref(*args))
    assert torch.equal(i16, S.score_quartile_batched_ref(*args))


def test_i16_int16_order_holds_for_nonnegative_bf16():
    """Every bf16 value from +0 to +inf: the int16 view orders as the
    value does, which E8's compare rests on."""
    bits = torch.arange(0, 0x7F81, dtype=torch.int32).to(torch.int16)
    vals = bits.view(torch.bfloat16).float()
    assert bool((vals[1:] > vals[:-1]).all()) and vals[-1].item() == float("inf")


# ---------------------------------------------------------------------------
# the harnesses, end to end on the CPU


def test_u8pass_harness_runs_on_cpu():
    out = r4_u8pass.run(device="cpu", small=True)
    assert list(out) == ["sum_u8_i32", "sum_u8_bf16", "sum_bf16", "sum_f32",
                         "conv_mat", "kernel_conv"]
    assert all(r["ms"] is None for r in out.values())  # a CPU run times nothing
    assert len({r["value"] for n, r in out.items() if n.startswith("sum")}) == 1
    assert out["kernel_conv"]["value"] == out["conv_mat"]["value"]


def test_u8pass2_harness_runs_on_cpu():
    out = r4_u8pass2.run(["sum_u8", "sum_i16", "conv", "kernel_conv"], device="cpu", small=True)
    assert out["sum_u8"]["value"] == out["sum_i16"]["value"]
    assert out["kernel_conv"]["value"] == out["conv"]["value"]
    with pytest.raises(ValueError, match="unknown"):
        r4_u8pass2.run(["pallas_conv"], device="cpu", small=True)


def test_slice2_harness_runs_on_cpu():
    before = dict(BC.LAUNCHES)
    out = r4_slice2.run(device="cpu", small=True)
    assert out["kernel_sum"]["value"] == out["slice_sum"]["value"]
    assert out["slice_pyr"]["value"] > out["static_pyr"]["value"] > 0
    assert BC.LAUNCHES == before


def test_i16score_harness_runs_on_cpu():
    out = r4_i16score.run(device="cpu", small=True)
    assert out["parity_equal"] and out["identical"]
    assert out["k2"]["cost"].shape == (4,) and bool(torch.isfinite(out["k2"]["cost"]).all())
    # the patch is undone
    from rssync_tpu_torch.core import ransac
    assert ransac.score_quartile_batched is S.score_quartile_batched


def test_harness_commands_refuse_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert r4_u8pass.main([]) == 1


# ---------------------------------------------------------------------------
# on a card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,offset", [((17, 2056, 2816), 0), ((7, 13, 5), 0),
                                          ((1000003,), 1)])
def test_u8_to_bf16_kernel_matches_plain_on_card(cuda, shape, offset):
    n = int(np.prod(shape))
    flat = torch.as_tensor(_u8(5, n + offset), device=cuda)
    x = flat[offset:].view(shape)  # offset 1: not 16-byte aligned
    before = CV.LAUNCHES["u8_to_bf16"]
    got = CV.u8_to_bf16(x)
    torch.cuda.synchronize()
    assert CV.LAUNCHES["u8_to_bf16"] == before + 1
    assert torch.equal(got, CV.u8_to_bf16_ref(x))


@pytest.mark.cuda
@pytest.mark.parametrize("edge", [None] + [label for label, *_ in BC.copy_edges(132)])
def test_copy_block_kernel_matches_plain_on_card(cuda, edge):
    """The probe's chunk starts on a small clip, then each of
    blockcopy.copy_edges (n = 1, n = T, the last start, one 16-byte
    frame, under one stage, a vector past a stage on the block and on
    every CTA of this card, float32)."""
    if edge is None:
        frames, cases = torch.as_tensor(_u8(6, 33, 64, 256), device=cuda), [(0, 17), (15, 17),
                                                                             (16, 17)]
    else:
        edges = {e[0]: e[1:] for e in BC.copy_edges(BC.sm_count(cuda))}
        shape, dtype, s, n = edges[edge]
        frames, cases = BC.edge_frames(shape, dtype, cuda, 7), [(s, n)]
    before = BC.LAUNCHES["copy_block"]
    for s, n in cases:
        start = torch.tensor([s], dtype=torch.int32, device=cuda)
        assert torch.equal(BC.copy_block(frames, start, n), BC.copy_block_ref(frames, start, n))
    assert BC.LAUNCHES["copy_block"] == before + len(cases)


@pytest.mark.cuda
def test_copy_block_kernel_traps_on_a_bad_start(cuda):
    """The start lives on the card, so the kernel checks it and traps: a
    CUDA error at the next synchronize, in a process of its own."""
    code = "\n".join([
        "import torch",
        "from rssync_tpu_torch.ops import blockcopy as B",
        "f = torch.zeros((5, 16, 32), dtype=torch.uint8, device='cuda')",
        "s = torch.tensor([2], dtype=torch.int32, device='cuda')",
        "B.copy_block(f, s, 3); torch.cuda.synchronize(); print('in bounds')",
        "s[0] = 3",
        "B.copy_block(f, s, 3); torch.cuda.synchronize(); print('out of bounds')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0 and "in bounds" in proc.stdout, proc.stderr
    assert "out of bounds" not in proc.stdout and "CUDA" in proc.stderr, proc.stderr


#: the scoring kernel's geometry edges (tests/test_torch_score.py's
#: EDGE_SHAPES): a ragged task count, I = 1, I = 33, N = 1, 5 and 131,
#: the register route's last N and one past it, wide rows
_I16_EDGE_SHAPES = [(7, 13, 130, 20), (3, 11, 130, 1), (3, 7, 130, 33), (2, 9, 1, 20),
                    (2, 9, 5, 20), (2, 9, 131, 20), (2, 9, 256, 20), (2, 9, 257, 20),
                    (3, 5, 700, 33)]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape", [(6000, 60, 130, 20), (30, 60, 130, 200), (3, 5, 131, 33), *_I16_EDGE_SHAPES]
)
def test_i16_kernel_matches_plain_and_k2_on_card(cuda, shape):
    B, F, N, I = shape
    args = [torch.as_tensor(x, device=cuda) for x in _score_problem(11, B, F, N, I)]
    before = S.LAUNCHES["score_quartile_i16"]
    got = S.score_quartile_i16(*args)
    torch.cuda.synchronize()
    assert S.LAUNCHES["score_quartile_i16"] == before + 1
    assert torch.equal(got, S.score_quartile_i16_ref(*args))
    assert torch.equal(got, S.score_quartile_batched(*args))
