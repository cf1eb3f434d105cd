"""The port's patch-extraction kernels E1-E4 and their harnesses
(rssync_tpu_torch/ops/patches.py, ops/strips.py::gather_strips,
rssync_tpu_torch/experiments/{pallas_patch,r3_dma,mb_extract,
mb_extract2}.py), held to experiments/pallas_patch.py, r3_dma.py,
mb_extract.py and mb_extract2.py.

On the CPU the wrappers take their plain versions. E1's and E2's Pallas
kernels run in interpret mode with the experiments' own kernel bodies
and specs; E3's and E4's are closures inside the experiments' `main()`,
so the port is held to `jax.lax.dynamic_slice` at origins clamped by
their rule. The experiment modules are loaded from their files
(`experiments/` is no package), and JAX only inside the `ref` fixture,
so the card tests run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_patches.py
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rssync_tpu_torch.experiments import mb_extract, mb_extract2, pallas_patch, r3_dma
from rssync_tpu_torch.ops import patches as P
from rssync_tpu_torch.ops import strips as ST

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
DTYPES = ["uint8", "bfloat16", "float32"]


@pytest.fixture(scope="module")
def ref():
    """E1's and E2's experiment modules, Pallas and lax (JAX on the CPU)."""
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
    for name in ("pallas_patch", "r3_dma"):
        spec = importlib.util.spec_from_file_location(
            f"experiments_{name}", REPO / "experiments" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        setattr(r, name, mod)
    return r


def _image(seed, H, W, dtype):
    """(torch image, the same values as float32 numpy): u8 integers, or
    normal values (rounded to bf16 for a bf16 image)."""
    rng = np.random.default_rng(seed)
    if dtype == "uint8":
        img = torch.as_tensor(rng.integers(0, 256, (H, W)).astype(np.uint8))
    else:
        img = torch.as_tensor((rng.normal(size=(H, W)) * 50).astype(np.float32))
        img = img.to(getattr(torch, dtype))
    return img, img.float().numpy()


def _jax_image(r, values, dtype):
    """The image for JAX: float32 values cast to its dtype (exact)."""
    return r.jnp.asarray(values).astype(getattr(r.jnp, dtype))


def _origins(seed, n, H, W):
    """(n + 8, 2) int32 xy: both edges, the corners, just outside and
    random interior origins."""
    edges = [[0, 0], [W - 1, H - 1], [-5, 3], [W, 0], [0, H], [W // 2, -2], [127, 31],
             [128, 32]]
    rng = np.random.default_rng(seed)
    inner = np.stack([rng.integers(0, W, n), rng.integers(0, H, n)], axis=1)
    return np.concatenate([np.asarray(edges), inner]).astype(np.int32)


# ---------------------------------------------------------------------------
# E1: experiments/pallas_patch.py


@pytest.mark.parametrize("dtype", DTYPES)
def test_e1_kernel_route_matches_pallas_interpret(ref, dtype):
    """force="kernel" equals _extract_pallas in interpret mode bit for
    bit, edge origins included: both clamp by the aligned-region rule."""
    H, W, size = 80, 300, 8
    img, values = _image(1, H, W, dtype)
    o = _origins(2, 12, H, W)
    want = np.asarray(ref.pallas_patch._extract_pallas(
        _jax_image(ref, values, dtype), ref.jnp.asarray(o), size, interpret=True))
    got = pallas_patch.extract_patches(img, torch.as_tensor(o), size, force="kernel")
    assert got.dtype == torch.float32 and got.shape == (len(o), size, size)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_e1_gather_route_matches_extract_xla(ref, dtype):
    """force="gather" (and None) equals _extract_xla, edge origins
    included: dynamic_slice counts a negative start from the end, then
    clamps it to [0, dim - size]."""
    H, W, size = 37, 150, 9
    img, values = _image(3, H, W, dtype)
    o = _origins(4, 10, H, W)
    want = np.asarray(ref.pallas_patch._extract_xla(
        _jax_image(ref, values, dtype), ref.jnp.asarray(o), size))
    for force in ("gather", None):
        got = pallas_patch.extract_patches(img, torch.as_tensor(o), size, force=force)
        np.testing.assert_array_equal(got.numpy(), want)


def test_e1_refuses_an_image_below_the_aligned_region():
    img = torch.zeros((39, 300), dtype=torch.uint8)  # u8 region is 40 x 256 at size 8
    with pytest.raises(ValueError, match="aligned DMA region"):
        pallas_patch.extract_patches(img, torch.zeros((1, 2), dtype=torch.int32), 8, "kernel")
    with pytest.raises(ValueError, match="unknown force"):
        pallas_patch.extract_patches(img, torch.zeros((1, 2), dtype=torch.int32), 8, "pallas")
    assert pallas_patch.aligned_region(torch.bfloat16, 40) == (56, 256, 16)
    assert pallas_patch.aligned_region(torch.float32, 128) == (136, 256, 8)


# ---------------------------------------------------------------------------
# E2: experiments/r3_dma.py (K3's kernel)


def test_e2_gather_strips_matches_pallas_interpret(ref):
    """gather_strips (fidx=None: pair b reads frame b) equals r3_dma's
    kernel body in interpret mode with its PrefetchScalarGridSpec, at
    B = 2 frames of 64 x 384 and the module's N = 130 points, the last
    row block and column block included."""
    r, m = ref, ref.r3_dma
    B, H, Wp, N = 2, 64, 384, m.N
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (B, H, Wp)).astype(np.uint8)
    oy = rng.integers(0, (H - m.SD) // 8 + 1, (B, N)).astype(np.int32)
    obx = rng.integers(0, Wp // 128 - 1, (B, N)).astype(np.int32)
    oy[:, 0], obx[:, 0] = (H - m.SD) // 8, Wp // 128 - 2
    grid_spec = r.pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2, grid=(B,),
        in_specs=[r.pl.BlockSpec(memory_space=r.pl.ANY)],
        out_specs=r.pl.BlockSpec((None, N, m.SD, 256), lambda b, oy, obx: (b, 0, 0, 0),
                                 memory_space=r.pltpu.VMEM),
        scratch_shapes=[r.pltpu.SemaphoreType.DMA((2,))],
    )
    want = np.asarray(r.pl.pallas_call(
        m._kernel, out_shape=r.jax.ShapeDtypeStruct((B, N, m.SD, 256), r.jnp.uint8),
        grid_spec=grid_spec, interpret=True,
    )(*map(r.jnp.asarray, (oy, obx, img))))
    got = ST.gather_strips(*map(torch.as_tensor, (img, oy, obx)))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# E3 / E4: experiments/mb_extract.py, mb_extract2.py


def _aligned_clamp_np(o, H, W, rows, cols, sub, lane=128):
    """The experiments' clamp, as they write it (mb_extract.py:202-207)."""
    x_max = (W - cols) // lane * lane + lane - 1
    y_max = (H - rows) // sub * sub + sub - 1
    return np.stack([np.clip(o[:, 0], 0, x_max), np.clip(o[:, 1], 0, y_max)], axis=1)


@pytest.mark.parametrize("probe,dtype,sub", [("E3", "uint8", 32), ("E3", "bfloat16", 16),
                                             ("E3", "float32", 8), ("E4", "float32", 8)])
def test_e3_e4_kernel_route_matches_dynamic_slice(ref, probe, dtype, sub):
    """E3's and E4's kernel routes (mb_extract.kernel_body,
    mb_extract2.kernel_call) clamp by the experiments' rule (rows
    size + sub up to 8, cols size + 128, not rounded) and equal
    dynamic_slice at the clamped origins bit for bit."""
    H, W, size = 90, 300, 8
    img, values = _image(6, H, W, dtype)
    o = _origins(7, 10, H, W)
    rows = size + sub + (-(size + sub)) % 8
    clamped = _aligned_clamp_np(o, H, W, rows, size + 128, sub)
    np.testing.assert_array_equal(
        P.clamp_aligned(torch.as_tensor(o), H, W, rows, size + 128, sub).numpy(), clamped)
    if probe == "E3":
        got = mb_extract.kernel_body(img, size, sub)(torch.as_tensor(o))
    else:
        p = mb_extract.Shape(H, W, len(o), size, 1, 1)
        got = mb_extract2.kernel_call(img, p, 8)(torch.as_tensor(o))
    jimg = _jax_image(ref, values, dtype)
    lax = ref.jax.lax
    want = ref.jax.vmap(lambda q: lax.dynamic_slice(jimg, (q[1], q[0]), (size, size)))(
        ref.jnp.asarray(clamped)).astype(ref.jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_clamp_slice_is_dynamic_slices_clamp(ref):
    H, W, size = 37, 150, 9
    o = _origins(8, 20, H, W)
    got = P.clamp_slice(torch.as_tensor(o), H, W, size).numpy()
    for axis, dim in ((0, W), (1, H)):  # a negative start counts from the end
        v = o[:, axis]
        np.testing.assert_array_equal(got[:, axis], np.clip(np.where(v < 0, v + dim, v), 0,
                                                            dim - size))
    # dynamic_slice reads the window at that start
    img = ref.jnp.arange(H * W, dtype=ref.jnp.int32).reshape(H, W)
    for (x, y), (cx, cy) in zip(o, got):
        corner = ref.jax.lax.dynamic_slice(img, (int(y), int(x)), (size, size))[0, 0]
        assert int(corner) == cy * W + cx


# ---------------------------------------------------------------------------
# the wrapper


def test_extract_patches_checks_its_inputs():
    img = torch.zeros((20, 30), dtype=torch.uint8)
    o = torch.tensor([[0, 0], [22, 12]], dtype=torch.int32)
    with pytest.raises(TypeError, match="uint8, bfloat16 or float32"):
        P.extract_patches(img.to(torch.int16), o, 8)
    with pytest.raises(TypeError, match="int32"):
        P.extract_patches(img, o.long(), 8)
    with pytest.raises(ValueError, match=r"\(N, 2\)"):
        P.extract_patches(img, torch.zeros((2, 3), dtype=torch.int32), 8)
    with pytest.raises(ValueError, match=r"\(H, W\)"):
        P.extract_patches(img[None], o, 8)
    with pytest.raises(ValueError, match="contiguous"):
        P.extract_patches(img.t(), o, 8)
    with pytest.raises(ValueError, match="size 21"):
        P.extract_patches(img, o, 21)
    with pytest.raises(ValueError, match="patches_per_block"):
        P.extract_patches(img, o, 8, patches_per_block=0)
    for bad in ([23, 0], [0, 13], [-1, 0], [0, -1]):
        with pytest.raises(ValueError, match="outside"):
            P.extract_patches(img, torch.tensor([bad], dtype=torch.int32), 8)


def test_extract_patches_plain_version_launches_nothing():
    img, _ = _image(9, 20, 30, "bfloat16")
    o = torch.tensor([[0, 0], [22, 12], [5, 7]], dtype=torch.int32)
    before = dict(P.LAUNCHES)
    got = P.extract_patches(img, o, 8, patches_per_block=2)
    assert P.LAUNCHES == before
    for n, (x, y) in enumerate(o.tolist()):
        assert torch.equal(got[n], img[y : y + 8, x : x + 8].float())
    assert P.extract_patches(img, o[:0], 8).shape == (0, 8, 8)


# ---------------------------------------------------------------------------
# the kernel's thread -> output mapping and its loads (a model of
# csrc/extract_patches.cu in ops/patches.py)

KERNEL_SWEEP = [(130, 40, 1), (130, 40, 2), (130, 40, 8), (130, 40, 16), (9, 7, 3), (1, 1, 1),
                (257, 41, 5), (130, 40, 1024)]


def _kernel_origins(seed, N, H, W, size):
    """(N, 2) int64 xy in bounds, the image's four corners first."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.integers(0, W - size + 1, N), rng.integers(0, H - size + 1, N)], axis=1)
    corners = [[0, 0], [W - size, 0], [0, H - size], [W - size, H - size]]
    o[: min(N, 4)] = corners[: min(N, 4)]
    return o


def _loads_cover_pixels(walk, loads, size, o, pitch, itemsize, base):
    """Every output float's pixel lies inside one load of its vector."""
    order = np.argsort(loads["vector"], kind="stable")
    vec, addr, width = (loads[k][order] for k in ("vector", "address", "width"))
    start = np.searchsorted(vec, np.arange(len(walk["vector"])))
    count = np.bincount(vec, minlength=len(walk["vector"]))
    e = walk["elems"]
    valid = e[..., 0] >= 0
    n = np.where(valid, e[..., 0], 0)
    a = base + ((o[n, 1] + e[..., 1]) * pitch + o[n, 0] + e[..., 2]) * itemsize
    covered = ~valid
    for k in range(int(count.max())):
        i = np.minimum(start + k, len(vec) - 1)
        lo, hi = addr[i][:, None], (addr[i] + width[i])[:, None]
        covered |= (k < count)[:, None] & (lo <= a) & (a + itemsize <= hi)
    return bool(covered.all())


@pytest.mark.parametrize("N,size,ppb", KERNEL_SWEEP)
def test_kernel_walk_writes_each_output_once_and_reads_inside_its_patch(N, size, ppb):
    """The kernel's mapping: whole warps, 32-256 threads, neighbouring
    threads on neighbouring vectors, every output float written by
    exactly one thread; and every load, the widened u8/bf16 words and
    float4s included, inside [x, x + S) x [y, y + S) of its patch, at
    every alignment of the image's base, W = 2S + 3 (not a multiple of
    4) and origins on the image's last row and column."""
    blocks, threads, depth = P.kernel_launch(N, size, ppb)
    assert threads % 32 == 0 and 32 <= threads <= 256 and depth <= P.MAX_DEPTH
    assert threads * depth == P.VECTORS_PER_BLOCK and depth <= ppb
    walk = P.kernel_walk(N, size, ppb)
    b, t, j, v, e = (walk[k] for k in ("block", "thread", "slot", "vector", "elems"))
    assert b.max() < blocks and t.max() < threads and j.max() < depth
    np.testing.assert_array_equal(v, b * P.VECTORS_PER_BLOCK + j * threads + t)
    assert len(np.unique(v)) == len(v) == -(-N * size * size // 4)
    valid = e[..., 0] >= 0
    flat = e[..., 0] * size * size + e[..., 1] * size + e[..., 2]
    np.testing.assert_array_equal(flat[valid], (4 * v[:, None] + np.arange(4))[valid])
    np.testing.assert_array_equal(np.bincount(flat[valid], minlength=N * size * size), 1)
    assert (e[valid][:, 1:] < size).all() and (e[valid][:, 0] < N).all()
    if size == P.ROW_SIZE:  # a vector is four pixels of one patch row
        assert (e[:, :, :2] == e[:, :1, :2]).all() and (e[:, 0, 2] % 4 == 0).all()
    H, W = size + 29, 2 * size + 3
    o = _kernel_origins(N + size, N, H, W, size)
    for itemsize in (1, 2, 4):
        for base in range(0, 16 if itemsize == 4 else 4, itemsize):
            loads = P.kernel_loads(walk, size, o, W, itemsize, base)
            x, y = o[loads["patch"], 0], o[loads["patch"], 1]
            row, col = np.divmod(loads["address"] - base, W * itemsize)
            inside = ((y <= row) & (row < y + size) & (x * itemsize <= col)
                      & (col + loads["width"] <= (x + size) * itemsize))
            assert inside.all(), (itemsize, base, np.flatnonzero(~inside)[:5])
            assert _loads_cover_pixels(walk, loads, size, o, W, itemsize, base), (itemsize, base)
            if size == P.ROW_SIZE:  # the wide loads are taken
                assert (loads["width"] > itemsize).any()


@pytest.mark.parametrize("ppb", [1, 2, 8, 16])
def test_kernel_grid_fills_the_card_at_every_launched_depth(ppb):
    """At the harnesses' 130 patches of 40 x 40 every patches_per_block
    they launch gives one grid of at least 132 blocks (the H100's SMs):
    the depth changes the threads a block, not the blocks."""
    blocks, threads, depth = P.kernel_launch(130, 40, ppb)
    assert blocks >= 132 and blocks == P.kernel_launch(130, 40, 1)[0]
    assert threads * depth == P.VECTORS_PER_BLOCK


# ---------------------------------------------------------------------------
# the harnesses, end to end on the CPU


def test_pallas_patch_routes_agree_on_e3_origins():
    """E1's two routes at mb_extract's origins, which no clamp moves."""
    img = mb_extract.make_image("cpu", small=True)
    o = mb_extract.make_origins("cpu", 6, small=True)
    for dt in (torch.uint8, torch.bfloat16, torch.float32):
        a = pallas_patch.extract_patches(img.to(dt), o, 8, force="kernel")
        assert torch.equal(a, pallas_patch.extract_patches(img.to(dt), o, 8, force="gather"))


def test_r3_dma_harness_runs_on_cpu():
    before = dict(ST.LAUNCHES)
    out = r3_dma.run(device="cpu", small=True)
    assert out["match"] and list(out) == ["match", "kernel-strips", "gather-blocks"]
    assert all(out[n]["ms"] is None and out[n]["value"] > 0 for n in out if n != "match")
    assert ST.LAUNCHES == before


def test_mb_extract_harness_runs_on_cpu():
    before = dict(P.LAUNCHES)
    out = mb_extract.run(device="cpu", small=True)
    assert len(out) == 12 and all(r["ms"] is None for r in out.values())
    assert len({r["value"] for r in out.values()}) == 1  # the same pixels, exact sums
    assert P.LAUNCHES == before
    with pytest.raises(ValueError, match="unknown"):
        mb_extract.run(["pallas_u8"], device="cpu", small=True)


def test_mb_extract2_harness_runs_on_cpu():
    out = mb_extract2.run(device="cpu", small=True)
    main = (mb_extract.SMALL.points, mb_extract.SMALL.size)
    same = [n for n, r in out.items() if r["patches"] == main]
    assert same == ["gather_n6_s8", "seq", "kernel_nbuf2", "kernel_nbuf8", "kernel_nbuf16"]
    assert len({out[n]["value"] for n in same}) == 1
    assert all(out[f"kernel_nbuf{b}"]["correct"] for b in mb_extract2.NBUF)
    assert out["floor"]["patches"] is None and out["floor"]["value"] > 0


@pytest.mark.parametrize("harness", [r3_dma, mb_extract, mb_extract2])
def test_patch_harness_commands_refuse_the_cpu(harness):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert harness.main([]) == 1


# ---------------------------------------------------------------------------
# on a card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("patches_per_block", [1, 2, 8, 16])
@pytest.mark.parametrize("dtype", DTYPES)
def test_extract_patches_kernel_matches_plain_on_card(cuda, dtype, patches_per_block):
    """E3's image, 130 + 4 origins in bounds (the corners included), 40
    x 40 patches: bit-equal to the plain version."""
    H, W, size = mb_extract.FULL.height, mb_extract.FULL.width, mb_extract.FULL.size
    img = _image(10, H, W, dtype)[0].to(cuda)
    o = np.clip(_origins(11, 126, H, W), 0, [W - size, H - size]).astype(np.int32)
    o = torch.as_tensor(o, device=cuda)
    before = P.LAUNCHES["extract_patches"]
    got = P.extract_patches(img, o, size, patches_per_block=patches_per_block)
    torch.cuda.synchronize()
    assert P.LAUNCHES["extract_patches"] == before + 1
    assert torch.equal(got, P.extract_patches_ref(img, o, size))


#: (H, W, N, size, patches_per_block, storage offset in elements): odd
#: sizes (the generic instance), one patch and 257, views whose base is
#: not aligned, W not a multiple of 4; the corners are always among the
#: origins, so patches touch the last row and column
EDGE_CASES = {
    "s7": (37, 131, 9, 7, 3, 0),
    "s41-n257": (300, 403, 257, 41, 5, 0),
    "s40-n1": (50, 63, 1, 40, 1, 0),
    "s40-n257": (500, 601, 257, 40, 16, 0),
    "s1-n1": (5, 7, 1, 1, 1, 0),
    "s40-offset1": (97, 203, 130, 40, 8, 1),
    "s40-offset3": (97, 203, 130, 40, 2, 3),
    "s7-offset1": (37, 131, 9, 7, 4, 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", EDGE_CASES)
def test_extract_patches_kernel_edge_shapes_match_plain_on_card(cuda, case, dtype):
    """Bit-equal to the plain version at odd sizes and counts, on a view
    that starts `offset` elements into its buffer and ends at its last
    element."""
    H, W, N, size, ppb, offset = EDGE_CASES[case]
    buf = _image(12, 1, offset + H * W, dtype)[0][0].to(cuda)
    img = buf[offset:].view(H, W)
    assert img.is_contiguous() and img.storage_offset() == offset
    o = torch.as_tensor(_kernel_origins(13, N, H, W, size).astype(np.int32), device=cuda)
    before = P.LAUNCHES["extract_patches"]
    got = P.extract_patches(img, o, size, patches_per_block=ppb)
    torch.cuda.synchronize()
    assert P.LAUNCHES["extract_patches"] == before + 1
    assert torch.equal(got, P.extract_patches_ref(img, o, size))


@pytest.mark.cuda
def test_extract_patches_kernel_traps_on_an_origin_outside(cuda):
    """The origins live on the card, so the kernel checks them and traps:
    a CUDA error at the next synchronize, in a process of its own."""
    code = "\n".join([
        "import torch",
        "from rssync_tpu_torch.ops import patches as P",
        "img = torch.zeros((20, 30), dtype=torch.uint8, device='cuda')",
        "o = torch.tensor([[22, 12]], dtype=torch.int32, device='cuda')",
        "P.extract_patches(img, o, 8); torch.cuda.synchronize(); print('in bounds')",
        "o[0, 0] = 23",
        "P.extract_patches(img, o, 8); torch.cuda.synchronize(); print('out of bounds')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0 and "in bounds" in proc.stdout, proc.stderr
    assert "out of bounds" not in proc.stdout and "CUDA" in proc.stderr, proc.stderr


@pytest.mark.cuda
def test_patch_harnesses_launch_their_kernels_on_card(cuda):
    P.reset_launch_counters()
    ST.reset_launch_counters()
    assert r3_dma.run(device=cuda, small=True)["match"]
    out = mb_extract.run(device=cuda, small=True)
    assert len({r["value"] for r in out.values()}) == 1
    out2 = mb_extract2.run(["gather_n6_s8", "kernel_nbuf2", "kernel_nbuf16"], device=cuda,
                           small=True)
    assert len({r["value"] for r in out2.values()}) == 1 and out2["kernel_nbuf16"]["correct"]
    assert ST.LAUNCHES["gather_strips"] > 0 and P.LAUNCHES["extract_patches"] > 0
