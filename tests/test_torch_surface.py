"""The port's public math helpers held to rssync_tpu's on the CPU, and
its surface: every public top-level name of rssync_tpu has a
counterpart in rssync_tpu_torch or stands in DELIBERATE_OMISSIONS with
its reason.

- `ops/quat.py::squad`, `quad` against rssync_tpu's (atol 1e-6) and
  their endpoint properties (tests/test_quat.py:119-137);
- `ops/spline.py::eval_spline`, `eval_spline_deriv` against rssync_tpu's
  and scipy (the cases of tests/test_spline.py; 1e-5 against JAX),
  `rotational_deriv` against `rotational_deriv_numeric` and JAX
  (tests/test_aux.py:85);
- `core/ransac.py::guess_motion_from_pairs` against rssync_tpu's on the
  same pairs and against tests/oracle.py's float64 guesser
  (tests/test_engine.py:75); `guess_motion` against
  `guess_motion_window` on a one-frame window.
"""

import ast
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.interpolate import CubicSpline
from scipy.spatial.transform import Rotation

from rssync_tpu_torch.core import ransac as R
from rssync_tpu_torch.ops import quat as Q
from rssync_tpu_torch.ops import spline as SP

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
QUAT_ATOL = 1e-6
SPLINE_JAX_ATOL = 1e-5

#: (rssync_tpu module, name) -> why the port has no counterpart
DELIBERATE_OMISSIONS = {
    ("utils/floors.py", "*"): "v5e time floors: TPU constants, not the card's",
    ("testing/tpu_selftest.py", "*"):
        "the TPU self-test; the cuda-marked tests and chip_smoke.py replace it",
    ("ops/pallas_score.py", "VMEM_BUDGET"): "a TPU scoped-VMEM budget",
    ("ops/pallas_score.py", "fits_vmem"): "a TPU scoped-VMEM check",
    ("ops/pallas_score.py", "fits_vmem_batched"): "a TPU scoped-VMEM check",
    ("ops/pallas_score.py", "on_tpu"): "a TPU backend probe",
    ("utils/timing.py", "enable_compile_cache"): "an XLA compile cache; nothing compiles here",
    ("utils/timing.py", "jax_profiler_trace"):
        "jax.profiler; the port's profilers use torch.profiler",
    ("core/problem.py", "WIDE"): "wide bands: the port's single coefficient gather "
                                 "reads any knot and gives the same values",
    ("core/problem.py", "WIDE_PAD"): "wide bands (see WIDE)",
    ("core/problem.py", "WIDE_SMAX"): "wide bands (see WIDE)",
    ("core/problem.py", "WideBands"): "wide bands (see WIDE)",
    ("core/problem.py", "make_wide_bands"): "wide bands (see WIDE)",
    ("core/problem.py", "wide_smax"): "wide bands (see WIDE)",
    ("core/problem.py", "problem_rows_aos"): "nothing calls it",
    ("frontend/tracking.py", "build_pyramid"):
        "the dense pyramid: nothing calls it (build_pyramid_sparse serves every path)",
    ("frontend/tracking.py", "DMA_SLOTS"): "a TPU DMA depth",
    ("core/presync.py", "DELAY_CHUNK"):
        "the port sizes PreSync's delay chunk to the device's memory (delay_chunk)",
    ("parallel/multi.py", "batched_presync_multi"):
        "parallel/batch.py::batched_presync takes a stacked table and per-window grids",
    ("parallel/multi.py", "batched_sync_multi"):
        "parallel/batch.py::batched_sync takes a stacked table",
}

#: (rssync_tpu module, name) -> (port module, name) where the port renames
RENAMED = {
    ("ops/pallas_score.py", "score_quartile_pallas"): ("ops/score.py", "score_quartile"),
    ("ops/pallas_score.py", "score_quartile_pallas_batched"):
        ("ops/score.py", "score_quartile_batched"),
    ("ops/pallas_score.py", "score_quartile_xla"): ("ops/score.py", "score_quartile_ref"),
    ("ops/pallas_score.py", "BISECT_ROUNDS"): ("ops/score.py", "BISECT_ROUNDS"),
    ("ops/pallas_score.py", "MARKOV_C"): ("ops/score.py", "MARKOV_C"),
}


@pytest.fixture(scope="module")
def jax_ops():
    pytest.importorskip("jax")
    from rssync_tpu.ops import quat, spline

    return quat, spline


# ---------------------------------------------------------------------------
# the surface


def _public_names(path: Path) -> set[str]:
    """Top-level public definitions of a module, read with ast (no
    import, so no JAX): functions, classes and assigned names, and in a
    package's __init__.py the names it re-exports."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            names |= {a.asname or a.name for a in node.names}
    return {n for n in names if not n.startswith("_")}


def _port_module(rel: str):
    mod = "rssync_tpu_torch." + rel.removesuffix(".py").replace("/", ".")
    return importlib.import_module(mod.removesuffix(".__init__"))


def _surface():
    for path in sorted((ROOT / "rssync_tpu").rglob("*.py")):
        rel = path.relative_to(ROOT / "rssync_tpu").as_posix()
        for name in sorted(_public_names(path)):
            yield rel, name


def test_every_public_name_is_ported_or_deliberately_omitted():
    missing, stale = [], []
    for rel, name in _surface():
        if (rel, "*") in DELIBERATE_OMISSIONS or (rel, name) in DELIBERATE_OMISSIONS:
            continue
        port_rel, port_name = RENAMED.get((rel, name), (rel, name))
        try:
            mod = _port_module(port_rel)
        except ModuleNotFoundError:
            missing.append(f"{rel} (module)")
            continue
        if not hasattr(mod, port_name):
            missing.append(f"{rel}::{name}")
    known = set(_surface())
    for rel, name in DELIBERATE_OMISSIONS:
        if name == "*":
            if not (ROOT / "rssync_tpu" / rel).exists():
                stale.append(rel)
        elif (rel, name) not in known:
            stale.append(f"{rel}::{name}")
            continue
        # an omitted module or name stays absent from the port
        port = ROOT / "rssync_tpu_torch" / rel
        if name == "*":
            assert not port.exists(), f"{rel} is ported: drop it from the omissions"
        elif port.exists():
            assert not hasattr(_port_module(rel), name), \
                f"{rel}::{name} is ported: drop it from the omissions"
    assert not missing, f"public names of rssync_tpu with no counterpart: {missing}"
    assert not stale, f"omissions that name nothing in rssync_tpu: {stale}"
    assert all(DELIBERATE_OMISSIONS.values())


def test_surface_walk_reads_definitions_and_reexports():
    names = _public_names(ROOT / "rssync_tpu" / "analysis" / "__init__.py")
    assert {"SyncQuality", "sync_rmse", "sync_rmse_from_csv", "to_gyroflow_offset"} <= names
    mesh = _public_names(ROOT / "rssync_tpu" / "parallel" / "mesh.py")
    assert mesh == {"WINDOW_AXIS", "make_mesh", "pad_to_multiple", "shard_windows",
                    "replicate_table", "shard_vector"}


# ---------------------------------------------------------------------------
# squad / quad


def _wxyz(rot):
    q = rot.as_quat()  # xyzw
    return np.concatenate([q[..., 3:], q[..., :3]], axis=-1)


@pytest.mark.parametrize("fn", ["squad", "quad"])
@pytest.mark.parametrize("batched", [False, True])
def test_squad_quad_match_jax(jax_ops, fn, batched):
    import jax.numpy as jnp

    jq = jax_ops[0]
    rng = np.random.default_rng(11)
    lead = (6,) if batched else ()
    ps = [_wxyz(Rotation.random(int(np.prod(lead)) or 1, rng=rng)).reshape(*lead, 4)
          for _ in range(4)]
    ps = [p.astype(np.float32) for p in ps]
    ts = rng.uniform(0, 1, size=lead).astype(np.float32) if batched else np.float32(0.37)
    got = getattr(Q, fn)(*map(torch.as_tensor, ps), torch.as_tensor(ts)).numpy()
    want = np.asarray(getattr(jq, fn)(*map(jnp.asarray, ps), jnp.asarray(ts)))
    assert got.shape == want.shape == (*lead, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=QUAT_ATOL)


@pytest.mark.parametrize("fn,seed", [("squad", 7), ("quad", 8)])
def test_squad_quad_endpoints(fn, seed):
    qs = _wxyz(Rotation.random(4, rng=np.random.default_rng(seed))).astype(np.float32)
    p0, p1, p2, p3 = (torch.as_tensor(q) for q in qs)
    f = getattr(Q, fn)
    np.testing.assert_allclose(f(p0, p1, p2, p3, 0.0).numpy(), qs[1], atol=QUAT_ATOL)
    np.testing.assert_allclose(f(p0, p1, p2, p3, 1.0).numpy(), qs[2], atol=QUAT_ATOL)


# ---------------------------------------------------------------------------
# eval_spline / eval_spline_deriv / rotational_deriv


def _split(x):
    x = np.asarray(x, np.float64)
    i0 = np.floor(x).astype(np.int32)
    return i0, (x - i0).astype(np.float32)


def _both(jax_ops, name, coeffs, i0, frac):
    """The port's and rssync_tpu's `name` at the same split positions."""
    import jax.numpy as jnp

    c32 = coeffs.astype(np.float32)
    got = getattr(SP, name)(torch.as_tensor(c32), torch.as_tensor(i0),
                            torch.as_tensor(frac)).numpy()
    want = np.asarray(getattr(jax_ops[1], name)(jnp.asarray(c32), jnp.asarray(i0),
                                                jnp.asarray(frac)))
    return got, want


@pytest.mark.parametrize("case", ["interior", "knots", "extrapolation", "split_index"])
def test_eval_spline_matches_jax_and_scipy(jax_ops, rng, case):
    n = {"interior": 50, "knots": 20, "extrapolation": 12, "split_index": 32}[case]
    y = rng.normal(size=(3, n)) if case != "split_index" else np.sin(0.3 * np.arange(n))[None]
    coeffs = SP.fit_natural_cubic(y)
    if case == "interior":
        i0, frac = _split(rng.uniform(0, n - 1, size=200))
    elif case == "knots":
        i0, frac = _split(np.arange(n))
    elif case == "extrapolation":  # both quadratic branches and the x >= n jump
        i0, frac = _split([-3.5, -1e-4, 0.0, n - 1 - 1e-4, n - 1.0, n - 0.5, n + 0.25, n + 2.5])
    else:  # a large index carried exactly by i0, a tiny fraction
        i0 = np.full(3, 20, np.int32)
        frac = np.asarray([0.25, 0.2501, 0.2502], np.float32)
    got, want = _both(jax_ops, "eval_spline", coeffs, i0, frac)
    assert got.shape == want.shape == (len(i0), y.shape[0])
    np.testing.assert_allclose(got, want, rtol=0, atol=SPLINE_JAX_ATOL)
    x = i0.astype(np.float64) + frac
    inside = (x >= 0) & (x <= n - 1)
    cs = [CubicSpline(np.arange(n), y[r], bc_type="natural") for r in range(y.shape[0])]
    ref = np.stack([c(x) for c in cs], axis=-1)
    atol = 1e-5 if case in ("knots", "split_index") else 2e-4  # test_spline.py's limits
    np.testing.assert_allclose(got[inside], ref[inside], rtol=0, atol=atol)


def test_eval_spline_packed_equals_unpacked(rng):
    coeffs = SP.fit_natural_cubic(rng.normal(size=(4, 30)))
    i0, frac = _split(rng.uniform(-2, 32, size=64))
    i0_t, frac_t = torch.as_tensor(i0), torch.as_tensor(frac)
    un = SP.eval_spline(torch.as_tensor(coeffs, dtype=torch.float32), i0_t, frac_t)
    packed = torch.as_tensor(SP.pack_table(coeffs), dtype=torch.float32)
    assert torch.equal(un, SP.eval_spline_packed(packed, i0_t, frac_t).T)


def test_eval_spline_deriv_matches_jax_and_scipy(jax_ops, rng):
    n = 40
    y = rng.normal(size=(2, n))
    coeffs = SP.fit_natural_cubic(y)
    x = np.concatenate([rng.uniform(0.5, n - 1.5, size=100), [-2.5, -0.5, n - 0.5, n + 1.5]])
    got, want = _both(jax_ops, "eval_spline_deriv", coeffs, *_split(x))
    np.testing.assert_allclose(got, want, rtol=0, atol=SPLINE_JAX_ATOL)
    cs = [CubicSpline(np.arange(n), y[r], bc_type="natural") for r in range(2)]
    ref = np.stack([c(x[:100], 1) for c in cs], axis=-1)
    np.testing.assert_allclose(got[:100], ref, atol=2e-3)  # test_spline.py's limit


def test_rotational_deriv_recovers_rate_and_matches_jax(jax_ops):
    """Constant rate about z (tests/test_aux.py:85): rotational_deriv's
    vector part is the body rate, the numeric variant half of it (the
    reference's formula has no factor 2); both as rssync_tpu's."""
    rate, n = 0.05, 64
    q = _wxyz(Rotation.from_euler("z", rate * np.arange(n)[:, None]))
    coeffs = SP.fit_natural_cubic(q.T)
    i0 = np.asarray([20, 30], np.int32)
    frac = np.asarray([0.3, 0.7], np.float32)
    got, want = _both(jax_ops, "rotational_deriv", coeffs, i0, frac)
    np.testing.assert_allclose(got[:, 3], rate, atol=1e-3)
    np.testing.assert_allclose(got[:, 1:3], 0.0, atol=1e-3)
    np.testing.assert_allclose(got, want, rtol=0, atol=SPLINE_JAX_ATOL)
    import jax.numpy as jnp

    c32 = coeffs.astype(np.float32)
    num = SP.rotational_deriv_numeric(torch.as_tensor(c32), torch.as_tensor(i0),
                                      torch.as_tensor(frac), 1e-3).numpy()
    want_n = np.asarray(jax_ops[1].rotational_deriv_numeric(
        jnp.asarray(c32), jnp.asarray(i0), jnp.asarray(frac), 1e-3))
    np.testing.assert_allclose(num[:, 3], rate / 2, atol=1e-2)
    assert np.all(num[:, 0] == 0.0)
    np.testing.assert_allclose(num, want_n, rtol=0, atol=1e-3)  # f32 / eps differences
    np.testing.assert_allclose(2 * num[:, 1:], got[:, 1:], atol=2e-2)


# ---------------------------------------------------------------------------
# the single-frame guessers


@pytest.fixture(scope="module")
def frame_problem():
    """P (3, N) of one frame of a tests/synthetic.py scene at a delay
    10 ms off, with its valid count, and the float64 oracle's P."""
    from oracle import OracleProblem
    from synthetic import make_scene

    from rssync_tpu_torch.core.problem import build_track_window, compute_problem, \
        make_spline_table

    scene = make_scene(seed=3, true_delay=0.0, n_frames=4, n_points=60)
    f = sorted(scene.frames)[0]
    table = make_spline_table(scene.quats_wxyz, scene.gyro_rate, device="cpu")
    win = build_track_window(*[[scene.frames[f][k]] for k in range(4)],
                             quats_start=float(scene.gyro_ts[0]),
                             sample_rate=scene.gyro_rate, device="cpu")
    P = compute_problem(table, win, torch.tensor(0.01))[:, 0]  # (3, N)
    oracle = OracleProblem(scene.quats_wxyz, scene.gyro_rate, float(scene.gyro_ts[0]))
    oracle.set_track(f, *scene.frames[f])
    return P, int(win.counts[0]), oracle.compute_problem(f, 0.01)


def test_guess_motion_from_pairs_matches_jax_and_oracle(frame_problem):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from oracle import OracleProblem
    from rssync_tpu.core import ransac as JR

    P, count, P_oracle = frame_problem
    r0, r1 = R.sample_pairs(torch.Generator().manual_seed(42), 50, torch.tensor(count))
    got = R.guess_motion_from_pairs(P, count, r0, r1)
    assert got.shape == (3,)
    want = np.asarray(JR.guess_motion_from_pairs(
        jnp.asarray(P.numpy()), jnp.int32(count), jnp.asarray(r0.numpy()),
        jnp.asarray(r1.numpy())))
    # the same hypothesis wins; the direction itself differs only by the
    # rsqrt of its normalization (torch's vs XLA's)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    oracle = OracleProblem.guess_motion_from_pairs(P_oracle, r0.numpy(), r1.numpy())
    np.testing.assert_allclose(got.numpy(), oracle, atol=1e-3)  # test_engine.py's limit


def test_guess_motion_equals_one_frame_window(frame_problem):
    P, count, _ = frame_problem
    for iters in (20, 200):
        got = R.guess_motion(P, count, torch.Generator().manual_seed(5), iters)
        want = R.guess_motion_window(P[:, None], torch.tensor([count], dtype=torch.int32),
                                     torch.Generator().manual_seed(5), iters)
        assert torch.equal(got, want[0])
        assert abs(float(torch.linalg.vector_norm(got)) - 1.0) < 1e-6
