"""PyTorch port: the geometry sweeps of step02 (padded group, per-lane
multigrid) and step03 (t_fat group on a shared lattice), their apps,
and the serial metric row, against the JAX package (f64, CPU).

step02 at a pair of its cases (circle r = 10 mm, square r = 15 mm, two
different lattices); step03 at coarse=True, one radius group."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pelvistim_fem_tpu.models.electrodes import \
    build_electrode_case as jax_electrode_case  # noqa: E402
from pelvistim_fem_tpu.ops import metrics as jmetrics  # noqa: E402
from pelvistim_fem_tpu.ops import multigrid as jmg  # noqa: E402
from pelvistim_fem_tpu.ops import stencil as jst  # noqa: E402
from pelvistim_fem_tpu.parallel import geometry_sweep as jgs  # noqa: E402
from pelvistim_fem_tpu.utils.config import \
    default_params as jax_params  # noqa: E402

from pelvistim_fem_tpu_torch.apps import run_step02, run_step03  # noqa: E402
from pelvistim_fem_tpu_torch.models.electrodes import \
    build_electrode_case  # noqa: E402
from pelvistim_fem_tpu_torch.ops import metrics  # noqa: E402
from pelvistim_fem_tpu_torch.ops import multigrid as tmg  # noqa: E402
from pelvistim_fem_tpu_torch.ops import stencil as tst  # noqa: E402
from pelvistim_fem_tpu_torch.parallel import geometry_sweep as tgs  # noqa: E402
from pelvistim_fem_tpu_torch.utils.config import default_params  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

TOL = 1e-8
PAIR = [("circle", 0.010), ("square", 0.015)]
R_STEP03 = 0.010


def _rel(a, b):
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())


def _assert_coeff_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-13 * np.abs(want).max())


@pytest.fixture(scope="module")
def pair():
    """Both packages' step02 pair, padded into one group (f64), with the
    per-lane hierarchies."""
    jp, tp = jax_params("step02_electrodes"), default_params(
        "step02_electrodes")
    jb, tb = [], []
    for shape, r in PAIR:
        jc, _, jm = jax_electrode_case(jp, shape=shape, r=r,
                                       dtype=jnp.float64, with_mesh=True)
        tc, _, tm = build_electrode_case(tp, shape=shape, r=r,
                                         with_mesh=True, device="cpu")
        jb.append((jc, jm))
        tb.append((tc, tm))
    jstacked, jextract = jgs.build_padded_group(jb, dtype=jnp.float64)
    jhier = jgs.build_padded_group_hierarchy(
        jstacked, host_coeff=jextract.host_coeff,
        host_free=jextract.host_free)
    tstacked, textract = tgs.build_padded_group(tb, dtype=torch.float64,
                                                device="cpu")
    thier = tgs.build_padded_group_hierarchy(tstacked)
    return dict(jb=jb, tb=tb, jstacked=jstacked, jextract=jextract,
                jhier=jhier, tstacked=tstacked, textract=textract,
                thier=thier)


@pytest.fixture(scope="module")
def group():
    """Both packages' coarse step03 t_fat group of one radius (f64) and
    the JAX package's certified phis of it."""
    p = jax_params("step03_ankle_layers")
    t_fats = p["layers"]["t_fat_sweep"]
    jsc, jstack, jcases, jmeshes = jgs.build_t_fat_group(
        p, t_fats, R_STEP03, coarse=True, dtype=jnp.float64)
    tsc, tstack, tcases, tmeshes = tgs.build_t_fat_group(
        default_params("step03_ankle_layers"), t_fats, R_STEP03,
        coarse=True, dtype=torch.float64, device="cpu")
    jtabs = jnp.stack([c.sigma_table for c in jcases])
    jref = jst.batched_geometry_solve_refined(jsc, jstack, jtabs, tol=TOL,
                                              maxiter=30_000)
    return dict(params=p, jsc=jsc, jstack=jstack, jcases=jcases,
                jmeshes=jmeshes, tsc=tsc, tstack=tstack, tcases=tcases,
                tmeshes=tmeshes, jtabs=jtabs, jref=jref)


# ── step02: the padded group ───────────────────────────────────────────


def test_electrode_cases_equal_reference(pair):
    for (jc, jm), (tc, tm) in zip(pair["jb"], pair["tb"]):
        for name in ("nodes", "tets", "tet_body", "faces", "face_bcid"):
            assert np.array_equal(getattr(tm, name), getattr(jm, name)), name
        assert tm.lattice.grid_shape == jm.lattice.grid_shape
        for f in dataclasses.fields(jc):
            if f.name != "meta":
                np.testing.assert_array_equal(
                    getattr(tc, f.name).numpy(),
                    np.asarray(getattr(jc, f.name)), err_msg=f.name)
        assert dataclasses.asdict(tc.meta) == dataclasses.asdict(jc.meta)


def test_padded_group_equals_reference(pair):
    """build_padded_group: every array equal (the coefficients to 1e-13
    of their largest: two orders of one host sum) and extract."""
    js, ts = pair["jstacked"], pair["tstacked"]
    assert tuple(ts.free.shape) == tuple(js.free.shape) == (2, 42, 25, 8)
    for name in ("free", "dirichlet", "b_neumann", "sigma_table"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(ts.grid_index.numpy(),
                                  np.asarray(js.grid_index)[0])
    _assert_coeff_close(ts.coeff.numpy(), js.coeff)
    phi = np.random.default_rng(0).standard_normal(ts.free.shape).reshape(
        2, -1)
    for a, b in zip(pair["textract"](torch.as_tensor(phi)),
                    pair["jextract"](phi)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_padded_group_hierarchy_matches_reference(pair):
    """Per-lane levels probed on the device in f64 and cast to f32: the
    free masks equal, the coefficients within 1e-6 of their largest."""
    jl, tl = pair["jhier"].levels, pair["thier"].levels
    assert len(tl) == len(jl) >= 2
    for k, (a, b) in enumerate(zip(tl, jl)):
        assert a.coeff.dtype == torch.float32
        np.testing.assert_array_equal(a.free.numpy(), np.asarray(b.free),
                                      err_msg=f"level {k}")
        want = np.asarray(b.coeff)
        np.testing.assert_allclose(a.coeff.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=f"level {k}")


def test_group_mg_solve_matches_reference(pair):
    """batched_group_solve_mg_refined: every lane certified, iterations
    within 2 of the reference's, phi within 1e-5 max|phi|."""
    want = jmg.batched_group_solve_mg_refined(
        pair["jstacked"], pair["jhier"], tol=TOL, maxiter=30_000)
    got = tmg.batched_group_solve_mg_refined(
        pair["tstacked"], pair["thier"], tol=TOL, maxiter=30_000)
    assert bool(got.converged.all()) and float(got.residual.max()) <= TOL
    assert np.abs(got.iterations.numpy()
                  - np.asarray(want.iterations)).max() <= 2
    assert _rel(got.phi.numpy(), want.phi) <= 1e-5


@pytest.mark.parametrize("refined", [False, True])
def test_batched_case_solve_matches_reference(pair, refined):
    """The padded group by lane-stacked Jacobi-PCG: f64 takes the
    reference's iterations; both certify each lane's TRUE residual."""
    if refined:
        want = jst.batched_case_solve_refined(pair["jstacked"], tol=TOL,
                                              maxiter=30_000)
        got = tst.batched_case_solve_refined(pair["tstacked"], tol=TOL,
                                             maxiter=30_000)
    else:
        want = jst.batched_case_solve(pair["jstacked"], tol=TOL,
                                      maxiter=30_000)
        got = tst.batched_case_solve(pair["tstacked"], tol=TOL,
                                     maxiter=30_000)
        np.testing.assert_array_equal(got.iterations.numpy(),
                                      np.asarray(want.iterations))
    assert bool(got.converged.all()) and float(got.residual.max()) <= TOL
    assert _rel(got.phi.numpy(), want.phi) <= 1e-5


# ── step03: the t_fat group ────────────────────────────────────────────


@pytest.mark.parametrize("coarse", [True, False])
def test_shared_z_knots_equal_reference(group, coarse):
    t_fats = group["params"]["layers"]["t_fat_sweep"]
    np.testing.assert_array_equal(
        tgs.shared_z_knots(default_params("step03_ankle_layers"), t_fats,
                           coarse=coarse),
        jgs.shared_z_knots(group["params"], t_fats, coarse=coarse))


def test_t_fat_group_equals_reference(group):
    """build_t_fat_group: the shared StencilCase and the per-lane
    coefficient stacks (stencil_host_data of each multi-body case)."""
    js, ts = group["jsc"], group["tsc"]
    for name in ("free", "dirichlet", "b_neumann", "grid_index",
                 "sigma_table"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)),
                                      err_msg=name)
    _assert_coeff_close(ts.coeff.numpy(), js.coeff)
    assert tuple(group["tstack"].shape) == tuple(group["jstack"].shape)
    _assert_coeff_close(group["tstack"].numpy(), group["jstack"])
    for tm, jm in zip(group["tmeshes"], group["jmeshes"]):
        assert np.array_equal(tm.lattice.grid_index, jm.lattice.grid_index)


@pytest.mark.parametrize("refined", [False, True])
def test_geometry_solve_matches_reference(group, refined):
    """batched_geometry_solve[_refined] on the t_fat group: certified
    lanes, phi within 1e-8 max|phi|; f64 takes the reference's
    iterations (f32 inner counts follow their rounding)."""
    tabs = torch.stack([c.sigma_table for c in group["tcases"]])
    if refined:
        want = group["jref"]
        got = tst.batched_geometry_solve_refined(
            group["tsc"], group["tstack"], tabs, tol=TOL, maxiter=30_000)
    else:
        want = jst.batched_geometry_solve(group["jsc"], group["jstack"],
                                          group["jtabs"], tol=TOL,
                                          maxiter=30_000)
        got = tst.batched_geometry_solve(group["tsc"], group["tstack"],
                                         tabs, tol=TOL, maxiter=30_000)
        np.testing.assert_array_equal(got.iterations.numpy(),
                                      np.asarray(want.iterations))
    assert got.phi.shape == (3, group["tcases"][0].n_nodes)
    assert bool(got.converged.all()) and float(got.residual.max()) <= TOL
    assert _rel(got.phi.numpy(), want.phi) <= 1e-8


def test_serial_extract_results_matches_reference(group):
    """The serial metric row (the batched extractor with one lane) on the
    same certified phi: every key, numbers to rtol 1e-10."""
    p = group["params"]
    for i in (0, 2):
        phi = np.asarray(group["jref"].phi[i])
        want = jmetrics.extract_results(group["jcases"][i],
                                        jnp.asarray(phi), p, verbose=False)
        got = metrics.extract_results(group["tcases"][i],
                                      torch.as_tensor(phi), p,
                                      verbose=False)
        assert list(got) == list(want)
        for k, b in want.items():
            a = got[k]
            if isinstance(b, (bool, str)) or b is None:
                assert a == b, k
            else:
                np.testing.assert_allclose(a, b, rtol=1e-10, atol=0,
                                           equal_nan=True, err_msg=k)


# ── the apps, end to end on the CPU ────────────────────────────────────


def test_run_step02_quick(tmp_path, capsys):
    """run_step02 --quick: the padded MG batch of two cases and its rows."""
    assert run_step02.main(["--quick", "--device", "cpu", "--outdir",
                            str(tmp_path)]) == 0
    rows = json.loads((tmp_path / "summary.json").read_text())
    assert [(r["shape"], r["r_mm"]) for r in rows] == [("circle", 10.0),
                                                       ("square", 10.0)]
    for r in rows:
        assert np.isfinite(r["peak_J"]) and 0 < r["flux_err"] < 0.05
        assert r["I_consistent_A"] > 0
    assert "padded batch (2, 42, 25, 8)" in capsys.readouterr().out


@pytest.mark.parametrize("batch", [False, True])
def test_run_step03_smoke_and_resume(tmp_path, capsys, batch):
    """run_step03 --smoke, serial and --batch, then --resume from the
    cached row."""
    argv = ["--smoke", "--device", "cpu", "--outdir", str(tmp_path)] + \
        (["--batch"] if batch else [])
    assert run_step03.main(argv) == 0
    rows = json.loads((tmp_path / "summary.json").read_text())
    assert len(rows) == 1 and rows[0]["flux_err"] < 0.05
    case_dir = tmp_path / "tfat5000um_r10000um"
    assert (case_dir / "row.json").exists()
    assert (case_dir / "bc_debug_report.txt").exists()
    capsys.readouterr()
    assert run_step03.main(argv + ["--resume"]) == 0
    assert "cached" in capsys.readouterr().out
    assert json.loads((tmp_path / "summary.json").read_text()) == rows
