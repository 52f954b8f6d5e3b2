"""PyTorch port: the step01 box, the element-path solvers, the runner,
the serial current metrics and the lane axis of the single stencil
apply, against the JAX package (f64, CPU)."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pelvistim_fem_tpu.mesh.generate import box_mesh as jax_box_mesh  # noqa: E402
from pelvistim_fem_tpu.models.box import \
    build_box_case as jax_box_case  # noqa: E402
from pelvistim_fem_tpu.ops import fields as jfields  # noqa: E402
from pelvistim_fem_tpu.ops import metrics as jmetrics  # noqa: E402
from pelvistim_fem_tpu.ops import solve as jsolve  # noqa: E402
from pelvistim_fem_tpu.ops import stencil as jst  # noqa: E402
from pelvistim_fem_tpu.runner import solve_auto as jax_solve_auto  # noqa: E402

from pelvistim_fem_tpu_torch import runner  # noqa: E402
from pelvistim_fem_tpu_torch.apps import run_step01  # noqa: E402
from pelvistim_fem_tpu_torch.mesh.generate import box_mesh  # noqa: E402
from pelvistim_fem_tpu_torch.models.box import build_box_case  # noqa: E402
from pelvistim_fem_tpu_torch.ops import fields, metrics, solve  # noqa: E402
from pelvistim_fem_tpu_torch.ops import stencil as tst  # noqa: E402
from pelvistim_fem_tpu_torch.ops.kernels import \
    stencil_kernels as sk  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

TOL = 1e-8
# Solves compared for phi run to TIGHT: at 1e-8 the f32 inner passes of
# two implementations leave different error of ~cond * 1e-8 (2e-7 of
# max|phi| on the box), at 1e-12 both sit on the discrete solution.
TIGHT = 1e-12


@pytest.fixture(scope="module")
def box():
    """Both packages' step01 box (f64) and the JAX package's certified
    phi of it (solve_auto, stencil branch)."""
    jcase, params, jmesh = jax_box_case(dtype=jnp.float64, with_mesh=True)
    tcase, tparams, tmesh = build_box_case(with_mesh=True, device="cpu")
    jres = jax_solve_auto(jcase, jmesh, tol=TOL)
    return dict(jcase=jcase, jmesh=jmesh, tcase=tcase, tmesh=tmesh,
                params=params, tparams=tparams, phi=np.asarray(jres.phi))


def _rel(a, b):
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())


def test_box_mesh_and_case_equal_reference(box):
    """box_mesh and build_box_case: nodes, tets, faces and BC arrays and
    every Case array bit for bit, and the metadata."""
    jm, tm = box["jmesh"], box["tmesh"]
    for name in ("nodes", "tets", "tet_body", "faces", "face_bcid",
                 "face_parent"):
        a, b = getattr(tm, name), getattr(jm, name)
        assert np.array_equal(a, b) and a.dtype == b.dtype, name
    assert tm.lattice.grid_shape == jm.lattice.grid_shape == (11, 11, 6)
    assert np.array_equal(tm.lattice.grid_index, jm.lattice.grid_index)
    small = box_mesh(0.01, 0.01, 0.005, 0.0025)
    assert np.array_equal(small.faces,
                          jax_box_mesh(0.01, 0.01, 0.005, 0.0025).faces)
    jc, tc = box["jcase"], box["tcase"]
    for f in dataclasses.fields(jc):
        if f.name != "meta":
            np.testing.assert_array_equal(getattr(tc, f.name).numpy(),
                                          np.asarray(getattr(jc, f.name)),
                                          err_msg=f.name)
    assert dataclasses.asdict(tc.meta) == dataclasses.asdict(jc.meta)
    assert box["tparams"] == box["params"]


@pytest.mark.parametrize("scheme", ["nodal", "cell"])
def test_boundary_face_flux_matches_reference(box, scheme):
    phi = box["phi"]
    want = np.asarray(jfields.boundary_face_flux(
        box["jcase"], jnp.asarray(phi), scheme=scheme))
    got = fields.boundary_face_flux(box["tcase"], torch.as_tensor(phi),
                                    scheme=scheme).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-12 * np.abs(want).max())


def test_injected_currents_match_reference(box):
    phi = box["phi"]
    want = jmetrics.injected_currents(box["jcase"], jnp.asarray(phi))
    got = metrics.injected_currents(box["tcase"], torch.as_tensor(phi))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-10, atol=1e-16,
                                   err_msg=k)
    assert got["flux_err"] < 1e-5


def test_stencil_host_data_of_box_matches_reference(box):
    want = jst.stencil_host_data(box["jcase"], box["jmesh"])
    got = tst.stencil_host_data(box["tcase"], box["tmesh"])
    for k in ("free", "dirichlet", "b_neumann", "grid_index",
              "sigma_table"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    scale = np.abs(want["coeff"]).max()
    np.testing.assert_allclose(got["coeff"], want["coeff"], rtol=0,
                               atol=1e-13 * scale)


@pytest.mark.parametrize("refined", [False, True])
def test_solve_case_matches_reference(box, refined):
    """The element path on the port's gather-table operator; the f64
    solve also takes the reference's iteration count."""
    if refined:
        want = jsolve.solve_case_refined(box["jcase"], tol=TIGHT)
        got = solve.solve_case_refined(box["tcase"], tol=TIGHT)
        assert float(got.residual) <= TIGHT
    else:
        want = jsolve.solve_case(box["jcase"], tol=TOL)
        got = solve.solve_case(box["tcase"], tol=TOL)
        assert int(got.iterations) == int(want.iterations)
    assert bool(got.converged) and float(got.residual) <= TOL
    assert got.phi.dtype == torch.float64
    assert _rel(got.phi.numpy(), want.phi) <= 1e-8


@pytest.mark.parametrize("branch", ["stencil", "element"])
def test_solve_auto_matches_reference(box, branch):
    mesh = (box["tmesh"], box["jmesh"]) if branch == "stencil" else \
        (None, None)
    want = jax_solve_auto(box["jcase"], mesh[1], tol=TIGHT)
    got = runner.solve_auto(box["tcase"], mesh[0], tol=TIGHT)
    assert bool(got.converged) and float(got.residual) <= TIGHT
    assert _rel(got.phi.numpy(), want.phi) <= 1e-8


def test_solve_auto_refuses_large_meshes_without_lattice():
    """A lattice-less mesh of >= 2000 nodes takes the certified AMG-CG
    element path (ops/amg; it raised before the port had it), with the
    hierarchy's host data read back from the case, as the reference's
    solve_auto does on the CPU: certified, iterations within 2 and phi
    within 1e-8 max|phi| of the reference's."""
    case, _ = build_box_case(h=0.002, device="cpu")
    assert case.n_nodes >= runner.ELEMENT_JACOBI_MAX_NODES
    got = runner.solve_auto(case, None)
    want = jax_solve_auto(jax_box_case(h=0.002)[0], None)
    assert bool(got.converged) and float(got.residual) <= 1e-8
    assert abs(int(got.iterations) - int(want.iterations)) <= 2
    assert _rel(got.phi.numpy(), want.phi) <= 1e-8


def test_runner_dtype_and_device_defaults():
    assert runner.preferred_dtype("cpu") == torch.float64
    assert not runner.on_card("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert runner.preferred_dtype() == torch.float64
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_box_case()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_step01.main([])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("S,shape", [(1, (5, 4, 3)), (3, (7, 6, 5)),
                                     (4, (9, 3, 8))])
def test_lane_stencil_twin_is_a_loop_of_the_single(S, shape, dtype):
    """The 4-D stencil_spmv_plain is the 3-D twin per lane, bit for bit."""
    rng = np.random.default_rng(S)
    x = torch.as_tensor(rng.standard_normal((S,) + shape), dtype=dtype)
    C = torch.as_tensor(rng.standard_normal((S, 27) + shape), dtype=dtype)
    y = sk.stencil_spmv(x, C)
    assert y.shape == x.shape and y.dtype == dtype
    for s in range(S):
        assert torch.equal(y[s], sk.stencil_spmv_plain(x[s], C[s]))


def test_lane_stencil_twin_matches_jax_vmap():
    rng = np.random.default_rng(7)
    shape = (3, 8, 7, 6)
    x = rng.standard_normal(shape)
    C = rng.standard_normal((3, 27) + shape[1:])
    want = np.asarray(jax.vmap(jst.stencil_spmv)(jnp.asarray(x),
                                                 jnp.asarray(C)))
    got = sk.stencil_spmv_plain(torch.as_tensor(x), torch.as_tensor(C))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_run_step01_passes_its_gates(tmp_path, capsys):
    """The step01 app end to end on the CPU: exit 0, metrics.json."""
    rc = run_step01.main(["--device", "cpu", "--outdir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0, out
    m = json.loads((tmp_path / "metrics.json").read_text())
    assert m["passed"] and m["rel_l2_vs_analytic"] <= 1e-6
    assert abs(m["mean_J"] - 10.0) < 1e-3
    assert out.count("[PASS]") == 5
