"""ops/amg of the port against the JAX package's on the CPU, on the coarse
step04 structure at the full 7000x contrast (sigma_contact 5e-5 against
muscle 0.35): the hierarchy's levels, one V-cycle apply, the AMG-CG
solves (iterations within 2, phi within 1e-8 max|phi|, the certified
solve's true residual recomputed with the plain element operator), the
lane-stacked form, and runner.solve_auto's AMG branch."""

import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pelvistim_fem_tpu.models.pressure import build_pressure_case as jbuild
from pelvistim_fem_tpu.ops import amg as jamg
from pelvistim_fem_tpu_torch.models.pressure import build_pressure_case
from pelvistim_fem_tpu_torch.ops import amg
from torch_threads import one_torch_thread  # noqa: E402,F401

LEVEL_FIELDS = ("a_cols", "a_vals", "diag", "p_cols", "p_vals", "r_cols",
                "r_vals")


@pytest.fixture(scope="module")
def hard():
    jcase, _, jmesh = jbuild(coarse=True, with_mesh=True)
    case, _, mesh = build_pressure_case(coarse=True, with_mesh=True,
                                        device="cpu")
    table = np.asarray(jcase.sigma_table).copy()
    table[4] = table[5] = 5e-5
    jcase = dataclasses.replace(jcase, sigma_table=jnp.asarray(table))
    case = dataclasses.replace(case, sigma_table=torch.as_tensor(table))
    return dict(jcase=jcase, jmesh=jmesh, case=case, mesh=mesh,
                j32=jamg.build_amg(jcase, mesh=jmesh, dtype=jnp.float32),
                t32=amg.build_amg(case, mesh=mesh, dtype=torch.float32),
                j64=jamg.build_amg(jcase, mesh=jmesh, dtype=jnp.float64),
                t64=amg.build_amg(case, mesh=mesh, dtype=torch.float64))


def _true_residual(case, phi):
    """||b_eff - K phi|| / ||b_eff|| on the free dofs, with the plain f64
    element operator assembled here in numpy."""
    grads = case.grads.numpy()
    sigvol = (case.sigma_table[case.tet_body] * case.vol).numpy()
    tets, n = case.tets.numpy(), case.n_nodes
    free = case.free_mask.numpy()

    def raw(x):
        q = np.einsum("mid,mi->md", grads, x[tets])
        ye = np.einsum("mid,md->mi", grads, sigvol[:, None] * q)
        return np.bincount(tets.reshape(-1), ye.reshape(-1), minlength=n)

    diri = case.dirichlet_vals.numpy()
    b = np.where(free, case.b_neumann.numpy()
                 - raw(np.where(free, 0.0, diri)), 0.0)
    r = np.where(free, b - raw(np.where(free, phi, 0.0)), 0.0)
    return np.linalg.norm(r) / np.linalg.norm(b)


@pytest.mark.parametrize("with_mesh", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_hierarchy_levels_equal_reference(hard, with_mesh, dtype):
    """Levels, aggregates (through P), the RCM order and the fine ELL
    equal the reference's, built from the host mesh or read back from
    the case."""
    case, jcase = hard["case"], hard["jcase"]
    if with_mesh:
        got, want = (hard["t32"], hard["j32"]) if dtype == "float32" else \
            (hard["t64"], hard["j64"])
    else:
        got = amg.build_amg(case, mesh=hard["mesh"] if with_mesh else None,
                            dtype=getattr(torch, dtype))
        want = jamg.build_amg(jcase, mesh=hard["jmesh"] if with_mesh
                              else None, dtype=getattr(jnp, dtype))
    assert len(got.levels) == len(want.levels) >= 3
    np.testing.assert_array_equal(got.free_idx.numpy(),
                                  np.asarray(want.free_idx))
    for lv, jlv in zip(got.levels, want.levels):
        for f in LEVEL_FIELDS:
            g, w = getattr(lv, f).numpy(), np.asarray(getattr(jlv, f))
            # indices are int64 here (torch's gather index), int32 there
            assert g.shape == w.shape and (g.dtype == w.dtype or
                                           g.dtype.kind == w.dtype.kind
                                           == "i"), f
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0, err_msg=f)
    for f in ("fine_cols", "fine_vals", "fine_vals64"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    assert got.sizes[0] == int(case.free_mask.sum()) and got.build_s > 0


def test_aggregation_equals_reference(hard):
    A, _ = amg._assemble_csr(*amg._host_problem(hard["case"], hard["mesh"]))
    JA, _ = jamg._assemble_csr(*jamg._host_problem(hard["jcase"],
                                                   hard["jmesh"], None))
    assert (A != JA).nnz == 0
    for theta in (0.08, 0.25):
        S = amg._strength_graph(A, theta)
        assert (S != jamg._strength_graph(JA, theta)).nnz == 0
        agg, n = amg._aggregate(S)
        jagg, jn = jamg._aggregate(S)
        assert n == jn
        np.testing.assert_array_equal(agg, jagg)
    assert amg._rho_dinv_a(A) == jamg._rho_dinv_a(JA)


def test_vcycle_apply_matches_reference(hard):
    case, jcase = hard["case"], hard["jcase"]
    t64, j64 = hard["t64"], hard["j64"]
    v = np.random.default_rng(0).standard_normal(t64.sizes[0])
    got = amg.make_amg_preconditioner(t64)(torch.as_tensor(v)).numpy()
    want = np.asarray(jamg.make_amg_preconditioner(j64)(jnp.asarray(v)))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    # lanes: each lane's apply is the single apply (the coarse CG's dots
    # reduce per lane)
    V = torch.as_tensor(np.stack([v, 3 * v[::-1].copy()]))
    M = amg.make_amg_preconditioner(t64)
    lanes = M(V)
    for i in range(2):
        torch.testing.assert_close(lanes[i], M(V[i]), rtol=0, atol=0)
    # the coarse-levels-only cycle of distributed solvers
    vc = np.random.default_rng(1).standard_normal(t64.sizes[1])
    got = amg.make_amg_preconditioner(t64, start_level=1)(
        torch.as_tensor(vc)).numpy()
    want = np.asarray(jamg.make_amg_preconditioner(j64, start_level=1)(
        jnp.asarray(vc)))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    with pytest.raises(ValueError, match="fine_op"):
        amg.make_amg_preconditioner(amg.build_amg(case, mesh=hard["mesh"],
                                                  fine_ell=False))


def test_solve_case_amg_matches_reference(hard):
    case, jcase = hard["case"], hard["jcase"]
    t64, j64 = hard["t64"], hard["j64"]
    want = jamg.solve_case_amg(jcase, j64, tol=1e-8)
    got = amg.solve_case_amg(case, t64, tol=1e-8)
    p = np.asarray(want.phi)
    assert bool(got.converged)
    assert abs(int(got.iterations) - int(want.iterations)) <= 2
    np.testing.assert_allclose(got.phi.numpy(), p, rtol=0,
                               atol=1e-8 * np.abs(p).max())
    # an explicit table keeps the matrix-free element operator
    got_e = amg.solve_case_amg(case, t64, case.sigma_table, tol=1e-8)
    want_e = jamg.solve_case_amg(jcase, j64, jcase.sigma_table, tol=1e-8)
    assert abs(int(got_e.iterations) - int(want_e.iterations)) <= 2
    np.testing.assert_allclose(got_e.phi.numpy(), np.asarray(want_e.phi),
                               rtol=0, atol=1e-8 * np.abs(p).max())


def test_certified_amg_solve_matches_reference(hard):
    case, jcase = hard["case"], hard["jcase"]
    want = jamg.solve_case_amg_refined(jcase, hard["j32"], tol=1e-8)
    got = amg.solve_case_amg_refined(case, hard["t32"], tol=1e-8)
    p = np.asarray(want.phi)
    assert bool(got.converged) and float(got.residual) <= 1e-8
    print(f"AMG-CG iterations: port {int(got.iterations)}, reference "
          f"{int(want.iterations)}")
    assert abs(int(got.iterations) - int(want.iterations)) <= 2
    np.testing.assert_allclose(got.phi.numpy(), p, rtol=0,
                               atol=1e-8 * np.abs(p).max())
    true = _true_residual(case, got.phi.numpy())
    assert true <= 1.1e-8, true
    np.testing.assert_allclose(true, float(got.residual), rtol=0.05)


def test_lane_stacked_loads_match_single_solves(hard):
    """loads (K, N): each lane certified and equal to its case solved
    alone with that load (within what 1e-8 leaves), iterations within 2."""
    case = hard["case"]
    rng = np.random.default_rng(2)
    free = case.free_mask.numpy()
    loads = np.where(free, rng.standard_normal((2, case.n_nodes)), 0.0)
    loads = np.concatenate([case.b_neumann.numpy()[None], 1e-6 * loads])
    out = amg.solve_case_amg_refined(case, hard["t32"], tol=1e-8,
                                     loads=loads)
    assert out.phi.shape == (3, case.n_nodes)
    assert bool(out.converged.all()) and float(out.residual.max()) <= 1e-8
    for k in range(3):
        one = amg.solve_case_amg_refined(dataclasses.replace(
            case, b_neumann=torch.as_tensor(loads[k])), hard["t32"],
            tol=1e-8)
        assert abs(int(out.iterations[k]) - int(one.iterations)) <= 2
        scale = float(one.phi.abs().max())
        np.testing.assert_allclose(out.phi[k].numpy(), one.phi.numpy(),
                                   rtol=0, atol=1e-7 * scale)


def test_solve_auto_routes_latticeless_mesh_to_amg(hard):
    from pelvistim_fem_tpu.runner import solve_auto as jsolve_auto
    from pelvistim_fem_tpu_torch.runner import (ELEMENT_JACOBI_MAX_NODES,
                                                solve_auto)
    case, mesh = hard["case"], dataclasses.replace(hard["mesh"],
                                                   lattice=None)
    assert case.n_nodes >= ELEMENT_JACOBI_MAX_NODES
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = solve_auto(case, mesh, tol=1e-8)
        want = jsolve_auto(hard["jcase"], dataclasses.replace(
            hard["jmesh"], lattice=None), tol=1e-8)
    assert "amg: 3 levels" in buf.getvalue()
    assert len(res.amg.levels) == 3 and res.amg.build_s > 0
    assert res.amg.sizes[0] == int(case.free_mask.sum())
    assert bool(res.converged) and float(res.residual) <= 1e-8
    assert abs(int(res.iterations) - int(want.iterations)) <= 2
    p = np.asarray(want.phi)
    np.testing.assert_allclose(res.phi.numpy(), p, rtol=0,
                               atol=1e-8 * np.abs(p).max())
    assert _true_residual(case, res.phi.numpy()) <= 1.1e-8
