"""PyTorch port: lead-field solves, lead vectors and the Frank-Wolfe
current-pattern design (ops/leadfield) against the JAX package on the
reference test's tiny array, a (18, 18, 9) lattice with K = 4 discs.

The stencil solvers run on the JAX-assembled case and hierarchy, handed
over as numpy arrays (pelvistim_fem_tpu_torch.interop); the element
path, the lead vectors and the optimizers on the port's own Case and on
the same numpy inputs as the reference."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pelvistim_fem_tpu.models import array as jarray  # noqa: E402
from pelvistim_fem_tpu.models.case import build_case as jbuild  # noqa: E402
from pelvistim_fem_tpu.ops import lattice_assembly as jla  # noqa: E402
from pelvistim_fem_tpu.ops import leadfield as jlf  # noqa: E402
from pelvistim_fem_tpu.ops import multigrid as jmg  # noqa: E402

from pelvistim_fem_tpu_torch import interop  # noqa: E402
from pelvistim_fem_tpu_torch.mesh import core  # noqa: E402
from pelvistim_fem_tpu_torch.models import array as tarray  # noqa: E402
from pelvistim_fem_tpu_torch.models.case import build_case  # noqa: E402
from pelvistim_fem_tpu_torch.ops import leadfield as tlf  # noqa: E402
from pelvistim_fem_tpu_torch.ops import multigrid as tmg  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_leadfield import _tiny_params  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

TOL = 1e-10
SIGMA = {core.BODY_MUSCLE: 0.35, core.BODY_FAT: 0.04, core.BODY_SKIN: 0.10}


def _case_dict(c):
    return {k: np.asarray(getattr(c, k)) for k in
            ("coeff", "free", "dirichlet", "b_neumann", "grid_index",
             "sigma_table")}


@pytest.fixture(scope="module")
def ref():
    specs, params, meta = jarray.build_array_specs(_tiny_params())
    jcase, jhier = jla.assemble_lattice(specs[0], jnp.float64)
    loads = np.stack([s.b_neumann for s in specs])
    out = jlf.solve_basis_refined(jcase, jhier, jnp.asarray(loads), tol=TOL)
    icase = interop.stencil_case_from_numpy(_case_dict(jcase), device="cpu")
    ihier = interop.hierarchy_from_numpy(
        [(np.asarray(lv.coeff), np.asarray(lv.free)) for lv in jhier.levels],
        specs[0].axes, device="cpu")
    mesh = tarray.array_recipe(params, 0).mesh()
    return dict(specs=specs, params=params, meta=meta, jcase=jcase,
                jhier=jhier, loads=loads, out=out, icase=icase, ihier=ihier,
                mesh=mesh)


def test_solve_basis_refined_matches_reference(ref):
    """K certified solves of the shared operator: phi within 1e-8
    max|phi| (the reference test's tolerance), every lane at a true
    residual <= 1e-10, iterations within 2; prints the measured delta
    (pytest -s)."""
    got = tlf.solve_basis_refined(ref["icase"], ref["ihier"],
                                  torch.as_tensor(ref["loads"]), tol=TOL)
    want = ref["out"]
    p = np.asarray(want.phi)
    assert bool(got.converged.all()) and float(got.residual.max()) <= TOL
    np.testing.assert_allclose(got.phi.numpy(), p, rtol=0,
                               atol=1e-8 * np.abs(p).max())
    np.testing.assert_array_less(
        np.abs(got.iterations.numpy() - np.asarray(want.iterations)), 3)
    rel = np.abs(got.phi.numpy() - p).max() / np.abs(p).max()
    print(f"basis: phi within {rel:.2e} max|phi|; iterations "
          f"{got.iterations.tolist()}, reference "
          f"{np.asarray(want.iterations).tolist()}")


def test_solve_basis_on_port_assembly(ref):
    """The port's own assembly of its bit-identical spec gives the same
    basis, and the discrete reciprocity R_jk = R_kj of the reference
    test holds."""
    from pelvistim_fem_tpu_torch.ops.lattice_assembly import assemble_lattice
    specs, _, _ = tarray.build_array_specs(_tiny_params())
    scase, hier = assemble_lattice(specs[0], torch.float64, device="cpu")
    loads = torch.as_tensor(np.stack([s.b_neumann for s in specs]))
    got = tlf.solve_basis_refined(scase, hier, loads, tol=TOL)
    p = np.asarray(ref["out"].phi)
    np.testing.assert_allclose(got.phi.numpy(), p, rtol=0,
                               atol=1e-8 * np.abs(p).max())
    gi = specs[0].grid_index
    b = np.stack([ld.ravel()[gi] for ld in ref["loads"]])
    R = b @ got.phi.numpy().T
    assert np.abs(R - R.T).max() / np.abs(R).max() < 1e-9


def test_solve_basis_uncertified_matches_reference(ref):
    """solve_basis (one MG-CG in f64, no refinement) against the JAX
    package's, within 1e-6 max|phi| (the reference test's tolerance
    between its two paths), and against the certified basis."""
    loads = ref["loads"]
    want = jlf.solve_basis(ref["jcase"], ref["jhier"], jnp.asarray(loads),
                           tol=TOL)
    got = tlf.solve_basis(ref["icase"], ref["ihier"],
                          torch.as_tensor(loads), tol=TOL)
    p = np.asarray(want.phi)
    for other in (p, np.asarray(ref["out"].phi)):
        np.testing.assert_allclose(got.phi.numpy(), other, rtol=0,
                                   atol=1e-6 * np.abs(p).max())
    assert bool(got.converged.all())
    np.testing.assert_array_less(
        np.abs(got.iterations.numpy() - np.asarray(want.iterations)), 3)


def test_solve_stencil_mg_matches_reference(ref):
    """The unrefined single-operator MG-CG in f64 on load 2."""
    jc = dataclasses.replace(ref["jcase"],
                             b_neumann=jnp.asarray(ref["loads"][2]))
    want = jmg.solve_stencil_mg(jc, ref["jhier"], tol=TOL)
    ic = dataclasses.replace(ref["icase"],
                             b_neumann=torch.as_tensor(ref["loads"][2]))
    got = tmg.solve_stencil_mg(ic, ref["ihier"], tol=TOL)
    p = np.asarray(want.phi)
    assert bool(got.converged) and float(got.residual) <= TOL
    np.testing.assert_allclose(got.phi.numpy(), p, rtol=0,
                               atol=1e-8 * np.abs(p).max())
    assert abs(int(got.iterations) - int(want.iterations)) <= 2


def _patch_ids(params, mesh):
    """Face patch ids 1..K from each disc's own recipe (the faces are
    ordered identically across the K meshes)."""
    pid = np.zeros(len(mesh.faces), np.int32)
    for k in range(params["n_electrodes"]):
        bc = tarray.array_recipe(params, k).mesh().face_bcid
        pid[bc == core.BC_ACTIVE] = k + 1
    return pid


def test_element_path_basis_matches_reference(ref):
    """Patch loads and the element-path certified basis (Jacobi-PCG
    refined, the reference's amg=None form) against the JAX package's."""
    params, mesh = ref["params"], ref["mesh"]
    pid = _patch_ids(params, mesh)
    case = build_case(mesh, SIGMA, mode="current",
                      injected_current_A=params["I_unit_A"], device="cpu")
    jcase = jbuild(jarray.array_recipe(params, 0).mesh(), SIGMA,
                   mode="current", injected_current_A=params["I_unit_A"])
    loads = tlf.element_patch_loads(case, pid, I_unit=params["I_unit_A"])
    np.testing.assert_array_equal(
        loads, jlf.element_patch_loads(jcase, pid,
                                       I_unit=params["I_unit_A"]))
    np.testing.assert_allclose(loads.sum(axis=1), params["I_unit_A"],
                               rtol=1e-12)
    want = jlf.solve_basis_case_refined(jcase, loads, tol=TOL)
    got = tlf.solve_basis_case_refined(case, loads, tol=TOL)
    p = np.asarray(want.phi)
    assert bool(got.converged.all()) and float(got.residual.max()) <= TOL
    np.testing.assert_allclose(got.phi.numpy(), p, rtol=0,
                               atol=1e-8 * np.abs(p).max())


def test_element_path_basis_amg_matches_reference(ref):
    """The AMG form (amg=, ops/amg) on the tiny array's mesh read without
    its lattice: each basis lane certified, within 1e-8 max|phi| of the
    reference's vmapped AMG solves, its AMG-CG iterations within 2."""
    from pelvistim_fem_tpu.ops.amg import build_amg as jbuild_amg
    from pelvistim_fem_tpu_torch.ops.amg import build_amg
    params = ref["params"]
    mesh = dataclasses.replace(ref["mesh"], lattice=None)
    pid = _patch_ids(params, mesh)
    kw = dict(mode="current", injected_current_A=params["I_unit_A"])
    case = build_case(mesh, SIGMA, device="cpu", **kw)
    jcase = jbuild(jarray.array_recipe(params, 0).mesh(), SIGMA, **kw)
    assert case.n_nodes >= 2000
    loads = tlf.element_patch_loads(case, pid, I_unit=params["I_unit_A"])
    want = jlf.solve_basis_case_refined(
        jcase, loads, amg=jbuild_amg(jcase, dtype=jnp.float32), tol=TOL)
    got = tlf.solve_basis_case_refined(
        case, loads, amg=build_amg(case, mesh=mesh), tol=TOL)
    p = np.asarray(want.phi)
    assert got.phi.shape == p.shape
    assert bool(got.converged.all()) and float(got.residual.max()) <= TOL
    np.testing.assert_allclose(got.phi.numpy(), p, rtol=0,
                               atol=1e-8 * np.abs(p).max())
    it, jit = got.iterations.numpy(), np.asarray(want.iterations)
    print(f"AMG basis iterations: port {it.tolist()}, reference "
          f"{jit.tolist()}")
    assert np.abs(it - jit).max() <= 2


@pytest.fixture(scope="module")
def leads(ref):
    """Lead vectors of both packages from the same f32 phi on their f32
    Cases, as run_array_opt extracts them."""
    params, meta = ref["params"], ref["meta"]
    kw = dict(roi_center=meta["roi_center"], roi_r=meta["roi_r"],
              target_dir=meta["target_dir"])
    phi = np.asarray(ref["out"].phi).astype(np.float32)
    jcase = jbuild(jarray.array_recipe(params, 0).mesh(), SIGMA,
                   mode="current", dtype=jnp.float32,
                   injected_current_A=params["I_unit_A"])
    case = build_case(ref["mesh"], SIGMA, mode="current",
                      dtype=torch.float32,
                      injected_current_A=params["I_unit_A"], device="cpu")
    want = jlf.lead_vectors(jcase, jnp.asarray(phi), **kw)
    got = tlf.lead_vectors(case, torch.as_tensor(phi), **kw)
    sig = np.asarray([0.0, 0.5, 0.03, 0.2], np.float32)
    want_s = jlf.lead_vectors(jcase, jnp.asarray(phi),
                              sigma_table=jnp.asarray(sig), **kw)
    got_s = tlf.lead_vectors(case, torch.as_tensor(phi),
                             sigma_table=torch.as_tensor(sig), **kw)
    return dict(want=want, got=got, want_s=want_s, got_s=got_s)


def test_lead_vectors_match_reference(leads):
    """w, J_skin and vol_roi within f32 rounding of the JAX package's,
    with the case's and with another sigma table."""
    for want, got in ((leads["want"], leads["got"]),
                      (leads["want_s"], leads["got_s"])):
        w, J, vol = (np.asarray(a) for a in want)
        assert got[1].shape == J.shape and got[1].dtype == torch.float32
        np.testing.assert_allclose(got[0].numpy(), w, rtol=2e-6)
        np.testing.assert_allclose(got[1].numpy(), J, rtol=0,
                                   atol=2e-6 * np.abs(J).max())
        np.testing.assert_allclose(float(got[2]), float(vol), rtol=2e-6)
    assert not np.allclose(np.asarray(leads["want"][1]),
                           np.asarray(leads["want_s"][1]))


def _design_inputs(leads, dtype):
    w, J, _ = (np.asarray(a) for a in leads["want"])
    budget, i_max = 4.0, 1.5
    peak1 = float(np.sqrt(((J.sum(axis=0)) ** 2).sum(axis=1).max()))
    return w.astype(dtype), J.astype(dtype), budget, i_max, 0.5 * peak1


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_optimize_pattern_matches_reference(leads, dtype):
    """The Frank-Wolfe design on the same numpy w / J_skin in both
    packages: pattern within 1e-6 of the budget (f64) or 1e-4 (f32),
    objective and peak within rtol 1e-9 (f64) or 2e-6 (f32), the history
    alike; feasible and at least the best single channel, as
    test_optimize_pattern_feasible_and_beats_single checks the
    reference."""
    w, J, budget, i_max, j_limit = _design_inputs(leads, dtype)
    want_i, want = jlf.optimize_pattern(jnp.asarray(w), jnp.asarray(J),
                                        budget=budget, i_max=i_max,
                                        j_limit=j_limit, steps=300)
    got_i, got = tlf.optimize_pattern(torch.as_tensor(w), torch.as_tensor(J),
                                      budget=budget, i_max=i_max,
                                      j_limit=j_limit, steps=300)
    rtol, itol = (1e-9, 1e-6) if dtype == np.float64 else (2e-6, 1e-4)
    # the limit itself rounds to the design's dtype
    feas = 1e-9 if dtype == np.float64 else 1e-6
    assert got_i.dtype == torch.float64 if dtype == np.float64 else \
        got_i.dtype == torch.float32
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), rtol=0,
                               atol=itol * budget)
    for k in ("objective", "peak_J_skin", "l1", "linf"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=rtol, err_msg=k)
    np.testing.assert_allclose(got["history"].numpy(),
                               np.asarray(want["history"]), rtol=10 * rtol)
    assert float(got["l1"]) <= budget * (1 + 1e-9)
    assert float(got["linf"]) <= i_max * (1 + 1e-9)
    assert float(got["peak_J_skin"]) <= j_limit * (1 + feas)
    best_single = 0.0
    for k in range(len(w)):
        for s in (+1.0, -1.0):
            e = np.zeros_like(w, dtype=np.float64)
            e[k] = s * min(i_max, budget)
            pk = float(np.sqrt(((e[:, None, None] * J).sum(0) ** 2)
                               .sum(axis=1).max()))
            if pk > j_limit:
                e *= j_limit / pk
            best_single = max(best_single, float(w @ e))
    assert float(got["objective"]) >= best_single * (1 - 1e-6)


def test_lmo_ties_in_index_order():
    """The oracle fills tied channels in index order, as JAX's stable
    argsort does."""
    g = np.asarray([0.5, -2.0, 2.0, 0.5, -0.5])
    for budget in (3.0, 5.0):
        want = jlf.optimize_pattern(jnp.asarray(g), jnp.zeros((5, 1, 3)),
                                    budget=budget, i_max=1.5, j_limit=1.0,
                                    steps=0)[0]
        got = tlf.optimize_pattern(torch.as_tensor(g), torch.zeros(5, 1, 3,
                                   dtype=torch.float64), budget=budget,
                                   i_max=1.5, j_limit=1.0, steps=0)[0]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_optimize_pattern_robust_matches_reference(leads, dtype):
    """The worst-case design over three samples (the nominal and two
    scaled lead sets) with the nominal design as a candidate: pattern,
    worst and mean objectives and peak alike in both packages, feasible
    for every sample and no worse on the worst sample than the nominal
    pattern made feasible, as test_robust_design_over_sigma_samples
    checks the reference."""
    w, J, budget, i_max, j_limit = _design_inputs(leads, dtype)
    ws, Js = (np.asarray(a).astype(dtype) for a in leads["want_s"][:2])
    w_sk = np.stack([w, ws, 0.9 * w])
    J_sk = np.stack([J, Js, 1.1 * J]).astype(dtype)
    i_nom = np.asarray(jlf.optimize_pattern(
        jnp.asarray(w), jnp.asarray(J), budget=budget, i_max=i_max,
        j_limit=j_limit, steps=200)[0])
    want_i, want = jlf.optimize_pattern_robust(
        jnp.asarray(w_sk), jnp.asarray(J_sk), budget=budget, i_max=i_max,
        j_limit=j_limit, steps=200, candidates=jnp.asarray([i_nom]))
    got_i, got = tlf.optimize_pattern_robust(
        torch.as_tensor(w_sk), torch.as_tensor(J_sk), budget=budget,
        i_max=i_max, j_limit=j_limit, steps=200,
        candidates=torch.as_tensor(np.asarray([i_nom])))
    rtol, itol = (1e-9, 1e-6) if dtype == np.float64 else (2e-6, 1e-4)
    feas = 1e-9 if dtype == np.float64 else 1e-6
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), rtol=0,
                               atol=itol * budget)
    for k in ("objective_worst", "objective_mean", "peak_J_skin", "l1",
              "linf"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=rtol, err_msg=k)
    assert float(got["l1"]) <= budget * (1 + 1e-9)
    assert float(got["linf"]) <= i_max * (1 + 1e-9)
    assert float(got["peak_J_skin"]) <= j_limit * (1 + feas)
    J_all = np.einsum("k,skmc->smc", i_nom.astype(np.float64), J_sk)
    pk = float(np.sqrt((J_all ** 2).sum(axis=2).max()))
    nom_worst = float((w_sk @ (i_nom * min(1.0, j_limit / pk))).min())
    assert float(got["objective_worst"]) >= nom_worst * (1 - 1e-6)
