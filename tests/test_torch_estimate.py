"""ops/estimate of the port against the JAX package's on the CPU: the ZZ
indicators and global estimate (scalar and 3x3 sigma, by body and not),
the goal-oriented indicators, and the axis regrading, bit-identical when
both packages are fed the reference's indicators."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pelvistim_fem_tpu.models.ankle import build_layered_case as jbuild
from pelvistim_fem_tpu.ops import estimate as jest
from pelvistim_fem_tpu.ops.solve import solve_case as jsolve
from pelvistim_fem_tpu_torch.models.ankle import build_layered_case
from pelvistim_fem_tpu_torch.ops import estimate as pest
from torch_threads import one_torch_thread  # noqa: E402,F401

RTOL = 1e-12


@pytest.fixture(scope="module")
def ref():
    """The coarse step03 case in both packages (f64), its JAX solve, and
    the dual of a mean-potential goal over the muscle's top nodes."""
    jcase, params, jmesh = jbuild(coarse=True, with_mesh=True)
    case, _, mesh = build_layered_case(coarse=True, with_mesh=True,
                                       device="cpu")
    phi = np.asarray(jsolve(jcase, tol=1e-10, maxiter=30_000).phi)
    z = mesh.nodes[:, 2]
    q = np.where(np.abs(z - z.max() / 2) < 0.004, 1.0, 0.0) / mesh.n_nodes
    jdual = jest.goal_dual_case(jcase, jnp.asarray(q))
    psi = np.asarray(jsolve(jdual, tol=1e-10, maxiter=30_000).phi)
    return dict(jcase=jcase, jmesh=jmesh, case=case, mesh=mesh,
                params=params, phi=phi, psi=psi, q=q)


def _tensor_table(case):
    """(T, 3, 3) SPD tables: each body's sigma times a fixed SPD shape."""
    rng = np.random.default_rng(3)
    sig = np.asarray(case.sigma_table.numpy(), np.float64)
    out = []
    for s in sig:
        a = rng.standard_normal((3, 3))
        out.append(s * (a @ a.T + 3 * np.eye(3)) / 3)
    return np.stack(out)


@pytest.mark.parametrize("table", ["scalar", "tensor"])
@pytest.mark.parametrize("by_body", [True, False])
def test_zz_indicators_and_global_error_match(ref, table, by_body):
    jcase, case = ref["jcase"], ref["case"]
    tab = (None if table == "scalar" else _tensor_table(case))
    jt = None if tab is None else jnp.asarray(tab)
    tt = None if tab is None else torch.as_tensor(tab)
    want = np.asarray(jest.zz_error_indicators(
        jcase, jnp.asarray(ref["phi"]), jt, by_body=by_body))
    got = pest.zz_error_indicators(case, torch.as_tensor(ref["phi"]), tt,
                                   by_body=by_body).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=1e-14 * np.abs(want).max())
    if by_body:
        we, wr = (float(v) for v in jest.zz_global_error(
            jcase, jnp.asarray(ref["phi"]), jt))
        ge, gr = (float(v) for v in pest.zz_global_error(
            case, torch.as_tensor(ref["phi"]), tt))
        np.testing.assert_allclose([ge, gr], [we, wr], rtol=RTOL)


def test_recovered_gradient_matches(ref):
    want = np.asarray(jest.zz_recovered_gradient(
        ref["jcase"], jnp.asarray(ref["phi"])))
    got = pest.zz_recovered_gradient(ref["case"],
                                     torch.as_tensor(ref["phi"])).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=1e-14 * np.abs(want).max())


def test_goal_indicators_and_bound_match(ref):
    jcase, case = ref["jcase"], ref["case"]
    jdual = jest.goal_dual_case(jcase, jnp.asarray(ref["q"]))
    dual = pest.goal_dual_case(case, torch.as_tensor(ref["q"]))
    np.testing.assert_array_equal(dual.dirichlet_vals.numpy(),
                                  np.asarray(jdual.dirichlet_vals))
    np.testing.assert_array_equal(dual.b_neumann.numpy(),
                                  np.asarray(jdual.b_neumann))
    args_j = (jcase, jnp.asarray(ref["phi"]), jnp.asarray(ref["psi"]))
    args_t = (case, torch.as_tensor(ref["phi"]), torch.as_tensor(ref["psi"]))
    want = np.asarray(jest.zz_goal_indicators(*args_j))
    got = pest.zz_goal_indicators(*args_t).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=1e-14 * np.abs(want).max())
    np.testing.assert_allclose(float(pest.zz_goal_bound(*args_t)),
                               float(jest.zz_goal_bound(*args_j)),
                               rtol=RTOL)


@pytest.mark.parametrize("power", [2, 1])
def test_axis_weights_and_adapt_recipe_bit_identical(ref, power):
    """Fed the reference's indicators, both packages' axis weights and
    regraded recipes are equal bit for bit."""
    from pelvistim_fem_tpu.mesh.generate import layered_slab_recipe as jr
    from pelvistim_fem_tpu.models.ankle import layered_model_inputs as ji
    from pelvistim_fem_tpu_torch.mesh.generate import layered_slab_recipe
    from pelvistim_fem_tpu_torch.models.ankle import layered_model_inputs
    eta = np.asarray(jest.zz_error_indicators(ref["jcase"],
                                              jnp.asarray(ref["phi"])))
    (Lx, Ly, Lz), rk, *_ = layered_model_inputs(ref["params"], coarse=True)
    (jLx, jLy, jLz), jrk, *_ = ji(ref["params"], coarse=True)
    recipe, jrecipe = layered_slab_recipe(Lx, Ly, Lz, **rk), \
        jr(jLx, jLy, jLz, **jrk)
    knots = (recipe.xs, recipe.ys, recipe.zs)
    got = pest.lattice_axis_weights(ref["case"], ref["mesh"], knots, eta,
                                    power=power)
    want = jest.lattice_axis_weights(ref["jcase"], ref["jmesh"], knots, eta,
                                     power=power)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    keep_z = list(np.cumsum([0.0] + [t for _, t, _ in rk["layers"]]))
    new = pest.adapt_recipe(recipe, ref["case"], ref["mesh"], eta,
                            keep_z=keep_z, power=power)
    jnew = jest.adapt_recipe(jrecipe, ref["jcase"], ref["jmesh"], eta,
                             keep_z=keep_z, power=power)
    for a in ("xs", "ys", "zs"):
        np.testing.assert_array_equal(getattr(new, a), getattr(jnew, a))
        assert len(getattr(new, a)) == len(getattr(recipe, a))
    # the regraded recipe's mesh is the reference's
    m, jm = new.mesh(), jnew.mesh()
    np.testing.assert_array_equal(m.nodes, jm.nodes)
    np.testing.assert_array_equal(m.tets, jm.tets)
    np.testing.assert_array_equal(m.face_bcid, jm.face_bcid)


@pytest.mark.parametrize("seed,n_cells,keep,h_min", [
    (0, 20, (), None), (1, 33, (0.31, 0.5), None),
    (2, 12, (0.2, 0.2 + 1e-13, 0.9), 0.01), (3, 40, (0.05,), 0.03),
])
def test_adapt_axis_bit_identical(seed, n_cells, keep, h_min):
    rng = np.random.default_rng(seed)
    knots = np.concatenate([[0.0], np.sort(rng.random(24)), [1.0]])
    w = rng.random(25) ** 4
    w[rng.random(25) < 0.2] = 0.0
    got = pest.adapt_axis(knots, w, n_cells, keep=keep, h_min=h_min)
    want = jest.adapt_axis(knots, w, n_cells, keep=keep, h_min=h_min)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="kept segments"):
        pest.adapt_axis(knots, w, 1, keep=(0.3, 0.6))
    with pytest.raises(ValueError, match="must be w_cell"):
        pest.adapt_axis(knots, w[:-1], n_cells)


def test_indicators_in_an_f32_case(ref):
    """An f32 Case gives f32 indicators within f32 rounding of the f64
    ones (no silent promotion)."""
    case32 = dataclasses.replace(ref["case"], **{
        f: getattr(ref["case"], f).to(torch.float32)
        for f in ("nodes", "grads", "vol", "sigma_table")})
    got = pest.zz_error_indicators(
        case32, torch.as_tensor(ref["phi"], dtype=torch.float32))
    want = pest.zz_error_indicators(ref["case"],
                                    torch.as_tensor(ref["phi"]))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-4 * float(want.max()))
