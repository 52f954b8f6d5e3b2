"""PyTorch port: the Pennes bioheat solves (ops/bioheat) against the JAX
package's, on the coarse step04 geometry and the 1-D slab, on the CPU.

Tolerances: f64 solves of one system by the same Jacobi-PCG agree to
1e-8 degC (a few hundred iterations of reordered f64 sums, far below the
solves' 1e-10 tolerance times the ~40 degC field) with iteration counts
within 1; the app's f32 lanes (tol 3e-6) agree to 2e-4 degC, the
reference's own ~1e-4 degC accuracy of an f32 solve at that tolerance,
twice.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pelvistim_fem_tpu.mesh import core as jcore  # noqa: E402
from pelvistim_fem_tpu.models.pressure import \
    build_pressure_case as jax_pressure_case  # noqa: E402
from pelvistim_fem_tpu.ops import bioheat as jbh  # noqa: E402

from pelvistim_fem_tpu_torch.mesh import core  # noqa: E402
from pelvistim_fem_tpu_torch.models.pressure import \
    build_pressure_case  # noqa: E402
from pelvistim_fem_tpu_torch.ops import bioheat as bh  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

T64 = dict(atol=1e-8, rtol=0)


@pytest.fixture(scope="module")
def cases():
    jcase, _, jmesh = jax_pressure_case(coarse=True, dtype=jnp.float64,
                                        with_mesh=True)
    tcase, _, tmesh = build_pressure_case(coarse=True, dtype=torch.float64,
                                          with_mesh=True, device="cpu")
    return jcase, tcase, jmesh, tmesh


def _app_tables(n_b, mod=bh, c=core):
    """The app's thermal tables (run_step04 --thermal), from the port's
    module and body ids or the reference's."""
    return mod.thermal_tables(
        n_b,
        {c.BODY_MUSCLE: mod.DEFAULT_K["muscle"],
         c.BODY_FAT: mod.DEFAULT_K["fat"],
         c.BODY_SKIN: mod.DEFAULT_K["skin"],
         c.BODY_CONTACT_ACTIVE: mod.DEFAULT_K["contact"],
         c.BODY_CONTACT_RETURN: mod.DEFAULT_K["contact"]},
        {c.BODY_MUSCLE: mod.DEFAULT_PERFUSION["muscle"],
         c.BODY_FAT: mod.DEFAULT_PERFUSION["fat"],
         c.BODY_SKIN: mod.DEFAULT_PERFUSION["skin"],
         c.BODY_CONTACT_ACTIVE: 0.0,
         c.BODY_CONTACT_RETURN: 0.0})


def _heat(n_tets, lanes, seed=3):
    """(lanes, M) numpy heat loads [W/m^3], the first all zero (the
    app's no-stimulation baseline lane)."""
    rng = np.random.default_rng(seed)
    q = 1e4 * (1.0 + rng.random((lanes, n_tets)))
    q[0] = 0.0
    return q


def test_constants_and_tables_equal_reference():
    assert bh.DEFAULT_K == jbh.DEFAULT_K
    assert bh.DEFAULT_PERFUSION == jbh.DEFAULT_PERFUSION
    assert bh.H_AIR == jbh.H_AIR
    for a, b in zip(_app_tables(5), _app_tables(5, jbh, jcore)):
        assert np.array_equal(a, b) and a.any()


def test_build_bioheat_case_bit_identical(cases):
    jcase, tcase, _, _ = cases
    kt, pt = _app_tables(tcase.meta.n_bodies)
    jb = jbh.build_bioheat_case(jcase, kt, pt)
    tb = bh.build_bioheat_case(tcase, kt, pt)
    for name in ("kvol", "diag_extra", "b_fixed", "mass_lump", "free",
                 "dirichlet"):
        a, b = getattr(tb, name).numpy(), np.asarray(getattr(jb, name))
        assert np.array_equal(a, b), name
    assert tb.kvol.dtype == torch.float64 and tb.free.dtype == torch.bool


def test_uniform_temperature_exact(cases):
    """Zero heating with T_air = T_core gives T == T_core exactly (to
    solver tolerance) in both packages, in the same iterations."""
    jcase, tcase, _, _ = cases
    kt, pt = bh.thermal_tables(5, {b: 0.4 for b in range(1, 6)},
                               {b: 2000.0 for b in range(1, 6)})
    res = bh.solve_bioheat(tcase, bh.build_bioheat_case(
        tcase, kt, pt, T_core=37.0, T_air=37.0),
        torch.zeros(tcase.n_tets, dtype=torch.float64))
    ref = jbh.solve_bioheat(jcase, jbh.build_bioheat_case(
        jcase, kt, pt, T_core=37.0, T_air=37.0), jnp.zeros(jcase.n_tets))
    assert bool(res.converged)
    np.testing.assert_allclose(res.phi.numpy(), 37.0, atol=1e-8)
    assert int(res.iterations) == int(ref.iterations)


def test_1d_slab_analytic_and_parity():
    """Insulated-top slab, no perfusion, uniform heating: the exact
    T(z) = T0 + (q/k)(L z - z^2/2) at O(h^2), and the reference's field
    to 1e-8 degC."""
    from pelvistim_fem_tpu.mesh.generate import box_mesh as jbox_mesh
    from pelvistim_fem_tpu.models.case import build_case as jbuild_case
    from pelvistim_fem_tpu_torch.mesh.generate import box_mesh
    from pelvistim_fem_tpu_torch.models.case import build_case
    L, k, q, T0 = 0.02, 0.4, 5.0e4, 37.0
    kt, pt = bh.thermal_tables(1, {1: k}, {1: 0.0})

    def solve_at(h):
        mesh = box_mesh(0.04, 0.04, L, h)
        case = build_case(mesh, {1: 1.0}, mode="voltage",
                          dtype=torch.float64, device="cpu")
        b = bh.build_bioheat_case(case, kt, pt, T_core=T0, T_air=0.0,
                                  h_air=0.0)
        res = bh.solve_bioheat(case, b, torch.full((case.n_tets,), q,
                                                   dtype=torch.float64),
                               tol=1e-12)
        jcase = jbuild_case(jbox_mesh(0.04, 0.04, L, h), {1: 1.0},
                            mode="voltage", dtype=jnp.float64)
        jb = jbh.build_bioheat_case(jcase, kt, pt, T_core=T0, T_air=0.0,
                                    h_air=0.0)
        ref = jbh.solve_bioheat(jcase, jb, jnp.full(jcase.n_tets, q),
                                tol=1e-12)
        assert bool(res.converged)
        T = res.phi.numpy()
        np.testing.assert_allclose(T, np.asarray(ref.phi), **T64)
        assert abs(int(res.iterations) - int(ref.iterations)) <= 1
        z = mesh.nodes[:, 2]
        exact = T0 + (q / k) * (L * z - 0.5 * z * z)
        return np.abs(T - exact).max() / (exact.max() - T0)

    e1, e2 = solve_at(0.002), solve_at(0.001)
    assert e1 < 0.02 and e2 < e1
    assert np.log2(e1 / e2) > 1.6


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_lane_stacked_steady_matches_vmapped_reference(cases, dtype):
    """solve_bioheat on (3, M) heat loads (a zero baseline and two
    heated lanes, the app's layout) against the reference's vmapped
    solve: f64 at 1e-10 to 1e-8 degC with iterations within 1; f32 at
    the app's 3e-6 to 2e-4 degC."""
    jcase, tcase, _, _ = cases
    kt, pt = _app_tables(tcase.meta.n_bodies)
    q = _heat(tcase.n_tets, 3)
    if dtype == "float32":
        from pelvistim_fem_tpu_torch.ops.solve import _case_astype
        tcase = _case_astype(tcase, torch.float32)
        jcase = jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float32)
            if jnp.issubdtype(a.dtype, jnp.floating) else a, jcase)
        tol, bound = 3e-6, dict(atol=2e-4, rtol=0)
    else:
        tol, bound = 1e-10, T64
    res = bh.solve_bioheat(tcase, bh.build_bioheat_case(tcase, kt, pt),
                           torch.as_tensor(q, dtype=getattr(torch, dtype)),
                           tol=tol)
    jb = jbh.build_bioheat_case(jcase, kt, pt)
    ref = jax.vmap(lambda qc: jbh.solve_bioheat(jcase, jb, qc, tol=tol))(
        jnp.asarray(q, getattr(jnp, dtype)))
    assert res.phi.shape == (3, tcase.n_nodes)
    assert bool(res.converged.all()) and bool(np.all(ref.converged))
    np.testing.assert_allclose(res.phi.numpy(), np.asarray(ref.phi),
                               **bound)
    if dtype == "float64":
        assert np.abs(res.iterations.numpy()
                      - np.asarray(ref.iterations)).max() <= 1
    # the stimulation-induced skin rise above the baseline lane
    skin = dict(skin_body=core.BODY_SKIN)
    m = bh.skin_temperature_metrics(tcase, res.phi[1], T_ref=res.phi[0],
                                    **skin)
    mj = jbh.skin_temperature_metrics(jcase, np.asarray(ref.phi[1]),
                                      T_ref=np.asarray(ref.phi[0]), **skin)
    for key in m:
        assert abs(m[key] - mj[key]) <= bound["atol"], key
    assert 0 < m["dT_skin_max"] <= m["dT_max"] + 1e-12


def test_transient_trace_matches_reference(cases):
    """Five warm-started implicit-Euler steps from the baseline, traced
    on the skin nodes as the app does: the final field and every step's
    pointwise rise within 1e-8 degC."""
    jcase, tcase, _, _ = cases
    kt, pt = _app_tables(tcase.meta.n_bodies)
    q = _heat(tcase.n_tets, 2)
    tb = bh.build_bioheat_case(tcase, kt, pt)
    jb = jbh.build_bioheat_case(jcase, kt, pt)
    base = bh.solve_bioheat(tcase, tb, torch.zeros(tcase.n_tets,
                                                   dtype=torch.float64))
    skin_tets = tcase.tets.numpy()[tcase.tet_body.numpy() == core.BODY_SKIN]
    nodes = np.unique(skin_tets)
    T, trace = bh.solve_bioheat_transient(
        tcase, tb, torch.as_tensor(q[1]), base.phi, dt_s=60.0, n_steps=5,
        tol=1e-10, trace_nodes=torch.as_tensor(nodes), trace_ref=base.phi)
    jbase = jnp.asarray(base.phi.numpy())
    jT, jtrace = jbh.solve_bioheat_transient(
        jcase, jb, jnp.asarray(q[1]), jbase, dt_s=60.0, n_steps=5,
        tol=1e-10, trace_nodes=jnp.asarray(nodes), trace_ref=jbase)
    assert trace.shape == (5,)
    np.testing.assert_allclose(trace.numpy(), np.asarray(jtrace), **T64)
    np.testing.assert_allclose(T.numpy(), np.asarray(jT), **T64)
    assert np.all(np.diff(trace.numpy()) > 0)      # monotone heating


def test_stencil_solve_matches_element_path_and_reference(cases):
    """solve_bioheat_stencil (the k-combined 27-point stencil through
    stencil_spmv) against the element-path solve (iterations within 3,
    T within 1e-8 degC, as the reference's own test) and against the
    reference's stencil solve (iterations within 1, T within 1e-8)."""
    from pelvistim_fem_tpu.ops import stencil as jst
    from pelvistim_fem_tpu_torch.ops.stencil import build_stencil_case
    jcase, tcase, jmesh, tmesh = cases
    n_b = tcase.meta.n_bodies
    kt, pt = bh.thermal_tables(n_b, {b: 0.3 + 0.05 * b
                                     for b in range(1, n_b + 1)},
                               {b: 1000.0 * b for b in range(1, n_b + 1)})
    rng = np.random.default_rng(7)
    q = 2e4 * (1 + 0.5 * rng.random(tcase.n_tets))
    tb = bh.build_bioheat_case(tcase, kt, pt)
    ref = bh.solve_bioheat(tcase, tb, torch.as_tensor(q), tol=1e-12)
    sc = build_stencil_case(tcase, tmesh, dtype=torch.float64, device="cpu")
    grid = bh.bioheat_grid_data(tcase, tb, sc)
    q_node = bh.lumped_heat_load(tcase, torch.as_tensor(q))
    out = bh.solve_bioheat_stencil(sc, torch.as_tensor(kt), grid, q_node,
                                   tol=1e-12)
    assert bool(ref.converged) and bool(out.converged)
    assert abs(int(out.iterations) - int(ref.iterations)) <= 3
    np.testing.assert_allclose(out.phi.numpy(), ref.phi.numpy(), **T64)

    jsc = jst.build_stencil_case(jcase, jmesh, dtype=jnp.float64)
    jb = jbh.build_bioheat_case(jcase, kt, pt)
    jgrid = {k: jnp.asarray(v)
             for k, v in jbh.bioheat_grid_data(jcase, jb, jsc).items()}
    for k, v in jgrid.items():
        assert np.array_equal(grid[k].numpy(), np.asarray(v)), k
    jq_node = jbh.lumped_heat_load(jcase, jnp.asarray(q))
    np.testing.assert_allclose(q_node.numpy(), np.asarray(jq_node),
                               rtol=1e-15, atol=0)
    jout = jbh.solve_bioheat_stencil(jsc, jnp.asarray(kt), jgrid, jq_node,
                                     tol=1e-12)
    assert abs(int(out.iterations) - int(jout.iterations)) <= 1
    np.testing.assert_allclose(out.phi.numpy(), np.asarray(jout.phi), **T64)
