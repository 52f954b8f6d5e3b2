"""PyTorch port: the element mesh, the step04 Case, the field operators
and the batched metric rows, against the JAX package on the coarse
step04 geometry."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pelvistim_fem_tpu.mesh import boundary as jboundary  # noqa: E402
from pelvistim_fem_tpu.models.pressure import (  # noqa: E402
    build_pressure_case as jax_pressure_case,
    sigma_tables_for_sweep as jax_sweep_tables)
from pelvistim_fem_tpu.ops import fields as jfields  # noqa: E402
from pelvistim_fem_tpu.ops import stencil as jst  # noqa: E402
from pelvistim_fem_tpu.ops.metrics import \
    extract_results_batched as jax_extract  # noqa: E402

from pelvistim_fem_tpu_torch.mesh import boundary  # noqa: E402
from pelvistim_fem_tpu_torch.models.pressure import (  # noqa: E402
    build_pressure_case, sigma_tables_for_sweep)
from pelvistim_fem_tpu_torch.ops import assembly, fields  # noqa: E402
from pelvistim_fem_tpu_torch.ops.metrics import \
    extract_results_batched  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

LANES = [0, 7, 14]


@pytest.fixture(scope="module")
def ref():
    """Both packages' coarse step04 Case (f64) and three JAX-solved
    phis (fused Jacobi sweep, certified to 1e-8)."""
    jcase, params, jmesh = jax_pressure_case(coarse=True, with_mesh=True)
    tcase, tparams, tmesh = build_pressure_case(coarse=True, with_mesh=True,
                                                device="cpu")
    tables = np.array(jax_sweep_tables(jcase, params))[LANES]
    sc = jst.build_stencil_case(jcase, jmesh)
    out = jst.batched_stencil_solve_fused(sc, jnp.asarray(tables), tol=1e-8,
                                          maxiter=30_000)
    return dict(jcase=jcase, jmesh=jmesh, params=params, tcase=tcase,
                tmesh=tmesh, tparams=tparams, tables=tables,
                phis=np.array(out.phi))


def test_mesh_equals_reference(ref):
    jm, tm = ref["jmesh"], ref["tmesh"]
    for name in ("nodes", "tets", "tet_body", "faces", "face_bcid",
                 "face_parent"):
        a, b = getattr(tm, name), getattr(jm, name)
        assert np.array_equal(a, b) and a.dtype == b.dtype, name
    assert tm.lattice.grid_shape == jm.lattice.grid_shape
    assert np.array_equal(tm.lattice.grid_index, jm.lattice.grid_index)
    for a, b in zip(tm.face_areas_normals(), jm.face_areas_normals()):
        assert np.array_equal(a, b)


def test_case_equals_reference(ref):
    """Every array of the Case bit for bit, and the metadata."""
    jc, tc = ref["jcase"], ref["tcase"]
    for f in dataclasses.fields(jc):
        if f.name == "meta":
            continue
        np.testing.assert_array_equal(getattr(tc, f.name).numpy(),
                                      np.asarray(getattr(jc, f.name)),
                                      err_msg=f.name)
    assert dataclasses.asdict(tc.meta) == dataclasses.asdict(jc.meta)
    assert tc.n_nodes == 4290 and tc.n_tets == 20972
    np.testing.assert_array_equal(
        sigma_tables_for_sweep(tc, ref["tparams"]).numpy(),
        np.asarray(jax_sweep_tables(jc, ref["params"])))


def test_boundary_helpers_equal_reference(ref):
    jm, tm = ref["jmesh"], ref["tmesh"]
    np.testing.assert_array_equal(boundary.classify_flat_extremes(
        tm.nodes, tm.faces), jboundary.classify_flat_extremes(jm.nodes,
                                                              jm.faces))
    meta = ref["jcase"].meta
    args = (meta.e1_pos, meta.e2_pos, meta.elec_r)
    assert boundary.detect_electrode_bcids(tm, *args) == \
        jboundary.detect_electrode_bcids(jm, *args)


def test_gather_sum_matches_add_at(ref):
    """The deterministic gather-sum equals an unordered scatter-add."""
    tc = ref["tcase"]
    v = np.random.default_rng(3).standard_normal((2, tc.n_tets, 4))
    expect = np.zeros((2, tc.n_nodes))
    for lane in range(2):
        np.add.at(expect[lane], tc.tets.numpy().ravel(), v[lane].ravel())
    got = assembly.scatter_to_nodes(torch.as_tensor(v), tc.scatter_table)
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-12, atol=1e-15)


def test_fields_match_reference(ref):
    """cell_J, nodal_average, point_to_cell and the consistent electrode
    currents of one lane, f64."""
    jc, tc = ref["jcase"], ref["tcase"]
    phi, tab = ref["phis"][1], ref["tables"][1]
    jJ = jfields.cell_J(jc, jnp.asarray(phi), jnp.asarray(tab))
    tJ = fields.cell_J(tc, torch.as_tensor(phi), torch.as_tensor(tab))
    np.testing.assert_allclose(tJ.numpy(), np.asarray(jJ), rtol=1e-12,
                               atol=1e-12 * float(np.abs(jJ).max()))
    jn = jfields.nodal_average(jc, jJ)
    tn = fields.nodal_average(tc, tJ)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-10,
                               atol=1e-12 * float(np.abs(jn).max()))
    np.testing.assert_allclose(fields.point_to_cell(tc, tn).numpy(),
                               np.asarray(jfields.point_to_cell(jc, jn)),
                               rtol=1e-10, atol=1e-12)
    ja, jr = jfields.consistent_electrode_currents(jc, jnp.asarray(phi),
                                                   jnp.asarray(tab))
    ta, tr = fields.consistent_electrode_currents(tc, torch.as_tensor(phi),
                                                  torch.as_tensor(tab))
    np.testing.assert_allclose([float(ta), float(tr)],
                               [float(ja), float(jr)], rtol=1e-9)


def _assert_rows_equal(got, want):
    """Numbers to rtol 1e-5 with NaN equal (flux_err_consistent, a
    difference of reactions that cancel, to atol 1e-5); strings,
    booleans and None exactly."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            a, b = g[k], w[k]
            if isinstance(b, (bool, str)) or b is None:
                assert a == b, k
            elif k == "flux_err_consistent":
                assert abs(a - b) <= 1e-5, (k, a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5, equal_nan=True,
                                           err_msg=k)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_extract_rows_match_reference(ref, dtype):
    """extract_results_batched on the same three phis (handed over as
    numpy) gives the JAX rows; float32 as the benchmark extracts."""
    labels = [f"s{i:03d}" for i in range(len(LANES))]
    sig = [float(s) for s in ref["tables"][:, 4]]
    jc, params, _ = jax_pressure_case(coarse=True, with_mesh=True,
                                      dtype=getattr(jnp, dtype))
    want = jax_extract(jc, jnp.asarray(ref["phis"], dtype),
                       params, sigma_tables=jnp.asarray(ref["tables"], dtype),
                       pressure_labels=labels, sigma_contacts=sig)
    tdt = getattr(torch, dtype)
    tc, tparams = build_pressure_case(coarse=True, dtype=tdt, device="cpu")
    got = extract_results_batched(
        tc, torch.as_tensor(ref["phis"], dtype=tdt), tparams,
        sigma_tables=torch.as_tensor(ref["tables"], dtype=tdt),
        pressure_labels=labels, sigma_contacts=sig)
    _assert_rows_equal(got, want)
    assert all(r["flux_err"] < 0.05 for r in got)


def test_extract_degenerate_roi_is_nan(ref):
    """An ROI that holds no cell even at 3x gives NaN ROI columns, as
    the reference's rows do."""
    params = dict(ref["params"], roi={"z_target": -1.0,
                                      "roi_radius": 1e-4})
    jc = ref["jcase"]
    want = jax_extract(jc, jnp.asarray(ref["phis"][:1]), params,
                       sigma_tables=jnp.asarray(ref["tables"][:1]))
    tc = ref["tcase"]
    got = extract_results_batched(
        tc, torch.as_tensor(ref["phis"][:1]), params,
        sigma_tables=torch.as_tensor(ref["tables"][:1]))
    assert np.isnan(got[0]["roi_mean_J"]) and got[0]["roi_n_cells"] == 0
    _assert_rows_equal(got, want)


def test_case_defaults_to_the_card():
    """With no device the Case goes to the card, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_pressure_case(coarse=True)
