"""The imported-mesh pipeline of the port (models/imported) on the CPU:
the coarse step03 case with its lattice stripped and its bcids scrambled
(1 -> 7, 2 -> 9) is written by the port's writers to a Gmsh .msh, an
Elmer mesh DB and a VTU, read back blind, detected, built and solved on
the AMG element path; the Case equals the JAX package's, and phi and the
metric row agree with the lattice path's solve of the same case and
with the reference's imported solve."""

import dataclasses

import numpy as np
import pytest
import torch

from pelvistim_fem_tpu.models import imported as jimp
from pelvistim_fem_tpu_torch.mesh.io_elmer import write_elmer_mesh
from pelvistim_fem_tpu_torch.mesh.io_msh import write_msh2
from pelvistim_fem_tpu_torch.models import imported
from pelvistim_fem_tpu_torch.models.ankle import build_layered_case
from pelvistim_fem_tpu_torch.ops.metrics import extract_results
from pelvistim_fem_tpu_torch.runner import solve_auto
from pelvistim_fem_tpu_torch.utils.vtu import write_vtu
from torch_threads import one_torch_thread  # noqa: E402,F401

ROW_RTOL = {"compliance_V": 1e-5, "total_current_A": 1e-5,
            "roi_mean_E": 1e-5, "roi_mean_J": 1e-5,
            "peak_J_skin_no_elec": 1e-5, "elec_area_mesh_cm2": 1e-9}


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    case, params, mesh = build_layered_case(coarse=True, with_mesh=True,
                                            device="cpu")
    bc = mesh.face_bcid.copy()
    bc[bc == 1], bc[bc == 2] = 7, 9
    m = dataclasses.replace(mesh, face_bcid=bc, lattice=None)
    d = tmp_path_factory.mktemp("imported")
    write_elmer_mesh(m, d / "elmer_mesh")
    write_msh2(m, d / "mesh.msh")
    write_vtu(d / "mesh.vtu", m, cell_data={"GeometryIds": np.concatenate(
        [m.tet_body, m.face_bcid + 100]).astype(np.int32)},
        include_boundary=True)
    res = solve_auto(case, mesh, tol=1e-8)          # the lattice path
    row = extract_results(case, res.phi, params, verbose=False)
    return dict(dir=d, params=params, phi=res.phi, row=row)


def test_imported_case_equals_reference(exported):
    d, params = exported["dir"], exported["params"]
    mesh = imported.read_mesh_any(d / "elmer_mesh")
    jmesh = jimp.read_mesh_any(d / "elmer_mesh")
    assert mesh.lattice is None
    case, cm = imported.build_imported_case(mesh, params, verbose=False,
                                            with_mesh=True, device="cpu")
    jcase, jcm = jimp.build_imported_case(jmesh, params, verbose=False,
                                          with_mesh=True)
    np.testing.assert_array_equal(cm.face_bcid, jcm.face_bcid)
    assert set(np.unique(cm.face_bcid)) == {1, 2, 3}
    for f in ("free_mask", "dirichlet_vals", "b_neumann", "sigma_table",
              "face_bcid", "vol"):
        np.testing.assert_array_equal(getattr(case, f).numpy(),
                                      np.asarray(getattr(jcase, f)),
                                      err_msg=f)
    for k, v in vars(case.meta).items():
        assert v == getattr(jcase.meta, k), k
    with pytest.raises(ValueError, match="cannot read mesh"):
        imported.read_mesh_any(d / "mesh.txt")


@pytest.mark.parametrize("source", ["elmer_mesh", "mesh.msh", "mesh.vtu"])
def test_solve_imported_matches_the_lattice_path(exported, source):
    out = imported.solve_imported(exported["dir"] / source,
                                  exported["params"], verbose=False,
                                  device="cpu")
    case, res, row, mesh = out
    assert case.nodes.dtype == torch.float64
    assert bool(res.converged) and float(res.residual) <= 1e-8
    ref = exported["phi"]
    d = float((res.phi - ref).abs().max() / ref.abs().max())
    assert d <= 1e-7, d
    for key, rtol in ROW_RTOL.items():
        np.testing.assert_allclose(row[key], exported["row"][key],
                                   rtol=rtol, err_msg=key)
    assert abs(row["flux_err"] - exported["row"]["flux_err"]) <= 1e-5
    assert row["flux_err_consistent"] < 1e-8
    assert abs(row["total_current_A"] - 5e-3) / 5e-3 < 0.02


def test_solve_imported_matches_reference(exported):
    d, params = exported["dir"], exported["params"]
    _, jres, jrow, _ = jimp.solve_imported(d / "elmer_mesh", params,
                                           verbose=False)
    _, res, row, _ = imported.solve_imported(d / "elmer_mesh", params,
                                             verbose=False, device="cpu")
    p = np.asarray(jres.phi)
    np.testing.assert_allclose(res.phi.numpy(), p, rtol=0,
                               atol=1e-8 * np.abs(p).max())
    assert abs(int(res.iterations) - int(np.asarray(jres.iterations))) <= 2
    for key, rtol in ROW_RTOL.items():
        np.testing.assert_allclose(row[key], jrow[key], rtol=rtol,
                                   err_msg=key)
