"""Imported-mesh pipeline: arbitrary tet meshes through detect-BCs ->
build -> solve -> extract (PyTorch twin of
pelvistim_fem_tpu/models/imported.py).

A mesh read from disk (Gmsh .msh v2.2/v4.1, an Elmer mesh DB or a VTU)
has arbitrary boundary ids: the electrode patches are identified
geometrically from the parameters' placement, the ids renumbered to the
canonical 1 = active / 2 = return / 3 = insulated, body ids mapped to
conductivities, and a solver-ready Case assembled whose metric row
matches the lattice path's.  Such a mesh has no lattice, so
runner.solve_auto solves it on the AMG element path.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from pelvistim_fem_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from pelvistim_fem_tpu_torch.mesh.boundary import detect_electrode_bcids
from pelvistim_fem_tpu_torch.mesh.core import (BC_ACTIVE, BC_INSULATED,
                                               BC_RETURN, TetMesh)
from pelvistim_fem_tpu_torch.models.case import Case, build_case
from pelvistim_fem_tpu_torch.utils.config import (default_params,
                                                  get_placement, get_stim)


def read_mesh_any(path) -> TetMesh:
    """Read a mesh from a Gmsh .msh file, an Elmer mesh DB directory or a
    .vtu file."""
    p = Path(path)
    if p.is_dir():
        from pelvistim_fem_tpu_torch.mesh.io_elmer import read_elmer_mesh
        return read_elmer_mesh(p)
    if p.suffix == ".msh":
        from pelvistim_fem_tpu_torch.mesh.io_msh import read_msh
        return read_msh(p)
    if p.suffix == ".vtu":
        from pelvistim_fem_tpu_torch.utils.vtu import read_vtu_mesh
        return read_vtu_mesh(p)
    raise ValueError(f"cannot read mesh from {p} "
                     f"(expect .msh, .vtu, or Elmer mesh directory)")


def build_imported_case(mesh: TetMesh, params: dict | None = None, *,
                        sigma_contact: float | None = None,
                        dtype=torch.float64, verbose: bool = True,
                        with_mesh: bool = False,
                        device=DEFAULT_DEVICE) -> Case:
    """A Case on `device` from an imported mesh with ARBITRARY boundary
    numbering.

    The electrode patches are detected geometrically from the params'
    placement (active_xy / return_xy / electrode_r_mm), then face_bcid is
    renumbered to the canonical ids before build_case.  Body ids: 1 =
    muscle, 2 = fat, 3 = skin, 4 / 5 = contact (sigma_contact where
    present).  with_mesh=True also returns the renumbered mesh, the host
    data of the AMG hierarchy build."""
    device = resolve_device(device)
    params = params or default_params("step03_ankle_layers")
    g = params["geometry"]
    Lz = g["Lz"]
    ls = params.get("layers", {})
    t_skin = float(ls.get("t_skin", 0.0))
    t_fat = float(ls.get("t_fat", 0.0))

    pl = get_placement(params)
    shape = pl.get("electrode_shape", pl.get("shape", "circle"))
    e1x, e1y = map(float, pl.get("active_xy", [0.025, g["Ly"] / 2]))
    e2x, e2y = map(float, pl.get("return_xy",
                                 [g["Lx"] - 0.025, g["Ly"] / 2]))
    elec_r = pl.get("electrode_r_mm", 10.0) * 1e-3

    bc1, bc2, a1, a2 = detect_electrode_bcids(
        mesh, (e1x, e1y), (e2x, e2y), elec_r)
    if verbose:
        print(f"  detected electrodes: active bcid {bc1} "
              f"({a1*1e4:.3f} cm^2), return bcid {bc2} "
              f"({a2*1e4:.3f} cm^2)")

    bcid = np.full(mesh.face_bcid.shape, BC_INSULATED, np.int32)
    bcid[mesh.face_bcid == bc1] = BC_ACTIVE
    bcid[mesh.face_bcid == bc2] = BC_RETURN
    mesh = dataclasses.replace(mesh, face_bcid=bcid)

    c = params.get("conductivities", {})
    ct = params.get("contact", {})
    if sigma_contact is None:
        sigma_contact = ct.get("sigma_contact_Spm", 0.005)
    bodies_present = set(np.unique(mesh.tet_body).tolist())
    defaults = {1: c.get("sigma_muscle", 0.35),
                2: c.get("sigma_fat", 0.04),
                3: c.get("sigma_skin", 1e-3),
                4: sigma_contact, 5: sigma_contact}
    sigma_by_body = {}
    for b in sorted(bodies_present):
        if int(b) not in defaults:
            raise ValueError(f"mesh body id {int(b)} has no conductivity "
                             f"mapping (known: {sorted(defaults)})")
        sigma_by_body[int(b)] = float(defaults[int(b)])
    contact_enabled = 4 in bodies_present or 5 in bodies_present
    t_contact = (ct.get("t_contact_mm", 0.5) * 1e-3
                 if contact_enabled else 0.0)

    st = get_stim(params)
    meta_extra = dict(
        elec_shape=shape,
        elec_r=float(elec_r),
        e1_pos=(e1x, e1y, Lz + t_contact),
        e2_pos=(e2x, e2y, Lz + t_contact),
        z_skin_top=float(Lz),
        z_e1_elec_top=Lz + t_contact,
        z_e2_elec_top=Lz + t_contact,
        contact_enabled=contact_enabled,
        t_skin=t_skin,
        t_fat=t_fat,
        compliance_limit_V=float(st.get("compliance_voltage_V", 100.0)),
    )
    case = build_case(
        mesh, sigma_by_body,
        mode=st.get("control_mode", "voltage"), active_V=1.0,
        injected_current_A=st.get("injected_current_mA", 5.0) * 1e-3,
        meta_extra=meta_extra, dtype=dtype, device=device)
    if with_mesh:
        return case, mesh
    return case


def solve_imported(path, params: dict | None = None, *, tol: float = 1e-8,
                   verbose: bool = True, device=DEFAULT_DEVICE,
                   timer=None):
    """Read mesh -> detect BCs -> assemble -> certified solve
    (runner.solve_auto, true f64 residual <= tol) -> the step03 metric
    row.  Returns (case, SolveResult, row, oriented mesh).  The Case is
    float64 on every device: the AMG path's f64 residual reads its load
    and geometry (an f32 Case would round them by ~6e-8)."""
    from pelvistim_fem_tpu_torch import runner
    from pelvistim_fem_tpu_torch.ops.metrics import extract_results

    device = resolve_device(device)
    params = params or default_params("step03_ankle_layers")
    mesh = read_mesh_any(path).with_positive_volumes()
    case, mesh_c = build_imported_case(
        mesh, params, dtype=torch.float64, verbose=verbose,
        with_mesh=True, device=device)
    res = runner.solve_auto(case, mesh=mesh_c, tol=tol, timer=timer)
    row = extract_results(case, res.phi, params, verbose=verbose)
    return case, res, row, mesh
