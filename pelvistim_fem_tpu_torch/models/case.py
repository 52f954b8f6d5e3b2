"""Case: a solver- and metric-ready element problem as a dataclass of
tensors (PyTorch twin of pelvistim_fem_tpu/models/case.py).

Built once on the host (numpy, float64) and moved to the device: element
gradients and volumes, the sorted scatter plan and its gather table, BC
masks, Dirichlet values and the Neumann load with Jn from the TRUE mesh
electrode area, boundary-face areas and outward normals.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pelvistim_fem_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from pelvistim_fem_tpu_torch.mesh.core import TetMesh
from pelvistim_fem_tpu_torch.ops import assembly, bc as bc_ops


@dataclasses.dataclass(frozen=True)
class CaseMeta:
    """Static case metadata (stimulation mode, electrode geometry, layer
    thicknesses, host copy of the sigma table)."""
    mode: str = "voltage"              # "voltage" | "current"
    active_V: float = 1.0              # Dirichlet level (voltage mode)
    I_target_A: float = 0.0            # injected current (current mode)
    jn_used: float = 0.0               # applied Neumann density [A/m^2]
    elec_shape: str = "circle"
    elec_r: float = 0.0
    e1_pos: tuple = (0.0, 0.0, 0.0)    # active electrode centre (x, y, z)
    e2_pos: tuple = (0.0, 0.0, 0.0)    # return electrode centre
    z_skin_top: float = 0.0
    z_e1_elec_top: float = 0.0
    z_e2_elec_top: float = 0.0
    elec_area_mesh: float = 0.0        # true mesh area, active patch
    return_area_mesh: float = 0.0
    contact_enabled: bool = False
    t_skin: float = 0.0
    t_fat: float = 0.0
    compliance_limit_V: float = 100.0
    n_bodies: int = 1
    sigma_table_host: tuple = ()


@dataclasses.dataclass
class Case:
    # geometry / topology
    nodes: torch.Tensor           # (N, 3)
    tets: torch.Tensor            # (M, 4) int64
    tet_body: torch.Tensor        # (M,)   int64
    grads: torch.Tensor           # (M, 4, 3)
    vol: torch.Tensor             # (M,)
    # element -> node scatter plan and its gather table
    scatter_perm: torch.Tensor    # (4M,) int64
    scatter_segids: torch.Tensor  # (4M,) int64
    scatter_table: torch.Tensor   # (N, K) int64 (assembly.gather_table)
    # materials
    sigma_table: torch.Tensor     # (n_bodies + 1,), slot 0 unused
    # boundary conditions
    free_mask: torch.Tensor       # (N,) bool
    dirichlet_vals: torch.Tensor  # (N,)
    b_neumann: torch.Tensor       # (N,)
    # boundary faces (flux metrics)
    faces: torch.Tensor           # (B, 3) int64
    face_bcid: torch.Tensor       # (B,)   int64
    face_parent: torch.Tensor     # (B,)   int64
    face_area: torch.Tensor       # (B,)
    face_normal: torch.Tensor     # (B, 3)
    meta: CaseMeta = dataclasses.field(default_factory=CaseMeta)

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def n_tets(self) -> int:
        return self.tets.shape[0]


def compute_bc_host(mesh: TetMesh, *, mode: str, active_V: float = 1.0,
                    injected_current_A: float = 0.0,
                    strict_area_check: bool = True, face_areas=None):
    """Host BC assembly: (free (N,) bool, dirichlet (N,), b_neumann (N,),
    jn, area_active, area_return)."""
    n = mesh.n_nodes
    if face_areas is None:
        face_areas, _ = mesh.face_areas_normals()
    active_nodes, return_nodes = bc_ops.electrode_node_masks(
        mesh.faces, mesh.face_bcid, n)
    a_act, a_ret = bc_ops.electrode_mesh_areas(face_areas, mesh.face_bcid)

    dirichlet = np.zeros(n)
    free = np.ones(n, dtype=bool)
    b_neu = np.zeros(n)
    jn = 0.0
    if mode == "voltage":
        free[active_nodes] = False
        free[return_nodes] = False
        dirichlet[active_nodes] = active_V
    elif mode == "current":
        if a_act <= 0:
            raise ValueError("current mode requires a nonzero active "
                             "electrode patch")
        # Jn from the TRUE mesh area, so sum(Jn * A_f) == I exactly
        jn = injected_current_A / a_act
        b_neu = bc_ops.neumann_current_load(
            mesh.faces, face_areas, mesh.face_bcid, jn, n)
        if strict_area_check:
            got = b_neu.sum()
            if abs(got - injected_current_A) > 1e-9 * max(
                    abs(injected_current_A), 1.0):
                raise ValueError(
                    f"Neumann load integrates to {got}, expected "
                    f"{injected_current_A}")
        free[return_nodes] = False
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return free, dirichlet, b_neu, jn, a_act, a_ret


def build_case(mesh: TetMesh, sigma_by_body: dict, *,
               mode: str = "voltage", active_V: float = 1.0,
               injected_current_A: float = 0.0,
               meta_extra: Optional[dict] = None, dtype=torch.float64,
               strict_area_check: bool = True,
               device=DEFAULT_DEVICE) -> Case:
    """Assemble a Case from a host mesh and physics spec on `device`.
    sigma_by_body: {body_id: sigma [S/m]}."""
    device = resolve_device(device)
    mesh.validate()
    n = mesh.n_nodes
    grads, vol = mesh.geometry()
    perm, segids = assembly.scatter_plan(mesh.tets, n)
    areas, normals = mesh.face_areas_normals()

    n_bodies = max(sigma_by_body)
    sig = np.zeros(n_bodies + 1)
    for b, s in sigma_by_body.items():
        sig[b] = s

    free, dirichlet, b_neu, jn, a_act, a_ret = compute_bc_host(
        mesh, mode=mode, active_V=active_V,
        injected_current_A=injected_current_A,
        strict_area_check=strict_area_check, face_areas=areas)

    meta = CaseMeta(
        mode=mode,
        active_V=float(active_V),
        I_target_A=injected_current_A,
        jn_used=float(jn),
        elec_area_mesh=a_act,
        return_area_mesh=a_ret,
        n_bodies=n_bodies,
        sigma_table_host=tuple(float(v) for v in sig),
        **dict(meta_extra or {}),
    )
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    i = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64,
                                  device=device)
    return Case(
        nodes=f(mesh.nodes),
        tets=i(mesh.tets),
        tet_body=i(mesh.tet_body),
        grads=f(grads),
        vol=f(vol),
        scatter_perm=i(perm),
        scatter_segids=i(segids),
        scatter_table=i(assembly.gather_table(perm, segids, n)),
        sigma_table=f(sig),
        free_mask=torch.as_tensor(free, device=device),
        dirichlet_vals=f(dirichlet),
        b_neumann=f(b_neu),
        faces=i(mesh.faces),
        face_bcid=i(mesh.face_bcid),
        face_parent=i(mesh.face_parent),
        face_area=f(areas),
        face_normal=f(normals),
        meta=meta,
    )
