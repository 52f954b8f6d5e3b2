"""step02_electrodes workload: bipolar surface electrodes on a 15 x 15 x
5 cm slab, shape x radius sweep (twin of
pelvistim_fem_tpu/models/electrodes.py).

Two electrode patches on the top face (+1 V / 0 V); the lattice is graded
to lc_elec = r / 3.5 near the electrodes and lc_bulk = min(4 r, 12 mm)
elsewhere.
"""

from __future__ import annotations

import torch

from pelvistim_fem_tpu_torch.device import DEFAULT_DEVICE
from pelvistim_fem_tpu_torch.mesh import core
from pelvistim_fem_tpu_torch.mesh.generate import layered_slab_mesh
from pelvistim_fem_tpu_torch.models.case import build_case
from pelvistim_fem_tpu_torch.utils.config import (default_params,
                                                  get_placement)


def build_electrode_case(params: dict | None = None, *,
                         shape: str = "circle", r: float = 0.01,
                         dtype=torch.float64, with_mesh: bool = False,
                         device=DEFAULT_DEVICE):
    """(Case, params) of one step02 case on `device` (with the host
    TetMesh as a third item when with_mesh=True)."""
    params = params or default_params("step02_electrodes")
    g = params["geometry"]
    Lx, Ly, Lz = g["Lx"], g["Ly"], g["Lz"]
    pl = get_placement(params)
    sep = pl.get("separation", 0.06)
    e1 = (Lx / 2 - sep / 2, Ly / 2, r)
    e2 = (Lx / 2 + sep / 2, Ly / 2, r)

    lc_elec = r / 3.5
    lc_bulk = min(r * 4, params.get("mesh", {}).get("lc_bulk_max_m", 0.012))

    # two z-bands of the same tissue body: fine near the electrode
    # surface, coarse at depth
    z_fine = min(3 * lc_elec, Lz / 3)
    layers = [
        (core.BODY_TISSUE, Lz - z_fine, lc_bulk),
        (core.BODY_TISSUE, z_fine, lc_elec),
    ]
    mesh = layered_slab_mesh(
        Lx, Ly, Lz,
        layers=layers,
        electrodes=[e1, e2],
        elec_shape=shape,
        contact_t=0.0,
        h_fine=lc_elec,
        h_coarse=lc_bulk,
    )
    case = build_case(
        mesh,
        {core.BODY_TISSUE: params["conductivities"]["sigma"]},
        mode="voltage",
        active_V=params.get("stim", {}).get("v_active", 1.0),
        meta_extra=dict(
            elec_shape=shape,
            elec_r=float(r),
            e1_pos=(e1[0], e1[1], Lz),
            e2_pos=(e2[0], e2[1], Lz),
            z_skin_top=float(Lz),
            z_e1_elec_top=float(Lz),
            z_e2_elec_top=float(Lz),
        ),
        dtype=dtype,
        device=device,
    )
    if with_mesh:
        return case, params, mesh
    return case, params
