"""step01_box workload: uniform box with an analytic solution (twin of
pelvistim_fem_tpu/models/box.py).

phi(z) = z / Lz * V and |J| = sigma V / Lz = 10 A/m^2 for the default
parameters (4 x 4 x 2 cm, sigma 0.2 S/m, 1 V).
"""

from __future__ import annotations

import torch

from pelvistim_fem_tpu_torch.device import DEFAULT_DEVICE
from pelvistim_fem_tpu_torch.mesh.generate import box_mesh
from pelvistim_fem_tpu_torch.models.case import build_case
from pelvistim_fem_tpu_torch.utils.config import default_params


def build_box_case(params: dict | None = None, *, h: float | None = None,
                   dtype=torch.float64, with_mesh: bool = False,
                   device=DEFAULT_DEVICE):
    """(Case, params) of the box on `device` (with the host TetMesh as a
    third item when with_mesh=True); `h` overrides the mesh spacing."""
    params = params or default_params("step01_box")
    g = params["geometry"]
    h = h or params["mesh"]["lc_m"]
    mesh = box_mesh(g["Lx"], g["Ly"], g["Lz"], h)
    st = params.get("stim", {})
    case = build_case(
        mesh,
        {1: params["conductivities"]["sigma"]},
        mode="voltage",
        active_V=st.get("v_active", 1.0),
        meta_extra=dict(z_skin_top=g["Lz"]),
        dtype=dtype,
        device=device,
    )
    if with_mesh:
        return case, params, mesh
    return case, params
