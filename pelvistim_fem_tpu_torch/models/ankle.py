"""step03_ankle_layers front end: 3-layer ankle slab + contact volumes,
current-controlled stimulation (twin of pelvistim_fem_tpu/models/ankle.py:
the lattice spec for the stencil solvers, the element Case for the
metrics).

  * 12-point ankle outline polygon
  * anatomical height field z_top(x, y) with medial-groove / Achilles /
    malleolus Gaussian features
  * extruded muscle/fat/skin layers with optional thin contact volumes
    under each electrode, as a graded structured lattice.
"""

from __future__ import annotations

import numpy as np
import torch

from pelvistim_fem_tpu_torch.device import DEFAULT_DEVICE
from pelvistim_fem_tpu_torch.mesh import core
from pelvistim_fem_tpu_torch.utils.config import (default_params,
                                                  get_placement, get_stim)


def ankle_outline_pts(Lx: float, Ly: float):
    """12-point polygon approximating an ankle cross-section."""
    frac = [
        (0.25, 0.02), (0.50, 0.00), (0.75, 0.02), (0.97, 0.22),
        (1.00, 0.47), (0.93, 0.72), (0.75, 0.97), (0.50, 1.00),
        (0.25, 0.97), (0.07, 0.72), (0.02, 0.47), (0.07, 0.22),
    ]
    return [(fx * Lx, fy * Ly) for fx, fy in frac]


def ankle_z_top(x, y, Lx, Ly, Lz):
    """Skin-surface height field: flat Lz plus a -4 mm medial groove,
    +3 mm Achilles bump and +2 mm lateral malleolus.  Vectorized."""
    xn = np.asarray(x) / Lx
    yn = np.asarray(y) / Ly
    h = np.full(np.broadcast(xn, yn).shape, float(Lz))
    r2 = ((xn - 0.02) / 0.12) ** 2 + ((yn - 0.47) / 0.18) ** 2
    h = h - 0.004 * np.exp(-r2)
    r2 = ((xn - 0.50) / 0.18) ** 2 + ((yn - 0.97) / 0.07) ** 2
    h = h + 0.003 * np.exp(-r2)
    r2 = ((xn - 0.97) / 0.07) ** 2 + ((yn - 0.47) / 0.18) ** 2
    h = h + 0.002 * np.exp(-r2)
    return h


def layered_model_inputs(params: dict | None = None, *,
                         t_fat: float | None = None,
                         elec_r: float | None = None,
                         sigma_skin: float | None = None,
                         sigma_contact: float | None = None,
                         coarse: bool = False,
                         explicit_zs=None):
    """Resolve step03/step04 params into ((Lx, Ly, Lz), recipe_kwargs,
    sigma_by_body, bc_kwargs, meta_extra, params)."""
    params = params or default_params("step03_ankle_layers")
    g = params["geometry"]
    Lx, Ly, Lz = g["Lx"], g["Ly"], g["Lz"]
    ls = params["layers"]
    t_skin = ls["t_skin"]
    t_fat = t_fat if t_fat is not None else ls["t_fat"]
    t_muscle = Lz - t_skin - t_fat
    if t_muscle <= 1e-4:
        raise ValueError(
            f"t_muscle = {t_muscle*1000:.2f} mm <= 0.1 mm — reduce "
            f"t_fat + t_skin or increase Lz")

    pl = get_placement(params)
    shape = pl.get("electrode_shape", pl.get("shape", "circle"))
    e1x, e1y = map(float, pl.get("active_xy", [0.025, Ly / 2]))
    e2x, e2y = map(float, pl.get("return_xy", [Lx - 0.025, Ly / 2]))
    if elec_r is None:
        elec_r = pl.get("electrode_r_mm", 10.0) * 1e-3

    ct = params.get("contact", {})
    contact_enabled = bool(ct.get("enabled", False)) and \
        ct.get("model", "layer") == "layer"
    t_contact = ct.get("t_contact_mm", 0.5) * 1e-3 if contact_enabled else 0.0

    m = params.get("mesh", {})
    scale = 2.0 if coarse else 1.0
    lc_elec = m.get("lc_electrode_mm", 1.5) * 1e-3 * scale
    lc_bulk = m.get("lc_global_mm", 3.0) * 1e-3 * scale
    lc_min = m.get("lc_skin_min", 0.5) * 1e-3 * scale

    cross = g.get("cross_section", "rect")
    z_e1_skin = (float(ankle_z_top(e1x, e1y, Lx, Ly, Lz))
                 if cross == "ankle" else Lz)
    z_e2_skin = (float(ankle_z_top(e2x, e2y, Lx, Ly, Lz))
                 if cross == "ankle" else Lz)

    layers = [
        (core.BODY_MUSCLE, t_muscle, lc_bulk),
        (core.BODY_FAT, t_fat, min(lc_bulk, max(t_fat / 2, lc_min))),
        (core.BODY_SKIN, t_skin, max(t_skin / 3, lc_min / 2)),
    ]
    recipe_kwargs = dict(
        layers=layers,
        electrodes=[(e1x, e1y, elec_r), (e2x, e2y, elec_r)],
        elec_shape=shape,
        contact_t=t_contact,
        contact_h_z=t_contact if t_contact > 0 else None,
        h_fine=lc_elec,
        h_coarse=lc_bulk,
        rim_refine=float(m.get("rim_refine", 0.0)),
        rim_band_w=float(m.get("rim_band_w_mm", 0.0)) * 1e-3,
        cross_section=cross,
        ankle_z_top_fn=(
            (lambda x, y: ankle_z_top(x, y, Lx, Ly, Lz))
            if cross == "ankle" else None),
        outline_polygon=(ankle_outline_pts(Lx, Ly)
                         if cross == "ankle" else None),
        explicit_zs=explicit_zs,
    )

    c = params["conductivities"]
    sigma_skin = sigma_skin if sigma_skin is not None else c["sigma_skin"]
    sigma_contact = (sigma_contact if sigma_contact is not None
                     else ct.get("sigma_contact_Spm", 0.005))
    sigma_by_body = {
        core.BODY_MUSCLE: c["sigma_muscle"],
        core.BODY_FAT: c["sigma_fat"],
        core.BODY_SKIN: sigma_skin,
    }
    if contact_enabled:
        sigma_by_body[core.BODY_CONTACT_ACTIVE] = sigma_contact
        sigma_by_body[core.BODY_CONTACT_RETURN] = sigma_contact

    st = get_stim(params)
    mode = st.get("control_mode", "voltage")
    meta_extra = dict(
        elec_shape=shape,
        elec_r=float(elec_r),
        e1_pos=(e1x, e1y, z_e1_skin + t_contact),
        e2_pos=(e2x, e2y, z_e2_skin + t_contact),
        z_skin_top=float(Lz),
        z_e1_elec_top=z_e1_skin + t_contact,
        z_e2_elec_top=z_e2_skin + t_contact,
        contact_enabled=contact_enabled,
        t_skin=float(t_skin),
        t_fat=float(t_fat),
        compliance_limit_V=float(st.get("compliance_voltage_V", 100.0)),
    )
    bc_kwargs = dict(
        mode=mode,
        active_V=1.0,
        injected_current_A=st.get("injected_current_mA", 5.0) * 1e-3,
    )
    return (Lx, Ly, Lz), recipe_kwargs, sigma_by_body, bc_kwargs, \
        meta_extra, params


def build_layered_case(params: dict | None = None, *,
                       t_fat: float | None = None,
                       elec_r: float | None = None,
                       sigma_skin: float | None = None,
                       sigma_contact: float | None = None,
                       coarse: bool = False,
                       dtype=torch.float64,
                       with_mesh: bool = False,
                       explicit_zs=None,
                       device=DEFAULT_DEVICE):
    """(Case, params) for one step03 sweep point on `device` (with the
    host TetMesh as a third item when with_mesh=True).  `coarse=True`
    doubles the mesh spacings."""
    from pelvistim_fem_tpu_torch.mesh.generate import layered_slab_mesh
    from pelvistim_fem_tpu_torch.models.case import build_case
    (Lx, Ly, Lz), recipe_kwargs, sigma_by_body, bc_kwargs, meta_extra, \
        params = layered_model_inputs(
            params, t_fat=t_fat, elec_r=elec_r, sigma_skin=sigma_skin,
            sigma_contact=sigma_contact, coarse=coarse,
            explicit_zs=explicit_zs)
    mesh = layered_slab_mesh(Lx, Ly, Lz, **recipe_kwargs)
    case = build_case(mesh, sigma_by_body, meta_extra=meta_extra,
                      dtype=dtype, device=device, **bc_kwargs)
    if with_mesh:
        return case, params, mesh
    return case, params


def build_layered_spec(params: dict | None = None, *,
                       t_fat: float | None = None,
                       elec_r: float | None = None,
                       sigma_skin: float | None = None,
                       sigma_contact: float | None = None,
                       coarse: bool = False,
                       explicit_zs=None):
    """(LatticeSpec, params) for one step03 sweep point — the front end
    of the device-side assembly (ops/lattice_assembly.py).  `coarse=True`
    doubles the mesh spacings."""
    from pelvistim_fem_tpu_torch.mesh.generate import layered_slab_recipe
    from pelvistim_fem_tpu_torch.mesh.spec import build_lattice_spec
    (Lx, Ly, Lz), recipe_kwargs, sigma_by_body, bc_kwargs, _, params = \
        layered_model_inputs(
            params, t_fat=t_fat, elec_r=elec_r, sigma_skin=sigma_skin,
            sigma_contact=sigma_contact, coarse=coarse,
            explicit_zs=explicit_zs)
    recipe = layered_slab_recipe(Lx, Ly, Lz, **recipe_kwargs)
    spec = build_lattice_spec(recipe, sigma_by_body, **bc_kwargs)
    return spec, params


def megatet_spec():
    """(LatticeSpec, params) of the benchmark's large step03 case
    (bench.py's megatet leg): the default step03 parameters at mesh
    spacings lc 1.1 / 0.7 / 0.4 mm, a (112, 68, 41) lattice of
    1,747,398 tets."""
    params = default_params("step03_ankle_layers")
    params["mesh"] = {"lc_global_mm": 1.1, "lc_electrode_mm": 0.7,
                      "lc_skin_min": 0.4}
    return build_layered_spec(params)
