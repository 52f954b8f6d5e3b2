"""Multi-electrode array model for lead-field / current-pattern design
(numpy twin of pelvistim_fem_tpu/models/array.py; every spec is
bit-identical to the JAX package's).

A layered tissue slab (muscle, fat, skin) carrying a RING of K surface
disc electrodes on the skin plus one large return electrode on the
bottom plane.  The K basis problems share one lattice and operator (only
the Neumann load differs), so the lead-field matrix is K solves of the
same certified MG operator (ops/leadfield.py).

All K specs are built on identical knot axes (the grading spans every
footprint whichever disc is active), so `body6`, `free`, `coords_dev`
and hence the assembled operator are bit-identical across basis cases;
only `b_neumann` differs.  `build_array_specs` asserts this.
"""

from __future__ import annotations

import numpy as np

from pelvistim_fem_tpu_torch.mesh import core
from pelvistim_fem_tpu_torch.mesh.generate import (LatticeRecipe,
                                                   _footprint_mask)
from pelvistim_fem_tpu_torch.mesh.grading import graded_axis, layered_z_axis
from pelvistim_fem_tpu_torch.mesh.spec import build_lattice_spec

BC_ACTIVE = core.BC_ACTIVE
BC_RETURN = core.BC_RETURN
BC_INSULATED = core.BC_INSULATED


def default_array_params(coarse: bool = False) -> dict:
    """Self-contained geometry and material defaults (a step04-class
    tissue stack with literature conductivities)."""
    return {
        "L_mm": (160.0, 160.0),
        "layers_mm": (("muscle", 20.0), ("fat", 10.0), ("skin", 5.0)),
        "sigma_Spm": {"muscle": 0.35, "fat": 0.04, "skin": 0.10},
        "n_electrodes": 8,
        "ring_r_mm": 45.0,
        "elec_r_mm": 8.0,
        "return_r_mm": 50.0,
        "h_fine_mm": 4.0 if coarse else 2.0,
        "h_coarse_mm": 10.0 if coarse else 5.0,
        "h_z_mm": (5.0, 2.5, 1.25) if coarse else (2.5, 1.25, 0.75),
        "I_unit_A": 1e-3,
        # ROI: sphere centred under the array, mid-muscle depth
        "roi_r_mm": 10.0,
        "roi_depth_mm": 12.0,   # below the skin surface
    }


def electrode_positions(params) -> np.ndarray:
    """(K, 2) xy centres of the ring discs."""
    Lx, Ly = (v * 1e-3 for v in params["L_mm"])
    K = params["n_electrodes"]
    R = params["ring_r_mm"] * 1e-3
    th = 2 * np.pi * np.arange(K) / K
    return np.stack([Lx / 2 + R * np.cos(th),
                     Ly / 2 + R * np.sin(th)], axis=1)


def array_recipe(params, active_idx: int) -> LatticeRecipe:
    """LatticeRecipe with disc `active_idx` driven (BC 1), the bottom
    return pad as BC 2, every other disc insulated (the standard
    lead-field idealization: undriven electrodes absent or floating)."""
    Lx, Ly = (v * 1e-3 for v in params["L_mm"])
    layers = params["layers_mm"]
    Lz = sum(t for _, t in layers) * 1e-3
    pos = electrode_positions(params)
    r_e = params["elec_r_mm"] * 1e-3
    r_ret = params["return_r_mm"] * 1e-3
    h_fine = params["h_fine_mm"] * 1e-3
    h_coarse = params["h_coarse_mm"] * 1e-3
    cx, cy = Lx / 2, Ly / 2

    pad = 1.15
    spans_x = [(px - r_e * pad, px + r_e * pad) for px, _ in pos]
    spans_y = [(py - r_e * pad, py + r_e * pad) for _, py in pos]
    xs = graded_axis(0, Lx, spans_x, h_fine, h_coarse)
    ys = graded_axis(0, Ly, spans_y, h_fine, h_coarse)

    name_to_body = {"muscle": core.BODY_MUSCLE, "fat": core.BODY_FAT,
                    "skin": core.BODY_SKIN}
    interfaces = [0.0]
    hs = []
    for (nm, t), hz in zip(layers, params["h_z_mm"]):
        interfaces.append(interfaces[-1] + t * 1e-3)
        hs.append(hz * 1e-3)
    zs = layered_z_axis(interfaces, hs)
    layer_tops = np.asarray(interfaces[1:])
    layer_ids = np.asarray([name_to_body[nm] for nm, _ in layers],
                           np.int32)

    def body_fn(bx, by, bz):
        idx = np.searchsorted(layer_tops, np.clip(bz, 0, Lz),
                              side="right")
        idx = np.clip(idx, 0, len(layer_ids) - 1)
        return layer_ids[idx]

    z_tol = max(hs[-1] * 1e-3, 1e-9)

    def bcid_fn(fx, fy, fz, nx, ny, nz):
        out = np.full(fx.shape, BC_INSULATED, np.int32)
        top = (nz > 0.5) & (np.abs(fz - Lz) < z_tol)
        ax, ay = pos[active_idx]
        out[top & _footprint_mask(fx, fy, ax, ay, r_e, "circle")] = \
            BC_ACTIVE
        bottom = (nz < -0.5) & (np.abs(fz) < z_tol)
        out[bottom & _footprint_mask(fx, fy, cx, cy, r_ret, "circle")] = \
            BC_RETURN
        return out

    def deform_fn(nodes):
        # one-sided outward rim snap onto every disc (geometry only, the
        # same for every active_idx)
        nodes = nodes.copy()
        rims = [(px, py, r_e) for px, py in pos] + [(cx, cy, r_ret)]
        for ex, ey, r in rims:
            dx = nodes[:, 0] - ex
            dy = nodes[:, 1] - ey
            d = np.hypot(dx, dy)
            band = (d < r) & (d > r - 0.5 * h_fine) & (d > 1e-12)
            disp = np.minimum(r - d[band], 0.35 * h_fine)
            scale = (d[band] + disp) / d[band]
            nodes[band, 0] = ex + dx[band] * scale
            nodes[band, 1] = ey + dy[band] * scale
        return nodes

    return LatticeRecipe(xs, ys, zs, body_fn, bcid_fn, deform_fn)


def build_array_specs(params: dict | None = None, *,
                      coarse: bool = False):
    """K LatticeSpecs on ONE shared lattice: spec k drives disc k with
    `I_unit_A`.  Returns (specs, params, meta); meta carries electrode
    positions, the ROI ball and the preferred stimulation direction."""
    params = params or default_array_params(coarse)
    sigma_by_body = {
        core.BODY_MUSCLE: params["sigma_Spm"]["muscle"],
        core.BODY_FAT: params["sigma_Spm"]["fat"],
        core.BODY_SKIN: params["sigma_Spm"]["skin"],
    }
    K = params["n_electrodes"]
    specs = []
    for k in range(K):
        rec = array_recipe(params, k)
        specs.append(build_lattice_spec(
            rec, sigma_by_body, mode="current",
            injected_current_A=params["I_unit_A"]))
    s0 = specs[0]
    for s in specs[1:]:
        # shared-operator contract: only the load may differ
        assert s.grid_shape == s0.grid_shape
        assert np.array_equal(s.body6, s0.body6)
        assert np.array_equal(s.free, s0.free)
        assert np.array_equal(s.coords_dev, s0.coords_dev)

    Lx, Ly = (v * 1e-3 for v in params["L_mm"])
    Lz = sum(t for _, t in params["layers_mm"]) * 1e-3
    meta = {
        "positions": electrode_positions(params),
        "roi_center": np.array([Lx / 2, Ly / 2,
                                Lz - params["roi_depth_mm"] * 1e-3]),
        "roi_r": params["roi_r_mm"] * 1e-3,
        "target_dir": np.array([0.0, 0.0, 1.0]),
        "Lz": Lz,
    }
    return specs, params, meta
