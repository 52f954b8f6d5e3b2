"""Post-processed metrics of a solve or a sweep (PyTorch twin of
pelvistim_fem_tpu/ops/metrics.py: `injected_currents`,
`compliance_voltage`, the serial `extract_results` and the batched
`extract_results_batched`).

All lanes' metric scalars come out of one device pass over a lane axis
(no vmap) and one host read of an (10, L) stack; the lane-independent
geometry (ROI mask with the reference's auto-expansion, skin and
footprint masks, electrode node masks, layer fractions) is computed once
on the host and cached on the case.  Rows are assembled by `_build_row`,
a copy of the reference's, so columns, rounding and NaN rules match:

  * surface flux integrals over the tagged electrode faces, KCL error
    (flux_err), and the exact weak-form reaction currents
    (flux_err_consistent)
  * ROI mean |J|, smoothed |E| and raw P1 |E|; skin-surface peak |J|
    with and without the electrode footprints; compliance voltage
  * step04 extras: contact impedance Z = V / I, charge density
    Q = J t_pulse 0.1 [mC/cm^2], safety flags
"""

from __future__ import annotations

import numpy as np
import torch

from pelvistim_fem_tpu_torch.mesh.core import BC_ACTIVE, BC_RETURN
from pelvistim_fem_tpu_torch.ops import fields

ROI_EXPANSION = (1.0, 1.5, 2.0, 3.0)  # ROI radius multipliers, in order


def injected_currents(case, phi, sigma_table=None, *, nodal_J=None):
    """Electrode patch currents over the tagged BC faces and the KCL flux
    error, plus the exact weak-form reaction currents: a dict of floats
    (I_active, I_return, their signed forms, flux_err, I_active_consistent,
    I_return_consistent, flux_err_consistent).  Outward normals: the
    current injected at the active electrode is a negative flux there.
    sigma_table: (T,) scalars or (T, 3, 3) tensors (ops/fields)."""
    flux = fields.boundary_face_flux(case, phi, sigma_table,
                                     nodal_J=nodal_J).cpu().numpy()
    bcid = case.face_bcid.cpu().numpy()
    I_active_signed = float(flux[bcid == BC_ACTIVE].sum())
    I_return_signed = float(flux[bcid == BC_RETURN].sum())
    I_active = abs(I_active_signed)
    I_return = abs(I_return_signed)
    denom = max(I_active, I_return)
    flux_err = (abs(I_active_signed + I_return_signed) / denom
                if denom > 0 else np.nan)
    ia_c, ir_c = fields.consistent_electrode_currents(case, phi, sigma_table)
    ia_c, ir_c = float(ia_c), float(ir_c)
    denom_c = max(abs(ia_c), abs(ir_c))
    return dict(I_active=I_active, I_return=I_return,
                I_active_signed=I_active_signed,
                I_return_signed=I_return_signed, flux_err=flux_err,
                I_active_consistent=ia_c, I_return_consistent=ir_c,
                flux_err_consistent=(abs(ia_c - ir_c) / denom_c
                                     if denom_c > 0 else np.nan))


def compliance_voltage(case, phi):
    """Mean potential of the active electrode's nodes minus that of the
    return electrode's (the nodes of the tagged BC faces); NaN without an
    active patch.  phi (N,), on any device."""
    from pelvistim_fem_tpu_torch.ops.bc import electrode_node_masks
    act, ret = electrode_node_masks(case.faces.cpu().numpy(),
                                    case.face_bcid.cpu().numpy(),
                                    case.n_nodes)
    phi_np = phi.cpu().numpy()
    if not act.any():
        return np.nan
    v_act = float(phi_np[act].mean())
    v_ret = float(phi_np[ret].mean()) if ret.any() else 0.0
    return v_act - v_ret


def extract_results(case, phi, params, *, sigma_table=None,
                    pressure_label=None, sigma_contact=None, verbose=True):
    """The full metric row of one solve, phi (N,): the batched extractor
    with one lane (the reference's serial and batched extractors share
    `_build_row`, so the rows agree)."""
    tables = None if sigma_table is None else sigma_table[None]
    return extract_results_batched(
        case, phi[None], params, sigma_tables=tables,
        pressure_labels=(None if pressure_label is None
                         else [pressure_label]),
        sigma_contacts=None if sigma_contact is None else [sigma_contact],
        verbose=verbose)[0]


def _in_footprint(x, y, cx, cy, r, shape):
    if shape == "square":
        return (np.abs(x - cx) < r) & (np.abs(y - cy) < r)
    return np.sqrt((x - cx) ** 2 + (y - cy) ** 2) < r


def _roi_layer_fractions(cen, roi_cen, roi_r_used, meta):
    """ROI layer fractions; lane-independent geometry."""
    t_sk, t_fat = meta.t_skin, meta.t_fat
    z_fat_bot = meta.z_skin_top - t_sk - t_fat
    z_fat_top = meta.z_skin_top - t_sk
    dist = np.linalg.norm(cen - roi_cen, axis=1)
    roi_mask = dist < roi_r_used
    if roi_mask.any():
        z_roi = cen[roi_mask, 2]
        n_roi = roi_mask.sum()
        frac_skin = float((z_roi > z_fat_top).sum()) / n_roi
        frac_fat = float(((z_roi > z_fat_bot)
                          & (z_roi <= z_fat_top)).sum()) / n_roi
        frac_muscle = float((z_roi <= z_fat_bot).sum()) / n_roi
    else:
        frac_skin = frac_fat = frac_muscle = np.nan
    return frac_skin, frac_fat, frac_muscle, roi_mask


def _build_row(meta, params, s, *, cen, layer_fracs=None,
               pressure_label=None, sigma_contact=None, verbose=True):
    """Assemble the full row dict from named scalars `s`."""
    from pelvistim_fem_tpu_torch.utils.config import get_stim

    st = get_stim(params)
    mode = meta.mode

    I_active_signed = float(s["I_active_signed"])
    I_return_signed = float(s["I_return_signed"])
    I_active = abs(I_active_signed)
    I_return = abs(I_return_signed)
    denom = max(I_active, I_return)
    flux_err = (abs(I_active_signed + I_return_signed) / denom
                if denom > 0 else np.nan)
    ia_c = float(s["I_active_consistent"])
    ir_c = float(s["I_return_consistent"])
    denom_c = max(abs(ia_c), abs(ir_c))
    flux_err_c = abs(ia_c - ir_c) / denom_c if denom_c > 0 else np.nan
    if verbose:
        print(f"    I_active={I_active:.4e} A  I_return={I_return:.4e} A  "
              f"flux_err={flux_err:.2e}")

    # hard 2% warning for current-mode deviations
    if mode == "current" and meta.I_target_A > 0 and np.isfinite(I_active):
        dev = abs(I_active - meta.I_target_A) / meta.I_target_A
        if dev > 0.02 and verbose:
            print(f"    *** CURRENT ERROR > 2%: measured {I_active*1e3:.3f}"
                  f" mA vs target {meta.I_target_A*1e3:.1f} mA "
                  f"({dev:.1%} deviation) ***")

    compliance_V = float(s["compliance_V"])
    exceeded_compliance = False
    if mode == "current" and np.isfinite(compliance_V):
        cmp_lim = st.get("compliance_voltage_V", 100.0)
        exceeded_compliance = bool(compliance_V > cmp_lim)
        if exceeded_compliance and verbose:
            print(f"    WARNING: compliance_V={compliance_V:.1f} V > "
                  f"limit {cmp_lim:.0f} V")

    r_cfg = params["roi"]
    z_nerve = meta.z_skin_top - r_cfg["z_target"]
    roi_cen = np.array([meta.e1_pos[0], meta.e1_pos[1], z_nerve])
    peak_with, peak_no = float(s["peak_with"]), float(s["peak_no"])
    mean_J_roi = float(s["mean_J_roi"])
    mean_E_roi = float(s["mean_E_roi"])
    mean_E_p1 = float(s["mean_E_p1"])
    roi_n, roi_r_used = int(s["roi_n"]), float(s["roi_r_used"])
    if s.get("roi_warn") and verbose:
        print(f"    ROI: {s['roi_warn']}")

    t_sk, t_fat = meta.t_skin, meta.t_fat
    z_fat_bot = meta.z_skin_top - t_sk - t_fat
    z_fat_top = meta.z_skin_top - t_sk
    if layer_fracs is not None:      # lane-independent, precomputed
        frac_skin, frac_fat, frac_muscle = layer_fracs
    else:
        frac_skin, frac_fat, frac_muscle, _ = _roi_layer_fractions(
            cen, roi_cen, roi_r_used, meta)

    area = (np.pi * meta.elec_r ** 2 if meta.elec_shape == "circle"
            else (2 * meta.elec_r) ** 2)
    efficiency = (float(mean_E_roi) / peak_no
                  if (np.isfinite(mean_E_roi) and np.isfinite(peak_no)
                      and peak_no > 0) else np.nan)
    I_ref = I_active if np.isfinite(I_active) and I_active > 0 else np.nan

    def _norm(v):
        v = float(v)
        return v / I_ref if np.isfinite(v) and np.isfinite(I_ref) else np.nan

    roi_layer = ("skin" if z_nerve > z_fat_top
                 else "fat" if z_nerve > z_fat_bot else "muscle")

    def _r(v, nd):
        v = float(v)
        return round(v, nd) if np.isfinite(v) else v

    c = params.get("conductivities", {})
    out = {
        "t_fat_mm": _r(t_fat * 1000, 2),
        "elec_r_mm": _r(meta.elec_r * 1000, 2),
        "elec_area_cm2": _r(area * 1e4, 4),
        "elec_area_mesh_cm2": _r(meta.elec_area_mesh * 1e4, 4),
        "return_area_mesh_cm2": _r(meta.return_area_mesh * 1e4, 4),
        "elec_shape": meta.elec_shape,
        "contact_enabled": meta.contact_enabled,
        "sigma_skin": c.get("sigma_skin"),
        "control_mode": mode,
        "jn_used": _r(meta.jn_used, 4) if meta.jn_used else None,
        "peak_J_skin_with_elec": _r(peak_with, 6),
        "peak_J_skin_no_elec": _r(peak_no, 6),
        "roi_mean_J": _r(mean_J_roi, 6),
        "roi_mean_E": _r(mean_E_roi, 4),
        "efficiency": _r(efficiency, 6),
        "compliance_V": _r(compliance_V, 3),
        "exceeded_compliance": exceeded_compliance,
        "total_current_A": _r(I_active, 8),
        "I_active_signed_A": _r(I_active_signed, 8),
        "I_return_A": _r(I_return, 8),
        "I_return_signed_A": _r(I_return_signed, 8),
        "peak_J_skin_per_A": _r(_norm(peak_no), 4),
        "roi_mean_J_per_A": _r(_norm(mean_J_roi), 4),
        "roi_mean_E_per_A": _r(_norm(mean_E_roi), 4),
        "efficiency_per_A": _r(efficiency, 6),
        "flux_err": _r(flux_err, 6),
        # exact discrete electrode currents from the weak-form reaction
        "roi_mean_E_p1": _r(mean_E_p1, 4),
        "I_active_consistent_A": _r(ia_c, 10),
        "I_return_consistent_A": _r(ir_c, 10),
        "flux_err_consistent": _r(flux_err_c, 10),
        "roi_layer": roi_layer,
        "roi_n_cells": roi_n,
        "roi_radius_used_mm": _r(roi_r_used * 1000, 2),
        "roi_center_z_mm": _r(z_nerve * 1000, 3),
        "dist_fat_muscle_mm": _r(abs(z_nerve - z_fat_bot) * 1000, 3),
        "roi_frac_muscle": _r(frac_muscle, 4),
        "roi_frac_fat": _r(frac_fat, 4),
        "roi_frac_skin": _r(frac_skin, 4),
        "active_boundary_id_used": BC_ACTIVE,
        "return_boundary_id_used": BC_RETURN,
    }

    # step04 extras
    if pressure_label is not None or sigma_contact is not None:
        contact_Z = (float(compliance_V / I_active)
                     if (np.isfinite(compliance_V) and np.isfinite(I_active)
                         and I_active > 0) else np.nan)
        pw_us = st.get("pulse_width_us", 200.0)
        # C/m^2 -> mC/cm^2 is a factor 0.1
        charge_density = (float(peak_with * pw_us * 1e-6 * 0.1)
                          if np.isfinite(peak_with) else np.nan)
        limit = params.get("safety", {}).get(
            "charge_density_limit_mC_cm2", 1.0)
        out.update({
            "pressure_label": pressure_label,
            "sigma_contact_Spm": sigma_contact,
            "contact_impedance_ohm": _r(contact_Z, 1),
            "jn_used_A_m2": _r(meta.jn_used, 6),
            "charge_density_mC_cm2": _r(charge_density, 6),
            "exceeds_charge_limit": bool(np.isfinite(charge_density)
                                         and charge_density > limit),
            "pulse_width_us": pw_us,
            "frequency_Hz": st.get("frequency_Hz", 10.0),
        })
    return out


_SCALAR_KEYS = ("I_active_signed", "I_return_signed",
                "I_active_consistent", "I_return_consistent",
                "peak_with", "peak_no", "mean_J_roi", "mean_E_roi",
                "mean_E_p1", "compliance_V")


def _batched_metric_scalars(case, phis, sigma_tables, masks):
    """Per-lane metric scalars over the lane axis of phis (L, N) and
    sigma_tables (L, T), as a dict of (L,) numpy arrays (one host read)."""
    def norm(a):
        return torch.sqrt(torch.sum(a * a, -1))

    def mmean(x, m, n):
        return torch.sum(torch.where(m, x, 0.0), -1) / n

    J_cell = fields.cell_J(case, phis, sigma_tables)          # (L, M, 3)
    E_cell = fields.cell_E(case, phis)
    Jn = fields.nodal_average(case, J_cell)                   # (L, N, 3)
    E_sm = fields.point_to_cell(case, fields.nodal_average(case, E_cell))
    Jmag_n = norm(Jn)
    Jmag_c = norm(J_cell)
    Emag_sm = norm(E_sm)
    Emag_p1 = norm(E_cell)

    # surface flux (nodal scheme: a face's J is its vertices' mean)
    Jf = Jn[:, case.faces].mean(-2)                           # (L, B, 3)
    flux = torch.sum(Jf * case.face_normal, -1) * case.face_area
    Ia_s = torch.sum(torch.where(masks["face_act"], flux, 0.0), -1)
    Ir_s = torch.sum(torch.where(masks["face_ret"], flux, 0.0), -1)
    ia_c, ir_c = fields.consistent_electrode_currents(case, phis,
                                                      sigma_tables)

    neg = torch.tensor(-torch.inf, dtype=Jmag_n.dtype, device=Jmag_n.device)
    peak_with = torch.max(torch.where(masks["skin"], Jmag_n, neg), -1).values
    peak_no = torch.max(torch.where(masks["skin_no"], Jmag_n, neg),
                        -1).values

    n_roi = torch.clamp(torch.sum(masks["roi"]), min=1)
    mean_J = mmean(Jmag_c, masks["roi"], n_roi)
    mean_E = mmean(Emag_sm, masks["roi"], n_roi)
    mean_E_p1 = mmean(Emag_p1, masks["roi"], n_roi)

    n_act = torch.clamp(torch.sum(masks["act"]), min=1)
    n_ret = torch.clamp(torch.sum(masks["ret"]), min=1)
    compliance = (mmean(phis, masks["act"], n_act)
                  - mmean(phis, masks["ret"], n_ret))
    vals = (Ia_s, Ir_s, ia_c, ir_c, peak_with, peak_no, mean_J, mean_E,
            mean_E_p1, compliance)
    stacked = torch.stack(vals).cpu().numpy()
    return {k: stacked[j] for j, k in enumerate(_SCALAR_KEYS)}


def extract_results_batched(case, phis, params, *, sigma_tables=None,
                            pressure_labels=None, sigma_contacts=None,
                            verbose=False):
    """All sweep lanes' metric rows: one device pass over the lane axis
    and one host read of (L,) scalars.  phis (L, N) and sigma_tables
    (L, T) lie on the case's device; sigma_tables defaults to the case's
    own table in every lane."""
    meta = case.meta
    L = phis.shape[0]
    if sigma_tables is None:
        sigma_tables = case.sigma_table.expand((L,) +
                                               case.sigma_table.shape)

    geom = _metric_geometry(case, params)
    out = _batched_metric_scalars(case, phis, sigma_tables, geom["masks"])
    # degenerate masks give NaN, as the serial extractor does, not the
    # masked 0.0 / -inf
    if geom["roi_n"] == 0:
        for k in ("mean_J_roi", "mean_E_roi", "mean_E_p1"):
            out[k] = np.full_like(out[k], np.nan)
    if geom["skin_empty"]:
        out["peak_with"] = np.full_like(out["peak_with"], np.nan)
        out["peak_no"] = np.full_like(out["peak_no"], np.nan)

    rows = []
    for i in range(L):
        s = {k: v[i] for k, v in out.items()}
        if meta.mode != "current":
            s["compliance_V"] = np.nan
        s.update(roi_n=geom["roi_n"], roi_r_used=geom["roi_r_used"],
                 roi_warn=geom["roi_warn"])
        rows.append(_build_row(
            meta, params, s, cen=geom["cen"],
            layer_fracs=geom["layer_fracs"],
            pressure_label=(pressure_labels[i] if pressure_labels
                            else None),
            sigma_contact=(sigma_contacts[i] if sigma_contacts is not None
                           else None),
            verbose=verbose))
    return rows


def _metric_geometry(case, params):
    """Lane-independent extraction geometry, cached on the case for its
    (roi_radius, z_target)."""
    from pelvistim_fem_tpu_torch.ops.bc import electrode_node_masks

    meta = case.meta
    r_cfg = params["roi"]
    key = (float(r_cfg["roi_radius"]), float(r_cfg["z_target"]))
    cached = getattr(case, "_metric_geom_cache", None)
    if cached is not None and cached[0] == key:
        return cached[1]

    nodes = case.nodes.cpu().numpy()
    tets_np = case.tets.cpu().numpy()
    cen = nodes[tets_np].mean(axis=1)
    z_nerve = meta.z_skin_top - r_cfg["z_target"]
    roi_cen = np.array([meta.e1_pos[0], meta.e1_pos[1], z_nerve])
    dist = np.linalg.norm(cen - roi_cen, axis=1)
    # auto-expansion: the first multiplier with at least 4 cells
    roi_r_used = r_cfg["roi_radius"] * ROI_EXPANSION[-1]
    roi_warn = None
    for mult in ROI_EXPANSION:
        if int((dist < r_cfg["roi_radius"] * mult).sum()) >= 4:
            roi_r_used = r_cfg["roi_radius"] * mult
            if mult > 1.0:
                roi_warn = (f"ROI radius expanded {mult:.1f}x to "
                            f"{roi_r_used*1000:.1f} mm")
            break
    roi_mask = dist < roi_r_used
    roi_n = int(roi_mask.sum())

    z0_skin = meta.z_skin_top - meta.t_skin
    skin_mask = nodes[:, 2] > z0_skin + meta.t_skin * 0.80
    xp, yp = nodes[:, 0], nodes[:, 1]
    in_fp = (_in_footprint(xp, yp, meta.e1_pos[0], meta.e1_pos[1],
                           meta.elec_r, meta.elec_shape)
             | _in_footprint(xp, yp, meta.e2_pos[0], meta.e2_pos[1],
                             meta.elec_r, meta.elec_shape))
    skin_no = skin_mask & ~in_fp
    if not skin_no.any():
        skin_no = skin_mask
    faces_np = case.faces.cpu().numpy()
    bcid_np = case.face_bcid.cpu().numpy()
    act_nodes, ret_nodes = electrode_node_masks(faces_np, bcid_np,
                                                nodes.shape[0])

    dev = lambda a: torch.as_tensor(a, device=case.nodes.device)
    geom = dict(
        masks=dict(
            roi=dev(roi_mask), skin=dev(skin_mask), skin_no=dev(skin_no),
            act=dev(act_nodes), ret=dev(ret_nodes),
            face_act=dev(bcid_np == BC_ACTIVE),
            face_ret=dev(bcid_np == BC_RETURN)),
        cen=cen, roi_n=roi_n, roi_r_used=roi_r_used, roi_warn=roi_warn,
        skin_empty=not bool(skin_mask.any()),
        layer_fracs=_roi_layer_fractions(cen, roi_cen, roi_r_used,
                                         meta)[:3],
    )
    case._metric_geom_cache = (key, geom)
    return geom
