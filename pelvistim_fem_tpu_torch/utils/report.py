"""Human-facing reports of the apps: the per-case BC debug report, the
end-of-run summary (step03) and the sanity table (step04); stdlib twin
of pelvistim_fem_tpu/utils/report.py, the same text, line for line.
"""

from __future__ import annotations

import math
from pathlib import Path

from pelvistim_fem_tpu_torch.mesh.core import BC_ACTIVE, BC_RETURN
from pelvistim_fem_tpu_torch.utils.config import get_stim


def save_bc_debug_report(run_dir, label, case, params):
    """Per-case text report of the BC setup (the applied Jn, the electrode
    areas and the z-geometry) in run_dir/bc_debug_report.txt."""
    meta = case.meta
    mode = meta.mode
    I_A = meta.I_target_A
    I_mA = I_A * 1e3

    lines = [
        f"BC DEBUG REPORT — {label}",
        "=" * 60,
        f"  control_mode     : {mode}",
        f"  injected_current : {I_mA} mA  ({I_A:.4e} A)",
        "",
        f"  boundary ID — active  : {BC_ACTIVE}",
        f"  boundary ID — return  : {BC_RETURN}",
        "",
        f"  Mesh area — active electrode : {meta.elec_area_mesh*1e4:.4f} cm2",
        f"  Mesh area — return electrode : "
        f"{meta.return_area_mesh*1e4:.4f} cm2",
    ]
    if mode == "current" and meta.jn_used:
        expected = meta.jn_used * meta.elec_area_mesh
        lines += [
            "",
            f"  Current density applied (Jn) : {meta.jn_used:.6e} A/m2",
            f"  Expected current (Jn * A)    : {expected*1e3:.4f} mA",
            f"  Target current               : {I_mA:.4f} mA",
            f"  Pre-solve area error         : "
            f"{abs(expected - I_A)/I_A*100:.2f}%",
            "",
            "  Neumann BC: uniform normal current density on the active",
            "  electrode faces; load b_i = Jn*A_f/3 per face node, so the",
            "  discrete injected current equals the target EXACTLY (the",
            "  reference's .sif 'Current Density' keyword relied on Elmer's",
            "  face integration of the same quantity).",
            "  Return electrode is Dirichlet: Potential = 0.",
        ]
    lines += [
        "",
        f"  contact_enabled  : {meta.contact_enabled}",
        f"  z_skin_top (nom) : {meta.z_skin_top*1000:.2f} mm",
        f"  z_e1_elec_top    : {meta.z_e1_elec_top*1000:.2f} mm",
        f"  z_e2_elec_top    : {meta.z_e2_elec_top*1000:.2f} mm",
    ]
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    out = run_dir / "bc_debug_report.txt"
    out.write_text("\n".join(lines) + "\n")
    print(f"    BC debug -> {out}")


def print_run_summary(results, params):
    """End-of-run summary: the output files and the middle case's
    currents, flux error, compliance, skin peak and ROI field."""
    st = get_stim(params)
    mode = st.get("control_mode", "voltage")
    nan = float("nan")
    print(f"\n{'='*60}")
    print("  RUN COMPLETE — OUTPUTS")
    print(f"{'='*60}")
    print("  results/summary.csv")
    print("  results/summary.json")
    print(f"  {len(results)} case(s) computed")
    if results:
        ex = results[len(results) // 2]
        print(f"\n  Example case  "
              f"(fat={ex.get('t_fat_mm', nan):.1f} mm, "
              f"r={ex.get('elec_r_mm', nan):.1f} mm):")
        print(f"    control_mode       : {ex.get('control_mode', '?')}")
        if mode == "current" and ex.get("jn_used") is not None:
            print(f"    jn_used            : {ex['jn_used']:.4f} A/m2")
        print(f"    I_active           : "
              f"{ex.get('total_current_A', nan):.4e} A")
        print(f"    I_return           : {ex.get('I_return_A', nan):.4e} A")
        print(f"    flux_err           : {ex.get('flux_err', nan):.3e}")
        if mode == "current":
            cv = ex.get("compliance_V", nan)
            tag = "  [EXCEEDED]" if ex.get("exceeded_compliance") else ""
            print(f"    compliance_V       : {cv:.2f} V{tag}")
        print(f"    peak_J_no_elec     : "
              f"{ex.get('peak_J_skin_no_elec', nan):.4f} A/m2")
        print(f"    roi_mean_E         : {ex.get('roi_mean_E', nan):.4f} V/m")
        print(f"    efficiency         : {ex.get('efficiency', nan):.4e} m")
    print(f"{'='*60}\n")


def print_sanity_table(results, params):
    """Per-case console table: currents, flux error, deviation from the
    target current, compliance voltage, ROI layer fractions."""
    st = get_stim(params)
    mode = st.get("control_mode", "voltage")
    I_target = st.get("injected_current_mA", 5.0) * 1e-3
    nan = float("nan")
    print(f"\n{'='*100}")
    print("  SANITY TABLE")
    print(f"{'='*100}")
    hdr = (f"  {'case':<22}{'I_act[mA]':>10}{'I_ret[mA]':>10}"
           f"{'flux_err%':>10}{'dev%':>8}{'compl[V]':>10}"
           f"{'ROI musc/fat/skin':>20}")
    print(hdr)
    print("  " + "-" * 96)
    for r in results:
        label = (r.get("pressure_label")
                 or f"tfat{r.get('t_fat_mm', 0):.0f}mm_r"
                 f"{r.get('elec_r_mm', 0):.0f}mm")
        ia = r.get("total_current_A", r.get("I_active_A", nan))
        ir = r.get("I_return_A", nan)
        fe = r.get("flux_err", nan)
        dev = (abs(ia - I_target) / I_target * 100
               if (mode == "current" and isinstance(ia, float)
                   and math.isfinite(ia)) else nan)
        cv = r.get("compliance_V", nan)
        fr = (f"{r.get('roi_frac_muscle', nan):.2f}/"
              f"{r.get('roi_frac_fat', nan):.2f}/"
              f"{r.get('roi_frac_skin', nan):.2f}")
        print(f"  {label:<22}{ia*1e3:>10.3f}{ir*1e3:>10.3f}"
              f"{fe*100:>10.2f}{dev:>8.2f}{cv:>10.2f}{fr:>20}")
    print(f"{'='*100}\n")
