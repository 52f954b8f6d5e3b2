#!/usr/bin/env python3
"""step04 — pressure-dependent contact-impedance sweep (PyTorch twin of
pelvistim_fem_tpu/apps/run_step04.py).

    python -m pelvistim_fem_tpu_torch.apps.run_step04 [--smoke]
        [--outdir DIR] [--params FILE.json] [--thermal] [--nonlinear]
        [--nl-amp A] [--nl-e0 E0] [--nl-w W] [--device cuda|cpu]

One lattice spec and one device assembly of the per-body stencils and
their multigrid hierarchy serve every contact level; the sweep is one
lane-stacked certified solve (true f64 residual <= 1e-8 per lane), then
every lane's metric row from one batched extraction on the element Case.

The solve is multigrid.batched_mg_solve_fused_refined_chunked: the
body-factored lane-stacked MG on kernel 2.  The reference app runs the
vmapped per-lane-combined batched_mg_solve_refined instead; both are
the same certified contract (f32 MG-CG inner solves on the same
hierarchy, f64 true residual <= 1e-8 per lane) reached by two schedules
of the same arithmetic, so rows agree to what 1e-8 leaves.

--thermal: per-level Joule heating (duty-cycle averaged) into one
lane-stacked f32 Pennes solve (ops/bioheat), lane 0 the no-stimulation
baseline; rows gain dT_skin_max_C and dT_max_C, and the driest level's
implicit-Euler heating course gives t95.  --nonlinear: each level
re-solved with the rebased logistic skin law sigma_skin(|E|) on the
lattice (ops/nonlinear.solve_lattice_field_dependent); rows gain
compliance_V_nl and skin_sigma_rise.

Outputs: DIR/summary.csv and summary.json, the sanity table, the trend
lines, and the walls of the phases build, solve, extract, thermal and
nonlinear.
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Pressure sweep")
    ap.add_argument("--smoke", action="store_true",
                    help="coarse mesh for a quick pipeline check")
    ap.add_argument("--outdir", default="results_step04")
    ap.add_argument("--params", default=None,
                    help="parameter JSON path (default: bundled step04)")
    ap.add_argument("--thermal", action="store_true",
                    help="Pennes bioheat per case: Joule heating -> "
                         "skin temperature rise (duty-cycle scaled)")
    ap.add_argument("--nonlinear", action="store_true",
                    help="dynamic skin conductance: re-solve each case "
                         "with sigma_skin(|E|) (ops/nonlinear.py) and "
                         "report the compliance shift vs linear")
    ap.add_argument("--nl-amp", type=float, default=4.0,
                    help="saturating relative skin-conductance rise")
    ap.add_argument("--nl-e0", type=float, default=2000.0,
                    help="field threshold [V/m] of the skin law")
    ap.add_argument("--nl-w", type=float, default=500.0,
                    help="transition width [V/m] of the skin law")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda)")
    return ap.parse_args(argv)


def step04_thermal_tables(n_bodies):
    """(k_table, perf_table) of the step04 tissues: the literature
    defaults per layer, unperfused contacts."""
    from pelvistim_fem_tpu_torch.mesh import core as c
    from pelvistim_fem_tpu_torch.ops.bioheat import (DEFAULT_K,
                                                     DEFAULT_PERFUSION,
                                                     thermal_tables)
    return thermal_tables(
        n_bodies,
        {c.BODY_MUSCLE: DEFAULT_K["muscle"], c.BODY_FAT: DEFAULT_K["fat"],
         c.BODY_SKIN: DEFAULT_K["skin"],
         c.BODY_CONTACT_ACTIVE: DEFAULT_K["contact"],
         c.BODY_CONTACT_RETURN: DEFAULT_K["contact"]},
        {c.BODY_MUSCLE: DEFAULT_PERFUSION["muscle"],
         c.BODY_FAT: DEFAULT_PERFUSION["fat"],
         c.BODY_SKIN: DEFAULT_PERFUSION["skin"],
         c.BODY_CONTACT_ACTIVE: 0.0, c.BODY_CONTACT_RETURN: 0.0})


def skin_law(sigma_table, *, amp, e0, w):
    """The rebased logistic sigma(|E|) law on the skin body only (every
    other body linear), in f64 on sigma_table's device."""
    import torch
    from pelvistim_fem_tpu_torch.mesh import core as c
    from pelvistim_fem_tpu_torch.ops.nonlinear import FieldLaw
    s0 = sigma_table.to(torch.float64)
    amp_t, e0_t, w_t = (torch.zeros_like(s0), torch.ones_like(s0),
                        torch.ones_like(s0))
    amp_t[c.BODY_SKIN], e0_t[c.BODY_SKIN], w_t[c.BODY_SKIN] = amp, e0, w
    return FieldLaw(sigma0=s0, amp=amp_t, e0=e0_t, w=w_t)


def _thermal(case, p, out_phi, tables, results, timer):
    """Pennes chain: dT columns of `results`; returns (t95 [min], steady
    skin rise of the driest level [degC], thermal solve)."""
    import torch
    from pelvistim_fem_tpu_torch.mesh import core as mcore
    from pelvistim_fem_tpu_torch.ops.bioheat import (
        build_bioheat_case, skin_temperature_metrics, solve_bioheat,
        solve_bioheat_transient)
    from pelvistim_fem_tpu_torch.ops.fields import cell_power_density

    duty = (p["stim"].get("pulse_width_us", 200.0) * 1e-6
            * p["stim"].get("frequency_Hz", 10.0))
    kt, pt = step04_thermal_tables(case.meta.n_bodies)
    with timer.phase("thermal"):
        bh = build_bioheat_case(case, kt, pt)
        tets = case.tets.cpu().numpy()
        skin_tets = tets[case.tet_body.cpu().numpy() == mcore.BODY_SKIN]
        q = cell_power_density(case, out_phi.to(torch.float32),
                               tables.to(torch.float32)) * duty
        # f32 solves at 3e-6: delta-T good to ~1e-4 degC.  Lane 0 = no
        # heating, the no-stimulation baseline (skin below core through
        # air convection); the safety number is the rise above it.
        q = torch.cat([torch.zeros_like(q[:1]), q])
        sol = solve_bioheat(case, bh, q, tol=3e-6)
        Ts = sol.phi.cpu().numpy()
        for i, row in enumerate(results):
            m = skin_temperature_metrics(case, Ts[i + 1],
                                         skin_body=mcore.BODY_SKIN,
                                         T_ref=Ts[0], skin_tets=skin_tets)
            row["dT_skin_max_C"] = m["dT_skin_max"]
            row["dT_max_C"] = m["dT_max"]
    print(f"  thermal (duty {100*duty:.2f}%): {len(results)} Pennes solves "
          f"in {timer.phases['thermal']:.2f} s; dT_skin_max "
          f"{results[0]['dT_skin_max_C']:.4f} -> "
          f"{results[-1]['dT_skin_max_C']:.4f} degC (guideline ~1 degC)")
    # heating course of the WORST (dry) level: the bioheat time constant
    # rho_c / (w c) is ~20 min, so a session may end before the steady
    # rise
    dt_s = 60.0
    t95 = None
    with timer.phase("thermal"):
        skin_nodes = np.unique(skin_tets)
        T_base = sol.phi[0]
        _, trace = solve_bioheat_transient(
            case, bh, q[1], T_base, dt_s=dt_s, n_steps=45, tol=1e-7,
            trace_nodes=torch.as_tensor(skin_nodes, device=T_base.device),
            trace_ref=T_base)
        trace = trace.cpu().numpy()     # pointwise skin rise per step
        rise = float((Ts[1] - Ts[0])[skin_nodes].max())
    if rise > 1e-9:
        hit = np.nonzero(trace >= 0.95 * rise)[0]
        t95 = (hit[0] + 1) * dt_s / 60.0 if hit.size else np.inf
        print(f"  heating time course (dry case): t95 = {t95:.0f} min to "
              f"95% of the steady {rise:.4f} degC skin rise")
    return t95, rise, sol


def _nonlinear(args, spec, case, tables, results, timer, device):
    """sigma_skin(|E|) re-solve of every level: compliance_V_nl and
    skin_sigma_rise columns; returns the NonlinearResults."""
    import torch
    from pelvistim_fem_tpu_torch.mesh import core as mcore
    from pelvistim_fem_tpu_torch.ops import nonlinear as nl
    from pelvistim_fem_tpu_torch.ops.lattice_assembly import \
        spec_device_arrays
    from pelvistim_fem_tpu_torch.ops.metrics import compliance_voltage

    f64 = torch.float64
    skin6 = np.asarray(spec.body6) == mcore.BODY_SKIN
    tabs64 = tables.to(f64).cpu().numpy()
    out = []
    with timer.phase("nonlinear"):
        dev64 = spec_device_arrays(spec, f64, device)
        for i, row in enumerate(results):
            law = skin_law(tables[i], amp=args.nl_amp, e0=args.nl_e0,
                           w=args.nl_w)
            r = nl.solve_lattice_field_dependent(spec, law, tol=1e-8,
                                                 device_arrays=dev64)
            # the electrode node patches are integer face data: the f32
            # Case gives the same compliance voltage as an f64 one
            row["compliance_V_nl"] = compliance_voltage(case, r.phi)
            s_skin = r.sigma_e.cpu().numpy()[skin6]
            row["skin_sigma_rise"] = float(
                s_skin.mean() / tabs64[i][mcore.BODY_SKIN])
            if not bool(r.converged):
                print(f"  WARNING: nonlinear lane {i} unconverged "
                      f"(residual {float(r.residual):.2e}, sigma change "
                      f"{float(r.sigma_change):.2e})")
            out.append(r)
    print(f"  nonlinear skin (amp {args.nl_amp:g}, e0 {args.nl_e0:g} V/m): "
          f"{len(results)} certified fixed-point solves in "
          f"{timer.phases['nonlinear']:.1f} s")
    print(f"  compliance_V nl/linear: "
          f"{results[0]['compliance_V_nl']:.1f}/"
          f"{results[0]['compliance_V']:.1f} -> "
          f"{results[-1]['compliance_V_nl']:.1f}/"
          f"{results[-1]['compliance_V']:.1f} V; skin sigma rise "
          f"x{results[0]['skin_sigma_rise']:.2f} -> "
          f"x{results[-1]['skin_sigma_rise']:.2f}")
    return out


def run(args) -> dict:
    """The sweep and its chains: dict(rows, solve (SolveResult of the
    linear sweep), nonlinear ([NonlinearResult] or None), t95, rise,
    thermal (SolveResult or None), phases {name: s}, wall_s)."""
    import torch
    from pelvistim_fem_tpu_torch.device import resolve_device
    from pelvistim_fem_tpu_torch.models.pressure import (
        SWEEP_LANES_PER_CHUNK, build_pressure_case, build_pressure_spec,
        sigma_tables_for_sweep)
    from pelvistim_fem_tpu_torch.ops.lattice_assembly import assemble_lattice
    from pelvistim_fem_tpu_torch.ops.metrics import extract_results_batched
    from pelvistim_fem_tpu_torch.ops.multigrid import \
        batched_mg_solve_fused_refined_chunked
    from pelvistim_fem_tpu_torch.utils.config import (default_params,
                                                      load_params)
    from pelvistim_fem_tpu_torch.utils.report import print_sanity_table
    from pelvistim_fem_tpu_torch.utils.summary import save_results
    from pelvistim_fem_tpu_torch.utils.timing import PhaseTimer

    device = resolve_device(args.device)
    p = (load_params(args.params) if args.params
         else default_params("step04_pressure"))
    sweep = p["pressure_sweep"]["sigma_contact_Spm"]
    labels = p["pressure_sweep"]["labels"]
    print(f"=== PRESSURE SWEEP: {len(sweep)} sigma_contact levels "
          f"({sweep[0]:g} .. {sweep[-1]:g} S/m) ===")
    timer = PhaseTimer()
    t_start = time.perf_counter()

    # the compact spec on the host; the per-body f64 stencils and their
    # hierarchy assembled on the device once for every level.  The
    # element Case carries the metrics (flux integrals, ROI are tet-based)
    with timer.phase("build"):
        spec, _ = build_pressure_spec(p, coarse=args.smoke)
        scase, hier = assemble_lattice(spec, torch.float64, device=device)
        tables = sigma_tables_for_sweep(scase, p)
        case, _ = build_pressure_case(p, coarse=args.smoke,
                                      dtype=torch.float32, device=device)
    print(f"  spec+assemble (ONCE, reused for all {len(sweep)} cases): "
          f"{case.n_nodes} nodes, {case.n_tets} tets, "
          f"{timer.phases['build']:.1f} s")

    with timer.phase("solve"):
        out = batched_mg_solve_fused_refined_chunked(
            scase, hier, tables, tol=1e-8,
            lanes_per_chunk=SWEEP_LANES_PER_CHUNK)
        conv = out.converged.cpu().numpy()
    t_solve = timer.phases["solve"]
    print(f"  batched MG solve: {len(sweep)} cases in {t_solve:.2f} s = "
          f"{len(sweep)*60/t_solve:.1f} solves/min at CERTIFIED tol 1e-8 "
          f"(max true residual {float(out.residual.max()):.2e}, "
          f"iters {out.iterations.tolist()})")
    if not conv.all():
        print(f"  WARNING: lanes not converged: {np.where(~conv)[0]}")

    # every lane's metrics in one device pass, in f32: the refined phi is
    # certified to 1e-8, so its f32 cast is exact to ~1e-7
    with timer.phase("extract"):
        results = extract_results_batched(
            case, out.phi.to(torch.float32), p,
            sigma_tables=tables.to(torch.float32),
            pressure_labels=list(labels), sigma_contacts=list(sweep))
    t_extract = timer.phases["extract"]
    print(f"  batched extract: {len(sweep)} cases in {t_extract:.2f} s "
          f"(end-to-end {len(sweep)*60/(t_solve+t_extract):.1f} "
          f"cases/min)")
    for lab, s, row in zip(labels, sweep, results):
        print(f"[{lab}] sigma_contact = {s:g} S/m  "
              f"compliance_V={row['compliance_V']:.1f} V  "
              f"Z={row['contact_impedance_ohm']:.0f} ohm  "
              f"roi_E={row['roi_mean_E']:.2f} V/m  "
              f"Q={row['charge_density_mC_cm2']:.6f} mC/cm2")

    t95 = rise = thermal = nonlinear = None
    if args.thermal:
        t95, rise, thermal = _thermal(case, p, out.phi, tables, results,
                                      timer)
    if args.nonlinear:
        nonlinear = _nonlinear(args, spec, case, tables, results, timer,
                               device)

    save_results(results, Path(args.outdir))
    print_sanity_table(results, p)
    # end-of-run trend summary
    print(f"  compliance_V : {results[0]['compliance_V']:.1f} -> "
          f"{results[-1]['compliance_V']:.1f} V")
    print(f"  impedance    : {results[0]['contact_impedance_ohm']:.0f} -> "
          f"{results[-1]['contact_impedance_ohm']:.0f} ohm")
    print(f"  roi_mean_E   : {results[0]['roi_mean_E']:.2f} -> "
          f"{results[-1]['roi_mean_E']:.2f} V/m")
    wall = time.perf_counter() - t_start
    phases = timer.report()
    print(f"  wall {wall:.1f} s; phases: "
          + ", ".join(f"{k}={v:.2f}s" for k, v in phases.items()))
    return dict(rows=results, solve=out, nonlinear=nonlinear, t95=t95,
                rise=rise, thermal=thermal, phases=phases, wall_s=wall)


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
