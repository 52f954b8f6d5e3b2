#!/usr/bin/env python3
"""step03 — layered ankle sweep, fat thickness x electrode radius
(PyTorch twin of pelvistim_fem_tpu/apps/run_step03.py).

    python -m pelvistim_fem_tpu_torch.apps.run_step03 [--smoke] [--batch]
        [--resume] [--params FILE.json] [--outdir DIR] [--device cuda|cpu]

Each case is one in-memory build and certified solve (runner.solve_auto,
true f64 residual <= 1e-8), then its metric row.  --batch solves each
radius group's fat thicknesses as one lane-stacked certified solve on a
shared lattice (parallel/geometry_sweep.solve_t_fat_group).  --smoke runs
one coarse case; --resume skips cases (with --batch: whole radius
groups) whose row.json exists.  Outputs: DIR/<case>/bc_debug_report.txt
and row.json, DIR/summary.csv and summary.json, and a run summary.
"""

import argparse
import json
import sys
import time
from pathlib import Path


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Ankle layered slab sweep")
    ap.add_argument("--smoke", action="store_true",
                    help="single coarse case for a quick pipeline check")
    ap.add_argument("--outdir", default="results_step03")
    ap.add_argument("--params", default=None,
                    help="parameter JSON path (default: bundled step03)")
    ap.add_argument("--resume", action="store_true",
                    help="skip cases whose per-case row.json exists")
    ap.add_argument("--batch", action="store_true",
                    help="solve each radius group's t_fat variants as one "
                         "lane-stacked batch on a shared lattice instead "
                         "of the serial per-case loop")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda)")
    return ap.parse_args(argv)


def _label(t_fat, elec_r):
    return f"tfat{int(t_fat*1e6):04d}um_r{int(elec_r*1e6):04d}um"


def _run_batch(args, p, t_fat_list, r_list_mm, coarse, device, timer,
               out_root):
    """--batch: one certified solve_t_fat_group per radius; returns
    (rows, groups) with groups [dict(r_mm, grid, nodes, iterations,
    residual, converged)]."""
    from pelvistim_fem_tpu_torch.ops.metrics import extract_results
    from pelvistim_fem_tpu_torch.parallel.geometry_sweep import \
        solve_t_fat_group
    from pelvistim_fem_tpu_torch.utils.report import save_bc_debug_report
    from pelvistim_fem_tpu_torch.utils.summary import _NanToNullEncoder

    results, groups = [], []
    for r_mm in r_list_mm:
        elec_r = r_mm * 1e-3
        labels = [_label(t_fat, elec_r) for t_fat in t_fat_list]
        rows = [out_root / lb / "row.json" for lb in labels]
        if args.resume and all(rp.exists() for rp in rows):
            # a radius group resumes only when every row is cached: one
            # lane-stacked solve is the unit of work
            print(f"\n[batch r={r_mm:.1f}mm] all {len(rows)} rows cached "
                  "-> skipping group")
            results.extend(json.loads(rp.read_text()) for rp in rows)
            continue
        print(f"\n[batch r={r_mm:.1f}mm] solving {len(t_fat_list)} t_fat "
              "variants as one batch (refined, tol 1e-8)")
        with timer.phase("batched solve"):
            out, cases, meshes = solve_t_fat_group(
                p, t_fat_list, elec_r, coarse=coarse, device=device)
        converged = bool(out.converged.all())
        print(f"    iters {out.iterations.tolist()}  converged {converged}")
        if not converged:
            raise RuntimeError(f"step03 batch r={r_mm} mm: lanes not "
                               f"certified, residuals "
                               f"{out.residual.tolist()}")
        groups.append(dict(r_mm=r_mm,
                           grid=tuple(meshes[0].lattice.grid_shape),
                           nodes=cases[0].n_nodes,
                           iterations=out.iterations.tolist(),
                           residual=out.residual.tolist(),
                           converged=converged))
        for i, label in enumerate(labels):
            run_dir = out_root / label
            save_bc_debug_report(run_dir, label, cases[i], p)
            with timer.phase("metrics"):
                row = extract_results(cases[i], out.phi[i], p)
            (run_dir / "row.json").write_text(
                json.dumps(row, cls=_NanToNullEncoder))
            results.append(row)
    return results, groups


def run(args) -> dict:
    """The sweep: dict(rows, groups (--batch), wall_s)."""
    from pelvistim_fem_tpu_torch.device import resolve_device
    from pelvistim_fem_tpu_torch.models.ankle import build_layered_case
    from pelvistim_fem_tpu_torch.ops.metrics import extract_results
    from pelvistim_fem_tpu_torch.runner import preferred_dtype, solve_auto
    from pelvistim_fem_tpu_torch.utils.config import (default_params,
                                                      get_placement,
                                                      get_stim, load_params)
    from pelvistim_fem_tpu_torch.utils.report import (print_run_summary,
                                                      save_bc_debug_report)
    from pelvistim_fem_tpu_torch.utils.summary import (_NanToNullEncoder,
                                                       save_results)
    from pelvistim_fem_tpu_torch.utils.timing import PhaseTimer

    device = resolve_device(args.device)
    p = (load_params(args.params) if args.params
         else default_params("step03_ankle_layers"))
    pl = get_placement(p)
    st = get_stim(p)
    if args.smoke:
        t_fat_list = [p["layers"]["t_fat"]]
        r_list_mm = [pl.get("electrode_r_mm_list", [5, 10, 15])[1]]
        coarse = True
        print("=== SMOKE TEST (1 coarse case) ===")
    else:
        t_fat_list = p["layers"]["t_fat_sweep"]
        r_list_mm = pl.get("electrode_r_mm_list", [5, 10, 15])
        coarse = False
        print(f"=== FULL SWEEP: {len(t_fat_list)} fat thicknesses x "
              f"{len(r_list_mm)} electrode sizes = "
              f"{len(t_fat_list)*len(r_list_mm)} cases ===")

    mode = st.get("control_mode", "voltage")
    print(f"\n{'='*60}")
    if mode == "current":
        print("  CONTROL MODE : current")
        print(f"  Injected I   : {st.get('injected_current_mA', 5.0):.1f}"
              f" mA  (Neumann BC at active electrode)")
        print(f"  Compliance   : warn if V_active > "
              f"{st.get('compliance_voltage_V', 100.0):.0f} V")
    else:
        print("  CONTROL MODE : voltage")
        print("  V_active = 1.0 V  |  V_return = 0 V  (Dirichlet BCs)")
    print(f"{'='*60}\n")

    out_root = Path(args.outdir)
    timer = PhaseTimer()
    t_start = time.perf_counter()
    groups = []
    if args.batch:
        results, groups = _run_batch(args, p, t_fat_list, r_list_mm, coarse,
                                     device, timer, out_root)
    else:
        results = []
        for t_fat in t_fat_list:
            for r_mm in r_list_mm:
                elec_r = r_mm * 1e-3
                label = _label(t_fat, elec_r)
                run_dir = out_root / label
                row_path = run_dir / "row.json"
                if args.resume and row_path.exists():
                    print(f"\n[{label}]  cached -> {row_path}")
                    results.append(json.loads(row_path.read_text()))
                    continue
                print(f"\n[{label}]  t_fat={t_fat*1000:.1f}mm  "
                      f"r={r_mm:.1f}mm")
                with timer.phase("mesh+assemble"):
                    case, _, mesh = build_layered_case(
                        p, t_fat=t_fat, elec_r=elec_r, coarse=coarse,
                        dtype=preferred_dtype(device), with_mesh=True,
                        device=device)
                print(f"    {case.n_nodes} nodes, {case.n_tets} tets, "
                      f"A_active={case.meta.elec_area_mesh*1e4:.4f} cm2")
                save_bc_debug_report(run_dir, label, case, p)
                res = solve_auto(case, mesh, tol=1e-8, timer=timer)
                with timer.phase("metrics"):
                    row = extract_results(case, res.phi, p)
                row_path.write_text(json.dumps(row, cls=_NanToNullEncoder))
                results.append(row)
                print(f"    peak_J_no_elec="
                      f"{row['peak_J_skin_no_elec']:.4f}  "
                      f"roi_mean_E={row['roi_mean_E']:.4f}  "
                      f"flux_err={row['flux_err']:.3e}")

    wall = time.perf_counter() - t_start
    save_results(results, out_root)
    print_run_summary(results, p)
    n = len(results)
    print(f"  {n} case(s) in {wall:.1f} s = {n*60/wall:.1f} solves/min   "
          "phases: " + ", ".join(f"{k}={v:.1f}s"
                                 for k, v in timer.report().items()))
    return dict(rows=results, groups=groups, wall_s=wall)


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
