#!/usr/bin/env python3
"""step03 — layered ankle sweep, fat thickness x electrode radius
(PyTorch twin of pelvistim_fem_tpu/apps/run_step03.py).

    python -m pelvistim_fem_tpu_torch.apps.run_step03 [--smoke] [--batch]
        [--resume] [--save-vtu] [--export-elmer] [--params FILE.json]
        [--outdir DIR] [--device cuda|cpu]
    python -m pelvistim_fem_tpu_torch.apps.run_step03 --adapt N [--smoke]
    python -m pelvistim_fem_tpu_torch.apps.run_step03 --adapt-local N
        [--theta 0.5] [--smoke]

Each case is one in-memory build and certified solve (runner.solve_auto,
true f64 residual <= 1e-8), then its metric row.  --batch solves each
radius group's fat thicknesses as one lane-stacked certified solve on a
shared lattice (parallel/geometry_sweep.solve_t_fat_group).  --smoke runs
one coarse case; --resume skips cases (with --batch: whole radius
groups) whose row.json exists.  Outputs: DIR/<case>/bc_debug_report.txt
and row.json, DIR/summary.csv and summary.json, and a run summary;
--save-vtu adds DIR/<case>/results/case_t0001.vtu, --export-elmer an
Elmer case (elmer_mesh/, case.sif, results/) per case.

--adapt N and --adapt-local N run N cycles of ZZ-driven mesh adaptation
on the anchor case instead of the sweep (exit 1 if the estimate grows by
more than 10%): --adapt regrades every lattice axis at the same cell
count (the stencil path), --adapt-local bisects the Doerfler-marked tets
(theta) and solves on the AMG element path.
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
    ap.add_argument("--save-vtu", action="store_true",
                    help="write a solution VTU per case")
    ap.add_argument("--export-elmer", action="store_true",
                    help="also write elmer_mesh/ + case.sif per case for "
                         "cross-validation with ElmerSolver")
    ap.add_argument("--adapt", type=int, default=0, metavar="N",
                    help="N ZZ estimate -> regrade cycles on the anchor "
                         "case at equal cell count instead of the sweep")
    ap.add_argument("--adapt-local", type=int, default=0, metavar="N",
                    help="N cycles of ZZ-driven local bisection refinement "
                         "on the anchor case (conforming Maubach closure, "
                         "certified AMG solves)")
    ap.add_argument("--theta", type=float, default=0.5,
                    help="Doerfler marking fraction for --adapt-local")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda)")
    return ap.parse_args(argv)


def _anchor_inputs(args):
    """The anchor case's recipe inputs: ((Lx, Ly, Lz), recipe kwargs,
    sigma_by_body, bc_kwargs, meta_extra, params)."""
    from pelvistim_fem_tpu_torch.models.ankle import layered_model_inputs
    from pelvistim_fem_tpu_torch.utils.config import (default_params,
                                                      load_params)
    p = (load_params(args.params) if args.params
         else default_params("step03_ankle_layers"))
    return layered_model_inputs(p, coarse=args.smoke)


def run_adapt(args) -> dict:
    """ZZ-driven lattice adaptation on the step03 anchor case: solve ->
    per-element ZZ indicators (per-body recovery) -> equidistribute every
    lattice axis at the SAME cell count (layer-interface z-knots locked)
    -> solve again.  Reports the estimated relative energy error and
    flux_err per cycle; exit 1 if adaptation makes the estimate more than
    10% worse.  Returns dict(cycles, exit)."""
    from pelvistim_fem_tpu_torch.device import resolve_device
    from pelvistim_fem_tpu_torch.mesh.generate import layered_slab_recipe
    from pelvistim_fem_tpu_torch.models.case import build_case
    from pelvistim_fem_tpu_torch.ops.estimate import (adapt_recipe,
                                                      zz_error_indicators,
                                                      zz_global_error)
    from pelvistim_fem_tpu_torch.ops.metrics import extract_results
    from pelvistim_fem_tpu_torch.runner import solve_auto

    device = resolve_device(args.device)
    (Lx, Ly, Lz), rk, sigma_by_body, bc_kwargs, meta_extra, p = \
        _anchor_inputs(args)
    recipe = layered_slab_recipe(Lx, Ly, Lz, **rk)
    # locked z-knots: every layer interface (+ the contact top); bodies
    # classify by centroid, so these must stay grid planes
    keep_z = [0.0]
    for _b, t, _h in rk["layers"]:
        keep_z.append(keep_z[-1] + t)
    if rk.get("contact_t", 0.0) > 0:
        keep_z.append(Lz + rk["contact_t"])

    cycles = []
    for cycle in range(args.adapt + 1):
        t0 = time.perf_counter()
        mesh = recipe.mesh()
        case = build_case(mesh, sigma_by_body, meta_extra=meta_extra,
                          device=device, **bc_kwargs)
        res = solve_auto(case, mesh, tol=1e-8)
        if not bool(res.converged):
            raise RuntimeError(f"adapt cycle {cycle}: solve not certified, "
                               f"residual {float(res.residual):.3e}")
        eta = zz_error_indicators(case, res.phi)
        eta_g, rel = (float(v) for v in zz_global_error(case, res.phi))
        row = extract_results(case, res.phi, p, verbose=False)
        wall = time.perf_counter() - t0
        cycles.append(dict(
            tets=mesh.n_tets, grid=tuple(mesh.lattice.grid_shape),
            knots=tuple(list(map(float, k))
                        for k in (recipe.xs, recipe.ys, recipe.zs)),
            eta=eta_g, rel=rel, flux_err=float(row["flux_err"]),
            iterations=int(res.iterations),
            residual=float(res.residual), wall_s=wall))
        print(f"cycle {cycle}: {mesh.n_tets:,} tets "
              f"({len(recipe.xs)}x{len(recipe.ys)}x{len(recipe.zs)} "
              f"knots)  est rel energy err {rel:.3%}  "
              f"flux_err {row['flux_err']:.2%}  ({wall:.1f} s)")
        if cycle < args.adapt:
            recipe = adapt_recipe(recipe, case, mesh, eta, keep_z=keep_z)

    rel_hist = [c["rel"] for c in cycles]
    best = min(rel_hist[1:], default=rel_hist[0])
    if best > 1.10 * rel_hist[0]:
        print(f"FAIL: adaptation degraded the estimate "
              f"({rel_hist[0]:.3%} -> {best:.3%})")
        return dict(cycles=cycles, exit=1)
    verdict = ("improved" if best < 0.98 * rel_hist[0]
               else "certified near-optimal")
    print(f"PASS: hand grading {verdict} "
          f"({rel_hist[0]:.3%} -> {best:.3%} at equal cell count)")
    return dict(cycles=cycles, exit=0)


def run_adapt_local(args) -> dict:
    """Local (bisection) adaptation on the step03 anchor case: each cycle
    bisects the tets the ZZ indicators mark (Doerfler bulk chasing and a
    conforming Maubach closure, mesh/refine), solves on the certified AMG
    path (the refined mesh has no lattice), classifies the electrode
    faces again on the finer boundary, and reports the estimate, flux_err,
    peak_J_skin_no_elec and per-phase times.  Exit 1 if the estimate grows
    by more than 10% from one cycle to the next.  Returns dict(cycles,
    exit); each cycle carries its case, phi and Doerfler marks (but the
    last) for checks."""
    from pelvistim_fem_tpu_torch.device import resolve_device
    from pelvistim_fem_tpu_torch.mesh.generate import layered_slab_recipe
    from pelvistim_fem_tpu_torch.mesh.refine import (BisectionMesh,
                                                     mark_doerfler)
    from pelvistim_fem_tpu_torch.models.case import build_case
    from pelvistim_fem_tpu_torch.ops.estimate import (zz_error_indicators,
                                                      zz_global_error)
    from pelvistim_fem_tpu_torch.ops.metrics import extract_results
    from pelvistim_fem_tpu_torch.runner import solve_auto
    from pelvistim_fem_tpu_torch.utils.timing import PhaseTimer

    device = resolve_device(args.device)
    (Lx, Ly, Lz), rk, sigma_by_body, bc_kwargs, meta_extra, p = \
        _anchor_inputs(args)
    bm = BisectionMesh.from_recipe(layered_slab_recipe(Lx, Ly, Lz, **rk))

    rel_prev = None
    failed = False
    cycles = []
    for cycle in range(args.adapt_local + 1):
        timer = PhaseTimer()
        t0 = time.perf_counter()
        with timer.phase("mesh"):
            mesh = bm.mesh()
        with timer.phase("case"):
            case = build_case(mesh, sigma_by_body, meta_extra=meta_extra,
                              device=device, **bc_kwargs)
        res = solve_auto(case, mesh, tol=1e-8, timer=timer)
        if not bool(res.converged):
            raise RuntimeError(f"adapt-local cycle {cycle}: solve not "
                               f"certified, residual "
                               f"{float(res.residual):.3e}")
        with timer.phase("zz"):
            eta = zz_error_indicators(case, res.phi).cpu().numpy()
            eta_g, rel = (float(v) for v in zz_global_error(case, res.phi))
        with timer.phase("extract"):
            row = extract_results(case, res.phi, p, verbose=False)
        wall = time.perf_counter() - t0
        ph = timer.report()
        cycles.append(dict(
            tets=mesh.n_tets, nodes=mesh.n_nodes, eta=eta_g, rel=rel,
            flux_err=float(row["flux_err"]),
            peak_J_skin_no_elec=float(row["peak_J_skin_no_elec"]),
            iterations=int(res.iterations), residual=float(res.residual),
            amg_sizes=res.amg.sizes, amg_build_s=res.amg.build_s,
            phases=ph, wall_s=wall, case=case, phi=res.phi))
        print(f"cycle {cycle}: {mesh.n_tets:,} tets  "
              f"est rel energy err {rel:.3%}  "
              f"flux_err {row['flux_err']:.2%}  "
              f"peak_J_no_elec {row['peak_J_skin_no_elec']:.1f} A/m^2  "
              f"({wall:.1f} s: mesh {ph['mesh']:.1f}, case "
              f"{ph['case']:.1f}, solve+amg {ph['solve']:.1f} (amg build "
              f"{ph['amg build']:.1f}), zz {ph['zz']:.1f}, extract "
              f"{ph['extract']:.1f})", flush=True)
        if rel_prev is not None and rel > 1.10 * rel_prev:
            print(f"  FAIL: estimate grew >10% ({rel_prev:.3%} -> "
                  f"{rel:.3%})")
            failed = True
        rel_prev = rel
        if cycle < args.adapt_local:
            cycles[-1]["marked"] = mark_doerfler(eta, theta=args.theta)
            bm = bm.refine(cycles[-1]["marked"])
    return dict(cycles=cycles, exit=1 if failed else 0)


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
    from pelvistim_fem_tpu_torch.utils.sif import export_elmer_case
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
            if args.export_elmer:
                export_elmer_case(cases[i], meshes[i], run_dir)
            with timer.phase("metrics"):
                row = extract_results(cases[i], out.phi[i], p)
            if args.save_vtu:
                _save_vtu(run_dir, meshes[i], cases[i], out.phi[i])
            (run_dir / "row.json").write_text(
                json.dumps(row, cls=_NanToNullEncoder))
            results.append(row)
    return results, groups


def _save_vtu(run_dir, mesh, case, phi):
    """--save-vtu: the case's solution VTU."""
    from pelvistim_fem_tpu_torch.utils.vtu import write_solution_vtu
    (run_dir / "results").mkdir(parents=True, exist_ok=True)
    write_solution_vtu(run_dir / "results" / "case_t0001.vtu", mesh, case,
                       phi)


def run(args) -> dict:
    """The sweep: dict(rows, groups (--batch), wall_s); with --adapt or
    --adapt-local the adaptation's dict(cycles, exit) instead."""
    if args.adapt_local:
        return run_adapt_local(args)
    if args.adapt:
        return run_adapt(args)
    from pelvistim_fem_tpu_torch.device import resolve_device
    from pelvistim_fem_tpu_torch.models.ankle import build_layered_case
    from pelvistim_fem_tpu_torch.ops.metrics import extract_results
    from pelvistim_fem_tpu_torch.runner import preferred_dtype, solve_auto
    from pelvistim_fem_tpu_torch.utils.config import (default_params,
                                                      get_placement,
                                                      get_stim, load_params)
    from pelvistim_fem_tpu_torch.utils.report import (print_run_summary,
                                                      save_bc_debug_report)
    from pelvistim_fem_tpu_torch.utils.sif import export_elmer_case
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
                if args.export_elmer:
                    export_elmer_case(case, mesh, run_dir)
                res = solve_auto(case, mesh, tol=1e-8, timer=timer)
                with timer.phase("metrics"):
                    row = extract_results(case, res.phi, p)
                if args.save_vtu:
                    _save_vtu(run_dir, mesh, case, res.phi)
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
    return run(parse_args(argv)).get("exit", 0)


if __name__ == "__main__":
    sys.exit(main())
