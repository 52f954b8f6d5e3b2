#!/usr/bin/env python3
"""Electrode-array stimulation design: lead fields and pattern
optimization (PyTorch twin of pelvistim_fem_tpu/apps/run_array_opt.py).

    python -m pelvistim_fem_tpu_torch.apps.run_array_opt [--full] [--k K]
        [--budget-mA B] [--imax-mA M] [--jlimit JLIM] [--steps N]
        [--robust S] [--pareto P] [--seed SEED] [--outdir DIR]
        [--device cuda|cpu]

Builds a K-disc electrode ring on the layered tissue slab
(models/array.py), solves all K lead-field basis problems as ONE
certified (true f64 residual <= 1e-8) lane-stacked MG solve with a load
per lane (ops/leadfield.py), and designs the injected current pattern
that maximizes directional E in a mid-muscle ROI subject to a
total-current budget, per-channel caps and a skin current-density
safety limit.  --pareto P sweeps the safety limit over P values (no new
solves); --robust S also designs against S log-normal conductivity
samples (S*K certified solves in one lane-stacked call).

The reference app's --plot is not here: the plots module is not ported,
and the card's machine has no matplotlib.

Outputs: DIR/summary.json (the reference app's keys); the exit code is 0
only if the design's checks pass (budget, cap and skin limit met, the
pattern at least the best single channel, and with --pareto / --robust
their checks).
"""

import argparse
import json
import os
import sys
import time

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="Electrode-array lead fields and pattern design "
                    "(the reference app's --plot is not ported)")
    ap.add_argument("--full", action="store_true",
                    help="fine resolution (default: coarse)")
    ap.add_argument("--k", type=int, default=8,
                    help="number of ring electrodes")
    ap.add_argument("--budget-mA", type=float, default=4.0,
                    help="total delivered current budget (sum |i_k|)")
    ap.add_argument("--imax-mA", type=float, default=2.0,
                    help="per-channel current cap")
    ap.add_argument("--jlimit", type=float, default=0.0,
                    help="skin |J| safety limit in A/m^2 "
                         "(0 = 60%% of the best single-channel peak "
                         "at its feasible amplitude, binding)")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--robust", type=int, default=0, metavar="S",
                    help="ALSO design against S log-normal conductivity "
                         "samples (worst-case objective, sample-wise "
                         "skin safety): S*K certified solves in one "
                         "lane-stacked batch")
    ap.add_argument("--pareto", type=int, default=0, metavar="P",
                    help="dose-vs-safety Pareto sweep over P skin-|J| "
                         "limits (no new FEM solves)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--outdir", default="results_array_opt")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda)")
    return ap.parse_args(argv)


def run(args) -> dict:
    """The design run; returns {"summary": summary.json's dict, "ok",
    the basis and ensemble SolveResults, and the case, hierarchy, loads
    and sample tables they were solved on}."""
    import torch
    from pelvistim_fem_tpu_torch.device import resolve_device
    from pelvistim_fem_tpu_torch.mesh import core
    from pelvistim_fem_tpu_torch.models.array import (array_recipe,
                                                      build_array_specs,
                                                      default_array_params)
    from pelvistim_fem_tpu_torch.models.case import build_case
    from pelvistim_fem_tpu_torch.ops.lattice_assembly import assemble_lattice
    from pelvistim_fem_tpu_torch.ops.leadfield import (lead_vectors,
                                                       optimize_pattern,
                                                       solve_basis_refined)

    device = resolve_device(args.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    params = default_array_params(coarse=not args.full)
    params["n_electrodes"] = args.k
    t0 = time.perf_counter()
    specs, params, meta = build_array_specs(params)
    t_specs = time.perf_counter() - t0
    K = len(specs)
    gx, gy, gz = specs[0].grid_shape
    print(f"  {K}-electrode array, grid {gx}x{gy}x{gz} "
          f"({int(np.sum(specs[0].body6 > 0))} tets), "
          f"specs built in {t_specs:.2f} s")

    # one shared operator + hierarchy; K loads
    scase, hier = assemble_lattice(specs[0], torch.float64, device=device)
    loads = torch.as_tensor(np.stack([s.b_neumann for s in specs]),
                            device=device)

    out = solve_basis_refined(scase, hier, loads, tol=1e-8)  # warm-up
    sync()
    t0 = time.perf_counter()
    out = solve_basis_refined(scase, hier, loads, tol=1e-8)
    sync()
    t_basis = time.perf_counter() - t0
    if not bool(out.converged.all()):
        raise AssertionError("basis solves not certified: residuals "
                             f"{out.residual.tolist()}")
    res = float(out.residual.max())
    print(f"  {K} certified basis solves in {t_basis:.2f} s "
          f"(max true residual {res:.2e}, "
          f"iters {out.iterations.tolist()})")

    # element mesh (the same lattice) for the field and lead extraction,
    # in f32: the certified f64 phi casts exactly to ~1e-7, far below the
    # metrics' tolerances
    sigma_by_body = {
        core.BODY_MUSCLE: params["sigma_Spm"]["muscle"],
        core.BODY_FAT: params["sigma_Spm"]["fat"],
        core.BODY_SKIN: params["sigma_Spm"]["skin"],
    }
    case = build_case(array_recipe(params, 0).mesh(), sigma_by_body,
                      mode="current", dtype=torch.float32,
                      injected_current_A=params["I_unit_A"], device=device)
    lead = dict(roi_center=meta["roi_center"], roi_r=meta["roi_r"],
                target_dir=meta["target_dir"])
    w, J_skin, vol_roi = lead_vectors(case, out.phi.to(torch.float32),
                                      **lead)
    w_np = w.cpu().numpy()
    J_np = J_skin.cpu().numpy()

    # constraint scales (units of I_unit_A = 1 mA per unit)
    budget = args.budget_mA
    i_max = args.imax_mA

    def single_peak(k, amp):
        J = amp * J_np[k]
        return float(np.sqrt((J ** 2).sum(axis=1).max()))

    amp1 = min(i_max, budget)
    if args.jlimit > 0:
        j_limit = args.jlimit
    else:
        j_limit = float(0.6 * min(single_peak(k, amp1)
                                  for k in range(K)))

    # best feasible single channel (the conventional one-pair montage)
    best_single = 0.0
    for k in range(K):
        for s in (+1.0, -1.0):
            e = s * amp1
            pk = single_peak(k, abs(e))
            scale = min(1.0, j_limit / pk)
            best_single = max(best_single, float(w_np[k] * e * scale))

    t0 = time.perf_counter()
    i_opt, info = optimize_pattern(w, J_skin, budget=budget, i_max=i_max,
                                   j_limit=j_limit, steps=args.steps)
    obj = float(info["objective"])
    t_opt = time.perf_counter() - t0
    i_np = i_opt.cpu().numpy()

    gain = obj / best_single if best_single > 0 else float("inf")
    print(f"\n  pattern optimized in {t_opt:.2f} s "
          f"({args.steps} Frank-Wolfe steps)")
    print(f"  ROI mean E.target  optimized: {obj:8.4f} V/m   "
          f"best single channel: {best_single:8.4f} V/m   "
          f"gain {gain:.2f}x")
    print(f"  constraints: sum|i| {float(info['l1']):.3f} mA "
          f"(budget {budget}), max|i| {float(info['linf']):.3f} mA "
          f"(cap {i_max}), peak skin |J| "
          f"{float(info['peak_J_skin']):.3f} A/m^2 "
          f"(limit {j_limit:.3f})")
    print("\n  ch    x_mm    y_mm    i_mA")
    for k, (px, py) in enumerate(meta["positions"]):
        print(f"  {k:2d} {1e3*px:7.1f} {1e3*py:7.1f} {i_np[k]:+8.4f}")

    ok = (float(info["l1"]) <= budget * (1 + 1e-9)
          and float(info["linf"]) <= i_max * (1 + 1e-9)
          and float(info["peak_J_skin"]) <= j_limit * (1 + 1e-9)
          and obj >= best_single * (1 - 1e-6))

    pareto = None
    if args.pareto > 0:
        # dose-vs-safety trade-off: the Frank-Wolfe design over a j_limit
        # sweep, on the lead vectors in hand (no new solves)
        t0 = time.perf_counter()
        j_grid = np.logspace(np.log10(j_limit / 4),
                             np.log10(4 * j_limit), args.pareto)
        pareto_rows = []
        for jl in j_grid:
            _, inf_p = optimize_pattern(w, J_skin, budget=budget,
                                        i_max=i_max, j_limit=jl,
                                        steps=args.steps)
            pareto_rows.append({
                "j_limit_Apm2": float(jl),
                "roi_E_Vpm": float(inf_p["objective"]),
                "peak_J_skin_Apm2": float(inf_p["peak_J_skin"]),
                "l1_mA": float(inf_p["l1"]),
            })
        t_par = time.perf_counter() - t0
        doses = [r["roi_E_Vpm"] for r in pareto_rows]
        # dose is nondecreasing in the safety limit (larger feasible set)
        ok &= all(a <= b + 1e-9 for a, b in zip(doses, doses[1:]))
        ok &= all(r["peak_J_skin_Apm2"] <= r["j_limit_Apm2"] * (1 + 1e-6)
                  for r in pareto_rows)
        print(f"\n  Pareto dose-vs-safety sweep: {args.pareto} limits "
              f"in {t_par:.2f} s (zero new solves); dose "
              f"{doses[0]:.3f} -> {doses[-1]:.3f} V/m over j_limit "
              f"{j_grid[0]:.3f} -> {j_grid[-1]:.3f} A/m^2")
        pareto = pareto_rows

    robust = ens = tabs = None
    if args.robust > 0:
        from pelvistim_fem_tpu_torch.ops.leadfield import (
            optimize_pattern_robust, solve_basis_ensemble_refined)
        from pelvistim_fem_tpu_torch.ops.uq import (DEFAULT_GSD,
                                                    sample_sigma_tables)
        S = args.robust
        gsd = {core.BODY_MUSCLE: DEFAULT_GSD["muscle"],
               core.BODY_FAT: DEFAULT_GSD["fat"],
               core.BODY_SKIN: DEFAULT_GSD["skin"]}
        samples = sample_sigma_tables(np.asarray(specs[0].sigma_table),
                                      gsd, S, seed=args.seed)
        tabs = torch.as_tensor(samples, dtype=torch.float64, device=device)
        ens = solve_basis_ensemble_refined(scase, hier, loads, tabs,
                                           tol=1e-8)    # warm-up
        sync()
        t0 = time.perf_counter()
        ens = solve_basis_ensemble_refined(scase, hier, loads, tabs,
                                           tol=1e-8)
        sync()
        t_ens = time.perf_counter() - t0
        if not bool(ens.converged.all()):
            raise AssertionError("ensemble solves not certified: max "
                                 f"residual {float(ens.residual.max())}")
        w_sk, Jsk = [], []
        for s in range(S):
            ws, Js, _ = lead_vectors(
                case, ens.phi[s].to(torch.float32),
                sigma_table=torch.as_tensor(samples[s], dtype=torch.float32,
                                            device=device), **lead)
            w_sk.append(ws)
            Jsk.append(Js)
        w_sk = torch.stack(w_sk)
        Jsk = torch.stack(Jsk)
        t0 = time.perf_counter()
        i_rob, rinfo = optimize_pattern_robust(
            w_sk, Jsk, budget=budget, i_max=i_max, j_limit=j_limit,
            steps=args.steps,
            candidates=torch.as_tensor(np.asarray([i_np]),
                                       dtype=w_sk.dtype, device=device))
        rob_worst = float(rinfo["objective_worst"])
        t_ropt = time.perf_counter() - t0
        # the NOMINAL pattern evaluated under the sampled worlds
        w_np_sk = w_sk.cpu().numpy()
        J_all = np.einsum("k,skmc->smc", i_np, Jsk.cpu().numpy())
        pk_nom = float(np.sqrt((J_all ** 2).sum(axis=2).max()))
        i_nom_feas = i_np * min(1.0, j_limit / max(pk_nom, 1e-30))
        nom_worst = float((w_np_sk @ i_nom_feas).min())
        print(f"\n  ROBUST design over {S} sigma samples "
              f"({S * K} certified solves in {t_ens:.2f} s, "
              f"worst-case FW in {t_ropt:.2f} s):")
        print(f"  worst-sample ROI dose  robust: {rob_worst:8.4f} V/m   "
              f"nominal pattern: {nom_worst:8.4f} V/m   "
              f"(+{100 * (rob_worst / max(nom_worst, 1e-30) - 1):.1f}%)")
        print(f"  sample-wise peak skin |J| "
              f"{float(rinfo['peak_J_skin']):.3f} <= {j_limit:.3f}")
        ok &= (rob_worst >= nom_worst * (1 - 1e-6)
               and float(rinfo["peak_J_skin"]) <= j_limit * (1 + 1e-9))
        robust = {
            "S": S, "seed": args.seed,
            "ensemble_wall_s": round(t_ens, 3),
            "opt_wall_s": round(t_ropt, 3),
            "pattern_mA": i_rob.cpu().numpy().tolist(),
            "worst_dose_robust_Vpm": rob_worst,
            "worst_dose_nominal_pattern_Vpm": nom_worst,
            "mean_dose_robust_Vpm": float(rinfo["objective_mean"]),
            "peak_J_skin_Apm2": float(rinfo["peak_J_skin"]),
        }

    os.makedirs(args.outdir, exist_ok=True)
    summary = {
        "K": K, "grid": [int(gx), int(gy), int(gz)],
        "n_tets": int(case.n_tets),
        "tol": 1e-8, "max_true_residual": res,
        "basis_wall_s": round(t_basis, 3),
        "opt_wall_s": round(t_opt, 3),
        "budget_mA": budget, "imax_mA": i_max,
        "jlimit_Apm2": j_limit,
        "roi_vol_mm3": float(vol_roi) * 1e9,
        "lead_w_Vpm_per_mA": w_np.tolist(),
        "pattern_mA": i_np.tolist(),
        "roi_E_optimized_Vpm": obj,
        "roi_E_best_single_Vpm": best_single,
        "gain": gain,
        "peak_J_skin_Apm2": float(info["peak_J_skin"]),
        "robust": robust,
        "pareto": pareto,
        "ok": bool(ok),
    }
    with open(os.path.join(args.outdir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"\n  summary -> {args.outdir}/summary.json")
    return dict(summary=summary, ok=bool(ok), basis=out, ensemble=ens,
                scase=scase, hier=hier, loads=loads, tables=tabs)


def main(argv=None) -> int:
    return 0 if run(parse_args(argv))["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
