#!/usr/bin/env python3
"""Conductivity calibration on the step04 case: the inverse problem
(PyTorch twin of pelvistim_fem_tpu/apps/run_calibration.py).

    python -m pelvistim_fem_tpu_torch.apps.run_calibration [--full]
        [--noise REL] [--adam] [--fibers] [--steps N] [--outdir DIR]
        [--device cuda|cpu]

Synthesizes measurements on the pressure-sore model: solves the
ground-truth forward problem, samples the potentials of every third node
(optionally with relative noise), starts the tissue conductivities off
by the literature uncertainty (muscle 2.5x, fat 0.4x, skin 3x) and
recovers them through the differentiable solve (ops/calibrate):
Levenberg-Marquardt by default (one primal, three tangent and one trial
MG-CG solve an iteration), --adam the first-order adjoint loop (one
forward and one adjoint solve a step).  --fibers fits the muscle's fiber
anisotropy (sigma_long, sigma_trans, fibers along y) by damped
Gauss-Newton with gradients through the tensor device assembly
(ops/adjoint.solve_lattice_mg_diff).  Every solve is f64.

The reference app's --spectrum (the Cole-Cole fit, which needs ops/eqs)
and --plot (viz/plots; the card's machine has no matplotlib) are not
ported: each prints so and exits with code 2.

Outputs: DIR/summary.json (DIR/summary_fibers.json with --fibers), the
reference app's keys; the exit code is 0 only if every parameter is
recovered (LM within 1e-4, Adam within 5%, fibers within 1e-2; with
--noise within 10x the noise).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

NOT_PORTED = {"spectrum": "--spectrum (the Cole-Cole spectrum fit) waits "
                          "for ops/eqs",
              "plot": "--plot waits for viz/plots"}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="Conductivity calibration through the differentiable "
                    "solve (the reference app's --spectrum and --plot are "
                    "not ported)")
    ap.add_argument("--full", action="store_true",
                    help="full step04 resolution (~167k tets)")
    ap.add_argument("--noise", type=float, default=0.0,
                    help="relative measurement noise (e.g. 0.01)")
    ap.add_argument("--adam", action="store_true",
                    help="first-order adjoint loop instead of LM")
    ap.add_argument("--fibers", action="store_true",
                    help="fit the muscle fiber anisotropy (sigma_long, "
                         "sigma_trans) through the tensor device assembly")
    ap.add_argument("--steps", type=int, default=0,
                    help="iterations (default: 15 LM / 200 Adam / 12 "
                         "fibers)")
    ap.add_argument("--spectrum", action="store_true",
                    help="not ported (needs ops/eqs)")
    ap.add_argument("--plot", action="store_true",
                    help="not ported (needs viz/plots)")
    ap.add_argument("--outdir", default="results_calibration")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda)")
    return ap.parse_args(argv)


def _not_ported(args):
    return [msg for flag, msg in NOT_PORTED.items() if getattr(args, flag)]


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _observe(phi, noise):
    """(obs_idx, obs): every third node's potential, with relative noise
    from the seed-0 generator where noise > 0."""
    obs_idx = np.arange(0, phi.shape[0], 3)
    obs = phi.cpu().numpy()[obs_idx]
    if noise:
        rng = np.random.default_rng(0)
        obs = obs * (1 + noise * rng.standard_normal(obs.shape))
    return obs_idx, obs


def run(args) -> dict:
    """The fit; returns {"summary": summary.json's dict, "ok", "losses"
    (numpy), "fit" (numpy: the table, or (sigma_long, sigma_trans) with
    --fibers), "solves": [(kind, MG-CG iterations)] of every solve in
    order (the synthesis first), "wall_s"}."""
    import torch
    from pelvistim_fem_tpu_torch.device import resolve_device
    from pelvistim_fem_tpu_torch.models.pressure import build_pressure_spec
    from pelvistim_fem_tpu_torch.ops.adjoint import solve_stencil_mg_diff
    from pelvistim_fem_tpu_torch.ops.calibrate import (calibrate_sigma,
                                                       calibrate_sigma_lm)
    from pelvistim_fem_tpu_torch.ops.lattice_assembly import assemble_lattice

    missing = _not_ported(args)
    if missing:
        raise ValueError("; ".join(missing) + " (not ported)")
    device = resolve_device(args.device)
    spec, _ = build_pressure_spec(coarse=not args.full)
    scase, hier = assemble_lattice(spec, torch.float64, device=device)
    if args.fibers:
        return _fit_fibers(args, spec, hier, device)
    steps = args.steps or (200 if args.adam else 15)
    truth = scase.sigma_table
    names = {1: "muscle", 2: "fat", 3: "skin"}
    bodies = tuple(names)
    stats = []

    # ground-truth forward solve, sampled where surface electrodes would
    # measure
    with torch.no_grad():
        phi = solve_stencil_mg_diff(scase, hier, truth, tol=1e-10,
                                    stats=stats)
    obs_idx, obs = _observe(phi, args.noise)
    obs_idx = torch.as_tensor(obs_idx, device=device)
    obs = torch.as_tensor(obs, dtype=torch.float64, device=device)

    off = np.array([2.5, 0.4, 3.0])
    tr = truth.cpu().numpy()
    sigma0 = torch.as_tensor(tr[list(bodies)] * off, device=device)

    _sync(device)
    t0 = time.perf_counter()
    if args.adam:
        fit, losses = calibrate_sigma(scase, hier, obs_idx, obs, bodies,
                                      sigma0, steps=steps, lr=0.1, tol=1e-9,
                                      stats=stats)
        per = "1 forward + 1 adjoint MG-CG solve"
    else:
        fit, losses = calibrate_sigma_lm(scase, hier, obs_idx, obs, bodies,
                                         sigma0, iters=steps, tol=1e-9,
                                         stats=stats)
        per = "primal + 3 tangent + trial MG-CG solves"
    losses = losses.cpu().numpy()
    wall = time.perf_counter() - t0

    fit = fit.cpu().numpy()
    rows = {}
    kind = "Adam" if args.adam else "LM"
    print(f"\n  {steps} {kind} steps in {wall:.1f} s "
          f"({1e3 * wall / steps:.0f} ms/step = {per})")
    print(f"  final loss {float(losses[-1]):.3e}\n")
    print(f"  {'tissue':<8} {'true':>10} {'start':>10} "
          f"{'recovered':>10} {'err':>8}")
    ok = True
    for k, (b, nm) in enumerate(names.items()):
        err = abs(fit[b] / tr[b] - 1)
        tol_rec = (1e-4 if not args.adam else 0.05) if not args.noise \
            else 10 * args.noise
        ok &= err < tol_rec
        rows[nm] = {"true_Spm": float(tr[b]),
                    "start_Spm": float(tr[b] * off[k]),
                    "recovered_Spm": float(fit[b]),
                    "rel_err": float(err)}
        print(f"  {nm:<8} {tr[b]:>10.4g} {tr[b]*off[k]:>10.4g} "
              f"{fit[b]:>10.4g} {100*err:>7.2f}%")

    os.makedirs(args.outdir, exist_ok=True)
    out = {"method": kind, "steps": steps, "wall_s": round(wall, 2),
           "noise_rel": args.noise, "n_obs": int(obs.shape[0]),
           "final_loss": float(losses[-1]),
           "recovered": rows, "ok": bool(ok)}
    with open(os.path.join(args.outdir, "summary.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(f"\n  summary -> {args.outdir}/summary.json")
    return dict(summary=out, ok=bool(ok), losses=losses, fit=fit,
                solves=stats, wall_s=wall)


def _fit_fibers(args, spec, hier, device):
    """Recover the muscle's fiber anisotropy (sigma_long, sigma_trans)
    from synthetic potentials by damped Gauss-Newton, the gradients
    through the tensor device assembly (lattice_coeff's n_a^T Sigma n_b)
    by ops/adjoint's forward mode: an iteration is one primal and two
    tangent solves (calibrate.jacobian_columns) and one trial solve, all
    with one preconditioner (lattice_solver's, the spec's scalar
    table)."""
    import torch
    from pelvistim_fem_tpu_torch.mesh import core
    from pelvistim_fem_tpu_torch.ops.adjoint import (lattice_diff_grid,
                                                     lattice_solver)
    from pelvistim_fem_tpu_torch.ops.aniso import tensor_table
    from pelvistim_fem_tpu_torch.ops.calibrate import jacobian_columns
    from pelvistim_fem_tpu_torch.ops.lattice_assembly import \
        spec_device_arrays

    f64 = torch.float64
    iters = args.steps or 12
    dev = spec_device_arrays(spec, f64, device)
    nb = spec.n_bodies
    base = torch.as_tensor(tensor_table(spec.sigma_table), device=device)
    b = core.BODY_MUSCLE
    axis = torch.tensor((0.0, 1.0, 0.0), dtype=f64, device=device)
    d = axis / torch.linalg.vector_norm(axis)
    eye3 = torch.eye(3, dtype=f64, device=device)
    stats = []
    solver = lattice_solver(dev, hier, tol=1e-11, stats=stats)
    gidx = dev["grid_index"]

    def table_for(p):
        s_long, s_trans = torch.exp(p[0]), torch.exp(p[1])
        Sig = s_trans * eye3 + (s_long - s_trans) * (d[:, None] * d[None])
        return torch.cat([base[:b], Sig[None], base[b + 1:]])

    # literature muscle anisotropy (longitudinal / transverse, S/m)
    truth = np.array([0.4, 0.09])
    with torch.no_grad():
        x_t = lattice_diff_grid(dev, table_for(torch.log(torch.as_tensor(
            truth, device=device))), nb, solver)
    obs_idx, obs = _observe(x_t.reshape(-1)[gidx], args.noise)
    obs_idx = torch.as_tensor(obs_idx, device=device)
    obs = torch.as_tensor(obs, dtype=f64, device=device)
    scale = torch.sqrt(torch.sum(obs * obs))

    def resid(p, x_init=None):
        x = lattice_diff_grid(dev, table_for(p), nb, solver, x_init)
        return (x.reshape(-1)[gidx][obs_idx] - obs) / scale, x

    def loss(p):
        with torch.no_grad():
            r, x = resid(p)
        return float(torch.sum(r * r)), x

    start = np.array([0.25, 0.15])         # near-isotropic guess
    p = torch.log(torch.as_tensor(start, device=device))
    lam = 1e-3
    l0, x = loss(p)
    losses = [l0]
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        r, Jm, x = jacobian_columns(resid, p, x)
        A = torch.sum(Jm[:, None, :] * Jm[None, :, :], dim=-1).cpu().numpy()
        g = torch.sum(Jm * r, dim=-1).cpu().numpy()
        dp = np.linalg.solve(A + lam * np.diag(np.diag(A)), -g)
        p_try = p + torch.as_tensor(dp, device=device)
        l_try, x_try = loss(p_try)
        if l_try < losses[-1]:
            p, lam, x = p_try, lam / 3, x_try
            losses.append(l_try)
        else:
            lam *= 4
            losses.append(losses[-1])
        if losses[-1] < 1e-18:
            break
    _sync(device)
    wall = time.perf_counter() - t0

    fit = np.exp(p.cpu().numpy())
    tol_rec = 1e-2 if not args.noise else 10 * args.noise
    names = ("sigma_long", "sigma_trans")
    print(f"\n  {len(losses)-1} Gauss-Newton steps in {wall:.1f} s "
          f"(primal + 2 tangent + trial MG-CG solves/step)")
    print(f"  final loss {losses[-1]:.3e}\n")
    print(f"  {'param':<12} {'true':>10} {'start':>10} "
          f"{'recovered':>10} {'err':>8}")
    ok = True
    rows = {}
    for k, nm in enumerate(names):
        err = abs(fit[k] / truth[k] - 1)
        ok &= err < tol_rec
        rows[nm] = {"true_Spm": float(truth[k]),
                    "start_Spm": float(start[k]),
                    "recovered_Spm": float(fit[k]),
                    "rel_err": float(err)}
        print(f"  {nm:<12} {truth[k]:>10.4g} {start[k]:>10.4g} "
              f"{fit[k]:>10.4g} {100*err:>7.2f}%")

    os.makedirs(args.outdir, exist_ok=True)
    out = {"method": "GN-fibers", "steps": len(losses) - 1,
           "wall_s": round(wall, 2), "noise_rel": args.noise,
           "n_obs": int(obs.shape[0]), "final_loss": losses[-1],
           "fiber_axis": [0, 1, 0], "recovered": rows, "ok": bool(ok)}
    with open(os.path.join(args.outdir, "summary_fibers.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(f"\n  summary -> {args.outdir}/summary_fibers.json")
    return dict(summary=out, ok=bool(ok), losses=np.asarray(losses),
                fit=fit, solves=stats, wall_s=wall)


def main(argv=None) -> int:
    args = parse_args(argv)
    missing = _not_ported(args)
    if missing:
        for msg in missing:
            print(f"run_calibration: {msg}: not ported yet", file=sys.stderr)
        return 2
    return 0 if run(args)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
