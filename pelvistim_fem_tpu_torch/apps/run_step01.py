#!/usr/bin/env python3
"""step01 — analytic box: solve and hold the result to five gates
(PyTorch twin of pelvistim_fem_tpu/apps/run_step01.py).

    python -m pelvistim_fem_tpu_torch.apps.run_step01 [--outdir DIR]
                                                      [--device cuda|cpu]

Gates: rel_err(mean |J|) < 1e-3, CV(|J|) < 1e-2, R^2 of V(z) on a node
column > 0.9999, electrode flux mismatch < 1e-2, and rel-L2 of phi
against z / Lz <= 1e-6.  Writes DIR/metrics.json; the exit code is 0
only if every gate passes.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

TOL_REL_ERR = 1e-3
TOL_CV = 1e-2
TOL_R2 = 0.9999
TOL_FLUX = 1e-2
TOL_REL_L2 = 1e-6
SIGMA, LZ, DV = 0.2, 0.02, 1.0
J_ANALYTIC = SIGMA * DV / LZ


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="step01 analytic box")
    ap.add_argument("--outdir", default="results_step01")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda)")
    return ap.parse_args(argv)


def run(args) -> dict:
    """Build, solve and gate the box; returns metrics.json's dict plus
    the gate table under "gates" [(name, value, passed)]."""
    from pelvistim_fem_tpu_torch.device import resolve_device
    from pelvistim_fem_tpu_torch.models.box import build_box_case
    from pelvistim_fem_tpu_torch.ops import fields
    from pelvistim_fem_tpu_torch.runner import preferred_dtype, solve_auto
    from pelvistim_fem_tpu_torch.utils.timing import PhaseTimer

    device = resolve_device(args.device)
    timer = PhaseTimer()
    with timer.phase("mesh+assemble"):
        case, _, mesh = build_box_case(dtype=preferred_dtype(device),
                                       with_mesh=True, device=device)
    print(f"  mesh: {case.n_nodes} nodes, {case.n_tets} tets")
    res = solve_auto(case, mesh, tol=1e-10, timer=timer)
    phi = res.phi.cpu().numpy().astype(np.float64)

    J = fields.cell_J(case, res.phi).cpu().numpy().astype(np.float64)
    Jmag = np.linalg.norm(J, axis=1)
    rel_err = abs(Jmag.mean() - J_ANALYTIC) / J_ANALYTIC
    cv = Jmag.std() / Jmag.mean()

    pts = mesh.nodes
    col = (np.abs(pts[:, 0] - 0.02) < 1e-9) & (np.abs(pts[:, 1] - 0.02)
                                               < 1e-9)
    z, v = pts[col, 2], phi[col]
    A = np.vstack([z, np.ones_like(z)]).T
    coef, *_ = np.linalg.lstsq(A, v, rcond=None)
    r2 = 1 - ((v - A @ coef) ** 2).sum() / ((v - v.mean()) ** 2).sum()

    flux = fields.boundary_face_flux(case, res.phi).cpu().numpy()
    bcid = mesh.face_bcid
    I_top, I_bot = flux[bcid == 1].sum(), flux[bcid == 2].sum()
    flux_mismatch = abs(abs(I_top) - abs(I_bot)) / max(abs(I_top),
                                                       abs(I_bot))
    exact = pts[:, 2] / LZ
    rel_l2 = np.linalg.norm(phi - exact) / np.linalg.norm(exact)

    gates = [
        ("rel_err(mean|J|) < 1e-3", rel_err, rel_err < TOL_REL_ERR),
        ("CV(|J|) < 1e-2", cv, cv < TOL_CV),
        ("R2(V(z)) > 0.9999", r2, r2 > TOL_R2),
        ("flux mismatch < 1e-2", flux_mismatch, flux_mismatch < TOL_FLUX),
        ("rel-L2 vs analytic <= 1e-6", rel_l2, rel_l2 <= TOL_REL_L2),
    ]
    print(f"\n  |J| mean = {Jmag.mean():.6f} A/m2 (analytic "
          f"{J_ANALYTIC})")
    ok = True
    for name, val, passed in gates:
        print(f"  [{'PASS' if passed else 'FAIL'}] {name:<32} "
              f"(got {val:.3e})")
        ok &= bool(passed)

    metrics = {
        "mean_J": float(Jmag.mean()), "rel_err": float(rel_err),
        "cv": float(cv), "r2": float(r2),
        "flux_mismatch": float(flux_mismatch),
        "rel_l2_vs_analytic": float(rel_l2),
        "phases_s": timer.report(), "passed": ok,
    }
    out = Path(args.outdir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "metrics.json").write_text(json.dumps(metrics, indent=2))
    print(f"\n  metrics -> {out / 'metrics.json'}")
    print("\n  RESULT:", "PASS" if ok else "FAIL")
    return dict(metrics, gates=gates, iterations=int(res.iterations),
                residual=float(res.residual))


def main(argv=None) -> int:
    return 0 if run(parse_args(argv))["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
