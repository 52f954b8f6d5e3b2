#!/usr/bin/env python3
"""step02 — bipolar electrode shape x radius sweep, 8 cases (PyTorch twin
of pelvistim_fem_tpu/apps/run_step02.py).

    python -m pelvistim_fem_tpu_torch.apps.run_step02 [--outdir DIR]
        [--serial] [--quick] [--device cuda|cpu]

Each radius has its own graded lattice, so by default every case is
padded onto one grid envelope and the whole sweep is one certified
lane-stacked multigrid solve (parallel/geometry_sweep.build_padded_group,
ops/multigrid.batched_group_solve_mg_refined): one operator per lane,
each exactly its serial one.  --serial solves case by case
(runner.solve_auto); --quick keeps circle and square at r = 10 mm.
Rows: the top-surface peak and mean |J|, the injected current by surface
flux and by weak-form reaction, and the KCL flux error; written to
DIR/summary.csv and summary.json.
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np


def extract_top_J(case, mesh, phi):
    """(x, y, |J|) at the nodes of the top face z > 0.99 Lz (numpy)."""
    from pelvistim_fem_tpu_torch.ops import fields
    Lz = case.meta.z_skin_top
    pts = mesh.nodes
    Jn = fields.nodal_average(case, fields.cell_J(case, phi)).cpu().numpy()
    Jmag = np.linalg.norm(Jn, axis=1)
    m = pts[:, 2] > Lz * 0.99
    return pts[m, 0], pts[m, 1], Jmag[m]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="step02 electrode sweep")
    ap.add_argument("--outdir", default="results_step02")
    ap.add_argument("--quick", action="store_true",
                    help="2 cases only (circle/square at r=10mm)")
    ap.add_argument("--serial", action="store_true",
                    help="per-case solve loop (default: one padded batch)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda)")
    return ap.parse_args(argv)


def build_cases(params, shapes, radii, device):
    """[(label, shape, r)] and [(case, mesh)] of every sweep point."""
    from pelvistim_fem_tpu_torch.models.electrodes import \
        build_electrode_case
    from pelvistim_fem_tpu_torch.runner import preferred_dtype
    labels, built = [], []
    for shape in shapes:
        for r in radii:
            label = f"{shape}_r{int(r*1000)}mm"
            case, _, mesh = build_electrode_case(
                params, shape=shape, r=r, dtype=preferred_dtype(device),
                with_mesh=True, device=device)
            print(f"  [{label}] {case.n_nodes} nodes, {case.n_tets} tets")
            labels.append((label, shape, r))
            built.append((case, mesh))
    return labels, built


def solve_batch(built, device):
    """The padded MG batch: (SolveResult over the padded grid, per-case
    phi list)."""
    import torch

    from pelvistim_fem_tpu_torch.ops.multigrid import \
        batched_group_solve_mg_refined
    from pelvistim_fem_tpu_torch.parallel.geometry_sweep import (
        build_padded_group, build_padded_group_hierarchy)
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    stacked, extract = build_padded_group(built, dtype=torch.float64,
                                          device=device)
    # per-lane MG hierarchies on shared index-space transfers
    bhier = build_padded_group_hierarchy(stacked)
    sync()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = batched_group_solve_mg_refined(stacked, bhier, tol=1e-8,
                                         maxiter=30_000)
    sync()
    t_solve = time.perf_counter() - t0
    print(f"\n  padded batch {tuple(stacked.free.shape)}: assemble "
          f"{t_build:.2f} s, solve {t_solve:.2f} s, iters "
          f"{out.iterations.tolist()}")
    if not bool(out.converged.all()):
        raise RuntimeError(f"step02 batch: lanes not certified, residuals "
                           f"{out.residual.tolist()}")
    return out, extract(out.phi)


def run(args) -> dict:
    """The sweep: dict(rows, phis, labels, built, batch (SolveResult or
    None), wall_s)."""
    from pelvistim_fem_tpu_torch.device import resolve_device
    from pelvistim_fem_tpu_torch.ops import metrics
    from pelvistim_fem_tpu_torch.runner import solve_auto
    from pelvistim_fem_tpu_torch.utils.config import (default_params,
                                                      get_placement)
    from pelvistim_fem_tpu_torch.utils.summary import save_results

    device = resolve_device(args.device)
    p = default_params("step02_electrodes")
    pl = get_placement(p)
    shapes = pl.get("shapes", ["circle", "square"])
    radii = pl.get("radii_m", [0.005, 0.010, 0.015, 0.020])
    if args.quick:
        shapes, radii = ["circle", "square"], [0.010]

    t_start = time.perf_counter()
    labels, built = build_cases(p, shapes, radii, device)
    batch = None
    if args.serial:
        phis = []
        for (label, _, _), (case, mesh) in zip(labels, built):
            print(f"\n[{label}]")
            phis.append(solve_auto(case, mesh, tol=1e-8).phi)
    else:
        batch, phis = solve_batch(built, device)

    rows = []
    for (label, shape, r), (case, mesh), phi in zip(labels, built, phis):
        _, _, J = extract_top_J(case, mesh, phi)
        cur = metrics.injected_currents(case, phi)
        area = np.pi * r * r if shape == "circle" else (2 * r) ** 2
        rows.append({
            "shape": shape,
            "r_mm": r * 1000,
            "area_cm2": area * 1e4,
            "area_mesh_cm2": case.meta.elec_area_mesh * 1e4,
            "peak_J": float(J.max()),
            "mean_J_top": float(J.mean()),
            "I_total_A": cur["I_active"],
            "I_consistent_A": cur["I_active_consistent"],
            "flux_err": cur["flux_err"],
        })
        print(f"  [{label}] peak_J={J.max():.3f} A/m2  "
              f"I={cur['I_active']:.4e} A  flux_err={cur['flux_err']:.2e}")

    wall = time.perf_counter() - t_start
    save_results(rows, Path(args.outdir))
    print(f"\n  {len(rows)} cases in {wall:.1f} s")
    return dict(rows=rows, phis=phis, labels=labels, built=built,
                batch=batch, wall_s=wall)


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
