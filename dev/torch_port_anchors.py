#!/usr/bin/env python3
"""Reference anchors of the step01 / step02 / step03-batch paths, computed
with the JAX package on the CPU with x64 on (the numbers chip_smoke.py
holds the PyTorch port's card run against).

    python dev/torch_port_anchors.py [--out anchors.json] [--skip-step03]
                                     [--coarse-step03]

Prints one JSON object:
  step01   the five gate values of apps/run_step01 (box, solve_auto)
  step02   the default padded MG batch of apps/run_step02 (8 cases):
           lattice shapes, envelope, per-lane MG iterations and certified
           residuals, and the rows' peak_J, mean_J_top, I_total_A,
           I_consistent_A, flux_err; and, as the spread two certified
           solvers leave in those rows, the largest relative difference
           of each key between the batch and the serial solves
           (runner.solve_auto, run_step02 --serial)
  step03   apps/run_step03 --batch at full resolution (or --coarse-step03):
           per radius group the lattice, per-lane iterations and
           residuals, and the rows' compliance_V, total_current_A,
           roi_mean_E, peak_J_skin_no_elec; wall seconds of each group
"""

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

STEP02_KEYS = ("peak_J", "mean_J_top", "I_total_A", "I_consistent_A",
               "flux_err")
STEP03_KEYS = ("compliance_V", "total_current_A", "roi_mean_E",
               "peak_J_skin_no_elec")


def step01():
    from pelvistim_fem_tpu.models.box import build_box_case
    from pelvistim_fem_tpu.ops import fields
    from pelvistim_fem_tpu.runner import solve_auto
    case, _, mesh = build_box_case(dtype=jnp.float64, with_mesh=True)
    with contextlib.redirect_stdout(sys.stderr):
        res = solve_auto(case, mesh, tol=1e-10)
    phi = np.asarray(res.phi)
    J = np.linalg.norm(np.asarray(fields.cell_J(case, res.phi)), axis=1)
    flux = np.asarray(fields.boundary_face_flux(case, res.phi))
    bcid = mesh.face_bcid
    i_top, i_bot = flux[bcid == 1].sum(), flux[bcid == 2].sum()
    exact = mesh.nodes[:, 2] / 0.02
    return dict(grid=list(mesh.lattice.grid_shape), nodes=case.n_nodes,
                tets=case.n_tets, mean_J=float(J.mean()),
                cv=float(J.std() / J.mean()),
                flux_mismatch=float(abs(abs(i_top) - abs(i_bot))
                                    / max(abs(i_top), abs(i_bot))),
                rel_l2=float(np.linalg.norm(phi - exact)
                             / np.linalg.norm(exact)),
                iterations=int(np.asarray(res.iterations)))


def step02():
    from pelvistim_fem_tpu.apps.run_step02 import extract_top_J
    from pelvistim_fem_tpu.models.electrodes import build_electrode_case
    from pelvistim_fem_tpu.ops import metrics
    from pelvistim_fem_tpu.ops.multigrid import \
        batched_group_solve_mg_refined
    from pelvistim_fem_tpu.parallel.geometry_sweep import (
        build_padded_group, build_padded_group_hierarchy)
    from pelvistim_fem_tpu.runner import solve_auto
    from pelvistim_fem_tpu.utils.config import default_params, get_placement
    p = default_params("step02_electrodes")
    pl = get_placement(p)
    built, labels = [], []
    for shape in pl["shapes"]:
        for r in pl["radii_m"]:
            case, _, mesh = build_electrode_case(p, shape=shape, r=r,
                                                 dtype=jnp.float64,
                                                 with_mesh=True)
            built.append((case, mesh))
            labels.append((f"{shape}_r{int(r * 1000)}mm", shape, r))
    t0 = time.perf_counter()
    stacked, extract = build_padded_group(built, dtype=jnp.float64)
    bhier = build_padded_group_hierarchy(
        stacked, host_coeff=extract.host_coeff, host_free=extract.host_free)
    out = batched_group_solve_mg_refined(stacked, bhier, tol=1e-8,
                                         maxiter=30_000)
    phis = extract(out.phi)
    wall = time.perf_counter() - t0

    def row(label, case, mesh, phi):
        _, _, J = extract_top_J(case, mesh, phi)
        cur = metrics.injected_currents(case, phi)
        return dict(label=label, peak_J=float(J.max()),
                    mean_J_top=float(J.mean()), I_total_A=cur["I_active"],
                    I_consistent_A=cur["I_active_consistent"],
                    flux_err=cur["flux_err"])

    rows = [row(label, case, mesh, phi) for (label, _, _), (case, mesh), phi
            in zip(labels, built, phis)]
    spread = dict.fromkeys(STEP02_KEYS, 0.0)
    for (label, _, _), (case, mesh), r in zip(labels, built, rows):
        with contextlib.redirect_stdout(sys.stderr):   # its solve line
            res = solve_auto(case, mesh, tol=1e-8)
        serial = row(label, case, mesh, res.phi)
        for k in STEP02_KEYS:
            spread[k] = max(spread[k], abs(serial[k] - r[k]) / abs(r[k]))
    return dict(
        grids=[list(m.lattice.grid_shape) for _, m in built],
        nodes=[int(c.n_nodes) for c, _ in built],
        envelope=list(stacked.free.shape),
        levels=len(bhier.levels),
        iterations=np.asarray(out.iterations).tolist(),
        residual=np.asarray(out.residual).tolist(),
        converged=bool(np.asarray(out.converged).all()),
        rows=rows, serial_vs_batch_rel=spread, wall_s=wall)


def step03(coarse):
    from pelvistim_fem_tpu.ops.metrics import extract_results
    from pelvistim_fem_tpu.parallel.geometry_sweep import solve_t_fat_group
    from pelvistim_fem_tpu.utils.config import default_params, get_placement
    p = default_params("step03_ankle_layers")
    t_fats = p["layers"]["t_fat_sweep"]
    groups = []
    for r_mm in get_placement(p).get("electrode_r_mm_list", [5, 10, 15]):
        t0 = time.perf_counter()
        out, cases, meshes = solve_t_fat_group(
            p, t_fats, r_mm * 1e-3, coarse=coarse, dtype=jnp.float64,
            tol=1e-8, refined=True)
        rows = [extract_results(cases[i], out.phi[i], p, verbose=False)
                for i in range(len(t_fats))]
        groups.append(dict(
            r_mm=r_mm, t_fat=list(t_fats),
            grid=list(meshes[0].lattice.grid_shape),
            nodes=int(cases[0].n_nodes),
            iterations=np.asarray(out.iterations).tolist(),
            residual=np.asarray(out.residual).tolist(),
            converged=bool(np.asarray(out.converged).all()),
            rows=[{k: row[k] for k in STEP03_KEYS} for row in rows],
            wall_s=time.perf_counter() - t0))
        print(f"step03 r={r_mm} mm done in {groups[-1]['wall_s']:.1f} s",
              file=sys.stderr, flush=True)
    return dict(coarse=coarse, groups=groups)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-step03", action="store_true")
    ap.add_argument("--coarse-step03", action="store_true")
    args = ap.parse_args()
    res = dict(step01=step01(), step02=step02())
    print(f"step01, step02 done", file=sys.stderr, flush=True)
    if not args.skip_step03:
        res["step03"] = step03(args.coarse_step03)
    text = json.dumps(res, indent=1)
    if args.out:
        Path(args.out).write_text(text)
    print(text)


if __name__ == "__main__":
    main()
