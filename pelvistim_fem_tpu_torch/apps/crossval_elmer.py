#!/usr/bin/env python3
"""Cross-validate an exported Elmer case against the port (PyTorch twin of
pelvistim_fem_tpu/apps/crossval_elmer.py).

    python -m pelvistim_fem_tpu_torch.apps.crossval_elmer CASE_DIR
        [--vtu RESULT.vtu] [--params FILE.json] [--tol 1e-8]
        [--device cuda|cpu]

Reads a case directory written by `run_step03 --export-elmer`
(elmer_mesh/ + case.sif + results/), solves its mesh (certified, AMG
element path) and, when a result VTU is present (any encoding
ElmerSolver emits), diffs its fields against the solve: the potential's
relative L2 over all nodes (the gate: < 2%) and that of the nodal
'volume current' magnitude.  Without a result VTU it writes its own
solution to results/ours.vtu so ElmerSolver output can be diffed later.
Exit code 0 iff the gate passes (or there was nothing to compare).
"""

import argparse
import sys
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="cross-validate an exported "
                                 "Elmer case")
    ap.add_argument("case_dir")
    ap.add_argument("--vtu", default=None,
                    help="result VTU (default: first *.vtu under "
                         "CASE_DIR/results/)")
    ap.add_argument("--params", default=None)
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the solve (default cuda)")
    return ap.parse_args(argv)


def run(args) -> dict:
    """dict(row, wrote (the VTU written or None), potential_rel_l2,
    Jmag_rel_l2, exit)."""
    import torch
    from pelvistim_fem_tpu_torch import runner
    from pelvistim_fem_tpu_torch.device import resolve_device
    from pelvistim_fem_tpu_torch.mesh.io_elmer import read_elmer_mesh
    from pelvistim_fem_tpu_torch.models.imported import build_imported_case
    from pelvistim_fem_tpu_torch.ops import fields
    from pelvistim_fem_tpu_torch.ops.metrics import extract_results
    from pelvistim_fem_tpu_torch.utils.config import (default_params,
                                                      load_params)
    from pelvistim_fem_tpu_torch.utils.vtu import read_vtu, write_solution_vtu

    device = resolve_device(args.device)
    case_dir = Path(args.case_dir)
    mesh_dir = case_dir / "elmer_mesh"
    if not mesh_dir.is_dir():
        raise SystemExit(f"{mesh_dir} not found (expected an "
                         f"--export-elmer case directory)")
    params = (load_params(args.params) if args.params
              else default_params("step03_ankle_layers"))

    mesh = read_elmer_mesh(mesh_dir).with_positive_volumes()
    # f64 Case, as models/imported.solve_imported builds it
    case = build_imported_case(mesh, params, dtype=torch.float64,
                               device=device)
    res = runner.solve_auto(case, mesh=None, tol=args.tol)
    row = extract_results(case, res.phi, params, verbose=False)
    print(f"  ours: compliance_V={row['compliance_V']:.3f}  "
          f"roi_mean_E={row['roi_mean_E']:.3f}  "
          f"I={row['total_current_A']:.4e}")
    out = dict(row=row, wrote=None, potential_rel_l2=None,
               Jmag_rel_l2=None, exit=0, iterations=int(res.iterations),
               residual=float(res.residual))

    vtu_path = Path(args.vtu) if args.vtu else next(
        iter(sorted((case_dir / "results").glob("*.vtu"))), None)
    if vtu_path is None or not vtu_path.exists():
        path = case_dir / "results" / "ours.vtu"
        path.parent.mkdir(parents=True, exist_ok=True)
        write_solution_vtu(path, mesh, case, res.phi)
        print(f"  no reference VTU found: wrote {path} for external "
              f"comparison (run again with --vtu once ElmerSolver output "
              f"exists)")
        out["wrote"] = str(path)
        return out

    pts, pdata, *_ = read_vtu(vtu_path)
    pot_key = next((k for k in pdata
                    if k.lower() in ("potential", "phi")), None)
    if pot_key is None:
        raise SystemExit(f"{vtu_path} has no potential array "
                         f"(found: {sorted(pdata)})")
    # ElmerSolver keeps the mesh DB's node order; permuted points are
    # matched by lexicographic coordinate order
    if pts.shape[0] != mesh.n_nodes:
        raise SystemExit(f"node count mismatch: VTU {pts.shape[0]} vs "
                         f"mesh {mesh.n_nodes}")
    if np.allclose(pts, mesh.nodes, atol=1e-9):
        order = np.arange(mesh.n_nodes)
    else:
        ref_order = np.lexsort((pts[:, 2], pts[:, 1], pts[:, 0]))
        our_order = np.lexsort((mesh.nodes[:, 2], mesh.nodes[:, 1],
                                mesh.nodes[:, 0]))
        order = np.empty(mesh.n_nodes, np.int64)
        order[our_order] = ref_order
        if not np.allclose(pts[order], mesh.nodes, atol=1e-8):
            raise SystemExit("VTU points do not match the mesh nodes")
    phi_ref = np.asarray(pdata[pot_key])[order]
    phi = res.phi.cpu().numpy()
    # both ground the return electrode: compare directly
    rel_phi = float(np.linalg.norm(phi - phi_ref)
                    / max(np.linalg.norm(phi_ref), 1e-300))
    print(f"  potential rel-L2 vs {vtu_path.name}: {rel_phi:.3e}")
    out["potential_rel_l2"] = rel_phi

    jkey = next((k for k in pdata if "volume current" in k.lower()), None)
    if jkey is not None:
        J_ref = np.asarray(pdata[jkey])[order]
        Jn = fields.nodal_average(
            case, fields.cell_J(case, res.phi)).cpu().numpy()
        num = np.linalg.norm(
            np.linalg.norm(Jn, axis=1) - np.linalg.norm(J_ref, axis=1))
        den = max(np.linalg.norm(np.linalg.norm(J_ref, axis=1)), 1e-300)
        out["Jmag_rel_l2"] = float(num / den)
        print(f"  |J| rel-L2: {out['Jmag_rel_l2']:.3e}")
    ok = rel_phi < 0.02
    print("  CROSSVAL", "PASS" if ok else "FAIL",
          "(gate: potential rel-L2 < 2%)")
    out["exit"] = 0 if ok else 1
    return out


def main(argv=None) -> int:
    return run(parse_args(argv))["exit"]


if __name__ == "__main__":
    sys.exit(main())
