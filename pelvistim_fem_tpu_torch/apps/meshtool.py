#!/usr/bin/env python3
"""Mesh interchange and inspection tool (PyTorch twin of
pelvistim_fem_tpu/apps/meshtool.py, without `solve --cem`, which needs
ops/cem).

    python -m pelvistim_fem_tpu_torch.apps.meshtool convert IN OUT
    python -m pelvistim_fem_tpu_torch.apps.meshtool inspect IN
    python -m pelvistim_fem_tpu_torch.apps.meshtool boundaries IN OUT
    python -m pelvistim_fem_tpu_torch.apps.meshtool solve IN
        [--params FILE.json] [--out DIR] [--tol 1e-8] [--vtu]
        [--estimate] [--device cuda|cpu]

Converts between Gmsh .msh, an Elmer mesh DB (a directory) and VTU by
extension; rebuilds the boundary topologically and classifies its flat
z-extremes; prints mesh statistics and shape quality; and solves an
imported mesh end to end (electrode detection, certified AMG solve, the
step03 metric row in OUT/summary.json, optionally the solution VTU and
the ZZ error estimate).
"""

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np


def _read(path):
    from pelvistim_fem_tpu_torch.models.imported import read_mesh_any
    try:
        return read_mesh_any(path)
    except ValueError as e:
        raise SystemExit(str(e))


def _write(mesh, path):
    from pelvistim_fem_tpu_torch.mesh.io_elmer import write_elmer_mesh
    from pelvistim_fem_tpu_torch.mesh.io_msh import write_msh2
    from pelvistim_fem_tpu_torch.utils.vtu import write_vtu
    p = Path(path)
    if p.suffix == ".msh":
        write_msh2(mesh, p)
    elif p.suffix == ".vtu":
        write_vtu(p, mesh, cell_data={
            "GeometryIds": np.concatenate(
                [mesh.tet_body, mesh.face_bcid + 100]).astype(np.int32)},
            include_boundary=True)
    else:
        write_elmer_mesh(mesh, p)
    print(f"wrote {p}")


def cmd_convert(args):
    _write(_read(args.input), args.output)
    return {}


def cmd_inspect(args):
    from pelvistim_fem_tpu_torch.mesh.core import tet_quality, tet_volumes
    m = _read(args.input)
    m.validate()
    vols = tet_volumes(m.nodes, m.tets)
    areas, _ = m.face_areas_normals()
    bb = np.vstack([m.nodes.min(0), m.nodes.max(0)])
    print(f"nodes     : {m.n_nodes}")
    print(f"tets      : {m.n_tets}   (vol {vols.sum():.6e} m^3, "
          f"min/mean {vols.min()/vols.mean():.2e})")
    print(f"boundary  : {m.n_faces} faces, area {areas.sum():.6e} m^2")
    print(f"bbox      : {bb[0].tolist()} .. {bb[1].tolist()}")
    print("bodies    : "
          + ", ".join(f"{b}: {int((m.tet_body == b).sum())} tets"
                      for b in np.unique(m.tet_body)))
    print("bc ids    : "
          + ", ".join(f"{b}: {int((m.face_bcid == b).sum())} faces "
                      f"({areas[m.face_bcid == b].sum()*1e4:.3f} cm2)"
                      for b in np.unique(m.face_bcid)))
    q = tet_quality(m.nodes, m.tets)
    rr, dh = q["radius_ratio"], q["min_dihedral"]
    n_sliver = int((rr < 0.1).sum())
    print(f"quality   : radius ratio min/median {rr.min():.3f}/"
          f"{np.median(rr):.3f} (1 = regular), min dihedral "
          f"{dh.min():.1f} deg"
          + (f"  WARNING: {n_sliver} slivers (ratio < 0.1)"
             if n_sliver else ""))
    return dict(nodes=m.n_nodes, tets=m.n_tets, faces=m.n_faces,
                volume=float(vols.sum()), area=float(areas.sum()),
                radius_ratio_min=float(rr.min()),
                min_dihedral=float(dh.min()), slivers=n_sliver)


def cmd_boundaries(args):
    """Rebuild the boundary topologically (faces in exactly one tet) and
    classify its flat z-extremes."""
    from pelvistim_fem_tpu_torch.mesh.boundary import (
        classify_flat_extremes, extract_boundary)
    m = _read(args.input)
    faces, parent = extract_boundary(m.tets)
    bcid = classify_flat_extremes(m.nodes, faces)
    m2 = dataclasses.replace(m, faces=faces, face_bcid=bcid,
                             face_parent=parent)
    print(f"rebuilt {len(faces)} boundary faces; "
          f"top {int((bcid == 1).sum())}, bottom {int((bcid == 2).sum())},"
          f" sides {int((bcid == 3).sum())}")
    _write(m2, args.output)
    return dict(faces=len(faces))


def cmd_solve(args):
    """An imported mesh end to end: detect the electrode BCs, assemble,
    solve certified to `tol`, and write the step03 metric row."""
    from pelvistim_fem_tpu_torch.models.imported import solve_imported
    from pelvistim_fem_tpu_torch.utils.config import (default_params,
                                                      load_params)
    params = (load_params(args.params) if args.params
              else default_params("step03_ankle_layers"))
    case, res, row, mesh = solve_imported(args.input, params, tol=args.tol,
                                          device=args.device)
    if args.estimate:
        from pelvistim_fem_tpu_torch.ops.estimate import (
            zz_error_indicators, zz_global_error)
        eta = zz_error_indicators(case, res.phi).cpu().numpy()
        eta_g, rel = (float(v) for v in zz_global_error(case, res.phi))
        body = case.tet_body.cpu().numpy()
        per = np.sqrt(np.bincount(body, weights=eta ** 2))
        row["zz_error_energy"] = eta_g
        row["zz_error_rel"] = rel
        row["zz_error_per_body"] = per.tolist()
        print(f"ZZ estimated energy error {eta_g:.3e} "
              f"({rel:.2%} of solution energy norm); per body: "
              + ", ".join(f"b{b}={v:.2e}"
                          for b, v in enumerate(per) if v > 0))
    out = Path(args.out or ".")
    out.mkdir(parents=True, exist_ok=True)
    clean = {k: (None if isinstance(v, float) and not np.isfinite(v)
                 else v) for k, v in row.items()}
    (out / "summary.json").write_text(json.dumps(clean, indent=1))
    print(f"wrote {out / 'summary.json'}")
    if args.vtu:
        from pelvistim_fem_tpu_torch.utils.vtu import write_solution_vtu
        # the mesh the solution was computed on (oriented)
        write_solution_vtu(out / "solution.vtu", mesh, case, res.phi)
        print(f"wrote {out / 'solution.vtu'}")
    return dict(row=row, iterations=int(res.iterations),
                residual=float(res.residual),
                converged=bool(res.converged))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="mesh convert / inspect / "
                                 "boundaries / solve")
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("convert")
    c.add_argument("input")
    c.add_argument("output")
    c.set_defaults(fn=cmd_convert)
    c = sub.add_parser("inspect")
    c.add_argument("input")
    c.set_defaults(fn=cmd_inspect)
    c = sub.add_parser("boundaries")
    c.add_argument("input")
    c.add_argument("output")
    c.set_defaults(fn=cmd_boundaries)
    c = sub.add_parser("solve")
    c.add_argument("input")
    c.add_argument("--params", default=None,
                   help="parameter JSON (default: bundled step03)")
    c.add_argument("--out", default=None)
    c.add_argument("--tol", type=float, default=1e-8)
    c.add_argument("--vtu", action="store_true",
                   help="also write solution.vtu")
    c.add_argument("--estimate", action="store_true",
                   help="ZZ a-posteriori energy-error estimate (global and "
                        "per body) of the solved field")
    c.add_argument("--device", default="cuda",
                   help="torch device of the solve (default cuda)")
    c.set_defaults(fn=cmd_solve)
    return ap.parse_args(argv)


def run(args) -> dict:
    return args.fn(args)


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
