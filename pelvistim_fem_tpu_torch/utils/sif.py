"""Elmer .sif case exporter (twin of pelvistim_fem_tpu/utils/sif.py; the
bytes it writes equal the JAX package's).

Writes an ElmerSolver input file: StatCurrentSolve steady state with
either Dirichlet electrode potentials or a uniform Neumann current
density from the TRUE mesh electrode area, plus VTU output.  With
mesh/io_elmer.write_elmer_mesh it lets ElmerSolver (where installed)
solve the port's meshes for independent verification.
"""

from __future__ import annotations

from pathlib import Path

from pelvistim_fem_tpu_torch.mesh.core import BC_ACTIVE, BC_RETURN

_HEADER = """\
Header
  CHECK KEYWORDS Warn
  Mesh DB "." "elmer_mesh"
  Include Path ""
  Results Directory "results"
End

Simulation
  Max Output Level = 5
  Coordinate System = Cartesian 3D
  Coordinate Mapping(3) = 1 2 3
  Simulation Type = Steady State
  Steady State Max Iterations = 1
  Output Intervals = 1
End

Constants
  Permittivity of Vacuum = 8.8542e-12
End

Equation 1
  Name = "Conduction"
  Active Solvers(2) = 1 2
End

Solver 1
  Equation = "Static Current Conduction"
  Procedure = "StatCurrentSolve" "StatCurrentSolver"
  Variable = "Potential"
  Variable DOFs = 1
  Calculate Volume Current = True
  Linear System Solver = Direct
  Linear System Direct Method = UMFPACK
  Steady State Convergence Tolerance = {tol}
End

Solver 2
  Equation = "ResultOutput"
  Procedure = "ResultOutputSolve" "ResultOutputSolver"
  Output File Name = "case"
  Output Format = VTU
  VTU Format = Logical True
  Save Geometry IDs = Logical True
End
"""

_BODY_NAMES = {1: "muscle", 2: "fat", 3: "skin", 4: "contact_active",
               5: "contact_return"}


def write_sif(path, case, *, tol: float = 1e-8) -> str:
    """Write case.sif for a Case whose mesh was exported with
    write_elmer_mesh (body ids and BC ids match 1:1)."""
    meta = case.meta
    sig = meta.sigma_table_host
    n_bodies = meta.n_bodies

    parts = [_HEADER.format(tol=f"{tol:.1e}")]
    for b in range(1, n_bodies + 1):
        parts.append(f"""
Body {b}
  Target Bodies(1) = {b}
  Name = "{_BODY_NAMES.get(b, f'body{b}')}"
  Equation = 1
  Material = {b}
End
""")
    for b in range(1, n_bodies + 1):
        parts.append(f"""
Material {b}
  Name = "{_BODY_NAMES.get(b, f'body{b}')}"
  Electric Conductivity = {sig[b]}
End
""")

    if meta.mode == "voltage":
        bc1 = f"  Potential = {meta.active_V}"
    else:
        bc1 = (f"  Current Density = {meta.jn_used:.6e}  "
               f"! I={meta.I_target_A*1e3:.1f}mA, "
               f"A_mesh={meta.elec_area_mesh*1e4:.4f}cm2")
    parts.append(f"""
Boundary Condition 1
  Name = "active_electrode"
  Target Boundaries = {BC_ACTIVE}
{bc1}
End

Boundary Condition 2
  Name = "return_electrode"
  Target Boundaries = {BC_RETURN}
  Potential = 0.0
End
""")
    sif = "".join(parts)
    Path(path).write_text(sif)
    return sif


def export_elmer_case(case, mesh, out_dir, *, tol: float = 1e-8):
    """Full Elmer case directory: elmer_mesh/ + case.sif + results/."""
    from pelvistim_fem_tpu_torch.mesh.io_elmer import write_elmer_mesh
    out_dir = Path(out_dir)
    write_elmer_mesh(mesh, out_dir / "elmer_mesh")
    write_sif(out_dir / "case.sif", case, tol=tol)
    (out_dir / "results").mkdir(parents=True, exist_ok=True)
    return out_dir
