"""Solve orchestration shared by the apps (PyTorch twin of
pelvistim_fem_tpu/runner.py).

The operator follows the mesh: the structured stencil when the mesh has
lattice provenance (every generated mesh), the element operator
otherwise, preconditioned by smoothed-aggregation AMG (ops/amg) from
ELEMENT_JACOBI_MAX_NODES nodes on.  Every branch certifies a TRUE f64
relative residual: f32 inner sweeps refined against an f64 master
operator, on the card and on the CPU alike (the card runs f64 natively,
so the reference's f32-only branches for an accelerator without x64 have
no counterpart).
"""

from __future__ import annotations

import time

import torch

from pelvistim_fem_tpu_torch.ops.amg import build_amg, solve_case_amg_refined
from pelvistim_fem_tpu_torch.ops.solve import solve_case_refined
from pelvistim_fem_tpu_torch.ops.stencil import (build_stencil_case,
                                                 solve_stencil_refined)

# Lattice-less meshes of at least this many nodes take the AMG-CG element
# path; smaller ones Jacobi-PCG (as the reference switches).
ELEMENT_JACOBI_MAX_NODES = 2000


def on_card(device=None) -> bool:
    """True when `device` (default: the default device, "cuda" where a
    card is present) is a CUDA device."""
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


def preferred_dtype(device=None):
    """Case dtype of the apps: float32 on the card, float64 on the CPU
    (as the reference picks for its accelerator and its CPU).  Solves
    stay certified in f64 either way."""
    return torch.float32 if on_card(device) else torch.float64


def solve_auto(case, mesh=None, *, tol=1e-8, maxiter=30_000, timer=None):
    """Solve a Case with the certified strategy for its mesh; phi in mesh
    node order, on the case's device.  The wall time is added to
    timer.phases["solve"], the AMG hierarchy's host build (a lattice-less
    mesh of at least ELEMENT_JACOBI_MAX_NODES nodes) also to
    timer.phases["amg build"]; the hierarchy's levels are printed, and
    the hierarchy comes back as the result's `amg`.
    `mesh` feeds the hierarchy build its host data; without it the data
    is read back from the case."""
    t0 = time.perf_counter()
    device = case.nodes.device
    if mesh is not None and mesh.lattice is not None:
        # f64 master coefficients: an f32-rounded operator would cap the
        # reaction-flux consistency near 1e-4
        scase = build_stencil_case(case, mesh, dtype=torch.float64,
                                   device=device)
        res = solve_stencil_refined(scase, tol=tol, inner_tol=1e-6,
                                    maxiter=maxiter)
    elif case.n_nodes >= ELEMENT_JACOBI_MAX_NODES:
        # smoothed-aggregation AMG: Jacobi-PCG pays 100s-1000s of
        # iterations at the tissue contrasts where AMG-CG takes ~15-30
        amg = build_amg(case, mesh=mesh, dtype=torch.float32)
        print(f"    amg: {len(amg.levels)} levels {amg.sizes}, built in "
              f"{amg.build_s:.2f} s")
        if timer is not None:
            timer.phases["amg build"] = (timer.phases.get("amg build", 0.0)
                                         + amg.build_s)
        res = solve_case_amg_refined(case, amg, tol=tol, maxiter=maxiter)
    else:
        res = solve_case_refined(case, tol=tol, inner_tol=1e-6,
                                 maxiter=maxiter)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    if timer is not None:
        timer.phases["solve"] = timer.phases.get("solve", 0.0) + dt
    it = int(res.iterations)
    print(f"    solve: {dt*1e3:.0f} ms, {it} iters, "
          f"rel res {float(res.residual):.2e}, "
          f"{case.n_nodes / max(dt, 1e-9):,.0f} DOF/s")
    if not bool(res.converged):
        print("    WARNING: solver did not reach tolerance")
    return res
