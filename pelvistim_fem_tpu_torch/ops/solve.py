"""Preconditioned conjugate gradients (PyTorch twin of the slice of
pelvistim_fem_tpu/ops/solve.py that the certified multigrid solve uses).

Convergence is a relative residual ||r|| / ||b|| <= tol.  The loop is a
Python loop over device tensors: one host read of the stopping flag per
iteration, nothing else leaves the device.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class SolveResult:
    phi: torch.Tensor         # (N,) or (L, N) potential
    iterations: torch.Tensor  # scalar or (L,) int
    residual: torch.Tensor    # scalar or (L,) — final ||r|| / ||b||
    converged: torch.Tensor   # scalar or (L,) bool


def _dot(a, b):
    # elementwise multiply-reduce: never a (TF32-capable) matmul
    return torch.sum(a * b)


def preconditioned_cg(op, b, M, x0, *, tol=1e-8, maxiter=10_000):
    """CG for SPD `op` with an SPD preconditioner apply M(r) -> z.
    Runs in the dtype of `b`; `tol` is relative to ||b|| and may be a
    0-d tensor."""
    bnorm = torch.sqrt(_dot(b, b))
    tol_abs = torch.clamp(tol * bnorm, min=0.0)

    x = x0
    r = b - op(x0)
    z = M(r)
    rz = _dot(r, z)
    p = z
    k = 0
    done = bool(torch.sqrt(_dot(r, r)) <= tol_abs)
    while not done and k < maxiter:
        ap = op(p)
        alpha = rz / _dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = M(r)
        rz_n = _dot(r, z)
        beta = rz_n / rz
        p = z + beta * p
        rz = rz_n
        k += 1
        done = bool(torch.sqrt(_dot(r, r)) <= tol_abs)
    rel = torch.sqrt(_dot(r, r)) / torch.where(bnorm > 0, bnorm, 1.0)
    return SolveResult(phi=x, iterations=torch.tensor(k), residual=rel,
                       converged=rel <= tol)
