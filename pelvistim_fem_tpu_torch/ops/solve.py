"""Preconditioned conjugate gradients (PyTorch twin of the slice of
pelvistim_fem_tpu/ops/solve.py that the stencil solvers use).

Convergence is a relative residual ||r|| / ||b|| <= tol.  The loop is a
Python loop over device tensors: one host read of the stopping flag per
iteration, nothing else leaves the device.

  preconditioned_cg        one system, any SPD preconditioner apply
  jacobi_pcg               one system, diagonal (Jacobi) preconditioner
  batched_cg               lane-stacked systems, lanes on any one axis;
                           converged lanes freeze
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


def jacobi_pcg(op, b, diag, x0, *, tol=1e-8, maxiter=10_000):
    """CG for SPD `op` with the Jacobi preconditioner 1 / diag (1 where
    diag <= 0).  Runs in the dtype of `b`."""
    minv = torch.where(diag > 0, 1.0 / diag, torch.ones_like(diag))
    return preconditioned_cg(op, b, lambda r: minv * r, x0, tol=tol,
                             maxiter=maxiter)


def batched_cg(op, b, M, x0, *, tol, maxiter, lane_dim=0):
    """Lane-aware preconditioned CG on lane-stacked state: lane axis
    `lane_dim` (0 for (L, X, Y, Z), -1 for (X, Y, Z, L)), dots reduce over
    the other axes.  Converged lanes FREEZE through torch.where, so a
    finished lane's discarded rz/0 never reaches its state; as in the
    reference, a lane at `maxiter` that has not converged iterates on
    while another lane still runs.  `tol` is a float or a per-lane (L,)
    tensor, `maxiter` an int or a per-lane (L,) tensor.  Returns (x, r,
    iterations (L,)); one host read of the loop condition per
    iteration."""
    lane_dim %= b.dim()
    dims = tuple(d for d in range(b.dim()) if d != lane_dim)
    shape = [1] * b.dim()
    shape[lane_dim] = -1
    red = lambda a: torch.sum(a, dim=dims)
    ex = lambda v: v.reshape(shape)
    nrm = lambda a: torch.sqrt(red(a * a))
    L = b.shape[lane_dim]

    tol_abs = tol * nrm(b)
    x = x0
    r = b - op(x0)
    z = M(r)
    rz = red(r * z)
    p = z
    k = torch.zeros(L, dtype=torch.int64, device=b.device)
    done = nrm(r) <= tol_abs
    while bool(torch.any(~done & (k < maxiter))):
        ap = op(p)
        alpha = rz / red(p * ap)
        x_n = x + ex(alpha) * p
        r_n = r - ex(alpha) * ap
        z_n = M(r_n)
        rz_n = red(r_n * z_n)
        beta = rz_n / rz
        p_n = z_n + ex(beta) * p
        keep = ex(done)
        x = torch.where(keep, x, x_n)
        r = torch.where(keep, r, r_n)
        z = torch.where(keep, z, z_n)
        p = torch.where(keep, p, p_n)
        rz = torch.where(done, rz, rz_n)
        k = torch.where(done, k, k + 1)
        done = done | (nrm(r) <= tol_abs)
    return x, r, k
