"""Structured 27-point stencil operator (PyTorch twin of the slice of
pelvistim_fem_tpu/ops/stencil.py on the certified solve path).

Every generated mesh is a (graded, carved, deformed) tensor-product
lattice, so the P1 stiffness matrix is exactly a 27-point stencil: K phi
at node (i, j, k) reads only neighbours (i+dx, j+dy, k+dz), dx, dy, dz in
{-1, 0, 1}.  Stored as 27 coefficient grids, SpMV is 27 shifted
multiply-adds.  Conductivity stays factored per body,
C(sigma) = sum_b sigma_b C_b, so a material sweep never re-assembles.

Carved nodes (outside the geometry) have all-zero rows and are held at 0
by the same projection as Dirichlet nodes.  Every stencil apply goes
through ops/kernels/stencil_kernels.py: the CUDA kernels on a CUDA
device, their plain twins on the CPU.
"""

from __future__ import annotations

import dataclasses

import torch

from pelvistim_fem_tpu_torch.ops.kernels.stencil_kernels import (
    DIAG_OFFSET, OFFSETS, batched_stencil_spmv, stencil_spmv)  # noqa: F401


@dataclasses.dataclass
class StencilCase:
    """Device-ready structured-operator problem instance."""
    coeff: torch.Tensor        # (n_bodies, 27, X, Y, Z) per-body stencils
    free: torch.Tensor         # (X, Y, Z) bool — solve dofs
    dirichlet: torch.Tensor    # (X, Y, Z) prescribed values (0 elsewhere)
    b_neumann: torch.Tensor    # (X, Y, Z) load
    grid_index: torch.Tensor   # (N,) int64 — mesh node -> flat grid slot
    sigma_table: torch.Tensor  # (n_bodies + 1,)

    @property
    def grid_shape(self):
        return tuple(self.free.shape)

    def astype(self, dtype) -> "StencilCase":
        """Copy with every floating tensor cast to `dtype`."""
        return StencilCase(coeff=self.coeff.to(dtype), free=self.free,
                           dirichlet=self.dirichlet.to(dtype),
                           b_neumann=self.b_neumann.to(dtype),
                           grid_index=self.grid_index,
                           sigma_table=self.sigma_table.to(dtype))


def combine_coeffs(coeff, sigma_table):
    """C(sigma) = sum_b sigma_b C_b  ->  (27, X, Y, Z).

    An explicit elementwise sum over bodies, never a matmul or einsum: a
    reduced-precision (TF32) contraction perturbs the coefficients by
    ~1e-3, which on a kappa ~ 1e6 system gives a wrong solution with a
    converged residual.

    B == 1 fast path for pre-combined stacks: taken only when the sigma
    table matches the B == 1 stack (length 2); a longer table with a
    pre-combined stack raises the shape mismatch instead."""
    B = coeff.shape[0]
    if B == 1 and sigma_table.shape[-1] == 2:
        return coeff[0] * sigma_table[1]
    if sigma_table.shape[-1] != B + 1:
        raise ValueError(f"sigma table of length {sigma_table.shape[-1]} "
                         f"for {B} bodies")
    C = sigma_table[1] * coeff[0]
    for b in range(1, B):
        C = C + sigma_table[b + 1] * coeff[b]
    return C


def batched_stencil_spmv_fused(Xs, coeff, sigma_tables):
    """Lane-stacked SpMV with body-factored coefficients:

        Y[l] = sum_b sigma[l, b] * (C_b * shift(X[l]))

    Xs (L, X, Y, Z); coeff (B, 27, X, Y, Z); sigma_tables (L, T) with
    body b at index b+1.  No per-lane (27, G) combined-coefficient block
    is ever stored: memory is O(L*G + B*27*G)."""
    B = coeff.shape[0]
    sig = sigma_tables[:, 1:1 + B].to(Xs.dtype).contiguous()
    return batched_stencil_spmv(Xs, coeff, sig)


def _operator(scase: StencilCase, sigma_table, coeff=None):
    """(op, diag, b_eff) for the stencil system with Dirichlet/carved
    projection: op(x) = x on fixed nodes, K x on free nodes."""
    C = combine_coeffs(scase.coeff if coeff is None else coeff,
                       sigma_table).contiguous()
    free = scase.free

    def raw(x):
        return stencil_spmv(x.contiguous(), C)

    def op(x):
        return torch.where(free, raw(torch.where(free, x, 0.0)), x)

    diag = torch.where(free, C[DIAG_OFFSET], 1.0)
    phi_d = torch.where(free, 0.0, scase.dirichlet)
    b_eff = torch.where(free, scase.b_neumann - raw(phi_d),
                        scase.dirichlet)
    return op, diag, b_eff
