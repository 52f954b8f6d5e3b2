"""P1 tetrahedral FEM assembly, matrix-free (PyTorch twin of
pelvistim_fem_tpu/ops/assembly.py).

For tet e with vertices x0..x3 the P1 shape-function gradients
G_e = [grad lambda_0 .. grad lambda_3] (4, 3) are constant and the
element stiffness is K_e = sigma_e V_e G_e G_e^T.  K x is applied without
forming K:

    q_e = G_e^T x[tets_e]          gather + 4-term sums
    y_e = sigma_e V_e G_e q_e
    y   = sum of y_e over each node's element corners

Element geometry and the scatter plan are host numpy (float64), built
once.  The element -> node sum is a deterministic gather-sum: every node
reads its element corners in the plan's sorted order through a padded
(N, K) table, so no atomics (CUDA's index_add_) and the same sums from
run to run.  Contractions are elementwise products and sums, never a
(TF32-capable) einsum or matmul.  Every device function takes any
leading lane axes on its per-node and per-element operands.

A conductivity is a scalar per element, or a symmetric 3x3 tensor per
element (anisotropic tissue, ops/aniso): K_e = V_e G_e Sigma_e G_e^T.  A
sigma table says which by its shape (is_tensor_table), never by its
number of axes alone: a lane-stacked scalar table (L, T) and a tensor
table (T, 3, 3) both have more than one.
"""

from __future__ import annotations

import numpy as np
import torch


def element_gradients(nodes: np.ndarray, tets: np.ndarray):
    """Per-element shape-function gradients and volumes (host, float64):
    (grads (M, 4, 3), vol (M,)), grads[m, i] = grad lambda_i on tet m.
    Closed-form adjugate (cross products)."""
    x = nodes[tets].astype(np.float64)               # (M, 4, 3)
    e1 = x[:, 1] - x[:, 0]
    e2 = x[:, 2] - x[:, 0]
    e3 = x[:, 3] - x[:, 0]
    c23 = np.cross(e2, e3)
    det = np.einsum("md,md->m", e1, c23)             # det [e1; e2; e3]
    vol = det / 6.0
    inv_det = 1.0 / det
    g1 = c23 * inv_det[:, None]
    g2 = np.cross(e3, e1) * inv_det[:, None]
    g3 = np.cross(e1, e2) * inv_det[:, None]
    g0 = -(g1 + g2 + g3)
    return np.stack([g0, g1, g2, g3], axis=1), vol


def scatter_plan(tets: np.ndarray, n_nodes: int):
    """Sorted element -> node plan: (perm, segids), the stable argsort of
    the flat (4M,) corner node ids and the sorted ids."""
    flat = tets.reshape(-1).astype(np.int32)
    perm = np.argsort(flat, kind="stable").astype(np.int32)
    return perm, flat[perm]


def gather_table(perm: np.ndarray, segids: np.ndarray, n_nodes: int):
    """(N, K) int64 table of the plan: row n lists node n's flat corner
    slots in sorted order, padded with 4M (a zero slot appended by
    scatter_to_nodes); K is the largest node degree."""
    counts = np.bincount(segids, minlength=n_nodes)
    starts = np.cumsum(counts) - counts
    k = np.arange(max(int(counts.max(initial=0)), 1))
    pos = starts[:, None] + k[None, :]
    valid = k[None, :] < counts[:, None]
    pad = perm.shape[0]
    return np.where(valid, perm[np.minimum(pos, pad - 1)].astype(np.int64),
                    pad)


def scatter_to_nodes(values, table):
    """Sum (..., M, 4) element-corner values into (..., N) nodal values
    (deterministic gather-sum through the gather_table)."""
    flat = values.reshape(values.shape[:-2] + (-1,))
    flat = torch.cat([flat, flat.new_zeros(flat.shape[:-1] + (1,))], -1)
    return flat[..., table].sum(-1)


def is_tensor_table(sigma_table, n_slots: int) -> bool:
    """Whether a sigma table of a case with n_slots bodies (slot 0
    included) holds 3x3 tensors, (..., n_slots, 3, 3), or scalars, (...,
    n_slots); raises where its shape is neither, or both."""
    shape = tuple(sigma_table.shape)
    tensor = shape[-3:] == (n_slots, 3, 3)
    scalar = shape[-1:] == (n_slots,)
    if tensor == scalar:
        raise ValueError(f"sigma table of shape {shape} for {n_slots} "
                         "slots: neither (..., T) scalars nor (..., T, 3, "
                         "3) tensors, or both")
    return tensor


def element_sigma(sigma_table, tet_body, n_slots: int):
    """(sigma per element, whether tensors) from a per-body table:
    (..., M) for scalars, (..., M, 3, 3) for tensors (is_tensor_table)."""
    if is_tensor_table(sigma_table, n_slots):
        return sigma_table[..., tet_body, :, :], True
    return sigma_table[..., tet_body], False


def spmv(phi, tets, grads, sigvol, table, *, tensor=False):
    """Matrix-free y = K phi.  phi (..., N); sigvol = sigma_e V_e, (...,
    M) for an isotropic conductivity, or with tensor=True (..., M, 3, 3)
    symmetric tensors."""
    xe = phi[..., tets]                                   # (..., M, 4)
    q = (grads * xe[..., None]).sum(-2)                   # (..., M, 3)
    if tensor:
        s = (sigvol * q[..., None, :]).sum(-1)            # Sigma_e q
    else:
        s = sigvol[..., None] * q
    ye = (grads * s[..., None, :]).sum(-1)                # (..., M, 4)
    return scatter_to_nodes(ye, table)


def stiffness_diagonal(grads, sigvol, table, *, tensor=False):
    """diag(K) for Jacobi preconditioning: V_e g_i^T Sigma_e g_i (tensor)
    or sigma_e V_e |grad lambda_i|^2, summed over each node's element
    corners.  sigvol as spmv takes it."""
    if tensor:
        de = (grads[..., :, :, None] * sigvol[..., None, :, :]
              * grads[..., :, None, :]).sum((-1, -2))    # (..., M, 4)
    else:
        de = sigvol[..., None] * (grads * grads).sum(-1)
    return scatter_to_nodes(de, table)
