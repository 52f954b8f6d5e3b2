"""Anisotropic (tensor) conductivity tables (numpy twin of
pelvistim_fem_tpu/ops/aniso.py; the same tables).

Skeletal muscle conducts ~4-5x better along its fibers than across them
(longitudinal ~0.4 S/m, transverse ~0.09 S/m, Gabriel et al. 1996).  A
(T, 3, 3) table of symmetric per-body tensors goes wherever a scalar (T,)
table goes on the element path (ops/solve.solve_case[_refined],
ops/fields, ops/metrics.injected_currents) and into the device assembly
(ops/lattice_assembly.lattice_coeff, which pre-combines it to one
stencil; solve_lattice_mg_refined, ops/adjoint.solve_lattice_mg_diff).

This module only builds such tables.
"""

from __future__ import annotations

import numpy as np
import torch

from pelvistim_fem_tpu_torch.device import DEFAULT_DEVICE, resolve_device


def uniaxial_tensor(direction, sigma_long, sigma_trans):
    """3x3 conductivity tensor for a fiber direction: sigma_long along
    `direction`, sigma_trans across it.

    Sigma = sigma_trans I + (sigma_long - sigma_trans) d d^T, symmetric
    positive definite for positive conductivities."""
    d = np.asarray(direction, np.float64)
    d = d / np.linalg.norm(d)
    return (sigma_trans * np.eye(3)
            + (sigma_long - sigma_trans) * np.outer(d, d))


def tensor_table(sigma_table, fibers: dict | None = None):
    """(T, 3, 3) numpy f64 tensor table from a scalar (T,) table.

    fibers: {body_id: (direction, sigma_long, sigma_trans)}: the bodies
    listed get the uniaxial tensor, every other body stays isotropic at
    its scalar value.  E.g. muscle fibers along y:
        tensor_table(spec.sigma_table,
                     {core.BODY_MUSCLE: ((0, 1, 0), 0.4, 0.09)})"""
    base = np.asarray(sigma_table, np.float64)
    T = base.shape[0]
    out = np.zeros((T, 3, 3))
    out[:, 0, 0] = out[:, 1, 1] = out[:, 2, 2] = base
    for body, (direction, s_long, s_trans) in (fibers or {}).items():
        out[body] = uniaxial_tensor(direction, s_long, s_trans)
    return out


def check_spd(table, tol=1e-12, *, device=DEFAULT_DEVICE):
    """The table as an f64 tensor on `device`; raises if any body tensor
    is not symmetric or not positive semi-definite (the operator would
    lose the SPD property CG and the refined solvers depend on).  Body 0
    (carved / outside) may be all zero."""
    device = resolve_device(device)
    t = np.asarray(table, np.float64)
    if t.ndim != 3 or t.shape[-2:] != (3, 3):
        raise ValueError(f"expected (T, 3, 3) tensor table, got {t.shape}")
    asym = np.abs(t - np.swapaxes(t, -1, -2)).max()
    if asym > tol:
        raise ValueError(f"tensor table not symmetric (max asym {asym:g})")
    for b, m in enumerate(t):
        w = np.linalg.eigvalsh(m)
        if b == 0 and np.allclose(m, 0):
            continue
        if w.min() < -tol:
            raise ValueError(f"body {b} tensor not PSD (eigenvalues {w})")
    return torch.as_tensor(t, device=device)
