"""Carry solver state across from the JAX package as numpy arrays.

The reference package (pelvistim_fem_tpu) and this one share no code;
these helpers build this package's StencilCase and MGHierarchy from
plain numpy arrays, so a case and hierarchy assembled by the reference
can be fed to this package's solvers (solver parity tested apart from
assembly parity).  Nothing here imports the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from pelvistim_fem_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from pelvistim_fem_tpu_torch.ops.multigrid import (MGHierarchy, MGLevel,
                                                   Transfer)
from pelvistim_fem_tpu_torch.ops.stencil import StencilCase


def stencil_case_from_numpy(d: dict, *,
                            device=DEFAULT_DEVICE) -> StencilCase:
    """StencilCase from a dict of numpy arrays with keys coeff, free,
    dirichlet, b_neumann, grid_index, sigma_table.  Arrays are copied
    and keep their dtype (cast the result with StencilCase.astype)."""
    device = resolve_device(device)

    def f(a):
        return torch.tensor(np.asarray(a), device=device)

    return StencilCase(
        coeff=f(d["coeff"]),
        free=torch.tensor(np.asarray(d["free"], bool), device=device),
        dirichlet=f(d["dirichlet"]),
        b_neumann=f(d["b_neumann"]),
        grid_index=torch.tensor(np.asarray(d["grid_index"]),
                                dtype=torch.int64, device=device),
        sigma_table=f(d["sigma_table"]),
    )


def hierarchy_from_numpy(levels, axes, *,
                         device=DEFAULT_DEVICE) -> MGHierarchy:
    """MGHierarchy from [(coeff, free), ...] numpy levels (finest first)
    and the finest level's knot axes; the transfers are rebuilt from the
    axes by the same every-other-knot coarsening."""
    device = resolve_device(device)
    out, transfers = [], []
    cur_axes = tuple(np.asarray(a, np.float64) for a in axes)
    for i, (coeff, free) in enumerate(levels):
        if i > 0:
            tr = Transfer(cur_axes)
            if tr.nc != tuple(np.shape(free)):
                raise ValueError(f"level {i} has shape {np.shape(free)}, "
                                 f"the axes coarsen to {tr.nc}")
            transfers.append(tr)
            cur_axes = tr.coarse_axes
        out.append(MGLevel(
            coeff=torch.tensor(np.asarray(coeff), device=device),
            free=torch.tensor(np.asarray(free, bool), device=device)))
    return MGHierarchy(levels=tuple(out), transfers=tuple(transfers))
