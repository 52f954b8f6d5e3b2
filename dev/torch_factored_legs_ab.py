#!/usr/bin/env python3
"""The body-factored legs of pelvistim_fem_tpu_torch.profile_legs (one
25-lane chunk of the step04 contact sweep, the array's 8-lane basis and
64-lane ensemble) from the checkout at TREE, on a CUDA card:

    python dev/torch_factored_legs_ab.py TREE

Imports the port from TREE (its kernels built into TREE's _build/) and
runs the same profiled calls as `profile_legs --factored` there, so that
two checkouts, e.g. a parent commit unpacked by `git archive`, can be
profiled in turns (TREE A, B, B, A) on the same card.
Prints each leg's wall, device time, busy share, launches and launches
per MG-CG iteration.  Imports no JAX.
"""

import sys
from pathlib import Path

tree = str(Path(sys.argv[1]).resolve())
sys.path.insert(0, tree)

import torch  # noqa: E402

import pelvistim_fem_tpu_torch  # noqa: E402
from pelvistim_fem_tpu_torch import profile_legs as pl  # noqa: E402
from pelvistim_fem_tpu_torch.models.pressure import (  # noqa: E402
    SWEEP_LANES_PER_CHUNK, sweep_spec)
from pelvistim_fem_tpu_torch.ops.lattice_assembly import \
    assemble_lattice  # noqa: E402
from pelvistim_fem_tpu_torch.ops.multigrid import \
    batched_mg_solve_fused_refined  # noqa: E402

if not pelvistim_fem_tpu_torch.__file__.startswith(tree):
    raise SystemExit(f"imported {pelvistim_fem_tpu_torch.__file__}, not "
                     f"the port of {tree}")
if not torch.cuda.is_available():
    raise SystemExit("no CUDA card")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

dev = "cuda:0"
print(f"tree {tree}: {torch.cuda.get_device_name(0)}")
spec, params, tables = sweep_spec()
scase, hier = assemble_lattice(spec, torch.float64, device=dev)
tabs = torch.as_tensor(tables[:SWEEP_LANES_PER_CHUNK], device=dev)
out = {}


def sweep_chunk():
    out["sweep"] = batched_mg_solve_fused_refined(scase, hier, tabs,
                                                  tol=1e-8)


n = pl._profile("sweep_chunk", sweep_chunk)[2]
it = out["sweep"].iterations.cpu().numpy()
print(f"  iterations max {it.max()} mean {it.mean():.2f} residual max "
      f"{float(out['sweep'].residual.max()):.3e}")
pl._per_iteration(n, int(it.max()))
pl._profile_array(dev, True)
