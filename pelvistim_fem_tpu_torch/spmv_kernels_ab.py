"""Kernel 1 against its probes on the megatet lattice (the counterpart of
dev/spmv_kernels_ab.py).

    python -m pelvistim_fem_tpu_torch.spmv_kernels_ab [--small] [--device D]

Builds the benchmark's megatet step03 spec (models/ankle.megatet_spec;
--small: the step03 spec at mesh spacings 3.0 / 2.0 / 0.8 mm), assembles
it in float32, combines its conductivities into one stencil C and, on x
of normal values from seed 0 over sqrt(G), runs:

  xla     the plain PyTorch twin, stencil_spmv_plain (the dev script's
          XLA row)
  v0      kernel 1, stencil_spmv_cuda (the dev script's vslice computes
          the same function and is served by the same kernel)
  vnoop   the plane-FMA probe with 27 planes on x rows i-1, i, i+1 and no
          neighbour shifts (wrong by design): kernel 1's bytes and
          multiply-adds without its shifts, so v0 - vnoop is what the
          shifts cost
  vbf16   kernel 1 with bf16 coefficient planes, stencil_spmv_bf16c_cuda:
          what halving the coefficient traffic buys

v0, vnoop and vbf16 are held against their twins (float32 tolerance;
vbf16's twin gets the same bf16 coefficients), and v0's and vbf16's
largest error relative to the twin's f32-coefficient product is printed
(vbf16's is the rounding of its coefficients, printed, not held).  On a
CUDA device it then times each: kernels by measure.kernel_ms (a CUDA
graph of 20 launches, inputs rotated through HBM), the twin by CUDA
events around one call, and prints ms, GB/s of the kernel's bound bytes,
their share of the H100's 3.35 TB/s and the share of the kernel's bound.
The dev script's v0r16 / vsl16 / vb16r16 rows are Pallas block heights
(VMEM tiles) with no CUDA counterpart.  Its x = 1 / sqrt(G) is not kept:
every row of the assembled stencil sums to 0, so K x is rounding noise
there and no error could be read against it.  With --device cpu only the checks
run (no time is taken on the CPU).  main() returns the rows as a dict.
"""

from __future__ import annotations

import argparse
import itertools

import numpy as np
import torch

from .device import DEFAULT_DEVICE, resolve_device
from .models.ankle import build_layered_spec, megatet_spec
from .ops.kernels import measure
from .ops.kernels import stencil_kernels as sk
from .ops.lattice_assembly import assemble_lattice
from .ops.stencil import combine_coeffs
from .utils.config import default_params

SMALL_MESH = {"lc_global_mm": 3.0, "lc_electrode_mm": 2.0,
              "lc_skin_min": 0.8}
BLOCK_HEIGHT_ROWS = ("v0r16", "vsl16", "vb16r16")
SEED = 0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true",
                    help="the step03 spec at coarse mesh spacings")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    return ap.parse_args(argv)


def build_stencil(small, device):
    """(spec, C): the spec and its combined float32 stencil (27, X, Y,
    Z) on `device`."""
    if small:
        params = default_params("step03_ankle_layers")
        params["mesh"] = dict(SMALL_MESH)
        spec, _ = build_layered_spec(params)
    else:
        spec, _ = megatet_spec()
    scase, _ = assemble_lattice(spec, torch.float32, device=device)
    return spec, combine_coeffs(scase.coeff, scase.sigma_table).contiguous()


def variants(x0, C):
    """{row: (kernel name, dispatch function, its arguments)}."""
    return {
        "v0": ("stencil_spmv_cuda", sk.stencil_spmv, (x0, C)),
        "vnoop": ("plane_fma_cuda", sk.plane_fma, (x0, C, 3)),
        "vbf16": ("stencil_spmv_bf16c_cuda", sk.stencil_spmv_bf16c,
                  (x0, C.to(torch.bfloat16))),
    }


def bound_shape(name, grid):
    """The shape measure.bound takes for kernel `name` on `grid`."""
    return (27, 3, grid) if name == "plane_fma_cuda" else grid


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    spec, C = build_stencil(args.small, dev)
    grid = tuple(spec.grid_shape)
    G = int(np.prod(grid))
    rng = np.random.default_rng(SEED)
    x0 = torch.as_tensor(rng.standard_normal(grid) / np.sqrt(G),
                         dtype=torch.float32, device=dev)
    mb = (27 * G + 2 * G) * 4 / 1e6
    print(f"grid {grid} G={G} logical f32 MB/apply {mb:.1f}", flush=True)

    y_ref = sk.stencil_spmv_plain(x0, C)
    scale = float(y_ref.abs().max())
    out = {"grid": grid, "G": G, "mb_per_apply": mb, "errors": {},
           "rows": {}}
    runs = variants(x0, C)
    for row, (name, fn, a) in runs.items():
        y = fn(*a)
        twin = getattr(sk, name.replace("_cuda", "_plain"))
        err = measure.check_close(f"{row} {name}", y, twin(*a),
                                  torch.float32)
        line = f"  {row} against its twin: max abs err {err:.2e}"
        if row != "vnoop":          # vnoop computes another function
            rel = float((y - y_ref).abs().max()) / scale
            out["errors"][row] = rel
            line += f"; max rel err vs the f32 product: {rel:.2e}"
        print(line, flush=True)
    print("  vslice: kernel 1's function, served by v0's kernel",
          flush=True)

    if dev.type != "cuda":
        print("timings: not measured (they need a CUDA device)", flush=True)
        return out
    copies_ref = measure.input_copies((x0, C))
    turn = itertools.cycle(copies_ref)
    xla_ms = measure.cuda_ms(lambda: sk.stencil_spmv_plain(*next(turn)))
    del copies_ref, turn
    timed = {"xla": ("stencil_spmv_cuda", xla_ms)}
    for row, (name, _, a) in runs.items():
        kernel = getattr(sk, name)
        copies = measure.input_copies(a)
        timed[row] = (name, measure.kernel_ms(kernel, copies))
        del copies
        torch.cuda.empty_cache()
    for row, (name, ms) in timed.items():
        shape = bound_shape(name, grid)
        b_ms, _ = measure.bound(name, shape, "float32")
        gbs = measure.work(name, shape, "float32")[0] / (ms * 1e-3) / 1e9
        out["rows"][row] = dict(kernel=name, ms=ms, gb_s=gbs,
                                hbm_share=gbs * 1e9 / measure.HBM_BYTES_PER_S,
                                bound_ms=b_ms, bound_share=b_ms / ms)
        print(f"{row:6s}: {ms:.4f} ms/apply, {gbs:.0f} GB/s of its bound "
              f"bytes ({100 * gbs * 1e9 / measure.HBM_BYTES_PER_S:.1f}% "
              f"of 3.35 TB/s), {100 * b_ms / ms:.1f}% of its bound "
              f"{b_ms:.4f} ms", flush=True)
    for row in BLOCK_HEIGHT_ROWS:
        print(f"{row}: same CUDA kernel; no block-height counterpart",
              flush=True)
    shifts = out["rows"]["v0"]["ms"] - out["rows"]["vnoop"]["ms"]
    out["shift_ms"] = shifts
    print(f"v0 - vnoop (the cost of the neighbour shifts): {shifts:.4f} ms",
          flush=True)
    return out


if __name__ == "__main__":
    main()
