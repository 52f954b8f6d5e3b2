"""Tile variants of the two batched stencil kernels, and block sizes of
the V-cycle tail kernel and of the level kernels, timed on a CUDA card.

    python -m pelvistim_fem_tpu_torch.profile_kernels          # all
    python -m pelvistim_fem_tpu_torch.profile_kernels --tail   # the tails
    python -m pelvistim_fem_tpu_torch.profile_kernels --tail --clocks
    python -m pelvistim_fem_tpu_torch.profile_kernels --levels # levels
    python -m pelvistim_fem_tpu_torch.profile_kernels --factored
    python -m pelvistim_fem_tpu_torch.profile_kernels --factored \
        --against <checkout of another tree>
    python -m pelvistim_fem_tpu_torch.profile_kernels --transfers

Builds the kernel library once per variant of the tile constants of
csrc/stencil.cu (-D flags; all builds at once, each in _build/ under its
own hash), then for every variant, kernel (lane-major
`batched_stencil_spmv_cuda`, lane-minor `batched_stencil_spmv_lminor_cuda`),
dtype and shape the paths launch (L=25 and L=15 with B=5 on the sweep's
(89, 41, 19) lattice, L=27 with B=1 on the megatet's (112, 68, 41)) it
holds the kernel against its plain twin and reads its device time with
`measure.kernel_ms` (inputs from HBM).  It prints ptxas's registers and
spills of each variant's instantiations on those shapes, then a table of
times, each with its share of the kernel's bound.  The production
wrappers use the default build ("default" below).

With --clocks, a -DPST_TAIL_CLOCKS build breaks one launch of the tail
(and of the cluster tail) down by phase: thread 0 of the first block
reads clock64() at each phase's end (csrc/stencil.cu, TailClock).

The cluster tail (`cluster_tail_cuda`) is timed at each of CLUSTER_RANKS
blocks a cluster on the paths' levels from the one above the tail
(CLUSTER_TAILS), cold and warm, beside the level-kernel launches and the
tail launch it replaces as one CUDA graph.

The tail kernel (`vcycle_tail_cuda`) is built at each of TAIL_THREADS
threads a block in both dtypes (-DPST_TAIL_THREADS; the default build
takes 512 in float32 and 256 in float64) and timed the same way on the
paths' tails, SPD stencils on their level grids (step04's app, the megatet,
step02's 8 lanes, the sweep's 25 lanes, step04's 15 linear lanes), f32
and f64, each build first held against the twin
(measure.check_vcycle_tail).

The level kernels (`level_apply_cuda` in its four modes, `restrict_cuda`,
`prolong_add_cuda`) are built at each of LEVEL_THREADS threads a block
(-DPST_LEVEL_THREADS; the default build takes 256) and timed at the
levels above the paths' tails (LEVELS), cold (inputs rotated through
HBM) and warm (the same inputs each launch, as a solve finds them in L2),
each build first held against the twin; kernel 1 is timed cold and warm
at the same grids beside them.

The body-factored level kernel (`level_apply_factored_cuda`, its four
modes) is timed cold and warm at the body-factored levels above the
paths' tails (FACTORED: the sweep's three at 25 lanes, the Jacobi MG
rows' three and step04's two at 15, 5 bodies; the array's three at 8
and 64 lanes, 3 bodies): the launch `march_plan` makes, and each of its
kernels forced (the march, `march_blocks`; kernel 2's tiles), each held
torch.equal to the card's route (kernel 2 and PyTorch's ops), and
kernel 2 beside the kernel.  With --against DIR, the same wrapper of
the checkout at DIR (its own build) is timed on the same inputs in
turns with this tree's (DIR, this, this, DIR; the medians of each
tree's two).

The transfers (`restrict_cuda`, `prolong_add_cuda`; `level_apply_cuda`
in mode "prolong_sweep") are built at each of TRANSFER_VARIANTS (the
restriction's tile of coarse points and threads, -DPST_RS_*; the
prolong_sweep tile and threads, -DPST_PS_*) and timed cold and warm
at the paths' shapes (RESTRICTS, PROLONG_ADDS, PROLONG_SWEEPS), each build
first held torch.equal to the route; prolong_add then "sweep" (the two
launches "prolong_sweep" replaces) are timed beside it.  With --against
DIR, the checkout at DIR's wrapper of each is timed in turns with this
tree's default build (DIR, this, this, DIR):

    python -m pelvistim_fem_tpu_torch.profile_kernels --transfers \
        --against <checkout of another tree>
"""

from __future__ import annotations

import argparse
import importlib.util
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

SWEEP_GRID, MEGATET_GRID = (89, 41, 19), (112, 68, 41)
SHAPES = [(25, 5, SWEEP_GRID), (15, 5, SWEEP_GRID), (27, 1, MEGATET_GRID)]
KERNELS = ["batched_stencil_spmv_cuda", "batched_stencil_spmv_lminor_cuda"]
CONSTANTS = ("POINTS", "LANES", "THREADS", "MINB")
# the tail kernel's block sizes, and the paths' tails (S lanes, level
# grids) in f32 and in f64 (from the first level that fits in f64): the
# step04 app's nonlinear chain, the megatet, step02's 8 lanes, the sweep's
# 25-lane chunk and the step04 app's 15 linear lanes
TAIL_THREADS = (256, 512)
TAILS = {"float32": [(1, ((15, 9, 6), (8, 5, 4), (5, 3, 3))),
                     (1, ((15, 10, 6), (8, 6, 4), (5, 4, 3))),
                     (8, ((18, 8, 3), (10, 5, 2))),
                     (25, ((12, 6, 4), (7, 4, 3))),
                     (15, ((15, 9, 6), (8, 5, 4), (5, 3, 3)))],
         "float64": [(1, ((8, 5, 4), (5, 3, 3))),
                     (1, ((8, 6, 4), (5, 4, 3))),
                     (8, ((18, 8, 3), (10, 5, 2))),
                     (25, ((12, 6, 4), (7, 4, 3))),
                     (15, ((8, 5, 4), (5, 3, 3)))]}


def _flags(**cells):
    """-D flags of tile constants, per cell "<kernel>_<dtype>" (b2_f32 for
    the lane-major kernel in float32, lm_f64 for the lane-minor one in
    float64, ...): (points, largest lanes per thread, threads, blocks per
    SM)."""
    flags = []
    for cell, values in cells.items():
        kernel, dt = cell.split("_")
        flags += [f"-DPST_{kernel.upper()}_{n}_{dt.upper()}={v}"
                  for n, v in zip(CONSTANTS, values)]
    return tuple(flags)


# Each build varies all four (kernel, dtype) cells at once: a column is
# read per cell.  Defaults (csrc/stencil.cu): b2_f32 (64, 4, 448, 2),
# b2_f64 (32, 2, 416, 2), lm_f32 (64, 2, 512, 2), lm_f64 (16, 2, 256, 2).
VARIANTS = {
    "default": _flags(),
    "a": _flags(b2_f32=(64, 4, 512, 1), b2_f64=(32, 2, 512, 1),
                lm_f32=(64, 1, 512, 2), lm_f64=(32, 1, 512, 2)),
    "b": _flags(b2_f32=(32, 4, 448, 2), b2_f64=(32, 1, 800, 1),
                lm_f32=(64, 3, 512, 2), lm_f64=(32, 2, 256, 3)),
    "c": _flags(b2_f32=(128, 4, 896, 1), b2_f64=(64, 2, 832, 1),
                lm_f32=(32, 2, 256, 3), lm_f64=(32, 2, 512, 1)),
    "d": _flags(b2_f32=(64, 3, 576, 1), b2_f64=(32, 2, 448, 1),
                lm_f32=(64, 2, 256, 2), lm_f64=(64, 2, 512, 1)),
    "e": _flags(b2_f32=(32, 4, 256, 3), b2_f64=(32, 2, 416, 1),
                lm_f32=(32, 1, 512, 2), lm_f64=(16, 1, 256, 2)),
}


def time_variants(variants):
    """[(kernel, dtype, shape, bound_ms, {variant: ms})] for every kernel,
    dtype and shape; each variant (name: nvcc flags) is first held
    against the plain twin."""
    from pelvistim_fem_tpu_torch.ops.kernels import measure
    from pelvistim_fem_tpu_torch.ops.kernels import stencil_kernels as sk
    rng = np.random.default_rng(0)
    rows = []
    for name in KERNELS:
        twin = getattr(sk, name.replace("_cuda", "_plain"))
        for dn in ("float32", "float64"):
            dtype = getattr(torch, dn)
            for shape in SHAPES:
                args = measure.kernel_inputs(name, shape, dtype, "cuda", rng)
                ref = twin(*args)
                copies = measure.input_copies(args)
                times = {}
                for v, fl in variants.items():
                    def kernel(*a, _fl=fl):
                        return sk.launch(name, *a, extra_flags=_fl)
                    measure.check_close(f"{v} {name} {dn} {shape}",
                                        kernel(*args), ref, dtype)
                    times[v] = measure.kernel_ms(kernel, copies)
                rows.append((name, dn, shape,
                             measure.bound(name, shape, dn)[0], times))
                del copies
                torch.cuda.empty_cache()
    return rows


def print_table(rows, gpu):
    variants = list(rows[0][4])
    print(f"kernel device ms (share of bound), inputs from HBM; {gpu}")
    print("  " + " ".join(f"{v:>16s}" for v in variants)
          + "  kernel dtype L,B,grid bound_ms")
    for name, dn, (L, B, grid), b_ms, times in rows:
        cells = " ".join(f"{times[v]:8.4f} ({100 * b_ms / times[v]:4.1f}%)"
                         for v in variants)
        best = min(times, key=times.get)
        print(f"  {cells}  {name.replace('batched_stencil_spmv', 'b')} "
              f"{dn} {L},{B},{grid} {b_ms:.4f} best {best}")


def print_usage(variants):
    """ptxas's registers and spills of the instantiations SHAPES use."""
    from pelvistim_fem_tpu_torch.ops.kernels import stencil_kernels as sk
    print("ptxas: registers / spill bytes of the instantiations the "
          "shapes launch (B = 5 and B = 1)")
    for v, fl in variants.items():
        usage = {k: u for k, u in sk.ptxas_usage(fl).items()
                 if k.startswith("batched") and k.split(",")[1] in ("1", "5")}
        print(f"  {v:8s} {' '.join(fl) or '(no flags)'}")
        for k, u in sorted(usage.items()):
            print(f"    {k:52s} {u['registers']:4d} regs "
                  f"{u['spill_bytes']:5d} B spilled")


# the level kernels' block sizes, and the grids above the paths' tails:
# the step04 app's two, the megatet's three, step02's 8-lane fine level
LEVEL_THREADS = (128, 256, 512)
LEVELS = [(55, 31, 19), (28, 16, 10), (112, 68, 41), (57, 35, 21),
          (29, 18, 11), (8, 67, 29, 8)]


def level_flags(threads):
    return (f"-DPST_LEVEL_THREADS={threads}",)


def time_levels(gpu):
    """The level kernels at each of LEVEL_THREADS on LEVELS, f32 and f64,
    cold and warm, against the bound; kernel 1 (the default build) cold
    and warm at the same grids."""
    from pelvistim_fem_tpu_torch.ops.kernels import measure
    from pelvistim_fem_tpu_torch.ops.kernels import stencil_kernels as sk
    for t in LEVEL_THREADS:
        for k, u in sorted(sk.ptxas_usage(level_flags(t)).items()):
            if k.startswith(("level_apply", "restrict", "prolong_add")):
                print(f"  {t:5d} threads {k:32s} {u['registers']:4d} regs "
                      f"{u['spill_bytes']:5d} B spilled")
    print(f"level kernels' device ms cold / warm by threads a block "
          f"{LEVEL_THREADS}; {gpu}")
    rng = np.random.default_rng(2)
    for dn in ("float32", "float64"):
        dtype = getattr(torch, dn)
        for grid in LEVELS:
            lanes = grid[0] if len(grid) == 4 else 1
            jobs = [("level_apply_cuda", (m, lanes, grid)) for m in
                    ("sweep", "sweep0", "residual", "masked")]
            jobs += [("restrict_cuda", (lanes, grid)),
                     ("prolong_add_cuda", (grid,)),
                     ("stencil_spmv_cuda", grid)]
            for name, shape in jobs:
                args = measure.kernel_inputs(name, shape, dtype, "cuda", rng)
                ref = getattr(sk, name.replace("_cuda", "_plain"))(*args)
                builds = [()] if name == "stencil_spmv_cuda" else \
                    [level_flags(t) for t in LEVEL_THREADS]
                cold = measure.input_copies(args)
                warm = measure.input_copies(args, warm=True)
                cells = []
                for fl in builds:
                    def kernel(*a, _fl=fl):
                        return sk.launch(name, *a, extra_flags=_fl)
                    measure.check_close(f"{fl} {name} {shape} {dn}",
                                        kernel(*args), ref, dtype)
                    cells.append(f"{measure.kernel_ms(kernel, cold):.4f} / "
                                 f"{measure.kernel_ms(kernel, warm):.4f}")
                b_ms = measure.bound(name, shape, dn)[0]
                print(f"  {'   '.join(cells)}  {name} {dn} {shape} bound "
                      f"{b_ms:.6f}")
                del cold
                torch.cuda.empty_cache()


# the body-factored level kernel's levels: (lanes, bodies, grid)
FACTORED = [(25, 5, (89, 41, 19)), (25, 5, (45, 21, 10)),
            (25, 5, (23, 11, 6)), (15, 5, (89, 41, 19)),
            (15, 5, (45, 21, 10)), (15, 5, (23, 11, 6)),
            (15, 5, (55, 31, 19)), (15, 5, (28, 16, 10)),
            (8, 3, (71, 71, 24)), (8, 3, (36, 36, 13)), (8, 3, (19, 19, 7)),
            (64, 3, (71, 71, 24)), (64, 3, (36, 36, 13)),
            (64, 3, (19, 19, 7))]


def load_tree(path):
    """The stencil_kernels module of the checkout at `path` (its kernels
    built into that checkout's _build/), beside this tree's."""
    src = Path(path) / "pelvistim_fem_tpu_torch/ops/kernels/stencil_kernels.py"
    spec = importlib.util.spec_from_file_location("against_stencil_kernels",
                                                  src)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod      # its dataclasses look themselves up
    spec.loader.exec_module(mod)
    return mod


def factored_with(plan):
    """level_apply_factored_cuda's launch with `plan` (a MarchPlan; tiles
    for kernel 2's tiles) in place of march_plan's, uncounted."""
    from pelvistim_fem_tpu_torch.ops.kernels import stencil_kernels as sk

    def run(*args):
        tensors, dims, entry = sk._dims_level_apply_factored(*args)
        dims = dims[:6] + ((0, 0, 0) if plan.tiles else
                           (plan.ty, plan.seg, plan.lanes))
        lib = sk.build()
        out = torch.empty_like(tensors[0])
        rc = getattr(lib, entry)(*(t.data_ptr() for t in tensors),
                                 out.data_ptr(), *dims,
                                 torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{entry}: {lib.pst_error_string(rc).decode()}")
        return out
    return run


def time_factored(gpu, against=None):
    """The body-factored level kernel on FACTORED, f32 and f64, every
    mode, cold and warm, against the bound: the launch march_plan makes
    ("plan"), and each of its two kernels forced, the march
    (march_blocks) and kernel 2's tiles, each held torch.equal to the
    route; kernel 2 cold and warm at the same shapes.  against: another
    tree's stencil_kernels (load_tree), its wrapper timed in turns with
    this tree's plan on the same inputs (other, plan, plan, other)."""
    from pelvistim_fem_tpu_torch.ops.kernels import measure
    from pelvistim_fem_tpu_torch.ops.kernels import stencil_kernels as sk
    for k, u in sorted(sk.ptxas_usage().items()):
        if k.startswith(("level_march", "level_apply_factored")) and \
                k.split(",")[1] in ("3", "5"):
            print(f"  {k:48s} {u['registers']:4d} regs "
                  f"{u['spill_bytes']:5d} B spilled")
    print(f"body-factored level kernel device ms cold / warm: the plan's "
          f"launch" + (" (the other tree's as \"other\", in turns)"
                       if against else "") + f", the march, the tiles; "
          f"{gpu}")
    name = "level_apply_factored_cuda"
    rng = np.random.default_rng(3)
    tiles = sk.MarchPlan(0, 0, 0, 0, 0, 0, 0, 0, tiles=True)
    for dn in ("float32", "float64"):
        dtype = getattr(torch, dn)
        for L, B, grid in FACTORED:
            for mode in sk.FACTORED_MODES:
                shape = (mode, B, (L,) + grid)
                x, b, lv, _, omega = measure.kernel_inputs(
                    name, shape, dtype, "cuda", rng)
                args = (None if mode == "sweep0" else x,
                        None if mode == "masked" else b, lv, mode, omega)
                route = sk.level_apply_factored_plain(
                    *args, spmv=sk.batched_stencil_spmv_cuda)
                measure.check_close(f"{shape} {dn}",
                                    sk.level_apply_factored_cuda(*args),
                                    sk.level_apply_factored_plain(*args),
                                    dtype)
                plan = sk.march_plan(L, B, grid, dtype, mode)
                runs = {"plan": sk.level_apply_factored_cuda,
                        "march": factored_with(sk.march_blocks(
                            L, B, grid, dtype, mode)),
                        "tiles": factored_with(tiles)}
                if against is not None:
                    runs["other"] = against.level_apply_factored_cuda
                for k, fn in runs.items():
                    if not torch.equal(fn(*args), route):
                        raise AssertionError(f"{shape} {dn} {k}: not the "
                                             "route")
                copies = {"cold": measure.input_copies(args),
                          "warm": measure.input_copies(args, warm=True)}
                ms = {}
                for temp, cp in copies.items():
                    times = {k: [] for k in runs}
                    order = (["other", "plan", "plan", "other"]
                             if against is not None else ["plan"])
                    for k in order:
                        times[k].append(measure.kernel_ms(runs[k], cp))
                    for k in runs:
                        if not times[k]:
                            times[k].append(measure.kernel_ms(runs[k], cp))
                    ms[temp] = {k: float(np.median(v))
                                for k, v in times.items()}
                cells = "; ".join(
                    f"{k} " + " / ".join(f"{ms[t][k]:.4f}" for t in ms)
                    for k in runs)
                b_ms = measure.bound(name, shape, dn)[0]
                kind = "tiles" if plan.tiles else (
                    f"march: {plan.ty} rows, {plan.lanes} lanes, segments of "
                    f"{plan.seg}, {plan.blocks} blocks of {plan.threads} "
                    f"threads, {plan.smem} B")
                print(f"  {dn} {mode} L={L} B={B} {grid} bound {b_ms:.6f} "
                      f"({100 * b_ms / ms['cold']['plan']:.0f}% cold); "
                      f"{cells}; the plan's {kind}", flush=True)
                del copies
            xs = measure.kernel_inputs("batched_stencil_spmv_cuda",
                                       (L, B, grid), dtype, "cuda", rng)
            k2 = sk.batched_stencil_spmv_cuda
            print(f"  kernel 2 {measure.kernel_ms(k2, measure.input_copies(xs)):.4f}"
                  f" / {measure.kernel_ms(k2, measure.input_copies(xs, warm=True)):.4f}"
                  f"  {dn} L={L} B={B} {grid} bound "
                  f"{measure.bound('batched_stencil_spmv_cuda', (L, B, grid), dn)[0]:.6f}")
            torch.cuda.empty_cache()


# the transfers' builds: the restriction's small and large tiles
# (coarse points x, y), the grid's blocks from which it takes the large
# one, and its threads; "prolong_sweep"'s tile (fine points x, z at most)
# and threads.  Defaults (csrc/stencil.cu): rs small (2, 4), large (4,
# 8), from 264 blocks, 256 threads; ps (2, 32, 128).  Each build varies
# both at once: a column is read per kernel.
def transfer_flags(rs=None, ps=None):
    flags = []
    for pre, names, v in (("RS", ("SMALL_TX", "SMALL_TY", "LARGE_TX",
                                  "LARGE_TY", "LARGE_BLOCKS", "THREADS"),
                           rs),
                          ("PS", ("TX", "TZ", "THREADS"), ps)):
        if v is not None:
            flags += [f"-DPST_{pre}_{n}={x}" for n, x in zip(names, v)]
    return tuple(flags)


TRANSFER_VARIANTS = {
    "default": transfer_flags(),
    "small": transfer_flags((2, 4, 4, 8, 1 << 30, 256), (1, 32, 128)),
    "large": transfer_flags((2, 4, 4, 8, 0, 256), (2, 32, 64)),
    "t3": transfer_flags((2, 4, 4, 4, 264, 256), (4, 32, 256)),
    "t4": transfer_flags((2, 4, 4, 8, 264, 128), (2, 16, 128)),
    "t5": transfer_flags((1, 4, 4, 8, 264, 256), (2, 32, 256)),
}
# (mask lanes, fine grid) of the paths' restrictions: the step04 app's
# two levels, the megatet's three, step02's 8 lanes, the sweep's 25
# lanes and the array's 64 at their fine levels (one coarse mask); the
# levels of level_apply "prolong_sweep" (those with their own stencils);
# the body-factored levels of prolong_add (the sweep's three at 25 lanes,
# the array's at 64 and 8, step04's linear two at 15)
RESTRICTS = [(1, (55, 31, 19)), (1, (28, 16, 10)), (1, (112, 68, 41)),
             (1, (57, 35, 21)), (1, (29, 18, 11)), (8, (8, 67, 29, 8)),
             (1, (25, 89, 41, 19)), (1, (64, 71, 71, 24))]
PROLONG_SWEEPS = [(1, g) for g in LEVELS[:5]] + [(8, LEVELS[5])]
PROLONG_ADDS = [(25, 89, 41, 19), (25, 45, 21, 10), (25, 23, 11, 6),
                (64, 71, 71, 24), (64, 36, 36, 13), (8, 71, 71, 24),
                (15, 55, 31, 19), (15, 28, 16, 10)]


def time_transfers(gpu, against=None):
    """restrict_cuda, prolong_add_cuda and level_apply_cuda
    "prolong_sweep" at each of TRANSFER_VARIANTS on RESTRICTS,
    PROLONG_ADDS and PROLONG_SWEEPS, f32 and f64, cold / warm, each build
    held torch.equal to the route; beside "prolong_sweep", prolong_add
    then "sweep" of the default build.  against: another tree's
    stencil_kernels (load_tree), its wrapper of the same function timed
    in turns with this tree's default build on the same inputs (other,
    this, this, other; the medians of each tree's two), as "other"."""
    from pelvistim_fem_tpu_torch.ops.kernels import measure
    from pelvistim_fem_tpu_torch.ops.kernels import stencil_kernels as sk
    for v, fl in TRANSFER_VARIANTS.items():
        for k, u in sorted(sk.ptxas_usage(fl).items()):
            if k.startswith(("restrict", "level_prolong_sweep",
                             "prolong_add")):
                print(f"  {v:8s} {k:36s} {u['registers']:4d} regs "
                      f"{u['spill_bytes']:5d} B spilled")
    print(f"transfers' device ms cold / warm by build "
          f"{list(TRANSFER_VARIANTS)}"
          + (" (the other tree's as \"other\", in turns with \"default\")"
             if against is not None else "") + f"; {gpu}")
    rng = np.random.default_rng(4)
    for dn in ("float32", "float64"):
        dtype = getattr(torch, dn)
        jobs = [("restrict_cuda", s) for s in RESTRICTS] + \
            [("prolong_add_cuda", (g,)) for g in PROLONG_ADDS] + \
            [("level_apply_cuda", ("prolong_sweep", FL, g))
             for FL, g in PROLONG_SWEEPS]
        for name, shape in jobs:
            args = measure.kernel_inputs(name, shape, dtype, "cuda", rng)
            route = sk.restrict_plain(*args) if name == "restrict_cuda" \
                else sk.prolong_add_plain(*args) \
                if name == "prolong_add_cuda" \
                else sk.level_apply_plain(*args, spmv=sk.stencil_spmv_cuda)
            copies = {"cold": measure.input_copies(args),
                      "warm": measure.input_copies(args, warm=True)}
            runs = {}
            for v, fl in TRANSFER_VARIANTS.items():
                def kernel(*a, _fl=fl):
                    return sk.launch(name, *a, extra_flags=_fl)
                runs[v] = kernel
            if against is not None:
                runs["other"] = getattr(against, name)
            for v, fn in runs.items():
                if not torch.equal(fn(*args), route):
                    raise AssertionError(f"{v} {name} {shape} {dn}: not "
                                         "the route")
            ms = {}
            for temp, cp in copies.items():
                times = {v: [] for v in runs}
                if against is not None:
                    for v in ("other", "default", "default", "other"):
                        times[v].append(measure.kernel_ms(runs[v], cp))
                for v in runs:
                    if not times[v]:
                        times[v].append(measure.kernel_ms(runs[v], cp))
                ms[temp] = {v: float(np.median(t))
                            for v, t in times.items()}
            cells = [f"{v} {ms['cold'][v]:.4f} / {ms['warm'][v]:.4f}"
                     for v in runs]
            if name == "level_apply_cuda":      # the two launches replaced
                cold = copies["cold"]
                pa = [(c[0], c[5], c[6]) for c in cold]
                sw = [(c[0], c[1], c[2], "sweep", c[4]) for c in cold]
                pa_ms = measure.kernel_ms(sk.prolong_add_cuda, pa)
                sw_ms = measure.kernel_ms(sk.level_apply_cuda, sw)
                cells.append(f"prolong_add {pa_ms:.4f} + sweep {sw_ms:.4f} "
                             f"= {pa_ms + sw_ms:.4f}")
            b_ms = measure.bound(name, shape, dn)[0]
            print(f"  {name} {dn} {shape} bound {b_ms:.6f}: "
                  + "; ".join(cells), flush=True)
            del copies
            torch.cuda.empty_cache()


def tail_flags(threads):
    return (f"-DPST_TAIL_THREADS={threads}",)


def time_tail(gpu):
    """The tail kernel at each of TAIL_THREADS on TAILS: registers and
    spills of each build, then device ms against the bound."""
    from pelvistim_fem_tpu_torch.ops.kernels import measure
    from pelvistim_fem_tpu_torch.ops.kernels import stencil_kernels as sk
    for t in TAIL_THREADS:
        for k, u in sorted(sk.ptxas_usage(tail_flags(t)).items()):
            if k.startswith("vcycle_tail"):
                print(f"  {t:5d} threads {k:28s} {u['registers']:4d} regs "
                      f"{u['spill_bytes']:5d} B spilled")
    print(f"tail kernel device ms by threads a block "
          f"{TAIL_THREADS}, inputs from HBM; {gpu}")
    rng = np.random.default_rng(1)
    for dn, tails in TAILS.items():
        for S, shapes in tails:
            shape = (2, 24, S, shapes)
            args = measure.kernel_inputs("vcycle_tail_cuda", shape,
                                         getattr(torch, dn), "cuda", rng)
            copies = measure.input_copies(args)
            times = []
            for t in TAIL_THREADS:
                def kernel(*a, _fl=tail_flags(t)):
                    return sk.launch("vcycle_tail_cuda", *a, extra_flags=_fl)
                measure.check_vcycle_tail(f"{t} threads {shape}",
                                          kernel(*args), args)
                times.append(measure.kernel_ms(kernel, copies))
            b_ms = measure.bound("vcycle_tail_cuda", shape, dn)[0]
            print("  " + " ".join(f"{ms:8.4f}" for ms in times)
                  + f"  {dn} {S} x {shapes} bound {b_ms:.6f}")
            del copies
            torch.cuda.empty_cache()


# the tail's phase clocks (csrc/stencil.cu, TailClock): a build with
# -DPST_TAIL_CLOCKS; the slots' numbers as the source's
CLOCK_FLAGS = ("-DPST_TAIL_CLOCKS",)
CLK_CG, CLK_UP, CLK_OUT, CLK_CLUSTER, CLK_TOTAL = 29, 36, 52, 53, 63
# the cluster tails of the paths (the level above the tail, then the
# tail): step04's app, the megatet's and step02's 8 lanes in f32, step04's
# in f64; timed at each of CLUSTER_RANKS blocks a cluster where that plan
# fits
CLUSTER_RANKS = (2, 4, 8)
CLUSTER_TAILS = {"float32": [(1, ((28, 16, 10),) + TAILS["float32"][0][1]),
                             (1, ((29, 18, 11),) + TAILS["float32"][1][1]),
                             (8, ((34, 15, 5),) + TAILS["float32"][2][1])],
                 "float64": [(1, ((15, 9, 6),) + TAILS["float32"][0][1][1:])]}
# the tails broken down, f32: step04's app (nonlinear chain) and the
# megatet's, one lane each, step02's 8 lanes; then the cluster tails of
# step04 and the megatet at 8 blocks
CLOCK_TAILS = [("vcycle_tail_cuda", label, (2, 24) + TAILS["float32"][i])
               for i, label in enumerate(("step04", "megatet", "step02"))] + \
    [("cluster_tail_cuda", label, (2, 24) + CLUSTER_TAILS["float32"][i]
      + (8,)) for i, label in enumerate(("step04 cluster",
                                         "megatet cluster"))]


def clk_down(l, k):
    return 1 + 7 * min(l, 3) + k


def clk_up(l, k):
    return CLK_UP + 4 * min(l, 3) + k


def clock_slots(shapes, nu, iters):
    """[(slot, phase, per)] of a tail over levels `shapes` (the top one
    first) as TailClock numbers them; per: how many times the phase runs
    in one launch (the coarse CG's iterations)."""
    n = len(shapes)
    rows = [(0, "staging (planes issued, words, wd, b)", 1)]
    for l in range(n - 1):
        g = shapes[l]
        rows += [(clk_down(l, 0), f"{g} x = wd b", 1),
                 (clk_down(l, 1), f"{g} planes' cp.async wait", 1),
                 (clk_down(l, 2), f"{g} {nu - 1} pre-sweeps", 1),
                 (clk_down(l, 3), f"{g} residual", 1)]
        rows += [(clk_down(l, 4 + a), f"{g} restriction pass {a}", 1)
                 for a in range(3)]
    rows += [(clk_down(n - 1, 1), f"{shapes[-1]} planes' cp.async wait", 1),
             (CLK_CG, "coarse CG start (b, dinv, first r.z sum)", 1),
             (CLK_CG + 1, "coarse CG apply", iters),
             (CLK_CG + 2, "coarse CG p.ap block_sum", iters),
             (CLK_CG + 3, "coarse CG x, r, z updates", iters),
             (CLK_CG + 4, "coarse CG r.z block_sum", iters),
             (CLK_CG + 5, "coarse CG p update and loop barrier", iters),
             (CLK_CG + 6, "coarse CG result", 1)]
    for l in range(n - 2, -1, -1):
        g = shapes[l]
        rows += [(clk_up(l, a), f"{g} prolongation pass {a}", 1)
                 for a in range(3)]
        rows += [(clk_up(l, 3), f"{g} {nu} post-sweeps", 1)]
    rows += [(CLK_OUT, "write x", 1)]
    return rows


def cluster_clock_slots(shapes, nu, iters):
    """clock_slots of a cluster tail over levels `shapes` (its top level A
    first), read on its tail rank: A's phases (each ending at a cluster
    barrier the tail rank waits at), the tail's own phases between."""
    A = shapes[0]
    rows = [(CLK_CLUSTER, f"{A} staging, x = wd b (the tail rank: its "
             "staging); cluster barrier", 1),
            (CLK_CLUSTER + 1, f"{A} {nu - 1} pre-sweeps", 1),
            (CLK_CLUSTER + 2, f"{A} residual", 1),
            (CLK_CLUSTER + 3, f"{A} restriction into the tail rank's b", 1)]
    rows += [r for r in clock_slots(shapes[1:], nu, iters)
             if r[0] not in (0, CLK_OUT)]
    rows += [(CLK_CLUSTER + 4, f"{A} x' = x + P xc (xc by DSMEM)", 1),
             (CLK_CLUSTER + 5, f"{A} {nu} post-sweeps, the last writes x",
              1)]
    return rows


def read_clocks(lib):
    import ctypes
    n = lib.pst_tail_clock_slots()
    out = (ctypes.c_longlong * n)()
    rc = lib.pst_tail_clocks(out, n)
    if rc != 0:
        raise RuntimeError(f"pst_tail_clocks: {lib.pst_error_string(rc)}")
    return list(out)


def time_clocks(gpu, cases=None, reps=7):
    """The phase breakdown of one tail launch (the median over `reps`
    launches, each read after it ends) of the clock build, on SPD inputs
    at each of `cases` ((kernel, label, shape as measure.kernel_inputs
    takes it)), f32, nu 2, 24 coarse iterations: cycles, share of the
    launch, and microseconds at the SM clock nvidia-smi reads right
    after."""
    from pelvistim_fem_tpu_torch.ops.kernels import measure
    from pelvistim_fem_tpu_torch.ops.kernels import stencil_kernels as sk
    lib = sk.build(CLOCK_FLAGS)
    rng = np.random.default_rng(4)
    for name, label, shape in cases or CLOCK_TAILS:
        S, shapes = shape[2], shape[3]
        args = measure.kernel_inputs(name, shape, torch.float32, "cuda",
                                     rng)
        cluster = name == "cluster_tail_cuda"
        check = measure.check_cluster_tail if cluster else \
            measure.check_vcycle_tail

        def kernel(*a, _name=name):
            return sk.launch(_name, *a, extra_flags=CLOCK_FLAGS)
        check(f"clocks {shape}", kernel(*args), args)
        for _ in range(10):
            kernel(*args)
        runs = []
        for _ in range(reps):
            kernel(*args)
            torch.cuda.synchronize()
            runs.append(read_clocks(lib))
        clk = np.median(np.array(runs, dtype=np.float64), axis=0)
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
             "nounits"], capture_output=True, text=True,
            check=True).stdout.split()[0])
        total = clk[CLK_TOTAL]
        print(f"tail clocks {label} {S} x {shapes} f32 (median of {reps} "
              f"launches; SM clock {mhz:.0f} MHz; {gpu}): total "
              f"{total:.0f} cycles, {total / mhz:.2f} us")
        slots = (cluster_clock_slots if cluster else clock_slots)(
            shapes, 2, 24)
        for slot, phase, per in slots:
            c = clk[slot]
            each = f", {c / per:.0f} an iteration" if per > 1 else ""
            print(f"  {phase:44s} {c:9.0f} cycles {100 * c / total:5.1f}% "
                  f"{c / mhz:7.3f} us{each}")
        rest = total - sum(clk[s] for s, _, _ in slots)
        print(f"  {'(unassigned)':44s} {rest:9.0f} cycles")


def time_cluster(gpu):
    """The cluster tail at each of CLUSTER_RANKS blocks a cluster on
    CLUSTER_TAILS (where the plan fits): ptxas's registers and spills of
    the default build, then device ms cold (inputs rotated through HBM)
    and warm beside the work it replaces as one CUDA graph (the five
    level-kernel launches at its top level and the vcycle_tail launch,
    measure.cluster_replaced) and its bound."""
    from pelvistim_fem_tpu_torch.ops.kernels import measure
    from pelvistim_fem_tpu_torch.ops.kernels import stencil_kernels as sk
    for k, u in sorted(sk.ptxas_usage().items()):
        if k.startswith("cluster_tail"):
            print(f"  {k:28s} {u['registers']:4d} regs "
                  f"{u['spill_bytes']:5d} B spilled")
    print(f"cluster tail device ms cold / warm by blocks a cluster "
          f"{CLUSTER_RANKS}, then the replaced launches as one graph cold "
          f"/ warm; {gpu}")
    rng = np.random.default_rng(2)
    for dn, tails in CLUSTER_TAILS.items():
        dt = getattr(torch, dn)
        for S, shapes in tails:
            cells, base = [], None
            for ranks in CLUSTER_RANKS:
                if sk.cluster_plan(shapes, dt, ranks) is None:
                    cells.append("   does not fit  ")
                    continue
                shape = (2, 24, S, shapes, ranks)
                args = measure.kernel_inputs("cluster_tail_cuda", shape, dt,
                                             "cuda", rng)
                y = sk.cluster_tail_cuda(*args)
                measure.check_cluster_tail(f"cluster {shape}", y, args)
                if not torch.equal(y, measure.cluster_route(*args)):
                    raise AssertionError(f"cluster {shape}: not the route")
                copies = measure.input_copies(args)
                warm = measure.input_copies(args, warm=True)
                ms = [measure.kernel_ms(sk.cluster_tail_cuda, c)
                      for c in (copies, warm)]
                cells.append(f"{ms[0]:8.4f} {ms[1]:8.4f}")
                base = (args, copies, warm)
            args, copies, warm = base
            graph = (measure.kernel_ms(measure.cluster_replaced, copies),
                     measure.kernel_ms(measure.cluster_replaced, warm))
            b_ms = measure.bound("cluster_tail_cuda", (2, 24, S, shapes),
                                 dn)[0]
            print("  " + " | ".join(cells) + f" | {graph[0]:8.4f} "
                  f"{graph[1]:8.4f}  {dn} {S} x {shapes} bound {b_ms:.6f}")
            del copies, warm, base
            torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tail", action="store_true",
                    help="only the tail kernel's block sizes and the "
                         "cluster tail's cluster sizes")
    ap.add_argument("--levels", action="store_true",
                    help="only the level kernels' block sizes")
    ap.add_argument("--factored", action="store_true",
                    help="only the body-factored level kernel")
    ap.add_argument("--against", metavar="DIR",
                    help="with --factored or --transfers: a checkout of "
                         "another tree whose kernels are timed in turns "
                         "with these")
    ap.add_argument("--transfers", action="store_true",
                    help="only the restriction and prolong_sweep")
    ap.add_argument("--clocks", action="store_true",
                    help="with --tail: the tail's phase breakdown (a "
                         "-DPST_TAIL_CLOCKS build)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels: no CUDA device")
    from pelvistim_fem_tpu_torch.ops.kernels import stencil_kernels as sk

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(gpu)
    every = not (args.tail or args.levels or args.factored or
                 args.transfers)
    builds = [()]
    if args.tail or every:
        builds += [tail_flags(t) for t in TAIL_THREADS]
    if args.clocks:
        builds.append(CLOCK_FLAGS)
    if args.levels or every:
        builds += [level_flags(t) for t in LEVEL_THREADS]
    if args.transfers or every:
        builds += list(TRANSFER_VARIANTS.values())
    if every:
        builds += list(VARIANTS.values())
    with ThreadPoolExecutor(len(builds)) as pool:
        for f in [pool.submit(sk.build, fl) for fl in set(builds)]:
            f.result()
    if every:
        print_usage(VARIANTS)
        print_table(time_variants(VARIANTS), gpu)
    if args.clocks:
        time_clocks(gpu)
    if args.tail or every:
        time_tail(gpu)
        time_cluster(gpu)
    if args.levels or every:
        time_levels(gpu)
    other = None
    if args.against:
        other = load_tree(args.against)
        other.build()
    if args.factored or every:
        time_factored(gpu, other)
    if args.transfers or every:
        time_transfers(gpu, other)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
