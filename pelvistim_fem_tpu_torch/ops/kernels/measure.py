"""Timing, bounds and twin checks of the stencil kernels on a CUDA card
(used by chip_smoke.py and profile_kernels.py).

Kernel device time is read from a CUDA graph of launches replayed between
CUDA events, each launch on one of enough copies of its inputs that its
reads come from HBM, not the H100's 50 MB L2 (`input_copies`,
`kernel_ms`): "cold".  "Warm" times launch every time on the same inputs
(`input_copies(..., warm=True)`), as a solve does at the levels whose
planes stay in L2.  A bound is the least time the card could take for
the same work (`bound`).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from pelvistim_fem_tpu_torch.ops.kernels.stencil_kernels import (
    DIAG_OFFSET, ClusterTail, FactoredLevelOp, LevelOp, TransferTables,
    VcycleTail, coarse_cg_plain, make_cluster_tail, make_vcycle_tail,
    vcycle_tail_plain)

# Least time bounds: NVIDIA H100 SXM data sheet, dense, without sparsity
# (at a power limit of 700 W): HBM3 3.35 TB/s; 67 TFLOP/s float32 and 34
# TFLOP/s float64 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
# Timed launches rotate through copies of their inputs that together
# stream at least 3x the H100's 50 MB L2.
ROTATE_BYTES = 150e6


def cuda_ms(fn, reps=20, warmup=10):
    """Median milliseconds of fn() over `reps` launches, CUDA events,
    after `warmup` untimed launches (the first timings of a process run
    before the card's clocks have risen)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def input_copies(args, warm=False):
    """args and clones of its tensors, V-cycle tails and level ops (other
    arguments kept), enough that using them in turn reads at least
    ROTATE_BYTES: between two uses of one copy the others evict it from
    L2, so each launch reads its inputs from HBM, as inside a solve where
    the CG vectors evict the coefficients.  warm: [args] alone, every
    launch on the same inputs (L2 keeps what fits)."""
    if warm:
        return [tuple(args)]
    tensors = [a for a in args if torch.is_tensor(a)]
    for a in args:
        if isinstance(a, ClusterTail):
            tensors += [a.top.C] + list(a.top._wd.values()) + (
                [a.top.words] if a.top.words is not None else [])
            a = a.tail
        if isinstance(a, VcycleTail) and a.packed is not None:
            tensors += list(a.packed[:-1])
        if isinstance(a, LevelOp):
            tensors += [a.C]
        if isinstance(a, FactoredLevelOp):
            tensors += [a.coeff, a.sig]
        if isinstance(a, (LevelOp, FactoredLevelOp)):
            tensors += list(a._wd.values()) + (
                [a.words] if a.words is not None else [])
    nbytes = sum(a.numel() * a.element_size() for a in tensors)
    n = max(2, math.ceil(ROTATE_BYTES / nbytes))
    copy = lambda a: a.clone() if torch.is_tensor(a) or isinstance(
        a, (VcycleTail, ClusterTail, LevelOp, FactoredLevelOp)) else a
    return [tuple(args)] + [tuple(copy(a) for a in args)
                            for _ in range(n - 1)]


def kernel_ms(kernel, copies, launches=20, reps=20, warmup=10):
    """Device milliseconds of one kernel launch: kernel(*copy), the copies
    taken in turn, is captured `launches` times into a CUDA graph, each
    launch with an output of its own, and the graph's replay is timed with
    CUDA events; the median of `reps` replays over `launches`.  A replay
    has no host work between its launches, so unlike events around one
    call this leaves out the Python wrapper's host time, which is longer
    than the shortest kernels."""
    for i in range(warmup):
        kernel(*copies[i % len(copies)])
    torch.cuda.synchronize()
    graph, outs = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph):
        for i in range(launches):
            outs.append(kernel(*copies[i % len(copies)]))
    return cuda_ms(graph.replay, reps=reps, warmup=2) / launches


def _lanes_points(grid):
    """(S, G) of a grid (X, Y, Z), S = 1, or (S, X, Y, Z)."""
    return (grid[0] if len(grid) == 4 else 1), int(np.prod(grid[-3:]))


def work(name, shape, dtype):
    """(bytes, operations) one apply must move and do: each input read
    once, the output written once; multiply-adds as 2.  shape: (X, Y, Z)
    or (S, X, Y, Z) (S lanes, each its own stencil) for stencil_spmv_cuda
    and stencil_spmv_bf16c_cuda (float32 x and y, bf16 coefficients:
    dtype "float32"), (P, xrows, grid) for plane_fma_cuda (P planes, x
    and y: P + 2 values a point, P multiply-adds), (L, B, (X, Y, Z)) for
    the batched kernels, whose per-lane coefficient is a B-term combine
    (2B - 1 operations) before the multiply-add, (iters, grid) for
    coarse_cg_cuda (b, 27 planes, a free byte and x a point; per point
    and iteration 27 multiply-adds of the apply, two dot products and
    the x, r, z and p updates: 54 + 4 + 7 operations; 4 to start),
    (nu, iters, S, shapes) for vcycle_tail_cuda (S lanes, each with the
    levels of grids `shapes`, the top one first: per lane each level's
    27 planes and free byte, b and x of the top level; operations: at each
    level but the coarsest 2 nu applies (a single one, the residual, at nu
    = 0) of 27 multiply-adds a point, their sweeps' 3 operations and the
    first sweep's and the residual's 1, then the coarse CG's; the
    transfers' few operations a point are left out), (nu, iters, S,
    shapes) for cluster_tail_cuda (as vcycle_tail_cuda's over every level,
    the top level's wd and neighbour word, 4 bytes, read in place of its
    free byte), (L, B, shapes) for
    combine_lanes_cuda (L lanes of B bodies over the 27 planes of the
    levels of grids `shapes`, packed: each body's coefficients and sigma
    read once, each lane's stencils written once; 2B - 1 operations an
    element and lane), (mode, FL, grid) for level_apply_cuda (S lanes of
    grid (X, Y, Z) or (S, X, Y, Z): per point and lane the 27 planes and
    the mode's vectors, x b wd y ("sweep"), b wd y ("sweep0"), x b y
    ("residual"), x y ("masked"), and FL neighbour words of 4 bytes a
    point; 54 operations of the apply, 3 of a sweep, 1 more for "sweep0"'s
    wd b and the residual's subtraction; "prolong_sweep": a sweep's and
    prolong_add_cuda's, their x and y counted once), (mode, B, (L, X, Y,
    Z)) for
    level_apply_factored_cuda (L lanes sharing B bodies' coefficients:
    the B * 27 planes once, sigma, per point and lane the mode's vectors
    as level_apply's, one word of 4 bytes a point; operations per point
    and lane as the batched kernels' apply, 27 (2B + 1), and the mode's
    as level_apply's), (FL, grid) for restrict_cuda
    (r, rc, the coarse mask's FL bytes a point, the tables' idx and wt;
    the three axis passes' multiply-adds as restrict_axes does them) and
    (grid,) for prolong_add_cuda (x, xc, y, the tables' s0, wl and wr;
    the axis passes' 3 operations a value and the add); the coarse grid
    and the tables' K are those of multigrid.Transfer on the fine grid."""
    es = 4 if dtype == "float32" else 8
    vecs = {"sweep": 4, "sweep0": 3, "residual": 3, "masked": 2}
    mode_ops = {"sweep": 3, "sweep0": 4, "residual": 1, "masked": 0}
    if name == "level_apply_cuda" and shape[0] == "prolong_sweep":
        S, G = _lanes_points(shape[2])
        sweep = work(name, ("sweep",) + tuple(shape[1:]), dtype)
        pro = work("prolong_add_cuda", (shape[2],), dtype)
        return sweep[0] + pro[0] - 2 * S * G * es, sweep[1] + pro[1]
    if name == "level_apply_cuda":
        mode, FL, grid = shape
        S, G = _lanes_points(grid)
        return (S * G * (27 + vecs[mode]) * es + FL * G * 4,
                S * G * (54 + mode_ops[mode]))
    if name == "level_apply_factored_cuda":
        mode, B, grid = shape
        L, G = _lanes_points(grid)
        return ((L * G * vecs[mode] + B * 27 * G + L * B) * es + G * 4,
                L * G * (27 * (2 * B + 1) + mode_ops[mode]))
    if name in ("restrict_cuda", "prolong_add_cuda"):
        grid = shape[-1]
        S, G = _lanes_points(grid)
        fine = tuple(grid[-3:])
        coarse, K = _coarsening(fine)
        Gc = int(np.prod(coarse))
        passes = [(coarse[0], fine[1], fine[2]), (coarse[0], coarse[1],
                                                  fine[2]), coarse]
        if name == "restrict_cuda":
            tables = sum(c * k for c, k in zip(coarse, K)) * (4 + es)
            ops = sum(int(np.prod(p)) * (2 * k - 1)
                      for p, k in zip(passes, K))
            return S * (G + Gc) * es + shape[0] * Gc + tables, S * ops
        passes = [(fine[0], coarse[1], coarse[2]),
                  (fine[0], fine[1], coarse[2]), fine]
        tables = sum(fine) * (4 + 2 * es)
        return (S * (2 * G + Gc) * es + tables,
                S * (sum(3 * int(np.prod(p)) for p in passes) + G))
    if name == "combine_lanes_cuda":
        L, B, shapes = shape
        N = 27 * sum(int(np.prod(s)) for s in shapes)
        return (B * N + L * B + L * N) * es, L * N * (2 * B - 1)
    if name == "cluster_tail_cuda":
        nbytes, ops = work("vcycle_tail_cuda", shape, dtype)
        S, G = shape[2], int(np.prod(shape[3][0]))
        return nbytes + S * G * (es + 3), ops
    if name == "vcycle_tail_cuda":
        nu, iters, S, shapes = shape
        pts = [int(np.prod(s)) for s in shapes]
        applies = 2 * nu if nu else 1
        ops = sum(G * (54 * applies + 3 * (applies - 1) + 2)
                  for G in pts[:-1]) + pts[-1] * (65 * iters + 4)
        return (S * ((27 * sum(pts) + 2 * pts[0]) * es + sum(pts)),
                S * ops)
    if name == "coarse_cg_cuda":
        iters, grid = shape
        S, G = _lanes_points(grid)
        return S * G * (29 * es + 1), S * G * (65 * iters + 4)
    if name == "stencil_spmv_cuda":
        S, G = _lanes_points(shape)
        return S * 29 * G * es, S * 2 * 27 * G
    if name == "stencil_spmv_bf16c_cuda":
        S, G = _lanes_points(shape)
        return S * (27 * 2 + 2 * 4) * G, S * 2 * 27 * G
    if name == "plane_fma_cuda":
        P, _, grid = shape
        S, G = _lanes_points(grid)
        return (P + 2) * S * G * es, 2 * P * S * G
    L, B, grid = shape
    G = int(np.prod(grid))
    return ((2 * L * G + 27 * B * G + L * B) * es,
            L * G * 27 * (2 * B + 1))


def _coarsening(fine):
    """(coarse grid, K per axis) of multigrid.Transfer on grid `fine` (K
    depends on the knots' order only, not their spacing)."""
    from pelvistim_fem_tpu_torch.ops.multigrid import Transfer
    tr = Transfer([np.arange(n, dtype=float) for n in fine])
    return tr.nc, [int(idx.shape[1]) for idx, _ in tr.tables]


def bound(name, shape, dtype):
    """(bound_ms, bound_by) of one apply (shape as `work` takes it): the
    larger of its bytes over the HBM rate and its operations over the
    peak rate of its dtype."""
    nbytes, flops = work(name, shape, dtype)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_close(name, y, ref, dtype):
    """f32: rtol 2e-5, atol 1e-5 max|ref|; f64: rtol 1e-12, atol 1e-12
    max|ref| (random 27-term sums: the atol covers entries that cancel
    to near zero).  stencil_spmv_bf16c_cuda is held at float32 against
    its twin fed the same bf16 coefficients.  Returns the max abs
    error."""
    scale = float(ref.abs().max())
    rtol, atol = (2e-5, 1e-5 * scale) if dtype == torch.float32 else \
        (1e-12, 1e-12 * scale)
    err = (y - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if not torch.isfinite(y).all() or bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} entries off, max "
                             f"abs err {float(err.max()):.3e} "
                             f"(scale {scale:.3e})")
    return float(err.max())


def check_ulps(name, y, ref, ulps=1):
    """|y - ref| within `ulps` units in the last place (the larger spacing
    of the two values' magnitudes in their dtype) at every entry, and y
    finite; returns the largest difference in units of that spacing."""
    inf = torch.tensor(float("inf"), dtype=y.dtype, device=y.device)
    spacing = torch.maximum(torch.nextafter(y.abs(), inf) - y.abs(),
                            torch.nextafter(ref.abs(), inf) - ref.abs())
    units = (y - ref).abs() / spacing
    worst = float(units.max()) if units.numel() else 0.0
    if not bool(torch.isfinite(y).all()) or not worst <= ulps:
        raise AssertionError(f"{name}: {int((units > ulps).sum())} entries "
                             f"more than {ulps} ulp off, the worst by "
                             f"{worst:.2f}")
    return worst


def spd_stencil(grid, rng):
    """A 27-point stencil C (27, X, Y, Z) (numpy, float64) of a symmetric
    positive definite operator: random positive weights w on the grid's
    edges, C[o] = -w of the edge along offset o (zero where the neighbour
    lies outside the grid), C[13] = the row's weights plus a positive
    mass.  Diagonally dominant, condition ~60."""
    X, Y, Z = grid
    C = np.zeros((27,) + tuple(grid))
    for o in range(14, 27):
        dx, dy, dz = o // 9 - 1, o // 3 % 3 - 1, o % 3 - 1
        w = 0.1 + rng.random(grid)
        lo = (slice(max(0, -dx), X - max(0, dx)),
              slice(max(0, -dy), Y - max(0, dy)),
              slice(max(0, -dz), Z - max(0, dz)))
        hi = tuple(slice(s.start + d, s.stop + d)
                   for s, d in zip(lo, (dx, dy, dz)))
        C[o][lo] = -w[lo]             # row p, column p + offset
        C[26 - o][hi] = -w[lo]        # row p + offset, column p
    C[13] = -C.sum(axis=0) + 0.5 + rng.random(grid)
    return C


def check_against_spread(name, y, twin, inputs):
    """Holds a kernel's y against twin(*inputs), the plain twin on the
    same inputs; returns max|y - twin|.  A fixed CG passes every rounding
    on, amplified by the operator's conditioning, and more so once it has
    converged (on the step04 app's coarsest level kernel and twin differ
    in f64 by 4e7 unit roundoffs of max|x|).  So the bound is the twin's
    own spread on these inputs: e = the largest max|twin(inputs') -
    twin(inputs)| over 3 copies of the float tensors `inputs` with each
    entry moved by one unit roundoff of their dtype, up or down at random
    (seeded); then max|y - twin| <= 8 e + atol, atol 2e-5 (f32) or 1e-12
    (f64) times max|twin|."""
    ref = twin(*inputs)
    dtype = inputs[0].dtype
    u = torch.finfo(dtype).eps
    rng = np.random.default_rng(0)
    e = 0.0
    for _ in range(3):
        moved = [a * (1 + u * torch.as_tensor(
            rng.choice([-1.0, 1.0], tuple(a.shape)), dtype=a.dtype,
            device=a.device)) for a in inputs]
        e = max(e, float((twin(*moved) - ref).abs().max()))
    scale = float(ref.abs().max())
    atol = (2e-5 if dtype == torch.float32 else 1e-12) * scale
    err = float((y - ref).abs().max())
    if not bool(torch.isfinite(y).all()) or not err <= 8 * e + atol:
        raise AssertionError(f"{name}: max abs err {err:.3e} against the "
                             f"bound {8 * e + atol:.3e} (twin's spread "
                             f"{e:.3e}, scale {scale:.3e})")
    return err


def check_coarse_cg(name, y, args):
    """coarse_cg_cuda's y against its twin on `args` (b, C, free, iters),
    b and C moved (check_against_spread)."""
    b, C, free, iters = args
    return check_against_spread(
        name, y, lambda b, C: coarse_cg_plain(b, C, free, iters), (b, C))


def check_vcycle_tail(name, y, args):
    """vcycle_tail_cuda's y against its twin on `args` (b, tail, nu,
    omega, coarse_iters), b and every level's stencil moved
    (check_against_spread: the tail ends in the coarse CG)."""
    b, tail, nu, omega, iters = args

    def twin(b, *Cs):
        return vcycle_tail_plain(b, dataclasses.replace(tail, Cs=Cs),
                                 nu, omega, iters)

    return check_against_spread(name, y, twin, (b,) + tuple(tail.Cs))


def check_cluster_tail(name, y, args):
    """cluster_tail_cuda's y against vcycle_tail_plain over the same levels
    (ClusterTail.levels), b and every level's stencil moved
    (check_vcycle_tail)."""
    b, ct, nu, omega, iters = args
    return check_vcycle_tail(name, y, (b, ct.levels(), nu, omega, iters))


def cluster_route(b, ct, nu, omega, iters, route=True):
    """On the card, around vcycle_tail_cuda on the levels below a cluster
    tail's top level, that level's phases as multigrid._level_cycle runs
    them: route=True, kernel 1 and PyTorch's ops (the route the kernel
    repeats bit for bit); False, the level kernels ("sweep0", "residual",
    restrict, "prolong_sweep", "sweep" at nu = 2: the launches the
    cluster tail replaces; cluster_replaced)."""
    from pelvistim_fem_tpu_torch.ops.kernels.stencil_kernels import \
        vcycle_tail_cuda
    from pelvistim_fem_tpu_torch.ops.multigrid import _level_cycle
    return _level_cycle(
        ct.top, ct.tt, ct.tail.frees[0], b,
        lambda rc: vcycle_tail_cuda(rc, ct.tail, nu, omega, iters), nu=nu,
        omega=omega, route=route)


def cluster_replaced(b, ct, nu, omega, iters):
    return cluster_route(b, ct, nu, omega, iters, route=False)


def as_cluster(whole, ranks=None):
    """The ClusterTail of the levels of a VcycleTail `whole`
    (make_cluster_tail): its top level as a LevelOp, its first transfer's
    kernel tables (multigrid.Transfer.kernel_tables' re-pointed padding)
    and the VcycleTail of the levels below."""
    from pelvistim_fem_tpu_torch.ops.multigrid import _kernel_restrict_idx
    pro, res = whole.pro[0], whole.res[0]
    kidx = tuple(torch.as_tensor(_kernel_restrict_idx(
        p[0].cpu().numpy(), r[0].cpu().numpy()), device=r[0].device)
        for p, r in zip(pro, res))
    top = LevelOp(whole.Cs[0], whole.frees[0])
    rest = make_vcycle_tail(whole.Cs[1:], whole.frees[1:], whole.pro[1:],
                            whole.res[1:])
    return make_cluster_tail(top, TransferTables(pro, res, kidx), rest,
                             ranks)


def kernel_inputs(name, shape, dtype, device, rng):
    """Random arguments of kernel `name` at `shape` (as `bound` takes it)
    in its layout: bf16 coefficients for stencil_spmv_bf16c_cuda (dtype
    float32 for x), xrows after x and C for plane_fma_cuda; the two
    batched kernels get one problem from one `rng` state, and sigma is
    positive, as solved; coarse_cg_cuda an SPD stencil a lane
    (spd_stencil), a mask free on 85% of the points, one a lane, and b
    on every point (so that the masked-out points' identity rows run
    too); vcycle_tail_cuda tail_inputs; cluster_tail_cuda (shape (nu,
    iters, S, shapes) or (nu, iters, S, shapes, ranks)) tail_inputs' levels
    as a ClusterTail (as_cluster); combine_lanes_cuda coeff (B, 27
    * points) of the levels `shapes` packed, and positive sigma (L, B);
    level_apply_cuda (x, b, a LevelOp of a random stencil and a mask free
    on 85% of the points, FL of them, its words and wd made, mode, 0.7;
    "prolong_sweep" then xc and the tables of multigrid.Transfer on
    unit-spaced knots);
    level_apply_factored_cuda likewise with a FactoredLevelOp of B bodies'
    random coefficients, their centre ones 27 + |N(0, 1)| (the Jacobi
    diagonal of positive sigma then far from 0, as a level's: near 0, wd
    b and the sweeps cancel to values that no f32 tolerance relative to
    max|twin| holds), positive sigma and one such mask;
    restrict_cuda (r, the tables of multigrid.Transfer on unit-spaced
    knots, a coarse mask of FL lanes), prolong_add_cuda (x, xc, those
    tables)."""
    def rand(s):
        return torch.as_tensor(rng.standard_normal(s), dtype=dtype,
                               device=device)
    if name in ("stencil_spmv_cuda", "stencil_spmv_bf16c_cuda"):
        shape = tuple(shape)
        x, C = rand(shape), rand(shape[:-3] + (27,) + shape[-3:])
        if name == "stencil_spmv_bf16c_cuda":
            return x, C.to(torch.bfloat16)
        return x, C
    if name == "plane_fma_cuda":
        P, xrows, grid = shape
        grid = tuple(grid)
        return rand(grid), rand(grid[:-3] + (P,) + grid[-3:]), xrows
    if name == "vcycle_tail_cuda":
        return tail_inputs(shape, dtype, device, rng)
    if name == "cluster_tail_cuda":
        b, whole, nu, omega, iters = tail_inputs(shape[:4], dtype, device,
                                                 rng)
        ct = as_cluster(whole, shape[4] if len(shape) > 4 else None)
        ct.top.wd(omega)
        return b, ct, nu, omega, iters
    if name == "combine_lanes_cuda":
        L, B, shapes = shape
        N = 27 * sum(int(np.prod(s)) for s in shapes)
        return rand((B, N)), torch.as_tensor(rng.random((L, B)), dtype=dtype,
                                             device=device)
    if name == "level_apply_cuda":
        mode, FL, grid = shape
        grid = tuple(grid)
        lv = LevelOp(rand(grid[:-3] + (27,) + grid[-3:]), torch.as_tensor(
            rng.random(((FL,) if len(grid) == 4 else ()) + grid[-3:])
            < 0.85, device=device))
        lv.neighbour_words()
        lv.wd(0.7)
        if mode != "prolong_sweep":
            return rand(grid), rand(grid), lv, mode, 0.7
        x, xc, tt = kernel_inputs("prolong_add_cuda", (grid,), dtype, device,
                                  rng)
        return x, rand(grid), lv, mode, 0.7, xc, tt
    if name == "level_apply_factored_cuda":
        mode, B, grid = shape
        grid = tuple(grid)
        coeff = rand((B, 27) + grid[1:])
        coeff[:, DIAG_OFFSET] = 27 + coeff[:, DIAG_OFFSET].abs()
        lv = FactoredLevelOp(
            coeff,
            torch.as_tensor(rng.random((grid[0], B)), dtype=dtype,
                            device=device),
            torch.as_tensor(rng.random((1,) + grid[1:]) < 0.85,
                            device=device))
        lv.neighbour_words()
        lv.wd(0.7)
        return rand(grid), rand(grid), lv, mode, 0.7
    if name in ("restrict_cuda", "prolong_add_cuda"):
        from pelvistim_fem_tpu_torch.ops.multigrid import Transfer
        grid = tuple(shape[-1])
        tr = Transfer([np.arange(n, dtype=float) for n in grid[-3:]])
        tt = tr.kernel_tables(device, dtype)
        coarse = grid[:-3] + tr.nc
        if name == "prolong_add_cuda":
            return rand(grid), rand(coarse), tt
        free = torch.as_tensor(rng.random(
            ((shape[0],) if len(grid) == 4 else ()) + tr.nc) < 0.85,
            device=device)
        return rand(grid), tt, free
    if name == "coarse_cg_cuda":
        iters, grid = shape
        grid = tuple(grid)
        lanes = grid[:-3]
        C = np.stack([spd_stencil(grid[-3:], rng)
                      for _ in range(int(np.prod(lanes)))])
        free = torch.as_tensor(rng.random(grid) < 0.85, device=device)
        C = torch.as_tensor(C.reshape(lanes + (27,) + grid[-3:]),
                            dtype=dtype, device=device)
        return rand(grid), C, free, iters
    L, B, grid = shape
    grid = tuple(grid)
    Xs, coeff = rand((L,) + grid), rand((B, 27) + grid)
    sig = torch.as_tensor(rng.random((L, B)), dtype=dtype, device=device)
    if name == "batched_stencil_spmv_cuda":
        return Xs, coeff, sig
    return Xs.permute(1, 2, 3, 0).contiguous(), coeff, sig.T.contiguous()


def tail_inputs(shape, dtype, device, rng):
    """(b, tail, nu, 0.7, iters) for vcycle_tail_cuda at shape (nu, iters,
    S, shapes): levels of grids `shapes` (the top one first, each the
    every-other-knot coarsening of the one before, multigrid.Transfer on
    unit-spaced knots), an SPD stencil (spd_stencil) and a mask free on
    85% of the points a level and lane, and b on every point of the top
    level; S = 1 gives 3-D arrays (X, Y, Z), else S lanes."""
    from pelvistim_fem_tpu_torch.ops.multigrid import Transfer
    nu, iters, S, shapes = shape
    shapes = [tuple(s) for s in shapes]
    lead = (S,) if S > 1 else ()
    axes = [np.arange(n, dtype=float) for n in shapes[0]]
    pro, res = [], []
    for fine, coarse in zip(shapes, shapes[1:]):
        tr = Transfer(axes)
        if tr.nc != coarse:
            raise ValueError(f"{fine} coarsens to {tr.nc}, not {coarse}")
        p, r = tr._tensors(torch.device(device), dtype)
        pro.append(p)
        res.append(r)
        axes = tr.coarse_axes
    Cs = [torch.as_tensor(np.stack([spd_stencil(g, rng) for _ in range(S)])
                          .reshape(lead + (27,) + g), dtype=dtype,
                          device=device) for g in shapes]
    frees = [torch.as_tensor(rng.random(lead + g) < 0.85, device=device)
             for g in shapes]
    b = torch.as_tensor(rng.standard_normal(lead + shapes[0]), dtype=dtype,
                        device=device)
    return b, make_vcycle_tail(Cs, frees, pro, res), nu, 0.7, iters
