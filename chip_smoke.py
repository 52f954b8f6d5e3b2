#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, nvcc and
PyTorch built for CUDA.  It drives the port (pelvistim_fem_tpu_torch)
through its paths at the benchmark's full sizes, and imports no JAX:

  1. device     the card's name and power limit; TF32 pinned off
  2. build      nvcc compiles the stencil kernels from the checkout;
                ptxas's registers and spills of the instantiations
  3. parity     each CUDA kernel against its plain PyTorch twin, f32 and
                f64, at small shapes, at the batched kernels' edges (grids
                that end mid-tile, lane counts that fill no lane group,
                1 and 8 bodies) and at the paths' shapes; kernel
                device times (a CUDA graph of 20 launches, replayed
                between CUDA events) and call and twin times (CUDA
                events), medians of 20, each launch on one of enough
                copies of its inputs that every read comes from HBM, not
                the 50 MB L2; the lane-major and lane-minor twins
                against each other through a transpose; and a small
                sweep solved on the card and on the CPU
  4. sweep      step04 contact sweep: rim-banded (89, 41, 19) lattice,
                100 log-spaced contact conductivities, certified to a
                1e-8 true f64 residual in chunks of 25 lanes; then the
                metric rows of all 100 lanes on the 361,920-tet element
                Case (f32, as bench.py extracts) with the flux gate
  5. megatet    one 1,747,398-tet step03 case on (112, 68, 41),
                assembled and solved certified to 1e-8
  6. jacobi     the reference's 15 contact levels on the same f64
                lattice as one Jacobi-PCG sweep, lane-minor (the
                lane-minor kernel) and lane-major (the batched kernel);
                both against each other and, through their metric rows,
                against the certified MG sweep of the same levels
  7. single     the certified single-case Jacobi solve
                (solve_stencil_refined) of the middle contact level
                against that lane of the Jacobi sweep

Launch counters are set to 0 before each of the paths 4-7 and read after
it; each path must have launched its own kernels, and every kernel must
have run.  Every (kernel, dtype, shapes) the paths launched is counted
(`launches_by_shape` in the kernels line), and each that phase 3 did not
hold is then held against its twin on random inputs of those shapes.
Every phase checks its results and raises on failure; the exit code is
then non-zero and no result line is printed.  The second-to-last line
is a JSON summary of the kernels (times, bounds, launches); the last
line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import collections
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# Accuracy and iteration anchors of the algorithm (the reference
# implementation's certified runs of the same two workloads).
SWEEP_ITERS_MAX, SWEEP_ITERS_MEAN = 69, 47.5
MEGATET_ITERS = 50
MEGATET_TETS, MEGATET_GRID = 1_747_398, (112, 68, 41)
SWEEP_NODES, SWEEP_GRID = 66_228, (89, 41, 19)
SWEEP_TETS = 361_920
# The reference's extraction of the same 100-lane sweep (BENCH_r05).
MAX_FLUX_ERR, MAX_FLUX_ERR_CONSISTENT = 0.00564, 1.86e-7
TOL = 1e-8
# The Jacobi sweep: the reference's 15 contact levels, middle one for the
# single-case solve.
JACOBI_LANES, SINGLE_LANE = 15, 7
# Rows carry values rounded to these decimals; two rows agree when they
# are within rtol 1e-5 plus one unit of the last kept decimal (values a
# hair apart can round one unit apart).
ROW_KEYS = {"compliance_V": 3, "contact_impedance_ohm": 1,
            "roi_mean_E": 4, "charge_density_mC_cm2": 6}

SOURCE = "pelvistim_fem_tpu_torch/ops/kernels/csrc/stencil.cu"
PALLAS = "pelvistim_fem_tpu/ops/pallas_stencil.py"
REPLACES = {
    "stencil_spmv_cuda": f"{PALLAS}:326, {PALLAS}:75",
    "batched_stencil_spmv_cuda": f"{PALLAS}:410, {PALLAS}:202",
    "batched_stencil_spmv_lminor_cuda": f"{PALLAS}:128",
}


def log(msg):
    print(msg, flush=True)


def gpu_query(fields):
    """First line of nvidia-smi --query-gpu=<fields> (csv, no header)."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_parity(dev):
    import torch
    from pelvistim_fem_tpu_torch.models.pressure import \
        SWEEP_LANES_PER_CHUNK as LANES_PER_CHUNK
    from pelvistim_fem_tpu_torch.ops.kernels import measure
    from pelvistim_fem_tpu_torch.ops.kernels import stencil_kernels as sk

    rng = np.random.default_rng(0)
    results = {}
    # ~2 s of kernel work first: the card's clocks rise under load, and
    # timings taken before that read slow
    Xs = torch.ones((LANES_PER_CHUNK,) + SWEEP_GRID, device=dev)
    coeff = torch.ones((5, 27) + SWEEP_GRID, device=dev)
    sig = torch.ones((LANES_PER_CHUNK, 5), device=dev)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 2.0:
        for _ in range(50):
            sk.batched_stencil_spmv_cuda(Xs, coeff, sig)
        torch.cuda.synchronize()
    log(f"parity: clocks after warm-up: {gpu_query('clocks.sm,clocks.max.sm')}")

    def rand(shape, dtype):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                               device=dev)

    covered = set()

    def run(name, dn, shape, timed):
        dtype = getattr(torch, dn)
        kernel = getattr(sk, name)
        twin = getattr(sk, name.replace("_cuda", "_plain"))
        args = measure.kernel_inputs(name, shape, dtype, dev, rng)
        covered.add(signature(name, args))
        y = kernel(*args)
        ref = twin(*args)
        torch.cuda.synchronize()
        err = measure.check_close(f"{name} {shape} {dn}", y, ref, dtype)
        line = f"parity {name} {dn} {shape}: max_abs_err {err:.3e}"
        if timed:
            copies = measure.input_copies(args)
            ms = measure.kernel_ms(kernel, copies)
            turn = itertools.cycle(copies)
            call = measure.cuda_ms(lambda: kernel(*next(turn)))
            pms = measure.cuda_ms(lambda: twin(*next(turn)))
            line += (f" kernel {ms:.4f} ms (one call with its wrapper "
                     f"{call:.4f} ms) plain {pms:.4f} ms")
            results[(name, dn)] = (err, ms, pms, shape, call)
        log(line)

    single = [(8, 7, 6), (20, 13, 9), (31, 16, 8), SWEEP_GRID,
              MEGATET_GRID]
    # the batched kernels: tiles cut by the grid's end (G not a multiple
    # of the points per block), lane counts that fill no lane group or
    # block, 1 and 8 bodies, and the paths' shapes
    edges = [(3, 5, (8, 7, 6)), (5, 2, (14, 9, 8)), (1, 8, (9, 7, 5)),
             (33, 1, (9, 7, 5)), (40, 3, (9, 7, 6))]
    batched = edges + [(LANES_PER_CHUNK, 5, SWEEP_GRID),
                       (JACOBI_LANES, 5, SWEEP_GRID), (27, 1, MEGATET_GRID)]
    lminor = edges + [(JACOBI_LANES, 5, SWEEP_GRID), (25, 5, SWEEP_GRID)]
    for dn in ("float32", "float64"):
        for shape in single:
            run("stencil_spmv_cuda", dn, shape, shape == MEGATET_GRID)
        for L, B, shape in batched:
            run("batched_stencil_spmv_cuda", dn, (L, B, shape),
                L == LANES_PER_CHUNK and shape == SWEEP_GRID)
        for L, B, shape in lminor:
            run("batched_stencil_spmv_lminor_cuda", dn, (L, B, shape),
                L == JACOBI_LANES)
    # one-hot neighbour directions: each offset picks the right neighbour
    shape = (6, 5, 4)
    x = rand(shape, torch.float64)
    for o in range(27):
        C = torch.zeros((27,) + shape, dtype=x.dtype, device=dev)
        C[o] = 1.0
        y = sk.stencil_spmv_cuda(x, C)
        if not torch.equal(y, sk.stencil_spmv_plain(x, C)):
            raise AssertionError(f"stencil_spmv offset {o} "
                                 f"{sk.OFFSETS[o]} picks a wrong neighbour")
    log("parity stencil_spmv one-hot offsets: 27/27 exact")
    # the lane-major and lane-minor twins compute one function
    L, B = JACOBI_LANES, 5
    Xs = rand((L,) + SWEEP_GRID, torch.float64)
    coeff = rand((B, 27) + SWEEP_GRID, torch.float64)
    sig = torch.as_tensor(rng.random((L, B)), device=dev)
    major = sk.batched_stencil_spmv_plain(Xs, coeff, sig)
    minor = sk.batched_stencil_spmv_lminor_plain(
        Xs.permute(1, 2, 3, 0).contiguous(), coeff, sig.T.contiguous())
    err = measure.check_close("lane-major vs lane-minor twins",
                      minor.permute(3, 0, 1, 2), major, torch.float64)
    log(f"parity twins lane-major vs lane-minor (transposed) L={L} B={B} "
        f"{SWEEP_GRID} float64: max_abs_err {err:.3e}")
    return results, covered


def signature(name, args):
    """(kernel, dtype, input shapes) of one launch."""
    return (name, str(args[0].dtype).split(".")[-1],
            tuple(tuple(a.shape) for a in args))


def shape_key(name, dn, shapes):
    """A launch signature as "<dtype> (L, B, (X, Y, Z))", or "<dtype> (X,
    Y, Z)" for stencil_spmv_cuda (the parity lines' shapes)."""
    if name == "stencil_spmv_cuda":
        return f"{dn} {shapes[0]}"
    L = shapes[0][0] if name == "batched_stencil_spmv_cuda" else \
        shapes[0][3]
    return f"{dn} {(L, shapes[1][0], shapes[1][2:])}"


def record_launches(sk, seen):
    """Wrap the CUDA wrappers of `sk` so that each launch through the
    package counts its signature in the Counter `seen`; returns a function
    that puts the wrappers back."""
    originals = {name: getattr(sk, name) for name in sk.LAUNCHES}
    for name, fn in originals.items():
        def wrapped(*args, _fn=fn, _name=name):
            seen[signature(_name, args)] += 1
            return _fn(*args)
        setattr(sk, name, wrapped)
    return lambda: [setattr(sk, n, f) for n, f in originals.items()]


def phase_path_parity(dev, seen, covered):
    """Each (kernel, dtype, shapes) the paths launched and phase_parity did
    not hold (the MG levels, the assembly's probes, the right-hand sides),
    against its twin on random inputs of those shapes."""
    import torch
    from pelvistim_fem_tpu_torch.ops.kernels import measure
    from pelvistim_fem_tpu_torch.ops.kernels import stencil_kernels as sk
    rng = np.random.default_rng(1)
    todo = sorted(set(seen) - covered)
    for name, dn, shapes in todo:
        dtype = getattr(torch, dn)
        args = [torch.as_tensor(rng.standard_normal(s), dtype=dtype,
                                device=dev) for s in shapes]
        if name != "stencil_spmv_cuda":        # sigma: positive, as solved
            args[2] = args[2].abs()
        twin = getattr(sk, name.replace("_cuda", "_plain"))
        y = getattr(sk, name)(*args)
        err = measure.check_close(f"path {name} {dn} {shapes}", y,
                                  twin(*args), dtype)
        log(f"parity path {name} {dn} {shapes}: max_abs_err {err:.3e}")
    log(f"parity path shapes: the paths launched {len(seen)} (kernel, "
        f"dtype, shapes), {len(todo)} not held in phase 3, all within "
        "tolerance")


def true_residuals(scase, sig_tables, phi, grid_index):
    """Relative f64 residual ||free * (b - K x)|| / ||b_eff|| of each lane
    of phi (L, N), recomputed with the plain PyTorch twin."""
    import torch
    from pelvistim_fem_tpu_torch.ops.kernels.stencil_kernels import \
        batched_stencil_spmv_plain
    B = scase.coeff.shape[0]
    sig = sig_tables[:, 1:1 + B].to(torch.float64)
    coeff = scase.coeff.to(torch.float64)
    L = phi.shape[0]
    shape = scase.grid_shape
    x = torch.zeros((L,) + shape, dtype=torch.float64, device=phi.device)
    x.view(L, -1)[:, grid_index] = phi.to(torch.float64)
    free = scase.free[None]
    x = torch.where(free, x, scase.dirichlet[None].to(torch.float64))
    r = torch.where(free, scase.b_neumann[None] -
                    batched_stencil_spmv_plain(x, coeff, sig), 0.0)
    phi_d = torch.where(scase.free, 0.0, scase.dirichlet).to(torch.float64)
    Kd = batched_stencil_spmv_plain(phi_d.expand((L,) + shape).contiguous(),
                                    coeff, sig)
    b = torch.where(free, scase.b_neumann[None] - Kd,
                    scase.dirichlet[None])
    red = lambda a: torch.sqrt(torch.sum(a * a, dim=(1, 2, 3)))
    return red(r) / red(b)


def phase_small_reference(dev):
    """A coarse 3-lane sweep on the card and on the CPU (plain twins):
    both certified, phi equal to 1e-6 max|phi|."""
    import torch
    from pelvistim_fem_tpu_torch.models.pressure import (build_pressure_spec,
                                                         sigma_tables)
    from pelvistim_fem_tpu_torch.ops.lattice_assembly import assemble_lattice
    from pelvistim_fem_tpu_torch.ops.multigrid import \
        batched_mg_solve_fused_refined_chunked as sweep
    spec, params = build_pressure_spec(coarse=True)
    tabs = sigma_tables(spec, [5e-5, 5e-3, 0.5])
    out = {}
    for d in ("cpu", dev):
        scase, hier = assemble_lattice(spec, torch.float64, device=d)
        r = sweep(scase, hier, torch.as_tensor(tabs, device=d),
                  lanes_per_chunk=2, tol=TOL)
        if not bool(r.converged.all()) or float(r.residual.max()) > TOL:
            raise AssertionError(f"small sweep on {d} not certified: "
                                 f"{r.residual.tolist()}")
        out[d] = r
    pc, pg = out["cpu"].phi, out[dev].phi.cpu()
    err = float((pc - pg).abs().max() / pc.abs().max())
    if err > 1e-6:
        raise AssertionError(f"small sweep: card vs CPU phi rel err {err}")
    log(f"reference coarse sweep {spec.grid_shape}: card vs CPU phi rel err "
        f"{err:.2e}; iterations card {out[dev].iterations.tolist()} cpu "
        f"{out['cpu'].iterations.tolist()}")


def phase_sweep(dev, gpu):
    import torch
    from pelvistim_fem_tpu_torch.models.pressure import (
        SWEEP_LANES as N_LANES, SWEEP_LANES_PER_CHUNK as LANES_PER_CHUNK,
        sweep_spec)
    from pelvistim_fem_tpu_torch.ops.lattice_assembly import assemble_lattice
    from pelvistim_fem_tpu_torch.ops.multigrid import \
        batched_mg_solve_fused_refined_chunked as sweep

    t0 = time.perf_counter()
    spec, params, tables = sweep_spec(N_LANES)
    t_spec = time.perf_counter() - t0
    if spec.grid_shape != SWEEP_GRID or len(spec.grid_index) != SWEEP_NODES:
        raise AssertionError(f"sweep lattice {spec.grid_shape}, "
                             f"{len(spec.grid_index)} nodes")
    t0 = time.perf_counter()
    scase, hier = assemble_lattice(spec, torch.float64, device=dev)
    torch.cuda.synchronize()
    t_asm = time.perf_counter() - t0
    tabs = torch.as_tensor(tables, device=dev)

    def run():
        r = sweep(scase, hier, tabs, lanes_per_chunk=LANES_PER_CHUNK,
                  tol=TOL)
        torch.cuda.synchronize()
        return r

    t0 = time.perf_counter()
    r = run()
    t_cold = time.perf_counter() - t0
    it = r.iterations.cpu().numpy()
    res = r.residual.cpu().numpy()
    if tuple(r.phi.shape) != (N_LANES, SWEEP_NODES) or \
            not bool(torch.isfinite(r.phi).all()):
        raise AssertionError(f"sweep phi shape {tuple(r.phi.shape)} or "
                             "non-finite values")
    n_conv = int(r.converged.sum())
    if n_conv != N_LANES or res.max() > TOL:
        raise AssertionError(f"sweep: {n_conv}/{N_LANES} certified, max "
                             f"true residual {res.max():.3e}")
    check = true_residuals(scase, tabs, r.phi, scase.grid_index).cpu()
    if float(check.max()) > TOL * 1.01 or not np.allclose(
            check.numpy(), res, rtol=1e-3, atol=1e-12):
        raise AssertionError("sweep: recomputed residuals disagree with "
                             f"the reported ones ({float(check.max()):.3e}"
                             f" vs {res.max():.3e})")
    if it.max() > 1.25 * SWEEP_ITERS_MAX or \
            it.mean() > 1.25 * SWEEP_ITERS_MEAN:
        raise AssertionError(f"sweep iterations max {it.max()} mean "
                             f"{it.mean():.1f} exceed 1.25x the anchors")
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    wall = min(walls)
    log(f"sweep: {n_conv}/{N_LANES} lanes certified, max true residual "
        f"{res.max():.3e} (recomputed {float(check.max()):.3e}); "
        f"iterations max {it.max()} mean {it.mean():.2f} (anchors "
        f"{SWEEP_ITERS_MAX} / {SWEEP_ITERS_MEAN})")
    log(f"sweep: grid {spec.grid_shape} nodes {len(spec.grid_index)} "
        f"spec {t_spec:.3f} s assemble {t_asm:.3f} s cold solve "
        f"{t_cold:.3f} s warm best-of-3 {wall:.4f} s "
        f"({N_LANES * 60.0 / wall:.1f} solves/min) on {gpu}")
    return dict(iters_max=int(it.max()), iters_mean=float(it.mean()),
                max_residual=float(res.max()), wall_s=wall,
                solves_per_min=N_LANES * 60.0 / wall, spec=spec,
                params=params, scase=scase, hier=hier, tables=tabs,
                phi=r.phi)


def rows_of(case, phis, params, tables, labels, sigmas):
    from pelvistim_fem_tpu_torch.ops.metrics import extract_results_batched
    import torch
    return extract_results_batched(
        case, phis.to(torch.float32), params,
        sigma_tables=tables.to(torch.float32), pressure_labels=labels,
        sigma_contacts=sigmas)


def phase_sweep_metrics(dev, gpu, sweep):
    """bench.py's end of the sweep leg: the 100 certified phis (cast to
    f32) through the batched metric extraction on the element Case."""
    import torch
    from pelvistim_fem_tpu_torch.models.pressure import build_pressure_case

    params = sweep["params"]
    t0 = time.perf_counter()
    case, _ = build_pressure_case(params, dtype=torch.float32, device=dev)
    t_case = time.perf_counter() - t0
    if case.n_nodes != SWEEP_NODES or case.n_tets != SWEEP_TETS:
        raise AssertionError(f"sweep Case: {case.n_nodes} nodes, "
                             f"{case.n_tets} tets")
    L = sweep["phi"].shape[0]
    labels = [f"s{i:03d}" for i in range(L)]
    sigmas = [float(v) for v in sweep["tables"][:, 4].cpu()]

    def run():
        return rows_of(case, sweep["phi"], params, sweep["tables"], labels,
                       sigmas)

    t0 = time.perf_counter()
    rows = run()
    t_cold = time.perf_counter() - t0
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    wall = min(walls)
    comp = np.array([r["compliance_V"] for r in rows])
    if len(rows) != L or not np.isfinite(comp).all():
        raise AssertionError(f"sweep metrics: {len(rows)} rows, "
                             f"{int(np.isfinite(comp).sum())} finite "
                             "compliance_V")
    max_flux_err = max(r["flux_err"] for r in rows)
    max_flux_err_c = max(r["flux_err_consistent"] for r in rows)
    if not max_flux_err < 0.05:
        raise AssertionError(f"sweep metrics: max_flux_err {max_flux_err}")
    e2e = L * 60.0 / (sweep["wall_s"] + wall)
    log(f"sweep metrics: {len(rows)} rows, compliance_V {comp.max():.3f} "
        f"... {comp.min():.3f} V; max_flux_err {max_flux_err:.6f} (anchor "
        f"{MAX_FLUX_ERR}), max flux_err_consistent {max_flux_err_c:.3e} "
        f"(anchor {MAX_FLUX_ERR_CONSISTENT})")
    log(f"sweep metrics: Case {case.n_nodes} nodes {case.n_tets} tets "
        f"built in {t_case:.3f} s; extraction cold {t_cold:.4f} s, warm "
        f"best-of-3 {wall:.4f} s; solves + extraction {e2e:.1f} per "
        f"minute on {gpu}")
    return dict(case=case, max_flux_err=max_flux_err,
                max_flux_err_consistent=max_flux_err_c, wall_s=wall,
                e2e_per_min=e2e)


def rows_agree(name, got, want):
    """The ROW_KEYS of two row lists agree to rtol 1e-5 plus one unit of
    the row's last decimal; returns the largest relative difference."""
    worst = 0.0
    for key, nd in ROW_KEYS.items():
        a = np.array([r[key] for r in got], float)
        b = np.array([r[key] for r in want], float)
        # 1.001 units: a one-unit step reads a hair over 10**-nd in binary
        bad = np.abs(a - b) > 1e-5 * np.abs(b) + 1.001 * 10.0 ** -nd
        if bad.any() or not np.isfinite(a).all():
            raise AssertionError(f"{name}: {key} differs in lanes "
                                 f"{np.flatnonzero(bad).tolist()}: {a[bad]}"
                                 f" vs {b[bad]}")
        worst = max(worst, float(np.max(np.abs(a - b) / np.abs(b))))
    return worst


def phase_jacobi(dev, gpu, sweep, case):
    """The reference's 15 contact levels as one f64 Jacobi-PCG sweep on
    the full-size lattice, lane-minor and lane-major, held against each
    other and against the certified MG sweep through the metric rows."""
    import torch
    from pelvistim_fem_tpu_torch.models.pressure import (
        SWEEP_LANES_PER_CHUNK as LANES_PER_CHUNK, sigma_tables)
    from pelvistim_fem_tpu_torch.ops.multigrid import \
        batched_mg_solve_fused_refined_chunked as mg_sweep
    from pelvistim_fem_tpu_torch.ops.stencil import \
        batched_stencil_solve_fused as fused

    params, scase = sweep["params"], sweep["scase"]
    levels = params["pressure_sweep"]["sigma_contact_Spm"]
    labels = params["pressure_sweep"]["labels"]
    tabs = torch.as_tensor(sigma_tables(sweep["spec"], levels), device=dev)
    if tabs.shape[0] != JACOBI_LANES:
        raise AssertionError(f"{tabs.shape[0]} contact levels")
    out = {}
    for lane_minor in (True, False):
        route = "lane-minor" if lane_minor else "lane-major"
        walls = []
        for _ in range(2):              # cold, then warm
            t0 = time.perf_counter()
            r = fused(scase, tabs, tol=TOL, maxiter=30_000,
                      lane_minor=lane_minor)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        it = r.iterations.cpu().numpy()
        true = true_residuals(scase, tabs, r.phi, scase.grid_index).cpu()
        n_conv = int(r.converged.sum())
        if n_conv != JACOBI_LANES or float(true.max()) > TOL or \
                not bool(torch.isfinite(r.phi).all()):
            raise AssertionError(f"jacobi {route}: {n_conv}/{JACOBI_LANES}"
                                 f" converged, max true residual "
                                 f"{float(true.max()):.3e}")
        log(f"jacobi {route}: {n_conv}/{JACOBI_LANES} lanes converged, max "
            f"true f64 residual {float(true.max()):.3e} (reported "
            f"{float(r.residual.max()):.3e}); iterations max {it.max()} "
            f"mean {it.mean():.2f}; cold {walls[0]:.4f} s warm "
            f"{walls[1]:.4f} s ({it.max() / walls[1]:.0f} iterations/s) "
            f"on {gpu}")
        out[route] = dict(r=r, iters_max=int(it.max()),
                          iters_mean=float(it.mean()), wall_s=walls[1],
                          max_true_residual=float(true.max()))
    lm, la = out["lane-minor"]["r"], out["lane-major"]["r"]
    d_it = int((lm.iterations - la.iterations).abs().max())
    scale = float(la.phi.abs().max())
    d_phi = float((lm.phi - la.phi).abs().max()) / scale
    if d_it > 2 or d_phi > 1e-7:
        raise AssertionError(f"jacobi routes disagree: iterations by "
                             f"{d_it}, phi by {d_phi:.3e} max|phi|")
    mg = mg_sweep(scase, sweep["hier"], tabs,
                  lanes_per_chunk=LANES_PER_CHUNK, tol=TOL)
    if not bool(mg.converged.all()):
        raise AssertionError("jacobi: the MG sweep of the 15 levels did "
                             "not certify")
    rows_j = rows_of(case, lm.phi, params, tabs, labels, levels)
    rows_m = rows_of(case, mg.phi, params, tabs, labels, levels)
    worst = rows_agree("jacobi vs MG rows", rows_j, rows_m)
    log(f"jacobi: lane-minor vs lane-major iterations within {d_it}, phi "
        f"within {d_phi:.3e} max|phi|; rows vs the MG sweep "
        f"({', '.join(ROW_KEYS)}) within {worst:.3e} relative; "
        f"compliance_V {rows_j[0]['compliance_V']} ... "
        f"{rows_j[-1]['compliance_V']} V")
    out["tables"], out["rows"] = tabs, rows_j
    return out


def phase_single(dev, gpu, sweep, jacobi):
    """solve_stencil_refined (the single-case apply on stencil_spmv_cuda)
    on the middle contact level against that lane of the Jacobi sweep."""
    import torch
    from pelvistim_fem_tpu_torch.ops.stencil import solve_stencil_refined

    scase = sweep["scase"]
    tab = jacobi["tables"][SINGLE_LANE]
    ref = jacobi["lane-minor"]["r"].phi[SINGLE_LANE]
    walls = []
    for _ in range(2):                  # cold, then warm
        t0 = time.perf_counter()
        r = solve_stencil_refined(scase, tab, tol=TOL)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    d_phi = float((r.phi - ref).abs().max() / ref.abs().max())
    if not bool(r.converged) or float(r.residual) > TOL or d_phi > 1e-7:
        raise AssertionError(f"single: true residual "
                             f"{float(r.residual):.3e}, phi off the Jacobi "
                             f"lane by {d_phi:.3e} max|phi|")
    log(f"single: sigma_contact {float(tab[4]):.5f} S/m, certified true "
        f"residual {float(r.residual):.3e}, {int(r.iterations)} f32 "
        f"iterations, phi within {d_phi:.3e} max|phi| of the Jacobi lane; "
        f"cold {walls[0]:.4f} s warm {walls[1]:.4f} s on {gpu}")
    return dict(residual=float(r.residual), iters=int(r.iterations),
                wall_s=walls[1])


def phase_megatet(dev, gpu):
    import torch
    from pelvistim_fem_tpu_torch.models.ankle import megatet_spec
    from pelvistim_fem_tpu_torch.ops.lattice_assembly import (
        solve_lattice_mg_refined, spec_device_arrays)

    t0 = time.perf_counter()
    spec, _ = megatet_spec()
    t_spec = time.perf_counter() - t0
    n_tets = int(np.sum(spec.body6 > 0))
    if n_tets != MEGATET_TETS or spec.grid_shape != MEGATET_GRID:
        raise AssertionError(f"megatet: {n_tets} tets on "
                             f"{spec.grid_shape}")
    dev_arrays = spec_device_arrays(spec, torch.float64, dev)

    def run():
        r = solve_lattice_mg_refined(spec, tol=TOL,
                                     device_arrays=dev_arrays)
        torch.cuda.synchronize()
        return r

    t0 = time.perf_counter()
    r = run()
    t_cold = time.perf_counter() - t0
    its, res = int(r.iterations), float(r.residual)
    if not bool(r.converged) or res > TOL or \
            not bool(torch.isfinite(r.phi).all()) or \
            tuple(r.phi.shape) != (len(spec.grid_index),):
        raise AssertionError(f"megatet not certified: residual {res:.3e}")
    if its > 1.25 * MEGATET_ITERS:
        raise AssertionError(f"megatet iterations {its} exceed 1.25x the "
                             f"anchor {MEGATET_ITERS}")
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    wall = min(walls)
    log(f"megatet: {n_tets} tets on {spec.grid_shape}, certified true "
        f"residual {res:.3e}, iterations {its} (anchor {MEGATET_ITERS})")
    log(f"megatet: spec {t_spec:.3f} s cold assemble+solve {t_cold:.3f} s "
        f"warm best-of-3 assemble+solve {wall:.4f} s on {gpu}")
    return dict(iters=its, residual=res, wall_s=wall)


def main():
    import torch
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "pelvistim_fem_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository (the "
              "pelvistim_fem_tpu_torch package is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = "cuda:0"
    kind = torch.cuda.get_device_name(0)
    gpu = gpu_query("name,power.limit")
    log(f"device: {kind}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    log(gpu)

    # 2. build
    from pelvistim_fem_tpu_torch.ops.kernels import measure
    from pelvistim_fem_tpu_torch.ops.kernels import stencil_kernels as sk
    t0 = time.perf_counter()
    sk.build()
    log(f"build: stencil kernels compiled and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    usage = sk.ptxas_usage()
    for k, u in usage.items():
        if not k.startswith("batched") or k.split(",")[1] in ("1", "5"):
            log(f"ptxas {k}: {u['registers']} registers, "
                f"{u['spill_bytes']} bytes spilled")
    log(f"ptxas: {len(usage)} kernel instantiations, "
        f"{sum(u['spill_bytes'] for u in usage.values())} bytes spilled "
        "in all")

    # 3. parity
    t0 = time.perf_counter()
    parity, covered = phase_parity(dev)
    phase_small_reference(dev)
    log(f"parity: done in {time.perf_counter() - t0:.1f} s; clocks "
        f"{gpu_query('clocks.sm,clocks.max.sm')}")

    # 4-7. the paths, each counted on its own
    launches = dict.fromkeys(sk.LAUNCHES, 0)
    seen = collections.Counter()
    restore = record_launches(sk, seen)

    def path(name, kernels, fn, *args):
        sk.reset_launches()
        out = fn(*args)
        counts = dict(sk.LAUNCHES)
        log(f"launches {name}: {counts}")
        for k in kernels:
            if counts[k] <= 0:
                raise AssertionError(f"{k} never launched on the {name} "
                                     "path")
        for k, n in counts.items():
            launches[k] += n
        return out

    def sweep_leg():                   # bench.py's sweep leg: solve, rows
        s = phase_sweep(dev, gpu)
        return s, phase_sweep_metrics(dev, gpu, s)

    sweep, metrics = path("sweep", ["batched_stencil_spmv_cuda"],
                          sweep_leg)
    mega = path("megatet", ["stencil_spmv_cuda"], phase_megatet, dev, gpu)
    jacobi = path("jacobi", ["batched_stencil_spmv_lminor_cuda",
                             "batched_stencil_spmv_cuda"],
                  phase_jacobi, dev, gpu, sweep, metrics["case"])
    single = path("single", ["stencil_spmv_cuda"], phase_single, dev, gpu,
                  sweep, jacobi)

    restore()
    phase_path_parity(dev, seen, covered)
    log(f"launches: {launches}")
    by_shape = {name: {} for name in launches}
    for (name, dn, shapes), n in seen.most_common():
        by_shape[name][shape_key(name, dn, shapes)] = n
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the paths")
        if sum(by_shape[name].values()) != n:
            raise AssertionError(f"{name}: launches by shape add up to "
                                 f"{sum(by_shape[name].values())}, not {n}")
        log(f"launches by shape {name}: {by_shape[name]}")

    kernels = []
    for name, dn, alt in (("stencil_spmv_cuda", "float32", "float64"),
                          ("batched_stencil_spmv_cuda", "float32",
                           "float64"),
                          ("batched_stencil_spmv_lminor_cuda", "float64",
                           "float32")):
        err, ms, pms, shape, call = parity[(name, dn)]
        b_ms, b_by = measure.bound(name, shape, dn)
        a_err, a_ms, a_pms, _, a_call = parity[(name, alt)]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=launches[name], launches_by_shape=by_shape[name],
            max_abs_err=err, ms=ms, plain_ms=pms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None, dtype=dn,
            shape=str(shape), call_ms=call,
            other_dtype=dict(dtype=alt, max_abs_err=a_err, ms=a_ms,
                             plain_ms=a_pms, call_ms=a_call,
                             bound_ms=measure.bound(name, shape, alt)[0])))
        log(f"{name} {dn} {shape}: {ms:.4f} ms against a bound of "
            f"{b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.1f}% of it")
    log(f"total: {time.perf_counter() - t_start:.1f} s; sweep "
        f"{sweep['wall_s']:.4f} s + extraction {metrics['wall_s']:.4f} s, "
        f"megatet {mega['wall_s']:.4f} s, jacobi lane-minor "
        f"{jacobi['lane-minor']['wall_s']:.4f} s lane-major "
        f"{jacobi['lane-major']['wall_s']:.4f} s, single "
        f"{single['wall_s']:.4f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
