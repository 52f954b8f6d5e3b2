#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, nvcc and
PyTorch built for CUDA.  It drives the port (pelvistim_fem_tpu_torch)
through its main path at the benchmark's full sizes, and imports no JAX:

  1. device     the card's name and power limit; TF32 pinned off
  2. build      nvcc compiles the stencil kernels from the checkout
  3. parity     each CUDA kernel against its plain PyTorch twin, f32 and
                f64, at small shapes and at the main path's shapes;
                kernel and twin times (CUDA events, median of 20); and a
                small sweep solved on the card and on the CPU (twins)
  4. sweep      step04 contact sweep: rim-banded (89, 41, 19) lattice,
                100 log-spaced contact conductivities, certified to a
                1e-8 true f64 residual in chunks of 25 lanes
  5. megatet    one 1,747,398-tet step03 case on (112, 68, 41),
                assembled and solved certified to 1e-8
  6. launches   both kernels carried phases 4-5 (launch counters > 0)

Every phase checks its results and raises on failure; the exit code is
then non-zero and no result line is printed.  The second-to-last line is
a JSON summary of the kernels; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

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
TOL = 1e-8


def log(msg):
    print(msg, flush=True)


def gpu_query(fields):
    """First line of nvidia-smi --query-gpu=<fields> (csv, no header)."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20, warmup=10):
    """Median milliseconds of fn() over `reps` launches, CUDA events,
    after `warmup` untimed launches (the first timings of a process run
    before the card's clocks have risen)."""
    import torch
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


def check_close(name, y, ref, dtype):
    """f32: rtol 2e-5, atol 1e-5 max|ref|; f64: rtol 1e-12, atol 1e-12
    max|ref| (random 27-term sums: the atol covers entries that cancel
    to near zero).  Returns the max abs error."""
    import torch
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


def phase_parity(dev):
    import torch
    from pelvistim_fem_tpu_torch.models.pressure import \
        SWEEP_LANES_PER_CHUNK as LANES_PER_CHUNK
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
    single = [(8, 7, 6), (20, 13, 9), (31, 16, 8), SWEEP_GRID,
              MEGATET_GRID]
    batched = [(3, 5, (8, 7, 6)), (5, 2, (14, 9, 8)),
               (LANES_PER_CHUNK, 5, SWEEP_GRID), (27, 1, MEGATET_GRID)]
    for dtype in (torch.float32, torch.float64):
        dn = str(dtype).split(".")[-1]
        for shape in single:
            x = torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                                device=dev)
            C = torch.as_tensor(rng.standard_normal((27,) + shape),
                                dtype=dtype, device=dev)
            y = sk.stencil_spmv_cuda(x, C)
            ref = sk.stencil_spmv_plain(x, C)
            torch.cuda.synchronize()
            err = check_close(f"stencil_spmv {shape} {dn}", y, ref, dtype)
            line = f"parity stencil_spmv {dn} {shape}: max_abs_err {err:.3e}"
            if shape == MEGATET_GRID:
                ms = cuda_ms(lambda: sk.stencil_spmv_cuda(x, C))
                pms = cuda_ms(lambda: sk.stencil_spmv_plain(x, C))
                line += f" kernel {ms:.4f} ms plain {pms:.4f} ms"
                results[("stencil_spmv_cuda", dn)] = (err, ms, pms)
            log(line)
        for L, B, shape in batched:
            Xs = torch.as_tensor(rng.standard_normal((L,) + shape),
                                 dtype=dtype, device=dev)
            coeff = torch.as_tensor(rng.standard_normal((B, 27) + shape),
                                    dtype=dtype, device=dev)
            sig = torch.as_tensor(rng.random((L, B)), dtype=dtype,
                                  device=dev)
            y = sk.batched_stencil_spmv_cuda(Xs, coeff, sig)
            ref = sk.batched_stencil_spmv_plain(Xs, coeff, sig)
            torch.cuda.synchronize()
            err = check_close(f"batched_stencil_spmv L={L} B={B} {shape} "
                              f"{dn}", y, ref, dtype)
            line = (f"parity batched_stencil_spmv {dn} L={L} B={B} "
                    f"{shape}: max_abs_err {err:.3e}")
            if shape == SWEEP_GRID:
                ms = cuda_ms(lambda: sk.batched_stencil_spmv_cuda(
                    Xs, coeff, sig))
                pms = cuda_ms(lambda: sk.batched_stencil_spmv_plain(
                    Xs, coeff, sig))
                line += f" kernel {ms:.4f} ms plain {pms:.4f} ms"
                results[("batched_stencil_spmv_cuda", dn)] = (err, ms, pms)
            log(line)
    # one-hot neighbour directions: each offset picks the right neighbour
    shape = (6, 5, 4)
    x = torch.as_tensor(rng.standard_normal(shape), device=dev)
    for o in range(27):
        C = torch.zeros((27,) + shape, dtype=x.dtype, device=dev)
        C[o] = 1.0
        y = sk.stencil_spmv_cuda(x, C)
        if not torch.equal(y, sk.stencil_spmv_plain(x, C)):
            raise AssertionError(f"stencil_spmv offset {o} "
                                 f"{sk.OFFSETS[o]} picks a wrong neighbour")
    log("parity stencil_spmv one-hot offsets: 27/27 exact")
    return results


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
    spec, _, tables = sweep_spec(N_LANES)
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
                solves_per_min=N_LANES * 60.0 / wall)


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
    from pelvistim_fem_tpu_torch.ops.kernels import stencil_kernels as sk
    t0 = time.perf_counter()
    sk.build(verbose=True)
    log(f"build: stencil kernels compiled and loaded in "
        f"{time.perf_counter() - t0:.2f} s")

    # 3. parity
    t0 = time.perf_counter()
    parity = phase_parity(dev)
    phase_small_reference(dev)
    log(f"parity: done in {time.perf_counter() - t0:.1f} s; clocks "
        f"{gpu_query('clocks.sm,clocks.max.sm')}")

    # 4-5. the main path, counted
    sk.reset_launches()
    sweep = phase_sweep(dev, gpu)
    mega = phase_megatet(dev, gpu)
    launches = dict(sk.LAUNCHES)

    # 6. launch counters
    log(f"launches: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the main path")

    src = "pelvistim_fem_tpu_torch/ops/kernels/csrc/stencil.cu"
    replaces = {
        "stencil_spmv_cuda": "pelvistim_fem_tpu/ops/pallas_stencil.py:326",
        "batched_stencil_spmv_cuda":
            "pelvistim_fem_tpu/ops/pallas_stencil.py:410",
    }
    kernels = []
    for name in ("stencil_spmv_cuda", "batched_stencil_spmv_cuda"):
        err, ms, pms = parity[(name, "float32")]
        err64, ms64, pms64 = parity[(name, "float64")]
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=replaces[name],
                            launches=launches[name], max_abs_err=err,
                            ms=ms, plain_ms=pms, max_abs_err_f64=err64,
                            ms_f64=ms64, plain_ms_f64=pms64))
    log(f"total: {time.perf_counter() - t_start:.1f} s; sweep "
        f"{sweep['wall_s']:.4f} s, megatet {mega['wall_s']:.4f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
