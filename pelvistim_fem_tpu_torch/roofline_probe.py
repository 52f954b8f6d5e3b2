"""Device roofline probe on a CUDA card (the counterpart of
dev/roofline_probe.py).

    python -m pelvistim_fem_tpu_torch.roofline_probe

Measures, warm, device time from CUDA events:

  stream   y = 2x + 1 over 32 Mi float32 (one elementwise PyTorch
           kernel), 50 passes captured in a CUDA graph: the streaming
           ceiling, its GB/s read as r + w
  matmul   A = tanh(A @ A), 4096^3 bf16 (torch.matmul), 20 passes in a
           CUDA graph: the tensor-core ceiling, in TFLOP/s
  probe    the plane-FMA kernel (stencil_kernels.plane_fma_cuda) on the
           megatet grid (112, 68, 41) in float32: P = 1 on one x row (a
           copy: the launch and pipeline floor without coefficient
           traffic), P = 27 on one x row, and P = 27 on x rows i-1, i,
           i+1 (kernel 1's bytes and multiply-adds without its shifts);
           each held against its twin and timed by measure.kernel_ms
           (inputs rotated through HBM), with GB/s of its bytes and
           their share of the H100's 3.35 TB/s

The probe is built at PST_PROBE_THREADS 128, 256 (the default build,
whose launches are counted) and 512 threads a block.  The dev script
varied Pallas block heights of 8, 16 and 56 rows over a lane-packed
(112, 3072) layout instead: those size the TPU's VMEM tiles and have no
CUDA meaning; this probe runs on the natural (X, Y, Z) layout.  Data
come from seed 0.  Needs a CUDA device; main() returns the rows as a
dict.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .device import resolve_device
from .ops.kernels import measure
from .ops.kernels import stencil_kernels as sk

STREAM_N, STREAM_PASSES = 32 * 1024 * 1024, 50
MATMUL_N, MATMUL_PASSES = 4096, 20
GRID = (112, 68, 41)
FORMS = ((1, 1), (27, 1), (27, 3))           # (planes P, x rows)
THREADS = (128, 256, 512)
DEFAULT_THREADS = 256                         # csrc/stencil.cu's default


def _graph_ms(run, passes):
    """Device ms of one of the `passes` passes that run() makes, captured
    in a CUDA graph (median of replays)."""
    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    return measure.cuda_ms(graph.replay, reps=10, warmup=2) / passes


def stream(dev):
    x = torch.arange(STREAM_N, dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    one = torch.ones((), dtype=torch.float32, device=dev)

    def run():
        for _ in range(STREAM_PASSES):
            torch.add(one, x, alpha=2.0, out=y)
    ms = _graph_ms(run, STREAM_PASSES)
    if not torch.equal(y[:4].cpu(), torch.tensor([1.0, 3.0, 5.0, 7.0])):
        raise AssertionError(f"stream: y[:4] = {y[:4].tolist()}")
    gbs = 2 * 4 * STREAM_N / (ms * 1e-3) / 1e9
    return dict(ms=ms, gb_s=gbs, hbm_share=gbs * 1e9 / measure.HBM_BYTES_PER_S)


def matmul(dev):
    """A = tanh(A @ A) as the dev script's loop: two buffers in turn."""
    n = MATMUL_N
    bufs = [torch.ones((n, n), dtype=torch.bfloat16, device=dev),
            torch.empty((n, n), dtype=torch.bfloat16, device=dev)]

    def run():
        for k in range(MATMUL_PASSES):
            src, dst = bufs[k % 2], bufs[(k + 1) % 2]
            torch.matmul(src, src, out=dst)
            dst.tanh_()
    ms = _graph_ms(run, MATMUL_PASSES)
    if not bool(torch.isfinite(bufs[0]).all()):
        raise AssertionError("matmul: non-finite values")
    return dict(ms=ms, tflop_s=2 * n ** 3 / (ms * 1e-3) / 1e12)


def probe_flags(threads):
    """nvcc flags of the build with `threads` threads a probe block."""
    return () if threads == DEFAULT_THREADS else \
        (f"-DPST_PROBE_THREADS={threads}",)


def probe(dev, rng):
    """[row] of the plane-FMA probe: each form at each thread count."""
    with ThreadPoolExecutor(len(THREADS)) as pool:
        for f in [pool.submit(sk.build, probe_flags(t)) for t in THREADS]:
            f.result()
    rows = []
    for P, xrows in FORMS:
        shape = (P, xrows, GRID)
        args = measure.kernel_inputs("plane_fma_cuda", shape, torch.float32,
                                     dev, rng)
        ref = sk.plane_fma_plain(*args)
        copies = measure.input_copies(args)
        nbytes = measure.work("plane_fma_cuda", shape, "float32")[0]
        b_ms, _ = measure.bound("plane_fma_cuda", shape, "float32")
        for threads in THREADS:
            if threads == DEFAULT_THREADS:
                kernel = sk.plane_fma_cuda
            else:
                def kernel(*a, _fl=probe_flags(threads)):
                    return sk.launch("plane_fma_cuda", *a, extra_flags=_fl)
            err = measure.check_close(f"probe P={P} xrows={xrows} "
                                      f"threads={threads}", kernel(*args),
                                      ref, torch.float32)
            ms = measure.kernel_ms(kernel, copies)
            gbs = nbytes / (ms * 1e-3) / 1e9
            rows.append(dict(planes=P, xrows=xrows, threads=threads, ms=ms,
                             gb_s=gbs,
                             hbm_share=gbs * 1e9 / measure.HBM_BYTES_PER_S,
                             bound_ms=b_ms, max_abs_err=err))
        del copies
        torch.cuda.empty_cache()
    return rows


def main():
    dev = resolve_device("cuda")
    out = {"stream": stream(dev)}
    s = out["stream"]
    print(f"stream y = 2x + 1, {STREAM_N} float32: {s['ms']:.4f} ms/pass, "
          f"{s['gb_s']:.0f} GB/s (r+w), {100 * s['hbm_share']:.1f}% of "
          "3.35 TB/s", flush=True)
    out["matmul"] = m = matmul(dev)
    print(f"matmul {MATMUL_N}^3 bf16 + tanh: {m['ms']:.4f} ms, "
          f"{m['tflop_s']:.1f} TFLOP/s", flush=True)
    out["probe"] = probe(dev, np.random.default_rng(0))
    for r in out["probe"]:
        print(f"probe P={r['planes']} xrows={r['xrows']} threads="
              f"{r['threads']}: {r['ms']:.4f} ms/apply, {r['gb_s']:.0f} GB/s "
              f"({100 * r['hbm_share']:.1f}% of 3.35 TB/s), bound "
              f"{r['bound_ms']:.4f} ms ({100 * r['bound_ms'] / r['ms']:.1f}%)",
              flush=True)
    return out


if __name__ == "__main__":
    main()
