#!/usr/bin/env python3
"""Kernel 2's tiles at the body-factored levels (level_apply_factored_kernel
in pelvistim_fem_tpu_torch/ops/kernels/csrc/stencil.cu) broken down by
variant of their tile loop, on a CUDA card:

    python dev/torch_factored_step0.py

Writes a patched copy of the source into the port's _build/step0/ and
builds it once per variant (-DPST_S0): 1 x loads replaced by a register
value, 2 coefficient reads replaced by a constant, 3 the staging alone
(the tiles' copies and waits, y = 0 stored), 5 staging and epilogue
without the apply, 4 clock64() around wait, stage, apply and epilogue
(thread (0, 0) of every block, summed over the blocks).  Times each
variant cold and warm at STEP0_SHAPES in f32 and f64, holds the unpatched
and the clocks builds to the twin, and prints the clocks build's cycles a
tile by phase and ptxas's registers.  The variants copy the tile loop as
it stands at TILE_LOOP_SHA256; the script refuses a source whose loop has
changed since.  Imports no JAX.
"""

from __future__ import annotations

import hashlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# sha256 of the tile loop that step0_source replaces
TILE_LOOP_SHA256 = \
    "d8b476fbb5b17be29ee271ae63a64b1511a9eb7afed388f46a96067bd9bbb6b0"
STEP0 = {"kernel": 0, "x_in_register": 1, "coefficients_constant": 2,
         "staging_alone": 3, "no_apply": 5, "clocks": 4}
STEP0_SHAPES = [(25, 5, (89, 41, 19)), (64, 3, (71, 71, 24))]


def step0_source():
    """csrc/stencil.cu with the step-0 variants of the tile loop."""
    from pelvistim_fem_tpu_torch.ops.kernels import stencil_kernels as sk
    src = sk._CSRC.read_text()
    head = ("  const int step = gridDim.x;\n  int tile = blockIdx.x;\n"
            "  stage_coeff_tile<T, B, P>(tiles, coeff, G, tile * P);\n")
    at = src.index(head, src.index(
        "level_apply_factored_kernel(const T* __restrict__ x"))
    end = src.index("\n}\n", at) + 3
    if hashlib.sha256(src[at:end].encode()).hexdigest() != TILE_LOOP_SHA256:
        raise SystemExit("the tile loop of level_apply_factored_kernel is not "
                         "the one these variants copy: update them first")
    loop = """  const int step = gridDim.x;
  int tile = blockIdx.x;
  const bool clk = threadIdx.x == 0 && threadIdx.y == 0;
  long long c[4] = {0, 0, 0, 0}, t0 = 0, t1 = 0, n_t = 0;
  stage_coeff_tile<T, B, P>(tiles, coeff, G, tile * P);
  for (int it = 0; tile < ntiles; ++it, tile += step) {
    if (PST_S0 == 4 && clk) t0 = clock64();
    cp_async_wait_block();
    if (PST_S0 == 4 && clk) { t1 = clock64(); c[0] += t1 - t0; t0 = t1; }
    if (tile + step < ntiles) {
      stage_coeff_tile<T, B, P>(
          tiles + ((it + 1) & 1) * kTile, coeff, G, (tile + step) * P);
    }
    if (PST_S0 == 4 && clk) { t1 = clock64(); c[1] += t1 - t0; t0 = t1; }
    const T* s_c = tiles + (it & 1) * kTile + threadIdx.x;
    const int p = tile * P + threadIdx.x;
    if (p >= G || nl <= 0) continue;
    const unsigned nb = words[p];
    const bool f = (nb & kCgFree) != 0u;
    const int q0 = l0 * G + p;
    T acc[K];
#pragma unroll
    for (int l = 0; l < K; ++l) acc[l] = T(0);
    if (PST_S0 == 3) {
#pragma unroll
      for (int l = 0; l < K; ++l) {
        if (l < nl) y[q0 + l * G] = T(0);
      }
      continue;
    }
    if (f && PST_S0 != 5) {
      if (PST_S0 == 1) {
        const T xr = xval(q0);
        factored_apply<T, B, K>(
            s, nl, nb, [s_c](int bb, int o) { return s_c[(bb * 27 + o) * P]; },
            [&](int l, int o) { return xr * T(l * 27 + o + 1); }, acc);
      } else if (PST_S0 == 2) {
        factored_apply<T, B, K>(
            s, nl, nb, [](int bb, int o) { return T(bb * 27 + o + 1); },
            [&](int l, int o) { return xval(q0 + l * G + shift(o, Y, Z)); },
            acc);
      } else {
        factored_apply<T, B, K>(
            s, nl, nb, [s_c](int bb, int o) { return s_c[(bb * 27 + o) * P]; },
            [&](int l, int o) { return xval(q0 + l * G + shift(o, Y, Z)); },
            acc);
      }
    }
    if (PST_S0 == 4 && clk) {
      T sum = T(0);
#pragma unroll
      for (int l = 0; l < K; ++l) sum += acc[l];
      if (sum == T(12345.678)) y[0] = sum;
      t1 = clock64(); c[2] += t1 - t0; t0 = t1;
    }
#pragma unroll
    for (int l = 0; l < K; ++l) {
      if (l < nl) {
        const int q = q0 + l * G;
        const T xq = xval(q);
        y[q] = level_out(mode, xq, f ? acc[l] : xq, b, wd, q);
      }
    }
    if (PST_S0 == 4 && clk) { t1 = clock64(); c[3] += t1 - t0; ++n_t; }
  }
  if (PST_S0 == 4 && clk) {
    for (int i = 0; i < 4; ++i) {
      atomicAdd(&g_s0_clk[i], (unsigned long long)c[i]);
    }
    atomicAdd(&g_s0_clk[4], 1ull);
    atomicAdd(&g_s0_clk[5], (unsigned long long)n_t);
  }
}
"""
    src = src[:at] + loop + src[end:]
    anchor = "template <typename T, bool kFromZero>\nconstexpr int factored_min_blocks()"
    src = src.replace(anchor, "#ifndef PST_S0\n#define PST_S0 0\n#endif\n"
                      "__device__ unsigned long long g_s0_clk[8];\n\n" + anchor)
    src += """
extern "C" int pst_s0_clocks(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[8] = {0};
    return (int)cudaMemcpyToSymbol(g_s0_clk, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, g_s0_clk, sizeof(g_s0_clk));
}
"""
    return src


def time_step0(gpu):
    """Step 0: kernel 2's tiles at STEP0_SHAPES, f32 and f64, every mode
    the tiles have, cold / warm, in each STEP0 variant (the kernel and
    clocks held to the twin), then one launch of the clocks variant
    broken down by phase; ptxas's registers."""
    import ctypes

    from pelvistim_fem_tpu_torch.ops.kernels import measure
    from pelvistim_fem_tpu_torch.ops.kernels import stencil_kernels as sk
    out = sk.BUILD_DIR / "step0"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "stencil_step0.cu"
    src.write_text(step0_source())

    def build_one(v):
        lib = out / f"libstep0_{v}.so"
        proc = subprocess.run([sk._nvcc(), *sk.NVCC_FLAGS, f"-DPST_S0={v}",
                               "-o", str(lib), str(src)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"step 0 build {v}: {proc.stderr[-4000:]}")
        return ctypes.CDLL(str(lib)), sk.parse_ptxas(proc.stderr)

    with ThreadPoolExecutor(len(STEP0)) as pool:
        built = dict(zip(STEP0, pool.map(build_one, STEP0.values())))
    for v, (_, usage) in built.items():
        for k, u in sorted(usage.items()):
            if k.startswith("level_apply_factored") and \
                    k.split(",")[1] in ("3", "5"):
                print(f"  step 0 {v:22s} {k:44s} {u['registers']:4d} regs "
                      f"{u['spill_bytes']:4d} B spilled")
    ptr, i = ctypes.c_void_p, ctypes.c_int

    def tiles(lib):
        for dt in ("f32", "f64"):
            fn = getattr(lib, f"pst_level_apply_factored_{dt}")
            fn.argtypes = [ptr] * 7 + [i] * 9 + [ptr]
            fn.restype = i

        def run(x, b, lv, mode, omega):
            tensors, dims, entry = sk._dims_level_apply_factored(
                x, b, lv, mode, omega)
            y = torch.empty_like(tensors[0])
            rc = getattr(lib, entry)(*(t.data_ptr() for t in tensors),
                                     y.data_ptr(), *dims[:6], 0, 0, 0,
                                     torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"step 0 launch: {rc}")
            return y
        return run

    clk = built["clocks"][0]
    clk.pst_s0_clocks.argtypes = [ptr, i]
    print(f"step 0: kernel 2's tiles, device ms cold / warm by variant; {gpu}")
    rng = np.random.default_rng(0)
    for L, B, grid in STEP0_SHAPES:
        for dn in ("float32", "float64"):
            dtype = getattr(torch, dn)
            for mode in ("sweep", "sweep0", "residual", "masked"):
                shape = (mode, B, (L,) + grid)
                args = measure.kernel_inputs("level_apply_factored_cuda",
                                             shape, dtype, "cuda", rng)
                args = (None if mode == "sweep0" else args[0],
                        None if mode == "masked" else args[1]) + args[2:]
                ref = sk.level_apply_factored_plain(*args)
                cold = measure.input_copies(args)
                warm = measure.input_copies(args, warm=True)
                cells = []
                for v, (lib, _) in built.items():
                    if mode in ("residual", "masked") and \
                            v not in ("kernel", "clocks"):
                        continue
                    run = tiles(lib)
                    if v in ("kernel", "clocks"):
                        measure.check_close(f"step 0 {v} {shape} {dn}",
                                            run(*args), ref, dtype)
                    cells.append(f"{v} {measure.kernel_ms(run, cold):.4f} / "
                                 f"{measure.kernel_ms(run, warm):.4f}")
                b_ms = measure.bound("level_apply_factored_cuda", shape,
                                     dn)[0]
                print(f"  {dn} {mode} L={L} B={B} {grid} bound {b_ms:.4f}: "
                      + "; ".join(cells), flush=True)
                buf = (ctypes.c_ulonglong * 8)()
                clk.pst_s0_clocks(buf, 1)
                tiles(clk)(*args)
                torch.cuda.synchronize()
                clk.pst_s0_clocks(buf, 0)
                c = list(buf)
                tot, nt = sum(c[:4]) or 1, max(c[5], 1)
                print(f"    clocks: {c[4]} blocks, {c[5]} tiles; cycles a "
                      f"tile: wait {c[0] / nt:.0f}, stage {c[1] / nt:.0f}, "
                      f"apply {c[2] / nt:.0f}, epilogue {c[3] / nt:.0f} ("
                      + ", ".join(f"{100 * x / tot:.1f}%" for x in c[:4])
                      + ")", flush=True)
                del cold, warm
                torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(gpu)
    time_step0(gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
