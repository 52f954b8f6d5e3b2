#!/usr/bin/env python3
"""The point-wise prolongation kernels of a checkout (prolong_add_kernel,
a thread a fine point, and level_prolong_sweep_kernel with x + P xc
recomputed at every halo point, as csrc/stencil.cu had them before the
separable passes) broken down by variant, on a CUDA card:

    python dev/torch_transfers_step0.py TREE

TREE is a checkout whose csrc/stencil.cu holds those two kernels (e.g. a
parent commit unpacked by `git archive` into _scratch/).  Writes a patched
copy of that source into this tree's _build/step0_transfers/ and builds
it once per variant (-DPST_S0): for prolong_add 1 y = x alone (the stream
floor), 2 that plus the eight xc gathers (slots by formula, plain sums),
3 that plus the slot and weight tables (plain sums), 0 the kernel, 4 the
kernel with clock64() around the tables, the interpolation and the add
and store; for "prolong_sweep" 1 the point's register loads alone, 2 that
plus the staging (cp.async and its wait), 3 that plus x' on the halo, 0
the kernel (the apply), 4 the kernel with clock64() around the loads'
and copies' issue, the wait, x' and the apply.  The clocks are read by
thread 0 of every block and summed over the blocks.  Times each variant
cold and warm (measure.kernel_ms, inputs rotated through >= 150 MB, or
the same inputs) at STEP0_PROLONG_ADD and STEP0_PROLONG_SWEEP in f32 and
f64, holds the kernel and clocks builds torch.equal to the route, and
prints the cycles a block by phase and ptxas's registers.  The variants
copy the kernels as they stand at PROLONG_ADD_SHA256 and
PROLONG_SWEEP_SHA256; the script refuses a source whose kernels differ.
Imports no JAX.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

PROLONG_ADD_SHA256 = \
    "b074bd15b01e360e9107f47ea041d15244e870f7c08656ad2766d76cc239fc62"
PROLONG_SWEEP_SHA256 = \
    "4f12ec6211fdad75b1a986135278c8f5b7e8c43146340a4428a852deaa6ce680"
STEP0 = {"kernel": 0, "first": 1, "second": 2, "third": 3, "clocks": 4}
NAMES = {"prolong_add_cuda": ("stream", "gathers", "tables"),
         "level_apply_cuda": ("loads", "staging", "xprime")}
STEP0_PROLONG_ADD = [(25, 89, 41, 19), (64, 71, 71, 24)]
STEP0_PROLONG_SWEEP = [(112, 68, 41), (55, 31, 19)]

PROLONG_ADD = r"""template <typename T>
__global__ void __launch_bounds__(PST_LEVEL_THREADS)
prolong_add_kernel(const T* __restrict__ x, const T* __restrict__ xc,
                   const int* __restrict__ itab, const T* __restrict__ wtab,
                   T* __restrict__ y, const __grid_constant__ TailMeta m) {
  const bool clk = PST_S0 == 4 && threadIdx.x == 0;
  long long c0 = clk ? clock64() : 0, c1 = 0, c2 = 0;
  const TailLevel F = m.lv[0], Cl = m.lv[1];
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= F.G) return;
  x += blockIdx.y * F.G;
  y += blockIdx.y * F.G;
  xc += blockIdx.y * Cl.G;
  if (PST_S0 == 1) {
    y[q] = x[q];
    return;
  }
  const TailTransfer& tr = m.tr[0];
  int i, j, k;
  ijk(q, F.Y, F.Z, &i, &j, &k);
  const auto at = [&](int cx, int cy, int cz) {
    return xc[(cx * Cl.Y + cy) * Cl.Z + cz];
  };
  if (PST_S0 == 2) {
    const int sx = min(i / 2, Cl.X - 2), sy = min(j / 2, Cl.Y - 2),
              sz = min(k / 2, Cl.Z - 2);
    T acc = x[q];
    for (int d = 0; d < 8; ++d) acc += at(sx + (d >> 2), sy + (d >> 1 & 1),
                                          sz + (d & 1));
    y[q] = acc;
    return;
  }
  const T* w0 = wtab + tr.woff[0];
  const T* w1 = wtab + tr.woff[1];
  const T* w2 = wtab + tr.woff[2];
  const int sx = itab[tr.ioff[0] + i], sy = itab[tr.ioff[1] + j],
            sz = itab[tr.ioff[2] + k];
  const T lx = w0[i], rx = w0[F.X + i], ly = w1[j], ry = w1[F.Y + j],
          lz = w2[k], rz = w2[F.Z + k];
  if (PST_S0 == 3) {
    T acc = x[q] + lx + rx + ly + ry + lz + rz;
    for (int d = 0; d < 8; ++d) acc += at(sx + (d >> 2), sy + (d >> 1 & 1),
                                          sz + (d & 1));
    y[q] = acc;
    return;
  }
  if (clk) {
    const T w = lx + rx + ly + ry + lz + rz + T(sx + sy + sz);
    if (w == T(12345.678)) y[0] = w;
    c1 = clock64();
  }
  const T p = prolong_value(at, sx, sy, sz, lx, rx, ly, ry, lz, rz);
  if (clk) {
    if (p == T(12345.678)) y[0] = p;
    c2 = clock64();
  }
  y[q] = add_rn(x[q], p);
  if (clk) {
    const long long c3 = clock64();
    atomicAdd(&g_s0_clk[0], (unsigned long long)(c1 - c0));
    atomicAdd(&g_s0_clk[1], (unsigned long long)(c2 - c1));
    atomicAdd(&g_s0_clk[2], (unsigned long long)(c3 - c2));
    atomicAdd(&g_s0_clk[4], 1ull);
  }
}
"""

PROLONG_SWEEP = r"""template <typename T>
__global__ void __launch_bounds__(PST_PS_THREADS)
level_prolong_sweep_kernel(const T* __restrict__ x, const T* __restrict__ xc,
                           const T* __restrict__ b, const T* __restrict__ C,
                           const T* __restrict__ wd,
                           const unsigned* __restrict__ words,
                           const int* __restrict__ itab,
                           const T* __restrict__ wtab, T* __restrict__ y,
                           int word_stride, const __grid_constant__ TailMeta m,
                           int ty, int tz) {
  const bool clk = PST_S0 == 4 && threadIdx.x == 0;
  long long k0 = clk ? clock64() : 0, k1 = 0, k2 = 0, k3 = 0;
  extern __shared__ __align__(16) unsigned char s_raw[];
  const TailLevel F = m.lv[0], Cl = m.lv[1];
  const TailTransfer& tr = m.tr[0];
  const int G = F.G, lane = blockIdx.y;
  x += lane * G;
  xc += lane * Cl.G;
  const int nf[3] = {F.X, F.Y, F.Z}, nc[3] = {Cl.X, Cl.Y, Cl.Z};
  const int nty = (F.Y + ty - 1) / ty, ntz = (F.Z + tz - 1) / tz;
  const int t0[3] = {(int)blockIdx.x / (nty * ntz) * PST_PS_TX,
                     (int)blockIdx.x / ntz % nty * ty,
                     (int)blockIdx.x % ntz * tz};
  const int tn[3] = {min(PST_PS_TX, F.X - t0[0]), min(ty, F.Y - t0[1]),
                     min(tz, F.Z - t0[2])};
  const int tid = threadIdx.x;
  const bool mine = tid < tn[0] * tn[1] * tn[2];
  const PsSmem sm(ty, tz);
  const int H1 = sm.h[1], H2 = sm.h[2];
  int q = 0, s = 0;
  unsigned nb = 0;
  T bq = T(0), wq = T(0), cr[27];
  if (mine) {
    const int a = tid / (tn[1] * tn[2]), c = tid / tn[2] % tn[1],
              d = tid % tn[2];
    q = ((t0[0] + a) * F.Y + t0[1] + c) * F.Z + t0[2] + d;
    s = ((a + 1) * H1 + c + 1) * H2 + d + 1;
    nb = words[lane * word_stride + q];
    bq = b[lane * G + q];
    wq = wd[lane * G + q];
#pragma unroll
    for (int o = 0; o < 27; ++o) cr[o] = C[(27 * lane + o) * G + q];
  }
  const auto sink = [&](T v) {
    T acc = v + bq + wq + T(nb & 1u);
#pragma unroll
    for (int o = 0; o < 27; ++o) acc += cr[o];
    y[lane * G + q] = acc;
  };
  if (PST_S0 == 1) {
    if (mine) sink(T(0));
    return;
  }
  int h0[3], hn[3], c0[3], cn[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    h0[a] = max(t0[a] - 1, 0);
    hn[a] = min(t0[a] + tn[a], nf[a] - 1) - h0[a] + 1;
    c0[a] = min(h0[a] / 2, nc[a] - 2);
    cn[a] = min((h0[a] + hn[a] - 1) / 2, nc[a] - 2) + 2 - c0[a];
  }
  T* xs = reinterpret_cast<T*>(s_raw);
  T* xcs = xs + sm.h[0] * H1 * H2;
  T* wl = xcs + sm.c[0] * sm.c[1] * sm.c[2];
  T* wr = wl + sm.h[0] + H1 + H2;
  int* sl = reinterpret_cast<int*>(wr + sm.h[0] + H1 + H2);
  const int ho[3] = {0, sm.h[0], sm.h[0] + H1};
  const int nt = blockDim.x;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    for (int e = tid; e < hn[a]; e += nt) {
      const int f = h0[a] + e;
      cp_async_elem(sl + ho[a] + e, itab + tr.ioff[a] + f);
      cp_async_elem(wl + ho[a] + e, wtab + tr.woff[a] + f);
      cp_async_elem(wr + ho[a] + e, wtab + tr.woff[a] + nf[a] + f);
    }
  }
  const int hp = hn[1] * hn[2], cp = cn[1] * cn[2];
  const FastDiv by_hp(hp), by_hz(hn[2]), by_cp(cp), by_cz(cn[2]);
  const int ho0 = ((h0[0] - t0[0] + 1) * H1 + h0[1] - t0[1] + 1) * H2 +
                  h0[2] - t0[2] + 1;
  const auto halo = [&](int e, int* i, int* j, int* k) {
    *i = by_hp.div(e);
    const int jk = e - *i * hp;
    *j = by_hz.div(jk);
    *k = jk - *j * hn[2];
  };
  for (int e = tid; e < hn[0] * hp; e += nt) {
    int i, j, k;
    halo(e, &i, &j, &k);
    cp_async_elem(xs + ho0 + (i * H1 + j) * H2 + k,
                  x + ((h0[0] + i) * F.Y + h0[1] + j) * F.Z + h0[2] + k);
  }
  for (int e = tid; e < cn[0] * cp; e += nt) {
    const int i = by_cp.div(e), jk = e - i * cp;
    const int j = by_cz.div(jk), k = jk - j * cn[2];
    cp_async_elem(xcs + e,
                  xc + ((c0[0] + i) * Cl.Y + c0[1] + j) * Cl.Z + c0[2] + k);
  }
  if (clk) k1 = clock64();
  cp_async_wait_block();
  if (clk) k2 = clock64();
  if (PST_S0 == 2) {
    if (mine) sink(xs[s] + xcs[0] + wl[0] + T(sl[0]));
    return;
  }
  for (int e = tid; e < hn[0] * hp; e += nt) {
    int i, j, k;
    halo(e, &i, &j, &k);
    const int ix = ho[0] + i, iy = ho[1] + j, iz = ho[2] + k;
    const T p = prolong_value(
        [&](int cx, int cy, int cz) {
          return xcs[(cx * cn[1] + cy) * cn[2] + cz];
        },
        sl[ix] - c0[0], sl[iy] - c0[1], sl[iz] - c0[2], wl[ix], wr[ix],
        wl[iy], wr[iy], wl[iz], wr[iz]);
    T* at = xs + ho0 + (i * H1 + j) * H2 + k;
    *at = add_rn(*at, p);
  }
  __syncthreads();
  if (clk) k3 = clock64();
  if (PST_S0 == 3) {
    if (mine) sink(xs[s]);
    return;
  }
  if (!mine) return;
  const T xq = xs[s];
  T ax = xq;
  if (nb & kCgFree) {
    ax = T(0);
#pragma unroll
    for (int o = 0; o < 27; ++o) {
      const T pv = (nb >> o & 1u)
                       ? xs[s + ((o / 9 - 1) * H1 + o / 3 % 3 - 1) * H2 +
                            o % 3 - 1]
                       : T(0);
      ax = fma(cr[o], pv, ax);
    }
  }
  y[lane * G + q] = add_rn(xq, mul_rn(wq, sub_rn(bq, ax)));
  if (clk) {
    const long long k4 = clock64();
    atomicAdd(&g_s0_clk[0], (unsigned long long)(k1 - k0));
    atomicAdd(&g_s0_clk[1], (unsigned long long)(k2 - k1));
    atomicAdd(&g_s0_clk[2], (unsigned long long)(k3 - k2));
    atomicAdd(&g_s0_clk[3], (unsigned long long)(k4 - k3));
    atomicAdd(&g_s0_clk[4], 1ull);
  }
}
"""

HEADS = {"prolong_add": ("template <typename T>\n__global__ void "
                         "__launch_bounds__(PST_LEVEL_THREADS)\n"
                         "prolong_add_kernel(", PROLONG_ADD_SHA256,
                         PROLONG_ADD),
         "prolong_sweep": ("template <typename T>\n__global__ void "
                           "__launch_bounds__(PST_PS_THREADS)\n"
                           "level_prolong_sweep_kernel(",
                           PROLONG_SWEEP_SHA256, PROLONG_SWEEP)}
PHASES = {"prolong_add_cuda": ("tables", "interpolation", "x, add, store"),
          "level_apply_cuda": ("issue", "wait", "x'", "apply")}


def step0_source(tree):
    """TREE's csrc/stencil.cu with the step-0 variants of its two
    point-wise prolongation kernels."""
    src = (Path(tree) / "pelvistim_fem_tpu_torch/ops/kernels/csrc/"
           "stencil.cu").read_text()
    for name, (head, sha, body) in HEADS.items():
        at = src.index(head)
        end = src.index("\n}\n", at) + 3
        if hashlib.sha256(src[at:end].encode()).hexdigest() != sha:
            raise SystemExit(f"{tree}: its {name} kernel is not the one "
                             "these variants copy")
        src = src[:at] + body + src[end:]
    anchor = "// y = x + P xc at fine point q of lane blockIdx.y"
    return src.replace(anchor, "#ifndef PST_S0\n#define PST_S0 0\n#endif\n"
                       "__device__ unsigned long long g_s0_clk[8];\n\n"
                       + anchor, 1) + """
extern "C" int pst_s0_clocks(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[8] = {0};
    return (int)cudaMemcpyToSymbol(g_s0_clk, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, g_s0_clk, sizeof(g_s0_clk));
}
"""


def time_step0(tree, gpu):
    from pelvistim_fem_tpu_torch.ops.kernels import measure
    from pelvistim_fem_tpu_torch.ops.kernels import stencil_kernels as sk
    out = sk.BUILD_DIR / "step0_transfers"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "stencil_step0.cu"
    src.write_text(step0_source(tree))
    ptr, i = ctypes.c_void_p, ctypes.c_int

    def build_one(v):
        lib = out / f"libstep0_{v}.so"
        proc = subprocess.run([sk._nvcc(), *sk.NVCC_FLAGS, f"-DPST_S0={v}",
                               "-o", str(lib), str(src)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"step 0 build {v}: {proc.stderr[-4000:]}")
        so = ctypes.CDLL(str(lib))
        for dt in ("f32", "f64"):
            fn = getattr(so, f"pst_prolong_add_{dt}")
            fn.argtypes = [ptr] * 6 + [i, ptr]
            fn.restype = i
            fn = getattr(so, f"pst_level_prolong_sweep_{dt}")
            fn.argtypes = [ptr] * 10 + [i, i, ptr]
            fn.restype = i
        so.pst_s0_clocks.argtypes = [ptr, i]
        return so, sk.parse_ptxas(proc.stderr)

    with ThreadPoolExecutor(len(STEP0)) as pool:
        built = dict(zip(STEP0, pool.map(build_one, STEP0.values())))
    for v, (_, usage) in built.items():
        for k, u in sorted(usage.items()):
            if k.startswith(("prolong_add", "level_prolong_sweep")):
                print(f"  step 0 {v:8s} {k:40s} {u['registers']:4d} regs "
                      f"{u['spill_bytes']:4d} B spilled")

    def dims_of(name, *args):
        # the kernels' interface as TREE has it: prolong_add takes the slot
        # table too
        if name != "prolong_add_cuda":
            return sk._DIMS[name](*args)
        x, xc, tt = args
        S, Ip, Wp, layout = sk._transfer_args(name, x, tt, tt.shape[0])
        return ((x, xc, Ip, Wp), (ctypes.addressof(layout), S),
                f"pst_prolong_add_{sk._SUFFIX[x.dtype]}")

    def runner(lib, name):
        def run(*args):
            tensors, dims, entry, *_ = dims_of(name, *args)
            yv = torch.empty_like(tensors[0])
            rc = getattr(lib, entry)(*(t.data_ptr() for t in tensors),
                                     yv.data_ptr(), *dims,
                                     torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"step 0 launch {entry}: {rc}")
            return yv
        return run

    print(f"step 0: the point-wise prolongation of {tree}, device ms cold / "
          f"warm by variant; {gpu}")
    rng = np.random.default_rng(0)
    jobs = [("prolong_add_cuda", (g,)) for g in STEP0_PROLONG_ADD] + \
        [("level_apply_cuda", ("prolong_sweep", 1, g))
         for g in STEP0_PROLONG_SWEEP]
    for name, shape in jobs:
        for dn in ("float32", "float64"):
            dtype = getattr(torch, dn)
            args = measure.kernel_inputs(name, shape, dtype, "cuda", rng)
            route = sk.prolong_add_plain(*args) if name == \
                "prolong_add_cuda" else sk.level_apply_plain(
                    *args, spmv=sk.stencil_spmv_cuda)
            cold = measure.input_copies(args)
            warm = measure.input_copies(args, warm=True)
            cells = []
            for v, (lib, _) in built.items():
                run = runner(lib, name)
                if v in ("kernel", "clocks") and \
                        not torch.equal(run(*args), route):
                    raise AssertionError(f"step 0 {v} {name} {shape} {dn}: "
                                         "not the route")
                label = NAMES[name][STEP0[v] - 1] if 1 <= STEP0[v] <= 3 \
                    else v
                cells.append(f"{label} {measure.kernel_ms(run, cold):.4f} / "
                             f"{measure.kernel_ms(run, warm):.4f}")
            b_ms = measure.bound(name, shape, dn)[0]
            print(f"  {name} {dn} {shape} bound {b_ms:.4f}: "
                  + "; ".join(cells), flush=True)
            clk = built["clocks"][0]
            buf = (ctypes.c_ulonglong * 8)()
            clk.pst_s0_clocks(buf, 1)
            runner(clk, name)(*args)
            torch.cuda.synchronize()
            clk.pst_s0_clocks(buf, 0)
            c = list(buf)
            phases = PHASES[name]
            tot, nb = sum(c[:len(phases)]) or 1, max(c[4], 1)
            print(f"    clocks: {c[4]} blocks; cycles a block (thread 0): "
                  + ", ".join(f"{p} {c[k] / nb:.0f} ({100 * c[k] / tot:.1f}%)"
                              for k, p in enumerate(phases)), flush=True)
            del cold, warm
            torch.cuda.empty_cache()


def main():
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(gpu)
    time_step0(sys.argv[1], gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
