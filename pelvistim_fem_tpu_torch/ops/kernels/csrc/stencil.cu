// 27-point stencil SpMV kernels for Hopper (sm_90a), float and double.
//
// Replaces the Pallas TPU kernels of pelvistim_fem_tpu/ops/pallas_stencil.py:
//   stencil_spmv            <- stencil_spmv_flat and stencil_spmv_pallas
//                              (one combined stencil; the two TPU kernels
//                              differ only in their TPU layout and schedule)
//   batched_stencil_spmv    <- batched_stencil_spmv_flat and
//                              batched_stencil_spmv_fused_pallas (lane-major,
//                              body-factored coefficients)
//   batched_stencil_spmv_lminor
//                           <- batched_stencil_spmv_fused_lminor (the same
//                              function as batched_stencil_spmv, lane-minor)
// and the Pallas probes of dev/spmv_kernels_ab.py and dev/roofline_probe.py,
// which no solve runs:
//   stencil_spmv_bf16c      <- spmv_slice with bf16 coefficient planes
//                              (kernel 1 reading bf16 C, f32 x and sums)
//   plane_fma               <- spmv_noop (27 planes, x rows i-1, i, i+1, no
//                              neighbour shifts) and fma (P planes, one x
//                              row; P = 1 is a copy)
// and two kernels that run whole multigrid levels in one launch:
//   coarse_cg               <- the coarse branch of cycle_impl
//                              (pelvistim_fem_tpu/ops/multigrid.py: 24
//                              fixed CG iterations of kernel 1's apply,
//                              which the TPU ran as ~21 XLA ops each)
//   vcycle_tail             <- cycle_impl's recursion from a level t to the
//                              coarsest (multigrid.py:425-460: kernel 1 on
//                              levels below FLAT_MIN_NODES is XLA there,
//                              fused with the smoothing and transfers)
// and the lanes' stencils that tail takes where they share body-factored
// coefficients:
//   combine_lanes           <- the on-the-fly combine sum_b sig[l, b] C_b of
//                              batched_stencil_spmv_flat, made once a solve
//                              for a tail's levels
// and kernel 1's work at the levels above the tail, one launch a phase:
//   level_apply             <- kernel 1 with the damped-Jacobi sweep, the
//                              residual or the mask around it
//   restrict, prolong_add   <- the transfers' per-axis gathers (the levels
//                              that cycle_impl, multigrid.py:425-460, runs
//                              as XLA fusions below FLAT_MIN_NODES); the
//                              prolongation also folded into the first
//                              post-sweep (level_apply "prolong_sweep")
// and kernel 2's work at the body-factored levels above the tail:
//   level_apply_factored    <- kernel 2 with the damped-Jacobi sweep, the
//                              residual or the mask around it (the levels
//                              of _fused_cycle, multigrid.py:797-830, that
//                              XLA fuses around batched_stencil_spmv_fused)
//                              as kernel 2's tiles or as a march along
//                              axis 0 (level_march_kernel), by the
//                              caller's plan
//
// Layout is the natural one of the PyTorch tensors, C-contiguous:
//   x (S, X, Y, Z), C (S, 27, X, Y, Z)   [S lanes; S = 1 is the 3-D call]
//   Xs (L, X, Y, Z), coeff (B, 27, X, Y, Z), sig (L, B)
//   Xm (X, Y, Z, L), coeff (B, 27, X, Y, Z), sig (B, L)   [lane-minor]
//   x (S, X, Y, Z), C (S, P, X, Y, Z)    [plane_fma; bf16c: C in bf16]
//   b (S, X, Y, Z), C (S, 27, X, Y, Z), free (S or 1, X, Y, Z) bytes
//                                        [coarse_cg]
//   b (S, G_t), packed planes (S, 27 * sum G_l), packed free (S or 1,
//   sum G_l), transfer tables                    [vcycle_tail]
//   coeff (B, N), sig (L, B) -> C (L, N)         [combine_lanes]
//   x, b, wd (S, X, Y, Z), C (S, 27, X, Y, Z), neighbour words (S or 1,
//   X, Y, Z); "prolong_sweep" also xc (S, G_c) and one transfer's tables
//                                                [level_apply]
//   x, b, wd (L, X, Y, Z), coeff (B, 27, X, Y, Z), sig (L, B), neighbour
//   words (X, Y, Z)                              [level_apply_factored]
//   r (S, G_f) -> rc (S, G_c), free (S or 1, G_c); x (S, G_f), xc (S, G_c);
//   one transfer's tables as vcycle_tail's       [restrict, prolong_add]
// with offset o = (dx+1)*9 + (dy+1)*3 + (dz+1) and zero outside the grid.
//
// All are bound by device-memory bandwidth: per grid point the single
// kernel reads 27 coefficients and writes one value, doing 27
// multiply-adds, far below the card's ratio of operations to bytes.  In it
// and in the probes one thread computes one grid point; consecutive
// threads take consecutive z, so every coefficient plane and x row is read
// coalesced, and the 27 neighbour reads of a warp hit the same few cache
// lines.
//
// The two batched kernels compute Y[l] = sum_o (sum_b sig[l, b] C_b[o])
// * shift_o(X[l]) over B*27 coefficient planes that all L lanes share; an
// apply must read those planes once, the lanes once and write them once.
// Relying on L1 to serve the lanes' repeated coefficient reads did not
// hold (kernels that did so reached 7-12% of that bound), so both share
// one design:
//   * Tiles.  A tile is P consecutive flattened grid points with all
//     lanes of the call, or one slab of them (blockIdx.y).  Its B*27*P
//     coefficients are copied into shared memory once for all the tile's
//     lanes (stage_coeff_tile: cp.async of one element each, coalesced
//     along p; the planes start at (b*27+o)*G, not 16-byte aligned for
//     odd G, so no 16-byte copies and no TMA), so device memory sees each
//     coefficient once per slab.
//   * Persistent blocks, two tile buffers.  A grid of as many blocks as
//     the card holds at once walks the tiles; each block copies its next
//     tile while it computes the current one, so the coefficient stream
//     from device memory overlaps the arithmetic instead of alternating
//     with it.
//   * Each thread forms sum_b sig[l, b] C_b[o] in registers from its own
//     lanes' sigma, with B a template parameter (no runtime body tests)
//     and all 27 offsets unrolled, the 3 x-neighbours of each (dx, dy) row
//     loaded before their multiply-adds; index arithmetic is 32-bit (the
//     launchers check that L*G and B*27*G fit in an int).
//   * Lane-major: a thread takes one point and K lanes (K chosen from
//     dtype and B), consecutive threads consecutive points: shared-memory
//     reads are conflict-free and every X read and Y write is coalesced;
//     the block launches only the lane groups L needs.
//   * Lane-minor: a thread takes one lane of one point at a time, lanes
//     fastest, so a block's reads Xm[(p+off)*L + l] for one offset are one
//     contiguous run, and the lanes of a point read its coefficients from
//     shared memory as a broadcast.
// The arithmetic is fixed by explicit fma(): co = s_0 C_0, then co =
// fma(s_b, C_b, co) for b = 1..B-1, then acc = fma(co, x, acc) for offsets
// 0..26 in order (the plain twins' order), so no contraction choice of the
// compiler changes a result.  The tile constants below are defaults,
// chosen by timing builds that override them with -D flags of the same
// names at the paths' shapes (profile_kernels.py).
//
// Every entry point returns cudaGetLastError() of its launch (0 = ok),
// launches on the caller's stream and does not synchronise.

#include <algorithm>
#include <atomic>
#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Tile constants of the batched kernels (B2 lane-major, LM lane-minor),
// per dtype: grid points per tile (a multiple of 32 for B2), largest lanes
// per thread, threads per block at most, and blocks per SM that the
// kernel's register use must allow.
#ifndef PST_B2_POINTS_F32
#define PST_B2_POINTS_F32 64
#endif
#ifndef PST_B2_LANES_F32
#define PST_B2_LANES_F32 4
#endif
#ifndef PST_B2_THREADS_F32
#define PST_B2_THREADS_F32 448
#endif
#ifndef PST_B2_MINB_F32
#define PST_B2_MINB_F32 2
#endif
#ifndef PST_B2_POINTS_F64
#define PST_B2_POINTS_F64 32
#endif
#ifndef PST_B2_LANES_F64
#define PST_B2_LANES_F64 2
#endif
#ifndef PST_B2_THREADS_F64
#define PST_B2_THREADS_F64 416
#endif
#ifndef PST_B2_MINB_F64
#define PST_B2_MINB_F64 2
#endif
#ifndef PST_LM_POINTS_F32
#define PST_LM_POINTS_F32 64
#endif
#ifndef PST_LM_LANES_F32
#define PST_LM_LANES_F32 2
#endif
#ifndef PST_LM_THREADS_F32
#define PST_LM_THREADS_F32 512
#endif
#ifndef PST_LM_MINB_F32
#define PST_LM_MINB_F32 2
#endif
#ifndef PST_LM_POINTS_F64
#define PST_LM_POINTS_F64 16
#endif
#ifndef PST_LM_LANES_F64
#define PST_LM_LANES_F64 2
#endif
#ifndef PST_LM_THREADS_F64
#define PST_LM_THREADS_F64 256
#endif
#ifndef PST_LM_MINB_F64
#define PST_LM_MINB_F64 2
#endif
// Threads per block of the plane-FMA probe.  The dev script's Pallas block
// heights (8, 16 and 56 rows of the packed lattice) size VMEM tiles and
// have no CUDA meaning; roofline_probe.py sweeps this instead.
#ifndef PST_PROBE_THREADS
#define PST_PROBE_THREADS 256
#endif

namespace {

constexpr int kBlock = 256;
constexpr int kMaxBodies = 8;  // largest body count the batched kernels take
constexpr int kMaxSmem = 232448;  // shared memory a block may opt in to

template <typename T>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int kB2Points = PST_B2_POINTS_F32;
  static constexpr int kB2Lanes = PST_B2_LANES_F32;
  static constexpr int kB2Threads = PST_B2_THREADS_F32;
  static constexpr int kB2MinBlocks = PST_B2_MINB_F32;
  static constexpr int kLmPoints = PST_LM_POINTS_F32;
  static constexpr int kLmLanes = PST_LM_LANES_F32;
  static constexpr int kLmThreads = PST_LM_THREADS_F32;
  static constexpr int kLmMinBlocks = PST_LM_MINB_F32;
};
template <>
struct Tile<double> {
  static constexpr int kB2Points = PST_B2_POINTS_F64;
  static constexpr int kB2Lanes = PST_B2_LANES_F64;
  static constexpr int kB2Threads = PST_B2_THREADS_F64;
  static constexpr int kB2MinBlocks = PST_B2_MINB_F64;
  static constexpr int kLmPoints = PST_LM_POINTS_F64;
  static constexpr int kLmLanes = PST_LM_LANES_F64;
  static constexpr int kLmThreads = PST_LM_THREADS_F64;
  static constexpr int kLmMinBlocks = PST_LM_MINB_F64;
};

// Lanes per thread of a batched kernel: at most `most`, fewer for many
// bodies, so that a thread's K*B sigma values stay at most 20 registers'
// worth.
template <typename T>
constexpr int lanes_per_thread(int B, int most) {
  const int fit = 20 * 4 / (int)sizeof(T) / B;
  return fit < 1 ? 1 : (fit < most ? fit : most);
}

// A coefficient as the accumulator's type: itself, or a bf16 widened
// exactly to float.
template <typename T>
__device__ __forceinline__ T widen(T c) { return c; }
__device__ __forceinline__ float widen(__nv_bfloat16 c) {
  return __bfloat162float(c);
}

// y[s] = sum_o C[s, o] * shift_o(x[s]) for lane s = blockIdx.y: each lane
// has its own stencil and its own grid; lanes never mix.  The one body of
// kernel 1 and of its bf16-coefficient probe (TC the coefficient type, T
// that of x, y and the sums): acc = fma(C_o, x_o, acc) for o = 0..26 in
// order, the sum apply_point forms on shared memory.
template <typename T, typename TC>
__device__ __forceinline__ void stencil_point(const T* __restrict__ x,
                                              const TC* __restrict__ C,
                                              T* __restrict__ y, int X, int Y,
                                              int Z) {
  const long long G = (long long)X * Y * Z;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= G) return;
  x += blockIdx.y * G;
  C += blockIdx.y * 27 * G;
  y += blockIdx.y * G;
  const int k = (int)(p % Z);
  const long long q = p / Z;
  const int j = (int)(q % Y);
  const int i = (int)(q / Y);

  T acc = T(0);
  int o = 0;
#pragma unroll
  for (int dx = -1; dx <= 1; ++dx) {
    const int ii = i + dx;
    const bool okx = ii >= 0 && ii < X;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
      const int jj = j + dy;
      const bool oky = okx && jj >= 0 && jj < Y;
#pragma unroll
      for (int dz = -1; dz <= 1; ++dz, ++o) {
        const int kk = k + dz;
        T xv = T(0);
        if (oky && kk >= 0 && kk < Z) {
          xv = x[((long long)ii * Y + jj) * Z + kk];
        }
        acc = fma(widen(C[(long long)o * G + p]), xv, acc);
      }
    }
  }
  y[p] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
stencil_spmv_kernel(const T* __restrict__ x, const T* __restrict__ C,
                    T* __restrict__ y, int X, int Y, int Z) {
  stencil_point<T, T>(x, C, y, X, Y, Z);
}

// Kernel 1 with bf16 coefficient planes: half its coefficient bytes, each
// plane widened to float before its multiply-add, f32 sums in kernel 1's
// order.  A probe of what halving the coefficient traffic buys; no solve
// runs it.
__global__ void __launch_bounds__(kBlock)
stencil_spmv_bf16c_kernel(const float* __restrict__ x,
                          const __nv_bfloat16* __restrict__ C,
                          float* __restrict__ y, int X, int Y, int Z) {
  stencil_point<float, __nv_bfloat16>(x, C, y, X, Y, Z);
}

// The plane-FMA probe's 3-row form: y[s, i, j, k] = sum_{p < 27} C[s, p,
// i, j, k] * x[s, i + dx(p), j, k], lane s = blockIdx.y, dx(p) = p / 9 - 1
// (kernel 1's offset order), rows outside 0 <= i < X read 0.  Its result is
// wrong by design (no j, k shifts), its traffic is kernel 1's: the bytes
// and multiply-adds of an apply without the shifts.  Sums in p order from
// 0, by fma.  Bound by device memory: 29 values moved per point for 27
// multiply-adds.
template <typename T>
__global__ void __launch_bounds__(PST_PROBE_THREADS)
plane_fma_kernel(const T* __restrict__ x, const T* __restrict__ C,
                 T* __restrict__ y, int X, int Y, int Z) {
  const long long YZ = (long long)Y * Z;
  const long long G = X * YZ;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= G) return;
  x += blockIdx.y * G;
  C += blockIdx.y * 27 * G;
  y += blockIdx.y * G;
  T acc = T(0);
  const int i = (int)(p / YZ);
  T xv[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const int ii = i + d - 1;
    xv[d] = (ii >= 0 && ii < X) ? x[p + (d - 1) * YZ] : T(0);
  }
#pragma unroll
  for (int o = 0; o < 27; ++o) acc = fma(C[o * G + p], xv[o / 9], acc);
  y[p] = acc;
}

// V consecutive values, aligned to their size: one 16-byte load or store
// for V * sizeof(T) == 16.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T e[V];
};

// The probe's 1-row form: y[s, q] = sum_{p < P} C[s, p, q] * x[s, q] over
// the flattened grid q, lane s = blockIdx.y.  A thread takes V consecutive
// points: V = 16 / sizeof(T) with 16-byte loads and stores where the
// launcher finds G a multiple of V and every plane 16-byte aligned, else 1
// with scalar loads.  P is a template parameter, its planes unrolled, so
// that all of a thread's coefficient loads are in flight at once (P = 0:
// the runtime count nP, unrolled by 4).  32-bit indices: the launcher
// refuses S * P * G past INT_MAX.  Sums in p order from 0, by fma, per
// point as the scalar form.  Bound by device memory: P + 2 values moved
// per point for P multiply-adds.
template <typename T, int P, int V>
__global__ void __launch_bounds__(PST_PROBE_THREADS)
plane_fma_row_kernel(const T* __restrict__ x, const T* __restrict__ C,
                     T* __restrict__ y, int nP, int G) {
  using Pk = Pack<T, V>;
  const int n = G / V;  // packs a plane
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int planes = P > 0 ? P : nP;
  const Pk* xs = reinterpret_cast<const Pk*>(x + blockIdx.y * G);
  const Pk* cs = reinterpret_cast<const Pk*>(C + blockIdx.y * planes * G);
  const Pk xv = xs[i];
  Pk acc;
#pragma unroll
  for (int v = 0; v < V; ++v) acc.e[v] = T(0);
  if constexpr (P > 0) {
#pragma unroll
    for (int o = 0; o < P; ++o) {
      const Pk c = cs[o * n + i];
#pragma unroll
      for (int v = 0; v < V; ++v) acc.e[v] = fma(c.e[v], xv.e[v], acc.e[v]);
    }
  } else {
#pragma unroll 4
    for (int o = 0; o < nP; ++o) {
      const Pk c = cs[o * n + i];
#pragma unroll
      for (int v = 0; v < V; ++v) acc.e[v] = fma(c.e[v], xv.e[v], acc.e[v]);
    }
  }
  reinterpret_cast<Pk*>(y + blockIdx.y * G)[i] = acc;
}

// One element of global memory to shared memory, asynchronously.
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(sizeof(T)));
}

// Waits for this thread's cp.async copies, then for the block.
__device__ __forceinline__ void cp_async_wait_block() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// Starts the copy of one coefficient tile (B*27, P): s[r * P + q] =
// coeff[r * G + p0 + q] for the planes r = b*27 + o and the points q < P
// with p0 + q < G (the rest of the last tile is left unwritten: no thread
// reads it).  Every thread of the block takes part, consecutive threads on
// consecutive points; the copy lands at cp_async_wait_block().
template <typename T, int B, int P>
__device__ __forceinline__ void stage_coeff_tile(T* s,
                                                 const T* __restrict__ coeff,
                                                 int G, int p0) {
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int np = min(P, G - p0);
  const T* src = coeff + p0;
#pragma unroll 4  // more copies in flight spill registers
  for (int t = tid; t < B * 27 * P; t += nthreads) {
    const int q = t % P;
    if (q < np) cp_async_elem(s + t, src + (t / P) * G + q);
  }
}

// Neighbour validity of grid point p = (i, j, k): m[a] for d = a - 1.
struct Nbr {
  bool mx[3], my[3], mz[3];
  __device__ Nbr(int p, int X, int Y, int Z) {
    const int k = p % Z;
    const int q = p / Z;
    const int j = q % Y;
    const int i = q / Y;
    mx[0] = i > 0; mx[1] = true; mx[2] = i < X - 1;
    my[0] = j > 0; my[1] = true; my[2] = j < Y - 1;
    mz[0] = k > 0; mz[1] = true; mz[2] = k < Z - 1;
  }
  __device__ bool ok(int o) const {
    return mx[o / 9] && my[(o / 3) % 3] && mz[o % 3];
  }
};

// Flattened index shift of offset o.
__device__ __forceinline__ int shift(int o, int Y, int Z) {
  return ((o / 9 - 1) * Y + ((o / 3) % 3 - 1)) * Z + (o % 3 - 1);
}

// Lane-major: block (P points) x (blockDim.y lane groups of K lanes),
// blockIdx.y the lane slab.  The block walks the tiles blockIdx.x,
// + gridDim.x, ... with two tile buffers: the next tile's copy runs
// while the current one is computed.  Tile layout (B*27, P): the warp's
// consecutive points read consecutive words.
template <typename T, int B, int K, int P>
__global__ void __launch_bounds__(Tile<T>::kB2Threads, Tile<T>::kB2MinBlocks)
batched_stencil_spmv_kernel(const T* __restrict__ Xs,
                            const T* __restrict__ coeff,
                            const T* __restrict__ sig, T* __restrict__ Ys,
                            int L, int X, int Y, int Z) {
  constexpr int kTile = B * 27 * P;
  extern __shared__ __align__(16) unsigned char s_raw[];
  T* tiles = reinterpret_cast<T*>(s_raw);  // two tiles
  const int G = X * Y * Z;
  const int ntiles = (G + P - 1) / P;
  const int l0 = (blockIdx.y * blockDim.y + threadIdx.y) * K;
  const int nl = min(K, L - l0);  // lanes of this thread (<= 0: none)
  T s[K][B];
#pragma unroll
  for (int l = 0; l < K; ++l) {
#pragma unroll
    for (int b = 0; b < B; ++b) {
      s[l][b] = l < nl ? sig[(l0 + l) * B + b] : T(0);
    }
  }

  const int step = gridDim.x;
  int tile = blockIdx.x;
  stage_coeff_tile<T, B, P>(tiles, coeff, G, tile * P);
  for (int it = 0; tile < ntiles; ++it, tile += step) {
    cp_async_wait_block();
    if (tile + step < ntiles) {
      stage_coeff_tile<T, B, P>(
          tiles + ((it + 1) & 1) * kTile, coeff, G, (tile + step) * P);
    }
    const T* s_c = tiles + (it & 1) * kTile;
    const int p = tile * P + threadIdx.x;
    if (p >= G || nl <= 0) continue;
    const Nbr nbr(p, X, Y, Z);
    const T* x0 = Xs + l0 * G + p;
    T acc[K];
#pragma unroll
    for (int l = 0; l < K; ++l) acc[l] = T(0);
#pragma unroll
    for (int row = 0; row < 9; ++row) {  // (dx, dy); its 3 x 3 loads first
      T xv[3][K];
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
        const int o = row * 3 + dz;
        const bool ok = nbr.ok(o);
        const int off = shift(o, Y, Z);
#pragma unroll
        for (int l = 0; l < K; ++l) {
          xv[dz][l] = (ok && l < nl) ? x0[l * G + off] : T(0);
        }
      }
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
        const int o = row * 3 + dz;
        T c[B];
#pragma unroll
        for (int b = 0; b < B; ++b) c[b] = s_c[(b * 27 + o) * P + threadIdx.x];
#pragma unroll
        for (int l = 0; l < K; ++l) {
          if (l < nl) {
            T co = s[l][0] * c[0];
#pragma unroll
            for (int b = 1; b < B; ++b) co = fma(s[l][b], c[b], co);
            acc[l] = fma(co, xv[dz][l], acc[l]);
          }
        }
      }
    }
#pragma unroll
    for (int l = 0; l < K; ++l) {
      if (l < nl) Ys[(l0 + l) * G + p] = acc[l];
    }
  }
}

// Lane-minor: block (blockDim.x lane threads) x (blockDim.y point rows);
// blockIdx.y the lane slab of blockDim.x * K lanes, of which a thread takes
// K, blockDim.x apart, at the points threadIdx.y, +blockDim.y, ... of a
// P-point tile.  Tiles and their two buffers as in the lane-major kernel;
// the threads of a point read its coefficients as a broadcast.
template <typename T, int B, int K, int P>
__global__ void __launch_bounds__(Tile<T>::kLmThreads, Tile<T>::kLmMinBlocks)
batched_stencil_spmv_lminor_kernel(const T* __restrict__ Xm,
                                   const T* __restrict__ coeff,
                                   const T* __restrict__ sig,
                                   T* __restrict__ Ym, int L, int X, int Y,
                                   int Z) {
  constexpr int kTile = B * 27 * P;
  extern __shared__ __align__(16) unsigned char s_raw[];
  T* tiles = reinterpret_cast<T*>(s_raw);  // two tiles
  const int G = X * Y * Z;
  const int ntiles = (G + P - 1) / P;
  const int H = blockDim.x;
  const int l0 = blockIdx.y * H * K + threadIdx.x;  // lanes l0 + j * H
  const int nl = L > l0 ? (L - l0 + H - 1) / H : 0;  // of them below L
  T s[K][B];
#pragma unroll
  for (int j = 0; j < K; ++j) {
#pragma unroll
    for (int b = 0; b < B; ++b) {
      s[j][b] = j < nl ? sig[b * L + l0 + j * H] : T(0);
    }
  }

  const int step = gridDim.x;
  int tile = blockIdx.x;
  stage_coeff_tile<T, B, P>(tiles, coeff, G, tile * P);
  for (int it = 0; tile < ntiles; ++it, tile += step) {
    cp_async_wait_block();
    if (tile + step < ntiles) {
      stage_coeff_tile<T, B, P>(tiles + ((it + 1) & 1) * kTile, coeff, G,
                                (tile + step) * P);
    }
    if (nl <= 0) continue;
    const T* s_c = tiles + (it & 1) * kTile;
    const int np = min(P, G - tile * P);
    for (int q = threadIdx.y; q < np; q += blockDim.y) {
      const int p = tile * P + q;
      const Nbr nbr(p, X, Y, Z);
      T acc[K];
#pragma unroll
      for (int j = 0; j < K; ++j) acc[j] = T(0);
#pragma unroll
      for (int row = 0; row < 9; ++row) {  // (dx, dy); its 3 x K loads first
        T xv[3][K];
#pragma unroll
        for (int dz = 0; dz < 3; ++dz) {
          const int o = row * 3 + dz;
          const bool ok = nbr.ok(o);
          const T* x = Xm + (p + shift(o, Y, Z)) * L + l0;
#pragma unroll
          for (int j = 0; j < K; ++j) {
            xv[dz][j] = (ok && j < nl) ? x[j * H] : T(0);
          }
        }
#pragma unroll
        for (int dz = 0; dz < 3; ++dz) {
          const int o = row * 3 + dz;
          T c[B];
#pragma unroll
          for (int b = 0; b < B; ++b) c[b] = s_c[(b * 27 + o) * P + q];
#pragma unroll
          for (int j = 0; j < K; ++j) {
            if (j < nl) {
              T co = s[j][0] * c[0];
#pragma unroll
              for (int b = 1; b < B; ++b) co = fma(s[j][b], c[b], co);
              acc[j] = fma(co, xv[dz][j], acc[j]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (j < nl) Ym[p * L + l0 + j * H] = acc[j];
      }
    }
  }
}

// The coarsest multigrid level's fixed CG in one launch: for each lane s
// (one block each), with diag = free && C[13] != 0 ? C[13] : 1, dinv =
// 1 / diag and op(v) = free ? K (free ? v : 0) : v (kernel 1's apply),
//   z = dinv b;  x = 0, r = b, p = z, rz = sum b z;  `iters` times:
//   ap = op(p);  alpha = rz / (pap != 0 ? pap : 1), pap = sum p ap;
//   x += alpha p;  r -= alpha ap;  z = dinv r;
//   beta = rz' / (rz != 0 ? rz : 1), rz' = sum r z;  p = z + beta p;
// and x is written.  Run as ~21 launches an iteration, the level costs
// ~505 launches a V-cycle at the launch floor; the whole level fits in one
// SM, so one block runs all its iterations:
//   * The block is 1..kCgMaxWarps warps (one per 32 points); a thread
//     keeps x, r and dinv of its K points q = tid + k * blockDim.x in
//     registers (touched only by unrolled elementwise updates).
//   * Shared memory: with kSmemC the lane's 27 coefficient planes, copied
//     in once (cp.async), so that every apply reads them from there
//     (without, for a level too large, from device memory, where L2 keeps
//     them); p; free ? p : 0, which the neighbour reads take (zero outside
//     the grid, as in kernel 1); ap, then z; and each point's 27 neighbour
//     bits and free bit.  The apply is a plain loop over the thread's
//     points, its 27 offsets unrolled, acc = fma(C_o, p_o, acc) over o =
//     0..26 in order: a thread holds one point's loads at a time (holding
//     all K points' in registers spilled).
//   * Dot products: a __shfl_xor_sync butterfly in each warp (every lane
//     ends with the same sum), then the warps' partials added in warp
//     order by every thread: the same sums in every run, and every thread
//     forms alpha and beta itself, with IEEE division.
// Bound by latency, not by bytes or operations: each iteration is three
// block barriers and two reductions in sequence.  A grid is a few blocks,
// so a block may take all the registers an SM gives it (launch bounds of
// one block an SM).
constexpr int kCgMaxWarps = 8;
constexpr int kCgMaxPoints = 8;  // points a thread at most
constexpr unsigned kCgFree = 1u << 31;

// Phase clocks of the V-cycle tail (profile_kernels --tail --clocks): a
// build with -DPST_TAIL_CLOCKS has thread 0 of block (0, 0) read clock64()
// at the end of each phase (after its barrier, so a phase's cycles include
// the wait for the block's slowest thread) and add the cycles since the
// last reading to the phase's slot; at exit it writes the slots to
// g_tail_clk, which pst_tail_clocks copies out.  The default build has no
// clock code: TailClock is empty there.  Slots (profile_kernels reads them
// by the same numbers): 0 staging; per level l above the coarsest (l > 3
// kept in 3) 1 + 7 l + {x = wd b, its planes' wait, the nu - 1 sweeps, the
// residual, the restriction's passes 0, 1, 2}; the coarse CG
// kClkCg + {start, apply, p.ap sum, x r z updates, r.z sum, p update and
// the loop's barrier, the result}, the per-iteration ones summed over the
// iterations; per level going up kClkUp + 4 l + {the prolongation's passes
// 0, 1, 2, the nu sweeps}; kClkOut writing x; the cluster tail's phases,
// read on its tail rank (which waits at the cluster barriers meanwhile),
// kClkCluster + {the absorbed level's staging and x = wd b, its nu - 1
// sweeps, its residual, its restriction, its prolongation, its nu
// sweeps}; kClkTotal entry to exit.
constexpr int kClkSlots = 64;
constexpr int kClkCg = 29;
constexpr int kClkUp = 36;
constexpr int kClkOut = 52;
constexpr int kClkCluster = 53;
constexpr int kClkTotal = 63;
__host__ __device__ constexpr int clk_down(int l, int k) {
  return 1 + 7 * (l < 3 ? l : 3) + k;
}
__host__ __device__ constexpr int clk_up(int l, int k) {
  return kClkUp + 4 * (l < 3 ? l : 3) + k;
}

#ifdef PST_TAIL_CLOCKS
__device__ long long g_tail_clk[kClkSlots];
struct TailClock {
  long long acc[kClkSlots];
  long long first, last;
  bool on;
  __device__ TailClock()
      : on(threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0) {
    if (on) {
      for (int i = 0; i < kClkSlots; ++i) acc[i] = 0;
      first = last = clock64();
    }
  }
  __device__ void mark(int slot) {
    if (on) {
      const long long now = clock64();
      acc[slot] += now - last;
      last = now;
    }
  }
  __device__ void store() {
    if (on) {
      acc[kClkTotal] = clock64() - first;
      for (int i = 0; i < kClkSlots; ++i) g_tail_clk[i] = acc[i];
    }
  }
};
#else
struct TailClock {
  __device__ void mark(int) {}
  __device__ void store() {}
};
#endif

// Barrier of the block's first nt threads (nt a multiple of 32): named
// barrier 1, which the coarse CG's threads take while the block's other
// warps wait once, at the block barrier after it.
__device__ __forceinline__ void cg_barrier(int nt) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(nt) : "memory");
}

// Sum of v over the first `warps` warps (nt = 32 warps threads), through
// slot[0..warps) (see coarse_cg_kernel), on those threads only.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* slot, int warps) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) slot[w] = v;
  cg_barrier(32 * warps);
  T sum = slot[0];
  for (int i = 1; i < warps; ++i) sum += slot[i];
  return sum;
}

// Point q's 27 neighbour bits (bit o: offset o lies in the grid) and, if
// `free`, kCgFree: bit (dx + 1) 9 + (dy + 1) 3 + dz + 1 is the product of
// the three axes' bits, formed as 3-bit masks an axis (a dozen
// instructions, not a test an offset: the tail's staging is bound by
// issue).
__device__ __forceinline__ unsigned axis_bits(int i, int n) {
  return (i > 0 ? 1u : 0u) | 2u | (i < n - 1 ? 4u : 0u);
}
__device__ __forceinline__ unsigned nbr_word(int q, int X, int Y, int Z,
                                             bool free) {
  const int k = q % Z, t = q / Z;
  const unsigned bz = axis_bits(k, Z), by = axis_bits(t % Y, Y);
  const unsigned bx = axis_bits(t / Y, X);
  const unsigned yz = (by & 1u ? bz : 0u) | bz << 3 | (by & 4u ? bz << 6 : 0u);
  return (free ? kCgFree : 0u) | (bx & 1u ? yz : 0u) | yz << 9 |
         (bx & 4u ? yz << 18 : 0u);
}

// Kernel 1's apply at point q, c the grid's 27 planes of G points: acc =
// fma(C_o, v_o, acc) over o = 0..26 in order (stencil_point's sum), v_o =
// value(n) of the neighbour n along offset o, 0 where bit o of nb is clear
// (outside the grid, or, in the level kernels' words, not free).
template <typename T, typename Value>
__device__ __forceinline__ T apply_with(const T* c, unsigned nb, int q, int G,
                                        int Y, int Z, Value value) {
  T acc = T(0);
#pragma unroll
  for (int o = 0; o < 27; ++o) {
    const T pv = (nb >> o & 1u) ? value(q + shift(o, Y, Z)) : T(0);
    acc = fma(c[o * G + q], pv, acc);
  }
  return acc;
}

// apply_with on values v in memory (shared memory in the coarse CG and
// the tail).
template <typename T>
__device__ __forceinline__ T apply_point(const T* c, const T* v, unsigned nb,
                                         int q, int G, int Y, int Z) {
  return apply_with(c, nb, q, G, Y, Z, [v](int n) { return v[n]; });
}

// The coarse CG's work on one lane's level, shared by coarse_cg_kernel and
// vcycle_tail_kernel: c its 27 planes, nbs its neighbour words (nbr_word),
// b its right-hand side and x its result (shared or device memory); pm, pu
// and tz scratch of G values and red 2 * kCgMaxWarps partials in shared
// memory.  The first nt threads (a multiple of 32) take the points q =
// tid + k * nt, k < K, and synchronise by cg_barrier; the block's other
// threads return at once (the caller's block barrier after the CG waits
// for it).
template <typename T, int K>
__device__ void coarse_cg_run(const T* c, const unsigned* nbs, const T* b,
                              T* x, T* pm, T* pu, T* tz, T* red, int nt,
                              int iters, int G, int Y, int Z,
                              TailClock& ck) {
  const int tid = threadIdx.x;
  if (tid >= nt) return;
  const int warps = nt >> 5;
  T xk[K], rk[K], dk[K];  // x, r, dinv of the thread's points
  unsigned fr = 0;        // bit k: point k is free
  T part = T(0);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int q = tid + k * nt;
    xk[k] = rk[k] = dk[k] = T(0);
    if (q < G) {
      const bool f = (nbs[q] & kCgFree) != 0u;
      fr |= (unsigned)f << k;
      rk[k] = b[q];
      const T c13 = c[13 * G + q];
      dk[k] = T(1) / ((f && c13 != T(0)) ? c13 : T(1));
      const T z = dk[k] * rk[k];
      pu[q] = z;
      pm[q] = f ? z : T(0);
      part = fma(rk[k], z, part);
    }
  }
  T rz = block_sum(part, red + kCgMaxWarps, warps);
  ck.mark(kClkCg);
  for (int it = 0; it < iters; ++it) {
    cg_barrier(nt);  // every point's p written
    ck.mark(kClkCg + 5);
    T pap = T(0);
    for (int q = tid; q < G; q += nt) {
      const unsigned nb = nbs[q];
      const T pq = pu[q];
      const T ap = (nb & kCgFree) ? apply_point(c, pm, nb, q, G, Y, Z) : pq;
      tz[q] = ap;
      pap = fma(pq, ap, pap);
    }
    ck.mark(kClkCg + 1);
    const T den = block_sum(pap, red, warps);
    ck.mark(kClkCg + 2);
    const T alpha = rz / (den != T(0) ? den : T(1));
    T rzp = T(0);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = tid + k * nt;
      if (q < G) {
        xk[k] = fma(alpha, pu[q], xk[k]);
        rk[k] = fma(-alpha, tz[q], rk[k]);
        const T z = dk[k] * rk[k];
        tz[q] = z;
        rzp = fma(rk[k], z, rzp);
      }
    }
    ck.mark(kClkCg + 3);
    const T rzn = block_sum(rzp, red + kCgMaxWarps, warps);
    ck.mark(kClkCg + 4);
    const T beta = rzn / (rz != T(0) ? rz : T(1));
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = tid + k * nt;
      if (q < G) {
        const T pn = fma(beta, pu[q], tz[q]);
        pu[q] = pn;
        pm[q] = (fr >> k & 1u) ? pn : T(0);
      }
    }
    rz = rzn;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int q = tid + k * nt;
    if (q < G) x[q] = xk[k];
  }
}

// Threads of a coarse CG on G points: one warp per 32 points, at most
// kCgMaxWarps; then each thread takes ceil(G / threads) points.
__host__ __device__ __forceinline__ int coarse_cg_threads(int G) {
  const int w = (G + 31) / 32;
  return 32 * (w < kCgMaxWarps ? w : kCgMaxWarps);
}

template <typename T, int K, bool kSmemC>
__global__ void __launch_bounds__(kCgMaxWarps * 32, 1)
coarse_cg_kernel(const T* __restrict__ b, const T* __restrict__ C,
                 const unsigned char* __restrict__ free, T* __restrict__ x,
                 int free_stride, int iters, int X, int Y, int Z) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  T* sm = reinterpret_cast<T*>(s_raw);
  const int G = X * Y * Z;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  b += blockIdx.x * G;
  x += blockIdx.x * G;
  free += blockIdx.x * free_stride;
  const T* c = C + blockIdx.x * 27 * G;
  if constexpr (kSmemC) {
    for (int t = tid; t < 27 * G; t += nt) cp_async_elem(sm + t, c + t);
    c = sm;
  }
  T* pm = sm + (kSmemC ? 27 * G : 0);  // free ? p : 0, for the neighbours
  T* pu = pm + G;                      // p
  T* tz = pu + G;                      // ap, then z
  T* red = tz + G;  // [0, kCgMaxWarps): p.ap partials; then r.z partials
  unsigned* nbs = reinterpret_cast<unsigned*>(red + 2 * kCgMaxWarps);
  for (int q = tid; q < G; q += nt) nbs[q] = nbr_word(q, X, Y, Z, free[q]);
  if constexpr (kSmemC) {
    cp_async_wait_block();
  } else {
    __syncthreads();
  }
  TailClock ck;  // no clocks kept: the tail's slots
  coarse_cg_run<T, K>(c, nbs, b, x, pm, pu, tz, red, nt, iters, G, Y, Z, ck);
}

// ── the V-cycle tail ──────────────────────────────────────────────────────
//
// cycle_impl's V-cycle from a level t down to the coarsest and back, in one
// launch, one block a lane.  Run level by level, each level below t costs
// ~75 launches a V-cycle (4 of kernel 1 at a few hundred to a few thousand
// points, the smoothing's elementwise ops, the transfers' per-axis gathers)
// and the coarsest one coarse-CG launch; every launch sits at the launch
// floor, so the card idles between them.  Every level from t on fits one
// SM's shared memory, so one block keeps the whole tail there:
//   * Shared memory: every tail level's 27 coefficient planes, copied in at
//     entry by cp.async, one commit group a level with the top level's
//     first, so that each level waits only for its own planes (the top
//     level's first sweep needs none: omega * dinv comes from the diagonal
//     plane read from device memory); each level's x, b, omega * dinv and
//     neighbour word a point; and, sized by the top level, the masked x
//     (two buffers: a Jacobi sweep reads one and writes the other) and two
//     temporaries for the residual and the transfers' axis passes, which
//     the coarse CG reuses as its p, masked p and ap.  The transfer tables
//     (a few hundred values) are read from device memory, where L1 keeps
//     them.
//   * Phases (a sweep, the residual, one axis of a transfer) are separated
//     by __syncthreads() instead of kernel boundaries; in each, the threads
//     stride over the level's points.  The coarsest level is coarse_cg_run,
//     on the threads and in the order coarse_cg_kernel uses at its size.
//   * The route it replaces is repeated bit for bit: the applies are kernel
//     1's sum (apply_point); the smoothing, residual, masks and transfers
//     round as PyTorch's op-by-op kernels do: __f*_rn / __d*_rn intrinsics
//     keep nvcc from contracting a multiply and an add into an fma, in the
//     twin's operand order: x + (omega dinv) (b - op(x)) with omega in T,
//     dinv = 1 / diag by IEEE division; restriction acc = in_0 w_0, then
//     acc + in_k w_k for every table entry k in order (zero-weight padding
//     included); prolongation in_s0 wl + in_s1 wr.
// Bound by latency, as the coarse CG: ~10 barrier-separated phases a level
// plus the coarse CG's three barriers an iteration.
constexpr int kTailMaxLevels = 8;

// Threads of a tail block: 512 in float32, 256 in float64
// (profile_kernels --tail: 512 threads take 1-3% less time on the float32
// tails of four of the five paths and 1-6% more on the float64 ones);
// PST_TAIL_THREADS sets both.
#ifdef PST_TAIL_THREADS
template <typename T>
constexpr int kTailThreads = PST_TAIL_THREADS;
#else
template <typename T>
constexpr int kTailThreads = sizeof(T) == 4 ? 512 : 256;
#endif
static_assert(kTailThreads<float> % 32 == 0 &&
                  kTailThreads<float> >= kCgMaxWarps * 32 &&
                  kTailThreads<double> % 32 == 0 &&
                  kTailThreads<double> >= kCgMaxWarps * 32,
              "the tail's block must hold the coarse CG's threads");

struct TailLevel {
  int X, Y, Z, G;
  int off;  // the level's first point in the packed layout
};
struct TailTransfer {  // level l to l + 1, per axis
  int K[3];            // restriction entries a coarse point
  int ioff[3];         // s0 (fine points), then idx (coarse x K) in itab
  int woff[3];         // wl, wr (fine points each), then wt in wtab
};
struct TailMeta {
  int n;       // levels, the top one first
  int points;  // points of all levels
  TailLevel lv[kTailMaxLevels];
  TailTransfer tr[kTailMaxLevels - 1];
};

// PyTorch's single-rounded elementwise ops (no contraction into fma).
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `pending` of this thread's newest commit groups are
// in flight (0..kTailMaxLevels).
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  switch (pending) {
    case 0: cp_async_wait_group<0>(); break;
    case 1: cp_async_wait_group<1>(); break;
    case 2: cp_async_wait_group<2>(); break;
    case 3: cp_async_wait_group<3>(); break;
    case 4: cp_async_wait_group<4>(); break;
    case 5: cp_async_wait_group<5>(); break;
    case 6: cp_async_wait_group<6>(); break;
    case 7: cp_async_wait_group<7>(); break;
    default: cp_async_wait_group<8>(); break;
  }
}

// (i, j, k) of point p of an (n0, n1, n2) grid.
__device__ __forceinline__ void ijk(int p, int n1, int n2, int* i, int* j,
                                    int* k) {
  *k = p % n2;
  const int q = p / n2;
  *j = q % n1;
  *i = q / n1;
}

// n / d for 0 <= n < 2^31 and 1 <= d < 2^20 by a multiply-high and a
// shift, three instructions instead of a division's ~20.  The magic
// number m = floor(2^(32 + s) / d) - 2^32 + 1, s = ceil(log2 d), comes
// from one double division, whose floor is exact here: the quotient's
// fraction is 0 or at most 1 - 1 / d, far from the next integer for d <
// 2^20 (no 64-bit integer division, a long software routine).
struct FastDiv {
  unsigned m, s;
  __device__ explicit FastDiv(int d) {
    s = 32 - __clz((unsigned)d - 1);
    const double q = (double)(1ull << (32 + s)) / (double)d;
    m = (unsigned)((unsigned long long)q - (1ull << 32) + 1);
  }
  __device__ int div(int n) const {
    return (int)((__umulhi((unsigned)n, m) + (unsigned)n) >> s);
  }
};

// ijk by FastDiv: by1 and by2 divide by n1 and n2 (the tail's transfer
// passes: two divisions and two remainders a value cost more than its
// sum).
__device__ __forceinline__ void ijk_fast(int p, int n1, int n2,
                                         const FastDiv& by1,
                                         const FastDiv& by2, int* i, int* j,
                                         int* k) {
  const int q = by2.div(p);
  *k = p - q * n2;
  *i = by1.div(q);
  *j = q - *i * n1;
}

// One axis pass of the restriction R = P^T: out (o0, o1, o2) from `in`,
// whose extent along axis a is nf; out[c] = sum_k in[idx[c, k]] wt[c, k]
// in k order, acc = in_0 wt_0, then acc + in_k wt_k.  With `mask` (the
// coarse level's words), out = free ? acc : 0.
template <typename T>
__device__ void restrict_axis(const T* in, T* out, int o0, int o1, int o2,
                              int a, int nf, const int* __restrict__ idx,
                              const T* __restrict__ wt, int K,
                              const unsigned* mask) {
  const int m1 = a == 1 ? nf : o1, m2 = a == 2 ? nf : o2;
  const int st = a == 0 ? m1 * m2 : (a == 1 ? m2 : 1);
  const int N = o0 * o1 * o2;
  const FastDiv by1(o1), by2(o2);
  for (int p = threadIdx.x; p < N; p += blockDim.x) {
    int i, j, k;
    ijk_fast(p, o1, o2, by1, by2, &i, &j, &k);
    const int c = a == 0 ? i : (a == 1 ? j : k);
    const int base = (i * m1 + j) * m2 + k - c * st;
    const int* ix = idx + c * K;
    const T* w = wt + c * K;
    T acc = mul_rn(in[base + ix[0] * st], w[0]);
    for (int e = 1; e < K; ++e) {
      acc = add_rn(acc, mul_rn(in[base + ix[e] * st], w[e]));
    }
    out[p] = (mask == nullptr || (mask[p] & kCgFree)) ? acc : T(0);
  }
  __syncthreads();
}

// One axis pass of the prolongation: the value at (o0, o1, o2) with fine
// index f along axis a is in_s wl[f] + in_(s+1) wr[f], s = s0[f], from `in`
// whose extent along axis a is nc.  kAdd: the last pass, added to the
// level's x (x + P xc) and written masked to xm; else stored in out.
template <typename T, bool kAdd>
__device__ void prolong_axis(const T* in, T* out, int o0, int o1, int o2,
                             int a, int nc, const int* __restrict__ s0,
                             const T* __restrict__ wl,
                             const T* __restrict__ wr, T* xm,
                             const unsigned* nb) {
  const int m1 = a == 1 ? nc : o1, m2 = a == 2 ? nc : o2;
  const int st = a == 0 ? m1 * m2 : (a == 1 ? m2 : 1);
  const int N = o0 * o1 * o2;
  const FastDiv by1(o1), by2(o2);
  for (int p = threadIdx.x; p < N; p += blockDim.x) {
    int i, j, k;
    ijk_fast(p, o1, o2, by1, by2, &i, &j, &k);
    const int f = a == 0 ? i : (a == 1 ? j : k);
    const int at = (i * m1 + j) * m2 + k + (s0[f] - f) * st;
    const T v = add_rn(mul_rn(in[at], wl[f]), mul_rn(in[at + st], wr[f]));
    if constexpr (kAdd) {
      const T xn = add_rn(out[p], v);
      out[p] = xn;
      xm[p] = (nb[p] & kCgFree) ? xn : T(0);
    } else {
      out[p] = v;
    }
  }
  __syncthreads();
}

// P xc at a fine point as prolong_axis forms it: along x, then y, then
// z, each value in_s wl + in_(s+1) wr; at(cx, cy, cz) reads xc, (sx, lx,
// rx) etc. the point's slots and weights along each axis (the cluster
// tail's slabs; prolong_add_kernel and level_prolong_sweep_kernel share
// the passes' values among points: prolong_unit, the halo's pairs).
template <typename T, typename At>
__device__ __forceinline__ T prolong_value(At at, int sx, int sy, int sz,
                                           T lx, T rx, T ly, T ry, T lz,
                                           T rz) {
  const auto p0 = [&](int cy, int cz) {
    return add_rn(mul_rn(at(sx, cy, cz), lx), mul_rn(at(sx + 1, cy, cz), rx));
  };
  const auto p1 = [&](int cz) {
    return add_rn(mul_rn(p0(sy, cz), ly), mul_rn(p0(sy + 1, cz), ry));
  };
  return add_rn(mul_rn(p1(sz), lz), mul_rn(p1(sz + 1), rz));
}

// One level's arrays in shared memory.
template <typename T>
struct TailView {
  const T* c;  // 27 planes
  T* x;
  T* b;
  const T* wd;  // omega * dinv
  const unsigned* nb;
  int X, Y, Z, G;
};

// A damped-Jacobi sweep x = x + wd (b - op(x)), op(x) = free ? K xm : x,
// xm = free ? x : 0 read from xin; the new masked x goes to xout.
template <typename T>
__device__ void jacobi_sweep(const TailView<T>& v, const T* xin, T* xout) {
  for (int q = threadIdx.x; q < v.G; q += blockDim.x) {
    const unsigned nb = v.nb[q];
    const bool f = (nb & kCgFree) != 0u;
    const T xq = v.x[q];
    const T ax = f ? apply_point(v.c, xin, nb, q, v.G, v.Y, v.Z) : xq;
    const T xn = add_rn(xq, mul_rn(v.wd[q], sub_rn(v.b[q], ax)));
    v.x[q] = xn;
    xout[q] = f ? xn : T(0);
  }
  __syncthreads();
}

// A tail block's shared memory, carved for the levels of m (see
// vcycle_tail_smem): every level's planes, x, b, omega * dinv and words;
// two masked-x buffers and two temporaries of the top level's points; the
// coarse CG's partials.
template <typename T>
struct TailSmem {
  T *planes, *xs, *bs, *wd, *xm, *s1, *s2, *red;
  unsigned* nbs;
  __device__ TailSmem(unsigned char* raw, const TailMeta& m) {
    const int P = m.points, G0 = m.lv[0].G;
    planes = reinterpret_cast<T*>(raw);
    xs = planes + 27 * P;
    bs = xs + P;
    wd = bs + P;
    xm = wd + P;       // two buffers of G0: the masked x the applies read
    s1 = xm + 2 * G0;  // the residual; transfer passes
    s2 = s1 + G0;
    red = s2 + G0;     // the coarse CG's partials
    nbs = reinterpret_cast<unsigned*>(red + 2 * kCgMaxWarps);
  }
  __device__ TailView<T> view(const TailMeta& m, int l) const {
    const TailLevel L = m.lv[l];
    return TailView<T>{planes + 27 * L.off, xs + L.off, bs + L.off,
                       wd + L.off, nbs + L.off, L.X, L.Y, L.Z, L.G};
  }
};

// Points of the tail's staging a thread takes at a time, their reads in
// flight together.
constexpr int kTailStage = 4;

// Starts a tail block: every level's planes (cl, the lane's packed planes)
// copied by cp.async, one commit group a level, the top level's first, so
// that each level waits only for its own planes (the top level's first
// sweep needs none: omega * dinv comes from the diagonal plane read from
// device memory); meanwhile every level's neighbour words (fl, the lane's
// packed free bytes) and omega * dinv, over all levels' points at once,
// kTailStage a thread, their device-memory reads issued first (the first
// points' before the planes' copies, which would queue ahead of them).
template <typename T>
__device__ void tail_stage(const TailSmem<T>& sm, const TailMeta& m,
                           const T* __restrict__ cl,
                           const unsigned char* __restrict__ fl, T omega) {
  const int n = m.n, P = m.points, tid = threadIdx.x, nt = blockDim.x;
  int lv[kTailStage];
  bool f[kTailStage];
  T c13[kTailStage];
  const auto load = [&](int p0) {
#pragma unroll
    for (int u = 0; u < kTailStage; ++u) {
      const int p = p0 + u * nt;
      int l = 0;
      while (l + 1 < n && p >= m.lv[l + 1].off) ++l;
      lv[u] = l;
      f[u] = false;
      c13[u] = T(1);
      if (p < P) {
        const TailLevel L = m.lv[l];
        f[u] = fl[p] != 0;
        c13[u] = cl[27LL * L.off + 13LL * L.G + (p - L.off)];
      }
    }
  };
  const auto words = [&](int p0) {
#pragma unroll
    for (int u = 0; u < kTailStage; ++u) {
      const int p = p0 + u * nt;
      if (p < P) {
        const TailLevel L = m.lv[lv[u]];
        sm.nbs[p] = nbr_word(p - L.off, L.X, L.Y, L.Z, f[u]);
        sm.wd[p] = mul_rn(omega, T(1) / ((f[u] && c13[u] != T(0)) ? c13[u]
                                                                   : T(1)));
      }
    }
  };
  load(tid);
  for (int l = 0; l < n; ++l) {
    const int o = 27 * m.lv[l].off, cnt = 27 * m.lv[l].G;
    for (int t = tid; t < cnt; t += nt) {
      cp_async_elem(sm.planes + o + t, cl + o + t);
    }
    cp_async_commit();
  }
  words(tid);
  for (int p0 = tid + kTailStage * nt; p0 < P; p0 += kTailStage * nt) {
    load(p0);
    words(p0);
  }
}

// The tail's V-cycle once tail_stage has run, the top level's b is in
// sm.bs and a block barrier has passed: down (pre-smooth, residual,
// restrict), the coarsest level's CG, up (prolong and add, post-smooth);
// the top level's result in sm.xs.  The planes' commit groups are the
// block's last n.
template <typename T>
__device__ void tail_run(const TailSmem<T>& sm, const TailMeta& m,
                         const int* __restrict__ itab,
                         const T* __restrict__ wtab, int nu, int iters,
                         TailClock& ck) {
  const int n = m.n, G0 = m.lv[0].G, tid = threadIdx.x, nt = blockDim.x;
  T* xm = sm.xm;
  T* s1 = sm.s1;
  T* s2 = sm.s2;
  // down: pre-smooth, residual, restrict
  for (int l = 0; l < n - 1; ++l) {
    const TailView<T> v = sm.view(m, l);
    for (int q = tid; q < v.G; q += nt) {  // the first sweep, from x = 0
      const T xq = mul_rn(v.wd[q], v.b[q]);
      v.x[q] = xq;
      xm[q] = (v.nb[q] & kCgFree) ? xq : T(0);
    }
    ck.mark(clk_down(l, 0));
    cp_async_wait_pending(n - 1 - l);  // this level's planes
    __syncthreads();
    ck.mark(clk_down(l, 1));
    int cur = 0;
    for (int s = 1; s < nu; ++s, cur ^= 1) {
      jacobi_sweep(v, xm + cur * G0, xm + (cur ^ 1) * G0);
    }
    ck.mark(clk_down(l, 2));
    for (int q = tid; q < v.G; q += nt) {
      const unsigned nb = v.nb[q];
      const T ax = (nb & kCgFree)
                       ? apply_point(v.c, xm + cur * G0, nb, q, v.G, v.Y, v.Z)
                       : v.x[q];
      s1[q] = sub_rn(v.b[q], ax);
    }
    __syncthreads();
    ck.mark(clk_down(l, 3));
    const TailLevel C = m.lv[l + 1];
    const TailTransfer& tr = m.tr[l];
    restrict_axis(s1, s2, C.X, v.Y, v.Z, 0, v.X, itab + tr.ioff[0] + v.X,
                  wtab + tr.woff[0] + 2 * v.X, tr.K[0], (const unsigned*)nullptr);
    ck.mark(clk_down(l, 4));
    restrict_axis(s2, s1, C.X, C.Y, v.Z, 1, v.Y, itab + tr.ioff[1] + v.Y,
                  wtab + tr.woff[1] + 2 * v.Y, tr.K[1], (const unsigned*)nullptr);
    ck.mark(clk_down(l, 5));
    restrict_axis(s1, sm.bs + C.off, C.X, C.Y, C.Z, 2, v.Z,
                  itab + tr.ioff[2] + v.Z, wtab + tr.woff[2] + 2 * v.Z,
                  tr.K[2], sm.nbs + C.off);
    ck.mark(clk_down(l, 6));
  }
  // the coarsest level: coarse_cg_kernel's CG at its thread count
  {
    const TailView<T> v = sm.view(m, n - 1);
    cp_async_wait_pending(0);
    __syncthreads();
    ck.mark(clk_down(n - 1, 1));
    const int ntc = coarse_cg_threads(v.G);
    const int need = (v.G + ntc - 1) / ntc;
    T* pm = xm;
    T* pu = xm + G0;
    if (need <= 1) {
      coarse_cg_run<T, 1>(v.c, v.nb, v.b, v.x, pm, pu, s1, sm.red, ntc, iters,
                          v.G, v.Y, v.Z, ck);
    } else if (need <= 2) {
      coarse_cg_run<T, 2>(v.c, v.nb, v.b, v.x, pm, pu, s1, sm.red, ntc, iters,
                          v.G, v.Y, v.Z, ck);
    } else if (need <= 4) {
      coarse_cg_run<T, 4>(v.c, v.nb, v.b, v.x, pm, pu, s1, sm.red, ntc, iters,
                          v.G, v.Y, v.Z, ck);
    } else {
      coarse_cg_run<T, 8>(v.c, v.nb, v.b, v.x, pm, pu, s1, sm.red, ntc, iters,
                          v.G, v.Y, v.Z, ck);
    }
    __syncthreads();
    ck.mark(kClkCg + 6);
  }
  // up: prolong and add, post-smooth
  for (int l = n - 2; l >= 0; --l) {
    const TailView<T> v = sm.view(m, l);
    const TailLevel C = m.lv[l + 1];
    const TailTransfer& tr = m.tr[l];
    prolong_axis<T, false>(sm.xs + C.off, s1, v.X, C.Y, C.Z, 0, C.X,
                           itab + tr.ioff[0], wtab + tr.woff[0],
                           wtab + tr.woff[0] + v.X, nullptr, nullptr);
    ck.mark(clk_up(l, 0));
    prolong_axis<T, false>(s1, s2, v.X, v.Y, C.Z, 1, C.Y, itab + tr.ioff[1],
                           wtab + tr.woff[1], wtab + tr.woff[1] + v.Y,
                           nullptr, nullptr);
    ck.mark(clk_up(l, 1));
    prolong_axis<T, true>(s2, v.x, v.X, v.Y, v.Z, 2, C.Z, itab + tr.ioff[2],
                          wtab + tr.woff[2], wtab + tr.woff[2] + v.Z, xm,
                          v.nb);
    ck.mark(clk_up(l, 2));
    int cur = 0;
    for (int s = 0; s < nu; ++s, cur ^= 1) {
      jacobi_sweep(v, xm + cur * G0, xm + (cur ^ 1) * G0);
    }
    ck.mark(clk_up(l, 3));
  }
}

template <typename T>
__global__ void __launch_bounds__(kTailThreads<T>, 1)
vcycle_tail_kernel(const T* __restrict__ b, const T* __restrict__ Cp,
                   const unsigned char* __restrict__ Fp,
                   const int* __restrict__ itab, const T* __restrict__ wtab,
                   T* __restrict__ x, const __grid_constant__ TailMeta m,
                   int free_stride, int nu, T omega, int iters) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  TailClock ck;
  const TailSmem<T> sm(s_raw, m);
  const int G0 = m.lv[0].G, tid = threadIdx.x, nt = blockDim.x;
  const long long lane = blockIdx.x;
  b += lane * G0;
  x += lane * G0;
  // b first, in a commit group of its own before the planes'
  for (int q = tid; q < G0; q += nt) cp_async_elem(sm.bs + q, b + q);
  cp_async_commit();
  tail_stage(sm, m, Cp + lane * 27 * m.points, Fp + lane * free_stride,
             omega);
  cp_async_wait_pending(m.n);
  __syncthreads();
  ck.mark(0);
  tail_run(sm, m, itab, wtab, nu, iters, ck);
  for (int q = tid; q < G0; q += nt) x[q] = sm.xs[q];
  ck.mark(kClkOut);
  ck.store();
}

// ── the cluster tail ─────────────────────────────────────────────────────
//
// One V-cycle from a level A down to the coarsest and back in one launch,
// where A, the level above the tail (t - 1), does not fit one SM (its
// planes are 484 KB in f32 at step04's (28, 16, 10)): one thread-block
// cluster of N <= 8 blocks a lane, on N SMs that read and write each
// other's shared memory (DSMEM).  It replaces, at A, the five level-kernel
// launches of a V-cycle ("sweep0", "residual", restrict, "prolong_sweep",
// "sweep"), and below it the vcycle_tail launch: kernel 1's work
// (stencil_spmv_flat) and cycle_impl's recursion
// (pelvistim_fem_tpu/ops/multigrid.py:425-460) from A on, which run as
// ~80 XLA ops and fusions a V-cycle on the TPU.
//   * Rank 0, the tail rank, holds the tail from level t and runs
//     vcycle_tail_kernel's body (tail_stage, then tail_run).  (Staging the
//     tail's words on the slab ranks instead, stored into rank 0 by DSMEM
//     after a split cluster barrier, did not shorten the first barrier:
//     PERF.md.)  Ranks 1..N-1, the slab ranks, each hold
//     an even slab of A's planes along axis 0 (ClusterPlan): their 27
//     coefficient planes and neighbour words (LevelOp's: bit o where the
//     neighbour lies in the grid and is free, bit 31 where the point is
//     free), b and wd = omega dinv with a plane of halo each side, all
//     copied in by cp.async; x (two buffers) with a plane of halo each
//     side, the residual with two.
//   * A's phases are separated by cluster.sync() (barrier.cluster with
//     release / acquire: a phase's shared-memory writes, DSMEM stores
//     included, are seen by every block after it).  Every read is local:
//     the thread that forms a value on a slab's boundary plane also
//     stores it into the halo of each rank that holds that plane in one
//     (push_halo, DSMEM stores), in the same phase.  The sweeps alternate
//     two x buffers, so no block writes a halo that its owner still reads.
//     (Reading the neighbours' planes in place through DSMEM inside the
//     apply took 12,000 cycles a sweep at step04's level, 5x the local
//     reads: PERF.md.)
//   * The restriction: each slab rank takes the coarse planes c of level t
//     whose fine knot min(2 c, X - 1) lies in its slab; the three passes
//     read its residual and halo; pass 2, masked by level t's free, is
//     stored into the tail rank's b by DSMEM.  The tail rank then runs the
//     tail while the slab ranks wait at cluster.sync().
//   * The prolongation: a slab rank copies the planes of level t's x that
//     its slab interpolates from (DSMEM loads; stores by the tail rank into
//     the slab ranks took longer: PERF.md), forms x' = x + P xc on its
//     points (prolong_value) and halos them; the nu sweeps follow, the last
//     writes x.
// Bit for bit the level kernels at A, then vcycle_tail from t (the route):
// A's applies are apply_with (kernel 1's fma order), the sweeps, residual
// and x' level_apply_kernel's and level_prolong_sweep_kernel's single
// roundings, the restriction restrict_kernel's sums on the same tables
// (TransferTables.packed) and mask.  Bound by latency, as the tail: 2 nu +
// 4 cluster barriers besides the tail's own, A's phases at one or two
// points a thread at N = 8.
constexpr int kClusterMaxRanks = 8;

struct ClusterPlan {
  int ranks;                     // N: rank 0 the tail rank
  int f0[kClusterMaxRanks + 1];  // slab rank r's planes of A [f0[r], f0[r + 1])
  int c0[kClusterMaxRanks + 1];  // its planes of level t in the restriction
  int wmax, cmax, pmax;  // most planes of A, of t restricted, of t prolonged
};

// n planes over the N - 1 slab ranks, evenly (the first n % (N - 1) take
// one more): rank r's are [at[r], at[r + 1]), r = 1..N - 1.
void even_planes(int n, int ranks, int* at) {
  const int s = ranks - 1, q = n / s, rem = n % s;
  at[0] = 0;
  for (int r = 1; r <= ranks; ++r) {
    at[r] = (r - 1) * q + std::min(r - 1, rem);
  }
}

// The plan of N ranks for A = ma.lv[0] and t = ma.lv[1]: false unless 2 <=
// N <= kClusterMaxRanks, every slab rank holds a plane of A and t has two
// planes along axis 0.  Slab rank r restricts the planes c of t whose fine
// knot min(2 c, X - 1) lies in its slab (their every-other-knot footprint
// [2 c - 2, 2 c + 2] then lies in its slab and two planes of halo each
// side), and its prolongation reads the planes of t from slot min(f / 2,
// Xt - 2) of its first plane f to one past its last's (the coarsening that
// multigrid.Transfer's kernel tables are checked to be).
bool cluster_plan(const TailMeta& ma, int ranks, ClusterPlan* pl) {
  const int X = ma.lv[0].X, nc = ma.lv[1].X;
  if (ranks < 2 || ranks > kClusterMaxRanks || X < ranks - 1 || nc < 2) {
    return false;
  }
  pl->ranks = ranks;
  even_planes(X, ranks, pl->f0);
  pl->wmax = (X + ranks - 2) / (ranks - 1);
  pl->cmax = pl->pmax = 0;
  pl->c0[0] = pl->c0[1] = 0;
  for (int r = 1, c = 0; r < ranks; ++r) {
    while (c < nc && std::min(2 * c, X - 1) < pl->f0[r + 1]) ++c;
    pl->c0[r + 1] = c;
    pl->cmax = std::max(pl->cmax, c - pl->c0[r]);
    const int a = std::min(pl->f0[r] / 2, nc - 2);
    const int b = std::min((pl->f0[r + 1] - 1) / 2, nc - 2) + 1;
    pl->pmax = std::max(pl->pmax, b - a + 1);
  }
  return true;
}

// A slab rank's shared memory: 27 planes and the words of wmax planes of
// A; b, wd and x twice with a plane of halo each side; the residual with
// two; the restriction's passes 0 and 1 (cmax planes of t); the footprint
// of t's x (pmax planes).
template <typename T>
struct SlabSmem {
  T *c, *b, *wd, *xa, *xb, *r, *sa, *sb, *xc;
  unsigned* nb;
  __device__ SlabSmem(unsigned char* raw, const TailMeta& ma,
                      const ClusterPlan& pl) {
    const TailLevel A = ma.lv[0], C = ma.lv[1];
    const int YZ = A.Y * A.Z, W = pl.wmax * YZ, H = W + 2 * YZ;
    c = reinterpret_cast<T*>(raw);
    b = c + 27 * W;
    wd = b + H;
    xa = wd + H;
    xb = xa + H;
    r = xb + H;
    sa = r + W + 4 * YZ;
    sb = sa + pl.cmax * YZ;
    xc = sb + pl.cmax * C.Y * A.Z;
    nb = reinterpret_cast<unsigned*>(xc + pl.pmax * C.Y * C.Z);
  }
};

// Stores v, the value at point jk of plane i of A, into the halo of every
// slab rank of `cl` other than `rank` that holds plane i in a halo of h
// planes each side: into `buf` of that rank, laid out from its plane f0 -
// h (DSMEM stores).
template <typename T>
__device__ __forceinline__ void push_halo(cooperative_groups::cluster_group& cl,
                                          const ClusterPlan& pl, int rank,
                                          T* buf, int h, int i, int jk,
                                          int YZ, T v) {
  for (int d = -h; d <= h; ++d) {
    const int s = rank + d;
    if (d == 0 || s < 1 || s >= pl.ranks) continue;
    const int a = pl.f0[s], e = pl.f0[s + 1];
    if ((i >= a - h && i < a) || (i >= e && i < e + h)) {
      cl.map_shared_rank(buf, s)[(i - a + h) * YZ + jk] = v;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kTailThreads<T>, 1)
cluster_tail_kernel(const T* __restrict__ b, const T* __restrict__ CA,
                    const T* __restrict__ wdA,
                    const unsigned* __restrict__ words,
                    const int* __restrict__ itabA,
                    const T* __restrict__ wtabA, const T* __restrict__ Cp,
                    const unsigned char* __restrict__ Fp,
                    const int* __restrict__ itab, const T* __restrict__ wtab,
                    T* __restrict__ x, const __grid_constant__ TailMeta m,
                    const __grid_constant__ TailMeta ma,
                    const __grid_constant__ ClusterPlan pl, int word_stride,
                    int free_stride, int nu, T omega, int iters) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  TailClock ck;
  const int rank = (int)cluster.block_rank();
  const bool tail_rank = rank == 0;
  const long long lane = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;
  const TailLevel A = ma.lv[0], Ct = ma.lv[1];
  const TailTransfer& tr = ma.tr[0];
  const int Y = A.Y, Z = A.Z, YZ = Y * Z;
  const TailSmem<T> tsm(s_raw, m);       // the tail rank's layout
  const SlabSmem<T> ssm(s_raw, ma, pl);  // a slab rank's
  // a slab rank's planes [f0, f1) of A: W points from A's point lo
  const int f0 = tail_rank ? 0 : pl.f0[rank];
  const int f1 = tail_rank ? 0 : pl.f0[rank + 1];
  const int W = (f1 - f0) * YZ, lo = f0 * YZ, Wst = pl.wmax * YZ;
  T* out = x + lane * A.G + lo;
  const FastDiv by_yz(YZ);
  // x' (or a sweep of x) at the slab's point q: into xout past its halo,
  // the halos of the neighbours on a boundary plane, or into out
  const auto put = [&](T* xout, int q, T v, bool last) {
    if (last) {
      out[q] = v;
      return;
    }
    xout[YZ + q] = v;
    if (q < YZ || q >= W - YZ) {
      const int i = by_yz.div(q);
      push_halo(cluster, pl, rank, xout, 1, f0 + i, q - i * YZ, YZ, v);
    }
  };
  // one damped-Jacobi sweep on the slab from xin into xout, or into out
  const auto sweep = [&](const T* xin, T* xout, bool last) {
    const T* xv = xin + YZ;
    for (int q = tid; q < W; q += nt) {
      const unsigned nb = ssm.nb[q];
      const T xq = xv[q];
      const T ax = (nb & kCgFree) ? apply_point(ssm.c, xv, nb, q, Wst, Y, Z)
                                  : xq;
      put(xout, q, add_rn(xq, mul_rn(ssm.wd[YZ + q],
                                     sub_rn(ssm.b[YZ + q], ax))), last);
    }
  };

  // staging: the tail rank its tail; a slab rank b and wd with their halo
  // and its words, then x = wd b there, its planes of A landing meanwhile
  if (tail_rank) {
    tail_stage(tsm, m, Cp + lane * 27 * m.points, Fp + lane * free_stride,
               omega);
  } else {
    const int h0 = max(f0 - 1, 0) * YZ, h1 = min(f1 + 1, A.X) * YZ;
    for (int p = h0 + tid; p < h1; p += nt) {
      const int at = p - lo + YZ;
      cp_async_elem(ssm.b + at, b + lane * A.G + p);
      cp_async_elem(ssm.wd + at, wdA + lane * A.G + p);
    }
    for (int q = tid; q < W; q += nt) {
      cp_async_elem(ssm.nb + q, words + lane * word_stride + lo + q);
    }
    cp_async_commit();
    const T* cA = CA + lane * 27 * A.G + lo;
    for (int o = 0; o < 27; ++o) {
      for (int q = tid; q < W; q += nt) {
        cp_async_elem(ssm.c + o * Wst + q, cA + (long long)o * A.G + q);
      }
    }
    cp_async_commit();
    cp_async_wait_group<1>();
    __syncthreads();
    for (int p = h0 + tid; p < h1; p += nt) {
      const int at = p - lo + YZ;
      ssm.xa[at] = mul_rn(ssm.wd[at], ssm.b[at]);
    }
  }
  cluster.sync();  // every block has started: DSMEM may be used from here
  ck.mark(kClkCluster);
  if (!tail_rank) {
    cp_async_wait_group<0>();  // the planes of A
    __syncthreads();
  }
  T* xcur = ssm.xa;
  T* xoth = ssm.xb;
  for (int s = 1; s < nu; ++s) {  // the pre-sweeps
    if (!tail_rank) sweep(xcur, xoth, false);
    cluster.sync();
    T* t = xcur;
    xcur = xoth;
    xoth = t;
  }
  ck.mark(kClkCluster + 1);
  if (!tail_rank) {  // the residual, and its halo of two planes
    const T* xv = xcur + YZ;
    for (int q = tid; q < W; q += nt) {
      const unsigned nb = ssm.nb[q];
      const T ax = (nb & kCgFree) ? apply_point(ssm.c, xv, nb, q, Wst, Y, Z)
                                  : xv[q];
      const T v = sub_rn(ssm.b[YZ + q], ax);
      ssm.r[2 * YZ + q] = v;
      if (q < 2 * YZ || q >= W - 2 * YZ) {
        const int i = by_yz.div(q);
        push_halo(cluster, pl, rank, ssm.r, 2, f0 + i, q - i * YZ, YZ, v);
      }
    }
  }
  cluster.sync();
  ck.mark(kClkCluster + 2);
  if (!tail_rank) {  // the restriction, into the tail rank's b
    const int c0 = pl.c0[rank], cn = pl.c0[rank + 1] - c0;
    const int K0 = tr.K[0], K1 = tr.K[1], K2 = tr.K[2];
    const int* i0 = itabA + tr.ioff[0] + A.X;
    const T* w0 = wtabA + tr.woff[0] + 2 * A.X;
    const T* rl = ssm.r + (2 - f0) * YZ;  // r at A's plane i: rl[i YZ + jk]
    for (int p = tid; p < cn * YZ; p += nt) {  // pass 0: (cn, Y, Z)
      const int cl = by_yz.div(p), jk = p - cl * YZ, c = c0 + cl;
      const int* ix = i0 + c * K0;
      const T* w = w0 + c * K0;
      T acc = mul_rn(rl[ix[0] * YZ + jk], w[0]);
      for (int e = 1; e < K0; ++e) {
        acc = add_rn(acc, mul_rn(rl[ix[e] * YZ + jk], w[e]));
      }
      ssm.sa[p] = acc;
    }
    __syncthreads();
    const int* i1 = itabA + tr.ioff[1] + Y;
    const T* w1 = wtabA + tr.woff[1] + 2 * Y;
    const FastDiv by_z(Z), by_cy(Ct.Y);
    for (int p = tid; p < cn * Ct.Y * Z; p += nt) {  // pass 1: (cn, Yc, Z)
      const int q = by_z.div(p), k = p - q * Z;
      const int cl = by_cy.div(q), c = q - cl * Ct.Y;
      const T* in = ssm.sa + cl * YZ + k;
      const int* ix = i1 + c * K1;
      const T* w = w1 + c * K1;
      T acc = mul_rn(in[ix[0] * Z], w[0]);
      for (int e = 1; e < K1; ++e) {
        acc = add_rn(acc, mul_rn(in[ix[e] * Z], w[e]));
      }
      ssm.sb[p] = acc;
    }
    __syncthreads();
    const int* i2 = itabA + tr.ioff[2] + Z;
    const T* w2 = wtabA + tr.woff[2] + 2 * Z;
    const unsigned char* fc = Fp + lane * free_stride;  // level t's free
    T* bt = cluster.map_shared_rank(tsm.bs, 0);
    const FastDiv by_cz(Ct.Z);
    for (int p = tid; p < cn * Ct.Y * Ct.Z; p += nt) {  // pass 2, masked
      const int q = by_cz.div(p), c = p - q * Ct.Z;
      const T* in = ssm.sb + q * Z;
      const int* ix = i2 + c * K2;
      const T* w = w2 + c * K2;
      T acc = mul_rn(in[ix[0]], w[0]);
      for (int e = 1; e < K2; ++e) acc = add_rn(acc, mul_rn(in[ix[e]], w[e]));
      const int at = c0 * Ct.Y * Ct.Z + p;
      bt[at] = fc[at] != 0 ? acc : T(0);
    }
  }
  cluster.sync();
  ck.mark(kClkCluster + 3);
  if (tail_rank) tail_run(tsm, m, itab, wtab, nu, iters, ck);
  cluster.sync();
  if (!tail_rank) {  // x' = x + P xc on the slab
    const int* sx = itabA + tr.ioff[0];
    const int a = sx[f0], cnt = (sx[f1 - 1] + 2 - a) * Ct.Y * Ct.Z;
    if (cnt > pl.pmax * Ct.Y * Ct.Z) __trap();  // not the plan's coarsening
    const T* xt = cluster.map_shared_rank(tsm.xs, 0) + a * Ct.Y * Ct.Z;
    for (int e = tid; e < cnt; e += nt) ssm.xc[e] = xt[e];
    __syncthreads();
    const T* w0 = wtabA + tr.woff[0];
    const T* w1 = wtabA + tr.woff[1];
    const T* w2 = wtabA + tr.woff[2];
    const FastDiv by_y(Y), by_z(Z);
    for (int q = tid; q < W; q += nt) {
      int i, j, k;
      ijk_fast(q, Y, Z, by_y, by_z, &i, &j, &k);
      i += f0;
      const T p = prolong_value(
          [&](int cx, int cy, int cz) {
            return ssm.xc[((cx - a) * Ct.Y + cy) * Ct.Z + cz];
          },
          sx[i], itabA[tr.ioff[1] + j], itabA[tr.ioff[2] + k], w0[i],
          w0[A.X + i], w1[j], w1[Y + j], w2[k], w2[Z + k]);
      put(xcur, q, add_rn(xcur[YZ + q], p), nu == 0);
    }
  }
  cluster.sync();
  ck.mark(kClkCluster + 4);
  for (int s = 0; s < nu; ++s) {  // the post-sweeps; the last writes x
    if (!tail_rank) sweep(xcur, xoth, s == nu - 1);
    cluster.sync();  // also: no block leaves while a neighbour reads it
    T* t = xcur;
    xcur = xoth;
    xoth = t;
  }
  ck.mark(kClkCluster + 5);
  ck.store();
}

// ── the levels above the tail ────────────────────────────────────────────
//
// Kernel 1's work at a V-cycle level above the tail, with the smoothing,
// residual and transfers around it, one launch a phase.  It replaces
// kernel 1 (stencil_spmv_flat) at the levels that cycle_impl
// (pelvistim_fem_tpu/ops/multigrid.py:425-460) runs as XLA fusions below
// FLAT_MIN_NODES, where XLA fuses the stencil with the smoothing around it;
// run op by op, such a level took ~70 launches a V-cycle (kernel 1 five
// times, the where/sub/mul/add of the sweeps, three axes of K
// index_selects, multiplies and adds a transfer), at the launch floor.
// Now a level takes 5 at nu = 2 ("sweep0", "residual", restrict,
// "prolong_sweep", "sweep"):
//   level_apply_kernel   one mode a launch: a damped-Jacobi sweep x + wd (b
//                        - op(x)); the first two sweeps from x = 0 (x and
//                        its neighbours formed as wd b on the fly); the
//                        residual b - op(x); op(x) alone (the CG's fine-level
//                        operator); op(x) = free ? K xm : x, xm = free ? x : 0
//   level_prolong_sweep_kernel
//                        the mode "prolong_sweep": a sweep on x + P xc, the
//                        prolongation formed in a tile of shared memory
//   restrict_kernel      R r masked by the coarse level's free, the three
//                        axis passes on a tile of shared memory
//   prolong_add_kernel   x + P xc, a thread a unit of 2 x 2 x 1 fine points
//                        (the body-factored levels, and nu = 0)
// level_apply_kernel takes one thread a point; the level kernels take
// lanes on blockIdx.y, 32-bit indices (the launchers
// refuse S * 27 * G past INT_MAX).  Each point's neighbour word is made once
// a hierarchy: bit o set where the neighbour along offset o lies in the grid
// AND is free, bit 31 where the point is free; so a neighbour read is one
// bit test, no bounds tests, and the masked copy xm is never written: a
// neighbour that is not free reads 0, as it reads 0 from xm.  wd = omega /
// diag is made once too.  The arithmetic is the route's bit for bit: the
// apply is kernel 1's fma chain (apply_with), the rest PyTorch's single
// roundings in its operand order (add_rn etc., as in the tail), the
// transfers' partial sums per axis pass as restrict_axis / prolong_axis
// form them.  Bound by device memory where the level is large
// (27 planes and a few vectors a point; warm in the 50 MB L2 on the path),
// by the launch at the small levels: the design's gain is the ~65 launches
// a level and V-cycle it removes.
#ifndef PST_LEVEL_THREADS
#define PST_LEVEL_THREADS 256
#endif

enum LevelMode {
  kSweep = 0,
  kSweep0 = 1,
  kResidual = 2,
  kMasked = 3,
  kProlongSweep = 4  // level_prolong_sweep_kernel
};

template <typename T, int Mode>
__global__ void __launch_bounds__(PST_LEVEL_THREADS)
level_apply_kernel(const T* __restrict__ x, const T* __restrict__ b,
                   const T* __restrict__ C, const T* __restrict__ wd,
                   const unsigned* __restrict__ words, T* __restrict__ y,
                   int word_stride, int X, int Y, int Z) {
  const int G = X * Y * Z;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= G) return;
  const int off = blockIdx.y * G;
  x += off;
  b += off;
  wd += off;
  y += off;
  C += 27 * off;
  const unsigned nb = words[blockIdx.y * word_stride + q];
  const bool f = (nb & kCgFree) != 0u;
  if constexpr (Mode == kSweep0) {  // x = wd b, then one sweep
    const auto x0 = [b, wd](int n) { return mul_rn(wd[n], b[n]); };
    const T xq = x0(q);
    const T ax = f ? apply_with(C, nb, q, G, Y, Z, x0) : xq;
    y[q] = add_rn(xq, mul_rn(wd[q], sub_rn(b[q], ax)));
  } else {
    const T xq = x[q];
    const T ax = f ? apply_with(C, nb, q, G, Y, Z, [x](int n) { return x[n]; })
                   : xq;
    if constexpr (Mode == kSweep) {
      y[q] = add_rn(xq, mul_rn(wd[q], sub_rn(b[q], ax)));
    } else if constexpr (Mode == kResidual) {
      y[q] = sub_rn(b[q], ax);
    } else {
      y[q] = ax;
    }
  }
}

// rc = free_c ? R r : 0 of lane blockIdx.y, m the layout of a two-level
// tail (the fine level, the coarse level, the transfer's tables as
// vcycle_tail_kernel reads them), the three axis passes of restrict_axis
// one after another on a tile of coarse points in shared memory:
//   * A block takes a tile of coarse points of one lane (RsTile: the small
//     or the large tile by the grid's size, PST_RS_LARGE_BLOCKS; Z cut
//     evenly into tiles of at most PST_RS_TZ; the last tiles along x and
//     y cut by the grid's end).  Every table entry of coarse knot c lies
//     in [2 c - 2, 2 c + 2] along its axis (the every-other-knot
//     coarsening of multigrid.Transfer, whose kernel tables point each
//     padding entry at its row's last real entry and check this:
//     _kernel_restrict_idx), so the tile's fine footprint is at most 2 t +
//     3 knots an axis for t coarse ones (RsTile::foot).  The block copies
//     that footprint of r into shared memory by cp.async, coalesced along
//     z, with the tile's rows of the three tables, all in flight at once.
//   * Then the passes in the route's order (restrict_axes), each value
//     formed once a block by one thread, acc = in_0 wt_0, then acc +
//     in_k wt_k in k order, a barrier between passes: pass 0 (footprint
//     -> tile along x) into a second buffer, pass 1 (y) back into the
//     first, pass 2 (z) masked into rc.  Each intermediate value is the
//     one restrict_axes forms, so the result is the route's bit for bit.
//     A value's coordinates in the tile come by FastDiv.
// Bound by the launch and one round trip to device memory at the small
// levels (then a chain of K <= 6 dependent adds a pass), by device memory
// at the lane-stacked ones (r read once, the footprints' overlap from L2).
constexpr int kLevelMaxK = 6;  // restriction entries a coarse knot at most

#ifndef PST_RS_SMALL_TX
#define PST_RS_SMALL_TX 2
#endif
#ifndef PST_RS_SMALL_TY
#define PST_RS_SMALL_TY 4
#endif
#ifndef PST_RS_LARGE_TX
#define PST_RS_LARGE_TX 4
#endif
#ifndef PST_RS_LARGE_TY
#define PST_RS_LARGE_TY 8
#endif
#ifndef PST_RS_TZ
#define PST_RS_TZ 16
#endif
#ifndef PST_RS_THREADS
#define PST_RS_THREADS 256
#endif
// The large tile where its grid has this many blocks (lanes included, two
// an SM), the small one below: fewer, larger tiles stage less of r again
// at the lane-stacked levels; small tiles give a small level enough
// blocks.
#ifndef PST_RS_LARGE_BLOCKS
#define PST_RS_LARGE_BLOCKS 264
#endif

// A tile of TX x TY x (at most) PST_RS_TZ coarse points: the coarse points
// along axis a, their fine footprint at most, the first of axis a's rows
// in the block's table buffers, and the block's buffers.
template <int TX, int TY>
struct RsTile {
  __host__ __device__ static constexpr int tile(int a) {
    return a == 0 ? TX : a == 1 ? TY : PST_RS_TZ;
  }
  __host__ __device__ static constexpr int foot(int a) {
    return 2 * tile(a) + 3;
  }
  __host__ __device__ static constexpr int row(int a) {
    return a == 0 ? 0 : a == 1 ? TX : TX + TY;
  }
  static constexpr int kIn = foot(0) * foot(1) * foot(2);  // r; pass 1's
  static constexpr int kMid = TX * foot(1) * foot(2);      // pass 0's
  static constexpr int kEntries = (TX + TY + PST_RS_TZ) * kLevelMaxK;
  // dynamic shared memory, T values then ints
  template <typename T>
  static constexpr int smem() {
    return (kIn + kMid + kEntries) * (int)sizeof(T) + kEntries * 4;
  }
};

template <typename T, int TX, int TY>
__global__ void __launch_bounds__(PST_RS_THREADS)
restrict_kernel(const T* __restrict__ r, const int* __restrict__ itab,
                const T* __restrict__ wtab,
                const unsigned char* __restrict__ free_c, T* __restrict__ rc,
                int free_stride, const __grid_constant__ TailMeta m, int tz) {
  using Tile = RsTile<TX, TY>;
  extern __shared__ __align__(16) unsigned char s_raw[];
  T* s_in = reinterpret_cast<T*>(s_raw);
  T* s_mid = s_in + Tile::kIn;
  T* s_w = s_mid + Tile::kMid;
  int* s_i = reinterpret_cast<int*>(s_w + Tile::kEntries);
  const TailLevel F = m.lv[0], Cl = m.lv[1];
  const TailTransfer& tr = m.tr[0];
  const int nf[3] = {F.X, F.Y, F.Z}, nc[3] = {Cl.X, Cl.Y, Cl.Z};
  // the tile (x slowest; tz <= PST_RS_TZ along z), its coarse rows c0[a]
  // + [0, n[a]) and their fine footprint lo[a] + [0, f[a])
  const int t1 = (Cl.Y + Tile::tile(1) - 1) / Tile::tile(1);
  const int t2 = (Cl.Z + tz - 1) / tz;
  const int tile[3] = {(int)blockIdx.x / (t1 * t2),
                       (int)blockIdx.x / t2 % t1, (int)blockIdx.x % t2};
  const int step[3] = {Tile::tile(0), Tile::tile(1), tz};
  int c0[3], n[3], lo[3], f[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    c0[a] = tile[a] * step[a];
    n[a] = min(step[a], nc[a] - c0[a]);
    lo[a] = max(0, 2 * c0[a] - 2);
    f[a] = min(nf[a] - 1, 2 * (c0[a] + n[a] - 1) + 2) - lo[a] + 1;
  }
  // the coarse mask of this thread's first output, read first
  const int tid = threadIdx.x, nt = blockDim.x;
  const FastDiv by_n1(n[1]), by_n2(n[2]);
  const auto out_at = [&](int p, int* ij, int* c) {
    *ij = by_n2.div(p);
    *c = p - *ij * n[2];
    const int i = by_n1.div(*ij), j = *ij - i * n[1];
    return ((c0[0] + i) * Cl.Y + c0[1] + j) * Cl.Z + c0[2] + *c;
  };
  free_c += blockIdx.y * free_stride;
  bool free_first = false;
  if (tid < n[0] * n[1] * n[2]) {
    int ij, c;
    free_first = free_c[out_at(tid, &ij, &c)] != 0;
  }
  r += blockIdx.y * F.G;
  // the tile's rows of the tables, axis a's from row Tile::row(a)
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int K = tr.K[a];
    for (int e = tid; e < n[a] * K; e += nt) {
      const int c = e / K, at = (c0[a] + c) * K + e % K;
      const int to = (Tile::row(a) + c) * kLevelMaxK + e % K;
      cp_async_elem(s_i + to, itab + tr.ioff[a] + nf[a] + at);
      cp_async_elem(s_w + to, wtab + tr.woff[a] + 2 * nf[a] + at);
    }
  }
  // r's footprint (f0, f1, f2), z fastest
  const int plane = f[1] * f[2];
  const FastDiv by_plane(plane), by_f2(f[2]);
  for (int e = tid; e < f[0] * plane; e += nt) {
    const int i = by_plane.div(e), jk = e - i * plane;
    const int j = by_f2.div(jk), k = jk - j * f[2];
    cp_async_elem(s_in + e,
                  r + ((lo[0] + i) * F.Y + lo[1] + j) * F.Z + lo[2] + k);
  }
  cp_async_wait_block();
  // one axis's sum at a value: in(v) the input at footprint index v, (ix,
  // w) the coarse knot's row
  const auto pass = [](const int* ix, const T* w, int K, int lo_a,
                       auto in) {
    T acc = mul_rn(in(ix[0] - lo_a), w[0]);
#pragma unroll
    for (int e = 1; e < kLevelMaxK; ++e) {
      if (e < K) acc = add_rn(acc, mul_rn(in(ix[e] - lo_a), w[e]));
    }
    return acc;
  };
  // pass 0: (n0, f1, f2) from (f0, f1, f2)
  for (int p = tid; p < n[0] * plane; p += nt) {
    const int c = by_plane.div(p), jk = p - c * plane;
    s_mid[p] = pass(s_i + c * kLevelMaxK, s_w + c * kLevelMaxK, tr.K[0],
                    lo[0], [&](int v) { return s_in[v * plane + jk]; });
  }
  __syncthreads();
  // pass 1: (n0, n1, f2) from (n0, f1, f2)
  for (int p = tid; p < n[0] * n[1] * f[2]; p += nt) {
    const int ic = by_f2.div(p), k = p - ic * f[2];
    const int i = by_n1.div(ic), c = ic - i * n[1];
    const int row = (Tile::row(1) + c) * kLevelMaxK;
    const T* in = s_mid + i * plane + k;
    s_in[p] = pass(s_i + row, s_w + row, tr.K[1], lo[1],
                   [&](int v) { return in[v * f[2]]; });
  }
  __syncthreads();
  // pass 2: (n0, n1, n2) from (n0, n1, f2), masked, into rc
  rc += blockIdx.y * Cl.G;
  for (int p = tid; p < n[0] * n[1] * n[2]; p += nt) {
    int ij, c;
    const int q = out_at(p, &ij, &c);
    const int row = (Tile::row(2) + c) * kLevelMaxK;
    const T* in = s_in + ij * f[2];
    const T acc = pass(s_i + row, s_w + row, tr.K[2], lo[2],
                       [&](int v) { return in[v]; });
    rc[q] = (p == tid ? free_first : free_c[q] != 0) ? acc : T(0);
  }
}

// The separable prolongation on a unit of 2 x 2 x 1 fine points, in
// registers: P xc at (2 a + dx, 2 b + dy, k), dx, dy in {0, 1} (the fine
// knots 2 a and 2 a + 1 share their slot along x, 2 b and 2 b + 1 along
// y), formed one axis at a time in prolong_axes' order (x, then y, then
// z), each value in_s wl + in_(s+1) wr: pass 0 2 x 4 values from the
// unit's 2 x 2 x 2 coarse footprint, pass 1 2 x 2 x 2, pass 2 2 x 2.  The
// slot of fine knot f is min(f / 2, nc - 2) (the every-other-knot
// coarsening of multigrid.Transfer, which _kernel_restrict_idx checks
// wherever TransferTables are made), so the footprint's address needs no
// table read; the weights are the tables' (wl[f], then wr[f] nf entries
// on).  A point past the grid's end (the second of a pair on an odd grid)
// is formed from the last knot's weights, for the caller to drop.  Each
// intermediate value is the one prolong_axes forms and prolong_value
// forms a point at a time, so the result is the route's bit for bit; the
// unit forms 4 points with 8 coarse reads and 20 values where
// prolong_value takes 8 reads and 7 values a point.
template <typename T>
__device__ __forceinline__ void prolong_unit(const T* __restrict__ xc,
                                             const T* __restrict__ wtab,
                                             const TailTransfer& tr,
                                             const TailLevel& F,
                                             const TailLevel& Cl, int a,
                                             int b, int k, T out[2][2]) {
  const int sx = min(a, Cl.X - 2), sy = min(b, Cl.Y - 2),
            sz = min(k / 2, Cl.Z - 2);
  const T* wx = wtab + tr.woff[0];
  const T* wy = wtab + tr.woff[1];
  const T* wz = wtab + tr.woff[2];
  T lx[2], rx[2], ly[2], ry[2];
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const int i = min(2 * a + d, F.X - 1), j = min(2 * b + d, F.Y - 1);
    lx[d] = wx[i];
    rx[d] = wx[F.X + i];
    ly[d] = wy[j];
    ry[d] = wy[F.Y + j];
  }
  const T lz = wz[k], rz = wz[F.Z + k];
  const T* c = xc + (sx * Cl.Y + sy) * Cl.Z + sz;
  T v[2][2][2];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    v[e >> 2][e >> 1 & 1][e & 1] =
        c[((e >> 2) * Cl.Y + (e >> 1 & 1)) * Cl.Z + (e & 1)];
  }
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    T p0[2][2];  // pass 0: along x, at the coarse (cy, cz)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p0[e >> 1][e & 1] = add_rn(mul_rn(v[0][e >> 1][e & 1], lx[d]),
                                 mul_rn(v[1][e >> 1][e & 1], rx[d]));
    }
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      T p1[2];  // pass 1: along y, at the coarse cz
#pragma unroll
      for (int z = 0; z < 2; ++z) {
        p1[z] = add_rn(mul_rn(p0[0][z], ly[f]), mul_rn(p0[1][z], ry[f]));
      }
      out[d][f] = add_rn(mul_rn(p1[0], lz), mul_rn(p1[1], rz));  // pass 2
    }
  }
}

// y = x + P xc of lane blockIdx.y (layout as restrict_kernel's), a thread
// a unit of 2 x 2 x 1 fine points (prolong_unit), consecutive threads on
// consecutive z, so that each of the unit's four x reads and y writes is
// coalesced along z; the unit's 8 coarse reads and 12 weights come
// through L1 (neighbouring threads share them), all issued at once.  It
// replaces the form with a thread a point (8 coarse reads, 6 table reads
// and 21 roundings a point, each point's coarse addresses waiting on its
// slots' reads) and was measured against a form with a tile's coarse
// footprint and three axis passes in shared memory, which was slower than
// the point-wise form at every path shape (its block's staging, passes
// and barriers run in series; PERF.md).  Bound by device memory at the
// lane-stacked levels (x read, y written, xc from L2), by the launch at
// the small ones.  64 threads a block at every grid: at the paths' eight
// shapes 256 threads, or 256 from two blocks an SM up, took as long or
// longer (PERF.md).
constexpr int kPaThreads = 64;

template <typename T>
__global__ void __launch_bounds__(kPaThreads)
prolong_add_kernel(const T* __restrict__ x, const T* __restrict__ xc,
                   const T* __restrict__ wtab, T* __restrict__ y,
                   const __grid_constant__ TailMeta m) {
  const TailLevel F = m.lv[0], Cl = m.lv[1];
  const int by = (F.Y + 1) / 2;
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= (F.X + 1) / 2 * by * F.Z) return;
  x += blockIdx.y * F.G;
  y += blockIdx.y * F.G;
  xc += blockIdx.y * Cl.G;
  const int ab = u / F.Z, k = u - ab * F.Z;
  const int a = ab / by, b = ab - a * by;
  const int YZ = F.Y * F.Z, q = (2 * a * F.Y + 2 * b) * F.Z + k;
  const bool hx = 2 * a + 1 < F.X, hy = 2 * b + 1 < F.Y;
  T xv[2][2];
  xv[0][0] = x[q];
  if (hy) xv[0][1] = x[q + F.Z];
  if (hx) xv[1][0] = x[q + YZ];
  if (hx && hy) xv[1][1] = x[q + YZ + F.Z];
  T p[2][2];
  prolong_unit(xc, wtab, m.tr[0], F, Cl, a, b, k, p);
  y[q] = add_rn(xv[0][0], p[0][0]);
  if (hy) y[q + F.Z] = add_rn(xv[0][1], p[0][1]);
  if (hx) y[q + YZ] = add_rn(xv[1][0], p[1][0]);
  if (hx && hy) y[q + YZ + F.Z] = add_rn(xv[1][1], p[1][1]);
}

// level_apply's mode "prolong_sweep" (kProlongSweep): the prolongation
// and its add folded into the first post-smoothing sweep,
//   y = x' + wd (b - op(x')),  x' = x + P xc,
// op as level_apply_kernel's, x' formed by the separable passes in
// prolong_axes' order (the values prolong_add_kernel's units form), so y
// is prolong_add then "sweep" bit for bit; P xc is never written to
// device memory and read back, and the level's V-cycle takes one launch
// fewer.  A block takes a tile of PST_PS_TX x ty x tz points of one lane,
// one point a thread (prolong_sweep_tile: tz <= PST_PS_TZ cuts Z evenly,
// ty fills the block), in one round trip to device memory:
//   * Each thread first loads its point's 27 coefficients, word, b and wd
//     into registers; meanwhile the block copies by cp.async, coalesced
//     along z, x on the tile and its halo of one point (clipped to the
//     grid), the coarse footprint of xc that the halo's interpolation
//     reads (the slot of fine knot f is min(f / 2, nc - 2), the
//     every-other-knot coarsening of multigrid.Transfer, which
//     _kernel_restrict_idx checks) and the halo's slots and weights.
//   * Then x' on the tile and halo, in shared memory, a pair of fine
//     knots along z a thread (the two share their slot: passes 0 and 1
//     once for both, pass 2 and the add a point), and each point's apply,
//     kernel 1's fma chain in its order on its registers' coefficients
//     and its neighbours' x' (0 for a neighbour that is not free, as the
//     neighbour words say), the sweep in PyTorch's roundings.
// Bound as "sweep" is: by device memory at the megatet's fine level, by
// the launch and the round trip at the small levels.  The halo's x' is
// bound by its latency, not its operations: x' a point a thread
// (prolong_value) took up to 13% more, and the forms with fewer
// operations but a longer chain a thread (three passes with two more
// barriers; runs along z) took 2-20% more (PERF.md).  (The form without
// shared memory, x' of each neighbour formed on the fly, a thread a
// point, took 1.2-2.2x the time.)
#ifndef PST_PS_TX
#define PST_PS_TX 2
#endif
#ifndef PST_PS_TZ
#define PST_PS_TZ 32
#endif
#ifndef PST_PS_THREADS
#define PST_PS_THREADS 128
#endif
static_assert(PST_PS_THREADS % 32 == 0 &&
                  PST_PS_TX * PST_PS_TZ <= PST_PS_THREADS,
              "a prolong_sweep block is whole warps, a point a thread");

// The prolong_sweep tile of a grid's (Y, Z): Z cut evenly into tiles of
// at most PST_PS_TZ points, ty as many rows as the block's threads hold.
inline void prolong_sweep_tile(int Y, int Z, int* ty, int* tz) {
  const int ntz = (Z + PST_PS_TZ - 1) / PST_PS_TZ;
  *tz = (Z + ntz - 1) / ntz;
  const int rows = PST_PS_THREADS / (PST_PS_TX * *tz);
  *ty = rows < 1 ? 1 : (rows < Y ? rows : Y);
}

// Shared memory of a prolong_sweep block with tile (ty, tz): the halo's
// x' (tile + 2 an axis), the coarse footprint (at most h / 2 + 3 an axis
// for a halo of h), the halo's slots, left and right weights an axis.
struct PsSmem {
  int h[3], c[3];
  __host__ __device__ PsSmem(int ty, int tz)
      : h{PST_PS_TX + 2, ty + 2, tz + 2},
        c{h[0] / 2 + 3, h[1] / 2 + 3, h[2] / 2 + 3} {}
  __host__ __device__ int values() const {
    return h[0] * h[1] * h[2] + c[0] * c[1] * c[2] + 2 * (h[0] + h[1] + h[2]);
  }
  __host__ __device__ int bytes(int elem) const {
    return values() * elem + 4 * (h[0] + h[1] + h[2]);
  }
};

template <typename T>
__global__ void __launch_bounds__(PST_PS_THREADS)
level_prolong_sweep_kernel(const T* __restrict__ x, const T* __restrict__ xc,
                           const T* __restrict__ b, const T* __restrict__ C,
                           const T* __restrict__ wd,
                           const unsigned* __restrict__ words,
                           const int* __restrict__ itab,
                           const T* __restrict__ wtab, T* __restrict__ y,
                           int word_stride, const __grid_constant__ TailMeta m,
                           int ty, int tz) {
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
  // the thread's point, its loads first
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
  // the halo [h0, h0 + hn) clipped to the grid (at xs offset h0 - t0 + 1)
  // and its coarse footprint [c0, c0 + cn)
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
  T* wl = xcs + sm.c[0] * sm.c[1] * sm.c[2];  // per axis h[a] left weights,
  T* wr = wl + sm.h[0] + H1 + H2;             // right weights
  int* sl = reinterpret_cast<int*>(wr + sm.h[0] + H1 + H2);  // slots
  const int ho[3] = {0, sm.h[0], sm.h[0] + H1};  // axis a's table offset
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
  // x on the halo (at xs offset h0 - t0 + 1), xc's footprint, z fastest
  const int hp = hn[1] * hn[2], cp = cn[1] * cn[2];
  const FastDiv by_hp(hp), by_hz(hn[2]), by_cp(cp), by_cz(cn[2]);
  // x' a pair of fine knots along z a thread: the halo's pairs m from
  // pz0, npz a column
  const int pz0 = h0[2] >> 1, npz = ((h0[2] + hn[2] - 1) >> 1) - pz0 + 1;
  const int ncol = hn[0] * hn[1];
  const FastDiv by_col(ncol), by_hy(hn[1]);
  const int ho0 = ((h0[0] - t0[0] + 1) * H1 + h0[1] - t0[1] + 1) * H2 +
                  h0[2] - t0[2] + 1;
  for (int e = tid; e < hn[0] * hp; e += nt) {
    const int i = by_hp.div(e), jk = e - i * hp;
    const int j = by_hz.div(jk), k = jk - j * hn[2];
    cp_async_elem(xs + ho0 + (i * H1 + j) * H2 + k,
                  x + ((h0[0] + i) * F.Y + h0[1] + j) * F.Z + h0[2] + k);
  }
  for (int e = tid; e < cn[0] * cp; e += nt) {
    const int i = by_cp.div(e), jk = e - i * cp;
    const int j = by_cz.div(jk), k = jk - j * cn[2];
    cp_async_elem(xcs + e,
                  xc + ((c0[0] + i) * Cl.Y + c0[1] + j) * Cl.Z + c0[2] + k);
  }
  cp_async_wait_block();
  // x' = x + P xc on the halo, in place, a pair of fine knots along z a
  // thread (2 m and 2 m + 1, which share their slot; cut by the halo's
  // ends), consecutive threads on consecutive columns (i, j): pass 0
  // along x at the pair's 2 x 2 coarse (cy, cz), pass 1 along y at its
  // two cz, then pass 2 along z and the add at each of its points.
  for (int t = tid; t < ncol * npz; t += nt) {
    const int mz = by_col.div(t), col = t - mz * ncol;
    const int i = by_hy.div(col), j = col - i * hn[1];
    const int ix = ho[0] + i, iy = ho[1] + j;
    const int f0 = max(2 * (pz0 + mz), h0[2]);
    const bool two = f0 < min(2 * (pz0 + mz) + 1, h0[2] + hn[2] - 1);
    const int k0 = f0 - h0[2], iz = ho[2] + k0;
    T* at = xs + ho0 + (i * H1 + j) * H2 + k0;
    const T a0 = at[0], a1 = two ? at[1] : T(0);
    const T lz0 = wl[iz], rz0 = wr[iz];
    const T lz1 = two ? wl[iz + 1] : T(0), rz1 = two ? wr[iz + 1] : T(0);
    const T lx = wl[ix], rx = wr[ix], ly = wl[iy], ry = wr[iy];
    const T* c = xcs + ((sl[ix] - c0[0]) * cn[1] + sl[iy] - c0[1]) * cn[2] +
                 sl[iz] - c0[2];
    const T u0 = add_rn(mul_rn(c[0], lx), mul_rn(c[cp], rx));
    const T u1 = add_rn(mul_rn(c[cn[2]], lx), mul_rn(c[cp + cn[2]], rx));
    const T u2 = add_rn(mul_rn(c[1], lx), mul_rn(c[cp + 1], rx));
    const T u3 =
        add_rn(mul_rn(c[cn[2] + 1], lx), mul_rn(c[cp + cn[2] + 1], rx));
    const T v0 = add_rn(mul_rn(u0, ly), mul_rn(u1, ry));
    const T v1 = add_rn(mul_rn(u2, ly), mul_rn(u3, ry));
    at[0] = add_rn(a0, add_rn(mul_rn(v0, lz0), mul_rn(v1, rz0)));
    if (two) at[1] = add_rn(a1, add_rn(mul_rn(v0, lz1), mul_rn(v1, rz1)));
  }
  __syncthreads();
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
}

// ── kernel 2's work at the levels above the tail ─────────────────────────
//
// level_apply's four modes where the L lanes of a level share body-factored
// coefficients (B, 27, X, Y, Z) and one mask: op(x)_l = free ? sum_o (sum_b
// sig[l, b] C_b[o]) x_l(shift o) : x_l, x_l masked by free.  It replaces
// kernel 2 (batched_stencil_spmv_flat) with the sweep, residual and masks
// around it at the body-factored levels above the tail of _fused_cycle
// (pelvistim_fem_tpu/ops/multigrid.py:797-830, where XLA fuses them around
// batched_stencil_spmv_fused); run op by op there took ~77 launches a level
// and V-cycle (kernel 2 five times, the where/sub/mul/add of the sweeps, the
// transfers' gathers).  Now a level takes 6 at nu = 2: four launches of
// this kernel or of the march below and restrict_kernel and
// prolong_add_kernel, which take lanes on blockIdx.y and the lanes' one
// coarse mask with free_stride 0.
//
// The arithmetic is the route's bit for bit: each lane's coefficient is
// formed as kernel 2 forms it (co = s_0 c_0, then fma(s_b, c_b, co)), the
// sum is kernel 2's acc = fma(co, x, acc) over o in its row / dz order
// (factored_apply), the rest PyTorch's single roundings in the route's
// operand order (level_out).  The neighbour words are level_apply_kernel's,
// one a point, shared by the lanes; wd = omega / diag is made once a solve,
// diag the route's explicit sum over bodies.
//
// Bound by device memory at the fine level: the B * 27 coefficient planes
// (37 MB in f32 at the sweep's (89, 41, 19), 5 bodies) and 2-4 vectors a
// lane (6.9 MB each at 25 lanes).  The coefficients must be read once for
// all lanes: a block's lanes read a point's coefficients from one tile in
// shared memory, as in kernel 2: kernel 2's tiles of P consecutive points
// with all lanes of the slab, persistent blocks, the next tile's
// coefficients copied by cp.async while the current one is computed; x (or
// wd b) from device memory, 27 neighbour reads a point and lane through L1.
// Kernel 2's grid at every level: on a level of few tiles, spreading the
// lanes over more blocks (more slabs of fewer lane groups, or fewer lanes a
// thread) was slower on the card, since every block stages its whole
// coefficient tile.  A variant with the neighbours from shared memory (one
// box of rows a block, its coefficients and its lanes' x over the box and
// its halo copied in, then computed, no copy overlapped) was slower at every
// level and is not kept (PERF.md).

// Kernel 2's apply at one point for a thread's nl <= K lanes (s their sigma
// rows): acc[l] = sum_o co_l(o) v(l, o), co_l(o) = s_l0 c(0, o), then
// fma(s_lb, c(b, o), co), acc = fma(co, v, acc) over the rows (dx, dy) and
// dz in batched_stencil_spmv_kernel's order, each row's 3 x K neighbour
// values loaded first; v(l, o) is read only where bit o of nb is set (the
// neighbour lies in the grid and is free), else 0.
template <typename T, int B, int K, typename Coef, typename Value>
__device__ __forceinline__ void factored_apply(const T (&s)[K][B], int nl,
                                               unsigned nb, Coef coef,
                                               Value value, T (&acc)[K]) {
#pragma unroll
  for (int row = 0; row < 9; ++row) {
    T xv[3][K];
#pragma unroll
    for (int dz = 0; dz < 3; ++dz) {
      const bool ok = (nb >> (row * 3 + dz) & 1u) != 0u;
#pragma unroll
      for (int l = 0; l < K; ++l) {
        xv[dz][l] = (ok && l < nl) ? value(l, row * 3 + dz) : T(0);
      }
    }
#pragma unroll
    for (int dz = 0; dz < 3; ++dz) {
      const int o = row * 3 + dz;
      T c[B];
#pragma unroll
      for (int b = 0; b < B; ++b) c[b] = coef(b, o);
#pragma unroll
      for (int l = 0; l < K; ++l) {
        if (l < nl) {
          T co = s[l][0] * c[0];
#pragma unroll
          for (int b = 1; b < B; ++b) co = fma(s[l][b], c[b], co);
          acc[l] = fma(co, xv[dz][l], acc[l]);
        }
      }
    }
  }
}

// One lane's output at point q from its x, its op(x) ax and the mode
// (level_apply_kernel's epilogue).
template <typename T>
__device__ __forceinline__ T level_out(int mode, T xq, T ax,
                                       const T* __restrict__ b,
                                       const T* __restrict__ wd, int q) {
  if (mode == kResidual) return sub_rn(b[q], ax);
  if (mode == kMasked) return ax;
  return add_rn(xq, mul_rn(wd[q], sub_rn(b[q], ax)));
}

// The sigma rows of a thread's lanes l0 .. l0 + nl - 1 (0 past them).
template <typename T, int B, int K>
__device__ __forceinline__ void load_sigma(T (&s)[K][B],
                                           const T* __restrict__ sig, int l0,
                                           int nl) {
#pragma unroll
  for (int l = 0; l < K; ++l) {
#pragma unroll
    for (int b = 0; b < B; ++b) {
      s[l][b] = l < nl ? sig[(l0 + l) * B + b] : T(0);
    }
  }
}

// Blocks an SM that level_apply_factored_kernel's register use must allow:
// kernel 2's, but one for kSweep0 in f64, whose neighbour values wd b take
// twice the loads (two spilled at 72 registers).
template <typename T, bool kFromZero>
constexpr int factored_min_blocks() {
  return kFromZero && sizeof(T) == 8 ? 1 : Tile<T>::kB2MinBlocks;
}

// batched_stencil_spmv_kernel's blocks and tiles; mode a LevelMode,
// kFromZero for kSweep0 (x and its neighbours formed as wd b).
template <typename T, int B, int K, int P, bool kFromZero>
__global__ void __launch_bounds__(Tile<T>::kB2Threads,
                                  factored_min_blocks<T, kFromZero>())
level_apply_factored_kernel(const T* __restrict__ x, const T* __restrict__ b,
                            const T* __restrict__ coeff,
                            const T* __restrict__ sig,
                            const T* __restrict__ wd,
                            const unsigned* __restrict__ words,
                            T* __restrict__ y, int mode, int L, int X, int Y,
                            int Z) {
  constexpr int kTile = B * 27 * P;
  extern __shared__ __align__(16) unsigned char s_raw[];
  T* tiles = reinterpret_cast<T*>(s_raw);  // two tiles
  const int G = X * Y * Z;
  const int ntiles = (G + P - 1) / P;
  const int l0 = (blockIdx.y * blockDim.y + threadIdx.y) * K;
  const int nl = min(K, L - l0);  // lanes of this thread (<= 0: none)
  T s[K][B];
  load_sigma<T, B, K>(s, sig, l0, nl);
  const auto xval = [x, b, wd](int n) {
    if constexpr (kFromZero) {
      return mul_rn(wd[n], b[n]);
    } else {
      return x[n];
    }
  };

  const int step = gridDim.x;
  int tile = blockIdx.x;
  stage_coeff_tile<T, B, P>(tiles, coeff, G, tile * P);
  for (int it = 0; tile < ntiles; ++it, tile += step) {
    cp_async_wait_block();
    if (tile + step < ntiles) {
      stage_coeff_tile<T, B, P>(
          tiles + ((it + 1) & 1) * kTile, coeff, G, (tile + step) * P);
    }
    const T* s_c = tiles + (it & 1) * kTile + threadIdx.x;
    const int p = tile * P + threadIdx.x;
    if (p >= G || nl <= 0) continue;
    const unsigned nb = words[p];
    const bool f = (nb & kCgFree) != 0u;
    const int q0 = l0 * G + p;
    T acc[K];
#pragma unroll
    for (int l = 0; l < K; ++l) acc[l] = T(0);
    if (f) {
      factored_apply<T, B, K>(
          s, nl, nb, [s_c](int bb, int o) { return s_c[(bb * 27 + o) * P]; },
          [&](int l, int o) { return xval(q0 + l * G + shift(o, Y, Z)); },
          acc);
    }
#pragma unroll
    for (int l = 0; l < K; ++l) {
      if (l < nl) {
        const int q = q0 + l * G;
        const T xq = xval(q);
        y[q] = level_out(mode, xq, f ? acc[l] : xq, b, wd, q);
      }
    }
  }
}

// ── the body-factored levels as a march along axis 0 ────────────────────
//
// level_march_kernel: level_apply_factored's four modes.  A block takes a
// tile of ty rows of (Y, Z), whole along z, for a slab of `lanes` lanes
// over a segment of axis 0, and marches along it a plane at a time:
//   * Shared memory holds a ring of axis-0 planes of the staged operand
//     for the slab's lanes on the tile's rows and a row of halo each side
//     (x; wd b for "sweep0", formed once a point), and two buffers of the
//     plane's coefficient tile (B x 27 x ty x Z).  Whole rows along z: a
//     lane's window of a plane and a coefficient plane's tile are each one
//     contiguous run in device and in shared memory, and a warp's
//     neighbour reads are consecutive words.
//   * While plane i is computed, the copies of the next planes are in
//     flight (cp.async, one element each, issued by every thread: the runs
//     start at odd offsets, no 16-byte copies or TMA): x plane i + 2 (three
//     ring planes in use, four slots), or, for "sweep0", b and wd of plane
//     i + 3 while wd b of plane i + 2 is formed in its slot (five slots, b
//     in the slot and wd beside it), and the coefficients of plane i + 1.
//     One barrier a plane.  (Warps that only issue the copies, behind
//     named barriers, were slower: a warp's 4-byte cp.async issue is bound
//     by how fast device memory drains them, PERF.md.)
//   * The coefficients are read from device memory once a block and
//     plane for all the slab's lanes; each x value once a plane, its 26
//     neighbours' reads from shared memory.
//   * A thread takes one point of the tile and K lanes (march_lanes,
//     kernel 2's: its K * B sigma values in registers), and keeps kernel
//     2's fma order (factored_apply) and level_out's epilogue, so every
//     mode repeats the route bit for bit.
// The plan (rows, lanes a block, segment) comes from the caller
// (stencil_kernels.march_plan), checked here against the same formulas
// (MarchSmem, march_lanes).  Bound by device memory: the coefficients
// once and 2-4 vectors a lane; the halo rows and the segments' end
// planes are read again from L2.
enum MarchStage { kStageX = 0, kStageWdB = 1 };
// Most threads a march block, by dtype: with two blocks an SM, the
// registers the unrolled apply needs without spilling (f32 at 320, f64 at
// 256; at 384 both spilled).
template <typename T>
constexpr int kMarchMaxThreads = sizeof(T) == 4 ? 320 : 256;

// Lanes a thread of the march takes: kernel 2's (lanes_per_thread: its K
// * B sigma values within 20 registers' worth).
template <typename T>
constexpr int march_lanes(int B) {
  return lanes_per_thread<T>(B, sizeof(T) == 4 ? 4 : 2);
}

// The shared memory of a march block of ty rows of a level Z points deep
// with `lanes` lanes of B bodies in stage `stage`, in elements of T: two
// coefficient tiles; the ring, `slots` planes of the lanes on the rows and
// their halo (ty + 2 rows); "sweep0" two planes of wd.
struct MarchSmem {
  int slots, tpts, plane, slot;
  int coef, ring, aux;
  __host__ __device__ MarchSmem(int ty, int Z, int lanes, int B, int stage)
      : slots(stage == kStageX ? 4 : 5), tpts(ty * Z), plane((ty + 2) * Z),
        slot(lanes * plane), coef(B * 27 * ty * Z), ring(slots * slot),
        aux(stage == kStageWdB ? 2 * slot : 0) {}
  __host__ __device__ long long bytes(int elem) const {
    return (2LL * coef + ring + aux) * elem;
  }
};

// A march launch's arguments: the tensors (b, wd unread in kMasked; x in
// kSweep0), the level and the plan with what follows from it.
template <typename T>
struct MarchArgs {
  const T *x, *b, *coeff, *sig, *wd;
  const unsigned* words;
  T* y;
  int L, X, Y, Z, mode;
  int ty, seg, lanes, nty, nslab;
};

template <typename T, int B, int K, int Stage>
__global__ void __launch_bounds__(kMarchMaxThreads<T>, 2)
level_march_kernel(const __grid_constant__ MarchArgs<T> a) {
  constexpr int NS = Stage == kStageX ? 4 : 5;
  extern __shared__ __align__(16) unsigned char s_raw[];
  const MarchSmem sm(a.ty, a.Z, a.lanes, B, Stage);
  T* s_coef = reinterpret_cast<T*>(s_raw);
  T* s_ring = s_coef + 2 * sm.coef;
  T* s_aux = s_ring + sm.ring;
  const int X = a.X, Y = a.Y, Z = a.Z, YZ = Y * Z, G = X * YZ;
  // the block: lane slab fastest, then the rows, then the segment
  const int slab = blockIdx.x % a.nslab, rest = blockIdx.x / a.nslab;
  const int y0 = rest % a.nty * a.ty;
  const int i0 = rest / a.nty * a.seg, i1 = min(i0 + a.seg, X);
  const int L0 = slab * a.lanes, nlb = min(a.lanes, a.L - L0);
  // the tile's rows in the grid; the window, rows [wy0, wy0 + ny) with
  // their halo clipped to the grid, from row oy of a lane's ring plane: a
  // run of `run` points
  const int ey = min(a.ty, Y - y0);
  const int wy0 = max(y0 - 1, 0), ny = min(y0 + a.ty + 1, Y) - wy0;
  const int oy = (wy0 - y0 + 1) * Z, run = ny * Z, crun = ey * Z;
  const int ct = threadIdx.x, cn = blockDim.x;
  const FastDiv by_run(run), by_crun(crun);
  const auto ring = [&](int f) { return s_ring + (f + NS) % NS * sm.slot; };
  const int nwin = nlb * run;
  // plane f of v (L, X, Y, Z) on the window into dst, by cp.async
  const auto stage_plane = [&](T* dst, const T* __restrict__ v, int f) {
    const T* src = v + L0 * G + f * YZ + wy0 * Z;
    for (int e = ct; e < nwin; e += cn) {
      const int ll = by_run.div(e), k = e - ll * run;
      cp_async_elem(dst + ll * sm.plane + oy + k, src + ll * G + k);
    }
  };
  // plane f's coefficient tile (B * 27, ty * Z), the tile's rows in the
  // grid
  const auto stage_coef = [&](T* dst, int f) {
    const T* src = a.coeff + (f * Y + y0) * Z;
    for (int e = ct; e < B * 27 * crun; e += cn) {
      const int r = by_crun.div(e), k = e - r * crun;
      cp_async_elem(dst + r * sm.tpts + k, src + r * G + k);
    }
  };
  // "sweep0": b of plane f in its ring slot, wd beside it (copies)
  const auto stage_raw = [&](int f) {
    stage_plane(ring(f), a.b, f);
    stage_plane(s_aux + (f & 1) * sm.slot, a.wd, f);
  };

  // prologue: the planes i0 - 1 .. i0 + 1 in the ring ("sweep0": wd b
  // formed here from device memory), the next raw plane's copies and
  // plane i0's coefficients
  const int last = min(i1, X - 1);  // the segment's planes and neighbours
  if constexpr (Stage == kStageX) {
    for (int f = max(i0 - 1, 0); f <= min(i0 + 1, last); ++f) {
      stage_plane(ring(f), a.x, f);
    }
  } else {
    for (int f = max(i0 - 1, 0); f <= min(i0 + 1, last); ++f) {
      T* dst = ring(f);
      for (int e = ct; e < nwin; e += cn) {
        const int ll = by_run.div(e), k = e - ll * run;
        const int g = (L0 + ll) * G + f * YZ + wy0 * Z + k;
        dst[ll * sm.plane + oy + k] = mul_rn(a.wd[g], a.b[g]);
      }
    }
    if (i0 + 2 <= last) stage_raw(i0 + 2);
  }
  stage_coef(s_coef, i0);

  // the thread's point and lanes: the slab's lanes in `groups` groups of
  // kg, group g from lane g * kg
  const int groups = cn / sm.tpts;
  const int g = ct / sm.tpts, p = ct - g * sm.tpts;
  const int kg = (nlb + groups - 1) / groups;
  const int lg = g * kg, nl = min(kg, nlb - lg);
  const bool mine = p < crun && nl > 0;
  T s[K][B];
  load_sigma<T, B, K>(s, a.sig, L0 + lg, mine ? nl : 0);
  const int ctr = lg * sm.plane + Z + p;  // row py + 1 of lane lg's plane
  for (int i = i0; i < i1; ++i) {
    cp_async_wait_block();
    const int k = i - i0;
    if constexpr (Stage == kStageX) {
      if (i + 2 <= last) stage_plane(ring(i + 2), a.x, i + 2);
    } else {
      if (i + 3 <= last) stage_raw(i + 3);
      if (i + 2 <= last) {  // form wd b of plane i + 2 in its slot
        const int f = i + 2;
        T* dst = ring(f);
        const T* w = s_aux + (f & 1) * sm.slot;
        for (int e = ct; e < nwin; e += cn) {
          const int ll = by_run.div(e);
          const int at = ll * sm.plane + oy + e - ll * run;
          dst[at] = mul_rn(w[at], dst[at]);
        }
      }
    }
    if (i + 1 < i1) stage_coef(s_coef + ((k + 1) & 1) * sm.coef, i + 1);
    if (!mine) continue;
    const T* cb = s_coef + (k & 1) * sm.coef + p;
    const T* r0 = ring(i) + ctr;
    const T* rm = ring(i - 1) + ctr;
    const T* rp = ring(i + 1) + ctr;
    const int q = (i * Y + y0) * Z + p;
    const unsigned nb = a.words[q];
    const bool f = (nb & kCgFree) != 0u;
    T acc[K];
#pragma unroll
    for (int l = 0; l < K; ++l) acc[l] = T(0);
    if (f) {
      const int tp = sm.tpts, pl = sm.plane;
      factored_apply<T, B, K>(
          s, nl, nb, [cb, tp](int bb, int o) { return cb[(bb * 27 + o) * tp]; },
          [&](int l, int o) {
            const T* r = o < 9 ? rm : (o < 18 ? r0 : rp);
            return r[l * pl + (o / 3 % 3 - 1) * Z + o % 3 - 1];
          },
          acc);
    }
#pragma unroll
    for (int l = 0; l < K; ++l) {
      if (l < nl) {
        const int gq = (L0 + lg + l) * G + q;
        const T xq = r0[l * sm.plane];
        a.y[gq] = level_out(a.mode, xq, f ? acc[l] : xq, a.b, a.wd, gq);
      }
    }
  }
}

// ── the lanes' combined stencils ─────────────────────────────────────────
//
// C[l, i] = sum_b sig[l, b] coeff[b, i] over the N elements of a body's
// coefficients: the lanes' own stencils of body-factored levels, made once
// a solve for every level of a V-cycle tail at once (the levels' planes one
// after another, the layout vcycle_tail_kernel reads).  The sum is
// batched_stencil_spmv_kernel's co in its order, co = s_0 c_0 (one
// rounding), then co = fma(s_b, c_b, co) for b = 1..B-1, so that kernel 1
// or the tail applying C repeats kernel 2's applies bit for bit (both
// accumulate fma(C_o, x_o, acc) over o in kernel 2's order).  Elementwise
// and bound by device memory (B reads a coefficient element, one write a
// lane and element): a thread holds one element's B coefficients in
// registers and writes it for the lanes blockIdx.y, + gridDim.y, ...;
// consecutive threads take consecutive elements, so every read and write
// is coalesced, and the lanes' reads of one element's coefficients after
// the first come from L2.
template <typename T, int B>
__global__ void __launch_bounds__(kBlock)
combine_lanes_kernel(const T* __restrict__ coeff, const T* __restrict__ sig,
                     T* __restrict__ C, int L, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  T c[B];
#pragma unroll
  for (int b = 0; b < B; ++b) c[b] = coeff[b * N + i];
  for (int l = blockIdx.y; l < L; l += gridDim.y) {
    const T* s = sig + l * B;
    T co = mul_rn(s[0], c[0]);
#pragma unroll
    for (int b = 1; b < B; ++b) co = fma(s[b], c[b], co);
    C[l * N + i] = co;
  }
}

// Lets `kernel` take `smem` bytes of dynamic shared memory on the current
// device: cudaFuncSetAttribute once per device, recorded in bit d of
// `done` (one `done` per kernel instantiation).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem, std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (bit && (done.load() & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

// 32-bit index arithmetic: the launchers refuse L*G or B*27*G past INT_MAX.
bool fits_int(long long G, int L, int B) {
  return G * L <= INT_MAX && G * 27 * B <= INT_MAX;
}

// S lanes as gridDim.y (at most 65535).  The kernel indexes in 64 bits,
// so no grid size is refused for overflowing an int.  Kernel 1 and its
// bf16-coefficient probe (TC its coefficient type).
template <typename T, typename TC, typename Kernel>
int launch_stencil_spmv(Kernel kernel, const void* x, const void* C, void* y,
                        int S, int X, int Y, int Z, void* stream) {
  const long long G = (long long)X * Y * Z;
  if (S < 0 || S > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (G == 0 || S == 0) return 0;
  const unsigned blocks = (unsigned)((G + kBlock - 1) / kBlock);
  kernel<<<dim3(blocks, S), kBlock, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const TC*)C, (T*)y, X, Y, Z);
  return (int)cudaGetLastError();
}

// The probe's 1-row form with V points a thread, P = 1 and 27 unrolled.
template <typename T, int V>
int launch_plane_fma_row(const void* x, const void* C, void* y, int S, int P,
                         int G, cudaStream_t stream) {
  const dim3 grid((G / V + PST_PROBE_THREADS - 1) / PST_PROBE_THREADS, S);
  const auto kernel = P == 1    ? plane_fma_row_kernel<T, 1, V>
                      : P == 27 ? plane_fma_row_kernel<T, 27, V>
                                : plane_fma_row_kernel<T, 0, V>;
  kernel<<<grid, PST_PROBE_THREADS, 0, stream>>>((const T*)x, (const T*)C,
                                                 (T*)y, P, G);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The plane-FMA probe: S lanes as gridDim.y; P >= 1, xrows 1, or 3 with
// P == 27.  The 3-row form indexes in 64 bits; the 1-row form in 32 (S * P
// * G past INT_MAX is refused), with 16-byte loads where G is a multiple
// of their points and x, C and y start 16-byte aligned.
template <typename T>
int launch_plane_fma(const void* x, const void* C, void* y, int S, int P,
                     int xrows, int X, int Y, int Z, void* stream) {
  const long long G = (long long)X * Y * Z;
  if (S < 0 || S > 65535 || P < 1 || !(xrows == 1 || xrows == 3) ||
      (xrows == 3 && P != 27) || (xrows == 1 && G * P * S > INT_MAX)) {
    return (int)cudaErrorInvalidValue;
  }
  if (G == 0 || S == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (xrows == 1) {
    constexpr int V = 16 / sizeof(T);
    if (G % V == 0 && aligned16(x) && aligned16(C) && aligned16(y)) {
      return launch_plane_fma_row<T, V>(x, C, y, S, P, (int)G, st);
    }
    return launch_plane_fma_row<T, 1>(x, C, y, S, P, (int)G, st);
  }
  const unsigned blocks =
      (unsigned)((G + PST_PROBE_THREADS - 1) / PST_PROBE_THREADS);
  plane_fma_kernel<T><<<dim3(blocks, S), PST_PROBE_THREADS, 0, st>>>(
      (const T*)x, (const T*)C, (T*)y, X, Y, Z);
  return (int)cudaGetLastError();
}

// Splits n items into the fewest slabs of at most `most`, evenly: returns
// the slab size; *slabs gets their number.
int even_slabs(int n, int most, int* slabs) {
  *slabs = (n + most - 1) / most;
  return (n + *slabs - 1) / *slabs;
}

// Blocks of `kernel` that the card holds at once with `threads` threads and
// `smem` bytes each (SMs times blocks per SM).  The occupancy query runs
// once per (device, threads) pair in a row; `last` (one per kernel
// instantiation) keeps the last pair and its answer.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, int smem,
                            std::atomic<unsigned long long>& last,
                            int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long key = (unsigned long long)dev << 48 |
                                 (unsigned long long)threads << 32;
  const unsigned long long kept = last.load();
  if ((kept & ~0xffffffffull) == key) {
    *blocks = (int)(kept & 0xffffffffull);
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  last.store(key | (unsigned)*blocks);
  return cudaSuccess;
}

// Launch of the lane-major kernel with B bodies (a switch on B picks it).
template <typename T, int B>
struct Batched {
  static int run(const void* Xs, const void* coeff, const void* sig, void* Ys,
                 int L, int X, int Y, int Z, cudaStream_t stream) {
    constexpr int P = Tile<T>::kB2Points;
    constexpr int K = lanes_per_thread<T>(B, Tile<T>::kB2Lanes);
    constexpr int smem = 2 * B * 27 * P * (int)sizeof(T);
    constexpr int kThreads = Tile<T>::kB2Threads;
    static_assert(kThreads % P == 0, "P must divide the block");
    static_assert(P % 32 == 0, "a warp must lie in one lane group");
    static_assert(2 * kMaxBodies * 27 * P * sizeof(T) <= kMaxSmem,
                  "two coefficient tiles above the shared memory of a block");
    const auto kernel = batched_stencil_spmv_kernel<T, B, K, P>;
    static std::atomic<unsigned> opted{0};
    static std::atomic<unsigned long long> last{0};
    const int G = X * Y * Z;
    int slabs = 0, blocks = 0;
    const int groups = even_slabs((L + K - 1) / K, kThreads / P, &slabs);
    cudaError_t err = allow_smem(kernel, smem, opted);
    if (err == cudaSuccess) {
      err = resident_blocks(kernel, P * groups, smem, last, &blocks);
    }
    if (err != cudaSuccess) return (int)err;
    batched_stencil_spmv_kernel<T, B, K, P>
        <<<dim3(std::min(blocks, (G + P - 1) / P), slabs), dim3(P, groups),
           smem, stream>>>(
            (const T*)Xs, (const T*)coeff, (const T*)sig, (T*)Ys, L, X, Y, Z);
    return (int)cudaGetLastError();
  }
};

// Launch of the lane-minor kernel with B bodies.
template <typename T, int B>
struct Lminor {
  static int run(const void* Xm, const void* coeff, const void* sig, void* Ym,
                 int L, int X, int Y, int Z, cudaStream_t stream) {
    constexpr int P = Tile<T>::kLmPoints;
    constexpr int K = lanes_per_thread<T>(B, Tile<T>::kLmLanes);
    constexpr int smem = 2 * B * 27 * P * (int)sizeof(T);
    constexpr int kThreads = Tile<T>::kLmThreads;
    static_assert(2 * kMaxBodies * 27 * P * sizeof(T) <= kMaxSmem,
                  "two coefficient tiles above the shared memory of a block");
    const auto kernel = batched_stencil_spmv_lminor_kernel<T, B, K, P>;
    static std::atomic<unsigned> opted{0};
    static std::atomic<unsigned long long> last{0};
    const int G = X * Y * Z;
    int slabs = 0, blocks = 0;
    const int lanes = even_slabs(L, kThreads * K, &slabs);
    const int threads = (lanes + K - 1) / K;  // per point row
    int rows = 1;  // point rows: a power of two, at most P
    while (rows * 2 <= P && rows * 2 * threads <= kThreads) rows *= 2;
    cudaError_t err = allow_smem(kernel, smem, opted);
    if (err == cudaSuccess) {
      err = resident_blocks(kernel, threads * rows, smem, last, &blocks);
    }
    if (err != cudaSuccess) return (int)err;
    batched_stencil_spmv_lminor_kernel<T, B, K, P>
        <<<dim3(std::min(blocks, (G + P - 1) / P), slabs),
           dim3(threads, rows), smem, stream>>>(
            (const T*)Xm, (const T*)coeff, (const T*)sig, (T*)Ym, L, X, Y, Z);
    return (int)cudaGetLastError();
  }
};

// Either batched kernel (Launch = Batched or Lminor): checks the sizes,
// then passes B = 1..kMaxBodies as a template argument.
template <typename T, template <typename, int> class Launch>
int launch_batched(const void* X_, const void* coeff, const void* sig,
                   void* Y_, int L, int B, int X, int Y, int Z,
                   void* stream) {
  const long long G = (long long)X * Y * Z;
  if (B < 1 || B > kMaxBodies || L < 0 || !fits_int(G, L, B)) {
    return (int)cudaErrorInvalidValue;
  }
  if (G == 0 || L == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (B) {
    case 1: return Launch<T, 1>::run(X_, coeff, sig, Y_, L, X, Y, Z, st);
    case 2: return Launch<T, 2>::run(X_, coeff, sig, Y_, L, X, Y, Z, st);
    case 3: return Launch<T, 3>::run(X_, coeff, sig, Y_, L, X, Y, Z, st);
    case 4: return Launch<T, 4>::run(X_, coeff, sig, Y_, L, X, Y, Z, st);
    case 5: return Launch<T, 5>::run(X_, coeff, sig, Y_, L, X, Y, Z, st);
    case 6: return Launch<T, 6>::run(X_, coeff, sig, Y_, L, X, Y, Z, st);
    case 7: return Launch<T, 7>::run(X_, coeff, sig, Y_, L, X, Y, Z, st);
    default: return Launch<T, 8>::run(X_, coeff, sig, Y_, L, X, Y, Z, st);
  }
}

// Shared memory of a coarse_cg block: the coefficient planes (kSmemC),
// p twice, ap or z, the two reductions' partials and a word a point.
template <typename T>
long long coarse_cg_smem(int G, bool smem_c) {
  return ((smem_c ? 27LL * G : 0) + 3LL * G + 2 * kCgMaxWarps) *
             (long long)sizeof(T) +
         4LL * G;
}

template <typename T, int K, bool kSmemC>
int launch_coarse_cg_as(const void* b, const void* C, const void* free,
                        void* x, int S, int free_stride, int iters, int X,
                        int Y, int Z, int threads, cudaStream_t stream) {
  const auto kernel = coarse_cg_kernel<T, K, kSmemC>;
  static std::atomic<unsigned> opted{0};
  const cudaError_t err = allow_smem(kernel, kMaxSmem, opted);
  if (err != cudaSuccess) return (int)err;
  const int smem = (int)coarse_cg_smem<T>(X * Y * Z, kSmemC);
  kernel<<<S, threads, smem, stream>>>(
      (const T*)b, (const T*)C, (const unsigned char*)free, (T*)x,
      free_stride, iters, X, Y, Z);
  return (int)cudaGetLastError();
}

template <typename T, int K>
int launch_coarse_cg_k(const void* b, const void* C, const void* free,
                       void* x, int S, int free_stride, int iters, int X,
                       int Y, int Z, int threads, cudaStream_t st) {
  if (coarse_cg_smem<T>(X * Y * Z, true) <= kMaxSmem) {
    return launch_coarse_cg_as<T, K, true>(b, C, free, x, S, free_stride,
                                           iters, X, Y, Z, threads, st);
  }
  return launch_coarse_cg_as<T, K, false>(b, C, free, x, S, free_stride,
                                          iters, X, Y, Z, threads, st);
}

// S lanes, one block each; free shared by the lanes (free_lanes 1) or one
// a lane (free_lanes S); G at most kCgMaxWarps * 32 * kCgMaxPoints.
template <typename T>
int launch_coarse_cg(const void* b, const void* C, const void* free, void* x,
                     int S, int free_lanes, int iters, int X, int Y, int Z,
                     void* stream) {
  const long long G = (long long)X * Y * Z;
  if (S < 0 || iters < 0 || !(free_lanes == 1 || free_lanes == S) ||
      G > kCgMaxWarps * 32 * kCgMaxPoints || !fits_int(G, S, S)) {
    return (int)cudaErrorInvalidValue;
  }
  if (G == 0 || S == 0) return 0;
  const int threads = coarse_cg_threads((int)G);
  const int need = (int)((G + threads - 1) / threads);
  const int free_stride = free_lanes == 1 ? 0 : (int)G;
  const cudaStream_t st = (cudaStream_t)stream;
  if (need <= 1)
    return launch_coarse_cg_k<T, 1>(b, C, free, x, S, free_stride, iters, X,
                                    Y, Z, threads, st);
  if (need <= 2)
    return launch_coarse_cg_k<T, 2>(b, C, free, x, S, free_stride, iters, X,
                                    Y, Z, threads, st);
  if (need <= 4)
    return launch_coarse_cg_k<T, 4>(b, C, free, x, S, free_stride, iters, X,
                                    Y, Z, threads, st);
  return launch_coarse_cg_k<T, 8>(b, C, free, x, S, free_stride, iters, X,
                                  Y, Z, threads, st);
}

// The tail's layout from meta = [n, X_0, Y_0, Z_0, ..., X_{n-1}, Y_{n-1},
// Z_{n-1}, then K of each transfer l and axis a, (l, a) in order]: the
// levels' points one after another (offsets in points; the planes at 27
// times them), each transfer's tables one after another, per axis in order:
// int s0 (fine points) and idx (coarse points x K); T wl and wr (fine
// points each) and wt (coarse points x K).  False for a layout the kernel
// does not take: 1..kTailMaxLevels levels, no extent below 1 or coarser
// than its next level's, K >= 1, 27 times the points within an int.
bool tail_meta(const int* meta, bool with_k, TailMeta* m) {
  const int n = meta[0];
  if (n < 1 || n > kTailMaxLevels) return false;
  m->n = n;
  long long off = 0;
  for (int l = 0; l < n; ++l) {
    const int* d = meta + 1 + 3 * l;
    if (d[0] < 1 || d[1] < 1 || d[2] < 1) return false;
    const long long G = (long long)d[0] * d[1] * d[2];
    if (27 * (off + G) > INT_MAX) return false;
    m->lv[l] = TailLevel{d[0], d[1], d[2], (int)G, (int)off};
    off += G;
  }
  m->points = (int)off;
  if (!with_k) return true;
  const int* K = meta + 1 + 3 * n;
  long long io = 0, wo = 0;
  for (int l = 0; l + 1 < n; ++l) {
    for (int a = 0; a < 3; ++a) {
      const int nf = meta[1 + 3 * l + a], nc = meta[1 + 3 * (l + 1) + a];
      const int k = K[3 * l + a];
      if (k < 1 || nc > nf) return false;
      m->tr[l].K[a] = k;
      m->tr[l].ioff[a] = (int)io;
      m->tr[l].woff[a] = (int)wo;
      io += nf + (long long)nc * k;
      wo += 2LL * nf + (long long)nc * k;
      if (wo > INT_MAX) return false;
    }
  }
  return true;
}

// Shared memory of a vcycle_tail block (see vcycle_tail_kernel): per point
// of every level 27 planes, x, b and omega * dinv in T and a neighbour word;
// four arrays of the top level's points; the coarse CG's partials.
long long vcycle_tail_smem(const TailMeta& m, int elem) {
  return (30LL * m.points + 4LL * m.lv[0].G + 2 * kCgMaxWarps) * elem +
         4LL * m.points;
}

// S lanes, one block each; free shared by the lanes (free_lanes 1) or one
// a lane (free_lanes S).  Refuses a layout tail_meta refuses, a coarsest
// level past the coarse CG's kCgMaxWarps * 32 * kCgMaxPoints points, and a
// tail past kMaxSmem.
template <typename T>
int launch_vcycle_tail(const void* b, const void* Cp, const void* Fp,
                       const void* itab, const void* wtab, void* x,
                       const int* meta, int S, int free_lanes, int nu,
                       double omega, int iters, void* stream) {
  TailMeta m;
  if (S < 0 || nu < 0 || iters < 0 || !(free_lanes == 1 || free_lanes == S) ||
      !tail_meta(meta, true, &m) ||
      m.lv[m.n - 1].G > kCgMaxWarps * 32 * kCgMaxPoints) {
    return (int)cudaErrorInvalidValue;
  }
  const long long smem = vcycle_tail_smem(m, (int)sizeof(T));
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  const auto kernel = vcycle_tail_kernel<T>;
  static std::atomic<unsigned> opted{0};
  const cudaError_t err = allow_smem(kernel, kMaxSmem, opted);
  if (err != cudaSuccess) return (int)err;
  kernel<<<S, kTailThreads<T>, (int)smem, (cudaStream_t)stream>>>(
      (const T*)b, (const T*)Cp, (const unsigned char*)Fp, (const int*)itab,
      (const T*)wtab, (T*)x, m, free_lanes == 1 ? 0 : m.points, nu, (T)omega,
      iters);
  return (int)cudaGetLastError();
}

// S lanes (gridDim.y, at most 65535) of G points within 32-bit indices.
bool level_lanes_fit(long long G, int S) {
  return S >= 0 && S <= 65535 && 27LL * S * G <= INT_MAX;
}

dim3 level_grid(int G, int S) {
  return dim3((unsigned)((G + PST_LEVEL_THREADS - 1) / PST_LEVEL_THREADS), S);
}

// S lanes with their own stencils (27, X, Y, Z) and wd; neighbour words
// shared by the lanes (word_lanes 1) or one set a lane (word_lanes S);
// mode a LevelMode (x unread in kSweep0, b and wd unread in kMasked).
template <typename T>
int launch_level_apply(const void* x, const void* b, const void* C,
                       const void* wd, const void* words, void* y, int S,
                       int word_lanes, int mode, int X, int Y, int Z,
                       void* stream) {
  const long long G = (long long)X * Y * Z;
  if (X < 1 || Y < 1 || Z < 1 || !level_lanes_fit(G, S) ||
      !(word_lanes == 1 || word_lanes == S) || mode < kSweep ||
      mode > kMasked) {
    return (int)cudaErrorInvalidValue;
  }
  if (S == 0) return 0;
  const auto kernel = mode == kSweep      ? level_apply_kernel<T, kSweep>
                      : mode == kSweep0   ? level_apply_kernel<T, kSweep0>
                      : mode == kResidual ? level_apply_kernel<T, kResidual>
                                          : level_apply_kernel<T, kMasked>;
  kernel<<<level_grid((int)G, S), PST_LEVEL_THREADS, 0,
           (cudaStream_t)stream>>>(
      (const T*)x, (const T*)b, (const T*)C, (const T*)wd,
      (const unsigned*)words, (T*)y, word_lanes == 1 ? 0 : (int)G, X, Y, Z);
  return (int)cudaGetLastError();
}

// The layout of one transfer: meta as tail_meta reads it, two levels.
bool transfer_meta(const int* meta, int S, TailMeta* m) {
  return meta[0] == 2 && tail_meta(meta, true, m) &&
         level_lanes_fit(m->lv[0].G, S);
}

// Bytes of dynamic shared memory of a cluster-tail block: the larger of
// the tail rank's (vcycle_tail_smem of the tail) and a slab rank's.
long long cluster_tail_smem(const TailMeta& m, const TailMeta& ma,
                            const ClusterPlan& pl, int elem) {
  const TailLevel A = ma.lv[0], C = ma.lv[1];
  const long long W = (long long)pl.wmax * A.Y * A.Z;
  const long long slab =
      (32 * W + 12LL * A.Y * A.Z + (long long)pl.cmax * (A.Y + C.Y) * A.Z +
       (long long)pl.pmax * C.Y * C.Z) * elem + 4 * W;
  return std::max(vcycle_tail_smem(m, elem), slab);
}

// The cluster tail: S lanes (gridDim.y), a cluster of `ranks` blocks each
// (gridDim.x); meta the tail's layout from level t (as launch_vcycle_tail's,
// its tables Cp, Fp, itab, wtab), meta_top level A's and t's with the
// transfer between them (its tables itabA, wtabA: TransferTables.packed);
// A's stencils CA (S, 27, G_A) and wd (S, G_A), its neighbour words
// shared by the lanes (word_lanes 1) or one set a lane (S); the tail's
// free likewise (free_lanes).  Refuses what launch_vcycle_tail refuses, a
// meta_top that does not join the tail, a plan cluster_plan refuses and
// blocks past kMaxSmem; raises cudaErrorLaunchOutOfResources where the
// card cannot place one such cluster (cudaOccupancyMaxActiveClusters).
template <typename T>
int launch_cluster_tail(const void* b, const void* CA, const void* wdA,
                        const void* words, const void* itabA,
                        const void* wtabA, const void* Cp, const void* Fp,
                        const void* itab, const void* wtab, void* x,
                        const int* meta, const int* meta_top, int ranks,
                        int S, int word_lanes, int free_lanes, int nu,
                        double omega, int iters, void* stream) {
  TailMeta m, ma;
  ClusterPlan pl;
  if (S < 0 || S > 65535 || nu < 0 || iters < 0 ||
      !(word_lanes == 1 || word_lanes == S) ||
      !(free_lanes == 1 || free_lanes == S) || !tail_meta(meta, true, &m) ||
      m.lv[m.n - 1].G > kCgMaxWarps * 32 * kCgMaxPoints ||
      !transfer_meta(meta_top, S, &ma) || ma.lv[1].X != m.lv[0].X ||
      ma.lv[1].Y != m.lv[0].Y || ma.lv[1].Z != m.lv[0].Z ||
      !cluster_plan(ma, ranks, &pl)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long smem = cluster_tail_smem(m, ma, pl, (int)sizeof(T));
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  const auto kernel = cluster_tail_kernel<T>;
  static std::atomic<unsigned> opted{0};
  cudaError_t err = allow_smem(kernel, kMaxSmem, opted);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, S);
  cfg.blockDim = dim3(kTailThreads<T>);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the placement query once per (device, ranks, bytes) in a row
  static std::atomic<unsigned long long> placed{0};
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long key = 1ull << 63 | (unsigned long long)dev << 40 |
                                 (unsigned long long)ranks << 32 |
                                 (unsigned long long)smem;
  if (placed.load() != key) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
    placed.store(key);
  }
  err = cudaLaunchKernelEx(
      &cfg, kernel, (const T*)b, (const T*)CA, (const T*)wdA,
      (const unsigned*)words, (const int*)itabA, (const T*)wtabA,
      (const T*)Cp, (const unsigned char*)Fp, (const int*)itab,
      (const T*)wtab, (T*)x, m, ma, pl,
      word_lanes == 1 ? 0 : ma.lv[0].G, free_lanes == 1 ? 0 : m.points, nu,
      (T)omega, iters);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// restrict_kernel with tiles of TX x TY coarse points, Z cut evenly into
// tiles of at most PST_RS_TZ; the grid's blocks (tiles x lanes) in
// *blocks.
template <typename T, int TX, int TY>
int launch_restrict_tile(const void* r, const void* itab, const void* wtab,
                         const void* free_c, void* rc, const TailMeta& m,
                         int S, int free_lanes, bool run, long long* blocks,
                         cudaStream_t stream) {
  using Tile = RsTile<TX, TY>;
  const TailLevel Cl = m.lv[1];
  const int ntz = (Cl.Z + PST_RS_TZ - 1) / PST_RS_TZ;
  const int tz = (Cl.Z + ntz - 1) / ntz;
  const long long tiles = (long long)((Cl.X + Tile::tile(0) - 1) /
                                      Tile::tile(0)) *
                          ((Cl.Y + Tile::tile(1) - 1) / Tile::tile(1)) * ntz;
  *blocks = tiles * S;
  if (!run) return 0;
  if (tiles > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  constexpr int smem = Tile::template smem<T>();
  static_assert(smem <= kMaxSmem, "the restriction's tile must fit an SM");
  const auto kernel = restrict_kernel<T, TX, TY>;
  static std::atomic<unsigned> opted{0};
  const cudaError_t err = allow_smem(kernel, smem, opted);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)tiles, S), PST_RS_THREADS, smem, stream>>>(
      (const T*)r, (const int*)itab, (const T*)wtab,
      (const unsigned char*)free_c, (T*)rc, free_lanes == 1 ? 0 : Cl.G, m,
      tz);
  return (int)cudaGetLastError();
}

// The large tile where its grid has PST_RS_LARGE_BLOCKS blocks, else the
// small one.
template <typename T>
int launch_restrict(const void* r, const void* itab, const void* wtab,
                    const void* free_c, void* rc, const int* meta, int S,
                    int free_lanes, void* stream) {
  TailMeta m;
  if (!transfer_meta(meta, S, &m) || !(free_lanes == 1 || free_lanes == S) ||
      std::max({m.tr[0].K[0], m.tr[0].K[1], m.tr[0].K[2]}) > kLevelMaxK) {
    return (int)cudaErrorInvalidValue;
  }
  if (S == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  constexpr int LX = PST_RS_LARGE_TX, LY = PST_RS_LARGE_TY;
  constexpr int SX = PST_RS_SMALL_TX, SY = PST_RS_SMALL_TY;
  long long blocks = 0;
  launch_restrict_tile<T, LX, LY>(r, itab, wtab, free_c, rc, m, S,
                                  free_lanes, false, &blocks, st);
  if (blocks >= PST_RS_LARGE_BLOCKS) {
    return launch_restrict_tile<T, LX, LY>(r, itab, wtab, free_c, rc, m, S,
                                           free_lanes, true, &blocks, st);
  }
  return launch_restrict_tile<T, SX, SY>(r, itab, wtab, free_c, rc, m, S,
                                         free_lanes, true, &blocks, st);
}

// prolong_add_kernel on S lanes: a thread a unit of 2 x 2 x 1 fine
// points, kPaThreads a block.
template <typename T>
int launch_prolong_add(const void* x, const void* xc, const void* wtab,
                       void* y, const int* meta, int S, void* stream) {
  TailMeta m;
  if (!transfer_meta(meta, S, &m)) return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  const TailLevel F = m.lv[0];
  const long long units = (long long)((F.X + 1) / 2) * ((F.Y + 1) / 2) * F.Z;
  prolong_add_kernel<T>
      <<<dim3((unsigned)((units + kPaThreads - 1) / kPaThreads), S),
         kPaThreads, 0, (cudaStream_t)stream>>>(
          (const T*)x, (const T*)xc, (const T*)wtab, (T*)y, m);
  return (int)cudaGetLastError();
}

// S lanes with their own stencils in level_apply's mode "prolong_sweep":
// meta the transfer's layout (as launch_prolong_add's), the neighbour
// words as launch_level_apply's.  The tile: PST_PS_TX x ty x tz points
// (prolong_sweep_tile).
template <typename T>
int launch_level_prolong_sweep(const void* x, const void* xc, const void* b,
                               const void* C, const void* wd,
                               const void* words, const void* itab,
                               const void* wtab, void* y, const int* meta,
                               int S, int word_lanes, void* stream) {
  TailMeta m;
  if (!transfer_meta(meta, S, &m) || !(word_lanes == 1 || word_lanes == S)) {
    return (int)cudaErrorInvalidValue;
  }
  if (S == 0) return 0;
  const TailLevel F = m.lv[0];
  int ty, tz;
  prolong_sweep_tile(F.Y, F.Z, &ty, &tz);
  const long long tiles = (long long)((F.X + PST_PS_TX - 1) / PST_PS_TX) *
                          ((F.Y + ty - 1) / ty) * ((F.Z + tz - 1) / tz);
  const int smem = PsSmem(ty, tz).bytes((int)sizeof(T));
  if (tiles > INT_MAX || smem > kMaxSmem) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const auto kernel = level_prolong_sweep_kernel<T>;
  static std::atomic<unsigned> opted{0};
  const cudaError_t err = allow_smem(kernel, kMaxSmem, opted);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)tiles, S), PST_PS_THREADS, smem,
           (cudaStream_t)stream>>>(
      (const T*)x, (const T*)xc, (const T*)b, (const T*)C, (const T*)wd,
      (const unsigned*)words, (const int*)itab, (const T*)wtab, (T*)y,
      word_lanes == 1 ? 0 : F.G, m, ty, tz);
  return (int)cudaGetLastError();
}

// Pointers of a level_apply_factored launch.
template <typename T>
struct FactoredArgs {
  const T *x, *b, *coeff, *sig, *wd;
  const unsigned* words;
  T* y;
};

// B bodies: kernel 2's launch (Batched::run): blocks of P points by the
// lane groups of K lanes a slab holds, as many blocks as the card holds and
// at most one a tile.
template <typename T, int B, bool kFromZero>
int launch_factored_tiles(const FactoredArgs<T>& a, int mode, int L, int X,
                          int Y, int Z, cudaStream_t stream) {
  constexpr int P = Tile<T>::kB2Points;
  constexpr int K = lanes_per_thread<T>(B, Tile<T>::kB2Lanes);
  constexpr int smem = 2 * B * 27 * P * (int)sizeof(T);
  const auto kernel = level_apply_factored_kernel<T, B, K, P, kFromZero>;
  static std::atomic<unsigned> opted{0};
  static std::atomic<unsigned long long> last{0};
  int slabs = 0, blocks = 0;
  const int groups = even_slabs((L + K - 1) / K,
                                Tile<T>::kB2Threads / P, &slabs);
  cudaError_t err = allow_smem(kernel, smem, opted);
  if (err == cudaSuccess) {
    err = resident_blocks(kernel, P * groups, smem, last, &blocks);
  }
  if (err != cudaSuccess) return (int)err;
  if (slabs > 65535) return (int)cudaErrorInvalidConfiguration;
  kernel<<<dim3(std::min(blocks, (X * Y * Z + P - 1) / P), slabs),
           dim3(P, groups), smem, stream>>>(
      a.x, a.b, a.coeff, a.sig, a.wd, a.words, a.y, mode, L, X, Y, Z);
  return (int)cudaGetLastError();
}

template <typename T, int B>
int launch_factored_b(const FactoredArgs<T>& a, int mode, int L, int X,
                      int Y, int Z, cudaStream_t st) {
  return mode == kSweep0
             ? launch_factored_tiles<T, B, true>(a, mode, L, X, Y, Z, st)
             : launch_factored_tiles<T, B, false>(a, mode, L, X, Y, Z, st);
}

// L lanes of B bodies (1..kMaxBodies) on grid (X, Y, Z) within 32-bit
// indices; mode a LevelMode (x unread in kSweep0, b and wd in kMasked).
template <typename T>
int launch_level_apply_factored_tiles(const void* x, const void* b,
                                const void* coeff, const void* sig,
                                const void* wd, const void* words, void* y,
                                int L, int B, int mode, int X, int Y, int Z,
                                void* stream) {
  const long long G = (long long)X * Y * Z;
  if (X < 1 || Y < 1 || Z < 1 || B < 1 || B > kMaxBodies || L < 0 ||
      !fits_int(G, L, B) || mode < kSweep || mode > kMasked) {
    return (int)cudaErrorInvalidValue;
  }
  if (L == 0) return 0;
  const FactoredArgs<T> a{(const T*)x,  (const T*)b,  (const T*)coeff,
                          (const T*)sig, (const T*)wd, (const unsigned*)words,
                          (T*)y};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (B) {
    case 1: return launch_factored_b<T, 1>(a, mode, L, X, Y, Z, st);
    case 2: return launch_factored_b<T, 2>(a, mode, L, X, Y, Z, st);
    case 3: return launch_factored_b<T, 3>(a, mode, L, X, Y, Z, st);
    case 4: return launch_factored_b<T, 4>(a, mode, L, X, Y, Z, st);
    case 5: return launch_factored_b<T, 5>(a, mode, L, X, Y, Z, st);
    case 6: return launch_factored_b<T, 6>(a, mode, L, X, Y, Z, st);
    case 7: return launch_factored_b<T, 7>(a, mode, L, X, Y, Z, st);
    default: return launch_factored_b<T, 8>(a, mode, L, X, Y, Z, st);
  }
}

// A march plan's blocks: ty rows of (Y, Z), whole along z, segments of
// `seg` planes, slabs of `lanes` lanes; a thread a point and group of
// march_lanes lanes; false for a plan the kernel does not take (threads
// past kMarchMaxThreads, shared memory past kMaxSmem, rows, a segment or
// a slab larger than the level).  stencil_kernels.march_plan makes it by
// the same formulas.
struct MarchPlan {
  int nty, nseg, nslab, threads, blocks;
  long long smem;
};

template <typename T>
bool march_plan(int L, int B, int X, int Y, int Z, int stage, int ty,
                int seg, int lanes, MarchPlan* p) {
  if (ty < 1 || seg < 1 || lanes < 1 || ty > Y || seg > X || lanes > L) {
    return false;
  }
  const int K = march_lanes<T>(B);
  const long long threads = (long long)ty * Z * ((lanes + K - 1) / K);
  p->nty = (Y + ty - 1) / ty;
  p->nseg = (X + seg - 1) / seg;
  p->nslab = (L + lanes - 1) / lanes;
  p->smem = MarchSmem(ty, Z, lanes, B, stage).bytes((int)sizeof(T));
  const long long blocks = (long long)p->nty * p->nseg * p->nslab;
  p->threads = (int)std::min(threads, (long long)INT_MAX);
  p->blocks = (int)std::min(blocks, (long long)INT_MAX);
  return threads <= kMarchMaxThreads<T> && p->smem <= kMaxSmem &&
         blocks <= INT_MAX;
}

template <typename T, int B, int Stage>
int launch_march_as(const MarchArgs<T>& a, const MarchPlan& p,
                    cudaStream_t stream) {
  const auto kernel = level_march_kernel<T, B, march_lanes<T>(B), Stage>;
  static std::atomic<unsigned> opted{0};
  const cudaError_t err = allow_smem(kernel, kMaxSmem, opted);
  if (err != cudaSuccess) return (int)err;
  kernel<<<p.blocks, p.threads, (int)p.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int B>
int launch_march_b(const MarchArgs<T>& a, const MarchPlan& p, int stage,
                   cudaStream_t st) {
  if (stage == kStageWdB) return launch_march_as<T, B, kStageWdB>(a, p, st);
  return launch_march_as<T, B, kStageX>(a, p, st);
}

// The march stage of a LevelMode: wd b formed ("sweep0") or x staged.
int march_stage(int mode) { return mode == kSweep0 ? kStageWdB : kStageX; }

// L lanes of B bodies (1..kMaxBodies) on grid (X, Y, Z) within 32-bit
// indices; mode a LevelMode (x unread in kSweep0, b and wd in kMasked);
// the plan (ty, seg, lanes) as march_plan takes it, or ty = 0 for kernel
// 2's tiles (level_apply_factored_kernel).
template <typename T>
int launch_level_apply_factored(const void* x, const void* b,
                                const void* coeff, const void* sig,
                                const void* wd, const void* words, void* y,
                                int L, int B, int mode, int X, int Y, int Z,
                                int ty, int seg, int lanes, void* stream) {
  const long long G = (long long)X * Y * Z;
  MarchPlan p;
  if (X < 1 || Y < 1 || Z < 1 || B < 1 || B > kMaxBodies || L < 0 ||
      !fits_int(G, L, B) || mode < kSweep || mode > kMasked) {
    return (int)cudaErrorInvalidValue;
  }
  if (L == 0) return 0;
  if (ty == 0) {  // the plan keeps kernel 2's tiles
    return launch_level_apply_factored_tiles<T>(x, b, coeff, sig, wd, words,
                                                y, L, B, mode, X, Y, Z,
                                                stream);
  }
  const int stage = march_stage(mode);
  if (!march_plan<T>(L, B, X, Y, Z, stage, ty, seg, lanes, &p)) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const MarchArgs<T> a{(const T*)x,  (const T*)b,  (const T*)coeff,
                       (const T*)sig, (const T*)wd, (const unsigned*)words,
                       (T*)y,         L,            X,
                       Y,             Z,            mode,
                       ty,            seg,          lanes,
                       p.nty,         p.nslab};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (B) {
    case 1: return launch_march_b<T, 1>(a, p, stage, st);
    case 2: return launch_march_b<T, 2>(a, p, stage, st);
    case 3: return launch_march_b<T, 3>(a, p, stage, st);
    case 4: return launch_march_b<T, 4>(a, p, stage, st);
    case 5: return launch_march_b<T, 5>(a, p, stage, st);
    case 6: return launch_march_b<T, 6>(a, p, stage, st);
    case 7: return launch_march_b<T, 7>(a, p, stage, st);
    default: return launch_march_b<T, 8>(a, p, stage, st);
  }
}

template <typename T, int B>
int launch_combine_lanes_b(const void* coeff, const void* sig, void* C, int L,
                           int N, cudaStream_t stream) {
  const dim3 grid((N + kBlock - 1) / kBlock, std::min(L, 65535));
  combine_lanes_kernel<T, B><<<grid, kBlock, 0, stream>>>(
      (const T*)coeff, (const T*)sig, (T*)C, L, N);
  return (int)cudaGetLastError();
}

// L lanes of B bodies (1..kMaxBodies) over N elements; L * N and B * N
// within an int.
template <typename T>
int launch_combine_lanes(const void* coeff, const void* sig, void* C, int L,
                         int B, int N, void* stream) {
  if (B < 1 || B > kMaxBodies || L < 0 || N < 0 ||
      (long long)L * N > INT_MAX || (long long)B * N > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  if (L == 0 || N == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (B) {
    case 1: return launch_combine_lanes_b<T, 1>(coeff, sig, C, L, N, st);
    case 2: return launch_combine_lanes_b<T, 2>(coeff, sig, C, L, N, st);
    case 3: return launch_combine_lanes_b<T, 3>(coeff, sig, C, L, N, st);
    case 4: return launch_combine_lanes_b<T, 4>(coeff, sig, C, L, N, st);
    case 5: return launch_combine_lanes_b<T, 5>(coeff, sig, C, L, N, st);
    case 6: return launch_combine_lanes_b<T, 6>(coeff, sig, C, L, N, st);
    case 7: return launch_combine_lanes_b<T, 7>(coeff, sig, C, L, N, st);
    default: return launch_combine_lanes_b<T, 8>(coeff, sig, C, L, N, st);
  }
}

}  // namespace

extern "C" {

int pst_max_bodies() { return kMaxBodies; }

int pst_coarse_cg_max_points() { return kCgMaxWarps * 32 * kCgMaxPoints; }

int pst_stencil_spmv_f32(const void* x, const void* C, void* y, int S, int X,
                         int Y, int Z, void* stream) {
  return launch_stencil_spmv<float, float>(stencil_spmv_kernel<float>, x, C,
                                           y, S, X, Y, Z, stream);
}

int pst_stencil_spmv_f64(const void* x, const void* C, void* y, int S, int X,
                         int Y, int Z, void* stream) {
  return launch_stencil_spmv<double, double>(stencil_spmv_kernel<double>, x,
                                             C, y, S, X, Y, Z, stream);
}

int pst_stencil_spmv_bf16c(const void* x, const void* C, void* y, int S,
                           int X, int Y, int Z, void* stream) {
  return launch_stencil_spmv<float, __nv_bfloat16>(
      stencil_spmv_bf16c_kernel, x, C, y, S, X, Y, Z, stream);
}

int pst_plane_fma_f32(const void* x, const void* C, void* y, int S, int P,
                      int xrows, int X, int Y, int Z, void* stream) {
  return launch_plane_fma<float>(x, C, y, S, P, xrows, X, Y, Z, stream);
}

int pst_plane_fma_f64(const void* x, const void* C, void* y, int S, int P,
                      int xrows, int X, int Y, int Z, void* stream) {
  return launch_plane_fma<double>(x, C, y, S, P, xrows, X, Y, Z, stream);
}

int pst_batched_stencil_spmv_f32(const void* Xs, const void* coeff,
                                 const void* sig, void* Ys, int L, int B,
                                 int X, int Y, int Z, void* stream) {
  return launch_batched<float, Batched>(Xs, coeff, sig, Ys, L, B, X, Y, Z,
                                        stream);
}

int pst_batched_stencil_spmv_f64(const void* Xs, const void* coeff,
                                 const void* sig, void* Ys, int L, int B,
                                 int X, int Y, int Z, void* stream) {
  return launch_batched<double, Batched>(Xs, coeff, sig, Ys, L, B, X, Y, Z,
                                         stream);
}

int pst_batched_stencil_spmv_lminor_f32(const void* Xm, const void* coeff,
                                        const void* sig, void* Ym, int L,
                                        int B, int X, int Y, int Z,
                                        void* stream) {
  return launch_batched<float, Lminor>(Xm, coeff, sig, Ym, L, B, X, Y, Z,
                                       stream);
}

int pst_batched_stencil_spmv_lminor_f64(const void* Xm, const void* coeff,
                                        const void* sig, void* Ym, int L,
                                        int B, int X, int Y, int Z,
                                        void* stream) {
  return launch_batched<double, Lminor>(Xm, coeff, sig, Ym, L, B, X, Y, Z,
                                        stream);
}

int pst_coarse_cg_f32(const void* b, const void* C, const void* free,
                      void* x, int S, int free_lanes, int iters, int X, int Y,
                      int Z, void* stream) {
  return launch_coarse_cg<float>(b, C, free, x, S, free_lanes, iters, X, Y, Z,
                                 stream);
}

int pst_coarse_cg_f64(const void* b, const void* C, const void* free,
                      void* x, int S, int free_lanes, int iters, int X, int Y,
                      int Z, void* stream) {
  return launch_coarse_cg<double>(b, C, free, x, S, free_lanes, iters, X, Y,
                                  Z, stream);
}

int pst_vcycle_tail_f32(const void* b, const void* Cp, const void* Fp,
                        const void* itab, const void* wtab, void* x,
                        const int* meta, int S, int free_lanes, int nu,
                        double omega, int iters, void* stream) {
  return launch_vcycle_tail<float>(b, Cp, Fp, itab, wtab, x, meta, S,
                                   free_lanes, nu, omega, iters, stream);
}

int pst_vcycle_tail_f64(const void* b, const void* Cp, const void* Fp,
                        const void* itab, const void* wtab, void* x,
                        const int* meta, int S, int free_lanes, int nu,
                        double omega, int iters, void* stream) {
  return launch_vcycle_tail<double>(b, Cp, Fp, itab, wtab, x, meta, S,
                                    free_lanes, nu, omega, iters, stream);
}

int pst_cluster_tail_f32(const void* b, const void* CA, const void* wdA,
                         const void* words, const void* itabA,
                         const void* wtabA, const void* Cp, const void* Fp,
                         const void* itab, const void* wtab, void* x,
                         const int* meta, const int* meta_top, int ranks,
                         int S, int word_lanes, int free_lanes, int nu,
                         double omega, int iters, void* stream) {
  return launch_cluster_tail<float>(b, CA, wdA, words, itabA, wtabA, Cp, Fp,
                                    itab, wtab, x, meta, meta_top, ranks, S,
                                    word_lanes, free_lanes, nu, omega, iters,
                                    stream);
}

int pst_cluster_tail_f64(const void* b, const void* CA, const void* wdA,
                         const void* words, const void* itabA,
                         const void* wtabA, const void* Cp, const void* Fp,
                         const void* itab, const void* wtab, void* x,
                         const int* meta, const int* meta_top, int ranks,
                         int S, int word_lanes, int free_lanes, int nu,
                         double omega, int iters, void* stream) {
  return launch_cluster_tail<double>(b, CA, wdA, words, itabA, wtabA, Cp, Fp,
                                     itab, wtab, x, meta, meta_top, ranks, S,
                                     word_lanes, free_lanes, nu, omega, iters,
                                     stream);
}

int pst_combine_lanes_f32(const void* coeff, const void* sig, void* C, int L,
                          int B, int N, void* stream) {
  return launch_combine_lanes<float>(coeff, sig, C, L, B, N, stream);
}

int pst_combine_lanes_f64(const void* coeff, const void* sig, void* C, int L,
                          int B, int N, void* stream) {
  return launch_combine_lanes<double>(coeff, sig, C, L, B, N, stream);
}

int pst_level_apply_f32(const void* x, const void* b, const void* C,
                        const void* wd, const void* words, void* y, int S,
                        int word_lanes, int mode, int X, int Y, int Z,
                        void* stream) {
  return launch_level_apply<float>(x, b, C, wd, words, y, S, word_lanes,
                                   mode, X, Y, Z, stream);
}

int pst_level_apply_f64(const void* x, const void* b, const void* C,
                        const void* wd, const void* words, void* y, int S,
                        int word_lanes, int mode, int X, int Y, int Z,
                        void* stream) {
  return launch_level_apply<double>(x, b, C, wd, words, y, S, word_lanes,
                                    mode, X, Y, Z, stream);
}

int pst_restrict_f32(const void* r, const void* itab, const void* wtab,
                     const void* free_c, void* rc, const int* meta, int S,
                     int free_lanes, void* stream) {
  return launch_restrict<float>(r, itab, wtab, free_c, rc, meta, S,
                                free_lanes, stream);
}

int pst_restrict_f64(const void* r, const void* itab, const void* wtab,
                     const void* free_c, void* rc, const int* meta, int S,
                     int free_lanes, void* stream) {
  return launch_restrict<double>(r, itab, wtab, free_c, rc, meta, S,
                                 free_lanes, stream);
}

int pst_prolong_add_f32(const void* x, const void* xc, const void* wtab,
                        void* y, const int* meta, int S, void* stream) {
  return launch_prolong_add<float>(x, xc, wtab, y, meta, S, stream);
}

int pst_prolong_add_f64(const void* x, const void* xc, const void* wtab,
                        void* y, const int* meta, int S, void* stream) {
  return launch_prolong_add<double>(x, xc, wtab, y, meta, S, stream);
}

int pst_level_prolong_sweep_f32(const void* x, const void* xc, const void* b,
                                const void* C, const void* wd,
                                const void* words, const void* itab,
                                const void* wtab, void* y, const int* meta,
                                int S, int word_lanes, void* stream) {
  return launch_level_prolong_sweep<float>(x, xc, b, C, wd, words, itab, wtab,
                                           y, meta, S, word_lanes, stream);
}

int pst_level_prolong_sweep_f64(const void* x, const void* xc, const void* b,
                                const void* C, const void* wd,
                                const void* words, const void* itab,
                                const void* wtab, void* y, const int* meta,
                                int S, int word_lanes, void* stream) {
  return launch_level_prolong_sweep<double>(x, xc, b, C, wd, words, itab,
                                            wtab, y, meta, S, word_lanes,
                                            stream);
}

int pst_level_apply_factored_f32(const void* x, const void* b,
                                 const void* coeff, const void* sig,
                                 const void* wd, const void* words, void* y,
                                 int L, int B, int mode, int X, int Y, int Z,
                                 int ty, int seg, int lanes, void* stream) {
  return launch_level_apply_factored<float>(x, b, coeff, sig, wd, words, y,
                                            L, B, mode, X, Y, Z, ty, seg,
                                            lanes, stream);
}

int pst_level_apply_factored_f64(const void* x, const void* b,
                                 const void* coeff, const void* sig,
                                 const void* wd, const void* words, void* y,
                                 int L, int B, int mode, int X, int Y, int Z,
                                 int ty, int seg, int lanes, void* stream) {
  return launch_level_apply_factored<double>(x, b, coeff, sig, wd, words, y,
                                             L, B, mode, X, Y, Z, ty, seg,
                                             lanes, stream);
}

// The march's lanes a thread (march_lanes) for B bodies in elements of
// elem bytes, and the shared memory of a block of ty rows of a level Z
// points deep with `lanes` lanes in mode `mode` (MarchSmem): what
// stencil_kernels.march_plan computes.
int pst_march_lanes(int B, int elem) {
  return elem == 4 ? march_lanes<float>(B) : march_lanes<double>(B);
}

long long pst_march_smem(int ty, int Z, int lanes, int B, int mode,
                         int elem) {
  return MarchSmem(ty, Z, lanes, B, march_stage(mode)).bytes(elem);
}

int pst_march_max_threads(int elem) {
  return elem == 4 ? kMarchMaxThreads<float> : kMarchMaxThreads<double>;
}

// Shared memory of a vcycle_tail block for the levels of meta ([n, then X,
// Y, Z a level]) with elements of elem bytes; -1 for levels it refuses.
long long pst_vcycle_tail_smem(const int* meta, int elem) {
  TailMeta m;
  return tail_meta(meta, false, &m) ? vcycle_tail_smem(m, elem) : -1;
}

// Shared memory of a cluster-tail block of `ranks` ranks for the tail's
// levels (meta as pst_vcycle_tail_smem's) below level A (meta_top: [2, A's
// X, Y, Z, the tail's top X, Y, Z]); -1 for a plan it refuses.
long long pst_cluster_tail_smem(const int* meta, const int* meta_top,
                                int ranks, int elem) {
  TailMeta m, ma;
  ClusterPlan pl;
  if (!tail_meta(meta, false, &m) || meta_top[0] != 2 ||
      !tail_meta(meta_top, false, &ma) || !cluster_plan(ma, ranks, &pl)) {
    return -1;
  }
  return cluster_tail_smem(m, ma, pl, elem);
}

int pst_cluster_max_ranks() { return kClusterMaxRanks; }

int pst_tail_max_levels() { return kTailMaxLevels; }

// The phase clocks of the last tail launch (see TailClock) into out[0..n),
// n <= kClkSlots, after the device has finished it; a build without
// PST_TAIL_CLOCKS keeps none and returns cudaErrorNotSupported.
int pst_tail_clocks(long long* out, int n) {
#ifdef PST_TAIL_CLOCKS
  if (n < 0 || n > kClkSlots) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(out, g_tail_clk, n * sizeof(long long));
#else
  (void)out;
  (void)n;
  return (int)cudaErrorNotSupported;
#endif
}

int pst_tail_clock_slots() { return kClkSlots; }

int pst_max_smem() { return kMaxSmem; }

const char* pst_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
