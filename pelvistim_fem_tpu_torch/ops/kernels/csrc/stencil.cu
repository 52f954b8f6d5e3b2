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
//
// Layout is the natural one of the PyTorch tensors, C-contiguous:
//   x (X, Y, Z), C (27, X, Y, Z)
//   Xs (L, X, Y, Z), coeff (B, 27, X, Y, Z), sig (L, B)
//   Xm (X, Y, Z, L), coeff (B, 27, X, Y, Z), sig (B, L)   [lane-minor]
// with offset o = (dx+1)*9 + (dy+1)*3 + (dz+1) and zero outside the grid.
//
// Both kernels are bound by device-memory bandwidth: per grid point the
// single kernel reads 27 coefficients and writes one value, doing 27
// multiply-adds, far below the card's ratio of operations to bytes.  One
// thread computes one grid point; consecutive threads take consecutive z,
// so every coefficient plane and x row is read coalesced, and the 27
// neighbour reads of a warp hit the same few cache lines.
//
// The batched kernel keeps the TPU kernel's intent: the B*27 coefficient
// planes are not read once per lane.  A block covers kPoints grid points
// and kGroups lane groups of kLanes lanes; each thread computes kLanes
// lanes of one grid point, holding one accumulator per lane in registers,
// and forms each lane's combined coefficient sum_b sig[l, b] * C_b[o] on
// the fly from sigma held in shared memory.  The kGroups threads of one
// grid point sit in one block and load the same coefficients, so all but
// the first load of each are served by the SM's L1: device memory sees the
// coefficients once per kGroups * kLanes = 32 lanes, while each thread
// holds only kLanes accumulators.
//
// The lane-minor kernel gives one thread to one (grid point, lane) pair,
// lanes fastest, so a warp covers consecutive lanes of one or a few grid
// points: every neighbour read Xm[g + off, l] is one coalesced run across
// the warp, and every coefficient read C_b[o][g] is one address for all
// the lanes of a point (a broadcast).  Sigma (B x L) is staged in shared
// memory once per block and each thread keeps its lane's B values in
// registers.  Bound: device-memory bandwidth; each apply must read the
// B*27 coefficient planes once and the vectors once in, once out.
//
// Every entry point returns cudaGetLastError() of its launch (0 = ok),
// launches on the caller's stream and does not synchronise.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
// batched kernel: a block is kPoints grid points x kGroups lane groups,
// each thread kLanes lanes of one grid point
constexpr int kLanes = 4;
constexpr int kGroups = 8;
constexpr int kPoints = 256 / kGroups;
constexpr int kMaxBodies = 8;  // largest body count the batched kernel takes

template <typename T>
__global__ void __launch_bounds__(kBlock)
stencil_spmv_kernel(const T* __restrict__ x, const T* __restrict__ C,
                    T* __restrict__ y, int X, int Y, int Z) {
  const long long G = (long long)X * Y * Z;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= G) return;
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
        acc += C[(long long)o * G + p] * xv;
      }
    }
  }
  y[p] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kPoints * kGroups)
batched_stencil_spmv_kernel(const T* __restrict__ Xs,
                            const T* __restrict__ coeff,
                            const T* __restrict__ sig,
                            T* __restrict__ Ys, int L, int B, int X, int Y,
                            int Z) {
  constexpr int kBlockLanes = kGroups * kLanes;
  __shared__ T s_sig[kBlockLanes * kMaxBodies];
  const int lb = blockIdx.y * kBlockLanes;  // first lane of this block
  const int tid = threadIdx.y * kPoints + threadIdx.x;
  for (int t = tid; t < kBlockLanes * kMaxBodies; t += kPoints * kGroups) {
    const int l = t / kMaxBodies;
    const int b = t % kMaxBodies;
    s_sig[t] = (lb + l < L && b < B) ? sig[(long long)(lb + l) * B + b]
                                     : T(0);
  }
  __syncthreads();

  const long long G = (long long)X * Y * Z;
  const long long p = (long long)blockIdx.x * kPoints + threadIdx.x;
  const int l0 = lb + threadIdx.y * kLanes;  // first lane of this thread
  if (p >= G || l0 >= L) return;
  const int k = (int)(p % Z);
  const long long q = p / Z;
  const int j = (int)(q % Y);
  const int i = (int)(q / Y);
  const int nl = min(kLanes, L - l0);
  const T* s_lanes = s_sig + threadIdx.y * kLanes * kMaxBodies;

  T acc[kLanes];
#pragma unroll
  for (int l = 0; l < kLanes; ++l) acc[l] = T(0);

  int o = 0;
  for (int dx = -1; dx <= 1; ++dx) {
    const int ii = i + dx;
    const bool okx = ii >= 0 && ii < X;
    for (int dy = -1; dy <= 1; ++dy) {
      const int jj = j + dy;
      const bool oky = okx && jj >= 0 && jj < Y;
      for (int dz = -1; dz <= 1; ++dz, ++o) {
        const int kk = k + dz;
        const bool ok = oky && kk >= 0 && kk < Z;
        const long long nb = ((long long)ii * Y + jj) * Z + kk;
        T c[kMaxBodies];
#pragma unroll
        for (int b = 0; b < kMaxBodies; ++b) {
          c[b] = b < B ? coeff[((long long)b * 27 + o) * G + p] : T(0);
        }
#pragma unroll
        for (int l = 0; l < kLanes; ++l) {
          if (l < nl) {
            const T* s = s_lanes + l * kMaxBodies;
            T co = s[0] * c[0];
#pragma unroll
            for (int b = 1; b < kMaxBodies; ++b) {
              if (b < B) co += s[b] * c[b];
            }
            const T xv = ok ? Xs[(long long)(l0 + l) * G + nb] : T(0);
            acc[l] += co * xv;
          }
        }
      }
    }
  }
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    if (l < nl) Ys[(long long)(l0 + l) * G + p] = acc[l];
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
batched_stencil_spmv_lminor_kernel(const T* __restrict__ Xm,
                                   const T* __restrict__ coeff,
                                   const T* __restrict__ sig,
                                   T* __restrict__ Ym, int L, int B, int X,
                                   int Y, int Z) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  T* s_sig = reinterpret_cast<T*>(s_raw);  // (B, L), as in device memory
  for (int t = threadIdx.x; t < B * L; t += blockDim.x) s_sig[t] = sig[t];
  __syncthreads();

  const long long G = (long long)X * Y * Z;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= G * L) return;
  const int l = (int)(t % L);
  const long long p = t / L;  // grid point
  const int k = (int)(p % Z);
  const long long q = p / Z;
  const int j = (int)(q % Y);
  const int i = (int)(q / Y);

  T s[kMaxBodies];
#pragma unroll
  for (int b = 0; b < kMaxBodies; ++b) s[b] = b < B ? s_sig[b * L + l] : T(0);

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
        T co = s[0] * coeff[(long long)o * G + p];
#pragma unroll
        for (int b = 1; b < kMaxBodies; ++b) {
          if (b < B) co += s[b] * coeff[((long long)b * 27 + o) * G + p];
        }
        T xv = T(0);
        if (oky && kk >= 0 && kk < Z) {
          xv = Xm[(((long long)ii * Y + jj) * Z + kk) * L + l];
        }
        acc += co * xv;
      }
    }
  }
  Ym[t] = acc;
}

template <typename T>
int launch_stencil_spmv(const void* x, const void* C, void* y, int X, int Y,
                        int Z, void* stream) {
  const long long G = (long long)X * Y * Z;
  if (G == 0) return 0;
  const unsigned blocks = (unsigned)((G + kBlock - 1) / kBlock);
  stencil_spmv_kernel<T><<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)C, (T*)y, X, Y, Z);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_batched_stencil_spmv(const void* Xs, const void* coeff,
                                const void* sig, void* Ys, int L, int B,
                                int X, int Y, int Z, void* stream) {
  if (B < 1 || B > kMaxBodies) return (int)cudaErrorInvalidValue;
  const long long G = (long long)X * Y * Z;
  if (G == 0 || L == 0) return 0;
  constexpr int kBlockLanes = kGroups * kLanes;
  const dim3 grid((unsigned)((G + kPoints - 1) / kPoints),
                  (unsigned)((L + kBlockLanes - 1) / kBlockLanes));
  batched_stencil_spmv_kernel<T>
      <<<grid, dim3(kPoints, kGroups), 0, (cudaStream_t)stream>>>(
          (const T*)Xs, (const T*)coeff, (const T*)sig, (T*)Ys, L, B, X, Y,
          Z);
  return (int)cudaGetLastError();
}

// Largest sigma table (B x L) the lane-minor kernel stages in shared
// memory without opting in to more than the default 48 KB.
constexpr int kMaxSigBytes = 48 * 1024;

template <typename T>
int launch_batched_stencil_spmv_lminor(const void* Xm, const void* coeff,
                                       const void* sig, void* Ym, int L,
                                       int B, int X, int Y, int Z,
                                       void* stream) {
  if (B < 1 || B > kMaxBodies) return (int)cudaErrorInvalidValue;
  const size_t sig_bytes = (size_t)B * L * sizeof(T);
  if (sig_bytes > (size_t)kMaxSigBytes) return (int)cudaErrorInvalidValue;
  const long long n = (long long)X * Y * Z * L;
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + kBlock - 1) / kBlock);
  batched_stencil_spmv_lminor_kernel<T>
      <<<blocks, kBlock, sig_bytes, (cudaStream_t)stream>>>(
          (const T*)Xm, (const T*)coeff, (const T*)sig, (T*)Ym, L, B, X, Y,
          Z);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pst_max_bodies() { return kMaxBodies; }

int pst_stencil_spmv_f32(const void* x, const void* C, void* y, int X, int Y,
                         int Z, void* stream) {
  return launch_stencil_spmv<float>(x, C, y, X, Y, Z, stream);
}

int pst_stencil_spmv_f64(const void* x, const void* C, void* y, int X, int Y,
                         int Z, void* stream) {
  return launch_stencil_spmv<double>(x, C, y, X, Y, Z, stream);
}

int pst_batched_stencil_spmv_f32(const void* Xs, const void* coeff,
                                 const void* sig, void* Ys, int L, int B,
                                 int X, int Y, int Z, void* stream) {
  return launch_batched_stencil_spmv<float>(Xs, coeff, sig, Ys, L, B, X, Y,
                                            Z, stream);
}

int pst_batched_stencil_spmv_f64(const void* Xs, const void* coeff,
                                 const void* sig, void* Ys, int L, int B,
                                 int X, int Y, int Z, void* stream) {
  return launch_batched_stencil_spmv<double>(Xs, coeff, sig, Ys, L, B, X, Y,
                                             Z, stream);
}

int pst_max_lminor_sig_bytes() { return kMaxSigBytes; }

int pst_batched_stencil_spmv_lminor_f32(const void* Xm, const void* coeff,
                                        const void* sig, void* Ym, int L,
                                        int B, int X, int Y, int Z,
                                        void* stream) {
  return launch_batched_stencil_spmv_lminor<float>(Xm, coeff, sig, Ym, L, B,
                                                   X, Y, Z, stream);
}

int pst_batched_stencil_spmv_lminor_f64(const void* Xm, const void* coeff,
                                        const void* sig, void* Ym, int L,
                                        int B, int X, int Y, int Z,
                                        void* stream) {
  return launch_batched_stencil_spmv_lminor<double>(Xm, coeff, sig, Ym, L,
                                                    B, X, Y, Z, stream);
}

const char* pst_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
