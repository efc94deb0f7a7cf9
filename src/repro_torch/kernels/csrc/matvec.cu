// K5 matvec: o = a @ x for a (m, n) and a slab x (n, k), or a vector.
//
// Replaces the Pallas TPU kernel `matvec_kernel` / `matvec_pallas`
// (src/repro/kernels/matvec.py:34/64), which accumulates (bm, K) output
// tiles in VMEM across a sequential reduction grid and zero-pads n to
// full tiles.  Its one caller is the local product of `ShardedOperator`:
// a rank's (L, n) row block against the replicated probe slab.
//
// Bound: bytes.  A is read once, about 4 bytes per 2k FLOP in f32; at
// n = 16384, k = 32 the call moves 1.07 GB against 17.2 GFLOP (0.32 ms by
// bytes, 0.26 ms by FFMA).  Design: two paths, chosen by k.
//  - k <= 4 (the power-iteration bounds of Chebyshev are single columns):
//    one warp per row of A streams the row in 16-byte vectors (scalar
//    loads when a row is not 16-byte aligned), multiplies each element by
//    the k entries of x it meets (x is small and stays in L1/L2), and the
//    warp reduces its 32 partial sums with shuffles.  No padding lanes.
//  - k > 4: the skinny shared-memory GEMM tile of skinny_gemm.cuh (32 x 32
//    output per 128-thread block, FFMA) on the rectangular block.
// Sums in full f32 (f64 for f64), no TF32; reads outside the matrix are
// bounds-checked zeros, where the Pallas kernel pads a copy.  The order
// of the sums differs from cuBLAS's, so the plain version is matched to
// a rounding bound (kernels/ref.py:matvec_bound), not bitwise.
#include "skinny_gemm.cuh"

namespace {

using namespace repro;

constexpr int kRowWarps = 8;   // rows (warps) per 256-thread block, GEMV path
constexpr int kMaxGemvCols = 4;

template <typename T, int KC, bool VEC>
__global__ void __launch_bounds__(32 * kRowWarps)
matvec_rows_kernel(const T* __restrict__ a, const T* __restrict__ x,
                   T* __restrict__ o, long long m, long long n) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kRowWarps + threadIdx.x / 32;
  if (row >= m) return;                       // the whole warp leaves
  const T* __restrict__ arow = a + row * n;
  T acc[KC];
#pragma unroll
  for (int j = 0; j < KC; ++j) acc[j] = T(0);
  if constexpr (VEC) {
    using V = typename Vec16<T>::type;
    constexpr int W = Vec16<T>::n;
    const V* __restrict__ av = reinterpret_cast<const V*>(arow);
    const long long nv = n / W;
#pragma unroll 4
    for (long long c = lane; c < nv; c += 32) {
      const V v = __ldg(av + c);
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int q = 0; q < W; ++q) {
        const T* xr = x + (c * W + q) * KC;
#pragma unroll
        for (int j = 0; j < KC; ++j) acc[j] = fma_rn(e[q], __ldg(xr + j), acc[j]);
      }
    }
  } else {
#pragma unroll 4
    for (long long c = lane; c < n; c += 32) {
      const T e = __ldg(arow + c);
#pragma unroll
      for (int j = 0; j < KC; ++j) acc[j] = fma_rn(e, __ldg(x + c * KC + j), acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < KC; ++j)
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      acc[j] = add_rn(acc[j], __shfl_xor_sync(0xffffffffu, acc[j], off));
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < KC; ++j) o[row * KC + j] = acc[j];
  }
}

template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
matvec_tile_kernel(const T* __restrict__ a, const T* __restrict__ x,
                   T* __restrict__ o, long long m, long long n, long long k) {
  const long long row0 = (long long)blockIdx.x * kGemmBM;
  const long long col0 = (long long)blockIdx.y * kGemmBN;
  T acc[2][4];
  skinny_gemm_tile<T>(a, x, m, n, k, row0, col0, acc);
  const int tx = threadIdx.x % 8;
  const int ty = threadIdx.x / 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long row = row0 + 2 * ty + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long col = col0 + 4 * tx + j;
      if (col < k) o[row * k + col] = acc[i][j];
    }
  }
}

template <typename T, int KC>
void launch_rows(const T* a, const T* x, T* o, long long m, long long n,
                 cudaStream_t s) {
  const unsigned blocks = (unsigned)((m + kRowWarps - 1) / kRowWarps);
  const bool vec = n % Vec16<T>::n == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  if (vec)
    matvec_rows_kernel<T, KC, true><<<blocks, 32 * kRowWarps, 0, s>>>(a, x, o, m, n);
  else
    matvec_rows_kernel<T, KC, false><<<blocks, 32 * kRowWarps, 0, s>>>(a, x, o, m, n);
}

template <typename T>
int launch(const void* a_, const void* x_, void* o_, long long m, long long n,
           long long k, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const T* a = (const T*)a_;
  const T* x = (const T*)x_;
  T* o = (T*)o_;
  switch (k) {
    case 1: launch_rows<T, 1>(a, x, o, m, n, s); break;
    case 2: launch_rows<T, 2>(a, x, o, m, n, s); break;
    case 3: launch_rows<T, 3>(a, x, o, m, n, s); break;
    case 4: launch_rows<T, 4>(a, x, o, m, n, s); break;
    default: {
      const dim3 grid((unsigned)((m + kGemmBM - 1) / kGemmBM),
                      (unsigned)((k + kGemmBN - 1) / kGemmBN));
      matvec_tile_kernel<T><<<grid, kGemmThreads, 0, s>>>(a, x, o, m, n, k);
    }
  }
  static_assert(kMaxGemvCols == 4, "the switch above covers k = 1..4");
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_matvec(int dtype, const void* a, const void* x, void* o,
                            long long m, long long n, long long k,
                            void* stream) {
  if (m <= 0 || k <= 0) return 0;
  if (dtype == REPRO_F32) return launch<float>(a, x, o, m, n, k, stream);
  if (dtype == REPRO_F64) return launch<double>(a, x, o, m, n, k, stream);
  return (int)cudaErrorInvalidValue;
}
