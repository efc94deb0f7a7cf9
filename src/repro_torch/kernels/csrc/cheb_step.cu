// K6 cheb_step: one step of the stochastic Chebyshev three-term recurrence.
//
//   w_next = 2 * (2 * (A @ w) - center * w) / width - w_prev
//   dots   = sum over rows of v * w_next                       (k,)
//
// Replaces the Pallas TPU kernel `cheb_step_kernel` / `cheb_step_pallas`
// (src/repro/kernels/fused_est.py:40/55), which holds A and the slabs in
// VMEM as one block (and falls back to jnp above an 8 MiB budget).  Here
// A streams once from device memory through the skinny GEMM tile of
// skinny_gemm.cuh, at every n.
//
// Bound: at n = 16384, k = 32, f32 the call moves 1.07 GB (A once, four
// slabs) and does 17.2 GFLOP: 0.32 ms by bytes against 0.26 ms by f32
// FFMA, near the ridge, so this plain FFMA kernel is limited by its
// instruction rate.  Design: the epilogue finishes the recurrence on the
// 32 x 32 output tile while `A @ w` is in registers, so the slab is read
// and written once; every multiply, subtract and divide is rounded as the
// plain version rounds it (no contraction into FMAs).  The probe dots are
// reduced without atomics: each block writes its column sums to a
// (tiles, k) buffer, and a second small launch adds them in tile order,
// so a repeated call is bitwise repeatable.  `center` and `width` are read
// from device memory: they come from `spectral_bounds` on the card, and a
// host float would stall the host on every step.
#include "skinny_gemm.cuh"

namespace {

using namespace repro;

template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
cheb_step_kernel(const T* __restrict__ a, const T* __restrict__ w,
                 const T* __restrict__ w_prev, const T* __restrict__ v,
                 const T* __restrict__ center, const T* __restrict__ width,
                 T* __restrict__ w_next, T* __restrict__ partials, long long n,
                 long long k) {
  const long long row0 = (long long)blockIdx.x * kGemmBM;
  const long long col0 = (long long)blockIdx.y * kGemmBN;
  T acc[2][4];
  skinny_gemm_tile<T>(a, w, n, n, k, row0, col0, acc);

  const int tx = threadIdx.x % 8;
  const int ty = threadIdx.x / 8;
  const T c = *center;
  const T wd = *width;
  T colsum[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long row = row0 + 2 * ty + i;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long col = col0 + 4 * tx + j;
      if (col >= k) continue;
      const long long idx = row * k + col;
      const T mv = div_rn(sub_rn(mul_rn(T(2), acc[i][j]), mul_rn(c, w[idx])), wd);
      const T wn = sub_rn(mul_rn(T(2), mv), w_prev[idx]);
      w_next[idx] = wn;
      colsum[j] = add_rn(colsum[j], mul_rn(v[idx], wn));
    }
  }
  block_column_sums<T>(colsum, partials + (long long)blockIdx.x * k, col0, k);
}

template <typename T>
int launch(const void* a, const void* w, const void* w_prev, const void* v,
           const void* center, const void* width, void* w_next, void* dots,
           void* partials, long long n, long long k, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const long long tiles = (n + kGemmBM - 1) / kGemmBM;
  const dim3 grid((unsigned)tiles, (unsigned)((k + kGemmBN - 1) / kGemmBN));
  cheb_step_kernel<T><<<grid, kGemmThreads, 0, s>>>(
      (const T*)a, (const T*)w, (const T*)w_prev, (const T*)v, (const T*)center,
      (const T*)width, (T*)w_next, (T*)partials, n, k);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  column_sum_kernel<T><<<(unsigned)((k + 127) / 128), 128, 0, s>>>(
      (const T*)partials, (T*)dots, tiles, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_cheb_step(int dtype, const void* a, const void* w,
                               const void* w_prev, const void* v,
                               const void* center, const void* width,
                               void* w_next, void* dots, void* partials,
                               long long n, long long k, void* stream) {
  if (n <= 0 || k <= 0) return 0;
  if (dtype == REPRO_F32)
    return launch<float>(a, w, w_prev, v, center, width, w_next, dots, partials,
                         n, k, stream);
  if (dtype == REPRO_F64)
    return launch<double>(a, w, w_prev, v, center, width, w_next, dots, partials,
                          n, k, stream);
  return (int)cudaErrorInvalidValue;
}
