// The skinny GEMM tile of K7 (cg_step), and the ordered column sum of
// partial dots that K6 (cheb_step) shares (K5 and K6 compute their
// products on skinny_mma.cuh's tile).
//
// It computes `A @ w` for a square A (n, n) and a slab w (n, k) of a few
// dozen probe columns; K7 then finishes an elementwise epilogue on the
// (32 x 32) output tile while it is still in registers.  A is read from device memory exactly
// once per 32 columns of the slab (once in all for k <= 32), so at k = 32
// an f32 call moves 4 bytes of A per 64 FLOP: near the card's f32 ridge,
// and bound by the FFMA rate of this plain shared-memory GEMM rather than
// by bytes.
//
// Each 128-thread block owns 32 rows and 32 columns of the output.  It
// streams its rows of A in chunks of 32 columns through shared memory
// (stored transposed, so each thread reads two adjacent rows at once),
// together with the matching 32 x 32 chunk of w; the next chunk's global
// loads are issued into registers before the current chunk is consumed,
// so they are in flight during the FMAs.  Thread (tx, ty) = (tid % 8,
// tid / 8) accumulates rows 2*ty + {0, 1} and columns 4*tx + {0..3} with
// FFMA in full f32 (DFMA for f64; no TF32).  The sum over A's columns
// runs in increasing order, which is another order than cuBLAS's: the
// plain versions are matched to a summation-order bound, not bitwise.
#pragma once

#include "repro_kernels.cuh"

#include <cfloat>

namespace repro {

constexpr int kGemmThreads = 128;
constexpr int kGemmBM = 32;   // rows of A (and of the output) per block
constexpr int kGemmBN = 32;   // slab columns per block
constexpr int kGemmBK = 32;   // columns of A per shared-memory chunk
constexpr int kGemmLoads = kGemmBM * kGemmBK / kGemmThreads;   // 8

template <typename T> __device__ __forceinline__ T tiny();
template <> __device__ __forceinline__ float tiny<float>() { return FLT_MIN; }
template <> __device__ __forceinline__ double tiny<double>() { return DBL_MIN; }

// acc[i][j] = sum_c a[row0 + 2*ty + i, c] * w[c, col0 + 4*tx + j] for a
// (m, n) and w (n, k), both row-major (zero where the row or column lies
// outside the matrix: no size need be a multiple of the tile).
template <typename T>
__device__ __forceinline__ void skinny_gemm_tile(const T* __restrict__ a,
                                                 const T* __restrict__ w,
                                                 long long m, long long n,
                                                 long long k,
                                                 long long row0, long long col0,
                                                 T (&acc)[2][4]) {
  __shared__ __align__(16) T as[kGemmBK][kGemmBM + 2];
  __shared__ __align__(16) T ws[kGemmBK][kGemmBN];
  const int tid = threadIdx.x;
  const int tx = tid % 8;
  const int ty = tid / 8;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = T(0);

  T ra[kGemmLoads];
  T rw[kGemmLoads];
  auto load = [&](long long k0) {
#pragma unroll
    for (int e = 0; e < kGemmLoads; ++e) {
      const int idx = tid + kGemmThreads * e;
      const int rr = idx / kGemmBK;
      const int kk = idx % kGemmBK;
      const long long gi = row0 + rr;
      const long long gc = k0 + kk;
      ra[e] = (gi < m && gc < n) ? a[gi * n + gc] : T(0);
      const int wk = idx / kGemmBN;
      const int wc = idx % kGemmBN;
      const long long gk = k0 + wk;
      const long long gj = col0 + wc;
      rw[e] = (gk < n && gj < k) ? w[gk * k + gj] : T(0);
    }
  };

  load(0);
  for (long long k0 = 0; k0 < n; k0 += kGemmBK) {
#pragma unroll
    for (int e = 0; e < kGemmLoads; ++e) {
      const int idx = tid + kGemmThreads * e;
      as[idx % kGemmBK][idx / kGemmBK] = ra[e];
      ws[idx / kGemmBN][idx % kGemmBN] = rw[e];
    }
    __syncthreads();
    if (k0 + kGemmBK < n) load(k0 + kGemmBK);
#pragma unroll 8
    for (int kk = 0; kk < kGemmBK; ++kk) {
      T av[2];
      T wv[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) av[i] = as[kk][2 * ty + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = ws[kk][4 * tx + j];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fma_rn(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// out[col0 + c] = the block's column sums of colsum (each thread holds
// its two rows' share for columns 4*tx + j), added over ty in order.
template <typename T>
__device__ __forceinline__ void block_column_sums(const T (&colsum)[4], T* __restrict__ out,
                                                  long long col0, long long k) {
  __shared__ T red[kGemmThreads / 8][kGemmBN];
  const int tid = threadIdx.x;
  const int tx = tid % 8;
  const int ty = tid / 8;
#pragma unroll
  for (int j = 0; j < 4; ++j) red[ty][4 * tx + j] = colsum[j];
  __syncthreads();
  if (tid < kGemmBN && col0 + tid < k) {
    T s = red[0][tid];
    for (int t = 1; t < kGemmThreads / 8; ++t) s = add_rn(s, red[t][tid]);
    out[col0 + tid] = s;
  }
}

// out[c] = sum over tiles t, in order, of partials[t, c]
template <typename T>
__global__ void column_sum_kernel(const T* __restrict__ partials, T* __restrict__ out,
                                  long long tiles, long long k) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= k) return;
  T s = T(0);
  for (long long t = 0; t < tiles; ++t) s = add_rn(s, partials[t * k + c]);
  out[c] = s;
}

}  // namespace repro
