// K2 panel_update: out = a - c @ r, the subtract fused into the GEMM epilogue.
//
// Replaces the Pallas TPU kernel `panel_update_kernel` /
// `panel_update_pallas` (src/repro/kernels/panel_update.py:35/48).
//
// Bound: bytes.  At the panel width K = 32 an f32 call does 2*K = 64 FLOP
// per output element against 8 bytes of `a` read and written, 8 FLOP/byte,
// below the card's f32 ridge (67 TFLOP/s / 3.35 TB/s = 20).  Design: a
// tiled shared-memory GEMM.  Each 256-thread block owns a BM x BN output
// tile (128 x 128 for f32, 64 x 64 for f64), stages K-chunks of 32 of `c`
// and `r` in shared memory (widening bf16 operands to the accumulator type
// on load), and accumulates a register micro-tile per thread with FFMA in
// full f32 (DFMA for f64; no TF32, which would change the numbers the JAX
// package gives).  The epilogue reads each `a` element once, subtracts,
// and writes `out` once, so the trailing matrix crosses memory one time.
// Thread (tx, ty) owns rows ty + 16*i and columns tx + 16*j, so a warp's
// epilogue accesses are runs of 16 contiguous columns.  The sum runs in
// another order than cuBLAS's: the plain version is matched to a stated
// tolerance, not bitwise.  wgmma and TMA are later work.
#include "repro_kernels.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;

template <typename T, typename OpT, int BM, int BN>
__global__ void __launch_bounds__(kThreads)
panel_update_kernel(const T* __restrict__ a, const OpT* __restrict__ c,
                    const OpT* __restrict__ r, T* __restrict__ out,
                    long long m, long long n, long long k) {
  constexpr int TM = BM / 16;
  constexpr int TN = BN / 16;
  __shared__ T cs[kChunk][BM + 1];
  __shared__ T rs[kChunk][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long row0 = (long long)blockIdx.y * BM;
  const long long col0 = (long long)blockIdx.x * BN;

  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = T(0);

  for (long long k0 = 0; k0 < k; k0 += kChunk) {
    for (int idx = tid; idx < BM * kChunk; idx += kThreads) {
      const int rr = idx / kChunk;
      const int kk = idx % kChunk;
      const long long gi = row0 + rr;
      const long long gk = k0 + kk;
      cs[kk][rr] = (gi < m && gk < k) ? T(repro::widen(c[gi * k + gk])) : T(0);
    }
    for (int idx = tid; idx < kChunk * BN; idx += kThreads) {
      const int kk = idx / BN;
      const int cc = idx % BN;
      const long long gk = k0 + kk;
      const long long gj = col0 + cc;
      rs[kk][cc] = (gk < k && gj < n) ? T(repro::widen(r[gk * n + gj])) : T(0);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kChunk; ++kk) {
      T cv[TM];
      T rv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) cv[i] = cs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) rv[j] = rs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = repro::fma_rn(cv[i], rv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long gi = row0 + ty + 16 * i;
    if (gi >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const long long gj = col0 + tx + 16 * j;
      if (gj < n) out[gi * n + gj] = repro::sub_rn(a[gi * n + gj], acc[i][j]);
    }
  }
}

template <typename T, typename OpT, int BM, int BN>
int launch(const void* a, const void* c, const void* r, void* out, long long m,
           long long n, long long k, void* stream) {
  const dim3 grid((unsigned)((n + BN - 1) / BN), (unsigned)((m + BM - 1) / BM));
  panel_update_kernel<T, OpT, BM, BN><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)a, (const OpT*)c, (const OpT*)r, (T*)out, m, n, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_panel_update(int dtype, int op_dtype, const void* a,
                                  const void* c, const void* r, void* out,
                                  long long m, long long n, long long k,
                                  void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (dtype == REPRO_F32 && op_dtype == REPRO_F32)
    return launch<float, float, 128, 128>(a, c, r, out, m, n, k, stream);
  if (dtype == REPRO_F32 && op_dtype == REPRO_BF16)
    return launch<float, __nv_bfloat16, 128, 128>(a, c, r, out, m, n, k, stream);
  if (dtype == REPRO_F64 && op_dtype == REPRO_F64)
    return launch<double, double, 64, 64>(a, c, r, out, m, n, k, stream);
  if (dtype == REPRO_F64 && op_dtype == REPRO_BF16)
    return launch<double, __nv_bfloat16, 64, 64>(a, c, r, out, m, n, k, stream);
  return (int)cudaErrorInvalidValue;
}
