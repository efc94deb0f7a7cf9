// K7 cg_step: the matvec-and-axpy chain of one conjugate-gradient step.
//
//   ap    = A @ p
//   alpha = rz / sum over rows of p * ap      (0 where |den| <= FLT/DBL_MIN)
//   x_new = x + alpha * p,   r_new = r - alpha * ap
//
// Replaces the Pallas TPU kernel `cg_step_kernel` / `cg_step_pallas`
// (src/repro/kernels/fused_est.py:85/103), a single VMEM-resident block
// (with a jnp fallback above an 8 MiB budget).  Here it runs at every n.
//
// Bound: the same as K6's, 0.32 ms by bytes at n = 16384, k = 32, f32 (A
// once, the slabs), with 17.2 GFLOP of FFMA beside it.  Design: alpha
// needs the dot over all n rows before either axpy can run, and blocks of
// a launch cannot wait on each other, so the chain is two launches behind
// one entry point.  Phase 1 is the skinny GEMM tile of skinny_gemm.cuh:
// it writes `ap` and each block's column sums of p * ap to a (tiles, k)
// buffer.  Phase 2 reduces those partials in a fixed order (each warp
// takes columns, each lane a strided run of tiles, then a fixed shuffle
// tree), forms the guarded alpha exactly as the plain version does, and
// runs both axpys with every product rounded before it is added.  No
// atomics: a repeated call is bitwise repeatable.  `rz` stays on the card.
#include "skinny_gemm.cuh"

namespace {

using namespace repro;

constexpr int kUpdateThreads = 256;
constexpr long long kUpdateRows = 128;

template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
cg_matvec_kernel(const T* __restrict__ a, const T* __restrict__ p,
                 T* __restrict__ ap, T* __restrict__ partials, long long n,
                 long long k) {
  const long long row0 = (long long)blockIdx.x * kGemmBM;
  const long long col0 = (long long)blockIdx.y * kGemmBN;
  T acc[2][4];
  skinny_gemm_tile<T>(a, p, n, n, k, row0, col0, acc);

  const int tx = threadIdx.x % 8;
  const int ty = threadIdx.x / 8;
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
      ap[idx] = acc[i][j];
      colsum[j] = add_rn(colsum[j], mul_rn(p[idx], acc[i][j]));
    }
  }
  block_column_sums<T>(colsum, partials + (long long)blockIdx.x * k, col0, k);
}

template <typename T>
__global__ void __launch_bounds__(kUpdateThreads)
cg_update_kernel(const T* __restrict__ partials, long long tiles,
                 const T* __restrict__ rz, const T* __restrict__ p,
                 const T* __restrict__ x, const T* __restrict__ r,
                 const T* __restrict__ ap, T* __restrict__ x_new,
                 T* __restrict__ r_new, long long n, long long k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* alpha = reinterpret_cast<T*>(smem_raw);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  for (long long c = warp; c < k; c += kUpdateThreads / 32) {
    T s = T(0);
    for (long long t = lane; t < tiles; t += 32) s = add_rn(s, partials[t * k + c]);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) s = add_rn(s, __shfl_down_sync(0xffffffffu, s, off));
    if (lane == 0) alpha[c] = abs_(s) > tiny<T>() ? div_rn(rz[c], s) : T(0);
  }
  __syncthreads();
  const long long start = (long long)blockIdx.x * kUpdateRows * k;
  const long long end = min(n, ((long long)blockIdx.x + 1) * kUpdateRows) * k;
  for (long long e = start + threadIdx.x; e < end; e += kUpdateThreads) {
    const T al = alpha[e % k];
    x_new[e] = add_rn(x[e], mul_rn(al, p[e]));
    r_new[e] = sub_rn(r[e], mul_rn(al, ap[e]));
  }
}

template <typename T>
int launch(const void* a, const void* p, const void* x, const void* r,
           const void* rz, void* x_new, void* r_new, void* ap, void* partials,
           long long n, long long k, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const long long tiles = (n + kGemmBM - 1) / kGemmBM;
  const dim3 grid((unsigned)tiles, (unsigned)((k + kGemmBN - 1) / kGemmBN));
  cg_matvec_kernel<T><<<grid, kGemmThreads, 0, s>>>(
      (const T*)a, (const T*)p, (T*)ap, (T*)partials, n, k);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const unsigned blocks = (unsigned)((n + kUpdateRows - 1) / kUpdateRows);
  cg_update_kernel<T><<<blocks, kUpdateThreads, k * sizeof(T), s>>>(
      (const T*)partials, tiles, (const T*)rz, (const T*)p, (const T*)x,
      (const T*)r, (const T*)ap, (T*)x_new, (T*)r_new, n, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_cg_step(int dtype, const void* a, const void* p,
                             const void* x, const void* r, const void* rz,
                             void* x_new, void* r_new, void* ap,
                             void* partials, long long n, long long k,
                             void* stream) {
  if (n <= 0 || k <= 0) return 0;
  if (dtype == REPRO_F32)
    return launch<float>(a, p, x, r, rz, x_new, r_new, ap, partials, n, k, stream);
  if (dtype == REPRO_F64)
    return launch<double>(a, p, x, r, rz, x_new, r_new, ap, partials, n, k, stream);
  return (int)cudaErrorInvalidValue;
}
