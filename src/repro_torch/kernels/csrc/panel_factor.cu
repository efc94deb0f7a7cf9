// K4 panel_factor: K sequential condensation steps on a (K, N) panel.
//
// Replaces the Pallas TPU kernel `panel_factor_kernel` /
// `panel_factor_pallas` (src/repro/kernels/panel_factor.py:31/83).
//
// Bound: latency.  The K steps depend on one another (each argmax needs
// the previous update), and the bytes are few: one read of the panel and
// one write of R, about 2 MiB for (32, 8192) f32, well under a
// microsecond at the memory rate.  The TPU kernel keeps the panel in its
// 8 MiB of VMEM; a Hopper block has at most 227 KB of shared memory, so
// this design keeps the panel in global memory, where after the first
// touch it stays in the 50 MB L2, and runs ONE block of 1024 threads that
// loops over the steps, separated by __syncthreads():
//   1. block argmax of |R[j, c]| over the live columns c < m0 - j (warp
//      shuffles, then one warp over the 32 warp winners), ties to the
//      LOWEST index and NaN above every number, as torch.argmax;
//   2. swap columns l <-> last across the K rows;
//   3. normalize the pivot row over all N columns, pr[last] = 1 unless
//      the pivot is 0;
//   4. rank-1 update of all K rows with the pivot column zeroed at rows
//      <= j; each thread owns whole columns, so it reads pr[c] before any
//      row of column c is rewritten;
//   5. thread 0 accumulates ls, the sign (parity (r_pos + m - 1) % 2) and
//      log|det|.
// Every multiply, subtract and divide rounds on its own: R and ls equal
// the plain version bit for bit.  Keeping the panel in shared memory when
// it fits, or spreading a step over a cluster, is later work.
#include "repro_kernels.cuh"

#include <cmath>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxRows = 1024;

// does (v, i) beat (b, bi) as the argmax?  bi < 0 means "no candidate"
template <typename T>
__device__ __forceinline__ bool better(T v, long long i, T b, long long bi) {
  if (i < 0) return false;
  if (bi < 0) return true;
  const bool vn = isnan(v);
  const bool bn = isnan(b);
  if (vn != bn) return vn;
  if (!vn && v != b) return v > b;
  return i < bi;
}

template <typename T>
__device__ __forceinline__ void warp_argmax(T& v, long long& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_down_sync(0xffffffffu, v, off);
    const long long oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
panel_factor_kernel(const T* __restrict__ panel, T* __restrict__ R,
                    long long* __restrict__ ls, T* __restrict__ sign_logdet,
                    int K, long long n, long long m0, long long r_pos) {
  __shared__ T s_val[kThreads / 32];
  __shared__ long long s_idx[kThreads / 32];
  __shared__ T s_pc[kMaxRows];
  __shared__ long long s_l;
  __shared__ T s_pv;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  for (long long e = tid; e < (long long)K * n; e += kThreads) R[e] = panel[e];
  __syncthreads();

  T sign = T(1);
  T logdet = T(0);
  for (int j = 0; j < K; ++j) {
    const long long m = m0 - j;
    const long long last = m - 1;
    T* row = R + (long long)j * n;

    // 1. argmax over the live prefix of the pivot row
    T best = T(0);
    long long bi = -1;
    for (long long c = tid; c < m; c += kThreads) {
      const T v = repro::abs_(row[c]);
      if (better(v, c, best, bi)) {
        best = v;
        bi = c;
      }
    }
    warp_argmax(best, bi);
    if (lane == 0) {
      s_val[warp] = best;
      s_idx[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      best = s_val[lane];
      bi = s_idx[lane];
      warp_argmax(best, bi);
      if (lane == 0) {
        s_l = bi;
        s_pv = row[bi];
      }
    }
    __syncthreads();
    const long long l = s_l;
    const T pv = s_pv;

    // 2. swap columns l <-> last across the panel
    if (l != last) {
      for (int i = tid; i < K; i += kThreads) {
        const T x = R[(long long)i * n + l];
        R[(long long)i * n + l] = R[(long long)i * n + last];
        R[(long long)i * n + last] = x;
      }
    }
    __syncthreads();

    // 3. normalize the pivot row over all n columns
    for (long long c = tid; c < n; c += kThreads) {
      T p = pv == T(0) ? T(0) : repro::div_rn(row[c], pv);
      if (c == last && pv != T(0)) p = T(1);
      row[c] = p;
    }
    __syncthreads();

    // 4. rank-1 update of every row; the pivot column is zero at rows <= j
    for (int i = tid; i < K; i += kThreads)
      s_pc[i] = i <= j ? T(0) : R[(long long)i * n + last];
    __syncthreads();
    for (long long c = tid; c < n; c += kThreads) {
      const T prc = row[c];
      for (int i = 0; i < K; ++i) {
        T* x = R + (long long)i * n + c;
        *x = repro::sub_rn(*x, repro::mul_rn(s_pc[i], prc));
      }
    }
    __syncthreads();

    // 5. bookkeeping
    if (tid == 0) {
      ls[j] = l;
      const T parity = (r_pos + m - 1) % 2 == 0 ? T(1) : T(-1);
      const T swap_sign = l == last ? T(1) : T(-1);
      // as torch.sign: (0 < x) - (x < 0), so 0 and NaN give 0
      const T sgn = T(T(0) < pv) - T(pv < T(0));
      sign = sign * sgn * swap_sign * parity;
      logdet = logdet + repro::log_(repro::abs_(pv));
    }
  }
  if (tid == 0) {
    sign_logdet[0] = sign;
    sign_logdet[1] = logdet;
  }
}

template <typename T>
int launch(const void* panel, void* r, void* ls, void* sign_logdet,
           long long k, long long n, long long m0, long long r_pos,
           void* stream) {
  panel_factor_kernel<T><<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)panel, (T*)r, (long long*)ls, (T*)sign_logdet, (int)k, n, m0,
      r_pos);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_panel_factor(int dtype, const void* panel, void* r,
                                  void* ls, void* sign_logdet, long long k,
                                  long long n, long long m0, long long r_pos,
                                  void* stream) {
  if (k <= 0 || k > kMaxRows || m0 < k || m0 > n) return (int)cudaErrorInvalidValue;
  if (dtype == REPRO_F32)
    return launch<float>(panel, r, ls, sign_logdet, k, n, m0, r_pos, stream);
  if (dtype == REPRO_F64)
    return launch<double>(panel, r, ls, sign_logdet, k, n, m0, r_pos, stream);
  return (int)cudaErrorInvalidValue;
}
