// K1 rank1_update: out = a - outer(pc, pr).
//
// Replaces the Pallas TPU kernel `rank1_update_kernel` /
// `rank1_update_pallas` (src/repro/kernels/condense_step.py:36/45).
//
// Bound: bytes.  Each element is read once and written once for one
// multiply and one subtract (0.25 FLOP/byte in f32), so the kernel can
// only approach the card's memory rate, and it gets there only with
// enough of `a` in flight on every SM.  Design (each choice measured on an
// H100 against its alternatives, tools/k1_k6_variants.py; ms f32 / f64 at
// 8192 x 8192):
//  - Every thread owns V contiguous columns (one 16-byte vector: 4 f32 or
//    2 f64) and loads its V pivot-row values once.
//  - It takes its rows kRows = 8 at a time and issues all eight loads of
//    `a` (and of `pc`) before the first subtract, so eight 16-byte loads a
//    thread are in flight: 0.1807 / 0.3566, against 0.1865 / 0.3987 for
//    the first K1, which loaded, subtracted and stored one row before it
//    loaded the next, and 0.1793 / 0.3579 for a pure copy of the same
//    bytes (`o.copy_(a)`).  Four rows at a time: 0.1816 / 0.3561.
//  - One block per group of eight rows, so the card schedules short-lived
//    blocks as SMs free up.  Persistent blocks (as many as the card holds
//    at once, each walking the same number of groups with `pr` in
//    registers) took 0.1947 / 0.3781.
//  - Calls of fewer than eight rows (the mesh lookahead's one-row calls)
//    take a one-row instance, a smaller body: 2.27 / 2.23 us at (1,
//    8192), against 2.71 / 2.60 through the eight-row one and 2.37 / 2.51
//    for the first K1.
//  - Rows whose width is not a multiple of V, or unaligned buffers, take
//    a scalar path with the same batching and the same arithmetic.
// The multiply and the subtract round separately (`product`, `sub_rn`):
// bitwise equal to the plain version, signed zeros, infinities and NaNs
// included.  (K2 with K = 1 would not be: its FMA chain from zero turns a
// -0 product into +0.)
// A (B, M, N) stack is ONE launch, the port of what `vmap` does to the
// Pallas call's grid: blockIdx.z walks the matrices (grid-stride past
// 65535), so a stack's step costs the host one launch, not B.  Each
// element's arithmetic is the single matrix's, so matrix b of a stack
// equals the one-matrix launch on it bit for bit.  `a` may lie with a
// batch stride above M * N (Gaussian elimination's rows below the pivot);
// pc (B, M), pr (B, N) and out are contiguous.
#include "repro_kernels.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;   // rows a thread loads before its first subtract
constexpr long long kMaxGridZ = 65535;   // matrices of a stack in flight at once

// Block (blockIdx.x, blockIdx.y, blockIdx.z) owns kThreads * V columns of
// R rows of matrices blockIdx.z, blockIdx.z + gridDim.z, ... of the stack
// (one matrix: gridDim.z = 1)
template <typename T, typename OpT, bool VEC, int R>
__global__ void __launch_bounds__(kThreads)
rank1_update_kernel(const T* __restrict__ a, const OpT* __restrict__ pc,
                    const OpT* __restrict__ pr, T* __restrict__ out,
                    long long batch, long long m, long long n,
                    long long a_stride) {
  using VT = typename repro::Vec16<T>::type;
  constexpr int V = repro::Vec16<T>::n;
  const long long j0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * V;
  if (j0 >= n) return;
  const int nv = (int)(n - j0 < V ? n - j0 : V);
  const long long i0 = (long long)blockIdx.y * R;
  const int rows = (int)(m - i0 < R ? m - i0 : R);
  for (long long b = blockIdx.z; b < batch; b += gridDim.z) {
    const T* ab = a + b * a_stride;
    const OpT* pcb = pc + b * m;
    const OpT* prb = pr + b * n;
    T* ob = out + b * m * n;
    OpT prv[V];
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (v < nv) prv[v] = prb[j0 + v];
    OpT c[R];
    if constexpr (VEC) {
      VT x[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < rows) {
          x[r] = *reinterpret_cast<const VT*>(ab + (i0 + r) * n + j0);
          c[r] = pcb[i0 + r];
        }
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < rows) {
          alignas(16) T y[V];
          *reinterpret_cast<VT*>(y) = x[r];
#pragma unroll
          for (int v = 0; v < V; ++v)
            y[v] = repro::sub_rn(y[v], repro::product<T>(c[r], prv[v]));
          *reinterpret_cast<VT*>(ob + (i0 + r) * n + j0) = *reinterpret_cast<const VT*>(y);
        }
    } else {
      T x[R][V];
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < rows) {
          c[r] = pcb[i0 + r];
#pragma unroll
          for (int v = 0; v < V; ++v)
            if (v < nv) x[r][v] = ab[(i0 + r) * n + j0 + v];
        }
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < rows) {
#pragma unroll
          for (int v = 0; v < V; ++v)
            if (v < nv)
              ob[(i0 + r) * n + j0 + v] =
                  repro::sub_rn(x[r][v], repro::product<T>(c[r], prv[v]));
        }
    }
  }
}

template <typename T, typename OpT, bool VEC, int R>
int launch_kernel(const void* a, const void* pc, const void* pr, void* out,
                  long long batch, long long m, long long n, long long a_stride,
                  void* stream) {
  constexpr int V = repro::Vec16<T>::n;
  const auto kernel = rank1_update_kernel<T, OpT, VEC, R>;
  const long long col_blocks = (n + (long long)kThreads * V - 1) / ((long long)kThreads * V);
  const long long groups = (m + R - 1) / R;
  const long long mats = batch < kMaxGridZ ? batch : kMaxGridZ;
  kernel<<<dim3((unsigned)col_blocks, (unsigned)groups, (unsigned)mats), kThreads, 0,
           (cudaStream_t)stream>>>((const T*)a, (const OpT*)pc, (const OpT*)pr, (T*)out,
                                   batch, m, n, a_stride);
  return (int)cudaGetLastError();
}

// Calls of fewer than kRows rows (the mesh lookahead's one-row calls) take
// the one-row instance, which runs them sooner (measured, above)
template <typename T, typename OpT, bool VEC>
int launch_rows(const void* a, const void* pc, const void* pr, void* out,
                long long batch, long long m, long long n, long long a_stride,
                void* stream) {
  return m < kRows
             ? launch_kernel<T, OpT, VEC, 1>(a, pc, pr, out, batch, m, n, a_stride, stream)
             : launch_kernel<T, OpT, VEC, kRows>(a, pc, pr, out, batch, m, n, a_stride, stream);
}

template <typename T, typename OpT>
int launch(const void* a, const void* pc, const void* pr, void* out,
           long long batch, long long m, long long n, long long a_stride,
           void* stream) {
  constexpr int V = repro::Vec16<T>::n;
  const bool vec = n % V == 0 && a_stride % V == 0 &&
                   reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return vec ? launch_rows<T, OpT, true>(a, pc, pr, out, batch, m, n, a_stride, stream)
             : launch_rows<T, OpT, false>(a, pc, pr, out, batch, m, n, a_stride, stream);
}

}  // namespace

extern "C" int repro_rank1_update(int dtype, int op_dtype, const void* a,
                                  const void* pc, const void* pr, void* out,
                                  long long batch, long long m, long long n,
                                  long long a_stride, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return 0;
  if (a_stride < m * n) return (int)cudaErrorInvalidValue;
  if (dtype == REPRO_F32 && op_dtype == REPRO_F32)
    return launch<float, float>(a, pc, pr, out, batch, m, n, a_stride, stream);
  if (dtype == REPRO_F32 && op_dtype == REPRO_BF16)
    return launch<float, __nv_bfloat16>(a, pc, pr, out, batch, m, n, a_stride, stream);
  if (dtype == REPRO_F64 && op_dtype == REPRO_F64)
    return launch<double, double>(a, pc, pr, out, batch, m, n, a_stride, stream);
  if (dtype == REPRO_F64 && op_dtype == REPRO_BF16)
    return launch<double, __nv_bfloat16>(a, pc, pr, out, batch, m, n, a_stride, stream);
  return (int)cudaErrorInvalidValue;
}
