// K3 fused_step: out = swap_select(a; l <-> last) - outer(pc, pr), one pass.
//
// Replaces the Pallas TPU kernel `fused_step_kernel` / `fused_step_pallas`
// (src/repro/kernels/fused_step.py:40/56).
//
// Bound: bytes, as K1: one read and one write of every element; the
// column select adds no traffic beyond the two (m,) column slabs.  Design:
// K1's layout (16-byte vectors of contiguous columns, kRowsPerBlock rows
// per block, the pivot row in registers), with the §2.4 column swap done
// as a per-element select.  The pivot column `l` is read from device
// memory -- it is the argmax the caller computed on the card, so the host
// never waits for it -- and `last` is a launch argument.  The multiply and
// the subtract round separately: bitwise equal to the plain version and
// to the scatter swap followed by K1.
// A (B, M, N) stack is one launch, blockIdx.z walking the matrices as in
// K1; matrix b reads its own pivot column l[b] (a (B,) device array),
// while `last` is shared: every matrix of a stack is at the same step.
#include "repro_kernels.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 8;
constexpr long long kMaxGridZ = 65535;   // matrices of a stack in flight at once

template <typename T, typename OpT>
__global__ void __launch_bounds__(kThreads)
fused_step_kernel(const T* __restrict__ a, const long long* __restrict__ lp,
                  long long last, const OpT* __restrict__ pc,
                  const OpT* __restrict__ pr, const T* __restrict__ col_l,
                  const T* __restrict__ col_last, T* __restrict__ out,
                  long long batch, long long m, long long n, bool vec) {
  using VT = typename repro::Vec16<T>::type;
  constexpr int V = repro::Vec16<T>::n;
  const long long j0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * V;
  if (j0 >= n) return;
  const int nv = (int)(n - j0 < V ? n - j0 : V);
  const long long i0 = (long long)blockIdx.y * kRowsPerBlock;
  const long long i1 = i0 + kRowsPerBlock < m ? i0 + kRowsPerBlock : m;
  for (long long b = blockIdx.z; b < batch; b += gridDim.z) {
    const long long l = lp[b];
    const T* ab = a + b * m * n;
    T* ob = out + b * m * n;
    OpT prv[V];
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (v < nv) prv[v] = pr[b * n + j0 + v];
    for (long long i = i0; i < i1; ++i) {
      const OpT c = pc[b * m + i];
      const T cl = col_l[b * m + i];
      const T clast = col_last[b * m + i];
      const long long off = i * n + j0;
      alignas(16) T x[V];
      if (vec) {
        *reinterpret_cast<VT*>(x) = *reinterpret_cast<const VT*>(ab + off);
      } else {
        for (int v = 0; v < nv; ++v) x[v] = ab[off + v];
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (v >= nv) break;
        const long long j = j0 + v;
        const T s = j == l ? clast : (j == last ? cl : x[v]);
        x[v] = repro::sub_rn(s, repro::product<T>(c, prv[v]));
      }
      if (vec) {
        *reinterpret_cast<VT*>(ob + off) = *reinterpret_cast<const VT*>(x);
      } else {
        for (int v = 0; v < nv; ++v) ob[off + v] = x[v];
      }
    }
  }
}

template <typename T, typename OpT>
int launch(const void* a, const void* l, long long last, const void* pc,
           const void* pr, const void* col_l, const void* col_last, void* out,
           long long batch, long long m, long long n, void* stream) {
  constexpr int V = repro::Vec16<T>::n;
  const bool vec = n % V == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid((unsigned)((n + (long long)kThreads * V - 1) / ((long long)kThreads * V)),
                  (unsigned)((m + kRowsPerBlock - 1) / kRowsPerBlock),
                  (unsigned)(batch < kMaxGridZ ? batch : kMaxGridZ));
  fused_step_kernel<T, OpT><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)a, (const long long*)l, last, (const OpT*)pc, (const OpT*)pr,
      (const T*)col_l, (const T*)col_last, (T*)out, batch, m, n, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_fused_step(int dtype, int op_dtype, const void* a,
                                const void* l, long long last, const void* pc,
                                const void* pr, const void* col_l,
                                const void* col_last, void* out,
                                long long batch, long long m, long long n,
                                void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return 0;
  if (dtype == REPRO_F32 && op_dtype == REPRO_F32)
    return launch<float, float>(a, l, last, pc, pr, col_l, col_last, out, batch, m, n, stream);
  if (dtype == REPRO_F32 && op_dtype == REPRO_BF16)
    return launch<float, __nv_bfloat16>(a, l, last, pc, pr, col_l, col_last, out, batch, m, n,
                                        stream);
  if (dtype == REPRO_F64 && op_dtype == REPRO_F64)
    return launch<double, double>(a, l, last, pc, pr, col_l, col_last, out, batch, m, n, stream);
  if (dtype == REPRO_F64 && op_dtype == REPRO_BF16)
    return launch<double, __nv_bfloat16>(a, l, last, pc, pr, col_l, col_last, out, batch, m, n,
                                         stream);
  return (int)cudaErrorInvalidValue;
}
