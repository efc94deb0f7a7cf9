// K1 rank1_update: out = a - outer(pc, pr).
//
// Replaces the Pallas TPU kernel `rank1_update_kernel` /
// `rank1_update_pallas` (src/repro/kernels/condense_step.py:36/45).
//
// Bound: bytes.  Each element is read once and written once for one
// multiply and one subtract (0.25 FLOP/byte in f32), so the kernel can
// only approach the card's memory rate.  Design: every thread owns V
// contiguous columns (one 16-byte vector: 4 f32 or 2 f64), loads its V
// pivot-row values once, and walks kRowsPerBlock rows, so `a` and `out`
// stream with coalesced 16-byte accesses and `pr` is read once per
// kRowsPerBlock rows instead of once per element.  Rows whose width is
// not a multiple of V, or unaligned buffers, take a scalar path with the
// same arithmetic.  The multiply and the subtract round separately
// (`product`, `sub_rn`): bitwise equal to the plain version.
#include "repro_kernels.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 8;

template <typename T, typename OpT>
__global__ void __launch_bounds__(kThreads)
rank1_update_kernel(const T* __restrict__ a, const OpT* __restrict__ pc,
                    const OpT* __restrict__ pr, T* __restrict__ out,
                    long long m, long long n, bool vec) {
  using VT = typename repro::Vec16<T>::type;
  constexpr int V = repro::Vec16<T>::n;
  const long long j0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * V;
  if (j0 >= n) return;
  const int nv = (int)(n - j0 < V ? n - j0 : V);
  OpT prv[V];
#pragma unroll
  for (int v = 0; v < V; ++v)
    if (v < nv) prv[v] = pr[j0 + v];
  const long long i0 = (long long)blockIdx.y * kRowsPerBlock;
  const long long i1 = i0 + kRowsPerBlock < m ? i0 + kRowsPerBlock : m;
  for (long long i = i0; i < i1; ++i) {
    const OpT c = pc[i];
    const long long off = i * n + j0;
    if (vec) {
      alignas(16) T x[V];
      *reinterpret_cast<VT*>(x) = *reinterpret_cast<const VT*>(a + off);
#pragma unroll
      for (int v = 0; v < V; ++v)
        x[v] = repro::sub_rn(x[v], repro::product<T>(c, prv[v]));
      *reinterpret_cast<VT*>(out + off) = *reinterpret_cast<const VT*>(x);
    } else {
      for (int v = 0; v < nv; ++v)
        out[off + v] = repro::sub_rn(a[off + v], repro::product<T>(c, prv[v]));
    }
  }
}

template <typename T, typename OpT>
int launch(const void* a, const void* pc, const void* pr, void* out,
           long long m, long long n, void* stream) {
  constexpr int V = repro::Vec16<T>::n;
  const bool vec = n % V == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid((unsigned)((n + (long long)kThreads * V - 1) / ((long long)kThreads * V)),
                  (unsigned)((m + kRowsPerBlock - 1) / kRowsPerBlock));
  rank1_update_kernel<T, OpT><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)a, (const OpT*)pc, (const OpT*)pr, (T*)out, m, n, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_rank1_update(int dtype, int op_dtype, const void* a,
                                  const void* pc, const void* pr, void* out,
                                  long long m, long long n, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (dtype == REPRO_F32 && op_dtype == REPRO_F32)
    return launch<float, float>(a, pc, pr, out, m, n, stream);
  if (dtype == REPRO_F32 && op_dtype == REPRO_BF16)
    return launch<float, __nv_bfloat16>(a, pc, pr, out, m, n, stream);
  if (dtype == REPRO_F64 && op_dtype == REPRO_F64)
    return launch<double, double>(a, pc, pr, out, m, n, stream);
  if (dtype == REPRO_F64 && op_dtype == REPRO_BF16)
    return launch<double, __nv_bfloat16>(a, pc, pr, out, m, n, stream);
  return (int)cudaErrorInvalidValue;
}
