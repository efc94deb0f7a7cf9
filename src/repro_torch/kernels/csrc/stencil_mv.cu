// K8 stencil_mv: the banded product of a stencil operator.
//
//   y[i, :] = sum_d bands[d, i] * x[i + offsets[d], :]   (zero outside [0, n))
//
// Replaces the Pallas TPU kernel `stencil_mv_kernel` / `stencil_mv_pallas`
// (src/repro/kernels/stencil_mv.py:34/46), which copies x into a
// zero-padded slab held whole in VMEM.
//
// Bound: bytes.  One multiply and one add per band entry and column
// against 4 bytes of x (or y) each: far below the ridge.  At a 1024 x 1024
// lattice, k = 32, five bands, f32 the call moves x 134 MB + y 134 MB +
// bands 21 MB = 289 MB, 0.086 ms at 3.35 TB/s.  Design: one thread per
// (row, 16-byte vector of columns) of the (n, k) slab, so a warp reads
// and writes contiguous runs of the row-major slab; the band coefficient
// of a row is one load shared by its vector.  Rows a band reaches outside
// [0, n) read zeros by a bounds check (no padded copy of x), and the
// product with that zero is still added, so the arithmetic is exactly the
// plain version's: bands summed in order d = 0..nb-1 from a zero
// accumulator, each product rounded before it is added.  The result is
// bitwise equal to the plain version.  The neighbours a band reads again
// (the +-1 and +-lattice-row offsets) come from L1/L2, not device memory.
// Offsets are host integers passed by value, at most REPRO_MAX_BANDS.
#include "repro_kernels.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 256;

struct Offsets {
  long long v[REPRO_MAX_BANDS];
};

template <typename T, int V>
struct Pack {
  T v[V];
};

__device__ __forceinline__ void unpack(const float4& q, Pack<float, 4>& o) {
  o.v[0] = q.x; o.v[1] = q.y; o.v[2] = q.z; o.v[3] = q.w;
}
__device__ __forceinline__ void unpack(const double2& q, Pack<double, 2>& o) {
  o.v[0] = q.x; o.v[1] = q.y;
}
__device__ __forceinline__ float4 repack(const Pack<float, 4>& p) {
  return make_float4(p.v[0], p.v[1], p.v[2], p.v[3]);
}
__device__ __forceinline__ double2 repack(const Pack<double, 2>& p) {
  return make_double2(p.v[0], p.v[1]);
}

// V values from p: one 16-byte load when V fills a vector (p is then
// 16-byte aligned), else V scalar loads
template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_pack(const T* p) {
  Pack<T, V> out;
  if constexpr (V == Vec16<T>::n) {
    unpack(*reinterpret_cast<const typename Vec16<T>::type*>(p), out);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) out.v[e] = p[e];
  }
  return out;
}

template <typename T, int V>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, V>& x) {
  if constexpr (V == Vec16<T>::n) {
    *reinterpret_cast<typename Vec16<T>::type*>(p) = repack(x);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) p[e] = x.v[e];
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
stencil_mv_kernel(const T* __restrict__ bands, Offsets off, int nb,
                  const T* __restrict__ x, T* __restrict__ y, long long n,
                  long long k) {
  const long long kv = k / V;
  const long long total = n * kv;
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x; t < total;
       t += (long long)gridDim.x * kThreads) {
    const long long i = t / kv;
    const long long c = (t - i * kv) * V;
    Pack<T, V> acc;
#pragma unroll
    for (int e = 0; e < V; ++e) acc.v[e] = T(0);
    // unrolled to the maximum so that every offset is read from the
    // parameter space at a constant index: with a runtime index nvcc
    // copied the offsets to a 128-byte local-memory stack frame in every
    // thread, and the kernel ran at a third of this speed
#pragma unroll
    for (int d = 0; d < REPRO_MAX_BANDS; ++d) {
      if (d >= nb) break;
      const T b = bands[d * n + i];
      const long long j = i + off.v[d];
      Pack<T, V> xv;
      if (j >= 0 && j < n) {
        xv = load_pack<T, V>(x + j * k + c);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) xv.v[e] = T(0);
      }
#pragma unroll
      for (int e = 0; e < V; ++e) acc.v[e] = add_rn(acc.v[e], mul_rn(b, xv.v[e]));
    }
    store_pack<T, V>(y + i * k + c, acc);
  }
}

template <typename T, int V>
int launch(const void* bands, const Offsets& off, int nb, const void* x, void* y,
           long long n, long long k, void* stream) {
  const long long total = n * (k / V);
  const long long blocks = (total + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(blocks < (1LL << 30) ? blocks : (1LL << 30));
  stencil_mv_kernel<T, V><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)bands, off, nb, (const T*)x, (T*)y, n, k);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* bands, const Offsets& off, int nb, const void* x, void* y,
             long long n, long long k, void* stream) {
  constexpr int V = Vec16<T>::n;
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0);
  if (aligned && k % V == 0) return launch<T, V>(bands, off, nb, x, y, n, k, stream);
  return launch<T, 1>(bands, off, nb, x, y, n, k, stream);
}

}  // namespace

extern "C" int repro_stencil_mv(int dtype, const void* bands,
                                const long long* offsets, int nb, const void* x,
                                void* y, long long n, long long k, void* stream) {
  if (nb < 1 || nb > REPRO_MAX_BANDS) return (int)cudaErrorInvalidValue;
  if (n <= 0 || k <= 0) return 0;
  Offsets off = {};
  for (int d = 0; d < nb; ++d) off.v[d] = offsets[d];
  if (dtype == REPRO_F32) return dispatch<float>(bands, off, nb, x, y, n, k, stream);
  if (dtype == REPRO_F64) return dispatch<double>(bands, off, nb, x, y, n, k, stream);
  return (int)cudaErrorInvalidValue;
}
