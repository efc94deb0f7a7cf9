// Shared header of the port's kernels K1-K8 (sm_90a).
//
// The C interface below is what the Python wrappers bind with ctypes
// (kernels/_build.py): every pointer and the stream are `void*`, every
// size is `long long`, every dtype is one of the codes below, and every
// function returns cudaGetLastError() after its launch (0 on success).
//
// The device helpers pin the rounding of every multiply, subtract and
// divide (`__fmul_rn`, `__fsub_rn`, `__fdiv_rn` and their f64 forms), so
// nvcc cannot contract `a - pc * pr` into an FMA: the plain PyTorch
// versions (kernels/ref.py) materialize the product before subtracting,
// and the kernels reproduce their elementwise arithmetic bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>
#include <type_traits>

// dtype codes shared with kernels/_build.py
#define REPRO_F32 0
#define REPRO_F64 1
#define REPRO_BF16 2

#ifdef __cplusplus
extern "C" {
#endif

// K1-K4 take a stack of `batch` matrices in one launch (batch = 1: one
// matrix); matrix b of every array follows matrix b - 1 contiguously,
// except K1's `a`, whose matrices lie `a_stride` elements apart.

// K1: out = a - outer(pc, pr); a, out (batch, m, n) in dtype; pc (batch, m),
// pr (batch, n) in op_dtype.
int repro_rank1_update(int dtype, int op_dtype, const void* a, const void* pc,
                       const void* pr, void* out, long long batch, long long m,
                       long long n, long long a_stride, void* stream);

// K2: out = a - c @ r; a, out (batch, m, n) in dtype; c (batch, m, k),
// r (batch, k, n) in op_dtype.
int repro_panel_update(int dtype, int op_dtype, const void* a, const void* c,
                       const void* r, void* out, long long batch, long long m,
                       long long n, long long k, void* stream);

// K3: out = swap_select(a; l <-> last) - outer(pc, pr), shapes as K1's;
// l (batch,) is device int64, one pivot column per matrix.
int repro_fused_step(int dtype, int op_dtype, const void* a, const void* l,
                     long long last, const void* pc, const void* pr,
                     const void* col_l, const void* col_last, void* out,
                     long long batch, long long m, long long n, void* stream);

// K4: factorize (batch, k, n) panels; r (batch, k, n) out, ls (batch, k)
// int64 out, sign_logdet (batch, 2) out in dtype; one cluster of `cluster`
// blocks of `cols` columns each per panel, slices in shared memory if
// `shared`, smem_bytes of dynamic shared memory per block (the cut is
// kernels/panel_factor.py:plan's).
int repro_panel_factor(int dtype, const void* panel, void* r, void* ls,
                       void* sign_logdet, long long batch, long long k,
                       long long n, long long m0, long long r_pos,
                       long long cluster, long long cols, long long shared,
                       long long smem_bytes, void* stream);

// K5: o (m, k) = a (m, n) @ x (n, k), every tensor in dtype; the cut
// (bm, bn, chunk, splits, split_len) is kernels/matvec.py:plan's, and
// partials (splits, m, k) is scratch when splits > 1 (else may be null).
int repro_matvec(int dtype, const void* a, const void* x, void* o,
                 void* partials, long long m, long long n, long long k,
                 long long bm, long long bn, long long chunk, long long splits,
                 long long split_len, void* stream);

// K6: one Chebyshev step on a (n, n), w / w_prev / v (n, k) in dtype;
// w_next (n, k) out, dots (k,) out; center and width are one-element
// device buffers in dtype.  The cut (bm, bn, chunk, splits, split_len) is
// kernels/matvec.py:plan's for (n, n, k);
// partials (ceil(n / bm), k) is scratch, and so is slices (splits, n, k)
// when splits > 1 (else may be null).
int repro_cheb_step(int dtype, const void* a, const void* w,
                    const void* w_prev, const void* v, const void* center,
                    const void* width, void* w_next, void* dots,
                    void* partials, void* slices, long long n, long long k,
                    long long bm, long long bn, long long chunk,
                    long long splits, long long split_len, void* stream);

// K7: one CG step on a (n, n), p / x / r (n, k), rz (k,) in dtype;
// x_new, r_new (n, k) out.  The cut (bm, bn, chunk, splits, split_len) is
// kernels/matvec.py:plan's for (n, n, k); ap (n, k) and partials
// (ceil(n / bm), k) are scratch, and so is slices (splits, n, k) when
// splits > 1 (else may be null).
int repro_cg_step(int dtype, const void* a, const void* p, const void* x,
                  const void* r, const void* rz, void* x_new, void* r_new,
                  void* ap, void* partials, void* slices, long long n,
                  long long k, long long bm, long long bn, long long chunk,
                  long long splits, long long split_len, void* stream);

// K8: y (n, k) = sum_d bands[d, :] * x[. + offsets[d], :], zero outside
// [0, n); bands (nb, n), x (n, k) in dtype; offsets is a host array of nb
// values, nb <= REPRO_MAX_BANDS.
#define REPRO_MAX_BANDS 16
int repro_stencil_mv(int dtype, const void* bands, const long long* offsets,
                     int nb, const void* x, void* y, long long n, long long k,
                     void* stream);

#ifdef __cplusplus
}
#endif

#ifdef __CUDACC__
namespace repro {

__device__ __forceinline__ float mul_rn(float x, float y) { return __fmul_rn(x, y); }
__device__ __forceinline__ double mul_rn(double x, double y) { return __dmul_rn(x, y); }
__device__ __forceinline__ float sub_rn(float x, float y) { return __fsub_rn(x, y); }
__device__ __forceinline__ double sub_rn(double x, double y) { return __dsub_rn(x, y); }
__device__ __forceinline__ float add_rn(float x, float y) { return __fadd_rn(x, y); }
__device__ __forceinline__ double add_rn(double x, double y) { return __dadd_rn(x, y); }
__device__ __forceinline__ float div_rn(float x, float y) { return __fdiv_rn(x, y); }
__device__ __forceinline__ double div_rn(double x, double y) { return __ddiv_rn(x, y); }
__device__ __forceinline__ float fma_rn(float x, float y, float z) { return __fmaf_rn(x, y, z); }
__device__ __forceinline__ double fma_rn(double x, double y, double z) { return __fma_rn(x, y, z); }
__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }
__device__ __forceinline__ float log_(float x) { return logf(x); }
__device__ __forceinline__ double log_(double x) { return log(x); }

// the smallest normal value: K7's alpha is 0 where |den| is not above it
template <typename T> __device__ __forceinline__ T tiny();
template <> __device__ __forceinline__ float tiny<float>() { return FLT_MIN; }
template <> __device__ __forceinline__ double tiny<double>() { return DBL_MIN; }

template <typename T>
__device__ __forceinline__ T widen(T x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// pc * pr rounded in the operand type, then widened to the buffer type T:
// a bf16 product is exact in f32 and rounds once to bf16, as PyTorch's
// bf16 multiply does.
template <typename T, typename OpT>
__device__ __forceinline__ T product(OpT x, OpT y) {
  if constexpr (std::is_same<OpT, __nv_bfloat16>::value) {
    float p = __fmul_rn(__bfloat162float(x), __bfloat162float(y));
    return static_cast<T>(__bfloat162float(__float2bfloat16_rn(p)));
  } else {
    return mul_rn(x, y);
  }
}

// 16-byte vector of a buffer type, for coalesced loads and stores
template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; static constexpr int n = 4; };
template <> struct Vec16<double> { using type = double2; static constexpr int n = 2; };

}  // namespace repro
#endif
