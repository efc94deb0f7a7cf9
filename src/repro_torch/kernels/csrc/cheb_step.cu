// K6 cheb_step: one step of the stochastic Chebyshev three-term recurrence.
//
//   w_next = 2 * (2 * (A @ w) - center * w) / width - w_prev
//   dots   = sum over rows of v * w_next                       (k,)
//
// Replaces the Pallas TPU kernel `cheb_step_kernel` / `cheb_step_pallas`
// (src/repro/kernels/fused_est.py:40/55), which holds A and the slabs in
// VMEM as one block (and falls back to jnp above an 8 MiB budget).  Here
// A streams once from device memory, at every n.
//
// Bound: bytes.  At n = 16384, k = 32, f32 the call moves 1.07 GB (A once,
// four slabs) and does 17.2 GFLOP: 0.32 ms by bytes against 0.26 ms by
// f32 FFMA, near the ridge, so the product has to keep the memory rate
// and the FFMA rate near their peaks at once.  Design (each choice
// measured on an H100 at that shape against its alternatives,
// tools/k1_k6_variants.py; ms f32 / f64):
//  - `A @ w` is K5's product (skinny_mma.cuh) with K5's cut
//    (kernels/matvec.py:plan for (n, n, k), passed in by the wrapper,
//    kernels/fused_est.py:cheb_step): 128-row x BN (16, 32
//    or 64) blocks, A streamed through a two-stage shared-memory ring by
//    the copy engine, a 4 x 8 FFMA register tile in f32 and DMMA m16n8k4
//    in f64, A read once per 64 columns of w; up to four columns, one warp
//    per row (`row_dot`).  0.556 / 0.761, against 1.143 / 3.079 for the
//    first K6 (32 x 32 blocks of 2 x 4 FFMA register tiles fed from shared
//    memory, A a chunk ahead in registers, plain DFMA in f64), 0.523 /
//    0.735 for K5 alone and 0.534 / 0.687 for cuBLAS's `A @ w`.
//  - With one range of the reduction axis the recurrence runs in the tile
//    kernel's epilogue, on the summed tile, so the slabs are read and
//    w_next written once.  Where the plan splits the axis (too few row
//    blocks to give every SM two: at n = 16384, k = 32, 128 blocks on 132
//    SMs), each range writes its slice of an (S, n, k) buffer, and the
//    pass that adds the S slices in range order runs the recurrence: two
//    ranges 0.556 / 0.761, one 0.701 / 1.084, four 0.569 / 0.769.  K5's
//    product and then PyTorch's elementwise recurrence: 0.566 / 0.781.
//  - Every multiply, subtract and divide of the epilogue is rounded as the
//    plain version rounds it (no contraction into FMAs); only the order of
//    `A @ w`'s sums differs from it (and from the first K6's).
//  - The probe dots are reduced without atomics: each block writes its
//    column sums (its rows in order) to a (row blocks, k) buffer, and
//    `column_sum_kernel` (skinny_mma.cuh) adds them in row-block order,
//    so a repeated call is bitwise repeatable.
//  - `center` and `width` are read from device memory: they come from
//    `spectral_bounds` on the card, and a host float would stall the host
//    on every step.
#include "skinny_mma.cuh"

namespace {

using namespace repro;

// The recurrence on rows [row0, row0 + kBlockRows) x columns [col0, col0 +
// BN) of the output, from the product's entries prod(r, c) (local
// indices), and this block's column sums of v * w_next into partials[col0
// ...].  `red` holds kThreads values of scratch; the block waits before
// writing it, so it may alias what `prod` reads.
template <typename T, int BN, typename Prod>
__device__ __forceinline__ void cheb_epilogue(Prod prod, const T* __restrict__ w,
                                              const T* __restrict__ w_prev,
                                              const T* __restrict__ v, T c, T wd,
                                              T* __restrict__ w_next, T* __restrict__ partials,
                                              long long n, long long k, long long row0,
                                              long long col0, T* red) {
  constexpr int RS = skinny::kThreads / BN;   // rows one pass of the block covers
  const int cc = threadIdx.x % BN;
  const long long col = col0 + cc;
  T colsum = T(0);
  if (col < k) {
    for (int r = threadIdx.x / BN; r < skinny::kBlockRows && row0 + r < n; r += RS) {
      const long long idx = (row0 + r) * k + col;
      const T mv = div_rn(sub_rn(mul_rn(T(2), prod(r, cc)), mul_rn(c, w[idx])), wd);
      const T wn = sub_rn(mul_rn(T(2), mv), w_prev[idx]);
      w_next[idx] = wn;
      colsum = add_rn(colsum, mul_rn(v[idx], wn));
    }
  }
  __syncthreads();
  red[threadIdx.x] = colsum;
  __syncthreads();
  if (threadIdx.x < BN && col < k) {
    T s = red[threadIdx.x];
    for (int t = 1; t < RS; ++t) s = add_rn(s, red[t * BN + threadIdx.x]);
    partials[col] = s;
  }
}

// Range z = blockIdx.z of the reduction axis for block (blockIdx.x,
// blockIdx.y) of kBlockRows rows and BN columns: with one range, the
// recurrence and the block's partial dots (row block blockIdx.x); with
// several, the range's share of `A @ w` into slice z of `slices`.
template <typename T, int BN, skinny::Copy MODE>
__global__ void __launch_bounds__(skinny::kThreads, skinny::kBlocksPerSm)
cheb_tile_kernel(const T* __restrict__ a, const T* __restrict__ w,
                 const T* __restrict__ w_prev, const T* __restrict__ v,
                 const T* __restrict__ center, const T* __restrict__ width,
                 T* __restrict__ w_next, T* __restrict__ partials,
                 T* __restrict__ slices, long long n, long long k,
                 long long split_len) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const long long row0 = (long long)blockIdx.x * skinny::kBlockRows;
  const long long col0 = (long long)blockIdx.y * BN;
  const long long kbeg = (long long)blockIdx.z * split_len;
  const long long kend = kbeg + split_len < n ? kbeg + split_len : n;
  skinny::skinny_mma_tile<T, BN, MODE>(a, w, n, n, k, row0, col0, kbeg, kend, smem);
  if (gridDim.z > 1) {
    T* __restrict__ o = slices + (long long)blockIdx.z * n * k;
    for (int e = threadIdx.x; e < skinny::kBlockRows * BN; e += skinny::kThreads) {
      const int r = e / BN, c = e % BN;
      if (row0 + r < n && col0 + c < k)
        o[(row0 + r) * k + col0 + c] = skinny::sum<T, BN>(smem, r, c);
    }
    return;
  }
  cheb_epilogue<T, BN>([&](int r, int c) { return skinny::sum<T, BN>(smem, r, c); }, w,
                       w_prev, v, *center, *width, w_next,
                       partials + (long long)blockIdx.x * k, n, k, row0, col0, smem);
}

// After a split product: `A @ w` = the S slices added in range order (as
// K5's split_sum_kernel adds them), then the recurrence and the partial
// dots of block (blockIdx.x, blockIdx.y), as the tile kernel's epilogue.
template <typename T, int BN>
__global__ void __launch_bounds__(skinny::kThreads)
cheb_split_kernel(const T* __restrict__ slices, const T* __restrict__ w,
                  const T* __restrict__ w_prev, const T* __restrict__ v,
                  const T* __restrict__ center, const T* __restrict__ width,
                  T* __restrict__ w_next, T* __restrict__ partials, long long n,
                  long long k, long long splits) {
  __shared__ T red[skinny::kThreads];
  const long long row0 = (long long)blockIdx.x * skinny::kBlockRows;
  const long long col0 = (long long)blockIdx.y * BN;
  const long long count = n * k;
  auto prod = [&](int r, int c) {
    const long long i = (row0 + r) * k + col0 + c;
    T s = slices[i];
    for (long long z = 1; z < splits; ++z) s = add_rn(s, slices[z * count + i]);
    return s;
  };
  cheb_epilogue<T, BN>(prod, w, w_prev, v, *center, *width, w_next,
                       partials + (long long)blockIdx.x * k, n, k, row0, col0, red);
}

// k <= kMaxGemvCols: one warp per row (`row_dot`), its recurrence by lane
// 0, and the block's partial dots (its kGemvRows rows in order) into row
// block blockIdx.x of partials.
template <typename T, int KC, bool VEC>
__global__ void __launch_bounds__(32 * skinny::kGemvRows)
cheb_rows_kernel(const T* __restrict__ a, const T* __restrict__ w,
                 const T* __restrict__ w_prev, const T* __restrict__ v,
                 const T* __restrict__ center, const T* __restrict__ width,
                 T* __restrict__ w_next, T* __restrict__ partials, long long n) {
  __shared__ T red[skinny::kGemvRows][KC];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long row = (long long)blockIdx.x * skinny::kGemvRows + warp;
  if (row < n) {                                // the whole warp, or none of it
    T acc[KC];
    skinny::row_dot<T, KC, VEC>(a + row * n, w, n, lane, acc);
    if (lane == 0) {
      const T c = *center, wd = *width;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const long long idx = row * KC + j;
        const T mv = div_rn(sub_rn(mul_rn(T(2), acc[j]), mul_rn(c, w[idx])), wd);
        const T wn = sub_rn(mul_rn(T(2), mv), w_prev[idx]);
        w_next[idx] = wn;
        red[warp][j] = mul_rn(v[idx], wn);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < KC) {
    const long long rows = n - (long long)blockIdx.x * skinny::kGemvRows;
    const int last = rows < skinny::kGemvRows ? (int)rows : skinny::kGemvRows;
    T s = red[0][threadIdx.x];
    for (int r = 1; r < last; ++r) s = add_rn(s, red[r][threadIdx.x]);
    partials[(long long)blockIdx.x * KC + threadIdx.x] = s;
  }
}

struct Args {
  const void *a, *w, *w_prev, *v, *center, *width;
  void *w_next, *dots, *partials, *slices;
  long long n, k;
  cudaStream_t s;
};

template <typename T, int KC>
void launch_rows(const Args& g) {
  const unsigned blocks = (unsigned)((g.n + skinny::kGemvRows - 1) / skinny::kGemvRows);
  const bool vec = g.n % Vec16<T>::n == 0 && reinterpret_cast<uintptr_t>(g.a) % 16 == 0;
  const auto kernel = vec ? cheb_rows_kernel<T, KC, true> : cheb_rows_kernel<T, KC, false>;
  kernel<<<blocks, 32 * skinny::kGemvRows, 0, g.s>>>(
      (const T*)g.a, (const T*)g.w, (const T*)g.w_prev, (const T*)g.v, (const T*)g.center,
      (const T*)g.width, (T*)g.w_next, (T*)g.partials, g.n);
}

template <typename T, int BN, skinny::Copy MODE>
cudaError_t launch_tile(const Args& g, long long splits, long long split_len) {
  constexpr int smem = skinny::launch_smem_bytes<T, BN>();
  const auto kernel = cheb_tile_kernel<T, BN, MODE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const unsigned row_blocks = (unsigned)((g.n + skinny::kBlockRows - 1) / skinny::kBlockRows);
  const unsigned col_blocks = (unsigned)((g.k + BN - 1) / BN);
  kernel<<<dim3(row_blocks, col_blocks, (unsigned)splits), skinny::kThreads, smem, g.s>>>(
      (const T*)g.a, (const T*)g.w, (const T*)g.w_prev, (const T*)g.v, (const T*)g.center,
      (const T*)g.width, (T*)g.w_next, (T*)g.partials, (T*)g.slices, g.n, g.k, split_len);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  cheb_split_kernel<T, BN><<<dim3(row_blocks, col_blocks), skinny::kThreads, 0, g.s>>>(
      (const T*)g.slices, (const T*)g.w, (const T*)g.w_prev, (const T*)g.v,
      (const T*)g.center, (const T*)g.width, (T*)g.w_next, (T*)g.partials, g.n, g.k, splits);
  return cudaGetLastError();
}

template <typename T, int BN>
cudaError_t launch_bn(const Args& g, long long splits, long long split_len) {
  using skinny::Copy;
  constexpr int BK = skinny::Layout<T, BN>::BK;
  const bool aligned = reinterpret_cast<uintptr_t>(g.a) % 16 == 0;
  if (aligned && g.n % BK == 0 && split_len % BK == 0)
    return launch_tile<T, BN, Copy::kBulk>(g, splits, split_len);
  if (aligned && g.n % Vec16<T>::n == 0) return launch_tile<T, BN, Copy::kVec>(g, splits, split_len);
  return launch_tile<T, BN, Copy::kElem>(g, splits, split_len);
}

// The cut (bm, bn, chunk, splits, split_len) from kernels/matvec.py:plan
// for (n, n, k), checked against what the kernels
// take; partials holds one row of k per row block of bm rows.  With n = 0
// the dots are zeros.
template <typename T>
int launch(const Args& g, long long bm, long long bn, long long chunk, long long splits,
           long long split_len) {
  cudaError_t err = cudaSuccess;
  if (g.k <= skinny::kMaxGemvCols) {
    if (bm != skinny::kGemvRows || bn != g.k || splits != 1) return (int)cudaErrorInvalidValue;
    if (g.n > 0) {
      switch (g.k) {
        case 1: launch_rows<T, 1>(g); break;
        case 2: launch_rows<T, 2>(g); break;
        case 3: launch_rows<T, 3>(g); break;
        case 4: launch_rows<T, 4>(g); break;
      }
      err = cudaGetLastError();
    }
    static_assert(skinny::kMaxGemvCols == 4, "the switch above covers k = 1..4");
  } else {
    if (!skinny::tile_cut_ok<T>(g.n, bm, chunk, splits, split_len, g.slices) ||
        (bn != 16 && bn != 32 && bn != 64))
      return (int)cudaErrorInvalidValue;
    if (g.n > 0) {
      switch (bn) {
        case 16: err = launch_bn<T, 16>(g, splits, split_len); break;
        case 32: err = launch_bn<T, 32>(g, splits, split_len); break;
        case 64: err = launch_bn<T, 64>(g, splits, split_len); break;
      }
    }
  }
  if (err != cudaSuccess) return (int)err;
  skinny::column_sum_kernel<T><<<(unsigned)((g.k + 127) / 128), 128, 0, g.s>>>(
      (const T*)g.partials, (T*)g.dots, (g.n + bm - 1) / bm, g.k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_cheb_step(int dtype, const void* a, const void* w,
                               const void* w_prev, const void* v,
                               const void* center, const void* width,
                               void* w_next, void* dots, void* partials,
                               void* slices, long long n, long long k,
                               long long bm, long long bn, long long chunk,
                               long long splits, long long split_len,
                               void* stream) {
  if (n < 0 || k <= 0) return 0;
  const Args g{a, w, w_prev, v, center, width, w_next, dots, partials, slices, n, k,
               (cudaStream_t)stream};
  if (dtype == REPRO_F32) return launch<float>(g, bm, bn, chunk, splits, split_len);
  if (dtype == REPRO_F64) return launch<double>(g, bm, bn, chunk, splits, split_len);
  return (int)cudaErrorInvalidValue;
}
