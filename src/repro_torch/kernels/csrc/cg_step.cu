// K7 cg_step: the matvec-and-axpy chain of one conjugate-gradient step.
//
//   ap    = A @ p
//   alpha = rz / sum over rows of p * ap      (0 where |den| <= FLT/DBL_MIN)
//   x_new = x + alpha * p,   r_new = r - alpha * ap
//
// Replaces the Pallas TPU kernel `cg_step_kernel` / `cg_step_pallas`
// (src/repro/kernels/fused_est.py:85/103), a single VMEM-resident block
// (with a jnp fallback above an 8 MiB budget).  Here A streams once from
// device memory, at every n.
//
// Bound: bytes.  At n = 16384, k = 32, f32 the call moves 1.08 GB (A once,
// five slabs) and does 17.2 GFLOP: 0.32 ms by bytes against 0.26 ms by
// f32 FFMA, near the ridge, as K6.  Design: alpha needs the dot over all
// n rows before either axpy can run, and blocks of a launch cannot wait
// on each other, so the chain is two phases behind one entry point.
// Measured on an H100 at that shape, all in one call (tools/k7_variants.py;
// ms f32 / f64): 0.551 / 0.763, against 1.130 / 3.077 for the first K7
// (32 x 32 blocks of 2 x 4 FFMA register tiles, plain DFMA in f64),
// 0.527 / 0.733 for K5 alone and 0.535 / 0.685 for cuBLAS's `A @ p`.
//  - Phase 1 is K6's product (skinny_mma.cuh, K5's tile) with K5's cut
//    (kernels/matvec.py:plan for (n, n, k), passed in by the wrapper,
//    kernels/fused_est.py:cg_step): 128-row x BN (16, 32 or 64) blocks, A
//    streamed through a two-stage shared-memory ring by the copy engine,
//    FFMA register tiles in f32 and DMMA m16n8k4 in f64; up to four
//    columns, one warp per row (`row_dot`).  With one range of the
//    reduction axis the tile kernel's epilogue reads the summed tile,
//    writes `ap` once and the block's column sums of p * ap to row
//    blockIdx.x of a (row blocks, k) buffer.  Where the plan splits the
//    axis (at n = 16384, k = 32: two ranges, 128 row blocks on 132 SMs),
//    each range writes its slice of an (S, n, k) buffer, and a pass that
//    adds the S slices in range order runs the same epilogue: two ranges
//    0.554 / 0.762, one 0.700 / 1.091, four 0.565 / 0.771.  K5's product
//    and then PyTorch's elementwise epilogue: 0.581 / 0.790.
//  - Phase 2 reduces those partials in a fixed order (each warp takes
//    columns, each lane a strided run of row blocks, then a fixed shuffle
//    tree), forms the guarded alpha exactly as the plain version does, and
//    runs both axpys, 16 bytes a thread where the slabs allow (one element
//    a thread: 0.559 / 0.765; 32 rows a block, not 128: 0.559 / 0.766).
//  - Every multiply and add of the epilogues is rounded as the plain
//    version rounds it (no contraction into FMAs); only the order of the
//    sums in `A @ p` and in the dots differs from it.  No atomics: a
//    repeated call is bitwise repeatable.  `rz` stays on the card.
#include "skinny_mma.cuh"

namespace {

using namespace repro;

constexpr int kUpdateThreads = 256;
constexpr long long kUpdateRows = 128;   // rows of the slabs per phase-2 block

// ap on rows [row0, row0 + kBlockRows) x columns [col0, col0 + BN) from
// the product's entries prod(r, c) (local indices), and this block's
// column sums of p * ap into partials[col0 ...].  `red` holds kThreads
// values of scratch; the block waits before writing it, so it may alias
// what `prod` reads.
template <typename T, int BN, typename Prod>
__device__ __forceinline__ void cg_epilogue(Prod prod, const T* __restrict__ p,
                                            T* __restrict__ ap, T* __restrict__ partials,
                                            long long n, long long k, long long row0,
                                            long long col0, T* red) {
  constexpr int RS = skinny::kThreads / BN;   // rows one pass of the block covers
  const int cc = threadIdx.x % BN;
  const long long col = col0 + cc;
  T colsum = T(0);
  if (col < k) {
    for (int r = threadIdx.x / BN; r < skinny::kBlockRows && row0 + r < n; r += RS) {
      const long long idx = (row0 + r) * k + col;
      const T v = prod(r, cc);
      ap[idx] = v;
      colsum = add_rn(colsum, mul_rn(p[idx], v));
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
// blockIdx.y) of kBlockRows rows and BN columns: with one range, `ap` and
// the block's partial dots (row block blockIdx.x); with several, the
// range's share of `A @ p` into slice z of `slices`.
template <typename T, int BN, skinny::Copy MODE>
__global__ void __launch_bounds__(skinny::kThreads, skinny::kBlocksPerSm)
cg_tile_kernel(const T* __restrict__ a, const T* __restrict__ p, T* __restrict__ ap,
               T* __restrict__ partials, T* __restrict__ slices, long long n, long long k,
               long long split_len) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const long long row0 = (long long)blockIdx.x * skinny::kBlockRows;
  const long long col0 = (long long)blockIdx.y * BN;
  const long long kbeg = (long long)blockIdx.z * split_len;
  const long long kend = kbeg + split_len < n ? kbeg + split_len : n;
  skinny::skinny_mma_tile<T, BN, MODE>(a, p, n, n, k, row0, col0, kbeg, kend, smem);
  if (gridDim.z > 1) {
    T* __restrict__ o = slices + (long long)blockIdx.z * n * k;
    for (int e = threadIdx.x; e < skinny::kBlockRows * BN; e += skinny::kThreads) {
      const int r = e / BN, c = e % BN;
      if (row0 + r < n && col0 + c < k)
        o[(row0 + r) * k + col0 + c] = skinny::sum<T, BN>(smem, r, c);
    }
    return;
  }
  cg_epilogue<T, BN>([&](int r, int c) { return skinny::sum<T, BN>(smem, r, c); }, p, ap,
                     partials + (long long)blockIdx.x * k, n, k, row0, col0, smem);
}

// After a split product: `A @ p` = the S slices added in range order (as
// K5's split_sum_kernel adds them), then `ap` and the partial dots of
// block (blockIdx.x, blockIdx.y), as the tile kernel's epilogue.
template <typename T, int BN>
__global__ void __launch_bounds__(skinny::kThreads)
cg_split_kernel(const T* __restrict__ slices, const T* __restrict__ p, T* __restrict__ ap,
                T* __restrict__ partials, long long n, long long k, long long splits) {
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
  cg_epilogue<T, BN>(prod, p, ap, partials + (long long)blockIdx.x * k, n, k, row0, col0,
                     red);
}

// k <= kMaxGemvCols: one warp per row (`row_dot`), `ap` by lane 0, and
// the block's partial dots (its kGemvRows rows in order) into row block
// blockIdx.x of partials.
template <typename T, int KC, bool VEC>
__global__ void __launch_bounds__(32 * skinny::kGemvRows)
cg_rows_kernel(const T* __restrict__ a, const T* __restrict__ p, T* __restrict__ ap,
               T* __restrict__ partials, long long n) {
  __shared__ T red[skinny::kGemvRows][KC];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long row = (long long)blockIdx.x * skinny::kGemvRows + warp;
  if (row < n) {                                // the whole warp, or none of it
    T acc[KC];
    skinny::row_dot<T, KC, VEC>(a + row * n, p, n, lane, acc);
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const long long idx = row * KC + j;
        ap[idx] = acc[j];
        red[warp][j] = mul_rn(p[idx], acc[j]);
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

// Phase 2 on rows [blockIdx.x kUpdateRows, + kUpdateRows): every block
// forms the k alphas from the `blocks` rows of partial dots, then both
// axpys, each product rounded before it is added.  VEC: 16-byte vectors
// (every slab 16-byte aligned, k a multiple of the vector, so a vector's
// columns are consecutive).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kUpdateThreads)
cg_update_kernel(const T* __restrict__ partials, long long blocks, const T* __restrict__ rz,
                 const T* __restrict__ p, const T* __restrict__ x, const T* __restrict__ r,
                 const T* __restrict__ ap, T* __restrict__ x_new, T* __restrict__ r_new,
                 long long n, long long k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* alpha = reinterpret_cast<T*>(smem_raw);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  for (long long c = warp; c < k; c += kUpdateThreads / 32) {
    T s = T(0);
    for (long long t = lane; t < blocks; t += 32) s = add_rn(s, partials[t * k + c]);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) s = add_rn(s, __shfl_down_sync(0xffffffffu, s, off));
    if (lane == 0) alpha[c] = abs_(s) > tiny<T>() ? div_rn(rz[c], s) : T(0);
  }
  __syncthreads();
  const long long start = (long long)blockIdx.x * kUpdateRows * k;
  const long long end = min(n, ((long long)blockIdx.x + 1) * kUpdateRows) * k;
  if constexpr (VEC) {
    using V = typename Vec16<T>::type;
    constexpr int W = Vec16<T>::n;
#pragma unroll 4
    for (long long e = start + W * threadIdx.x; e < end; e += W * kUpdateThreads) {
      const T* al = alpha + e % k;
      const V pv = *reinterpret_cast<const V*>(p + e);
      const V xv = *reinterpret_cast<const V*>(x + e);
      const V rv = *reinterpret_cast<const V*>(r + e);
      const V av = *reinterpret_cast<const V*>(ap + e);
      const T* pe = reinterpret_cast<const T*>(&pv);
      const T* xe = reinterpret_cast<const T*>(&xv);
      const T* re = reinterpret_cast<const T*>(&rv);
      const T* ae = reinterpret_cast<const T*>(&av);
      V xo, ro;
      T* xoe = reinterpret_cast<T*>(&xo);
      T* roe = reinterpret_cast<T*>(&ro);
#pragma unroll
      for (int q = 0; q < W; ++q) {
        xoe[q] = add_rn(xe[q], mul_rn(al[q], pe[q]));
        roe[q] = sub_rn(re[q], mul_rn(al[q], ae[q]));
      }
      *reinterpret_cast<V*>(x_new + e) = xo;
      *reinterpret_cast<V*>(r_new + e) = ro;
    }
  } else {
    for (long long e = start + threadIdx.x; e < end; e += kUpdateThreads) {
      const T al = alpha[e % k];
      x_new[e] = add_rn(x[e], mul_rn(al, p[e]));
      r_new[e] = sub_rn(r[e], mul_rn(al, ap[e]));
    }
  }
}

struct Args {
  const void *a, *p, *x, *r, *rz;
  void *x_new, *r_new, *ap, *partials, *slices;
  long long n, k;
  cudaStream_t s;
};

template <typename T, int KC>
void launch_rows(const Args& g) {
  const unsigned blocks = (unsigned)((g.n + skinny::kGemvRows - 1) / skinny::kGemvRows);
  const bool vec = g.n % Vec16<T>::n == 0 && reinterpret_cast<uintptr_t>(g.a) % 16 == 0;
  const auto kernel = vec ? cg_rows_kernel<T, KC, true> : cg_rows_kernel<T, KC, false>;
  kernel<<<blocks, 32 * skinny::kGemvRows, 0, g.s>>>((const T*)g.a, (const T*)g.p, (T*)g.ap,
                                                     (T*)g.partials, g.n);
}

template <typename T, int BN, skinny::Copy MODE>
cudaError_t launch_tile(const Args& g, long long splits, long long split_len) {
  constexpr int smem = skinny::launch_smem_bytes<T, BN>();
  const auto kernel = cg_tile_kernel<T, BN, MODE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const unsigned row_blocks = (unsigned)((g.n + skinny::kBlockRows - 1) / skinny::kBlockRows);
  const unsigned col_blocks = (unsigned)((g.k + BN - 1) / BN);
  kernel<<<dim3(row_blocks, col_blocks, (unsigned)splits), skinny::kThreads, smem, g.s>>>(
      (const T*)g.a, (const T*)g.p, (T*)g.ap, (T*)g.partials, (T*)g.slices, g.n, g.k,
      split_len);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  cg_split_kernel<T, BN><<<dim3(row_blocks, col_blocks), skinny::kThreads, 0, g.s>>>(
      (const T*)g.slices, (const T*)g.p, (T*)g.ap, (T*)g.partials, g.n, g.k, splits);
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

template <typename T>
cudaError_t launch_update(const Args& g, long long blocks) {
  const unsigned grid = (unsigned)((g.n + kUpdateRows - 1) / kUpdateRows);
  const uintptr_t any = reinterpret_cast<uintptr_t>(g.p) | reinterpret_cast<uintptr_t>(g.x) |
                        reinterpret_cast<uintptr_t>(g.r) | reinterpret_cast<uintptr_t>(g.ap) |
                        reinterpret_cast<uintptr_t>(g.x_new) |
                        reinterpret_cast<uintptr_t>(g.r_new);
  const bool vec = g.k % Vec16<T>::n == 0 && any % 16 == 0;
  const auto kernel = vec ? cg_update_kernel<T, true> : cg_update_kernel<T, false>;
  kernel<<<grid, kUpdateThreads, g.k * sizeof(T), g.s>>>(
      (const T*)g.partials, blocks, (const T*)g.rz, (const T*)g.p, (const T*)g.x,
      (const T*)g.r, (const T*)g.ap, (T*)g.x_new, (T*)g.r_new, g.n, g.k);
  return cudaGetLastError();
}

// The cut (bm, bn, chunk, splits, split_len) from kernels/matvec.py:plan
// for (n, n, k), checked against what the kernels take; partials holds
// one row of k per row block of bm rows.
template <typename T>
int launch(const Args& g, long long bm, long long bn, long long chunk, long long splits,
           long long split_len) {
  cudaError_t err = cudaSuccess;
  if (g.k <= skinny::kMaxGemvCols) {
    if (bm != skinny::kGemvRows || bn != g.k || splits != 1) return (int)cudaErrorInvalidValue;
    if (g.n == 0) return 0;
    switch (g.k) {
      case 1: launch_rows<T, 1>(g); break;
      case 2: launch_rows<T, 2>(g); break;
      case 3: launch_rows<T, 3>(g); break;
      case 4: launch_rows<T, 4>(g); break;
    }
    err = cudaGetLastError();
    static_assert(skinny::kMaxGemvCols == 4, "the switch above covers k = 1..4");
  } else {
    if (!skinny::tile_cut_ok<T>(g.n, bm, chunk, splits, split_len, g.slices) ||
        (bn != 16 && bn != 32 && bn != 64))
      return (int)cudaErrorInvalidValue;
    if (g.n == 0) return 0;
    switch (bn) {
      case 16: err = launch_bn<T, 16>(g, splits, split_len); break;
      case 32: err = launch_bn<T, 32>(g, splits, split_len); break;
      case 64: err = launch_bn<T, 64>(g, splits, split_len); break;
    }
  }
  if (err != cudaSuccess) return (int)err;
  return (int)launch_update<T>(g, (g.n + bm - 1) / bm);
}

}  // namespace

extern "C" int repro_cg_step(int dtype, const void* a, const void* p, const void* x,
                             const void* r, const void* rz, void* x_new, void* r_new,
                             void* ap, void* partials, void* slices, long long n,
                             long long k, long long bm, long long bn, long long chunk,
                             long long splits, long long split_len, void* stream) {
  if (n < 0 || k <= 0) return 0;
  const Args g{a, p, x, r, rz, x_new, r_new, ap, partials, slices, n, k,
               (cudaStream_t)stream};
  if (dtype == REPRO_F32) return launch<float>(g, bm, bn, chunk, splits, split_len);
  if (dtype == REPRO_F64) return launch<double>(g, bm, bn, chunk, splits, split_len);
  return (int)cudaErrorInvalidValue;
}
