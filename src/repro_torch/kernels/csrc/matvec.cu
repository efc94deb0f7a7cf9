// K5 matvec: o = a @ x for a (m, n) and a slab x (n, k), or a vector.
//
// Replaces the Pallas TPU kernel `matvec_kernel` / `matvec_pallas`
// (src/repro/kernels/matvec.py:34/64), which accumulates (bm, K) output
// tiles in VMEM across a sequential reduction grid and zero-pads n to
// full tiles.  Its one caller is the local product of `ShardedOperator`:
// a rank's (L, n) row block against the replicated probe slab.
//
// Bound: bytes.  A is read once, about 4 bytes per 2k FLOP in f32; at
// n = 16384, k = 32 the call moves 1.07 GB against 17.2 GFLOP (0.32 ms by
// bytes, 0.26 ms by FFMA).  Design: two paths, chosen by k.
//  - k <= 4 (the power-iteration bounds of Chebyshev are single columns):
//    one warp per row of A streams the row in 16-byte vectors (scalar
//    loads when a row is not 16-byte aligned), multiplies each element by
//    the k entries of x it meets (x is small and stays in L1/L2), and the
//    warp reduces its 32 partial sums with shuffles.  No padding lanes.
//  - k > 4: the tile of skinny_mma.cuh (128 rows x BN = 16, 32 or 64
//    columns per 256-thread block; A streamed through a shared-memory
//    ring by the copy engine; 8 x 8 FFMA register tiles in f32, DMMA in
//    f64), so A is read once for k <= 64 and once per 64 columns above.
//    When the tiles are fewer than two blocks for every SM, the reduction
//    axis is split into S equal 32-aligned ranges, one block each, so
//    that the card holds about two blocks per SM in one round: each range
//    writes its (m, k) slice of an (S, m, k) partials buffer, and a
//    second kernel sums the S slices in range order (no atomics: a
//    repeated call is bitwise equal).  The cut (BN, S, the range length)
//    is chosen by `kernels/matvec.py:plan`, which the wrapper passes in
//    and this entry checks; the wrapper allocates the partials through
//    PyTorch.
// Sums in full f32 (f64 for f64), no TF32; where the Pallas kernel pads
// a copy, reads past n are zero-filled and rows past m (left unread by
// the copy engine) meet only outputs that are not stored.  The order
// of the sums differs from cuBLAS's, so the plain version is matched to
// a rounding bound (kernels/ref.py:matvec_bound), not bitwise.
#include "skinny_mma.cuh"

namespace {

using namespace repro;

template <typename T, int KC, bool VEC>
__global__ void __launch_bounds__(32 * skinny::kGemvRows)
matvec_rows_kernel(const T* __restrict__ a, const T* __restrict__ x,
                   T* __restrict__ o, long long m, long long n) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * skinny::kGemvRows + threadIdx.x / 32;
  if (row >= m) return;                       // the whole warp leaves
  T acc[KC];
  skinny::row_dot<T, KC, VEC>(a + row * n, x, n, lane, acc);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < KC; ++j) o[row * KC + j] = acc[j];
  }
}

// out[z] (m, k) = a[:, z*split_len : (z+1)*split_len] @ x[that range, :] for
// range z = blockIdx.z; block (blockIdx.x, blockIdx.y) owns kBlockRows rows
// and BN columns.  With one range, out is o itself.
template <typename T, int BN, skinny::Copy MODE>
__global__ void __launch_bounds__(skinny::kThreads, skinny::kBlocksPerSm)
matvec_tile_kernel(const T* __restrict__ a, const T* __restrict__ x,
                   T* __restrict__ out, long long m, long long n, long long k,
                   long long split_len) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const long long row0 = (long long)blockIdx.x * skinny::kBlockRows;
  const long long col0 = (long long)blockIdx.y * BN;
  const long long kbeg = (long long)blockIdx.z * split_len;
  const long long kend = kbeg + split_len < n ? kbeg + split_len : n;
  skinny::skinny_mma_tile<T, BN, MODE>(a, x, m, n, k, row0, col0, kbeg, kend, smem);
  T* __restrict__ o = out + (long long)blockIdx.z * m * k;
  for (int e = threadIdx.x; e < skinny::kBlockRows * BN; e += skinny::kThreads) {
    const int r = e / BN, c = e % BN;
    if (row0 + r < m && col0 + c < k)
      o[(row0 + r) * k + col0 + c] = skinny::sum<T, BN>(smem, r, c);
  }
}

// o[i] = sum over ranges z, in order, of partials[z, i] (i < count = m k)
template <typename T>
__global__ void split_sum_kernel(const T* __restrict__ partials, T* __restrict__ o,
                                 long long count, long long splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  T s = partials[i];
  for (long long z = 1; z < splits; ++z) s = add_rn(s, partials[z * count + i]);
  o[i] = s;
}

template <typename T, int KC>
void launch_rows(const T* a, const T* x, T* o, long long m, long long n,
                 cudaStream_t s) {
  const unsigned blocks = (unsigned)((m + skinny::kGemvRows - 1) / skinny::kGemvRows);
  const bool vec = n % Vec16<T>::n == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  if (vec)
    matvec_rows_kernel<T, KC, true><<<blocks, 32 * skinny::kGemvRows, 0, s>>>(a, x, o, m, n);
  else
    matvec_rows_kernel<T, KC, false><<<blocks, 32 * skinny::kGemvRows, 0, s>>>(a, x, o, m, n);
}

template <typename T, int BN, skinny::Copy MODE>
cudaError_t launch_tile(const T* a, const T* x, T* o, T* partials, long long m,
                        long long n, long long k, long long splits,
                        long long split_len, cudaStream_t s) {
  constexpr int smem = skinny::launch_smem_bytes<T, BN>();
  cudaError_t err = cudaFuncSetAttribute(matvec_tile_kernel<T, BN, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((m + skinny::kBlockRows - 1) / skinny::kBlockRows),
                  (unsigned)((k + BN - 1) / BN), (unsigned)splits);
  matvec_tile_kernel<T, BN, MODE><<<grid, skinny::kThreads, smem, s>>>(
      a, x, splits > 1 ? partials : o, m, n, k, split_len);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long count = m * k;
  split_sum_kernel<T><<<(unsigned)((count + 255) / 256), 256, 0, s>>>(
      partials, o, count, splits);
  return cudaGetLastError();
}

template <typename T, int BN>
cudaError_t launch_bn(const T* a, const T* x, T* o, T* partials, long long m,
                      long long n, long long k, long long splits,
                      long long split_len, cudaStream_t s) {
  using skinny::Copy;
  const bool aligned = reinterpret_cast<uintptr_t>(a) % 16 == 0;
  if (aligned && n % skinny::Layout<T, BN>::BK == 0 && split_len % skinny::Layout<T, BN>::BK == 0)
    return launch_tile<T, BN, Copy::kBulk>(a, x, o, partials, m, n, k, splits, split_len, s);
  if (aligned && n % Vec16<T>::n == 0)
    return launch_tile<T, BN, Copy::kVec>(a, x, o, partials, m, n, k, splits, split_len, s);
  return launch_tile<T, BN, Copy::kElem>(a, x, o, partials, m, n, k, splits, split_len, s);
}

// The plan (bm, bn, chunk, splits, split_len) from kernels/matvec.py:plan,
// checked against what the kernels take.
template <typename T>
int launch(const void* a_, const void* x_, void* o_, void* partials_,
           long long m, long long n, long long k, long long bm, long long bn,
           long long chunk, long long splits, long long split_len,
           void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const T* a = (const T*)a_;
  const T* x = (const T*)x_;
  T* o = (T*)o_;
  T* partials = (T*)partials_;
  if (k <= skinny::kMaxGemvCols) {
    if (bm != skinny::kGemvRows || bn != k || splits != 1) return (int)cudaErrorInvalidValue;
    switch (k) {
      case 1: launch_rows<T, 1>(a, x, o, m, n, s); break;
      case 2: launch_rows<T, 2>(a, x, o, m, n, s); break;
      case 3: launch_rows<T, 3>(a, x, o, m, n, s); break;
      case 4: launch_rows<T, 4>(a, x, o, m, n, s); break;
    }
    static_assert(skinny::kMaxGemvCols == 4, "the switch above covers k = 1..4");
    return (int)cudaGetLastError();
  }
  if (!skinny::tile_cut_ok<T>(n, bm, chunk, splits, split_len, partials))
    return (int)cudaErrorInvalidValue;
  switch (bn) {
    case 16: return (int)launch_bn<T, 16>(a, x, o, partials, m, n, k, splits, split_len, s);
    case 32: return (int)launch_bn<T, 32>(a, x, o, partials, m, n, k, splits, split_len, s);
    case 64: return (int)launch_bn<T, 64>(a, x, o, partials, m, n, k, splits, split_len, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int repro_matvec(int dtype, const void* a, const void* x, void* o,
                            void* partials, long long m, long long n, long long k,
                            long long bm, long long bn, long long chunk,
                            long long splits, long long split_len, void* stream) {
  if (m <= 0 || k <= 0) return 0;
  if (dtype == REPRO_F32)
    return launch<float>(a, x, o, partials, m, n, k, bm, bn, chunk, splits, split_len, stream);
  if (dtype == REPRO_F64)
    return launch<double>(a, x, o, partials, m, n, k, bm, bn, chunk, splits, split_len, stream);
  return (int)cudaErrorInvalidValue;
}
