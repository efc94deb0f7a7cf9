// The skinny tile of K5 (matvec), K6 (cheb_step) and K7 (cg_step) on
// Hopper: a block's (kBlockRows x BN) share of `A[:, kbeg:kend] @
// X[kbeg:kend, :]` for A (m, n) and a slab X (n, k) of a few dozen probe
// columns, both row-major; and, for k <= kMaxGemvCols, one row of A
// against X by one warp (`row_dot`).
//
// Bound: bytes.  A is read from device memory once for any k <= BN
// (BN = 16, 32 or 64), at 4 bytes of f32 per 2k FLOP: at k = 32 an f32
// call is just above the card's f32 ridge, so the memory rate and the
// FFMA rate have to be kept near their peaks at once.  Design (each
// choice measured on the H100 against its alternatives):
//  - A streams through shared memory in a ring of kStages = 2 stages
//    of 32 KB of A, as many as fit kBlocksPerSm = 2 blocks on an SM.  A
//    stage holds 256 contiguous bytes of each of the block's 128 rows (64
//    f32 or 32 f64 columns; 128-byte pieces streamed 7 % slower)
//    and the matching rows of X's BN columns.  When n is a multiple of
//    the stage width and A is 16-byte aligned, each row piece is one
//    bulk copy by the copy engine (`cp.async.bulk`, counted on the
//    stage's mbarrier), issued by one thread per row, which keeps the
//    copies' address arithmetic out of the FFMA loop's issue slots (2-10
//    % faster than per-thread 16-byte `cp.async` copies; issuing all rows
//    from one warp was slower).  Otherwise 16-byte `cp.async` copies, or
//    element copies when rows are not 16-byte aligned, zero-fill what
//    lies outside the matrix or past `kend` (`Copy`).  X always takes
//    `cp.async` copies.
//  - The block's 256 threads split each stage's columns between G groups
//    that each hold the whole (kBlockRows x BN) tile, so every thread
//    gets a large register tile: in f32 4 x 8 FFMAs (8 x 8 at BN = 64)
//    fed per two columns by four (eight) 8-byte loads of A and four
//    16-byte loads of X (a 4 x 4 tile took twice the FFMA time: shared
//    memory serves a 16-byte load to a warp in four passes).  Stage rows are padded by 16 bytes, so the rows a warp reads
//    at once fall in distinct banks.  Full f32, no TF32.
//  - f64: the FP64 tensor cores (DMMA, `mma.sync ... m16n8k4 ... f64`);
//    a warp owns 16 rows and all BN columns of its group's tile.  X's
//    stage rows are padded by 64 bytes, so a B fragment (four rows of
//    eight values) takes two shared-memory wavefronts.  IEEE f64.
//  - At the end the G partial tiles meet in shared memory, and `sum`
//    adds them in group order for the kernel's epilogue.
// Each output's sum over A's columns runs in a fixed order (each group's
// columns in increasing order, in steps of four on the tensor cores, then
// the groups in order), so a call is repeatable bit for bit; the order
// differs from cuBLAS's, so the plain version is matched to a rounding
// bound, not bitwise.
#pragma once

#include "repro_kernels.cuh"

namespace repro {
namespace skinny {

constexpr int kThreads = 256;      // eight warps
constexpr int kBlockRows = 128;    // rows of A (and of the output) per block
constexpr int kBlocksPerSm = 2;    // resident together (registers, smem)
constexpr int kChunkBytes = 256;   // bytes of each A row per stage
constexpr int kStages = 2;         // as many as fit kBlocksPerSm blocks

template <typename T, int BN>
struct Layout {
  static constexpr int BK = kChunkBytes / sizeof(T);            // 64 | 32
  static constexpr int LDA = BK + 16 / sizeof(T);               // +16 bytes
  static constexpr int LDX = BN + (sizeof(T) == 8 ? 64 / 8 : 0);
  static constexpr int A_ELEMS = kBlockRows * LDA;
  static constexpr int STAGE_ELEMS = A_ELEMS + BK * LDX;
  static constexpr int STAGE_BYTES = STAGE_ELEMS * sizeof(T);
  static_assert(BN == 16 || BN == 32 || BN == 64, "BN is 16, 32 or 64");
  static_assert(A_ELEMS * sizeof(T) % 16 == 0 && STAGE_BYTES % 16 == 0,
                "stages stay 16-byte aligned");
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// dst[0:BYTES] = ok ? src[0:BYTES] : 0 (src is not read when !ok)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(ok ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(BYTES), "r"(ok ? BYTES : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mbarrier of one stage: one arrival (the expected byte count) per phase
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  uint64_t state;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;\n"
               : "=l"(state) : "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}
// dst[0:bytes] = src[0:bytes] by the copy engine (TMA), counted on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// How a stage's rows of A reach shared memory: whole 256-byte row pieces
// by the copy engine (n a multiple of the stage width, A 16-byte
// aligned), 16-byte cp.async copies (n a multiple of 16 bytes), or
// element copies.
enum class Copy { kBulk, kVec, kElem };

// One stage: A[row0:row0+kBlockRows, c0:c0+BK] and X[c0:c0+BK,
// col0:col0+BN], zero outside [0, m) x [0, kend) and [0, kend) x [0, k).
template <typename T, int BN, Copy MODE>
__device__ __forceinline__ void load_stage(T* as, T* xs, const T* __restrict__ a,
                                           const T* __restrict__ x, long long m,
                                           long long n, long long k, long long row0,
                                           long long col0, long long c0, long long kend,
                                           bool x_vec, uint64_t* bar) {
  using L = Layout<T, BN>;
  constexpr int W = 16 / sizeof(T);
  const int tid = threadIdx.x;
  if constexpr (MODE == Copy::kBulk) {
    // rows past m are left as they are: they meet only their own outputs
    const int rows = m - row0 < kBlockRows ? (int)(m - row0) : kBlockRows;
    if (tid == 0) mbar_expect(bar, rows * kChunkBytes);
    if (tid < rows) bulk_copy(as + tid * L::LDA, a + (row0 + tid) * n + c0, kChunkBytes, bar);
  } else if constexpr (MODE == Copy::kVec) {
    constexpr int RV = L::BK / W;   // vectors per row of the stage
#pragma unroll
    for (int v = tid; v < kBlockRows * RV; v += kThreads) {
      const int r = v / RV, c = (v % RV) * W;
      const bool ok = row0 + r < m && c0 + c < kend;
      cp_async<16>(as + r * L::LDA + c, ok ? a + (row0 + r) * n + c0 + c : a, ok);
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < kBlockRows * L::BK; e += kThreads) {
      const int r = e / L::BK, c = e % L::BK;
      const bool ok = row0 + r < m && c0 + c < kend;
      cp_async<sizeof(T)>(as + r * L::LDA + c, ok ? a + (row0 + r) * n + c0 + c : a, ok);
    }
  }
  if (x_vec) {
    constexpr int RV = BN / W;
#pragma unroll
    for (int v = tid; v < L::BK * RV; v += kThreads) {
      const int r = v / RV, c = (v % RV) * W;
      const bool ok = c0 + r < kend && col0 + c < k;
      cp_async<16>(xs + r * L::LDX + c, ok ? x + (c0 + r) * k + col0 + c : x, ok);
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < L::BK * BN; e += kThreads) {
      const int r = e / BN, c = e % BN;
      const bool ok = c0 + r < kend && col0 + c < k;
      cp_async<sizeof(T)>(xs + r * L::LDX + c, ok ? x + (c0 + r) * k + col0 + c : x, ok);
    }
  }
}

// f32: each thread holds a TM x TN register tile.  G = kThreads / GT
// groups of GT = (kBlockRows / TM) (BN / TN) threads; thread t of group g
// = tid / GT owns rows rt + RT i (i < TM) and columns TN ct + j (j < TN),
// ct = t % CT, rt = t / CT, CT = BN / TN, RT = kBlockRows / TM, and sums
// the stage columns [g KG, (g + 1) KG), KG = BK / G.
template <int BN>
struct FfmaTile {
  using L = Layout<float, BN>;
  // 4 x 8 up to 32 columns, 8 x 8 at 64: each the fastest measured there
  static constexpr int TM = BN == 64 ? 8 : 4;
  static constexpr int TN = 8;
  static constexpr int CT = BN / TN;
  static constexpr int RT = kBlockRows / TM;
  static constexpr int GT = CT * RT;
  static constexpr int G = kThreads / GT;
  static constexpr int KG = L::BK / G;            // stage columns per group
  static constexpr int RED_ELEMS = G * kBlockRows * BN;
  static_assert(kThreads % GT == 0 && L::BK % G == 0 && KG % 2 == 0 && TN % 4 == 0,
                "groups divide");
  float acc[TM][TN];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }

  __device__ __forceinline__ void consume(const float* as, const float* xs) {
    const int g = threadIdx.x / GT, t = threadIdx.x % GT;
    const int ct = t % CT, rt = t / CT;
    const float* ap = as + rt * L::LDA + g * KG;
    const float* xp = xs + g * KG * L::LDX + TN * ct;
#pragma unroll
    for (int kk = 0; kk < KG; kk += 2) {
      float x0[TN], x1[TN];
#pragma unroll
      for (int j = 0; j < TN; j += 4) {
        const float4 u = *reinterpret_cast<const float4*>(xp + kk * L::LDX + j);
        const float4 v = *reinterpret_cast<const float4*>(xp + (kk + 1) * L::LDX + j);
        x0[j] = u.x, x0[j + 1] = u.y, x0[j + 2] = u.z, x0[j + 3] = u.w;
        x1[j] = v.x, x1[j + 1] = v.y, x1[j + 2] = v.z, x1[j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float2 av = *reinterpret_cast<const float2*>(ap + i * RT * L::LDA + kk);
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fma_rn(av.x, x0[j], acc[i][j]);
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fma_rn(av.y, x1[j], acc[i][j]);
      }
    }
  }

  // red[g][row][col] = this group's share of the tile
  __device__ __forceinline__ void store(float* red) const {
    const int g = threadIdx.x / GT, t = threadIdx.x % GT;
    const int ct = t % CT, rt = t / CT;
    float* rp = red + (g * kBlockRows + rt) * BN + TN * ct;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; j += 4)
        *reinterpret_cast<float4*>(rp + i * RT * BN + j) =
            make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
  }
};

// f64: WR = kBlockRows / 16 warps per group, G = 8 / WR groups; warp w
// owns rows 16 (w % WR) .. + 15 and all BN columns as BN / 8 m16n8
// accumulator fragments, and sums the stage columns of group w / WR; lane
// = 4 gid + tig holds, in fragment t, rows gid and gid + 8 at columns
// 8t + 2 tig + {0, 1}.
template <int BN>
struct DmmaTile {
  using L = Layout<double, BN>;
  static constexpr int NT = BN / 8;
  static constexpr int WR = kBlockRows / 16;
  static constexpr int G = kThreads / 32 / WR;
  static constexpr int KG = L::BK / G;
  static constexpr int RED_ELEMS = G * kBlockRows * BN;
  static_assert(kThreads / 32 % WR == 0 && L::BK % G == 0 && KG % 4 == 0, "groups divide");
  double acc[NT][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[t][q] = 0.0;
  }

  __device__ __forceinline__ void consume(const double* as, const double* xs) {
    const int w = threadIdx.x / 32, g = w / WR;
    const int gid = threadIdx.x % 32 / 4, tig = threadIdx.x % 4;
    const double* ap = as + (16 * (w % WR) + gid) * L::LDA + g * KG + tig;
    const double* xp = xs + (g * KG + tig) * L::LDX + gid;
#pragma unroll
    for (int kk = 0; kk < KG; kk += 4) {
      const double a0 = ap[kk], a1 = ap[8 * L::LDA + kk];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const double b = xp[kk * L::LDX + 8 * t];
        asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
            "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
            : "+d"(acc[t][0]), "+d"(acc[t][1]), "+d"(acc[t][2]), "+d"(acc[t][3])
            : "d"(a0), "d"(a1), "d"(b));
      }
    }
  }

  __device__ __forceinline__ void store(double* red) const {
    const int w = threadIdx.x / 32, g = w / WR;
    const int gid = threadIdx.x % 32 / 4, tig = threadIdx.x % 4;
    double* rp = red + (g * kBlockRows + 16 * (w % WR) + gid) * BN + 2 * tig;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      rp[8 * t] = acc[t][0];
      rp[8 * t + 1] = acc[t][1];
      rp[8 * BN + 8 * t] = acc[t][2];
      rp[8 * BN + 8 * t + 1] = acc[t][3];
    }
  }
};

template <typename T, int BN> struct TileOf;
template <int BN> struct TileOf<float, BN> { using type = FfmaTile<BN>; };
template <int BN> struct TileOf<double, BN> { using type = DmmaTile<BN>; };

// Shared memory of one block: the ring, reused for the partial tiles.
template <typename T, int BN>
__host__ __device__ constexpr int smem_bytes() {
  constexpr int ring = kStages * Layout<T, BN>::STAGE_BYTES;
  constexpr int red = TileOf<T, BN>::type::RED_ELEMS * sizeof(T);
  return ring > red ? ring : red;
}
// ... and the stages' mbarriers after it; kBlocksPerSm blocks fit an SM
// (228 KB, less 1 KB reserved per block)
template <typename T, int BN>
__host__ __device__ constexpr int launch_smem_bytes() {
  constexpr int bytes = smem_bytes<T, BN>() + 8 * kStages;
  static_assert(kBlocksPerSm * (bytes + 1024) <= 233472, "the blocks fit an SM");
  return bytes;
}

// Leaves the block's share of A[row0:row0+kBlockRows, kbeg:kend] @
// X[kbeg:kend, col0:col0+BN] (zero where a row or column lies outside the
// matrix) in `smem` as G partial (kBlockRows, BN) tiles, for `sum`.  `smem`
// holds smem_bytes<T, BN>() of dynamic shared memory.
template <typename T, int BN, Copy MODE>
__device__ __forceinline__ void skinny_mma_tile(const T* __restrict__ a,
                                                const T* __restrict__ x, long long m,
                                                long long n, long long k, long long row0,
                                                long long col0, long long kbeg,
                                                long long kend, T* smem) {
  using L = Layout<T, BN>;
  constexpr int S = kStages;
  uint64_t* bars = reinterpret_cast<uint64_t*>(reinterpret_cast<char*>(smem) +
                                               smem_bytes<T, BN>());
  if constexpr (MODE == Copy::kBulk) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < S; ++s) mbar_init(bars + s);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  const bool x_vec = k % (16 / sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const long long chunks = kend > kbeg ? (kend - kbeg + L::BK - 1) / L::BK : 0;
  auto load = [&](long long ch) {
    T* as = smem + (int)(ch % S) * L::STAGE_ELEMS;
    load_stage<T, BN, MODE>(as, as + L::A_ELEMS, a, x, m, n, k, row0, col0,
                            kbeg + ch * L::BK, kend, x_vec, bars + (int)(ch % S));
  };
  typename TileOf<T, BN>::type tile;
  tile.zero();
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < chunks) load(s);
    cp_async_commit();
  }
  for (long long ch = 0; ch < chunks; ++ch) {
    cp_async_wait<S - 2>();   // chunk ch has landed (this thread's copies)
    if constexpr (MODE == Copy::kBulk)
      mbar_wait(bars + (int)(ch % S), (unsigned)(ch / S) & 1u);   // (the engine's)
    __syncthreads();          // ... every thread's; chunk ch - 1 is consumed
    if (ch + S - 1 < chunks) load(ch + S - 1);
    cp_async_commit();
    const T* as = smem + (int)(ch % S) * L::STAGE_ELEMS;
    tile.consume(as, as + L::A_ELEMS);
  }
  cp_async_wait<0>();
  __syncthreads();            // the ring is free
  tile.store(smem);
  __syncthreads();
}

// The tile's (row, col) entry: the groups' partial sums in group order.
template <typename T, int BN>
__device__ __forceinline__ T sum(const T* smem, int row, int col) {
  constexpr int G = TileOf<T, BN>::type::G;
  const T* p = smem + row * BN + col;
  T s = p[0];
#pragma unroll
  for (int g = 1; g < G; ++g) s = add_rn(s, p[g * kBlockRows * BN]);
  return s;
}

// Whether (bm, chunk, splits, split_len) is a cut of the tile path that
// kernels/matvec.py:plan can give for n columns of A: 32-aligned ranges
// that cover [0, n), a partials buffer when there are several.
constexpr int kSplitAlign = 32;   // a range's length is a multiple of this
template <typename T>
__host__ __forceinline__ bool tile_cut_ok(long long n, long long bm, long long chunk,
                                          long long splits, long long split_len,
                                          const void* partials) {
  return bm == kBlockRows && chunk == kChunkBytes / (long long)sizeof(T) && split_len > 0 &&
         split_len % kSplitAlign == 0 && splits >= 1 && splits <= 65535 &&
         splits == (n > 0 ? (n + split_len - 1) / split_len : 1) &&
         (splits == 1 || partials != nullptr);
}

// The GEMV path (k <= kMaxGemvCols): one warp per row of A, kGemvRows
// rows per 256-thread block.
constexpr int kGemvRows = 8;
constexpr int kMaxGemvCols = 4;

// acc[j] = sum over c of arow[c] * x[c * KC + j], by one warp: lane `lane`
// takes columns lane, lane + 32, ... (16-byte vectors of them when VEC:
// arow 16-byte aligned, n a multiple of the vector), multiplies each by
// the KC entries of x it meets (x is small and stays in L1/L2), and the 32
// partial sums meet by shuffles in a fixed order; every lane gets them.
template <typename T, int KC, bool VEC>
__device__ __forceinline__ void row_dot(const T* __restrict__ arow, const T* __restrict__ x,
                                        long long n, int lane, T (&acc)[KC]) {
#pragma unroll
  for (int j = 0; j < KC; ++j) acc[j] = T(0);
  if constexpr (VEC) {
    using V = typename Vec16<T>::type;
    constexpr int W = Vec16<T>::n;
    const V* __restrict__ av = reinterpret_cast<const V*>(arow);
    const long long nv = n / W;
#pragma unroll 4
    for (long long c = lane; c < nv; c += 32) {
      const V v = __ldg(av + c);
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int q = 0; q < W; ++q) {
        const T* xr = x + (c * W + q) * KC;
#pragma unroll
        for (int j = 0; j < KC; ++j) acc[j] = fma_rn(e[q], __ldg(xr + j), acc[j]);
      }
    }
  } else {
#pragma unroll 4
    for (long long c = lane; c < n; c += 32) {
      const T e = __ldg(arow + c);
#pragma unroll
      for (int j = 0; j < KC; ++j) acc[j] = fma_rn(e, __ldg(x + c * KC + j), acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < KC; ++j)
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      acc[j] = add_rn(acc[j], __shfl_xor_sync(0xffffffffu, acc[j], off));
}

// out[c] = sum over row blocks t, in order, of partials[t, c]: the probe
// dots of K6 from its blocks' column sums
template <typename T>
__global__ void column_sum_kernel(const T* __restrict__ partials, T* __restrict__ out,
                                  long long blocks, long long k) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= k) return;
  T s = T(0);
  for (long long t = 0; t < blocks; ++t) s = add_rn(s, partials[t * k + c]);
  out[c] = s;
}

}  // namespace skinny
}  // namespace repro
