// K2 panel_update: out = a - c @ r, the subtract fused into the product.
//
// Replaces the Pallas TPU kernel `panel_update_kernel` /
// `panel_update_pallas` (src/repro/kernels/panel_update.py:35/48).
//
// Bound: bytes.  At the panel width K = 32 an f32 call does 2K = 64 FLOP
// per element of `a` against 8 bytes read and written, 8 FLOP/byte, below
// the card's f32 ridge (67 TFLOP/s / 3.35 TB/s = 20); f64 does 4 FLOP/byte
// against a DFMA ridge of 10.  The FMAs alone take about 40 % of the byte
// time, so they have to run while `a` streams, not before it.  Design
// (each choice measured on an H100 at (8192, 8192, K = 32) against its
// alternatives, tools/k2_variants.py; the parent kernel took 0.380 ms f32):
//  - Tiles of BM x BN outputs for 256 threads, each a register tile of TM
//    rows (ty + 16 i) by J 16-byte vectors (columns W tx + 16 W j + w), fed
//    by 16-byte shared-memory loads; FFMA in full f32 (no TF32, which would
//    change the numbers the JAX package gives), DFMA in f64.
//  - A tile's `a`, and its chunk of `c` (BM x 32) and `r` (32 x BN), go
//    into a stage in shared memory by `cp.async` (16 bytes a thread where
//    the rows allow, zero-filled outside the matrices), and the epilogue
//    reads `a` from there, subtracts and writes `out` with 16-byte stores,
//    so the trailing matrix crosses memory once.
//  - f32: 64 x 128 tiles, a ring of two stages, and persistent blocks (as
//    many as the card holds at once, two an SM) walking the tiles in a
//    grid-stride loop, column tiles fastest, so a tile's loads are in
//    flight while the tile before it is multiplied: 0.197 ms, against
//    0.211 with one stage and 0.225 on 32-row tiles.
//  - bf16 operands (f32 buffer) go through registers: loaded at the same
//    point, held over the current tile's work and widened into the stage
//    after it (0.197 ms; 0.259 widened at once), on 128 x 128 tiles
//    (0.219 on 64-row ones).
//  - f64: 64 x 64 tiles, one stage, one tile a block: 0.378 ms, against
//    0.396 persistent with two stages.
// Summation order: every output's product is one FMA chain from zero over
// k = 0 .. K-1 in order, then one subtract from `a`, whatever the call's
// shape or the element's place in a tile.  So rows of a call equal the
// same rows of a larger call bit for bit (the mesh lookahead relies on
// it), and a repeated call is bitwise equal.  The order differs from
// cuBLAS's: the plain version is matched to a rounding bound, not bitwise.
// A (B, M, N) stack is one launch (the port of what `vmap` does to the
// Pallas call's grid): the tile space is B x the matrix's tiles, matrix
// slowest, walked by the same blocks (persistent, or one tile each), so
// matrix b of a stack equals the one-matrix launch on it bit for bit.
#include "repro_kernels.cuh"
#include "skinny_mma.cuh"   // the cp.async helpers

#include <climits>
#include <map>
#include <mutex>

namespace {

using repro::skinny::cp_async;
using repro::skinny::cp_async_commit;
using repro::skinny::cp_async_wait;

constexpr int kThreads = 256;   // 16 x 16 threads over a tile
constexpr int kChunk = 32;      // columns of c (rows of r) in a stage: the panel width

// By accumulator and operand type: a thread's register tile (TM rows by J
// 16-byte vectors), the ring's depth S, and whether the blocks persist
// (PERSIST: as many as the card holds at once, each walking many tiles)
// or take one tile each
template <typename T, typename OpT> struct Config;
template <> struct Config<float, float> { static constexpr int TM = 4, J = 2, S = 2, PERSIST = 1; };
template <> struct Config<float, __nv_bfloat16> { static constexpr int TM = 8, J = 2, S = 2, PERSIST = 1; };
template <> struct Config<double, double> { static constexpr int TM = 4, J = 2, S = 1, PERSIST = 0; };
template <> struct Config<double, __nv_bfloat16> { static constexpr int TM = 4, J = 2, S = 1, PERSIST = 0; };

template <typename T, typename OpT>
struct Layout {
  using C = Config<T, OpT>;
  using V = typename repro::Vec16<T>::type;
  static constexpr int W = repro::Vec16<T>::n;      // elements of a 16-byte vector
  static constexpr int TM = C::TM, J = C::J, S = C::S;
  static constexpr int BM = 16 * TM;                // rows of a tile
  static constexpr int BN = 16 * W * J;             // columns of a tile
  static constexpr int A_ELEMS = BM * BN;           // a, row-major
  static constexpr int C_ELEMS = BM * kChunk;       // c chunk, row-major
  static constexpr int R_ELEMS = kChunk * BN;       // r chunk, row-major
  static constexpr int STAGE_ELEMS = A_ELEMS + C_ELEMS + R_ELEMS;
  static constexpr int SMEM_BYTES = S * STAGE_ELEMS * (int)sizeof(T);
  static_assert(A_ELEMS % (kThreads * W) == 0 && C_ELEMS % (kThreads * W) == 0 &&
                    R_ELEMS % (kThreads * W) == 0,
                "every thread copies whole vectors of each part");
};

__device__ __forceinline__ void unpack(const float4& v, float* x) {
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ void unpack(const double2& v, double* x) { x[0] = v.x, x[1] = v.y; }
__device__ __forceinline__ float4 pack(const float* x) {
  return make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ double2 pack(const double* x) { return make_double2(x[0], x[1]); }

// dst (rows x cols, row-major in shared memory) = src[row0:, col0:] of a
// (rows_in, cols_in) row-major matrix with leading dimension ld, zero
// outside it; 16-byte copies when `vec` (cols_in a multiple of W, src
// 16-byte aligned), else element copies.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void copy_async(T* dst, const T* __restrict__ src, long long rows_in,
                                           long long cols_in, long long ld, long long row0,
                                           long long col0, bool vec) {
  constexpr int W = repro::Vec16<T>::n;
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int RV = COLS / W;
#pragma unroll
    for (int it = 0; it < ROWS * RV / kThreads; ++it) {
      const int v = tid + it * kThreads, rr = v / RV, cc = (v % RV) * W;
      const bool ok = row0 + rr < rows_in && col0 + cc < cols_in;
      cp_async<16>(dst + rr * COLS + cc, ok ? src + (row0 + rr) * ld + col0 + cc : src, ok);
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < ROWS * COLS / kThreads; ++it) {
      const int e = tid + it * kThreads, rr = e / COLS, cc = e % COLS;
      const bool ok = row0 + rr < rows_in && col0 + cc < cols_in;
      cp_async<sizeof(T)>(dst + rr * COLS + cc, ok ? src + (row0 + rr) * ld + col0 + cc : src,
                          ok);
    }
  }
}

// The same through registers, widening each element to T (the chunks of
// c and r after the first, for K > 32)
template <typename T, int ROWS, int COLS, typename OpT>
__device__ __forceinline__ void copy_widen(T* dst, const OpT* __restrict__ src, long long rows_in,
                                           long long cols_in, long long ld, long long row0,
                                           long long col0) {
#pragma unroll 4
  for (int it = 0; it < ROWS * COLS / kThreads; ++it) {
    const int e = threadIdx.x + it * kThreads, rr = e / COLS, cc = e % COLS;
    const bool ok = row0 + rr < rows_in && col0 + cc < cols_in;
    dst[e] = ok ? T(repro::widen(src[(row0 + rr) * ld + col0 + cc])) : T(0);
  }
}

// Operands of another type than T (bf16): a tile's first chunk of c and r
// in registers, loaded early and widened into its stage later, so that
// the loads' latency hides behind the work of the tile before it
template <typename T, typename OpT>
struct Fetched {
  using L = Layout<T, OpT>;
  static constexpr int NC = L::C_ELEMS / kThreads, NR = L::R_ELEMS / kThreads;
  OpT cv[NC], rv[NR];

  __device__ __forceinline__ void load(const OpT* __restrict__ c, const OpT* __restrict__ r,
                                       long long m, long long n, long long k, long long row0,
                                       long long col0) {
#pragma unroll
    for (int it = 0; it < NC; ++it) {
      const int e = threadIdx.x + it * kThreads, rr = e / kChunk, kk = e % kChunk;
      cv[it] = OpT{};
      if (row0 + rr < m && kk < k) cv[it] = c[(row0 + rr) * k + kk];
    }
#pragma unroll
    for (int it = 0; it < NR; ++it) {
      const int e = threadIdx.x + it * kThreads, kk = e / L::BN, cc = e % L::BN;
      rv[it] = OpT{};
      if (kk < k && col0 + cc < n) rv[it] = r[kk * n + col0 + cc];
    }
  }
  __device__ __forceinline__ void store(T* cs, T* rs) const {
#pragma unroll
    for (int it = 0; it < NC; ++it) cs[threadIdx.x + it * kThreads] = T(repro::widen(cv[it]));
#pragma unroll
    for (int it = 0; it < NR; ++it) rs[threadIdx.x + it * kThreads] = T(repro::widen(rv[it]));
  }
};

// acc += c chunk @ r chunk for this thread's outputs, k in order
template <typename T, typename L>
__device__ __forceinline__ void multiply(T (&acc)[L::TM][L::J][L::W], const T* cs, const T* rs,
                                         int tx, int ty) {
  using V = typename L::V;
  constexpr int W = L::W;
#pragma unroll
  for (int kk = 0; kk < kChunk; kk += W) {
    T cv[L::TM][W];
#pragma unroll
    for (int i = 0; i < L::TM; ++i)
      unpack(*reinterpret_cast<const V*>(cs + (ty + 16 * i) * kChunk + kk), cv[i]);
#pragma unroll
    for (int q = 0; q < W; ++q) {
      T rv[L::J][W];
#pragma unroll
      for (int j = 0; j < L::J; ++j)
        unpack(*reinterpret_cast<const V*>(rs + (kk + q) * L::BN + W * tx + 16 * W * j), rv[j]);
#pragma unroll
      for (int i = 0; i < L::TM; ++i)
#pragma unroll
        for (int j = 0; j < L::J; ++j)
#pragma unroll
          for (int w = 0; w < W; ++w)
            acc[i][j][w] = repro::fma_rn(cv[i][q], rv[j][w], acc[i][j][w]);
    }
  }
}

// kStack: a stack of more than one matrix (else the tile index is the
// matrix's own, and the kernel is the single-matrix one instruction for
// instruction: the batch decomposition cost 3 % at (8192, 8192, K = 32)
// on an H100, tools/panel_route_time.py).
// VEC: n a multiple of W and a, out 16-byte aligned (16-byte copies of a
// and a 16-byte epilogue).  A template parameter, not a run-time flag: as
// a flag it cost 4-9 % with bf16 operands at (8192, 8192, K = 32) on an
// H100, nothing in f32, and moved f64 by -3 % to +2 % between two calls
// (tools/k2_variants.py, vec_at_run_time)
template <typename T, typename OpT, bool VEC, bool kStack>
__global__ void __launch_bounds__(kThreads)
panel_update_kernel(const T* __restrict__ a, const OpT* __restrict__ c,
                    const OpT* __restrict__ r, T* __restrict__ out, long long m,
                    long long n, long long k, long long tiles_n, long long tiles_per,
                    long long tiles) {
  using L = Layout<T, OpT>;
  using V = typename L::V;
  constexpr int S = L::S, W = L::W;
  constexpr bool kSameType = std::is_same<T, OpT>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool c_vec = k % W == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0;
  const bool r_vec = n % W == 0 && reinterpret_cast<uintptr_t>(r) % 16 == 0;
  const long long chunks = (k + kChunk - 1) / kChunk;
  const long long stride = gridDim.x;

  auto stage = [&](int s) { return smem + s * L::STAGE_ELEMS; };
  Fetched<T, OpT> fetched;   // bf16 operands only

  // tile t of the stack: its matrix's a, c and r, and its first row and
  // column (one matrix: t is the tile)
  struct Tile {
    const T* a;
    const OpT* c;
    const OpT* r;
    T* out;
    long long row0, col0;
  };
  auto tile = [&](long long t) {
    long long b = 0, u = t;
    if constexpr (kStack) {
      b = t / tiles_per;
      u = t - b * tiles_per;
    }
    return Tile{a + b * m * n, c + b * m * k, r + b * k * n, out + b * m * n,
                u / tiles_n * L::BM, u % tiles_n * L::BN};
  };

  // tile t's a and first chunk of c and r into stage s, as one commit
  // group; bf16 c and r reach the stage now if `now`, else at `fetched.store`
  auto fill = [&](long long t, int s, bool now) {
    if (t < tiles) {
      T* st = stage(s);
      const Tile tl = tile(t);
      const long long row0 = tl.row0, col0 = tl.col0;
      copy_async<T, L::BM, L::BN>(st, tl.a, m, n, n, row0, col0, VEC);
      if constexpr (kSameType) {
        copy_async<T, L::BM, kChunk>(st + L::A_ELEMS, tl.c, m, k, k, row0, 0, c_vec);
        copy_async<T, kChunk, L::BN>(st + L::A_ELEMS + L::C_ELEMS, tl.r, k, n, n, 0, col0,
                                     r_vec);
      } else {
        fetched.load(tl.c, tl.r, m, n, k, row0, col0);
        if (now) fetched.store(st + L::A_ELEMS, st + L::A_ELEMS + L::C_ELEMS);
      }
    }
    cp_async_commit();
  };

  long long t = blockIdx.x;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) fill(t + s * stride, s, true);
  for (long long j = 0; t < tiles; ++j, t += stride) {
    const int s = (int)(j % S);
    const int s_next = (int)((j + S - 1) % S);
    // the stage read by the previous tile is free (the barrier ending it)
    fill(t + (S - 1) * stride, s_next, S == 1);
    cp_async_wait<S - 1>();   // this thread's copies of stage s have landed
    __syncthreads();          // ... and every thread's
    T* st = stage(s);
    T* cs = st + L::A_ELEMS;
    T* rs = cs + L::C_ELEMS;
    const Tile tl = tile(t);
    const long long row0 = tl.row0, col0 = tl.col0;

    T acc[L::TM][L::J][W];
#pragma unroll
    for (int i = 0; i < L::TM; ++i)
#pragma unroll
      for (int jj = 0; jj < L::J; ++jj)
#pragma unroll
        for (int w = 0; w < W; ++w) acc[i][jj][w] = T(0);
    multiply<T, L>(acc, cs, rs, tx, ty);
    for (long long ch = 1; ch < chunks; ++ch) {   // K > 32: further chunks
      __syncthreads();
      copy_widen<T, L::BM, kChunk>(cs, tl.c, m, k, k, row0, ch * kChunk);
      copy_widen<T, kChunk, L::BN>(rs, tl.r, k, n, n, ch * kChunk, col0);
      __syncthreads();
      multiply<T, L>(acc, cs, rs, tx, ty);
    }

#pragma unroll
    for (int i = 0; i < L::TM; ++i) {
      const int rr = ty + 16 * i;
      const long long gi = row0 + rr;
      if (gi >= m) continue;
#pragma unroll
      for (int jj = 0; jj < L::J; ++jj) {
        const int cc = W * tx + 16 * W * jj;
        const long long gj = col0 + cc;
        const T* ap = st + rr * L::BN + cc;
        T* op = tl.out + gi * n + gj;
        if constexpr (VEC) {
          if (gj < n) {
            T x[W];
            unpack(*reinterpret_cast<const V*>(ap), x);
#pragma unroll
            for (int w = 0; w < W; ++w) x[w] = repro::sub_rn(x[w], acc[i][jj][w]);
            *reinterpret_cast<V*>(op) = pack(x);
          }
        } else {
#pragma unroll
          for (int w = 0; w < W; ++w)
            if (gj + w < n) op[w] = repro::sub_rn(ap[w], acc[i][jj][w]);
        }
      }
    }
    if constexpr (!kSameType && S > 1)
      if (t + (S - 1) * stride < tiles)
        fetched.store(stage(s_next) + L::A_ELEMS, stage(s_next) + L::A_ELEMS + L::C_ELEMS);
    __syncthreads();   // stage s is read out: the next fill may reuse it
  }
  cp_async_wait<0>();
}

template <typename T, typename OpT, bool VEC, bool kStack>
int launch_kernel(const void* a, const void* c, const void* r, void* out, long long batch,
                  long long m, long long n, long long k, void* stream) {
  using L = Layout<T, OpT>;
  const auto kernel = panel_update_kernel<T, OpT, VEC, kStack>;
  // per device, set up at its first launch: the shared-memory attribute,
  // and for a persistent config the blocks the card holds at once
  static std::mutex mu;
  static std::map<int, long long> resident;
  long long cap = 0;
  {
    std::lock_guard<std::mutex> guard(mu);
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    auto it = resident.find(dev);
    if (it == resident.end()) {
      int per_sm = 0, sms = 0;
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::SMEM_BYTES);
      if (L::C::PERSIST) {
        if (e == cudaSuccess)
          e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                            L::SMEM_BYTES);
        if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (e == cudaSuccess && per_sm == 0) e = cudaErrorInvalidConfiguration;
      }
      if (e != cudaSuccess) return (int)e;
      it = resident.emplace(dev, (long long)per_sm * sms).first;
    }
    cap = it->second;
  }
  const long long tiles_n = (n + L::BN - 1) / L::BN;
  const long long tiles_per = (m + L::BM - 1) / L::BM * tiles_n;
  const long long tiles = batch * tiles_per;
  const long long grid = L::C::PERSIST && tiles > cap ? cap : tiles;
  if (grid > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)grid, kThreads, L::SMEM_BYTES, (cudaStream_t)stream>>>(
      (const T*)a, (const OpT*)c, (const OpT*)r, (T*)out, m, n, k, tiles_n, tiles_per, tiles);
  return (int)cudaGetLastError();
}

template <typename T, typename OpT>
int launch(const void* a, const void* c, const void* r, void* out, long long batch,
           long long m, long long n, long long k, void* stream) {
  const bool vec = n % repro::Vec16<T>::n == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (batch > 1)
    return vec ? launch_kernel<T, OpT, true, true>(a, c, r, out, batch, m, n, k, stream)
               : launch_kernel<T, OpT, false, true>(a, c, r, out, batch, m, n, k, stream);
  return vec ? launch_kernel<T, OpT, true, false>(a, c, r, out, batch, m, n, k, stream)
             : launch_kernel<T, OpT, false, false>(a, c, r, out, batch, m, n, k, stream);
}

}  // namespace

extern "C" int repro_panel_update(int dtype, int op_dtype, const void* a,
                                  const void* c, const void* r, void* out,
                                  long long batch, long long m, long long n,
                                  long long k, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return 0;
  if (dtype == REPRO_F32 && op_dtype == REPRO_F32)
    return launch<float, float>(a, c, r, out, batch, m, n, k, stream);
  if (dtype == REPRO_F32 && op_dtype == REPRO_BF16)
    return launch<float, __nv_bfloat16>(a, c, r, out, batch, m, n, k, stream);
  if (dtype == REPRO_F64 && op_dtype == REPRO_F64)
    return launch<double, double>(a, c, r, out, batch, m, n, k, stream);
  if (dtype == REPRO_F64 && op_dtype == REPRO_BF16)
    return launch<double, __nv_bfloat16>(a, c, r, out, batch, m, n, k, stream);
  return (int)cudaErrorInvalidValue;
}
