// K4 panel_factor: K sequential condensation steps on a (K, N) panel,
// spread over the blocks of ONE thread-block cluster.
//
// Replaces the Pallas TPU kernel `panel_factor_kernel` /
// `panel_factor_pallas` (src/repro/kernels/panel_factor.py:31/83).
//
// Bound: step latency.  The K steps depend on one another (each argmax
// needs the previous update), while the bytes are few: one read of the
// panel and one write of R, 2 MiB for (32, 8192) f32, under a microsecond
// at the memory rate.  The TPU kernel keeps the panel in VMEM for all K
// steps.  Here the blocks of one cluster (up to 16, one per SM; the cut is
// kernels/panel_factor.py:plan's) split the panel's columns: each block
// loads its slice once into shared memory, keeps it there for all K steps
// and writes R once, and a step costs ONE cluster barrier, two round trips
// through distributed shared memory and a pass over the block's K x cols
// slice.  Step j (m = m0 - j live columns, last = m - 1):
//   1. each block's argmax of |R[j, c]| over its live columns, ties to the
//      LOWEST index and NaN above every number, as torch.argmax: a total
//      order, so the blocks' candidates may be reduced in any order; the
//      block publishes its candidate and that column (K values), and the
//      owner of column `last` publishes it, in buffers of parity j % 2;
//   2. cluster barrier;
//   3. every block reduces the candidates to the same pivot column l and
//      copies the published columns l and last (remote reads); pv is
//      column l's row j;
//   4. each block normalizes the pivot row and applies the rank-1 update
//      to its own columns, the swap included: column last takes the old
//      column l (pr[last] = 1, or 0 for a zero pivot) and column l the old
//      column last, from those copies;
//   5. block 0 keeps ls, the sign (NaN for a NaN pivot, as jnp.sign) and
//      log|det|, in step order, and writes them at the end.
// No block reads another's slice, so one barrier a step suffices: a block
// rewrites its parity-(j % 2) buffers in step j + 2, after the barrier of
// step j + 1, which every block reaches only once done reading step j's.
// A panel too large for the cluster's shared memory (f32 K = 32 above
// about 28k columns, or a tall K) keeps each slice in R itself, in global
// memory and the L2, and runs the same steps on the same cluster: plan()
// picks the branch from the shape, never on a failure.
// Every multiply, subtract and divide rounds on its own, and every row,
// the pivot row and those above it included, takes the update (0 * inf is
// NaN, 0 - 0 * x turns -0 into +0): R and ls equal the plain version
// (kernels/ref.py:panel_factor_ref) bit for bit.
// A (B, K, N) stack of panels is one launch of B clusters, gridDim =
// (cluster, B, 1) (the port of what `vmap` does to the Pallas call's
// grid), on either branch; each cluster factorizes its matrix with the
// single panel's arithmetic (m0 and r_pos are the stack's, every matrix
// being at the same step), so matrix b equals the one-panel launch on it
// bit for bit.
#include "repro_kernels.cuh"

#include <cooperative_groups.h>

#include <algorithm>
#include <climits>
#include <cmath>
#include <map>
#include <mutex>
#include <type_traits>
#include <utility>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxRows = 1024;
constexpr int kMaxCluster = 16;   // non-portable: above the portable 8
constexpr long long kMaxGridY = 65535;   // clusters of a stack in flight at once

// The argmax's order as an unsigned key: a larger |x| has a larger key,
// every NaN the largest, 0 no candidate; ties go to the LOWEST index, as
// torch.argmax.  A total order, so the candidates may be reduced in any
// order.
__device__ __forceinline__ unsigned long long argmax_key(float x) {
  return isnan(x) ? ~0ull : (unsigned long long)__float_as_uint(fabsf(x)) + 1;
}
__device__ __forceinline__ unsigned long long argmax_key(double x) {
  return isnan(x) ? ~0ull
                  : (unsigned long long)__double_as_longlong(fabs(x)) + 1;
}

// the warp's best (key, index), in every lane: the largest key, and the
// lowest index among the lanes that hold it (index < 0 when none does)
__device__ __forceinline__ void warp_best(unsigned long long& key, int& i) {
  const unsigned full = 0xffffffffu;
  const unsigned hi = (unsigned)(key >> 32), lo = (unsigned)key;
  const unsigned top = __reduce_max_sync(full, hi);
  const unsigned low = __reduce_max_sync(full, hi == top ? lo : 0u);
  const bool best = hi == top && lo == low;
  const unsigned at = __reduce_min_sync(full, best ? (unsigned)i : ~0u);
  key = ((unsigned long long)top << 32) | low;
  i = key == 0 ? -1 : (int)at;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// the pivot row's entry x divided by the pivot, 0 for a zero pivot
template <typename T>
__device__ __forceinline__ T normalized(T x, T pv) {
  return pv == T(0) ? T(0) : repro::div_rn(x, pv);
}

struct Candidate {
  unsigned long long key;
  int i;
};

// candidate (key, at) <- (argmax_key(v), g) if that beats it
template <typename T>
__device__ __forceinline__ void keep(T v, int g, unsigned long long& key,
                                     int& at) {
  const unsigned long long k = argmax_key(v);
  if (k > key) {
    key = k;
    at = g;
  }
}

// One owned column of step j, its K rows: x[i] = y[i] - pc[i] * pr, with
// y the column before the step (src if kCopy, else x itself), y[j] = pr,
// and pc = 0 from row j up (so those rows subtract one product, 0 * pr:
// 0, -0 or NaN); row j + 1 is also the column's candidate for the next
// argmax if `live`.  Loads run kBatch rows ahead of the stores they might
// alias, and no row takes a branch.
template <bool kCopy, typename T, typename I>
__device__ __forceinline__ void update_rows(const T* src, T* x, I stride,
                                            const T* pc, T pr, int K, int j,
                                            bool live, int g,
                                            unsigned long long& key,
                                            int& at) {
  constexpr int kBatch = 4;
  auto y = [&](int i) { return kCopy ? src[i] : x[i * stride]; };
  const T z = repro::mul_rn(T(0), pr);
  int i = 0;
  for (; i + kBatch <= j; i += kBatch) {
    T v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) v[u] = y(i + u);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) x[(i + u) * stride] = repro::sub_rn(v[u], z);
  }
  for (; i < j; ++i) x[i * stride] = repro::sub_rn(y(i), z);
  x[j * stride] = repro::sub_rn(pr, z);
  if (j + 1 < K) {
    const T v = repro::sub_rn(y(j + 1), repro::mul_rn(pc[j + 1], pr));
    x[(j + 1) * stride] = v;
    if (live) keep(v, g, key, at);
  }
  for (i = j + 2; i + kBatch <= K; i += kBatch) {
    T v[kBatch], p[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      v[u] = y(i + u);
      p[u] = pc[i + u];
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      x[(i + u) * stride] = repro::sub_rn(v[u], repro::mul_rn(p[u], pr));
  }
  for (; i < K; ++i)
    x[i * stride] = repro::sub_rn(y(i), repro::mul_rn(pc[i], pr));
}

// kStack: a stack of more than one panel; else the kernel is the single
// panel's, without the loop over matrices (which cost 6 % at (32, 8192)
// f32 on an H100, tools/panel_route_time.py)
template <typename T, bool kShared, bool kStack>
__global__ void __launch_bounds__(kThreads, 1)
panel_factor_kernel(const T* __restrict__ panels, T* __restrict__ Rs,
                    long long* __restrict__ lss, T* __restrict__ sign_logdets,
                    int K, int n, int m0, long long r_pos, int cols,
                    long long batch) {
  // dynamic shared memory (kernels/panel_factor.py:smem_bytes): the copies
  // of columns l and last, the published columns by parity, the pivots,
  // the slice (kShared), ls
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_col = reinterpret_cast<T*>(smem);  // old column l: pc, pv at row j
  T* s_last = s_col + K;                  // old column last
  T* s_pub = s_last + K;                  // [2][K] this block's candidate's
  T* s_pub_last = s_pub + 2 * K;          // [2][K] column last, if owned
  T* s_pv = s_pub_last + 2 * K;           // the pivots, by step
  T* s_slice = s_pv + K;                  // K x cols
  int* s_ls = reinterpret_cast<int*>(s_slice + (kShared ? K * cols : 0));
  __shared__ Candidate s_cand[2];
  __shared__ unsigned long long s_wk[kThreads / 32];
  __shared__ int s_wi[kThreads / 32];
  __shared__ int s_l;

  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int blocks = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  const int threads = blockDim.x;  // a multiple of 32, at most kThreads
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int warps = threads / 32;
  const int last_warp = warps > 1 ? 1 : 0;  // copies column last
  const int c0 = rank * cols;
  const int width = min(cols, n - c0);  // >= 1: the plan covers [0, n)
  // a slice in shared memory is indexed in 32 bits
  using Index = typename std::conditional<kShared, int, long long>::type;
  const Index stride = kShared ? cols : n;
  // the cluster's matrices of a stack: blockIdx.y, then every gridDim.y-th
  // (every block of a cluster has the same blockIdx.y); the barrier ending
  // one matrix is passed before the next reuses the buffers
  for (long long b = kStack ? blockIdx.y : 0; b < (kStack ? batch : 1);
       b += kStack ? gridDim.y : 1) {
    const T* panel = panels + b * K * n;
    T* R = Rs + b * K * n;
    long long* ls = lss + b * K;
    T* sign_logdet = sign_logdets + 2 * b;
    T* slice = kShared ? s_slice : R + c0;

    for (int i = 0; i < K; ++i)
      for (int c = tid; c < width; c += threads)
        slice[i * stride + c] = panel[(long long)i * n + c0 + c];
    __syncthreads();

    // the argmax candidates of row 0
    unsigned long long key = 0;
    int at = -1;
    for (int c = tid; c < min(width, m0 - c0); c += threads)
      keep(slice[c], c0 + c, key, at);

    for (int j = 0; j < K; ++j) {
      const int m = m0 - j;
      const int last = m - 1;
      const int own_last = last / cols;
      const int par = j & 1;

      // 1. this block's candidate for row j; publish it and its column
      warp_best(key, at);
      if (lane == 0) {
        s_wk[warp] = key;
        s_wi[warp] = at;
      }
      __syncthreads();
      if (warp == 0) {
        key = lane < warps ? s_wk[lane] : 0ull;
        at = lane < warps ? s_wi[lane] : -1;
        warp_best(key, at);
        if (lane == 0) s_cand[par] = Candidate{key, at};
        if (at >= 0)
          for (int i = lane; i < K; i += 32)
            s_pub[par * K + i] = slice[i * stride + (at - c0)];
      }
      if (warp == last_warp && rank == own_last)
        for (int i = lane; i < K; i += 32)
          s_pub_last[par * K + i] = slice[i * stride + (last - c0)];

      // 2. every block's candidate and columns are published
      cluster_sync();

      // 3. the pivot column l and the copies of columns l and last
      if (warp == 0) {
        key = 0;
        at = -1;
        if (lane < blocks) {
          const Candidate* cand = cluster.map_shared_rank(s_cand + par, lane);
          key = cand->key;
          at = cand->i;
        }
        warp_best(key, at);
        const T* col = cluster.map_shared_rank(s_pub + par * K, at / cols);
        for (int i = lane; i < K; i += 32) s_col[i] = col[i];
        if (lane == 0) s_l = at;
      }
      if (warp == last_warp) {
        const T* col = cluster.map_shared_rank(s_pub_last + par * K, own_last);
        for (int i = lane; i < K; i += 32) s_last[i] = col[i];
      }
      __syncthreads();
      const int l = s_l;
      const T pv = s_col[j];
      if (rank == 0 && tid == 0) {
        s_ls[j] = l;
        s_pv[j] = pv;
      }

      // 4. normalize and update the owned columns, swapped (column last
      // takes the old column l, pr[last] = 1 or 0 for a zero pivot; column
      // l the old column last), and keep the candidates of row j + 1 among
      // the next step's live columns [0, last); a thread owns whole columns,
      // so it reads a column's pivot-row entry before rewriting it
      key = 0;
      at = -1;
      for (int c = tid; c < width; c += threads) {
        const int g = c0 + c;
        T* x = slice + c;
        if (g == last)
          update_rows<true>(s_col, x, stride, s_col, pv == T(0) ? T(0) : T(1),
                            K, j, false, g, key, at);
        else if (g == l)
          update_rows<true>(s_last, x, stride, s_col, normalized(s_last[j], pv),
                            K, j, g < last, g, key, at);
        else
          update_rows<false>(x, x, stride, s_col, normalized(x[j * stride], pv),
                             K, j, g < last, g, key, at);
      }
    }
    __syncthreads();

    if constexpr (kShared) {
      for (int i = 0; i < K; ++i)
        for (int c = tid; c < width; c += threads)
          R[(long long)i * n + c0 + c] = s_slice[i * cols + c];
    }
    if (rank == 0) {
      for (int j = tid; j < K; j += threads) ls[j] = s_ls[j];
      if (tid == 0) {
        // the sign (NaN for a NaN pivot, as ref.nan_sign) and log|det|,
        // accumulated in step order
        T sign = T(1);
        T logdet = T(0);
        for (int j = 0; j < K; ++j) {
          const T pv = s_pv[j];
          const int m = m0 - j;
          const T parity = (r_pos + m - 1) % 2 == 0 ? T(1) : T(-1);
          const T swap_sign = s_ls[j] == m - 1 ? T(1) : T(-1);
          const T sgn = isnan(pv) ? pv : T(T(0) < pv) - T(pv < T(0));
          sign = sign * sgn * swap_sign * parity;
          logdet = logdet + repro::log_(repro::abs_(pv));
        }
        sign_logdet[0] = sign;
        sign_logdet[1] = logdet;
      }
    }
    // no block leaves while another may still read its buffers: the last
    // reads (step 3 of step K - 1) end before the barrier below
    cluster_sync();
  }
}

// per device and kernel instance: the attributes set so far and the
// occupancy answers, so a launch costs host calls only the first time
struct LaunchState {
  bool nonportable = false;
  int smem_set = 0;
  std::map<std::pair<int, size_t>, int> clusters;  // (size, smem) -> count
};

// a host-side error is also the runtime's "last error": clear it, so the
// next kernel's launch check does not report it
int fail(cudaError_t e) {
  cudaGetLastError();
  return (int)e;
}

template <typename T, bool kShared, bool kStack>
int launch(const void* panel, void* r, void* ls, void* sign_logdet,
           long long batch, int k, int n, int m0, long long r_pos, int cluster,
           int cols, size_t smem, cudaStream_t stream) {
  static std::mutex mu;
  static std::map<int, LaunchState> states;
  const auto kernel = panel_factor_kernel<T, kShared, kStack>;

  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // one cluster per matrix of a stack, up to kMaxGridY clusters a launch
  cfg.gridDim = dim3(cluster, (unsigned)(batch < kMaxGridY ? batch : kMaxGridY), 1);
  // one thread per column of the slice, up to kThreads
  cfg.blockDim = dim3(std::min(kThreads, (cols + 31) / 32 * 32), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  {
    std::lock_guard<std::mutex> guard(mu);
    int device = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e != cudaSuccess) return fail(e);
    LaunchState& st = states[device];
    if (!st.nonportable) {
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return fail(e);
      st.nonportable = true;
    }
    if ((int)smem > st.smem_set) {
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return fail(e);
      st.smem_set = (int)smem;
    }
    const auto key = std::make_pair(cluster, smem);
    auto it = st.clusters.find(key);
    if (it == st.clusters.end()) {
      int count = 0;
      e = cudaOccupancyMaxActiveClusters(&count, (const void*)kernel, &cfg);
      if (e != cudaSuccess) return fail(e);
      it = st.clusters.emplace(key, count).first;
    }
    // the card cannot place one such cluster: refuse, never run garbage
    if (it->second < 1) return fail(cudaErrorInvalidConfiguration);
  }
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, (const T*)panel, (T*)r, (long long*)ls, (T*)sign_logdet,
      k, n, m0, r_pos, cols, batch);
  if (e != cudaSuccess) return fail(e);
  return (int)cudaGetLastError();
}

// the instance for the branch and whether a stack is launched
template <typename T>
int launch_for(bool shared, bool stack, const void* panel, void* r, void* ls,
               void* sign_logdet, long long batch, int K, int N, int M0,
               long long r_pos, int C, int W, size_t smem, cudaStream_t s) {
  if (shared)
    return stack ? launch<T, true, true>(panel, r, ls, sign_logdet, batch, K,
                                         N, M0, r_pos, C, W, smem, s)
                 : launch<T, true, false>(panel, r, ls, sign_logdet, batch, K,
                                          N, M0, r_pos, C, W, smem, s);
  return stack ? launch<T, false, true>(panel, r, ls, sign_logdet, batch, K, N,
                                        M0, r_pos, C, W, smem, s)
               : launch<T, false, false>(panel, r, ls, sign_logdet, batch, K,
                                         N, M0, r_pos, C, W, smem, s);
}

}  // namespace

extern "C" int repro_panel_factor(int dtype, const void* panel, void* r,
                                  void* ls, void* sign_logdet, long long batch,
                                  long long k, long long n, long long m0,
                                  long long r_pos, long long cluster,
                                  long long cols, long long shared,
                                  long long smem_bytes, void* stream) {
  if (batch <= 0) return 0;
  if (k <= 0 || k > kMaxRows || m0 < k || m0 > n || n > INT_MAX)
    return (int)cudaErrorInvalidValue;
  // the plan's slices must cover [0, n) exactly once, none empty
  if (cluster < 1 || cluster > kMaxCluster || cols < 1 ||
      (cluster - 1) * cols >= n || cluster * cols < n)
    return (int)cudaErrorInvalidValue;
  if (dtype != REPRO_F32 && dtype != REPRO_F64) return (int)cudaErrorInvalidValue;
  const size_t size = dtype == REPRO_F32 ? sizeof(float) : sizeof(double);
  const size_t smem = (size_t)(7 * k + (shared ? k * cols : 0)) * size +
                      (size_t)k * sizeof(int);
  if ((long long)smem != smem_bytes) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int K = (int)k, N = (int)n, M0 = (int)m0, C = (int)cluster,
            W = (int)cols;
  if (dtype == REPRO_F32)
    return launch_for<float>(shared != 0, batch > 1, panel, r, ls, sign_logdet,
                             batch, K, N, M0, r_pos, C, W, smem, s);
  return launch_for<double>(shared != 0, batch > 1, panel, r, ls, sign_logdet,
                            batch, K, N, M0, r_pos, C, W, smem, s);
}
