// Deterministic index-add: the backward of a row gather.
//
// Not a port of a TPU kernel: the JAX package gathers outside Pallas and
// XLA adds the gradient rows back in a fixed order. torch.gather's backward
// on the card adds them with atomics in no fixed order, so a training step
// was not bitwise reproducible. This kernel is its repair.
//
// out[b, r, c] = sum of src[b, p, c] over the positions p with idx[b, p] ==
// r, in ascending p, starting from +0.0, each add rounded to nearest
// (__fadd_rn): bitwise the plain PyTorch version and the CPU's
// scatter_add, which add in the same order. Indices outside [0, n) add
// nothing.
//
// One launch a call and no sort before it: the kernel sorts. A CTA owns
// `bins` output rows [r0, r0 + bins) of one batch row and `tile_c` of its
// channels, their running sums in shared memory. It reads the batch row's
// indices in ascending order, a step of kStep positions at a time (8
// indices a lane, two 16-byte loads where the row allows, the next step's
// loads in flight during this one), and appends the positions that land
// in its rows to a list in shared memory, in ascending order (a warp
// prefix over the lanes' counts, the warps' counts shared through one
// barrier a step). When the next step might not fit the list's kList
// entries, or at the row's end, it runs a stable counting sort of the list
// by row and adds:
//   1. the list's parts of kPart entries, one a warp, were counted per row
//      as they were appended (shared-memory atomics: a count does not
//      depend on order); an exclusive scan over (row, part) gives each
//      part its first slot in each row's sorted list;
//   2. each warp places its part: __match_any_sync ranks equal rows among
//      32 entries and a (row, part) cursor private to the warp moves on,
//      so each row's list ascends whatever the warps' timing;
//   3. the sorted lists' source rows are staged into shared memory by the
//      whole CTA (cp.async, 16 bytes a copy where C % 4 == 0, else 4), as
//      many at a time as the list's buffer holds; then groups of lanes (a
//      lane a channel, or a 4-channel chunk; up to a warp a group) each
//      walk the staged terms of consecutive rows, adding each to its
//      row's sum.
// The lists go in ascending order and the sums carry over, so every output
// element adds its terms in ascending position from +0.0. The CTA then
// writes all of its tile, empty rows too: the wrapper launches nothing
// else (no zero fill).
//
// The plan (bins, tile_c) is the wrapper's (ops/grouping.py
// index_add_plan), and one route serves every shape: n is tiled over CTAs
// (`bins` rows each, at most kMaxBins), C over CTAs (`tile_c` channels
// each, when a tile of all C would not fit kAccFloats sums) and M over
// lists (at most kList kept positions a sort; a CTA whose rows take few of
// the positions sorts once for many steps).
//
// What bounds it: bytes. Every source element is read once (a CTA reads
// only its rows' terms) and every output element written once. Each CTA
// also reads its batch row's whole index row from L2: (row tiles x channel
// tiles) x M x 4 bytes a batch row. The plan narrows the row tiles toward
// a target of CTAs only while that stays within the source's M x C x 4
// bytes; wide tiles set it otherwise (a scene of 65536 rows at C 128 is
// 1024 row tiles of 64 rows, 32 times the source's bytes). Terms crowded
// onto few indices (the chamfer's padded GT rows put all 256 terms of a
// row on one index) make a chain of dependent adds: staging makes each
// link a shared-memory read, with every source load of the chunk in
// flight at once, where a walk loading each term from device memory waits
// a round trip every few terms.

#include "common.cuh"

// the kernels live in gspn:: (their names carry it, so that a sanitizer or
// profiler can pick them out); the C entry points below use them unqualified
using namespace gspn;

namespace gspn {
namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kLanePositions = 8;           // indices a lane reads a step
constexpr int kTrip = 32 * kLanePositions;  // positions a warp reads a step
constexpr int kStep = kWarps * kTrip;       // positions a step
constexpr int kList = 8192;                 // kept positions a sort at most
constexpr int kPart = kList / kWarps;       // list entries a warp places
constexpr int kMaxBins = 256;               // output rows a CTA
constexpr int kAccFloats = 8192;            // a CTA's running sums (32 KB)
constexpr int kStageWords = kList;          // staged floats (and the list)
constexpr int kOffsetBits = 23;             // a kept position past the list's base
constexpr int kUnroll = 8;                  // staged terms read ahead a lane
static_assert(kMaxBins <= (1 << (31 - kOffsetBits)), "row and offset share a word");
static_assert(kList >= kStep, "a step fits an empty list");

template <int V>
struct Vec {
  using T = float;
};
template <>
struct Vec<4> {
  using T = float4;
};

// one cp.async of a term's V floats into shared memory
template <int V>
__device__ __forceinline__ void stage_copy(void* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
                 : "memory");
}

__device__ __forceinline__ float vadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// a lane's kLanePositions indices from p0 (-1 past m)
__device__ __forceinline__ void load_indices(const int* irow, long long p0,
                                             long long m, int vec_idx,
                                             int (&v)[kLanePositions]) {
  if (vec_idx && p0 + kLanePositions <= m) {
#pragma unroll
    for (int q = 0; q < kLanePositions; q += 4) {
      const int4 a = *reinterpret_cast<const int4*>(irow + p0 + q);
      v[q] = a.x, v[q + 1] = a.y, v[q + 2] = a.z, v[q + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int s = 0; s < kLanePositions; ++s) v[s] = p0 + s < m ? irow[p0 + s] : -1;
  }
}

// grid: (row tiles of `bins`, B, channel tiles of `tile_c`). Dynamic shared
// memory, in 4-byte words: the sums (bins x tile_c), the (row, part)
// cursors (bins x kWarps), the list of kept positions and then the staged
// terms (kStageWords), the sorted list (kList), the rows' list starts
// (bins + 1). V: floats a copy (4 needs C % 4 == 0, tile_c % 4 == 0 and a
// 16-byte aligned src). vec_idx: the index rows allow 16-byte loads
// (M % 4 == 0, idx 16-byte aligned).
template <int V>
__global__ void __launch_bounds__(kThreads, 2)
    index_add_kernel(const float* __restrict__ src,
                     const int* __restrict__ idx, int m, int n, int c,
                     int bins, int tile_c, int vec_idx,
                     float* __restrict__ out) {
  using T = typename Vec<V>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int step_count[2][kWarps];  // a step's kept positions a warp
  __shared__ int scan_total[kWarps];

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * bins;
  const int nr = min(bins, n - r0);  // this CTA's output rows
  const int r1 = r0 + nr;
  const int c0 = blockIdx.z * tile_c;
  const int ct = min(tile_c, c - c0);  // and channels
  const int chunks = ct / V;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;

  T* acc = reinterpret_cast<T*>(smem);  // [nr][chunks]
  int* cur = reinterpret_cast<int*>(smem + sizeof(float) * bins * tile_c);
  int* list = cur + bins * kWarps;  // (row << kOffsetBits) | position - base
  T* stage = reinterpret_cast<T*>(list);  // once the list is sorted
  int* sorted = list + kStageWords;  // [kList]: positions - base, by row
  int* start = sorted + kList;       // [nr + 1]
  const int stage_terms = kStageWords / ct;  // terms staged at a time

  for (int i = threadIdx.x; i < nr * chunks; i += kThreads) acc[i] = T{};
  for (int i = threadIdx.x; i < nr * kWarps; i += kThreads) cur[i] = 0;

  // a group of `width` lanes a run of consecutive rows, a lane a chunk
  int width = 1;
  while (width < chunks && width < 32) width <<= 1;
  const int groups = kThreads / width;
  const int per_group = (nr + groups - 1) / groups;
  const int g_lo = min(static_cast<int>(threadIdx.x) / width * per_group, nr);
  const int g_hi = min(g_lo + per_group, nr);

  const int* irow = idx + static_cast<size_t>(b) * m;
  const float* srow = src + static_cast<size_t>(b) * m * c + c0;

  // A stable counting sort of the list's `total` positions (ascending, from
  // `base`) by row, then each group adds its rows' terms in list order. The
  // list's part p (entries [p * kPart, (p + 1) * kPart)) is warp p's to
  // place; cur[row * kWarps + p] holds the part's entries in each row,
  // counted as they were appended (a count does not depend on order).
  auto sort_and_add = [&](int total, long long base) {
    __syncthreads();  // the list and its counts are whole
    const int active = (total + kPart - 1) / kPart;  // the parts
    auto at = [&](int e) -> int& { return cur[e / active * kWarps + e % active]; };

    // 1. exclusive scan of the counts in (row, part) order: each part's
    // first slot in each row's sorted list, and each row's list start
    const int entries = nr * active;
    const int per = (entries + kThreads - 1) / kThreads;
    const int e0 = min(static_cast<int>(threadIdx.x) * per, entries);
    const int e1 = min(e0 + per, entries);
    int sum = 0;
    for (int e = e0; e < e1; ++e) sum += at(e);
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(gspn::kFullMask, incl, off);
      if (lane >= off) incl += o;
    }
    if (lane == 31) scan_total[warp] = incl;
    __syncthreads();
    int run = incl - sum;
    for (int w = 0; w < warp; ++w) run += scan_total[w];
    for (int e = e0; e < e1; ++e) {
      const int h = at(e);
      if (e % active == 0) start[e / active] = run;
      at(e) = run;
      run += h;
    }
    if (threadIdx.x == kThreads - 1) start[nr] = total;
    __syncthreads();

    // 2. each warp places its part, in order, at its cursors
    const int lo = min(warp * kPart, total);
    const int hi = min(lo + kPart, total);
    for (int i0 = lo; i0 < hi; i0 += 32) {
      const int i = i0 + lane;
      const int e = i < hi ? list[i] : -1;
      const int row = e >> kOffsetBits;  // -1 past the part
      const unsigned peers = __match_any_sync(gspn::kFullMask, row);
      const int rank = __popc(peers & below);
      if (i < hi) sorted[cur[row * kWarps + warp] + rank] = e & ((1 << kOffsetBits) - 1);
      __syncwarp();
      if (i < hi && rank == 0) cur[row * kWarps + warp] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    // the next list's counts start from 0 (the staging's barriers order
    // this before its first append)
    for (int i = threadIdx.x; i < nr * kWarps; i += kThreads) cur[i] = 0;

    // 3. stage the lists' source rows, as many as fit, and each group adds
    // its rows' staged terms in list order
    const float* bsrc = srow + static_cast<size_t>(base) * c;
    for (int s0 = 0; s0 < total; s0 += stage_terms) {
      const int s1 = min(total, s0 + stage_terms);
      for (int i = threadIdx.x; i < (s1 - s0) * chunks; i += kThreads) {
        const int t = i / chunks;
        stage_copy<V>(stage + i, bsrc + static_cast<size_t>(sorted[s0 + t]) * c +
                                     (i - t * chunks) * V);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
      for (int k = static_cast<int>(threadIdx.x) % width; k < chunks; k += width) {
        for (int row = g_lo; row < g_hi; ++row) {
          const int q0 = max(start[row], s0);
          const int q1 = min(start[row + 1], s1);
          if (q0 >= q1) continue;
          const T* x = stage + (q0 - s0) * chunks + k;
          T a = acc[row * chunks + k];
          int q = q0;
          for (; q + kUnroll <= q1; q += kUnroll, x += kUnroll * chunks) {
            T t[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) t[u] = x[u * chunks];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) a = vadd(a, t[u]);
          }
          for (; q < q1; ++q, x += chunks) a = vadd(a, *x);
          acc[row * chunks + k] = a;
        }
      }
      __syncthreads();  // the stage is read before the next chunk lands
    }
  };

  // Scan the index row a step of kStep positions at a time (the next step's
  // indices in flight meanwhile), appending the positions in this CTA's
  // rows to the list in ascending order; sort and add once the next step
  // might not fit.
  int total = 0;       // kept positions in the list (the same in every thread)
  long long base = 0;  // the list's first step
  int v[kLanePositions];
  const long long lane_p = static_cast<long long>(warp) * kTrip + kLanePositions * lane;
  load_indices(irow, lane_p, m, vec_idx, v);
  int parity = 0;
  for (long long w0 = 0; w0 < m; w0 += kStep, parity ^= 1) {
    int nv[kLanePositions];
    if (w0 + kStep < m)
      load_indices(irow, w0 + kStep + lane_p, m, vec_idx, nv);
    else
#pragma unroll
      for (int s = 0; s < kLanePositions; ++s) nv[s] = -1;
    const long long end = min(w0 + kStep, static_cast<long long>(m));
    if (total > 0 && (total + (end - w0) > kList || end - base > (1LL << kOffsetBits))) {
      sort_and_add(total, base);
      total = 0;
    }
    if (total == 0) base = w0;

    int k = 0;
#pragma unroll
    for (int s = 0; s < kLanePositions; ++s) k += v[s] >= r0 && v[s] < r1;
    int incl = k;  // inclusive prefix of the lanes' counts
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(gspn::kFullMask, incl, off);
      if (lane >= off) incl += o;
    }
    if (lane == 31) step_count[parity][warp] = incl;
    // one barrier a step: step_count[parity] is written again two steps on
    __syncthreads();
    int o = total + incl - k;
    int step_total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int t = step_count[parity][w];
      if (w < warp) o += t;
      step_total += t;
    }
    if (k) {
      const long long p0 = w0 + lane_p - base;
#pragma unroll
      for (int s = 0; s < kLanePositions; ++s)
        if (v[s] >= r0 && v[s] < r1) {
          atomicAdd(&cur[(v[s] - r0) * kWarps + o / kPart], 1);
          list[o++] = ((v[s] - r0) << kOffsetBits) | static_cast<int>(p0 + s);
        }
    }
    total += step_total;
#pragma unroll
    for (int s = 0; s < kLanePositions; ++s) v[s] = nv[s];
  }
  if (total > 0) sort_and_add(total, base);
  __syncthreads();  // every sum is in (none were added when no row had a term)

  // every element of the tile, rows without terms too
  float* orow = out + (static_cast<size_t>(b) * n + r0) * c + c0;
  const float* sums = reinterpret_cast<const float*>(acc);
  for (int i = threadIdx.x; i < nr * ct; i += kThreads) {
    const int row = i / ct;
    orow[static_cast<size_t>(row) * c + (i - row * ct)] = sums[i];
  }
}

// the most dynamic shared memory a plan takes
constexpr size_t kMaxSmemBytes =
    sizeof(int) * (kAccFloats + kMaxBins * kWarps + kStageWords + kList +
                   kMaxBins + 1);

template <int V>
int launch(const float* src, const int* idx, int nb, int m, int n, int c,
           int bins, int tile_c, int vec_idx, float* out,
           dim3 grid, size_t smem, cudaStream_t stream) {
  // the attribute is set once a device (a launch is on the host's hot path)
  static int set_on = -1;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess && device != set_on) {
    e = cudaFuncSetAttribute(index_add_kernel<V>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxSmemBytes));
    if (e == cudaSuccess) set_on = device;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  index_add_kernel<V><<<grid, kThreads, smem, stream>>>(
      src, idx, m, n, c, bins, tile_c, vec_idx, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace gspn

// bins (output rows a CTA, 1..kMaxBins) and tile_c (channels a CTA, with
// bins * tile_c <= kAccFloats): ops/grouping.py index_add_plan.
extern "C" int gspn_index_add(const float* src, const int* idx, int nb, int m,
                              int n, int c, int bins, int tile_c, float* out,
                              cudaStream_t stream) {
  if (nb < 0 || m < 0 || n < 0 || c < 0 || nb > 65535 || bins < 1 ||
      bins > kMaxBins || tile_c < 1 || tile_c > kAccFloats ||
      bins * tile_c > kAccFloats)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0 || n == 0 || c == 0) return 0;
  const long long row_tiles = (static_cast<long long>(n) + bins - 1) / bins;
  const long long channel_tiles = (static_cast<long long>(c) + tile_c - 1) / tile_c;
  if (row_tiles > 0x7fffffffLL || channel_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(row_tiles), static_cast<unsigned>(nb),
                  static_cast<unsigned>(channel_tiles));
  const size_t smem =
      sizeof(int) * (static_cast<size_t>(bins) * tile_c + bins * kWarps +
                     kStageWords + kList + bins + 1);
  const int vec_idx =
      m % 4 == 0 && reinterpret_cast<uintptr_t>(idx) % 16 == 0;
  if (c % 4 == 0 && tile_c % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0)
    return launch<4>(src, idx, nb, m, n, c, bins, tile_c, vec_idx, out,
                     grid, smem, stream);
  return launch<1>(src, idx, nb, m, n, c, bins, tile_c, vec_idx, out,
                   grid, smem, stream);
}
