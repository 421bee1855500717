// First-K grouping over a scene staged through shared memory, shared by the
// first-K ball group (ball_group.cu), the first-K ball query (ball_query.cu)
// and the first-S box group (box_group.cu); its predicates, scene staging
// (SceneTiles, for_each_tile) and padding (write_padding) also serve the
// strided groups and the strided ball query (group_strided.cuh), and its
// GroupOut is every grouping kernel's output record. kCoords (a template
// argument, so part of the kernel's symbol) says whether a hit writes its
// local coordinates (the groups) or only its index and the count (the ball
// query: group_first_kernel<Ball<n>, false>). A predicate type says what a
// hit is and where the local frame's origin lies:
//   Ball<kScales>: up to kMaxScales concentric balls about a centre (query
//     (B, M, 3)), hit in scale s when d2 < r2[s] strictly, d2 by
//     gspn::sqdist in the plain order, one distance for every scale;
//   Box: an axis-aligned box (query (B, M, 6) [lo, hi]), hit when
//     lo <= p <= hi on every axis (inclusive), origin (lo + hi) * 0.5.
//
// group_first_kernel. What bounds it: the point tests. A query whose ball
// or box holds fewer than K points tests its whole scene, and every query
// of a scene tests the same points. So:
//   - A CTA holds queries of one scene only and stages that scene through
//     shared memory in tiles of kTile points, double-buffered: cp.async
//     16-byte copies of the raw (x, y, z) floats and validity bytes for
//     tile t+1 are in flight while tile t is scanned. Each tile is then
//     turned once into float4 points whose x is NaN where the point is
//     invalid (d2 < r2 and lo <= x are then false: the validity test is
//     folded into the predicate). A point comes from L2 once per CTA, not
//     once per query, and a test is one 16-byte shared load.
//   - Each lane tests kGroups points a step (base + l, base + 32 + l, ...):
//     the loads and tests are independent; the groups are then ranked one
//     after another with a ballot each, so ranks ascend with the index.
//   - When queries are few (the GSPN crops and the RoI boxes: 8 x 64 a
//     request), `split` warps share one query: within a tile warp w takes
//     the contiguous w-th of kTile / split points, counts its hits per
//     scale (keeping each group's ballot in shared memory), an exclusive
//     prefix over the query's warps gives each warp its first rank, and
//     each warp writes only the ranks below K. Slots are exactly the
//     serial first-come scan's.
//   - The CTA stops loading tiles once every query it holds has filled
//     every scale (the reference's early exit).
// The contract is the reference's: local = p - origin with __fsub_rn,
// padding repeats the first hit (kept in shared memory when it is found),
// an empty row takes index 0 and point 0 minus the origin, cnt capped at K;
// without kCoords the same indices and counts.
//
// The split rule (group_first_split), measured on an H100 by timing every
// split at the ball group's main-path shapes (chip_smoke.py's split sweep,
// through gspn_ball_group's `split` argument; PERF.md section 6): no split
// for a scene under one tile (SA2-SA4: a split only adds passes and
// barriers to a short scan); else double the warps a query while the
// launch stays within kTargetWarps (about the 32 warps an SM holds at this
// kernel's registers) and each warp keeps kMinWarpPoints of the scene.
// That picks 1 for SA1, 8 for the crops and the boxes (8 x 64 over 8192)
// and the training crops (4 x 64 over 4096), 4 for the whole scene's SA1
// and 16 for its crops and boxes (1 x 64 over 65536).

#pragma once

#include <type_traits>

#include "common.cuh"

namespace gspn {

constexpr int kMaxScales = 4;

// The grouping kernels' outputs, per scale.
struct GroupOut {
  int nscales;
  int k[kMaxScales];
  float r2[kMaxScales];
  int* idx[kMaxScales];      // (B, M, k) int32
  int* cnt[kMaxScales];      // (B, M) int32, capped at k
  float* local[kMaxScales];  // (B, M, k, 3) f32; null for the ball query
};

// GroupOut for the ball scans from the C entry points' per-scale arrays
// (local null for the ball query).
inline int ball_group_out(int nscales, const float* r2s, const int* ks,
                          int* const* idx, int* const* cnt,
                          float* const* local, GroupOut* out) {
  if (nscales < 1 || nscales > kMaxScales)
    return static_cast<int>(cudaErrorInvalidValue);
  *out = GroupOut{};
  out->nscales = nscales;
  for (int s = 0; s < nscales; ++s) {
    out->k[s] = ks[s];
    out->r2[s] = r2s[s];
    out->idx[s] = idx[s];
    out->cnt[s] = cnt[s];
    out->local[s] = local ? local[s] : nullptr;
  }
  return 0;
}

// f(std::integral_constant<int, nscales>{}): an entry point's scale count
// as a template argument (1..kMaxScales).
template <class F>
int with_scales(int nscales, F&& f) {
  switch (nscales) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

constexpr int kTile = 2048;        // points a tile
constexpr int kCtaWarps = 16;      // warps a CTA: (16 / split) queries
constexpr int kDirectWarps = 4;    // warps a CTA of one-step scenes
constexpr int kGroups = 4;         // 32-point groups a lane tests a step
constexpr int kMaxSplit = 16;      // warps a query
constexpr int kTargetWarps = 4096; // ~32 resident warps on each of 132 SMs
constexpr int kMinWarpPoints = 512; // a split warp's share of the scene
constexpr int kTileGroups = kTile / 32;

// dynamic shared memory, in this order: the staged scene (SceneTiles),
// then each kernel's own
constexpr size_t kRawXyzBytes = 2 * kTile * 3 * sizeof(float);
constexpr size_t kRawValidBytes = 2 * kTile;
constexpr size_t kPointBytes = kTile * sizeof(float4);
constexpr size_t kStagingBytes = kRawXyzBytes + kRawValidBytes + kPointBytes;
constexpr size_t kBallotBytes =
    (kCtaWarps / 2) * kMaxScales * kTileGroups * sizeof(unsigned);
constexpr size_t kWarpCountBytes = kCtaWarps * kMaxScales * sizeof(int);
constexpr size_t kGroupFirstSmemBytes =
    kStagingBytes + kBallotBytes + kWarpCountBytes;

// kScales concentric balls about a centre; one distance for every scale.
template <int kScales_>
struct Ball {
  static constexpr int kScales = kScales_;
  static constexpr int kQueryFloats = 3;
  float ox = 0.f, oy = 0.f, oz = 0.f;  // centre: the local frame's origin

  __device__ __forceinline__ void load(const float* q) {
    ox = q[0];
    oy = q[1];
    oz = q[2];
  }
  __device__ __forceinline__ void test(float4 p, const GroupOut& out,
                                       bool (&hit)[kScales]) const {
    const float d2 = sqdist(ox, oy, oz, p.x, p.y, p.z);
#pragma unroll
    for (int s = 0; s < kScales; ++s) hit[s] = d2 < out.r2[s];
  }
};

// An axis-aligned box [lo, hi], inclusive, one scale.
struct Box {
  static constexpr int kScales = 1;
  static constexpr int kQueryFloats = 6;
  float lx = 0.f, ly = 0.f, lz = 0.f, hx = 0.f, hy = 0.f, hz = 0.f;
  float ox = 0.f, oy = 0.f, oz = 0.f;  // (lo + hi) * 0.5, as the plain version

  __device__ __forceinline__ void load(const float* q) {
    lx = q[0];
    ly = q[1];
    lz = q[2];
    hx = q[3];
    hy = q[4];
    hz = q[5];
    ox = __fmul_rn(__fadd_rn(lx, hx), 0.5f);
    oy = __fmul_rn(__fadd_rn(ly, hy), 0.5f);
    oz = __fmul_rn(__fadd_rn(lz, hz), 0.5f);
  }
  __device__ __forceinline__ void test(float4 p, const GroupOut&,
                                       bool (&hit)[1]) const {
    hit[0] = lx <= p.x && p.x <= hx && ly <= p.y && p.y <= hy && lz <= p.z &&
             p.z <= hz;
  }
};

// A query's first hit in one scale: what its padding repeats.
struct FirstHit {
  int idx;
  float x, y, z;  // local coordinates
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Write a hit of rank `slot` < K: its index and, with kCoords, its local
// coordinates (rank 0 also to the query's FirstHit record `first`).
template <bool kCoords>
__device__ __forceinline__ void put_hit(const GroupOut& out, int s, int q,
                                        int slot, int j, float4 p, float ox,
                                        float oy, float oz, FirstHit* first) {
  const size_t o = static_cast<size_t>(q) * out.k[s] + slot;
  out.idx[s][o] = j;
  if constexpr (kCoords) {
    const FirstHit h{j, __fsub_rn(p.x, ox), __fsub_rn(p.y, oy),
                     __fsub_rn(p.z, oz)};
    out.local[s][3 * o] = h.x;
    out.local[s][3 * o + 1] = h.y;
    out.local[s][3 * o + 2] = h.z;
    if (slot == 0) first[s] = h;
  } else {
    if (slot == 0) first[s].idx = j;
  }
}

template <int kScales>
__device__ __forceinline__ bool all_full(const int* cnt, const GroupOut& out) {
  bool full = true;
#pragma unroll
  for (int s = 0; s < kScales; ++s)
    if (cnt[s] < out.k[s]) full = false;
  return full;
}

// A scene staged through shared memory tile by tile: the raw (x, y, z)
// floats and validity bytes of tile t+1 copied (cp.async where `async`,
// else plain loads) while tile t is read, each tile turned once into float4
// points whose x is NaN where the point is invalid, NaN points padding it
// to whole steps (32 * kGroups points), so scans load unguarded.
struct SceneTiles {
  float* raw_xyz;      // two buffers of kTile rows
  uint8_t* raw_valid;  // two buffers of kTile bytes
  float4* pts4;        // the current tile
  const float* pts;    // the scene in device memory
  const uint8_t* v;    // its validity, or null
  int n;
  int async;  // rows 16-byte aligned for cp.async

  __device__ SceneTiles(unsigned char* smem, const float* pts_,
                        const uint8_t* v_, int n_, int async_)
      : raw_xyz(reinterpret_cast<float*>(smem)),
        raw_valid(smem + kRawXyzBytes),
        pts4(reinterpret_cast<float4*>(smem + kRawXyzBytes + kRawValidBytes)),
        pts(pts_),
        v(v_),
        n(n_),
        async(async_) {}

  // issue the copies of the tile at t0 into buffer buf
  __device__ __forceinline__ void stage(int buf, int t0) const {
    const int tn = min(kTile, n - t0);
    float* dx = raw_xyz + buf * kTile * 3;
    uint8_t* dv = raw_valid + buf * kTile;
    if (async) {  // tn * 3 and (with validity) tn are multiples of 16 B
      for (int c = threadIdx.x; c < tn * 3 / 4; c += blockDim.x)
        cp_async16(dx + 4 * c, pts + 3 * static_cast<size_t>(t0) + 4 * c);
      if (v)
        for (int c = threadIdx.x; c < tn / 16; c += blockDim.x)
          cp_async16(dv + 16 * c, v + t0 + 16 * c);
    } else {
      for (int i = threadIdx.x; i < tn * 3; i += blockDim.x)
        dx[i] = pts[3 * static_cast<size_t>(t0) + i];
      if (v)
        for (int i = threadIdx.x; i < tn; i += blockDim.x) dv[i] = v[t0 + i];
    }
  }

  // buffer buf, a tile of tn points, as float4 points in pts4
  __device__ __forceinline__ void convert(int buf, int tn) const {
    constexpr int kStep = 32 * kGroups;
    const int tn_pad = (tn + kStep - 1) / kStep * kStep;
    for (int i = threadIdx.x; i < tn_pad; i += blockDim.x) {
      const float* r = raw_xyz + buf * kTile * 3 + 3 * i;
      const bool ok =
          i < tn && (v == nullptr || raw_valid[buf * kTile + i] != 0);
      pts4[i] = i < tn ? make_float4(ok ? r[0] : CUDART_NAN_F, r[1], r[2], 0.f)
                       : make_float4(CUDART_NAN_F, 0.f, 0.f, 0.f);
    }
  }
};

// Every thread of the CTA calls it: the scene's tiles in order, each in
// pts4 while scan(t0, tn) reads it (tile t+1's copies in flight); stops
// after the first tile for which every thread's scan returned true.
template <class Scan>
__device__ __forceinline__ void for_each_tile(const SceneTiles& st,
                                              Scan&& scan) {
  const int ntiles = (st.n + kTile - 1) / kTile;
  st.stage(0, 0);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    const int t0 = t * kTile;
    const int tn = min(kTile, st.n - t0);
    if (t + 1 < ntiles) st.stage(buf ^ 1, t0 + kTile);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of tile t have landed
    __syncthreads();     // everyone's have
    st.convert(buf, tn);
    __syncthreads();
    // the barrier also keeps tile t's buffers until every warp is past them
    if (__syncthreads_and(scan(t0, tn))) break;
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The tail of a query's row in each scale: slots from min(hits, K) on
// repeat the first hit (first[s], recorded by put_hit); an empty row takes
// index 0 and point 0 minus the origin (coordinates with kCoords only).
// The query's `split` warps share the slots; its part 0 writes the capped
// count.
template <int kScales, bool kCoords>
__device__ __forceinline__ void write_padding(const GroupOut& out, int q,
                                              const int* hits,
                                              const FirstHit* first,
                                              const float* pts, float ox,
                                              float oy, float oz, int part,
                                              int split, int lane) {
#pragma unroll
  for (int s = 0; s < kScales; ++s) {
    const int k = out.k[s];
    const int c = hits[s] < k ? hits[s] : k;
    const size_t o0 = static_cast<size_t>(q) * k;
    const int fill = c > 0 ? first[s].idx : 0;
    float fx = 0.f, fy = 0.f, fz = 0.f;
    if constexpr (kCoords) {
      if (c > 0) {
        fx = first[s].x;
        fy = first[s].y;
        fz = first[s].z;
      } else {
        fx = __fsub_rn(pts[0], ox);
        fy = __fsub_rn(pts[1], oy);
        fz = __fsub_rn(pts[2], oz);
      }
    }
    for (int slot = c + part * 32 + lane; slot < k; slot += 32 * split) {
      const size_t o = o0 + slot;
      out.idx[s][o] = fill;
      if constexpr (kCoords) {
        out.local[s][3 * o] = fx;
        out.local[s][3 * o + 1] = fy;
        out.local[s][3 * o + 2] = fz;
      }
    }
    if (part == 0 && lane == 0) out.cnt[s][q] = c;
  }
}

// grid: nb * ctas_per_scene CTAs of kCtaWarps warps (kDirectWarps when
// `direct`); CTA c serves scene c / ctas_per_scene, queries from
// (c % ctas_per_scene) * (warps / split), `split` warps each. `async`: the
// scene's rows are 16-byte aligned for cp.async (else the tile is staged by
// plain loads). `direct`: a scene of one step, tested from device memory
// (no dynamic shared memory). Pred::kScales: out.nscales. kCoords: write
// the local coordinates too (out.local), else only idx and cnt.
template <class Pred, bool kCoords>
__global__ void __launch_bounds__(kCtaWarps * 32)
    group_first_kernel(const float* __restrict__ xyz,
                       const uint8_t* __restrict__ valid,
                       const float* __restrict__ query, int n, int m,
                       int split, int ctas_per_scene, int async, int direct,
                       GroupOut out) {
  constexpr int kScales = Pred::kScales;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* ballots = reinterpret_cast<unsigned*>(smem + kStagingBytes);
  int* warp_cnt =
      reinterpret_cast<int*>(smem + kStagingBytes + kBallotBytes);
  __shared__ FirstHit first_hits[kCtaWarps * kMaxScales];

  const int b = blockIdx.x / ctas_per_scene;
  const int qpc = (blockDim.x >> 5) / split;  // queries a CTA
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slot_q = warp / split;  // the CTA's query slot of this warp
  const int part = warp % split;    // this warp's share of its query
  const int qm = (blockIdx.x % ctas_per_scene) * qpc + slot_q;
  const bool has_q = qm < m;
  const int q = b * m + qm;
  const float* pts = xyz + static_cast<size_t>(b) * n * 3;
  const uint8_t* v = valid ? valid + static_cast<size_t>(b) * n : nullptr;
  const unsigned below = (1u << lane) - 1u;
  const int range = kTile / split;  // points of a tile a warp ranks
  FirstHit* first = first_hits + slot_q * kMaxScales;

  Pred pred;
  if (has_q) pred.load(query + static_cast<size_t>(q) * Pred::kQueryFloats);
  const float ox = pred.ox, oy = pred.oy, oz = pred.oz;
  int cnt[kMaxScales];
#pragma unroll
  for (int s = 0; s < kMaxScales; ++s) cnt[s] = 0;
  bool done = !has_q;

  // one warp a query: test kGroups points a lane (j0 + 32 g + lane, NaN x
  // where invalid or past the scene) and rank every hit as it is found
  auto first_k_step = [&](const float4* p, int j0) {
    unsigned bal[kGroups][kScales];
    unsigned any = 0;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      bool hit[kScales];
      pred.test(p[g], out, hit);
#pragma unroll
      for (int s = 0; s < kScales; ++s) {
        bal[g][s] = __ballot_sync(kFullMask, hit[s]);
        any |= bal[g][s];
      }
    }
    if (any == 0) return;  // most steps of a sparse ball or box
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
#pragma unroll
      for (int s = 0; s < kScales; ++s) {
        const unsigned bs = bal[g][s];
        const int rank = cnt[s] + __popc(bs & below);
        if (((bs >> lane) & 1u) && rank < out.k[s])
          put_hit<kCoords>(out, s, q, rank, j0 + 32 * g + lane, p[g], ox,
                           oy, oz, first);
        cnt[s] += __popc(bs);
      }
    }
    done = all_full<kScales>(cnt, out);
  };

  if (direct) {
    // a scene of one step (SA4): tested straight from device memory, no
    // staging or barrier
    if (!done) {
      float4 p[kGroups];
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int j = 32 * g + lane;
        p[g] = make_float4(CUDART_NAN_F, 0.f, 0.f, 0.f);
        if (j < n)
          p[g] = make_float4(
              v == nullptr || v[j] != 0 ? pts[3 * j] : CUDART_NAN_F,
              pts[3 * j + 1], pts[3 * j + 2], 0.f);
      }
      first_k_step(p, 0);
    }
    __syncwarp();  // the warp's FirstHit records
  } else {
    const SceneTiles st(smem, pts, v, n, async);
    const float4* pts4 = st.pts4;
    for_each_tile(st, [&](int t0, int tn) {
      if (split == 1) {
        for (int base = 0; base < tn && !done; base += 32 * kGroups) {
          float4 p[kGroups];
#pragma unroll
          for (int g = 0; g < kGroups; ++g) p[g] = pts4[base + 32 * g + lane];
          first_k_step(p, t0 + base);
        }
        return done;
      }
      // `split` warps a query: count, prefix over the warps, then rank
      const int lo = part * range;  // this warp's points of the tile
      unsigned* bal_q = ballots + slot_q * kMaxScales * kTileGroups;
      int mine[kMaxScales];
#pragma unroll
      for (int s = 0; s < kMaxScales; ++s) mine[s] = 0;
      if (!done) {
        for (int base = lo; base < lo + range && base < tn;
             base += 32 * kGroups) {
          bool hit[kGroups][kScales];
#pragma unroll
          for (int g = 0; g < kGroups; ++g)
            pred.test(pts4[base + 32 * g + lane], out, hit[g]);
#pragma unroll
          for (int g = 0; g < kGroups; ++g) {
#pragma unroll
            for (int s = 0; s < kScales; ++s) {
              const unsigned bal = __ballot_sync(kFullMask, hit[g][s]);
              if (lane == 0) bal_q[s * kTileGroups + base / 32 + g] = bal;
              mine[s] += __popc(bal);
            }
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int s = 0; s < kMaxScales; ++s)
            warp_cnt[warp * kMaxScales + s] = mine[s];
        }
      }
      __syncthreads();
      if (!done) {
        int rank0[kMaxScales];  // rank of this warp's first hit
        int total[kMaxScales];  // the query's hits in this tile
        bool write = false;
#pragma unroll
        for (int s = 0; s < kScales; ++s) {
          rank0[s] = cnt[s];
          total[s] = 0;
          for (int w = 0; w < split; ++w) {
            const int c = warp_cnt[(slot_q * split + w) * kMaxScales + s];
            if (w < part) rank0[s] += c;
            total[s] += c;
          }
          if (mine[s] > 0 && rank0[s] < out.k[s]) write = true;
        }
        for (int base = lo; write && base < lo + range && base < tn;
             base += 32) {
          const int g = base / 32;
          const int i = base + lane;
#pragma unroll
          for (int s = 0; s < kScales; ++s) {
            const unsigned bal = bal_q[s * kTileGroups + g];
            if (bal == 0 || rank0[s] >= out.k[s]) continue;
            const int rank = rank0[s] + __popc(bal & below);
            if (((bal >> lane) & 1u) && rank < out.k[s])
              put_hit<kCoords>(out, s, q, rank, t0 + i, pts4[i], ox, oy, oz,
                               first);
            rank0[s] += __popc(bal);
          }
        }
#pragma unroll
        for (int s = 0; s < kScales; ++s) cnt[s] += total[s];
        done = all_full<kScales>(cnt, out);
      }
      return done;  // every query full: load no further tile
    });
  }

  if (!has_q) return;
  write_padding<kScales, kCoords>(out, q, cnt, first, pts, ox, oy, oz, part,
                                  split, lane);
}

// Warps a query (1, 2, 4, 8 or 16) for nq queries over n points a scene:
// none below a tile, then doubled while the launch stays within
// kTargetWarps warps and each warp keeps kMinWarpPoints of the scene.
inline int group_first_split(long long nq, int n) {
  int split = 1;
  if (n < kTile) return split;
  while (split < kMaxSplit && nq * split * 2 <= kTargetWarps &&
         n / (split * 2) >= kMinWarpPoints)
    split *= 2;
  return split;
}

// Launch group_first_kernel<Pred, kCoords> over nb scenes of n points and m
// queries a scene; split: warps a query, 0 for group_first_split's choice
// (another value only to time one split against another).
template <class Pred, bool kCoords>
int launch_group_first(const float* xyz, const uint8_t* valid,
                       const float* query, int nb, int n, int m, int split,
                       const GroupOut& out, cudaStream_t stream) {
  if (out.nscales != Pred::kScales)
    return static_cast<int>(cudaErrorInvalidValue);
  if (split == 0) split = group_first_split(static_cast<long long>(nb) * m, n);
  if (split < 1 || split > kMaxSplit || (split & (split - 1)) != 0 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // one warp a query over a scene of one step needs no staging
  const int direct = split == 1 && n <= 32 * kGroups;
  const int warps = direct ? kDirectWarps : kCtaWarps;
  const int qpc = warps / split;
  const int ctas_per_scene = (m + qpc - 1) / qpc;
  const long long grid = static_cast<long long>(nb) * ctas_per_scene;
  if (grid == 0) return 0;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int async =
      reinterpret_cast<uintptr_t>(xyz) % 16 == 0 && n % 4 == 0 &&
      (valid == nullptr ||
       (reinterpret_cast<uintptr_t>(valid) % 16 == 0 && n % 16 == 0));
  const cudaError_t e = cudaFuncSetAttribute(
      group_first_kernel<Pred, kCoords>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kGroupFirstSmemBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  group_first_kernel<Pred, kCoords>
      <<<static_cast<unsigned>(grid), warps * 32,
         direct ? 0 : kGroupFirstSmemBytes, stream>>>(
          xyz, valid, query, n, m, split, ctas_per_scene, async, direct, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gspn
