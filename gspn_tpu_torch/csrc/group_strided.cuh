// Strided grouping, each point tested once, shared by the strided ball
// group (ball_group.cu), the strided ball query (ball_query.cu: kCoords
// false, indices and counts only) and the strided box group
// (box_group.cu), over the predicate types of group_first.cuh (Ball<n>,
// Box).
//
// The contract (gspn_tpu/ops/ball_query.py _strided_target_mask): with
// `total` hits in a scale (uncapped), slot j < min(total, K) holds the hit
// of rank floor(j * total / K) in ascending index order, so every hit in
// order when total <= K; the rank arithmetic is in 64 bits. A slot gets
// the point's index and local = p - origin (__fsub_rn; the box origin
// (lo + hi) * 0.5 rounded as Box::load rounds it); slots past min(total, K)
// repeat the first hit; an empty row takes index 0 and point 0 minus the
// origin; cnt = min(total, K). The ball test d2 < r2 is strict, the box
// test inclusive.
//
// group_strided_kernel. What bounds it: the point tests. Every query tests
// its whole scene (the selection needs `total`), and all queries of a scene
// test the same points. So, as group_first_kernel does:
//   - a CTA holds queries of one scene and stages that scene through
//     shared memory (SceneTiles: double-buffered cp.async tiles, float4
//     points with NaN x where invalid);
//   - when queries are few, `split` warps share one query: within each
//     tile warp w tests the contiguous w-th of kTile / split points.
// Each point is tested once. Pass 1 keeps every (query, scale, 32-point
// group) ballot: one bit a point, `words` words a query and scale, in
// shared memory when the CTA's ballots fit the wrapper's budget
// (`ballots` null), else in the wrapper's scratch buffer (L2-resident: 8 MB
// at SA1's 8 x 1024 queries over 8192 points). Pass 2 reads only ballots:
// warp w of a query takes the contiguous w-th of its words, counts their
// hits, and an exclusive prefix over the query's warps gives the rank of
// its first hit. It then walks its words 32 at a time (a word a lane, a
// warp scan of the popcounts): a window holding ranks [c, c + h) holds the
// targets of slots ceil(c*K/total) up to ceil((c+h)*K/total) (every rank
// when total <= K), and each lane takes one of those slots, finds the lane
// whose word holds its rank r by a binary search over the scan (five
// shuffles), and its bit as the (r - p + 1)-th set bit of that word, whose
// first rank is p (__fns): a dense word's slots are spread over the lanes.
// Point coordinates are read once a slot from device memory. That is
// O(N/32 + K) a query and scale after the tests, where a second scan of
// the scene would test every point again. The walk stops past the last
// target rank.
//
// A short scene (SA2-SA4: 64-1024 points a scene, a few steps) is not
// worth a CTA's staging and barriers: in `direct` mode each warp of a CTA
// of kDirectWarps holds one query and tests its scene straight from device
// memory (L1/L2), keeping its ballots in shared memory (in registers when
// the scene is one step); pass 2 needs no barrier then.
//
// The plan (warps a query, 1-16, or direct) and where the ballots live are
// the wrapper's (ops/ball_query.py strided_plan), fitted on an H100 to
// every plan timed at the strided groups' shapes (chip_smoke.py's split
// sweep).

#pragma once

#include "group_first.cuh"

namespace gspn {

// floor(a * b / c) and ceil(a * b / c) for a, b, c >= 0 (c > 0), in 32
// bits where the product fits (a 64-bit division is a long emulated
// sequence on the card).
__device__ __forceinline__ long long mul_div(long long a, long long b,
                                             long long c) {
  const unsigned long long ab = static_cast<unsigned long long>(a * b);
  if ((ab >> 32) == 0 && (c >> 32) == 0)
    return static_cast<unsigned>(ab) / static_cast<unsigned>(c);
  return static_cast<long long>(ab / static_cast<unsigned long long>(c));
}
__device__ __forceinline__ long long mul_div_up(long long a, long long b,
                                                long long c) {
  const long long f = mul_div(a, b, c);
  return f * c == a * b ? f : f + 1;
}

// Ballot words a query and scale: one a point, whole steps of the tiles.
inline int strided_words(int n) {
  constexpr int kStep = 32 * kGroups;
  return (n + kStep - 1) / kStep * kGroups;
}

// grid: nb * ctas_per_scene CTAs of kCtaWarps warps (kDirectWarps when
// `direct`, at split 1); CTA c serves scene c / ctas_per_scene, queries
// from (c % ctas_per_scene) * (warps / split), `split` warps each.
// `ballots`: (nb * m, kScales, words) words, or null for the CTA's
// ballots in dynamic shared memory (after the staging and the warp counts
// unless `direct`). kCoords: write the local coordinates too (out.local),
// else only idx and cnt.
template <class Pred, bool kCoords>
__global__ void __launch_bounds__(kCtaWarps * 32, 2)
    group_strided_kernel(const float* __restrict__ xyz,
                         const uint8_t* __restrict__ valid,
                         const float* __restrict__ query, int n, int m,
                         int split, int direct, int ctas_per_scene, int async,
                         int words, unsigned* __restrict__ ballots,
                         GroupOut out) {
  constexpr int kScales = Pred::kScales;
  extern __shared__ __align__(16) unsigned char smem[];
  int* warp_cnt = reinterpret_cast<int*>(smem + kStagingBytes);
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
  // this query's ballots, [scale][word]
  unsigned* bal =
      ballots ? ballots + static_cast<size_t>(q) * kScales * words
              : reinterpret_cast<unsigned*>(
                    smem + (direct ? 0 : kStagingBytes + kWarpCountBytes)) +
                    static_cast<size_t>(slot_q) * kScales * words;
  FirstHit* first = first_hits + slot_q * kMaxScales;

  Pred pred;
  if (has_q) pred.load(query + static_cast<size_t>(q) * Pred::kQueryFloats);
  const float ox = pred.ox, oy = pred.oy, oz = pred.oz;

  // pass 1: test every point once, keep the ballots (word w holds points
  // 32 w + lane); in direct mode also count the warp's hits, and in a
  // scene of one step (SA4) keep that step's ballots in every lane's
  // registers, so that pass 2 reads no shared memory
  int total[kMaxScales], carry0[kMaxScales];
#pragma unroll
  for (int s = 0; s < kMaxScales; ++s) total[s] = carry0[s] = 0;
  const bool one_step = direct && n <= 32 * kGroups;
  unsigned step_bal[kGroups][kScales];
  auto keep = [&](const bool (&hit)[kGroups][kScales], int w, bool direct_w) {
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
#pragma unroll
      for (int s = 0; s < kScales; ++s) {
        const unsigned bw = __ballot_sync(kFullMask, hit[g][s]);
        if (direct_w) {  // a constant at each (inlined) call
          step_bal[g][s] = bw;
          total[s] += __popc(bw);
          if (lane == g * kScales + s && !one_step) bal[s * words + w + g] = bw;
        } else if (lane == g * kScales + s) {
          bal[s * words + w + g] = bw;
        }
      }
    }
  };
  if (direct) {
    for (int base = 0; has_q && base < n; base += 32 * kGroups) {
      bool hit[kGroups][kScales];
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int j = base + 32 * g + lane;
        float4 p = make_float4(CUDART_NAN_F, 0.f, 0.f, 0.f);
        if (j < n)
          p = make_float4(v == nullptr || v[j] != 0 ? pts[3 * j] : CUDART_NAN_F,
                          pts[3 * j + 1], pts[3 * j + 2], 0.f);
        pred.test(p, out, hit[g]);
      }
      keep(hit, base / 32, true);
    }
    __syncwarp();
  } else {
    const int range = kTile / split;  // points of a tile a warp tests
    const SceneTiles st(smem, pts, v, n, async);
    for_each_tile(st, [&](int t0, int tn) {
      if (!has_q) return false;
      const int lo = part * range;
      for (int base = lo; base < lo + range && base < tn;
           base += 32 * kGroups) {
        bool hit[kGroups][kScales];
#pragma unroll
        for (int g = 0; g < kGroups; ++g)
          pred.test(st.pts4[base + 32 * g + lane], out, hit[g]);
        keep(hit, (t0 + base) / 32, false);
      }
      return false;  // the count needs the whole scene
    });
  }

  // pass 2: warp `part` ranks the contiguous part-th of the query's words
  // (all of them at split 1); a staged warp first counts the hits of its
  // words, and at split > 1 a prefix over the query's warps gives the rank
  // of its first
  const int share = (words + split - 1) / split;
  const int w0 = part * share;
  const int w1 = min(words, w0 + share);
  if (!direct) {
#pragma unroll
    for (int s = 0; s < kScales; ++s) {
      int c = 0;
      for (int w = w0 + lane; has_q && w < w1; w += 32)
        c += __popc(bal[s * words + w]);
      total[s] = static_cast<int>(
          __reduce_add_sync(kFullMask, static_cast<unsigned>(c)));
      if (split > 1 && lane == 0) warp_cnt[warp * kMaxScales + s] = total[s];
    }
  }
  if (split > 1) {
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kScales; ++s) {
      total[s] = 0;
      for (int w = 0; has_q && w < split; ++w) {
        const int c = warp_cnt[(slot_q * split + w) * kMaxScales + s];
        if (w < part) carry0[s] += c;
        total[s] += c;
      }
    }
  }
  if (has_q && one_step) {
#pragma unroll
    for (int s = 0; s < kScales; ++s) {
      const long long tot = total[s];
      const long long k = out.k[s];
      for (long long j = lane; j < min(tot, k); j += 32) {
        const int r = static_cast<int>(tot <= k ? j : mul_div(j, tot, k));
        int g = 0, before = 0;  // the group holding rank r, its first rank
        unsigned word = step_bal[0][s];
#pragma unroll
        for (int h = 0; h + 1 < kGroups; ++h) {
          const int pc = __popc(step_bal[h][s]);
          if (g == h && r >= before + pc) {
            g = h + 1;
            before += pc;
            word = step_bal[h + 1][s];
          }
        }
        const int i = 32 * g + static_cast<int>(__fns(word, 0, r - before + 1));
        put_hit<kCoords>(out, s, q, static_cast<int>(j), i,
                make_float4(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2], 0.f),
                ox, oy, oz, first);
      }
    }
  } else if (has_q) {
#pragma unroll
    for (int s = 0; s < kScales; ++s) {
      int carry = carry0[s];  // rank of the next word's first hit
      const long long tot = total[s];
      const long long k = out.k[s];
      const long long last = tot <= k ? tot - 1 : mul_div(k - 1, tot, k);
      const unsigned* bs = bal + s * words;
      for (int base = w0; base < w1 && carry <= last; base += 32) {
        const int w = base + lane;
        const unsigned word = w < w1 ? bs[w] : 0u;
        const int pc = __popc(word);
        int incl = pc;  // inclusive scan of the popcounts over the lanes
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int o = __shfl_up_sync(kFullMask, incl, off);
          if (lane >= off) incl += o;
        }
        const int hits = __shfl_sync(kFullMask, incl, 31);
        // the slots whose target ranks lie in [carry, carry + hits), a
        // slot a lane
        long long j0 = carry, j1 = carry + hits;
        if (tot > k) {
          j0 = mul_div_up(carry, k, tot);
          j1 = min(k, mul_div_up(carry + hits, k, tot));
        }
        for (long long jb = j0; jb < j1; jb += 32) {
          const long long j = jb + lane;
          const int t = static_cast<int>(
              (j >= j1 ? carry : tot <= k ? j : mul_div(j, tot, k)) - carry);
          // the lane whose word holds the window's rank t: the lanes whose
          // inclusive count is <= t
          int l = 0;
#pragma unroll
          for (int step = 16; step > 0; step >>= 1)
            if (__shfl_sync(kFullMask, incl, l + step - 1) <= t) l += step;
          const unsigned wl = __shfl_sync(kFullMask, word, l);
          const int before = __shfl_sync(kFullMask, incl - pc, l);
          if (j < j1) {
            const int i = 32 * (base + l) +
                          static_cast<int>(__fns(wl, 0, t - before + 1));
            put_hit<kCoords>(out, s, q, static_cast<int>(j), i,
                    make_float4(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2],
                                0.f),
                    ox, oy, oz, first);
          }
        }
        carry += hits;
      }
    }
  }
  // every query's FirstHit records are written
  if (split > 1)
    __syncthreads();
  else
    __syncwarp();
  if (!has_q) return;
  write_padding<kScales, kCoords>(out, q, total, first, pts, ox, oy, oz, part,
                                  split, lane);
}

// Launch group_strided_kernel<Pred, kCoords> over nb scenes of n points and m
// queries a scene at `split` warps a query (1, 2, 4, 8 or 16) or `direct`
// (split 1), the ballots in `ballots` ((nb * m, Pred::kScales,
// strided_words(n)) words) or, when it is null, in shared memory.
template <class Pred, bool kCoords>
int launch_group_strided(const float* xyz, const uint8_t* valid,
                         const float* query, int nb, int n, int m, int split,
                         int direct, unsigned* ballots, const GroupOut& out,
                         cudaStream_t stream) {
  if (out.nscales != Pred::kScales)
    return static_cast<int>(cudaErrorInvalidValue);
  if (split < 1 || split > kMaxSplit || (split & (split - 1)) != 0 || n < 1 ||
      (direct && split != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int warps = direct ? kDirectWarps : kCtaWarps;
  const int qpc = warps / split;
  const int ctas_per_scene = (m + qpc - 1) / qpc;
  const long long grid = static_cast<long long>(nb) * ctas_per_scene;
  if (grid == 0) return 0;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int words = strided_words(n);
  const size_t smem =
      (direct ? 0 : kStagingBytes + kWarpCountBytes) +
      (ballots ? 0
               : static_cast<size_t>(qpc) * Pred::kScales * words *
                     sizeof(unsigned));
  const int async =
      reinterpret_cast<uintptr_t>(xyz) % 16 == 0 && n % 4 == 0 &&
      (valid == nullptr ||
       (reinterpret_cast<uintptr_t>(valid) % 16 == 0 && n % 16 == 0));
  const cudaError_t e = cudaFuncSetAttribute(
      group_strided_kernel<Pred, kCoords>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  group_strided_kernel<Pred, kCoords>
      <<<static_cast<unsigned>(grid), warps * 32, smem, stream>>>(
          xyz, valid, query, n, m, split, direct, ctas_per_scene, async,
          words, ballots, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gspn
