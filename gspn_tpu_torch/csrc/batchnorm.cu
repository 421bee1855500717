// BatchNorm in training mode with its ReLU, forward and backward, for an
// (R, C) float32 input whose rows are the batch: nn/layers.py's
// MaskedBatchNorm and the ReLU after it, which PyTorch runs as ~28 kernels
// forward and ~18 backward a layer.
//
// Not a port of a TPU kernel: on the TPU, XLA fuses the JAX package's
// MaskedBatchNorm itself. The kernels live in the namespace gspn_bn, not
// gspn, so that a profiler's gspn:: kernels stay the point ops.
//
// Bitwise the module's PyTorch code and its autograd backward. The column
// sums stay PyTorch's own reductions (ops/batchnorm.py), over the same
// tensors the module's code reduces, so they round as they do there; the
// kernels take every element-wise and per-channel step around them, each
// rounded to nearest in the module's order (__fadd_rn, __fmul_rn,
// __fdiv_rn; the library builds with -fmad=false):
//   1. bn_stats_kernel: from the sums s1, s2 and the weight total, a
//      thread a channel: tot = max(tot, 1), mean = s1 / tot, v = s2 / tot -
//      mean^2, var = max(v, 0), rstd = rsqrt(var + eps), the running
//      statistics' blend, and the gate v >= 0 of the clamp's gradient.
//   2. bn_apply_kernel: ((x - mean) * rstd) * scale + bias, the ReLU and the
//      cast to the output dtype, a pass.
//   3. bn_grad_terms_kernel: the ReLU's mask recomputed from x (the output
//      is not kept); the four (R, C) terms autograd reduces: g, g * xhat
//      (scale's gradient), g scale (x - mean) (rstd's) and g scale rstd
//      (the mean's, and dx's direct term), a pass.
//   4. bn_grad_input_kernel: from the column sums of those terms, the
//      gradients of the variance, the mean, s1 and s2 a channel, then dx as
//      autograd adds its four contributions: ((g scale rstd + g2 w x) +
//      g2 w x) + g1 w, a pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gspn_bn {
namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 32;  // channel vectors a CTA's row at most
constexpr int kUnroll = 4;  // rows a thread loads before it stores

// the CTA's layout over an (R, C) tensor of V-wide channel vectors
struct Tile {
  int lanes;      // channel vectors a row of the CTA (threads a row)
  int rows;       // rows the CTA takes at a time
  int lane, row;  // this thread's; row >= rows: idle
  int cv;         // this thread's channel vector (>= cvs: idle)
  int cvs;        // C / V
};

template <int V>
__device__ __forceinline__ Tile tile(int c) {
  Tile t;
  t.cvs = c / V;
  t.lanes = t.cvs < kLanes ? t.cvs : kLanes;
  t.rows = kThreads / t.lanes;
  t.lane = threadIdx.x % t.lanes;
  t.row = threadIdx.x / t.lanes;
  t.cv = blockIdx.y * t.lanes + t.lane;
  return t;
}

template <int V>
__device__ __forceinline__ void load(const float* p, float (&a)[V]) {
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    a[0] = v.x, a[1] = v.y, a[2] = v.z, a[3] = v.w;
  } else {
    a[0] = *p;
  }
}

// a gradient of the output's dtype as float32 (bfloat16 widens exactly)
template <int V>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&a)[V]) {
  if constexpr (V == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    a[0] = lo.x, a[1] = lo.y, a[2] = hi.x, a[3] = hi.y;
  } else {
    a[0] = __bfloat162float(*p);
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&a)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  else
    *p = a[0];
}

template <int V>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&a)[V]) {
  if constexpr (V == 4) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(a[0], a[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(a[2], a[3]);
    uint2 u;
    u.x = *reinterpret_cast<unsigned*>(&lo);
    u.y = *reinterpret_cast<unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
  } else {
    *p = __float2bfloat16_rn(a[0]);
  }
}

// the row weights: W 0 none (every row 1), 1 one byte a row (a bool mask),
// 2 float32
template <int W>
__device__ __forceinline__ float row_weight(const void* w, long long r) {
  if constexpr (W == 0)
    return 1.0f;
  else if constexpr (W == 1)
    return static_cast<float>(static_cast<const uint8_t*>(w)[r]);
  else
    return static_cast<const float*>(w)[r];
}

// torch.clamp(v, min=lo) and torch.relu on the card: NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// the output as the forward stored it, in its dtype
template <typename Out>
__device__ __forceinline__ float stored(float y) {
  if constexpr (sizeof(Out) == 2)
    return __bfloat162float(__float2bfloat16_rn(y));
  else
    return y;
}

// xhat * scale + bias, as the module rounds it
__device__ __forceinline__ float affine(float xhat, float scale, float bias) {
  return __fadd_rn(__fmul_rn(xhat, scale), bias);
}

// 1. The statistics from the column sums, a thread a channel. tot: the
// weight total (a device scalar), or null for `rows` rows. stats: mean (C),
// rstd (C), the clamp's gradient gate (C: 1 where s2/tot - mean^2 >= 0),
// tot (1). With update, the running statistics move as keep * old + take *
// batch.
__global__ void __launch_bounds__(kThreads)
    bn_stats_kernel(const float* __restrict__ s1, const float* __restrict__ s2,
                    const float* __restrict__ tot_in, int rows, int c, float eps, float keep,
                    float take, int update, float* __restrict__ stats,
                    float* __restrict__ run_mean, float* __restrict__ run_var) {
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  if (ch >= c) return;
  const float tot = clamp_min(tot_in ? *tot_in : static_cast<float>(rows), 1.0f);
  const float mean = __fdiv_rn(s1[ch], tot);
  const float v = __fsub_rn(__fdiv_rn(s2[ch], tot), __fmul_rn(mean, mean));
  const float var = clamp_min(v, 0.0f);
  if (update) {
    run_mean[ch] = __fadd_rn(__fmul_rn(run_mean[ch], keep), __fmul_rn(mean, take));
    run_var[ch] = __fadd_rn(__fmul_rn(run_var[ch], keep), __fmul_rn(var, take));
  }
  stats[ch] = mean;
  stats[c + ch] = rsqrtf(__fadd_rn(var, eps));
  stats[2 * c + ch] = v >= 0.0f ? 1.0f : 0.0f;
  if (ch == 0) stats[3 * c] = tot;
}

// 2. The normalization, the affine, the ReLU and the cast, a pass.
template <int V, bool kRelu, typename Out>
__global__ void __launch_bounds__(kThreads)
    bn_apply_kernel(const float* __restrict__ x, const float* __restrict__ stats,
                    const float* __restrict__ scale, const float* __restrict__ bias, int rows,
                    int c, Out* __restrict__ out) {
  const Tile t = tile<V>(c);
  if (t.row >= t.rows || t.cv >= t.cvs) return;
  const int c0 = t.cv * V;
  float mean[V], rstd[V], sc[V], bi[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    mean[k] = stats[c0 + k];
    rstd[k] = stats[c + c0 + k];
    sc[k] = scale[c0 + k];
    bi[k] = bias[c0 + k];
  }
  const long long step = static_cast<long long>(gridDim.x) * t.rows;
  for (long long r = static_cast<long long>(blockIdx.x) * t.rows + t.row; r < rows;
       r += kUnroll * step) {
    float v[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (r + u * step < rows) load<V>(x + (r + u * step) * c + c0, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * step >= rows) break;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float y = affine(__fmul_rn(__fsub_rn(v[u][k], mean[k]), rstd[k]), sc[k], bi[k]);
        v[u][k] = kRelu ? clamp_min(y, 0.0f) : y;
      }
      store<V>(out + (r + u * step) * c + c0, v[u]);
    }
  }
}

// 3. The terms autograd reduces, a pass: gy (the ReLU's gradient, float32;
// null where g is summed as it is), ts = gy * xhat, tr = gy scale (x -
// mean), td = gy scale rstd.
template <int V, bool kRelu, typename G>
__global__ void __launch_bounds__(kThreads)
    bn_grad_terms_kernel(const float* __restrict__ x, const G* __restrict__ g,
                         const float* __restrict__ stats, const float* __restrict__ scale,
                         const float* __restrict__ bias, int rows, int c,
                         float* __restrict__ gy_out, float* __restrict__ ts,
                         float* __restrict__ tr, float* __restrict__ td) {
  const Tile t = tile<V>(c);
  if (t.row >= t.rows || t.cv >= t.cvs) return;
  const int c0 = t.cv * V;
  float mean[V], rstd[V], sc[V], bi[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    mean[k] = stats[c0 + k];
    rstd[k] = stats[c + c0 + k];
    sc[k] = scale[c0 + k];
    bi[k] = bias[c0 + k];
  }
  const long long step = static_cast<long long>(gridDim.x) * t.rows;
  for (long long r = static_cast<long long>(blockIdx.x) * t.rows + t.row; r < rows;
       r += kUnroll * step) {
    float v[kUnroll][V], gv[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * step < rows) {
        load<V>(x + (r + u * step) * c + c0, v[u]);
        load<V>(g + (r + u * step) * c + c0, gv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * step >= rows) break;
      float s[V], q[V], d[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float xc = __fsub_rn(v[u][k], mean[k]);
        const float xhat = __fmul_rn(xc, rstd[k]);
        float gy = gv[u][k];
        // torch's threshold_backward: no gradient where the stored output
        // is <= 0 (a NaN passes it)
        if (kRelu && stored<G>(affine(xhat, sc[k], bi[k])) <= 0.0f) gy = 0.0f;
        gv[u][k] = gy;
        s[k] = __fmul_rn(gy, xhat);
        const float gs = __fmul_rn(gy, sc[k]);
        q[k] = __fmul_rn(gs, xc);
        d[k] = __fmul_rn(gs, rstd[k]);
      }
      const long long at = (r + u * step) * c + c0;
      if (gy_out) store<V>(gy_out + at, gv[u]);
      store<V>(ts + at, s);
      store<V>(tr + at, q);
      store<V>(td + at, d);
    }
  }
}

// 4. dx from td and the column sums sr (of tr) and sd (of td), a pass.
template <int V, int W>
__global__ void __launch_bounds__(kThreads)
    bn_grad_input_kernel(const float* __restrict__ x, const float* __restrict__ td,
                         const void* __restrict__ w, const float* __restrict__ stats,
                         const float* __restrict__ sr, const float* __restrict__ sd, int rows,
                         int c, float* __restrict__ dx) {
  const Tile t = tile<V>(c);
  if (t.row >= t.rows || t.cv >= t.cvs) return;
  const int c0 = t.cv * V;
  const float tot = stats[3 * c];
  float g1[V], g2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int ch = c0 + k;
    const float mean = stats[ch], rstd = stats[c + ch];
    // rsqrt's backward, -0.5 * grad * rstd^3, then the clamp's gate
    const float cube = __fmul_rn(__fmul_rn(rstd, rstd), rstd);
    const float gv =
        stats[2 * c + ch] != 0.0f ? __fmul_rn(__fmul_rn(-0.5f, sr[ch]), cube) : 0.0f;
    // the mean's gradient: -sum(td), then mean * mean's, twice
    const float mm = __fmul_rn(-gv, mean);
    g1[k] = __fdiv_rn(__fadd_rn(__fadd_rn(-sd[ch], mm), mm), tot);
    g2[k] = __fdiv_rn(gv, tot);
  }
  const long long step = static_cast<long long>(gridDim.x) * t.rows;
  for (long long r = static_cast<long long>(blockIdx.x) * t.rows + t.row; r < rows;
       r += kUnroll * step) {
    float v[kUnroll][V], d[kUnroll][V], wt[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * step < rows) {
        load<V>(x + (r + u * step) * c + c0, v[u]);
        load<V>(td + (r + u * step) * c + c0, d[u]);
        wt[u] = row_weight<W>(w, r + u * step);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * step >= rows) break;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float g2w = W == 0 ? g2[k] : __fmul_rn(g2[k], wt[u]);
        const float sq = __fmul_rn(g2w, v[u][k]);
        const float g1w = W == 0 ? g1[k] : __fmul_rn(g1[k], wt[u]);
        d[u][k] = __fadd_rn(__fadd_rn(__fadd_rn(d[u][k], sq), sq), g1w);
      }
      store<V>(dx + (r + u * step) * c + c0, d[u]);
    }
  }
}

// A refused call's error is also the runtime's last error: clear it, so that
// the next launch's check does not report it again.
cudaError_t refused(cudaError_t err) {
  cudaGetLastError();
  return err;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }
bool aligned8(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 7u) == 0; }

// the grid of a pass: `blocks` CTAs along the rows (the wrapper's plan) by
// the channel tiles of V-wide vectors
dim3 grid(int blocks, int c, int v) {
  const int cvs = c / v;
  const int lanes = cvs < kLanes ? cvs : kLanes;
  return dim3(static_cast<unsigned>(blocks), static_cast<unsigned>((cvs + lanes - 1) / lanes));
}

bool bad_shape(int rows, int c, int blocks) {
  return rows < 0 || c < 1 || blocks < 1 || blocks > 65535 || (c + kLanes - 1) / kLanes > 65535;
}

template <int V, typename Out>
cudaError_t apply_launch(const float* x, const float* stats, const float* scale,
                         const float* bias, int rows, int c, int blocks, int relu, void* out,
                         cudaStream_t stream) {
  Out* o = static_cast<Out*>(out);
  if (relu)
    bn_apply_kernel<V, true, Out><<<grid(blocks, c, V), kThreads, 0, stream>>>(
        x, stats, scale, bias, rows, c, o);
  else
    bn_apply_kernel<V, false, Out><<<grid(blocks, c, V), kThreads, 0, stream>>>(
        x, stats, scale, bias, rows, c, o);
  return cudaGetLastError();
}

template <int V, typename G>
cudaError_t terms_launch(const float* x, const void* g, const float* stats, const float* scale,
                         const float* bias, int relu, int rows, int c, int blocks, float* gy,
                         float* ts, float* tr, float* td, cudaStream_t stream) {
  const G* gg = static_cast<const G*>(g);
  if (relu)
    bn_grad_terms_kernel<V, true, G><<<grid(blocks, c, V), kThreads, 0, stream>>>(
        x, gg, stats, scale, bias, rows, c, gy, ts, tr, td);
  else
    bn_grad_terms_kernel<V, false, G><<<grid(blocks, c, V), kThreads, 0, stream>>>(
        x, gg, stats, scale, bias, rows, c, gy, ts, tr, td);
  return cudaGetLastError();
}

template <int V>
cudaError_t input_launch(const float* x, const float* td, const void* w, int wkind,
                         const float* stats, const float* sr, const float* sd, int rows, int c,
                         int blocks, float* dx, cudaStream_t stream) {
  const dim3 gr = grid(blocks, c, V);
  if (wkind == 0)
    bn_grad_input_kernel<V, 0><<<gr, kThreads, 0, stream>>>(x, td, w, stats, sr, sd, rows, c, dx);
  else if (wkind == 1)
    bn_grad_input_kernel<V, 1><<<gr, kThreads, 0, stream>>>(x, td, w, stats, sr, sd, rows, c, dx);
  else
    bn_grad_input_kernel<V, 2><<<gr, kThreads, 0, stream>>>(x, td, w, stats, sr, sd, rows, c, dx);
  return cudaGetLastError();
}

}  // namespace
}  // namespace gspn_bn

using namespace gspn_bn;

// s1, s2 (c): the column sums of x (w x) and x^2 (x^2 w); tot: the weights'
// sum (a device scalar), or null for `rows`; stats: 3 c + 1 floats. With
// update, run_mean and run_var move as keep * old + take * batch.
extern "C" int gspn_bn_stats(const float* s1, const float* s2, const float* tot, int rows, int c,
                             float eps, float keep, float take, int update, float* stats,
                             float* run_mean, float* run_var, cudaStream_t stream) {
  if (rows < 0 || c < 1 || (update && (run_mean == nullptr || run_var == nullptr)))
    return static_cast<int>(refused(cudaErrorInvalidValue));
  bn_stats_kernel<<<(c + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      s1, s2, tot, rows, c, eps, keep, take, update, stats, run_mean, run_var);
  return static_cast<int>(cudaGetLastError());
}

// x (rows, c) float32; blocks: CTAs along the rows (ops/batchnorm.py
// batch_norm_plan); out (rows, c): float32, or bfloat16 with bf16; relu:
// the ReLU after the affine.
extern "C" int gspn_bn_apply(const float* x, const float* stats, const float* scale,
                             const float* bias, int rows, int c, int blocks, int relu, int bf16,
                             void* out, cudaStream_t stream) {
  if (bad_shape(rows, c, blocks)) return static_cast<int>(refused(cudaErrorInvalidValue));
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  const bool vec = c % 4 == 0 && aligned16(x) && (bf16 ? aligned8(out) : aligned16(out));
  cudaError_t err;
  if (bf16)
    err = vec ? apply_launch<4, __nv_bfloat16>(x, stats, scale, bias, rows, c, blocks, relu,
                                               out, stream)
              : apply_launch<1, __nv_bfloat16>(x, stats, scale, bias, rows, c, blocks, relu,
                                               out, stream);
  else
    err = vec ? apply_launch<4, float>(x, stats, scale, bias, rows, c, blocks, relu, out,
                                       stream)
              : apply_launch<1, float>(x, stats, scale, bias, rows, c, blocks, relu, out,
                                       stream);
  return static_cast<int>(err);
}

// g (rows, c) of the output's dtype (bfloat16 with bf16); gy (null only
// where g is float32 and no ReLU masks it: g is summed as it is), ts, tr,
// td (rows, c) float32.
extern "C" int gspn_bn_grad_terms(const float* x, const void* g, int bf16, const float* stats,
                                  const float* scale, const float* bias, int relu, int rows,
                                  int c, int blocks, float* gy, float* ts, float* tr, float* td,
                                  cudaStream_t stream) {
  if (bad_shape(rows, c, blocks) || ((relu || bf16) && gy == nullptr))
    return static_cast<int>(refused(cudaErrorInvalidValue));
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  const bool vec = c % 4 == 0 && aligned16(x) && (bf16 ? aligned8(g) : aligned16(g)) &&
                   (gy == nullptr || aligned16(gy)) && aligned16(ts) && aligned16(tr) &&
                   aligned16(td);
  cudaError_t err;
  if (bf16)
    err = vec ? terms_launch<4, __nv_bfloat16>(x, g, stats, scale, bias, relu, rows, c, blocks,
                                               gy, ts, tr, td, stream)
              : terms_launch<1, __nv_bfloat16>(x, g, stats, scale, bias, relu, rows, c, blocks,
                                               gy, ts, tr, td, stream);
  else
    err = vec ? terms_launch<4, float>(x, g, stats, scale, bias, relu, rows, c, blocks, gy, ts,
                                       tr, td, stream)
              : terms_launch<1, float>(x, g, stats, scale, bias, relu, rows, c, blocks, gy, ts,
                                       tr, td, stream);
  return static_cast<int>(err);
}

// dx (rows, c) float32 from td and the column sums sr (of tr) and sd (of
// td); w: null (wkind 0), one byte a row (1) or float32 (2).
extern "C" int gspn_bn_grad_input(const float* x, const float* td, const void* w, int wkind,
                                  const float* stats, const float* sr, const float* sd, int rows,
                                  int c, int blocks, float* dx, cudaStream_t stream) {
  if (bad_shape(rows, c, blocks) || wkind < 0 || wkind > 2 || (wkind != 0 && w == nullptr))
    return static_cast<int>(refused(cudaErrorInvalidValue));
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  const bool vec = c % 4 == 0 && aligned16(x) && aligned16(td) && aligned16(dx);
  return static_cast<int>(vec ? input_launch<4>(x, td, w, wkind, stats, sr, sd, rows, c, blocks,
                                                dx, stream)
                              : input_launch<1>(x, td, w, wkind, stats, sr, sd, rows, c, blocks,
                                                dx, stream));
}
