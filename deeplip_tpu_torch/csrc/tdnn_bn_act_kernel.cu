// Fused conv bias + BatchNorm + LeakyReLU of the TDNN blocks (T) for Hopper
// (sm_90a): train forward, train backward and eval apply, with a plain C
// interface for ctypes.
//
// Replaces no TPU kernel: on the TPU, XLA fuses the bias add, BN and
// LeakyReLU ops of deeplip_tpu/models/tdnn.py: TDNNBlock into the passes
// around each convolution. On the card the eager ops took over 60 % of a bf16 E-TDNN
// train step and 37 % of an FP32 extraction, as separate, unvectorised
// passes that broadcast each channel's constants along a strided axis.
//
// Input: the block's Conv1d output without its bias, in its own (B, C, T)
// layout, contiguous, in f32 or bf16; each (b, c) row is T contiguous
// elements. The kernels add the conv bias as the convolution would (x + cb
// in the activation's type T, cb cast to T): cuDNN's convolution adds it in
// a pass of its own, and its gradient is a reduction of its own. The
// per-channel parameters and every statistic are f32. The output has the
// same layout, so the blocks hand each other what they handed each other
// before.
//
// Train forward: x = conv + cb; per channel, over the B x T elements of its
//           B rows, the mean and biased variance (two-pass) in f32,
//           inv = 1 / sqrt(var + eps); then the eager ops' chain in T, each
//           result rounded to T as an eager op in T rounds it:
//           a = x - mean, y1 = a * inv, z = y1 * scale + bias (the four
//           constants cast to T), y = z > 0 ? z : slope * z
// Train backward: autograd of those eager ops, with x's chain recomputed:
//           gz = z > 0 ? dy : slope * dy, gy1 = gz * scale,
//           ga = gy1 * inv (in T)
//           dbias = sum gz, dscale = sum gz * y1 (rounded to T, as the
//           gradients of the parameters' T casts)
//           dx = ga + T(g_sq * 2 (x - mean) + g_mean / n), the gradient
//           through the f32 statistics from their per-channel sums
//           (tdnn_bwd_finalize_kernel); dcb = T(sum dx)
// Eval: the forward's chain with the running mean and inv = rsqrtf(var + eps).
//
// For f32 activations each op is rounded once in f32, so the eval apply
// gets the eager ops' bits. For bf16 the kernels round where the recipe's
// eager ops round (statistics in f32, the normalisation in bf16): the bf16
// TDNN step computes what it computed before, and the gradients of the
// convolutions' biases, which are zero in exact arithmetic and the bf16
// recipe's rounding noise in a step, keep the recipe's size.
//
// What bounds it on this card: bytes, and the loads in flight for bf16. A
// few flops an element leave the CUDA cores idle. Exact batch statistics
// need a read of x before the first y can be written, so the forward reads x
// twice and writes y (3|x|), the backward reads x and dy twice and writes dx
// (5|x|), and eval reads x once and writes y (2|x|); one pass over each
// input and output would be 2|x| and 3|x| in training.
//
// Design. Each warp owns whole (b, c) rows, one at a time: its lanes stride
// along the row, so a warp reads contiguous memory, the row's channel and its
// constants are fixed for the row, and no element needs a division to find
// its channel. (Two variants measured slower on the card: aligned pairs of
// elements a lane, with the odd element at a row's start or end apart; and a
// whole row held in registers, all of a lane's loads issued before any
// arithmetic.) A row's sums are added across the warp by a butterfly, whose
// result is bit-equal in every lane. Each reduction is a partial pass, which
// writes one slot per row (no atomics), and a finalize pass per channel,
// which adds its B slots in double in a fixed order: repeated runs, and CUDA
// graph replays, give bit-equal results. The forward's partial pass keeps
// the two-pass rule inside each row: the row sum, then the squares about the
// row's mean, read again from L1; the finalize merges the rows exactly
// (Chan's formula with the row mean as rounded). The elementwise arithmetic
// is rounded op by op (__fmul_rn / __fadd_rn: nothing contracts into an
// FMA).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // row-pass blocks: 8 warps
constexpr int kMaxGrid = 4096;  // row passes stride over the remaining rows
constexpr int kFinC = 32;       // finalize: channels per block
constexpr int kFinS = 32;       // finalize: batch slices per block

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// A value rounded to the activation type T, as an eager op in T rounds its result.
template <typename T>
__device__ __forceinline__ float rt(float v);
template <>
__device__ __forceinline__ float rt<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rt<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The first row of this warp and the stride between its rows.
__device__ __forceinline__ long long first_row() {
  return (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
}
__device__ __forceinline__ long long row_stride() {
  return ((long long)gridDim.x * blockDim.x) >> 5;
}

// The conv's output with its bias added, as the convolution adds it: x +
// cb in T, cb cast to T (cbT).
template <typename T>
__device__ __forceinline__ float biased(float x, float cbT) {
  return rt<T>(__fadd_rn(x, cbT));
}

// A channel's constants as the eager ops see them: the conv bias, mean,
// inv, scale and bias cast to T; mean also in f32 for the backward's
// (x - mean).
struct Channel {
  float cb, m, iv, sc, bi, m32;
};

template <typename T>
__device__ __forceinline__ Channel channel(float cb, float m, float iv, float sc, float bi) {
  return {rt<T>(cb), rt<T>(m), rt<T>(iv), rt<T>(sc), rt<T>(bi), m};
}

// The eager ops' chain in T from the biased conv output x: a = x - mean,
// y1 = a * inv, z = y1 * scale + bias, each result rounded to T (for f32
// each op is rounded once, and nothing contracts into an FMA).
struct Chain {
  float a, y1, z;
};

template <typename T>
__device__ __forceinline__ Chain chain(float x, const Channel& k) {
  Chain c;
  c.a = rt<T>(__fsub_rn(x, k.m));
  c.y1 = rt<T>(__fmul_rn(c.a, k.iv));
  c.z = rt<T>(__fadd_rn(rt<T>(__fmul_rn(c.y1, k.sc)), k.bi));
  return c;
}

template <typename T>
__device__ __forceinline__ float leaky(float z, float slope) {
  return z > 0.f ? z : rt<T>(__fmul_rn(z, slope));
}

// Forward, partial pass: per row of the biased conv output x, partial[0][row]
// = sum x and partial[1][row] = sum (x - m)^2 with m = sum x / len rounded to
// f32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
tdnn_stats_kernel(const T* __restrict__ x, const float* __restrict__ conv_bias,
                  float* __restrict__ partial, long long rows, int C, int len) {
  const int lane = threadIdx.x & 31;
  for (long long r = first_row(); r < rows; r += row_stride()) {
    const float cb = rt<T>(__ldg(conv_bias + (int)(r % C)));
    const T* xr = x + r * len;
    float s = 0.f;
#pragma unroll 4
    for (int t = lane; t < len; t += 32) s += biased<T>(ld(xr + t), cb);
    s = warp_sum(s);
    const float m = __fdiv_rn(s, (float)len);
    float q = 0.f;
#pragma unroll 4
    for (int t = lane; t < len; t += 32) {
      const float d = __fsub_rn(biased<T>(ld(xr + t), cb), m);
      q = __fadd_rn(q, __fmul_rn(d, d));
    }
    q = warp_sum(q);
    if (lane == 0) {
      partial[r] = s;
      partial[rows + r] = q;
    }
  }
}

// Adds sh[slice][x] over the slices in order (thread row y = 0 only).
__device__ __forceinline__ double slices_total(const double (&sh)[kFinS][kFinC]) {
  double s = 0.0;
  for (int j = 0; j < kFinS; ++j) s += sh[j][threadIdx.x];
  return s;
}

// Forward, finalize: channel c's mean over its batch x len elements, then
// the biased variance from each row's squares about its own mean m_b:
//   sum (x - mu)^2 = sum_b [q_b + (m_b - mu) (2 (s_b - len m_b) + len (m_b - mu))]
__global__ void __launch_bounds__(kFinC * kFinS)
tdnn_finalize_kernel(const float* __restrict__ partial, int batch, int C, int len,
                     float eps, float* __restrict__ mean, float* __restrict__ var,
                     float* __restrict__ inv) {
  __shared__ double sh[kFinS][kFinC];
  __shared__ double mu_sh[kFinC];
  const int c = blockIdx.x * kFinC + threadIdx.x;
  const long long rows = (long long)batch * C;
  const double n = (double)batch * (double)len;
  double acc = 0.0;
  if (c < C)
    for (int b = threadIdx.y; b < batch; b += kFinS) acc += partial[(long long)b * C + c];
  sh[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0) mu_sh[threadIdx.x] = slices_total(sh) / n;
  __syncthreads();
  const double mu = mu_sh[threadIdx.x];
  acc = 0.0;
  if (c < C) {
    for (int b = threadIdx.y; b < batch; b += kFinS) {
      const long long i = (long long)b * C + c;
      const float s = partial[i];
      const float m = __fdiv_rn(s, (float)len);
      const double d = (double)m - mu;
      acc += (double)partial[rows + i]
             + d * (2.0 * ((double)s - (double)len * (double)m) + (double)len * d);
    }
  }
  sh[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y != 0 || c >= C) return;
  const double v = fmax(slices_total(sh) / n, 0.0);
  mean[c] = (float)mu;
  var[c] = (float)v;
  inv[c] = (float)(1.0 / sqrt(v + (double)eps));
}

// Forward, apply: y = leaky(z) with the batch statistics.
template <typename T>
__global__ void __launch_bounds__(kThreads)
tdnn_apply_kernel(const T* __restrict__ x, const float* __restrict__ conv_bias,
                  const float* __restrict__ mean, const float* __restrict__ inv,
                  const float* __restrict__ scale, const float* __restrict__ bias, float slope,
                  T* __restrict__ y, long long rows, int C, int len) {
  const int lane = threadIdx.x & 31;
  for (long long r = first_row(); r < rows; r += row_stride()) {
    const int c = (int)(r % C);
    const Channel k = channel<T>(__ldg(conv_bias + c), __ldg(mean + c), __ldg(inv + c),
                                 __ldg(scale + c), __ldg(bias + c));
    const T* xr = x + r * len;
    T* yr = y + r * len;
#pragma unroll 4
    for (int t = lane; t < len; t += 32)
      st(yr + t, leaky<T>(chain<T>(biased<T>(ld(xr + t), k.cb), k).z, slope));
  }
}

// Eval: the apply with the running statistics, inv = rsqrtf(var + eps) as
// the eager rsqrt computes it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
tdnn_eval_kernel(const T* __restrict__ x, const float* __restrict__ conv_bias,
                 const float* __restrict__ mean, const float* __restrict__ var, float eps,
                 const float* __restrict__ scale, const float* __restrict__ bias, float slope,
                 T* __restrict__ y, long long rows, int C, int len) {
  const int lane = threadIdx.x & 31;
  for (long long r = first_row(); r < rows; r += row_stride()) {
    const int c = (int)(r % C);
    const Channel k = channel<T>(__ldg(conv_bias + c), __ldg(mean + c),
                                 rsqrtf(__fadd_rn(__ldg(var + c), eps)), __ldg(scale + c),
                                 __ldg(bias + c));
    const T* xr = x + r * len;
    T* yr = y + r * len;
#pragma unroll 4
    for (int t = lane; t < len; t += 32)
      st(yr + t, leaky<T>(chain<T>(biased<T>(ld(xr + t), k.cb), k).z, slope));
  }
}

// The backward's per-element gradients, as autograd of the eager ops forms
// them in T: gz through the LeakyReLU, gy1 = gz * scale, ga = gy1 * inv.
struct Grads {
  float gz, gy1, ga;
};

template <typename T>
__device__ __forceinline__ Grads grads(const Chain& c, float g, const Channel& k, float slope) {
  Grads d;
  d.gz = c.z > 0.f ? g : rt<T>(__fmul_rn(g, slope));
  d.gy1 = rt<T>(__fmul_rn(d.gz, k.sc));
  d.ga = rt<T>(__fmul_rn(d.gy1, k.iv));
  return d;
}

constexpr int kBwdSums = 5;   // sum gz, sum gz*y1, sum gy1*a, sum ga, sum (x - mean)

// Backward, partial pass: per row, partial[k][row] for the kBwdSums sums.
template <typename T>
__global__ void __launch_bounds__(kThreads)
tdnn_bwd_stats_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const float* __restrict__ conv_bias, const float* __restrict__ mean,
                      const float* __restrict__ inv, const float* __restrict__ scale,
                      const float* __restrict__ bias, float slope, float* __restrict__ partial,
                      long long rows, int C, int len) {
  const int lane = threadIdx.x & 31;
  for (long long r = first_row(); r < rows; r += row_stride()) {
    const int c = (int)(r % C);
    const Channel k = channel<T>(__ldg(conv_bias + c), __ldg(mean + c), __ldg(inv + c),
                                 __ldg(scale + c), __ldg(bias + c));
    const T* xr = x + r * len;
    const T* gr = dy + r * len;
    float s[kBwdSums] = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int t = lane; t < len; t += 32) {
      const float xv = biased<T>(ld(xr + t), k.cb);
      const Chain ch = chain<T>(xv, k);
      const Grads d = grads<T>(ch, ld(gr + t), k, slope);
      s[0] = __fadd_rn(s[0], d.gz);
      s[1] = __fadd_rn(s[1], rt<T>(__fmul_rn(d.gz, ch.y1)));
      s[2] = __fadd_rn(s[2], rt<T>(__fmul_rn(d.gy1, ch.a)));
      s[3] = __fadd_rn(s[3], d.ga);
      s[4] = __fadd_rn(s[4], __fsub_rn(xv, k.m32));
    }
#pragma unroll
    for (int j = 0; j < kBwdSums; ++j) {
      const float v = warp_sum(s[j]);
      if (lane == 0) partial[j * rows + r] = v;
    }
  }
}

// Backward, finalize: autograd's chain through the statistics, per
// channel. sums[2][C] = (dbias, dscale), each the T-rounded sum (the
// gradient of scale and bias cast to T); coef[2][C] = (g_sq, g_mean / n):
// the f32 gradient of x through the statistics is g_sq * 2 (x - mean) +
// g_mean / n, with
//   g_inv = T(sum gy1*a), g_var = -0.5 g_inv inv^3, g_sq = g_var / n,
//   g_mean = T(-sum ga) - g_sq * 2 sum (x - mean).
template <typename T>
__global__ void __launch_bounds__(kFinC * kFinS)
tdnn_bwd_finalize_kernel(const float* __restrict__ partial, int batch, int C, int len,
                         const float* __restrict__ inv, float* __restrict__ sums,
                         float* __restrict__ coef) {
  __shared__ double sh[kBwdSums][kFinS][kFinC];
  const int c = blockIdx.x * kFinC + threadIdx.x;
  const long long rows = (long long)batch * C;
  double acc[kBwdSums] = {0.0, 0.0, 0.0, 0.0, 0.0};
  if (c < C) {
    for (int i = threadIdx.y; i < batch; i += kFinS) {
#pragma unroll
      for (int j = 0; j < kBwdSums; ++j) acc[j] += partial[j * rows + (long long)i * C + c];
    }
  }
#pragma unroll
  for (int j = 0; j < kBwdSums; ++j) sh[j][threadIdx.y][threadIdx.x] = acc[j];
  __syncthreads();
  if (threadIdx.y != 0 || c >= C) return;
  float t[kBwdSums];
#pragma unroll
  for (int j = 0; j < kBwdSums; ++j) t[j] = (float)slices_total(sh[j]);
  const float n = (float)((double)batch * (double)len);
  const float iv = inv[c];
  const float g_inv = rt<T>(t[2]);
  const float g_var = __fmul_rn(__fmul_rn(-0.5f, g_inv), __fmul_rn(__fmul_rn(iv, iv), iv));
  const float g_sq = __fdiv_rn(g_var, n);
  const float g_mean = __fadd_rn(rt<T>(-t[3]), -__fmul_rn(g_sq, __fmul_rn(2.f, t[4])));
  sums[c] = rt<T>(t[0]);
  sums[C + c] = rt<T>(t[1]);
  coef[c] = g_sq;
  coef[C + c] = __fdiv_rn(g_mean, n);
}

// Backward, apply: dx = T(ga + T(g_sq * 2 (x - mean) + g_mean / n)), the
// two gradients of x that autograd adds: through the normalisation in T and
// through the f32 statistics; and per row, cb_partial[row] = sum dx (as
// stored), for the conv bias's gradient.
template <typename T>
__global__ void __launch_bounds__(kThreads)
tdnn_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const float* __restrict__ conv_bias, const float* __restrict__ mean,
                      const float* __restrict__ inv, const float* __restrict__ scale,
                      const float* __restrict__ bias, const float* __restrict__ coef,
                      float slope, T* __restrict__ dx, float* __restrict__ cb_partial,
                      long long rows, int C, int len) {
  const int lane = threadIdx.x & 31;
  for (long long r = first_row(); r < rows; r += row_stride()) {
    const int c = (int)(r % C);
    const Channel k = channel<T>(__ldg(conv_bias + c), __ldg(mean + c), __ldg(inv + c),
                                 __ldg(scale + c), __ldg(bias + c));
    const float g_sq = __ldg(coef + c), g_mean_n = __ldg(coef + C + c);
    const T* xr = x + r * len;
    const T* gr = dy + r * len;
    T* dr = dx + r * len;
    float s = 0.f;
#pragma unroll 4
    for (int t = lane; t < len; t += 32) {
      const float xv = biased<T>(ld(xr + t), k.cb);
      const Grads d = grads<T>(chain<T>(xv, k), ld(gr + t), k, slope);
      const float g_stats =
          __fadd_rn(__fmul_rn(g_sq, __fmul_rn(2.f, __fsub_rn(xv, k.m32))), g_mean_n);
      const float v = rt<T>(__fadd_rn(d.ga, rt<T>(g_stats)));
      st(dr + t, v);
      s = __fadd_rn(s, v);
    }
    s = warp_sum(s);
    if (lane == 0) cb_partial[r] = s;
  }
}

// Backward, the conv bias's gradient: dconv_bias[c] = T(sum of the channel's
// dx), the sum that the convolution's backward takes of its output's
// gradient, rounded as the gradient of the bias cast to T.
template <typename T>
__global__ void __launch_bounds__(kFinC * kFinS)
tdnn_bwd_cbias_kernel(const float* __restrict__ cb_partial, int batch, int C,
                      float* __restrict__ dconv_bias) {
  __shared__ double sh[kFinS][kFinC];
  const int c = blockIdx.x * kFinC + threadIdx.x;
  double acc = 0.0;
  if (c < C)
    for (int i = threadIdx.y; i < batch; i += kFinS) acc += cb_partial[(long long)i * C + c];
  sh[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y != 0 || c >= C) return;
  dconv_bias[c] = rt<T>((float)slices_total(sh));
}

int row_grid(long long rows) {
  const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  return (int)(blocks < kMaxGrid ? (blocks > 0 ? blocks : 1) : kMaxGrid);
}

int finalize_blocks(int C) { return (C + kFinC - 1) / kFinC; }

// Calls f(T{}) with T the activation type that is_bf16 selects.
template <typename F>
void with_type(int is_bf16, F&& f) {
  if (is_bf16)
    f(__nv_bfloat16{});
  else
    f(float{});
}

}  // namespace

extern "C" {

// is_bf16 selects __nv_bfloat16 activations (else float); rows = B * C and
// len = T of the (B, C, T) activation. Every function launches one kernel
// on `stream` and returns cudaGetLastError().

int tdnn_bn_stats(const void* x, int is_bf16, const float* conv_bias, float* partial,
                  long long rows, int C, int len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  with_type(is_bf16, [&](auto t) {
    using T = decltype(t);
    tdnn_stats_kernel<T><<<row_grid(rows), kThreads, 0, s>>>(
        static_cast<const T*>(x), conv_bias, partial, rows, C, len);
  });
  return (int)cudaGetLastError();
}

int tdnn_bn_finalize(const float* partial, int batch, int C, int len, float eps,
                     float* mean, float* var, float* inv, void* stream) {
  tdnn_finalize_kernel<<<finalize_blocks(C), dim3(kFinC, kFinS), 0,
                         static_cast<cudaStream_t>(stream)>>>(
      partial, batch, C, len, eps, mean, var, inv);
  return (int)cudaGetLastError();
}

int tdnn_bn_act_apply(const void* x, int is_bf16, const float* conv_bias, const float* mean,
                      const float* inv, const float* scale, const float* bias, float slope,
                      void* y, long long rows, int C, int len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  with_type(is_bf16, [&](auto t) {
    using T = decltype(t);
    tdnn_apply_kernel<T><<<row_grid(rows), kThreads, 0, s>>>(
        static_cast<const T*>(x), conv_bias, mean, inv, scale, bias, slope,
        static_cast<T*>(y), rows, C, len);
  });
  return (int)cudaGetLastError();
}

int tdnn_bn_act_eval(const void* x, int is_bf16, const float* conv_bias, const float* mean,
                     const float* var, float eps, const float* scale, const float* bias,
                     float slope, void* y, long long rows, int C, int len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  with_type(is_bf16, [&](auto t) {
    using T = decltype(t);
    tdnn_eval_kernel<T><<<row_grid(rows), kThreads, 0, s>>>(
        static_cast<const T*>(x), conv_bias, mean, var, eps, scale, bias, slope,
        static_cast<T*>(y), rows, C, len);
  });
  return (int)cudaGetLastError();
}

int tdnn_bn_act_bwd_stats(const void* x, const void* dy, int is_bf16, const float* conv_bias,
                          const float* mean, const float* inv, const float* scale,
                          const float* bias, float slope, float* partial, long long rows, int C,
                          int len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  with_type(is_bf16, [&](auto t) {
    using T = decltype(t);
    tdnn_bwd_stats_kernel<T><<<row_grid(rows), kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), conv_bias, mean, inv, scale,
        bias, slope, partial, rows, C, len);
  });
  return (int)cudaGetLastError();
}

int tdnn_bn_act_bwd_finalize(const float* partial, int is_bf16, int batch, int C, int len,
                             const float* inv, float* sums, float* coef, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  with_type(is_bf16, [&](auto t) {
    tdnn_bwd_finalize_kernel<decltype(t)><<<finalize_blocks(C), dim3(kFinC, kFinS), 0, s>>>(
        partial, batch, C, len, inv, sums, coef);
  });
  return (int)cudaGetLastError();
}

int tdnn_bn_act_bwd_apply(const void* x, const void* dy, int is_bf16, const float* conv_bias,
                          const float* mean, const float* inv, const float* scale,
                          const float* bias, const float* coef, float slope, void* dx,
                          float* cb_partial, long long rows, int C, int len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  with_type(is_bf16, [&](auto t) {
    using T = decltype(t);
    tdnn_bwd_apply_kernel<T><<<row_grid(rows), kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), conv_bias, mean, inv, scale,
        bias, coef, slope, static_cast<T*>(dx), cb_partial, rows, C, len);
  });
  return (int)cudaGetLastError();
}

int tdnn_bn_act_bwd_cbias(const float* cb_partial, int is_bf16, int batch, int C,
                          float* dconv_bias, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  with_type(is_bf16, [&](auto t) {
    tdnn_bwd_cbias_kernel<decltype(t)><<<finalize_blocks(C), dim3(kFinC, kFinS), 0, s>>>(
        cb_partial, batch, C, dconv_bias);
  });
  return (int)cudaGetLastError();
}

}  // extern "C"
