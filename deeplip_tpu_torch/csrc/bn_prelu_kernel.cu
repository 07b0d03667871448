// Fused train-mode BatchNorm + per-channel PReLU for Hopper (sm_90a):
// forward (K3) and backward (K4), with a plain C interface for ctypes.
//
// Replaces deeplip_tpu/ops/pallas/bn_prelu_kernel.py: _stats_kernel (:56)
// and _apply_kernel (:70) for the forward, _bwd_stats_kernel (:80) and
// _bwd_apply_kernel (:102) for the backward.
//
// Input: a channels-last activation seen as a row-major (rows, C) matrix,
// C a multiple of 4 and at most 1024, in f32 or bf16; the per-channel
// parameters and every statistic are f32.
//
// Forward:  mean, var = max(E[x^2] - mean^2, 0), inv = rsqrt(var + eps)
//           z = ((x - mean) * inv) * scale + bias;  y = z >= 0 ? z : alpha * z
// Backward: dz = z < 0 ? alpha * dy : dy
//           [sum dz, sum dz*xhat, sum_{z<0} dy*z] = (dbias, dscale, dalpha)
//           dx = (inv * scale) * (dz - mean(dz) - xhat * mean(dz*xhat))
//
// What bounds it on this card: bytes. Exact batch statistics need a full
// read of x before the first y can be written, so the forward moves at
// least 3|x| (x for the sums; x again and y) and the backward 5|x| (x and dy
// for the sums; x, dy and dx). A few flops per element leave the CUDA
// cores idle.
//
// Design. The TPU kernels carry their sums across a sequential grid in
// VMEM scratch. Here blocks run in parallel and in no order, so each
// reduction is a partial pass and a finalize pass. In the partial pass every
// block owns a contiguous chunk of rows and writes its sums to its own slot
// of a partial buffer (no atomics); each thread owns four channels (one
// float4, or four bf16 in 8 bytes) and strides down the rows, so a warp
// reads whole contiguous rows, and the block's row slots are added in
// shared memory in a fixed order. The finalize pass adds the chunk slots in
// double, in a fixed order. So repeated runs give bit-equal statistics.
//
// Under a process group (data-parallel training, one process per card) the
// statistics are those of the global batch. Each finalize then runs as two
// passes: the chunk totals to float64 (2, C) or (3, C), added in the same
// slot order, and, after the caller has all-reduced those totals across
// the processes (NCCL on the card), the totals to the statistics with the
// global row count. The backward keeps its local totals, cast to f32, as
// this process's dscale, dbias and dalpha: the one gradient all-reduce of
// the trainer sums them. The single finalize and the two passes compute
// the statistics by the same device functions, so a group of one process
// gives them bit for bit.
//
// The elementwise passes keep the per-channel constants in shared memory and
// the op order of the plain PyTorch version, with __fmul_rn / __fadd_rn so
// that nothing contracts into an FMA: y differs from the plain version's
// only through the statistics' rounding, and the backward decides z < 0
// exactly as the forward did.
//
// Eval (no TPU kernel: XLA fuses the eval-mode trunk's BN, PReLU and
// residual add): one pass over the activation with the running statistics,
// in one of three forms, for the ResNet trunk's BN + PReLU sites when no
// gradient is needed (a frozen encoder, extraction, serving):
//   plain:             y = prelu(bn(a))
//   identity residual: y = prelu(bn(a) + r)
//   BN residual:       y = prelu(bn(a) + bn_d(b))
// with bn(a) = ((a - mean) * rsqrt(var + eps)) * scale + bias. Each op is
// rounded where the eager ops of TorchBatchNorm, the residual add and PReLU
// round it, in the activation's type (f32, or bf16 after every op, with the
// constants cast to bf16 as the eager ops cast them), so y is the eager ops'
// result bit for bit. Eagerly the same sites make seven to thirteen passes,
// 58 to 102 bytes an f32 element; here 8 (plain) or 12 (residual).
// What bounds it on this card: bytes. Each thread keeps one group of V
// channels (16 bytes: four f32 or eight bf16) and their constants in
// registers, and strides down the rows of a persistent grid sized to the
// SMs, with several rows' loads in flight before any store.

#include "vec4.cuh"

namespace {

constexpr int kThreads = 256;   // partial and elementwise blocks
constexpr int kFinC = 32;       // finalize: channels per block
constexpr int kFinS = 32;       // finalize: chunk slices per block
constexpr int kMaxGrid = 4096;  // elementwise passes stride over the rest

// xhat = (x - mean) * inv and z = xhat * scale + bias, rounded op by op
__device__ __forceinline__ float bn_norm(float x, float mean, float inv) {
  return __fmul_rn(__fsub_rn(x, mean), inv);
}

__device__ __forceinline__ float bn_affine(float xhat, float scale, float bias) {
  return __fadd_rn(__fmul_rn(xhat, scale), bias);
}

// Adds sh[k][slot][C] over the slots in slot order and writes out[k][C].
template <int K>
__device__ __forceinline__ void reduce_slots(const float* sh, int slots, int C,
                                             float* out) {
  for (int i = threadIdx.x; i < K * C; i += blockDim.x) {
    const int k = i / C, c = i - k * C;
    float s = 0.f;
    for (int r = 0; r < slots; ++r) s += sh[(k * slots + r) * C + c];
    out[i] = s;
  }
}

// K3, partial pass: per-chunk [sum x, sum x^2] into partial[chunk][2][C].
template <typename T>
__global__ void __launch_bounds__(kThreads)
stats_partial_kernel(const T* __restrict__ x, float* __restrict__ partial,
                     long long rows, int C, long long rows_per_chunk) {
  extern __shared__ float sh[];  // [2][slots][C]
  const int groups = C / 4;
  const int slots = kThreads / groups;
  const int g = threadIdx.x % groups, slot = threadIdx.x / groups;
  const long long r0 = blockIdx.x * rows_per_chunk;
  const long long r1 = min(r0 + rows_per_chunk, rows);
  if (slot < slots) {
    float s[4] = {0.f, 0.f, 0.f, 0.f}, q[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (long long r = r0 + slot; r < r1; r += slots) {
      float v[4];
      load4(x + r * C + 4 * g, v);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s[k] += v[k];
        q[k] += v[k] * v[k];
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      sh[slot * C + 4 * g + k] = s[k];
      sh[(slots + slot) * C + 4 * g + k] = q[k];
    }
  }
  __syncthreads();
  reduce_slots<2>(sh, slots, C, partial + 2LL * C * blockIdx.x);
}

// Sums partial[chunk][K][C] over the chunks for the block's kFinC channels:
// thread (x, y) adds chunks y, y + kFinS, ... in double, then row y = 0
// adds the kFinS slices in order. Returns true on the threads that hold a
// channel's totals.
template <int K>
__device__ __forceinline__ bool chunk_totals(const float* __restrict__ partial,
                                             int chunks, int C, double (&tot)[K]) {
  __shared__ double sh[K][kFinS][kFinC];
  const int c = blockIdx.x * kFinC + threadIdx.x;
  double acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0;
  if (c < C) {
    for (int i = threadIdx.y; i < chunks; i += kFinS) {
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] += partial[((long long)i * K + k) * C + c];
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) sh[k][threadIdx.y][threadIdx.x] = acc[k];
  __syncthreads();
  if (threadIdx.y != 0 || c >= C) return false;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    double s = 0.0;
    for (int j = 0; j < kFinS; ++j) s += sh[k][j][threadIdx.x];
    tot[k] = s;
  }
  return true;
}

// Channel c's mean, biased var (single pass, clamped at 0) and inv from
// its totals [sum x, sum x^2] over n rows.
__device__ __forceinline__ void stats_from(double s, double q, long long n, float eps,
                                           int c, float* mean, float* var, float* inv) {
  const double m = s / (double)n;
  const double v = fmax(q / (double)n - m * m, 0.0);
  mean[c] = (float)m;
  var[c] = (float)v;
  inv[c] = (float)(1.0 / sqrt(v + (double)eps));
}

// K3, finalize: mean, biased var and inv.
__global__ void __launch_bounds__(kFinC * kFinS)
stats_finalize_kernel(const float* __restrict__ partial, int chunks, int C,
                      long long n, float eps, float* __restrict__ mean,
                      float* __restrict__ var, float* __restrict__ inv) {
  double t[2];
  if (!chunk_totals<2>(partial, chunks, C, t)) return;
  stats_from(t[0], t[1], n, eps, blockIdx.x * kFinC + threadIdx.x, mean, var, inv);
}

// K3 under a group, first pass: the chunk totals, totals[2][C] in double.
__global__ void __launch_bounds__(kFinC * kFinS)
stats_totals_kernel(const float* __restrict__ partial, int chunks, int C,
                    double* __restrict__ totals) {
  double t[2];
  if (!chunk_totals<2>(partial, chunks, C, t)) return;
  const int c = blockIdx.x * kFinC + threadIdx.x;
  totals[c] = t[0];
  totals[C + c] = t[1];
}

// K3 under a group, second pass: the all-reduced totals over the global n.
__global__ void __launch_bounds__(kThreads)
stats_from_totals_kernel(const double* __restrict__ totals, int C, long long n, float eps,
                         float* __restrict__ mean, float* __restrict__ var,
                         float* __restrict__ inv) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < C) stats_from(totals[c], totals[C + c], n, eps, c, mean, var, inv);
}

// K3, apply: y = prelu(((x - mean) * inv) * scale + bias).
template <typename T>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const T* __restrict__ x, const float* __restrict__ mean,
             const float* __restrict__ inv, const float* __restrict__ scale,
             const float* __restrict__ bias, const float* __restrict__ alpha,
             T* __restrict__ y, long long n4, int C) {
  extern __shared__ float p[];  // mean, inv, scale, bias, alpha: [5][C]
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    p[c] = mean[c];
    p[C + c] = inv[c];
    p[2 * C + c] = scale[c];
    p[3 * C + c] = bias[c];
    p[4 * C + c] = alpha[c];
  }
  __syncthreads();
  const int groups = C / 4;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const int c0 = 4 * (int)(i % groups);
    float v[4];
    load4(x + 4 * i, v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = c0 + k;
      const float z = bn_affine(bn_norm(v[k], p[c], p[C + c]), p[2 * C + c], p[3 * C + c]);
      v[k] = z >= 0.f ? z : __fmul_rn(p[4 * C + c], z);
    }
    store4(y + 4 * i, v);
  }
}

// K4, partial pass: per-chunk [sum dz, sum dz*xhat, sum_{z<0} dy*z].
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   const float* __restrict__ mean, const float* __restrict__ inv,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   const float* __restrict__ alpha, float* __restrict__ partial,
                   long long rows, int C, long long rows_per_chunk) {
  extern __shared__ float sh[];  // [3][slots][C]
  const int groups = C / 4;
  const int slots = kThreads / groups;
  const int g = threadIdx.x % groups, slot = threadIdx.x / groups;
  const long long r0 = blockIdx.x * rows_per_chunk;
  const long long r1 = min(r0 + rows_per_chunk, rows);
  if (slot < slots) {
    float pm[4], pi[4], ps[4], pb[4], pa[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = 4 * g + k;
      pm[k] = mean[c]; pi[k] = inv[c]; ps[k] = scale[c]; pb[k] = bias[c]; pa[k] = alpha[c];
    }
    float a[4] = {0.f, 0.f, 0.f, 0.f}, b[4] = {0.f, 0.f, 0.f, 0.f},
          d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
    for (long long r = r0 + slot; r < r1; r += slots) {
      float v[4], gy[4];
      load4(x + r * C + 4 * g, v);
      load4(dy + r * C + 4 * g, gy);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float xhat = bn_norm(v[k], pm[k], pi[k]);
        const float z = bn_affine(xhat, ps[k], pb[k]);
        const bool neg = z < 0.f;
        const float dz = neg ? pa[k] * gy[k] : gy[k];
        a[k] += dz;
        b[k] += dz * xhat;
        if (neg) d[k] += gy[k] * z;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      sh[slot * C + 4 * g + k] = a[k];
      sh[(slots + slot) * C + 4 * g + k] = b[k];
      sh[(2 * slots + slot) * C + 4 * g + k] = d[k];
    }
  }
  __syncthreads();
  reduce_slots<3>(sh, slots, C, partial + 3LL * C * blockIdx.x);
}

// Channel c's (mean dz, mean dz*xhat) from its totals over n rows.
__device__ __forceinline__ void bwd_means_from(double a, double b, long long n, int C, int c,
                                               float* means) {
  means[c] = (float)(a / (double)n);
  means[C + c] = (float)(b / (double)n);
}

// Channel c's totals as the f32 (dbias, dscale, dalpha).
__device__ __forceinline__ void bwd_sums_from(const double (&t)[3], int C, int c,
                                              float* sums) {
  sums[c] = (float)t[0];
  sums[C + c] = (float)t[1];
  sums[2 * C + c] = (float)t[2];
}

// K4, finalize: sums[3][C] = (dbias, dscale, dalpha); means[2][C] =
// (mean dz, mean dz*xhat).
__global__ void __launch_bounds__(kFinC * kFinS)
bwd_finalize_kernel(const float* __restrict__ partial, int chunks, int C,
                    long long n, float* __restrict__ sums, float* __restrict__ means) {
  double t[3];
  if (!chunk_totals<3>(partial, chunks, C, t)) return;
  const int c = blockIdx.x * kFinC + threadIdx.x;
  bwd_sums_from(t, C, c, sums);
  bwd_means_from(t[0], t[1], n, C, c, means);
}

// K4 under a group, first pass: totals[3][C] in double, and this
// process's own totals as the f32 sums (its parameter gradients).
__global__ void __launch_bounds__(kFinC * kFinS)
bwd_totals_kernel(const float* __restrict__ partial, int chunks, int C,
                  double* __restrict__ totals, float* __restrict__ sums) {
  double t[3];
  if (!chunk_totals<3>(partial, chunks, C, t)) return;
  const int c = blockIdx.x * kFinC + threadIdx.x;
  totals[c] = t[0];
  totals[C + c] = t[1];
  totals[2 * C + c] = t[2];
  bwd_sums_from(t, C, c, sums);
}

// K4 under a group, second pass: the global means from the all-reduced
// totals.
__global__ void __launch_bounds__(kThreads)
bwd_from_totals_kernel(const double* __restrict__ totals, int C, long long n,
                       float* __restrict__ means) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < C) bwd_means_from(totals[c], totals[C + c], n, C, c, means);
}

// K4, apply: dx = (inv * scale) * (dz - mean(dz) - xhat * mean(dz*xhat)).
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                 const float* __restrict__ mean, const float* __restrict__ inv,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 const float* __restrict__ alpha, const float* __restrict__ means,
                 T* __restrict__ dx, long long n4, int C) {
  extern __shared__ float p[];  // mean, inv, scale, bias, alpha, m_dz, m_dzxh
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    p[c] = mean[c];
    p[C + c] = inv[c];
    p[2 * C + c] = scale[c];
    p[3 * C + c] = bias[c];
    p[4 * C + c] = alpha[c];
    p[5 * C + c] = means[c];
    p[6 * C + c] = means[C + c];
  }
  __syncthreads();
  const int groups = C / 4;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const int c0 = 4 * (int)(i % groups);
    float v[4], gy[4];
    load4(x + 4 * i, v);
    load4(dy + 4 * i, gy);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = c0 + k;
      const float xhat = bn_norm(v[k], p[c], p[C + c]);
      const float z = bn_affine(xhat, p[2 * C + c], p[3 * C + c]);
      const float dz = z < 0.f ? __fmul_rn(p[4 * C + c], gy[k]) : gy[k];
      const float r = __fsub_rn(__fsub_rn(dz, p[5 * C + c]), __fmul_rn(xhat, p[6 * C + c]));
      v[k] = __fmul_rn(__fmul_rn(p[C + c], p[2 * C + c]), r);
    }
    store4(dx + 4 * i, v);
  }
}

// ---------------------------------------------------------------- eval

// A value rounded to the activation type T, as an eager op in T rounds its
// result (T's kernels keep the same rule).
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// V channels of T in one 16-byte (or, for bf16 at a C that is no multiple
// of 8, 8-byte) load or store.
__device__ __forceinline__ void vload(const float* p, float (&v)[4]) { load4(p, v); }
__device__ __forceinline__ void vload(const __nv_bfloat16* p, float (&v)[4]) { load4(p, v); }
__device__ __forceinline__ void vload(const __nv_bfloat16* p, float (&v)[8]) { load8(p, v); }
__device__ __forceinline__ void vstore(float* p, const float (&v)[4]) { store4(p, v); }
__device__ __forceinline__ void vstore(__nv_bfloat16* p, const float (&v)[4]) { store4(p, v); }
__device__ __forceinline__ void vstore(__nv_bfloat16* p, const float (&v)[8]) { store8(p, v); }

// The pointers of one BatchNorm's running statistics and affine parameters.
struct EvalBN {
  const float *mean, *var, *scale, *bias;
  float eps;
};

// One BatchNorm's constants for a thread's V channels as its eager ops see
// them: mean, inv = rsqrtf(var + eps) (the eager rsqrt), scale and bias,
// each cast to T.
template <typename T, int V>
struct ChannelBN {
  float m[V], iv[V], sc[V], bi[V];

  __device__ __forceinline__ void load(const EvalBN& p, int c0) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      m[k] = round_to<T>(__ldg(p.mean + c0 + k));
      iv[k] = round_to<T>(rsqrtf(__fadd_rn(__ldg(p.var + c0 + k), p.eps)));
      sc[k] = round_to<T>(__ldg(p.scale + c0 + k));
      bi[k] = round_to<T>(__ldg(p.bias + c0 + k));
    }
  }

  // ((a - mean) * inv) * scale + bias, each op rounded to T
  __device__ __forceinline__ float apply(float a, int k) const {
    const float y1 = round_to<T>(__fmul_rn(round_to<T>(__fsub_rn(a, m[k])), iv[k]));
    return round_to<T>(__fadd_rn(round_to<T>(__fmul_rn(y1, sc[k])), bi[k]));
  }
};

constexpr int kPlain = 0, kIdentityResidual = 1, kBNResidual = 2;

// Eval: y = prelu(bn(a) [+ r | + bn_d(r)]) over a (rows, C) activation.
// Thread t owns channel group t % (C / V) and the rows t / (C / V), +
// slots, ...: on the first row the grid reads one contiguous span, and each
// later row moves the span by slots * C. U rows' loads go out before their
// arithmetic and stores.
template <typename T, int V, int FORM>
__global__ void __launch_bounds__(kThreads)
bn_prelu_eval_kernel(const T* __restrict__ a, const T* __restrict__ r, EvalBN bn, EvalBN bn_d,
                     const float* __restrict__ alpha, T* __restrict__ y, long long rows,
                     int C) {
  constexpr int U = FORM == kPlain ? 4 : 2;
  const int groups = C / V;
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long slots = (long long)gridDim.x * blockDim.x / groups;
  long long row = t / groups;
  if (row >= slots) return;
  const int c0 = (int)(t % groups) * V;
  ChannelBN<T, V> k0, kd;
  k0.load(bn, c0);
  if constexpr (FORM == kBNResidual) kd.load(bn_d, c0);
  float al[V];
#pragma unroll
  for (int k = 0; k < V; ++k) al[k] = round_to<T>(__ldg(alpha + c0 + k));

  auto finish = [&](float (&v)[V], const float (&w)[V]) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float z = k0.apply(v[k], k);
      if constexpr (FORM == kIdentityResidual) z = round_to<T>(__fadd_rn(z, w[k]));
      if constexpr (FORM == kBNResidual) z = round_to<T>(__fadd_rn(z, kd.apply(w[k], k)));
      v[k] = z >= 0.f ? z : round_to<T>(__fmul_rn(al[k], z));
    }
  };

  for (; row + (U - 1) * slots < rows; row += U * slots) {
    float v[U][V], w[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = (row + u * slots) * C + c0;
      vload(a + i, v[u]);
      if constexpr (FORM != kPlain) vload(r + i, w[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      finish(v[u], w[u]);
      vstore(y + (row + u * slots) * C + c0, v[u]);
    }
  }
  for (; row < rows; row += slots) {
    float v[V], w[V];
    const long long i = row * C + c0;
    vload(a + i, v);
    if constexpr (FORM != kPlain) vload(r + i, w);
    finish(v, w);
    vstore(y + i, v);
  }
}

int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 1;
  }();
  return sms;
}

// The persistent grid: as many blocks as stay resident on the SMs at once,
// fewer for a small activation, and at least one row slot for every
// channel group.
template <typename T, int V, int FORM>
int launch_eval(const void* a, const void* r, const EvalBN& bn, const EvalBN& bn_d,
                const float* alpha, void* y, long long rows, int C, cudaStream_t s) {
  static const int resident = [] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bn_prelu_eval_kernel<T, V, FORM>,
                                                  kThreads, 0);
    return n > 0 ? n : 1;
  }();
  const long long groups = C / V;
  long long blocks = (rows * groups + kThreads - 1) / kThreads;
  const long long most = (long long)sm_count() * resident;
  const long long least = (groups + kThreads - 1) / kThreads;
  blocks = blocks < most ? blocks : most;
  blocks = blocks > least ? blocks : least;
  bn_prelu_eval_kernel<T, V, FORM><<<(int)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(r), bn, bn_d, alpha, static_cast<T*>(y),
      rows, C);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_eval_form(int form, const void* a, const void* r, const EvalBN& bn,
                     const EvalBN& bn_d, const float* alpha, void* y, long long rows, int C,
                     cudaStream_t s) {
  if (form == kIdentityResidual)
    return launch_eval<T, V, kIdentityResidual>(a, r, bn, bn_d, alpha, y, rows, C, s);
  if (form == kBNResidual)
    return launch_eval<T, V, kBNResidual>(a, r, bn, bn_d, alpha, y, rows, C, s);
  return launch_eval<T, V, kPlain>(a, r, bn, bn_d, alpha, y, rows, C, s);
}

int grid_for(long long n4) {
  const long long blocks = (n4 + kThreads - 1) / kThreads;
  return (int)(blocks < kMaxGrid ? (blocks > 0 ? blocks : 1) : kMaxGrid);
}

int finalize_blocks(int C) { return (C + kFinC - 1) / kFinC; }

int channel_blocks(int C) { return (C + kThreads - 1) / kThreads; }

size_t slot_bytes(int k, int C) {
  return sizeof(float) * (size_t)k * (size_t)(kThreads / (C / 4)) * (size_t)C;
}

}  // namespace

extern "C" {

// is_bf16 selects __nv_bfloat16 activations (else float). Every function
// launches one kernel on `stream` and returns cudaGetLastError().

int bn_stats_partial(const void* x, int is_bf16, float* partial, long long rows,
                     int C, long long rows_per_chunk, int chunks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = slot_bytes(2, C);
  if (is_bf16)
    stats_partial_kernel<__nv_bfloat16><<<chunks, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), partial, rows, C, rows_per_chunk);
  else
    stats_partial_kernel<float><<<chunks, kThreads, smem, s>>>(
        static_cast<const float*>(x), partial, rows, C, rows_per_chunk);
  return (int)cudaGetLastError();
}

int bn_stats_finalize(const float* partial, int chunks, int C, long long n,
                      float eps, float* mean, float* var, float* inv, void* stream) {
  stats_finalize_kernel<<<finalize_blocks(C), dim3(kFinC, kFinS), 0,
                          static_cast<cudaStream_t>(stream)>>>(
      partial, chunks, C, n, eps, mean, var, inv);
  return (int)cudaGetLastError();
}

// The finalize split in two for a process group: chunk totals to float64,
// then (after the caller's all-reduce) totals to mean, var and inv.
int bn_stats_totals(const float* partial, int chunks, int C, double* totals,
                    void* stream) {
  stats_totals_kernel<<<finalize_blocks(C), dim3(kFinC, kFinS), 0,
                        static_cast<cudaStream_t>(stream)>>>(partial, chunks, C, totals);
  return (int)cudaGetLastError();
}

int bn_stats_from_totals(const double* totals, int C, long long n, float eps,
                         float* mean, float* var, float* inv, void* stream) {
  stats_from_totals_kernel<<<channel_blocks(C), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      totals, C, n, eps, mean, var, inv);
  return (int)cudaGetLastError();
}

int bn_prelu_apply(const void* x, int is_bf16, const float* mean, const float* inv,
                   const float* scale, const float* bias, const float* alpha,
                   void* y, long long rows, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n4 = rows * C / 4;
  const size_t smem = sizeof(float) * 5 * (size_t)C;
  if (is_bf16)
    apply_kernel<__nv_bfloat16><<<grid_for(n4), kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), mean, inv, scale, bias, alpha,
        static_cast<__nv_bfloat16*>(y), n4, C);
  else
    apply_kernel<float><<<grid_for(n4), kThreads, smem, s>>>(
        static_cast<const float*>(x), mean, inv, scale, bias, alpha,
        static_cast<float*>(y), n4, C);
  return (int)cudaGetLastError();
}

int bn_prelu_bwd_partial(const void* x, const void* dy, int is_bf16,
                         const float* mean, const float* inv, const float* scale,
                         const float* bias, const float* alpha, float* partial,
                         long long rows, int C, long long rows_per_chunk, int chunks,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = slot_bytes(3, C);
  if (is_bf16)
    bwd_partial_kernel<__nv_bfloat16><<<chunks, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy),
        mean, inv, scale, bias, alpha, partial, rows, C, rows_per_chunk);
  else
    bwd_partial_kernel<float><<<chunks, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy),
        mean, inv, scale, bias, alpha, partial, rows, C, rows_per_chunk);
  return (int)cudaGetLastError();
}

int bn_prelu_bwd_finalize(const float* partial, int chunks, int C, long long n,
                          float* sums, float* means, void* stream) {
  bwd_finalize_kernel<<<finalize_blocks(C), dim3(kFinC, kFinS), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      partial, chunks, C, n, sums, means);
  return (int)cudaGetLastError();
}

int bn_prelu_bwd_totals(const float* partial, int chunks, int C, double* totals,
                        float* sums, void* stream) {
  bwd_totals_kernel<<<finalize_blocks(C), dim3(kFinC, kFinS), 0,
                      static_cast<cudaStream_t>(stream)>>>(partial, chunks, C, totals, sums);
  return (int)cudaGetLastError();
}

int bn_prelu_bwd_from_totals(const double* totals, int C, long long n, float* means,
                             void* stream) {
  bwd_from_totals_kernel<<<channel_blocks(C), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(totals, C, n, means);
  return (int)cudaGetLastError();
}

int bn_prelu_bwd_apply(const void* x, const void* dy, int is_bf16,
                       const float* mean, const float* inv, const float* scale,
                       const float* bias, const float* alpha, const float* means,
                       void* dx, long long rows, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n4 = rows * C / 4;
  const size_t smem = sizeof(float) * 7 * (size_t)C;
  if (is_bf16)
    bwd_apply_kernel<__nv_bfloat16><<<grid_for(n4), kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy),
        mean, inv, scale, bias, alpha, means, static_cast<__nv_bfloat16*>(dx), n4, C);
  else
    bwd_apply_kernel<float><<<grid_for(n4), kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy),
        mean, inv, scale, bias, alpha, means, static_cast<float*>(dx), n4, C);
  return (int)cudaGetLastError();
}

// The eval apply. form: 0 plain, 1 identity residual (r added as it is), 2
// BN residual (bn_d applied to r first); r and the bn_d pointers are unused
// below their form. The (rows, C) activations are 16-byte aligned, C a
// multiple of 4.
int bn_prelu_eval(const void* a, const void* r, int is_bf16, int form, const float* mean,
                  const float* var, const float* scale, const float* bias, float eps,
                  const float* mean_d, const float* var_d, const float* scale_d,
                  const float* bias_d, float eps_d, const float* alpha, void* y,
                  long long rows, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const EvalBN bn{mean, var, scale, bias, eps}, bn_d{mean_d, var_d, scale_d, bias_d, eps_d};
  if (!is_bf16) return launch_eval_form<float, 4>(form, a, r, bn, bn_d, alpha, y, rows, C, s);
  if (C % 8) return launch_eval_form<__nv_bfloat16, 4>(form, a, r, bn, bn_d, alpha, y, rows, C, s);
  return launch_eval_form<__nv_bfloat16, 8>(form, a, r, bn, bn_d, alpha, y, rows, C, s);
}

}  // extern "C"
