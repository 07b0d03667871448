// The weight gradient of the Lipreading frontend's Conv3d for Hopper
// (sm_90a), in FP32, with a plain C interface for ctypes.
//
// The conv is Conv3d(1 -> C, (5, 7, 7), stride (1, 2, 2), pad (2, 3, 3), no
// bias) over a (B, T, H, W) clip, C = 64 before the ResNet trunk and 24
// before the ShuffleNetV2 one. Its weight gradient is
//
//   dW[co, kt, kh, kw] = sum over b, t, ho, wo of
//                        dY[b, t, ho, wo, co] * x[b, t+kt-2, 2ho+kh-3, 2wo+kw-3]
//
// with x zero outside the clip: a product of M = C channels, N = 245 taps
// and a reduction over K = B*T*Ho*Wo positions (7.19 M at bs 128 x 29 x 88 x
// 88). dY is channels-last (B, T, Ho, Wo, C), as the fused BN+PReLU
// backward leaves it; dW is (C, 1, 5, 7, 7).
//
// It replaces no TPU kernel: the JAX package leaves this conv to XLA, in a
// space-to-depth form (deeplip_tpu/ops/video.py: frontend_conv3d_s2d). It is
// here because cuDNN's FP32 weight gradient of this shape (a 1-channel
// input, a 7.2 M-long reduction, a 15,680-weight output) took 55 % of the
// f32 Lipreading train step, at under 1 % of its bound.
//
// What bounds it on this card: FP32 operations. 2*64*245*7.19 M = 225.4
// GFLOP is 3.36 ms at 67 TFLOP/s; its bytes (dY 1.84 GB, x 115 MB) take
// 0.58 ms at 3.35 TB/s. The recipe is FP32 (TF32 off), so every product is
// a plain FFMA on the CUDA cores.
//
// Design. An implicit GEMM, split over the reduction. The reduction runs
// over units (b, band, t): `rows` output rows of frame t of clip b. A
// persistent grid of (SMs x resident blocks) blocks takes a static, equal
// share of the units in (b, band, t) order, so a block walks runs of
// consecutive frames of one clip's band. Each thread owns one tap row
// (kt, kh) and eight channels: 8 x 7 accumulators (kw = 0..6) held in
// registers over all the block's units, 35 x C/8 threads covering all
// C x 245 weights with no padding. Per unit the block stages dY's band
// (double-buffered) and keeps a ring of six input-frame halos, 2 rows + 5
// rows of 2 Wo + 8 floats (Wo rounded up to four) with the zero padding
// written in, so each input frame is staged once and serves all five kt
// taps of the five output frames that read it; the next unit's band and
// frame are copied (cp.async) while this one computes. A thread steps over four output columns at a time: sixteen
// staged x values (four 16-byte reads, the seven taps of each of the four
// columns at stride 2) and two 16-byte dY reads a column feed 224 FFMAs,
// so a dY float feeds 7 FFMAs and an x float 14. Threads of a warp are
// eight channel groups of four tap rows, so a dY read is eight distinct 16-
// byte words (the two halves of a group are swapped in every other group of
// four, which puts them in eight distinct bank quads) and an x read four,
// broadcast: one shared-memory wavefront each, 12 a step of 224 FFMAs.
// Each block writes its C x 245 sums to its own slab of a scratch tensor,
// and a second pass adds the slabs in block order: no atomics, so the
// result is the same bit for bit from run to run and under graph replay on
// one card.

#include <cuda_runtime.h>

namespace {

constexpr int kKT = 5, kKH = 7, kKW = 7;
constexpr int kTaps = kKT * kKH * kKW;  // 245
constexpr int kTapRows = kKT * kKH;     // 35 (kt, kh) rows: a thread owns one
constexpr int kSlots = 6;               // staged frames: a unit's five and the next one
constexpr int kCols = 4;                // output columns a thread steps over at once
constexpr int kMaxRows = 4;             // most output rows of a band
// the shared memory a block aims at, which leaves room for two blocks of
// 64 channels on an SM; a shape whose one-row band needs more takes up to
// the most a block may have
constexpr long long kSmemTarget = 80 * 1024;
constexpr long long kSmemMax = 227 * 1024;
constexpr int kSumThreads = 256;

struct Plan {
  int B, T, H, W, Ho, Wo;
  int cols;         // output columns a staged row holds: Wo rounded up to kCols
  int rows;         // output rows of a band
  int bands;        // ceil(Ho / rows)
  int xrows;        // staged input rows of a frame: 2 rows + 5
  int xstride;      // floats of a staged input row
  long long units;  // B * bands * T
};

struct Unit {
  int b, band, t;
};

__device__ __forceinline__ Unit unit_at(long long u, const Plan& p) {
  const long long clip_band = u / p.T;
  Unit r;
  r.t = (int)(u - clip_band * p.T);
  r.b = (int)(clip_band / p.bands);
  r.band = (int)(clip_band - (long long)r.b * p.bands);
  return r;
}

// the ring slot of input frame ti (ti >= -2)
__device__ __forceinline__ int slot_of(int ti) { return (ti + kSlots) % kSlots; }

// four floats from 16-byte aligned shared memory
__device__ __forceinline__ void lds4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

// src-size 0 writes zero bytes and reads nothing
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// dY's band of unit u: `rows` rows of Wo pixels of C channels, contiguous in
// dY, each row staged as `cols` pixels (zeros past Wo). Channel group g's two
// 16-byte halves go to g*8 + 4*(h ^ ((g >> 2) & 1)).
template <int C>
__device__ void stage_dy(float* dst, const float* __restrict__ dy, const Plan& p, Unit u) {
  constexpr int Q = C / 4;  // 16-byte words a pixel
  const int ho0 = u.band * p.rows;
  const int n = min(p.rows, p.Ho - ho0) * p.cols * Q;
  const float* src = dy + (((long long)u.b * p.T + u.t) * p.Ho + ho0) * p.Wo * C;
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    const int pix = q / Q, j = q - pix * Q;
    const int r = pix / p.cols, wo = pix - r * p.cols;
    const int g = j >> 1, h = j & 1;
    const bool valid = wo < p.Wo;
    cp_async16(dst + pix * C + g * 8 + 4 * (h ^ ((g >> 2) & 1)),
               valid ? src + ((long long)r * p.Wo + wo) * C + 4 * j : dy, valid);
  }
}

// input frame ti of clip b around band `band`: rows 2*ho0-3 .. 2*ho0+2*rows+1,
// each as 2*cols + 8 floats, column c at c + 4 and zeros outside 0..W-1;
// rows and frames outside the clip are zeros. Rows of a multiple of four
// pixels are copied 16 bytes at a time, others 4.
__device__ void stage_x(float* dst, const float* __restrict__ x, const Plan& p, int b, int ti,
                        int band) {
  const int h0 = 2 * band * p.rows - 3;
  const int width = 2 * p.cols + 8;
  const bool frame = ti >= 0 && ti < p.T;
  const float* src = x + ((long long)b * p.T + (frame ? ti : 0)) * p.H * p.W;
  if (p.W % 4 == 0) {
    const int words = width / 4, n = p.xrows * words;
    for (int q = threadIdx.x; q < n; q += blockDim.x) {
      const int r = q / words, k = q - r * words;
      const int hi = h0 + r;
      const bool valid = frame && hi >= 0 && hi < p.H && k > 0 && k <= p.W / 4;
      cp_async16(dst + r * p.xstride + 4 * k,
                 valid ? src + (long long)hi * p.W + 4 * (k - 1) : x, valid);
    }
  } else {
    const int n = p.xrows * width;
    for (int q = threadIdx.x; q < n; q += blockDim.x) {
      const int r = q / width, k = q - r * width;
      const int hi = h0 + r, c = k - 4;
      const bool valid = frame && hi >= 0 && hi < p.H && c >= 0 && c < p.W;
      cp_async4(dst + r * p.xstride + k, valid ? src + (long long)hi * p.W + c : x, valid);
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kTapRows * (C / 8), C == 64 ? 2 : 3)
conv3d_wgrad_kernel(const float* __restrict__ dy, const float* __restrict__ x,
                    float* __restrict__ partial, Plan p) {
  constexpr int G = C / 8;  // channel groups of eight
  extern __shared__ __align__(16) float smem[];
  const int band_floats = p.rows * p.cols * C;
  const int slot_floats = p.xrows * p.xstride;
  float* sdy = smem;                   // two bands of dY
  float* sx = smem + 2 * band_floats;  // kSlots frames of x

  const int cg = threadIdx.x % G, tap_row = threadIdx.x / G;
  const int kt = tap_row / kKH, kh = tap_row - kt * kKH;
  const int swz = (cg >> 2) & 1;
  const int d0 = cg * 8 + 4 * swz, d1 = cg * 8 + 4 * (swz ^ 1);

  float acc[8][kKW];
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int k = 0; k < kKW; ++k) acc[c][k] = 0.f;

  const long long u0 = p.units * blockIdx.x / gridDim.x;
  const long long u1 = p.units * (blockIdx.x + 1) / gridDim.x;
  if (u0 < u1) {
    const Unit first = unit_at(u0, p);
    stage_dy<C>(sdy, dy, p, first);
    for (int dt = -2; dt <= 2; ++dt)
      stage_x(sx + slot_of(first.t + dt) * slot_floats, x, p, first.b, first.t + dt, first.band);
    cp_async_commit();
  }
  for (long long u = u0; u < u1; ++u) {
    const Unit cur = unit_at(u, p);
    const int buf = (int)((u - u0) & 1);
    cp_async_wait_all();
    __syncthreads();  // this unit is staged, and every thread is done with the last one
    // the next unit: its dY band, and its new frame if it carries on this run;
    // a new run's five frames are staged once this unit is done with the ring
    bool new_run = false;
    Unit nxt = cur;
    if (u + 1 < u1) {
      nxt = unit_at(u + 1, p);
      new_run = !(nxt.b == cur.b && nxt.band == cur.band && nxt.t == cur.t + 1);
      stage_dy<C>(sdy + (buf ^ 1) * band_floats, dy, p, nxt);
      if (!new_run)
        stage_x(sx + slot_of(nxt.t + 2) * slot_floats, x, p, nxt.b, nxt.t + 2, nxt.band);
      cp_async_commit();
    }
    const int rows = min(p.rows, p.Ho - cur.band * p.rows);
    const float* xs = sx + slot_of(cur.t + kt - 2) * slot_floats + kh * p.xstride;
    const float* ds = sdy + buf * band_floats;
    for (int r = 0; r < rows; ++r) {
      const float* xr = xs + 2 * r * p.xstride;
      const float* dr = ds + r * p.cols * C;
      for (int w0 = 0; w0 < p.cols; w0 += kCols) {
        // columns 2*w0-4 .. 2*w0+11: tap kw of column w0+j is xv[2j + kw + 1]
        float xv[16];
        lds4(xr + 2 * w0, xv);
        lds4(xr + 2 * w0 + 4, xv + 4);
        lds4(xr + 2 * w0 + 8, xv + 8);
        lds4(xr + 2 * w0 + 12, xv + 12);
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          float d[8];
          lds4(dr + (w0 + j) * C + d0, d);
          lds4(dr + (w0 + j) * C + d1, d + 4);
#pragma unroll
          for (int c = 0; c < 8; ++c)
#pragma unroll
            for (int k = 0; k < kKW; ++k) acc[c][k] = fmaf(d[c], xv[2 * j + k + 1], acc[c][k]);
        }
      }
    }
    if (new_run) {
      __syncthreads();  // every thread is done with the ring
      for (int dt = -2; dt <= 2; ++dt)
        stage_x(sx + slot_of(nxt.t + dt) * slot_floats, x, p, nxt.b, nxt.t + dt, nxt.band);
      cp_async_commit();
    }
  }
  float* out = partial + (long long)blockIdx.x * C * kTaps;
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int k = 0; k < kKW; ++k) out[(cg * 8 + c) * kTaps + tap_row * kKW + k] = acc[c][k];
}

// dW[i] = the blocks' slabs added in block order, from 0.f
__global__ void __launch_bounds__(kSumThreads)
conv3d_wgrad_sum_kernel(const float* __restrict__ partial, float* __restrict__ dw, int n,
                        int blocks) {
  const int i = blockIdx.x * kSumThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
#pragma unroll 8
  for (int g = 0; g < blocks; ++g) s += partial[(long long)g * n + i];
  dw[i] = s;
}

long long smem_bytes(const Plan& p, int C) {
  return 4LL * (2LL * p.rows * p.cols * C + (long long)kSlots * p.xrows * p.xstride);
}

// the plan of a shape with `rows` output rows a band (0: choose), or false
bool make_plan(int B, int T, int H, int W, int C, int rows, Plan* p) {
  if (B < 1 || T < 1 || H < 1 || W < 1 || (C != 24 && C != 64)) return false;
  p->B = B;
  p->T = T;
  p->H = H;
  p->W = W;
  p->Ho = (H - 1) / 2 + 1;
  p->Wo = (W - 1) / 2 + 1;
  p->cols = (p->Wo + kCols - 1) / kCols * kCols;
  // a row stride of 4 mod 8 floats puts the tap rows of a warp in distinct bank quads
  p->xstride = 2 * p->cols + 12;
  auto fit = [&](int r) {
    p->rows = r;
    p->xrows = 2 * r + 5;
    return smem_bytes(*p, C);
  };
  if (rows == 0) {
    rows = 1;
    for (int r = kMaxRows; r > 1; --r)
      if (r <= p->Ho && fit(r) <= kSmemTarget) {
        rows = r;
        break;
      }
  }
  if (rows < 1 || rows > kMaxRows || fit(rows) > kSmemMax) return false;
  p->bands = (p->Ho + rows - 1) / rows;
  p->units = (long long)B * p->bands * T;
  return true;
}

template <int C>
cudaError_t set_smem(const Plan& p) {
  return cudaFuncSetAttribute(conv3d_wgrad_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes(p, C));
}

}  // namespace

extern "C" {

// The plan of a (B, T, H, W) clip and C channels on the current device:
// `rows` output rows a band and `blocks`, the grid (SMs x resident blocks,
// at most one a unit), which is also the number of C x 245 slabs the
// scratch tensor of conv3d_wgrad must hold. cudaErrorInvalidValue for a
// shape the kernel does not take: C other than 24 or 64, an empty clip, or
// frames so wide that a one-row band does not fit in shared memory.
int conv3d_wgrad_plan(int B, int T, int H, int W, int C, int* blocks, int* rows) {
  Plan p;
  if (!make_plan(B, T, H, W, C, 0, &p)) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = C == 64 ? set_smem<64>(p) : set_smem<24>(p);
  if (e == cudaSuccess)
    e = C == 64 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &per_sm, conv3d_wgrad_kernel<64>, kTapRows * 8, smem_bytes(p, 64))
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &per_sm, conv3d_wgrad_kernel<24>, kTapRows * 3, smem_bytes(p, 24));
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long g = (long long)sms * per_sm;
  *blocks = (int)(g < p.units ? g : p.units);
  *rows = p.rows;
  return 0;
}

// dW (C, 1, 5, 7, 7) of f32 dY (B, T, Ho, Wo, C) and x (B, T, H, W), both
// contiguous and 16-byte aligned, with the plan's `blocks` and `rows`;
// `partial` holds blocks x C x 245 floats. Two launches on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape or plan the
// kernel does not take.
int conv3d_wgrad(const float* dy, const float* x, float* partial, float* dw, int B, int T, int H,
                 int W, int C, int blocks, int rows, void* stream) {
  Plan p;
  if (!make_plan(B, T, H, W, C, rows, &p) || blocks < 1 || blocks > p.units)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)smem_bytes(p, C);
  cudaError_t e = C == 64 ? set_smem<64>(p) : set_smem<24>(p);
  if (e != cudaSuccess) return (int)e;
  if (C == 64)
    conv3d_wgrad_kernel<64><<<blocks, kTapRows * 8, smem, s>>>(dy, x, partial, p);
  else
    conv3d_wgrad_kernel<24><<<blocks, kTapRows * 3, smem, s>>>(dy, x, partial, p);
  const int n = C * kTaps;
  conv3d_wgrad_sum_kernel<<<(n + kSumThreads - 1) / kSumThreads, kSumThreads, 0, s>>>(
      partial, dw, n, blocks);
  return (int)cudaGetLastError();
}

}  // extern "C"
