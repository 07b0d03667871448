// The Lipreading frontend's max-pool for Hopper (sm_90a), forward and
// backward, with a plain C interface for ctypes.
//
// The kernel that benchmarks/pool_mosaic_probe.py: check (:43) was written
// for. The probe asks the TPU compiler whether a Pallas kernel could read
// and write the W axis at stride 2 (and five more layout operations) on
// (8, 22, 44, 64) bf16 blocks; the Pallas kernel itself was never written
// and the JAX model pools with nn.max_pool (models/lipreading.py:158-161).
// On this card a thread indexes the taps it needs, so the counterpart of
// the probe is the pool.
//
// Input: a channels-last activation (NT, H, W, C), contiguous, C a multiple
// of 4, in f32 or bf16. Window 3x3, stride 2, padding 1 over (H, W); taps
// outside the frame count as -inf. Output (NT, Ho, Wo, C), Ho = (H - 1) / 2
// + 1, and optionally one byte per output element: the window position
// (0..8, row-major) of its maximum.
//
// Forward:  y[n,i,j,c] = max over di,dj in 0..2 of x[n,2i-1+di,2j-1+dj,c]
//           The first maximum in row-major window order wins a tie, and a
//           NaN tap becomes the maximum and stays it (F.max_pool3d's rule:
//           take a tap when it is greater than the maximum so far or NaN).
// Backward: dx[n,h,w,c] = sum of dy over the windows whose saved position
//           is (h, w): at most two rows times two columns of windows hold a
//           pixel, added in (i, j) order in f32.
//
// What bounds it on this card: bytes. The forward reads x once and writes y
// (a quarter of x) and, when a gradient will be asked for, the positions
// (one byte per element of y); the backward reads dy and the positions and
// writes dx. A compare per tap leaves the CUDA cores idle.
//
// Design. The backward could recompute each window from x (2.25|x| bytes,
// and x, 1.8 GB at the training shape, would stay alive for it) or read a
// saved position (|x| + |y| + |y|/itemsize bytes, and only the one-byte
// positions stay alive). It reads the saved position. It gathers: a thread
// owns four channels of one input pixel and looks at the windows that hold
// it, so every dx element is written once, in a fixed order, with no
// atomics and no zero-fill. In the forward a thread owns four channels of
// one output pixel, so a warp reads whole pixels of C contiguous channels;
// neighbouring windows share taps through L1/L2. Offsets are 64-bit: the
// training shape has 4.6e8 elements.

#include "vec4.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
maxpool_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                   unsigned char* __restrict__ pos, long long n_out4, int H, int W,
                   int C, int Ho, int Wo) {
  const long long t = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (t >= n_out4) return;
  const int groups = C / 4;
  const long long pix = t / groups;
  const int g = (int)(t - pix * groups);
  const long long row = pix / Wo;
  const int j = (int)(pix - row * Wo);
  const long long n = row / Ho;
  const int i = (int)(row - n * Ho);
  const T* frame = x + n * H * W * C + 4 * g;
  float m[4] = {0.f, 0.f, 0.f, 0.f};
  unsigned char at[4] = {0, 0, 0, 0};
  bool first = true;  // every window holds at least one tap inside the frame
#pragma unroll
  for (int di = 0; di < 3; ++di) {
    const int h = 2 * i - 1 + di;
    if (h < 0 || h >= H) continue;
#pragma unroll
    for (int dj = 0; dj < 3; ++dj) {
      const int w = 2 * j - 1 + dj;
      if (w < 0 || w >= W) continue;
      float v[4];
      load4(frame + ((long long)h * W + w) * C, v);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (first || v[k] > m[k] || v[k] != v[k]) {
          m[k] = v[k];
          at[k] = (unsigned char)(di * 3 + dj);
        }
      }
      first = false;
    }
  }
  store4(y + 4 * t, m);
  if (pos != nullptr)
    *reinterpret_cast<uchar4*>(pos + 4 * t) = make_uchar4(at[0], at[1], at[2], at[3]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
maxpool_bwd_kernel(const T* __restrict__ dy, const unsigned char* __restrict__ pos,
                   T* __restrict__ dx, long long n_in4, int H, int W, int C, int Ho,
                   int Wo) {
  const long long t = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (t >= n_in4) return;
  const int groups = C / 4;
  const long long pix = t / groups;
  const int g = (int)(t - pix * groups);
  const long long row = pix / W;
  const int w = (int)(pix - row * W);
  const long long n = row / H;
  const int h = (int)(row - n * H);
  // the windows that hold row h start at 2i - 1 <= h <= 2i + 1: i = h / 2
  // and, for an odd h, (h + 1) / 2; the same along w
  const int i1 = (h + 1) >> 1, j1 = (w + 1) >> 1;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = h >> 1; i <= i1 && i < Ho; ++i) {
    const int di = h - (2 * i - 1);
    for (int j = w >> 1; j <= j1 && j < Wo; ++j) {
      const unsigned tap = (unsigned)(di * 3 + (w - (2 * j - 1)));
      const long long o = ((n * Ho + i) * Wo + j) * C + 4 * g;
      const uchar4 p = __ldg(reinterpret_cast<const uchar4*>(pos + o));
      float gy[4];
      load4(dy + o, gy);
      if (p.x == tap) acc[0] += gy[0];
      if (p.y == tap) acc[1] += gy[1];
      if (p.z == tap) acc[2] += gy[2];
      if (p.w == tap) acc[3] += gy[3];
    }
  }
  store4(dx + 4 * t, acc);
}

bool grid_for(long long n4, unsigned* blocks) {
  const long long b = (n4 + kThreads - 1) / kThreads;
  if (b < 1 || b > 2147483647LL) return false;
  *blocks = (unsigned)b;
  return true;
}

}  // namespace

extern "C" {

// is_bf16 selects __nv_bfloat16 activations (else float). Each function
// launches one kernel on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a size its grid cannot cover.

int maxpool_forward(const void* x, unsigned char* pos, void* y, int is_bf16,
                    long long nt, int H, int W, int C, int Ho, int Wo, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n4 = nt * Ho * Wo * (C / 4);
  unsigned blocks;
  if (!grid_for(n4, &blocks)) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    maxpool_fwd_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), pos, n4,
        H, W, C, Ho, Wo);
  else
    maxpool_fwd_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), pos, n4, H, W, C, Ho, Wo);
  return (int)cudaGetLastError();
}

int maxpool_backward(const void* dy, const unsigned char* pos, void* dx, int is_bf16,
                     long long nt, int H, int W, int C, int Ho, int Wo, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n4 = nt * H * W * (C / 4);
  unsigned blocks;
  if (!grid_for(n4, &blocks)) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    maxpool_bwd_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(dy), pos, static_cast<__nv_bfloat16*>(dx), n4,
        H, W, C, Ho, Wo);
  else
    maxpool_bwd_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(dy), pos, static_cast<float*>(dx), n4, H, W, C, Ho, Wo);
  return (int)cudaGetLastError();
}

}  // extern "C"
