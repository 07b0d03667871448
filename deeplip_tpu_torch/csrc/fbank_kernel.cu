// Fused audio front-end for Hopper (sm_90a): pre-emphasised PCM -> framed
// real-DFT power spectrum -> mel filterbank -> log (-> DCT * lifter, c0 <-
// log energy). Only the (B, T, D) features reach device memory; frames and
// power spectra live in shared memory.
//
// Replaces deeplip_tpu/ops/pallas/fbank_kernel.py: _feature_kernel_v2 (the
// residue-class TPU kernel) and _feature_kernel (its hop-blocked v1
// fallback). Both TPU kernels exist to fit the 128-lane MXU tiling: v2 folds
// the Nyquist bin into the zero sin column so 257 bins become 256 lanes,
// which is exact only for filterbanks whose edge rows are zero, and v1
// serves the configs that fold refuses. This kernel keeps all n_fft/2+1 bins
// in full, so one kernel covers every config of both.
//
// What bounds it: arithmetic. A 256 x 3 s batch (76,544 frames of 400
// samples) needs about 31.4 GFLOP for the DFT against the 512 nonzero
// columns of [cos | -sin] and 0.07 GFLOP for the mel sums over the
// filterbank's 459 nonzero weights, but moves only about 57 MB (49 MB of
// PCM in, 7 MB of features out): about 0.47 ms at the FP32 CUDA-core peak
// of an H100 SXM against 0.02 ms of memory time.
//
// What the design does about it: one block owns one (batch row, tile of
// kTile frames). The tile's frames are copied once into shared memory,
// zero-padded at the signal end, so every frame row is 16-byte aligned
// whatever the hop. Each thread owns one frequency bin and keeps its
// re/im sums for all kTile frames in registers: per four samples it loads
// eight basis values (coalesced across the warp, L2-resident: the f32 basis
// is 822 KB) and one float4 of each frame (a shared-memory broadcast), then
// issues 8 * kTile FMAs. The basis is read once per tile, so its L2 traffic
// falls as 1/kTile. A short leftover of bins past a multiple of the block
// (bin 256 of a 512-point FFT) is split across the whole block by (bin,
// frame, sample stride) and reduced with warp shuffles, so no warp runs a
// second full pass alone. Everything is FP32, which meets or beats every
// Pallas precision mode; the TF32 tensor-core variant is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kPsfEps = 2.220446049250313e-16f;  // numpy float64 eps

enum FeatType { kFbank = 0, kLogfbank = 1, kMfcc = 2 };

template <int kTile>
__global__ void __launch_bounds__(kThreads, 2)
fbank_features_kernel(const float* __restrict__ x,
                      const float* __restrict__ basis,
                      const float* __restrict__ mel_fb,
                      const float* __restrict__ dct,
                      const float* __restrict__ lift,
                      float* __restrict__ out,
                      int S, int T, int frame_len, int l_pad, int hop,
                      int n_bins, int n_mel, int n_cep, int feat_type,
                      int energy, float n_fft) {
  extern __shared__ __align__(16) float smem[];
  float* frames = smem;                    // kTile x l_pad
  float* power = frames + kTile * l_pad;   // kTile x n_bins
  float* melbuf = power + kTile * n_bins;  // kTile x n_mel
  float* etot = melbuf + kTile * n_mel;    // kTile

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const float* xb = x + static_cast<size_t>(b) * S;
  const int d_out = feat_type == kMfcc ? n_cep : n_mel;
  float* outb = out + (static_cast<size_t>(b) * T + t0) * d_out;

  // 1. Frame the tile: frame t, sample n reads x[(t0 + t) * hop + n]; the
  //    num_frames zero-pad convention makes samples at index >= S zero, and
  //    the alignment pad n >= frame_len meets zero basis rows.
  for (int i = tid; i < kTile * l_pad; i += kThreads) {
    const int t = i / l_pad;
    const int n = i - t * l_pad;
    const long long idx = static_cast<long long>(t0 + t) * hop + n;
    frames[i] = (n < frame_len && idx < S) ? __ldg(xb + idx) : 0.f;
  }
  __syncthreads();

  // 2. Power spectrum: power[t][k] = (re^2 + im^2) / n_fft. Bins below
  //    n_main take one thread each; a short leftover (bin 256 of a 512-point
  //    FFT) is split across the block in step 2b instead of running a whole
  //    extra pass on a few threads while the other warps wait.
  const int two_k = 2 * n_bins;
  const int n4 = l_pad / 4;
  const float4* fr4 = reinterpret_cast<const float4*>(frames);
  const int n_left = n_bins % kThreads;
  const int n_main = n_left * kTile <= kThreads ? n_bins - n_left : n_bins;
  for (int k = tid; k < n_main; k += kThreads) {
    float re[kTile], im[kTile];
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      re[t] = 0.f;
      im[t] = 0.f;
    }
    const float* bc = basis + k;           // cos column k
    const float* bs = basis + n_bins + k;  // -sin column k
    for (int j = 0; j < n4; ++j) {
      const size_t r = static_cast<size_t>(4 * j) * two_k;
      const float c0 = __ldg(bc + r), c1 = __ldg(bc + r + two_k);
      const float c2 = __ldg(bc + r + 2 * two_k), c3 = __ldg(bc + r + 3 * two_k);
      const float s0 = __ldg(bs + r), s1 = __ldg(bs + r + two_k);
      const float s2 = __ldg(bs + r + 2 * two_k), s3 = __ldg(bs + r + 3 * two_k);
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        const float4 f = fr4[t * n4 + j];
        re[t] = fmaf(f.x, c0, re[t]);
        im[t] = fmaf(f.x, s0, im[t]);
        re[t] = fmaf(f.y, c1, re[t]);
        im[t] = fmaf(f.y, s1, im[t]);
        re[t] = fmaf(f.z, c2, re[t]);
        im[t] = fmaf(f.z, s2, im[t]);
        re[t] = fmaf(f.w, c3, re[t]);
        im[t] = fmaf(f.w, s3, im[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      power[t * n_bins + k] = (re[t] * re[t] + im[t] * im[t]) / n_fft;
    }
  }
  // 2b. Leftover bins: each (bin, frame) item is summed by `split`
  //     consecutive lanes (a power of two that divides the warp), each over
  //     every split-th sample, then reduced with shuffles. Every thread runs
  //     the shuffles, so the warps stay converged.
  if (n_main < n_bins) {
    const int items = (n_bins - n_main) * kTile;
    int split = 1;
    while (split < 32 && items * split * 2 <= kThreads) split *= 2;
    const int item = tid / split;
    const int lane = tid % split;
    const int k = n_main + item / kTile;
    const int t = item % kTile;
    float re = 0.f, im = 0.f;
    if (item < items) {
      const float* f = frames + t * l_pad;
      for (int n = lane; n < frame_len; n += split) {
        const size_t r = static_cast<size_t>(n) * two_k + k;
        re = fmaf(f[n], __ldg(basis + r), re);
        im = fmaf(f[n], __ldg(basis + r + n_bins), im);
      }
    }
    for (int o = split / 2; o > 0; o /= 2) {
      re += __shfl_xor_sync(0xffffffffu, re, o);
      im += __shfl_xor_sync(0xffffffffu, im, o);
    }
    if (item < items && lane == 0) {
      power[t * n_bins + k] = (re * re + im * im) / n_fft;
    }
  }
  __syncthreads();

  // 3. Frame energy (MFCC c0) and mel energies, with the psf zero guard.
  //    fbank and logfbank store here; MFCC keeps log-mel for step 4.
  if (feat_type == kMfcc && energy) {
    for (int t = tid; t < kTile; t += kThreads) {
      const float* p = power + t * n_bins;
      float e = 0.f;
      for (int k = 0; k < n_bins; ++k) e += p[k];
      etot[t] = e == 0.f ? kPsfEps : e;
    }
  }
  for (int i = tid; i < kTile * n_mel; i += kThreads) {
    const int t = i / n_mel;
    const int m = i - t * n_mel;
    const float* p = power + t * n_bins;
    float s = 0.f;
    for (int k = 0; k < n_bins; ++k) s = fmaf(p[k], __ldg(mel_fb + k * n_mel + m), s);
    s = s == 0.f ? kPsfEps : s;
    if (feat_type != kFbank) s = logf(s);
    if (feat_type == kMfcc) {
      melbuf[i] = s;
    } else if (t0 + t < T) {
      outb[i] = s;
    }
  }
  if (feat_type != kMfcc) return;
  __syncthreads();

  // 4. MFCC: log-mel @ DCT * lifter; c0 <- log energy when `energy`.
  for (int i = tid; i < kTile * n_cep; i += kThreads) {
    const int t = i / n_cep;
    const int c = i - t * n_cep;
    if (t0 + t >= T) continue;
    float s;
    if (energy && c == 0) {
      s = logf(etot[t]);
    } else {
      const float* lm = melbuf + t * n_mel;
      s = 0.f;
      for (int m = 0; m < n_mel; ++m) s = fmaf(lm[m], __ldg(dct + m * n_cep + c), s);
      s *= __ldg(lift + c);
    }
    outb[i] = s;
  }
}

template <int kTile>
cudaError_t launch(const float* x, const float* basis, const float* mel_fb,
                   const float* dct, const float* lift, float* out, int B,
                   int S, int T, int frame_len, int l_pad, int hop, int n_fft,
                   int n_mel, int n_cep, int feat_type, int energy,
                   size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fbank_features_kernel<kTile>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kTile - 1) / kTile, B);
  fbank_features_kernel<kTile><<<grid, kThreads, smem, stream>>>(
      x, basis, mel_fb, dct, lift, out, S, T, frame_len, l_pad, hop,
      n_fft / 2 + 1, n_mel, n_cep, feat_type, energy,
      static_cast<float>(n_fft));
  return cudaGetLastError();
}

size_t smem_bytes(int tile, int l_pad, int n_bins, int n_mel) {
  return sizeof(float) * static_cast<size_t>(tile) * (l_pad + n_bins + n_mel + 1);
}

}  // namespace

// x: (B, S) pre-emphasised, length-masked PCM; basis: (l_pad, 2 * (n_fft/2+1))
// [cos | -sin] with zero rows from frame_len on; mel_fb: (n_fft/2+1, n_mel);
// dct: (n_mel, n_cep); lift: (n_cep,); out: (B, T, D) with D = n_cep for
// MFCC, else n_mel. All f32, contiguous, on the device of `stream`.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int fbank_features(const float* x, const float* basis,
                              const float* mel_fb, const float* dct,
                              const float* lift, float* out, int B, int S,
                              int T, int frame_len, int l_pad, int hop,
                              int n_fft, int n_mel, int n_cep, int feat_type,
                              int energy, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || T < 1 || hop < 1 || frame_len < 1 ||
      l_pad % 4 != 0 || l_pad < frame_len || n_fft < 2 || n_mel < 1 ||
      feat_type < kFbank || feat_type > kMfcc ||
      (feat_type == kMfcc && n_cep < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_bins = n_fft / 2 + 1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t big = smem_bytes(32, l_pad, n_bins, n_mel);
  if (big <= 200 * 1024) {
    return static_cast<int>(launch<32>(x, basis, mel_fb, dct, lift, out, B, S,
                                       T, frame_len, l_pad, hop, n_fft, n_mel,
                                       n_cep, feat_type, energy, big, s));
  }
  return static_cast<int>(launch<8>(x, basis, mel_fb, dct, lift, out, B, S, T,
                                    frame_len, l_pad, hop, n_fft, n_mel, n_cep,
                                    feat_type, energy,
                                    smem_bytes(8, l_pad, n_bins, n_mel), s));
}
