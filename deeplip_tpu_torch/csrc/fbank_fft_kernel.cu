// Fused audio front-end for Hopper (sm_90a) as an FP32 FFT in shared memory:
// raw PCM -> pre-emphasis and length mask -> framed real FFT power spectrum
// -> mel filterbank -> log (-> DCT * lifter, c0 <- log energy). Only the
// (B, T, D) features reach device memory; the PCM strip, the frames' spectra
// and the power spectra live in shared memory.
//
// Replaces deeplip_tpu/ops/pallas/fbank_kernel.py: _feature_kernel_v2 and
// _feature_kernel (v1) for every n_fft from 64 to 4096: fbank_fft_kernel
// for a power of two, fbank_mixed_fft_kernel (below) for any other size.
// The TPU kernels compute the real DFT as a dense product against the
// [cos | -sin] basis because the TPU's matrix unit makes that cheap and its
// FFT is slow. On Hopper the product is 411 kFLOP a frame at n_fft 512 on
// CUDA cores (fbank_kernel.cu, kept for n_fft outside [64, 4096]); this
// kernel's FFT needs about 16 kFLOP a frame for the whole front-end.
//
// What bounds it: at a 256 x 3 s batch (76,544 frames of 400 samples,
// n_fft 512) the front-end must read 49 MB of PCM and write 7.3 MB of
// MFCC, about 0.017 ms at 3.35 TB/s, and do about 1.06 GFLOP, about
// 0.016 ms at the 67 TFLOP/s FP32 peak: the bytes set the bound, and the
// operations nearly meet it (this kernel does 1.27 GFLOP, with each
// frame's pre-emphasis, the DC sums and both halves of every untangle
// pair). In practice the latency of each block's phases (the
// shared-memory round trips and the barriers between them, and the serial
// DC sums) sets the pace.
//
// What the design does about it: one block owns one (batch row, tile of F
// frames), F * n_fft/2 = 4096 complex points, fewer if the PCM strip would
// not fit, in two spectra buffers (35 KB each) that the passes write in
// turn, so no thread holds data across a barrier and nothing spills. The
// block
//   1. copies the tile's PCM strip once, with cp.async (16 bytes where the
//      address allows, else 4), plus the one sample before it;
//   2. runs the first radix-16 pass of an n_fft/2-point complex FFT
//      straight from the strip, forming e[n] = x[n] - a x[n-1] (0 from
//      each row's length on, and past the signal end) and packing z[n] =
//      e[2n] + i e[2n+1] as it reads, so pre-emphasis and the mask cost no
//      pass; beside it one warp sums each frame's e[n] in sample order for
//      the DC bin (below), its lanes skewed in time so that their reads, a
//      hop apart, fall on distinct banks;
//   3. runs the remaining passes (radix 16 while four factors of 2 are
//      left, then one of radix 2, 4 or 8: two passes in all at n_fft 512)
//      in Stockham order from one buffer to the other: every thread reads
//      its butterflies into registers, does a 16-point DFT there (radix
//      4 x 4) and writes them out; the block meets at one barrier a pass.
//      The spectra carry one pad slot every 16 points, so the strided
//      writes of the early passes fall on distinct banks;
//   4. untangles the n_fft/2+1 real-input bins from Z[k] and Z[N-k] and
//      writes the power to the other buffer;
//   5. sums each mel filter over its nonzero weights only, filter-major,
//      takes the energy as a warp reduction, and for MFCC applies the DCT
//      and the lifter from shared memory before one coalesced store of
//      the tile.
// Why the DC bin is summed apart: after pre-emphasis X[0] = sum e[n] is a
// few hundredths of the frame's size, and now and then, in about one frame
// in 10^5 of white noise, within 1e-5 of zero. The packed FFT forms it as
// sum e[2n] + sum e[2n+1], two halves of the frame's own size that cancel;
// in sample order the running sum telescopes (x[last] + (1 - a) sum x[n]
// + ...) and stays a sample's size. Against the float64 sum the sample
// order is the more accurate, by more than 2x in rms and at worst on such
// frames (tests/test_torch_fbank_fft.py), and it is the order in which
// the plain version (cuBLAS) and the DFT kernel sum a column. With the
// packed value, a mel filter that holds the DC bin alone (logfbank-60 at
// n_fft 512) missed the plain log by up to 0.13 in those frames. Complex
// bins come that near zero far more rarely (the chance falls with the
// square of the distance) and keep the FFT's value.
// Twiddles come from a table the wrapper computes in float64. An all-zero
// frame stays exactly zero through every pass, so the mel==0 guard fires
// as in the plain version (and so does a filter with no nonzero weight,
// whose CSR row is empty: logfbank-80 at n_fft 400 has one). Built without
// --use_fast_math; logf, not __logf.
//
// fbank_mixed_fft_kernel, the route at every other n_fft in [64, 4096]
// (400 for torchaudio's and Whisper's front-ends, 480 for 30 ms at 16 kHz,
// 441 for 10 ms at 44.1 kHz, Kaldi's frame length itself), keeps this
// design and changes what the passes are. The wrapper's plan
// (ops/cuda/fbank.py: fft_plan) is passed in: radices 16 while four factors
// of 2 are left, then 8, 4 or 2, then 3, 5 and 7, over L points a frame.
// An even n_fft packs z as above (L = n = n_fft / 2) and untangles; an odd
// one transforms the real frame itself (n = n_fft: 441 = 3 3 7 7) and reads
// its bins directly. Where n has a prime factor above 7 (510: n = 255 = 3 5
// 17) the DFT is Bluestein's: z[k] c[k] with the chirp c[k] = exp(-i pi k^2
// / n) (k^2 mod 2n reduced in integers before the float64 phase), zero-
// padded to L = m, a power of two >= 2n - 1; an m-point transform A; its
// conj(A) times h = conj(B) / m, B the float64 FFT of the chirp's conjugate,
// rounded once; a second m-point transform E, so that Z[k] = c[k] conj(E[k])
// (the conjugates and 1/m make the second forward transform the inverse
// one). What bounds it is what bounds this kernel: at 256 x 3 s the
// function's bytes or operations take 0.017-0.019 ms, the route's own
// operations 0.018 ms (n_fft 400) to 0.056 ms (510, two transforms of 512
// points), and each block's phases set the pace. What the design does:
//   - the odd radices run in registers as y_k, y_{R-k} = v_0 + sum t_r
//     cos -/+ i sum s_r sin over the mirrored pairs t_r = v_r + v_{R-r},
//     s_r = v_r - v_{R-r}, with cos and sin constants rounded once to f32,
//     since their roots are not the 16th roots mul_w16 knows;
//   - a pass's quotients by its runtime sub-transform size and stride are
//     products with a 32-bit reciprocal (__umulhi), not divisions;
//   - F = kPoints / L frames a block (at most 128, fewer where shared memory
//     asks: n_fft 4095 takes m = 8192 with F = 1); L need not divide
//     kPoints, and frames past the row's end are masked as in this kernel;
//   - the first pass reads the strip through the same pre-emphasis, mask
//     and packing, times the chirp under Bluestein, and the DC bin is summed
//     in sample order by the same warps;
//   - the tables (twiddles of L or n_fft points, chirp, filter) are uploaded
//     once per device and config before any capture; a launch allocates
//     nothing and never synchronises.
// The power-of-two kernel keeps its compile-time plan; the two kernels
// share the staging, the DC sums and the mel, energy and DCT stages. Forced
// onto the power-of-two plans at 256 x 3 s (`chip_smoke.py --k1-against`,
// H100 80GB HBM3, 700 W), this kernel took 12 % longer than the
// compile-time one at 512 (the shipped size) and 4096, and 12-13 % less at
// 1024 and 2048.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPoints = 4096;                  // complex points per block: F * N
constexpr float kPsfEps = 2.220446049250313e-16f;  // numpy float64 eps
constexpr size_t kSmemTarget = 74 * 1024;      // keeps 3 blocks on an SM
constexpr size_t kSmemMax = 232448;            // a block's limit on sm_90

enum FeatType { kFbank = 0, kLogfbank = 1, kMfcc = 2 };

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Spectra slot of complex point i: one pad slot after every 16 points.
__host__ __device__ inline int pad16(int i) { return i + (i >> 4); }

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

// a * exp(-2 pi i k / 16) for a k known at compile time after unrolling:
// the trivial roots are swaps and signs, the others one complex product
// with constants rounded once to f32.
__device__ __forceinline__ float2 mul_w16(float2 a, int k) {
  constexpr float c1 = 0.92387953251128674f;   // cos(pi / 8)
  constexpr float s1 = 0.38268343236508977f;   // sin(pi / 8)
  constexpr float h = 0.70710678118654752f;    // cos(pi / 4)
  k &= 15;
  switch (k) {
    case 0: return a;
    case 4: return make_float2(a.y, -a.x);
    case 8: return make_float2(-a.x, -a.y);
    case 12: return make_float2(-a.y, a.x);
    case 1: return cmul(a, make_float2(c1, -s1));
    case 2: return cmul(a, make_float2(h, -h));
    case 3: return cmul(a, make_float2(s1, -c1));
    case 5: return cmul(a, make_float2(-s1, -c1));
    case 6: return cmul(a, make_float2(-h, -h));
    case 7: return cmul(a, make_float2(-c1, -s1));
    case 9: return cmul(a, make_float2(-c1, s1));
    case 10: return cmul(a, make_float2(-h, h));
    case 11: return cmul(a, make_float2(-s1, c1));
    case 13: return cmul(a, make_float2(s1, c1));
    case 14: return cmul(a, make_float2(h, h));
    default: return cmul(a, make_float2(c1, s1));
  }
}

// Forward R-point DFT (R = 2, 4, 8, 16) of v in registers, Stockham passes
// of radix 4 (then 2) over sub-transforms of NS points, as the block-level
// passes run.
template <int R, int NS>
struct SmallDft {
  static __device__ __forceinline__ void run(float2 (&v)[R]) {
    constexpr int P = R / NS >= 4 ? 4 : 2;
    constexpr int Q = R / P;
    float2 o[R];
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      float2 u[P];
#pragma unroll
      for (int r = 0; r < P; ++r) u[r] = mul_w16(v[j + r * Q], (j % NS) * r * (16 / (NS * P)));
      if constexpr (P == 4) {
        const float2 a0 = make_float2(u[0].x + u[2].x, u[0].y + u[2].y);
        const float2 a1 = make_float2(u[0].x - u[2].x, u[0].y - u[2].y);
        const float2 a2 = make_float2(u[1].x + u[3].x, u[1].y + u[3].y);
        const float2 a3 = make_float2(u[1].y - u[3].y, u[3].x - u[1].x);  // -i (u1 - u3)
        u[0] = make_float2(a0.x + a2.x, a0.y + a2.y);
        u[1] = make_float2(a1.x + a3.x, a1.y + a3.y);
        u[2] = make_float2(a0.x - a2.x, a0.y - a2.y);
        u[3] = make_float2(a1.x - a3.x, a1.y - a3.y);
      } else {
        const float2 a0 = u[0];
        u[0] = make_float2(a0.x + u[1].x, a0.y + u[1].y);
        u[1] = make_float2(a0.x - u[1].x, a0.y - u[1].y);
      }
      const int d = (j / NS) * NS * P + j % NS;
#pragma unroll
      for (int r = 0; r < P; ++r) o[d + r * NS] = u[r];
    }
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] = o[i];
    SmallDft<R, NS * P>::run(v);
  }
};

template <int R>
struct SmallDft<R, R> {
  static __device__ __forceinline__ void run(float2 (&)[R]) {}
};

// X[k] = (Z[k] + conj Z[N-k]) / 2 - i W^k (Z[k] - conj Z[N-k]) / 2 with
// a = Z[k], b = Z[N-k], w = exp(-2 pi i k / n_fft).
__device__ __forceinline__ float2 untangle(float2 a, float2 b, float2 w) {
  const float2 e = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y));
  const float2 o = make_float2(0.5f * (a.y + b.y), -0.5f * (a.x - b.x));
  return make_float2(e.x + (w.x * o.x - w.y * o.y), e.y + (w.x * o.y + w.y * o.x));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// One Stockham pass of radix R = 2^LOG_R over F frames of N = 2^log_n
// points, from src to dst, for sub-transforms of ns = 2^log_ns points;
// twiddles exp(-2 pi i (j mod ns) r / (ns R)) from the n_fft-point table.
template <int LOG_R>
__device__ __forceinline__ void fft_pass(const float2* src, float2* dst,
                                         const float2* __restrict__ tw, int F, int log_n,
                                         int log_ns) {
  constexpr int R = 1 << LOG_R;
  const int log_q = log_n - LOG_R, q = 1 << log_q, ns = 1 << log_ns;
  const int items = F << log_q;
  const int tw_shift = log_n + 1 - log_ns - LOG_R;  // n_fft / (ns R) = 2^tw_shift
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int j = it & (q - 1);
    const int base = (it >> log_q) << log_n;
    const int m = (j & (ns - 1)) << tw_shift;
    float2 v[R];
    v[0] = src[pad16(base + j)];
#pragma unroll
    for (int r = 1; r < R; ++r) v[r] = cmul(src[pad16(base + j + r * q)], __ldg(tw + r * m));
    SmallDft<R, 1>::run(v);
    const int d = base + ((j >> log_ns) << (log_ns + LOG_R)) + (j & (ns - 1));
#pragma unroll
    for (int r = 0; r < R; ++r) dst[pad16(d + r * ns)] = v[r];
  }
  __syncthreads();
}

// Where a block's tile lies in its strip: frame 0's sample 0, and the row's
// length counted from that sample.
struct Tile {
  const float* fr;
  int lim_rel;
};

// A block's shared copies of the constants, after the two spectra buffers.
struct Consts {
  float* mel_w;   // n_weights mel weights
  int* idx;       // 3 x n_mel: each filter's first nonzero bin, count, offset
  float* dct;     // n_mel x n_cep
  float* lift;    // n_cep
  float* dc;      // F: X[0] of each frame
};

__device__ __forceinline__ Consts carve_consts(float* base, int n_weights, int n_mel,
                                               int n_cep) {
  Consts c;
  c.mel_w = base;
  c.idx = reinterpret_cast<int*>(c.mel_w + round4(n_weights));
  c.dct = reinterpret_cast<float*>(c.idx + round4(3 * n_mel));
  c.lift = c.dct + round4(n_mel * n_cep);
  c.dc = c.lift + round4(n_cep);
  return c;
}

// 1. Stage the strip: row samples [s0, s0 + cnt) with s0 = t0*hop - 1,
//    only those below the row's length (the rest is never read). Strip
//    slot i holds row sample s0 + i - pad, where pad puts the slot at the
//    same offset mod 16 bytes as its source, so 16-byte copies line up.
//    Then the constants; the block meets once all have landed.
__device__ __forceinline__ Tile stage_tile(const float* __restrict__ xb, int lim,
                                           float* strip, Consts c, int t0, int F, int hop,
                                           int frame_len, const int* __restrict__ mel_idx,
                                           const float* __restrict__ mel_w,
                                           const float* __restrict__ dct,
                                           const float* __restrict__ lift, int n_mel,
                                           int n_cep, int n_weights, bool mfcc) {
  const int tid = threadIdx.x;
  const long long s0 = static_cast<long long>(t0) * hop - 1;
  const int cnt = (F - 1) * hop + frame_len + 1;
  const long long g_lo = s0 < 0 ? 0 : s0;
  const long long g_end = s0 + cnt < lim ? s0 + cnt : lim;
  const int n_copy = g_end > g_lo ? static_cast<int>(g_end - g_lo) : 0;
  const float* gsrc = xb + g_lo;
  const int ph = static_cast<int>((reinterpret_cast<uintptr_t>(gsrc) >> 2) & 3);
  const int off0 = static_cast<int>(g_lo - s0);     // 1 for the first tile
  const int pad = (ph - off0) & 3;
  float* sdst = strip + pad + off0;
  const int head = min((4 - ph) & 3, n_copy);
  const int n_vec = (n_copy - head) >> 2;
  for (int i = tid; i < head; i += kThreads) cp_async4(sdst + i, gsrc + i);
  for (int i = tid; i < n_vec; i += kThreads) {
    cp_async16(sdst + head + 4 * i, gsrc + head + 4 * i);
  }
  for (int i = head + 4 * n_vec + tid; i < n_copy; i += kThreads) cp_async4(sdst + i, gsrc + i);
  if (tid == 0 && s0 < 0) strip[pad] = 0.f;         // x[-1] := 0, so e[0] = x[0]
  for (int i = tid; i < n_weights; i += kThreads) c.mel_w[i] = __ldg(mel_w + i);
  for (int i = tid; i < 3 * n_mel; i += kThreads) c.idx[i] = __ldg(mel_idx + i);
  if (mfcc) {
    for (int i = tid; i < n_mel * n_cep; i += kThreads) c.dct[i] = __ldg(dct + i);
    for (int i = tid; i < n_cep; i += kThreads) c.lift[i] = __ldg(lift + i);
  }
  cp_async_wait_all();
  __syncthreads();
  return Tile{strip + pad + 1, lim - t0 * hop};
}

// The DC sums: frame f on lane f % 32 of warp f / 32 (F <= 128, so the
// first F / 32 warps). Lane l runs s_l = l (hop - 1) mod 32 steps behind
// lane 0, so at every step the lanes read 32 distinct banks (frame starts
// lie hop apart); each frame is still summed in sample order.
__device__ __forceinline__ void dc_sums(Tile tile, float* dc, int F, int hop, int frame_len,
                                        float preemph) {
  const int tid = threadIdx.x;
  if (tid < ((F + 31) & ~31)) {
    const int f = tid;
    const int lag = ((tid & 31) * (hop - 1)) & 31;
    const float* p = tile.fr + f * hop;
    const int n_valid = f < F ? max(0, min(frame_len, tile.lim_rel - f * hop)) : 0;
    float s = 0.f, prev = n_valid > 0 ? p[-1] : 0.f;
    for (int step = 0; step < frame_len + 31; step += 16) {
      float xs[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int m = step + i - lag;
        xs[i] = static_cast<unsigned>(m) < static_cast<unsigned>(n_valid) ? p[m] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {   // selects, no branches: the lanes' lags differ
        const bool on = static_cast<unsigned>(step + i - lag) < static_cast<unsigned>(n_valid);
        const float e = __fsub_rn(xs[i], __fmul_rn(preemph, prev));
        s += on ? e : 0.f;
        prev = on ? xs[i] : prev;
      }
    }
    if (f < F) dc[f] = s;
  }
}

// 5. Frame energy (MFCC c0), one warp per frame, and the mel sums over each
//    filter's nonzero weights, with the psf zero guard, filter-major (a
//    warp's lanes share one or two filters, so they loop alike), from the
//    F x n_bins power `pw` into `melbuf`; then the tile out in one coalesced
//    pass, or 6. for MFCC log-mel @ DCT * lifter (c0 <- log energy when
//    `energy`) first.
__device__ __forceinline__ void mel_features(const float* pw, int n_bins, float* melbuf,
                                             Consts c, int F, int n_mel, int n_cep,
                                             int feat_type, int energy, float* outb, int t0,
                                             int T) {
  const int tid = threadIdx.x;
  const bool mfcc = feat_type == kMfcc;
  float* etot = melbuf + round4(F * n_mel);        // F
  if (mfcc && energy) {
    const int warp = tid >> 5, lane = tid & 31;
    for (int f = warp; f < F; f += kThreads / 32) {
      const float* p = pw + f * n_bins;
      float e = 0.f;
      for (int k = lane; k < n_bins; k += 32) e += p[k];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) e += __shfl_xor_sync(0xffffffffu, e, o);
      if (lane == 0) etot[f] = e == 0.f ? kPsfEps : e;
    }
  }
  const int* m_first = c.idx;
  const int* m_count = c.idx + n_mel;
  const int* m_off = c.idx + 2 * n_mel;
  for (int i = tid; i < F * n_mel; i += kThreads) {
    const int m = i / F;
    const int f = i - m * F;
    const float* p = pw + f * n_bins + m_first[m];
    const float* w = c.mel_w + m_off[m];
    const int n = m_count[m];
    float s0 = 0.f, s1 = 0.f;   // two chains: the terms are >= 0, no cancellation
    int k = 0;
    for (; k + 1 < n; k += 2) {
      s0 = fmaf(p[k], w[k], s0);
      s1 = fmaf(p[k + 1], w[k + 1], s1);
    }
    if (k < n) s0 = fmaf(p[k], w[k], s0);
    float s = s0 + s1;
    s = s == 0.f ? kPsfEps : s;
    melbuf[f * n_mel + m] = feat_type == kFbank ? s : logf(s);
  }
  __syncthreads();
  if (!mfcc) {   // fbank, logfbank: the tile out in one coalesced pass
    for (int i = tid; i < F * n_mel; i += kThreads) {
      if (t0 + i / n_mel < T) outb[i] = melbuf[i];
    }
    return;
  }
  for (int i = tid; i < F * n_cep; i += kThreads) {
    const int f = i / n_cep;
    const int cc = i - f * n_cep;
    if (t0 + f >= T) continue;
    float s;
    if (energy && cc == 0) {
      s = logf(etot[f]);
    } else {
      const float* lm = melbuf + f * n_mel;
      float s0 = 0.f, s1 = 0.f;
      int m = 0;
      for (; m + 1 < n_mel; m += 2) {
        s0 = fmaf(lm[m], c.dct[m * n_cep + cc], s0);
        s1 = fmaf(lm[m + 1], c.dct[(m + 1) * n_cep + cc], s1);
      }
      if (m < n_mel) s0 = fmaf(lm[m], c.dct[m * n_cep + cc], s0);
      s = (s0 + s1) * c.lift[cc];
    }
    outb[i] = s;
  }
}

__global__ void __launch_bounds__(kThreads, 3)
fbank_fft_kernel(const float* __restrict__ x, const int* __restrict__ lengths,
                 const float2* __restrict__ tw, const int* __restrict__ mel_idx,
                 const float* __restrict__ mel_w, const float* __restrict__ dct,
                 const float* __restrict__ lift, float* __restrict__ out, int S,
                 int T, int F, int frame_len, int hop, int log_n, int n_mel,
                 int n_cep, int n_weights, int feat_type, int energy,
                 float preemph, int spec) {
  // Shared memory: two spectra buffers of `spec` floats each (F x N complex,
  // padded); the PCM strip lies in the second until the first pass has read
  // it; the power goes to the buffer the last pass did not write, and the
  // mel energies to the one it did, once the untangle has read it.
  extern __shared__ __align__(16) float smem[];
  const int N = 1 << log_n;
  const int stride = N + 1;                        // power row of one frame
  float* strip = smem + spec;                      // raw samples, first pass only
  const Consts cs = carve_consts(smem + 2 * spec, n_weights, n_mel, n_cep);
  const bool mfcc = feat_type == kMfcc;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * F;
  const int tid = threadIdx.x;
  const float* xb = x + static_cast<size_t>(b) * S;
  const int lim = lengths ? min(max(__ldg(lengths + b), 0), S) : S;
  const int d_out = mfcc ? n_cep : n_mel;
  float* outb = out + (static_cast<size_t>(b) * T + t0) * d_out;

  const Tile tile = stage_tile(xb, lim, strip, cs, t0, F, hop, frame_len, mel_idx, mel_w,
                               dct, lift, n_mel, n_cep, n_weights, mfcc);

  // 2. First radix-16 pass, read from the strip. Frame f's sample m is row
  //    sample (t0 + f) * hop + m = fr[f * hop + m]; it is pre-emphasised as
  //    the plain version does (x[n] - a * x[n-1], no FMA) and is zero at
  //    m >= frame_len (the n_fft zero pad) and from the row's length on.
  {
    const float* fr = tile.fr;
    const int lim_rel = tile.lim_rel;
    const int log_q = log_n - 4, q = 1 << log_q;
    if (tid < F << log_q) {   // F * N / 16 <= kThreads
      const int f = tid >> log_q, j = tid & (q - 1);
      float2 v[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int m = 2 * (j + r * q);
        const int i = f * hop + m;
        float e0 = 0.f, e1 = 0.f;
        if (m < frame_len && i < lim_rel) {
          const float x0 = fr[i];
          e0 = __fsub_rn(x0, __fmul_rn(preemph, fr[i - 1]));
          if (m + 1 < frame_len && i + 1 < lim_rel) e1 = __fsub_rn(fr[i + 1], __fmul_rn(preemph, x0));
        }
        v[r] = make_float2(e0, e1);
      }
      SmallDft<16, 1>::run(v);
      float2* dst = reinterpret_cast<float2*>(smem);
      const int d = (f << log_n) + 16 * j;
#pragma unroll
      for (int r = 0; r < 16; ++r) dst[pad16(d + r)] = v[r];
    }
    // the DC sums, after this thread's pass item
    dc_sums(tile, cs.dc, F, hop, frame_len, preemph);
    __syncthreads();
  }

  // 3. The remaining passes, from one buffer to the other: radix 16 while
  //    four or more factors of 2 are left, then one pass of the radix that
  //    is left.
  float* cur = smem;            // the buffer that holds the spectra
  float* other = smem + spec;
  for (int log_ns = 4; log_ns < log_n;) {
    const int rem = log_n - log_ns;
    const float2* src = reinterpret_cast<const float2*>(cur);
    float2* dst = reinterpret_cast<float2*>(other);
    if (rem >= 4) {
      fft_pass<4>(src, dst, tw, F, log_n, log_ns);
    } else if (rem == 3) {
      fft_pass<3>(src, dst, tw, F, log_n, log_ns);
    } else if (rem == 2) {
      fft_pass<2>(src, dst, tw, F, log_n, log_ns);
    } else {
      fft_pass<1>(src, dst, tw, F, log_n, log_ns);
    }
    log_ns += rem >= 4 ? 4 : rem;
    float* t = cur;
    cur = other;
    other = t;
  }

  // 4. Untangle: pair p of a frame gives bins p and N - p (bin N from
  //    Z[0] at p = 0); the power (re^2 + im^2) / n_fft goes to the other
  //    buffer.
  float* pw = other;                               // F x (N+1) power
  {
    const float2* z = reinterpret_cast<const float2*>(cur);
    const int half = N >> 1;
    const int pairs = F * (half + 1);
    const float n_fft = static_cast<float>(2 * N);
    for (int it = tid; it < pairs; it += kThreads) {
      const int f = it / (half + 1), p = it - f * (half + 1);
      const int zf = f << log_n;
      const float2 a = z[pad16(zf + p)], bb = z[pad16(zf + ((N - p) & (N - 1)))];
      const float2 lo = p ? untangle(a, bb, __ldg(tw + p)) : make_float2(cs.dc[f], 0.f);
      pw[f * stride + p] = (lo.x * lo.x + lo.y * lo.y) / n_fft;
      if (p != half) {
        const float2 hi = untangle(bb, a, __ldg(tw + N - p));
        pw[f * stride + N - p] = (hi.x * hi.x + hi.y * hi.y) / n_fft;
      }
    }
    __syncthreads();
  }

  // 5, 6. Mel, energy, DCT; the mel energies go to the buffer the untangle
  //    read.
  mel_features(pw, stride, cur, cs, F, n_mel, n_cep, feat_type, energy, outb, t0, T);
}

// ----------------------------------------------------------------------------
// The mixed-radix and Bluestein route: every other n_fft in [64, 4096].
// ----------------------------------------------------------------------------

constexpr int kMaxPasses = 16;

// The passes' radices in order (the wrapper's fft_plan), by value.
struct MixedPlan {
  int radix[kMaxPasses];
  int n_pass;
};

// (cos, sin) of 2 pi m / R for an odd radix R and 0 < m <= R / 2, rounded
// once to f32; a compile-time switch after unrolling.
__device__ __forceinline__ float2 odd_root(int R, int m) {
  switch (R * 8 + m) {
    case 3 * 8 + 1: return make_float2(-0.5f, 0.86602540378443865f);
    case 5 * 8 + 1: return make_float2(0.30901699437494742f, 0.95105651629515357f);
    case 5 * 8 + 2: return make_float2(-0.80901699437494742f, 0.58778525229247313f);
    case 7 * 8 + 1: return make_float2(0.62348980185873353f, 0.78183148246802981f);
    case 7 * 8 + 2: return make_float2(-0.22252093395631440f, 0.97492791218182361f);
    case 7 * 8 + 3: return make_float2(-0.90096886790241913f, 0.43388373911755812f);
    default: return make_float2(1.f, 0.f);
  }
}

// Forward R-point DFT (R = 3, 5, 7) of v in registers, by the mirrored
// pairs t_r = v_r + v_{R-r}, s_r = v_r - v_{R-r}:
//   y_k, y_{R-k} = v_0 + sum_r t_r cos(2 pi r k / R) -/+ i sum_r s_r sin(...).
template <int R>
struct OddDft {
  static __device__ __forceinline__ void run(float2 (&v)[R]) {
    constexpr int H = R / 2;
    float2 t[H], s[H];
#pragma unroll
    for (int r = 1; r <= H; ++r) {
      t[r - 1] = make_float2(v[r].x + v[R - r].x, v[r].y + v[R - r].y);
      s[r - 1] = make_float2(v[r].x - v[R - r].x, v[r].y - v[R - r].y);
    }
    float2 y[R];
    y[0] = v[0];
#pragma unroll
    for (int r = 0; r < H; ++r) y[0] = make_float2(y[0].x + t[r].x, y[0].y + t[r].y);
#pragma unroll
    for (int k = 1; k <= H; ++k) {
      float ar = v[0].x, ai = v[0].y, br = 0.f, bi = 0.f;
#pragma unroll
      for (int r = 1; r <= H; ++r) {
        const int m = (r * k) % R;
        const float2 w = odd_root(R, m <= H ? m : R - m);
        const float sn = m <= H ? w.y : -w.y;
        ar = fmaf(t[r - 1].x, w.x, ar);
        ai = fmaf(t[r - 1].y, w.x, ai);
        br = fmaf(s[r - 1].x, sn, br);
        bi = fmaf(s[r - 1].y, sn, bi);
      }
      y[k] = make_float2(ar + bi, ai - br);       // a - i b
      y[R - k] = make_float2(ar - bi, ai + br);   // a + i b
    }
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] = y[i];
  }
};

template <int R>
__device__ __forceinline__ void dft_in_registers(float2 (&v)[R]) {
  if constexpr ((R & (R - 1)) == 0) {
    SmallDft<R, 1>::run(v);
  } else {
    OddDft<R>::run(v);
  }
}

// One Stockham pass of radix R over F transforms of L points: point n of
// transform f is load(f, n); sub-transforms of ns points; twiddles
// exp(-2 pi i (j mod ns) r / (ns R)) = tw[(j mod ns) r tw_step]. Writes the
// padded dst; the caller meets at the barrier. The quotients by the runtime
// q and ns are products with a reciprocal (__umulhi with ceil(2^32 / d)),
// exact for the numerators here (n * d < 2^32).
template <int R, class Load>
__device__ __forceinline__ void mixed_pass(Load load, float2* dst,
                                           const float2* __restrict__ tw, int F, int L,
                                           int ns, int tw_step) {
  const int q = L / R;
  const unsigned q_inv = 0xffffffffu / q + 1;     // q >= 2
  const unsigned ns_inv = 0xffffffffu / ns + 1;   // used for ns >= 2 only
  const int items = F * q;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int f = static_cast<int>(__umulhi(it, q_inv));
    const int j = it - f * q;
    const int k = ns == 1 ? 0 : j - ns * static_cast<int>(__umulhi(j, ns_inv));
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = load(f, j + r * q);
    if (ns > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r) v[r] = cmul(v[r], __ldg(tw + r * k * tw_step));
    }
    dft_in_registers<R>(v);
    const int d = f * L + (j - k) * R + k;   // (j / ns) ns R + j mod ns
#pragma unroll
    for (int r = 0; r < R; ++r) dst[pad16(d + r * ns)] = v[r];
  }
}

template <class Load>
__device__ __forceinline__ void any_pass(int R, Load load, float2* dst,
                                         const float2* __restrict__ tw, int F, int L, int ns,
                                         int tw_step) {
  switch (R) {
    case 16: mixed_pass<16>(load, dst, tw, F, L, ns, tw_step); break;
    case 8: mixed_pass<8>(load, dst, tw, F, L, ns, tw_step); break;
    case 4: mixed_pass<4>(load, dst, tw, F, L, ns, tw_step); break;
    case 2: mixed_pass<2>(load, dst, tw, F, L, ns, tw_step); break;
    case 3: mixed_pass<3>(load, dst, tw, F, L, ns, tw_step); break;
    case 5: mixed_pass<5>(load, dst, tw, F, L, ns, tw_step); break;
    default: mixed_pass<7>(load, dst, tw, F, L, ns, tw_step); break;
  }
}

// Passes 1 .. n_pass-1 of one transform (pass 0 wrote `cur`), each from one
// buffer to the other with a barrier after it; returns the buffer that holds
// the result, and leaves the other in `other`.
__device__ __forceinline__ float2* later_passes(const MixedPlan& plan, float2* cur,
                                                float2*& other,
                                                const float2* __restrict__ tw, int tw_len,
                                                int F, int L) {
  int ns = plan.radix[0];
  for (int p = 1; p < plan.n_pass; ++p) {
    const int R = plan.radix[p];
    const float2* src = cur;
    any_pass(R, [src, L](int f, int n) { return src[pad16(f * L + n)]; }, other, tw, F, L,
             ns, tw_len / (ns * R));
    __syncthreads();
    float2* t = cur;
    cur = other;
    other = t;
    ns *= R;
  }
  return cur;
}

// The FFT route at an n_fft that is no power of two. As fbank_fft_kernel,
// with the plan's passes (any order of radix 16, 8, 4, 2, 3, 5, 7) over L
// points a frame: L = n (n = n_fft / 2 packed for an even n_fft, n = n_fft
// for an odd one), or Bluestein's L = m, a power of two >= 2n - 1, where the
// first transform's input is z[k] c[k] (c the chirp; 0 from k = n on), the
// second's conj(A[k]) h[k] (h = conj(B) / m, the chirp filter), and
// Z[k] = c[k] conj(E[k]) of its output E.
__global__ void __launch_bounds__(kThreads, 3)
fbank_mixed_fft_kernel(const float* __restrict__ x, const int* __restrict__ lengths,
                       const float2* __restrict__ tw, const float2* __restrict__ tw_unt,
                       const float2* __restrict__ chirp, const float2* __restrict__ filt,
                       const int* __restrict__ mel_idx, const float* __restrict__ mel_w,
                       const float* __restrict__ dct, const float* __restrict__ lift,
                       float* __restrict__ out, MixedPlan plan, int S, int T, int F,
                       int frame_len, int hop, int n_fft, int L, int tw_len, int n_mel,
                       int n_cep, int n_weights, int feat_type, int energy, float preemph,
                       int spec) {
  // Shared memory as fbank_fft_kernel's: two spectra buffers of `spec`
  // floats (F x L complex, padded), the strip in the second until the first
  // pass has read it, then the constants.
  extern __shared__ __align__(16) float smem[];
  const bool packed = (n_fft & 1) == 0;
  const int n = packed ? n_fft >> 1 : n_fft;       // points of the DFT
  const bool bluestein = L != n;
  const int n_bins = n_fft / 2 + 1;                // power row of one frame
  float* strip = smem + spec;
  const Consts cs = carve_consts(smem + 2 * spec, n_weights, n_mel, n_cep);
  const bool mfcc = feat_type == kMfcc;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * F;
  const int tid = threadIdx.x;
  const float* xb = x + static_cast<size_t>(b) * S;
  const int lim = lengths ? min(max(__ldg(lengths + b), 0), S) : S;
  const int d_out = mfcc ? n_cep : n_mel;
  float* outb = out + (static_cast<size_t>(b) * T + t0) * d_out;

  const Tile tile = stage_tile(xb, lim, strip, cs, t0, F, hop, frame_len, mel_idx, mel_w,
                               dct, lift, n_mel, n_cep, n_weights, mfcc);

  // 2. The first pass, read from the strip: e[m] pre-emphasised as in
  //    fbank_fft_kernel (0 at m >= frame_len and from the row's length on),
  //    packed or not, times the chirp under Bluestein; then the DC sums.
  float2* cur = reinterpret_cast<float2*>(smem);
  float2* other = reinterpret_cast<float2*>(smem + spec);
  {
    const float* fr = tile.fr;
    const int lim_rel = tile.lim_rel;
    const auto e = [=](int f, int m) {
      const int i = f * hop + m;
      return m < frame_len && i < lim_rel ? __fsub_rn(fr[i], __fmul_rn(preemph, fr[i - 1]))
                                          : 0.f;
    };
    any_pass(plan.radix[0], [=](int f, int k) {
      if (k >= n) return make_float2(0.f, 0.f);   // Bluestein's zero pad
      const float2 z = packed ? make_float2(e(f, 2 * k), e(f, 2 * k + 1))
                              : make_float2(e(f, k), 0.f);
      return bluestein ? cmul(z, __ldg(chirp + k)) : z;
    }, cur, tw, F, L, 1, 0);
    dc_sums(tile, cs.dc, F, hop, frame_len, preemph);
    __syncthreads();
  }

  // 3. The plan's other passes; under Bluestein the second transform, its
  //    first pass reading conj(A) h.
  cur = later_passes(plan, cur, other, tw, tw_len, F, L);
  if (bluestein) {
    const float2* a = cur;
    any_pass(plan.radix[0], [a, L, filt](int f, int k) {
      const float2 v = a[pad16(f * L + k)];
      return cmul(make_float2(v.x, -v.y), __ldg(filt + k));
    }, other, tw, F, L, 1, 0);
    __syncthreads();
    float2* t = cur;
    cur = other;
    other = t;
    cur = later_passes(plan, cur, other, tw, tw_len, F, L);
  }

  // 4. The power of bins 0 .. n_fft/2 to the other buffer: for an even
  //    n_fft the untangle of pair p (bins p and n - p), for an odd one the
  //    bins themselves; bin 0 from the DC sum.
  float* pw = reinterpret_cast<float*>(other);
  {
    const auto z = [=](int f, int k) {
      const float2 v = cur[pad16(f * L + k)];
      return bluestein ? cmul(make_float2(v.x, -v.y), __ldg(chirp + k)) : v;
    };
    if (packed) {
      const int half = n >> 1;
      const int pairs = F * (half + 1);
      for (int it = tid; it < pairs; it += kThreads) {
        const int f = it / (half + 1), p = it - f * (half + 1);
        const float2 a = z(f, p), bb = z(f, p ? n - p : 0);
        const float2 lo = p ? untangle(a, bb, __ldg(tw_unt + p)) : make_float2(cs.dc[f], 0.f);
        pw[f * n_bins + p] = (lo.x * lo.x + lo.y * lo.y) / static_cast<float>(n_fft);
        if (n - p != p) {
          const float2 hi = untangle(bb, a, __ldg(tw_unt + n - p));
          pw[f * n_bins + n - p] = (hi.x * hi.x + hi.y * hi.y) / static_cast<float>(n_fft);
        }
      }
    } else {
      for (int it = tid; it < F * n_bins; it += kThreads) {
        const int f = it / n_bins, k = it - f * n_bins;
        const float2 v = k ? cur[pad16(f * L + k)] : make_float2(cs.dc[f], 0.f);  // |c| = 1
        pw[it] = (v.x * v.x + v.y * v.y) / static_cast<float>(n_fft);
      }
    }
    __syncthreads();
  }

  // 5, 6. Mel, energy, DCT; the mel energies go to the buffer step 4 read.
  mel_features(pw, n_bins, reinterpret_cast<float*>(cur), cs, F, n_mel, n_cep, feat_type,
               energy, outb, t0, T);
}

int strip_floats(int F, int hop, int frame_len) {
  return round4((F - 1) * hop + frame_len + 1 + 3);
}

// Floats of one of the two buffers: F x L padded complex spectra, the power
// F x n_bins, the mel energies, and, in the second, the strip; a multiple
// of 4, so the strip in the second buffer starts on 16 bytes.
int spec_floats(int F, int L, int n_bins, int hop, int frame_len, int n_mel) {
  return round4(std::max({2 * pad16(F * L), F * n_bins, round4(F * n_mel) + round4(F),
                          strip_floats(F, hop, frame_len)}));
}

size_t smem_bytes(int spec, int F, int n_mel, int n_cep, int n_weights) {
  return sizeof(float) * (static_cast<size_t>(2) * spec + round4(n_weights) +
                          round4(3 * n_mel) + round4(n_mel * n_cep) + round4(n_cep) +
                          round4(F));
}

bool valid_features(int B, int S, int T, int frame_len, int hop, int n_fft, int n_mel,
                    int n_cep, int n_weights, int feat_type) {
  return B >= 1 && B <= 65535 && S >= 1 && T >= 1 && hop >= 1 && frame_len >= 1 &&
         n_fft >= 64 && n_fft <= 4096 && frame_len <= n_fft && n_mel >= 1 &&
         n_weights >= 0 && feat_type >= kFbank && feat_type <= kMfcc &&
         (feat_type != kMfcc || n_cep >= 1);
}

}  // namespace

// x: (B, S) raw f32 PCM; lengths: (B,) int32 valid samples per row, or null
// for S; twiddles: (n_fft,) complex exp(-2 pi i k / n_fft) as (re, im) f32
// pairs; mel_idx: (3, n_mel) int32 first nonzero bin, count and offset into
// mel_w of each filter; mel_w: the filters' n_weights weights, f32; dct:
// (n_mel, n_cep); lift: (n_cep,); out: (B, T, D) with D = n_cep for MFCC,
// else n_mel. n_fft a power of two in [64, 4096], 1 <= frame_len <= n_fft.
// All contiguous, on the device of `stream`. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int fbank_fft_features(const float* x, const int* lengths,
                                  const float* twiddles, const int* mel_idx,
                                  const float* mel_w, const float* dct,
                                  const float* lift, float* out, int B, int S,
                                  int T, int frame_len, int hop, int n_fft,
                                  int n_mel, int n_cep, int n_weights, int feat_type,
                                  int energy, float preemph, void* stream) {
  int log_n = 0;
  while ((2 << log_n) < n_fft) ++log_n;   // n_fft = 2^(log_n + 1)
  if (!valid_features(B, S, T, frame_len, hop, n_fft, n_mel, n_cep, n_weights, feat_type) ||
      (2 << log_n) != n_fft) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (feat_type != kMfcc) n_cep = 0;
  const int N = n_fft / 2;
  auto bytes = [&](int f) {
    return smem_bytes(spec_floats(f, N, N + 1, hop, frame_len, n_mel), f, n_mel, n_cep,
                      n_weights);
  };
  int F = kPoints / N;
  while (F > 1 && bytes(F) > kSmemTarget) F /= 2;
  const size_t smem = bytes(F);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fbank_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + F - 1) / F, B);
  fbank_fft_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, lengths, reinterpret_cast<const float2*>(twiddles), mel_idx, mel_w, dct, lift, out,
      S, T, F, frame_len, hop, log_n, n_mel, n_cep, n_weights, feat_type, energy, preemph,
      spec_floats(F, N, N + 1, hop, frame_len, n_mel));
  return static_cast<int>(cudaGetLastError());
}

// The mixed-radix and Bluestein route. As fbank_fft_features, at any n_fft
// in [64, 4096], with the plan the wrapper made (ops/cuda/fbank.py:
// fft_plan): radices[n_pass] (each 16, 8, 4, 2, 3, 5 or 7) whose product is
// L, the points of each transform; L = n (n_fft / 2 for an even n_fft, else
// n_fft), or under Bluestein a power of two >= 2n - 1. twiddles: (tw_len,)
// complex exp(-2 pi i k / tw_len), tw_len = L under Bluestein, else n_fft;
// twiddles_n_fft: the (n_fft,) table of the untangle; chirp: (n,)
// exp(-i pi k^2 / n) and chirp_filter: (L,) conj(FFT_L(b)) / L, both null
// without Bluestein.
extern "C" int fbank_mixed_fft_features(
    const float* x, const int* lengths, const float* twiddles, const float* twiddles_n_fft,
    const float* chirp, const float* chirp_filter, const int* mel_idx, const float* mel_w,
    const float* dct, const float* lift, float* out, const int* radices, int B, int S, int T,
    int frame_len, int hop, int n_fft, int L, int n_pass, int n_mel, int n_cep, int n_weights,
    int feat_type, int energy, float preemph, void* stream) {
  if (!valid_features(B, S, T, frame_len, hop, n_fft, n_mel, n_cep, n_weights, feat_type) ||
      n_pass < 1 || n_pass > kMaxPasses || radices == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MixedPlan plan;
  plan.n_pass = n_pass;
  int product = 1;
  for (int p = 0; p < n_pass; ++p) {
    const int r = radices[p];
    if (r != 2 && r != 3 && r != 4 && r != 5 && r != 7 && r != 8 && r != 16) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    plan.radix[p] = r;
    product *= r;
  }
  const int n = n_fft % 2 == 0 ? n_fft / 2 : n_fft;
  const bool bluestein = L != n;
  if (product != L || L < 32 ||
      (bluestein && ((L & (L - 1)) != 0 || L < 2 * n - 1 || chirp == nullptr ||
                     chirp_filter == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (feat_type != kMfcc) n_cep = 0;
  const int n_bins = n_fft / 2 + 1;
  auto bytes = [&](int f) {
    return smem_bytes(spec_floats(f, L, n_bins, hop, frame_len, n_mel), f, n_mel, n_cep,
                      n_weights);
  };
  int F = std::min(128, std::max(1, kPoints / L));
  while (F > 1 && bytes(F) > kSmemTarget) --F;
  const size_t smem = bytes(F);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fbank_mixed_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + F - 1) / F, B);
  fbank_mixed_fft_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, lengths, reinterpret_cast<const float2*>(twiddles),
      reinterpret_cast<const float2*>(twiddles_n_fft), reinterpret_cast<const float2*>(chirp),
      reinterpret_cast<const float2*>(chirp_filter), mel_idx, mel_w, dct, lift, out, plan, S,
      T, F, frame_len, hop, n_fft, L, bluestein ? L : n_fft, n_mel, n_cep, n_weights,
      feat_type, energy, preemph, spec_floats(F, L, n_bins, hop, frame_len, n_mel));
  return static_cast<int>(cudaGetLastError());
}
