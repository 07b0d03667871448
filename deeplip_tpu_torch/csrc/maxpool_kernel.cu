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
//           pixel. Each dx element is 0.f plus those windows' dy in (i, j)
//           order, added in f32 and rounded once to the type.
//
// What bounds it on this card: bytes. The forward reads x once and writes y
// (a quarter of x) and, when a gradient will be asked for, the positions
// (one byte per element of y); the backward reads dy and the positions and
// writes dx. A compare per tap leaves the CUDA cores idle.
//
// Design. The backward could recompute each window from x (2.25|x| bytes,
// and x, 1.8 GB at the training shape, would stay alive for it) or read a
// saved position (|x| + |y| + |y|/itemsize bytes, and only the one-byte
// positions stay alive). It reads the saved position. In the forward a
// thread owns four channels of one output pixel, so a warp reads whole
// pixels of C contiguous channels; neighbouring windows share taps through
// L1/L2. Offsets are 64-bit: the training shape has 4.6e8 elements.
//
// The backward writes each dx element once, with no atomics and no
// zero-fill. Window (i, j) holds pixel rows 2i-1..2i+1 and columns
// 2j-1..2j+1, so the 2x2 patch (2i..2i+1, 2j..2j+1) is the one part of the
// frame that no window left of or above (i, j) holds: a thread that owns
// window (i, j) and V channels (16 bytes: 4 f32, or 8 bf16) writes that
// patch (clipped at H, W) from windows (i, j), (i, j+1), (i+1, j) and
// (i+1, j+1), a straight line of compares with no loop over the windows.
// Those windows are their neighbours' too, so a block first stages its
// tile of windows with one row and one column of halo in shared memory
// (kBwdRows window rows of whole frame rows where they fit in 48 KB, else
// columns, else channels), and its threads read them from there. Small
// tiles keep many blocks in flight to hide each one's copy. Whole,
// 16-byte-aligned rows are contiguous in dy and in the positions, so the
// stage is two 1-D bulk copies (TMA) completed on an mbarrier; any other
// tile is copied by the threads in 4-byte words, which at the training
// shapes would take 1.4-2x the TMA stage's time. The frame is a grid axis
// (looped past 65,535 frames) and the index math inside a frame is 32-bit:
// no 64-bit division. bf16 takes 8 channels a thread when C is a multiple
// of 8; with C % 8 == 4 every other staged window starts 8 bytes off a
// 16-byte line, so such C take 4 (as f32 always does), 8-byte accesses.
// Against a design that stages nothing (a thread walks rows of one column,
// carries the next row's windows in registers and reads its right
// neighbour's through L1), staging measured 0.6-12 % faster at the
// training shapes, and 2 rows a tile 1-21 % faster than 4 or 8 (H100 SXM;
// PERF.md).

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

constexpr int kBwdThreads = 256;  // most threads of a backward block
constexpr int kBwdRows = 2;       // most window rows of a backward tile
// dynamic shared memory of a backward block: the 48 KB a block may take
// without opting in, less its static mbarrier and alignment
constexpr int kBwdStageBytes = 48 * 1024 - 32;

// A backward block's tile: `rows` window rows, `cols` window columns and
// `chans` channels of one frame, staged with one window row and column of
// halo. The grid's x axis enumerates tiles (channel tile fastest), y frames.
struct BwdTiles {
  int rows, cols, chans;
  int col_tiles, chan_tiles;
  int pos_offset;  // bytes from the staged dy to the staged positions
  int bulk;        // whole, 16-byte-aligned window rows: two TMA copies
};

__device__ __forceinline__ void read_lanes(const float* p, float (&v)[4]) { read4(p, v); }
__device__ __forceinline__ void read_lanes(const __nv_bfloat16* p, float (&v)[4]) { read4(p, v); }
__device__ __forceinline__ void read_lanes(const __nv_bfloat16* p, float (&v)[8]) { read8(p, v); }
__device__ __forceinline__ void store_lanes(float* p, const float (&v)[4]) { store4(p, v); }
__device__ __forceinline__ void store_lanes(__nv_bfloat16* p, const float (&v)[4]) { store4(p, v); }
__device__ __forceinline__ void store_lanes(__nv_bfloat16* p, const float (&v)[8]) { store8(p, v); }

// one staged window's dy and positions for a thread's V channels
template <int V>
struct Window {
  float g[V];
  unsigned char p[V];
};

template <typename T, int V>
__device__ __forceinline__ void read_window(Window<V>& w, const T* g, const unsigned char* p) {
  read_lanes(g, w.g);
  read_bytes(p, w.p);
}

// adds to each channel's sum the window's dy where its position is `tap`
template <int V>
__device__ __forceinline__ void add_tap(float (&acc)[V], const Window<V>& w, unsigned tap) {
#pragma unroll
  for (int k = 0; k < V; ++k)
    if (w.p[k] == tap) acc[k] += w.g[k];
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

template <typename T, int V>
__global__ void __launch_bounds__(kBwdThreads)
maxpool_bwd_kernel(const T* __restrict__ dy, const unsigned char* __restrict__ pos,
                   T* __restrict__ dx, long long nt, int H, int W, int C, int Ho, int Wo,
                   BwdTiles t) {
  extern __shared__ __align__(16) unsigned char stage[];
  __shared__ __align__(8) unsigned long long full;  // the bulk copies' mbarrier
  int tile = blockIdx.x;
  const int ct = tile % t.chan_tiles;
  tile /= t.chan_tiles;
  const int jt = tile % t.col_tiles, it = tile / t.col_tiles;
  const int i0 = it * t.rows, j0 = jt * t.cols, c0 = ct * t.chans;
  const int rows = min(t.rows, Ho - i0), cols = min(t.cols, Wo - j0);
  const int chans = min(t.chans, C - c0);
  const int srows = min(t.rows + 1, Ho - i0), scols = min(t.cols + 1, Wo - j0);
  T* sg = reinterpret_cast<T*>(stage);
  unsigned char* sp = stage + t.pos_offset;
  const unsigned bar = smem_addr(&full);
  if (t.bulk && threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int groups = chans / V, row_items = cols * groups;
  const int span = scols * chans;  // elements of one staged window row
  unsigned parity = 0;
  for (long long n = blockIdx.y; n < nt; n += gridDim.y) {
    // stage window rows i0.., columns j0.. and channels c0.. of dy and pos
    const long long base = ((n * Ho + i0) * Wo + j0) * C + c0;
    if (t.bulk) {  // whole rows: one contiguous span each of dy and pos
      if (threadIdx.x == 0) {
        const unsigned bg = srows * span * (unsigned)sizeof(T), bp = srows * span;
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     :: "r"(bar), "r"(bg + bp) : "memory");
        asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                     "[%0], [%1], %2, [%3];\n"
                     :: "r"(smem_addr(sg)), "l"(dy + base), "r"(bg), "r"(bar) : "memory");
        asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                     "[%0], [%1], %2, [%3];\n"
                     :: "r"(smem_addr(sp)), "l"(pos + base), "r"(bp), "r"(bar) : "memory");
      }
      asm volatile("{\n .reg .pred done;\n WAIT_%=:\n"
                   " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
                   " @!done bra WAIT_%=;\n}\n" :: "r"(bar), "r"(parity) : "memory");
      parity ^= 1;
    } else {  // a run of `chans` channels a staged window, in 4-byte words
      const int wg = chans * (int)sizeof(T) / 4, wp = chans / 4;
      for (int w = threadIdx.x; w < srows * scols * (wg + wp); w += blockDim.x) {
        const bool is_pos = w >= srows * scols * wg;
        const int per = is_pos ? wp : wg, v = is_pos ? w - srows * scols * wg : w;
        const int win = v / per, k = v - win * per, r = win / scols, jj = win - r * scols;
        const long long o = base + ((long long)r * Wo + jj) * C;
        unsigned* dst = reinterpret_cast<unsigned*>(is_pos ? (void*)(sp + win * chans)
                                                           : (void*)(sg + win * chans));
        dst[k] = __ldg(reinterpret_cast<const unsigned*>(
                     is_pos ? (const void*)(pos + o) : (const void*)(dy + o)) + k);
      }
      __syncthreads();
    }
    // each thread: window (i, j) and V channels at a time, the 2x2 patch of
    // dx it alone owns. Taps are row-major in a window, whose top-left
    // pixel is (2i-1, 2j-1): pixel (2i+r, 2j+s) is tap (r+1)*3 + s+1 of
    // window (i, j). A pixel adds its windows in (i, j) order.
    for (int item = threadIdx.x; item < rows * row_items; item += blockDim.x) {
      const int r = item / row_items, q = item - r * row_items;
      const int jl = q / groups, c = (q - jl * groups) * V;
      const int i = i0 + r, j = j0 + jl;
      const int s = (r * scols + jl) * chans + c;
      float p00[V], p01[V], p10[V], p11[V];  // pixels (2i, 2j), (2i, 2j+1), (2i+1, 2j), (2i+1, 2j+1)
#pragma unroll
      for (int k = 0; k < V; ++k) p00[k] = p01[k] = p10[k] = p11[k] = 0.f;
      Window<V> w;
      read_window(w, sg + s, sp + s);  // (i, j)
      add_tap(p00, w, 4);
      add_tap(p01, w, 5);
      add_tap(p10, w, 7);
      add_tap(p11, w, 8);
      const bool right = j + 1 < Wo, below = i + 1 < Ho;
      if (right) {  // (i, j+1)
        read_window(w, sg + s + chans, sp + s + chans);
        add_tap(p01, w, 3);
        add_tap(p11, w, 6);
      }
      if (below) {  // (i+1, j)
        read_window(w, sg + s + span, sp + s + span);
        add_tap(p10, w, 1);
        add_tap(p11, w, 2);
      }
      if (below && right) {  // (i+1, j+1)
        read_window(w, sg + s + span + chans, sp + s + span + chans);
        add_tap(p11, w, 0);
      }
      const long long in_row = (long long)W * C;
      T* out = dx + ((n * H + 2 * i) * W + 2 * j) * (long long)C + c0 + c;
      const bool col1 = 2 * j + 1 < W;
      store_lanes(out, p00);
      if (col1) store_lanes(out + C, p01);
      if (2 * i + 1 < H) {
        store_lanes(out + in_row, p10);
        if (col1) store_lanes(out + in_row + C, p11);
      }
    }
    __syncthreads();  // every thread is done with the stage before the next frame's
  }
}

long long lmin(long long a, long long b) { return a < b ? a : b; }

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
  const int item = is_bf16 ? 2 : 4;
  // 8 bf16 channels a thread when every staged window starts on a 16-byte
  // line, else 4: C % 8 == 4 would put every other one 8 bytes off
  const int v = is_bf16 && C % 8 == 0 ? 8 : 4;
  if (nt < 1 || C < v) return (int)cudaErrorInvalidValue;
  // the tile whose stage, halo included, fits: whole window rows (at most
  // kBwdRows) where two fit, else kBwdRows rows of as many window columns
  // as fit, else of one column (and its halo) and as many channels as fit
  const long long budget = kBwdStageBytes - 16, unit = (long long)C * (item + 1);
  BwdTiles t;
  t.chans = C;
  t.cols = Wo;
  if (2 * Wo * unit <= budget) {
    t.rows = (int)lmin(kBwdRows, budget / (Wo * unit) - 1);
  } else {
    t.rows = kBwdRows;
    t.cols = (int)(budget / ((kBwdRows + 1) * unit) - 1);
    if (t.cols < 1) {
      t.cols = 1;
      t.chans = (int)(budget / (2 * (kBwdRows + 1) * (item + 1))) / v * v;
    }
  }
  t.col_tiles = (Wo + t.cols - 1) / t.cols;
  t.chan_tiles = (C + t.chans - 1) / t.chans;
  const long long tiles = (long long)((Ho + t.rows - 1) / t.rows) * t.col_tiles * t.chan_tiles;
  const int scols = (int)lmin(t.cols + 1, Wo);
  const int stage = (t.rows + 1) * scols * t.chans;
  t.pos_offset = (stage * item + 15) / 16 * 16;
  t.bulk = t.cols == Wo && t.chans == C && (long long)Wo * C % 16 == 0 &&
           reinterpret_cast<uintptr_t>(dy) % 16 == 0 && reinterpret_cast<uintptr_t>(pos) % 16 == 0;
  // as many threads as spread the tile's items evenly over whole rounds
  const int items = (int)lmin(t.rows, Ho) * (int)lmin(t.cols, Wo) * (t.chans / v);
  const int rounds = (items + kBwdThreads - 1) / kBwdThreads;
  const int threads = ((items + rounds - 1) / rounds + 31) / 32 * 32;
  if (tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)(nt < 65535 ? nt : 65535));
  const size_t smem = t.pos_offset + stage;
  if (v == 8)
    maxpool_bwd_kernel<__nv_bfloat16, 8><<<grid, threads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(dy), pos, static_cast<__nv_bfloat16*>(dx), nt, H,
        W, C, Ho, Wo, t);
  else if (is_bf16)
    maxpool_bwd_kernel<__nv_bfloat16, 4><<<grid, threads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(dy), pos, static_cast<__nv_bfloat16*>(dx), nt, H,
        W, C, Ho, Wo, t);
  else
    maxpool_bwd_kernel<float, 4><<<grid, threads, smem, s>>>(
        static_cast<const float*>(dy), pos, static_cast<float*>(dx), nt, H, W, C, Ho, Wo, t);
  return (int)cudaGetLastError();
}

}  // extern "C"
