// The FFT and the per-frame tail shared by kernels K1 (mfcc_signal.cu) and
// K2 (mfcc_frames.cu): windowed frame -> power spectrum -> log-mel -> MFCC.
//
// One warp owns one frame. A real frame of N = n_fft samples is packed as
// M = N/2 complex values z[j] = x[2j] w[2j] + i x[2j+1] w[2j+1]; an M-point
// complex FFT of z runs in three Stockham passes (radix 16-16-2 at M = 512,
// 16-16-4 at M = 1024, 8-8-4 at M = 256), each thread holding P = M/32
// values in registers: it reads its inputs of a pass, butterflies them in
// registers and writes them back to the warp's buffer in shared memory, so
// a frame makes two round trips through shared memory after its first read.
// The warp's buffer is padded by one float2 every 16, which keeps every
// pass's reads and the radix-16 passes' writes free of bank conflicts. The
// usual real-FFT post-pass splits Z into the bins 0..M of the real
// spectrum: X[k] = E[k] + W^k O[k], with E, O the transforms of the even
// and odd samples, X[0] = Re Z[0] + Im Z[0] and X[M] = Re Z[0] - Im Z[0].
//
// Twiddles: every factor between passes and in the post-pass is an entry
// of row 1 of the real-DFT bases (cos(2 pi k/N), -sin(2 pi k/N), k = 0..M,
// float32 correctly rounded), copied once a block into shared memory, the
// factors of each pass laid out so that a warp reads them on consecutive
// addresses; W^e for e > M is -W^(e-M), exact. The factors inside a
// radix-2/4/8/16 butterfly are the same values as float literals.
//
// A block works on 8 frames at a time (a tile), and the mel product, log
// and DCT-II run block-wide once the tile's 8 power rows are in shared
// memory: a lane takes one filter (or coefficient) of one frame, 8 lanes a
// filter for the 8 frames, whose rows are skewed 4 banks apart so that a
// step is one conflict-free load besides a broadcast weight. Filter m sums
// only its band of nonzero bins [lo_m, hi_m), in ascending bin order (a
// float32 FMA chain): adding the skipped exact zeros would not change a
// bit. The band weights are gathered once a block into shared memory.
// Every output is one fixed sum: no atomics, so two runs give the same
// bits.

#pragma once

#include <cuda_runtime.h>

namespace mfcc_fft {

constexpr int kWarps = 8;  // frames a block works on at a time, one a warp
constexpr int kThreads = 32 * kWarps;

// Radices of the three Stockham passes of an M-point FFT (M = n_fft / 2).
template <int M> struct Plan;
template <> struct Plan<256> { static constexpr int R0 = 8, R1 = 8, R2 = 4; };
template <> struct Plan<512> { static constexpr int R0 = 16, R1 = 16, R2 = 2; };
template <> struct Plan<1024> { static constexpr int R0 = 16, R1 = 16, R2 = 4; };

// Shared memory of one block at n_fft N, in float2 / float / int units.
template <int N>
struct Layout {
  static constexpr int M = N / 2;
  static constexpr int P = M / 32;              // values a thread holds
  static constexpr int kBins = M + 1;
  static constexpr int kBuf = M + M / 16;       // a warp's padded buffer
  using PL = Plan<M>;
  static constexpr int kTw1 = (PL::R1 - 1) * PL::R0;              // pass 1
  static constexpr int kTw2 = (PL::R2 - 1) * PL::R0 * PL::R1;     // pass 2
  static constexpr int kWtsCap = 2 * kBins;  // band weights: a bin lies in
                                             // at most two triangles
  // float2: buffers, post-pass twiddles, pass twiddles.
  static constexpr int kFloat2 = kWarps * kBuf + kBins + kTw1 + kTw2;
  // Bytes for the given mel/DCT sizes and `extra` floats (K1's windows).
  static size_t bytes(int n_mels, int n_mfcc, int extra) {
    return sizeof(float2) * kFloat2 +
           sizeof(float) * (static_cast<size_t>(N) + kWtsCap + extra +
                            static_cast<size_t>(n_mels) * n_mfcc) +
           sizeof(int) * 3 * static_cast<size_t>(n_mels);
  }
  // Frame f's power row and log-mel row lie in its warp's buffer from
  // float 4 f on (a skew of 4 banks a frame, see row()).
  static bool fits(int n_mels) {
    return 4 * (kWarps - 1) + kBins + n_mels <= 2 * kBuf;
  }
};

// Pointers into a block's shared memory (see Layout::bytes for the order).
template <int N>
struct Smem {
  using L = Layout<N>;
  float2* buf;   // [kWarps][kBuf]
  float2* twb;   // W^k, k = 0..M (post-pass)
  float2* tw1;   // pass 1: [(r - 1) * R0 + k] = W_{R0 R1}^(k r)
  float2* tw2;   // pass 2: [(r - 1) * R0 R1 + k] = W_M^(k r)
  float* win;    // [N]
  float* wts;    // band weights, filter m at off[m]
  float* extra;  // K1: the staged signal windows (8-byte aligned)
  float* dct;    // [n_mels][n_mfcc]
  int* lo;       // [n_mels] first nonzero bin of each filter
  int* hi;       // [n_mels] one past its last
  int* off;      // [n_mels] where its weights start in wts
  __device__ Smem(void* base, int n_mels, int n_mfcc, int extra_floats) {
    buf = static_cast<float2*>(base);
    twb = buf + kWarps * L::kBuf;
    tw1 = twb + L::kBins;
    tw2 = tw1 + L::kTw1;
    win = reinterpret_cast<float*>(tw2 + L::kTw2);
    wts = win + N;
    extra = wts + L::kWtsCap;
    dct = extra + extra_floats;
    lo = reinterpret_cast<int*>(dct + n_mels * n_mfcc);
    hi = lo + n_mels;
    off = hi + n_mels;
  }
};

// Frame f's power row (kBins floats, then its log-mel row) in the buffer of
// warp f, from float 4 f on: with buffers a multiple of 32 floats apart,
// the tile's 8 rows then start 4 banks apart, so 8 lanes reading one bin
// (or one filter) of the 8 frames hit 8 different banks.
template <int N>
__device__ __forceinline__ float* row(const Smem<N>& s, int f) {
  return reinterpret_cast<float*>(s.buf + f * Layout<N>::kBuf) + 4 * f;
}

__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// x * W_16^e for 0 <= e < 8 (W = exp(-2 pi i / 16)), float32 literals.
template <int E>
__device__ __forceinline__ float2 twiddle16(float2 x) {
  constexpr float c1 = 0.92387953251128675613f;  // cos(pi/8)
  constexpr float s1 = 0.38268343236508977173f;  // sin(pi/8)
  constexpr float h = 0.70710678118654752440f;   // sqrt(1/2)
  if constexpr (E == 0) return x;
  else if constexpr (E == 4) return make_float2(x.y, -x.x);  // x * -i
  else if constexpr (E == 1) return cmul(x, make_float2(c1, -s1));
  else if constexpr (E == 2) return cmul(x, make_float2(h, -h));
  else if constexpr (E == 3) return cmul(x, make_float2(s1, -c1));
  else if constexpr (E == 5) return cmul(x, make_float2(-s1, -c1));
  else if constexpr (E == 6) return cmul(x, make_float2(-h, -h));
  else return cmul(x, make_float2(-c1, -s1));
}

// In-register forward FFT of R points (radix-2 decimation in time),
// natural order in and out.
template <int R>
struct Fft {
  template <int K>
  static __device__ __forceinline__ void combine(float2* v, const float2* e,
                                                 const float2* o) {
    if constexpr (K < R / 2) {
      const float2 t = twiddle16<K * 16 / R>(o[K]);
      v[K] = make_float2(e[K].x + t.x, e[K].y + t.y);
      v[K + R / 2] = make_float2(e[K].x - t.x, e[K].y - t.y);
      combine<K + 1>(v, e, o);
    }
  }
  static __device__ __forceinline__ void run(float2* v) {
    float2 e[R / 2], o[R / 2];
#pragma unroll
    for (int i = 0; i < R / 2; ++i) {
      e[i] = v[2 * i];
      o[i] = v[2 * i + 1];
    }
    Fft<R / 2>::run(e);
    Fft<R / 2>::run(o);
    combine<0>(v, e, o);
  }
};
template <>
struct Fft<1> {
  static __device__ __forceinline__ void run(float2*) {}
};

// W_N^e for 0 <= e < N from row 1 of the cos/sin bases (entries 0..N/2).
template <int N>
__device__ __forceinline__ float2 table_twiddle(const float* cos1,
                                                const float* sin1, int e) {
  constexpr int M = N / 2;
  return e <= M ? make_float2(__ldg(cos1 + e), __ldg(sin1 + e))
                : make_float2(-__ldg(cos1 + e - M), -__ldg(sin1 + e - M));
}

// Block-wide: twiddles, window, band table and weights, DCT into shared
// memory. The caller synchronises the block afterwards.
template <int N>
__device__ void stage_constants(const Smem<N>& s, const float* cos1,
                                const float* sin1, const float* window,
                                const float* mel, const int* band,
                                const float* dct, int n_mels, int n_mfcc) {
  using L = Layout<N>;
  using PL = typename L::PL;
  constexpr int NS1 = PL::R0, NS2 = PL::R0 * PL::R1;
  const int tid = threadIdx.x;
  for (int k = tid; k < L::kBins; k += kThreads)
    s.twb[k] = make_float2(__ldg(cos1 + k), __ldg(sin1 + k));
  for (int i = tid; i < L::kTw1; i += kThreads) {
    const int r = i / NS1 + 1, k = i % NS1;
    s.tw1[i] = table_twiddle<N>(cos1, sin1, k * r * (N / (NS1 * PL::R1)));
  }
  for (int i = tid; i < L::kTw2; i += kThreads) {
    const int r = i / NS2 + 1, k = i % NS2;
    s.tw2[i] = table_twiddle<N>(cos1, sin1, k * r * (N / (NS2 * PL::R2)));
  }
  for (int t = tid; t < N; t += kThreads) s.win[t] = __ldg(window + t);
  for (int i = tid; i < n_mels * n_mfcc; i += kThreads) s.dct[i] = __ldg(dct + i);
  for (int m = tid; m < n_mels; m += kThreads) {
    s.lo[m] = __ldg(band + m);
    s.hi[m] = __ldg(band + n_mels + m);
  }
  __syncthreads();
  for (int m = tid; m < n_mels; m += kThreads) {
    int o = 0;
    for (int q = 0; q < m; ++q) o += s.hi[q] - s.lo[q];
    s.off[m] = o;
  }
  __syncthreads();
  // The band weights, one a thread: weight i belongs to the last filter
  // whose offset is <= i (an empty filter shares its offset with the next).
  const int total = s.off[n_mels - 1] + s.hi[n_mels - 1] - s.lo[n_mels - 1];
  if (total > L::kWtsCap) __trap();  // not a mel filterbank
  for (int i = tid; i < total; i += kThreads) {
    int a = 0, b = n_mels - 1;
    while (a < b) {
      const int c = (a + b + 1) / 2;
      if (s.off[c] <= i) a = c; else b = c - 1;
    }
    const int k = s.lo[a] + i - s.off[a];
    s.wts[i] = __ldg(mel + static_cast<size_t>(k) * n_mels + a);
  }
}

__device__ __forceinline__ int sign_of(float v) { return (v > 0.f) - (v < 0.f); }

// The first pass's inputs, windowed, from a frame of N samples in shared
// memory (8-byte aligned): v[b R0 + r] = z[lane + 32 b + r M/R0]. With
// kTime, also the frame's sum of squared windowed samples and its count of
// sign changes of the raw samples.
template <int N, bool kTime>
__device__ __forceinline__ void load_frame(float2* v, const float* src,
                                           const float* win, int lane,
                                           float& msq, int& changes) {
  using L = Layout<N>;
  constexpr int M = L::M, R = L::PL::R0;
#pragma unroll
  for (int b = 0; b < L::P / R; ++b) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + 32 * b + r * (M / R);
      const float2 x = *reinterpret_cast<const float2*>(src + 2 * i);
      const float2 w = *reinterpret_cast<const float2*>(win + 2 * i);
      const float2 z = make_float2(__fmul_rn(x.x, w.x), __fmul_rn(x.y, w.y));
      v[b * R + r] = z;
      if constexpr (kTime) {
        msq = fmaf(z.x, z.x, msq);
        msq = fmaf(z.y, z.y, msq);
        changes += sign_of(x.x) != sign_of(x.y);
        if (i + 1 < M) changes += sign_of(x.y) != sign_of(src[2 * i + 2]);
      }
    }
  }
}

// One Stockham pass from registers: twiddle (stride NS > 1), butterfly,
// and write to the warp's buffer in the order of the next pass.
template <int M, int R, int NS>
__device__ __forceinline__ void pass_store(float2* v, float2* buf,
                                           const float2* tw, int lane) {
  constexpr int P = M / 32;
#pragma unroll
  for (int b = 0; b < P / R; ++b) {
    const int j = lane + 32 * b;
    const int k = j & (NS - 1);
    float2* u = v + b * R;
    if constexpr (NS > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r) u[r] = cmul(u[r], tw[(r - 1) * NS + k]);
    }
    Fft<R>::run(u);
    const int d = (j / NS) * NS * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) buf[pad(d + r * NS)] = u[r];
  }
}

// The next pass's inputs from the warp's buffer.
template <int M, int R>
__device__ __forceinline__ void pass_load(float2* v, const float2* buf, int lane) {
  constexpr int P = M / 32;
#pragma unroll
  for (int b = 0; b < P / R; ++b) {
#pragma unroll
    for (int r = 0; r < R; ++r) v[b * R + r] = buf[pad(lane + 32 * b + r * (M / R))];
  }
}

// The M-point FFT of the packed frame in v (first pass's order); Z[k] ends
// in buf[pad(k)]. Ends with the warp synchronised.
template <int N>
__device__ __forceinline__ void fft(float2* v, float2* buf, const Smem<N>& s,
                                    int lane) {
  using L = Layout<N>;
  using PL = typename L::PL;
  constexpr int M = L::M;
  pass_store<M, PL::R0, 1>(v, buf, nullptr, lane);
  __syncwarp();
  pass_load<M, PL::R1>(v, buf, lane);
  __syncwarp();
  pass_store<M, PL::R1, PL::R0>(v, buf, s.tw1, lane);
  __syncwarp();
  pass_load<M, PL::R2>(v, buf, lane);
  __syncwarp();
  pass_store<M, PL::R2, PL::R0 * PL::R1>(v, buf, s.tw2, lane);
  __syncwarp();
}

// Real-FFT post-pass: the power of bins 0..M from Z in warp f's buffer,
// written over that buffer as frame f's power row (row(s, f)) and to
// `power` (the frame's row in device memory, consecutive lanes on
// consecutive bins).
template <int N>
__device__ __forceinline__ void power_row(float2* buf, const Smem<N>& s,
                                          int f, float* power, int lane) {
  using L = Layout<N>;
  constexpr int M = L::M, C = L::P + 1;
  float p[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int k = lane + 32 * c;
    if (k == 0 || k >= M) {  // X[0], X[M] from Z[0] (lane 0 only)
      const float2 a = buf[0];
      const float x = k == 0 ? a.x + a.y : a.x - a.y;
      p[c] = x * x;
    } else {
      const float2 a = buf[pad(k)], b = buf[pad(M - k)], w = s.twb[k];
      const float ex = (a.x + b.x) * 0.5f, ey = (a.y - b.y) * 0.5f;
      const float ox = (a.y + b.y) * 0.5f, oy = (b.x - a.x) * 0.5f;
      const float xr = ex + (w.x * ox - w.y * oy);
      const float xi = ey + (w.x * oy + w.y * ox);
      p[c] = xr * xr + xi * xi;
    }
  }
  __syncwarp();  // every read of Z is done
  float* pw = row(s, f);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int k = lane + 32 * c;
    if (k <= M) {
      pw[k] = p[c];
      power[k] = p[c];
    }
  }
  __syncwarp();
}

// Block-wide, after the tile's power rows are in: the log-mel of each
// filter over its band and the DCT-II, for the tile's frames f < n_valid,
// whose rows of `logmel` and `mfcc` start at the given pointers (rows of
// n_mels and n_mfcc floats). A warp step takes 4 filters (or 4
// coefficients) x the 8 frames: lane = 8 g + f. The 8 lanes of a filter
// read one bin of 8 skewed rows (8 banks) and share its weight, so a step
// is one conflict-free load besides a broadcast. Filter m sums its band in
// ascending bin order (a float32 FMA chain); coefficient j sums the
// filters in ascending order. Groups of 4 consecutive filters (similar
// widths) go to the warps widest first, in snake order.
template <int N>
__device__ __forceinline__ void mel_dct(const Smem<N>& s, int n_valid,
                                        int n_mels, int n_mfcc, float* logmel,
                                        float* mfcc) {
  using L = Layout<N>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 8, f = lane % 8;
  const float* pw = row(s, f);
  float* lm = row(s, f) + L::kBins;
  const int groups = (n_mels + 3) / 4;
  for (int i = 0; i < groups; ++i) {
    const int round = i / kWarps, pos = i % kWarps;
    if ((round & 1 ? kWarps - 1 - pos : pos) != warp) continue;
    const int m = 4 * (groups - 1 - i) + g;
    if (m >= n_mels) continue;
    const int lo = s.lo[m], n = s.hi[m] - lo;
    const float* p = pw + lo;
    const float* w = s.wts + s.off[m];
    float e = 0.f;
#pragma unroll 4
    for (int k = 0; k < n; ++k) e = fmaf(p[k], w[k], e);
    const float l = logf(fmaxf(e, 1e-10f));
    lm[m] = l;
    if (f < n_valid) logmel[f * n_mels + m] = l;
  }
  __syncthreads();
  for (int j = 4 * warp + g; j < n_mfcc; j += 4 * kWarps) {
    float c = 0.f;
#pragma unroll 8
    for (int m = 0; m < n_mels; ++m) c = fmaf(lm[m], s.dct[m * n_mfcc + j], c);
    if (f < n_valid) mfcc[f * n_mfcc + j] = c;
  }
}

// Sets `kernel`'s dynamic shared-memory limit to `smem` on the current
// card and returns how many of its blocks the card holds at once (0 when
// none fits): the grid of a launch, which walks over the tiles.
template <typename Kernel>
int resident_blocks(Kernel kernel, size_t smem, cudaError_t* err) {
  int device = 0, per_sm = 0, sms = 0;
  if ((*err = cudaFuncSetAttribute(kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem))) != cudaSuccess ||
      (*err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess ||
      (*err = cudaGetDevice(&device)) != cudaSuccess ||
      (*err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     device)) != cudaSuccess)
    return 0;
  return per_sm * sms;
}

// Makes `device` current for its lifetime and restores the caller's card.
struct DeviceGuard {
  int previous = -1;
  cudaError_t err;
  explicit DeviceGuard(int device) {
    err = cudaGetDevice(&previous);
    if (err == cudaSuccess && previous != device) err = cudaSetDevice(device);
  }
  ~DeviceGuard() {
    int now = -1;
    if (previous >= 0 && cudaGetDevice(&now) == cudaSuccess && now != previous)
      cudaSetDevice(previous);
  }
};

}  // namespace mfcc_fft
