// Kernel K1: fused MFCC front-end from the raw (reflect-padded) signal.
//
// Replaces the TPU kernel tpu_deer/ops/audio_frontend.py:_mfcc_signal_kernel
// (launched by _mfcc_signal_pallas). For every frame f of every utterance b:
//
//   re/im[f, k] = sum_t x[b, f*hop + t] * (window-folded cos/sin)[t, k]
//   power       = re^2 + im^2                                  [B, N, n_bins]
//   logmel      = log(max(power . mel, 1e-10))                 [B, N, n_mels]
//   mfcc        = logmel . dct                                 [B, N, n_mfcc]
//   timefeats   = (sqrt(sum_t x^2 w^2 / n_fft),                [B, N, 2]
//                  sign changes / (n_fft - 1))
//
// Frames are never written to device memory: a block stages the contiguous
// signal window of its frames in shared memory and reads every frame (and
// its ZCR pairs) from there.
//
// What bounds it on an H100: the function itself is bound by bytes. Done as
// a real FFT it needs ~33 kFLOP per frame at n_fft 1024 against ~2.3 KB of
// outputs, so its floor is the memory rate. This kernel does not reach that
// floor: it computes the DFT as a dense product, 4 * n_fft * (n_fft/2 + 1)
// = ~2.1 MFLOP per frame, about 60x the FFT's count, in full float32 FMAs
// (not TF32, so that it agrees with the plain float32 version). That makes
// its own floor the card's non-tensor-core f32 rate, far above the byte
// bound; an f32 FFT in shared memory (radix stages over the staged window)
// is the way to the byte bound. Within the dense design the kernel keeps the
// FMA pipes fed and nothing else: each thread owns one frequency
// bin for all 32 frames of its block (64 accumulators in registers), the
// frame samples come from shared memory as 16-byte broadcast loads (one load
// feeds 8 FMAs per bin), and the window-folded bases stream through L2,
// coalesced along bins, once per block. The Nyquist bin, RMS and ZCR run one
// warp per frame; mel, log and DCT run from the power rows kept in shared
// memory, so only the four outputs reach device memory.

#include <cuda_runtime.h>

namespace {

constexpr int kFramesPerBlock = 32;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kHop = 256;  // the hop this build is specialised for

__device__ __forceinline__ int sign_of(float v) { return (v > 0.f) - (v < 0.f); }

template <int HOP>
__global__ void __launch_bounds__(kThreads, 1)
mfcc_signal_kernel(const float* __restrict__ x_pad,
                   const float* __restrict__ cos_w,
                   const float* __restrict__ sin_w,
                   const float* __restrict__ mel,
                   const float* __restrict__ dct,
                   const float* __restrict__ win_sq,
                   float* __restrict__ mfcc, float* __restrict__ logmel,
                   float* __restrict__ power, float* __restrict__ timefeats,
                   int Tp, int n_frames, int n_fft, int n_mels, int n_mfcc) {
  extern __shared__ __align__(16) float smem[];
  const int n_bins = n_fft / 2 + 1;
  const int half = n_fft / 2;  // bins [0, half) by thread, bin `half` by warp
  const int span = (kFramesPerBlock - 1) * HOP + n_fft;
  float* xs = smem;                                // signal window [span]
  float* ps = xs + span;                           // power rows [BF, n_bins]
  float* lms = ps + kFramesPerBlock * n_bins;      // logmel rows [BF, n_mels]
  float* nyq_c = lms + kFramesPerBlock * n_mels;   // cos_w[:, half] [n_fft]
  float* nyq_s = nyq_c + n_fft;                    // sin_w[:, half] [n_fft]

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kFramesPerBlock;
  const int n_valid = min(kFramesPerBlock, n_frames - f0);
  const size_t row0 = static_cast<size_t>(b) * n_frames + f0;
  const float* x = x_pad + static_cast<size_t>(b) * Tp + static_cast<size_t>(f0) * HOP;
  const int avail = Tp - f0 * HOP;

  for (int i = tid; i < span; i += kThreads) xs[i] = i < avail ? x[i] : 0.f;
  for (int t = tid; t < n_fft; t += kThreads) {
    nyq_c[t] = cos_w[static_cast<size_t>(t) * n_bins + half];
    nyq_s[t] = sin_w[static_cast<size_t>(t) * n_bins + half];
  }
  __syncthreads();

  // DFT + power: one bin per thread, the block's frames in registers.
  for (int k = tid; k < half; k += kThreads) {
    float re[kFramesPerBlock], im[kFramesPerBlock];
#pragma unroll
    for (int f = 0; f < kFramesPerBlock; ++f) {
      re[f] = 0.f;
      im[f] = 0.f;
    }
    const float* cp = cos_w + k;
    const float* sp = sin_w + k;
    for (int t = 0; t < n_fft; t += 4) {
      const size_t r = static_cast<size_t>(t) * n_bins;
      const float c0 = __ldg(cp + r), c1 = __ldg(cp + r + n_bins);
      const float c2 = __ldg(cp + r + 2 * n_bins), c3 = __ldg(cp + r + 3 * n_bins);
      const float s0 = __ldg(sp + r), s1 = __ldg(sp + r + n_bins);
      const float s2 = __ldg(sp + r + 2 * n_bins), s3 = __ldg(sp + r + 3 * n_bins);
#pragma unroll
      for (int f = 0; f < kFramesPerBlock; ++f) {
        const float4 v = *reinterpret_cast<const float4*>(xs + f * HOP + t);
        re[f] = fmaf(v.x, c0, re[f]);
        im[f] = fmaf(v.x, s0, im[f]);
        re[f] = fmaf(v.y, c1, re[f]);
        im[f] = fmaf(v.y, s1, im[f]);
        re[f] = fmaf(v.z, c2, re[f]);
        im[f] = fmaf(v.z, s2, im[f]);
        re[f] = fmaf(v.w, c3, re[f]);
        im[f] = fmaf(v.w, s3, im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < kFramesPerBlock; ++f) {
      const float p = re[f] * re[f] + im[f] * im[f];
      ps[f * n_bins + k] = p;
      if (f < n_valid) power[(row0 + f) * n_bins + k] = p;
    }
  }

  // Nyquist bin, windowed RMS and ZCR: one warp per frame.
  const int warp = tid / 32, lane = tid % 32;
  for (int f = warp; f < kFramesPerBlock; f += kWarps) {
    const float* xf = xs + f * HOP;
    float nr = 0.f, ni = 0.f, msq = 0.f;
    int changes = 0;
    for (int t = lane; t < n_fft; t += 32) {
      const float v = xf[t];
      nr = fmaf(v, nyq_c[t], nr);
      ni = fmaf(v, nyq_s[t], ni);
      msq = fmaf(v * v, __ldg(win_sq + t), msq);
      if (t + 1 < n_fft) changes += sign_of(v) != sign_of(xf[t + 1]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      nr += __shfl_xor_sync(0xffffffffu, nr, off);
      ni += __shfl_xor_sync(0xffffffffu, ni, off);
      msq += __shfl_xor_sync(0xffffffffu, msq, off);
      changes += __shfl_xor_sync(0xffffffffu, changes, off);
    }
    if (lane == 0) {
      const float p = nr * nr + ni * ni;
      ps[f * n_bins + half] = p;
      if (f < n_valid) {
        power[(row0 + f) * n_bins + half] = p;
        timefeats[(row0 + f) * 2] = sqrtf(fmaxf(msq / n_fft, 0.f));
        timefeats[(row0 + f) * 2 + 1] =
            static_cast<float>(changes) / static_cast<float>(n_fft - 1);
      }
    }
  }
  __syncthreads();

  // Mel energies and their log, from the power rows in shared memory.
  for (int o = tid; o < kFramesPerBlock * n_mels; o += kThreads) {
    const int f = o / n_mels, m = o - f * n_mels;
    const float* pr = ps + f * n_bins;
    float e = 0.f;
    for (int k = 0; k < n_bins; ++k)
      e = fmaf(pr[k], __ldg(mel + static_cast<size_t>(k) * n_mels + m), e);
    const float lm = logf(fmaxf(e, 1e-10f));
    lms[o] = lm;
    if (f < n_valid) logmel[(row0 + f) * n_mels + m] = lm;
  }
  __syncthreads();

  // DCT-II of the log-mel rows.
  for (int o = tid; o < kFramesPerBlock * n_mfcc; o += kThreads) {
    const int f = o / n_mfcc, j = o - f * n_mfcc;
    if (f >= n_valid) continue;
    const float* lr = lms + f * n_mels;
    float c = 0.f;
    for (int m = 0; m < n_mels; ++m) c = fmaf(lr[m], __ldg(dct + m * n_mfcc + j), c);
    mfcc[(row0 + f) * n_mfcc + j] = c;
  }
}

// Shared memory one block needs at this n_fft, n_mels (bytes).
size_t smem_bytes(int n_fft, int n_mels) {
  const int n_bins = n_fft / 2 + 1;
  const int span = (kFramesPerBlock - 1) * kHop + n_fft;
  return sizeof(float) *
         (static_cast<size_t>(span) + kFramesPerBlock * n_bins +
          kFramesPerBlock * n_mels + 2 * n_fft);
}

}  // namespace

extern "C" {

// Launches K1 on `stream`. All arrays are contiguous float32 on the device:
// x_pad [B, Tp], cos_w/sin_w [n_fft, n_fft/2+1], mel [n_fft/2+1, n_mels],
// dct [n_mels, n_mfcc], win_sq [n_fft]; outputs mfcc [B, n_frames, n_mfcc],
// logmel [B, n_frames, n_mels], power [B, n_frames, n_fft/2+1],
// timefeats [B, n_frames, 2]. `device` is the card the arrays live on.
// Returns the launch's cudaError_t: cudaErrorInvalidValue for a hop other
// than kHop, more than 65535 signals or a signal too short for n_frames,
// and cudaFuncSetAttribute's error when n_fft needs more shared memory than
// a block may have.
int mfcc_signal_launch(int device, const float* x_pad, const float* cos_w,
                       const float* sin_w, const float* mel, const float* dct,
                       const float* win_sq, float* mfcc, float* logmel,
                       float* power, float* timefeats, int B, int Tp,
                       int n_frames, int n_fft, int hop, int n_mels,
                       int n_mfcc, cudaStream_t stream) {
  if (hop != kHop || n_fft % hop != 0 || B <= 0 || n_frames <= 0 ||
      Tp < (n_frames - 1) * hop + n_fft || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(n_fft, n_mels);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      mfcc_signal_kernel<kHop>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_frames + kFramesPerBlock - 1) / kFramesPerBlock, B);
  mfcc_signal_kernel<kHop><<<grid, kThreads, smem, stream>>>(
      x_pad, cos_w, sin_w, mel, dct, win_sq, mfcc, logmel, power, timefeats,
      Tp, n_frames, n_fft, n_mels, n_mfcc);
  return static_cast<int>(cudaGetLastError());
}

const char* mfcc_signal_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
