// Kernel K2: fused MFCC front-end from frames the caller already holds.
//
// Replaces the TPU kernel tpu_deer/ops/audio_frontend.py:_mfcc_kernel
// (launched by _mfcc_pallas). For every row r of frames [R, n_fft]:
//
//   re/im[r, k] = sum_t x[r, t] * (window-folded cos/sin)[t, k]
//   power       = re^2 + im^2                                  [R, n_bins]
//   logmel      = log(max(power . mel, 1e-10))                 [R, n_mels]
//   mfcc        = logmel . dct                                 [R, n_mfcc]
//
// The streaming tick is its caller: one launch takes the frames of every
// stream of the tick, rows = streams x frames per chunk.
//
// What bounds it on an H100: the function is bound by bytes. As a real FFT
// it needs ~31 kFLOP per frame at n_fft 1024 against 4 KB read and 2.3 KB
// written, so its floor is the memory rate. This kernel does not reach that
// floor: like K1 (csrc/mfcc_signal.cu) it computes the DFT as a dense
// product, 4 * n_fft * (n_fft/2 + 1) = ~2.1 MFLOP per frame, in full float32
// FMAs (not TF32, so that it agrees with the plain float32 twin), which
// makes the card's non-tensor-core f32 rate its own floor. An f32 FFT in
// shared memory is the way to the byte bound.
//
// How it differs from K1, and why it is a file of its own: K1 stages one
// overlapping signal window per block; here the rows are independent, so 32
// of them at n_fft 1024 take 128 KB of shared memory. The kernel keeps that
// to one buffer: the staged frames are read by the DFT, and once every warp
// is past it the same buffer holds the power rows and then the log-mel rows
// (each thread keeps its bin's 32 powers in registers across the barrier).
// So a block needs 32 * n_fft + 2 * n_fft + 32 floats (136 KB at n_fft
// 1024), one block per SM, as K1. Within the dense design: one thread per
// frequency bin for all 32 frames of its block (64 accumulators in
// registers), frame samples from shared memory as 16-byte broadcast loads
// (one load feeds 8 FMAs per bin), and the window-folded bases streamed
// through L2, coalesced along bins, once per block. The Nyquist bin runs
// one warp per frame; mel, log and DCT run from the rows in shared memory.
// n_fft is a template parameter (512 or 1024, n_fft/2 threads a block), so
// the DFT loop has constant bounds; rows past R are staged as zeros and
// their outputs not written.

#include <cuda_runtime.h>

namespace {

constexpr int kFramesPerBlock = 32;

template <int N_FFT>
__global__ void __launch_bounds__(N_FFT / 2, 1)
mfcc_frames_kernel(const float* __restrict__ frames,
                   const float* __restrict__ cos_w,
                   const float* __restrict__ sin_w,
                   const float* __restrict__ mel,
                   const float* __restrict__ dct,
                   float* __restrict__ mfcc, float* __restrict__ logmel,
                   float* __restrict__ power, int n_rows, int n_mels,
                   int n_mfcc, int rows_span) {
  constexpr int kThreads = N_FFT / 2;
  constexpr int kWarps = kThreads / 32;
  constexpr int kHalf = N_FFT / 2;  // bins [0, kHalf) by thread, kHalf by warp
  constexpr int kBins = N_FFT / 2 + 1;
  constexpr int kVec = N_FFT / 4;   // float4 per row
  extern __shared__ __align__(16) float smem[];
  // rows_span floats per frame: the staged frame, later its power row and
  // its log-mel row (rows_span >= max(N_FFT, kBins + n_mels)).
  float* xs = smem;                                  // frames [BF, N_FFT]
  float* ps = smem;                                  // power [BF, kBins]
  float* lms = smem + kFramesPerBlock * kBins;       // logmel [BF, n_mels]
  float* nyq_c = smem + kFramesPerBlock * rows_span; // cos_w[:, kHalf]
  float* nyq_s = nyq_c + N_FFT;                      // sin_w[:, kHalf]
  float* nyq_p = nyq_s + N_FFT;                      // Nyquist power [BF]

  const int tid = threadIdx.x;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * kFramesPerBlock;
  const int n_valid = min(kFramesPerBlock, n_rows - static_cast<int>(row0));

  const float4* src = reinterpret_cast<const float4*>(frames + row0 * N_FFT);
  float4* dst = reinterpret_cast<float4*>(xs);
  for (int i = tid; i < kFramesPerBlock * kVec; i += kThreads)
    dst[i] = i < n_valid * kVec ? __ldg(src + i) : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int t = tid; t < N_FFT; t += kThreads) {
    nyq_c[t] = __ldg(cos_w + static_cast<size_t>(t) * kBins + kHalf);
    nyq_s[t] = __ldg(sin_w + static_cast<size_t>(t) * kBins + kHalf);
  }
  __syncthreads();

  // DFT + power: thread `tid` owns bin k = tid for the block's frames.
  const int k = tid;
  float re[kFramesPerBlock], im[kFramesPerBlock];
#pragma unroll
  for (int f = 0; f < kFramesPerBlock; ++f) {
    re[f] = 0.f;
    im[f] = 0.f;
  }
  const float* cp = cos_w + k;
  const float* sp = sin_w + k;
  for (int t = 0; t < N_FFT; t += 4) {
    const size_t r = static_cast<size_t>(t) * kBins;
    const float c0 = __ldg(cp + r), c1 = __ldg(cp + r + kBins);
    const float c2 = __ldg(cp + r + 2 * kBins), c3 = __ldg(cp + r + 3 * kBins);
    const float s0 = __ldg(sp + r), s1 = __ldg(sp + r + kBins);
    const float s2 = __ldg(sp + r + 2 * kBins), s3 = __ldg(sp + r + 3 * kBins);
#pragma unroll
    for (int f = 0; f < kFramesPerBlock; ++f) {
      const float4 v = *reinterpret_cast<const float4*>(xs + f * N_FFT + t);
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

  // Nyquist bin: one warp per frame.
  const int warp = tid / 32, lane = tid % 32;
  for (int f = warp; f < kFramesPerBlock; f += kWarps) {
    const float* xf = xs + f * N_FFT;
    float nr = 0.f, ni = 0.f;
    for (int t = lane; t < N_FFT; t += 32) {
      nr = fmaf(xf[t], nyq_c[t], nr);
      ni = fmaf(xf[t], nyq_s[t], ni);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      nr += __shfl_xor_sync(0xffffffffu, nr, off);
      ni += __shfl_xor_sync(0xffffffffu, ni, off);
    }
    if (lane == 0) nyq_p[f] = nr * nr + ni * ni;
  }
  __syncthreads();  // every read of the staged frames is done

  // Power rows over the frames' buffer, and out to device memory.
#pragma unroll
  for (int f = 0; f < kFramesPerBlock; ++f) {
    const float p = re[f] * re[f] + im[f] * im[f];
    ps[f * kBins + k] = p;
    if (f < n_valid) power[(row0 + f) * kBins + k] = p;
  }
  for (int f = tid; f < kFramesPerBlock; f += kThreads) {
    ps[f * kBins + kHalf] = nyq_p[f];
    if (f < n_valid) power[(row0 + f) * kBins + kHalf] = nyq_p[f];
  }
  __syncthreads();

  // Mel energies and their log.
  for (int o = tid; o < kFramesPerBlock * n_mels; o += kThreads) {
    const int f = o / n_mels, m = o - f * n_mels;
    const float* pr = ps + f * kBins;
    float e = 0.f;
    for (int b = 0; b < kBins; ++b)
      e = fmaf(pr[b], __ldg(mel + static_cast<size_t>(b) * n_mels + m), e);
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

template <int N_FFT>
int launch(const float* frames, const float* cos_w, const float* sin_w,
           const float* mel, const float* dct, float* mfcc, float* logmel,
           float* power, int n_rows, int n_mels, int n_mfcc,
           cudaStream_t stream) {
  const int rows_span = N_FFT > N_FFT / 2 + 1 + n_mels ? N_FFT : N_FFT / 2 + 1 + n_mels;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(kFramesPerBlock) * rows_span + 2 * N_FFT + kFramesPerBlock);
  cudaError_t err = cudaFuncSetAttribute(
      mfcc_frames_kernel<N_FFT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = (static_cast<unsigned>(n_rows) + kFramesPerBlock - 1) / kFramesPerBlock;
  mfcc_frames_kernel<N_FFT><<<blocks, N_FFT / 2, smem, stream>>>(
      frames, cos_w, sin_w, mel, dct, mfcc, logmel, power, n_rows, n_mels,
      n_mfcc, rows_span);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches K2 on `stream`. All arrays are contiguous float32 on the device,
// `frames` 16-byte aligned: frames [n_rows, n_fft], cos_w/sin_w
// [n_fft, n_fft/2+1], mel [n_fft/2+1, n_mels], dct [n_mels, n_mfcc];
// outputs mfcc [n_rows, n_mfcc], logmel [n_rows, n_mels], power
// [n_rows, n_fft/2+1]. `device` is the card the arrays live on. Returns the
// launch's cudaError_t: cudaErrorInvalidValue for an n_fft other than 512
// or 1024 or a count below 1, and cudaFuncSetAttribute's error when a block
// needs more shared memory than the card allows.
int mfcc_frames_launch(int device, const float* frames, const float* cos_w,
                       const float* sin_w, const float* mel, const float* dct,
                       float* mfcc, float* logmel, float* power, int n_rows,
                       int n_fft, int n_mels, int n_mfcc, cudaStream_t stream) {
  if (n_rows <= 0 || n_mels <= 0 || n_mfcc <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (n_fft) {
    case 512:
      return launch<512>(frames, cos_w, sin_w, mel, dct, mfcc, logmel, power,
                         n_rows, n_mels, n_mfcc, stream);
    case 1024:
      return launch<1024>(frames, cos_w, sin_w, mel, dct, mfcc, logmel, power,
                          n_rows, n_mels, n_mfcc, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* mfcc_frames_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
