// Kernel K1: fused MFCC front-end from the raw (reflect-padded) signal.
//
// Replaces the TPU kernel tpu_deer/ops/audio_frontend.py:_mfcc_signal_kernel
// (launched by _mfcc_signal_pallas). For every frame f of every utterance b:
//
//   X[f, k]   = real DFT of x[b, f*hop : f*hop + n_fft] * window, k <= n_fft/2
//   power     = |X|^2                                         [B, N, n_bins]
//   logmel    = log(max(power . mel, 1e-10))                  [B, N, n_mels]
//   mfcc      = logmel . dct                                  [B, N, n_mfcc]
//   timefeats = (sqrt(sum_t (x w)^2 / n_fft),                 [B, N, 2]
//                sign changes / (n_fft - 1))
//
// What bounds it on an H100: bytes. At n_fft 1024 a frame needs ~26 kFLOP
// as a real FFT against 1 KB of new signal and 2.3 KB of outputs, so the
// memory rate is the floor; the power rows are two-thirds of the bytes.
//
// The design (mfcc_fft.cuh holds the parts shared with K2): a block of 8
// warps walks over tiles of 8 consecutive frames of one utterance, as many
// blocks as fit on the card at once. Each tile's overlapping signal window
// ((8-1)*hop + n_fft samples) is staged once in shared memory by cp.async,
// one tile ahead, into one of two buffers, so that the copy of the next
// window runs under this tile's work and a tile needs one barrier to
// start; frames never reach device memory. Each warp then takes one frame:
// windowed samples packed as n_fft/2 complex values, a three-pass Stockham
// FFT with the values in registers and the warp's padded buffer in shared
// memory, the real-FFT post-pass, and the power row written to device
// memory by consecutive lanes. RMS and ZCR come from the same reads of the
// staged window as the FFT's first pass. The mel product over each
// filter's band, the log and the DCT run block-wide on the tile's 8 power
// rows. The twiddles, window, band weights and DCT are copied into shared
// memory once a block. n_fft is a template parameter (512, 1024 or 2048);
// the hop is 256. Each output is one fixed sum, so two runs give the same
// bits.

#include "mfcc_fft.cuh"

namespace {

using mfcc_fft::kThreads;
using mfcc_fft::kWarps;
constexpr int kHop = 256;  // the hop this build is specialised for

template <int N>
__host__ __device__ constexpr int span() {  // samples staged a tile
  return (kWarps - 1) * kHop + N;
}

// cp.async of one float into shared memory (0 when !valid; src must still
// be a valid address), the commit of this thread's copies, and the wait
// for all of them.
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

template <int N>
__global__ void __launch_bounds__(kThreads, 2)
mfcc_signal_kernel(const float* __restrict__ x_pad,
                   const float* __restrict__ cos1,
                   const float* __restrict__ sin1,
                   const float* __restrict__ window,
                   const float* __restrict__ mel,
                   const int* __restrict__ band,
                   const float* __restrict__ dct,
                   float* __restrict__ mfcc, float* __restrict__ logmel,
                   float* __restrict__ power, float* __restrict__ timefeats,
                   int B, int Tp, int n_frames, int n_mels, int n_mfcc) {
  using L = mfcc_fft::Layout<N>;
  extern __shared__ __align__(16) unsigned char smem[];
  const mfcc_fft::Smem<N> s(smem, n_mels, n_mfcc, 2 * span<N>());
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float2* buf = s.buf + warp * L::kBuf;
  const int tiles_per_signal = (n_frames + kWarps - 1) / kWarps;
  const int n_tiles = B * tiles_per_signal;
  const int stride = static_cast<int>(gridDim.x);
  // The window of `tile` into the t-th of two buffers by cp.async (no
  // registers spent); samples past the signal's end come in as 0.
  auto stage = [&](int tile, int t) {
    const int b = tile / tiles_per_signal;
    const int f0 = (tile - b * tiles_per_signal) * kWarps;
    const float* x = x_pad + static_cast<size_t>(b) * Tp +
                     static_cast<size_t>(f0) * kHop;
    const int avail = Tp - f0 * kHop;
    float* xs = s.extra + t * span<N>();
    for (int i = threadIdx.x; i < span<N>(); i += kThreads)
      copy_async(xs + i, i < avail ? x + i : x, i < avail);
    copy_commit();
  };
  if (static_cast<int>(blockIdx.x) < n_tiles) stage(blockIdx.x, 0);
  mfcc_fft::stage_constants<N>(s, cos1, sin1, window, mel, band, dct, n_mels,
                               n_mfcc);

  for (int tile = blockIdx.x, t = 0; tile < n_tiles; tile += stride, t ^= 1) {
    copy_wait_all();
    // This tile's window and the constants are in, and every warp is past
    // the last tile, whose buffer the next tile's copy now fills.
    __syncthreads();
    if (tile + stride < n_tiles) stage(tile + stride, t ^ 1);
    const float* xs = s.extra + t * span<N>();
    const int b = tile / tiles_per_signal;
    const int f0 = (tile - b * tiles_per_signal) * kWarps;
    const int n_valid = min(kWarps, n_frames - f0);
    const size_t row0 = static_cast<size_t>(b) * n_frames + f0;
    if (warp < n_valid) {
      const size_t row = row0 + warp;
      float2 v[L::P];
      float msq = 0.f;
      int changes = 0;
      mfcc_fft::load_frame<N, true>(v, xs + warp * kHop, s.win, lane, msq,
                                    changes);
      mfcc_fft::fft<N>(v, buf, s, lane);
      mfcc_fft::power_row<N>(buf, s, warp, power + row * L::kBins, lane);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        msq += __shfl_xor_sync(0xffffffffu, msq, o);
        changes += __shfl_xor_sync(0xffffffffu, changes, o);
      }
      if (lane == 0) {
        timefeats[row * 2] = sqrtf(fmaxf(msq / N, 0.f));
        timefeats[row * 2 + 1] =
            static_cast<float>(changes) / static_cast<float>(N - 1);
      }
    }
    __syncthreads();  // the tile's power rows are in
    mfcc_fft::mel_dct<N>(s, n_valid, n_mels, n_mfcc, logmel + row0 * n_mels,
                         mfcc + row0 * n_mfcc);
  }
}

// A launch (config == nullptr) with grid min(blocks, tiles), or a query
// that sets the kernel's shared-memory limit and reports config[0] = the
// dynamic shared memory of a block (bytes), config[1] = the blocks the
// card holds at once. The query goes first on each card.
template <int N>
int run(const float* x_pad, const float* cos1, const float* sin1,
        const float* window, const float* mel, const int* band,
        const float* dct, float* mfcc, float* logmel, float* power,
        float* timefeats, int B, int Tp, int n_frames, int n_mels,
        int n_mfcc, int blocks, cudaStream_t stream, int* config) {
  using L = mfcc_fft::Layout<N>;
  if (!L::fits(n_mels)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = L::bytes(n_mels, n_mfcc, 2 * span<N>());
  if (config) {
    cudaError_t err = cudaSuccess;
    config[0] = static_cast<int>(smem);
    config[1] = mfcc_fft::resident_blocks(mfcc_signal_kernel<N>, smem, &err);
    return static_cast<int>(err);
  }
  const long long tiles =
      static_cast<long long>(B) * ((n_frames + kWarps - 1) / kWarps);
  const int grid = static_cast<int>(blocks < tiles ? blocks : tiles);
  mfcc_signal_kernel<N><<<grid, kThreads, smem, stream>>>(
      x_pad, cos1, sin1, window, mel, band, dct, mfcc, logmel, power,
      timefeats, B, Tp, n_frames, n_mels, n_mfcc);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int device, const float* x_pad, const float* cos1,
             const float* sin1, const float* window, const float* mel,
             const int* band, const float* dct, float* mfcc, float* logmel,
             float* power, float* timefeats, int B, int Tp, int n_frames,
             int n_fft, int hop, int n_mels, int n_mfcc, int blocks,
             cudaStream_t stream, int* config) {
  if (hop != kHop || B <= 0 || n_frames <= 0 || n_mels <= 0 || n_mfcc <= 0 ||
      Tp < (n_frames - 1) * hop + n_fft || (!config && blocks <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const mfcc_fft::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  switch (n_fft) {
    case 512:
      return run<512>(x_pad, cos1, sin1, window, mel, band, dct, mfcc, logmel,
                      power, timefeats, B, Tp, n_frames, n_mels, n_mfcc,
                      blocks, stream, config);
    case 1024:
      return run<1024>(x_pad, cos1, sin1, window, mel, band, dct, mfcc,
                       logmel, power, timefeats, B, Tp, n_frames, n_mels,
                       n_mfcc, blocks, stream, config);
    case 2048:
      return run<2048>(x_pad, cos1, sin1, window, mel, band, dct, mfcc,
                       logmel, power, timefeats, B, Tp, n_frames, n_mels,
                       n_mfcc, blocks, stream, config);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches K1 on `stream`. All arrays are contiguous on the device, float32
// unless said: x_pad [B, Tp]; cos1, sin1 = row 1 of the real-DFT bases
// (cos(2 pi k/n_fft), -sin(2 pi k/n_fft), k = 0..n_fft/2); window [n_fft];
// mel [n_fft/2+1, n_mels]; band int32 [2, n_mels] (each filter's first
// nonzero bin and one past its last); dct [n_mels, n_mfcc]; outputs mfcc
// [B, n_frames, n_mfcc], logmel [B, n_frames, n_mels], power
// [B, n_frames, n_fft/2+1], timefeats [B, n_frames, 2]. `device` is the
// card the arrays live on; `blocks` is mfcc_signal_config's config[1] for
// that card, whose query must come first. Returns the launch's
// cudaError_t: cudaErrorInvalidValue for a hop other than 256, an n_fft
// other than 512, 1024 or 2048, a signal too short for n_frames or too
// many mel filters.
int mfcc_signal_launch(int device, const float* x_pad, const float* cos1,
                       const float* sin1, const float* window,
                       const float* mel, const int* band, const float* dct,
                       float* mfcc, float* logmel, float* power,
                       float* timefeats, int B, int Tp, int n_frames,
                       int n_fft, int hop, int n_mels, int n_mfcc, int blocks,
                       cudaStream_t stream) {
  return dispatch(device, x_pad, cos1, sin1, window, mel, band, dct, mfcc,
                  logmel, power, timefeats, B, Tp, n_frames, n_fft, hop,
                  n_mels, n_mfcc, blocks, stream, nullptr);
}

// Sets K1's shared-memory limit for these sizes on `device` and reports,
// launching nothing: config[0] = the dynamic shared memory of a block
// (bytes), config[1] = the blocks the card holds at once. Returns the
// cudaError_t; cudaFuncSetAttribute's error when a block needs more shared
// memory than the card allows.
int mfcc_signal_config(int device, int n_fft, int n_mels, int n_mfcc,
                       int* config) {
  return dispatch(device, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1,
                  n_fft, 1, n_fft, kHop, n_mels, n_mfcc, 0, nullptr, config);
}

const char* mfcc_signal_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
