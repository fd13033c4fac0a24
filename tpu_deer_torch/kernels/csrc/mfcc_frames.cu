// Kernel K2: fused MFCC front-end from frames the caller already holds.
//
// Replaces the TPU kernel tpu_deer/ops/audio_frontend.py:_mfcc_kernel
// (launched by _mfcc_pallas). For every row r of frames [R, n_fft]:
//
//   X[r, k] = real DFT of frames[r] * window, k <= n_fft/2
//   power   = |X|^2                                          [R, n_bins]
//   logmel  = log(max(power . mel, 1e-10))                   [R, n_mels]
//   mfcc    = logmel . dct                                   [R, n_mfcc]
//
// The streaming tick is its caller: one launch takes the frames of every
// stream of the tick, rows = streams x frames per chunk.
//
// What bounds it on an H100: bytes. At n_fft 1024 a row needs ~26 kFLOP as
// a real FFT against 4 KB read and 2.3 KB written, so the memory rate is
// the floor.
//
// The design: K1's FFT and per-tile tail (mfcc_fft.cuh), with rows in
// place of the staged signal. A block of 8 warps copies the twiddles,
// window, band weights and DCT into shared memory once, and walks over
// tiles of 8 rows (as many blocks as fit on the card at once). Each warp
// copies its row into its buffer in shared memory with 16-byte loads (the
// first tile's while the constants come in), takes the FFT's first inputs
// from there and runs the FFT and the power row; then the block runs the
// mel product over each filter's band, the log and the DCT on the tile's 8
// power rows, as K1 does. n_fft is a template parameter (512 or 1024).
// Each output is one fixed sum, so two runs give the same bits.

#include "mfcc_fft.cuh"

namespace {

using mfcc_fft::kThreads;
using mfcc_fft::kWarps;

template <int N>
__global__ void __launch_bounds__(kThreads, 2)
mfcc_frames_kernel(const float* __restrict__ frames,
                   const float* __restrict__ cos1,
                   const float* __restrict__ sin1,
                   const float* __restrict__ window,
                   const float* __restrict__ mel,
                   const int* __restrict__ band,
                   const float* __restrict__ dct,
                   float* __restrict__ mfcc, float* __restrict__ logmel,
                   float* __restrict__ power, int n_rows, int n_mels,
                   int n_mfcc) {
  using L = mfcc_fft::Layout<N>;
  extern __shared__ __align__(16) unsigned char smem[];
  const mfcc_fft::Smem<N> s(smem, n_mels, n_mfcc, 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float2* buf = s.buf + warp * L::kBuf;
  float4* raw = reinterpret_cast<float4*>(buf);  // the row, before the FFT
  const int n_tiles = (n_rows + kWarps - 1) / kWarps;
  // The warp's row of `tile` into its buffer, 16 bytes a load.
  auto stage = [&](int tile) {
    const int row = tile * kWarps + warp;
    if (row >= n_rows) return;
    const float4* src =
        reinterpret_cast<const float4*>(frames + static_cast<size_t>(row) * N);
#pragma unroll
    for (int c = 0; c < N / 128; ++c)
      raw[lane + 32 * c] = __ldg(src + lane + 32 * c);
  };
  // The first row's loads are in flight while the constants come in.
  if (static_cast<int>(blockIdx.x) < n_tiles) stage(blockIdx.x);
  mfcc_fft::stage_constants<N>(s, cos1, sin1, window, mel, band, dct, n_mels,
                               n_mfcc);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * kWarps, row = row0 + warp;
    const int n_valid = min(kWarps, n_rows - row0);
    // The constants are in; past the first tile, the last tile's rows are
    // read and this tile's may come in.
    __syncthreads();
    if (tile != static_cast<int>(blockIdx.x)) stage(tile);
    if (warp < n_valid) {
      __syncwarp();
      float2 v[L::P];
      float msq = 0.f;
      int changes = 0;
      mfcc_fft::load_frame<N, false>(v, reinterpret_cast<const float*>(raw),
                                     s.win, lane, msq, changes);
      __syncwarp();  // the row is read; the FFT writes over it
      mfcc_fft::fft<N>(v, buf, s, lane);
      mfcc_fft::power_row<N>(buf, s, warp,
                             power + static_cast<size_t>(row) * L::kBins, lane);
    }
    __syncthreads();  // the tile's power rows are in
    mfcc_fft::mel_dct<N>(s, n_valid, n_mels, n_mfcc,
                         logmel + static_cast<size_t>(row0) * n_mels,
                         mfcc + static_cast<size_t>(row0) * n_mfcc);
  }
}

// A launch (config == nullptr) with grid min(blocks, tiles), or a query
// that sets the kernel's shared-memory limit and reports config[0] = the
// dynamic shared memory of a block (bytes), config[1] = the blocks the
// card holds at once. The query goes first on each card.
template <int N>
int run(const float* frames, const float* cos1, const float* sin1,
        const float* window, const float* mel, const int* band,
        const float* dct, float* mfcc, float* logmel, float* power,
        int n_rows, int n_mels, int n_mfcc, int blocks, cudaStream_t stream,
        int* config) {
  using L = mfcc_fft::Layout<N>;
  if (!L::fits(n_mels)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = L::bytes(n_mels, n_mfcc, 0);
  if (config) {
    cudaError_t err = cudaSuccess;
    config[0] = static_cast<int>(smem);
    config[1] = mfcc_fft::resident_blocks(mfcc_frames_kernel<N>, smem, &err);
    return static_cast<int>(err);
  }
  const int tiles = (n_rows + kWarps - 1) / kWarps;
  const int grid = blocks < tiles ? blocks : tiles;
  mfcc_frames_kernel<N><<<grid, kThreads, smem, stream>>>(
      frames, cos1, sin1, window, mel, band, dct, mfcc, logmel, power, n_rows,
      n_mels, n_mfcc);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int device, const float* frames, const float* cos1,
             const float* sin1, const float* window, const float* mel,
             const int* band, const float* dct, float* mfcc, float* logmel,
             float* power, int n_rows, int n_fft, int n_mels, int n_mfcc,
             int blocks, cudaStream_t stream, int* config) {
  if (n_rows <= 0 || n_mels <= 0 || n_mfcc <= 0 || (!config && blocks <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const mfcc_fft::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  switch (n_fft) {
    case 512:
      return run<512>(frames, cos1, sin1, window, mel, band, dct, mfcc,
                      logmel, power, n_rows, n_mels, n_mfcc, blocks, stream,
                      config);
    case 1024:
      return run<1024>(frames, cos1, sin1, window, mel, band, dct, mfcc,
                       logmel, power, n_rows, n_mels, n_mfcc, blocks, stream,
                       config);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches K2 on `stream`. All arrays are contiguous on the device, float32
// unless said, `frames` 16-byte aligned: frames [n_rows, n_fft]; cos1, sin1
// = row 1 of the real-DFT bases (cos(2 pi k/n_fft), -sin(2 pi k/n_fft),
// k = 0..n_fft/2); window [n_fft]; mel [n_fft/2+1, n_mels]; band int32
// [2, n_mels] (each filter's first nonzero bin and one past its last); dct
// [n_mels, n_mfcc]; outputs mfcc [n_rows, n_mfcc], logmel [n_rows, n_mels],
// power [n_rows, n_fft/2+1]. `device` is the card the arrays live on;
// `blocks` is mfcc_frames_config's config[1] for that card, whose query
// must come first. Returns the launch's cudaError_t: cudaErrorInvalidValue
// for an n_fft other than 512 or 1024, a count below 1 or too many mel
// filters.
int mfcc_frames_launch(int device, const float* frames, const float* cos1,
                       const float* sin1, const float* window,
                       const float* mel, const int* band, const float* dct,
                       float* mfcc, float* logmel, float* power, int n_rows,
                       int n_fft, int n_mels, int n_mfcc, int blocks,
                       cudaStream_t stream) {
  return dispatch(device, frames, cos1, sin1, window, mel, band, dct, mfcc,
                  logmel, power, n_rows, n_fft, n_mels, n_mfcc, blocks, stream,
                  nullptr);
}

// Sets K2's shared-memory limit for these sizes on `device` and reports,
// launching nothing: config[0] = the dynamic shared memory of a block
// (bytes), config[1] = the blocks the card holds at once. Returns the
// cudaError_t; cudaFuncSetAttribute's error when a block needs more shared
// memory than the card allows.
int mfcc_frames_config(int device, int n_fft, int n_mels, int n_mfcc,
                       int* config) {
  return dispatch(device, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, nullptr, nullptr, nullptr, 1, n_fft,
                  n_mels, n_mfcc, 0, nullptr, config);
}

const char* mfcc_frames_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
