// The gradient of a token-embedding lookup, summed in an order fixed by the
// ids alone, so that two runs give the same bits.
//
// Not a TPU kernel. The reference looks rows up with flax nn.Embed
// (tpu_deer/models/encoders.py:328), whose gradient XLA computes as a
// scatter-add that repeats bit for bit; PyTorch's CUDA embedding backward
// adds with atomics in an order that varies by run, and a seeded training
// run then parts after its first step. For ids [n] and dX [n, D]:
//
//   dW[v] = Σ dX[i] over the positions i with ids[i] = v     (dW [V, D])
//
// The caller sorts the ids stably (torch.sort(stable=True): the order it
// returns depends on the ids alone) and passes the sorted ids and the
// permutation; dW arrives zeroed (ids that never occur keep 0). Two passes,
// no atomics:
//   A. One warp a piece of kPiece consecutive sorted positions. It walks
//      them in order, adding dX's rows (lane l holds columns l, l + 32, ...,
//      so each row is read as whole 128-byte runs), and at the end of each
//      run of one id writes the sum: straight into dW when the run lies
//      inside the piece, else into the piece's partial slots, `head` for the
//      run that holds the piece's first position and `tail` for a later run
//      that goes on past the piece's end.
//   B. One block a piece. The piece where a run that crosses pieces starts
//      finds the run's end by binary search, sums its partials over the
//      pieces it covers (warp w takes every kWarpsB-th piece, in order; the
//      warps' sums are added in warp order) and writes dW.
// The padding id, which holds ~99% of the positions of a batch of long
// transcripts, is thus summed by every warp of pass A and joined by one
// block of pass B over its ~n/kPiece partials.
//
// What bounds it on an H100: bytes. dX is read once (131,072 × 128 floats,
// 67 MB, on the raw trainer's padded transcripts), the ids and the
// permutation once, dW written once: ~0.02 ms at 3.35 TB/s. Pass A keeps
// kBatch rows of loads in flight a warp before it adds them in order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPiece = 64;      // sorted positions a warp, pass A
constexpr int kWarpsA = 8;      // warps a block, pass A
constexpr int kBatch = 8;       // rows loaded ahead of their adds, pass A
constexpr int kWarpsB = 16;     // warps a block, pass B
constexpr int kCols = 128;      // columns a warp covers at a time: 4 a lane

__device__ __forceinline__ void store_cols(float* dst, const float (&acc)[4], int c0,
                                           int lane, int D) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int col = c0 + lane + 32 * k;
    if (col < D) dst[col] = acc[k];
  }
}

// Pass A: warp `piece` sums the runs of positions [p0, p1).
__global__ void __launch_bounds__(32 * kWarpsA)
piece_kernel(const int64_t* __restrict__ ids, const int64_t* __restrict__ perm,
             const float* __restrict__ dx, float* __restrict__ dw,
             float* __restrict__ part, long long n, long long V, int D) {
  const int lane = threadIdx.x & 31;
  const long long piece = static_cast<long long>(blockIdx.x) * kWarpsA + threadIdx.x / 32;
  const long long p0 = piece * kPiece;
  if (p0 >= n) return;
  const long long p1 = p0 + kPiece < n ? p0 + kPiece : n;
  const bool has_prev = p0 > 0, has_next = p1 < n;
  const int64_t prev = has_prev ? ids[p0 - 1] : 0;
  const int64_t next = has_next ? ids[p1] : 0;
  float* head = part + static_cast<size_t>(piece) * 2 * D;
  float* tail = head + D;

  for (int c0 = 0; c0 < D; c0 += kCols) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    int64_t cur = ids[p0];
    bool first = true;  // cur's run holds the piece's first position
    // Writes cur's sum: a run that crosses the piece's start or end goes
    // to a partial slot, any other straight to dW.
    auto flush = [&](bool last) {
      const bool crosses = (first && has_prev && cur == prev) ||
                           (last && has_next && cur == next);
      if (crosses)
        store_cols(first ? head : tail, acc, c0, lane, D);
      else if (cur >= 0 && cur < V)
        store_cols(dw + cur * D, acc, c0, lane, D);
    };
    for (long long p = p0; p < p1; p += kBatch) {
      int64_t id[kBatch];
      float x[kBatch][4];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const bool in = p + j < p1;
        id[j] = in ? ids[p + j] : 0;
        const int64_t row = in ? perm[p + j] : 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int col = c0 + lane + 32 * k;
          x[j][k] = in && col < D ? __ldg(dx + row * D + col) : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (p + j >= p1) break;  // the last piece's ragged end
        if (id[j] != cur) {  // the same on every lane: no divergence
          flush(false);
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[k] = 0.f;
          cur = id[j];
          first = false;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] += x[j][k];
      }
    }
    flush(true);
  }
}

// Pass B: block `piece` joins the run that starts in it and goes on past
// its end, if there is one.
__global__ void __launch_bounds__(32 * kWarpsB)
join_kernel(const int64_t* __restrict__ ids, const float* __restrict__ part,
            float* __restrict__ dw, long long n, long long V, int D) {
  __shared__ float red[kWarpsB][kCols];
  const long long piece = blockIdx.x;
  const long long p0 = piece * kPiece;
  const long long p1 = p0 + kPiece < n ? p0 + kPiece : n;
  if (p1 >= n) return;
  const int64_t id = ids[p1 - 1];
  if (ids[p1] != id) return;  // the piece's last run ends inside it
  long long lo = 0, hi = p1 - 1;  // the run's first position
  while (lo < hi) {
    const long long mid = (lo + hi) / 2;
    if (ids[mid] < id) lo = mid + 1; else hi = mid;
  }
  const long long start = lo;
  if (start < p0) return;  // an earlier piece joins it
  lo = p1;
  hi = n;  // one past the run's last position
  while (lo < hi) {
    const long long mid = (lo + hi) / 2;
    if (ids[mid] <= id) lo = mid + 1; else hi = mid;
  }
  const long long last_piece = (lo - 1) / kPiece;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  for (int c0 = 0; c0 < D; c0 += kCols) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (long long j = piece + warp; j <= last_piece; j += kWarpsB) {
      // The run holds piece j's first position (head) unless it starts
      // later in it (tail: only in the first piece).
      const float* src = part + (static_cast<size_t>(j) * 2 + (start <= j * kPiece ? 0 : 1)) * D;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int col = c0 + lane + 32 * k;
        if (col < D) acc[k] += src[col];
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) red[warp][lane + 32 * k] = acc[k];
    __syncthreads();
    const int c = threadIdx.x;
    if (c < kCols && c0 + c < D && id >= 0 && id < V) {
      float s = 0.f;
      for (int w = 0; w < kWarpsB; ++w) s += red[w][c];
      dw[id * D + c0 + c] = s;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Floats of scratch (`part`) that embedding_grad_launch needs for n ids of
// D columns.
long long embedding_grad_scratch(long long n, int D) {
  return (n + kPiece - 1) / kPiece * 2 * static_cast<long long>(D);
}

// Launches passes A and B on `stream`: sorted_ids [n] and perm [n] int64 (a
// stable sort of the ids and its permutation), dx [n, D] contiguous
// float32, dw [V, D] float32 zeroed by the caller, part of
// embedding_grad_scratch(n, D) floats, all on card `device`. Ids outside
// [0, V) add to no row. Returns the first failing call's cudaError_t
// (cudaErrorInvalidValue for n, V or D < 1).
int embedding_grad_launch(int device, const int64_t* sorted_ids, const int64_t* perm,
                          const float* dx, float* dw, float* part, long long n,
                          long long V, int D, cudaStream_t stream) {
  if (n < 1 || V < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long pieces = (n + kPiece - 1) / kPiece;
  if (pieces > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks_a = static_cast<unsigned>((pieces + kWarpsA - 1) / kWarpsA);
  piece_kernel<<<blocks_a, 32 * kWarpsA, 0, stream>>>(sorted_ids, perm, dx, dw, part, n, V, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  join_kernel<<<static_cast<unsigned>(pieces), 32 * kWarpsB, 0, stream>>>(sorted_ids, part, dw,
                                                                           n, V, D);
  return static_cast<int>(cudaGetLastError());
}

const char* embedding_grad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
