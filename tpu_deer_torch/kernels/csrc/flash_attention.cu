// Kernels K3a, K3b, K3c: blocked attention with an online softmax, forward
// and backward (the FlashAttention-2 recipe), in float32.
//
// Replaces the TPU kernels of tpu_deer/ops/flash_attention.py:
//   K3a  _fwd_kernel     (launched by _forward_impl)   O, lse
//   K3b  _bwd_dq_kernel  (launched by _backward_impl)  dq
//   K3c  _bwd_dkv_kernel (launched by _backward_impl)  dk, dv
//
// For every batch·head bh, with scale = 1/sqrt(D), a key mask row m = mask[bh / H]
// ([B, Tk], 1 = valid) and s = scale q·kᵀ filled with -1e30 where m = 0:
//   O   = softmax(s) v,  lse = logsumexp(s)                         (K3a)
//   δ   = rowsum(dO ∘ O)                                            (K3b)
//   p   = exp(s - lse),  ds = p ∘ (dO vᵀ - δ), 0 where m = 0
//   dq  = scale ds k                                                (K3b)
//   dk  = scale dsᵀ q,   dv = pᵀ dO                                 (K3c)
// The [Tq, Tk] matrices never reach device memory: p is recomputed from lse.
//
// A batch element whose whole key mask is 0 gets reference_attention's
// function: O = the mean of v over its Tk keys, dq = dk = 0, dv += Σ dO / Tk.
// The key loops stop at Tk, so no padded key is ever scored; in such a row
// every real key scores -1e30, gets p = 1 and l = Tk. Its lse, -1e30 +
// log(Tk), rounds to -1e30 in float32, so the backward cannot recompute p
// from it: both backward kernels read lse < -5e29 as "no valid key" and use
// p = 1/Tk there.
//
// What bounds them on an H100: operations. At the training shape (B·H = 256,
// T = 2048, D = 32, every key valid) K3a does 4·BH·T²·D = 137 GFLOP against
// ~0.3 GB of inputs and outputs, K3b 6·BH·T²·D and K3c 8·BH·T²·D: 100-500
// FLOP a byte, far above the card's ~20 FLOP a byte at its float32 rate.
// The products
// run in full float32 FMAs (not TF32) so that they agree with the plain
// float32 version, which makes the 67 TFLOP/s non-tensor-core f32 rate the
// floor. The design keeps the FMA pipes fed in the simplest way: one thread
// owns one query row (K3a, K3b) or one key row (K3c) with its vectors in
// registers, and the other side streams through shared memory in tiles of
// 64 rows, read back as 16-byte broadcast loads (one load feeds 4 FMAs).
// Masked keys are computed and discarded, as on the TPU, so the kernels'
// work does not depend on the mask; the function's does, since a masked key
// adds 0 to O, dq, dk and dv. Skipping fully masked key tiles, tensor-core
// products (wgmma, 3xTF32) and TMA staging are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 64;      // query (K3a, K3b) or key (K3c) rows a block
constexpr int kTile = 64;      // rows of the other side a shared-memory tile
constexpr int kChunk = 16;     // K3a: keys scored at a time, in registers
constexpr float kNegInf = -1e30f;          // the masked-score fill, as on TPU
constexpr float kNoValidKey = 0.5f * kNegInf;  // lse below this: all masked

// a · b over D floats; a in registers, b in shared memory (16-byte aligned).
template <int D>
__device__ __forceinline__ float dot(const float (&a)[D], const float* b) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(b + d);
    s0 = fmaf(a[d], x.x, s0);
    s1 = fmaf(a[d + 1], x.y, s1);
    s2 = fmaf(a[d + 2], x.z, s2);
    s3 = fmaf(a[d + 3], x.w, s3);
  }
  return (s0 + s1) + (s2 + s3);
}

// acc += w · b over D floats; b in shared memory (16-byte aligned).
template <int D>
__device__ __forceinline__ void axpy(float (&acc)[D], float w, const float* b) {
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(b + d);
    acc[d] = fmaf(w, x.x, acc[d]);
    acc[d + 1] = fmaf(w, x.y, acc[d + 1]);
    acc[d + 2] = fmaf(w, x.z, acc[d + 2]);
    acc[d + 3] = fmaf(w, x.w, acc[d + 3]);
  }
}

// A row of D floats from device memory into registers (zeros when !live).
template <int D>
__device__ __forceinline__ void load_row(float (&r)[D], const float* src,
                                         bool live, float mul = 1.f) {
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live) x = __ldg(reinterpret_cast<const float4*>(src + d));
    r[d] = x.x * mul;
    r[d + 1] = x.y * mul;
    r[d + 2] = x.z * mul;
    r[d + 3] = x.w * mul;
  }
}

template <int D>
__device__ __forceinline__ void store_row(float* dst, const float (&r)[D],
                                          float mul) {
#pragma unroll
  for (int d = 0; d < D; d += 4)
    *reinterpret_cast<float4*>(dst + d) =
        make_float4(r[d] * mul, r[d + 1] * mul, r[d + 2] * mul, r[d + 3] * mul);
}

// Rows [r0, r0 + n) of a [*, D] array into a [kTile, D] shared tile; rows
// past n are zeros. Called by all kRows threads of the block.
template <int D>
__device__ __forceinline__ void stage(float* tile, const float* src, int r0,
                                      int n) {
  constexpr int kVecs = kTile * D / 4;
  for (int i = threadIdx.x; i < kVecs; i += kRows) {
    const int r = i / (D / 4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n)
      x = __ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(r0) * D) + i);
    reinterpret_cast<float4*>(tile)[i] = x;
  }
}

// K3a: one block per (bh, 64 query rows), one thread per query row.
template <int D>
__global__ void __launch_bounds__(kRows)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ mask,
           float* __restrict__ o, float* __restrict__ lse, int H, int Tq,
           int Tk, float scale) {
  __shared__ __align__(16) float ks[kTile * D];
  __shared__ __align__(16) float vs[kTile * D];
  __shared__ float ms[kTile];
  const int bh = blockIdx.x;
  const int row = blockIdx.y * kRows + threadIdx.x;
  const bool live = row < Tq;
  const size_t qoff = (static_cast<size_t>(bh) * Tq + row) * D;
  const float* kb = k + static_cast<size_t>(bh) * Tk * D;
  const float* vb = v + static_cast<size_t>(bh) * Tk * D;
  const float* mrow = mask + static_cast<size_t>(bh / H) * Tk;

  float qr[D], acc[D];
  load_row<D>(qr, q + qoff, live, scale);
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = kNegInf, l = 0.f;

  for (int t0 = 0; t0 < Tk; t0 += kTile) {
    const int n = min(kTile, Tk - t0);
    __syncthreads();  // the previous tile is consumed
    stage<D>(ks, kb, t0, n);
    stage<D>(vs, vb, t0, n);
    for (int j = threadIdx.x; j < kTile; j += kRows)
      ms[j] = j < n ? mrow[t0 + j] : 0.f;
    __syncthreads();
    for (int c = 0; c < n; c += kChunk) {
      float s[kChunk];
      float cmax = kNegInf;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int jj = c + j;
        const float x = dot<D>(qr, ks + jj * D);
        // Keys past Tk do not exist (p = 0); masked keys score -1e30.
        s[j] = jj < n ? (ms[jj] > 0.f ? x : kNegInf) : -INFINITY;
        cmax = fmaxf(cmax, s[j]);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = expf(s[j] - m_new);
        l += p;
        axpy<D>(acc, p, vs + (c + j) * D);
      }
      m = m_new;
    }
  }
  if (live) {
    const float l_safe = fmaxf(l, 1e-30f);
    store_row<D>(o + qoff, acc, 1.f / l_safe);
    lse[static_cast<size_t>(bh) * Tq + row] = m + logf(l_safe);
  }
}

// K3b: one block per (bh, 64 query rows), one thread per query row; writes
// δ = rowsum(dO ∘ O) for K3c beside dq.
template <int D>
__global__ void __launch_bounds__(kRows)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ mask,
              const float* __restrict__ o, const float* __restrict__ dout,
              const float* __restrict__ lse, float* __restrict__ delta,
              float* __restrict__ dq, int H, int Tq, int Tk, float scale) {
  __shared__ __align__(16) float ks[kTile * D];
  __shared__ __align__(16) float vs[kTile * D];
  __shared__ float ms[kTile];
  const int bh = blockIdx.x;
  const int row = blockIdx.y * kRows + threadIdx.x;
  const bool live = row < Tq;
  const size_t qoff = (static_cast<size_t>(bh) * Tq + row) * D;
  const size_t soff = static_cast<size_t>(bh) * Tq + row;
  const float* kb = k + static_cast<size_t>(bh) * Tk * D;
  const float* vb = v + static_cast<size_t>(bh) * Tk * D;
  const float* mrow = mask + static_cast<size_t>(bh / H) * Tk;

  float qr[D], dor[D], acc[D];
  load_row<D>(qr, q + qoff, live);
  load_row<D>(dor, dout + qoff, live);
  float dl = 0.f;
  {
    float orow[D];
    load_row<D>(orow, o + qoff, live);
#pragma unroll
    for (int d = 0; d < D; ++d) dl = fmaf(dor[d], orow[d], dl);
  }
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  const float lr = live ? lse[soff] : 0.f;
  const bool none = lr < kNoValidKey;
  const float p_none = 1.f / static_cast<float>(Tk);

  for (int t0 = 0; t0 < Tk; t0 += kTile) {
    const int n = min(kTile, Tk - t0);
    __syncthreads();
    stage<D>(ks, kb, t0, n);
    stage<D>(vs, vb, t0, n);
    for (int j = threadIdx.x; j < kTile; j += kRows)
      ms[j] = j < n ? mrow[t0 + j] : 0.f;
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float* kj = ks + j * D;
      const bool valid = ms[j] > 0.f;
      const float x = scale * dot<D>(qr, kj);  // computed for masked keys too
      const float p = none ? p_none : expf((valid ? x : kNegInf) - lr);
      const float dp = dot<D>(dor, vs + j * D);
      const float ds = valid ? p * (dp - dl) : 0.f;
      axpy<D>(acc, ds, kj);
    }
  }
  if (live) {
    store_row<D>(dq + qoff, acc, scale);
    delta[soff] = dl;
  }
}

// K3c: one block per (bh, 64 key rows), one thread per key row.
template <int D>
__global__ void __launch_bounds__(kRows)
bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ mask,
               const float* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dk,
               float* __restrict__ dv, int H, int Tq, int Tk, float scale) {
  __shared__ __align__(16) float qs[kTile * D];
  __shared__ __align__(16) float dos[kTile * D];
  __shared__ float ls[kTile];
  __shared__ float dls[kTile];
  const int bh = blockIdx.x;
  const int key = blockIdx.y * kRows + threadIdx.x;
  const bool live = key < Tk;
  const size_t koff = (static_cast<size_t>(bh) * Tk + key) * D;
  const float* qb = q + static_cast<size_t>(bh) * Tq * D;
  const float* dob = dout + static_cast<size_t>(bh) * Tq * D;
  const float* lb = lse + static_cast<size_t>(bh) * Tq;
  const float* db = delta + static_cast<size_t>(bh) * Tq;
  const bool valid =
      live && mask[static_cast<size_t>(bh / H) * Tk + key] > 0.f;

  float kr[D], vr[D], dka[D], dva[D];
  load_row<D>(kr, k + koff, live);
  load_row<D>(vr, v + koff, live);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    dka[d] = 0.f;
    dva[d] = 0.f;
  }
  const float p_none = 1.f / static_cast<float>(Tk);

  for (int t0 = 0; t0 < Tq; t0 += kTile) {
    const int n = min(kTile, Tq - t0);
    __syncthreads();
    stage<D>(qs, qb, t0, n);
    stage<D>(dos, dob, t0, n);
    for (int i = threadIdx.x; i < kTile; i += kRows) {
      ls[i] = i < n ? lb[t0 + i] : 0.f;
      dls[i] = i < n ? db[t0 + i] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float* qi = qs + i * D;
      const float* doi = dos + i * D;
      const float li = ls[i];
      const float x = scale * dot<D>(kr, qi);  // computed for masked keys too
      const float p = li < kNoValidKey ? p_none : expf((valid ? x : kNegInf) - li);
      axpy<D>(dva, p, doi);
      const float dp = dot<D>(vr, doi);
      const float ds = valid ? p * (dp - dls[i]) : 0.f;
      axpy<D>(dka, ds, qi);
    }
  }
  if (live) {
    store_row<D>(dk + koff, dka, scale);
    store_row<D>(dv + koff, dva, 1.f);
  }
}

bool bad_shape(int B, int H, int Tq, int Tk) {
  return B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 ||
         static_cast<long long>(B) * H > 2147483647LL ||
         (static_cast<long long>(Tq) + kRows - 1) / kRows > 65535 ||
         (static_cast<long long>(Tk) + kRows - 1) / kRows > 65535;
}

dim3 grid_for(int B, int H, int T) {
  return dim3(static_cast<unsigned>(B * H), static_cast<unsigned>((T + kRows - 1) / kRows));
}

}  // namespace

extern "C" {

// Each entry point launches one kernel on `stream` and returns its
// cudaError_t (cudaErrorInvalidValue for a head size other than 32 or 64 or
// an empty or too large shape). Arrays are contiguous float32 on card
// `device`, 16-byte aligned: q, dout, o, dq [B, H, Tq, D]; k, v, dk, dv
// [B, H, Tk, D]; mask [B, Tk] (> 0 = valid); lse, delta [B, H, Tq].

// K3a: (q, k, v, mask) → (o, lse).
int flash_fwd_launch(int device, const float* q, const float* k,
                     const float* v, const float* mask, float* o, float* lse,
                     int B, int H, int Tq, int Tk, int D, cudaStream_t stream) {
  if (bad_shape(B, H, Tq, Tk) || (D != 32 && D != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  const dim3 grid = grid_for(B, H, Tq);
  if (D == 32)
    fwd_kernel<32><<<grid, kRows, 0, stream>>>(q, k, v, mask, o, lse, H, Tq, Tk, scale);
  else
    fwd_kernel<64><<<grid, kRows, 0, stream>>>(q, k, v, mask, o, lse, H, Tq, Tk, scale);
  return static_cast<int>(cudaGetLastError());
}

// K3b: (q, k, v, mask, o, dout, lse) → (delta, dq).
int flash_bwd_dq_launch(int device, const float* q, const float* k,
                        const float* v, const float* mask, const float* o,
                        const float* dout, const float* lse, float* delta,
                        float* dq, int B, int H, int Tq, int Tk, int D,
                        cudaStream_t stream) {
  if (bad_shape(B, H, Tq, Tk) || (D != 32 && D != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  const dim3 grid = grid_for(B, H, Tq);
  if (D == 32)
    bwd_dq_kernel<32><<<grid, kRows, 0, stream>>>(q, k, v, mask, o, dout, lse,
                                                  delta, dq, H, Tq, Tk, scale);
  else
    bwd_dq_kernel<64><<<grid, kRows, 0, stream>>>(q, k, v, mask, o, dout, lse,
                                                  delta, dq, H, Tq, Tk, scale);
  return static_cast<int>(cudaGetLastError());
}

// K3c: (q, k, v, mask, dout, lse, delta) → (dk, dv).
int flash_bwd_dkv_launch(int device, const float* q, const float* k,
                         const float* v, const float* mask, const float* dout,
                         const float* lse, const float* delta, float* dk,
                         float* dv, int B, int H, int Tq, int Tk, int D,
                         cudaStream_t stream) {
  if (bad_shape(B, H, Tq, Tk) || (D != 32 && D != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  const dim3 grid = grid_for(B, H, Tk);
  if (D == 32)
    bwd_dkv_kernel<32><<<grid, kRows, 0, stream>>>(q, k, v, mask, dout, lse,
                                                   delta, dk, dv, H, Tq, Tk, scale);
  else
    bwd_dkv_kernel<64><<<grid, kRows, 0, stream>>>(q, k, v, mask, dout, lse,
                                                   delta, dk, dv, H, Tq, Tk, scale);
  return static_cast<int>(cudaGetLastError());
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
