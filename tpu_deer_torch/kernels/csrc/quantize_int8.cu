// Kernel K4: per-tensor int8 quantization with stochastic rounding.
//
// Replaces the TPU kernel tpu_deer/ops/quantization.py:quantize_int8_stochastic
// (its Pallas body quantize_body). For w of any shape, n elements:
//
//   scale = max(max |w|, 1e-8) * float32(1/127)             [1, 1] float32
//   u[e]  = (bits[e] >> 8) * 2^-24                           uniform [0, 1)
//   q[e]  = clip(floor(w[e] / scale + u[e]), -127, 127)      int8, w's shape
//
// The 32-bit words come either from Philox4x32-10, written out below and
// keyed by the caller's 64-bit seed (the counterpart of the TPU's hardware
// PRNG), or from the caller as an int32 array (the counterpart of the
// reference's non-TPU body, which takes jax.random.bits): that variant holds
// the port exactly against the reference, whose bits no other package can
// draw. Element e takes word e % 4 of the Philox call at counter
// (lo32(e / 4), hi32(e / 4), 0, 0), key (lo32(seed), hi32(seed)).
//
// Arithmetic, for bit parity with the reference as XLA compiles it: the
// scale is max(amax, 1e-8) times float32(1/127) (XLA turns the division by
// the constant 127 into that product), while w / scale is an IEEE division
// (__fdiv_rn; build.py does not pass --use_fast_math), never a product with
// a reciprocal, and the add is rounded on its own (__fadd_rn, no FMA). NaN
// propagates through the maximum as jnp.max does: the maximum is taken over
// the bits of |w| as unsigned integers, and a NaN's exceed +inf's.
//
// What bounds it on an H100: bytes, in principle. The function reads 4 B
// and writes 1 B an element (the bits variant reads 4 B more). But the
// maximum must be known before the first element is rounded, and w is
// larger than the 50 MB L2 at the sizes that take time, so a kernel that
// reads w once for the maximum and again to round moves 9 B an element from
// HBM (the two kernels and the memset this one replaces did). And the
// rounding itself is not free: Philox's 20 32x32->64-bit integer multiplies
// per 4 elements run at a fraction of the FP32 rate, and with the IEEE
// division they make the rounding as long as the read of w (PERF.md, K4).
//
// The design: one persistent launch that reads w from HBM once.
// cudaLaunchCooperativeKernel keeps all its blocks resident, one a SM at the
// card's own count (quantize_int8_config asks the card), fewer for small n.
// Block b takes a contiguous share of w (a multiple of 16 elements, so every
// share starts on a 64-byte boundary; the host computes the split,
// kernels/quantize_int8.py:split).
//   Pass 1: the block reads its share and takes its max |w| (as bits). The
//     first `staged` elements (up to the 227 KB of dynamic shared memory a
//     block may have) go into shared memory, read evict-first; the rest of
//     the share is read last with an L2 evict_last policy, so that it is
//     still in L2 for pass 2. On an H100 that hint measured neutral: pass 2
//     at [4096, 4096] took the same time within 0.5 us with evict_normal
//     (tools/k4_passes.py, PERF.md), likely as the rest, read last, is the
//     newest data in L2 either way; it stays as the design's guard for it.
//     The block writes its maximum to its own slot: no atomic, no memset.
//   A grid-wide barrier (cooperative_groups::this_grid().sync()).
//   Pass 2: every block takes the maximum of the slots (exact in any order)
//     and block 0 writes the scale. The block rounds its staged elements
//     from shared memory, one thread 16 consecutive elements (four Philox
//     calls, one 16-byte store of q); the stage holds each group's four
//     float4s rotated by (group / 2) % 4, so that those reads meet no bank
//     conflict. Then the rest, from L2: lane l of a warp rounds float4 b + l
//     (coalesced 16-byte loads), and the first lane of each four stores the
//     four lanes' 16 bytes. q is stored evict-first.
// The rounding cannot start before the last block has read its share, so
// the kernel takes about the read of w plus the rounding: it saves the
// second read of w and two launches, not the rounding's time.
// On chip: 132 blocks x 232,320 B = 30.7 MB of w is staged on an H100, so
// every Dense kernel of the flagship (<= 1.5 MB) stays on chip whole; at
// [4096, 4096] (64 MB) ~34 MB are read a second time, from L2. Registers
// hold no share. A tensor larger than shared memory plus L2 (about 75 MB)
// still gives the right answer, but part of its rest comes from HBM again.
// A w, q or bits that is not 16-byte aligned takes the same passes with
// 4-byte loads and 1-byte stores.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 16;  // elements a 16-byte store of q holds
constexpr int kLoads = 4;   // 16-byte loads a thread keeps in flight

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round > 0) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const unsigned lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ uint4 philox_at(long long counter, uint2 key) {
  return philox4x32_10(make_uint4(static_cast<unsigned>(counter),
                                  static_cast<unsigned>(counter >> 32), 0u, 0u),
                       key);
}

__device__ __forceinline__ unsigned abs_bits(float x) {
  return __float_as_uint(fabsf(x));
}

__device__ __forceinline__ unsigned abs_bits4(float4 v) {
  return max(max(abs_bits(v.x), abs_bits(v.y)), max(abs_bits(v.z), abs_bits(v.w)));
}

// Slot of float4 i in a stage: the four float4s of group i / 4, rotated by
// (group / 2) % 4.
__device__ __forceinline__ int slot(int i) {
  const int g = i >> 2;
  return 4 * g + (((i & 3) + (g >> 1)) & 3);
}

__device__ __forceinline__ int slot_elem(int e) { return 4 * slot(e >> 2) + (e & 3); }

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// Loads that leave their lines in L2 with evict_last priority.
__device__ __forceinline__ float4 ld_keep4(const float4* p, uint64_t policy) {
  float4 v;
  asm volatile("ld.global.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ float ld_keep(const float* p, uint64_t policy) {
  float v;
  asm volatile("ld.global.L2::cache_hint.f32 %0, [%1], %2;\n"
               : "=f"(v) : "l"(p), "l"(policy));
  return v;
}

// The maximum of m over the block, returned to every thread.
__device__ __forceinline__ unsigned block_max(unsigned m, unsigned* partial) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) partial[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? partial[lane] : 0u;
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1)
      m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) partial[0] = m;
  }
  __syncthreads();
  return partial[0];
}

// One element: the IEEE quotient plus u (exact: 24 bits times 2^-24),
// rounded on its own, clipped then floored (equal to floor then clip for
// integer bounds; a NaN gives -127, as fmaxf(NaN, -127) does).
__device__ __forceinline__ int round_one(float x, unsigned bits, float scale) {
  const float u = static_cast<float>(bits >> 8) * 5.9604644775390625e-08f;  // 2^-24
  const float t = __fadd_rn(__fdiv_rn(x, scale), u);
  return __float2int_rd(fminf(fmaxf(t, -127.0f), 127.0f));
}

// The four elements of v with the words of r, as 4 bytes.
__device__ __forceinline__ unsigned round4(float4 v, uint4 r, float scale) {
  return __byte_perm(__byte_perm(round_one(v.x, r.x, scale), round_one(v.y, r.y, scale), 0x0040),
                     __byte_perm(round_one(v.z, r.z, scale), round_one(v.w, r.w, scale), 0x0040),
                     0x5410);
}

// Elements [e0, e0 + 16) of w, given as four float4s: one 16-byte store.
template <bool PHILOX>
__device__ __forceinline__ void round_group(const float4 (&v)[4], long long e0,
                                            const int* __restrict__ bits,
                                            signed char* __restrict__ q,
                                            uint2 key, float scale) {
  unsigned out[4];
  if (PHILOX) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[j] = round4(v[j], philox_at((e0 >> 2) + j, key), scale);
  } else {
    uint4 r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) r[j] = __ldcs(reinterpret_cast<const uint4*>(bits + e0) + j);
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = round4(v[j], r[j], scale);
  }
  __stcs(reinterpret_cast<int4*>(q + e0),
         make_int4(static_cast<int>(out[0]), static_cast<int>(out[1]),
                   static_cast<int>(out[2]), static_cast<int>(out[3])));
}

// Elements [lo, len) of the share at `start` (lo a multiple of 4), one
// Philox call per 4, 1-byte loads and stores: the ragged end, and every
// element of a misaligned tensor. Element l < st comes from the stage.
template <bool PHILOX>
__device__ __forceinline__ void round_quads(const float* __restrict__ w,
                                            const int* __restrict__ bits,
                                            signed char* __restrict__ q,
                                            const float* stage, long long start,
                                            long long lo, long long len, int st,
                                            uint2 key, float scale) {
  for (long long k = lo / 4 + threadIdx.x; 4 * k < len; k += kThreads) {
    const long long e = start + 4 * k;
    unsigned r[4] = {0u, 0u, 0u, 0u};
    if (PHILOX) {
      const uint4 c = philox_at(e >> 2, key);
      r[0] = c.x; r[1] = c.y; r[2] = c.z; r[3] = c.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long l = 4 * k + j;
      if (l < len) {
        const unsigned b = PHILOX ? r[j] : static_cast<unsigned>(bits[e + j]);
        const float x = l < st ? stage[slot_elem(static_cast<int>(l))] : __ldcs(w + e + j);
        q[e + j] = static_cast<signed char>(round_one(x, b, scale));
      }
    }
  }
}

// The rest of a share from global memory (L2): float4s [0, whole4) of
// wr, whose first element is element e0 of w (a multiple of 16). Lane l of a
// warp rounds float4 b + l (coalesced 16-byte loads, kLoads in flight), and
// the first lane of each four stores the four lanes' 16 bytes.
template <bool PHILOX>
__device__ __forceinline__ void round_rest(const float* __restrict__ wr,
                                           const int* __restrict__ bits,
                                           signed char* __restrict__ q, long long e0,
                                           long long whole4, uint2 key,
                                           float scale) {
  const int lane = threadIdx.x % 32;
  const float4* const r4 = reinterpret_cast<const float4*>(wr);
  for (long long b = threadIdx.x - lane; b < whole4; b += kLoads * kThreads) {  // warp-uniform
    float4 v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const long long i = b + u * kThreads + lane;
      if (i < whole4) v[u] = __ldcs(r4 + i);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const long long i = b + u * kThreads + lane;
      unsigned word = 0;
      if (i < whole4) {
        const uint4 r = PHILOX ? philox_at((e0 >> 2) + i, key)
                               : __ldcs(reinterpret_cast<const uint4*>(bits + e0) + i);
        word = round4(v[u], r, scale);
      }
      const unsigned w1 = __shfl_down_sync(0xffffffffu, word, 1);
      const unsigned w2 = __shfl_down_sync(0xffffffffu, word, 2);
      const unsigned w3 = __shfl_down_sync(0xffffffffu, word, 3);
      if (i < whole4 && lane % 4 == 0)
        __stcs(reinterpret_cast<int4*>(q + e0) + i / 4,
               make_int4(static_cast<int>(word), static_cast<int>(w1),
                         static_cast<int>(w2), static_cast<int>(w3)));
    }
  }
}

// K4. Block b: elements [b * share, min(n, (b + 1) * share)), the first
// `staged` of them in shared memory. VEC: w, q and bits 16-byte aligned.
template <bool PHILOX, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
quantize_one_pass(const float* __restrict__ w, const int* __restrict__ bits,
                  signed char* __restrict__ q, float* __restrict__ scale_out,
                  unsigned* __restrict__ slots, long long n, long long share,
                  int staged, uint2 key) {
  extern __shared__ float4 stage[];
  float* const stage_f = reinterpret_cast<float*>(stage);
  __shared__ unsigned partial[kWarps];
  const int tid = threadIdx.x;
  const long long start = static_cast<long long>(blockIdx.x) * share;
  const long long len = min(share, n - start);
  const int st = static_cast<int>(min(static_cast<long long>(staged), len));
  const long long rest = len - st;  // > 0 only when st == staged, a multiple of 16
  const float* const wb = w + start;
  const float* const wr = wb + st;
  const uint64_t keep = evict_last_policy();

  // Pass 1: the share's maximum; the staged part into shared memory, then
  // the rest read (each thread keeps up to 2 kLoads 16-byte loads in flight).
  unsigned m = 0;
  if (VEC) {
    // Float4 i < st / 4 of the share goes to the stage, the rest is only
    // read; the next kLoads loads are issued before the current ones are used.
    const float4* w4 = reinterpret_cast<const float4*>(wb);
    const int st4 = st / 4;
    const long long len4 = len / 4;
    const auto load = [&](long long i) {
      return i < st4 ? __ldcs(w4 + i) : ld_keep4(w4 + i, keep);
    };
    float4 cur[kLoads], next[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      if (tid + u * kThreads < len4) cur[u] = load(tid + u * kThreads);
    for (long long i = tid; i < len4; i += kLoads * kThreads) {
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const long long j = i + (kLoads + u) * kThreads;
        if (j < len4) next[u] = load(j);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const long long j = i + u * kThreads;
        if (j < len4) {
          m = max(m, abs_bits4(cur[u]));
          if (j < st4) stage[slot(static_cast<int>(j))] = cur[u];
        }
        cur[u] = next[u];
      }
    }
    for (long long e = 4 * len4 + tid; e < len; e += kThreads) {  // the ragged end
      const float x = e < st ? wb[e] : ld_keep(wb + e, keep);
      m = max(m, abs_bits(x));
      if (e < st) stage_f[slot_elem(static_cast<int>(e))] = x;
    }
  } else {
    for (int e = tid; e < st; e += kThreads) {
      const float x = wb[e];
      m = max(m, abs_bits(x));
      stage_f[slot_elem(e)] = x;
    }
    for (long long e = tid; e < rest; e += kThreads)
      m = max(m, abs_bits(ld_keep(wr + e, keep)));
  }
  m = block_max(m, partial);
  if (tid == 0) slots[blockIdx.x] = m;

  cg::this_grid().sync();

  // Pass 2: the maximum of every block's slot, then the rounding.
  unsigned all = 0;
  for (int i = tid; i < static_cast<int>(gridDim.x); i += kThreads)
    all = max(all, __ldcg(slots + i));
  const float amax = __uint_as_float(block_max(all, partial));
  const float scale = isnan(amax) ? amax : __fmul_rn(fmaxf(amax, 1e-8f), 1.0f / 127.0f);
  if (blockIdx.x == 0 && tid == 0) scale_out[0] = scale;

  if (!VEC) {
    round_quads<PHILOX>(w, bits, q, stage_f, start, 0, len, st, key, scale);
    return;
  }
  // The staged groups, one a thread: its four float4s from the stage.
  const int staged_groups = st / kGroup;
  for (int g = tid; g < staged_groups; g += kThreads) {
    float4 v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = stage[4 * g + ((j + (g >> 1)) & 3)];
    round_group<PHILOX>(v, start + static_cast<long long>(kGroup) * g, bits, q, key, scale);
  }
  // Then the rest's whole groups, from L2.
  const long long whole4 = rest / kGroup * 4;  // float4s in the rest's whole groups
  round_rest<PHILOX>(wr, bits, q, start + st, whole4, key, scale);
  // The ragged end of w, in the last share: past the whole groups of the
  // rest, or of the stage when there is no rest.
  const long long done = rest > 0 ? st + 4 * whole4 : kGroup * staged_groups;
  round_quads<PHILOX>(w, bits, q, stage_f, start, done, len, st, key, scale);
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

// Sets the instance's dynamic shared-memory limit to `stage_bytes` and
// lowers *per_sm to the blocks of it a SM holds at once.
template <bool PHILOX, bool VEC>
cudaError_t configure(int stage_bytes, int* per_sm) {
  const auto kernel = quantize_one_pass<PHILOX, VEC>;
  int blocks = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, stage_bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads,
                                                        stage_bytes);
  if (blocks < *per_sm) *per_sm = blocks;
  return err;
}

template <bool PHILOX, bool VEC>
cudaError_t launch(const float* w, const int* bits, signed char* q, float* scale,
                   unsigned* slots, long long n, long long share, int staged,
                   int grid, uint2 key, cudaStream_t stream) {
  void* args[] = {&w, &bits, &q, &scale, &slots, &n, &share, &staged, &key};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(quantize_one_pass<PHILOX, VEC>), dim3(grid),
      dim3(kThreads), args, static_cast<size_t>(staged) * sizeof(float), stream);
}

}  // namespace

extern "C" {

// Sets K4's shared-memory limit on `device` and reports, launching nothing:
// config[0] = the blocks the card holds at once (SMs x blocks a SM, the most
// a cooperative launch may take), config[1] = the shared-memory bytes a block
// may stage (a multiple of 64). Returns the cudaError_t
// (cudaErrorNotSupported on a card without cooperative launch).
int quantize_int8_config(int device, int* config) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  int optin = 0, sms = 0, coop = 0;
  cudaError_t err;
  if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                    device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess ||
      (err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device)) !=
          cudaSuccess)
    return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, quantize_one_pass<true, true>)) != cudaSuccess)
    return static_cast<int>(err);
  const int unit = kGroup * static_cast<int>(sizeof(float));
  const int stage_bytes = (optin - static_cast<int>(attr.sharedSizeBytes)) / unit * unit;
  int per_sm = INT_MAX;
  if ((err = configure<true, true>(stage_bytes, &per_sm)) != cudaSuccess ||
      (err = configure<true, false>(stage_bytes, &per_sm)) != cudaSuccess ||
      (err = configure<false, true>(stage_bytes, &per_sm)) != cudaSuccess ||
      (err = configure<false, false>(stage_bytes, &per_sm)) != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  config[0] = per_sm * sms;
  config[1] = stage_bytes;
  return 0;
}

// Launches K4 once on `stream`: w [n] contiguous float32, q [n] int8,
// scale [1] float32 and slots [grid] (4-byte scratch) on card `device`.
// bits: n int32 words, or NULL to draw them from Philox keyed by `seed`.
// (grid, share, staged) is kernels/quantize_int8.py:split of n for the card's
// quantize_int8_config, whose query must come first. Returns the launch's
// cudaError_t: cudaErrorInvalidValue for a split that does not cover n
// exactly, and cudaErrorCooperativeLaunchTooLarge for a grid that the card
// cannot hold at once.
int quantize_int8_launch(int device, const float* w, const int* bits,
                         signed char* q, float* scale, unsigned* slots,
                         long long n, long long share, int staged, int grid,
                         unsigned long long seed, cudaStream_t stream) {
  if (n < 1 || grid < 1 || share < kGroup || share % kGroup || staged < kGroup ||
      staged % kGroup || staged > share || (grid - 1LL) * share >= n ||
      grid * share < n)
    return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  const uint2 key = make_uint2(static_cast<unsigned>(seed),
                               static_cast<unsigned>(seed >> 32));
  const bool vec = reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(bits) % 16 == 0;
  cudaError_t err;
  if (bits == nullptr)
    err = vec ? launch<true, true>(w, bits, q, scale, slots, n, share, staged, grid, key, stream)
              : launch<true, false>(w, bits, q, scale, slots, n, share, staged, grid, key, stream);
  else
    err = vec ? launch<false, true>(w, bits, q, scale, slots, n, share, staged, grid, key, stream)
              : launch<false, false>(w, bits, q, scale, slots, n, share, staged, grid, key, stream);
  if (err != cudaSuccess) cudaGetLastError();  // returned here: not left for the next check
  return static_cast<int>(err);
}

const char* quantize_int8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
