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
// What bounds it on an H100: bytes. The function reads 4 B and writes 1 B
// an element (the bits variant reads 4 B more); Philox's ~100 integer
// operations per 4 elements are far below the card's integer rate. Two
// launches on the caller's stream: K4a reduces max |w| (grid-stride float4
// loads, a warp reduction with __shfl_xor_sync, then one in shared memory,
// then one atomicMax a block into a 4-byte word zeroed by cudaMemsetAsync
// on the same stream); K4b quantizes, one thread per 4 consecutive elements
// with one Philox call, float4 loads and char4 stores, and block 0 writes
// the scale. K4b reads w a second time, so the kernel moves 9 B an element
// where 5 are unavoidable; a single pass would need the maximum before the
// first element is rounded (a grid-wide barrier), which is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

__device__ __forceinline__ unsigned abs_bits(float x) {
  return __float_as_uint(fabsf(x));
}

// K4a: *amax_bits = max over e of the bits of |w[e]| (the caller zeroes it).
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
amax_kernel(const float* __restrict__ w, long long n,
            unsigned* __restrict__ amax_bits) {
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  unsigned m = 0;
  long long start = 0;
  if (VEC) {
    const long long n4 = n / 4;
    const float4* w4 = reinterpret_cast<const float4*>(w);
    for (long long i = tid; i < n4; i += stride) {
      const float4 v = w4[i];
      m = max(m, max(max(abs_bits(v.x), abs_bits(v.y)),
                     max(abs_bits(v.z), abs_bits(v.w))));
    }
    start = 4 * n4;
  }
  for (long long i = start + tid; i < n; i += stride) m = max(m, abs_bits(w[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ unsigned partial[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) partial[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? partial[lane] : 0u;
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1)
      m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) atomicMax(amax_bits, m);
  }
}

__device__ __forceinline__ signed char round_one(float x, unsigned bits, float scale) {
  const float u = static_cast<float>(bits >> 8) * 5.9604644775390625e-08f;  // 2^-24
  const float q = floorf(__fadd_rn(__fdiv_rn(x, scale), u));
  return static_cast<signed char>(fminf(fmaxf(q, -127.0f), 127.0f));
}

// K4b: one thread per group of 4 consecutive elements. PHILOX: the group's
// four words from one Philox call; otherwise from `bits`. VEC: w 16-byte and
// q 4-byte aligned, so full groups load a float4 and store a char4.
template <bool PHILOX, bool VEC>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ w, const int* __restrict__ bits,
                signed char* __restrict__ q, float* __restrict__ scale_out,
                const unsigned* __restrict__ amax_bits, long long n,
                uint2 key) {
  const float amax = __uint_as_float(*amax_bits);
  const float scale = isnan(amax) ? amax : __fmul_rn(fmaxf(amax, 1e-8f), 1.0f / 127.0f);
  if (blockIdx.x == 0 && threadIdx.x == 0) scale_out[0] = scale;
  const long long groups = (n + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       g < groups; g += stride) {
    const long long base = 4 * g;
    const bool full = base + 3 < n;
    unsigned r[4];
    if (PHILOX) {
      const uint4 c = philox4x32_10(
          make_uint4(static_cast<unsigned>(g), static_cast<unsigned>(g >> 32), 0u, 0u),
          key);
      r[0] = c.x; r[1] = c.y; r[2] = c.z; r[3] = c.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        r[j] = base + j < n ? static_cast<unsigned>(bits[base + j]) : 0u;
    }
    if (VEC && full) {
      const float4 v = reinterpret_cast<const float4*>(w)[g];
      reinterpret_cast<char4*>(q)[g] = make_char4(
          round_one(v.x, r[0], scale), round_one(v.y, r[1], scale),
          round_one(v.z, r[2], scale), round_one(v.w, r[3], scale));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (base + j < n) q[base + j] = round_one(w[base + j], r[j], scale);
    }
  }
}

template <bool PHILOX, bool VEC>
int launch(const float* w, const int* bits, signed char* q, float* scale,
           unsigned* amax, long long n, uint2 key, cudaStream_t stream) {
  const long long sms = 132;
  long long blocks_a = (n + 4LL * kThreads - 1) / (4LL * kThreads);
  blocks_a = blocks_a < 4 * sms ? blocks_a : 4 * sms;
  amax_kernel<VEC><<<static_cast<unsigned>(blocks_a), kThreads, 0, stream>>>(w, n, amax);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long groups = (n + 3) / 4;
  long long blocks_b = (groups + kThreads - 1) / kThreads;
  blocks_b = blocks_b < 16 * sms ? blocks_b : 16 * sms;
  quantize_kernel<PHILOX, VEC><<<static_cast<unsigned>(blocks_b), kThreads, 0, stream>>>(
      w, bits, q, scale, amax, n, key);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches K4a then K4b on `stream`. w [n] contiguous float32, q [n] int8,
// scale [1] float32 and amax [1] (4-byte scratch) on card `device`. bits:
// n int32 words, or NULL to draw them from Philox keyed by `seed`. Returns
// the first failing call's cudaError_t (cudaErrorInvalidValue for n < 1).
int quantize_int8_launch(int device, const float* w, const int* bits,
                         signed char* q, float* scale, unsigned* amax,
                         long long n, unsigned long long seed,
                         cudaStream_t stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(amax, 0, sizeof(unsigned), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint2 key = make_uint2(static_cast<unsigned>(seed),
                               static_cast<unsigned>(seed >> 32));
  const bool vec = reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 4 == 0;
  if (bits == nullptr)
    return vec ? launch<true, true>(w, bits, q, scale, amax, n, key, stream)
               : launch<true, false>(w, bits, q, scale, amax, n, key, stream);
  return vec ? launch<false, true>(w, bits, q, scale, amax, n, key, stream)
             : launch<false, false>(w, bits, q, scale, amax, n, key, stream);
}

const char* quantize_int8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
