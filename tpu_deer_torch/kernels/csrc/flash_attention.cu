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
// K3a finds no live key tile in such an element's mask row: it writes
// O = Σ v / Tk, summed in a fixed order, and lse = -1e30 + log(Tk), which
// rounds to -1e30 in float32. The backward cannot recompute p from that lse:
// lse < -5e29 marks "no valid key". K3b skips every key tile of such an
// element (dq = 0); K3c detects it from lse and writes dv = Σ dO / Tk,
// dk = 0.
//
// What bounds them on an H100: operations. At the training shape (B·H = 256,
// T = 2048, D = 32) K3a does 4·BH·T·D FLOP for each valid key, K3b 6 and K3c
// 8, against ~0.3 GB of inputs and outputs: 100-500 FLOP a byte.
//
// All three run every product on the tensor cores, as wgmma.mma_async
// with tf32 operands, in 3xTF32: each operand x is split into hi, x with its
// 13 low mantissa bits cleared (the tensor core reads a float32 operand as
// tf32 by ignoring those bits, so a raw float32 tile serves as hi), and
// lo = x - hi; a product is lo·hi + hi·lo + hi·hi in float32, which agrees
// with the plain float32 version to about float32's precision (one tf32
// product alone misses K3_TOL by an order of magnitude). That is 3
// tensor-core products for each float32 one: their floor is 3 × the
// operations over 495 TFLOP/s, 2.4× below the float32 FMA floor.
//   - One warpgroup (128 threads) a block owns 64 rows of its side (query
//     rows in K3a and K3b, key rows in K3c) and streams the other side in
//     tiles, double-buffered through cp.async: the next tile's copy runs
//     while the current tile's products do. The products that need only the
//     raw tiles are issued first, and the lo and transposed tiles are split
//     out while they run.
//   - Key tiles with no valid key are skipped, for any mask (not only a
//     prefix): K3a and K3b read which of the next 32 key tiles are live
//     with one block-wide OR over their mask row and loop over those; a K3c
//     block whose 64 keys are all masked writes dk = dv = 0 and returns (or
//     takes the all-masked element's values above). A masked key inside a
//     live tile scores -1e30, which gives p = 0 beside the tile's valid key,
//     so a skipped tile changes only the order of the sums.
//   - K3a's online softmax runs on the S accumulator: a thread holds two
//     query rows of it, so the row maximum and the row sum take a shuffle
//     across the 4 lanes of a row group. A key past Tk (the ragged last
//     tile) gets p = 0.
//   - wgmma takes 32-bit operands K-major only, so the operand of a
//     product that reduces over keys or queries (v in O = p·v, k in
//     dq = ds·k, q and dO in dk = dsᵀ·q and dv = pᵀ·dO) is transposed in
//     shared memory from the staged tile. p and ds leave the accumulator of
//     one product and enter the next as its register A operand: the
//     accumulator holds columns 2t and 2t+1 of each group of 8 where the A
//     fragment wants t and t+4, so the transposed tiles store the rows of
//     each group of 8 in the order 0 2 4 6 1 3 5 7 and no value moves
//     between threads.
//   - The tensor core's float32 accumulation truncates; a sum over a whole
//     row of tiles (2,048 queries in dv) drifted past K3_TOL that way where
//     p is large. So each tile's O, dq, dk, dv product starts from zero and
//     joins the running sum in ordinary float32 adds.
//   - Operand tiles are in wgmma's no-swizzle K-major layout: core matrices
//     of 8 rows × 4 floats (128 contiguous bytes).
// O, lse and dq are written by their own block (no atomics), so runs repeat
// bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // query (K3a, K3b) or key (K3c) rows a block
constexpr float kNegInf = -1e30f;          // the masked-score fill, as on TPU
constexpr float kNoValidKey = 0.5f * kNegInf;  // lse below this: all masked
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

constexpr int kThreads = 128;  // one warpgroup a block

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element (r, c) of a tile whose rows are C floats along the reduction (K)
// axis, in wgmma's no-swizzle K-major layout: core matrices of 8 rows × 4
// floats, 128 contiguous bytes each; the core matrices of a row group are
// adjacent along K (leading byte offset 128), row groups C/4 core matrices
// apart (stride byte offset).
template <int C>
__device__ __forceinline__ int il(int r, int c) {
  return ((r >> 3) * (C / 4) + (c >> 2)) * 32 + (r & 7) * 4 + (c & 3);
}

// The descriptor of k-step `step` (8 floats of K) of such a tile.
template <int C>
__device__ __forceinline__ uint64_t desc(const float* tile, int step) {
  const uint32_t a = smem_u32(tile + step * 64);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>((C / 4 * 128) >> 4) << 32);
}

// d[64, N] += A · Bᵀ over 8 of K, A and B both from shared memory (ss) or
// A from registers (rs, the m64k8 tf32 fragment: rows 16w + g and 16w + g + 8
// of warp w, lane 4g + t; columns t and t + 4).
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b);
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Makes this thread's shared-memory writes visible to wgmma's reads.
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Pins registers that an in-flight wgmma reads or writes: no access to them
// moves across this point.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(full ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rows [0, n) of a [*, D] array into an [R, D] tile (K = D) by 16-byte
// cp.async; rows past n are zeros.
template <int R, int D>
__device__ __forceinline__ void stage_rows(float* tile, const float* src, int n) {
  for (int i = threadIdx.x; i < R * D / 4; i += kThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    cp_async16(tile + il<D>(r, c), src + static_cast<size_t>(r < n ? r : 0) * D + c, r < n);
  }
}

// Entries [0, n) of a vector into R floats by 4-byte cp.async; entries past
// n are zeros.
template <int R>
__device__ __forceinline__ void stage_vec(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < R; i += kThreads) cp_async4(dst + i, src + (i < n ? i : 0), i < n);
}

__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

// 2^x (MUFU.EX2: relative error ~2^-22; 0 for x = -inf).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float4 lo4(float4 v) {
  return make_float4(v.x - tf32_hi(v.x), v.y - tf32_hi(v.y), v.z - tf32_hi(v.z),
                     v.w - tf32_hi(v.w));
}

// lo = x - hi(x) for the N floats of a tile (same layout).
template <int N>
__device__ __forceinline__ void split_lo(float* lo, const float* x) {
  for (int i = threadIdx.x * 4; i < N; i += kThreads * 4)
    *reinterpret_cast<float4*>(lo + i) = lo4(*reinterpret_cast<const float4*>(x + i));
}

// The transposed copy of an [R, D] tile x (K = D) and its lo: element
// (r, c) goes to (c, κ(r)) of a [D, R] tile (K = R), where κ orders the rows
// of each group of 8 as 0 2 4 6 1 3 5 7 (see mma3_rs). A thread gathers the
// four rows of one κ quad and stores them as one float4; the eight lanes of
// a store phase take eight adjacent columns (one 128-byte core-matrix run).
template <int R, int D>
__device__ __forceinline__ void split_t(float* t, float* t_lo, const float* x) {
  for (int i = threadIdx.x; i < R * D / 4; i += kThreads) {
    const int c = (i & 7) | (((i >> 5) % (D / 8)) << 3);
    const int m = ((i >> 3) & 3) | (((i >> 5) / (D / 8)) << 2);  // κ = 4m .. 4m + 3
    const int r = (m >> 1) * 8 + (m & 1);                          // rows r, r+2, r+4, r+6
    const float4 v = make_float4(x[il<D>(r, c)], x[il<D>(r + 2, c)], x[il<D>(r + 4, c)],
                                 x[il<D>(r + 6, c)]);
    *reinterpret_cast<float4*>(t + il<R>(c, 4 * m)) = v;
    *reinterpret_cast<float4*>(t_lo + il<R>(c, 4 * m)) = lo4(v);
  }
}

// d[64, N] += A[64, K] · B[N, K]ᵀ in 3xTF32 with A and B in shared memory,
// the raw float32 tiles serving as hi, in two calls: mma_ss_a adds
// a_lo·b + a·b, which need only the raw B tile, and mma_ss_b adds a·b_lo
// once B's lo is split out.
template <int N, int K>
__device__ __forceinline__ void mma_ss_a(float (&d)[N / 2], const float* a, const float* a_lo,
                                         const float* b) {
#pragma unroll
  for (int s = 0; s < K / 8; ++s) wgmma_ss<N>(d, desc<K>(a_lo, s), desc<K>(b, s));
#pragma unroll
  for (int s = 0; s < K / 8; ++s) wgmma_ss<N>(d, desc<K>(a, s), desc<K>(b, s));
}

template <int N, int K>
__device__ __forceinline__ void mma_ss_b(float (&d)[N / 2], const float* a, const float* b_lo) {
#pragma unroll
  for (int s = 0; s < K / 8; ++s) wgmma_ss<N>(d, desc<K>(a, s), desc<K>(b_lo, s));
}

// The same with A = X[64, K] = hi + lo in registers, in the accumulator
// layout of an earlier m64nK product (registers 4j..4j+3 hold columns
// 8j + 2t, 8j + 2t + 1 of rows g and g + 8). As an A fragment, registers
// (4j, 4j+2, 4j+1, 4j+3) place column 8j + 2t at t and 8j + 2t + 1 at t + 4;
// B's tile stores its K axis in the same order (split_t).
template <int N, int K>
__device__ __forceinline__ void mma3_rs(float (&d)[N / 2], const float (&hi)[K / 2],
                                        const float (&lo)[K / 2], const float* b,
                                        const float* b_lo) {
#pragma unroll
  for (int pass = 0; pass < 2; ++pass)
#pragma unroll
    for (int j = 0; j < K / 8; ++j) {
      const uint32_t ah[4] = {__float_as_uint(hi[4 * j]), __float_as_uint(hi[4 * j + 2]),
                              __float_as_uint(hi[4 * j + 1]), __float_as_uint(hi[4 * j + 3])};
      if (pass == 0) {
        const uint32_t al[4] = {__float_as_uint(lo[4 * j]), __float_as_uint(lo[4 * j + 2]),
                                __float_as_uint(lo[4 * j + 1]), __float_as_uint(lo[4 * j + 3])};
        wgmma_rs<N>(d, al, desc<K>(b, j));
        wgmma_rs<N>(d, ah, desc<K>(b_lo, j));
      } else {
        wgmma_rs<N>(d, ah, desc<K>(b, j));
      }
    }
}

// x → (hi, lo) in place: x keeps hi.
template <int N>
__device__ __forceinline__ void split_regs(float (&x)[N], float (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float h = tf32_hi(x[i]);
    lo[i] = x[i] - h;
    x[i] = h;
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// acc += x. A tile's product joins the running sum in ordinary float32
// adds: the tensor core's own float32 accumulation truncates, and over the
// thousands of steps of a whole row of tiles that drifts.
template <int N>
__device__ __forceinline__ void promote(float (&acc)[N], const float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] += x[i];
}

// Bit i set: key tile w0 + i (i < 32, below n_tiles) holds a valid key.
// Called by every thread of the block: each loads its keys of the 32 tiles
// at once, and one OR over the block (a warp reduction, then `word` in
// shared memory) gives the bits to all.
template <int BN>
__device__ __forceinline__ uint32_t live_tiles(const float* mrow, int w0, int n_tiles,
                                               int Tk, unsigned* word) {
  uint32_t bits = 0;
#pragma unroll
  for (int i = threadIdx.x / BN; i < 32; i += kThreads / BN) {
    const int key = (w0 + i) * BN + static_cast<int>(threadIdx.x) % BN;
    if (w0 + i < n_tiles && key < Tk && mrow[key] > 0.f) bits |= 1u << i;
  }
  bits = __reduce_or_sync(0xffffffffu, bits);
  if (threadIdx.x == 0) *word = 0;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) atomicOr(word, bits);
  __syncthreads();
  bits = *word;
  __syncthreads();  // every thread has read the word before it is reset
  return bits;
}

// The first live key tile >= j, or n_tiles; (w0, bits) is the window of 32
// tiles last read by live_tiles, moved on as needed.
template <int BN>
__device__ __forceinline__ int next_live(const float* mrow, int j, int n_tiles, int Tk,
                                         int& w0, uint32_t& bits, unsigned* word) {
  while (j < n_tiles) {
    if (j >= w0 + 32) {
      w0 = j & ~31;
      bits = live_tiles<BN>(mrow, w0, n_tiles, Tk, word);
    }
    const uint32_t ahead = bits >> (j - w0);
    if (ahead) return j + __ffs(ahead) - 1;
    j = w0 + 32;
  }
  return n_tiles;
}

// Rows r0 = 16w + g and r0 + 8 of the 64 a thread holds in an accumulator,
// and its column offset 2t within each group of 8.
struct Frag {
  int r0, c;
  __device__ Frag() {
    const int lane = threadIdx.x & 31;
    r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);
    c = 2 * (lane & 3);
  }
};

// Writes rows [0, n) of a [64, D] accumulator, times mul, to dst [*, D].
template <int D>
__device__ __forceinline__ void store_acc(float* dst, const float (&acc)[D / 2], int n,
                                          float mul) {
  const Frag f;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = f.r0 + 8 * h;
      if (r < n)
        *reinterpret_cast<float2*>(dst + static_cast<size_t>(r) * D + 8 * j + f.c) =
            make_float2(acc[4 * j + 2 * h] * mul, acc[4 * j + 2 * h + 1] * mul);
    }
}

// Rows of the streamed tile: keys in K3a and K3b (64 at D = 32, 32 at
// D = 64), queries in K3c (32).
template <int D>
constexpr int kDqRows = D == 32 ? 64 : 32;
constexpr int kDkvRows = 32;

// Key tile j of K, V and the mask row into a stage ([BN, D] K, [BN, D] V,
// [BN] mask); keys past Tk are zeros.
template <int BN, int D>
__device__ __forceinline__ void stage_kv(float* st, const float* kb, const float* vb,
                                         const float* mrow, int j, int Tk) {
  const int n = min(BN, Tk - j * BN);
  const size_t off = static_cast<size_t>(j) * BN;
  stage_rows<BN, D>(st, kb + off * D, n);
  stage_rows<BN, D>(st + BN * D, vb + off * D, n);
  stage_vec<BN>(st + 2 * BN * D, mrow + off, n);
}

// K3a: Q (+ lo); 2 stages of K, V, mask; lo of K; Vᵀ (+ lo); a word.
template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (2 * 64 * D + 7 * kDqRows<D> * D + 2 * kDqRows<D> + 1);
}

// K3b: Q, dO (+ lo); 2 stages of K, V, mask; lo of K, V; Kᵀ (+ lo); lse, δ;
// a word.
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * 64 * D + 8 * kDqRows<D> * D + 2 * kDqRows<D> + 2 * 64 + 1);
}

// K3c: K, V (+ lo); 2 stages of Q, dO, lse, δ; lo of Q, dO; Qᵀ, dOᵀ (+ lo).
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * 64 * D + 10 * kDkvRows * D + 4 * kDkvRows);
}

// K3a: one block per (bh, 64 query rows). Loops over the live key tiles
// only; an element with none (all keys masked) gets O = the mean of v.
template <int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ mask,
           float* __restrict__ o, float* __restrict__ lse, int H, int Tq,
           int Tk, float scale) {
  constexpr int BN = kDqRows<D>, kT = BN * D;
  constexpr int kStage = 2 * kT + BN;  // K, V, mask
  extern __shared__ __align__(128) float sm[];
  float* qs = sm;                 // [64, D]
  float* q_lo = qs + 64 * D;
  float* ring = q_lo + 64 * D;    // 2 stages
  float* k_lo = ring + 2 * kStage;
  float* vt = k_lo + kT;          // Vᵀ [D, BN]
  float* vt_lo = vt + kT;
  unsigned* word = reinterpret_cast<unsigned*>(vt_lo + kT);

  const int bh = blockIdx.x, q0 = blockIdx.y * 64, nq = min(64, Tq - q0);
  const size_t qoff = (static_cast<size_t>(bh) * Tq + q0) * D;
  const size_t soff = static_cast<size_t>(bh) * Tq + q0;
  const float* kb = k + static_cast<size_t>(bh) * Tk * D;
  const float* vb = v + static_cast<size_t>(bh) * Tk * D;
  const float* mrow = mask + static_cast<size_t>(bh / H) * Tk;
  const int n_tiles = (Tk + BN - 1) / BN;
  const int tid = threadIdx.x;

  stage_rows<64, D>(qs, q + qoff, nq);  // in flight while the mask is read
  int w0 = -32;  // no window of live tiles read yet
  uint32_t bits = 0;
  int j = next_live<BN>(mrow, 0, n_tiles, Tk, w0, bits, word);
  if (j == n_tiles) {
    // All-masked element: the softmax of a row of -1e30 is 1/Tk on every key.
    cp_commit();
    cp_wait();  // the q copy lands before its shared memory is reused
    __syncthreads();
    float* part = sm;  // [kThreads]
    const int c = tid % D;
    float sum = 0.f;
    for (int r = tid / D; r < Tk; r += kThreads / D) sum += vb[static_cast<size_t>(r) * D + c];
    part[tid] = sum;
    __syncthreads();
    if (tid < D) {
      for (int i = tid + D; i < kThreads; i += D) sum += part[i];
      part[tid] = sum / static_cast<float>(Tk);
    }
    __syncthreads();
    for (int i = tid; i < nq * D; i += kThreads) o[qoff + i] = part[i % D];
    if (tid < nq) lse[soff + tid] = kNegInf + logf(static_cast<float>(Tk));
    return;
  }
  stage_kv<BN, D>(ring, kb, vb, mrow, j, Tk);
  cp_commit();
  cp_wait();
  __syncthreads();
  split_lo<64 * D>(q_lo, qs);
  proxy_fence();

  // Scores in log2 units, s · scale·log2 e: a masked key -1e30 (p = 0,
  // since every tile here holds a valid key), a key past Tk -inf. A thread
  // holds rows f.r0 + 8h (h = 0, 1); m is the row's maximum so far, l this
  // thread's share of the row sum (the 4 lanes' shares are added at the
  // end: every rescaling is the same on all 4).
  const Frag f;
  const float c1 = scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 2];
  zero(acc);
  int st = 0;
  while (j < n_tiles) {
    const float* kh = ring + st * kStage;
    const float* vh = kh + kT;
    const float* ms = vh + kT;
    cp_wait();
    proxy_fence();
    __syncthreads();  // tile j has landed; the previous tile's products are done

    float s[BN / 2];
    zero(s);
    pin(s);
    wg_fence();
    mma_ss_a<BN, D>(s, qs, q_lo, kh);  // S = Q Kᵀ
    wg_commit();
    // Meanwhile: the next live tile's copy, and K's lo.
    const int jn = next_live<BN>(mrow, j + 1, n_tiles, Tk, w0, bits, word);
    if (jn < n_tiles) stage_kv<BN, D>(ring + (st ^ 1) * kStage, kb, vb, mrow, jn, Tk);
    cp_commit();
    split_lo<kT>(k_lo, kh);
    proxy_fence();
    __syncthreads();
    mma_ss_b<BN, D>(s, qs, k_lo);
    wg_commit();
    split_t<BN, D>(vt, vt_lo, vh);  // meanwhile: Vᵀ for O += P V
    proxy_fence();
    wg_wait();
    pin(s);
    __syncthreads();

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      const float2 mk = *reinterpret_cast<const float2*>(ms + 8 * jj + f.c);  // 0 past Tk
      const int key = j * BN + 8 * jj + f.c;
      const bool valid[2] = {mk.x > 0.f, mk.y > 0.f};
      const float dead[2] = {key < Tk ? kNegInf : -INFINITY,
                             key + 1 < Tk ? kNegInf : -INFINITY};
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * jj + 2 * h + e;
          s[i] = valid[e] ? s[i] * c1 : dead[e];
          mx[h] = fmaxf(mx[h], s[i]);
        }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the row's maximum over its 4 lanes
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      corr[h] = exp2_approx(m[h] - mx[h]);  // 0 on the first live tile
      m[h] = mx[h];
      l[h] *= corr[h];
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int h = (i >> 1) & 1;
      s[i] = exp2_approx(s[i] - m[h]);  // p
      l[h] += s[i];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

    float p_lo[BN / 2], t[D / 2];
    split_regs(s, p_lo);
    zero(t);
    pin(s);
    pin(p_lo);
    pin(t);
    wg_fence();
    mma3_rs<D, BN>(t, s, p_lo, vt, vt_lo);  // this tile's P V
    wg_commit();
    wg_wait();
    pin(t);
    pin(s);
    pin(p_lo);
    promote(acc, t);
    j = jn;
    st ^= 1;
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = 1.f / l[h];
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] *= inv[(i >> 1) & 1];
  store_acc<D>(o + qoff, acc, nq, 1.f);
  if ((tid & 3) == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = f.r0 + 8 * h;
      if (r < nq) lse[soff + r] = m[h] * kLn2 + logf(l[h]);
    }
}

// K3b: one block per (bh, 64 query rows); writes δ = rowsum(dO ∘ O) for K3c
// beside dq. Loops over the live key tiles only: a masked key adds exactly
// 0 to dq, and an all-masked element gets dq = 0.
template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ mask,
              const float* __restrict__ o, const float* __restrict__ dout,
              const float* __restrict__ lse, float* __restrict__ delta,
              float* __restrict__ dq, int H, int Tq, int Tk, float scale) {
  constexpr int BN = kDqRows<D>, kT = BN * D;
  constexpr int kStage = 2 * kT + BN;  // K, V, mask
  extern __shared__ __align__(128) float sm[];
  float* qs = sm;                 // [64, D]
  float* q_lo = qs + 64 * D;
  float* os = q_lo + 64 * D;      // dO [64, D]
  float* o_lo = os + 64 * D;
  float* ring = o_lo + 64 * D;    // 2 stages
  float* k_lo = ring + 2 * kStage;
  float* v_lo = k_lo + kT;
  float* kt = v_lo + kT;          // Kᵀ [D, BN]
  float* kt_lo = kt + kT;
  float* ls = kt_lo + kT;         // lse [64]
  float* dls = ls + 64;           // δ [64]
  unsigned* word = reinterpret_cast<unsigned*>(dls + 64);

  const int bh = blockIdx.x, q0 = blockIdx.y * 64, nq = min(64, Tq - q0);
  const size_t qoff = (static_cast<size_t>(bh) * Tq + q0) * D;
  const float* kb = k + static_cast<size_t>(bh) * Tk * D;
  const float* vb = v + static_cast<size_t>(bh) * Tk * D;
  const float* mrow = mask + static_cast<size_t>(bh / H) * Tk;
  const int n_tiles = (Tk + BN - 1) / BN;

  stage_rows<64, D>(qs, q + qoff, nq);
  stage_rows<64, D>(os, dout + qoff, nq);
  int w0 = -32;  // no window of live tiles read yet
  uint32_t bits = 0;
  int j = next_live<BN>(mrow, 0, n_tiles, Tk, w0, bits, word);
  if (j < n_tiles) stage_kv<BN, D>(ring, kb, vb, mrow, j, Tk);
  cp_commit();

  {  // δ: two threads a row, D/2 columns each
    const int r = threadIdx.x >> 1, c0 = (threadIdx.x & 1) * (D / 2);
    float s = 0.f;
    if (r < nq) {
      const float* orow = o + qoff + static_cast<size_t>(r) * D + c0;
      const float* drow = dout + qoff + static_cast<size_t>(r) * D + c0;
#pragma unroll
      for (int c = 0; c < D / 2; c += 4) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(orow + c));
        const float4 y = __ldg(reinterpret_cast<const float4*>(drow + c));
        s = fmaf(y.x, x.x, s);
        s = fmaf(y.y, x.y, s);
        s = fmaf(y.z, x.z, s);
        s = fmaf(y.w, x.w, s);
      }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if ((threadIdx.x & 1) == 0) {
      const size_t soff = static_cast<size_t>(bh) * Tq + q0 + r;
      dls[r] = s;
      ls[r] = r < nq ? lse[soff] : 0.f;
      if (r < nq) delta[soff] = s;
    }
  }
  cp_wait();
  __syncthreads();
  split_lo<64 * D>(q_lo, qs);
  split_lo<64 * D>(o_lo, os);
  proxy_fence();

  // p = 2^(s · scale·log2 e - lse·log2 e - off), off = inf on a masked key
  // or one past Tk (p = 0). A row of an all-masked element (lse <
  // kNoValidKey) has no live tile, so it never gets here.
  const Frag f;
  const float c1 = scale * kLog2e;
  const float l2[2] = {ls[f.r0] * kLog2e, ls[f.r0 + 8] * kLog2e};
  const float dl[2] = {dls[f.r0], dls[f.r0 + 8]};
  float acc[D / 2];
  zero(acc);
  int st = 0;
  while (j < n_tiles) {
    const float* kh = ring + st * kStage;
    const float* vh = kh + kT;
    const float* ms = vh + kT;
    cp_wait();
    proxy_fence();
    __syncthreads();  // tile j has landed; the previous tile's products are done

    float s[BN / 2], dp[BN / 2];
    zero(s);
    zero(dp);
    pin(s);
    pin(dp);
    wg_fence();
    mma_ss_a<BN, D>(s, qs, q_lo, kh);   // S = Q Kᵀ
    mma_ss_a<BN, D>(dp, os, o_lo, vh);  // dP = dO Vᵀ
    wg_commit();
    // Meanwhile: the next live tile's copy, and K's and V's lo.
    const int jn = next_live<BN>(mrow, j + 1, n_tiles, Tk, w0, bits, word);
    if (jn < n_tiles) stage_kv<BN, D>(ring + (st ^ 1) * kStage, kb, vb, mrow, jn, Tk);
    cp_commit();
    split_lo<kT>(k_lo, kh);
    split_lo<kT>(v_lo, vh);
    proxy_fence();
    __syncthreads();
    mma_ss_b<BN, D>(s, qs, k_lo);
    mma_ss_b<BN, D>(dp, os, v_lo);
    wg_commit();
    split_t<BN, D>(kt, kt_lo, kh);  // meanwhile: Kᵀ for dQ
    proxy_fence();
    wg_wait();
    pin(s);
    pin(dp);
    __syncthreads();

#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      const float2 m = *reinterpret_cast<const float2*>(ms + 8 * jj + f.c);  // 0 past Tk
      const float off[2] = {m.x > 0.f ? 0.f : INFINITY, m.y > 0.f ? 0.f : INFINITY};
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * jj + 2 * h + e;
          const float p = exp2_approx(fmaf(s[i], c1, -l2[h]) - off[e]);
          s[i] = p * (dp[i] - dl[h]);  // ds
        }
    }
    float ds_lo[BN / 2], t[D / 2];
    split_regs(s, ds_lo);
    zero(t);
    pin(s);
    pin(ds_lo);
    pin(t);
    wg_fence();
    mma3_rs<D, BN>(t, s, ds_lo, kt, kt_lo);  // this tile's dS K
    wg_commit();
    wg_wait();
    pin(t);
    pin(s);
    pin(ds_lo);
    promote(acc, t);
    j = jn;
    st ^= 1;
  }
  store_acc<D>(dq + qoff, acc, nq, scale);
}

// K3c: one block per (bh, 64 key rows).
template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ mask,
               const float* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dk,
               float* __restrict__ dv, int H, int Tq, int Tk, float scale) {
  constexpr int BQ = kDkvRows, kT = BQ * D;
  constexpr int kStage = 2 * kT + 2 * BQ;  // Q, dO, lse, δ
  extern __shared__ __align__(128) float sm[];
  float* ks = sm;                 // [64, D]
  float* k_lo = ks + 64 * D;
  float* vs = k_lo + 64 * D;
  float* v_lo = vs + 64 * D;
  float* ring = v_lo + 64 * D;    // 2 stages
  float* q_lo = ring + 2 * kStage;
  float* o_lo = q_lo + kT;
  float* qt = o_lo + kT;          // Qᵀ [D, BQ]
  float* qt_lo = qt + kT;
  float* ot = qt_lo + kT;         // dOᵀ [D, BQ]
  float* ot_lo = ot + kT;

  const int bh = blockIdx.x, k0 = blockIdx.y * 64, nk = min(64, Tk - k0);
  const size_t koff = (static_cast<size_t>(bh) * Tk + k0) * D;
  const float* qb = q + static_cast<size_t>(bh) * Tq * D;
  const float* dob = dout + static_cast<size_t>(bh) * Tq * D;
  const float* lb = lse + static_cast<size_t>(bh) * Tq;
  const float* db = delta + static_cast<size_t>(bh) * Tq;
  const float* mrow = mask + static_cast<size_t>(bh / H) * Tk;
  const int tid = threadIdx.x;

  if (!__syncthreads_or(tid < nk && mrow[k0 + tid] > 0.f)) {
    // No valid key here. K3a gives every row of an element with a valid key
    // a finite lse, and every row of an all-masked one -1e30.
    if (!(lb[0] < kNoValidKey)) {  // live element, dead tile: dk = dv = 0
      for (int i = tid * 4; i < nk * D; i += kThreads * 4) {
        *reinterpret_cast<float4*>(dk + koff + i) = make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(dv + koff + i) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      return;
    }
    // All-masked element: p = 1/Tk for every key, ds = 0.
    float* part = sm;  // [kThreads]
    const int c = tid % D;
    float sum = 0.f;
    for (int r = tid / D; r < Tq; r += kThreads / D) sum += dob[static_cast<size_t>(r) * D + c];
    part[tid] = sum;
    __syncthreads();
    if (tid < D) {
      for (int i = tid + D; i < kThreads; i += D) sum += part[i];
      part[tid] = sum / static_cast<float>(Tk);
    }
    __syncthreads();
    for (int i = tid; i < nk * D; i += kThreads) {
      dk[koff + i] = 0.f;
      dv[koff + i] = part[i % D];
    }
    return;
  }

  const int n_tiles = (Tq + BQ - 1) / BQ;
  auto stage_q = [&](float* s, int t) {
    const int n = min(BQ, Tq - t * BQ);
    const size_t off = static_cast<size_t>(t) * BQ;
    stage_rows<BQ, D>(s, qb + off * D, n);
    stage_rows<BQ, D>(s + kT, dob + off * D, n);
    stage_vec<BQ>(s + 2 * kT, lb + off, n);
    stage_vec<BQ>(s + 2 * kT + BQ, db + off, n);
  };
  stage_rows<64, D>(ks, k + koff, nk);
  stage_rows<64, D>(vs, v + koff, nk);
  stage_q(ring, 0);
  cp_commit();
  cp_wait();
  __syncthreads();
  split_lo<64 * D>(k_lo, ks);
  split_lo<64 * D>(v_lo, vs);

  proxy_fence();

  // p = 2^(s · scale·log2 e - lse·log2 e - off), off = inf on a masked key
  // or one past Tk (p = 0). Every row of this element has a finite lse (it
  // has a valid key). Queries past Tq have zero q, dO, lse and δ rows: they
  // add exactly 0.
  const Frag f;
  float off[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + f.r0 + 8 * h;
    off[h] = key < Tk && mrow[key] > 0.f ? 0.f : INFINITY;
  }
  const float c1 = scale * kLog2e;
  float dka[D / 2], dva[D / 2];
  zero(dka);
  zero(dva);
  for (int t = 0; t < n_tiles; ++t) {
    const float* qh = ring + (t & 1) * kStage;
    const float* oh = qh + kT;
    const float* ls = oh + kT;
    const float* dls = ls + BQ;
    cp_wait();
    proxy_fence();
    __syncthreads();  // tile t has landed; the previous tile's products are done

    float s[BQ / 2], dp[BQ / 2];
    zero(s);
    zero(dp);
    pin(s);
    pin(dp);
    wg_fence();
    mma_ss_a<BQ, D>(s, ks, k_lo, qh);   // Sᵀ = K Qᵀ
    mma_ss_a<BQ, D>(dp, vs, v_lo, oh);  // dPᵀ = V dOᵀ
    wg_commit();
    // Meanwhile: the next tile's copy, and Q's and dO's lo.
    if (t + 1 < n_tiles) stage_q(ring + ((t + 1) & 1) * kStage, t + 1);
    cp_commit();
    split_lo<kT>(q_lo, qh);
    split_lo<kT>(o_lo, oh);
    proxy_fence();
    __syncthreads();
    mma_ss_b<BQ, D>(s, ks, q_lo);
    mma_ss_b<BQ, D>(dp, vs, o_lo);
    wg_commit();
    split_t<BQ, D>(qt, qt_lo, qh);  // meanwhile: Qᵀ and dOᵀ
    split_t<BQ, D>(ot, ot_lo, oh);
    proxy_fence();
    wg_wait();
    pin(s);
    pin(dp);
    __syncthreads();

#pragma unroll
    for (int jj = 0; jj < BQ / 8; ++jj) {
      const float2 l = *reinterpret_cast<const float2*>(ls + 8 * jj + f.c);
      const float2 d = *reinterpret_cast<const float2*>(dls + 8 * jj + f.c);
      const float l2[2] = {l.x * kLog2e, l.y * kLog2e}, dl[2] = {d.x, d.y};
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * jj + 2 * h + e;
          const float p = exp2_approx(fmaf(s[i], c1, -l2[e]) - off[h]);
          dp[i] = p * (dp[i] - dl[e]);  // ds
          s[i] = p;
        }
    }
    float p_lo[BQ / 2], ds_lo[BQ / 2], tv[D / 2], tk[D / 2];
    split_regs(s, p_lo);
    split_regs(dp, ds_lo);
    zero(tv);
    zero(tk);
    pin(s);
    pin(p_lo);
    pin(dp);
    pin(ds_lo);
    pin(tv);
    pin(tk);
    wg_fence();
    mma3_rs<D, BQ>(tv, s, p_lo, ot, ot_lo);    // this tile's Pᵀ dO
    mma3_rs<D, BQ>(tk, dp, ds_lo, qt, qt_lo);  // and dSᵀ Q
    wg_commit();
    wg_wait();
    pin(tv);
    pin(tk);
    pin(s);
    pin(p_lo);
    pin(dp);
    pin(ds_lo);
    promote(dva, tv);
    promote(dka, tk);
  }
  store_acc<D>(dk + koff, dka, nk, scale);
  store_acc<D>(dv + koff, dva, nk, 1.f);
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

// K3a-c take more than 48 KB of shared memory: dynamic, after raising the
// kernel's limit.
template <int D>
cudaError_t launch_fwd(dim3 grid, cudaStream_t stream, const float* q, const float* k,
                       const float* v, const float* mask, float* o, float* lse, int H,
                       int Tq, int Tk) {
  constexpr size_t bytes = fwd_smem<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  fwd_kernel<D><<<grid, kThreads, bytes, stream>>>(q, k, v, mask, o, lse, H, Tq, Tk, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(dim3 grid, cudaStream_t stream, const float* q, const float* k,
                      const float* v, const float* mask, const float* o,
                      const float* dout, const float* lse, float* delta, float* dq,
                      int H, int Tq, int Tk) {
  constexpr size_t bytes = dq_smem<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  bwd_dq_kernel<D><<<grid, kThreads, bytes, stream>>>(q, k, v, mask, o, dout, lse, delta, dq,
                                                      H, Tq, Tk, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(dim3 grid, cudaStream_t stream, const float* q, const float* k,
                       const float* v, const float* mask, const float* dout,
                       const float* lse, const float* delta, float* dk, float* dv,
                       int H, int Tq, int Tk) {
  constexpr size_t bytes = dkv_smem<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  bwd_dkv_kernel<D><<<grid, kThreads, bytes, stream>>>(q, k, v, mask, dout, lse, delta, dk, dv,
                                                       H, Tq, Tk, scale);
  return cudaGetLastError();
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
  return static_cast<int>(
      D == 32 ? launch_fwd<32>(grid_for(B, H, Tq), stream, q, k, v, mask, o, lse, H, Tq, Tk)
              : launch_fwd<64>(grid_for(B, H, Tq), stream, q, k, v, mask, o, lse, H, Tq, Tk));
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
  return static_cast<int>(
      D == 32 ? launch_dq<32>(grid_for(B, H, Tq), stream, q, k, v, mask, o, dout, lse,
                              delta, dq, H, Tq, Tk)
              : launch_dq<64>(grid_for(B, H, Tq), stream, q, k, v, mask, o, dout, lse,
                              delta, dq, H, Tq, Tk));
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
  return static_cast<int>(
      D == 32 ? launch_dkv<32>(grid_for(B, H, Tk), stream, q, k, v, mask, dout, lse,
                               delta, dk, dv, H, Tq, Tk)
              : launch_dkv<64>(grid_for(B, H, Tk), stream, q, k, v, mask, dout, lse,
                               delta, dk, dv, H, Tq, Tk));
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
