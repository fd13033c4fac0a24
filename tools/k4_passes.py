"""Time kernel K4's two passes on the card, with an instrumented copy.

    python -m tools.k4_passes [n ...]

Copies `tpu_deer_torch/kernels/csrc/quantize_int8.cu` into
`build/k4_passes/`, stamps `%globaltimer` in thread 0 of every block at the
kernel's start, after pass 1 (the block's slot written), after the
grid-wide barrier and at the end, and appends a `main` that launches the
kernel through its own C entry points on w [n] (values in [-2, 2) from a
hash of the index; q discarded). Builds it with nvcc three times: as it is;
with Philox replaced by a cheap mix of the counter (that copy's q is not
K4's), which shows Philox's share of pass 2; and with the rest of each
share read under an L2 evict_normal policy in place of evict_last, which
shows what the keep hint does for pass 2 once w outgrows shared memory.
For each n, mode (Philox or given words) and build, prints the medians over
35 launches of the time between CUDA events around one launch and, across
the blocks, of pass 1 (first start to last pass-1 end), the barrier (last
pass-1 end to last exit from it) and pass 2 (first exit to last end), in
microseconds. The stamps cost one store a block at each point. Needs a card
and nvcc; the shares are the wrapper's (`quantize_int8.split` for the
card's `launch_config`). The copy is made by inserting text at anchors in
the source: it raises if the kernel no longer has one of them.
"""

from __future__ import annotations

import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from tpu_deer_torch.kernels import build, quantize_int8

SIZES = (4096 * 4096, 7_666_560, 768 * 512)  # [4096, 4096], about the
# H100's staged capacity, the flagship's largest Dense kernel
# (text, anchor) pairs: a stamp goes right after each anchor.
STAMPS = (
    ("  PROBE(0);\n", "  const uint64_t keep = evict_last_policy();\n"),
    ("  PROBE(1);\n", "  if (tid == 0) slots[blockIdx.x] = m;\n"),
    ("  PROBE(2);\n", "  cg::this_grid().sync();\n"),
)
END = "  round_quads<PHILOX>(w, bits, q, stage_f, start, done, len, st, key, scale);\n"
PROBE = """
__device__ unsigned long long k4_stamps[1024 * 4];
#define PROBE(k) do { if (threadIdx.x == 0) { unsigned long long t_; \\
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); \\
  k4_stamps[blockIdx.x * 4 + (k)] = t_; } } while (0)
#ifdef K4_NO_KEEP
#define K4_POLICY "createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;\\n"
#else
#define K4_POLICY "createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\\n"
#endif
"""
POLICY = '"createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\\n"'
PHILOX = "__device__ __forceinline__ uint4 philox_at(long long counter, uint2 key) {\n"
NO_PHILOX = """#ifdef K4_NO_PHILOX
  const unsigned c = static_cast<unsigned>(counter) * 0x9E3779B9u ^ key.x;
  return make_uint4(c, c ^ 0x5555u, c ^ 0xAAAAu, c ^ 0x3333u);
#endif
"""
MAIN = r"""
#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <vector>

__global__ void k4_fill(float* w, long long n) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n; i += 256LL * gridDim.x) {
    unsigned h = static_cast<unsigned>(i) * 2654435761u;
    h ^= h >> 13; h *= 0x5bd1e995u; h ^= h >> 15;
    w[i] = ((h & 0xFFFF) / 65536.0f - 0.5f) * 4.0f;
  }
}

static double median(std::vector<double> v) {
  std::sort(v.begin(), v.end());
  return v[v.size() / 2];
}

// argv: n grid share staged, repeated.
int main(int argc, char** argv) {
  int config[2];
  if (quantize_int8_config(0, config)) return 1;
  for (int a = 1; a + 3 < argc; a += 4) {
    const long long n = atoll(argv[a]), share = atoll(argv[a + 2]);
    const int grid = atoi(argv[a + 1]), staged = atoi(argv[a + 3]);
    float *w, *out; int* bits; signed char* q;
    cudaMalloc(&w, n * 4); cudaMalloc(&bits, n * 4); cudaMalloc(&q, n);
    cudaMalloc(&out, 4 * (grid + 1));
    k4_fill<<<1024, 256>>>(w, n);
    cudaMemset(bits, 0x5A, n * 4);
    cudaEvent_t e0, e1;
    cudaEventCreate(&e0); cudaEventCreate(&e1);
    for (int given = 0; given < 2; ++given) {
      std::vector<double> event, pass1, barrier, pass2;
      for (int rep = 0; rep < 40; ++rep) {
        cudaEventRecord(e0);
        const int rc = quantize_int8_launch(0, w, given ? bits : nullptr, q, out,
                                            reinterpret_cast<unsigned*>(out + 1), n,
                                            share, staged, grid, 77, 0);
        cudaEventRecord(e1);
        cudaEventSynchronize(e1);
        if (rc) { printf("launch failed: %d\n", rc); return 1; }
        std::vector<unsigned long long> t(4 * grid);
        cudaMemcpyFromSymbol(t.data(), k4_stamps, t.size() * 8);
        unsigned long long start = ~0ull, end1 = 0, exit_first = ~0ull, exit_last = 0, end = 0;
        for (int b = 0; b < grid; ++b) {
          start = std::min(start, t[4 * b]);
          end1 = std::max(end1, t[4 * b + 1]);
          exit_first = std::min(exit_first, t[4 * b + 2]);
          exit_last = std::max(exit_last, t[4 * b + 2]);
          end = std::max(end, t[4 * b + 3]);
        }
        float ms;
        cudaEventElapsedTime(&ms, e0, e1);
        if (rep < 5) continue;
        event.push_back(1e3 * ms);
        pass1.push_back((end1 - start) / 1e3);
        barrier.push_back((exit_last - end1) / 1e3);
        pass2.push_back((end - exit_first) / 1e3);
      }
      printf("n=%lld %s grid=%d share=%lld staged=%d: event %.2f us, pass 1 %.2f us, "
             "barrier %.2f us, pass 2 %.2f us\n", n, given ? "given words" : "Philox",
             grid, share, staged, median(event), median(pass1), median(barrier),
             median(pass2));
    }
    cudaFree(w); cudaFree(bits); cudaFree(q); cudaFree(out);
  }
  return 0;
}
"""


def instrumented_source() -> str:
    """csrc/quantize_int8.cu with the stamps, the K4_NO_PHILOX and
    K4_NO_KEEP switches and a main; raises if an anchor is not found once
    (the kernel changed)."""
    src = (build.CSRC / "quantize_int8.cu").read_text()
    edits = [(anchor, anchor + stamp) for stamp, anchor in STAMPS]
    edits += [(END, END + "  __syncthreads();\n  PROBE(3);\n"), (PHILOX, PHILOX + NO_PHILOX),
              (POLICY, "K4_POLICY"),
              ("namespace cg = cooperative_groups;\n",
               "namespace cg = cooperative_groups;\n" + PROBE)]
    for anchor, text in edits:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in quantize_int8.cu: {anchor!r}")
        src = src.replace(anchor, text)
    return src + MAIN


def main(argv: list[str]) -> int:
    sizes = [int(a) for a in argv] or list(SIZES)
    out = build.BUILD_DIR.parent / "k4_passes"
    out.mkdir(parents=True, exist_ok=True)
    (out / "k4_passes.cu").write_text(instrumented_source())
    builds = {"as built": [], "Philox replaced": ["-DK4_NO_PHILOX"],
              "rest read evict_normal": ["-DK4_NO_KEEP"]}

    def compile_one(item):
        name, flags = item
        exe = out / ("k4_passes" + "".join(flags).replace("-D", "_").lower())
        subprocess.run([build._nvcc(), *build.ARCH_FLAGS, "-std=c++17", "-O3", *flags,
                        "-o", str(exe), str(out / "k4_passes.cu")], check=True)
        return name, exe

    with ThreadPoolExecutor(len(builds)) as pool:
        exes = list(pool.map(compile_one, builds.items()))
    resident, stage_bytes = quantize_int8.launch_config(0)
    args = []
    for n in sizes:
        args += [str(v) for v in (n, *quantize_int8.split(n, resident, stage_bytes))]
    for name, exe in exes:
        print(f"== K4 {name} ({resident} resident blocks, {stage_bytes} B staged each)",
              flush=True)
        subprocess.run([str(exe), *args], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
