// Gather probe (P1): the latency of one dependent table gather per thread.
//
// Replaces the Pallas TPU probe kernel of tools/vpu_probe.py (the gk(K)
// kernel: K dependent lane-shuffle gathers from an (8,128) table). Each
// thread runs K dependent steps
//
//   v = v + tab[row][(idx + (int)v % one) % 128]
//
// with `one` == 1 passed at run time: the index always equals idx, but the
// compiler cannot know that, so every gather waits for the previous sum, as
// in the TPU probe's body. The table is read through __ldg, the read-only
// cache path that trace kernel B1 fetches its gain tables with; the 512-byte
// row of a thread's block stays in L1, so a step is an L1 hit plus the
// integer and f32 work of the index and the sum.
//
// Timing is the caller's: two launches of different K, differenced, give
// the time of one step (raytrace_tpu_torch/tools/gather_probe.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRow = 128;

__global__ void gather_probe_kernel(const float* __restrict__ tab,
                                    const int32_t* __restrict__ idx,
                                    float* __restrict__ out, int64_t n, int K,
                                    int one) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const float* row = tab + (e / kRow) * kRow;
  const int i0 = idx[e];
  float v = 0.0f;
  for (int s = 0; s < K; ++s) {
    const int j = (i0 + (int)v % one) % kRow;
    v = v + __ldg(row + j);
  }
  out[e] = v;
}

}  // namespace

// C entry bound with ctypes by raytrace_tpu_torch/tools/gather_probe.py.
// `tab`, `idx` and `out` hold n = rows * 128 elements. Launches on `stream`,
// does not synchronise, and returns cudaGetLastError() of the launch.
extern "C" int rt_gather_probe(const float* tab, const int32_t* idx,
                               float* out, int64_t n, int K, int one,
                               void* stream) {
  const int threads = kRow;
  const int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 0) {
    gather_probe_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        tab, idx, out, n, K, one);
  }
  return (int)cudaGetLastError();
}
