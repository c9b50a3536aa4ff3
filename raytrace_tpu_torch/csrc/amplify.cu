// Amplify kernel (B3): the gain-only amplification of the seeded path,
//
//   Iv[b, k] = Iv0[b, k] * exp(sum_t gvl[b, t] * gv[seg(t)][ivl[b, t], k])
//
// in f64, with t running over (segment, sub-length) pairs, sub-lengths
// fastest, and seg(t) = t / nsub.
//
// Replaces the Pallas TPU kernel raytrace_tpu/ops/pallas_amplify.py
// (_loggain_kernel, launched by log_gain_fused) together with the Iv0 * exp
// that follows it (raytrace_tpu/ops/spectrum.py:194). On a TPU the row fetch
// gv[seg][ivl] is a windowed one-hot matmul on the MXU over a bf16 triple of
// the tables, and the sum a two-float f32 pair, because a TPU has no
// per-lane gather and emulates f64. Hopper gathers per thread and has native
// f64, so this kernel reads the f32 table rows directly and sums in f64 in
// the order of the plain twin (raytrace_tpu_torch/ops/amplify_kernel.py,
// amplify_gain_plain) and of the reference (RayTraceImageHelper.h:569-581).
// The TPU's table packing (pack_gv) has no counterpart.
//
// Layout: one thread per (ray, frequency) element, frequency fastest, so a
// warp reads consecutive entries of one gv row and the rows of the two or
// three rays it spans; the K threads of a ray read the same ivl/gvl words
// (one L1 line). The tables (~0.9 MB a segment at the shipped widths) stay
// in L2 and are read through the read-only cache.
//
// What bounds it: device-memory traffic, 16 bytes per element for Iv0 in and
// Iv out; the row gathers hit L2. The arithmetic is 2 f64 operations per
// term and one exp per element.
//
// Compiled with -fmad=false: each f64 product and sum rounds on its own, as
// the twin's separate PyTorch operations do, so the log-gain equals the
// twin's bitwise. exp may differ from PyTorch's CUDA exp by an ulp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void amplify_gain_kernel(const double* __restrict__ Iv0,
                                    const int32_t* __restrict__ ivl,
                                    const float* __restrict__ gvl,
                                    const float* __restrict__ gv, int64_t B,
                                    int T, int nsub, int cells, int K,
                                    double* __restrict__ Iv,
                                    double* __restrict__ log_gain) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B * K) return;
  const int64_t b = e / K;
  const int k = (int)(e - b * K);
  const int32_t* ivl_b = ivl + b * T;
  const float* gvl_b = gvl + b * T;
  double acc = 0.0;
  for (int t = 0; t < T; ++t) {
    const int64_t seg = t / nsub;
    const int64_t cell = __ldg(ivl_b + t);
    const float row = __ldg(gv + (seg * cells + cell) * K + k);
    acc = acc + (double)__ldg(gvl_b + t) * (double)row;
  }
  if (log_gain != nullptr) log_gain[e] = acc;
  Iv[e] = Iv0[e] * exp(acc);
}

}  // namespace

// C entry bound with ctypes by raytrace_tpu_torch/ops/amplify_kernel.py.
// Writes Iv [B, K] (and the log-gain, where `log_gain` is not null) on
// `stream`, does not synchronise, and returns cudaGetLastError() of the
// launch.
extern "C" int rt_amplify_gain(const double* Iv0, const int32_t* ivl,
                               const float* gvl, const float* gv, int64_t B,
                               int T, int nsub, int cells, int K, double* Iv,
                               double* log_gain, void* stream) {
  const int threads = 256;
  const int64_t blocks = (B * K + threads - 1) / threads;
  if (blocks > 0) {
    amplify_gain_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        Iv0, ivl, gvl, gv, B, T, nsub, cells, K, Iv, log_gain);
  }
  return (int)cudaGetLastError();
}
