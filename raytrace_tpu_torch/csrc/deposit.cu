// Deposit kernel (B2): out[c, k] += sum over rays b with bins[b] == c of
// contrib[b, k], in f64, into an accumulator the caller owns.
//
// Replaces the Pallas TPU kernel raytrace_tpu/ops/deposit_kernel.py
// (_deposit_kernel, launched by deposit_tiles). On a TPU the deposit is a
// bf16x3 one-hot matmul on the MXU because per-element scatter is slow
// there; Hopper has native f64 atomicAdd, which is also what the reference's
// GPU backend does (atomicAdd2, src/RayTraceImageCuda.cu:37-48). One thread
// per (ray, frequency) element: neighbouring threads read neighbouring
// contrib values and add into neighbouring cells of one image row.
//
// What bounds it: atomics to the L2. The image ([nx*ny, K] f64, ~600 KB at
// the shipped ASE size) sits in L2; rays of a chunk spread over its cells.
// Bin C (== out rows) is the trash bin of invalid rays and is skipped.
//
// Summation order under atomics changes from run to run, so the result
// differs between runs at about 1e-15 relative.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void deposit_kernel(double* __restrict__ out,
                               const double* __restrict__ contrib,
                               const int32_t* __restrict__ bins, int64_t B,
                               int K, int C) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B * K) return;
  const int64_t b = e / K;
  const int k = (int)(e - b * K);
  const int cell = bins[b];
  if (cell < 0 || cell >= C) return;
  atomicAdd(out + (int64_t)cell * K + k, contrib[e]);
}

}  // namespace

// C entry bound with ctypes by raytrace_tpu_torch/ops/deposit_kernel.py.
// Adds into `out` in place on `stream`, does not synchronise, and returns
// cudaGetLastError() of the launch.
extern "C" int rt_deposit(double* out, const double* contrib,
                          const int32_t* bins, int64_t B, int K, int C,
                          void* stream) {
  const int threads = 256;
  const int64_t blocks = (B * K + threads - 1) / threads;
  if (blocks > 0) {
    deposit_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        out, contrib, bins, B, K, C);
  }
  return (int)cudaGetLastError();
}
