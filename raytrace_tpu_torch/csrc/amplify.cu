// Amplify kernel (B3): the seeded path's gain-only amplification with the
// entry seed and the failure flags fused in,
//
//   Iv[b, k] = (escaped[b] ? 0 : f[b] * fv[k])
//              * exp(sum_t gvl[b, t] * gv[seg(t)][ivl[b, t], k])
//   flags[b] = bit 0 if any Iv[b, :] < 0, bit 1 if any Iv[b, :] is NaN
//
// in f64, with t running over (segment, sub-length) pairs, sub-lengths
// fastest. f[b] is the ray's separable seed factor f0 fx fy fa fb (clamped
// at 0) and fv the frequency profile, so the entry spectrum Iv0 = f fv is an
// outer product that is never stored.
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
// What bounds it on an H100: device-memory bytes. Per element it writes the
// 8-byte spectrum; per ray it reads T cell ids and path gains (8 T bytes),
// the seed factor and the escape flag, and writes one flag byte. For a
// 2^20-ray chunk at K 82 and T 6 that is about 0.74 GB, 0.221 ms at
// 3.35 TB/s. The row gathers (T per element) come from L2 and L1: the
// tables are 0.9 MB a segment at the shipped widths.
//
// Design:
// * a block covers a tile of rays (threadIdx.y) with one thread per V
//   consecutive frequencies (threadIdx.x): no integer division per element;
//   V = 2 where K is even, so the rows are read as float2 and the spectrum
//   written as double2;
// * the (segment, sub-length) loops are unrolled for the shipped 2 x 3
//   (template), with a generic instantiation for the rest, so the T row
//   gathers of a thread are independent loads in flight together;
// * the spectrum is written with streaming stores (__stcs), so it does not
//   push the tables out of L2;
// * the seed product and the escape mask are formed in registers (the same
//   values and rounding as the twin's f * fv, then where(escaped, 0, .));
// * the failure flags are one byte per ray, zeroed by the C entry and set
//   with an atomicOr on the byte's 32-bit word only where a bad value occurs
//   (never on a healthy call). They replace the [B, K] any(Iv < 0) and
//   any(Iv != Iv) passes of the failure codes.
//
// Compiled with -fmad=false: each f64 product and sum rounds on its own, as
// the twin's separate PyTorch operations do, so the log-gain equals the
// twin's bitwise. exp may differ from PyTorch's CUDA exp by an ulp.
//
// The f32 instantiation (rt_amplify_seeded_f32) is the TPU kernel's own
// arithmetic, raytrace_tpu's default spectrum: the log-gain is an
// unevaluated two-float pair (hi, lo) of f32 values, each term gvl * gv an
// error-free product added with Knuth's error-free two-sum,
//
//   p = gvl[b, t] * gv[seg(t)][ivl[b, t], k];  pe = fma(gvl, gv, -p)
//   hi, e = two_sum(hi, p);   lo = lo + (e + pe)
//   Iv[b, k] = f32(escaped[b] ? 0 : f[b] * fv[k]) * exp_fast2(hi, lo)
//
// with the seed product formed in f64 and rounded once, as raytrace_tpu
// rounds its f64 entry seed, and exp_fast2 the range-reduced polynomial exp
// of the pair (raytrace_tpu/ops/spectrum.py:70-88). Only f32 arithmetic
// past the seed product.
//
// The product's error is one fused multiply-add, __fmaf_rn(g, r, -p): the
// exact g r - p rounded once, which is the exact error itself wherever it
// is representable. The plain twin (raytrace_tpu_torch/ops/twofloat.py)
// forms it as raytrace_tpu does, by Dekker's product of factors split at a
// mask of 12 high significand bits; the two are bitwise equal wherever p is
// finite and |p| >= 2^-100, and where p is an exact zero
// (tests/test_torch_f32.py holds this, and lists the pairs near f32's
// underflow where they differ). On a traced seeded chunk of the main path
// the smallest nonzero |gvl * gv| is 1.4e-2 (chip_smoke.py's phase 3
// prints it), far inside that range, and phase 3 holds the kernel bitwise
// equal to the twin there. The explicit
// intrinsic is the kernel's only fused operation: the library stays
// compiled with -fmad=false, so the two-sum, the range reduction and the
// Horner polynomial round each operation on its own, as the twin does.
//
// What bounds it on an H100: issued f32 operations. Per element and term it
// does 11 (the product, its error as a fused multiply-add counted as two,
// the two-sum's 6 and the low part's 2); per element 35 for the exp, the
// seed product's rounding and mask, the product and the flags: 101 at a
// term count T of 6, 8.7e9 for a 2^20-ray chunk at K 82, 0.13 ms at 67
// TFLOP/s. Its bytes (4 a spectrum element, 8 T a ray for the cell ids and
// path gains) are about 0.40 GB, 0.12 ms at 3.35 TB/s.
//
// Design of the f32 instantiation:
// * a thread takes kUnitsF32 consecutive units of V frequencies (V = 2,
//   float2 rows, where K is even) of one ray, so the per-ray loads (cell
//   ids, path gains, seed factor, escape flag) and the row address of each
//   term serve 2 kUnitsF32 elements; at K 82 a ray is 14 threads (the
//   last with two units) and a block 18 rays;
// * the flags test one compare an element (!(Iv >= 0): negative or NaN)
//   and take the two bits apart only on a ray where it fired.

#include <cuda_runtime.h>
#include <stdint.h>

#include "twofloat.cuh"

namespace {

constexpr int kThreads = 256;

// NSEG, NSUB > 0: the loop bounds at compile time; 0: nseg, nsub at run time.
template <int NSEG, int NSUB, int V>
__global__ void __launch_bounds__(kThreads)
amplify_seeded_kernel(const double* __restrict__ f,
                      const double* __restrict__ fv,
                      const uint8_t* __restrict__ escaped,
                      const int32_t* __restrict__ ivl,
                      const float* __restrict__ gvl,
                      const float* __restrict__ gv, int64_t B, int nseg_rt,
                      int nsub_rt, int cells, int K, double* __restrict__ Iv,
                      uint8_t* __restrict__ flags,
                      double* __restrict__ log_gain) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  if (b >= B) return;
  const int k = (int)threadIdx.x * V;
  const int nseg = NSEG > 0 ? NSEG : nseg_rt;
  const int nsub = NSUB > 0 ? NSUB : nsub_rt;
  const int64_t T = (int64_t)nseg * nsub;
  const int32_t* ivl_b = ivl + b * T;
  const float* gvl_b = gvl + b * T;

  double acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.0;
#pragma unroll
  for (int s = 0; s < (NSEG > 0 ? NSEG : nseg); ++s) {
    const float* gv_s = gv + (int64_t)s * cells * K + k;
#pragma unroll
    for (int u = 0; u < (NSUB > 0 ? NSUB : nsub); ++u) {
      const int t = s * nsub + u;
      const float* row = gv_s + (int64_t)__ldg(ivl_b + t) * K;
      const double g = (double)__ldg(gvl_b + t);
      if constexpr (V == 2) {
        const float2 r = __ldg(reinterpret_cast<const float2*>(row));
        acc[0] = acc[0] + g * (double)r.x;
        acc[1] = acc[1] + g * (double)r.y;
      } else {
        acc[0] = acc[0] + g * (double)__ldg(row);
      }
    }
  }

  const bool esc = __ldg(escaped + b) != 0;
  const double fb = __ldg(f + b);
  double out[V];
  unsigned bits = 0;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const double iv0 = esc ? 0.0 : fb * __ldg(fv + k + v);
    out[v] = iv0 * exp(acc[v]);
    bits |= out[v] < 0.0 ? 1u : 0u;
    bits |= out[v] != out[v] ? 2u : 0u;
  }
  double* dst = Iv + b * K + k;
  if constexpr (V == 2) {
    __stcs(reinterpret_cast<double2*>(dst), make_double2(out[0], out[1]));
  } else {
    __stcs(dst, out[0]);
  }
  if (log_gain != nullptr) {
#pragma unroll
    for (int v = 0; v < V; ++v) log_gain[b * K + k + v] = acc[v];
  }
  if (bits != 0) {
    // the flag byte of ray b inside its aligned 32-bit word (little-endian)
    unsigned* word = reinterpret_cast<unsigned*>(flags + (b & ~(int64_t)3));
    atomicOr(word, bits << (8 * (unsigned)(b & 3)));
  }
}

// ---- the f32 instantiation: two-float arithmetic (csrc/twofloat.cuh) -----

// units of V frequencies a thread of the f32 kernel takes
constexpr int kUnitsF32 = 3;

// U units of V consecutive frequencies a thread (threadIdx.x), one ray a
// thread row (threadIdx.y); NSEG, NSUB as in amplify_seeded_kernel
template <int NSEG, int NSUB, int V, int U>
__global__ void __launch_bounds__(kThreads)
amplify_seeded_f32_kernel(const double* __restrict__ f,
                          const double* __restrict__ fv,
                          const uint8_t* __restrict__ escaped,
                          const int32_t* __restrict__ ivl,
                          const float* __restrict__ gvl,
                          const float* __restrict__ gv, int64_t B,
                          int nseg_rt, int nsub_rt, int cells, int K,
                          float* __restrict__ Iv, uint8_t* __restrict__ flags,
                          float* __restrict__ log_gain) {
  constexpr int E = U * V;  // elements a thread
  const int64_t b = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  if (b >= B) return;
  const int units = K / V;
  const int u0 = (int)threadIdx.x * U;
  const int nseg = NSEG > 0 ? NSEG : nseg_rt;
  const int nsub = NSUB > 0 ? NSUB : nsub_rt;
  const int64_t T = (int64_t)nseg * nsub;
  const int32_t* ivl_b = ivl + b * T;
  const float* gvl_b = gvl + b * T;
  bool live[U];  // the thread's units inside the spectrum
#pragma unroll
  for (int q = 0; q < U; ++q) live[q] = u0 + q < units;

  float hi[E], lo[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    hi[e] = 0.0f;
    lo[e] = 0.0f;
  }
#pragma unroll
  for (int s = 0; s < (NSEG > 0 ? NSEG : nseg); ++s) {
    const float* gv_s = gv + (int64_t)s * cells * K + u0 * V;
#pragma unroll
    for (int u = 0; u < (NSUB > 0 ? NSUB : nsub); ++u) {
      const int t = s * nsub + u;
      const float* row = gv_s + (int64_t)__ldg(ivl_b + t) * K;
      const float g = __ldg(gvl_b + t);
      float r[E];
#pragma unroll
      for (int q = 0; q < U; ++q) {
        if constexpr (V == 2) {
          float2 rr = make_float2(0.0f, 0.0f);
          if (live[q]) rr = __ldg(reinterpret_cast<const float2*>(row) + q);
          r[2 * q] = rr.x;
          r[2 * q + 1] = rr.y;
        } else {
          r[q] = live[q] ? __ldg(row + q) : 0.0f;
        }
      }
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float p = g * r[e];
        const float pe = __fmaf_rn(g, r[e], -p);
        float x;
        two_sum(hi[e], p, hi[e], x);
        lo[e] = lo[e] + (x + pe);
      }
    }
  }

  const bool esc = __ldg(escaped + b) != 0;
  const double fb = __ldg(f + b);
  const int k0 = u0 * V;
  float out[E];
  bool bad = false;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (!live[e / V]) continue;
    const float iv0 = esc ? 0.0f : (float)(fb * __ldg(fv + k0 + e));
    out[e] = iv0 * exp_fast2(hi[e], lo[e]);
    bad |= !(out[e] >= 0.0f);
  }
  float* dst = Iv + b * K + k0;
#pragma unroll
  for (int q = 0; q < U; ++q) {
    if (!live[q]) continue;
    if constexpr (V == 2) {
      __stcs(reinterpret_cast<float2*>(dst) + q,
             make_float2(out[2 * q], out[2 * q + 1]));
    } else {
      __stcs(dst + q, out[q]);
    }
  }
  if (log_gain != nullptr) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (!live[e / V]) continue;
      log_gain[b * K + k0 + e] = hi[e];
      log_gain[B * K + b * K + k0 + e] = lo[e];
    }
  }
  if (bad) {
    unsigned bits = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (!live[e / V]) continue;
      bits |= out[e] < 0.0f ? 1u : 0u;
      bits |= out[e] != out[e] ? 2u : 0u;
    }
    unsigned* word = reinterpret_cast<unsigned*>(flags + (b & ~(int64_t)3));
    atomicOr(word, bits << (8 * (unsigned)(b & 3)));
  }
}

template <int NSEG, int NSUB, int V>
void launch_f32(const double* f, const double* fv, const uint8_t* escaped,
                const int32_t* ivl, const float* gvl, const float* gv,
                int64_t B, int nseg, int nsub, int cells, int K, float* Iv,
                uint8_t* flags, float* log_gain, cudaStream_t stream) {
  const int per_ray = (K / V + kUnitsF32 - 1) / kUnitsF32;
  const dim3 threads(per_ray, kThreads / per_ray);
  const int64_t blocks = (B + threads.y - 1) / threads.y;
  amplify_seeded_f32_kernel<NSEG, NSUB, V, kUnitsF32>
      <<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
          f, fv, escaped, ivl, gvl, gv, B, nseg, nsub, cells, K, Iv, flags,
          log_gain);
}

template <int NSEG, int NSUB, int V>
void launch(const double* f, const double* fv, const uint8_t* escaped,
            const int32_t* ivl, const float* gvl, const float* gv, int64_t B,
            int nseg, int nsub, int cells, int K, double* Iv, uint8_t* flags,
            double* log_gain, cudaStream_t stream) {
  const dim3 threads(K / V, kThreads / (K / V));
  const int64_t blocks = (B + threads.y - 1) / threads.y;
  amplify_seeded_kernel<NSEG, NSUB, V>
      <<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
          f, fv, escaped, ivl, gvl, gv, B, nseg, nsub, cells, K, Iv, flags,
          log_gain);
}

}  // namespace

// C entry bound with ctypes by raytrace_tpu_torch/ops/amplify_kernel.py.
// Writes Iv [B, K], the flag bytes (`flags` holds B rounded up to a multiple
// of 4 bytes, 4-byte aligned) and, where `log_gain` is not null, the
// log-gain, on `stream`; does not synchronise; returns cudaGetLastError().
// `pairs` (K even, gv 8-byte aligned) selects the float2/double2 layout.
// K must be at most 256.
extern "C" int rt_amplify_seeded(const double* f, const double* fv,
                                 const uint8_t* escaped, const int32_t* ivl,
                                 const float* gvl, const float* gv, int64_t B,
                                 int nseg, int nsub, int cells, int K,
                                 int pairs, double* Iv, uint8_t* flags,
                                 double* log_gain, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(flags, 0, (size_t)((B + 3) & ~(int64_t)3), s);
  if (B > 0 && K > 0) {
    const bool shipped = nseg == 2 && nsub == 3;
    if (pairs && shipped) {
      launch<2, 3, 2>(f, fv, escaped, ivl, gvl, gv, B, nseg, nsub, cells, K,
                      Iv, flags, log_gain, s);
    } else if (pairs) {
      launch<0, 0, 2>(f, fv, escaped, ivl, gvl, gv, B, nseg, nsub, cells, K,
                      Iv, flags, log_gain, s);
    } else if (shipped) {
      launch<2, 3, 1>(f, fv, escaped, ivl, gvl, gv, B, nseg, nsub, cells, K,
                      Iv, flags, log_gain, s);
    } else {
      launch<0, 0, 1>(f, fv, escaped, ivl, gvl, gv, B, nseg, nsub, cells, K,
                      Iv, flags, log_gain, s);
    }
  }
  return (int)cudaGetLastError();
}

// The f32 instantiation's C entry: as rt_amplify_seeded, with Iv [B, K]
// f32 and, where `log_gain` is not null, the pair's hi and lo as [2, B, K]
// f32 (hi first). `pairs` (K even, gv 8-byte aligned) selects the float2
// layout. K must be at most 256.
extern "C" int rt_amplify_seeded_f32(const double* f, const double* fv,
                                     const uint8_t* escaped,
                                     const int32_t* ivl, const float* gvl,
                                     const float* gv, int64_t B, int nseg,
                                     int nsub, int cells, int K, int pairs,
                                     float* Iv, uint8_t* flags,
                                     float* log_gain, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(flags, 0, (size_t)((B + 3) & ~(int64_t)3), s);
  if (B > 0 && K > 0) {
    const bool shipped = nseg == 2 && nsub == 3;
    if (pairs && shipped) {
      launch_f32<2, 3, 2>(f, fv, escaped, ivl, gvl, gv, B, nseg, nsub, cells,
                          K, Iv, flags, log_gain, s);
    } else if (pairs) {
      launch_f32<0, 0, 2>(f, fv, escaped, ivl, gvl, gv, B, nseg, nsub, cells,
                          K, Iv, flags, log_gain, s);
    } else if (shipped) {
      launch_f32<2, 3, 1>(f, fv, escaped, ivl, gvl, gv, B, nseg, nsub, cells,
                          K, Iv, flags, log_gain, s);
    } else {
      launch_f32<0, 0, 1>(f, fv, escaped, ivl, gvl, gv, B, nseg, nsub, cells,
                          K, Iv, flags, log_gain, s);
    }
  }
  return (int)cudaGetLastError();
}
