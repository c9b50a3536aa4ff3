// Emissivity amplify kernel (B4): the ASE path's f64 amplification of each
// ray's spectrum along its recorded path, with gain and emissivity, from a
// zero entry spectrum, with the failure flags fused in,
//
//   Iv = 0
//   for each (segment i, sub-length s), segments outer:
//     g  = gv[i][ivl[b, i, s], k]
//     el = evl[b, i, s] g;   gl = gvl[b, i, s] g
//     Iv = el (1 + (gl / 2)(1 + 0.3333333333 gl)) + Iv (1 + gl (1 + gl / 2))
//                                                  where |gl| < 1e-3
//     Iv = el / gl (e^gl - 1) + Iv e^gl            elsewhere
//   flags[b] = bit 0 if any Iv[b, :] < 0, bit 1 if any Iv[b, :] is NaN
//
// in f64, the closed-form integration of dI/dz = j + g I of the reference
// (RayTraceImageHelper.h:534-567). The products el and gl of two f32 values
// are exact in f64.
//
// It replaces no Pallas kernel: raytrace_tpu computes this step in XLA
// (raytrace_tpu/ops/spectrum.py:156-183). The port ran it as a chain of
// PyTorch elementwise kernels over [B, K] f64 tensors, about two dozen a
// (segment, sub-length) step, then two [B, K] passes for the flags; that
// chain is the kernel's plain twin (raytrace_tpu_torch/ops/amplify_kernel.py,
// amplify_emis_plain), and the kernel keeps the twin's order of rounding
// operation by operation. The f32 spectrum has a kernel of its own, B4-f32
// (rt_amplify_emis_f32, below), which shares no code with this one.
//
// Compiled with -fmad=false: each f64 product and sum rounds on its own, as
// the twin's separate PyTorch operations do. exp may differ from PyTorch's
// by an ulp. The kernel takes the Taylor branch or the closed form per
// element where the twin computes both and selects: the same value.
//
// What bounds it on an H100: f64 issue. Per ray, frequency and (segment,
// sub-length) step it does one f64 exp (about 20 f64 instructions), one
// IEEE f64 division (a reciprocal and its Newton steps, about 8) and about
// 8 more products and sums, and converts the table's f32 value to f64; for
// the whole ASE call (399,000 rays, K 52, 6 steps) that is 124.5 M
// element-steps, about 0.25-0.35 ms at the card's f64 rate. Its bytes are
// the 8-byte spectrum written once (166 MB on that call) and 12 bytes a ray
// and step read once (28.7 MB): about 0.058 ms at 3.35 TB/s.
//
// Design:
// * a block covers a tile of rays (threadIdx.y) with one thread per V
//   consecutive frequencies (threadIdx.x), as B3 (csrc/amplify.cu); V = 2
//   where K is even, so the rows are read as float2 and the spectrum
//   written as double2; a thread walks its frequencies in strides of the
//   block's width, so any K runs;
// * the (segment, sub-length) loops are unrolled for the shipped 2 x 3
//   (template), with a generic instantiation for the rest: the row
//   gathers, exps and divisions of a thread's steps do not depend on the
//   spectrum, so they are in flight together; only the recurrence in Iv
//   is serial;
// * the spectrum is written with streaming stores (__stcs), so it does not
//   push the f32 tables (1.15 MB on the ASE call) out of L2;
// * the entry spectrum is the constant 0, never stored or read;
// * the failure flags are one byte per ray, zeroed by the C entry and set
//   with an atomicOr on the byte's 32-bit word only where a bad value occurs
//   (never on a healthy call), as B3's.
//
// The kernel allocates nothing and does not synchronise, so a CUDA graph of
// the call captures it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "twofloat.cuh"

namespace {

constexpr int kThreads = 256;
// the Taylor branch's bound on |gl| and its third, as the twin's f64
// constants
constexpr double kSmall = 1e-3;
constexpr double kThird = 0.3333333333;

// one (segment, sub-length) step of the spectrum Iv at one frequency: g the
// table's value, ev and gg the step's path emissivity and gain
__device__ __forceinline__ double emis_step(double iv, double ev, double gg,
                                            double g) {
  const double el = ev * g;
  const double gl = gg * g;
  if (fabs(gl) < kSmall) {
    return el * (1.0 + (0.5 * gl) * (1.0 + kThird * gl))
           + iv * (1.0 + gl * (1.0 + 0.5 * gl));
  }
  const double e = exp(gl);
  return el / gl * (e - 1.0) + iv * e;
}

// NSEG, NSUB > 0: the loop bounds at compile time; 0: nseg, nsub at run time.
template <int NSEG, int NSUB, int V>
__global__ void __launch_bounds__(kThreads)
amplify_emis_kernel(const int32_t* __restrict__ ivl,
                    const float* __restrict__ gvl,
                    const float* __restrict__ evl,
                    const float* __restrict__ gv, int64_t B, int nseg_rt,
                    int nsub_rt, int cells, int K, double* __restrict__ Iv,
                    uint8_t* __restrict__ flags) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  if (b >= B) return;
  const int nseg = NSEG > 0 ? NSEG : nseg_rt;
  const int nsub = NSUB > 0 ? NSUB : nsub_rt;
  const int64_t T = (int64_t)nseg * nsub;
  const int32_t* ivl_b = ivl + b * T;
  const float* gvl_b = gvl + b * T;
  const float* evl_b = evl + b * T;

  unsigned bits = 0;
  for (int k = (int)threadIdx.x * V; k < K; k += (int)blockDim.x * V) {
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
        const double ev = (double)__ldg(evl_b + t);
        const double gg = (double)__ldg(gvl_b + t);
        if constexpr (V == 2) {
          const float2 r = __ldg(reinterpret_cast<const float2*>(row));
          acc[0] = emis_step(acc[0], ev, gg, (double)r.x);
          acc[1] = emis_step(acc[1], ev, gg, (double)r.y);
        } else {
          acc[0] = emis_step(acc[0], ev, gg, (double)__ldg(row));
        }
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      bits |= acc[v] < 0.0 ? 1u : 0u;
      bits |= acc[v] != acc[v] ? 2u : 0u;
    }
    double* dst = Iv + b * K + k;
    if constexpr (V == 2) {
      __stcs(reinterpret_cast<double2*>(dst), make_double2(acc[0], acc[1]));
    } else {
      __stcs(dst, acc[0]);
    }
  }
  if (bits != 0) {
    // the flag byte of ray b inside its aligned 32-bit word (little-endian)
    unsigned* word = reinterpret_cast<unsigned*>(flags + (b & ~(int64_t)3));
    atomicOr(word, bits << (8 * (unsigned)(b & 3)));
  }
}

template <int NSEG, int NSUB, int V>
void launch(const int32_t* ivl, const float* gvl, const float* evl,
            const float* gv, int64_t B, int nseg, int nsub, int cells, int K,
            double* Iv, uint8_t* flags, cudaStream_t stream) {
  const int units = K / V;
  const int per_ray = units < kThreads ? units : kThreads;
  const dim3 threads(per_ray, kThreads / per_ray);
  const int64_t blocks = (B + threads.y - 1) / threads.y;
  amplify_emis_kernel<NSEG, NSUB, V>
      <<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
          ivl, gvl, evl, gv, B, nseg, nsub, cells, K, Iv, flags);
}

// ---- B4-f32: the f32 spectrum's emissivity amplify ------------------------
//
// Kernel B4-f32 (rt_amplify_emis_f32): the same amplify and flags with the
// spectrum in f32, raytrace_tpu's default (raytrace_tpu/ops/spectrum.py:
// 160-179), in the twin's f32 arithmetic (raytrace_tpu_torch/ops/
// spectrum.py, _amplify_f32, with ops/twofloat.py), per ray, frequency and
// step, segments outer:
//
//   el = evl g;   (gl, lo) = the two-float product of gvl and g
//   Iv = el (1 + (gl / 2)(1 + c gl)) + Iv (1 + gl (1 + gl / 2))
//                        where |gl| < f32(1e-3), with c = f32(0.3333333333)
//   Iv = el / gl * expm1_from_exp(e, gl, lo) + Iv e,  e = exp_fast2(gl, lo)
//                                                  elsewhere
//
// with exp_fast2 and expm1_from_exp the range-reduced polynomial exp of the
// pair and its expm1 (csrc/twofloat.cuh, shared with B3-f32). Every
// operation is a deterministic f32 operation (IEEE products, sums and
// quotient, rintf half to even, 2^n from its bits), so the kernel is
// bitwise equal to the twin (amplify_emis_plain with dtype float32),
// spectrum and flags; the flags are taken on the f32 spectrum.
//
// The product's error lo is one fused multiply-add, __fmaf_rn(gvl, g, -gl):
// the exact gvl g - gl rounded once, which is the exact error, and equal to
// Dekker's split product of the twin, wherever gl is finite and |gl| >=
// 2^-100 (csrc/amplify.cu). The twin reads the pair only where |gl| >=
// 1e-3: where |gl| < 1e-3 it zeroes the pair and takes the Taylor branch.
// So every element that uses the error gets Dekker's value bitwise; a gl
// of inf or NaN gives NaN whatever the error.
//
// The twin computes both branches and both forms of expm1 and selects; the
// kernel branches per element (the Taylor branch where |gl| < 1e-3, the
// polynomial or e - 1 by |gl| <= ln2 / 2): the same values. It keeps
// Iv e while Iv is the entry 0, so that an e of inf (a log-gain past f32's
// range) gives NaN, as the twin does.
//
// What bounds it on an H100: f32 issue. Per element-step the closed form
// is about 64 f32 operations (the products 2, the error 1, exp_fast2 28,
// the polynomial expm1 19, the IEEE quotient about 10, the closed form 3)
// and about 10 compares, selects and integer steps; for the whole ASE call
// (399,000 rays, K 52, 6 steps, 124.5 M element-steps) about 0.28 ms at
// 33.5 T lane-instructions a second. Its bytes are the 4-byte spectrum
// written once (83 MB on that call) and 12 bytes a ray and step read once.
//
// Design: B4's layout (a tile of rays a block, float2 rows and spectrum
// where K is even, the 2 x 3 steps unrolled with a generic instantiation,
// streaming stores, flag words set by atomicOr only where a bad value
// occurs), with kUnitsEmisF32 units of V frequencies a thread; any K. Two
// units a thread (13 threads a ray at K 52) ran the ASE call in 0.388 ms
// where one took 0.412, three 0.435 and four 0.479 (H100 80GB HBM3, 700 W).

// the Taylor branch's bound on |gl| and its third, rounded to f32 as the
// twin's _SMALL_F32 and _THIRD_F32
constexpr float kSmallF32 = 0x1.0624dep-10f;
constexpr float kThirdF32 = 0x1.555556p-2f;
// units of V frequencies a thread of the f32 kernel takes
constexpr int kUnitsEmisF32 = 2;

// one (segment, sub-length) step of the f32 spectrum Iv at one frequency:
// g the table's value, ev and gg the step's path emissivity and gain
__device__ __forceinline__ float emis_step_f32(float iv, float ev, float gg,
                                               float g) {
  const float el = ev * g;
  const float gl = gg * g;
  if (fabsf(gl) < kSmallF32) {
    return el * (1.0f + (0.5f * gl) * (1.0f + kThirdF32 * gl))
           + iv * (1.0f + gl * (1.0f + 0.5f * gl));
  }
  const float lo = __fmaf_rn(gg, g, -gl);
  const float e = exp_fast2(gl, lo);
  return el / gl * expm1_from_exp(e, gl, lo) + iv * e;
}

// U units of V consecutive frequencies a thread (threadIdx.x), strided by
// the block's width; one ray a thread row (threadIdx.y); NSEG, NSUB as in
// amplify_emis_kernel
template <int NSEG, int NSUB, int V, int U>
__global__ void __launch_bounds__(kThreads)
amplify_emis_f32_kernel(const int32_t* __restrict__ ivl,
                        const float* __restrict__ gvl,
                        const float* __restrict__ evl,
                        const float* __restrict__ gv, int64_t B, int nseg_rt,
                        int nsub_rt, int cells, int K, float* __restrict__ Iv,
                        uint8_t* __restrict__ flags) {
  constexpr int E = U * V;  // elements a thread
  const int64_t b = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  if (b >= B) return;
  const int units = K / V;
  const int nseg = NSEG > 0 ? NSEG : nseg_rt;
  const int nsub = NSUB > 0 ? NSUB : nsub_rt;
  const int64_t T = (int64_t)nseg * nsub;
  const int32_t* ivl_b = ivl + b * T;
  const float* gvl_b = gvl + b * T;
  const float* evl_b = evl + b * T;

  unsigned bits = 0;
  for (int u0 = (int)threadIdx.x * U; u0 < units; u0 += (int)blockDim.x * U) {
    bool live[U];  // the thread's units inside the spectrum
#pragma unroll
    for (int q = 0; q < U; ++q) live[q] = u0 + q < units;
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.0f;
#pragma unroll
    for (int s = 0; s < (NSEG > 0 ? NSEG : nseg); ++s) {
      const float* gv_s = gv + (int64_t)s * cells * K + u0 * V;
#pragma unroll
      for (int u = 0; u < (NSUB > 0 ? NSUB : nsub); ++u) {
        const int t = s * nsub + u;
        const float* row = gv_s + (int64_t)__ldg(ivl_b + t) * K;
        const float ev = __ldg(evl_b + t);
        const float gg = __ldg(gvl_b + t);
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
          acc[e] = emis_step_f32(acc[e], ev, gg, r[e]);
        }
      }
    }
    float* dst = Iv + b * K + u0 * V;
#pragma unroll
    for (int q = 0; q < U; ++q) {
      if (!live[q]) continue;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        bits |= acc[q * V + v] < 0.0f ? 1u : 0u;
        bits |= acc[q * V + v] != acc[q * V + v] ? 2u : 0u;
      }
      if constexpr (V == 2) {
        __stcs(reinterpret_cast<float2*>(dst) + q,
               make_float2(acc[2 * q], acc[2 * q + 1]));
      } else {
        __stcs(dst + q, acc[q]);
      }
    }
  }
  if (bits != 0) {
    // the flag byte of ray b inside its aligned 32-bit word (little-endian)
    unsigned* word = reinterpret_cast<unsigned*>(flags + (b & ~(int64_t)3));
    atomicOr(word, bits << (8 * (unsigned)(b & 3)));
  }
}

template <int NSEG, int NSUB, int V>
void launch_f32(const int32_t* ivl, const float* gvl, const float* evl,
                const float* gv, int64_t B, int nseg, int nsub, int cells,
                int K, float* Iv, uint8_t* flags, cudaStream_t stream) {
  const int threads_per_ray = (K / V + kUnitsEmisF32 - 1) / kUnitsEmisF32;
  const int per_ray = threads_per_ray < kThreads ? threads_per_ray : kThreads;
  const dim3 threads(per_ray, kThreads / per_ray);
  const int64_t blocks = (B + threads.y - 1) / threads.y;
  amplify_emis_f32_kernel<NSEG, NSUB, V, kUnitsEmisF32>
      <<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
          ivl, gvl, evl, gv, B, nseg, nsub, cells, K, Iv, flags);
}

}  // namespace

// C entry bound with ctypes by raytrace_tpu_torch/ops/amplify_kernel.py.
// Writes Iv [B, K] f64 and the flag bytes (`flags` holds B rounded up to a
// multiple of 4 bytes, 4-byte aligned) on `stream`; does not synchronise;
// returns cudaGetLastError(). `pairs` (K even, gv 8-byte aligned) selects
// the float2/double2 layout. Any K.
extern "C" int rt_amplify_emis(const int32_t* ivl, const float* gvl,
                               const float* evl, const float* gv, int64_t B,
                               int nseg, int nsub, int cells, int K,
                               int pairs, double* Iv, uint8_t* flags,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(flags, 0, (size_t)((B + 3) & ~(int64_t)3), s);
  if (B > 0 && K > 0) {
    const bool shipped = nseg == 2 && nsub == 3;
    if (pairs && shipped) {
      launch<2, 3, 2>(ivl, gvl, evl, gv, B, nseg, nsub, cells, K, Iv, flags,
                      s);
    } else if (pairs) {
      launch<0, 0, 2>(ivl, gvl, evl, gv, B, nseg, nsub, cells, K, Iv, flags,
                      s);
    } else if (shipped) {
      launch<2, 3, 1>(ivl, gvl, evl, gv, B, nseg, nsub, cells, K, Iv, flags,
                      s);
    } else {
      launch<0, 0, 1>(ivl, gvl, evl, gv, B, nseg, nsub, cells, K, Iv, flags,
                      s);
    }
  }
  return (int)cudaGetLastError();
}

// B4-f32's C entry: as rt_amplify_emis, with Iv [B, K] f32. `pairs` (K
// even, gv 8-byte aligned) selects the float2 layout. Any K.
extern "C" int rt_amplify_emis_f32(const int32_t* ivl, const float* gvl,
                                   const float* evl, const float* gv,
                                   int64_t B, int nseg, int nsub, int cells,
                                   int K, int pairs, float* Iv,
                                   uint8_t* flags, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(flags, 0, (size_t)((B + 3) & ~(int64_t)3), s);
  if (B > 0 && K > 0) {
    const bool shipped = nseg == 2 && nsub == 3;
    if (pairs && shipped) {
      launch_f32<2, 3, 2>(ivl, gvl, evl, gv, B, nseg, nsub, cells, K, Iv,
                          flags, s);
    } else if (pairs) {
      launch_f32<0, 0, 2>(ivl, gvl, evl, gv, B, nseg, nsub, cells, K, Iv,
                          flags, s);
    } else if (shipped) {
      launch_f32<2, 3, 1>(ivl, gvl, evl, gv, B, nseg, nsub, cells, K, Iv,
                          flags, s);
    } else {
      launch_f32<0, 0, 1>(ivl, gvl, evl, gv, B, nseg, nsub, cells, K, Iv,
                          flags, s);
    }
  }
  return (int)cudaGetLastError();
}
