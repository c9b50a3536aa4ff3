// Binning deposit kernel (B2): for one chunk of rays, each ray's image and
// angle bins and its deposit into the call's f64 accumulators, in one pass,
//
//   i1..i4 = getIndex(x, y, a, b) on the beam grids (-1 outside)
//   image[i1 + i2 nx, k] += Iv[b, k] * scale           (ok, i1, i2 >= 0)
//   I_ang[i3 + i4 na]    += sum_k Iv[b, k] * (2 dv[k])  (ok, i3, i4 >= 0)
//
// where a ray bins at its entry coordinates (method 1) or at its exit
// coordinates with both angles negated and, on a half-plane beam, y mirrored
// (method 2). A ray that is not ok (failed, or outside the stride list) or
// lands outside the grid is never read into a sum: failed rays carry NaN or
// negative spectra.
//
// Replaces the Pallas TPU kernel raytrace_tpu/ops/deposit_kernel.py
// (_deposit_kernel, launched by deposit_tiles) together with what surrounds
// it in raytrace_tpu/ops/binning.py (bin_images): the bin indices, Iv * scale
// and the I_ang product. On a TPU the deposit is a bf16x3 one-hot matmul on
// the MXU, with the one-hot kept in VMEM, because per-element scatter is slow
// there. Hopper has native f64 atomicAdd (also what the reference's GPU
// backend uses, atomicAdd2, src/RayTraceImageCuda.cu:37-48); what costs is
// the number of atomics and the passes over the spectra.
//
// What bounds it on an H100: device-memory bytes. The spectra of the
// deposited rays are read once (8 K bytes a ray), the coordinates and the ok
// byte once (17 bytes a ray), the accumulators read and written once. For a
// 2^20-ray seeded chunk at K 82 that is about 0.7 GB, 0.21 ms at 3.35 TB/s.
// The atomics go to L2; where many consecutive rays share a bin (ASE rays
// bin at their entry cell, 266 consecutive rays to one cell) one atomic per
// ray would serialise on the same addresses.
//
// Design:
// * a warp per tile of warpSize consecutive rays; lane j computes the bins
//   of ray t0 + j (four lower-bound searches on the f64 grids through
//   __ldg, in the plain twin's f64 order, so the bins equal get_index's
//   bitwise) and the warp then walks the tile's rays in order, taking each
//   ray's bins by __shfl_sync;
// * the lanes read a ray's spectrum over k, coalesced (pairs as double2
//   where K is even), a few rays' rows in flight at once, and keep one
//   running image sum per lane: an atomicAdd is issued only where the image
//   bin changes and at the tile's end, so a run of equal bins costs one
//   atomic per frequency;
// * the same loads give I_ang: each lane's products with 2 dv, summed over
//   the warp by __shfl_xor_sync, kept by the lane of that ray, which adds
//   its ray's total into I_ang with one atomic;
// * a spectrum wider than the warp is walked in slots of warpSize frequency
//   units, one pass over the tile's rays per slot (the seeded K 82: two);
// * no shared memory and no barrier, so a one-lane warp (the host test's
//   shim) runs the same code.
//
// Under atomics the summation order changes from run to run, so results
// differ between runs at about 1e-15 relative. Compiled with -fmad=false.
//
// The f32 instantiation (rt_bin_deposit_f32) deposits f32 spectra, the
// contribution raytrace_tpu's default spectrum gives its kernel
// (raytrace_tpu/ops/binning.py:129-154): each product Iv * f32(scale) and
// Iv * f32(2 dv) is formed in f32, as there, and then added in f64 into the
// same f64 accumulators (the TPU's per-chunk f32 partial sums are an
// artefact of its MXU; the port keeps the reference's f64 accumulation).
// The spectra read halves: for the seeded 2^20-ray chunk about 0.36 GB,
// 0.11 ms at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
// rays of a tile whose rows are loaded before any of them is added
constexpr int kBatch = 4;

struct Axis {
  const double* g;  // [n] f64 grid
  int n;
  double d;         // spacing
};

struct DepositArgs {
  const float* cx;
  const float* cy;
  const float* ca;
  const float* cb;
  const uint8_t* ok;
  const void* Iv;    // [B, K] of the instantiation's type
  int64_t B;
  int K;
  Axis x, y, a, b;
  const double* dv;  // [K]
  double scale;
  int mirror_y;      // method 2 on a half-plane beam: y -> |y|
  int negate_ab;     // method 2: a, b -> -a, -b
  double* image;     // [nx * ny, K]
  double* iang;      // [na * nb]
  int32_t* bins;     // [B, 2] or null
};

// getIndex (RayTraceImageCPU.cpp:11-16) as the twin computes it
// (binning.get_index): -1 outside the half-cell-padded extent, else
// findfirstsingle(grid, y - d/2): 0 below the grid, n above it, otherwise the
// first i with grid[i] >= t (searchsorted's lower bound, n for NaN) clamped
// to [1, n-1] as torch.clamp does.
__device__ __forceinline__ int64_t get_index(const Axis& ax, float yf) {
  const double y = (double)yf;
  const double half = 0.5 * ax.d;
  const double t = y - half;
  const double g0 = __ldg(ax.g);
  const double gn = __ldg(ax.g + ax.n - 1);
  if (y < g0 - half || y > gn + half) return -1;
  if (t < g0) return 0;
  if (t > gn) return ax.n;
  int lo = 0, hi = ax.n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(__ldg(ax.g + mid) >= t)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int c = lo > 1 ? lo : 1;
  return c < ax.n - 1 ? c : ax.n - 1;
}

// the image and angle bins of ray b, -1 where it deposits nothing there
__device__ __forceinline__ void ray_bins(const DepositArgs& A, int64_t b,
                                        int& img, int& ang) {
  img = -1;
  ang = -1;
  if (b >= A.B || __ldg(A.ok + b) == 0) return;
  const float x = __ldg(A.cx + b);
  float y = __ldg(A.cy + b);
  float a = __ldg(A.ca + b);
  float bb = __ldg(A.cb + b);
  if (A.mirror_y && y < 0.0f) y = -y;
  if (A.negate_ab) {
    a = -a;
    bb = -bb;
  }
  const int64_t i1 = get_index(A.x, x), i2 = get_index(A.y, y);
  const int64_t i3 = get_index(A.a, a), i4 = get_index(A.b, bb);
  if (i1 >= 0 && i2 >= 0) {
    const int64_t c = i1 + i2 * A.x.n;
    if (c < (int64_t)A.x.n * A.y.n) img = (int)c;
  }
  if (i3 >= 0 && i4 >= 0) {
    const int64_t c = i3 + i4 * A.a.n;
    if (c < (int64_t)A.a.n * A.b.n) ang = (int)c;
  }
}

// the pair type of a spectrum element type
template <typename T> struct Pair;
template <> struct Pair<double> { using type = double2; };
template <> struct Pair<float> { using type = float2; };

// T: the spectra's element type (products with scale and 2 dv in T, sums in
// f64); V: frequencies per lane and load (2: pairs, K even)
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bin_deposit_kernel(DepositArgs A) {
  using T2 = typename Pair<T>::type;
  const T* Iv = static_cast<const T*>(A.Iv);
  const T scale = (T)A.scale;
  const unsigned lane = threadIdx.x % warpSize;
  const int64_t t0 = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x - lane);
  if (t0 >= A.B) return;  // the whole warp
  int img, ang;
  ray_bins(A, t0 + lane, img, ang);
  if (A.bins != nullptr && t0 + lane < A.B) {
    A.bins[2 * (t0 + lane)] = img;
    A.bins[2 * (t0 + lane) + 1] = ang;
  }
  const int64_t left = A.B - t0;
  const int n = left < (int64_t)warpSize ? (int)left : (int)warpSize;
  const int K = A.K;
  const int units = K / V;
  double my_ang = 0.0;  // the I_ang total of this lane's ray

  for (int s0 = 0; s0 < units; s0 += warpSize) {
    const int p = s0 + (int)lane;
    const bool active = p < units;
    const int k = p * V;
    T w[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      w[j] = active ? (T)(2.0 * __ldg(A.dv + k + j)) : (T)0;
    }
    int cur = -1;  // the image bin of the running sum
    double run[V];
#pragma unroll
    for (int j = 0; j < V; ++j) run[j] = 0.0;

    for (int r0 = 0; r0 < n; r0 += kBatch) {
      int ci[kBatch], ca[kBatch];
      T v[kBatch][V];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int r = r0 + q;
        const int si = __shfl_sync(kFull, img, r % warpSize);
        const int sa = __shfl_sync(kFull, ang, r % warpSize);
        ci[q] = r < n ? si : -1;
        ca[q] = r < n ? sa : -1;
        const T* row = Iv + (t0 + r) * K + k;
        const bool load = active && (ci[q] >= 0 || ca[q] >= 0);
        if constexpr (V == 2) {
          T2 e;
          e.x = (T)0;
          e.y = (T)0;
          if (load) e = __ldg(reinterpret_cast<const T2*>(row));
          v[q][0] = e.x;
          v[q][1] = e.y;
        } else {
          v[q][0] = load ? __ldg(row) : (T)0;
        }
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        if (ci[q] >= 0) {
          if (ci[q] != cur) {
            if (cur >= 0 && active) {
              double* dst = A.image + (int64_t)cur * K + k;
#pragma unroll
              for (int j = 0; j < V; ++j) atomicAdd(dst + j, run[j]);
            }
            cur = ci[q];
#pragma unroll
            for (int j = 0; j < V; ++j) run[j] = 0.0;
          }
#pragma unroll
          for (int j = 0; j < V; ++j) {
            run[j] = run[j] + (double)(v[q][j] * scale);
          }
        }
        if (ca[q] >= 0) {
          double part = 0.0;
#pragma unroll
          for (int j = 0; j < V; ++j) part = part + (double)(v[q][j] * w[j]);
          for (int o = warpSize / 2; o > 0; o /= 2) {
            part = part + __shfl_xor_sync(kFull, part, o);
          }
          if ((int)lane == r0 + q) my_ang = my_ang + part;
        }
      }
    }
    if (cur >= 0 && active) {
      double* dst = A.image + (int64_t)cur * K + k;
#pragma unroll
      for (int j = 0; j < V; ++j) atomicAdd(dst + j, run[j]);
    }
  }
  if (ang >= 0) atomicAdd(A.iang + ang, my_ang);
}

template <typename T>
int bin_deposit(const float* cx, const float* cy, const float* ca,
                const float* cb, const uint8_t* ok, const T* Iv, int64_t B,
                int K, int pairs, const double* gx, int nx, double dx,
                const double* gy, int ny, double dy, const double* ga, int na,
                double da, const double* gb, int nb, double db,
                const double* dv, double scale, int mirror_y, int negate_ab,
                double* image, double* iang, int32_t* bins, void* stream) {
  const DepositArgs A{cx, cy, ca, cb, ok, Iv, B, K,
                      Axis{gx, nx, dx}, Axis{gy, ny, dy}, Axis{ga, na, da},
                      Axis{gb, nb, db}, dv, scale, mirror_y, negate_ab,
                      image, iang, bins};
  const int64_t blocks = (B + kThreads - 1) / kThreads;
  if (blocks > 0) {
    if (pairs) {
      bin_deposit_kernel<T, 2><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(A);
    } else {
      bin_deposit_kernel<T, 1><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(A);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C entry bound with ctypes by raytrace_tpu_torch/ops/deposit_kernel.py.
// Coordinates cx..cb [B] f32 and ok [B] bytes; Iv [B, K] f64 (16-byte
// aligned with K even where `pairs`); the beam grids g* [n*] f64 with their
// spacings; dv [K] f64. Adds into image [nx*ny, K] and iang [na*nb] in place
// and, where `bins` is not null, writes each ray's image and angle bin
// ([B, 2] i32, -1 for none). Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() of the launch.
extern "C" int rt_bin_deposit(const float* cx, const float* cy,
                              const float* ca, const float* cb,
                              const uint8_t* ok, const double* Iv, int64_t B,
                              int K, int pairs, const double* gx, int nx,
                              double dx, const double* gy, int ny, double dy,
                              const double* ga, int na, double da,
                              const double* gb, int nb, double db,
                              const double* dv, double scale, int mirror_y,
                              int negate_ab, double* image, double* iang,
                              int32_t* bins, void* stream) {
  return bin_deposit<double>(cx, cy, ca, cb, ok, Iv, B, K, pairs, gx, nx, dx,
                             gy, ny, dy, ga, na, da, gb, nb, db, dv, scale,
                             mirror_y, negate_ab, image, iang, bins, stream);
}

// The f32 instantiation's C entry: as rt_bin_deposit with Iv [B, K] f32
// (8-byte aligned with K even where `pairs`).
extern "C" int rt_bin_deposit_f32(const float* cx, const float* cy,
                                  const float* ca, const float* cb,
                                  const uint8_t* ok, const float* Iv,
                                  int64_t B, int K, int pairs,
                                  const double* gx, int nx, double dx,
                                  const double* gy, int ny, double dy,
                                  const double* ga, int na, double da,
                                  const double* gb, int nb, double db,
                                  const double* dv, double scale,
                                  int mirror_y, int negate_ab, double* image,
                                  double* iang, int32_t* bins, void* stream) {
  return bin_deposit<float>(cx, cy, ca, cb, ok, Iv, B, K, pairs, gx, nx, dx,
                            gy, ny, dy, ga, na, da, gb, nb, db, dv, scale,
                            mirror_y, negate_ab, image, iang, bins, stream);
}
