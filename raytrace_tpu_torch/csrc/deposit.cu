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
// The f32 kernel (rt_bin_deposit_f32) deposits f32 spectra, the
// contribution raytrace_tpu's default spectrum gives its kernel
// (raytrace_tpu/ops/binning.py:129-154): each product Iv * f32(scale) and
// Iv * f32(2 dv) is formed in f32, as there, and then added in f64 into the
// same f64 accumulators (the TPU's per-chunk f32 partial sums are an
// artefact of its MXU; the port keeps the reference's f64 accumulation).
// The spectra read halves: for the seeded 2^20-ray chunk about 0.36 GB,
// 0.11 ms at 3.35 TB/s. Its image atomics cost no measurable time (the f64
// walk above with its image atomics turned into plain stores ran as fast),
// while its per-ray I_ang butterflies and the second, 9-lane slot at K 82
// did; so it has a design of its own (bin_deposit_f32_kernel):
// * a block per tile of kTileRays consecutive rays: the tile's spectra,
//   one contiguous [n, K] f32 span of Iv, are staged in shared memory by
//   16-byte cp.async copies from the span's first 16-byte boundary on, the
//   ragged head and tail as single floats (a chunk's Iv may be a view at
//   any 4-byte offset: the staged copy keeps the source's 16-byte phase);
//   many small blocks resident at once hide each other's latency;
// * while the copies fly, a thread per ray takes its bins (ray_bins, as
//   above) and writes its key (image bin, ray in the tile);
// * then the block's first warp sums I_ang, a thread per ray (its staged
//   row's products with f32(2 dv) over k in f64, one atomic a ray; no warp
//   butterfly: a row's walk starts at the lane's offset where K is even,
//   so the 32 lanes' reads fall in distinct banks), while its second warp
//   walks the image: the tile's keys in order, one frequency a lane and
//   slot (one pass over K: three slots at K 82, no 9-lane second slot), one
//   f64 atomicAdd per (bin, k) where the bin changes and at the tile's
//   end: one atomic per run of equal bins, as above. On an H100 the two
//   warps in parallel took 11% less time than one warp doing both, and
//   merging equal bins across the tile (its keys sorted by a bitonic
//   network first) saved 2.5% of a seeded chunk's atomics and cost 6% of
//   the time (raytrace_tpu_torch/tools/f32_ab.py: tile32x32, sorted);
// * every loop over a tile is strided by blockDim.x, with barriers between
//   the phases, so a one-thread block runs the whole tile (the host test's
//   shim runs a block that shares memory as one thread).

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

// ---- the f32 kernel: a block per tile, staged in shared memory ----------

// rays of a tile (a power of two; fewer where K is wide) and threads of a
// block: a warp for I_ang, a warp for the image
constexpr int kTileRays = 32;
constexpr int kTileThreads = 64;
// a block's shared memory at most
constexpr int kBlockBytes = 96 * 1024;
// rays whose rows a warp loads before it adds any of them
constexpr int kWalkBatch = 4;
constexpr unsigned long long kNoBin = ~0ull;

// one 16-byte copy from device to shared memory without registers
// (cp.async); both addresses 16-byte aligned
__device__ __forceinline__ void stage16(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
#else
  for (int i = 0; i < 4; ++i) dst[i] = src[i];
#endif
}

// wait for this thread's stage16 copies
__device__ __forceinline__ void stage_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

__host__ __device__ __forceinline__ int64_t align16(int64_t n) {
  return (n + 15) & ~(int64_t)15;
}

// a block's shared memory for a tile of R rays at K: the keys [R] u64
// (image bin, ray), the I_ang bins [R] i32, the weights f32(2 dv) [K], the staged rows
// [R K] f32 after up to 3 floats of phase; each part 16-byte aligned
__host__ __device__ __forceinline__ int64_t block_bytes(int R, int K) {
  return align16(8 * (int64_t)R) + align16(4 * (int64_t)R)
         + align16(4 * (int64_t)K) + 4 * ((int64_t)R * K + 3);
}

// S: frequency slots a lane carries through one walk over the tile's keys
template <int S>
__global__ void __launch_bounds__(kTileThreads)
bin_deposit_f32_kernel(DepositArgs A, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = A.K;
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  int* angb = reinterpret_cast<int*>(smem + align16(8 * (int64_t)R));
  float* w = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(angb)
                                      + align16(4 * (int64_t)R));
  float* rows = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(w)
                                         + align16(4 * (int64_t)K));
  const int tid = (int)threadIdx.x, nt = (int)blockDim.x;
  const int64_t t0 = (int64_t)blockIdx.x * R;
  const int n = A.B - t0 < (int64_t)R ? (int)(A.B - t0) : R;

  // stage the tile's spectra [n, K], a contiguous span of Iv: src + i
  // lands at row0 + i, both of the same 16-byte phase
  const float* src = static_cast<const float*>(A.Iv) + t0 * K;
  const int phase = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  float* row0 = rows + phase;
  const int total = n * K;
  const int lead = (4 - phase) & 3;
  const int head = lead < total ? lead : total;
  const int body = (total - head) >> 2;
  for (int i = tid; i < head; i += nt) row0[i] = __ldg(src + i);
  for (int v = tid; v < body; v += nt) {
    stage16(row0 + head + 4 * v, src + head + 4 * v);
  }
  for (int i = head + 4 * body + tid; i < total; i += nt) {
    row0[i] = __ldg(src + i);
  }
  for (int k = tid; k < K; k += nt) w[k] = (float)(2.0 * __ldg(A.dv + k));

  // each ray's bins while the copies fly; its key (image bin, ray in the
  // tile; kNoBin without an image bin)
  for (int r = tid; r < R; r += nt) {
    int img = -1, ang = -1;
    if (r < n) {
      ray_bins(A, t0 + r, img, ang);
      if (A.bins != nullptr) {
        A.bins[2 * (t0 + r)] = img;
        A.bins[2 * (t0 + r) + 1] = ang;
      }
    }
    keys[r] = img >= 0 ? ((unsigned long long)(unsigned)img << 32)
                             | (unsigned)r
                       : kNoBin;
    angb[r] = ang;
  }
  stage_wait();
  __syncthreads();

  // with two warps or more, the first sums I_ang and the others walk the
  // image at the same time; a single warp (or thread) does both in turn
  const int lanes = nt < (int)warpSize ? nt : (int)warpSize;
  const int warps = nt / lanes, warp = tid / lanes, lane = tid % lanes;
  const bool split = warps > 1;

  // I_ang: a thread per ray, its row's products with w summed in f64
  if (!split || warp == 0) {
    const int step = split ? lanes : nt;
    for (int r = split ? lane : tid; r < n; r += step) {
      const int ang = angb[r];
      if (ang < 0) continue;
      const float* row = row0 + (int64_t)r * K;
      const int start = (K & 1) ? 0 : (r % lanes) % K;
      double sum = 0.0;
      for (int k = start; k < K; ++k) sum = sum + (double)(row[k] * w[k]);
      for (int k = 0; k < start; ++k) sum = sum + (double)(row[k] * w[k]);
      atomicAdd(A.iang + ang, sum);
    }
  }
  if (split && warp == 0) return;

  // the image: each walking warp takes its share of the tile's keys in
  // order, a lane per frequency and slot, one atomic per (bin, k) where the
  // bin changes and at the share's end
  const int walkers = split ? warps - 1 : warps;
  const int share = (R + walkers - 1) / walkers;
  const int q0 = (split ? warp - 1 : warp) * share;
  const int q1 = q0 + share < R ? q0 + share : R;
  const float scale = (float)A.scale;
  for (int j0 = 0; j0 * lanes < K; j0 += S) {
    int last = -1;
    double run[S];
#pragma unroll
    for (int j = 0; j < S; ++j) run[j] = 0.0;
    for (int q = q0; q < q1; q += kWalkBatch) {
      int bin[kWalkBatch];
      float v[kWalkBatch][S];
#pragma unroll
      for (int c = 0; c < kWalkBatch; ++c) {
        const unsigned long long key = q + c < q1 ? keys[q + c] : kNoBin;
        bin[c] = key == kNoBin ? -1 : (int)(key >> 32);
        const float* row = row0 + (int64_t)(unsigned)(key & 0xffffffffu) * K;
#pragma unroll
        for (int j = 0; j < S; ++j) {
          const int k = (j0 + j) * lanes + lane;
          v[c][j] = bin[c] >= 0 && k < K ? row[k] : 0.0f;
        }
      }
#pragma unroll
      for (int c = 0; c < kWalkBatch; ++c) {
        if (bin[c] < 0) continue;
        if (bin[c] != last) {
          if (last >= 0) {
#pragma unroll
            for (int j = 0; j < S; ++j) {
              const int k = (j0 + j) * lanes + lane;
              if (k < K) atomicAdd(A.image + (int64_t)last * K + k, run[j]);
            }
          }
          last = bin[c];
#pragma unroll
          for (int j = 0; j < S; ++j) run[j] = 0.0;
        }
#pragma unroll
        for (int j = 0; j < S; ++j) {
          run[j] = run[j] + (double)(v[c][j] * scale);
        }
      }
    }
    if (last >= 0) {
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const int k = (j0 + j) * lanes + lane;
        if (k < K) atomicAdd(A.image + (int64_t)last * K + k, run[j]);
      }
    }
  }
}

// the tile's rays for K: kTileRays, halved while a block's shared memory
// passes kBlockBytes (0 where one ray does not fit)
int tile_rays(int K) {
  int R = kTileRays;
  while (R > 1 && block_bytes(R, K) > kBlockBytes) R >>= 1;
  return block_bytes(R, K) > kBlockBytes ? 0 : R;
}

template <int S>
int launch_f32(const DepositArgs& A, int R, void* stream) {
  const int64_t blocks = (A.B + R - 1) / R;
  const int shared = (int)block_bytes(R, A.K);
  static int opted[64] = {};  // the opt-in above 48 KB, once per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (shared > 48 * 1024 && dev >= 0 && dev < 64 && !opted[dev]) {
    cudaFuncSetAttribute(bin_deposit_f32_kernel<S>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kBlockBytes);
    opted[dev] = 1;
  }
  bin_deposit_f32_kernel<S><<<(unsigned)blocks, kTileThreads, shared, (cudaStream_t)stream>>>(A, R);
  return (int)cudaGetLastError();
}

// the f32 kernel's launch: S = ceil(K / warpSize) slots (up to 4, with
// more passes over the tile's keys beyond K 128)
int bin_deposit_f32(const DepositArgs& A, void* stream) {
  if (A.B <= 0) return (int)cudaGetLastError();
  const int R = tile_rays(A.K);
  if (R == 0) return (int)cudaErrorInvalidValue;
  switch ((A.K + 31) / 32) {
    case 1: return launch_f32<1>(A, R, stream);
    case 2: return launch_f32<2>(A, R, stream);
    case 3: return launch_f32<3>(A, R, stream);
    default: return launch_f32<4>(A, R, stream);
  }
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

// The f32 kernel's C entry: as rt_bin_deposit with Iv [B, K] f32 (4-byte
// aligned; `pairs` is not read). Returns cudaErrorInvalidValue where K is
// too wide for a one-ray tile in shared memory.
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
  (void)pairs;
  const DepositArgs A{cx, cy, ca, cb, ok, Iv, B, K,
                      Axis{gx, nx, dx}, Axis{gy, ny, dy}, Axis{ga, na, da},
                      Axis{gb, nb, db}, dv, scale, mirror_y, negate_ab,
                      image, iang, bins};
  return bin_deposit_f32(A, stream);
}
