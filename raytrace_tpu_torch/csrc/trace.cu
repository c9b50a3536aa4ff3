// Trace kernel (B1): one thread traces one ray through every length segment.
//
// Replaces the Pallas TPU kernel raytrace_tpu/ops/pallas_kernel.py
// (_stepper_kernel, launched by _trace_tiles_jit/trace_tiles). It computes,
// per ray, what raytrace_tpu_torch/ops/stepper.py (trace_batch_plain, the
// lax-exact semantics of raytrace_tpu/ops/stepper.py) computes per lane:
// the cell walk, the propagate2 re-interpolation and the adaptive propagate
// micro-steps of the reference's RayTrace_calc_ray
// (src/common/RayTraceImageHelper.h:270-521).
//
// Design. The TPU kernel's (16,128) tiles, lane-shuffle table fetches, slabs
// and merged scheduling exist because a TPU has no per-lane gather. A GPU
// thread gathers freely, so this kernel keeps the reference's scalar loop
// nest per thread, with propagate's loop merged into propagate2's, and
// reads the gain tables straight from global memory through the read-only
// cache: the shipped tables are ~60 KB per segment and stay resident in
// L1/L2.
//
// What bounds it on an H100: the latency of dependent operations. Its bytes
// are small (rays in, ~26 bytes per ray and sub-length out: about 0.03 ms
// at 3.35 TB/s for a 2^20-ray chunk). Its operations depend on the data.
// Counted from this source: per micro-step of propagate (the `steps`
// count) 81 f32 operations, 11 of them IEEE divisions and one a square
// root (about 290 instructions in the SASS, each division and the root
// with its range check, slow-path branch and convergence barrier); per
// cell entry (the `cells` count) 28 f64 operations and 36 f32 (48 with
// emissivity), the interval searches included; the per-call set-up of
// propagate is left out. chip_smoke.py turns this run's counts into a
// bound against 67 TFLOP/s f32 and 34 TFLOP/s f64 (B1_OPS there). Every
// micro-step depends on the one before it and the SMs issue well below
// their rate, so what the card reaches is set by how many warps are
// resident to hide that latency (more of them pay even with spills), and
// by how many of a warp's 32 lanes take a micro-step each time the warp
// issues one (the micro-step lane fill): a ray's trace is a nest of loops
// (segment, sub-length, cell walk, propagate2's calls of propagate,
// propagate's micro-steps) whose trip counts differ between the rays of a
// warp, and the warp reconverges at the end of each loop. Every ray walks
// every (segment, sub-length), so the lanes of a warp start and end their
// rays together: the refill below hands a warp 32 rays at a time.
//
// What the design does about it:
// * One loop a cell: propagate2's calls and each call's micro-steps run in
//   one loop, an iteration at most one micro-step, so a lane whose call
//   ends sets up its next call while the other lanes of the warp take
//   their next micro-step, where a loop per call held every lane until the
//   warp's slowest call ended. Each ray's operations and their order are
//   the nest's; only which lanes share an instruction changes. The cell
//   walk keeps its barrier: a lane whose cell has ended waits for the
//   warp's other cells. A flat walk, one loop per lane through the ends of
//   cells, sub-lengths, segments and rays, filled the micro-steps better
//   (0.89-0.95 of the lanes) but ran 1.5-1.9 times slower: each of its
//   iterations adds a cell entry's dependent loads and f64 divisions and a
//   call set-up to the micro-step's latency; postponing the entries until
//   k lanes wait for one cut that to 1.4 times at best (PERF.md).
// * Persistent threads that refill idle lanes: as many blocks as stay
//   resident, each lane taking the next ray from a counter (one atomicAdd
//   per warp) when its ray ends, so no block waits for its slowest warp.
//   Per-ray outputs do not depend on which thread traced the ray. The
//   counters live in two scratch words the wrapper keeps per stream; the
//   launch's last thread to retire zeroes them again, so a trace costs one
//   launch and no memset.
// * __launch_bounds__(128, 7) caps the registers at 72, so 7 blocks (28
//   warps) stay resident per SM. The build spills a few dozen bytes and
//   runs faster than the spill-free 96-register build at 5 blocks (20
//   warps); 8 or more blocks spill more than they gain (PERF.md, the
//   kernel table; chip_smoke.py prints the build's registers and spills).
// * find_index guesses the interval from the segment's end points and
//   loads the guess and its neighbour: on the shipped uniform grids those
//   two loads find it, where the reference's bisection takes 7 + 5
//   dependent f64 loads per cell entry. Where the guess misses (a warped
//   grid) it bisects the side of the grid the two loads leave, at most two
//   loads more than the bisection. It returns the bisection's index on
//   every nondecreasing grid (the first i in [1, n-1] with X[i] >= y, or
//   n-1), NaN and the infinities included, so every output stays bitwise.
// No shared memory; one ray's state lives in registers and in the stack
// frame that holds the spills and the f64 tan/atan's argument reduction.
//
// Counts and census: with a non-null `steps` output the kernel also writes
// each ray's number of propagate micro-steps over the whole trace (one per
// iteration of propagate's loop), the per-lane count the Pallas kernel
// keeps with counts=True (pallas_kernel.py:757-758) and the cost-feedback
// reorder sorts by. With a non-null `cells` output it writes each ray's
// number of cell entries (the census of the operation bound). A non-null
// `warp_steps` output (the census launch) runs trace_census_kernel, the
// same walk that also adds up the micro-step iterations its warps issue:
// the lane that leads each one counts it in a register, and each lane adds
// its count with one atomicAdd as it retires; the plain kernel counts
// nothing. The rays' micro-steps over 32 times that sum is the micro-step
// lane fill. A null pointer writes nothing.
//
// Precision placement (the spec, held against the JAX package by
// tests/test_torch_trace.py): x/y grids and the cell-edge fractions in
// f64 with one cast to f32; stepping state f32; tan/atan in f64. The file
// is compiled with -fmad=false so every f32 product and sum rounds on its
// own, as in the plain PyTorch twin; without it nvcc contracts a*b+c into
// one FMA and the kernel drifts from the twin by an ulp per step, which the
// chaotic trajectories amplify. Divisions and sqrt are IEEE (no fast math).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNSub = 3;
// Launch bounds: threads per block and the blocks per SM they must fit,
// which caps the registers at 65536 / (128 x 7), rounded down to 72: the
// fastest build, with spills (see the design note above).
constexpr int kThreads = 128;
constexpr int kMinBlocks = 7;
// Same cap as stepper.MAX_CELL_STEPS: only a non-finite ray state reaches it.
constexpr int kMaxCellSteps = 1 << 16;

struct GainTables {
  const double* x;     // [N, nx_pad]
  const double* y;     // [N, ny_pad]
  const float* cdx;    // [N, nx_pad - 1]
  const float* cdy;    // [N, ny_pad - 1]
  const float* n4;     // [N, nx_pad * ny_pad]
  const float* g0;     // [N, nx_pad * ny_pad]
  const float* E0;     // [N, nx_pad * ny_pad]
  const float* Gx;     // [N, (nx_pad - 1) * ny_pad]
  const float* Gy;     // [N, nx_pad * (ny_pad - 1)]
  const float* range4; // [N, 4]
  const int32_t* absy; // [N]
  const int32_t* nx;   // [N] true grid sizes
  const int32_t* ny;   // [N]
  int nx_pad;
  int ny_pad;
};

// torch.minimum semantics: NaN if either operand is NaN.
__device__ __forceinline__ float min_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}

__device__ __forceinline__ void normalize(float& sx, float& sy, float& sz) {
  float tmp = sx * sx + sy * sy + sz * sz;
  float inv = 1.0f / sqrtf(tmp);
  sx = sx * inv;
  sy = sy * inv;
  sz = sz * inv;
}

__device__ __forceinline__ float bilinear(float dx, float dy, float f1,
                                          float f2, float f3, float f4) {
  float dx2 = 1.0f - dx;
  float dy2 = 1.0f - dy;
  return (dx * f2 + dx2 * f1) * dy2 + (dx * f4 + dx2 * f3) * dy;
}

// One segment's f64 grid axis for find_index: its true size and end points,
// and the scale that maps y - lo onto an interval guess.
struct Axis {
  const double* X;
  int n;
  double lo, hi;
  float scale;  // (n - 1) / (hi - lo) in f32, 0 when that span is 0
};

__device__ __forceinline__ Axis make_axis(const double* X, int n) {
  Axis a;
  a.X = X;
  a.n = n;
  a.lo = __ldg(X);
  a.hi = __ldg(X + n - 1);
  const float span = (float)(a.hi - a.lo);
  a.scale = span > 0.0f ? (float)(n - 1) / span : 0.0f;
  return a;
}

// findindex (RayTraceImageHelper.h:131-143): the first i in [1, n-1] with
// X[i] >= y, or n-1 -- what the reference's bisection returns on a
// nondecreasing grid, NaN (n-1) and the infinities included. The interval
// is guessed from the end points; the guess and its neighbour bracket the
// answer as X[lo] < y <= X[hi] on a uniform grid, and a bisection narrows
// whatever bracket they leave. The guess only decides where the search
// starts.
__device__ __forceinline__ int find_index(const Axis& a, double y) {
  if (!(y <= a.hi)) return a.n - 1;  // y > X[n-1], or NaN
  if (y <= a.lo) return 1;           // X[1] >= X[0] >= y; also -inf
  // here X[0] < y <= X[n-1]; a guess that is not below n-1 (an infinite
  // or NaN one included) starts the search at n-1
  const float guess = (float)(y - a.lo) * a.scale;
  const int i = guess < (float)(a.n - 1) ? (guess > 0.0f ? (int)guess : 0)
                                         : a.n - 1;
  int lo = 0, hi = a.n - 1;
  if (__ldg(a.X + i) >= y) {  // the answer is i or below (i >= 1)
    hi = i;
    if (hi - 1 > lo) {
      if (__ldg(a.X + hi - 1) < y) {
        lo = hi - 1;
      } else {
        hi = hi - 1;
      }
    }
  } else {  // the answer is above i
    lo = i;
    if (lo + 1 < hi) {
      if (__ldg(a.X + lo + 1) >= y) {
        hi = lo + 1;
      } else {
        lo = lo + 1;
      }
    }
  }
  while (hi - lo > 1) {
    const int m = (lo + hi) >> 1;
    if (__ldg(a.X + m) >= y) {
      hi = m;
    } else {
      lo = m;
    }
  }
  return hi;
}

struct Ray {
  float px, py, sx, sy, sz;
};

// One micro-step of propagate (RayTraceImageHelper.h:270-313) in the plain
// twin's operation order: advances the displacement r, the direction s and
// the path length of the call set up by n0, dndx, dndy and its box; returns
// the exit test, whether the call goes on.
__device__ __forceinline__ bool micro_step(float c, float n0, float dndx,
                                           float dndy, float box0,
                                           float box1, float box2,
                                           float& sx, float& sy, float& sz,
                                           float& rx, float& ry, float& rz,
                                           float& path) {
  const float dz_max = (c * 1.00001f) * box2;
  const float c01 = c * 0.1f;
  const float c005 = c * 0.05f;
  float n = n0 + rx * dndx + ry * dndy;
  float t = (sx * dndx + sy * dndy + 1e-12f) / n;
  float fx = dndx / n - sx * t;
  float fy = dndy / n - sy * t;
  float fz = -sz * t;
  float step = c01 / fabsf(t);
  step = min_nan(step, dz_max);
  float step2 = (1.0001f * (box2 - fabsf(rz))) / fabsf(sz);
  float step3 = (c005 * (fabsf(sx) + 5e-4f)) / (fabsf(fx) + 1e-8f);
  float step4 = (c005 * (fabsf(sy) + 5e-4f)) / (fabsf(fy) + 1e-8f);
  step = min_nan(min_nan(step, step2), min_nan(step3, step4));
  float st = step * t;
  float c1 = 0.5f * step * step * (1.0f - st / 3.0f + st * st / 12.0f);
  rx = rx + sx * step + c1 * fx;
  ry = ry + sy * step + c1 * fy;
  rz = rz + sz * step + c1 * fz;
  float c2 = step * (1.0f - 0.5f * st + st * st / 6.0f);
  float nsx = sx + c2 * fx, nsy = sy + c2 * fy, nsz = sz + c2 * fz;
  normalize(nsx, nsy, nsz);
  sx = nsx;
  sy = nsy;
  sz = nsz;
  path = path + step;
  // exit test with this body's n (the reference tests the n of the
  // previous body, RayTraceImageHelper.h:279)
  return (fabsf(rx) < box0) && (fabsf(ry) < box1) && (fabsf(rz) < box2) &&
         (fabsf(n - n0) < 0.05f);
}

// One (segment, sub-length) cell walk (RayTraceImageHelper.h:460-512).
// With kCensus, `led` counts the micro-step iterations this lane led for
// its warp.
template <bool kCensus>
__device__ __forceinline__ void cell_walk(const GainTables& g, int seg,
                                          float z_stop, float c,
                                          bool use_emis, Ray& ray,
                                          bool& escaped, float& z, float& gvl,
                                          float& evl, int& ivl, int& nst,
                                          int& ncell, unsigned& led) {
  const int nx_pad = g.nx_pad, ny_pad = g.ny_pad;
  const double* xg = g.x + (size_t)seg * nx_pad;
  const double* yg = g.y + (size_t)seg * ny_pad;
  const float* cdxg = g.cdx + (size_t)seg * (nx_pad - 1);
  const float* cdyg = g.cdy + (size_t)seg * (ny_pad - 1);
  const size_t cells = (size_t)nx_pad * ny_pad;
  const float* n4t = g.n4 + seg * cells;
  const float* g0t = g.g0 + seg * cells;
  const float* E0t = g.E0 + seg * cells;
  const float* Gxt = g.Gx + (size_t)seg * (nx_pad - 1) * ny_pad;
  const float* Gyt = g.Gy + (size_t)seg * nx_pad * (ny_pad - 1);
  const float r0 = g.range4[4 * seg + 0], r1 = g.range4[4 * seg + 1];
  const float r2 = g.range4[4 * seg + 2], r3 = g.range4[4 * seg + 3];
  const bool absy = g.absy[seg] != 0;
  const Axis ax = make_axis(xg, g.nx[seg]), ay = make_axis(yg, g.ny[seg]);
  const float z_stop995 = 0.995f * z_stop;

  gvl = 0.0f;
  evl = 0.0f;
  ivl = 0;
  bool finished = z >= z_stop995;
  for (int it = 0; it < kMaxCellSteps && !finished; ++it) {
    // escape test (RayTraceImageHelper.h:465-469)
    bool esc_now = (ray.px < r0) || (ray.px > r1) || (ray.py < r2) ||
                   (ray.py > r3) || (ray.sz * ray.sz < 0.01f);
    escaped = escaped || esc_now;
    if (!esc_now) {
      // cell entry: f64 interval search + corner fetches
      ++ncell;
      const float y_eff = absy ? fabsf(ray.py) : ray.py;
      const int k1 = find_index(ax, (double)ray.px);
      const int k2 = find_index(ay, (double)y_eff);
      const int i1 = (k1 - 1) + (k2 - 1) * nx_pad;
      const int i2 = k1 + (k2 - 1) * nx_pad;
      const int i3 = (k1 - 1) + k2 * nx_pad;
      const int i4 = k1 + k2 * nx_pad;
      const float n1 = __ldg(n4t + i1), n2 = __ldg(n4t + i2);
      const float n3 = __ldg(n4t + i3), n4 = __ldg(n4t + i4);
      const double xlo = __ldg(xg + k1 - 1), xhi = __ldg(xg + k1);
      const double ylo = __ldg(yg + k2 - 1), yhi = __ldg(yg + k2);
      const float cdx = __ldg(cdxg + k1 - 1), cdy = __ldg(cdyg + k2 - 1);
      const float dxi = (float)(((double)ray.px - xlo) / (xhi - xlo));
      const float dyi = (float)(((double)y_eff - ylo) / (yhi - ylo));
      const float g0c = bilinear(dxi, dyi, __ldg(g0t + i1), __ldg(g0t + i2),
                                 __ldg(g0t + i3), __ldg(g0t + i4));
      float E0c = 0.0f;
      if (use_emis) {
        E0c = bilinear(dxi, dyi, __ldg(E0t + i1), __ldg(E0t + i2),
                       __ldg(E0t + i3), __ldg(E0t + i4));
        E0c = E0c < 0.0f ? 0.0f : E0c;
      }
      const float gx1 = __ldg(Gxt + (k1 - 1) + (k2 - 1) * (nx_pad - 1));
      const float gx2 = __ldg(Gxt + (k1 - 1) + k2 * (nx_pad - 1));
      const float gy1 = __ldg(Gyt + (k1 - 1) + (k2 - 1) * nx_pad);
      const float gy2 = __ldg(Gyt + k1 + (k2 - 1) * nx_pad);
      // extended cell range (RayTraceImageHelper.h:492-497): f64, one cast
      const float exlo = (float)(xlo - 0.1 * (xhi - xlo));
      const float exhi = (float)(xhi + 0.1 * (xhi - xlo));
      const float eyhi = (float)(yhi + 0.1 * (yhi - ylo));
      const float eylo = (absy && k2 <= 1) ? -eyhi
                                           : (float)(ylo - 0.1 * (yhi - ylo));
      const float dz2 = z_stop - z;

      // walk within the cell: propagate2's calls of propagate
      // (RayTraceImageHelper.h:318-351) and each call's micro-steps
      // (:270-313) in one loop, an iteration at most one micro-step
      Ray l = ray;
      float pz = 0.0f, z2 = 0.0f, ds = 0.0f;
      const float lim = 0.999f * dz2;
      const float box0 = 0.1f * cdx, box1 = 0.1f * cdy;
      bool act1 = (ray.px > exlo) && (ray.px < exhi) && (y_eff > eylo) &&
                  (y_eff < eyhi) && (0.0f < lim);
      // the open propagate call; act while its micro-steps run
      float n0 = 0.0f, dndx = 0.0f, dndy = 0.0f, box2 = 0.0f;
      float rx = 0.0f, ry = 0.0f, rz = 0.0f, path = 0.0f;
      bool act = false;
      while (act1) {
        if (!act) {
          // set up the next call: re-interpolate at the ray's position
          const float y2 = absy ? fabsf(l.py) : l.py;
          const float dxi2 = (float)(((double)l.px - xlo) / (xhi - xlo));
          const float dyi2 = (float)(((double)y2 - ylo) / (yhi - ylo));
          n0 = bilinear(dxi2, dyi2, n1, n2, n3, n4);
          dndx = (1.0f - dyi2) * gx1 + dyi2 * gx2;
          dndy = (1.0f - dxi2) * gy1 + dxi2 * gy2;
          if (absy && l.py < 0.0f) dndy = -dndy;
          box2 = dz2 - z2;
          rx = 0.0f;
          ry = 0.0f;
          rz = 0.0f;
          path = 0.0f;
          act = (box0 > 0.0f) && (box1 > 0.0f) && (box2 > 0.0f);
        }
        if (act) {
          ++nst;
          if (kCensus && threadIdx.x % warpSize ==
                             (unsigned)(__ffs(__activemask()) - 1)) {
            ++led;
          }
          act = micro_step(c, n0, dndx, dndy, box0, box1, box2, l.sx, l.sy,
                           l.sz, rx, ry, rz, path);
        }
        if (!act) {
          // the call has ended: move by its displacement
          l.px = l.px + rx;
          l.py = l.py + ry;
          pz = pz + rz;
          z2 = z2 + fabsf(rz);
          ds = ds + path;
          const float y2n = absy ? fabsf(l.py) : l.py;
          act1 = (l.px > exlo) && (l.px < exhi) && (y2n > eylo) &&
                 (y2n < eyhi) && (z2 < lim);
        }
      }

      // close the cell: advance z, accumulate g*ds and E*ds
      z = z + fabsf(pz);
      gvl = gvl + g0c * ds;
      evl = evl + E0c * ds;
      ivl = i1;
      ray = l;
    }
    finished = escaped || (z >= z_stop995);
  }
}

// Everything one launch reads and writes.
struct TraceArgs {
  const float* ray_x;
  const float* ray_y;
  const float* ray_a;
  const float* ray_b;
  int64_t B;
  GainTables g;
  int N;
  float dz0, c;
  int method, use_emis;
  float* gvl_out;
  float* evl_out;
  int32_t* ivl_out;
  float* exit_x;
  float* exit_y;
  float* exit_a;
  float* exit_b;
  uint8_t* escaped_out;
  uint8_t* perp_out;
  int32_t* steps_out;  // may be null
  int32_t* cells_out;  // may be null
  unsigned long long* warp_steps;  // null but in the census launch
  unsigned long long* ctr;  // the refill's two counters, zero at launch
};

// Trace ray b through every segment and write its outputs.
template <bool kCensus>
__device__ __forceinline__ void trace_ray(const TraceArgs& A, int64_t b,
                                          unsigned& led) {
  const GainTables& g = A.g;
  const int N = A.N, method = A.method;
  const float dz0 = A.dz0, c = A.c;
  const int use_emis = A.use_emis;
  const float *ray_x = A.ray_x, *ray_y = A.ray_y, *ray_a = A.ray_a,
              *ray_b = A.ray_b;
  float *gvl_out = A.gvl_out, *evl_out = A.evl_out;
  int32_t* ivl_out = A.ivl_out;
  float *exit_x = A.exit_x, *exit_y = A.exit_y, *exit_a = A.exit_a,
        *exit_b = A.exit_b;
  uint8_t *escaped_out = A.escaped_out, *perp_out = A.perp_out;
  int32_t *steps_out = A.steps_out, *cells_out = A.cells_out;
  const int nseg = N - 1;

  // direction from angles (RayTraceImageHelper.h:404-418): tan in f64
  Ray ray;
  ray.px = ray_x[b];
  ray.py = ray_y[b];
  ray.sx = (float)tan((double)(1e-3f * ray_a[b]));
  ray.sy = (float)tan((double)(1e-3f * ray_b[b]));
  ray.sz = 1.0f;
  if (method == 1) {
    ray.sx = -ray.sx;
    ray.sy = -ray.sy;
    ray.sz = -ray.sz;
  }
  normalize(ray.sx, ray.sy, ray.sz);

  bool escaped = false;
  int nst = 0, ncell = 0;
  for (int i = 0; i < nseg; ++i) {
    // high-energy-side segment indexing (RayTraceImageHelper.h:430-441)
    const int ii = method == 1 ? N - i - 1 : i + 1;
    float z = 0.0f;
    for (int iz = 0; iz < kNSub; ++iz) {
      const int isub = method == 1 ? kNSub - iz - 1 : iz;
      const float z_stop = (dz0 * (float)(iz + 1)) / (float)kNSub;
      float gvl, evl;
      int ivl;
      cell_walk<kCensus>(g, ii, z_stop, c, use_emis != 0, ray, escaped, z,
                         gvl, evl, ivl, nst, ncell, led);
      const int64_t o = (b * nseg + (ii - 1)) * kNSub + isub;
      gvl_out[o] = gvl;
      evl_out[o] = evl;
      ivl_out[o] = ivl;
    }
  }

  // output ray (RayTraceImageHelper.h:514-521): atan in f64
  exit_x[b] = ray.px;
  exit_y[b] = ray.py;
  exit_a[b] = (float)atan((double)(ray.sx / ray.sz)) * 1e3f;
  exit_b[b] = (float)atan((double)(ray.sy / ray.sz)) * 1e3f;
  escaped_out[b] = escaped ? 1 : 0;
  perp_out[b] = (ray.sz * ray.sz < 0.01f) ? 1 : 0;
  if (steps_out != nullptr) steps_out[b] = nst;
  if (cells_out != nullptr) cells_out[b] = ncell;
}

// The next ray of a refilling thread: one atomicAdd per warp for the lanes
// that ask together, each lane taking its rank among them. ctr[0] is the
// next ray to hand out, ctr[1] the threads that have retired (been handed
// an index past the last ray); the leader retires its warp's lanes, and
// the launch's last thread to retire zeroes both for the next launch.
__device__ __forceinline__ int64_t next_ray(unsigned long long* ctr,
                                            int64_t B) {
  const unsigned mask = __activemask();
  const unsigned lane = threadIdx.x % warpSize;
  const unsigned leader = __ffs(mask) - 1;
  const unsigned long long n = __popc(mask);
  unsigned long long base = 0;
  if (lane == leader) {
    base = atomicAdd(ctr, n);
    const unsigned long long last = (unsigned long long)B;
    if (base + n > last) {
      const unsigned long long out = base + n - (base > last ? base : last);
      const unsigned long long threads =
          (unsigned long long)gridDim.x * blockDim.x;
      if (atomicAdd(ctr + 1, out) + out == threads) {
        ctr[0] = 0;
        ctr[1] = 0;
      }
    }
  }
  base = __shfl_sync(mask, base, leader);
  return (int64_t)(base + __popc(mask & ((1u << lane) - 1u)));
}

// Persistent threads: a lane whose ray has ended takes the next one, so a
// warp's lanes stay busy while its longest ray runs and no block waits for
// its slowest warp. With kCensus the lane also adds up the micro-step
// iterations it led for its warp, as it retires.
template <bool kCensus>
__device__ __forceinline__ void trace_rays(const TraceArgs& A) {
  unsigned led = 0;
  for (;;) {
    const int64_t b = next_ray(A.ctr, A.B);
    if (b >= A.B) break;
    trace_ray<kCensus>(A, b, led);
  }
  if (kCensus && led != 0) {
    atomicAdd(A.warp_steps, (unsigned long long)led);
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
trace_kernel(TraceArgs A) {
  trace_rays<false>(A);
}

// The census launch's kernel: trace_kernel with its warps' micro-step
// iterations counted into A.warp_steps.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
trace_census_kernel(TraceArgs A) {
  trace_rays<true>(A);
}

// Blocks of trace_kernel (of trace_census_kernel with `census`) resident at
// once on device `dev`, queried once.
int resident_blocks(bool census, int dev) {
  static int cache[2][64] = {};
  if (dev < 0 || dev >= 64) dev = 0;
  int& n = cache[census ? 1 : 0][dev];
  if (n == 0) {
    int sms = 1, per_sm = 1;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, census ? trace_census_kernel : trace_kernel, kThreads, 0);
    n = sms * (per_sm > 0 ? per_sm : 1);
  }
  return n;
}

__global__ void find_index_kernel(const double* __restrict__ X, int n,
                                  const double* __restrict__ y, int64_t m,
                                  int32_t* __restrict__ out) {
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= m) return;
  const Axis a = make_axis(X, n);
  out[q] = find_index(a, y[q]);
}

}  // namespace

// C entry bound with ctypes by raytrace_tpu_torch/ops/trace_kernel.py.
// `steps` and `cells` may be null (no counts, no census); a non-null
// `warp_steps` (one 8-byte word, zero before the launch) launches the
// census instance, which adds its warps' micro-step iterations to it; `ctr`
// is two 8-byte words of scratch, zero before the launch and zero again
// after it (the refill's counters; one pair per stream). Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() of the
// launch.
extern "C" int rt_trace(const float* ray_x, const float* ray_y,
                        const float* ray_a, const float* ray_b, int64_t B,
                        const double* gx, const double* gy, const float* cdx,
                        const float* cdy, const float* n4, const float* g0,
                        const float* E0, const float* Gx, const float* Gy,
                        const float* range4, const int32_t* absy,
                        const int32_t* nx, const int32_t* ny, int nx_pad,
                        int ny_pad, int N, float dz0, float c, int method,
                        int use_emis, float* gvl, float* evl, int32_t* ivl,
                        float* exit_x, float* exit_y, float* exit_a,
                        float* exit_b, uint8_t* escaped, uint8_t* perp,
                        int32_t* steps, int32_t* cells,
                        unsigned long long* warp_steps,
                        unsigned long long* ctr, void* stream) {
  GainTables g{gx, gy, cdx, cdy, n4, g0, E0, Gx, Gy, range4, absy, nx, ny,
               nx_pad, ny_pad};
  TraceArgs A{ray_x, ray_y, ray_a, ray_b, B, g, N, dz0, c, method,
              use_emis, gvl, evl, ivl, exit_x, exit_y, exit_a, exit_b,
              escaped, perp, steps, cells, warp_steps, ctr};
  // as many blocks as stay resident at once, fewer for a small batch
  int dev = 0;
  cudaGetDevice(&dev);
  const bool census = warp_steps != nullptr;
  const int64_t resident = resident_blocks(census, dev);
  int64_t blocks = (B + kThreads - 1) / kThreads;
  blocks = blocks < resident ? blocks : resident;
  if (blocks > 0 && census) {
    trace_census_kernel<<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(A);
  } else if (blocks > 0) {
    trace_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(A);
  }
  return (int)cudaGetLastError();
}

// find_index over m queries on one grid X[0..n-1] (n >= 2), for the tests
// that hold it against the bisection and searchsorted.
extern "C" int rt_find_index(const double* X, int n, const double* y,
                             int64_t m, int32_t* out, void* stream) {
  const int threads = 256;
  const int64_t blocks = (m + threads - 1) / threads;
  if (blocks > 0) {
    find_index_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        X, n, y, m, out);
  }
  return (int)cudaGetLastError();
}
