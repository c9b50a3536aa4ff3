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
// nest per thread and reads the gain tables straight from global memory
// through the read-only cache: the shipped tables are ~60 KB per segment
// and stay resident in L1/L2. The index search is the reference's f64
// bisection (findindex) on the segment's own grid, so uniform and
// non-uniform grids take one path.
//
// What bounds it: dependent f32 arithmetic of the micro-step loop
// (latency) and divergence between the rays of a warp, whose trip counts
// differ. No shared memory; one ray's state lives in registers.
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

// findindex (RayTraceImageHelper.h:131-143): the first i in [1, n-1] with
// X[i] >= y, or n-1.
__device__ __forceinline__ int find_index(const double* X, int n, double y) {
  int lower = 0, upper = n - 1;
  while (upper - lower != 1) {
    int mid = (upper + lower) >> 1;
    if (X[mid] >= y) upper = mid; else lower = mid;
  }
  return upper;
}

struct Ray {
  float px, py, sx, sy, sz;
};

// propagate (RayTraceImageHelper.h:270-313) in the plain twin's operation
// order. Returns the displacement, the new direction and the path length.
__device__ void propagate(float c, float n0, float dndx, float dndy,
                          float box0, float box1, float box2, float& sx,
                          float& sy, float& sz, float& rx, float& ry,
                          float& rz, float& path) {
  const float dz_max = (c * 1.00001f) * box2;
  const float c01 = c * 0.1f;
  const float c005 = c * 0.05f;
  rx = 0.0f;
  ry = 0.0f;
  rz = 0.0f;
  path = 0.0f;
  bool act = (box0 > 0.0f) && (box1 > 0.0f) && (box2 > 0.0f);
  while (act) {
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
    act = (fabsf(rx) < box0) && (fabsf(ry) < box1) && (fabsf(rz) < box2) &&
          (fabsf(n - n0) < 0.05f);
  }
}

// One (segment, sub-length) cell walk (RayTraceImageHelper.h:460-512).
__device__ void cell_walk(const GainTables& g, int seg, float z_stop,
                          float c, bool use_emis, Ray& ray, bool& escaped,
                          float& z, float& gvl, float& evl, int& ivl) {
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
  const int nx_true = g.nx[seg], ny_true = g.ny[seg];
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
      // cell entry: f64 bisection + corner fetches
      const float y_eff = absy ? fabsf(ray.py) : ray.py;
      const int k1 = find_index(xg, nx_true, (double)ray.px);
      const int k2 = find_index(yg, ny_true, (double)y_eff);
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

      // walk within the cell (propagate2, RayTraceImageHelper.h:318-351)
      Ray l = ray;
      float pz = 0.0f, z2 = 0.0f, ds = 0.0f;
      const float lim = 0.999f * dz2;
      const float box0 = 0.1f * cdx, box1 = 0.1f * cdy;
      bool act1 = (ray.px > exlo) && (ray.px < exhi) && (y_eff > eylo) &&
                  (y_eff < eyhi) && (0.0f < lim);
      while (act1) {
        const float y2 = absy ? fabsf(l.py) : l.py;
        const float dxi2 = (float)(((double)l.px - xlo) / (xhi - xlo));
        const float dyi2 = (float)(((double)y2 - ylo) / (yhi - ylo));
        const float n0 = bilinear(dxi2, dyi2, n1, n2, n3, n4);
        const float dndx = (1.0f - dyi2) * gx1 + dyi2 * gx2;
        float dndy = (1.0f - dxi2) * gy1 + dxi2 * gy2;
        if (absy && l.py < 0.0f) dndy = -dndy;
        const float box2 = dz2 - z2;
        float rx, ry, rz, path;
        propagate(c, n0, dndx, dndy, box0, box1, box2, l.sx, l.sy, l.sz,
                  rx, ry, rz, path);
        l.px = l.px + rx;
        l.py = l.py + ry;
        pz = pz + rz;
        z2 = z2 + fabsf(rz);
        ds = ds + path;
        const float y2n = absy ? fabsf(l.py) : l.py;
        act1 = (l.px > exlo) && (l.px < exhi) && (y2n > eylo) &&
               (y2n < eyhi) && (z2 < lim);
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

__global__ void trace_kernel(const float* __restrict__ ray_x,
                             const float* __restrict__ ray_y,
                             const float* __restrict__ ray_a,
                             const float* __restrict__ ray_b, int64_t B,
                             GainTables g, int N, float dz0, float c,
                             int method, int use_emis, float* gvl_out,
                             float* evl_out, int32_t* ivl_out, float* exit_x,
                             float* exit_y, float* exit_a, float* exit_b,
                             uint8_t* escaped_out, uint8_t* perp_out) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
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
  for (int i = 0; i < nseg; ++i) {
    // high-energy-side segment indexing (RayTraceImageHelper.h:430-441)
    const int ii = method == 1 ? N - i - 1 : i + 1;
    float z = 0.0f;
    for (int iz = 0; iz < kNSub; ++iz) {
      const int isub = method == 1 ? kNSub - iz - 1 : iz;
      const float z_stop = (dz0 * (float)(iz + 1)) / (float)kNSub;
      float gvl, evl;
      int ivl;
      cell_walk(g, ii, z_stop, c, use_emis != 0, ray, escaped, z, gvl, evl,
                ivl);
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
}

}  // namespace

// C entry bound with ctypes by raytrace_tpu_torch/ops/trace_kernel.py.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() of the launch.
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
                        void* stream) {
  GainTables g{gx, gy, cdx, cdy, n4, g0, E0, Gx, Gy, range4, absy, nx, ny,
               nx_pad, ny_pad};
  const int threads = 128;
  const int64_t blocks = (B + threads - 1) / threads;
  trace_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      ray_x, ray_y, ray_a, ray_b, B, g, N, dz0, c, method, use_emis, gvl, evl,
      ivl, exit_x, exit_y, exit_a, exit_b, escaped, perp);
  return (int)cudaGetLastError();
}
