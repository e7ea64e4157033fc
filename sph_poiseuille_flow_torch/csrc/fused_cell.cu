// Hand-written Hopper (sm_90a) kernels of the fused cell-layout SPH step.
//
// Replaces the Pallas TPU kernels of the JAX package's
// sph_poiseuille_flow_tpu/ops/fused_cell.py:
//   * _step_kernel / _kernel_body (fused_cell.py:560-1078, called through
//     _fused_call :1471-1538): one physics step as four sweeps.
//     -> sph_step: one launch per sweep (sweep0..sweep3 below).
//   * _chunk_kernel (fused_cell.py:1550-1701, called through
//     fused_chunk_call :1704-1783): up to n_sub whole steps per call.
//     -> sph_chunk: per step a one-block control kernel (v_max, dt, the
//        active flag and the Kahan clock, on device), the four sweeps and a
//        halo refresh; the host enqueues exactly n_sub steps with no sync.
//   * the geometry cache of both (cache_plan :422-458; written :663-674,
//     read :743-762, :845-861, :1005-1022) -> FORM_CACHE below.
//   * _kernel_body_rows, the candidate-row-outer loop (:1081-1468, picked
//     by use_rows :549-557) -> FORM_ROWS below.
//   * _shear_kernel (fused_cell.py:1928-2010): wall-shear partials.
//     -> sph_shear: per-slot partials, summed outside (torch.sum).
//   * the sweep-decomposition probes, which launch _step_kernel on a grid
//     cut to a sweep range (experiments/profile_r3.py:115 call_sweeps,
//     experiments/profile_fused.py:72 prefix_call) and a no-op body over
//     the step's buffers (profile_r3.py:170).
//     -> sph_step_sweeps (sph_step is its whole range) and sph_noop.
//   * the one-hot lane-tiling body of tests/test_pallas.py:155-172.
//     -> sph_expand.
//
// Layout (the JAX package's own): every field is a halo'd core
// (nyp+2, K, nx+2) -- cell row, slot rank, cell column with wrapped x-halo
// columns -- or a plain core (nyp, K, nx). Empty slots ride at x = 1e9, so
// the r^2 window test alone masks them. occ[grp] bounds the anchor ranks a
// row group visits; ranks k >= occ keep zeroed outputs (positions pass
// through).
//
// Each sweep body is written once (body0..body3) against a candidate
// source, and the source is what the three forms change:
//   * FORM_WIN (geom_cache "none"): one thread per anchor slot (iy, k, ix),
//     ix fastest, walking the 3x3 windows x K candidate ranks in the
//     (dy, dx, k) order of the JAX package's _stage (fused_cell.py:251-263)
//     straight from the halo'd cores, recomputing the pair geometry.
//   * FORM_CACHE (geom_cache "full"/"ring"/"partial"): sweep 0 walks the
//     window as FORM_WIN does and writes each anchor slot's VALID
//     candidates, in window order, to a compacted list: the candidate's
//     halo'd-core index, ex, ey, r, dw*m1 and dw*mw (the five _N_CACHE
//     values). Sweep 1 folds in Vol_j and writes back dw*m1*Vol_j and
//     dw*mw*Vol_j, sweeps 2 and 3 read them: the geometry, its rsqrt and
//     the x/y/isf loads are done once per step, and the later sweeps walk
//     ~20 valid candidates instead of 9K = 126. Skipping an invalid
//     candidate is exact: every term it adds in sweeps 1-3 carries an m1 or
//     mw factor that is 0 for it, so it adds +-0 to a sum that is never -0.
//     The TPU's full and ring caches differ only in their VMEM schedule and
//     the JAX package holds them bit-identical; here both are one cache for
//     every anchor rank. "partial" caches ranks k < kcut and recomputes the
//     rest (the split of _kloop_span, fused_cell.py:511-533); a warp that
//     straddles kcut runs both paths, which costs divergence, not values.
//     The cache expressions follow the JAX cached ones: sweep 1's
//     rf = r * (dw*m1*Vol_j + dw*mw*Vol_j), where the recompute form has
//     r*dw*Vol_j*(m1+mw); sweeps 2-3 agree with the recompute form bit for
//     bit (m1 and mw are exactly 0 or 1).
//     Storage is structure of arrays with the slot fastest (entry e of
//     cached slot s at e*ncs + s), so a warp's loads coalesce; the capacity
//     is 9K entries per slot, so a list cannot overflow.
//   * FORM_ROWS (fused_rows "1"): one block per tile of one cell row, TX
//     columns x all K ranks, one thread per anchor slot; the block stages
//     the 3 candidate rows x (TX+2) columns x K ranks of each field the
//     sweep reads into shared memory once and each thread walks its 9K
//     candidates from there, in the same (dy, dx, k) order and with the
//     recompute arithmetic, so its outputs equal FORM_WIN's bit for bit.
//     Threads of a warp differ in (k, tx) with tx fastest and read
//     candidate (dy, dx, j) at (dy*K + j)*W + tx + dx: TX consecutive words,
//     broadcast across k, so no bank conflicts.
//
// What bounds it on this card: per sweep a thread of FORM_WIN issues
// ~9K x (fields) 4-byte loads; the working set (a few MB at dp=0.01) sits
// in the 50 MB L2, so HBM does not bound the sweeps. One thread per anchor
// slot gives 54,600 threads at dp=0.01 and 11,760 at dp=0.025 (fewer
// blocks than SMs): a sweep lasts one thread's serial walk over its
// candidates, so the sweeps are latency-bound. FORM_CACHE shortens the walk
// of sweeps 1-3 to the valid candidates at the price of the list's traffic
// (~24 bytes per valid pair per sweep); FORM_ROWS trades L2 loads for
// shared-memory loads. One launch per sweep (stream order is the grid-wide
// barrier the TPU got from its sequential grid), the chunk's step loop
// enqueued from the host in sph_chunk. Compiled without fast math and with
// --fmad=false so the arithmetic follows the plain PyTorch twin operation
// for operation; the remaining differences are the summation order and
// rsqrtf.
//
// Plain C interface, loaded with ctypes. Every entry point returns
// cudaGetLastError(); the Python wrapper raises when it is not 0.

#include <cuda_runtime.h>
#include <math.h>

extern "C" {

struct SphConst {
  int nyp, K, nx, R;
  int kcut;  // FORM_CACHE: anchor ranks k < kcut use the cache (K: all)
  int ncs;   // cached slots: nyp * kcut * nx (the entry stride)
  int tx;    // FORM_ROWS: tile width in cell columns (tx * K <= 128)
  float DL, h, cut2, sigma, sig025, c225soh, c3soh, cm075soh;
  float rho0, p0, c_f, inv_sigma0, inv_rho0, tchh, h001, hh, c025h;
};

struct StepBufs {
  // inputs (halo'd except dr): in sph_chunk x/y/vx/vy/dr are the working
  // state, rewritten by the halo refresh after every step
  float *x, *y, *vx, *vy, *dr, *isf, *mass, *wvx, *wvy;
  const int* occ;     // (n_groups,) anchor-rank bound per row group
  float* dyn;         // [dt, g, mu, wf, active]
  float *vol, *b11, *b12, *b21, *b22, *vx2, *vy2;        // halo'd outputs
  float *rho, *p, *drho, *fx, *fy, *fpx, *fpy, *x2, *y2; // plain outputs
  float* cnt;         // plain per-slot pair count (reference convention)
  float *rhoH, *pH, *dxs, *dys;  // scratch: halo'd rho/p half, plain shift
};

// the geometry cache (FORM_CACHE): (9K, ncs) entries + (ncs,) counts
struct CacheBufs {
  int* idx;           // halo'd-core index of the candidate
  float *ex, *ey, *r;
  float *c1, *cw;     // dw*m1, dw*mw; times Vol_j after sweep 1
  int* n;             // valid candidates per cached slot
};

struct ShearBufs {
  const float *x, *y, *isf, *vol, *vx, *b11, *b12, *b21, *b22, *wvx, *wbot,
      *wtop;
  const int* occ;
  float *tb, *tt;     // plain per-slot partial sums (bottom / top wall)
  float mu, wf;
};

}  // extern "C"

namespace {

enum Form { FORM_WIN = 0, FORM_CACHE = 1, FORM_ROWS = 2 };

enum Field {
  F_X, F_Y, F_ISF, F_MASS, F_VOL, F_VX, F_VY, F_B11, F_B12, F_B21, F_B22,
  F_RHOH, F_PH, F_WVX, F_WVY, F_VX2, F_VY2
};

template <int F>
__device__ __forceinline__ const float* core(const StepBufs& b) {
  if constexpr (F == F_X) return b.x;
  else if constexpr (F == F_Y) return b.y;
  else if constexpr (F == F_ISF) return b.isf;
  else if constexpr (F == F_MASS) return b.mass;
  else if constexpr (F == F_VOL) return b.vol;
  else if constexpr (F == F_VX) return b.vx;
  else if constexpr (F == F_VY) return b.vy;
  else if constexpr (F == F_B11) return b.b11;
  else if constexpr (F == F_B12) return b.b12;
  else if constexpr (F == F_B21) return b.b21;
  else if constexpr (F == F_B22) return b.b22;
  else if constexpr (F == F_RHOH) return b.rhoH;
  else if constexpr (F == F_PH) return b.pH;
  else if constexpr (F == F_WVX) return b.wvx;
  else if constexpr (F == F_WVY) return b.wvy;
  else if constexpr (F == F_VX2) return b.vx2;
  else return b.vy2;
}

__device__ __forceinline__ int hix(const SphConst& c, int iyh, int k,
                                   int ixh) {
  return (iyh * c.K + k) * (c.nx + 2) + ixh;
}

__device__ __forceinline__ int pix(const SphConst& c, int iy, int k, int ix) {
  return (iy * c.K + k) * c.nx + ix;
}

// one halo'd output value with its wrapped x-halo copies (_flush,
// fused_cell.py:278-293; nx < 3 keeps zero halo columns)
__device__ __forceinline__ void store_h(const SphConst& c, float* out,
                                        int iy, int k, int ix, float v) {
  out[hix(c, iy + 1, k, ix + 1)] = v;
  if (c.nx >= 3) {
    if (ix == c.nx - 1) out[hix(c, iy + 1, k, 0)] = v;
    if (ix == 0) out[hix(c, iy + 1, k, c.nx + 1)] = v;
  }
}

struct Geo {
  float r, ex, ey, w, dw, m1, mw;
  bool valid;
};

// masked pair geometry of the anchor vs one candidate (_geometry,
// fused_cell.py:300-344; cubic spline sph_neighbor_search_mex.c:115-133)
__device__ __forceinline__ Geo geometry(const SphConst& c, float xa, float ya,
                                        float xv, float yv, float isfv,
                                        bool need_w) {
  Geo g;
  float dx = xa - xv;
  if (c.nx < 3) dx = dx - c.DL * rintf(dx / c.DL);
  float dy = ya - yv;
  float r2 = dx * dx + dy * dy;
  g.valid = r2 < c.cut2 && r2 > 1e-24f;
  const float fvalid = g.valid ? 1.0f : 0.0f;
  float rs = rsqrtf(fmaxf(r2, 1e-24f));
  float r = r2 * rs;
  float q = r / c.h;
  float tq = 2.0f - q;
  g.w = 0.0f;
  if (need_w) {
    float w = q < 1.0f
                  ? c.sigma * (1.0f - 1.5f * q * q + 0.75f * (q * q * q))
                  : (q < 2.0f ? c.sig025 * (tq * tq * tq) : 0.0f);
    g.w = w * fvalid;
  }
  g.dw = q < 1.0f ? q * (c.c225soh * q - c.c3soh)
                  : (q < 2.0f ? c.cm075soh * tq * tq : 0.0f);
  g.m1 = fvalid * isfv;
  g.mw = fvalid - g.m1;
  g.r = r;
  g.ex = dx * rs;
  g.ey = dy * rs;
  return g;
}

struct Slot {
  int iy, k, ix, ha;
  bool visited;
};

// FORM_WIN / FORM_CACHE: one thread per anchor slot over a 1-D grid
__device__ __forceinline__ bool slot_of(const SphConst& c, const int* occ,
                                        Slot& s) {
  int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= c.nyp * c.K * c.nx) return false;
  s.ix = tid % c.nx;
  int rest = tid / c.nx;
  s.k = rest % c.K;
  s.iy = rest / c.K;
  s.ha = hix(c, s.iy + 1, s.k, s.ix + 1);
  s.visited = s.k < occ[s.iy / c.R];
  return true;
}

// FORM_ROWS: block = (row iy, tile of tx columns from x0), thread = (k, ix)
__device__ __forceinline__ bool tile_slot(const SphConst& c, const int* occ,
                                          Slot& s, int& x0) {
  const int tiles = (c.nx + c.tx - 1) / c.tx;
  s.iy = blockIdx.x / tiles;
  x0 = (blockIdx.x % tiles) * c.tx;
  s.k = threadIdx.x / c.tx;
  s.ix = x0 + threadIdx.x % c.tx;
  if (s.ix >= c.nx) return false;
  s.ha = hix(c, s.iy + 1, s.k, s.ix + 1);
  s.visited = s.k < occ[s.iy / c.R];
  return true;
}

// ---- candidate sources ----

// FORM_WIN: the 9K candidates straight from the halo'd cores
struct Win {
  const SphConst& c;
  const StepBufs& b;
  int iy, ix;
  template <int F>
  __device__ __forceinline__ float ld(int i) const { return core<F>(b)[i]; }
  template <class Fn>
  __device__ __forceinline__ void each(Fn&& fn) const {
    for (int dy = 0; dy < 3; ++dy)
      for (int dx = 0; dx < 3; ++dx) {
        int hv = hix(c, iy + dy, 0, ix + dx);
        for (int j = 0; j < c.K; ++j, hv += c.nx + 2) fn(hv);
      }
  }
};

// the fields a sweep reads from its candidates, in shared-memory order
template <int... Fs>
struct FieldSet {
  static constexpr int n = sizeof...(Fs);
  template <int F>
  __host__ __device__ static constexpr int at() {
    int i = 0, r = -1;
    ((r = (Fs == F ? i : r), ++i), ...);
    return r;
  }
  // copy the 3 rows x (tx+2) halo'd columns x K ranks of each field
  __device__ static void stage(const SphConst& c, const StepBufs& b,
                               float* sm, int iy, int x0) {
    const float* src[n] = {core<Fs>(b)...};
    const int W = c.tx + 2, per = 3 * c.K * W;
    for (int t = threadIdx.x; t < n * per; t += blockDim.x) {
      const int f = t / per, rr = t - f * per;
      const int row = rr / W, col = rr - row * W;  // row = dy*K + k
      const int ixh = x0 + col;
      sm[t] = ixh < c.nx + 2
                  ? src[f][hix(c, iy + row / c.K, row % c.K, ixh)]
                  : 0.0f;
    }
  }
};

using Fields0 = FieldSet<F_X, F_Y, F_ISF, F_MASS>;
using Fields1 = FieldSet<F_X, F_Y, F_ISF, F_VOL>;
using Fields2 = FieldSet<F_X, F_Y, F_ISF, F_VOL, F_VX, F_VY, F_B11, F_B12,
                         F_B21, F_B22, F_RHOH, F_PH, F_WVX, F_WVY>;
using Fields3 = FieldSet<F_X, F_Y, F_ISF, F_VOL, F_VX2, F_VY2, F_WVX, F_WVY>;

// FORM_ROWS: the block's shared-memory copy of the window
template <class FS>
struct Tile {
  const SphConst& c;
  const float* sm;
  int tx;  // the thread's column in the tile
  template <int F>
  __device__ __forceinline__ float ld(int i) const {
    constexpr int f = FS::template at<F>();
    static_assert(f >= 0, "field not staged for this sweep");
    return sm[f * 3 * c.K * (c.tx + 2) + i];
  }
  template <class Fn>
  __device__ __forceinline__ void each(Fn&& fn) const {
    const int W = c.tx + 2;
    for (int dy = 0; dy < 3; ++dy)
      for (int dx = 0; dx < 3; ++dx) {
        int l = dy * c.K * W + tx + dx;
        for (int j = 0; j < c.K; ++j, l += W) fn(l);
      }
  }
};

// FORM_CACHE: the anchor slot's compacted list of valid candidates
struct Cached {
  const SphConst& c;
  const StepBufs& b;
  const CacheBufs& cb;
  int iy, ix, cs;  // cs: the slot's index among the cached slots
  template <int F>
  __device__ __forceinline__ float ld(int i) const { return core<F>(b)[i]; }
};

// ---- the pair loops of the sweeps, per source ----

// every candidate with its geometry (the recompute forms)
template <class Src, class Fn>
__device__ __forceinline__ void geo_each(const SphConst& c, const Src& src,
                                         float xa, float ya, bool need_w,
                                         Fn&& fn) {
  src.each([&](int i) {
    fn(i, geometry(c, xa, ya, src.template ld<F_X>(i),
                   src.template ld<F_Y>(i), src.template ld<F_ISF>(i),
                   need_w));
  });
}

// FORM_CACHE sweep 0: the window walk, writing the valid candidates
template <class Fn>
__device__ __forceinline__ void geo_each(const SphConst& c, const Cached& src,
                                         float xa, float ya, bool need_w,
                                         Fn&& fn) {
  const CacheBufs& cb = src.cb;
  int e = src.cs, n = 0;
  geo_each(c, Win{c, src.b, src.iy, src.ix}, xa, ya, need_w,
           [&](int i, const Geo& g) {
             if (g.valid) {
               cb.idx[e] = i;
               cb.ex[e] = g.ex;
               cb.ey[e] = g.ey;
               cb.r[e] = g.r;
               cb.c1[e] = g.dw * g.m1;
               cb.cw[e] = g.dw * g.mw;
               e += c.ncs;
               ++n;
             }
             fn(i, g);
           });
  cb.n[src.cs] = n;
}

// sweep 1: (rf, ex, ey) per pair, rf = r*dw*Vol_j*(m1+mw)
template <class Src, class Fn>
__device__ __forceinline__ void kgc_each(const SphConst& c, const Src& src,
                                         float xa, float ya, Fn&& fn) {
  geo_each(c, src, xa, ya, false, [&](int i, const Geo& g) {
    fn(g.r * g.dw * src.template ld<F_VOL>(i) * (g.m1 + g.mw), g.ex, g.ey);
  });
}

// FORM_CACHE sweep 1: folds Vol_j into the list (fused_cell.py:743-762)
template <class Fn>
__device__ __forceinline__ void kgc_each(const SphConst& c, const Cached& src,
                                         float, float, Fn&& fn) {
  const CacheBufs& cb = src.cb;
  const int n = cb.n[src.cs];
  for (int t = 0, e = src.cs; t < n; ++t, e += c.ncs) {
    const float volv = src.b.vol[cb.idx[e]];
    const float dwv1 = cb.c1[e] * volv, dwvw = cb.cw[e] * volv;
    cb.c1[e] = dwv1;
    cb.cw[e] = dwvw;
    fn(cb.r[e] * (dwv1 + dwvw), cb.ex[e], cb.ey[e]);
  }
}

// sweeps 2-3: (i, r, ex, ey, dw*Vol_j*m1, dw*Vol_j*mw) per pair
template <class Src, class Fn>
__device__ __forceinline__ void pair_each(const SphConst& c, const Src& src,
                                          float xa, float ya, Fn&& fn) {
  geo_each(c, src, xa, ya, false, [&](int i, const Geo& g) {
    const float dwv = g.dw * src.template ld<F_VOL>(i);
    fn(i, g.r, g.ex, g.ey, dwv * g.m1, dwv * g.mw);
  });
}

template <class Fn>
__device__ __forceinline__ void pair_each(const SphConst& c,
                                          const Cached& src, float, float,
                                          Fn&& fn) {
  const CacheBufs& cb = src.cb;
  const int n = cb.n[src.cs];
  for (int t = 0, e = src.cs; t < n; ++t, e += c.ncs)
    fn(cb.idx[e], cb.r[e], cb.ex[e], cb.ey[e], cb.c1[e], cb.cw[e]);
}

// ---- sweep 0: density, Vol, half-kick EOS, pair count
//      (sph_physics_mex.c:178-234, :857-865; fused_cell.py:643-729) ----
template <class Src>
__device__ __forceinline__ void body0(const SphConst& c, const StepBufs& b,
                                      const Slot& s, const Src& src) {
  float vol = 0.0f, rho_half = 0.0f, p_half = 0.0f, cnt = 0.0f;
  if (s.visited) {
    const float dt = b.dyn[0];
    const float xa = b.x[s.ha], ya = b.y[s.ha], af = b.isf[s.ha];
    float s_in = 0.0f, s_ct = 0.0f, s_m1 = 0.0f, s_mw = 0.0f;
    geo_each(c, src, xa, ya, true, [&](int i, const Geo& g) {
      s_in += g.w * g.m1;
      s_ct += g.w * (src.template ld<F_MASS>(i) * c.inv_rho0) * g.mw;
      s_m1 += g.m1;
      s_mw += g.mw;
    });
    const float sig_inner = c.sigma + s_in;  // W(0) = sigma
    const float massa = b.mass[s.ha];
    const float mass_safe = massa > 0.0f ? massa : 1.0f;
    float rho = sig_inner * c.rho0 * c.inv_sigma0 +
                s_ct * c.rho0 * c.rho0 * c.inv_sigma0 / mass_safe;
    rho = rho <= 1e-12f ? c.rho0 : rho;
    rho = af > 0.0f ? rho : c.rho0;  // walls keep rho0
    vol = mass_safe / rho;
    const float dra = b.dr[pix(c, s.iy, s.k, s.ix)];
    const float rk = rho + 0.5f * dt * dra;
    rho_half = af > 0.0f ? (rk < 1e-10f ? c.rho0 : rk) : rho;
    p_half = af > 0.0f ? c.p0 * (rho_half / c.rho0 - 1.0f) : 0.0f;
    cnt = af * (0.5f * s_m1 + s_mw);
  }
  store_h(c, b.vol, s.iy, s.k, s.ix, vol);
  store_h(c, b.rhoH, s.iy, s.k, s.ix, rho_half);
  store_h(c, b.pH, s.iy, s.k, s.ix, p_half);
  b.cnt[pix(c, s.iy, s.k, s.ix)] = cnt;
}

// ---- sweep 1: kernel gradient correction B (c:239-365;
//      fused_cell.py:731-816) ----
template <class Src>
__device__ __forceinline__ void body1(const SphConst& c, const StepBufs& b,
                                      const Slot& s, const Src& src) {
  float o11 = 0.0f, o12 = 0.0f, o21 = 0.0f, o22 = 0.0f;
  if (s.visited) {
    const float xa = b.x[s.ha], ya = b.y[s.ha], af = b.isf[s.ha];
    float a11 = 0.0f, a12 = 0.0f, a22 = 0.0f;
    kgc_each(c, src, xa, ya, [&](float rf, float ex, float ey) {
      a11 += rf * ex * ex;
      a12 += rf * ex * ey;
      a22 += rf * ey * ey;
    });
    a11 = -a11;
    a12 = -a12;
    a22 = -a22;
    const float a21 = a12;
    // regularized pseudo-inverse blend (c:321-365)
    const float ata11 = a11 * a11 + a21 * a21 + 1e-8f;
    const float ata12 = a11 * a12 + a21 * a22;
    const float ata22 = a12 * a12 + a22 * a22 + 1e-8f;
    const float det_m = ata11 * ata22 - ata12 * ata12;
    const bool degen = fabsf(det_m) < 1e-20f;
    const float det_safe = degen ? 1.0f : det_m;
    const float im11 = ata22 / det_safe;
    const float im12 = -ata12 / det_safe;
    const float im22 = ata11 / det_safe;
    const float p11 = degen ? 1.0f : im11 * a11 + im12 * a12;
    const float p12 = degen ? 0.0f : im11 * a21 + im12 * a22;
    const float p21 = degen ? 0.0f : im12 * a11 + im22 * a12;
    const float p22 = degen ? 1.0f : im12 * a21 + im22 * a22;
    const float det_a = a11 * a22 - a12 * a21;
    const float det_sqr = fmaxf(1.0f - det_a, 0.0f);
    const float denom = det_a + det_sqr;
    const bool small = fabsf(denom) < 1e-12f;
    const float denom_safe = small ? 1.0f : denom;
    const float w1 = small ? 0.0f : det_a / denom_safe;
    const float w2 = small ? 1.0f : det_sqr / denom_safe;
    const bool fl = af > 0.0f;
    o11 = fl ? w1 * p11 + w2 : 1.0f;
    o12 = fl ? w1 * p12 : 0.0f;
    o21 = fl ? w1 * p21 : 0.0f;
    o22 = fl ? w1 * p22 + w2 : 1.0f;
  }
  store_h(c, b.b11, s.iy, s.k, s.ix, o11);
  store_h(c, b.b12, s.iy, s.k, s.ix, o12);
  store_h(c, b.b21, s.iy, s.k, s.ix, o21);
  store_h(c, b.b22, s.iy, s.k, s.ix, o22);
}

// ---- sweep 2: viscous + gravity, shifting, Riemann pressure, kick
//      (c:466-545, :633-709, :867-957, :1388-1409;
//      fused_cell.py:818-965). Two candidate passes: the virtual wall
//      pressure needs the anchor's completed prior force. ----
template <class Src>
__device__ __forceinline__ void body2(const SphConst& c, const StepBufs& b,
                                      const Slot& s, const Src& src) {
  float vx2 = 0.0f, vy2 = 0.0f, fx = 0.0f, fy = 0.0f, fpx = 0.0f, fpy = 0.0f,
        dxs = 0.0f, dys = 0.0f;
  if (s.visited) {
    const float dt = b.dyn[0], g = b.dyn[1], mu = b.dyn[2], wf = b.dyn[3];
    const int ha = s.ha;
    const float xa = b.x[ha], ya = b.y[ha], af = b.isf[ha];
    const float vola = b.vol[ha];
    const float vxa = b.vx[ha], vya = b.vy[ha];
    const float b11a = b.b11[ha], b12a = b.b12[ha], b21a = b.b21[ha],
                b22a = b.b22[ha];
    const float rhoha = b.rhoH[ha], pha = b.pH[ha];
    const float massa = b.mass[ha];
    const float mass_safe = massa > 0.0f ? massa : 1.0f;

    float acc_x = 0.0f, acc_y = 0.0f, inc_x = 0.0f, inc_y = 0.0f;
    pair_each(c, src, xa, ya, [&](int i, float r, float ex, float ey,
                                  float dwv1, float dwvw) {
      const float inv_denom = 1.0f / (r + c.h001);
      const float tx_f = (b11a + src.template ld<F_B11>(i)) * ex +
                         (b12a + src.template ld<F_B12>(i)) * ey;
      const float ty_f = (b21a + src.template ld<F_B21>(i)) * ex +
                         (b22a + src.template ld<F_B22>(i)) * ey;
      const float tx_w = b11a * ex + b12a * ey;
      const float ty_w = b21a * ex + b22a * ey;
      const float ebe_f = ex * tx_f + ey * ty_f;
      const float ebe_w = ex * tx_w + ey * ty_w;
      const float cf_p = ebe_f * mu * inv_denom * dwv1;
      const float cw_p = wf * ebe_w * mu * inv_denom * dwvw;
      acc_x += cf_p * (vxa - src.template ld<F_VX>(i)) +
               cw_p * (vxa - src.template ld<F_WVX>(i));
      acc_y += cf_p * (vya - src.template ld<F_VY>(i)) +
               cw_p * (vya - src.template ld<F_WVY>(i));
      inc_x += -dwv1 * tx_f - 2.0f * dwvw * tx_w;
      inc_y += -dwv1 * ty_f - 2.0f * dwvw * ty_w;
    });
    const bool fl = af > 0.0f;
    fpx = fl ? acc_x * vola + massa * g : 0.0f;
    fpy = fl ? acc_y * vola : 0.0f;
    const float lim = fminf(
        fmaxf(100.0f * (inc_x * inc_x + inc_y * inc_y) / c.hh, 0.0f), 1.0f);
    const float shift = c.tchh * lim * af;
    dxs = shift * inc_x;
    dys = shift * inc_y;

    const float ax_prior = fpx / mass_safe, ay_prior = fpy / mass_safe;
    float pacc_x = 0.0f, pacc_y = 0.0f;
    pair_each(c, src, xa, ya, [&](int i, float r, float ex, float ey,
                                  float dwv1, float dwvw) {
      const float tx_f = (b11a + src.template ld<F_B11>(i)) * ex +
                         (b12a + src.template ld<F_B12>(i)) * ey;
      const float ty_f = (b21a + src.template ld<F_B21>(i)) * ex +
                         (b22a + src.template ld<F_B22>(i)) * ey;
      const float tx_w = b11a * ex + b12a * ey;
      const float ty_w = b21a * ex + b22a * ey;
      const float vxv = src.template ld<F_VX>(i);
      const float vyv = src.template ld<F_VY>(i);
      const float rho_bar = 0.5f * (rhoha + src.template ld<F_RHOH>(i));
      const float un_l = vxa * ex + vya * ey;
      const float un_r = vxv * ex + vyv * ey;
      const float beta = fminf(3.0f * fmaxf(un_l - un_r, 0.0f), c.c_f);
      const float p_avg = 0.5f * (pha + src.template ld<F_PH>(i));
      const float p_star = p_avg + 0.5f * beta * rho_bar * (un_l - un_r);
      const float p_face = 0.5f * (p_avg + p_star);
      const float face_acc = -(ax_prior * ex + ay_prior * ey);
      const float p_wall = pha + rhoha * r * fmaxf(0.0f, face_acc);
      pacc_x += p_face * tx_f * dwv1 + (pha + p_wall) * tx_w * dwvw;
      pacc_y += p_face * ty_f * dwv1 + (pha + p_wall) * ty_w * dwvw;
    });
    fx = fl ? -pacc_x * vola : 0.0f;
    fy = fl ? -pacc_y * vola : 0.0f;
    const float inv_m = 1.0f / mass_safe;
    vx2 = fl ? vxa + (fpx + fx) * inv_m * dt : 0.0f;
    vy2 = fl ? vya + (fpy + fy) * inv_m * dt : 0.0f;
  }
  const int p = pix(c, s.iy, s.k, s.ix);
  store_h(c, b.vx2, s.iy, s.k, s.ix, vx2);
  store_h(c, b.vy2, s.iy, s.k, s.ix, vy2);
  b.fx[p] = fx;
  b.fy[p] = fy;
  b.fpx[p] = fpx;
  b.fpy[p] = fpy;
  b.dxs[p] = dxs;
  b.dys[p] = dys;
}

// ---- sweep 3: continuity, final rho/p, positions (c:1073-1116,
//      :1429-1451; fused_cell.py:967-1078) ----
template <class Src>
__device__ __forceinline__ void body3(const SphConst& c, const StepBufs& b,
                                      const Slot& s, const Src& src) {
  const int ha = s.ha, p = pix(c, s.iy, s.k, s.ix);
  const float xa = b.x[ha], ya = b.y[ha];
  float rho_new = 0.0f, p_new = 0.0f, drho_new = 0.0f, x2 = xa, y2 = ya;
  if (s.visited) {
    const float dt = b.dyn[0];
    const float af = b.isf[ha];
    const float vx2a = b.vx2[ha], vy2a = b.vy2[ha];
    const float rhoha = b.rhoH[ha];
    float rate = 0.0f;
    pair_each(c, src, xa, ya, [&](int i, float, float ex, float ey,
                                  float dwv1, float dwvw) {
      const float u_jump_f = (vx2a - src.template ld<F_VX2>(i)) * ex +
                             (vy2a - src.template ld<F_VY2>(i)) * ey;
      const float u_jump_w =
          2.0f * ((vx2a - src.template ld<F_WVX>(i)) * ex +
                  (vy2a - src.template ld<F_WVY>(i)) * ey);
      rate += u_jump_f * dwv1 + u_jump_w * dwvw;
    });
    const bool fl = af > 0.0f;
    drho_new = fl ? rate * rhoha : 0.0f;
    float rn = rhoha + 0.5f * dt * drho_new;
    rn = rn < 1e-10f ? c.rho0 : rn;
    rho_new = fl ? rn : rhoha;
    p_new = fl ? c.p0 * (rho_new / c.rho0 - 1.0f) : 0.0f;
    // shift + half drift (old v) + half drift (new v); walls never move
    const float xs = xa + b.dxs[p] + 0.5f * dt * (b.vx[ha] + vx2a);
    const float ys = ya + b.dys[p] + 0.5f * dt * (b.vy[ha] + vy2a);
    x2 = fl ? xs : xa;
    y2 = fl ? ys : ya;
  }
  b.rho[p] = rho_new;
  b.p[p] = p_new;
  b.drho[p] = drho_new;
  b.x2[p] = x2;
  b.y2[p] = y2;
}

// one sweep in one form: pick the anchor slot and its candidate source,
// then run the sweep's body
template <int FORM, class FS, class Body>
__device__ __forceinline__ void run_sweep(const SphConst& c,
                                          const StepBufs& b,
                                          const CacheBufs& cb, Body&& body) {
  if (b.dyn[4] == 0.0f) return;  // the chunk's interval or n_sub is done
  Slot s;
  if constexpr (FORM == FORM_ROWS) {
    extern __shared__ float tile_sm[];
    int x0;
    const bool on = tile_slot(c, b.occ, s, x0);
    FS::stage(c, b, tile_sm, s.iy, x0);
    __syncthreads();
    if (on) body(s, Tile<FS>{c, tile_sm, s.ix - x0});
  } else {
    if (!slot_of(c, b.occ, s)) return;
    if constexpr (FORM == FORM_CACHE) {
      if (s.k < c.kcut) {
        const int cs = (s.iy * c.kcut + s.k) * c.nx + s.ix;
        body(s, Cached{c, b, cb, s.iy, s.ix, cs});
        return;
      }
    }
    body(s, Win{c, b, s.iy, s.ix});
  }
}

template <int FORM>
__global__ void __launch_bounds__(128)
    sweep0(SphConst c, StepBufs b, CacheBufs cb) {
  run_sweep<FORM, Fields0>(c, b, cb, [&](const Slot& s, const auto& src) {
    body0(c, b, s, src);
  });
}

template <int FORM>
__global__ void __launch_bounds__(128)
    sweep1(SphConst c, StepBufs b, CacheBufs cb) {
  run_sweep<FORM, Fields1>(c, b, cb, [&](const Slot& s, const auto& src) {
    body1(c, b, s, src);
  });
}

template <int FORM>
__global__ void __launch_bounds__(128)
    sweep2(SphConst c, StepBufs b, CacheBufs cb) {
  run_sweep<FORM, Fields2>(c, b, cb, [&](const Slot& s, const auto& src) {
    body2(c, b, s, src);
  });
}

template <int FORM>
__global__ void __launch_bounds__(128)
    sweep3(SphConst c, StepBufs b, CacheBufs cb) {
  run_sweep<FORM, Fields3>(c, b, cb, [&](const Slot& s, const auto& src) {
    body3(c, b, s, src);
  });
}

// ---- chunk control: v_max over the whole velocity cores, dt, the active
//      flag and the Kahan clock (fused_cell.py:1602-1618, :1664-1667).
//      clock = [t, t_comp, interval, dt_visc, dt_body]; steps = [done,
//      n_sub]. One block of 1024 threads. ----
__global__ void __launch_bounds__(1024) chunk_ctrl(SphConst c, StepBufs b,
                                                   int n_h, float* clock,
                                                   int* steps) {
  __shared__ float smax[1024];
  float m = 0.0f;
  for (int i = threadIdx.x; i < n_h; i += blockDim.x) {
    const float u = b.vx[i], v = b.vy[i];
    m = fmaxf(m, u * u + v * v);
  }
  smax[threadIdx.x] = m;
  __syncthreads();
  for (int w = blockDim.x / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w)
      smax[threadIdx.x] = fmaxf(smax[threadIdx.x], smax[threadIdx.x + w]);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const int done = steps[0];
    const float t = clock[0], tc = clock[1], interval = clock[2];
    if (done < steps[1] && t < interval) {
      const float v_max = sqrtf(smax[0]);
      const float remain = interval - t;
      const float dt_ac = c.c025h / fmaxf(c.c_f + v_max, 1e-12f);
      const float dt = fmaxf(
          fminf(fminf(dt_ac, clock[3]), fminf(clock[4], remain)), 1e-12f);
      const float yk = dt - tc;
      const float t2 = t + yk;
      clock[0] = t2;
      clock[1] = (t2 - t) - yk;
      steps[0] = done + 1;
      b.dyn[0] = dt;
      b.dyn[4] = 1.0f;
    } else {
      b.dyn[4] = 0.0f;
    }
  }
}

// ---- halo refresh of the working state (fused_cell.py:1680-1692):
//      positions keep translated x-halo columns and stay unwrapped ----
__global__ void __launch_bounds__(256) refresh(SphConst c, StepBufs b) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int W = c.nx + 2;
  if (i >= (c.nyp + 2) * c.K * W || b.dyn[4] == 0.0f) return;
  b.vx[i] = b.vx2[i];
  b.vy[i] = b.vy2[i];
  const int ixh = i % W;
  const int iyh = (i / W) / c.K;
  const int k = (i / W) % c.K;
  if (iyh < 1 || iyh > c.nyp) return;
  const int iy = iyh - 1;
  if (ixh >= 1 && ixh <= c.nx) {
    const int p = pix(c, iy, k, ixh - 1);
    b.x[i] = b.x2[p];
    b.y[i] = b.y2[p];
    b.dr[p] = b.drho[p];
  } else if (c.nx >= 3 && ixh == 0) {
    const int p = pix(c, iy, k, c.nx - 1);
    b.x[i] = b.x2[p] - c.DL;
    b.y[i] = b.y2[p];
  } else if (c.nx >= 3) {
    const int p = pix(c, iy, k, 0);
    b.x[i] = b.x2[p] + c.DL;
    b.y[i] = b.y2[p];
  }
}

// ---- wall-shear partials (sph_physics_mex.c:1713-1742;
//      fused_cell.py:1928-1979) ----
__global__ void __launch_bounds__(128) shear(SphConst c, ShearBufs b) {
  Slot s;
  if (!slot_of(c, b.occ, s)) return;
  float tb = 0.0f, tt = 0.0f;
  if (s.visited) {
    const int ha = s.ha;
    const float xa = b.x[ha], ya = b.y[ha];
    const float vxa = b.vx[ha], vola = b.vol[ha];
    const float b11a = b.b11[ha], b12a = b.b12[ha], b21a = b.b21[ha],
                b22a = b.b22[ha];
    for (int dy = 0; dy < 3; ++dy)
      for (int dx = 0; dx < 3; ++dx) {
        int hv = hix(c, s.iy + dy, 0, s.ix + dx);
        for (int j = 0; j < c.K; ++j, hv += c.nx + 2) {
          Geo q = geometry(c, xa, ya, b.x[hv], b.y[hv], b.isf[hv], false);
          const float ebe = q.ex * (b11a * q.ex + b12a * q.ey) +
                            q.ey * (b21a * q.ex + b22a * q.ey);
          const float f_pair = (b.wf * b.mu * ebe * q.dw * b.vol[hv] *
                                (vxa - b.wvx[hv]) / (q.r + c.h001) * vola) *
                               q.mw;
          tb += f_pair * b.wbot[hv];
          tt += f_pair * b.wtop[hv];
        }
      }
  }
  const int p = pix(c, s.iy, s.k, s.ix);
  b.tb[p] = tb;
  b.tt[p] = tt;
}

// ---- the fixed cost of one call over the step's buffers (the TPU probe's
//      noop_kernel, experiments/profile_r3.py:170-171): vol[0, 0, :] =
//      x[0, 0, :], nx + 2 floats; every other buffer is left as it is ----
__global__ void __launch_bounds__(128) noop(SphConst c, StepBufs b) {
  for (int i = threadIdx.x; i < c.nx + 2; i += blockDim.x) b.vol[i] = b.x[i];
}

// ---- the one-hot lane tiling of tests/test_pallas.py:155-172: out (rows,
//      K*bx) = v (rows, bx) @ E with E[c, k*bx + c] = 1, one thread per
//      output element, E generated in registers. Each sum is one product
//      v*1 and bx-1 products +-0 in float32 on the CUDA cores (--fmad=false),
//      so out is exactly v tiled K times. The tensor cores would round the
//      product under TF32 (10 mantissa bits): this card's counterpart of the
//      MXU default-precision trap that test documents. ----
__global__ void __launch_bounds__(256) expand(const float* v, float* out,
                                             int rows, int bx, int K) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const int w = K * bx;
  if (i >= (long long)rows * w) return;
  const int r = static_cast<int>(i / w), c = static_cast<int>(i % w) % bx;
  float acc = 0.0f;
  for (int j = 0; j < bx; ++j) acc += v[r * bx + j] * (j == c ? 1.0f : 0.0f);
  out[i] = acc;
}

inline int blocks_for(int n, int per) { return (n + per - 1) / per; }

// one sweep in one form; the rows form's window needs the kernel's opt-in
// when its dynamic shared memory exceeds 48 KB, set for each launched sweep
template <int FORM, class FS>
void launch_sweep(void (*kern)(SphConst, StepBufs, CacheBufs),
                  const SphConst& c, const StepBufs& b, const CacheBufs& cb,
                  cudaStream_t st) {
  int nb = blocks_for(c.nyp * c.K * c.nx, 128), nt = 128;
  size_t sm = 0;
  if constexpr (FORM == FORM_ROWS) {
    nb = c.nyp * blocks_for(c.nx, c.tx);
    nt = c.tx * c.K;
    sm = sizeof(float) * 3 * c.K * (c.tx + 2) * FS::n;
    if (sm > 48 * 1024)
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           sm);
  }
  kern<<<nb, nt, sm, st>>>(c, b, cb);
}

// sweeps first .. first+count-1 of one step, in stream order
template <int FORM>
void launch_sweeps(const SphConst& c, const StepBufs& b, const CacheBufs& cb,
                   int first, int count, cudaStream_t st) {
  for (int s = first; s < first + count; ++s) {
    if (s == 0)
      launch_sweep<FORM, Fields0>(sweep0<FORM>, c, b, cb, st);
    else if (s == 1)
      launch_sweep<FORM, Fields1>(sweep1<FORM>, c, b, cb, st);
    else if (s == 2)
      launch_sweep<FORM, Fields2>(sweep2<FORM>, c, b, cb, st);
    else
      launch_sweep<FORM, Fields3>(sweep3<FORM>, c, b, cb, st);
  }
}

void sweeps(const SphConst& c, const StepBufs& b, const CacheBufs& cb,
            int form, int first, int count, cudaStream_t st) {
  if (form == FORM_CACHE)
    launch_sweeps<FORM_CACHE>(c, b, cb, first, count, st);
  else if (form == FORM_ROWS)
    launch_sweeps<FORM_ROWS>(c, b, cb, first, count, st);
  else
    launch_sweeps<FORM_WIN>(c, b, cb, first, count, st);
}

}  // namespace

extern "C" {

// sweeps first .. first+count-1 (0 <= first, first + count <= 4; the
// wrapper checks) on the step's buffers: the TPU probes' grid restricted
// to a sweep range (experiments/profile_r3.py:115-127,
// experiments/profile_fused.py:72-95)
int sph_step_sweeps(const SphConst* cp, const StepBufs* bp,
                    const CacheBufs* cbp, int form, int first, int count,
                    void* stream) {
  sweeps(*cp, *bp, *cbp, form, first, count,
         static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

int sph_step(const SphConst* cp, const StepBufs* bp, const CacheBufs* cbp,
             int form, void* stream) {
  return sph_step_sweeps(cp, bp, cbp, form, 0, 4, stream);
}

int sph_noop(const SphConst* cp, const StepBufs* bp, void* stream) {
  noop<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(*cp, *bp);
  return static_cast<int>(cudaGetLastError());
}

int sph_expand(const float* v, float* out, int rows, int bx, int K,
               void* stream) {
  const long long n = static_cast<long long>(rows) * K * bx;
  expand<<<static_cast<int>((n + 255) / 256), 256, 0,
           static_cast<cudaStream_t>(stream)>>>(v, out, rows, bx, K);
  return static_cast<int>(cudaGetLastError());
}

int sph_chunk(const SphConst* cp, const StepBufs* bp, const CacheBufs* cbp,
              int form, float* clock, int* steps, int n_sub, void* stream) {
  const SphConst c = *cp;
  const StepBufs b = *bp;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_h = (c.nyp + 2) * c.K * (c.nx + 2);
  const int nh = blocks_for(n_h, 256);
  for (int i = 0; i < n_sub; ++i) {
    chunk_ctrl<<<1, 1024, 0, st>>>(c, b, n_h, clock, steps);
    sweeps(c, b, *cbp, form, 0, 4, st);
    refresh<<<nh, 256, 0, st>>>(c, b);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

int sph_shear(const SphConst* cp, const ShearBufs* bp, void* stream) {
  const SphConst c = *cp;
  const ShearBufs b = *bp;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  shear<<<blocks_for(c.nyp * c.K * c.nx, 128), 128, 0, st>>>(c, b);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
