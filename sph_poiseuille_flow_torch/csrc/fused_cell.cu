// Hand-written Hopper (sm_90a) kernels of the fused cell-layout SPH step.
//
// Replaces the three Pallas TPU kernels of the JAX package's
// sph_poiseuille_flow_tpu/ops/fused_cell.py:
//   * _step_kernel / _kernel_body (fused_cell.py:560-1078, called through
//     _fused_call :1471-1538): one physics step as four sweeps.
//     -> sph_step: one launch per sweep (sweep0..sweep3 below).
//   * _chunk_kernel (fused_cell.py:1550-1701, called through
//     fused_chunk_call :1704-1783): up to n_sub whole steps per call.
//     -> sph_chunk: per step a one-block control kernel (v_max, dt, the
//        active flag and the Kahan clock, on device), the four sweeps and a
//        halo refresh; the host enqueues exactly n_sub steps with no sync.
//   * _shear_kernel (fused_cell.py:1928-2010): wall-shear partials.
//     -> sph_shear: per-slot partials, summed outside (torch.sum).
//
// Layout (the JAX package's own): every field is a halo'd core
// (nyp+2, K, nx+2) -- cell row, slot rank, cell column with wrapped x-halo
// columns -- or a plain core (nyp, K, nx). Empty slots ride at x = 1e9, so
// the r^2 window test alone masks them. occ[grp] bounds the anchor ranks a
// row group visits; ranks k >= occ keep zeroed outputs (positions pass
// through).
//
// What bounds it on this card: each thread owns one anchor slot (iy, k, ix)
// (ix fastest, so a warp reads neighbouring candidate columns) and loops
// over the 3x3 windows x K candidate ranks in the (dy, dx, k) order of the
// JAX package's _stage (fused_cell.py:251-263), accumulating in registers.
// Per sweep a thread issues ~9K x (fields) 4-byte loads; the whole working
// set (a few MB at dp=0.01) sits in the 50 MB L2, so HBM does not bound
// the sweeps. One thread per anchor slot gives 54,600 threads at dp=0.01
// (about 13 of 64 warp slots per SM) and 11,760 at dp=0.025 (fewer blocks
// than SMs): a sweep lasts one thread's serial walk over its candidates,
// so the sweeps are latency-bound. Measured on one H100 (700 W) at the
// dp=0.01 grid (K=14): a step's device time is ~0.38 ms, of which sweep2
// takes 55% (it walks the candidates twice: the virtual wall pressure
// needs the anchor's finished prior force), sweeps 0, 1, 3 take 10-13%
// each and chunk_ctrl 4%.
// This first design takes the simple route: no shared-memory staging, no
// geometry cache (each sweep recomputes the pair geometry), one launch per
// sweep (stream order is the grid-wide barrier the TPU got from its
// sequential grid), and the chunk's step loop enqueued from the host in
// sph_chunk. Compiled without fast math and with --fmad=false so the
// arithmetic follows the plain PyTorch twin operation for operation; the
// remaining differences are the summation order and rsqrtf.
//
// Plain C interface, loaded with ctypes. Every entry point returns
// cudaGetLastError(); the Python wrapper raises when it is not 0.

#include <cuda_runtime.h>
#include <math.h>

extern "C" {

struct SphConst {
  int nyp, K, nx, R;
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

struct ShearBufs {
  const float *x, *y, *isf, *vol, *vx, *b11, *b12, *b21, *b22, *wvx, *wbot,
      *wtop;
  const int* occ;
  float *tb, *tt;     // plain per-slot partial sums (bottom / top wall)
  float mu, wf;
};

}  // extern "C"

namespace {

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
  float fvalid = (r2 < c.cut2 && r2 > 1e-24f) ? 1.0f : 0.0f;
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

// ---- sweep 0: density, Vol, half-kick EOS, pair count
//      (sph_physics_mex.c:178-234, :857-865; fused_cell.py:643-729) ----
__global__ void __launch_bounds__(128) sweep0(SphConst c, StepBufs b) {
  Slot s;
  if (!slot_of(c, b.occ, s) || b.dyn[4] == 0.0f) return;
  float vol = 0.0f, rho_half = 0.0f, p_half = 0.0f, cnt = 0.0f;
  if (s.visited) {
    const float dt = b.dyn[0];
    const float xa = b.x[s.ha], ya = b.y[s.ha], af = b.isf[s.ha];
    float s_in = 0.0f, s_ct = 0.0f, s_m1 = 0.0f, s_mw = 0.0f;
    for (int dy = 0; dy < 3; ++dy)
      for (int dx = 0; dx < 3; ++dx) {
        int hv = hix(c, s.iy + dy, 0, s.ix + dx);
        for (int j = 0; j < c.K; ++j, hv += c.nx + 2) {
          Geo g = geometry(c, xa, ya, b.x[hv], b.y[hv], b.isf[hv], true);
          s_in += g.w * g.m1;
          s_ct += g.w * (b.mass[hv] * c.inv_rho0) * g.mw;
          s_m1 += g.m1;
          s_mw += g.mw;
        }
      }
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
__global__ void __launch_bounds__(128) sweep1(SphConst c, StepBufs b) {
  Slot s;
  if (!slot_of(c, b.occ, s) || b.dyn[4] == 0.0f) return;
  float o11 = 0.0f, o12 = 0.0f, o21 = 0.0f, o22 = 0.0f;
  if (s.visited) {
    const float xa = b.x[s.ha], ya = b.y[s.ha], af = b.isf[s.ha];
    float a11 = 0.0f, a12 = 0.0f, a22 = 0.0f;
    for (int dy = 0; dy < 3; ++dy)
      for (int dx = 0; dx < 3; ++dx) {
        int hv = hix(c, s.iy + dy, 0, s.ix + dx);
        for (int j = 0; j < c.K; ++j, hv += c.nx + 2) {
          Geo g = geometry(c, xa, ya, b.x[hv], b.y[hv], b.isf[hv], false);
          const float rf = g.r * g.dw * b.vol[hv] * (g.m1 + g.mw);
          a11 += rf * g.ex * g.ex;
          a12 += rf * g.ex * g.ey;
          a22 += rf * g.ey * g.ey;
        }
      }
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
__global__ void __launch_bounds__(128) sweep2(SphConst c, StepBufs b) {
  Slot s;
  if (!slot_of(c, b.occ, s) || b.dyn[4] == 0.0f) return;
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
    for (int dy = 0; dy < 3; ++dy)
      for (int dx = 0; dx < 3; ++dx) {
        int hv = hix(c, s.iy + dy, 0, s.ix + dx);
        for (int j = 0; j < c.K; ++j, hv += c.nx + 2) {
          Geo q = geometry(c, xa, ya, b.x[hv], b.y[hv], b.isf[hv], false);
          const float dwv = q.dw * b.vol[hv];
          const float dwv1 = dwv * q.m1, dwvw = dwv * q.mw;
          const float inv_denom = 1.0f / (q.r + c.h001);
          const float tx_f = (b11a + b.b11[hv]) * q.ex + (b12a + b.b12[hv]) * q.ey;
          const float ty_f = (b21a + b.b21[hv]) * q.ex + (b22a + b.b22[hv]) * q.ey;
          const float tx_w = b11a * q.ex + b12a * q.ey;
          const float ty_w = b21a * q.ex + b22a * q.ey;
          const float ebe_f = q.ex * tx_f + q.ey * ty_f;
          const float ebe_w = q.ex * tx_w + q.ey * ty_w;
          const float cf_p = ebe_f * mu * inv_denom * dwv1;
          const float cw_p = wf * ebe_w * mu * inv_denom * dwvw;
          acc_x += cf_p * (vxa - b.vx[hv]) + cw_p * (vxa - b.wvx[hv]);
          acc_y += cf_p * (vya - b.vy[hv]) + cw_p * (vya - b.wvy[hv]);
          inc_x += -dwv1 * tx_f - 2.0f * dwvw * tx_w;
          inc_y += -dwv1 * ty_f - 2.0f * dwvw * ty_w;
        }
      }
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
    for (int dy = 0; dy < 3; ++dy)
      for (int dx = 0; dx < 3; ++dx) {
        int hv = hix(c, s.iy + dy, 0, s.ix + dx);
        for (int j = 0; j < c.K; ++j, hv += c.nx + 2) {
          Geo q = geometry(c, xa, ya, b.x[hv], b.y[hv], b.isf[hv], false);
          const float dwv = q.dw * b.vol[hv];
          const float dwv1 = dwv * q.m1, dwvw = dwv * q.mw;
          const float tx_f = (b11a + b.b11[hv]) * q.ex + (b12a + b.b12[hv]) * q.ey;
          const float ty_f = (b21a + b.b21[hv]) * q.ex + (b22a + b.b22[hv]) * q.ey;
          const float tx_w = b11a * q.ex + b12a * q.ey;
          const float ty_w = b21a * q.ex + b22a * q.ey;
          const float vxv = b.vx[hv], vyv = b.vy[hv];
          const float rho_bar = 0.5f * (rhoha + b.rhoH[hv]);
          const float un_l = vxa * q.ex + vya * q.ey;
          const float un_r = vxv * q.ex + vyv * q.ey;
          const float beta = fminf(3.0f * fmaxf(un_l - un_r, 0.0f), c.c_f);
          const float p_avg = 0.5f * (pha + b.pH[hv]);
          const float p_star = p_avg + 0.5f * beta * rho_bar * (un_l - un_r);
          const float p_face = 0.5f * (p_avg + p_star);
          const float face_acc = -(ax_prior * q.ex + ay_prior * q.ey);
          const float p_wall = pha + rhoha * q.r * fmaxf(0.0f, face_acc);
          pacc_x += p_face * tx_f * dwv1 + (pha + p_wall) * tx_w * dwvw;
          pacc_y += p_face * ty_f * dwv1 + (pha + p_wall) * ty_w * dwvw;
        }
      }
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
__global__ void __launch_bounds__(128) sweep3(SphConst c, StepBufs b) {
  Slot s;
  if (!slot_of(c, b.occ, s) || b.dyn[4] == 0.0f) return;
  const int ha = s.ha, p = pix(c, s.iy, s.k, s.ix);
  const float xa = b.x[ha], ya = b.y[ha];
  float rho_new = 0.0f, p_new = 0.0f, drho_new = 0.0f, x2 = xa, y2 = ya;
  if (s.visited) {
    const float dt = b.dyn[0];
    const float af = b.isf[ha];
    const float vx2a = b.vx2[ha], vy2a = b.vy2[ha];
    const float rhoha = b.rhoH[ha];
    float rate = 0.0f;
    for (int dy = 0; dy < 3; ++dy)
      for (int dx = 0; dx < 3; ++dx) {
        int hv = hix(c, s.iy + dy, 0, s.ix + dx);
        for (int j = 0; j < c.K; ++j, hv += c.nx + 2) {
          Geo q = geometry(c, xa, ya, b.x[hv], b.y[hv], b.isf[hv], false);
          const float dwv = q.dw * b.vol[hv];
          const float dwv1 = dwv * q.m1, dwvw = dwv * q.mw;
          const float u_jump_f =
              (vx2a - b.vx2[hv]) * q.ex + (vy2a - b.vy2[hv]) * q.ey;
          const float u_jump_w =
              2.0f * ((vx2a - b.wvx[hv]) * q.ex + (vy2a - b.wvy[hv]) * q.ey);
          rate += u_jump_f * dwv1 + u_jump_w * dwvw;
        }
      }
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

}  // namespace

#ifdef __CUDACC__
extern "C" {

static inline int blocks_for(int n, int per) { return (n + per - 1) / per; }

int sph_step(const SphConst* cp, const StepBufs* bp, void* stream) {
  const SphConst c = *cp;
  const StepBufs b = *bp;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = blocks_for(c.nyp * c.K * c.nx, 128);
  sweep0<<<nb, 128, 0, st>>>(c, b);
  sweep1<<<nb, 128, 0, st>>>(c, b);
  sweep2<<<nb, 128, 0, st>>>(c, b);
  sweep3<<<nb, 128, 0, st>>>(c, b);
  return static_cast<int>(cudaGetLastError());
}

int sph_chunk(const SphConst* cp, const StepBufs* bp, float* clock,
              int* steps, int n_sub, void* stream) {
  const SphConst c = *cp;
  const StepBufs b = *bp;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = blocks_for(c.nyp * c.K * c.nx, 128);
  const int n_h = (c.nyp + 2) * c.K * (c.nx + 2);
  const int nh = blocks_for(n_h, 256);
  for (int i = 0; i < n_sub; ++i) {
    chunk_ctrl<<<1, 1024, 0, st>>>(c, b, n_h, clock, steps);
    sweep0<<<nb, 128, 0, st>>>(c, b);
    sweep1<<<nb, 128, 0, st>>>(c, b);
    sweep2<<<nb, 128, 0, st>>>(c, b);
    sweep3<<<nb, 128, 0, st>>>(c, b);
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
#endif  // __CUDACC__
