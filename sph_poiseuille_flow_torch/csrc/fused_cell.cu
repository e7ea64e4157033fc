// Hand-written Hopper (sm_90a) kernels of the fused cell-layout SPH step.
//
// Replaces the Pallas TPU kernels of the JAX package's
// sph_poiseuille_flow_tpu/ops/fused_cell.py:
//   * _step_kernel / _kernel_body (fused_cell.py:560-1078, called through
//     _fused_call :1471-1538): one physics step as four sweeps.
//     -> sph_step: one launch per sweep (win_sweep, cache_sweep, rows_sweep
//        below, by form).
//   * _chunk_kernel (fused_cell.py:1550-1701, called through
//     fused_chunk_call :1704-1783): up to n_sub whole steps per call.
//     -> sph_chunk: a v_max reduction over the input cores, then per step
//        a one-thread control kernel (dt, the active flag and the Kahan
//        clock, on device), the four sweeps and a halo refresh that takes
//        the next step's v_max; the host enqueues exactly n_sub steps with
//        no sync.
//   * the geometry cache of both (cache_plan :422-458; written :663-674,
//     read :743-762, :845-861, :1005-1022) -> FORM_CACHE below.
//   * _kernel_body_rows, the candidate-row-outer loop (:1081-1468, picked
//     by use_rows :549-557) -> FORM_ROWS below.
//   * _shear_kernel (fused_cell.py:1928-2010): wall-shear partials.
//     -> sph_shear: per-slot partials over the cell rows next to the walls
//        (the layout's row list), a lane group per anchor, summed outside
//        (torch.sum).
//   * the sweep-decomposition probes, which launch _step_kernel on a grid
//     cut to a sweep range (experiments/profile_r3.py:115 call_sweeps,
//     experiments/profile_fused.py:72 prefix_call) and a no-op body over
//     the step's buffers (profile_r3.py:170).
//     -> sph_step_sweeps (sph_step is its whole range) and sph_noop.
//   * the one-hot lane-tiling body of tests/test_pallas.py:155-172.
//     -> sph_expand: one block per row, the product's value from the row's
//        count of non-finite entries, float4 stores.
//
// Layout (the JAX package's own): every field is a halo'd core
// (nyp+2, K, nx+2) -- cell row, slot rank, cell column with wrapped x-halo
// columns -- or a plain core (nyp, K, nx). Empty slots ride at x = 1e9, so
// the r^2 window test alone masks them. occ[grp] bounds the anchor ranks a
// row group visits; ranks k >= occ keep zeroed outputs (positions pass
// through).
//
// The physics stands twice. body0..body3 (generic over a candidate source)
// serve the cache form alone. The window forms, FORM_WIN and FORM_ROWS,
// share the body0..body3 overloads for LWin, whose pair terms go to the
// lane group's ordered sums; LWin differs between them only in where a
// candidate lives (InCores: the halo'd cores; InTile: the block's staged
// tile). The cache bodies stay apart because bodies written over the
// ordered sums compiled the cache kernels to other code (its sweep 0 ran
// 8% slower). Which check guards which copy: chip_smoke.py holds every
// form to the plain twin at its tolerances (the cache's bodies are guarded
// by that alone) and fails unless the rows kernels equal the recompute
// kernels on every core bit for bit, which guards the tile's index
// arithmetic (staging, the walk's place in the tile). The forms:
//   * FORM_WIN (geom_cache "none"; the JAX package's recompute loop,
//     _kloop_span fused_cell.py:511-533, over the window of _stage
//     :251-263): a group of G lanes shares one anchor slot (LWin,
//     win_sweep<S, G, ROWS>; G = wg, the wrapper's win_groups, 4-32),
//     slots in the (iy, k, ix) order. The group walks the anchor's window
//     straight from the halo'd cores (walk_window, which the shear and the
//     wide cache kernels walk too) in two passes per piece of 128 window
//     positions: every lane tests its share of the candidates
//     for validity (x, y only; ranks past a row's occupancy bound hold
//     empty slots and are not tested), the group ORs the valid window
//     positions into a bit mask, and the lanes then take the valid
//     candidates in the (dy, dx, k) window order, each computing the pair
//     geometry and the sweep's terms of the candidate it holds. Every
//     lane adds the round's terms in window order, lane 0's first
//     (shuffles), so the sums are those of a one-thread walk over all 9K
//     candidates bit for bit on a finite state: skipping an invalid
//     candidate is exact (see FORM_CACHE). The whole window is one piece
//     where 9K <= 128 (ROWS = 3), else each window row is walked in pieces
//     (ROWS = 1, two or more pieces a row from K = 43); sweep 2, which
//     walks its window twice, keeps the one-piece mask for its second
//     walk. The form writes nothing but the step's outputs and scratch.
//   * FORM_CACHE (geom_cache "full"/"ring"/"partial"; replaces the JAX
//     package's geometry cache, cache_plan fused_cell.py:422, written
//     :663-674, read :743-762, :845-861, :1005-1022): a group of lanes
//     shares one anchor slot (Lanes, cache_sweep<S, G>): G0 = cg0 lanes
//     (4-32) in sweep 0, G = cg lanes (1-32) in sweeps 1-3, the wrapper's
//     CACHE_G0 and CACHE_G. Sweep 0 walks the window one row dy at a time
//     (for K > 42, 3K > 128, in pieces of 128 window positions, in the
//     kernels cache_sweep_wide), in two passes: every lane tests its share
//     of the row's candidates for validity (x, y only), the group ORs the
//     valid window positions into a bit mask, and the lanes then take the
//     valid candidates in window order, computing their geometry and
//     writing each to the slot's list: the candidate's halo'd-core index, ex, ey, r, dw*m1 and dw*mw (the
//     five _N_CACHE values), in tiles of T = 32/G slots, entry-major in a
//     tile (list_at), so that the 32 lanes of a warp of sweeps 1-3, which
//     hold the T slots of one tile, read 32 consecutive words at each step
//     of their walk. An anchor parked at x = 1e9
//     (an empty slot) has no valid candidate and skips the walk: the sums
//     it would take are +0. Sweeps 1-3 split the slot's list over the
//     lanes and read the candidates' fields from four halo'd float4
//     record cores that the anchors of the earlier sweeps fill
//     (CacheBufs::rec), one 16-byte load per record; sweep 1 reads the
//     list and does not write it. Per-anchor sums are lane partials summed
//     by an xor butterfly of shuffles (a fixed order, so launches repeat
//     bit for bit; no atomics); sweep 2's second pass needs the first
//     pass's sums, which the butterfly leaves in every lane; one lane
//     writes the anchor's outputs. Skipping an invalid candidate is exact:
//     every term it adds in sweeps 0-3 carries a w, m1 or mw factor that
//     is 0 for it, so it adds +-0 to a sum that is never -0. The TPU's
//     full and ring caches differ only in their VMEM schedule and the JAX
//     package holds them bit-identical; here both are one cache for every
//     anchor rank. "partial" caches ranks k < kcut and walks the window
//     for the rest (the split of _kloop_span, fused_cell.py:511-533), in
//     the same lane groups. The cache expressions follow the JAX cached
//     ones: sweep 1's rf = r * (dw*m1*Vol_j + dw*mw*Vol_j), where the
//     recompute form has r*dw*Vol_j*(m1+mw); sweeps 2-3 take
//     (dw*m1)*Vol_j and (dw*mw)*Vol_j, equal bit for bit to the recompute
//     form's (dw*Vol_j)*m1 and (dw*Vol_j)*mw (m1 and mw are exactly 0 or
//     1). The capacity is 9K entries per slot, so a list cannot overflow.
//     Bytes per valid pair and sweep: sweep 0 writes 24 (idx + five
//     floats); sweep 1 reads 24 of list and one 16-byte record; sweep 2
//     reads 24 of list and three records (48) in each of its two passes;
//     sweep 3 reads 20 of list (no r) and two records (32).
//   * FORM_ROWS (fused_rows "1"; the JAX package's candidate-row-outer
//     loop, _kernel_body_rows fused_cell.py:1081, whose (K, L) anchors
//     stay in registers while each candidate row is loaded once): one
//     block per tile of one cell row, TX = c.tx columns x all K ranks x
//     G = c.rg lanes per anchor slot (the wrapper's rows_tile; at most 1024
//     threads), slots in the (k, tx) order, G consecutive threads each. The
//     block stages its window once into shared memory: for each field the
//     sweep reads, the 3 candidate rows x the ranks below each row's
//     occupancy bound (none for the y-halo rows) x the TX+2 halo'd columns
//     from the tile's first, as tile[f][dy][j][col] with W = TX+2 words a
//     rank (InTile). Every group then walks its anchor's window as FORM_WIN
//     does (walk_window, the same two passes, order and sums), reading x
//     and y in pass 1 and every field in pass 2 from the tile, so its
//     outputs equal FORM_WIN's bit for bit. Pass 1's loads: the G lanes of
//     a group take u = 3j + dx, so a round reads words j*W + dx + tx, and
//     the warp's groups at neighbouring columns shift them by one; at the
//     tiles rows_tile picks they fall on distinct banks or share a word (a
//     broadcast), so W needs no padding (tests/test_torch_rows_tile.py).
//     Pass 2's words depend on which candidates are valid.
//
// What bounds it on this card: the working set (a few MB at dp=0.01) sits
// in the 50 MB L2, so HBM does not bound the sweeps. FORM_WIN puts G lanes
// on each anchor (G = 4 at dp=0.01: 218k threads; 16 at dp=0.025: 188k)
// and walks ~17 valid candidates in order, but tests every occupied
// candidate of the window in each sweep (pass 1: two loads a candidate,
// from L1/L2): its sweeps last about as long as the cache form's sweep 0,
// which walks the same window, and are bound by the latency of those
// loads and of the round's chain (geometry, field loads, shuffles), not
// by bytes or operations. FORM_ROWS walks the same window in the same
// lane groups from shared memory: each staged word serves the ~3*occ
// anchors of the tile that test it in pass 1, and the staging (one
// __syncthreads a block, (TX+2)/TX of the columns used) is its price.
// FORM_CACHE puts a group of lanes on each anchor
// (8 lanes: 437k threads at dp=0.01, more than the card holds at once) and
// walks ~17 valid candidates instead of 9K = 126 in sweeps 1-3; what
// bounds it then is the L1/L2 traffic of the candidate gathers:
// consecutive list entries of one anchor are mostly consecutive ranks of
// one cell, nx+2 words apart, so a warp's gather touches about G cache
// lines, where 32 lanes on 32 neighbouring anchors at one entry touch one
// or two; hence G for sweeps 1-3 apart from sweep 0's, and the records,
// which cut sweep 2's gathers per pair and pass from nine to three. The
// operations (utils/roofline.py) would take a few us. One launch per sweep (stream order is the grid-wide barrier the TPU
// got from its sequential grid), the chunk's step loop enqueued from the
// host in sph_chunk; v_max reaches each step's control through the
// previous step's refresh (block max, one integer atomicMax per block).
// Compiled without fast math and with --fmad=false so the arithmetic
// follows the plain PyTorch twin operation for operation; the remaining
// differences are the summation order and rsqrtf.
//
// Plain C interface, loaded with ctypes. Every entry point returns
// cudaGetLastError(); the Python wrapper raises when it is not 0.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

extern "C" {

struct SphConst {
  int nyp, K, nx, R;
  int kcut;  // FORM_CACHE: anchor ranks k < kcut use the cache (K: all)
  int ncs;   // cached slots: nyp * kcut * nx
  int tx;    // FORM_ROWS: tile width in cell columns (tx * K * rg <= 1024)
  int cg0;   // FORM_CACHE: lanes per anchor slot in sweep 0 (4 .. 32)
  int cg;    // FORM_CACHE: lanes per anchor slot in sweeps 1-3 (1 .. 32)
  int wg;    // FORM_WIN: lanes per anchor slot (4 .. 32)
  int rg;    // FORM_ROWS: lanes per anchor slot (4 .. 32)
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

// the geometry cache (FORM_CACHE): 9K entries per cached slot in tiles of
// T = 32/cg slots, entry-major in a tile (entry e of cached slot s at
// list_at(s, e)), + (ncs,) counts
struct CacheBufs {
  int* idx;           // halo'd-core index of the candidate
  float *ex, *ey, *r;
  float *c1, *cw;     // dw*m1, dw*mw
  int* n;             // valid candidates per cached slot
  // four halo'd record cores (4 x (nyp+2)*K*(nx+2) float4): what sweeps
  // 1-3 read of a listed candidate, one 16-byte load per record:
  // A = {vol, rhoH, pH, vx}, B = {vy, wvx, wvy, 0} (sweep 0),
  // C = {b11, b12, b21, b22} (sweep 1), D = {vx2, vy2, wvx, wvy} (sweep 2)
  float4* rec;
};

struct ShearBufs {
  const float *x, *y, *isf, *vol, *vx, *b11, *b12, *b21, *b22, *wvx, *wbot,
      *wtop;
  const int* occ;
  const int* rows;    // the cell rows whose window holds a wall slot
  float *tb, *tt;     // plain per-slot partial sums (bottom / top wall)
  float mu, wf;
  int nrows;
};

}  // extern "C"

namespace {

// half of the x fill of empty slots (_BIG_X = 1e9): an anchor at or past it
// is an empty slot
constexpr float kParked = 5e8f;

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

// FORM_CACHE: entry e of cached slot cs. A warp of sweeps 1-3 holds the
// T = 32/cg slots of one tile, lane l of a slot reading entries l, l+cg,
// ...: its 32 loads of one step of the walk are 32 consecutive words.
__device__ __forceinline__ int list_at(const SphConst& c, int cs, int e) {
  const int T = 32 / c.cg;
  return (cs / T) * (T * 9 * c.K) + e * T + cs % T;
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

// anchor slot i of the (iy, k, ix) order, ix fastest
__device__ __forceinline__ bool slot_at(const SphConst& c, const int* occ,
                                        Slot& s, int i) {
  if (i >= c.nyp * c.K * c.nx) return false;
  s.ix = i % c.nx;
  int rest = i / c.nx;
  s.k = rest % c.K;
  s.iy = rest / c.K;
  s.ha = hix(c, s.iy + 1, s.k, s.ix + 1);
  s.visited = s.k < occ[s.iy / c.R];
  return true;
}

// FORM_CACHE, FORM_WIN and FORM_ROWS: G lanes (a power of two <= 32) share one anchor
// slot. In FORM_CACHE a per-anchor sum is the xor-butterfly of the lanes'
// partial sums: a fixed order, and every lane ends with the same bits (a +
// b == b + a). FORM_WIN adds the terms in window order instead (geo_sum
// below).
template <int G>
struct Lanes {
  int lane;       // 0 .. G-1
  unsigned mask;  // the group's lanes in the warp
  __device__ __forceinline__ float sum(float v) const {
    for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o, G);
    return v;
  }
  __device__ __forceinline__ bool lead() const { return lane == 0; }
};

// slots in the (iy, k, ix) order of slot_at, G consecutive threads each;
// a 128-thread block holds whole groups, so a group never straddles warps
template <int G>
__device__ __forceinline__ bool group_slot(const SphConst& c, const int* occ,
                                           Slot& s, Lanes<G>& g) {
  const int wl = threadIdx.x & 31;
  g.lane = wl & (G - 1);
  g.mask = G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (wl & ~(G - 1));
  return slot_at(c, occ, s, (blockIdx.x * blockDim.x + threadIdx.x) / G);
}

// FORM_ROWS: block = (cell row iy, tile of c.tx columns from x0), its
// slots in the (k, tx) order, G consecutive threads each (blockDim.x =
// c.tx * K * G, so a group never straddles warps); false for the columns
// of the last tile past nx
template <int G>
__device__ __forceinline__ bool tile_slot(const SphConst& c, const int* occ,
                                          Slot& s, Lanes<G>& g, int& x0) {
  const int tiles = (c.nx + c.tx - 1) / c.tx;
  s.iy = blockIdx.x / tiles;
  x0 = (blockIdx.x - s.iy * tiles) * c.tx;
  const int wl = threadIdx.x & 31;
  g.lane = wl & (G - 1);
  g.mask = G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (wl & ~(G - 1));
  const int a = threadIdx.x / G;
  s.k = a / c.tx;
  s.ix = x0 + (a - s.k * c.tx);
  if (s.ix >= c.nx) return false;
  s.ha = hix(c, s.iy + 1, s.k, s.ix + 1);
  s.visited = s.k < occ[s.iy / c.R];
  return true;
}

// a window walk's bit mask of kPiece window positions (walk_window)
constexpr int kMaskWords = 4;
constexpr int kPiece = 32 * kMaskWords;

struct WinMask {
  unsigned m[kMaskWords];
  bool set;
};

// ---- candidate sources ----
// Each gives the fields of a candidate (ld), its per-anchor sum (sum: the
// cache form's lane butterfly; the window forms' sums are their own, see
// geo_sum) and whether this thread writes the anchor's outputs (lead).

// the anchor-rank bound of halo'd cell row `row` (0 for the y-halo rows,
// which hold empty slots only)
__device__ __forceinline__ int row_occ(const SphConst& c, const int* occ,
                                       int row) {
  return row >= 1 && row <= c.nyp ? occ[(row - 1) / c.R] : 0;
}

// Where a window's candidates live: candidate (window row dy, rank j,
// column dx) of the anchor is at(dy, j, dx), and ld<F>(b, i) is field F
// there. InCores: the halo'd cores, the anchor at halo'd (iy+1, ix+1)
// (FORM_WIN, the wide cache kernels, the shear).
struct InCores {
  int K, nx2, iy, ix;
  __device__ __forceinline__ int at(int dy, int j, int dx) const {
    return ((iy + dy) * K + j) * nx2 + ix + dx;
  }
  template <int F>
  __device__ __forceinline__ float ld(const StepBufs& b, int i) const {
    return core<F>(b)[i];
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
  // FORM_ROWS: copy the block's window into its tile, tile[f][dy][j][col]
  // (W = c.tx+2 words a rank, 3*K*W a field): for each field, halo'd cell
  // rows iy .. iy+2, the ranks below each row's occupancy bound (the only
  // ones the walk tests) and the halo'd columns x0 .. x0+W-1 inside the
  // core; the rest of the tile is never read. A thread takes one (rank,
  // column) of the rows and loads every field there before it stores
  // them, so all of a thread's loads are in flight at once, and it decodes
  // its place with one division
  __device__ static void stage(const SphConst& c, const StepBufs& b,
                               float* sm, int iy, int x0) {
    const float* src[n] = {core<Fs>(b)...};
    const int W = c.tx + 2, cols = min(W, c.nx + 2 - x0);
    int jn[3];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) jn[dy] = row_occ(c, b.occ, iy + dy);
    const int jm = max(jn[0], max(jn[1], jn[2]));
    for (int t = threadIdx.x; t < jm * cols; t += blockDim.x) {
      const int j = t / cols, col = t - j * cols;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        if (j >= jn[dy]) continue;
        const int g = hix(c, iy + dy, j, x0 + col);
        float v[n];
#pragma unroll
        for (int f = 0; f < n; ++f) v[f] = src[f][g];
#pragma unroll
        for (int f = 0; f < n; ++f)
          sm[((f * 3 + dy) * c.K + j) * W + col] = v[f];
      }
    }
  }
};

using Fields0 = FieldSet<F_X, F_Y, F_ISF, F_MASS>;
using Fields1 = FieldSet<F_X, F_Y, F_ISF, F_VOL>;
using Fields2 = FieldSet<F_X, F_Y, F_ISF, F_VOL, F_VX, F_VY, F_B11, F_B12,
                         F_B21, F_B22, F_RHOH, F_PH, F_WVX, F_WVY>;
using Fields3 = FieldSet<F_X, F_Y, F_ISF, F_VOL, F_VX2, F_VY2, F_WVX, F_WVY>;

// InTile: the block's staged tile (FORM_ROWS; FieldSet::stage), K ranks a
// row, W words a rank, the anchor at tile column tx
template <class FS>
struct InTile {
  const float* sm;
  int K, W, tx;
  __device__ __forceinline__ int at(int dy, int j, int dx) const {
    return (dy * K + j) * W + tx + dx;
  }
  template <int F>
  __device__ __forceinline__ float ld(const StepBufs&, int i) const {
    constexpr int f = FS::template at<F>();
    static_assert(f >= 0, "field not staged for this sweep");
    return sm[f * 3 * K * W + i];
  }
};

// FORM_WIN and FORM_ROWS: the anchor's window, walked by its group of G
// lanes (walk_window) where P says (InCores, InTile); ROWS: window rows per
// piece of the walk (3 when the whole window fits one piece, 9K <= 128,
// else 1); memo: the window's mask, kept by a sweep's first walk for its
// second (ROWS = 3)
template <int G, int ROWS, class P>
struct LWin : Lanes<G> {
  const SphConst& c;
  const StepBufs& b;
  int iy;
  P place;
  mutable WinMask memo{};
  template <int F>
  __device__ __forceinline__ float ld(int i) const {
    return place.template ld<F>(b, i);
  }
};

// FORM_CACHE: the anchor's window, walked by the group (geo_each below);
// REC: sweep 0 of a cached slot, which writes the list (cs: the slot's
// index among the cached slots); WIDE: a window row holds more than 128
// candidates (K > 42), walked in pieces
template <int G, bool REC, bool WIDE>
struct GWin : Lanes<G> {
  const SphConst& c;
  const StepBufs& b;
  const CacheBufs& cb;
  int iy, ix, cs;
  template <int F>
  __device__ __forceinline__ float ld(int i) const { return core<F>(b)[i]; }
};

// FORM_CACHE: the cached slot's list of valid candidates, lane l taking
// entries l, l+G, ...; sweep S reads the candidates' fields from the
// records the earlier sweeps wrote
template <int G, int S>
struct GList : Lanes<G> {
  const SphConst& c;
  const StepBufs& b;
  const CacheBufs& cb;
  int cs;
  __device__ __forceinline__ float4 rec(int q, int i) const {
    return cb.rec[q * ((c.nyp + 2) * c.K * (c.nx + 2)) + i];
  }
  template <int F>
  __device__ __forceinline__ float ld(int i) const {
    if constexpr (F == F_VOL) return rec(0, i).x;
    else if constexpr (F == F_RHOH) return rec(0, i).y;
    else if constexpr (F == F_PH) return rec(0, i).z;
    else if constexpr (F == F_VX) return rec(0, i).w;
    else if constexpr (F == F_VY) return rec(1, i).x;
    else if constexpr (F == F_WVX) return S == 3 ? rec(3, i).z : rec(1, i).y;
    else if constexpr (F == F_WVY) return S == 3 ? rec(3, i).w : rec(1, i).z;
    else if constexpr (F == F_B11) return rec(2, i).x;
    else if constexpr (F == F_B12) return rec(2, i).y;
    else if constexpr (F == F_B21) return rec(2, i).z;
    else if constexpr (F == F_B22) return rec(2, i).w;
    else if constexpr (F == F_VX2) return rec(3, i).x;
    else if constexpr (F == F_VY2) return rec(3, i).y;
    else return core<F>(b)[i];
  }
};

// the anchor's record(s) that sweep S feeds, with their wrapped x-halo
// copies (as store_h writes the cores), from the values the sweep stored
template <int S>
__device__ __forceinline__ void store_rec(const SphConst& c,
                                          const StepBufs& b,
                                          const CacheBufs& cb,
                                          const Slot& s) {
  const int nh = (c.nyp + 2) * c.K * (c.nx + 2), ha = s.ha;
  float4 v[2];
  int q0, nq = 1;
  if constexpr (S == 0) {
    v[0] = make_float4(b.vol[ha], b.rhoH[ha], b.pH[ha], b.vx[ha]);
    v[1] = make_float4(b.vy[ha], b.wvx[ha], b.wvy[ha], 0.0f);
    q0 = 0;
    nq = 2;
  } else if constexpr (S == 1) {
    v[0] = make_float4(b.b11[ha], b.b12[ha], b.b21[ha], b.b22[ha]);
    q0 = 2;
  } else {
    v[0] = make_float4(b.vx2[ha], b.vy2[ha], b.wvx[ha], b.wvy[ha]);
    q0 = 3;
  }
  int at[3] = {ha, -1, -1};
  if (c.nx >= 3) {
    if (s.ix == c.nx - 1) at[1] = hix(c, s.iy + 1, s.k, 0);
    if (s.ix == 0) at[2] = hix(c, s.iy + 1, s.k, c.nx + 1);
  }
  for (int q = 0; q < nq; ++q)
    for (int a = 0; a < 3; ++a)
      if (at[a] >= 0) cb.rec[(q0 + q) * nh + at[a]] = v[q];
}

// ---- the pair loops of the sweeps, per source ----

// the window position of set bit p (p < popcount) of a piece's mask
__device__ __forceinline__ int nth_bit(const unsigned (&m)[kMaskWords],
                                       int p) {
  int base = 0;
#pragma unroll
  for (int w = 0; w < kMaskWords; ++w) {
    const int cw = __popc(m[w]);
    if (p < cw) return base + __fns(m[w], 0, p + 1);
    p -= cw;
    base += 32;
  }
  return -1;
}

// The group's walk of an anchor's window (FORM_WIN's and FORM_ROWS's sweeps,
// the wide cache kernels for K > 42, the shear), the candidates where
// `place` says (InCores, InTile), ROWS window rows a span (3 where the
// whole window fits one piece, 9K <= 128; else 1), in pieces of kPiece =
// 32*kMaskWords window positions (w = (dr*3 + dx)*K + j over the rows dr
// of the span; two pieces a row from K = 43), in two passes per piece.
// Pass 1 takes the span's rows one at a time and tests (test(i)) the
// candidates of ranks below the row's occupancy bound (occ of its row
// group; the ranks past it and the y-halo rows hold empty slots, x = 1e9,
// which no test passes), the lanes taking them dx fastest, so that the
// group's loads fall on few cache lines, and ORs the piece's positions that
// pass into a bit mask that every lane of the group then holds. Pass 2
// takes them in window order, lane l the l-th, (l+G)-th ..., decoding a
// position with compares, not divisions: fn(on, i, p) is called by every
// lane of the group in step, with on set where the lane holds a candidate,
// i its place (place.at: its halo'd-core or tile index) and p its position
// among the window's listed candidates. Spans and pieces are taken in
// window order, so the listed candidates keep the (dy, dx, j) window order
// for every K. With memo (ROWS = 3), the window's mask is kept by the
// first walk and used by the next with the same test, which skips pass 1
// (the window forms' sweep 2 walks its window twice). Returns how many
// were listed.
template <int G, int ROWS, class P, class Test, class Fn>
__device__ __forceinline__ int walk_window(const SphConst& c, const int* occ,
                                           const Lanes<G>& g, int iy,
                                           const P& place, WinMask* memo,
                                           Test&& test, Fn&& fn) {
  const int K = c.K, R3 = 3 * K, W = ROWS * R3;
  int n = 0;
  for (int dy0 = 0; dy0 < 3; dy0 += ROWS) {
    for (int b0 = 0; b0 < W; b0 += kPiece) {
      unsigned m[kMaskWords] = {};
      if (ROWS == 3 && memo && memo->set) {
#pragma unroll
        for (int q = 0; q < kMaskWords; ++q) m[q] = memo->m[q];
      } else {
        for (int dr = 0; dr < ROWS; ++dr) {
          const int jn = row_occ(c, occ, iy + dy0 + dr);  // halo'd cell row
#pragma unroll 1
          for (int u = g.lane; u < 3 * jn; u += G) {
            const int j = u / 3, dx = u - 3 * j;
            const int w = dr * R3 + dx * K + j - b0;
            if (W > kPiece && (w < 0 || w >= kPiece)) continue;
            if (test(place.at(dy0 + dr, j, dx))) {
#pragma unroll
              for (int q = 0; q < kMaskWords; ++q)
                if ((w >> 5) == q) m[q] |= 1u << (w & 31);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < kMaskWords; ++q)
          for (int o = G / 2; o > 0; o >>= 1)
            m[q] |= __shfl_xor_sync(g.mask, m[q], o, G);
        if (ROWS == 3 && memo) {
#pragma unroll
          for (int q = 0; q < kMaskWords; ++q) memo->m[q] = m[q];
          memo->set = true;
        }
      }
      int cnt = 0;
#pragma unroll
      for (int q = 0; q < kMaskWords; ++q) cnt += __popc(m[q]);
      for (int p0 = 0; p0 < cnt; p0 += G) {
        const int p = p0 + g.lane;
        int i = -1;
        if (p < cnt) {
          const int w = b0 + nth_bit(m, p);
          const int dr = ROWS == 1 ? 0 : (w >= R3) + (w >= 2 * R3);
          const int u = w - dr * R3;
          const int dx = (u >= K) + (u >= 2 * K), j = u - dx * K;
          i = place.at(dy0 + dr, j, dx);
        }
        fn(p < cnt, i, n + p);
      }
      n += cnt;
    }
  }
  return n;
}

// pass 1's validity test: the r^2 window test of geometry()
__device__ __forceinline__ bool in_range(const SphConst& c, float xa,
                                         float ya, float xv, float yv) {
  float ddx = xa - xv;
  if (c.nx < 3) ddx = ddx - c.DL * rintf(ddx / c.DL);
  const float ddy = ya - yv;
  const float r2 = ddx * ddx + ddy * ddy;
  return r2 < c.cut2 && r2 > 1e-24f;
}

// FORM_CACHE: the group's window walk, one window row dy at a time, in
// two passes. Pass 1 tests every candidate of the row for validity, the
// lanes taking them dx fastest, so that the group's loads fall on few cache
// lines, and ORs the valid window positions into a bit mask that every lane
// of the group then holds. Pass 2 takes the valid candidates in window
// order, lane l the l-th, (l+G)-th ...: their geometry reaches fn and, with
// REC, entry n + p of the list. Only valid candidates reach fn: an invalid
// one adds +-0 to sums that start at +0 (see the note above). An anchor
// parked at x = 1e9 (an empty slot) has no valid candidate, so it skips the
// walk. A row of 3K <= 128 candidates fits one mask; WIDE (K > 42) walks
// each row in pieces of 128 window positions (walk_window), in window
// order, so the list is the same. The two are kept apart, each in its own
// kernel (cache_sweep, cache_sweep_wide): sharing one walk cost the narrow
// kernels their spill-free registers and 3-15% of their time.
template <int G, bool REC, bool WIDE, class Fn>
__device__ __forceinline__ void geo_each(const SphConst& c,
                                         const GWin<G, REC, WIDE>& src,
                                         float xa, float ya, bool need_w,
                                         Fn&& fn) {
  const CacheBufs& cb = src.cb;
  const StepBufs& b = src.b;
  const int K = c.K;
  int n = 0;
  if (xa < kParked) {
    if constexpr (WIDE) {
      n = walk_window<G, 1>(
          c, b.occ, src, src.iy, InCores{K, c.nx + 2, src.iy, src.ix},
          nullptr,
          [&](int i) { return in_range(c, xa, ya, b.x[i], b.y[i]); },
          [&](bool on, int i, int p) {
            if (!on) return;
            const Geo g = geometry(c, xa, ya, b.x[i], b.y[i], b.isf[i],
                                   need_w);
            fn(i, g);
            if constexpr (REC) {
              const int e = list_at(c, src.cs, p);
              cb.idx[e] = i;
              cb.ex[e] = g.ex;
              cb.ey[e] = g.ey;
              cb.r[e] = g.r;
              cb.c1[e] = g.dw * g.m1;
              cb.cw[e] = g.dw * g.mw;
            }
          });
    } else {
      for (int dy = 0; dy < 3; ++dy) {
        const int row = (src.iy + dy) * K;
        unsigned m[kMaskWords] = {};
        for (int t = src.lane; t < 3 * K; t += G) {
          const int j = t / 3, dx = t - 3 * j;
          const int i = (row + j) * (c.nx + 2) + src.ix + dx;
          float ddx = xa - b.x[i];
          if (c.nx < 3) ddx = ddx - c.DL * rintf(ddx / c.DL);
          const float ddy = ya - b.y[i];
          const float r2 = ddx * ddx + ddy * ddy;
          if (r2 < c.cut2 && r2 > 1e-24f) {
            const int w = dx * K + j;
#pragma unroll
            for (int q = 0; q < kMaskWords; ++q)
              if ((w >> 5) == q) m[q] |= 1u << (w & 31);
          }
        }
        int cnt = 0;
#pragma unroll
        for (int q = 0; q < kMaskWords; ++q) {
          for (int o = G / 2; o > 0; o >>= 1)
            m[q] |= __shfl_xor_sync(src.mask, m[q], o, G);
          cnt += __popc(m[q]);
        }
        for (int p = src.lane; p < cnt; p += G) {
          const int w = nth_bit(m, p);
          const int dx = w / K, j = w - dx * K;
          const int i = (row + j) * (c.nx + 2) + src.ix + dx;
          const Geo g = geometry(c, xa, ya, b.x[i], b.y[i], b.isf[i],
                                 need_w);
          fn(i, g);
          if constexpr (REC) {
            const int e = list_at(c, src.cs, n + p);
            cb.idx[e] = i;
            cb.ex[e] = g.ex;
            cb.ey[e] = g.ey;
            cb.r[e] = g.r;
            cb.c1[e] = g.dw * g.m1;
            cb.cw[e] = g.dw * g.mw;
          }
        }
        n += cnt;
      }
    }
  }
  if constexpr (REC) {
    if (src.lead()) cb.n[src.cs] = n;
  }
}

// sweep 1: (rf, ex, ey) per pair, rf = r*dw*Vol_j*(m1+mw)
template <class Src, class Fn>
__device__ __forceinline__ void kgc_each(const SphConst& c, const Src& src,
                                         float xa, float ya, Fn&& fn) {
  geo_each(c, src, xa, ya, false, [&](int i, const Geo& g) {
    fn(g.r * g.dw * src.template ld<F_VOL>(i) * (g.m1 + g.mw), g.ex, g.ey);
  });
}

// FORM_CACHE sweep 1 from the list: rf = r*(dw*m1*Vol_j + dw*mw*Vol_j),
// the JAX cached association (fused_cell.py:743-762)
template <int G, int S, class Fn>
__device__ __forceinline__ void kgc_each(const SphConst& c,
                                         const GList<G, S>& src, float, float,
                                         Fn&& fn) {
  const CacheBufs& cb = src.cb;
  const int n = cb.n[src.cs];
  for (int t = src.lane; t < n; t += G) {
    const int e = list_at(c, src.cs, t);
    const float volv = src.template ld<F_VOL>(cb.idx[e]);
    fn(cb.r[e] * (cb.c1[e] * volv + cb.cw[e] * volv), cb.ex[e], cb.ey[e]);
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

// FORM_CACHE sweeps 2-3 from the list: dw*m1*Vol_j and dw*mw*Vol_j are
// the products the recompute form forms (m1 and mw are exactly 0 or 1)
template <int G, int S, class Fn>
__device__ __forceinline__ void pair_each(const SphConst& c,
                                          const GList<G, S>& src, float,
                                          float, Fn&& fn) {
  const CacheBufs& cb = src.cb;
  const int n = cb.n[src.cs];
  for (int t = src.lane; t < n; t += G) {
    const int e = list_at(c, src.cs, t);
    const int i = cb.idx[e];
    const float volv = src.template ld<F_VOL>(i);
    fn(i, cb.r[e], cb.ex[e], cb.ey[e], cb.c1[e] * volv, cb.cw[e] * volv);
  }
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
    s_in = src.sum(s_in);
    s_ct = src.sum(s_ct);
    s_m1 = src.sum(s_m1);
    s_mw = src.sum(s_mw);
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
  if (!src.lead()) return;
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
    a11 = -src.sum(a11);
    a12 = -src.sum(a12);
    a22 = -src.sum(a22);
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
  if (!src.lead()) return;
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
    acc_x = src.sum(acc_x);
    acc_y = src.sum(acc_y);
    inc_x = src.sum(inc_x);
    inc_y = src.sum(inc_y);
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
    pacc_x = src.sum(pacc_x);
    pacc_y = src.sum(pacc_y);
    fx = fl ? -pacc_x * vola : 0.0f;
    fy = fl ? -pacc_y * vola : 0.0f;
    const float inv_m = 1.0f / mass_safe;
    vx2 = fl ? vxa + (fpx + fx) * inv_m * dt : 0.0f;
    vy2 = fl ? vya + (fpy + fy) * inv_m * dt : 0.0f;
  }
  if (!src.lead()) return;
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
    rate = src.sum(rate);
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
  if (!src.lead()) return;
  b.rho[p] = rho_new;
  b.p[p] = p_new;
  b.drho[p] = drho_new;
  b.x2[p] = x2;
  b.y2[p] = y2;
}

// ---- FORM_WIN and FORM_ROWS: the sweeps' bodies again, with the pair
//      terms handed to the lane group's ordered sums (geo_sum, kgc_sum,
//      pair_sum below), over a window that lives where LWin's place says
//      (the halo'd cores or the block's tile). They repeat body0..body3's
//      arithmetic operation for operation; body0..body3 stay as they are
//      for the cache form: written over these, its kernels compiled to
//      other code (its sweep 0 ran 8% slower). ----

// The window forms: the group walks the anchor's window (walk_window), each lane
// computes the terms of the valid candidate it holds, and every lane adds
// the round's terms in window order, lane 0's first: the shuffles give all
// lanes the same values, so all end with the same sums, and those are the
// sums of a one-thread walk over all 9K candidates in window order bit for
// bit on a finite state (an invalid candidate's terms are +-0, which leave
// a sum that starts at +0 as it is). An anchor parked at x = 1e9 (an empty
// slot) has no valid candidate: its sums stay +0.
template <int N, int G, int ROWS, class P, class Fn>
__device__ __forceinline__ void geo_sum(const SphConst& c,
                                        const LWin<G, ROWS, P>& src,
                                        float xa, float ya, bool need_w,
                                        float (&s)[N], Fn&& fn) {
  if (xa >= kParked) return;
  walk_window<G, ROWS>(
      c, src.b.occ, src, src.iy, src.place, &src.memo,
      [&](int i) {
        return in_range(c, xa, ya, src.template ld<F_X>(i),
                        src.template ld<F_Y>(i));
      },
      [&](bool on, int i, int) {
        float t[N];
#pragma unroll
        for (int q = 0; q < N; ++q) t[q] = 0.0f;
        if (on)
          fn(i,
             geometry(c, xa, ya, src.template ld<F_X>(i),
                      src.template ld<F_Y>(i), src.template ld<F_ISF>(i),
                      need_w),
             t);
        // the lanes that hold a candidate are lanes 0 .. m-1
        const int m = __popc(__ballot_sync(src.mask, on) & src.mask);
        for (int l = 0; l < m; ++l) {
#pragma unroll
          for (int q = 0; q < N; ++q)
            s[q] += __shfl_sync(src.mask, t[q], l, G);
        }
      });
}

// sweep 1: (rf, ex, ey) per pair, rf = r*dw*Vol_j*(m1+mw)
template <int N, int G, int ROWS, class P, class Fn>
__device__ __forceinline__ void kgc_sum(const SphConst& c,
                                        const LWin<G, ROWS, P>& src, float xa,
                                        float ya, float (&s)[N], Fn&& fn) {
  geo_sum(c, src, xa, ya, false, s,
          [&](int i, const Geo& g, auto& t) {
            fn(g.r * g.dw * src.template ld<F_VOL>(i) * (g.m1 + g.mw), g.ex,
               g.ey, t);
          });
}

// sweeps 2-3: (i, r, ex, ey, dw*Vol_j*m1, dw*Vol_j*mw) per pair
template <int N, int G, int ROWS, class P, class Fn>
__device__ __forceinline__ void pair_sum(const SphConst& c,
                                         const LWin<G, ROWS, P>& src, float xa,
                                         float ya, float (&s)[N], Fn&& fn) {
  geo_sum(c, src, xa, ya, false, s,
          [&](int i, const Geo& g, auto& t) {
            const float dwv = g.dw * src.template ld<F_VOL>(i);
            fn(i, g.r, g.ex, g.ey, dwv * g.m1, dwv * g.mw, t);
          });
}

// ---- sweep 0: density, Vol, half-kick EOS, pair count
//      (sph_physics_mex.c:178-234, :857-865; fused_cell.py:643-729) ----
template <int G, int ROWS, class P>
__device__ __forceinline__ void body0(const SphConst& c, const StepBufs& b,
                                      const Slot& s,
                                      const LWin<G, ROWS, P>& src) {
  float vol = 0.0f, rho_half = 0.0f, p_half = 0.0f, cnt = 0.0f;
  if (s.visited) {
    const float dt = b.dyn[0];
    const float xa = b.x[s.ha], ya = b.y[s.ha], af = b.isf[s.ha];
    float sums[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    geo_sum(c, src, xa, ya, true, sums,
            [&](int i, const Geo& g, auto& t) {
              t[0] = g.w * g.m1;
              t[1] = g.w * (src.template ld<F_MASS>(i) * c.inv_rho0) * g.mw;
              t[2] = g.m1;
              t[3] = g.mw;
            });
    const float s_in = sums[0], s_ct = sums[1], s_m1 = sums[2],
                s_mw = sums[3];
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
  if (!src.lead()) return;
  store_h(c, b.vol, s.iy, s.k, s.ix, vol);
  store_h(c, b.rhoH, s.iy, s.k, s.ix, rho_half);
  store_h(c, b.pH, s.iy, s.k, s.ix, p_half);
  b.cnt[pix(c, s.iy, s.k, s.ix)] = cnt;
}

// ---- sweep 1: kernel gradient correction B (c:239-365;
//      fused_cell.py:731-816) ----
template <int G, int ROWS, class P>
__device__ __forceinline__ void body1(const SphConst& c, const StepBufs& b,
                                      const Slot& s,
                                      const LWin<G, ROWS, P>& src) {
  float o11 = 0.0f, o12 = 0.0f, o21 = 0.0f, o22 = 0.0f;
  if (s.visited) {
    const float xa = b.x[s.ha], ya = b.y[s.ha], af = b.isf[s.ha];
    float sums[3] = {0.0f, 0.0f, 0.0f};
    kgc_sum(c, src, xa, ya, sums,
            [&](float rf, float ex, float ey, auto& t) {
              t[0] = rf * ex * ex;
              t[1] = rf * ex * ey;
              t[2] = rf * ey * ey;
            });
    const float a11 = -sums[0], a12 = -sums[1], a22 = -sums[2];
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
  if (!src.lead()) return;
  store_h(c, b.b11, s.iy, s.k, s.ix, o11);
  store_h(c, b.b12, s.iy, s.k, s.ix, o12);
  store_h(c, b.b21, s.iy, s.k, s.ix, o21);
  store_h(c, b.b22, s.iy, s.k, s.ix, o22);
}

// ---- sweep 2: viscous + gravity, shifting, Riemann pressure, kick
//      (c:466-545, :633-709, :867-957, :1388-1409;
//      fused_cell.py:818-965). Two candidate passes: the virtual wall
//      pressure needs the anchor's completed prior force. ----
template <int G, int ROWS, class P>
__device__ __forceinline__ void body2(const SphConst& c, const StepBufs& b,
                                      const Slot& s,
                                      const LWin<G, ROWS, P>& src) {
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

    float s1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    pair_sum(c, src, xa, ya, s1, [&](int i, float r, float ex, float ey,
                                     float dwv1, float dwvw, auto& t) {
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
      t[0] = cf_p * (vxa - src.template ld<F_VX>(i)) +
             cw_p * (vxa - src.template ld<F_WVX>(i));
      t[1] = cf_p * (vya - src.template ld<F_VY>(i)) +
             cw_p * (vya - src.template ld<F_WVY>(i));
      t[2] = -dwv1 * tx_f - 2.0f * dwvw * tx_w;
      t[3] = -dwv1 * ty_f - 2.0f * dwvw * ty_w;
    });
    const float acc_x = s1[0], acc_y = s1[1], inc_x = s1[2], inc_y = s1[3];
    const bool fl = af > 0.0f;
    fpx = fl ? acc_x * vola + massa * g : 0.0f;
    fpy = fl ? acc_y * vola : 0.0f;
    const float lim = fminf(
        fmaxf(100.0f * (inc_x * inc_x + inc_y * inc_y) / c.hh, 0.0f), 1.0f);
    const float shift = c.tchh * lim * af;
    dxs = shift * inc_x;
    dys = shift * inc_y;

    const float ax_prior = fpx / mass_safe, ay_prior = fpy / mass_safe;
    float s2[2] = {0.0f, 0.0f};
    pair_sum(c, src, xa, ya, s2, [&](int i, float r, float ex, float ey,
                                     float dwv1, float dwvw, auto& t) {
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
      t[0] = p_face * tx_f * dwv1 + (pha + p_wall) * tx_w * dwvw;
      t[1] = p_face * ty_f * dwv1 + (pha + p_wall) * ty_w * dwvw;
    });
    const float pacc_x = s2[0], pacc_y = s2[1];
    fx = fl ? -pacc_x * vola : 0.0f;
    fy = fl ? -pacc_y * vola : 0.0f;
    const float inv_m = 1.0f / mass_safe;
    vx2 = fl ? vxa + (fpx + fx) * inv_m * dt : 0.0f;
    vy2 = fl ? vya + (fpy + fy) * inv_m * dt : 0.0f;
  }
  if (!src.lead()) return;
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
template <int G, int ROWS, class P>
__device__ __forceinline__ void body3(const SphConst& c, const StepBufs& b,
                                      const Slot& s,
                                      const LWin<G, ROWS, P>& src) {
  const int ha = s.ha, p = pix(c, s.iy, s.k, s.ix);
  const float xa = b.x[ha], ya = b.y[ha];
  float rho_new = 0.0f, p_new = 0.0f, drho_new = 0.0f, x2 = xa, y2 = ya;
  if (s.visited) {
    const float dt = b.dyn[0];
    const float af = b.isf[ha];
    const float vx2a = b.vx2[ha], vy2a = b.vy2[ha];
    const float rhoha = b.rhoH[ha];
    float s1[1] = {0.0f};
    pair_sum(c, src, xa, ya, s1, [&](int i, float, float ex, float ey,
                                     float dwv1, float dwvw, auto& t) {
      const float u_jump_f = (vx2a - src.template ld<F_VX2>(i)) * ex +
                             (vy2a - src.template ld<F_VY2>(i)) * ey;
      const float u_jump_w =
          2.0f * ((vx2a - src.template ld<F_WVX>(i)) * ex +
                  (vy2a - src.template ld<F_WVY>(i)) * ey);
      t[0] = u_jump_f * dwv1 + u_jump_w * dwvw;
    });
    const float rate = s1[0];
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
  if (!src.lead()) return;
  b.rho[p] = rho_new;
  b.p[p] = p_new;
  b.drho[p] = drho_new;
  b.x2[p] = x2;
  b.y2[p] = y2;
}

template <int S, class Src>
__device__ __forceinline__ void body(const SphConst& c, const StepBufs& b,
                                     const Slot& s, const Src& src) {
  if constexpr (S == 0) body0(c, b, s, src);
  else if constexpr (S == 1) body1(c, b, s, src);
  else if constexpr (S == 2) body2(c, b, s, src);
  else body3(c, b, s, src);
}

// the fields sweep S reads from its candidates
template <int S>
using SweepFields = std::conditional_t<
    S == 0, Fields0,
    std::conditional_t<S == 1, Fields1,
                       std::conditional_t<S == 2, Fields2, Fields3>>>;

// FORM_WIN sweep S, G lanes per anchor slot (slots in the (iy, k, ix)
// order, ix fastest). The walk is latency-bound, so the kernels are held
// to 64 registers (eight blocks of 128 threads an SM) and pass 1 is not
// unrolled: more warps in flight beat the few spills that costs, at
// dp=0.01 and 0.025 (PERF.md; the compiler's own budget was up to 96)
template <int S, int G, int ROWS>
__global__ void __launch_bounds__(128, 8)
    win_sweep(SphConst c, StepBufs b) {
  if (b.dyn[4] == 0.0f) return;  // the chunk's interval or n_sub is done
  Slot s;
  Lanes<G> g;
  if (!group_slot<G>(c, b.occ, s, g)) return;
  body<S>(c, b, s,
          LWin<G, ROWS, InCores>{g, c, b, s.iy,
                                 {c.K, c.nx + 2, s.iy, s.ix}});
}

// FORM_ROWS sweep S, G lanes per anchor slot: the block stages its window
// into shared memory, then each group walks its anchor's window from
// there. At most 1024 threads a block, so at most 64 registers a thread,
// the recompute kernels' budget
template <int S, int G, int ROWS>
__global__ void __launch_bounds__(1024)
    rows_sweep(SphConst c, StepBufs b) {
  if (b.dyn[4] == 0.0f) return;  // the chunk's interval or n_sub is done
  using FS = SweepFields<S>;
  extern __shared__ float tile_sm[];
  Slot s;
  Lanes<G> g;
  int x0;
  const bool on = tile_slot<G>(c, b.occ, s, g, x0);
  FS::stage(c, b, tile_sm, s.iy, x0);
  __syncthreads();
  if (on)
    body<S>(c, b, s,
            LWin<G, ROWS, InTile<FS>>{g, c, b, s.iy,
                                      {tile_sm, c.K, c.tx + 2, s.ix - x0}});
}

// FORM_CACHE sweep S, G lanes per anchor slot: a cached slot's sweep 0
// walks the window and writes the list, its sweeps 1-3 walk the list;
// ranks k >= kcut ("partial") walk the window in every sweep
template <int S, int G, bool WIDE>
__device__ __forceinline__ void cache_body(const SphConst& c,
                                           const StepBufs& b,
                                           const CacheBufs& cb) {
  if (b.dyn[4] == 0.0f) return;  // the chunk's interval or n_sub is done
  Slot s;
  Lanes<G> g;
  if (!group_slot<G>(c, b.occ, s, g)) return;
  const int cs = (s.iy * c.kcut + s.k) * c.nx + s.ix;
  if (s.k >= c.kcut) {
    body<S>(c, b, s, GWin<G, false, WIDE>{g, c, b, cb, s.iy, s.ix, 0});
  } else if constexpr (S == 0) {
    body<0>(c, b, s, GWin<G, true, WIDE>{g, c, b, cb, s.iy, s.ix, cs});
    if (!s.visited && g.lead()) cb.n[cs] = 0;
  } else {
    body<S>(c, b, s, GList<G, S>{g, c, b, cb, cs});
  }
  if constexpr (S < 3) {
    if (g.lead()) store_rec<S>(c, b, cb, s);
  }
}

template <int S, int G>
__global__ void __launch_bounds__(128)
    cache_sweep(SphConst c, StepBufs b, CacheBufs cb) {
  cache_body<S, G, false>(c, b, cb);
}

// K > 42: the window rows in pieces. The heavier walk spills at the
// default register budget, so the wide kernel may use more registers
template <int S, int G>
__global__ void __launch_bounds__(128, 1)
    cache_sweep_wide(SphConst c, StepBufs b, CacheBufs cb) {
  cache_body<S, G, true>(c, b, cb);
}

// the largest v^2 = vx^2 + vy^2 of a block's threads into *vmax2 as float
// bits: the values are >= +0, so their bits order as unsigned integers and
// an integer max is exact in any order
__device__ __forceinline__ void block_vmax(float m, unsigned* vmax2) {
  __shared__ unsigned wmax[32];
  unsigned v = __reduce_max_sync(0xffffffffu, __float_as_uint(m));
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  if (l == 0) wmax[w] = v;
  __syncthreads();
  if (w == 0) {
    v = __reduce_max_sync(0xffffffffu,
                          l < (int)(blockDim.x >> 5) ? wmax[l] : 0u);
    if (l == 0) atomicMax(vmax2, v);
  }
}

// ---- v^2 max over the chunk's input velocity cores, for its first step
//      (*vmax2 zeroed by the caller) ----
__global__ void __launch_bounds__(256) vmax_init(const float* vx,
                                                 const float* vy, int n,
                                                 unsigned* vmax2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float m = 0.0f;
  if (i < n) {
    const float u = vx[i], v = vy[i];
    m = u * u + v * v;
  }
  block_vmax(m, vmax2);
}

// ---- chunk control: v_max, dt, the active flag and the Kahan clock
//      (fused_cell.py:1602-1618, :1664-1667). v_max is over the whole
//      halo'd velocity cores (:1612): vmax2 holds its square, from
//      vmax_init for the first step and from the previous step's refresh,
//      which writes those cores, after; an active step zeroes it for its
//      own refresh. clock = [t, t_comp, interval, dt_visc, dt_body];
//      steps = [done, n_sub]. One thread. ----
__global__ void chunk_ctrl(SphConst c, StepBufs b, unsigned* vmax2,
                           float* clock, int* steps) {
  const int done = steps[0];
  const float t = clock[0], tc = clock[1], interval = clock[2];
  if (done < steps[1] && t < interval) {
    const float v_max = sqrtf(__uint_as_float(*vmax2));
    *vmax2 = 0u;
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

// ---- halo refresh of the working state (fused_cell.py:1680-1692):
//      positions keep translated x-halo columns and stay unwrapped; the
//      block max of the new v^2 goes to vmax2 for the next step ----
__global__ void __launch_bounds__(256) refresh(SphConst c, StepBufs b,
                                               unsigned* vmax2) {
  if (b.dyn[4] == 0.0f) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int W = c.nx + 2;
  float m = 0.0f;
  if (i < (c.nyp + 2) * c.K * W) {
    const float u = b.vx2[i], v = b.vy2[i];
    b.vx[i] = u;
    b.vy[i] = v;
    m = u * u + v * v;
    const int ixh = i % W;
    const int iyh = (i / W) / c.K;
    const int k = (i / W) % c.K;
    const int iy = iyh - 1;
    if (iyh < 1 || iyh > c.nyp) {
      // y-halo rows: velocities only
    } else if (ixh >= 1 && ixh <= c.nx) {
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
  block_vmax(m, vmax2);
}

// ---- wall-shear partials (sph_physics_mex.c:1713-1742;
//      fused_cell.py:1928-1979). Only an anchor whose window holds a wall
//      slot (wbot or wtop set) adds anything: every other term is f_pair
//      times a zero mask, +-0, added to sums that start at +0. So the grid
//      covers only the cell rows of b.rows (those whose window rows hold a
//      wall slot, listed from the wall cores), kShearG lanes per anchor
//      slot, and the slots of every other row keep the +0 their buffer was
//      zeroed with. The lanes walk the whole 3x3 window at once
//      (walk_window over three rows: one piece of the mask when 9K <= 128;
//      ranks below each row's occupancy bound) and pass only the valid
//      candidates that are not fluid (isf == 0:
//      the wall slots, and the empty ones, which the range test drops), x
//      and y loaded only for those; the lead lane adds the group's terms
//      one by one in window order, the order in which the
//      one-thread-per-slot walk over all 9K candidates added them, so a
//      finite state gives that walk's sums bit for bit (it also added +-0
//      for each other candidate, which leaves a sum that is never -0
//      unchanged; a wall slot with neither mask set adds +-0 here too). No
//      atomics: launches repeat bit for bit. An anchor parked at x = 1e9 or
//      not visited writes +0. What bounds it: a few rows next to each wall,
//      K*nx*kShearG threads a row, each group's chain of dependent loads
//      (isf, then x and y, then the fields of the wall candidates) and its
//      shuffles. kShearG = 16 was the fastest of 4/8/16/32 at dp=0.01. ----
constexpr int kShearG = 16;

__global__ void __launch_bounds__(128) shear(SphConst c, ShearBufs b) {
  constexpr int G = kShearG;
  Lanes<G> g;
  const int wl = threadIdx.x & 31;
  g.lane = wl & (G - 1);
  g.mask = G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (wl & ~(G - 1));
  const int a = (blockIdx.x * blockDim.x + threadIdx.x) / G;
  const int per_row = c.K * c.nx;
  if (a >= b.nrows * per_row) return;
  Slot s;
  s.iy = b.rows[a / per_row];
  const int rem = a - (a / per_row) * per_row;
  s.k = rem / c.nx;
  s.ix = rem - s.k * c.nx;
  s.ha = hix(c, s.iy + 1, s.k, s.ix + 1);
  s.visited = s.k < b.occ[s.iy / c.R];
  const int ha = s.ha;
  const float xa = b.x[ha], ya = b.y[ha];
  float tb = 0.0f, tt = 0.0f;
  if (s.visited && xa < kParked) {
    const float vxa = b.vx[ha], vola = b.vol[ha];
    const float b11a = b.b11[ha], b12a = b.b12[ha], b21a = b.b21[ha],
                b22a = b.b22[ha];
    walk_window<G, 3>(
        c, b.occ, g, s.iy, InCores{c.K, c.nx + 2, s.iy, s.ix}, nullptr,
        [&](int i) {
          return b.isf[i] == 0.0f && in_range(c, xa, ya, b.x[i], b.y[i]);
        },
        [&](bool on, int i, int) {
          float fb = 0.0f, ft = 0.0f;
          if (on) {
            const Geo q = geometry(c, xa, ya, b.x[i], b.y[i], b.isf[i],
                                   false);
            const float ebe = q.ex * (b11a * q.ex + b12a * q.ey) +
                              q.ey * (b21a * q.ex + b22a * q.ey);
            const float f_pair = (b.wf * b.mu * ebe * q.dw * b.vol[i] *
                                  (vxa - b.wvx[i]) / (q.r + c.h001) * vola) *
                                 q.mw;
            fb = f_pair * b.wbot[i];
            ft = f_pair * b.wtop[i];
          }
          // lanes without a candidate hold +0, which leaves the sum as it is
          for (int l = 0; l < G; ++l) {
            const float vb = __shfl_sync(g.mask, fb, l, G);
            const float vt = __shfl_sync(g.mask, ft, l, G);
            if (g.lead()) {
              tb += vb;
              tt += vt;
            }
          }
        });
  }
  if (!g.lead()) return;
  const int p = pix(c, s.iy, s.k, s.ix);
  b.tb[p] = tb;
  b.tt[p] = tt;
}

// ---- the fixed cost of one call over the step's buffers (the TPU probe's
//      noop_kernel, experiments/profile_r3.py:170-171): vol[0, 0, :] =
//      x[0, 0, :], n = nx + 2 floats; every other buffer is left as it is.
//      On the TPU that fixed cost is the DMA of every input into VMEM; the
//      card has no counterpart of it, so the kernel takes only the two rows
//      and their length (20 bytes of parameters, where the step's constants
//      and buffer table are 368). What bounds a copy this small is the
//      launch: back to back, its time is the launch latency, which neither
//      the parameter block's size nor the block's shape nor the loop moved
//      below a row copy_'s cudaMemcpyAsync (PERF.md). It is launched as the
//      sweeps are, plainly, so that it measures what their launches cost. ----
__global__ void __launch_bounds__(128) noop(const float* x, float* vol,
                                           int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) vol[i] = x[i];
}

// ---- the one-hot lane tiling of tests/test_pallas.py:155-172: out (rows,
//      K*bx) = v (rows, bx) @ E with E[c, k*bx + c] = 1. In float32 each
//      output is a sum that starts at +0 and adds v[c]*1 and bx-1 products
//      v[j]*0: +-0 for a finite v[j], NaN for an inf or a NaN. So it is
//      v[c] + 0 (which maps -0 to +0) when no other entry of the row is
//      non-finite and v[c] is not NaN, and NaN otherwise, whatever the order
//      of the sum. One block per row: the row is loaded once, coalesced,
//      into shared memory, its count of non-finite entries taken with one
//      block reduction, and the K copies written as float4 stores where a
//      row's width is a multiple of 4. What bounds it: the output bytes
//      (K times the input); at the shapes of the probes, the launch. The
//      tensor cores would round the product under TF32 (10 mantissa bits):
//      this card's counterpart of the MXU default-precision trap that test
//      documents. ----
__device__ __forceinline__ float expand_at(const float* vrow, int nbad,
                                           int e, int bx) {
  const float a = vrow[e % bx];
  const int others = nbad - (isfinite(a) ? 0 : 1);
  return others == 0 && !isnan(a) ? a + 0.0f : __int_as_float(0x7fffffff);
}

__global__ void __launch_bounds__(128) expand(const float* v, float* out,
                                             int bx, int K) {
  extern __shared__ float vrow[];
  __shared__ int nbad;
  if (threadIdx.x == 0) nbad = 0;
  __syncthreads();
  const float* src = v + static_cast<long long>(blockIdx.x) * bx;
  int bad = 0;
  for (int j = threadIdx.x; j < bx; j += blockDim.x) {
    const float a = src[j];
    vrow[j] = a;
    bad += isfinite(a) ? 0 : 1;
  }
  if (bad) atomicAdd(&nbad, bad);
  __syncthreads();
  const int w = K * bx, nb = nbad;
  float* o = out + static_cast<long long>(blockIdx.x) * w;
  if ((w & 3) == 0) {
    float4* o4 = reinterpret_cast<float4*>(o);
    for (int q = threadIdx.x; q < w / 4; q += blockDim.x) {
      const int e = 4 * q;
      o4[q] = make_float4(expand_at(vrow, nb, e, bx),
                          expand_at(vrow, nb, e + 1, bx),
                          expand_at(vrow, nb, e + 2, bx),
                          expand_at(vrow, nb, e + 3, bx));
    }
  } else {
    for (int e = threadIdx.x; e < w; e += blockDim.x)
      o[e] = expand_at(vrow, nb, e, bx);
  }
}

inline int blocks_for(int n, int per) { return (n + per - 1) / per; }

// FORM_ROWS sweep S: tiles of c.tx columns of one cell row, c.tx*K*G
// threads a block; its tile needs the kernel's opt-in when it exceeds 48
// KB of dynamic shared memory, set for each launched sweep
template <int S, int G, int ROWS>
void launch_rows(const SphConst& c, const StepBufs& b, cudaStream_t st) {
  const size_t sm =
      sizeof(float) * 3 * c.K * (c.tx + 2) * SweepFields<S>::n;
  if (sm > 48 * 1024)
    cudaFuncSetAttribute(rows_sweep<S, G, ROWS>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, sm);
  rows_sweep<S, G, ROWS><<<c.nyp * blocks_for(c.nx, c.tx), c.tx * c.K * G,
                           sm, st>>>(c, b);
}

// the whole window in one piece of the walk where 9K <= 128, else row by
// row
template <int G>
void launch_rows(const SphConst& c, const StepBufs& b, int s,
                 cudaStream_t st) {
  if (9 * c.K <= kPiece) {
    if (s == 0) launch_rows<0, G, 3>(c, b, st);
    else if (s == 1) launch_rows<1, G, 3>(c, b, st);
    else if (s == 2) launch_rows<2, G, 3>(c, b, st);
    else launch_rows<3, G, 3>(c, b, st);
  } else {
    if (s == 0) launch_rows<0, G, 1>(c, b, st);
    else if (s == 1) launch_rows<1, G, 1>(c, b, st);
    else if (s == 2) launch_rows<2, G, 1>(c, b, st);
    else launch_rows<3, G, 1>(c, b, st);
  }
}

// FORM_WIN sweep S, G lanes per anchor slot; the whole window in one piece
// of the walk where 9K <= 128, else row by row
template <int G, int ROWS>
void launch_win(const SphConst& c, const StepBufs& b, int s,
                cudaStream_t st) {
  const int nb = blocks_for(c.nyp * c.K * c.nx * G, 128);
  if (s == 0) win_sweep<0, G, ROWS><<<nb, 128, 0, st>>>(c, b);
  else if (s == 1) win_sweep<1, G, ROWS><<<nb, 128, 0, st>>>(c, b);
  else if (s == 2) win_sweep<2, G, ROWS><<<nb, 128, 0, st>>>(c, b);
  else win_sweep<3, G, ROWS><<<nb, 128, 0, st>>>(c, b);
}

// the whole window in one piece of the walk where 9K <= 128, else row by
// row
template <int G>
void launch_win(const SphConst& c, const StepBufs& b, int s,
                cudaStream_t st) {
  if (9 * c.K <= kPiece) launch_win<G, 3>(c, b, s, st);
  else launch_win<G, 1>(c, b, s, st);
}

template <int G, bool WIDE>
void launch_cache(const SphConst& c, const StepBufs& b, const CacheBufs& cb,
                  int s, cudaStream_t st) {
  const int nb = blocks_for(c.nyp * c.K * c.nx * G, 128);
  if constexpr (WIDE) {
    if (s == 0) {
      if constexpr (G >= 4)
        cache_sweep_wide<0, G><<<nb, 128, 0, st>>>(c, b, cb);
    } else if (s == 1)
      cache_sweep_wide<1, G><<<nb, 128, 0, st>>>(c, b, cb);
    else if (s == 2)
      cache_sweep_wide<2, G><<<nb, 128, 0, st>>>(c, b, cb);
    else
      cache_sweep_wide<3, G><<<nb, 128, 0, st>>>(c, b, cb);
  } else {
    if (s == 0) {
      if constexpr (G >= 4) cache_sweep<0, G><<<nb, 128, 0, st>>>(c, b, cb);
    } else if (s == 1)
      cache_sweep<1, G><<<nb, 128, 0, st>>>(c, b, cb);
    else if (s == 2)
      cache_sweep<2, G><<<nb, 128, 0, st>>>(c, b, cb);
    else
      cache_sweep<3, G><<<nb, 128, 0, st>>>(c, b, cb);
  }
}

template <int G>
void launch_cache(const SphConst& c, const StepBufs& b, const CacheBufs& cb,
                  int s, cudaStream_t st) {
  if (3 * c.K > kPiece)
    launch_cache<G, true>(c, b, cb, s, st);
  else
    launch_cache<G, false>(c, b, cb, s, st);
}

cudaError_t sweeps(const SphConst& c, const StepBufs& b, const CacheBufs& cb,
                   int form, int first, int count, cudaStream_t st) {
  if (form == FORM_CACHE) {
    for (int s = first; s < first + count; ++s) {
      const int g = s == 0 ? c.cg0 : c.cg;
      if (g == 1 && s > 0)
        launch_cache<1>(c, b, cb, s, st);
      else if (g == 2 && s > 0)
        launch_cache<2>(c, b, cb, s, st);
      else if (g == 4)
        launch_cache<4>(c, b, cb, s, st);
      else if (g == 8)
        launch_cache<8>(c, b, cb, s, st);
      else if (g == 16)
        launch_cache<16>(c, b, cb, s, st);
      else if (g == 32)
        launch_cache<32>(c, b, cb, s, st);
      else
        return cudaErrorInvalidValue;
    }
  } else if (form == FORM_ROWS) {
    if (c.tx < 1 || c.tx * c.K * c.rg > 1024) return cudaErrorInvalidValue;
    for (int s = first; s < first + count; ++s) {
      if (c.rg == 4) launch_rows<4>(c, b, s, st);
      else if (c.rg == 8) launch_rows<8>(c, b, s, st);
      else if (c.rg == 16) launch_rows<16>(c, b, s, st);
      else if (c.rg == 32) launch_rows<32>(c, b, s, st);
      else return cudaErrorInvalidValue;
    }
  } else if (form == FORM_WIN) {
    for (int s = first; s < first + count; ++s) {
      if (c.wg == 4) launch_win<4>(c, b, s, st);
      else if (c.wg == 8) launch_win<8>(c, b, s, st);
      else if (c.wg == 16) launch_win<16>(c, b, s, st);
      else if (c.wg == 32) launch_win<32>(c, b, s, st);
      else return cudaErrorInvalidValue;
    }
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
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
  const cudaError_t e = sweeps(*cp, *bp, *cbp, form, first, count,
                               static_cast<cudaStream_t>(stream));
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

int sph_step(const SphConst* cp, const StepBufs* bp, const CacheBufs* cbp,
             int form, void* stream) {
  return sph_step_sweeps(cp, bp, cbp, form, 0, 4, stream);
}

int sph_noop(const SphConst* cp, const StepBufs* bp, void* stream) {
  noop<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(bp->x), bp->vol, cp->nx + 2);
  return static_cast<int>(cudaGetLastError());
}

int sph_expand(const float* v, float* out, int rows, int bx, int K,
               void* stream) {
  const size_t sm = sizeof(float) * bx;
  if (sm > 48 * 1024)
    cudaFuncSetAttribute(expand, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(sm));
  expand<<<rows, 128, sm, static_cast<cudaStream_t>(stream)>>>(v, out, bx,
                                                              K);
  return static_cast<int>(cudaGetLastError());
}

// vmax2: one zeroed unsigned, left holding the bits of v_max^2 over the
// final working velocity cores
int sph_chunk(const SphConst* cp, const StepBufs* bp, const CacheBufs* cbp,
              int form, float* clock, int* steps, unsigned* vmax2, int n_sub,
              void* stream) {
  const SphConst c = *cp;
  const StepBufs b = *bp;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_h = (c.nyp + 2) * c.K * (c.nx + 2);
  const int nh = blocks_for(n_h, 256);
  vmax_init<<<nh, 256, 0, st>>>(b.vx, b.vy, n_h, vmax2);
  for (int i = 0; i < n_sub; ++i) {
    chunk_ctrl<<<1, 1, 0, st>>>(c, b, vmax2, clock, steps);
    cudaError_t e = sweeps(c, b, *cbp, form, 0, 4, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    refresh<<<nh, 256, 0, st>>>(c, b, vmax2);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

int sph_shear(const SphConst* cp, const ShearBufs* bp, void* stream) {
  const SphConst c = *cp;
  const ShearBufs b = *bp;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b.nrows == 0) return static_cast<int>(cudaGetLastError());
  const int n = b.nrows * c.K * c.nx;
  shear<<<blocks_for(n * kShearG, 128), 128, 0, st>>>(c, b);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
