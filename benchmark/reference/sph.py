"""Plain PyTorch reference of the channel's weakly-compressible SPH scheme.

The semantics are the upstream solver's (KIYOYOZU/SPH-Poiseuille-Flow,
``SPH_Poiseuille.m`` with ``sph_physics_mex.c``): pairs stored once, the
fluid-fluid pairs added to both sides and the fluid-wall pairs to the
fluid side only. A step is

  density by kernel summation, volume, the kernel gradient correction B;
  the viscous force and the body force (the prior force);
  particle shifting (transport correction) of the positions;
  dt = min(acoustic, viscous, body-force, time left to the output point);
  stage 1: rho += dt/2 drho_prev, EOS, pos += dt/2 v, the Riemann
    pressure force with the virtual wall pressure, all on the pairs of
    the step's starting positions;
  the kick; stage 2: pos += dt/2 v_new, the continuity rate with the
    mirrored no-slip wall velocity; rho += dt/2 drho_new, EOS;
  x wrapped into [0, DL) for the fluid.

The interval clock is Kahan-compensated and clamps the last dt onto the
output point. The wall shear is read at the output point on the pairs of
the final positions. Every sum is a scatter-add over a pair list, written
out from the formulas and not from any program's kernels; it imports
nothing of the solver under test.

The pair list holds every store-once pair within 2h + skin of a cell
search and is searched again once a particle has moved half the skin, so
the pairs a step uses are exactly those within 2h of its positions.

``dtype`` is the precision of every field and pair term; ``pos_dtype`` that
of the positions (the benchmark's lower-precision control keeps positions
in float32, because bfloat16 cannot resolve a lattice of this spacing).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

TRANSPORT_COEFF = 0.30      # SPH_Poiseuille.m:77 (the code, not the README)
WALL_VISC_FACTOR = 4.0      # sph_physics_mex.c:383-388, 526
EPS_REG = 1e-8              # the correction's regularisation (c:321-349)


class Channel:
    """The channel's derived constants (SPH_Poiseuille.m:62-91) from the
    physical keys of ``config.ini``."""

    def __init__(self, DL, DH, dp, rho0, mu, U_bulk, c_f):
        self.dp = float(dp)
        self.DL = round(DL / dp) * dp
        self.DH = round(DH / dp) * dp
        self.rho0, self.mu, self.c_f = float(rho0), float(mu), float(c_f)
        self.U_bulk = float(U_bulk)
        self.g = 12.0 * mu * U_bulk / (rho0 * self.DH ** 2)
        self.h = 1.3 * dp
        self.wall_thickness = max(
            4.0 * dp, math.ceil(2.0 * self.h / dp - 1e-12) * dp)
        self.p0 = rho0 * c_f ** 2
        self.inv_sigma0 = dp ** 2
        self.nu = mu / rho0
        self.tau_target = self.g * rho0 * self.DH / 2.0

    @classmethod
    def from_physics(cls, phys: dict) -> "Channel":
        return cls(**{k: float(phys[k]) for k in (
            "DL", "DH", "dp", "rho0", "mu", "U_bulk", "c_f")})

    def analytic_u(self, y):
        """The steady profile u(y) = g/(2 nu) y (DH - y)."""
        return self.g / (2.0 * self.nu) * y * (self.DH - y)

    def lattice(self, device="cpu"):
        """(x, y, mass, n_fluid) in float64 on ``device``: the cell-centred
        fluid lattice (rows of constant y), then the bottom and the top
        wall blocks (SPH_Poiseuille.m:93-125,
        build_shell_wall_particles.m)."""
        dp = self.dp
        nx, ny = round(self.DL / dp), round(self.DH / dp)
        nl = round(self.wall_thickness / dp)

        def ar(k):
            return torch.arange(k, dtype=torch.float64, device=device)

        xs = (ar(nx) + 0.5) * dp

        def block(ys):
            yy, xx = torch.meshgrid(ys, xs, indexing="ij")
            return xx.reshape(-1), yy.reshape(-1)

        xf, yf = block((ar(ny) + 0.5) * dp)
        xb, yb = block(-self.wall_thickness + (ar(nl) + 0.5) * dp)
        xt, yt = block(self.DH + (ar(nl) + 0.5) * dp)
        x = torch.cat([xf, xb, xt])
        y = torch.cat([yf, yb, yt])
        mass = torch.full_like(x, self.rho0 * dp * dp)
        return x, y, mass, xf.numel()


class Fields(NamedTuple):
    """Particle fields, fluid first and walls last (1-D tensors)."""

    x: torch.Tensor
    y: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    rho: torch.Tensor
    p: torch.Tensor
    drho_dt: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    fpx: torch.Tensor
    fpy: torch.Tensor
    vol: torch.Tensor
    b11: torch.Tensor
    b12: torch.Tensor
    b21: torch.Tensor
    b22: torch.Tensor


def cubic(r, h):
    """The 2D cubic spline (Monaghan M4): (W, dW/dr), zero at r >= 2h."""
    sigma = 10.0 / (7.0 * math.pi * h * h)
    q = r / h
    tq = 2.0 - q
    w = torch.where(q < 1.0, sigma * (1.0 - 1.5 * q * q + 0.75 * q * q * q),
                    torch.where(q < 2.0, sigma * 0.25 * tq * tq * tq,
                                torch.zeros_like(q)))
    dw = torch.where(q < 1.0, sigma * (-3.0 * q + 2.25 * q * q) / h,
                     torch.where(q < 2.0, -sigma * 0.75 * tq * tq / h,
                                 torch.zeros_like(q)))
    return w, dw


def candidate_pairs(x, y, n_fluid: int, DL: float, reach: float):
    """Store-once pairs (i, j) with |r_ij| < ``reach`` under the minimum
    image in x: fluid i with fluid j > i, and fluid i with every wall j.
    A cell search over square cells of side >= ``reach``."""
    dev = x.device
    n = x.numel()
    ncx = int(DL // reach)
    if ncx < 3:
        raise ValueError(f"the box (DL={DL}) holds fewer than three cells "
                         f"of the search reach {reach}")
    xd, yd = x.double(), y.double()
    cx = torch.clamp(torch.floor(torch.remainder(xd, DL) / (DL / ncx)),
                     0, ncx - 1).long()
    y0 = float(yd.min())
    cy = torch.floor((yd - y0) / reach).long()
    ncy = int(cy.max()) + 1
    key = cy * ncx + cx
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=ncx * ncy)
    starts = torch.cumsum(counts, 0) - counts
    m = int(counts.max())
    off = torch.tensor([-1, 0, 1], device=dev)
    nbx = torch.remainder(cx[:n_fluid, None, None] + off[None, None, :], ncx)
    nby = cy[:n_fluid, None, None] + off[None, :, None]
    inside = ((nby >= 0) & (nby < ncy)).expand(n_fluid, 3, 3)
    cell = (torch.clamp(nby, 0, ncy - 1) * ncx + nbx).reshape(n_fluid, 9)
    cnt = counts[cell] * inside.reshape(n_fluid, 9)
    slot = torch.arange(m, device=dev)
    idx = starts[cell][:, :, None] + slot
    ok = slot < cnt[:, :, None]
    j = order[torch.clamp(idx, max=n - 1)]
    i = torch.arange(n_fluid, device=dev)[:, None, None].expand_as(j)
    ok &= (j > i) | (j >= n_fluid)
    i, j = i[ok], j[ok]
    dx = xd[i] - xd[j]
    dx = dx - DL * torch.round(dx / DL)
    dy = yd[i] - yd[j]
    near = dx * dx + dy * dy < reach * reach
    return i[near], j[near]


class _Pairs(NamedTuple):
    """The pair terms of one set of positions; masks as 0/1 fields."""

    i: torch.Tensor
    j: torch.Tensor
    mf: torch.Tensor        # fluid-fluid and within 2h
    mw: torch.Tensor        # fluid-wall and within 2h
    r: torch.Tensor
    ex: torch.Tensor
    ey: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    w: torch.Tensor
    dw: torch.Tensor


def pair_terms(ch: Channel, x, y, i, j, n_fluid: int, dtype) -> _Pairs:
    """Distances, unit vectors and kernel values of the candidate pairs
    (i, j); pairs at 2h or beyond, or at r^2 <= 1e-24, are masked out."""
    dx = x[i] - x[j]
    dx = dx - ch.DL * torch.round(dx / ch.DL)
    dy = y[i] - y[j]
    dx, dy = dx.to(dtype), dy.to(dtype)
    r2 = dx * dx + dy * dy
    valid = (r2 > 1e-24) & (r2 < (2.0 * ch.h) ** 2)
    r = torch.sqrt(torch.where(valid, r2, torch.ones_like(r2)))
    w, dw = cubic(r, ch.h)
    wall = j >= n_fluid
    mf = (valid & ~wall).to(dtype)
    mw = (valid & wall).to(dtype)
    m = mf + mw
    return _Pairs(i=i, j=j, mf=mf, mw=mw, r=r, ex=dx / r * m, ey=dy / r * m,
                  dx=dx * m, dy=dy * m, w=w * m, dw=dw * m)


def _scatter(n, i, vi, j=None, vj=None):
    out = torch.zeros(n, dtype=vi.dtype, device=vi.device)
    out.index_add_(0, i, vi)
    if j is not None:
        out.index_add_(0, j, vj)
    return out


def _bdot(b11, b12, b21, b22, ex, ey):
    return b11 * ex + b12 * ey, b21 * ex + b22 * ey


def density_correction(ch: Channel, pt: _Pairs, mass, n_fluid: int):
    """Kernel-summation density, volume and the gradient correction B
    (sph_physics_mex.c:95-374). Walls keep rho0 and B = I."""
    n = mass.numel()
    i, j = pt.i, pt.j
    sig0 = 10.0 / (7.0 * math.pi * ch.h * ch.h)
    sig_in = sig0 + _scatter(n, i, pt.w * pt.mf, j, pt.w * pt.mf)
    sig_c = _scatter(n, i, pt.w * pt.mw * (mass[j] / ch.rho0))
    nf = n_fluid
    rho_f = (sig_in[:nf] * ch.rho0 * ch.inv_sigma0
             + sig_c[:nf] * ch.rho0 * ch.rho0 * ch.inv_sigma0 / mass[:nf])
    rho_f = torch.where(rho_f <= 1e-12, torch.full_like(rho_f, ch.rho0),
                        rho_f)
    rho = torch.cat([rho_f, torch.full_like(mass[nf:], ch.rho0)])
    vol = mass / rho

    fj = pt.dw * vol[j]                         # i's side: all pairs
    fi = pt.dw * vol[i] * pt.mf                 # j's side: fluid pairs
    a = []
    for u, e in ((pt.dx, pt.ex), (pt.dx, pt.ey), (pt.dy, pt.ex),
                 (pt.dy, pt.ey)):
        a.append(-_scatter(n, i, u * fj * e, j, u * fi * e)[:nf])
    a11, a12, a21, a22 = a
    ata11 = a11 * a11 + a21 * a21 + EPS_REG
    ata12 = a11 * a12 + a21 * a22
    ata22 = a12 * a12 + a22 * a22 + EPS_REG
    det_m = ata11 * ata22 - ata12 * ata12
    degen = torch.abs(det_m) < 1e-20
    det_s = torch.where(degen, torch.ones_like(det_m), det_m)
    im11, im12, im22 = ata22 / det_s, -ata12 / det_s, ata11 / det_s
    one, zero = torch.ones_like(a11), torch.zeros_like(a11)
    p11 = torch.where(degen, one, im11 * a11 + im12 * a12)
    p12 = torch.where(degen, zero, im11 * a21 + im12 * a22)
    p21 = torch.where(degen, zero, im12 * a11 + im22 * a12)
    p22 = torch.where(degen, one, im12 * a21 + im22 * a22)
    det_a = a11 * a22 - a12 * a21
    det_sqr = torch.clamp(1.0 - det_a, min=0.0)
    denom = det_a + det_sqr
    small = torch.abs(denom) < 1e-12
    den_s = torch.where(small, one, denom)
    w1 = torch.where(small, zero, det_a / den_s)
    w2 = torch.where(small, one, det_sqr / den_s)
    wl1 = torch.ones_like(mass[nf:])
    wl0 = torch.zeros_like(mass[nf:])
    b11 = torch.cat([w1 * p11 + w2, wl1])
    b12 = torch.cat([w1 * p12, wl0])
    b21 = torch.cat([w1 * p21, wl0])
    b22 = torch.cat([w1 * p22 + w2, wl1])
    return rho, vol, (b11, b12, b21, b22)


def viscous_force(ch: Channel, pt: _Pairs, vx, vy, vol, B, mu, n_fluid):
    """The viscous force of the fluid (sph_physics_mex.c:376-567), walls
    at rest, one-sided wall pairs x WALL_VISC_FACTOR."""
    n = vx.numel()
    i, j = pt.i, pt.j
    bi = [b[i] for b in B]
    bs = [u + b[j] for u, b in zip(bi, B)]
    den = pt.r + 0.01 * ch.h
    tx, ty = _bdot(*bs, pt.ex, pt.ey)
    ebe_f = pt.ex * tx + pt.ey * ty
    wx, wy = _bdot(*bi, pt.ex, pt.ey)
    ebe_w = pt.ex * wx + pt.ey * wy
    dvx, dvy = vx[i] - vx[j], vy[i] - vy[j]
    k_i = (ebe_f * pt.mf + WALL_VISC_FACTOR * ebe_w * pt.mw) \
        * mu * pt.dw * vol[j] / den
    k_j = ebe_f * pt.mf * mu * pt.dw * vol[i] / den
    ax = _scatter(n, i, k_i * dvx, j, -k_j * dvx)
    ay = _scatter(n, i, k_i * dvy, j, -k_j * dvy)
    fl = torch.zeros_like(vx)
    fl[:n_fluid] = 1.0
    return ax * vol * fl, ay * vol * fl


def transport_shift(ch: Channel, pt: _Pairs, x, y, vol, B, n_fluid):
    """Particle shifting (sph_physics_mex.c:569-714): fluid positions only."""
    n = vol.numel()
    i, j = pt.i, pt.j
    bi = [b[i] for b in B]
    bs = [u + b[j] for u, b in zip(bi, B)]
    tfx, tfy = _bdot(*bs, pt.ex, pt.ey)
    twx, twy = _bdot(*bi, pt.ex, pt.ey)
    ci = -pt.dw * vol[j]
    cj = pt.dw * vol[i] * pt.mf
    incx = _scatter(n, i, ci * (tfx * pt.mf + 2.0 * twx * pt.mw), j,
                    cj * tfx)[:n_fluid]
    incy = _scatter(n, i, ci * (tfy * pt.mf + 2.0 * twy * pt.mw), j,
                    cj * tfy)[:n_fluid]
    n2 = incx * incx + incy * incy
    lim = torch.clamp(100.0 * n2 / (ch.h * ch.h), 0.0, 1.0)
    s = TRANSPORT_COEFF * ch.h * ch.h * lim
    nf = n_fluid
    return (torch.cat([x[:nf] + (s * incx).to(x.dtype), x[nf:]]),
            torch.cat([y[:nf] + (s * incy).to(y.dtype), y[nf:]]))


def verlet_dt(ch: Channel, vx_f, vy_f, g, remain: float):
    """min(acoustic, viscous, body-force, remaining), floored at 1e-12
    (SPH_Poiseuille.m:519-527), in float64 on the host's terms."""
    v_max = float(torch.sqrt(torch.max(vx_f.double() ** 2
                                       + vy_f.double() ** 2)))
    return max(min(0.25 * ch.h / max(ch.c_f + v_max, 1e-12),
                   0.125 * ch.h * ch.h / max(ch.nu, 1e-12),
                   0.25 * math.sqrt(ch.h / max(abs(g), 1e-12)), remain),
               1e-12)


def _eos(ch: Channel, rho_f):
    rho_f = torch.where(rho_f < 1e-10, torch.full_like(rho_f, ch.rho0),
                        rho_f)
    return rho_f, ch.p0 * (rho_f / ch.rho0 - 1.0)


def step(ch: Channel, st: Fields, pt: _Pairs, mass, n_fluid: int, dt: float,
         g: float, mu: float) -> Fields:
    """One step on the pairs ``pt`` of ``st``'s positions."""
    nf = n_fluid
    n = mass.numel()
    i, j = pt.i, pt.j
    rho, vol, B = density_correction(ch, pt, mass, nf)
    fpx, fpy = viscous_force(ch, pt, st.vx, st.vy, vol, B, mu, nf)
    fpx = torch.cat([fpx[:nf] + mass[:nf] * g, fpx[nf:]])
    xs, ys = transport_shift(ch, pt, st.x, st.y, vol, B, nf)

    # stage 1
    rho_h, p_hf = _eos(ch, rho[:nf] + 0.5 * dt * st.drho_dt[:nf])
    rho_h = torch.cat([rho_h, rho[nf:]])
    p_h = torch.cat([p_hf, torch.zeros_like(rho[nf:])])
    vx, vy = st.vx, st.vy

    def drift(px, py, ux, uy):
        return (torch.cat([px[:nf] + (0.5 * dt * ux[:nf]).to(px.dtype),
                           px[nf:]]),
                torch.cat([py[:nf] + (0.5 * dt * uy[:nf]).to(py.dtype),
                           py[nf:]]))

    xh, yh = drift(xs, ys, vx, vy)
    bi = [b[i] for b in B]
    bs = [u + b[j] for u, b in zip(bi, B)]
    sx, sy = _bdot(*bs, pt.ex, pt.ey)
    wx, wy = _bdot(*bi, pt.ex, pt.ey)
    p_i, p_j = p_h[i], p_h[j]
    un_l = vx[i] * pt.ex + vy[i] * pt.ey
    un_r = vx[j] * pt.ex + vy[j] * pt.ey
    beta = torch.clamp(3.0 * torch.clamp(un_l - un_r, min=0.0), max=ch.c_f)
    p_avg = 0.5 * (p_i + p_j)
    p_star = p_avg + 0.5 * beta * 0.5 * (rho_h[i] + rho_h[j]) * (un_l - un_r)
    p_face = 0.5 * (p_avg + p_star)
    face_acc = -((fpx[i] / mass[i]) * pt.ex + (fpy[i] / mass[i]) * pt.ey)
    p_wall = p_i + rho_h[i] * pt.r * torch.clamp(face_acc, min=0.0)
    dwv_j = pt.dw * vol[j]
    dwv_i = pt.dw * vol[i] * pt.mf
    fxi = -(p_face * sx * pt.mf + (p_i + p_wall) * wx * pt.mw) * dwv_j
    fyi = -(p_face * sy * pt.mf + (p_i + p_wall) * wy * pt.mw) * dwv_j
    fl = torch.zeros_like(vol)
    fl[:nf] = 1.0
    fx = _scatter(n, i, fxi, j, p_face * sx * dwv_i) * vol * fl
    fy = _scatter(n, i, fyi, j, p_face * sy * dwv_i) * vol * fl

    # kick, stage 2, finalize
    vx2 = (vx + (fpx + fx) / mass * dt) * fl
    vy2 = (vy + (fpy + fy) / mass * dt) * fl
    x2, y2 = drift(xh, yh, vx2, vy2)
    jump = ((vx2[i] - vx2[j]) * pt.ex + (vy2[i] - vy2[j]) * pt.ey) * pt.mf \
        + 2.0 * (vx2[i] * pt.ex + vy2[i] * pt.ey) * pt.mw
    rate = _scatter(n, i, jump * pt.dw * vol[j], j,
                    jump * pt.dw * vol[i] * pt.mf)
    drho = rate * rho_h * fl
    rho2_f, p2_f = _eos(ch, rho_h[:nf] + 0.5 * dt * drho[:nf])
    x2 = torch.cat([torch.remainder(x2[:nf], ch.DL), x2[nf:]])
    return Fields(x=x2, y=y2, vx=vx2, vy=vy2,
                  rho=torch.cat([rho2_f, rho_h[nf:]]),
                  p=torch.cat([p2_f, torch.zeros_like(rho[nf:])]),
                  drho_dt=drho, fx=fx, fy=fy, fpx=fpx, fpy=fpy, vol=vol,
                  b11=B[0], b12=B[1], b21=B[2], b22=B[3])


def wall_shear(ch: Channel, st: Fields, pt: _Pairs, n_fluid: int, mu: float):
    """(tau_bottom, tau_top): the viscous x-force of the fluid-wall pairs
    split by wall side, tau = -sum / DL (sph_physics_mex.c:1653-1743)."""
    i, j = pt.i, pt.j
    wx, wy = _bdot(st.b11[i], st.b12[i], st.b21[i], st.b22[i], pt.ex, pt.ey)
    ebe = pt.ex * wx + pt.ey * wy
    f = (WALL_VISC_FACTOR * mu * ebe * pt.dw * st.vol[j] * st.vx[i]
         / (pt.r + 0.01 * ch.h) * st.vol[i]) * pt.mw
    yj = st.y[j]
    bot = (yj <= 0.0).to(f.dtype)
    top = (yj >= ch.DH).to(f.dtype)
    return (float(-(f * bot).double().sum() / ch.DL),
            float(-(f * top).double().sum() / ch.DL))


class Outcome(NamedTuple):
    """An output point: the state, the steps and clock that reached it, the
    wall shear and the largest fluid speed."""

    state: Fields
    n_steps: int
    t: float
    tau_bottom: float
    tau_top: float
    v_max: float


class Reference:
    """Runs the scheme from given fields.

    ``mass``: the particle masses; ``n_fluid``: fluid first, walls last.
    The pair search reaches half a spacing beyond 2h."""

    def __init__(self, ch: Channel, mass, n_fluid: int, dtype=torch.float64,
                 pos_dtype=None):
        self.ch = ch
        self.dtype = dtype
        self.pos_dtype = pos_dtype or dtype
        self.mass = mass.to(dtype)
        self.nf = int(n_fluid)
        self.skin = 0.5 * ch.dp
        self._pairs = None

    def cast(self, st: Fields) -> Fields:
        """The fields in the reference's precisions."""
        return Fields(*(v.to(self.pos_dtype) if k in ("x", "y")
                        else v.to(self.dtype)
                        for k, v in zip(Fields._fields, st)))

    def pairs(self, x, y) -> _Pairs:
        """The pair terms within 2h of (x, y), searching again once a
        particle has moved half the skin since the last search."""
        ch = self.ch
        if self._pairs is not None:
            x0, y0, i, j = self._pairs
            ddx = (x - x0).double()
            ddx = ddx - ch.DL * torch.round(ddx / ch.DL)
            moved = float(torch.max(ddx * ddx + (y - y0).double() ** 2))
            if moved >= (0.5 * self.skin) ** 2:
                self._pairs = None
        if self._pairs is None:
            i, j = candidate_pairs(x, y, self.nf, ch.DL,
                                   2.0 * ch.h + self.skin)
            self._pairs = (x.clone(), y.clone(), i, j)
        _, _, i, j = self._pairs
        return pair_terms(ch, x, y, i, j, self.nf, self.dtype)

    def density(self, st: Fields):
        """The density pass on ``st``'s positions: (rho, p, vol, B)."""
        pt = self.pairs(*(v.to(self.pos_dtype) for v in (st.x, st.y)))
        rho, vol, B = density_correction(self.ch, pt, self.mass, self.nf)
        p = self.ch.p0 * (rho / self.ch.rho0 - 1.0)
        p[self.nf:] = 0.0
        return rho, p, vol, B

    def run(self, st: Fields, interval: float | None = None,
            n_steps: int | None = None) -> Outcome:
        """Steps from ``st``: up to the output point ``interval`` seconds
        ahead (the last dt clamped onto it), or exactly ``n_steps`` steps
        with no clamp."""
        ch = self.ch
        g, mu = ch.g, ch.mu
        st = self.cast(st)
        t = comp = 0.0
        n = 0
        while (t < interval) if n_steps is None else (n < n_steps):
            pt = self.pairs(st.x, st.y)
            remain = math.inf if interval is None else interval - t
            dt = verlet_dt(ch, st.vx[:self.nf], st.vy[:self.nf], g, remain)
            st = step(ch, st, pt, self.mass, self.nf, dt, g, mu)
            yk = dt - comp
            s = t + yk
            comp = (s - t) - yk
            t = s
            n += 1
        pt = self.pairs(st.x, st.y)
        tau_b, tau_t = wall_shear(ch, st, pt, self.nf, mu)
        vf = torch.sqrt(st.vx[:self.nf].double() ** 2
                        + st.vy[:self.nf].double() ** 2)
        return Outcome(state=st, n_steps=n, t=t, tau_bottom=tau_b,
                       tau_top=tau_t, v_max=float(vf.max()))
