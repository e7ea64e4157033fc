"""Cell-layout engine of plain torch ops (torch port of the JAX package's
``ops/cellgrid.py``): slot assignment, the padded ``(ny, nx, K)`` cell
layout, the 3x3 neighbour view by static slicing, and the full physics step
over ``(S, K, 9K)`` pair blocks with masked reductions (the dense row-sum
semantics of the reference's pair loops).

This is the engine ``CellEngine`` (stepper.py) runs. It holds no kernel of
its own: it is the counterpart of the JAX package's XLA code, and it runs
in float32 or float64 on any device. The slot order fixes the order of
every in-cell reduction, so the slot array must be identical to the JAX
package's: a STABLE sort by cell id, then the rank inside the cell.

Self-pairs and halo self-images cancel as in the JAX package: a particle's
own halo copy sits at minimum-image distance 0 and is excluded by the r^2
lower bound; particle identity (pid) excludes the true self-pair.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from .density import EPS_REG
from .kernels import cubic_spline, w0
from .neighbors import GridSpec, _cell_coords


class CellLayout(NamedTuple):
    """Per-rebuild slot assignment + static per-slot fields."""

    slot: torch.Tensor      # (n_total,) int64 core slot id (cell*K + rank)
    pid_v: torch.Tensor     # (S, 9K) neighbor-view particle ids (-1 empty)
    pid_a: torch.Tensor     # (S, K) slot-side particle ids (-1 empty)
    valid_v: torch.Tensor   # (S, 9K) occupancy of the neighbor view
    isf_v: torch.Tensor     # (S, 9K) 1.0 where the neighbor is fluid
    mass_v: torch.Tensor    # (S, 9K) neighbor mass
    wvx_v: torch.Tensor     # (S, 9K) neighbor prescribed wall velocity
    wvy_v: torch.Tensor
    wbot_v: torch.Tensor    # (S, 9K) bottom-wall neighbor mask
    wtop_v: torch.Tensor    # (S, 9K) top-wall neighbor mask
    a_fluid: torch.Tensor   # (S, K) 1.0 where the slot holds a fluid
    a_valid: torch.Tensor   # (S, K) slot occupancy
    mass_a: torch.Tensor    # (S, K) slot-side mass (1.0 in empty slots)
    ref_x: torch.Tensor     # (n_total,) positions at rebuild (skin guard)
    ref_y: torch.Tensor
    overflow: torch.Tensor  # 0-dim bool


class CellGeometry(NamedTuple):
    """Per-step pair geometry, the irreducible 3 fields (validity is
    rm > 0; everything else is rederived by ``derive_pair_terms``)."""

    rm: torch.Tensor   # (S, K, 9K) r where the pair is valid, 0 elsewhere
    ex: torch.Tensor   # (S, K, 9K) dx/r, 0 where invalid
    ey: torch.Tensor   # (S, K, 9K) dy/r, 0 where invalid


def assign_slots(spec: GridSpec, x: torch.Tensor, y: torch.Tensor):
    """Stable sort by cell id + rank-in-cell -> (slot, overflow): slot is
    ``cell * K + rank`` (int64), or the sentinel ``n_cells * K`` for a
    particle past the cell capacity; overflow is a 0-dim bool tensor (the
    reference's linked-cell insert, sph_neighbor_search_mex.c:69-113, as a
    static-shape scatter). The per-cell counts use ``scatter_add`` with a
    known length, which unlike ``bincount`` needs no device sync. Every
    write is out of place, so the function maps over a lane axis
    (``torch.func.vmap``, the batched sweep)."""
    n = spec.n_total
    dev = x.device
    cx, cy = _cell_coords(spec, x, y)
    cid = cy.to(torch.int64) * spec.nx + cx.to(torch.int64)
    order = torch.argsort(cid, stable=True)
    cid_sorted = cid[order]
    counts = torch.zeros(spec.n_cells, dtype=torch.int64,
                         device=dev).scatter_add(0, cid, torch.ones_like(cid))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, dtype=torch.int64, device=dev) - starts[cid_sorted]
    overflow = torch.max(counts) > spec.K
    slot_sorted = torch.where(rank < spec.K, cid_sorted * spec.K + rank,
                              torch.full_like(rank, spec.n_cells * spec.K))
    slot = torch.empty_like(slot_sorted).scatter(0, order, slot_sorted)
    return slot, overflow


def _core(spec: GridSpec, slot, arrays: Sequence[torch.Tensor], fill=0.0,
          dtype=None):
    """Packed scatter of per-particle arrays into the (ny, nx, K*F) core;
    the overflow sentinel slot is dropped."""
    pack = torch.stack(list(arrays), dim=-1)
    if dtype is not None:
        pack = pack.to(dtype)
    n_slots = spec.n_cells * spec.K
    flat = torch.full((n_slots + 1, pack.shape[1]), fill, dtype=pack.dtype,
                      device=pack.device).index_put((slot,), pack)
    return flat[:n_slots].reshape(spec.ny, spec.nx, -1)


def _nview(spec: GridSpec, core):
    """(ny, nx, K*F) core -> (S, 9K*F) neighbor view via an x-halo and
    shifted concatenation (static slices only). For nx < 3 the halo
    columns are zero: the interior shifts alone cover every cell (the JAX
    ``_nview``'s dedup)."""
    zrow = torch.zeros_like(core[:1])
    return nview_bands(core, spec.nx, zrow, zrow)


def nview_bands(core, nx: int, lo, hi):
    """``_nview`` of a y-slab of cell rows ``core`` (rows, nx, K*F) whose
    neighbor rows below and above are ``lo`` and ``hi`` (1, nx, K*F each;
    zero rows at the walls): the slab's rows of the whole grid's view."""
    ny = core.shape[0]
    full = torch.cat([lo, core, hi], dim=0)
    if nx >= 3:
        left, right = full[:, -1:], full[:, :1]
    else:
        left = right = torch.zeros_like(full[:, :1])
    h = torch.cat([left, full, right], dim=1)
    rp = torch.cat([h[:, i:i + nx] for i in range(3)], dim=2)
    out = torch.cat([rp[i:i + ny] for i in range(3)], dim=2)
    return out.reshape(ny * nx, -1)


def _unpack(view, F):
    """(S, 9K*F) -> tuple of F tensors (S, 9K) (fields interleaved per
    slot)."""
    v = view.reshape(view.shape[0], -1, F)
    return tuple(v[:, :, k] for k in range(F))


def _apack(core, F):
    """(ny, nx, K*F) core -> tuple of F tensors (S, K)."""
    v = core.reshape(core.shape[0] * core.shape[1], -1, F)
    return tuple(v[:, :, k] for k in range(F))


def build_layout(spec: GridSpec, x, y, mass, wall_vx, wall_vy,
                 wall_y) -> CellLayout:
    """Assign slots (stable sort by cell + rank) and precompute the static
    per-slot/per-view fields."""
    n = spec.n_total
    dev = x.device
    slot, overflow = assign_slots(spec, x, y)
    fdtype = x.dtype
    is_fluid = (torch.arange(n, device=dev) < spec.n_fluid).to(fdtype)
    ones = torch.ones(n, dtype=fdtype, device=dev)
    is_wall = 1.0 - is_fluid
    core_static = _core(spec, slot, (
        ones, is_fluid, mass, wall_vx, wall_vy,
        is_wall * (wall_y <= 0.0).to(fdtype),
        is_wall * (wall_y >= spec.DH).to(fdtype)))
    valid_v, isf_v, mass_v, wvx_v, wvy_v, wbot_v, wtop_v = _unpack(
        _nview(spec, core_static), 7)
    pid = torch.arange(n, dtype=torch.int32, device=dev)
    pid_core = _core(spec, slot, (pid,), fill=-1, dtype=torch.int32)
    (pid_v,) = _unpack(_nview(spec, pid_core), 1)
    (pid_a,) = _apack(pid_core, 1)
    statics_a = _apack(core_static, 7)
    a_valid, a_fluid = statics_a[0], statics_a[1]
    mass_a = torch.where(a_valid > 0, statics_a[2],
                         torch.ones((), dtype=fdtype, device=dev))
    return CellLayout(
        slot=slot, pid_v=pid_v, pid_a=pid_a, valid_v=valid_v, isf_v=isf_v,
        mass_v=mass_v, wvx_v=wvx_v, wvy_v=wvy_v, wbot_v=wbot_v,
        wtop_v=wtop_v, a_fluid=a_fluid, a_valid=a_valid, mass_a=mass_a,
        ref_x=x, ref_y=y, overflow=overflow)


def pair_view(spec: GridSpec, a):
    """(S, K, 9K) pair-block passthrough."""
    return a.reshape(spec.n_cells, spec.K, -1)


def derive_pair_terms(spec: GridSpec, lay: CellLayout, geom: CellGeometry):
    """Rederive the full per-pair term set from the slim geometry:
    (r_safe, ex, ey, wk, dwk, mask_f, mask_w), each (S, K, 9K)."""
    rm = pair_view(spec, geom.rm)
    ex = pair_view(spec, geom.ex)
    ey = pair_view(spec, geom.ey)
    fvalid = (rm > 0).to(rm.dtype)
    r = torch.where(rm > 0, rm, torch.ones((), dtype=rm.dtype,
                                           device=rm.device))
    wk, dwk = cubic_spline(r, spec.h)
    mask_f = fvalid * lay.isf_v[:, None, :]
    mask_w = fvalid * (1.0 - lay.isf_v[:, None, :])
    return r, ex, ey, wk * fvalid, dwk * fvalid, mask_f, mask_w


def compute_geometry(spec: GridSpec, lay: CellLayout, x, y) -> CellGeometry:
    """Minimum-image pair geometry of every slot against its 3x3 view,
    masked to the interaction cutoff."""
    core_xy = _core(spec, lay.slot, (x, y))
    xa, ya = _apack(core_xy, 2)
    xv, yv = _unpack(_nview(spec, core_xy), 2)
    return pair_geometry(spec, lay, xa, ya, xv, yv)


def pair_geometry(spec: GridSpec, lay: CellLayout, xa, ya, xv,
                  yv) -> CellGeometry:
    """``compute_geometry`` from the slot positions (S, K) and their views
    (S, 9K) of the cells ``lay`` holds (the whole grid, or a y-slab of it
    whose view fields were sliced to its rows)."""
    dx = xa[:, :, None] - xv[:, None, :]
    dx = dx - spec.DL * torch.round(dx / spec.DL)
    dy = ya[:, :, None] - yv[:, None, :]
    r2 = dx * dx + dy * dy
    valid = ((lay.valid_v[:, None, :] > 0)
             & (lay.pid_a[:, :, None] != lay.pid_v[:, None, :])
             & (r2 < spec.cutoff * spec.cutoff) & (r2 > 1e-24))
    r = torch.sqrt(torch.where(valid, r2, torch.ones((), dtype=r2.dtype,
                                                     device=r2.device)))
    fvalid = valid.to(xa.dtype)
    inv_r = 1.0 / r
    return CellGeometry(rm=r * fvalid, ex=dx * inv_r * fvalid,
                        ey=dy * inv_r * fvalid)


def displacement_exceeded(spec: GridSpec, lay: CellLayout, x, y):
    """Skin guard: True (0-dim bool) when some particle moved more than
    skin/2 since the rebuild."""
    if spec.skin <= 0.0:
        return torch.zeros((), dtype=torch.bool, device=x.device)
    ddx = x - lay.ref_x
    ddx = ddx - spec.DL * torch.round(ddx / spec.DL)
    ddy = y - lay.ref_y
    return torch.max(ddx * ddx + ddy * ddy) > (0.5 * spec.skin) ** 2


def count_pairs(lay: CellLayout, geom: CellGeometry):
    """Reference-convention pair count over FLUID-rooted pairs only (wall
    particles also occupy slots, so the masks alone overcount)."""
    n_ff_directed, n_fw = pair_sums(lay, geom)
    return (n_ff_directed / 2 + n_fw).to(torch.int32)


def pair_sums(lay: CellLayout, geom: CellGeometry):
    """(directed fluid-fluid pairs, fluid-wall pairs) rooted at the fluid
    slots of ``lay`` (0-dim float tensors)."""
    S, nine_k = lay.valid_v.shape
    rm = geom.rm.reshape(S, -1, nine_k)
    fvalid = (rm > 0).to(rm.dtype)
    mask_f = fvalid * lay.isf_v[:, None, :]
    mask_w = fvalid * (1.0 - lay.isf_v[:, None, :])
    af = lay.a_fluid[:, :, None]
    return torch.sum(mask_f * af), torch.sum(mask_w * af)


def _where(cond, a, b):
    """``jnp.where`` with Python-number branches in ``cond``'s partner
    dtype (the first tensor among a, b)."""
    like = a if torch.is_tensor(a) else b
    if not torch.is_tensor(a):
        a = torch.tensor(a, dtype=like.dtype, device=like.device)
    if not torch.is_tensor(b):
        b = torch.tensor(b, dtype=like.dtype, device=like.device)
    return torch.where(cond, a, b)


def cell_step(spec: GridSpec, lay: CellLayout, geom: CellGeometry,
              mass, x, y, vx, vy, drho_dt, dt,
              rho0: float, p0: float, c_f: float, inv_sigma0: float,
              transport_coeff: float, g, mu, wall_visc_factor: float = 4.0):
    """One full physics step in cell layout: density+KGC -> viscous(+g) ->
    shifting -> Verlet (stage-1 force, kick, stage 2, finalize). Same
    operator order and formulas as the JAX package's ``cell_step`` and the
    reference inner loop (SPH_Poiseuille.m:254-283).

    Inputs and outputs are per-particle (one packed collect); positions
    are returned pre-wrap. ``dt`` is a 0-dim tensor or a number; ``g`` and
    ``mu`` numbers or 0-dim tensors."""
    core_state = _core(spec, lay.slot, (vx, vy, drho_dt))
    vxa, vya, drho_a = _apack(core_state, 3)
    vxv, vyv, _ = _unpack(_nview(spec, core_state), 3)
    body = cell_step_slots(spec, lay, geom, vxa, vya, drho_a, vxv, vyv, dt,
                           rho0, p0, c_f, inv_sigma0, transport_coeff, g,
                           mu, wall_visc_factor)
    per_slot = run_views([body], lambda reqs: [view_of(spec, reqs[0])])[0]
    return collect_step(spec, lay, per_slot, x, y, vx, vy, dt)


def view_of(spec: GridSpec, slot_arrays):
    """Neighbor views (S, 9K) of F per-slot (S, K) arrays of the grid of
    ``spec`` (the whole grid, or a y-slab's local spec)."""
    F = len(slot_arrays)
    core = torch.stack(list(slot_arrays), dim=-1).reshape(
        spec.ny, spec.nx, spec.K * F)
    return _unpack(_nview(spec, core), F)


def run_views(bodies, views):
    """Drive ``cell_step_slots`` generators in lockstep: at each point where
    they need the neighbor views of per-slot arrays, ``views`` maps the
    list of every body's arrays to the list of their views (the whole
    grid's, or each y-slab's with its neighbors' band rows). Returns each
    body's per-slot outputs."""
    reqs = [next(b) for b in bodies]
    while True:
        sent = [_send(b, v) for b, v in zip(bodies, views(reqs))]
        reqs = [v for _, v in sent]
        if sent[0][0]:
            return reqs


def _send(body, value):
    """(finished, next request or the body's result)."""
    try:
        return False, body.send(value)
    except StopIteration as stop:
        return True, stop.value


def cell_step_slots(spec: GridSpec, lay: CellLayout, geom: CellGeometry,
                    vxa, vya, drho_a, vxv, vyv, dt, rho0: float, p0: float,
                    c_f: float, inv_sigma0: float, transport_coeff: float, g,
                    mu, wall_visc_factor: float = 4.0):
    """The per-slot work of ``cell_step`` over the cells of ``lay`` (the
    whole grid, or a y-slab with ``spec`` its local spec), as a generator:
    it yields the tuple of per-slot arrays whose neighbor views it needs
    next (vol; then B, rho and p at the half step; then the kicked
    velocities), receives those views, and returns the per-slot outputs
    ``collect_step`` takes. ``vxa``..``drho_a`` are the slots' state,
    ``vxv``, ``vyv`` their views."""
    h = spec.h
    af = lay.a_fluid
    pos = af > 0
    r, ex, ey, wk, dwk, m1, mw = derive_pair_terms(spec, lay, geom)
    mass_a = lay.mass_a

    # ---- density summation (sph_physics_mex.c:178-234) ----
    sigma_inner = w0(h) + torch.sum(wk * m1, dim=2)
    sigma_contact = torch.sum(wk * (lay.mass_v[:, None, :] / rho0) * mw,
                              dim=2)
    mass_a_safe = mass_a  # already 1.0 in empty slots
    rho_a = (sigma_inner * rho0 * inv_sigma0
             + sigma_contact * rho0 * rho0 * inv_sigma0 / mass_a_safe)
    rho_a = _where(rho_a <= 1e-12, rho0, rho_a)
    rho_a = _where(pos, rho_a, rho0)          # walls keep rho0
    vol_a = mass_a_safe / rho_a

    (vol_v,) = yield (vol_a,)
    vol_vb = vol_v[:, None, :]

    # ---- kernel gradient correction (sph_physics_mex.c:239-365) ----
    rf = r * dwk * vol_vb * (m1 + mw)
    a11 = -torch.sum(rf * ex * ex, dim=2)
    a12 = -torch.sum(rf * ex * ey, dim=2)
    a21 = a12
    a22 = -torch.sum(rf * ey * ey, dim=2)
    ata11 = a11 * a11 + a21 * a21 + EPS_REG
    ata12 = a11 * a12 + a21 * a22
    ata22 = a12 * a12 + a22 * a22 + EPS_REG
    det_m = ata11 * ata22 - ata12 * ata12
    degenerate = torch.abs(det_m) < 1e-20
    det_m_safe = _where(degenerate, 1.0, det_m)
    im11 = ata22 / det_m_safe
    im12 = -ata12 / det_m_safe
    im22 = ata11 / det_m_safe
    p11 = _where(degenerate, 1.0, im11 * a11 + im12 * a12)
    p12 = _where(degenerate, 0.0, im11 * a21 + im12 * a22)
    p21 = _where(degenerate, 0.0, im12 * a11 + im22 * a12)
    p22 = _where(degenerate, 1.0, im12 * a21 + im22 * a22)
    det_a = a11 * a22 - a12 * a21
    det_sqr = torch.clamp(1.0 - det_a, min=0.0)
    denom = det_a + det_sqr
    small = torch.abs(denom) < 1e-12
    denom_safe = _where(small, 1.0, denom)
    w1 = _where(small, 0.0, det_a / denom_safe)
    w2 = _where(small, 1.0, det_sqr / denom_safe)
    b11_a = _where(pos, w1 * p11 + w2, 1.0)
    b12_a = _where(pos, w1 * p12, 0.0)
    b21_a = _where(pos, w1 * p21, 0.0)
    b22_a = _where(pos, w1 * p22 + w2, 1.0)

    # stage-1 density half-kick + EOS per slot (fluid only)
    rk = rho_a + 0.5 * dt * drho_a
    rho_half_a = _where(pos, _where(rk < 1e-10, rho0, rk), rho_a)
    p_half_a = _where(pos, p0 * (rho_half_a / rho0 - 1.0), 0.0)

    b11_v, b12_v, b21_v, b22_v, rho_half_v, p_half_v = yield (
        b11_a, b12_a, b21_a, b22_a, rho_half_a, p_half_a)

    b11a = b11_a[:, :, None]
    b12a = b12_a[:, :, None]
    b21a = b21_a[:, :, None]
    b22a = b22_a[:, :, None]
    b11v = b11_v[:, None, :]
    b12v = b12_v[:, None, :]
    b21v = b21_v[:, None, :]
    b22v = b22_v[:, None, :]
    vxa_c = vxa[:, :, None]
    vya_c = vya[:, :, None]
    vxv_b = vxv[:, None, :]
    vyv_b = vyv[:, None, :]

    # ---- viscous force (sph_physics_mex.c:466-545) ----
    denom_r = r + 0.01 * h
    ebe_f = (ex * ((b11a + b11v) * ex + (b12a + b12v) * ey)
             + ey * ((b21a + b21v) * ex + (b22a + b22v) * ey))
    ebe_w = ex * (b11a * ex + b12a * ey) + ey * (b21a * ex + b22a * ey)
    coeff_f = ebe_f * mu * dwk * vol_vb / denom_r * m1
    coeff_w = wall_visc_factor * ebe_w * mu * dwk * vol_vb / denom_r * mw
    wvx_b = lay.wvx_v[:, None, :]
    wvy_b = lay.wvy_v[:, None, :]
    acc_x = torch.sum(coeff_f * (vxa_c - vxv_b) + coeff_w * (vxa_c - wvx_b),
                      dim=2)
    acc_y = torch.sum(coeff_f * (vya_c - vyv_b) + coeff_w * (vya_c - wvy_b),
                      dim=2)
    fpx_a = _where(pos, acc_x * vol_a + mass_a * g, 0.0)
    fpy_a = _where(pos, acc_y * vol_a, 0.0)

    # ---- transport (shifting) correction (sph_physics_mex.c:633-709) ----
    tx_f = (b11a + b11v) * ex + (b12a + b12v) * ey
    ty_f = (b21a + b21v) * ex + (b22a + b22v) * ey
    tx_w = b11a * ex + b12a * ey
    ty_w = b21a * ex + b22a * ey
    c_f_pair = -dwk * vol_vb * m1
    c_w_pair = -2.0 * dwk * vol_vb * mw
    inc_x = torch.sum(c_f_pair * tx_f + c_w_pair * tx_w, dim=2)
    inc_y = torch.sum(c_f_pair * ty_f + c_w_pair * ty_w, dim=2)
    limiter = torch.clamp(100.0 * (inc_x * inc_x + inc_y * inc_y) / (h * h),
                          0.0, 1.0)
    shift_scale = transport_coeff * h * h * limiter * af
    dx_shift_a = shift_scale * inc_x
    dy_shift_a = shift_scale * inc_y

    # ---- stage-1 Riemann pressure force (sph_physics_mex.c:867-957) ----
    rho_half_c = rho_half_a[:, :, None]
    p_half_c = p_half_a[:, :, None]
    rho_bar = 0.5 * (rho_half_c + rho_half_v[:, None, :])
    un_l = vxa_c * ex + vya_c * ey
    un_r = vxv_b * ex + vyv_b * ey
    beta = torch.clamp(3.0 * torch.clamp(un_l - un_r, min=0.0), max=c_f)
    p_avg = 0.5 * (p_half_c + p_half_v[:, None, :])
    p_star = p_avg + 0.5 * beta * rho_bar * (un_l - un_r)
    p_face = 0.5 * (p_avg + p_star)
    ptx_f = p_face * ((b11a + b11v) * ex + (b12a + b12v) * ey)
    pty_f = p_face * ((b21a + b21v) * ex + (b22a + b22v) * ey)
    ax_prior = fpx_a / mass_a_safe
    ay_prior = fpy_a / mass_a_safe
    face_acc = -(ax_prior[:, :, None] * ex + ay_prior[:, :, None] * ey)
    p_wall = p_half_c + rho_half_c * r * torch.clamp(face_acc, min=0.0)
    ptx_w = (p_half_c + p_wall) * (b11a * ex + b12a * ey)
    pty_w = (p_half_c + p_wall) * (b21a * ex + b22a * ey)
    dwv = dwk * vol_vb
    pacc_x = -torch.sum((ptx_f * m1 + ptx_w * mw) * dwv, dim=2)
    pacc_y = -torch.sum((pty_f * m1 + pty_w * mw) * dwv, dim=2)
    fx_a = _where(pos, pacc_x * vol_a, 0.0)
    fy_a = _where(pos, pacc_y * vol_a, 0.0)

    # ---- kick (sph_physics_mex.c:1388-1409) ----
    inv_m = 1.0 / mass_a_safe
    vx2_a = _where(pos, vxa + (fpx_a + fx_a) * inv_m * dt, 0.0)
    vy2_a = _where(pos, vya + (fpy_a + fy_a) * inv_m * dt, 0.0)

    # ---- stage-2 continuity (sph_physics_mex.c:1073-1116) ----
    vx2_v, vy2_v = yield (vx2_a, vy2_a)
    vx2c = vx2_a[:, :, None]
    vy2c = vy2_a[:, :, None]
    u_jump_f = ((vx2c - vx2_v[:, None, :]) * ex
                + (vy2c - vy2_v[:, None, :]) * ey)
    u_jump_w = 2.0 * ((vx2c - wvx_b) * ex + (vy2c - wvy_b) * ey)
    rate = torch.sum((u_jump_f * m1 + u_jump_w * mw) * dwv, dim=2)
    drho_new_a = _where(pos, rate * rho_half_a, 0.0)

    # ---- finalize density + EOS (sph_physics_mex.c:1440-1450) ----
    rho_new_a = rho_half_a + 0.5 * dt * drho_new_a
    rho_new_a = _where(rho_new_a < 1e-10, rho0, rho_new_a)
    rho_new_a = _where(pos, rho_new_a, rho_half_a)
    p_new_a = _where(pos, p0 * (rho_new_a / rho0 - 1.0), 0.0)

    return [rho_new_a, p_new_a, drho_new_a, vx2_a, vy2_a, fx_a, fy_a,
            fpx_a, fpy_a, vol_a, b11_a, b12_a, b21_a, b22_a, dx_shift_a,
            dy_shift_a]


def collect_step(spec: GridSpec, lay: CellLayout, per_slot, x, y, vx, vy,
                 dt):
    """The end of ``cell_step``: the per-slot outputs of every cell (S, K)
    back to particle order (one take; the overflow sentinel is clamped,
    as the JAX gather clamps) and the position update of each particle
    (shifting + two half drifts)."""
    nf = spec.n_fluid
    pack = torch.stack([a.reshape(-1) for a in per_slot], dim=-1)
    got = pack[torch.clamp(lay.slot, max=pack.shape[0] - 1)]
    (rho_p, p_p, drho_p, vx2_p, vy2_p, fx_p, fy_p, fpx_p, fpy_p, vol_p,
     b11_p, b12_p, b21_p, b22_p, dxs_p, dys_p) = got.unbind(dim=1)

    x2 = x + dxs_p + 0.5 * dt * vx + 0.5 * dt * vx2_p
    y2 = y + dys_p + 0.5 * dt * vy + 0.5 * dt * vy2_p
    fluid_mask = (torch.arange(spec.n_total, device=x.device)
                  < nf).to(x.dtype)
    x2 = x * (1 - fluid_mask) + x2 * fluid_mask
    y2 = y * (1 - fluid_mask) + y2 * fluid_mask

    return dict(rho=rho_p, p=p_p, drho_dt=drho_p, vx=vx2_p, vy=vy2_p,
                fx=fx_p, fy=fy_p, fpx=fpx_p, fpy=fpy_p, vol=vol_p,
                b11=b11_p, b12=b12_p, b21=b21_p, b22=b22_p,
                x=x2, y=y2)


def cell_wall_shear(spec: GridSpec, lay: CellLayout, geom: CellGeometry,
                    vx, vol, b11, b12, b21, b22, mu,
                    wall_visc_factor: float = 4.0):
    """Wall-shear monitor on the (freshly rebuilt) layout with the current
    step's vol/B and post-kick velocities (SPH_Poiseuille.m:280-283;
    formula sph_physics_mex.c:1713-1742): (tau_bottom, tau_top) as 0-dim
    tensors."""
    core = _core(spec, lay.slot, (vx, vol, b11, b12, b21, b22))
    vol_v = _unpack(_nview(spec, core), 6)[1]
    sb, st = shear_sums(spec, lay, geom, _apack(core, 6), vol_v, mu,
                        wall_visc_factor)
    return -sb / spec.DL, -st / spec.DL


def shear_sums(spec: GridSpec, lay: CellLayout, geom: CellGeometry, slots,
               vol_v, mu, wall_visc_factor: float = 4.0):
    """The bottom and top sums of ``cell_wall_shear`` over the cells of
    ``lay`` (the whole grid, or a y-slab with ``spec`` its local spec):
    ``slots`` the slots' (vx, vol, b11, b12, b21, b22), ``vol_v`` the view
    of vol."""
    vxa, vol_a, b11_a, b12_a, b21_a, b22_a = slots
    r, ex, ey, _, dwk, _, mask_w = derive_pair_terms(spec, lay, geom)
    ebe = (ex * (b11_a[:, :, None] * ex + b12_a[:, :, None] * ey)
           + ey * (b21_a[:, :, None] * ex + b22_a[:, :, None] * ey))
    dv_x = vxa[:, :, None] - lay.wvx_v[:, None, :]
    f_pair = (wall_visc_factor * mu * ebe * dwk * vol_v[:, None, :] * dv_x
              / (r + 0.01 * spec.h)
              * vol_a[:, :, None]) * mask_w
    return (torch.sum(f_pair * lay.wbot_v[:, None, :]),
            torch.sum(f_pair * lay.wtop_v[:, None, :]))
