"""Verlet kick-drift-kick integration with low-dissipation Riemann
pressure (torch port of the JAX package's ``ops/integration.py``; the
reference's ``integration_1st`` / ``integration_2nd`` /
``integration_verlet`` modes, sph_physics_mex.c:736-967, 987-1119,
1316-1469).

``verlet_dt`` and ``periodic_wrap`` serve every engine. The row-math
operators below are the gather engine's (``stepper.Engine``); the fused
engine runs the same physics inside the sweeps of ``ops/fused_cell.py``:

stage 1 (c:857-957): rho += dt/2 * drho_dt_prev (floor 1e-10 -> rho0),
  EOS p = p0(rho/rho0 - 1), pos += dt/2 * v, then the Riemann-stabilized
  pressure force (p* = (p_i+p_j)/2 + beta/2 rho_bar (u_L - u_R),
  beta = min(3 max(u_L - u_R, 0), c_f); c:885-892), the virtual wall
  pressure p_wall = p_i + rho_i r max(0, -a.e) (c:926-950) and the
  Riemann dissipation density rate (c:918-925, 953-957);
kick (c:1388-1409): v += (F_prior + F_pressure)/m * dt; walls v = 0;
stage 2 (c:1066-1116): pos += dt/2 * v_new; continuity rate from the
  velocity divergence with the mirrored no-slip wall velocity;
finalize (c:1429-1451): rho += dt/2 * drho_new (floor -> rho0), EOS.
"""

from __future__ import annotations

import torch

from .neighbors import Candidates, Geometry, GridSpec, gather_pack


def _c(v, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim constant of ``like``'s dtype and device (so a constant on
    the LEFT of a division rounds once, as in the JAX package, instead of
    going through torch's reciprocal-times form)."""
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def verlet_dt(vx_f: torch.Tensor, vy_f: torch.Tensor, c_f: float, h: float,
              nu, gravity_g, remain) -> torch.Tensor:
    """Unified Verlet dt: min(acoustic, viscous, body-force, remaining)
    (reference: SPH_Poiseuille.m:519-527), as a 0-dim tensor."""
    v_max = torch.sqrt(torch.max(vx_f * vx_f + vy_f * vy_f))
    nu = torch.as_tensor(nu, dtype=v_max.dtype, device=v_max.device)
    g = torch.as_tensor(gravity_g, dtype=v_max.dtype, device=v_max.device)
    remain = torch.as_tensor(remain, dtype=v_max.dtype, device=v_max.device)
    tiny = _c(1e-12, v_max)
    dt_acoustic = _c(0.25 * h, v_max) / torch.maximum(c_f + v_max, tiny)
    dt_viscous = _c(0.125 * h * h, v_max) / torch.maximum(nu, tiny)
    dt_body = 0.25 * torch.sqrt(_c(h, v_max) / torch.maximum(g.abs(), tiny))
    dt = torch.minimum(torch.minimum(dt_acoustic, dt_viscous),
                       torch.minimum(dt_body, remain))
    return torch.maximum(dt, tiny)


def periodic_wrap(spec: GridSpec, x: torch.Tensor) -> torch.Tensor:
    """x <- mod(x, DL) for fluid particles (SPH_Poiseuille.m:570-577)."""
    nf = spec.n_fluid
    return torch.cat([torch.remainder(x[:nf], spec.DL), x[nf:]])


def half_kick_eos(spec: GridSpec, rho, drho_dt, dt, rho0: float, p0: float):
    """rho += dt/2 * drho_prev (floor -> rho0), EOS; walls keep rho, p = 0
    (sph_physics_mex.c:857-862)."""
    nf = spec.n_fluid
    n_wall = spec.n_total - nf
    rho_f = rho[:nf] + 0.5 * dt * drho_dt[:nf]
    rho_f = torch.where(rho_f < 1e-10, rho0, rho_f)
    p_f = p0 * (rho_f / rho0 - 1.0)
    rho_half = torch.cat([rho_f, rho[nf:]])
    p_half = torch.cat([p_f, p_f.new_zeros((n_wall,))])
    return rho_half, p_half


def half_drift(spec: GridSpec, x, y, vx, vy, dt):
    """pos += dt/2 * v for fluid (used by both stages)."""
    nf = spec.n_fluid
    x = torch.cat([x[:nf] + 0.5 * dt * vx[:nf], x[nf:]])
    y = torch.cat([y[:nf] + 0.5 * dt * vy[:nf], y[nf:]])
    return x, y


def pressure_force(spec: GridSpec, geom: Geometry, cands: Candidates,
                   rho_half, p_half, mass, vx, vy, fpx, fpy, vol,
                   b11, b12, b21, b22,
                   vol_j, b11_j, b12_j, b21_j, b22_j, vx_j, vy_j,
                   rho_half_j, p_half_j, rho0: float, c_f: float):
    """Riemann-stabilized pressure force + dissipation density rate
    (stage 1 pair loop, sph_physics_mex.c:867-957).
    Returns (fx, fy, drho_diss), all (n_total,) with wall rows zero."""
    nf = spec.n_fluid
    n_wall = spec.n_total - nf
    ex, ey = geom.ex, geom.ey
    dwv_j = geom.dw * vol_j

    b11i = b11[:nf][:, None]
    b12i = b12[:nf][:, None]
    b21i = b21[:nf][:, None]
    b22i = b22[:nf][:, None]
    p_i = p_half[:nf][:, None]
    rho_i = rho_half[:nf][:, None]
    vxi = vx[:nf][:, None]
    vyi = vy[:nf][:, None]

    # --- fluid-fluid: low-dissipation Riemann face pressure ---
    rho_bar = 0.5 * (rho_i + rho_half_j)
    un_l = vxi * ex + vyi * ey
    un_r = vx_j * ex + vy_j * ey
    compression = torch.clamp(un_l - un_r, min=0.0)
    beta = torch.clamp(3.0 * compression, max=c_f)
    p_avg = 0.5 * (p_i + p_half_j)
    p_star = p_avg + 0.5 * beta * rho_bar * (un_l - un_r)
    p_face = 0.5 * (p_avg + p_star)
    tx_f = p_face * ((b11i + b11_j) * ex + (b12i + b12_j) * ey)
    ty_f = p_face * ((b21i + b21_j) * ex + (b22i + b22_j) * ey)

    # --- fluid-wall: virtual wall pressure (no-penetration) ---
    ax = (fpx[:nf] / mass[:nf])[:, None]
    ay = (fpy[:nf] / mass[:nf])[:, None]
    face_wall_ext_acc = -(ax * ex + ay * ey)
    p_wall = p_i + rho_i * geom.r * torch.clamp(face_wall_ext_acc, min=0.0)
    tx_w = (p_i + p_wall) * (b11i * ex + b12i * ey)
    ty_w = (p_i + p_wall) * (b21i * ex + b22i * ey)

    acc_x = -torch.sum((tx_f * geom.mask_f + tx_w * geom.mask_w) * dwv_j,
                       dim=1)
    acc_y = -torch.sum((ty_f * geom.mask_f + ty_w * geom.mask_w) * dwv_j,
                       dim=1)
    diss = torch.sum(((p_i - p_half_j) * geom.mask_f
                      + (p_i - p_wall) * geom.mask_w)
                     / (rho0 * c_f) * dwv_j, dim=1)

    zeros_w = acc_x.new_zeros((n_wall,))
    fx = torch.cat([acc_x * vol[:nf], zeros_w])
    fy = torch.cat([acc_y * vol[:nf], zeros_w])
    drho_diss = torch.cat([diss * rho_half[:nf], zeros_w])
    return fx, fy, drho_diss


def kick(spec: GridSpec, vx, vy, fpx, fpy, fx, fy, mass, dt):
    """Full-step velocity kick; walls pinned to zero
    (sph_physics_mex.c:1388-1409)."""
    nf = spec.n_fluid
    n_wall = spec.n_total - nf
    inv_m = 1.0 / mass[:nf]
    vx_f = vx[:nf] + (fpx[:nf] + fx[:nf]) * inv_m * dt
    vy_f = vy[:nf] + (fpy[:nf] + fy[:nf]) * inv_m * dt
    zeros_w = vx.new_zeros((n_wall,))
    return torch.cat([vx_f, zeros_w]), torch.cat([vy_f, zeros_w])


def continuity_rate(spec: GridSpec, geom: Geometry, cands: Candidates,
                    rho_half, vx, vy, vol_j, vx_j, vy_j):
    """Continuity density rate from velocity divergence with mirrored
    no-slip wall velocity (stage 2 pair loop, sph_physics_mex.c:1073-1116).
    ``rho_half`` is stage 1's density (sph_physics_mex.c:1420); velocities
    are post-kick."""
    nf = spec.n_fluid
    n_wall = spec.n_total - nf
    ex, ey = geom.ex, geom.ey
    dwv_j = geom.dw * vol_j
    vxi = vx[:nf][:, None]
    vyi = vy[:nf][:, None]

    u_jump_f = (vxi - vx_j) * ex + (vyi - vy_j) * ey
    # mirrored no-slip wall velocity: v_mirror = 2*wall_vel - v_i, so the
    # jump doubles the fluid-relative velocity (sph_physics_mex.c:1100-1108)
    u_jump_w = 2.0 * ((vxi - cands.wvx_j) * ex + (vyi - cands.wvy_j) * ey)

    rate = torch.sum((u_jump_f * geom.mask_f + u_jump_w * geom.mask_w)
                     * dwv_j, dim=1)
    return torch.cat([rate * rho_half[:nf], rate.new_zeros((n_wall,))])


def finalize_density(spec: GridSpec, rho_half, drho_new, dt,
                     rho0: float, p0: float):
    """rho += dt/2 * drho_new, floor, EOS (sph_physics_mex.c:1440-1450)."""
    nf = spec.n_fluid
    n_wall = spec.n_total - nf
    rho_f = rho_half[:nf] + 0.5 * dt * drho_new[:nf]
    rho_f = torch.where(rho_f < 1e-10, rho0, rho_f)
    p_f = p0 * (rho_f / rho0 - 1.0)
    rho = torch.cat([rho_f, rho_half[nf:]])
    p = torch.cat([p_f, p_f.new_zeros((n_wall,))])
    return rho, p


def verlet_step(spec: GridSpec, geom: Geometry, cands: Candidates, vol,
                b11, b12, b21, b22, rho, mass, x, y, vx, vy,
                drho_dt, fpx, fpy, dt, rho0: float, p0: float, c_f: float):
    """Composite single-step Verlet advance (sph_physics_mex.c:1316-1469)
    with its own packed gathers. Returns
    (rho, p, x, y, vx, vy, drho_dt, fx, fy). ``stepper.Engine`` inlines the
    same sequence to share gathers with the other operators."""
    rho_half, p_half = half_kick_eos(spec, rho, drho_dt, dt, rho0, p0)
    x_half, y_half = half_drift(spec, x, y, vx, vy, dt)

    (vol_j, b11_j, b12_j, b21_j, b22_j, vx_j, vy_j, rho_half_j,
     p_half_j) = gather_pack(cands.jsafe, (vol, b11, b12, b21, b22, vx, vy,
                                           rho_half, p_half))
    fx, fy, _ = pressure_force(
        spec, geom, cands, rho_half, p_half, mass, vx, vy, fpx, fpy, vol,
        b11, b12, b21, b22, vol_j, b11_j, b12_j, b21_j, b22_j, vx_j, vy_j,
        rho_half_j, p_half_j, rho0, c_f)

    vx2, vy2 = kick(spec, vx, vy, fpx, fpy, fx, fy, mass, dt)
    x2, y2 = half_drift(spec, x_half, y_half, vx2, vy2, dt)
    vx2_j, vy2_j = gather_pack(cands.jsafe, (vx2, vy2))
    drho_new = continuity_rate(spec, geom, cands, rho_half, vx2, vy2,
                               vol_j, vx2_j, vy2_j)
    rho_new, p_new = finalize_density(spec, rho_half, drho_new, dt,
                                      rho0, p0)
    return rho_new, p_new, x2, y2, vx2, vy2, drho_new, fx, fy
