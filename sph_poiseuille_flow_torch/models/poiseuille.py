"""Poiseuille channel scene: fluid lattice + thick-wall dummy particles.

Maps the reference's particle initialization (SPH_Poiseuille.m:93-125) and
wall generator (build_shell_wall_particles.m:1-39) into a host-side NumPy
``Scene`` that the device state is built from. The index convention is
preserved: fluid particles first (indices < n_fluid), walls last.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import SPHConfig, ConfigError


@dataclasses.dataclass(frozen=True)
class Scene:
    """Host-side immutable scene description (float64 NumPy arrays)."""

    n_fluid: int
    n_wall: int
    x: np.ndarray           # (n_total,)
    y: np.ndarray           # (n_total,)
    mass: np.ndarray        # (n_total,)
    wall_normal: np.ndarray # (n_wall, 2) — into-wall normals, kept for parity
    wall_measure: np.ndarray        # (n_wall,)
    wall_thickness_arr: np.ndarray  # (n_wall,)

    @property
    def n_total(self) -> int:
        return self.n_fluid + self.n_wall


def fluid_lattice(DL: float, DH: float, dp: float):
    """Cell-centered fluid lattice over [0,DL]x[0,DH]
    (reference: SPH_Poiseuille.m:95-98)."""
    nx = int(round(DL / dp))
    ny = int(round(DH / dp))
    xs = (np.arange(nx) + 0.5) * dp
    ys = (np.arange(ny) + 0.5) * dp
    X, Y = np.meshgrid(xs, ys)  # row = y, col = x
    return X.ravel(), Y.ravel()


def build_wall_particles(DL: float, DH: float, dp: float, wall_thickness: float):
    """Thick-wall dummy lattices below y=0 and above y=DH
    (reference: build_shell_wall_particles.m:14-38).

    Returns (x, y, wall_normal, wall_measure, wall_thickness_arr) with the
    bottom block first, then the top block. Normals point INTO the wall.
    """
    if DL <= 0 or DH <= 0 or dp <= 0 or wall_thickness <= 0:
        raise ConfigError("DL, DH, dp, wall_thickness must all be positive")
    n_layers = int(round(wall_thickness / dp))
    if abs(n_layers * dp - wall_thickness) > 1e-12:
        raise ConfigError("wall_thickness must be an integer multiple of dp")
    if n_layers < 1:
        raise ConfigError("wall needs at least one particle layer")

    nx = int(round(DL / dp))
    xs = (np.arange(nx) + 0.5) * dp
    y_bottom = -wall_thickness + (np.arange(n_layers) + 0.5) * dp
    y_top = DH + (np.arange(n_layers) + 0.5) * dp

    Xb, Yb = np.meshgrid(xs, y_bottom)
    Xt, Yt = np.meshgrid(xs, y_top)
    x = np.concatenate([Xb.ravel(), Xt.ravel()])
    y = np.concatenate([Yb.ravel(), Yt.ravel()])

    n_bottom = Xb.size
    n_top = Xt.size
    wall_normal = np.concatenate([
        np.tile([0.0, -1.0], (n_bottom, 1)),
        np.tile([0.0, 1.0], (n_top, 1)),
    ])
    wall_measure = np.full(n_bottom + n_top, dp)
    wall_thickness_arr = np.full(n_bottom + n_top, dp)
    return x, y, wall_normal, wall_measure, wall_thickness_arr


def build_scene(cfg: SPHConfig) -> Scene:
    """Assemble the full Poiseuille scene (fluid first, walls last).

    Masses: m_fluid = rho0*dp^2, m_wall = rho0*(measure*thickness)
    (reference: SPH_Poiseuille.m:116-119).
    """
    xf, yf = fluid_lattice(cfg.DL, cfg.DH, cfg.dp)
    xw, yw, wall_normal, wall_measure, wall_thickness_arr = build_wall_particles(
        cfg.DL, cfg.DH, cfg.dp, cfg.wall_thickness)

    n_fluid = xf.size
    n_wall = xw.size
    mass = np.concatenate([
        np.full(n_fluid, cfg.rho0 * cfg.dp ** 2),
        cfg.rho0 * wall_measure * wall_thickness_arr,
    ])
    return Scene(
        n_fluid=n_fluid, n_wall=n_wall,
        x=np.concatenate([xf, xw]), y=np.concatenate([yf, yw]),
        mass=mass, wall_normal=wall_normal, wall_measure=wall_measure,
        wall_thickness_arr=wall_thickness_arr,
    )
