"""Multi-device decomposition (torch port of the JAX package's
``parallel/sharding.py``): the fused engine and the cell-layout engine
split into y-slabs of cell rows, the gather engine into blocks of neighbor
rows.

The JAX package runs one controller over N devices in one process
(``shard_map`` and GSPMD). The port does the same with explicit devices:
one process holds N slabs, slab i on ``mesh.devices[i]`` (``cuda:0..N-1``
on a host with N cards, every slab on ``cuda:0`` on fewer, N CPU slabs
with ``--device cpu``; ``virtual.ensure_devices``). What the JAX package
does over ICI the port does by copies between the slabs' devices, written
as small helpers: ``_exchange_bands`` (``lax.ppermute`` of ghost bands,
or an ``all_gather`` of the slab axis for slabs shallower than the band),
``_pmax``/``_psum`` (a reduction on the first device) and ``_all_gather``
(a ``cat`` there). Every slab then takes the same decision, as every JAX
device does. Per-particle state is replicated, that is it lives once on
the first device (every device of a one-card mesh).

* ``ShardedPallasEngine`` (the path "auto" resolves to in float32): each
  step every slab takes a ``ghost``-row band of the five dynamic state
  slabs from its y-neighbors and runs the unmodified fused step kernel
  (``ops/fused_cell.fused_step_cores``) on its extended slab. The ghost
  depth is the kernel's cross-row dependency depth (4 sweeps x a 1-row
  stencil), so every interior output is exact and the band's outputs are
  dropped. Rebuilds are slab-local (particles ranked by id within a
  cell), the drift guard runs on mesh-merged bounds, and the trajectory
  is the single-device chunk trajectory bit for bit. A one-device mesh
  with ghost=4 runs the chunk kernel on its extended slab; with ghost=0
  (its default) it runs ``PallasCellEngine.run_interval`` as it is.
* ``ShardedCellEngine``: ``CellEngine`` with its cell axis split into
  y-slabs; the 3x3 neighbor views of the per-slot values a slab computes
  take a one-row band from each neighbor (where the JAX package lets
  GSPMD insert the halo exchange).
* ``ShardedEngine``: the gather engine with its ``(n_fluid, C)`` candidate
  and geometry rows split into one block per device; the row-wise
  operators run per block and their per-particle outputs are gathered.

The reference mechanism is the ghost-entry halo
(sph_neighbor_search_mex.c:282-295), pointed across the mesh.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import SPHConfig
from ..models.poiseuille import Scene
from ..ops import cellgrid as cg
from ..ops import fused_cell as pc
from ..ops import neighbors as nbr
from ..ops.density import density_sums, kernel_gradient_correction
from ..ops.integration import (continuity_rate, finalize_density, half_drift,
                               half_kick_eos, kick, periodic_wrap,
                               pressure_force, verlet_dt)
from ..ops.monitors import wall_shear
from ..ops.neighbors import gather_pack
from ..ops.transport import transport_correction
from ..ops.viscosity import viscous_force
from ..stepper import (CellEngine, Engine, IntervalResult,
                       PallasCellEngine, State, _t_add)
from .virtual import ensure_devices, is_virtual

AXIS = "shard"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the device of each slab (``AXIS``) and their count."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def virtual(self) -> bool:
        return is_virtual(self.devices)


def make_mesh(n_devices: Optional[int] = None, devices=None,
              device="cuda") -> Mesh:
    """1-D mesh over the first ``n_devices`` of ``devices``, by default
    those ``virtual.ensure_devices`` gives for ``device``."""
    if devices is None:
        devices = ensure_devices(1 if n_devices is None else n_devices,
                                 device)
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"requested {n_devices} devices, only {len(devices)} present")
        devices = devices[:n_devices]
    return Mesh(tuple(devices))


# ---------------------------------------------------------------------------
# collectives over the slabs of one process
# ---------------------------------------------------------------------------


def _pmax(vals, device):
    """``lax.pmax``: the max of one 0-dim value per slab, on ``device``."""
    return torch.amax(torch.stack([v.to(device) for v in vals]))


def _psum(vals, device):
    """``lax.psum``: the sum of one 0-dim value per slab, in slab order."""
    out = vals[0].to(device)
    for v in vals[1:]:
        out = out + v.to(device)
    return out


def _all_gather(parts, device, dim: int = 0):
    """``lax.all_gather(..., tiled=True)``: the slabs' parts concatenated in
    slab order on ``device``."""
    return torch.cat([p.to(device) for p in parts], dim=dim)


def _exchange_bands(slabs, fill, G: int, rows_loc: int, gather_mode: bool):
    """(lo, hi) ``G``-row ghost bands of every y-slab, on its device: lo is
    the last G rows of the slab below, hi the first G rows of the slab
    above; the edge slabs read ``fill`` (walls bound y, nothing beyond).
    ``gather_mode`` (slabs shallower than G) gathers every slab and slices
    the bands out of the whole, as the JAX package's ``all_gather`` does:
    the same values, more bytes."""
    def cap(like):
        return torch.full((G,) + tuple(like.shape[1:]), fill,
                          dtype=like.dtype, device=like.device)

    n = len(slabs)
    if n == 1:
        z = cap(slabs[0])
        return [(z, z)]
    if gather_mode:
        full = _all_gather(slabs, slabs[0].device)
        c = cap(full)
        padded = torch.cat([c, full, c], dim=0)
        out = []
        for i, s in enumerate(slabs):
            i0 = i * rows_loc
            out.append((padded[i0:i0 + G].to(s.device),
                        padded[i0 + rows_loc + G:i0 + rows_loc + 2 * G]
                        .to(s.device)))
        return out
    return [(slabs[i - 1][-G:].to(s.device) if i > 0 else cap(s),
             slabs[i + 1][:G].to(s.device) if i < n - 1 else cap(s))
            for i, s in enumerate(slabs)]


def _split_rows(a, rows_loc: int, n: int, fill, devices):
    """Pad the leading (row) axis of ``a`` to ``n * rows_loc`` with ``fill``
    and hand slab i its ``rows_loc`` rows on ``devices[i]``."""
    if a.shape[0] < n * rows_loc:
        a = torch.cat([a, torch.full((n * rows_loc - a.shape[0],)
                                     + tuple(a.shape[1:]), fill,
                                     dtype=a.dtype, device=a.device)])
    return [a[i * rows_loc:(i + 1) * rows_loc].to(d)
            for i, d in enumerate(devices)]


def _scalar_on(v, device):
    """A number or a 0-dim tensor, as the slab on ``device`` takes it."""
    return v.to(device) if torch.is_tensor(v) else v


# ---------------------------------------------------------------------------
# the gather engine, row-sharded
# ---------------------------------------------------------------------------


class RowBlocks(NamedTuple):
    """The gather engine's candidates with their rows split into blocks:
    the whole set (for the drift guard) and each block's rows on its
    device (``jsafe`` still indexes particles)."""

    full: nbr.Candidates
    blocks: tuple
    overflow: torch.Tensor


class ShardedEngine(Engine):
    """The packed-gather engine whose ``(n_fluid, C)`` neighbor rows are
    split into ``mesh.size`` blocks, one per device (the JAX package's
    ``ShardedEngine``, sharding.py:86-146, where GSPMD partitions the rows
    of one jitted step). Per-particle state is replicated; each row-wise
    operator runs on each block, and its per-particle output is gathered
    before the next packed gather reads it.

    A block runs the unchanged operators of ``ops/`` on arrays laid out as
    [its own fluid rows, then every particle] under a spec whose
    ``n_fluid`` is the block's row count: the operators' own-row side
    (``a[:n_fluid]``) is the block's rows, and the neighbor side gathers
    from the whole arrays (``jsafe`` offset by the block's row count).
    Every row adds the same terms in the same order as on one device, so
    only the cross-row sums (the pair count, the wall shear) add in
    another order."""

    def __init__(self, cfg: SPHConfig, scene: Scene, mesh: Mesh):
        n = mesh.size
        if scene.n_fluid % n != 0:
            raise ValueError(
                f"n_fluid={scene.n_fluid} must divide evenly over {n} "
                f"devices (pad the lattice or choose dp so DL/dp*DH/dp is "
                f"a multiple of the mesh size)")
        super().__init__(cfg, scene, mesh.devices[0])
        self.mesh = mesh
        nb = scene.n_fluid // n
        self._nb = nb
        self._bspec = dataclasses.replace(self.spec, n_fluid=nb,
                                          n_total=nb + self.spec.n_total)

    def _blk(self, i: int, a):
        """Block i's layout of a per-particle array: its rows, then all."""
        nb = self._nb
        return torch.cat([a[i * nb:(i + 1) * nb], a]).to(
            self.mesh.devices[i])

    def _gather(self, outs):
        """The per-particle array of the blocks' outputs (each laid out as
        ``_blk``): every block's rows, then the walls."""
        nb, nf, dev = self._nb, self.spec.n_fluid, self.device
        return torch.cat([o[:nb].to(dev) for o in outs]
                         + [outs[0][nb + nf:].to(dev)])

    def _each(self, fn, n_out: int):
        """Run ``fn(i)`` on every block and gather its ``n_out`` outputs."""
        outs = [fn(i) for i in range(self.mesh.size)]
        return tuple(self._gather([o[k] for o in outs])
                     for k in range(n_out))

    def _rebuild(self, x, y):
        full = Engine._rebuild(self, x, y)
        nb = self._nb
        blocks = tuple(
            nbr.Candidates(*[
                (a[i * nb:(i + 1) * nb].to(d) if a.dim() == 2 else a)
                for a in full])
            for i, d in enumerate(self.mesh.devices))
        return RowBlocks(full, blocks, full.overflow)

    def _drift_over(self, lay, x, y):
        return nbr.displacement_exceeded(self.spec, lay.full, x, y)

    def _geometry(self, lay, state: State):
        return tuple(
            nbr.compute_geometry(
                self._bspec, c._replace(jsafe=c.jsafe + self._nb),
                self._blk(i, state.x), self._blk(i, state.y),
                self._blk(i, state.vol))
            for i, c in enumerate(lay.blocks))

    def _count_pairs(self, lay, geom):
        ff = _psum([torch.sum(g.mask_f) for g in geom], self.device)
        fw = _psum([torch.sum(g.mask_w) for g in geom], self.device)
        return (ff / 2 + fw).to(torch.int32)

    def _gathered(self, lay, arrays):
        """Each block's packed gather of the per-particle ``arrays``."""
        return [gather_pack(c.jsafe, [a.to(c.jsafe.device) for a in arrays])
                for c in lay.blocks]

    def _density(self, lay, geom):
        cfg = self.cfg
        return self._each(lambda i: density_sums(
            self._bspec, geom[i], lay.blocks[i], self._blk(i, self._mass),
            cfg.rho0, cfg.inv_sigma0), 2)

    def _advance(self, state: State, lay, geom, remain, g, mu):
        """``Engine._advance`` with each row-wise operator run per block."""
        cfg, spec = self.cfg, self.spec
        nf = spec.n_fluid
        mass = self._mass
        B, bs = self._blk, self._bspec
        dt = verlet_dt(state.vx[:nf], state.vy[:nf], cfg.c_f, cfg.h,
                       mu / cfg.rho0, g, remain)

        rho, vol = self._density(lay, geom)
        rho_half, p_half = half_kick_eos(spec, rho, state.drho_dt, dt,
                                         cfg.rho0, cfg.p0)
        jA = self._gathered(lay, (vol,))                          # gather A
        b11, b12, b21, b22 = self._each(lambda i: kernel_gradient_correction(
            bs, geom[i], jA[i][0]), 4)
        jB = self._gathered(lay, (b11, b12, b21, b22, state.vx, state.vy,
                                  rho_half, p_half))              # gather B

        def own(i, *arrays):
            return [B(i, a) for a in arrays]

        fpx, fpy = self._each(lambda i: viscous_force(
            bs, geom[i], lay.blocks[i],
            *own(i, state.vx, state.vy, vol, b11, b12, b21, b22),
            jA[i][0], *jB[i][:6], mu, cfg.h, cfg.wall_visc_factor), 2)
        fpx = torch.cat([fpx[:nf] + mass[:nf] * g, fpx[nf:]])
        x, y = self._each(lambda i: transport_correction(
            bs, geom[i], *own(i, state.x, state.y, b11, b12, b21, b22),
            jA[i][0], *jB[i][:4], cfg.h, cfg.transport_coeff), 2)

        x, y = half_drift(spec, x, y, state.vx, state.vy, dt)
        fx, fy = self._each(lambda i: pressure_force(
            bs, geom[i], lay.blocks[i],
            *own(i, rho_half, p_half, mass, state.vx, state.vy, fpx, fpy,
                 vol, b11, b12, b21, b22),
            jA[i][0], *jB[i], cfg.rho0, cfg.c_f)[:2], 2)
        vx2, vy2 = kick(spec, state.vx, state.vy, fpx, fpy, fx, fy, mass,
                        dt)
        x, y = half_drift(spec, x, y, vx2, vy2, dt)
        jC = self._gathered(lay, (vx2, vy2))                      # gather C
        (drho_dt,) = self._each(lambda i: (continuity_rate(
            bs, geom[i], lay.blocks[i], *own(i, rho_half, vx2, vy2),
            jA[i][0], *jC[i]),), 1)
        rho, p = finalize_density(spec, rho_half, drho_dt, dt, cfg.rho0,
                                  cfg.p0)
        x = periodic_wrap(spec, x)
        return State(x=x, y=y, vx=vx2, vy=vy2, rho=rho, p=p,
                     drho_dt=drho_dt, fx=fx, fy=fy, fpx=fpx, fpy=fpy,
                     vol=vol, b11=b11, b12=b12, b21=b21, b22=b22), dt

    def init(self, state: State):
        """``Engine.init`` with its row-wise operators run per block."""
        cfg, spec = self.cfg, self.spec
        nf = spec.n_fluid
        cands = self._rebuild(state.x, state.y)
        geom = self._geometry(cands, state)
        rho, vol = self._density(cands, geom)
        jA = self._gathered(cands, (vol,))
        b11, b12, b21, b22 = self._each(lambda i: kernel_gradient_correction(
            self._bspec, geom[i], jA[i][0]), 4)
        p_f = cfg.p0 * (rho[:nf] / cfg.rho0 - 1.0)
        p = torch.cat([p_f, p_f.new_zeros((spec.n_total - nf,))])
        state = state._replace(rho=rho, p=p, vol=vol, b11=b11, b12=b12,
                               b21=b21, b22=b22)
        return state, cands, geom, cands.overflow

    def final_shear(self, state: State, lay, geom, mu):
        """The wall shear of each block's rows, summed over the blocks."""
        cfg = self.cfg
        taus = [wall_shear(
            self._bspec, geom[i], lay.blocks[i],
            *[self._blk(i, a) for a in (state.vx, state.vol, state.b11,
                                        state.b12, state.b21, state.b22)],
            cfg.DL, mu, cfg.h, cfg.wall_visc_factor)
            for i in range(self.mesh.size)]
        return (_psum([t[0] for t in taus], self.device),
                _psum([t[1] for t in taus], self.device))


# ---------------------------------------------------------------------------
# the cell-layout engine, y-slab sharded
# ---------------------------------------------------------------------------


class SlabLayout(NamedTuple):
    """The cell layout of the whole grid (slot assignment, drift
    references) and each y-slab's slot and view fields on its device."""

    full: cg.CellLayout
    slabs: tuple
    overflow: torch.Tensor


# the S-major fields of a CellLayout and the value of a padding cell
_CELL_FILLS = dict(pid_v=-1, pid_a=-1, valid_v=0.0, isf_v=0.0, mass_v=0.0,
                   wvx_v=0.0, wvy_v=0.0, wbot_v=0.0, wtop_v=0.0,
                   a_fluid=0.0, a_valid=0.0, mass_a=1.0)


class ShardedCellEngine(CellEngine):
    """Spatial domain decomposition of the cell-layout engine (the JAX
    package's ``ShardedCellEngine``, sharding.py:149-210). The grid's cell
    rows (ny, padded so that S = ny*nx divides by the mesh, as the JAX
    package pads them; and to whole slabs of ``rows_loc`` rows, whose
    extra cells are empty) split into contiguous y-slabs, one per device.
    Per-particle state stays replicated; all (S, K, 9K) pair work is
    slab-local. The per-slot values a slab computes (vol; B and rho, p at
    the half step; the kicked velocities) reach its neighbors' 3x3 views
    through a one-row band (``_exchange_bands``), where the JAX package
    lets GSPMD insert the halo exchange."""

    def __init__(self, cfg: SPHConfig, scene: Scene, mesh: Mesh):
        super().__init__(cfg, scene, mesh.devices[0], s_multiple=mesh.size)
        self.mesh = mesh
        n, spec = mesh.size, self.spec
        self.rows_loc = -(-spec.ny // n)
        self.slab_spec = dataclasses.replace(spec, ny=self.rows_loc)

    def _split(self, a, fill=0.0):
        """S-major (S, ...) array -> each slab's rows of cells."""
        spec, n = self.spec, self.mesh.size
        rows = a.reshape((spec.ny, spec.nx) + tuple(a.shape[1:]))
        return [s.reshape((-1,) + tuple(a.shape[1:]))
                for s in _split_rows(rows, self.rows_loc, n, fill,
                                     self.mesh.devices)]

    def _rebuild(self, x, y):
        full = CellEngine._rebuild(self, x, y)
        parts = {k: self._split(getattr(full, k), f)
                 for k, f in _CELL_FILLS.items()}
        slabs = tuple(full._replace(**{k: v[i] for k, v in parts.items()})
                      for i in range(self.mesh.size))
        return SlabLayout(full, slabs, full.overflow)

    def _drift_over(self, lay, x, y):
        return cg.displacement_exceeded(self.spec, lay.full, x, y)

    def _slots(self, lay, arrays):
        """Each slab's (slot values, views) of F per-particle arrays: F
        tensors (S_loc, K) and F tensors (S_loc, 9K). Per-particle state is
        replicated, so the views come from the whole grid's core."""
        F = len(arrays)
        core = cg._core(self.spec, lay.full.slot, arrays)
        slot = self._split(core.reshape(-1, core.shape[2]))
        view = self._split(cg._nview(self.spec, core))
        return [(cg._unpack(s, F), cg._unpack(v, F))
                for s, v in zip(slot, view)]

    def _geometry(self, lay, state: State):
        return tuple(
            cg.pair_geometry(self.slab_spec, sl, xa, ya, xv, yv)
            for sl, ((xa, ya), (xv, yv)) in zip(
                lay.slabs, self._slots(lay, (state.x, state.y))))

    def _views(self, reqs):
        """The slabs' neighbor views of the per-slot arrays each requests,
        through a one-row band from each neighbor slab."""
        spec, F = self.slab_spec, len(reqs[0])
        cores = [torch.stack(list(r), dim=-1).reshape(
            spec.ny, spec.nx, spec.K * F) for r in reqs]
        bands = _exchange_bands(cores, 0.0, 1, self.rows_loc, False)
        return [cg._unpack(cg.nview_bands(c, spec.nx, lo, hi), F)
                for c, (lo, hi) in zip(cores, bands)]

    def _cell_step(self, lay, geom, state: State, dt, transport_coeff, g,
                   mu):
        cfg, spec, devs = self.cfg, self.spec, self.mesh.devices
        slots = self._slots(lay, (state.vx, state.vy, state.drho_dt))
        bodies = [cg.cell_step_slots(
            self.slab_spec, lay.slabs[i], geom[i], vxa, vya, dra, vxv, vyv,
            _scalar_on(dt, devs[i]), cfg.rho0, cfg.p0, cfg.c_f,
            cfg.inv_sigma0, transport_coeff, _scalar_on(g, devs[i]),
            _scalar_on(mu, devs[i]), cfg.wall_visc_factor)
            for i, ((vxa, vya, dra), (vxv, vyv, _)) in enumerate(slots)]
        outs = cg.run_views(bodies, self._views)
        S = spec.n_cells
        per_slot = [_all_gather([o[k] for o in outs], self.device)[:S]
                    for k in range(len(outs[0]))]
        return cg.collect_step(spec, lay.full, per_slot, state.x, state.y,
                               state.vx, state.vy, dt)

    def _count_pairs(self, lay, geom):
        sums = [cg.pair_sums(sl, gm) for sl, gm in zip(lay.slabs, geom)]
        ff = _psum([s[0] for s in sums], self.device)
        fw = _psum([s[1] for s in sums], self.device)
        return (ff / 2 + fw).to(torch.int32)

    def final_shear(self, state: State, lay, geom, mu):
        """The wall shear of each slab's cells, summed over the slabs."""
        cfg = self.cfg
        sums = []
        for i, (slots, views) in enumerate(self._slots(lay, (
                state.vx, state.vol, state.b11, state.b12, state.b21,
                state.b22))):
            sums.append(cg.shear_sums(
                self.slab_spec, lay.slabs[i], geom[i], slots, views[1],
                _scalar_on(mu, self.mesh.devices[i]), cfg.wall_visc_factor))
        return (-_psum([s[0] for s in sums], self.device) / cfg.DL,
                -_psum([s[1] for s in sums], self.device) / cfg.DL)


# ---------------------------------------------------------------------------
# the fused engine, y-slab sharded
# ---------------------------------------------------------------------------


# the aux state that rides each slab between steps and through re-bins
AUX_KEYS = ("vol", "b11", "b12", "b21", "b22", "rho", "p", "fx", "fy", "fpx",
            "fpy")
# the statics of a slab (they change at rebuilds only)
_STATIC_KEYS = ("isf", "mass", "wvx", "wvy", "wbot", "wtop")


class ShardedPallasEngine(PallasCellEngine):
    """y-slab decomposition of the fused engine (the JAX package's
    ``ShardedPallasEngine``, sharding.py:213-1062).

    The fused layout's cell-row axis (``nyp`` rows of ``(K, nx)`` slots,
    padded to ``nyp_pad``, a multiple of the mesh) is split into slabs of
    ``rows_loc`` rows, one per device. Each step, every slab takes a
    ``ghost``-row band of the dynamic state cores from its y-neighbors
    (``_exchange_bands``) and runs the unmodified fused step kernel on
    its extended slab of ``rows_loc + 2*ghost`` rows (``slab_spec``),
    keeping the interior. Slabs shallower than the ghost depth take their
    bands from a gather of every slab (``_gather_mode``).

    ``run_interval`` runs the chunk design of the single-device engine
    slab by slab (``_chunked_interval``), the per-step path with the step
    log (``_run_interval_steps`` over ``_fused_cell_step``, which also
    serves ``init``), or on a one-device mesh with ghost=0 the
    single-device interval loop itself. The wall shear runs once per
    interval on the collected global layout. Each slab's kernels launch on
    its device's current stream."""

    def __init__(self, cfg: SPHConfig, scene: Scene, mesh: Mesh,
                 ghost: int = None):
        self.mesh = mesh
        self.n_dev = mesh.size
        if ghost is None:
            # 4 = the kernel's cross-row dependency depth (4 sweeps x
            # 1-row stencil). A one-device mesh needs no ghost rows: both
            # band edges are walls, so its slab is the whole domain.
            ghost = 4 if self.n_dev > 1 else 0
        self.ghost = int(ghost)
        super().__init__(cfg, scene, mesh.devices[0])
        nyp = pc.plan(self.spec)[3]
        self._nyp = nyp
        self.nyp_pad = -(-nyp // self.n_dev) * self.n_dev
        self.rows_loc = self.nyp_pad // self.n_dev
        self._gather_mode = self.rows_loc < self.ghost
        self.slab_spec = dataclasses.replace(
            self.spec, ny=self.rows_loc + 2 * self.ghost)
        # the cache kernels pick their lanes per anchor for the whole
        # domain's anchor slots (``fused_cell_cuda._const``), so a slab's
        # per-anchor sums add in one device's order
        self.cache_slots = nyp * self.spec.K * self.spec.nx
        # steps each slab's step kernel ran (init and the per-step path
        # included, rolled-back sub-chunks too): chip_smoke.py holds the
        # step kernel's launch count to mesh size times this
        self.slab_steps = 0

    # ---- slab plumbing ----

    def _slabs(self, plain, fill):
        """A plain (nyp, K, nx) core -> its slabs on their devices."""
        return _split_rows(plain, self.rows_loc, self.n_dev, fill,
                           self.mesh.devices)

    def _ext(self, slabs, fill, G=None):
        """Each slab extended by its ghost bands and padded to the extended
        spec's plan rows; with ``G`` given, by G-row bands only (the
        re-bin's one-row band)."""
        if G is not None:
            return [torch.cat([lo, s, hi], dim=0) for s, (lo, hi) in zip(
                slabs, _exchange_bands(slabs, fill, G, self.rows_loc,
                                       False))]
        nypl = pc.plan(self.slab_spec)[3]
        out = []
        for s, (lo, hi) in zip(slabs, _exchange_bands(
                slabs, fill, self.ghost, self.rows_loc, self._gather_mode)):
            e = torch.cat([lo, s, hi], dim=0)
            if nypl > e.shape[0]:
                e = torch.cat([e, torch.full(
                    (nypl - e.shape[0],) + tuple(e.shape[1:]), fill,
                    dtype=e.dtype, device=e.device)])
            out.append(e)
        return out

    def _ih(self, c):
        """Halo'd extended core -> its slab's interior rows."""
        G, nx = self.ghost, self.spec.nx
        return c[1 + G:1 + G + self.rows_loc, :, 1:nx + 1]

    def _ip(self, c):
        """Plain extended core -> its slab's interior rows."""
        return c[self.ghost:self.ghost + self.rows_loc]

    def _cnt_rows(self, cnt):
        """(n_groups, L) pair counts of an extended slab -> its interior
        (rows_loc, nx) rows."""
        nx = self.spec.nx
        return cnt.reshape(-1, nx)[self.ghost:self.ghost + self.rows_loc]

    def _occl(self, x_e):
        """The anchor-rank bound of each row group of an extended slab from
        its slot occupancy (empty slots ride at x = BIG and a cell's ranks
        are packed, so the count is the bound)."""
        ls, K = self.slab_spec, self.spec.K
        Rl, _, ngl, _ = pc.plan(ls)
        cnt_cell = torch.sum((x_e < 0.5 * pc._BIG_X).to(torch.int32), dim=1)
        return torch.clamp(torch.amax(cnt_cell.reshape(ngl, Rl * ls.nx),
                                      dim=1, keepdim=True),
                           max=K).to(torch.int32)

    @staticmethod
    def _shim(stat_h, occl):
        """The ``FusedLayout`` a kernel reads on an extended slab: the
        halo'd statics and the occupancy bound (the JAX package's shim,
        sharding.py:726-731)."""
        z1 = torch.zeros((1,), dtype=torch.int32, device=occl.device)
        return pc.FusedLayout(
            pidx=z1, hidx=z1, isf_c=stat_h[0], mass_c=stat_h[1],
            wvx_c=stat_h[2], wvy_c=stat_h[3], wbot_c=z1, wtop_c=z1,
            refx_p=z1, refy_p=z1, occ=occl,
            overflow=torch.zeros((), dtype=torch.bool, device=occl.device))

    def _stat_h(self, statics):
        """Each slab's extended halo'd statics (isf, mass, wvx, wvy)."""
        ls = self.slab_spec
        ext = [self._ext(statics[k], 0.0) for k in ("isf", "mass", "wvx",
                                                     "wvy")]
        return [tuple(pc.halo_ify(ls, e[i]) for e in ext)
                for i in range(self.n_dev)]

    def _slab_args(self, sts, stat_h, occl=None):
        """Each slab's step-kernel inputs on its extended slab from its
        plain x, y, vx, vy, dr slabs (``sts``): (layout shim, xH, yH, vxH,
        vyH, drP). ``occl``: each slab's occupancy bound, else taken from
        its extended x."""
        ls, spec, BIG = self.slab_spec, self.spec, pc._BIG_X
        x_e = self._ext([s["x"] for s in sts], BIG)
        y_e, vx_e, vy_e, dr_e = (self._ext([s[k] for s in sts], 0.0)
                                 for k in ("y", "vx", "vy", "dr"))
        if occl is None:
            occl = [self._occl(x) for x in x_e]
        return [(self._shim(stat_h[i], occl[i]),
                 pc.halo_ify(ls, x_e[i], fill=BIG, xshift=spec.DL),
                 pc.halo_ify(ls, y_e[i]), pc.halo_ify(ls, vx_e[i]),
                 pc.halo_ify(ls, vy_e[i]), dr_e[i])
                for i in range(self.n_dev)]

    def _entry(self, state: State, lay):
        """The one packed scatter into plain slabs at interval entry
        (particle order exists only here and at the interval end): each
        slab's state dict (x, y, vx, vy, dr, the aux state riding along,
        so a first-group rollback restores it, and a zero pair count), pid
        slabs, statics and drift references (refx, refy)."""
        spec, nx, n_total = self.spec, self.spec.nx, self.spec.n_total
        nyp, BIG, devs = self._nyp, pc._BIG_X, self.mesh.devices

        def mp(v, fill=0.0):
            return self._slabs(pc.make_plain(spec, lay.pidx, v, fill=fill),
                               fill)

        sts = [dict(x=xs, y=ys, vx=vxs, vy=vys, dr=drs,
                    cnt=torch.zeros((self.rows_loc, nx), dtype=self.dtype,
                                    device=d))
               for xs, ys, vxs, vys, drs, d in zip(
                   mp(state.x, BIG), mp(state.y), mp(state.vx), mp(state.vy),
                   mp(state.drho_dt), devs)]
        aux_in = {k: mp(getattr(state, k)) for k in AUX_KEYS}
        for i, st in enumerate(sts):
            st.update({k: aux_in[k][i] for k in AUX_KEYS})
        pid = torch.arange(n_total, dtype=torch.int32, device=self.device)
        pids = self._slabs(pc.make_plain(spec, lay.pidx, pid, fill=n_total),
                           n_total)
        stat_s = {k: self._slabs(getattr(lay, k + "_c")[1:nyp + 1, :,
                                                        1:nx + 1], 0.0)
                  for k in _STATIC_KEYS}
        statics = [{k: stat_s[k][i] for k in _STATIC_KEYS}
                   for i in range(self.n_dev)]
        return (sts, pids, statics, self._slabs(lay.refx_p, BIG),
                self._slabs(lay.refy_p, 0.0))

    # ---- the dispatch ----

    def run_interval(self, state: State, lay, geom, interval_len,
                     g=None, mu=None, max_steps=None, t_local0=None,
                     t_comp0=None, sub_len0=None, t_base=None,
                     step_base=None, steps_done0=None) -> IntervalResult:
        """Run to the next output point (JAX sharding.py:287-303). The step
        log takes the per-step path; a one-device mesh with ghost=0 runs
        ``PallasCellEngine.run_interval``; else the slab-local chunk loop,
        which takes no split dispatch."""
        cfg = self.cfg
        g = cfg.gravity_g if g is None else g
        mu = cfg.mu if mu is None else mu
        if cfg.step_log_every > 0:
            return self._run_interval_steps(
                state, lay, geom, interval_len, g, mu, max_steps, t_local0,
                t_comp0, t_base, step_base, steps_done0)
        if self.n_dev == 1 and self.ghost == 0:
            return PallasCellEngine.run_interval(
                self, state, lay, geom, interval_len, g=g, mu=mu,
                max_steps=max_steps, t_local0=t_local0, t_comp0=t_comp0,
                sub_len0=sub_len0)
        if any(v is not None for v in (max_steps, t_local0, t_comp0,
                                       sub_len0, steps_done0)):
            raise ValueError("the slab-local chunk loop runs whole "
                             "intervals (no split dispatch under a mesh)")
        return self._chunked_interval(state, lay, geom, interval_len, g, mu)

    # ---- one fused step, slab by slab (init and the per-step path) ----

    def _fused_cell_step(self, lay, x, y, vx, vy, drho_dt, dt, g, mu,
                         transport_coeff=None):
        """``fused_cell_step`` over the slabs (JAX sharding.py:948-1062):
        packed scatters into plain cores, padded and split into slabs,
        each extended by its bands and stepped by the fused kernel on its
        device; the interiors are gathered and taken back to particle
        order."""
        cfg, spec = self.cfg, self.spec
        tc = (cfg.transport_coeff if transport_coeff is None
              else transport_coeff)
        nyp, nx = self._nyp, spec.nx
        BIG = pc._BIG_X
        ls, devs = self.slab_spec, self.mesh.devices

        def strip(c):  # halo'd static core -> plain interior
            return c[1:nyp + 1, :, 1:nx + 1]

        def mp(v, fill=0.0):
            return self._slabs(pc.make_plain(spec, lay.pidx, v, fill=fill),
                               fill)

        sts = [dict(x=a, y=b, vx=c, vy=d, dr=e) for a, b, c, d, e in zip(
            mp(x, BIG), mp(y), mp(vx), mp(vy), mp(drho_dt))]
        stat_h = self._stat_h({k: self._slabs(strip(getattr(lay, k + "_c")),
                                              0.0)
                               for k in ("isf", "mass", "wvx", "wvy")})
        outs = []
        self.slab_steps += 1
        for args, dev in zip(self._slab_args(sts, stat_h), devs):
            outs.append(pc.fused_step_cores(
                ls, *args, _scalar_on(dt, dev), cfg.rho0, cfg.p0, cfg.c_f,
                cfg.inv_sigma0, tc, _scalar_on(g, dev), _scalar_on(mu, dev),
                cfg.wall_visc_factor, cache_slots=self.cache_slots))
        npairs = _psum([torch.sum(self._cnt_rows(o["cnt"])) for o in outs],
                       self.device)

        def take(key):
            cut = self._ih if key.endswith("H") else self._ip
            whole = _all_gather([cut(o[key]) for o in outs], self.device)
            flat = whole[:nyp].reshape(-1)
            return flat[torch.clamp(lay.pidx, max=flat.numel() - 1)]

        return dict(
            rho=take("rhoP"), p=take("pP"), drho_dt=take("drP"),
            vx=take("vxH"), vy=take("vyH"), fx=take("fxP"), fy=take("fyP"),
            fpx=take("fpxP"), fpy=take("fpyP"), vol=take("volH"),
            b11=take("b11H"), b12=take("b12H"), b21=take("b21H"),
            b22=take("b22H"), x=take("xP"), y=take("yP"),
            n_pairs=torch.round(npairs).to(torch.int32))

    # ---- the slab-local chunk loop ----

    def _drift_bounds(self, sts, refx, refy, isf):
        """Slab-local twin of ``fused_cell.pair_drift_bounds``: the
        per-row displacement ranges reduce on each slab, the (2, rows, nx)
        row tables gather, and the 2-row/2-column windowing runs once, so
        the bounds equal the single-device computation's (JAX
        sharding.py:529-555)."""
        rng = [pc.drift_row_ranges(fs > 0, rx, ry, st["x"], st["y"])
               for st, rx, ry, fs in zip(sts, refx, refy, isf)]
        return pc.drift_window_bounds(
            _all_gather([r[0] for r in rng], self.device, dim=1),
            _all_gather([r[1] for r in rng], self.device, dim=1),
            self.spec.nx)

    def _local_rebuild(self, sts, pids, statics):
        """Slab-local re-bin (JAX sharding.py:557-649): wrap x, bin each
        slab extended by a 1-row band with the global cell rule
        (``neighbors._cell_coords``), keep the particles whose new row is
        the slab's, rank within each cell by particle id -- the placement
        of the global ``assign_slots``, exactly. The aux state follows its
        particles. Returns the slabs' new state dicts, pid slabs and
        statics, and the per-slab overflow (a cell past K) and jump (a
        row moved by more than one) flags."""
        spec = self.spec
        nx, K, n_total = spec.nx, spec.K, spec.n_total
        rows_loc, BIG = self.rows_loc, pc._BIG_X
        n_loc = rows_loc * nx
        names = ("x", "y", "vx", "vy", "dr") + _STATIC_KEYS + AUX_KEYS
        fills = dict.fromkeys(names, 0.0)
        fills["x"] = BIG
        fields = []
        for st, stat in zip(sts, statics):
            occ = st["x"] < 0.5 * BIG
            f = dict(st, **stat)
            f["x"] = torch.where(occ & (stat["isf"] > 0),
                                 torch.remainder(st["x"], spec.DL), st["x"])
            fields.append(f)
        ext = {k: self._ext([f[k] for f in fields], fills[k], G=1)
               for k in names}
        pid_ext = self._ext(pids, n_total, G=1)
        out_st, out_pid, out_stat, ovfs, jumps = [], [], [], [], []
        for i, dev in enumerate(self.mesh.devices):
            r0 = i * rows_loc
            es = {k: ext[k][i].reshape(-1) for k in names}
            pid_e = pid_ext[i].reshape(-1)
            S_e = pid_e.shape[0]
            valid = pid_e < n_total
            cx, cy = nbr._cell_coords(spec, es["x"], es["y"])
            cx, cy = cx.to(torch.int64), cy.to(torch.int64)
            old_row = (r0 - 1 + torch.arange(rows_loc + 2, device=dev)
                       )[:, None, None].expand(rows_loc + 2, K, nx).reshape(-1)
            jumps.append(torch.any(valid & (torch.abs(cy - old_row) > 1)))
            keep = valid & (cy >= r0) & (cy < r0 + rows_loc)
            cid = torch.where(keep, (cy - r0) * nx + cx,
                              torch.full_like(cy, n_loc))
            # rank within cell by particle id == assign_slots' stable
            # particle-index ranking
            ord1 = torch.argsort(pid_e, stable=True)
            cid1 = cid[ord1]
            ord2 = torch.argsort(cid1, stable=True)
            order = ord1[ord2]
            cid_s = cid1[ord2]
            counts = torch.zeros(n_loc + 1, dtype=torch.int64,
                                 device=dev).scatter_add(
                0, cid, torch.ones_like(cid))
            starts = torch.cumsum(counts, 0) - counts
            rank = torch.arange(S_e, device=dev) - starts[cid_s]
            ovfs.append(torch.max(counts[:n_loc]) > K)
            slot_s = torch.where((rank < K) & (cid_s < n_loc),
                                 cid_s * K + rank,
                                 torch.full_like(rank, n_loc * K))
            slot = torch.empty_like(slot_s).scatter(0, order, slot_s)
            cid2 = slot // K
            k2 = slot - cid2 * K
            iy2 = cid2 // nx
            ix2 = cid2 - iy2 * nx
            pidx_n = torch.where(slot < n_loc * K, (iy2 * K + k2) * nx + ix2,
                                 torch.full_like(slot, n_loc * K))
            pack = torch.stack([es[k] for k in names], dim=-1)
            fill_row = torch.tensor([fills[k] for k in names],
                                    dtype=pack.dtype, device=dev)
            out = pc._scatter(n_loc * K, pidx_n, pack, fill_row).reshape(
                rows_loc, K, nx, len(names))
            new = {k: out[..., j] for j, k in enumerate(names)}
            out_pid.append(pc._scatter(n_loc * K, pidx_n, pid_e,
                                       n_total).reshape(rows_loc, K, nx))
            out_stat.append({k: new[k] for k in _STATIC_KEYS})
            st = dict(sts[i])
            for k in ("x", "y", "vx", "vy", "dr") + AUX_KEYS:
                st[k] = new[k]
            out_st.append(st)
        return out_st, out_pid, out_stat, ovfs, jumps

    def _chunked_interval(self, state: State, lay, geom, interval_len, g,
                          mu):
        """The single-device chunk design run slab by slab (JAX
        sharding.py:340-929). Per sub-chunk group: the slabs' statics are
        extended and halo'd once, the occupancy bound taken once; the
        group loop is the single-device engine's (``_run_group``): each
        sub-chunk runs up to ``n_sub`` steps (``_one_step``: global v_max
        by pmax, dt as the chunk kernel computes it, the step kernel on
        every extended slab), and the drift bounds on mesh-merged row
        tables decide the predictive stop and the rollback; a group ends
        in the slab-local re-bin. A one-device mesh (ghost=4) runs the
        chunk kernel on its extended slab instead of the per-step loop.

        Host syncs: one per sub-chunk, which reads the bounds and the
        clock; the steps of a sub-chunk that cannot reach the output
        point (the step count times the largest dt the criteria allow
        stays short of it) run with no sync, the others read the clock
        before each step; one at the end for the jump flag."""
        cfg, spec = self.cfg, self.spec
        f = self._np_dtype
        n_total = spec.n_total
        devs, dev0 = self.mesh.devices, self.device
        BIG = pc._BIG_X
        rb, sub_max = self._group_lengths()
        interval = f(interval_len)

        sts, pids, statics, refx, refy = self._entry(state, lay)
        scalars = (cfg.rho0, cfg.p0, cfg.c_f, cfg.inv_sigma0,
                   cfg.transport_coeff, g, mu, cfg.wall_visc_factor)
        like = torch.empty((), dtype=self.dtype, device=dev0)
        dt_visc, dt_body = pc.chunk_dt_limits(spec, cfg.rho0, g, mu, like)
        consts = dict(il=pc._scalar(interval, like),
                      tiny=pc._scalar(1e-12, like),
                      c025h=pc._scalar(0.25 * spec.h, like),
                      dt_visc=dt_visc, dt_body=dt_body,
                      slab=[tuple(pc._scalar(v, like).to(d)
                                  for v in (g, mu, cfg.wall_visc_factor))
                            for d in devs])
        # no step of a sub-chunk can reach the output point while
        # n_sub * dt_cap stays short of it (dt <= 0.25h/c_f and the
        # step-independent limits)
        dt_cap = 1.001 * min(0.25 * spec.h / cfg.c_f, float(dt_visc),
                             float(dt_body))

        t_local, t_comp = f(0.0), f(0.0)
        sub_len = sub_max
        npairs = torch.as_tensor(geom, device=dev0).to(self.dtype)
        n_steps, n_roll, n_syncs, n_kept = 0, 0, 0, 0
        overflow = lay.overflow
        jumped = torch.zeros((), dtype=torch.bool, device=dev0)

        while t_local < interval:
            stat_h = self._stat_h(
                {k: [s[k] for s in statics] for k in ("isf", "mass", "wvx",
                                                      "wvy")})
            occl = [self._occl(x)
                    for x in self._ext([s["x"] for s in sts], BIG)]
            isf = [s["isf"] for s in statics]
            if self.n_dev == 1:
                drift = (pc.DriftRef(refx[0].contiguous(),
                                     refy[0].contiguous(),
                                     isf[0].contiguous(), False, self.ghost)
                         if spec.skin > 0.0 else None)
                run = self._chunk_run(sts[0], stat_h[0], occl[0], interval,
                                      scalars, drift)
            else:
                run = _StepRun(self, sts, stat_h, occl, interval, consts,
                               dt_cap, (refx, refy, isf)
                               if spec.skin > 0.0 else None)
            (t_local, t_comp, done_i, nrb, sub_len, syncs,
             kept) = self._run_group(
                 run, spec.skin > 0.0, interval, t_local, t_comp, sub_len,
                 rb, sub_max)
            n_syncs += syncs
            n_kept += kept
            sts = (run.state() if self.n_dev > 1
                   else [self._carry_slab(run.state())])
            npairs = _psum([torch.sum(s["cnt"]) for s in sts], dev0)

            sts, pids, statics, ovfs, jumps = self._local_rebuild(
                sts, pids, statics)
            refx = [s["x"] for s in sts]
            refy = [s["y"] for s in sts]
            overflow = torch.logical_or(overflow, _pmax(ovfs, dev0))
            jumped = torch.logical_or(jumped, _pmax(jumps, dev0))
            n_steps += done_i
            n_roll += nrb

        # ---- collect to particle order (once per interval) ----
        pid_f = _all_gather([p.reshape(-1) for p in pids], dev0).to(
            torch.int64)

        def collect(key):
            return pc._scatter(n_total, pid_f, _all_gather(
                [s[key].reshape(-1) for s in sts], dev0), 0.0)

        x_pp = periodic_wrap(spec, collect("x"))
        y_pp = collect("y")
        new_state = State(
            x=x_pp, y=y_pp, vx=collect("vx"), vy=collect("vy"),
            rho=collect("rho"), p=collect("p"), drho_dt=collect("dr"),
            fx=collect("fx"), fy=collect("fy"), fpx=collect("fpx"),
            fpy=collect("fpy"), vol=collect("vol"), b11=collect("b11"),
            b12=collect("b12"), b21=collect("b21"), b22=collect("b22"))
        # the interval-final global rebuild feeds the next interval's entry
        # scatter and the wall shear (monitor after rebuild,
        # SPH_Poiseuille.m:280-283)
        lay2 = self._rebuild(x_pp, y_pp)
        tau_b, tau_t = self.final_shear(new_state, lay2, mu)
        nf = spec.n_fluid
        v_max = torch.sqrt(torch.max(new_state.vx[:nf] ** 2
                                     + new_state.vy[:nf] ** 2))
        n_pairs = torch.round(npairs).to(torch.int32)
        n_syncs += 1
        return IntervalResult(
            state=new_state, cands=lay2, geom=n_pairs, tau_bottom=tau_b,
            tau_top=tau_t, n_steps=n_steps,
            overflow=torch.logical_or(overflow, lay2.overflow),
            skin_guard=bool(jumped), v_max=v_max, n_pairs=n_pairs,
            n_rollbacks=n_roll, t_local=t_local, t_comp=t_comp,
            sub_len=sub_len, n_syncs=n_syncs, n_kept_crossings=n_kept)

    def _one_step(self, sts, stat_h, occl, t, tc, consts):
        """One step of every slab (JAX sharding.py:496-527): v_max over the
        mesh (pmax of squared speeds, then sqrt), dt exactly as the chunk
        kernel computes it, the Kahan clock, and the fused step kernel on
        each extended slab."""
        cfg = self.cfg
        dev0 = self.device
        v2 = _pmax([torch.amax(s["vx"] * s["vx"] + s["vy"] * s["vy"])
                    for s in sts], dev0)
        v_max = torch.sqrt(v2)
        tiny = consts["tiny"]
        remain = consts["il"] - t
        dt_ac = consts["c025h"] / torch.maximum(cfg.c_f + v_max, tiny)
        dt = torch.maximum(
            torch.minimum(torch.minimum(dt_ac, consts["dt_visc"]),
                          torch.minimum(consts["dt_body"], remain)), tiny)
        out = []
        self.slab_steps += 1
        for i, (args, dev) in enumerate(zip(
                self._slab_args(sts, stat_h, occl), self.mesh.devices)):
            g_i, mu_i, wf_i = consts["slab"][i]
            o = pc.fused_step_cores(
                self.slab_spec, *args, dt.to(dev), cfg.rho0, cfg.p0,
                cfg.c_f, cfg.inv_sigma0, cfg.transport_coeff, g_i, mu_i,
                wf_i, cache_slots=self.cache_slots)
            ih, ip = self._ih, self._ip
            out.append(dict(
                x=ip(o["xP"]), y=ip(o["yP"]), vx=ih(o["vxH"]),
                vy=ih(o["vyH"]), dr=ip(o["drP"]), vol=ih(o["volH"]),
                b11=ih(o["b11H"]), b12=ih(o["b12H"]), b21=ih(o["b21H"]),
                b22=ih(o["b22H"]), rho=ip(o["rhoP"]), p=ip(o["pP"]),
                fx=ip(o["fxP"]), fy=ip(o["fyP"]), fpx=ip(o["fpxP"]),
                fpy=ip(o["fpyP"]), cnt=self._cnt_rows(o["cnt"])))
        t2, tc2 = _t_add(t, tc, dt)
        return out, t2, tc2

    def _chunk_run(self, st, stat_h, occl, interval, scalars, drift):
        """A group's sub-chunk runner on a one-device mesh (JAX
        sharding.py:709-805): the chunk kernel on the extended slab, its
        halo'd carry cores feeding the next call directly. The rollback
        seeds are the group-entry state in the chunk's own forms.
        ``drift``: the slab's drift references (``fused_cell.DriftRef``
        over its interior rows), None without a skin."""
        ls = self.slab_spec
        halo = pc.halo_ify

        def ext(v, fill=0.0):
            return self._ext([v], fill)[0]

        shim, xH, yH, vxH, vyH, drP = self._slab_args([st], [stat_h],
                                                      [occl])[0]
        # the runner's count per slot: the slab's row counts in rank 0
        cnt = torch.zeros_like(drP)
        cnt[self.ghost:self.ghost + self.rows_loc, 0] = st["cnt"]
        # xP/yP: what a group that keeps no sub-chunk hands _carry_slab
        carry = dict(
            xH=xH, yH=yH, vxH=vxH, vyH=vyH, drP=drP,
            xP=xH[1:-1, :, 1:-1], yP=yH[1:-1, :, 1:-1],
            **{k + "H": halo(ls, ext(st[k]))
               for k in ("vol", "b11", "b12", "b21", "b22")},
            **{k + "P": ext(st[k])
               for k in ("rho", "p", "fx", "fy", "fpx", "fpy")},
            cnt=cnt)
        return self._chunks.group(ls, shim, carry, interval, scalars, drift,
                                  self.cache_slots)

    def _carry_slab(self, c):
        """A one-device chunk carry -> its slab's state dict, the count
        per slot summed to the slab's (rows_loc, nx) rows."""
        ih, ip = self._ih, self._ip
        return dict(
            x=ip(c["xP"]), y=ip(c["yP"]), vx=ih(c["vxH"]), vy=ih(c["vyH"]),
            dr=ip(c["drP"]),
            **{k: ih(c[k + "H"]) for k in ("vol", "b11", "b12", "b21",
                                           "b22")},
            **{k: ip(c[k + "P"])
               for k in ("rho", "p", "fx", "fy", "fpx", "fpy")},
            cnt=torch.sum(ip(c["cnt"]), dim=1))


class _StepRun:
    """A group's sub-chunk runner on a multi-slab mesh (the protocol of
    ``PallasCellEngine._run_group``): a call runs up to ``n_sub`` calls of
    ``ShardedPallasEngine._one_step`` (the JAX inner while loop) from the
    kept slab states, then reads the mesh-merged drift bounds of where it
    got to (``drift``: the slabs' (refx, refy, isf); None: no skin,
    bounds 0) and the clock in one host sync. The clock is read before a
    step only where the sub-chunk can reach the output point (``n_sub``
    steps at ``dt_cap`` reach it). ``keep`` makes the last call's states
    the kept ones, ``state`` returns them."""

    def __init__(self, engine, sts, stat_h, occl, interval, consts, dt_cap,
                 drift):
        self.cur, self.new = sts, None
        self.engine, self.stat_h, self.occl = engine, stat_h, occl
        self.interval, self.consts, self.dt_cap = interval, consts, dt_cap
        self.drift = drift

    def __call__(self, n_sub, t_i, tc_i):
        eng = self.engine
        like = torch.empty((), dtype=eng.dtype, device=eng.device)
        t = pc._scalar(t_i, like)
        tc = pc._scalar(tc_i, like)
        safe = float(t_i) + n_sub * self.dt_cap < float(self.interval)
        s, done, syncs = self.cur, 0, 0
        while done < n_sub:
            if done > 0 and not safe:
                syncs += 1
                if not np.float32(t.item()) < self.interval:
                    break
            s, t, tc = eng._one_step(s, self.stat_h, self.occl, t, tc,
                                     self.consts)
            done += 1
        self.new = s
        zero = torch.zeros((), dtype=t.dtype, device=t.device)
        bx, by = ((zero, zero) if self.drift is None
                  else eng._drift_bounds(s, *self.drift))
        # the one host sync of the sub-chunk
        vals = torch.stack([bx, by, t, tc.to(t.device)]).tolist()
        return (*vals, done, syncs + 1)

    def keep(self):
        self.cur = self.new

    def state(self):
        return self.cur
