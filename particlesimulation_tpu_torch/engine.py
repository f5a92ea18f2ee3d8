"""Single-device simulation engines: slot-resident, supercell, banded, dense,
tiered and sweep.

Counterpart of the JAX package's ``engine.py``. Six implementations:

* ``resident`` (``make_resident_run``) — the state lives in (ncells, K) slot
  tiles; one step is
  1. per-cell COM and the 8-neighbour monopole (``ops/stencil``,
     ``ops/dense.monopole_tile_forces``) added to the pair forces carried
     from the previous step;
  2. integration with periodic wrap (``ops/integrate``);
  3. rebin: movers change rows (``ops/resident.rebin``);
  4. the fused collision(t) + pair-force(t+1) pass (``ops/cuda/cell_pairs``).
* ``supercell`` (``ops/supercell.make_supercell_run``) — the resident step
  on rows of S x S cells, for sparse grids, with a same-cell label in the
  pair pass.
* ``banded`` (``ops/banded.make_banded_run``) — the resident step on bands
  of grid rows, each with its own K, in one slot pool: for clustered loads,
  and for uniform loads whose tile state is large (the streaming route).
* ``dense`` (``make_dense_step``) — particle arrays sorted by (cell, pid),
  scattered into (ncells, K) tiles each step for the force and collision
  kernels; the resident engine's escalation target.
* ``tiered`` (``ops/tiered.make_tiered_step``) — the dense step on
  occupancy-classed tiles, for clustered loads.
* ``sweep`` (``make_step``) — neighbor-offset sweeps over the sorted
  particle arrays, with no tile capacity to outgrow: the f64 parity engine
  (the reference's operation order, bit for bit) and, in f32, the last rung
  of the ladder and the census's engine for small sparse grids. Plain torch,
  as in the JAX package (XLA code there, not Pallas).

A tile engine's run is a Python loop over steps on the device with no host
readback inside it; the engine reads the overflow counter once per run and,
when the tiles were too small, replays the run losslessly with larger tiles
or another engine, as the JAX engine's retry ladder does (resident -> dense
-> sweep, banded -> grown bands -> dense; the reference instead PANIC-skips
particles, serial/parsim.cpp:276-280). The sweep's loop trip counts are host
integers, so it reads the cell occupancy back once a step.
"""

from __future__ import annotations

import numpy as np
import torch

from particlesimulation_tpu_torch.config import DELTAT, EPSILON, Precision, SimConfig
from particlesimulation_tpu_torch.initializer import init_particles_host
from particlesimulation_tpu_torch.ops import (binning, collisions, com, dense,
                                              forces, integrate, stencil)
from particlesimulation_tpu_torch.ops import resident as res
from particlesimulation_tpu_torch.ops.banded import (grow_plan,
                                                     make_banded_run,
                                                     plan_bands,
                                                     uniform_band_plan)
from particlesimulation_tpu_torch.ops.cuda import cell_pairs
from particlesimulation_tpu_torch.ops.supercell import (choose_supercell_factor,
                                                        make_supercell_run)
from particlesimulation_tpu_torch.ops.tiered import make_tiered_step, plan_tiers
from particlesimulation_tpu_torch.state import SimState, result_of

# Largest tile capacity the tile kernels take; beyond it the ladder
# escalates resident -> dense -> sweep, and supercell -> sweep. (The JAX
# supercell and banded engines run on XLA kernels up to MAX_XLA_KCAP = 4096,
# so a super-cell row of 1025-4096 particles stays on supercell there and
# runs the sweep here, and a band grows to 4096 there and to 1024 here.)
MAX_DENSE_KCAP = cell_pairs.MAX_KCAP
INF = cell_pairs.INF
# Telemetry value of a collision-rank domain overflow (a cell of RANK_LIMIT
# occupants or more), far above any tile-capacity retry value.
RANK_OVF = 1 << 30

IMPLS = ("resident", "supercell", "banded", "dense", "tiered", "sweep")
CLUSTERED_IMPLS = ("banded", "tiered")
# Pair kernels of the resident engine (the JAX package's PSIM_PALLAS_PAIR):
# v4 and v2 are the hit-gated kernel's two force forms, v1 the ungated
# kernel in the v2 form. None picks v4 or v2 by the box side.
PAIR_IMPLS = ("v1", "v2", "v4")

# Above this tile-state size the JAX census streams uniform loads through
# row bands (engine.py PSIM_STREAM_BYTES default, 256 MB).
_STREAM_BYTES = 256 << 20
_STREAM_BAND_BYTES = 40 << 20


def make_step(config: SimConfig):
    """Build (step, run) of the sweep engine: parity (f64, the reference's
    operation order) or fast (f32, order-free), by ``config.precision``.

    ``step(state, plan)`` takes a state sorted by (cell key, pid) and
    ``plan``, the ``binning.occupancy`` of its keys, and returns the next
    state and the occupancy of its keys. The post-move sort of step t is the
    binning of step t+1 (positions do not change between the collision pass
    and the next COM pass), so a step sorts once and reads the occupancy
    back once; ``run(state, n_steps)`` adds one read for the first step.
    """
    side = config.side
    nc = config.ncside
    ncells = config.ncells
    parity = config.precision is Precision.PARITY

    def step(state: SimState, plan):
        x, y, vx, vy, m, alive, pid = (state.x, state.y, state.vx, state.vy,
                                       state.m, state.alive, state.pid)
        # Phase 1 — COM (the arrays arrive sorted by this key).
        key, valid = binning.cell_keys(x, y, side, nc)
        if parity:
            M, MX, MY = com.com_parity(key, x, y, m, ncells, plan)
            fx, fy = forces.pairwise_forces_parity_blocked(
                x, y, m, alive, key, ncells, plan)
        else:
            M, MX, MY = com.com_fast(key, x, y, m, ncells, plan)
            fx, fy = forces.pairwise_forces_fast(x, y, m, alive, key, ncells,
                                                 plan)
        # Phase 2 — forces: the pair sweeps above, then the 8 stencil
        # monopole terms.
        ml, mxl, myl = stencil.stencil_tables(M, MX, MY, side, nc)
        fx, fy = forces.monopole_forces(x, y, m, alive, key, fx, fy, ml, mxl,
                                        myl, ncells)
        # Phase 3 — integrate + periodic wrap.
        x, y, vx, vy = integrate.integrate(x, y, vx, vy, m, fx, fy, side,
                                           DELTAT)
        # Phase 4 — post-move rebin (the one sort per step) + collisions.
        key2, _ = binning.cell_keys(x, y, side, nc)
        key2, pid, x, y, vx, vy, m, alive = binning.sort_by_cell(
            key2, pid, x, y, vx, vy, m, alive)
        pos2, _ = binning.segment_positions(key2)
        plan2 = binning.occupancy(key2, ncells)
        count, died = collisions.detect_collisions_blocked(
            x, y, alive, key2, pos2, EPSILON, ncells, plan2)
        m, alive = collisions.apply_deaths(m, alive, died)
        overflow = state.overflow
        if collisions.rank_overflow(plan2.kmax):
            overflow = torch.clamp(overflow, min=RANK_OVF)
        return SimState(
            x=x, y=y, vx=vx, vy=vy, m=m, alive=alive, pid=pid,
            collisions=state.collisions + count,
            panics=state.panics + torch.sum(~valid, dtype=torch.int32),
            overflow=overflow), plan2

    def run(state: SimState, n_steps: int) -> SimState:
        key, _ = binning.cell_keys(state.x, state.y, side, nc)
        plan = binning.occupancy(key, ncells)
        for _ in range(n_steps):
            state, plan = step(state, plan)
        return state

    return step, run


def make_resident_run(config: SimConfig, kcap: int,
                      pair_impl: str | None = None):
    """Build (prologue, pair_tiles, run) of the slot-resident fast engine at
    tile capacity ``kcap``. ``run(state, n_steps)`` returns the final
    SimState; ``pair_tiles(state, n_steps)`` the (x, y, mf, alive, pid)
    tiles that step ``n_steps`` of that run hands its pair pass (0: the
    run's first pass), holes and limbo slots as they lie."""
    side = config.side
    nc = config.ncside
    ncells = config.ncells
    nslots = ncells * kcap
    if pair_impl is None:
        pair_impl = dense.pair_force_form(side)
    if pair_impl not in PAIR_IMPLS:
        raise ValueError(f"pair_impl {pair_impl!r}; valid: {PAIR_IMPLS}")
    form = "v2" if pair_impl == "v1" else pair_impl

    def scatter(idx, a, fill=0):
        flat = torch.full((nslots + 1,), fill, dtype=a.dtype, device=a.device)
        flat[idx] = a
        return flat[:nslots].reshape(ncells, kcap)

    def prologue(state: SimState) -> res.TileState:
        # Scatter by the CLAMPED cell key: out-of-range (PANIC2-limbo)
        # particles land in their nearest valid row, at most one hop from
        # home once they re-enter the box; they stay masked out of physics
        # (binned_mask). Valid particles keep their in-cell pid order.
        cx, cy, _ = res.cell_of(state.x, state.y, side, nc)
        ck = (torch.clamp(cy, 0, nc - 1) * nc + torch.clamp(cx, 0, nc - 1))
        ck, pid, x, y, vx, vy, m = binning.sort_by_cell(
            ck, state.pid, state.x, state.y, state.vx, state.vy, state.m)
        pos, _ = binning.segment_positions(ck)
        kmax = binning.max_occupancy(pos, torch.ones_like(pos, dtype=torch.bool))
        ovf = torch.where(kmax > kcap, kmax, 0).to(torch.int32)
        idx = torch.where(pos < kcap, ck.to(torch.int64) * kcap + pos,
                          nslots)
        return res.TileState(
            x=scatter(idx, x), y=scatter(idx, y),
            vx=scatter(idx, vx), vy=scatter(idx, vy), m=scatter(idx, m),
            occ=scatter(idx, torch.ones_like(m, dtype=torch.bool), False),
            pid=scatter(idx, pid),
            collisions=state.collisions, panics=state.panics,
            overflow=torch.maximum(state.overflow, ovf))

    def mono_tables(ts, mf):
        # COM + stencil from the tiles (row reductions only).
        return stencil.tables_from_sums(
            torch.sum(mf, dim=1), torch.sum(mf * ts.x, dim=1),
            torch.sum(mf * ts.y, dim=1), side, nc)

    def physics_mass(ts):
        binned, limbo_count = res.binned_mask(ts, side, nc)
        # Zero mf silences limbo slots in every physics pass: they exert
        # and receive no force and never collide.
        return torch.where(binned, ts.m, 0.0), binned, limbo_count

    def pair_args(ts):
        mf, binned, _ = physics_mass(ts)
        alive = (binned & (ts.m > 0)).to(torch.int32)
        return ts.x, ts.y, mf, alive, ts.pid

    def pair_pass(ts, collide: bool):
        """Fused collision(t) + pair-force(t+1) pass; (fx, fy, count, died).

        The post-move positions a step's collision pass scans are the
        positions the next step's force pass needs; forces come out with
        this pass's deaths applied (merged particles are massless from the
        next step on). pid tiles give the reference's pid-order tie-breaks.
        """
        fx, fy, count, ft = cell_pairs.fused_pairs(
            *pair_args(ts), kcap, EPSILON, collide=collide, force_form=form,
            gated=pair_impl != "v1")
        return fx, fy, count, ft != INF

    def advance(ts, fxd, fyd):
        """Phases 1-3 of a step: monopole, integrate, rebin."""
        mf, _, limbo_count = physics_mass(ts)
        fxm, fym = dense.monopole_tile_forces(ts.x, ts.y, mf,
                                              *mono_tables(ts, mf))
        # Integrate in place; m==0 (dead or empty slot) stays frozen.
        x, y, vx, vy = integrate.integrate(ts.x, ts.y, ts.vx, ts.vy, ts.m,
                                           fxd + fxm, fyd + fym, side, DELTAT)
        ts = ts._replace(x=x, y=y, vx=vx, vy=vy)
        ts, undelivered = res.rebin(ts, side, nc, kcap)
        return ts, undelivered, limbo_count

    pair_tiles, run = res.make_tile_run(prologue, advance, pair_args,
                                        pair_pass, kcap, side, nc)
    return prologue, pair_tiles, run


def make_dense_step(config: SimConfig, kcap: int):
    """Fast f32 step over dense per-cell tiles rebuilt from sorted particles.

    The state's particle arrays are sorted by (cell key, pid). Each step
    scatters them into (ncells, kcap) tiles, runs the force kernel with the
    8-neighbour monopole folded in, integrates, re-sorts, rebuilds the tiles
    and runs the collision kernel on them. The post-move tiles of step t
    are the binning tiles of step t+1 (positions do not change between the
    collision pass and the next COM pass), so the run loop carries them.
    Returns (step, build_tiles, run).
    """
    side = config.side
    nc = config.ncside
    ncells = config.ncells
    nslots = ncells * kcap

    def scatter(idx, a):
        flat = a.new_zeros(nslots + 1)  # the last slot takes dropped entries
        flat[idx] = a
        return flat[:nslots].view(ncells, kcap)

    def build_tiles(state: SimState):
        """Dense tiles and the particle -> slot map of the state's (sorted)
        positions. Dead particles carry m=0, so the mass tile serves COM,
        forces and (as m > 0) the collision alive-mask."""
        key, valid = binning.cell_keys(state.x, state.y, side, nc)
        pos, _ = binning.segment_positions(key)
        kmax = binning.max_occupancy(pos, valid)
        ok = valid & (pos < kcap)
        idx = torch.where(ok, key.to(torch.int64) * kcap + pos, nslots)
        return {"xd": scatter(idx, state.x), "yd": scatter(idx, state.y),
                "md": scatter(idx, state.m), "idx": idx, "ok": ok,
                "ovf": torch.where(kmax > kcap, kmax, 0).to(torch.int32),
                "panic": torch.sum(~valid, dtype=torch.int32)}

    def slot_of(tiles):
        # Each particle's slot (clamped where it has none: ok is False).
        return torch.clamp(tiles["idx"], max=nslots - 1)

    def step(state: SimState, tiles):
        xd, yd, md = tiles["xd"], tiles["yd"], tiles["md"]
        ml, mxl, myl = stencil.tables_from_sums(
            torch.sum(md, dim=1), torch.sum(md * xd, dim=1),
            torch.sum(md * yd, dim=1), side, nc)
        fxd, fyd = cell_pairs.dense_pairwise_forces(xd, yd, md, ml, mxl, myl,
                                                    kcap)
        g = slot_of(tiles)
        fx = torch.where(tiles["ok"], fxd.reshape(-1)[g], 0.0)
        fy = torch.where(tiles["ok"], fyd.reshape(-1)[g], 0.0)

        x, y, vx, vy = integrate.integrate(state.x, state.y, state.vx,
                                           state.vy, state.m, fx, fy, side,
                                           DELTAT)

        # Post-move rebin: the one sort per step, then fresh tiles (used by
        # the collision pass now and as binning next step).
        key2, _ = binning.cell_keys(x, y, side, nc)
        _, pid, x, y, vx, vy, m, alive = binning.sort_by_cell(
            key2, state.pid, x, y, vx, vy, state.m, state.alive)
        tiles2 = build_tiles(state._replace(x=x, y=y, vx=vx, vy=vy, m=m,
                                            alive=alive, pid=pid))
        ovf = torch.maximum(tiles["ovf"], tiles2["ovf"])

        count, ftd = cell_pairs.dense_collisions(
            tiles2["xd"], tiles2["yd"], (tiles2["md"] > 0).to(torch.int32),
            kcap, EPSILON)
        dead_slot = ftd != INF
        died = tiles2["ok"] & dead_slot.reshape(-1)[slot_of(tiles2)]
        m, alive = collisions.apply_deaths(m, alive, died)
        # Deaths in tile space keep the carried mass tile consistent.
        tiles2["md"] = torch.where(dead_slot, 0.0, tiles2["md"])
        tiles2["ovf"] = ovf

        out = state._replace(
            x=x, y=y, vx=vx, vy=vy, m=m, alive=alive, pid=pid,
            collisions=state.collisions + count,
            panics=state.panics + tiles["panic"],
            overflow=torch.maximum(state.overflow, ovf))
        return out, tiles2

    def run(state: SimState, n_steps: int) -> SimState:
        tiles = build_tiles(state)
        for _ in range(n_steps):
            state, tiles = step(state, tiles)
        return state

    return step, build_tiles, run


def _clustered(plan) -> bool:
    """Whether a ``plan_tiers`` plan marks a clustered load: a class ladder
    whose top cap is at least twice its bulk cap (the JAX census's test
    that routes a load to the banded or tiered engine)."""
    return plan is not None and plan[-1][0] >= 2 * plan[0][0]


class Engine:
    """Single-device engine: init, run loop, result extraction.

    ``device`` defaults to ``cuda`` and raises if CUDA is absent; the CPU is
    used only when the caller passes ``device="cpu"`` (there the tile passes
    take their plain torch versions). ``impl`` may be None (the census
    decides), "resident", "supercell", "banded", "dense", "tiered" or
    "sweep". Parity precision runs the sweep in float64 whatever ``impl``
    says, as the JAX engine does. ``clustered_impl`` is the engine the census
    gives a clustered load ("banded", the JAX default, or "tiered"); the
    census takes tiered where no band plan exists.
    ``pair_impl`` picks the resident engine's pair kernel (see
    ``PAIR_IMPLS``; supercell takes "v2" or "v4").
    """

    def __init__(self, config: SimConfig, kcap: int | None = None,
                 impl: str | None = None, device=None,
                 clustered_impl: str = "banded",
                 pair_impl: str | None = None):
        if config.n_shards > 1:
            raise NotImplementedError(
                "the sharded engines are not ported yet (n_shards > 1)")
        if clustered_impl not in CLUSTERED_IMPLS:
            raise ValueError(f"clustered_impl {clustered_impl!r}; valid: "
                             f"{CLUSTERED_IMPLS}")
        if pair_impl is not None and pair_impl not in PAIR_IMPLS:
            raise ValueError(f"pair_impl {pair_impl!r}; valid: {PAIR_IMPLS}")
        parity = config.precision is Precision.PARITY
        auto = impl is None and not parity
        if parity:
            impl = "sweep"
        elif impl is None and config.n_particles / config.ncells < 1.5:
            # JAX census: sparse grids go to super-cell tiles where the grid
            # can be coarsened (choose_supercell_factor), else to the sweep.
            impl = ("sweep" if choose_supercell_factor(config) is None
                    else "supercell")
        elif impl is not None and impl not in IMPLS:
            raise ValueError(f"unknown impl {impl!r}; valid: {IMPLS}")
        if device is None:
            device = "cuda"
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run on the CPU")
        self.config = config
        self.dtype = torch.float64 if parity else torch.float32
        self._impl_auto = auto
        self.impl = impl or "resident"
        self.clustered_impl = clustered_impl
        self.pair_impl = pair_impl
        self.kcap = kcap
        self._tier_plan = None  # [(cap, rows), ...] of the tiered engine
        self._band_plan = None  # [(row0, rows, kcap), ...] of the banded one
        self._built_key = None
        self._run = None

    def _supercell_factor(self) -> int:
        # An explicit supercell on a grid the chooser declines: coarsen as
        # far as the grid allows.
        return (choose_supercell_factor(self.config)
                or max(2, self.config.ncside // 8))

    def _sc_rows(self) -> int:
        nsc = -(-self.config.ncside // self._supercell_factor())
        return nsc * nsc

    def _heuristic_kcap(self) -> int:
        # Poisson-tail bound on max row occupancy for near-uniform loads;
        # the overflow check + lossless retry covers clustered ones.
        rows = (self._sc_rows() if self.impl == "supercell"
                else self.config.ncells)
        avg = max(1.0, self.config.n_particles / rows)
        bound = avg + 4.5 * avg ** 0.5 + 8
        return min(binning.round_cap(bound), MAX_DENSE_KCAP)

    def _default_tier_plan(self):
        # No census plan: Poisson k_small for the bulk plus a generous top
        # class; the retry ladder refines.
        ks = self._heuristic_kcap()
        kb = min(max(4 * ks, 256), MAX_DENSE_KCAP)
        fatrows = binning.round_cap(max(self.config.ncells // 16, 32))
        if kb <= ks:
            kb = binning.round_cap(ks + 32)
        return ((ks, self.config.ncells), (kb, fatrows))

    def _build(self):
        if self.impl == "banded":
            if self._band_plan is None:
                # No census plan: one whole-grid band at the Poisson bound.
                self._band_plan = ((0, self.config.ncside,
                                    self._heuristic_kcap()),)
            self._band_plan = tuple(tuple(p) for p in self._band_plan)
            self.kcap = max(k for _, _, k in self._band_plan)  # telemetry
            if self.kcap > MAX_DENSE_KCAP:
                self.impl = "dense"
                self._band_plan = None
                self.kcap = None
        if self.impl == "tiered":
            if self._tier_plan is None:
                self._tier_plan = self._default_tier_plan()
            self._tier_plan = tuple(tuple(p) for p in self._tier_plan)
            self.kcap = self._tier_plan[-1][0]  # telemetry: the top cap
            if self.kcap > MAX_DENSE_KCAP:
                self.impl = "dense"
                self._tier_plan = None
                self.kcap = None
        if self.impl != "sweep":
            if self.kcap is None:
                self.kcap = self._heuristic_kcap()
            if self.impl == "supercell":
                # The epilogue's compaction needs rows·kcap >= N slots.
                need = -(-self.config.n_particles // self._sc_rows()) + 8
                self.kcap = max(self.kcap, binning.round_cap(need))
            if self.kcap > MAX_DENSE_KCAP:
                self.impl = "sweep"
        key = (self.impl, self.kcap, self._tier_plan, self._band_plan,
               self.pair_impl)
        if self._built_key == key:
            return
        if self.impl == "sweep":
            _, self._run = make_step(self.config)
        elif self.impl == "resident":
            _, _, self._run = make_resident_run(self.config, self.kcap,
                                                self.pair_impl)
        elif self.impl == "supercell":
            _, _, self._run = make_supercell_run(
                self.config, self.kcap, self._supercell_factor(),
                self.pair_impl)
        elif self.impl == "banded":
            _, _, self._run = make_banded_run(self.config, self._band_plan)
        elif self.impl == "dense":
            _, _, self._run = make_dense_step(self.config, self.kcap)
        else:
            _, _, self._run = make_tiered_step(self.config, self._tier_plan,
                                               self.device)
        self._built_key = key

    def init_state(self) -> SimState:
        """Host-side initial conditions, cast, moved to the device and sorted
        by cell key; sizes the tiles from the occupancy census."""
        cfg = self.config
        xs, ys, vxs, vys, ms = init_particles_host(cfg)
        n = cfg.n_particles
        if self.kcap is None and self.impl != "sweep":
            w = cfg.side / cfg.ncside
            cx = np.clip((xs / w).astype(np.int64), 0, cfg.ncside - 1)
            cy = np.clip((ys / w).astype(np.int64), 0, cfg.ncside - 1)
            # Occupancy of the rows: cells, or supercell's S x S blocks.
            s = self._supercell_factor() if self.impl == "supercell" else 1
            nsc = -(-cfg.ncside // s)
            hist = np.bincount((cy // s) * nsc + cx // s, minlength=nsc * nsc)
            # Snug slack: pair-pass cost scales with kcap², and overflow
            # retries are lossless.
            kcap = min(binning.round_cap(int(hist.max()) * 1.1 + 4),
                       MAX_DENSE_KCAP)
            if self.impl != "supercell":
                self._census(hist, kcap)
            self.kcap = kcap
        dev = self.device

        def cast(a):
            return torch.as_tensor(a, dtype=self.dtype).to(dev)

        state = SimState(
            x=cast(xs), y=cast(ys), vx=cast(vxs), vy=cast(vys), m=cast(ms),
            alive=torch.ones(n, dtype=torch.bool, device=dev),
            pid=torch.arange(n, dtype=torch.int32, device=dev),
            collisions=torch.zeros((), dtype=torch.int64, device=dev),
            panics=torch.zeros((), dtype=torch.int32, device=dev),
            overflow=torch.zeros((), dtype=torch.int32, device=dev))
        key, _ = binning.cell_keys(state.x, state.y, cfg.side, cfg.ncside)
        key, pid, x, y, vx, vy, m, alive = binning.sort_by_cell(
            key, state.pid, state.x, state.y, state.vx, state.vy, state.m,
            state.alive)
        return state._replace(x=x, y=y, vx=vx, vy=vy, m=m, alive=alive,
                              pid=pid)

    def _census(self, hist, kcap: int):
        """The JAX census on the occupancy histogram (and the tile capacity
        it gives): for a clustered load, banded where a band plan exists and
        banded is the clustered engine, else tiered; for a uniform load
        whose tile state exceeds ``_STREAM_BYTES``, banded on equal bands of
        about ``_STREAM_BAND_BYTES``. An explicit banded run takes the band
        plan, or none (one whole-grid band)."""
        cfg = self.config
        if self.impl == "banded" and self._band_plan is None:
            bands = plan_bands(hist, cfg.ncside, MAX_DENSE_KCAP)
            self._band_plan = bands and tuple(tuple(p) for p in bands)
        plan = plan_tiers(hist, cfg.ncells, MAX_DENSE_KCAP)
        if self.impl == "tiered" or (self._impl_auto and _clustered(plan)):
            bands = (plan_bands(hist, cfg.ncside, MAX_DENSE_KCAP)
                     if self.impl != "tiered"
                     and self.clustered_impl == "banded" else None)
            if bands is not None:
                self.impl = "banded"
                self._band_plan = tuple(tuple(p) for p in bands)
            else:
                self.impl = "tiered"
                self._tier_plan = plan or self._default_tier_plan()
        if self._impl_auto and self.impl == "resident":
            row_bytes = cfg.ncside * kcap * 25
            band_rows = max(1, _STREAM_BAND_BYTES // max(1, row_bytes))
            if (cfg.ncells * kcap * 25 > _STREAM_BYTES
                    and -(-cfg.ncside // band_rows) >= 2):
                self.impl = "banded"
                self._band_plan = uniform_band_plan(cfg.ncside, band_rows,
                                                    kcap)

    def run(self, state: SimState, n_steps: int) -> SimState:
        for attempt in range(6):
            self._build()
            out = self._run(state._replace(overflow=torch.zeros_like(
                state.overflow)), n_steps)
            need = int(out.overflow)  # a tile run's one host readback
            if self.impl == "sweep" and need >= RANK_OVF:
                raise RuntimeError(
                    "collision rank overflow: a cell exceeded 65534 "
                    "occupants; uint32 pair ranks cannot order its "
                    "collision set")
            if need == 0:
                return out
            if self.impl == "tiered":
                self._grow_tiers(need, attempt)
                continue
            if self.impl == "banded":
                # Grow every band; if growth does not converge, the dense
                # engine has no bands to outgrow.
                self._band_plan = tuple(tuple(p) for p in grow_plan(
                    self._band_plan, 1.5, MAX_DENSE_KCAP))
                self.kcap = max(k for _, _, k in self._band_plan)
                if attempt >= 2:
                    self.impl = "dense"
                    self._band_plan = None
                    self.kcap = None
                continue
            # Occupancy outgrew the tiles: replay from the input state with
            # tiles sized to the observed occupancy. Beyond the tile cap the
            # ladder escalates resident -> dense -> sweep.
            self.kcap = max(binning.round_cap(need * 1.25 + 1),
                            binning.round_cap(self.kcap * 1.5))
            if self.impl == "resident" and (attempt >= 2
                                            or self.kcap > MAX_DENSE_KCAP):
                # Growth is not converging (or cannot): the dense engine has
                # no delivery step and re-censuses from the Poisson bound.
                self.impl = "dense"
                self.kcap = None
            elif self.impl == "supercell" and attempt >= 2:
                # Clustering at super-cell granularity: the sweep has no
                # tile capacity to outgrow.
                self.impl = "sweep"
            elif self.kcap > MAX_DENSE_KCAP:
                self.impl = "sweep"  # no tile capacity to outgrow
        raise RuntimeError("tile capacity retries exhausted")

    def _grow_tiers(self, need: int, attempt: int):
        """Re-plan the tiered engine after an overflow: a negative need is
        the worst class row deficit (grow every class's rows), a positive
        one a cell above the top cap (grow the top cap). Past attempt 2, or
        beyond the kernels' cap, fall back to the single-tier dense engine."""
        plan = [list(p) for p in self._tier_plan]
        if need < 0:
            for p in plan[1:]:
                p[1] = binning.round_cap(p[1] * 1.5 + (-need) * 1.3)
        else:
            plan[-1][0] = max(binning.round_cap(need * 1.25 + 1),
                              binning.round_cap(plan[-1][0] * 1.5))
        self._tier_plan = tuple(tuple(p) for p in plan)
        if attempt >= 2 or plan[-1][0] > MAX_DENSE_KCAP:
            self.impl = "dense"
            self._tier_plan = None
            self.kcap = None

    def result(self, state: SimState) -> tuple[float, float, int]:
        return result_of(state)

    def run_debug(self, state: SimState, n_steps: int) -> SimState:
        """Step-by-step execution for step-diff debugging: one run of one
        step at a time, with no overflow retry."""
        self._build()
        for _ in range(n_steps):
            state = self._run(state, 1)
        return state
