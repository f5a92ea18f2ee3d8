"""Single-device simulation engines: slot-resident, dense and tiered.

Counterpart of the JAX package's ``engine.py``. Three f32 fast-path
implementations:

* ``resident`` (``make_resident_run``) — the state lives in (ncells, K) slot
  tiles; one step is
  1. per-cell COM and the 8-neighbour monopole (``ops/stencil``,
     ``ops/dense.monopole_tile_forces``) added to the pair forces carried
     from the previous step;
  2. integration with periodic wrap (``ops/integrate``);
  3. rebin: movers change rows (``ops/resident.rebin``);
  4. the fused collision(t) + pair-force(t+1) pass (``ops/cuda/cell_pairs``).
* ``dense`` (``make_dense_step``) — particle arrays sorted by (cell, pid),
  scattered into (ncells, K) tiles each step for the force and collision
  kernels; the resident engine's escalation target.
* ``tiered`` (``ops/tiered.make_tiered_step``) — the dense step on
  occupancy-classed tiles, for clustered loads.

A run is a Python loop over steps on the device with no host readback inside
it; the engine reads the overflow counter once per run and, when the tiles
were too small, replays the run losslessly with larger tiles or another
engine, as the JAX engine's retry ladder does (the reference instead
PANIC-skips particles, serial/parsim.cpp:276-280).

Where the JAX census or ladder would pick an engine the port does not have
yet (supercell, sweep, banded), the port raises ``NotImplementedError``
naming that engine and never runs another one.
"""

from __future__ import annotations

import numpy as np
import torch

from particlesimulation_tpu_torch.config import DELTAT, EPSILON, Precision, SimConfig
from particlesimulation_tpu_torch.initializer import init_particles_host
from particlesimulation_tpu_torch.ops import binning, collisions, dense, integrate, stencil
from particlesimulation_tpu_torch.ops import resident as res
from particlesimulation_tpu_torch.ops.banded import plan_bands
from particlesimulation_tpu_torch.ops.cuda import cell_pairs
from particlesimulation_tpu_torch.ops.tiered import make_tiered_step, plan_tiers
from particlesimulation_tpu_torch.state import SimState, result_of

# Largest tile capacity the tile kernels take; beyond it the JAX engine
# escalates resident -> dense -> sweep.
MAX_DENSE_KCAP = cell_pairs.MAX_KCAP
INF = cell_pairs.INF

IMPLS = ("resident", "dense", "tiered")
UNPORTED_IMPLS = ("sweep", "supercell", "banded")
CLUSTERED_IMPLS = ("banded", "tiered")
# Pair kernels of the resident engine (the JAX package's PSIM_PALLAS_PAIR):
# v4 and v2 are the hit-gated kernel's two force forms, v1 the ungated
# kernel in the v2 form. None picks v4 or v2 by the box side.
PAIR_IMPLS = ("v1", "v2", "v4")

# Above this tile-state size the JAX census streams uniform loads through
# row bands (engine.py PSIM_STREAM_BYTES default, 256 MB).
_STREAM_BYTES = 256 << 20
_STREAM_BAND_BYTES = 40 << 20


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

    def step(ts, fxd, fyd):
        ts, undelivered, limbo_count = advance(ts, fxd, fyd)
        fxd, fyd, count, died = pair_pass(ts, collide=True)
        ovf = torch.where(undelivered > 0, kcap + 1, 0).to(torch.int32)
        ts = ts._replace(
            m=torch.where(died, 0.0, ts.m),
            collisions=ts.collisions + count,
            panics=ts.panics + limbo_count,
            overflow=torch.maximum(ts.overflow, ovf))
        return ts, fxd, fyd

    def epilogue(ts: res.TileState, n: int) -> SimState:
        # Compact tiles back to N particle-major arrays (once per run).
        occf = ts.occ.reshape(-1)
        order = torch.argsort((~occf).to(torch.uint8), stable=True)[:n]
        x, y, vx, vy, m, pid, occ = (a.reshape(-1)[order] for a in (
            ts.x, ts.y, ts.vx, ts.vy, ts.m, ts.pid, ts.occ))
        key, _ = binning.cell_keys(x, y, side, nc)
        key, pid, x, y, vx, vy, m, alive = binning.sort_by_cell(
            key, pid, x, y, vx, vy, m, occ & (m > 0))
        return SimState(x=x, y=y, vx=vx, vy=vy, m=m, alive=alive, pid=pid,
                        collisions=ts.collisions, panics=ts.panics,
                        overflow=ts.overflow)

    def run(state: SimState, n_steps: int) -> SimState:
        ts = prologue(state)
        fxd, fyd, _, _ = pair_pass(ts, collide=False)
        for _ in range(n_steps):
            ts, fxd, fyd = step(ts, fxd, fyd)
        return epilogue(ts, state.x.shape[0])

    def pair_tiles(state: SimState, n_steps: int):
        ts = prologue(state)
        if n_steps > 0:
            fxd, fyd, _, _ = pair_pass(ts, collide=False)
            for _ in range(n_steps - 1):
                ts, fxd, fyd = step(ts, fxd, fyd)
            ts = advance(ts, fxd, fyd)[0]
        return pair_args(ts)

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
    decides), "resident", "dense" or "tiered"; "sweep", "supercell" and
    "banded" are not ported yet. ``clustered_impl`` is the engine the census
    gives a clustered load ("banded", the JAX default, or "tiered"); the
    census takes tiered where no band plan exists. ``pair_impl`` picks the
    resident engine's pair kernel (see ``PAIR_IMPLS``).
    """

    def __init__(self, config: SimConfig, kcap: int | None = None,
                 impl: str | None = None, device=None,
                 clustered_impl: str = "banded",
                 pair_impl: str | None = None):
        if config.precision is not Precision.FAST:
            raise NotImplementedError(
                "the f64 parity engine (sweep) is not ported yet")
        if config.n_shards > 1:
            raise NotImplementedError(
                "the sharded engines are not ported yet (n_shards > 1)")
        if clustered_impl not in CLUSTERED_IMPLS:
            raise ValueError(f"clustered_impl {clustered_impl!r}; valid: "
                             f"{CLUSTERED_IMPLS}")
        if pair_impl is not None and pair_impl not in PAIR_IMPLS:
            raise ValueError(f"pair_impl {pair_impl!r}; valid: {PAIR_IMPLS}")
        if impl is None:
            avg = config.n_particles / config.ncells
            if avg < 1.5:
                # JAX census: sparse grids go to super-cell tiles where the
                # grid can be coarsened (ops/supercell.choose_supercell_factor
                # needs ncside >= 16), else to the sweep.
                other = "supercell" if config.ncside >= 16 else "sweep"
                raise NotImplementedError(
                    f"the census routes average occupancy {avg:.3g} < 1.5 to "
                    f"the {other} engine, which is not ported yet; pass "
                    f"impl='resident' to run the resident engine")
        elif impl in UNPORTED_IMPLS:
            raise NotImplementedError(
                f"the {impl!r} engine is not ported yet; valid: {IMPLS}")
        elif impl not in IMPLS:
            raise ValueError(f"unknown impl {impl!r}; valid: {IMPLS}")
        if device is None:
            device = "cuda"
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run on the CPU")
        self.config = config
        self._impl_auto = impl is None
        self.impl = impl or "resident"
        self.clustered_impl = clustered_impl
        self.pair_impl = pair_impl
        self.kcap = kcap
        self._tier_plan = None  # [(cap, rows), ...] of the tiered engine
        self._built_key = None
        self._run = None

    def _heuristic_kcap(self) -> int:
        # Poisson-tail bound on max cell occupancy for near-uniform loads;
        # the overflow check + lossless retry covers clustered ones.
        avg = max(1.0, self.config.n_particles / self.config.ncells)
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
        if self.impl == "tiered":
            if self._tier_plan is None:
                self._tier_plan = self._default_tier_plan()
            self._tier_plan = tuple(tuple(p) for p in self._tier_plan)
            self.kcap = self._tier_plan[-1][0]  # telemetry: the top cap
            if self.kcap > MAX_DENSE_KCAP:
                self.impl = "dense"
                self._tier_plan = None
                self.kcap = None
        if self.kcap is None:
            self.kcap = self._heuristic_kcap()
        if self.kcap > MAX_DENSE_KCAP:
            raise NotImplementedError(
                f"kcap {self.kcap} exceeds the tile kernels' "
                f"{MAX_DENSE_KCAP}; the JAX engine escalates to the sweep "
                f"engine, which is not ported yet")
        key = (self.impl, self.kcap, self._tier_plan, self.pair_impl)
        if self._built_key == key:
            return
        if self.impl == "resident":
            _, _, self._run = make_resident_run(self.config, self.kcap,
                                                self.pair_impl)
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
        if self.kcap is None:
            w = cfg.side / cfg.ncside
            cx = np.clip((xs / w).astype(np.int64), 0, cfg.ncside - 1)
            cy = np.clip((ys / w).astype(np.int64), 0, cfg.ncside - 1)
            hist = np.bincount(cy * cfg.ncside + cx, minlength=cfg.ncells)
            # Snug slack: pair-pass cost scales with kcap², and overflow
            # retries are lossless.
            kcap = min(binning.round_cap(int(hist.max()) * 1.1 + 4),
                       MAX_DENSE_KCAP)
            self._census(hist, kcap)
            self.kcap = kcap
        dev = self.device

        def f32(a):
            return torch.as_tensor(a, dtype=torch.float32).to(dev)

        state = SimState(
            x=f32(xs), y=f32(ys), vx=f32(vxs), vy=f32(vys), m=f32(ms),
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
        it gives): classed tiles for a clustered load (banded where a band
        plan exists and banded is the clustered engine, which raises here;
        else tiered), and the banded streaming route, which raises here, for
        large uniform loads."""
        cfg = self.config
        plan = plan_tiers(hist, cfg.ncells, MAX_DENSE_KCAP)
        if self.impl == "tiered" or (self._impl_auto and _clustered(plan)):
            if (self.impl != "tiered" and self.clustered_impl == "banded"
                    and plan_bands(hist, cfg.ncside, MAX_DENSE_KCAP)
                    is not None):
                raise NotImplementedError(
                    "the census routes this clustered load to the banded "
                    "engine, which is not ported yet; pass "
                    "clustered_impl='tiered' to run the tiered engine")
            self.impl = "tiered"
            self._tier_plan = plan or self._default_tier_plan()
        if self._impl_auto and self.impl == "resident":
            row_bytes = cfg.ncside * kcap * 25
            band_rows = max(1, _STREAM_BAND_BYTES // max(1, row_bytes))
            if (cfg.ncells * kcap * 25 > _STREAM_BYTES
                    and -(-cfg.ncside // band_rows) >= 2):
                raise NotImplementedError(
                    "the census streams tile state above 256 MB through the "
                    "banded engine, which is not ported yet")

    def run(self, state: SimState, n_steps: int) -> SimState:
        for attempt in range(6):
            self._build()
            out = self._run(state._replace(overflow=torch.zeros_like(
                state.overflow)), n_steps)
            need = int(out.overflow)  # the run's one host readback
            if need == 0:
                return out
            if self.impl == "tiered":
                self._grow_tiers(need, attempt)
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
            elif self.kcap > MAX_DENSE_KCAP:
                raise NotImplementedError(
                    f"kcap {self.kcap} exceeds the tile kernels' "
                    f"{MAX_DENSE_KCAP}; the JAX engine escalates to the "
                    f"sweep engine, which is not ported yet")
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
