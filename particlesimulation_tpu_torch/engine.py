"""Single-device simulation engine: the slot-resident fast engine.

Counterpart of the JAX package's ``engine.py`` (``make_resident_run`` and
the resident part of ``Engine``). The state lives in (ncells, K) slot tiles;
one step is

1. per-cell COM and the 8-neighbour monopole (``mono_tables``,
   ``ops/stencil``, ``ops/dense.monopole_tile_forces``) added to the pair
   forces carried from the previous step;
2. integration with periodic wrap (``ops/integrate``);
3. rebin: movers change rows (``ops/resident.rebin``);
4. the fused collision(t) + pair-force(t+1) pass (``ops/cuda/cell_pairs``).

A run is a Python loop over steps on the device with no host readback inside
it; the engine reads the overflow counter once per run and, when the tiles
were too small, replays the run losslessly with larger tiles (the reference
instead PANIC-skips particles, serial/parsim.cpp:276-280).

The JAX census may route a configuration to an engine the port does not
have yet (supercell, sweep, banded, tiered, dense); the port then raises
``NotImplementedError`` naming that engine and never runs another one.
"""

from __future__ import annotations

import numpy as np
import torch

from particlesimulation_tpu_torch.config import DELTAT, EPSILON, Precision, SimConfig
from particlesimulation_tpu_torch.initializer import init_particles_host
from particlesimulation_tpu_torch.ops import binning, dense, integrate, stencil
from particlesimulation_tpu_torch.ops import resident as res
from particlesimulation_tpu_torch.ops.cuda import cell_pairs
from particlesimulation_tpu_torch.state import SimState, result_of

# Largest tile capacity the fused pair kernel takes; beyond it the JAX
# engine escalates to the dense engine.
MAX_DENSE_KCAP = cell_pairs.MAX_KCAP
INF = cell_pairs.INF

# Above this tile-state size the JAX census streams uniform loads through
# row bands (engine.py PSIM_STREAM_BYTES default, 256 MB).
_STREAM_BYTES = 256 << 20
_STREAM_BAND_BYTES = 40 << 20

# Cost model of the JAX package's occupancy-classed tile planner
# (ops/tiered.py), used by the census to recognise clustered loads.
_CLASS_PENALTY = 8_000_000
_SLOT_WEIGHT = 24


def make_resident_run(config: SimConfig, kcap: int):
    """Build (prologue, run) of the slot-resident fast engine at tile
    capacity ``kcap``. ``run(state, n_steps)`` returns the final SimState."""
    side = config.side
    nc = config.ncside
    ncells = config.ncells
    nslots = ncells * kcap
    form = dense.pair_force_form(side)

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
        M = torch.sum(mf, dim=1)
        SX = torch.sum(mf * ts.x, dim=1)
        SY = torch.sum(mf * ts.y, dim=1)
        has = M > 0
        safe = torch.where(has, M, 1.0)
        MX = torch.where(has, SX / safe, 0.0)
        MY = torch.where(has, SY / safe, 0.0)
        ml, mxl, myl = stencil.stencil_tables(M, MX, MY, side, nc)
        return (ml[:, :ncells].T.contiguous(), mxl[:, :ncells].T.contiguous(),
                myl[:, :ncells].T.contiguous())

    def physics_mass(ts):
        binned, limbo_count = res.binned_mask(ts, side, nc)
        # Zero mf silences limbo slots in every physics pass: they exert
        # and receive no force and never collide.
        return torch.where(binned, ts.m, 0.0), binned, limbo_count

    def pair_pass(ts, collide: bool):
        """Fused collision(t) + pair-force(t+1) pass; (fx, fy, count, died).

        The post-move positions a step's collision pass scans are the
        positions the next step's force pass needs; forces come out with
        this pass's deaths applied (merged particles are massless from the
        next step on). pid tiles give the reference's pid-order tie-breaks.
        """
        mf, binned, _ = physics_mass(ts)
        alive = (binned & (ts.m > 0)).to(torch.int32)
        fx, fy, count, ft = cell_pairs.fused_pairs(
            ts.x, ts.y, mf, alive, ts.pid, kcap, EPSILON, collide=collide,
            force_form=form)
        return fx, fy, count, ft != INF

    def step(ts, fxd, fyd):
        mf, _, limbo_count = physics_mass(ts)
        fxm, fym = dense.monopole_tile_forces(ts.x, ts.y, mf,
                                              *mono_tables(ts, mf))
        # Integrate in place; m==0 (dead or empty slot) stays frozen.
        x, y, vx, vy = integrate.integrate(ts.x, ts.y, ts.vx, ts.vy, ts.m,
                                           fxd + fxm, fyd + fym, side, DELTAT)
        ts = ts._replace(x=x, y=y, vx=vx, vy=vy)
        ts, undelivered = res.rebin(ts, side, nc, kcap)
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

    return prologue, run


def _round_cap(x: float) -> int:
    # Pair-pass cost scales with kcap², so size tiles snugly in multiples
    # of 32.
    return max(32, (int(x) + 31) // 32 * 32)


def _clustered(hist, ncells: int, max_kcap: int) -> bool:
    """Whether the JAX census's occupancy-classed planner (ops/tiered.py
    ``plan_tiers``) finds a class ladder whose top cap is at least twice its
    bulk cap — the test that routes a load to the banded or tiered engine."""
    top = min(_round_cap(int(hist.max()) * 1.1 + 4), max_kcap)
    caps = list(range(32, top, 32)) + [top]
    above = {k: int((hist > k).sum()) for k in [0] + caps}
    # tail[k]: the cheapest (cost, plan) of the classes above cap k.
    tail = {top: (0, ())}

    def cheapest(prev: int, first: bool):
        options = []
        for k in caps:
            if k <= prev:
                continue
            rows = (ncells if first else
                    max(32, -(-int((above[prev] - above[k]) * 1.3) // 32) * 32))
            cost, plan = tail[k]
            options.append((rows * k * k + _SLOT_WEIGHT * rows * k
                            + _CLASS_PENALTY + cost, ((k, rows),) + plan))
        return min(options, key=lambda o: o[0])  # first of equal costs

    for prev in reversed(caps[:-1]):
        tail[prev] = cheapest(prev, False)
    cost, plan = cheapest(0, True)
    single = ncells * top * top + _SLOT_WEIGHT * ncells * top
    return (cost <= 0.6 * single and len(plan) >= 2
            and plan[-1][0] >= 2 * plan[0][0])


class Engine:
    """Single-device engine: init, run loop, result extraction.

    ``device`` defaults to ``cuda`` and raises if CUDA is absent; the CPU is
    used only when the caller passes ``device="cpu"`` (there the fused pair
    pass takes its plain torch version). ``impl`` may be None (the census
    decides) or "resident"; any other engine is not ported yet.
    """

    def __init__(self, config: SimConfig, kcap: int | None = None,
                 impl: str | None = None, device=None):
        if config.precision is not Precision.FAST:
            raise NotImplementedError(
                "the f64 parity engine (sweep) is not ported yet")
        if config.n_shards > 1:
            raise NotImplementedError(
                "the sharded engines are not ported yet (n_shards > 1)")
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
        elif impl != "resident":
            raise NotImplementedError(
                f"the {impl!r} engine is not ported yet; valid: 'resident'")
        if device is None:
            device = "cuda"
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run on the CPU")
        self.config = config
        self._impl_auto = impl is None
        self.kcap = kcap
        self._built_kcap = None
        self._run = None

    def _heuristic_kcap(self) -> int:
        # Poisson-tail bound on max cell occupancy for near-uniform loads;
        # the overflow check + lossless retry covers clustered ones.
        avg = max(1.0, self.config.n_particles / self.config.ncells)
        bound = avg + 4.5 * avg ** 0.5 + 8
        return min(_round_cap(bound), MAX_DENSE_KCAP)

    def _build(self):
        if self.kcap is None:
            self.kcap = self._heuristic_kcap()
        if self.kcap > MAX_DENSE_KCAP:
            raise NotImplementedError(
                f"kcap {self.kcap} exceeds the fused pair kernel's "
                f"{MAX_DENSE_KCAP}; the JAX engine escalates to the dense "
                f"engine, which is not ported yet")
        if self._built_kcap != self.kcap:
            _, self._run = make_resident_run(self.config, self.kcap)
            self._built_kcap = self.kcap

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
            occ = int(hist.max())
            kcap = min(_round_cap(occ * 1.1 + 4), MAX_DENSE_KCAP)
            if self._impl_auto:
                self._census(hist, kcap)
            # Snug slack: pair-pass cost scales with kcap², and overflow
            # retries are lossless.
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
        """Raise where the JAX census would leave the resident engine."""
        cfg = self.config
        if _clustered(hist, cfg.ncells, MAX_DENSE_KCAP):
            raise NotImplementedError(
                "the census routes this clustered load to the banded engine "
                "(tiered where bands do not apply), which is not ported yet")
        row_bytes = cfg.ncside * kcap * 25
        band_rows = max(1, _STREAM_BAND_BYTES // max(1, row_bytes))
        if (cfg.ncells * kcap * 25 > _STREAM_BYTES
                and -(-cfg.ncside // band_rows) >= 2):
            raise NotImplementedError(
                "the census streams tile state above 256 MB through the "
                "banded engine, which is not ported yet")

    def run(self, state: SimState, n_steps: int) -> SimState:
        for _ in range(3):
            self._build()
            out = self._run(state._replace(overflow=torch.zeros_like(
                state.overflow)), n_steps)
            need = int(out.overflow)  # the run's one host readback
            if need == 0:
                return out
            # Occupancy outgrew the tiles: replay from the input state with
            # tiles sized to the observed occupancy.
            self.kcap = max(_round_cap(need * 1.25 + 1),
                            _round_cap(self.kcap * 1.5))
        raise NotImplementedError(
            "tile growth is not converging after 3 runs; the JAX engine "
            "escalates to the dense engine, which is not ported yet")

    def result(self, state: SimState) -> tuple[float, float, int]:
        return result_of(state)
