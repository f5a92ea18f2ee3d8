"""Row-sharded engine over a 1D mesh (counterpart of the JAX package's
``parallel/sharded.py``).

Spatial decomposition as in the reference MPI variant (reference
mpi/parsim-mpi.cpp:330-465): the ``ncside`` grid rows are split into
contiguous blocks, one per shard; each shard owns the particles whose cell
row falls in its block, in a slab of C slots sorted by (cell key, pid). A
sweep step, written against the mesh interface of ``parallel/mesh``:

* local binning and COM over the shard's row block;
* a one-row COM halo to each ring neighbour (``mesh.ppermute``; the
  reference's Isend/Irecv ghost exchange, mpi/parsim-mpi.cpp:670-815): only
  monopole data crosses shards, never particle bodies;
* forces and integration against the halo-padded stencil;
* emigrants ride a fixed-capacity ring buffer for D-1 hops (the reference's
  Alltoall + point-to-point migration, mpi/parsim-mpi.cpp:512-600), landing
  in free slab slots;
* the post-move sort and collisions; the collision count, panics and
  overflow are summed over the mesh (``mesh.psum``; MPI_Reduce,
  mpi/parsim-mpi.cpp:1098-1099).

Each cell lives wholly on one shard and its particles keep pid order, so
per-cell arithmetic is the single-device sweep's: the f64 run is bitwise
equal to the single-device parity engine (and to the JAX sharded engine).
The sweeps run once over all the local shards' lanes: shard l's local cell
c gets the key ``l * ncells_local + c``, so the sweep's three passes
(``ops/cuda/sweep``: the kernels on the card, ``ops/com``, ``ops/forces``
and ``ops/collisions`` on the CPU) run unchanged, cell by cell, on each
lane's batched key and its position in its cell, the occupancy read on the
card as on one device (no readback in a step: the run replays one CUDA
graph); the halo tables are built per shard from global coordinates.

Migration runs D-1 ring hops every step. The JAX engine gates its hops on
a ``psum`` of the pending emigrants, a value the host would read each hop;
its own comment notes that skipped hops forward an all-invalid buffer and
accept nothing, so the unconditional D-1 hops give the same bits with no
readback.

Row decomposition is balanced-uneven (``SimConfig.rows_of_shard``) or
census-planned (``parallel/balance``). Every shard's local COM grid is
``rows_max`` tall; a shard with fewer rows leaves its tail rows empty and
takes its bottom halo at row ``rows_mine + 1``.

The f32 fast precision runs tile engines by the JAX mesh census: sharded
super-cell tiles for sparse loads (``parallel/sharded_supercell``),
column-sharded bands for clustered loads and for uniform ones whose tile
state a shard exceeds ``engine._STREAM_BYTES`` (the streaming route,
``parallel/sharded_banded_cols``), and the sharded resident tiles
(``parallel/sharded_resident``) otherwise; this sweep runs in f32 on
request or as the ladder's last rung. ``impl="banded-cyclic"`` runs JAX's
block-cyclic bands (``parallel/sharded_banded``), which the census never
picks. The 2D mesh is ``parallel/sharded2d``; this engine runs the 1D row
split of ``config.n_shards`` shards whatever ``config.mesh_shape`` says.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from particlesimulation_tpu_torch import engine as single
from particlesimulation_tpu_torch.config import DELTAT, EPSILON, Precision, SimConfig
from particlesimulation_tpu_torch.initializer import init_particles_host
from particlesimulation_tpu_torch.ops import (binning, collisions, graphed,
                                              integrate)
from particlesimulation_tpu_torch.ops.banded import (grow_plan, plan_bands,
                                                     plan_bands_cyclic,
                                                     uniform_band_plan)
from particlesimulation_tpu_torch.ops.cuda import migrate as migrate_ops
from particlesimulation_tpu_torch.ops.cuda import stencil as stencil_ops
from particlesimulation_tpu_torch.ops.cuda import sweep
from particlesimulation_tpu_torch.ops.supercell import choose_supercell_factor
from particlesimulation_tpu_torch.ops.tiered import plan_tiers
from particlesimulation_tpu_torch.parallel.balance import plan_shard_rows
from particlesimulation_tpu_torch.parallel.mesh import LocalMesh
from particlesimulation_tpu_torch.state import ShardedState

# Overflow-cause sentinels. ``ShardedState.overflow`` combines causes by
# maximum (counts of one cause add up below the sentinels; the sweep's
# ``engine.RANK_OVF`` lies above them all), so the largest present wins and
# the retry ladder dispatches on ranges: below SHIP_OVF, tile-occupancy /
# migration counts (grow kcap or the sweep's buffers); SHIP_OVF, resident
# emigrants still in transit after the last ship round (more rounds);
# CAP_OVF + deficit, a slab out of slots (grow the slab); STRAY_OVF, a
# particle outside its owner's rows (an invariant violation, not
# capacity-fixable).
SHIP_OVF = 1 << 27
CAP_OVF = 1 << 28
STRAY_OVF = 1 << 29
INT32_MAX = np.iinfo(np.int32).max
# Ship rounds beyond the D-hop worst case: the resident ladder's round cap
# (the JAX resident engine's).
SHIP_SLACK = 4
IMPLS = ("resident", "sweep", "supercell", "banded", "banded-cols",
         "banded-cyclic")


def check_capturable(mesh) -> None:
    """Raise ValueError where ``mesh``'s collectives cannot be captured in
    a CUDA graph (a gloo mesh on a CUDA device): ``run`` replays graphs,
    ``run_eager`` runs there."""
    if not mesh.capturable:
        raise ValueError("this mesh's collectives pass through host "
                         "memory and cannot be captured as CUDA graphs; "
                         "use run_eager")


def mesh_need(mesh, out: ShardedState) -> int:
    """A run's overflow as the ladder reads it: the mesh's maximum, the
    run's one readback. The causes are combined over the mesh in the run
    (counts by ``psum``, sentinels by ``pmax``) but for the sweep's rank
    flag, which each shard raises from its own cells; the maximum makes
    every shard take the same rung, so that none waits in a collective the
    others do not reach."""
    return int(mesh.pmax(out.overflow[None]))


def shard_rows(config: SimConfig, mesh):
    """(row0, rows_mine) of the mesh's local shards: (L,) int64 tensors."""
    return (torch.tensor([config.row0_of_shard(s) for s in mesh.local_shards],
                         device=mesh.device),
            torch.tensor([config.rows_of_shard(s) for s in mesh.local_shards],
                         device=mesh.device))


def sort_slabs(key, pid, *arrays):
    """Sort each shard's slab (rows of (L, C) tensors) by (key, pid), ties
    (empty slots of one pid) in slot order. Returns (key, pid, *arrays)."""
    composite = key.to(torch.int64) * (1 << 32) + pid.to(torch.int64)
    order = torch.argsort(composite, dim=1, stable=True)
    return tuple(torch.gather(a, 1, order) for a in (key, pid) + arrays)


def _slab_key(x, y, valid, side, nc):
    key, in_range = binning.cell_keys(x, y, side, nc)
    return torch.where(valid, key, nc * nc + 1), in_range


def own_fields(slab):
    """A migration's slab with copies of the fields the sweep's step took
    from its state (m, alive, pid), so that its packs, which land arrivals
    in place, write no tensor of the state (a retry replays the run from
    it, ``run_eager`` from the caller's)."""
    return {k: v.clone() if k in ("m", "alive", "pid") else v
            for k, v in slab.items()}


def make_slab_sweep(config: SimConfig, mesh, ncl: int, local_cell, tables,
                    migrate):
    """Build (step, run) of the sweep over the mesh's sorted slabs, from
    the decomposition's three parts:

    * ``local_cell(key, real)``: each real lane's cell on its shard's local
      grid of ``ncl`` cells, from (L, C) global keys (``real``: key <
      ncells); a sorted slab's keys must map onto it monotonically. The
      sweeps run once over all shards' lanes, on batched keys (shard l's
      local cell c is ``l * ncl + c``);
    * ``tables(M, MX, MY)``: the stencil tables, (8, L * ncl + 1) each, of
      the local COM over the batched cells (the halo exchange);
    * ``migrate(slab, valid)``: the emigrants moved to their owners' slabs
      (``slab`` a dict of (L, C) x/y/vx/vy/m/alive/pid); (slab, valid,
      (L,) overflow). Its packs write in place (``ops/cuda/migrate``):
      x, y, vx, vy and ``valid`` are the step's own tensors, but m, alive
      and pid are the state's, which it copies before its first pack
      (``own_fields``).

    Parity (f64, the reference's operation order) or fast (f32), by
    ``config.precision``. ``step(state, counts, kmax, large)`` takes a
    ShardedState and the device part of the occupancy of its batched cell
    keys, and returns the next state and the occupancy of its keys in the
    same form, as ``engine.make_step``'s step does, reading nothing back;
    ``run(state, n_steps)`` returns the final ShardedState, a
    ``graphed.GraphedRun`` whose steps replay one graph on the card."""
    side = config.side
    nc = config.ncside
    ncells = config.ncells
    L = len(mesh.local_shards)
    nb = L * ncl                            # cells of the batched grid
    lpos = torch.arange(L, device=mesh.device)[:, None]

    def lanes(key):
        """Batched keys of (L, C) global keys, flat (sentinel lanes nb),
        and each lane's position in its cell (from a sorted surrogate key
        that keeps the out-of-range and empty lanes of each shard apart)."""
        real = key < ncells
        lk = local_cell(key, real)
        bkey = torch.where(real, lpos * ncl + lk, nb).reshape(-1).to(
            torch.int32)
        skey = lpos * (ncl + 2) + torch.where(real, lk, key - ncells + ncl)
        pos, _ = binning.segment_positions(skey.reshape(-1))
        return bkey, pos

    def step(state: ShardedState, counts, kmax, large):
        x, y, vx, vy, m, alive, valid, pid = (a.view(L, -1)
                                              for a in state[:8])
        # ---- binning, local COM, pair forces (the slab arrives sorted) ----
        key, _ = _slab_key(x, y, valid, side, nc)
        bkey, pos = lanes(key)
        plan = binning.Occupancy(counts, kmax, large, bkey)
        X, Y, Mf, Af = (a.reshape(-1) for a in (x, y, m, alive))
        M, MX, MY = sweep.sweep_com(X, Y, Mf, bkey, pos, plan, nb)
        # ---- COM halo, then the pair and monopole terms ----
        fx, fy = sweep.sweep_forces(X, Y, Mf, Af, bkey, pos, plan,
                                    tables(M, MX, MY), nb)
        # ---- integrate + wrap ----
        x, y, vx, vy = (a.view(L, -1) for a in integrate.integrate(
            X, Y, vx.reshape(-1), vy.reshape(-1), Mf, fx, fy, side, DELTAT))

        # ---- migration (reference P4) ----
        slab, valid, overflow = migrate(
            dict(x=x, y=y, vx=vx, vy=vy, m=m, alive=alive, pid=pid), valid)
        x, y, vx, vy, m, alive, pid = (slab[k] for k in (
            "x", "y", "vx", "vy", "m", "alive", "pid"))

        # Cleared slots hold inert values (m = 0 freezes them everywhere).
        x, y, m = (torch.where(valid, a, 0.0) for a in (x, y, m))
        alive = alive & valid

        # ---- post-move sort + collisions (the one sort a step) ----
        key3, in_range3 = _slab_key(x, y, valid, side, nc)
        panics = torch.sum(valid & ~in_range3, dim=1, dtype=torch.int32)
        key3, pid, x, y, vx, vy, m, alive, valid = sort_slabs(
            key3, pid, x, y, vx, vy, m, alive, valid)
        bkey3, pos3 = lanes(key3)
        plan2 = binning.occupancy(bkey3, nb, pos3)
        count, died = sweep.sweep_collisions(
            x.reshape(-1), y.reshape(-1), alive.reshape(-1), bkey3, pos3,
            plan2, EPSILON, nb)
        m, alive = collisions.apply_deaths(m.reshape(-1), alive.reshape(-1),
                                           died)
        # Counts add up; the rank sentinel is combined by maximum, as on
        # one device, so that it holds however many steps raise it.
        overflow = single.rank_flag(state.overflow + mesh.psum(overflow),
                                    plan2.kmax)
        out = ShardedState(
            x=x.reshape(-1), y=y.reshape(-1), vx=vx.reshape(-1),
            vy=vy.reshape(-1), m=m, alive=alive, valid=valid.reshape(-1),
            pid=pid.reshape(-1),
            collisions=state.collisions + mesh.psum(count[None]),
            panics=state.panics + mesh.psum(panics),
            overflow=overflow)
        return out, plan2.counts, plan2.kmax, plan2.large

    def start(state: ShardedState):
        key, _ = _slab_key(state.x.view(L, -1), state.y.view(L, -1),
                           state.valid.view(L, -1), side, nc)
        bkey, pos = lanes(key)
        plan = binning.occupancy(bkey, nb, pos)
        return state, plan.counts, plan.kmax, plan.large

    run = graphed.loop_run(start, step, lambda carry, state: carry[0])
    return step, run


def make_sharded_step(config: SimConfig, mesh, cap: int, bcap: int):
    """Build (step, run) of the sweep over the mesh's slabs of ``cap`` slots
    on row blocks (``make_slab_sweep``), with emigrant buffers of ``bcap``
    entries."""
    side = config.side
    nc = config.ncside
    ncells = config.ncells
    d = config.n_shards
    ncl = config.rows_max * nc              # local cells of one shard
    L = len(mesh.local_shards)
    row0, rows_mine = shard_rows(config, mesh)
    me = mesh.shard_ids[:, None]
    owner = torch.as_tensor(config.shard_of_row(np.arange(nc)),
                            dtype=torch.int64, device=mesh.device)

    def local_cell(key, real):
        return key - row0[:, None] * nc

    layout = stencil_ops.HaloLayout((config.rows_max,), nc, row0=(row0,),
                                    rows_mine=(rows_mine,))

    def tables(M, MX, MY):
        grids = [tuple(a.view(L, config.rows_max, nc) for a in (M, MX, MY))]
        return stencil_ops.mesh_tables(mesh, layout, grids, side, nc)

    def migrate(slab, valid):
        """Emigrants ride the ring buffer D-1 hops, landing in free slots."""
        key2, _ = _slab_key(slab["x"], slab["y"], valid, side, nc)
        real2 = valid & (key2 < ncells)
        dest = torch.where(real2, owner[torch.where(real2, key2 // nc, 0)],
                           me)
        emig = valid & (dest != me)
        buf, overflow = migrate_ops.compact(slab, emig, bcap, dest=dest)
        valid = valid & ~emig
        if d > 1:
            slab = own_fields(slab)
        for _ in range(d - 1):
            buf = mesh.ppermute(buf, 1)
            # Arrivals, in buffer order, fill the free slots in slot order.
            arr = buf["valid"] & (buf["dest"] == me)
            slab, valid, ovf = migrate_ops.pack(slab, valid, buf, arr)
            overflow = overflow + ovf
            buf["valid"] = buf["valid"] & ~arr
        return slab, valid, overflow

    return make_slab_sweep(config, mesh, ncl, local_cell, tables, migrate)


class SlabMesh:
    """The slab state of a mesh engine (``config``, ``device``, ``mesh``):
    scattered from host arrays, grown, gathered and read back the same way
    whatever the decomposition. A state holds the slabs of the mesh's local
    shards (``mesh.local_shards``): all of them on a ``LocalMesh``, this
    rank's on a ``DistMesh``."""

    def _scatter(self, particles, shard, cap: int, collisions, panics,
                 dt) -> ShardedState:
        """Host particle arrays into the local shards' slabs of ``cap``
        slots by ``shard`` (each particle's owner), each slab sorted by
        (cell key, pid)."""
        local = self.mesh.local_shards
        L = len(local)
        slabs = {k: np.zeros((L, cap)) for k in ("x", "y", "vx", "vy", "m")}
        alive = np.zeros((L, cap), dtype=bool)
        valid = np.zeros((L, cap), dtype=bool)
        pids = np.full((L, cap), INT32_MAX, dtype=np.int32)
        for l, s in enumerate(local):
            idx = np.nonzero(shard == s)[0]
            k = len(idx)
            for name in slabs:
                slabs[name][l, :k] = np.asarray(particles[name])[idx]
            alive[l, :k] = np.asarray(particles["alive"])[idx]
            valid[l, :k] = True
            pids[l, :k] = np.asarray(particles["pid"])[idx]
        dev = self.device

        def put(a, dt):
            return torch.as_tensor(a.reshape(-1), dtype=dt).to(dev)

        state = ShardedState(
            **{k: put(v, dt) for k, v in slabs.items()},
            alive=put(alive, torch.bool), valid=put(valid, torch.bool),
            pid=put(pids, torch.int32),
            collisions=torch.tensor(int(collisions), dtype=torch.int64,
                                    device=dev),
            panics=torch.tensor(int(panics), dtype=torch.int32, device=dev),
            overflow=torch.zeros((), dtype=torch.int32, device=dev))
        return self._presort(state)

    def _presort(self, state: ShardedState) -> ShardedState:
        """Each slab sorted by (cell key, pid), its empty slots last."""
        L = len(self.mesh.local_shards)
        x, y, vx, vy, m, alive, valid, pid = (a.view(L, -1)
                                              for a in state[:8])
        key, _ = _slab_key(x, y, valid, self.config.side, self.config.ncside)
        _, pid, x, y, vx, vy, m, alive, valid = sort_slabs(
            key, pid, x, y, vx, vy, m, alive, valid)
        return state._replace(**{k: a.reshape(-1) for k, a in (
            ("x", x), ("y", y), ("vx", vx), ("vy", vy), ("m", m),
            ("alive", alive), ("valid", valid), ("pid", pid))})

    def _grow_state(self, state: ShardedState, new_cap: int) -> ShardedState:
        """The slabs at a larger capacity: empty slots appended at each
        shard's tail (sentinel key, pid INT32_MAX), so each stays sorted."""
        L = len(self.mesh.local_shards)
        old_cap = state.x.shape[0] // L
        if old_cap >= new_cap:
            return state

        def grow(a, fill):
            tail = torch.full((L, new_cap - old_cap), fill, dtype=a.dtype,
                              device=a.device)
            return torch.cat([a.view(L, old_cap), tail], dim=1).reshape(-1)

        return state._replace(
            **{k: grow(getattr(state, k), 0)
               for k in ("x", "y", "vx", "vy", "m")},
            alive=grow(state.alive, False), valid=grow(state.valid, False),
            pid=grow(state.pid, INT32_MAX))

    def result(self, state: ShardedState) -> tuple[float, float, int]:
        """Particle 0's position (the smallest valid pid over the mesh; a
        shard may hold none) and the collision count."""
        L = len(self.mesh.local_shards)
        pid = torch.where(state.valid, state.pid, INT32_MAX).view(L, -1)
        slot = torch.argmin(pid, dim=1, keepdim=True)
        pids, xs, ys = (self.mesh.all_gather(torch.gather(a.view(L, -1), 1,
                                                          slot))[:, 0]
                        for a in (pid, state.x, state.y))
        i = int(torch.argmin(pids))
        return float(xs[i]), float(ys[i]), int(state.collisions)

    def gather(self, state: ShardedState) -> dict:
        """The mesh's valid particles in pid order, as NumPy arrays, on
        every rank (the reference's Gatherv)."""
        L = len(self.mesh.local_shards)
        slabs = {name: self.mesh.all_gather(getattr(state, name).view(L, -1))
                 .reshape(-1).cpu().numpy()
                 for name in ("x", "y", "vx", "vy", "m", "alive", "valid",
                              "pid")}
        valid = slabs.pop("valid")
        pid = slabs["pid"][valid]
        order = np.argsort(pid)
        return {name: a[valid][order] for name, a in slabs.items()}


class ShardedEngine(SlabMesh):
    """Mesh engine with the single-device engine's interface.

    Implementations (``impl``):

    * ``sweep`` — sorted per-shard slabs on row blocks, the neighbour-offset
      sweep. The f64 parity path (bitwise equal to the single-device parity
      engine) and the ladder's last rung;
    * ``resident`` — per-shard slot tiles on row blocks with halo rows and
      the fused pair kernel (``parallel/sharded_resident``);
    * ``supercell`` — super-cell tiles on blocks of super-rows with the
      labelled pair kernel (``parallel/sharded_supercell``);
    * ``banded`` (or ``banded-cols``) — every row band over each shard's
      column range (``parallel/sharded_banded_cols``);
    * ``banded-cyclic`` — a contiguous chunk of every band's rows a shard,
      the chunks in ring order (``parallel/sharded_banded``, JAX's
      block-cyclic variant; ``banded_variant`` "cyclic").

    ``device`` defaults to ``cuda`` and raises without CUDA; the CPU only
    when the caller passes ``device="cpu"``. The mesh is a ``LocalMesh`` of
    ``config.n_shards`` shards on that device, or ``mesh`` (the JAX
    engine's ``devices=``): a ``DistMesh`` of ``config.n_shards`` ranks,
    whose device it takes, holding this rank's slab alone. Every route runs
    on either mesh with the same bits: every rank reaches the same route,
    plan and capacities from the same host data (the seed's init, a
    checkpoint, a gathered state) without a broadcast, and the ladder's
    one readback is the mesh's maximum. ``impl`` None lets the JAX
    mesh census route (fast precision): sparse loads to super-cells where
    ``supercell_shard_viable``, clustered loads with a band plan and uniform
    loads above ``engine._STREAM_BYTES`` of tiles a shard to bands, the rest
    to resident tiles; the census never picks ``banded-cyclic``, as in JAX.
    ``init_state`` plans census-weighted row boundaries for the row-block
    impls unless ``config.row_starts`` fixes them. A ``config.mesh_shape``
    is dropped: this engine is the 1D row split.

    Overflow replays the run losslessly: a slab out of slots grows the
    slab, the sweep's migration buffers grow, tiles grow (a band plan by
    ``grow_plan``), emigrants left in transit get more ship rounds, and
    where growth does not converge or passes the kernels' K, the run
    escalates to the sweep (re-packed by row block where the tiles owned
    cells otherwise).
    """

    def __init__(self, config: SimConfig, impl: str | None = None,
                 kcap: int | None = None, device=None, mesh=None):
        if config.mesh_shape:
            config = dataclasses.replace(config, mesh_shape=())
        parity = config.precision is Precision.PARITY
        if parity:
            impl = None  # parity always runs the sweep, as in JAX
        if impl is not None and impl not in IMPLS:
            raise ValueError(f"unknown sharded impl {impl!r}; valid: {IMPLS}")
        if mesh is not None and mesh.size != config.n_shards:
            raise ValueError(f"a mesh of {mesh.size} shards for n_shards="
                             f"{config.n_shards}")
        device = torch.device(mesh.device if mesh is not None
                              else device or "cuda")
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run on the CPU")
        self.config = config
        self.mesh = mesh or LocalMesh(config.n_shards, device)
        self.device = device
        self.dtype = torch.float64 if parity else torch.float32
        self._impl_auto = impl is None and not parity
        # JAX's banded decompositions: columns (its default) or block-cyclic
        # rows, by impl name (JAX's PSIM_BANDED_SHARD).
        self.banded_variant = "cols"
        self._band_plan = None  # [(row0, rows, kcap), ...] of banded
        self._sc_factor = None  # super-cell S of supercell
        if impl in ("banded-cols", "banded-cyclic"):
            self.banded_variant = impl.split("-", 1)[1]
            impl = "banded"
        self.impl = "sweep" if parity else (impl or "resident")
        # (Imported here: the tile meshes import this module.)
        from particlesimulation_tpu_torch.parallel.sharded_supercell import (
            supercell_shard_viable)
        if self._impl_auto and config.n_particles / config.ncells < 1.5:
            s = choose_supercell_factor(config)
            if supercell_shard_viable(config, s):
                self.impl, self._sc_factor = "supercell", s
        elif self.impl == "supercell":
            # Asked for: the chooser's S, else the largest divisor factor
            # that keeps a super-row a shard; none declines to resident.
            s = choose_supercell_factor(config)
            if s is not None and not supercell_shard_viable(config, s):
                s = next((f for f in range(s, 1, -1)
                          if supercell_shard_viable(config, f)), None)
            if supercell_shard_viable(config, s):
                self._sc_factor = s
            else:
                self.impl = "resident"
        self.kcap = kcap
        self.capacity = config.shard_capacity or None  # set at pack time
        self.bcap = config.migration_capacity or None
        self.ship_rounds = 1
        self._built_key = None
        self._run = None

    def _build(self):
        cfg = self.config
        cap = self.capacity or cfg.resolved_shard_capacity()
        self.capacity = cap
        if self.impl in ("resident", "supercell") and self.kcap is None:
            # Snug Poisson-tail bound; overflow retries are lossless.
            nsc = cfg.ncside // (self._sc_factor or 1)
            avg = max(1.0, cfg.n_particles / (nsc * nsc))
            self.kcap = binning.round_cap(avg + 4.5 * avg ** 0.5 + 8)
        if self.impl == "banded":
            if self._band_plan is None:
                # No census: one whole-grid band at the Poisson bound.
                avg = max(1.0, cfg.n_particles / cfg.ncells)
                k = self.kcap or binning.round_cap(avg + 4.5 * avg ** 0.5
                                                   + 8)
                self._band_plan = ((0, cfg.ncside, k),)
            # A band wider than the cap (a plan given by the caller) runs at
            # the cap; a cell too full for it overflows to the ladder.
            self._band_plan = tuple(
                (r0, rw, min(k, single.MAX_XLA_KCAP))
                for r0, rw, k in self._band_plan)
            self.kcap = max(k for _, _, k in self._band_plan)  # telemetry
        if self.bcap is None:
            self.bcap = max(64, cap // 2)
        key = (self.impl, cap, self.bcap, self.kcap, self.ship_rounds,
               self._band_plan, self.banded_variant, self._sc_factor,
               cfg.row_starts)
        if self._built_key == key:
            return
        graphed.release(self._run)
        # (Imported here: the tile meshes import this module.)
        if self.impl == "resident":
            from particlesimulation_tpu_torch.parallel import (
                sharded_resident)
            _, _, self._run = sharded_resident.make_sharded_resident_run(
                cfg, self.mesh, self.kcap, cap, self.ship_rounds)
        elif self.impl == "supercell":
            from particlesimulation_tpu_torch.parallel import (
                sharded_supercell)
            _, _, self._run = sharded_supercell.make_sharded_supercell_run(
                cfg, self.mesh, self.kcap, cap, self._sc_factor,
                self.ship_rounds)
        elif self.impl == "banded" and self.banded_variant == "cyclic":
            from particlesimulation_tpu_torch.parallel import sharded_banded
            _, _, self._run = sharded_banded.make_sharded_banded_run(
                cfg, self.mesh, self._band_plan, cap, self.ship_rounds)
        elif self.impl == "banded":
            from particlesimulation_tpu_torch.parallel import (
                sharded_banded_cols)
            _, _, self._run = (
                sharded_banded_cols.make_sharded_banded_cols_run(
                    cfg, self.mesh, self._band_plan, cap, self.ship_rounds))
        else:
            _, self._run = make_sharded_step(cfg, self.mesh, cap, self.bcap)
        self._built_key = key

    def _census_route(self, hist) -> None:
        """The JAX mesh census on the occupancy histogram (auto impl only,
        once, while the census route is resident): a clustered load with a
        band plan goes to the column-sharded bands on the one-device plan
        (unquantized, at JAX's K cap); a uniform one whose tile state a
        shard exceeds ``engine._STREAM_BYTES`` to equal streaming bands."""
        if not self._impl_auto or self.impl != "resident":
            self._impl_auto = False
            return
        self._impl_auto = False
        cfg = self.config
        hist = np.asarray(hist)
        tplan = plan_tiers(hist, cfg.ncells, single.MAX_XLA_KCAP)
        if single._clustered(tplan):
            bands = plan_bands(hist, cfg.ncside, single.MAX_XLA_KCAP)
            if bands is not None:
                self.impl = "banded"
                self._band_plan = tuple(tuple(p) for p in bands)
                return
        occ = int(hist.max()) if hist.size else 1
        kcap_est = binning.round_cap(occ * 1.1 + 4)
        d = cfg.n_shards
        row_bytes = max(1, (cfg.ncside // d) * kcap_est * 25)
        band_rows = max(1, single._STREAM_BAND_BYTES // row_bytes)
        if (cfg.ncells * kcap_est * 25 // d > single._STREAM_BYTES
                and -(-cfg.ncside // band_rows) >= 2):
            self.impl = "banded"
            self._band_plan = uniform_band_plan(cfg.ncside, band_rows,
                                                kcap_est)

    def init_state(self, host=None) -> ShardedState:
        """Host init, then scatter by owner into per-shard slabs (the
        reference initializes on rank 0 and distributes by ownership,
        mpi/parsim-mpi.cpp:344-349,406-465). ``host``: the initializer's
        (x, y, vx, vy, m) arrays, where a caller (the 2D mesh's census
        delegation) already made them."""
        cfg = self.config
        xs, ys, vxs, vys, ms = (host if host is not None
                                else init_particles_host(cfg))
        w = cfg.side / cfg.ncside
        cx = np.clip((xs / w).astype(np.int64), 0, cfg.ncside - 1)
        cy = np.clip((ys / w).astype(np.int64), 0, cfg.ncside - 1)
        # Route before balance planning, as JAX does: the band and
        # super-cell impls own cells by their own rules.
        self._census_route(np.bincount(cy * cfg.ncside + cx,
                                       minlength=cfg.ncells))
        if (not cfg.row_starts and cfg.n_shards > 1
                and self.impl in ("resident", "sweep")):
            starts = plan_shard_rows(np.bincount(cy, minlength=cfg.ncside),
                                     cfg.n_shards)
            if starts is not None:
                self.config = dataclasses.replace(cfg, row_starts=starts)
        n = cfg.n_particles
        return self.pack_particles({
            "x": xs, "y": ys, "vx": vxs, "vy": vys, "m": ms,
            "alive": np.ones(n, dtype=bool),
            "pid": np.arange(n, dtype=np.int32)})

    def ownership_plan(self) -> tuple:
        """The slab ownership of this engine's impl, as the JAX package's
        checkpoints record it (``band_plan``): ``((-2, S, -2),)`` for
        super-cells (super-row blocks, a function of S and the shard count),
        ``((-1, -1, -1),)`` for column bands (any plan: the column split
        depends on the shard count alone), the band plan itself for
        block-cyclic bands (its rows give each shard's chunks), ``()`` for
        row blocks.
        ``utils/checkpointing.restore_sharded`` places a checkpoint's slabs
        as saved only where its ownership is the engine's."""
        if self.impl == "supercell":
            return ((-2, int(self._sc_factor), -2),)
        if self.impl == "banded" and self.banded_variant == "cyclic":
            return tuple(tuple(int(v) for v in p)
                         for p in self._band_plan or ())
        if self.impl == "banded":
            return ((-1, -1, -1),)
        return ()

    def _owners(self, cx, cy, in_range):
        """Owning shard of each particle (NumPy) by the impl's rule: column
        blocks, block-cyclic band chunks, super-row blocks or row blocks;
        out-of-range ones to shard 0."""
        cfg = self.config
        d = cfg.n_shards
        row = np.clip(cy, 0, cfg.ncside - 1)
        if self.impl == "banded" and self.banded_variant == "cyclic":
            from particlesimulation_tpu_torch.parallel.sharded_banded import (
                cyclic_owner_of_rows)
            shard = cyclic_owner_of_rows(self._band_plan, d, row)
        elif self.impl == "banded":
            from particlesimulation_tpu_torch.parallel.sharded_banded_cols \
                import col_owner
            shard = col_owner(cfg.ncside, d, np.clip(cx, 0, cfg.ncside - 1))
        elif self.impl == "supercell":
            from particlesimulation_tpu_torch.parallel.sharded_supercell \
                import sc_row_starts
            nsc = cfg.ncside // self._sc_factor
            starts = np.asarray(sc_row_starts(nsc, d))
            shard = np.searchsorted(starts, np.clip(row // self._sc_factor,
                                                    0, nsc - 1),
                                    side="right") - 1
        else:
            shard = cfg.shard_of_row(row)
        return np.where(in_range, shard, 0)

    def pack_particles(self, particles, collisions=0, panics=0,
                       dtype=None) -> ShardedState:
        """Scatter host particle arrays by owner into slabs, each sorted by
        (cell key, pid). ``particles`` maps x/y/vx/vy/m/alive/pid to
        equal-length arrays. Also the checkpoint path where the geometry or
        the ownership changed (``utils/checkpointing.restore_sharded``), and
        the ladder's re-pack."""
        cfg = self.config
        d = cfg.n_shards
        dt = dtype or self.dtype
        # Cells in the precision the run bins in (``binning.cell_keys``): a
        # particle near a shard boundary must land where the prologue looks.
        npdt = torch.empty((), dtype=dt).numpy().dtype
        xs, ys = (np.asarray(particles[k]).astype(npdt) for k in ("x", "y"))
        w = npdt.type(cfg.side / cfg.ncside)
        cx = (xs / w).astype(np.int32)
        cy = (ys / w).astype(np.int32)
        in_range = ((cx >= 0) & (cx < cfg.ncside) &
                    (cy >= 0) & (cy < cfg.ncside))
        row = np.clip(cy, 0, cfg.ncside - 1)
        col = np.clip(cx, 0, cfg.ncside - 1)
        hist = np.bincount((row * cfg.ncside + col)[in_range],
                           minlength=cfg.ncells)
        self._census_route(hist)
        if self.impl == "banded" and self._band_plan is None:
            # Asked for: this census's one-device plan (for columns) or
            # shard-divisible one (block-cyclic); a uniform load (no plan)
            # runs resident tiles, as in JAX.
            cap = single.MAX_XLA_KCAP
            bands = (plan_bands_cyclic(hist, cfg.ncside, d, cap)
                     if self.banded_variant == "cyclic"
                     else plan_bands(hist, cfg.ncside, cap))
            if bands is None:
                self.impl = "resident"
            else:
                self._band_plan = tuple(tuple(p) for p in bands)
        shard = self._owners(cx, cy, in_range)
        counts = np.bincount(shard, minlength=d)
        if self.impl in ("resident", "supercell") and self.kcap is None:
            # Occupancy-informed tile capacity; pair-pass cost scales with
            # kcap², and overflow retries are lossless.
            s = self._sc_factor or 1
            nsc = cfg.ncside // s
            occ = np.bincount((row // s) * nsc + col // s,
                              minlength=nsc * nsc).max()
            self.kcap = binning.round_cap(occ * 1.1 + 4)
        if self.capacity is None:
            # Slabs sized from the occupancy with migration slack.
            self.capacity = max(int(counts.max() * 1.5) + 16,
                                cfg.resolved_shard_capacity())
        if int(counts.max()) > self.capacity:
            self.capacity = binning.round_cap(counts.max() * 1.5 + 16)
        return self._scatter(particles, shard, self.capacity, collisions,
                             panics, dt)

    def _to_sweep(self, state: ShardedState) -> ShardedState:
        """The ladder's last rung: the sweep, on row blocks. A state whose
        tiles owned cells by another rule is re-packed."""
        owned_by_rows = self.impl == "resident"
        self.impl = "sweep"
        if owned_by_rows:
            return state
        return self.pack_particles(self.gather(state),
                                   collisions=int(state.collisions),
                                   panics=int(state.panics),
                                   dtype=state.x.dtype)

    def run(self, state: ShardedState, n_steps: int) -> ShardedState:
        """Run ``n_steps``; overflow replays the run from the input state
        with more capacity (nothing is dropped; the reference instead
        PANIC-skips or dies). The adapted impl and capacities stick for
        later runs of this engine. The run replays its step graphs on the
        GPU (``ops/graphed``); a run of 0 steps captures them. A mesh whose
        collectives cannot be captured (``capturable`` False: gloo on a
        CUDA device) raises: use ``run_eager``."""
        check_capturable(self.mesh)
        return self._ladder(state, n_steps, eager=False)

    def run_eager(self, state: ShardedState, n_steps: int) -> ShardedState:
        """``run`` with each run's plain loop, every kernel of every step
        dispatched from Python: the same bits as ``run``."""
        return self._ladder(state, n_steps, eager=True)

    def _ladder(self, state: ShardedState, n_steps: int, eager: bool):
        d = self.config.n_shards
        for attempt in range(8):
            if self.capacity is not None:
                state = self._grow_state(state, self.capacity)
            if (self.impl in ("resident", "supercell")
                    and (self.kcap or 0) > single.MAX_XLA_KCAP):
                # Past the cap (JAX's MAX_XLA_KCAP, as every mesh engine of
                # JAX's), as one device's supercell -> sweep.
                state = self._to_sweep(state)
            self._build()
            run = self._run.eager if eager else self._run
            out = run(state._replace(
                overflow=torch.zeros_like(state.overflow)), n_steps)
            need = mesh_need(self.mesh, out)
            if need == 0:
                return out
            if need >= single.RANK_OVF:
                raise RuntimeError(
                    "collision rank overflow: a cell exceeded 65534 "
                    "occupants; uint32 pair ranks cannot order its "
                    "collision set")
            if need >= STRAY_OVF:
                raise RuntimeError(
                    "sharded slab invariant violation: a particle sits "
                    "outside its owner shard's rows (not capacity-fixable)")
            cap = self.capacity or self.config.resolved_shard_capacity()
            if need >= CAP_OVF:
                self.capacity = binning.round_cap(cap * 1.5 + need - CAP_OVF)
            elif need >= SHIP_OVF:
                # Emigrants still in transit: the JAX engine's round cap.
                if self.ship_rounds < d + SHIP_SLACK:
                    self.ship_rounds = d + SHIP_SLACK
                else:
                    state = self._to_sweep(state)
            elif self.impl == "sweep":
                # Emigrant buffer or landing-slot exhaustion.
                self.capacity = binning.round_cap(cap * 1.5 + need)
                self.bcap = binning.round_cap(self.bcap * 2 + need)
            elif self.impl == "banded":
                # Bands too narrow: grow them; where growth does not
                # converge or a band passes the cap, the sweep (JAX's rule).
                plan = tuple(tuple(p) for p in grow_plan(self._band_plan,
                                                         1.5))
                widest = max(k for _, _, k in plan)
                if attempt >= 2 or widest > single.MAX_XLA_KCAP:
                    state = self._to_sweep(state)
                self._band_plan = plan
            else:
                # Tile occupancy outgrew the tiles: larger tiles, then the
                # sweep.
                self.kcap = max(binning.round_cap(need * 1.25 + 1),
                                binning.round_cap(self.kcap * 1.5))
                if attempt >= 2 or self.kcap > single.MAX_XLA_KCAP:
                    state = self._to_sweep(state)
        raise RuntimeError("sharded capacity retries exhausted")
