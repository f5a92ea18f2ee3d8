"""Rectangle-sharded engine over a 2D (rows × cols) mesh (counterpart of
the JAX package's ``parallel/sharded2d.py``).

The reference decomposes the grid by rows only (mpi/parsim-mpi.cpp:330-465).
Here each shard owns a ``rows × cols`` rectangle of cells, block (r, c) of
the balanced-uneven split of each axis (``AxisDecomp``), and the shards of
a mesh of shape (d_r, d_c) talk along two axes:

* the COM halo is the two-phase exchange (``com_halo_layout``): the rows
  axis first, then the cols axis over the row-padded grids, so the corner
  cells ride the second phase; only monopole data crosses shards (the
  reference's ghost rule, mpi/parsim-mpi.cpp:670-815);
* migration routes dimension-ordered (rows first, then cols): emigrants
  ride a row ring buffer for d_r - 1 hops, landing where their column
  block matches too and moving to a column buffer where only their row
  block does, which then rides d_c - 1 hops along the cols axis.

The JAX engine gates each ring's hops on a ``psum`` of the pending
emigrants, a value the host would read each hop; its skipped hops forward
an all-invalid buffer, so the unconditional hops here give the same bits
with no readback (as ``parallel/sharded``'s D-1 hops do).

Each cell stays whole on one shard and in pid order, so the f64 run is
bitwise equal to the one-device parity engine (and to JAX's
``Sharded2DEngine``). The sweep is ``parallel/sharded.make_slab_sweep``,
the 1D mesh's, with the rectangles' batched cell keys, halo and migration.

The f32 fast precision runs rectangle tiles (``parallel/sharded2d_resident``)
by default, or, with no ``impl``, the JAX census's delegation: sparse
loads go to ``ShardedEngine``'s super-cell tiles, clustered loads and
uniform ones above ``engine._STREAM_BYTES`` of tiles a shard to its column
bands, each on the 1D mesh of the same shards (``mesh.flat()``: on a
``DistMesh`` the same ranks, shard ``s`` at rank ``s``). Unlike JAX, every
entry that reads or writes slabs (``pack_particles``,
``ownership_plan``, ``run``, ``result``, ``gather``, checkpoints through
``target``) goes to the delegate.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from particlesimulation_tpu_torch import engine as single
from particlesimulation_tpu_torch.config import Precision, SimConfig
from particlesimulation_tpu_torch.initializer import init_particles_host
from particlesimulation_tpu_torch.ops import binning, graphed
from particlesimulation_tpu_torch.ops.cuda import migrate as migrate_ops
from particlesimulation_tpu_torch.ops.cuda import stencil as stencil_ops
from particlesimulation_tpu_torch.parallel.mesh import LocalMesh
from particlesimulation_tpu_torch.parallel.sharded import (
    CAP_OVF, SHIP_OVF, SHIP_SLACK, STRAY_OVF, ShardedEngine, SlabMesh,
    _slab_key, check_capturable, make_slab_sweep, mesh_need,
    own_fields)
from particlesimulation_tpu_torch.state import ShardedState

IMPLS = ("resident", "sweep")


class AxisDecomp:
    """Balanced-uneven contiguous blocks of one grid axis: the first ``rem``
    blocks own ``base + 1`` lines, the rest ``base`` (the 1D mesh's rule;
    the reference gives the last rank the whole remainder,
    mpi/parsim-mpi.cpp:338-342)."""

    def __init__(self, size: int, nblocks: int):
        if nblocks < 1 or nblocks > size:
            raise ValueError(
                f"need 1 <= nblocks ({nblocks}) <= axis size ({size})")
        self.size = size
        self.nblocks = nblocks
        self.base, self.rem = divmod(size, nblocks)
        self.max_blocks = self.base + (1 if self.rem else 0)

    def first_of(self, s: int) -> int:
        """First line of block ``s``."""
        return s * self.base + min(s, self.rem)

    def count_of(self, s: int) -> int:
        """Lines of block ``s``."""
        return self.base + (1 if s < self.rem else 0)

    def owner_of(self, v):
        """Owning block of each line ``v`` (NumPy)."""
        v = np.asarray(v)
        split = self.rem * (self.base + 1)
        return np.where(v < split, v // (self.base + 1),
                        self.rem + (v - split) // max(1, self.base))


def rect_geometry(mesh, dec_r: AxisDecomp, dec_c: AxisDecomp):
    """(row0, rows_mine, col0, cols_mine) of the mesh's local shards, (L,)
    int64 tensors each (the JAX program's two ``axis_index`` calls)."""
    mer, mec = (c.tolist() for c in mesh.coords)

    def t(vals):
        return torch.tensor(vals, device=mesh.device)

    return (t([dec_r.first_of(r) for r in mer]),
            t([dec_r.count_of(r) for r in mer]),
            t([dec_c.first_of(c) for c in mec]),
            t([dec_c.count_of(c) for c in mec]))


def com_halo_layout(dec_r: AxisDecomp, dec_c: AxisDecomp, row0, rows_mine,
                    col0, cols_mine, aligned=None):
    """The two-phase COM halo over the (rows, cols) mesh
    (``ops/cuda/stencil.HaloLayout``): the rows phase sends each shard's
    last and first owned rows along the rows axis, then the cols phase the
    row-padded blocks' columns along the cols axis, so the corner cells
    ride along (the torus form of the reference's ghost exchange,
    mpi/parsim-mpi.cpp:670-815); an axis of extent 1 wraps onto itself.
    Mirrors from global coordinates, the 2D form's predicate."""
    return stencil_ops.HaloLayout(
        (dec_r.max_blocks,), dec_c.max_blocks, row0=(row0,),
        rows_mine=(rows_mine,), col0=col0, cols_mine=cols_mine, y_ge=False,
        aligned=aligned, cols_axis="cols")


def make_sharded2d_step(config: SimConfig, mesh, dec_r: AxisDecomp,
                        dec_c: AxisDecomp, cap: int, bcap: int):
    """Build (step, run) of the sweep over the rectangles' slabs of ``cap``
    slots (``sharded.make_slab_sweep``), with row and column emigrant
    buffers of ``bcap`` entries each."""
    side = config.side
    nc = config.ncside
    ncells = config.ncells
    d_r, d_c = mesh.shape
    cols_max = dec_c.max_blocks
    L = len(mesh.local_shards)
    row0, rows_mine, col0, cols_mine = rect_geometry(mesh, dec_r, dec_c)
    mer, mec = (c[:, None] for c in mesh.coords)
    owner_r, owner_c = (torch.as_tensor(dec.owner_of(np.arange(nc)),
                                        dtype=torch.int64, device=mesh.device)
                        for dec in (dec_r, dec_c))

    def rc(key, real):
        gy = torch.where(real, key // nc, 0)
        return gy, torch.where(real, key - gy * nc, 0)

    def local_cell(key, real):
        """The rectangle's cell, row-major: a sorted slab's global keys map
        onto it monotonically."""
        gy, gx = rc(key, real)
        return (gy - row0[:, None]) * cols_max + (gx - col0[:, None])

    layout = com_halo_layout(dec_r, dec_c, row0, rows_mine, col0, cols_mine)

    def tables(M, MX, MY):
        grids = [tuple(a.view(L, dec_r.max_blocks, cols_max)
                       for a in (M, MX, MY))]
        return stencil_ops.mesh_tables(mesh, layout, grids, side, nc)

    def land(slab, valid, buf, cbuf):
        """Buffer entries whose row block is this shard's: direct hits land
        in the slab, the rest go to the column buffer."""
        landed = buf["valid"] & (buf["dest_r"] == mer)
        direct = landed & (buf["dest_c"] == mec)
        slab, valid, o1 = migrate_ops.pack(slab, valid, buf, direct)
        cfields = {k: v for k, v in cbuf.items() if k != "valid"}
        cfields, cvalid, o2 = migrate_ops.pack(cfields, cbuf["valid"], buf,
                                               landed & ~direct)
        buf = {**buf, "valid": buf["valid"] & ~landed}
        return slab, valid, buf, {**cfields, "valid": cvalid}, o1 + o2

    def migrate(slab, valid):
        """Dimension-ordered: d_r - 1 row hops, then d_c - 1 column hops."""
        key2, _ = _slab_key(slab["x"], slab["y"], valid, side, nc)
        real2 = valid & (key2 < ncells)
        gy, gx = rc(key2, real2)
        dest_r = torch.where(real2, owner_r[gy], mer)
        dest_c = torch.where(real2, owner_c[gx], mec)
        emig = valid & ((dest_r != mer) | (dest_c != mec))
        buf, overflow = migrate_ops.compact(slab, emig, bcap, dest_r=dest_r,
                                            dest_c=dest_c)
        valid = valid & ~emig
        slab = own_fields(slab)
        cbuf = {k: torch.zeros_like(v) for k, v in buf.items()}
        # Emigrants already on their row block go to the column buffer
        # with no row hop.
        slab, valid, buf, cbuf, ovf = land(slab, valid, buf, cbuf)
        overflow = overflow + ovf
        for _ in range(d_r - 1):
            buf = mesh.ppermute(buf, 1, "rows")
            slab, valid, buf, cbuf, ovf = land(slab, valid, buf, cbuf)
            overflow = overflow + ovf
        for _ in range(d_c - 1):
            cbuf = mesh.ppermute(cbuf, 1, "cols")
            arr = cbuf["valid"] & (cbuf["dest_c"] == mec)
            slab, valid, ovf = migrate_ops.pack(slab, valid, cbuf, arr)
            overflow = overflow + ovf
            cbuf["valid"] = cbuf["valid"] & ~arr
        return slab, valid, overflow

    return make_slab_sweep(config, mesh, dec_r.max_blocks * cols_max,
                           local_cell, tables, migrate)


class Sharded2DEngine(SlabMesh):
    """Rectangle-mesh engine with the 1D mesh engine's interface.

    ``config.mesh_shape`` = (d_r, d_c) lays ``config.n_shards`` shards out
    as a ``LocalMesh`` of that shape on ``device`` (``cuda`` by default,
    raising without CUDA; the CPU only when the caller passes
    ``device="cpu"``), or on ``mesh`` (the JAX engine's ``devices=``): a
    mesh of that shape, a ``DistMesh`` holding this rank's shard alone,
    whose device it takes; shard (r, c) owns the cells [row block r] ×
    [col block c]. Implementations (``impl``):

    * ``sweep`` — sorted slabs and the neighbour-offset sweep: the f64
      parity path (bitwise the one-device parity engine) and the ladder's
      last rung;
    * ``resident`` — rectangle tiles with a halo ring, the fused pair kernel
      and dimension-ordered halo shipping (``parallel/sharded2d_resident``):
      fast precision's default.

    ``impl`` None (fast precision) runs JAX's census at the first
    ``pack_particles`` (``init_state``'s, or a checkpoint's re-pack):
    sparse, clustered and streaming loads delegate to a ``ShardedEngine``
    on ``mesh.flat()``, the 1D mesh of the same shards, the rest stay on
    resident tiles; where ``n_shards > ncside`` nothing delegates. Every
    rank of a ``DistMesh`` routes alike, from the same host data. A fresh
    ``init_state`` routes again.

    Overflow replays the run losslessly: CAP_OVF grows the slab, the
    sweep's migration overflow its slab and buffers, SHIP_OVF the ship
    rounds, tile occupancy kcap; growth that does not converge, or a kcap
    past the kernels' K, goes to the sweep (the same rectangles, no
    re-pack). STRAY_OVF raises.
    """

    def __init__(self, config: SimConfig, impl: str | None = None,
                 kcap: int | None = None, device=None, mesh=None):
        if not config.mesh_shape:
            raise ValueError("Sharded2DEngine needs config.mesh_shape "
                             "(d_rows, d_cols)")
        if mesh is not None:
            if tuple(mesh.shape) != tuple(config.mesh_shape):
                raise ValueError(f"a mesh of shape {mesh.shape} for "
                                 f"mesh_shape={config.mesh_shape}")
            device = mesh.device
        parity = config.precision is Precision.PARITY
        if parity:
            impl = None  # parity always runs the sweep, as in JAX
        if impl is not None and impl not in IMPLS:
            raise ValueError(f"unknown sharded2d impl {impl!r}; valid: "
                             f"{IMPLS}")
        device = torch.device(device or "cuda")
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run on the CPU")
        self.config = config
        self.device = device
        d_r, d_c = config.mesh_shape
        self.dec_r = AxisDecomp(config.ncside, d_r)
        self.dec_c = AxisDecomp(config.ncside, d_c)
        self.mesh = mesh or LocalMesh(config.n_shards, device, (d_r, d_c))
        self.dtype = torch.float64 if parity else torch.float32
        self._auto = impl is None and not parity
        self._routed = False
        self._delegate = None  # the 1D ShardedEngine the census chose
        self._impl = "sweep" if parity else (impl or "resident")
        self.kcap = kcap
        self.capacity = config.shard_capacity or None  # set at pack time
        self.bcap = config.migration_capacity or None
        self.ship_rounds = 1
        self._built_key = None
        self._run = None

    @property
    def impl(self) -> str:
        """The route: this engine's impl, or its delegate's."""
        return self._delegate.impl if self._delegate else self._impl

    def target(self, particles=None):
        """The engine that holds this engine's slabs: its delegate, or
        itself. A census not yet run runs on ``particles`` (a dict with
        "x" and "y"), where given."""
        if self._auto and not self._routed and particles is not None:
            self._route(particles)
        return self._delegate or self

    def _route(self, particles) -> None:
        """JAX's census delegation (``Sharded2DEngine._route_1d``): a 1D
        mesh of the same shard count runs sparse loads on super-cells, and
        clustered and streaming ones on column bands; the rest stay here."""
        self._routed = True
        cfg = self.config
        if cfg.n_shards > cfg.ncside:
            # The row split needs a grid row a shard, the rectangles not.
            return
        cand = ShardedEngine(dataclasses.replace(cfg, mesh_shape=()),
                             mesh=self.mesh.flat())
        if cand.impl == "supercell":
            self._delegate = cand
            return
        w = cfg.side / cfg.ncside
        cx, cy = (np.clip((np.asarray(particles[k]) / w).astype(np.int64), 0,
                          cfg.ncside - 1) for k in ("x", "y"))
        cand._census_route(np.bincount(cy * cfg.ncside + cx,
                                       minlength=cfg.ncells))
        if cand.impl != "resident":
            self._delegate = cand

    def init_state(self) -> ShardedState:
        """Host init, then scatter by owner rectangle into per-shard slabs
        (the reference's rank-0 init and distribution,
        mpi/parsim-mpi.cpp:344-349,406-465); with no impl, the census
        routes first, on this init."""
        cfg = self.config
        host = init_particles_host(cfg)
        self._routed, self._delegate = False, None
        n = cfg.n_particles
        particles = dict(zip(("x", "y", "vx", "vy", "m"), host),
                         alive=np.ones(n, dtype=bool),
                         pid=np.arange(n, dtype=np.int32))
        eng = self.target(particles)
        if eng is not self:
            return eng.init_state(host=host)
        return self.pack_particles(particles)

    def ownership_plan(self) -> tuple:
        """The checkpoint ownership sentinel (``ShardedEngine``'s):
        rectangles are ``()``, with ``config.mesh_shape``; a delegate's
        own."""
        return self._delegate.ownership_plan() if self._delegate else ()

    def pack_particles(self, particles, collisions=0, panics=0,
                       dtype=None) -> ShardedState:
        """Scatter host particle arrays by owner rectangle into slabs, each
        sorted by (cell key, pid) (or the delegate's packing). Also the
        checkpoint re-pack."""
        eng = self.target(particles)
        if eng is not self:
            return eng.pack_particles(particles, collisions, panics, dtype)
        cfg = self.config
        d_c = self.dec_c.nblocks
        dt = dtype or self.dtype
        # Cells in the precision the run bins in (``binning.cell_keys``), on
        # both axes: a particle near a block boundary must land where the
        # prologue looks.
        npdt = torch.empty((), dtype=dt).numpy().dtype
        xs, ys = (np.asarray(particles[k]).astype(npdt) for k in ("x", "y"))
        w = npdt.type(cfg.side / cfg.ncside)
        cx = (xs / w).astype(np.int32)
        cy = (ys / w).astype(np.int32)
        in_range = ((cx >= 0) & (cx < cfg.ncside) &
                    (cy >= 0) & (cy < cfg.ncside))
        row = np.clip(cy, 0, cfg.ncside - 1)
        col = np.clip(cx, 0, cfg.ncside - 1)
        shard = np.where(in_range, self.dec_r.owner_of(row) * d_c
                         + self.dec_c.owner_of(col), 0)
        counts = np.bincount(shard, minlength=cfg.n_shards)
        if self._impl == "resident" and self.kcap is None:
            # Occupancy-informed tile capacity; overflow retries are
            # lossless.
            occ = np.bincount(row * cfg.ncside + col,
                              minlength=cfg.ncells).max()
            self.kcap = binning.round_cap(occ * 1.1 + 4)
        if self.capacity is None:
            self.capacity = max(int(counts.max() * 1.5) + 16,
                                cfg.resolved_shard_capacity())
        if int(counts.max()) > self.capacity:
            self.capacity = binning.round_cap(counts.max() * 1.5 + 16)
        return self._scatter(particles, shard, self.capacity, collisions,
                             panics, dt)

    def _build(self):
        cfg = self.config
        cap = self.capacity or cfg.resolved_shard_capacity()
        self.capacity = cap
        if self._impl == "resident" and self.kcap is None:
            # Snug Poisson-tail bound; overflow retries are lossless.
            avg = max(1.0, cfg.n_particles / cfg.ncells)
            self.kcap = binning.round_cap(avg + 4.5 * avg ** 0.5 + 8)
        if self.bcap is None:
            self.bcap = max(64, cap // 2)
        key = (self._impl, cap, self.bcap, self.kcap, self.ship_rounds)
        if self._built_key == key:
            return
        graphed.release(self._run)
        if self._impl == "resident":
            from particlesimulation_tpu_torch.parallel import (
                sharded2d_resident)
            _, _, self._run = sharded2d_resident.make_sharded2d_resident_run(
                cfg, self.mesh, self.dec_r, self.dec_c, self.kcap, cap,
                self.ship_rounds)
        else:
            _, self._run = make_sharded2d_step(cfg, self.mesh, self.dec_r,
                                               self.dec_c, cap, self.bcap)
        self._built_key = key

    def run(self, state: ShardedState, n_steps: int) -> ShardedState:
        """Run ``n_steps``; overflow replays the run from the input state
        with more capacity (nothing is dropped). The adapted impl and
        capacities stick for later runs. The run replays its step graphs
        on the GPU (``ops/graphed``); a run of 0 steps captures them. A
        mesh whose collectives cannot be captured raises: use
        ``run_eager``."""
        check_capturable(self.mesh)
        if self._delegate:
            return self._delegate.run(state, n_steps)
        return self._ladder(state, n_steps, eager=False)

    def run_eager(self, state: ShardedState, n_steps: int) -> ShardedState:
        """``run`` with each run's plain loop, every kernel of every step
        dispatched from Python: the same bits as ``run``."""
        if self._delegate:
            return self._delegate.run_eager(state, n_steps)
        return self._ladder(state, n_steps, eager=True)

    def _ladder(self, state: ShardedState, n_steps: int, eager: bool):
        d_r, d_c = self.mesh.shape
        for attempt in range(8):
            if self.capacity is not None:
                state = self._grow_state(state, self.capacity)
            if self._impl == "resident" and self.kcap > single.MAX_XLA_KCAP:
                self._impl = "sweep"
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
                    "sharded2d slab invariant violation: a particle sits "
                    "outside its owner shard's rectangle (not "
                    "capacity-fixable)")
            cap = self.capacity or self.config.resolved_shard_capacity()
            if need >= CAP_OVF:
                self.capacity = binning.round_cap(cap * 1.5 + need - CAP_OVF)
            elif need >= SHIP_OVF:
                # Emigrants still in transit: JAX's round cap, then the
                # sweep.
                if self.ship_rounds < d_r + d_c + SHIP_SLACK:
                    self.ship_rounds = d_r + d_c + SHIP_SLACK
                else:
                    self._impl = "sweep"
            elif self._impl == "sweep":
                # Emigrant buffer or landing-slot exhaustion.
                self.capacity = binning.round_cap(cap * 1.5 + need)
                self.bcap = binning.round_cap(self.bcap * 2 + need)
            else:
                # Tile occupancy outgrew the tiles: larger tiles, then the
                # sweep (the same rectangles: no re-pack).
                self.kcap = max(binning.round_cap(need * 1.25 + 1),
                                binning.round_cap(self.kcap * 1.5))
                if attempt >= 2:
                    self._impl = "sweep"
        raise RuntimeError("sharded2d capacity retries exhausted")

    def result(self, state: ShardedState) -> tuple[float, float, int]:
        return SlabMesh.result(self._delegate or self, state)

    def gather(self, state: ShardedState) -> dict:
        return SlabMesh.gather(self._delegate or self, state)

