"""State checkpoint/resume (counterpart of the JAX package's
``utils/checkpointing.py``, in the same ``.npz`` format).

The reference has none (state lives in memory for the whole run). States
serialize to ``.npz`` with the JAX package's field names and dtypes, so a
checkpoint written by either package loads in the other; the step is
deterministic, so a restored state continues bit for bit.

Both state families round-trip: the single-device ``SimState`` and the mesh
engine's ``ShardedState`` (the ``valid`` mask tells them apart). A sharded
checkpoint records its slab geometry (``n_shards``, ``row_starts``,
``mesh_shape``, and in ``band_plan`` the engine's ownership,
``ShardedEngine.ownership_plan()``): slab placement encodes cell ownership
(row blocks, rectangles of the 2D mesh, super-row blocks, column blocks or
block-cyclic band chunks), so a restore places the slabs as they are only
where the geometry and the ownership match, and otherwise re-packs the
particles through the engine's own packer. A 2D engine whose census handed
its loads to a 1D delegate saves and restores through that delegate
(``Sharded2DEngine.target``). On a ``DistMesh`` (one shard per rank)
every rank saves and restores: the file holds the slabs of every shard in
shard order, as a ``LocalMesh`` state of the same shape holds them, written
by rank 0; each rank restores its own shard's slab, or re-packs its own
shard's particles.
"""

from __future__ import annotations

import numpy as np
import torch

from particlesimulation_tpu_torch.state import ShardedState, state_from_numpy

_FIELDS = ("x", "y", "vx", "vy", "m", "alive", "pid", "collisions", "panics",
           "overflow")
_SHARDED_FIELDS = _FIELDS + ("valid",)
# The fields a ShardedState holds a slab of per shard; the rest are the
# mesh's counters, the same on every shard.
_SLAB_FIELDS = ("x", "y", "vx", "vy", "m", "alive", "valid", "pid")


def _host(state, fields) -> dict:
    return {f: getattr(state, f).cpu().numpy() for f in fields}


def save_state(path: str, state) -> None:
    """Serialize a SimState or ShardedState (the latter without its slab
    geometry; see :func:`save_sharded_state`)."""
    fields = _SHARDED_FIELDS if isinstance(state, ShardedState) else _FIELDS
    np.savez_compressed(path, **_host(state, fields))


def _target(engine, particles=None):
    """The engine that holds ``engine``'s slabs: a 2D engine's delegate,
    where its census chose one (run on ``particles`` if not yet run)."""
    target = getattr(engine, "target", None)
    return target(particles) if target else engine


def save_sharded_state(path: str, state: ShardedState, n_shards: int = 0,
                       row_starts: tuple = (), mesh_shape: tuple = (),
                       band_plan: tuple = (), engine=None) -> None:
    """Serialize a ShardedState with its slab geometry: ``n_shards``, plus
    ``row_starts`` when the row boundaries are census-planned
    (``parallel/balance``), ``mesh_shape`` for a 2D mesh and, in
    ``band_plan``, the writing engine's ``ownership_plan()`` (empty for row
    blocks and rectangles; the JAX package's sentinels for super-cells and
    column bands, or a block-cyclic plan). ``engine``, where given, the
    writing engine, supplies all four (a 2D engine's delegate's where it
    has one) and its mesh's slabs: on a ``DistMesh`` every rank calls this,
    the slabs are all-gathered in shard order, rank 0 writes and every
    rank returns once the file is written."""
    mesh = None
    if engine is not None:
        eng = _target(engine)
        mesh = eng.mesh
        n_shards, row_starts, mesh_shape, band_plan = (
            eng.config.n_shards, eng.config.row_starts,
            eng.config.mesh_shape, eng.ownership_plan())
        L = len(mesh.local_shards)
        state = state._replace(**{
            f: mesh.all_gather(getattr(state, f).view(L, -1)).reshape(-1)
            for f in _SLAB_FIELDS})
    arrs = _host(state, _SHARDED_FIELDS)
    arrs["n_shards"] = np.asarray(n_shards, np.int32)
    arrs["row_starts"] = np.asarray(row_starts, np.int32)
    arrs["mesh_shape"] = np.asarray(mesh_shape, np.int32)
    arrs["band_plan"] = np.asarray(
        [list(p) for p in band_plan] if band_plan else np.zeros((0, 3)),
        np.int32)
    if mesh is None or mesh.rank == 0:
        np.savez_compressed(path, **arrs)
    if mesh is not None:
        mesh.barrier()


def load_state(path: str, dtype=None, device=None):
    """A SimState or ShardedState as saved, on ``device`` (default
    ``cuda``). Float fields keep their saved dtype unless ``dtype`` is
    given. A ShardedState comes back as saved, not placed for an engine:
    use :func:`restore_sharded` for that."""
    with np.load(path) as z:
        fields = {f: z[f] for f in z.files}
    dtype = dtype or torch.from_numpy(fields["x"][:0]).dtype
    return state_from_numpy(fields, torch.device(device or "cuda"), dtype)


def restore_sharded(path: str, engine, dtype=None) -> ShardedState:
    """Load a sharded checkpoint as a legal input of ``engine.run``.

    Where the checkpoint's geometry (shard count, slab capacity, row
    boundaries, mesh shape) and ownership (``band_plan`` against
    ``engine.ownership_plan()``) match the engine's, the slabs are placed as
    they are (a bit-exact resume); otherwise the valid particles are
    gathered and re-packed through ``engine.pack_particles``, as a
    checkpoint from another mesh width or shape, another row decomposition
    or another ownership rule must be. A 2D engine places them through its
    delegate, if its census (run on the checkpoint's particles if not yet
    run) chose one. On a ``DistMesh`` every rank calls this and takes its
    own shard's slab (or packs its own shard's particles).
    """
    with np.load(path) as z:
        saved = {f: z[f] for f in z.files}
    valid = saved["valid"]
    particles = {f: saved[f][valid] for f in ("x", "y", "vx", "vy", "m",
                                              "alive", "pid")}
    engine = _target(engine, particles)
    cfg = engine.config
    d = cfg.n_shards
    saved_shards = (int(saved["n_shards"]) if "n_shards" in saved
                    else None)
    saved_starts = tuple(int(r) for r in saved.get("row_starts", ()))
    saved_mesh = tuple(int(v) for v in saved.get("mesh_shape", ()))
    saved_plan = tuple(tuple(int(v) for v in p)
                       for p in saved.get("band_plan", ()))
    cap = engine.capacity or cfg.resolved_shard_capacity()
    dt = dtype or engine.dtype
    if (saved_shards == d and saved["x"].shape[0] == d * cap
            and saved_starts == tuple(cfg.row_starts)
            and saved_mesh == tuple(cfg.mesh_shape)
            and saved_plan == tuple(tuple(int(v) for v in p)
                                    for p in engine.ownership_plan())):
        mine = list(engine.mesh.local_shards)
        return state_from_numpy(
            {f: (saved[f].reshape(d, cap)[mine].reshape(-1)
                 if f in _SLAB_FIELDS else saved[f])
             for f in _SHARDED_FIELDS}, engine.device, dt)
    return engine.pack_particles(particles, collisions=saved["collisions"],
                                 panics=saved["panics"], dtype=dt)
