"""The meshes: D shards in one process (``LocalMesh``), or one shard per
rank of a ``torch.distributed`` process group (``DistMesh``).

The port's counterpart of the JAX package's ``jax.sharding.Mesh`` with
``shard_map`` over a "rows" axis, or over the (rows, cols) axes of its 2D
mesh. A shard program (``parallel/sharded``, ``parallel/sharded_resident``,
``parallel/sharded2d``) holds its shards' data with a leading shard axis, of
length ``len(local_shards)``, and talks to the other shards only through the
three collectives ``ppermute``, ``psum`` and ``pmax``; the engines' host
side reads the whole mesh's slabs through ``all_gather``.

``LocalMesh``: every shard is local, the leading axis is the whole mesh, and
a collective is a tensor operation over it (the analog of the JAX package's
virtual CPU mesh, or of ``mpirun`` on one machine, reference
mpi/run_tests.sh:8-16), not a multi-GPU run.

``DistMesh``: this rank holds shard ``rank`` alone (a leading axis of
length 1); ``ppermute`` is a send to the rank ``shift`` places further along
the axis and a receive from the rank ``shift`` places back (the reference's
Isend/Irecv), ``psum`` and ``pmax`` are all-reduces (its MPI_Allreduce),
``all_gather`` its Allgather, ``barrier`` its MPI_Barrier. NCCL carries
CUDA tensors; gloo carries CPU tensors, and a gloo mesh on a CUDA device
stages each collective through host memory, which no CUDA graph can capture
(``capturable`` False). Every route of both mesh engines runs on either
mesh, with the same bits.

A mesh of shape ``(d_r, d_c)`` lays its shards out row-major: shard ``r *
d_c + c`` sits at row ``r``, column ``c``. A 1D mesh of D shards is ``(D,
1)``: "rows" is its one axis. ``flat()`` is the 1D mesh of the same shards
(shard ``s`` at rank ``s`` in both layouts), the 2D engine's census
delegate's.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

AXES = ("rows", "cols")


def _mesh_shape(size: int, shape) -> tuple:
    """``shape`` (``(size, 1)`` where None) checked to hold ``size``
    shards."""
    if size < 1:
        raise ValueError(f"mesh size {size} < 1")
    shape = tuple(int(v) for v in (shape or (size, 1)))
    if len(shape) != 2 or shape[0] * shape[1] != size:
        raise ValueError(f"mesh shape {shape} does not hold {size} shards")
    return shape


class LocalMesh:
    """``size`` shards on ``device``, all held by this process, laid out as
    ``shape`` (``(size, 1)`` by default)."""

    # Its collectives are tensor operations: a step captures as a CUDA
    # graph (``ops/graphed``) on any device.
    capturable = True
    # This process's rank: one process holds the whole mesh.
    rank = 0

    def __init__(self, size: int, device, shape: tuple | None = None):
        shape = _mesh_shape(size, shape)
        self.size = size
        self.shape = shape
        self.device = torch.device(device)
        self.local_shards = tuple(range(size))
        # (L,) int64: the index of each local shard on the mesh (the JAX
        # program's lax.axis_index), and its (row, column) coordinates.
        self.shard_ids = torch.arange(size, device=self.device)
        self.coords = (self.shard_ids // shape[1], self.shard_ids % shape[1])

    def ppermute(self, tree, shift: int, axis: str = "rows"):
        """Ring permutation along ``axis``: the leaf of the shard at
        coordinate ``i`` on that axis goes to the shard at ``(i + shift) %
        extent`` with the same other coordinate (JAX ``lax.ppermute`` over
        ``[(i, (i + shift) % d)]`` on that axis). ``tree`` is a tensor, or a
        tuple or dict of tensors, each with the leading shard axis."""
        if isinstance(tree, dict):
            return {k: self.ppermute(v, shift, axis) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(self.ppermute(v, shift, axis) for v in tree)
        d_r, d_c = self.shape
        if axis == "rows":
            return torch.roll(tree, shift * d_c, dims=0)
        if axis != "cols":
            raise ValueError(f"unknown mesh axis {axis!r}; valid: {AXES}")
        grid = tree.reshape(d_r, d_c, *tree.shape[1:])
        return torch.roll(grid, shift, dims=1).reshape(tree.shape)

    def psum(self, t):
        """Sum over the mesh of per-shard values with the leading shard axis;
        the total, without it, as every shard sees it."""
        return torch.sum(t, dim=0, dtype=t.dtype)

    def pmax(self, t):
        """Maximum over the mesh, as ``psum``."""
        return torch.amax(t, dim=0)

    def all_gather(self, t):
        """Every shard's rows of ``t`` (leading shard axis), in shard
        order: here, ``t`` itself."""
        return t

    def barrier(self) -> None:
        """Every shard has reached this point: here, at once."""

    def flat(self) -> LocalMesh:
        """The 1D mesh, ``(size, 1)``, of the same shards on the same
        device."""
        return LocalMesh(self.size, self.device)


class DistMesh:
    """Shard ``rank`` of the initialised default ``torch.distributed``
    process group, on ``device``; the group's ``size`` ranks laid out as
    ``shape`` (``(size, 1)`` by default), rank ``r * d_c + c`` at row
    ``r``, column ``c``.

    The collectives take the trees and shapes ``LocalMesh``'s take, with a
    leading local axis of length 1. ``psum`` and ``pmax`` reduce it, then
    all-reduce over the group; every call site reduces integers, so the
    totals are exact (a float ``psum`` would add the shards in the
    backend's order, not ``LocalMesh``'s). The group's backend carries the
    tensors: NCCL those on ``device`` (a CUDA device), gloo CPU tensors,
    so a gloo mesh on a CUDA device copies each collective's tensors
    through host memory (``capturable`` False: ``ShardedEngine.run``
    refuses it, ``run_eager`` runs). ``init_dist_mesh`` initialises the
    group from torchrun's environment; a caller that initialised it
    itself builds the mesh directly.
    """

    def __init__(self, device, shape: tuple | None = None):
        if not dist.is_initialized():
            raise RuntimeError("DistMesh needs an initialised default "
                               "process group (init_dist_mesh)")
        self.size = dist.get_world_size()
        self.rank = dist.get_rank()
        self.shape = _mesh_shape(self.size, shape)
        self.device = torch.device(device)
        backend = str(dist.get_backend())
        if self.device.type == "cpu" and "gloo" not in backend:
            raise ValueError(f"a CPU mesh needs the gloo backend, not "
                             f"{backend}")
        self._staged = self.device.type == "cuda" and "nccl" not in backend
        # NCCL's collectives capture as CUDA graphs; a CPU mesh runs the
        # graphs' CPU twin; host-staged ones cannot capture.
        self.capturable = not self._staged
        self.local_shards = (self.rank,)
        self.shard_ids = torch.tensor([self.rank], device=self.device)
        self.coords = (self.shard_ids // self.shape[1],
                       self.shard_ids % self.shape[1])

    def _peers(self, shift: int, axis: str) -> tuple[int, int]:
        """(the rank ``shift`` places further along ``axis``, the rank
        ``shift`` places back), wrapping within the mesh row or column."""
        d_r, d_c = self.shape
        r, c = divmod(self.rank, d_c)
        if axis == "rows":
            return (((r + shift) % d_r) * d_c + c,
                    ((r - shift) % d_r) * d_c + c)
        if axis != "cols":
            raise ValueError(f"unknown mesh axis {axis!r}; valid: {AXES}")
        return r * d_c + (c + shift) % d_c, r * d_c + (c - shift) % d_c

    def _out(self, t):
        """``t`` as the backend carries it (a host copy where staged)."""
        return t.cpu() if self._staged else t

    def _in(self, t):
        return t.to(self.device) if self._staged else t

    def ppermute(self, tree, shift: int, axis: str = "rows"):
        """Ring permutation along ``axis`` (``LocalMesh.ppermute``): every
        leaf sent to the rank ``shift`` places further along it and
        received from the rank ``shift`` places back, in one
        ``batch_isend_irecv``; the identity, with no call, where the shift
        comes round to this rank (an axis of extent 1)."""
        dst, src = self._peers(shift, axis)
        leaves, spec = pytree.tree_flatten(tree)
        if dst == self.rank:
            return pytree.tree_unflatten(leaves, spec)
        sends = [self._out(t.contiguous()) for t in leaves]
        recvs = [torch.empty_like(t) for t in sends]
        for work in dist.batch_isend_irecv(
                [op for s, r in zip(sends, recvs)
                 for op in (dist.P2POp(dist.isend, s, dst),
                            dist.P2POp(dist.irecv, r, src))]):
            work.wait()
        return pytree.tree_unflatten([self._in(r) for r in recvs], spec)

    def _all_reduce(self, t, op):
        t = self._out(t)
        dist.all_reduce(t, op)
        return self._in(t)

    def psum(self, t):
        """The mesh's total of per-shard values with the leading local
        axis; the total, without it, on every rank."""
        return self._all_reduce(torch.sum(t, dim=0, dtype=t.dtype),
                                dist.ReduceOp.SUM)

    def pmax(self, t):
        """Maximum over the mesh, as ``psum``."""
        return self._all_reduce(torch.amax(t, dim=0), dist.ReduceOp.MAX)

    def all_gather(self, t):
        """Every rank's rows of ``t`` (leading local axis), in rank order,
        on every rank."""
        t = self._out(t.contiguous())
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t)
        return self._in(torch.cat(parts))

    def barrier(self) -> None:
        """Return once every rank has called it (an all-reduce read back on
        the host, so that an NCCL rank waits for it too): what one rank
        wrote to a file before it, every rank reads after it."""
        int(self._all_reduce(torch.zeros(1, dtype=torch.int32,
                                          device=self.device),
                             dist.ReduceOp.SUM))

    def flat(self) -> DistMesh:
        """The 1D mesh, ``(size, 1)``, over the same group and device:
        shard ``s`` is rank ``s`` in both layouts, so a 2D mesh's delegate
        holds the slab of the shard this rank holds."""
        return DistMesh(self.device)


def init_dist_mesh(shape: tuple | None = None, device="cuda") -> DistMesh:
    """Initialise the default process group from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT`` through
    ``init_method="env://"``) and return this rank's ``DistMesh``: NCCL on
    ``cuda:LOCAL_RANK`` for a CUDA device given without an index, gloo for
    the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method="env://")
    return DistMesh(device, shape)
