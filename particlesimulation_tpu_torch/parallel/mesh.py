"""The local mesh: D shards in one process, on one device.

The port's counterpart of the JAX package's ``jax.sharding.Mesh`` with
``shard_map`` over a 1D "rows" axis. A shard program (``parallel/sharded``,
``parallel/sharded_resident``) holds its shards' data with a leading shard
axis, of length ``len(local_shards)``, and talks to the other shards only
through the three collectives below. Here every shard is local: the leading
axis is the whole mesh, and a collective is a tensor operation over it (the
analog of the JAX package's virtual CPU mesh, or of ``mpirun`` on one
machine, reference mpi/run_tests.sh:8-16), not a multi-GPU run.

A ``torch.distributed`` mesh, one shard per rank, is meant to implement the
same interface (``size``, ``device``, ``local_shards``, ``shard_ids``,
``ppermute``, ``psum``, ``pmax``): ``ppermute`` as a send to rank
``(r + shift) % size`` and a receive from ``(r - shift) % size``, ``psum``
and ``pmax`` as all-reduces; the shard programs need no change.
"""

from __future__ import annotations

import torch


class LocalMesh:
    """``size`` shards on ``device``, all held by this process."""

    def __init__(self, size: int, device):
        if size < 1:
            raise ValueError(f"mesh size {size} < 1")
        self.size = size
        self.device = torch.device(device)
        self.local_shards = tuple(range(size))
        # (L,) int64: the index of each local shard on the mesh axis (the
        # JAX program's lax.axis_index).
        self.shard_ids = torch.arange(size, device=self.device)

    def ppermute(self, tree, shift: int):
        """Ring permutation: shard s's leaf goes to shard (s + shift) % size
        (JAX ``lax.ppermute`` over ``[(i, (i + shift) % d)]``). ``tree`` is
        a tensor, or a tuple or dict of tensors, each with the leading shard
        axis."""
        if isinstance(tree, dict):
            return {k: self.ppermute(v, shift) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(self.ppermute(v, shift) for v in tree)
        return torch.roll(tree, shift, dims=0)

    def psum(self, t):
        """Sum over the mesh of per-shard values with the leading shard axis;
        the total, without it, as every shard sees it."""
        return torch.sum(t, dim=0, dtype=t.dtype)

    def pmax(self, t):
        """Maximum over the mesh, as ``psum``."""
        return torch.amax(t, dim=0)
