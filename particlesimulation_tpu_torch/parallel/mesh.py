"""The local mesh: D shards in one process, on one device.

The port's counterpart of the JAX package's ``jax.sharding.Mesh`` with
``shard_map`` over a "rows" axis, or over the (rows, cols) axes of its 2D
mesh. A shard program (``parallel/sharded``, ``parallel/sharded_resident``,
``parallel/sharded2d``) holds its shards' data with a leading shard axis, of
length ``len(local_shards)``, and talks to the other shards only through the
three collectives below. Here every shard is local: the leading axis is the
whole mesh, and a collective is a tensor operation over it (the analog of
the JAX package's virtual CPU mesh, or of ``mpirun`` on one machine,
reference mpi/run_tests.sh:8-16), not a multi-GPU run.

A mesh of shape ``(d_r, d_c)`` lays its shards out row-major: shard ``r *
d_c + c`` sits at row ``r``, column ``c``. A 1D mesh of D shards is ``(D,
1)``: "rows" is its one axis.

A ``torch.distributed`` mesh, one shard per rank, is meant to implement the
same interface (``size``, ``shape``, ``device``, ``local_shards``,
``shard_ids``, ``coords``, ``ppermute``, ``psum``, ``pmax``): ``ppermute(t,
shift, axis)`` as a send to the rank ``shift`` places further along
``axis`` (wrapping within the mesh row or column) and a receive from the
rank ``shift`` places back, ``psum`` and ``pmax`` as all-reduces over the
whole mesh; the shard programs need no change.
"""

from __future__ import annotations

import torch

AXES = ("rows", "cols")


class LocalMesh:
    """``size`` shards on ``device``, all held by this process, laid out as
    ``shape`` (``(size, 1)`` by default)."""

    def __init__(self, size: int, device, shape: tuple | None = None):
        if size < 1:
            raise ValueError(f"mesh size {size} < 1")
        shape = tuple(int(v) for v in (shape or (size, 1)))
        if len(shape) != 2 or shape[0] * shape[1] != size:
            raise ValueError(f"mesh shape {shape} does not hold {size} "
                             f"shards")
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
