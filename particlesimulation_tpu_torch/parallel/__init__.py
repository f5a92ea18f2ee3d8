"""The meshes: the reference's MPI layer (counterpart of the JAX package's
``parallel/``).

  P2 domain decomposition           → ``ShardedEngine`` over a 1D mesh of
                                      grid-row blocks (``sharded``), blocks
                                      of super-rows (``sharded_supercell``),
                                      of columns (``sharded_banded_cols``)
                                      or block-cyclic band chunks
                                      (``sharded_banded``);
                                      ``Sharded2DEngine`` over a 2D mesh of
                                      rectangles (``sharded2d``,
                                      ``sharded2d_resident``)
  P3 ghost-cell halo Isend/Irecv    → ``mesh.ppermute`` of a one-row (or
                                      one-column, or two-phase) COM halo
  P4 particle migration Alltoall    → ring-forwarded buffers (the sweeps) or
                                      shipped halos (the tile meshes)
  P5 MPI_Reduce / Gatherv           → ``mesh.psum`` / ``mesh.all_gather`` at
                                      read-out

The mesh is ``mesh.LocalMesh`` (D shards, as (rows, cols), held by one
process on one device) or, for the 1D row mesh's sweep and resident
tiles, ``mesh.DistMesh`` (one shard a ``torch.distributed`` rank).
"""
