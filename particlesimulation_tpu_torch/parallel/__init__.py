"""The 1D mesh: the reference's MPI layer (counterpart of the JAX package's
``parallel/``).

  P2 domain decomposition           → ``ShardedEngine`` over a 1D mesh of
                                      grid-row blocks (``sharded``), blocks
                                      of super-rows (``sharded_supercell``)
                                      or of columns (``sharded_banded_cols``)
  P3 ghost-cell halo Isend/Irecv    → ``mesh.ppermute`` of a one-row (or
                                      one-column) COM halo
  P4 particle migration Alltoall    → ring-forwarded buffers (the sweep) or
                                      shipped halos (the tile meshes)
  P5 MPI_Reduce / Gatherv           → ``mesh.psum`` / host gather at read-out

The mesh is ``mesh.LocalMesh``: D shards held by one process on one device.
"""
