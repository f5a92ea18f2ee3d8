"""The 1D row mesh: the reference's MPI layer (counterpart of the JAX
package's ``parallel/``).

  P2 row-wise domain decomposition  → ``ShardedEngine`` over a 1D mesh of
                                      grid-row blocks (``sharded``)
  P3 ghost-cell halo Isend/Irecv    → ``mesh.ppermute`` of a one-row COM halo
  P4 particle migration Alltoall    → ring-forwarded buffers (the sweep) or
                                      shipped halo rows (resident tiles)
  P5 MPI_Reduce / Gatherv           → ``mesh.psum`` / host gather at read-out

The mesh is ``mesh.LocalMesh``: D shards held by one process on one device.
"""
