"""Command-line entry point with the reference's exact output contract.

Usage mirrors the reference binary (reference serial/parsim.cpp:461-469):

    python -m particlesimulation_tpu_torch <seed> <side_length> <grid_size> \
        <n_particles> <n_timesteps> [--engine parity|fast] \
        [--impl resident|supercell|banded|banded-cols|banded-cyclic|dense|\
tiered|sweep] [--device cuda|cpu] [--mesh N|RxC]

stdout: two lines — particle 0's position at three decimals, then the
cumulative collision count (serial/parsim.cpp:450-453). Wall time goes to
stderr as "%.1fs" (serial/parsim.cpp:475-479), timing only the step loop, as
the reference does; a ``run(state, 0)`` warm-up (the kernel build) runs
before the timer. The engine is parity (float64, the reference's operation
order) unless ``--engine fast`` is given; the device is ``cuda`` unless
``--device cpu`` is given. ``--mesh N`` runs the 1D row mesh of N shards
(``parallel/sharded.ShardedEngine``) on a local mesh: N shards in this
process on the one device, the analog of the JAX CLI's virtual CPU mesh.
Parity runs its f64 sweep; fast precision takes ``--impl
resident|supercell|banded|banded-cols|banded-cyclic|sweep`` or the mesh
census (sparse loads on super-cell tiles, clustered and large uniform ones
on column-sharded bands, the rest on resident tiles). ``--mesh RxC`` runs
the 2D mesh of R rows by C columns of shards
(``parallel/sharded2d.Sharded2DEngine``): parity its f64 sweep, fast
precision ``--impl resident|sweep`` or the census, which hands sparse,
clustered and streaming loads to the 1D mesh of R·C shards.

Under torchrun (``WORLD_SIZE`` set), the mesh is a
``parallel/mesh.DistMesh``, one shard per rank: ``--mesh D`` the 1D row
mesh, D the world size, on every route ``--impl`` or the census gives, and
``--mesh RxC`` the 2D mesh, R·C the world size:

    python -m torch.distributed.run --standalone --nproc-per-node D \
        -m particlesimulation_tpu_torch <5 args> --mesh D|RxC \
        [--engine fast] [--impl ...] [--device cpu]

NCCL on ``cuda:LOCAL_RANK`` (a card a rank), or gloo with ``--device cpu``.
Rank 0 alone prints the lines; every rank exits 0.
"""

from __future__ import annotations

import os
import sys
import time

USAGE = ("Usage: python -m particlesimulation_tpu_torch <seed> <side_length> "
         "<grid_size> <n_particles> <n_timesteps> [--engine parity|fast] "
         "[--impl resident|supercell|banded|dense|tiered|sweep] "
         "[--device cuda|cpu] [--mesh N|RxC] "
         "(default: parity on cuda; fast precision census-routes without "
         "--impl; mesh impls: resident|supercell|banded|banded-cols|"
         "banded-cyclic|sweep; RxC impls: resident|sweep)")
_FLAGS = ("--engine", "--impl", "--device", "--mesh")


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = {"--engine": "parity", "--impl": None, "--device": "cuda",
            "--mesh": "1"}
    pos_args = []
    i = 0
    while i < len(argv):
        if argv[i] in _FLAGS and i + 1 < len(argv):
            opts[argv[i]] = argv[i + 1]
            i += 2
        else:
            pos_args.append(argv[i])
            i += 1
    try:
        args = (int(pos_args[0]), float(pos_args[1]), int(pos_args[2]),
                int(pos_args[3]), int(pos_args[4]))
        mesh = [int(v) for v in opts["--mesh"].split("x")]
    except (IndexError, ValueError):
        print(USAGE, file=sys.stderr)
        return 1
    if (len(pos_args) != 5 or opts["--engine"] not in ("parity", "fast")
            or len(mesh) > 2):
        print(USAGE, file=sys.stderr)
        return 1
    n_shards = mesh[0] * (mesh[1] if len(mesh) > 1 else 1)
    mesh_shape = tuple(mesh) if len(mesh) > 1 else ()
    world = int(os.environ.get("WORLD_SIZE", "0"))
    if world and n_shards != world:
        # Under torchrun, --mesh D or RxC of the world size's shards
        # (--mesh 1 on one rank runs the one-device engine).
        print(f"--mesh {opts['--mesh']} under torchrun with WORLD_SIZE="
              f"{world}: give --mesh {world} (or RxC with R·C = {world})"
              f"\n{USAGE}", file=sys.stderr)
        return 1

    import torch

    if (world > 1 and opts["--device"] != "cpu"
            and torch.cuda.device_count() < world):
        print(f"{world} ranks need {world} CUDA devices, one a rank; this "
              f"machine has {torch.cuda.device_count()} (--device cpu runs "
              f"gloo)", file=sys.stderr)
        return 1
    if world <= 1:
        return _simulate(opts, args, n_shards, mesh_shape, None)
    from particlesimulation_tpu_torch.parallel.mesh import init_dist_mesh

    dist_mesh = init_dist_mesh(shape=mesh_shape or None,
                               device=opts["--device"])
    try:
        return _simulate(opts, args, n_shards, mesh_shape, dist_mesh)
    finally:
        torch.distributed.destroy_process_group()


def _simulate(opts, args, n_shards, mesh_shape, dist_mesh) -> int:
    """Build the engine (the mesh engine on ``dist_mesh``, where given) and
    run it."""
    from particlesimulation_tpu_torch.config import Precision, SimConfig
    from particlesimulation_tpu_torch.engine import Engine
    from particlesimulation_tpu_torch.parallel.sharded import ShardedEngine
    from particlesimulation_tpu_torch.parallel.sharded2d import (
        Sharded2DEngine)

    precision = (Precision.PARITY if opts["--engine"] == "parity"
                 else Precision.FAST)
    seed, side, ncside, n_particles, n_steps = args
    try:
        config = SimConfig(seed=seed, side=side, ncside=ncside,
                           n_particles=n_particles, precision=precision,
                           n_shards=n_shards, mesh_shape=mesh_shape)
        # Parity always runs the sweep (the mesh engines force it, as the
        # single-device engine does); fast precision takes --impl or the
        # census.
        cls = (Engine if n_shards == 1 and dist_mesh is None else
               Sharded2DEngine if mesh_shape else ShardedEngine)
        where = ({"device": opts["--device"]} if dist_mesh is None
                 else {"mesh": dist_mesh})
        eng = cls(config, impl=opts["--impl"], **where)
    except ValueError as e:
        print(f"{e}\n{USAGE}", file=sys.stderr)
        return 1
    return _run(eng, n_steps, dist_mesh is None or dist_mesh.rank == 0)


def _run(eng, n_steps: int, prints: bool) -> int:
    """The timed run and the output contract (printed where ``prints``)."""
    state = eng.init_state()
    # Warm-up outside the timed region (the reference's timer brackets only
    # simulate(); building the kernels is the analog of g++'s compile): a
    # run of 0 steps builds the kernels and captures the run's CUDA graphs,
    # as JAX's run(state, 0) compiles its one program, so that the timed
    # run replays them.
    state0 = eng.run(state, 0)
    t0 = time.perf_counter()
    state = eng.run(state0, n_steps)
    elapsed = time.perf_counter() - t0

    x, y, cols = eng.result(state)
    if prints:
        print(f"{elapsed:.1f}s", file=sys.stderr)
        print(f"{x:.3f} {y:.3f}")
        print(cols)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
