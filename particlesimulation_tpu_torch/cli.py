"""Command-line entry point with the reference's exact output contract.

Usage mirrors the reference binary (reference serial/parsim.cpp:461-469):

    python -m particlesimulation_tpu_torch <seed> <side_length> <grid_size> \
        <n_particles> <n_timesteps> [--engine parity|fast] \
        [--impl resident|supercell|banded|dense|tiered|sweep] \
        [--device cuda|cpu]

stdout: two lines — particle 0's position at three decimals, then the
cumulative collision count (serial/parsim.cpp:450-453). Wall time goes to
stderr as "%.1fs" (serial/parsim.cpp:475-479), timing only the step loop, as
the reference does; a ``run(state, 0)`` warm-up (the kernel build) runs
before the timer. The engine is parity (float64, the reference's operation
order) unless ``--engine fast`` is given; the device is ``cuda`` unless
``--device cpu`` is given. ``--mesh`` with more than one device is refused:
the sharded engines are not ported.
"""

from __future__ import annotations

import sys
import time

USAGE = ("Usage: python -m particlesimulation_tpu_torch <seed> <side_length> "
         "<grid_size> <n_particles> <n_timesteps> [--engine parity|fast] "
         "[--impl resident|supercell|banded|dense|tiered|sweep] "
         "[--device cuda|cpu] "
         "(default: parity on cuda; fast precision census-routes without "
         "--impl)")
_FLAGS = ("--engine", "--impl", "--device", "--mesh")


def _devices(mesh: str) -> int:
    """Devices a ``--mesh`` value asks for: "N" or "RxC"."""
    n = 1
    for v in mesh.split("x"):
        n *= int(v)
    return n


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
        seed, side, ncside, n_particles, n_steps = (
            int(pos_args[0]), float(pos_args[1]), int(pos_args[2]),
            int(pos_args[3]), int(pos_args[4]))
        mesh = _devices(opts["--mesh"])
    except (IndexError, ValueError):
        print(USAGE, file=sys.stderr)
        return 1
    if len(pos_args) != 5 or opts["--engine"] not in ("parity", "fast"):
        print(USAGE, file=sys.stderr)
        return 1
    if mesh > 1:
        print(f"--mesh {opts['--mesh']}: the sharded engines are not ported "
              f"yet; this port runs on one device", file=sys.stderr)
        return 2

    from particlesimulation_tpu_torch.config import Precision, SimConfig
    from particlesimulation_tpu_torch.engine import Engine

    precision = (Precision.PARITY if opts["--engine"] == "parity"
                 else Precision.FAST)
    config = SimConfig(seed=seed, side=side, ncside=ncside,
                       n_particles=n_particles, precision=precision)
    eng = Engine(config, impl=opts["--impl"], device=opts["--device"])
    state = eng.init_state()
    # Warm-up outside the timed region (the reference's timer brackets only
    # simulate(); building the kernels is the analog of g++'s compile).
    state0 = eng.run(state, 0)
    t0 = time.perf_counter()
    state = eng.run(state0, n_steps)
    elapsed = time.perf_counter() - t0

    x, y, cols = eng.result(state)
    print(f"{elapsed:.1f}s", file=sys.stderr)
    print(f"{x:.3f} {y:.3f}")
    print(cols)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
