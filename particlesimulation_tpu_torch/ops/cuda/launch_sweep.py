"""The pair kernels' launch shapes on the engines' own tiles.

Run on a machine with one CUDA card, from the repository root:

    python3 -m particlesimulation_tpu_torch.ops.cuda.launch_sweep
    python3 -m particlesimulation_tpu_torch.ops.cuda.launch_sweep --supercell

The first builds the resident engine's pair-pass tiles after RESIDENT_STEPS steps
of golden s1's configuration (the flagship) and of the same particles on
coarser grids (RESIDENT_SWEEP: rows of ~200 and ~400 used slots), the dense
engine's tiles of the flagship and the dense and tiered engines' tiles of
UNEVEN. It times the fused kernel (v4, v2 and v1, collide on) in every
(receivers per thread, threads per block) shape on the resident tiles, the
force kernel in every such shape and the collision kernel at every thread
count from 32 to 1024 on the others, each against the shape the wrappers'
rules pick
(``cell_pairs.fused_launch``, ``cell_pairs.force_launch``,
``cell_pairs.collision_threads``), whose outputs every shape must equal bit
for bit. Times: CUDA events around each call, the calls queued behind a
spin kernel, median of 10. The rules come from this table.

``--supercell`` sweeps the supercell engine's two kernels instead, on
SMALL's own pair-pass tiles (SMALL's configuration after SMALL_STEPS steps
through the census): the labelled pass (v4 and v2, collide on and off) a
warp a row at 1 to 16 rows a block, and a block a row at 1 or 2 receivers a
thread and 32 or 64 threads, each against ``cell_pairs.labelled_launch``'s
shape bit for bit; then the adversarial tiles at K = 160 and 1024 a block a
row; then the cell sums kernel at 1 to 8 rows a block against
``cell_pairs.cell_sums_launch``'s, with its zeroing of the output, its
kernel and the round kernel (which rows of K > 64 take) timed apart.

``resident_tiles``, ``band_tiles``, ``class_tiles`` and ``dense_tiles`` also
serve ``chip_smoke.py``.
"""

from __future__ import annotations

import statistics
import subprocess
import sys

import torch

from particlesimulation_tpu_torch.config import EPSILON, G
from particlesimulation_tpu_torch.ops.cuda import cell_pairs

# golden s1's configuration, and UNEVEN (the reference report's clustered
# workload) with its tier plan and its band plan (the census's).
FLAGSHIP = (1, 5000.0, 100, 1_000_000)
UNEVEN = (-23, 5000.0, 100, 1_000_000)
UNEVEN_PLAN = ((32, 10000), (64, 1280), (128, 1280), (192, 800), (256, 512),
               (320, 416), (384, 352), (448, 288), (480, 128), (576, 352),
               (672, 288), (864, 96))
UNEVEN_BANDS = ((0, 15, 64), (15, 6, 128), (21, 4, 224), (25, 5, 352),
                (30, 6, 544), (36, 5, 704), (41, 21, 896), (62, 6, 608),
                (68, 4, 416), (72, 4, 288), (76, 6, 192), (82, 9, 96),
                (91, 9, 32))
SPIN_CYCLES = 2_000_000  # ~1.1 ms of a 1.755 GHz SM per queued call
RESIDENT_STEPS = 4  # golden s1's run: its last pair pass
# The flagship's particles binned into 100², 70² and 50² cells.
RESIDENT_SWEEP = (FLAGSHIP, (1, 5000.0, 70, 1_000_000),
                  (1, 5000.0, 50, 1_000_000))
# The fused kernel's variants: (name, force form, hit-gated).
FUSED_KINDS = (("v4", "v4", True), ("v2", "v2", True), ("v1", "v2", False))
# SMALL (the reference report's sparse workload, seed 50, side 10000,
# ncside 1300, N = 5e5): the census runs it on super-cells of S = 10.
SMALL = (50, 10000.0, 1300, 500_000)
SMALL_STEPS = 10
# The labelled pass's variants: (force form, collide).
LABELLED_KINDS = (("v4", True), ("v4", False), ("v2", True))


def fresh_inputs(fresh, reps):
    """``reps`` calls' inputs: ``fresh()`` each, made before any is timed
    (a function that writes its inputs in place gets new ones each call);
    without ``fresh``, None each."""
    return [fresh() if fresh else None for _ in range(reps)]


def call_with(fn, arg):
    """``fn(arg)``, or ``fn()`` for an input of None (``fresh_inputs``)."""
    return fn() if arg is None else fn(arg)


def device_ms(fn, reps, fresh=None):
    """Median device milliseconds of ``fn`` over ``reps`` calls: CUDA events
    around each call, all queued behind a spin kernel, so that each pair of
    events brackets the call's kernels and not the host's work between
    launches. With ``fresh``, each call is ``fn(fresh())``, the inputs made
    before the spin kernel is queued."""
    args = fresh_inputs(fresh, reps + 1)
    call_with(fn, args[0])
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(SPIN_CYCLES * reps)
    for (start, end), a in zip(events, args[1:]):
        start.record()
        call_with(fn, a)
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def resident_tiles(config, kcap, state, steps=RESIDENT_STEPS):
    """The (x, y, mf, alive, pid) tiles the resident engine's pair pass
    takes at step ``steps`` of a run from ``state``, holes included."""
    from particlesimulation_tpu_torch.engine import make_resident_run

    return make_resident_run(config, kcap)[1](state, steps)


def band_tiles(config, plan, state, steps):
    """The per-band (x, y, mf, alive, pid) tiles the banded engine's pair
    passes take at step ``steps`` of a run from ``state`` on ``plan``."""
    from particlesimulation_tpu_torch.ops.banded import make_banded_run

    return make_banded_run(config, plan)[1](state, steps)


def class_tiles(config, plan, state):
    """The tiered engine's class tiles of ``state``: per class (x, y, m,
    ml, mxl, myl), the stencil rows gathered for the class's cells."""
    from particlesimulation_tpu_torch.ops import binning, stencil
    from particlesimulation_tpu_torch.ops.tiered import make_tiered_step

    nc, side = config.ncside, config.side
    key, _ = binning.cell_keys(state.x, state.y, side, nc)

    def sums(v):
        out = torch.zeros(nc * nc + 1, dtype=v.dtype, device=v.device)
        return out.index_add_(0, key.long(), v)[:nc * nc]

    tables = stencil.tables_from_sums(sums(state.m), sums(state.m * state.x),
                                      sums(state.m * state.y), side, nc)
    tiles = make_tiered_step(config, plan, state.x.device.type)[1](state)
    out, offs = [], 0
    for t, (k, r) in enumerate(plan):
        xyz = [tiles[f][offs:offs + r * k].view(r, k)
               for f in ("xf", "yf", "mf")]
        rows = (tuple(tables) if t == 0 else
                tuple(a[tiles["ids"][t - 1]] for a in tables))
        out.append(xyz + [a.contiguous() for a in rows])
        offs += r * k
    return out


def dense_tiles(config, tiles):
    """The dense engine's (x, y, m) tiles and their stencil rows."""
    from particlesimulation_tpu_torch.ops import stencil

    x, y, m = tiles["xd"], tiles["yd"], tiles["md"]
    return (x, y, m) + tuple(stencil.tables_from_sums(
        m.sum(1), (m * x).sum(1), (m * y).sum(1), config.side,
        config.ncside))


def _fused(tiles, form, gated, shape):
    """The fused kernel, collide on, in launch shape (rows, threads); (fx,
    fy, count, ft) as ``cell_pairs.fused_pairs`` returns them."""
    x, y, mf, alive, pid = tiles
    fx, fy = torch.empty_like(x), torch.empty_like(x)
    ft = torch.empty_like(pid)
    count = torch.empty((), dtype=torch.int32, device=x.device)
    cell_pairs._launch(
        "fused_pairs" if gated else "fused_pairs_v1",
        cell_pairs._library().psim_fused_pairs, x,
        x.data_ptr(), y.data_ptr(), mf.data_ptr(), alive.data_ptr(),
        pid.data_ptr(), fx.data_ptr(), fy.data_ptr(), ft.data_ptr(),
        count.data_ptr(), x.shape[0], x.shape[1], cell_pairs._eps2(EPSILON),
        G, 1, int(form == "v4"), int(gated), *shape)
    return fx, fy, count, ft


def sweep_fused(label, tiles):
    """The fused kernel's launch shapes on one tile set, each variant's
    outputs equal to the rule's shape's bit for bit; prints one line."""
    rows, kcap = tiles[0].shape
    used = (tiles[2] > 0).sum(1)
    rule = cell_pairs.fused_launch(kcap)
    shapes = sorted({(r, t) for r in (1, 2)
                     for t in (32, 64, 96, 128, 192, 256)} | {rule})
    parts = []
    for name, form, gated in FUSED_KINDS:
        ref = _fused(tiles, form, gated, rule)
        times = []
        for shape in shapes:
            got = _fused(tiles, form, gated, shape)
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                raise AssertionError(f"{label}: fused {name} of launch "
                                     f"{shape} differs from the rule's "
                                     f"launch {rule}")
            times.append((shape, device_ms(
                lambda: _fused(tiles, form, gated, shape), 10)))
        parts.append(f"{name} " + ", ".join(f"{s}={t:.4f}" for s, t in times))
    print(f"{label} ({rows}, {kcap}), used slots a row: mean "
          f"{float(used.float().mean()):.1f}, max {int(used.max())}; "
          f"fused (rows, threads) ms: "
          + "; ".join(parts) + f"; rule {rule}", flush=True)


def supercell_tiles(config, kcap, S, state, steps=SMALL_STEPS):
    """The (x, y, mf, alive, pid, sub) tiles the supercell engine's labelled
    pass takes at step ``steps`` of a run from ``state``."""
    from particlesimulation_tpu_torch.ops.supercell import make_supercell_run

    return make_supercell_run(config, kcap, S)[1](state, steps)


def _labelled(tiles, form, collide, shape):
    """The labelled pass in launch shape (rows a block, receivers a thread,
    threads a block); (fx, fy, count, ft) as ``cell_pairs.fused_pairs``
    returns them."""
    x, y, mf, alive, pid, sub = tiles
    fx, fy = torch.empty_like(x), torch.empty_like(x)
    ft = torch.empty_like(pid)
    count = torch.empty((), dtype=torch.int32, device=x.device)
    cell_pairs._launch(
        "fused_pairs_sub", cell_pairs._library().psim_labelled_pairs, x,
        x.data_ptr(), y.data_ptr(), mf.data_ptr(), alive.data_ptr(),
        pid.data_ptr(), sub.data_ptr(), fx.data_ptr(), fy.data_ptr(),
        ft.data_ptr(), count.data_ptr(), x.shape[0], x.shape[1],
        cell_pairs._eps2(EPSILON), G, int(collide), int(form == "v4"),
        *shape)
    return fx, fy, count, ft


def sweep_labelled(label, tiles):
    """The labelled pass's launch shapes on one tile set, each one's outputs
    equal to the rule's shape's bit for bit; prints one line."""
    rows, kcap = tiles[0].shape
    rule = cell_pairs.labelled_launch(kcap)
    shapes = {(0, r, t) for r in (1, 2) for t in (32, 64, 96, 128, 192, 256)
              if t <= 64 or kcap > cell_pairs.WARP_ROW_KCAP}
    if kcap <= cell_pairs.WARP_ROW_KCAP:
        shapes |= {(w, -(-kcap // 32), 32 * w) for w in (1, 2, 4, 8, 16)}
    parts = []
    for form, collide in LABELLED_KINDS:
        ref = _labelled(tiles, form, collide, rule)
        times = []
        for shape in sorted(shapes | {rule}):
            got = _labelled(tiles, form, collide, shape)
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                raise AssertionError(f"{label}: labelled {form} collide="
                                     f"{collide} of launch {shape} differs "
                                     f"from the rule's launch {rule}")
            times.append((shape, device_ms(
                lambda: _labelled(tiles, form, collide, shape), 10)))
        parts.append(f"{form} collide={collide} "
                     + ", ".join(f"{s}={t:.4f}" for s, t in times))
    print(f"{label} ({rows}, {kcap}): labelled (rows a block, receivers a "
          f"thread, threads) ms: " + "; ".join(parts) + f"; rule {rule}",
          flush=True)


def _cell_sums(args, warps, parts=3, rounds=0):
    """The cell sums kernel at ``warps`` rows a block; ``parts`` 1 only
    zeroes the output, 2 only runs the kernel, 3 both; ``rounds`` 1 takes
    the round kernel whatever K."""
    mf, mfx, mfy, cell, ncells = args
    out = torch.empty((3, ncells), dtype=torch.float32, device=mf.device)
    cell_pairs._launch(
        "supercell_cell_sums", cell_pairs._library().psim_cell_sums, mf,
        mf.data_ptr(), mfx.data_ptr(), mfy.data_ptr(), cell.data_ptr(),
        out.data_ptr(), mf.shape[0], mf.shape[1], ncells, warps, parts,
        rounds)
    return out


def sweep_cell_sums(label, args):
    """The cell sums kernel at 1 to 8 rows a block, each equal to the
    rule's bit for bit, and at the rule's shape its zeroing, its kernel and
    the round kernel (which wider rows take) timed apart; prints one
    line."""
    rows, kcap = args[0].shape
    rule = cell_pairs.cell_sums_launch(kcap)
    ref = _cell_sums(args, rule)
    times = []
    for w in sorted({1, 2, 4, 8, rule}):
        if not torch.equal(_cell_sums(args, w), ref):
            raise AssertionError(f"{label}: cell sums at {w} rows a block "
                                 f"differ from the rule's {rule}")
        times.append((w, device_ms(lambda: _cell_sums(args, w), 10)))
    zero = device_ms(lambda: _cell_sums(args, rule, 1), 10)
    kern = device_ms(lambda: _cell_sums(args, rule, 2), 10)
    if not torch.equal(_cell_sums(args, rule, 3, 1), ref):
        raise AssertionError(f"{label}: the round kernel differs")
    rounds = device_ms(lambda: _cell_sums(args, rule, 2, 1), 10)
    print(f"{label} ({rows}, {kcap}) onto {args[4]} cells: cell sums rows a "
          f"block ms: " + ", ".join(f"{w}={t:.4f}" for w, t in times)
          + f"; at the rule's {rule}: zeroing alone {zero:.4f}, kernel alone "
          f"{kern:.4f}; the round kernel (__match_any_sync) alone "
          f"{rounds:.4f}", flush=True)


def supercell_main():
    """The supercell engine's kernels on SMALL's tiles (``--supercell``)."""
    from particlesimulation_tpu_torch.config import SimConfig
    from particlesimulation_tpu_torch.engine import Engine
    from particlesimulation_tpu_torch.ops import resident as res
    from particlesimulation_tpu_torch.ops.cuda.adversarial import (
        adversarial_tiles, label_layouts)

    config = SimConfig(*SMALL)
    eng = Engine(config, device="cuda")
    state = eng.init_state()
    S = eng._supercell_factor()
    tiles = supercell_tiles(config, eng.kcap, S, state)
    sweep_labelled(f"SMALL tiles (S = {S})", tiles)
    for kcap in (160, 1024):
        adv = [torch.from_numpy(a).cuda() for a in adversarial_tiles(kcap)]
        for name in ("random", "one"):
            sub = torch.from_numpy(label_layouts(kcap)[name]).cuda()
            sweep_labelled(f"adversarial tiles, labels {name}", adv + [sub])
    x, y, mf, _, _, sub = tiles
    cx, cy, _ = res.cell_of(x, y, config.side, config.ncside)
    cell = torch.where(sub >= 0, cy * config.ncside + cx, -1).to(torch.int32)
    sweep_cell_sums("SMALL tiles", (mf, mf * x, mf * y, cell, config.ncells))


def _forces(x, y, m, ml, mxl, myl, shape):
    """The force kernel in launch shape (rows, threads, chunks)."""
    fx, fy = torch.empty_like(x), torch.empty_like(x)
    cell_pairs._launch(
        "dense_forces", cell_pairs._library().psim_dense_forces, x,
        x.data_ptr(), y.data_ptr(), m.data_ptr(), ml.data_ptr(),
        mxl.data_ptr(), myl.data_ptr(), fx.data_ptr(), fy.data_ptr(),
        x.shape[0], x.shape[1], G, *shape)
    return fx, fy


def _collisions(x, y, alive, threads):
    """The collision kernel (no pid) with ``threads`` per block."""
    ft = torch.empty_like(alive)
    count = torch.empty((), dtype=torch.int32, device=x.device)
    cell_pairs._launch(
        "dense_collisions", cell_pairs._library().psim_dense_collisions, x,
        x.data_ptr(), y.data_ptr(), alive.data_ptr(), None, ft.data_ptr(),
        count.data_ptr(), x.shape[0], x.shape[1],
        cell_pairs._eps2(EPSILON), threads)
    return count, ft


def sweep(label, x, y, m, ml, mxl, myl):
    """One tile set: every launch shape timed, outputs equal to the rule's
    shape's bit for bit; prints one line."""
    rows, kcap = x.shape
    sms = cell_pairs._sm_count(x.device.index)
    alive = (m > 0).to(torch.int32)
    fargs = (x, y, m, ml, mxl, myl, kcap)
    ref = cell_pairs.dense_pairwise_forces(*fargs)
    rule = cell_pairs.force_launch(rows, kcap, sms)
    chunks = rule[2]
    shapes = sorted({(r, t, chunks) for r in (1, 2)
                     for t in (32, 64, 128, 256)} | {rule})
    ftimes = []
    for shape in shapes:
        got = _forces(*fargs[:6], shape)
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"{label}: forces of launch {shape} differ "
                                 f"from the rule's launch {rule}")
        ftimes.append((shape, device_ms(lambda: _forces(*fargs[:6], shape),
                                        10)))
    cref = cell_pairs.dense_collisions(x, y, alive, kcap, EPSILON)
    crule = cell_pairs.collision_threads(rows, kcap, sms)
    ctimes = []
    for threads in sorted({32, 64, 96, 128, 256, 512, 1024, crule}):
        got = _collisions(x, y, alive, threads)
        if not all(torch.equal(a, b) for a, b in zip(got, cref)):
            raise AssertionError(f"{label}: collisions with {threads} "
                                 f"threads differ from the rule's {crule}")
        ctimes.append((threads, device_ms(
            lambda: _collisions(x, y, alive, threads), 10)))
    print(f"{label} ({rows}, {kcap}): forces (rows, threads, chunks) ms: "
          + ", ".join(f"{s}={t:.4f}" for s, t in ftimes)
          + f"; rule {rule}; collisions threads ms: "
          + ", ".join(f"{n}={t:.4f}" for n, t in ctimes)
          + f"; rule {crule}", flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("launch_sweep: CUDA is not available")
    from particlesimulation_tpu_torch.config import SimConfig
    from particlesimulation_tpu_torch.engine import Engine, make_dense_step

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(f"{smi.stdout.strip().splitlines()[0]}, "
          f"{cell_pairs._sm_count(0)} SMs", flush=True)
    if sys.argv[1:] == ["--supercell"]:
        supercell_main()
        return
    for args in RESIDENT_SWEEP:
        config = SimConfig(*args)
        eng = Engine(config, device="cuda", impl="resident")
        state = eng.init_state()  # sizes the tiles
        sweep_fused(f"resident tiles {args}",
                    resident_tiles(config, eng.kcap, state))
    for label, args in (("flagship", FLAGSHIP), ("UNEVEN", UNEVEN)):
        config = SimConfig(*args)
        eng = Engine(config, device="cuda", impl="dense")
        state = eng.init_state()
        tiles = make_dense_step(config, eng.kcap)[1](state)
        sweep(f"{label} dense tiles", *dense_tiles(config, tiles))
    config = SimConfig(*UNEVEN)
    state = Engine(config, device="cuda", impl="tiered").init_state()
    for tiles in class_tiles(config, UNEVEN_PLAN, state):
        sweep("UNEVEN class", *tiles)


if __name__ == "__main__":
    main()
