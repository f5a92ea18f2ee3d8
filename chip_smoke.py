#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the kernel library from ``particlesimulation_tpu_torch/csrc`` and
holds each kernel against its plain torch version at the tile shapes the
engines give it and on the adversarial tiles of
``ops/cuda/adversarial.py`` (the cases the kernels' compaction, x buckets
and O(n) count risk); then it drives the three engines through ``Engine``:

* resident (the main path): golden vector s1 (seed 1, side 5000, ncside
  100, N=1e6) against the reference's golden values, once with the default
  pair kernel and once with the v1 kernel; the fused kernel on the tiles
  the engine's own run hands its pair pass (v4 with collide on and off, v1;
  checked, timed, with the bound);
* dense: golden s1 again, and both dense kernels on the engine's own tiles
  (checked, timed, with the bound);
* tiered: UNEVEN (seed -23, side 5000, ncside 100, N=1e6, the reference
  report's clustered workload) against the JAX package's result, each of
  its 12 classes through both dense kernels (checked, timed, with the
  bound), then 10 steps against the dense engine on the card, whose own
  UNEVEN tiles go through both kernels too.

Then the sweep engine (plain torch, no kernel of its own) and the CLI:

a. ``python -m particlesimulation_tpu_torch`` on golden s1 with the default
   engine (f64 parity) and device (cuda), as a subprocess: the golden lines
   exactly, and "%.1fs" on stderr;
b. golden s0 and the five small golden vectors through the parity engine
   on cuda at the harness's ±0.001, the counts exact;
c. the parity engine on cuda and on cpu, bitwise equal in every field;
d. the f32 sweep on golden s1 (±0.002, 4 collisions), and 1200 particles
   in one cell through resident, where the ladder must end on the sweep;
e. MEDIUM (golden s3's config, kcap ~2750) through the census: the ladder
   ends on the sweep, overflow 0, and two runs give the same bits;
f. the CLI's fast route in-process, which must launch the fused kernel;
g. the step times of parity s1, the f32 sweep s1 and MEDIUM.

Then the supercell engine at SMALL (seed 50, side 10000, ncside 1300,
N=5e5, 10 steps; the reference report's sparse workload, not cut):

h. the labelled fused kernel on SMALL's own pair-pass tiles and on the
   adversarial tiles with random labels (K 32 to 1024: the 1024 launch opts
   in to more shared memory), with every label distinct (no pair may
   collide: count 0, every ft INF) and every label 0 (the unlabelled
   kernel's bits); the v4 and v2 forms against an f64 truth on SMALL's
   tiles (the v4 centre is the whole row's mean);
i. the cell sums kernel on SMALL's tiles: within rtol 1e-6 of the plain
   version on the card (atomics in any order), bit for bit equal to the
   plain version on the CPU (slot order) and to itself in a second run;
j. SMALL through the census (supercell, S = 10), against the JAX package's
   f32 result and the port's f32 sweep on the card; both new kernels must
   launch; no host sync in the run loop; cuda == cpu on an uneven
   partition (7 5.0 25 400, S = 3 over 25 cells);
k. the CLI's fast route at SMALL in-process (the labelled kernel launched);
l. SMALL's step time, device time, idle share, launches and syncs a step.

Then the banded engine (row bands of cells, each band with its own K, in one
slot pool):

m. UNEVEN through the default census: banded on its 13-band plan
   (``launch_sweep.UNEVEN_BANDS``); after 2 steps the JAX f32 engine's 14
   collisions and particle 0; the fused kernel launched;
n. 10 steps of banded against 10 of dense on the card;
o. no host sync in a banded run; cuda == cpu on (-7 100 12 4000) with
   four bands of K 64 to 256 (the v4 form) and on (5 8 8 600) with four
   2-row bands (the v2 form);
p. the fused kernel on the banded run's own tiles of the K = 896 and K = 32
   bands (checked, timed, with the bound), and the lanes each band's pair
   pass needs (Σc² over rows·K²) against one tier at K = 864;
q. UNEVEN banded, tiered and dense timed one after another: step time,
   device time, idle share, launches and syncs a step;
r. N = 1e7 (seed 1, side 5000, ncside 316): the census's streaming route
   (banded on 12 bands of 27 rows, K 192), 10 steps against 10 of
   resident, and both timed.

Each path runs with the kernel launch counts set to 0 just before and read
just after, and fails if a kernel of the path did not launch. Two steps of
each tile engine's run loop run under
``torch.cuda.set_sync_debug_mode("error")``; each engine on the GPU is
compared with the same engine on the CPU; the flagship, UNEVEN and sweep
steps are timed and their device time broken down by kernel
(torch.profiler), with the kernel launches and host synchronisations a
step. Any failure raises (non-zero exit). The last two lines of standard
output are one JSON object with a record per kernel and one JSON object
naming the device.

Kernel times: CUDA events around each call, median of 20. ``ms`` (the
record's time) times each call alone on an idle card, the wrapper's host
work before the launch included; ``device_ms`` queues the calls behind a
spin kernel, so that the events bracket the kernels alone. The launch
shapes the wrappers' rules pick come from ``ops/cuda/launch_sweep.py``.

Tolerances:
  * collision outputs (ft, count, collisions, dead set) are exact;
  * kernel forces hold to the plain version within 1e-5·|f| + 1e-6·max|f|
    plus (K + 8)·2^-24 of the summed magnitudes of the terms of each force:
    the worst-case rounding of a (K + 8)-term sequential f32 sum (the
    kernels sum partners one by one, the plain versions pairwise), with a
    few ulps for each term (rsqrtf differs from torch.rsqrt by an ulp or
    so). The terms matter where they cancel: on near pairs, and in the v4
    form always;
  * the v1 kernel equals the gated kernel in the v2 form bit for bit: the
    same arithmetic in the same order;
  * golden s1: particle 0 within ±0.002 of (3936.506, 131.472) (the JAX f32
    engine on a CPU lands 0.0008 from the golden y; the GPU sums in another
    order); UNEVEN after 2 steps: within ±0.002 of the JAX f32 engine's
    (2748.5098, 2624.1592) on a CPU;
  * tiered vs dense on the card: positions within 2e-5·side (f32 reduction
    trees of another shape, tests/test_tiered.py's tolerance);
  * GPU vs CPU runs: positions within 1e-6·side, velocities within
    1e-5·max|v|; the parity engine bit for bit;
  * parity golden vectors: the reference harness's ±0.001 (the CLI's
    three-decimal lines exactly); the f32 sweep on golden s1: ±0.002, as
    the tile engines; MEDIUM's particle 0 against golden s3 is printed,
    not held;
  * the labelled kernel: as the fused kernel, its tolerance's terms summed
    over the pairs of equal labels; all labels 0: bit for bit the
    unlabelled kernel;
  * cell sums: rtol 1e-6 against the plain version on the card (a cell's
    few non-negative terms added in another order), bit for bit against it
    on the CPU;
  * SMALL: the JAX f32 engine's collision count exactly and particle 0
    within ±0.002; against the port's f32 sweep on the card, the count and
    dead set exact and positions within 1e-3 (the JAX package's
    tests/test_supercell.py tolerance);
  * banded UNEVEN: as tiered (the same function); against dense, positions
    within 2e-5·side; at 1e7 against resident, the count and dead set exact
    and positions within 1e-6·side (the same function on the same cell
    rows, another split of the pool).

Bounds: a kernel's bound is the larger of its bytes over 3.35 TB/s and
its f32 operations over 67 TFLOP/s (H100 SXM data sheet), counted from
this run's tiles. Bytes: each output written once, each input read once
where the function needs it: masses, alive flags and pids of every slot,
x and y only of the slots that take part (used ones, m > 0, for a force,
alive ones for a collision). Operations: 14 per ordered pair of used slots
for the v2 force, 15 for v4, 14 per monopole term (an FMA counts 2, an
rsqrt 1); the labelled kernel's pairs are only those of equal labels (the
function's sum of c² over the cells, where the kernel tests all n² used
pairs of a row). The cell sums move 16 bytes a slot and 12 a true cell. The collision test's operations are not counted: it need test
only the pairs near in x (a few per alive slot, 6 ops each), which cost
little beside the row's bytes. The rsqrt count is shown against the SFU
rate, 16 per SM and clock: 1/16 of the f32 rate.
"""

import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_S1 = (1, 5000.0, 100, 1_000_000, 4, 3936.506, 131.472, 4)
GOLDEN_TOL = 0.002
# The reference harness's golden vectors (reference serial/run_tests.sh and
# openMP/new_tests.sh) that the parity phases run: s0 and the five small
# ones; and MEDIUM (golden s3's config), whose golden values are printed
# beside the f32 sweep's but not held (f32 over 10 steps at ~2500
# particles a cell has no measured tolerance).
GOLDEN_S0 = (-50, 10000.0, 200, 500_000, 10, 5025.384, 5303.928, 4)
FAST_VECTORS = (
    (1, 2.0, 3, 10, 1, 1.570, 0.056, 0),
    (1, 1.0, 5, 100, 1, 0.786, 0.027, 0),
    (-10, 3.0, 3, 100, 10, 1.733, 1.643, 2),
    (5893, 0.05, 3, 10, 10, 0.002, 0.035, 2),
    (8555, 0.05, 3, 10, 10, 0.016, 0.049, 1),
)
PARITY_TOL = 0.001
MEDIUM = (1, 5000.0, 20, 1_000_000, 10)
GOLDEN_S3 = (3918.912, 143.364, 19)
# Parity on cuda against parity on cpu, bit for bit: several deaths in one
# cell; ~156 particles a cell.
CARD_VS_CPU = ((8555, 0.05, 3, 30, 20), (1, 100.0, 8, 10_000, 10))
# UNEVEN: the reference report's clustered workload; the JAX f32 engine's
# tiered result after 2 steps on a CPU (its plan_tiers plan is
# launch_sweep.UNEVEN_PLAN).
UNEVEN = (-23, 5000.0, 100, 1_000_000)
UNEVEN_2 = (2748.5098, 2624.1592, 14)
# SMALL (BASELINE.md): the JAX f32 sweep's result after 10 steps on a CPU,
# (7907.595703125, 7537.66015625, 1); the JAX supercell engine gives the
# same.
SMALL = (50, 10000.0, 1300, 500_000, 10)
SMALL_10 = (7907.5957, 7537.6602, 1)
SMALL_S = 10
# The TPU kernel body each kernel replaces (file:line).
REPLACES = {
    "fused_pairs": "particlesimulation_tpu/ops/pallas/cell_pairs.py:248",
    "fused_pairs_v1": "particlesimulation_tpu/ops/pallas/cell_pairs.py:166",
    "dense_pairwise_forces":
        "particlesimulation_tpu/ops/pallas/cell_pairs.py:45",
    "dense_collisions": "particlesimulation_tpu/ops/pallas/cell_pairs.py:112",
    # XLA code of the JAX package (no Pallas kernel): the `sub` argument of
    # fused_pairs_v2 / _v4, and the supercell per-cell one-hot sums.
    "fused_pairs_sub": "particlesimulation_tpu/ops/dense_xla.py:330",
    "supercell_cell_sums": "particlesimulation_tpu/ops/supercell.py:209",
}
SOURCE = "particlesimulation_tpu_torch/csrc/cell_pairs.cu"
# The kernels' names in csrc/cell_pairs.cu, as the profiler reports them.
PORT_KERNELS = ("fused_pairs_kernel", "dense_forces_kernel",
                "dense_collisions_kernel", "cell_sums_kernel")

PEAK_BYTES = 3.35e12   # B/s, HBM3
PEAK_F32 = 67e12       # FLOP/s outside the tensor cores
PEAK_SFU = PEAK_F32 / 16


def _timed(fn, reps):
    """Median milliseconds of ``fn`` over ``reps`` calls, each on an idle
    card between CUDA events: the host's work up to the launch included, as
    a caller that waits for each call sees it."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _kernel_times(kernel, plain):
    """The record's times: the kernel's per-call and device ms (median of
    20), the plain version's per-call ms (median of 3)."""
    from particlesimulation_tpu_torch.ops.cuda.launch_sweep import device_ms

    return {"ms": _timed(kernel, 20), "device_ms": device_ms(kernel, 20),
            "plain_ms": _timed(plain, 3)}


def _tiles(ncells, kcap, fill, seed, device):
    """Slot tiles shaped like the flagship's: cells 50 wide on a 100-column
    grid, Poisson(fill) occupied slots with the flagship's mass scale, empty
    slots zeroed, colliding chains planted in every 50th cell, pids permuted
    per row."""
    from particlesimulation_tpu_torch.config import EPSILON, EPSILON2, G

    rng = np.random.default_rng(seed)
    w = 50.0
    cell = np.arange(ncells)
    x = ((cell % 100)[:, None] + rng.uniform(size=(ncells, kcap))) * w
    y = ((cell // 100)[:, None] + rng.uniform(size=(ncells, kcap))) * w
    m = rng.uniform(size=(ncells, kcap)) * 0.01 * 1e4 / 1e6 / G * EPSILON2
    occ = np.arange(kcap)[None, :] < np.minimum(
        rng.poisson(fill, ncells), kcap)[:, None]
    for c in range(0, ncells, 50):
        occ[c, :3] = True
        x[c, 1] = x[c, 0] + EPSILON / 3
        x[c, 2] = x[c, 1] + EPSILON / 3
        y[c, 1:3] = y[c, 0]
    x, y, m = (np.where(occ, a, 0.0).astype(np.float32) for a in (x, y, m))
    pid = np.argsort(rng.uniform(size=(ncells, kcap)), axis=1)
    arrays = (x, y, m, occ.astype(np.int32), pid.astype(np.int32))
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def _stencil(x, y, m):
    """(ncells, 8) stencil rows from the tiles' COM, on the 100 x 100 grid
    of 50-wide cells that ``_tiles`` lays rows out on."""
    from particlesimulation_tpu_torch.ops import stencil

    n = x.shape[0]
    sums = torch.zeros(3, 10_000, dtype=torch.float32, device=x.device)
    sums[0, :n] = m.sum(1)
    sums[1, :n] = (m * x).sum(1)
    sums[2, :n] = (m * y).sum(1)
    return [t[:n].contiguous()
            for t in stencil.tables_from_sums(*sums, 5000.0, 100)]


def _term_sums(x, y, m_post, form, tables=None, sub=None):
    """Per slot and axis, the summed magnitudes of the force's terms (the
    monopole terms too, given the stencil tables; only the pairs of equal
    labels, given ``sub``)."""
    from particlesimulation_tpu_torch.config import G

    out = []
    for c0 in range(0, x.shape[0], 64):
        xs, ys, ms = (a[c0:c0 + 64].double() for a in (x, y, m_post))
        if sub is not None:
            ls = sub[c0:c0 + 64]
        if form == "v4":
            used = ms > 0
            n = used.sum(1, keepdim=True).clamp(min=1)
            xs = xs - (xs * used).sum(1, keepdim=True) / n
            ys = ys - (ys * used).sum(1, keepdim=True) / n
        dx = xs[:, None, :] - xs[:, :, None]
        dy = ys[:, None, :] - ys[:, :, None]
        d2 = dx * dx + dy * dy
        inv3 = torch.where(d2 > 0, d2.clamp(min=1e-300) ** -1.5, 0.0)
        w = ms[:, None, :] * inv3 * (G * ms)[:, :, None]
        if sub is not None:
            w = w * (ls[:, None, :] == ls[:, :, None])
        if form == "v4":
            bx = (w * (xs.abs()[:, :, None] + xs.abs()[:, None, :])).sum(2)
            by = (w * (ys.abs()[:, :, None] + ys.abs()[:, None, :])).sum(2)
        else:
            bx = (w * dx.abs()).sum(2)
            by = (w * dy.abs()).sum(2)
        if tables is not None:
            ml, mxl, myl = (t[c0:c0 + 64].double() for t in tables)
            dlx = mxl[:, None, :] - xs[:, :, None]
            dly = myl[:, None, :] - ys[:, :, None]
            d2l = dlx * dlx + dly * dly
            wl = (ml[:, None, :] * torch.where(
                d2l > 0, d2l.clamp(min=1e-300) ** -1.5, 0.0)
                * (G * ms)[:, :, None])
            bx = bx + (wl * dlx.abs()).sum(2)
            by = by + (wl * dly.abs()).sum(2)
        out.append((bx, by))
    return [torch.cat(b) for b in zip(*out)]


def _force_err(got, ref, terms, kcap, tag):
    """Max |kernel - plain| over both axes; raises beyond the tolerance."""
    max_err = 0.0
    for a, b, t in zip(got, ref, terms):
        err = (a.double() - b.double()).abs()
        tol = (1e-5 * b.double().abs() + 1e-6 * float(b.abs().max())
               + (kcap + 8) * 2.0 ** -24 * t)
        if not bool((err <= tol).all()):
            raise AssertionError(f"{tag}: force off by {float(err.max())}")
        max_err = max(max_err, float(err.max()))
    return max_err


def _bound(nbytes, ops, rsqrt):
    """(bound_ms, bound_by, sfu_ms) of a kernel's work."""
    mem_ms = nbytes / PEAK_BYTES * 1e3
    ops_ms = ops / PEAK_F32 * 1e3
    return (max(mem_ms, ops_ms), "bytes" if mem_ms >= ops_ms else "operations",
            rsqrt / PEAK_SFU * 1e3)


def _pairs(mask, sub=None):
    """(ordered pairs, unordered pairs) of set slots, summed over rows; only
    the pairs of equal labels, given ``sub`` (labels >= 0 on set slots)."""
    if sub is None:
        n = mask.sum(1).double()
    else:
        nlab = int(sub.max()) + 2
        row = torch.arange(sub.shape[0], device=sub.device)[:, None]
        key = (row * nlab + sub + 1)[mask]
        n = torch.bincount(key).double()
    return float((n * (n - 1)).sum()), float((n * (n - 1) / 2).sum())


def _force_bound(x, m):
    """(bound_ms, bound_by, sfu_ms) of the dense force kernel on tiles: m
    read and fx, fy written for every slot, x and y read for the used
    ones, 96 bytes of stencil rows a cell."""
    p_force, _ = _pairs(m > 0)
    used = float((m > 0).sum())
    return _bound(12 * x.numel() + 8 * used + 96 * x.shape[0],
                  14 * p_force + 8 * 14 * used, p_force + 8 * used)


def _collision_bound(x, alive, with_pid=False):
    """(bound_ms, bound_by, sfu_ms) of the collision kernel on tiles, bytes
    only: alive (and pid) read and ft written for every slot, x and y read
    for the alive ones, the count written."""
    n_alive = float((alive > 0).sum())
    return _bound((12 if with_pid else 8) * x.numel() + 8 * n_alive + 4,
                  0, 0)


def _report(tag, rec):
    print(f"{tag}: max|df|={rec['max_abs_err']:.3e}; kernel "
          f"{rec['ms']:.4f} ms a call ({rec['device_ms']:.4f} ms of device "
          f"time), plain {rec['plain_ms']:.4f} ms, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), rsqrt at the SFU "
          f"rate {rec['sfu_ms']:.4f} ms", flush=True)


def _check_collisions(got, ref, tag, planted=True):
    if not torch.equal(got[1], ref[1]):
        raise AssertionError(f"{tag}: ft differs in "
                             f"{int((got[1] != ref[1]).sum())} slots")
    if int(got[0]) != int(ref[0]):
        raise AssertionError(f"{tag}: count {int(got[0])} != {int(ref[0])}")
    if planted and int(ref[0]) == 0:
        raise AssertionError(f"{tag}: the planted chains did not collide")


def check_fused(ncells, kcap, fill, form, collide, gated=True):
    """The fused kernel on synthetic flagship-like tiles (``_tiles``)."""
    return fused_record(f"({ncells}, {kcap})",
                        _tiles(ncells, kcap, fill, kcap + ncells, "cuda"),
                        form, collide, gated)


def fused_record(where, tiles, form, collide, gated=True, planted=True,
                 sub=None):
    """Fused pair kernel vs plain version on (x, y, mf, alive, pid) tiles on
    the card (labelled by ``sub``, where given); the measured numbers. The
    ungated (v1) kernel must also equal the gated one bit for bit."""
    from particlesimulation_tpu_torch.config import EPSILON
    from particlesimulation_tpu_torch.ops.cuda import cell_pairs

    x, y, m, alive, pid = tiles
    kcap = x.shape[1]
    args = (x, y, m, alive, pid, kcap, EPSILON, collide, form)
    kw = {} if sub is None else {"sub": sub}
    got = cell_pairs.fused_pairs(*args, gated=gated, **kw)
    ref = cell_pairs.fused_pairs_ref(*args, **kw)
    torch.cuda.synchronize()
    name = "fused_pairs_sub" if sub is not None else (
        "fused_pairs" if gated else "fused_pairs_v1")
    tag = f"{name} {form} collide={collide} {where}"
    if collide:
        _check_collisions((got[2], got[3]), (ref[2], ref[3]), tag, planted)
    elif not torch.equal(got[3], ref[3]) or int(got[2]) != 0:
        raise AssertionError(f"{tag}: collisions reported with collide off")
    if not gated:
        gated_out = cell_pairs.fused_pairs(*args)
        if not all(torch.equal(a, b) for a, b in zip(got, gated_out)):
            raise AssertionError(f"{tag}: not bitwise equal to the gated "
                                 f"kernel")
    m_post = torch.where(ref[3] != cell_pairs.INF, 0.0, m)
    max_err = _force_err(got[:2], ref[:2],
                         _term_sums(x, y, m_post, form, sub=sub), kcap, tag)
    # mf read and fx, fy, ft written for every slot, alive and pid too with
    # collide on, and the label; x and y read for the alive or used ones.
    p_force, _ = _pairs(m_post > 0, sub)
    n_xy = float((((alive > 0) & collide) | (m > 0)).sum())
    bound_ms, bound_by, sfu_ms = _bound(
        ((24 if collide else 16) + (0 if sub is None else 4)) * x.numel()
        + 8 * n_xy + 4, (15 if form == "v4" else 14) * p_force, p_force)
    rec = {"max_abs_err": max_err,
           **_kernel_times(
               lambda: cell_pairs.fused_pairs(*args, gated=gated, **kw),
               lambda: cell_pairs.fused_pairs_ref(*args, **kw)),
           "bound_ms": bound_ms, "bound_by": bound_by, "sfu_ms": sfu_ms}
    if sub is not None:
        rec["pairs"] = (_pairs(m_post > 0)[0], p_force)
        print(f"{tag}: the kernel tests {rec['pairs'][0]:.0f} ordered used "
              f"pairs (n² a row), the function needs {p_force:.0f} (Σc² a "
              f"cell)", flush=True)
    _report(f"{tag}: ft, count={int(got[2])} exact", rec)
    return rec


def check_dense_forces(ncells, kcap, fill):
    from particlesimulation_tpu_torch.ops.cuda import cell_pairs

    x, y, m, _, _ = _tiles(ncells, kcap, fill, kcap + ncells + 1, "cuda")
    tables = _stencil(x, y, m)
    args = (x, y, m, *tables, kcap)
    got = cell_pairs.dense_pairwise_forces(*args)
    ref = cell_pairs.dense_pairwise_forces_ref(*args)
    torch.cuda.synchronize()
    tag = f"dense_pairwise_forces ({ncells}, {kcap})"
    max_err = _force_err(got, ref, _term_sums(x, y, m, "v2", tables), kcap,
                         tag)
    bound_ms, bound_by, sfu_ms = _force_bound(x, m)
    rec = {"max_abs_err": max_err,
           **_kernel_times(
               lambda: cell_pairs.dense_pairwise_forces(*args),
               lambda: cell_pairs.dense_pairwise_forces_ref(*args)),
           "bound_ms": bound_ms, "bound_by": bound_by, "sfu_ms": sfu_ms}
    _report(tag, rec)
    return rec


def check_dense_collisions(ncells, kcap, fill, with_pid):
    from particlesimulation_tpu_torch.config import EPSILON
    from particlesimulation_tpu_torch.ops.cuda import cell_pairs

    x, y, _, alive, pid = _tiles(ncells, kcap, fill, kcap + ncells + 2,
                                 "cuda")
    args = (x, y, alive, kcap, EPSILON, pid if with_pid else None)
    got = cell_pairs.dense_collisions(*args)
    ref = cell_pairs.dense_collisions_ref(*args)
    torch.cuda.synchronize()
    tag = (f"dense_collisions {'pid' if with_pid else 'no pid'} "
           f"({ncells}, {kcap})")
    _check_collisions(got, ref, tag)
    bound_ms, bound_by, sfu_ms = _collision_bound(x, alive, with_pid)
    rec = {"max_abs_err": 0.0,
           **_kernel_times(lambda: cell_pairs.dense_collisions(*args),
                           lambda: cell_pairs.dense_collisions_ref(*args)),
           "bound_ms": bound_ms, "bound_by": bound_by, "sfu_ms": sfu_ms}
    _report(f"{tag}: ft, count={int(got[0])} exact", rec)
    return rec


def check_adversarial(kcap):
    """The adversarial tiles (ops/cuda/adversarial.py: a row whose only
    alive slots are the last two, holes, an empty row, a 48-particle
    cluster, a full row, a vertical line of near pairs, a row whose alive
    slots all collide, a row with one used slot) through the dense kernels
    and the fused kernels, against the plain versions: ft and count exact,
    forces within the tolerance, v1 bitwise equal to the gated kernel."""
    from particlesimulation_tpu_torch.config import EPSILON
    from particlesimulation_tpu_torch.ops.cuda import cell_pairs
    from particlesimulation_tpu_torch.ops.cuda.adversarial import (
        adversarial_tiles)

    x, y, m, alive, pid = (torch.from_numpy(a).cuda()
                           for a in adversarial_tiles(kcap, kcap))
    rng = np.random.default_rng(kcap)
    tables = [torch.from_numpy(rng.uniform(lo, hi, (x.shape[0], 8)).astype(
        np.float32)).cuda() for lo, hi in ((5.0, 50.0), (-1.0, 2.0),
                                           (-1.0, 2.0))]
    tag = f"adversarial K={kcap}"
    counts = []
    for p in (None, pid):
        args = (x, y, alive, kcap, EPSILON, p)
        got = cell_pairs.dense_collisions(*args)
        _check_collisions(got, cell_pairs.dense_collisions_ref(*args),
                          f"{tag} dense_collisions pid={p is not None}")
        counts.append(int(got[0]))
    args = (x, y, m, *tables, kcap)
    err = _force_err(cell_pairs.dense_pairwise_forces(*args),
                     cell_pairs.dense_pairwise_forces_ref(*args),
                     _term_sums(x, y, m, "v2", tables), kcap,
                     f"{tag} dense_pairwise_forces")
    for form in ("v4", "v2"):
        args = (x, y, m, alive, pid, kcap, EPSILON, True, form)
        got = cell_pairs.fused_pairs(*args)
        ref = cell_pairs.fused_pairs_ref(*args)
        _check_collisions((got[2], got[3]), (ref[2], ref[3]),
                          f"{tag} fused_pairs {form}")
        m_post = torch.where(ref[3] != cell_pairs.INF, 0.0, m)
        _force_err(got[:2], ref[:2], _term_sums(x, y, m_post, form), kcap,
                   f"{tag} fused_pairs {form}")
        if form == "v2":
            v1 = cell_pairs.fused_pairs(*args, gated=False)
            if not all(torch.equal(a, b) for a, b in zip(v1, got)):
                raise AssertionError(f"{tag}: v1 not bitwise equal to the "
                                     f"gated kernel")
    torch.cuda.synchronize()
    print(f"{tag}: dense_collisions ft, count={counts[0]} (no pid), "
          f"{counts[1]} (pid) exact; dense_pairwise_forces max|df|="
          f"{err:.3e}; fused v4, v2, v1 exact on ft and count, v1 = gated",
          flush=True)


def check_tiles(label, tile_sets):
    """Both dense kernels on a path's own tiles, one (x, y, m, ml, mxl,
    myl) set per launch of each kernel in a step (one for dense, one per
    class for tiered): each held against the plain versions (forces within
    the tolerance, ft and count exact), timed, with its bound; then the
    sums over the sets, a step's worth."""
    from particlesimulation_tpu_torch.config import EPSILON
    from particlesimulation_tpu_torch.ops.cuda import cell_pairs
    from particlesimulation_tpu_torch.ops.cuda.launch_sweep import device_ms

    names = ("dense_pairwise_forces", "dense_collisions")
    sums = {k: [0.0, 0.0, 0.0] for k in names}  # ms a call, device, bound
    for x, y, m, ml, mxl, myl in tile_sets:
        rows, kcap = x.shape
        alive = (m > 0).to(torch.int32)
        fargs = (x, y, m, ml, mxl, myl, kcap)
        cargs = (x, y, alive, kcap, EPSILON)
        tag = f"{label} tiles ({rows}, {kcap})"
        err = _force_err(cell_pairs.dense_pairwise_forces(*fargs),
                         cell_pairs.dense_pairwise_forces_ref(*fargs),
                         _term_sums(x, y, m, "v2", (ml, mxl, myl)), kcap, tag)
        _check_collisions(cell_pairs.dense_collisions(*cargs),
                          cell_pairs.dense_collisions_ref(*cargs), tag,
                          planted=False)
        out = []
        for name, fn, bound in (
                (names[0], lambda: cell_pairs.dense_pairwise_forces(*fargs),
                 _force_bound(x, m)[0]),
                (names[1], lambda: cell_pairs.dense_collisions(*cargs),
                 _collision_bound(x, alive)[0])):
            times = (_timed(fn, 20), device_ms(fn, 20), bound)
            sums[name] = [a + b for a, b in zip(sums[name], times)]
            out.append("{} {:.4f} ms a call, {:.4f} device (bound {:.4f})"
                       .format(name, *times))
        print(f"{tag}, {int(alive.sum(1).max())} alive at most, "
              f"max|df|={err:.2e}, ft and count exact: " + "; ".join(out),
              flush=True)
    print(f"{label}, summed over its {len(tile_sets)} tile set(s): "
          + "; ".join("{} {:.4f} ms a call, {:.4f} device (bound {:.4f})"
                      .format(k, *v) for k, v in sums.items()), flush=True)


def drive(label, eng, state, steps, kernels):
    """One run of a path with the launch counts set to 0 just before it and
    read just after; fails if a kernel of the path did not launch."""
    from particlesimulation_tpu_torch.ops.cuda import cell_pairs

    torch.cuda.synchronize()
    cell_pairs.reset_launches()
    out = eng.run(state, steps)
    torch.cuda.synchronize()
    launches = dict(cell_pairs.LAUNCHES)
    x, y, c = eng.result(out)
    finite = bool(torch.isfinite(out.x).all() and torch.isfinite(out.y).all())
    print(f"{label} on cuda: {eng.impl}, kcap {eng.kcap}, particle 0 "
          f"({x:.4f}, {y:.4f}), collisions {c}, overflow "
          f"{int(out.overflow)}, launches {launches}", flush=True)
    if not (finite and out.x.shape == state.x.shape
            and int(out.overflow) == 0):
        raise AssertionError(f"{label}: non-finite, misshapen or overflowed")
    if not all(launches[k] > 0 for k in kernels):
        raise AssertionError(f"{label}: a kernel of the path did not launch")
    return out, (x, y, c), launches


def check_golden(label, eng, state, steps, golden, kernels):
    """A path's run against known values of particle 0 and the count."""
    ex, ey, ec = golden
    out, (x, y, c), launches = drive(label, eng, state, steps, kernels)
    if not (c == ec and abs(x - ex) <= GOLDEN_TOL and abs(y - ey) <= GOLDEN_TOL):
        raise AssertionError(f"{label}: ({x}, {y}, {c}) vs ({ex}, {ey}, {ec})")
    return out, launches


def check_no_sync(label, run, state):
    """The run loop must not synchronise with the host: any synchronising
    CUDA call inside it raises here."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        run(state, 2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print(f"{label} run loop: no host synchronisation in 2 steps", flush=True)


def _by_pid(state):
    order = torch.argsort(state.pid)
    return {f: getattr(state, f)[order].cpu()
            for f in ("x", "y", "vx", "alive")}


def compare_runs(label, a, b, pos_tol, v_tol):
    """Collisions and dead sets exact; positions and velocities within the
    given fractions of side and max|v|."""
    (ca, sa, side), (cb, sb, _) = a, b
    ga, gb = _by_pid(sa), _by_pid(sb)
    if ca != cb or not torch.equal(ga["alive"], gb["alive"]):
        raise AssertionError(f"{label}: collisions {ca} vs {cb}, dead sets "
                             f"equal: {torch.equal(ga['alive'], gb['alive'])}")
    dpos = max(float((ga[f] - gb[f]).abs().max()) for f in ("x", "y"))
    dvx = float((ga["vx"] - gb["vx"]).abs().max())
    vmax = float(gb["vx"].abs().max())
    if dpos > pos_tol * side or (v_tol is not None and dvx > v_tol * vmax):
        raise AssertionError(f"{label}: |dx|={dpos}, |dvx|={dvx}")
    print(f"{label}: collisions {ca} = {cb}, dead sets equal, "
          f"max|dpos|={dpos:.3e}, max|dvx|={dvx:.3e}", flush=True)


def check_gpu_vs_cpu(seed, side, nc, n, steps, impl=None, plan=None):
    from particlesimulation_tpu_torch.config import SimConfig
    from particlesimulation_tpu_torch.engine import Engine

    outs = []
    for device in ("cuda", "cpu"):
        eng = Engine(SimConfig(seed, side, nc, n), impl=impl, device=device)
        state = eng.init_state()
        if plan is not None:
            eng._band_plan = plan
        out = eng.run(state, steps)
        if int(out.overflow) != 0:
            raise AssertionError(f"overflow on {device}")
        if impl is not None and eng.impl != impl:
            raise AssertionError(f"{impl} escalated to {eng.impl}")
        outs.append((int(out.collisions), out, side))
    compare_runs(f"cuda vs cpu, {eng.impl} ({seed} {side} {nc} {n}, {steps} "
                 f"steps)", *outs, 1e-6, 1e-5)


def step_ms(eng, state, k, reps=2):
    """Per-step ms as (t(run k+1) - t(run 1)) / k, best of ``reps``."""
    def run_seconds(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        o = eng.run(state, steps)
        torch.cuda.synchronize()
        if int(o.overflow) != 0:
            raise AssertionError("overflow in the timed run")
        return time.perf_counter() - t

    t1 = min(run_seconds(1) for _ in range(reps))
    tk = min(run_seconds(k + 1) for _ in range(reps))
    return (tk - t1) / k * 1e3, t1, tk


def _profile(eng, state, steps):
    """(device ms, kernel launches) of one run of ``steps``, by name:
    [(ms, launches, name)], from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.run(state, steps)
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0:
            copy = evt.key.startswith(("Memcpy", "Memset"))
            rows.append((us / 1e3, 0 if copy else evt.count, evt.key))
    return rows


def _syncs(eng, state, steps):
    """Host synchronisations (readbacks) in one run of ``steps``: the
    warnings of torch's CUDA sync debug mode, one per synchronising call."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng.run(state, steps)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def device_breakdown(label, eng, state, step_ms_host, steps=10):
    """Device time per step by kernel name (torch.profiler over a run of
    ``steps``, its prologue and epilogue included), the share of the
    unprofiled step the device is idle, and per step the kernel launches
    and host synchronisations (a run of ``steps`` less a run of 0)."""
    rows = _profile(eng, state, steps)
    rows0 = _profile(eng, state, 0)
    launches = (sum(n for _, n, _ in rows) - sum(n for _, n, _ in rows0)) / steps
    syncs = (_syncs(eng, state, steps) - _syncs(eng, state, 0)) / steps
    rows = sorted(((ms / steps, key) for ms, _, key in rows), reverse=True)
    total = sum(ms for ms, _ in rows)
    top = "; ".join(f"{key[:48]} {ms:.4f}" for ms, key in rows[:8])
    ours = {name: sum(ms for ms, key in rows if name in key)
            for name in PORT_KERNELS}
    print(f"{label}: device {total:.4f} ms/step of {step_ms_host:.4f} "
          f"ms/step, idle {1 - total / step_ms_host:.1%}; {launches:.1f} "
          f"kernel launches and {syncs:.2f} host synchronisations a step; "
          f"by kernel (ms/step): {top}; the port's kernels (ms/step): "
          + ", ".join(f"{k} {v:.4f}" for k, v in ours.items() if v > 0),
          flush=True)
    return {"device_ms": total, "idle": 1 - total / step_ms_host,
            "launches": launches, "syncs": syncs}


def _parity(seed, side, nc, n, device):
    from particlesimulation_tpu_torch.config import Precision, SimConfig
    from particlesimulation_tpu_torch.engine import Engine

    return Engine(SimConfig(seed, side, nc, n, precision=Precision.PARITY),
                  device=device)


def check_cli_parity():
    """(a) The CLI as a user runs it, with the default engine (parity) and
    device (cuda): golden s1's exact output lines, and "%.1fs" on stderr."""
    seed, side, nc, n, steps, ex, ey, ec = GOLDEN_S1
    args = [str(seed), str(int(side)), str(nc), str(n), str(steps)]
    t = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "particlesimulation_tpu_torch",
                        *args], cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    lines = r.stdout.splitlines()
    timing = (r.stderr.strip().splitlines() or [""])[-1]
    want = [f"{ex:.3f} {ey:.3f}", str(ec)]
    if r.returncode != 0 or lines != want or not re.fullmatch(
            r"\d+\.\ds", timing):
        raise AssertionError(f"CLI parity {args}: rc {r.returncode}, stdout "
                             f"{lines}, stderr {r.stderr[-2000:]}")
    print(f"CLI parity {' '.join(args)} on cuda: {lines} (the golden "
          f"values), {timing} on stderr, {time.perf_counter() - t:.1f} s "
          f"with the process start", flush=True)


def check_parity_golden():
    """(b) Golden s0 and the five small golden vectors through the parity
    engine on cuda: the reference harness's ±0.001, the count exact."""
    for seed, side, nc, n, steps, ex, ey, ec in (GOLDEN_S0,) + FAST_VECTORS:
        eng = _parity(seed, side, nc, n, "cuda")
        out = eng.run(eng.init_state(), steps)
        x, y, c = eng.result(out)
        print(f"parity golden {seed} {side} {nc} {n} {steps} on cuda: "
              f"({x:.6f}, {y:.6f}), {c} collisions; golden ({ex}, {ey}), "
              f"{ec}", flush=True)
        if not (eng.impl == "sweep" and out.x.dtype == torch.float64
                and c == ec and abs(x - ex) <= PARITY_TOL
                and abs(y - ey) <= PARITY_TOL):
            raise AssertionError(f"parity golden {seed} {side} {nc} {n}")


def check_parity_card_vs_cpu():
    """(c) The parity engine on cuda and on cpu, field by field with
    torch.equal: the card contracted nothing and took no reciprocal."""
    for seed, side, nc, n, steps in CARD_VS_CPU:
        outs = []
        for device in ("cuda", "cpu"):
            eng = _parity(seed, side, nc, n, device)
            outs.append(eng.run(eng.init_state(), steps))
        fields = ("x", "y", "vx", "vy", "m", "alive", "pid", "collisions")
        bad = [f for f in fields if not torch.equal(
            getattr(outs[0], f).cpu(), getattr(outs[1], f))]
        if bad:
            raise AssertionError(f"parity cuda vs cpu {seed} {side} {nc} "
                                 f"{n}: {bad} differ")
        print(f"parity cuda vs cpu ({seed} {side} {nc} {n}, {steps} steps): "
              f"{', '.join(fields)} bitwise equal; {int(outs[1].collisions)} "
              f"collisions", flush=True)


def check_f32_sweep():
    """(d) The f32 sweep: golden s1 within ±0.002 and 4 collisions; 1200
    particles in one cell through resident, where the ladder must end on
    the sweep."""
    from particlesimulation_tpu_torch.config import SimConfig
    from particlesimulation_tpu_torch.engine import Engine

    seed, side, nc, n, steps, ex, ey, ec = GOLDEN_S1
    eng = Engine(SimConfig(seed, side, nc, n), impl="sweep", device="cuda")
    out = eng.run(eng.init_state(), steps)
    x, y, c = eng.result(out)
    print(f"golden s1 f32 sweep on cuda: ({x:.4f}, {y:.4f}), {c} collisions, "
          f"overflow {int(out.overflow)}", flush=True)
    if not (eng.impl == "sweep" and c == ec and abs(x - ex) <= GOLDEN_TOL
            and abs(y - ey) <= GOLDEN_TOL and int(out.overflow) == 0):
        raise AssertionError("golden s1 f32 sweep")
    eng = Engine(SimConfig(1, 10.0, 1, 1200), impl="resident", device="cuda")
    out = eng.run(eng.init_state(), 2)
    print(f"1200 particles in one cell, from resident: the ladder ends on "
          f"{eng.impl}, overflow {int(out.overflow)}, collisions "
          f"{int(out.collisions)}", flush=True)
    if eng.impl != "sweep" or int(out.overflow) != 0:
        raise AssertionError("the ladder did not end on the sweep")


def check_medium():
    """(e) MEDIUM through the census: the ladder (resident -> dense ->
    sweep) ends on the sweep with overflow 0, and two runs give the same
    bits. Returns the engine and its initial state."""
    from particlesimulation_tpu_torch.config import SimConfig
    from particlesimulation_tpu_torch.engine import Engine

    seed, side, nc, n, steps = MEDIUM
    eng = Engine(SimConfig(seed, side, nc, n), device="cuda")
    state = eng.init_state()

    def timed_run(k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = eng.run(state, k)  # ends in a readback
        return out, time.perf_counter() - t

    first, t_ladder = timed_run(steps)
    second, t_k = timed_run(steps)
    t_1 = timed_run(1)[1]
    runs = [first, second]
    fields = ("x", "y", "vx", "vy", "m", "alive", "pid", "collisions")
    same = all(torch.equal(getattr(runs[0], f), getattr(runs[1], f))
               for f in fields)
    x, y, c = eng.result(runs[0])
    print(f"MEDIUM {seed} {side} {nc} {n}, {steps} steps on cuda: the census "
          f"and ladder end on {eng.impl} ({t_ladder:.1f} s with the ladder's "
          f"tile attempts), overflow {int(runs[0].overflow)}, two runs "
          f"bitwise equal: {same}; particle 0 ({x:.4f}, {y:.4f}), {c} "
          f"collisions (golden s3, f64: {GOLDEN_S3}; f32 not held to it)",
          flush=True)
    if eng.impl != "sweep" or int(runs[0].overflow) != 0 or not same:
        raise AssertionError("MEDIUM")
    # ms a step as step_ms defines it, from the second run and a run of 1.
    ms = (t_k - t_1) / (steps - 1) * 1e3
    print(f"MEDIUM f32 sweep: {ms:.4f} ms/step (run(1) {t_1:.4f} s, "
          f"run({steps}) {t_k:.4f} s)", flush=True)
    return eng, state, ms


def check_cli_fast(vec=GOLDEN_S1, kernel="fused_pairs"):
    """(f, k) The CLI's fast route in-process (golden s1 through the census:
    resident; SMALL: supercell), with the launch counts set to 0 just before
    it: ``kernel`` must have launched. Returns the launch counts."""
    from particlesimulation_tpu_torch import cli
    from particlesimulation_tpu_torch.ops.cuda import cell_pairs

    seed, side, nc, n, steps, ex, ey, ec = vec
    args = [str(seed), f"{side:g}", str(nc), str(n), str(steps),
            "--engine", "fast"]
    out, err = io.StringIO(), io.StringIO()
    torch.cuda.synchronize()
    cell_pairs.reset_launches()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(args)
    torch.cuda.synchronize()
    launches = dict(cell_pairs.LAUNCHES)
    lines = out.getvalue().splitlines()
    print(f"CLI {' '.join(args)} in-process on cuda: rc {rc}, {lines}, "
          f"{err.getvalue().strip()} on stderr, launches {launches}",
          flush=True)
    x, y = (float(v) for v in lines[0].split())
    if not (rc == 0 and len(lines) == 2 and int(lines[1]) == ec
            and abs(x - ex) <= GOLDEN_TOL and abs(y - ey) <= GOLDEN_TOL
            and launches[kernel] > 0):
        raise AssertionError("CLI fast")
    return launches


def time_sweeps(card, medium):
    """(g) ms a step of the sweep engine (step_ms over 4 steps; MEDIUM's
    from ``check_medium``'s runs): parity s1, f32 sweep s1, MEDIUM; each
    with its device time, idle share, launches and host syncs a step."""
    from particlesimulation_tpu_torch.config import SimConfig
    from particlesimulation_tpu_torch.engine import Engine

    seed, side, nc, n = GOLDEN_S1[:4]
    out = {}
    for label, eng, steps in (
            ("parity s1", _parity(seed, side, nc, n, "cuda"), 2),
            ("f32 sweep s1", Engine(SimConfig(seed, side, nc, n),
                                    impl="sweep", device="cuda"), 2),
            ("MEDIUM f32 sweep", medium[0], 1)):
        if eng is medium[0]:
            state, ms = medium[1:]
        else:
            state = eng.init_state()
            ms, t1, tk = step_ms(eng, state, 4, reps=1)
            print(f"{label}: {ms:.4f} ms/step (run(1) {t1:.4f} s, run(5) "
                  f"{tk:.4f} s)", flush=True)
        print(f"{label}, {eng.impl}: {ms:.4f} ms/step, "
              f"{state.x.shape[0] / ms / 1e3:.4f} M particle-steps/s on "
              f"{card}", flush=True)
        out[label] = {"ms": ms, **device_breakdown(label, eng, state, ms,
                                                   steps)}
    return out


def check_adversarial_labelled(kcap):
    """(h) The labelled fused kernel on the adversarial tiles: random labels
    and -1s (ft and count exact, forces within the tolerance); every label
    distinct (no pair shares a cell: count 0, every ft INF, forces 0, where
    the unlabelled kernel counts collisions); every label 0 (the unlabelled
    kernel's bits)."""
    from particlesimulation_tpu_torch.config import EPSILON
    from particlesimulation_tpu_torch.ops.cuda import cell_pairs
    from particlesimulation_tpu_torch.ops.cuda.adversarial import (
        adversarial_tiles)

    x, y, m, alive, pid = (torch.from_numpy(a).cuda()
                           for a in adversarial_tiles(kcap, kcap))
    rng = np.random.default_rng(kcap + 1)
    sub = torch.from_numpy(rng.integers(-1, 4, x.shape).astype(
        np.int32)).cuda()
    apart = torch.arange(kcap, dtype=torch.int32,
                         device="cuda").expand(x.shape).contiguous()
    tag = f"labelled adversarial K={kcap}"
    counts = []
    for form in ("v4", "v2"):
        args = (x, y, m, alive, pid, kcap, EPSILON, True, form)
        got = cell_pairs.fused_pairs(*args, sub=sub)
        ref = cell_pairs.fused_pairs_ref(*args, sub=sub)
        _check_collisions((got[2], got[3]), (ref[2], ref[3]),
                          f"{tag} {form}", planted=False)
        m_post = torch.where(ref[3] != cell_pairs.INF, 0.0, m)
        _force_err(got[:2], ref[:2], _term_sums(x, y, m_post, form, sub=sub),
                   kcap, f"{tag} {form}")
        plain = cell_pairs.fused_pairs(*args)
        alone = cell_pairs.fused_pairs(*args, sub=apart)
        if (int(alone[2]) != 0 or not bool((alone[3] == cell_pairs.INF).all())
                or bool(alone[0].abs().max() > 0) or int(plain[2]) == 0):
            raise AssertionError(f"{tag} {form}: distinct labels collided "
                                 f"or pulled")
        zero = cell_pairs.fused_pairs(*args, sub=torch.zeros_like(sub))
        if not all(torch.equal(a, b) for a, b in zip(zero, plain)):
            raise AssertionError(f"{tag} {form}: all labels 0 differ from "
                                 f"the unlabelled kernel")
        counts.append((int(got[2]), int(plain[2])))
    torch.cuda.synchronize()
    print(f"{tag}: v4, v2 ft and count exact (count {counts[0][0]} labelled, "
          f"{counts[0][1]} unlabelled); distinct labels: count 0, every ft "
          f"INF, no force; all labels 0 = the unlabelled kernel bit for bit",
          flush=True)


def v4_centre_error(tiles, sub):
    """(h) The labelled kernel's v2 and v4 forces (collide off) on a path's
    tiles against an f64 truth over the pairs of equal labels: the median
    and largest relative error over slots with a force, as
    tests/test_dense_kernels.py::test_v4_quantization_study measures it.
    The v4 centre is the mean of the row's used slots, S cells wide."""
    from particlesimulation_tpu_torch.config import EPSILON, G
    from particlesimulation_tpu_torch.ops.cuda import cell_pairs

    x, y, m, alive, pid = tiles
    kcap = x.shape[1]
    got = {form: cell_pairs.fused_pairs(x, y, m, alive, pid, kcap, EPSILON,
                                        collide=False, force_form=form,
                                        sub=sub)[0].double()
           for form in ("v2", "v4")}
    truth = []
    for c0 in range(0, x.shape[0], 256):
        xs, ys, ms = (a[c0:c0 + 256].double() for a in (x, y, m))
        ls = sub[c0:c0 + 256]
        dx = xs[:, None, :] - xs[:, :, None]
        dy = ys[:, None, :] - ys[:, :, None]
        d2 = dx * dx + dy * dy
        pair = (d2 > 0) & (ls[:, None, :] == ls[:, :, None])
        inv3 = torch.where(pair, d2.clamp(min=1e-300) ** -1.5, 0.0)
        truth.append((G * ms[:, :, None] * ms[:, None, :] * inv3 * dx).sum(2))
    truth = torch.cat(truth)
    has = truth != 0
    out = {}
    for form, f in got.items():
        rel = ((f - truth).abs() / truth.abs())[has]
        out[form] = (float(rel.median()), float(rel.max()))
    d = ((got["v4"] - got["v2"]).abs() / got["v2"].abs())[has]
    print(f"v4 row-wide centre on SMALL's tiles ({int(has.sum())} slots with "
          f"a pair force): relative error against f64, median / max: v2 "
          f"{out['v2'][0]:.3e} / {out['v2'][1]:.3e}, v4 {out['v4'][0]:.3e} / "
          f"{out['v4'][1]:.3e}; |v4 - v2|/|v2| median {float(d.median()):.3e}"
          f", max {float(d.max()):.3e}", flush=True)
    return out


def check_cell_sums(tiles, sub, cfg):
    """(i) The cell sums kernel on a path's tiles (its binned slots are those
    with a label): within rtol 1e-6 of the plain version on the card, bit
    for bit equal to the plain version on the CPU (slot order) and to a
    second run of itself; timed, with its bound."""
    from particlesimulation_tpu_torch.ops import resident as res
    from particlesimulation_tpu_torch.ops.cuda import cell_pairs

    x, y, m, _, _ = tiles
    cx, cy, _ = res.cell_of(x, y, cfg.side, cfg.ncside)
    cell = torch.where(sub >= 0, cy * cfg.ncside + cx, -1).to(torch.int32)
    args = (m, m * x, m * y, cell, cfg.ncells)
    got = cell_pairs.supercell_cell_sums(*args)
    again = cell_pairs.supercell_cell_sums(*args)
    ref = cell_pairs.supercell_cell_sums_ref(*args)
    cpu = cell_pairs.supercell_cell_sums_ref(*(a.cpu() for a in args[:4]),
                                             cfg.ncells)
    torch.cuda.synchronize()
    tag = f"supercell_cell_sums SMALL tiles {tuple(x.shape)}"
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{tag}: two runs differ")
    if not all(torch.equal(a.cpu(), b) for a, b in zip(got, cpu)):
        raise AssertionError(f"{tag}: differs from the plain version on "
                             f"the CPU")
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    if not all(bool(((a - b).abs() <= 1e-6 * b.abs()).all())
               for a, b in zip(got, ref)):
        raise AssertionError(f"{tag}: off by {err}")
    bound_ms, bound_by, _ = _bound(16 * x.numel() + 12 * cfg.ncells, 0, 0)
    rec = {"max_abs_err": err,
           **_kernel_times(lambda: cell_pairs.supercell_cell_sums(*args),
                           lambda: cell_pairs.supercell_cell_sums_ref(*args)),
           "bound_ms": bound_ms, "bound_by": bound_by, "sfu_ms": 0.0,
           **_cell_sums_library(args, ref)}
    _report(f"{tag}: {int((got[0] > 0).sum())} cells with mass; = itself "
            f"and the CPU plain version bit for bit, rtol 1e-6 of the card's",
            rec)
    print(f"{tag}: library call (one index_add_ of the stacked sources) "
          f"{rec['library_ms']:.4f} ms a call ({rec['library_device_ms']:.4f}"
          f" device), deterministic {rec['library_det_ms']:.4f} ms "
          f"({rec['library_det_device_ms']:.4f} device)", flush=True)
    return rec


def _cell_sums_library(args, ref):
    """The library call that computes the cell sums: one ``index_add_`` of
    the stacked (3, slots) sources into a (3, ncells + 1) output, unbinned
    slots into the extra column. Held to the plain version (rtol 1e-6) and
    timed as it runs by default (atomics, any order) and under
    ``torch.use_deterministic_algorithms`` (the same bits in every run, as
    the kernel gives). The port never calls it."""
    from particlesimulation_tpu_torch.ops.cuda.launch_sweep import device_ms

    mf, mfx, mfy, cell, ncells = args
    src = torch.stack((mf, mfx, mfy)).reshape(3, -1)
    idx = cell.reshape(-1).to(torch.int64)
    idx = torch.where(idx >= 0, idx, ncells)

    def library():
        out = torch.zeros((3, ncells + 1), dtype=torch.float32,
                          device=mf.device)
        return out.index_add_(1, idx, src)

    was = torch.are_deterministic_algorithms_enabled()
    rec = {}
    try:
        for key, det in (("library", False), ("library_det", True)):
            torch.use_deterministic_algorithms(det)
            got = library()[:, :ncells]
            if not all(bool(((a - b).abs() <= 1e-6 * b.abs()).all())
                       for a, b in zip(got, ref)):
                raise AssertionError(f"cell sums' {key} call disagrees with "
                                     f"the plain version")
            rec[f"{key}_ms"] = _timed(library, 20)
            rec[f"{key}_device_ms"] = device_ms(library, 20)
    finally:
        torch.use_deterministic_algorithms(was)
    return rec


def check_small(card):
    """(h)-(l) SMALL through the census on the supercell engine. Returns
    the records of the labelled kernel (v4, collide on) and the cell sums
    kernel, and the launch counts of the path's run and of the CLI's."""
    from particlesimulation_tpu_torch.config import SimConfig
    from particlesimulation_tpu_torch.engine import Engine
    from particlesimulation_tpu_torch.ops.supercell import make_supercell_run

    t0 = time.perf_counter()
    seed, side, nc, n, steps = SMALL
    cfg = SimConfig(seed, side, nc, n)
    for kcap in (32, 160, 288, 1024):
        check_adversarial_labelled(kcap)
    eng = Engine(cfg, device="cuda")
    state = eng.init_state()
    out, launches = check_golden(
        "SMALL supercell", eng, state, steps, SMALL_10,
        ["fused_pairs_sub", "supercell_cell_sums"])
    if eng.impl != "supercell" or eng._supercell_factor() != SMALL_S:
        raise AssertionError(f"SMALL: {eng.impl}, S {eng._supercell_factor()}")
    print(f"SMALL: the census's route {eng.impl}, S {eng._supercell_factor()} "
          f"({eng._sc_rows()} rows), kcap {eng.kcap}", flush=True)
    sweep = Engine(cfg, impl="sweep", device="cuda")
    ref = sweep.run(sweep.init_state(), steps)
    compare_runs("SMALL 10 steps, supercell vs the f32 sweep on cuda",
                 (int(out.collisions), out, side),
                 (int(ref.collisions), ref, side), 1e-3 / side, None)
    _, pair_tiles, run = make_supercell_run(cfg, eng.kcap, eng._supercell_factor())
    check_no_sync("supercell", run, state)
    *tiles, sub = pair_tiles(state, steps)
    recs = {kind: fused_record("SMALL tiles", tiles, *kind, planted=False,
                               sub=sub)
            for kind in (("v4", True), ("v4", False), ("v2", True))}
    v4_centre_error(tiles, sub)
    sums = check_cell_sums(tiles, sub, cfg)
    check_gpu_vs_cpu(7, 5.0, 25, 400, 20, impl="supercell")
    cli_launches = check_cli_fast(SMALL + SMALL_10, "fused_pairs_sub")
    ms, t1, t21 = step_ms(eng, state, 20)
    print(f"SMALL supercell {n} particles, kcap {eng.kcap}: {ms:.4f} "
          f"ms/step, {n / ms / 1e3:.2f} M particle-steps/s (run(1) {t1:.4f} "
          f"s, run(21) {t21:.4f} s) on {card}", flush=True)
    times = device_breakdown("SMALL supercell", eng, state, ms)
    if times["syncs"] != 0:
        raise AssertionError(f"SMALL: {times['syncs']} syncs a step")
    print(f"supercell phases: {time.perf_counter() - t0:.1f} s; per step "
          f"{json.dumps({'ms': ms, **times})}", flush=True)
    return recs[("v4", True)], sums, launches, cli_launches


def band_lanes(plan, tiles):
    """(p) Per band, from the tiles its pair pass takes: the used slots
    (m > 0) a row c, the slot fill Σc/(rows·K) and the share of the pair
    lanes the function needs, Σc²/(rows·K²); then that share over the plan
    and over one tier of K = 864 (the dense engine at UNEVEN)."""
    c2 = lanes = 0.0
    for (r0, rw, k), (_, _, m, _, _) in zip(plan, tiles):
        c = (m > 0).sum(1).double()
        c2 += float((c * c).sum())
        lanes += float(c.numel()) * k * k
        print(f"band rows {r0}-{r0 + rw - 1}, K {k}: {int(c.sum())} "
              f"particles, max {int(c.max())} a cell, fill "
              f"{float(c.sum()) / (c.numel() * k):.3f}, pair lanes needed "
              f"{float((c * c).sum()) / (c.numel() * k * k):.3f}", flush=True)
    cells = sum(t[0].shape[0] for t in tiles)
    print(f"pair lanes needed over the plan {c2 / lanes:.4f}; over one tier "
          f"of K = 864 {c2 / (cells * 864.0 ** 2):.4f}", flush=True)
    return c2 / lanes


def check_banded(card, tiered, dense):
    """(m)-(r) The banded engine: UNEVEN through the census, against dense
    and the CPU, its fused kernel on its own band tiles, its step times
    beside the tiered and dense engines' (``tiered``, ``dense``: (engine,
    state) at UNEVEN); then N = 1e7 on the streaming route, against
    resident. Returns the path's launch counts and the two band records."""
    from particlesimulation_tpu_torch.config import SimConfig
    from particlesimulation_tpu_torch.engine import Engine
    from particlesimulation_tpu_torch.ops.banded import (make_banded_run,
                                                         uniform_band_plan)
    from particlesimulation_tpu_torch.ops.cuda.launch_sweep import (
        UNEVEN_BANDS, band_tiles)

    t0 = time.perf_counter()
    un = SimConfig(*UNEVEN)
    eng = Engine(un, device="cuda")
    state = eng.init_state()
    if eng.impl != "banded" or eng._band_plan != UNEVEN_BANDS:
        raise AssertionError(f"UNEVEN census: {eng.impl} {eng._band_plan}")
    _, launches = check_golden("UNEVEN banded", eng, state, 2, UNEVEN_2,
                               ["fused_pairs"])
    runs = []
    for e in (eng, Engine(un, device="cuda", impl="dense")):
        out = e.run(state, 10)
        if e.impl not in ("banded", "dense") or int(out.overflow) != 0:
            raise AssertionError(f"UNEVEN: ran {e.impl}, overflow "
                                 f"{int(out.overflow)}")
        runs.append((int(out.collisions), out, un.side))
    compare_runs("UNEVEN 10 steps, banded vs dense on cuda", *runs, 2e-5,
                 None)
    check_no_sync("banded", make_banded_run(un, UNEVEN_BANDS)[2], state)
    check_gpu_vs_cpu(-7, 100.0, 12, 4000, 10, impl="banded",
                     plan=((0, 3, 64), (3, 3, 256), (6, 3, 256), (9, 3, 64)))
    check_gpu_vs_cpu(5, 8.0, 8, 600, 15, impl="banded",
                     plan=((0, 2, 64), (2, 2, 64), (4, 2, 64), (6, 2, 64)))

    tiles = band_tiles(un, UNEVEN_BANDS, state, 2)
    band_lanes(UNEVEN_BANDS, tiles)
    recs = {}
    for b, (_, _, k) in enumerate(UNEVEN_BANDS):
        if k in (896, 32):
            recs[k] = fused_record(f"UNEVEN banded tiles K={k}", tiles[b],
                                   "v4", True, planted=False)

    times = {}
    for label, e, st in (("banded", eng, state), ("tiered", *tiered),
                         ("dense", *dense)):
        ms, t1, t11 = step_ms(e, st, 10)
        print(f"UNEVEN {label}, kcap {e.kcap}: {ms:.4f} ms/step, "
              f"{un.n_particles / ms / 1e3:.2f} M particle-steps/s (run(1) "
              f"{t1:.4f} s, run(11) {t11:.4f} s) on {card}", flush=True)
        times[f"UNEVEN {label}"] = {"ms": ms, **device_breakdown(
            f"UNEVEN {label}", e, st, ms)}
    if times["UNEVEN banded"]["syncs"] != 0:
        raise AssertionError("UNEVEN banded: host syncs in the run")

    big = SimConfig(1, 5000.0, 316, 10_000_000)
    eng_b = Engine(big, device="cuda")
    state_b = eng_b.init_state()
    if eng_b.impl != "banded" or eng_b._band_plan != uniform_band_plan(
            316, 27, 192):
        raise AssertionError(f"1e7 census: {eng_b.impl} {eng_b._band_plan}")
    eng_r = Engine(big, device="cuda", impl="resident")
    state_r = eng_r.init_state()
    outs = []
    for label, e, st in (("1e7 banded", eng_b, state_b),
                         ("1e7 resident", eng_r, state_r)):
        out, _, _ = drive(label, e, st, 10, ["fused_pairs"])
        outs.append((int(out.collisions), out, big.side))
    same = all(torch.equal(getattr(outs[0][1], f), getattr(outs[1][1], f))
               for f in ("x", "y", "vx", "vy", "m", "alive", "pid"))
    compare_runs(f"1e7 10 steps, banded vs resident on cuda (bitwise equal: "
                 f"{same})", *outs, 1e-6, 1e-5)
    for label, e, st in (("1e7 banded", eng_b, state_b),
                         ("1e7 resident", eng_r, state_r)):
        ms, t1, t11 = step_ms(e, st, 10)
        print(f"{label}, kcap {e.kcap}: {ms:.4f} ms/step, "
              f"{big.n_particles / ms / 1e3:.2f} M particle-steps/s (run(1) "
              f"{t1:.4f} s, run(11) {t11:.4f} s) on {card}", flush=True)
        times[label] = {"ms": ms, **device_breakdown(label, e, st, ms)}
    print(f"banded phases: {time.perf_counter() - t0:.1f} s; per step "
          f"{json.dumps(times)}", flush=True)
    return launches, recs


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")

    # 1. The card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {name}", flush=True)

    # 2. Build the kernel library from the checkout's sources.
    from particlesimulation_tpu_torch.config import SimConfig
    from particlesimulation_tpu_torch.engine import (
        Engine, make_dense_step, make_resident_run)
    from particlesimulation_tpu_torch.ops.cuda import cell_pairs
    from particlesimulation_tpu_torch.ops.cuda.launch_sweep import (
        UNEVEN_PLAN, class_tiles, dense_tiles, resident_tiles)
    from particlesimulation_tpu_torch.ops.tiered import make_tiered_step

    t0 = time.perf_counter()
    lib = cell_pairs.build()
    print(f"built {lib} in {time.perf_counter() - t0:.2f} s", flush=True)
    with open(f"{lib}.log") as f:
        print(f.read().strip(), flush=True)

    # 3. Each kernel vs its plain version: the flagship tile shape, kcap
    # 1024, kcap 288 (no power of two) and a tiered UNEVEN class shape; then
    # the adversarial tiles.
    shapes = ((10_000, 160, 100), (300, 1024, 900), (500, 288, 200))
    for ncells, kcap, fill in shapes:
        for form in ("v4", "v2"):
            for collide in (True, False):
                check_fused(ncells, kcap, fill, form, collide)
    forces, colls = {}, {}
    for ncells, kcap, fill in shapes + ((96, 864, 600),):
        check_fused(ncells, kcap, fill, "v2", True, gated=False)
        forces[ncells] = check_dense_forces(ncells, kcap, fill)
        for with_pid in (False, True):
            colls[(ncells, with_pid)] = check_dense_collisions(
                ncells, kcap, fill, with_pid)
    for kcap in (32, 160, 288, 1024):
        check_adversarial(kcap)

    seed, side, nc, n, steps, ex, ey, ec = GOLDEN_S1
    s1 = SimConfig(seed, side, nc, n)

    # 4. The resident path (the main path): golden s1, default pair kernel.
    eng = Engine(s1, device="cuda")
    state = eng.init_state()
    _, res_launches = check_golden("golden s1 resident", eng, state, steps,
                                   (ex, ey, ec), ["fused_pairs"])
    check_no_sync("resident", make_resident_run(s1, eng.kcap)[2], state)
    # The fused kernel on the tiles the resident run hands its pair pass at
    # golden s1's last step, holes and limbo slots included.
    tiles = resident_tiles(s1, eng.kcap, state, steps)
    on_path = {kind: fused_record("resident flagship tiles", tiles, *kind,
                                  planted=False)
               for kind in (("v4", True), ("v4", False), ("v2", True, False))}
    check_gpu_vs_cpu(1, 5000.0, 32, 20_000, 10)
    check_gpu_vs_cpu(2, 100.0, 16, 12_000, 5)
    res_ms, t1, t101 = step_ms(eng, state, 100)
    print(f"resident flagship {n} particles, kcap {eng.kcap}: {res_ms:.4f} "
          f"ms/step, {n / res_ms / 1e3:.2f} M particle-steps/s (run(1) "
          f"{t1:.4f} s, run(101) {t101:.4f} s) on {card}", flush=True)
    device_breakdown("resident flagship", eng, state, res_ms)

    # 5. The resident path with the v1 pair kernel.
    eng_v1 = Engine(s1, device="cuda", impl="resident", pair_impl="v1")
    _, v1_launches = check_golden("golden s1 resident v1", eng_v1,
                                  eng_v1.init_state(), steps, (ex, ey, ec),
                                  ["fused_pairs_v1"])

    # 6. The dense path: golden s1.
    eng_d = Engine(s1, device="cuda", impl="dense")
    state_d = eng_d.init_state()
    _, dense_launches = check_golden(
        "golden s1 dense", eng_d, state_d, steps, (ex, ey, ec),
        ["dense_forces", "dense_collisions"])
    check_no_sync("dense", make_dense_step(s1, eng_d.kcap)[2], state_d)
    check_gpu_vs_cpu(2, 100.0, 16, 12_000, 5, impl="dense")
    dense_ms, t1, t101 = step_ms(eng_d, state_d, 100)
    print(f"dense flagship {n} particles, kcap {eng_d.kcap}: {dense_ms:.4f} "
          f"ms/step, {n / dense_ms / 1e3:.2f} M particle-steps/s (run(1) "
          f"{t1:.4f} s, run(101) {t101:.4f} s) on {card}", flush=True)
    device_breakdown("dense flagship", eng_d, state_d, dense_ms)
    tiles = make_dense_step(s1, eng_d.kcap)[1](state_d)
    check_tiles("dense flagship", [dense_tiles(s1, tiles)])

    # 7. The tiered path: UNEVEN, against the JAX result, then against the
    # dense engine on the card.
    un = SimConfig(*UNEVEN)
    eng_t = Engine(un, device="cuda", impl="tiered")
    state_t = eng_t.init_state()
    if tuple(map(tuple, eng_t._tier_plan)) != UNEVEN_PLAN:
        raise AssertionError(f"UNEVEN plan {eng_t._tier_plan}")
    _, tiered_launches = check_golden(
        "UNEVEN tiered", eng_t, state_t, 2, UNEVEN_2,
        ["dense_forces", "dense_collisions"])
    check_no_sync("tiered", make_tiered_step(un, UNEVEN_PLAN, "cuda")[2],
                  state_t)
    check_tiles("UNEVEN tiered", class_tiles(un, UNEVEN_PLAN, state_t))
    runs = []
    for impl in ("tiered", "dense"):
        e = Engine(un, device="cuda", impl=impl)
        out = e.run(e.init_state(), 10)
        if e.impl != impl or int(out.overflow) != 0:
            raise AssertionError(f"UNEVEN {impl}: ran {e.impl}, overflow "
                                 f"{int(out.overflow)}")
        runs.append((int(out.collisions), out, un.side))
    compare_runs("UNEVEN 10 steps, tiered vs dense on cuda", *runs, 2e-5,
                 None)
    check_gpu_vs_cpu(-7, 24.0, 12, 2000, 12, impl="tiered")
    eng_dun = Engine(un, device="cuda", impl="dense")
    state_dun = eng_dun.init_state()
    tiles = make_dense_step(un, eng_dun.kcap)[1](state_dun)
    check_tiles("UNEVEN dense", [dense_tiles(un, tiles)])
    for label, e, st in (("tiered", eng_t, state_t),
                         ("dense", eng_dun, state_dun)):
        ms, t1, t11 = step_ms(e, st, 10)
        print(f"UNEVEN {label}, kcap {e.kcap}: {ms:.4f} ms/step, "
              f"{n / ms / 1e3:.2f} M particle-steps/s (run(1) {t1:.4f} s, "
              f"run(11) {t11:.4f} s) on {card}", flush=True)
        device_breakdown(f"UNEVEN {label}", e, st, ms)

    # 8. The sweep engine (f64 parity and f32) and the CLI.
    t_sweep = time.perf_counter()
    check_cli_parity()
    check_parity_golden()
    check_parity_card_vs_cpu()
    check_f32_sweep()
    medium = check_medium()
    cli_launches = check_cli_fast()
    sweep_times = time_sweeps(card, medium)
    print(f"sweep and CLI phases: {time.perf_counter() - t_sweep:.1f} s; "
          f"per step {json.dumps(sweep_times)}", flush=True)

    # 9. The supercell engine at SMALL.
    sub_rec, sums_rec, small_launches, small_cli = check_small(card)

    # 10. The banded engine: UNEVEN by the census, and N = 1e7 streaming.
    banded_launches, _ = check_banded(card, (eng_t, state_t),
                                      (eng_dun, state_dun))

    def entry(name, launches, rec):
        return {"name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[name], "launches": launches,
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "device_ms": rec["device_ms"], "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                "library_ms": rec.get("library_ms")}

    print(f"launches per path: resident {res_launches}, resident v1 "
          f"{v1_launches}, dense {dense_launches}, tiered {tiered_launches}, "
          f"CLI fast {cli_launches}, supercell SMALL {small_launches}, CLI "
          f"fast SMALL {small_cli}, banded UNEVEN (2 steps: 13 fused "
          f"launches a step and 13 for the first pass) {banded_launches}",
          flush=True)
    print(json.dumps({"kernels": [
        entry("fused_pairs", res_launches["fused_pairs"],
              on_path[("v4", True)]),
        entry("fused_pairs_v1", v1_launches["fused_pairs_v1"],
              on_path[("v2", True, False)]),
        entry("dense_pairwise_forces", dense_launches["dense_forces"],
              forces[10_000]),
        entry("dense_collisions", dense_launches["dense_collisions"],
              colls[(10_000, False)]),
        entry("fused_pairs_sub", small_launches["fused_pairs_sub"], sub_rec),
        entry("supercell_cell_sums", small_launches["supercell_cell_sums"],
              sums_rec),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
