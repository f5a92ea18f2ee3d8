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

Each path runs with the kernel launch counts set to 0 just before and read
just after, and fails if a kernel of the path did not launch. Two steps of
each run loop run under ``torch.cuda.set_sync_debug_mode("error")``; each
engine on the GPU is compared with the same engine on the CPU; the flagship
and UNEVEN steps are timed and their device time broken down by kernel
(torch.profiler). Any failure raises (non-zero exit). The last two
lines of standard output are one JSON object with a record per kernel and
one JSON object naming the device.

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
    1e-5·max|v|.

Bounds: a kernel's bound is the larger of its bytes over 3.35 TB/s and
its f32 operations over 67 TFLOP/s (H100 SXM data sheet), counted from
this run's tiles. Bytes: each output written once, each input read once
where the function needs it: masses, alive flags and pids of every slot,
x and y only of the slots that take part (used ones, m > 0, for a force,
alive ones for a collision). Operations: 14 per ordered pair of used slots
for the v2 force, 15 for v4, 14 per monopole term (an FMA counts 2, an
rsqrt 1). The collision test's operations are not counted: it need test
only the pairs near in x (a few per alive slot, 6 ops each), which cost
little beside the row's bytes. The rsqrt count is shown against the SFU
rate, 16 per SM and clock: 1/16 of the f32 rate.
"""

import json
import statistics
import subprocess
import time

import numpy as np
import torch

GOLDEN_S1 = (1, 5000.0, 100, 1_000_000, 4, 3936.506, 131.472, 4)
GOLDEN_TOL = 0.002
# UNEVEN: the reference report's clustered workload; the JAX f32 engine's
# tiered result after 2 steps on a CPU (its plan_tiers plan is
# launch_sweep.UNEVEN_PLAN).
UNEVEN = (-23, 5000.0, 100, 1_000_000)
UNEVEN_2 = (2748.5098, 2624.1592, 14)
# The TPU kernel body each kernel replaces (file:line).
REPLACES = {
    "fused_pairs": "particlesimulation_tpu/ops/pallas/cell_pairs.py:248",
    "fused_pairs_v1": "particlesimulation_tpu/ops/pallas/cell_pairs.py:166",
    "dense_pairwise_forces":
        "particlesimulation_tpu/ops/pallas/cell_pairs.py:45",
    "dense_collisions": "particlesimulation_tpu/ops/pallas/cell_pairs.py:112",
}
SOURCE = "particlesimulation_tpu_torch/csrc/cell_pairs.cu"
# The kernels' names in csrc/cell_pairs.cu, as the profiler reports them.
PORT_KERNELS = ("fused_pairs_kernel", "dense_forces_kernel",
                "dense_collisions_kernel")

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


def _term_sums(x, y, m_post, form, tables=None):
    """Per slot and axis, the summed magnitudes of the force's terms (the
    monopole terms too, given the stencil tables)."""
    from particlesimulation_tpu_torch.config import G

    out = []
    for c0 in range(0, x.shape[0], 64):
        xs, ys, ms = (a[c0:c0 + 64].double() for a in (x, y, m_post))
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


def _pairs(mask):
    """(ordered pairs, unordered pairs) of set slots, summed over rows."""
    n = mask.sum(1).double()
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


def fused_record(where, tiles, form, collide, gated=True, planted=True):
    """Fused pair kernel vs plain version on (x, y, mf, alive, pid) tiles on
    the card; the measured numbers. The ungated (v1) kernel must also equal
    the gated one bit for bit."""
    from particlesimulation_tpu_torch.config import EPSILON
    from particlesimulation_tpu_torch.ops.cuda import cell_pairs

    x, y, m, alive, pid = tiles
    kcap = x.shape[1]
    args = (x, y, m, alive, pid, kcap, EPSILON, collide, form)
    got = cell_pairs.fused_pairs(*args, gated=gated)
    ref = cell_pairs.fused_pairs_ref(*args)
    torch.cuda.synchronize()
    tag = (f"fused_pairs{'' if gated else '_v1'} {form} collide={collide} "
           f"{where}")
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
    max_err = _force_err(got[:2], ref[:2], _term_sums(x, y, m_post, form),
                         kcap, tag)
    # mf read and fx, fy, ft written for every slot, alive and pid too with
    # collide on; x and y read for the alive or used ones.
    p_force, _ = _pairs(m_post > 0)
    n_xy = float((((alive > 0) & collide) | (m > 0)).sum())
    bound_ms, bound_by, sfu_ms = _bound(
        (24 if collide else 16) * x.numel() + 8 * n_xy + 4,
        (15 if form == "v4" else 14) * p_force, p_force)
    rec = {"max_abs_err": max_err,
           **_kernel_times(lambda: cell_pairs.fused_pairs(*args, gated=gated),
                           lambda: cell_pairs.fused_pairs_ref(*args)),
           "bound_ms": bound_ms, "bound_by": bound_by, "sfu_ms": sfu_ms}
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


def check_gpu_vs_cpu(seed, side, nc, n, steps, impl=None):
    from particlesimulation_tpu_torch.config import SimConfig
    from particlesimulation_tpu_torch.engine import Engine

    outs = []
    for device in ("cuda", "cpu"):
        eng = Engine(SimConfig(seed, side, nc, n), impl=impl, device=device)
        out = eng.run(eng.init_state(), steps)
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


def device_breakdown(label, eng, state, step_ms_host, steps=10):
    """Device time per step by kernel name (torch.profiler over a run of
    ``steps``, its prologue and epilogue included), and the share of the
    unprofiled step the device is idle."""
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
            rows.append((us / 1e3 / steps, evt.key))
    rows.sort(reverse=True)
    total = sum(ms for ms, _ in rows)
    top = "; ".join(f"{key[:48]} {ms:.4f}" for ms, key in rows[:8])
    ours = {name: sum(ms for ms, key in rows if name in key)
            for name in PORT_KERNELS}
    print(f"{label}: device {total:.4f} ms/step of {step_ms_host:.4f} "
          f"ms/step, idle {1 - total / step_ms_host:.1%}; by kernel "
          f"(ms/step): {top}; the port's kernels (ms/step): "
          + ", ".join(f"{k} {v:.4f}" for k, v in ours.items() if v > 0),
          flush=True)


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

    def entry(name, launches, rec):
        return {"name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[name], "launches": launches,
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "device_ms": rec["device_ms"], "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"], "library_ms": None}

    print(f"launches per path: resident {res_launches}, resident v1 "
          f"{v1_launches}, dense {dense_launches}, tiered {tiered_launches}",
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
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
