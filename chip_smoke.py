#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the fused pair kernel from ``particlesimulation_tpu_torch/csrc``,
holds it against its plain torch version at the main path's tile shapes,
drives the main path (the f32 resident engine at golden vector s1's config,
seed 1, side 5000, ncside 100, N=1e6) and checks the result against the
reference's golden values, compares the port on the GPU with the port on the
CPU, and times the flagship step. Any failure raises (non-zero exit). The
last two lines of standard output are one JSON object per kernel run and one
JSON object naming the device.

Tolerances:
  * collision outputs (ft, count, collisions, dead set) are exact;
  * kernel forces hold to the plain version within 1e-5·|f| + 1e-6·max|f|
    plus (K + 8)·2^-24 of the summed magnitudes of the terms of each force:
    the worst-case rounding of a K-term sequential f32 sum (the kernel sums
    partners one by one, the plain version pairwise), with a few ulps for
    each term (rsqrtf differs from torch.rsqrt by an ulp or so). The terms
    matter where they cancel: on near pairs, and in the v4 form always;
  * golden s1: particle 0 within ±0.002 of (3936.506, 131.472) (the JAX f32
    engine on a CPU lands 0.0008 from the golden y; the GPU sums in another
    order);
  * GPU vs CPU runs: positions within 1e-6·side, velocities within
    1e-5·max|v|.
"""

import json
import statistics
import subprocess
import time

import numpy as np
import torch

GOLDEN_S1 = (1, 5000.0, 100, 1_000_000, 4, 3936.506, 131.472, 4)
GOLDEN_TOL = 0.002
PAIR_KERNEL_TPU = "particlesimulation_tpu/ops/pallas/cell_pairs.py:248"


def _timed(fn, reps):
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA-event timed."""
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


def _tiles(ncells, kcap, fill, seed, device):
    """Slot tiles shaped like the flagship's: cells 50 wide, Poisson(fill)
    occupied slots with the flagship's mass scale, empty slots zeroed,
    colliding chains planted in every 50th cell, pids permuted per row."""
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


def _term_sums(x, y, m_post, form):
    """Per slot and axis, the summed magnitudes of the force's terms."""
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
        out.append((bx, by))
    return [torch.cat(b) for b in zip(*out)]


def check_kernel(ncells, kcap, fill, form, collide):
    """Kernel vs plain version on the card; returns the measured numbers."""
    from particlesimulation_tpu_torch.config import EPSILON
    from particlesimulation_tpu_torch.ops.cuda import cell_pairs

    x, y, m, alive, pid = _tiles(ncells, kcap, fill, kcap + ncells, "cuda")
    args = (x, y, m, alive, pid, kcap, EPSILON, collide, form)
    got = cell_pairs.fused_pairs(*args)
    ref = cell_pairs.fused_pairs_ref(*args)
    torch.cuda.synchronize()
    tag = f"fused_pairs {form} collide={collide} ({ncells}, {kcap})"
    if not torch.equal(got[3], ref[3]):
        raise AssertionError(f"{tag}: ft differs in "
                             f"{int((got[3] != ref[3]).sum())} slots")
    if int(got[2]) != int(ref[2]):
        raise AssertionError(f"{tag}: count {int(got[2])} != {int(ref[2])}")
    if collide and int(ref[2]) == 0:
        raise AssertionError(f"{tag}: the planted chains did not collide")
    m_post = torch.where(ref[3] != cell_pairs.INF, 0.0, m)
    max_err = 0.0
    for a, b, terms in zip(got[:2], ref[:2], _term_sums(x, y, m_post, form)):
        err = (a.double() - b.double()).abs()
        tol = (1e-5 * b.double().abs() + 1e-6 * float(b.abs().max())
               + (kcap + 8) * 2.0 ** -24 * terms)
        if not bool((err <= tol).all()):
            raise AssertionError(f"{tag}: force off by {float(err.max())}")
        max_err = max(max_err, float(err.max()))
    ms = _timed(lambda: cell_pairs.fused_pairs(*args), 20)
    plain_ms = _timed(lambda: cell_pairs.fused_pairs_ref(*args), 3)
    print(f"{tag}: ft, count={int(got[2])} exact; max|df|={max_err:.3e}; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def _by_pid(state):
    order = torch.argsort(state.pid)
    return {f: getattr(state, f)[order].cpu()
            for f in ("x", "y", "vx", "alive")}


def check_gpu_vs_cpu(seed, side, nc, n, steps):
    from particlesimulation_tpu_torch.config import SimConfig
    from particlesimulation_tpu_torch.engine import Engine

    outs = []
    for device in ("cuda", "cpu"):
        eng = Engine(SimConfig(seed, side, nc, n), device=device)
        out = eng.run(eng.init_state(), steps)
        if int(out.overflow) != 0:
            raise AssertionError(f"overflow on {device}")
        outs.append((int(out.collisions), _by_pid(out)))
    (cg, g), (cc, c) = outs
    if cg != cc or not torch.equal(g["alive"], c["alive"]):
        raise AssertionError(f"cuda vs cpu: collisions {cg} vs {cc}, dead "
                             f"sets equal: {torch.equal(g['alive'], c['alive'])}")
    dpos = max(float((g[f] - c[f]).abs().max()) for f in ("x", "y"))
    dvx = float((g["vx"] - c["vx"]).abs().max())
    if dpos > 1e-6 * side or dvx > 1e-5 * float(c["vx"].abs().max()):
        raise AssertionError(f"cuda vs cpu: |dx|={dpos}, |dvx|={dvx}")
    print(f"cuda vs cpu ({seed} {side} {nc} {n}, {steps} steps): "
          f"collisions {cg} = {cc}, dead sets equal, max|dpos|={dpos:.3e}, "
          f"max|dvx|={dvx:.3e}", flush=True)


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
    from particlesimulation_tpu_torch.engine import Engine, make_resident_run
    from particlesimulation_tpu_torch.ops.cuda import cell_pairs

    t0 = time.perf_counter()
    lib = cell_pairs.build()
    print(f"built {lib} in {time.perf_counter() - t0:.2f} s", flush=True)
    with open(f"{lib}.log") as f:
        print(f.read().strip(), flush=True)

    # 3. Kernel vs plain version at the flagship tile shape and at kcap 1024.
    results = {}
    # kcap 288 is not a multiple of the kernel's 256 threads.
    for ncells, kcap, fill in ((10_000, 160, 100), (300, 1024, 900),
                               (500, 288, 200)):
        for form in ("v4", "v2"):
            for collide in (True, False):
                results[(ncells, kcap, form, collide)] = check_kernel(
                    ncells, kcap, fill, form, collide)

    # 4. The main path: golden vector s1 on the card, from the host init.
    seed, side, nc, n, steps, ex, ey, ec = GOLDEN_S1
    eng = Engine(SimConfig(seed, side, nc, n), device="cuda")
    state = eng.init_state()
    cell_pairs.LAUNCHES = 0
    out = eng.run(state, steps)
    torch.cuda.synchronize()
    launches = cell_pairs.LAUNCHES
    x, y, c = eng.result(out)
    finite = bool(torch.isfinite(out.x).all() and torch.isfinite(out.y).all())
    print(f"golden s1 on cuda: kcap {eng.kcap}, particle 0 ({x:.4f}, {y:.4f}) "
          f"dx={x - ex:+.4f} dy={y - ey:+.4f}, collisions {c}, overflow "
          f"{int(out.overflow)}, pair-kernel launches {launches}", flush=True)
    if not (out.x.shape == (n,) and finite and c == ec
            and abs(x - ex) <= GOLDEN_TOL and abs(y - ey) <= GOLDEN_TOL
            and int(out.overflow) == 0 and launches > 0):
        raise AssertionError("golden s1 failed on cuda")

    # The run loop must not synchronise with the host: any synchronising
    # CUDA call inside it raises here.
    _, run = make_resident_run(eng.config, eng.kcap)
    torch.cuda.set_sync_debug_mode("error")
    try:
        run(state, 2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("run loop: no host synchronisation in 2 steps", flush=True)

    # 5. The port on the GPU against the port on the CPU.
    check_gpu_vs_cpu(1, 5000.0, 32, 20_000, 10)
    check_gpu_vs_cpu(2, 100.0, 16, 12_000, 5)

    # 6. Flagship timing: per step = (t(run 101) - t(run 1)) / 100.
    def run_seconds(k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        o = eng.run(state, k)
        torch.cuda.synchronize()
        if int(o.overflow) != 0:
            raise AssertionError("overflow in the timed run")
        return time.perf_counter() - t

    t1 = min(run_seconds(1) for _ in range(2))
    t101 = min(run_seconds(101) for _ in range(2))
    per_step = (t101 - t1) / 100
    print(f"flagship {n} particles, kcap {eng.kcap}: {per_step * 1e3:.4f} "
          f"ms/step, {n / per_step / 1e6:.2f} M particle-steps/s "
          f"(run(1) {t1:.4f} s, run(101) {t101:.4f} s) on {card}",
          flush=True)

    flag = results[(10_000, 160, "v4", True)]
    print(json.dumps({"kernels": [{
        "name": "fused_pairs", "route": "cuda",
        "source": "particlesimulation_tpu_torch/csrc/cell_pairs.cu",
        "replaces": PAIR_KERNEL_TPU, "launches": launches,
        "max_abs_err": flag["max_abs_err"], "ms": flag["ms"],
        "plain_ms": flag["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
