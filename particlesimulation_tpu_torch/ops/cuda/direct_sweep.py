"""The direct kernels' launch constants swept on the card, and their SASS.

A diagnostic, run on a machine with a card:

    python3 -m particlesimulation_tpu_torch.ops.cuda.direct_sweep

For each variant of ``SWEEP`` (receivers a thread and threads a receiver
of both passes, or partners a step) it writes a copy of
``csrc/direct_nbody.cu`` with those constants set into the build
directory, builds them all (one nvcc each, started
together) and prints each build's registers and spills (``-Xptxas -v``).
Then, at N = 1e5 (seed -1, side 1000: the direct model's initial state,
float32), it times both kernels of each build (CUDA events, median of 10
queued behind a spin kernel), holds each build's partners to the repo
build's exactly and prints its forces' largest difference from them. The
source's constants come from one such sweep (PERF.md).

``sass_per_pair`` reads a library's kernels with ``cuobjdump -sass`` where
the toolkit has it: the instructions on each kernel's hot loop and the
pairs an iteration evaluates, so that instructions a pair can be set beside
the bound. With a path argument the script also writes the repo build's
SASS there.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from particlesimulation_tpu_torch.ops.cuda import cell_pairs, direct_nbody

# The variants: (receivers a thread, threads a receiver) for both passes at
# once, then the source's own pair with other partners a step (force loop,
# collision prefilter).
SWEEP = tuple({"kForceRecv": r, "kCollideRecv": r, "kForceSplit": s,
               "kCollideSplit": s}
              for r, s in ((1, 4), (2, 2), (2, 4), (2, 8), (4, 2), (4, 4),
                           (4, 8), (8, 2), (8, 4), (8, 8))) + (
    {"kForceGroup": 1}, {"kForceGroup": 4})
BIG = (-1, 1000.0, 100_000)
KERNELS = ("direct_forces_kernel", "direct_collisions_kernel")


def variant_source(constants: dict) -> str:
    """A copy of the kernels' source with the given ``constexpr int``
    constants set, in the build directory."""
    with open(direct_nbody.SOURCE) as f:
        src = f.read()
    for name, v in constants.items():
        src, k = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {v};", src)
        if k != 1:
            raise ValueError(f"{name} not found once in the source")
    os.makedirs(cell_pairs.BUILD_DIR, exist_ok=True)
    tag = "_".join(f"{k}{v}" for k, v in sorted(constants.items()))
    path = os.path.join(cell_pairs.BUILD_DIR, f"direct_nbody_{tag}.cu")
    with open(path, "w") as f:
        f.write(src)
    return path


def ptxas_report(lib: str) -> dict:
    """Registers, spill bytes and shared bytes of each kernel instance, from
    the ``-Xptxas -v`` log kept beside the library."""
    with open(f"{lib}.log") as f:
        log = f.read()
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = _short(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out.setdefault(name, {})["spill"] = int(m.group(1)) + int(
                m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            out[name]["smem"] = int(s.group(1)) if s else 0
    return out


def _short(mangled: str) -> str:
    """'direct_forces_kernel<float>' from a mangled kernel name."""
    for k in KERNELS:
        if k in mangled:
            rest = mangled.split(k, 1)[1]
            return f"{k}<{'float' if rest.startswith('If') else 'double'}>"
    return mangled


def _cuobjdump():
    found = shutil.which("cuobjdump")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "cuobjdump")
    return path if os.path.exists(path) else None


def sass_text(lib: str):
    """``cuobjdump -sass`` of the library, or None without cuobjdump."""
    tool = _cuobjdump()
    if tool is None:
        return None
    return subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout


_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def sass_functions(text: str) -> dict:
    """{short kernel name: [(address, instruction), ...]} of the direct
    kernels in ``cuobjdump -sass`` output."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = _short(m.group(1))
            cur = cur if cur.startswith(KERNELS) else None
            if cur:
                funcs[cur] = []
            continue
        m = _INSN.search(line)
        if cur and m:
            funcs[cur].append((int(m.group(1), 16), m.group(2)))
    return funcs


def _unpredicated(insn: str) -> str:
    """An instruction without its predicate."""
    return insn.split(None, 1)[1] if insn.startswith("@") else insn


# The instruction that marks one pair on a kernel's hot path: the force's
# rsqrt; the collision prefilter's |d| - c (an add of an absolute value).
MARKERS = {"direct_forces_kernel": re.compile(r"MUFU\.RSQ "),
           "direct_collisions_kernel": re.compile(r"FADD \S+, \|")}


def _target(insn):
    m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", insn)
    return int(m.group(1), 16) if m else None


def sass_loops(insns, marker: re.Pattern) -> list:
    """The innermost loops of one kernel (a backward branch and the code it
    jumps back over that holds no other backward branch), each as a dict:
    first and last address, the instructions in that range, and those on
    its common path with the pairs they evaluate (instructions that
    ``marker`` matches, predicate aside).
    The common path takes every conditional forward branch inside the loop:
    the kernels branch over their rare blocks (a step with a zero or
    subnormal d², a prefilter group with a candidate)."""
    back = [(_target(i), a) for a, i in insns
            if _target(i) is not None and _target(i) <= a]
    loops = []
    for lo, hi in back:
        if any(lo <= a < b <= hi and (a, b) != (lo, hi) for a, b in back):
            continue
        body = [(a, i) for a, i in insns if lo <= a <= hi]
        path, skip_to = [], None
        for a, i in body:
            if skip_to is not None and a < skip_to:
                continue
            path.append(i)
            t = _target(i)
            if t is not None and a < t <= hi:
                skip_to = t
        pairs = sum(bool(marker.match(_unpredicated(i))) for i in path)
        loops.append({"from": hex(lo), "to": hex(hi), "insns": len(body),
                      "path": len(path), "pairs": pairs,
                      "per_pair": len(path) / pairs if pairs else None})
    return loops


def sass_per_pair(lib: str):
    """{float32 kernel: its hot loop (the innermost loop with the fewest
    common-path instructions a pair)}, or None without cuobjdump."""
    text = sass_text(lib)
    if text is None:
        return None
    out = {}
    for name, insns in sass_functions(text).items():
        kernel = name.split("<")[0]
        if not name.endswith("<float>"):
            continue
        loops = [lp for lp in sass_loops(insns, MARKERS[kernel])
                 if lp["pairs"]]
        out[name] = min(loops, key=lambda lp: lp["per_pair"], default=None)
    return out


def _big_state():
    from particlesimulation_tpu_torch.models.direct_nbody import (
        DirectSimulation)

    st = DirectSimulation(*BIG, device="cuda").state
    return st.x, st.y, st.m, st.alive


def main():
    from particlesimulation_tpu_torch.ops.cuda.launch_sweep import device_ms

    if not torch.cuda.is_available():
        raise SystemExit("direct_sweep: CUDA is not available")
    side = BIG[1]
    paths = [variant_source(v) for v in SWEEP]
    with ThreadPoolExecutor(len(paths) + 1) as pool:
        libs = list(pool.map(cell_pairs.build,
                             [direct_nbody.SOURCE] + paths))
    x, y, m, alive = _big_state()
    counts = dict.fromkeys(("direct_forces", "direct_collisions"), 0)
    ref = direct_nbody.load(libs[0])
    fref = direct_nbody.forces_with(ref, x, y, m, side, counts)
    cref = direct_nbody.collisions_with(ref, x, y, alive, side, counts)
    rows = []
    for variant, lib in zip(SWEEP, libs[1:]):
        k = direct_nbody.load(lib)
        f = direct_nbody.forces_with(k, x, y, m, side, counts)
        c = direct_nbody.collisions_with(k, x, y, alive, side, counts)
        if not torch.equal(c, cref):
            raise AssertionError(f"{variant}: partners differ")
        scale = float(torch.stack(fref).abs().max())
        row = {**variant,
               "forces_ms": device_ms(lambda: direct_nbody.forces_with(
                   k, x, y, m, side, counts), 10),
               "collisions_ms": device_ms(
                   lambda: direct_nbody.collisions_with(
                       k, x, y, alive, side, counts), 10),
               "max_df_rel": max(float((a - b).abs().max()) for a, b in
                                 zip(f, fref)) / scale,
               "ptxas": ptxas_report(lib)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    for name in ("forces_ms", "collisions_ms"):
        best = min(rows, key=lambda r: r[name])
        consts = {k: v for k, v in best.items() if k.startswith("k")}
        print(f"{name}: best {json.dumps(consts)} {best[name]:.4f} ms",
              flush=True)
    print(f"SASS hot loops of {os.path.basename(libs[0])}: "
          f"{json.dumps(sass_per_pair(libs[0]))}", flush=True)
    if len(sys.argv) > 1 and sass_text(libs[0]) is not None:
        with open(sys.argv[1], "w") as f:
            f.write(sass_text(libs[0]))


if __name__ == "__main__":
    main()
