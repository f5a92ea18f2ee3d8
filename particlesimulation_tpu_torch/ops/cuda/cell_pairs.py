"""Per-cell passes on slot tiles: collisions, pair forces, cell sums.

Counterpart of the JAX package's ``ops/pallas/cell_pairs.py``. Each wrapper
below launches a hand-written CUDA kernel of ``csrc/cell_pairs.cu``; the
``*_ref`` function beside it is the plain torch version of the same
function:

* ``fused_pairs`` / ``fused_pairs_ref``: collision(t) + pair forces(t+1),
  the resident engine's pass (``fused_pairs_v2``/``fused_pairs_v4``, and
  with ``gated=False`` the v1 ``fused_pairs``); with ``sub`` labels, the
  supercell engine's pass (the XLA ``fused_pairs_v2``/``_v4`` with
  ``sub=``), in which only slots of one label interact;
* ``supercell_cell_sums`` / ``supercell_cell_sums_ref``: the supercell
  engine's per-cell mass and moment sums (the one-hot contractions of the
  JAX ``ops/supercell.py``);
* ``dense_pairwise_forces`` / ``dense_pairwise_forces_ref``: the dense and
  tiered engines' force pass (``dense_pairwise_forces``);
* ``dense_collisions`` / ``dense_collisions_ref``: their collision pass
  (``dense_collisions``).

A tensor on the CPU goes to the plain version; a tensor on a CUDA device
goes to the kernel, or the wrapper raises. The kernel library is compiled
with ``nvcc`` at first use, from the source in this repository, into the
package's build directory, under a name keyed on the source's content.

Collision contract (per cell row of the (ncells, K) tiles): ``ft`` is each
slot's minimum first-pair rank over alive partners within EPSILON
(INT32_MAX if none), ``count`` the number of pairs that are first for both
ends (the reference's collision set rule, serial/parsim.cpp:393-411).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading

import numpy as np
import torch

from particlesimulation_tpu_torch.config import G
from particlesimulation_tpu_torch.ops.dense import monopole_tile_forces

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_PKG, "csrc", "cell_pairs.cu")
BUILD_DIR = os.path.join(_PKG, "build")

# Largest per-cell capacity the kernels take: the JAX package's MAX_XLA_KCAP,
# the widest tile its XLA kernels run. A launch whose row needs more shared
# memory than the 48 KB a block may use without asking (the fused kernel's
# eleven (K,) words of 4 bytes from K = 1112 on, its labelled form's twelve
# from K = 1024) opts in to it, up to 192 KB at K = 4096; a launch past
# MAX_KCAP raises, as does one whose opt-in fails.
MAX_KCAP = 4096
INF = 0x7FFFFFFF
FORCE_FORMS = ("v2", "v4")

# Kernel launches per kernel since the last reset_launches() (the chip check
# reads them to show which kernels the main path went through).
LAUNCHES = {"fused_pairs": 0, "fused_pairs_v1": 0, "fused_pairs_sub": 0,
            "dense_forces": 0, "dense_collisions": 0,
            "supercell_cell_sums": 0}

_lock = threading.Lock()
_lib = None


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def build(source: str = SOURCE, flags=()) -> str:
    """Compile the kernel library of the CUDA file ``source`` (this module's
    by default), with the extra ``nvcc`` options ``flags``, if it is not
    built yet; returns its path, ``lib<stem>_<hash>.so`` in the build
    directory, the hash taken over the source and the options.

    The compiler's report (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside the library as ``<name>.log``. The hash also covers the
    headers the source includes by ``#include "..."`` from its directory
    (``halo.cuh``).
    """
    with open(source, "rb") as f:
        text = f.read()
    h = hashlib.sha256(text)
    for name in re.findall(rb'^#include "([^"]+)"', text, re.M):
        with open(os.path.join(os.path.dirname(source), name.decode()),
                  "rb") as f:
            h.update(f.read())
    if flags:
        h.update(" ".join(flags).encode())
    digest = h.hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0]
    so = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Per-pid temp name: concurrent processes may race to build; each
    # compiles privately and the atomic rename makes last-writer-wins safe.
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           *flags, "-o", tmp, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{proc.stderr}")
    with open(f"{so}.log", "w") as f:
        f.write(proc.stderr)
    os.replace(tmp, so)
    return so


def _library():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp = ctypes.c_void_p
            ci = ctypes.c_int
            cf = ctypes.c_float
            lib.psim_fused_pairs.argtypes = (
                [vp] * 9 + [ci, ci, cf, cf, ci, ci, ci, ci, ci, vp])
            lib.psim_labelled_pairs.argtypes = (
                [vp] * 10 + [ci, ci, cf, cf, ci, ci, ci, ci, ci, vp])
            lib.psim_dense_forces.argtypes = (
                [vp] * 8 + [ci, ci, cf, ci, ci, ci, vp])
            lib.psim_dense_collisions.argtypes = (
                [vp] * 6 + [ci, ci, cf, ci, vp])
            lib.psim_cell_sums.argtypes = [vp] * 5 + [ci] * 6 + [vp]
            for fn in (lib.psim_fused_pairs, lib.psim_labelled_pairs,
                       lib.psim_dense_forces, lib.psim_dense_collisions,
                       lib.psim_cell_sums):
                fn.restype = ci
            _lib = lib
        return _lib


@functools.lru_cache(maxsize=None)
def _eps2(eps: float) -> float:
    # f32(eps)·f32(eps) == f32(eps²) for EPSILON (both 0x37D1B717).
    return float(np.float32(eps) * np.float32(eps))


def _check(kcap, x, *others):
    """Validate (ncells, kcap) tiles ``x`` and ``others``: (name, tensor,
    dtype, row width) tuples that must share x's rows and device."""
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] != kcap:
        raise ValueError(f"tiles must be (ncells >= 1, {kcap}); got "
                         f"{tuple(x.shape)}")
    if not 1 <= kcap <= MAX_KCAP:
        raise ValueError(f"kcap {kcap} outside [1, {MAX_KCAP}]")
    for name, t, dt, width in (("x", x, torch.float32, kcap),) + others:
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}; got {t.dtype}")
        if t.shape != (x.shape[0], width):
            raise ValueError(f"{name} shape {tuple(t.shape)} != "
                             f"{(x.shape[0], width)}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _on_card(x, what):
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no {what} for device {x.device}")
    return True


def _launch(name, fn, x, *args, launches=LAUNCHES, made=None):
    # The kernel goes to the current device, on its current stream. (The raw
    # stream handle saves the Stream object that torch.cuda.current_stream()
    # builds on every call.) ``made``: a ctypes.c_int among ``args`` (by
    # reference) in which an entry point that launches more than once
    # writes its launches; else it launches once.
    dev = x.device.index
    with (contextlib.nullcontext() if dev == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1 if made is None else made.value


def _check_fused(x, y, mf, alive, pid, kcap, force_form, sub=None):
    if force_form not in FORCE_FORMS:
        raise ValueError(f"force_form {force_form!r}; valid: {FORCE_FORMS}")
    others = [("y", y, torch.float32, kcap), ("mf", mf, torch.float32, kcap),
              ("alive", alive, torch.int32, kcap),
              ("pid", pid, torch.int32, kcap)]
    if sub is not None:
        others.append(("sub", sub, torch.int32, kcap))
    _check(kcap, x, *others)


def fused_pairs(x, y, mf, alive, pid, kcap: int, eps: float,
                collide: bool = True, force_form: str = "v4",
                gated: bool = True, sub=None, out=None):
    """Fused collision + pair-force pass over (ncells, kcap) tiles.

    x, y, mf: float32 positions and physics masses (limbo slots zeroed);
    alive, pid: int32 collision mask and particle ids. Forces come out with
    this pass's deaths applied. ``gated=False`` is the v1 kernel: the
    collision machinery runs in every cell, not only in cells with a hit;
    the function is the same. ``sub`` (int32 tiles, or None): each slot's
    cell within its row (−1 for an unbinned slot); two slots interact and
    can collide only if their labels are equal, the reference's same-cell
    rule (serial/parsim.cpp:356-366,393-411) inside a super-cell row. Ranks
    stay the row's pid ranks. The labelled pass is hit-gated only. Returns
    (fx, fy, count, ft): float32 forces, the int32 0-d collision count and
    the int32 first-pair ranks. ``out`` (fx, fy): float32 tiles the forces
    are written into (a tile run's carried forces, read before this pass),
    else new ones.
    """
    _check_fused(x, y, mf, alive, pid, kcap, force_form, sub)
    if sub is not None and not gated:
        raise ValueError("the labelled pair pass has no ungated (v1) form")
    if out is not None:
        _check(kcap, x, ("fx", out[0], torch.float32, kcap),
               ("fy", out[1], torch.float32, kcap))
    if not _on_card(x, "fused pair pass"):
        fx, fy, count, ft = fused_pairs_ref(x, y, mf, alive, pid, kcap, eps,
                                            collide, force_form, sub)
        if out is None:
            return fx, fy, count, ft
        out[0].copy_(fx)
        out[1].copy_(fy)
        return out[0], out[1], count, ft
    ncells = x.shape[0]
    fx, fy = out if out is not None else (torch.empty_like(x),
                                          torch.empty_like(x))
    ft = torch.empty_like(pid)
    count = torch.empty((), dtype=torch.int32, device=x.device)
    ptrs = (x.data_ptr(), y.data_ptr(), mf.data_ptr(), alive.data_ptr(),
            pid.data_ptr())
    outs = (fx.data_ptr(), fy.data_ptr(), ft.data_ptr(), count.data_ptr(),
            ncells, kcap, _eps2(eps), G, int(bool(collide)),
            int(force_form == "v4"))
    if sub is not None:
        _launch("fused_pairs_sub", _library().psim_labelled_pairs, x,
                *ptrs, sub.data_ptr(), *outs, *labelled_launch(kcap))
    else:
        _launch("fused_pairs" if gated else "fused_pairs_v1",
                _library().psim_fused_pairs, x, *ptrs, *outs,
                int(bool(gated)), *fused_launch(kcap))
    return fx, fy, count, ft


def fused_pairs_ref(x, y, mf, alive, pid, kcap: int, eps: float,
                    collide: bool = True, force_form: str = "v4", sub=None):
    """Plain torch version of ``fused_pairs`` (same outputs, any gating).

    Chunked over blocks of cells so that no (ncells, K, K) tensor exists.
    """
    _check_fused(x, y, mf, alive, pid, kcap, force_form, sub)
    eps2 = torch.full((), _eps2(eps), dtype=torch.float32, device=x.device)
    g = torch.full((), G, dtype=torch.float32, device=x.device)

    def block(sl):
        same = (None if sub is None
                else sub[sl][:, :, None] == sub[sl][:, None, :])
        if collide:
            ft, count = _ref_collide(x[sl], y[sl], alive[sl], pid[sl], eps2,
                                     same)
            m_post = torch.where(ft != INF, 0.0, mf[sl])
        else:
            ft = torch.full_like(pid[sl], INF)
            count = torch.zeros((), dtype=torch.int32, device=x.device)
            m_post = mf[sl]
        if force_form == "v4":
            fx, fy = _ref_force_v4(x[sl], y[sl], m_post, g, same)
        else:
            fx, fy = _ref_force_v2(x[sl], y[sl], m_post, g, same)
        return fx, fy, ft, count

    fx, fy, ft, counts = zip(*(block(sl) for sl in _cell_blocks(x)))
    return (torch.cat(fx), torch.cat(fy),
            torch.sum(torch.stack(counts), dtype=torch.int32), torch.cat(ft))


def dense_pairwise_forces(x, y, m, ml, mxl, myl, kcap: int):
    """Total gravity per slot over (ncells, kcap) tiles: all same-cell pairs
    plus the 8 monopole terms of the cell's (ncells, 8) stencil rows ml
    (neighbour mass) and mxl, myl (mirrored neighbour COM). Returns (fx, fy).
    """
    _check_dense_forces(x, y, m, ml, mxl, myl, kcap)
    if not _on_card(x, "dense force pass"):
        return dense_pairwise_forces_ref(x, y, m, ml, mxl, myl, kcap)
    ncells = x.shape[0]
    fx = torch.empty_like(x)
    fy = torch.empty_like(x)
    _launch("dense_forces", _library().psim_dense_forces, x,
            x.data_ptr(), y.data_ptr(), m.data_ptr(), ml.data_ptr(),
            mxl.data_ptr(), myl.data_ptr(), fx.data_ptr(), fy.data_ptr(),
            ncells, kcap, G,
            *force_launch(ncells, kcap, _sm_count(x.device.index)))
    return fx, fy


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def fused_launch(kcap: int):
    """(receivers per thread, threads per block) of the fused kernel on
    (ncells, kcap) tiles, one block per cell whatever ncells and the card:
    two receivers a thread, in the smallest power-of-two block
    (32 to 256 threads) whose one pass covers a row up to 80% full. On the
    resident engine's tiles (``launch_sweep.py``; device ms of v4 on an
    H100 80GB HBM3 at 700 W) it picks the fastest shape at each K measured:
    (2, 64) at (10 000,
    160), 0.1168 against a thread per slot pair's (2, 96) 0.1231; (2, 128)
    at (4900, 288), 0.1771 against (2, 160) 0.1791; (2, 256) at (2500,
    544), 0.2864 against (2, 224) 0.2997 and (2, 192) 0.3265. Rows wider
    than 640 slots take (2, 256), the kernel's largest block, up to
    ``MAX_KCAP``: its receivers loop over the row in passes of 512."""
    threads = 32
    while threads < 256 and 10 * threads < 4 * kcap:
        threads *= 2
    return 2, threads


# The labelled pass takes rows of up to WARP_ROW_KCAP slots a warp a row
# (a lane's slots l and l + 32), wider rows a block a row.
WARP_ROW_KCAP = 64
LABELLED_ROW_WARPS = 2


def labelled_launch(kcap: int):
    """(rows a block, receivers a thread, threads a block) of the labelled
    pass on (ncells, kcap) tiles. Up to ``WARP_ROW_KCAP`` slots a row: a
    warp a row, ``LABELLED_ROW_WARPS`` rows a block, each lane the receiver
    of its ceil(kcap / 32) slots. Wider rows: a block a row (0 rows a
    block), in ``fused_launch``'s shape. On SMALL's tiles (16 900, 64)
    (``launch_sweep.py --supercell``; device ms of v4 with collide on, on an
    H100 80GB HBM3 at 700 W) 1, 2 and 4 rows a block gave 0.0252, 0.0251
    and 0.0252, 8 and 16 gave 0.0266 and 0.0274; a block a row at 1 or 2
    receivers and 32 or 64 threads 0.0712-0.0934."""
    if kcap <= WARP_ROW_KCAP:
        return LABELLED_ROW_WARPS, -(-kcap // 32), 32 * LABELLED_ROW_WARPS
    return (0,) + fused_launch(kcap)


def cell_sums_launch(kcap: int) -> int:
    """Rows (warps) a block of the cell sums kernels on (rows, kcap) tiles:
    8, or as many as 48 KB of shared memory hold, at least 1. Up to
    ``WARP_ROW_KCAP`` slots a warp takes 2.6 KB; for wider rows its table
    takes 16 bytes for each of 2 kcap rounded up to a power of two slots,
    and 32 more (from K = 769 on one warp a block, 131 KB at K = 4096, which
    the launch opts in to). On
    SMALL's tiles (``launch_sweep.py --supercell``, an H100 80GB HBM3 at
    700 W) 1, 2, 4 and 8 rows a block gave 0.0252, 0.0252, 0.0255 and
    0.0254 device ms: the same within the spread."""
    table = 64
    while table < 2 * kcap:
        table *= 2
    return max(1, min(8, (48 * 1024) // (16 * (table + 32))))


def force_launch(ncells: int, kcap: int, sms: int):
    """(receivers per thread, threads per block, blocks per cell) of the
    force kernel on (ncells, kcap) tiles on a card with ``sms``
    multiprocessors, as the launch sweep (``launch_sweep.py``) on an H100
    chose them: two receivers a thread and a full row per pass, up to 256
    threads; where a class has fewer rows than two per SM, each row over up
    to four blocks per SM in all, one receiver a thread. Every shape is
    legal up to ``MAX_KCAP``: at most 256 threads, and a row's chunks (at
    most K / 128) each staging the whole row."""
    if ncells >= 2 * sms:
        return 2, min(256, -(-kcap // 64) * 32), 1
    chunks = max(1, min(-(-4 * sms // ncells), -(-kcap // 128)))
    return 1, min(256, -(-kcap // (32 * chunks)) * 32), chunks


def dense_pairwise_forces_ref(x, y, m, ml, mxl, myl, kcap: int):
    """Plain torch version of ``dense_pairwise_forces``, chunked over cells."""
    _check_dense_forces(x, y, m, ml, mxl, myl, kcap)
    g = torch.full((), G, dtype=torch.float32, device=x.device)
    fx, fy = zip(*(_ref_force_v2(x[sl], y[sl], m[sl], g)
                   for sl in _cell_blocks(x)))
    fxm, fym = monopole_tile_forces(x, y, m, ml, mxl, myl)
    return torch.cat(fx) + fxm, torch.cat(fy) + fym


def _check_dense_forces(x, y, m, ml, mxl, myl, kcap):
    f32 = torch.float32
    _check(kcap, x, ("y", y, f32, kcap), ("m", m, f32, kcap),
           ("ml", ml, f32, 8), ("mxl", mxl, f32, 8), ("myl", myl, f32, 8))


def dense_collisions(x, y, alive, kcap: int, eps: float, pid=None):
    """Collision pass over (ncells, kcap) tiles; returns (count, ft).

    With ``pid=None`` slot order stands for pid order (the dense engines'
    tiles are (cell, pid)-sorted): a slot's rank is the number of alive
    slots before it in its row.
    """
    _check_collisions(x, y, alive, pid, kcap)
    if not _on_card(x, "collision pass"):
        return dense_collisions_ref(x, y, alive, kcap, eps, pid)
    ncells = x.shape[0]
    ft = torch.empty_like(alive)
    count = torch.empty((), dtype=torch.int32, device=x.device)
    _launch("dense_collisions", _library().psim_dense_collisions, x,
            x.data_ptr(), y.data_ptr(), alive.data_ptr(),
            None if pid is None else pid.data_ptr(), ft.data_ptr(),
            count.data_ptr(), ncells, kcap, _eps2(eps),
            collision_threads(ncells, kcap, _sm_count(x.device.index)))
    return count, ft


def collision_threads(ncells: int, kcap: int, sms: int) -> int:
    """Threads per block of the collision kernel on a card with ``sms``
    multiprocessors, as the launch sweep (``launch_sweep.py``) on an H100
    chose them: a thread for two slots where a class has few rows (the
    sweep's classes of up to 1280 rows, 10 per SM, ran fastest so); a
    thread for eight where it has thousands, so that more cells are in
    flight at once (10 000 rows, 76 per SM). The switch, at 16 rows per SM,
    lies between the two, where no shape was measured. In whole warps, 32
    to 512 (512 from K = 1024 on, each thread then striding over the row's
    slots up to ``MAX_KCAP``)."""
    share = 8 if ncells >= 16 * sms else 2
    return min(512, max(32, -(-kcap // (32 * share)) * 32))


def dense_collisions_ref(x, y, alive, kcap: int, eps: float, pid=None):
    """Plain torch version of ``dense_collisions``, chunked over cells."""
    _check_collisions(x, y, alive, pid, kcap)
    eps2 = torch.full((), _eps2(eps), dtype=torch.float32, device=x.device)
    if pid is None:
        pid = torch.arange(kcap, dtype=torch.int32,
                           device=x.device).expand(x.shape[0], kcap)
    ft, counts = zip(*(_ref_collide(x[sl], y[sl], alive[sl], pid[sl], eps2)
                       for sl in _cell_blocks(x)))
    return torch.sum(torch.stack(counts), dtype=torch.int32), torch.cat(ft)


def _check_collisions(x, y, alive, pid, kcap):
    others = [("y", y, torch.float32, kcap),
              ("alive", alive, torch.int32, kcap)]
    if pid is not None:
        others.append(("pid", pid, torch.int32, kcap))
    _check(kcap, x, *others)


def supercell_cell_sums(mf, mfx, mfy, cell, ncells: int):
    """Per-cell sums of the supercell engine's (rows, K) tiles: M, Σm·x and
    Σm·y of every true cell, each (ncells,) float32, 0 for a cell with no
    slot. mf, mfx, mfy: float32 physics masses and moments (m·x, m·y);
    cell: int32 true-cell index of each binned slot, −1 for the others (an
    index outside [0, ncells) counts in no cell). Each cell's slots must lie
    in one row, as a super-cell layout puts them; the kernel adds them in
    slot order, so it gives the same bits in every run."""
    _check_sums(mf, mfx, mfy, cell, ncells)
    if not _on_card(mf, "cell sums"):
        return supercell_cell_sums_ref(mf, mfx, mfy, cell, ncells)
    rows, kcap = mf.shape
    out = torch.empty((3, ncells), dtype=torch.float32, device=mf.device)
    _launch("supercell_cell_sums", _library().psim_cell_sums, mf,
            mf.data_ptr(), mfx.data_ptr(), mfy.data_ptr(), cell.data_ptr(),
            out.data_ptr(), rows, kcap, ncells, cell_sums_launch(kcap), 3,
            0)
    return out[0], out[1], out[2]


def supercell_cell_sums_ref(mf, mfx, mfy, cell, ncells: int):
    """Plain torch version of ``supercell_cell_sums``: ``index_add_`` into
    the cells (in slot order on the CPU; in any order, by atomics, on a
    GPU), unbinned slots into a dropped extra cell."""
    _check_sums(mf, mfx, mfy, cell, ncells)
    idx = cell.reshape(-1).to(torch.int64)
    idx = torch.where((idx >= 0) & (idx < ncells), idx, ncells)
    out = torch.zeros((3, ncells + 1), dtype=torch.float32, device=mf.device)
    for row, src in zip(out, (mf, mfx, mfy)):
        row.index_add_(0, idx, src.reshape(-1))
    return out[0, :ncells], out[1, :ncells], out[2, :ncells]


def _check_sums(mf, mfx, mfy, cell, ncells):
    if ncells < 1:
        raise ValueError(f"ncells {ncells} < 1")
    kcap = mf.shape[-1]
    _check(kcap, mf, ("mfx", mfx, torch.float32, kcap),
           ("mfy", mfy, torch.float32, kcap),
           ("cell", cell, torch.int32, kcap))


def _cell_blocks(x):
    """Row slices of about 2M pair elements each."""
    k = x.shape[1]
    cb = max(1, (1 << 21) // (k * k))
    return [slice(c, c + cb) for c in range(0, x.shape[0], cb)]


def _ref_collide(x, y, alive, pid, eps2, same=None):
    """(ft, count) of one block of rows; pair tensors are (cells, i, j).
    ``same``: the pairs that may collide (equal labels), or None for all."""
    k = x.shape[1]
    dev = x.device
    dx = x[:, None, :] - x[:, :, None]
    dy = y[:, None, :] - y[:, :, None]
    d2 = dx * dx + dy * dy
    pair_alive = (alive[:, :, None] * alive[:, None, :]) > 0
    not_self = ~torch.eye(k, dtype=torch.bool, device=dev)
    hit = pair_alive & (d2 < eps2) & not_self
    if same is not None:
        hit = hit & same
    # Pid rank among alive slots: the reference's bucket order.
    pr = torch.sum((alive[:, None, :] > 0) & (pid[:, None, :] < pid[:, :, None]),
                   dim=2, dtype=torch.int32)
    ri, rj = pr[:, :, None], pr[:, None, :]
    rank = torch.minimum(ri, rj) * (k + 1) + torch.maximum(ri, rj)
    cand = torch.where(hit, rank, INF)
    ft = torch.amin(cand, dim=2)
    upper = torch.ones(k, k, dtype=torch.bool, device=dev).triu(1)
    first = hit & upper & (ft[:, :, None] == cand) & (ft[:, None, :] == cand)
    return ft, torch.sum(first, dtype=torch.int32)


def _inv3(dx, dy, same=None):
    d2 = dx * dx + dy * dy
    nz = d2 > 0
    if same is not None:
        nz = nz & same
    inv = torch.where(nz, torch.rsqrt(torch.where(nz, d2, 1.0)), 0.0)
    return inv * inv * inv


def _ref_force_v2(x, y, m, g, same=None):
    """Same-cell pair gravity G·m_i·m_j·d/|d|³ of one block of rows (only
    the pairs in ``same``, where given)."""
    dx = x[:, None, :] - x[:, :, None]
    dy = y[:, None, :] - y[:, :, None]
    s = (g * m)[:, :, None] * m[:, None, :] * _inv3(dx, dy, same)
    return torch.sum(s * dx, dim=2), torch.sum(s * dy, dim=2)


def _ref_force_v4(x, y, m, g, same=None):
    """The v4 form: fx_i = G·m_i·(Σ_j w_ij·xl_j − xl_i·Σ_j w_ij), w = m_j/d³
    (0 for a pair not in ``same``, where given), on coordinates recentred by
    the mean of the row's used slots, whatever their labels."""
    used = m > 0
    nrow = torch.clamp(torch.sum(used, dim=1, dtype=torch.float32),
                       min=1.0)[:, None]
    xl = x - torch.sum(torch.where(used, x, 0.0), dim=1, keepdim=True) / nrow
    yl = y - torch.sum(torch.where(used, y, 0.0), dim=1, keepdim=True) / nrow
    w = m[:, None, :] * _inv3(xl[:, None, :] - xl[:, :, None],
                              yl[:, None, :] - yl[:, :, None], same)
    sw = torch.sum(w, dim=2)
    gm = g * m
    return (gm * (torch.sum(w * xl[:, None, :], dim=2) - xl * sw),
            gm * (torch.sum(w * yl[:, None, :], dim=2) - yl * sw))
