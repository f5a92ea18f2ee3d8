"""Fused per-cell pair pass: collision(t) + pair forces(t+1) on slot tiles.

Counterpart of the JAX package's ``ops/pallas/cell_pairs.py`` (its
``fused_pairs_v2`` / ``fused_pairs_v4``). ``fused_pairs`` is the wrapper of
the hand-written CUDA kernel in ``csrc/cell_pairs.cu``; ``fused_pairs_ref``
beside it is the plain torch version of the same function.

A tensor on the CPU goes to ``fused_pairs_ref``; a tensor on a CUDA device
goes to the kernel, or the wrapper raises. The kernel library is compiled
with ``nvcc`` at first use, from the source in this repository, into the
package's build directory, under a name keyed on the source's content.

Contract (per cell row of the (ncells, K) tiles): ``ft`` is each slot's
minimum first-pair rank over alive partners within EPSILON (INT32_MAX if
none), ``count`` the number of pairs that are first for both ends (the
reference's collision set rule, serial/parsim.cpp:393-411), and fx, fy the
same-cell pair gravity computed with this pass's deaths already applied.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np
import torch

from particlesimulation_tpu_torch.config import G

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_PKG, "csrc", "cell_pairs.cu")
BUILD_DIR = os.path.join(_PKG, "build")

# Largest per-cell capacity the kernel takes: nine (K,) arrays of 4 bytes
# must fit the 48 KB of shared memory a block may use without opting in.
MAX_KCAP = 1024
INF = 0x7FFFFFFF
FORCE_FORMS = ("v2", "v4")

# Kernel launches since the last reset (the chip check reads it to show that
# the main path went through the kernel).
LAUNCHES = 0

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def build() -> str:
    """Compile the kernel library if it is not built yet; returns its path.

    The compiler's report (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside the library as ``<name>.log``.
    """
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"libcell_pairs_{digest}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Per-pid temp name: concurrent processes may race to build; each
    # compiles privately and the atomic rename makes last-writer-wins safe.
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", tmp, SOURCE]
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
                [vp] * 9 + [ci, ci, cf, cf, ci, ci, vp])
            lib.psim_fused_pairs.restype = ci
            _lib = lib
        return _lib


def _eps2(eps: float) -> float:
    # f32(eps)·f32(eps) == f32(eps²) for EPSILON (both 0x37D1B717).
    return float(np.float32(eps) * np.float32(eps))


def _check(x, y, mf, alive, pid, kcap, force_form):
    if force_form not in FORCE_FORMS:
        raise ValueError(f"force_form {force_form!r}; valid: {FORCE_FORMS}")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] != kcap:
        raise ValueError(f"tiles must be (ncells >= 1, {kcap}); got "
                         f"{tuple(x.shape)}")
    if not 1 <= kcap <= MAX_KCAP:
        raise ValueError(f"kcap {kcap} outside [1, {MAX_KCAP}]")
    for name, t, dt in (("x", x, torch.float32), ("y", y, torch.float32),
                        ("mf", mf, torch.float32), ("alive", alive, torch.int32),
                        ("pid", pid, torch.int32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}; got {t.dtype}")
        if t.shape != x.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != "
                             f"{tuple(x.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_pairs(x, y, mf, alive, pid, kcap: int, eps: float,
                collide: bool = True, force_form: str = "v4"):
    """Fused collision + pair-force pass over (ncells, kcap) tiles.

    x, y, mf: float32 positions and physics masses (limbo slots zeroed);
    alive, pid: int32 collision mask and particle ids. Returns
    (fx, fy, count, ft): float32 forces, the int32 0-d collision count and
    the int32 first-pair ranks.
    """
    global LAUNCHES
    _check(x, y, mf, alive, pid, kcap, force_form)
    if x.device.type == "cpu":
        return fused_pairs_ref(x, y, mf, alive, pid, kcap, eps, collide,
                               force_form)
    if x.device.type != "cuda":
        raise ValueError(f"no fused pair pass for device {x.device}")
    ncells = x.shape[0]
    fx = torch.empty_like(x)
    fy = torch.empty_like(x)
    ft = torch.empty_like(pid)
    cell_count = torch.empty(ncells, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = _library().psim_fused_pairs(
            x.data_ptr(), y.data_ptr(), mf.data_ptr(), alive.data_ptr(),
            pid.data_ptr(), fx.data_ptr(), fy.data_ptr(), ft.data_ptr(),
            cell_count.data_ptr(), ncells, kcap, _eps2(eps), G,
            int(bool(collide)), int(force_form == "v4"),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused pair kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return fx, fy, torch.sum(cell_count, dtype=torch.int32), ft


def fused_pairs_ref(x, y, mf, alive, pid, kcap: int, eps: float,
                    collide: bool = True, force_form: str = "v4"):
    """Plain torch version of ``fused_pairs`` (same signature and outputs).

    Chunked over blocks of cells so that no (ncells, K, K) tensor exists.
    """
    _check(x, y, mf, alive, pid, kcap, force_form)
    eps2 = torch.full((), _eps2(eps), dtype=torch.float32, device=x.device)
    g = torch.full((), G, dtype=torch.float32, device=x.device)
    cb = max(1, (1 << 21) // (kcap * kcap))
    outs = [_ref_block(x[c:c + cb], y[c:c + cb], mf[c:c + cb],
                       alive[c:c + cb], pid[c:c + cb], eps2, g, collide,
                       force_form == "v4")
            for c in range(0, x.shape[0], cb)]
    fx, fy, ft, counts = zip(*outs)
    return (torch.cat(fx), torch.cat(fy),
            torch.sum(torch.stack(counts), dtype=torch.int32), torch.cat(ft))


def _ref_block(x, y, mf, alive, pid, eps2, g, collide: bool, v4: bool):
    k = x.shape[1]
    dev = x.device
    # Pair tensors are (cells, i, j); dx = x_j - x_i.
    dx = x[:, None, :] - x[:, :, None]
    dy = y[:, None, :] - y[:, :, None]
    d2 = dx * dx + dy * dy
    if collide:
        pair_alive = (alive[:, :, None] * alive[:, None, :]) > 0
        not_self = ~torch.eye(k, dtype=torch.bool, device=dev)
        hit = pair_alive & (d2 < eps2) & not_self
        # Pid rank among alive slots: the reference's bucket order.
        pr = torch.sum((alive[:, None, :] > 0)
                       & (pid[:, None, :] < pid[:, :, None]), dim=2,
                       dtype=torch.int32)
        ri, rj = pr[:, :, None], pr[:, None, :]
        rank = torch.minimum(ri, rj) * (k + 1) + torch.maximum(ri, rj)
        cand = torch.where(hit, rank, INF)
        ft = torch.amin(cand, dim=2)
        upper = torch.ones(k, k, dtype=torch.bool, device=dev).triu(1)
        first = (hit & upper & (ft[:, :, None] == cand)
                 & (ft[:, None, :] == cand))
        count = torch.sum(first, dtype=torch.int32)
        m_post = torch.where(ft != INF, 0.0, mf)
    else:
        ft = torch.full_like(pid, INF)
        count = torch.zeros((), dtype=torch.int32, device=dev)
        m_post = mf
    gm = g * m_post
    if v4:
        # fx_i = G·m_i·(Σ_j w_ij·xl_j − xl_i·Σ_j w_ij), w = m_j/d³, on
        # coordinates recentred by the mean of used slots.
        used = m_post > 0
        nrow = torch.clamp(torch.sum(used, dim=1, dtype=torch.float32),
                           min=1.0)[:, None]
        xl = x - torch.sum(torch.where(used, x, 0.0), dim=1,
                           keepdim=True) / nrow
        yl = y - torch.sum(torch.where(used, y, 0.0), dim=1,
                           keepdim=True) / nrow
        dx = xl[:, None, :] - xl[:, :, None]
        dy = yl[:, None, :] - yl[:, :, None]
        d2 = dx * dx + dy * dy
    nz = d2 > 0
    inv = torch.where(nz, torch.rsqrt(torch.where(nz, d2, 1.0)), 0.0)
    inv3 = inv * inv * inv
    if v4:
        w = m_post[:, None, :] * inv3
        sx = torch.sum(w * xl[:, None, :], dim=2)
        sy = torch.sum(w * yl[:, None, :], dim=2)
        sw = torch.sum(w, dim=2)
        fx = gm * (sx - xl * sw)
        fy = gm * (sy - yl * sw)
    else:
        s = gm[:, :, None] * m_post[:, None, :] * inv3
        fx = torch.sum(s * dx, dim=2)
        fy = torch.sum(s * dy, dim=2)
    return fx, fy, ft, count
