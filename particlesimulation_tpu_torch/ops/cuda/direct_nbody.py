"""Exact all-pairs passes of the direct model: forces and first-pair search.

Counterpart of the XLA code of the JAX package's ``models/direct_nbody.py``
(``_pair_forces`` and the collision block of ``make_step``). Each wrapper
launches a hand-written CUDA kernel of ``csrc/direct_nbody.cu``; the
``*_ref`` function beside it is the plain torch version:

* ``direct_forces`` / ``direct_forces_ref``: every pair's gravity with the
  periodic minimum image, in float32 or float64;
* ``direct_collisions`` / ``direct_collisions_ref``: for each alive slot
  its first partner within EPSILON, or -1.

``first_pair_outcome`` turns the partners into the step's deaths and count
in O(N) plain torch. A tensor on the CPU goes to the plain version; a
tensor on a CUDA device goes to the kernel, or the wrapper raises.

The kernels take the minimum image by a threshold instead of JAX's
division: for |d| < side, ``round(d / side)`` is ±1 exactly where |d|
reaches ``min_image_threshold(side, dtype)``, found here on the host by
bisection over the floats with the same IEEE division, and 0 below it. The
collision kernel also takes ``collision_window(side, dtype)``, a test on the
x difference alone that no hitting pair fails. The plain versions keep
JAX's division.

Pair order: JAX ranks a pair (i, j), i < j, by ``i * (n + 1) + j`` in
int32, which wraps for n >= 46341. The ranks order pairs as (min, max)
lexicographically, and among the pairs of one slot that is the order of the
partner's index; so a slot's first pair is its smallest hitting partner,
which both versions find without a rank (the same result below 46341, and
no wrap above).
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
import re
import threading

import numpy as np
import torch

from particlesimulation_tpu_torch.config import EPSILON, G
from particlesimulation_tpu_torch.ops.cuda import cell_pairs

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc", "direct_nbody.cu")
# Receivers a step of the plain versions (JAX's jchunk).
CHUNK = 512
FLOATS = (torch.float32, torch.float64)

# Kernel launches per kernel since the last reset_launches().
LAUNCHES = {"direct_forces": 0, "direct_collisions": 0}

_lock = threading.Lock()
_lib = None


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def load(path):
    """The kernel library at ``path`` (a build of ``SOURCE``), bound."""
    lib = ctypes.CDLL(path)
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.psim_direct_forces.argtypes = [vp] * 5 + [ci, cd, cd, cd, ci, vp]
    lib.psim_direct_collisions.argtypes = (
        [vp] * 4 + [ci, cd, cd, cd, cd, cd, ci, vp])
    lib.psim_direct_forces.restype = ci
    lib.psim_direct_collisions.restype = ci
    return lib


def _library():
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(cell_pairs.build(SOURCE))
        return _lib


def eps2_of(dtype) -> float:
    """EPSILON² computed in ``dtype``, as JAX's ``asarray(EPSILON, dt)**2``."""
    if dtype == torch.float32:
        return float(np.float32(EPSILON) * np.float32(EPSILON))
    return EPSILON * EPSILON


def source_constants(source=SOURCE) -> dict:
    """The ``constexpr int`` constants of the kernels' source (tile width,
    threads and receivers a thread of each pass), by name."""
    with open(source) as f:
        return {k: int(v) for k, v in re.findall(
            r"constexpr int (\w+) = (\d+);", f.read())}


_BITS = {torch.float32: (np.float32, np.uint32),
         torch.float64: (np.float64, np.uint64)}


def _float(bits: int, dtype):
    f, u = _BITS[dtype]
    return np.array(bits, u).view(f)[()]


def _bits(v, dtype) -> int:
    f, u = _BITS[dtype]
    return int(np.array(v, f).view(u))


def _first_float(pred, lo, hi, dtype):
    """The smallest non-negative float of ``dtype`` above ``lo`` and at most
    ``hi`` for which ``pred`` holds, where it holds at ``hi`` and not at
    ``lo`` and is monotone between (the bit patterns of non-negative floats
    order as their values; Python ints, which do not overflow, bisect
    them)."""
    lo, hi = _bits(lo, dtype), _bits(hi, dtype)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if pred(_float(mid, dtype)):
            hi = mid
        else:
            lo = mid
    return _float(hi, dtype)


def _side_of(side, dtype):
    if dtype not in _BITS:
        raise TypeError(f"dtype must be float32 or float64; got {dtype}")
    with np.errstate(over="ignore"):
        s = _BITS[dtype][0](side)
    if not (math.isfinite(side) and s > 0 and np.isfinite(s)):
        raise ValueError(f"side must be finite and > 0 in {dtype}; got "
                         f"{side}")
    return s


@functools.lru_cache(maxsize=None)
def _threshold(side: float, dtype):
    s = _side_of(side, dtype)
    half = s.dtype.type(0.5)
    return _first_float(lambda d: d / s > half, 0, s, dtype)


def min_image_threshold(side: float, dtype) -> float:
    """T: the smallest float d of ``dtype`` with ``fl(d / side) > 0.5``.

    For |d| < side, JAX's minimum image ``d - side * round(d / side)`` is
    then, bit for bit, ``d - copysign(side, d)`` where |d| >= T and ``d -
    copysign(0, d)`` below (``fl(d / side)`` is at most 1, rounds to 1
    above 0.5 and to 0 at 0.5, half to even). T is not side/2: for float32
    at side 1000 it is 500.00003. Cached per (side, dtype); raises for a
    dtype other than float32 or float64 and for a side that is not a
    finite float > 0 in it."""
    return float(_threshold(side, dtype))


@functools.lru_cache(maxsize=None)
def collision_window(side: float, dtype) -> tuple:
    """(c, h): the collision kernel's test on the x difference alone. For
    positions in ``[0, side)``, a pair whose minimum-image x difference has
    ``fl(dx²) >= eps2`` cannot hit, since ``fl(fl(dx²) + fl(dy²)) >=
    fl(dx²)``; with d the raw difference (|d| < side), that is exactly
    ``lo <= |d| < hi``, and every pair outside that band has
    ``|fl(|d| - c)| > h``. So the kernel takes the exact test only where
    ``|fl(|d| - c)| > h``: a window that loses no hit and admits little
    more than the band's complement."""
    s = _side_of(side, dtype)
    f = s.dtype.type
    t = _threshold(side, dtype)
    eps2 = f(eps2_of(dtype))
    # E: the least |image| with fl(image²) >= eps2. Below T the image is d;
    # from T on its magnitude is fl(side - |d|), which is under E from F on.
    e = _first_float(lambda v: v * v >= eps2, 0, max(f(1), eps2),
                    dtype)
    far = 0 if s - f(0) < e else _first_float(lambda a: s - a < e, 0, s,
                                              dtype)
    lo, hi = min(e, t), max(far, t)
    c = s / f(2)
    h = np.nextafter(min(c - lo, hi - c), f(-np.inf))
    return float(c), float(h)


def _check(x, *others):
    """x: a 1-D contiguous float32 or float64 tensor; others: (name, tensor,
    dtype or None for x's) that must match its shape and device."""
    if x.dtype not in FLOATS:
        raise TypeError(f"x must be float32 or float64; got {x.dtype}")
    if x.dim() != 1:
        raise ValueError(f"x must be 1-D; got {tuple(x.shape)}")
    for name, t, dt in (("x", x, None),) + others:
        if t.dtype != (dt or x.dtype):
            raise TypeError(f"{name} must be {dt or x.dtype}; got {t.dtype}")
        if t.shape != x.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != "
                             f"{tuple(x.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def direct_forces(x, y, m, side: float):
    """(fx, fy): on each particle, the sum over every particle of
    ``G m_i m_j d / |d|³`` with d the minimum-image displacement on the
    periodic ``[0, side)²`` box (no term where d = 0)."""
    _check(x, ("y", y, None), ("m", m, None))
    if not cell_pairs._on_card(x, "direct_forces"):
        return direct_forces_ref(x, y, m, side)
    return forces_with(_library(), x, y, m, side)


def forces_with(lib, x, y, m, side: float, launches=LAUNCHES):
    """``direct_forces`` on CUDA tensors through the library ``lib``."""
    fx, fy = torch.empty_like(x), torch.empty_like(x)
    if x.numel():
        cell_pairs._launch(
            "direct_forces", lib.psim_direct_forces, x, x.data_ptr(),
            y.data_ptr(), m.data_ptr(), fx.data_ptr(), fy.data_ptr(),
            x.numel(), side, G, min_image_threshold(side, x.dtype),
            int(x.dtype == torch.float64), launches=launches)
    return fx, fy


def _min_image(b, a, side):
    d = b - a
    return d - side * torch.round(d / side)


def direct_forces_ref(x, y, m, side: float):
    """Plain torch version of ``direct_forces``: JAX's ``_pair_forces``, a
    (CHUNK, N) block of receivers at a time."""
    _check(x, ("y", y, None), ("m", m, None))
    sidet = torch.full((), side, dtype=x.dtype, device=x.device)
    g = torch.full((), G, dtype=x.dtype, device=x.device)
    fx, fy = torch.empty_like(x), torch.empty_like(x)
    for i0 in range(0, x.numel(), CHUNK):
        xi, yi, mi = (a[i0:i0 + CHUNK, None] for a in (x, y, m))
        dx = _min_image(x[None, :], xi, sidet)
        dy = _min_image(y[None, :], yi, sidet)
        d2 = dx * dx + dy * dy
        nz = d2 > 0
        inv = torch.where(nz, torch.rsqrt(torch.where(nz, d2, 1.0)), 0.0)
        s = (g * mi) * m[None, :] * (inv * inv * inv)
        fx[i0:i0 + CHUNK] = (s * dx).sum(1)
        fy[i0:i0 + CHUNK] = (s * dy).sum(1)
    return fx, fy


def direct_collisions(x, y, alive, side: float):
    """int32 (N,): for each alive particle the smallest index of another
    alive particle within EPSILON (minimum image; ``d² < EPSILON²`` in x's
    type), or -1. Dead particles neither hit nor are hit."""
    _check(x, ("y", y, None), ("alive", alive, torch.bool))
    if not cell_pairs._on_card(x, "direct_collisions"):
        return direct_collisions_ref(x, y, alive, side)
    return collisions_with(_library(), x, y, alive, side)


def collisions_with(lib, x, y, alive, side: float, launches=LAUNCHES):
    """``direct_collisions`` on CUDA tensors through the library ``lib``."""
    first = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    if x.numel():
        cell_pairs._launch(
            "direct_collisions", lib.psim_direct_collisions, x,
            x.data_ptr(), y.data_ptr(), alive.data_ptr(), first.data_ptr(),
            x.numel(), side, eps2_of(x.dtype),
            min_image_threshold(side, x.dtype),
            *collision_window(side, x.dtype), int(x.dtype == torch.float64),
            launches=launches)
    return first


def direct_collisions_ref(x, y, alive, side: float):
    """Plain torch version of ``direct_collisions``, a (CHUNK, N) block of
    receivers at a time."""
    _check(x, ("y", y, None), ("alive", alive, torch.bool))
    n = x.numel()
    sidet = torch.full((), side, dtype=x.dtype, device=x.device)
    eps2 = eps2_of(x.dtype)
    idx = torch.arange(n, dtype=torch.int32, device=x.device)
    first = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    for i0 in range(0, n, CHUNK):
        ii = idx[i0:i0 + CHUNK, None]
        dx = _min_image(x[None, :], x[i0:i0 + CHUNK, None], sidet)
        dy = _min_image(y[None, :], y[i0:i0 + CHUNK, None], sidet)
        hit = ((dx * dx + dy * dy < eps2) & alive[None, :]
               & alive[i0:i0 + CHUNK, None] & (idx[None, :] != ii))
        j = torch.where(hit, idx[None, :], n).amin(1)
        first[i0:i0 + CHUNK] = torch.where(j < n, j, -1)
    return first


def first_pair_outcome(first):
    """(died, count) from ``direct_collisions``' partners: every particle
    with a partner dies (a chain or cluster dies whole), and the count is
    the number of pairs that are each other's first partner."""
    died = first >= 0
    idx = torch.arange(first.numel(), dtype=first.dtype, device=first.device)
    mutual = died & (first[first.clamp(min=0).long()] == idx) & (idx < first)
    return died, mutual.sum()
