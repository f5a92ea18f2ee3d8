"""The sweep engine's three passes over sorted particle lanes.

Counterpart of the XLA programs of the JAX package's ``ops/com.py``
(``com_parity``, ``com_fast``), ``ops/forces.py``
(``pairwise_forces_parity_blocked``, ``pairwise_forces_fast``, then
``monopole_forces``) and ``ops/collisions.py``
(``detect_collisions_blocked``), which the port's ``ops/com``,
``ops/forces`` and ``ops/collisions`` run as plain torch, one launch per
operation per neighbour offset. Each wrapper below launches a hand-written
CUDA kernel of ``csrc/sweep.cu``; the ``*_ref`` function beside it is the
plain torch version, those modules' functions:

* ``sweep_com`` / ``sweep_com_ref``: per cell M, MX, MY, parity (the
  reference's running mean in position order) or fast (``Σm·x / Σm``);
* ``sweep_forces`` / ``sweep_forces_ref``: each lane's same-cell pair
  forces, then its 8 stencil monopole terms from the ``(8, ncells + 1)``
  tables (``ops/stencil.stencil_tables``; the mesh's halo tables), in one
  launch;
* ``sweep_collisions`` / ``sweep_collisions_ref``: the collision count
  (pairs first for both ends) and the dead set, exact.

Beside them, two yardsticks of the COM kernel that no path runs:
``com_chain`` (one thread walking the kernel's chain, whose time a lane is
the chain floor) and ``div_check`` (its parity division against
``__ddiv_rn``).

The lanes come in the caller's order: each cell's lanes contiguous, in
position order, ``pos`` each lane's position in its cell (so a cell starts
at ``lane - pos``), ``plan.counts`` (``binning.occupancy``) each key's lane
count on the device; a key of ``ncells`` or more is a sentinel, in no cell.
The kernels read no lane order: ``plan.order`` (and the plain sweeps'
gathers) is for the plain versions alone.

Parity (float64) or fast (float32): the lanes' type picks the kernel and
the plain version. A tensor on the CPU goes to the plain version;
a tensor on a CUDA device goes to the kernel, or the wrapper raises. The
library is compiled with ``nvcc`` at first use (``cell_pairs.build``) with
``-fmad=false`` (``advance.FLAGS``), so that every product and sum rounds
on its own, as eager torch's do.

Bits (``csrc/sweep.cu`` has the argument): in parity the three kernels give
the plain versions' results bit for bit; in fast precision the collision
count and dead set are exact, the pair terms are the plain version's in
its order (``rsqrtf``, the instruction ``torch.rsqrt`` runs on the card),
and the COM sums each cell in position order where the plain version sums
``(ncells, kmax)`` rows with ``torch.sum``: within (c·2⁻²⁴)·Σ|terms| for a
cell of c lanes, the same bits in every run.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from particlesimulation_tpu_torch.config import G
from particlesimulation_tpu_torch.ops import collisions, com, forces
from particlesimulation_tpu_torch.ops.cuda import cell_pairs
from particlesimulation_tpu_torch.ops.cuda.advance import FLAGS

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc", "sweep.cu")

# Kernel launches per wrapper since the last reset_launches() (one a call:
# the collision call runs its two passes).
LAUNCHES = {"sweep_com": 0, "sweep_forces": 0, "sweep_collisions": 0}

_lock = threading.Lock()
_lib = None


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def load(path):
    """The kernel library at ``path`` (a build of ``SOURCE``), bound."""
    lib = ctypes.CDLL(path)
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for t in ("f32", "f64"):
        com_fn = getattr(lib, f"psim_sweep_com_{t}")
        com_fn.argtypes = [vp] * 6 + [ci, ci] + [vp] * 4
        forces_fn = getattr(lib, f"psim_sweep_forces_{t}")
        # The parity kernel also takes its team and scratch (sync) before
        # the stream.
        forces_fn.argtypes = ([vp] * 7 + [ci, ci] + [vp] * 3 + [cd]
                              + ([vp, vp, ci, vp, vp] if t == "f64"
                                 else [vp] * 3))
        coll_fn = getattr(lib, f"psim_sweep_collisions_{t}")
        coll_fn.argtypes = [vp] * 6 + [ci, ci, ci, cd] + [vp] * 4
        for fn in (com_fn, forces_fn, coll_fn):
            fn.restype = ci
        chain_fn = getattr(lib, f"psim_sweep_com_chain_{t}")
        chain_fn.argtypes = [ci, vp, vp]
        chain_fn.restype = ci
    lib.psim_sweep_div_check.argtypes = [vp, vp, ci, ci, vp, vp]
    lib.psim_sweep_div_check.restype = ci
    return lib


def build():
    """Build the library (if it is not built yet); returns its path."""
    return cell_pairs.build(SOURCE, FLAGS)


def _library():
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
        return _lib


def _float_type(x):
    """``x``'s type, float32 (fast) or float64 (parity)."""
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"x must be float32 or float64; got {x.dtype}")
    return x.dtype


def _check(floats, others, key, pos, plan, ncells):
    """Validate the lanes: ``floats`` (name, tensor) of the first one's
    type, float32 or float64; ``others`` (name, tensor, dtype); ``key``
    (int32) and ``pos`` (int64), all (n,) contiguous on the first float's
    device; ``plan.counts`` (ncells + 1,) int64 there. Returns n."""
    x = floats[0][1]
    dtype = _float_type(x)
    n = x.shape[0] if x.dim() == 1 else -1
    if n < 1:
        raise ValueError(f"lanes must be (n >= 1,); got {tuple(x.shape)}")
    if ncells < 1:
        raise ValueError(f"ncells {ncells} < 1")
    lanes = [(k, t, dtype) for k, t in floats] + list(others) + [
        ("key", key, torch.int32), ("pos", pos, torch.int64)]
    for name, t, dt in lanes:
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}; got {t.dtype}")
        if t.shape != (n,):
            raise ValueError(f"{name} shape {tuple(t.shape)} != {(n,)}")
    counts = plan.counts
    if counts.dtype != torch.int64 or counts.shape != (ncells + 1,):
        raise ValueError(f"plan.counts must be ({ncells + 1},) int64; got "
                         f"{tuple(counts.shape)} {counts.dtype}")
    for name, t, _ in lanes + [("plan.counts", counts, None)]:
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return n


def _kernel(name, x):
    """The library's ``psim_sweep_{name}`` for ``x``'s type."""
    t = "f64" if x.dtype == torch.float64 else "f32"
    return getattr(_library(), f"psim_sweep_{name}_{t}")


def sweep_com(x, y, m, key, pos, plan, ncells: int):
    """Per-cell (M, MX, MY), each (ncells,) of the lanes' type: parity
    (float64) or fast (float32); empty cells hold zeros. ``plan`` is
    ``binning.occupancy(key, ncells)``."""
    n = _check([("x", x), ("y", y), ("m", m)], [], key, pos, plan, ncells)
    if not cell_pairs._on_card(x, "sweep COM pass"):
        return sweep_com_ref(x, y, m, key, pos, plan, ncells)
    out = torch.empty((3, ncells), dtype=x.dtype, device=x.device)
    cell_pairs._launch(
        "sweep_com", _kernel("com", x), x, x.data_ptr(), y.data_ptr(),
        m.data_ptr(), key.data_ptr(), pos.data_ptr(), plan.counts.data_ptr(),
        n, ncells, out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        launches=LAUNCHES)
    return out[0], out[1], out[2]


def sweep_com_ref(x, y, m, key, pos, plan, ncells: int):
    """Plain torch version of ``sweep_com``: ``com.com_parity`` (float64)
    or ``com.com_fast`` (float32)."""
    fn = com.com_parity if _float_type(x) == torch.float64 else com.com_fast
    return fn(key, x, y, m, ncells, plan, pos)


# Launches of the COM kernel's two yardsticks (chip_smoke's chain floor and
# division check), on no path and so apart from LAUNCHES.
YARDSTICKS = {"sweep_com_chain": 0, "sweep_div_check": 0}


def com_chain(out, steps: int):
    """Launch the COM chain's yardstick (``csrc/sweep.cu``
    ``sweep_com_chain_kernel``): one thread walks ``steps`` (a multiple of
    32) lanes of the COM kernel's chain, parity for a float64 ``out``, fast
    for float32; ``out`` ((3,) on the card) takes the chain's result. Its
    time over ``steps`` is one lane's dependent latency on the chain."""
    if steps < 32 or steps % 32:
        raise ValueError(f"steps {steps} must be a positive multiple of 32")
    _float_type(out)
    if out.shape != (3,) or not cell_pairs._on_card(out, "COM chain"):
        raise ValueError("out must be (3,) on a CUDA device")
    cell_pairs._launch("sweep_com_chain", _kernel("com_chain", out), out,
                       steps, out.data_ptr(), launches=YARDSTICKS)


def div_check(u, v, midpoint: bool = False):
    """The COM kernel's parity division (a reciprocal, then two fma
    corrections where the divisor lies in its range and the numerator too or
    is +0, else ``__ddiv_rn``) against
    ``__ddiv_rn`` on float64 pairs on the card (``sweep_div_check_kernel``):
    pair i divides u[i] by v[i], or with ``midpoint`` RN(v[i]·(u[i] +
    ulp(u[i])/2)) by v[i], a quotient next to a rounding midpoint. Returns
    (the quotients whose bits differ, the pairs that took the reciprocal),
    an int64 (2,) tensor on the card."""
    if u.dtype != torch.float64 or v.dtype != torch.float64:
        raise TypeError("u and v must be float64")
    if u.shape != v.shape or u.dim() != 1 or u.shape[0] < 1:
        raise ValueError(f"u {tuple(u.shape)} and v {tuple(v.shape)} must "
                         f"be (n >= 1,)")
    if not (cell_pairs._on_card(u, "division check") and v.device == u.device
            and u.is_contiguous() and v.is_contiguous()):
        raise ValueError("u and v must be contiguous on one CUDA device")
    out = torch.zeros(2, dtype=torch.int64, device=u.device)
    cell_pairs._launch("sweep_div_check", _library().psim_sweep_div_check, u,
                       u.data_ptr(), v.data_ptr(), u.shape[0],
                       int(bool(midpoint)), out.data_ptr(),
                       launches=YARDSTICKS)
    return out


def sweep_forces(x, y, m, alive, key, pos, plan, tables, ncells: int):
    """Each lane's (fx, fy): its same-cell pair forces, then the 8 stencil
    monopole terms of ``tables`` ((ml, mxl, myl), each (8, ncells + 1) of
    the lanes' type, the last column the sentinel's), in one pass."""
    n = _check([("x", x), ("y", y), ("m", m)], [("alive", alive, torch.bool)],
               key, pos, plan, ncells)
    for name, t in zip(("ml", "mxl", "myl"), tables):
        if t.dtype != x.dtype or t.shape != (8, ncells + 1):
            raise ValueError(f"{name} must be (8, {ncells + 1}) {x.dtype}; "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    if not cell_pairs._on_card(x, "sweep force pass"):
        return sweep_forces_ref(x, y, m, alive, key, pos, plan, tables,
                                ncells)
    out = torch.empty((2, n), dtype=x.dtype, device=x.device)
    parity = []
    if x.dtype == torch.float64:
        # The team, and the scratch: each row tile's progress, a counter.
        sync = torch.zeros(n + 1, dtype=torch.int32, device=x.device)
        parity = [parity_team(plan, cell_pairs._sm_count(x.device.index)),
                  sync.data_ptr()]
    cell_pairs._launch(
        "sweep_forces", _kernel("forces", x), x, x.data_ptr(), y.data_ptr(),
        m.data_ptr(), alive.data_ptr(), key.data_ptr(), pos.data_ptr(),
        plan.counts.data_ptr(), n, ncells, *(t.data_ptr() for t in tables),
        float(G), out[0].data_ptr(), out[1].data_ptr(), *parity,
        launches=LAUNCHES)
    return out[0], out[1]


# csrc/sweep.cu: the most lanes of a cell the parity force kernel runs a
# lane a thread when large cells take teams (larger cells go to a team of
# TEAM warps, each pair's term once), and the warps the card holds an SM.
SMALL_CELL = 512
TEAM = 16
SM_WARPS = 32


def parity_team(plan, sms: int) -> int:
    """The warps a large cell takes in the parity force kernel: TEAM where
    the large cells' teams fill every warp of the card (``sms`` SMs), else
    0, every cell a lane a thread. A team's rows wait on each other, so a
    few cells run mostly waiting (nine cells of ~1100 lanes: 1.14 → 4.58
    device ms a step, PERF.md section 6), where a lane a thread keeps the
    card busy."""
    large = plan.cells[SMALL_CELL] if plan.kmax > SMALL_CELL else 0
    return TEAM if large * TEAM >= SM_WARPS * sms else 0


def sweep_forces_ref(x, y, m, alive, key, pos, plan, tables, ncells: int):
    """Plain torch version of ``sweep_forces``:
    ``forces.pairwise_forces_parity_blocked`` (float64) or
    ``forces.pairwise_forces_fast`` (float32), then
    ``forces.monopole_forces``."""
    pair = (forces.pairwise_forces_parity_blocked
            if _float_type(x) == torch.float64
            else forces.pairwise_forces_fast)
    fx, fy = pair(x, y, m, alive, key, ncells, plan)
    return forces.monopole_forces(x, y, m, alive, key, fx, fy, *tables,
                                  ncells)


def sweep_collisions(x, y, alive, key, pos, plan, epsilon: float,
                     ncells: int):
    """(count int64 0-d, died bool (n,)): the collision pass of float32 or
    float64 lanes. A cell of ``collisions.RANK_LIMIT`` lanes or more
    (``plan.kmax``) takes no detection, as in the plain version: the
    engine flags it."""
    n = _check([("x", x), ("y", y)], [("alive", alive, torch.bool)], key,
               pos, plan, ncells)
    if not cell_pairs._on_card(x, "sweep collision pass"):
        return sweep_collisions_ref(x, y, alive, key, pos, plan, epsilon,
                                    ncells)
    if collisions.rank_overflow(plan.kmax):
        return (torch.zeros((), dtype=torch.int64, device=x.device),
                torch.zeros(n, dtype=torch.bool, device=x.device))
    count = torch.empty((), dtype=torch.int64, device=x.device)
    first = torch.empty(n, dtype=torch.int32, device=x.device)
    died = torch.empty(n, dtype=torch.bool, device=x.device)
    cell_pairs._launch(
        "sweep_collisions", _kernel("collisions", x), x, x.data_ptr(),
        y.data_ptr(), alive.data_ptr(), key.data_ptr(), pos.data_ptr(),
        plan.counts.data_ptr(), n, ncells, plan.kmax, float(epsilon),
        first.data_ptr(), died.data_ptr(), count.data_ptr(),
        launches=LAUNCHES)
    return count, died


def sweep_collisions_ref(x, y, alive, key, pos, plan, epsilon: float,
                         ncells: int):
    """Plain torch version of ``sweep_collisions``:
    ``collisions.detect_collisions_blocked``."""
    return collisions.detect_collisions_blocked(x, y, alive, key, pos,
                                                epsilon, ncells, plan)
