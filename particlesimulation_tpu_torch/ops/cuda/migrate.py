"""The parity meshes' migration pack: stable compactions of each shard's
slab row and ring buffer row, without a sort.

Counterpart of the XLA code of the JAX package's mesh migration
(``parallel/sharded.py``: the emigrant pack, an argsort of ``~emig`` and a
gather a field; ``accept``, arrivals first by a stable argsort, a
``cumsum`` of the free slots and a gather a field into them; and their 2D
twins in ``parallel/sharded2d.py``), which the port ran as the same chain
of plain torch launches. Each wrapper launches hand-written CUDA kernels
of ``csrc/migrate.cu``; the ``*_ref`` function beside it is the plain torch
version of the same function:

* ``compact`` / ``compact_ref``: each shard row's emigrants, in slab order,
  the first ``bcap`` of them, as a ring buffer with their fields and a
  valid flag; the count that did not fit;
* ``pack`` / ``pack_ref``: a buffer row's arrivals, in buffer order, into
  the slab row's free slots, in slot order; the count that did not land.

A tensor on the CPU goes to the plain version; a tensor on a CUDA device
goes to the kernels, or the wrapper raises. The library is compiled with
``nvcc`` at first use (``cell_pairs.build``).

``pack`` writes the slab in place, the plain version too (its result is
copied back), so that a CPU run sees the aliasing a card run does: a
caller hands it tensors that no one else reads (``parallel/sharded``'s
migration copies the fields it took from its state first). Every field is
copied as bytes: the kernels give the plain versions' bits, ``pack``'s
every slot, ``compact``'s valid flags and valid entries. The kernel does
not write the fields of a buffer entry past the emigrants (the plain
argsort fills them with the slab's other entries): no caller reads an
entry that is not valid.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from particlesimulation_tpu_torch.ops.cuda import cell_pairs

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc", "migrate.cu")
# Fields one launch sequence moves, at most (csrc/migrate.cu kMaxFields).
MAX_FIELDS = 12

# Wrapper calls since the last reset_launches() (a pack's call runs three
# kernels, a compact's two).
LAUNCHES = {"pack": 0, "compact": 0}

_lock = threading.Lock()
_lib = None


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def load(path):
    """The kernel library at ``path`` (a build of ``SOURCE``), bound."""
    lib = ctypes.CDLL(path)
    vp, ci, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.psim_migrate_scratch.argtypes = [ci, i64, i64, ci]
    lib.psim_migrate_scratch.restype = i64
    lib.psim_pack.argtypes = [ci, i64, i64, vp, vp, ci] + [vp] * 6
    lib.psim_compact.argtypes = [ci, i64, i64, i64, vp, ci] + [vp] * 7
    lib.psim_pack.restype = lib.psim_compact.restype = ci
    return lib


def build():
    """Build the library (if it is not built yet); returns its path."""
    return cell_pairs.build(SOURCE)


def _library():
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
        return _lib


def _rows(name, t, L, dev, dtype=None):
    """``t``'s row length; raises unless it is a contiguous (L, n) tensor
    on ``dev`` (of ``dtype`` where given)."""
    if t.dim() != 2 or t.shape[0] != L or t.shape[1] < 1:
        raise ValueError(f"{name} must be ({L}, n >= 1); got "
                         f"{tuple(t.shape)}")
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, not {dev}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}; got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.shape[1]


def _fields(pairs):
    """ctypes arrays (src, dst, sizes) of (name, src, dst) triples whose
    tensors match in dtype; at most MAX_FIELDS."""
    if len(pairs) > MAX_FIELDS:
        raise ValueError(f"{len(pairs)} fields; at most {MAX_FIELDS}")
    for name, s, d in pairs:
        if s.dtype != d.dtype or s.element_size() not in (1, 4, 8):
            raise TypeError(f"field {name}: {s.dtype} into {d.dtype}")
    n = len(pairs)
    return ((ctypes.c_void_p * n)(*(s.data_ptr() for _, s, _ in pairs)),
            (ctypes.c_void_p * n)(*(d.data_ptr() for _, _, d in pairs)),
            (ctypes.c_int * n)(*(s.element_size() for _, s, _ in pairs)))


def _scratch(L, len_c, len_b, with_list, dev):
    n = _library().psim_migrate_scratch(L, len_c, len_b, int(with_list))
    return torch.empty(n, dtype=torch.int32, device=dev)


def pack(dst, dst_valid, src, take):
    """Move the ``src`` entries under ``take`` (``src``: a dict of (L, B)
    tensors holding ``dst``'s keys; ``take``: (L, B) bool), in their order,
    into the free slots of ``dst`` (a dict of (L, C) tensors, slots free
    where ``dst_valid``, (L, C) bool, is not), in slot order, in place.
    Returns (dst, dst_valid, overflow): the same tensors, every landed slot
    holding its arrival's fields and valid, every other slot as it was;
    ``overflow`` the (L,) int32 count of arrivals beyond a row's free
    slots, which do not land (the ladder replays the run)."""
    dev = dst_valid.device
    L = dst_valid.shape[0] if dst_valid.dim() == 2 else 0
    C = _rows("dst_valid", dst_valid, L, dev, torch.bool)
    B = _rows("take", take, L, dev, torch.bool)
    for k, t in dst.items():
        if _rows(f"dst[{k!r}]", t, L, dev) != C:
            raise ValueError(f"dst[{k!r}] rows of {t.shape[1]}, not {C}")
        if k not in src:
            raise KeyError(f"src lacks field {k!r}")
        if _rows(f"src[{k!r}]", src[k], L, dev) != B:
            raise ValueError(f"src[{k!r}] rows of {src[k].shape[1]}, not "
                             f"{B}")
    pairs = [(k, src[k], t) for k, t in dst.items()]
    if not cell_pairs._on_card(dst_valid, "migration pack"):
        out, valid, overflow = pack_ref(dst, dst_valid, src, take)
        for k, t in dst.items():
            t.copy_(out[k])
        dst_valid.copy_(valid)
        return dst, dst_valid, overflow
    srcs, dsts, sizes = _fields(pairs)
    overflow = torch.empty(L, dtype=torch.int32, device=dev)
    scratch = _scratch(L, C, B, True, dev)
    cell_pairs._launch(
        "pack", _library().psim_pack, dst_valid, L, C, B,
        dst_valid.data_ptr(), take.data_ptr(), len(pairs), srcs, dsts, sizes,
        overflow.data_ptr(), scratch.data_ptr(), launches=LAUNCHES)
    return dst, dst_valid, overflow


def pack_ref(dst, dst_valid, src, take):
    """Plain torch version of ``pack``, not in place: arrivals first by a
    stable argsort, the free slots ranked by a ``cumsum``, a gather and a
    ``where`` a field (JAX's ``accept``). Returns new (dst', valid',
    overflow)."""
    n_arr = torch.sum(take, dim=1, dtype=torch.int32)
    aorder = torch.argsort((~take).to(torch.uint8), dim=1, stable=True)
    free = ~dst_valid
    slot_rank = torch.cumsum(free.to(torch.int32), dim=1) - 1
    idx = torch.gather(aorder, 1, torch.clamp(slot_rank, 0,
                                              take.shape[1] - 1))
    fill = free & (slot_rank < n_arr[:, None])
    overflow = torch.clamp(n_arr - torch.sum(free, dim=1, dtype=torch.int32),
                           min=0)
    out = {k: torch.where(fill, torch.gather(src[k], 1, idx), v)
           for k, v in dst.items()}
    return out, dst_valid | fill, overflow


def compact(slab, emig, bcap: int, **extra):
    """Each shard's emigrants (``emig``, (L, C) bool) in slab order, the
    first ``bcap`` of them, as a ring buffer of min(bcap, C) entries a row:
    ``slab``'s fields (a dict of (L, C) tensors), ``extra``'s (L, C)
    tensors and ``valid``, new (L, min(bcap, C)) tensors; and the (L,)
    int32 count that did not fit. The entries past a row's emigrants have
    valid false, and their fields are not to be read: on the card they
    hold whatever the new tensors held, in the plain version the row's
    other slots in slab order."""
    dev = emig.device
    L = emig.shape[0] if emig.dim() == 2 else 0
    C = _rows("emig", emig, L, dev, torch.bool)
    if bcap < 1:
        raise ValueError(f"bcap {bcap} < 1")
    fields = {**slab, **extra}
    for k, t in fields.items():
        if _rows(f"field {k!r}", t, L, dev) != C:
            raise ValueError(f"field {k!r} rows of {t.shape[1]}, not {C}")
    if not cell_pairs._on_card(emig, "emigrant buffer"):
        return compact_ref(slab, emig, bcap, **extra)
    B = min(bcap, C)
    buf = {k: torch.empty((L, B), dtype=t.dtype, device=dev)
           for k, t in fields.items()}
    buf["valid"] = torch.empty((L, B), dtype=torch.bool, device=dev)
    srcs, dsts, sizes = _fields([(k, t, buf[k]) for k, t in fields.items()])
    overflow = torch.empty(L, dtype=torch.int32, device=dev)
    scratch = _scratch(L, C, 0, False, dev)
    cell_pairs._launch(
        "compact", _library().psim_compact, emig, L, C, B, bcap,
        emig.data_ptr(), len(fields), srcs, dsts, sizes,
        buf["valid"].data_ptr(), overflow.data_ptr(), scratch.data_ptr(),
        launches=LAUNCHES)
    return buf, overflow


def compact_ref(slab, emig, bcap: int, **extra):
    """Plain torch version of ``compact``: a stable argsort of ``~emig``,
    its first ``bcap`` entries, a gather a field (JAX's emigrant pack)."""
    overflow = torch.clamp(torch.sum(emig, dim=1, dtype=torch.int32) - bcap,
                           min=0)
    take = torch.argsort((~emig).to(torch.uint8), dim=1, stable=True)[:, :bcap]
    return {k: torch.gather(a, 1, take) for k, a in (
        *slab.items(), *extra.items(), ("valid", emig))}, overflow
