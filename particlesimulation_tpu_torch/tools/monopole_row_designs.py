"""Three designs of the mesh rows' monopole + integrate, timed on the same
inputs on the card.

The port runs ``csrc/advance.cu``'s ``monopole_pool_kernel`` (a thread a
slot over the pool, its row found from the runs of rows of one width, which
``ops/cuda/advance.tile_monopole_integrate`` and
``gathered_monopole_integrate`` launch). ``monopole_row_designs.cu`` beside
this file holds the two others, on the same slot physics: a warp a row (the
first design) and a block a row that compacts the row's live slots by
ballot. On the first-step monopole call of each of the four routes that run
the rows' pass (the flagship's resident meshes at D = 4 and on (2, 2),
UNEVEN's column and cyclic bands at D = 4; each recorded from an eager
step) and on ``ops/cuda/adversarial``'s row cases, every design is held bit
for bit to the plain version and, on the routes, timed in device ms (CUDA
events, median of 20, each call updating the same copy in place).

Run from the repository root, on a machine with one card::

    python3 -m particlesimulation_tpu_torch.tools.monopole_row_designs

It prints a line a route and input set and, last, one JSON object of the
routes' times, with the card's name and power limit. It exits with a code
other than 0 if a design disagrees with the plain version.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import sys

import numpy as np
import torch

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "monopole_row_designs.cu")
# The routes, by their names in chip_smoke.BF_MONOPOLE_PATHS.
ROUTES = ("mesh fast D=4", "2D (2, 2)", "column bands D=4", "cyclic D=4")
ROW_WRAPPERS = ("tile_monopole_integrate", "gathered_monopole_integrate")
REPS = 20


def _library():
    from particlesimulation_tpu_torch.ops.cuda import cell_pairs

    lib = ctypes.CDLL(cell_pairs.build(SOURCE, ("-fmad=false",)))
    vp, ci, cf, i64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                       ctypes.c_int64)
    lib.psim_design_warp_rows.argtypes = (
        [vp] * 11 + [i64] * 4 + [vp, ci, vp, vp, ci, cf, cf, cf, ci, vp])
    lib.psim_design_ballot_rows.argtypes = (
        [vp] * 11 + [i64] * 4 + [vp, vp, ci, vp, vp, ci, cf, cf, cf, vp])
    for fn in (lib.psim_design_warp_rows, lib.psim_design_ballot_rows):
        fn.restype = ci
    return lib


class _Call:
    """One recorded row call (``fn_name``, its args and kwargs), unpacked
    into what every design takes."""

    def __init__(self, fn_name, args, kw):
        from particlesimulation_tpu_torch.ops.cuda import advance

        self.fn_name, self.args, self.kw = fn_name, args, kw
        self.fields = args[:8]
        self.tables = args[8]
        if fn_name == "tile_monopole_integrate":
            _, row_start, self.side, self.dt = args[8:12]
            self.runs = ((row_start.numel() - 1, args[0].shape[1]),)
            self.row_idx, self.binned, self.gathered = None, None, False
            t = self.tables[0]
            self.layout = (t.stride(0), t.stride(1), t.shape[0], 0)
        else:
            _, self.row_idx, self.side, self.dt, runs = args[8:13]
            self.runs = tuple((int(r), int(k)) for r, k in runs)
            self.binned = kw.get("binned")
            self.gathered = True
            t = self.tables[0]
            self.layout = (t.stride(1), t.stride(0), t.shape[1],
                           t.shape[1] - 1)
            row_start = advance.row_starts(self.runs, t.device)
        self.row_start = row_start

    def fresh(self):
        return tuple(a.clone() for a in self.fields[:4])

    def _common(self, xyv):
        return (*(a.data_ptr() for a in xyv),
                *(a.data_ptr() for a in self.fields[4:8]),
                *(t.data_ptr() for t in self.tables), *self.layout)

    def _ptr(self, t):
        return None if t is None else t.data_ptr()

    def plain(self, xyv):
        from particlesimulation_tpu_torch.ops.cuda import advance

        ref = getattr(advance, self.fn_name + "_ref")
        return ref(*xyv, *self.args[4:], **self.kw)

    def pool(self, xyv):
        from particlesimulation_tpu_torch.ops.cuda import advance

        return getattr(advance, self.fn_name)(*xyv, *self.args[4:], **self.kw)

    def warp_rows(self, lib, xyv):
        from particlesimulation_tpu_torch.config import G

        err = lib.psim_design_warp_rows(
            *self._common(xyv), self.row_start.data_ptr(),
            self.row_start.numel() - 1, self._ptr(self.row_idx),
            self._ptr(self.binned), int(self.gathered),
            float(np.float32(self.side)), float(np.float32(self.dt)),
            float(np.float32(G)), 8, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the warp-a-row design: CUDA error {err}")
        return xyv

    def ballot_rows(self, lib, xyv):
        from particlesimulation_tpu_torch.config import G

        n = len(self.runs)
        rows = (ctypes.c_int64 * n)(*(r for r, _ in self.runs))
        ks = (ctypes.c_int * n)(*(k for _, k in self.runs))
        err = lib.psim_design_ballot_rows(
            *self._common(xyv), self._ptr(self.row_idx),
            self._ptr(self.binned), n, rows, ks, int(self.gathered),
            float(np.float32(self.side)), float(np.float32(self.dt)),
            float(np.float32(G)), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the ballot design: CUDA error {err}")
        return xyv


def _designs(lib, call):
    return {"pool (the port's)": call.pool,
            "warp a row (first design)":
                lambda xyv: call.warp_rows(lib, xyv),
            "block a row, ballot": lambda xyv: call.ballot_rows(lib, xyv)}


def check(tag, lib, call, timed):
    """Every design bit for bit the plain version on ``call``; with
    ``timed``, {design: device ms}."""
    import chip_smoke

    ref = call.plain(call.fresh())
    out = {}
    for name, fn in _designs(lib, call).items():
        got = fn(call.fresh())
        torch.cuda.synchronize()
        bad = [k for k, a, b in zip("x y vx vy".split(), got, ref)
               if not chip_smoke._exact(a, b)]
        if bad:
            raise AssertionError(f"{tag}: {name} differs from the plain "
                                 f"version in {bad}")
        if timed:
            one = call.fresh()
            out[name] = chip_smoke.device_ms(lambda: fn(one), REPS)
    live = int((call.fields[4] != 0).sum())
    print(f"{tag}: {call.fn_name}, {call.fields[0].numel()} slots ({live} "
          f"live), runs {call.runs[:4]}{' ...' if len(call.runs) > 4 else ''}"
          f": the three designs bit for bit the plain version"
          + ("; device ms " + ", ".join(f"{k} {v:.4f}" for k, v in out.items())
             if timed else ""), flush=True)
    return out


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    from particlesimulation_tpu_torch.ops import graphed
    from particlesimulation_tpu_torch.ops.cuda import advance

    card = chip_smoke._card()
    print(card, flush=True)
    lib = _library()
    _, _, monos = chip_smoke._adversarial_mesh_calls("cuda")
    for name, fn, a, kw in monos:
        if fn in ROW_WRAPPERS:
            check(f"adversarial, {name}", lib, _Call(fn, a, kw), False)
    del monos
    times = {}
    paths = {p[0]: p for p in chip_smoke.BF_MONOPOLE_PATHS}
    for route in ROUTES:
        label, kind, args, cfg_kw, eng_kw = paths[route]
        eng, state = chip_smoke._graph_engine(kind, args, cfg_kw, eng_kw)
        with contextlib.ExitStack() as stack:
            rec = [(n, stack.enter_context(chip_smoke._recording(advance, n,
                                                                 1)))
                   for n in ROW_WRAPPERS]
            eng.run_eager(state, 1)
        torch.cuda.synchronize()
        calls = [(n, c) for n, got in rec for c in got]
        if len(calls) != 1:
            raise AssertionError(f"{label}: {len(calls)} row calls, not 1")
        fn, (a, kw) = calls[0]
        times[label] = check(label, lib, _Call(fn, a, kw), True)
        graphed.release(chip_smoke._target(eng)._run)
        del eng, state, calls, rec
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "device_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
