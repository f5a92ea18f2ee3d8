"""Plain-torch tile passes shared by the tile engines (the needed part of the
JAX package's ``ops/dense_xla.py``): the pair force-form selector and the
8-term monopole pass, on row-aligned tables or on tables gathered per slot.
"""

from __future__ import annotations

import torch

from particlesimulation_tpu_torch.config import G

# Below this domain size the v4 force form is not the default: its
# contraction-cancellation error (~1e-3 relative on near-EPSILON pairs)
# would exceed the f32 coordinate-quantization error every f32 variant
# already carries. At side >= ~84 the quantization floor ulp(side)/EPSILON
# dwarfs v4's extra term; tiny boxes (golden N1/N2, side=0.05) stay on v2,
# which is ~1000x more accurate near EPSILON there.
V4_MIN_SIDE = 100.0


def pair_force_form(side: float) -> str:
    """Force form of the fused pair pass: "v4" if side >= V4_MIN_SIDE, else "v2"."""
    return "v4" if side >= V4_MIN_SIDE else "v2"


def monopole_tile_forces(xd, yd, mfd, ml_t, mxl_t, myl_t):
    """8 stencil monopole terms per slot, directly on (ncells, K) tiles.

    ml_t, mxl_t, myl_t: (ncells, 8) neighbor mass / mirrored COM per cell.
    """
    g = torch.full((), G, dtype=xd.dtype, device=xd.device)
    gm = g * mfd
    fx = torch.zeros_like(xd)
    fy = torch.zeros_like(xd)
    for l in range(8):
        cm = ml_t[:, l:l + 1]
        dxl = mxl_t[:, l:l + 1] - xd
        dyl = myl_t[:, l:l + 1] - yd
        d2l = dxl * dxl + dyl * dyl
        nzl = d2l > 0.0
        invl = torch.where(nzl, torch.rsqrt(torch.where(nzl, d2l, 1.0)), 0.0)
        sl = gm * cm * (invl * invl * invl)
        fx = fx + sl * dxl
        fy = fy + sl * dyl
    return fx, fy


def monopole_gathered(x, y, mf, ml, mxl, myl, at):
    """8 stencil monopole terms per slot, each slot's cell's terms gathered
    from the (8, ncells + 1) tables of ``stencil.stencil_tables`` by ``at``
    (int32 or int64, the shape of x: the slot's cell, or ncells, the zero
    sentinel). The 8 directions' terms are computed together, in (8, slots)
    tensors, and added in stencil order, so the slots of a cell row get
    ``monopole_tile_forces``' bits."""
    g = torch.full((), G, dtype=x.dtype, device=x.device)
    gm = g * mf
    flat = at.reshape(-1)
    cm, mx, my = (torch.index_select(t, 1, flat).view(8, *x.shape)
                  for t in (ml, mxl, myl))
    dxl = mx - x
    dyl = my - y
    d2l = dxl * dxl + dyl * dyl
    nzl = (d2l > 0.0) & (cm != 0.0)
    invl = torch.where(nzl, torch.rsqrt(torch.where(nzl, d2l, 1.0)), 0.0)
    sl = gm * cm * (invl * invl * invl)
    sx = sl * dxl
    sy = sl * dyl
    fx = torch.zeros_like(x)
    fy = torch.zeros_like(x)
    for l in range(8):
        fx = fx + sx[l]
        fy = fy + sy[l]
    return fx, fy
