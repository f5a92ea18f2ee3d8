"""The supercell engine's two passes, as the redesigned CUDA kernels see
them, on the CPU (plain versions) against the JAX package.

* The labelled pair pass (``cell_pairs.fused_pairs(..., sub=)``) against the
  XLA twins ``dense_xla.fused_pairs_v2``/``_v4`` with ``sub`` on the label
  layouts the kernels' grouping by label risks
  (``adversarial.label_layouts``: one label holding every slot, every slot
  its own label, runs between -1 labels, labels that return later in the
  row, random labels), at K = 32 and 64 (the warp kernel's one and two slots
  a lane), collide on and off. Collisions exact; forces to the tolerance of
  ``test_torch_cell_pairs.py`` (rtol 1e-5, atol 1e-6·max|f|, plus 8 ulps of
  the v4 terms that cancel), over the pairs of equal labels.
* The cell sums (``supercell_cell_sums``) against the JAX one-hot
  contraction on an uneven partition whose cells' slots are spread over
  their rows.
* The launch rules as pure functions, and the output digest of
  ``chip_smoke.py --supercell-times``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from particlesimulation_tpu.config import EPSILON
from particlesimulation_tpu.ops import dense_xla
from particlesimulation_tpu_torch.ops.cuda import cell_pairs
from particlesimulation_tpu_torch.ops.cuda.adversarial import (
    LABEL_LAYOUTS, adversarial_tiles, label_layouts)
from tests.test_torch_cell_pairs import _compare

torch.set_num_threads(2)


@pytest.mark.parametrize("collide", [True, False])
@pytest.mark.parametrize("form", ["v2", "v4"])
@pytest.mark.parametrize("kcap", [32, 64])
def test_labelled_layouts_match_xla(kcap, form, collide):
    """The adversarial tiles once under each label layout, stacked into
    one tile set (one XLA call)."""
    tiles = adversarial_tiles(kcap, kcap + 11)
    rows = tiles[0].shape[0]
    lay = label_layouts(kcap, rows, seed=kcap)
    x, y, m, alive, pid = (np.concatenate([a] * len(LABEL_LAYOUTS))
                           for a in tiles)
    sub = np.concatenate([lay[name] for name in LABEL_LAYOUTS])
    xla_fn = {"v2": dense_xla.fused_pairs_v2,
              "v4": dense_xla.fused_pairs_v4}[form]
    ref = xla_fn(jnp.asarray(x), jnp.asarray(y), jnp.asarray(m),
                 jnp.asarray(alive), x.shape[0], kcap, EPSILON,
                 collide=collide, pid=jnp.asarray(pid), sub=jnp.asarray(sub))
    got = cell_pairs.fused_pairs(
        *map(torch.from_numpy, (x, y, m, alive, pid)), kcap, EPSILON,
        collide=collide, force_form=form, sub=torch.from_numpy(sub))
    _compare(got, ref, form, x, y, m, sub)
    plain = cell_pairs.fused_pairs(
        *map(torch.from_numpy, tiles), kcap, EPSILON, collide=collide,
        force_form=form)
    for k, name in enumerate(LABEL_LAYOUTS):
        part = [t[k * rows:(k + 1) * rows] for t in got[:2]] + [
            got[3][k * rows:(k + 1) * rows]]
        if name == "distinct" or not collide:
            assert (part[2].numpy() == cell_pairs.INF).all()
        if name == "distinct":
            assert not part[0].abs().max() > 0
        if name == "one":  # the unlabelled pass, bit for bit
            for a, b in zip(part, (plain[0], plain[1], plain[3])):
                assert torch.equal(a, b)
    if not collide:
        assert int(got[2]) == 0


def test_label_layouts_shapes():
    """Each layout covers every slot; "returning" spreads each label over
    the whole row with -1s between, "gaps" keeps runs of three."""
    for kcap in (32, 64, 160):
        lay = label_layouts(kcap, rows=9, seed=1)
        assert set(lay) == set(LABEL_LAYOUTS)
        for v in lay.values():
            assert v.shape == (9, kcap) and v.dtype == np.int32
        ret = lay["returning"][0]
        for lab in (0, 1, 2):
            at = np.flatnonzero(ret == lab)
            assert at.min() < kcap // 4 and at.max() >= 3 * kcap // 4
        assert (ret == -1).any() and (lay["gaps"] == -1).any()
        assert len(np.unique(lay["distinct"][0])) == kcap
        assert (lay["one"] == 0).all()


def _uneven_sums(seed, nc, S, kcap):
    """Super-cell tiles of an nc² grid coarsened by S, with S not dividing
    nc; each row's slots hold the cells of its super-cell in an order that
    returns to a cell later in the row, a fifth of them unbinned."""
    rng = np.random.default_rng(seed)
    nsc = -(-nc // S)
    rows = nsc * nsc
    scy, scx = np.divmod(np.arange(rows), nsc)
    k = np.arange(kcap)
    sy, sx = (k // 3) % S, (k * 7 + 1) % S
    cy, cx = scy[:, None] * S + sy, scx[:, None] * S + sx
    valid = (cy < nc) & (cx < nc) & (rng.uniform(size=(rows, kcap)) > 0.2)
    cell = np.where(valid, cy * nc + cx, -1).astype(np.int32)
    sub = np.where(valid, sy * S + sx, -1)
    mf = np.where(valid, rng.uniform(0.5, 2.0, (rows, kcap)), 0.0)
    x = rng.uniform(0, nc, (rows, kcap))
    y = rng.uniform(0, nc, (rows, kcap))
    mf, x, y = (a.astype(np.float32) for a in (mf, x, y))
    return mf, mf * x, mf * y, cell, sub


@pytest.mark.parametrize("nc,S,kcap", [(13, 4, 64), (11, 3, 32),
                                       (9, 4, 160)])
def test_cell_sums_match_jax_einsum_uneven(nc, S, kcap):
    """Against einsum("rk,rks->rs") unpacked onto the true grid (rtol 1e-6:
    the matrix product adds in another order); each cell's sum also equals
    a sequential f32 sum in slot order bit for bit, and empty cells are
    0."""
    mf, mx, my, cell, sub = _uneven_sums(nc * S + kcap, nc, S, kcap)
    got = cell_pairs.supercell_cell_sums(*map(torch.from_numpy,
                                              (mf, mx, my, cell)), nc * nc)
    onehot = ((jnp.asarray(sub)[:, :, None] == jnp.arange(S * S))
              & jnp.asarray(cell >= 0)[:, :, None]).astype(jnp.float32)
    nsc = -(-nc // S)
    for g, v in zip(got, (mf, mx, my)):
        per = np.asarray(jnp.einsum("rk,rks->rs", jnp.asarray(v), onehot))
        grid = per.reshape(nsc, nsc, S, S).transpose(0, 2, 1, 3).reshape(
            nsc * S, nsc * S)[:nc, :nc].reshape(-1)
        np.testing.assert_allclose(g.numpy(), grid, rtol=1e-6, atol=0)
        assert (g.numpy()[grid == 0] == 0).all()
        want = np.zeros(nc * nc, np.float32)
        for c, a in zip(cell.reshape(-1), v.reshape(-1)):
            if c >= 0:
                want[c] = np.float32(want[c] + a)
        np.testing.assert_array_equal(g.numpy(), want)


@pytest.mark.parametrize("kcap", [1, 8, 31, 32, 33, 63, 64, 65, 96, 160,
                                  288, 512, 864, 1024])
def test_labelled_launch_rule(kcap):
    """A warp a row up to WARP_ROW_KCAP slots (a lane's ceil(K/32) slots,
    whole warps, at most 16 rows a block); a block a row above it, in the
    unlabelled rule's shape."""
    rows_a_block, receivers, threads = cell_pairs.labelled_launch(kcap)
    if kcap <= cell_pairs.WARP_ROW_KCAP:
        assert 1 <= rows_a_block <= 16
        assert receivers == -(-kcap // 32) and receivers in (1, 2)
        assert threads == 32 * rows_a_block
    else:
        assert rows_a_block == 0
        assert (receivers, threads) == cell_pairs.fused_launch(kcap)
        assert receivers in (1, 2)
        assert 32 <= threads <= 256 and threads % 32 == 0


@pytest.mark.parametrize("kcap", [1, 32, 64, 100, 160, 288, 1024])
def test_cell_sums_launch_rule(kcap):
    """1 to 8 rows a block, each warp's table at least 2 K slots, the
    block's tables within 48 KB wherever one warp's fits."""
    warps = cell_pairs.cell_sums_launch(kcap)
    table = max(64, 1 << (2 * kcap - 1).bit_length())
    assert table >= 2 * kcap
    assert 1 <= warps <= 8
    per_warp = 16 * (table + 32)
    assert warps * per_warp <= max(48 * 1024, per_warp)
    if kcap <= 64:
        assert warps == 8


def test_digest_tells_bits_apart():
    """The same tensors give the same digest; one flipped bit, -0 for +0,
    another dtype or shape, or another order give another."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
    b = torch.from_numpy(rng.integers(0, 9, (4, 8)).astype(np.int32))
    c = torch.tensor(7, dtype=torch.int32)
    d0 = chip_smoke.digest([a, b, c])
    assert d0 == chip_smoke.digest([a.clone(), b.clone(), c.clone()])
    flipped = a.clone()
    flipped.view(torch.int32)[2, 3] ^= 1
    assert chip_smoke.digest([flipped, b, c]) != d0
    z = torch.zeros(3)
    assert chip_smoke.digest([z]) != chip_smoke.digest([-z])
    assert chip_smoke.digest([b.to(torch.int64), a, c]) != chip_smoke.digest(
        [b, a, c])
    assert chip_smoke.digest([a.reshape(8, 4), b, c]) != d0
    assert chip_smoke.digest([b, a, c]) != d0
