"""The port's fused pair pass (plain torch version) vs the JAX package's
Pallas kernel (interpret mode on the CPU) and its XLA twin.

Inputs are made with NumPy from a seed and given to both sides as float32 /
int32: tiles with empty slots and planted ε-chains (``_tiles``), and the
port's ``adversarial_tiles`` (``used=None``) at K = 32 and 160, the rows
the CUDA kernels' compactions risk (among them a row whose alive slots all
collide and a row with one used slot). Collision outputs (ft, count) must
be exact. Forces hold to
rtol 1e-5 with atol 1e-6·max|f| (the tolerance of test_pallas_fused.py):
the partner sums run in another order and torch.rsqrt may differ from XLA's
by an ulp. The v4 form computes fx_i = G·m_i·(Σ w_ij·xl_j − xl_i·Σ w_ij),
whose two terms cancel on near pairs, so its rounding error is bounded by the
terms' size, not the result's: v4 forces hold to that tolerance plus 8 ulps
of G·m_i·Σ_j w_ij·(|xl_i| + |xl_j|) per element (w = m_j/d³ on the
recentred coordinates xl).

The labelled pass (``sub=``, the supercell engine's) is held against the
XLA twins ``dense_xla.fused_pairs_v2``/``_v4`` with ``sub`` (the Pallas
kernels take no label), with the same tolerances over the pairs of equal
labels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesimulation_tpu.config import EPSILON, G
from particlesimulation_tpu.ops import dense_xla
from particlesimulation_tpu.ops.pallas import cell_pairs as pallas_pairs
from particlesimulation_tpu_torch.ops.cuda import cell_pairs
from particlesimulation_tpu_torch.ops.cuda.adversarial import (
    adversarial_tiles)

torch.set_num_threads(2)


def _tiles(seed, ncells, kcap, used, permute_pid):
    """Tiles with empty slots past ``used`` and planted colliding chains."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (ncells, kcap)).astype(np.float32)
    y = rng.uniform(0, 1, (ncells, kcap)).astype(np.float32)
    m = rng.uniform(0.5, 2.0, (ncells, kcap)).astype(np.float32)
    m[:, used:] = 0.0
    for c in (1, 5):
        # A chain: slot 0 - slot 1 - slot 2, each EPSILON/3 apart.
        x[c, 1] = x[c, 0] + EPSILON / 3
        y[c, 1] = y[c, 0]
        x[c, 2] = x[c, 1] + EPSILON / 3
        y[c, 2] = y[c, 1]
    alive = (m > 0).astype(np.int32)
    if permute_pid:
        pid = np.argsort(rng.uniform(size=(ncells, kcap)), axis=1)
    else:
        pid = np.broadcast_to(np.arange(kcap), (ncells, kcap))
    return x, y, m, alive, np.ascontiguousarray(pid, dtype=np.int32)


def _recentred(c, m_post):
    """Coordinate c recentred on the mean of used slots, in float64."""
    c = c.astype(np.float64)
    m = m_post.astype(np.float64)
    used = m > 0
    return c - (c * used).sum(1, keepdims=True) / np.maximum(
        used.sum(1, keepdims=True), 1)


def _v4_bound(x, y, m_post, sub=None):
    """Per element, 8 ulps of G·m_i·Σ_j w_ij·(|cl_i| + |cl_j|) for each
    recentred coordinate cl (the size of the two v4 terms that cancel), over
    the pairs of equal labels where ``sub`` is given."""
    xl, yl = _recentred(x, m_post), _recentred(y, m_post)
    d2 = ((xl[:, None, :] - xl[:, :, None]) ** 2
          + (yl[:, None, :] - yl[:, :, None]) ** 2)
    pair = d2 > 0
    if sub is not None:
        pair &= sub[:, :, None] == sub[:, None, :]
    w = np.divide(np.broadcast_to(m_post[:, None, :], d2.shape), d2 ** 1.5,
                  out=np.zeros_like(d2), where=pair)
    gm = G * m_post.astype(np.float64)
    return tuple(2.0 ** -20 * gm * np.sum(
        w * (np.abs(cl)[:, :, None] + np.abs(cl)[:, None, :]), axis=2)
        for cl in (xl, yl))


def _compare(got, ref, form, x, y, m, sub=None):
    fx, fy, cnt, ft = (t.numpy() for t in got)
    np.testing.assert_array_equal(ft, np.asarray(ref[3]))
    assert int(cnt) == int(ref[2])
    m_post = np.where(ft != cell_pairs.INF, 0.0, m)
    bounds = _v4_bound(x, y, m_post, sub) if form == "v4" else (0.0, 0.0)
    for a, b, bound in ((fx, ref[0], bounds[0]), (fy, ref[1], bounds[1])):
        b = np.asarray(b)
        scale = float(np.abs(b).max()) + 1e-30
        err = np.abs(a.astype(np.float64) - b)
        assert (err <= 1e-5 * np.abs(b) + 1e-6 * scale + bound).all(), (
            float(err.max()))


CASES = [
    # (kcap, used, force_form, collide, permute_pid)
    (32, 24, "v2", True, False),
    (32, 24, "v2", True, True),
    (32, 24, "v4", True, False),
    (32, 24, "v4", True, True),
    (32, 24, "v2", False, True),
    (32, 24, "v4", False, True),
    (160, 100, "v4", True, True),
    (32, None, "v2", True, True),
    (32, None, "v4", True, True),
    (160, None, "v2", True, True),
    (160, None, "v4", True, True),
]


def _fused_inputs(kcap, used, permute, seed_offset=0):
    """(x, y, m, alive, pid): ``_tiles`` of 12 cells, or the adversarial
    tiles where ``used`` is None."""
    if used is None:
        return adversarial_tiles(kcap, kcap + 3 + seed_offset)
    return _tiles(kcap + used + seed_offset, 12, kcap, used, permute)


@pytest.mark.parametrize("kcap,used,form,collide,permute", CASES)
def test_ref_matches_pallas(kcap, used, form, collide, permute):
    x, y, m, alive, pid = _fused_inputs(kcap, used, permute)
    ncells = x.shape[0]
    pallas_fn = {"v2": pallas_pairs.fused_pairs_v2,
                 "v4": pallas_pairs.fused_pairs_v4}[form]
    ref = pallas_fn(jnp.asarray(x), jnp.asarray(y), jnp.asarray(m),
                    jnp.asarray(alive), ncells, kcap, EPSILON,
                    collide=collide, pid=jnp.asarray(pid))
    got = cell_pairs.fused_pairs_ref(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(m),
        torch.from_numpy(alive), torch.from_numpy(pid), kcap, EPSILON,
        collide=collide, force_form=form)
    _compare(got, ref, form, x, y, m)
    if collide:
        assert int(ref[2]) > 0  # the planted chains collide


@pytest.mark.parametrize("form", ["v2", "v4"])
def test_ref_matches_xla_at_max_kcap(form):
    """K = 1024 (the kernel's largest tile) against the XLA twin, which
    computes the same function as the Pallas kernel."""
    ncells, kcap = 6, 1024
    x, y, m, alive, pid = _tiles(7, ncells, kcap, 900, True)
    xla_fn = {"v2": dense_xla.fused_pairs_v2,
              "v4": dense_xla.fused_pairs_v4}[form]
    ref = xla_fn(jnp.asarray(x), jnp.asarray(y), jnp.asarray(m),
                 jnp.asarray(alive), ncells, kcap, EPSILON,
                 pid=jnp.asarray(pid))
    got = cell_pairs.fused_pairs_ref(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(m),
        torch.from_numpy(alive), torch.from_numpy(pid), kcap, EPSILON,
        force_form=form)
    _compare(got, ref, form, x, y, m)


def test_wrapper_takes_plain_path_on_cpu():
    x, y, m, alive, pid = (torch.from_numpy(a) for a in
                           _tiles(3, 8, 32, 20, True))
    before = dict(cell_pairs.LAUNCHES)
    got = cell_pairs.fused_pairs(x, y, m, alive, pid, 32, EPSILON)
    ref = cell_pairs.fused_pairs_ref(x, y, m, alive, pid, 32, EPSILON)
    assert cell_pairs.LAUNCHES == before  # no kernel launch on the CPU
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["dtype", "shape", "kcap", "form"])
def test_wrapper_rejects_bad_input(bad):
    x, y, m, alive, pid = (torch.from_numpy(a) for a in
                           _tiles(3, 8, 32, 20, True))
    kcap, form = 32, "v4"
    if bad == "dtype":
        alive = alive.to(torch.int64)
    elif bad == "shape":
        y = y[:, :16].contiguous()
    elif bad == "kcap":
        kcap = 16
    else:
        form = "v3"
    with pytest.raises((TypeError, ValueError)):
        cell_pairs.fused_pairs(x, y, m, alive, pid, kcap, EPSILON,
                               force_form=form)


def _labels(x, seed, chains=((1, (2, 2, 2)), (5, (0, 1, 0)))):
    """Labels 0-3 with a share of -1, per slot; each planted chain's three
    slots get the given labels (row 1: one cell, all three pairs collide;
    row 5: only the outer pair, 2ε/3 apart, shares a cell)."""
    rng = np.random.default_rng(seed)
    sub = rng.integers(-1, 4, x.shape).astype(np.int32)
    for row, labs in chains:
        sub[row, :3] = labs
    return sub


def _labelled(kcap, used, form, collide, sub_of):
    x, y, m, alive, pid = _fused_inputs(kcap, used, True, seed_offset=1)
    sub = sub_of(x)
    xla_fn = {"v2": dense_xla.fused_pairs_v2,
              "v4": dense_xla.fused_pairs_v4}[form]
    ref = xla_fn(jnp.asarray(x), jnp.asarray(y), jnp.asarray(m),
                 jnp.asarray(alive), x.shape[0], kcap, EPSILON,
                 collide=collide, pid=jnp.asarray(pid), sub=jnp.asarray(sub))
    got = cell_pairs.fused_pairs(
        *map(torch.from_numpy, (x, y, m, alive, pid)), kcap, EPSILON,
        collide=collide, force_form=form, sub=torch.from_numpy(sub))
    _compare(got, ref, form, x, y, m, sub)
    return got, ref


@pytest.mark.parametrize("kcap,used,form,collide", [
    (32, 24, "v2", True), (32, 24, "v4", True), (32, 24, "v2", False),
    (32, 24, "v4", False), (160, 100, "v4", True),
    (32, None, "v2", True), (32, None, "v4", True), (160, None, "v4", True),
])
def test_labelled_ref_matches_xla(kcap, used, form, collide):
    """Planted-chain and adversarial tiles with random labels and -1s."""
    got, ref = _labelled(kcap, used, form, collide,
                         lambda x: _labels(x, kcap + 7))
    if collide and used is not None:
        ft = got[3].numpy()
        assert (ft[1, :3] != cell_pairs.INF).all()     # one cell: all die
        assert ft[5, 1] == cell_pairs.INF != ft[5, 0]  # 5's middle lives
        assert int(ref[2]) > 0


@pytest.mark.parametrize("form", ["v2", "v4"])
def test_labels_across_every_near_pair(form):
    """Rows whose near pairs all cross labels: no collision there, every
    ft INF, the count 0 in the whole tile set."""
    def cross(x):
        return _labels(x, 3, chains=((1, (0, 1, 2)), (5, (3, 2, 1))))

    got, ref = _labelled(32, 24, form, True, cross)
    assert int(got[2]) == int(ref[2]) == 0
    assert (got[3].numpy() == cell_pairs.INF).all()


@pytest.mark.parametrize("form", ["v2", "v4"])
def test_all_zero_labels_are_unlabelled(form):
    """Every label 0 gives the unlabelled pass bit for bit."""
    args = [torch.from_numpy(a) for a in _fused_inputs(32, 24, True)]
    plain = cell_pairs.fused_pairs(*args, 32, EPSILON, force_form=form)
    zero = cell_pairs.fused_pairs(*args, 32, EPSILON, force_form=form,
                                  sub=torch.zeros_like(args[4]))
    for a, b in zip(plain, zero):
        assert torch.equal(a, b)


def test_labelled_pass_refuses_v1():
    args = [torch.from_numpy(a) for a in _fused_inputs(32, 24, True)]
    with pytest.raises(ValueError, match="v1"):
        cell_pairs.fused_pairs(*args, 32, EPSILON, gated=False,
                               sub=torch.zeros_like(args[4]))
