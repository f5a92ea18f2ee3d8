"""The port's dense force and collision passes, and its v1 fused pass (plain
torch versions), vs the JAX package's Pallas kernels (interpret mode on the
CPU) and their XLA twins.

Inputs are made with NumPy from a seed and given to both sides as float32 /
int32, with empty slots and planted ε-chains (``_tiles``), and the cases the
CUDA kernels' compaction, x buckets and O(n) count risk (``used=None``: the
port's ``adversarial_tiles``, at K = 32, 160 and 288, the last no multiple of
a power-of-two block). Collision outputs (ft, count) must be exact against
the Pallas kernels. The XLA twin of the
collision pass ranks pairs by slot index when no pid is given, the Pallas
kernel by alive-slot order: both give the same order, so against the twin
only the death set (ft != INF) and the count are compared.

Forces hold to rtol 1e-5 with atol 1e-6·max|f| plus (K+8)·2⁻²⁴ of the
summed magnitudes of each force's terms: the worst-case rounding of a
(K+8)-term f32 sum (the port adds the pair sum and the monopole sum, the
kernel adds the terms one by one onto the pair sum; torch.rsqrt may differ
from XLA's by an ulp).
"""

import contextlib
import functools
import os

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
from tests.test_torch_cell_pairs import _compare, _fused_inputs, _tiles

torch.set_num_threads(2)


def _stencil(seed, ncells):
    """Non-zero (ncells, 8) stencil rows: neighbour masses and COMs around
    the unit cell."""
    rng = np.random.default_rng(seed)
    ml = rng.uniform(5.0, 50.0, (ncells, 8)).astype(np.float32)
    mxl = rng.uniform(-1.0, 2.0, (ncells, 8)).astype(np.float32)
    myl = rng.uniform(-1.0, 2.0, (ncells, 8)).astype(np.float32)
    return ml, mxl, myl


def _term_sums(x, y, m, ml, mxl, myl):
    """Per slot and axis, Σ|term| over the pair and monopole terms (f64)."""
    x, y, m, ml, mxl, myl = (a.astype(np.float64)
                             for a in (x, y, m, ml, mxl, myl))

    def sums(dx, dy, mj):
        # Σ_j mj·|d|/|d|³ per receiver and axis; dx, dy are (cells, i, j).
        r3 = (dx * dx + dy * dy) ** 1.5
        return [np.divide(np.abs(d) * mj, r3, out=np.zeros_like(r3),
                          where=r3 > 0).sum(2) for d in (dx, dy)]

    pair = sums(x[:, None, :] - x[:, :, None], y[:, None, :] - y[:, :, None],
                m[:, None, :])
    mono = sums(mxl[:, None, :] - x[:, :, None],
                myl[:, None, :] - y[:, :, None], ml[:, None, :])
    return [G * m * (p + q) for p, q in zip(pair, mono)]


def _assert_forces(got, ref, terms, kcap):
    for a, b, t in zip(got, ref, terms):
        a = a.numpy().astype(np.float64)
        b = np.asarray(b, dtype=np.float64)
        err = np.abs(a - b)
        tol = (1e-5 * np.abs(b) + 1e-6 * np.abs(b).max()
               + (kcap + 8) * 2.0 ** -24 * t)
        assert (err <= tol).all(), float(err.max())


def _force_inputs(kcap, used, ncells):
    if used is None:
        x, y, m, _, _ = adversarial_tiles(kcap, kcap)
    else:
        x, y, m, _, _ = _tiles(kcap + used, ncells, kcap, used, True)
    return (x, y, m) + _stencil(kcap, x.shape[0])


ADVERSARIAL = [(32, None), (160, None), (288, None)]


@contextlib.contextmanager
def _pallas_tiling(used):
    """On the adversarial tiles, the Pallas kernels take receiver chunks of
    up to 128 (their PSIM_PALLAS_TILE_KB knob, read at each call): the same
    function, in interpret mode some 8x faster at K = 288."""
    old = os.environ.get("PSIM_PALLAS_TILE_KB")
    if used is None:
        os.environ["PSIM_PALLAS_TILE_KB"] = "2048"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("PSIM_PALLAS_TILE_KB", None)
        else:
            os.environ["PSIM_PALLAS_TILE_KB"] = old


@pytest.mark.parametrize("kcap,used", [(32, 24), (160, 100)] + ADVERSARIAL)
def test_dense_forces_ref_matches_pallas(kcap, used):
    arrays = _force_inputs(kcap, used, 12)
    with _pallas_tiling(used):
        ref = pallas_pairs.dense_pairwise_forces(
            *(jnp.asarray(a) for a in arrays), arrays[0].shape[0], kcap)
    got = cell_pairs.dense_pairwise_forces_ref(
        *(torch.from_numpy(a) for a in arrays), kcap)
    _assert_forces(got, ref, _term_sums(*arrays), kcap)


def test_dense_forces_ref_matches_xla_at_max_kcap():
    """K = 1024 (the kernels' largest tile) against the XLA twin, which
    computes the same function as the Pallas kernel."""
    ncells, kcap = 6, 1024
    arrays = _force_inputs(kcap, 900, ncells)
    ref = dense_xla.dense_pairwise_forces(
        *(jnp.asarray(a) for a in arrays), ncells, kcap)
    got = cell_pairs.dense_pairwise_forces_ref(
        *(torch.from_numpy(a) for a in arrays), kcap)
    _assert_forces(got, ref, _term_sums(*arrays), kcap)


def _collision_inputs(kcap, used, ncells, permute):
    if used is None:
        x, y, _, alive, pid = adversarial_tiles(kcap, kcap + 1)
    else:
        x, y, _, alive, pid = _tiles(kcap + used + 1, ncells, kcap, used,
                                     permute)
    return x, y, alive, (pid if permute else None)


@functools.lru_cache(maxsize=None)
def _pallas_collisions(kcap, used, permute):
    """(x, y, alive, pid) and the Pallas kernel's (count, ft) on them."""
    x, y, alive, pid = _collision_inputs(kcap, used, 12, permute)
    with _pallas_tiling(used):
        count, ft = pallas_pairs.dense_collisions(
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(alive), x.shape[0],
            kcap, EPSILON, pid=None if pid is None else jnp.asarray(pid))
    return (x, y, alive, pid), (int(count), np.asarray(ft))


@pytest.mark.parametrize("kcap,used", [(32, 24), (160, 100)] + ADVERSARIAL)
@pytest.mark.parametrize("permute", [False, True], ids=["no_pid", "pid"])
def test_dense_collisions_ref_matches_pallas(kcap, used, permute):
    (x, y, alive, pid), (ref_count, ref_ft) = _pallas_collisions(
        kcap, used, permute)
    count, ft = cell_pairs.dense_collisions_ref(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(alive),
        kcap, EPSILON, None if pid is None else torch.from_numpy(pid))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(ref_ft))
    assert int(count) == int(ref_count) > 0  # the planted chains collide


@pytest.mark.parametrize("kcap", [32, 160, 288])
@pytest.mark.parametrize("permute", [False, True], ids=["no_pid", "pid"])
def test_first_pair_count_is_equal_ft_pairs(kcap, permute):
    """The identity the CUDA kernels count by: a pair is first for both
    ends iff both ends' ft are equal and finite (ranks are distinct among
    alive slots, so a finite ft names one pair). Held on the Pallas
    kernel's outputs over the adversarial tiles."""
    (_, _, alive, _), (count, ft) = _pallas_collisions(kcap, None, permute)
    upper = np.triu(np.ones((kcap, kcap), dtype=bool), 1)
    alive_pair = (alive[:, :, None] > 0) & (alive[:, None, :] > 0)
    equal = (ft[:, :, None] == ft[:, None, :]) & (ft[:, :, None]
                                                 != cell_pairs.INF)
    assert count == int(np.sum(equal & alive_pair & upper)) > 0


def test_dense_collisions_ref_matches_xla_at_max_kcap():
    ncells, kcap = 6, 1024
    x, y, alive, _ = _collision_inputs(kcap, 900, ncells, False)
    ref_count, ref_ft = dense_xla.dense_collisions(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(alive), ncells, kcap,
        EPSILON)
    count, ft = cell_pairs.dense_collisions_ref(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(alive),
        kcap, EPSILON)
    np.testing.assert_array_equal(ft.numpy() != cell_pairs.INF,
                                  np.asarray(ref_ft) != cell_pairs.INF)
    assert int(count) == int(ref_count) > 0


@pytest.mark.parametrize("kcap,used,collide", [
    (32, 24, True), (32, 24, False), (160, 100, True), (32, None, True),
    (160, None, True)])
def test_v1_ref_matches_pallas(kcap, used, collide):
    """The ungated v1 kernel computes the v2 form's function."""
    x, y, m, alive, pid = _fused_inputs(kcap, used, True, 2)
    ncells = x.shape[0]
    with _pallas_tiling(used):
        ref = pallas_pairs.fused_pairs(
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(m),
            jnp.asarray(alive), ncells, kcap, EPSILON, collide=collide,
            pid=jnp.asarray(pid))
    got = cell_pairs.fused_pairs_ref(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(m),
        torch.from_numpy(alive), torch.from_numpy(pid), kcap, EPSILON,
        collide=collide, force_form="v2")
    _compare(got, ref, "v2", x, y, m)
    if collide:
        assert int(ref[2]) > 0


@pytest.mark.parametrize("ncells", [1, 96, 263, 264, 2047, 2048, 10_000])
def test_launch_shapes_fit_the_kernels(ncells):
    """The wrappers' launch rules give shapes the kernels take (whole warps,
    at most 256 threads for the force and fused kernels and 1024 for the
    collision kernel, 1 or 2 receivers a thread, a block per cell at least)
    at every K, on cards of 132 SMs (an H100 SXM) and of fewer."""
    for sms in (132, 78, 1):
        for kcap in range(1, cell_pairs.MAX_KCAP + 1):
            rows, threads, chunks = cell_pairs.force_launch(ncells, kcap, sms)
            assert rows in (1, 2) and chunks >= 1
            assert threads % 32 == 0 and 32 <= threads <= 256
            # every used slot of a row gets a thread
            assert rows * threads * chunks >= kcap or threads == 256
            rows, threads = cell_pairs.fused_launch(kcap)
            assert rows in (1, 2)
            assert threads % 32 == 0 and 32 <= threads <= 256
            # one pass covers a row up to 80% full (the kernel loops on)
            assert 5 * rows * threads >= 4 * kcap or threads == 256
            threads = cell_pairs.collision_threads(ncells, kcap, sms)
            assert threads % 32 == 0 and 32 <= threads <= 1024


def _cpu_inputs():
    ncells, kcap = 8, 32
    x, y, m, alive, pid = (torch.from_numpy(a) for a in
                           _tiles(3, ncells, kcap, 20, True))
    ml, mxl, myl = (torch.from_numpy(a) for a in _stencil(3, ncells))
    return x, y, m, alive, pid, ml, mxl, myl, kcap


def test_wrappers_take_plain_path_on_cpu():
    x, y, m, alive, pid, ml, mxl, myl, kcap = _cpu_inputs()
    before = dict(cell_pairs.LAUNCHES)
    pairs = [
        (cell_pairs.dense_pairwise_forces(x, y, m, ml, mxl, myl, kcap),
         cell_pairs.dense_pairwise_forces_ref(x, y, m, ml, mxl, myl, kcap)),
        (cell_pairs.dense_collisions(x, y, alive, kcap, EPSILON),
         cell_pairs.dense_collisions_ref(x, y, alive, kcap, EPSILON)),
        (cell_pairs.dense_collisions(x, y, alive, kcap, EPSILON, pid),
         cell_pairs.dense_collisions_ref(x, y, alive, kcap, EPSILON, pid)),
        (cell_pairs.fused_pairs(x, y, m, alive, pid, kcap, EPSILON,
                                force_form="v2", gated=False),
         cell_pairs.fused_pairs_ref(x, y, m, alive, pid, kcap, EPSILON,
                                    force_form="v2")),
    ]
    assert cell_pairs.LAUNCHES == before  # no kernel launch on the CPU
    for got, ref in pairs:
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


@pytest.mark.parametrize("bad", [
    "stencil_shape", "stencil_dtype", "alive_dtype", "pid_shape", "kcap",
    "noncontiguous"])
def test_dense_wrappers_reject_bad_input(bad):
    x, y, m, alive, pid, ml, mxl, myl, kcap = _cpu_inputs()
    if bad == "stencil_shape":
        ml = ml[:, :7].contiguous()
    elif bad == "stencil_dtype":
        mxl = mxl.double()
    elif bad == "alive_dtype":
        alive = alive.to(torch.bool)
    elif bad == "pid_shape":
        pid = pid[:4].contiguous()
    elif bad == "kcap":
        kcap = 16
    else:
        y = y.T.contiguous().T  # same values, column-major strides
    with pytest.raises((TypeError, ValueError)):
        if bad in ("stencil_shape", "stencil_dtype", "noncontiguous"):
            cell_pairs.dense_pairwise_forces(x, y, m, ml, mxl, myl, kcap)
        else:
            cell_pairs.dense_collisions(x, y, alive, kcap, EPSILON, pid)
