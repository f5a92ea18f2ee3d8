"""Tiles wider than 1024 slots (K up to 4096): the port's pair, dense and
cell sums passes (plain torch versions) and its routes, against the JAX
package on the CPU.

The JAX package runs tiles up to K = 4096 (``dense_xla.MAX_XLA_KCAP``) on
its XLA kernels: supercell always, the other tile engines under
``dense_backend="xla"``, and every mesh engine. Its Pallas kernels stop at
K = 1024, so under ``dense_backend="pallas"`` (the default) a wider load
climbs the ladder. The port's kernels take K up to 4096 and its engines cap
as JAX's do (``Engine._max_kcap``).

Inputs are made with NumPy from a seed and given to both sides as float32 /
int32. Collision outputs (ft, count) are exact. Forces hold to the fused
kernel's stated tolerance (chip_smoke.py): 1e-5·|f| + 1e-6·max|f| plus
(K + 8)·2⁻²⁴ of the summed magnitudes of each force's terms, the worst-case
rounding of a (K + 8)-term f32 sum in another order (for v4 the terms are
the two that cancel, w·(|xl_i| + |xl_j|)). Engine runs: the same route,
tile capacity, band and tier plans after the run, the collision count and
dead set exact, positions within 1e-6·side and velocities within
1e-5·max|v| (``test_torch_engine._assert_same_run``). Each JAX run happens
once, in a module-scoped cache.
"""

import contextlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesimulation_tpu.config import EPSILON, G
from particlesimulation_tpu.config import Precision as JPrecision
from particlesimulation_tpu.config import SimConfig as JSimConfig
from particlesimulation_tpu.engine import Engine as JEngine
from particlesimulation_tpu.ops import dense_xla
from particlesimulation_tpu.parallel.sharded import (
    ShardedEngine as JShardedEngine)
from particlesimulation_tpu_torch import engine as port_engine
from particlesimulation_tpu_torch.config import SimConfig
from particlesimulation_tpu_torch.engine import Engine
from particlesimulation_tpu_torch.ops.cuda import cell_pairs
from particlesimulation_tpu_torch.parallel.sharded import ShardedEngine
from tests.test_torch_engine import _assert_same_run
from tests.test_torch_sharded import _assert_close
from tests.test_torch_supercell import _sums_inputs

torch.set_num_threads(2)

_JAX = {}
WIDE = [(3, 1056), (2, 2048), (1, 4096)]
BACKENDS = ("pallas", "xla")


def _wide_tiles(seed, ncells, kcap):
    """Rows 60-95 % full over a 4 x 4 square (a few random pairs within
    EPSILON a row), pids permuted per row, and in every row a chain of
    three slots EPSILON/3 apart and a pair EPSILON/2 apart."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 4, (ncells, kcap)).astype(np.float32)
    y = rng.uniform(0, 4, (ncells, kcap)).astype(np.float32)
    m = rng.uniform(0.5, 2.0, (ncells, kcap)).astype(np.float32)
    used = rng.integers(int(0.6 * kcap), int(0.95 * kcap), ncells)
    for r in range(ncells):
        m[r, used[r]:] = 0.0
        x[r, 1] = x[r, 0] + EPSILON / 3
        x[r, 2] = x[r, 1] + EPSILON / 3
        y[r, 1:3] = y[r, 0]
        j = used[r] - 1  # the last used slot, paired with slot 7
        x[r, j] = x[r, 7]
        y[r, j] = y[r, 7] + EPSILON / 2
    alive = (m > 0).astype(np.int32)
    pid = np.argsort(rng.uniform(size=(ncells, kcap)), axis=1)
    return x, y, m, alive, np.ascontiguousarray(pid, dtype=np.int32)


def _term_sums(x, y, m, form, sub=None, stencil=None):
    """Per slot and axis, Σ|term| of its force in float64 (receivers in
    chunks of 256, so that no (K, K) array of a 4096-slot row exists): the
    pair terms (of equal labels, given ``sub``; for v4 the recentred
    w·(|xl_i| + |xl_j|)) and the monopole terms of ``stencil``."""
    x, y, m = (a.astype(np.float64) for a in (x, y, m))
    if form == "v4":
        used = m > 0
        n = np.maximum(used.sum(1, keepdims=True), 1)
        x = x - (x * used).sum(1, keepdims=True) / n
        y = y - (y * used).sum(1, keepdims=True) / n
    out = np.zeros((2,) + x.shape)
    for r in range(x.shape[0]):
        for i0 in range(0, x.shape[1], 256):
            xi, yi = x[r, i0:i0 + 256, None], y[r, i0:i0 + 256, None]
            dx, dy = x[r][None, :] - xi, y[r][None, :] - yi
            d2 = dx * dx + dy * dy
            w = np.divide(np.broadcast_to(m[r][None, :], d2.shape),
                          d2 ** 1.5, out=np.zeros_like(d2), where=d2 > 0)
            if sub is not None:
                w = w * (sub[r][None, :] == sub[r, i0:i0 + 256, None])
            gm = G * m[r, i0:i0 + 256]
            if form == "v4":
                bx = (w * (np.abs(xi) + np.abs(x[r])[None, :])).sum(1)
                by = (w * (np.abs(yi) + np.abs(y[r])[None, :])).sum(1)
            else:
                bx, by = (w * np.abs(dx)).sum(1), (w * np.abs(dy)).sum(1)
            if stencil is not None:
                ml, mxl, myl = (a[r].astype(np.float64) for a in stencil)
                dlx, dly = mxl[None, :] - xi, myl[None, :] - yi
                d2l = dlx * dlx + dly * dly
                wl = np.divide(np.broadcast_to(ml[None, :], d2l.shape),
                               d2l ** 1.5, out=np.zeros_like(d2l),
                               where=d2l > 0)
                bx = bx + (wl * np.abs(dlx)).sum(1)
                by = by + (wl * np.abs(dly)).sum(1)
            out[0, r, i0:i0 + 256] = gm * bx
            out[1, r, i0:i0 + 256] = gm * by
    return out


def _assert_forces(got, ref, terms, kcap):
    for a, b, t in zip(got, ref, terms):
        a = a.numpy().astype(np.float64)
        b = np.asarray(b, dtype=np.float64)
        err = np.abs(a - b)
        tol = (1e-5 * np.abs(b) + 1e-6 * np.abs(b).max()
               + (kcap + 8) * 2.0 ** -24 * t)
        assert (err <= tol).all(), float((err - tol).max())


def _jax_fused(key, fn, tiles, kcap, collide, sub=None):
    if key not in _JAX:
        x, y, m, alive, pid = tiles
        kw = {} if sub is None else {"sub": jnp.asarray(sub)}
        out = fn(jnp.asarray(x), jnp.asarray(y), jnp.asarray(m),
                 jnp.asarray(alive), x.shape[0], kcap, EPSILON,
                 collide=collide, pid=jnp.asarray(pid), **kw)
        _JAX[key] = tuple(np.asarray(a) for a in out)
    return _JAX[key]


def _check_fused(got, ref, tiles, form, kcap, sub=None):
    x, y, m, _, _ = tiles
    fx, fy, count, ft = got
    np.testing.assert_array_equal(ft.numpy(), ref[3])
    assert int(count) == int(ref[2])
    m_post = np.where(ft.numpy() != cell_pairs.INF, 0.0, m)
    _assert_forces((fx, fy), ref[:2], _term_sums(x, y, m_post, form, sub),
                   kcap)


# -- (a) the fused pass in v4, v2 and v1 ------------------------------------

@pytest.mark.parametrize("collide", [True, False], ids=["collide", "forces"])
@pytest.mark.parametrize("form", ["v4", "v2", "v1"])
@pytest.mark.parametrize("ncells,kcap", WIDE, ids=lambda v: str(v))
def test_fused_ref_matches_xla_wide(ncells, kcap, form, collide):
    """The plain fused pass (the CPU path of ``fused_pairs``; v1 is the
    ungated call) against JAX's ``fused_pairs_v4``, ``fused_pairs_v2`` and
    ``fused_pairs`` (v1) at K = 1056, 2048 and 4096."""
    tiles = _wide_tiles(kcap + ncells, ncells, kcap)
    fn = {"v4": dense_xla.fused_pairs_v4, "v2": dense_xla.fused_pairs_v2,
          "v1": dense_xla.fused_pairs}[form]
    ref = _jax_fused(("fused", ncells, kcap, form, collide), fn, tiles,
                     kcap, collide)
    got = cell_pairs.fused_pairs(
        *map(torch.from_numpy, tiles), kcap, EPSILON, collide=collide,
        force_form="v2" if form == "v1" else form, gated=form != "v1")
    _check_fused(got, ref, tiles, "v4" if form == "v4" else "v2", kcap)
    if collide:
        # The planted chain and pair of every row collide.
        assert int(ref[2]) >= 2 * ncells


# -- (b) the labelled form ---------------------------------------------------

@pytest.mark.parametrize("collide", [True, False], ids=["collide", "forces"])
@pytest.mark.parametrize("form", ["v4", "v2"])
def test_labelled_ref_matches_xla_wide(form, collide):
    """The labelled pass (supercell rows of S² = 9 cells, a share of -1
    labels) at K = 1100 against the XLA forms with ``sub=``; the planted
    chain of each row shares one label."""
    ncells, kcap = 2, 1100
    tiles = _wide_tiles(31, ncells, kcap)
    rng = np.random.default_rng(32)
    sub = rng.integers(-1, 9, (ncells, kcap)).astype(np.int32)
    sub[:, :3] = 4
    fn = {"v4": dense_xla.fused_pairs_v4, "v2": dense_xla.fused_pairs_v2}
    ref = _jax_fused(("labelled", form, collide), fn[form], tiles, kcap,
                     collide, sub)
    got = cell_pairs.fused_pairs(*map(torch.from_numpy, tiles), kcap,
                                 EPSILON, collide=collide, force_form=form,
                                 sub=torch.from_numpy(sub))
    _check_fused(got, ref, tiles, form, kcap, sub)
    if collide:
        assert int(ref[2]) >= ncells


# -- (c) the dense kernels ---------------------------------------------------

def _stencil(seed, ncells):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(lo, hi, (ncells, 8)).astype(np.float32)
                 for lo, hi in ((5.0, 50.0), (-1.0, 5.0), (-1.0, 5.0)))


def test_dense_forces_ref_matches_xla_wide():
    ncells, kcap = 2, 2048
    x, y, m, _, _ = _wide_tiles(41, ncells, kcap)
    st = _stencil(42, ncells)
    ref = dense_xla.dense_pairwise_forces(*map(jnp.asarray, (x, y, m) + st),
                                          ncells, kcap)
    got = cell_pairs.dense_pairwise_forces(
        *map(torch.from_numpy, (x, y, m) + st), kcap)
    _assert_forces(got, [np.asarray(r) for r in ref],
                   _term_sums(x, y, m, "v2", stencil=st), kcap)


@pytest.mark.parametrize("with_pid", [False, True], ids=["slots", "pid"])
def test_dense_collisions_ref_matches_xla_wide(with_pid):
    """With pids the ranks are the same function: ft exact. Without, the
    XLA twin ranks by slot index and the port by alive-slot order (the same
    order, other numbers): the death set and the count exact."""
    ncells, kcap = 2, 2048
    x, y, _, alive, pid = _wide_tiles(43, ncells, kcap)
    pid = pid if with_pid else None
    ref = dense_xla.dense_collisions(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(alive), ncells, kcap,
        EPSILON, pid=None if pid is None else jnp.asarray(pid))
    count, ft = cell_pairs.dense_collisions(
        *map(torch.from_numpy, (x, y, alive)), kcap, EPSILON,
        None if pid is None else torch.from_numpy(pid))
    assert int(count) == int(ref[0]) >= 2 * ncells
    if with_pid:
        np.testing.assert_array_equal(ft.numpy(), np.asarray(ref[1]))
    else:
        np.testing.assert_array_equal(ft.numpy() != cell_pairs.INF,
                                      np.asarray(ref[1]) != cell_pairs.INF)


# -- (d) the cell sums -------------------------------------------------------

@pytest.mark.parametrize("nc,S", [(12, 6), (10, 4)])
def test_cell_sums_match_jax_einsum_wide(nc, S):
    """Rows of K = 1100 slots against JAX's one-hot ``einsum`` (the JAX
    supercell COM), unpacked onto the true grid; empty cells 0."""
    kcap = 1100
    mf, mx, my, cell, sub = _sums_inputs(nc + S, nc, S, kcap)
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


# -- no fallback past the cap ------------------------------------------------

@pytest.mark.parametrize("kernel", ["fused", "labelled", "forces",
                                    "collisions", "sums"])
def test_wrappers_refuse_past_4096(kernel):
    """A launch past ``MAX_KCAP`` raises; there is no fallback."""
    k = cell_pairs.MAX_KCAP + 1
    assert k == 4097
    z = torch.zeros((1, k))
    i = torch.zeros((1, k), dtype=torch.int32)
    st = torch.zeros((1, 8))
    call = {
        "fused": lambda: cell_pairs.fused_pairs(z, z, z, i, i, k, EPSILON),
        "labelled": lambda: cell_pairs.fused_pairs(z, z, z, i, i, k, EPSILON,
                                                   sub=i),
        "forces": lambda: cell_pairs.dense_pairwise_forces(z, z, z, st, st,
                                                           st, k),
        "collisions": lambda: cell_pairs.dense_collisions(z, z, i, k,
                                                          EPSILON),
        "sums": lambda: cell_pairs.supercell_cell_sums(z, z, z, i, 4)}[kernel]
    with pytest.raises(ValueError, match="4096"):
        call()


# -- (e) the engines at K > 1024, both backends ------------------------------

# (label, (seed, side, ncside, N), steps, impl asked for, forced band plan)
ENGINES = [
    # 4 cells of ~1250 particles: resident at K = 1440 under "xla"; under
    # "pallas" the ladder resident -> dense -> sweep.
    ("resident", (1, 10.0, 2, 5000), 2, None, None),
    # A blob of four ~1050-particle cells in a 4 x 4 grid, its band planted
    # at K = 960: it grows to 1440 under "xla"; under "pallas" it stops at
    # 1024 and the ladder goes on to dense and the sweep.
    ("banded", (-7, 100.0, 4, 5000), 2, "banded",
     ((0, 1, 160), (1, 2, 960), (3, 1, 160))),
    # Super-cell rows of 2 x 2 cells, ~1250 particles each: supercell at
    # K = 1440 under both (JAX's supercell cap is 4096 whatever the
    # backend).
    ("supercell", (3, 10.0, 8, 20000), 2, "supercell", None),
    # The same blob on the dense engine: from the Poisson bound (K = 416)
    # to K = 1344 under "xla"; under "pallas" past 1024, so the sweep.
    ("dense", (-7, 100.0, 4, 5000), 2, "dense", None),
]


@contextlib.contextmanager
def _env(**kv):
    """Environment variables set for the JAX census (tile engines on a
    CPU), restored after."""
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _jax_engine(case, backend):
    key = ("engine", case[0], backend)
    if key not in _JAX:
        _, args, steps, impl, plan = case
        with _env(PSIM_DENSE="1"):
            eng = JEngine(JSimConfig(*args, precision=JPrecision.FAST),
                          impl=impl, dense_backend=backend)
            state = eng.init_state()
            if plan is not None:
                eng._band_plan = plan
            out = eng.run(state, steps)
        _JAX[key] = (eng, out)
    return _JAX[key]


def _plans(eng):
    return (eng.impl, eng.kcap,
            eng._band_plan and tuple(map(tuple, eng._band_plan)),
            eng._tier_plan and tuple(map(tuple, eng._tier_plan)))


def check_engine(case, backend):
    """The port's ``Engine`` on ``case`` under ``backend`` against JAX's:
    the same route, kcap and plans after the run, the same result; on tiles
    wider than 1024 exactly where JAX keeps them (supercell always, the
    others under "xla" only)."""
    label, args, steps, impl, plan = case
    jeng, ref = _jax_engine(case, backend)
    eng = Engine(SimConfig(*args), impl=impl, device="cpu",
                 dense_backend=backend)
    state = eng.init_state()
    if plan is not None:
        eng._band_plan = plan
    got = eng.run(state, steps)
    assert _plans(eng) == _plans(jeng)
    _assert_same_run(got, ref, args[1])
    wide = eng.impl != "sweep" and eng.kcap > port_engine.MAX_DENSE_KCAP
    assert wide == (label == "supercell" or backend == "xla")


@pytest.mark.parametrize("backend", ["xla"])
@pytest.mark.parametrize("case", ENGINES, ids=lambda c: c[0])
def test_engine_matches_jax_wide(case, backend):
    """Under "xla". The same cases under "pallas", where JAX's resident,
    banded and dense ladders run its Pallas kernels in interpret mode
    (~2-3 minutes each), are in test_torch_wide_ladders_resident.py and
    test_torch_wide_ladders_clustered.py, so that pytest-xdist's
    ``--dist loadfile`` runs them beside this file, not after it."""
    check_engine(case, backend)


# -- (f) the route table -----------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("impl", port_engine.IMPLS)
def test_max_kcap_matches_jax(impl, backend):
    args = (1, 10.0, 8, 1000)
    jeng = JEngine(JSimConfig(*args, precision=JPrecision.FAST), impl=impl,
                   dense_backend=backend)
    eng = Engine(SimConfig(*args), impl=impl, device="cpu",
                 dense_backend=backend)
    assert eng._max_kcap() == jeng._max_kcap()
    assert eng._max_kcap() == (4096 if impl == "supercell"
                               or backend == "xla" else 1024)


def test_dense_backend_is_checked():
    with pytest.raises(ValueError, match="dense_backend"):
        Engine(SimConfig(1, 10.0, 8, 1000), device="cpu",
               dense_backend="triton")


# -- (g) the mesh at K > 1024 ------------------------------------------------

def test_mesh_matches_jax_wide():
    """D = 2 through the mesh census: a uniform load of ~1250 particles a
    cell stays on resident tiles at K = 1440 (JAX's mesh caps at 4096), with
    JAX's result."""
    args, steps, d = (1, 10.0, 4, 20000), 2, 2
    key = ("mesh", args, d)
    if key not in _JAX:
        jeng = JShardedEngine(JSimConfig(*args, precision=JPrecision.FAST,
                                         n_shards=d))
        out = jeng.run(jeng.init_state(), steps)
        assert int(np.asarray(out.overflow)) == 0
        _JAX[key] = (jeng, jeng.gather(out), int(np.asarray(out.collisions)))
    jeng, ref, count = _JAX[key]
    eng = ShardedEngine(SimConfig(*args, n_shards=d), device="cpu")
    out = eng.run(eng.init_state(), steps)
    assert eng.impl == jeng.impl == "resident"
    assert eng.kcap == jeng.kcap > port_engine.MAX_DENSE_KCAP
    assert int(out.overflow) == 0 and int(out.collisions) == count
    _assert_close(eng.gather(out), ref, args[1])
