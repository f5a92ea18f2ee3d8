"""The direct kernels' minimum image by threshold, held to JAX's division.

The CUDA kernels of ``csrc/direct_nbody.cu`` take the minimum image by a
threshold T that the host finds (``min_image_threshold``), and the
collision kernel rules pairs out on x alone by a window
(``collision_window``). Neither kernel runs on the CPU, so these tests hold
the same arithmetic, written in plain torch, to JAX's form
``d - side * jnp.round(d / side)`` on the CPU, bit for bit (bit patterns
are compared, so the sign of zero counts), on: a seeded draw of position
differences, every float within 2000 ulps of ±T, the 2000 floats below
±side, ±0 and ±side/2; at the sides of the golden and chip configurations
and 10000, in float32 and float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from particlesimulation_tpu_torch.ops.cuda import direct_nbody as dk
from particlesimulation_tpu_torch.ops.cuda import direct_sweep

SIDES = (1000.0, 5000.0, 100.0, 3500.0, 1.0, 0.05, 8.0, 10000.0)
DTYPES = (torch.float32, torch.float64)
NP = {torch.float32: (np.float32, np.uint32),
      torch.float64: (np.float64, np.uint64)}
ULPS = 2000


def _floats_from(bits, count, dtype):
    f, u = NP[dtype]
    return np.arange(bits, bits + count, dtype=np.uint64).astype(u).view(f)


def _differences(side, dtype):
    """The test's differences d, as a float array of ``dtype``."""
    f, u = NP[dtype]
    rng = np.random.default_rng(12)
    a, b = rng.uniform(0.0, side, (2, 100_000)).astype(f)
    t = f(dk.min_image_threshold(side, dtype))
    tb, sb = int(t.view(u)), int(f(side).view(u))
    near = _floats_from(tb - ULPS, 2 * ULPS + 1, dtype)
    below = _floats_from(sb - ULPS, ULPS, dtype)
    s = f(side)
    special = np.array([0.0, -0.0, s / 2, -s / 2], f)
    return np.concatenate([b - a, near, -near, below, -below, special])


def _bits(a):
    return a.view(torch.int32 if a.dtype == torch.float32 else torch.int64)


def _jax_image(d, side):
    jd = jnp.asarray(d)
    js = jnp.asarray(side, jd.dtype)
    out = np.array(jd - js * jnp.round(jd / js))
    assert out.dtype == d.dtype
    return torch.from_numpy(out)


def _threshold_image(d, side, t):
    """The kernels' image in plain torch: for |d| < side, d -
    copysign(side, d) from T on and d - copysign(0, d) below (the kernel
    adds +0 to positions, which gives the same -0 -> +0)."""
    s = torch.full((), side, dtype=d.dtype)
    shift = torch.where(d.abs() >= t, s, torch.zeros((), dtype=d.dtype))
    return d - torch.copysign(shift, d)


@pytest.mark.parametrize("side", SIDES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_threshold_image_is_jax_image(dtype, side):
    d = _differences(side, dtype)
    assert (np.abs(d) < NP[dtype][0](side)).all()
    t = dk.min_image_threshold(side, dtype)
    ref = _jax_image(d, side)
    dt = torch.from_numpy(d)
    got = _threshold_image(dt, side, t)
    assert torch.equal(_bits(got), _bits(ref))
    port = dk._min_image(dt, torch.zeros((), dtype=dtype),
                         torch.full((), side, dtype=dtype))
    assert torch.equal(_bits(port), _bits(ref))
    # T itself takes the shift, its lower neighbour does not; side/2 does
    # not (fl(0.5) rounds half to even, to 0).
    f = NP[dtype][0]
    tt = torch.tensor([t, np.nextafter(f(t), f(0)), f(side) / 2],
                      dtype=dtype)
    assert torch.equal(_jax_image(tt.numpy(), side) != tt,
                       torch.tensor([True, False, False]))


@pytest.mark.parametrize("side", SIDES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_collision_window_keeps_every_hit(dtype, side):
    """Every difference whose x image alone has fl(dx²) < eps2, which any
    hit needs, passes the window |fl(|d| - c)| > h; the window admits few
    others (none of the seeded draw)."""
    d = torch.from_numpy(_differences(side, dtype))
    eps2 = dk.eps2_of(dtype)
    image = _jax_image(d.numpy(), side)
    needed = image * image < eps2
    c, h = dk.collision_window(side, dtype)
    window = (d.abs() - c).abs() > h
    assert bool((window | ~needed).all())
    assert not bool((window & ~needed)[:100_000].any())
    f = NP[dtype][0]
    # EPSILON's own float neighbourhood, inside the box and across the
    # periodic edge: the window passes every one that needs the test.
    e = f(0.005)
    near = torch.from_numpy(np.array(
        [np.nextafter(e, f(k)) for k in (0, 1)] + [e]
        + [f(f(side) - v) for v in (e, np.nextafter(e, f(0)),
                                    np.nextafter(e, f(1)))], f))
    im = _jax_image(near.numpy(), side)
    assert bool(((near.abs() - c).abs() > h)[im * im < eps2].all())


def test_threshold_values():
    """T is not side/2, and is cached per (side, dtype)."""
    assert dk.min_image_threshold(1000.0, torch.float32) == float(
        np.float32(500.00003))
    assert dk.min_image_threshold(1000.0, torch.float64) == float(
        np.nextafter(500.0, 1000.0))
    assert dk.min_image_threshold(1.0, torch.float32) == float(
        np.nextafter(np.float32(0.5), np.float32(1)))
    dk._threshold.cache_clear()
    dk.min_image_threshold(1000.0, torch.float32)
    dk.min_image_threshold(1000.0, torch.float32)
    assert dk._threshold.cache_info().hits >= 1


@pytest.mark.parametrize("side,dtype,error", [
    (1000.0, torch.int32, TypeError),
    (1000.0, torch.float16, TypeError),
    (0.0, torch.float32, ValueError),
    (-8.0, torch.float64, ValueError),
    (float("nan"), torch.float32, ValueError),
    (float("inf"), torch.float64, ValueError),
    (1e-50, torch.float32, ValueError),
    (1e40, torch.float32, ValueError),
])
def test_threshold_rejects_bad_input(side, dtype, error):
    with pytest.raises(error):
        dk.min_image_threshold(side, dtype)
    with pytest.raises(error):
        dk.collision_window(side, dtype)


def test_source_constants_and_sweep_variants(tmp_path, monkeypatch):
    """The constants chip_smoke and the sweep read from the source, and a
    sweep variant that changes exactly the constants it names; a name
    the source lacks is refused."""
    c = dk.source_constants()
    for name in ("kThreads", "kTile", "kForceSplit", "kForceRecv",
                 "kCollideSplit", "kCollideRecv"):
        assert c[name] > 0
    assert c["kTile"] % c["kForceSplit"] == 0
    assert (c["kThreads"] // c["kForceSplit"]) % 32 == 0
    monkeypatch.setattr(direct_sweep.cell_pairs, "BUILD_DIR", str(tmp_path))
    path = direct_sweep.variant_source(
        {"kForceRecv": 8, "kCollideRecv": 8, "kForceSplit": 2,
         "kCollideSplit": 2})
    v = dk.source_constants(path)
    assert (v["kForceRecv"], v["kCollideRecv"], v["kForceSplit"],
            v["kCollideSplit"]) == (8, 8, 2, 2)
    assert {k: v[k] for k in c if "Recv" not in k and "Split" not in k} == {
        k: c[k] for k in c if "Recv" not in k and "Split" not in k}
    with pytest.raises(ValueError, match="kNoSuch"):
        direct_sweep.variant_source({"kNoSuch": 1})


def test_force_chain_length():
    """chip_smoke's tolerance takes the longest chain of terms one thread
    sums: its part's slice of every tile, the last tile cut by N."""
    tile, split = chip_smoke._direct_consts()
    width = tile // split
    for n in (1, 2, width, tile, tile + 1, 8191, 100_000):
        slices = [sum(max(0, min(width, n - j0 - p * width))
                      for j0 in range(0, n, tile)) for p in range(split)]
        assert chip_smoke._direct_chain(n) == max(slices)


SASS = """
        Function : _ZN12_GLOBAL__N_120direct_forces_kernelIfEEvPKT_S3_
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDS.128 R4, [R2] ;
        /*0020*/                   FADD R8, R4, -R9 ;
        /*0030*/                   MUFU.RSQ R10, R11 ;
        /*0040*/               @P0 BRA P1, 0x70 ;
        /*0050*/                   MUFU.RSQ R14, R15 ;
        /*0060*/                   FMUL R14, R14, 4096 ;
        /*0070*/                   BSYNC B2 ;
        /*0080*/                   FFMA R3, R10, R8, R3 ;
        /*0090*/              @!P1 BRA 0x10 ;
        /*00a0*/                   EXIT ;
        Function : _ZN12_GLOBAL__N_124direct_collisions_kernelIdEEvPKT_S3_
        /*0000*/                   BRA 0x0 ;
"""


def test_sass_loops_counts_the_common_path():
    """The hot loop's instructions a pair: the rare block the loop branches
    over (0x50-0x60) is not on the common path."""
    funcs = direct_sweep.sass_functions(SASS)
    assert set(funcs) == {"direct_forces_kernel<float>",
                          "direct_collisions_kernel<double>"}
    (loop,) = direct_sweep.sass_loops(
        funcs["direct_forces_kernel<float>"],
        direct_sweep.MARKERS["direct_forces_kernel"])
    assert (loop["from"], loop["to"], loop["insns"], loop["path"],
            loop["pairs"], loop["per_pair"]) == ("0x10", "0x90", 9, 7, 1,
                                                 7.0)
