"""The port's comparison instruments (``utils/observables``,
``utils/debug``) against the JAX package's on the same states: observables
to float64 rounding (rtol 1e-12: sums in another order), the digest and the
step-diff search exactly."""

import os
import shutil

import numpy as np
import pytest
import torch

from particlesimulation_tpu.config import Precision as JPrecision
from particlesimulation_tpu.config import SimConfig as JSimConfig
from particlesimulation_tpu.engine import Engine as JEngine
from particlesimulation_tpu.utils import debug as jdebug
from particlesimulation_tpu.utils import observables as jobs
from particlesimulation_tpu_torch.config import Precision, SimConfig
from particlesimulation_tpu_torch.engine import Engine
from particlesimulation_tpu_torch.utils import debug, observables

CFG = (-10, 3.0, 3, 100)


def _pair(steps=4):
    jeng = JEngine(JSimConfig(*CFG, precision=JPrecision.PARITY))
    eng = Engine(SimConfig(*CFG, precision=Precision.PARITY), device="cpu")
    return (eng, eng.run(eng.init_state(), steps),
            jeng, jeng.run(jeng.init_state(), steps))


def test_observables_match_jax():
    _, st, _, jst = _pair()
    got, ref = observables.summary(st, CFG[1]), jobs.summary(jst, CFG[1])
    assert got.keys() == ref.keys()
    assert (got["alive"], got["collisions"]) == (ref["alive"],
                                                 ref["collisions"])
    for k in ("mass", "momentum", "kinetic_energy", "com"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-12, atol=1e-15)


def test_state_digest_matches_jax():
    _, st, _, jst = _pair()
    got, ref = debug.state_digest(st), jdebug.state_digest(jst)
    assert got.keys() == ref.keys()
    assert (got["alive"], got["collisions"]) == (ref["alive"],
                                                 ref["collisions"])
    for k in ("sx", "sy", "sm"):
        assert got[k] == pytest.approx(ref[k], rel=1e-12)


def test_first_divergence():
    """None between the port's and the JAX parity engines (bit for bit);
    the step and field where a perturbed start first differs."""
    eng, _, jeng, _ = _pair(0)
    start = eng.init_state()
    assert debug.first_divergence(eng, start, jeng, jeng.init_state(),
                                  3) is None
    bent = start._replace(vx=start.vx + torch.where(start.pid == 5, 1e-9,
                                                    0.0))
    step, field, diff = debug.first_divergence(eng, start, eng, bent, 3)
    assert (step, field) == (0, "x") and 0 < diff < 1e-9


def test_run_reference_binary(tmp_path):
    """Builds ``serial/parsim.cpp`` of a reference checkout (a stand-in that
    prints its arguments in the reference's two-line format) and reads its
    output."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    src = tmp_path / "ref" / "serial" / "parsim.cpp"
    src.parent.mkdir(parents=True)
    src.write_text('#include <cstdio>\n#include <cstdlib>\n'
                   'int main(int c, char** v) {\n'
                   '  printf("%.3f %.3f\\n%d\\n", atof(v[1]), atof(v[2]),'
                   ' atoi(v[3]));\n  return 0;\n}\n')
    out = debug.run_reference_binary(str(tmp_path / "ref"), [1.5, 2.25, 7],
                                     build_dir=str(tmp_path / "build"))
    assert out == (1.5, 2.25, 7)
    assert os.path.exists(tmp_path / "build" / "parsim")
