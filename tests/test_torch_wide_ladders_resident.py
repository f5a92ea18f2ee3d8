"""The engines on tiles wider than 1024 slots under
``dense_backend="pallas"``, against the JAX package: 4 cells of ~1250 particles (resident -> dense -> sweep under "pallas") and the super-cell rows (supercell at K = 1440 under both backends).

Cases, checks and tolerances are ``tests/test_torch_wide_tiles.py``'s
(``ENGINES``, ``check_engine``): the same route, tile capacity and plans
after the run as JAX's, the same result. JAX's ladders run its Pallas
kernels in interpret mode here, minutes a case, so these cases live in
files of their own, which pytest-xdist's ``--dist loadfile`` hands to
other workers than the rest of the wide-tile tests.
"""

import pytest

from tests.test_torch_wide_tiles import ENGINES, check_engine

CASES = [c for c in ENGINES if c[0] in ('resident', 'supercell')]


@pytest.mark.parametrize("backend", ["pallas"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_engine_matches_jax_wide(case, backend):
    check_engine(case, backend)
