"""Deterministic xorshift32 random stream — the source of cross-variant parity.

The reference seeds every run from a 32-bit xorshift generator whose uniform
draw mixes the *signed* reinterpretation of the pre- and post-update state
(reference ``serial/parsim.cpp:18-48``):

    state' = xorshift32(state)                      # unsigned 32-bit
    u      = 0.5 + 0.2328306e-9 * (i32(state) + i32(state'))   # i32 sum WRAPS

Negative CLI seeds switch every draw to a Box-Muller normal(0.5, 0.15) with
rejection to [0, 1), which consumes a data-dependent number of uniforms
(reference serial/parsim.cpp:34-43). The stream is host-side NumPy; the
native C++ generator (``native``) is its fast path.
"""

from __future__ import annotations

import numpy as np

SEED_OFFSET = 987654321
_MIX = 0.2328306e-9


def derive_state(input_seed: int) -> int:
    """Initial generator state: abs(seed) + 987654321, as uint32.

    Reference serial/parsim.cpp:24.
    """
    return (abs(int(input_seed)) + SEED_OFFSET) & 0xFFFFFFFF


def _xorshift32(s: int) -> int:
    s ^= (s << 13) & 0xFFFFFFFF
    s ^= s >> 17
    s ^= (s << 5) & 0xFFFFFFFF
    return s & 0xFFFFFFFF


def _to_i32(u: int) -> int:
    return u - 0x100000000 if u >= 0x80000000 else u


def _draw(s: int) -> tuple[int, float]:
    """One uniform01 draw: (next state, value)."""
    s_in = _to_i32(s)
    s = _xorshift32(s)
    # int32 + int32 with wraparound, then converted to double
    total = _to_i32((s_in + _to_i32(s)) & 0xFFFFFFFF)
    return s, 0.5 + _MIX * float(total)


def uniform_stream_np(input_seed: int, n: int) -> np.ndarray:
    """First ``n`` uniform01 draws as float64."""
    s = derive_state(input_seed)
    out = np.empty(n, dtype=np.float64)
    for i in range(n):
        s, out[i] = _draw(s)
    return out


def normal_stream_np(input_seed: int, n: int) -> np.ndarray:
    """First ``n`` normal-mode draws (Box-Muller + rejection to [0,1)).

    Reference serial/parsim.cpp:34-43. Uses NumPy scalar log/cos, which on
    this platform resolve to the same libm as the reference binary.
    """
    s = derive_state(input_seed)
    out = np.empty(n, dtype=np.float64)
    two_pi = 2.0 * np.pi
    for i in range(n):
        while True:
            s, u1 = _draw(s)
            s, u2 = _draw(s)
            z = np.sqrt(-2.0 * np.log(u1)) * np.cos(two_pi * u2)
            r = 0.5 + 0.15 * z
            if 0.0 <= r < 1.0:
                out[i] = r
                break
    return out
