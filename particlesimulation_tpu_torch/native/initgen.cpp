// Native particle initializer for particlesimulation_tpu.
//
// Reproduces, bit for bit, the initial conditions of the reference simulator
// (reference serial/parsim.cpp:18-48 RandomGenerator, :220-232 init_particles):
// a sequential xorshift32 stream whose uniform draw mixes the signed-int32
// reinterpretation of the pre- and post-update state with a wrapping add, and
// a Box-Muller normal mode (negative seeds) whose rejection loop consumes a
// data-dependent number of uniforms.
//
// This must be native code: the Box-Muller path calls log()/cos(), and bit
// parity with the reference binary requires the *same libm* the reference is
// linked against. A JAX re-implementation would use XLA's transcendentals and
// diverge in the last ulp, which a chaotic N-body system amplifies past the
// golden-test tolerance within a few hundred steps.
//
// Exposed via a plain C ABI and loaded with ctypes (no pybind11 dependency).
//
// Build: g++ -O2 -shared -fPIC -o libpsim_init.so initgen.cpp
// (same optimization level as the reference Makefile; the x86-64 baseline has
// no FMA, so -O2 here and there produce identical IEEE operation sequences).

#include <cmath>
#include <cstdint>

namespace {

struct XorshiftStream {
  uint32_t state;
  bool use_normal;

  XorshiftStream(int32_t input_seed)
      : state(static_cast<uint32_t>(
            (input_seed < 0 ? -static_cast<int64_t>(input_seed)
                            : static_cast<int64_t>(input_seed)) +
            987654321)),
        use_normal(input_seed < 0) {}

  double uniform01() {
    int32_t before = static_cast<int32_t>(state);
    state ^= (state << 13);
    state ^= (state >> 17);
    state ^= (state << 5);
    // int32 + int32 wraps; the wrap is load-bearing for stream parity.
    int32_t mixed = static_cast<int32_t>(
        static_cast<uint32_t>(before) + static_cast<uint32_t>(state));
    return 0.5 + 0.2328306e-09 * mixed;
  }

  double normal01() {
    double u1, u2, z, result;
    do {
      u1 = uniform01();
      u2 = uniform01();
      z = std::sqrt(-2 * std::log(u1)) * std::cos(2 * M_PI * u2);
      result = 0.5 + 0.15 * z;
    } while (result < 0 || result >= 1);
    return result;
  }

  double next() { return use_normal ? normal01() : uniform01(); }
};

}  // namespace

extern "C" {

// Fill the first n uniform01 draws (ignores the normal-mode flag).
void psim_uniform_stream(int32_t seed, long long n, double* out) {
  XorshiftStream rng(seed);
  for (long long i = 0; i < n; ++i) out[i] = rng.uniform01();
}

// Fill the first n draws in the seed's native mode (uniform or normal).
void psim_draw_stream(int32_t seed, long long n, double* out) {
  XorshiftStream rng(seed);
  for (long long i = 0; i < n; ++i) out[i] = rng.next();
}

// Initialize n particles exactly as the reference does: per particle, five
// sequential draws in x, y, vx, vy, m order with the reference's scaling
// expressions (reference serial/parsim.cpp:220-232). Expression shapes and
// association order are preserved so every intermediate rounds identically.
void psim_init_particles(int32_t seed, double side_length, long ncside,
                         long long n, double* x, double* y, double* vx,
                         double* vy, double* m) {
  XorshiftStream rng(seed);
  const double grid2 = static_cast<double>(ncside) * static_cast<double>(ncside);
  (void)grid2;  // kept for readability; the loop uses the exact reference form
  for (long long i = 0; i < n; ++i) {
    x[i] = rng.next() * side_length;
    y[i] = rng.next() * side_length;
    vx[i] = (rng.next() - 0.5) * side_length / ncside / 5.0;
    vy[i] = (rng.next() - 0.5) * side_length / ncside / 5.0;
    m[i] = rng.next() * 0.01 * (ncside * ncside) /
           static_cast<double>(n) / 6.67408e-11 * (0.005 * 0.005);
  }
}

}  // extern "C"
