// Philox-4x32-10 and the Omega entry draw, on the card.
//
// Replaces the in-kernel tile generator of the TPU kernels
// (src/repro/kernels/local.py `_om_block`, src/repro/kernels/sketch_matmul.py
// `_omega_tile_kernel`), which call src/repro/core/rng.py.  The bits are
// those of the plain version (src/repro_torch/core/rng.py):
//   * `__umulhi` and a 32-bit `*` give the (hi, lo) words that rng.py builds
//     from 16-bit limbs;
//   * counters: (gi, gj, salt, 0) is the uniform draw, (gi, gj, salt, sub+1)
//     for sub in 0..2 the three normal draws; gi/gj wrap as uint32;
//   * normal = Irwin-Hall: twelve 24-bit lanes summed in uint32 (exact),
//     minus 6*2^24, one round-to-nearest int->float (`__int2float_rn`),
//     times 2^-24 (exact).
// Build without --use_fast_math: it would flush denormals in the scale.
#pragma once

#include <cstdint>

namespace repro_torch {

enum OmegaKind : int { kNormal = 0, kUniform = 1, kRademacher = 2 };

struct PhiloxKey {
  uint32_t k0, k1;
};

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], PhiloxKey key) {
  uint32_t k0 = key.k0, k1 = key.k1;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]);
    const uint32_t lo0 = 0xD2511F53u * c[0];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]);
    const uint32_t lo1 = 0xCD9E8D57u * c[2];
    c[0] = hi1 ^ c[1] ^ k0;
    c[1] = lo1;
    c[2] = hi0 ^ c[3] ^ k1;
    c[3] = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
}

// Omega[gi, gj] (already offset to global coordinates), times `scale`.
__device__ __forceinline__ float omega_entry(PhiloxKey key, uint32_t gi,
                                             uint32_t gj, uint32_t salt,
                                             int kind, float scale) {
  if (kind == kNormal) {
    uint32_t total = 0;
#pragma unroll
    for (uint32_t sub = 1; sub <= 3; ++sub) {
      uint32_t c[4] = {gi, gj, salt, sub};
      philox4x32_10(c, key);
      total += (c[0] >> 8) + (c[1] >> 8) + (c[2] >> 8) + (c[3] >> 8);
    }
    const int d = static_cast<int>(total) - 6 * (1 << 24);
    return __int2float_rn(d) * (1.0f / 16777216.0f) * scale;
  }
  uint32_t c[4] = {gi, gj, salt, 0u};
  philox4x32_10(c, key);
  const float u = static_cast<float>(c[0] >> 8) * (1.0f / 16777216.0f);
  if (kind == kUniform) return u * scale;
  return (u < 0.5f ? -1.0f : 1.0f) * scale;
}

}  // namespace repro_torch
