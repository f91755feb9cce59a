// The PRF of spec/PROTOCOL.md §2, shared by every kernel of the port.
//
// Threefry-2x32 (20 rounds, first output word) and the packing law v1
// coordinate layout, in functions that compile for the device (nvcc) and for
// the host (g++), so the CPU tests can check them against ops/prf.py. All
// arithmetic is uint32 with wraparound.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define BRC_HD __host__ __device__ __forceinline__
#else
#define BRC_HD inline
#endif

namespace brc {

// PRF purposes (spec §2) and the §4b LCG.
constexpr uint32_t kInitEst = 0;
constexpr uint32_t kLocalCoin = 1;
constexpr uint32_t kSharedCoin = 2;
constexpr uint32_t kByzValue = 5;
constexpr uint32_t kSched = 6;
constexpr uint32_t kUrn = 7;
constexpr uint32_t kUrn2 = 8;
constexpr uint32_t kCoinStep = 3;
constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr uint32_t kLcgA = 0x915F77F5u;
constexpr uint32_t kLcgC = 0x6A09E667u;

BRC_HD uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

// Threefry-2x32, 20 rounds, first output word (ops/prf.py::threefry2x32).
BRC_HD uint32_t threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
#define BRC_MIX(r) x0 += x1; x1 = rotl32(x1, r) ^ x0;
  x0 += k0; x1 += k1;
  BRC_MIX(13) BRC_MIX(15) BRC_MIX(26) BRC_MIX(6)  x0 += k1; x1 += k2 + 1u;
  BRC_MIX(17) BRC_MIX(29) BRC_MIX(16) BRC_MIX(24) x0 += k2; x1 += k0 + 2u;
  BRC_MIX(13) BRC_MIX(15) BRC_MIX(26) BRC_MIX(6)  x0 += k0; x1 += k1 + 3u;
  BRC_MIX(17) BRC_MIX(29) BRC_MIX(16) BRC_MIX(24) x0 += k1; x1 += k2 + 4u;
  BRC_MIX(13) BRC_MIX(15) BRC_MIX(26) BRC_MIX(6)  x0 += k2; x1 += k0 + 5u;
#undef BRC_MIX
  return x0;
}

// One PRF word under packing law v1 (spec §2):
//   x0 = send<<17 | inst,  x1 = rnd<<16 | recv<<6 | step<<4 | purpose.
BRC_HD uint32_t prf_u32(uint32_t k0, uint32_t k1, uint32_t inst, uint32_t rnd,
                        uint32_t step, uint32_t recv, uint32_t send,
                        uint32_t purpose) {
  return threefry2x32(k0, k1, (send << 17) | inst,
                      (rnd << 16) | (recv << 6) | (step << 4) | purpose);
}

}  // namespace brc
