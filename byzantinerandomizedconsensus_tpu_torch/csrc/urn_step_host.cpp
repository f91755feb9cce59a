// Host build of the urn step kernel's per-receiver arithmetic, for the CPU
// tests: g++ compiles urn_step.cuh behind this extern "C" shim
// (ops/_build.py::load_host), and tests/test_torch_kernel_host.py holds it
// against the port's plain torch version and the reference.
//
// brc_host_urn_step runs the kernel's work for one instance at a time with
// the block reductions written as loops over the replicas, and calls the
// same functions after them as urn_step.cu does. It returns the random draws
// made, the count behind chip_smoke.py's bound. brc_urn_scaled and
// brc_sub_if_below are the draw's scaled index and the pick.
#include <stddef.h>
#include <stdint.h>

#include "urn_step.cuh"

extern "C" {

uint32_t brc_urn_scaled(uint32_t s, uint32_t R) { return brc::urn_scaled(s, R); }

uint32_t brc_sub_if_below(uint32_t x, uint32_t a, uint32_t step) {
  return brc::sub_if_below(x, a, step);
}

long long brc_host_urn_step(const int32_t* inst_ids, const uint8_t* values,
                            const uint8_t* silent, const uint8_t* faulty,
                            int32_t* c0_out, int32_t* c1_out, int B, int n,
                            int f, int rnd, int step, int adversary,
                            uint32_t k0, uint32_t k1) {
  const brc::StepParams p{k0, k1, n, f, (uint32_t)rnd, (uint32_t)step, adversary};
  long long draws = 0;
  for (int b = 0; b < B; ++b) {
    const size_t row = (size_t)b * n;
    int M[3] = {0, 0, 0}, h0 = 0, h1 = 0;
    for (int v = 0; v < n; ++v) {
      if (!silent[row + v]) ++M[values[row + v]];
      if (!faulty[row + v]) {
        h0 += values[row + v] == 0 ? 1 : 0;
        h1 += values[row + v] == 1 ? 1 : 0;
      }
    }
    const uint32_t minority = brc::minority_of(h0, h1);
    for (int v = 0; v < n; ++v) {
      int c0, c1;
      draws += brc::urn_counts(p, (uint32_t)inst_ids[b], v, values[row + v],
                               !silent[row + v], M[0], M[1], M[2], minority,
                               &c0, &c1);
      c0_out[row + v] = c0;
      c1_out[row + v] = c1;
    }
  }
  return draws;
}

}  // extern "C"
