// Host build of the urn step kernel's per-receiver arithmetic, for the CPU
// tests: g++ compiles urn_step.cuh behind this extern "C" shim
// (ops/_build.py::load_host), and tests/test_torch_kernel_host.py holds it
// against the port's plain torch version and the reference.
//
// brc_host_urn_step runs the kernel's work for one instance at a time with
// the block reductions written as loops over the replicas, and calls the
// same functions after them as urn_step.cu does: under packing law v2 (n >
// 1024) urn_counts<2>, under Ben-Or's two-faced pairing (kAdvTwoFaced) with
// each sender's two class values and each class's totals. It returns the
// random draws made, the count behind chip_smoke.py's bound;
// brc_host_urn_step_shard does so over a receiver range (the kernels'
// recv_offset and n_recv).
// brc_urn_scaled and brc_sub_if_below are the draw's scaled index and the
// pick.
#include <stddef.h>
#include <stdint.h>

#include <vector>

#include "urn_step.cuh"

extern "C" {

uint32_t brc_urn_scaled(uint32_t s, uint32_t R) { return brc::urn_scaled(s, R); }

uint32_t brc_urn_scaled_packed(int pack, uint32_t s, uint32_t R) {
  return pack == 1 ? brc::urn_scaled<1>(s, R) : brc::urn_scaled<2>(s, R);
}

uint32_t brc_sub_if_below(uint32_t x, uint32_t a, uint32_t step) {
  return brc::sub_if_below(x, a, step);
}

}  // extern "C"

namespace {

template <int PACK>
long long host_urn_step(const int32_t* inst_ids, const uint8_t* values, const uint8_t* silent,
                        const uint8_t* faulty, int32_t* c0_out, int32_t* c1_out, int B,
                        bool two_faced, const brc::StepParams& p, int recv_offset,
                        int n_recv) {
  const int n = p.n;
  long long draws = 0;
  std::vector<uint32_t> own0(n), own1(n);
  for (int b = 0; b < B; ++b) {
    const size_t row = (size_t)b * n;
    const uint32_t inst = (uint32_t)inst_ids[b];
    int M[6] = {0, 0, 0, 0, 0, 0}, h0 = 0, h1 = 0;
    for (int v = 0; v < n; ++v) {
      own0[v] = own1[v] = values[row + v];
      if (two_faced && faulty[row + v]) {
        own0[v] = brc::prf_sender<PACK>(p.k0, p.k1, inst, p.rnd, p.step, 0u, (uint32_t)v,
                                        brc::kByzValue) % 3u;
        own1[v] = brc::prf_sender<PACK>(p.k0, p.k1, inst, p.rnd, p.step, 1u, (uint32_t)v,
                                        brc::kByzValue) % 3u;
      }
      if (!silent[row + v]) {
        ++M[own0[v]];
        ++M[3 + own1[v]];
      }
      if (!faulty[row + v]) {
        h0 += values[row + v] == 0 ? 1 : 0;
        h1 += values[row + v] == 1 ? 1 : 0;
      }
    }
    const uint32_t minority = brc::minority_of(h0, h1);
    for (int v = recv_offset; v < recv_offset + n_recv; ++v) {
      const bool h = two_faced && v >= (n + 1) / 2;
      const int* m = h ? M + 3 : M;
      int c0, c1;
      draws += brc::urn_counts<PACK>(p, inst, (uint32_t)v, h ? own1[v] : own0[v],
                                     !silent[row + v], m[0], m[1], m[2], minority, &c0, &c1);
      c0_out[(size_t)b * n_recv + (v - recv_offset)] = c0;
      c1_out[(size_t)b * n_recv + (v - recv_offset)] = c1;
    }
  }
  return draws;
}

}  // namespace

extern "C" {

// One step for B instances over the receivers recv_offset .. recv_offset +
// n_recv - 1 (c0_out, c1_out (B, n_recv)), as urn_step.cu's kernels compute
// it. Returns the random draws made.
long long brc_host_urn_step_shard(const int32_t* inst_ids, const uint8_t* values,
                                  const uint8_t* silent, const uint8_t* faulty,
                                  int32_t* c0_out, int32_t* c1_out, int B, int n, int f,
                                  int rnd, int step, int adversary, uint32_t k0,
                                  uint32_t k1, int recv_offset, int n_recv) {
  const bool two_faced = adversary == brc::kAdvTwoFaced;
  const brc::StepParams p{k0, k1, n, f, (uint32_t)rnd, (uint32_t)step,
                          two_faced ? brc::kAdvNone : adversary};
  if (n > 1024)
    return host_urn_step<2>(inst_ids, values, silent, faulty, c0_out, c1_out, B, two_faced,
                            p, recv_offset, n_recv);
  return host_urn_step<1>(inst_ids, values, silent, faulty, c0_out, c1_out, B, two_faced, p,
                          recv_offset, n_recv);
}

// The same over every receiver (c0_out, c1_out (B, n)).
long long brc_host_urn_step(const int32_t* inst_ids, const uint8_t* values,
                            const uint8_t* silent, const uint8_t* faulty,
                            int32_t* c0_out, int32_t* c1_out, int B, int n,
                            int f, int rnd, int step, int adversary,
                            uint32_t k0, uint32_t k1) {
  return brc_host_urn_step_shard(inst_ids, values, silent, faulty, c0_out, c1_out, B, n, f,
                                 rnd, step, adversary, k0, k1, 0, n);
}

}  // extern "C"
