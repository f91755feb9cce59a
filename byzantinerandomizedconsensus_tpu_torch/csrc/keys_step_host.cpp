// Host build of the keys step kernel's per-lane arithmetic, for the CPU tests:
// g++ compiles keys_step.cuh behind this extern "C" shim
// (ops/_build.py::load_host), and tests/test_torch_kernel_host.py holds it
// against the port's plain torch version and the reference.
//
// brc_host_keys_step runs the kernel's work for one receiver row at a time
// (brc_select_row for the selection). It calls the same functions between
// the reductions as keys_step.cu does, in the same order.
#include <stddef.h>
#include <stdint.h>

#include <vector>

#include "keys_step.cuh"

extern "C" {

uint32_t brc_combined_key(uint32_t k0, uint32_t k1, int n, int rnd, int step,
                          int adversary, uint32_t inst, uint32_t recv,
                          uint32_t send, uint32_t value, int silent,
                          uint32_t minority) {
  const brc::StepParams p{k0, k1, n, 0, (uint32_t)rnd, (uint32_t)step, adversary};
  return brc::combined_key(p, inst, recv, send, value, silent != 0, minority);
}

// The kernel's selection on one row of n top fields, with the warp
// reductions and ballots written as loops over the senders in sender order:
// sel[s] = 1 for the k smallest keys (top, sender).
void brc_select_row(const uint32_t* top, int n, int k, uint8_t* sel) {
  uint32_t T = 0u;
  for (int bit = brc::kTopBits - 1; bit >= 0; --bit) {
    const uint32_t cand = brc::search_cand(T, bit);
    int cnt = 0;
    for (int s = 0; s < n; ++s) cnt += top[s] <= cand ? 1 : 0;
    T = brc::search_step(T, bit, cnt, k);
  }
  int below = 0;
  for (int s = 0; s < n; ++s) below += top[s] < T ? 1 : 0;
  int ties = 0;
  for (int s = 0; s < n; ++s) {
    sel[s] = brc::selected(top[s], T, ties, k, below) ? 1 : 0;
    ties += top[s] == T ? 1 : 0;
  }
}

void brc_host_keys_step(const int32_t* inst_ids, const uint8_t* values,
                        const uint8_t* silent, const uint8_t* faulty,
                        int32_t* c0_out, int32_t* c1_out, int B, int n, int f,
                        int rnd, int step, int adversary, uint32_t k0,
                        uint32_t k1) {
  const brc::StepParams p{k0, k1, n, f, (uint32_t)rnd, (uint32_t)step, adversary};
  std::vector<uint32_t> top(n);
  std::vector<uint8_t> sel(n);
  for (int b = 0; b < B; ++b) {
    const uint8_t* val = values + (size_t)b * n;
    const uint8_t* sil = silent + (size_t)b * n;
    const uint8_t* fa = faulty + (size_t)b * n;
    const uint32_t inst = (uint32_t)inst_ids[b];
    int h0 = 0, h1 = 0;
    for (int s = 0; s < n; ++s) {
      if (!fa[s]) {
        h0 += val[s] == 0 ? 1 : 0;
        h1 += val[s] == 1 ? 1 : 0;
      }
    }
    const uint32_t minority = brc::minority_of(h0, h1);
    for (int recv = 0; recv < n; ++recv) {
      for (int s = 0; s < n; ++s)
        top[s] = brc::combined_key(p, inst, recv, s, val[s], sil[s] != 0,
                                   minority) >> brc::kKeyLow;
      brc_select_row(top.data(), n, n - f, sel.data());
      int c0 = 0, c1 = 0;
      for (int s = 0; s < n; ++s) {
        const bool deliv = brc::delivered(s == recv, sil[s] != 0, sel[s] != 0);
        c0 += deliv && val[s] == 0 ? 1 : 0;
        c1 += deliv && val[s] == 1 ? 1 : 0;
      }
      c0_out[(size_t)b * n + recv] = c0;
      c1_out[(size_t)b * n + recv] = c1;
    }
  }
}

}  // extern "C"
