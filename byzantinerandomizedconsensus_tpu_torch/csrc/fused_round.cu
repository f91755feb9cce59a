// The fused round kernel: the whole Bracha round loop of a chunk in one launch.
//
// Replaces the TPU kernel byzantinerandomizedconsensus_tpu/ops/pallas_round.py
// (run_chunk, pallas_call at :268, body _make_kernel.kernel at :146), on the
// surface of the benchmark's main path: protocol bracha, delivery urn2
// (spec §4b-v2), adversary none, faults none, n <= 1024 (packing law v1),
// every init law and both coins.
//
// Layout. One CTA per instance, one thread per replica (blockDim = n rounded
// up to a warp). Each thread keeps its replica's state word
// (prf.FUSED_STATE_BITS) in a register for the whole loop; the block-wide
// counts the protocol needs (live class totals of each step, the validation
// counts, the termination test) are __syncthreads_count reductions. Each
// thread runs its own urn2 chain of K = min(m, L-m, D) draws; the torch plain
// version runs all lanes to the batch maximum of K with lanes masked, which
// draws the same bits. Each CTA leaves its round loop as soon as its correct
// replicas have decided. No replica is faulty under adversary none, so the
// termination test all(decided | faulty) is all(decided) and replica 0 is the
// first correct replica, which reports the decision. Only rounds (int32) and
// decision (uint8) are written, one of each per instance.
//
// Bound. Integer issue: a threefry word costs about 72 integer operations and
// a chain draw about 9, against a few bytes per instance moved to or from
// device memory. wgmma, TMA and the tensor cores do not apply to this
// integer workload.
//
// Known and left for later: warp divergence in the chain. K runs from 0 to
// D = 170 at config4's balanced steps, and a warp waits for its longest lane.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_round.cuh"

namespace {

__global__ void __launch_bounds__(1024)
fused_round_kernel(const int32_t* __restrict__ inst_ids,
                   int32_t* __restrict__ rounds_out,
                   uint8_t* __restrict__ decision_out, brc::Params p) {
  const int b = blockIdx.x;
  const uint32_t v = threadIdx.x;
  const bool active = (int)v < p.n;
  const uint32_t inst = (uint32_t)inst_ids[b];

  uint32_t word = active ? brc::init_est(p, inst, v) : 0u;
  int done_at = -1;
  for (int r = 0; r < p.round_cap; ++r) {
    const uint32_t rnd = (uint32_t)r;
    // Step 0: est on the wire, nobody silent.
    const uint32_t est = brc::word_est(word);
    const int g00 = __syncthreads_count(active && est == 0u);
    const int g01 = __syncthreads_count(active && est == 1u);
    uint32_t x = 0u;
    if (active) x = brc::step0_vote(p, inst, rnd, v, est, g00, g01);

    // Step 1: invalid messages join the silent set before delivery.
    const bool live1 = brc::step1_valid(p, x, g00, g01);
    const int g10 = __syncthreads_count(active && live1 && x == 0u);
    const int g11 = __syncthreads_count(active && live1 && x == 1u);
    uint32_t z = 0u;
    if (active) z = brc::step1_vote(p, inst, rnd, v, x, live1, g10, g11);

    // Step 2, coin and decide.
    const bool live2 = brc::step2_valid(p, z, g10, g11);
    const int m20 = __syncthreads_count(active && live2 && z == 0u);
    const int m21 = __syncthreads_count(active && live2 && z == 1u);
    const int m22 = __syncthreads_count(active && live2 && z == 2u);
    if (active) word = brc::round_update(p, inst, rnd, v, word, z, live2, m20, m21, m22);

    const int undone = __syncthreads_count(active && !brc::word_decided(word));
    if (undone == 0) {
      done_at = r + 1;
      break;
    }
  }
  if (v == 0) {
    rounds_out[b] = done_at >= 0 ? done_at : p.round_cap;
    decision_out[b] = done_at >= 0 ? (uint8_t)brc::word_decided_val(word) : (uint8_t)2;
  }
}

}  // namespace

// Launch one chunk of B instances on `stream`. Pointers are device pointers:
// inst_ids (B,) int32, rounds (B,) int32, decision (B,) uint8. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int brc_fused_round_launch(const int32_t* inst_ids, int32_t* rounds,
                                      uint8_t* decision, int B, int n, int f,
                                      int round_cap, int init_code,
                                      int coin_code, uint32_t k0, uint32_t k1,
                                      void* stream) {
  if (B <= 0) return 0;
  if (n < 1 || n > 1024) return (int)cudaErrorInvalidValue;
  const brc::Params p{k0, k1, n, f, round_cap, init_code, coin_code};
  const int threads = (n + 31) / 32 * 32;
  fused_round_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
      inst_ids, rounds, decision, p);
  return (int)cudaGetLastError();
}
