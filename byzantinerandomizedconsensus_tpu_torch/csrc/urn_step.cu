// The urn step kernel: one broadcast step's delivered counts under the spec
// §4b urn law.
//
// Replaces the TPU kernel byzantinerandomizedconsensus_tpu/ops/pallas_urn.py
// (step_counts, pallas_call at :291, body _urn_kernel at :60) on the surface
// bracha, adversary none / adaptive / adaptive_min, faults none, n <= 1024
// (packing law v1).
//
// Layout. One CTA per instance, one thread per receiver (blockDim = n rounded
// up to a warp), as in fused_round.cu. The live class totals, and under
// adaptive_min the honest vote counts that give the minority, are
// __syncthreads_count reductions. Each thread then runs its own drop draws
// (urn_step.cuh::urn_counts). Every receiver of an instance sees the same
// totals less its own message, so D is the same within a CTA up to one and a
// warp does not diverge on it. Only the (B, n) counts are written.
//
// Bound. Integer operations. A drop draw is the LCG multiply-add, the xor-shift,
// the draw's index scaled by 2^22 (a shift and one full-rate IMAD), and one
// compare with a predicated subtract against the tracked count, held scaled
// the same way (urn_step.cuh::urn_scaled, sub_if_below); a single-stratum
// draw adds a compare and a subtract. Under the adaptive family only the
// draws of the biased phase are made, min(D, B0) per receiver, and the tail
// is one subtraction. A receiver with D == 0 computes no threefry word. The
// loop runs over the urn size and is unrolled by 4, so the LCG steps, which
// do not depend on the picks, overlap the one loop-carried chain, compare
// then subtract. __launch_bounds__(1024, 2) holds a thread to 32 registers,
// so 64 warps reside on an SM at any n. The reference's affine LCG tables
// (pallas_urn.py:137-162), a TPU device to make each draw's state
// independent of the one before, are not carried over: here the LCG step is
// one IMAD off the pick chain.
#include <cuda_runtime.h>
#include <stdint.h>

#include "urn_step.cuh"

namespace {

__global__ void __launch_bounds__(1024, 2)
urn_step_kernel(const int32_t* __restrict__ inst_ids,
                const uint8_t* __restrict__ values,
                const uint8_t* __restrict__ silent,
                const uint8_t* __restrict__ faulty,
                int32_t* __restrict__ c0_out, int32_t* __restrict__ c1_out,
                brc::StepParams p) {
  const int b = blockIdx.x;
  const uint32_t v = threadIdx.x;
  const bool active = (int)v < p.n;
  const size_t at = (size_t)b * p.n + v;
  const uint32_t own = active ? values[at] : 2u;
  const bool live = active && !silent[at];
  const int M0 = __syncthreads_count(live && own == 0u);
  const int M1 = __syncthreads_count(live && own == 1u);
  const int M2 = __syncthreads_count(live && own == 2u);
  uint32_t minority = 0u;
  if (p.adversary == brc::kAdvAdaptiveMin) {
    const bool honest = active && !faulty[at];
    const int h0 = __syncthreads_count(honest && own == 0u);
    const int h1 = __syncthreads_count(honest && own == 1u);
    minority = brc::minority_of(h0, h1);
  }
  if (!active) return;
  int c0, c1;
  brc::urn_counts(p, (uint32_t)inst_ids[b], v, own, live, M0, M1, M2, minority,
                  &c0, &c1);
  c0_out[at] = c0;
  c1_out[at] = c1;
}

}  // namespace

// Launch one step for B instances on `stream`. Pointers are device pointers:
// inst_ids (B,) int32; values, silent, faulty (B, n) uint8; c0, c1 (B, n)
// int32. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int brc_urn_step_launch(const int32_t* inst_ids,
                                   const uint8_t* values, const uint8_t* silent,
                                   const uint8_t* faulty, int32_t* c0,
                                   int32_t* c1, int B, int n, int f, int rnd,
                                   int step, int adversary, uint32_t k0,
                                   uint32_t k1, void* stream) {
  if (B <= 0) return 0;
  if (n < 1 || n > 1024 || f < 0 || f >= n) return (int)cudaErrorInvalidValue;
  const brc::StepParams p{k0, k1, n, f, (uint32_t)rnd, (uint32_t)step, adversary};
  const int threads = (n + 31) / 32 * 32;
  urn_step_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
      inst_ids, values, silent, faulty, c0, c1, p);
  return (int)cudaGetLastError();
}
