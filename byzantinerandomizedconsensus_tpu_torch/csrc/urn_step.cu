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
// __syncthreads_count reductions. Each thread then runs its own D drop draws
// (urn_step.cuh::urn_counts): the sequential single-stratum loop without
// strata (the reference's affine LCG tables are a TPU device and not needed
// here), the two-stratum loop for the adaptive family. Only the (B, n)
// counts are written.
//
// Bound. Integer issue: one threefry word per receiver and about 12
// operations per drop draw, against 3n bytes read and 8n bytes written per
// instance. A warp waits for its longest D.
#include <cuda_runtime.h>
#include <stdint.h>

#include "urn_step.cuh"

namespace {

__global__ void __launch_bounds__(1024)
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
  brc::urn_counts(p, (uint32_t)inst_ids[b], v, own, live, M0, M1, M2,
                  brc::strata(p, v, minority), &c0, &c1);
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
