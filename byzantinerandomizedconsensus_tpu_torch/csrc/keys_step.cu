// The keys step kernel: one broadcast step's delivered counts under the spec
// §4 keys law.
//
// Replaces the TPU kernel byzantinerandomizedconsensus_tpu/ops/pallas_tally.py
// (step_counts, pallas_call at :326, body _step_kernel at :135) on the surface
// bracha, adversary none / adaptive / adaptive_min, faults none, n <= 1024
// (packing law v1). For each (instance, receiver) it builds the receiver's n
// scheduling keys, selects the n - f smallest and counts the delivered 0s
// and 1s. Only the (B, n) counts are written; the (B, n, n) keys never leave
// registers.
//
// Layout. One warp per receiver row, kWarps rows per CTA. The CTA first
// copies the instance's wire values and silences (n bytes each) to shared
// memory. Lane l owns senders l, l+32, ..., so it holds NJ = n/32 rounded up
// to a power of two key tops in registers (16 at n=512): a template
// parameter, so the arrays are indexed at compile time. The threshold T is
// the 22-pass MSB-first search on the top field (key >> 10), each pass a
// per-lane count and a __reduce_add_sync. Ties at T go in sender order: a
// __ballot_sync per sender chunk, the __popc of the lower lanes plus the ties
// of the earlier chunks. c0/c1 are __popc of ballots over delivered & value.
// The adaptive bias is recomputed from the receiver class; adaptive_min's
// minority from the honest (non-faulty) wire values, per warp.
//
// Bound. Integer issue: one threefry word (about 72 operations) per (recv,
// send) pair and 22 compare-and-count passes, against 3n bytes read and 8n
// bytes written per instance.
#include <cuda_runtime.h>
#include <stdint.h>

#include "keys_step.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxN = 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;

template <int NJ>
__global__ void __launch_bounds__(kThreads)
keys_step_kernel(const int32_t* __restrict__ inst_ids,
                 const uint8_t* __restrict__ values,
                 const uint8_t* __restrict__ silent,
                 const uint8_t* __restrict__ faulty,
                 int32_t* __restrict__ c0_out, int32_t* __restrict__ c1_out,
                 brc::StepParams p, int groups) {
  __shared__ uint8_t s_val[kMaxN];
  __shared__ uint8_t s_sil[kMaxN];
  const int b = blockIdx.x / groups;
  const int g = blockIdx.x - b * groups;
  const size_t row = (size_t)b * p.n;
  for (int i = threadIdx.x; i < p.n; i += kThreads) {
    s_val[i] = values[row + i];
    s_sil[i] = silent[row + i];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const uint32_t recv = (uint32_t)(g * kWarps + (threadIdx.x >> 5));
  if ((int)recv >= p.n) return;  // whole warps; no block barrier follows
  const uint32_t inst = (uint32_t)inst_ids[b];

  uint32_t minority = 0u;
  if (p.adversary == brc::kAdvAdaptiveMin) {
    int h0 = 0, h1 = 0;
    for (int s = lane; s < p.n; s += 32) {
      if (!faulty[row + s]) {
        h0 += s_val[s] == 0 ? 1 : 0;
        h1 += s_val[s] == 1 ? 1 : 0;
      }
    }
    minority = brc::minority_of(__reduce_add_sync(kFull, h0),
                                __reduce_add_sync(kFull, h1));
  }

  uint32_t top[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const uint32_t s = (uint32_t)(lane + 32 * j);
    const bool in = (int)s < p.n;
    top[j] = brc::combined_key(p, inst, recv, s, in ? s_val[s] : 2u,
                               in && s_sil[s], minority) >> brc::kKeyLow;
  }

  const int k = p.n - p.f;
  uint32_t T = 0u;
  for (int bit = brc::kTopBits - 1; bit >= 0; --bit) {
    const uint32_t cand = brc::search_cand(T, bit);
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < NJ; ++j) cnt += top[j] <= cand ? 1 : 0;
    T = brc::search_step(T, bit, __reduce_add_sync(kFull, cnt), k);
  }
  int below = 0;
#pragma unroll
  for (int j = 0; j < NJ; ++j) below += top[j] < T ? 1 : 0;
  below = __reduce_add_sync(kFull, below);

  const unsigned lower = (1u << lane) - 1u;
  int ties = 0, c0 = 0, c1 = 0;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int s = lane + 32 * j;
    const unsigned tie = __ballot_sync(kFull, top[j] == T);
    const int rank = ties + __popc(tie & lower);
    ties += __popc(tie);
    uint32_t v = 2u;
    bool deliv = false;
    if (s < p.n) {
      v = s_val[s];
      deliv = brc::delivered((uint32_t)s == recv, s_sil[s] != 0,
                             brc::selected(top[j], T, rank, k, below));
    }
    c0 += __popc(__ballot_sync(kFull, deliv && v == 0u));
    c1 += __popc(__ballot_sync(kFull, deliv && v == 1u));
  }
  if (lane == 0) {
    c0_out[row + recv] = c0;
    c1_out[row + recv] = c1;
  }
}

template <int NJ>
void launch(const int32_t* inst_ids, const uint8_t* values,
            const uint8_t* silent, const uint8_t* faulty, int32_t* c0,
            int32_t* c1, int B, const brc::StepParams& p, cudaStream_t stream) {
  const int groups = (p.n + kWarps - 1) / kWarps;
  keys_step_kernel<NJ><<<B * groups, kThreads, 0, stream>>>(
      inst_ids, values, silent, faulty, c0, c1, p, groups);
}

}  // namespace

// Launch one step for B instances on `stream`. Pointers are device pointers:
// inst_ids (B,) int32; values, silent, faulty (B, n) uint8; c0, c1 (B, n)
// int32. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int brc_keys_step_launch(const int32_t* inst_ids,
                                    const uint8_t* values,
                                    const uint8_t* silent,
                                    const uint8_t* faulty, int32_t* c0,
                                    int32_t* c1, int B, int n, int f, int rnd,
                                    int step, int adversary, uint32_t k0,
                                    uint32_t k1, void* stream) {
  if (B <= 0) return 0;
  if (n < 1 || n > kMaxN || f < 0 || f >= n) return (int)cudaErrorInvalidValue;
  const brc::StepParams p{k0, k1, n, f, (uint32_t)rnd, (uint32_t)step, adversary};
  const cudaStream_t s = (cudaStream_t)stream;
  const int chunks = (n + 31) / 32;
  if (chunks <= 1) launch<1>(inst_ids, values, silent, faulty, c0, c1, B, p, s);
  else if (chunks <= 2) launch<2>(inst_ids, values, silent, faulty, c0, c1, B, p, s);
  else if (chunks <= 4) launch<4>(inst_ids, values, silent, faulty, c0, c1, B, p, s);
  else if (chunks <= 8) launch<8>(inst_ids, values, silent, faulty, c0, c1, B, p, s);
  else if (chunks <= 16) launch<16>(inst_ids, values, silent, faulty, c0, c1, B, p, s);
  else launch<32>(inst_ids, values, silent, faulty, c0, c1, B, p, s);
  return (int)cudaGetLastError();
}
