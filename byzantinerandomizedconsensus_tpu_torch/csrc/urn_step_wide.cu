// The urn step kernel (urn_step.cu) past its config-5 layout: packing law v2
// (1024 < n <= 4096, up to four receivers a thread) and Ben-Or's two-faced
// class rows at any n, in a module of their own, so that urn_step.cu's
// kernel compiles as it did alone (a module whose kernels share urn_counts
// orders the PRF word's ORs otherwise).
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_sum.cuh"
#include "urn_step.cuh"

namespace {

// The layout past urn_step_kernel's: R receivers v = tid + k·blockDim per
// thread, law PACK, and under TWO_FACED Ben-Or's two class rows, receiver v
// reading the totals and its own value of its class h = v >= (n+1)/2; as
// in urn_step_kernel, every thread reads its senders into the totals and
// only the receivers of the range recv_offset .. recv_offset + n_recv - 1
// draw and write their local rows.
template <int PACK, bool TWO_FACED>
__global__ void __launch_bounds__(1024)
urn_step_wide_kernel(const int32_t* __restrict__ inst_ids,
                     const uint8_t* __restrict__ values,
                     const uint8_t* __restrict__ silent,
                     const uint8_t* __restrict__ faulty,
                     int32_t* __restrict__ c0_out, int32_t* __restrict__ c1_out,
                     brc::StepParams p, int recv_offset, int n_recv) {
  constexpr int R = PACK == 1 ? 1 : 4;
  constexpr int K = TWO_FACED ? 6 : 3;
  const int b = blockIdx.x;
  const uint32_t tid = threadIdx.x, nt = blockDim.x;
  const size_t row = (size_t)b * p.n;
  const uint32_t inst = (uint32_t)inst_ids[b];
  uint32_t own0[R], own1[R];
  bool live[R];
  // The live totals of each value (of each class row), then the honest
  // votes of adaptive_min's observation.
  int c[K + 2];
#pragma unroll
  for (int i = 0; i < K + 2; ++i) c[i] = 0;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const uint32_t v = tid + (uint32_t)k * nt;
    own0[k] = own1[k] = 2u;
    live[k] = false;
    if ((int)v >= p.n) continue;
    const uint32_t hon = values[row + v];
    const bool bad = faulty[row + v] != 0;
    own0[k] = own1[k] = hon;
    if constexpr (TWO_FACED) {
      if (bad) {
        // ops/urn.py::byz_class_values: class h sees prf_sender(tag h) % 3.
        own0[k] = brc::prf_sender<PACK>(p.k0, p.k1, inst, p.rnd, p.step, 0u, v,
                                        brc::kByzValue) % 3u;
        own1[k] = brc::prf_sender<PACK>(p.k0, p.k1, inst, p.rnd, p.step, 1u, v,
                                        brc::kByzValue) % 3u;
      }
    }
    live[k] = !silent[row + v];
#pragma unroll
    for (uint32_t w = 0; w < 3; ++w) {
      c[w] += live[k] && own0[k] == w ? 1 : 0;
      if constexpr (TWO_FACED) c[3 + w] += live[k] && own1[k] == w ? 1 : 0;
    }
    if (p.adversary == brc::kAdvAdaptiveMin && !bad) {
      c[K] += hon == 0u ? 1 : 0;
      c[K + 1] += hon == 1u ? 1 : 0;
    }
  }
  brc::block_sum(c);
  const uint32_t minority = brc::minority_of(c[K], c[K + 1]);
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const uint32_t v = tid + (uint32_t)k * nt;
    const int r = (int)v - recv_offset;  // the local row of global receiver v
    if ((int)v >= p.n || r < 0 || r >= n_recv) continue;
    uint32_t own = own0[k];
    int M0 = c[0], M1 = c[1], M2 = c[2];
    if constexpr (TWO_FACED) {
      if (v >= (uint32_t)(p.n + 1) / 2) {
        own = own1[k];
        M0 = c[3];
        M1 = c[4];
        M2 = c[5];
      }
    }
    int c0, c1;
    brc::urn_counts<PACK>(p, inst, v, own, live[k], M0, M1, M2, minority, &c0, &c1);
    const size_t out = (size_t)b * n_recv + r;
    c0_out[out] = c0;
    c1_out[out] = c1;
  }
}

template <int PACK, bool TWO_FACED>
int launch_wide(const int32_t* inst_ids, const uint8_t* values, const uint8_t* silent,
                const uint8_t* faulty, int32_t* c0, int32_t* c1, int B,
                const brc::StepParams& p, int recv_offset, int n_recv,
                cudaStream_t stream) {
  constexpr int R = PACK == 1 ? 1 : 4;
  const int threads = ((p.n + R - 1) / R + 31) / 32 * 32;
  urn_step_wide_kernel<PACK, TWO_FACED><<<B, threads, 0, stream>>>(
      inst_ids, values, silent, faulty, c0, c1, p, recv_offset, n_recv);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch one step for B instances on `stream`, as brc_urn_step_shard_launch
// does, for n <= 4096 with the adversary code kAdvTwoFaced (Ben-Or's
// Byzantine pairing) or n > 1024. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int brc_urn_step_wide_shard_launch(const int32_t* inst_ids,
                                              const uint8_t* values,
                                              const uint8_t* silent,
                                              const uint8_t* faulty, int32_t* c0,
                                              int32_t* c1, int B, int n, int f, int rnd,
                                              int step, int adversary, uint32_t k0,
                                              uint32_t k1, int recv_offset, int n_recv,
                                              void* stream) {
  if (B <= 0) return 0;
  if (n < 1 || n > 4096 || f < 0 || f >= n) return (int)cudaErrorInvalidValue;
  if (recv_offset < 0 || n_recv < 1 || recv_offset + n_recv > n)
    return (int)cudaErrorInvalidValue;
  if (adversary < brc::kAdvNone || adversary > brc::kAdvTwoFaced)
    return (int)cudaErrorInvalidValue;
  const bool two_faced = adversary == brc::kAdvTwoFaced;
  if (n <= 1024 && !two_faced) return (int)cudaErrorInvalidValue;
  const brc::StepParams p{k0, k1, n, f, (uint32_t)rnd, (uint32_t)step,
                          two_faced ? brc::kAdvNone : adversary};
  const cudaStream_t s = (cudaStream_t)stream;
  const int o = recv_offset, r = n_recv;
  if (n <= 1024)
    return launch_wide<1, true>(inst_ids, values, silent, faulty, c0, c1, B, p, o, r, s);
  return two_faced
             ? launch_wide<2, true>(inst_ids, values, silent, faulty, c0, c1, B, p, o, r, s)
             : launch_wide<2, false>(inst_ids, values, silent, faulty, c0, c1, B, p, o, r, s);
}
