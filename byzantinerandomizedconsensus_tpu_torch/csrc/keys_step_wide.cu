// The keys step kernel (keys_step.cu) past its config-5 instantiation:
// Ben-Or's Byzantine equivocation under packing law v1, and law v2
// (1024 < n <= 4096) with and without it, in a module of their own
// (keys_step_kernel.cuh).
#include "keys_step_kernel.cuh"

// Launch one step for B instances on `stream`, as brc_keys_step_shard_launch
// does, for n <= 4096 with the adversary code kAdvTwoFaced (Ben-Or's
// Byzantine pairing) or n > 1024. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int brc_keys_step_wide_shard_launch(const int32_t* inst_ids,
                                               const uint8_t* values,
                                               const uint8_t* silent,
                                               const uint8_t* faulty, int32_t* c0,
                                               int32_t* c1, int B, int n, int f, int rnd,
                                               int step, int adversary, uint32_t k0,
                                               uint32_t k1, int recv_offset, int n_recv,
                                               void* stream) {
  if (B <= 0) return 0;
  if (n < 1 || n > kMaxN || f < 0 || f >= n) return (int)cudaErrorInvalidValue;
  if (recv_offset < 0 || n_recv < 1 || recv_offset + n_recv > n)
    return (int)cudaErrorInvalidValue;
  if (adversary < brc::kAdvNone || adversary > brc::kAdvTwoFaced)
    return (int)cudaErrorInvalidValue;
  const bool equiv = adversary == brc::kAdvTwoFaced;
  if (n <= 1024 && !equiv) return (int)cudaErrorInvalidValue;
  const brc::StepParams p{k0, k1, n, f, (uint32_t)rnd, (uint32_t)step,
                          equiv ? brc::kAdvNone : adversary};
  const cudaStream_t s = (cudaStream_t)stream;
  const int o = recv_offset, r = n_recv;
  if (n <= 1024) return launch<1, true>(inst_ids, values, silent, faulty, c0, c1, B, p, o, r, s);
  return equiv ? launch<2, true>(inst_ids, values, silent, faulty, c0, c1, B, p, o, r, s)
               : launch<2, false>(inst_ids, values, silent, faulty, c0, c1, B, p, o, r, s);
}
