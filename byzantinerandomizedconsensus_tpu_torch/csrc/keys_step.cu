// The keys step kernel: one broadcast step's delivered counts under the spec
// §4 keys law.
//
// Replaces the TPU kernel byzantinerandomizedconsensus_tpu/ops/pallas_tally.py
// (step_counts, pallas_call at :326, body _step_kernel at :135) on the surface
// benor and bracha, every static adversary, faults none, n <= 4096 (packing
// laws v1 and v2). For each (instance, receiver) it selects the n - f
// smallest of the receiver's n scheduling keys and counts the delivered 0s
// and 1s. Only the (B, n_recv) counts are written. Crash silences and Bracha's
// Byzantine pairing reach the kernel through the silent and values planes;
// the adaptive family's bias and Ben-Or's per-receiver equivocation are
// recomputed here, as in the reference.
//
// Bound. Integer issue: one threefry word (about 72 operations) for each
// (recv, send) pair of the row's crossing class (keys_step.cuh), which the
// data decides, and under Ben-Or's Byzantine pairing one more for each
// (recv, delivered faulty sender) pair, against 3n bytes read and 8n bytes
// written per instance.
//
// Layout. One CTA of kWarps warps per kRows receiver rows of one instance.
// The CTA first copies the instance's wire values and silences to shared
// memory, reduces the honest votes to the minority (adaptive_min), and builds
// its class tables (keys_step.cuh::ClassTable) with the sender lists of the
// two live classes, (value << low | sender) in shared memory: once per CTA,
// not per row. Then each warp takes rows in turn:
//   1. row_plan gives the crossing class and kp from the counts alone; a row
//      whose live keys all fit writes its counts without hashing;
//   2. the 32 lanes walk the crossing class's list densely, skipping the own
//      sender, hash each member once, and write (value | prf | sender) to the
//      warp's list and its packed bin word to the warp's 256-bin histogram
//      (shared atomicAdd); under crossing class 0 the own entry joins;
//   3. each lane loads 8 bins, a warp scan of the packed words finds the bin
//      that crosses kp and the value counts of every key below it;
//   4. the few keys of that bin are compacted (ballot, popc) into 32 slots
//      and ranked by shuffles; a bin of more than 32 keys runs the MSB-first
//      search over its keys instead.
// The keys never leave shared memory; no lane holds more than one.
//
// Receiver range. The rows are the receivers recv_offset .. recv_offset +
// n_recv - 1, a replica shard of the sharded path (pallas_tally.py:148, used
// at :155); every sender stays in the class tables. A row's global index
// recv_offset + r is its own message, its PRF words' receiver field, its
// send != recv exclusion and its equivocation words; the local r indexes
// the outputs. recv_offset 0 and n_recv n are the unsharded step.
//
// Ben-Or's Byzantine pairing (EQUIV) changes only the counting: a faulty
// sender's table entry has the value code kEquivocates, which the class
// counts skip; its value is hashed per row where the row delivers it, in the
// crossing class's walk (one more word per faulty member) and, for the
// classes selected whole, in a walk over their faulty members; a faulty
// receiver's own value is one word too. Rows of honest senders hash nothing
// more.
//
// Packing law v2 (PACK = 2, 1024 < n <= 4096) widens the sender field to 12
// bits and the bin word to a u64 (keys_step.cuh::BinLaw); the warp's list
// of n entries makes the dynamic shared memory 189,440 bytes at n = 4096,
// inside the 227 KB a CTA may have. The kernel's template is
// keys_step_kernel.cuh; this library holds its config-5 instantiation (law
// v1, no equivocation) alone, keys_step_wide.cu the other three.
#include "keys_step_kernel.cuh"

// Launch one step for B instances on `stream`, over the receivers
// recv_offset .. recv_offset + n_recv - 1 (a replica shard; the sender axis is
// always all n). Pointers are device pointers: inst_ids (B,) int32; values,
// silent, faulty (B, n) uint8; c0, c1 (B, n_recv) int32. Packing law v1 (n <=
// 1024) and any adversary code of keys_step.cuh but kAdvTwoFaced, which
// keys_step_wide.cu runs. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int brc_keys_step_shard_launch(const int32_t* inst_ids,
                                          const uint8_t* values,
                                          const uint8_t* silent,
                                          const uint8_t* faulty, int32_t* c0,
                                          int32_t* c1, int B, int n, int f, int rnd,
                                          int step, int adversary, uint32_t k0,
                                          uint32_t k1, int recv_offset, int n_recv,
                                          void* stream) {
  if (B <= 0) return 0;
  if (n < 1 || n > 1024 || f < 0 || f >= n) return (int)cudaErrorInvalidValue;
  if (recv_offset < 0 || n_recv < 1 || recv_offset + n_recv > n)
    return (int)cudaErrorInvalidValue;
  if (adversary < brc::kAdvNone || adversary >= brc::kAdvTwoFaced)
    return (int)cudaErrorInvalidValue;
  const brc::StepParams p{k0, k1, n, f, (uint32_t)rnd, (uint32_t)step, adversary};
  return launch<1, false>(inst_ids, values, silent, faulty, c0, c1, B, p, recv_offset,
                          n_recv, (cudaStream_t)stream);
}
