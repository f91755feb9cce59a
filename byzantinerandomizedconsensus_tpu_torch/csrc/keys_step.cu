// The keys step kernel: one broadcast step's delivered counts under the spec
// §4 keys law.
//
// Replaces the TPU kernel byzantinerandomizedconsensus_tpu/ops/pallas_tally.py
// (step_counts, pallas_call at :326, body _step_kernel at :135) on the surface
// bracha, adversary none / adaptive / adaptive_min, faults none, n <= 1024
// (packing law v1). For each (instance, receiver) it selects the n - f
// smallest of the receiver's n scheduling keys and counts the delivered 0s
// and 1s. Only the (B, n) counts are written.
//
// Bound. Integer issue: one threefry word (about 72 operations) for each
// (recv, send) pair of the row's crossing class (keys_step.cuh), which the
// data decides, against 3n bytes read and 8n bytes written per instance.
//
// Layout. One CTA of kWarps warps per kRows receiver rows of one instance.
// The CTA first copies the instance's wire values and silences to shared
// memory, reduces the honest votes to the minority (adaptive_min), and builds
// its class tables (keys_step.cuh::ClassTable) with the sender lists of the
// two live classes, (value << 10 | sender) in shared memory: once per CTA,
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
#include <cuda_runtime.h>
#include <stdint.h>

#include "keys_step.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 8;
constexpr int kMaxN = 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Dynamic shared memory of a CTA at n senders: per warp a histogram, the
// finish slots and a list of n entries (u32); the class lists, two tables
// of two classes of n entries (u16); the values and silences (u8).
size_t smem_bytes(int n) {
  return (size_t)kWarps * (brc::kBins + brc::kFinishSlots + n) * 4 +
         (size_t)4 * n * 2 + (size_t)2 * n;
}

__global__ void __launch_bounds__(kThreads)
keys_step_kernel(const int32_t* __restrict__ inst_ids,
                 const uint8_t* __restrict__ values,
                 const uint8_t* __restrict__ silent,
                 const uint8_t* __restrict__ faulty,
                 int32_t* __restrict__ c0_out, int32_t* __restrict__ c1_out,
                 brc::StepParams p, int groups) {
  extern __shared__ uint4 smem[];
  __shared__ brc::ClassTable s_tab[2];
  __shared__ int s_honest[2];
  const int n = p.n;
  uint32_t* s_hist = reinterpret_cast<uint32_t*>(smem);
  uint32_t* s_slots = s_hist + kWarps * brc::kBins;
  uint32_t* s_list = s_slots + kWarps * brc::kFinishSlots;
  uint16_t* s_class = reinterpret_cast<uint16_t*>(s_list + kWarps * n);
  uint8_t* s_val = reinterpret_cast<uint8_t*>(s_class + 4 * n);
  uint8_t* s_sil = s_val + n;

  const int b = blockIdx.x / groups;
  const int g = blockIdx.x - b * groups;
  const size_t row = (size_t)b * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;

  if (threadIdx.x < 2) {
    s_tab[threadIdx.x] = brc::ClassTable{{0, 0}, {0, 0}, {0, 0}};
    s_honest[threadIdx.x] = 0;
  }
  for (int i = threadIdx.x; i < kWarps * brc::kBins; i += kThreads) s_hist[i] = 0u;
  int h0 = 0, h1 = 0;
  for (int s = threadIdx.x; s < n; s += kThreads) {
    const uint8_t v = values[row + s];
    s_val[s] = v;
    s_sil[s] = silent[row + s];
    if (p.adversary == brc::kAdvAdaptiveMin && !faulty[row + s]) {
      h0 += v == 0 ? 1 : 0;
      h1 += v == 1 ? 1 : 0;
    }
  }
  __syncthreads();
  if (p.adversary == brc::kAdvAdaptiveMin) {
    h0 = __reduce_add_sync(kFull, h0);
    h1 = __reduce_add_sync(kFull, h1);
    if (lane == 0) {
      atomicAdd(&s_honest[0], h0);
      atomicAdd(&s_honest[1], h1);
    }
    __syncthreads();
  }
  const uint32_t minority = brc::minority_of(s_honest[0], s_honest[1]);

  // The class tables and the live classes' sender lists, in any order: the
  // selection orders by key, not by list position.
  for (int t = 0; t < brc::table_count(p); ++t) {
    const uint32_t pref = brc::table_pref(p, t, minority);
    for (int base = warp * 32; base < n; base += kThreads) {
      const int s = base + lane;
      const uint32_t v = s < n ? s_val[s] : 2u;
      const uint32_t cls = s < n ? brc::key_class(p, v, s_sil[s] != 0, pref) : 3u;
#pragma unroll
      for (uint32_t x = 0; x < 2; ++x) {
        const unsigned in = __ballot_sync(kFull, cls == x);
        const unsigned z = __ballot_sync(kFull, cls == x && v == 0u);
        const unsigned o = __ballot_sync(kFull, cls == x && v == 1u);
        int at = 0;
        if (lane == 0 && in) {
          at = atomicAdd(&s_tab[t].m[x], __popc(in));
          atomicAdd(&s_tab[t].v0[x], __popc(z));
          atomicAdd(&s_tab[t].v1[x], __popc(o));
        }
        at = __shfl_sync(kFull, at, 0);
        if (cls == x)
          s_class[(t * 2 + x) * n + at + __popc(in & lower)] = (uint16_t)(v << 10 | s);
      }
    }
  }
  __syncthreads();

  uint32_t* hist = s_hist + warp * brc::kBins;
  uint32_t* slots = s_slots + warp * brc::kFinishSlots;
  uint32_t* list = s_list + warp * n;
  const uint32_t inst = (uint32_t)inst_ids[b];
  const int k = n - p.f;
  const int r_end = min(n, (g + 1) * kRows);
  for (int r = g * kRows + warp; r < r_end; r += kWarps) {
    const uint32_t recv = (uint32_t)r;
    const int t = brc::table_of(p, recv);
    const brc::ClassTable tab = s_tab[t];
    const uint32_t own = s_val[recv];
    const brc::RowPlan plan = brc::row_plan(
        tab, own, brc::key_class(p, own, s_sil[recv] != 0, brc::table_pref(p, t, minority)), k);
    int c0 = plan.c0, c1 = plan.c1;
    if (plan.kp > 0) {
      // 2. Hash the crossing class into the warp's list and histogram.
      const uint16_t* members = s_class + (t * 2 + plan.cross) * n;
      const int len = tab.m[plan.cross];
      int m = 0;
      for (int base = 0; base < len; base += 32) {
        const int i = base + lane;
        const uint32_t e = i < len ? members[i] : 0u;
        const uint32_t send = e & 0x3FFu;
        const bool keep = i < len && send != recv;
        const unsigned bal = __ballot_sync(kFull, keep);
        if (keep) {
          const uint32_t w = brc::list_entry(
              e >> 10, brc::prf_u32(p.k0, p.k1, inst, p.rnd, p.step, recv, send, brc::kSched),
              send);
          list[m + __popc(bal & lower)] = w;
          atomicAdd(&hist[brc::entry_bin(w)], brc::bin_word(w));
        }
        m += __popc(bal);
      }
      if (plan.cross == 0) {
        if (lane == 0) {
          const uint32_t w = brc::own_entry(recv);
          list[m] = w;
          atomicAdd(&hist[brc::entry_bin(w)], brc::bin_word(w));
        }
        m += 1;
      }
      __syncwarp();

      // 3. The crossing bin: a warp scan of the packed bin words.
      uint32_t w[brc::kBinsPerLane];
      uint4* mine = reinterpret_cast<uint4*>(hist + lane * brc::kBinsPerLane);
#pragma unroll
      for (int q = 0; q < brc::kBinsPerLane / 4; ++q) {
        const uint4 x = mine[q];
        w[4 * q] = x.x;
        w[4 * q + 1] = x.y;
        w[4 * q + 2] = x.z;
        w[4 * q + 3] = x.w;
        mine[q] = make_uint4(0u, 0u, 0u, 0u);  // clear for the next row
      }
      uint32_t incl = 0u;
#pragma unroll
      for (int j = 0; j < brc::kBinsPerLane; ++j) incl += w[j];
      const uint32_t local = incl;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t up = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += up;
      }
      uint32_t below = 0u, word = 0u;
      const int j = brc::crossing_bin(w, incl - local, plan.kp, &below, &word);
      const int owner = __ffs(__ballot_sync(kFull, j < brc::kBinsPerLane)) - 1;
      const uint32_t bstar = __shfl_sync(kFull, (uint32_t)(lane * brc::kBinsPerLane + j), owner);
      below = __shfl_sync(kFull, below, owner);
      word = __shfl_sync(kFull, word, owner);
      c0 += brc::bin_v0(below);
      c1 += brc::bin_v1(below);
      const int kpp = plan.kp - brc::bin_count(below);
      const int cbin = brc::bin_count(word);

      // 4. The exact finish inside the crossing bin.
      if (cbin <= brc::kFinishSlots) {
        int slot = 0;
        for (int base = 0; base < m; base += 32) {
          const int i = base + lane;
          const uint32_t e = i < m ? list[i] : 0u;
          const bool cand = i < m && brc::entry_bin(e) == bstar;
          const unsigned bal = __ballot_sync(kFull, cand);
          if (cand) slots[slot + __popc(bal & lower)] = e;
          slot += __popc(bal);
        }
        __syncwarp();
        const uint32_t e = lane < cbin ? slots[lane] : 0u;
        int rank = 0;
        for (int q = 0; q < cbin; ++q)
          rank += brc::entry_key(__shfl_sync(kFull, e, q)) < brc::entry_key(e) ? 1 : 0;
        const bool sel = lane < cbin && rank < kpp;
        c0 += __popc(__ballot_sync(kFull, sel && brc::entry_value(e) == 0u));
        c1 += __popc(__ballot_sync(kFull, sel && brc::entry_value(e) == 1u));
      } else {
        uint32_t T = brc::search_start(bstar);
        for (int bit = brc::kBinLow - 1; bit >= 0; --bit) {
          const uint32_t cand = brc::search_cand(T, bit);
          int cnt = 0;
          for (int i = lane; i < m; i += 32)
            cnt += brc::entry_bin(list[i]) == bstar && brc::entry_key(list[i]) <= cand ? 1 : 0;
          T = brc::search_step(T, bit, __reduce_add_sync(kFull, cnt), kpp);
        }
        int s0 = 0, s1 = 0;
        for (int i = lane; i < m; i += 32) {
          const uint32_t e = list[i];
          const bool sel = brc::entry_bin(e) == bstar && brc::entry_key(e) <= T;
          s0 += sel && brc::entry_value(e) == 0u ? 1 : 0;
          s1 += sel && brc::entry_value(e) == 1u ? 1 : 0;
        }
        c0 += __reduce_add_sync(kFull, s0);
        c1 += __reduce_add_sync(kFull, s1);
      }
      __syncwarp();  // the list and the slots are rewritten by the next row
    }
    if (lane == 0) {
      c0_out[row + recv] = c0;
      c1_out[row + recv] = c1;
    }
  }
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
  const size_t smem = smem_bytes(n);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        keys_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int groups = (n + kRows - 1) / kRows;
  keys_step_kernel<<<B * groups, kThreads, smem, (cudaStream_t)stream>>>(
      inst_ids, values, silent, faulty, c0, c1, p, groups);
  return (int)cudaGetLastError();
}
