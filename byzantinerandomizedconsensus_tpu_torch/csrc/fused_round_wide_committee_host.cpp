// Host build of the wide fused round kernel's loop under delivery committee
// (packing laws v1, v2 and v3): see fused_round_wide_host.inc.
#include "fused_round_wide_host.inc"

#define BRC_RUN(LAW, PACK)                                                                 \
  if (law == fz::LAW && pack == PACK) {                                                    \
    host_wide_run<fz::LAW, PACK>(protocol, adversary, fault, p, inst_ids, pl, rounds,     \
                                 decision, state, B);                                      \
    return 0;                                                                              \
  }

BRC_HOST_WIDE_ENTRY(BRC_RUN(kLawCommittee, 1) BRC_RUN(kLawCommittee, 2)
                        BRC_RUN(kLawCommittee, 3))
