// Host build of the wide fused round kernel's loop under delivery urn2
// (packing law v2), urn3 and urn (v1, v2): see fused_round_wide_host.inc.
#include "fused_round_wide_host.inc"

#define BRC_RUN(LAW, PACK)                                                                 \
  if (law == fz::LAW && pack == PACK) {                                                    \
    host_wide_run<fz::LAW, PACK>(protocol, adversary, fault, p, inst_ids, pl, rounds,     \
                                 decision, state, B);                                      \
    return 0;                                                                              \
  }

BRC_HOST_WIDE_ENTRY(BRC_RUN(kLawUrn2, 2) BRC_RUN(kLawUrn3, 1) BRC_RUN(kLawUrn3, 2)
                        BRC_RUN(kLawUrn, 1) BRC_RUN(kLawUrn, 2))
