// One library of the wide fused round kernel (fused_round_wide.cuh): delivery
// urn (spec §4b), layout R = 4: up to four
// replicas per thread in registers, 1024 < n <= 4096, packing law v2. Each (law, layout) is its own
// translation unit, so the libraries build in parallel, one nvcc each
// (ops/_build.py).
#include "fused_round_wide.cuh"

BRC_WIDE_ENTRY(brc::fused::kLawUrn, 4)
