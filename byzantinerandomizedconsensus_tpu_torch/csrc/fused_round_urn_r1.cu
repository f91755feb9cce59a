// One library of the wide fused round kernel (fused_round_wide.cuh): delivery
// urn (spec §4b), layout R = 1: one replica
// per thread, n <= 1024, packing law v1. Each (law, layout) is its own
// translation unit, so the libraries build in parallel, one nvcc each
// (ops/_build.py).
#include "fused_round_wide.cuh"

BRC_WIDE_ENTRY(brc::fused::kLawUrn, 1)
