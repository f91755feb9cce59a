// One library of the wide fused round kernel (fused_round_wide.cuh): delivery
// committee, layout R = 0: the state words streamed from the scratch plane, n > 4096, packing law v3. Each (law, layout) is its own translation unit, so
// the libraries build in parallel, one nvcc each (ops/_build.py).
#include "fused_round_wide.cuh"

BRC_WIDE_ENTRY(brc::fused::kLawCommittee, 0)
