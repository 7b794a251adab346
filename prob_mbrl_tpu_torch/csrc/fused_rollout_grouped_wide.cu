// The wide instance's grouped rows 3-5 (fused_rollout_grouped.cu compiled
// with WideLimits): a translation unit of libfused_rollout_wide.so.

#define PMBRL_WIDE 1
#define fused_rollout_grouped fused_rollout_grouped_wide
#include "fused_rollout_grouped.cu"
