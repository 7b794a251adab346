// The wide instance's grouped rows 8-9 (fused_rollout_grouped_grid.cu
// compiled with WideLimits): a translation unit of libfused_rollout_wide.so.

#define PMBRL_WIDE 1
#define fused_rollout_grouped_grid fused_rollout_grouped_grid_wide
#include "fused_rollout_grouped_grid.cu"
