// The wide instance of the whole-rollout kernel (rows 3-5 and 8-9, grouped
// MM through fused_rollout_grouped_wide.cu and _grouped_grid_wide.cu, rows
// 3-5 with the value update's critic through fused_rollout_critic_*_wide.cu):
// the device code of fused_rollout.cu compiled with WideLimits (D <= 16,
// U <= 8, a tip of up to 16 rows, rollout_step.cuh) into a library of its
// own, libfused_rollout_wide.so, with the same C entry points. The gate
// (fused_rollout.py kernel_refuses) takes the narrow instance wherever it can
// and this one beyond it.

#define PMBRL_WIDE 1
#define fused_rollout_grouped fused_rollout_grouped_wide
#define fused_rollout_grouped_grid fused_rollout_grouped_grid_wide
#define fused_rollout_critic_fwd fused_rollout_critic_fwd_wide
#define fused_rollout_critic_bwd fused_rollout_critic_bwd_wide
#define fused_rollout_critic_vg fused_rollout_critic_vg_wide
#define fused_rollout_critic_grouped_fwd fused_rollout_critic_grouped_fwd_wide
#define fused_rollout_critic_grouped_bwd fused_rollout_critic_grouped_bwd_wide
#define fused_rollout_critic_grouped_vg fused_rollout_critic_grouped_vg_wide
#include "fused_rollout.cu"
