// The wide instance's grouped row 5 with the value update's critic
// (fused_rollout_critic_grouped_vg.cu compiled with WideLimits): a
// translation unit of libfused_rollout_wide.so.

#define PMBRL_WIDE 1
#define fused_rollout_critic_grouped_vg fused_rollout_critic_grouped_vg_wide
#include "fused_rollout_critic_grouped_vg.cu"
