// The wide instance's row 4 with the value update's critic
// (fused_rollout_critic_bwd.cu compiled with WideLimits): a translation
// unit of libfused_rollout_wide.so.

#define PMBRL_WIDE 1
#define fused_rollout_critic_bwd fused_rollout_critic_bwd_wide
#include "fused_rollout_critic_bwd.cu"
