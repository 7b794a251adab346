// The wide instance's row 3 with the value update's critic
// (fused_rollout_critic_fwd.cu compiled with WideLimits): a translation
// unit of libfused_rollout_wide.so.

#define PMBRL_WIDE 1
#define fused_rollout_critic_fwd fused_rollout_critic_fwd_wide
#include "fused_rollout_critic_fwd.cu"
