// Row 3's grouped instances with the value update's critic (RollArgs::critic
// and RollArgs::groups; rollout_kernel.cuh, critic_walk.cuh, group_mm.cuh):
// a translation unit of its own, which nvcc compiles beside
// fused_rollout.cu's (build.py links them into libfused_rollout.so), whose
// launch() takes them through this function.

#include "rollout_kernel.cuh"

extern "C" const void* fused_rollout_critic_grouped_fwd(int relu) {
  return critic_instance<kFwd | kGrp>(relu);
}
