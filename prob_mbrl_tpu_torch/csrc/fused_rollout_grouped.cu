// The whole-rollout kernel's grouped instances of rows 3-5 without a critic
// (kGrp, grouped moment matching; rollout_kernel.cuh, group_mm.cuh), for
// MLPs whose hidden activations are all relu or not: a translation unit of
// its own, which nvcc compiles beside fused_rollout.cu's (build.py links
// them into libfused_rollout.so), whose launch() takes them through this
// function.

#include "rollout_kernel.cuh"

// kind: 0 row 3 (forward), 1 row 4 (backward), 2 row 5 (value and grad)
extern "C" const void* fused_rollout_grouped(int kind, int relu) {
  using K = void (*)(Step, Roll, Lay, Crit);
  static const K kernels[2][3] = {
      {rollout_kernel<false, kFwd | kGrp, false, false>,
       rollout_kernel<false, kBwd | kGrp, false, false>,
       rollout_kernel<false, kFwd | kBwd | kGrp, false, false>},
      {rollout_kernel<false, kFwd | kGrp, true, false>,
       rollout_kernel<false, kBwd | kGrp, true, false>,
       rollout_kernel<false, kFwd | kBwd | kGrp, true, false>}};
  return kind >= 0 && kind < 3 ? reinterpret_cast<const void*>(kernels[relu != 0][kind])
                               : nullptr;
}
