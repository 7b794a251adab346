// The grid kernels' grouped instances (rows 8-9 with kGrp, grouped moment
// matching; rollout_kernel.cuh, group_mm.cuh), for MLPs whose hidden
// activations are all relu or not: a translation unit of its own, which
// nvcc compiles beside fused_rollout.cu's (build.py links them into
// libfused_rollout.so), whose launch() takes them through this function.

#include "rollout_kernel.cuh"

// kind: 3 row 8 (forward), 4 row 9 (backward)
extern "C" const void* fused_rollout_grouped_grid(int kind, int relu) {
  using K = void (*)(Step, Roll, Lay, Crit);
  static const K kernels[2][2] = {
      {rollout_kernel<true, kFwd | kGrp, false, false>,
       rollout_kernel<true, kBwd | kGrp, false, false>},
      {rollout_kernel<true, kFwd | kGrp, true, false>,
       rollout_kernel<true, kBwd | kGrp, true, false>}};
  return kind == 3 || kind == 4 ? reinterpret_cast<const void*>(kernels[relu != 0][kind - 3])
                                : nullptr;
}
