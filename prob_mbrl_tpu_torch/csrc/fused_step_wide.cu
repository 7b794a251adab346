// The wide instance of the step kernels (rows 6-7): the device code of
// fused_step.cu compiled with WideLimits (D <= 16, U <= 8, a tip of up to 16
// rows, rollout_step.cuh) into a library of its own, libfused_step_wide.so,
// with the same C entry points. The gate (fused_rollout.py kernel_refuses)
// takes the narrow instance wherever it can and this one beyond it.

#define PMBRL_WIDE 1
#include "fused_step.cu"
