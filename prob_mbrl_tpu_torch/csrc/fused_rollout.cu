// The whole MC-PILCO rollout (T steps, the discounted mean-return loss and the
// mean return) and its backward in one launch each, for Hopper (sm_90a), with
// a plain C interface that prob_mbrl_tpu_torch/ops/cuda/fused_rollout.py
// loads with ctypes.
//
// Replaces the Pallas TPU kernels of prob_mbrl_tpu/ops/pallas/fused_rollout.py
// whose body is make_loss_impl (:472-667; the TD(H) critic refit of
// :507-516, :615-660 through critic_walk.cuh; grouped moment matching,
// _mm_resample_grouped_kf at :553-561, through group_mm.cuh):
//   fused_rollout_fwd <- make_fused_loss._fwd_pallas (the call at :813)
//   fused_rollout_bwd <- make_fused_loss._bwd_pallas (the call at :859)
//   fused_rollout_vg  <- make_fused_value_and_grad.fused_vg (the call at :981)
// and the grid tier's two kernels (make_grid_rollout, :1368-1602, grouped or
// not):
//   fused_grid_fwd <- make_grid_rollout._fwd_pallas (the call at :1462)
//   fused_grid_bwd <- make_grid_rollout._bwd_pallas (the call at :1542)
// Per step t: the step of rollout_step.cuh on the states s_t (policy ->
// DiagGaussian sample -> squash + eps -> whitened input -> dynamics -> sample
// -> nxt, the reward of StepArgs::reward_kind, learned or not: :500, :568-575),
// then s_{t+1} = resample(nxt) (or nxt), r =
// resample(r) (or its particle mean with the reward mean-only shortcut,
// :583-591, or r itself); disc += w_t r, raw += r; loss = sign * mean(disc),
// mean_return = mean(raw). The grid kernels run the same sweeps with
// per-particle outputs: the forward also accumulates vret += vw_t r and
// writes disc, raw, vret [B] and the boundary states (states_all =
// s_all[1:]); the backward takes a cotangent per particle for each of disc,
// raw, vret, so the reward cotangent of row b at step t is c[b] = w_t
// g_disc[b] + g_raw[b] + vw_t g_vret[b] (:1534) where rows 3-5 have the
// uniform (sign g_loss w_t + g_mret) / B, and it adds g_sall[t], the
// cotangent of states_all[t], to the state cotangent before step t's MM
// backward (:1530-1531). No mean-only shortcut there.
//
// With the value update's critic (RollArgs::critic, rows 3-5; see
// critic_walk.cuh) the forward also accumulates vret and keeps s_H, the
// post-MM state after step H; after the forward sweep the refit (the TD(H)
// loss of V0 = V(params, s_0) against vret + w_H V(target, s_H), its
// gradient, Adam, polyak; rows 3 and 5 write params', target', the Adam
// state and v_loss) and the bootstrap disc += w_H V(params', s_T) run before
// the loss's sums, and the reverse sweep starts from the state cotangent
// sign g_loss w_H / B dV(s_T)/ds_T instead of 0. Row 4 takes params' (row
// 3's output) as the critic's params and seeds its reverse sweep the same
// way; it does not refit again (the port's row 4 is the remat design and
// keeps the forward's outputs).
//
// Bound at the main-path shapes (B = 100, T = 15; policy 5->200->200->2,
// dynamics 6->200->200->10): T times the step's work, ~15 x 17 MFLOP of
// float32 products forward (~3.9 us at the 67 TFLOP/s non-tensor-core peak)
// and ~15 x 42 MFLOP backward. It is a chain of dependent layer products
// and of reductions over all particles, so latency sets its time: per
// layer, the product over one CTA's share of the weights, one exchange
// through distributed shared memory and one cluster barrier.
//
// Design. One launch of thread-block clusters of kCluster = 8 CTAs
// (cudaLaunchKernelEx with a cluster dimension and the cooperative
// attribute, so every CTA is resident at once and this_grid().sync()
// works across clusters). The launch plan (clusters, particles per
// cluster, row tiles, threads, resident or streamed weights, shared
// memory, scratch) comes from rollout_plan() in fused_rollout.py and is
// checked here (lay_of).
// - Cluster c owns particles [c P, c P + P) for all T steps, walked in
//   tiles of TR rows: the states, the state cotangent and the returns never
//   leave it. Every CTA of the cluster holds the cluster's small per-row
//   quantities (states, actions, MLP outputs, rewards, their gradients) and
//   computes them redundantly, in the same order, so all eight hold the
//   same bits with no exchange.
// - Each step walks the cluster's tiles through the cluster walk of
//   cluster_walk.cuh (shared with the step kernels of fused_step.cu): CTA r
//   keeps rows [r kw, r kw + kw) of every W_l of both MLPs (all of W_0),
//   staged into shared memory once per launch where the plan is resident
//   (hidden widths of 512 read them from L2 in place); layers split across
//   the cluster through distributed shared memory, one cluster barrier a
//   layer; in the reverse sweep the policy's dW and db are added to a
//   per-CTA accumulator at every step, in a fixed order: in shared memory
//   with a resident plan, in its own scratch otherwise.
// - Moments once per cluster: each CTA reduces the cluster's rows (count,
//   mean, centred second moments, centred sums); with several clusters one
//   partial per cluster goes to scratch, one grid barrier, and every CTA
//   merges the partials in cluster order with the pairwise (Chan) update;
//   then the safe Cholesky on one thread of every CTA (the same bits in all)
//   and the resample of the cluster's rows. The MM adjoint's sums go the
//   same way. With one cluster there is no grid barrier at all.
// - After the reverse sweep the clusters' dW partials are summed in cluster
//   order after one grid barrier (with one cluster they are dW and db).
// No atomics on values: results repeat bit for bit. The backward
// recomputes each step from its boundary state (the remat design). The
// entry point's kind is a template parameter, so rows 3-5 carry no grid
// branches; so is whether every hidden activation is relu (the main
// path's), which the walks then apply as a constant: through the runtime
// activation switch their epilogues cost several times as much on an H100
// (tools/torch_rollout_laps.py --generic, PERF.md PR 7).
//
// Time split. Given RollArgs::split, thread 0 of CTA 0 adds the %globaltimer
// nanoseconds of each part of the launch to split[part] (kSplitParts parts:
// weight staging, forward MLP walk, forward moments and resample, grid
// barriers, MM adjoint, recompute, VJP with the dW accumulation, final sums).
//
// Grouped moment matching (RollArgs::groups G > 1, the kGrp instances):
// per step, each group that holds a row of the cluster is matched on a few
// lanes of one warp over all its rows (group_mm.cuh), the rows of a group
// that straddles two clusters read from the other cluster's copy in device
// memory after one grid barrier (the forward's pre-MM rows; the reverse
// sweep's state cotangents, through an exchange buffer in scratch). Where
// no group straddles a cluster boundary there is no grid barrier at all.
//
// Layout of the sources: rollout_kernel.cuh holds the kernel's device code
// and layout; this file its C entry points and the ungrouped instances
// without a critic; fused_rollout_grouped.cu and _grouped_grid.cu the
// grouped ones; fused_rollout_critic_fwd, _bwd and _vg.cu the instances with
// a critic, fused_rollout_critic_grouped_fwd, _bwd and _vg.cu the grouped
// ones.

#include "rollout_kernel.cuh"

// The kernel's instances with the value update's critic, relu or not: rows
// 3, 4 and 5, from fused_rollout_critic_fwd, _bwd and _vg.cu, grouped from
// fused_rollout_critic_grouped_fwd, _bwd and _vg.cu; the grouped instances
// without one, from fused_rollout_grouped.cu (rows 3-5, kind 0-2) and
// fused_rollout_grouped_grid.cu (rows 8-9, kind 3-4). The wide instance
// (fused_rollout_wide.cu, which includes this file) takes each from its own
// *_wide.cu unit under a name of its own.
extern "C" const void* fused_rollout_critic_fwd(int relu);
extern "C" const void* fused_rollout_critic_bwd(int relu);
extern "C" const void* fused_rollout_critic_vg(int relu);
extern "C" const void* fused_rollout_critic_grouped_fwd(int relu);
extern "C" const void* fused_rollout_critic_grouped_bwd(int relu);
extern "C" const void* fused_rollout_critic_grouped_vg(int relu);
extern "C" const void* fused_rollout_grouped(int kind, int relu);
extern "C" const void* fused_rollout_grouped_grid(int kind, int relu);

namespace {

// The instances of the kernel without a critic: one per entry point, each
// for MLPs whose hidden activations are all relu (the activation a
// compile-time constant in the walks) or not. Those with a critic (rows
// 3-5) are fused_rollout_critic_*.cu's.
using Kernel = void (*)(Step, Roll, Lay, Crit);
const Kernel kKernels[2][5] = {
    {rollout_kernel<false, kFwd, false, false>, rollout_kernel<false, kBwd, false, false>,
     rollout_kernel<false, kFwd | kBwd, false, false>, rollout_kernel<true, kFwd, false, false>,
     rollout_kernel<true, kBwd, false, false>},
    {rollout_kernel<false, kFwd, true, false>, rollout_kernel<false, kBwd, true, false>,
     rollout_kernel<false, kFwd | kBwd, true, false>, rollout_kernel<true, kFwd, true, false>,
     rollout_kernel<true, kBwd, true, false>}};

// The kernel of entry point `kind` (0-4), with a critic (rows 3-5 only) or
// not, grouped or not.
const void* kernel_of(bool relu, int kind, bool critic, bool grouped) {
  if (critic) {
    using Of = const void* (*)(int);
    const Of of[2][3] = {
        {fused_rollout_critic_fwd, fused_rollout_critic_bwd, fused_rollout_critic_vg},
        {fused_rollout_critic_grouped_fwd, fused_rollout_critic_grouped_bwd,
         fused_rollout_critic_grouped_vg}};
    return kind < 3 ? of[grouped][kind](relu) : nullptr;
  }
  if (grouped)
    return kind < 3 ? fused_rollout_grouped(kind, relu) : fused_rollout_grouped_grid(kind, relu);
  return reinterpret_cast<const void*>(kKernels[relu][kind]);
}

int launch(const StepArgs* a, const RollArgs* r, const int* plan, int kind, void* stream) {
  const int phases = kind == 0 || kind == 3 ? kFwd : (kind == 2 ? kFwd | kBwd : kBwd);
  const bool grid = kind >= 3;
  Step st;
  if (!r || !plan || !fill_step(st, a) || r->T < 1 || !r->w_t || !r->s_all || !r->nxt_raw ||
      !r->r_raw || !r->stats)
    return -1;
  const int r_mm = r->mm_rewards && !r->mean_only;
  const int G = r->groups;
  if (G < 1 || st.B % G || st.B / G < 2) return -1;
  if ((r->mm_states && !st.z_mm) || (r_mm && !st.z_rr)) return -1;
  if ((phases & kFwd) && !(grid ? r->disc && r->raw && r->vret && r->vw_t : r->loss && r->mret))
    return -1;
  if (grid && (phases & kBwd) && !(r->g_disc && r->g_raw && r->g_vret && r->g_sall && r->vw_t))
    return -1;
  if (grid && r->mean_only) return -1;
  Crit cr = {};
  Net cnet = {};
  const bool critic = r->critic != nullptr;
  if (critic) {
    // rows 3 and 5 refit (vret's weights, H within the rollout); row 4 bootstraps
    if (grid || r->mean_only || !fill_crit(cr, r->critic, st, (phases & kFwd) != 0, cnet))
      return -1;
    if ((phases & kFwd) && (!r->vw_t || r->critic->H > r->T)) return -1;
  }
  Lay lay;
  if (!lay_of(st, r->T, plan, lay, critic ? &cnet : nullptr, G) ||
      (lay.scratch > 0 && !r->scratch))
    return -1;
  Roll ro = {};
  ro.T = r->T;
  ro.H = critic ? r->critic->H : 0;
  ro.G = G;
  ro.mm_states = r->mm_states;
  ro.r_mm = r_mm;
  ro.mean_only = r->mm_rewards && r->mean_only;
  ro.sign = r->sign;
  ro.w_t = r->w_t;
  ro.g_loss = r->g_loss;
  ro.g_mret = r->g_mret;
  ro.vw_t = r->vw_t;
  ro.g_disc = r->g_disc;
  ro.g_raw = r->g_raw;
  ro.g_vret = r->g_vret;
  ro.g_sall = r->g_sall;
  ro.disc = r->disc;
  ro.raw = r->raw;
  ro.vret = r->vret;
  ro.split = r->split;
  ro.s_all = r->s_all;
  ro.nxt_raw = r->nxt_raw;
  ro.r_raw = r->r_raw;
  ro.stats = r->stats;
  ro.loss = r->loss;
  ro.mret = r->mret;
  ro.g_eps = r->g_eps;
  ro.scratch = r->scratch;
  if (phases & kBwd) {
    const int np = st.pol.n;
    for (int l = 0; l < kMaxLayers; ++l) {
      const bool lin = l <= np;
      ro.dw[l] = lin ? r->dw[l] : nullptr;
      ro.db[l] = lin ? r->db[l] : nullptr;
      if (lin && !ro.dw[l]) return -1;
      if (lin && (st.pol.b[l] != nullptr) != (ro.db[l] != nullptr)) return -1;
    }
  }
  const bool relu = relu_only(st.pol) && relu_only(st.dyn) && (!critic || relu_only(cnet));
  const void* k = kernel_of(relu, kind, critic, G > 1);
  if (!k) return -1;
  const int smem = plan[kPlanSmem];
  int e = set_smem(k, smem);
  if (e == cudaSuccess) {
    cudaLaunchAttribute attr[2];
    const cudaLaunchConfig_t cfg = cluster_config(lay.clusters, plan[kPlanThreads], smem,
                                                  static_cast<cudaStream_t>(stream), attr, true);
    void* args[] = {&st, &ro, &lay, &cr};
    e = cudaLaunchKernelExC(&cfg, k, args);
  }
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused launch must not fail the next one
    return e;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* fused_rollout_error(int e) {
  return e < 0 ? "arguments or a launch plan the kernel does not take"
               : cudaGetErrorString(static_cast<cudaError_t>(e));
}

// Sizes in bytes of the argument blocks (checked against the ctypes mirrors).
int fused_rollout_args_size() { return static_cast<int>(sizeof(StepArgs)); }
int fused_rollout_roll_size() { return static_cast<int>(sizeof(RollArgs)); }

// How many clusters of the rollout kernel (every entry point's instance) the
// current device holds at once with this many threads and bytes of dynamic
// shared memory per CTA. Returns 0 or a cudaError_t.
int fused_rollout_max_clusters(int threads, int smem, int* clusters) {
  if (!clusters || threads < 32 || threads > kMaxThreads || smem < 0 || smem > kSmemMax) return -1;
  *clusters = 0;
  int best = -1, e = cudaSuccess;
  for (int i = 0; i < 32; ++i) {  // ten instances without a critic, six with; grouped or not
    const bool grouped = i >= 16;
    const int j = i % 16;
    const void* k = j < 10 ? kernel_of(j / 5, j % 5, false, grouped)
                           : kernel_of((j - 10) / 3, (j - 10) % 3, true, grouped);
    e = set_smem(k, smem);
    if (e != cudaSuccess) break;
    cudaLaunchAttribute attr[2];
    const cudaLaunchConfig_t cfg = cluster_config(1, threads, smem, nullptr, attr, false);
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, k, &cfg);
    if (e != cudaSuccess) break;
    best = best < 0 ? n : min(best, n);
  }
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused query must not fail the next launch
    return e;
  }
  *clusters = best;
  return cudaSuccess;
}

// The forward (row 3): a->states is x0 [B, D], a->eps the action noise
// [T, B, U] (or null), a->z_mm / a->z_rr the prepared MM noise [T, B, D] /
// [T, B, 1]. Writes loss, mret and the residuals s_all, nxt_raw, r_raw, stats
// that the backward takes; with r->critic (and r->vw_t) first the critic
// refit, whose params', target', Adam state and v_loss it writes, and the
// bootstrap. plan: kPlanLen ints from rollout_plan. Returns 0, a
// cudaError_t, or -1.
int fused_rollout_fwd(const StepArgs* a, const RollArgs* r, const int* plan, void* stream) {
  if (!r || r->disc || r->g_disc || r->g_loss) return -1;
  return launch(a, r, plan, 0, stream);
}

// The backward (row 4) from the forward's residuals and the cotangents
// r->g_loss, r->g_mret: policy dW, db and (when r->g_eps) the gradient wrt
// the action noise. With r->critic, whose ins[0] holds the forward's
// params', the bootstrap's cotangent joins the state cotangent of s_T.
int fused_rollout_bwd(const StepArgs* a, const RollArgs* r, const int* plan, void* stream) {
  if (!r || !r->g_loss || !r->g_mret || r->g_disc || r->disc) return -1;
  return launch(a, r, plan, 1, stream);
}

// Value and grad (row 5): both sweeps in one launch with g_loss = 1 and
// g_mret = 0 (with r->critic the refit and the bootstrap between them).
int fused_rollout_vg(const StepArgs* a, const RollArgs* r, const int* plan, void* stream) {
  if (!r || r->g_loss || r->g_mret || r->disc || r->g_disc) return -1;
  return launch(a, r, plan, 2, stream);
}

// The grid tier's forward (row 8): as fused_rollout_fwd with r->vw_t, but
// writes the per-particle r->disc, r->raw, r->vret [B] (no loss, no
// mean_return); the boundary states r->s_all[1:] are states_all.
int fused_grid_fwd(const StepArgs* a, const RollArgs* r, const int* plan, void* stream) {
  if (!r || !r->disc || r->loss || r->mret || r->g_disc) return -1;
  return launch(a, r, plan, 3, stream);
}

// The grid tier's backward (row 9) from fused_grid_fwd's residuals and the
// cotangents r->g_disc, r->g_raw, r->g_vret [B] and r->g_sall [T, B, D]:
// policy dW, db and (when r->g_eps) the gradient wrt the action noise.
int fused_grid_bwd(const StepArgs* a, const RollArgs* r, const int* plan, void* stream) {
  if (!r || !r->g_disc || r->g_loss || r->g_mret || r->disc) return -1;
  return launch(a, r, plan, 4, stream);
}

}  // extern "C"
