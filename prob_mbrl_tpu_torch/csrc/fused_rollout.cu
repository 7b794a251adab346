// The whole MC-PILCO rollout (T steps, the discounted mean-return loss and the
// mean return) and its backward in one launch each, for Hopper (sm_90a), with
// a plain C interface that prob_mbrl_tpu_torch/ops/cuda/fused_rollout.py
// loads with ctypes.
//
// Replaces the Pallas TPU kernels of prob_mbrl_tpu/ops/pallas/fused_rollout.py
// whose body is make_loss_impl (:472-667, ungrouped, no value bootstrap):
//   fused_rollout_fwd <- make_fused_loss._fwd_pallas (the call at :813)
//   fused_rollout_bwd <- make_fused_loss._bwd_pallas (the call at :859)
//   fused_rollout_vg  <- make_fused_value_and_grad.fused_vg (the call at :981)
// and the grid tier's two kernels (make_grid_rollout, :1368-1602, ungrouped):
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

#include "cluster_walk.cuh"

// the plan's fields, in the order of fused_rollout.py's RolloutPlan
enum PlanField {
  kPlanCluster, kPlanClusters, kPlanParticles, kPlanTileRows, kPlanTiles, kPlanThreads,
  kPlanResident, kPlanSmem, kPlanScratch, kPlanLen
};

// ---- the C interface's second argument block (mirrored by ctypes) ----------

struct RollArgs {
  int T, mm_states, mm_rewards, mean_only;
  float sign;            // -1 when the loss maximizes the return
  const float* w_t;      // [T] discount weights
  const float* g_loss;   // backward: cotangents of loss and mean_return (device
  const float* g_mret;   //   scalars); null in value-and-grad (1 and 0)
  const float* vw_t;     // grid: [T] weights of vret
  const float* g_disc;   // grid backward: [B] cotangents of disc, raw and vret
  const float* g_raw;
  const float* g_vret;
  const float* g_sall;   // grid backward: [T, B, D] cotangent of s_all[1:]
  float* disc;           // grid forward: [B] per-particle disc, raw and vret
  float* raw;
  float* vret;
  unsigned long long* split;  // [kSplitParts] nanoseconds of each part, or null
  float* s_all;          // [T + 1, B, D] boundary states (s_0 = x0)
  float* nxt_raw;        // [T, B, D] pre-MM next states
  float* r_raw;          // [T, B] pre-MM rewards
  float* stats;          // [T, 2, kStat] (m, sd, L) of the state and reward resamples
  float* loss;           // [1]
  float* mret;           // [1]
  float* g_eps;          // [T, B, U] or null
  float* scratch;        // plan[kPlanScratch] floats (null when 0)
  float* dw[kMaxLayers];      // policy dW (outputs)
  float* db[kMaxLayers];      // policy db (outputs; null where no bias)
};

namespace {

constexpr int kMaxTiles = 8;      // row tiles a cluster walks, at most
constexpr int kFwd = 1, kBwd = 2;
// parts of RollArgs::split
constexpr int kLapStage = 0, kLapFwdWalk = 1, kLapFwdMM = 2, kLapGrid = 3, kLapBwdMM = 4,
              kLapRecompute = 5, kLapVjp = 6, kLapSums = 7, kSplitParts = 8;

static_assert(kLapSums + 1 == kSplitParts, "the parts of RollArgs::split");

}  // namespace

namespace {

struct Roll {
  int T, mm_states, r_mm, mean_only;
  float sign;
  const float *w_t, *g_loss, *g_mret, *vw_t, *g_disc, *g_raw, *g_vret, *g_sall;
  float *s_all, *nxt_raw, *r_raw, *stats, *loss, *mret, *g_eps, *disc, *raw, *vret, *scratch;
  unsigned long long* split;
  float* dw[kMaxLayers];
  float* db[kMaxLayers];
};

struct RollSm {
  Site s, r;  // states, rewards
  float part[kPart];  // this cluster's partial
  float tot[kPart];   // the merged totals (backward)
  float stat[2 * kStat];  // the backward's (m, sd, L) of both sites, loaded together
  float rmean;        // the mean-only reward's particle mean
  unsigned long long last_lap;  // the time split's clock at the last lap
};

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// With ro.split, thread 0 of CTA 0 adds the time since the last lap to
// ro.split[part].
__device__ __forceinline__ void lap(const Roll& ro, RollSm& sh, int part) {
  if (!ro.split || blockIdx.x != 0 || threadIdx.x != 0) return;
  const unsigned long long t = globaltimer();
  ro.split[part] += t - sh.last_lap;
  sh.last_lap = t;
}

__device__ __forceinline__ void grid_sync(const Roll& ro, RollSm& sh, int part) {
  lap(ro, sh, part);
  cg::this_grid().sync();
  lap(ro, sh, kLapGrid);
}

// The per-particle arrays of the cluster (lay.pp): states, pre-MM nxt (the
// backward: its gradient), the state cotangent, the step's MM noise and
// (backward) pre-MM nxt; pre-MM r (its gradient), disc, raw, vret, the
// step's reward MM noise and (backward) pre-MM r.
struct Rows {
  float *S, *XN, *GS, *ZM, *XR, *RR, *disc, *raw, *vret, *ZR, *RW;
};

__device__ __forceinline__ Rows rows_of(const Ctx& c, int D) {
  float* p = c.sm + c.lay.pp;
  const int P = c.lay.P;
  float* q = p + 5 * P * D;
  return Rows{p, p + P * D, p + 2 * P * D, p + 3 * P * D, p + 4 * P * D,
              q, q + P, q + 2 * P, q + 3 * P, q + 4 * P, q + 5 * P};
}

// The step's backward for a tile at step t: recompute from the boundary
// states srows, then the VJPs (step_vjp). The gradients wrt the pre-MM nxt
// and r come from the cluster's rows (XN, RR, at local particle lp); the
// state cotangent goes back to GS.
template <bool kReluOnly>
__device__ void step_bwd(Ctx& c, const Step& st, const Roll& ro, RollSm& sh, int t,
                         const float* srows, int row0, int nrows, int lp, float* dwacc) {
  const int D = st.D, U = st.U, B = st.B;
  const float* eps_t = st.eps ? st.eps + (size_t)t * B * U : nullptr;
  step_fwd<kReluOnly>(c, st, srows, eps_t, row0, nrows, true);
  lap(ro, sh, kLapRecompute);
  const Rows rw = rows_of(c, D);
  float* g_eps = ro.g_eps && c.rank == 0 ? ro.g_eps + ((size_t)t * B + row0) * U : nullptr;
  step_vjp<kReluOnly>(c, st, rw.XN + lp * D, rw.RR + lp, row0, nrows, g_eps, rw.GS + lp * D,
                      dwacc);
  lap(ro, sh, kLapVjp);
}

// ---- moments and their adjoint, once per cluster ---------------------------

// Loads the clusters' partials [clusters][kPart] of slot `slot` into
// lay.parts after a grid barrier, this cluster's from sh.part first (rank 0
// writes it). With one cluster: sh.part itself, no barrier.
__device__ const float* gather_parts(const Ctx& c, const Roll& ro, RollSm& sh, int base, int len,
                                     int lap_part) {
  const int nc = c.lay.clusters;
  if (nc == 1) return sh.part;
  float* dst = ro.scratch + base;
  if (c.rank == 0)
    for (int e = threadIdx.x; e < len; e += blockDim.x) dst[c.cid * len + e] = sh.part[e];
  grid_sync(ro, sh, lap_part);
  float* parts = c.sm + c.lay.parts;
  for (int e = threadIdx.x; e < nc * len; e += blockDim.x) parts[e] = dst[e];
  __syncthreads();
  return parts;
}

// The forward's moments of step t over all B particles: the cluster's
// partial from its rows (every CTA the same), then the merge in cluster order
// and the safe Cholesky of each resample site (cluster 0, rank 0 keeps them
// in ro.stats); sh.rmean for the mean-only reward.
__device__ void fwd_moments(const Ctx& c, const Step& st, const Roll& ro, RollSm& sh, int t) {
  const int D = st.D, B = st.B, n = c.n, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const Rows rw = rows_of(c, D);
  const int nT = D * (D + 1) / 2;
  for (int w = warp; w <= D; w += nw) {  // means; warp D: the rewards
    float v = 0.f;
    for (int p = lane; p < n; p += 32) v += w < D ? rw.XN[p * D + w] : rw.RR[p];
    v = warp_sum(v);
    if (lane == 0) {
      if (w < D) {
        sh.part[kFMean + w] = v / n;
      } else {
        sh.part[kFR] = v / n;
        sh.part[kFR + 3] = v;
      }
    }
  }
  if (tid == 0) sh.part[kFN] = static_cast<float>(n);
  __syncthreads();
  for (int e = warp; e < nT + D + 2; e += nw) {  // centred second moments and sums
    float v = 0.f;
    if (e < nT) {
      int i, j;
      tri_of(e, i, j);
      const float mi = sh.part[kFMean + i], mj = sh.part[kFMean + j];
      for (int p = lane; p < n; p += 32) v += (rw.XN[p * D + i] - mi) * (rw.XN[p * D + j] - mj);
    } else if (e < nT + D) {
      const int i = e - nT;
      const float mi = sh.part[kFMean + i];
      for (int p = lane; p < n; p += 32) v += rw.XN[p * D + i] - mi;
    } else {
      const float mr = sh.part[kFR];
      for (int p = lane; p < n; p += 32) {
        const float d = rw.RR[p] - mr;
        v += e == nT + D ? d * d : d;
      }
    }
    v = warp_sum(v);
    if (lane == 0) {
      if (e < nT) sh.part[kFM2 + e] = v;
      else if (e < nT + D) sh.part[kFSd + e - nT] = v;
      else sh.part[kFR + 1 + (e - nT - D)] = v;
    }
  }
  __syncthreads();
  const float* q = gather_parts(c, ro, sh, c.lay.s_fwd + t * c.lay.clusters * kPart, kPart,
                                kLapFwdMM);
  const int nc = c.lay.clusters;
  // pairwise merge in cluster order, one thread per entry
  for (int e = tid; e < nT + 2; e += nt) {
    if (e < nT ? !ro.mm_states : (e == nT ? !ro.r_mm : !ro.mean_only)) continue;
    if (e == nT + 1) {
      float s = 0.f;
      for (int cc = 0; cc < nc; ++cc) s += q[cc * kPart + kFR + 3];
      sh.rmean = s / B;
      continue;
    }
    int i = 0, j = 0, mo = kFR, m2 = kFR + 1;
    if (e < nT) {
      tri_of(e, i, j);
      mo = kFMean;
      m2 = kFM2 + e;
    }
    float nn = 0.f, mi = 0.f, mj = 0.f, M = 0.f;
    for (int cc = 0; cc < nc; ++cc) {
      const float* pc = q + cc * kPart;
      const float nb = pc[kFN], tot = nn + nb;
      const float di = pc[mo + i] - mi, dj = pc[mo + j] - mj;
      M += pc[m2] + di * dj * (nn * nb / tot);
      mi += di * (nb / tot);
      mj += dj * (nb / tot);
      nn = tot;
    }
    Site& s = e < nT ? sh.s : sh.r;
    const int d = e < nT ? D : 1;
    s.S[i * d + j] = s.S[j * d + i] = M / (B - 1);
    if (i == j) s.m[i] = mi;
  }
  __syncthreads();
  // centred sums about the merged mean
  for (int e = tid; e <= D; e += nt) {
    if (e < D ? !ro.mm_states : !ro.r_mm) continue;
    const int mo = e < D ? kFMean + e : kFR, so = e < D ? kFSd + e : kFR + 2;
    const float m = e < D ? sh.s.m[e] : sh.r.m[0];
    float s = 0.f;
    for (int cc = 0; cc < nc; ++cc) {
      const float* pc = q + cc * kPart;
      s += pc[so] + pc[kFN] * (pc[mo] - m);
    }
    (e < D ? sh.s.sd[e] : sh.r.sd[0]) = s;
  }
  __syncthreads();
  float* stat = ro.stats + (size_t)t * 2 * kStat;
  const bool keeper = c.cid == 0 && c.rank == 0;
  if (tid == 0 && ro.mm_states) {
    safe_chol(sh.s.S, D, sh.s.L);
    if (keeper) save_site(sh.s, D, stat);
  }
  if (tid == 32 && ro.r_mm) {
    safe_chol(sh.r.S, 1, sh.r.L);
    if (keeper) save_site(sh.r, 1, stat + kStat);
  }
  __syncthreads();
}

// ---- the sweeps ---------------------------------------------------------------

template <bool kGrid>
__device__ __forceinline__ float reward_cot(const Roll& ro, int t, int b, float c) {
  if (kGrid) return ro.w_t[t] * ro.g_disc[b] + ro.g_raw[b] + ro.vw_t[t] * ro.g_vret[b];
  return c;
}

template <bool kGrid, bool kReluOnly>
__device__ void forward_sweep(Ctx& c, const Step& st, const Roll& ro, RollSm& sh) {
  const int B = st.B, D = st.D, U = st.U, tid = threadIdx.x, nt = blockDim.x;
  const int TR = c.lay.TR, n = c.n, p0 = c.p0;
  const Rows rw = rows_of(c, D);
  for (int e = tid; e < n * D; e += nt) {
    rw.S[e] = st.states[(size_t)p0 * D + e];
    if (c.rank == 0) ro.s_all[(size_t)p0 * D + e] = rw.S[e];
  }
  for (int p = tid; p < n; p += nt) rw.disc[p] = rw.raw[p] = rw.vret[p] = 0.f;
  __syncthreads();
  for (int t = 0; t < ro.T; ++t) {
    // the step's MM noise of the cluster's rows, in flight during the walk
    if (ro.mm_states) prefetch(rw.ZM, st.z_mm + ((size_t)t * B + p0) * D, n * D);
    if (ro.r_mm) prefetch(rw.ZR, st.z_rr + (size_t)t * B + p0, n);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const float* eps_t = st.eps ? st.eps + (size_t)t * B * U : nullptr;
    float* x_t = ro.nxt_raw + (size_t)t * B * D;
    float* r_t = ro.r_raw + (size_t)t * B;
    for (int lp = 0; lp < n; lp += TR) {
      const int nrows = min(TR, n - lp);
      step_fwd<kReluOnly>(c, st, rw.S + lp * D, eps_t, p0 + lp, nrows, false);
      const float* ts = c.sm + c.lay.tsm;
      const int TRP = c.lay.TRP;
      for (int e = tid; e < nrows * D; e += nt) {
        const int r = e / D, k = e - r * D;
        const float v = ts[(kTNxt + k) * TRP + r];
        rw.XN[(lp + r) * D + k] = v;
        if (c.rank == 0) x_t[(size_t)(p0 + lp + r) * D + k] = v;
      }
      for (int r = tid; r < nrows; r += nt) {
        rw.RR[lp + r] = ts[kTR * TRP + r];
        if (c.rank == 0) r_t[p0 + lp + r] = ts[kTR * TRP + r];
      }
      __syncthreads();
    }
    lap(ro, sh, kLapFwdWalk);
    if (ro.mm_states || ro.r_mm || ro.mean_only) fwd_moments(c, st, ro, sh, t);
    prefetch_wait();
    float* s_n = ro.s_all + (size_t)(t + 1) * B * D;
    for (int e = tid; e < n * D; e += nt) {
      const int p = e / D, k = e - p * D;
      float v = rw.XN[e];
      if (ro.mm_states) {
        float acc = 0.f;
        for (int j = 0; j <= k; ++j) acc += rw.ZM[p * D + j] * sh.s.L[k * D + j];
        v = sh.s.m[k] + acc;
      }
      rw.S[e] = v;
      if (c.rank == 0) s_n[(size_t)p0 * D + e] = v;
    }
    const float w = ro.w_t[t], vw = kGrid ? ro.vw_t[t] : 0.f;
    for (int p = tid; p < n; p += nt) {
      float r = rw.RR[p];
      if (ro.mean_only) r = sh.rmean;
      else if (ro.r_mm) r = sh.r.m[0] + rw.ZR[p] * sh.r.L[0];
      rw.disc[p] = rw.disc[p] + w * r;
      rw.raw[p] = rw.raw[p] + r;
      if (kGrid) rw.vret[p] = rw.vret[p] + vw * r;
    }
    __syncthreads();
    lap(ro, sh, kLapFwdMM);
  }
  if (kGrid) {  // per-particle outputs, no reduction
    if (c.rank == 0) {
      for (int p = tid; p < n; p += nt) {
        ro.disc[p0 + p] = rw.disc[p];
        ro.raw[p0 + p] = rw.raw[p];
        ro.vret[p0 + p] = rw.vret[p];
      }
    }
    return;
  }
  // loss and mean_return: each cluster's sums, then the clusters' in order
  const int warp = tid >> 5, lane = tid & 31;
  if (warp < 2) {
    float v = 0.f;
    for (int p = lane; p < n; p += 32) v += warp == 0 ? rw.disc[p] : rw.raw[p];
    v = warp_sum(v);
    if (lane == 0) sh.part[warp] = v;
  }
  __syncthreads();
  const float* q = gather_parts(c, ro, sh, c.lay.s_loss, 2, kLapSums);
  if (blockIdx.x == 0 && tid == 0) {
    float disc = 0.f, raw = 0.f;
    for (int cc = 0; cc < c.lay.clusters; ++cc) {
      disc += q[cc * 2];
      raw += q[cc * 2 + 1];
    }
    *ro.loss = ro.sign * (disc / B);
    *ro.mret = raw / B;
  }
  lap(ro, sh, kLapSums);
}

template <bool kGrid, bool kReluOnly>
__device__ void reverse_sweep(Ctx& c, const Step& st, const Roll& ro, RollSm& sh, float* dwacc) {
  const int B = st.B, D = st.D, tid = threadIdx.x, nt = blockDim.x;
  const int TR = c.lay.TR, n = c.n, p0 = c.p0;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int nT = D * (D + 1) / 2;
  const Rows rw = rows_of(c, D);
  const float g_loss = kGrid ? 0.f : (ro.g_loss ? *ro.g_loss : 1.f);
  const float g_mret = kGrid ? 0.f : (ro.g_mret ? *ro.g_mret : 0.f);
  for (int e = tid; e < n * D; e += nt) rw.GS[e] = 0.f;
  // the forward of this launch (rank 0's residuals, cluster 0's stats) is
  // ordered before the reads below by this barrier, and across clusters by
  // the loss's grid barrier
  cluster_sync();
  for (int t = ro.T - 1; t >= 0; --t) {
    // the step's residuals, MM noise and moments of the cluster's rows
    if (ro.mm_states) {
      prefetch(rw.ZM, st.z_mm + ((size_t)t * B + p0) * D, n * D);
      prefetch(rw.XR, ro.nxt_raw + ((size_t)t * B + p0) * D, n * D);
    }
    if (ro.r_mm) {
      prefetch(rw.ZR, st.z_rr + (size_t)t * B + p0, n);
      prefetch(rw.RW, ro.r_raw + (size_t)t * B + p0, n);
    }
    prefetch(sh.stat, ro.stats + (size_t)t * 2 * kStat, 2 * kStat);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (kGrid) {  // the cotangent of states_all[t] joins the state cotangent
      const float* gs = ro.g_sall + (size_t)t * B * D + (size_t)p0 * D;
      for (int e = tid; e < n * D; e += nt) rw.GS[e] += gs[e];
      __syncthreads();
    }
    const float cu = (ro.sign * g_loss * ro.w_t[t] + g_mret) / B;
    prefetch_wait();
    // the cluster's sums: states gm[i], gL[i, j <= i]; rewards gm, gL
    for (int e = warp; e < D + nT + 2; e += nw) {
      if (e < D + nT ? !ro.mm_states : !ro.r_mm) continue;
      float v = 0.f;
      if (e < D) {
        for (int p = lane; p < n; p += 32) v += rw.GS[p * D + e];
      } else if (e < D + nT) {
        int i, j;
        tri_of(e - D, i, j);
        for (int p = lane; p < n; p += 32) v += rw.GS[p * D + i] * rw.ZM[p * D + j];
      } else {
        for (int p = lane; p < n; p += 32) {
          const float cp = reward_cot<kGrid>(ro, t, p0 + p, cu);
          v += e == D + nT ? cp : cp * rw.ZR[p];
        }
      }
      v = warp_sum(v);
      if (lane == 0) sh.part[e < D ? kBGm + e : (e < D + nT ? kBGl + e - D : kBR + e - D - nT)] = v;
    }
    __syncthreads();
    const float* q = gather_parts(c, ro, sh, c.lay.s_bwd + t * c.lay.clusters * kPart, kPart,
                                  kLapBwdMM);
    for (int e = tid; e < kPart; e += nt) {
      float v = 0.f;
      for (int cc = 0; cc < c.lay.clusters; ++cc) v += q[cc * kPart + e];
      sh.tot[e] = v;
    }
    __syncthreads();
    if (tid == 0 && ro.mm_states) {
      load_site(sh.stat, D, sh.s);
      for (int i = 0, e = 0; i < D; ++i) {
        sh.s.gm[i] = sh.tot[kBGm + i];
        for (int j = 0; j < D; ++j) sh.s.gL[i * D + j] = j <= i ? sh.tot[kBGl + e++] : 0.f;
      }
      mm_vjp_coeffs(sh.s.L, true, sh.s.gm, sh.s.gL, sh.s.sd, B, D, sh.s.H, sh.s.c0);
    }
    if (tid == 32 && ro.r_mm) {
      load_site(sh.stat + kStat, 1, sh.r);
      sh.r.gm[0] = sh.tot[kBR];
      sh.r.gL[0] = sh.tot[kBR + 1];
      mm_vjp_coeffs(sh.r.L, true, sh.r.gm, sh.r.gL, sh.r.sd, B, 1, sh.r.H, sh.r.c0);
    }
    __syncthreads();
    // gradients wrt the cluster's pre-MM nxt and r of step t
    for (int e = tid; e < n * D; e += nt) {
      const int p = e / D, k = e - p * D;
      float v = rw.GS[e];
      if (ro.mm_states) {
        float acc = 0.f;
        for (int k2 = 0; k2 < D; ++k2)
          acc += sh.s.H[k * D + k2] * (rw.XR[p * D + k2] - sh.s.m[k2]);
        v = acc + sh.s.c0[k];
      }
      rw.XN[e] = v;
    }
    for (int p = tid; p < n; p += nt) {
      float v = reward_cot<kGrid>(ro, t, p0 + p, cu);
      if (ro.r_mm)
        v = sh.r.H[0] * (rw.RW[p] - sh.r.m[0]) + sh.r.c0[0];
      rw.RR[p] = v;
    }
    __syncthreads();
    lap(ro, sh, kLapBwdMM);
    const float* s_t = ro.s_all + (size_t)t * B * D;
    for (int lp = 0; lp < n; lp += TR)
      step_bwd<kReluOnly>(c, st, ro, sh, t, s_t + (size_t)(p0 + lp) * D, p0 + lp, min(TR, n - lp), lp,
                     dwacc);
  }
}

// The policy's dW and db from every CTA's accumulator: with one cluster
// straight to the outputs; else each cluster's into its flat partial, one
// grid barrier, and every thread of the grid sums entries over the clusters
// in order.
__device__ void finish_dw(const Ctx& c, const Step& st, const Roll& ro, RollSm& sh,
                          const float* dwacc) {
  const int tid = threadIdx.x, nt = blockDim.x, np = st.pol.n, nc = c.lay.clusters;
  const int ndw = c.lay.dw_flat[np + 1];
  float* flat = ro.scratch + c.lay.s_dw;
  __syncthreads();
  for (int l = 0; l <= np; ++l) {
    const int din = st.pol.dims[l], dout = st.pol.dims[l + 1], ld = round4(dout);
    const Slice ks = slice_of(din, c.rank), js = slice_of(dout, c.rank);
    const float* acc = dwacc + c.lay.dw_off[l];
    const float* accb = acc + round4(ceil_div(din, kCluster)) * ld;
    float* dw = nc == 1 ? ro.dw[l] : flat + (size_t)c.cid * ndw + c.lay.dw_flat[l];
    float* db = nc == 1 ? ro.db[l] : flat + (size_t)c.cid * ndw + c.lay.dw_flat[l] + din * dout;
    for (int e = tid; e < ks.cnt * dout; e += nt) {
      const int k = e / dout, j = e - k * dout;
      dw[(size_t)(ks.c0 + k) * dout + j] = acc[k * ld + j];
    }
    if (st.pol.b[l])
      for (int jj = tid; jj < js.cnt; jj += nt) db[js.c0 + jj] = accb[js.c0 + jj];
  }
  if (nc == 1) return;
  grid_sync(ro, sh, kLapSums);
  for (int e = blockIdx.x * nt + tid; e < ndw; e += gridDim.x * nt) {
    int l = 0;
    while (e >= c.lay.dw_flat[l + 1]) ++l;
    const int din = st.pol.dims[l], dout = st.pol.dims[l + 1], i = e - c.lay.dw_flat[l];
    if (i >= din * dout && !st.pol.b[l]) continue;
    float v = 0.f;
    for (int cc = 0; cc < nc; ++cc) v += flat[(size_t)cc * ndw + e];
    if (i < din * dout) ro.dw[l][i] = v;
    else ro.db[l][i - din * dout] = v;
  }
}

template <bool kGrid, int kPhases, bool kReluOnly>
__device__ void run(Ctx& c, const Step& st, const Roll& ro, RollSm& sh) {
  float* dwacc = c.lay.resident ? c.sm + c.lay.dwa
                      : ro.scratch + c.lay.s_dwcta + (size_t)blockIdx.x * c.lay.dw_cta;
  stage(c, st, (kPhases & kBwd) ? dwacc : nullptr);
  lap(ro, sh, kLapStage);
  if (kPhases & kFwd) forward_sweep<kGrid, kReluOnly>(c, st, ro, sh);
  if (kPhases & kBwd) {
    reverse_sweep<kGrid, kReluOnly>(c, st, ro, sh, dwacc);
    finish_dw(c, st, ro, sh, dwacc);
    lap(ro, sh, kLapSums);
  }
}

// The forward's last barrier (the loss's, with several clusters; with one,
// the cluster barriers of every layer) orders cluster 0's stats before the
// backward of a value-and-grad launch reads them.
template <bool kGrid, int kPhases, bool kReluOnly>
__global__ void __launch_bounds__(kMaxThreads, 1)
rollout_kernel(const __grid_constant__ Step st, const __grid_constant__ Roll ro,
               const __grid_constant__ Lay lay) {
  extern __shared__ __align__(16) float smem[];
  __shared__ RollSm sh;
  // the step's and the layout's fields, indexed by layer all through the
  // walks, read from shared memory rather than the parameter space
  __shared__ Step st_s;
  __shared__ Lay lay_s;
  static_assert(sizeof(RollSm) + sizeof(Step) + sizeof(Lay) <= 8192 - 512, "static smem");
  static_assert(sizeof(Step) % 4 == 0 && sizeof(Lay) % 4 == 0, "word copies");
  for (int i = threadIdx.x; i < (int)(sizeof(Step) / 4); i += blockDim.x)
    reinterpret_cast<int*>(&st_s)[i] = reinterpret_cast<const int*>(&st)[i];
  for (int i = threadIdx.x; i < (int)(sizeof(Lay) / 4); i += blockDim.x)
    reinterpret_cast<int*>(&lay_s)[i] = reinterpret_cast<const int*>(&lay)[i];
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int cid = blockIdx.x / kCluster;
  const int p0 = cid * lay.P;
  Ctx c{smem, lay_s, rank, cid, p0, min(lay.P, st.B - p0), 0};
  if (ro.split && blockIdx.x == 0 && threadIdx.x == 0) sh.last_lap = globaltimer();
  __syncthreads();
  run<kGrid, kPhases, kReluOnly>(c, st_s, ro, sh);
}

}  // namespace

// ---- host side ----------------------------------------------------------------

namespace {

// The layout of a launch from the plan (the formulas of rollout_plan in
// fused_rollout.py); false when the plan does not fit these models.
bool lay_of(const Step& st, int T, const int* plan, Lay& L) {
  const int TR = plan[kPlanTileRows], tiles = plan[kPlanTiles], P = plan[kPlanParticles];
  const int clusters = plan[kPlanClusters], threads = plan[kPlanThreads];
  if (plan[kPlanCluster] != kCluster || TR < RB || TR > kMaxTileRows || TR % RB) return false;
  if (tiles < 1 || tiles > kMaxTiles || P != tiles * TR || clusters != ceil_div(st.B, P))
    return false;
  if (threads < 32 || threads > kMaxThreads || threads % 32) return false;
  if (plan[kPlanResident] != 0 && plan[kPlanResident] != 1) return false;
  const int D = st.D;
  L.clusters = clusters;
  L.P = P;
  long long off = walk_lay(st, TR, plan[kPlanResident], true, L);
  L.pp = static_cast<int>(off);
  off += round4(P * (5 * D + 6));
  L.parts = static_cast<int>(off);
  off += (long long)clusters * kPart;
  if (4 * off != plan[kPlanSmem] || 4 * off > kSmemMax) return false;
  // scratch: the clusters' partials (several clusters), the CTAs' dW
  // accumulators (streamed plans)
  long long sc = 0;
  const int multi = clusters > 1;
  const int flat = L.dw_flat[st.pol.n + 1];
  L.s_fwd = 0;
  sc += multi ? (long long)T * clusters * kPart : 0;
  L.s_bwd = static_cast<int>(sc);
  sc += multi ? (long long)T * clusters * kPart : 0;
  L.s_loss = static_cast<int>(sc);
  sc += multi ? 2LL * clusters : 0;
  L.s_dw = static_cast<int>(sc);
  sc += multi ? (long long)clusters * flat : 0;
  L.s_dwcta = static_cast<int>(sc);
  sc += L.resident ? 0 : (long long)clusters * kCluster * L.dw_cta;
  L.scratch = static_cast<int>(sc);
  return sc == plan[kPlanScratch] && sc < (1LL << 31);
}

// The instances of the kernel: one per entry point, each for MLPs whose
// hidden activations are all relu (the activation a compile-time constant
// in the walks) or not.
using Kernel = void (*)(Step, Roll, Lay);
const Kernel kKernels[2][5] = {
    {rollout_kernel<false, kFwd, false>, rollout_kernel<false, kBwd, false>,
     rollout_kernel<false, kFwd | kBwd, false>, rollout_kernel<true, kFwd, false>,
     rollout_kernel<true, kBwd, false>},
    {rollout_kernel<false, kFwd, true>, rollout_kernel<false, kBwd, true>,
     rollout_kernel<false, kFwd | kBwd, true>, rollout_kernel<true, kFwd, true>,
     rollout_kernel<true, kBwd, true>}};

int launch(const StepArgs* a, const RollArgs* r, const int* plan, int kind, void* stream) {
  const int phases = kind == 0 || kind == 3 ? kFwd : (kind == 2 ? kFwd | kBwd : kBwd);
  const bool grid = kind >= 3;
  Step st;
  if (!r || !plan || !fill_step(st, a) || r->T < 1 || !r->w_t || !r->s_all || !r->nxt_raw ||
      !r->r_raw || !r->stats)
    return -1;
  const int r_mm = r->mm_rewards && !r->mean_only;
  if ((r->mm_states && !st.z_mm) || (r_mm && !st.z_rr)) return -1;
  if ((phases & kFwd) && !(grid ? r->disc && r->raw && r->vret && r->vw_t : r->loss && r->mret))
    return -1;
  if (grid && (phases & kBwd) && !(r->g_disc && r->g_raw && r->g_vret && r->g_sall && r->vw_t))
    return -1;
  if (grid && r->mean_only) return -1;
  Lay lay;
  if (!lay_of(st, r->T, plan, lay) || (lay.scratch > 0 && !r->scratch)) return -1;
  Roll ro = {};
  ro.T = r->T;
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
  const Kernel k = kKernels[relu_only(st.pol) && relu_only(st.dyn)][kind];
  const int smem = plan[kPlanSmem];
  int e = set_smem(reinterpret_cast<const void*>(k), smem);
  if (e == cudaSuccess) {
    cudaLaunchAttribute attr[2];
    const cudaLaunchConfig_t cfg = cluster_config(lay.clusters, plan[kPlanThreads], smem,
                                                  static_cast<cudaStream_t>(stream), attr, true);
    e = cudaLaunchKernelEx(&cfg, k, st, ro, lay);
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
  for (int i = 0; i < 10; ++i) {
    const Kernel k = kKernels[i / 5][i % 5];
    e = set_smem(reinterpret_cast<const void*>(k), smem);
    if (e != cudaSuccess) break;
    cudaLaunchAttribute attr[2];
    const cudaLaunchConfig_t cfg = cluster_config(1, threads, smem, nullptr, attr, false);
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, reinterpret_cast<const void*>(k), &cfg);
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
// that the backward takes. plan: kPlanLen ints from rollout_plan. Returns 0,
// a cudaError_t, or -1.
int fused_rollout_fwd(const StepArgs* a, const RollArgs* r, const int* plan, void* stream) {
  if (!r || r->disc || r->g_disc || r->g_loss) return -1;
  return launch(a, r, plan, 0, stream);
}

// The backward (row 4) from the forward's residuals and the cotangents
// r->g_loss, r->g_mret: policy dW, db and (when r->g_eps) the gradient wrt
// the action noise.
int fused_rollout_bwd(const StepArgs* a, const RollArgs* r, const int* plan, void* stream) {
  if (!r || !r->g_loss || !r->g_mret || r->g_disc || r->disc) return -1;
  return launch(a, r, plan, 1, stream);
}

// Value and grad (row 5): both sweeps in one launch with g_loss = 1 and
// g_mret = 0.
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
