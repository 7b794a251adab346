// The whole-rollout kernel (rollout_kernel, every entry point's instance),
// its device code and its launch layout, shared by fused_rollout.cu (the C
// entry points and the instances without a critic; its comment says what
// the kernel replaces and how it is laid out) and fused_rollout_critic_fwd,
// _bwd and _vg.cu (the instances of rows 3, 4 and 5 that refit the value
// update's critic, each a translation unit of its own so that nvcc compiles
// the four in parallel; build.py links them into libfused_rollout.so). Whether a launch refits a critic is a
// template parameter (kCritic): the instances without one run the same
// code as they would without critic_walk.cuh. So is grouped moment matching
// (the kGrp bit of kPhases; group_mm.cuh), whose instances are compiled in
// fused_rollout_grouped.cu, _grouped_grid.cu and, with a critic,
// fused_rollout_critic_grouped_{fwd,bwd,vg}.cu.
#pragma once

#include "critic_walk.cuh"
#include "group_mm.cuh"

// the plan's fields, in the order of fused_rollout.py's RolloutPlan
enum PlanField {
  kPlanCluster, kPlanClusters, kPlanParticles, kPlanTileRows, kPlanTiles, kPlanThreads,
  kPlanResident, kPlanSmem, kPlanScratch, kPlanLen
};

// ---- the C interface's second argument block (mirrored by ctypes) ----------

struct RollArgs {
  int T, mm_states, mm_rewards, mean_only;
  int groups;            // G: MM groups of B / G contiguous particles (1: none)
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
  float* stats;          // [T, G, 2, kStat] (m, sd, L) of each group's state and reward
                         //   resamples
  float* loss;           // [1]
  float* mret;           // [1]
  float* g_eps;          // [T, B, U] or null
  float* scratch;        // plan[kPlanScratch] floats (null when 0)
  float* dw[kMaxLayers];      // policy dW (outputs)
  float* db[kMaxLayers];      // policy db (outputs; null where no bias)
  const CriticArgs* critic;   // rows 3-5: the value update's critic, or null (vw_t then
                              //   the [T] weights of vret)
};

namespace {

constexpr int kMaxTiles = 8;      // row tiles a cluster walks, at most
// the wide instance's warps of grouped MM (one group a warp at a time, its
// sites in RollSm)
constexpr int kMmWarps = 2;
// kPhases: the sweeps, and whether the resamples are grouped (G > 1)
constexpr int kFwd = 1, kBwd = 2, kGrp = 4;
// parts of RollArgs::split
constexpr int kLapStage = 0, kLapFwdWalk = 1, kLapFwdMM = 2, kLapGrid = 3, kLapBwdMM = 4,
              kLapRecompute = 5, kLapVjp = 6, kLapSums = 7, kLapCritic = 8, kSplitParts = 9;

static_assert(kLapCritic + 1 == kSplitParts, "the parts of RollArgs::split");

}  // namespace

namespace {

struct Roll {
  int T, mm_states, r_mm, mean_only;
  int H;  // the critic's TD horizon (rows 3 and 5 with a critic)
  float sign;
  const float *w_t, *g_loss, *g_mret, *vw_t, *g_disc, *g_raw, *g_vret, *g_sall;
  float *s_all, *nxt_raw, *r_raw, *stats, *loss, *mret, *g_eps, *disc, *raw, *vret, *scratch;
  unsigned long long* split;
  float* dw[kMaxLayers];
  float* db[kMaxLayers];
  int G;  // MM groups
};

struct RollSm {
  Site s, r;  // states, rewards
  float part[kPart];  // this cluster's partial
  float tot[kPart];   // the merged totals (backward)
  float stat[2 * kStat];  // the backward's (m, sd, L) of both sites, loaded together
  float rmean;        // the mean-only reward's particle mean
  float closs, creg;  // the critic refit: this cluster's sum of the rows' losses; the regulariser
  float red[32];      // block_sum's warp partials
  unsigned long long last_lap;  // the time split's clock at the last lap
#if PMBRL_WIDE
  GroupSite gsite[kMmWarps];    // grouped MM: each MM warp's group
  GroupAdjoint gadj[kMmWarps];
#endif
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
#if PMBRL_WIDE
  if (warp == 0 && ro.mm_states) {  // the whole warp: safe_chol_warp
    safe_chol_warp(sh.s.S, D, sh.s.L);
    if (keeper && lane == 0) save_site(sh.s, D, stat);
  }
#else
  if (tid == 0 && ro.mm_states) {
    safe_chol(sh.s.S, D, sh.s.L);
    if (keeper) save_site(sh.s, D, stat);
  }
#endif
  if (tid == 32 && ro.r_mm) {
    safe_chol(sh.r.S, 1, sh.r.L);
    if (keeper) save_site(sh.r, 1, stat + kStat);
  }
  __syncthreads();
}

// The reward's cotangent of particle b at step t: rows 3-5's uniform c, the
// grid's per particle.
template <bool kGrid>
__device__ __forceinline__ float reward_cot(const Roll& ro, int t, int b, float c) {
  if (kGrid) return ro.w_t[t] * ro.g_disc[b] + ro.g_raw[b] + ro.vw_t[t] * ro.g_vret[b];
  return c;
}

// ---- grouped moments and their adjoint (kGrp) --------------------------------

// The groups that hold the cluster's particles, [g0, g0 + ng), and whether
// some group straddles two clusters (its rows are then read from the other
// cluster's copy in device memory, after a grid barrier).
struct GroupSpan {
  int Bg, W, g0, ng;
  bool straddle;
};

__device__ __forceinline__ GroupSpan group_span(const Ctx& c, const Step& st, const Roll& ro) {
  const int Bg = st.B / ro.G;
  return {Bg, group_lanes(Bg), c.p0 / Bg, (c.p0 + c.n - 1) / Bg - c.p0 / Bg + 1,
          c.lay.clusters > 1 && c.lay.P % Bg != 0};
}

// The forward's grouped resample of step t: each group that holds a row of
// the cluster, on W lanes of one warp (group_mm.cuh), its moments over all
// its rows (the cluster's from XN and RR, another cluster's from
// ro.nxt_raw / r_raw, which rank 0 of each cluster wrote during the walk),
// its factors (the cluster that holds its first row, rank 0, keeps them in
// ro.stats [T, G, 2, kStat]) and the cluster's rows of it resampled in
// place: XN the post-MM states, RR the post-MM rewards (or, mean-only, the
// group's mean reward). Every CTA computes the same bits.
__device__ void fwd_groups(const Ctx& c, const Step& st, const Roll& ro, RollSm& sh, int t) {
  const int D = st.D, B = st.B, n = c.n, p0 = c.p0, lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const GroupSpan gp = group_span(c, st, ro);
  const int W = gp.W, Bg = gp.Bg, per = 32 / W;
  const Rows rw = rows_of(c, D);
  if (gp.straddle) grid_sync(ro, sh, kLapFwdMM);
  const float* xg = ro.nxt_raw + (size_t)t * B * D;
  const float* rg = ro.r_raw + (size_t)t * B;
  const bool rs = ro.r_mm || ro.mean_only;
#if PMBRL_WIDE
  // one group a warp, on the first kMmWarps warps
  for (int base = warp; warp < kMmWarps && base < gp.ng; base += kMmWarps) {
#else
  for (int base = warp * per; base < gp.ng; base += nw * per) {  // uniform in the warp
#endif
    const int gi = base + lane / W;
    const bool on = gi < gp.ng;
    const int b0 = (gp.g0 + (on ? gi : 0)) * Bg;  // the group's first particle
    auto x = [&](int q, int k) {
      const int p = b0 + q - p0;
      return p >= 0 && p < n ? rw.XN[p * D + k] : __ldcg(xg + (size_t)(b0 + q) * D + k);
    };
    auto r = [&](int q) {
      const int p = b0 + q - p0;
      return p >= 0 && p < n ? rw.RR[p] : __ldcg(rg + b0 + q);
    };
#if PMBRL_WIDE
    GroupSite& g = sh.gsite[warp];
#else
    GroupSite g;
#endif
    group_moments(x, r, Bg, D, W, on, ro.mm_states, rs, g);
    if (!on) continue;
    group_factor(g, D, ro.mm_states, ro.r_mm);
    const int j = lane & (W - 1);
    if (c.rank == 0 && j == 0 && b0 >= p0)
      group_save(g, D, ro.mm_states, ro.r_mm, ro.stats + ((size_t)t * ro.G + b0 / Bg) * 2 * kStat);
    const int q1 = min(p0 + n - b0, Bg);
    for (int q = max(p0 - b0, 0) + j; q < q1; q += W) {
      const int p = b0 + q - p0;
      if (ro.mm_states) {
        float out[kMaxD];
        group_resample_row(g, D, rw.ZM + p * D, out);
        for (int k = 0; k < D; ++k) rw.XN[p * D + k] = out[k];
      }
      if (ro.mean_only) rw.RR[p] = g.rm;
      else if (ro.r_mm) rw.RR[p] = g.rm + rw.ZR[p] * g.rL;
    }
  }
  __syncthreads();
}

// The reverse sweep's grouped MM adjoint of step t: each group that holds a
// row of the cluster, on W lanes of one warp, its sums of the state
// cotangent GS and of GS z^T over all its rows (another cluster's rows from
// the exchange buffer [2][B][D] of scratch, which rank 0 of each cluster
// fills at each step, the step's parity choosing the half, before a grid
// barrier) and of the reward's cotangent c and c z_r, its sites from
// ro.stats, the coefficients (mm_vjp_coeffs with Bg) and the gradients wrt
// the cluster's pre-MM rows of it: XN = H (x - m) + c0 (GS without the
// state resample), RR likewise (c without the reward's).
template <bool kGrid>
__device__ void bwd_groups(const Ctx& c, const Step& st, const Roll& ro, RollSm& sh, int t,
                           float cu) {
  const int D = st.D, B = st.B, n = c.n, p0 = c.p0, lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const GroupSpan gp = group_span(c, st, ro);
  const int W = gp.W, Bg = gp.Bg, per = 32 / W;
  const Rows rw = rows_of(c, D);
  const float* xchg = ro.scratch + c.lay.s_gx + (size_t)(t & 1) * B * D;
  if (gp.straddle && ro.mm_states) {
    if (c.rank == 0)
      for (int e = threadIdx.x; e < n * D; e += blockDim.x)
        ro.scratch[c.lay.s_gx + (size_t)(t & 1) * B * D + (size_t)p0 * D + e] = rw.GS[e];
    grid_sync(ro, sh, kLapBwdMM);
  }
  const float* zg = st.z_mm + (size_t)t * B * D;
  const float* zrg = st.z_rr + (size_t)t * B;
#if PMBRL_WIDE
  for (int base = warp; warp < kMmWarps && base < gp.ng; base += kMmWarps) {
#else
  for (int base = warp * per; base < gp.ng; base += nw * per) {  // uniform in the warp
#endif
    const int gi = base + lane / W;
    const bool on = gi < gp.ng;
    const int b0 = (gp.g0 + (on ? gi : 0)) * Bg;
    auto own = [&](int q) { return b0 + q - p0 >= 0 && b0 + q - p0 < n; };
    auto gs = [&](int q, int k) {
      return own(q) ? rw.GS[(b0 + q - p0) * D + k] : __ldcg(xchg + (size_t)(b0 + q) * D + k);
    };
    auto zs = [&](int q, int k) {
      return own(q) ? rw.ZM[(b0 + q - p0) * D + k] : zg[(size_t)(b0 + q) * D + k];
    };
    auto gr = [&](int q) { return reward_cot<kGrid>(ro, t, b0 + q, cu); };
    auto zr = [&](int q) { return own(q) ? rw.ZR[b0 + q - p0] : zrg[b0 + q]; };
#if PMBRL_WIDE
    GroupSite& g = sh.gsite[warp];
    GroupAdjoint& a = sh.gadj[warp];
#else
    GroupSite g;
    GroupAdjoint a;
#endif
    if (on) group_load(ro.stats + ((size_t)t * ro.G + b0 / Bg) * 2 * kStat, D, g);
    group_adjoint(gs, zs, gr, zr, Bg, D, W, on, ro.mm_states, ro.r_mm, g, a);
    if (!on) continue;
    const int j = lane & (W - 1), q1 = min(p0 + n - b0, Bg);
    for (int q = max(p0 - b0, 0) + j; q < q1; q += W) {
      const int p = b0 + q - p0;
      if (ro.mm_states) {
        float out[kMaxD];
        group_vjp_row(a, g, D, rw.XR + p * D, out);
        for (int k = 0; k < D; ++k) rw.XN[p * D + k] = out[k];
      } else {
        for (int k = 0; k < D; ++k) rw.XN[p * D + k] = rw.GS[p * D + k];
      }
      rw.RR[p] = ro.r_mm ? a.rH * (rw.RW[p] - g.rm) + a.rc0 : reward_cot<kGrid>(ro, t, p0 + p, cu);
    }
  }
  __syncthreads();
}

// ---- the sweeps ---------------------------------------------------------------

// Rows 3-5: loss and mean_return, each cluster's sums of disc and raw, then
// the clusters' in order.
__device__ void loss_sums(const Ctx& c, const Step& st, const Roll& ro, RollSm& sh) {
  const int B = st.B, tid = threadIdx.x, n = c.n;
  const Rows rw = rows_of(c, st.D);
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


template <bool kGrid, bool kCritic, bool kReluOnly, bool kGroups>
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
    if (kGroups) {  // XN and RR resampled in place
      prefetch_wait();
      if (ro.mm_states || ro.r_mm || ro.mean_only) fwd_groups(c, st, ro, sh, t);
    } else {
      if (ro.mm_states || ro.r_mm || ro.mean_only) fwd_moments(c, st, ro, sh, t);
      prefetch_wait();
    }
    float* s_n = ro.s_all + (size_t)(t + 1) * B * D;
    for (int e = tid; e < n * D; e += nt) {
      const int p = e / D, k = e - p * D;
      float v = rw.XN[e];
      if (!kGroups && ro.mm_states) {
        float acc = 0.f;
        for (int j = 0; j <= k; ++j) acc += rw.ZM[p * D + j] * sh.s.L[k * D + j];
        v = sh.s.m[k] + acc;
      }
      rw.S[e] = v;
      if (c.rank == 0) s_n[(size_t)p0 * D + e] = v;
      if (kCritic && t + 1 == ro.H) rw.GS[e] = v;  // s_H, for the refit
    }
    constexpr bool vr = kGrid || kCritic;
    const float w = ro.w_t[t], vw = vr ? ro.vw_t[t] : 0.f;
    for (int p = tid; p < n; p += nt) {
      float r = rw.RR[p];  // grouped: resampled in place
      if (!kGroups && ro.mean_only) r = sh.rmean;
      else if (!kGroups && ro.r_mm) r = sh.r.m[0] + rw.ZR[p] * sh.r.L[0];
      rw.disc[p] = rw.disc[p] + w * r;
      rw.raw[p] = rw.raw[p] + r;
      if (vr) rw.vret[p] = rw.vret[p] + vw * r;
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
  // with a critic the loss's sums come after the refit and the bootstrap
  if (!kCritic) loss_sums(c, st, ro, sh);
}

template <bool kGrid, bool kCritic, bool kReluOnly, bool kGroups>
__device__ void reverse_sweep(Ctx& c, const Step& st, const Roll& ro, RollSm& sh, float* dwacc) {
  const int B = st.B, D = st.D, tid = threadIdx.x, nt = blockDim.x;
  const int TR = c.lay.TR, n = c.n, p0 = c.p0;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int nT = D * (D + 1) / 2;
  const Rows rw = rows_of(c, D);
  const float g_loss = kGrid ? 0.f : (ro.g_loss ? *ro.g_loss : 1.f);
  const float g_mret = kGrid ? 0.f : (ro.g_mret ? *ro.g_mret : 0.f);
  if (!kCritic)  // else GS holds the bootstrap's cotangent of s_T
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
    if (!kGroups) prefetch(sh.stat, ro.stats + (size_t)t * 2 * kStat, 2 * kStat);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (kGrid) {  // the cotangent of states_all[t] joins the state cotangent
      const float* gs = ro.g_sall + (size_t)t * B * D + (size_t)p0 * D;
      for (int e = tid; e < n * D; e += nt) rw.GS[e] += gs[e];
      __syncthreads();
    }
    const float cu = (ro.sign * g_loss * ro.w_t[t] + g_mret) / B;
    prefetch_wait();
    if (kGroups) {
      bwd_groups<kGrid>(c, st, ro, sh, t, cu);
      lap(ro, sh, kLapBwdMM);
      const float* s_t = ro.s_all + (size_t)t * B * D;
      for (int lp = 0; lp < n; lp += TR)
        step_bwd<kReluOnly>(c, st, ro, sh, t, s_t + (size_t)(p0 + lp) * D, p0 + lp,
                            min(TR, n - lp), lp, dwacc);
      continue;
    }
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
#if PMBRL_WIDE
    if (warp == 0 && ro.mm_states) {  // the whole warp: mm_vjp_coeffs_warp
      for (int e = lane; e < D * D; e += 32) {
        const int i = e / D, j = e - i * D;
        sh.s.L[e] = sh.stat[2 * kMaxD + e];
        sh.s.gL[e] = j <= i ? sh.tot[kBGl + i * (i + 1) / 2 + j] : 0.f;
      }
      for (int i = lane; i < D; i += 32) {
        sh.s.m[i] = sh.stat[i];
        sh.s.sd[i] = sh.stat[kMaxD + i];
        sh.s.gm[i] = sh.tot[kBGm + i];
      }
      __syncwarp();
      mm_vjp_coeffs_warp(sh.s.L, sh.s.gm, sh.s.gL, sh.s.sd, B, D, sh.s.H, sh.s.c0);
    }
#else
    if (tid == 0 && ro.mm_states) {
      load_site(sh.stat, D, sh.s);
      for (int i = 0, e = 0; i < D; ++i) {
        sh.s.gm[i] = sh.tot[kBGm + i];
        for (int j = 0; j < D; ++j) sh.s.gL[i * D + j] = j <= i ? sh.tot[kBGl + e++] : 0.f;
      }
      mm_vjp_coeffs(sh.s.L, true, sh.s.gm, sh.s.gL, sh.s.sd, B, D, sh.s.H, sh.s.c0);
    }
#endif
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

// ---- the critic refit and the bootstrap (rows 3-5 with RollArgs::critic) ----

// A barrier across the launch for the critic's global writes: the grid's,
// or with one cluster the cluster's.
__device__ void critic_sync(const Ctx& c, const Roll& ro, RollSm& sh) {
  if (c.lay.clusters > 1) {
    grid_sync(ro, sh, kLapCritic);
    return;
  }
  __threadfence();
  cluster_sync();
}

// The TD(H) refit on the cluster's rows (s_0 = x0, s_H kept in GS by the
// forward sweep, vret): per tile VH = V(target, s_H) (the target's masks),
// then V0 = V(params, s_0) (params' masks), each row's loss and its
// cotangent (MSE: (V0 - t)^2, 2 (V0 - t) / B; NLL: 0.5 q^2 + ls + log(2
// pi) / 2 with q = (mean - t) e^-ls, q e^-ls / B and (1 - q^2) / B) and V0's
// backward into this CTA's dW accumulator; the cluster's loss to scratch;
// one barrier; v_loss = the rows' mean + reg_weight times the regulariser
// (CTA 0), the Adam step and the polyak target over every thread; one more
// barrier, after which params' is whole for the bootstrap. Spectral norm adds
// a barrier before the step (<G, w> over the launch, critic_sn_dots) and one
// after it (params' normalized weights, critic_sn_refresh).
template <bool kReluOnly>
__device__ void critic_refit(Ctx& c, const Step& st, const Roll& ro, RollSm& sh, const Crit& cr,
                             Net& cn) {
  const CriticArgs& a = cr.a;
  const int D = st.D, B = st.B, tid = threadIdx.x, nt = blockDim.x;
  const int TR = c.lay.TR, TRP = c.lay.TRP, n = c.n, p0 = c.p0;
  const Rows rw = rows_of(c, D);
  float* acc = ro.scratch + c.lay.s_cdw + (size_t)blockIdx.x * c.lay.cdw_cta;
  for (int e = tid; e < c.lay.cdw_cta; e += nt) acc[e] = 0.f;
  if (tid == 0) sh.closs = 0.f;
  __syncthreads();
  float* ts = c.sm + c.lay.tsm;
  const float* out = ts + kTDout * TRP;
  float* tgt = ts + kTNxt * TRP;  // the tile's TD targets
  float* lrow = ts + kTR * TRP;   // its rows' losses
  const bool gauss = a.head == kHeadGauss;
  for (int lp = 0; lp < n; lp += TR) {
    const int nrows = min(TR, n - lp);
    critic_fwd<kReluOnly>(c, cr, cn, kSetT, rw.GS + lp * D, p0 + lp, nrows, false, nullptr);
    for (int r = tid; r < TR; r += nt) {
      float t = 0.f;
      if (r < nrows) {
        float m, ls;
        critic_head(a, out, TRP, r, m, ls);
        t = rw.vret[lp + r] + a.v_wH * critic_sample(a, m, ls, gauss ? a.z[p0 + lp + r] : 0.f);
      }
      tgt[r] = t;
    }
    __syncthreads();
    critic_fwd<kReluOnly>(c, cr, cn, kSetP, st.states + (size_t)(p0 + lp) * D, p0 + lp, nrows,
                          true, nullptr);
    float* X = c.region(c.pass + 1);  // the gradient wrt the output, where mlp_bwd reads it
    for (int r = tid; r < TR; r += nt) {
      float l = 0.f, g0 = 0.f, g1 = 0.f;
      if (r < nrows) {
        float m, ls;
        critic_head(a, out, TRP, r, m, ls);
        if (gauss) {
          const float e = expf(-ls), q = (m - tgt[r]) * e;
          l = 0.5f * (q * q) + ls + kHalfLog2Pi;
          g0 = ((q * e) / B) * a.sy[0];
          g1 = ((1.f - q * q) / B) * sigmoid_f(a.upper - out[TRP + r]);
        } else {
          const float d = m - tgt[r];
          l = d * d;
          g0 = ((2.f * d) / B) * a.sy[0];
        }
      }
      lrow[r] = l;
      X[r] = g0;
      if (gauss) X[TRP + r] = g1;
    }
    __syncthreads();
    if (a.opts && a.opts->out_act != kIdentity) {
      critic_out_act(c, cr, nrows, true, X);
      __syncthreads();
    }
    mlp_bwd<kReluOnly>(c, cn, kCriticNet, p0 + lp, nrows, c.lay.xp, acc);
    if (tid < 32) {
      float v = 0.f;
      for (int r = tid; r < nrows; r += 32) v += lrow[r];
      v = warp_sum(v);
      if (tid == 0) sh.closs += v;
    }
    __syncthreads();
  }
  lap(ro, sh, kLapCritic);
  if (c.rank == 0 && tid == 0) ro.scratch[c.lay.s_closs + c.cid] = sh.closs;
  if (blockIdx.x == 0) {
    const float reg = critic_reg(cr, sh.red);
    if (tid == 0) sh.creg = reg;
  }
  critic_sync(c, ro, sh);
  if (blockIdx.x == 0 && tid == 0) {
    float v = 0.f;
    for (int cc = 0; cc < c.lay.clusters; ++cc) v += ro.scratch[c.lay.s_closs + cc];
    *a.v_loss = v / B + sh.creg;
  }
  if (a.sn) {  // spectral norm: <G, w> over the launch before the step
    critic_sn_dots(c, cr, ro.scratch + c.lay.s_cdw, sh.red);
    critic_sync(c, ro, sh);
  }
  critic_adam(c, cr, ro.scratch + c.lay.s_cdw);
  critic_sync(c, ro, sh);
  if (a.sn) {  // params' normalized weights, for the bootstrap
    if (blockIdx.x == 0) critic_sn_refresh(c, cr, sh.red);
    critic_sync(c, ro, sh);
  }
}

// The bootstrap w_H V(s_T) of the cluster's rows under params' (fwd: rows
// 3 and 5, after the refit; s_T the forward's) or under the given params
// (row 4; s_T from s_all[T]), with the masks of that logit_p: with fwd disc
// += w_H V, with bwd the state cotangent GS = sign g_loss w_H / B times V's
// input gradient (times isx), where the reverse sweep starts.
template <bool kReluOnly>
__device__ void critic_bootstrap(Ctx& c, const Step& st, const Roll& ro, const Crit& cr, Net& cn,
                                 bool fwd, bool bwd) {
  const CriticArgs& a = cr.a;
  const int D = st.D, B = st.B, tid = threadIdx.x, nt = blockDim.x;
  const int TR = c.lay.TR, TRP = c.lay.TRP, n = c.n, p0 = c.p0;
  const Rows rw = rows_of(c, D);
  const int set = fwd ? kSetQ : kSetP;
  const float* s_T = fwd ? rw.S : ro.s_all + ((size_t)ro.T * B + p0) * D;
  const float gv = bwd ? ro.sign * (ro.g_loss ? *ro.g_loss : 1.f) * a.w_H / B : 0.f;
  const float* out = c.sm + c.lay.tsm + kTDout * TRP;
  const bool gauss = a.head == kHeadGauss;
  for (int lp = 0; lp < n; lp += TR) {
    const int nrows = min(TR, n - lp);
    critic_fwd<kReluOnly>(c, cr, cn, set, s_T + lp * D, p0 + lp, nrows, bwd, a.masks);
    float* X = c.region(c.pass + 1);
    for (int r = tid; r < TR; r += nt) {
      const bool in = r < nrows;
      float m, ls;
      critic_head(a, out, TRP, r, m, ls);
      const float z = gauss && in ? a.z[p0 + lp + r] : 0.f;
      if (fwd && in) rw.disc[lp + r] = rw.disc[lp + r] + a.w_H * critic_sample(a, m, ls, z);
      if (bwd) {
        X[r] = in ? gv * a.sy[0] : 0.f;
        if (gauss)
          X[TRP + r] = in ? ((gv * z) * expf(ls)) * sigmoid_f(a.upper - out[TRP + r]) : 0.f;
      }
    }
    __syncthreads();
    if (!bwd) continue;
    if (a.opts && a.opts->out_act != kIdentity) {
      critic_out_act(c, cr, nrows, true, X);
      __syncthreads();
    }
    const float* gx = mlp_bwd<kReluOnly>(c, cn, kCriticNet, p0 + lp, nrows, c.lay.xp, nullptr);
    if (a.opts) {  // through the input mask and the angles' embedding
      critic_option_grad(c, cr, gx, s_T + lp * D, rw.GS + lp * D, nrows);
    } else {
      for (int e = tid; e < nrows * D; e += nt) {
        const int r = e / D, k = e - r * D;
        rw.GS[(lp + r) * D + k] = gx[k * TRP + r] * a.isx[k];
      }
    }
    __syncthreads();
  }
}

template <bool kGrid, int kPhases, bool kReluOnly, bool kCritic>
__device__ void run(Ctx& c, const Step& st, const Roll& ro, RollSm& sh, const Crit& cr, Net& cn) {
  constexpr bool kGroups = (kPhases & kGrp) != 0;
  float* dwacc = c.lay.resident ? c.sm + c.lay.dwa
                      : ro.scratch + c.lay.s_dwcta + (size_t)blockIdx.x * c.lay.dw_cta;
  stage(c, st, (kPhases & kBwd) ? dwacc : nullptr);
  lap(ro, sh, kLapStage);
  if (kPhases & kFwd) forward_sweep<kGrid, kCritic, kReluOnly, kGroups>(c, st, ro, sh);
  if constexpr (kCritic) {
    if (kPhases & kFwd) {
      critic_refit<kReluOnly>(c, st, ro, sh, cr, cn);
      critic_bootstrap<kReluOnly>(c, st, ro, cr, cn, true, (kPhases & kBwd) != 0);
      lap(ro, sh, kLapCritic);
      loss_sums(c, st, ro, sh);
    } else {
      critic_bootstrap<kReluOnly>(c, st, ro, cr, cn, false, true);
      lap(ro, sh, kLapCritic);
    }
  }
  if (kPhases & kBwd) {
    reverse_sweep<kGrid, kCritic, kReluOnly, kGroups>(c, st, ro, sh, dwacc);
    finish_dw(c, st, ro, sh, dwacc);
    lap(ro, sh, kLapSums);
  }
}

// The forward's last barrier (the loss's, with several clusters; with one,
// the cluster barriers of every layer) orders cluster 0's stats before the
// backward of a value-and-grad launch reads them.
template <bool kGrid, int kPhases, bool kReluOnly, bool kCritic>
__global__ void __launch_bounds__(kMaxThreads, 1)
rollout_kernel(const __grid_constant__ Step st, const __grid_constant__ Roll ro,
               const __grid_constant__ Lay lay, const __grid_constant__ Crit cr) {
  extern __shared__ __align__(16) float smem[];
  __shared__ RollSm sh;
  // the step's and the layout's fields, indexed by layer all through the
  // walks, read from shared memory rather than the parameter space
  __shared__ Step st_s;
  __shared__ Lay lay_s;
  __shared__ Net cnet_s;  // the critic's, for its walks (critic_net)
  static_assert(sizeof(RollSm) + sizeof(Step) + sizeof(Lay) + sizeof(Net) <= kStaticSmem - 512,
                "static smem");
  static_assert(sizeof(Step) + sizeof(Roll) + sizeof(Lay) + sizeof(Crit) <= 4096,
                "kernel parameters");
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
  if (kCritic && threadIdx.x == 0) critic_net(cr, st.B, cnet_s);
  __syncthreads();
  run<kGrid, kPhases, kReluOnly, kCritic>(c, st_s, ro, sh, cr, cnet_s);
}

}  // namespace

// ---- host side ----------------------------------------------------------------

namespace {

// The layout of a launch from the plan (the formulas of rollout_plan in
// fused_rollout.py); false when the plan does not fit these models (and the
// critic's params, where there is one) and G MM groups.
bool lay_of(const Step& st, int T, const int* plan, Lay& L, const Net* critic, int G) {
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
  long long off = walk_lay(st, TR, plan[kPlanResident], true, L, critic);
  L.pp = static_cast<int>(off);
  off += round4(P * (5 * D + 6));
  L.parts = static_cast<int>(off);
  off += (long long)clusters * kPart;
  if (4 * off != plan[kPlanSmem] || 4 * off > kSmemMax) return false;
  // scratch: the clusters' partials (several clusters), the CTAs' dW
  // accumulators (streamed plans); with a critic the CTAs' critic dW
  // accumulators and the clusters' sums of its loss; grouped with several
  // clusters the exchange of the state cotangent, [2][B][D]
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
  L.cdw_cta = critic ? critic_dw_lay(*critic, L) : 0;
  L.s_cdw = static_cast<int>(sc);
  sc += (long long)clusters * kCluster * L.cdw_cta;
  L.s_closs = static_cast<int>(sc);
  sc += critic ? clusters : 0;
  L.s_gx = static_cast<int>(sc);
  sc += multi && G > 1 ? 2LL * st.B * D : 0;
  L.scratch = static_cast<int>(sc);
  return sc == plan[kPlanScratch] && sc < (1LL << 31);
}

// The instance of rows 3-5's entry point kPhases (with kGrp: grouped) with a
// critic, for MLPs whose hidden activations are all relu or not: each
// kPhases instantiated in a translation unit of its own
// (fused_rollout_critic_{fwd,bwd,vg}.cu, grouped
// fused_rollout_critic_grouped_{fwd,bwd,vg}.cu).
template <int kPhases>
const void* critic_instance(int relu) {
  return relu ? reinterpret_cast<const void*>(rollout_kernel<false, kPhases, true, true>)
              : reinterpret_cast<const void*>(rollout_kernel<false, kPhases, false, true>);
}

}  // namespace
