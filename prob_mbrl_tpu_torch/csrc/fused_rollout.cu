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
// -> nxt, tip reward), then s_{t+1} = resample(nxt) (or nxt), r =
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
// - CTA r owns rows [r kw, r kw + kw) of every W_l, kw = ceil(d_l / 8), of
//   both MLPs, and all of W_0 (at most kMaxIn rows). With a resident plan it
//   stages them into shared memory once per launch (16-byte cp.async where
//   the block is 16-byte aligned and whole rows), so no step reads a weight
//   from L2 again; a plan whose weights do not fit (hidden widths of 512)
//   reads them from L2 in place. Biases are staged once per launch; each
//   step stages its tile's mask slices and noise by cp.async, one wait.
// - Layer 0 needs no exchange: every CTA holds the whole (small) input and
//   forms its own output columns, and in the backward the whole gradient
//   wrt the input from the gathered g_a.
// - Forward layer: each CTA forms the partial product of its weight rows
//   for every output column (4 rows x 4 columns a thread) and sends each
//   column's partial through distributed shared memory to the CTA that owns
//   the column; after one cluster barrier the owner sums the sources in
//   rank order, adds the bias, keeps the pre-activation and applies
//   activation and mask: its columns are its rows of the next layer. The
//   output layer's partials go to every CTA, which sums them in rank order.
//   Exchange buffers alternate between two regions, one barrier a layer.
// - Backward layer: every CTA holds the whole g_a, forms g_h for its rows
//   (each dot product split over lanes, a fixed butterfly), applies mask
//   and activation VJP and all-gathers the result, one barrier a layer.
//   For the policy it adds h[:, rows]^T g_a of the tile to a dW accumulator
//   for its rows (and its columns' db) at every step, in a fixed order:
//   in shared memory with a resident plan, in its own scratch otherwise.
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

#include <cooperative_groups.h>

#include <cstdint>

#include "rollout_step.cuh"

namespace cg = cooperative_groups;

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

constexpr int kCluster = 8;       // CTAs per cluster (the portable maximum)
constexpr int RB = 4;             // rows of a row group: one float4 of a feature-major tile
constexpr int kMaxThreads = 512;  // 128 registers a thread
constexpr int kMaxTileRows = 128;
constexpr int kMaxTiles = 8;      // row tiles a cluster walks, at most
constexpr int kSmemMax = 232448 - 8192;  // dynamic shared memory (the static part is below 8192)
constexpr int kStat = 2 * kMaxD + kMaxD * kMaxD;  // m, sd, L of one resample site
constexpr int kMaxIn = kMaxD + kMaxU;             // widest MLP input (the dynamics')
constexpr int kTri = kMaxD * (kMaxD + 1) / 2;
// a cluster's forward partial: n, mean, centred M2 (lower, row-major), centred
// sums; then the reward's mean, M2, centred sum and plain sum
constexpr int kFN = 0, kFMean = 1, kFM2 = kFMean + kMaxD, kFSd = kFM2 + kTri,
              kFR = kFSd + kMaxD, kPartF = 64;
// a cluster's backward partial: sum g, sum g z^T (lower); the reward's two
constexpr int kBGm = 0, kBGl = kMaxD, kBR = kBGl + kTri, kPartB = 48;
constexpr int kPart = kPartF > kPartB ? kPartF : kPartB;
// the tile's small per-row quantities, [feature][TRP] each
constexpr int kTPout = 0, kTDout = kTPout + 2 * kMaxU, kTU = kTDout + 2 * kMaxD,
              kTAct = kTU + kMaxU, kTNxt = kTAct + kMaxU, kTR = kTNxt + kMaxD,
              kTGnxt = kTR + 1, kTGact = kTGnxt + kMaxD, kTGs = kTGact + kMaxU,
              kTZp = kTGs + kMaxD, kTEps = kTZp + kMaxU, kTZd = kTEps + kMaxU, kTSmall = 80;
constexpr int kFwd = 1, kBwd = 2;
// parts of RollArgs::split
constexpr int kLapStage = 0, kLapFwdWalk = 1, kLapFwdMM = 2, kLapGrid = 3, kLapBwdMM = 4,
              kLapRecompute = 5, kLapVjp = 6, kLapSums = 7, kSplitParts = 8;

static_assert(kFR + 4 <= kPartF && kBR + 2 <= kPartB, "partials");
static_assert(kTZd + kMaxD <= kTSmall, "tile arrays");
static_assert(kLapSums + 1 == kSplitParts, "the parts of RollArgs::split");

__host__ __device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ __forceinline__ int round4(int a) { return (a + 3) & ~3; }

struct Slice {
  int c0, cnt, sw;  // first index, how many this CTA owns, slice width
};

__host__ __device__ __forceinline__ Slice slice_of(int width, int rank) {
  const int sw = ceil_div(width, kCluster);
  const int c0 = rank * sw;
  const int cnt = width - c0 < sw ? width - c0 : sw;
  return {c0, cnt > 0 ? cnt : 0, sw};
}

// Shared-memory layout and tiling of one launch (offsets in floats, each a
// multiple of 4), from the plan (lay_of).
struct Lay {
  int clusters, P, TR, TRP, resident;
  int w_off[2][kMaxLayers];  // resident weight slices [kw4][d4] of each net's layers
  int dwa;                   // the dW accumulator (resident plans)
  int dw_off[kMaxLayers];    // the policy's dW accumulator [kw4][d4] + db [d4], from dwa
  int dw_cta;                // floats of one CTA's dW accumulator
  int region[2], rfl;        // the two exchange regions and their floats
  int h, xp, xd, gx, tsm, pp, parts;  // h: a layer's input slice (backward: the dW's)
  int asm_off[2][kMaxLayers];  // kept hidden pre-activation slices [kw4][TRP]
  int msk_off[2][kMaxLayers];  // the tile's mask slices of the hidden layers [kw4][TRP]
  int bias_off[2][kMaxLayers];  // every layer's bias [d4] (zero without one)
  // scratch (floats)
  int s_fwd, s_bwd, s_loss, s_dw, s_dwcta, scratch;
  int dw_flat[kMaxLayers + 1];  // offsets of each policy layer's dW + db in a flat partial
};

struct Roll {
  int T, mm_states, r_mm, mean_only;
  float sign;
  const float *w_t, *g_loss, *g_mret, *vw_t, *g_disc, *g_raw, *g_vret, *g_sall;
  float *s_all, *nxt_raw, *r_raw, *stats, *loss, *mret, *g_eps, *disc, *raw, *vret, *scratch;
  unsigned long long* split;
  float* dw[kMaxLayers];
  float* db[kMaxLayers];
};

// one resample site's moments, factor and adjoint coefficients
struct Site {
  float m[kMaxD], S[kMaxD * kMaxD], L[kMaxD * kMaxD], sd[kMaxD];
  float H[kMaxD * kMaxD], c0[kMaxD], gm[kMaxD], gL[kMaxD * kMaxD];
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

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

// What every part of the kernel needs: the layout, this CTA's place, and
// the count of exchange passes so far (the same in every CTA of a cluster:
// pass p writes region p & 1 of the other CTAs and reads it after its
// barrier, so a region is rewritten only after the barrier that follows
// its last read).
struct Ctx {
  float* sm;
  const Lay& lay;
  int rank, cid, p0, n;  // n: the cluster's particles, from p0
  int pass;
  __device__ float* region(int p) const { return sm + lay.region[p & 1]; }
};

// p in the shared memory of CTA `rank` of this cluster
__device__ __forceinline__ float* remote(float* p, int rank) {
  return cg::this_cluster().map_shared_rank(p, rank);
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

__device__ void save_site(const Site& x, int D, float* dst) {
  for (int i = 0; i < D; ++i) {
    dst[i] = x.m[i];
    dst[kMaxD + i] = x.sd[i];
  }
  for (int i = 0; i < D * D; ++i) dst[2 * kMaxD + i] = x.L[i];
}

__device__ void load_site(const float* src, int D, Site& x) {
  for (int i = 0; i < D; ++i) {
    x.m[i] = src[i];
    x.sd[i] = src[kMaxD + i];
  }
  for (int i = 0; i < D * D; ++i) x.L[i] = src[2 * kMaxD + i];
}

// row i >= j of the e-th entry of a lower triangle, row-major
__device__ __forceinline__ void tri_of(int e, int& i, int& j) {
  i = 0;
  while (e > i) e -= ++i;
  j = e;
}

// Sum over the lanes of a warp in a fixed order; every lane gets it.
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace

namespace {

// ---- the MLP walks of one row tile, split over the cluster -----------------

// Weight rows of layer l of `net` (0 policy, 1 dynamics) that this CTA owns:
// the staged block [kw4][d4] (zero past the block), or the caller's W in
// place ([din][dout], rows from ks.c0).
__device__ __forceinline__ const float* wrows(const Ctx& c, const Net& net, int netid, int l,
                                              const Slice& ks) {
  if (c.lay.resident) return c.sm + c.lay.w_off[netid][l];
  return net.w[l] + (size_t)ks.c0 * net.dims[l + 1];
}

// w[k][j .. j + 3], zero past dout (ld: the row stride).
__device__ __forceinline__ float4 w_quad(bool res, const float* w, int ld, int k, int j,
                                         int dout) {
  if (res) return ld4(w + k * ld + j);
  const float* p = w + (size_t)k * dout + j;
  return make_float4(p[0], j + 1 < dout ? p[1] : 0.f, j + 2 < dout ? p[2] : 0.f,
                     j + 3 < dout ? p[3] : 0.f);
}

// w[k][j], zero at rows k >= cnt (the staged block is zero there).
__device__ __forceinline__ float w_at(bool res, const float* w, int ld, int k, int j, int cnt) {
  if (res) return w[k * ld + j];
  return k < cnt ? w[(size_t)k * ld + j] : 0.f;
}

// The activation and its VJP (mlp_tile.cuh) with the activation fixed at
// compile time (A >= 0: the relu-only instances), or chosen at run time
// from k (A < 0).
template <int A>
__device__ __forceinline__ float actf(int k, float x) {
  return act_fwd(A < 0 ? k : A, x);
}

template <int A>
__device__ __forceinline__ float actg(int k, float x, float g) {
  return act_vjp(A < 0 ? k : A, x, g);
}

// The owner's epilogue of one hidden-layer item (column jj of this CTA's
// slice, row group g): bias, the pre-activation (kept with keep),
// activation and mask; the result is this CTA's slice of the next layer's
// input, h[jj][rows].
template <int A>
__device__ __forceinline__ void owner_out(Ctx& c, const Net& net, int netid, int l, int jj,
                                          int g, float4 a, float bias, float4 mk, bool keep,
                                          int nrows, float* h) {
  const int TRP = c.lay.TRP, left = nrows - g * RB;
  const bool masked = net.m[l] != nullptr;
  float av[RB] = {a.x + bias, a.y + bias, a.z + bias, a.w + bias};
  const float mv[RB] = {mk.x, mk.y, mk.z, mk.w};
  float hv[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (r >= left) av[r] = 0.f;
    hv[r] = r < left ? actf<A>(net.act[l], av[r]) * (masked ? mv[r] : 1.f) : 0.f;
  }
  if (keep)
    st4(c.sm + c.lay.asm_off[netid][l] + jj * TRP + g * RB, make_float4(av[0], av[1], av[2], av[3]));
  st4(h + jj * TRP + g * RB, make_float4(hv[0], hv[1], hv[2], hv[3]));
}

// Bias and mask of an owner item (column cs.c0 + jj, rows of group g), from
// the staged biases and the tile's staged mask slice (rows past nrows are
// stale and never used).
__device__ __forceinline__ void owner_loads(const Ctx& c, const Net& net, int netid, int l,
                                            const Slice& cs, int jj, int g, float& bias,
                                            float4& mk) {
  bias = c.sm[c.lay.bias_off[netid][l] + cs.c0 + jj];
  mk = net.m[l] ? ld4(c.sm + c.lay.msk_off[netid][l] + jj * c.lay.TRP + g * RB)
                : make_float4(1.f, 1.f, 1.f, 1.f);
}

// Forward walk of one MLP over a tile of TR rows (row0: the first particle,
// nrows of them real). x_off: the whole input, feature-major ([din][TRP],
// zeros past nrows), in every CTA. Layer 0 (at most kMaxIn inputs) needs no
// exchange: each CTA forms its own output columns from the whole input and
// the whole W_0. Each later layer: partial products over this CTA's weight
// rows, sent to the column owners (the output layer's to every CTA), one
// cluster barrier, then the owners' epilogue. Each hidden pre-activation
// slice goes to asm_off[netid][l] (with keep); the output, all of it, to
// out_off [dout][TRP] in every CTA, zero past nrows. Ends with
// __syncthreads().
template <bool kReluOnly>
__device__ void mlp_fwd(Ctx& c, const Net& net, int netid, int x_off, bool keep, int out_off,
                        int row0, int nrows) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int TR = c.lay.TR, TRP = c.lay.TRP, G = TR / RB;
  const bool res = c.lay.resident;
  float* h = c.sm + c.lay.h;
  float* out = c.sm + out_off;
  for (int l = 0; l <= net.n; ++l) {
    const int din = net.dims[l], dout = net.dims[l + 1];
    const bool last = l == net.n;
    const Slice ks = slice_of(din, c.rank), cs = slice_of(dout, c.rank);
    const int ne = last ? dout * G : cs.cnt * G;
    if (l == 0) {
      const float* x = c.sm + x_off;
      const float* w0 = res ? c.sm + c.lay.w_off[netid][0] : net.w[0];
      const int ld0 = res ? round4(dout) : dout;
      for (int i = tid; i < ne; i += nt) {
        const int jj = i % cs.cnt, g = i / cs.cnt, col = cs.c0 + jj;
        float bias;
        float4 mk;
        owner_loads(c, net, netid, 0, cs, jj, g, bias, mk);
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int k = 0; k < din; ++k) {
          const float4 xv = ld4(x + k * TRP + g * RB);
          const float wv = w0[k * ld0 + col];
          a.x = fmaf(xv.x, wv, a.x);
          a.y = fmaf(xv.y, wv, a.y);
          a.z = fmaf(xv.z, wv, a.z);
          a.w = fmaf(xv.w, wv, a.w);
        }
        owner_out<kReluOnly ? kRelu : -1>(c, net, netid, 0, jj, g, a, bias, mk, keep, nrows, h);
      }
      __syncthreads();
      continue;
    }
    const int ld = res ? round4(dout) : dout;
    const float* w = wrows(c, net, netid, l, ks);
    float* reg = c.region(c.pass);
    // partial products: item (row group g, column quad q), 4 x 4 a thread
    const int J4 = ceil_div(dout, 4);
    const int np = ks.cnt ? G * J4 : 0;
    for (int i = tid; i < np; i += nt) {
      const int g = i / J4, j0 = (i - g * J4) * 4;
      float4 acc[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      const float* hk = h + g * RB;
#pragma unroll 4
      for (int k = 0; k < ks.cnt; ++k, hk += TRP) {
        const float4 hv = ld4(hk);
        const float4 wv = w_quad(res, w, ld, k, j0, dout);
        const float wq[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[q].x = fmaf(hv.x, wq[q], acc[q].x);
          acc[q].y = fmaf(hv.y, wq[q], acc[q].y);
          acc[q].z = fmaf(hv.z, wq[q], acc[q].z);
          acc[q].w = fmaf(hv.w, wq[q], acc[q].w);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + q;
        if (j >= dout) break;
        if (last) {  // this CTA's block of [source rank][column][rows], sent below
          st4(reg + (c.rank * dout + j) * TRP + g * RB, acc[q]);
        } else {
          const int owner = j / cs.sw;
          st4(remote(reg, owner) + (c.rank * cs.sw + j - owner * cs.sw) * TRP + g * RB, acc[q]);
        }
      }
    }
    if (last && ks.cnt) {
      // the output layer's partials go to every CTA: all threads send
      __syncthreads();
      const int base = c.rank * dout * TRP;
      for (int e = tid; e < dout * G * (kCluster - 1); e += nt) {
        const int dst = (c.rank + 1 + e % (kCluster - 1)) % kCluster, i = e / (kCluster - 1);
        const int off = base + (i / G) * TRP + (i % G) * RB;
        st4(remote(reg, dst) + off, ld4(reg + off));
      }
    }
    cluster_sync();
    ++c.pass;
    const int sources = ceil_div(din, ks.sw);
    for (int i = tid; i < ne; i += nt) {
      if (last) {
        const int j = i % dout, g = i / dout;
        const float* src = reg + j * TRP + g * RB;
        float4 a = ld4(src);
        for (int s = 1; s < sources; ++s) a = add4(a, ld4(src + s * dout * TRP));
        const float bj = c.sm[c.lay.bias_off[netid][l] + j];
        const int left = nrows - g * RB;
        st4(out + j * TRP + g * RB,
            make_float4(0 < left ? a.x + bj : 0.f, 1 < left ? a.y + bj : 0.f,
                        2 < left ? a.z + bj : 0.f, 3 < left ? a.w + bj : 0.f));
        continue;
      }
      const int jj = i % cs.cnt, g = i / cs.cnt;
      float bias;
      float4 mk;
      owner_loads(c, net, netid, l, cs, jj, g, bias, mk);
      const float* src = reg + jj * TRP + g * RB;
      float4 a = ld4(src);
      for (int s = 1; s < sources; ++s) a = add4(a, ld4(src + s * cs.sw * TRP));
      owner_out<kReluOnly ? kRelu : -1>(c, net, netid, l, jj, g, a, bias, mk, keep, nrows, h);
    }
    __syncthreads();
  }
}

// This CTA's rows of the policy's dW (and its columns' db), plus the tile:
// dW[k][j] += sum_r hs[k][r] g[j][r] for k < ks.cnt, j < dout; a thread
// takes 4 rows x 4 columns, summed over the tile's row groups in order.
__device__ void dw_accumulate(const Ctx& c, const Slice& ks, int dout, const float* hs,
                              const float* g, float* dw, float* db, bool bias) {
  const int tid = threadIdx.x, nt = blockDim.x, TRP = c.lay.TRP, G = c.lay.TR / RB;
  const int ld = round4(dout), K4 = ceil_div(ks.cnt, 4), J4 = ceil_div(dout, 4);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = tid; i < K4 * J4; i += nt) {
    const int kb = i / J4, j0 = (i - kb * J4) * 4, k0 = kb * 4;
    float sum[4][4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int q = 0; q < 4; ++q) sum[b][q] = 0.f;
    for (int r = 0; r < G; ++r) {
      float4 hv[4], gv[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) hv[b] = k0 + b < ks.cnt ? ld4(hs + (k0 + b) * TRP + r * RB) : zero;
#pragma unroll
      for (int q = 0; q < 4; ++q) gv[q] = j0 + q < dout ? ld4(g + (j0 + q) * TRP + r * RB) : zero;
#pragma unroll
      for (int b = 0; b < 4; ++b)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          sum[b][q] = fmaf(hv[b].x, gv[q].x, sum[b][q]);
          sum[b][q] = fmaf(hv[b].y, gv[q].y, sum[b][q]);
          sum[b][q] = fmaf(hv[b].z, gv[q].z, sum[b][q]);
          sum[b][q] = fmaf(hv[b].w, gv[q].w, sum[b][q]);
        }
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (k0 + b >= ks.cnt) break;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (j0 + q < dout) dw[(k0 + b) * ld + j0 + q] += sum[b][q];
    }
  }
  if (!bias) return;
  const Slice js = slice_of(dout, c.rank);
  for (int jj = tid; jj < js.cnt; jj += nt) {
    const float* gj = g + (js.c0 + jj) * TRP;
    float s = 0.f;
    for (int r = 0; r < c.lay.TR; ++r) s += gj[r];
    db[js.c0 + jj] += s;
  }
}

// The layer input h = act(a) * mask at 4 rows and the gradient wrt its
// pre-activation from g_h (rows past `left`: zeros).
template <int A>
__device__ __forceinline__ void input_vjp(int act, const float (&av)[RB], const float (&mv)[RB],
                                          const float (&gh)[RB], bool masked, int left,
                                          float (&hv)[RB], float (&ga)[RB]) {
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    ga[r] = hv[r] = 0.f;
    if (r >= left) continue;
    const float fa = actf<A>(act, av[r]);
    hv[r] = masked ? fa * mv[r] : fa;
    ga[r] = actg<A>(act, av[r], masked ? gh[r] * mv[r] : gh[r]);
  }
}

// Backward walk of one MLP over a tile, in reverse. On entry the gradient
// wrt the output, all of it, is in region(c.pass + 1) of this CTA. Each
// layer l > 0 forms g_h for this CTA's rows of its input, applies mask (the
// tile's slice staged by step_fwd) and activation VJP, and all-gathers the
// result (written here, then sent to the other CTAs by all threads), one
// cluster barrier a layer. Layer 0 needs no
// exchange: every CTA forms the whole gradient wrt the MLP input from the
// gathered g_a and the whole W_0, into lay.gx ([din][TRP]), which this
// returns. The hidden pre-activations are the slices the forward kept.
// With dw (the policy): adds this CTA's rows of every layer's dW and db
// (x_off: the whole layer-0 input).
template <bool kReluOnly>
__device__ const float* mlp_bwd(Ctx& c, const Net& net, int netid, int row0, int nrows,
                                int x_off, float* dw) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int TR = c.lay.TR, TRP = c.lay.TRP, G = TR / RB;
  const bool res = c.lay.resident;
  float* hs = c.sm + c.lay.h;  // the forward's slice buffer, free here
  for (int l = net.n; l >= 1; --l) {
    const int din = net.dims[l], dout = net.dims[l + 1];
    const Slice ks = slice_of(din, c.rank);
    const int ld = res ? round4(dout) : dout;
    const float* w = wrows(c, net, netid, l, ks);
    const float* g = c.region(c.pass + 1);
    float* gnext = c.region(c.pass);
    const int hid = l - 1;
    const float* M = net.m[hid];
    const float* mkb = c.sm + c.lay.msk_off[netid][hid];
    const int act = net.act[hid];
    // items (block of 4 rows k, row group), each split over kparts lanes
    const int K4 = ceil_div(ks.cnt, 4), n = K4 * G;
    int kparts = 1;
    while (kparts < 32 && 2 * kparts * n <= nt) kparts *= 2;
    for (int i0 = 0; i0 < n * kparts; i0 += nt) {
      const int item = (i0 + tid) / kparts, part = (i0 + tid) % kparts;
      const bool on = item < n;
      const int it = on ? item : 0;
      const int kb = it / G, rg = it - kb * G, k0 = kb * 4;
      float4 acc[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[b] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (on) {
#pragma unroll 2
        for (int j = part; j < dout; j += kparts) {
          const float4 gv = ld4(g + j * TRP + rg * RB);
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const float wv = w_at(res, w, ld, k0 + b, j, ks.cnt);
            acc[b].x = fmaf(gv.x, wv, acc[b].x);
            acc[b].y = fmaf(gv.y, wv, acc[b].y);
            acc[b].z = fmaf(gv.z, wv, acc[b].z);
            acc[b].w = fmaf(gv.w, wv, acc[b].w);
          }
        }
      }
      for (int m = kparts >> 1; m > 0; m >>= 1) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          acc[b].x += __shfl_xor_sync(0xffffffffu, acc[b].x, m);
          acc[b].y += __shfl_xor_sync(0xffffffffu, acc[b].y, m);
          acc[b].z += __shfl_xor_sync(0xffffffffu, acc[b].z, m);
          acc[b].w += __shfl_xor_sync(0xffffffffu, acc[b].w, m);
        }
      }
      if (!on) continue;
      // after the butterfly every lane of the item holds its four sums:
      // lane `part` finishes rows k0 + part, k0 + part + kparts, ...
      const int left = nrows - rg * RB;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int k = k0 + b;
        if (k >= ks.cnt) break;
        if ((b - part) % kparts) continue;
        const float4 a4 = ld4(c.sm + c.lay.asm_off[netid][hid] + k * TRP + rg * RB);
        const float4 m4 = M ? ld4(mkb + k * TRP + rg * RB) : make_float4(1.f, 1.f, 1.f, 1.f);
        const float av[RB] = {a4.x, a4.y, a4.z, a4.w};
        const float mv[RB] = {m4.x, m4.y, m4.z, m4.w};
        const float gh[RB] = {acc[b].x, acc[b].y, acc[b].z, acc[b].w};
        float ga[RB], hv[RB];
        input_vjp<kReluOnly ? kRelu : -1>(act, av, mv, gh, M != nullptr, left, hv, ga);
        if (dw) st4(hs + k * TRP + rg * RB, make_float4(hv[0], hv[1], hv[2], hv[3]));
        st4(gnext + (ks.c0 + k) * TRP + rg * RB, make_float4(ga[0], ga[1], ga[2], ga[3]));
      }
    }
    __syncthreads();
    // this CTA's rows of the new g_a to the other CTAs, all threads sending
    for (int e = tid; e < ks.cnt * G * (kCluster - 1); e += nt) {
      const int dst = (c.rank + 1 + e % (kCluster - 1)) % kCluster, i = e / (kCluster - 1);
      const int off = (ks.c0 + i / G) * TRP + (i % G) * RB;
      st4(remote(gnext, dst) + off, ld4(gnext + off));
    }
    // g (this layer's g_a) is rewritten only after the barrier below
    if (dw)
      dw_accumulate(c, ks, dout, hs, g, dw + c.lay.dw_off[l],
                    dw + c.lay.dw_off[l] + round4(ceil_div(din, kCluster)) * round4(dout),
                    net.b[l] != nullptr);
    cluster_sync();
    ++c.pass;
  }
  // layer 0: the whole gradient wrt the input, in every CTA (the same bits)
  const int din = net.dims[0], dout = net.dims[1];
  const float* g = c.region(c.pass + 1);
  const float* w0 = res ? c.sm + c.lay.w_off[netid][0] : net.w[0];
  const int ld0 = res ? round4(dout) : dout;
  float* gx = c.sm + c.lay.gx;
  const int n = din * G;
  int kparts = 1;
  while (kparts < 32 && 2 * kparts * n <= nt) kparts *= 2;
  for (int i0 = 0; i0 < n * kparts; i0 += nt) {
    const int item = (i0 + tid) / kparts, part = (i0 + tid) % kparts;
    const bool on = item < n;
    const int k = on ? item / G : 0, rg = on ? item % G : 0;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (on) {
      for (int j = part; j < dout; j += kparts) {
        const float4 gv = ld4(g + j * TRP + rg * RB);
        const float wv = w0[k * ld0 + j];
        acc.x = fmaf(gv.x, wv, acc.x);
        acc.y = fmaf(gv.y, wv, acc.y);
        acc.z = fmaf(gv.z, wv, acc.z);
        acc.w = fmaf(gv.w, wv, acc.w);
      }
    }
    for (int m = kparts >> 1; m > 0; m >>= 1) {
      acc.x += __shfl_xor_sync(0xffffffffu, acc.x, m);
      acc.y += __shfl_xor_sync(0xffffffffu, acc.y, m);
      acc.z += __shfl_xor_sync(0xffffffffu, acc.z, m);
      acc.w += __shfl_xor_sync(0xffffffffu, acc.w, m);
    }
    if (on && !part) st4(gx + k * TRP + rg * RB, acc);
  }
  if (dw) {
    const Slice ks = slice_of(din, c.rank);
    dw_accumulate(c, ks, dout, c.sm + x_off + ks.c0 * TRP, g, dw + c.lay.dw_off[0],
                  dw + c.lay.dw_off[0] + round4(ceil_div(din, kCluster)) * round4(dout),
                  net.b[0] != nullptr);
  }
  __syncthreads();
  return gx;
}

}  // namespace

namespace {

// ---- one step of a row tile ---------------------------------------------------

// Starts 4-byte cp.async copies of src[0, n) to dst[0, n) (all threads; no
// commit, no wait).
__device__ __forceinline__ void prefetch(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) cp_async4(dst + i, src + i);
}

__device__ __forceinline__ void prefetch_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}


// The step's forward for a tile: states from srows ([TR][D] row-major, this
// tile's rows; shared or global memory), eps_t the step's action noise (or
// null). Leaves the policy and dynamics outputs, u, the action, nxt and r in
// the tile arrays, zero past nrows, and both MLPs' whole inputs in lay.xp
// and lay.xd; with keep, the hidden pre-activation slices for the backward.
template <bool kReluOnly>
__device__ void step_fwd(Ctx& c, const Step& st, const float* srows, const float* eps_t,
                         int row0, int nrows, bool keep) {
  const int D = st.D, U = st.U, tid = threadIdx.x, nt = blockDim.x;
  const int TR = c.lay.TR, TRP = c.lay.TRP;
  float* ts = c.sm + c.lay.tsm;
  float* xp = c.sm + c.lay.xp;
  float* xd = c.sm + c.lay.xd;
  // the tile's mask slices of every hidden layer and its noise, all in
  // flight together (one wait for the whole step)
  for (int id = 0; id < 2; ++id) {
    const Net& net = id ? st.dyn : st.pol;
    for (int l = 0; l < net.n; ++l) {
      if (!net.m[l]) continue;
      const int w = net.dims[l + 1];
      const Slice cs = slice_of(w, c.rank);
      float* dst = c.sm + c.lay.msk_off[id][l];
      for (int e = tid; e < cs.cnt * nrows; e += nt) {
        const int k = e / nrows, r = e - k * nrows;
        cp_async4(dst + k * TRP + r, net.m[l] + (size_t)(row0 + r) * w + cs.c0 + k);
      }
    }
  }
  for (int e = tid; e < nrows * U; e += nt) {
    const int r = e / U, k = e - r * U;
    cp_async4(ts + (kTZp + k) * TRP + r, st.z_pol + (size_t)(row0 + r) * U + k);
    if (eps_t) cp_async4(ts + (kTEps + k) * TRP + r, eps_t + (size_t)(row0 + r) * U + k);
  }
  for (int e = tid; e < nrows * D; e += nt) {
    const int r = e / D, k = e - r * D;
    cp_async4(ts + (kTZd + k) * TRP + r, st.z_dyn + (size_t)(row0 + r) * D + k);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int e = tid; e < D * TR; e += nt) {
    const int k = e / TR, r = e - k * TR;
    xp[k * TRP + r] = r < nrows ? srows[r * D + k] : 0.f;
  }
  prefetch_wait();
  mlp_fwd<kReluOnly>(c, st.pol, 0, c.lay.xp, keep, c.lay.tsm + kTPout * TRP, row0, nrows);
  for (int e = tid; e < TR * U; e += nt) {
    const int r = e / U, k = e - r * U;
    const float mean = ts[(kTPout + k) * TRP + r], lsr = ts[(kTPout + U + k) * TRP + r];
    const float z = r < nrows ? ts[(kTZp + k) * TRP + r] : 0.f;
    const float u = mean + z * expf(upper_clip(lsr, st.pol_upper));
    float a = st.act_scale[k] * tanhf(u) + st.act_bias[k];
    if (eps_t && r < nrows) a += ts[(kTEps + k) * TRP + r];
    ts[(kTU + k) * TRP + r] = u;
    ts[(kTAct + k) * TRP + r] = a;
  }
  __syncthreads();
  for (int e = tid; e < (D + U) * TR; e += nt) {
    const int k = e / TR, r = e - k * TR;
    float v = 0.f;
    if (r < nrows) {
      v = k < D ? xp[k * TRP + r] : ts[(kTAct + k - D) * TRP + r];
      v = (v - st.mx[k]) * st.isx[k];
    }
    xd[k * TRP + r] = v;
  }
  __syncthreads();
  mlp_fwd<kReluOnly>(c, st.dyn, 1, c.lay.xd, keep, c.lay.tsm + kTDout * TRP, row0, nrows);
  for (int e = tid; e < TR * D; e += nt) {
    const int r = e / D, k = e - r * D;
    const float mr = ts[(kTDout + k) * TRP + r], lsr = ts[(kTDout + D + k) * TRP + r];
    const float ls = upper_clip(lsr, st.dyn_upper) + logf(st.sy[k]);
    const float mean = mr * st.sy[k] + st.my[k];
    const bool in = r < nrows;
    const float z = in ? ts[(kTZd + k) * TRP + r] : 0.f;
    const float s = in ? xp[k * TRP + r] : 0.f;
    ts[(kTNxt + k) * TRP + r] = in ? s + (mean + z * expf(ls)) : 0.f;
  }
  __syncthreads();
  for (int r = tid; r < TR; r += nt) {
    float q = 0.f, ua = 0.f;
    for (int j = 0; j < st.ntip; ++j) {
      float tip = 0.f;
      for (int k = 0; k < D; ++k) tip += st.tip[j * D + k] * ts[(kTNxt + k) * TRP + r];
      const float d = (tip - st.target[j]) / st.norm;
      q += d * d;
    }
    for (int k = 0; k < U; ++k) ua += ts[(kTAct + k) * TRP + r] * ts[(kTAct + k) * TRP + r];
    ts[kTR * TRP + r] = r < nrows ? expf(-(0.5f * (st.q_scale * q + st.r_scale * ua))) : 0.f;
  }
  __syncthreads();
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
// states srows, then the VJPs in reverse order (reward, dynamics density,
// dynamics MLP, squash and policy density, policy MLP with the dW). The
// gradients wrt the pre-MM nxt and r come from the cluster's rows (XN, RR,
// at local particle lp); the state cotangent goes back to GS.
template <bool kReluOnly>
__device__ void step_bwd(Ctx& c, const Step& st, const Roll& ro, RollSm& sh, int t,
                         const float* srows, int row0, int nrows, int lp, float* dwacc) {
  const int D = st.D, U = st.U, tid = threadIdx.x, nt = blockDim.x, B = st.B;
  const int TR = c.lay.TR, TRP = c.lay.TRP;
  const float* eps_t = st.eps ? st.eps + (size_t)t * B * U : nullptr;
  step_fwd<kReluOnly>(c, st, srows, eps_t, row0, nrows, true);
  lap(ro, sh, kLapRecompute);
  float* ts = c.sm + c.lay.tsm;
  const Rows rw = rows_of(c, D);
  // reward: r = exp(-cost), cost = 0.5 (q |(tip - target) / norm|^2 + rs |a|^2)
  for (int r = tid; r < TR; r += nt) {
    const bool in = r < nrows;
    const float gc = -(in ? rw.RR[lp + r] : 0.f) * ts[kTR * TRP + r];
    float gtip[kMaxTip];
    for (int j = 0; j < st.ntip; ++j) {
      float tip = 0.f;
      for (int k = 0; k < D; ++k) tip += st.tip[j * D + k] * ts[(kTNxt + k) * TRP + r];
      const float d = (tip - st.target[j]) / st.norm;
      gtip[j] = gc * 0.5f * st.q_scale * 2.f * d / st.norm;
    }
    for (int k = 0; k < D; ++k) {
      float g = in ? rw.XN[(lp + r) * D + k] : 0.f;
      for (int j = 0; j < st.ntip; ++j) g += st.tip[j * D + k] * gtip[j];
      ts[(kTGnxt + k) * TRP + r] = in ? g : 0.f;
    }
    for (int k = 0; k < U; ++k)
      ts[(kTGact + k) * TRP + r] = gc * 0.5f * st.r_scale * 2.f * ts[(kTAct + k) * TRP + r];
  }
  __syncthreads();
  // nxt = s + mean * sy + my + z * exp(upper_clip(lsr) + log sy): the dynamics
  // output's gradient, all of it, where the first backward layer reads it
  float* X = c.region(c.pass + 1);
  for (int e = tid; e < TR * D; e += nt) {
    const int r = e / D, k = e - r * D;
    const float g = ts[(kTGnxt + k) * TRP + r];
    const float lsr = ts[(kTDout + D + k) * TRP + r];
    const float ls = upper_clip(lsr, st.dyn_upper) + logf(st.sy[k]);
    const float z = r < nrows ? ts[(kTZd + k) * TRP + r] : 0.f;
    X[k * TRP + r] = g * st.sy[k];
    X[(D + k) * TRP + r] = (g * z) * expf(ls) * sigmoid_f(st.dyn_upper - lsr);
  }
  __syncthreads();
  const float* gx = mlp_bwd<kReluOnly>(c, st.dyn, 1, row0, nrows, c.lay.xd, nullptr);
  for (int e = tid; e < TR * D; e += nt) {
    const int r = e / D, k = e - r * D;
    ts[(kTGs + k) * TRP + r] = ts[(kTGnxt + k) * TRP + r] + gx[k * TRP + r] * st.isx[k];
  }
  for (int e = tid; e < TR * U; e += nt) {
    const int r = e / U, k = e - r * U;
    const float ga = ts[(kTGact + k) * TRP + r] + gx[(D + k) * TRP + r] * st.isx[D + k];
    ts[(kTGact + k) * TRP + r] = ga;
    if (ro.g_eps && c.rank == 0 && r < nrows)
      ro.g_eps[((size_t)t * B + row0 + r) * U + k] = ga;
  }
  __syncthreads();
  // a = scale tanh(u) + bias + eps, u = mean + z exp(upper_clip(lsr)): the
  // policy output's gradient, where the first backward layer reads it
  float* Xp = c.region(c.pass + 1);
  for (int e = tid; e < TR * U; e += nt) {
    const int r = e / U, k = e - r * U;
    const float ga = ts[(kTGact + k) * TRP + r];
    const float th = tanhf(ts[(kTU + k) * TRP + r]);
    const float gu = ga * st.act_scale[k] * (1.f - th * th);
    const float lsr = ts[(kTPout + U + k) * TRP + r];
    const float z = r < nrows ? ts[(kTZp + k) * TRP + r] : 0.f;
    Xp[k * TRP + r] = gu;
    Xp[(U + k) * TRP + r] =
        (gu * z) * expf(upper_clip(lsr, st.pol_upper)) * sigmoid_f(st.pol_upper - lsr);
  }
  __syncthreads();
  const float* gp = mlp_bwd<kReluOnly>(c, st.pol, 0, row0, nrows, c.lay.xp, dwacc);
  for (int e = tid; e < nrows * D; e += nt) {
    const int r = e / D, k = e - r * D;
    rw.GS[(lp + r) * D + k] = ts[(kTGs + k) * TRP + r] + gp[k * TRP + r];
  }
  __syncthreads();
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

// Stages this CTA's weight rows of both MLPs (resident plans) and zeroes its
// dW accumulator; ends with a cluster barrier, so every CTA of the cluster
// has started before any writes into another's shared memory.
__device__ void stage(const Ctx& c, const Step& st, float* dwacc) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (c.lay.resident) {
    for (int id = 0; id < 2; ++id) {
      const Net& net = id ? st.dyn : st.pol;
      for (int l = 0; l <= net.n; ++l) {
        const int din = net.dims[l], dout = net.dims[l + 1], ld = round4(dout);
        const int kw4 = l ? round4(ceil_div(din, kCluster)) : din;
        const Slice ks = l ? slice_of(din, c.rank) : Slice{0, din, din};
        float* dst = c.sm + c.lay.w_off[id][l];
        const float* src = net.w[l] + (size_t)ks.c0 * dout;
        for (int e = tid; e < kw4 * ld; e += nt) {
          const int k = e / ld, j = e - k * ld;
          if (k >= ks.cnt || j >= dout) dst[e] = 0.f;
        }
        const int n = ks.cnt * dout;
        if (dout % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
          for (int i = tid; i < n / 4; i += nt) cp_async16(dst + 4 * i, src + 4 * i);
        } else {
          for (int e = tid; e < n; e += nt) {
            const int k = e / dout, j = e - k * dout;
            cp_async4(dst + k * ld + j, src + e);
          }
        }
      }
    }
  }
  // every layer's bias, zero where there is none
  for (int id = 0; id < 2; ++id) {
    const Net& net = id ? st.dyn : st.pol;
    for (int l = 0; l <= net.n; ++l) {
      const int dout = net.dims[l + 1];
      float* dst = c.sm + c.lay.bias_off[id][l];
      for (int j = tid; j < round4(dout); j += nt) {
        if (net.b[l] && j < dout) cp_async4(dst + j, net.b[l] + j);
        else dst[j] = 0.f;
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (dwacc)
    for (int e = tid; e < c.lay.dw_cta; e += nt) dwacc[e] = 0.f;
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  cluster_sync();
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

// Rows of W_l a CTA stages: all of W_0 (at most kMaxIn), its block of the others.
int wrows_of(int din, int l) { return l ? round4(ceil_div(din, kCluster)) : din; }

int net_kwmax(const Net& net) {
  int k = 0;
  for (int l = 0; l <= net.n + 1; ++l) k = max(k, ceil_div(net.dims[l], kCluster));
  return k;
}

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
  const int D = st.D, TRP = TR + 4;
  L.clusters = clusters;
  L.P = P;
  L.TR = TR;
  L.TRP = TRP;
  L.resident = plan[kPlanResident];
  const Net* nets[2] = {&st.pol, &st.dyn};
  long long off = 0;
  for (int id = 0; id < 2; ++id)
    for (int l = 0; l < kMaxLayers; ++l) {
      L.w_off[id][l] = 0;
      L.asm_off[id][l] = 0;
    }
  if (L.resident)
    for (int id = 0; id < 2; ++id)
      for (int l = 0; l <= nets[id]->n; ++l) {
        L.w_off[id][l] = static_cast<int>(off);
        off += (long long)wrows_of(nets[id]->dims[l], l) * round4(nets[id]->dims[l + 1]);
      }
  L.dwa = static_cast<int>(off);
  int dw = 0, flat = 0;
  for (int l = 0; l < kMaxLayers; ++l) L.dw_off[l] = 0;
  L.dw_flat[0] = 0;
  for (int l = 0; l <= st.pol.n; ++l) {
    const int din = st.pol.dims[l], dout = st.pol.dims[l + 1];
    L.dw_off[l] = dw;
    dw += round4(ceil_div(din, kCluster)) * round4(dout) + round4(dout);
    flat += din * dout + dout;
    L.dw_flat[l + 1] = flat;
  }
  L.dw_cta = dw;
  if (L.resident) off += dw;
  for (int id = 0; id < 2; ++id)
    for (int l = 0; l < kMaxLayers; ++l) {
      L.bias_off[id][l] = 0;
      L.msk_off[id][l] = 0;
      if (l > nets[id]->n) continue;
      L.bias_off[id][l] = static_cast<int>(off);
      off += round4(nets[id]->dims[l + 1]);
    }
  const int kwmax = max(net_kwmax(st.pol), net_kwmax(st.dyn));
  const int outmax = max(st.pol.dims[st.pol.n + 1], st.dyn.dims[st.dyn.n + 1]);
  const int rw = max(max(kCluster * kwmax, max_width(st)), kCluster * outmax);
  L.rfl = rw * TRP;
  L.region[0] = static_cast<int>(off);
  L.region[1] = static_cast<int>(off + L.rfl);
  off += 2LL * L.rfl;
  const int kw4 = round4(kwmax);
  L.h = static_cast<int>(off);
  off += (long long)kw4 * TRP;
  L.xp = static_cast<int>(off);
  L.xd = static_cast<int>(off + kMaxIn * TRP);
  L.gx = static_cast<int>(off + 2 * kMaxIn * TRP);
  off += 3LL * kMaxIn * TRP;
  for (int id = 0; id < 2; ++id)
    for (int l = 0; l < nets[id]->n; ++l) {
      const long long slice = (long long)round4(ceil_div(nets[id]->dims[l + 1], kCluster)) * TRP;
      L.asm_off[id][l] = static_cast<int>(off);
      L.msk_off[id][l] = static_cast<int>(off + slice);
      off += 2 * slice;
    }
  L.tsm = static_cast<int>(off);
  off += (long long)kTSmall * TRP;
  L.pp = static_cast<int>(off);
  off += round4(P * (5 * D + 6));
  L.parts = static_cast<int>(off);
  off += (long long)clusters * kPart;
  if (4 * off != plan[kPlanSmem] || 4 * off > kSmemMax) return false;
  // scratch: the clusters' partials (several clusters), the CTAs' dW
  // accumulators (streamed plans)
  long long sc = 0;
  const int multi = clusters > 1;
  L.s_fwd = 0;
  sc += multi ? (long long)T * clusters * kPart : 0;
  L.s_bwd = static_cast<int>(sc);
  sc += multi ? (long long)T * clusters * kPart : 0;
  L.s_loss = static_cast<int>(sc);
  sc += multi ? 2LL * clusters : 0;
  L.s_dw = static_cast<int>(sc);
  sc += multi ? (long long)clusters * flat : 0;
  L.s_dwcta = static_cast<int>(sc);
  sc += L.resident ? 0 : (long long)clusters * kCluster * dw;
  L.scratch = static_cast<int>(sc);
  return sc == plan[kPlanScratch] && sc < (1LL << 31);
}

int set_smem(const void* kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

cudaLaunchConfig_t cluster_config(int clusters, int threads, int smem, cudaStream_t s,
                                  cudaLaunchAttribute* attr, bool cooperative) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * kCluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cooperative ? 2 : 1;
  return cfg;
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

bool relu_only(const Net& net) {
  for (int l = 0; l < net.n; ++l)
    if (net.act[l] != kRelu) return false;
  return true;
}

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
