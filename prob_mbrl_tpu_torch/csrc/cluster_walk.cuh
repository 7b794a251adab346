// Device code of the cluster walk, shared by fused_rollout.cu (the whole
// rollout in one cooperative launch) and fused_step.cu (one rollout step per
// launch and direction): the launch's layout, the MLP walks of a tile of
// particle rows split over a thread-block cluster, the step's forward and its
// VJPs on such a tile, the staging of the weights, and the partials of the
// moments that both kernels merge.
//
// Layout. Clusters of kCluster = 8 CTAs. CTA r owns rows [r kw, r kw + kw),
// kw = ceil(d_l / 8), of every W_l of both MLPs, and all of W_0 (at most
// kMaxIn rows); with a resident plan stage() copies them into shared memory
// once per launch (16-byte cp.async where the block is 16-byte aligned and
// whole rows), else the walks read them from L2 in place. Every CTA of a
// cluster holds the tile's small per-row quantities (states, actions, MLP
// outputs, rewards, their gradients) and computes them redundantly, in the
// same order, so all eight hold the same bits with no exchange.
// - Layer 0 needs no exchange: every CTA holds the whole (small) input and
//   forms its own output columns, and in the backward the whole gradient
//   wrt the input from the gathered g_a.
// - Forward layer: each CTA forms the partial product of its weight rows for
//   every output column (4 rows x 4 columns a thread) and sends each
//   column's partial through distributed shared memory to the CTA that owns
//   the column; after one cluster barrier the owner sums the sources in rank
//   order, adds the bias, keeps the pre-activation and applies activation
//   and mask: its columns are its rows of the next layer. The output layer's
//   partials go to every CTA, which sums them in rank order. Exchange
//   buffers alternate between two regions, one barrier a layer.
// - Backward layer: every CTA holds the whole g_a, forms g_h for its rows
//   (each dot product split over lanes, a fixed butterfly), applies mask and
//   activation VJP and all-gathers the result, one barrier a layer. For the
//   policy it adds h[:, rows]^T g_a of the tile to a dW accumulator for its
//   rows (and its columns' db), in a fixed order.
// Model options (StepArgs' last fields): an MLP's input is its source row
// (the states, and for the dynamics the actions) or the sin or cos of one,
// angle-embedded as ops/angles.py has it, times the input-dropout mask
// after the dynamics' whitening (the policy's own input is then a tile
// array of its own, Lay::xq); an output nonlinearity acts on an MLP's
// outputs, whose pre-activations Lay::opre keeps for its VJP. Spectral norm
// needs nothing here: the wrapper binds the normalized weights. The policy's
// head (StepArgs::pol_head) is a diagonal Gaussian in line, or out of line a
// TanhSquashedDensity (its own tanh squash before the policy's) or a
// CategoricalDensity (U logits, the straight-through one-hot of its
// Gumbel-softmax pick; the tile arrays keep u or y for the VJP, kTU).
// Data written in the same launch by other CTAs is read with plain loads or
// cp.async (no __restrict__ const, no __ldg). No atomics on values.
#pragma once

#include <cooperative_groups.h>

#include <cstdint>

#include "rollout_step.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;       // CTAs per cluster (the portable maximum)
constexpr int RB = 4;             // rows of a row group: one float4 of a feature-major tile
constexpr int kMaxThreads = 512;  // 128 registers a thread
constexpr int kMaxTileRows = 128;
#if !PMBRL_WIDE
constexpr int kSmemMax = 232448 - 8192;  // dynamic shared memory (the static part is below 8192)
constexpr int kStaticSmem = 8192;
#else
// the wide instance's static part (its sites of 16 x 16, partials of 176
// floats, grouped MM's sites in shared memory) is below 24576
constexpr int kStaticSmem = 24576;
constexpr int kSmemMax = 232448 - kStaticSmem;
#endif
constexpr int kStat = 2 * kMaxD + kMaxD * kMaxD;  // m, sd, L of one resample site
constexpr int kMaxIn = kMaxD + kMaxU;             // the dynamics' input without angle embedding
constexpr int kTri = kMaxD * (kMaxD + 1) / 2;
// a cluster's forward partial: n, mean, centred M2 (lower, row-major), centred
// sums; then the reward's mean, M2, centred sum and plain sum
constexpr int kFN = 0, kFMean = 1, kFM2 = kFMean + kMaxD, kFSd = kFM2 + kTri,
              kFR = kFSd + kMaxD;
// a partial of the MM adjoint's sums: sum g, sum g z^T (lower); the reward's two
constexpr int kBGm = 0, kBGl = kMaxD, kBR = kBGl + kTri;
#if !PMBRL_WIDE
constexpr int kPartF = 64, kPartB = 48;
#else
constexpr int kPartF = 176, kPartB = 156;
#endif
constexpr int kPart = kPartF > kPartB ? kPartF : kPartB;
// the tile's small per-row quantities, [feature][TRP] each; the dynamics
// head's outputs and noise have room for a learned reward's (kMaxD + 1 a half)
constexpr int kMaxE = kMaxD + 1;
// netid of the value update's critic in the walks (0 the policy, 1 the
// dynamics): its weights and biases are read in place, never staged
constexpr int kCriticNet = 2;
constexpr int kTPout = 0, kTDout = kTPout + 2 * kMaxU, kTU = kTDout + 2 * kMaxE,
              kTAct = kTU + kMaxU, kTNxt = kTAct + kMaxU, kTR = kTNxt + kMaxD,
              kTGnxt = kTR + 1, kTGact = kTGnxt + kMaxD, kTGs = kTGact + kMaxU,
              kTZp = kTGs + kMaxD, kTEps = kTZp + kMaxU, kTZd = kTEps + kMaxU;
#if !PMBRL_WIDE
constexpr int kTSmall = 80;
#else
constexpr int kTSmall = 156;
#endif

static_assert(kFR + 4 <= kPartF && kBR + 2 <= kPartB, "partials");
static_assert(kTZd + kMaxE <= kTSmall && (kTSmall & 3) == 0, "tile arrays");
static_assert(kPartF % 4 == 0 && kPartB % 4 == 0, "partials");

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

}  // namespace

// Shared-memory layout and tiling of one launch (offsets in floats, each a
// multiple of 4), from its plan: the walk's fields (walk_lay) and the
// whole-rollout kernel's (lay_of in fused_rollout.cu); the step kernels
// (step_lay_of in fused_step.cu) fill the walk's and the dW scratch's.
// Outside the unnamed namespace: the extern "C" functions build it.
struct Lay {
  int clusters, P, TR, TRP, resident;  // P: the rollout's particles a cluster
  int w_off[2][kMaxLayers];  // resident weight slices [kw4][d4] of each net's layers
  int dwa;                   // the dW accumulator (resident plans)
  int dw_off[kMaxLayers];    // the policy's dW accumulator [kw4][d4] + db [d4], from dwa
  int dw_cta;                // floats of one CTA's dW accumulator
  int region[2], rfl;        // the two exchange regions and their floats
  int h, xp, xd, gx, tsm, pp, parts;  // h: a layer's input slice (backward: the dW's)
  // kept hidden pre-activation slices [kw4][TRP] and the tile's mask slices
  // of the hidden layers [kw4][TRP] of the policy, the dynamics and (netid
  // kCriticNet, rollout_kernel.cuh) the value update's critic
  int asm_off[3][kMaxLayers];
  int msk_off[3][kMaxLayers];
  int bias_off[2][kMaxLayers];  // every layer's bias [d4] (zero without one)
  int cdw_off[kMaxLayers];   // the critic's dW accumulator [kw4][d4] + db [d4] of each layer
  int cdw_cta;               // floats of one CTA's critic dW accumulator
  // scratch (floats)
  int s_fwd, s_bwd, s_loss, s_dw, s_dwcta, s_cdw, s_closs, scratch;
  int dw_flat[kMaxLayers + 1];  // offsets of each policy layer's dW + db in a flat partial
  int s_gx;  // scratch: grouped MM's exchange of the state cotangent
  // a mixture dynamics head's rows [row][TRP] (none for a diagonal head):
  // its head_width(K, E) outputs, then its noise z_pi (K) and u_cat (1)
  int mix;
  // the policy MLP's own input [din][TRP] (angle-embedded or input-dropped
  // states; xq == xp without either), and with an output nonlinearity the
  // MLPs' output pre-activations [2 U + the dynamics' outputs][TRP] (0: none)
  int xq, opre;
};

namespace {

// one resample site's moments, factor and adjoint coefficients
struct Site {
  float m[kMaxD], S[kMaxD * kMaxD], L[kMaxD * kMaxD], sd[kMaxD];
  float H[kMaxD * kMaxD], c0[kMaxD], gm[kMaxD], gL[kMaxD * kMaxD];
};

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
template <class T>
__device__ __forceinline__ T* remote(T* p, int rank) {
  return cg::this_cluster().map_shared_rank(p, rank);
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

// ---- a mixture dynamics head, one row -----------------------------------------

// The pick of one row r of a mixture head of K components over E dims, held
// as the row's scalars (any K: no array sized by K). hd: the tile's mixture
// rows (Lay::mix), the logits at o = 2 E K, the log temperature at o + K,
// then z_pi (K rows) and u_cat. In the plain version's order of operations:
// temp = 0.1 + softplus(lt), lp = logit / temp, soft = softmax((log_softmax(lp)
// + z_pi) / 0.1), the hard pick idx = sum_j (u_cat > cumsum(soft)_j) (K past
// the last sum: no component, as jax.nn.one_hot has it), and the
// straight-through weights k = (hard - soft) + soft; for the backward also pi
// = softmax(lp). mx and lse are lp's max and log-sum-exp, my and sy those of
// the second softmax's arguments (sy the sum of their exponentials). A
// component's quantities come from these by the helpers below, one for each,
// whether from a cached value or recomputed from hd, so every use has the
// same operations and bits.
struct MixRow {
  const float* hd;
  int TRP, r, K, o;
  float temp, mx, lse, my, sy;
  int idx;
};

__device__ __forceinline__ float mix_at(const MixRow& m, int row) { return m.hd[row * m.TRP + m.r]; }

// lp_j = logit_j / temp
__device__ __forceinline__ float mix_lp(const MixRow& m, int j) { return mix_at(m, m.o + j) / m.temp; }

// log_softmax(lp)_j
__device__ __forceinline__ float mix_lsm_of(const MixRow& m, float lp) { return (lp - m.mx) - m.lse; }

// the second softmax's argument (log_softmax(lp)_j + z_pi_j) / 0.1
__device__ __forceinline__ float mix_y_of(const MixRow& m, int j, float lsm) {
  return (lsm + mix_at(m, m.o + m.K + 1 + j)) / 0.1f;
}

__device__ __forceinline__ float mix_soft_of(const MixRow& m, float y) { return expf(y - m.my) / m.sy; }

// the straight-through weight k_j = (hard_j - soft_j) + soft_j
__device__ __forceinline__ float mix_k_of(const MixRow& m, int j, float soft) {
  return ((j == m.idx ? 1.f : 0.f) - soft) + soft;
}

__device__ __forceinline__ float mix_soft(const MixRow& m, int j) {
  return mix_soft_of(m, mix_y_of(m, j, mix_lsm_of(m, mix_lp(m, j))));
}

// The row's scalars, with S (K rows of scratch, [j][TRP]) holding each
// component's lp, then its y, then its soft weight, which it leaves there.
__device__ void mix_pick(const float* hd, float* S, int TRP, int r, int K, int E, MixRow& m) {
  m.hd = hd;
  m.TRP = TRP;
  m.r = r;
  m.K = K;
  m.o = 2 * E * K;
  m.temp = 0.1f + softplus_f(mix_at(m, m.o + K));
  float* s = S + r;
  m.mx = 0.f;
  for (int j = 0; j < K; ++j) {
    const float lp = mix_lp(m, j);
    s[j * TRP] = lp;
    m.mx = j ? fmaxf(m.mx, lp) : lp;
  }
  float se = 0.f;
  for (int j = 0; j < K; ++j) se += expf(s[j * TRP] - m.mx);
  m.lse = logf(se);
  m.my = 0.f;
  for (int j = 0; j < K; ++j) {
    const float y = mix_y_of(m, j, mix_lsm_of(m, s[j * TRP]));
    s[j * TRP] = y;
    m.my = j ? fmaxf(m.my, y) : y;
  }
  m.sy = 0.f;
  for (int j = 0; j < K; ++j) m.sy += expf(s[j * TRP] - m.my);
  const float u = mix_at(m, m.o + 2 * K + 1);
  float cdf = 0.f;
  int idx = 0;
  for (int j = 0; j < K; ++j) {
    const float soft = mix_soft_of(m, s[j * TRP]);
    s[j * TRP] = soft;
    cdf += soft;
    idx += u > cdf ? 1 : 0;
  }
  m.idx = idx;
}

// The mixture head's sample of a tile, one thread a row (ts: the tile's
// small arrays, xp: the states, feature-major; S: K rows of scratch for
// mix_pick): the weights k of each row, then mean = sum_j mean_j k_j and
// std = exp(sum_j ls_j k_j) of each dim, mean_j = mr_j sy + my and ls_j =
// upper_clip(lsr_j) + log sy, nxt = s + mean + z std; the output D of a
// learned reward goes to r. The sums run over the components in order, in
// the tile's rows of a diagonal head's outputs (kTDout: mean_e at e, ls_e at
// kMaxE + e), which a mixture leaves free (its outputs are at Lay::mix).
// Kept out of line so that a diagonal head's step keeps its registers.
__device__ __noinline__ void mix_sample(const Step& st, const float* hd, float* ts,
                                        const float* xp, float* S, int TR, int TRP, int nrows) {
  const int D = st.D, K = st.K, E = head_dims(st.reward_kind, D);
  for (int r = threadIdx.x; r < TR; r += blockDim.x) {
    const bool in = r < nrows;
    float* mean = ts + kTDout * TRP + r;
    float* ls = ts + (kTDout + kMaxE) * TRP + r;
    for (int e = 0; e < E; ++e) mean[e * TRP] = ls[e * TRP] = 0.f;
    if (in) {
      MixRow m;
      mix_pick(hd, S, TRP, r, K, E, m);
      for (int j = 0; j < K; ++j) {
        const float k = mix_k_of(m, j, S[j * TRP + r]);
        for (int e = 0; e < E; ++e) {
          const float mr = hd[(e * K + j) * TRP + r], lsr = hd[(E * K + e * K + j) * TRP + r];
          mean[e * TRP] += (mr * st.sy[e] + st.my[e]) * k;
          ls[e * TRP] += (upper_clip(lsr, st.dyn_upper) + logf(st.sy[e])) * k;
        }
      }
    }
    for (int e = 0; e < E; ++e) {
      const float v = in ? mean[e * TRP] + ts[(kTZd + e) * TRP + r] * expf(ls[e * TRP]) : 0.f;
      if (e < D)
        ts[(kTNxt + e) * TRP + r] = in ? xp[e * TRP + r] + v : 0.f;
      else
        ts[kTR * TRP + r] = v;
    }
  }
}

// The mixture head's VJP of a tile, one thread a row, into X (the gradient
// wrt the dynamics MLP's outputs; g_r: the rewards' cotangent, for a
// learned reward's output D): with gls_e = g_e z_e std_e, mean_j's raw
// output gets g_e k_j sy_e and lsr_j gets gls_e k_j upper_clip'(lsr_j); the
// weights' cotangent dk_j = sum_e g_e mean_ej + gls_e ls_ej goes through the
// softmax (and its 1 / 0.1), log_softmax and lp = logit / temp into the
// logits and, through temp = 0.1 + softplus(lt), into lt (none through the
// hard pick). Scratch: ls_e and then gls_e in the tile's kTDout rows (as
// mix_sample); X's rows of the logits (o + j) hold the soft weights
// (mix_pick), then dk, then the log_softmax's cotangent, before their final
// values.
__device__ __noinline__ void mix_vjp(const Step& st, const float* hd, float* ts, const float* g_r,
                                     float* X, int TR, int TRP, int nrows) {
  const int D = st.D, K = st.K, E = head_dims(st.reward_kind, D), o = 2 * E * K;
  for (int r = threadIdx.x; r < TR; r += blockDim.x) {
    if (r >= nrows) {
      for (int i = 0; i <= o + K; ++i) X[i * TRP + r] = 0.f;
      continue;
    }
    float* S = X + o * TRP;
    MixRow m;
    mix_pick(hd, S, TRP, r, K, E, m);
    float* gls = ts + kTDout * TRP + r;
    for (int e = 0; e < E; ++e) gls[e * TRP] = 0.f;
    for (int j = 0; j < K; ++j) {
      const float k = mix_k_of(m, j, S[j * TRP + r]);
      for (int e = 0; e < E; ++e)
        gls[e * TRP] += (upper_clip(hd[(E * K + e * K + j) * TRP + r], st.dyn_upper) + logf(st.sy[e])) * k;
    }
    for (int e = 0; e < E; ++e) {
      const float g = e < D ? ts[(kTGnxt + e) * TRP + r] : g_r[r];
      gls[e * TRP] = (g * ts[(kTZd + e) * TRP + r]) * expf(gls[e * TRP]);
    }
    float dot = 0.f, sl = 0.f, gt = 0.f;
    for (int j = 0; j < K; ++j) {
      const float soft = S[j * TRP + r], k = mix_k_of(m, j, soft);
      float gk = 0.f;
      for (int e = 0; e < E; ++e) {
        const float g = e < D ? ts[(kTGnxt + e) * TRP + r] : g_r[r];
        const float lsy = logf(st.sy[e]), ge = gls[e * TRP];
        const float mr = hd[(e * K + j) * TRP + r], lsr = hd[(E * K + e * K + j) * TRP + r];
        X[(e * K + j) * TRP + r] = g * k * st.sy[e];
        X[(E * K + e * K + j) * TRP + r] = ge * k * sigmoid_f(st.dyn_upper - lsr);
        gk += g * (mr * st.sy[e] + st.my[e]) + ge * (upper_clip(lsr, st.dyn_upper) + lsy);
      }
      dot += gk * soft;
      S[j * TRP + r] = gk;
    }
    for (int j = 0; j < K; ++j) {
      const float glsm = mix_soft(m, j) * (S[j * TRP + r] - dot) / 0.1f;
      S[j * TRP + r] = glsm;
      sl += glsm;
    }
    for (int j = 0; j < K; ++j) {
      const float lp = mix_lp(m, j), glp = S[j * TRP + r] - expf(mix_lsm_of(m, lp)) * sl;
      X[(o + j) * TRP + r] = glp / m.temp;
      gt -= glp * lp;
    }
    X[(o + K) * TRP + r] = gt / m.temp * sigmoid_f(mix_at(m, o + K));
  }
}

// ---- the policy's other heads, one row --------------------------------------

// A categorical policy head's soft weights of tile row r (its U logits x at
// kTPout of the tile arrays, its Gumbel noise z at kTZp, zero past nrows) in
// the plain version's order of operations, each softmax with its max
// subtracted: lsm = log_softmax(x), p = exp(lsm) = softmax(x), soft =
// softmax((lsm + z) / head_temp).
__device__ void cat_soft(const Step& st, const float* ts, int TRP, int r, bool in, float* soft,
                         float* p) {
  const int U = st.U;
  float mx = ts[kTPout * TRP + r];
  for (int j = 1; j < U; ++j) mx = fmaxf(mx, ts[(kTPout + j) * TRP + r]);
  float se = 0.f;
  for (int j = 0; j < U; ++j) se += expf(ts[(kTPout + j) * TRP + r] - mx);
  const float lse = logf(se);
  float mv = 0.f;
  for (int j = 0; j < U; ++j) {
    const float lsm = (ts[(kTPout + j) * TRP + r] - mx) - lse;
    p[j] = expf(lsm);
    soft[j] = (lsm + (in ? ts[(kTZp + j) * TRP + r] : 0.f)) / st.head_temp;
    mv = j ? fmaxf(mv, soft[j]) : soft[j];
  }
  float sv = 0.f;
  for (int j = 0; j < U; ++j) {
    soft[j] = expf(soft[j] - mv);
    sv += soft[j];
  }
  for (int j = 0; j < U; ++j) soft[j] = soft[j] / sv;
}

// The sample of a TanhSquashedDensity or CategoricalDensity policy head
// (st.pol_head) of a tile, one thread a row: y, then a = act_scale tanh(y) +
// act_bias (+ eps) into ts[kTAct]. The tanh head keeps its Gaussian sample u
// = mean + z exp(upper_clip(lsr)) in ts[kTU] (y = head_scale tanh(u) +
// head_bias); the categorical head its y, the straight-through one-hot of the
// pick idx = sum_j (u_pol > cumsum(soft)_j) (u_pol at row kTPout + U, which
// its U-wide MLP output leaves free; U past the last sum: a zero row, as
// jax.nn.one_hot has it). Out of line, as mix_sample, so that a diagonal
// head's step keeps its registers.
__device__ __noinline__ void pol_head_sample(const Step& st, float* ts, int TR, int TRP, int nrows,
                                             bool eps) {
  const int U = st.U;
  for (int r = threadIdx.x; r < TR; r += blockDim.x) {
    const bool in = r < nrows;
    float y[kMaxU];
    if (st.pol_head == kHeadCat) {
      float soft[kMaxU], p[kMaxU];
      cat_soft(st, ts, TRP, r, in, soft, p);
      const float u = in ? ts[(kTPout + U) * TRP + r] : 0.f;
      float cdf = 0.f;
      int idx = 0;
      for (int j = 0; j < U; ++j) {
        cdf += soft[j];
        idx += u > cdf ? 1 : 0;
      }
      for (int j = 0; j < U; ++j) {
        y[j] = ((j == idx ? 1.f : 0.f) - soft[j]) + soft[j];
        ts[(kTU + j) * TRP + r] = y[j];
      }
    } else {
      for (int k = 0; k < U; ++k) {
        const float mean = ts[(kTPout + k) * TRP + r], lsr = ts[(kTPout + U + k) * TRP + r];
        const float z = in ? ts[(kTZp + k) * TRP + r] : 0.f;
        const float u = mean + z * expf(upper_clip(lsr, st.pol_upper));
        ts[(kTU + k) * TRP + r] = u;
        y[k] = st.head_scale * tanhf(u) + st.head_bias;
      }
    }
    for (int k = 0; k < U; ++k) {
      float a = st.act_scale[k] * tanhf(y[k]) + st.act_bias[k];
      if (eps && in) a += ts[(kTEps + k) * TRP + r];
      ts[(kTAct + k) * TRP + r] = a;
    }
  }
}

// Its VJP, one thread a row, into Xp (the gradient wrt the policy MLP's
// outputs) from ts[kTGact]: gy = g_a act_scale (1 - tanh(y)^2); the tanh
// head gu = gy head_scale (1 - tanh(u)^2), then the Gaussian sample's
// reparameterisation as a diagonal head's; the categorical head through soft
// (none through the hard pick): the softmax's VJP over 1 / head_temp, then
// log_softmax's, U outputs.
__device__ __noinline__ void pol_head_vjp(const Step& st, const float* ts, float* Xp, int TR,
                                          int TRP, int nrows) {
  const int U = st.U;
  for (int r = threadIdx.x; r < TR; r += blockDim.x) {
    const bool in = r < nrows;
    float gy[kMaxU];
    for (int k = 0; k < U; ++k) {
      const float ga = ts[(kTGact + k) * TRP + r], u = ts[(kTU + k) * TRP + r];
      const float ty = tanhf(st.pol_head == kHeadCat ? u : st.head_scale * tanhf(u) + st.head_bias);
      gy[k] = ga * st.act_scale[k] * (1.f - ty * ty);
    }
    if (st.pol_head == kHeadCat) {
      float soft[kMaxU], p[kMaxU], dot = 0.f, sl = 0.f;
      cat_soft(st, ts, TRP, r, in, soft, p);
      for (int j = 0; j < U; ++j) dot += gy[j] * soft[j];
      for (int j = 0; j < U; ++j) {
        gy[j] = soft[j] * (gy[j] - dot) / st.head_temp;
        sl += gy[j];
      }
      for (int j = 0; j < U; ++j) Xp[j * TRP + r] = gy[j] - p[j] * sl;
      continue;
    }
    for (int k = 0; k < U; ++k) {
      const float tu = tanhf(ts[(kTU + k) * TRP + r]);
      const float gu = gy[k] * st.head_scale * (1.f - tu * tu);
      const float lsr = ts[(kTPout + U + k) * TRP + r];
      const float z = in ? ts[(kTZp + k) * TRP + r] : 0.f;
      Xp[k * TRP + r] = gu;
      Xp[(U + k) * TRP + r] =
          (gu * z) * expf(upper_clip(lsr, st.pol_upper)) * sigmoid_f(st.pol_upper - lsr);
    }
  }
}

// ---- the MLP walks of one row tile, split over the cluster -----------------

// Whether the weights of `netid` are staged in shared memory (a resident
// plan's policy and dynamics) or read in place.
__device__ __forceinline__ bool staged(const Ctx& c, int netid) {
  return c.lay.resident && netid < kCriticNet;
}

// Weight rows of layer l of `net` (0 policy, 1 dynamics, kCriticNet the
// critic) that this CTA owns: the staged block [kw4][d4] (zero past the
// block), or the caller's W in place ([din][dout], rows from ks.c0).
__device__ __forceinline__ const float* wrows(const Ctx& c, const Net& net, int netid, int l,
                                              const Slice& ks) {
  if (staged(c, netid)) return c.sm + c.lay.w_off[netid][l];
  return net.w[l] + (size_t)ks.c0 * net.dims[l + 1];
}

// Bias j of layer l: staged (the policy's and the dynamics'), or the
// critic's in place; zero without one.
__device__ __forceinline__ float bias_at(const Ctx& c, const Net& net, int netid, int l, int j) {
  if (netid < kCriticNet) return c.sm[c.lay.bias_off[netid][l] + j];
  return net.b[l] ? net.b[l][j] : 0.f;
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
  bias = bias_at(c, net, netid, l, cs.c0 + jj);
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
  const bool res = staged(c, netid);
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
        const float bj = bias_at(c, net, netid, l, j);
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
// With dw (the policy, or the critic): adds this CTA's rows of every layer's
// dW and db at that net's accumulator offsets (x_off: the whole layer-0
// input).
template <bool kReluOnly>
__device__ const float* mlp_bwd(Ctx& c, const Net& net, int netid, int row0, int nrows,
                                int x_off, float* dw) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int TR = c.lay.TR, TRP = c.lay.TRP, G = TR / RB;
  const bool res = staged(c, netid);
  const int* dwo = netid == kCriticNet ? c.lay.cdw_off : c.lay.dw_off;
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
      dw_accumulate(c, ks, dout, hs, g, dw + dwo[l],
                    dw + dwo[l] + round4(ceil_div(din, kCluster)) * round4(dout),
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
    dw_accumulate(c, ks, dout, c.sm + x_off + ks.c0 * TRP, g, dw + dwo[0],
                  dw + dwo[0] + round4(ceil_div(din, kCluster)) * round4(dout),
                  net.b[0] != nullptr);
  }
  __syncthreads();
  return gx;
}

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

// Whether the walk needs the policy's own input array (Lay::xq).
__host__ __device__ __forceinline__ bool own_policy_input(const Step& st) {
  return st.pol.dims[0] != st.D || st.m_in[0] != nullptr;
}

__host__ __device__ __forceinline__ bool has_out_act(const Step& st) {
  return st.out_act[0] != kIdentity || st.out_act[1] != kIdentity;
}

// Input k of MLP `id` at tile row r: its source (the states xp, then the
// actions in the tile arrays) or the sin or cos of it (in_map).
__device__ __forceinline__ float mlp_input(const Step& st, int id, int k, const float* xp,
                                           const float* ts, int TRP, int r) {
  const int code = st.in_map[id][k], i = code / 3, kind = code - 3 * i;
  const float x = i < st.D ? xp[i * TRP + r] : ts[(kTAct + i - st.D) * TRP + r];
  return kind == 0 ? x : kind == 1 ? sinf(x) : cosf(x);
}

// MLP `id`'s input, all of it, into dst ([din][TRP], zeros past nrows): the
// angle-embedded sources (mlp_input), whitened for the dynamics, times the
// input-dropout mask. Out of line (as mix_sample), so that a step without
// the options keeps its registers.
__device__ __noinline__ void option_input(const Step& st, int id, float* dst, const float* xp,
                                          const float* ts, int TR, int TRP, int row0, int nrows) {
  const int din = (id ? st.dyn : st.pol).dims[0];
  const float* m = st.m_in[id];
  for (int e = threadIdx.x; e < din * TR; e += blockDim.x) {
    const int k = e / TR, r = e - k * TR;
    float v = 0.f;
    if (r < nrows) {
      v = mlp_input(st, id, k, xp, ts, TRP, r);
      if (id) v = (v - st.mx[k]) * st.isx[k];
      if (m) v *= m[(size_t)(row0 + r) * din + k];
    }
    dst[k * TRP + r] = v;
  }
}

// The output nonlinearity of MLP `id` (not kIdentity) on its `rows`
// outputs at out (kept in pre), zero past nrows.
__device__ __noinline__ void out_act_fwd(const Step& st, int id, float* out, float* pre, int rows,
                                         int TR, int TRP, int nrows) {
  const int act = st.out_act[id];
  for (int e = threadIdx.x; e < rows * TR; e += blockDim.x) {
    const int k = e / TR, r = e - k * TR;
    const float a = out[k * TRP + r];
    pre[k * TRP + r] = a;
    out[k * TRP + r] = r < nrows ? act_fwd(act, a) : 0.f;
  }
}

// Its VJP on the gradient X wrt the outputs, in place.
__device__ __noinline__ void out_act_vjp(const Step& st, int id, float* X, const float* pre,
                                         int rows, int TR, int TRP) {
  const int act = st.out_act[id];
  for (int e = threadIdx.x; e < rows * TR; e += blockDim.x) {
    const int k = e / TR, r = e - k * TR;
    X[k * TRP + r] = act_vjp(act, pre[k * TRP + r], X[k * TRP + r]);
  }
}

// The gradient wrt source i of MLP `id`'s input at row r, from gw, the
// gradient wrt each input (times mask and whitening), added to g in the
// inputs' order: a value passes, d sin x = cos x, d cos x = -sin x.
__device__ __forceinline__ float source_grad(const Step& st, int id, int i, float g, const float* gw,
                                             const float* xp, const float* ts, int TRP, int r) {
  const int din = (id ? st.dyn : st.pol).dims[0];
  const float x = i < st.D ? xp[i * TRP + r] : ts[(kTAct + i - st.D) * TRP + r];
  for (int k = 0; k < din; ++k) {
    const int code = st.in_map[id][k];
    if (code / 3 != i) continue;
    const int kind = code - 3 * i;
    const float v = gw[k * TRP + r];
    g += kind == 0 ? v : kind == 1 ? v * cosf(x) : -(v * sinf(x));
  }
  return g;
}

// The option path of the dynamics input's VJP: gx (the gradient wrt the MLP
// input, in place) times the input mask and the whitening, then onto each
// source: the states' into ts[kTGs] (after ts[kTGnxt]), the actions' into
// ts[kTGact] and g_eps.
__device__ __noinline__ void dyn_option_vjp(const Step& st, float* gx, const float* xp, float* ts,
                                            int TR, int TRP, int row0, int nrows, float* g_eps) {
  const int D = st.D, U = st.U, dx = st.dyn.dims[0], tid = threadIdx.x, nt = blockDim.x;
  for (int e = tid; e < dx * TR; e += nt) {
    const int k = e / TR, r = e - k * TR;
    float v = gx[k * TRP + r];
    if (st.m_in[1]) v *= r < nrows ? st.m_in[1][(size_t)(row0 + r) * dx + k] : 0.f;
    gx[k * TRP + r] = v * st.isx[k];
  }
  __syncthreads();
  for (int e = tid; e < TR * (D + U); e += nt) {
    const int r = e / (D + U), i = e - r * (D + U);
    const float g = i < D ? ts[(kTGnxt + i) * TRP + r] : ts[(kTGact + i - D) * TRP + r];
    const float gi = source_grad(st, 1, i, g, gx, xp, ts, TRP, r);
    if (i < D) {
      ts[(kTGs + i) * TRP + r] = gi;
    } else {
      ts[(kTGact + i - D) * TRP + r] = gi;
      if (g_eps && r < nrows) g_eps[r * U + i - D] = gi;
    }
  }
}

// The option path of the policy input's VJP: gp (in place) times the input
// mask, then onto the states: g_s = ts[kTGs] + its share.
__device__ __noinline__ void pol_option_vjp(const Step& st, float* gp, const float* xp,
                                            const float* ts, int TRP, int row0, int nrows,
                                            float* g_s) {
  const int D = st.D, dq = st.pol.dims[0], tid = threadIdx.x, nt = blockDim.x;
  if (st.m_in[0]) {
    for (int e = tid; e < dq * nrows; e += nt) {
      const int k = e / nrows, r = e - k * nrows;
      gp[k * TRP + r] *= st.m_in[0][(size_t)(row0 + r) * dq + k];
    }
    __syncthreads();
  }
  for (int e = tid; e < nrows * D; e += nt) {
    const int r = e / D, k = e - r * D;
    g_s[r * D + k] = source_grad(st, 0, k, ts[(kTGs + k) * TRP + r], gp, xp, ts, TRP, r);
  }
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
  if (st.u_pol)  // a categorical head's uniform, where its MLP output leaves a row
    for (int r = tid; r < nrows; r += nt) cp_async4(ts + (kTPout + U) * TRP + r, st.u_pol + row0 + r);
  const int E = head_dims(st.reward_kind, D), K = st.K;
  for (int e = tid; e < nrows * E; e += nt) {
    const int r = e / E, k = e - r * E;
    cp_async4(ts + (kTZd + k) * TRP + r, st.z_dyn + (size_t)(row0 + r) * E + k);
  }
  float* hd = c.sm + c.lay.mix;  // a mixture head's rows, then its noise
  const int hw = head_width(K, E);
  for (int e = tid; e < nrows * (K + 1) && K; e += nt) {
    const int r = e / (K + 1), k = e - r * (K + 1);
    cp_async4(hd + (hw + k) * TRP + r,
              k < K ? st.z_pi + (size_t)(row0 + r) * K + k : st.u_cat + row0 + r);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int e = tid; e < D * TR; e += nt) {
    const int k = e / TR, r = e - k * TR;
    xp[k * TRP + r] = r < nrows ? srows[r * D + k] : 0.f;
  }
  prefetch_wait();
  if (c.lay.xq != c.lay.xp) {  // the policy's input: embedded, input-dropped states
    option_input(st, 0, c.sm + c.lay.xq, xp, ts, TR, TRP, row0, nrows);
    __syncthreads();
  }
  mlp_fwd<kReluOnly>(c, st.pol, 0, c.lay.xq, keep, c.lay.tsm + kTPout * TRP, row0, nrows);
  const int pw = pol_width(st.pol_head, U);
  if (st.out_act[0] != kIdentity) {
    out_act_fwd(st, 0, ts + kTPout * TRP, c.sm + c.lay.opre, pw, TR, TRP, nrows);
    __syncthreads();
  }
  if (st.pol_head != kHeadDiag) pol_head_sample(st, ts, TR, TRP, nrows, eps_t != nullptr);
  for (int e = tid; e < TR * U && st.pol_head == kHeadDiag; e += nt) {
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
  if (st.dyn.dims[0] == D + U && !st.m_in[1]) {  // no embedding, no input dropout
    for (int e = tid; e < (D + U) * TR; e += nt) {
      const int k = e / TR, r = e - k * TR;
      float v = 0.f;
      if (r < nrows) {
        v = k < D ? xp[k * TRP + r] : ts[(kTAct + k - D) * TRP + r];
        v = (v - st.mx[k]) * st.isx[k];
      }
      xd[k * TRP + r] = v;
    }
  } else {
    option_input(st, 1, xd, xp, ts, TR, TRP, row0, nrows);
  }
  __syncthreads();
  const int dout_off = K ? c.lay.mix : c.lay.tsm + kTDout * TRP;
  mlp_fwd<kReluOnly>(c, st.dyn, 1, c.lay.xd, keep, dout_off, row0, nrows);
  if (st.out_act[1] != kIdentity) {
    out_act_fwd(st, 1, c.sm + dout_off, c.sm + c.lay.opre + pw * TRP,
                st.dyn.dims[st.dyn.n + 1], TR, TRP, nrows);
    __syncthreads();
  }
  // scratch: the exchange region the dynamics MLP's last layer has read, which
  // no CTA writes before this one's next cluster barrier
  if (K) mix_sample(st, hd, ts, xp, c.region(c.pass + 1), TR, TRP, nrows);
  for (int e = tid; e < TR * D && !K; e += nt) {
    const int r = e / D, k = e - r * D;
    const float mr = ts[(kTDout + k) * TRP + r], lsr = ts[(kTDout + E + k) * TRP + r];
    const float ls = upper_clip(lsr, st.dyn_upper) + logf(st.sy[k]);
    const float mean = mr * st.sy[k] + st.my[k];
    const bool in = r < nrows;
    const float z = in ? ts[(kTZd + k) * TRP + r] : 0.f;
    const float s = in ? xp[k * TRP + r] : 0.f;
    ts[(kTNxt + k) * TRP + r] = in ? s + (mean + z * expf(ls)) : 0.f;
  }
  __syncthreads();
  for (int r = tid; r < TR; r += nt) {
    if (st.reward_kind == kLearnedReward) {  // the head's output D, as a state's delta
      if (K) continue;  // sampled above
      const float mr = ts[(kTDout + D) * TRP + r], lsr = ts[(kTDout + E + D) * TRP + r];
      const float ls = upper_clip(lsr, st.dyn_upper) + logf(st.sy[D]);
      const float mean = mr * st.sy[D] + st.my[D];
      const float z = r < nrows ? ts[(kTZd + D) * TRP + r] : 0.f;
      ts[kTR * TRP + r] = r < nrows ? mean + z * expf(ls) : 0.f;
      continue;
    }
    if (st.reward_kind == kLanderReward) {  // D = 8, U = 2 (fill_step)
      float x[kMaxD], a[2];
      for (int k = 0; k < kMaxD; ++k) x[k] = ts[(kTNxt + k) * TRP + r];
      for (int k = 0; k < 2; ++k) a[k] = ts[(kTAct + k) * TRP + r];
      ts[kTR * TRP + r] = r < nrows ? lander_reward(x, a) : 0.f;
      continue;
    }
    float q = 0.f, ua = 0.f;
    for (int j = 0; j < st.ntip; ++j) {
      float tip = 0.f;
      for (int k = 0; k < D; ++k) tip += st.tip[j * D + k] * ts[(kTNxt + k) * TRP + r];
      const float d = (tip - st.target[j]) / st.norm;
      q += d * d;
    }
    for (int k = 0; k < U; ++k) ua += ts[(kTAct + k) * TRP + r] * ts[(kTAct + k) * TRP + r];
    float rew = 0.f;
    if (r < nrows)
      rew = st.reward_kind == kExpQuadReward ? expf(-(0.5f * (st.q_scale * q + st.r_scale * ua)))
                                             : -(st.q_scale * q + st.r_scale * ua);
    ts[kTR * TRP + r] = rew;
  }
  __syncthreads();
}

// The step's VJPs for a tile after step_fwd(keep = true) recomputed it, in
// reverse order (reward, dynamics density, dynamics MLP, squash and policy
// density, policy MLP with the dW into dwacc, or none when null). g_nxt
// [nrows][D] and g_r [nrows]: the gradients wrt the tile's pre-MM nxt and r
// (shared or global memory). Writes the gradient wrt the action noise to
// g_eps [nrows][U] and wrt the states to g_s [nrows][D], each where not null.
// Ends with __syncthreads().
template <bool kReluOnly>
__device__ __forceinline__ void step_vjp(Ctx& c, const Step& st, const float* g_nxt,
                                         const float* g_r, int row0, int nrows, float* g_eps,
                                         float* g_s, float* dwacc) {
  const int D = st.D, U = st.U, tid = threadIdx.x, nt = blockDim.x;
  const int TR = c.lay.TR, TRP = c.lay.TRP;
  float* ts = c.sm + c.lay.tsm;
  // reward, d = (tip - target) / norm: kind 0 r = exp(-cost), cost = 0.5 (q
  // |d|^2 + rs |a|^2), so dr/dtip_j = -r q d_j / norm, dr/da_k = -r rs a_k;
  // kind 1 r = -(q |d|^2 + rs |a|^2), dr/dtip_j = -2 q d_j / norm, dr/da_k =
  // -2 rs a_k. gq d_j / norm and ga a_k are the cotangents. Kind 2, the
  // lander: lander_reward_vjp, zero past nrows (a norm of 0 there is NaN).
  // Kind 3, learned: r is a head output, so nothing reaches nxt or the action
  // from it here (its gradient enters the head below).
  const int E = head_dims(st.reward_kind, D);
  for (int r = tid; r < TR; r += nt) {
    const bool in = r < nrows;
    const float gr = in ? g_r[r] : 0.f;
    if (st.reward_kind == kLearnedReward) {
      for (int k = 0; k < D; ++k) ts[(kTGnxt + k) * TRP + r] = in ? g_nxt[r * D + k] : 0.f;
      for (int k = 0; k < U; ++k) ts[(kTGact + k) * TRP + r] = 0.f;
      continue;
    }
    if (st.reward_kind == kLanderReward) {  // D = 8, U = 2 (fill_step)
      float x[kMaxD], a[2], gx[kMaxD], gu[2];
      for (int k = 0; k < kMaxD; ++k) x[k] = ts[(kTNxt + k) * TRP + r];
      for (int k = 0; k < 2; ++k) a[k] = ts[(kTAct + k) * TRP + r];
      lander_reward_vjp(x, a, gr, gx, gu);
      for (int k = 0; k < kMaxD; ++k)
        ts[(kTGnxt + k) * TRP + r] = in ? g_nxt[r * D + k] + gx[k] : 0.f;
      for (int k = 0; k < 2; ++k) ts[(kTGact + k) * TRP + r] = in ? gu[k] : 0.f;
      continue;
    }
    float gq, ga;
    if (st.reward_kind == kExpQuadReward) {
      const float gc = -gr * ts[kTR * TRP + r];
      gq = gc * 0.5f * st.q_scale * 2.f;
      ga = gc * 0.5f * st.r_scale * 2.f;
    } else {
      gq = -2.f * st.q_scale * gr;
      ga = -2.f * st.r_scale * gr;
    }
    float gtip[kMaxTip];
    for (int j = 0; j < st.ntip; ++j) {
      float tip = 0.f;
      for (int k = 0; k < D; ++k) tip += st.tip[j * D + k] * ts[(kTNxt + k) * TRP + r];
      const float d = (tip - st.target[j]) / st.norm;
      gtip[j] = gq * d / st.norm;
    }
    for (int k = 0; k < D; ++k) {
      float g = in ? g_nxt[r * D + k] : 0.f;
      for (int j = 0; j < st.ntip; ++j) g += st.tip[j * D + k] * gtip[j];
      ts[(kTGnxt + k) * TRP + r] = in ? g : 0.f;
    }
    for (int k = 0; k < U; ++k) ts[(kTGact + k) * TRP + r] = ga * ts[(kTAct + k) * TRP + r];
  }
  __syncthreads();
  // nxt = s + mean * sy + my + z * exp(upper_clip(lsr) + log sy): the dynamics
  // output's gradient, all of it, where the first backward layer reads it;
  // a learned reward, r = mean_D * sy_D + my_D + z_D exp(...), is output D,
  // with the cotangent g_r
  float* X = c.region(c.pass + 1);
  const int K = st.K;
  if (K) mix_vjp(st, c.sm + c.lay.mix, ts, g_r, X, TR, TRP, nrows);
  for (int e = tid; e < TR * E && !K; e += nt) {
    const int r = e / E, k = e - r * E;
    const float g = k < D ? ts[(kTGnxt + k) * TRP + r] : (r < nrows ? g_r[r] : 0.f);
    const float lsr = ts[(kTDout + E + k) * TRP + r];
    const float ls = upper_clip(lsr, st.dyn_upper) + logf(st.sy[k]);
    const float z = r < nrows ? ts[(kTZd + k) * TRP + r] : 0.f;
    X[k * TRP + r] = g * st.sy[k];
    X[(E + k) * TRP + r] = (g * z) * expf(ls) * sigmoid_f(st.dyn_upper - lsr);
  }
  __syncthreads();
  if (st.out_act[1] != kIdentity) {
    out_act_vjp(st, 1, X, c.sm + c.lay.opre + pol_width(st.pol_head, U) * TRP,
                st.dyn.dims[st.dyn.n + 1], TR, TRP);
    __syncthreads();
  }
  float* gx = const_cast<float*>(mlp_bwd<kReluOnly>(c, st.dyn, 1, row0, nrows, c.lay.xd, nullptr));
  if (st.dyn.dims[0] == D + U && !st.m_in[1]) {  // no embedding, no input dropout
    for (int e = tid; e < TR * D; e += nt) {
      const int r = e / D, k = e - r * D;
      ts[(kTGs + k) * TRP + r] = ts[(kTGnxt + k) * TRP + r] + gx[k * TRP + r] * st.isx[k];
    }
    for (int e = tid; e < TR * U; e += nt) {
      const int r = e / U, k = e - r * U;
      const float ga = ts[(kTGact + k) * TRP + r] + gx[(D + k) * TRP + r] * st.isx[D + k];
      ts[(kTGact + k) * TRP + r] = ga;
      if (g_eps && r < nrows) g_eps[r * U + k] = ga;
    }
  } else {
    dyn_option_vjp(st, gx, c.sm + c.lay.xp, ts, TR, TRP, row0, nrows, g_eps);
  }
  __syncthreads();
  // a = scale tanh(u) + bias + eps, u = mean + z exp(upper_clip(lsr)): the
  // policy output's gradient, where the first backward layer reads it (the
  // other heads: pol_head_vjp)
  float* Xp = c.region(c.pass + 1);
  if (st.pol_head != kHeadDiag) pol_head_vjp(st, ts, Xp, TR, TRP, nrows);
  for (int e = tid; e < TR * U && st.pol_head == kHeadDiag; e += nt) {
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
  if (st.out_act[0] != kIdentity) {
    out_act_vjp(st, 0, Xp, c.sm + c.lay.opre, pol_width(st.pol_head, U), TR, TRP);
    __syncthreads();
  }
  float* gp = const_cast<float*>(mlp_bwd<kReluOnly>(c, st.pol, 0, row0, nrows, c.lay.xq, dwacc));
  if (g_s && c.lay.xq == c.lay.xp) {
    for (int e = tid; e < nrows * D; e += nt) {
      const int r = e / D, k = e - r * D;
      g_s[r * D + k] = ts[(kTGs + k) * TRP + r] + gp[k * TRP + r];
    }
  } else if (g_s) {
    pol_option_vjp(st, gp, c.sm + c.lay.xp, ts, TRP, row0, nrows, g_s);
  }
  __syncthreads();
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

// The walk's layout for tiles of TR rows (the formulas of _walk_floats in
// fused_rollout.py): the resident weights of both MLPs (all of W_0 and a
// block of ceil(d_l / 8) rows, to 4, of each later W_l, rows padded to 4),
// with bwd and resident weights the policy's dW accumulator; every layer's
// bias; two exchange regions; the layer-input slice; both MLPs' whole inputs
// and the gradient wrt one; the tile's mask slices of the hidden layers and,
// with bwd, the kept pre-activation slices; the tile's small arrays and a
// mixture head's rows (Lay::mix: its outputs and noise). With a
// critic (bwd only) the widths of its layers count in the exchange regions
// and the layer-input slice, and its kept pre-activation and mask slices
// share the policy's and the dynamics' room (the walks of the three never
// overlap in time), which grows to the larger of the two. Returns the
// floats so far.
long long walk_lay(const Step& st, int TR, int resident, bool bwd, Lay& L,
                   const Net* critic = nullptr) {
  const int TRP = TR + 4;
  L.TR = TR;
  L.TRP = TRP;
  L.resident = resident;
  const Net* nets[3] = {&st.pol, &st.dyn, critic};
  const int nn = critic ? 3 : 2;
  long long off = 0;
  for (int id = 0; id < 3; ++id)
    for (int l = 0; l < kMaxLayers; ++l) {
      if (id < 2) L.w_off[id][l] = 0;
      L.asm_off[id][l] = 0;
      L.msk_off[id][l] = 0;
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
  for (int l = 0; l <= kMaxLayers; ++l) L.dw_flat[l] = 0;
  for (int l = 0; l <= st.pol.n; ++l) {
    const int din = st.pol.dims[l], dout = st.pol.dims[l + 1];
    L.dw_off[l] = dw;
    dw += round4(ceil_div(din, kCluster)) * round4(dout) + round4(dout);
    flat += din * dout + dout;
    L.dw_flat[l + 1] = flat;
  }
  L.dw_cta = dw;
  if (L.resident && bwd) off += dw;
  for (int id = 0; id < 2; ++id)
    for (int l = 0; l < kMaxLayers; ++l) {
      L.bias_off[id][l] = 0;
      L.msk_off[id][l] = 0;
      if (l > nets[id]->n) continue;
      L.bias_off[id][l] = static_cast<int>(off);
      off += round4(nets[id]->dims[l + 1]);
    }
  int kwmax = 0, outmax = 0, wmax = 0;
  for (int id = 0; id < nn; ++id) {
    kwmax = max(kwmax, net_kwmax(*nets[id]));
    outmax = max(outmax, nets[id]->dims[nets[id]->n + 1]);
    wmax = max(wmax, nets[id]->maxw);
  }
  const int rw = max(max(kCluster * kwmax, wmax), kCluster * outmax);
  L.rfl = rw * TRP;
  L.region[0] = static_cast<int>(off);
  L.region[1] = static_cast<int>(off + L.rfl);
  off += 2LL * L.rfl;
  const int kw4 = round4(kwmax);
  L.h = static_cast<int>(off);
  off += (long long)kw4 * TRP;
  // the MLP inputs' arrays: kMaxIn rows, or the widest embedded input's (the
  // critic's too: its input and its input mask, critic_walk.cuh)
  const int nx = max(max(kMaxIn, critic ? critic->dims[0] : 0),
                     max(st.pol.dims[0], st.dyn.dims[0]));
  L.xp = static_cast<int>(off);
  L.xd = static_cast<int>(off + nx * TRP);
  L.gx = static_cast<int>(off + 2 * nx * TRP);
  off += 3LL * nx * TRP;
  L.xq = L.xp;
  if (own_policy_input(st)) {
    L.xq = static_cast<int>(off);
    off += (long long)nx * TRP;
  }
  const long long base = off;
  long long ends[3] = {off, off, off};
  for (int id = 0; id < nn; ++id) {
    long long o = id == 2 ? base : off;
    for (int l = 0; l < nets[id]->n; ++l) {
      const long long slice = (long long)round4(ceil_div(nets[id]->dims[l + 1], kCluster)) * TRP;
      L.asm_off[id][l] = static_cast<int>(o);
      L.msk_off[id][l] = static_cast<int>(bwd ? o + slice : o);
      o += bwd ? 2 * slice : slice;
    }
    ends[id] = o;
    if (id < 2) off = o;
  }
  off = max(off, ends[2]);
  L.tsm = static_cast<int>(off);
  off += (long long)kTSmall * TRP;
  L.mix = static_cast<int>(off);
  if (st.K) off += (long long)(st.dyn.dims[st.dyn.n + 1] + st.K + 1) * TRP;
  L.opre = 0;
  if (has_out_act(st)) {
    L.opre = static_cast<int>(off);
    off += (long long)(st.pol.dims[st.pol.n + 1] + st.dyn.dims[st.dyn.n + 1]) * TRP;
  }
  return off;
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

bool relu_only(const Net& net) {
  for (int l = 0; l < net.n; ++l)
    if (net.act[l] != kRelu) return false;
  return true;
}

}  // namespace
