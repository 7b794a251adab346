// The value update's critic inside the whole-rollout kernel (fused_rollout.cu,
// rows 3-5 of PERF.md): the C argument block of the TD(H) critic refit, the
// critic's MLP on a tile of a cluster's rows through the cluster walk of
// cluster_walk.cuh, its dropout masks formed in the kernel, its head, its
// regulariser, and the Adam step with the polyak target.
//
// Replaces the critic part of make_loss_impl (prob_mbrl_tpu/ops/pallas/
// fused_rollout.py:507-516, :615-660), where JAX traces value_update.core
// (prob_mbrl_tpu/algorithms/value.py:60-94) inside the Pallas kernels of rows
// 3-5: V0 = V(params, s_0) and VH = V(target, s_H) under one noise dict,
// targets = vret + w_H VH, the MSE (plain head) or the Gaussian NLL
// (DiagGaussianDensity(1) head) of V0 against them plus reg_weight times the
// dropout regulariser, one Adam step (optax's), the polyak target, then the
// bootstrap w_H V(params', s_T).
//
// Design. The critic (netid kCriticNet of the walks) is walked on the same
// tiles of the same cluster rows as the rollout, split over the cluster's 8
// CTAs by weight rows, one cluster barrier a layer. The refit reads three
// weight sets (params, target and params'), so its weights and biases are
// read in place from global memory / L2, never staged; its kept
// pre-activation and mask slices reuse the policy's and the dynamics' room.
// The masks are formed in the kernel from logit_p and the noise (u, u_hard)
// in ConcreteDropoutSpec.mask's order of operations on the card (so a mask
// flips against the plain version only where the two sides' logit_p differ:
// params' is computed twice), or as BernoulliDropoutSpec.mask forms them.
// Each tile's V0 backward follows its forward at once (the cotangent of a
// row is its own: no activation is kept across tiles); a CTA adds its rows
// of dW and its columns of db to its own accumulator in global scratch, in a
// fixed order, and after one barrier every thread of the launch sums the
// clusters' accumulators of its entries in cluster order and takes the Adam
// step there. No atomics on values: the results repeat bit for bit.
//
// Bound (the with-value driver's critic 5->200->200->1, B particles): the
// refit's V0 forward and backward and VH forward and the bootstrap's forward
// (and backward) are ~5 passes of ~41k MACs a particle (~0.4 GFLOP at
// B = 1000, ~6 us at the 67 TFLOP/s float32 peak); the walk is latency-bound
// like the rollout's (a cluster barrier a layer), and the refit adds two
// barriers across the launch (one with a single cluster: cluster barriers).
#pragma once

#include "cluster_walk.cuh"

// ---- the C interface's critic block (RollArgs::critic; mirrored by ctypes) --
// Outside the unnamed namespace: the extern "C" functions take it.

struct CriticLeaves {  // one set of the critic's leaves, each [din][dout], [dout], [w]
  float* w[kMaxLayers];
  float* b[kMaxLayers];   // null where the layer has no bias
  float* lp[kMaxLayers];  // logit_p of hidden layer l (concrete dropout), else null
};

struct CriticArgs {
  int n;                      // hidden layers
  int dims[kMaxLayers + 1];   // D -> ... -> 1 (plain head) or 2 (Gaussian head)
  int act[kMaxLayers];
  int drop[kMaxLayers];       // hidden layer l's dropout: kDropNone, kDropBernoulli, kDropConcrete
  int head;                   // kHeadPlain (MSE) or kHeadGauss (NLL)
  int H;                      // the TD horizon: s_H is the post-MM state after step H
  float v_wH, w_H;            // the TD targets' weight of V(target, s_H); the bootstrap's
  float neg_lr, b1, b2, omb1, omb2, eps;  // Adam: -lr, b1, b2, 1 - b1, 1 - b2, eps
  float reg_weight, tau, omtau;           // the regulariser's weight; polyak tau, 1 - tau
  float upper;                // log(max_noise_std) of the Gaussian head
  float keep[kMaxLayers];     // Bernoulli: the keep probability p = 1 - rate
  float inv_keep[kMaxLayers]; //   and its float32 inverse (the mask's value)
  float scale[kMaxLayers];    // regularizer_scale of hidden layer l's dropout
  float dreg[kMaxLayers];     // concrete: dropout_regularizer
  float inv_temp[kMaxLayers]; // concrete: the float32 inverse of the temperature
  CriticLeaves ins[4];        // params, target, Adam mu, nu (read)
  CriticLeaves outs[4];       // params', target', mu', nu' (written by rows 3 and 5)
  const int* count;           // Adam's step count (int32, read)
  int* count_out;             // count + 1
  float* v_loss;              // [1] the refit's loss before the step
  const float *mx, *isx;      // the critic's input whitening [D]
  const float *my, *sy;       // its output scaling [1]
  const float* u[kMaxLayers];   // hidden layer l's dropout noise [B, w_l]
  const float* uh[kMaxLayers];  //   and (concrete) u_hard
  const float* z;             // the Gaussian head's noise [B, 1]
  float* masks;               // debug: V(s_T)'s masks, layer l at sum_{l' < l} B w_l', or null
};

namespace {

constexpr int kDropNone = 0, kDropBernoulli = 1, kDropConcrete = 2;
constexpr int kHeadPlain = 0, kHeadGauss = 1;
constexpr int kSetP = 0, kSetT = 1, kSetQ = 2;  // params, target, params' (Crit::net)
constexpr float kHalfLog2Pi = 0.9189385332046727f;

// What the kernel takes of the critic (a kernel parameter: with the
// others within the classic 4 KB of them): the block, the count of its
// leaves' entries and the offsets of each hidden layer in a.masks. The walk's
// view of it is one Net in shared memory (critic_net), pointed at the
// weight set of each walk by critic_fwd.
struct Crit {
  CriticArgs a;
  int nflat;                // entries of the critic's leaves (critic_leaf)
  int moff[kMaxLayers];
};

// The leaves of weight set `set`: params, target or params'.
__device__ __forceinline__ const CriticLeaves& leaves_of(const CriticArgs& a, int set) {
  return set == kSetQ ? a.outs[0] : a.ins[set];
}

// The critic's Net for the walks (thread 0, before a barrier): dims,
// activations, and m[l] non-null where hidden layer l has dropout (its masks
// are formed into the tile's mask slices); critic_fwd sets w and b.
__device__ void critic_net(const Crit& cr, int B, Net& cn) {
  const CriticArgs& a = cr.a;
  cn.n = a.n;
  cn.B = B;
  cn.maxw = 0;
  for (int l = 0; l <= a.n + 1; ++l) {
    cn.dims[l] = a.dims[l];
    cn.maxw = cn.maxw > a.dims[l] ? cn.maxw : a.dims[l];
  }
  for (int l = 0; l < kMaxLayers; ++l) {
    cn.w[l] = cn.b[l] = cn.m[l] = nullptr;
    cn.a[l] = nullptr;
    cn.act[l] = l < a.n ? a.act[l] : kIdentity;
    if (l < a.n && a.drop[l] != kDropNone) cn.m[l] = a.u[l];
  }
}

// ConcreteDropoutSpec.mask(train=False) of one entry in its order of
// operations on the card: log((u + 1e-7) / (1 - (u - 1e-7))) + logit_p,
// times the float32 inverse of the temperature (PyTorch multiplies by it
// where it divides by a number on the card), sigmoid; 1 where u_hard <
// probs, else 0.
__device__ __forceinline__ float concrete_mask(float lp, float u, float uh, float inv_temp) {
  const float q = __fdiv_rn(__fadd_rn(u, 1e-7f), __fsub_rn(1.f, __fsub_rn(u, 1e-7f)));
  const float x = __fmul_rn(__fadd_rn(lp, logf(q)), inv_temp);
  const float probs = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
  return uh < probs ? 1.f : 0.f;
}

// The keep probability of unit k of hidden layer l under the logit_p lp:
// sigmoid(logit_p) (concrete) or p (Bernoulli).
__device__ __forceinline__ float keep_prob(const CriticArgs& a, const float* lp, int l, int k) {
  if (a.drop[l] == kDropBernoulli) return a.keep[l];
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-lp[k])));
}

// The tile's critic forward under weight set `set` on the states srows
// ([nrows][D] row-major, the tile's rows; shared or global memory): points
// cn at the set's weights, forms this CTA's mask slices of the hidden layers
// (with masks_out, each mask also at moff[l] + row w + column, written by
// the column's owner) and the whitened input (x - mx) isx in lay.xp (zeros
// past nrows), then walks; leaves the output [dout][TRP] at kTDout of the
// tile's small arrays in every CTA and, with keep, the hidden pre-activation
// slices (cn then still points at the set, for mlp_bwd). Ends with
// __syncthreads().
template <bool kReluOnly>
__device__ void critic_fwd(Ctx& c, const Crit& cr, Net& cn, int set, const float* srows,
                           int row0, int nrows, bool keep, float* masks_out) {
  const CriticArgs& a = cr.a;
  const CriticLeaves& lv = leaves_of(a, set);
  const int D = a.dims[0], tid = threadIdx.x, nt = blockDim.x;
  const int TR = c.lay.TR, TRP = c.lay.TRP;
  __syncthreads();  // every read of cn's last weights is done
  if (tid == 0)
    for (int l = 0; l <= a.n; ++l) {
      cn.w[l] = lv.w[l];
      cn.b[l] = lv.b[l];
    }
  for (int l = 0; l < a.n; ++l) {
    const int drop = a.drop[l];
    if (drop == kDropNone) continue;
    const int w = a.dims[l + 1];
    const Slice cs = slice_of(w, c.rank);
    const float* lp = lv.lp[l];
    float* dst = c.sm + c.lay.msk_off[kCriticNet][l];
    for (int e = tid; e < cs.cnt * TR; e += nt) {
      const int k = e / TR, r = e - k * TR, col = cs.c0 + k;
      float m = 0.f;
      if (r < nrows) {
        const size_t i = (size_t)(row0 + r) * w + col;
        m = drop == kDropBernoulli ? (a.u[l][i] < a.keep[l] ? a.inv_keep[l] : 0.f)
                                   : concrete_mask(lp[col], a.u[l][i], a.uh[l][i], a.inv_temp[l]);
        if (masks_out) masks_out[cr.moff[l] + i] = m;
      }
      dst[k * TRP + r] = m;
    }
  }
  float* xp = c.sm + c.lay.xp;
  for (int e = tid; e < D * TR; e += nt) {
    const int k = e / TR, r = e - k * TR;
    xp[k * TRP + r] = r < nrows ? (srows[r * D + k] - a.mx[k]) * a.isx[k] : 0.f;
  }
  __syncthreads();
  mlp_fwd<kReluOnly>(c, cn, kCriticNet, c.lay.xp, keep, c.lay.tsm + kTDout * TRP, row0, nrows);
}

// The head on tile row r of the critic's output (out: [dout][TRP]): the
// plain head's out Sy + my (mean; ls 0), or the Gaussian head's mean and
// log_std (DiagGaussianDensity.distribution with (my, Sy)); each product and
// sum rounded on its own, as PyTorch's separate kernels round them.
__device__ __forceinline__ void critic_head(const CriticArgs& a, const float* out, int TRP, int r,
                                            float& mean, float& ls) {
  mean = __fadd_rn(__fmul_rn(out[r], a.sy[0]), a.my[0]);
  ls = a.head == kHeadGauss ? __fadd_rn(upper_clip(out[TRP + r], a.upper), logf(a.sy[0])) : 0.f;
}

// A sample of the head: mean + z exp(ls) (Gaussian head), or the mean.
__device__ __forceinline__ float critic_sample(const CriticArgs& a, float mean, float ls, float z) {
  return a.head == kHeadGauss ? __fadd_rn(mean, __fmul_rn(z, expf(ls))) : mean;
}

// Sum over the block in a fixed order (red: 32 floats of shared memory);
// thread 0 gets it.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w];
  __syncthreads();
  return s;
}

// reg_weight times the critic's regulariser at its input params
// (MLPSpec.regularization_loss: each dropout paired with the next Linear:
// 0.5 s sum_k p_k |W[k, :]|^2 + dr sum_k (p_k log p_k + (1 - p_k) log(1 -
// p_k)) (concrete) + 0.5 s |b|^2), by one CTA in a fixed order; thread 0's
// value.
__device__ float critic_reg(const Crit& cr, float* red) {
  const CriticArgs& a = cr.a;
  const CriticLeaves& P = a.ins[0];
  const int tid = threadIdx.x, nt = blockDim.x;
  float v = 0.f;
  for (int l = 0; l < a.n; ++l) {
    if (a.drop[l] == kDropNone) continue;
    const int w = a.dims[l + 1], d = a.dims[l + 2];
    const float* W = P.w[l + 1];
    const float s = a.scale[l];
    for (int k = tid; k < w; k += nt) {
      float s2 = 0.f;
      for (int j = 0; j < d; ++j) s2 += W[(size_t)k * d + j] * W[(size_t)k * d + j];
      const float p = keep_prob(a, P.lp[l], l, k);
      float r = 0.5f * s * (p * s2);
      if (a.drop[l] == kDropConcrete) r += a.dreg[l] * (p * logf(p) + (1.f - p) * logf(1.f - p));
      v += r;
    }
    if (P.b[l + 1])
      for (int j = tid; j < d; j += nt) v += 0.5f * s * (P.b[l + 1][j] * P.b[l + 1][j]);
  }
  return a.reg_weight * block_sum(v, red);
}

// Entry e of the critic's leaves, in the order W_0, b_0, W_1, b_1, ... (b_l
// where the layer has one), then logit_p of each concrete hidden layer:
// kind 0 (W), 1 (b) or 2 (logit_p), the layer l and the index i in the leaf.
// False past the last.
__device__ bool critic_leaf(const CriticArgs& a, int e, int& kind, int& l, int& i) {
  const CriticLeaves& P = a.ins[0];
  for (l = 0; l <= a.n; ++l) {
    const int din = a.dims[l], dout = a.dims[l + 1];
    if (e < din * dout) {
      kind = 0;
      i = e;
      return true;
    }
    e -= din * dout;
    if (P.b[l]) {
      if (e < dout) {
        kind = 1;
        i = e;
        return true;
      }
      e -= dout;
    }
  }
  for (l = 0; l < a.n; ++l) {
    if (a.drop[l] != kDropConcrete) continue;
    if (e < a.dims[l + 1]) {
      kind = 2;
      i = e;
      return true;
    }
    e -= a.dims[l + 1];
  }
  return false;
}

// The Adam step of every leaf (optax.adam as algorithms/value.py's Adam
// takes it: the int32 count incremented and cast to float32, 1 - b^count in
// float32, eps outside the root) and the polyak target, spread over every
// thread of the launch, after the barrier that ends the dW accumulation.
// The gradient of an entry: the clusters' accumulators (part: [cluster][CTA
// rank][cdw_cta], the CTA owning the row of W or the column of b) summed in
// cluster order, plus reg_weight times the regulariser's: s p_k W[k, j] and
// s b_j for the Linear after a dropout, and for logit_p (0.5 s |W[k, :]|^2 +
// dr (log p_k - log(1 - p_k))) p_k (1 - p_k) (the masks are hard and
// detached: no other gradient reaches logit_p).
__device__ void critic_adam(const Ctx& c, const Crit& cr, const float* part) {
  const CriticArgs& a = cr.a;
  const CriticLeaves& P = a.ins[0];
  const int nc = c.lay.clusters, cta = c.lay.cdw_cta;
  const int cnt = *a.count + 1;
  const float cf = static_cast<float>(cnt);
  const float bc1 = __fsub_rn(1.f, powf(a.b1, cf)), bc2 = __fsub_rn(1.f, powf(a.b2, cf));
  const int stride = gridDim.x * blockDim.x;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < cr.nflat; e += stride) {
    int kind, l, i;
    critic_leaf(a, e, kind, l, i);
    float g = 0.f, p;
    if (kind < 2) {
      const int din = a.dims[l], dout = a.dims[l + 1], ld = round4(dout);
      int rank, off;
      if (kind == 0) {
        const int k = i / dout, j = i - k * dout, sw = ceil_div(din, kCluster);
        rank = k / sw;
        off = c.lay.cdw_off[l] + (k - rank * sw) * ld + j;
      } else {
        rank = i / ceil_div(dout, kCluster);
        off = c.lay.cdw_off[l] + round4(ceil_div(din, kCluster)) * ld + i;
      }
      for (int cc = 0; cc < nc; ++cc) g += part[(size_t)(cc * kCluster + rank) * cta + off];
      p = kind == 0 ? P.w[l][i] : P.b[l][i];
      if (l >= 1 && a.drop[l - 1] != kDropNone) {
        const float keep = kind == 0 ? keep_prob(a, P.lp[l - 1], l - 1, i / dout) : 1.f;
        g += a.reg_weight * a.scale[l - 1] * keep * p;
      }
    } else {
      const int d = a.dims[l + 2];
      const float* W = P.w[l + 1];
      float s2 = 0.f;
      for (int j = 0; j < d; ++j) s2 += W[(size_t)i * d + j] * W[(size_t)i * d + j];
      p = P.lp[l][i];
      const float q = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-p)));
      g = a.reg_weight * ((0.5f * a.scale[l] * s2 + a.dreg[l] * (logf(q) - logf(1.f - q)))
                          * (q * (1.f - q)));
    }
    float* const* out[4];
    const float* const* in[4];
    for (int s = 0; s < 4; ++s) {
      const CriticLeaves& li = a.ins[s];
      const CriticLeaves& lo = a.outs[s];
      in[s] = kind == 0 ? li.w : (kind == 1 ? li.b : li.lp);
      out[s] = kind == 0 ? lo.w : (kind == 1 ? lo.b : lo.lp);
    }
    const float mu = __fadd_rn(__fmul_rn(a.omb1, g), __fmul_rn(a.b1, in[2][l][i]));
    const float nu = __fadd_rn(__fmul_rn(a.omb2, __fmul_rn(g, g)), __fmul_rn(a.b2, in[3][l][i]));
    const float step = __fdiv_rn(__fdiv_rn(mu, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, bc2)), a.eps));
    const float q = __fadd_rn(p, __fmul_rn(a.neg_lr, step));
    out[0][l][i] = q;
    out[1][l][i] = __fadd_rn(__fmul_rn(a.tau, q), __fmul_rn(a.omtau, in[1][l][i]));
    out[2][l][i] = mu;
    out[3][l][i] = nu;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.count_out = cnt;
}

}  // namespace

// ---- host side ----------------------------------------------------------------

namespace {

// The kernel's view of the critic block, and in `net` its Net under
// params for the layout (false when it does not fit the rollout's models);
// refit: the entry point refits (rows 3 and 5: every set read and written),
// else it bootstraps under ins[0] alone (row 4).
bool fill_crit(Crit& cr, const CriticArgs* a, const Step& st, bool refit, Net& net) {
  if (!a) return false;
  cr = Crit{};
  cr.a = *a;
  const int n = a->n;
  if (n < 1 || n + 1 > kMaxLayers || a->dims[0] != st.D) return false;
  if (a->head != kHeadPlain && a->head != kHeadGauss) return false;
  if (a->dims[n + 1] != (a->head == kHeadGauss ? 2 : 1)) return false;
  if (!a->mx || !a->isx || !a->my || !a->sy || (a->head == kHeadGauss && !a->z)) return false;
  if (refit && (a->H < 1 || !a->count || !a->count_out || !a->v_loss)) return false;
  int moff = 0;
  for (int l = 0; l < n; ++l) {
    const int drop = a->drop[l];
    cr.moff[l] = moff;
    moff += st.B * a->dims[l + 1];
    if (drop < kDropNone || drop > kDropConcrete) return false;
    if (drop != kDropNone && !a->u[l]) return false;
    if (drop == kDropConcrete && !a->uh[l]) return false;
  }
  MlpArgs m = {};
  m.n = n;
  for (int l = 0; l <= n + 1; ++l) m.dims[l] = a->dims[l];
  for (int l = 0; l <= n; ++l) {
    m.w[l] = a->ins[0].w[l];
    m.b[l] = a->ins[0].b[l];
    if (l < n) {
      m.act[l] = a->act[l];
      m.m[l] = a->drop[l] != kDropNone ? a->u[l] : nullptr;
    }
  }
  if (!fill_mlp(net, m, st.B)) return false;
  // every set the entry point reads or writes has every leaf
  const int nsets = refit ? 4 : 1;
  int nflat = 0;
  for (int l = 0; l <= n; ++l) {
    const bool bias = a->ins[0].b[l] != nullptr;
    const bool lp = l < n && a->drop[l] == kDropConcrete;
    nflat += a->dims[l] * a->dims[l + 1] + (bias ? a->dims[l + 1] : 0) + (lp ? a->dims[l + 1] : 0);
    for (int io = 0; io < (refit ? 2 : 1); ++io)
      for (int s = 0; s < nsets; ++s) {
        const CriticLeaves& lv = io ? a->outs[s] : a->ins[s];
        if (!lv.w[l] || (lv.b[l] != nullptr) != bias || (l < n && (lv.lp[l] != nullptr) != lp))
          return false;
      }
  }
  cr.nflat = nflat;
  return true;
}

// The critic's dW accumulator of one CTA (the policy's formula): for each
// layer a block of ceil(din / 8) rows (to 4) of round4(dout) floats, then
// round4(dout) of db. Returns its floats.
int critic_dw_lay(const Net& net, Lay& L) {
  int dw = 0;
  for (int l = 0; l < kMaxLayers; ++l) L.cdw_off[l] = 0;
  for (int l = 0; l <= net.n; ++l) {
    const int din = net.dims[l], dout = net.dims[l + 1];
    L.cdw_off[l] = dw;
    dw += round4(ceil_div(din, kCluster)) * round4(dout) + round4(dout);
  }
  return dw;
}

}  // namespace
