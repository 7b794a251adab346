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
// Model options of the critic (CriticArgs::opts, a block in device memory: the
// kernel parameters hold no room for it): angle embedding of the states
// (in_map, as the rollout's MLPs have it, with the whitening over the embedded
// input), input dropout (Bernoulli or concrete: its mask formed in the kernel
// from the noise and, under each weight set, that set's logit_p, which the
// Adam step updates as a hidden layer's, and its regulariser on W_0 and b_0),
// an output nonlinearity from the kernels' set (its pre-activation kept for
// the VJPs of V0 and of the bootstrap), and spectral norm of any layer
// (CriticArgs::sn): W = c w / sigma, c = sn_max_K sigmoid(sn_scale), sigma =
// u^T w v after sn_iters power iterations from the stored sn_u. The walks
// of params and target take the host's normalized weights (one launch's);
// before the Adam step each layer's dW wrt W is chained to w and sn_scale,
// dw = (c / sigma) G - (c / sigma^2) <G, w> u v^T and d sn_scale = sn_max_K
// sigmoid'(sn_scale) <G, w> / sigma (u, v, sigma and c of params from the
// host; <G, w> summed over the launch, one more barrier), sn_u's gradient
// zero; after it block 0 forms params' sigma by its own power iteration from
// sn_u' and writes params' normalized weights, which the bootstrap walks (one
// more barrier).
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
  // logit_p of hidden layer l (concrete dropout), else null; at kLpIn that of
  // the input's concrete dropout (no hidden layer has that index)
  float* lp[kMaxLayers];
};

// The critic's model options (CriticArgs::opts; device memory).
struct CriticOpts {
  // MLP input k is in_map[k] = 3 i + kind of state i: kind 0 the value, 1 its
  // sin, 2 its cos (ops/angles.py to_complex); the identity without angles
  signed char in_map[kMaxX];
  int out_act;                // output nonlinearity (an Act; kIdentity: none)
  int in_drop;                // the input's dropout: kDropNone, kDropBernoulli, kDropConcrete
  float in_keep, in_inv_keep; // Bernoulli: p = 1 - rate and its float32 inverse
  float in_scale;             // regularizer_scale
  float in_dreg, in_inv_temp; // concrete: dropout_regularizer, the inverse temperature
  const float* in_u;          // the input dropout's noise [B, din]
  const float* in_uh;         //   and (concrete) u_hard
  // spectral norm of the layers of CriticArgs::sn
  int sn_iters;
  float sn_max_K;
  const float* wn[2][kMaxLayers];  // the normalized weights of params and target (the host's)
  float* wq[kMaxLayers];           // params' normalized weights (written by rows 3 and 5)
  const float* sn_uv[kMaxLayers];  // params' power iteration: u [din], then v [dout]
  const float* sn_k;               // [kMaxLayers][4]: params' sigma, c, sigmoid(sn_scale)
  float* sn_dots;                  // [blocks][kMaxLayers]: the launch's partials of <G, w>
  float* sn_scale[8][kMaxLayers];  // the sets' sn_scale leaves: read (ins 0-3), written (outs)
  float* sn_u[8][kMaxLayers];      //   and sn_u
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
  const CriticOpts* opts;     // the model options (device memory), or null: none
  int sn;                     // bit l: layer l has spectral norm (its fields in opts)
};

namespace {

constexpr int kDropNone = 0, kDropBernoulli = 1, kDropConcrete = 2;
constexpr int kHeadPlain = 0, kHeadGauss = 1;
constexpr int kSetP = 0, kSetT = 1, kSetQ = 2;  // params, target, params' (Crit::net)
constexpr int kLpIn = kMaxLayers - 1;  // CriticLeaves::lp of the input dropout
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
  int D;                    // the states' dims (a.dims[0] with no angle embedding)
};

// The leaves of weight set `set`: params, target or params'.
__device__ __forceinline__ const CriticLeaves& leaves_of(const CriticArgs& a, int set) {
  return set == kSetQ ? a.outs[0] : a.ins[set];
}

// The weights a walk under weight set `set` applies at layer l: the leaf, or
// under spectral norm the normalized copy (the host's for params and target,
// the launch's for params').
__device__ __forceinline__ const float* set_weight(const CriticArgs& a, int set, int l) {
  if (!(a.sn >> l & 1)) return leaves_of(a, set).w[l];
  return set == kSetQ ? a.opts->wq[l] : a.opts->wn[set][l];
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

// The dropout before Linear layer l, which its regulariser pairs with it:
// the input's (l = 0, CriticArgs::opts) or hidden layer l - 1's, under the
// logit_p of the leaves P.
struct Drop {
  int drop;                 // kDropNone, kDropBernoulli or kDropConcrete
  float keep, scale, dreg;  // Bernoulli's p; regularizer_scale; dropout_regularizer
  const float* lp;          // concrete: logit_p
};

__device__ __forceinline__ Drop drop_before(const CriticArgs& a, const CriticLeaves& P, int l) {
  if (l >= 1) return {a.drop[l - 1], a.keep[l - 1], a.scale[l - 1], a.dreg[l - 1], P.lp[l - 1]};
  if (!a.opts) return {kDropNone, 0.f, 0.f, 0.f, nullptr};
  const CriticOpts& o = *a.opts;
  return {o.in_drop, o.in_keep, o.in_scale, o.in_dreg, P.lp[kLpIn]};
}

// The keep probability of unit k of dropout d: sigmoid(logit_p) (concrete)
// or p (Bernoulli).
__device__ __forceinline__ float keep_prob(const Drop& d, int k) {
  if (d.drop == kDropBernoulli) return d.keep;
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-d.lp[k])));
}

// The critic's input with its options (out of line, so that a critic without
// them keeps its registers), all of it into lay.xp ([din][TRP], zeros past
// nrows): each input's source state (srows, [nrows][D] row-major) or its sin
// or cos (in_map), whitened, times the input dropout's mask under weight set
// `set` (formed here as the hidden layers' are, and kept in lay.xd, free
// while the critic walks, for the bootstrap's input gradient).
__device__ __noinline__ void critic_option_input(const Ctx& c, const Crit& cr, int set,
                                                 const float* srows, int row0, int nrows) {
  const CriticArgs& a = cr.a;
  const CriticOpts& o = *a.opts;
  const int din = a.dims[0], D = cr.D, TR = c.lay.TR, TRP = c.lay.TRP;
  const float* lp = leaves_of(a, set).lp[kLpIn];
  float* xp = c.sm + c.lay.xp;
  float* msk = c.sm + c.lay.xd;
  for (int e = threadIdx.x; e < din * TR; e += blockDim.x) {
    const int k = e / TR, r = e - k * TR;
    float v = 0.f, m = 1.f;
    if (r < nrows) {
      const int code = o.in_map[k], i = code / 3, kind = code - 3 * i;
      const float x = srows[r * D + i];
      v = kind == 0 ? x : kind == 1 ? sinf(x) : cosf(x);
      v = (v - a.mx[k]) * a.isx[k];
      const size_t j = (size_t)(row0 + r) * din + k;
      if (o.in_drop == kDropBernoulli) m = o.in_u[j] < o.in_keep ? o.in_inv_keep : 0.f;
      else if (o.in_drop == kDropConcrete) m = concrete_mask(lp[k], o.in_u[j], o.in_uh[j], o.in_inv_temp);
      v *= m;
    }
    xp[k * TRP + r] = v;
    msk[k * TRP + r] = r < nrows ? m : 0.f;
  }
}

// The critic's output nonlinearity on the tile's outputs at kTDout, its
// pre-activations kept two rows further (rows the critic's head leaves free);
// with vjp, its VJP on the gradient wrt the outputs X in place instead.
__device__ __noinline__ void critic_out_act(const Ctx& c, const Crit& cr, int nrows, bool vjp,
                                            float* X = nullptr) {
  const int act = cr.a.opts->out_act, rows = cr.a.dims[cr.a.n + 1];
  const int TR = c.lay.TR, TRP = c.lay.TRP;
  float* out = c.sm + c.lay.tsm + kTDout * TRP;
  float* pre = out + 2 * TRP;
  for (int e = threadIdx.x; e < rows * TR; e += blockDim.x) {
    const int k = e / TR, r = e - k * TR;
    if (vjp) {
      X[k * TRP + r] = act_vjp(act, pre[k * TRP + r], X[k * TRP + r]);
      continue;
    }
    const float v = out[k * TRP + r];
    pre[k * TRP + r] = v;
    out[k * TRP + r] = r < nrows ? act_fwd(act, v) : 0.f;
  }
}

// The bootstrap's gradient wrt the states from gx, the gradient wrt the
// critic's input: times the input mask (lay.xd) and the whitening, then onto
// each input's source state (a value passes, d sin x = cos x, d cos x = -sin
// x), in the inputs' order, into GS ([nrows][D]).
__device__ __noinline__ void critic_option_grad(const Ctx& c, const Crit& cr, const float* gx,
                                                const float* srows, float* GS, int nrows) {
  const CriticArgs& a = cr.a;
  const int din = a.dims[0], D = cr.D, TRP = c.lay.TRP;
  const float* msk = c.sm + c.lay.xd;
  for (int e = threadIdx.x; e < nrows * D; e += blockDim.x) {
    const int r = e / D, i = e - r * D;
    const float x = srows[r * D + i];
    float g = 0.f;
    for (int k = 0; k < din; ++k) {
      const int code = a.opts->in_map[k];
      if (code / 3 != i) continue;
      const int kind = code - 3 * i;
      const float v = gx[k * TRP + r] * msk[k * TRP + r] * a.isx[k];
      g += kind == 0 ? v : kind == 1 ? v * cosf(x) : -(v * sinf(x));
    }
    GS[r * D + i] = g;
  }
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
  const int D = a.dims[0], tid = threadIdx.x, nt = blockDim.x;  // D: the input's width
  const int TR = c.lay.TR, TRP = c.lay.TRP;
  __syncthreads();  // every read of cn's last weights is done
  if (tid == 0)
    for (int l = 0; l <= a.n; ++l) {
      cn.w[l] = set_weight(a, set, l);
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
  if (a.opts) {
    critic_option_input(c, cr, set, srows, row0, nrows);
  } else {
    for (int e = tid; e < D * TR; e += nt) {
      const int k = e / TR, r = e - k * TR;
      xp[k * TRP + r] = r < nrows ? (srows[r * D + k] - a.mx[k]) * a.isx[k] : 0.f;
    }
  }
  __syncthreads();
  mlp_fwd<kReluOnly>(c, cn, kCriticNet, c.lay.xp, keep, c.lay.tsm + kTDout * TRP, row0, nrows);
  if (a.opts && a.opts->out_act != kIdentity) {
    critic_out_act(c, cr, nrows, false);
    __syncthreads();
  }
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
  for (int l = 0; l <= a.n; ++l) {  // each Linear layer after a dropout
    const Drop dr = drop_before(a, P, l);
    if (dr.drop == kDropNone) continue;
    const int w = a.dims[l], d = a.dims[l + 1];
    const float* W = P.w[l];
    const float s = dr.scale;
    for (int k = tid; k < w; k += nt) {
      float s2 = 0.f;
      for (int j = 0; j < d; ++j) s2 += W[(size_t)k * d + j] * W[(size_t)k * d + j];
      const float p = keep_prob(dr, k);
      float r = 0.5f * s * (p * s2);
      if (dr.drop == kDropConcrete) r += dr.dreg * (p * logf(p) + (1.f - p) * logf(1.f - p));
      v += r;
    }
    if (P.b[l])
      for (int j = tid; j < d; j += nt) v += 0.5f * s * (P.b[l][j] * P.b[l][j]);
  }
  return a.reg_weight * block_sum(v, red);
}

// Entry e of the critic's leaves, in the order W_0, b_0, W_1, b_1, ... (b_l
// where the layer has one), then logit_p of each concrete hidden layer and of
// a concrete input dropout (l = kLpIn), then each spectral-norm layer's
// sn_scale and sn_u: kind 0 (W), 1 (b), 2 (logit_p), 3 (sn_scale) or 4
// (sn_u), the layer l and the index i in the leaf.
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
  if (P.lp[kLpIn]) {  // the input's concrete dropout
    if (e < a.dims[0]) {
      kind = 2;
      l = kLpIn;
      i = e;
      return true;
    }
    e -= a.dims[0];
  }
  for (l = 0; l <= a.n; ++l) {  // spectral norm: sn_scale, then sn_u
    if (!(a.sn >> l & 1)) continue;
    if (e < 1 + a.dims[l]) {
      kind = e ? 4 : 3;
      i = e ? e - 1 : 0;
      return true;
    }
    e -= 1 + a.dims[l];
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
// The V0 backward's gradient of entry i of layer l's W (kind 0) or b (kind
// 1): the clusters' accumulators (part: [cluster][CTA rank][cdw_cta], the CTA
// owning the row of W or the column of b) summed in cluster order.
__device__ float summed_grad(const Ctx& c, const CriticArgs& a, const float* part, int kind,
                             int l, int i) {
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
  float g = 0.f;
  for (int cc = 0; cc < c.lay.clusters; ++cc)
    g += part[(size_t)(cc * kCluster + rank) * c.lay.cdw_cta + off];
  return g;
}

// This block's partial of <G, w> of each spectral-norm layer (G: the dW wrt
// its normalized weight, summed_grad; w its params' leaf), in a fixed order,
// into opts->sn_dots[block]; the launch's barrier follows.
__device__ __noinline__ void critic_sn_dots(const Ctx& c, const Crit& cr, const float* part,
                                            float* red) {
  const CriticArgs& a = cr.a;
  const int stride = gridDim.x * blockDim.x;
  for (int l = 0; l <= a.n; ++l) {
    if (!(a.sn >> l & 1)) continue;
    const int n = a.dims[l] * a.dims[l + 1];
    float v = 0.f;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
      v += summed_grad(c, a, part, 0, l, i) * a.ins[0].w[l][i];
    v = block_sum(v, red);
    if (threadIdx.x == 0) a.opts->sn_dots[blockIdx.x * kMaxLayers + l] = v;
  }
}

__device__ void critic_adam(const Ctx& c, const Crit& cr, const float* part) {
  const CriticArgs& a = cr.a;
  const CriticLeaves& P = a.ins[0];
  const int cnt = *a.count + 1;
  const float cf = static_cast<float>(cnt);
  const float bc1 = __fsub_rn(1.f, powf(a.b1, cf)), bc2 = __fsub_rn(1.f, powf(a.b2, cf));
  const int stride = gridDim.x * blockDim.x;
  __shared__ float dots[kMaxLayers];  // <G, w> of each spectral-norm layer, over the launch
  if (a.sn && threadIdx.x == 0)
    for (int l = 0; l <= a.n; ++l) {
      float v = 0.f;
      for (int b = 0; a.sn >> l & 1 && b < (int)gridDim.x; ++b) v += a.opts->sn_dots[b * kMaxLayers + l];
      dots[l] = v;
    }
  __syncthreads();
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < cr.nflat; e += stride) {
    int kind, l, i;
    critic_leaf(a, e, kind, l, i);
    float g = 0.f, p;
    if (kind < 2) {
      const int dout = a.dims[l + 1];
      g = summed_grad(c, a, part, kind, l, i);
      if (kind == 0 && a.sn >> l & 1) {  // through W = c w / sigma
        const float* k4 = a.opts->sn_k + 4 * l;
        const float* uv = a.opts->sn_uv[l];  // u [din], then v [dout]
        const float cs = __fdiv_rn(k4[1], k4[0]), cs2 = __fdiv_rn(cs, k4[0]);
        g = cs * g - (cs2 * dots[l]) * (uv[i / dout] * uv[a.dims[l] + i % dout]);
      }
      p = kind == 0 ? P.w[l][i] : P.b[l][i];
      const Drop dr = drop_before(a, P, l);
      if (dr.drop != kDropNone) {
        const float keep = kind == 0 ? keep_prob(dr, i / dout) : 1.f;
        g += a.reg_weight * dr.scale * keep * p;
      }
    } else if (kind >= 3) {  // spectral norm: sn_scale, sn_u (no gradient)
      const float* k4 = a.opts->sn_k + 4 * l;
      g = kind == 3 ? a.opts->sn_max_K * (k4[2] * (1.f - k4[2])) * __fdiv_rn(dots[l], k4[0]) : 0.f;
      p = kind == 3 ? a.opts->sn_scale[0][l][0] : a.opts->sn_u[0][l][i];
    } else {
      const int nl = l == kLpIn ? 0 : l + 1;  // the Linear layer after the dropout
      const Drop dr = drop_before(a, P, nl);
      const int d = a.dims[nl + 1];
      const float* W = P.w[nl];
      float s2 = 0.f;
      for (int j = 0; j < d; ++j) s2 += W[(size_t)i * d + j] * W[(size_t)i * d + j];
      p = P.lp[l][i];
      const float q = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-p)));
      g = a.reg_weight * ((0.5f * dr.scale * s2 + dr.dreg * (logf(q) - logf(1.f - q))) * (q * (1.f - q)));
    }
    float* const* out[4];
    const float* const* in[4];
    for (int s = 0; s < 4; ++s) {
      const CriticLeaves& li = a.ins[s];
      const CriticLeaves& lo = a.outs[s];
      if (kind >= 3) {
        in[s] = kind == 3 ? a.opts->sn_scale[s] : a.opts->sn_u[s];
        out[s] = kind == 3 ? a.opts->sn_scale[4 + s] : a.opts->sn_u[4 + s];
        continue;
      }
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

// Block 0, after the Adam step's barrier (every other block waits at the
// next): params' sigma of each spectral-norm layer by sn_iters power
// iterations from its sn_u' on its w' (PyTorch's spectral_weight: v = w^T u /
// (|w^T u| + 1e-12), u = w v / (|w v| + 1e-12), sigma = u^T (w v)), u and v
// in this block's exchange regions (idle while the others wait), then its
// normalized weights c' w' / sigma' into opts->wq for the bootstrap.
__device__ __noinline__ void critic_sn_refresh(const Ctx& c, const Crit& cr, float* red) {
  const CriticArgs& a = cr.a;
  const CriticOpts& o = *a.opts;
  const int tid = threadIdx.x, nt = blockDim.x;
  float* u = c.sm + c.lay.region[0];
  float* v = c.sm + c.lay.region[1];
  __shared__ float bc;  // a block sum, broadcast
  for (int l = 0; l <= a.n; ++l) {
    if (!(a.sn >> l & 1)) continue;
    const int din = a.dims[l], dout = a.dims[l + 1];
    const float* w = a.outs[0].w[l];
    for (int k = tid; k < din; k += nt) u[k] = o.sn_u[4][l][k];
    __syncthreads();
    // one pass: x = w^T u (rows: v) or w v (rows: u, and wv for sigma)
    auto matvec = [&](bool transposed, float* dst, const float* src) {
      const int rows = transposed ? dout : din, cols = transposed ? din : dout;
      float s2 = 0.f;
      for (int r = tid; r < rows; r += nt) {
        float x = 0.f;
        for (int q = 0; q < cols; ++q)
          x += (transposed ? w[(size_t)q * dout + r] : w[(size_t)r * dout + q]) * src[q];
        dst[r] = x;
        s2 += x * x;
      }
      s2 = block_sum(s2, red);
      if (tid == 0) bc = s2;
      __syncthreads();
      return sqrtf(bc) + 1e-12f;
    };
    float* wv = c.sm + c.lay.region[0] + din;  // u then w v in region 0
    for (int it = 0; it < o.sn_iters; ++it) {
      const float nv = matvec(true, v, u);
      for (int j = tid; j < dout; j += nt) v[j] = v[j] / nv;
      __syncthreads();
      const float nu = matvec(false, u, v);
      for (int k = tid; k < din; k += nt) u[k] = u[k] / nu;
      __syncthreads();
    }
    matvec(false, wv, v);
    float s = 0.f;
    for (int k = tid; k < din; k += nt) s += u[k] * wv[k];
    s = block_sum(s, red);
    if (tid == 0) bc = s;
    __syncthreads();
    const float sigma = bc;
    const float cq = o.sn_max_K * __fdiv_rn(1.f, __fadd_rn(1.f, expf(-o.sn_scale[4][l][0])));
    for (int e = tid; e < din * dout; e += nt) o.wq[l][e] = __fdiv_rn(cq * w[e], sigma);
    __syncthreads();
  }
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
  // the input: the states, or with angle embedding (CriticArgs::opts) wider
  if (n < 1 || n + 1 > kMaxLayers || a->dims[0] < st.D || a->dims[0] > kMaxX) return false;
  if (a->dims[0] != st.D && !a->opts) return false;
  cr.D = st.D;
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
  // a concrete input dropout's logit_p (kLpIn) in every set, or in none
  const bool lp_in = a->ins[0].lp[kLpIn] != nullptr;
  if (lp_in && !a->opts) return false;
  int nflat = lp_in ? a->dims[0] : 0;
  if (a->sn && !a->opts) return false;
  if (a->sn >> (n + 1)) return false;  // spectral norm of a layer it has not
  for (int l = 0; l <= n; ++l)
    if (a->sn >> l & 1) nflat += 1 + a->dims[l];  // sn_scale, sn_u
  for (int io = 0; io < (refit ? 2 : 1); ++io)
    for (int s = 0; s < nsets; ++s)
      if (((io ? a->outs[s] : a->ins[s]).lp[kLpIn] != nullptr) != lp_in) return false;
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
