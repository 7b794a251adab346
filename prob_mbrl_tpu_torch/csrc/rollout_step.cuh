// What the kernels of one MC-PILCO rollout step take, shared by fused_step.cu
// (one launch per step and direction) and fused_rollout.cu (the whole rollout
// in one launch), both through cluster_walk.cuh: the C argument block and
// its checks, the densities' clip, the 8-jitter safe Cholesky of the
// moment-matching resample and the resample's adjoint. Everything is
// float32.
//
// The step (make_step_impl of prob_mbrl_tpu/ops/pallas/fused_rollout.py,
// :1079-1129):
//   [angle-embedded, input-dropped] s -> policy MLP [-> output nonlinearity]
//   -> the policy head's sample: DiagGaussian, a TanhSquashedDensity over
//      it or a CategoricalDensity's straight-through one-hot (StepArgs::
//      pol_head) -> max_u * tanh(.) + eps
//   -> [angle-embedded] cat(s, a), whitened [, input-dropped] -> dynamics MLP
//      [-> output nonlinearity] -> scaled DiagGaussian sample, or
//      a GaussianMixtureDensity's straight-through pick of one of its K
//      scaled components (Gumbel-softmax weights, inverse-CDF hard pick)
//   -> nxt = s + delta -> the reward on the pre-MM nxt (JAX calls the env's
//      reward closure there, :579 and :1122; here one of three kinds: two of
//      the linear tip M nxt, the exp-quadratic tip reward of the swing-up
//      envs or the negative quadratic cost of rendezvous, and the lunar
//      lander's shaping potential with its gated fuel costs), or the
//      learned reward, the dynamics head's last output (:568-575, :1114-1118)
//   -> moment-matching resample of nxt (D) and of r (D = 1), Cholesky path
//      with the escalating jitter of _safe_cholesky_kf (:117-203).
#pragma once

#include "mlp_tile.cuh"

// The instance of the device code a translation unit compiles: the narrow
// one (NarrowLimits) unless it defines PMBRL_WIDE 1 before it includes this
// header (WideLimits, the *_wide.cu units, libraries of their own). Every
// array and layout below is sized by the instance's limits; the wide one
// also keeps the policy's squash and the reward's tip and target in device
// memory (StepArgs below) and factors and differentiates each moment-matching
// site on a whole warp (safe_chol_warp, chol_vjp_warp).
#ifndef PMBRL_WIDE
#define PMBRL_WIDE 0
#endif

namespace {

struct NarrowLimits {
  static constexpr int kMaxD = 8;    // state dims
  static constexpr int kMaxU = 4;    // action dims
  static constexpr int kMaxTip = 4;  // coordinates of the reward's tip
};

// D <= 16, U <= 8 and a tip over the whole state
struct WideLimits {
  static constexpr int kMaxD = 16;
  static constexpr int kMaxU = 8;
  static constexpr int kMaxTip = 16;
};

#if PMBRL_WIDE
using Limits = WideLimits;
#else
using Limits = NarrowLimits;
#endif
constexpr bool kWide = PMBRL_WIDE != 0;
constexpr int kMaxD = Limits::kMaxD;
constexpr int kMaxU = Limits::kMaxU;
constexpr int kMaxTip = Limits::kMaxTip;
constexpr int kTries = 8;    // jitters of the safe Cholesky
// widest MLP input: the dynamics' D + U with every state dim angle-embedded
constexpr int kMaxX = 2 * kMaxD + kMaxU;

// StepArgs::reward_kind, with d = (M nxt - target) / norm:
constexpr int kExpQuadReward = 0;  // r = exp(-0.5 (q |d|^2 + r_u |a|^2))
constexpr int kQuadReward = 1;     // r = -(q |d|^2 + r_u |a|^2)
// the lander (envs/jax_lander.py LanderReward; D = 8, U = 2, no tip): r =
// -(|(x0, x1)| + |(x2, x3)| + |x4|) + 0.1 (x6 + x7) - 0.3 m - 0.03 s, m and s
// the gated engine powers of the clipped action (lander_reward below)
constexpr int kLanderReward = 2;
// a learned reward (DynamicsModel without reward_func; no tip): the dynamics
// head has 2 (D + 1) outputs, and its output D is the reward, r = mean_D +
// z_D exp(ls_D), sampled like the state deltas but added to nothing
constexpr int kLearnedReward = 3;

// StepArgs::pol_head, the policy's density (JAX models/densities.py):
constexpr int kHeadDiag = 0;  // DiagGaussianDensity(U): y = mean + z exp(upper_clip(lsr))
// TanhSquashedDensity(DiagGaussianDensity(U)): y = head_scale tanh(u) + head_bias
// of the Gaussian sample u (:206-216)
constexpr int kHeadTanh = 1;
// CategoricalDensity(U): the MLP has U outputs x; soft = softmax((log_softmax(x)
// + z) / head_temp), the hard pick idx = sum_j (u_pol > cumsum(soft)_j) and y =
// (onehot(idx) - soft) + soft, forward the one-hot, backward through soft (:170-183)
constexpr int kHeadCat = 2;

}  // namespace

// ---- the C interface's argument block (mirrored by ctypes) ----------------
// Outside the unnamed namespace: the extern "C" functions that take it must
// keep external linkage.

struct MlpArgs {
  int n;  // hidden layers
  int dims[kMaxLayers + 1];
  int act[kMaxLayers];
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];  // null where absent
  const float* m[kMaxLayers];  // hidden-layer masks [B, d] or null
};

#if !PMBRL_WIDE
struct StepArgs {
  int B, D, U, ntip;
  int reward_kind;      // kExpQuadReward, kQuadReward, kLanderReward or kLearnedReward
  int K;                // components of a mixture dynamics head; 0: diagonal
  MlpArgs pol, dyn;
  const float* states;  // [B, D]
  const float* eps;     // [B, U] or null (zero)
  const float* z_pol;   // [B, U] policy density noise
  const float* z_dyn;   // [B, E] dynamics density noise (E = D, or D + 1 with
                        //   kLearnedReward: the head's outputs); a mixture's
                        //   z_normal
  const float* mx;      // [D + U] input whitening: (x - mx) * isx
  const float* isx;
  const float* my;      // [E] output scaling: mean * sy + my, log_std + log(sy)
  const float* sy;
  const float* z_mm;    // [B, D] standardized MM noise of this step (or null)
  const float* z_rr;    // [B, 1]
  const float* z_pi;    // [B, K] a mixture's Gumbel noise (or null)
  const float* u_cat;   // [B, 1] a mixture's uniform of the hard pick (or null)
  float pol_upper, dyn_upper;  // log(max_noise_std) of each density
  float act_scale[kMaxU], act_bias[kMaxU];
  float tip[kMaxTip * kMaxD];  // tip = tip_matrix @ nxt, [ntip, D] row-major
  float target[kMaxTip];
  float norm, q_scale, r_scale;
  // the model options of the policy's MLP ([0]) and the dynamics' ([1]):
  const float* m_in[2];  // input dropout mask [B, din] (null: none)
  int out_act[2];        // output nonlinearity (an Act; kIdentity: none)
  // MLP input k is in_map[net][k] = 3 i + kind of source i (the states, then
  // the actions for the dynamics): kind 0 the value, 1 its sin, 2 its cos
  // (ops/angles.py to_complex: the other dims, then sin, then cos); bytes,
  // as Step is a kernel parameter, with the others within 4 KB
  signed char in_map[2][kMaxX];
  // the policy's head (kHeadDiag, kHeadTanh or kHeadCat): a TanhSquashedDensity's
  // own scale and bias (before the Policy's act_scale / act_bias), a
  // CategoricalDensity's sampling temperature and its uniform [B, 1] (else null)
  int pol_head;
  float head_scale, head_bias, head_temp;
  const float* u_pol;
};
#else
// The wide instance's: the policy's squash and the tip in device memory.
struct StepArgs {
  int B, D, U, ntip;
  int reward_kind;      // kExpQuadReward, kQuadReward, kLanderReward or kLearnedReward
  int K;                // components of a mixture dynamics head; 0: diagonal
  MlpArgs pol, dyn;
  const float* states;  // [B, D]
  const float* eps;     // [B, U] or null (zero)
  const float* z_pol;   // [B, U] policy density noise
  const float* z_dyn;   // [B, E] dynamics density noise (E = D, or D + 1 with
                        //   kLearnedReward: the head's outputs); a mixture's
                        //   z_normal
  const float* mx;      // [D + U] input whitening: (x - mx) * isx
  const float* isx;
  const float* my;      // [E] output scaling: mean * sy + my, log_std + log(sy)
  const float* sy;
  const float* z_mm;    // [B, D] standardized MM noise of this step (or null)
  const float* z_rr;    // [B, 1]
  const float* z_pi;    // [B, K] a mixture's Gumbel noise (or null)
  const float* u_cat;   // [B, 1] a mixture's uniform of the hard pick (or null)
  float pol_upper, dyn_upper;  // log(max_noise_std) of each density
  // in device memory: act_scale, act_bias [U]; tip = tip_matrix @ nxt,
  // [ntip, D] row-major; target [ntip] (null with ntip 0)
  const float *act_scale, *act_bias, *tip, *target;
  float norm, q_scale, r_scale;
  // the model options of the policy's MLP ([0]) and the dynamics' ([1]):
  const float* m_in[2];  // input dropout mask [B, din] (null: none)
  int out_act[2];        // output nonlinearity (an Act; kIdentity: none)
  // MLP input k is in_map[net][k] = 3 i + kind of source i (the states, then
  // the actions for the dynamics): kind 0 the value, 1 its sin, 2 its cos
  // (ops/angles.py to_complex: the other dims, then sin, then cos); bytes,
  // as Step is a kernel parameter, with the others within 4 KB
  signed char in_map[2][kMaxX];
  // the policy's head (kHeadDiag, kHeadTanh or kHeadCat): a TanhSquashedDensity's
  // own scale and bias (before the Policy's act_scale / act_bias), a
  // CategoricalDensity's sampling temperature and its uniform [B, 1] (else null)
  int pol_head;
  float head_scale, head_bias, head_temp;
  const float* u_pol;
};
#endif

namespace {

// ---- what the kernels take --------------------------------------------------

struct Step {
  Net pol, dyn;
  int B, D, U, ntip, reward_kind, K;
  const float *states, *eps, *z_pol, *z_dyn, *mx, *isx, *my, *sy, *z_mm, *z_rr, *z_pi, *u_cat;
  float pol_upper, dyn_upper;
#if PMBRL_WIDE
  // in device memory (StepArgs): Step is a kernel parameter, and a 16 x 16
  // tip alone would take 1 KB of the 4 KB
  const float *act_scale, *act_bias, *tip, *target;
#else
  float act_scale[kMaxU], act_bias[kMaxU];
  float tip[kMaxTip * kMaxD], target[kMaxTip];
#endif
  float norm, q_scale, r_scale;
  const float* m_in[2];
  int out_act[2];
  signed char in_map[2][kMaxX];
  int pol_head;
  float head_scale, head_bias, head_temp;
  const float* u_pol;
};

// The policy MLP's outputs for U actions: the Gaussian heads' means and raw
// log-stds (2 U), a categorical head's U logits.
__host__ __device__ __forceinline__ int pol_width(int pol_head, int U) {
  return pol_head == kHeadCat ? U : 2 * U;
}

__device__ __forceinline__ float softplus_f(float y) {
  return y > 20.f ? y : log1pf(expf(y));  // torch.nn.functional.softplus
}

// ops.math.softplus_upper_clip: -softplus(upper - x) + upper; its derivative
// is sigmoid(upper - x).
__device__ __forceinline__ float upper_clip(float x, float upper) {
  return -softplus_f(upper - x) + upper;
}

__device__ __forceinline__ float sigmoid_f(float y) { return 1.f / (1.f + expf(-y)); }

// ---- the lander's reward (kLanderReward) and its VJP, one row ---------------

// clip(a, -1, 1) and its derivative as JAX's min-of-max clip has it: 1 inside,
// 0.5 at exactly +-1 (the tie splits), 0 outside. A saturated tanh policy
// with max_u = 1 sits exactly on the tie.
__device__ __forceinline__ float clip1(float a) { return fminf(fmaxf(a, -1.f), 1.f); }
__device__ __forceinline__ float clip1_grad(float a) {
  return (a > -1.f && a < 1.f) ? 1.f : (a == 1.f || a == -1.f) ? 0.5f : 0.f;
}

// r(x, a) in the plain version's order of operations: 0.01 shaping - 0.3 m -
// 0.03 s, shaping = -100 |(x0, x1)| - 100 |(x2, x3)| - 100 |x4| + 10 x6 + 10 x7,
// m = 0.5 + 0.5 c0 where c0 > 0, s = |c1| where |c1| > 0.5 (c = clip1(a)).
__device__ __forceinline__ float lander_reward(const float* x, const float* a) {
  const float c0 = clip1(a[0]), c1 = clip1(a[1]);
  const float m = c0 > 0.f ? 0.5f + 0.5f * c0 : 0.f;
  const float ac1 = c1 >= 0.f ? c1 : -c1;
  const float s = ac1 > 0.5f ? ac1 : 0.f;
  const float ax4 = x[4] >= 0.f ? x[4] : -x[4];
  const float shaping = -100.f * sqrtf(x[0] * x[0] + x[1] * x[1])
                        - 100.f * sqrtf(x[2] * x[2] + x[3] * x[3]) - 100.f * ax4
                        + 10.f * x[6] + 10.f * x[7];
  return 0.01f * shaping - 0.3f * m - 0.03f * s;
}

// gr times the reward's gradient wrt x (gx [8]) and wrt a (ga [2]), with JAX's
// conventions at the kinks: d|x4|/dx4 = +1 at 0, clip1_grad at the bounds, and
// NaN from a norm at exactly 0 (-0 / 0), as the plain version has it.
__device__ __forceinline__ void lander_reward_vjp(const float* x, const float* a, float gr,
                                                  float* gx, float* ga) {
  const float n1 = sqrtf(x[0] * x[0] + x[1] * x[1]);
  const float n2 = sqrtf(x[2] * x[2] + x[3] * x[3]);
  gx[0] = gr * (-x[0] / n1);
  gx[1] = gr * (-x[1] / n1);
  gx[2] = gr * (-x[2] / n2);
  gx[3] = gr * (-x[3] / n2);
  gx[4] = x[4] >= 0.f ? -gr : gr;
  gx[5] = 0.f;
  gx[6] = 0.1f * gr;
  gx[7] = 0.1f * gr;
  const float c0 = clip1(a[0]), c1 = clip1(a[1]);
  ga[0] = c0 > 0.f ? (-0.3f * 0.5f) * clip1_grad(a[0]) * gr : 0.f;
  ga[1] = (c1 > 0.5f || c1 < -0.5f)
              ? -0.03f * (c1 >= 0.f ? 1.f : -1.f) * clip1_grad(a[1]) * gr
              : 0.f;
}

// The dynamics density's outputs: the D state deltas, and the reward after
// them where it is learned.
__host__ __device__ __forceinline__ int head_dims(int reward_kind, int D) {
  return reward_kind == kLearnedReward ? D + 1 : D;
}

// The dynamics MLP's outputs for E head dims: a diagonal head's means and
// raw log-stds (2 E); a mixture's K means and raw log-stds of each dim (laid
// out [E][K]: entry (e, j) at e K + j), K logits and the log temperature.
__host__ __device__ __forceinline__ int head_width(int K, int E) {
  return K ? 2 * E * K + K + 1 : 2 * E;
}

// ---- moment matching: the factor and the adjoint, on one thread -----------

// Outer-product Cholesky of S + jitter I (the unrolled small_cholesky). False
// as soon as a pivot^2 <= tol2 (the block is bad, _safe_cholesky_kf's test).
__device__ bool chol_try(const float* S, int D, float jitter, float tol2, float* L) {
  float A[kMaxD * kMaxD];
  for (int i = 0; i < D * D; ++i) A[i] = S[i];
  for (int i = 0; i < D; ++i) A[i * D + i] += jitter;
  for (int j = 0; j < D; ++j) {
    const float piv2 = A[j * D + j];
    if (!(piv2 > tol2)) return false;
    const float p = sqrtf(piv2);
    for (int i = 0; i < D; ++i) L[i * D + j] = i >= j ? A[i * D + j] / p : 0.f;
    for (int i = j + 1; i < D; ++i)
      for (int k = j + 1; k < D; ++k) A[i * D + k] -= L[i * D + j] * L[k * D + j];
  }
  return true;
}

// _safe_cholesky_kf: jitters 1e-12 * 100^i times mean|diag S| (no gradient),
// the first whose pivots all exceed 1e-5 sqrt(scale); NaN when none does.
__device__ bool safe_chol(const float* S, int D, float* L) {
  float scale = 0.f;
  for (int i = 0; i < D; ++i) scale += fabsf(S[i * D + i]);
  scale = scale / D + 1e-30f;
  const float tol = 1e-5f * sqrtf(scale);
  const float jitters[kTries] = {1e-12f, 1e-10f, 1e-8f, 1e-6f, 1e-4f, 1e-2f, 1.f, 1e2f};
  for (int g = 0; g < kTries; ++g)
    if (chol_try(S, D, jitters[g] * scale, tol * tol, L)) return true;
  for (int i = 0; i < D * D; ++i) L[i] = __int_as_float(0x7fc00000);
  return false;
}

// Reverse of chol_try's loop at the chosen jitter: gradient wrt S (lower
// triangle, where the loop reads) from the gradient gL wrt L (lower part).
// Uses A_j[i, j] = L[i, j] * L[j, j] for i >= j.
__device__ void chol_vjp(const float* L, const float* gL, int D, float* gS) {
  for (int i = 0; i < D * D; ++i) gS[i] = 0.f;
  for (int j = D - 1; j >= 0; --j) {
    const float p = L[j * D + j];
    float gc[kMaxD];
    for (int i = j; i < D; ++i) {
      float g = gL[i * D + j];
      for (int k = j; k < D; ++k) g -= (gS[i * D + k] + gS[k * D + i]) * L[k * D + j];
      gc[i] = g;
    }
    float gp = 0.f;
    for (int i = j; i < D; ++i) {
      gp -= gc[i] * L[i * D + j] / p;
      gS[i * D + j] += gc[i] / p;
    }
    gS[j * D + j] += gp / (2.f * p);
  }
}

// The VJP of out = m + z L^T: from g_m = sum_b g[b] (gm) and g_L[i, j] =
// sum_b g[b, i] z[b, j] (gL, lower part; zero above), the Cholesky adjoint
// gives G wrt S (NaN when the factor failed, ok false); S = d^T d / (B - 1),
// d = x - m, so g_x[b] = H d[b] + c0 with H = (G + G^T) / (B - 1) and
// c0 = (g_m - H sum_b d[b]) / B. One thread.
__device__ void mm_vjp_coeffs(const float* L, bool ok, const float* gm, const float* gL,
                              const float* sd, int B, int D, float* H, float* c0) {
  float G[kMaxD * kMaxD];
  if (ok) {
    chol_vjp(L, gL, D, G);
  } else {
    for (int i = 0; i < D * D; ++i) G[i] = __int_as_float(0x7fc00000);
  }
  for (int i = 0; i < D; ++i)
    for (int k = 0; k < D; ++k) H[i * D + k] = (G[i * D + k] + G[k * D + i]) / (B - 1);
  for (int i = 0; i < D; ++i) {
    float hs = 0.f;
    for (int k = 0; k < D; ++k) hs += H[i * D + k] * sd[k];
    c0[i] = (gm[i] - hs) / B;
  }
}

#if PMBRL_WIDE
// ---- the same on a whole warp (the wide instance) ---------------------------
// Lane i < D owns row i; every lane of the warp calls them. Each entry takes
// the one-thread versions' operations in their order: D steps of O(D) work a
// lane where one thread did O(D^3).

// chol_try with lane i's row of A in registers: column j's pivot comes from
// lane j by __shfl_sync, L[k, j] of the update from lane k. L (D x D, shared
// memory) is whole after the closing __syncwarp.
__device__ bool chol_try_warp(const float* S, int D, float jitter, float tol2, float* L) {
  const int i = threadIdx.x & 31;
  float a[kMaxD];
#pragma unroll
  for (int k = 0; k < kMaxD; ++k) {
    const float s = i < D && k < D ? S[i * D + k] : 0.f;
    a[k] = k == i ? s + jitter : s;
  }
  bool ok = true;
  for (int j = 0; j < D && ok; ++j) {
    float aj = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxD; ++k)
      if (k == j) aj = a[k];
    const float piv2 = __shfl_sync(0xffffffffu, aj, j);
    if (!(piv2 > tol2)) {
      ok = false;
      break;
    }
    const float p = sqrtf(piv2);
    const float lij = i >= j ? aj / p : 0.f;
    if (i < D) L[i * D + j] = lij;
#pragma unroll
    for (int k = 0; k < kMaxD; ++k) {
      const float lkj = __shfl_sync(0xffffffffu, lij, k);
      if (k > j && k < D) a[k] -= lij * lkj;
    }
  }
  __syncwarp();
  return ok;
}

// safe_chol on a warp: the same scale, tolerance and jitters, NaN when none
// is ok.
__device__ bool safe_chol_warp(const float* S, int D, float* L) {
  float scale = 0.f;
  for (int i = 0; i < D; ++i) scale += fabsf(S[i * D + i]);
  scale = scale / D + 1e-30f;
  const float tol = 1e-5f * sqrtf(scale);
  const float jitters[kTries] = {1e-12f, 1e-10f, 1e-8f, 1e-6f, 1e-4f, 1e-2f, 1.f, 1e2f};
  for (int g = 0; g < kTries; ++g)
    if (chol_try_warp(S, D, jitters[g] * scale, tol * tol, L)) return true;
  const int i = threadIdx.x & 31;
  if (i < D)
    for (int k = 0; k < D; ++k) L[i * D + k] = __int_as_float(0x7fc00000);
  __syncwarp();
  return false;
}

// chol_vjp on a warp, gS (D x D, shared memory, not gL) whole at the end:
// at column j lane i >= j forms its gc from the columns already done, then
// every lane adds gp over the rows in order (gc by __shfl_sync), then lane i
// writes its row's entry and lane j the pivot's share.
__device__ void chol_vjp_warp(const float* L, const float* gL, int D, float* gS) {
  const int i = threadIdx.x & 31;
  if (i < D)
    for (int k = 0; k < D; ++k) gS[i * D + k] = 0.f;
  __syncwarp();
  for (int j = D - 1; j >= 0; --j) {
    const float p = L[j * D + j];
    const bool mine = i >= j && i < D;
    float gc = 0.f;
    if (mine) {
      gc = gL[i * D + j];
      for (int k = j; k < D; ++k) gc -= (gS[i * D + k] + gS[k * D + i]) * L[k * D + j];
    }
    float gp = 0.f;
    for (int q = j; q < D; ++q) gp -= __shfl_sync(0xffffffffu, gc, q) * L[q * D + j] / p;
    __syncwarp();
    if (mine) gS[i * D + j] += gc / p;
    if (i == j) gS[j * D + j] += gp / (2.f * p);
    __syncwarp();
  }
}

// mm_vjp_coeffs on a warp (a factor that failed is NaN, and so is all that
// follows from it): H (D x D, shared memory) holds chol_vjp's G first, then
// (G + G^T) / (B - 1) in place; H and c0 whole at the end.
__device__ void mm_vjp_coeffs_warp(const float* L, const float* gm, const float* gL,
                                   const float* sd, int B, int D, float* H, float* c0) {
  const int i = threadIdx.x & 31;
  chol_vjp_warp(L, gL, D, H);
  float h[kMaxD];
#pragma unroll
  for (int k = 0; k < kMaxD; ++k)
    h[k] = i < D && k < D ? (H[i * D + k] + H[k * D + i]) / (B - 1) : 0.f;
  __syncwarp();
  if (i < D) {
#pragma unroll
    for (int k = 0; k < kMaxD; ++k)
      if (k < D) H[i * D + k] = h[k];
  }
  __syncwarp();
  if (i < D) {
    float hs = 0.f;
    for (int k = 0; k < D; ++k) hs += H[i * D + k] * sd[k];
    c0[i] = (gm[i] - hs) / B;
  }
  __syncwarp();
}
#endif

// ---- host side ----------------------------------------------------------------

bool fill_mlp(Net& net, const MlpArgs& a, int B) {
  if (a.n < 0 || a.n + 1 > kMaxLayers) return false;
  net.n = a.n;
  net.B = B;
  net.maxw = 0;
  for (int l = 0; l <= a.n + 1; ++l) {
    if (a.dims[l] < 1 || a.dims[l] > kMaxWidth) return false;
    net.dims[l] = a.dims[l];
    net.maxw = a.dims[l] > net.maxw ? a.dims[l] : net.maxw;
  }
  for (int l = 0; l < kMaxLayers; ++l) {
    const bool lin = l <= a.n, hid = l < a.n;
    net.w[l] = lin ? a.w[l] : nullptr;
    net.b[l] = lin ? a.b[l] : nullptr;
    net.m[l] = hid ? a.m[l] : nullptr;
    net.a[l] = nullptr;
    net.act[l] = hid ? a.act[l] : kIdentity;
    if (lin && !net.w[l]) return false;
    if (hid && (a.act[l] < 0 || a.act[l] >= kNumActs)) return false;
  }
  return true;
}

bool fill_step(Step& st, const StepArgs* a) {
  if (!a || a->B < 2 || a->D < 1 || a->D > kMaxD || a->U < 1 || a->U > kMaxU
      || a->ntip < 0 || a->ntip > kMaxTip
      || a->reward_kind < kExpQuadReward || a->reward_kind > kLearnedReward
      || a->K < 0)
    return false;
  if (a->reward_kind == kLanderReward && (a->D != 8 || a->U != 2 || a->ntip != 0)) return false;
  if (a->reward_kind == kLearnedReward && a->ntip != 0) return false;
  if (!fill_mlp(st.pol, a->pol, a->B) || !fill_mlp(st.dyn, a->dyn, a->B)) return false;
  const int D = a->D, U = a->U, E = head_dims(a->reward_kind, D);
  if (a->pol_head < kHeadDiag || a->pol_head > kHeadCat) return false;
  if (a->pol_head == kHeadCat && (!a->u_pol || !(a->head_temp > 0.f))) return false;
  if (st.pol.dims[0] < D || st.pol.dims[0] > 2 * D
      || st.pol.dims[st.pol.n + 1] != pol_width(a->pol_head, U)
      || st.dyn.dims[0] < D + U || st.dyn.dims[0] > kMaxX
      || st.dyn.dims[st.dyn.n + 1] != head_width(a->K, E))
    return false;
  for (int id = 0; id < 2; ++id) {
    const Net& net = id ? st.dyn : st.pol;
    const int sources = id ? D + U : D;
    st.m_in[id] = a->m_in[id];
    st.out_act[id] = a->out_act[id];
    if (st.out_act[id] < 0 || st.out_act[id] >= kNumActs) return false;
    for (int k = 0; k < kMaxX; ++k) {
      st.in_map[id][k] = a->in_map[id][k];
      if (k < net.dims[0] && (st.in_map[id][k] < 0 || st.in_map[id][k] >= 3 * sources))
        return false;
    }
  }
  st.B = a->B;
  st.D = D;
  st.U = U;
  st.ntip = a->ntip;
  st.reward_kind = a->reward_kind;
  st.K = a->K;
  st.states = a->states;
  st.eps = a->eps;
  st.z_pol = a->z_pol;
  st.z_dyn = a->z_dyn;
  st.mx = a->mx;
  st.isx = a->isx;
  st.my = a->my;
  st.sy = a->sy;
  st.z_mm = a->z_mm;
  st.z_rr = a->z_rr;
  st.z_pi = a->z_pi;
  st.u_cat = a->u_cat;
  if (!st.states || !st.z_pol || !st.z_dyn || !st.mx || !st.isx || !st.my || !st.sy) return false;
  if (st.K && (!st.z_pi || !st.u_cat)) return false;
  st.pol_upper = a->pol_upper;
  st.dyn_upper = a->dyn_upper;
#if PMBRL_WIDE
  st.act_scale = a->act_scale;
  st.act_bias = a->act_bias;
  st.tip = a->tip;
  st.target = a->target;
  if (!st.act_scale || !st.act_bias || (a->ntip && (!st.tip || !st.target))) return false;
#else
  for (int k = 0; k < kMaxU; ++k) {
    st.act_scale[k] = a->act_scale[k];
    st.act_bias[k] = a->act_bias[k];
  }
  for (int i = 0; i < kMaxTip * kMaxD; ++i) st.tip[i] = a->tip[i];
  for (int j = 0; j < kMaxTip; ++j) st.target[j] = a->target[j];
#endif
  st.norm = a->norm;
  st.q_scale = a->q_scale;
  st.r_scale = a->r_scale;
  st.pol_head = a->pol_head;
  st.head_scale = a->head_scale;
  st.head_bias = a->head_bias;
  st.head_temp = a->head_temp;
  st.u_pol = a->pol_head == kHeadCat ? a->u_pol : nullptr;
  return true;
}

}  // namespace
