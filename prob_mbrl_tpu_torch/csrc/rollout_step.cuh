// Device code of one MC-PILCO rollout step, shared by fused_step.cu (one
// launch per step and direction) and fused_rollout.cu (the whole rollout in
// one launch): the C argument block, the tile of rows' forward (tile_fwd) and
// backward (tile_bwd), the particle moments, the 8-jitter safe Cholesky, its
// adjoint, and the moment-matching resample and its VJP. Everything is
// float32 FMA.
//
// The step (make_step_impl of prob_mbrl_tpu/ops/pallas/fused_rollout.py,
// :1079-1129):
//   policy MLP -> DiagGaussian sample -> max_u * tanh(.) + eps
//   -> whitened cat(s, a) -> dynamics MLP -> scaled DiagGaussian sample
//   -> nxt = s + delta -> exp-quadratic tip reward on the pre-MM nxt
//   -> moment-matching resample of nxt (D) and of r (D = 1), Cholesky path
//      with the escalating jitter of _safe_cholesky_kf (:117-203).
#pragma once

#include "mlp_tile.cuh"

namespace {

constexpr int kMaxD = 8;     // state dims
constexpr int kMaxU = 4;     // action dims
constexpr int kMaxTip = 4;   // coordinates of the reward's tip
constexpr int kTries = 8;    // jitters of the safe Cholesky

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

struct StepArgs {
  int B, D, U, ntip;
  MlpArgs pol, dyn;
  const float* states;  // [B, D]
  const float* eps;     // [B, U] or null (zero)
  const float* z_pol;   // [B, U] policy density noise
  const float* z_dyn;   // [B, D] dynamics density noise
  const float* mx;      // [D + U] input whitening: (x - mx) * isx
  const float* isx;
  const float* my;      // [D] output scaling: mean * sy + my, log_std + log(sy)
  const float* sy;
  const float* z_mm;    // [B, D] standardized MM noise of this step (or null)
  const float* z_rr;    // [B, 1]
  float pol_upper, dyn_upper;  // log(max_noise_std) of each density
  float act_scale[kMaxU], act_bias[kMaxU];
  float tip[kMaxTip * kMaxD];  // tip = tip_matrix @ nxt, [ntip, D] row-major
  float target[kMaxTip];
  float norm, q_scale, r_scale;
};

namespace {

// ---- what the kernels take --------------------------------------------------

struct Step {
  Net pol, dyn;
  int B, D, U, ntip;
  const float *states, *eps, *z_pol, *z_dyn, *mx, *isx, *my, *sy, *z_mm, *z_rr;
  float pol_upper, dyn_upper;
  float act_scale[kMaxU], act_bias[kMaxU];
  float tip[kMaxTip * kMaxD], target[kMaxTip];
  float norm, q_scale, r_scale;
};

// one tile's small per-row quantities, [feature][row]
struct TileSm {
  float s[kMaxD][TM];
  float u[kMaxU][TM];        // policy sample before the squash
  float act[kMaxU][TM];      // action (+ eps)
  float p[2 * kMaxU][TM];    // policy output: mean, raw log_std
  float o[2 * kMaxD][TM];    // dynamics output: mean, raw log_std
  float nxt[kMaxD][TM];      // next state before moment matching
  float r[TM];               // reward
  float g_nxt[kMaxD][TM];    // backward: gradient wrt the pre-MM nxt
  float g_act[kMaxU][TM];    // backward: the reward's gradient wrt the action
  float g_s[kMaxD][TM];      // backward: gradient wrt the states, dynamics part
};

__device__ __forceinline__ float softplus_f(float y) {
  return y > 20.f ? y : log1pf(expf(y));  // torch.nn.functional.softplus
}

// ops.math.softplus_upper_clip: -softplus(upper - x) + upper; its derivative
// is sigmoid(upper - x).
__device__ __forceinline__ float upper_clip(float x, float upper) {
  return -softplus_f(upper - x) + upper;
}

__device__ __forceinline__ float sigmoid_f(float y) { return 1.f / (1.f + expf(-y)); }

__host__ __device__ inline int max_width(const Step& st) {
  return st.pol.maxw > st.dyn.maxw ? st.pol.maxw : st.dyn.maxw;
}

// The step's forward for one tile of rows of `states` (and `eps`, or null);
// leaves its per-row results in tl. `pol` is st.pol or a copy whose
// pre-activation pointers (a) point elsewhere. pol_a_sm / dyn_a_sm: where to
// keep the hidden pre-activations (backward).
__device__ void tile_fwd(const Step& st, const Net& pol, const float* states, const float* eps,
                         TileSm& tl, float* buf0, float* buf1, int row0, int nrows,
                         float* const* pol_a_sm, float* const* dyn_a_sm) {
  const int D = st.D, U = st.U, nt = blockDim.x, tid = threadIdx.x;
  for (int i = tid; i < TM * D; i += nt) {
    const int r = i / D, k = i - r * D;
    const float v = r < nrows ? states[(size_t)(row0 + r) * D + k] : 0.f;
    tl.s[k][r] = v;
    buf0[k * TMP + r] = v;
  }
  __syncthreads();
  float* P = mlp_rows_fwd(pol, buf0, buf1, row0, nrows, pol_a_sm, nullptr);
  for (int i = tid; i < TM * U; i += nt) {
    const int r = i / U, k = i - r * U;
    const size_t o = (size_t)(row0 + r) * U + k;
    const float mean = P[k * TMP + r], lsr = P[(U + k) * TMP + r];
    const float z = r < nrows ? st.z_pol[o] : 0.f;
    const float u = mean + z * expf(upper_clip(lsr, st.pol_upper));
    float a = st.act_scale[k] * tanhf(u) + st.act_bias[k];
    if (eps && r < nrows) a += eps[o];
    tl.p[k][r] = mean;
    tl.p[U + k][r] = lsr;
    tl.u[k][r] = u;
    tl.act[k][r] = a;
  }
  __syncthreads();
  float* xin = P == buf0 ? buf1 : buf0;
  for (int i = tid; i < TM * (D + U); i += nt) {
    const int r = i / (D + U), k = i - r * (D + U);
    const float v = k < D ? tl.s[k][r] : tl.act[k - D][r];
    xin[k * TMP + r] = r < nrows ? (v - st.mx[k]) * st.isx[k] : 0.f;
  }
  __syncthreads();
  float* O = mlp_rows_fwd(st.dyn, xin, P, row0, nrows, dyn_a_sm, nullptr);
  for (int i = tid; i < TM * D; i += nt) {
    const int r = i / D, k = i - r * D;
    const float mr = O[k * TMP + r], lsr = O[(D + k) * TMP + r];
    const float ls = upper_clip(lsr, st.dyn_upper) + logf(st.sy[k]);
    const float mean = mr * st.sy[k] + st.my[k];
    const float z = r < nrows ? st.z_dyn[(size_t)(row0 + r) * D + k] : 0.f;
    tl.o[k][r] = mr;
    tl.o[D + k][r] = lsr;
    tl.nxt[k][r] = tl.s[k][r] + (mean + z * expf(ls));
  }
  __syncthreads();
  for (int r = tid; r < TM; r += nt) {
    float q = 0.f, ua = 0.f;
    for (int j = 0; j < st.ntip; ++j) {
      float tip = 0.f;
      for (int k = 0; k < D; ++k) tip += st.tip[j * D + k] * tl.nxt[k][r];
      const float d = (tip - st.target[j]) / st.norm;
      q += d * d;
    }
    for (int k = 0; k < U; ++k) ua += tl.act[k][r] * tl.act[k][r];
    tl.r[r] = expf(-(0.5f * (st.q_scale * q + st.r_scale * ua)));
  }
  __syncthreads();
}

// What the backward of one tile reads and writes in device memory.
struct StepGrads {
  const float* g_nxt;  // [B, D] gradient wrt the pre-MM nxt
  const float* g_r;    // [B] gradient wrt the pre-MM r
  float* g_states;     // [B, D]
  float* g_eps;        // [B, U] or null
  float* g_pout;       // [B, 2U] gradient wrt the policy MLP's output
  Grads pol;           // the policy's ga scratch (dw/db are wgrad's)
};

// Dynamic shared memory of tile_bwd: two work buffers and both MLPs' hidden
// pre-activations, each a feature-major tile.
inline size_t bwd_smem(const Step& st) {
  size_t f = 2 * (size_t)max_width(st);
  for (int l = 0; l < st.pol.n; ++l) f += st.pol.dims[l + 1];
  for (int l = 0; l < st.dyn.n; ++l) f += st.dyn.dims[l + 1];
  return f * TMP * sizeof(float);
}

// Backward of one tile of rows: recompute the forward from `states` (and
// `eps`), then the VJPs in reverse order (reward, dynamics density, dynamics
// dx chain, tanh squash, policy density, policy dx chain). The policy's
// hidden pre-activations go to pol.a and their gradients to sg.pol.ga, for
// wgrad; its output's gradient to sg.g_pout.
__device__ void tile_bwd(const Step& st, const Net& pol, const float* states, const float* eps,
                         const StepGrads& sg, TileSm& tl, float* smem, int row0, int nrows) {
  const int maxw = max_width(st);
  const int D = st.D, U = st.U, nt = blockDim.x, tid = threadIdx.x;
  float* buf0 = smem;
  float* buf1 = smem + maxw * TMP;
  float* pol_a[kMaxLayers];
  float* dyn_a[kMaxLayers];
  float* next = buf1 + maxw * TMP;
  for (int l = 0; l < pol.n; ++l) {
    pol_a[l] = next;
    next += pol.dims[l + 1] * TMP;
  }
  for (int l = 0; l < st.dyn.n; ++l) {
    dyn_a[l] = next;
    next += st.dyn.dims[l + 1] * TMP;
  }
  tile_fwd(st, pol, states, eps, tl, buf0, buf1, row0, nrows, pol_a, dyn_a);

  // reward: r = exp(-cost), cost = 0.5 (q |(tip - target) / norm|^2 + rs |a|^2)
  for (int r = tid; r < TM; r += nt) {
    const float gr = r < nrows ? sg.g_r[row0 + r] : 0.f;
    const float gc = -gr * tl.r[r];
    float gtip[kMaxTip];
    for (int j = 0; j < st.ntip; ++j) {
      float tip = 0.f;
      for (int k = 0; k < D; ++k) tip += st.tip[j * D + k] * tl.nxt[k][r];
      const float d = (tip - st.target[j]) / st.norm;
      gtip[j] = gc * 0.5f * st.q_scale * 2.f * d / st.norm;
    }
    for (int k = 0; k < D; ++k) {
      float g = r < nrows ? sg.g_nxt[(size_t)(row0 + r) * D + k] : 0.f;
      for (int j = 0; j < st.ntip; ++j) g += st.tip[j * D + k] * gtip[j];
      tl.g_nxt[k][r] = g;
    }
    for (int k = 0; k < U; ++k) tl.g_act[k][r] = gc * 0.5f * st.r_scale * 2.f * tl.act[k][r];
  }
  __syncthreads();
  // nxt = s + mean * sy + my + z * exp(upper_clip(lsr) + log sy)
  for (int i = tid; i < TM * D; i += nt) {
    const int r = i / D, k = i - r * D;
    const float g = tl.g_nxt[k][r];
    const float lsr = tl.o[D + k][r];
    const float ls = upper_clip(lsr, st.dyn_upper) + logf(st.sy[k]);
    const float z = r < nrows ? st.z_dyn[(size_t)(row0 + r) * D + k] : 0.f;
    buf0[k * TMP + r] = g * st.sy[k];
    buf0[(D + k) * TMP + r] = (g * z) * expf(ls) * sigmoid_f(st.dyn_upper - lsr);
  }
  __syncthreads();
  Grads none = {};
  float* G = mlp_rows_bwd(st.dyn, none, buf0, buf1, row0, nrows, dyn_a, nullptr);
  float* gp = G == buf0 ? buf1 : buf0;
  for (int i = tid; i < TM * D; i += nt) {
    const int r = i / D, k = i - r * D;
    tl.g_s[k][r] = tl.g_nxt[k][r] + G[k * TMP + r] * st.isx[k];
  }
  // a = scale tanh(u) + bias + eps, u = mean + z exp(upper_clip(lsr))
  for (int i = tid; i < TM * U; i += nt) {
    const int r = i / U, k = i - r * U;
    const size_t o = (size_t)(row0 + r) * U + k;
    const float ga = tl.g_act[k][r] + G[(D + k) * TMP + r] * st.isx[D + k];
    if (sg.g_eps && r < nrows) sg.g_eps[o] = ga;
    const float t = tanhf(tl.u[k][r]);
    const float gu = ga * st.act_scale[k] * (1.f - t * t);
    const float lsr = tl.p[U + k][r];
    const float z = r < nrows ? st.z_pol[o] : 0.f;
    const float glsr = (gu * z) * expf(upper_clip(lsr, st.pol_upper))
                       * sigmoid_f(st.pol_upper - lsr);
    gp[k * TMP + r] = gu;
    gp[(U + k) * TMP + r] = glsr;
    if (r < nrows) {
      sg.g_pout[(size_t)(row0 + r) * 2 * U + k] = gu;
      sg.g_pout[(size_t)(row0 + r) * 2 * U + U + k] = glsr;
    }
  }
  __syncthreads();
  float* dx = mlp_rows_bwd(pol, sg.pol, gp, G, row0, nrows, pol_a, nullptr);
  for (int i = tid; i < nrows * D; i += nt) {
    const int r = i / D, k = i - r * D;
    sg.g_states[(size_t)(row0 + r) * D + k] = tl.g_s[k][r] + dx[k * TMP + r];
  }
}

// ---- moment matching ----------------------------------------------------------
// The particle clouds may have been written earlier in the same launch by
// other blocks (fused_rollout.cu), so they are read with plain loads, never
// through the read-only path (no __restrict__ const, no __ldg).

// Sum of v over the block (blockDim.x a multiple of 32), in a fixed order;
// every thread gets the total. All threads must call it.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();  // red may still be read from the previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += red[w];
  return t;
}

// Mean m, unbiased covariance S (lower triangle filled, both halves) and the
// sum of the centred particles sd (zero up to rounding) of x [B, D].
__device__ void moments(const float* x, int B, int D, float* m, float* S, float* sd, float* red) {
  for (int c = 0; c < D; ++c) {
    float p = 0.f;
    for (int b = threadIdx.x; b < B; b += blockDim.x) p += x[(size_t)b * D + c];
    const float t = block_sum(p, red);
    if (threadIdx.x == 0) m[c] = t / B;
  }
  __syncthreads();
  for (int c = 0; c < D; ++c) {
    float p = 0.f;
    for (int b = threadIdx.x; b < B; b += blockDim.x) p += x[(size_t)b * D + c] - m[c];
    const float t = block_sum(p, red);
    if (threadIdx.x == 0) sd[c] = t;
    for (int c2 = 0; c2 <= c; ++c2) {
      float q = 0.f;
      for (int b = threadIdx.x; b < B; b += blockDim.x)
        q += (x[(size_t)b * D + c] - m[c]) * (x[(size_t)b * D + c2] - m[c2]);
      const float s = block_sum(q, red) / (B - 1);
      if (threadIdx.x == 0) S[c * D + c2] = S[c2 * D + c] = s;
    }
  }
  __syncthreads();
}

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

// The resample out = m + z L^T for rows [row0, row0 + nrows) of z [B, D].
__device__ void mm_apply(const float* z, const float* m, const float* L, int D, int row0,
                         int nrows, float* out) {
  for (int i = threadIdx.x; i < nrows * D; i += blockDim.x) {
    const int b = row0 + i / D, c = i % D;
    float acc = 0.f;
    for (int j = 0; j <= c; ++j) acc += z[(size_t)b * D + j] * L[c * D + j];
    out[(size_t)b * D + c] = m[c] + acc;
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

// g_x[b] = H (x[b] - m) + c0 for rows [row0, row0 + nrows) of x [B, D].
__device__ void mm_vjp_apply(const float* x, const float* m, const float* H, const float* c0,
                             int D, int row0, int nrows, float* out) {
  for (int i = threadIdx.x; i < nrows * D; i += blockDim.x) {
    const int b = row0 + i / D, c = i % D;
    float acc = 0.f;
    for (int k = 0; k < D; ++k) acc += H[c * D + k] * (x[(size_t)b * D + k] - m[k]);
    out[(size_t)b * D + c] = acc + c0[c];
  }
}

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
      || a->ntip < 0 || a->ntip > kMaxTip)
    return false;
  if (!fill_mlp(st.pol, a->pol, a->B) || !fill_mlp(st.dyn, a->dyn, a->B)) return false;
  const int D = a->D, U = a->U;
  if (st.pol.dims[0] != D || st.pol.dims[st.pol.n + 1] != 2 * U
      || st.dyn.dims[0] != D + U || st.dyn.dims[st.dyn.n + 1] != 2 * D)
    return false;
  st.B = a->B;
  st.D = D;
  st.U = U;
  st.ntip = a->ntip;
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
  if (!st.states || !st.z_pol || !st.z_dyn || !st.mx || !st.isx || !st.my || !st.sy) return false;
  st.pol_upper = a->pol_upper;
  st.dyn_upper = a->dyn_upper;
  for (int k = 0; k < kMaxU; ++k) {
    st.act_scale[k] = a->act_scale[k];
    st.act_bias[k] = a->act_bias[k];
  }
  for (int i = 0; i < kMaxTip * kMaxD; ++i) st.tip[i] = a->tip[i];
  for (int j = 0; j < kMaxTip; ++j) st.target[j] = a->target[j];
  st.norm = a->norm;
  st.q_scale = a->q_scale;
  st.r_scale = a->r_scale;
  return true;
}

}  // namespace
