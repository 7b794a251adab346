// One MC-PILCO rollout step, forward and backward, for Hopper (sm_90a), with
// a plain C interface that prob_mbrl_tpu_torch/ops/cuda/fused_rollout.py
// loads with ctypes.
//
// Replaces the Pallas TPU kernels of prob_mbrl_tpu/ops/pallas/fused_rollout.py:
//   fused_step_fwd <- make_fused_step._fwd_pallas (:1153-1177, the call at :1166)
//   fused_step_bwd <- make_fused_step._bwd_pallas (:1179-1217, the call at :1206)
// whose body is make_step_impl (:1079-1129):
//   policy MLP -> DiagGaussian sample -> max_u * tanh(.) + eps
//   -> whitened cat(s, a) -> dynamics MLP -> scaled DiagGaussian sample
//   -> nxt = s + delta -> exp-quadratic tip reward on the pre-MM nxt
//   -> moment-matching resample of nxt (D) and of r (D = 1), Cholesky path
//      with the escalating jitter of _safe_cholesky_kf (:117-203).
//
// Bound at the main-path shapes (B = 100; policy 5->200->200->2, dynamics
// 6->200->200->10): the forward does ~17 MFLOP of float32 products (0.26 us
// at the 67 TFLOP/s non-tensor-core peak) and moves ~0.65 MB of weights,
// masks and state (0.19 us at 3.35 TB/s). Like the fused MLP, it is a chain
// of dependent products, so latency, not either bound, sets its time.
//
// Design. Hopper's blocks run in parallel, but the resample reduces over
// all B particles, so each direction is split at the reduction:
//   forward:  rows_fwd_kernel, one block per TM rows: both MLPs, the samples
//             and the reward, activations in shared memory (mlp_tile.cuh);
//             writes the pre-MM (nxt, r). Then mm_fwd_kernel, one block per
//             resampled quantity (nxt and r side by side): mean, unbiased
//             covariance, 8-jitter Cholesky with first-ok selection,
//             m + z L^T.
//   backward: mm_bwd_kernel (one block per quantity; the Cholesky adjoint
//             at the chosen jitter), then rows_bwd_kernel, which recomputes
//             the tile's forward from the step's inputs and applies every
//             VJP by hand (reward, density, tanh, both MLPs' dx chains),
//             then wgrad_kernel for the policy's dW and db.
// No activation goes to device memory between launches except what the next
// launch reads: the pre-MM (nxt, r) of the forward (the autograd residual),
// and in the backward the policy's pre-activations and their gradients for
// wgrad_kernel. Dynamics parameters and masks get no gradient (the step
// differentiates wrt the policy parameters, the states and eps only).
// Reductions run in a fixed order; no atomics.

#include "mlp_tile.cuh"

namespace {

constexpr int kMaxD = 8;     // state dims
constexpr int kMaxU = 4;     // action dims
constexpr int kMaxTip = 4;   // coordinates of the reward's tip
constexpr int kTries = 8;    // jitters of the safe Cholesky
constexpr int kMMThreads = 256;

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
  const float *states, *eps, *z_pol, *z_dyn, *mx, *isx, *my, *sy;
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

// The step's forward for one tile of rows; leaves its per-row results in tl.
// pol_a_sm / dyn_a_sm: where to keep the hidden pre-activations (backward).
__device__ void tile_fwd(const Step& st, TileSm& tl, float* buf0, float* buf1, int row0,
                         int nrows, float* const* pol_a_sm, float* const* dyn_a_sm) {
  const int D = st.D, U = st.U, nt = blockDim.x, tid = threadIdx.x;
  for (int i = tid; i < TM * D; i += nt) {
    const int r = i / D, k = i - r * D;
    const float v = r < nrows ? st.states[(size_t)(row0 + r) * D + k] : 0.f;
    tl.s[k][r] = v;
    buf0[k * TMP + r] = v;
  }
  __syncthreads();
  float* P = mlp_rows_fwd(st.pol, buf0, buf1, row0, nrows, pol_a_sm, nullptr);
  for (int i = tid; i < TM * U; i += nt) {
    const int r = i / U, k = i - r * U;
    const size_t o = (size_t)(row0 + r) * U + k;
    const float mean = P[k * TMP + r], lsr = P[(U + k) * TMP + r];
    const float z = r < nrows ? st.z_pol[o] : 0.f;
    const float u = mean + z * expf(upper_clip(lsr, st.pol_upper));
    float a = st.act_scale[k] * tanhf(u) + st.act_bias[k];
    if (st.eps && r < nrows) a += st.eps[o];
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

__global__ void __launch_bounds__(1024)
rows_fwd_kernel(Step st, float* __restrict__ nxt_raw, float* __restrict__ r_raw) {
  extern __shared__ __align__(16) float smem[];
  __shared__ TileSm tl;
  const int maxw = max(st.pol.maxw, st.dyn.maxw);
  const int row0 = blockIdx.x * TM;
  const int nrows = min(TM, st.B - row0);
  tile_fwd(st, tl, smem, smem + maxw * TMP, row0, nrows, nullptr, nullptr);
  const int D = st.D;
  for (int i = threadIdx.x; i < nrows * D; i += blockDim.x) {
    const int r = i / D, k = i - r * D;
    nxt_raw[(size_t)(row0 + r) * D + k] = tl.nxt[k][r];
  }
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) r_raw[row0 + r] = tl.r[r];
}

// Backward of one tile: recompute, then the VJPs in reverse order.
struct StepGrads {
  const float* g_nxt;  // [B, D] gradient wrt the pre-MM nxt
  const float* g_r;    // [B] gradient wrt the pre-MM r
  float* g_states;     // [B, D]
  float* g_eps;        // [B, U] or null
  float* g_pout;       // [B, 2U] gradient wrt the policy MLP's output
  Grads pol;           // the policy's ga scratch (dw/db are wgrad_kernel's)
};

__global__ void __launch_bounds__(1024)
rows_bwd_kernel(Step st, StepGrads sg) {
  extern __shared__ __align__(16) float smem[];
  __shared__ TileSm tl;
  const int maxw = max(st.pol.maxw, st.dyn.maxw);
  const int D = st.D, U = st.U, nt = blockDim.x, tid = threadIdx.x;
  const int row0 = blockIdx.x * TM;
  const int nrows = min(TM, st.B - row0);
  float* buf0 = smem;
  float* buf1 = smem + maxw * TMP;
  float* pol_a[kMaxLayers];
  float* dyn_a[kMaxLayers];
  float* next = buf1 + maxw * TMP;
  for (int l = 0; l < st.pol.n; ++l) {
    pol_a[l] = next;
    next += st.pol.dims[l + 1] * TMP;
  }
  for (int l = 0; l < st.dyn.n; ++l) {
    dyn_a[l] = next;
    next += st.dyn.dims[l + 1] * TMP;
  }
  tile_fwd(st, tl, buf0, buf1, row0, nrows, pol_a, dyn_a);

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
  float* dx = mlp_rows_bwd(st.pol, sg.pol, gp, G, row0, nrows, pol_a, nullptr);
  for (int i = tid; i < nrows * D; i += nt) {
    const int r = i / D, k = i - r * D;
    sg.g_states[(size_t)(row0 + r) * D + k] = tl.g_s[k][r] + dx[k * TMP + r];
  }
}

// ---- moment matching: one block per resampled quantity ----------------------

struct MMSite {
  const float* x;  // [B, D] particles
  const float* z;  // [B, D] standardized noise
  const float* g;  // backward: [B, D] gradient wrt the output
  float* out;      // forward: [B, D] resampled; backward: gradient wrt x
  int D;
};

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
__device__ void moments(const float* __restrict__ x, int B, int D, float* m, float* S, float* sd,
                        float* red) {
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

__global__ void __launch_bounds__(kMMThreads)
mm_fwd_kernel(MMSite s0, MMSite s1, int B) {
  const MMSite s = blockIdx.x == 0 ? s0 : s1;
  __shared__ float red[kMMThreads / 32];
  __shared__ float m[kMaxD], S[kMaxD * kMaxD], L[kMaxD * kMaxD], sd[kMaxD];
  const int D = s.D;
  moments(s.x, B, D, m, S, sd, red);
  if (threadIdx.x == 0) safe_chol(S, D, L);
  __syncthreads();
  for (int i = threadIdx.x; i < B * D; i += blockDim.x) {
    const int b = i / D, c = i - b * D;
    float acc = 0.f;
    for (int j = 0; j <= c; ++j) acc += s.z[(size_t)b * D + j] * L[c * D + j];
    s.out[i] = m[c] + acc;
  }
}

// out = m + z L^T: g_m = sum_b g[b]; g_L[i, j] = sum_b g[b, i] z[b, j]; the
// Cholesky adjoint gives G wrt S; S = d^T d / (B - 1), d = x - m, so
// g_x[b] = (G + G^T) d[b] / (B - 1) + (g_m - (G + G^T) sum_b d[b] / (B - 1)) / B.
__global__ void __launch_bounds__(kMMThreads)
mm_bwd_kernel(MMSite s0, MMSite s1, int B) {
  const MMSite s = blockIdx.x == 0 ? s0 : s1;
  __shared__ float red[kMMThreads / 32];
  __shared__ float m[kMaxD], S[kMaxD * kMaxD], L[kMaxD * kMaxD], sd[kMaxD];
  __shared__ float gm[kMaxD], gL[kMaxD * kMaxD], H[kMaxD * kMaxD], c0[kMaxD];
  const int D = s.D;
  moments(s.x, B, D, m, S, sd, red);
  for (int i = 0; i < D; ++i) {
    float p = 0.f;
    for (int b = threadIdx.x; b < B; b += blockDim.x) p += s.g[(size_t)b * D + i];
    const float t = block_sum(p, red);
    if (threadIdx.x == 0) gm[i] = t;
    for (int j = 0; j <= i; ++j) {
      float q = 0.f;
      for (int b = threadIdx.x; b < B; b += blockDim.x)
        q += s.g[(size_t)b * D + i] * s.z[(size_t)b * D + j];
      const float t2 = block_sum(q, red);
      if (threadIdx.x == 0) {
        gL[i * D + j] = t2;
        if (j < i) gL[j * D + i] = 0.f;
      }
    }
  }
  if (threadIdx.x == 0) {
    float G[kMaxD * kMaxD];
    if (safe_chol(S, D, L)) {
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
  __syncthreads();
  for (int i = threadIdx.x; i < B * D; i += blockDim.x) {
    const int b = i / D, c = i - b * D;
    float acc = 0.f;
    for (int k = 0; k < D; ++k) acc += H[c * D + k] * (s.x[(size_t)b * D + k] - m[k]);
    s.out[i] = acc + c0[c];
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

// Dynamic shared memory beside the kernel's static TileSm: above 48 KB in
// all, the kernel has to be allowed the dynamic part explicitly. The largest
// size allowed so far is kept in `allowed`, so that a launch inside a CUDA
// graph capture sets no attribute once the size was seen before.
int allow_smem(const void* kernel, size_t bytes, size_t& allowed) {
  if (bytes + sizeof(TileSm) <= 48 * 1024 || bytes <= allowed) return cudaSuccess;
  const int e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     static_cast<int>(bytes));
  if (e == cudaSuccess) allowed = bytes;
  return e;
}

size_t g_fwd_allowed = 0, g_bwd_allowed = 0;

int max_width(const Step& st) { return st.pol.maxw > st.dyn.maxw ? st.pol.maxw : st.dyn.maxw; }

size_t fwd_smem(const Step& st) { return 2 * (size_t)max_width(st) * TMP * sizeof(float); }

size_t bwd_smem(const Step& st) {
  size_t f = 2 * (size_t)max_width(st);
  for (int l = 0; l < st.pol.n; ++l) f += st.pol.dims[l + 1];
  for (int l = 0; l < st.dyn.n; ++l) f += st.dyn.dims[l + 1];
  return f * TMP * sizeof(float);
}

// The resample sites of one direction: states first, then rewards; unused
// slots repeat the last used one and are not launched.
int sites(const StepArgs* a, int mm_states, int mm_rewards, const void* xs, const void* xr,
          const void* gs, const void* gr, void* os, void* orr, MMSite* out) {
  int n = 0;
  if (mm_states) out[n++] = MMSite{static_cast<const float*>(xs), a->z_mm,
                                   static_cast<const float*>(gs), static_cast<float*>(os), a->D};
  if (mm_rewards) out[n++] = MMSite{static_cast<const float*>(xr), a->z_rr,
                                    static_cast<const float*>(gr), static_cast<float*>(orr), 1};
  if (n == 2 || n == 0) return n;
  out[1] = out[0];
  return n;
}

}  // namespace

extern "C" {

const char* fused_step_error(int e) {
  return e < 0 ? "arguments the kernel does not take"
               : cudaGetErrorString(static_cast<cudaError_t>(e));
}

// Size in bytes of the argument block (checked against the ctypes mirror).
int fused_step_args_size() { return static_cast<int>(sizeof(StepArgs)); }

// Forward of one step. Writes the pre-MM (nxt_raw [B, D], r_raw [B, 1]);
// when mm_states (mm_rewards), resamples them into nxt (r), else the caller
// passes nxt == nxt_raw (r == r_raw). Returns 0, a cudaError_t, or -1.
int fused_step_fwd(const StepArgs* a, int mm_states, int mm_rewards, void* nxt_raw, void* r_raw,
                   void* nxt, void* r, void* stream) {
  Step st;
  if (!fill_step(st, a) || !nxt_raw || !r_raw || !nxt || !r) return -1;
  if ((mm_states && !a->z_mm) || (mm_rewards && !a->z_rr)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = fwd_smem(st);
  int e = allow_smem(reinterpret_cast<const void*>(rows_fwd_kernel), smem, g_fwd_allowed);
  if (e != cudaSuccess) return e;
  rows_fwd_kernel<<<(st.B + TM - 1) / TM, threads_for(max_width(st)), smem, s>>>(
      st, static_cast<float*>(nxt_raw), static_cast<float*>(r_raw));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  MMSite ms[2];
  const int n = sites(a, mm_states, mm_rewards, nxt_raw, r_raw, nullptr, nullptr, nxt, r, ms);
  if (n == 0) return cudaSuccess;
  mm_fwd_kernel<<<n, kMMThreads, 0, s>>>(ms[0], ms[1], st.B);
  return cudaGetLastError();
}

// Backward of one step from the forward's inputs and its pre-MM outputs.
// g_nxt_raw, g_r_raw: scratch [B, D], [B, 1] for the gradients wrt the pre-MM
// outputs (the caller passes g_nxt_raw == g_nxt without mm_states, and
// likewise for r). Outputs: g_states [B, D], g_eps [B, U] (or null), the
// policy's dw (n_pol + 1) and db (null where a layer has no bias). Scratch:
// pol_a, pol_ga (n_pol hidden layers, [B, d]) and g_pout [B, 2U].
int fused_step_bwd(const StepArgs* a, int mm_states, int mm_rewards, const void* nxt_raw,
                   const void* r_raw, const void* g_nxt, const void* g_r, void* g_nxt_raw,
                   void* g_r_raw, void* g_states, void* g_eps, void* const* dw,
                   void* const* db, void* const* pol_a, void* const* pol_ga, void* g_pout,
                   void* stream) {
  Step st;
  if (!fill_step(st, a) || !nxt_raw || !r_raw || !g_nxt || !g_r || !g_nxt_raw || !g_r_raw
      || !g_states || !g_pout)
    return -1;
  if ((mm_states && !a->z_mm) || (mm_rewards && !a->z_rr)) return -1;
  StepGrads sg;
  sg.g_nxt = static_cast<const float*>(g_nxt_raw);
  sg.g_r = static_cast<const float*>(g_r_raw);
  sg.g_states = static_cast<float*>(g_states);
  sg.g_eps = static_cast<float*>(g_eps);
  sg.g_pout = static_cast<float*>(g_pout);
  const int np = st.pol.n;
  for (int l = 0; l < kMaxLayers; ++l) {
    const bool lin = l <= np, hid = l < np;
    sg.pol.dw[l] = lin ? static_cast<float*>(dw[l]) : nullptr;
    sg.pol.db[l] = lin ? static_cast<float*>(db[l]) : nullptr;
    sg.pol.dm[l] = nullptr;
    sg.pol.ga[l] = hid ? static_cast<float*>(pol_ga[l]) : nullptr;
    st.pol.a[l] = hid ? static_cast<float*>(pol_a[l]) : nullptr;
    if ((lin && !sg.pol.dw[l]) || (hid && (!sg.pol.ga[l] || !st.pol.a[l]))) return -1;
    if (lin && (st.pol.b[l] != nullptr) != (sg.pol.db[l] != nullptr)) return -1;
  }
  fill_tiles(st.pol, sg.pol);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MMSite ms[2];
  const int n = sites(a, mm_states, mm_rewards, nxt_raw, r_raw, g_nxt, g_r, g_nxt_raw, g_r_raw,
                      ms);
  int e;
  if (n > 0) {
    mm_bwd_kernel<<<n, kMMThreads, 0, s>>>(ms[0], ms[1], st.B);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const size_t smem = bwd_smem(st);
  e = allow_smem(reinterpret_cast<const void*>(rows_bwd_kernel), smem, g_bwd_allowed);
  if (e != cudaSuccess) return e;
  rows_bwd_kernel<<<(st.B + TM - 1) / TM, threads_for(max_width(st)), smem, s>>>(st, sg);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  wgrad_kernel<<<sg.pol.tile_start[np + 1], 256, 0, s>>>(
      st.pol, sg.pol, st.states, static_cast<const float*>(g_pout));
  return cudaGetLastError();
}

}  // extern "C"
