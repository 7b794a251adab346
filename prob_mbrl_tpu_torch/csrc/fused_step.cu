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
// Reductions run in a fixed order; no atomics. The step's device code (tile
// forward and backward, moments, safe Cholesky and adjoint, the resample and
// its VJP) lives in rollout_step.cuh, shared with fused_rollout.cu.

#include "rollout_step.cuh"

namespace {

constexpr int kMMThreads = 256;

__global__ void __launch_bounds__(1024)
rows_fwd_kernel(Step st, float* __restrict__ nxt_raw, float* __restrict__ r_raw) {
  extern __shared__ __align__(16) float smem[];
  __shared__ TileSm tl;
  const int maxw = max_width(st);
  const int row0 = blockIdx.x * TM;
  const int nrows = min(TM, st.B - row0);
  tile_fwd(st, st.pol, st.states, st.eps, tl, smem, smem + maxw * TMP, row0, nrows, nullptr,
           nullptr);
  const int D = st.D;
  for (int i = threadIdx.x; i < nrows * D; i += blockDim.x) {
    const int r = i / D, k = i - r * D;
    nxt_raw[(size_t)(row0 + r) * D + k] = tl.nxt[k][r];
  }
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) r_raw[row0 + r] = tl.r[r];
}

__global__ void __launch_bounds__(1024)
rows_bwd_kernel(Step st, StepGrads sg) {
  extern __shared__ __align__(16) float smem[];
  __shared__ TileSm tl;
  const int row0 = blockIdx.x * TM;
  tile_bwd(st, st.pol, st.states, st.eps, sg, tl, smem, row0, min(TM, st.B - row0));
}

// ---- moment matching: one block per resampled quantity ----------------------

struct MMSite {
  const float* x;  // [B, D] particles
  const float* z;  // [B, D] standardized noise
  const float* g;  // backward: [B, D] gradient wrt the output
  float* out;      // forward: [B, D] resampled; backward: gradient wrt x
  int D;
};

__global__ void __launch_bounds__(kMMThreads)
mm_fwd_kernel(MMSite s0, MMSite s1, int B) {
  const MMSite s = blockIdx.x == 0 ? s0 : s1;
  __shared__ float red[kMMThreads / 32];
  __shared__ float m[kMaxD], S[kMaxD * kMaxD], L[kMaxD * kMaxD], sd[kMaxD];
  const int D = s.D;
  moments(s.x, B, D, m, S, sd, red);
  if (threadIdx.x == 0) safe_chol(S, D, L);
  __syncthreads();
  mm_apply(s.z, m, L, D, 0, B, s.out);
}

// out = m + z L^T: g_m = sum_b g[b]; g_L[i, j] = sum_b g[b, i] z[b, j]; then
// mm_vjp_coeffs and mm_vjp_apply.
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
  if (threadIdx.x == 0) mm_vjp_coeffs(L, safe_chol(S, D, L), gm, gL, sd, B, D, H, c0);
  __syncthreads();
  mm_vjp_apply(s.x, m, H, c0, D, 0, B, s.out);
}

// ---- host side ----------------------------------------------------------------

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

size_t fwd_smem(const Step& st) { return 2 * (size_t)max_width(st) * TMP * sizeof(float); }

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
