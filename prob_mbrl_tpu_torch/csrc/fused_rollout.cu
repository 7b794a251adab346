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
// Per step t: the step of rollout_step.cuh on the states s_t, then
// s_{t+1} = resample(nxt) (or nxt), r = resample(r) (or its particle mean
// with the reward mean-only shortcut, :583-591, or r itself);
// disc += w_t r, raw += r; loss = sign * mean(disc), mean_return = mean(raw).
// The grid kernels run the same sweeps with per-particle outputs: the forward
// also accumulates vret += vw_t r and writes disc, raw, vret [B] and the
// boundary states (states_all = s_all[1:]) instead of loss and mean_return;
// the backward takes a cotangent per particle for each of disc, raw, vret,
// so the reward cotangent of row b at step t is
// c[b] = w_t g_disc[b] + g_raw[b] + vw_t g_vret[b] (:1534) where rows 3-5 have
// the uniform (sign g_loss w_t + g_mret) / B, and it adds g_sall[t], the
// cotangent of states_all[t], to the state cotangent before step t's MM
// backward (:1530-1531). No mean-only shortcut there: the critic reads
// per-particle rewards.
//
// Bound at the main-path shapes (B = 100, T = 15; policy 5->200->200->2,
// dynamics 6->200->200->10): T times the step's work, ~15 x 17 MFLOP of
// float32 products forward (~3.9 us at the 67 TFLOP/s non-tensor-core peak)
// and ~15 x 42 MFLOP backward (the recompute, both dx chains and the
// policy's dW). Like the step, it is a chain of dependent products and of
// reductions over all particles, so latency, not either bound, sets its time.
// The grid kernels at the value path's B = 1000 do 10x that work (~39 us
// forward, ~96 us backward at that peak) on 125 row blocks, one per SM; the
// backward's dW then sums T B = 15000 rows per tile, one tile per block.
//
// Design. One cooperative launch, all blocks co-resident (checked with the
// occupancy API before the launch). Block k < ceil(B / TM) owns rows
// [k TM, k TM + TM) for all T steps, so the state carry and the backward's
// state cotangent never leave the block; a launch with a backward has at
// least as many blocks as the policy has dW tiles (63 at the main path's
// widths; as many as the card holds), and the blocks that own no rows only
// wait at the barriers until the dW. A grid-wide barrier
// (cooperative_groups::this_grid().sync()) separates only what reduces over
// all B particles:
//   forward, per step: the block's rows through the step (tile_fwd), the
//     pre-MM (nxt, r) into slot t of [T, B, D] / [T, B] buffers (one slot
//     per step: no write-after-read hazard); one grid sync; then every block
//     computes the moments and the safe Cholesky of all B rows itself, in
//     the same fixed order, so all get the same m and L with no second
//     barrier, and applies m + z L^T to its own rows. The boundary states go
//     to [T + 1, B, D]; block 0 keeps (m, sd, L) of each step for the
//     backward. Returns accumulate per row; after the last step one more
//     sync and a fixed-order sum give loss and mean_return.
//   backward, per step t = T-1 ... 0: the gradient wrt the post-MM reward is
//     the uniform (sign g_loss w_t + g_mret) / B. Each block writes its
//     partial MM-backward sums (sum g, sum g z^T over its rows) into slot t;
//     one grid sync; every block sums all partials in a fixed order, runs the
//     Cholesky adjoint itself, forms the gradient wrt its rows' pre-MM
//     (nxt, r) and runs the step's recompute-and-VJP (tile_bwd) from the
//     boundary state s_t. The policy's pre-activations and their gradients
//     go to [T, B, width] buffers (L2-resident at the main path's size).
//     The mean-only reward's VJP is the same uniform scalar: no reduction.
//   policy dW and db: after the sweep one sync, then all blocks share the
//     dW tiles over all T B rows (wgrad_tile), each summed in row order by
//     one block (13 blocks walking the 63 tiles took ~1.3 ms of the
//     backward's 4.1 at the main path; one tile per block removes most).
// No atomics anywhere: results repeat bit for bit. The backward recomputes
// each step from its boundary state (the remat design).
//
// Time split. Given RollArgs::split, thread 0 of block 0 adds the
// %globaltimer nanoseconds of each part of the launch to split[part]: the
// forward's step (MLP walk), its barrier and moment matching, the backward's
// barrier and MM adjoint, its recompute and VJP, and the dW (barrier
// included). Block 0's clock includes its wait at each barrier for the
// slowest block. Off (null) it costs one test per part.

#include <cooperative_groups.h>

#include "rollout_step.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kStat = 2 * kMaxD + kMaxD * kMaxD;  // m, sd, L of one resample site
constexpr int kPart = 48;  // partial sums of one block: D + D(D+1)/2 + 2 <= 46
constexpr int kFwd = 1, kBwd = 2;
// parts of RollArgs::split
constexpr int kFwdStep = 0, kFwdMM = 1, kBwdMM = 2, kBwdStep = 3, kDW = 4;
// Threads of a block, at most: the launch bound leaves each thread 128
// registers. With a bound of 1024 (64 registers) the kernel spilled heavily
// and ran markedly slower at the main path on an H100; 256 was no faster
// than 512. MLPs wider than 512 are not taken: the capacity query reports 0
// blocks and the gate names the step tier.
constexpr int kMaxThreads = 512;

}  // namespace

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
  unsigned long long* split;  // [5] nanoseconds of each part, or null
  float* s_all;          // [T + 1, B, D] boundary states (s_0 = x0)
  float* nxt_raw;        // [T, B, D] pre-MM next states
  float* r_raw;          // [T, B] pre-MM rewards
  float* stats;          // [T, 2, kStat] (m, sd, L) of the state and reward resamples
  float* loss;           // [1]
  float* mret;           // [1]
  float* g_eps;          // [T, B, U] or null
  float* rowsum;         // [2, B] scratch: per-row disc and raw
  float* part;           // [T, ceil(B / TM), kPart] scratch: MM-backward partial sums
  float* g_s;            // [B, D] scratch: the state cotangent
  float* g_nxt;          // [B, D] scratch: gradient wrt the pre-MM nxt
  float* g_r;            // [B] scratch: gradient wrt the pre-MM r
  float* g_pout;         // [T, B, 2U] scratch: gradient wrt the policy's output
  float* pol_a[kMaxLayers];   // [T, B, d] scratch: policy hidden pre-activations
  float* pol_ga[kMaxLayers];  // [T, B, d] scratch: their gradients
  float* dw[kMaxLayers];      // policy dW (outputs)
  float* db[kMaxLayers];      // policy db (outputs; null where no bias)
};

namespace {

struct Roll {
  int T, nrb, mm_states, r_mm, mean_only;  // nrb: blocks that own rows
  float sign;
  const float *w_t, *g_loss, *g_mret, *vw_t, *g_disc, *g_raw, *g_vret, *g_sall;
  float *s_all, *nxt_raw, *r_raw, *stats, *loss, *mret, *g_eps, *disc, *raw, *vret;
  unsigned long long* split;
  float *rowsum, *part, *g_s, *g_nxt, *g_r, *g_pout;
  float* pol_a[kMaxLayers];
  Grads pw;  // dw, db, ga = pol_ga; tile_start over the policy's layers
};

// one resample site's moments, factor and adjoint coefficients
struct Site {
  float m[kMaxD], S[kMaxD * kMaxD], L[kMaxD * kMaxD], sd[kMaxD];
  float H[kMaxD * kMaxD], c0[kMaxD], gm[kMaxD], gL[kMaxD * kMaxD];
};

struct RollSm {
  Site s, r;  // states, rewards
  float red[32];
  float tot[kPart];
  float disc[TM], raw[TM], vret[TM], rpost[TM];
  unsigned long long last_lap;  // the time split's clock at the last lap
};

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// With ro.split, thread 0 of block 0 adds the time since the last lap to
// ro.split[part] (the clock lives in shared memory, the pointer in the
// kernel's parameters: no register is held for it).
__device__ __forceinline__ void lap(const Roll& ro, RollSm& sh, int part) {
  if (!ro.split || blockIdx.x != 0 || threadIdx.x != 0) return;
  const unsigned long long t = globaltimer();
  ro.split[part] += t - sh.last_lap;
  sh.last_lap = t;
}

// The cotangent of row b's post-MM reward at step t: per particle on the grid
// tier, else the loss's uniform c.
__device__ __forceinline__ float reward_cot(const Roll& ro, int t, int b, float c) {
  return ro.g_disc ? ro.w_t[t] * ro.g_disc[b] + ro.g_raw[b] + ro.vw_t[t] * ro.g_vret[b] : c;
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

__device__ void forward_sweep(const Step& st, const Roll& ro, TileSm& tl, RollSm& sh,
                              float* smem, cg::grid_group& grid) {
  const int B = st.B, D = st.D, U = st.U, tid = threadIdx.x, nt = blockDim.x;
  const int row0 = blockIdx.x * TM, nrows = min(TM, B - row0);
  const bool owner = (int)blockIdx.x < ro.nrb;  // the other blocks only wait here
  const int maxw = max_width(st);
  float* buf0 = smem;
  float* buf1 = smem + maxw * TMP;
  if (owner) {
    for (int i = tid; i < nrows * D; i += nt)
      ro.s_all[(size_t)row0 * D + i] = st.states[(size_t)row0 * D + i];
  }
  for (int r = tid; r < TM; r += nt) sh.disc[r] = sh.raw[r] = sh.vret[r] = 0.f;
  __syncthreads();
  for (int t = 0; t < ro.T; ++t) {
    if (!owner) {
      grid.sync();
      continue;
    }
    const float* s_t = ro.s_all + (size_t)t * B * D;
    float* s_n = ro.s_all + (size_t)(t + 1) * B * D;
    float* x_t = ro.nxt_raw + (size_t)t * B * D;
    float* r_t = ro.r_raw + (size_t)t * B;
    float* stat = ro.stats + (size_t)t * 2 * kStat;
    tile_fwd(st, st.pol, s_t, st.eps ? st.eps + (size_t)t * B * U : nullptr, tl, buf0, buf1,
             row0, nrows, nullptr, nullptr);
    for (int i = tid; i < nrows * D; i += nt) {
      const int r = i / D, k = i - r * D;
      x_t[(size_t)(row0 + r) * D + k] = tl.nxt[k][r];
    }
    for (int r = tid; r < nrows; r += nt) r_t[row0 + r] = tl.r[r];
    lap(ro, sh, kFwdStep);
    grid.sync();
    if (ro.mm_states) {
      moments(x_t, B, D, sh.s.m, sh.s.S, sh.s.sd, sh.red);
      if (tid == 0) {
        safe_chol(sh.s.S, D, sh.s.L);
        if (blockIdx.x == 0) save_site(sh.s, D, stat);
      }
      __syncthreads();
      mm_apply(st.z_mm + (size_t)t * B * D, sh.s.m, sh.s.L, D, row0, nrows, s_n);
    } else {
      for (int i = tid; i < nrows * D; i += nt) {
        const int r = i / D, k = i - r * D;
        s_n[(size_t)(row0 + r) * D + k] = tl.nxt[k][r];
      }
    }
    if (ro.mean_only) {
      float p = 0.f;
      for (int b = tid; b < B; b += nt) p += r_t[b];
      const float mean = block_sum(p, sh.red) / B;
      for (int r = tid; r < TM; r += nt) sh.rpost[r] = mean;
    } else if (ro.r_mm) {
      moments(r_t, B, 1, sh.r.m, sh.r.S, sh.r.sd, sh.red);
      if (tid == 0) {
        safe_chol(sh.r.S, 1, sh.r.L);
        if (blockIdx.x == 0) save_site(sh.r, 1, stat + kStat);
      }
      __syncthreads();
      for (int r = tid; r < nrows; r += nt)
        sh.rpost[r] = sh.r.m[0] + st.z_rr[(size_t)t * B + row0 + r] * sh.r.L[0];
    } else {
      for (int r = tid; r < TM; r += nt) sh.rpost[r] = tl.r[r];
    }
    __syncthreads();
    for (int r = tid; r < nrows; r += nt) {
      sh.disc[r] = sh.disc[r] + ro.w_t[t] * sh.rpost[r];
      sh.raw[r] = sh.raw[r] + sh.rpost[r];
      if (ro.vw_t) sh.vret[r] = sh.vret[r] + ro.vw_t[t] * sh.rpost[r];
    }
    __syncthreads();
    lap(ro, sh, kFwdMM);
  }
  if (ro.disc) {  // the grid tier: per-particle outputs, no reduction
    if (owner) {
      for (int r = tid; r < nrows; r += nt) {
        ro.disc[row0 + r] = sh.disc[r];
        ro.raw[row0 + r] = sh.raw[r];
        ro.vret[row0 + r] = sh.vret[r];
      }
    }
    return;
  }
  if (owner) {
    for (int r = tid; r < nrows; r += nt) {
      ro.rowsum[row0 + r] = sh.disc[r];
      ro.rowsum[B + row0 + r] = sh.raw[r];
    }
  }
  grid.sync();
  if (blockIdx.x == 0) {
    float p = 0.f, q = 0.f;
    for (int b = tid; b < B; b += nt) {
      p += ro.rowsum[b];
      q += ro.rowsum[B + b];
    }
    const float disc = block_sum(p, sh.red);
    const float raw = block_sum(q, sh.red);
    if (tid == 0) {
      *ro.loss = ro.sign * (disc / B);
      *ro.mret = raw / B;
    }
  }
  lap(ro, sh, kFwdMM);
}

__device__ void reverse_sweep(const Step& st, const Roll& ro, TileSm& tl, RollSm& sh,
                              float* smem, cg::grid_group& grid) {
  const int B = st.B, D = st.D, U = st.U, tid = threadIdx.x, nt = blockDim.x;
  const int blk = blockIdx.x, row0 = blk * TM, nrows = min(TM, B - row0);
  const bool owner = blk < ro.nrb;  // the other blocks join for the dW only
  const int nL = D * (D + 1) / 2;
  const float g_loss = ro.g_loss ? *ro.g_loss : 1.f;
  const float g_mret = ro.g_mret ? *ro.g_mret : 0.f;
  if (owner) {
    for (int i = tid; i < nrows * D; i += nt) ro.g_s[(size_t)row0 * D + i] = 0.f;
  }
  __syncthreads();
  for (int t = ro.T - 1; t >= 0; --t) {
    if (!owner) {
      grid.sync();
      continue;
    }
    if (ro.g_sall) {  // the grid tier: the cotangent of states_all[t] joins g_s
      const float* gs = ro.g_sall + (size_t)t * B * D + (size_t)row0 * D;
      for (int i = tid; i < nrows * D; i += nt) ro.g_s[(size_t)row0 * D + i] += gs[i];
      __syncthreads();
    }
    // gradient wrt every particle's post-MM reward of step t (the loss's;
    // reward_cot gives the grid tier's per-particle one)
    const float c = (ro.sign * g_loss * ro.w_t[t] + g_mret) / B;
    const float* zm = st.z_mm ? st.z_mm + (size_t)t * B * D : nullptr;
    const float* zr = st.z_rr ? st.z_rr + (size_t)t * B : nullptr;
    // this block's partial sums: states gm[i], gL[i, j <= i]; rewards gm, gL
    if (tid < kPart) {
      float v = 0.f;
      if (ro.mm_states && tid < D) {
        for (int r = 0; r < nrows; ++r) v += ro.g_s[(size_t)(row0 + r) * D + tid];
      } else if (ro.mm_states && tid < D + nL) {
        int i = 0, q = tid - D;
        while (q > i) q -= ++i;  // q-th entry of the lower triangle, row-major
        const int j = q;
        for (int r = 0; r < nrows; ++r)
          v += ro.g_s[(size_t)(row0 + r) * D + i] * zm[(size_t)(row0 + r) * D + j];
      } else if (ro.r_mm && tid == D + nL) {
        for (int r = 0; r < nrows; ++r) v += reward_cot(ro, t, row0 + r, c);
      } else if (ro.r_mm && tid == D + nL + 1) {
        for (int r = 0; r < nrows; ++r) v += reward_cot(ro, t, row0 + r, c) * zr[row0 + r];
      }
      ro.part[((size_t)t * ro.nrb + blk) * kPart + tid] = v;
    }
    grid.sync();
    // totals over the owner blocks, one warp per partial sum, in a fixed order
    for (int p = tid >> 5; p < kPart; p += nt >> 5) {
      float v = 0.f;
      for (int q = tid & 31; q < ro.nrb; q += 32) v += ro.part[((size_t)t * ro.nrb + q) * kPart + p];
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
      if ((tid & 31) == 0) sh.tot[p] = v;
    }
    __syncthreads();
    const float* stat = ro.stats + (size_t)t * 2 * kStat;
    if (tid == 0 && ro.mm_states) {
      load_site(stat, D, sh.s);
      for (int i = 0, q = D; i < D; ++i) {
        sh.s.gm[i] = sh.tot[i];
        for (int j = 0; j < D; ++j) sh.s.gL[i * D + j] = j <= i ? sh.tot[q++] : 0.f;
      }
      mm_vjp_coeffs(sh.s.L, true, sh.s.gm, sh.s.gL, sh.s.sd, B, D, sh.s.H, sh.s.c0);
    }
    if (tid == 32 && ro.r_mm) {
      load_site(stat + kStat, 1, sh.r);
      sh.r.gm[0] = sh.tot[D + nL];
      sh.r.gL[0] = sh.tot[D + nL + 1];
      mm_vjp_coeffs(sh.r.L, true, sh.r.gm, sh.r.gL, sh.r.sd, B, 1, sh.r.H, sh.r.c0);
    }
    __syncthreads();
    // gradient wrt this block's pre-MM (nxt, r) of step t
    if (ro.mm_states) {
      mm_vjp_apply(ro.nxt_raw + (size_t)t * B * D, sh.s.m, sh.s.H, sh.s.c0, D, row0, nrows,
                   ro.g_nxt);
    } else {
      for (int i = tid; i < nrows * D; i += nt)
        ro.g_nxt[(size_t)row0 * D + i] = ro.g_s[(size_t)row0 * D + i];
    }
    if (ro.r_mm) {
      mm_vjp_apply(ro.r_raw + (size_t)t * B, sh.r.m, sh.r.H, sh.r.c0, 1, row0, nrows, ro.g_r);
    } else {
      for (int r = tid; r < nrows; r += nt) ro.g_r[row0 + r] = reward_cot(ro, t, row0 + r, c);
    }
    __syncthreads();
    lap(ro, sh, kBwdMM);
    Net pol = st.pol;
    StepGrads sg;
    sg.g_nxt = ro.g_nxt;
    sg.g_r = ro.g_r;
    sg.g_states = ro.g_s;
    sg.g_eps = ro.g_eps ? ro.g_eps + (size_t)t * B * U : nullptr;
    sg.g_pout = ro.g_pout + (size_t)t * B * 2 * U;
    sg.pol = ro.pw;
    for (int l = 0; l < pol.n; ++l) {
      pol.a[l] = ro.pol_a[l] + (size_t)t * B * pol.dims[l + 1];
      sg.pol.ga[l] = ro.pw.ga[l] + (size_t)t * B * pol.dims[l + 1];
    }
    tile_bwd(st, pol, ro.s_all + (size_t)t * B * D,
             st.eps ? st.eps + (size_t)t * B * U : nullptr, sg, tl, smem, row0, nrows);
    __syncthreads();
    lap(ro, sh, kBwdStep);
  }
  grid.sync();
  // the policy's dW and db over all T B rows (inputs s_0 ... s_{T-1}), the
  // tiles shared by every block of the grid
  Net pw = st.pol;
  pw.B = ro.T * B;
  for (int l = 0; l < pw.n; ++l) pw.a[l] = ro.pol_a[l];
  for (int t = blk; t < ro.pw.tile_start[pw.n + 1]; t += gridDim.x)
    wgrad_tile(pw, ro.pw, ro.s_all, ro.g_pout, t, B);
  lap(ro, sh, kDW);
}

__global__ void __launch_bounds__(kMaxThreads)
rollout_kernel(Step st, Roll ro, int phases) {
  extern __shared__ __align__(16) float smem[];
  __shared__ TileSm tl;
  __shared__ RollSm sh;
  cg::grid_group grid = cg::this_grid();
  if (ro.split && blockIdx.x == 0 && threadIdx.x == 0) sh.last_lap = globaltimer();
  // the forward's last grid sync already orders block 0's stats before the
  // backward reads them
  if (phases & kFwd) forward_sweep(st, ro, tl, sh, smem, grid);
  if (phases & kBwd) reverse_sweep(st, ro, tl, sh, smem, grid);
}

// ---- host side ----------------------------------------------------------------

int block_threads(int maxw) { return threads_for(maxw) > 256 ? threads_for(maxw) : 256; }

size_t g_allowed = 0;  // dynamic shared memory allowed so far

// Blocks of rollout_kernel that fit on the current device at once, for
// tiles of width maxw and `hidden` hidden units in all (both MLPs).
int capacity(int maxw, int hidden, int* blocks) {
  const size_t smem = (2 * (size_t)maxw + hidden) * TMP * sizeof(float);
  const void* k = reinterpret_cast<const void*>(rollout_kernel);
  if (smem > g_allowed) {
    const int e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    g_allowed = smem;
  }
  int dev = 0, sms = 0, per_sm = 0;
  *blocks = 0;
  if (block_threads(maxw) > kMaxThreads) return cudaSuccess;
  int e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, block_threads(maxw), smem);
  *blocks = per_sm * sms;
  return e;
}

int hidden_units(const Step& st) {
  int h = 0;
  for (int l = 0; l < st.pol.n; ++l) h += st.pol.dims[l + 1];
  for (int l = 0; l < st.dyn.n; ++l) h += st.dyn.dims[l + 1];
  return h;
}

int launch(const StepArgs* a, const RollArgs* r, int phases, void* stream) {
  Step st;
  if (!r || !fill_step(st, a) || r->T < 1 || !r->w_t || !r->s_all || !r->nxt_raw || !r->r_raw
      || !r->stats)
    return -1;
  const int r_mm = r->mm_rewards && !r->mean_only;
  if ((r->mm_states && !st.z_mm) || (r_mm && !st.z_rr)) return -1;
  const bool grid_fwd = r->disc != nullptr;
  if ((phases & kFwd) && !(grid_fwd ? r->raw && r->vret && r->vw_t
                                    : r->loss && r->mret && r->rowsum))
    return -1;
  if (r->g_disc && !(r->g_raw && r->g_vret && r->g_sall && r->vw_t)) return -1;
  if ((grid_fwd || r->g_disc) && r->mean_only) return -1;
  Roll ro = {};
  ro.T = r->T;
  ro.nrb = (st.B + TM - 1) / TM;
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
  ro.rowsum = r->rowsum;
  ro.part = r->part;
  ro.g_s = r->g_s;
  ro.g_nxt = r->g_nxt;
  ro.g_r = r->g_r;
  ro.g_pout = r->g_pout;
  if (phases & kBwd) {
    if (!ro.part || !ro.g_s || !ro.g_nxt || !ro.g_r || !ro.g_pout) return -1;
    const int np = st.pol.n;
    for (int l = 0; l < kMaxLayers; ++l) {
      const bool lin = l <= np, hid = l < np;
      ro.pw.dw[l] = lin ? r->dw[l] : nullptr;
      ro.pw.db[l] = lin ? r->db[l] : nullptr;
      ro.pw.dm[l] = nullptr;
      ro.pw.ga[l] = hid ? r->pol_ga[l] : nullptr;
      ro.pol_a[l] = hid ? r->pol_a[l] : nullptr;
      if ((lin && !ro.pw.dw[l]) || (hid && (!ro.pw.ga[l] || !ro.pol_a[l]))) return -1;
      if (lin && (st.pol.b[l] != nullptr) != (ro.pw.db[l] != nullptr)) return -1;
    }
    fill_tiles(st.pol, ro.pw);
  }
  const int maxw = max_width(st);
  int blocks = 0;
  int e = capacity(maxw, hidden_units(st), &blocks);
  if (e != cudaSuccess) return e;
  if (blocks < ro.nrb) return -2;
  // the backward's dW tiles go one to a block where the card holds that many
  int grid = ro.nrb;
  if ((phases & kBwd) && ro.pw.tile_start[st.pol.n + 1] > grid)
    grid = ro.pw.tile_start[st.pol.n + 1] < blocks ? ro.pw.tile_start[st.pol.n + 1] : blocks;
  void* args[] = {&st, &ro, &phases};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(rollout_kernel), grid,
                                  block_threads(maxw), args, bwd_smem(st),
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* fused_rollout_error(int e) {
  if (e == -2) return "the rollout's blocks cannot all be resident on the device at once";
  return e < 0 ? "arguments the kernel does not take"
               : cudaGetErrorString(static_cast<cudaError_t>(e));
}

// Sizes in bytes of the argument blocks (checked against the ctypes mirrors).
int fused_rollout_args_size() { return static_cast<int>(sizeof(StepArgs)); }
int fused_rollout_roll_size() { return static_cast<int>(sizeof(RollArgs)); }

// How many blocks of the rollout kernel the current device holds at once for
// MLP tiles of width maxw and `hidden` hidden units (both MLPs); the launch
// needs ceil(B / 8). Returns 0 or a cudaError_t.
int fused_rollout_capacity(int maxw, int hidden, int* blocks) {
  if (maxw < 1 || maxw > kMaxWidth || hidden < 0 || !blocks) return -1;
  return capacity(maxw, hidden, blocks);
}

// The forward (row 3): a->states is x0 [B, D], a->eps the action noise
// [T, B, U] (or null), a->z_mm / a->z_rr the prepared MM noise [T, B, D] /
// [T, B, 1]. Writes loss, mret and the residuals s_all, nxt_raw, r_raw, stats
// that the backward takes. Returns 0, a cudaError_t, -1 or -2.
int fused_rollout_fwd(const StepArgs* a, const RollArgs* r, void* stream) {
  if (!r || r->disc) return -1;
  return launch(a, r, kFwd, stream);
}

// The backward (row 4) from the forward's residuals and the cotangents
// r->g_loss, r->g_mret: policy dW, db and (when r->g_eps) the gradient wrt
// the action noise.
int fused_rollout_bwd(const StepArgs* a, const RollArgs* r, void* stream) {
  if (!r || !r->g_loss || !r->g_mret || r->g_disc) return -1;
  return launch(a, r, kBwd, stream);
}

// Value and grad (row 5): both sweeps in one launch with g_loss = 1 and
// g_mret = 0.
int fused_rollout_vg(const StepArgs* a, const RollArgs* r, void* stream) {
  if (!r || r->g_loss || r->g_mret || r->disc || r->g_disc) return -1;
  return launch(a, r, kFwd | kBwd, stream);
}

// The grid tier's forward (row 8): as fused_rollout_fwd with r->vw_t, but
// writes the per-particle r->disc, r->raw, r->vret [B] (no loss, no
// mean_return); the boundary states r->s_all[1:] are states_all.
int fused_grid_fwd(const StepArgs* a, const RollArgs* r, void* stream) {
  if (!r || !r->disc || r->loss || r->mret || r->g_disc) return -1;
  return launch(a, r, kFwd, stream);
}

// The grid tier's backward (row 9) from fused_grid_fwd's residuals and the
// cotangents r->g_disc, r->g_raw, r->g_vret [B] and r->g_sall [T, B, D]:
// policy dW, db and (when r->g_eps) the gradient wrt the action noise.
int fused_grid_bwd(const StepArgs* a, const RollArgs* r, void* stream) {
  if (!r || !r->g_disc || r->g_loss || r->g_mret || r->disc) return -1;
  return launch(a, r, kBwd, stream);
}

}  // extern "C"
