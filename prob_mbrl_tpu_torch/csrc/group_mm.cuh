// Grouped moment matching (mm_groups G): the B particles fall into G
// contiguous groups of Bg = B / G, and each resample site is matched per
// group: the group's mean m_g, covariance S_g = sum (x - m_g)(x - m_g)^T /
// (Bg - 1), its own safe Cholesky L_g (its own scale, tolerance and first ok
// jitter, NaN where none is ok), and out = m_g + z L_g^T with z standardized
// per group. Shared by the whole-rollout kernel (rollout_kernel.cuh, its
// grouped instances) and the step kernels (fused_step.cu, group_fwd_kernel
// and group_bwd_kernel).
//
// Replaces the grouped branch of the Pallas kernel bodies of
// prob_mbrl_tpu/ops/pallas/fused_rollout.py: _mm_resample_grouped_kf
// (:375-410) with _safe_cholesky_grouped_t (:300-364) in make_loss_impl
// (rows 3-5, with the per-group reward mean of the mean-only shortcut,
// :537-541, :583-591), make_step_impl (rows 6-7, :1079-1129) and the grid
// kernels (rows 8-9, :1382). The TPU version packs all groups' factors into
// lane-major blocks of constant indicator matrices, a layout for Mosaic; here
// a group is a few lanes of a warp.
//
// Design. W lanes share a group: the smallest power of 2 >= Bg, at most 32,
// so a warp holds 32 / W groups. Lane j of a group takes its rows j, j + W,
// ...; every sum is then added over the W lanes by a butterfly of xor
// shuffles, which leaves the same bits in all W (each level adds the same
// two numbers in either order), so every lane factors the group's
// covariance itself (safe_chol, D <= 8) and resamples its own rows: no
// exchange, no barrier, results that repeat bit for bit. The moments are
// two-pass (the mean, then the centred second moments and centred sums);
// the adjoint takes the group's sums of g and g z^T and mm_vjp_coeffs with
// Bg for B. What bounds it: at D = 5 a group's moments are ~25 sums of Bg
// rows and ~25 xor butterflies, its factor ~50 multiply-adds a try, all on
// the group's lanes; latency, not bytes or operations.
//
// The wide instance (PMBRL_WIDE, D <= 16): a group's sites of 16 x 16 do not
// fit a lane's registers, so one warp takes a group (W = 32) and keeps its
// sites in shared memory (GroupSite, GroupAdjoint: one each a warp, the
// caller's), lane e % 32 sums entry e of the moments (or of the adjoint's
// sums) over the group's rows in order straight into them, and the warp
// factors (safe_chol_warp) and differentiates (mm_vjp_coeffs_warp) it. Every
// lane of the warp calls these with a warp-uniform group.
#pragma once

#include "cluster_walk.cuh"

namespace {

// One group's resample sites on one lane: the states' mean, covariance,
// factor and centred sums, and the reward's (D = 1).
struct GroupSite {
  float m[kMaxD], S[kMaxD * kMaxD], L[kMaxD * kMaxD], sd[kMaxD];
  float rm, rS, rL, rsd;
};

// Lanes that share a group of Bg particles: the smallest power of 2 >= Bg,
// at most 32 (the wide instance: a warp).
__host__ __device__ __forceinline__ int group_lanes(int Bg) {
  if (kWide) return 32;
  int w = 1;
  while (w < Bg && w < 32) w <<= 1;
  return w;
}

// v summed over the W aligned lanes of a group (W a power of 2) by a xor
// butterfly: the same bits in all W. Every lane of the warp must call it.
__device__ __forceinline__ float lanes_sum(float v, int W) {
  for (int o = W >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

#if !PMBRL_WIDE
// The moments of a group's Bg rows: x(q, k) is feature k of its row q, r(q)
// the row's reward; the states' with `states`, the reward's with `reward`.
// Lane j (of the group's W) takes rows j, j + W, ..., each row's features
// loaded together (one latency for a row another cluster holds in device
// memory) into registers, in two passes (the sums, then the centred second
// moments and sums); `on` false: this lane's group does not exist, it adds
// nothing but takes part in the shuffles. Every lane of the warp must call
// it with the same Bg, D, W and flags.
template <class X, class R>
__device__ void group_moments(const X& x, const R& r, int Bg, int D, int W, bool on, bool states,
                              bool reward, GroupSite& g) {
  const int j = threadIdx.x & (W - 1), n = on ? Bg : 0;
  const int Ds = states ? D : 0;
  float s[kMaxD], sr = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxD; ++k) s[k] = 0.f;
  for (int q = j; q < n; q += W) {
#pragma unroll
    for (int k = 0; k < kMaxD; ++k)
      if (k < Ds) s[k] += x(q, k);
    if (reward) sr += r(q);
  }
  float m[kMaxD];
#pragma unroll
  for (int k = 0; k < kMaxD; ++k) m[k] = k < Ds ? lanes_sum(s[k], W) / Bg : 0.f;
  const float rm = reward ? lanes_sum(sr, W) / Bg : 0.f;
  float m2[kTri], sd[kMaxD], r2 = 0.f, r1 = 0.f;
#pragma unroll
  for (int e = 0; e < kTri; ++e) m2[e] = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxD; ++k) sd[k] = 0.f;
  for (int q = j; q < n; q += W) {
    float d[kMaxD];
#pragma unroll
    for (int k = 0; k < kMaxD; ++k) d[k] = k < Ds ? x(q, k) - m[k] : 0.f;
#pragma unroll
    for (int i = 0; i < kMaxD; ++i) {
#pragma unroll
      for (int k = 0; k <= i; ++k) m2[i * (i + 1) / 2 + k] += d[i] * d[k];
      sd[i] += d[i];
    }
    if (reward) {
      const float e = r(q) - rm;
      r2 += e * e;
      r1 += e;
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxD; ++i) {
    if (i >= Ds) continue;
    g.m[i] = m[i];
#pragma unroll
    for (int k = 0; k <= i; ++k)
      g.S[i * D + k] = g.S[k * D + i] = lanes_sum(m2[i * (i + 1) / 2 + k], W) / (Bg - 1);
    g.sd[i] = lanes_sum(sd[i], W);
  }
  if (reward) {
    g.rm = rm;
    g.rS = lanes_sum(r2, W) / (Bg - 1);
    g.rsd = lanes_sum(r1, W);
  }
}

// The safe Cholesky factor of each resampled site.
__device__ __forceinline__ void group_factor(GroupSite& g, int D, bool states, bool reward) {
  if (states) safe_chol(g.S, D, g.L);
  if (reward) safe_chol(&g.rS, 1, &g.rL);
}

#else
// The moments of a group's Bg rows (the wide instance): x(q, k) is feature
// k of its row q, r(q) the row's reward. Entry by entry (each mean, then each
// centred second moment and centred sum about the means), lane j adds rows
// j, j + 32, ... and a xor butterfly adds the lanes: the narrow instance's
// sums at W = 32, so the same bits where its groups span a warp. Lane 0
// writes each sum into g (shared memory).
template <class X, class R>
__device__ void group_moments(const X& x, const R& r, int Bg, int D, int W, bool on, bool states,
                              bool reward, GroupSite& g) {
  const int lane = threadIdx.x & 31, n = on ? Bg : 0;
  const int Ds = states ? D : 0, nT = Ds * (Ds + 1) / 2;
  __syncwarp();  // the warp's last group is read no more
  for (int k = 0; k < Ds + (reward ? 1 : 0); ++k) {  // uniform in the warp
    float s = 0.f;
    for (int q = lane; q < n; q += 32) s += k < Ds ? x(q, k) : r(q);
    s = lanes_sum(s, 32) / Bg;
    if (lane == 0) (k < Ds ? g.m[k] : g.rm) = s;
  }
  __syncwarp();
  for (int e = 0; e < nT + Ds + (reward ? 2 : 0); ++e) {  // uniform in the warp
    float v = 0.f;
    if (e < nT) {
      int i, j;
      tri_of(e, i, j);
      const float mi = g.m[i], mj = g.m[j];
      for (int q = lane; q < n; q += 32) v += (x(q, i) - mi) * (x(q, j) - mj);
    } else if (e < nT + Ds) {
      const float mi = g.m[e - nT];
      for (int q = lane; q < n; q += 32) v += x(q, e - nT) - mi;
    } else {
      for (int q = lane; q < n; q += 32) {
        const float d = r(q) - g.rm;
        v += e == nT + Ds ? d * d : d;
      }
    }
    v = lanes_sum(v, 32);
    if (lane) continue;
    if (e < nT) {
      int i, j;
      tri_of(e, i, j);
      g.S[i * D + j] = g.S[j * D + i] = v / (Bg - 1);
    } else if (e < nT + Ds) {
      g.sd[e - nT] = v;
    } else if (e == nT + Ds) {
      g.rS = v / (Bg - 1);
    } else {
      g.rsd = v;
    }
  }
  __syncwarp();
}

// The safe Cholesky factor of each resampled site, on the warp.
__device__ __forceinline__ void group_factor(GroupSite& g, int D, bool states, bool reward) {
  if (states) safe_chol_warp(g.S, D, g.L);
  if (reward) safe_chol_warp(&g.rS, 1, &g.rL);
}

#endif

// (m, sd, L) of the resampled sites into dst [2][kStat] (save_site's
// layout).
__device__ void group_save(const GroupSite& g, int D, bool states, bool reward, float* dst) {
  if (states) {
    for (int i = 0; i < D; ++i) {
      dst[i] = g.m[i];
      dst[kMaxD + i] = g.sd[i];
    }
    for (int i = 0; i < D * D; ++i) dst[2 * kMaxD + i] = g.L[i];
  }
  if (reward) {
    dst[kStat] = g.rm;
    dst[kStat + kMaxD] = g.rsd;
    dst[kStat + 2 * kMaxD] = g.rL;
  }
}

// group_save's sites back, from device memory written in this launch or an
// earlier one (loads past L1); the wide instance's on the warp.
__device__ void group_load(const float* src, int D, GroupSite& g) {
#if PMBRL_WIDE
  const int lane = threadIdx.x & 31;
  __syncwarp();  // the warp's last group is read no more
  for (int i = lane; i < D; i += 32) {
    g.m[i] = __ldcg(src + i);
    g.sd[i] = __ldcg(src + kMaxD + i);
  }
  for (int i = lane; i < D * D; i += 32) g.L[i] = __ldcg(src + 2 * kMaxD + i);
  if (lane == 0) {
    g.rm = __ldcg(src + kStat);
    g.rsd = __ldcg(src + kStat + kMaxD);
    g.rL = __ldcg(src + kStat + 2 * kMaxD);
  }
  __syncwarp();
#else
  for (int i = 0; i < D; ++i) {
    g.m[i] = __ldcg(src + i);
    g.sd[i] = __ldcg(src + kMaxD + i);
  }
  for (int i = 0; i < D * D; ++i) g.L[i] = __ldcg(src + 2 * kMaxD + i);
  g.rm = __ldcg(src + kStat);
  g.rsd = __ldcg(src + kStat + kMaxD);
  g.rL = __ldcg(src + kStat + 2 * kMaxD);
#endif
}

// Row q of the group resampled: out[k] = m[k] + sum_{j <= k} z[j] L[k, j].
__device__ __forceinline__ void group_resample_row(const GroupSite& g, int D, const float* z,
                                                   float* out) {
  for (int k = 0; k < D; ++k) {
    float acc = 0.f;
    for (int j = 0; j <= k; ++j) acc += z[j] * g.L[k * D + j];
    out[k] = g.m[k] + acc;
  }
}

// The adjoint of a group's resample: from the cotangents g(q, k) of its
// resampled rows, z(q, k) its noise, gr(q) / zr(q) the reward's, the sums
// g_m and g_L (lower) of each site over the group's rows and mm_vjp_coeffs
// with Bg particles: H, c0 of the states into (H, c0), the reward's into
// (rH, rc0). Called as group_moments.
#if !PMBRL_WIDE
struct GroupAdjoint {
  float H[kMaxD * kMaxD], c0[kMaxD], rH, rc0;
};

template <class Gs, class Zs, class Gr, class Zr>
__device__ void group_adjoint(const Gs& gs, const Zs& zs, const Gr& gr, const Zr& zr, int Bg, int D,
                              int W, bool on, bool states, bool reward, const GroupSite& site,
                              GroupAdjoint& a) {
  const int j = threadIdx.x & (W - 1), n = on ? Bg : 0;
  const int Ds = states ? D : 0;
  float sm[kMaxD], sl[kTri], v = 0.f, w = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxD; ++k) sm[k] = 0.f;
#pragma unroll
  for (int e = 0; e < kTri; ++e) sl[e] = 0.f;
  for (int q = j; q < n; q += W) {  // each row's cotangent and noise loaded together
    float gv[kMaxD], zv[kMaxD];
#pragma unroll
    for (int k = 0; k < kMaxD; ++k) {
      gv[k] = k < Ds ? gs(q, k) : 0.f;
      zv[k] = k < Ds ? zs(q, k) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kMaxD; ++i) {
      sm[i] += gv[i];
#pragma unroll
      for (int k = 0; k <= i; ++k) sl[i * (i + 1) / 2 + k] += gv[i] * zv[k];
    }
    if (reward) {
      const float c = gr(q);
      v += c;
      w += c * zr(q);
    }
  }
  if (states) {
    float gm[kMaxD], gL[kMaxD * kMaxD];
#pragma unroll
    for (int i = 0; i < kMaxD; ++i) {
      if (i >= D) continue;
      gm[i] = lanes_sum(sm[i], W);
#pragma unroll
      for (int k = 0; k < kMaxD; ++k)
        if (k < D) gL[i * D + k] = k <= i ? lanes_sum(sl[i * (i + 1) / 2 + k], W) : 0.f;
    }
    if (on) mm_vjp_coeffs(site.L, true, gm, gL, site.sd, Bg, D, a.H, a.c0);
  }
  if (reward) {
    float gm = lanes_sum(v, W), gL = lanes_sum(w, W);
    if (on) mm_vjp_coeffs(&site.rL, true, &gm, &gL, &site.rsd, Bg, 1, &a.rH, &a.rc0);
  }
}

#else
// The wide instance's: the sums gm, gL (lower, zero above) and the reward's
// two beside the coefficients, all in shared memory.
struct GroupAdjoint {
  float H[kMaxD * kMaxD], c0[kMaxD], gm[kMaxD], gL[kMaxD * kMaxD];
  float rH, rc0, rgm, rgL;
};

template <class Gs, class Zs, class Gr, class Zr>
__device__ void group_adjoint(const Gs& gs, const Zs& zs, const Gr& gr, const Zr& zr, int Bg, int D,
                              int W, bool on, bool states, bool reward, const GroupSite& site,
                              GroupAdjoint& a) {
  const int lane = threadIdx.x & 31, n = on ? Bg : 0;
  const int Ds = states ? D : 0, nT = Ds * (Ds + 1) / 2;
  // entry by entry as group_moments: sum g, sum g z^T (lower), the reward's
  for (int e = 0; e < Ds + nT + (reward ? 2 : 0); ++e) {  // uniform in the warp
    float v = 0.f;
    int i = 0, j = 0;
    if (e < Ds) {
      for (int q = lane; q < n; q += 32) v += gs(q, e);
    } else if (e < Ds + nT) {
      tri_of(e - Ds, i, j);
      for (int q = lane; q < n; q += 32) v += gs(q, i) * zs(q, j);
    } else if (e == Ds + nT) {
      for (int q = lane; q < n; q += 32) v += gr(q);
    } else {
      for (int q = lane; q < n; q += 32) v += gr(q) * zr(q);
    }
    v = lanes_sum(v, 32);
    if (lane) continue;
    if (e < Ds) {
      a.gm[e] = v;
    } else if (e < Ds + nT) {
      a.gL[i * D + j] = v;
      if (i != j) a.gL[j * D + i] = 0.f;
    } else if (e == Ds + nT) {
      a.rgm = v;
    } else {
      a.rgL = v;
    }
  }
  __syncwarp();
  if (!on) return;
  if (states) mm_vjp_coeffs_warp(site.L, a.gm, a.gL, site.sd, Bg, D, a.H, a.c0);
  if (reward) mm_vjp_coeffs_warp(&site.rL, &a.rgm, &a.rgL, &site.rsd, Bg, 1, &a.rH, &a.rc0);
}

#endif

// The gradient wrt a pre-MM row x (raw) of the group: H (x - m) + c0.
__device__ __forceinline__ void group_vjp_row(const GroupAdjoint& a, const GroupSite& g, int D,
                                              const float* raw, float* out) {
  for (int k = 0; k < D; ++k) {
    float acc = 0.f;
    for (int k2 = 0; k2 < D; ++k2) acc += a.H[k * D + k2] * (raw[k2] - g.m[k2]);
    out[k] = acc + a.c0[k];
  }
}

}  // namespace
