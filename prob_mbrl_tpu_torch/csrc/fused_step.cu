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
//   -> nxt = s + delta -> the reward on the pre-MM nxt (StepArgs::reward_kind:
//      the exp-quadratic tip reward, rendezvous's negative quadratic, the
//      lunar lander's shaping potential and gated fuel costs, or a learned
//      reward, the dynamics head's output D, :1114-1118)
//   -> moment-matching resample of nxt (D) and of r (D = 1), Cholesky path
//      with the escalating jitter of _safe_cholesky_kf (:117-203), or per
//      group of B / G rows (mm_groups G, _mm_resample_grouped_kf, :375-410).
//
// Bound at the main-path shapes (policy 5->200->200->2, dynamics
// 6->200->200->10): ~0.17 MFLOP of float32 products per particle forward and
// ~0.43 backward (the recompute, both dx chains and the policy's dW), so
// ~17 MFLOP at B = 100 (0.26 us at the 67 TFLOP/s non-tensor-core peak) and
// ~1 GFLOP at B = 5761 (~15 us). Both are chains of dependent layer products
// and of a reduction over all particles, so latency sets the time at
// B = 100 and the rows a pass walks at a time at B = 5761.
//
// Design (the cluster walk of cluster_walk.cuh, shared with the whole-rollout
// kernel of fused_rollout.cu). Normal launches (not cooperative) of
// thread-block clusters of 8 CTAs, so a batch of any size runs and a CUDA
// graph captures them: the step tier takes the batches beyond what the card
// holds of the whole rollout at once. Cluster c of nc walks row tiles c,
// c + nc, c + 2 nc, ... of TR rows; each CTA stages its rows of every weight
// once per launch. The launch plan (clusters, tile rows, tiles, threads,
// resident or streamed weights, shared memory, the MM adjoint's blocks,
// scratch) comes from step_plan() in fused_rollout.py and is checked here
// (step_lay_of).
//   forward (one launch): the step's forward on each tile; rank 0 of the
//     cluster writes the pre-MM (nxt, r) and merges the tile's moments
//     (count, mean, centred M2 and sums, Chan's update) into the cluster's.
//     Each cluster leaves one partial in scratch and takes a ticket; the
//     last to arrive (__threadfence and an atomic counter, reset to 0 for
//     the next launch or graph replay) merges the partials in cluster order,
//     runs the safe Cholesky, keeps (m, sd, L) of each site for the backward
//     and resamples all B rows: out = m + z L^T.
//   backward (two launches): step_sums_kernel, blocks of kSumThreads rows,
//     reduces g_m = sum_b g[b] and g_L = sum_b g[b] z[b]^T of each site; the
//     last block sums the blocks' partials in order and runs the adjoint
//     (mm_vjp_coeffs) to (H, c0). Then step_bwd_kernel walks the tiles: the
//     gradient wrt the tile's pre-MM outputs, H (x - m) + c0, in shared
//     memory; the recompute of the step's forward from its inputs; every VJP
//     by hand (step_vjp); the policy's dW and db added to a per-CTA
//     accumulator as the walk goes; g_states and g_eps written out. The
//     last cluster to finish sums the clusters' dW partials in cluster order.
// Grouped (G > 1): the forward's walk writes the pre-MM rows and no moments,
//   then group_fwd_kernel matches each group on a few lanes of a warp
//   (group_mm.cuh: its moments, its own safe Cholesky, its rows resampled,
//   its (m, sd, L) kept in stats [G, 2, kStat]); the backward's
//   group_bwd_kernel forms each group's adjoint sums and coefficients and
//   the gradient wrt its pre-MM rows into scratch, which the walk then takes
//   as its incoming gradient (no step_sums_kernel).
// The counters order the work; no value is summed by an atomic, so results
// repeat bit for bit. Dynamics parameters and masks get no gradient (the
// step differentiates wrt the policy parameters, the states and eps only).
// Every hidden activation relu (the main path's) is a kernel instance of its
// own that applies relu as a constant.

#include "group_mm.cuh"

// the plan's fields, in the order of fused_rollout.py's StepPlan
enum StepPlanField {
  kSPCluster, kSPClusters, kSPTileRows, kSPTiles, kSPThreads, kSPResident, kSPSmem,
  kSPSumBlocks, kSPScratch, kSPLen
};

namespace {

// The step kernels' own part of the layout (step_lay_of): the row tiles, the
// backward's gradient wrt the tile's pre-MM outputs (floats into shared
// memory, [TR][kMaxD] then [TR]) and the scratch (floats) of the forward's
// partials, of the blocks' partials of the MM adjoint's sums and of its
// coefficients.
struct Tiles {
  int tiles, gin, s_part, s_sum, s_coef, s_gpre;  // s_gpre: grouped, [B, D] + [B]
};

constexpr int kSumThreads = 256;  // rows of a block of the MM adjoint's sums
constexpr int kGroupThreads = 256;  // threads of a block of the grouped resample
constexpr int kCoef = kMaxD * kMaxD + kMaxD;  // H and c0 of one resample site
// the launches' counters (int scratch, zero between launches)
constexpr int kTicketFwd = 0, kTicketSums = 1, kTicketDw = 2, kTickets = 3;

// What the forward writes.
struct StepIo {
  int mm_states, r_mm;
  float *nxt_raw, *r_raw;  // [B, D], [B] before the resample
  float *nxt, *r;          // [B, D], [B] (the pre-MM buffers without a resample)
  float* stats;            // [2, kStat] (m, sd, L) of the state and reward sites
  float* scratch;
  int* tickets;
};

// What the backward reads and writes.
struct StepGrad {
  int B, D, mm_states, r_mm;
  const float *nxt_raw, *r_raw, *stats;  // the forward's residuals
  const float *g_nxt, *g_r;              // gradients wrt the outputs (nxt, r)
  const float *z_mm, *z_rr;              // the step's MM noise
  float *g_states, *g_eps;               // [B, D], [B, U] or null
  float* scratch;
  int* tickets;
  float* dw[kMaxLayers];
  float* db[kMaxLayers];
};

struct StepSm {
  Site s, r;               // states, rewards
  float part[2][kPart];    // the moments of this CTA's tiles so far, then a tile's
  float merged[kPart];
  int last;                // this cluster took the last ticket
};

// The step and the layout from the parameter space into shared memory: the
// walks index their fields by layer all through.
__device__ __forceinline__ void copy_params(const Step& st, const Lay& lay, Step& st_s,
                                            Lay& lay_s) {
  static_assert(sizeof(StepSm) + sizeof(Step) + sizeof(Lay) <= kStaticSmem - 512, "static smem");
  static_assert(sizeof(Step) % 4 == 0 && sizeof(Lay) % 4 == 0, "word copies");
  for (int i = threadIdx.x; i < (int)(sizeof(Step) / 4); i += blockDim.x)
    reinterpret_cast<int*>(&st_s)[i] = reinterpret_cast<const int*>(&st)[i];
  for (int i = threadIdx.x; i < (int)(sizeof(Lay) / 4); i += blockDim.x)
    reinterpret_cast<int*>(&lay_s)[i] = reinterpret_cast<const int*>(&lay)[i];
  __syncthreads();
}

// Whether this cluster is the last of nc to take ticket `t` (rank 0 takes it
// and tells every CTA of the cluster); the caller's writes to device memory
// are ordered before the ticket (each thread's __threadfence, then the
// cluster barrier). All threads of the cluster must call it.
__device__ bool last_cluster(int* tickets, int t, int rank, int nc, StepSm& sh) {
  __threadfence();
  cluster_sync();
  if (rank == 0 && threadIdx.x == 0) {
    const int last = atomicAdd(tickets + t, 1) == nc - 1;
    __threadfence();
    for (int r = 0; r < kCluster; ++r) *remote(&sh.last, r) = last;
  }
  cluster_sync();
  return sh.last != 0;
}

// A load of rows written in this launch by other CTAs (kGlobal: from device
// memory, past L1) or of the tile arrays.
template <bool kGlobal>
__device__ __forceinline__ float ld_rows(const float* p) {
  return kGlobal ? __ldcg(p) : *p;
}

// The moments of n pre-MM rows into the partial tp: feature i of row p of
// nxt at x[i * fs + p * rs], r at rr[p]. Ends with __syncthreads().
template <bool kGlobal>
__device__ void rows_moments(const float* x, int fs, int rs, const float* rr, int D, int n,
                             float* tp) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int nT = D * (D + 1) / 2;
  for (int w = warp; w <= D; w += nw) {  // means; warp D: the rewards
    float v = 0.f;
    for (int p = lane; p < n; p += 32)
      v += ld_rows<kGlobal>(w < D ? x + w * fs + p * rs : rr + p);
    v = warp_sum(v);
    if (lane == 0) tp[w < D ? kFMean + w : kFR] = v / n;
  }
  if (tid == 0) tp[kFN] = static_cast<float>(n);
  __syncthreads();
  for (int e = warp; e < nT + D + 2; e += nw) {  // centred second moments and sums
    float v = 0.f;
    if (e < nT) {
      int i, j;
      tri_of(e, i, j);
      const float mi = tp[kFMean + i], mj = tp[kFMean + j];
      for (int p = lane; p < n; p += 32)
        v += (ld_rows<kGlobal>(x + i * fs + p * rs) - mi)
             * (ld_rows<kGlobal>(x + j * fs + p * rs) - mj);
    } else if (e < nT + D) {
      const int i = e - nT;
      const float mi = tp[kFMean + i];
      for (int p = lane; p < n; p += 32) v += ld_rows<kGlobal>(x + i * fs + p * rs) - mi;
    } else {
      const float mr = tp[kFR];
      for (int p = lane; p < n; p += 32) {
        const float d = ld_rows<kGlobal>(rr + p) - mr;
        v += e == nT + D ? d * d : d;
      }
    }
    v = warp_sum(v);
    if (lane == 0) {
      if (e < nT) tp[kFM2 + e] = v;
      else if (e < nT + D) tp[kFSd + e - nT] = v;
      else tp[kFR + 1 + (e - nT - D)] = v;
    }
  }
  __syncthreads();
}

// Merges the partials q [np][kPart] (shared memory, the first with a count)
// in order into one partial, out: the count, the merged means, M2 and the
// centred sums about the merged means (the pairwise update of Chan et al.,
// one thread per entry, as the whole-rollout kernel's fwd_moments). Ends
// with __syncthreads().
__device__ void merge_parts(const float* q, int np, int D, float* out) {
  const int tid = threadIdx.x, nt = blockDim.x, nT = D * (D + 1) / 2;
  for (int e = tid; e < nT + D + 2; e += nt) {
    if (e <= nT) {  // M2: the states' lower triangle, the reward's
      int i = 0, j = 0, mo = kFR, m2 = kFR + 1;
      if (e < nT) {
        tri_of(e, i, j);
        mo = kFMean;
        m2 = kFM2 + e;
      }
      float nn = 0.f, mi = 0.f, mj = 0.f, M = 0.f;
      for (int p = 0; p < np; ++p) {
        const float* pc = q + p * kPart;
        const float nb = pc[kFN], tot = nn + nb;
        const float di = pc[mo + i] - mi, dj = pc[mo + j] - mj;
        M += pc[m2] + di * dj * (nn * nb / tot);
        mi += di * (nb / tot);
        mj += dj * (nb / tot);
        nn = tot;
      }
      out[m2] = M;
      continue;
    }
    // a mean and the centred sum about it; k = D: the reward's
    const int k = e - nT - 1;
    const int mo = k < D ? kFMean + k : kFR, so = k < D ? kFSd + k : kFR + 2;
    float nn = 0.f, m = 0.f;
    for (int p = 0; p < np; ++p) {
      const float* pc = q + p * kPart;
      const float nb = pc[kFN], tot = nn + nb;
      m += (pc[mo] - m) * (nb / tot);
      nn = tot;
    }
    float sd = 0.f;
    for (int p = 0; p < np; ++p) {
      const float* pc = q + p * kPart;
      sd += pc[so] + pc[kFN] * (pc[mo] - m);
    }
    out[mo] = m;
    out[so] = sd;
    if (k == 0) out[kFN] = nn;
  }
  __syncthreads();
}

// The resample sites from the merged partial of all B particles: mean m,
// unbiased covariance S (both halves) and the centred sums sd of the states
// and of the reward. Ends with __syncthreads().
__device__ void sites_of(const float* p, int D, int B, Site& ss, Site& sr) {
  const int nT = D * (D + 1) / 2;
  for (int e = threadIdx.x; e <= nT; e += blockDim.x) {
    if (e == nT) {
      sr.S[0] = p[kFR + 1] / (B - 1);
      sr.m[0] = p[kFR];
      sr.sd[0] = p[kFR + 2];
      continue;
    }
    int i, j;
    tri_of(e, i, j);
    ss.S[i * D + j] = ss.S[j * D + i] = p[kFM2 + e] / (B - 1);
    if (i == j) {
      ss.m[i] = p[kFMean + i];
      ss.sd[i] = p[kFSd + i];
    }
  }
  __syncthreads();
}

template <bool kReluOnly>
__global__ void __launch_bounds__(kMaxThreads, 1)
step_fwd_kernel(const __grid_constant__ Step st, const __grid_constant__ Lay lay,
                const __grid_constant__ Tiles tl, const __grid_constant__ StepIo io) {
  extern __shared__ __align__(16) float smem[];
  __shared__ StepSm sh;
  __shared__ Step st_s;
  __shared__ Lay lay_s;
  copy_params(st, lay, st_s, lay_s);
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int cid = blockIdx.x / kCluster, nc = gridDim.x / kCluster;
  Ctx c{smem, lay_s, rank, cid, 0, 0, 0};
  const Step& s = st_s;
  const int D = s.D, B = s.B, tid = threadIdx.x, nt = blockDim.x;
  const int TR = lay_s.TR, TRP = lay_s.TRP;
  const bool mm = io.mm_states || io.r_mm;
  const float* ts = smem + lay_s.tsm;
  stage(c, s, nullptr);
  const int first = rank * nt + tid, stride = kCluster * nt;
  for (int t = cid; t < tl.tiles; t += nc) {
    const int row0 = t * TR, nrows = min(TR, B - row0);
    step_fwd<kReluOnly>(c, s, s.states + (size_t)row0 * D, s.eps, row0, nrows, false);
    // the CTAs hold the same tile arrays: each writes its share of the rows
    for (int e = first; e < nrows * D; e += stride) {
      const int r = e / D, k = e - r * D;
      io.nxt_raw[(size_t)(row0 + r) * D + k] = ts[(kTNxt + k) * TRP + r];
    }
    for (int r = first; r < nrows; r += stride) io.r_raw[row0 + r] = ts[kTR * TRP + r];
  }
  if (!mm) return;
  // the moments of the cluster's J tiles: tile j of its walk by CTA j % 8,
  // the last one from the tile arrays, the others from the rows written
  // above (ordered before these reads by the fence and the cluster
  // barrier); then rank 0 merges the CTAs' partials in rank order into the
  // cluster's
  const int J = (tl.tiles - cid + nc - 1) / nc;
  if (J > 1) {
    __threadfence();
    cluster_sync();
  }
  for (int j = rank; j < J; j += kCluster) {
    const int row0 = (cid + j * nc) * TR, n = min(TR, B - row0);
    float* tp = sh.part[j == rank ? 0 : 1];
    if (j == J - 1)
      rows_moments<false>(ts + kTNxt * TRP, TRP, 1, ts + kTR * TRP, D, n, tp);
    else
      rows_moments<true>(io.nxt_raw + (size_t)row0 * D, 1, D, io.r_raw + row0, D, n, tp);
    if (j == rank) continue;
    merge_parts(sh.part[0], 2, D, sh.merged);
    for (int e = tid; e < kPart; e += nt) sh.part[0][e] = sh.merged[e];
    __syncthreads();
  }
  float* parts = c.region(0);  // free from here (step_lay_of checks the room)
  const float* part = sh.part[0];
  if (J > 1) {
    cluster_sync();
    if (rank == 0) {
      const int np = min(J, kCluster);  // the CTAs with a tile
      for (int e = tid; e < np * kPart; e += nt)
        parts[e] = *remote(&sh.part[0][e % kPart], e / kPart);
      __syncthreads();
      merge_parts(parts, np, D, sh.merged);
      part = sh.merged;
    }
  }
  if (rank == 0)
    for (int e = tid; e < kPart; e += nt) io.scratch[tl.s_part + cid * kPart + e] = part[e];
  if (!last_cluster(io.tickets, kTicketFwd, rank, nc, sh)) return;
  // the last cluster: every CTA merges the clusters' partials in order (the
  // same bits in all), factors, and resamples its share of the rows
  for (int e = tid; e < nc * kPart; e += nt) parts[e] = __ldcg(io.scratch + tl.s_part + e);
  __syncthreads();
  merge_parts(parts, nc, D, sh.merged);
  sites_of(sh.merged, D, B, sh.s, sh.r);
#if PMBRL_WIDE
  if (tid < 32 && io.mm_states) {  // the whole warp: safe_chol_warp
    safe_chol_warp(sh.s.S, D, sh.s.L);
    if (rank == 0 && tid == 0) save_site(sh.s, D, io.stats);
  }
#else
  if (tid == 0 && io.mm_states) {
    safe_chol(sh.s.S, D, sh.s.L);
    if (rank == 0) save_site(sh.s, D, io.stats);
  }
#endif
  if (tid == 32 && io.r_mm) {
    safe_chol(sh.r.S, 1, sh.r.L);
    if (rank == 0) save_site(sh.r, 1, io.stats + kStat);
  }
  if (rank == 0 && tid == 0) io.tickets[kTicketFwd] = 0;
  __syncthreads();
  if (io.mm_states)
    for (int e = first; e < B * D; e += stride) {
      const int b = e / D, k = e - b * D;
      float acc = 0.f;
      for (int j = 0; j <= k; ++j) acc += s.z_mm[(size_t)b * D + j] * sh.s.L[k * D + j];
      io.nxt[e] = sh.s.m[k] + acc;
    }
  if (io.r_mm)
    for (int b = first; b < B; b += stride) io.r[b] = sh.r.m[0] + s.z_rr[b] * sh.r.L[0];
}

// Adds v over the warp and leaves it in red[warp][e].
__device__ __forceinline__ void put_sum(float (*red)[kPartB], int e, float v) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5][e] = v;
}

// The MM adjoint's sums over this block's rows (one a thread): the states'
// g_m = sum_b g[b] and g_L = sum_b g[b] z[b]^T (lower), the reward's two; a
// partial per block, then the last block to take its ticket sums them in
// block order and forms (H, c0) of each site (mm_vjp_coeffs) in scratch.
__global__ void __launch_bounds__(kSumThreads)
step_sums_kernel(const __grid_constant__ Tiles tl, const __grid_constant__ StepGrad g) {
  __shared__ float red[kSumThreads / 32][kPartB];
  __shared__ float tot[kPartB];
  __shared__ Site ss, sr;
  __shared__ int last;
  const int tid = threadIdx.x, D = g.D, B = g.B;
  const int b = blockIdx.x * kSumThreads + tid;
  float gv[kMaxD], zv[kMaxD];
#pragma unroll
  for (int k = 0; k < kMaxD; ++k) {
    const bool on = g.mm_states && b < B && k < D;
    gv[k] = on ? g.g_nxt[(size_t)b * D + k] : 0.f;
    zv[k] = on ? g.z_mm[(size_t)b * D + k] : 0.f;
  }
  const bool ron = g.r_mm && b < B;
  const float gr = ron ? g.g_r[b] : 0.f, zr = ron ? g.z_rr[b] : 0.f;
  for (int e = tid; e < kPartB; e += blockDim.x)
    for (int w = 0; w < kSumThreads / 32; ++w) red[w][e] = 0.f;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kMaxD; ++i) {
    put_sum(red, kBGm + i, gv[i]);
#pragma unroll
    for (int j = 0; j <= i; ++j) put_sum(red, kBGl + i * (i + 1) / 2 + j, gv[i] * zv[j]);
  }
  put_sum(red, kBR, gr);
  put_sum(red, kBR + 1, gr * zr);
  __syncthreads();
  float* part = g.scratch + tl.s_sum;
  if (tid < kPartB) {
    float v = 0.f;
    for (int w = 0; w < kSumThreads / 32; ++w) v += red[w][tid];
    part[blockIdx.x * kPartB + tid] = v;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(g.tickets + kTicketSums, 1) == (int)gridDim.x - 1;
    __threadfence();
  }
  __syncthreads();
  if (!last) return;
  if (tid < kPartB) {
    float v = 0.f;
    for (int k = 0; k < (int)gridDim.x; ++k) v += __ldcg(part + k * kPartB + tid);
    tot[tid] = v;
  }
  __syncthreads();
  float* coef = g.scratch + tl.s_coef;
#if PMBRL_WIDE
  if (tid == 0) g.tickets[kTicketSums] = 0;
  if (tid < 32 && g.mm_states) {  // the whole warp: mm_vjp_coeffs_warp
    for (int e = tid; e < D * D; e += 32) {
      const int i = e / D, j = e - i * D;
      ss.L[e] = g.stats[2 * kMaxD + e];
      ss.gL[e] = j <= i ? tot[kBGl + i * (i + 1) / 2 + j] : 0.f;
    }
    for (int i = tid; i < D; i += 32) {
      ss.m[i] = g.stats[i];
      ss.sd[i] = g.stats[kMaxD + i];
      ss.gm[i] = tot[kBGm + i];
    }
    __syncwarp();
    mm_vjp_coeffs_warp(ss.L, ss.gm, ss.gL, ss.sd, B, D, ss.H, ss.c0);
    for (int i = tid; i < D * D; i += 32) coef[i] = ss.H[i];
    for (int i = tid; i < D; i += 32) coef[kMaxD * kMaxD + i] = ss.c0[i];
  }
#else
  if (tid == 0) {
    g.tickets[kTicketSums] = 0;
    if (g.mm_states) {
      load_site(g.stats, D, ss);
      for (int i = 0, e = 0; i < D; ++i) {
        ss.gm[i] = tot[kBGm + i];
        for (int j = 0; j < D; ++j) ss.gL[i * D + j] = j <= i ? tot[kBGl + e++] : 0.f;
      }
      mm_vjp_coeffs(ss.L, true, ss.gm, ss.gL, ss.sd, B, D, ss.H, ss.c0);
      for (int i = 0; i < D * D; ++i) coef[i] = ss.H[i];
      for (int i = 0; i < D; ++i) coef[kMaxD * kMaxD + i] = ss.c0[i];
    }
  }
#endif
  if (tid == 32 && g.r_mm) {
    load_site(g.stats + kStat, 1, sr);
    sr.gm[0] = tot[kBR];
    sr.gL[0] = tot[kBR + 1];
    mm_vjp_coeffs(sr.L, true, sr.gm, sr.gL, sr.sd, B, 1, sr.H, sr.c0);
    coef[kCoef] = sr.H[0];
    coef[kCoef + kMaxD * kMaxD] = sr.c0[0];
  }
}

// The policy's dW and db from every CTA's accumulator: with one cluster
// straight to the outputs; else each cluster's into its flat partial, and the
// last cluster to take its ticket sums them over the clusters in order.
__device__ void finish_dw(const Ctx& c, const Step& st, const StepGrad& g, StepSm& sh,
                          const float* dwacc, int nc) {
  const int tid = threadIdx.x, nt = blockDim.x, np = st.pol.n;
  const Lay& lay = c.lay;
  const int ndw = lay.dw_flat[np + 1], ld4w = round4(ndw) / 4;  // a partial's float4s
  float* flat = g.scratch + lay.s_dw;
  __syncthreads();
  for (int l = 0; l <= np; ++l) {
    const int din = st.pol.dims[l], dout = st.pol.dims[l + 1], ld = round4(dout);
    const Slice ks = slice_of(din, c.rank), js = slice_of(dout, c.rank);
    const float* acc = dwacc + lay.dw_off[l];
    const float* accb = acc + round4(ceil_div(din, kCluster)) * ld;
    float* part = flat + (size_t)c.cid * 4 * ld4w + lay.dw_flat[l];
    float* dw = nc == 1 ? g.dw[l] : part;
    float* db = nc == 1 ? g.db[l] : part + din * dout;
    for (int e = tid; e < ks.cnt * dout; e += nt) {
      const int k = e / dout, j = e - k * dout;
      dw[(size_t)(ks.c0 + k) * dout + j] = acc[k * ld + j];
    }
    if (st.pol.b[l])
      for (int jj = tid; jj < js.cnt; jj += nt) db[js.c0 + jj] = accb[js.c0 + jj];
  }
  if (nc == 1) return;
  if (!last_cluster(g.tickets, kTicketDw, c.rank, nc, sh)) return;
  if (c.rank == 0 && tid == 0) g.tickets[kTicketDw] = 0;
  const float4* f4 = reinterpret_cast<const float4*>(flat);
  for (int q = c.rank * nt + tid; q < ld4w; q += kCluster * nt) {
    float4 v4 = __ldcg(f4 + q);
#pragma unroll 4
    for (int cc = 1; cc < nc; ++cc) v4 = add4(v4, __ldcg(f4 + (size_t)cc * ld4w + q));
    const float v[4] = {v4.x, v4.y, v4.z, v4.w};
    int l = 0;
    for (int u = 0; u < 4 && 4 * q + u < ndw; ++u) {
      const int e = 4 * q + u;
      while (e >= lay.dw_flat[l + 1]) ++l;
      const int din = st.pol.dims[l], dout = st.pol.dims[l + 1], i = e - lay.dw_flat[l];
      if (i < din * dout) g.dw[l][i] = v[u];
      else if (st.pol.b[l]) g.db[l][i - din * dout] = v[u];
    }
  }
}

template <bool kReluOnly>
__global__ void __launch_bounds__(kMaxThreads, 1)
step_bwd_kernel(const __grid_constant__ Step st, const __grid_constant__ Lay lay,
                const __grid_constant__ Tiles tl, const __grid_constant__ StepGrad g) {
  extern __shared__ __align__(16) float smem[];
  __shared__ StepSm sh;
  __shared__ Step st_s;
  __shared__ Lay lay_s;
  copy_params(st, lay, st_s, lay_s);
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int cid = blockIdx.x / kCluster, nc = gridDim.x / kCluster;
  Ctx c{smem, lay_s, rank, cid, 0, 0, 0};
  const Step& s = st_s;
  const int D = s.D, U = s.U, B = s.B, tid = threadIdx.x, nt = blockDim.x;
  const int TR = lay_s.TR;
  float* dwacc = lay_s.resident ? smem + lay_s.dwa
                                : g.scratch + lay_s.s_dwcta + (size_t)blockIdx.x * lay_s.dw_cta;
  stage(c, s, dwacc);
  // the MM adjoint's coefficients (step_sums_kernel) and the forward's means
  const float* coef = g.scratch + tl.s_coef;
  for (int e = tid; e < kMaxD * kMaxD; e += nt) {
    sh.s.H[e] = coef[e];
    sh.r.H[e] = coef[kCoef + e];
  }
  for (int e = tid; e < kMaxD; e += nt) {
    sh.s.c0[e] = coef[kMaxD * kMaxD + e];
    sh.r.c0[e] = coef[kCoef + kMaxD * kMaxD + e];
    sh.s.m[e] = g.stats[e];
    sh.r.m[e] = g.stats[kStat + e];
  }
  __syncthreads();
  float* gin = smem + tl.gin;
  float* grin = gin + TR * kMaxD;
  for (int t = cid; t < tl.tiles; t += nc) {
    const int row0 = t * TR, nrows = min(TR, B - row0);
    // the gradient wrt the tile's pre-MM outputs: g_x = H (x - m) + c0
    for (int e = tid; e < nrows * D; e += nt) {
      const size_t o = (size_t)row0 * D + e;
      float v;
      if (g.mm_states) {
        const int p = e / D, k = e - p * D;
        float acc = 0.f;
        for (int k2 = 0; k2 < D; ++k2)
          acc += sh.s.H[k * D + k2] * (g.nxt_raw[(size_t)(row0 + p) * D + k2] - sh.s.m[k2]);
        v = acc + sh.s.c0[k];
      } else {
        v = g.g_nxt[o];
      }
      gin[e] = v;
    }
    for (int p = tid; p < nrows; p += nt)
      grin[p] = g.r_mm ? sh.r.H[0] * (g.r_raw[row0 + p] - sh.r.m[0]) + sh.r.c0[0]
                       : g.g_r[row0 + p];
    step_fwd<kReluOnly>(c, s, s.states + (size_t)row0 * D, s.eps, row0, nrows, true);
    float* g_eps = rank == 0 && g.g_eps ? g.g_eps + (size_t)row0 * U : nullptr;
    float* g_s = rank == 0 ? g.g_states + (size_t)row0 * D : nullptr;
    step_vjp<kReluOnly>(c, s, gin, grin, row0, nrows, g_eps, g_s, dwacc);
  }
  finish_dw(c, s, g, sh, dwacc, nc);
}

// What the grouped resample's kernels read and write (group_mm.cuh).
struct GroupIo {
  int B, D, G, mm_states, r_mm;
  const float *nxt_raw, *r_raw;  // [B, D], [B]: the walk's pre-MM rows
  const float *z_mm, *z_rr;      // the step's MM noise, standardized per group
  float* stats;                  // [G, 2, kStat]
  float *nxt, *r;                // forward: the resampled rows
  const float *g_nxt, *g_r;      // backward: the cotangents of nxt, r
  float* gpre;                   // backward: the gradient wrt nxt_raw [B, D], then r_raw [B]
};

// The forward's grouped resample: W lanes a group (group_mm.cuh), its
// moments over its Bg rows, its factors (kept in stats by its first lane),
// its rows resampled.
__global__ void __launch_bounds__(kGroupThreads)
group_fwd_kernel(const __grid_constant__ GroupIo io) {
  const int D = io.D, Bg = io.B / io.G, W = group_lanes(Bg), lane = threadIdx.x & 31;
  const int g = (blockIdx.x * kGroupThreads + threadIdx.x) / W, j = lane & (W - 1);
  const bool on = g < io.G;
  const int b0 = (on ? g : 0) * Bg;
  auto x = [&](int q, int k) { return io.nxt_raw[(size_t)(b0 + q) * D + k]; };
  auto r = [&](int q) { return io.r_raw[b0 + q]; };
#if PMBRL_WIDE
  __shared__ GroupSite sites[kGroupThreads / 32];  // one group a warp
  GroupSite& s = sites[threadIdx.x >> 5];
#else
  GroupSite s;
#endif
  group_moments(x, r, Bg, D, W, on, io.mm_states, io.r_mm, s);
  if (!on) return;
  group_factor(s, D, io.mm_states, io.r_mm);
  if (j == 0) group_save(s, D, io.mm_states, io.r_mm, io.stats + (size_t)g * 2 * kStat);
  for (int q = j; q < Bg; q += W) {
    const size_t b = b0 + q;
    if (io.mm_states) group_resample_row(s, D, io.z_mm + b * D, io.nxt + b * D);
    if (io.r_mm) io.r[b] = s.rm + io.z_rr[b] * s.rL;
  }
}

// The backward's grouped MM adjoint: W lanes a group, its sums of g and
// g z^T, its coefficients from its sites in stats, and the gradient wrt its
// pre-MM rows into io.gpre (the cotangents themselves where a site is not
// resampled).
__global__ void __launch_bounds__(kGroupThreads)
group_bwd_kernel(const __grid_constant__ GroupIo io) {
  const int D = io.D, B = io.B, Bg = B / io.G, W = group_lanes(Bg), lane = threadIdx.x & 31;
  const int g = (blockIdx.x * kGroupThreads + threadIdx.x) / W, j = lane & (W - 1);
  const bool on = g < io.G;
  const int b0 = (on ? g : 0) * Bg;
  auto gs = [&](int q, int k) { return io.g_nxt[(size_t)(b0 + q) * D + k]; };
  auto zs = [&](int q, int k) { return io.z_mm[(size_t)(b0 + q) * D + k]; };
  auto gr = [&](int q) { return io.g_r[b0 + q]; };
  auto zr = [&](int q) { return io.z_rr[b0 + q]; };
#if PMBRL_WIDE
  __shared__ GroupSite sites[kGroupThreads / 32];  // one group a warp
  __shared__ GroupAdjoint adjs[kGroupThreads / 32];
  GroupSite& s = sites[threadIdx.x >> 5];
  GroupAdjoint& a = adjs[threadIdx.x >> 5];
#else
  GroupSite s;
  GroupAdjoint a;
#endif
  if (on) group_load(io.stats + (size_t)g * 2 * kStat, D, s);
  group_adjoint(gs, zs, gr, zr, Bg, D, W, on, io.mm_states, io.r_mm, s, a);
  if (!on) return;
  for (int q = j; q < Bg; q += W) {
    const size_t b = b0 + q;
    if (io.mm_states) group_vjp_row(a, s, D, io.nxt_raw + b * D, io.gpre + b * D);
    else
      for (int k = 0; k < D; ++k) io.gpre[b * D + k] = io.g_nxt[b * D + k];
    io.gpre[(size_t)B * D + b] = io.r_mm ? a.rH * (io.r_raw[b] - s.rm) + a.rc0 : io.g_r[b];
  }
}

// Blocks of group_*_kernel for G groups of B / G.
int group_blocks(int B, int G) {
  const int per = kGroupThreads / group_lanes(B / G);  // groups a block
  return (G + per - 1) / per;
}

}  // namespace

// ---- host side ----------------------------------------------------------------

namespace {

// The layout of a launch from the plan (the formulas of step_plan in
// fused_rollout.py); false when the plan does not fit these models and G
// MM groups.
bool step_lay_of(const Step& st, const int* plan, bool bwd, Lay& L, Tiles& T, int G) {
  L = Lay{};
  T = Tiles{};
  const int TR = plan[kSPTileRows], tiles = plan[kSPTiles], clusters = plan[kSPClusters];
  const int threads = plan[kSPThreads], sum_blocks = plan[kSPSumBlocks];
  if (plan[kSPCluster] != kCluster || TR < RB || TR > kMaxTileRows || TR % RB) return false;
  if (tiles != ceil_div(st.B, TR) || clusters < 1 || clusters > tiles) return false;
  if (threads < 32 || threads > kMaxThreads || threads % 32) return false;
  if (plan[kSPResident] != 0 && plan[kSPResident] != 1) return false;
  if (sum_blocks != (bwd ? ceil_div(st.B, kSumThreads) : 0)) return false;
  L.clusters = clusters;
  T.tiles = tiles;
  long long off = walk_lay(st, TR, plan[kSPResident], bwd, L);
  T.gin = static_cast<int>(off);
  if (bwd) off += round4(TR * (kMaxD + 1));
  if (4 * off != plan[kSPSmem] || 4 * off > kSmemMax) return false;
  // the forward merges the CTAs' and the clusters' partials over the walk's
  // buffers
  if (!bwd && (long long)max(clusters, kCluster) * kPart > off - L.region[0]) return false;
  long long sc = 0;
  if (!bwd) {
    sc += (long long)clusters * kPart;
  } else {
    T.s_sum = 0;
    sc += (long long)sum_blocks * kPartB;
    T.s_coef = static_cast<int>(sc);
    sc += 2 * kCoef;
    L.s_dw = static_cast<int>(sc);
    sc += clusters > 1 ? (long long)clusters * round4(L.dw_flat[st.pol.n + 1]) : 0;
    L.s_dwcta = static_cast<int>(sc);
    sc += L.resident ? 0 : (long long)clusters * kCluster * L.dw_cta;
    T.s_gpre = static_cast<int>(sc);
    sc += G > 1 ? (long long)st.B * (st.D + 1) : 0;
  }
  L.scratch = static_cast<int>(sc);
  return sc == plan[kSPScratch] && sc < (1LL << 31);
}

// The walk kernels, each for MLPs whose hidden activations are all relu (the
// activation a compile-time constant in the walks) or not.
using FwdKernel = void (*)(Step, Lay, Tiles, StepIo);
using BwdKernel = void (*)(Step, Lay, Tiles, StepGrad);
const FwdKernel kFwdKernels[2] = {step_fwd_kernel<false>, step_fwd_kernel<true>};
const BwdKernel kBwdKernels[2] = {step_bwd_kernel<false>, step_bwd_kernel<true>};

template <class K, class A>
int launch_walk(K k, const Step& st, const Lay& lay, const Tiles& tl, const A& io,
                const int* plan, cudaStream_t s) {
  const int smem = plan[kSPSmem];
  int e = set_smem(reinterpret_cast<const void*>(k), smem);
  if (e == cudaSuccess) {
    cudaLaunchAttribute attr[2];
    const cudaLaunchConfig_t cfg = cluster_config(lay.clusters, plan[kSPThreads], smem, s, attr,
                                                  false);
    e = cudaLaunchKernelEx(&cfg, k, st, lay, tl, io);
  }
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused launch must not fail the next one
    return e;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* fused_step_error(int e) {
  return e < 0 ? "arguments or a launch plan the kernel does not take"
               : cudaGetErrorString(static_cast<cudaError_t>(e));
}

// Size in bytes of the argument block (checked against the ctypes mirror).
int fused_step_args_size() { return static_cast<int>(sizeof(StepArgs)); }

// How many clusters of the walk kernels (every instance) the current device
// holds at once with this many threads and bytes of dynamic shared memory
// per CTA. Returns 0 or a cudaError_t.
int fused_step_max_clusters(int threads, int smem, int* clusters) {
  if (!clusters || threads < 32 || threads > kMaxThreads || smem < 0 || smem > kSmemMax) return -1;
  *clusters = 0;
  const void* kernels[4] = {
      reinterpret_cast<const void*>(kFwdKernels[0]), reinterpret_cast<const void*>(kFwdKernels[1]),
      reinterpret_cast<const void*>(kBwdKernels[0]), reinterpret_cast<const void*>(kBwdKernels[1])};
  int best = -1, e = cudaSuccess;
  for (const void* k : kernels) {
    e = set_smem(k, smem);
    if (e != cudaSuccess) break;
    cudaLaunchAttribute attr[2];
    const cudaLaunchConfig_t cfg = cluster_config(1, threads, smem, nullptr, attr, false);
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, k, &cfg);
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

// Forward of one step (one launch; grouped, two). Writes the pre-MM nxt_raw
// [B, D] and r_raw [B, 1]; when mm_states (mm_rewards), resamples them into
// nxt (r), per group of B / groups rows, and keeps (m, sd, L) of each
// group's site in stats [groups, 2, kStat], else the caller passes nxt ==
// nxt_raw (r == r_raw). plan: kSPLen ints from step_plan(backward = False);
// scratch: plan[kSPScratch] floats; tickets: kTickets ints, zero (each
// launch leaves them zero). Returns 0, a cudaError_t, or -1.
int fused_step_fwd(const StepArgs* a, const int* plan, int mm_states, int mm_rewards,
                   int groups, void* nxt_raw, void* r_raw, void* nxt, void* r, void* stats,
                   void* scratch, void* tickets, void* stream) {
  Step st;
  Lay lay;
  Tiles tl;
  if (!plan || !fill_step(st, a) || groups < 1 || st.B % groups || st.B / groups < 2 ||
      !step_lay_of(st, plan, false, lay, tl, groups))
    return -1;
  if (!nxt_raw || !r_raw || !nxt || !r || !stats || !scratch || !tickets) return -1;
  if ((mm_states && !a->z_mm) || (mm_rewards && !a->z_rr)) return -1;
  const bool grouped = groups > 1;
  StepIo io;
  io.mm_states = grouped ? 0 : mm_states;  // grouped: the walk alone, then group_fwd_kernel
  io.r_mm = grouped ? 0 : mm_rewards;
  io.nxt_raw = static_cast<float*>(nxt_raw);
  io.r_raw = static_cast<float*>(r_raw);
  io.nxt = static_cast<float*>(nxt);
  io.r = static_cast<float*>(r);
  io.stats = static_cast<float*>(stats);
  io.scratch = static_cast<float*>(scratch);
  io.tickets = static_cast<int*>(tickets);
  const bool relu = relu_only(st.pol) && relu_only(st.dyn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int e = launch_walk(kFwdKernels[relu], st, lay, tl, io, plan, s);
  if (e != cudaSuccess || !grouped || !(mm_states || mm_rewards)) return e;
  GroupIo gio = {};
  gio.B = st.B;
  gio.D = st.D;
  gio.G = groups;
  gio.mm_states = mm_states;
  gio.r_mm = mm_rewards;
  gio.nxt_raw = io.nxt_raw;
  gio.r_raw = io.r_raw;
  gio.z_mm = st.z_mm;
  gio.z_rr = st.z_rr;
  gio.stats = io.stats;
  gio.nxt = io.nxt;
  gio.r = io.r;
  group_fwd_kernel<<<group_blocks(st.B, groups), kGroupThreads, 0, s>>>(gio);
  return cudaGetLastError();
}

// Backward of one step from the forward's inputs and residuals (nxt_raw,
// r_raw, stats) and the gradients g_nxt [B, D], g_r [B, 1] wrt its outputs:
// g_states [B, D], g_eps [B, U] (or null), the policy's dw (n_pol + 1) and
// db (null where a layer has no bias). One launch of step_sums_kernel
// (grouped: group_bwd_kernel) when either site is resampled, then the walk.
// plan: from step_plan(backward = True); scratch and tickets as the
// forward's (the same buffers may serve both). Returns 0, a cudaError_t, or
// -1.
int fused_step_bwd(const StepArgs* a, const int* plan, int mm_states, int mm_rewards,
                   int groups, const void* nxt_raw, const void* r_raw, const void* stats,
                   const void* g_nxt, const void* g_r, void* g_states, void* g_eps,
                   void* const* dw, void* const* db, void* scratch, void* tickets,
                   void* stream) {
  Step st;
  Lay lay;
  Tiles tl;
  if (!plan || !fill_step(st, a) || groups < 1 || st.B % groups || st.B / groups < 2 ||
      !step_lay_of(st, plan, true, lay, tl, groups))
    return -1;
  if (!nxt_raw || !r_raw || !stats || !g_nxt || !g_r || !g_states || !scratch || !tickets)
    return -1;
  if ((mm_states && !a->z_mm) || (mm_rewards && !a->z_rr)) return -1;
  StepGrad g;
  g.B = st.B;
  g.D = st.D;
  g.mm_states = mm_states;
  g.r_mm = mm_rewards;
  g.nxt_raw = static_cast<const float*>(nxt_raw);
  g.r_raw = static_cast<const float*>(r_raw);
  g.stats = static_cast<const float*>(stats);
  g.g_nxt = static_cast<const float*>(g_nxt);
  g.g_r = static_cast<const float*>(g_r);
  g.z_mm = st.z_mm;
  g.z_rr = st.z_rr;
  g.g_states = static_cast<float*>(g_states);
  g.g_eps = static_cast<float*>(g_eps);
  g.scratch = static_cast<float*>(scratch);
  g.tickets = static_cast<int*>(tickets);
  const int np = st.pol.n;
  for (int l = 0; l < kMaxLayers; ++l) {
    const bool lin = l <= np;
    g.dw[l] = lin ? static_cast<float*>(dw[l]) : nullptr;
    g.db[l] = lin ? static_cast<float*>(db[l]) : nullptr;
    if (lin && !g.dw[l]) return -1;
    if (lin && (st.pol.b[l] != nullptr) != (g.db[l] != nullptr)) return -1;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((mm_states || mm_rewards) && groups > 1) {
    // the gradient wrt the pre-MM rows into scratch, which the walk takes
    // as its incoming gradient
    GroupIo gio = {};
    gio.B = st.B;
    gio.D = st.D;
    gio.G = groups;
    gio.mm_states = mm_states;
    gio.r_mm = mm_rewards;
    gio.nxt_raw = g.nxt_raw;
    gio.r_raw = g.r_raw;
    gio.z_mm = st.z_mm;
    gio.z_rr = st.z_rr;
    gio.stats = const_cast<float*>(g.stats);
    gio.g_nxt = g.g_nxt;
    gio.g_r = g.g_r;
    gio.gpre = g.scratch + tl.s_gpre;
    group_bwd_kernel<<<group_blocks(st.B, groups), kGroupThreads, 0, s>>>(gio);
    const int e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    g.mm_states = g.r_mm = 0;
    g.g_nxt = gio.gpre;
    g.g_r = gio.gpre + (size_t)st.B * st.D;
  } else if (mm_states || mm_rewards) {
    step_sums_kernel<<<plan[kSPSumBlocks], kSumThreads, 0, s>>>(tl, g);
    const int e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const bool relu = relu_only(st.pol) && relu_only(st.dyn);
  return launch_walk(kBwdKernels[relu], st, lay, tl, g, plan, s);
}

}  // extern "C"
