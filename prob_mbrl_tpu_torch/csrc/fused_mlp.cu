// Fused dropout-MLP forward and backward for Hopper (sm_90a), with a plain C
// interface that prob_mbrl_tpu_torch/ops/cuda/fused_mlp.py loads with ctypes.
//
// Replaces the Pallas TPU kernels of prob_mbrl_tpu/ops/pallas/fused_mlp.py:
//   fused_mlp_fwd <- _fwd_kernel (:74-105), launched by _make_fused.fwd_call (:222)
//   fused_mlp_bwd <- _bwd_kernel (:108-176), launched by _make_fused.bwd_call (:247)
//
// Bound at the main-path shapes (B = 100 particles; policy 5->200->200->2,
// dynamics 6->200->200->10): one dynamics forward moves ~0.5 MB (weights,
// masks, pre-activations), ~0.15 us at 3.35 TB/s, and does ~8.7 MFLOP, ~0.13
// us at the 67 TFLOP/s float32 (non-tensor-core) peak; the backward ~0.84 MB
// and ~17 MFLOP. No launch of this size gets near either bound: each layer
// needs the whole previous layer, so the time is a chain of latencies
// (launch, weight fetch, an FMA chain per layer, a barrier per layer). The
// yardstick is the torch.matmul chain of the same products.
//
// Design: thread-block clusters of kCluster = 8 CTAs, each walking tiles of
// TR batch rows; the plan (TR, row tiles, clusters, threads, ring stage size
// and depth, shared memory, scratch) comes from launch_plan() in
// fused_mlp.py and is checked here.
// - CTA r of a cluster owns rows [r kw, (r + 1) kw) of every W_l, kw =
//   ceil(d_l / 8): a contiguous block of memory, which it streams into
//   shared memory once per tile through a ring of stages filled by 16-byte
//   cp.async copies (a stage keeps the block's 16-byte phase, so every width
//   copies in 16-byte pieces). The ring runs across layer boundaries: at the
//   main widths the whole net's blocks are in flight from the kernel's first
//   instructions, and layer l+1's arrive while layer l computes. A
//   1000-wide layer streams through the same ring.
// - Forward, per layer: the CTA holds its slice h[:, rows] of the layer
//   input and forms the partial product h[:, rows] W_l[rows, :] over its kw
//   rows (a short FMA chain: 25 at width 200). Each partial column goes
//   through distributed shared memory to the CTA that owns that output
//   column; after one cluster barrier the owner sums the 8 partials in rank
//   order, adds the bias, writes the pre-activation, applies activation and
//   mask, and keeps the result: its output columns are its rows of the next
//   layer. The partial buffers are double-buffered, so a layer costs one
//   cluster barrier, and the output layer ends the same way into `out`.
// - Backward, per layer (in reverse): every CTA holds the whole g_a of the
//   layer output, all-gathered through distributed shared memory, and forms
//   g_h = g_a W_l[rows, :]^T for its rows, each dot product split over lanes
//   of a warp and summed by a fixed butterfly. It recomputes h at its rows
//   from the pre-activations and the mask, writes d(mask) and dx, applies
//   the activation's VJP and all-gathers the new g_a (double-buffered: one
//   cluster barrier per layer). It also forms its rows of the dW partial,
//   h[:, rows]^T g_a, and its share of the db partial. A cluster adds its
//   tiles into its own partials in the order it walks them; a second launch
//   sums the clusters' partials in order (with one cluster they are dW and
//   db). No atomics on values: results repeat bit for bit.
// - Products are float32 FMA. 3xTF32 on the tensor cores would cost three
//   products per FMA for at most ~1.4x on the product part, and the products
//   are not what sets the pace at these shapes; TF32 alone misses the 1e-4
//   tolerance. Cluster launches are plain launches (no cooperative launch,
//   no host read-back), so they are captured in CUDA graphs.
//
// Rows past the batch are never read: their tile rows hold zeros (never
// garbage times zero, which can be NaN).

#include <cooperative_groups.h>

#include <cstdint>

#include "mlp_tile.cuh"

namespace cg = cooperative_groups;

// the plan's fields, in the order of fused_mlp.py's Plan
enum PlanField {
  kPlanCluster, kPlanTileRows, kPlanRowTiles, kPlanClusters, kPlanThreads, kPlanStage,
  kPlanFwdStages, kPlanFwdSmem, kPlanBwdStages, kPlanBwdSmem, kPlanScratch, kPlanLen
};

struct Tiling {
  int tr, trp;  // batch rows of a tile; their padded stride in shared memory
  int tiles;    // row tiles; cluster c walks tiles c, c + clusters, ...
  int ns;       // ring stages
  int stage;    // floats of a ring stage
  int kw;       // widest slice: ceil(d / 8) over every width d
  int gw;       // width of the gathered g_a tiles (backward)
};

struct BwdOut {
  const float* x;
  const float* g;
  float* dx;
  float* pw[kMaxLayers];  // dW partials [clusters, d_l, d_{l+1}] (dW itself for one cluster)
  float* pb[kMaxLayers];  // db partials [clusters, d_{l+1}], null without a bias
  float* dm[kMaxLayers];  // null without a mask
};

struct PartialSums {
  const float* src[2 * kMaxLayers];
  float* dst[2 * kMaxLayers];
  int count[2 * kMaxLayers];
  int start[2 * kMaxLayers + 1];
  int parts;  // partials per output: one per cluster
  int segs;
};

namespace {

constexpr int kCluster = 8;  // CTAs per cluster (the portable maximum)
constexpr int RB = 4;        // rows of an item: one float4 of a feature-major tile
constexpr int kMaxThreads = 512;
constexpr int kMaxStages = 8;
constexpr int kMaxTileRows = 128;
constexpr int kMaxItems = 8;  // items per thread in the forward product
constexpr int DS = 4;         // block rows of a dW task
constexpr int DJ = 4;         // outputs j of a lane in a dW task
constexpr int kSmemMax = 232448;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most n of this thread's copy groups are pending (n < 7).
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A read-only load issued here: volatile, so the compiler keeps it ahead of
// the products that follow instead of sinking it to its use.
__device__ __forceinline__ float ld_early(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

struct Slice {
  int c0, cnt, sw;  // first index, how many this CTA owns, slice width
};

__device__ __forceinline__ Slice slice_of(int width, int rank) {
  const int sw = (width + kCluster - 1) / kCluster;
  const int c0 = rank * sw;
  return {c0, max(0, min(sw, width - c0)), sw};
}

// Rows of a layer's weight block that one ring stage holds.
__device__ __forceinline__ int stage_rows(int stage, int dout) {
  return max(1, (stage - 4) / dout);
}

// A stage holds src[0, n) at stage + (src's float offset mod 4), so that
// both sides of every 16-byte copy are 16-byte aligned.
__device__ __forceinline__ int phase_of(const float* src) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
}

// The ring of weight stages. Stages run over the layers in the order the
// kernel walks them (forward: 0..n; backward: n..0), once per row tile of
// the cluster; stage c of layer l holds rows [c R, (c + 1) R) of the CTA's
// block of W_l (R = stage_rows), at least one stage per layer.
struct Ring {
  float* stages;
  int ns, stage;
  int issued;  // stages issued (empty ones past the last layer included)
  int pos;     // producer: position in the walk, over all of the cluster's tiles
  int end;     // positions in the walk: layers times the cluster's tiles
  int row;     // producer: first block row of the next stage
};

__device__ __forceinline__ Ring make_ring(float* stages, const Tiling& t, int layers) {
  const int cid = blockIdx.x / kCluster, clusters = gridDim.x / kCluster;
  const int tiles = (t.tiles - cid + clusters - 1) / clusters;
  return Ring{stages, t.ns, t.stage, 0, 0, tiles * layers, 0};
}

// Issues the next stage (all threads; one commit group per stage, empty past
// the last layer).
template <bool kBwd>
__device__ __forceinline__ void issue(Ring& q, const Net& net, int rank) {
  if (q.pos < q.end) {
    const int walk = q.pos % (net.n + 1);
    const int l = kBwd ? net.n - walk : walk;
    const int dout = net.dims[l + 1];
    const Slice ks = slice_of(net.dims[l], rank);
    const int R = stage_rows(q.stage, dout);
    const int rows = min(R, ks.cnt - q.row);
    if (rows > 0) {
      const float* src = net.w[l] + (size_t)(ks.c0 + q.row) * dout;
      const int ph = phase_of(src);
      float* dst = q.stages + (q.issued % q.ns) * q.stage + ph;
      const int n = rows * dout, head = min(n, (4 - ph) & 3);
      const int quads = (n - head) >> 2;
      for (int i = threadIdx.x; i < quads; i += blockDim.x)
        cp_async16(dst + head + 4 * i, src + head + 4 * i);
      for (int i = threadIdx.x; i < head; i += blockDim.x) cp_async4(dst + i, src + i);
      for (int i = head + 4 * quads + threadIdx.x; i < n; i += blockDim.x)
        cp_async4(dst + i, src + i);
    }
    q.row += R;
    if (q.row >= ks.cnt) {
      ++q.pos;
      q.row = 0;
    }
  }
  cp_async_commit();
  ++q.issued;
}

// The next stage, landed and visible to the whole CTA; refills the ring
// (into the stage every thread has finished with). All threads call it.
// Returns where the stage holds the block rows whose global start is src.
template <bool kBwd>
__device__ __forceinline__ const float* next_stage(Ring& q, const Net& net, int rank,
                                                   const float* src) {
  cp_async_wait(q.ns - 2);
  __syncthreads();
  const float* s = q.stages + ((q.issued - (q.ns - 1)) % q.ns) * q.stage + phase_of(src);
  issue<kBwd>(q, net, rank);
  return s;
}

// An input tile, feature-major: dst[k * trp + r] = src[(row0 + r) * ld + c0
// + k] for k < cnt, r < tr, zeros past the batch's nrows rows.
__device__ __forceinline__ void load_tile(float* dst, const float* src, int ld, int c0, int cnt,
                                          int row0, int nrows, int tr, int trp) {
  for (int e = threadIdx.x; e < tr * cnt; e += blockDim.x) {
    const int r = e / cnt, k = e - r * cnt;
    dst[k * trp + r] = r < nrows ? src[(size_t)(row0 + r) * ld + c0 + k] : 0.f;
  }
}

// Writes v at dst[off] in every CTA of the cluster.
__device__ __forceinline__ void all_gather(cg::cluster_group& cluster, float* dst, int off,
                                           float4 v) {
#pragma unroll
  for (int q = 0; q < kCluster; ++q)
    *reinterpret_cast<float4*>(cluster.map_shared_rank(dst, q) + off) = v;
}

// Forward partial product of one layer: for items i = threadIdx.x + p
// blockDim.x < n (row group i / dout, output column i % dout), acc[p] =
// sum over the CTA's block rows k, in order, of h[k][rows of the group] *
// W_l[k, column]. h: the CTA's slice of the layer input (feature-major).
template <int kP>
__device__ __forceinline__ void fwd_product(Ring& q, const Net& net, int rank, int l,
                                            const Slice& ks, const float* h, int trp, int n,
                                            float4 (&acc)[kMaxItems]) {
  const int dout = net.dims[l + 1];
  const int R = stage_rows(q.stage, dout);
  int wo[kP], ho[kP];
  bool any = false;
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const int i = min(static_cast<int>(threadIdx.x + p * blockDim.x), max(n - 1, 0));
    any = any || static_cast<int>(threadIdx.x + p * blockDim.x) < n;
    wo[p] = i % dout;
    ho[p] = (i / dout) * RB;
    acc[p] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int r0 = 0; r0 < max(ks.cnt, 1); r0 += R) {
    const float* src = net.w[l] + (size_t)(ks.c0 + r0) * dout;
    const float* w = next_stage<false>(q, net, rank, src);
    const int rows = min(R, ks.cnt - r0);
    if (!any) continue;
    const float* hk = h + r0 * trp;
#pragma unroll 4
    for (int k = 0; k < rows; ++k, w += dout, hk += trp) {
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const float wv = w[wo[p]];
        const float4 hv = *reinterpret_cast<const float4*>(hk + ho[p]);
        acc[p].x = fmaf(hv.x, wv, acc[p].x);
        acc[p].y = fmaf(hv.y, wv, acc[p].y);
        acc[p].z = fmaf(hv.z, wv, acc[p].z);
        acc[p].w = fmaf(hv.w, wv, acc[p].w);
      }
    }
  }
}

// Cluster c walks row tiles c, c + clusters, ...; every tile starts with a
// cluster arrive whose wait comes before the tile's first write into another
// CTA, so none writes into a CTA that has not finished the last tile.
__global__ void __launch_bounds__(kMaxThreads)
fwd_cluster_kernel(Net net, Tiling t, const float* __restrict__ x, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  // partials of layer l at smem + (l & 1) * part_floats: [source rank][column][row]
  const int part_floats = kCluster * t.kw * t.trp;
  float* h = smem + 2 * part_floats;  // this CTA's slice of the layer input
  Ring q = make_ring(h + t.kw * t.trp, t, net.n + 1);
  const int d0 = net.dims[0];
  const Slice xs = slice_of(d0, rank);
  for (int i = 0; i < t.ns - 1; ++i) issue<false>(q, net, rank);
  const int G = t.tr / RB;  // row groups of a tile
  for (int tile = blockIdx.x / kCluster; tile < t.tiles; tile += gridDim.x / kCluster) {
    const int row0 = tile * t.tr;
    const int nrows = min(t.tr, net.B - row0);
    __syncthreads();  // the last tile's reads of h and the partials are done
    cluster_arrive();
    load_tile(h, x, d0, xs.c0, xs.cnt, row0, nrows, t.tr, t.trp);
    for (int l = 0; l <= net.n; ++l) {
      const int din = net.dims[l], dout = net.dims[l + 1];
      const bool last = l == net.n;
      const Slice ks = slice_of(din, rank), cs = slice_of(dout, rank);
      // the outputs this CTA owns: one item (row group, column) a thread,
      // as G * cs.cnt <= G * kw <= threads (tiling_of); bias and mask
      // loaded before the products
      const int no = G * cs.cnt;
      const int oi = threadIdx.x;
      const float* M = last ? nullptr : net.m[l];
      float bias = 0.f;
      float4 mk = make_float4(1.f, 1.f, 1.f, 1.f);
      if (oi < no) {
        const int col = cs.c0 + oi % cs.cnt, row = row0 + (oi / cs.cnt) * RB;
        if (net.b[l]) bias = ld_early(net.b[l] + col);
        if (M) {
          const float* m = M + (size_t)row * dout + col;
          mk.x = row < net.B ? ld_early(m) : 1.f;
          mk.y = row + 1 < net.B ? ld_early(m + dout) : 1.f;
          mk.z = row + 2 < net.B ? ld_early(m + 2 * dout) : 1.f;
          mk.w = row + 3 < net.B ? ld_early(m + 3 * dout) : 1.f;
        }
      }
      // this CTA's partial of every output, each sent to the output's owner
      const int n = ks.cnt ? G * dout : 0;
      float4 acc[kMaxItems];
      const int per = (n + blockDim.x - 1) / blockDim.x;
      if (per <= 1) fwd_product<1>(q, net, rank, l, ks, h, t.trp, n, acc);
      else if (per == 2) fwd_product<2>(q, net, rank, l, ks, h, t.trp, n, acc);
      else if (per <= 4) fwd_product<4>(q, net, rank, l, ks, h, t.trp, n, acc);
      else fwd_product<8>(q, net, rank, l, ks, h, t.trp, n, acc);
      float* part = smem + (l & 1) * part_floats;
      if (l == 0) cluster_wait();  // every CTA of the cluster is on this tile
#pragma unroll
      for (int p = 0; p < kMaxItems; ++p) {
        const int i = threadIdx.x + p * blockDim.x;
        if (p >= per || i >= n) break;
        const int col = i % dout, owner = col / cs.sw;
        float* dst = cluster.map_shared_rank(part, owner);
        *reinterpret_cast<float4*>(dst + (rank * t.kw + col - owner * cs.sw) * t.trp +
                                   (i / dout) * RB) = acc[p];
      }
      cluster_arrive();
      cluster_wait();
      // owner: the partials summed in rank order, then bias, activation, mask
      const int sources = (din + ks.sw - 1) / ks.sw;
      float* A = last ? nullptr : net.a[l];
      const int act = net.act[l];
      if (oi < no) {
        const int jj = oi % cs.cnt, rg = oi / cs.cnt;
        const int col = cs.c0 + jj, row = row0 + rg * RB;
        const float* src = part + jj * t.trp + rg * RB;
        float4 a = *reinterpret_cast<const float4*>(src);
        for (int s = 1; s < sources; ++s)
          a = add4(a, *reinterpret_cast<const float4*>(src + s * t.kw * t.trp));
        float v[RB] = {a.x + bias, a.y + bias, a.z + bias, a.w + bias};
        const float m[RB] = {mk.x, mk.y, mk.z, mk.w};
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const bool in = row + r < net.B;
          const size_t o = (size_t)(row + r) * dout + col;
          if (last) {
            if (in) out[o] = v[r];
            continue;
          }
          if (in && A) A[o] = v[r];
          v[r] = in ? act_fwd(act, v[r]) * m[r] : 0.f;
        }
        if (!last)
          *reinterpret_cast<float4*>(h + jj * t.trp + rg * RB) =
              make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

// Backward product and epilogue of one stage of block rows [r0, r0 + rows):
// items (row group, block row), each split over kparts lanes (part = lane %
// kparts sums every kparts-th output feature j; the parts are summed by a
// fixed butterfly). The leading lane recomputes h at its rows from the
// pre-activations and mask (loaded before the product), writes dx or
// d(mask), all-gathers the next g_a into `gnext` of every CTA (l > 0) and
// keeps h in hs.
__device__ __forceinline__ void bwd_stage(cg::cluster_group& cluster, const Net& net,
                                          const BwdOut& o, const Tiling& t, int l,
                                          const Slice& ks, int r0, int rows, int kparts,
                                          const float* w, const float* g, float* gnext,
                                          float* hs, int row0) {
  const int G = t.tr / RB;
  const int din = net.dims[l], dout = net.dims[l + 1];
  const int n = rows > 0 ? G * rows : 0;
  const int part = threadIdx.x % kparts, item = threadIdx.x / kparts;
  const bool lead = part == 0 && item < n;
  const int i = min(item, max(n - 1, 0));
  const int rg = i % G, s = r0 + i / G, k = ks.c0 + s;
  const int row = row0 + rg * RB;
  const int hid = l - 1;
  const float* A = l ? net.a[hid] : o.x;
  const float* M = l ? net.m[hid] : nullptr;
  // the layer input at the item's rows and feature, for the epilogue
  float av[RB], mv[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const bool in = lead && row + r < net.B;
    const size_t off = (size_t)(row + r) * din + k;
    av[r] = in ? ld_early(A + off) : 0.f;
    mv[r] = in && M ? ld_early(M + off) : 1.f;
  }
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (item < n) {
    const float* wr = w + (s - r0) * dout;
    const float* gr = g + rg * RB;
#pragma unroll 4
    for (int j = part; j < dout; j += kparts) {
      const float wv = wr[j];
      const float4 gv = *reinterpret_cast<const float4*>(gr + j * t.trp);
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
  if (!lead) return;
  const int act = l ? net.act[hid] : kIdentity;
  float* dm = l ? o.dm[hid] : nullptr;
  const float gh[RB] = {acc.x, acc.y, acc.z, acc.w};
  float ga[RB], hv[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    ga[r] = hv[r] = 0.f;
    if (row + r >= net.B) continue;
    const size_t off = (size_t)(row + r) * din + k;
    if (l == 0) {
      o.dx[off] = gh[r];
      hv[r] = av[r];
      continue;
    }
    const float fa = act_fwd(act, av[r]);
    float gp = gh[r];
    hv[r] = fa;
    if (M) {
      if (dm) dm[off] = gp * fa;
      gp *= mv[r];
      hv[r] = fa * mv[r];
    }
    ga[r] = act_vjp(act, av[r], gp);
  }
  *reinterpret_cast<float4*>(hs + s * t.trp + rg * RB) = make_float4(hv[0], hv[1], hv[2], hv[3]);
  if (l > 0)
    all_gather(cluster, gnext, k * t.trp + rg * RB, make_float4(ga[0], ga[1], ga[2], ga[3]));
}

// This CTA's rows of the dW partial, h[:, rows]^T g_a over the tile's rows:
// a warp takes DS block rows and 32 DJ outputs j (lane + 32 q), so each
// shared-memory load feeds several products. `first`: the cluster's first
// tile, which writes the partial; later tiles add to it.
__device__ __forceinline__ void dw_rows(const Tiling& t, const Slice& ks, int dout,
                                        const float* hs, const float* g, float* pw,
                                        bool first) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const int sblocks = (ks.cnt + DS - 1) / DS, jblocks = (dout + 32 * DJ - 1) / (32 * DJ);
  for (int task = warp; task < sblocks * jblocks; task += nwarps) {
    const int s0 = (task / jblocks) * DS, j0 = (task % jblocks) * 32 * DJ + lane;
    const float4* h4[DS];
    const float4* g4[DJ];
#pragma unroll
    for (int b = 0; b < DS; ++b)
      h4[b] = reinterpret_cast<const float4*>(hs + min(s0 + b, ks.cnt - 1) * t.trp);
#pragma unroll
    for (int q = 0; q < DJ; ++q)
      g4[q] = reinterpret_cast<const float4*>(g + min(j0 + 32 * q, dout - 1) * t.trp);
    float sum[DS][DJ];
#pragma unroll
    for (int b = 0; b < DS; ++b)
#pragma unroll
      for (int q = 0; q < DJ; ++q) sum[b][q] = 0.f;
    for (int r = 0; r < t.tr / RB; ++r) {
      float4 hv[DS], gv[DJ];
#pragma unroll
      for (int b = 0; b < DS; ++b) hv[b] = h4[b][r];
#pragma unroll
      for (int q = 0; q < DJ; ++q) gv[q] = g4[q][r];
#pragma unroll
      for (int b = 0; b < DS; ++b)
#pragma unroll
        for (int q = 0; q < DJ; ++q) {
          sum[b][q] = fmaf(hv[b].x, gv[q].x, sum[b][q]);
          sum[b][q] = fmaf(hv[b].y, gv[q].y, sum[b][q]);
          sum[b][q] = fmaf(hv[b].z, gv[q].z, sum[b][q]);
          sum[b][q] = fmaf(hv[b].w, gv[q].w, sum[b][q]);
        }
    }
#pragma unroll
    for (int b = 0; b < DS; ++b) {
      if (s0 + b >= ks.cnt) break;
      float* drow = pw + (size_t)(ks.c0 + s0 + b) * dout;
#pragma unroll
      for (int q = 0; q < DJ; ++q) {
        const int j = j0 + 32 * q;
        if (j >= dout) break;
        if (first) drow[j] = sum[b][q];
        else drow[j] += sum[b][q];
      }
    }
  }
}

// Tiles as in the forward; a cluster's dW and db partials add its tiles in
// the order it walks them.
__global__ void __launch_bounds__(kMaxThreads)
bwd_cluster_kernel(Net net, Tiling t, BwdOut o) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cid = blockIdx.x / kCluster;
  // g_a at walk position pos is at smem + (pos & 1) * tile_floats
  const int tile_floats = t.gw * t.trp;
  float* hs = smem + 2 * tile_floats;  // this CTA's slice of the layer input, recomputed
  Ring q = make_ring(hs + t.kw * t.trp, t, net.n + 1);
  const int dlast = net.dims[net.n + 1];
  for (int i = 0; i < t.ns - 1; ++i) issue<true>(q, net, rank);
  const int G = t.tr / RB;
  for (int tile = cid; tile < t.tiles; tile += gridDim.x / kCluster) {
    const int row0 = tile * t.tr;
    const int nrows = min(t.tr, net.B - row0);
    const bool first = tile == cid;
    __syncthreads();  // the last tile's reads of g_a and hs are done
    cluster_arrive();
    load_tile(smem, o.g, dlast, 0, dlast, row0, nrows, t.tr, t.trp);
    for (int pos = 0; pos <= net.n; ++pos) {
      const int l = net.n - pos;
      const int din = net.dims[l], dout = net.dims[l + 1];
      const Slice ks = slice_of(din, rank);
      const float* g = smem + (pos & 1) * tile_floats;
      float* gnext = smem + ((pos + 1) & 1) * tile_floats;
      const int R = stage_rows(q.stage, dout);
      for (int r0 = 0; r0 < max(ks.cnt, 1); r0 += R) {
        const float* src = net.w[l] + (size_t)(ks.c0 + r0) * dout;
        const float* w = next_stage<true>(q, net, rank, src);
        const int rows = min(R, ks.cnt - r0);
        if (pos == 0 && r0 == 0) cluster_wait();  // every CTA of the cluster is on this tile
        // lanes per item: the most (up to 32) that keep every item on a thread
        const int n = rows > 0 ? G * rows : 0;
        int kparts = 1;
        while (kparts < 32 && 2 * kparts * n <= static_cast<int>(blockDim.x)) kparts *= 2;
        bwd_stage(cluster, net, o, t, l, ks, r0, rows, kparts, w, g, gnext, hs, row0);
      }
      __syncthreads();
      dw_rows(t, ks, dout, hs, g, o.pw[l] + (size_t)cid * din * dout, first);
      // this CTA's share of the db partial: g_a summed over the tile's rows
      if (o.pb[l]) {
        const Slice js = slice_of(dout, rank);
        for (int j = threadIdx.x; j < js.cnt; j += blockDim.x) {
          const float* gj = g + (js.c0 + j) * t.trp;
          float sum = 0.f;
          for (int r = 0; r < t.tr; ++r) sum += gj[r];
          float* d = o.pb[l] + (size_t)cid * dout + js.c0 + j;
          *d = first ? sum : *d + sum;
        }
      }
      if (l > 0) {  // the next layer reads the gathered g_a; this one's tile is free
        cluster_arrive();
        cluster_wait();
      }
    }
  }
}

// dst[i] = sum over clusters c, in order, of src[c * count + i], for each
// segment (a layer's dW or db).
__global__ void __launch_bounds__(256) sum_partials_kernel(PartialSums s) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= s.start[s.segs]) return;
  int g = 0;
  while (e >= s.start[g + 1]) ++g;
  const int i = e - s.start[g];
  const float* src = s.src[g] + i;
  float sum = 0.f;
  for (int c = 0; c < s.parts; ++c) sum += src[(size_t)c * s.count[g]];
  s.dst[g][i] = sum;
}

bool fill_net(Net& net, int n_hidden, int B, const int* dims, const int* acts,
              const void* const* w, const void* const* b, const void* const* m,
              void* const* a) {
  if (n_hidden < 1 || n_hidden + 1 > kMaxLayers || B < 1) return false;
  net.n = n_hidden;
  net.B = B;
  net.maxw = 0;
  for (int l = 0; l <= n_hidden + 1; ++l) {
    if (dims[l] < 1 || dims[l] > kMaxWidth) return false;
    net.dims[l] = dims[l];
    net.maxw = dims[l] > net.maxw ? dims[l] : net.maxw;
  }
  for (int l = 0; l < kMaxLayers; ++l) {
    const bool lin = l <= n_hidden, hid = l < n_hidden;
    net.w[l] = lin ? static_cast<const float*>(w[l]) : nullptr;
    net.b[l] = lin && b ? static_cast<const float*>(b[l]) : nullptr;
    net.m[l] = hid ? static_cast<const float*>(m[l]) : nullptr;
    net.a[l] = hid ? static_cast<float*>(a[l]) : nullptr;
    net.act[l] = hid ? acts[l] : kIdentity;
    if (lin && !net.w[l]) return false;
    if (hid && (!net.a[l] || acts[l] < 0 || acts[l] >= kNumActs)) return false;
  }
  return true;
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Scratch floats of the dW and db partials, one set per cluster: none with
// one cluster.
long long scratch_floats(const Net& net, int clusters) {
  if (clusters < 2) return 0;
  long long n = 0;
  for (int l = 0; l <= net.n; ++l) n += (long long)(net.dims[l] + 1) * net.dims[l + 1];
  return n * clusters;
}

// Checks the plan against net (the formulas of launch_plan in fused_mlp.py)
// and fills the tiling of one direction.
bool tiling_of(const Net& net, const int* plan, bool bwd, Tiling& t) {
  const int tr = plan[kPlanTileRows], threads = plan[kPlanThreads];
  if (plan[kPlanCluster] != kCluster || tr < RB || tr > kMaxTileRows || tr % RB) return false;
  const int tiles = plan[kPlanRowTiles], clusters = plan[kPlanClusters];
  if (tiles != ceil_div(net.B, tr) || clusters < 1 || clusters > tiles) return false;
  if (threads < 32 || threads > kMaxThreads || threads % 32) return false;
  if (plan[kPlanScratch] != scratch_floats(net, clusters)) return false;
  t.tr = tr;
  t.trp = tr + 4;
  t.tiles = tiles;
  t.stage = plan[kPlanStage];
  t.ns = plan[bwd ? kPlanBwdStages : kPlanFwdStages];
  if (t.stage % 4 || t.ns < 2 || t.ns > kMaxStages) return false;
  t.kw = t.gw = 0;
  // items a thread holds: up to 8 forward product items, 1 forward epilogue
  // item (G * kw at most, as a backward stage's), 1 backward item
  int items = 0;
  for (int l = 0; l <= net.n + 1; ++l) {
    const int d = net.dims[l];
    t.kw = max(t.kw, ceil_div(d, kCluster));
    if (l > 0) {
      t.gw = max(t.gw, d);
      if (t.stage < d + 4) return false;
      items = max(items, ceil_div(tr / RB * d, kMaxItems));
    }
  }
  items = max(items, tr / RB * t.kw);
  if (items > threads) return false;
  const long long floats = bwd ? 2LL * t.gw * t.trp + (long long)t.kw * t.trp
                               : 2LL * kCluster * t.kw * t.trp + (long long)t.kw * t.trp;
  const long long bytes = 4 * (floats + (long long)t.ns * t.stage);
  return bytes == plan[bwd ? kPlanBwdSmem : kPlanFwdSmem] && bytes <= kSmemMax;
}

int set_smem(const void* kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

cudaLaunchConfig_t cluster_config(int clusters, int threads, int smem, cudaStream_t s,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * kCluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), const int* plan, int smem, cudaStream_t s,
                    Args... args) {
  int e = set_smem(reinterpret_cast<const void*>(kernel), smem);
  if (e == cudaSuccess) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg =
        cluster_config(plan[kPlanClusters], plan[kPlanThreads], smem, s, attr);
    e = cudaLaunchKernelEx(&cfg, kernel, args...);
  }
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused launch must not fail the next one
    return e;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* fused_mlp_error(int e) {
  return e < 0 ? "arguments or a launch plan the kernels do not take"
               : cudaGetErrorString(static_cast<cudaError_t>(e));
}

// How many clusters of the forward (backward = 0) or backward kernel the card
// holds at once with this many threads and bytes of shared memory per CTA.
// Returns 0 or a cudaError_t.
int fused_mlp_max_clusters(int backward, int threads, int smem, int* clusters) {
  const void* kernel = backward ? reinterpret_cast<const void*>(bwd_cluster_kernel)
                                : reinterpret_cast<const void*>(fwd_cluster_kernel);
  *clusters = 0;
  int e = set_smem(kernel, smem);
  if (e == cudaSuccess) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_config(1, threads, smem, nullptr, attr);
    e = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  }
  if (e != cudaSuccess) cudaGetLastError();  // a refused plan must not fail the next launch
  return e;
}

// Returns 0, a cudaError_t, or -1 for arguments or a plan the kernels do not
// take. w, b, m, a: arrays of device pointers (b and m entries may be null);
// plan: kPlanLen ints from launch_plan.
int fused_mlp_fwd(int n_hidden, int B, const int* dims, const int* acts,
                  const void* const* w, const void* const* b, const void* const* m,
                  void* const* a, const void* x, void* out, const int* plan, void* stream) {
  Net net;
  Tiling t;
  if (!fill_net(net, n_hidden, B, dims, acts, w, b, m, a) || !x || !out ||
      !tiling_of(net, plan, false, t))
    return -1;
  return launch_clusters(fwd_cluster_kernel, plan, plan[kPlanFwdSmem],
                         static_cast<cudaStream_t>(stream), net, t,
                         static_cast<const float*>(x), static_cast<float*>(out));
}

// dw: n_hidden + 1 outputs; db, dm: arrays with null where absent; scratch:
// plan[kPlanScratch] floats (null when that is 0).
int fused_mlp_bwd(int n_hidden, int B, const int* dims, const int* acts,
                  const void* const* w, const void* const* m, void* const* a,
                  const void* x, const void* g, void* dx, void* const* dw,
                  void* const* db, void* const* dm, void* scratch, const int* plan,
                  void* stream) {
  Net net;
  Tiling t;
  if (!fill_net(net, n_hidden, B, dims, acts, w, nullptr, m, a) || !x || !g || !dx ||
      !tiling_of(net, plan, true, t))
    return -1;
  const int parts = plan[kPlanClusters];
  if (parts > 1 && !scratch) return -1;
  BwdOut o;
  PartialSums sums;
  o.x = static_cast<const float*>(x);
  o.g = static_cast<const float*>(g);
  o.dx = static_cast<float*>(dx);
  float* part = static_cast<float*>(scratch);
  sums.parts = parts;
  sums.segs = 0;
  sums.start[0] = 0;
  for (int l = 0; l < kMaxLayers; ++l) {
    const bool lin = l <= n_hidden, hid = l < n_hidden;
    float* dwl = lin ? static_cast<float*>(dw[l]) : nullptr;
    float* dbl = lin ? static_cast<float*>(db[l]) : nullptr;
    o.dm[l] = hid ? static_cast<float*>(dm[l]) : nullptr;
    o.pw[l] = o.pb[l] = nullptr;
    if (lin && !dwl) return -1;
    if (hid && (net.m[l] != nullptr) != (o.dm[l] != nullptr)) return -1;
    if (!lin) continue;
    const int nw = net.dims[l] * net.dims[l + 1], nb = net.dims[l + 1];
    if (parts == 1) {
      o.pw[l] = dwl;
      o.pb[l] = dbl;
      continue;
    }
    o.pw[l] = part;
    part += (size_t)parts * nw;
    o.pb[l] = dbl ? part : nullptr;
    part += (size_t)parts * nb;
    const float* src[2] = {o.pw[l], o.pb[l]};
    float* dst[2] = {dwl, dbl};
    const int count[2] = {nw, nb};
    for (int k = 0; k < 2; ++k) {
      if (!dst[k]) continue;
      const int sg = sums.segs++;
      sums.src[sg] = src[k];
      sums.dst[sg] = dst[k];
      sums.count[sg] = count[k];
      sums.start[sg + 1] = sums.start[sg] + count[k];
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int e = launch_clusters(bwd_cluster_kernel, plan, plan[kPlanBwdSmem], s, net, t, o);
  if (e != cudaSuccess || parts == 1) return e;
  sum_partials_kernel<<<ceil_div(sums.start[sums.segs], 256), 256, 0, s>>>(sums);
  return cudaGetLastError();
}

}  // extern "C"
