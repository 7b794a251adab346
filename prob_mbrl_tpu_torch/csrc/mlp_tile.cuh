// Device code of a dropout MLP walked one tile of batch rows at a time, shared
// by fused_mlp.cu (the fused dropout-MLP kernels), fused_step.cu (the
// rollout-step kernels) and fused_rollout.cu (the whole-rollout kernels,
// through rollout_step.cuh). Everything is float32 FMA.
//
// Layout: a tile's activations sit in shared memory feature-major,
// h[k * TMP + r] for feature k and tile row r < TM, read as float4
// broadcasts. Rows past the batch are never loaded and hold zeros (never
// garbage times zero, which can be NaN).
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLayers = 8;    // linear layers: hidden layers + the output layer
constexpr int kMaxWidth = 1000;  // widest feature dim; bounds shared memory and threads
constexpr int TM = 8;            // batch rows per block in the row-parallel kernels
constexpr int TMP = TM + 4;      // padded stride: conflict-free float4 stores to shared memory
constexpr int KU = 16;           // weights loaded together, before their products
constexpr int WT = 32;           // edge of a dW tile in the weight-gradient kernel

enum Act { kRelu = 0, kSwish, kExp, kSin, kSinlu, kTanh, kIdentity, kNumActs };

struct Net {
  const float* w[kMaxLayers];  // [d_l, d_{l+1}], row-major (the JAX layout)
  const float* b[kMaxLayers];  // [d_{l+1}] or null
  const float* m[kMaxLayers];  // hidden-layer masks [B, d_{l+1}] or null
  float* a[kMaxLayers];        // hidden-layer pre-activations [B, d_{l+1}] or null
  int dims[kMaxLayers + 1];
  int act[kMaxLayers];
  int n;  // hidden layers; layer n is the output layer
  int B;
  int maxw;
};

struct Grads {
  float* dw[kMaxLayers];
  float* db[kMaxLayers];  // null where the layer has no bias
  float* dm[kMaxLayers];  // null where the hidden layer has no mask
  float* ga[kMaxLayers];  // gradient wrt each hidden pre-activation [B, d_{l+1}]
  int tile_start[kMaxLayers + 1];  // prefix sums of the dW tiles of each layer
};

__device__ __forceinline__ float relu_f(float x) { return x < 0.f ? 0.f : x; }

__device__ __forceinline__ float act_fwd(int k, float x) {
  switch (k) {
    case kRelu: return relu_f(x);
    case kSwish: return x * (1.f / (1.f + expf(-x)));
    case kExp: return expf(-0.5f * (x * x));
    case kSin: return sinf(x);
    case kSinlu: return relu_f(x) - sinf(relu_f(-x));
    case kTanh: return tanhf(x);
    default: return x;
  }
}

// g * act'(x), written as jax.vjp computes it: relu and sinlu select where
// x <= 0 (so relu'(0) = sinlu'(0) = 0 and a NaN cotangent there stays out).
__device__ __forceinline__ float act_vjp(int k, float x, float g) {
  switch (k) {
    case kRelu: return x > 0.f ? g : 0.f;
    case kSwish: {
      const float s = 1.f / (1.f + expf(-x));
      return g * s + (g * x) * (s * (1.f - s));
    }
    case kExp: return g * (-x * expf(-0.5f * (x * x)));
    case kSin: return g * cosf(x);
    case kSinlu: return x > 0.f ? g : (x < 0.f ? g * cosf(-x) : 0.f);
    case kTanh: {
      const float t = tanhf(x);
      return g * (1.f - t * t);
    }
    default: return g;
  }
}

// acc[r] += sum_{i < len} wsrc[i * wstride] * s[i * TMP + r]. The KU weight
// loads of a step go out together, so their L2 latencies overlap (one
// load per product left each thread waiting on L2 for every step); s is a
// feature-major tile in shared memory, read as float4 broadcasts. Entries
// past len are neither loaded nor multiplied: shared memory past a layer's
// width holds stale values, maybe NaN. The sum runs in order of i.
__device__ __forceinline__ void dot_tile(const float* __restrict__ wsrc, int wstride, int len,
                                         const float* s, float (&acc)[TM]) {
  for (int i0 = 0; i0 < len; i0 += KU) {
    float w[KU];
#pragma unroll
    for (int u = 0; u < KU; ++u)
      w[u] = i0 + u < len ? __ldg(wsrc + (size_t)(i0 + u) * wstride) : 0.f;
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      if (i0 + u < len) {
        const float4* s4 = reinterpret_cast<const float4*>(s + (i0 + u) * TMP);
#pragma unroll
        for (int q = 0; q < TM / 4; ++q) {
          const float4 v = s4[q];
          acc[4 * q + 0] = fmaf(v.x, w[u], acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(v.y, w[u], acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(v.z, w[u], acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(v.w, w[u], acc[4 * q + 3]);
        }
      }
    }
  }
}

__device__ __forceinline__ void store_col(float* dst, const float (&v)[TM]) {
  float4* o4 = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int q = 0; q < TM / 4; ++q)
    o4[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

// Forward walk of one tile through every layer. Thread j owns output column
// j of the current layer for all TM rows (acc in registers); weight rows are
// read coalesced across the threads, from L2. On entry hin holds the input
// tile. Each hidden pre-activation goes to net.a[l] (global, where not null)
// and to a_sm[l] (a feature-major tile, where a_sm is not null). The output
// layer goes to global out [B, d_out] when out is not null, else it is left
// (feature-major) in the buffer this returns. Ends with __syncthreads().
__device__ float* mlp_rows_fwd(const Net& net, float* hin, float* hout, int row0, int nrows,
                               float* const* a_sm, float* __restrict__ out) {
  const int j = threadIdx.x;
  for (int l = 0; l <= net.n; ++l) {
    const int din = net.dims[l], dout = net.dims[l + 1];
    if (j < dout) {
      float acc[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) acc[r] = 0.f;
      dot_tile(net.w[l] + j, dout, din, hin, acc);
      const float bj = net.b[l] ? net.b[l][j] : 0.f;
      float h[TM];
      if (l == net.n) {
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          h[r] = r < nrows ? acc[r] + bj : 0.f;
          if (out && r < nrows) out[(size_t)(row0 + r) * dout + j] = h[r];
        }
      } else {
        const float* M = net.m[l];
        float* A = net.a[l];
        const int act = net.act[l];
        float av[TM];
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          float v = 0.f, a = 0.f;
          if (r < nrows) {
            const size_t o = (size_t)(row0 + r) * dout + j;
            a = acc[r] + bj;
            if (A) A[o] = a;
            v = act_fwd(act, a);
            if (M) v *= M[o];
          }
          av[r] = a;
          h[r] = v;
        }
        if (a_sm) store_col(a_sm[l] + j * TMP, av);
      }
      if (l < net.n || !out) store_col(hout + j * TMP, h);
    }
    __syncthreads();
    float* t = hin;
    hin = hout;
    hout = t;
  }
  return hin;
}

// Backward walk of one tile through every layer, in reverse. gcur holds the
// gradient wrt the output layer (feature-major). Thread k owns input feature
// k: it forms (g W^T)[r, k] from row k of W (each thread walks its own row;
// the sectors it touches stay in L1), then applies the mask and the
// activation's vjp. Pre-activations come from a_sm (where not null) or from
// net.a. d(mask) goes to gr.dm[h] and each hidden pre-activation gradient to
// gr.ga[h], where those are not null. dx goes to global dx [B, d0] when dx is
// not null, else it is left (feature-major) in the buffer this returns. Ends
// with __syncthreads().
__device__ float* mlp_rows_bwd(const Net& net, const Grads& gr, float* gcur, float* gnext, int row0,
                               int nrows, const float* const* a_sm, float* __restrict__ dx) {
  const int k = threadIdx.x;
  for (int l = net.n; l >= 0; --l) {
    const int din = net.dims[l], dout = net.dims[l + 1];
    if (k < din) {
      float acc[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) acc[r] = 0.f;
      dot_tile(net.w[l] + (size_t)k * dout, 1, dout, gcur, acc);
      if (l == 0) {
        if (dx) {
#pragma unroll
          for (int r = 0; r < TM; ++r)
            if (r < nrows) dx[(size_t)(row0 + r) * din + k] = acc[r];
        } else {
#pragma unroll
          for (int r = 0; r < TM; ++r) acc[r] = r < nrows ? acc[r] : 0.f;
          store_col(gnext + k * TMP, acc);
        }
      } else {
        const int h = l - 1;  // hidden layer whose (masked) output feeds layer l
        const float* M = net.m[h];
        const int act = net.act[h];
        float ga[TM];
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          float v = 0.f;
          if (r < nrows) {
            const size_t o = (size_t)(row0 + r) * din + k;
            const float a = a_sm ? a_sm[h][k * TMP + r] : net.a[h][o];
            float gp = acc[r];
            if (M) {
              if (gr.dm[h]) gr.dm[h][o] = acc[r] * act_fwd(act, a);
              gp = acc[r] * M[o];
            }
            v = act_vjp(act, a, gp);
            if (gr.ga[h]) gr.ga[h][o] = v;
          }
          ga[r] = v;
        }
        store_col(gnext + k * TMP, ga);
      }
    }
    __syncthreads();
    float* t = gcur;
    gcur = gnext;
    gnext = t;
  }
  return gcur;
}

// Tile t of some layer's dW (WT x WT). It recomputes the layer input
// h = act(a) * mask (x for layer 0) from net.a and sums h^T g over the
// net.B batch rows in row order (g = gr.ga of the layer, or g_out for the
// output layer); the tiles of the first row of tiles also sum db. Row r
// takes mask row r % mask_rows (masks shared by the steps of a rollout).
// The first 256 threads work: warp ty owns dW rows ty, ty + 8, ..., lane tx
// owns column tx; all threads of the block must call it. No atomics:
// results repeat bit for bit. The inputs may have been written earlier in
// the same launch by other blocks, so nothing is read through the
// read-only path.
__device__ void wgrad_tile(const Net& net, const Grads& gr, const float* x, const float* g_out,
                           int t, int mask_rows) {
  __shared__ float hs[WT][WT + 1];
  __shared__ float gs[WT][WT + 1];
  int l = 0;
  while (t >= gr.tile_start[l + 1]) ++l;
  t -= gr.tile_start[l];
  const int din = net.dims[l], dout = net.dims[l + 1];
  const int jtiles = (dout + WT - 1) / WT;
  const int kt = t / jtiles, jt = t - kt * jtiles;
  const int k0 = kt * WT, j0 = jt * WT;
  const float* G = l == net.n ? g_out : gr.ga[l];
  const float* A = l > 0 ? net.a[l - 1] : nullptr;
  const float* M = l > 0 ? net.m[l - 1] : nullptr;
  const int act = l > 0 ? net.act[l - 1] : kIdentity;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const bool on = threadIdx.x < 256;
  const int B = net.B;

  float acc[WT / 8];
#pragma unroll
  for (int q = 0; q < WT / 8; ++q) acc[q] = 0.f;
  float bsum = 0.f;
  for (int r0 = 0; r0 < B; r0 += WT) {
    if (on) {
#pragma unroll
      for (int q = 0; q < WT / 8; ++q) {
        const int rr = ty + 8 * q, row = r0 + rr;
        const int kc = k0 + tx, jc = j0 + tx;
        float hv = 0.f, gv = 0.f;
        if (row < B) {
          if (kc < din) {
            const size_t o = (size_t)row * din + kc;
            if (l == 0) {
              hv = x[o];
            } else {
              hv = act_fwd(act, A[o]);
              if (M) hv *= M[(size_t)(row % mask_rows) * din + kc];
            }
          }
          if (jc < dout) gv = G[(size_t)row * dout + jc];
        }
        hs[rr][tx] = hv;
        gs[rr][tx] = gv;
      }
    }
    __syncthreads();
    const int rn = min(WT, B - r0);
    if (on) {
      for (int rr = 0; rr < rn; ++rr) {
        const float gv = gs[rr][tx];
        bsum += gv;
#pragma unroll
        for (int q = 0; q < WT / 8; ++q) acc[q] = fmaf(hs[rr][ty + 8 * q], gv, acc[q]);
      }
    }
    __syncthreads();
  }
  const int jc = j0 + tx;
  if (on && jc < dout) {
#pragma unroll
    for (int q = 0; q < WT / 8; ++q) {
      const int kr = k0 + ty + 8 * q;
      if (kr < din) gr.dw[l][(size_t)kr * dout + jc] = acc[q];
    }
    if (kt == 0 && ty == 0 && gr.db[l]) gr.db[l][jc] = bsum;
  }
}

// One block of 256 threads per dW tile (see wgrad_tile).
__global__ void __launch_bounds__(256)
wgrad_kernel(Net net, Grads gr, const float* __restrict__ x, const float* __restrict__ g_out) {
  wgrad_tile(net, gr, x, g_out, blockIdx.x, net.B);
}

// Fills the dW tiling of gr (tile_start) for net's layers.
void fill_tiles(const Net& net, Grads& gr) {
  gr.tile_start[0] = 0;
  for (int l = 0; l < kMaxLayers; ++l) {
    const int tiles = l <= net.n
        ? ((net.dims[l] + WT - 1) / WT) * ((net.dims[l + 1] + WT - 1) / WT) : 0;
    gr.tile_start[l + 1] = gr.tile_start[l] + tiles;
  }
}

int threads_for(int maxw) { return (maxw + 31) / 32 * 32; }

}  // namespace
