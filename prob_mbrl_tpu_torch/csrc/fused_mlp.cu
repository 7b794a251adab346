// Fused dropout-MLP forward and backward for Hopper (sm_90a), with a plain C
// interface that prob_mbrl_tpu_torch/ops/cuda/fused_mlp.py loads with ctypes.
//
// Replaces the Pallas TPU kernels of prob_mbrl_tpu/ops/pallas/fused_mlp.py:
//   fused_mlp_fwd <- _fwd_kernel (:74-105), launched by _make_fused.fwd_call (:221-232)
//   fused_mlp_bwd <- _bwd_kernel (:108-176), launched by _make_fused.bwd_call (:234-260)
//
// Bound at the main-path shapes (B = 100 particles; policy 5->200->200->2,
// dynamics 6->200->200->10): one dynamics forward reads ~0.17 MB of weights
// and 0.16 MB of masks and writes 0.16 MB of pre-activations, ~0.15 us at
// 3.35 TB/s, and does ~8.7 MFLOP, ~0.13 us at the 67 TFLOP/s float32
// (non-tensor-core) peak; the backward moves ~0.84 MB and does ~17 MFLOP.
// No launch of this size gets near either bound: the chain of dependent
// products (each layer needs the whole previous layer) makes it a latency
// problem. The design keeps that chain inside one block per tile of rows:
// activations stay in shared memory from layer to layer, weights are read
// from L2 by every block, and only the pre-activations the backward needs go
// to device memory. Products are float32 FMA; tensor cores are left for later.
//
// The TPU kernel accumulates dW over a sequential grid. Blocks on Hopper run
// in parallel, so the backward is two launches: a row-parallel pass that
// writes dx, d(mask) and each hidden layer's pre-activation gradient g_a, then
// a pass over tiles of every dW that reduces h^T g_a and sum(g_a) over the
// batch in a fixed order. No atomics: results do not change from run to run.
//
// Rows past the batch are never read: loads are guarded by bounds, and the
// padded rows of a tile hold zeros (never garbage times zero, which can be NaN).

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
  float* a[kMaxLayers];        // hidden-layer pre-activations [B, d_{l+1}]
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
  float* ga[kMaxLayers];  // scratch: gradient wrt each hidden pre-activation [B, d_{l+1}]
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

// Forward: one block per TM rows walks every layer. Thread j owns output
// column j of the current layer for all TM rows (acc in registers); the
// layer's input sits in shared memory as hin[k * TMP + r], read as float4
// broadcasts. Weight rows are read coalesced across the threads, from L2.
__global__ void __launch_bounds__(1024)
fwd_kernel(Net net, const float* __restrict__ x, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* hin = smem;
  float* hout = smem + net.maxw * TMP;
  const int row0 = blockIdx.x * TM;
  const int nrows = min(TM, net.B - row0);

  const int d0 = net.dims[0];
  for (int i = threadIdx.x; i < TM * d0; i += blockDim.x) {
    const int r = i / d0, k = i - r * d0;
    hin[k * TMP + r] = r < nrows ? x[(size_t)(row0 + r) * d0 + k] : 0.f;
  }
  __syncthreads();

  const int j = threadIdx.x;
  for (int l = 0; l <= net.n; ++l) {
    const int din = net.dims[l], dout = net.dims[l + 1];
    if (j < dout) {
      float acc[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) acc[r] = 0.f;
      dot_tile(net.w[l] + j, dout, din, hin, acc);
      const float bj = net.b[l] ? net.b[l][j] : 0.f;
      if (l == net.n) {
#pragma unroll
        for (int r = 0; r < TM; ++r)
          if (r < nrows) out[(size_t)(row0 + r) * dout + j] = acc[r] + bj;
      } else {
        const float* M = net.m[l];
        float* A = net.a[l];
        const int act = net.act[l];
        float h[TM];
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          float v = 0.f;
          if (r < nrows) {
            const size_t o = (size_t)(row0 + r) * dout + j;
            const float a = acc[r] + bj;
            A[o] = a;
            v = act_fwd(act, a);
            if (M) v *= M[o];
          }
          h[r] = v;
        }
        float4* o4 = reinterpret_cast<float4*>(hout + j * TMP);
#pragma unroll
        for (int q = 0; q < TM / 4; ++q)
          o4[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
      }
    }
    __syncthreads();
    float* t = hin;
    hin = hout;
    hout = t;
  }
}

// Backward, phase A: one block per TM rows walks the layers in reverse.
// gcur holds the gradient wrt the current layer's output (k-major, like the
// forward's activations). Thread k owns input feature k: it forms
// (g W^T)[r, k] from row k of W (each thread walks its own row; the sectors
// it touches stay in L1), then applies the mask and the activation's vjp and
// stores g_a for phase B.
__global__ void __launch_bounds__(1024)
bwd_rows_kernel(Net net, Grads gr, const float* __restrict__ g, float* __restrict__ dx) {
  extern __shared__ __align__(16) float smem[];
  float* gcur = smem;
  float* gnext = smem + net.maxw * TMP;
  const int row0 = blockIdx.x * TM;
  const int nrows = min(TM, net.B - row0);

  {
    const int dout = net.dims[net.n + 1];
    for (int i = threadIdx.x; i < TM * dout; i += blockDim.x) {
      const int r = i / dout, j = i - r * dout;
      gcur[j * TMP + r] = r < nrows ? g[(size_t)(row0 + r) * dout + j] : 0.f;
    }
  }
  __syncthreads();

  const int k = threadIdx.x;
  for (int l = net.n; l >= 0; --l) {
    const int din = net.dims[l], dout = net.dims[l + 1];
    if (k < din) {
      float acc[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) acc[r] = 0.f;
      dot_tile(net.w[l] + (size_t)k * dout, 1, dout, gcur, acc);
      if (l == 0) {
#pragma unroll
        for (int r = 0; r < TM; ++r)
          if (r < nrows) dx[(size_t)(row0 + r) * din + k] = acc[r];
      } else {
        const int h = l - 1;  // hidden layer whose (masked) output feeds layer l
        const float* A = net.a[h];
        const float* M = net.m[h];
        const int act = net.act[h];
        float ga[TM];
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          float v = 0.f;
          if (r < nrows) {
            const size_t o = (size_t)(row0 + r) * din + k;
            const float a = A[o];
            float gp = acc[r];
            if (M) {
              gr.dm[h][o] = acc[r] * act_fwd(act, a);
              gp = acc[r] * M[o];
            }
            v = act_vjp(act, a, gp);
            gr.ga[h][o] = v;
          }
          ga[r] = v;
        }
        float4* o4 = reinterpret_cast<float4*>(gnext + k * TMP);
#pragma unroll
        for (int q = 0; q < TM / 4; ++q)
          o4[q] = make_float4(ga[4 * q], ga[4 * q + 1], ga[4 * q + 2], ga[4 * q + 3]);
      }
    }
    __syncthreads();
    float* t = gcur;
    gcur = gnext;
    gnext = t;
  }
}

// Backward, phase B: one block per WT x WT tile of some layer's dW. It
// recomputes the layer input h = act(a) * mask (x for layer 0) and sums
// h^T g over the batch in row order; the blocks of the first row of tiles
// also sum db. 256 threads: warp ty owns dW rows ty, ty + 8, ..., lane tx
// owns column tx.
__global__ void __launch_bounds__(256)
wgrad_kernel(Net net, Grads gr, const float* __restrict__ x, const float* __restrict__ g) {
  __shared__ float hs[WT][WT + 1];
  __shared__ float gs[WT][WT + 1];
  int t = blockIdx.x, l = 0;
  while (t >= gr.tile_start[l + 1]) ++l;
  t -= gr.tile_start[l];
  const int din = net.dims[l], dout = net.dims[l + 1];
  const int jtiles = (dout + WT - 1) / WT;
  const int kt = t / jtiles, jt = t - kt * jtiles;
  const int k0 = kt * WT, j0 = jt * WT;
  const float* __restrict__ G = l == net.n ? g : gr.ga[l];
  const float* A = l > 0 ? net.a[l - 1] : nullptr;
  const float* M = l > 0 ? net.m[l - 1] : nullptr;
  const int act = l > 0 ? net.act[l - 1] : kIdentity;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int B = net.B;

  float acc[WT / 8];
#pragma unroll
  for (int q = 0; q < WT / 8; ++q) acc[q] = 0.f;
  float bsum = 0.f;
  for (int r0 = 0; r0 < B; r0 += WT) {
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
            if (M) hv *= M[o];
          }
        }
        if (jc < dout) gv = G[(size_t)row * dout + jc];
      }
      hs[rr][tx] = hv;
      gs[rr][tx] = gv;
    }
    __syncthreads();
    const int rn = min(WT, B - r0);
    for (int rr = 0; rr < rn; ++rr) {
      const float gv = gs[rr][tx];
      bsum += gv;
#pragma unroll
      for (int q = 0; q < WT / 8; ++q) acc[q] = fmaf(hs[rr][ty + 8 * q], gv, acc[q]);
    }
    __syncthreads();
  }
  const int jc = j0 + tx;
  if (jc < dout) {
#pragma unroll
    for (int q = 0; q < WT / 8; ++q) {
      const int kr = k0 + ty + 8 * q;
      if (kr < din) gr.dw[l][(size_t)kr * dout + jc] = acc[q];
    }
    if (kt == 0 && ty == 0 && gr.db[l]) gr.db[l][jc] = bsum;
  }
}

bool fill_net(Net& net, int n_hidden, int B, const int* dims, const int* acts,
              const void* const* w, const void* const* b, const void* const* m,
              void* const* a) {
  if (n_hidden < 0 || n_hidden + 1 > kMaxLayers || B < 1) return false;
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

int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

int threads_for(const Net& net) { return (net.maxw + 31) / 32 * 32; }

}  // namespace

extern "C" {

const char* fused_mlp_error(int e) {
  return e < 0 ? "arguments the kernel does not take"
               : cudaGetErrorString(static_cast<cudaError_t>(e));
}

// Returns 0, a cudaError_t, or -1 for arguments the kernels do not take.
// w, b, m, a: arrays of device pointers (b and m entries may be null).
int fused_mlp_fwd(int n_hidden, int B, const int* dims, const int* acts,
                  const void* const* w, const void* const* b, const void* const* m,
                  void* const* a, const void* x, void* out, void* stream) {
  Net net;
  if (!fill_net(net, n_hidden, B, dims, acts, w, b, m, a) || !x || !out) return -1;
  const size_t smem = 2 * (size_t)net.maxw * TMP * sizeof(float);
  int e = set_smem(reinterpret_cast<const void*>(fwd_kernel), smem);
  if (e != cudaSuccess) return e;
  fwd_kernel<<<(B + TM - 1) / TM, threads_for(net), smem, static_cast<cudaStream_t>(stream)>>>(
      net, static_cast<const float*>(x), static_cast<float*>(out));
  return cudaGetLastError();
}

// dw: n_hidden + 1 outputs; db, dm: arrays with null where absent;
// ga: n_hidden scratch buffers [B, d_{l+1}].
int fused_mlp_bwd(int n_hidden, int B, const int* dims, const int* acts,
                  const void* const* w, const void* const* m, void* const* a,
                  const void* x, const void* g, void* dx, void* const* dw,
                  void* const* db, void* const* dm, void* const* ga, void* stream) {
  Net net;
  if (!fill_net(net, n_hidden, B, dims, acts, w, nullptr, m, a) || !x || !g || !dx) return -1;
  Grads gr;
  gr.tile_start[0] = 0;
  for (int l = 0; l < kMaxLayers; ++l) {
    const bool lin = l <= n_hidden, hid = l < n_hidden;
    gr.dw[l] = lin ? static_cast<float*>(dw[l]) : nullptr;
    gr.db[l] = lin ? static_cast<float*>(db[l]) : nullptr;
    gr.dm[l] = hid ? static_cast<float*>(dm[l]) : nullptr;
    gr.ga[l] = hid ? static_cast<float*>(ga[l]) : nullptr;
    if (lin && !gr.dw[l]) return -1;
    if (hid && (!gr.ga[l] || (net.m[l] != nullptr) != (gr.dm[l] != nullptr))) return -1;
    const int tiles = lin ? ((net.dims[l] + WT - 1) / WT) * ((net.dims[l + 1] + WT - 1) / WT) : 0;
    gr.tile_start[l + 1] = gr.tile_start[l] + tiles;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = 2 * (size_t)net.maxw * TMP * sizeof(float);
  int e = set_smem(reinterpret_cast<const void*>(bwd_rows_kernel), smem);
  if (e != cudaSuccess) return e;
  bwd_rows_kernel<<<(B + TM - 1) / TM, threads_for(net), smem, s>>>(
      net, gr, static_cast<const float*>(g), static_cast<float*>(dx));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  wgrad_kernel<<<gr.tile_start[n_hidden + 1], 256, 0, s>>>(
      net, gr, static_cast<const float*>(x), static_cast<const float*>(g));
  return cudaGetLastError();
}

}  // extern "C"
