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
// The tile walks and the weight-gradient kernel live in mlp_tile.cuh, which
// the rollout-step kernels (fused_step.cu) share.

#include "mlp_tile.cuh"

namespace {

// Forward: one block per TM rows walks every layer; pre-activations go to
// device memory for the backward, the output layer to out.
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
  mlp_rows_fwd(net, hin, hout, row0, nrows, nullptr, out);
}

// Backward, phase A: one block per TM rows walks the layers in reverse and
// writes dx, d(mask) and g_a (each hidden pre-activation's gradient) for
// phase B, wgrad_kernel.
__global__ void __launch_bounds__(1024)
bwd_rows_kernel(Net net, Grads gr, const float* __restrict__ g, float* __restrict__ dx) {
  extern __shared__ __align__(16) float smem[];
  float* gcur = smem;
  float* gnext = smem + net.maxw * TMP;
  const int row0 = blockIdx.x * TM;
  const int nrows = min(TM, net.B - row0);
  const int dout = net.dims[net.n + 1];
  for (int i = threadIdx.x; i < TM * dout; i += blockDim.x) {
    const int r = i / dout, j = i - r * dout;
    gcur[j * TMP + r] = r < nrows ? g[(size_t)(row0 + r) * dout + j] : 0.f;
  }
  __syncthreads();
  mlp_rows_bwd(net, gr, gcur, gnext, row0, nrows, nullptr, dx);
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
  fwd_kernel<<<(B + TM - 1) / TM, threads_for(net.maxw), smem, static_cast<cudaStream_t>(stream)>>>(
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
  for (int l = 0; l < kMaxLayers; ++l) {
    const bool lin = l <= n_hidden, hid = l < n_hidden;
    gr.dw[l] = lin ? static_cast<float*>(dw[l]) : nullptr;
    gr.db[l] = lin ? static_cast<float*>(db[l]) : nullptr;
    gr.dm[l] = hid ? static_cast<float*>(dm[l]) : nullptr;
    gr.ga[l] = hid ? static_cast<float*>(ga[l]) : nullptr;
    if (lin && !gr.dw[l]) return -1;
    if (hid && (!gr.ga[l] || (net.m[l] != nullptr) != (gr.dm[l] != nullptr))) return -1;
  }
  fill_tiles(net, gr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = 2 * (size_t)net.maxw * TMP * sizeof(float);
  int e = set_smem(reinterpret_cast<const void*>(bwd_rows_kernel), smem);
  if (e != cudaSuccess) return e;
  bwd_rows_kernel<<<(B + TM - 1) / TM, threads_for(net.maxw), smem, s>>>(
      net, gr, static_cast<const float*>(g), static_cast<float*>(dx));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  wgrad_kernel<<<gr.tile_start[n_hidden + 1], 256, 0, s>>>(
      net, gr, static_cast<const float*>(x), static_cast<const float*>(g));
  return cudaGetLastError();
}

}  // extern "C"
