// What every kernel of the port knows of a dropout MLP, shared by fused_mlp.cu
// (the fused dropout-MLP kernels) and, through rollout_step.cuh, by
// fused_step.cu and fused_rollout.cu: its limits, its weights, biases and
// masks (Net), and each hidden activation with its VJP. Everything is
// float32.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLayers = 8;    // linear layers: hidden layers + the output layer
constexpr int kMaxWidth = 1000;  // widest feature dim; bounds shared memory and threads

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

}  // namespace
