// Probe of what the whole-rollout kernel (prob_mbrl_tpu_torch/csrc/
// fused_rollout.cu) builds on: a cooperative launch of thread-block clusters
// of 8 CTAs (cudaLaunchKernelEx with a cluster dimension and the cooperative
// attribute), this_grid().sync() across clusters, against a software
// barrier at cluster level and cluster barriers alone (time per iteration
// of 2000 by %globaltimer, with a DSMEM write checked each iteration), the
// clusters the card holds at several shared-memory sizes, and a launch one
// cluster beyond that (refused, its error cleared, then a normal launch).
// Built and run by tools/torch_cluster_probe.py.
#include <cooperative_groups.h>
#include <cstdio>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

__device__ __forceinline__ unsigned long long gt() {
  unsigned long long t; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); return t; }
__device__ __forceinline__ void carrive() { asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void cwait() { asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory"); }

__global__ void __launch_bounds__(512) k_grid(int iters, float* part, int* err, unsigned long long* ns, int mode, unsigned* bar) {
  extern __shared__ float sm[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = cl.block_rank(), cid = blockIdx.x / 8, nc = gridDim.x / 8;
  unsigned long long t0 = gt();
  for (int it = 0; it < iters; ++it) {
    if (threadIdx.x == 0 && rank == 0) part[(size_t)(it & 1) * nc + cid] = (float)(it + cid);
    if (mode == 0) {
      cg::this_grid().sync();
    } else if (mode == 1) {
      __syncthreads();
      __threadfence();
      carrive(); cwait();
      if (rank == 0 && threadIdx.x == 0) {
        volatile unsigned* gen = bar + 1;
        const unsigned g = *gen;
        __threadfence();
        if (atomicAdd(bar, 1u) == (unsigned)nc - 1) { bar[0] = 0; __threadfence(); atomicAdd(bar + 1, 1u); }
        else { while (*gen == g) {} }
        __threadfence();
      }
      carrive(); cwait();
    } else {
      carrive(); cwait();
    }
    if (mode != 2 && threadIdx.x == 0) {
      float s = 0.f, want = 0.f;
      for (int c = 0; c < nc; ++c) { s += ((volatile float*)part)[(size_t)(it & 1) * nc + c]; want += (float)(it + c); }
      if (s != want) atomicAdd(err, 1);
    }
    // a DSMEM write to the next rank, checked after one more cluster barrier
    if (threadIdx.x == 0) *cl.map_shared_rank(sm, (rank + 1) % 8) = (float)(it * 8 + rank);
    carrive(); cwait();
    if (threadIdx.x == 0 && sm[0] != (float)(it * 8 + (rank + 7) % 8)) atomicAdd(err, 1);
    carrive(); cwait();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *ns = gt() - t0;
}

int launch(int clusters, int smem, int iters, float* part, int* err, unsigned long long* ns, int mode, unsigned* bar, bool coop) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * 8); cfg.blockDim = dim3(512); cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeClusterDimension; at[0].val.clusterDim.x = 8; at[0].val.clusterDim.y = 1; at[0].val.clusterDim.z = 1;
  at[1].id = cudaLaunchAttributeCooperative; at[1].val.cooperative = 1;
  cfg.attrs = at; cfg.numAttrs = coop ? 2 : 1;
  int e = cudaLaunchKernelEx(&cfg, k_grid, iters, part, err, ns, mode, bar);
  if (e != cudaSuccess) { cudaGetLastError(); return e; }
  return cudaGetLastError();
}

int main() {
  cudaFuncSetAttribute(k_grid, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448 - 1024);
  cudaFuncSetAttribute(k_grid, cudaFuncAttributeNonPortableClusterSizeAllowed, 0);
  int sizes[] = {16384, 60000, 100000, 116000, 150000, 200000, 231000};
  for (int s : sizes) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(8); cfg.blockDim = dim3(512); cfg.dynamicSmemBytes = s;
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension; at[0].val.clusterDim.x = 8; at[0].val.clusterDim.y = 1; at[0].val.clusterDim.z = 1;
    cfg.attrs = at; cfg.numAttrs = 1;
    int n = -1; int e = cudaOccupancyMaxActiveClusters(&n, k_grid, &cfg);
    printf("occupancy smem=%d threads=512: max active clusters %d (rc %d)\n", s, n, e);
  }
  int maxc = 0;
  {
    cudaLaunchConfig_t cfg = {}; cfg.gridDim = dim3(8); cfg.blockDim = dim3(512); cfg.dynamicSmemBytes = 200000;
    cudaLaunchAttribute at[1]; at[0].id = cudaLaunchAttributeClusterDimension; at[0].val.clusterDim.x = 8; at[0].val.clusterDim.y = 1; at[0].val.clusterDim.z = 1;
    cfg.attrs = at; cfg.numAttrs = 1; cudaOccupancyMaxActiveClusters(&maxc, k_grid, &cfg);
  }
  float* part; int* err; unsigned long long* ns; unsigned* bar;
  cudaMalloc(&part, 4096); cudaMalloc(&err, 4); cudaMalloc(&ns, 8); cudaMalloc(&bar, 8); cudaMemset(bar, 0, 8);
  const char* names[] = {"cg grid.sync (cooperative)", "software cluster-level barrier", "cluster barrier only"};
  int iters = 2000;
  for (int mode = 0; mode < 3; ++mode) {
    for (int c : {1, 2, 13, maxc}) {
      cudaMemset(err, 0, 4);
      int e = launch(c, 200000, iters, part, err, ns, mode, bar, mode == 0);
      int e2 = cudaDeviceSynchronize();
      int h_err = -1; unsigned long long h_ns = 0;
      cudaMemcpy(&h_err, err, 4, cudaMemcpyDeviceToHost); cudaMemcpy(&h_ns, ns, 8, cudaMemcpyDeviceToHost);
      printf("%s clusters=%d: launch rc %d (%s) sync rc %d errors %d; %.3f us per iteration (barrier + 2 cluster barriers + checks)\n",
             names[mode], c, e, cudaGetErrorString((cudaError_t)e), e2, h_err, h_ns / 1e3 / iters);
    }
  }
  // too many clusters, cooperative: expect a refusal, then a normal launch
  int e = launch(maxc + 1, 200000, 10, part, err, ns, 0, bar, true);
  printf("cooperative launch of %d clusters (one beyond the occupancy): rc %d (%s); last error after: %d\n", maxc + 1, e, cudaGetErrorString((cudaError_t)e), (int)cudaGetLastError());
  cudaMemset(err, 0, 4);
  e = launch(maxc, 200000, 10, part, err, ns, 0, bar, true);
  int e2 = cudaDeviceSynchronize();
  int h_err = -1; cudaMemcpy(&h_err, err, 4, cudaMemcpyDeviceToHost);
  printf("then %d clusters: rc %d sync %d errors %d\n", maxc, e, e2, h_err);
  return 0;
}
