// Whether a cooperative launch (the whole grid co-resident, as K1's and
// K2's grid barriers need) also takes thread-block cluster dimensions
// through cudaLaunchKernelEx, and what a bare grid barrier (the kernels'
// own: a release add and an acquire poll on a global counter) and a
// cluster barrier cost. One block of 512 threads per SM, `smem` bytes of
// dynamic shared memory each, as the kernels launch.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o cluster_barrier ode_vio_tpu_torch/probes/cluster_barrier.cu
//   for c in 1 2 4 8; do ./cluster_barrier $c 200000; done
//
// Prints, per cluster size: the clusters that can be active at once and
// the clusters the grid needs; then, for 2000 rounds of cluster and grid
// barriers, of grid barriers alone and of cluster barriers alone, the
// launch's error and the time per round (CUDA events). A grid barrier that
// waits 2 s traps instead of hanging.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
namespace cg = cooperative_groups;

__device__ __forceinline__ uint64_t gns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void probe(unsigned* arrivals, unsigned* ranks, int rounds, int use_cluster,
                      int use_grid) {
  extern __shared__ float sm[];
  unsigned target = 0;
  for (int r = 0; r < rounds; ++r) {
    if (use_cluster) cg::this_cluster().sync();
    if (use_grid) {
      __syncthreads();
      target += gridDim.x;
      if (threadIdx.x == 0) {
        asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(arrivals), "r"(1u) : "memory");
        unsigned seen;
        const uint64_t t0 = gns();
        for (unsigned spin = 1;; ++spin) {
          asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(seen) : "l"(arrivals) : "memory");
          if (seen >= target) break;
          if ((spin & 1023u) == 0 && gns() - t0 > 2000000000ull) __trap();
        }
      }
      __syncthreads();
    }
  }
  if (threadIdx.x == 0) ranks[blockIdx.x] = cg::this_cluster().block_rank();
}

int main(int argc, char** argv) {
  const int c = atoi(argv[1]);
  const int smem = atoi(argv[2]);
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int grid = sms / c * c;
  cudaError_t e = cudaFuncSetAttribute(probe, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (c > 8 && e == cudaSuccess)
    e = cudaFuncSetAttribute(probe, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  printf("cluster %d smem %d grid %d set_attr %s\n", c, smem, grid, cudaGetErrorString(e));
  unsigned *arrivals, *ranks;
  cudaMalloc(&arrivals, 4);
  cudaMalloc(&ranks, 4 * grid);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeCooperative;
  attrs[0].val.cooperative = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = c;
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = 1;
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(512);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  int max_clusters = -1;
  cfg.numAttrs = 1;
  cfg.attrs = attrs + 1;
  e = cudaOccupancyMaxActiveClusters(&max_clusters, probe, &cfg);
  printf("max_active_clusters %d (%s), clusters needed %d\n", max_clusters, cudaGetErrorString(e),
         grid / c);
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  const char* names[3] = {"cluster+grid", "grid only", "cluster only"};
  const int uc[3] = {1, 0, 1}, ug[3] = {1, 1, 0};
  for (int m = 0; m < 3; ++m) {
    const int rounds = 2000;
    cudaMemset(arrivals, 0, 4);
    cudaEvent_t a, b;
    cudaEventCreate(&a);
    cudaEventCreate(&b);
    cudaEventRecord(a);
    e = cudaLaunchKernelEx(&cfg, probe, arrivals, ranks, rounds, uc[m], ug[m]);
    cudaEventRecord(b);
    cudaError_t s = cudaDeviceSynchronize();
    if (e != cudaSuccess || s != cudaSuccess) {
      printf("%s: launch %s, run %s\n", names[m], cudaGetErrorString(e), cudaGetErrorString(s));
      return s != cudaSuccess;
    }
    float ms = 0.f;
    cudaEventElapsedTime(&ms, a, b);
    printf("%s: %.3f us per round\n", names[m], ms * 1e3f / rounds);
  }
  unsigned h[4];
  cudaMemcpy(h, ranks, 16, cudaMemcpyDeviceToHost);
  printf("ranks of blocks 0-3: %u %u %u %u\n", h[0], h[1], h[2], h[3]);
  return 0;
}
