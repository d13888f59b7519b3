// The chain floor's timing kernels: what one link of a DP's dependent chain
// costs on the card at least.  Each iteration reads a value that another
// thread (block mode) or another CTA of the cluster (cluster mode) wrote in
// the iteration before, writes its own for the next, and ends with one
// barrier: __syncthreads, or the cluster barrier (release/acquire).  Two
// buffers alternate, as the DP kernels' value rows do, so one barrier a step
// suffices.  Grid mode is a cooperative launch of `size` blocks, each link a
// read of the next block's word in device memory and cg's grid sync, the
// intrinsic DP's large route's link at its grid.  Launch mode is a launch a
// link, each of `size` blocks reading the word the launch before wrote: the
// tree's large route's link between its step launches.  The intrinsic DP's
// shared route pays one block link a step, the tree's cluster route one
// cluster link; ops/tree_kernel.py chain_step_ns times them.  No TPU kernel
// stands behind them and no path launches them.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxGridBlocks = 4096;

__device__ float grid_words[2][kMaxGridBlocks];

template <bool kCluster>
__global__ void __launch_bounds__(kMaxThreads) chain_kernel(int iters, float* sink) {
  __shared__ float buf[2][kMaxThreads];
  const int tid = threadIdx.x, n = blockDim.x;
  buf[0][tid] = static_cast<float>(tid);
  unsigned next_rank = 0;
  if constexpr (kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    next_rank = (cluster.block_rank() + 1) % cluster.num_blocks();
    cluster.sync();
  } else {
    __syncthreads();
  }
  float x = 0.0f;
  for (int i = 0; i < iters; ++i) {
    float* src = buf[i & 1];
    if constexpr (kCluster) src = cg::this_cluster().map_shared_rank(src, next_rank);
    x = src[(tid + 1) % n];
    buf[(i + 1) & 1][tid] = x + 1.0f;
    if constexpr (kCluster)
      cg::this_cluster().sync();
    else
      __syncthreads();
  }
  if (x < 0.0f) *sink = x;  // never: keeps the chain
}

__global__ void __launch_bounds__(kMaxThreads) grid_chain_kernel(int iters, float* sink) {
  cg::grid_group grid = cg::this_grid();
  const unsigned nb = gridDim.x, next = (blockIdx.x + 1) % nb;
  float x = 0.0f;
  for (int i = 0; i < iters; ++i) {
    if (threadIdx.x == 0) {
      x = grid_words[i & 1][next];
      grid_words[(i + 1) & 1][blockIdx.x] = x + 1.0f;
    }
    grid.sync();
  }
  if (x < 0.0f) *sink = x;  // never: keeps the chain
}

__global__ void __launch_bounds__(kMaxThreads) launch_chain_kernel(int i) {
  if (threadIdx.x == 0)
    grid_words[(i + 1) & 1][blockIdx.x] = grid_words[i & 1][(blockIdx.x + 1) % gridDim.x] + 1.0f;
}

}  // namespace

// `iters` links on `stream`: kind 0, one launch of one block of `threads`
// threads; kind 1, one launch of one cluster of `size` CTAs of `threads`
// threads; kind 2, one cooperative launch of `size` blocks of `threads`
// threads (at most kMaxGridBlocks, all co-resident), a grid sync a link;
// kind 3, `iters` launches of `size` blocks of `threads` threads.
extern "C" int stt_chain_steps(int kind, int size, int threads, int iters, void* stream) {
  if (threads < 32 || threads > kMaxThreads || iters < 0 || kind < 0 || kind > 3 ||
      (kind >= 1 && (size < 1 || (kind != 1 && size > kMaxGridBlocks))))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0) {
    chain_kernel<false><<<1, threads, 0, s>>>(iters, nullptr);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err;
  if (kind == 2) {
    float* sink = nullptr;
    void* args[] = {&iters, &sink};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(grid_chain_kernel),
                                      dim3(size), dim3(threads), args, 0, s);
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
  }
  if (kind == 3) {
    for (int i = 0; i < iters; ++i) {
      launch_chain_kernel<<<size, threads, 0, s>>>(i);
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
  }
  err = cudaFuncSetAttribute(chain_kernel<true>, cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = size;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(size);
  config.blockDim = dim3(threads);
  config.stream = s;
  config.attrs = &attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, chain_kernel<true>, iters, static_cast<float*>(nullptr));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
