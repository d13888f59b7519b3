// Shared pieces of the storage_tpu_torch kernels: the monomial basis table,
// the design row built in registers, and the deterministic second-stage
// reduction of per-block partial sums.
#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace stt {

// The most basis functions and Markov factors of a monomial design built on
// the card in registers (kernels B and E, kernel C's monomial mode); a larger
// shape takes their wide routes (WideBasis; C's forward_sweep.cuh is_wide),
// on any factor count, up to kMaxWideB terms (the length of E's solve's
// per-thread substitution vector); past that, the design read from memory
// (engines/lsmc.py design_in_memory).  B's and E's wide route holds a sim's
// design row in registers up to kMaxWideRegB terms (compiled per padded
// size), in shared memory beyond; C's in shared memory.
constexpr int kMaxB = 16;  // basis functions
constexpr int kMaxF = 8;   // Markov factors
constexpr int kMaxWideB = 64;
constexpr int kMaxWideRegB = 32;

// Monomial powers, passed to kernels by value.  pows[b][0] is the spot power,
// pows[b][1 + f] the power of factor f.
struct Basis {
  int nb;
  int nf;
  int8_t pows[kMaxB][kMaxF + 1];
};

// The same powers for any B and F, past the caps (the wide routes):
// pows[b·(nf + 1)] is the spot power of term b, pows[b·(nf + 1) + 1 + f] the
// power of factor f.  The table reaches the kernel in device memory, the
// wrapper's [B, F + 1] int8 tensor, and each block stages it in shared
// memory; kernels read it at warp-uniform addresses.  (Growing Basis would
// cost every register route parameter space and registers.)
struct WideBasis {
  const int8_t* pows;
  int nb;
  int nf;
};

__host__ __device__ __forceinline__ int power_of(const Basis& basis, int b, int j) {
  return basis.pows[b][j];
}
__host__ __device__ __forceinline__ int power_of(const WideBasis& basis, int b, int j) {
  return basis.pows[b * (basis.nf + 1) + j];
}

// Host: unpack the wrapper's int table [B, (spot, F factor powers) * B].
static inline bool make_basis(const int* table, int num_factors, Basis* out) {
  const int nb = table[0];
  if (nb < 1 || nb > kMaxB || num_factors < 0 || num_factors > kMaxF) return false;
  out->nb = nb;
  out->nf = num_factors;
  for (int b = 0; b < kMaxB; ++b)
    for (int f = 0; f <= kMaxF; ++f) out->pows[b][f] = 0;
  for (int b = 0; b < nb; ++b)
    for (int f = 0; f <= num_factors; ++f)
      out->pows[b][f] = static_cast<int8_t>(table[1 + b * (num_factors + 1) + f]);
  return true;
}

// x**p by repeated multiplication, left to right (p >= 1).
__device__ __forceinline__ float ipow(float x, int p) {
  float r = x;
  for (int i = 1; i < p; ++i) r = __fmul_rn(r, x);
  return r;
}

// Standardised design row (x - mean) / std of one sim.  Products in the JAX
// package's order: spot power first, then factor powers by index.  Loops run
// to the compile-time maxima so that `row` stays in registers.
__device__ __forceinline__ void design_row(const Basis& basis, float spot,
                                           const float* fac, const float* mean,
                                           const float* stdv, float* row) {
#pragma unroll
  for (int b = 0; b < kMaxB; ++b) {
    if (b < basis.nb) {
      float v = 1.0f;
      const int sp = basis.pows[b][0];
      if (sp) v = __fmul_rn(v, ipow(spot, sp));
#pragma unroll
      for (int f = 0; f < kMaxF; ++f) {
        if (f < basis.nf) {
          const int fp = basis.pows[b][1 + f];
          if (fp) v = __fmul_rn(v, ipow(fac[f], fp));
        }
      }
      row[b] = __fdiv_rn(__fsub_rn(v, mean[b]), stdv[b]);
    } else {
      row[b] = 0.0f;
    }
  }
}

// out[k] = sum over blocks of partials[k * nblk + blk], one warp per output,
// lanes striding over blocks then a fixed butterfly: no atomics, so the same
// inputs give the same bits on every run.
static __global__ void reduce_partials_kernel(const float* __restrict__ partials,
                                       int nblk, int nout,
                                       float* __restrict__ out) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= nout) return;
  const float* p = partials + static_cast<size_t>(warp) * nblk;
  float acc = 0.0f;
  for (int i = lane; i < nblk; i += 32) acc += p[i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[warp] = acc;
}

static inline void launch_reduce(const float* partials, int nblk, int nout, float* out,
                          cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (nout * 32 + threads - 1) / threads;
  reduce_partials_kernel<<<blocks, threads, 0, stream>>>(partials, nblk, nout, out);
}

// Launch report of a kernel whose dynamic shared memory is
// fixed_words + words_per_grid_point·G floats, on the current device, into
// out[6]: sims (threads) per block, the shared memory bytes of a block at G
// (static and dynamic), the device's limit per block, the largest G within
// that limit (INT_MAX where nothing grows with G), blocks per SM at G (0
// where G does not fit), registers per thread.
template <typename Kernel>
static inline cudaError_t kernel_info(Kernel kernel, int threads, size_t fixed_words,
                                      size_t words_per_grid_point, int G, int* out) {
  int dev = 0;
  int limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  const size_t dynamic = sizeof(float) * (fixed_words + words_per_grid_point * G);
  const size_t total = attr.sharedSizeBytes + dynamic;
  const size_t room = static_cast<size_t>(limit) - attr.sharedSizeBytes;
  int blocks = 0;
  if (total <= static_cast<size_t>(limit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dynamic));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, dynamic);
    if (err != cudaSuccess) return err;
  }
  out[0] = threads;
  out[1] = static_cast<int>(total);
  out[2] = limit;
  out[3] = room / sizeof(float) < fixed_words ? 0
           : words_per_grid_point == 0 ? INT_MAX
           : static_cast<int>((room / sizeof(float) - fixed_words) / words_per_grid_point);
  out[4] = blocks;
  out[5] = attr.numRegs;
  return cudaSuccess;
}

}  // namespace stt
