// The forward sweep's vector-Jacobian product in the forward curve: the
// adjoint deltas.
//
// Replaces jax.value_and_grad of the XLA forward pass
// (storage_tpu/engines/lsmc.py:1518-1529, _forward_value_and_grad), which the
// JAX package runs for deltas_method="adjoint"; it has no Pallas kernel of
// its own.  With the bang-bang policy held fixed (its argmax carries no
// gradient) and spot = forward x stochastic part, a sim's PV depends on
// fwd[t] only through its chosen decision's immediate value,
// -(volume + fuel)·df_settle[t]·spot[t, s], so for the upstream gradient
// g [S] of each sim's PV:
//
//   grad_fwd[t] = df_settle[t] / fwd[t] · Σ_s g[s]·(−(dec[t,s] + cons[t,s]))·spot[t,s]
//
// with dec and cons the volume and fuel panels [N, S] that kernel C wrote on
// the pricing run's own sweep.
//
// Bound on the H100: device memory.  Three [N, S] panels are read once:
// 1.148 GB at N = 365, S = 262,144 in f32, 0.343 ms at 3.35 TB/s; three
// operations per element are far below that.  Design: a plain two-pass
// reduction.  Blocks of kThreads threads tile each row in chunks of
// kThreads·kPerThread sims (blockIdx.y the row, blockIdx.x the chunk); each
// thread reads its kPerThread elements of the three panels, neighbouring
// threads on neighbouring addresses, all loads issued before the sums, and
// accumulates them in order; then warp butterflies, the warps in order, and
// one partial a block.  A second kernel, one warp a row, sums a row's
// partials in a fixed order and scales it by df_settle/fwd: no atomics, the
// same bits on every run.  The accumulation is in the panels' type (f32
// like kernel C's sums, or f64).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kChunk = kThreads * kPerThread;  // sims a block sums

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) vjp_partials_kernel(
    int S, int nchunks, const T* __restrict__ dec, const T* __restrict__ cons,
    const T* __restrict__ spot, const T* __restrict__ g, T* __restrict__ partials) {
  __shared__ T red[kThreads / 32];
  const int t = blockIdx.y;
  const int base = blockIdx.x * kChunk + threadIdx.x;
  const size_t row = static_cast<size_t>(t) * S;
  T d[kPerThread], c[kPerThread], p[kPerThread], w[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int s = base + k * kThreads;
    const bool in = s < S;
    d[k] = in ? dec[row + s] : T(0);
    c[k] = in ? cons[row + s] : T(0);
    p[k] = in ? spot[row + s] : T(0);
    w[k] = in ? g[s] : T(0);
  }
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) acc += w[k] * (-(d[k] + c[k])) * p[k];
  acc = warp_sum(acc);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    T x = T(0);
    for (int i = 0; i < kThreads / 32; ++i) x += red[i];
    partials[static_cast<size_t>(t) * nchunks + blockIdx.x] = x;
  }
}

// One warp a row: lanes stride over the row's partials, then a butterfly.
template <typename T>
__global__ void vjp_finish_kernel(int N, int nchunks, const T* __restrict__ partials,
                                  const T* __restrict__ fwd, const T* __restrict__ df_settle,
                                  T* __restrict__ grad) {
  const int t = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (t >= N) return;
  const T* p = partials + static_cast<size_t>(t) * nchunks;
  T acc = T(0);
  for (int i = lane; i < nchunks; i += 32) acc += p[i];
  acc = warp_sum(acc);
  if (lane == 0) grad[t] = df_settle[t] / fwd[t] * acc;
}

template <typename T>
cudaError_t launch_vjp(int N, int S, const void* dec, const void* cons, const void* spot,
                       const void* g, const void* fwd, const void* df_settle, void* partials,
                       void* grad, void* stream) {
  if (N < 1 || S < 1 || N > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nchunks = (S + kChunk - 1) / kChunk;
  vjp_partials_kernel<T><<<dim3(nchunks, N), kThreads, 0, st>>>(
      S, nchunks, static_cast<const T*>(dec), static_cast<const T*>(cons),
      static_cast<const T*>(spot), static_cast<const T*>(g), static_cast<T*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = 256;
  vjp_finish_kernel<T><<<(N * 32 + threads - 1) / threads, threads, 0, st>>>(
      N, nchunks, static_cast<const T*>(partials), static_cast<const T*>(fwd),
      static_cast<const T*>(df_settle), static_cast<T*>(grad));
  return cudaGetLastError();
}

}  // namespace

// grad [N] from the volume, fuel and spot panels dec, cons, spot [N, S], the
// upstream gradient g [S], fwd [N] and df_settle [N]; partials [N,
// ceil(S / 2048)] are scratch.  f32 and f64 (is_double).
extern "C" int stt_forward_sweep_vjp(int N, int S, int is_double, const void* dec,
                                     const void* cons, const void* spot, const void* g,
                                     const void* fwd, const void* df_settle, void* partials,
                                     void* grad, void* stream) {
  return static_cast<int>(
      is_double ? launch_vjp<double>(N, S, dec, cons, spot, g, fwd, df_settle, partials, grad,
                                     stream)
                : launch_vjp<float>(N, S, dec, cons, spot, g, fwd, df_settle, partials, grad,
                                    stream));
}

// Sims summed by one block of the first pass (the partials' row width is
// ceil(S / this)).
extern "C" int stt_forward_sweep_vjp_chunk(int* out) {
  out[0] = kChunk;
  return 0;
}
