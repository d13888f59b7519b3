// The trinomial tree's backward induction on the inventory grid: one launch a
// step, one block a node row.
//
// No TPU kernel stands behind it: it replaces the lax.scan of
// storage_tpu/engines/tree.py:_tree_core, whose step is a dense
// [M, M] x [M, G] dot (tree.py:125) and then the decisions of every node and
// grid point (tree.py:130-165).  Here step t is one launch of M blocks.
// Block m
//   1. forms its row of the expected continuation,
//      ev[g] = sum_k T_t[m, k] * V_{t+1}[k, g], into shared memory, reading
//      only the row's band: the W <= 2 * num_substeps + 1 columns from
//      start[m] that hold its non-zeros (ops/tree_kernel.py band), summed in
//      ascending k (the dense product's other terms are exact zeros, so they
//      change no rounding);
//   2. in cubic mode, forms the row's spline moments in shared memory
//      (dp_common.cuh block_moments, the dense [G-2, G-2] inverse);
//   3. strides its threads over the G grid points and writes
//      V_t[m, g] = max over the D = 2E + 3 decisions of immediate PV against
//      the node's spot plus the interpolated continuation (dp_common.cuh
//      decide(), the intrinsic DP's arithmetic, every operation rounded on
//      its own).
// The launch boundary separates the steps: step t reads the whole of
// V_{t+1}, which other blocks wrote.  The values [N+1, M, G] stay in device
// memory, returned to the caller; the transition never reaches the card as
// [N, M, M].
//
// Bound on the H100: at the headline tree (N = 365, M = 99, G = 100, W = 9)
// the work is ~5·10^8 unfused operations and ~15 MB of values (0.015 ms), but
// the N steps are a chain of dependent launches of M blocks each, under one
// wave: latency, not work.  A simple design first: one launch a step keeps
// the step's hand-over in device memory and L2.
#include <cstdint>
#include <cuda_runtime.h>

#include "dp_common.cuh"

namespace {

using namespace stt_dp;

constexpr int kThreads = 256;

template <typename T>
struct TreeStep {
  int M, G, W, R, E, is_step, mode;
  const T* s;                 // step t's scalars [NUM_STEP_SCALARS]
  const T* r_inv;             // step t's ratchet nodes [R]
  const T* r_min;
  const T* r_max;
  const T* grid;              // grids[t] [G]
  const T* grid_next;         // grids[t + 1] [G]
  const T* spot;              // spot[t] [M]
  const T* band;              // band[t] [M, W]
  const int64_t* start;       // start[t] [M]: the band's first column
  const T* solver;            // [G - 2, G - 2] (cubic) or null
  const T* v_next;            // values[t + 1] [M, G]
  T* v;                       // values[t] [M, G]
};

// Shared memory: ev [G], and in cubic mode its moments [G] and the rhs [G-2].
template <typename T>
size_t smem_bytes(int G, int mode) {
  return sizeof(T) * static_cast<size_t>(mode == MODE_CUBIC ? 3 * G - 2 : G);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) tree_step_kernel(TreeStep<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ev = reinterpret_cast<T*>(smem_raw);
  const bool cubic = p.mode == MODE_CUBIC;
  T* moments = cubic ? ev + p.G : nullptr;
  const int G = p.G, m = blockIdx.x;

  const T* band = p.band + static_cast<size_t>(m) * p.W;
  const T* rows = p.v_next + static_cast<size_t>(p.start[m]) * G;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    T acc = T(0);
    for (int w = 0; w < p.W; ++w)
      acc = add(acc, mul(band[w], rows[static_cast<size_t>(w) * G + g]));
    ev[g] = acc;
  }
  __syncthreads();
  if (cubic) block_moments(p.grid_next, ev, p.solver, ev + 2 * G, moments, G);

  const StepView<T> st{p.s, p.r_inv, p.r_min, p.r_max, p.R, p.is_step, p.E, G, p.mode,
                       p.grid_next, ev, moments};
  const T price = p.spot[m];
  T* out = p.v + static_cast<size_t>(m) * G;
  for (int g = threadIdx.x; g < G; g += blockDim.x) out[g] = decide(st, price, p.grid[g]).total;
}

int smem_optin(int* bytes) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return static_cast<int>(err);
}

template <typename T>
int launch(int N, int M, int G, int W, int R, int E, int is_step, int mode, const T* steps,
           const T* r_inv, const T* r_min, const T* r_max, const T* grids, const T* spot,
           const T* band, const int64_t* start, const T* solver, T* values, void* stream) {
  if (N < 1 || M < 1 || G < 2 || W < 1 || W > M || R < 1 || E < 0 || mode < MODE_UNIFORM ||
      mode > MODE_CUBIC || (mode == MODE_CUBIC && G > 2 && !solver))
    return static_cast<int>(cudaErrorInvalidValue);
  int optin = 0;
  if (int err = smem_optin(&optin)) return err;
  const size_t smem = smem_bytes<T>(G, mode);
  if (smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tree_step_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int t = N - 1; t >= 0; --t) {
    const size_t mg = static_cast<size_t>(M) * G;
    const size_t row = static_cast<size_t>(t) * R;
    TreeStep<T> p{M, G, W, R, E, is_step, mode,
                  steps + static_cast<size_t>(t) * NUM_STEP_SCALARS,
                  r_inv + row, r_min + row, r_max + row,
                  grids + static_cast<size_t>(t) * G, grids + static_cast<size_t>(t + 1) * G,
                  spot + static_cast<size_t>(t) * M,
                  band + static_cast<size_t>(t) * M * W, start + static_cast<size_t>(t) * M,
                  mode == MODE_CUBIC ? solver : nullptr,
                  values + (t + 1) * mg, values + t * mg};
    tree_step_kernel<T><<<M, kThreads, smem, s>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <typename T>
int info(int G, int mode, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, tree_step_kernel<T>);
  int optin = 0;
  if (err == cudaSuccess) err = static_cast<cudaError_t>(smem_optin(&optin));
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes<T>(G, mode);
  int blocks = 0;
  if (smem <= static_cast<size_t>(optin)) {
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(tree_step_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, tree_step_kernel<T>, kThreads,
                                                          smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int per = static_cast<int>(sizeof(T));
  out[0] = kThreads;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = static_cast<int>(smem);
  out[4] = blocks;
  out[5] = mode == MODE_CUBIC ? (optin / per + 2) / 3 : optin / per;  // the largest G
  return 0;
}

}  // namespace

// N steps, M node rows, G grid points, W band width, R ratchet nodes, E extra
// decisions, is_step, mode (0 uniform, 1 general, 2 cubic), steps [N, 11],
// ratchet inventories, min and max rates [N, R], grids [N+1, G], spot
// [N+1, M], band [N, M, W], band start [N, M] (int64), solver [G-2, G-2]
// (cubic, else NULL), values [N+1, M, G] (values[N] given: the terminal
// values), stream.  Launches the N steps t = N-1 .. 0, one kernel each.
extern "C" int stt_tree_dp_f32(int N, int M, int G, int W, int R, int E, int is_step, int mode,
                               const float* steps, const float* r_inv, const float* r_min,
                               const float* r_max, const float* grids, const float* spot,
                               const float* band, const int64_t* start, const float* solver,
                               float* values, void* stream) {
  return launch<float>(N, M, G, W, R, E, is_step, mode, steps, r_inv, r_min, r_max, grids, spot,
                       band, start, solver, values, stream);
}

extern "C" int stt_tree_dp_f64(int N, int M, int G, int W, int R, int E, int is_step, int mode,
                               const double* steps, const double* r_inv, const double* r_min,
                               const double* r_max, const double* grids, const double* spot,
                               const double* band, const int64_t* start, const double* solver,
                               double* values, void* stream) {
  return launch<double>(N, M, G, W, R, E, is_step, mode, steps, r_inv, r_min, r_max, grids, spot,
                        band, start, solver, values, stream);
}

// Launch report of the step kernel in f32 (is_double 0) or f64 (1) at G grid
// points in a mode into out[6]: threads per block, registers per thread,
// local memory bytes per thread (spills), dynamic shared memory bytes at G,
// blocks per SM at G (0 where G does not fit), and the largest G that fits
// the card's shared memory in that mode.
extern "C" int stt_tree_dp_info(int is_double, int G, int mode, int* out) {
  if (G < 2 || mode < MODE_UNIFORM || mode > MODE_CUBIC)
    return static_cast<int>(cudaErrorInvalidValue);
  return is_double ? info<double>(G, mode, out) : info<float>(G, mode, out);
}
