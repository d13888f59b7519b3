// The intrinsic DP (the deterministic storage valuation on the forward curve)
// as one launch of one block.
//
// No TPU kernel stands behind it: it replaces the lax.scan pair of
// storage_tpu/engines/intrinsic.py:_intrinsic_core (backward over t = N-1..1,
// then the forward walk of the inventory), which the port would otherwise
// run as tensor code at ~7 launches a backward step and ~60 a forward step.
// Here the whole DP is one launch: threads stride over the G grid points of
// a backward step, a block barrier between steps, and then one thread walks
// the forward from the starting inventory.
//
// Per grid point (backward) or for the path's inventory (forward), the
// decision is dp_common.cuh's decide() against the step's forward price, in
// any of its three continuation modes; in cubic mode each step's moments are
// kept in a [N+1, G] buffer beside the values, so that the forward reads
// them.  Every operation is rounded on its own, so the arithmetic is the
// plain version's (engines/intrinsic.py intrinsic_plain) operation by
// operation.
//
// The values vs [N+1, G] live in device memory and are read through L1:
// any G works, with no shared memory at all.
//
// Bound on the H100: neither bytes (the tables, ~150 KB at N = 365, G = 100)
// nor operations (~4·10^6 at the headline) but latency: the DP is a chain of
// N - 1 dependent backward steps, each ended by a barrier, and N dependent
// forward steps on one thread.  The design keeps that chain in one launch,
// so no launch gap lies between its steps.
#include <cstdint>
#include <cuda_runtime.h>

#include "dp_common.cuh"

namespace {

using namespace stt_dp;

constexpr int kThreads = 256;

template <typename T>
struct Problem {
  int N, G, R, E, is_step, mode;
  const T* steps;    // [N, NUM_STEP_SCALARS]
  const T* r_inv;    // [N, R]
  const T* r_min;    // [N, R]
  const T* r_max;    // [N, R]
  const T* grids;    // [N + 1, G]
  const T* v_end;    // [G] terminal values on grids[N]
  const T* solver;   // [G - 2, G - 2] (cubic) or null
  T inv0;            // starting inventory
  T* vs;             // [N + 1, G] values
  T* moments;        // [N + 1, G] (cubic) or null
  T* rhs;            // [G] scratch (cubic) or null
  T* out;            // [5 * N + 1]: inventory, volume, fuel, loss, PV rows; final inventory
};

// decision_values of engines/intrinsic.py at one inventory of step t.
template <typename T>
__device__ Choice<T> decide_step(const Problem<T>& p, int t, T inv) {
  const T* s = p.steps + static_cast<size_t>(t) * NUM_STEP_SCALARS;
  const size_t row = static_cast<size_t>(t) * p.R;
  const size_t next = static_cast<size_t>(t + 1) * p.G;
  const StepView<T> st{s, p.r_inv + row, p.r_min + row, p.r_max + row, p.R, p.is_step, p.E,
                       p.G, p.mode, p.grids + next, p.vs + next,
                       p.moments ? p.moments + next : nullptr};
  return decide(st, s[S_FWD], inv);
}

// Moments of row t (values vs[t] on grids[t]), through the [G] scratch.
template <typename T>
__device__ void moments_row(const Problem<T>& p, int t) {
  const size_t row = static_cast<size_t>(t) * p.G;
  block_moments(p.grids + row, p.vs + row, p.solver, p.rhs, p.moments + row, p.G);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) intrinsic_dp_kernel(Problem<T> p) {
  const int N = p.N, G = p.G;
  const bool cubic = p.mode == MODE_CUBIC;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    p.vs[static_cast<size_t>(N) * G + g] = p.v_end[g];
    p.vs[g] = T(0);  // grid[0] is the known inventory: valued by the forward walk
  }
  __syncthreads();
  if (cubic) moments_row(p, N);
  // Backward over t = N-1 .. 1.
  for (int t = N - 1; t >= 1; --t) {
    const T* grid = p.grids + static_cast<size_t>(t) * G;
    T* v = p.vs + static_cast<size_t>(t) * G;
    for (int g = threadIdx.x; g < G; g += blockDim.x) v[g] = decide_step(p, t, grid[g]).total;
    __syncthreads();
    if (cubic) moments_row(p, t);
  }
  // Forward walk of the inventory.
  if (threadIdx.x == 0) {
    T inv = p.inv0;
    // 16 units in the last place (engines/intrinsic.py snap_to_band).
    const T snap_ulps = ldexp(T(1), sizeof(T) == 4 ? -19 : -48);
    for (int t = 0; t < N; ++t) {
      const Choice<T> c = decide_step(p, t, inv);
      const T* s = p.steps + static_cast<size_t>(t) * NUM_STEP_SCALARS;
      const T loss = mul(s[S_LOSS_PCNT], inv);
      T next = sub(add(inv, c.decision), loss);
      // A decision that fills or empties to a bound of the next band lands
      // on it: snap the rounding residual, whose sign would decide whether
      // the next decision set holds zero.
      const T tol = mul(snap_ulps, add(add(fabs(inv), fabs(c.decision)), fabs(loss)));
      if (fabs(sub(next, s[S_NEXT_MIN])) <= tol) next = s[S_NEXT_MIN];
      if (fabs(sub(next, s[S_NEXT_MAX])) <= tol) next = s[S_NEXT_MAX];
      inv = next;
      p.out[t] = inv;
      p.out[N + t] = c.decision;
      p.out[2 * N + t] = c.consumed;
      p.out[3 * N + t] = loss;
      p.out[4 * N + t] = c.pv;
    }
    p.out[5 * N] = inv;
  }
}

template <typename T>
int launch(int N, int G, int R, int E, int is_step, int mode, const T* steps, const T* r_inv,
           const T* r_min, const T* r_max, const T* grids, const T* v_end, const T* solver,
           double inv0, T* vs, T* moments, T* rhs, T* out, void* stream) {
  if (N < 1 || G < 2 || R < 1 || E < 0 || mode < MODE_UNIFORM || mode > MODE_CUBIC ||
      (mode == MODE_CUBIC && ((G > 2 && !solver) || !moments || !rhs)))
    return static_cast<int>(cudaErrorInvalidValue);
  Problem<T> p{N, G, R, E, is_step, mode, steps, r_inv, r_min, r_max, grids, v_end,
               mode == MODE_CUBIC ? solver : nullptr, static_cast<T>(inv0), vs,
               mode == MODE_CUBIC ? moments : nullptr, rhs, out};
  intrinsic_dp_kernel<T><<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// N steps, G grid points, R ratchet nodes, E extra decisions, is_step, mode
// (0 uniform, 1 general, 2 cubic), steps [N, 11], ratchet inventories, min
// and max rates [N, R], grids [N+1, G], v_end [G], solver [G-2, G-2] (cubic,
// else NULL), the starting inventory, vs [N+1, G], moments [N+1, G] and rhs
// [G] (cubic, else NULL), out [5N+1], stream.
extern "C" int stt_intrinsic_dp_f32(int N, int G, int R, int E, int is_step, int mode,
                                    const float* steps, const float* r_inv, const float* r_min,
                                    const float* r_max, const float* grids, const float* v_end,
                                    const float* solver, double inv0, float* vs, float* moments,
                                    float* rhs, float* out, void* stream) {
  return launch<float>(N, G, R, E, is_step, mode, steps, r_inv, r_min, r_max, grids, v_end,
                       solver, inv0, vs, moments, rhs, out, stream);
}

extern "C" int stt_intrinsic_dp_f64(int N, int G, int R, int E, int is_step, int mode,
                                    const double* steps, const double* r_inv, const double* r_min,
                                    const double* r_max, const double* grids, const double* v_end,
                                    const double* solver, double inv0, double* vs, double* moments,
                                    double* rhs, double* out, void* stream) {
  return launch<double>(N, G, R, E, is_step, mode, steps, r_inv, r_min, r_max, grids, v_end,
                        solver, inv0, vs, moments, rhs, out, stream);
}

// Launch report of the DP kernel in f32 (is_double 0) or f64 (1) into out[5]:
// threads per block, registers per thread, local memory bytes per thread
// (spills), static shared memory bytes, blocks per SM at that block size.
template <typename Kernel>
static int dp_info(Kernel kernel, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = kThreads;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = static_cast<int>(attr.sharedSizeBytes);
  out[4] = blocks;
  return 0;
}

extern "C" int stt_intrinsic_dp_info(int is_double, int* out) {
  return is_double ? dp_info(intrinsic_dp_kernel<double>, out)
                   : dp_info(intrinsic_dp_kernel<float>, out);
}
