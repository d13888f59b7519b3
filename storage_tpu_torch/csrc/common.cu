// The caps of common.cuh, exported so that the wrappers' copy of them
// (ops/_build.py MAX_BASIS, MAX_FACTORS, MAX_WIDE_BASIS,
// MAX_WIDE_REGISTER_BASIS: the shape routes and require_wide_basis read
// it) can be held to the built library (chip_smoke.py); and the device's
// shared memory a block, which the grid routes read.
#include "common.cuh"

// out[0] the most basis functions, out[1] the most factors a register route
// takes, out[2] the most basis functions of the wide routes of kernels B, C
// and E, out[3] the most (padded) of B's and E's register row.
extern "C" int stt_limits(int* out) {
  out[0] = stt::kMaxB;
  out[1] = stt::kMaxF;
  out[2] = stt::kMaxWideB;
  out[3] = stt::kMaxWideRegB;
  return 0;
}

// out[0] the shared memory, in bytes, a block can opt in to on the current
// device (the grid routes' limit, ops/_build.py smem_limit).
extern "C" int stt_smem_limit(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(err);
}
