// The caps of common.cuh, exported so that the wrappers' copy of them
// (ops/_build.py MAX_BASIS, MAX_FACTORS: the shape route and require_caps
// read it) can be held to the built library (chip_smoke.py).
#include "common.cuh"

// out[0] the most basis functions, out[1] the most factors a kernel takes.
extern "C" int stt_limits(int* out) {
  out[0] = stt::kMaxB;
  out[1] = stt::kMaxF;
  return 0;
}
