// The caps of common.cuh, exported for the wrappers: they check a basis and a
// factor count against them before any launch (ops/_build.py require_caps).
#include "common.cuh"

// out[0] the most basis functions, out[1] the most factors a kernel takes.
extern "C" int stt_limits(int* out) {
  out[0] = stt::kMaxB;
  out[1] = stt::kMaxF;
  return 0;
}
