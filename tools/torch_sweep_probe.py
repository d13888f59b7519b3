#!/usr/bin/env python3
"""Variants of the simulation sweep of ``storage_tpu_torch``
(``csrc/sim_sweep.cu``, kernel A fused with the OU steps and the spot), timed
on one NVIDIA GPU on the headline's step tables (P=366, F=3, S=262,144, seed
11: ``chip_smoke.engine_inputs``).

Each variant is a text patch of the repository's ``sim_sweep.cu`` (and of
``threefry.cuh`` beside it), built alone into ``build/sweep_probe/<variant>/``:

  as_is         the kernel as committed: one path a thread, 256 a block, the
                step tables read through L1;
  tables_smem   every step's tables (decay, L, vols, c) staged once per block
                in shared memory, then read from there;
  paths2        two paths a thread (s and s + 128 of a 256-path block, 128
                threads a block), their draws and steps interleaved;
and, timing only (its bits differ):
  fma_erfinv    the erfinv polynomial by fused multiply-adds.

For each it prints blocks per SM, registers, local (spill) bytes, SASS
instructions (all and by class), the mean milliseconds per path set (CUDA
events over ``--repeats`` calls) and whether factors and spot are the plain
version's bits.  Before the variants it times kernel A's draw-only entry at
the same shapes (550 block rows).  The report goes to
``build/sweep_probe/sweep_probe.json``.

    python3 tools/torch_sweep_probe.py
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "build" / "sweep_probe"
SOURCE = "sim_sweep.cu"
HEADER = "threefry.cuh"

_TABLES = """    const float* dk = decay + static_cast<size_t>(k) * F;
    const float* lk = chol + static_cast<size_t>(k) * F * F;
    const float* vk = vols + static_cast<size_t>(k) * F;"""
_TABLES_SMEM = """    const float* dk = tab + static_cast<size_t>(k) * kRec;
    const float* lk = dk + F;
    const float* vk = lk + F * F;"""
_C_READ = "__ldg(c + k)"
_HEAD = """  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= S) return;"""
_STAGE = """  extern __shared__ float tab[];
  const int kRec = 2 * F + F * F + 1;
  for (int i = threadIdx.x; i < P * kRec; i += kThreads) {
    const int k = i / kRec;
    const int r = i - k * kRec;
    tab[i] = r < F ? decay[k * F + r]
           : r < F + F * F ? chol[k * F * F + r - F]
           : r < 2 * F + F * F ? vols[k * F + r - F - F * F] : c[k];
  }
  __syncthreads();
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= S) return;"""
# Shared memory is read directly, not through the read-only data cache.
_SMEM_READS = [("__ldg(lk + i * F)", "lk[i * F]"), ("__ldg(lk + i * F + j)", "lk[i * F + j]"),
               ("__ldg(dk + i)", "dk[i]"), ("__ldg(vk + i)", "vk[i]")]
_LAUNCH = "kernel<<<(S + kThreads - 1) / kThreads, kThreads, smem,"
_LAUNCH_SMEM = ("kernel<<<(S + kThreads - 1) / kThreads, kThreads, "
                "sizeof(float) * P * (2 * F + F * F + 1),")

# Two paths a thread: the kernel's body with every per-path value doubled (the
# compiled sizes only: the wide route is patched out).
_KERNEL_START = "template <int kF>\n__global__ void __launch_bounds__(kThreads) sim_sweep_kernel("
_KERNEL_END = "using SweepKernel ="
_WIDE_CASE = "default: return F > kMaxRegisterF ? sim_sweep_kernel<0> : nullptr;"
_PATHS2 = """template <int kF>
__global__ void __launch_bounds__(kThreads / 2) sim_sweep_kernel(
    int num_factors, uint32_t k0, uint32_t k1, uint32_t start, int P, int S,
    const uint32_t* __restrict__ ids, const float* __restrict__ sign,
    const float* __restrict__ x_in, const float* __restrict__ decay,
    const float* __restrict__ chol, const float* __restrict__ vols,
    const float* __restrict__ c, float* __restrict__ factors, float* __restrict__ spot) {
  constexpr int F = kF;
  constexpr int kHalf = kThreads / 2;
  const int s0 = blockIdx.x * kThreads + threadIdx.x;
  bool live[2];
  uint32_t hi[2];
  float sg[2];
  float x[2][F];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int s = s0 + q * kHalf;
    live[q] = s < S;
    hi[q] = live[q] ? ids[s] : 0u;
    sg[q] = sign != nullptr && live[q] ? sign[s] : 1.0f;
#pragma unroll
    for (int i = 0; i < F; ++i)
      x[q][i] = x_in != nullptr && live[q] ? x_in[static_cast<size_t>(i) * S + s] : 0.0f;
  }
  const uint32_t w0 = start * static_cast<uint32_t>(F);
  uint32_t block = w0 / 2;
  uint32_t spare[2] = {0u, 0u};
  bool have_spare = (w0 & 1u) != 0;
  if (have_spare) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      uint32_t x0 = hi[q];
      uint32_t x1 = block;
      stt::threefry2x32(k0, k1, x0, x1);
      spare[q] = x1;
    }
  }
  for (int k = 0; k < P; ++k) {
    float z[2][F];
#pragma unroll
    for (int i = 0; i < F; ++i) {
      uint32_t bits[2];
      if (have_spare) {
        bits[0] = spare[0];
        bits[1] = spare[1];
        ++block;
      } else {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          uint32_t x0 = hi[q];
          uint32_t x1 = block;
          stt::threefry2x32(k0, k1, x0, x1);
          bits[q] = x0;
          spare[q] = x1;
        }
      }
      have_spare = !have_spare;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        z[q][i] = stt::bits_to_normal(bits[q]);
        if (sign != nullptr) z[q][i] = __fmul_rn(z[q][i], sg[q]);
      }
    }
    const float* dk = decay + static_cast<size_t>(k) * F;
    const float* lk = chol + static_cast<size_t>(k) * F * F;
    const float* vk = vols + static_cast<size_t>(k) * F;
    const float ck = __ldg(c + k);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int s = s0 + q * kHalf;
      float ln_s = 0.0f;
#pragma unroll
      for (int i = 0; i < F; ++i) {
        float lz = __fmul_rn(__ldg(lk + i * F), z[q][0]);
#pragma unroll
        for (int j = 1; j < F; ++j) lz = __fadd_rn(lz, __fmul_rn(__ldg(lk + i * F + j), z[q][j]));
        x[q][i] = __fadd_rn(__fmul_rn(x[q][i], __ldg(dk + i)), lz);
        if (live[q]) factors[(static_cast<size_t>(k) * F + i) * S + s] = x[q][i];
        const float term = __fmul_rn(__ldg(vk + i), x[q][i]);
        ln_s = i == 0 ? term : __fadd_rn(ln_s, term);
      }
      if (live[q]) spot[static_cast<size_t>(k) * S + s] = expf(__fadd_rn(ln_s, ck));
    }
  }
}

"""
_PATHS2_LAUNCH = "kernel<<<(S + kThreads - 1) / kThreads, kThreads / 2, smem,"
_INFO = "stt::kernel_info(kernel, kThreads, 0,"

_POLY = "p = __fadd_rn("
_FMA_ERFINV = [
    (f"{_POLY}{c}, __fmul_rn(p, w));", f"p = fmaf(p, w, {c});")
    for c in ("3.43273939e-07f", "-3.5233877e-06f", "-4.39150654e-06f", "0.00021858087f",
              "-0.00125372503f", "-0.00417768164f", "0.246640727f", "1.50140941f",
              "0.000100950558f", "0.00134934322f", "-0.00367342844f", "0.00573950773f",
              "-0.0076224613f", "0.00943887047f", "1.00167406f", "2.83297682f")
]

# name: (patches of sim_sweep.cu, patches of threefry.cuh)
VARIANTS = {
    "as_is": ([], []),
    "tables_smem": ([(_HEAD, _STAGE), (_TABLES, _TABLES_SMEM), *_SMEM_READS,
                     (_C_READ, "tab[k * kRec + kRec - 1]"), (_LAUNCH, _LAUNCH_SMEM)], []),
    "paths2": ([("KERNEL", _PATHS2), (_WIDE_CASE, "default: return nullptr;"),
                (_LAUNCH, _PATHS2_LAUNCH), (_INFO, "stt::kernel_info(kernel, kThreads / 2, 0,")],
               []),
    "fma_erfinv": ([], _FMA_ERFINV),
}
TIMING_ONLY = {"fma_erfinv"}

# Registers and local bytes of the variant's kernel at F=3, appended to its source.
_ATTRS = """
extern "C" int probe_attrs(int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, sim_sweep_kernel<3>);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(err);
}
"""


def _patch(text: str, patches, name: str, file: str) -> str:
    for anchor, repl in patches:
        if anchor == "KERNEL":
            i, j = text.index(_KERNEL_START), text.index(_KERNEL_END)
            text = text[:i] + repl + text[j:]
            continue
        if anchor not in text:
            raise RuntimeError(f"{name}: anchor not found in {file}: {anchor[:60]!r}")
        text = text.replace(anchor, repl)
    return text


def build_all(csrc: Path):
    from storage_tpu_torch.ops import _build

    nvcc = _build.find_nvcc()
    procs = {}
    for name, (patches, header_patches) in VARIANTS.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / SOURCE).write_text(_patch((csrc / SOURCE).read_text(), patches, name, SOURCE) + _ATTRS)
        (d / HEADER).write_text(_patch((csrc / HEADER).read_text(), header_patches, name, HEADER))
        procs[name] = subprocess.Popen(
            [nvcc, *_build.COMPILE_FLAGS, "-shared", "-I", str(csrc), "-o", str(d / "lib.so"),
             str(d / SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, ptxas = {}, {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        ptxas[name] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        for fn in ("stt_simulate_sweep", "stt_simulate_sweep_info"):
            getattr(lib, fn).argtypes = list(_build.SIGNATURES[fn])
            getattr(lib, fn).restype = ctypes.c_int
        lib.probe_attrs.argtypes = [ctypes.c_void_p]
        lib.probe_attrs.restype = ctypes.c_int
        libs[name] = lib
    return libs, ptxas


def sass_by_class(lib: Path) -> dict:
    import chip_smoke
    from storage_tpu_torch.ops import _build

    opcodes = _build.sass_opcodes(lib, "sim_sweep_kernelILi3EE")
    out = {k: sum(opcodes[o] for o in ops) for k, ops in chip_smoke.SASS_CLASSES.items()}
    out["total"] = sum(opcodes.values())
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=20)
    args = ap.parse_args(argv[1:])
    import torch

    if not torch.cuda.is_available():
        print("sweep probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    import storage_tpu_torch as pkg
    from storage_tpu_torch.models import spot_sim
    from storage_tpu_torch.ops import _build, rng_kernel

    device = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(card, flush=True)
    _build.limits()  # from the repository's library, before the variants stand in for it
    libs, ptxas = build_all(REPO / "storage_tpu_torch" / "csrc")
    _, sim_in, _, _ = chip_smoke.engine_inputs(pkg, device)
    decay, chol, vols, half_var, fwd = sim_in
    c = torch.log(fwd) - half_var
    p, f = decay.shape
    s = chip_smoke.NUM_SIMS
    key = spot_sim.key_from_seed(11)
    ids = torch.arange(s, dtype=torch.int32, device=device)
    want = rng_kernel.simulate_sweep_plain(key, ids, None, decay, chol, vols, c)
    nb = p * f // 2 + 1
    a_ms = chip_smoke.cuda_ms(lambda: rng_kernel.normal_halves(key, 0, nb, ids), args.repeats)
    print(f"kernel A normal_halves [{nb} x {s}] alone: {a_ms:.4f} ms", flush=True)
    rows = []
    for name, lib in libs.items():
        rng_kernel._sweep_info.cache_clear()
        with mock.patch.object(_build, "library", lambda lib=lib: lib):
            fn = lambda: rng_kernel.simulate_sweep(key, ids, None, decay, chol, vols, c)  # noqa: E731
            got = fn()
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(got, want))
            del got
            ms = chip_smoke.cuda_ms(fn, args.repeats)
            info = rng_kernel.sweep_info(f, device)
        attrs = (ctypes.c_int * 2)()
        _build.check(lib.probe_attrs(attrs), name)
        sass = sass_by_class(OUT / name / "lib.so")
        row = dict(variant=name, timing_only=name in TIMING_ONLY, ms=ms, bits_equal_plain=same,
                   blocks_per_sm=info["blocks_per_sm"], threads_per_block=info["paths_per_block"],
                   registers=attrs[0], local_bytes=attrs[1], sass=sass)
        rows.append(row)
        print(f"{name:12s} blocks/SM {info['blocks_per_sm']:2d}  threads {info['paths_per_block']:3d}  "
              f"regs {attrs[0]:3d}  local {attrs[1]:3d} B  SASS {sass}  {ms:.4f} ms  "
              f"bits as plain: {same}", flush=True)
    rng_kernel._sweep_info.cache_clear()
    num_bytes, unfused, ints = chip_smoke.sweep_work(p, f, s, antithetic=False)
    bnd = chip_smoke.bound(num_bytes, 0.0, unfused, ints)
    report = dict(card=card, kind=torch.cuda.get_device_name(0), shapes=dict(P=p, F=f, S=s),
                  bound=bnd, normal_halves_ms=a_ms, variants=rows,
                  ptxas={k: [ln.strip() for ln in v_.splitlines()
                             if "registers" in ln or "spill" in ln] for k, v_ in ptxas.items()})
    (OUT / "sweep_probe.json").write_text(json.dumps(report, indent=1))
    print(f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
    print(card)
    return 0 if all(r["bits_equal_plain"] or r["timing_only"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
