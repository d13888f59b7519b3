#!/usr/bin/env python3
"""Measures variants of kernel C's forward sweep (``storage_tpu_torch/csrc/
forward_kernel.cu``) on one NVIDIA GPU, on the main path's tables and paths
(N=365, S=262,144, G=100, B=9, F=3, D=3, R=3: ``chip_smoke.forward_sweep_inputs``).

Each variant is a text patch of the repository's source, built alone into
``build/forward_probe/<variant>/``:
  sweep          as it is: 1 sim per thread, each step's table staged by one
                 TMA bulk copy into a two-stage ring;
  sweep_2sims    2 sims per thread (512 sims a block: half the table reads);
  sweep_4sims    4 sims per thread;
  sweep_cpasync  the tables staged by all threads with 16-byte cp.async and a
                 block barrier, instead of TMA and the mbarrier;
  sweep_nosums   without the warp butterflies of the cross-sim sums (timing
                 only: its sums are wrong);
  sweep_dpfrac   the decision fractions computed in double for every decision
                 of every sim and step, as the one-step kernel did, instead
                 of once per block;
  sweep_powloop  each design entry from the basis' powers of the spot and of
                 every factor, zero or not, as the one-step kernel did,
                 instead of the term's nonzero powers only;
  sweep_6blocks  registers capped for 6 blocks of 256 per SM;
  sweep_smemsums each warp's sums through shared memory: the lanes write their
                 values, and one lane per value adds the 32 in the
                 butterflies' order (the same bits);
  sweep_unroll3  the decision loop unrolled by 3 (the main path's D), so that
                 the decisions' continuations are in flight together;
  sweep_gtrans   the coefficients packed as [G, B] (a grid row's B values
                 together) instead of [B, G];
and, timing only (their results are wrong):
  abl_nogather   the continuation's coefficients read at a row shared by the
                 warp, not at each sim's own rows (no bank conflicts);
  abl_nodiv      the design row standardised by a product, not a division;
  abl_nodesign   no design row: each entry its step's mean;
  abl_d1         one decision per step instead of D = 2E + 3.

For each it prints blocks per SM, shared memory per block, registers, local
(spill) bytes, SASS instructions and the mean milliseconds per sweep, and
checks the final inventory and PV, sums and summed design rows against the
unpatched kernel's (bit for bit).  The report goes to
``build/forward_probe/forward_probe.json``.

    python3 tools/torch_forward_probe.py
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
OUT = REPO / "build" / "forward_probe"
SOURCE = "forward_kernel.cu"

_SIMS = "constexpr int kSims = 1;"
_TMA = """      if (tid == 0)
        bulk_copy(ring + k * W, table + static_cast<size_t>(t) * W,
                  static_cast<uint32_t>(W * sizeof(float)), &bars[k]);"""
_CPASYNC = """      for (int i = 4 * tid; i < W; i += 4 * kThreads)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                     :: "r"(smem_addr(ring + k * W + i)),
                        "l"(table + static_cast<size_t>(t) * W + i) : "memory");"""
_WAIT = "    wait_parity(&bars[k], (t / kStages) & 1);"
_SUM_ACC = "const float x = warp_sum(valid[j] ? acc[c] : 0.0f);"
_SUM_DM = "const float x = warp_sum(valid[j] ? dm.at(b) : 0.0f);"
_FRAC = """    const float dec = has_zero ? __fmul_rn(k <= mid ? yw : yi, frac[k])
                               : __fadd_rn(yw, __fmul_rn(__fsub_rn(yi, yw), frac[D + k]));"""
_DPFRAC = """    float dec;
    if (has_zero) {
      dec = k <= mid
          ? __fmul_rn(yw, static_cast<float>(1.0 - static_cast<double>(k) / mid))
          : __fmul_rn(yi, static_cast<float>(static_cast<double>(k - mid) / mid));
    } else {
      const float f_ = static_cast<float>((k > 1 ? k - 1.0 : 0.0) / (D - 2));
      dec = __fadd_rn(yw, __fmul_rn(__fsub_rn(yi, yw), f_));
    }"""
_POWLOOP = """[&] {
          float x = 1.0f;
          if (basis.pows[b][0]) x = __fmul_rn(x, stt::ipow(sp, basis.pows[b][0]));
#pragma unroll 1
          for (int f = 0; f < V; ++f) {
            const int fp = basis.pows[b][1 + f];
            if (fp) x = __fmul_rn(x, stt::ipow(vals[(1 + f) * kSims * kThreads], fp));
          }
          return __fdiv_rn(__fsub_rn(x, mean[b]), stdv[b]);
        }()"""
_BOUNDS = "__global__ void __launch_bounds__(kThreads) forward_sweep_kernel("
_BUTTERFLIES = """#pragma unroll
        for (int c = 0; c < kUsedSums; ++c) {
          const float x = warp_sum(valid[j] ? acc[c] : 0.0f);
          if (lane == 0) red_w[c] = x;
        }
#pragma unroll
        for (int b = 0; b < dm.size(); ++b) {
          const float x = warp_sum(valid[j] ? dm.at(b) : 0.0f);
          if (lane == 0) red_w[kUsedSums + b] = x;
        }"""
_SMEMSUMS = """        float* xw = xs[warp];
#pragma unroll
        for (int c = 0; c < kUsedSums; ++c) xw[lane * kXsPitch + c] = valid[j] ? acc[c] : 0.0f;
#pragma unroll
        for (int b = 0; b < dm.size(); ++b)
          xw[lane * kXsPitch + kUsedSums + b] = valid[j] ? dm.at(b) : 0.0f;
        __syncwarp();
        if (lane < kUsedSums + dm.size()) {
          float a[16];
#pragma unroll
          for (int i = 0; i < 16; ++i) a[i] = xw[i * kXsPitch + lane] + xw[(i + 16) * kXsPitch + lane];
#pragma unroll
          for (int h = 8; h > 0; h >>= 1)
#pragma unroll
            for (int i = 0; i < h; ++i) a[i] = a[i] + a[i + h];
          red_w[lane] = a[0];
        }
        __syncwarp();"""
_XS_DECL = "  __shared__ int terms[kWide ? 1 : B][kTermWords];"
_DLOOP = "  for (int k = 0; k < D; ++k) {\n    const float dec"
_GATHER = """    float p_lo = __fmul_rn(coeffs[lo], dm.at(0));
    float p_hi = __fmul_rn(coeffs[lo + 1], dm.at(0));
#pragma unroll
    for (int b = 1; b < B; ++b) {
      p_lo = __fadd_rn(p_lo, __fmul_rn(coeffs[b * G + lo], dm.at(b)));
      p_hi = __fadd_rn(p_hi, __fmul_rn(coeffs[b * G + lo + 1], dm.at(b)));
    }"""
_DIV = "  return __fdiv_rn(__fsub_rn(x, mean), stdv);"
# The monomial mode's design entry (the expression after the design mode's).
_DENTRY = "design_entry(terms[b], vals, kSims * kThreads, mean[b], stdv[b])"

# name: patches (anchor, replacement); each anchor must occur once.
VARIANTS = {
    "sweep": [],
    "sweep_2sims": [(_SIMS, "constexpr int kSims = 2;")],
    "sweep_4sims": [(_SIMS, "constexpr int kSims = 4;")],
    "sweep_cpasync": [(_TMA, _CPASYNC), (_WAIT, "    __syncthreads();")],
    "sweep_nosums": [(_SUM_ACC, "const float x = valid[j] ? acc[c] : 0.0f;"),
                     (_SUM_DM, "const float x = valid[j] ? dm.at(b) : 0.0f;")],
    "sweep_dpfrac": [(_FRAC, _DPFRAC)],
    "sweep_powloop": [(_DENTRY, _POWLOOP)],
    "sweep_6blocks": [(_BOUNDS, _BOUNDS.replace("(kThreads)", "(kThreads, 6)"))],
    "sweep_unroll3": [(_DLOOP, "#pragma unroll 3\n" + _DLOOP)],
    "sweep_gtrans": [(_GATHER, _GATHER.replace("coeffs[lo]", "coeffs[lo * B]")
                      .replace("coeffs[lo + 1]", "coeffs[(lo + 1) * B]")
                      .replace("coeffs[b * G + lo]", "coeffs[lo * B + b]")
                      .replace("coeffs[b * G + lo + 1]", "coeffs[(lo + 1) * B + b]"))],
    "abl_nogather": [(_GATHER, _GATHER.replace("lo]", "k]").replace("lo + 1]", "k + 1]"))],
    "abl_nodiv": [(_DIV, "  return __fmul_rn(__fsub_rn(x, mean), stdv);")],
    "abl_nodesign": [(_DENTRY, "mean[b]")],
    "abl_d1": [("  const int D = 2 * E + 3;\n  const int mid = E + 1;\n\n  const float loss",
                "  const int D = 1;\n  const int mid = E + 1;\n\n  const float loss")],
    "sweep_smemsums": [(_BUTTERFLIES, _SMEMSUMS), (_XS_DECL, _XS_DECL + """
  constexpr int kXsPitch = kUsedSums + stt::kMaxB + 1;  // odd: no bank conflicts
  __shared__ float xs[kWarps][32 * kXsPitch];""")],
}

# Variants that read the coefficients as [G, B]: the probe packs them so.
TRANSPOSED = {"sweep_gtrans"}
# Variants whose results are not the kernel's (timing only).
TIMING_ONLY = {"sweep_nosums", "abl_nogather", "abl_nodiv", "abl_nodesign", "abl_d1"}

# Appended to each variant: the kernel's local (spill) bytes per thread.
_QUERY = """
extern "C" int probe_local_bytes(int B, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, sweep_kernel<false>(B));
  out[0] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(err);
}
"""


def patched_source(csrc: Path, name: str) -> str:
    text = (csrc / SOURCE).read_text()
    for anchor, repl in VARIANTS[name]:
        if text.count(anchor) != 1:
            raise RuntimeError(f"{name}: anchor not found once in {SOURCE}: {anchor[:60]!r}")
        text = text.replace(anchor, repl)
    return text + _QUERY


def build_all(csrc: Path):
    from storage_tpu_torch.ops import _build, forward_kernel

    nvcc = _build.find_nvcc()
    procs = {}
    for name in VARIANTS:
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / SOURCE).write_text(patched_source(csrc, name))
        procs[name] = subprocess.Popen(
            [nvcc, *_build.COMPILE_FLAGS, "-shared", "-I", str(csrc), "-o", str(d / "lib.so"),
             str(d / SOURCE)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, ptxas, sass = {}, {}, {}
    for name, proc in procs.items():
        ptxas[name] = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{ptxas[name][-4000:]}")
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        for fn, argtypes in _build.SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
        sass[name] = _build.sass_instructions(OUT / name / "lib.so", forward_kernel.sass_name(9))
    return libs, ptxas, sass


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=20)
    args = ap.parse_args(argv[1:])
    import torch

    if not torch.cuda.is_available():
        print("forward probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    import storage_tpu_torch as pkg
    from storage_tpu_torch.engines import lsmc as engine
    from storage_tpu_torch.ops import _build, forward_kernel

    device = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(card, flush=True)
    libs, ptxas, sass = build_all(REPO / "storage_tpu_torch" / "csrc")
    with engine.full_f32_matmul():
        st = chip_smoke.backward_step_inputs(pkg, device)
        sweep_args = chip_smoke.forward_sweep_inputs(pkg, device, st)
    del st
    n, s = sweep_args[6].shape
    g, b_dim, r, f = sweep_args[10].shape[2], sweep_args[1].shape[1], sweep_args[3].shape[1], 3
    rows, ref = [], None
    pack = forward_kernel.pack_tables

    def pack_transposed(params, mean, std, r_inv, r_min, r_max, coeffs):
        n_, b_, g_ = coeffs.shape
        return pack(params, mean, std, r_inv, r_min, r_max,
                    coeffs.transpose(1, 2).contiguous().view(n_, b_, g_))

    for name, lib in libs.items():
        forward_kernel._kernel_info.cache_clear()
        packing = pack_transposed if name in TRANSPOSED else pack
        with mock.patch.object(_build, "library", lambda lib=lib: lib), \
                mock.patch.object(forward_kernel, "pack_tables", packing):
            info = forward_kernel.kernel_info(g, b_dim, r, f, 0, device)
            local = (ctypes.c_int * 1)()
            _build.check(lib.probe_local_bytes(b_dim, local), name)
            fn = lambda: forward_kernel.forward_sweep(*sweep_args)  # noqa: E731
            got = [x.clone() for x in fn()]
            torch.cuda.synchronize()
            ms = chip_smoke.cuda_ms(fn, args.repeats)
        ref = got if ref is None else ref
        same = all(torch.equal(x, y) for x, y in zip(got, ref))
        row = dict(variant=name, timing_only=name in TIMING_ONLY,
                   blocks_per_sm=info["blocks_per_sm"], smem_bytes=info["smem_bytes"],
                   sims_per_block=info["sims_per_block"], registers=info["registers"],
                   local_bytes=local[0], sass_instructions=sass[name], ms=ms,
                   results_equal_to_unpatched=same)
        rows.append(row)
        print(f"{name:14s} blocks/SM {info['blocks_per_sm']:2d}  sims/block "
              f"{info['sims_per_block']:4d}  smem {info['smem_bytes']:6d} B  regs "
              f"{info['registers']:3d}  local {local[0]:3d} B  SASS {sass[name]:6d}  {ms:.4f} ms  "
              f"results as unpatched: {same}", flush=True)
    forward_kernel._kernel_info.cache_clear()
    bnd = chip_smoke.bound(*chip_smoke.forward_work(n, s, f, b_dim, g, r, 3, panels=False))
    report = dict(card=card, kind=torch.cuda.get_device_name(0),
                  shapes=dict(N=n, S=s, G=g, B=b_dim, F=f, R=r, D=3), bound=bnd, variants=rows,
                  ptxas={k: [ln.strip() for ln in v.splitlines() if "registers" in ln or "spill" in ln]
                         for k, v in ptxas.items()})
    (OUT / "forward_probe.json").write_text(json.dumps(report, indent=1))
    print(f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
