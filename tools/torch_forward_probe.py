#!/usr/bin/env python3
"""Measures kernel C's forward sweep (``storage_tpu_torch/csrc/forward_sweep.cuh``,
built by ``forward_kernel.cu`` for the shared route and
``forward_kernel_large.cu`` for the large route) and text-patched variants
of it on one NVIDIA GPU, at the shapes of its rows in ``PERF.md``.

Each variant is a text patch of a checkout's ``forward_sweep.cuh`` (every
anchor must occur once; a variant whose anchor that checkout lacks is
skipped and listed), built with the checkout's two translation units and
``common.cu`` into ``build/forward_probe/<checkout>/<variant>/lib.so``, the
sweep compiled for the probed basis size alone (``--basis``, 9: the other
sizes' cases are cut from the switch).  Every build starts at once.  Each
checkout's own ``ops/forward_kernel.py`` packs the tables for its library
(loaded as a package of its own, so that a parent checkout and this one run
in one process); the inputs are made once, by this checkout's package.

Cases (``--cases``; B=9, F=3, D=3, R=3; CUDA events around each wrapper
call, the mean of ``--repeats`` after a warm-up call):
  main              monomial mode, shared route, the main path's tables and
                    paths (N=365, S=262,144, G=100: ``chip_smoke.forward_sweep_inputs``);
  general           the same on bunched rows (the general-grid mode);
  design            design mode, one 365-step launch on the main path's design;
  design_general    design mode on padded rows (10 repeats of the last node);
  large             monomial mode, large route, G=4,096, N=365, S=262,144 on
                    ``chip_smoke.random_sweep``'s tables (seed 30);
  general_large     the same on bunched rows padded by 3 repeats, ascending
                    at every step (``chip_smoke.ascending_rows``);
  design_large      design mode, large route: one 32-step launch (the
                    generic path's chunk) at seed 30;
  monomial_large32  the monomial mode on design_large's 32 steps (the same
                    tables and paths);
  design_large365   the design mode over large's 365 steps in one launch;
  design_large_chunks  the same in 12 launches of 32 steps
                    (``forward_sweep_generic``'s chunks).

Variants (``--variants``; "sweep" is the checkout as it is):
  sweep, sweep_2sims, sweep_4sims (sims a thread), sweep_cpasync (tables by
  16-byte cp.async, not TMA), sweep_dpfrac (decision fractions in double a
  decision), sweep_powloop (every basis power, zero or not), sweep_6blocks
  (registers capped for 6 blocks/SM, every route), sweep_unroll3 (the
  decision loop unrolled by 3), sweep_smemsums (warp sums through shared
  memory, the butterflies' order), sweep_gtrans (the shared route's
  coefficients packed [G, B]);
  cap_general5      the general-grid mode's shared route capped for 5 blocks/SM;
  cap_large6        the large route capped for 6 blocks/SM;
  cap_large5        the large route capped for 5 blocks/SM;
  coef_rowwise      the large route's rows lo and lo + 1 loaded and summed one
                    after the other (the same bits);
  search_binary     the general-grid mode's binary search of the whole row
                    (``dp_common.cuh`` general_weights) in place of the
                    bucket index (the same bits);
  coef_scalar       the large route's coefficient rows read by 2B scalar
                    loads from [G, Bp] in place of 16-byte loads (the same bits);
and, timing only (their results are wrong):
  sweep_nosums      no warp butterflies;
  abl_uniform_search  the general-grid mode's search replaced by the evenly
                    spaced position arithmetic;
  abl_fixed_row     the large route's coefficient reads at row 0 for every
                    decision (no scattered lines);
  abl_nogather, abl_nodiv, abl_nodesign, abl_d1 (the shared route's
  coefficients at a row shared by the warp; the design row standardised by
  a product; no design row; one decision a step).

The unpatched sweep runs at every case; each variant at the cases it
bears on (``VARIANT_CASES``; the shared route's older variants at main).
For each (checkout, variant, case) it prints blocks per SM, shared memory,
registers, spill bytes, SASS instructions of the case's kernel, ms, and the
SHA-256 digest of every output (final inventory and PV, sums, summed design
rows, the four per-sim panels), and whether they are the unpatched
kernel's.  ``--repo`` (repeatable) names the checkouts, this one by
default; with ``--turns`` and two checkouts A B the unpatched sweeps run A,
B, B, A.  ``--general-index`` also times ``general_tail`` (the wrapper's
bucket index) alone, by events and by its own device time under
torch.profiler, beside one batched ``torch.searchsorted`` timed both ways; ``--smoke-digests`` prints each checkout's SHA-256
digests of ``chip_smoke.c_digest_cases`` (the parent's go into
``chip_smoke.C_DIGESTS``).  The report goes to
``build/forward_probe/forward_probe.json``.

    python3 tools/torch_forward_probe.py --cases main large --variants sweep abl_fixed_row
    git archive HEAD | tar -x -C build/parent
    python3 tools/torch_forward_probe.py --repo build/parent --repo . --turns --variants sweep
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import importlib
import json
import re
import subprocess
import sys
import threading
import types
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "build" / "forward_probe"
SOURCE = "forward_sweep.cuh"
UNITS = ("forward_kernel.cu", "forward_kernel_large.cu", "common.cu")

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
_GATHER = """      p_lo = __fmul_rn(coeffs[lo], dm.at(0));
      p_hi = __fmul_rn(coeffs[lo + 1], dm.at(0));
#pragma unroll
      for (int b = 1; b < B; ++b) {
        p_lo = __fadd_rn(p_lo, __fmul_rn(coeffs[b * G + lo], dm.at(b)));
        p_hi = __fadd_rn(p_hi, __fmul_rn(coeffs[b * G + lo + 1], dm.at(b)));
      }"""
_DIV = "  return __fdiv_rn(__fsub_rn(x, mean), stdv);"
# The monomial mode's design entry (the expression after the design mode's).
_DENTRY = "design_entry(terms[b], vals, kSims * kThreads, mean[b], stdv[b])"
# The general-grid mode's search: the bucket index (and, in a checkout
# before it, the binary search of the whole row).
_INDEXED = "      indexed_weights<kLarge>(row, inv_after, &lo, &w);"
_BINARY = "      stt_dp::general_weights(grid_next, G, inv_after, &lo, &w);"
_UNIFORM = """      {
        const float pos = __fmul_rn(
            __fsub_rn(clampf(inv_after, grid_lo, grid_hi), grid_lo), inv_delta);
        lo = min(max(static_cast<int>(floorf(pos)), 0), G - 2);
        w = clampf(__fsub_rn(pos, static_cast<float>(lo)), 0.0f, 1.0f);
      }"""
# The large route's coefficient rows: 16-byte loads of [G, Bp] (and, in a
# checkout before them, 2B scalar loads of [G, B]).
_VECTOR = "      dot_rows_large(coef_t + static_cast<size_t>(lo) * padded_basis(B), dm, &p_lo, &p_hi);"
_SCALAR_OLD = "      const float* c = coef_t + static_cast<size_t>(lo) * B;"
_SCALAR = """      {
        const float* c = coef_t + static_cast<size_t>(lo) * padded_basis(B);
        const int bp = padded_basis(B);
        p_lo = __fmul_rn(__ldg(c), dm.at(0));
        p_hi = __fmul_rn(__ldg(c + bp), dm.at(0));
#pragma unroll
        for (int b = 1; b < B; ++b) {
          p_lo = __fadd_rn(p_lo, __fmul_rn(__ldg(c + b), dm.at(b)));
          p_hi = __fadd_rn(p_hi, __fmul_rn(__ldg(c + bp + b), dm.at(b)));
        }
      }"""


# The large route's dot products: both rows loaded, then summed together
# (and, as a variant, one row loaded and summed before the other).
_PAIR = """    float lo[B], hi[B];
    load_coef_row<B>(c, lo);
    load_coef_row<B>(c + padded_basis(B), hi);
    float a = __fmul_rn(lo[0], dm.at(0));
    float b = __fmul_rn(hi[0], dm.at(0));
#pragma unroll
    for (int k = 1; k < B; ++k) {
      a = __fadd_rn(a, __fmul_rn(lo[k], dm.at(k)));
      b = __fadd_rn(b, __fmul_rn(hi[k], dm.at(k)));
    }"""
_ROWWISE = """    float r[B];
    load_coef_row<B>(c, r);
    float a = __fmul_rn(r[0], dm.at(0));
#pragma unroll
    for (int k = 1; k < B; ++k) a = __fadd_rn(a, __fmul_rn(r[k], dm.at(k)));
    load_coef_row<B>(c + padded_basis(B), r);
    float b = __fmul_rn(r[0], dm.at(0));
#pragma unroll
    for (int k = 1; k < B; ++k) b = __fadd_rn(b, __fmul_rn(r[k], dm.at(k)));"""


def _cap(expr: str):
    return [(_BOUNDS, _BOUNDS.replace("(kThreads)", f"(kThreads, {expr})"))]


# name: patches (anchor, replacement); each anchor must occur once.  A list
# of alternatives (for checkouts before and after a redesign) takes the
# first whose anchors all occur.
VARIANTS = {
    "sweep": [[]],
    "sweep_2sims": [[(_SIMS, "constexpr int kSims = 2;")]],
    "sweep_4sims": [[(_SIMS, "constexpr int kSims = 4;")]],
    "sweep_cpasync": [[(_TMA, _CPASYNC), (_WAIT, "    __syncthreads();")]],
    "sweep_nosums": [[(_SUM_ACC, "const float x = valid[j] ? acc[c] : 0.0f;"),
                      (_SUM_DM, "const float x = valid[j] ? dm.at(b) : 0.0f;")]],
    "sweep_dpfrac": [[(_FRAC, _DPFRAC)]],
    "sweep_powloop": [[(_DENTRY, _POWLOOP)]],
    "sweep_6blocks": [_cap("6")],
    "sweep_unroll3": [[(_DLOOP, "#pragma unroll 3\n" + _DLOOP)]],
    "sweep_gtrans": [[(_GATHER, _GATHER.replace("coeffs[lo]", "coeffs[lo * B]")
                       .replace("coeffs[lo + 1]", "coeffs[(lo + 1) * B]")
                       .replace("coeffs[b * G + lo]", "coeffs[lo * B + b]")
                       .replace("coeffs[b * G + lo + 1]", "coeffs[(lo + 1) * B + b]"))]],
    "sweep_smemsums": [[(_BUTTERFLIES, _SMEMSUMS), (_XS_DECL, _XS_DECL + """
  constexpr int kXsPitch = kUsedSums + stt::kMaxB + 1;  // odd: no bank conflicts
  __shared__ float xs[kWarps][32 * kXsPitch];""")]],
    "cap_general5": [_cap("kGeneral && !kLarge ? 5 : 1")],
    "cap_large6": [_cap("kLarge ? 6 : 1")],
    "cap_large5": [_cap("kLarge ? 5 : 1")],
    "coef_rowwise": [[(_PAIR, _ROWWISE)]],
    "search_binary": [[(_INDEXED, "      stt_dp::general_weights(row.grid, G, inv_after, &lo, &w);")]],
    "coef_scalar": [[(_VECTOR, _SCALAR)]],
    "abl_uniform_search": [[(_INDEXED, _UNIFORM)], [(_BINARY, _UNIFORM)]],
    "abl_fixed_row": [[(_VECTOR, _VECTOR.replace(" + static_cast<size_t>(lo) * padded_basis(B)",
                                                  ""))],
                      [(_SCALAR_OLD, "      const float* c = coef_t;")]],
    "abl_nogather": [[(_GATHER, _GATHER.replace("lo]", "k]").replace("lo + 1]", "k + 1]"))]],
    "abl_nodiv": [[(_DIV, "  return __fmul_rn(__fsub_rn(x, mean), stdv);")]],
    "abl_nodesign": [[(_DENTRY, "mean[b]")]],
    "abl_d1": [[("  const int D = 2 * E + 3;\n  const int mid = E + 1;\n\n  const float loss",
                 "  const int D = 1;\n  const int mid = E + 1;\n\n  const float loss")]],
}

# Variants that read the shared route's coefficients as [G, B]: the probe
# packs them so.
TRANSPOSED = {"sweep_gtrans"}
# Variants whose results are not the kernel's (timing only).
TIMING_ONLY = {"sweep_nosums", "abl_uniform_search", "abl_fixed_row", "abl_nogather",
               "abl_nodiv", "abl_nodesign", "abl_d1"}
CASES = ("main", "general", "design", "design_general", "large", "general_large",
         "design_large", "monomial_large32", "design_large365",
         "design_large_chunks")
_GENERAL = ("general", "design_general", "general_large")
_LARGE = ("large", "general_large", "design_large",
          "monomial_large32")
# The cases each variant is timed at (the unpatched sweep at every case; the
# shared route's older variants at the main path).
VARIANT_CASES = {"cap_general5": ("general", "design_general"), "cap_large6": _LARGE,
                 "cap_large5": _LARGE, "coef_rowwise": _LARGE,
                 "sweep_unroll3": ("main", *_GENERAL, *_LARGE),
                 "search_binary": _GENERAL, "coef_scalar": _LARGE,
                 "abl_uniform_search": _GENERAL, "abl_fixed_row": _LARGE}

# Appended to each unit: the sweep's local (spill) bytes per thread (the
# kernel compiled for B; ``pick_sweep`` takes the factor count too in a
# checkout with the monomial mode's wide route, given as 0 here).
_QUERY = """
extern "C" int probe_local_bytes{suffix}(int B, int design, int general, int* out) {{
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(
      &attr, design ? pick_sweep<true, {large}>({args}) : pick_sweep<false, {large}>({args}));
  out[0] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(err);
}}
"""


def patched_source(text: str, name: str, bdims) -> str:
    """The checkout's forward_sweep.cuh with variant ``name`` applied, the
    switch of compiled basis sizes cut to ``bdims``; None where no
    alternative's anchors all occur once."""
    for patches in VARIANTS[name]:
        if all(text.count(anchor) == 1 for anchor, _ in patches):
            for anchor, repl in patches:
                text = text.replace(anchor, repl)
            break
    else:
        return None
    keep = {str(b) for b in bdims}
    return re.sub(r"    case (\d+): return forward_sweep_kernel<\1, [^\n]*\n",
                  lambda m: m.group(0) if m.group(1) in keep else "", text)


def build_all(checkouts, names, bdims):
    """Builds every (checkout, variant) at once; returns {(tag, name): lib dir}
    and the variants each checkout lacks."""
    from storage_tpu_torch.ops import _build

    nvcc = _build.find_nvcc()
    procs, skipped = {}, {}
    for tag, root in checkouts.items():
        csrc = root / "storage_tpu_torch" / "csrc"
        text = (csrc / SOURCE).read_text()
        for name in names:
            src = patched_source(text, name, bdims)
            if src is None:
                skipped.setdefault(tag, []).append(name)
                continue
            d = OUT / tag / name
            d.mkdir(parents=True, exist_ok=True)
            (d / SOURCE).write_text(src)
            units = []
            for unit in UNITS:
                body = (csrc / unit).read_text()
                if unit != "common.cu":
                    large = "true" if unit == "forward_kernel_large.cu" else "false"
                    args = ("B, 0, general" if "pick_sweep(int B, int F, bool general)" in text
                            else "B, general")
                    body += _QUERY.format(suffix="_large" if large == "true" else "", large=large,
                                          args=args)
                (d / unit).write_text(body)
                units.append(str(d / unit))
            procs[(tag, name)] = (d, subprocess.Popen(
                [nvcc, *_build.COMPILE_FLAGS, "-shared", "-I", str(d), "-I", str(csrc), "-o",
                 str(d / "lib.so"), *units], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    built, logs = {}, {}
    for key, (d, proc) in procs.items():
        logs[key] = proc.communicate()[0]
        if proc.returncode != 0:
            print(f"nvcc failed on {key}; skipped:\n{logs[key][-4000:]}", flush=True)
            skipped.setdefault(key[0], []).append(f"{key[1]} (build failed)")
            continue
        built[key] = d
    return built, logs, skipped


def load_library(d: Path, signatures):
    lib = ctypes.CDLL(str(d / "lib.so"))
    for fn, argtypes in signatures.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
    for fn in ("probe_local_bytes", "probe_local_bytes_large"):
        getattr(lib, fn).argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def load_checkout(root: Path, alias: str):
    """The checkout's ``ops/forward_kernel.py`` as module ``alias``.ops.forward_kernel,
    apart from this checkout's package (no package ``__init__`` runs)."""
    pkg = root.resolve() / "storage_tpu_torch"
    for name, path in ((alias, pkg), (f"{alias}.ops", pkg / "ops")):
        module = types.ModuleType(name)
        module.__path__ = [str(path)]
        sys.modules[name] = module
    return importlib.import_module(f"{alias}.ops.forward_kernel")


@functools.lru_cache(maxsize=None)
def sass_count(lib: Path, kernel: str) -> int:
    from storage_tpu_torch.ops import _build

    return _build.sass_instructions(lib, kernel)


def event_ms(fn, repeats: int) -> float:
    """Mean device ms of ``fn`` by CUDA events around each call, after a
    warm-up call."""
    import torch

    fn()
    spans = []
    for _ in range(repeats):
        start, end = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        start.record()
        fn()
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in spans) / repeats


def make_cases(chip_smoke, pkg, device, names):
    """{case: (mode, args, design, grid, chunked)} from ``chip_smoke``'s input builders."""
    import torch

    from storage_tpu_torch.basis import design_columns
    from storage_tpu_torch.engines import lsmc as engine

    cases = {}
    want_main = {"main", "general", "design", "design_general"} & set(names)
    if want_main:
        with engine.full_f32_matmul():
            st = chip_smoke.backward_step_inputs(pkg, device)
            args = chip_smoke.forward_sweep_inputs(pkg, device, st)
        del st
        g = args[10].shape[2]
        design = torch.stack(design_columns(args[11], args[6], args[7]), dim=1)
        rows = chip_smoke.bunched_rows(args[0], g, g)
        padded = chip_smoke.bunched_rows(args[0], g, g - 10)
        cases.update(main=("monomial", args, None, None, False),
                     general=("monomial", args, None, rows, False),
                     design=("design", args, design, None, False),
                     design_general=("design", args, design, padded, False))
    g, s = chip_smoke.GRID_BIG, chip_smoke.NUM_SIMS
    if {"large", "general_large", "design_large365", "design_large_chunks"} & set(names):
        args = chip_smoke.random_sweep(device, chip_smoke.NUM_STEPS, s, g, 3, seed=30)
        cases.update(large=("monomial", args, None, None, False),
                     general_large=("monomial", args, None, chip_smoke.ascending_rows(args[0], g),
                                    False))
        if {"design_large365", "design_large_chunks"} & set(names):
            design = torch.stack(design_columns(args[11], args[6], args[7]), dim=1)
            cases.update(design_large365=("design", args, design, None, False),
                         design_large_chunks=("design", args, design, None, True))
    if {"design_large", "monomial_large32"} & set(names):
        args = chip_smoke.random_sweep(device, 32, s, g, 3, seed=30)
        design = torch.stack(design_columns(args[11], args[6], args[7]), dim=1)
        cases.update(design_large=("design", args, design, None, False),
                     monomial_large32=("monomial", args, None, None, False))
    return {k: v for k, v in cases.items() if k in names}


def sweep_call(fk, case, panels=None):
    """The wrapper call of ``case`` through the checkout module ``fk``."""
    mode, args, design, grid, chunked = case
    if mode == "monomial":
        return lambda: fk.forward_sweep(*args, panels=panels, grid=grid)
    dargs = (*args[:7], design, *args[8:11], *args[12:])
    if not chunked:
        return lambda: fk.forward_sweep_design(*dargs, panels=panels, grid=grid)
    n = args[6].shape[0]

    def chunks():
        inv, pv = dargs[8], dargs[9]
        out = []
        for t0 in range(0, n, fk.DESIGN_CHUNK):
            t1 = min(t0 + fk.DESIGN_CHUNK, n)
            cut = [x[t0:t1] for x in dargs[:8]] + [inv, pv] + [dargs[10][t0:t1]]
            inv, pv, sums, xbar = fk.forward_sweep_design(
                *cut, *dargs[11:], grid=None if grid is None else grid[t0:t1])
            out += [sums, xbar]
        return (inv, pv, *out)
    return chunks


def general_index_ms(fk, cases, repeats):
    """The wrapper's bucket index (``general_tail``) alone on each general
    case's rows, beside one batched ``torch.searchsorted`` of the rows'
    interior nodes against their bucket edges (``chip_smoke.bucket_edges``):
    {case: ms by CUDA events around each call (the host's rate where a
    call's Python outlasts its kernel), and each one's own device time a
    call (``chip_smoke.kernel_busy_ms`` over ``repeats`` calls)}."""
    import torch

    import chip_smoke

    if not hasattr(fk, "general_tail"):
        return {}
    out = {}
    for name, case in cases.items():
        grid = case[3]
        if grid is None:
            continue
        nodes, edges = chip_smoke.bucket_edges(grid)
        kernel = lambda grid=grid: fk.general_tail(grid)  # noqa: E731
        library = lambda: torch.searchsorted(nodes, edges)  # noqa: E731
        own, n = chip_smoke.kernel_busy_ms(lambda: [kernel() for _ in range(repeats)],
                                           "general_tail")
        lib_own, lib_n = chip_smoke.kernel_busy_ms(lambda: [library() for _ in range(repeats)],
                                                   "searchsorted")
        out[name] = dict(ms=event_ms(kernel, repeats), own_ms=own / max(n, 1), launches=n,
                         library_ms=event_ms(library, repeats),
                         library_own_ms=lib_own / max(lib_n, 1), library_launches=lib_n,
                         rows=tuple(grid.shape))
        del nodes, edges
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", action="append", type=Path,
                    help="a checkout to probe (repeatable; default this one)")
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS))
    ap.add_argument("--cases", nargs="+", default=list(CASES), choices=list(CASES))
    ap.add_argument("--basis", nargs="+", type=int, default=[9])
    ap.add_argument("--turns", action="store_true",
                    help="with two checkouts A B, time the unpatched sweeps A, B, B, A")
    ap.add_argument("--general-index", action="store_true")
    ap.add_argument("--smoke-digests", action="store_true",
                    help="print each checkout's digests of chip_smoke.c_digest_cases")
    ap.add_argument("--repeats", type=int, default=10)
    args = ap.parse_args(argv[1:])
    import torch

    if not torch.cuda.is_available():
        print("forward probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    import storage_tpu_torch as pkg
    from storage_tpu_torch.ops import _build, forward_kernel

    device = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(card, flush=True)
    roots = args.repo or [REPO]
    checkouts = {f"c{i}_{root.resolve().name}": root.resolve() for i, root in enumerate(roots)}
    # This checkout's whole library (the inputs' backward pass) builds
    # beside the variants.
    library = threading.Thread(target=_build.build)
    library.start()
    built, logs, skipped = build_all(checkouts, args.variants, args.basis)
    library.join()
    for tag, names in skipped.items():
        print(f"{tag}: skipped (anchor not in its {SOURCE}): {', '.join(names)}", flush=True)
    modules = {tag: load_checkout(root, f"probe_{i}")
               for i, (tag, root) in enumerate(checkouts.items())}
    cases = make_cases(chip_smoke, pkg, device, args.cases)
    tags = list(checkouts)
    order = [(tag, name) for tag in tags for name in args.variants if (tag, name) in built]
    if args.turns and len(tags) == 2:
        a, b = tags
        order = [(a, "sweep"), (b, "sweep"), (b, "sweep"), (a, "sweep")] + [
            key for key in order if key[1] != "sweep"]
    rows, ref = [], {}
    for turn, (tag, name) in enumerate(order):
        fk = modules[tag]
        lib = load_library(built[(tag, name)], _build.SIGNATURES)
        pack = fk.pack_tables

        def pack_transposed(params, mean, std, r_inv, r_min, r_max, coeffs, grid=None,
                            large=False):
            n_, b_, g_ = coeffs.shape
            return pack(params, mean, std, r_inv, r_min, r_max,
                        coeffs.transpose(1, 2).contiguous().view(n_, b_, g_), grid, large)

        fk._kernel_info.cache_clear()
        with mock.patch.object(fk._build, "library", lambda lib=lib: lib), \
                mock.patch.object(fk, "pack_tables",
                                  pack_transposed if name in TRANSPOSED else pack):
            for case_name, case in cases.items():
                if case_name not in VARIANT_CASES.get(name, CASES if name == "sweep" else ("main",)):
                    continue
                mode, cargs, _, grid, _ = case
                n, s = cargs[6].shape
                g = cargs[10].shape[2]
                b_dim = cargs[1].shape[1]
                route = fk.sweep_route(g, b_dim, cargs[3].shape[1], b_dim if mode == "design"
                                       else 3, 0, fk._build.smem_limit(device),
                                       mode == "design", grid is not None)
                large = route == "large"
                info = fk.kernel_info(g, b_dim, cargs[3].shape[1], 0 if mode == "design" else 3,
                                      0, device, design=mode == "design",
                                      general=grid is not None, large=large)
                local = (ctypes.c_int * 1)()
                query = lib.probe_local_bytes_large if large else lib.probe_local_bytes
                _build.check(query(b_dim, int(mode == "design"), int(grid is not None), local),
                             name)
                panels = [torch.empty((n, s), device=device) for _ in range(4)]
                out = sweep_call(fk, case, panels if not case[4] else None)()
                got = chip_smoke.sha256_of([*out, *(panels if not case[4] else [])])
                del out, panels
                ms = event_ms(sweep_call(fk, case), args.repeats)
                sass = sass_count(built[(tag, name)] / "lib.so", forward_kernel.sass_name(
                    b_dim, mode == "design", grid is not None, large))
                key = (tag, case_name)
                same = ref.setdefault(key, got) == got if name == "sweep" else (
                    ref.get(key) == got)
                row = dict(turn=turn, checkout=tag, variant=name, case=case_name, route=route,
                           timing_only=name in TIMING_ONLY, steps=n, sims=s, grid=g,
                           blocks_per_sm=info["blocks_per_sm"], smem_bytes=info["smem_bytes"],
                           registers=info["registers"], local_bytes=local[0],
                           sass_instructions=sass, ms=ms, digest=got,
                           results_equal_to_unpatched=same)
                rows.append(row)
                print(f"{tag:16s} {name:18s} {case_name:19s} {route:6s} blocks/SM "
                      f"{info['blocks_per_sm']:2d} smem {info['smem_bytes']:6d} B regs "
                      f"{info['registers']:3d} local {local[0]:3d} B SASS {sass:6d} "
                      f"{ms:9.4f} ms  {got[:16]}  as unpatched: {same}", flush=True)
                torch.cuda.empty_cache()
            if args.general_index and name == "sweep":
                for case_name, r in general_index_ms(fk, cases, args.repeats).items():
                    rows.append(dict(turn=turn, checkout=tag, variant="general_tail",
                                     case=case_name, **r))
                    print(f"{tag:16s} general_tail       {case_name:19s} {r['rows']}: events "
                          f"{r['ms']:.4f} ms, own {r['own_ms']:.5f} ms ({r['launches']} "
                          f"launches); torch.searchsorted events {r['library_ms']:.4f} ms, own "
                          f"{r['library_own_ms']:.5f} ms ({r['library_launches']} launches)",
                          flush=True)
    smoke = {}
    if args.smoke_digests:
        digest_cases = chip_smoke.c_digest_cases(device)
        for tag in tags:
            fk = modules[tag]
            lib = load_library(built[(tag, "sweep")], _build.SIGNATURES)
            fk._kernel_info.cache_clear()
            with mock.patch.object(fk._build, "library", lambda lib=lib: lib):
                smoke[tag] = {name: chip_smoke.sha256_of(chip_smoke.c_outputs(fk, case))
                              for name, case in digest_cases.items()}
            print(f"{tag} C_DIGESTS = {json.dumps(smoke[tag], indent=4)}", flush=True)
        if len(tags) == 2:
            a, b = (smoke[t] for t in tags)
            print(f"smoke digests the same in both checkouts: "
                  f"{sum(a[k] == b[k] for k in a)} of {len(a)}; differ: "
                  f"{[k for k in a if a[k] != b[k]]}", flush=True)
        del digest_cases
    for tag in tags:
        modules[tag]._kernel_info.cache_clear()
    digests = {}
    for row in rows:
        if row["variant"] == "sweep":
            digests.setdefault(row["case"], {}).setdefault(row["checkout"], set()).add(
                row["digest"])
    agree = {case: len({d for ds in by.values() for d in ds}) == 1 for case, by in digests.items()}
    report = dict(card=card, kind=torch.cuda.get_device_name(0), checkouts=
                  {k: str(v) for k, v in checkouts.items()}, skipped=skipped, rows=rows,
                  digests_agree_across_checkouts=agree, smoke_digests=smoke,
                  ptxas={f"{k[0]}/{k[1]}": [ln.strip() for ln in v.splitlines()
                                            if "registers" in ln or "spill" in ln]
                         for k, v in logs.items()})
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "forward_probe.json").write_text(json.dumps(report, indent=1))
    print(f"unpatched digests the same across checkouts: {agree}")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
