#!/usr/bin/env python3
"""The two DP kernels of ``storage_tpu_torch`` (``csrc/intrinsic_kernel.cu``,
``csrc/tree_kernel.cu``) measured on one NVIDIA GPU, for the package of any
checkout: ``--repo`` names the directory that holds the ``storage_tpu_torch``
to import (this repository by default), so one command can run a ``git
archive`` of another commit and this one in turns.  The cases are
``chip_smoke.py``'s (this repository's copy), built with the imported
package.

It prints and writes to ``--out`` (``build/dp_probe/<label>.json``):

- **digests**: the SHA-256 of every output tensor of the DP kernels, f32
  and f64: the tree's values [N+1, M, G] at T1, T2 (both oracle
  facilities), T3, T4, T2 cubic, T2 on a custom grid and T3 at E=1; the
  intrinsic DP's inventory, volume, fuel, loss and PV rows and final
  inventory (through ``engines.intrinsic.intrinsic_core``) at the headline
  (N=365, G=100), G=1,000, the 2F facility cubic, on a custom grid and at
  E=1, and the 40-day facility that must end empty at E=1 and E=2;
- **the intrinsic DP's split**: CUDA-event ms a DP (20 calls) of the kernel
  as it is (and its own device time by torch.profiler) and of two
  timing-only variants compiled from the checkout's
  ``intrinsic_kernel.cu`` with a text patch (``backward_only``: the forward
  walk skipped; ``empty``: the kernel returns at once, the launch and the
  wrapper alone), at the headline and at G=1,000, f32 and f64: backward =
  backward_only − empty, forward = as is − backward_only;
- **the tree's launch gaps**: at T3 and T4, f32 and f64, the valuation's ms
  (``engines.tree.tree_core``, CUDA events over 10) beside the tree kernels'
  own device time in one valuation (torch.profiler, every kernel whose name
  holds ``tree``) and their launch count;
- where the package has it, the chain floor's timing kernels
  (``ops.tree_kernel.chain_step_ns``: block, cluster and grid links).

``--compare A.json B.json`` prints, case by case, whether two reports'
digests agree, and exits 1 if any differs.

    mkdir -p build/parent && git archive <parent> storage_tpu_torch | tar -x -C build/parent
    python3 tools/torch_dp_probe.py --repo build/parent --label parent
    python3 tools/torch_dp_probe.py --label change
    python3 tools/torch_dp_probe.py --compare build/dp_probe/parent.json build/dp_probe/change.json
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import re
import subprocess
import sys
import types
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "build" / "dp_probe"
# The forward walk's marker in intrinsic_kernel.cu: the statement after it
# starts the walk.
WALK_MARKER = "// Forward walk of the inventory."


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def patched_intrinsic(text: str, variant: str) -> str:
    """``intrinsic_kernel.cu`` as a timing-only variant of the split."""
    if variant == "as_is":
        return text
    if variant == "empty":
        new, count = re.subn(r"(intrinsic_dp_kernel\(Problem<T> p[^)]*\) \{\n)",
                             r"\1  if (p.N > 0) return;\n", text)
    else:  # backward_only
        new, count = re.subn(re.escape(WALK_MARKER) + r"\n(\s*)", WALK_MARKER + r"\n\1if (p.N < 0) ",
                             text)
    if count != 1:
        raise RuntimeError(f"{variant}: the anchor is not in intrinsic_kernel.cu once")
    return new


def _l2_prefetch(tables: str) -> str:
    """Source that prefetches each (pointer, bytes) of ``tables`` into L2,
    128-byte lines strided over the grid's threads."""
    return ("  {\n    const size_t stride = 128 * static_cast<size_t>(blockDim.x) * gridDim.x;\n"
            "    const size_t first = 128 * (static_cast<size_t>(blockIdx.x) * blockDim.x"
            " + threadIdx.x);\n"
            f"    const struct {{ const void* ptr; size_t bytes; }} tabs[] = {{{tables}}};\n"
            "    for (const auto& tab : tabs)\n"
            "      for (size_t off = first; off < tab.bytes; off += stride)\n"
            "        asm volatile(\"prefetch.global.L2 [%0];\" ::\"l\"("
            "static_cast<const char*>(tab.ptr) + off));\n  }\n")


_INTRINSIC_TABLES = ("{p.steps, sizeof(T) * 11 * p.N}, {p.r_inv, sizeof(T) * p.R * p.N}, "
                     "{p.r_min, sizeof(T) * p.R * p.N}, {p.r_max, sizeof(T) * p.R * p.N}, "
                     "{p.grids, sizeof(T) * p.G * (p.N + 1)}")
_TREE_TABLES = ("{p.steps, sizeof(T) * 11 * p.N}, {p.r_inv, sizeof(T) * p.R * p.N}, "
                "{p.r_min, sizeof(T) * p.R * p.N}, {p.r_max, sizeof(T) * p.R * p.N}, "
                "{p.grids, sizeof(T) * p.G * (p.N + 1)}, {p.spot, sizeof(T) * p.M * (p.N + 1)}, "
                "{p.band, sizeof(T) * p.M * p.W * p.N}, {p.start, sizeof(int64_t) * p.M * p.N}")
_KERNEL_START = "  T* base = reinterpret_cast<T*>(smem_raw);\n  backward<kMode>(p, l, base);"
_TREE_START = "  // V_N of the own rows.\n"
# The design's variants, each a text patch of one source (timing_only: the
# answer may differ).
DESIGN_VARIANTS = {
    "intrinsic/as_is": ("intrinsic_kernel.cu", [], False),
    "intrinsic/l2_prefetch": ("intrinsic_kernel.cu", [(_KERNEL_START, _KERNEL_START.replace(
        "  backward<", _l2_prefetch(_INTRINSIC_TABLES) + "  backward<"))], False),
    "intrinsic/table_from_memory": ("intrinsic_kernel.cu", [(
        "  p.stage_table = sizeof(T) * with_table <= static_cast<size_t>(optin);",
        "  p.stage_table = 0;")], False),
    "intrinsic/one_lane_walk": ("intrinsic_kernel.cu", [
        ("  p.walk_lanes = pow2_at_least(D);", "  p.walk_lanes = 1;")], False),
    "tree/as_is": ("tree_kernel.cu", [], False),
    "tree/l2_prefetch": ("tree_kernel.cu", [(_TREE_START, _l2_prefetch(_TREE_TABLES) + _TREE_START)],
                         False),
    # Every band row read from the CTA's own V_{t+1} (timing only): what the
    # reads of other CTAs' shared memory cost.
    "tree/local_rows": ("tree_kernel.cu", [(
        "        for (int j = 0; j < 8; ++j) x[j] = w0 + j < W ? band_rows[w0 + j][g] : T(0);",
        "        for (int j = 0; j < 8; ++j)\n"
        "          x[j] = w0 + j < W ? vbuf[(nxt * rows + (w0 + j) % rows) * G + g] : T(0);")],
        True),
}


def apply_patches(name: str, file: str, text: str, patches) -> str:
    for anchor, repl in patches:
        if text.count(anchor) != 1:
            raise RuntimeError(f"{name}: the anchor is not in {file} once: {anchor[:50]!r}")
        text = text.replace(anchor, repl)
    return text


def build_variants(csrc: Path, signatures: dict, nvcc: str, flags, variants: dict) -> dict:
    """Libraries of patched sources, one a variant, compiled together:
    ``variants`` maps a name to (source file, a function of its text), and
    a variant whose file name is "dp_common.cuh/<file>" patches that header
    (found beside the source before ``csrc``) and compiles ``<file>``."""
    procs = {}
    for name, (file, patch) in variants.items():
        d = OUT / "variants" / name.replace("/", "_")
        d.mkdir(parents=True, exist_ok=True)
        header, _, file = file.rpartition("/")
        if header:
            (d / header).write_text(patch((csrc / header).read_text()))
            (d / file).write_text((csrc / file).read_text())
        else:
            (d / file).write_text(patch((csrc / file).read_text()))
        procs[name] = subprocess.Popen(
            [nvcc, *flags, "-shared", "-I", str(csrc), "-o", str(d / "lib.so"), str(d / file)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-4000:]}")
        path = OUT / "variants" / name.replace("/", "_") / "lib.so"
        lib = ctypes.CDLL(str(path))
        ns = types.SimpleNamespace(path=path)
        for fn_name, argtypes in signatures.items():
            fn = getattr(lib, fn_name, None)
            if fn is not None:
                fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
                setattr(ns, fn_name, fn)
        libs[name] = ns
    return libs


def design_variants(cs, pkg, device, card) -> list:
    """The design's variants (``DESIGN_VARIANTS``) at the headline (the
    intrinsic DP) and T3 (the tree), f32: the kernel's own device time
    (torch.profiler, the median of three calls), whether its outputs are
    the repository kernel's bits, and its SASS size."""
    import torch

    from storage_tpu_torch.engines import intrinsic as ie
    from storage_tpu_torch.engines import tree as te
    from storage_tpu_torch.ops import _build

    libs = build_variants(_build.CSRC, _build.SIGNATURES, _build.find_nvcc(),
                          _build.COMPILE_FLAGS,
                          {k: (f, lambda text, k=k, f=f, p=p: apply_patches(k, f, text, p))
                           for k, (f, p, _) in DESIGN_VARIANTS.items()})
    inputs, arrays = cs.intrinsic_case(pkg, device, "headline", "linspace", cs.NUM_GRID)
    arrays = arrays[torch.float32]
    t3 = cs.headline_tree_case(pkg, 5.5)
    t_inputs, tables, _ = cs.tree_tables(pkg, device, t3)
    tables = tables[torch.float32]
    tfn = inputs.compiled.terminal_value
    runs = {"intrinsic": (lambda: ie.intrinsic_core(arrays, 100.0, 0, tfn, False),
                          "intrinsic_dp_kernel", "intrinsic_dp_kernel"),
            "tree": (lambda: te.tree_core(*tables, 0, t_inputs.compiled.terminal_value, False),
                     "tree_", "tree_cluster_kernel")}
    want = {k: run() for k, (run, _, _) in runs.items()}
    rows = []
    real_library = _build.library
    try:
        for name, lib in libs.items():
            kind = name.split("/")[0]
            run, key, kernel = runs[kind]
            _build.library = lambda lib=lib: lib  # noqa: E731
            got = run()
            same = (torch.equal(got.values, want[kind].values) if kind == "tree" else all(
                torch.equal(getattr(got, f), getattr(want[kind], f)) for f in got._fields))
            ms = sorted(cs.kernel_busy_ms(run, key)[0] for _ in range(3))[1]
            ops = _build.sass_opcodes(lib.path, kernel)
            rows.append(dict(variant=name, ms=ms, same_bits=same,
                             timing_only=DESIGN_VARIANTS[name][2],
                             sass_instructions=sum(ops.values()),
                             top_opcodes=ops.most_common(8)))
            print(f"{name:24s} {ms:.4f} ms (own device time), bits as the kernel's: {same}, "
                  f"SASS {sum(ops.values())} ({', '.join(f'{o} {c}' for o, c in ops.most_common(6))})"
                  f" [{card}]", flush=True)
    finally:
        _build.library = real_library
    return rows


# Clock stamps: thread 0 of block 0 adds each phase's SM cycles to a device
# array (probe_acc), with the kernel's cycles and globaltimer nanoseconds at
# 30 and 31 for the conversion.  Phase 3: the decision tables, once; the
# intrinsic backward (4-7: the step's start, its grid points, the table
# wait, the barrier); its walk (from 16: decide_lanes' candidates(), its
# candidate() loop, the lanes' merge, 20 a step's decision and snap, 21 a
# chunk's wait and barrier); the tree's step (4-9: the start and staging,
# ev, the barrier, the decisions, the table wait, the cluster barrier).
_STAMP_HEADER = [
    ("namespace stt_dp {\n", "namespace stt_dp {\n__device__ unsigned long long probe_acc[32];\n"
     "__device__ int probe_phase;\n__device__ __forceinline__ void probe_add(int i, long long c) {\n"
     "  if (threadIdx.x == 0 && blockIdx.x == 0)\n"
     "    probe_acc[probe_phase + i] += static_cast<unsigned long long>(c);\n}\n"),
    ("                                                int P) {\n"
     "  const Candidates<T> c = candidates(st, inv);\n",
     "                                                int P) {\n"
     "  const long long q0 = clock64();\n  const Candidates<T> c = candidates(st, inv);\n"
     "  const long long q1 = clock64();\n"),
    ("  best.merge(P);\n  const int owner =",
     "  const long long q2 = clock64();\n  best.merge(P);\n  const int owner ="),
    ("  return Choice<T>{best.total, __shfl_sync(0xffffffffu, mine.decision, owner),",
     "  const Choice<T> choice{best.total, __shfl_sync(0xffffffffu, mine.decision, owner),"),
    ("                   __shfl_sync(0xffffffffu, mine.pv, owner)};\n}",
     "                   __shfl_sync(0xffffffffu, mine.pv, owner)};\n  probe_add(0, q1 - q0);\n"
     "  probe_add(1, q2 - q1);\n  probe_add(2, clock64() - q2);\n  return choice;\n}"),
]
_GT = "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"({}));"
_READER = ("\nextern \"C\" int probe_read(unsigned long long* out) {\n"
           "  return static_cast<int>(cudaMemcpyFromSymbol(out, stt_dp::probe_acc,"
           " sizeof(stt_dp::probe_acc)));\n}\n"
           "extern \"C\" int probe_reset() {\n  unsigned long long z[32] = {0};\n"
           "  return static_cast<int>(cudaMemcpyToSymbol(stt_dp::probe_acc, z, sizeof(z)));\n}\n")
_TOTAL = ("  unsigned long long g1;\n  " + _GT.format("g1") + "\n"
          "  if (threadIdx.x == 0 && blockIdx.x == 0) {\n"
          "    stt_dp::probe_acc[30] += clock64() - k0;\n    stt_dp::probe_acc[31] += g1 - g0;\n  }\n")
_START = ("  const long long k0 = clock64();\n  unsigned long long g0;\n  " + _GT.format("g0") + "\n")
STAMPS = {
    "intrinsic_kernel.cu": [
        ("  backward<kMode>(p, l, base);\n  __syncthreads();\n  // Forward walk of the inventory.\n"
         "  forward_walk<kMode, false>(p, l, base);\n",
         _START + "  if (threadIdx.x == 0) stt_dp::probe_phase = 0;\n  backward<kMode>(p, l, base);\n"
         "  __syncthreads();\n  if (threadIdx.x == 0) stt_dp::probe_phase = 16;\n"
         "  forward_walk<kMode, false>(p, l, base);\n" + _TOTAL),
        ("  __syncthreads();  // the tables, written by every thread, are read below\n",
         "  __syncthreads();  // the tables, written by every thread, are read below\n"
         "  stt_dp::probe_add(3, clock64() - k_start);\n"),
        ("  const size_t g_ = static_cast<size_t>(G), table_len = g_ * l.row_len;\n",
         "  const size_t g_ = static_cast<size_t>(G), table_len = g_ * l.row_len;\n"
         "  const long long k_start = clock64();\n"),
        ("    const int cur = t & 1, nxt = cur ^ 1;\n    const T* tab = stages + cur * l.tab;",
         "    const long long pa = clock64();\n    const int cur = t & 1, nxt = cur ^ 1;\n"
         "    const T* tab = stages + cur * l.tab;"),
        ("    const T* v_next = v + nxt * g_;\n",
         "    const long long pb = clock64();\n    const T* v_next = v + nxt * g_;\n"),
        ("    cp_async_wait_all();\n    __syncthreads();\n    if (cubic) {\n"
         "      block_moments(p.grids + t * g_,",
         "    const long long pc = clock64();\n    cp_async_wait_all();\n"
         "    const long long pd = clock64();\n    __syncthreads();\n"
         "    stt_dp::probe_add(4, pb - pa);\n    stt_dp::probe_add(5, pc - pb);\n"
         "    stt_dp::probe_add(6, pd - pc);\n    stt_dp::probe_add(7, clock64() - pd);\n"
         "    if (cubic) {\n      block_moments(p.grids + t * g_,"),
        ("      const Choice<T> ch = decide_lanes(st, s[S_FWD], inv, l.walk_lanes);",
         "      const long long wa = clock64();\n"
         "      const Choice<T> ch = decide_lanes(st, s[S_FWD], inv, l.walk_lanes);"),
        ("      inv = next;\n", "      inv = next;\n      stt_dp::probe_add(4, clock64() - wa);\n"),
        ("    cp_async_wait_all();\n    __syncthreads();\n    if (c + 1 < chunks)",
         "    const long long wc = clock64();\n    cp_async_wait_all();\n    __syncthreads();\n"
         "    stt_dp::probe_add(5, clock64() - wc);\n    if (c + 1 < chunks)"),
    ],
    "tree_kernel.cu": [
        ("  const size_t mg = static_cast<size_t>(M) * G;\n\n  // The decision tables",
         "  const size_t mg = static_cast<size_t>(M) * G;\n"
         "  if (threadIdx.x == 0 && blockIdx.x == 0) stt_dp::probe_phase = 0;\n" + _START +
         "\n  // The decision tables"),
        ("  // The tables, written across the cluster, are read after this barrier.\n"
         "  cluster.sync();\n",
         "  // The tables, written across the cluster, are read after this barrier.\n"
         "  cluster.sync();\n  stt_dp::probe_add(3, clock64() - k0);\n"),
        ("  for (int t = p.N - 1; t >= 0; --t) {\n    const int cur = t & 1, nxt = cur ^ 1;\n"
         "    const T* s = stages",
         "  for (int t = p.N - 1; t >= 0; --t) {\n    const long long pa = clock64();\n"
         "    const int cur = t & 1, nxt = cur ^ 1;\n    const T* s = stages"),
        ("    // ev of the own rows from the band's rows of V_{t+1}, wherever they lie.\n",
         "    const long long pb = clock64();\n"
         "    // ev of the own rows from the band's rows of V_{t+1}, wherever they lie.\n"),
        ("    __syncthreads();\n    const T* grid_next = p.grids",
         "    const long long pc = clock64();\n    __syncthreads();\n"
         "    const long long pd = clock64();\n    const T* grid_next = p.grids"),
        ("    cp_async_wait_all();\n    // Publishes V_t",
         "    const long long pe = clock64();\n    cp_async_wait_all();\n"
         "    const long long pf = clock64();\n    // Publishes V_t"),
        ("    cluster.sync();\n  }\n}",
         "    cluster.sync();\n    stt_dp::probe_add(4, pb - pa);\n    stt_dp::probe_add(5, pc - pb);\n"
         "    stt_dp::probe_add(6, pd - pc);\n    stt_dp::probe_add(7, pe - pd);\n"
         "    stt_dp::probe_add(8, pf - pe);\n    stt_dp::probe_add(9, clock64() - pf);\n  }\n"
         + _TOTAL + "}"),
    ],
}
_PHASES = {"intrinsic": {3: "the tables (once)", 4: "backward: step start, staging",
                         5: "backward: grid points", 6: "backward: table wait",
                         7: "backward: barrier", 16: "walk: candidates()",
                         17: "walk: candidate() loop", 18: "walk: lanes' merge",
                         20: "walk: a step", 21: "walk: chunk wait"},
           "tree": {3: "the tables (once)", 4: "step start, staging", 5: "ev", 6: "barrier",
                    7: "decisions", 8: "table wait", 9: "cluster barrier"}}


def stamp_run(cs, pkg, device, card) -> dict:
    """The DP kernels with clock stamps (``STAMPS``) at the headline (the
    intrinsic DP, f32) and T3 (the tree, f32): nanoseconds a step in each
    phase, thread 0 of block 0."""
    import torch

    from storage_tpu_torch.engines import intrinsic as ie
    from storage_tpu_torch.engines import tree as te
    from storage_tpu_torch.ops import _build

    nvcc, out = _build.find_nvcc(), {}
    inputs, arrays = cs.intrinsic_case(pkg, device, "headline", "linspace", cs.NUM_GRID)
    arrays = arrays[torch.float32]
    t_inputs, tables, _ = cs.tree_tables(pkg, device, cs.headline_tree_case(pkg, 5.5))
    tables = tables[torch.float32]
    n = inputs.num_steps
    runs = {"intrinsic": (lambda: ie.intrinsic_core(arrays, 100.0, 0,
                                                    inputs.compiled.terminal_value, False)),
            "tree": (lambda: te.tree_core(*tables, 0, t_inputs.compiled.terminal_value, False))}
    real_library = _build.library
    try:
        for kind, file in (("intrinsic", "intrinsic_kernel.cu"), ("tree", "tree_kernel.cu")):
            d = OUT / "stamps" / kind
            d.mkdir(parents=True, exist_ok=True)
            header = apply_patches(kind, "dp_common.cuh", (_build.CSRC / "dp_common.cuh").read_text(),
                                   _STAMP_HEADER)
            (d / "dp_common.cuh").write_text(header)
            (d / file).write_text(apply_patches(kind, file, (_build.CSRC / file).read_text(),
                                                STAMPS[file]) + _READER)
            proc = subprocess.run([nvcc, *_build.COMPILE_FLAGS, "-shared", "-I", str(d), "-I",
                                   str(_build.CSRC), "-o", str(d / "lib.so"), str(d / file)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on the {kind} stamps:\n{proc.stdout[-4000:]}"
                                   f"{proc.stderr[-4000:]}")
            lib = ctypes.CDLL(str(d / "lib.so"))
            ns = types.SimpleNamespace()
            for name, argtypes in _build.SIGNATURES.items():
                fn = getattr(lib, name, None)
                if fn is not None:
                    fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
                    setattr(ns, name, fn)
            _build.library = lambda ns=ns: ns  # noqa: E731
            runs[kind]()  # warm-up: the wrapper's caches
            torch.cuda.synchronize()
            lib.probe_reset()
            runs[kind]()
            torch.cuda.synchronize()
            acc = (ctypes.c_ulonglong * 32)()
            lib.probe_read(acc)
            ns_per_cycle = acc[31] / max(acc[30], 1)
            steps = {i: 1 if i == 3 else n - 1 if kind == "intrinsic" and i < 16 else n
                     for i in _PHASES[kind]}
            out[kind] = row = {label: acc[i] * ns_per_cycle / steps[i]
                               for i, label in _PHASES[kind].items()}
            row["kernel_ns"] = acc[31]
            row["ghz"] = 1 / ns_per_cycle if ns_per_cycle else None
            print(f"{kind} stamps (ns a step, thread 0 of block 0; kernel {acc[31] / 1e3:.1f} us at "
                  f"{row['ghz']:.3f} GHz): " + ", ".join(
                      f"{k} {v:.1f}" for k, v in row.items() if k not in ("kernel_ns", "ghz"))
                  + f" [{card}]", flush=True)
    finally:
        _build.library = real_library
    return out


# ---- the large routes (``--large``, ``--large-variants``).

# The intrinsic DP's design (b), timing only: one launch a backward phase
# (the decisions of a step; in cubic mode the rhs, then the moments) with
# the large route's grid, then the walk in one block; the cooperative
# launch's place in launch_large taken by it.
_STEP_LAUNCHES = r"""
template <typename T, int kMode>
__global__ void __launch_bounds__(kGridThreads) probe_step_kernel(Problem<T> p, int t, int phase,
                                                                  T* rhs) {
  const size_t threads = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t first = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t spread = static_cast<size_t>(threadIdx.x) * gridDim.x + blockIdx.x;
  const size_t g_ = static_cast<size_t>(p.G);
  if (phase == 0) {
    for (size_t g = first; g < g_; g += threads) {
      p.vs[p.N * g_ + g] = p.v_end[g];
      p.vs[g] = T(0);
    }
  } else if (phase == 1) {
    decide_row<kMode>(p, t, first, threads);
  } else if (phase == 2) {
    rhs_row(p, t, rhs, first, threads);
  } else {
    moments_row(p, t, rhs, spread, threads);
  }
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kGridThreads) probe_walk_kernel(Problem<T> p, Plan l) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  forward_walk<kMode, true>(p, l, reinterpret_cast<T*>(smem_raw));
}

template <typename T, int kMode>
int probe_steps(const Problem<T>& p, const Plan& l, int blocks, T* rhs, cudaStream_t s) {
  const auto step = probe_step_kernel<T, kMode>;
  step<<<blocks, l.threads, 0, s>>>(p, 0, 0, rhs);
  for (int t = p.N; t >= 1; --t) {
    if (t < p.N) step<<<blocks, l.threads, 0, s>>>(p, t, 1, rhs);
    if (kMode == MODE_CUBIC) {
      step<<<blocks, l.threads, 0, s>>>(p, t, 2, rhs);
      step<<<blocks, l.threads, 0, s>>>(p, t, 3, rhs);
    }
  }
  const auto walk = probe_walk_kernel<T, kMode>;
  if (l.bytes > 48 * 1024)
    cudaFuncSetAttribute(walk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(l.bytes));
  walk<<<1, l.threads, l.bytes, s>>>(p, l);
  return static_cast<int>(cudaGetLastError());
}

"""
_PROBE_DISPATCH = ("  T* rhs_arg = cubic ? rhs : nullptr;\n", """  T* rhs_arg = cubic ? rhs : nullptr;
  {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return mode == MODE_GENERAL ? probe_steps<T, MODE_GENERAL>(p, l, blocks, rhs_arg, s)
           : mode == MODE_CUBIC ? probe_steps<T, MODE_CUBIC>(p, l, blocks, rhs_arg, s)
                                : probe_steps<T, MODE_UNIFORM>(p, l, blocks, rhs_arg, s);
  }
""")
_WALK = "  if (blockIdx.x == 0) forward_walk<kMode, true>(p, l, reinterpret_cast<T*>(smem_raw));"
_TREE_LOOP = "  for (int hi = p.N; hi > 0; hi -= table_steps) {\n"
_TREE_CUBIC = """      if (cubic) {
        tree_ev_kernel<T><<<rows, kStepThreads, 0, s>>>(p, t, ev, rhs);
        tree_moments_kernel<T><<<moments, kStepThreads, 0, s>>>(p, t, rhs, mom);
      }
"""
_TREE_DECIDE = """      decide_k<<<cells, kStepThreads, 0, s>>>(p, t, table + (t - lo) * table_len, ev, mom);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
"""
_DECIDE_ANCHOR = "// values[t][m, g] for node rows [blockIdx.y·kDecideRows, +kDecideRows) at\n"
_BAND_EV = """template <typename T>
__device__ __forceinline__ T band_ev(const T* band, const T* rows, int W, int G, int x) {
  T acc = T(0);
  for (int w = 0; w < W; ++w) acc = add(acc, mul(band[w], rows[static_cast<size_t>(w) * G + x]));
  return acc;
}

"""
_DECIDE_CONT = """      const T cont = node_continuation(kMode, w, ev[at], ev[at + 1], moments ? mom[at] : T(0),
                                       moments ? mom[at + 1] : T(0), curvature, degenerate);
"""
_BAND_EV_CONT = """      T v_lo = kMode == MODE_CUBIC ? ev[at] : T(0), v_hi = kMode == MODE_CUBIC ? ev[at + 1] : T(0);
      if (kMode != MODE_CUBIC) {
        const size_t tm = static_cast<size_t>(t) * M + m0 + r;
        const T* band = p.band + tm * p.W;
        const T* next = p.values + (t + 1) * mg + static_cast<size_t>(p.start[tm]) * G;
        v_lo = band_ev(band, next, p.W, G, idx);
        v_hi = band_ev(band, next, p.W, G, idx + 1);
      }
      const T cont = node_continuation(kMode, w, v_lo, v_hi, moments ? mom[at] : T(0),
                                       moments ? mom[at + 1] : T(0), curvature, degenerate);
"""
_EV_LAUNCH = ("      tree_ev_kernel<T><<<rows, kStepThreads, 0, s>>>(p, t, ev, cubic ? rhs : nullptr);\n")
_STEP_SYNC = "    grid.sync();  // v_t before its moments and step t-1 read it\n"
_WALK_STAGE = """      if (l.f_grid >= 0) stage_copy(dst + l.f_grid, p.grids + next, p.G);
    }
"""
_WALK_STAGE_PREFETCH = """      if (l.f_grid >= 0) stage_copy(dst + l.f_grid, p.grids + next, p.G);
    } else {
      constexpr int kLine = 128 / sizeof(T);
      for (int i = threadIdx.x * kLine; i < p.G; i += blockDim.x * kLine)
        for (const T* row : std::initializer_list<const T*>{p.vs, p.grids, p.moments})
          if (row) asm volatile("prefetch.global.L2 [%0];" ::"l"(row + next + i));
    }
"""
_NOW = "probe_now()"
_STAMP_PATCHES = [
    ("namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n__device__ unsigned long long probe_ns[8];\n"
     "__device__ __forceinline__ unsigned long long probe_now() {\n  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n  return t;\n}\n"),
    ("    decide_row<kMode>(p, t, first, threads);\n" + _STEP_SYNC,
     "    const unsigned long long q0 = probe_now();\n"
     "    decide_row<kMode>(p, t, first, threads);\n"
     "    const unsigned long long q1 = probe_now();\n" + _STEP_SYNC +
     "    if (blockIdx.x == 0 && threadIdx.x == 0) {\n      probe_ns[0] += q1 - q0;\n"
     "      probe_ns[1] += probe_now() - q1;\n    }\n"),
    ("      const Choice<T> ch = decide_lanes(st, s[S_FWD], inv, l.walk_lanes);\n",
     "      const unsigned long long w0 = probe_now();\n"
     "      const Choice<T> ch = decide_lanes(st, s[S_FWD], inv, l.walk_lanes);\n"
     "      if (kLarge && threadIdx.x == 0) probe_ns[2] += probe_now() - w0;\n"),
    ("    cp_async_wait_all();\n    __syncthreads();\n    if (c + 1 < chunks) stage_chunk",
     "    const unsigned long long c0 = probe_now();\n    cp_async_wait_all();\n"
     "    __syncthreads();\n    if (kLarge && threadIdx.x == 0) probe_ns[3] += probe_now() - c0;\n"
     "    if (c + 1 < chunks) stage_chunk"),
    (_WALK, "  const unsigned long long k0 = probe_now();\n" + _WALK +
     "\n  if (blockIdx.x == 0 && threadIdx.x == 0) probe_ns[4] += probe_now() - k0;"),
    ("}  // namespace\n",
     "}  // namespace\n\nextern \"C\" int probe_read(unsigned long long* out) {\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(out, probe_ns, sizeof(probe_ns)));\n}\n"
     "extern \"C\" int probe_reset() {\n  unsigned long long z[8] = {0};\n"
     "  return static_cast<int>(cudaMemcpyToSymbol(probe_ns, z, sizeof(z)));\n}\n"),
]
# The large routes' variants, each a text patch of one source (timing_only:
# the answer may differ).
LARGE_VARIANTS = {
    "intrinsic/as_is": ("intrinsic_kernel.cu", [], False),
    # Design (b): a launch a backward phase, the walk a launch of its own.
    "intrinsic/step_launches": ("intrinsic_kernel.cu", [
        ("int device_attribute(cudaDeviceAttr attr, int* value) {",
         _STEP_LAUNCHES + "int device_attribute(cudaDeviceAttr attr, int* value) {"),
        _PROBE_DISPATCH], False),
    # The walk skipped: the backward's share.
    "intrinsic/no_walk": ("intrinsic_kernel.cu", [
        (_WALK, _WALK.replace("blockIdx.x == 0", "blockIdx.x == 0 && p.N < 0"))], True),
    # decide()'s loop over the decisions unrolled four ways, so that their
    # continuation loads go out together (dp_common.cuh).
    "intrinsic/unroll_decide": ("dp_common.cuh/intrinsic_kernel.cu", [(
        "  Choice<T> best{T(0), T(0), T(0), T(0)};\n  for (int k = 0; k < c.bb.nd; ++k) {",
        "  Choice<T> best{T(0), T(0), T(0), T(0)};\n#pragma unroll 4\n"
        "  for (int k = 0; k < c.bb.nd; ++k) {")], False),
    # The walk's next rows prefetched into L2 a chunk ahead.
    "intrinsic/walk_prefetch": ("intrinsic_kernel.cu", [(_WALK_STAGE, _WALK_STAGE_PREFETCH)],
                                False),
    # Every block the card holds in linear and general modes too.
    "intrinsic/full_grid": ("intrinsic_kernel.cu", [(
        "  return static_cast<int>(std::min<long long>(resident, (G + kGridThreads - 1) / "
        "kGridThreads));", "  return static_cast<int>(resident);")], False),
    # The cubic moments' rows on the blocks G needs, not every block.
    "intrinsic/cubic_min_grid": ("intrinsic_kernel.cu", [
        ("  if (mode == MODE_CUBIC) return static_cast<int>(resident);\n", "")], False),
    "tree/as_is": ("tree_kernel.cu", [], False),
    **{f"tree/rows_{k}": ("tree_kernel.cu", [("constexpr int kDecideRows = 4;",
                                              f"constexpr int kDecideRows = {k};")], False)
       for k in (2, 8)},
    **{f"tree/ev_rows_{k}": ("tree_kernel.cu", [("constexpr int kEvRows = 8;",
                                                 f"constexpr int kEvRows = {k};")], False)
       for k in (1, 4, 16)},
    # The ev launches, or the decide launches, left out (timing only): each
    # one's share of a step.
    "tree/no_ev": ("tree_kernel.cu", [(_EV_LAUNCH, "")], True),
    "tree/no_decide": ("tree_kernel.cu", [(
        "      decide_k<<<cells, kStepThreads, 0, s>>>(p, t, table + (t - lo) * table_len, ev, mom);\n",
        "")], True),
    # One table launch a step (a table of one step in L2).
    "tree/step_tables": ("tree_kernel.cu", [(_TREE_LOOP, "  table_steps = 1;\n" + _TREE_LOOP)],
                         False),
    # Summing ev at each decision's two nodes from the band inside the
    # decide (linear and general modes), with no ev launch.
    "tree/band_ev": ("tree_kernel.cu", [
        (_DECIDE_ANCHOR, _BAND_EV + _DECIDE_ANCHOR),
        (_DECIDE_CONT, _BAND_EV_CONT),
        (_EV_LAUNCH, "      if (cubic) tree_ev_kernel<T><<<rows, kStepThreads, 0, s>>>(p, t, ev, rhs);\n")],
        False),
    # Clock stamps (globaltimer) of block 0's thread 0: a backward step's
    # decisions and its grid barrier, the walk's decide_lanes, its chunk
    # waits, and the whole walk.
    "intrinsic/stamps": ("intrinsic_kernel.cu", _STAMP_PATCHES, False),
    # The grid barrier a step removed (timing only: the answer may differ).
    "intrinsic/no_sync": ("intrinsic_kernel.cu", [
        (_STEP_SYNC, "")], True),
    # The decisions a step replaced by a store (timing only).
    "intrinsic/no_decide": ("intrinsic_kernel.cu", [
        ("    decide_row<kMode>(p, t, first, threads);\n",
         "    if (first < g_) p.vs[t * g_ + first] = p.grids[t * g_ + first];\n")], True),
}


def hourly_intrinsic_case(cs, pkg, device, g: int):
    """The hourly year (``chip_smoke.hourly_fwd``, 8,760 steps) at g
    linspace points in f32: (valuation inputs, arrays)."""
    import torch

    from storage_tpu_torch import grid as gridmod
    from storage_tpu_torch.engines import lsmc as engine
    from storage_tpu_torch.valuation_inputs import prepare_valuation

    storage, hour, fwd = cs.hourly_fwd(pkg)
    inputs = prepare_valuation(storage, hour, 100.0, fwd, 0.02, None)
    lo, hi = inputs.inventory_lower, inputs.inventory_upper
    arrays = engine.build_engine_arrays(inputs.compiled, inputs.fwd, inputs.df_settle,
                                        inputs.df_flow, lo, hi, g, torch.float32, device,
                                        gridmod.inventory_grids(lo, hi, g))
    return inputs, arrays


def large_cases(cs, pkg, device):
    """The large routes' cases, each (kind, name, run, repeats): ``run(route)``
    returns the outputs (a tuple of tensors) of the engine's core forced onto
    ``route``.  The intrinsic DP at G = 32,768 on linspace and on
    fixed-spacing rows (f32, f64), on 10,001 fixed-step rows (f64), cubic at
    G = 6,144 (f64; a cubic grid of 32,768 points needs a [32,766]² host
    inverse), and the hourly year at G = 3,840 (f32: just past the shared
    route's table cap at 3,830); the tree on T1 at G = 65,536 (f32, f64), on
    a random 8-row lattice cubic at G = 10,240 (f64), and at T3 and T5."""
    import torch

    from storage_tpu_torch.engines import intrinsic as ie
    from storage_tpu_torch.engines import tree as te

    dtypes = ((torch.float32, "f32"), (torch.float64, "f64"))

    def intrinsic_run(arrays, inputs, e, interpolation, uniform):
        tfn = None if inputs.compiled.must_be_empty_at_end else inputs.compiled.terminal_value
        args = (inputs.starting_inventory, e, tfn, inputs.compiled.ratchet_is_step, interpolation,
                uniform)
        return lambda route: tuple(ie.intrinsic_core(arrays, *args, route=route))

    def tree_run(tables, inputs, interpolation, uniform):
        tfn = None if inputs.compiled.must_be_empty_at_end else inputs.compiled.terminal_value
        return lambda route: (te.tree_core(*tables, 0, tfn, inputs.compiled.ratchet_is_step,
                                           interpolation, uniform, route=route).values,)

    for name, (case, scheme, g, grid_calc, interpolation, dts) in {
        "linear_32768": ("headline", "linspace", cs.DP_GRID, None, "linear", dtypes),
        "general_32768": ("headline", "fixed_spacing", cs.DP_GRID, None, "linear", dtypes),
        "general_10001": ("headline", "custom", cs.NUM_GRID, cs.step_rows(cs.DP_STEP), "linear",
                          dtypes[1:]),
        "cubic_6144": ("2F", "linspace", cs.DP_CUBIC_GRID, None, "cubic", dtypes[1:]),
    }.items():
        inputs, arrays = cs.intrinsic_case(pkg, device, case, scheme, g, grid_calc)
        for dt, label in dts:
            yield ("intrinsic", f"{name}_{label}",
                   intrinsic_run(arrays[dt], inputs, 0, interpolation, scheme == "linspace"), 3)
        del arrays
    for g in (3_830, 3_840):
        inputs, arrays = hourly_intrinsic_case(cs, pkg, device, g)
        yield "intrinsic", f"hourly_{g}_f32", intrinsic_run(arrays, inputs, 0, "linear", True), 3
        del arrays
    t1 = cs.csharp_tree_case(pkg)
    inputs, tables, uniform = cs.tree_tables(pkg, device, dict(t1, g=cs.DP_TREE_GRID))
    for dt, label in dtypes:
        yield "tree", f"T1_65536_{label}", tree_run(tables[dt], inputs, "linear", uniform), 5
    del tables
    inputs, tables = cs.random_lattice_tables(pkg, device, 8, cs.DP_TREE_CUBIC_GRID, 4)
    yield "tree", "cubic_10240_f64", tree_run(tables[torch.float64], inputs, "cubic", True), 3
    del tables
    for name, case in (("T3", cs.headline_tree_case(pkg, 5.5)), ("T5", cs.wide_tree_case(pkg))):
        inputs, tables, uniform = cs.tree_tables(pkg, device, case)
        for dt, label in dtypes:
            yield "tree", f"{name}_{label}", tree_run(tables[dt], inputs, "linear", uniform), 5
        del tables


def wrapper_ms(cs, kind: str, run, repeats: int) -> float:
    """Device ms of the DP wrapper's calls in ``run`` (``intrinsic_dp`` or
    ``tree_dp``: CUDA events around each call, ``chip_smoke.launch_ms``), the
    mean of ``repeats`` runs after half a second of warm-up calls: the
    kernels alone, not the engine's host work around them."""
    import time

    import torch

    from storage_tpu_torch.ops import intrinsic_kernel, tree_kernel

    # Calls until half a second has passed first: the card's clocks rise
    # under load, and a single warm-up call of a short kernel after idle
    # host work leaves them low.
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.5:
        run()
        torch.cuda.synchronize()
    module = intrinsic_kernel if kind == "intrinsic" else tree_kernel
    return cs.launch_ms(module, f"{kind}_dp", run, repeats)[0]


def large_run(cs, pkg, device, card, report) -> None:
    """Each large-route case (``large_cases``) forced onto the large route:
    its digests, its ms (``wrapper_ms``) and, where the shape also fits the shared or
    cluster route, whether that route gives the same bits; the hourly year
    at G = 3,830 also timed on the shared route (the crossing)."""
    import torch

    report["digests"]["large"], report["large_ms"], report["large_same_as_own"] = {}, {}, {}
    for kind, name, run, repeats in large_cases(cs, pkg, device):
        out = run("large")
        torch.cuda.synchronize()
        report["digests"]["large"][f"{kind}_{name}"] = digest(*out)
        ms = wrapper_ms(cs, kind, lambda: run("large"), repeats)
        report["large_ms"][f"{kind}_{name}"] = ms
        line = f"large {kind} {name}: {ms:.4f} ms (CUDA events around the DP's wrapper)"
        own = {"T3": "cluster", "T5": "steps", "hourly_3830": "shared"}.get(name.rsplit("_", 1)[0])
        if own:
            other = run(own)
            same = all(torch.equal(a, b) for a, b in zip(out, other))
            report["large_same_as_own"][f"{kind}_{name}"] = same
            line += f"; the {own} route's bits: {same}"
            if own == "shared":
                shared_ms = wrapper_ms(cs, kind, lambda: run("shared"), repeats)
                report["large_ms"][f"{kind}_{name}_shared"] = shared_ms
                line += f", the shared route {shared_ms:.4f} ms"
        print(f"{line} [{card}]", flush=True)
        del run
        torch.cuda.empty_cache()


def stamps_ns(lib, run, n: int) -> dict:
    """One call of ``run`` on the stamps variant's library: ns a step of
    the backward's decisions and grid barrier (block 0's thread 0, N-1
    steps), the walk's decide_lanes and chunk waits (N steps), and the whole
    walk in ms."""
    import torch

    cdll = ctypes.CDLL(str(lib.path))
    cdll.probe_reset()
    run()
    torch.cuda.synchronize()
    acc = (ctypes.c_ulonglong * 8)()
    cdll.probe_read(acc)
    return {"decide": acc[0] / (n - 1), "barrier": acc[1] / (n - 1), "walk_decide": acc[2] / n,
            "walk_chunk_wait": acc[3] / n, "walk_ms": acc[4] / 1e6}


def large_variants(cs, pkg, device, card) -> list:
    """The large routes' variants (``LARGE_VARIANTS``, built together): each
    one's ms on the intrinsic DP's (or the tree's) large cases and whether
    its outputs are the as-is kernel's bits."""
    import torch

    from storage_tpu_torch.ops import _build

    libs = build_variants(_build.CSRC, _build.SIGNATURES, _build.find_nvcc(),
                          _build.COMPILE_FLAGS,
                          {k: (f, lambda text, k=k, f=f, p=p: apply_patches(k, f, text, p))
                           for k, (f, p, _) in LARGE_VARIANTS.items()})
    keep = {"linear_32768_f32", "linear_32768_f64", "cubic_6144_f64", "hourly_3840_f32",
            "T1_65536_f32", "T1_65536_f64", "cubic_10240_f64"}
    rows = []
    real_library = _build.library
    try:
        for kind, name, run, repeats in large_cases(cs, pkg, device):
            if name not in keep:
                continue
            want = run("large")
            for variant, lib in libs.items():
                if not variant.startswith(kind):
                    continue
                _build.library = lambda lib=lib: lib  # noqa: E731
                got = run("large")
                same = all(torch.equal(a, b) for a, b in zip(got, want))
                ms = wrapper_ms(cs, kind, lambda: run("large"), repeats)
                row = dict(variant=variant, case=name, ms=ms, same_bits=same,
                           timing_only=LARGE_VARIANTS[variant][2])
                if variant.endswith("stamps"):
                    row["stamps_ns"] = stamps_ns(lib, lambda: run("large"), got[1].numel() - 1)
                _build.library = real_library
                rows.append(row)
                print(f"{variant:26s} {name:18s} {ms:.4f} ms, the as-is bits: {same}"
                      + (f"; ns a step: {row['stamps_ns']}" if "stamps_ns" in row else "")
                      + f" [{card}]", flush=True)
            del run, want
            torch.cuda.empty_cache()
    finally:
        _build.library = real_library
    return rows


def compare(a: Path, b: Path) -> int:
    ra, rb = json.loads(a.read_text()), json.loads(b.read_text())
    differ = 0
    for kind in ra["digests"]:
        for case, want in ra["digests"][kind].items():
            got = rb["digests"].get(kind, {}).get(case)
            same = got == want
            differ += not same
            print(f"{kind} {case}: {'same bits' if same else 'DIFFER'}", flush=True)
    print(f"{differ} of the digests differ between {a.name} and {b.name}")
    return 1 if differ else 0


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", type=Path, default=REPO,
                    help="directory holding the storage_tpu_torch to import")
    ap.add_argument("--label", default="change")
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--compare", nargs=2, type=Path, metavar=("A", "B"))
    ap.add_argument("--variants", action="store_true",
                    help="time the design's variants (DESIGN_VARIANTS) instead")
    ap.add_argument("--stamps", action="store_true",
                    help="time the DP kernels' phases by clock stamps (STAMPS) instead")
    ap.add_argument("--large", action="store_true",
                    help="only the large routes' cases: digests and times (large_run)")
    ap.add_argument("--large-variants", action="store_true",
                    help="time the large routes' variants (LARGE_VARIANTS) instead")
    args = ap.parse_args(argv[1:])
    if args.compare:
        return compare(*args.compare)
    import torch

    if not torch.cuda.is_available():
        print("dp probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.repo.resolve()))
    import storage_tpu_torch as pkg
    from storage_tpu_torch.engines import intrinsic as ie
    from storage_tpu_torch.engines import tree as te
    from storage_tpu_torch.ops import _build, tree_kernel

    cs = _load_chip_smoke()
    device = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"{card} [{args.label}: {Path(pkg.__file__).parent}]", flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    _build.library()
    if args.stamps:
        stamps = stamp_run(cs, pkg, device, card)
        (OUT / f"{args.label}_stamps.json").write_text(json.dumps(dict(card=card, stamps=stamps),
                                                                  indent=1))
        print(card)
        return 0
    if args.large_variants:
        rows = large_variants(cs, pkg, device, card)
        (OUT / f"{args.label}_large_variants.json").write_text(
            json.dumps(dict(card=card, variants=rows), indent=1))
        print(card)
        return 0
    if args.variants:
        rows = design_variants(cs, pkg, device, card)
        (OUT / f"{args.label}_variants.json").write_text(json.dumps(dict(card=card, variants=rows),
                                                                    indent=1))
        print(card)
        return 0
    report = dict(card=card, label=args.label, package=str(Path(pkg.__file__).parent),
                  digests={"tree": {}, "intrinsic": {}}, npv={})
    if args.large:
        large_run(cs, pkg, device, card, report)
        out = OUT / f"{args.label}.json"
        out.write_text(json.dumps(report, indent=1))
        print(f"report: {out.relative_to(REPO)}")
        print(card)
        return 0
    dtypes = ((torch.float32, "f32"), (torch.float64, "f64"))

    # ---- the tree.
    t1, t3, t4 = (cs.csharp_tree_case(pkg), cs.headline_tree_case(pkg, 5.5),
                  cs.headline_tree_case(pkg, 1.5))
    t2 = {name: cs.oracle_tree_case(pkg, name == "ratcheted") for name in ("simple", "ratcheted")}
    tree_cases = {
        "T1": (t1, 0, "linear", None), "T2_simple": (t2["simple"], 0, "linear", None),
        "T2_ratcheted": (t2["ratcheted"], 0, "linear", None), "T3": (t3, 0, "linear", None),
        "T4": (t4, 0, "linear", None), "T2_cubic": (t2["simple"], 0, "cubic", None),
        "T2_custom_grid": (t2["simple"], 0, "linear", cs.custom_grid),
        "T3_E=1": (t3, 1, "linear", None),
    }
    report["tree_times"] = {}
    for name, (case, e, interpolation, grid_calc) in tree_cases.items():
        inputs, tables, uniform = cs.tree_tables(pkg, device, case, grid_calc)
        tfn = None if inputs.compiled.must_be_empty_at_end else inputs.compiled.terminal_value
        targs = (e, tfn, inputs.compiled.ratchet_is_step, interpolation, uniform)
        for dt, label in dtypes:
            res = te.tree_core(*tables[dt], *targs)
            torch.cuda.synchronize()
            report["digests"]["tree"][f"{name}_{label}"] = digest(res.values)
            report["npv"][f"tree_{name}_{label}"] = float(res.npv)
            if name in ("T3", "T4"):
                run = lambda: te.tree_core(*tables[dt], *targs)  # noqa: E731
                ms = cs.cuda_ms(run, 10)
                busy, launches = cs.kernel_busy_ms(run, "tree")
                report["tree_times"][f"{name}_{label}"] = row = dict(
                    ms=ms, kernel_ms=busy, gaps_ms=ms - busy, launches=launches,
                    steps=inputs.num_steps)
                print(f"tree {name} {label}: {ms:.4f} ms a valuation (CUDA events), the tree "
                      f"kernels' own {busy:.4f} ms in {launches} launches, gaps {ms - busy:.4f} "
                      f"ms ({100 * (ms - busy) / ms:.1f}%); {1e3 * ms / inputs.num_steps:.3f} us "
                      f"a step [{card}]", flush=True)
        del tables
    print("tree digests: " + json.dumps(report["digests"]["tree"]), flush=True)

    # ---- the intrinsic DP.
    intrinsic_cases = {
        "headline": ("headline", "linspace", cs.NUM_GRID, 0, "linear"),
        "G=1000": ("headline", "linspace", cs.BIG_GRID, 0, "linear"),
        "2F_cubic": ("2F", "linspace", cs.NUM_GRID, 0, "cubic"),
        "custom_grid": ("2F", "custom", cs.NUM_GRID, 0, "linear"),
        "E=1": ("2F", "linspace", cs.NUM_GRID, 1, "linear"),
        "empty_E=1": ("empty40", "fixed_spacing", 15, 1, "linear"),
        "empty_E=2": ("empty40", "fixed_spacing", 15, 2, "linear"),
    }
    fields = ie.IntrinsicEngineResult._fields
    timed = {}
    for name, (case, scheme, g, e, interpolation) in intrinsic_cases.items():
        inputs, arrays = cs.intrinsic_case(pkg, device, case, scheme, g)
        tfn = None if inputs.compiled.must_be_empty_at_end else inputs.compiled.terminal_value
        iargs = (inputs.starting_inventory, e, tfn, inputs.compiled.ratchet_is_step, interpolation,
                 scheme == "linspace")
        for dt, label in dtypes:
            res = ie.intrinsic_core(arrays[dt], *iargs)
            torch.cuda.synchronize()
            report["digests"]["intrinsic"][f"{name}_{label}"] = digest(
                *(getattr(res, k) for k in fields))
            report["npv"][f"intrinsic_{name}_{label}"] = float(res.npv)
        if name in ("headline", "G=1000"):
            timed[name] = (inputs.num_steps, arrays, iargs)
        else:
            del arrays
    print("intrinsic digests: " + json.dumps(report["digests"]["intrinsic"]), flush=True)

    split = {v: ("intrinsic_kernel.cu", lambda text, v=v: patched_intrinsic(text, v))
             for v in ("as_is", "backward_only", "empty")}
    libs = build_variants(_build.CSRC, _build.SIGNATURES, _build.find_nvcc(), _build.COMPILE_FLAGS,
                          split)
    report["intrinsic_split"] = {}
    real_library = _build.library
    try:
        for name, (n, arrays, iargs) in timed.items():
            for dt, label in dtypes:
                ms = {}
                for variant, lib in libs.items():
                    _build.library = lambda lib=lib: lib  # noqa: E731
                    ms[variant] = cs.cuda_ms(lambda: ie.intrinsic_core(arrays[dt], *iargs),
                                             args.repeats)
                backward = ms["backward_only"] - ms["empty"]
                forward = ms["as_is"] - ms["backward_only"]
                _build.library = real_library
                own = cs.kernel_busy_ms(lambda: ie.intrinsic_core(arrays[dt], *iargs),
                                        "intrinsic_dp_kernel")[0]
                report["intrinsic_split"][f"{name}_{label}"] = row = dict(
                    **{f"{k}_ms": v for k, v in ms.items()}, kernel_ms=own, backward_ms=backward,
                    forward_ms=forward, backward_us_per_step=1e3 * backward / max(n - 1, 1),
                    forward_us_per_step=1e3 * forward / n, steps=n)
                print(f"intrinsic {name} {label}: {ms['as_is']:.4f} ms a DP (empty kernel "
                      f"{ms['empty']:.4f}; the kernel's own device time {own:.4f}); backward "
                      f"{backward:.4f} ms ({row['backward_us_per_step']:.3f} us a step of "
                      f"{n - 1}), forward walk "
                      f"{forward:.4f} ms ({row['forward_us_per_step']:.3f} us a step of {n}) "
                      f"[{card}]", flush=True)
    finally:
        _build.library = real_library
    if hasattr(tree_kernel, "chain_step_ns"):
        report["chain_step_ns"] = {kind: tree_kernel.chain_step_ns(kind, device)
                                   for kind in ("block", "cluster", "grid")}
        print(f"chain step: {json.dumps(report['chain_step_ns'])} [{card}]", flush=True)
    out = OUT / f"{args.label}.json"
    out.write_text(json.dumps(report, indent=1))
    print(f"report: {out.relative_to(REPO)}")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
