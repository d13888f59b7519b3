#!/usr/bin/env python3
"""Variants of kernel D of ``storage_tpu_torch`` (``csrc/decision_update_kernel.cu``)
timed on one NVIDIA GPU at the spot-only path's shapes (G=100, S=262,144, D=3,
B=4: ``chip_smoke.backward_step_inputs``' kernel-D arguments).

Each variant is a text patch of the kernel's source, built for B=4 alone into
``build/update_probe/<variant>/``:

  as_is             the kernel as committed: 256 sims a block, the argmax
                    first, 4 grid points a group, the winner's two rows of v
                    read through L1, the step tables in shared memory;
  parent            the first design (PR 2), from the source directory
                    ``--parent-csrc`` names (a ``git archive`` of the parent
                    commit): six gathers of v from device memory per sim and g;
  stage_whole, stage_whole_p128   the block's whole [G, P] slice of v staged
                    in shared memory by 16-byte ``cp.async`` of all threads
                    before the loop, and read from there (256 or 128 sims);
  p128, p64         128 or 64 sims a block;
  p128_8blk, blk5   registers capped for 8 blocks of 128 or 5 of 256 per SM;
  group1, group2, group8   1, 2 or 8 grid points a group, not 4;
  tables_l1         the step tables packed once into device memory by a small
                    kernel and read through L1, none in shared memory;
  one_kernel        one kernel for every basis size: compiled at 16 terms,
                    the records and the design row zero-padded to 16;
  rolled            the wide route (one kernel for every basis size, a loop
                    over the runtime padded B, the design row in a shared
                    [Bp, 256] tile), which the kernel takes past 32 terms;
  abl_uniform       v read at the grid point's decision-0 row, one row for the
                    whole warp (timing only: not the kernel's answer).

For each it prints blocks per SM, shared memory per block, registers, local
(spill) bytes, SASS instructions and the mean milliseconds per call (CUDA
events over ``--repeats`` calls), and whether best_act equals the plain
version's bits.  Before the variants it times ``nvcc`` on each source of
``csrc/`` alone, one after another (the kernel library builds them in
parallel), and on the parent's kernel D.  The report goes to
``build/update_probe/update_probe.json``.

    mkdir -p build/parent && git archive <parent> storage_tpu_torch | tar -x -C build/parent
    python3 tools/torch_update_probe.py --parent-csrc build/parent/storage_tpu_torch/csrc
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "build" / "update_probe"
FILE = "decision_update_kernel.cu"


def _const(name: str, value: str, new: str):
    """Patch of a constant's definition line (the comment after it kept)."""
    return f"constexpr int {name} = {value};", f"constexpr int {name} = {new};"


# Every variant of the repository's source is compiled for B=4 alone.
_SWITCH = ("  switch (padded_basis(B)) {\n"
           + "".join(f"    case {b}: return decision_update_kernel<{b}>;\n"
                     for b in (4, 8, 12, 16, 20, 24, 28, 32))
           + "    default: return decision_update_kernel<0>;\n  }")
_B4_ONLY = "  return B == 4 ? decision_update_kernel<4> : nullptr;"
_B16 = "  return B <= 16 ? decision_update_kernel<16> : nullptr;"
_WIDE = "  return decision_update_kernel<0>;"
_ROW_WORDS = "  return Bp > kMaxRegisterBasis ? Bp * kThreads : 0;"
_PAD = "__host__ __device__ inline int padded_basis(int B) { return (B + 3) & ~3; }"
_PAD16 = "__host__ __device__ inline int padded_basis(int B) { return B > 0 ? 16 : 0; }"

_BOUNDS = "__global__ void __launch_bounds__(kThreads) decision_update_kernel("


def _blocks(n: int):
    """Registers capped for n blocks per SM."""
    return (_BOUNDS, _BOUNDS.replace("(kThreads)", f"(kThreads, {n})"))


_P128 = _const("kThreads", "256", "128")
_LAUNCH_SMEM = ("      sizeof(float) * (static_cast<size_t>(G) * record_words(D, bp) + "
                "row_words(bp));")
_INFO_WORDS = "record_words(D, bp), G, out));"
_DM_LOAD = ("#pragma unroll\n"
            "    for (int k = 0; k < Bp; ++k)\n"
            "      dm.dm[k] = k < B ? dm_std_t[static_cast<size_t>(k) * S + s] : 0.0f;")
_ROW_READ = "    const float* x = v + static_cast<size_t>(best_lo[i]) * S + s;"
_CONT = "__fadd_rn(__fmul_rn(__ldg(x), __fsub_rn(1.0f, w)), __fmul_rn(__ldg(x + S), w));"
# The block's whole [G, kThreads] slice of v into shared memory after the
# tables, by 16-byte cp.async of all threads (S a multiple of 4).
_STAGE = _DM_LOAD + """
  {
    float* vs = tab + G * rec;
    const int s0 = blockIdx.x * kThreads;
    const int quads = min(kThreads, S - s0) / 4;
    for (int i = threadIdx.x; i < G * (kThreads / 4); i += kThreads) {
      const int r = i / (kThreads / 4);
      const int q = i - r * (kThreads / 4);
      if (q < quads)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                     :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(vs + r * kThreads + 4 * q))),
                        "l"(v + static_cast<size_t>(r) * S + s0 + 4 * q) : "memory");
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
  }"""
_STAGE_PATCHES = [
    (_DM_LOAD, _STAGE),
    (_ROW_READ, "    const float* x = tab + G * rec + best_lo[i] * kThreads + threadIdx.x;"),
    (_CONT, "__fadd_rn(__fmul_rn(x[0], __fsub_rn(1.0f, w)), __fmul_rn(x[kThreads], w));"),
    (_LAUNCH_SMEM, _LAUNCH_SMEM[:-1] + " + sizeof(float) * static_cast<size_t>(G) * kThreads;"),
    (_INFO_WORDS, "record_words(D, bp) + kThreads, G, out));"),
]

_TAB_SMEM = "  extern __shared__ __align__(16) float tab[];"
_REPACK = "  for (int i = threadIdx.x; i < G * D; i += kThreads) {"
_LAUNCH = "  const int nblk = (S + kThreads - 1) / kThreads;\n  kernel<<<"
_RECORDS = "// best_act of grid points [c·kGroup"
_PACK_KERNEL = """__global__ void probe_pack(int G, int D, int B, const float* a_g, const float* b_g,
                           const float* w_hi_g, const int* idx_lo_g, const float* dci_g) {
  const int Bp = padded_basis(B);
  const int rec = record_words(D, Bp);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < G * D; i += gridDim.x * blockDim.x) {
    const int d = i / G;
    const int g = i - d * G;
    float* out = g_probe_records + g * rec + record_offset(d, Bp);
    out[0] = a_g[i];
    out[1] = b_g[i];
    out[2] = w_hi_g[g * D + d];
    out[3] = __int_as_float(idx_lo_g[g * D + d]);
    if (d > 0)
      for (int k = 0; k < Bp; ++k) out[4 + k] = k < B ? dci_g[static_cast<size_t>(i) * B + k] : 0.0f;
  }
}

using UpdateKernel ="""

# name: (group, patches); "new" patches the repository's source, "parent" the
# --parent-csrc one.
VARIANTS = {
    "as_is": ("new", []),
    "parent": ("parent", []),
    "stage_whole": ("new", _STAGE_PATCHES),
    "stage_whole_p128": ("new", [_P128, *_STAGE_PATCHES]),
    "p128": ("new", [_P128]),
    "p64": ("new", [_const("kThreads", "256", "64")]),
    "p128_8blk": ("new", [_P128, _blocks(8)]),
    "blk5": ("new", [_blocks(5)]),
    "group1": ("new", [_const("kGroup", "4", "1")]),
    "group2": ("new", [_const("kGroup", "4", "2")]),
    "group8": ("new", [_const("kGroup", "4", "8")]),
    "tables_l1": ("new", [
        (_RECORDS, "__device__ __align__(16) float g_probe_records[1 << 16];\n\n" + _RECORDS),
        ("using UpdateKernel =", _PACK_KERNEL),
        (_TAB_SMEM, "  float* tab = g_probe_records;"),
        (_REPACK, "  for (int i = threadIdx.x; false && i < G * D; i += kThreads) {"),
        (_LAUNCH_SMEM, "  const size_t smem = 0;"),
        (_INFO_WORDS, "1, G, out));"),
        (_LAUNCH, "  probe_pack<<<8, 256, 0, static_cast<cudaStream_t>(stream)>>>(\n"
                  "      G, D, B, static_cast<const float*>(a), static_cast<const float*>(b),\n"
                  "      static_cast<const float*>(w_hi), static_cast<const int*>(idx_lo),\n"
                  "      static_cast<const float*>(dci));\n" + _LAUNCH),
    ]),
    "one_kernel": ("new", [(_PAD, _PAD16)]),
    "rolled": ("new", [(_ROW_WORDS, "  return Bp * kThreads;")]),
    "abl_uniform": ("new", [
        (_ROW_READ, "    const float* x = v + static_cast<size_t>(__float_as_int(r[i][3])) * S + s;")]),
}
TIMING_ONLY = {"abl_uniform"}
# The single-kernel variants keep their own switch (every B to the 16-term kernel).
_OWN_SWITCH = {"one_kernel": _B16, "rolled": _WIDE}

# Registers and local bytes of the variant's kernel at B=4, appended to its source.
_ATTRS = """
extern "C" int probe_attrs(int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, %s);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(err);
}
"""


def patched_source(csrc: Path, name: str) -> str:
    group, patches = VARIANTS[name]
    text = (csrc / FILE).read_text()
    if group == "new":
        patches = [(_SWITCH, _OWN_SWITCH.get(name, _B4_ONLY)), *patches]
    for anchor, repl in patches:
        if text.count(anchor) != 1:
            raise RuntimeError(f"{name}: anchor not found once in {FILE}: {anchor[:60]!r}")
        text = text.replace(anchor, repl)
    return text + _ATTRS % ("update_kernel(4)" if group == "new" else "decision_update_kernel")


def compile_seconds(csrc: dict) -> dict:
    """Seconds of ``nvcc -c`` on each source of the repository's ``csrc/``
    alone, one after another, and on the parent's kernel D."""
    from storage_tpu_torch.ops import _build

    nvcc = _build.find_nvcc()
    out = {}
    tmp = OUT / "compile"
    tmp.mkdir(parents=True, exist_ok=True)
    jobs = [(src.name, csrc["new"], src) for src in sorted(csrc["new"].glob("*.cu"))]
    jobs.append((f"parent {FILE}", csrc["parent"], csrc["parent"] / FILE))
    for label, inc, src in jobs:
        t0 = time.perf_counter()
        subprocess.run([nvcc, *_build.COMPILE_FLAGS, "-I", str(inc), "-c", "-o",
                        str(tmp / "probe.o"), str(src)], check=True, capture_output=True)
        out[label] = time.perf_counter() - t0
    return out


def build_all(csrc: dict):
    from storage_tpu_torch.ops import _build

    nvcc = _build.find_nvcc()
    procs = {}
    for name, (group, _) in VARIANTS.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / FILE).write_text(patched_source(csrc[group], name))
        procs[name] = subprocess.Popen(
            [nvcc, *_build.COMPILE_FLAGS, "-shared", "-I", str(csrc[group]), "-o",
             str(d / "lib.so"), str(d / FILE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, ptxas, sass = {}, {}, {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        ptxas[name] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        for fn in ("stt_decision_update", "stt_decision_update_info"):
            getattr(lib, fn).argtypes = list(_build.SIGNATURES[fn])
            getattr(lib, fn).restype = ctypes.c_int
        lib.probe_attrs.argtypes = [ctypes.c_void_p]
        lib.probe_attrs.restype = ctypes.c_int
        libs[name] = lib
        sass[name] = _build.sass_instructions(OUT / name / "lib.so", "decision_update_kernel")
    return libs, ptxas, sass


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-csrc", type=Path,
                    default=REPO / "build" / "parent" / "storage_tpu_torch" / "csrc",
                    help="csrc directory of the commit whose kernel D is compared")
    ap.add_argument("--repeats", type=int, default=20)
    args = ap.parse_args(argv[1:])
    import torch

    if not torch.cuda.is_available():
        print("update probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    import storage_tpu_torch as pkg
    from storage_tpu_torch.engines import lsmc as engine
    from storage_tpu_torch.ops import _build, decision_kernel

    device = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(card, flush=True)
    csrc = {"parent": args.parent_csrc, "new": REPO / "storage_tpu_torch" / "csrc"}
    seconds = compile_seconds(csrc)
    print("nvcc -c alone: " + ", ".join(f"{k} {t:.2f} s" for k, t in seconds.items()), flush=True)
    libs, ptxas, sass = build_all(csrc)
    with engine.full_f32_matmul():
        st = chip_smoke.backward_step_inputs(pkg, device)
    v, dm, spot, idx_lo, w_hi, ci, a, b = st.args_d
    g, s = v.shape
    d, bdim = ci.shape[0], ci.shape[2]
    dci = (ci - ci[0:1]).contiguous()
    want = decision_kernel.decision_update_plain(*st.args_d)
    stream = _build.stream_handle(device)
    rows = []
    for name, lib in libs.items():
        out = torch.empty_like(v)

        def call():
            _build.check(lib.stt_decision_update(
                g, s, d, bdim, v.data_ptr(), dm.data_ptr(), spot.data_ptr(), idx_lo.data_ptr(),
                w_hi.data_ptr(), dci.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(),
                stream), name)

        call()
        torch.cuda.synchronize()
        same = bool(torch.equal(out, want))
        ms = chip_smoke.cuda_ms(call, args.repeats)
        info = (ctypes.c_int * 6)()
        _build.check(lib.stt_decision_update_info(g, d, bdim, info), name)
        attrs = (ctypes.c_int * 2)()
        _build.check(lib.probe_attrs(attrs), name)
        row = dict(variant=name, blocks_per_sm=info[4], smem_bytes=info[1], registers=attrs[0],
                   local_bytes=attrs[1], sims_per_block=info[0], max_grid=info[3],
                   sass_instructions=sass[name], ms=ms, bits_equal_plain=same,
                   timing_only=name in TIMING_ONLY)
        rows.append(row)
        print(f"{name:17s} blocks/SM {info[4]:2d}  smem {info[1]:6d} B  regs {attrs[0]:3d}  "
              f"local {attrs[1]:3d} B  G <= {info[3]:5d}  SASS {sass[name]:6d}  {ms:.4f} ms  "
              f"bits as plain: {same}", flush=True)
        if not same and name not in TIMING_ONLY:
            print(f"  {name}: best_act differs from the plain version's bits", flush=True)
    report = dict(card=card, kind=torch.cuda.get_device_name(0),
                  shapes=dict(G=g, S=s, D=d, B=bdim), nvcc_seconds=seconds, variants=rows,
                  ptxas={k: [ln.strip() for ln in v_.splitlines()
                             if "registers" in ln or "spill" in ln] for k, v_ in ptxas.items()})
    (OUT / "update_probe.json").write_text(json.dumps(report, indent=1))
    print(card)
    return 0 if all(r["bits_equal_plain"] or r["timing_only"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
