#!/usr/bin/env python3
"""Separates what holds back kernels B and D of ``storage_tpu_torch`` on one
NVIDIA GPU, at the main path's shapes (G=100, S=262,144, D=3, B=9, F=3).

It builds variants of the kernels, each from a text patch of its source, into
``build/decision_probe/<variant>/`` and times each on the same inputs
(``chip_smoke.backward_step_inputs``) with CUDA events.  Two groups:

the first CUDA design of kernel B (commit 26161f5, unpacked with
``git archive`` into the directory ``--first-csrc`` names):
  B           kernel B as it was;
  B_nodots    without its serial per-pair dot products (it still writes a
              value for every partial, in the same scattered layout);
  B_noepi     with its moments epilogue compiled out (no partial written);
  B_nostore   B_noepi without the store of best_act into shared memory inside
              the grid loop;
  D           kernel D at B=9 (and ``D_b4`` at B=4, as chip_smoke times it);
  D_padB      D with its dynamic shared memory padded to B's;
  D_pad72k    D with 72 KiB of padding;
  D_l1tab     D reading its step tables through L1 instead of shared memory;
  D_prefetch  D prefetching the next grid point's v rows into L1;

the repository's kernel B (``storage_tpu_torch/csrc``):
  Bnew            as it is;
  Bnew_noprod     without the per-chunk moment products (timing only);
  Bnew_designrow  building its design rows with the unrolled stt::design_row;
  Bnew_7blocks    with registers capped for 7 blocks per SM instead of 9.

(Kernel D as redesigned since has its own probe, ``tools/torch_update_probe.py``.)

For each it prints blocks per SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
shared memory per block, registers, local (spill) bytes, the kernel's SASS
instruction count and the mean milliseconds per call, and checks best_act
against the unpatched kernel's.  The report goes to
``build/decision_probe/decision_probe.json``.

    mkdir -p build/parent && git archive 26161f5 storage_tpu_torch | tar -x -C build/parent
    python3 tools/torch_decision_probe.py --first-csrc build/parent/storage_tpu_torch/csrc
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "build" / "decision_probe"

# Text patches: (anchor, replacement); each anchor must occur once.
_D_SMEM = "const size_t smem = sizeof(float) * stt::decision_tables_words(G, D, B);"
_D_TABLES = """  const stt::DecisionTables tab =
      stt::load_decision_tables(smem, G, D, B, dci_g, a_g, b_g, w_hi_g, idx_lo_g);
  __syncthreads();"""
_D_LOOP = """  for (int g = 0; g < G; ++g)
    best_out[static_cast<size_t>(g) * S + s] = stt::decide(tab, G, D, B, g, v, S, s, sp, dm);"""
_B_DOTS = "    for (int t = 0; t < kThreads; ++t) acc = fmaf(x[t], y[t], acc);"
_B_EPI_START = "  // Block partials: XᵀX pairs first, then (Xᵀ·best_act)ᵀ as [G, B]."
_B_TILE = "    best_tile[g * kPitch + tid] = best_act;\n"
_B_SMEM = ("  const size_t smem = sizeof(float) *\n"
           "      (decision_tables_words(G, D, B) + 4 * B + static_cast<size_t>(G + B) * kPitch);")
_N_PROD = "    tile_product(best_tile, rows, dmp_tile, B, row + g0 * B);\n"
_N_BLOCKS = "constexpr int kMinBlocks = 9;"
_N_DESIGN = """#pragma unroll 1
  for (int k = 0; k < B; ++k)
    dmp_tile[k * kThreads + tid] = design_entry(basis, k, spot[s], factors, S, s, mean, stdv);
  float dm[stt::kMaxB];
#pragma unroll
  for (int k = 0; k < stt::kMaxB; ++k) dm[k] = k < B ? dmp_tile[k * kThreads + tid] : 0.0f;
  const float sp = spot[s];
#pragma unroll 1
  for (int k = 0; k < B; ++k) {
    const float x = design_entry(basis, k, spot_prev[s], factors_prev, S, s, mean_prev, std_prev);
    dmp_tile[k * kThreads + tid] = valid ? x : 0.0f;
  }"""
_N_DESIGN_ROW = """  float fac[stt::kMaxF];
  float dm[stt::kMaxB];
#pragma unroll
  for (int f = 0; f < stt::kMaxF; ++f)
    fac[f] = f < basis.nf ? factors_prev[static_cast<size_t>(f) * S + s] : 0.0f;
  stt::design_row(basis, spot_prev[s], fac, mean_prev, std_prev, dm);
#pragma unroll
  for (int k = 0; k < stt::kMaxB; ++k)
    if (k < B) dmp_tile[k * kThreads + tid] = valid ? dm[k] : 0.0f;
  const float sp = spot[s];
#pragma unroll
  for (int f = 0; f < stt::kMaxF; ++f)
    fac[f] = f < basis.nf ? factors[static_cast<size_t>(f) * S + s] : 0.0f;
  stt::design_row(basis, sp, fac, mean, stdv, dm);"""

# name: (group, source file, patches); "first" patches the --first-csrc
# sources, "new" the repository's.
VARIANTS = {
    "B": ("first", "decision_kernel.cu", []),
    "B_nodots": ("first", "decision_kernel.cu", [(_B_DOTS, "    acc = x[tid] * y[tid];")]),
    "B_noepi": ("first", "decision_kernel.cu", [(_B_EPI_START, "  return;\n" + _B_EPI_START)]),
    "B_nostore": ("first", "decision_kernel.cu", [(_B_EPI_START, "  return;\n" + _B_EPI_START),
                                                  (_B_TILE, "")]),
    "D": ("first", "decision_update_kernel.cu", []),
    "D_padB": ("first", "decision_update_kernel.cu", [(_D_SMEM, _D_SMEM[:-1] + " + kProbePad;")]),
    "D_pad72k": ("first", "decision_update_kernel.cu", [(_D_SMEM, _D_SMEM[:-1] + " + 72 * 1024;")]),
    "D_l1tab": ("first", "decision_update_kernel.cu", [
        (_D_TABLES, "  const stt::DecisionTables tab{const_cast<float*>(dci_g), "
                    "const_cast<float*>(a_g), const_cast<float*>(b_g), const_cast<float*>(w_hi_g), "
                    "const_cast<int*>(idx_lo_g)};"),
        (_D_SMEM, "const size_t smem = 0;"),
    ]),
    "D_prefetch": ("first", "decision_update_kernel.cu", [(_D_LOOP, """  for (int g = 0; g < G; ++g) {
    if (g + 1 < G) {
      for (int d = 0; d < D; ++d) {
        const float* row = v + static_cast<size_t>(tab.idx_lo[(g + 1) * D + d]) * S + s;
        asm volatile("prefetch.global.L1 [%0];" ::"l"(row));
        asm volatile("prefetch.global.L1 [%0];" ::"l"(row + S));
      }
    }
    best_out[static_cast<size_t>(g) * S + s] = stt::decide(tab, G, D, B, g, v, S, s, sp, dm);
  }""")]),
    "Bnew": ("new", "decision_kernel.cu", []),
    "Bnew_noprod": ("new", "decision_kernel.cu", [(_N_PROD, "")]),
    "Bnew_designrow": ("new", "decision_kernel.cu", [(_N_DESIGN, _N_DESIGN_ROW)]),
    "Bnew_7blocks": ("new", "decision_kernel.cu", [(_N_BLOCKS, "constexpr int kMinBlocks = 7;")]),
}

# The occupancy query appended to each variant: blocks per SM, shared memory
# per block (static and dynamic), registers and local bytes of the variant's
# kernel, as its own launch sizes it.
_QUERY = """
extern "C" int probe_occupancy(int G, int D, int B, int* out) {
  %(smem)s
  cudaError_t err = cudaFuncSetAttribute(%(kernel)s, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], %(kernel)s, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, %(kernel)s);
  out[1] = static_cast<int>(smem + attr.sharedSizeBytes);
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(err);
}
"""
_NEW_B_SMEM = ("  const size_t smem =\n      sizeof(float) * (smem_fixed_words(B) + "
               "smem_words_per_grid_point(D, B) * G);")


def kernel_name(file: str) -> str:
    return "decision_moments_kernel" if file == "decision_kernel.cu" else "decision_update_kernel"


def patched_source(csrc: Path, name: str, pad: int) -> str:
    group, file, patches = VARIANTS[name]
    text = (csrc / file).read_text()
    for anchor, repl in patches:
        if text.count(anchor) != 1:
            raise RuntimeError(f"{name}: anchor not found once in {file}: {anchor[:60]!r}")
        text = text.replace(anchor, repl)
    if file == "decision_update_kernel.cu":
        smem = next(ln for ln in text.splitlines() if "const size_t smem" in ln).strip()
    elif group == "first":
        smem = _B_SMEM.strip().replace("decision_tables_words", "stt::decision_tables_words")
    else:
        smem = _NEW_B_SMEM.strip()
    return (f"namespace {{ constexpr unsigned long long kProbePad = {pad}; }}\n" + text
            + _QUERY.replace("%(smem)s", smem).replace("%(kernel)s", kernel_name(file)))


def build_all(csrc: dict, pads: dict):
    from storage_tpu_torch.ops import _build

    nvcc = _build.find_nvcc()
    procs = {}
    for name, (group, file, _) in VARIANTS.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        src = d / file
        src.write_text(patched_source(csrc[group], name, pads[group]))
        procs[name] = subprocess.Popen(
            [nvcc, *_build.COMPILE_FLAGS, "-shared", "-I", str(csrc[group]), "-o",
             str(d / "lib.so"), str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, ptxas, sass = {}, {}, {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        ptxas[name] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        for fn, argtypes in _build.SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
        lib.probe_occupancy.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.probe_occupancy.restype = ctypes.c_int
        libs[name] = lib
        sass[name] = _build.sass_instructions(OUT / name / "lib.so", kernel_name(VARIANTS[name][1]))
    return libs, ptxas, sass


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--first-csrc", type=Path,
                    default=REPO / "build" / "parent" / "storage_tpu_torch" / "csrc",
                    help="csrc directory of commit 26161f5")
    ap.add_argument("--repeats", type=int, default=20)
    args = ap.parse_args(argv[1:])
    import torch

    if not torch.cuda.is_available():
        print("decision probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    import storage_tpu_torch as pkg
    from storage_tpu_torch.engines import lsmc as engine
    from storage_tpu_torch.ops import _build

    device = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(card, flush=True)
    g, d, b_dim = chip_smoke.NUM_GRID, 3, 9
    tables = d * g * b_dim + 4 * d * g
    # Kernel B's shared memory beyond the tables: the first design's, the new one's.
    pads = {"first": 4 * (4 * b_dim + (g + b_dim) * 129), "new": 4 * (b_dim + 8) * 128}
    libs, ptxas, sass = build_all({"first": args.first_csrc,
                                   "new": REPO / "storage_tpu_torch" / "csrc"}, pads)
    with engine.full_f32_matmul():
        st = chip_smoke.backward_step_inputs(pkg, device)
    (v, spot, factors, spot_prev, factors_prev, mean, std, mean_p, std_p, idx_lo, w_hi, ci, a, b,
     monomials) = st.args_b
    s, f = v.shape[1], factors.shape[0]
    dci = (ci - ci[0:1]).contiguous()
    table = _build.basis_table(tuple(monomials), f)
    # Kernel D at B=9: the step's 9-term design, standardised, as [B, S].
    dm9 = engine._standardised_design_t(monomials, spot, factors, mean, std).contiguous()
    _, dm4, spot4, idx4, w4, ci4, a4, b4 = st.args_d
    dci4 = (ci4 - ci4[0:1]).contiguous()
    nblk = -(-s // 128)
    partials = torch.empty((b_dim * b_dim + g * b_dim) * nblk, device=device)
    moments = torch.empty(b_dim * b_dim + g * b_dim, device=device)
    stream = _build.stream_handle(device)

    def call(name, out, spot_only=False):
        lib = libs[name]
        if name.startswith("B"):
            rc = lib.stt_decision_update_moments(
                g, s, f, d, table, v.data_ptr(), spot.data_ptr(), factors.data_ptr(),
                spot_prev.data_ptr(), factors_prev.data_ptr(), mean.data_ptr(), std.data_ptr(),
                mean_p.data_ptr(), std_p.data_ptr(), idx_lo.data_ptr(), w_hi.data_ptr(),
                dci.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(), partials.data_ptr(),
                moments.data_ptr(), stream)
        elif spot_only:
            rc = lib.stt_decision_update(g, s, d, 4, v.data_ptr(), dm4.data_ptr(), spot4.data_ptr(),
                                         idx4.data_ptr(), w4.data_ptr(), dci4.data_ptr(),
                                         a4.data_ptr(), b4.data_ptr(), out.data_ptr(), stream)
        else:
            rc = lib.stt_decision_update(g, s, d, b_dim, v.data_ptr(), dm9.data_ptr(),
                                         spot.data_ptr(), idx_lo.data_ptr(), w_hi.data_ptr(),
                                         dci.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                         stream)
        _build.check(rc, name)

    rows = []
    ref = {}
    for name in [*VARIANTS, "D_b4"]:
        lib_name = "D" if name == "D_b4" else name
        occ = (ctypes.c_int * 4)()
        _build.check(libs[lib_name].probe_occupancy(g, d, 4 if name == "D_b4" else b_dim,
                                                    ctypes.addressof(occ)), name)
        out = torch.empty_like(v)
        fn = lambda: call(lib_name, out, spot_only=name == "D_b4")  # noqa: E731
        fn()
        torch.cuda.synchronize()
        family = "D_b4" if name == "D_b4" else name[0]  # every B and every D variant alike
        ref.setdefault(family, out.clone())
        same = bool(torch.equal(out, ref[family]))
        ms = chip_smoke.cuda_ms(fn, args.repeats)
        row = dict(variant=name, blocks_per_sm=occ[0], smem_bytes=occ[1], registers=occ[2],
                   local_bytes=occ[3], sass_instructions=sass[lib_name], ms=ms,
                   best_act_equal_to_unpatched=same)
        rows.append(row)
        print(f"{name:15s} blocks/SM {occ[0]:2d}  smem {occ[1]:6d} B  regs {occ[2]:3d}  "
              f"local {occ[3]:3d} B  SASS {sass[lib_name]:6d}  {ms:.4f} ms  "
              f"best_act as unpatched: {same}", flush=True)
    report = dict(card=card, kind=torch.cuda.get_device_name(0),
                  shapes=dict(G=g, S=s, D=d, B=b_dim, F=f), tables_bytes=4 * tables, variants=rows,
                  ptxas={k: [ln.strip() for ln in v_.splitlines() if "registers" in ln or "spill" in ln]
                         for k, v_ in ptxas.items()})
    (OUT / "decision_probe.json").write_text(json.dumps(report, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
