#!/usr/bin/env python3
"""Separates what holds back kernel B of ``storage_tpu_torch`` (and kernel E,
which launches B's kernel after its solve) on one NVIDIA GPU, at the main
path's shapes (G=100, S=262,144, D=3, B=9, F=3).

It builds variants of ``storage_tpu_torch/csrc/decision_kernel.cu``, each
from a text patch of the repository's source, into
``build/decision_probe/<variant>/`` and times each on the same inputs
(``chip_smoke.backward_step_inputs``, the headline's step t = 180) with
CUDA events:

  Bnew           kernel B as it is;
  Bnew_noprod    without the per-chunk moment products of the shared route
                 (timing only: the moments are not written);
  Bnew_7blocks   with registers capped for 7 blocks per SM instead of 9;
  Bnew_group2    the decision loop's grid points in groups of 2 instead of 4;
  Bnew_group8    in groups of 8 (one group a chunk of kChunk = 8);
  Bnew_b16       every basis size on the kernel compiled for 16 terms (one
                 kernel for every B) instead of the one for its padded size.

Variants whose anchor the source lacks are skipped with a note.  For each
it prints blocks per SM and shared memory per block (the variant's own
``stt_decision_update_moments_info``), registers and spill bytes (its
``ptxas`` report), the shared route's SASS instruction count and the mean
milliseconds a launch, and holds every output to the unpatched kernel's
bits (timing-only variants excepted).  The report goes to
``build/decision_probe/decision_probe.json``.

With ``--wide`` it times kernel E's wide route instead (past kernel B's
register caps: B's wide body after E's solve), built with its registers
capped for each of ``WIDE_MIN_BLOCKS`` blocks per SM (``kWideMinBlocks``
patched in ``decision_kernel.cu``, compiled with ``fullstep_kernel.cu`` and
``common.cu``), at S=262,144 and step t = 180 of the caps phase's two
valuations (``chip_smoke.wide_step_args``: 20 terms on the headline's 3
factors, 13 terms on the 10-factor model) at G = 100 (the shared route) and
G = 1,000 (the large route), each also forced onto the other grid route
where G fits it: registers, spills, blocks per SM, ms, every output held to
the first variant's bits (``build/decision_probe/wide_probe.json``).

    python3 tools/torch_decision_probe.py [--repeats 20] [--wide]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "storage_tpu_torch" / "csrc"
OUT = REPO / "build" / "decision_probe"
SOURCE = "decision_kernel.cu"

# Text patches: (anchor, replacement); each anchor must occur once.
_N_PROD = "\n    tile_product(best_tile, rows, dmp_tile, B, row + g0 * B);\n"
_N_BLOCKS = "constexpr int kMinBlocks = 9;"
_N_GROUP = "constexpr int kGroup = 4;"
_N_SELECT = "  switch (stt::padded_basis(B)) {"

# name: (patches, whether the outputs must keep the unpatched kernel's bits)
VARIANTS = {
    "Bnew": ([], True),
    "Bnew_noprod": ([(_N_PROD, "\n")], False),
    "Bnew_7blocks": ([(_N_BLOCKS, "constexpr int kMinBlocks = 7;")], True),
    "Bnew_group2": ([(_N_GROUP, "constexpr int kGroup = 2;")], True),
    "Bnew_group8": ([(_N_GROUP, "constexpr int kGroup = 8;")], True),
    "Bnew_b16": ([(_N_SELECT, "  switch (16) {")], True),
}


def patched_source(name: str) -> str | None:
    text = (CSRC / SOURCE).read_text()
    for anchor, repl in VARIANTS[name][0]:
        if text.count(anchor) != 1:
            return None
        text = text.replace(anchor, repl)
    return text


def ptxas_kernels(log: str) -> dict:
    """{mangled kernel name: (registers, spill store bytes)} of a ptxas log."""
    out, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and current:
            out[current] = (out.get(current, (0, 0))[0], int(m.group(1)))
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            out[current] = (int(m.group(1)), out.get(current, (0, 0))[1])
    return out


def build_all():
    from storage_tpu_torch.ops import _build

    nvcc = _build.find_nvcc()
    procs, skipped = {}, []
    for name in VARIANTS:
        text = patched_source(name)
        if text is None:
            skipped.append(name)
            continue
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / SOURCE).write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.COMPILE_FLAGS, "-shared", "-I", str(CSRC), "-o", str(d / "lib.so"),
             str(d / SOURCE)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, ptxas = {}, {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-4000:]}")
        ptxas[name] = ptxas_kernels(log)
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        for fn in ("stt_decision_update_moments", "stt_decision_update_moments_info"):
            getattr(lib, fn).argtypes = list(_build.SIGNATURES[fn])
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs, ptxas, skipped


# Kernel E's wide route: its body's register cap, in blocks per SM.
_N_WIDE_BLOCKS = r"constexpr int kWideMinBlocks = \d+;"
WIDE_MIN_BLOCKS = (2, 3, 4, 5, 6, 8)
WIDE_SOURCES = ("decision_kernel.cu", "fullstep_kernel.cu", "common.cu")


def build_wide():
    """One library a register cap of the wide body (``WIDE_MIN_BLOCKS``),
    all built at once: {blocks: (library, ptxas report)}."""
    from storage_tpu_torch.ops import _build

    text = (CSRC / SOURCE).read_text()
    if len(re.findall(_N_WIDE_BLOCKS, text)) != 1:
        raise RuntimeError(f"{SOURCE} lacks the anchor {_N_WIDE_BLOCKS!r}")
    nvcc = _build.find_nvcc()
    procs = {}
    for blocks in WIDE_MIN_BLOCKS:
        d = OUT / f"wide_{blocks}"
        d.mkdir(parents=True, exist_ok=True)
        (d / SOURCE).write_text(re.sub(_N_WIDE_BLOCKS,
                                       f"constexpr int kWideMinBlocks = {blocks};", text))
        srcs = [d / SOURCE] + [CSRC / name for name in WIDE_SOURCES[1:]]
        procs[blocks] = subprocess.Popen(
            [nvcc, *_build.COMPILE_FLAGS, "-shared", "-I", str(CSRC), "-o", str(d / "lib.so"),
             *map(str, srcs)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for blocks, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on kWideMinBlocks = {blocks}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(OUT / f"wide_{blocks}" / "lib.so"))
        for fn in ("stt_decision_update_fullstep_wide", "stt_decision_update_moments_wide_info",
                   "stt_smem_limit"):
            getattr(lib, fn).argtypes = list(_build.SIGNATURES[fn])
            getattr(lib, fn).restype = ctypes.c_int
        libs[blocks] = (lib, ptxas_kernels(log))
    return libs


def wide_main(repeats: int) -> int:
    import torch

    sys.path.insert(0, str(REPO))
    import chip_smoke
    import storage_tpu_torch as pkg
    from storage_tpu_torch.basis import parse_basis_functions
    from storage_tpu_torch.engines import lsmc as engine
    from storage_tpu_torch.models import spot_sim
    from storage_tpu_torch.ops import _build, decision_kernel

    device = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(card, flush=True)
    libs = build_wide()
    with engine.full_f32_matmul():
        st = chip_smoke.backward_step_inputs(pkg, device)
    inputs = st.inputs
    arrays = {g: engine.build_engine_arrays(
        inputs.compiled, inputs.fwd, inputs.df_settle, inputs.df_flow, inputs.inventory_lower,
        inputs.inventory_upper, g, torch.float32, device) for g in (100, 1_000)}
    _, sim10 = chip_smoke.ten_factor_inputs(pkg, device)
    sims = {3: st.sims, chip_smoke.TEN_FACTORS: spot_sim.simulate_ou_paths(
        spot_sim.key_from_seed(11), torch.arange(chip_smoke.NUM_SIMS, device=device), *sim10)}
    fe = decision_kernel.decision_update_fullstep
    library = _build.library
    rows = []
    try:
        for basis, f in ((chip_smoke.BASIS_20, 3), (chip_smoke.BASIS_10F, chip_smoke.TEN_FACTORS)):
            mono = tuple(parse_basis_functions(basis))
            for g in (100, 1_000):
                with engine.full_f32_matmul():
                    args, prev = chip_smoke.wide_step_args(device, mono, sims[f], arrays[g],
                                                           st.t, chip_smoke.NUM_SIMS, seed=5)
                smem = _build.smem_limit(device)
                fits = min(decision_kernel.wide_max_grid(3, len(mono), f, smem),
                           decision_kernel.solve_max_grid(len(mono), smem))
                out, ref = torch.empty_like(args[0]), None
                for route in ("shared", "large") if g <= fits else ("large",):
                    plan = decision_kernel.fullstep_route(g, 3, len(mono), smem, route=route,
                                                          num_factors=f)
                    for blocks, (lib, ptxas) in libs.items():
                        _build.library = lambda lib=lib: lib
                        got = [t.clone() for t in fe(*args, **prev, out=out, route=route)]
                        ref = ref or got
                        same = all(torch.equal(x, y) for x, y in zip(got, ref))
                        ms = chip_smoke.cuda_ms(lambda: fe(*args, **prev, out=out, route=route),
                                                repeats)
                        info = (ctypes.c_int * 6)()
                        _build.check(lib.stt_decision_update_moments_wide_info(
                            plan.tile, 3, len(mono), f, info), "wide info")
                        regs, spill = next(r for k, r in ptxas.items()
                                           if "decision_moments_wide_kernel" in k)
                        row = dict(B=len(mono), F=f, G=g, route=plan.name, tile=plan.tile,
                                   min_blocks=blocks, blocks_per_sm=info[4], smem_bytes=info[1],
                                   registers=regs, ptxas_spill_bytes=spill, ms=ms,
                                   outputs_equal_to_first=same)
                        rows.append(row)
                        print(f"B={len(mono):2d} F={f:2d} G={g:5d} {plan.name:6s} kWideMinBlocks "
                              f"{blocks}: blocks/SM {info[4]:2d}  smem {info[1]:6d} B  regs "
                              f"{regs:3d}  spill {spill:3d} B  {ms:.4f} ms  outputs as the "
                              f"first: {same}", flush=True)
                        if not same:
                            raise AssertionError(f"kWideMinBlocks = {blocks} on the {route} route "
                                                 f"parts from the bits")
                del args, prev, out, ref
    finally:
        _build.library = library
    report = dict(card=card, kind=torch.cuda.get_device_name(0), rows=rows)
    (OUT / "wide_probe.json").write_text(json.dumps(report, indent=1))
    print(card)
    return 0


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--wide", action="store_true",
                    help="time kernel E's wide route over its register caps")
    args = ap.parse_args(argv[1:])
    import torch

    if args.wide and torch.cuda.is_available():
        return wide_main(args.repeats)

    if not torch.cuda.is_available():
        print("decision probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    import storage_tpu_torch as pkg
    from storage_tpu_torch.engines import lsmc as engine
    from storage_tpu_torch.ops import _build, decision_kernel

    device = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(card, flush=True)
    libs, ptxas, skipped = build_all()
    for name in skipped:
        print(f"{name}: skipped (its anchor is not in {SOURCE})", flush=True)
    with engine.full_f32_matmul():
        st = chip_smoke.backward_step_inputs(pkg, device)
    (v, spot, factors, spot_prev, factors_prev, mean, std, mean_p, std_p, idx_lo, w_hi, ci, a, b,
     monomials) = st.args_b
    (g, s), f, d, b_dim = v.shape, factors.shape[0], ci.shape[0], len(monomials)
    dci = (ci - ci[0:1]).contiguous()
    table = _build.basis_table(tuple(monomials), f)
    stream = _build.stream_handle(device)
    bp = -(-b_dim // 4) * 4

    rows, ref = [], None
    for name, lib in libs.items():
        partials, moments = decision_kernel.moments_scratch(g, b_dim, s, device)
        out = torch.empty_like(v)

        def call():
            _build.check(lib.stt_decision_update_moments(
                g, g, s, f, d, table, v.data_ptr(), spot.data_ptr(), factors.data_ptr(),
                spot_prev.data_ptr(), factors_prev.data_ptr(), mean.data_ptr(), std.data_ptr(),
                mean_p.data_ptr(), std_p.data_ptr(), idx_lo.data_ptr(), w_hi.data_ptr(),
                dci.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(), partials.data_ptr(),
                moments.data_ptr(), stream), name)

        call()
        torch.cuda.synchronize()
        outputs = (out.clone(), moments.clone())
        ref = ref or outputs
        same = all(torch.equal(x, y) for x, y in zip(outputs, ref))
        if VARIANTS[name][1] and not same:
            raise AssertionError(f"{name} parts from the unpatched kernel's bits")
        ms = chip_smoke.cuda_ms(call, args.repeats)
        info = (ctypes.c_int * 6)()
        _build.check(lib.stt_decision_update_moments_info(g, d, b_dim, 0, info), name)
        # The shared route's kernel at this basis size (every instantiation
        # shares the name; the b16 variant runs the 16-term one).
        size = 16 if name == "Bnew_b16" else bp
        kernels = {k: r for k, r in ptxas[name].items()
                   if "decision_moments_kernel" in k and f"ILi{size}E" in k}
        if not kernels:  # a kernel compiled for one size only
            kernels = {k: r for k, r in ptxas[name].items() if "decision_moments_kernel" in k}
        kernel = next(iter(kernels))
        regs, spill = kernels[kernel]
        sass = _build.sass_instructions(OUT / name / "lib.so", kernel)
        row = dict(variant=name, blocks_per_sm=info[4], smem_bytes=info[1], registers=regs,
                   ptxas_spill_bytes=spill, sass_instructions=sass, ms=ms,
                   outputs_equal_to_unpatched=same)
        rows.append(row)
        print(f"{name:13s} blocks/SM {info[4]:2d}  smem {info[1]:6d} B  regs {regs:3d}  "
              f"spill {spill:3d} B  SASS {sass:6d}  {ms:.4f} ms  outputs as unpatched: {same}",
              flush=True)
        del partials, moments, out, outputs
    report = dict(card=card, kind=torch.cuda.get_device_name(0),
                  shapes=dict(G=g, S=s, D=d, B=b_dim, F=f), variants=rows, skipped=skipped)
    (OUT / "decision_probe.json").write_text(json.dumps(report, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
