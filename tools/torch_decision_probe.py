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
register caps: E's solve, then a wide body) at step t = 180 of the caps
phase's two valuations (``chip_smoke.wide_step_args``: 20 terms on the
headline's 3 factors and 13 terms on the 10-factor model, at G = 100 with
S = 262,144 and G = 1,000 with S = 65,536) and at 32 terms on the first
one's paths (G = 100): on the rule's route, each grid route forced where G
fits it and, where the checkout has it, the shared row forced
(``"wide-smem-large"``), with CUDA events (the mean of ``--repeats`` calls
after a warm-up), each of E's kernels' own device time a call on the
rule's route (solve, interpolation, body, reduce; torch.profiler), blocks
per SM, shared memory and registers (``kernel_info``) and a SHA-256 digest
of every output, held to the first run's digest at each case.
``--repo`` names the checkout to import (the tool's own by default): run
it on a parent checkout and this one in turns (parent, change, change,
parent) in one call to compare times and digests.  ``--variants`` builds
text-patched variants of the checkout's ``decision_kernel.cu`` (with its
``fullstep_kernel.cu`` and ``common.cu``) into
``build/decision_probe/<variant>/`` and times each in place of the
checkout's library (``WIDE_VARIANTS``; a variant whose anchor the checkout
lacks is skipped): the shared row's register cap (``wide_cap<n>``) and,
on that body, the moments compiled out (``wide_noprod``, timing only) or
step t's row copied into registers (``wide_regrow``, ``wide_regrow16``,
at 20 and 13 terms: the same bits); the register row's caps
(``regcap<n>``, every padded size).  The report goes to
``build/decision_probe/wide_probe_<checkout>.json``.  With ``--moments``
as well it times kernel B's wide body without E's solve
(``decision_update_moments`` past the caps, ``moments_plan``'s route) on
the same cases, its coefficients the regression of the case's moments
(``fit_from_moments``), into ``wide_moments_probe_<checkout>.json``.

    python3 tools/torch_decision_probe.py [--repeats 20]
    python3 tools/torch_decision_probe.py --wide [--repo build/parent] [--variants regcap6 regcap8]
    python3 tools/torch_decision_probe.py --wide --moments
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
if "--repo" in sys.argv:  # the checkout whose package the probe imports and patches
    REPO = Path(sys.argv[sys.argv.index("--repo") + 1]).resolve()
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


# Kernel E's wide route.  Variants of decision_kernel.cu for it: (patches,
# the bases (terms) whose cases the variant runs, whether its outputs must
# keep the checkout's bits).  A patch is (regex, replacement), the regex
# found exactly once.
_N_WIDE_BLOCKS = r"constexpr int kWideMinBlocks = \d+;"
_N_WIDE_PROD = r"\n      tile_product_wide\(best_tile, rows, dmp_tile, B, row \+ g0 \* B\);\n"
_N_WIDE_ROW = r"  const stt::SharedRow<kThreads> dm\{dm_tile \+ tid, Bp\};\n"
_N_WIDE_REG_BLOCKS = r"constexpr int kWideRegMinBlocks\[2\] = \{[\d, ]+\};"


def _register_row(bp: int) -> str:
    """The shared row's entries copied into a register row of bp terms (the
    probed case's padded size: the same gaps, so the same bits)."""
    return (f"  stt::RegisterRow<{bp}> dm;\n#pragma unroll\n  for (int k = 0; k < {bp}; ++k) "
            f"dm.dm[k] = dm_tile[k * kThreads + tid];\n")


WIDE_VARIANTS = {
    "wide": ([], None, True),
    # The shared-row body: the moments' products compiled out (timing
    # only), or the row of step t in registers.
    "wide_noprod": ([(_N_WIDE_PROD, "\n")], None, False),
    "wide_regrow": ([(_N_WIDE_ROW, _register_row(20))], (20,), True),
    "wide_regrow16": ([(_N_WIDE_ROW, _register_row(16))], (13,), True),
    **{f"wide_cap{n}": ([(_N_WIDE_BLOCKS, f"constexpr int kWideMinBlocks = {n};")], None, True)
       for n in (4, 5, 6, 7, 8)},
    # The register row's cap (kWideRegMinBlocks, every padded size at once).
    **{f"regcap{n}": ([(_N_WIDE_REG_BLOCKS, f"constexpr int kWideRegMinBlocks[2] = {{{n}, {n}}};")],
                      None, True) for n in (4, 5, 6, 7, 8, 9)},
}
WIDE_SOURCES = ("decision_kernel.cu", "fullstep_kernel.cu", "common.cu")
# Kernel E's wide kernels, by the fragment of their mangled names.
WIDE_KERNELS = ("fullstep_solve_kernel", "fullstep_interp_kernel", "decision_moments_wide",
                "decision_moments_tiled_kernel", "reduce_rows_kernel")


def wide_patched(name: str) -> str | None:
    text = (CSRC / SOURCE).read_text()
    for anchor, repl in WIDE_VARIANTS[name][0]:
        if len(re.findall(anchor, text)) != 1:
            return None
        text = re.sub(anchor, lambda _m, r=repl: r, text)
    return text


def build_wide(names):
    """One library a variant of ``WIDE_VARIANTS`` (a variant whose anchor
    the checkout lacks is skipped), all built at once: ({name: (library,
    ptxas report)}, [skipped])."""
    from storage_tpu_torch.ops import _build

    nvcc = _build.find_nvcc()
    procs, skipped = {}, []
    for name in names:
        text = wide_patched(name)
        if text is None:
            skipped.append(name)
            continue
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / SOURCE).write_text(text)
        srcs = [d / SOURCE] + [CSRC / n for n in WIDE_SOURCES[1:]]
        procs[name] = subprocess.Popen(
            [nvcc, *_build.COMPILE_FLAGS, "-shared", "-I", str(CSRC), "-o", str(d / "lib.so"),
             *map(str, srcs)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        for fn in ("stt_decision_update_fullstep_wide", "stt_decision_update_moments_wide_info",
                   "stt_smem_limit"):
            getattr(lib, fn).argtypes = list(_build.SIGNATURES[fn])
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = (lib, ptxas_kernels(log))
    return libs, skipped


def device_split(fn, calls: int) -> dict:
    """Own device ms a call of each of kernel E's kernels in ``calls`` calls
    of ``fn`` under torch.profiler (``WIDE_KERNELS``), and the launches the
    profiler saw a call: below 1 where it dropped events, and the ms with
    them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        for frag in WIDE_KERNELS:
            if frag in e.key:
                ms, n = out.get(frag, (0.0, 0))
                out[frag] = (ms + e.self_device_time_total / 1e3 / calls, n + e.count / calls)
    return {k: dict(ms=ms, launches=n) for k, (ms, n) in out.items()}


def digest(outputs) -> str:
    """SHA-256 of the bytes of every output, in order (16 hex digits)."""
    import hashlib

    h = hashlib.sha256()
    for t in outputs:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


WIDE_CASES = ((20, 3, 100), (20, 3, 1_000), (13, 10, 100), (13, 10, 1_000), (32, 3, 100))


def wide_cases(device):
    """{(B, F, G): (args, prev)} of kernel E at step t = 180 of the caps
    phase's two valuations (``chip_smoke.wide_step_args``), and at 32 terms
    on the first one's paths: S=262,144 at G=100, 65,536 at G=1,000."""
    import torch

    import chip_smoke
    import storage_tpu_torch as pkg
    from storage_tpu_torch.basis import parse_basis_functions
    from storage_tpu_torch.engines import lsmc as engine
    from storage_tpu_torch.models import spot_sim

    with engine.full_f32_matmul():
        st = chip_smoke.backward_step_inputs(pkg, device)
    inputs = st.inputs
    arrays = {g: engine.build_engine_arrays(
        inputs.compiled, inputs.fwd, inputs.df_settle, inputs.df_flow, inputs.inventory_lower,
        inputs.inventory_upper, g, torch.float32, device) for g in (100, 1_000)}
    _, sim10 = chip_smoke.ten_factor_inputs(pkg, device)
    sims = {3: st.sims, chip_smoke.TEN_FACTORS: spot_sim.simulate_ou_paths(
        spot_sim.key_from_seed(11), torch.arange(chip_smoke.NUM_SIMS, device=device), *sim10)}
    # 32 terms: the first of the full cubic in the spot and the 3 factors.
    bases = {20: chip_smoke.BASIS_20, 13: chip_smoke.BASIS_10F,
             32: " + ".join(chip_smoke.full_cubic_basis().split(" + ")[:32])}
    cases = {}
    for b, f, g in WIDE_CASES:
        mono = tuple(parse_basis_functions(bases[b]))
        s = chip_smoke.NUM_SIMS if g == 100 else chip_smoke.BIG_SIMS
        with engine.full_f32_matmul():
            cases[b, f, g] = chip_smoke.wide_step_args(device, mono, sims[f], arrays[g], st.t, s,
                                                       seed=5 + g)
    return cases


def moments_case(args, prev):
    """Kernel B's arguments from kernel E's (``wide_step_args``): the same
    step, its coefficients the regression of E's carried moments."""
    from storage_tpu_torch.ops import interp
    from storage_tpu_torch.ops.regression import fit_from_moments

    v, spot, factors, spot_p, factors_p, xtx, xty, mean, std, idx_lo, w_hi, a, b, mono = args
    ci = interp.interp_coeffs(fit_from_moments(xtx, xty), idx_lo, w_hi)
    return (v, spot, factors, spot_p, factors_p, mean, std, prev["mean_prev"], prev["std_prev"],
            idx_lo, w_hi, ci, a, b, mono), {}


def wide_main(repeats: int, names, moments: bool = False) -> int:
    """Kernel E's wide route at ``WIDE_CASES`` (with ``moments``, kernel B's
    wide body without the solve): the checkout's own library (``names``
    empty), or text-patched variants of its decision_kernel.cu."""
    import torch

    sys.path.insert(0, str(REPO))
    import chip_smoke
    from storage_tpu_torch.ops import _build, decision_kernel

    device = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(f"{card}\ncheckout {REPO}", flush=True)
    if names:
        libs, skipped = build_wide(names)
        for name in skipped:
            print(f"{name}: skipped (its anchor is not in {SOURCE})", flush=True)
    else:
        libs = {"checkout": (_build.library(), None)}
    cases = wide_cases(device)
    fe = decision_kernel.decision_update_fullstep
    if moments:
        cases = {k: moments_case(*v) for k, v in cases.items()}
        fe = decision_kernel.decision_update_moments
    library = _build.library
    smem = _build.smem_limit(device)
    rows, ref = [], {}
    try:
        for (b, f, g), (args, prev) in cases.items():
            fits = decision_kernel.wide_max_grid(3, b, f, smem)
            if not moments:
                fits = min(fits, decision_kernel.solve_max_grid(b, smem))
            out = torch.empty_like(args[0])
            routes = (None, "shared", "large") if g <= fits else (None,)
            # The shared row forced, where the checkout has it beside the
            # register row.
            if "wide-smem-large" in getattr(decision_kernel, "WIDE_ROUTES", ()):
                routes += ("wide-smem-large",)
            for route in routes:
                plan = (decision_kernel.moments_plan(g, 3, b, f, smem, route=route) if moments
                        else decision_kernel.fullstep_route(g, 3, b, smem, route=route,
                                                            num_factors=f))
                for name, (lib, ptxas) in libs.items():
                    cases_of = WIDE_VARIANTS[name][1] if name in WIDE_VARIANTS else None
                    if cases_of is not None and b not in cases_of:
                        continue
                    _build.library = lambda lib=lib: lib
                    decision_kernel._kernel_info.cache_clear()
                    call = (lambda r_=route: fe(*args, **prev, out=out, route=r_))
                    got = digest(call())
                    same = ref.setdefault((b, f, g), got) == got
                    ms = chip_smoke.cuda_ms(call, repeats)
                    split = device_split(call, repeats) if route is None else {}
                    row = dict(variant=name, B=b, F=f, G=g, S=args[0].shape[1],
                               route=route or "rule", grid_route=plan.name, tile=plan.tile,
                               body=getattr(plan, "body", "wide" if plan.wide else "register"),
                               ms=ms, split=split, digest=got, same_bits_as_first=same)
                    if ptxas is not None:
                        regs = {k: r for k, r in ptxas.items() if "decision_moments" in k}
                        row["ptxas_body"] = regs
                    body = {"body": row["body"]} if hasattr(plan, "body") else {}
                    info = decision_kernel.kernel_info("wide", plan.tile, 3, b, device,
                                                       num_factors=f, **body)
                    row.update(blocks_per_sm=info["blocks_per_sm"],
                               smem_bytes=info["smem_bytes"], registers=info["registers"])
                    rows.append(row)
                    parts = "  ".join(f"{k} {v['ms']:.4f} ms x{v['launches']:.2f}"
                                      for k, v in split.items())
                    print(f"{name:14s} B={b:2d} F={f:2d} G={g:5d} {row['route']:6s} "
                          f"{plan.name:6s} body {row['body']:10s} blocks/SM "
                          f"{row.get('blocks_per_sm', '-')}  regs {row.get('registers', '-')}  "
                          f"{ms:.4f} ms  digest {got}  same bits: {same}"
                          + (f"\n    own device time a call: {parts}" if parts else ""),
                          flush=True)
                    keep = WIDE_VARIANTS[name][2] if name in WIDE_VARIANTS else True
                    if keep and not same:
                        raise AssertionError(f"{name} at B={b}, F={f}, G={g}, route {route} "
                                             f"parts from the bits")
            del out
    finally:
        _build.library = library
        decision_kernel._kernel_info.cache_clear()
    report = dict(card=card, kind=torch.cuda.get_device_name(0), checkout=str(REPO), rows=rows)
    OUT.mkdir(parents=True, exist_ok=True)
    kind = "wide_moments" if moments else "wide"
    (OUT / f"{kind}_probe_{REPO.name or 'repo'}.json").write_text(json.dumps(report, indent=1))
    print(card)
    return 0


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--wide", action="store_true",
                    help="time kernel E's wide route (WIDE_CASES)")
    ap.add_argument("--moments", action="store_true",
                    help="with --wide, kernel B's wide body without E's solve")
    ap.add_argument("--variants", nargs="*", default=(), choices=list(WIDE_VARIANTS),
                    help="with --wide, variants of decision_kernel.cu to build and time")
    ap.add_argument("--repo", default=str(REPO), help="the checkout to import and patch")
    args = ap.parse_args(argv[1:])
    import torch

    if args.wide and torch.cuda.is_available():
        return wide_main(args.repeats, args.variants, args.moments)

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
