#!/usr/bin/env python3
"""Times the large grid routes of kernels B, D, E and C of storage_tpu_torch
on one NVIDIA GPU, at G = 4,096 grid points and S = 262,144 sims (D = 3
decisions, the headline's 9-term basis on 3 factors; kernel D at B = 4 and
B = 9), over the tile sizes of B's and D's large routes.

For each tile T it prints the ms of one launch (CUDA events, the mean of
``--repeats`` launches after a warm-up), the blocks per SM (those of the
shared route at G = T, ``kernel_info``) and the least time the card could
take for the launch's bytes (v read and best_act written, at 3.35 TB/s),
on interpolation rows that follow g (a band of ±5 around each grid point,
as a valuation's targets give).  B and E also run at the default tile on
random rows spanning the grid; E on its large route, C in each mode over
``--steps`` steps.  The report lands in ``build/grid_probe/grid_probe.json``.

``--shared-b`` times instead kernels B, E and D (at B = 4 and 9) in the
checkout ``--repo`` names, at G = 100 (the headline's launch), 128, 200,
400, 1,000 (around the routes' crossing, each also forced onto each route
that takes it) and 4,096 (the large routes), on rows that follow g and on
random rows, and prints the route each took and SHA-256 digests of every
output: run it on two checkouts in turns in one call (parent, change,
change, parent) to compare their times, routes and bits on one card.

``--ablate-d`` builds variants of kernel D's source
(``csrc/decision_update_kernel.cu`` of ``--repo``), each from a text patch
(``D_VARIANTS``; a variant whose anchor the source lacks is skipped), into
``build/grid_probe/<variant>/`` and times each one's large route at G =
4,096 and S = 262,144, B = 4 and 9, on rows following g: ms, registers and
spills (``ptxas``), blocks per SM, and whether its best_act keeps the
unpatched kernel's bits (timing-only variants part from them).

``--c-routes`` times kernel C's three modes (monomial, general grid,
design) forced onto each route in turns (shared, large, large, shared) at
G = 100, 200, 400, 700 and 1,000 (``--grids``), the headline's 9-term basis
on 3 factors (``--basis``, ``--factors``; ``--modes`` restricts the modes):
the monomial and general modes over the 365 steps of a valuation, the
design mode over one 32-step chunk, as the generic path launches it.

    python3 tools/torch_grid_probe.py [--grid 4096] [--sims 262144]
    python3 tools/torch_grid_probe.py --shared-b --repo build/parent [--kernels D4 D9]
    python3 tools/torch_grid_probe.py --ablate-d
    python3 tools/torch_grid_probe.py --c-routes [--grids 500 600] [--modes monomial]
    python3 tools/torch_grid_probe.py --c-routes --grids 4096 --basis "1 + s + s**2 + s**3" \
        --factors 0 --modes monomial
"""
import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
if "--repo" in sys.argv:  # the checkout whose package the probe imports
    REPO = Path(sys.argv[sys.argv.index("--repo") + 1]).resolve()
sys.path.insert(0, str(REPO))

from storage_tpu_torch.basis import design_columns, parse_basis_functions  # noqa: E402
from storage_tpu_torch.ops import _build, decision_kernel, forward_kernel  # noqa: E402

BASIS_9 = "1 + x0 + x1 + x2 + x0**2 + x1**2 + x2**2 + s + s**2"
HBM_BYTES_PER_S = 3.35e12


def cuda_ms(fn, repeats: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def step_args(device, g, s, basis, seed=3, rows="band"):
    """Kernel B's arguments: random values and paths, interpolation rows in
    a band of ±5 around each grid point (``rows="band"``, as interpolated
    targets give) or random in [0, G−2] (``"random"``, spanning the grid)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    monomials = tuple(parse_basis_functions(basis))
    b, d, f = len(monomials), 3, 3
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=device)  # noqa: E731
    if rows == "band":
        idx_lo = (torch.arange(g, device=device)[:, None]
                  + torch.tensor([-5, 0, 5], device=device)[None, :]).clamp(0, g - 2)
    else:
        idx_lo = torch.randint(0, g - 1, (g, d), generator=gen, device=device)
    return (100.0 + 30.0 * rnd(g, s), 30.0 + 5.0 * rnd(s), rnd(f, s), 30.0 + 5.0 * rnd(s),
            rnd(f, s), 0.3 * rnd(b), 1.0 + 0.2 * rnd(b).abs(), 0.3 * rnd(b),
            1.0 + 0.2 * rnd(b).abs(), idx_lo.to(torch.int32).contiguous(),
            torch.rand((g, d), generator=gen, device=device), 20.0 * rnd(d, g, b),
            2.0 * rnd(d, g), 20.0 * rnd(d, g), monomials)


def bytes_bound_ms(g, s) -> float:
    return 1e3 * 8.0 * g * s / HBM_BYTES_PER_S


def fullstep_args(args):
    """Kernel E's arguments from kernel B's: the moments of the step's
    design against 0.9·v, and the next moments' stats."""
    v, spot, factors, spot_p, fac_p, mean, std, mean_p, std_p, idx_lo, w_hi, _, a, b, mono = args
    dm = decision_kernel._standardised_design(mono, spot, factors, mean, std)
    return ((v, spot, factors, spot_p, fac_p, dm.T @ dm, dm.T @ (0.9 * v.T), mean, std, idx_lo,
             w_hi, a, b, mono), dict(mean_prev=mean_p, std_prev=std_p))


def digest(outputs) -> str:
    """SHA-256 of the bytes of every output, in order."""
    h = hashlib.sha256()
    for t in outputs if isinstance(outputs, tuple) else (outputs,):
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


CROSSING_GRIDS = (100, 128, 200, 400, 1_000)


def route_taken(fn, call) -> str:
    """"large" where ``call()`` launched the wrapper ``fn``'s large route."""
    before = fn.large_launches
    call()
    return "large" if fn.large_launches > before else "shared"


def shared_b(device, sims: int, grids=(*CROSSING_GRIDS, 4_096), kernels=()) -> dict:
    """Kernels B, E and D (B = 4 and 9) at G = 100, 128, 200, 400, 1,000 and
    4,096 on both kinds of rows: ms a launch (20 launches after a warm-up,
    5 at G = 4,096), the route each took and the digest of every output; up
    to G = 1,000 also each forced onto each route that takes the shape
    (``grids``: those G alone; ``kernels``: those of "B", "E", "D4", "D9"
    alone)."""
    report = {"repo": str(REPO), "card": torch.cuda.get_device_name(0)}
    smem = _build.smem_limit(device)
    dk = decision_kernel
    for g in grids:
        repeats = 5 if g > 1_000 else 20
        for rows in ("band", "random"):
            args = step_args(device, g, sims, BASIS_9, rows=rows)
            out = torch.empty_like(args[0])
            e_args, prev = fullstep_args(args)
            calls = {
                "B": (dk.decision_update_moments, lambda **k: dk.decision_update_moments(
                    *args, out=out, **k), dk.moments_max_grid(3, 9, smem)),
                "E": (dk.decision_update_fullstep, lambda **k: dk.decision_update_fullstep(
                    *e_args, **prev, out=out, **k),
                    min(dk.moments_max_grid(3, 9, smem), dk.solve_max_grid(9, smem)))}
            for nb in (4, 9):
                gen = torch.Generator(device=device).manual_seed(5)
                d_args = (args[0], torch.randn((nb, sims), generator=gen, device=device), args[1],
                          args[9], args[10], 20.0 * torch.randn((3, g, nb), generator=gen,
                                                                device=device),
                          args[12], args[13])
                calls[f"D{nb}"] = (dk.decision_update,
                                   lambda a_=d_args, **k: dk.decision_update(*a_, out=out, **k),
                                   dk.update_max_grid(3, nb, smem))
            for name, (fn, call, fits) in calls.items():
                if kernels and name not in kernels:
                    continue
                forced = (("shared",) if g <= fits else ()) + ("large",) if g <= 1_000 else ()
                for route in (None, *forced):
                    key = f"{name}{'_' + route if route else ''}_g{g}_{rows}"
                    run = (lambda c_=call, r_=route: c_(route=r_))
                    report[f"ms_{key}"] = cuda_ms(run, repeats)
                    report[f"route_{key}"] = route_taken(fn, run)
                    report[f"digest_{key}"] = digest(run())
                    print(f"{key}: {report[f'ms_{key}']:.4f} ms, route {report[f'route_{key}']}, "
                          f"digest {report[f'digest_{key}']}", flush=True)
            del args, out, e_args, calls
            torch.cuda.empty_cache()
    return report


# Text patches of kernel D's source (anchor, replacement), each anchor found
# once; the flag says whether best_act must keep the unpatched kernel's bits.
_D_GATHER = "const float* x = v + static_cast<size_t>(best_lo[i]) * S + s;"
_D_STORE = "if (gl < nt && valid)\n      best_out["
_D_NOSTORE = "if (gl < nt && valid && cont == -1.2345e-38f)\n      best_out["
_D_STORE_LINE = ("best_out[static_cast<size_t>(g0 + gl) * S + s] = "
                 "__fadd_rn(cont, best_imm[i]);")
# Anchors in the kernel itself (the "D_" variants above patch its loop).
_DL_SWITCH = "  switch (B) {\n#define STT_UPDATE_CASE"
_DL_BLOCKS = "Bp <= 4 ? 5 : Bp <= 16 ? 4"
_DL_LOOP = """  for (int c = 0; c < ngroups; ++c)
    decide_group(c, g0, nt, S, D, bp, tab, v, s, valid, sp, dm, best_out);
}

// records[g, :]"""
_DL_HELPERS_AT = "// Blocks per SM the kernel's registers must allow"
_DL_HELPERS = """struct Pick {
  float imm[kGroup];
  float w[kGroup];
  int lo[kGroup];
};
struct Rows {
  float lo[kGroup];
  float hi[kGroup];
};
template <typename Row>
__device__ __forceinline__ Pick argmax_group(int c, int nt, int D, int bp, const float* tab,
                                             float sp, const Row& dm) {
  const int rec = record_words(D, bp);
  const float* r[kGroup];
#pragma unroll
  for (int i = 0; i < kGroup; ++i) r[i] = tab + min(c * kGroup + i, nt - 1) * rec;
  Pick p;
  float best_reg[kGroup];
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    const float4 e = *reinterpret_cast<const float4*>(r[i]);
    best_reg[i] = p.imm[i] = __fadd_rn(__fmul_rn(e.x, sp), e.y);
    p.w[i] = e.z;
    p.lo[i] = __float_as_int(e.w);
  }
#pragma unroll 1
  for (int d = 1; d < D; ++d) {
    const int off = record_offset(d, bp);
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const float* q = r[i] + off;
      const float4 e = *reinterpret_cast<const float4*>(q);
      const float gap = dm.gap(q + 4);
      const float imm = __fadd_rn(__fmul_rn(e.x, sp), e.y);
      const float vr = __fadd_rn(gap, imm);
      if (vr > best_reg[i]) {
        best_reg[i] = vr;
        p.imm[i] = imm;
        p.w[i] = e.z;
        p.lo[i] = __float_as_int(e.w);
      }
    }
  }
  return p;
}
__device__ __forceinline__ Rows request_rows(const Pick& p, const float* __restrict__ v, int S,
                                             int s) {
  Rows x;
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    const float* row = v + static_cast<size_t>(p.lo[i]) * S + s;
    x.lo[i] = __ldg(row);
    x.hi[i] = __ldg(row + S);
  }
  return x;
}
__device__ __forceinline__ void finish_group(const Pick& p, const Rows& x, int c, int g0, int nt,
                                             int S, int s, bool valid,
                                             float* __restrict__ best_out) {
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    const int gl = c * kGroup + i;
    const float cont = __fadd_rn(__fmul_rn(x.lo[i], __fsub_rn(1.0f, p.w[i])),
                                 __fmul_rn(x.hi[i], p.w[i]));
    if (gl < nt && valid)
      best_out[static_cast<size_t>(g0 + gl) * S + s] = __fadd_rn(cont, p.imm[i]);
  }
}

"""
_DL_PIPELINED = """  if constexpr (true) {
    Pick p = argmax_group(0, nt, D, bp, tab, sp, dm);
    Rows x = request_rows(p, v, S, s);
    for (int c = 1; c < ngroups; ++c) {
      const Pick next = argmax_group(c, nt, D, bp, tab, sp, dm);
      finish_group(p, x, c - 1, g0, nt, S, s, valid, best_out);
      x = request_rows(next, v, S, s);
      p = next;
    }
    finish_group(p, x, ngroups - 1, g0, nt, S, s, valid, best_out);
  } else {
    for (int c = 0; c < ngroups; ++c)
      decide_group(c, g0, nt, S, D, bp, tab, v, s, valid, sp, dm, best_out);
  }
}

// records[g, :]"""
D_VARIANTS = {
    "D": ([], True),
    # v's two gathers a grid point read one fixed row pair, coalesced and
    # independent of the argmax (L1 hits).
    "D_fixedrow": ([(_D_GATHER, "const float* x = v + s + 0 * best_lo[i];")], False),
    # best_act never stored (the loads and arithmetic kept).
    "D_nostore": ([(_D_STORE, _D_NOSTORE)], False),
    "D_fixedrow_nostore": ([(_D_GATHER, "const float* x = v + s + 0 * best_lo[i];"),
                            (_D_STORE, _D_NOSTORE)], False),
    # best_act written with streaming stores.
    "D_stcs": ([(_D_STORE_LINE, "__stcs(best_out + static_cast<size_t>(g0 + gl) * S + s, "
                                "__fadd_rn(cont, best_imm[i]));")], True),
    # The kernel ("D" above times it as it is) software-pipelined by one
    # group (c's argmax while c − 1's winner rows are in flight), at every
    # basis size or past 4;
    "DL_pipe": ([(_DL_HELPERS_AT, _DL_HELPERS + _DL_HELPERS_AT), (_DL_LOOP, _DL_PIPELINED)],
                True),
    "DL_pipe4": ([(_DL_HELPERS_AT, _DL_HELPERS + _DL_HELPERS_AT),
                  (_DL_LOOP, _DL_PIPELINED.replace("if constexpr (true)",
                                                   "if constexpr (NB == 0 || NB > 4)"))], True),
    # compiled per padded basis size, as the shared route, not per B;
    "DL_padded": ([(_DL_SWITCH, "  switch (padded_basis(B)) {\n#define STT_UPDATE_CASE")], True),
    # registers capped for one block per SM fewer or more at 5–16 terms,
    # for 4 at up to 4 terms;
    "DL_3blocks": ([(_DL_BLOCKS, "Bp <= 4 ? 5 : Bp <= 16 ? 3")], True),
    "DL_5blocks": ([(_DL_BLOCKS, "Bp <= 4 ? 5 : Bp <= 16 ? 5")], True),
    "DL_b4cap4": ([(_DL_BLOCKS, "Bp <= 4 ? 4 : Bp <= 16 ? 4")], True),
    # the blocks of one tile (all columns of sims) launched together, not
    # the tiles of one column;
    "DL_simfast": ([("const int g0 = blockIdx.x * tile;", "const int g0 = blockIdx.y * tile;"),
                    ("const int col = blockIdx.y * kThreads",
                     "const int col = blockIdx.x * kThreads"),
                    ("grid((G + tile - 1) / tile, (S + kThreads - 1) / kThreads)",
                     "grid((S + kThreads - 1) / kThreads, (G + tile - 1) / tile)")], True),
    # 2 or 8 grid points a group.
    "DL_group2": ([("constexpr int kGroup = 4;", "constexpr int kGroup = 2;")], True),
    "DL_group8": ([("constexpr int kGroup = 4;", "constexpr int kGroup = 8;")], True),
}


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


def build_variants(variants: dict, source: str, out_dir: Path):
    """Each variant of ``csrc/<source>`` built alone into a library under
    ``out_dir``, one nvcc each, all started together: ({name: CDLL},
    {name: ptxas report}, [skipped names])."""
    csrc = REPO / "storage_tpu_torch" / "csrc"
    nvcc = _build.find_nvcc()
    procs, skipped = {}, []
    for name, (patches, _) in variants.items():
        text = (csrc / source).read_text()
        if any(text.count(anchor) != 1 for anchor, _ in patches):
            skipped.append(name)
            continue
        for anchor, repl in patches:
            text = text.replace(anchor, repl)
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        (d / source).write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.COMPILE_FLAGS, "-shared", "-I", str(csrc), "-o", str(d / "lib.so"),
             str(d / source)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, ptxas = {}, {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(f"{name}: nvcc failed, skipped:\n{log[-2000:]}", flush=True)
            skipped.append(name)
            continue
        ptxas[name] = ptxas_kernels(log)
        lib = ctypes.CDLL(str(out_dir / name / "lib.so"))
        for fn, argtypes in _build.SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs, ptxas, skipped


def ablate_d(device, g: int, sims: int, repeats: int, names) -> dict:
    """Kernel D's large route in each of ``D_VARIANTS`` (those ``names``
    lists, all by default) at G grid points and S sims, B = 4 and 9, on rows
    following g."""
    out_dir = REPO / "build" / "grid_probe"
    _build.smem_limit(device)  # read through the repository's own library
    variants = {k: v for k, v in D_VARIANTS.items() if not names or k in names}
    libs, ptxas, skipped = build_variants(variants, "decision_update_kernel.cu", out_dir)
    report = {"card": torch.cuda.get_device_name(0), "grid": g, "sims": sims,
              "skipped": skipped, "rows": []}
    for name in skipped:
        print(f"{name}: skipped (its anchor is not in the source)", flush=True)
    args = step_args(device, g, sims, BASIS_9)
    out = torch.empty_like(args[0])
    library = _build.library
    try:
        for nb in (4, 9):
            gen = torch.Generator(device=device).manual_seed(5)
            d_args = (args[0], torch.randn((nb, sims), generator=gen, device=device), args[1],
                      args[9], args[10], 20.0 * torch.randn((3, g, nb), generator=gen,
                                                            device=device), args[12], args[13])
            ref = None
            for name, lib in libs.items():
                _build.library = lambda lib_=lib: lib_

                def run():
                    return decision_kernel.decision_update(*d_args, out=out, route="large")
                ms = cuda_ms(run, repeats)
                run()
                torch.cuda.synchronize()
                got = digest(out)
                ref = ref or got
                info = (ctypes.c_int * 6)()
                _build.check(lib.stt_decision_update_info(decision_kernel.TILE_D, 3, nb, info), name)
                bp = decision_kernel.padded_basis(nb)
                pattern = rf"decision_update_kernelILi({nb}|{bp})E"
                regs = {m.group(0): r for k, r in ptxas[name].items()
                        for m in [re.search(pattern, k)] if m}
                row = dict(variant=name, B=nb, ms=ms, digest=got, same_bits=got == ref,
                           bits_required=variants[name][1], blocks_per_sm=info[4],
                           smem_bytes=info[1], ptxas=regs)
                report["rows"].append(row)
                print(f"{name:20s} B={nb}: {ms:.4f} ms, blocks/SM {info[4]}, smem {info[1]} B, "
                      f"ptxas (registers, spill bytes) {regs}, digest {got} "
                      f"(unpatched's: {got == ref})", flush=True)
                if variants[name][1] and got != ref:
                    raise AssertionError(f"{name} parts from the unpatched kernel's bits")
            del d_args
    finally:
        _build.library = library
    report["bytes_bound_ms"] = bytes_bound_ms(g, sims)
    return report


C_GRIDS = (100, 200, 400, 700, 1_000)
C_MODES = ("monomial", "general", "design")


def c_routes(device, sims: int, repeats: int, grids=C_GRIDS, basis=BASIS_9, factors=3,
             modes=C_MODES) -> dict:
    """Kernel C in each of ``modes`` forced onto each route in turns at
    each of ``grids``: the monomial and general modes over 365 steps, the
    design mode over one 32-step chunk; ms a launch and blocks per SM of
    each route."""
    report = {"card": torch.cuda.get_device_name(0), "sims": sims, "basis": basis,
              "factors": factors}
    for g in grids:
        report[g] = c_routes_at(device, g, sims, repeats, basis, factors, modes)
    return report


def c_routes_at(device, g: int, sims: int, repeats: int, basis: str, f: int, modes) -> dict:
    mono = tuple(parse_basis_functions(basis))
    b = len(mono)
    smem = _build.smem_limit(device)
    report = {}
    for mode in modes:
        design = mode == "design"
        n = forward_kernel.DESIGN_CHUNK if design else 365
        sargs, rows = sweep_args(device, n, g, sims, mono, f)
        fits = forward_kernel.sweep_max_grid(b, 3, b if design else f, 0, smem, design,
                                             mode == "general")
        if design:
            raw = torch.stack(design_columns(mono, sargs[6], sargs[7]), dim=1)
            dargs = (*sargs[:7], raw, *sargs[8:11], *sargs[12:])
        grid = rows if mode == "general" else None
        for route in ("shared", "large", "large", "shared"):
            if route == "shared" and g > fits:
                continue
            if design:
                def run():
                    return forward_kernel.forward_sweep_design(*dargs, route=route)
            else:
                def run():
                    return forward_kernel.forward_sweep(*sargs, grid=grid, route=route)
            ms = cuda_ms(run, repeats)
            info = forward_kernel.kernel_info(g, b, 3, 0 if design else f, 0, device,
                                              design=design, general=mode == "general",
                                              large=route == "large")
            report.setdefault(f"{mode}_{route}", dict(
                ms=[], steps=n, blocks_per_sm=info["blocks_per_sm"],
                smem_bytes=info["smem_bytes"]))["ms"].append(ms)
            print(f"C {mode} {route} [G={g}, N={n}, B={b}, F={f}]: {ms:.4f} ms, "
                  f"{info['blocks_per_sm']} blocks/SM, {info['smem_bytes']} B", flush=True)
        del sargs, rows, grid, run
        if design:
            del raw, dargs
        torch.cuda.empty_cache()
    return report


def sweep_args(device, n: int, g: int, s: int, mono, f: int = 3):
    """Kernel C's arguments over N steps at G grid points, S sims and F
    factors, and its grid rows (bunched towards the top)."""
    gen = torch.Generator(device=device).manual_seed(6)
    t = torch.arange(n, dtype=torch.float32, device=device)
    lo, hi = 0.0 * t, 5000.0 + 0.0 * t
    scalars = dict(df_settle=0.97 - 0.0 * t, df_flow=0.95 - 0.0 * t, inj_cost=0.9 + 0.0 * t,
                   wdr_cost=0.7 + 0.0 * t, inj_pcnt=0.0 * t, wdr_pcnt=0.0 * t,
                   loss_pcnt=0.0 * t, inv_cost_rate=0.0 * t, next_min=lo, next_max=hi)
    rows = lo[:, None] + (hi - lo)[:, None] * torch.linspace(0.0, 1.0, g, device=device) ** 1.3
    params = forward_kernel.pack_params(scalars, rows)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=device)  # noqa: E731
    rat = lambda *x: torch.tensor(x, device=device).expand(n, 3).contiguous()  # noqa: E731
    b = len(mono)
    spot_p, fac = 30.0 + 5.0 * rnd(n, s), rnd(n, f, s)
    sargs = (params, 0.3 * rnd(n, b), 1.0 + 0.2 * rnd(n, b).abs(), rat(0.0, 2500.0, 5000.0),
             rat(-200.0, -250.0, -300.0), rat(300.0, 250.0, 200.0), spot_p, fac,
             5000.0 * torch.rand(s, generator=gen, device=device), None, 20.0 * rnd(n, b, g),
             mono, 0, False)
    return sargs, rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--grid", type=int, default=4_096)
    parser.add_argument("--sims", type=int, default=262_144)
    parser.add_argument("--steps", type=int, default=32)
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--repo", default=str(REPO), help="the checkout to import")
    parser.add_argument("--shared-b", action="store_true",
                        help="time kernels B, E and D at G = 100 to 4,096 only, with their "
                             "routes and digests of their outputs")
    parser.add_argument("--ablate-d", action="store_true",
                        help="time variants of kernel D's large route (D_VARIANTS)")
    parser.add_argument("--grids", type=int, nargs="*", default=None,
                        help="with --shared-b or --c-routes, the grid sizes to time")
    parser.add_argument("--kernels", nargs="*", default=(),
                        help="with --shared-b, those of B, E, D4, D9 to time (default: all)")
    parser.add_argument("--basis", default=BASIS_9, help="with --c-routes, the basis")
    parser.add_argument("--factors", type=int, default=3, help="with --c-routes, F")
    parser.add_argument("--modes", nargs="*", default=C_MODES,
                        help="with --c-routes, the modes to time (default: all three)")
    parser.add_argument("--tile", type=int, default=None,
                        help="with --ablate-d, kernel D's large-route tile (TILE_D)")
    parser.add_argument("--variants", nargs="*", default=(),
                        help="with --ablate-d, the variants to build (default: all)")
    parser.add_argument("--c-routes", action="store_true",
                        help="time kernel C's modes on each route at G = 100 to 1,000")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_grid_probe: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    if opts.tile:
        decision_kernel.TILE_D = opts.tile
    out_dir = REPO / "build" / "grid_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    for flag, name, fn in (
            (opts.shared_b, "shared_b",
             lambda: shared_b(device, opts.sims, opts.grids or (*CROSSING_GRIDS, 4_096),
                              opts.kernels)),
            (opts.ablate_d, "ablate_d", lambda: ablate_d(device, opts.grid, opts.sims,
                                                        opts.repeats, opts.variants)),
            (opts.c_routes, "c_routes", lambda: c_routes(
                device, opts.sims, 3, opts.grids or C_GRIDS, opts.basis, opts.factors,
                opts.modes))):
        if flag:
            _build.library()
            report = fn()
            (out_dir / f"{name}.json").write_text(json.dumps(report, indent=1))
            print(json.dumps(report))
            return 0
    g, s = opts.grid, opts.sims
    _build.library()
    report = {"card": torch.cuda.get_device_name(0), "grid": g, "sims": s,
              "bound_ms": bytes_bound_ms(g, s), "B": {}, "D4": {}, "D9": {}}
    args = step_args(device, g, s, BASIS_9)
    out = torch.empty_like(args[0])
    default_b, default_d = decision_kernel.TILE_B, decision_kernel.TILE_D
    for tile in (32, 48, 64, 96, 128, 192, 256, 384):
        decision_kernel.TILE_B = tile
        ms = cuda_ms(lambda: decision_kernel.decision_update_moments(*args, out=out,
                                                                     route="large"),
                     opts.repeats)
        info = decision_kernel.kernel_info("moments", tile, 3, 9, device, large=True)
        report["B"][tile] = dict(ms=ms, blocks_per_sm=info["blocks_per_sm"],
                                 smem_bytes=info["smem_bytes"])
        print(f"B tile {tile}: {ms:.4f} ms, {info['blocks_per_sm']} blocks/SM, "
              f"{info['smem_bytes']} B", flush=True)
    decision_kernel.TILE_B = default_b
    rnd_args = step_args(device, g, s, BASIS_9, rows="random")
    report["B_random_ms"] = cuda_ms(
        lambda: decision_kernel.decision_update_moments(*rnd_args, out=out), opts.repeats)
    e_args, prev = fullstep_args(rnd_args)
    report["E_random_ms"] = cuda_ms(
        lambda: decision_kernel.decision_update_fullstep(*e_args, **prev, out=out), opts.repeats)
    print(f"random rows, tile {default_b}: B {report['B_random_ms']:.4f} ms, "
          f"E {report['E_random_ms']:.4f} ms", flush=True)
    del rnd_args, e_args
    v, spot, factors = args[0], args[1], args[2]
    for label, basis in (("D4", "1 + s + s**2 + s**3"), ("D9", BASIS_9)):
        mono = tuple(parse_basis_functions(basis))
        nb = len(mono)
        gen = torch.Generator(device=device).manual_seed(5)
        dm_t = torch.randn((nb, s), generator=gen, device=device)
        ci = 20.0 * torch.randn((3, g, nb), generator=gen, device=device)
        dargs = (v, dm_t, spot, args[9], args[10], ci, args[12], args[13])
        for tile in (32, 64, 128, 256, 512):
            decision_kernel.TILE_D = tile
            ms = cuda_ms(lambda: decision_kernel.decision_update(*dargs, out=out, route="large"),
                         opts.repeats)
            info = decision_kernel.kernel_info("update", tile, 3, nb, device)
            report[label][tile] = dict(ms=ms, blocks_per_sm=info["blocks_per_sm"],
                                       smem_bytes=info["smem_bytes"])
            print(f"{label} tile {tile}: {ms:.4f} ms, {info['blocks_per_sm']} blocks/SM, "
                  f"{info['smem_bytes']} B", flush=True)
    decision_kernel.TILE_D = default_d
    mono = args[14]
    fargs, prev = fullstep_args(args)
    report["E_ms"] = cuda_ms(
        lambda: decision_kernel.decision_update_fullstep(*fargs, **prev, out=out), opts.repeats)
    print(f"E (large route, tile {default_b}): {report['E_ms']:.4f} ms", flush=True)
    del args, v, out, fargs
    # Kernel C in each mode over N steps, at the main path's sims.
    n = opts.steps
    sargs, rows = sweep_args(device, n, g, s, mono)
    spot_p, fac = sargs[6], sargs[7]
    raw = torch.stack(design_columns(mono, spot_p, fac), dim=1)
    dargs = (*sargs[:7], raw, *sargs[8:11], *sargs[12:])
    report["C"] = {
        "monomial": cuda_ms(lambda: forward_kernel.forward_sweep(*sargs), opts.repeats),
        "general": cuda_ms(lambda: forward_kernel.forward_sweep(*sargs, grid=rows), opts.repeats),
        "design": cuda_ms(lambda: forward_kernel.forward_sweep_design(*dargs), opts.repeats),
        "steps": n}
    print(f"C over {n} steps: {report['C']}", flush=True)
    (out_dir / "grid_probe.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
