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
checkout ``--repo`` names, at G = 100 (the headline's launch), 1,000 (B
also forced onto its large route) and 4,096 (the large routes), on rows
that follow g and on random rows, and prints SHA-256 digests of every
output: run it on two checkouts in turns in one call (parent, change,
change, parent) to compare their times and bits on one card.

    python3 tools/torch_grid_probe.py [--grid 4096] [--sims 262144]
    python3 tools/torch_grid_probe.py --shared-b --repo build/parent
"""
import argparse
import hashlib
import json
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


def shared_b(device, sims: int) -> dict:
    """Kernels B, E and D (B = 4 and 9) at G = 100, 1,000 and 4,096 on both
    kinds of rows: ms a launch (20 launches after a warm-up, 5 at G = 4,096)
    and the digest of every output."""
    report = {"repo": str(REPO), "card": torch.cuda.get_device_name(0)}
    for g in (100, 1_000, 4_096):
        repeats = 5 if g > 1_000 else 20
        for rows in ("band", "random"):
            args = step_args(device, g, sims, BASIS_9, rows=rows)
            out = torch.empty_like(args[0])
            e_args, prev = fullstep_args(args)
            calls = {
                "B": lambda: decision_kernel.decision_update_moments(*args, out=out),
                "E": lambda: decision_kernel.decision_update_fullstep(*e_args, **prev, out=out)}
            for nb in ((4, 9) if rows == "band" else ()):
                gen = torch.Generator(device=device).manual_seed(5)
                d_args = (args[0], torch.randn((nb, sims), generator=gen, device=device), args[1],
                          args[9], args[10], 20.0 * torch.randn((3, g, nb), generator=gen,
                                                                device=device),
                          args[12], args[13])
                calls[f"D{nb}"] = (lambda a_=d_args: decision_kernel.decision_update(*a_, out=out))
            if g == 1_000:  # the shared route at 1 block/SM against the large one
                calls["B_large"] = lambda: decision_kernel.decision_update_moments(
                    *args, out=out, route="large")
            for name, fn in calls.items():
                key = f"{name}_g{g}_{rows}"
                report[f"ms_{key}"] = cuda_ms(fn, repeats)
                report[f"digest_{key}"] = digest(fn())
                print(f"{key}: {report[f'ms_{key}']:.4f} ms, digest {report[f'digest_{key}']}",
                      flush=True)
            del args, out, e_args, calls
            torch.cuda.empty_cache()
    return report


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--grid", type=int, default=4_096)
    parser.add_argument("--sims", type=int, default=262_144)
    parser.add_argument("--steps", type=int, default=32)
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--repo", default=str(REPO), help="the checkout to import")
    parser.add_argument("--shared-b", action="store_true",
                        help="time kernels B, E and D at G = 100, 1,000 and 4,096 only, "
                             "with digests of their outputs")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_grid_probe: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    if opts.shared_b:
        _build.library()
        print(json.dumps(shared_b(device, opts.sims)))
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
        info = decision_kernel.kernel_info("moments", tile, 3, 9, device)
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
        for tile in (64, 128, 256, 512, 1024):
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
    spot_p, fac = 30.0 + 5.0 * rnd(n, s), rnd(n, 3, s)
    sargs = (params, 0.3 * rnd(n, 9), 1.0 + 0.2 * rnd(n, 9).abs(), rat(0.0, 2500.0, 5000.0),
             rat(-200.0, -250.0, -300.0), rat(300.0, 250.0, 200.0), spot_p, fac,
             5000.0 * torch.rand(s, generator=gen, device=device), None, 20.0 * rnd(n, 9, g),
             mono, 0, False)
    raw = torch.stack(design_columns(mono, spot_p, fac), dim=1)
    dargs = (*sargs[:7], raw, *sargs[8:11], *sargs[12:])
    report["C"] = {
        "monomial": cuda_ms(lambda: forward_kernel.forward_sweep(*sargs), opts.repeats),
        "general": cuda_ms(lambda: forward_kernel.forward_sweep(*sargs, grid=rows), opts.repeats),
        "design": cuda_ms(lambda: forward_kernel.forward_sweep_design(*dargs), opts.repeats),
        "steps": n}
    print(f"C over {n} steps: {report['C']}", flush=True)
    out_dir = REPO / "build" / "grid_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "grid_probe.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
