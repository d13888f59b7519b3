#!/usr/bin/env python3
"""The headline valuation's wall on one NVIDIA GPU for two or more
checkouts of the repository, in turns, so that a change is timed beside its
parent in one call (one card, one host).

Each turn runs one checkout in a fresh process: it builds that checkout's
kernels (into its own ``build/``, reused by its later turns), values the
headline case once to warm up (``chip_smoke.value``: 262,144 paths x 365
steps x 100 grid points, seeds 11/13, ``snap_interp=True``), then ``--runs``
timed valuations (host clock, each ended by ``torch.cuda.synchronize()``)
and one phase breakdown (``chip_smoke.phase_breakdown``).  The checkouts
run in the order given, then in reverse, ``--rounds`` times (A, B, B, A for
two checkouts and two rounds).  ``--grid G`` values the headline at G
inventory grid points instead of 100 (each checkout's own route rule
picks its kernels' routes).  ``--case basis_20`` or ``--case factors_10``
values one of the caps cells instead (``chip_smoke.caps_value``: a 20-term
basis on the headline's 3-factor model, or 13 terms on the 10-factor model,
at the headline's width), with no phase breakdown; ``--fullstep`` runs
each valuation with the engine's full step (``chip_smoke.fullstep_engine``).
It prints each turn, then each checkout's median wall over all its turns,
its NPV and SE (equal bits expected across checkouts that keep the main
path's arithmetic) and the card's name and power limit; the report goes to
``build/wall_compare/wall_compare_<case>[_fullstep]_g<G>.json``.

    mkdir -p build/parent && git archive <parent> | tar -x -C build/parent
    python3 tools/torch_wall_compare.py --repo build/parent --repo .
    python3 tools/torch_wall_compare.py --grid 1000 --runs 3 --repo build/parent --repo .
    python3 tools/torch_wall_compare.py --case basis_20 --fullstep --repo build/parent --repo .
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

OUT = Path(__file__).resolve().parents[1] / "build" / "wall_compare"


CASES = ("headline", "basis_20", "factors_10")


def child(repo: Path, runs: int, grid: int, case: str, fullstep: bool) -> dict:
    sys.path.insert(0, str(repo))
    import torch

    import chip_smoke
    import storage_tpu_torch as stt
    from storage_tpu_torch.ops import _build

    chip_smoke.NUM_GRID = grid  # read by chip_smoke.value at each call

    device = torch.device("cuda", 0)
    _build.library()

    def run():
        with chip_smoke.fullstep_engine(fullstep):
            if case == "headline":
                return chip_smoke.value(stt, device, snap_interp=True)
            return chip_smoke.caps_value(stt, device, case)

    run()
    torch.cuda.synchronize()
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    phases = chip_smoke.phase_breakdown(stt, device) if case == "headline" else {}
    return dict(repo=str(repo), walls_s=walls, npv=res.npv, se=res.val_sim_standard_error,
                phases={k: v for k, v in phases.items() if k.endswith("_s")})


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", action="append", default=[], help="a checkout (repeat)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--grid", type=int, default=100, help="inventory grid points")
    ap.add_argument("--case", choices=CASES, default="headline")
    ap.add_argument("--fullstep", action="store_true", help="the engine's full step")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv[1:])
    if args.child:
        print(json.dumps(child(Path(args.child).resolve(), args.runs, args.grid, args.case,
                               args.fullstep)))
        return 0
    import torch

    if len(args.repo) < 2:
        ap.error("name two or more checkouts with --repo")
    if not torch.cuda.is_available():
        print("torch_wall_compare: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    repos = [str(Path(r).resolve()) for r in args.repo]
    order = []
    for k in range(args.rounds):
        order += repos if k % 2 == 0 else repos[::-1]
    turns = []
    for repo in order:
        out = subprocess.run([sys.executable, __file__, "--child", repo, "--runs", str(args.runs),
                              "--grid", str(args.grid), "--case", args.case,
                              *(["--fullstep"] if args.fullstep else [])],
                             capture_output=True, text=True, cwd=repo)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        turn = json.loads(out.stdout.strip().splitlines()[-1])
        turns.append(turn)
        print(f"{repo}: walls {[round(w, 4) for w in turn['walls_s']]} s, phases "
              f"{ {k: round(v, 4) for k, v in turn['phases'].items()} }, NPV {turn['npv']!r} "
              f"SE {turn['se']!r}", flush=True)
    summary = {}
    for repo in repos:
        mine = [t for t in turns if t["repo"] == repo]
        walls = [w for t in mine for w in t["walls_s"]]
        summary[repo] = dict(median_s=statistics.median(walls), walls_s=walls,
                             npv=mine[0]["npv"], se=mine[0]["se"])
        print(f"{repo}: median {summary[repo]['median_s']:.4f} s of {len(walls)} runs, NPV "
              f"{mine[0]['npv']!r} SE {mine[0]['se']!r} [{card}]")
    OUT.mkdir(parents=True, exist_ok=True)
    name = f"{args.case}{'_fullstep' * args.fullstep}_g{args.grid}"
    (OUT / f"wall_compare_{name}.json").write_text(json.dumps(
        dict(card=card, grid=args.grid, case=args.case, fullstep=args.fullstep, turns=turns,
             summary=summary), indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
