#!/usr/bin/env python3
"""Times the headline valuation of storage_tpu_torch with its paths split over
a process group, one rank a card (``storage_tpu_torch.parallel``).

On N cards, from the repository root:

    python3 -m torch.distributed.run --nproc-per-node=N tools/torch_multi_gpu.py

(``--nproc-per-node=1`` gives the one-card figure of the same script.)  On the
CPU, a small rehearsal over gloo:

    python3 -m torch.distributed.run --nproc-per-node=4 tools/torch_multi_gpu.py \\
        --device cpu --sims 4096

The headline is ``chip_smoke.py``'s: the 365-day ratcheted facility, the
3-factor seasonal model, the 9-term basis, 100 grid points, seeds 11/13,
``--sims`` paths in all (262,144 by default), f32.  Each rank values it once to
warm up, then ``--runs`` times (a barrier before each; host clock around a
call ended by a synchronisation), then once with every collective bracketed
by synchronisations (their count and seconds, waits for the other ranks
included), then once with adjoint deltas.  Rank 0 gathers every rank's
numbers and prints one JSON line: the NPV and SE (the same bits on every
rank, checked), each rank's wall median and runs, collectives, adjoint wall
and peak device memory, with the card's name and power limit; it also writes
``build/multi_gpu/report_<N>.json``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--sims", type=int, default=262_144)
    parser.add_argument("--runs", type=int, default=5)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    import storage_tpu_torch as stt
    from storage_tpu_torch.parallel import distributed as pdist

    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        print("torch_multi_gpu: no CUDA device; pass --device cpu", file=sys.stderr)
        return 2
    pdist.initialize(backend=None if cuda else "gloo")
    rank, world = pdist.process_index(), pdist.process_count()
    if not cuda:
        torch.set_num_threads(1)
    device = torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device("cpu")
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)  # noqa: E731

    def timed(**kwargs):
        dist.barrier()
        t0 = time.perf_counter()
        res = cs.value(stt, device, True, num_sims=args.sims, **kwargs)
        sync()
        return res, time.perf_counter() - t0

    cs.value(stt, device, True, num_sims=args.sims)  # warm-up
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    walls = []
    for _ in range(args.runs):
        res, wall = timed()
        walls.append(wall)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9 if cuda else None

    spans, originals = [], {n: getattr(dist, n) for n in ("all_reduce", "all_gather", "broadcast")}

    def bracketed(fn):
        def run(*a, **k):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync()
            spans.append(time.perf_counter() - t0)
            return out
        return run

    for n, fn in originals.items():
        setattr(dist, n, bracketed(fn))
    try:
        res_c, wall_c = timed()
    finally:
        for n, fn in originals.items():
            setattr(dist, n, fn)
    res_a, wall_a = timed(deltas_method="adjoint")
    mine = dict(rank=rank, device=str(device), walls_s=walls, wall_s=float(np.median(walls)),
                collectives=len(spans), collectives_s=sum(spans), instrumented_wall_s=wall_c,
                adjoint_wall_s=wall_a, peak_gb=peak_gb, npv=res.npv,
                se=res.val_sim_standard_error, digest=cs.result_digest(res),
                same_bits=cs.result_digest(res_c) == cs.result_digest(res)
                and res_a.npv == res.npv)
    gathered = [None] * world
    dist.all_gather_object(gathered, mine)
    if rank == 0:
        report = dict(card=card_line() if cuda else "cpu", torch=torch.__version__, ranks=world,
                      backend=dist.get_backend(),
                      sims=args.sims, npv=res.npv, se=res.val_sim_standard_error,
                      ranks_agree=len({g["digest"] for g in gathered}) == 1
                      and all(g["same_bits"] for g in gathered),
                      per_rank=gathered)
        out = REPO / "build" / "multi_gpu"
        out.mkdir(parents=True, exist_ok=True)
        (out / f"report_{world}.json").write_text(json.dumps(report, indent=1))
        print(json.dumps(report), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
