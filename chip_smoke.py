#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``storage_tpu_torch``) on one NVIDIA GPU.

1. Prints the card (``nvidia-smi`` name and power limit, torch's device name).
2. Builds the CUDA kernels from ``storage_tpu_torch/csrc`` and prints the
   build time and the compiler's register/spill report.
3. Holds each kernel against its plain PyTorch version on the card, at the
   main path's shapes (S=262,144 paths, G=100 grid points, D=3 decisions,
   B=9 basis functions, F=3 factors, R=3 ratchet nodes), and times both with
   CUDA events.
4. Values the repository's headline daily case through the public API —
   a 365-day ratcheted facility, 3-factor seasonal model, 9-term basis,
   262,144 paths per set, f32, seeds 11/13 — once to warm up, then five
   timed runs (the launch counters reset before the first); checks that
   the NPV is within 0.1 SE of the same valuation in f64 on the same draws
   and within 3 SE of the reference record (114,941.8, ``BENCH_r05.json``),
   and that kernel A ran for both path sets, kernel B once per backward step
   and kernel C once per forward step.  Then the same valuation with the
   port's default ``snap_interp=False`` (held to the same bounds) and with
   the TPU run's numerics (held within 0.1 SE of the record), a phase
   breakdown (host preparation, simulate, backward, forward) and one
   valuation under torch.profiler (device busy share, kernels by time).

The line before the last is the card; the one before it the kernels' JSON
summary; the last line is ``{"ok": true, "device": {...}}``.  A fuller
report goes to ``build/chip_smoke/`` (``chip_smoke.json``, ``profile.txt``,
``ptxas.log``).  Exits non-zero, printing no result, without a CUDA device,
outside the repository, or when any phase fails.

Run from the repository root:  python3 chip_smoke.py
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

REFERENCE_NPV = 114_941.8  # BENCH_r05.json: 262,144 x 365 x 100, seeds 11/13
# The same valuation in f64 on these draws (the f32 paths cast to f64, the
# kernels' plain versions on an H100), by snap_interp: what the f32 run
# should reproduce up to f32 rounding of the regressions.
F64_NPV = {True: 115_080.6957706275, False: 115_079.00662445562}
NUM_SIMS = 262_144
NUM_STEPS = 365
NUM_GRID = 100
BASIS = "1 + x_st + x_lt + x_sw + x_st**2 + x_lt**2 + x_sw**2 + s + s**2"
REPO = Path(__file__).resolve().parent
OUT = REPO / "build" / "chip_smoke"
SOURCES = {  # kernel: (CUDA source, the TPU kernel's pallas_call it replaces)
    "normal_halves": ("storage_tpu_torch/csrc/rng_kernel.cu", "storage_tpu/ops/rng_kernel.py:175"),
    "decision_update_moments": ("storage_tpu_torch/csrc/decision_kernel.cu",
                                "storage_tpu/ops/decision_kernel.py:381"),
    "forward_step": ("storage_tpu_torch/csrc/forward_kernel.cu",
                     "storage_tpu/ops/forward_kernel.py:372"),
}


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bench_case(pkg):
    """The headline daily case of ``__graft_entry__._build_case`` / bench.py."""
    import numpy as np
    import pandas as pd

    start = pd.Period("2021-01-01", freq="D")
    storage = pkg.CmdtyStorage(
        "D", start, start + NUM_STEPS, 0.9, 0.7,
        ratchets=[
            (start, [(0.0, -200.0, 300.0), (2500.0, -250.0, 250.0), (5000.0, -300.0, 200.0)]),
        ],
        ratchet_interp=pkg.RatchetInterp.LINEAR,
        terminal_storage_npv=lambda price, inv: price * inv,
    )
    idx = pd.period_range(start, storage.end, freq="D")
    i = np.arange(len(idx))
    fwd = pd.Series(index=idx, data=30.0 + 6 * np.sin(2 * np.pi * i / 365.0))
    return storage, start, fwd


def value(pkg, device, snap_interp):
    """The headline valuation through the public API."""
    import torch

    storage, start, fwd = bench_case(pkg)
    return pkg.three_factor_seasonal_value(
        storage, start, 100.0, fwd, 0.02, None, 14.5, 1.1, 0.19, 0.23,
        NUM_SIMS, BASIS, False, seed=11, fwd_sim_seed=13,
        num_inventory_grid_points=NUM_GRID, dtype=torch.float32, device=device,
        snap_interp=snap_interp,
    )


def engine_inputs(pkg, device):
    """The headline case's engine inputs, built the way the API builds them:
    (valuation inputs, OU simulation tensors, engine arrays, monomials)."""
    import numpy as np
    import torch

    from storage_tpu_torch.basis import parse_basis_functions
    from storage_tpu_torch.engines import lsmc as engine
    from storage_tpu_torch.models import multi_factor as mf
    from storage_tpu_torch.valuation_inputs import prepare_valuation

    storage, start, fwd = bench_case(pkg)
    inputs = prepare_valuation(storage, start, 100.0, fwd, 0.02, None)
    factors, corrs = mf.create_3_factor_seasonal_params("D", 14.5, 1.1, 0.19, 0.23, start, storage.end)
    pre = mf.simulation_precompute(factors, corrs, inputs.val_day, list(inputs.periods), "D")
    sim_in = [torch.tensor(np.asarray(a), dtype=torch.float32, device=device)
              for a in (pre.decay, pre.chol, pre.vols, pre.half_var, inputs.fwd)]
    arrays = engine.build_engine_arrays(
        inputs.compiled, inputs.fwd, inputs.df_settle, inputs.df_flow,
        inputs.inventory_lower, inputs.inventory_upper, NUM_GRID, torch.float32, device,
    )
    return inputs, sim_in, arrays, tuple(parse_basis_functions(BASIS))


def check_npv(npv: float, se: float, snap_interp: bool) -> float:
    """Holds a headline NPV within 0.1 SE of the f64 answer on the same draws
    (f32 variants of the regression land within 0.04 SE of it) and within
    3 SE of the reference record; returns z against the record."""
    z = (npv - REFERENCE_NPV) / se
    off = (npv - F64_NPV[snap_interp]) / se
    if not (math.isfinite(npv) and abs(off) <= 0.1 and abs(z) <= 3.0):
        raise AssertionError(
            f"NPV {npv} (SE {se}) is {off:+.4f} SE from the f64 answer "
            f"{F64_NPV[snap_interp]} and {z:+.3f} SE from the record {REFERENCE_NPV}")
    return z


def cuda_ms(fn, repeats: int) -> float:
    """Mean milliseconds per call over ``repeats`` back-to-back calls, by CUDA
    events, after one warm-up call."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def check_kernels(pkg, device):
    """Each kernel against its plain version on the card at main-path shapes."""
    import torch

    from storage_tpu_torch.engines import lsmc as engine
    from storage_tpu_torch.models import spot_sim
    from storage_tpu_torch.ops import decision_kernel, forward_kernel, rng_kernel

    s, f = NUM_SIMS, 3
    results = {}

    # ---- A: threefry words bit for bit, normals within 4 ULP.
    key = spot_sim.key_from_seed(11)
    nb = (NUM_STEPS + 1) * f // 2 + 1  # blocks of the 366-period draw
    ids = torch.arange(s, dtype=torch.int32, device=device)
    w1, w2 = rng_kernel.threefry_words(key, 0, nb, ids)
    lo = torch.arange(nb, dtype=torch.int64, device=device)[:, None]
    p1, p2 = rng_kernel.threefry2x32(key[0], key[1], ids.to(torch.int64)[None, :], lo)
    words_equal = bool(
        torch.equal(w1.to(torch.int64) & rng_kernel.MASK32, p1)
        and torch.equal(w2.to(torch.int64) & rng_kernel.MASK32, p2)
    )
    del w1, w2, p1, p2
    z1, z2 = rng_kernel.normal_halves(key, 0, nb, ids)
    q1, q2 = rng_kernel.normal_halves_plain(key, 0, nb, ids)
    ulp = max(
        int((a.view(torch.int32).to(torch.int64) - b.view(torch.int32).to(torch.int64)).abs().max())
        for a, b in ((z1, q1), (z2, q2))
    )
    identical = float(((z1 == q1).float().mean() + (z2 == q2).float().mean()) / 2)
    err_a = float(torch.maximum((z1 - q1).abs().max(), (z2 - q2).abs().max()))
    del z1, z2, q1, q2
    ms = cuda_ms(lambda: rng_kernel.normal_halves(key, 0, nb, ids), 20)
    plain_ms = cuda_ms(lambda: rng_kernel.normal_halves_plain(key, 0, nb, ids), 3)
    log(f"kernel A normal_halves [{nb} x {s}]: words bit-identical={words_equal}, "
        f"normals max {ulp} ULP (tolerance 4), bit-identical share {identical:.6f}, "
        f"max abs err {err_a:.3e}; {ms:.3f} ms vs plain {plain_ms:.3f} ms")
    if not words_equal or ulp > 4:
        raise AssertionError("kernel A disagrees with its plain version")
    results["normal_halves"] = dict(max_abs_err=err_a, ms=ms, plain_ms=plain_ms,
                                    max_ulp=ulp, words_bit_identical=words_equal)

    # One step of the main path: the headline facility's arrays, a simulated
    # regression panel, random values and coefficients of realistic size.
    inputs, sim_in, arrays, monomials = engine_inputs(pkg, device)
    sims = spot_sim.simulate_ou_paths(key, torch.arange(s, device=device), *sim_in)
    b_dim = len(monomials)
    t = 180
    gen = torch.Generator(device=device).manual_seed(5)

    # ---- B: the backward step at step t.
    prep = engine._backward_prep_all(arrays, 0, False, snap_interp=True)
    mean, std = engine._design_stats(monomials, sims.spot[t - 1:t + 1], sims.factors[t - 1:t + 1])
    grid_next = arrays["grids"][t + 1]
    v = (grid_next[:, None] * sims.spot[t + 1][None, :]
         + 40.0 * torch.randn((NUM_GRID, s), generator=gen, device=device)).contiguous()
    coeffs = torch.randn((b_dim, NUM_GRID), generator=gen, device=device) * 50.0
    coeffs[0] = grid_next * 30.0
    ci = engine._interp_coeffs(coeffs, prep["idx_lo"][t], prep["w_hi"][t])
    args_b = (v, sims.spot[t], sims.factors[t], sims.spot[t - 1], sims.factors[t - 1],
              mean[1], std[1], mean[0], std[0], prep["idx_lo"][t], prep["w_hi"][t], ci,
              prep["a"][t], prep["b"][t], monomials)
    out = torch.empty_like(v)
    got = decision_kernel.decision_update_moments(*args_b, out=out)
    want = decision_kernel.decision_update_moments_plain(*args_b)
    # The kernel does the plain version's arithmetic in the same order, so a
    # best_act value may differ beyond f32 rounding only where the argmax
    # flipped, and it may flip only on a near-tie of the regressed values:
    # the best two within 100 f32 ULP of the largest regressed value.
    tol = 1e-6 * float(want[0].abs().max())
    mismatch = ~((got[0] - want[0]).abs() <= tol)
    regressed = torch.stack([r for r, _ in decision_kernel.decision_values(
        *args_b[:3], *args_b[5:7], *args_b[9:])])  # [D, G, S]
    top2 = regressed.topk(2, dim=0).values
    near_tie = (top2[0] - top2[1]) <= 1e-5 * float(regressed.abs().max())
    flips = int(mismatch.sum())
    unexplained = int((mismatch & ~near_tie).sum())
    del regressed, top2, near_tie
    err_b = float((got[0] - want[0]).abs().max())
    mom_err = max(
        float(((got[i] - want[i]).abs().max() / want[i].abs().max())) for i in (1, 2)
    )
    ms = cuda_ms(lambda: decision_kernel.decision_update_moments(*args_b, out=out), 20)
    plain_ms = cuda_ms(lambda: decision_kernel.decision_update_moments_plain(*args_b), 5)
    log(f"kernel B decision_update_moments [G={NUM_GRID}, S={s}, D=3, B={b_dim}]: "
        f"best_act max abs err {err_b:.3e}; {flips} of {v.numel()} beyond {tol:.2e} "
        f"(argmax flips), {unexplained} of them off a near-tie (tolerance 0); "
        f"moments max rel err {mom_err:.3e} "
        f"(tolerance 1e-4: f32 sums over {s} sims in another order); "
        f"{ms:.3f} ms vs plain {plain_ms:.3f} ms")
    if unexplained or flips > 1e-5 * v.numel() or mom_err > 1e-4:
        raise AssertionError("kernel B disagrees with its plain version")
    results["decision_update_moments"] = dict(
        max_abs_err=err_b, ms=ms, plain_ms=plain_ms, flips=flips, moments_max_rel_err=mom_err)
    del v, out, got, want, mismatch

    # ---- C: the forward step at step t.
    step = {k: arrays[k] for k in engine._SCALARS}
    step.update(next_min=arrays["lower"][1:], next_max=arrays["upper"][1:])
    params = forward_kernel.pack_params(step, arrays["grids"][1:])[t].contiguous()
    lo_b, hi_b = float(inputs.inventory_lower[t]), float(inputs.inventory_upper[t])
    inventory = lo_b + (hi_b - lo_b) * torch.rand(s, generator=gen, device=device)
    pv = 100.0 * torch.randn(s, generator=gen, device=device)
    args_c = (params, mean[1], std[1], arrays["ratchet_inv"][t], arrays["ratchet_min"][t],
              arrays["ratchet_max"][t], sims.spot[t], sims.factors[t], inventory, pv,
              coeffs, monomials, 0, False)
    got = forward_kernel.forward_step(*args_c)
    want = forward_kernel.forward_step_plain(*args_c)
    # As in B: new inventory, PV, volume and fuel within f32 rounding of the
    # plain version, except on sims whose argmax flipped on a near-tie of the
    # decisions' total values.
    mismatch = torch.zeros(s, dtype=torch.bool, device=device)
    for i in range(4):
        tol_i = 1e-6 * max(float(want[i].abs().max()), 1.0)
        mismatch |= ~((got[i] - want[i]).abs() <= tol_i)
    candidates, _, _ = forward_kernel.decision_candidates(*args_c[:9], *args_c[10:])
    totals = torch.stack([total for total, _ in candidates])  # [D, S]
    top2 = totals.topk(2, dim=0).values
    near_tie = (top2[0] - top2[1]) <= 1e-5 * float(totals.abs().max())
    flips_c = int(mismatch.sum())
    unexplained_c = int((mismatch & ~near_tie).sum())
    err_c = max(float((got[i] - want[i]).abs().max()) for i in range(4))
    sums_err = max(
        float(((got[i] - want[i]).abs().max() / want[i].abs().max().clamp(min=1.0))) for i in (4, 5)
    )
    ms = cuda_ms(lambda: forward_kernel.forward_step(*args_c), 50)
    plain_ms = cuda_ms(lambda: forward_kernel.forward_step_plain(*args_c), 10)
    log(f"kernel C forward_step [S={s}, G={NUM_GRID}, D=3, B={b_dim}, R=3]: per-sim "
        f"(inventory, PV, volume, fuel) max abs err {err_c:.3e}; {flips_c} sims beyond "
        f"1e-6 relative (argmax flips), {unexplained_c} of them off a near-tie (tolerance 0); "
        f"sums/xbar max rel err {sums_err:.3e} (tolerance 1e-4); "
        f"{ms:.3f} ms vs plain {plain_ms:.3f} ms")
    if unexplained_c or flips_c > 1e-5 * s or sums_err > 1e-4:
        raise AssertionError("kernel C disagrees with its plain version")
    results["forward_step"] = dict(
        max_abs_err=err_c, ms=ms, plain_ms=plain_ms, flips=flips_c, sums_max_rel_err=sums_err)
    torch.cuda.synchronize()
    return results


def tpu_numerics_valuation(pkg, device):
    """The headline valuation with the TPU run's numerics, to hold the port
    against the reference record itself:

    * the OU step's L_k·z_k with its inputs rounded to bf16: the JAX
      package's ``ou_step`` sets no matmul precision, and XLA on a TPU
      multiplies f32 inputs at bf16 by default;
    * the fused backward's moments (``storage_tpu/engines/lsmc.py:277-301``):
      step t−1's moments standardised by step t's stats inside kernel B,
      the exact system recovered with ``standardise_moments``.

    Returns (npv, standard error)."""
    from unittest import mock

    import torch

    from storage_tpu_torch.engines import lsmc as engine
    from storage_tpu_torch.models import spot_sim
    from storage_tpu_torch.ops import decision_kernel
    from storage_tpu_torch.ops.regression import fit_from_moments, standardise_moments

    def bf16(t):
        return t.to(torch.bfloat16).to(torch.float32)

    def tpu_ou_step(x, z, decay_k, chol_k):
        return x * decay_k[:, None] + bf16(chol_k) @ bf16(z)

    inputs, sim_in, arrays, monomials = engine_inputs(pkg, device)
    tfn = inputs.compiled.terminal_value
    ids = torch.arange(NUM_SIMS, device=device)
    with mock.patch.object(spot_sim, "ou_step", tpu_ou_step):
        reg = spot_sim.simulate_ou_paths(spot_sim.key_from_seed(11), ids, *sim_in)
        val = spot_sim.simulate_ou_paths(spot_sim.key_from_seed(13), ids, *sim_in)
    n, spot, factors = NUM_STEPS, reg.spot, reg.factors
    v = engine._terminal_values(tfn, spot[n], arrays["grids"][n], NUM_GRID, NUM_SIMS, torch.float32)
    prep = engine._backward_prep_all(arrays, 0, False, snap_interp=True)
    mean, std = (x[0] for x in engine._design_stats(monomials, spot[n - 1:n], factors[n - 1:n]))
    xtx, xty = engine._fused_bootstrap(monomials, spot[n - 1], factors[n - 1], v, mean, std)
    b_dim = len(monomials)
    regression = {"mean": torch.empty((n, b_dim), device=device),
                  "std": torch.empty((n, b_dim), device=device),
                  "coeffs": torch.empty((n, b_dim, NUM_GRID), device=device)}
    spare = torch.empty_like(v)
    for t in range(n - 1, -1, -1):
        m, rhs, mu_u, sig_u = standardise_moments(xtx, xty)
        mean, std = mean + std * mu_u, std * sig_u
        coeffs = fit_from_moments(m, rhs)
        ci = engine._interp_coeffs(coeffs, prep["idx_lo"][t], prep["w_hi"][t])
        prev = max(t - 1, 0)
        best_act, xtx, xty = decision_kernel.decision_update_moments(
            v, spot[t], factors[t], spot[prev], factors[prev], mean, std, mean, std,
            prep["idx_lo"][t], prep["w_hi"][t], ci, prep["a"][t], prep["b"][t], monomials,
            out=spare,
        )
        spare, v = v, best_act
        regression["mean"][t], regression["std"][t], regression["coeffs"][t] = mean, std, coeffs
    out = engine.lsmc_forward(arrays, val.spot, val.factors, regression, 100.0, monomials, 0,
                              False, tfn, False)
    return float(out["npv"]), float(out["standard_error"])


def phase_breakdown(pkg, device):
    """Host preparation / simulate / backward / forward seconds of the
    headline case, each ended by a synchronize, through the calls the API
    makes."""
    import torch

    from storage_tpu_torch.engines import lsmc as engine
    from storage_tpu_torch.models import spot_sim

    times = {}
    t0 = time.perf_counter()
    inputs, sim_in, arrays, monomials = engine_inputs(pkg, device)
    torch.cuda.synchronize()
    times["host_prep_s"] = time.perf_counter() - t0
    tfn = inputs.compiled.terminal_value
    ids = torch.arange(NUM_SIMS, device=device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    reg = spot_sim.simulate_ou_paths(spot_sim.key_from_seed(11), ids, *sim_in)
    val = spot_sim.simulate_ou_paths(spot_sim.key_from_seed(13), ids, *sim_in)
    torch.cuda.synchronize()
    times["simulate_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, regression = engine.lsmc_backward(arrays, reg.spot, reg.factors, monomials, 0, tfn, False,
                                         snap_interp=True)
    torch.cuda.synchronize()
    times["backward_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = engine.lsmc_forward(arrays, val.spot, val.factors, regression, 100.0, monomials, 0,
                              False, tfn, False)
    times["npv"] = float(out["npv"])  # reads back, so the forward pass has ended
    times["forward_s"] = time.perf_counter() - t0
    times["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    return times


def profile_valuation(pkg, device, card):
    """One headline valuation under torch.profiler: the device busy share and
    the device-side events by time, written to build/chip_smoke/profile.txt."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        value(pkg, device, snap_interp=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Device-side events only (kernels, copies, memsets): an aten:: op's
    # device time repeats that of the kernels it launched.
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    events.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in events) / 1e6
    lines = [f"{e.self_device_time_total / 1e3:10.3f} ms {e.count:7d}x  {e.key[:100]}" for e in events]
    (OUT / "profile.txt").write_text(
        f"{card}\nwall {wall:.4f} s under the profiler, device busy {busy:.4f} s\n" + "\n".join(lines)
    )
    log(f"profile: wall {wall:.4f} s under the profiler, device busy {busy:.4f} s "
        f"({100 * busy / wall:.1f}%) [{card}]")
    for line in lines[:12]:
        log(f"  {line}")
    return dict(wall_s=wall, device_busy_s=busy,
                top=[(e.key, e.self_device_time_total / 1e3, e.count) for e in events[:30]])


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 2
    if not (REPO / "storage_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))

    import numpy as np

    import storage_tpu_torch as stt
    from storage_tpu_torch.engines import lsmc as engine
    from storage_tpu_torch.ops import _build, decision_kernel, forward_kernel, rng_kernel

    device = torch.device("cuda", 0)
    OUT.mkdir(parents=True, exist_ok=True)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card} (torch: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda})")
    report = {"card": card, "kind": kind}

    # ---- build.
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    report["build_s"] = time.perf_counter() - t0
    log(f"build: {report['build_s']:.1f} s -> {lib_path.relative_to(REPO)}")
    ptxas = (lib_path.parent / "ptxas.log").read_text()
    (OUT / "ptxas.log").write_text(ptxas)
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    torch.cuda.synchronize()

    # ---- kernels against their plain versions.
    with engine.full_f32_matmul():
        kernels = check_kernels(stt, device)
    report["kernels"] = kernels

    # ---- the main path through the public API.
    value(stt, device, snap_interp=True)  # warm-up
    torch.cuda.synchronize()
    counted = (rng_kernel.normal_halves, decision_kernel.decision_update_moments,
               forward_kernel.forward_step)
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    res = value(stt, device, snap_interp=True)
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    launches = {fn.__name__: fn.launches for fn in counted}
    for _ in range(4):  # more timed valuations, for the spread
        t0 = time.perf_counter()
        value(stt, device, snap_interp=True)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    rate = NUM_SIMS * NUM_STEPS / wall
    z = check_npv(res.npv, res.val_sim_standard_error, snap_interp=True)
    log(f"main path (snap_interp=True): NPV {res.npv!r} SE {res.val_sim_standard_error!r} "
        f"(reference {REFERENCE_NPV}, z = {z:+.3f}); wall median {wall:.4f} s of "
        f"{[round(w, 4) for w in walls]} = {rate:.1f} paths*steps/s; launches {launches} "
        f"[{card}]")
    expected = {"normal_halves": 2, "decision_update_moments": NUM_STEPS, "forward_step": NUM_STEPS}
    if launches != expected:
        raise AssertionError(f"launch counts {launches}, expected {expected}")
    deltas = res.deltas.to_numpy()
    profile = res.expected_profile.to_numpy()
    if deltas.shape != (NUM_STEPS + 1,) or profile.shape != (NUM_STEPS + 1, 6):
        raise AssertionError("result shapes do not match the facility")
    if not (np.isfinite(deltas).all() and np.isfinite(profile).all()):
        raise AssertionError("non-finite deltas or profile")
    report["main_path"] = dict(npv=res.npv, se=res.val_sim_standard_error, wall_s=wall,
                               walls_s=walls, paths_steps_per_s=rate, z_vs_reference=z,
                               launches=launches)

    res_default = value(stt, device, snap_interp=False)
    torch.cuda.synchronize()
    z2 = check_npv(res_default.npv, res_default.val_sim_standard_error, snap_interp=False)
    log(f"main path (snap_interp=False, the port's default): NPV {res_default.npv!r} "
        f"SE {res_default.val_sim_standard_error!r} (z = {z2:+.3f})")
    report["main_path_default"] = dict(npv=res_default.npv, se=res_default.val_sim_standard_error)

    with engine.full_f32_matmul():
        npv_t, se_t = tpu_numerics_valuation(stt, device)
    torch.cuda.synchronize()
    z_t = (npv_t - REFERENCE_NPV) / se_t
    log(f"with the TPU run's numerics (bf16 inputs of L·z, u-coordinate moments): "
        f"NPV {npv_t!r} SE {se_t!r} (reference {REFERENCE_NPV}, z = {z_t:+.4f}, tolerance 0.1)")
    if not (math.isfinite(npv_t) and abs(z_t) <= 0.1):
        raise AssertionError(f"NPV {npv_t} is not within 0.1 SE of {REFERENCE_NPV}")
    report["tpu_numerics"] = dict(npv=npv_t, se=se_t, z_vs_reference=z_t)

    phases = phase_breakdown(stt, device)
    log(f"phases: host prep {phases['host_prep_s']:.4f} s, simulate {phases['simulate_s']:.4f} s, "
        f"backward {phases['backward_s']:.4f} s, "
        f"forward {phases['forward_s']:.4f} s, peak device memory {phases['peak_memory_gb']:.2f} GB "
        f"[{card}]")
    report["phases"] = phases
    report["profile"] = profile_valuation(stt, device, card)

    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": kernels[name]["max_abs_err"],
         "ms": kernels[name]["ms"], "plain_ms": kernels[name]["plain_ms"]}
        for name, (src, rep) in SOURCES.items()
    ]}
    (OUT / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=float))
    print(json.dumps(summary))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
