#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``storage_tpu_torch``) on one NVIDIA GPU.

1. Prints the card (``nvidia-smi`` name and power limit, torch's device name).
2. Builds the CUDA kernels from ``storage_tpu_torch/csrc`` and prints the
   build time and the compiler's register/spill report.
3. Holds each kernel against its plain PyTorch version on the card, at the
   main path's shapes (S=262,144 paths, G=100 grid points, D=3 decisions,
   B=9 basis functions and F=3 factors; B=4 and no factor for kernel D, R=3
   ratchet nodes), times both with CUDA events, and computes each kernel's
   bound (the least time the card could take for the same bytes and
   operations).  Kernels B and E are also held against their plain versions
   at G=1,000 (S=65,536, random inputs), B's outputs must be the same bits
   over two launches, B and E are also timed on random rows spanning the
   grid (the headline's follow g), and B's launch report (shared memory,
   blocks per SM, registers, spilled bytes, SASS instructions of the kernel
   for its padded basis size) is printed beside kernel D's.  B–E's bounds
   price the decision loop by issue slot (unfused f32, integer addresses,
   compares and selects) over the winner's interpolation alone.  The
   simulation sweep (kernel A fused with the OU steps and the spot) must
   give its plain version's factors and spot to the bit on the headline's
   tables (P=366, F=3) at seeds 11 and 13, and at S=1,000 over F = 1, 2, 3, 8, odd and even P, with and
   without antithetic signs; kernel A's draw-only entry keeps its threefry
   words bit-identical and its normals within 4 ULP.  Kernel D must give its plain
   version's bits (no error, no flipped argmax), also at G=1,000 (S=65,536)
   on rows following g and on random rows spanning the whole grid, and the
   same bits over two launches.
   Kernel C's sweep runs the main
   path's 365 steps on its real tables (a backward pass) and paths: against
   its plain version (per-sim paths may part only on a near-tie), against
   itself with the per-sim panels and against 365 one-step launches (the
   same bits); then at G=1,000 (8 steps, S=65,536) and on spot-only panels
   (32 steps), with the panels; its launch report and SASS size are
   printed.  The intrinsic DP kernel (one launch a valuation) is held in
   f64 and f32 against its plain version in f64 on the headline's tables
   (N=365, G=100, linear), the 2F pin facility on fixed spacing and with
   cubic interpolation, a custom grid, G=1,000 and one extra decision (f64:
   NPV within 1e-10 relative, profile within 1e-6, a decision flip only on a
   near-tie within 1e-9; f32: NPV within 1e-5 of the f64 answer), timed in
   f32 and f64 at G=100 and G=1,000 beside its bound and its launch report;
   then ``intrinsic_value(device="cuda")`` in f64 must hit the pins
   1,705,564.2806059965 (linspace) and 1,703,773.0757192627 (fixed spacing)
   within 1e-9 and the C# sample's 10,827.21 within 1e-3; its chain floor
   (2N - 1 links of a block barrier and a shared-memory read) and its
   largest G in each mode (at least 8,192 in f64 on linear rows) are
   printed.  The trinomial tree's DP kernel (the cluster route: one launch
   a valuation of one thread-block cluster; the large-slab route: one launch
   a step, one block a node row) is held in f64 and f32 against
   ``tree_plain`` in f64 on the reference's C# tree sample (T1: 16 steps,
   M=99, G=101), the two LSMC-against-tree oracle facilities (T2: 216
   steps, M=45, G=500), the headline facility on a 1-factor tree at a = 5.5
   (T3: 365 steps, M=99) and at a = 1.5 (T4, the widest lattice: M=361), T2
   with cubic interpolation and with a custom grid, T3 at E=1 (each on the
   cluster route, the large-slab route giving the same bits) and T1 at
   G=2,000 (T5: a slab the cluster cannot hold, the large-slab route) (f64:
   NPV within 1e-10 relative, values within 1e-9 of their row's scale,
   decisions along the centre, up and down branch paths parting only on a
   1e-9 near-tie; f32: NPV within 1e-5 of the f64 answer), timed at T3, T4
   and T5 beside its bound, its chain floor (N links of a cluster barrier
   and a read of another CTA's shared memory) and the large-slab route on
   the same tables; then through the API, each path with the launch
   counters reset just before it: ``trinomial_value(device="cuda")`` in f64
   must hit the C# sample's 24,799.09 within 5e-4, the port's 1-factor LSMC
   on the card (f32, 65,536 sims) must land within 3e-3 of the f64 tree on
   both T2 facilities, T3 is valued five times warm in f32 and f64 (T4
   once; T3's host phases timed apart) and T3's deltas taken over its 12
   monthly contracts; every tree path on the cluster route launches the
   tree kernel once a valuation and nothing else, T5's path the large-slab
   route once a step.  The host time of T4's lattice is printed
   beside that of the [N, M, M] copy the JAX package makes of it.
4. Values the repository's headline daily case through the public API —
   a 365-day ratcheted facility, 3-factor seasonal model, 9-term basis,
   262,144 paths per set, f32, seeds 11/13 — once to warm up, then five
   timed runs (the launch counters reset before the first); checks that
   the NPV is within 0.1 SE of the same valuation in f64 on the same draws
   and within 3 SE of the reference record (114,941.8, ``BENCH_r05.json``),
   and that the simulation sweep ran once for each path set (kernel A's
   draw-only entry never), kernel B once per backward step, kernel C once
   (one forward sweep per valuation) and the intrinsic DP once, its
   ``intrinsic_npv`` within 1e-5 of the pinned f64 answer.  Then the same valuation with the port's
   default ``snap_interp=False`` (held to the same bounds), with the TPU
   run's numerics (kernel A's draws rounded to bf16 with L, stepped by the
   sweep's plain loop; held within 0.1 SE of the record) and with antithetic
   draws (within 3 SE of the main path's NPV).
5. The round trip: the headline valuation with every per-sim panel
   (``sim_data_returned=ALL``), then ``value_from_sims`` fed its four path
   panels with the same flags must reproduce its NPV, SE and deltas to the
   bit; the per-sim PV and inventory panels must add up to the NPV and the
   expected profile.
6. ``value_from_sims`` on the headline's spot panels alone (basis
   1 + s + s² + s³): kernel D once per backward step, the NPV within 0.1 SE
   of the same valuation in f64, and the NPV and SE the bits pinned below.
6b. The grids phase ("grids phase: N s", right after the spot-only path, on
   its frames): inventory grids past every LSMC kernel's shared-memory
   route.  The Python route sizing equals each kernel's launch report
   (``kernel_info``'s max_grid) at 19 shapes, and the blocks per SM the
   route rule counts (B's two routes, D's kernel at 13 basis sizes) equal
   the launch reports' at 57 (C's on both sides of each crossing of its
   blocks rule); each large route (B, E, D at
   B=4 and 9, C monomial, general-grid and design mode) forced at G=100 (D
   at G=1,000) gives its shared route's bits; at G=4,096 on random inputs
   (S=65,536) each gives its plain version's bits or flips only on
   near-ties, and is timed with its plain version at S=262,144 beside its
   bound (the kernels line's ``*_large`` rows; B and E also on rows
   following g, ``band_rows_ms``, with B's launch report; D's with its
   registers, spills and blocks per SM at B=4 and 9, after
   ``pack_records`` held to its plain version's bits and timed by its own
   device time under torch.profiler at G=4,096 and 100).  Kernel C's
   digests: in every mode (monomial, general-grid on bunched, padded,
   custom and ascending rows, design, design on padded rows) on each route
   at G=100, 1,000 and 4,096 (``c_digest_cases``), the SHA-256 digests of
   its outputs equal the parent commit's (``C_DIGESTS``) and its plain
   version's values with no error and no flip; the log prints the bucket
   index's largest bracket on the padded rows.  Then,
   counters reset before each: the headline with every large route forced
   at G=100 (the pinned ``MAIN_NPV``/``MAIN_SE`` bits); the headline at
   G=1,000 (B on its large route by the rule: its routes, NPV,
   SE, wall, and the same bits with every route forced shared); at G=4,096
   and 262,144 paths the
   headline (B and C large, 365 + 1 launches), ``fullstep`` (E, within 0.05
   SE of it), the generic replica (D at B=9 and C's design mode, within 0.1
   SE), ``value_from_sims`` on the spot panels (D at B=4) and a custom grid
   of 4,096 bunched rows (C's general-grid mode), each with its launches,
   wall (median of 3) and peak memory; the headline and the custom grid at
   16,384 paths within 0.1 SE of their f64 answers on the same draws.
6c. The DP grids phase ("dp_grids phase: N s", right after the grids
   phase): the intrinsic DP and the tree past their shared routes.  The
   Python route sizing of each DP equals its launch report at 14 shapes,
   the intrinsic DP's large grid at 6 (and an H100's limits: 29,034 /
   14,506 intrinsic linear, 14,517 / 7,253 general, 11,613 / 5,802 cubic;
   the tree's step block 58,112 / 29,056, 19,371 / 9,686 cubic); each DP forced onto its large route gives its own
   route's bits (the intrinsic DP on the headline's tables in three modes,
   f32 and f64; the tree at T3 and T5); past the limits each large route
   holds to its plain version (``compare_intrinsic``, ``compare_tree``: the
   intrinsic DP at G=32,768 f32 and f64 on the headline's tables, on 10,001
   rows of a fixed 0.5-unit step in f64 and cubic at G=6,144 in f64; the
   tree at G=65,536 on T1's lattice in f32 and f64 and cubic at G=10,240 in
   f64 on a random 8-row lattice) and is timed beside its plain version,
   bound (the tree's twice: a whole decide a cell, and the table form),
   chain floor (grid links, launch links) and launch report (the kernels
   line's ``intrinsic_dp_large``, its cooperative grid's blocks held to
   ``intrinsic_kernel.large_grid_blocks``, and ``tree_dp_large``).  Then,
   counters reset before each,
   ``intrinsic_value`` at G=32,768 (f32) and on the 10,001 rows (f64),
   ``trinomial_value`` at G=65,536 on T1 and ``three_factor_seasonal_value``
   at G=32,768 on 16,384 paths, each with its wall, the DP kernel's own
   time, its launches by route and peak memory; the last one's route line
   names the intrinsic DP's large route.
7. The full-step backward (``lsmc_core(fullstep=True)``): kernel E once per
   backward step and no kernel B, the NPV within 0.05 SE of the main path's;
   the same valuation with E forced onto its wide route (every output the
   register route's bits, E's wide launches 365); its backward seconds
   beside the kernel-B-plus-glue backward.
8. The public host layer: kernel C's design mode (the forward step of a
   basis with a user callable, reading each step's raw design from memory)
   on the main path's tables with its nine monomials written out as the
   design, against its plain version (flips only on near-ties) and at
   G=1,000; the nine monomials as generic callables through
   ``forward_sweep_generic`` (the design built 32 steps at a time, one
   launch a chunk) the monomial mode's bits; kernel D at B=9 (a generic
   basis's backward on factor panels) the plain version's bits.  Then,
   each path with the counters reset: the replicated generic basis through
   ``three_factor_seasonal_value`` at the headline (within 0.1 SE of the
   main path's NPV; kernel D 365 launches, kernel B none, the design mode
   12, the intrinsic DP 1), an exp/indicator generic basis (reported, not
   gated), ``lsmc_value`` through the builder (the main path's NPV and SE
   bits at the default ``snap_interp``) and ``MultiFactorSpotSim`` on the
   card over the headline's model (its spot frame the sweep's bits).
8b. The caps phase ("caps phase: N s"): the route's copy of the monomial
   kernels' caps equals the library's; kernel D at B=20 (compiled) and 36
   (its wide route), C's design mode at B=20 (its wide route) on evenly
   spaced rows (365 steps) and bunched rows (64 steps), and the simulation
   sweep at F=10 (compiled; the 10-factor model's tables) and 13 (its wide
   route), whole and resumed, each against its plain version (D and the
   sweep the same bits, C flips only on near-ties), timed beside its bound
   with its launch report and the compiler's registers and spills (the
   kernels line's ``b20_*``, ``b36_*``, ``b20_uniform_*``,
   ``b20_general_*``, ``f10_*`` and ``f13_*`` keys); kernel E's wide route
   (past the caps) at 20 terms on the headline's 3-factor paths and 13 on
   the 10-factor model's, on its register row, at G=100 (the rule's grid
   route, the other forced to its bits) and G=1,000, against its plain
   version (flips counted, only on near-ties), the shared row forced to its
   bits, timed beside its bound and the shared row with B's wide body's
   launch report (the kernels line's ``decision_update_fullstep_wide`` row,
   its ``b13f10_*`` and ``*_g1000_*`` keys), each wide body's Python sizing
   held to the launch report on both sides of the route's crossing, and at
   the headline's B=9 forced onto each wide body: the register route's
   bits; then, counters reset before each, the headline facility at its
   full width with a 20-term basis (``three_factor_seasonal_value``) and
   with a 10-factor model (``multi_factor_value``, pairwise correlation
   0.3, 13 terms): each
   takes the design in memory on materialised paths (the sweep 2, D 365,
   C's design mode 12, the intrinsic DP 1) and lands within 0.1 SE of its
   f64 answer on the same draws (``F64_CAPS_NPV``), its wall and peak memory
   printed; beside each the same valuation with the engine's full step
   (``fullstep_engine``: the sweep 2, E 365 on its wide route, C's design
   mode 12, the intrinsic DP 1), within 0.05 SE of it on the same paths and
   its NPV the pinned bits ``CAPS_FULLSTEP_NPV``, the two timed in turns
   (full step, design in memory, design in memory, full step).  The
   headline keeps its route and its NPV bits (``MAIN_NPV``).
9. The service phase: the C++ band reducer against the Python band on the
   headline and an 8,760-step hourly year (the same f64 bits; medians of
   5, the hourly Python band timed once) and host prep with each, in turns; an interactive headline valuation
   (progress and cancel callbacks: the main path's bits, kernel C once a
   16-step segment, the JAX package's progress fractions), a cancel after
   the fifth progress call (``JobCancelledError`` in the backward, then the
   main path's bits again); the main path with ``checkpoint_path`` and
   forward-only revaluations from its checkpoint (the main path's NPV, one
   launch of kernel C and no other); ``CalculationService(device="cuda")``
   (the main path's bits with progress pushed; a second calc cancelled) and
   two 65,536-sim valuations at once on a two-thread job engine (their
   serial runs' bits; timed beside the pair one after the other);
   ``python3 -m storage_tpu_torch three-factor`` in a subprocess at 262,144
   sims (exit 0, the in-process call's lines and CSVs), and beside it a
   second one that gets SIGINT after its first progress line (exit 130,
   "cancelled").
10. Adjoint deltas and custom grids: the forward sweep's VJP kernel
   (``csrc/forward_vjp.cu``) against its plain version on the main path's
   own volume, fuel and spot panels (within 1e-5 of its largest entry), at
   g = 1/S against kernel C's pathwise-delta sums of the same sweep, at
   S=1,000 in f32 and f64, timed beside its bound and one einsum; kernel
   C's general-grid mode against its plain version on the main path's
   tables on bunched rows (monomial mode), padded rows (design mode) and
   at G=1,000, timed beside the evenly spaced mode; its bucket index
   (``general_tail``) its plain version's bits, each one's own device time
   (torch.profiler over 50 calls) beside one batched ``torch.searchsorted``
   of the rows' interior nodes against the bucket edges (its library
   time), and both host rates (CUDA events around back-to-back calls), at
   G=100 and 4,096.  Then, each path with
   the counters reset: the headline with ``deltas_method="adjoint"`` (the
   main path's NPV, SE, intrinsic value and profile bits, deltas for t < N
   within 1e-5 of the pathwise ones, the last the terminal value's gradient
   against its f64 formula on the same paths, one VJP launch; wall median
   of 3 beside the pathwise one's in turns, peak device memory); the
   headline on a custom grid (``bunched_grid``: within 0.1 SE of its f64
   answer ``F64_CUSTOM_NPV``, one general-mode sweep; wall median of 3);
   evenly spaced rows through ``grid_calc`` (the main path's bits); the
   adjoint on the custom grid (its pathwise deltas); the replicated generic
   basis on it (the design mode's general-grid launches); a checkpoint made
   on it, revalued on the same valuation paths (its NPV bits).
11. The streamed engine (after the spot-only path, on the round trip's
   frames): the simulation sweep resumed at a start step from its entry
   state against the sweep from step 0 and its plain version (S=1,000, F =
   1, 2, 3, 8, odd and even start steps, antithetic on and off: the same
   bits), a resumed 16-step segment of the hourly tables timed at 393,216
   paths; the headline through ``lsmc_core_streamed`` against ``lsmc_core``
   on materialised panels, walls in turns with the peak device memory of
   each (every output the same bits, the main path's NPV; the sweep 3 x 23
   launches, kernel C 23) and their adjoints (deltas within 1e-7);
   ``value_from_sims`` on the round trip's source frames with the threshold
   lowered, fed from host memory (the device-resident run's bits); the
   hourly year (8,760 steps, the headline's model, basis and grid) at 65,536
   paths streamed against materialised (the same bits; the materialised
   peak beside its footprint) and at 393,216 paths through the API, where
   the footprint selects streaming (its log line; NPV within 3 combined SE
   of the 65,536-path one; wall, paths*steps/s and peak memory printed).
12. The paths split over a process group (``parallel.mesh``, right after
   the streaming phase; "multi-GPU phase: N s" in the log): (a) a one-rank
   NCCL group in this process, the headline through the API the main
   path's bits; (b) two ranks in subprocesses (``--rank``; NCCL on two
   cards where the host has two, else gloo with both on card 0; they load
   this run's kernel library), a PASS or FAIL line each: the headline at
   131,072 paths a rank within 0.05 SE of (a), every reduced output the
   same bits on both ranks (pathwise, adjoint, streamed, host-local), A 2,
   B 365 and C 1 launches a rank and no plain version, each rank's wall,
   peak device memory and time in collectives (a run with every collective
   bracketed by synchronisations); the streamed route (threshold 0) the
   materialised bits; the ``--f64`` route at 16,384 paths within 1e-9 of
   one rank's; ``value_from_sims_host_local`` on each rank's half of the
   round trip's paths (their spot digests those of its frames) within 0.05
   SE of ``value_from_sims``, and on their spot alone (kernel D) within 0.1
   SE of the spot-only f64 answer.  Kernels A–D and the VJP are timed at a rank's share
   (131,072 paths) in this process, alone on the card.
13. A phase breakdown (host preparation, simulate, intrinsic, backward,
   forward) and one valuation under torch.profiler (device busy share,
   kernels by time).

Every path runs with the launch counters set to 0 just before it and read
just after.  The line before the last is the card; the one before it the
kernels' JSON summary (with the host's C++ band reducer as ``native_band``,
``route: "host"``, no bound); the last line is ``{"ok": true, "device":
{...}}``.  A
fuller report goes to ``build/chip_smoke/`` (``chip_smoke.json``,
``profile.txt``, ``ptxas.log``, each rank's ``rank<r>.json`` and
``rank<r>.log``).  Exits non-zero, printing no result, without
a CUDA device, outside the repository, or when any phase fails.

Run from the repository root:  python3 chip_smoke.py
``python3 chip_smoke.py --f64`` instead measures the f64 answers pinned below
(the kernels' plain versions in f64 on the card, on the f32 draws; the
custom grid's too) and prints them.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

REFERENCE_NPV = 114_941.8  # BENCH_r05.json: 262,144 x 365 x 100, seeds 11/13
# The same valuation in f64 on these draws (the f32 paths cast to f64, the
# kernels' plain versions on an H100), by snap_interp: what the f32 run
# should reproduce up to f32 rounding of the regressions.
F64_NPV = {True: 115_081.34206797711, False: 115_078.63334233503}
# The spot-only valuation of the headline's spot panels (SPOT_BASIS,
# snap_interp=True) in f64 the same way (``--f64``, NVIDIA H100 80GB HBM3).
F64_SPOT_NPV = 97_297.10184581533
# Its NPV and SE in f32 on the simulation sweep's paths (NVIDIA H100 80GB
# HBM3): the same arithmetic in any design of kernels C and D keeps these
# bits.
SPOT_NPV, SPOT_SE = 97_298.28125, 105.01128387451172
# The headline's NPV and SE in f32 (NVIDIA H100 80GB HBM3, since PR 7's
# paths): a change that keeps its route and arithmetic keeps these bits.
MAIN_NPV, MAIN_SE = 115_078.703125, 102.64122009277344
# The headline on the custom grid (``bunched_grid``) in f64 the same way
# (``--f64``): the f32 custom-grid valuation lands within 0.1 SE of it.
F64_CUSTOM_NPV = 115_081.24657122964
# The headline's intrinsic value in f64 (the DP's plain version on the card,
# ``--f64``): the f32 kernel of every valuation lands within 1e-5 of it.
F64_INTRINSIC_NPV = 46_977.992957453476
# The intrinsic pins (BASELINE.md): the 2F regression facility of
# tests/test_lsmc.py on linspace rows (tests/test_goldens.py:81) and on the
# reference's fixed spacing (its own pinned value, test_multi_factor.py:102),
# and the reference's C# intrinsic sample (README.md:404-440).
PIN_LINSPACE = 1_705_564.2806059965
PIN_FIXED_SPACING = 1_703_773.0757192627
PIN_CSHARP = 10_827.21
NUM_SIMS = 262_144
NUM_STEPS = 365
NUM_GRID = 100
# Kernels B and E are also held against their plain versions at a grid
# beyond the 338 points their first design could take (D=3, B=9).
BIG_GRID = 1_000
BIG_SIMS = 65_536
BASIS = "1 + x_st + x_lt + x_sw + x_st**2 + x_lt**2 + x_sw**2 + s + s**2"
SPOT_BASIS = "1 + s + s**2 + s**3"
REPO = Path(__file__).resolve().parent
OUT = REPO / "build" / "chip_smoke"
SOURCES = {  # kernel: (CUDA source, the TPU kernel's pallas_call it replaces)
    "simulate_sweep": ("storage_tpu_torch/csrc/sim_sweep.cu", "storage_tpu/ops/rng_kernel.py:175"),
    "normal_halves": ("storage_tpu_torch/csrc/rng_kernel.cu", "storage_tpu/ops/rng_kernel.py:175"),
    "decision_update_moments": ("storage_tpu_torch/csrc/decision_kernel.cu",
                                "storage_tpu/ops/decision_kernel.py:381"),
    "forward_sweep": ("storage_tpu_torch/csrc/forward_kernel.cu",
                      "storage_tpu/ops/forward_kernel.py:372"),
    "decision_update": ("storage_tpu_torch/csrc/decision_update_kernel.cu",
                        "storage_tpu/ops/decision_kernel.py:308"),
    "decision_update_fullstep": ("storage_tpu_torch/csrc/fullstep_kernel.cu",
                                 "storage_tpu/ops/decision_kernel.py:712"),
    # No Pallas kernel: the intrinsic DP's backward lax.scan (and the forward
    # one at :211).
    "intrinsic_dp": ("storage_tpu_torch/csrc/intrinsic_kernel.cu",
                     "storage_tpu/engines/intrinsic.py:193"),
    # No Pallas kernel: the tree's backward lax.scan (its step's dense dot at
    # :125), on the cluster route and on the large-slab route.
    "tree_dp": ("storage_tpu_torch/csrc/tree_kernel.cu", "storage_tpu/engines/tree.py:165"),
    "tree_dp_steps": ("storage_tpu_torch/csrc/tree_kernel.cu", "storage_tpu/engines/tree.py:165"),
    # Kernel C's design mode: the forward step of a generic basis, which the
    # JAX package runs on its XLA path (no Pallas kernel of its own).
    "forward_sweep_design": ("storage_tpu_torch/csrc/forward_kernel.cu",
                             "storage_tpu/ops/forward_kernel.py:372"),
    # The adjoint deltas' VJP of the forward sweep: jax.value_and_grad of the
    # XLA forward pass in the JAX package (no Pallas kernel).
    "forward_sweep_vjp": ("storage_tpu_torch/csrc/forward_vjp.cu",
                          "storage_tpu/engines/lsmc.py:1518"),
    # Kernel C's general-grid mode, in the monomial and the design mode: the
    # JAX package's XLA forward step with interp_per_sim_general on custom
    # rows (no Pallas kernel).
    "forward_sweep_general": ("storage_tpu_torch/csrc/forward_kernel.cu",
                              "storage_tpu/engines/lsmc.py:990"),
    "forward_sweep_design_general": ("storage_tpu_torch/csrc/forward_kernel.cu",
                                     "storage_tpu/engines/lsmc.py:990"),
    # Its bucket index over each next grid row, built before each launch of
    # the general-grid mode (the JAX forward step counts nodes instead).
    "general_tail": ("storage_tpu_torch/csrc/forward_kernel.cu",
                     "storage_tpu/engines/lsmc.py:990"),
    # The large grid routes (the grids phase): B, D and E with their step
    # tables a tile of grid points at a time, C's three modes with the
    # coefficients and grid rows in device memory.
    "decision_update_moments_large": ("storage_tpu_torch/csrc/decision_kernel.cu",
                                      "storage_tpu/ops/decision_kernel.py:381"),
    "decision_update_large": ("storage_tpu_torch/csrc/decision_update_kernel.cu",
                              "storage_tpu/ops/decision_kernel.py:308"),
    # Kernel D packs the step's records once before each launch (part of
    # kernel D's step; the TPU kernel took the tables as they are).
    "pack_records": ("storage_tpu_torch/csrc/decision_update_kernel.cu",
                     "storage_tpu/ops/decision_kernel.py:308"),
    "decision_update_fullstep_large": ("storage_tpu_torch/csrc/fullstep_kernel.cu",
                                       "storage_tpu/ops/decision_kernel.py:712"),
    # Kernel E's wide route past kernel B's register caps (the caps phase):
    # its solve, then B's wide body (decision_kernel.cu).
    "decision_update_fullstep_wide": ("storage_tpu_torch/csrc/fullstep_kernel.cu",
                                      "storage_tpu/ops/decision_kernel.py:712"),
    # Kernel B and kernel C's monomial mode past their register caps (16
    # terms, 8 factors): B's wide body without E's solve, C's wide route (the
    # caps phase's valuations).
    "decision_update_moments_wide": ("storage_tpu_torch/csrc/decision_kernel.cu",
                                     "storage_tpu/ops/decision_kernel.py:381"),
    "forward_sweep_wide": ("storage_tpu_torch/csrc/forward_kernel.cu",
                           "storage_tpu/ops/forward_kernel.py:372"),
    "forward_sweep_large": ("storage_tpu_torch/csrc/forward_kernel_large.cu",
                            "storage_tpu/ops/forward_kernel.py:372"),
    "forward_sweep_design_large": ("storage_tpu_torch/csrc/forward_kernel_large.cu",
                                   "storage_tpu/ops/forward_kernel.py:372"),
    "forward_sweep_general_large": ("storage_tpu_torch/csrc/forward_kernel_large.cu",
                                    "storage_tpu/engines/lsmc.py:990"),
    # The DPs' large routes (the DP grids phase): their rows in device memory.
    "intrinsic_dp_large": ("storage_tpu_torch/csrc/intrinsic_kernel.cu",
                           "storage_tpu/engines/intrinsic.py:193"),
    "tree_dp_large": ("storage_tpu_torch/csrc/tree_kernel.cu", "storage_tpu/engines/tree.py:165"),
}
# The H100 SXM's published peaks (NVIDIA's data sheet, at 700 W): device
# memory bandwidth, and float32 outside the tensor cores, which counts a
# fused multiply-add as two operations (128 lanes x 132 SMs x 1.98 GHz x 2).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Each SM sub-partition issues one warp instruction a clock: 32 lanes of
# f32, so one explicitly rounded (unfused) multiply or add a lane and clock,
# half the FMA-doubled rate.  This is also the rate at which instructions of
# every class together can issue.  32-bit integer add, shift and logic run
# on 16 lanes a sub-partition (64 per SM and clock on sm_90, CUDA C++
# Programming Guide, arithmetic instruction throughput), so an integer warp
# instruction holds its pipe two clocks while f32 ones go on issuing: the
# integer pipe alone runs at a quarter of the FMA-doubled rate.
F32_UNFUSED_OPS_PER_S = F32_OPS_PER_S / 2
INT32_OPS_PER_S = F32_OPS_PER_S / 4
# The draw's operations, counted from csrc/threefry.cuh: per threefry block
# 20 rounds of add/rotate/xor and 17 key-injection adds (integer); per
# normal 2 integer operations (the mantissa trick) and ~48 unfused f32 ones
# (log1p, a 9-term polynomial of separate multiplies and adds, the scaling).
THREEFRY_INT_OPS = 77
NORMAL_INT_OPS = 2
NORMAL_F32_OPS = 48
# expf, per spot value (its range reduction, polynomial and scaling).
EXP_F32_OPS = 8
# The intrinsic DP's unfused operations per decision at one inventory,
# counted from csrc/intrinsic_kernel.cu decide(): the volume (~3), its fuel,
# cash flows and PV (~11), the inventory after it (2), the linear
# continuation (~13: position, clamps, floor, weight, lerp) and the argmax
# (2); per inventory, the ratchet lookup (~10 + R) and the bang-bang ends
# (~12).
DP_OPS_PER_DECISION = 31
DP_OPS_PER_INVENTORY = 22
# A probe of the binary search of a general row (dp_common.cuh
# general_weights): the midpoint (an add and a shift), the load, the compare
# and the select.
DP_SEARCH_OPS_PER_PROBE = 4
# A decision from its table entry (dp_common.cuh entry_total): the PV at the
# price (7), the lerp on the next row (3), the total (1) and the argmax (2).
DP_OPS_PER_ENTRY = 13


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def terminal_npv(price, inventory):
    """The headline facility's terminal value."""
    return price * inventory


def bench_storage_kwargs(pkg) -> dict:
    """The headline facility as ``CmdtyStorage`` keywords (the service's
    ``create_storage`` takes them)."""
    import pandas as pd

    start = pd.Period("2021-01-01", freq="D")
    return dict(
        freq="D", storage_start=start, storage_end=start + NUM_STEPS, injection_cost=0.9,
        withdrawal_cost=0.7,
        ratchets=[
            (start, [(0.0, -200.0, 300.0), (2500.0, -250.0, 250.0), (5000.0, -300.0, 200.0)]),
        ],
        ratchet_interp=pkg.RatchetInterp.LINEAR,
        terminal_storage_npv=terminal_npv,
    )


def bench_case(pkg):
    """The headline daily case of ``__graft_entry__._build_case`` / bench.py."""
    import numpy as np
    import pandas as pd

    storage = pkg.CmdtyStorage(**bench_storage_kwargs(pkg))
    start = storage.start
    idx = pd.period_range(start, storage.end, freq="D")
    i = np.arange(len(idx))
    fwd = pd.Series(index=idx, data=30.0 + 6 * np.sin(2 * np.pi * i / 365.0))
    return storage, start, fwd


def value(pkg, device, snap_interp, basis=BASIS, num_sims=None, seed=11, fwd_sim_seed=13,
          **kwargs):
    """The headline valuation through the public API (``NUM_SIMS`` paths a
    set unless ``num_sims``)."""
    import torch

    storage, start, fwd = bench_case(pkg)
    return pkg.three_factor_seasonal_value(
        storage, start, 100.0, fwd, 0.02, None, 14.5, 1.1, 0.19, 0.23,
        num_sims or NUM_SIMS, basis, False, seed=seed, fwd_sim_seed=fwd_sim_seed,
        num_inventory_grid_points=NUM_GRID, dtype=torch.float32, device=device,
        snap_interp=snap_interp, **kwargs,
    )


def value_from_frames(pkg, device, spot_reg, spot_val, basis, **kwargs):
    """The headline facility valued on user panels through ``value_from_sims``."""
    import torch

    storage, start, fwd = bench_case(pkg)
    return pkg.value_from_sims(
        storage, start, 100.0, fwd, 0.02, None, spot_reg, spot_val, basis, False,
        num_inventory_grid_points=NUM_GRID, dtype=torch.float32, device=device,
        snap_interp=True, **kwargs,
    )


def bound(num_bytes: float, ops: float, unfused_ops: float = 0.0, int_ops: float = 0.0) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations' issue time.  ``ops`` are f32 operations
    counting a multiply-add as two, ``unfused_ops`` unfused f32 multiplies
    and adds, ``int_ops`` 32-bit integer operations.  Every instruction takes
    one issue slot (``ops``/2 + ``unfused_ops`` + ``int_ops`` lane-operations
    at the unfused rate), and the integer ones also take the integer pipe,
    which is half as wide: the operations' time is the larger of the two."""
    t_bytes = num_bytes / HBM_BYTES_PER_S
    t_ops = max((ops / 2 + unfused_ops + int_ops) / F32_UNFUSED_OPS_PER_S,
                int_ops / INT32_OPS_PER_S)
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes_ms=1e3 * t_bytes, ops_ms=1e3 * t_ops,
                bytes=num_bytes, ops=ops, unfused_ops=unfused_ops, int_ops=int_ops)


def draw_work(nb: int, s: int) -> tuple:
    """(bytes, unfused f32 operations, integer operations) of kernel A on nb
    block rows of S paths: ids in, two normals a pair out."""
    pairs = float(nb) * s
    return (4.0 * s + 8.0 * pairs, pairs * 2 * NORMAL_F32_OPS,
            pairs * (THREEFRY_INT_OPS + 2 * NORMAL_INT_OPS))


def sweep_work(p: int, f: int, s: int, antithetic: bool) -> tuple:
    """(bytes, unfused f32 operations, integer operations) of the simulation
    sweep: ids (and signs) and the step tables in, factors [P, F, S] and spot
    [P, S] out.  Per path: ceil(P·F/2) threefry blocks and P·F normals (times
    the sign when antithetic); per path and step the OU step (F·(2F−1) for
    L·z, 2F for the decay), the spot (2F) and one expf."""
    words = p * f
    num_bytes = 4.0 * ((2 if antithetic else 1) * s + (f + 1) * p * s + p * (2 * f + f * f + 1))
    per_step = f * (2 * f - 1) + 2 * f + 2 * f + EXP_F32_OPS
    unfused = float(s) * (words * (NORMAL_F32_OPS + (1 if antithetic else 0)) + p * per_step)
    ints = float(s) * (-(-words // 2) * THREEFRY_INT_OPS + words * NORMAL_INT_OPS)
    return num_bytes, unfused, ints


# The decision loop's issue slots a sim and grid point, counted from
# csrc/decision_step.cuh: decision 0's immediate value (2 unfused f32); per
# further decision its regressed gap over the B real terms (2B − 1), its
# immediate value (2) and their sum (1), then the strict > and the four
# selects of the running argmax (5, counted with the integer work); the
# winner's interpolation (1 − w, two products, their sum) and its immediate
# value (5 unfused); the addresses of the winner's two rows of v and of the
# two stores, 64-bit (7 integer).
DECIDE_F32_OPS = 7
DECIDE_F32_OPS_PER_DECISION = 3
DECIDE_INT_OPS = 7
DECIDE_INT_OPS_PER_DECISION = 5


def decision_work(g, s, d, b, f, moments: bool, design_in_memory: bool = False,
                  solve: bool = False):
    """(bytes, fused f32 operations, unfused f32 operations, integer
    operations) of one backward decision step, each input read once and
    each output written once: v [G, S] in and best_act [G, S] out, the step's
    spot (and, with moments, both steps' spot and factors or, for kernel D,
    the design [B, S]), the small tables (with ``solve``, kernel E's carried
    moments in and its regression out).  The decision loop is unfused
    (``DECIDE_*``: the argmax over D decisions, then the winner's
    interpolation alone); with moments, the design rows of two steps (~5B
    unfused each) and XᵀX and Xᵀv, fused, 2(B² + GB) a sim."""
    rows = 2 * g + 1 + (b if design_in_memory else 0) + ((2 + 2 * f - 1) if moments else 0)
    tables = d * g * b + 4 * d * g + 4 * b + (b * b + g * b if moments else 0)
    if solve:
        tables += b * b + 2 * b * g + 2 * b
    unfused = g * (DECIDE_F32_OPS + (d - 1) * (2 * b - 1 + DECIDE_F32_OPS_PER_DECISION))
    ints = g * (DECIDE_INT_OPS + (d - 1) * DECIDE_INT_OPS_PER_DECISION)
    fused = 0
    if moments:
        unfused += 10 * b
        fused += 2 * (b * b + g * b)
    return 4.0 * (rows * s + tables), float(fused) * s, float(unfused) * s, float(ints) * s


def near_tie_flips(got, want, regressed_sets):
    """Values beyond f32 rounding of the plain version's (1e-6 of its largest)
    are argmax flips; each must sit on a near-tie — the best two regressed
    values within 1e-5 of the largest — under one of the given sets of
    regressed values [D, G, S].  Returns (flips, unexplained, max abs err)."""
    import torch

    tol = 1e-6 * float(want.abs().max())
    mismatch = ~((got - want).abs() <= tol)
    near_tie = torch.zeros_like(mismatch)
    for regressed in regressed_sets:
        top2 = regressed.topk(2, dim=0).values
        near_tie |= (top2[0] - top2[1]) <= 1e-5 * float(regressed.abs().max())
    return (int(mismatch.sum()), int((mismatch & ~near_tie).sum()),
            float((got - want).abs().max()))


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


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


def launch_ms(module, name: str, run, repeats: int):
    """Device milliseconds that the calls ``run`` makes to ``module.name``
    take, by CUDA events around each call, summed over a run (the mean of
    ``repeats`` runs after a warm-up run), and the calls a run makes."""
    return launches_ms([(module, name)], run, repeats)[name]


@contextlib.contextmanager
def call_spans(targets):
    """CUDA events around every call of the wrappers ``targets``, (module,
    name) each, inside the block: yields {name: [(start, end), ...]}.  A
    wrapper counts its launches on the name its module binds, the timing
    wrapper inside the block: the counters are handed back on leaving it."""
    import functools

    import torch

    inners, spans = {name: getattr(module, name) for module, name in targets}, {}

    def timing(name):
        inner, spans[name] = inners[name], []

        @functools.wraps(inner)
        def timed(*a, **k):
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            result = inner(*a, **k)
            end.record()
            spans[name].append((start, end))
            return result
        return timed

    wrappers = {name: timing(name) for _, name in targets}
    for module, name in targets:
        setattr(module, name, wrappers[name])
    try:
        yield spans
    finally:
        for module, name in targets:
            inner, timed = inners[name], wrappers[name]
            setattr(module, name, inner)
            for counter in ("launches", "step_launches", "general_launches", "large_launches",
                            "wide_launches", "wide_smem_launches"):
                if hasattr(inner, counter):
                    setattr(inner, counter, getattr(timed, counter))


def spans_ms(spans) -> float:
    """Milliseconds of a list of (start, end) CUDA events, summed (the device
    synchronised first)."""
    import torch

    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in spans)


def launches_ms(targets, run, repeats: int) -> dict:
    """``launch_ms`` of several wrappers, (module, name) each, timed in the
    same runs: {name: (ms summed over a run, calls a run)}."""
    run()
    with call_spans(targets) as spans:
        for _ in range(repeats):
            run()
    return {name: (spans_ms(spans[name]) / repeats, len(spans[name]) // repeats)
            for name in spans}


def backward_step_inputs(pkg, device):
    """One backward step (t = 180) of the main path: the headline facility's
    arrays, a simulated regression panel, random values and coefficients of
    realistic size; the arguments of kernel B (``args_b``) and of kernel D on
    the step's spot-only design (``args_d``, basis ``SPOT_BASIS``)."""
    import types

    import torch

    from storage_tpu_torch.basis import parse_basis_functions
    from storage_tpu_torch.engines import lsmc as engine
    from storage_tpu_torch.models import spot_sim
    from storage_tpu_torch.ops import interp

    s = NUM_SIMS
    inputs, sim_in, arrays, monomials = engine_inputs(pkg, device)
    sims = spot_sim.simulate_ou_paths(spot_sim.key_from_seed(11), torch.arange(s, device=device),
                                      *sim_in)
    t = min(180, NUM_STEPS // 2)
    gen = torch.Generator(device=device).manual_seed(5)
    prep = engine._backward_prep_all(arrays, 0, False, snap_interp=True)
    step = dict(idx_lo=prep["idx_lo"][t], w_hi=prep["w_hi"][t], a=prep["a"][t], b=prep["b"][t])
    mean, std = engine._design_stats(monomials, sims.spot[t - 1:t + 1], sims.factors[t - 1:t + 1])
    grid_next = arrays["grids"][t + 1]
    v = (grid_next[:, None] * sims.spot[t + 1][None, :]
         + 40.0 * torch.randn((NUM_GRID, s), generator=gen, device=device)).contiguous()
    coeffs = torch.randn((len(monomials), NUM_GRID), generator=gen, device=device) * 50.0
    coeffs[0] = grid_next * 30.0
    ci = interp.interp_coeffs(coeffs, step["idx_lo"], step["w_hi"])
    args_b = (v, sims.spot[t], sims.factors[t], sims.spot[t - 1], sims.factors[t - 1],
              mean[1], std[1], mean[0], std[0], step["idx_lo"], step["w_hi"], ci,
              step["a"], step["b"], monomials)
    spot_monomials = tuple(parse_basis_functions(SPOT_BASIS))
    no_factors = sims.factors[t][:0]
    m_s, s_s = engine._design_stats(spot_monomials, sims.spot[t:t + 1], no_factors[None])
    dm_t = engine._standardised_design_t(spot_monomials, sims.spot[t], no_factors, m_s[0], s_s[0])
    coeffs_s = torch.randn((len(spot_monomials), NUM_GRID), generator=gen, device=device) * 50.0
    coeffs_s[0] = grid_next * 30.0
    ci_s = interp.interp_coeffs(coeffs_s, step["idx_lo"], step["w_hi"])
    args_d = (v, dm_t, sims.spot[t], step["idx_lo"], step["w_hi"], ci_s, step["a"], step["b"])
    return types.SimpleNamespace(
        inputs=inputs, arrays=arrays, monomials=monomials, sims=sims, t=t, gen=gen, step=step,
        mean=mean, std=std, v=v, coeffs=coeffs, args_b=args_b,
        spot_monomials=spot_monomials, args_d=args_d)


def random_step(device, g, s, seed):
    """Kernel B's arguments at G grid points, S sims, D=3 and the headline
    basis, from a seed: random values, paths, stats, interpolation rows and
    coefficients (the grid-limit checks, beyond the headline's G)."""
    import torch

    from storage_tpu_torch.basis import parse_basis_functions

    gen = torch.Generator(device=device).manual_seed(seed)
    monomials = tuple(parse_basis_functions(BASIS))
    b, d, f = len(monomials), 3, 3
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=device)  # noqa: E731
    return (100.0 + 30.0 * rnd(g, s), 30.0 + 5.0 * rnd(s), rnd(f, s), 30.0 + 5.0 * rnd(s),
            rnd(f, s), 0.3 * rnd(b), 1.0 + 0.2 * rnd(b).abs(), 0.3 * rnd(b),
            1.0 + 0.2 * rnd(b).abs(),
            torch.randint(0, g - 1, (g, d), generator=gen, device=device, dtype=torch.int32),
            torch.rand((g, d), generator=gen, device=device), 20.0 * rnd(d, g, b),
            2.0 * rnd(d, g), 20.0 * rnd(d, g), monomials)


def band_rows(args_b):
    """Kernel B's arguments with the interpolation rows following g in a band
    of ±5 (as a valuation's interpolated targets give) in place of theirs."""
    import torch

    idx_lo = args_b[9]
    g, d = idx_lo.shape
    offsets = 5 * torch.arange(d, device=idx_lo.device) - 5 * (d // 2)
    band = (torch.arange(g, device=idx_lo.device)[:, None] + offsets[None, :]).clamp(0, g - 2)
    return (*args_b[:9], band.to(torch.int32).contiguous(), *args_b[10:])


def random_update(device, g, s, seed, monotone: bool):
    """Kernel D's arguments at G grid points, S sims, D=3 and B=4 from a
    seed: random values, design, spot and coefficients, with interpolation
    rows either following g in a band of ±5 ("monotone", as interpolated
    targets give) or random in [0, G−2], spanning the whole grid (rows 0 and
    G−2 at every grid point)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=device)  # noqa: E731
    b, d = 4, 3
    if monotone:
        idx_lo = (torch.arange(g, device=device)[:, None]
                  + torch.tensor([-5, 0, 5], device=device)[None, :]).clamp(0, g - 2)
    else:
        idx_lo = torch.randint(0, g - 1, (g, d), generator=gen, device=device)
        idx_lo[:, 0], idx_lo[:, -1] = 0, g - 2
    return (100.0 + 30.0 * rnd(g, s), rnd(b, s), 30.0 + 5.0 * rnd(s),
            idx_lo.to(torch.int32).contiguous(), torch.rand((g, d), generator=gen, device=device),
            20.0 * rnd(d, g, b), 2.0 * rnd(d, g), 20.0 * rnd(d, g))


def compare_d(args_d) -> dict:
    """Kernel D against its plain version on ``args_d``, and against itself
    over two launches.  The kernel does the plain version's arithmetic in the
    same order, so every best_act value must be the same bits: no error and
    no flipped argmax."""
    import torch

    from storage_tpu_torch.ops import decision_kernel

    got = decision_kernel.decision_update(*args_d).clone()
    repeat_same = bool(torch.equal(got, decision_kernel.decision_update(*args_d)))
    want = decision_kernel.decision_update_plain(*args_d)
    err = float((got - want).abs().max())
    differ = int((got != want).sum())
    ok = differ == 0 and repeat_same
    text = (f"best_act max abs err {err:.3e}, {differ} of {got.numel()} values differ "
            f"(tolerance 0: no error, no flipped argmax); bit-identical over two launches: "
            f"{repeat_same}")
    return dict(ok=ok, text=text, max_abs_err=err, flips=differ,
                bit_identical_over_two_launches=repeat_same)


def compare_b(args_b) -> dict:
    """Kernel B against its plain version on ``args_b``, and against itself
    over two launches.  The kernel does the plain version's arithmetic in the
    same order, so a best_act value may differ beyond f32 rounding only where
    the argmax flipped, and it may flip only on a near-tie of the regressed
    values; the moments are f32 sums in another order (1e-4 relative), and
    the same bits on every launch."""
    import torch

    from storage_tpu_torch.ops import decision_kernel

    got = [x.clone() for x in decision_kernel.decision_update_moments(*args_b)]
    again = decision_kernel.decision_update_moments(*args_b)
    repeat_same = all(torch.equal(x, y) for x, y in zip(got, again))
    del again
    want = decision_kernel.decision_update_moments_plain(*args_b)
    regressed = torch.stack([r for r, _ in decision_kernel.decision_values(
        *args_b[:3], *args_b[5:7], *args_b[9:])])  # [D, G, S]
    flips, unexplained, err = near_tie_flips(got[0], want[0], [regressed])
    del regressed
    mom_err = max(rel_err(got[i], want[i]) for i in (1, 2))
    n = got[0].numel()
    ok = not unexplained and flips <= 1e-5 * n and mom_err <= 1e-4 and repeat_same
    text = (f"best_act max abs err {err:.3e}; {flips} of {n} beyond f32 rounding (argmax "
            f"flips), {unexplained} of them off a near-tie (tolerance 0); moments max rel err "
            f"{mom_err:.3e} (tolerance 1e-4: f32 sums over the sims in another order); "
            f"best_act, XtX and Xtv bit-identical over two launches: {repeat_same}")
    return dict(ok=ok, text=text, max_abs_err=err, flips=flips, unexplained_flips=unexplained,
                moments_max_rel_err=mom_err, bit_identical_over_two_launches=repeat_same)


def compare_e(args_e, prev, wide: bool = False) -> dict:
    """Kernel E against its plain version on ``args_e`` (with ``prev``, the
    stats of the next moments): the regression within 1e-4 relative (both
    factor the f32 system in double, the kernel by its own loop, the plain
    version with torch.linalg),
    the step bit-identical to kernel B run on E's own regression, argmax
    flips only on near-ties of either regression's values, the moments
    within 1e-4 relative.  With ``wide`` (E's wide route, past kernel B's
    caps, where B's register kernels do not run) the step is held to the
    plain version alone."""
    import torch

    from storage_tpu_torch.ops import decision_kernel, interp

    v, spot, factors, spot_prev, factors_prev, _, _, _, _, idx_lo, w_hi, a, b, monomials = args_e
    got = decision_kernel.decision_update_fullstep(*args_e, **prev)
    want = decision_kernel.decision_update_fullstep_plain(*args_e, **prev)
    reg_err = max(rel_err(got[i], want[i]) for i in (3, 4, 5))
    mom_err = max(rel_err(got[i], want[i]) for i in (1, 2))
    ci_k = interp.interp_coeffs(got[5], idx_lo, w_hi)
    if wide:
        bit_identical = None
    else:
        same = decision_kernel.decision_update_moments(
            v, spot, factors, spot_prev, factors_prev, got[3], got[4], prev["mean_prev"],
            prev["std_prev"], idx_lo, w_hi, ci_k, a, b, monomials)
        bit_identical = all(torch.equal(got[i], same[i]) for i in range(3))
        del same
    ci_p = interp.interp_coeffs(want[5], idx_lo, w_hi)
    regressed = [torch.stack([r for r, _ in decision_kernel.decision_values(
        v, spot, factors, m_, s_, idx_lo, w_hi, c_, a, b, monomials)])
        for m_, s_, c_ in ((want[3], want[4], ci_p), (got[3], got[4], ci_k))]
    flips, unexplained, err = near_tie_flips(got[0], want[0], regressed)
    del regressed
    n = got[0].numel()
    ok = (reg_err <= 1e-4 and mom_err <= 1e-4 and bit_identical is not False
          and not unexplained and flips <= 1e-5 * n)
    text = (f"mean/std/coeffs max rel err {reg_err:.3e} (tolerance 1e-4: the kernel's double "
            f"Cholesky rounds otherwise than torch.linalg's); step bit-identical to kernel B on its own "
            f"regression: {'not run (past its caps)' if wide else bit_identical}; best_act max "
            f"abs err {err:.3e}, {flips} argmax flips, "
            f"{unexplained} off a near-tie (tolerance 0); moments max rel err {mom_err:.3e} "
            f"(tolerance 1e-4)")
    return dict(ok=ok, text=text, max_abs_err=err, flips=flips, unexplained_flips=unexplained,
                regression_max_rel_err=reg_err, moments_max_rel_err=mom_err,
                bit_identical_to_b=bit_identical)


# SASS opcodes by class, for the launch reports of kernel A and the sweep.
SASS_CLASSES = {
    "int32": ("IADD3", "IADD", "LOP3", "SHF", "SHL", "SHR", "IMAD", "IMUL", "ISETP", "LEA", "IABS",
              "IMNMX", "SEL", "PRMT", "POPC", "FLO", "BREV"),
    "f32": ("FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX", "FCHK", "FSET", "FRND"),
    "mufu": ("MUFU",),
    "memory": ("LDG", "STG", "LDC", "ULDC", "LDS", "STS", "LD", "ST", "LDL", "STL"),
}


def sass_classes(kernel: str) -> dict:
    """Static SASS instructions of the built kernel(s) whose name holds
    ``kernel``, by class (every opcode of no class under "other")."""
    from storage_tpu_torch.ops import _build

    opcodes = _build.sass_opcodes(_build.library_path(), kernel)
    out = {name: sum(opcodes[o] for o in ops) for name, ops in SASS_CLASSES.items()}
    out["other"] = sum(opcodes.values()) - sum(out.values())
    out["total"] = sum(opcodes.values())
    return out


def ulp_diff(got, want) -> int:
    """Largest distance in units in the last place between two f32 tensors
    (0: the same bits)."""
    import torch

    a, b = got.view(torch.int32).to(torch.int64), want.view(torch.int32).to(torch.int64)
    return int((a - b).abs().max())


def compare_paths(got, want) -> dict:
    """The sweep's (factors, spot) against its plain version's: the kernel
    does the plain version's operations in its order, with the same expf, so
    both must be the same bits."""
    import torch

    same = bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    return dict(bit_identical=same, max_abs_err=err, factors_max_ulp=ulp_diff(got[0], want[0]),
                spot_max_ulp=ulp_diff(got[1], want[1]))


def sweep_tables(device, p, f, seed):
    """Random OU step tables over P steps at F factors (decay, chol, vols, c)
    from a seed: the checks beyond the headline's F = 3."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    decay = 0.6 + 0.4 * torch.rand((p, f), generator=gen, device=device)
    chol = torch.tril(0.1 * torch.randn((p, f, f), generator=gen, device=device)).contiguous()
    vols = 0.5 + torch.rand((p, f), generator=gen, device=device)
    c = 3.4 + 0.1 * torch.randn(p, generator=gen, device=device)
    return decay, chol, vols, c


def check_sweep(pkg, device) -> dict:
    """The simulation sweep against ``simulate_sweep_plain`` on the headline's
    step tables (P=366, F=3, S=262,144) at seeds 11 and 13, then at S=1,000
    over F = 1, 2, 3 and 8, odd and even P, with and without antithetic
    signs: every factor and spot value the same bits.  Times the sweep (20
    calls) and its plain version; its bound, launch report and SASS."""
    import torch

    from storage_tpu_torch.models import spot_sim
    from storage_tpu_torch.ops import rng_kernel

    _, sim_in, _, _ = engine_inputs(pkg, device)
    decay, chol, vols, half_var, fwd = sim_in
    c = torch.log(fwd) - half_var
    p, f = decay.shape
    s = NUM_SIMS
    ids = torch.arange(s, dtype=torch.int32, device=device)
    checks = {}
    for seed in (11, 13):
        key = spot_sim.key_from_seed(seed)
        got = rng_kernel.simulate_sweep(key, ids, None, decay, chol, vols, c)
        want = rng_kernel.simulate_sweep_plain(key, ids, None, decay, chol, vols, c)
        checks[f"main_seed_{seed}"] = compare_paths(got, want)
        del got, want
    path_ids = torch.arange(1000, device=device) + 77
    for f_x, p_x in ((1, 9), (2, 9), (3, 7), (3, 8), (8, 9), (8, 366)):
        for antithetic in (False, True):
            ids_x = (path_ids // 2 if antithetic else path_ids).to(torch.int32)
            sign = (1.0 - 2.0 * (path_ids % 2)).float() if antithetic else None
            tables = sweep_tables(device, p_x, f_x, seed=f_x + p_x)
            got = rng_kernel.simulate_sweep((5, 7), ids_x, sign, *tables)
            want = rng_kernel.simulate_sweep_plain((5, 7), ids_x, sign, *tables)
            checks[f"F={f_x},P={p_x}{',antithetic' if antithetic else ''}"] = compare_paths(got, want)
    key = spot_sim.key_from_seed(11)
    ms = cuda_ms(lambda: rng_kernel.simulate_sweep(key, ids, None, decay, chol, vols, c), 20)
    plain_ms = cuda_ms(lambda: rng_kernel.simulate_sweep_plain(key, ids, None, decay, chol, vols, c),
                       1)
    num_bytes, unfused, ints = sweep_work(p, f, s, antithetic=False)
    bnd = bound(num_bytes, 0.0, unfused, ints)
    info = rng_kernel.sweep_info(f, device)
    sass = sass_classes(rng_kernel.sweep_sass_name(f))
    sass_a = sass_classes("normal_halves_kernel")
    main = [checks[f"main_seed_{seed}"] for seed in (11, 13)]
    log(f"simulation sweep [P={p}, F={f}, S={s}], the headline's tables, seeds 11 and 13: factors "
        f"and spot bit-identical to simulate_sweep_plain: {[c_['bit_identical'] for c_ in main]} "
        f"(tolerance: the same bits; max {max(c_['factors_max_ulp'] for c_ in main)} ULP in the "
        f"factors, {max(c_['spot_max_ulp'] for c_ in main)} in the spot); {ms:.4f} ms a path set "
        f"vs plain {plain_ms:.1f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}; bytes "
        f"{1e3 * bnd['bytes'] / HBM_BYTES_PER_S:.4f} ms); launch: {info['paths_per_block']} paths "
        f"a block, {info['smem_bytes']} bytes of shared memory, {info['blocks_per_sm']} blocks per "
        f"SM, {info['registers']} registers; static SASS {sass}; kernel A's static SASS {sass_a}")
    small = {k: v_ for k, v_ in checks.items() if not k.startswith("main")}
    log("simulation sweep at S=1,000 (random tables): " + "; ".join(
        f"{k}: {'same bits' if v_['bit_identical'] else 'DIFFERS: ' + repr(v_)}"
        for k, v_ in small.items()))
    bad = [k for k, v_ in checks.items() if not v_["bit_identical"]]
    if bad:
        raise AssertionError(f"the simulation sweep disagrees with its plain version: {bad}")
    return dict(max_abs_err=max(c_["max_abs_err"] for c_ in main), ms=ms, plain_ms=plain_ms,
                checks=checks, launch=info, sass=sass, sass_normal_halves=sass_a, **bnd)


def check_kernels(pkg, device):
    """Each kernel against its plain version on the card at main-path shapes,
    with its time, its plain version's and its bound."""
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
    ulp = max(ulp_diff(z1, q1), ulp_diff(z2, q2))
    identical = float(((z1 == q1).float().mean() + (z2 == q2).float().mean()) / 2)
    err_a = float(torch.maximum((z1 - q1).abs().max(), (z2 - q2).abs().max()))
    del z1, z2, q1, q2
    ms = cuda_ms(lambda: rng_kernel.normal_halves(key, 0, nb, ids), 20)
    plain_ms = cuda_ms(lambda: rng_kernel.normal_halves_plain(key, 0, nb, ids), 3)
    num_bytes, unfused, ints = draw_work(nb, s)
    bnd = bound(num_bytes, 0.0, unfused, ints)
    log(f"kernel A normal_halves [{nb} x {s}]: words bit-identical={words_equal}, "
        f"normals max {ulp} ULP (tolerance 4), bit-identical share {identical:.6f}, "
        f"max abs err {err_a:.3e}; {ms:.3f} ms vs plain {plain_ms:.3f} ms, "
        f"bound {bnd['bound_ms']:.3f} ms ({bnd['bound_by']})")
    if not words_equal or ulp > 4:
        raise AssertionError("kernel A disagrees with its plain version")
    results["normal_halves"] = dict(max_abs_err=err_a, ms=ms, plain_ms=plain_ms,
                                    max_ulp=ulp, words_bit_identical=words_equal, **bnd)
    results["simulate_sweep"] = check_sweep(pkg, device)

    st = backward_step_inputs(pkg, device)
    monomials, sims, t = st.monomials, st.sims, st.t
    step, mean, std, v = st.step, st.mean, st.std, st.v
    b_dim = len(monomials)
    args_b = st.args_b

    # ---- B: the backward step at step t, then at G=1,000 grid points (beyond
    # the 338 of its first design); its launch report beside kernel D's.
    out = torch.empty_like(v)
    cmp_b = compare_b(args_b)
    ms = cuda_ms(lambda: decision_kernel.decision_update_moments(*args_b, out=out), 20)
    plain_ms = cuda_ms(lambda: decision_kernel.decision_update_moments_plain(*args_b), 5)
    bnd = bound(*decision_work(NUM_GRID, s, 3, b_dim, f, moments=True))
    log(f"kernel B decision_update_moments [G={NUM_GRID}, S={s}, D=3, B={b_dim}]: {cmp_b['text']}; "
        f"{ms:.3f} ms vs plain {plain_ms:.3f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
    # The same launch on random rows spanning the grid (the headline's
    # follow g), and the launch report of the kernel for B's padded size.
    rnd = random_step(device, NUM_GRID, s, seed=8)
    ms_random = cuda_ms(lambda: decision_kernel.decision_update_moments(*rnd, out=out), 20)
    report_b = moments_launch_report(device, NUM_GRID, b_dim)
    log(f"kernel B on random rows [G={NUM_GRID}, S={s}]: {ms_random:.4f} ms; its launch: "
        f"{launch_text(report_b)}; bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}; bytes "
        f"{bnd['bytes_ms']:.4f}, issue {bnd['ops_ms']:.4f})")
    big = random_step(device, BIG_GRID, BIG_SIMS, seed=7)
    cmp_big = compare_b(big)
    log(f"kernel B decision_update_moments [G={BIG_GRID}, S={BIG_SIMS}, D=3, B={b_dim}, random "
        f"inputs]: {cmp_big['text']}")
    launch = {name: decision_kernel.kernel_info(kind, NUM_GRID, 3, bd, device)
              for name, kind, bd in (("B", "moments", b_dim), ("D", "update", b_dim),
                                     ("D_spot_only", "update", len(st.spot_monomials)))}
    log("launch reports (kernel at G=100, D=3): " + "; ".join(
        f"{name} at B={bd}: {r['smem_bytes']} bytes of shared memory per block (limit "
        f"{r['smem_limit']}, so G <= {r['max_grid']}), {r['blocks_per_sm']} blocks of "
        f"{r['sims_per_block']} sims per SM, {r['registers']} registers"
        for (name, r), bd in zip(launch.items(), (b_dim, b_dim, len(st.spot_monomials)))))
    for c in (cmp_b, cmp_big):
        if not c["ok"]:
            raise AssertionError(f"kernel B disagrees with its plain version: {c['text']}")
    results["decision_update_moments"] = dict(
        max_abs_err=cmp_b["max_abs_err"], ms=ms, plain_ms=plain_ms,
        **{k: v_ for k, v_ in cmp_b.items() if k not in ("text", "max_abs_err")},
        big_grid=dict(G=BIG_GRID, S=BIG_SIMS, **{k: v_ for k, v_ in cmp_big.items() if k != "text"}),
        launch=launch, random_rows_ms=ms_random, launch_report=report_b, **bnd)

    # ---- D: the same step on spot-only panels (basis 1 + s + s² + s³): the
    # design [B, S] standardised by the step's exact stats, as the engine's
    # spot-only backward passes it; then at G=1,000 on rows following g and
    # on random rows spanning the whole grid.  Every value the plain
    # version's bits.
    spot_monomials = st.spot_monomials
    args_d = st.args_d
    cmp_d = compare_d(args_d)
    ms = cuda_ms(lambda: decision_kernel.decision_update(*args_d, out=out), 20)
    plain_ms = cuda_ms(lambda: decision_kernel.decision_update_plain(*args_d), 5)
    bnd = bound(*decision_work(NUM_GRID, s, 3, len(spot_monomials), 0, moments=False,
                               design_in_memory=True))
    log(f"kernel D decision_update [G={NUM_GRID}, S={s}, D=3, B={len(spot_monomials)}]: "
        f"{cmp_d['text']}; {ms:.4f} ms vs plain {plain_ms:.3f} ms, "
        f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
    big_d = {}
    for kind, monotone in (("monotone", True), ("whole-grid", False)):
        args_big = random_update(device, BIG_GRID, BIG_SIMS, seed=9, monotone=monotone)
        big_d[kind] = compare_d(args_big)
        log(f"kernel D decision_update [G={BIG_GRID}, S={BIG_SIMS}, D=3, B=4, {kind} rows]: "
            f"{big_d[kind]['text']}")
        del args_big
    for c in (cmp_d, *big_d.values()):
        if not c["ok"]:
            raise AssertionError(f"kernel D disagrees with its plain version: {c['text']}")
    results["decision_update"] = dict(
        max_abs_err=cmp_d["max_abs_err"], ms=ms, plain_ms=plain_ms,
        **{k: v_ for k, v_ in cmp_d.items() if k not in ("text", "max_abs_err")},
        big_grid={kind: dict(G=BIG_GRID, S=BIG_SIMS, **{k: v_ for k, v_ in c.items() if k != "text"})
                  for kind, c in big_d.items()},
        launch=launch["D_spot_only"], **bnd)

    # ---- E: the whole step from step t's moments against v, centred by its
    # exact stats, with step t-1's stats for the next moments (as the engine);
    # then at G=1,000 grid points on random inputs.
    dm = decision_kernel._standardised_design(monomials, sims.spot[t], sims.factors[t], mean[1],
                                              std[1])
    xtx, xty = dm.T @ dm, dm.T @ v.T
    del dm
    args_e = (v, sims.spot[t], sims.factors[t], sims.spot[t - 1], sims.factors[t - 1], xtx, xty,
              mean[1], std[1], step["idx_lo"], step["w_hi"], step["a"], step["b"], monomials)
    prev = dict(mean_prev=mean[0], std_prev=std[0])
    cmp_e = compare_e(args_e, prev)
    ms = cuda_ms(lambda: decision_kernel.decision_update_fullstep(*args_e, **prev, out=out), 20)
    plain_ms = cuda_ms(lambda: decision_kernel.decision_update_fullstep_plain(*args_e, **prev), 5)
    bnd = bound(*decision_work(NUM_GRID, s, 3, b_dim, f, moments=True, solve=True))
    e_rnd, e_prev = fullstep_args(rnd)
    ms_random = cuda_ms(lambda: decision_kernel.decision_update_fullstep(*e_rnd, **e_prev, out=out),
                        20)
    log(f"kernel E decision_update_fullstep [G={NUM_GRID}, S={s}, D=3, B={b_dim}, F={f}]: "
        f"{cmp_e['text']}; {ms:.3f} ms ({ms_random:.4f} on random rows) vs plain "
        f"{plain_ms:.3f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
    del args_e, e_rnd, rnd
    v_b, spot_b, fac_b, spot_pb, fac_pb, mean_b, std_b, mean_pb, std_pb, idx_b, w_b, _, a_b, b_b, \
        _ = big
    dm = decision_kernel._standardised_design(monomials, spot_b, fac_b, mean_b, std_b)
    args_big = (v_b, spot_b, fac_b, spot_pb, fac_pb, dm.T @ dm, dm.T @ (0.9 * v_b.T), mean_b,
                std_b, idx_b, w_b, a_b, b_b, monomials)
    del dm
    cmp_e_big = compare_e(args_big, dict(mean_prev=mean_pb, std_prev=std_pb))
    log(f"kernel E decision_update_fullstep [G={BIG_GRID}, S={BIG_SIMS}, D=3, B={b_dim}, random "
        f"inputs]: {cmp_e_big['text']}")
    for c in (cmp_e, cmp_e_big):
        if not c["ok"]:
            raise AssertionError(f"kernel E disagrees with its plain version: {c['text']}")
    results["decision_update_fullstep"] = dict(
        max_abs_err=cmp_e["max_abs_err"], ms=ms, plain_ms=plain_ms,
        **{k: v_ for k, v_ in cmp_e.items() if k not in ("text", "max_abs_err")},
        big_grid=dict(G=BIG_GRID, S=BIG_SIMS, **{k: v_ for k, v_ in cmp_e_big.items() if k != "text"}),
        random_rows_ms=ms_random, **bnd)
    del big, args_big
    del v, out

    results["forward_sweep"] = check_forward(pkg, device, st)
    torch.cuda.synchronize()
    return results


# Kernel C's instructions a sim and step, priced by issue slot from
# csrc/forward_sweep.cuh: every product and sum is rounded on its own (no
# FMA), and each instruction, whatever its class (loads, shuffles, selects,
# compares), takes one slot; an IEEE division __fdiv_rn takes about seven
# (MUFU.RCP, four FFMAs, FCHK and its branch).
DIV_SLOTS = 7
# A monomial design entry (design_entry): its term words and values loaded
# from shared memory, ~one power's product and one ipow multiply, the
# subtraction and the division; ~6 integer operations (shift, mask,
# addresses) a term.
DESIGN_TERM_SLOTS = 3 + 2 + 1 + DIV_SLOTS
DESIGN_TERM_INT_OPS = 6
# A ratchet segment (linear): two subtractions, a select, a division, a
# clamp, two lerps of four and the selects; 3R loads and 2 for the clamp.
RATCHET_SEGMENT_SLOTS = 10 + DIV_SLOTS
# The bang-bang set: ~14 f32 operations and selects.
BANG_BANG_SLOTS = 14
# A decision, besides its continuation's 4B − 2 products and sums and its
# loads: the volume (3), the target (2), the lerp (4), the immediate value
# (12) and the argmax (6).
DECISION_SLOTS = 3 + 2 + 4 + 12 + 6
# Placing a target: on an evenly spaced row, the position arithmetic (9 and
# 3 integer); on a general row from the bucket index (indexed_weights), the
# clamp and bucket (7), two count and four node loads, ~8 compares and
# selects, and the weight (4 and a division), with ~6 integer operations.
UNIFORM_PLACE = (9, 3)
INDEXED_PLACE = (7 + 6 + 8 + 4 + DIV_SLOTS, 6)
# A cross-sim sum (inventory, volume, fuel, loss, immediate value, delta
# numerator, the design row's B terms): what the function needs is one add
# a sim, and a block of 256 sims stores its partial, which the reduce reads
# and adds (CROSS_SUM_BLOCK_SLOTS a block).  The kernel's own way, a warp
# butterfly in every lane (five shuffles and five adds, the select of a
# valid sim and lane 0's store: WARP_SUM_SLOTS), is its design, not the
# function's: its cost beyond the add is reported beside the bound
# (butterfly_ms), not in it.
CROSS_SUM_SLOTS = 1
CROSS_SUM_BLOCK_SLOTS = 2
WARP_SUM_SLOTS = 12


def forward_issue(b, d, r, design: bool, general: bool, large: bool, f: int = 3) -> tuple:
    """(issue slots that are not integer arithmetic, integer operations) of
    kernel C a sim and step: the staged values' cp.async (B in design mode,
    else the F factors), the design row, the ratchet rates, the bang-bang
    set, D decisions (placing each target, its continuation's two rows: 2B
    loads from shared memory, or on the large route 2·ceil(B/4) 16-byte
    loads) and an add a sim for each of the 6 + B cross-sim sums."""
    staged = b if design else f
    slots = 1 + staged + BANG_BANG_SLOTS + 3 * r + 2 + (r - 1) * RATCHET_SEGMENT_SLOTS
    ints = 2 * (1 + staged)
    if design:
        slots += b * (2 + DIV_SLOTS)
    else:
        slots += b * DESIGN_TERM_SLOTS
        ints += b * DESIGN_TERM_INT_OPS
    place = INDEXED_PLACE if general else UNIFORM_PLACE
    loads = 2 * math.ceil(b / 4) if large else 2 * b
    slots += d * (DECISION_SLOTS + 4 * b - 2 + place[0] + loads)
    ints += d * (place[1] + (4 if large else 2 * b))
    slots += (6 + b) * CROSS_SUM_SLOTS
    return float(slots), float(ints)


def butterfly_ms(n, s, b) -> float:
    """The time at the unfused rate of what kernel C's warp butterflies
    issue beyond the one add a sim of its 6 + B cross-sim sums, over N steps
    of S sims: the design's cost above ``forward_work``'s bound, not part
    of it."""
    return 1e3 * n * s * (6 + b) * (WARP_SUM_SLOTS - CROSS_SUM_SLOTS) / F32_UNFUSED_OPS_PER_S


def forward_work(n, s, f, b, g, r, d, panels: bool, design: bool = False,
                 general: bool = False, large: bool = False):
    """(bytes, fused f32 operations, other issue slots, integer operations)
    of a forward sweep of N steps over S sims, ``bound``'s arguments.  Bytes:
    each input read once and each output written once: per step and sim its
    spot and F factor values in (with ``design``, its B raw design values in
    their place); once each sim's starting inventory in and final inventory
    and PV out; every step's tables in (coefficients and, in the
    general-grid mode, the next grid row: the bucket index is the wrapper's,
    ``general_tail_work``) and sums and summed design row out; with the
    panels, four [N, S] rows out.  Operations: none fused;
    ``forward_issue`` a sim and step, and each block of 256 sims' partials
    of the 6 + B sums a step."""
    from storage_tpu_torch.ops import forward_kernel

    width = forward_kernel.table_layout(b, r, g)[1] + (g if general else 0)
    staged = b if design else f
    num_bytes = 4.0 * ((1 + staged) * n * s + 3 * s + n * width
                       + n * (forward_kernel.NUM_SUMS + b) + (4 * n * s if panels else 0))
    slots, ints = forward_issue(b, d, r, design, general, large, f)
    blocks = -(-s // 256)
    slots = float(n) * (s * slots + blocks * (6 + b) * CROSS_SUM_BLOCK_SLOTS)
    return num_bytes, 0.0, slots, float(n) * s * ints


def forward_sweep_inputs(pkg, device, st, monomials=None, sims=None, sim_in=None):
    """The main path's forward sweep: the headline facility's tables, the
    regression of a backward pass over the regression paths of ``st`` and the
    valuation paths (seed 13); ``forward_sweep``'s arguments.  ``monomials``
    in place of the headline's basis, and ``sims`` (regression paths) and
    ``sim_in`` (the OU tables of the valuation paths) in place of the
    headline model's, where given."""
    import torch

    from storage_tpu_torch.engines import lsmc as engine
    from storage_tpu_torch.models import spot_sim
    from storage_tpu_torch.ops import forward_kernel

    arrays, monomials, n = st.arrays, monomials or st.monomials, NUM_STEPS
    sims = sims or st.sims
    tfn = st.inputs.compiled.terminal_value
    _, regression = engine.lsmc_backward(arrays, sims.spot, sims.factors, monomials, 0, tfn,
                                         False, snap_interp=True)
    if sim_in is None:
        _, sim_in, _, _ = engine_inputs(pkg, device)
    val = spot_sim.simulate_ou_paths(spot_sim.key_from_seed(13),
                                     torch.arange(NUM_SIMS, device=device), *sim_in)
    step = {k: arrays[k] for k in engine._SCALARS}
    step.update(next_min=arrays["lower"][1:], next_max=arrays["upper"][1:])
    params = forward_kernel.pack_params(step, arrays["grids"][1:])
    return (params, regression["mean"], regression["std"],
            *(arrays[k][:n].contiguous() for k in ("ratchet_inv", "ratchet_min", "ratchet_max")),
            val.spot[:n], val.factors[:n], torch.full((NUM_SIMS,), 100.0, device=device), None,
            regression["coeffs"], monomials, 0, False)


def random_sweep(device, n, s, g, f, seed):
    """``forward_sweep``'s arguments for N steps of random tables that change
    from step to step (a shrinking band, shifting ratchets, random design
    stats and coefficients) over random paths: the checks beyond the headline
    (G = 1,000; spot-only panels)."""
    import torch

    from storage_tpu_torch.basis import parse_basis_functions
    from storage_tpu_torch.ops import forward_kernel

    gen = torch.Generator(device=device).manual_seed(seed)
    monomials = tuple(parse_basis_functions(BASIS if f else SPOT_BASIS))
    b = len(monomials)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=device)  # noqa: E731
    t = torch.arange(n, dtype=torch.float32, device=device)
    next_min, next_max = 20.0 * t, 5000.0 - 30.0 * t
    scalars = dict(df_settle=0.99 - 0.001 * t, df_flow=0.99 - 0.001 * t,
                   inj_cost=0.9 + 0.0 * t, wdr_cost=0.7 + 0.0 * t, inj_pcnt=0.01 + 0.0 * t,
                   wdr_pcnt=0.005 + 0.0 * t, loss_pcnt=0.001 + 0.0 * t,
                   inv_cost_rate=0.02 + 0.0 * t, next_min=next_min, next_max=next_max)
    frac = torch.linspace(0.0, 1.0, g, device=device)
    grid_next = next_min[:, None] + (next_max - next_min)[:, None] * frac[None, :]
    params = forward_kernel.pack_params(scalars, grid_next)
    nodes = torch.tensor([0.0, 2500.0, 5000.0], device=device)[None, :] + 10.0 * t[:, None]
    coeffs = 50.0 * rnd(n, b, g)
    coeffs[:, 0] = 30.0 * grid_next
    return (params, 0.3 * rnd(n, b), 1.0 + 0.2 * rnd(n, b).abs(), nodes.contiguous(),
            (torch.tensor([-200.0, -250.0, -300.0], device=device) - t[:, None]).contiguous(),
            (torch.tensor([300.0, 250.0, 200.0], device=device) + t[:, None]).contiguous(),
            30.0 + 5.0 * rnd(n, s), rnd(n, f, s), 5000.0 * torch.rand(s, generator=gen,
                                                                    device=device),
            None, coeffs, monomials, 0, False)


def sweep_by_steps(args, panels):
    """The sweep as N launches of the one-step kernel (``forward_step``, the
    sweep at N = 1), each writing its panel rows: (inventory, pv, sums, xbar)."""
    import torch

    from storage_tpu_torch.ops import forward_kernel

    params, mean, std, r_inv, r_min, r_max, spot, factors, inv, pv, coeffs, mono, e, is_step = args
    pv = torch.zeros_like(inv) if pv is None else pv
    sums, xbar = [], []
    for t in range(spot.shape[0]):
        out = (panels[0][t], torch.empty_like(pv), panels[1][t], panels[2][t])
        inv, pv, _, _, sums_t, xbar_t = forward_kernel.forward_step(
            params[t], mean[t], std[t], r_inv[t], r_min[t], r_max[t], spot[t], factors[t], inv,
            pv, coeffs[t], mono, e, is_step, out=out, imm_out=panels[3][t])
        sums.append(sums_t)
        xbar.append(xbar_t)
    return inv, pv, torch.stack(sums), torch.stack(xbar)


def design_args(args, design):
    """``forward_sweep``'s arguments as ``forward_sweep_design``'s: the raw
    design [N, B, S] in place of the factors, no monomials."""
    return (*args[:7], design, *args[8:11], *args[12:])


def compare_sweep(args, got=None, got_panels=None, design=None, grid=None) -> dict:
    """The sweep kernel (or ``got``, its result with ``got_panels``) against
    ``forward_sweep_plain`` on ``args``, both with the per-sim panels; with
    ``design`` [N, B, S], the design mode on it (``design_args``); with
    ``grid`` [N, G], the general-grid mode on those rows.  The
    kernel does the plain version's arithmetic in the same order, so a sim
    may differ beyond 1e-6 of the largest value (final PV and inventory, or
    any panel row) only where its path flipped on a near-tie: at the first
    step where the two part, the best two of the plain version's totals
    within 1e-5 of the largest.  At most 1e-5·S such sims; sums and summed
    design rows within 1e-4 relative (f32 sums in another order)."""
    import torch

    from storage_tpu_torch.ops import forward_kernel

    (params, mean, std, r_inv, r_min, r_max, spot, factors, inv0, _, coeffs, mono, e,
     is_step) = args
    n, s = spot.shape
    if got is None:
        got_panels = [torch.empty((n, s), device=spot.device) for _ in range(4)]
        got = (forward_kernel.forward_sweep(*args, panels=got_panels, grid=grid) if design is None
               else forward_kernel.forward_sweep_design(*design_args(args, design),
                                                        panels=got_panels, grid=grid))
    want_panels = [torch.empty((n, s), device=spot.device) for _ in range(4)]
    want = forward_kernel.forward_sweep_plain(*args, panels=want_panels, design=design, grid=grid)

    def beyond(g_, w_):
        return ~((g_ - w_).abs() <= 1e-6 * max(float(w_.abs().max()), 1.0))

    pairs = [(got[0], want[0]), (got[1], want[1]), *zip(got_panels, want_panels)]
    err = max(float((g_ - w_).abs().max()) for g_, w_ in pairs)
    mismatch = beyond(got[0], want[0]) | beyond(got[1], want[1])
    for g_, w_ in zip(got_panels, want_panels):
        mismatch |= beyond(g_, w_).any(dim=0)
    idx = mismatch.nonzero().flatten()
    unexplained = 0
    if idx.numel():
        parted = torch.stack([beyond(g_[:, idx], w_[:, idx])
                              for g_, w_ in zip(got_panels, want_panels)]).any(dim=0)
        first = parted.int().argmax(dim=0)  # the first step where each sim's rows part
        for t in sorted(set(first.tolist())):
            cols = idx[first == t]
            inv_t = inv0[cols] if t == 0 else want_panels[0][t - 1, cols]
            candidates, _, _ = forward_kernel.decision_candidates(
                params[t], mean[t], std[t], r_inv[t], r_min[t], r_max[t], spot[t, cols],
                factors[t][:, cols], inv_t, coeffs[t], mono, e, is_step,
                None if design is None else design[t][:, cols],
                None if grid is None else grid[t])
            totals = torch.stack([total for total, _ in candidates])
            top2 = totals.topk(2, dim=0).values
            near = (top2[0] - top2[1]) <= 1e-5 * totals.abs().max(dim=0).values
            unexplained += int((~near).sum())
    flips = int(idx.numel())
    sums_err = max(rel_err(got[2], want[2]), rel_err(got[3], want[3]))
    pv_err = float(((got[1] - want[1]).abs() / want[1].abs().max()).max())
    ok = not unexplained and flips <= 1e-5 * s and sums_err <= 1e-4
    text = (f"final PV max rel err {pv_err:.3e}, per-sim values (final inventory and PV, every "
            f"panel row) max abs err {err:.3e}; {flips} of {s} sims beyond 1e-6 relative (paths "
            f"flipped), {unexplained} of them off a near-tie (tolerance 0, at most 1e-5*S); sums/"
            f"xbar max rel err {sums_err:.3e} (tolerance 1e-4)")
    return dict(ok=ok, text=text, max_abs_err=err, pv_max_rel_err=pv_err, flips=flips,
                unexplained_flips=unexplained, sums_max_rel_err=sums_err)


def check_forward(pkg, device, st) -> dict:
    """Kernel C: one step against its plain version at step t of ``st``; the
    main path's sweep against forward_sweep_plain, against itself with the
    panels and against N launches of the one-step kernel (the same bits);
    then at G = 1,000 and on spot-only panels.  Times the sweep, N one-step
    launches and the plain sweep; the sweep's launch report and SASS size."""
    import torch

    from storage_tpu_torch.engines import lsmc as engine
    from storage_tpu_torch.ops import _build, forward_kernel

    inputs, arrays, monomials, sims, t, gen = st.inputs, st.arrays, st.monomials, st.sims, st.t, st.gen
    s, f, b_dim = NUM_SIMS, 3, len(monomials)

    # ---- one step (t of st) against the plain version.
    step_c = {k: arrays[k] for k in engine._SCALARS}
    step_c.update(next_min=arrays["lower"][1:], next_max=arrays["upper"][1:])
    params = forward_kernel.pack_params(step_c, arrays["grids"][1:])[t].contiguous()
    lo_b, hi_b = float(inputs.inventory_lower[t]), float(inputs.inventory_upper[t])
    inventory = lo_b + (hi_b - lo_b) * torch.rand(s, generator=gen, device=device)
    pv = 100.0 * torch.randn(s, generator=gen, device=device)
    args_c = (params, st.mean[1], st.std[1], arrays["ratchet_inv"][t], arrays["ratchet_min"][t],
              arrays["ratchet_max"][t], sims.spot[t], sims.factors[t], inventory, pv,
              st.coeffs, monomials, 0, False)
    imm, imm_plain = torch.empty_like(pv), torch.empty_like(pv)
    got = forward_kernel.forward_step(*args_c, imm_out=imm)
    want = forward_kernel.forward_step_plain(*args_c, imm_out=imm_plain)
    # New inventory, PV, volume, fuel and immediate PV within f32 rounding of
    # the plain version, except on sims whose argmax flipped on a near-tie of
    # the decisions' total values.
    mismatch = torch.zeros(s, dtype=torch.bool, device=device)
    for g_i, w_i in (*zip(got[:4], want[:4]), (imm, imm_plain)):
        tol_i = 1e-6 * max(float(w_i.abs().max()), 1.0)
        mismatch |= ~((g_i - w_i).abs() <= tol_i)
    candidates, _, _ = forward_kernel.decision_candidates(*args_c[:9], *args_c[10:])
    totals = torch.stack([total for total, _ in candidates])  # [D, S]
    top2 = totals.topk(2, dim=0).values
    near_tie = (top2[0] - top2[1]) <= 1e-5 * float(totals.abs().max())
    flips_c = int(mismatch.sum())
    unexplained_c = int((mismatch & ~near_tie).sum())
    err_c = max(float((g_i - w_i).abs().max()) for g_i, w_i in (*zip(got[:4], want[:4]),
                                                                (imm, imm_plain)))
    sums_err = max(
        float(((got[i] - want[i]).abs().max() / want[i].abs().max().clamp(min=1.0))) for i in (4, 5)
    )
    step_ms = cuda_ms(lambda: forward_kernel.forward_step(*args_c), 50)
    log(f"kernel C forward_step (the sweep at N=1) [S={s}, G={NUM_GRID}, D=3, B={b_dim}, R=3]: "
        f"per-sim (inventory, PV, volume, fuel, immediate PV) max abs err {err_c:.3e}; {flips_c} "
        f"sims beyond 1e-6 relative (argmax flips), {unexplained_c} of them off a near-tie "
        f"(tolerance 0); sums/xbar max rel err {sums_err:.3e} (tolerance 1e-4); {step_ms:.4f} ms "
        f"a launch")
    if unexplained_c or flips_c > 1e-5 * s or sums_err > 1e-4:
        raise AssertionError("kernel C's step disagrees with its plain version")
    del args_c, got, want, candidates, totals, mismatch

    # ---- the main path's sweep: against itself with the panels, against N
    # one-step launches (the same bits) and against the plain sweep.
    args = forward_sweep_inputs(pkg, device, st)
    n = NUM_STEPS
    bare = [x.clone() for x in forward_kernel.forward_sweep(*args)]
    panels = [torch.empty((n, s), device=device) for _ in range(4)]
    with_panels = forward_kernel.forward_sweep(*args, panels=panels)
    step_panels = [torch.empty((n, s), device=device) for _ in range(4)]
    by_steps = sweep_by_steps(args, step_panels)
    same_panels = all(torch.equal(x, y) for x, y in zip(bare, with_panels))
    same_steps = (all(torch.equal(x, y) for x, y in zip(with_panels, by_steps))
                  and all(torch.equal(x, y) for x, y in zip(panels, step_panels)))
    del step_panels, by_steps
    cmp_main = compare_sweep(args, with_panels, panels)
    ms = cuda_ms(lambda: forward_kernel.forward_sweep(*args), 20)
    ms_panels = cuda_ms(lambda: forward_kernel.forward_sweep(*args, panels=panels), 10)
    steps_ms = cuda_ms(lambda: sweep_by_steps(args, panels), 3)
    plain_ms = cuda_ms(lambda: forward_kernel.forward_sweep_plain(*args), 1)
    del panels
    g_, r_ = args[10].shape[2], args[3].shape[1]
    bnd = bound(*forward_work(n, s, f, b_dim, g_, r_, 3, panels=False))
    bnd_panels = bound(*forward_work(n, s, f, b_dim, g_, r_, 3, panels=True))
    info = forward_kernel.kernel_info(g_, b_dim, r_, f, 0, device)
    sass = _build.sass_instructions(_build.library_path(), forward_kernel.sass_name(b_dim))
    log(f"kernel C forward_sweep [N={n}, S={s}, G={g_}, D=3, B={b_dim}, F={f}, R={r_}], the main "
        f"path's tables and paths: {cmp_main['text']}; bit-identical with the panels on: "
        f"{same_panels}; bit-identical to {n} one-step launches (final inventory and PV, every "
        f"panel row, sums, xbar): {same_steps}; {ms:.4f} ms a sweep ({ms_panels:.4f} ms with the "
        f"panels, bound {bnd_panels['bound_ms']:.4f}) vs {steps_ms:.3f} ms for {n} one-step "
        f"launches, plain {plain_ms:.1f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}); "
        f"launch: {info['smem_bytes']} bytes of shared memory per block (limit "
        f"{info['smem_limit']}, so G <= {info['max_grid']}), {info['blocks_per_sm']} blocks of "
        f"{info['sims_per_block']} sims per SM, {info['registers']} registers, {sass} SASS "
        f"instructions")
    del args

    # ---- G = 1,000 with a few steps, and spot-only panels, with the panels.
    checks = {}
    for name, (n_x, s_x, g_x, f_x) in {"big_grid": (8, BIG_SIMS, BIG_GRID, 3),
                                       "spot_only": (32, NUM_SIMS, NUM_GRID, 0)}.items():
        checks[name] = compare_sweep(random_sweep(device, n_x, s_x, g_x, f_x, seed=17))
        log(f"kernel C forward_sweep [{name}: N={n_x}, S={s_x}, G={g_x}, F={f_x}, random tables, "
            f"panels on]: {checks[name]['text']}")
    for c in (cmp_main, *checks.values()):
        if not c["ok"]:
            raise AssertionError(f"kernel C's sweep disagrees with its plain version: {c['text']}")
    if not (same_panels and same_steps):
        raise AssertionError("kernel C's sweep is not the same bits as its one-step launches")
    return dict(
        max_abs_err=cmp_main["max_abs_err"], ms=ms, plain_ms=plain_ms,
        **{k: v_ for k, v_ in cmp_main.items() if k not in ("text", "max_abs_err", "ok")},
        ms_with_panels=ms_panels, bound_with_panels_ms=bnd_panels["bound_ms"],
        steps_ms=steps_ms, step_ms=step_ms, bit_identical_to_steps=same_steps,
        bit_identical_with_panels=same_panels, smem_bytes=info["smem_bytes"],
        blocks_per_sm=info["blocks_per_sm"], registers=info["registers"],
        sims_per_block=info["sims_per_block"], max_grid=info["max_grid"],
        sass_instructions=sass, butterfly_ms=butterfly_ms(n, s, b_dim),
        step=dict(max_abs_err=err_c, flips=flips_c, sums_max_rel_err=sums_err),
        **{name: {k: v_ for k, v_ in c.items() if k != "text"} for name, c in checks.items()},
        **bnd)


def tpu_numerics_valuation(pkg, device, counts):
    """The headline valuation with the TPU run's numerics, to hold the port
    against the reference record itself:

    * the OU step's L_k·z_k with its inputs rounded to bf16: the JAX
      package's ``ou_step`` sets no matmul precision, and XLA on a TPU
      multiplies f32 inputs at bf16 by default.  The draws come from kernel A
      (materialised, so that they can be rounded) and the steps from the
      sweep's plain step loop on the card; the main path runs neither: its
      paths come from the sweep kernel;
    * the fused backward's moments (``storage_tpu/engines/lsmc.py:277-301``):
      step t−1's moments standardised by step t's stats inside kernel B,
      the exact system recovered with ``standardise_moments``.

    Returns (npv, standard error, launch counts)."""
    import torch

    from storage_tpu_torch.engines import lsmc as engine
    from storage_tpu_torch.models import spot_sim
    from storage_tpu_torch.ops import decision_kernel, interp, rng_kernel
    from storage_tpu_torch.ops.regression import fit_from_moments, standardise_moments

    def bf16(t):
        return t.to(torch.bfloat16).to(torch.float32)

    inputs, sim_in, arrays, monomials = engine_inputs(pkg, device)
    decay, chol, vols, half_var, fwd = sim_in
    c = torch.log(fwd) - half_var
    p, f = decay.shape
    tfn = inputs.compiled.terminal_value
    ids = torch.arange(NUM_SIMS, device=device)
    counts.reset()

    def tpu_paths(seed):
        z1, z2, _ = spot_sim.draw_normal_halves(spot_sim.key_from_seed(seed), 0, p, ids, f, False)
        z = bf16(rng_kernel.normals_by_step(z1, z2, p, f))
        del z1, z2
        factors, spot = rng_kernel.ou_sweep_plain(z, decay, bf16(chol), vols, c)
        return spot_sim.SpotSimResults(spot=spot, factors=factors)

    reg, val = tpu_paths(11), tpu_paths(13)
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
        ci = interp.interp_coeffs(coeffs, prep["idx_lo"][t], prep["w_hi"][t])
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
    npv, se = float(out["npv"]), float(out["standard_error"])
    launches = counts.read()
    expected = counts.expect(normal_halves=2, decision_update_moments=NUM_STEPS, forward_sweep=1)
    if launches != expected:
        raise AssertionError(f"launch counts {launches}, expected {expected}")
    return npv, se, launches


def phase_breakdown(pkg, device):
    """Host preparation / simulate / intrinsic / backward / forward seconds
    of the headline case, each ended by a synchronize, through the calls the
    API makes."""
    import torch

    from storage_tpu_torch.api import engine_profile
    from storage_tpu_torch.engines import intrinsic as ie
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
    # The intrinsic value as the API takes it: the DP kernel on the engine's
    # tables, read back with its profile frame.
    t0 = time.perf_counter()
    intrinsic = ie.intrinsic_core(arrays, 100.0, 0, tfn, False)
    engine_profile(inputs.periods, intrinsic)
    times["intrinsic_npv"] = float(intrinsic.npv)
    times["intrinsic_s"] = time.perf_counter() - t0
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


@contextlib.contextmanager
def api_timers(times):
    """Seconds spent, inside the API calls of the block, in the engine
    (``lsmc_core_rows``, ended by a synchronize: the device work and its
    launches), in building the result's per-sim frames (``_results``) and in
    reading user frames into arrays (``_frames_to_sims``)."""
    from unittest import mock

    import torch

    from storage_tpu_torch import api_lsmc

    def timed(name, fn, sync):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            times[name] = times.get(name, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    with mock.patch.object(api_lsmc.lsmc_engine, "lsmc_core_rows",
                           timed("engine_s", api_lsmc.lsmc_engine.lsmc_core_rows, True)), \
            mock.patch.object(api_lsmc, "_results",
                              timed("panel_assembly_s", api_lsmc._results, False)), \
            mock.patch.object(api_lsmc, "_frames_to_sims",
                              timed("frames_to_arrays_s", api_lsmc._frames_to_sims, False)):
        yield


def round_trip(pkg, device, counts, main_npv):
    """The headline valuation with every per-sim panel, then value_from_sims
    on its four path panels with the same flags: the same NPV, SE and deltas
    to the bit (deterministic kernels, lossless f32 -> f64 -> f32 frames).
    Returns the source result (its spot panels feed the spot-only phase, its
    path frames the streaming phase) and the value_from_sims result."""
    import numpy as np
    import torch

    flags = pkg.SimulationDataReturned.ALL
    report = {}
    for name in ("source", "from_sims"):
        times = {}
        counts.reset()
        t0 = time.perf_counter()
        with api_timers(times):
            if name == "source":
                res = value(pkg, device, True, sim_data_returned=flags)
            else:
                res = value_from_frames(
                    pkg, device, src.sim_spot_regress, src.sim_spot_valuation, BASIS,
                    sim_factors_regress=src.sim_factors_regress,
                    sim_factors_valuation=src.sim_factors_valuation, sim_data_returned=flags)
        torch.cuda.synchronize()
        times["wall_s"] = time.perf_counter() - t0
        launches = counts.read()
        expected = counts.expect(simulate_sweep=2 if name == "source" else 0,
                                 decision_update_moments=NUM_STEPS, forward_sweep=1,
                                 intrinsic_dp=1)
        log(f"round trip, {name}: NPV {res.npv!r} SE {res.val_sim_standard_error!r}; wall "
            f"{times['wall_s']:.3f} s, of it engine (device work, synchronized) "
            f"{times['engine_s']:.3f} s, per-sim frames {times['panel_assembly_s']:.3f} s, user "
            f"frames to arrays {times.get('frames_to_arrays_s', 0.0):.3f} s; launches {launches}")
        if launches != expected:
            raise AssertionError(f"launch counts {launches}, expected {expected}")
        report[name] = dict(npv=res.npv, se=res.val_sim_standard_error, launches=launches, **times)
        if name == "source":
            src = res
            if res.npv != main_npv:
                raise AssertionError(f"panels changed the NPV: {res.npv} vs {main_npv}")
    same = (res.npv == src.npv and res.val_sim_standard_error == src.val_sim_standard_error
            and np.array_equal(res.deltas.to_numpy(), src.deltas.to_numpy()))
    # Per-sim consistency: the PV panel sums to each sim's PV, whose mean is
    # the NPV; the inventory panel's mean is the expected profile (f32 sums
    # in another order: 1e-5 relative).
    pv_mean = float(src.sim_pv.to_numpy().sum(axis=0).mean())
    pv_off = abs(pv_mean - src.npv) / abs(src.npv)
    inv = src.expected_profile["inventory"].to_numpy()
    inv_off = float(np.abs(src.sim_inventory.to_numpy().mean(axis=1) - inv).max() / np.abs(inv).max())
    shapes_ok = (src.sim_pv.shape == (NUM_STEPS + 1, NUM_SIMS)
                 and src.sim_inject_withdraw.shape == (NUM_STEPS, NUM_SIMS)
                 and len(src.sim_factors_valuation) == 3)
    log(f"round trip: NPV, SE and deltas bit-identical: {same}; mean over sims of the summed "
        f"sim_pv {pv_mean!r} vs NPV {src.npv!r} (rel {pv_off:.2e}, tolerance 1e-5); sim_inventory "
        f"mean vs expected profile max rel {inv_off:.2e} (tolerance 1e-5); panel shapes ok: "
        f"{shapes_ok}")
    if not (same and pv_off <= 1e-5 and inv_off <= 1e-5 and shapes_ok):
        raise AssertionError("the round trip does not reproduce its source")
    report.update(bit_identical=same, sim_pv_rel=pv_off, sim_inventory_rel=inv_off)
    return src, res, report


def antithetic_valuation(pkg, device, counts, main):
    """The headline valuation with antithetic draws (path 2m+1 the negated
    normals of path 2m, in the sweep): its NPV within 3 SE of the main path's,
    through the same kernels."""
    import torch

    counts.reset()
    t0 = time.perf_counter()
    res = value(pkg, device, True, antithetic=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts.read()
    expected = counts.expect(simulate_sweep=2, decision_update_moments=NUM_STEPS, forward_sweep=1,
                             intrinsic_dp=1)
    gap = (res.npv - main.npv) / main.val_sim_standard_error
    log(f"antithetic: NPV {res.npv!r} SE {res.val_sim_standard_error!r}, {gap:+.3f} SE from the "
        f"main path's NPV (tolerance 3); wall {wall:.3f} s; launches {launches}")
    if launches != expected:
        raise AssertionError(f"launch counts {launches}, expected {expected}")
    if not (math.isfinite(res.npv) and abs(gap) <= 3.0):
        raise AssertionError(f"antithetic NPV {res.npv} is not within 3 SE of {main.npv}")
    return dict(npv=res.npv, se=res.val_sim_standard_error, gap_to_main_se=gap, wall_s=wall,
                launches=launches)


def spot_only_valuation(pkg, device, counts, src, main):
    """value_from_sims on the headline's spot panels alone: the spot-only
    backward (kernel D) and forward (kernel C), held within 0.1 SE of the
    same valuation in f64 on the same panels."""
    import torch

    counts.reset()
    t0 = time.perf_counter()
    res = value_from_frames(pkg, device, src.sim_spot_regress, src.sim_spot_valuation, SPOT_BASIS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts.read()
    expected = counts.expect(decision_update=NUM_STEPS, pack_records=NUM_STEPS, forward_sweep=1,
                             intrinsic_dp=1)
    se = res.val_sim_standard_error
    off = (res.npv - F64_SPOT_NPV) / se
    gap = (res.npv - main.npv) / main.val_sim_standard_error
    log(f"spot-only value_from_sims ({SPOT_BASIS}): NPV {res.npv!r} SE {se!r}, "
        f"{off:+.4f} SE from its f64 answer {F64_SPOT_NPV} (tolerance 0.1), {gap:+.3f} SE from "
        f"the 3-factor NPV {main.npv!r}; the pinned bits {SPOT_NPV!r} SE {SPOT_SE!r}: "
        f"{(res.npv, se) == (SPOT_NPV, SPOT_SE)}; wall {wall:.3f} s; launches {launches}")
    if launches != expected:
        raise AssertionError(f"launch counts {launches}, expected {expected}")
    if not abs(off) <= 0.1:
        raise AssertionError(f"spot-only NPV {res.npv} is not within 0.1 SE of {F64_SPOT_NPV}")
    if (res.npv, se) != (SPOT_NPV, SPOT_SE):
        raise AssertionError(f"spot-only NPV {res.npv!r} SE {se!r}: not the bits {SPOT_NPV!r} "
                             f"SE {SPOT_SE!r} of the same arithmetic")
    return dict(npv=res.npv, se=se, off_f64_se=off, gap_to_3f_se=gap, wall_s=wall,
                launches=launches)


def fullstep_valuation(pkg, device, counts, main):
    """The headline case through lsmc_core(fullstep=True): kernel E alone per
    backward step; its backward seconds beside the kernel-B-plus-glue
    backward, in turns (B, E, E, B)."""
    import torch

    from storage_tpu_torch.engines import lsmc as engine
    from storage_tpu_torch.models import spot_sim

    inputs, sim_in, arrays, monomials = engine_inputs(pkg, device)
    tfn = inputs.compiled.terminal_value
    ids = torch.arange(NUM_SIMS, device=device)
    reg = spot_sim.simulate_ou_paths(spot_sim.key_from_seed(11), ids, *sim_in)
    val = spot_sim.simulate_ou_paths(spot_sim.key_from_seed(13), ids, *sim_in)
    counts.reset()
    out = engine.lsmc_core(arrays, reg.spot, reg.factors, val.spot, val.factors, 100.0, monomials,
                           0, False, tfn, False, snap_interp=True, fullstep=True)
    npv, se = float(out["npv"]), float(out["standard_error"])
    launches = counts.read()
    expected = counts.expect(decision_update_fullstep=NUM_STEPS, forward_sweep=1)
    if launches != expected:
        raise AssertionError(f"launch counts {launches}, expected {expected}")
    z = check_npv(npv, se, snap_interp=True)
    off = (npv - main.npv) / main.val_sim_standard_error
    # The same valuation with kernel E forced onto its wide route: the
    # register route's bits in every output.
    counts.reset()
    with forced_routes("wide-shared", names=("decision_update_fullstep",)):
        wide = engine.lsmc_core(arrays, reg.spot, reg.factors, val.spot, val.factors, 100.0,
                                monomials, 0, False, tfn, False, snap_interp=True, fullstep=True)
    wide_launches = counts.read()
    wide_same = all(torch.equal(out[k], wide[k]) for k in out)
    log(f"fullstep forced onto kernel E's wide route: launches {wide_launches}; every output the "
        f"register route's bits: {wide_same}")
    if wide_launches != counts.expect(decision_update_fullstep=NUM_STEPS,
                                      decision_update_fullstep_wide=NUM_STEPS, forward_sweep=1):
        raise AssertionError(f"fullstep forced wide: launch counts {wide_launches}")
    if not wide_same:
        raise AssertionError("kernel E's wide route parts from its register route at the "
                             "headline")
    del wide
    backward = {False: [], True: []}
    with engine.full_f32_matmul():
        for fullstep in (False, True, True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.lsmc_backward(arrays, reg.spot, reg.factors, monomials, 0, tfn, False,
                                 snap_interp=True, fullstep=fullstep)
            torch.cuda.synchronize()
            backward[fullstep].append(time.perf_counter() - t0)
    log(f"fullstep: NPV {npv!r} SE {se!r} (z = {z:+.3f}), {off:+.4f} SE from the main path's "
        f"NPV (tolerance 0.05); launches {launches}; backward {backward[True]} s with kernel E "
        f"vs {backward[False]} s with kernel B and the glue")
    if not abs(off) <= 0.05:
        raise AssertionError(f"fullstep NPV {npv} is not within 0.05 SE of {main.npv}")
    return dict(npv=npv, se=se, off_main_se=off, launches=launches,
                backward_fullstep_s=backward[True], backward_b_glue_s=backward[False],
                forced_wide_launches=wide_launches, forced_wide_same_bits=wide_same)


def replica_basis(pkg):
    """The headline's nine monomials (``BASIS``) as generic callables: the
    design they write is the monomials' to the bit (the same products, and
    1·x is x)."""
    import torch

    g = pkg.generic
    return [g(lambda s, x: torch.ones_like(s), label="1"),
            g(lambda s, x: x[0], 1, "x_st"), g(lambda s, x: x[1], 2, "x_lt"),
            g(lambda s, x: x[2], 3, "x_sw"), g(lambda s, x: x[0] * x[0], 1, "x_st**2"),
            g(lambda s, x: x[1] * x[1], 2, "x_lt**2"), g(lambda s, x: x[2] * x[2], 3, "x_sw**2"),
            g(lambda s, x: s, label="s"), g(lambda s, x: s * s, label="s**2")]


def exp_indicator_basis(pkg):
    """Another nine-term basis: combinator atoms mixed with exponentials of
    the short-term factor and an indicator of the long-term one."""
    import torch

    g = pkg.generic
    return [pkg.ONE, pkg.X_ST, g(lambda s, x: torch.exp(x[0]), 1, "exp(x_st)"),
            g(lambda s, x: torch.exp(-x[0]), 1, "exp(-x_st)"), pkg.X_LT,
            g(lambda s, x: (x[1] > 0).to(s.dtype), 2, "1{x_lt>0}"), pkg.X_SW, pkg.S, pkg.S ** 2]


def check_design_mode(pkg, device) -> dict:
    """Kernel C's design mode on the main path's own tables and paths, the
    headline's nine monomials written out as the design: against its plain
    version (argmax flips only on near-ties); then at G = 1,000.  The
    replicated generic basis through ``forward_sweep_generic`` (the design
    built a chunk of steps at a time) against the monomial mode: the same
    bits, and the device time of its chunk launches.  Kernel D, which a
    generic basis runs backward on factor panels, at B = 9 against its plain
    version.  Times, bounds, launch report."""
    import torch

    from storage_tpu_torch.basis import coerce_basis_functions, design_columns
    from storage_tpu_torch.engines import lsmc as engine
    from storage_tpu_torch.ops import _build, decision_kernel, forward_kernel

    st = backward_step_inputs(pkg, device)
    # ---- kernel D on the step's nine-term design (factor panels).
    t, sims, step = st.t, st.sims, st.step
    dm_t = engine._standardised_design_t(st.monomials, sims.spot[t], sims.factors[t],
                                         st.mean[1], st.std[1])
    args_d9 = (st.v, dm_t, sims.spot[t], step["idx_lo"], step["w_hi"], st.args_b[11],
               step["a"], step["b"])
    cmp_d9 = compare_d(args_d9)
    out = torch.empty_like(st.v)
    d9_ms = cuda_ms(lambda: decision_kernel.decision_update(*args_d9, out=out), 20)
    d9_plain_ms = cuda_ms(lambda: decision_kernel.decision_update_plain(*args_d9), 5)
    d9_bnd = bound(*decision_work(NUM_GRID, NUM_SIMS, 3, dm_t.shape[0], 0, moments=False,
                                  design_in_memory=True))
    log(f"kernel D decision_update [G={NUM_GRID}, S={NUM_SIMS}, D=3, B={dm_t.shape[0]}: the "
        f"main path's design, as a generic basis runs it]: {cmp_d9['text']}; {d9_ms:.4f} ms vs "
        f"plain {d9_plain_ms:.3f} ms, bound {d9_bnd['bound_ms']:.4f} ms ({d9_bnd['bound_by']})")
    del args_d9, out, dm_t

    # ---- the design mode on the main path's sweep.
    args = forward_sweep_inputs(pkg, device, st)
    del st, sims
    n, s = args[6].shape
    mono = args[11]
    b_dim, g_, r_ = len(mono), args[10].shape[2], args[3].shape[1]
    design = torch.stack(design_columns(mono, args[6], args[7]), dim=1)  # [N, B, S]
    cmp_main = compare_sweep(args, design=design)
    d_args = design_args(args, design)
    ms = cuda_ms(lambda: forward_kernel.forward_sweep_design(*d_args), 10)
    mono_ms = cuda_ms(lambda: forward_kernel.forward_sweep(*args), 10)
    plain_ms = cuda_ms(lambda: forward_kernel.forward_sweep_plain(*args, design=design), 1)
    del d_args, design
    replica = tuple(coerce_basis_functions(replica_basis(pkg)))
    panels_g = [torch.empty((n, s), device=device) for _ in range(4)]
    panels_m = [torch.empty((n, s), device=device) for _ in range(4)]
    before = forward_kernel.forward_sweep_design.launches

    def generic_sweep(panels=None):
        return forward_kernel.forward_sweep_generic(*args[:9], args[10], replica, *args[12:],
                                                    panels=panels)

    got = generic_sweep(panels_g)
    chunk_launches = forward_kernel.forward_sweep_design.launches - before
    want = forward_kernel.forward_sweep(*args, panels=panels_m)
    pairs = list(zip((*got, *panels_g), (*want, *panels_m)))
    same = all(torch.equal(x, y) for x, y in pairs)
    largest = max(float((x - y).abs().max()) for x, y in pairs)
    del panels_g, panels_m, got, want, pairs
    chunked_ms = cuda_ms(generic_sweep, 3)
    path_ms, per_run = launch_ms(forward_kernel, "forward_sweep_design", generic_sweep, 3)
    if per_run != chunk_launches:
        raise AssertionError(f"timed {per_run} design-mode launches a forward pass, counted "
                             f"{chunk_launches}")
    bnd = bound(*forward_work(n, s, 0, b_dim, g_, r_, 3, panels=False, design=True))
    info = forward_kernel.kernel_info(g_, b_dim, r_, 0, 0, device, design=True)
    sass = _build.sass_instructions(_build.library_path(),
                                    forward_kernel.sass_name(b_dim, design=True))
    chunk = forward_kernel.DESIGN_CHUNK
    log(f"kernel C forward_sweep_design [N={n}, S={s}, G={g_}, D=3, B={b_dim}, R={r_}], the main "
        f"path's tables, paths and nine monomials as the design: {cmp_main['text']}; "
        f"{ms:.4f} ms one launch over all {n} steps (monomial mode {mono_ms:.4f} ms), plain "
        f"{plain_ms:.1f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}: N*S*(1+B)*4 bytes "
        f"in and the outputs over 3.35 TB/s); launch: {info['smem_bytes']} bytes of shared memory "
        f"per block (G <= {info['max_grid']}), {info['blocks_per_sm']} blocks per SM, "
        f"{info['registers']} registers, {sass} SASS instructions")
    log(f"kernel C forward_sweep_generic, the replicated generic basis in chunks of {chunk} steps "
        f"({chunk_launches} launches of the design mode): the monomial mode's bits (final "
        f"inventory and PV, sums, xbar, every panel row): {same}; largest difference {largest:.3e}; "
        f"{chunked_ms:.3f} ms a forward pass, the design built on the card included; the "
        f"{chunk_launches} launches on their own {path_ms:.4f} ms a pass "
        f"({path_ms / chunk_launches:.4f} ms a launch) against {ms:.4f} ms for one launch over "
        f"all {n} steps")
    del args
    big = random_sweep(device, 8, BIG_SIMS, BIG_GRID, 3, seed=17)
    big_design = torch.stack(design_columns(big[11], big[6], big[7]), dim=1)
    cmp_big = compare_sweep(big, design=big_design)
    log(f"kernel C forward_sweep_design [big_grid: N=8, S={BIG_SIMS}, G={BIG_GRID}, random "
        f"tables, panels on]: {cmp_big['text']}")
    del big, big_design
    for c in (cmp_main, cmp_big):
        if not c["ok"]:
            raise AssertionError(f"kernel C's design mode disagrees with its plain version: "
                                 f"{c['text']}")
    if not same:
        raise AssertionError(f"the replicated generic basis is not the monomial mode's bits "
                             f"(largest difference {largest})")
    if not cmp_d9["ok"]:
        raise AssertionError(f"kernel D at B=9 disagrees with its plain version: {cmp_d9['text']}")
    return dict(
        max_abs_err=cmp_main["max_abs_err"], ms=path_ms, ms_per_launch=path_ms / chunk_launches,
        ms_one_launch=ms, plain_ms=plain_ms, monomial_mode_ms=mono_ms,
        chunk=chunk, chunk_launches=chunk_launches, chunked_ms=chunked_ms,
        same_bits_as_monomial_mode=same, largest_difference=largest,
        **{k: v_ for k, v_ in cmp_main.items() if k not in ("text", "max_abs_err", "ok")},
        big_grid={k: v_ for k, v_ in cmp_big.items() if k != "text"},
        smem_bytes=info["smem_bytes"], blocks_per_sm=info["blocks_per_sm"],
        registers=info["registers"], sass_instructions=sass,
        butterfly_ms=butterfly_ms(n, s, b_dim),
        decision_update_b9=dict(ms=d9_ms, plain_ms=d9_plain_ms, bound_ms=d9_bnd["bound_ms"],
                                bound_by=d9_bnd["bound_by"],
                                **{k: v_ for k, v_ in cmp_d9.items() if k != "text"}),
        **bnd)


def host_layer_phase(pkg, device, counts, main, main_default) -> dict:
    """The public host layer on the card, each path with the launch counters
    reset just before it: the replicated generic basis at the headline
    (within 0.1 SE of the main path's NPV: kernel D once a backward step, no
    kernel B, C's design mode once a chunk of steps, the intrinsic DP once);
    an exp/indicator basis (another estimator: reported, not gated);
    ``lsmc_value`` through the builder (the main path's bits at the port's
    default ``snap_interp``); ``MultiFactorSpotSim`` over the headline's model
    (its spot frame the simulation sweep's bits)."""
    import numpy as np
    import torch

    from storage_tpu_torch.models import multi_factor as mf
    from storage_tpu_torch.models import spot_sim
    from storage_tpu_torch.ops import forward_kernel

    report = {}
    chunks = -(-NUM_STEPS // forward_kernel.DESIGN_CHUNK)
    generic_launches = dict(simulate_sweep=2, decision_update=NUM_STEPS,
                            pack_records=NUM_STEPS, forward_sweep_design=chunks, intrinsic_dp=1)
    for name, basis in (("replica", replica_basis(pkg)), ("exp_indicator", exp_indicator_basis(pkg))):
        counts.reset()
        t0 = time.perf_counter()
        res = value(pkg, device, True, basis=basis)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts.read()
        gap = (res.npv - main.npv) / main.val_sim_standard_error
        log(f"generic basis ({name}) at the headline: NPV {res.npv!r} SE "
            f"{res.val_sim_standard_error!r}, {gap:+.4f} SE from the main path's NPV "
            f"{main.npv!r}{' (tolerance 0.1)' if name == 'replica' else ' (not gated)'}; wall "
            f"{wall:.3f} s; launches {launches}")
        if launches != counts.expect(**generic_launches):
            raise AssertionError(f"launch counts {launches}, expected "
                                 f"{counts.expect(**generic_launches)}")
        if not (math.isfinite(res.npv) and math.isfinite(res.val_sim_standard_error)):
            raise AssertionError(f"generic basis ({name}): NPV {res.npv}")
        if name == "replica" and not abs(gap) <= 0.1:
            raise AssertionError(f"the replicated generic basis's NPV {res.npv} is not within "
                                 f"0.1 SE of the main path's {main.npv}")
        walls = [wall]
        for _ in range(2 if name == "replica" else 0):  # the generic path's wall, warm
            t0 = time.perf_counter()
            value(pkg, device, True, basis=basis)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        if len(walls) > 1:
            log(f"generic basis ({name}): walls {[round(w, 4) for w in walls]} s, median "
                f"{float(np.median(walls)):.4f} s")
        report[name] = dict(npv=res.npv, se=res.val_sim_standard_error, gap_to_main_se=gap,
                            wall_s=float(np.median(walls)), walls_s=walls, launches=launches)

    storage, start, fwd = bench_case(pkg)
    factors, corrs = mf.create_3_factor_seasonal_params("D", 14.5, 1.1, 0.19, 0.23, start,
                                                        storage.end)
    params = (pkg.LsmcValuationParameters.builder()
              .with_storage(storage).with_val_date(start).with_inventory(100.0)
              .with_forward_curve(fwd).with_interest_rates(0.02).with_settlement_rule(None)
              .with_basis_funcs(BASIS).with_grid_points(NUM_GRID).with_dtype(torch.float32)
              .with_device(device)
              .simulate_with_multi_factor_model(factors, corrs, NUM_SIMS, seed=11, fwd_sim_seed=13)
              .build())
    counts.reset()
    t0 = time.perf_counter()
    res = pkg.lsmc_value(params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts.read()
    same = (res.npv, res.val_sim_standard_error) == (main_default.npv,
                                                      main_default.val_sim_standard_error)
    log(f"lsmc_value (MultiFactorSimSpec, the builder): NPV {res.npv!r} SE "
        f"{res.val_sim_standard_error!r}; the main path's bits (snap_interp=False, the port's "
        f"default): {same}; wall {wall:.3f} s; launches {launches}")
    expected = counts.expect(simulate_sweep=2, decision_update_moments=NUM_STEPS,
                             forward_sweep=1, intrinsic_dp=1)
    if launches != expected:
        raise AssertionError(f"launch counts {launches}, expected {expected}")
    if not same:
        raise AssertionError(f"lsmc_value gave NPV {res.npv!r} SE {res.val_sim_standard_error!r}, "
                             f"not the main path's {main_default.npv!r} "
                             f"{main_default.val_sim_standard_error!r}")
    report["lsmc_value"] = dict(npv=res.npv, se=res.val_sim_standard_error, wall_s=wall,
                                launches=launches)

    inputs, sim_in, _, _ = engine_inputs(pkg, device)
    sim = pkg.MultiFactorSpotSim("D", factors, corrs, inputs.val_day, fwd, list(inputs.periods),
                                 seed=11, device=device)
    counts.reset()
    t0 = time.perf_counter()
    frame = sim.simulate(NUM_SIMS)
    frame_s = time.perf_counter() - t0
    launches = counts.read()
    ids = torch.arange(NUM_SIMS, device=device)
    want = spot_sim.simulate_ou_paths(spot_sim.key_from_seed(11), ids, *sim_in).spot
    same = (frame.shape == (NUM_STEPS + 1, NUM_SIMS)
            and frame.dtypes.unique().tolist() == [np.float32]
            and np.array_equal(frame.to_numpy(), want.cpu().numpy()))
    kernel_ms = cuda_ms(lambda: spot_sim.simulate_ou_paths(spot_sim.key_from_seed(11), ids,
                                                           *sim_in), 5)
    log(f"MultiFactorSpotSim(device='cuda') {NUM_SIMS} sims x {NUM_STEPS + 1} periods, f32: the "
        f"simulation sweep's bits for key 11 in an f32 frame: {same}; simulate() {frame_s:.3f} "
        f"s, of it the sweep {kernel_ms:.4f} ms and the rest building the frame; launches "
        f"{launches}")
    if launches != counts.expect(simulate_sweep=1):
        raise AssertionError(f"launch counts {launches}, expected one simulation sweep")
    if not same:
        raise AssertionError("MultiFactorSpotSim's spot frame is not the simulation sweep's")
    report["spot_sim"] = dict(simulate_s=frame_s, sweep_ms=kernel_ms, launches=launches)
    return report


# ---- the caps phase: shapes beyond what the kernels that build the monomial
# design on the card take (16 terms, 8 factors), on the design-in-memory route.
# The headline's 3-factor model with a 20-term basis: the full quadratic in the
# spot and the three factors (15 terms), the four cubes and s**4.
BASIS_20 = ("1 + s + x_st + x_lt + x_sw + s**2 + x_st**2 + x_lt**2 + x_sw**2 + s*x_st + s*x_lt "
            "+ s*x_sw + x_st*x_lt + x_st*x_sw + x_lt*x_sw + s**3 + x_st**3 + x_lt**3 + x_sw**3 "
            "+ s**4")


def full_cubic_basis() -> str:
    """The full cubic in the spot and the three factors (35 terms) and s**4:
    36 terms, past kernel D's last compiled size (32), for its wide route."""
    import itertools

    names = ("s", "x_st", "x_lt", "x_sw")
    terms = ["1"]
    for degree in (1, 2, 3):
        for combo in itertools.combinations_with_replacement(range(4), degree):
            terms.append("*".join(names[i] + (f"**{combo.count(i)}" if combo.count(i) > 1 else "")
                                  for i in sorted(set(combo))))
    return " + ".join([*terms, "s**4"])


# A 10-factor model on the headline facility: mean reversions from a
# long-term factor (0) to a fast spot factor, each factor's vol flat, every
# pair correlated 0.3 (so that the sweep's Cholesky product mixes all ten),
# and the basis 1 + s + s**2 + x0 + ... + x9 (13 terms).
TEN_FACTORS = 10
TEN_MEAN_REVERSIONS = (0.0, 0.5, 1.0, 2.0, 4.0, 7.0, 10.0, 14.5, 20.0, 30.0)
TEN_VOLS = (0.19, 0.12, 0.12, 0.15, 0.2, 0.25, 0.35, 0.6, 0.45, 0.35)
TEN_CORRELATION = 0.3
BASIS_10F = "1 + s + s**2 + " + " + ".join(f"x{i}" for i in range(TEN_FACTORS))
# The two valuations in f64 on the same f32 draws (``--f64``: the kernels'
# plain versions in f64 on the card, NVIDIA H100 80GB HBM3): each f32 NPV
# lands within 0.1 SE of its answer.
F64_CAPS_NPV = {"basis_20": 115_291.41648232081, "factors_10": 145_000.0596373356}
# The two valuations' f32 NPVs with the full step (kernel E's wide route), the
# bits of its first design on an NVIDIA H100 80GB HBM3: every redesign of the
# wide route keeps them.
CAPS_FULLSTEP_NPV = {"basis_20": 115_289.2890625, "factors_10": 145_000.125}


def ten_factor_model(fwd):
    """The 10-factor model's factors (mean reversion, vol series on the
    curve's index) and correlation matrix."""
    import numpy as np
    import pandas as pd

    factors = [(a, pd.Series(v, index=fwd.index)) for a, v in zip(TEN_MEAN_REVERSIONS, TEN_VOLS)]
    corrs = np.full((TEN_FACTORS, TEN_FACTORS), TEN_CORRELATION)
    np.fill_diagonal(corrs, 1.0)
    return factors, corrs


def ten_factor_inputs(pkg, device):
    """The 10-factor model's valuation inputs and OU simulation tensors
    (decay, chol, vols, half_var, fwd; f32), built as the API builds them."""
    import numpy as np
    import torch

    from storage_tpu_torch.models import multi_factor as mf
    from storage_tpu_torch.valuation_inputs import prepare_valuation

    storage, start, fwd = bench_case(pkg)
    inputs = prepare_valuation(storage, start, 100.0, fwd, 0.02, None)
    factors, corrs = ten_factor_model(fwd)
    pre = mf.simulation_precompute(factors, corrs, inputs.val_day, list(inputs.periods), "D")
    return inputs, [torch.tensor(np.asarray(a), dtype=torch.float32, device=device)
                    for a in (pre.decay, pre.chol, pre.vols, pre.half_var, inputs.fwd)]


def caps_value(pkg, device, case: str):
    """One of the caps phase's two valuations through the public API, at the
    headline's width (262,144 paths a set, 365 steps, G=100, seeds 11/13,
    f32, snap_interp=True): "basis_20" (``three_factor_seasonal_value``,
    ``BASIS_20``) or "factors_10" (``multi_factor_value``, the 10-factor
    model, ``BASIS_10F``)."""
    import torch

    if case == "basis_20":
        return value(pkg, device, snap_interp=True, basis=BASIS_20)
    storage, start, fwd = bench_case(pkg)
    factors, corrs = ten_factor_model(fwd)
    return pkg.multi_factor_value(
        storage, start, 100.0, fwd, 0.02, None, factors, corrs, NUM_SIMS, BASIS_10F, False,
        seed=11, fwd_sim_seed=13, num_inventory_grid_points=NUM_GRID, dtype=torch.float32,
        device=device, snap_interp=True)


def ptxas_report(fragment: str) -> dict:
    """Registers, spill bytes and stack frame that the compiler reported for
    the kernel whose mangled name holds ``fragment`` (the build's
    ``ptxas.log``)."""
    import re

    from storage_tpu_torch.ops import _build

    text = (_build.library_path().parent / "ptxas.log").read_text()
    out, current = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?(?: for|$)",
                      line)
        if m:
            current = m.group(1)
            continue
        if current is None or fragment not in current:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.update(stack_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out["registers"] = int(m.group(1))
    return out


def moments_launch_report(device, g: int, b_dim: int, large: bool = False) -> dict:
    """Kernel B's launch report at D = 3 and G grid points (the large route's
    at a tile of G): blocks per SM and shared memory a block
    (``kernel_info``), registers and spilled bytes (``ptxas.log``) and SASS
    instructions of the kernel compiled for B's padded basis size."""
    from storage_tpu_torch.ops import _build, decision_kernel

    info = decision_kernel.kernel_info("moments", g, 3, b_dim, device, large=large)
    name = ("decision_moments_tiled_kernel" if large else "decision_moments_kernel") \
        + f"ILi{decision_kernel.padded_basis(b_dim)}E"
    ptx = ptxas_report(name)
    return dict(blocks_per_sm=info["blocks_per_sm"], smem_bytes=info["smem_bytes"],
                registers=ptx["registers"], spill_bytes=ptx.get("spill_store_bytes", 0),
                sass_instructions=_build.sass_instructions(_build.library_path(), name))


def update_launch_report(device, g: int, b_dim: int) -> dict:
    """Kernel D's launch report at D = 3 and a tile of G grid points, as
    ``moments_launch_report``."""
    from storage_tpu_torch.ops import _build, decision_kernel

    info = decision_kernel.kernel_info("update", g, 3, b_dim, device)
    # Compiled per basis size, the wide route past 32 terms.
    name = f"decision_update_kernelILi{b_dim if b_dim <= 32 else 0}E"
    ptx = ptxas_report(name)
    return dict(blocks_per_sm=info["blocks_per_sm"], smem_bytes=info["smem_bytes"],
                registers=ptx["registers"], spill_bytes=ptx.get("spill_store_bytes", 0),
                sass_instructions=_build.sass_instructions(_build.library_path(), name))


def pack_work(g: int, d: int, b: int) -> tuple:
    """(bytes, fused and unfused f32 operations, integer operations) of the
    record pack: idx_lo and w_hi [G, D], ci [D, G, B], a and b [D, G] in,
    the records [G, record_words] out; one subtraction a centred
    coefficient."""
    from storage_tpu_torch.ops import decision_kernel

    words = 2 * g * d + d * g * b + 2 * d * g + g * decision_kernel.record_words(d, b)
    return 4.0 * words, 0.0, float((d - 1) * g * b), 0.0


def launch_text(r: dict) -> str:
    return (f"{r['blocks_per_sm']} blocks/SM, {r['smem_bytes']} B of shared memory a block, "
            f"{r['registers']} registers, {r['spill_bytes']} B spilled, "
            f"{r['sass_instructions']} SASS instructions")


def wide_step_args(device, monomials, sims, arrays, t: int, s: int, seed: int):
    """Kernel E's arguments at step t of a valuation's paths (the first S
    of ``sims``) and of its facility's step tables (``arrays``, at their G):
    v about the next grid's value, the moments of step t's design
    standardised by its exact stats against v, and step t−1's exact stats
    for the next moments, as the engine hands them over."""
    import torch

    from storage_tpu_torch.engines import lsmc as engine
    from storage_tpu_torch.ops import decision_kernel

    spot = sims.spot[t - 1:t + 2, :s].contiguous()
    factors = sims.factors[t - 1:t + 1, :, :s].contiguous()
    prep = engine._backward_prep_all(arrays, 0, False, snap_interp=True)
    grid_next = arrays["grids"][t + 1]
    gen = torch.Generator(device=device).manual_seed(seed)
    v = (grid_next[:, None] * spot[2][None, :]
         + 40.0 * torch.randn((grid_next.shape[0], s), generator=gen, device=device)).contiguous()
    mean, std = engine._design_stats(monomials, spot[:2], factors)
    dm = decision_kernel._standardised_design(monomials, spot[1], factors[1], mean[1], std[1])
    args = (v, spot[1], factors[1], spot[0], factors[0], dm.T @ dm, dm.T @ v.T, mean[1], std[1],
            prep["idx_lo"][t], prep["w_hi"][t], prep["a"][t], prep["b"][t], monomials)
    return args, dict(mean_prev=mean[0], std_prev=std[0])


def check_fullstep_wide(pkg, device, st, ten) -> dict:
    """Kernel E's wide route (past 16 terms or 8 factors) on the paths of
    the caps phase's two valuations at step t = 180: ``BASIS_20`` on the
    headline's 3-factor paths and ``BASIS_10F`` on the 10-factor model's
    (``ten``, its regression paths),
    each at G=100 (S=262,144; the rule's grid route, and the other forced to
    its bits) and G=1,000 (S=65,536, the large route), against its plain
    version (``compare_e``: the regression within 1e-4 relative, argmax
    flips counted and only on near-ties), timed beside its bound, with the
    launch report of B's wide body and the compiler's registers and spills;
    the route's Python sizing held to the
    launch report on both sides of the wide route's shared/large crossing;
    and at the headline's B=9, F=3 the wide route forced on each grid route
    (``route="wide-shared"``, ``"wide-large"``) against the register route:
    every output the same bits."""
    import torch

    from storage_tpu_torch.basis import parse_basis_functions
    from storage_tpu_torch.engines import lsmc as engine
    from storage_tpu_torch.ops import _build, decision_kernel

    limit = _build.smem_limit(device)
    inputs = st.inputs
    arrays = {NUM_GRID: st.arrays, BIG_GRID: engine.build_engine_arrays(
        inputs.compiled, inputs.fwd, inputs.df_settle, inputs.df_flow, inputs.inventory_lower,
        inputs.inventory_upper, BIG_GRID, torch.float32, device)}
    out, crossings = {}, {}
    fe = decision_kernel.decision_update_fullstep
    for label, basis, f in (("b20f3", BASIS_20, 3), ("b13f10", BASIS_10F, TEN_FACTORS)):
        mono = tuple(parse_basis_functions(basis))
        b = len(mono)
        sims = st.sims if f == 3 else ten
        for g, s in ((NUM_GRID, NUM_SIMS), (BIG_GRID, BIG_SIMS)):
            args, prev = wide_step_args(device, mono, sims, arrays[g], st.t, s, seed=5 + g)
            plan = decision_kernel.fullstep_route(g, 3, b, limit, num_factors=f)
            before = (fe.launches, fe.wide_launches, fe.wide_smem_launches, fe.large_launches)
            cmp = compare_e(args, prev, wide=True)
            counted = (fe.launches - before[0], fe.wide_launches - before[1],
                       fe.wide_smem_launches - before[2], fe.large_launches - before[3])
            buf = torch.empty_like(args[0])
            # Both grid routes at the main path's G: the other one's bits;
            # the shared row on the rule's grid route: the register row's.
            other = {"shared": "large", "large": "shared"}[plan.name]
            routes_same = g > NUM_GRID or forced_bits(fe, args, prev)
            smem_route = f"wide-smem-{plan.name}"
            rule_out = tuple(x.clone() for x in fe(*args, **prev))
            smem_same = same_outputs(rule_out, fe(*args, **prev, route=smem_route))
            del rule_out
            ms = cuda_ms(lambda: fe(*args, **prev, out=buf), 20 if g == NUM_GRID else 5)
            smem_ms = cuda_ms(lambda: fe(*args, **prev, out=buf, route=smem_route),
                              20 if g == NUM_GRID else 5)
            plain_ms = cuda_ms(
                lambda: decision_kernel.decision_update_fullstep_plain(*args, **prev), 2)
            bnd = bound(*decision_work(g, s, 3, b, f, moments=True, solve=True))
            info = decision_kernel.kernel_info("wide", plan.tile, 3, b, device, num_factors=f)
            log(f"caps: kernel E decision_update_fullstep [G={g}, S={s}, D=3, B={b}, F={f}, wide "
                f"route, body {plan.body}, {plan.name} (tile {plan.tile})]: {cmp['text']}; "
                f"launches counted (all, wide, shared row, large) {counted}; "
                + (f"forced onto its {other} route, the same bits: {routes_same}; "
                   if g == NUM_GRID else "")
                + f"the shared row ({smem_route}) the same bits: {smem_same}; "
                f"{ms:.4f} ms (the shared row {smem_ms:.4f}) vs plain {plain_ms:.3f} ms, bound "
                f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}); B's wide body "
                f"{info['smem_bytes']} bytes of shared memory (G <= "
                f"{info['max_grid']}), {info['blocks_per_sm']} blocks per SM, "
                f"{info['registers']} registers")
            if not cmp["ok"]:
                raise AssertionError(f"kernel E's wide route at B={b}, F={f}, G={g} disagrees "
                                     f"with its plain version: {cmp['text']}")
            if plan.body != "wide" or counted != (1, 1, 0, int(plan.name == "large")) or (
                    g > NUM_GRID and plan.name != "large"):
                raise AssertionError(f"kernel E at B={b}, F={f}, G={g} took {plan} (launches "
                                     f"{counted}), not its wide route's register row")
            if not (routes_same and smem_same):
                raise AssertionError(f"kernel E's wide route at B={b}, F={f}, G={g} gives other "
                                     f"bits on its {other} route ({routes_same}) or its shared "
                                     f"row ({smem_same})")
            out[label if g == NUM_GRID else f"{label}_g{g}"] = dict(
                B=b, F=f, G=g, S=s, grid_route=plan.name, tile=plan.tile,
                max_abs_err=cmp["max_abs_err"], flips=cmp["flips"],
                unexplained_flips=cmp["unexplained_flips"],
                regression_max_rel_err=cmp["regression_max_rel_err"],
                moments_max_rel_err=cmp["moments_max_rel_err"], ms=ms, plain_ms=plain_ms,
                body=plan.body, smem_row_ms=smem_ms,
                bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"], library_ms=None,
                smem_bytes=info["smem_bytes"], max_grid=info["max_grid"],
                blocks_per_sm=info["blocks_per_sm"], registers=info["registers"])
            del args, prev, buf
        del sims
        # The Python sizing of each wide body against its launch report: the
        # largest G, and the blocks per SM on both sides of the crossing and
        # at the large route's tile.
        last = max(g for g in range(2, 2_000)
                   if decision_kernel.fullstep_route(g, 3, b, limit, num_factors=f).name
                   == "shared")
        sizing = []
        for body in ("wide", "wide-smem"):
            cross = max(g for g in range(2, 2_000)
                        if decision_kernel.wide_route(g, 3, b, f, limit, body=body).name
                        == "shared")
            sizing.append((f"{body} max_grid", decision_kernel.wide_max_grid(3, b, f, limit, body),
                           decision_kernel.kernel_info("wide", 100, 3, b, device, num_factors=f,
                                                       body=body)["max_grid"]))
            for g in sorted({last, last + 1, cross, cross + 1, decision_kernel.TILE_B}):
                sizing.append((f"{body} blocks_per_sm G={g}",
                               decision_kernel.wide_blocks_per_sm(g, 3, b, f, limit, body),
                               decision_kernel.kernel_info("wide", g, 3, b, device,
                                                           num_factors=f,
                                                           body=body)["blocks_per_sm"]))
        crossings[label] = dict(last_shared=last, sizing=sizing)
        log(f"caps: kernel E's wide route at B={b}, F={f}: shared up to G={last} under the rule; "
            f"the Python sizing (mine, the launch report's): {sizing}")
        if any(mine != theirs for _, mine, theirs in sizing):
            raise AssertionError(f"the wide route's sizing at B={b}, F={f} disagrees with "
                                 f"kernel_info: {sizing}")
    ptx = {"body_b20": ptxas_report("decision_moments_tiled_kernelILi20EN3stt9WideBasisE"),
           "body_b13": ptxas_report("decision_moments_tiled_kernelILi16EN3stt9WideBasisE"),
           "body_smem_row": ptxas_report("decision_moments_wide_kernel"),
           **{f"solve{'_spread' * spread}_{n}": ptxas_report(
               f"fullstep_solve_kernelILb{spread}ELi{n}E")
              for spread in (0, 1) for n in (_build.MAX_BASIS, _build.MAX_WIDE_REGISTER_BASIS,
                                            _build.MAX_WIDE_BASIS)}}
    log(f"caps: kernel E's wide route, ptxas: {ptx}")
    # The headline's shape forced onto each wide body: the register route's
    # bits on each grid route.
    args_e, prev = fullstep_args(st.args_b)
    forced = {}
    for grid_route in ("shared", "large"):
        reg = tuple(t.clone() for t in fe(*args_e, **prev, route=grid_route))
        for body in ("wide", "wide-smem"):
            forced[f"{body}-{grid_route}"] = same_outputs(
                reg, fe(*args_e, **prev, route=f"{body}-{grid_route}"))
    log(f"caps: kernel E at the headline's B=9, F=3 forced onto each wide body (the register "
        f"row, the shared row): every output the register route's bits on the shared and the "
        f"large route: {forced}")
    if not all(forced.values()):
        raise AssertionError(f"kernel E's wide route at B=9 parts from its register route: "
                             f"{forced}")
    del args_e
    return out, dict(crossings=crossings, ptxas=ptx, forced_b9_same_bits=forced)


def check_moments_wide(device, st, ten) -> dict:
    """Kernel B's wide body without E's solve (``decision_update_moments``
    past 16 terms or 8 factors) at step t = 180 of the caps phase's two
    valuations' paths, G=100, S=262,144, D=3: ``BASIS_20`` on the headline's
    3-factor paths and ``BASIS_10F`` on the 10-factor model's (``ten``), on
    the moments of the step's design standardised by its exact stats
    against random values, the coefficients their regression's
    (``fit_from_moments``), as the engine hands them over.  Each against its
    plain version (``compare_b``: best_act beyond f32 rounding only on
    argmax flips at near-ties, the moments within 1e-4 relative, the same
    bits over two launches), its launches counted (all, wide, shared row,
    large), the other grid route and the other row forced to its bits,
    timed beside its bound (``decision_work(..., moments=True)``) with the
    launch report of the wide body."""
    import torch

    from storage_tpu_torch.basis import parse_basis_functions
    from storage_tpu_torch.ops import _build, decision_kernel, interp
    from storage_tpu_torch.ops.regression import fit_from_moments

    limit = _build.smem_limit(device)
    fm = decision_kernel.decision_update_moments
    out = {}
    for label, basis, f in (("b20f3", BASIS_20, 3), ("b13f10", BASIS_10F, TEN_FACTORS)):
        mono = tuple(parse_basis_functions(basis))
        b, g, s = len(mono), NUM_GRID, NUM_SIMS
        args_e, prev = wide_step_args(device, mono, st.sims if f == 3 else ten, st.arrays, st.t,
                                      s, seed=5 + f)
        v, spot, factors, spot_p, factors_p, xtx, xty, mean, std, idx_lo, w_hi, a, b_, _ = args_e
        ci = interp.interp_coeffs(fit_from_moments(xtx, xty), idx_lo, w_hi)
        args = (v, spot, factors, spot_p, factors_p, mean, std, prev["mean_prev"],
                prev["std_prev"], idx_lo, w_hi, ci, a, b_, mono)
        del args_e, xtx, xty
        plan = decision_kernel.moments_plan(g, 3, b, f, limit)
        before = (fm.launches, fm.wide_launches, fm.wide_smem_launches, fm.large_launches)
        rule_out = tuple(x.clone() for x in fm(*args))
        counted = tuple(x - y for x, y in zip(
            (fm.launches, fm.wide_launches, fm.wide_smem_launches, fm.large_launches), before))
        cmp = compare_b(args)
        other = {"shared": "large", "large": "shared"}[plan.name]
        forced = {route: same_outputs(rule_out, fm(*args, route=route))
                  for route in (other, f"wide-smem-{plan.name}")}
        del rule_out
        buf = torch.empty_like(v)
        ms = cuda_ms(lambda: fm(*args, out=buf), 20)
        plain_ms = cuda_ms(lambda: decision_kernel.decision_update_moments_plain(*args), 3)
        bnd = bound(*decision_work(g, s, 3, b, f, moments=True))
        info = decision_kernel.kernel_info("wide", plan.tile, 3, b, device, num_factors=f,
                                           body=plan.body)
        log(f"caps: kernel B decision_update_moments [G={g}, S={s}, D=3, B={b}, F={f}, wide "
            f"body {plan.body}, {plan.name} (tile {plan.tile})]: {cmp['text']}; launches counted "
            f"(all, wide, shared row, large) {counted}; forced onto {other} and onto the shared "
            f"row, the same bits: {forced}; {ms:.4f} ms vs plain {plain_ms:.3f} ms, bound "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}); {info['smem_bytes']} bytes of shared "
            f"memory (G <= {info['max_grid']}), {info['blocks_per_sm']} blocks per SM, "
            f"{info['registers']} registers")
        if not cmp["ok"]:
            raise AssertionError(f"kernel B's wide body at B={b}, F={f} disagrees with its plain "
                                 f"version: {cmp['text']}")
        if plan.body != "wide" or counted != (1, 1, 0, int(plan.name == "large")):
            raise AssertionError(f"kernel B at B={b}, F={f} took {plan} (launches {counted}), not "
                                 f"its wide register row")
        if not all(forced.values()):
            raise AssertionError(f"kernel B's wide body at B={b}, F={f} parts on a forced route: "
                                 f"{forced}")
        out[label] = dict(
            B=b, F=f, G=g, S=s, body=plan.body, grid_route=plan.name, tile=plan.tile,
            max_abs_err=cmp["max_abs_err"], flips=cmp["flips"],
            unexplained_flips=cmp["unexplained_flips"],
            moments_max_rel_err=cmp["moments_max_rel_err"], ms=ms, plain_ms=plain_ms,
            bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"], library_ms=None,
            smem_bytes=info["smem_bytes"], max_grid=info["max_grid"],
            blocks_per_sm=info["blocks_per_sm"], registers=info["registers"])
        del args, buf
    return out


def check_sweep_wide(device, label: str, args, f: int) -> dict:
    """Kernel C's monomial mode on its wide route (past 16 terms or 8
    factors) on a caps valuation's own backward tables and valuation paths
    (``forward_sweep_inputs``; ``f`` factors), S=262,144, G=100: over all
    365 steps on evenly spaced rows and over 64 steps on bunched rows (the
    general-grid mode), each against its plain version (``compare_sweep``:
    paths part only on near-ties) and forced onto its other grid route (the
    same bits), timed beside its bound (``forward_work``), with its launch
    report and the compiler's registers and spills; then against C's design
    mode on the same paths and coefficients (``forward_sweep_generic``: the
    design built on the card in 32-step chunks, 12 launches) to the bit,
    and that pass's time, the design's build included."""
    import torch

    from storage_tpu_torch.ops import _build, forward_kernel

    limit = _build.smem_limit(device)
    fs = forward_kernel.forward_sweep
    mono = args[11]
    b, (n, s), g, r_ = len(mono), args[6].shape, args[10].shape[2], args[3].shape[1]
    ng = min(64, n)
    sub = (*(x[:ng] for x in args[:8]), args[8], args[9], args[10][:ng], *args[11:])
    rows = bunched_rows(sub[0], g, g - 10)
    out = {}
    for mode, a_, grid, steps in (("uniform", args, None, n), ("general", sub, rows, ng)):
        general = grid is not None
        route = forward_kernel.sweep_route(g, b, r_, f, 0, limit, general=general)
        panels = [torch.empty((steps, s), device=device) for _ in range(4)]
        before = (fs.launches, fs.wide_launches, fs.large_launches)
        got = fs(*a_, panels=panels, grid=grid)
        counted = tuple(x - y for x, y in zip((fs.launches, fs.wide_launches, fs.large_launches),
                                             before))
        cmp = compare_sweep(a_, got=got, got_panels=panels, grid=grid)
        other = {"shared": "large", "large": "shared"}[route]
        panels_o = [torch.empty_like(p_) for p_ in panels]
        forced = same_outputs((*got, *panels), (*fs(*a_, panels=panels_o, grid=grid, route=other),
                                                *panels_o))
        del panels_o
        ms = cuda_ms(lambda: fs(*a_, grid=grid), 5)
        plain_ms = cuda_ms(lambda: forward_kernel.forward_sweep_plain(*a_, grid=grid), 1)
        bnd = bound(*forward_work(steps, s, f, b, g, r_, 3, panels=False, general=general,
                                  large=route == "large"))
        info = forward_kernel.kernel_info(g, b, r_, f, 0, device, general=general,
                                          large=route == "large")
        ptx = ptxas_report(forward_kernel.sass_name(0, general=general, large=route == "large"))
        row = dict(B=b, F=f, N=steps, route=route, max_abs_err=cmp["max_abs_err"],
                   flips=cmp["flips"], unexplained_flips=cmp["unexplained_flips"], ms=ms,
                   plain_ms=plain_ms, bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"],
                   library_ms=None, smem_bytes=info["smem_bytes"], max_grid=info["max_grid"],
                   blocks_per_sm=info["blocks_per_sm"], registers=info["registers"], ptxas=ptx)
        text = ""
        if mode == "uniform":
            # C's design mode on the same paths and coefficients: the design
            # of the monomials built on the card a chunk of steps at a time.
            def generic_sweep(panels=None):
                return forward_kernel.forward_sweep_generic(*args[:9], args[10], mono, *args[12:],
                                                            panels=panels)

            panels_d = [torch.empty_like(p_) for p_ in panels]
            design_launches = forward_kernel.forward_sweep_design.launches
            design_same = same_outputs((*got, *panels), (*generic_sweep(panels_d), *panels_d))
            design_launches = forward_kernel.forward_sweep_design.launches - design_launches
            del panels_d
            design_ms = cuda_ms(generic_sweep, 3)
            row.update(design_mode_same_bits=design_same, design_mode_launches=design_launches,
                       design_mode_ms=design_ms)
            text = (f"; C's design mode on the same paths and coefficients ({design_launches} "
                    f"launches, the design built on the card) the same bits: {design_same}, "
                    f"{design_ms:.3f} ms a pass")
        log(f"caps: kernel C forward_sweep [N={steps}, S={s}, G={g}, D=3, B={b}, F={f}, {mode} "
            f"rows, monomial mode's wide route, {route}], {label}'s backward tables and valuation "
            f"paths: {cmp['text']}; launches counted (all, wide, large) {counted}; forced onto "
            f"{other}, the same bits: {forced}; {ms:.4f} ms a launch over all {steps} steps, plain "
            f"{plain_ms:.1f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}); "
            f"{info['smem_bytes']} bytes of shared memory (G <= {info['max_grid']}), "
            f"{info['blocks_per_sm']} blocks per SM, {info['registers']} registers, ptxas {ptx}"
            + text)
        if not cmp["ok"]:
            raise AssertionError(f"kernel C's monomial wide route at B={b}, F={f} ({mode} rows) "
                                 f"disagrees with its plain version: {cmp['text']}")
        if counted != (1, 1, int(route == "large")) or not forced:
            raise AssertionError(f"kernel C at B={b}, F={f} ({mode} rows): launches {counted} on "
                                 f"{route}, or the forced {other} route parts: {forced}")
        if mode == "uniform" and not design_same:
            raise AssertionError(f"kernel C's monomial wide route at B={b}, F={f} parts from its "
                                 f"design mode on the same paths and coefficients")
        out[f"{label}_{mode}"] = row
        del got, panels
    return out


def check_caps(pkg, device) -> dict:
    """The kernels at the sizes beyond the monomial kernels' register caps,
    on the main path's shapes (S=262,144, G=100, D=3), each against its
    plain version with the tolerances of its own check: kernel D at B=20
    (compiled per basis size) and B=36 (the wide route), the same bits;
    kernel E's wide route and kernel B's wide body at 20 terms on 3 factors
    and 13 on 10 (``check_fullstep_wide``, ``check_moments_wide``); kernel
    C's design mode at B=20 (its wide route) on the 20 terms' own backward
    tables and the valuation paths, over all 365 steps on evenly spaced rows
    and over 64 steps on bunched rows (the general-grid mode), argmax flips
    only on near-ties (``compare_sweep``), and C's monomial mode's wide route
    the same way at both shapes (``check_sweep_wide``); the simulation sweep
    at F=10 on
    the 10-factor model's tables (P=366, seeds 11 and 13) and at F=13 (the
    wide route; S=65,536), then resumed at F = 10 and 13 (S=1,000, odd and
    even starts, antithetic on and off): the same bits.  Times, bounds,
    launch reports and the compiler's registers and spills."""
    import torch

    from storage_tpu_torch.basis import design_columns, parse_basis_functions
    from storage_tpu_torch.engines import lsmc as engine
    from storage_tpu_torch.models import spot_sim
    from storage_tpu_torch.ops import _build, decision_kernel, forward_kernel, interp, rng_kernel

    limits = _build.limits()
    caps = (_build.MAX_BASIS, _build.MAX_FACTORS, _build.MAX_WIDE_BASIS,
            _build.MAX_WIDE_REGISTER_BASIS)
    if tuple(limits.values()) != caps:
        raise AssertionError(f"the route's copy of the caps {caps} is not the library's {limits}")
    s, g = NUM_SIMS, NUM_GRID
    st = backward_step_inputs(pkg, device)
    t, sims, step = st.t, st.sims, st.step
    grid_next = st.arrays["grids"][t + 1]
    out = {"decision_update": {}, "forward_sweep_design": {}, "simulate_sweep": {}}

    # ---- kernel D at B = 20 and 36 on the step's own design.
    for label, basis in (("b20", BASIS_20), ("b36", full_cubic_basis())):
        mono = tuple(parse_basis_functions(basis))
        b = len(mono)
        m_, s_ = engine._design_stats(mono, sims.spot[t:t + 1], sims.factors[t:t + 1])
        dm_t = engine._standardised_design_t(mono, sims.spot[t], sims.factors[t], m_[0], s_[0])
        coeffs = torch.randn((b, g), generator=st.gen, device=device) * 50.0
        coeffs[0] = grid_next * 30.0
        ci = interp.interp_coeffs(coeffs, step["idx_lo"], step["w_hi"])
        args = (st.v, dm_t, sims.spot[t], step["idx_lo"], step["w_hi"], ci, step["a"], step["b"])
        cmp = compare_d(args)
        buf = torch.empty_like(st.v)
        ms = cuda_ms(lambda: decision_kernel.decision_update(*args, out=buf), 20)
        plain_ms = cuda_ms(lambda: decision_kernel.decision_update_plain(*args), 3)
        bnd = bound(*decision_work(g, s, 3, b, 0, moments=False, design_in_memory=True))
        info = decision_kernel.kernel_info("update", g, 3, b, device)
        ptx = ptxas_report(f"decision_update_kernelILi{b if b <= 32 else 0}EE")
        log(f"caps: kernel D decision_update [G={g}, S={s}, D=3, B={b}, "
            f"{'compiled' if b <= 32 else 'wide route'}]: {cmp['text']}; {ms:.4f} ms vs plain "
            f"{plain_ms:.3f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}); "
            f"{info['smem_bytes']} bytes of shared memory (G <= {info['max_grid']}), "
            f"{info['blocks_per_sm']} blocks per SM, {info['registers']} registers, ptxas {ptx}")
        if not cmp["ok"]:
            raise AssertionError(f"kernel D at B={b} disagrees with its plain version: "
                                 f"{cmp['text']}")
        out["decision_update"][label] = dict(
            B=b, max_abs_err=cmp["max_abs_err"], flips=cmp["flips"], ms=ms, plain_ms=plain_ms,
            bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"], library_ms=None,
            smem_bytes=info["smem_bytes"], max_grid=info["max_grid"],
            blocks_per_sm=info["blocks_per_sm"], registers=info["registers"], ptxas=ptx)
        del args, buf, dm_t

    # ---- kernel E's wide route and kernel B's wide body at (B, F) = (20, 3)
    # and (13, 10), the latter on the 10-factor model's regression paths.
    _, ten_in = ten_factor_inputs(pkg, device)
    ten = spot_sim.simulate_ou_paths(spot_sim.key_from_seed(11),
                                     torch.arange(NUM_SIMS, device=device), *ten_in)
    out["decision_update_fullstep_wide"], out["fullstep_wide_checks"] = check_fullstep_wide(
        pkg, device, st, ten)
    out["decision_update_moments_wide"] = check_moments_wide(device, st, ten)

    # ---- kernel C's design mode at B = 20 on the 20 terms' own backward.
    mono20 = tuple(parse_basis_functions(BASIS_20))
    args = forward_sweep_inputs(pkg, device, st, mono20)
    n = args[6].shape[0]
    r_ = args[3].shape[1]
    design = torch.stack(design_columns(mono20, args[6], args[7]), dim=1)  # [N, 20, S]
    ng = min(64, n)
    sub = (*(x[:ng] for x in args[:8]), args[8], args[9], args[10][:ng], *args[11:])
    rows = bunched_rows(sub[0], g, g - 10)
    for mode, a_, d_, grid, steps in (("uniform", args, design, None, n),
                                      ("general", sub, design[:ng], rows, ng)):
        cmp = compare_sweep(a_, design=d_, grid=grid)
        d_args = design_args(a_, d_)
        ms = cuda_ms(lambda: forward_kernel.forward_sweep_design(*d_args, grid=grid), 5)
        plain_ms = cuda_ms(lambda: forward_kernel.forward_sweep_plain(*a_, design=d_, grid=grid),
                           1)
        bnd = bound(*forward_work(steps, s, 0, 20, g, r_, 3, panels=False, design=True,
                                  general=grid is not None))
        route = forward_kernel.sweep_route(g, 20, r_, 20, 0, _build.smem_limit(device), True,
                                           grid is not None)
        info = forward_kernel.kernel_info(g, 20, r_, 0, 0, device, design=True,
                                          general=grid is not None, large=route == "large")
        ptx = ptxas_report(forward_kernel.sass_name(0, design=True, general=grid is not None,
                                                    large=route == "large"))
        log(f"caps: kernel C forward_sweep_design [N={steps}, S={s}, G={g}, D=3, B=20, {mode} "
            f"rows, wide route, {route}], the 20 terms' backward tables and the valuation paths: "
            f"{cmp['text']}; {ms:.4f} ms a launch over all {steps} steps, plain {plain_ms:.1f} ms, "
            f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}); {info['smem_bytes']} bytes of "
            f"shared memory (G <= {info['max_grid']}), {info['blocks_per_sm']} blocks per SM, "
            f"{info['registers']} registers, ptxas {ptx}")
        if not cmp["ok"]:
            raise AssertionError(f"kernel C's design mode at B=20 ({mode} rows) disagrees with its "
                                 f"plain version: {cmp['text']}")
        out["forward_sweep_design"][f"b20_{mode}"] = dict(
            N=steps, route=route, max_abs_err=cmp["max_abs_err"], flips=cmp["flips"],
            unexplained_flips=cmp["unexplained_flips"], ms=ms, plain_ms=plain_ms,
            bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"], library_ms=None,
            smem_bytes=info["smem_bytes"], max_grid=info["max_grid"],
            blocks_per_sm=info["blocks_per_sm"], registers=info["registers"], ptxas=ptx)
    del sub, design, rows

    # ---- kernel C's monomial mode past the caps (its wide route) on each
    # caps valuation's own backward tables and valuation paths.
    out["forward_sweep_wide"] = check_sweep_wide(device, "b20f3", args, 3)
    del args
    args = forward_sweep_inputs(pkg, device, st, tuple(parse_basis_functions(BASIS_10F)),
                                sims=ten, sim_in=ten_in)
    del st, sims, ten
    out["forward_sweep_wide"].update(check_sweep_wide(device, "b13f10", args, TEN_FACTORS))
    del args

    # ---- the simulation sweep at F = 10 (compiled) and 13 (the wide route).
    _, sim_in = ten_factor_inputs(pkg, device)
    decay, chol, vols, half_var, fwd = sim_in
    c = torch.log(fwd) - half_var
    p = decay.shape[0]
    thirteen = sweep_tables(device, p, 13, seed=13)  # random tables: the wide route's bits
    for label, tables, s_f in (("f10", (decay, chol, vols, c), s), ("f13", thirteen, 65_536)):
        f = tables[0].shape[1]
        ids = torch.arange(s_f, dtype=torch.int32, device=device)
        checks = {}
        for seed in (11, 13):
            key = spot_sim.key_from_seed(seed)
            got = rng_kernel.simulate_sweep(key, ids, None, *tables)
            want = rng_kernel.simulate_sweep_plain(key, ids, None, *tables)
            checks[f"seed_{seed}"] = compare_paths(got, want)
            del got, want
        path_ids = torch.arange(1000, device=device) + 77
        for start in (5, 6):
            for antithetic in (False, True):
                ids_x = (path_ids // 2 if antithetic else path_ids).to(torch.int32)
                sign = (1.0 - 2.0 * (path_ids % 2)).float() if antithetic else None
                small = sweep_tables(device, 11, f, seed=f + start)
                whole = rng_kernel.simulate_sweep((5, 7), ids_x, sign, *small)
                tail = [x[start:].contiguous() for x in small]
                x0 = whole[0][start - 1].contiguous()
                got = rng_kernel.simulate_sweep((5, 7), ids_x, sign, *tail, start, x0)
                want = rng_kernel.simulate_sweep_plain((5, 7), ids_x, sign, *tail, start, x0)
                same_whole = all(torch.equal(x, y[start:]) for x, y in zip(got, whole))
                checks[f"resumed_start{start}{'_antithetic' if antithetic else ''}"] = dict(
                    compare_paths(got, want), same_as_whole=same_whole)
        key = spot_sim.key_from_seed(11)
        ms = cuda_ms(lambda: rng_kernel.simulate_sweep(key, ids, None, *tables), 10)
        plain_ms = cuda_ms(lambda: rng_kernel.simulate_sweep_plain(key, ids, None, *tables), 1)
        num_bytes, unfused, ints = sweep_work(p, f, s_f, antithetic=False)
        bnd = bound(num_bytes, 0.0, unfused, ints)
        info = rng_kernel.sweep_info(f, device)
        ptx = ptxas_report(rng_kernel.sweep_sass_name(f))
        bad = [k for k, v_ in checks.items()
               if not v_["bit_identical"] or not v_.get("same_as_whole", True)]
        log(f"caps: simulation sweep [P={p}, F={f}, S={s_f}, "
            f"{'compiled' if f <= 12 else 'wide route'}], seeds 11 and 13, and resumed at S=1,000 "
            f"(starts 5 and 6, antithetic on and off): the plain version's bits in every case: "
            f"{not bad} {bad}; {ms:.4f} ms a path set vs plain {plain_ms:.1f} ms, bound "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}); {info['smem_bytes']} bytes of shared "
            f"memory, {info['blocks_per_sm']} blocks per SM, {info['registers']} registers, "
            f"ptxas {ptx}")
        if bad:
            raise AssertionError(f"the simulation sweep at F={f} disagrees with its plain "
                                 f"version: {bad}")
        out["simulate_sweep"][label] = dict(
            F=f, S=s_f, max_abs_err=max(v_["max_abs_err"] for v_ in checks.values()), ms=ms,
            plain_ms=plain_ms, bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"],
            library_ms=None, smem_bytes=info["smem_bytes"], blocks_per_sm=info["blocks_per_sm"],
            registers=info["registers"], ptxas=ptx, checks=checks)
    return out


@contextlib.contextmanager
def fullstep_engine(on: bool = True):
    """The public API's valuations inside the block run the engine's full
    step, ``lsmc_core_rows(..., fullstep=True)``: the engine keyword that
    takes the place of the JAX package's ``STORAGE_TPU_FULLSTEP=1``, which
    no API argument reaches.  With ``on`` False the block changes nothing."""
    import functools

    from storage_tpu_torch.engines import lsmc as engine

    inner = engine.lsmc_core_rows
    if on:
        engine.lsmc_core_rows = functools.partial(inner, fullstep=True)
    try:
        yield
    finally:
        engine.lsmc_core_rows = inner


def caps_valuations(pkg, device, counts, main) -> dict:
    """The two full-width valuations beyond the register caps through the
    public API, each with the launch counters reset just before it: the
    route chosen from shapes (kernel B and C's monomial mode, not the design
    in memory), its launches (the sweep 2 (one a path set), kernel B 365 on
    its wide body, C 1 on its monomial mode's wide route, the intrinsic DP
    1, no other: no kernel D, no record pack, no design mode), its NPV
    within 0.1 SE of the f64 answer on the same draws (``F64_CAPS_NPV``),
    finite deltas and profile, its wall and peak device memory.  Beside
    each, the same valuation with the engine's full step
    (``fullstep_engine``): the sweep 2, kernel E 365 on its wide route, C 1
    on its wide route, the intrinsic DP 1 and no other, its NPV within 0.05
    SE of the default route's on the same paths and the bits pinned in
    ``CAPS_FULLSTEP_NPV``; the two timed in turns (full step, default,
    default, full step).  The headline's route is printed beside them."""
    import numpy as np
    import torch

    from storage_tpu_torch.basis import parse_basis_functions
    from storage_tpu_torch.engines import lsmc as engine
    from storage_tpu_torch.ops import _build, decision_kernel, forward_kernel

    out = {}
    head = engine.design_in_memory(tuple(parse_basis_functions(BASIS)), 3)
    log(f"caps: the headline (9 terms, 3 factors) design in memory: {head}; launches "
        f"{main['launches']}")
    if head:
        raise AssertionError("the headline's shape left the monomial route")
    for case, terms, factors in (("basis_20", 20, 3), ("factors_10", 13, TEN_FACTORS)):
        basis = BASIS_20 if case == "basis_20" else BASIS_10F
        on_design = engine.design_in_memory(tuple(parse_basis_functions(basis)), factors)
        body = engine.fullstep_body(tuple(parse_basis_functions(basis)), factors)
        runs, walls = {}, {True: [], False: []}
        for fullstep in (True, False, False, True):
            # The route reads the card's free memory: hand back the caching
            # allocator's blocks, so that the valuation is routed
            # (materialised: its panels fit the card) as it would be in a
            # fresh process.
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            counts.reset()
            t0 = time.perf_counter()
            with fullstep_engine(fullstep):
                res = caps_value(pkg, device, case)
            torch.cuda.synchronize()
            walls[fullstep].append(time.perf_counter() - t0)
            if fullstep not in runs:
                runs[fullstep] = (res, counts.read(), torch.cuda.max_memory_allocated() / 1e9)
        res, launches, peak = runs[False]
        wall = walls[False][0]
        limit = _build.smem_limit(device)
        plan = decision_kernel.moments_plan(NUM_GRID, 3, terms, factors, limit)
        sweep_large = forward_kernel.sweep_route(NUM_GRID, terms, 3, factors, 0, limit) == "large"
        forward = dict(forward_sweep=1, forward_sweep_wide=1, forward_sweep_large=int(sweep_large))
        expected = counts.expect(simulate_sweep=2, decision_update_moments=NUM_STEPS,
                                 decision_update_moments_wide=NUM_STEPS,
                                 decision_update_moments_wide_smem=NUM_STEPS * (
                                     plan.body == "wide-smem"),
                                 decision_update_moments_large=NUM_STEPS * (plan.name == "large"),
                                 intrinsic_dp=1, **forward)
        npv, se = res.npv, res.val_sim_standard_error
        pin = F64_CAPS_NPV[case]
        off = (npv - pin) / se
        finite = bool(np.isfinite(res.deltas.to_numpy()).all()
                      and np.isfinite(res.expected_profile.to_numpy()).all())
        paths = "materialised" if launches["simulate_sweep"] == 2 else "streamed"
        log(f"caps: {case} ({terms} terms on {factors} factors) route: design in memory "
            f"{on_design}, kernel B's {plan.body} body ({plan.name}), paths {paths}; NPV {npv!r} "
            f"SE {se!r} ({off:+.4f} SE from the f64 answer {pin!r}, tolerance 0.1); launches "
            f"{launches}; wall {wall:.4f} s, peak device memory {peak:.2f} GB; finite deltas and "
            f"profile {finite}")
        if on_design or plan.body != "wide":
            raise AssertionError(f"{case} took the design in memory ({on_design}) or kernel B's "
                                 f"{plan.body} body, not B's wide register row")
        if launches != expected:
            raise AssertionError(f"{case}: launch counts {launches}, expected {expected}")
        if not (math.isfinite(npv) and abs(off) <= 0.1 and finite):
            raise AssertionError(f"{case}: NPV {npv} (SE {se}) is {off:+.4f} SE from {pin}, or "
                                 f"its deltas or profile are not finite")
        res_e, launches_e, peak_e = runs[True]
        grid_route = decision_kernel.fullstep_route(NUM_GRID, 3, terms, _build.smem_limit(device),
                                                    num_factors=factors).name
        expected_e = counts.expect(simulate_sweep=2, decision_update_fullstep=NUM_STEPS,
                                   decision_update_fullstep_wide=NUM_STEPS,
                                   decision_update_fullstep_large=NUM_STEPS * (
                                       grid_route == "large"),
                                   intrinsic_dp=1, **forward)
        npv_e, se_e = res_e.npv, res_e.val_sim_standard_error
        off_e = (npv_e - npv) / se
        finite_e = bool(np.isfinite(res_e.deltas.to_numpy()).all()
                        and np.isfinite(res_e.expected_profile.to_numpy()).all())
        log(f"caps: {case} with the full step (kernel E's {body} route, {grid_route}): NPV "
            f"{npv_e!r} SE {se_e!r} (the pinned bits {CAPS_FULLSTEP_NPV[case]!r}: "
            f"{npv_e == CAPS_FULLSTEP_NPV[case]}) "
            f"({off_e:+.4f} SE from the default route's NPV on the same paths, tolerance 0.05); "
            f"launches {launches_e}; walls in turns (full step, default, default, full step): "
            f"{walls[True][0]:.4f}, {walls[False][0]:.4f}, "
            f"{walls[False][1]:.4f}, {walls[True][1]:.4f} s; peak device memory {peak_e:.2f} GB; "
            f"finite deltas and profile {finite_e}")
        if body != "wide":
            raise AssertionError(f"{case}: the full step chose kernel E's {body} route")
        if launches_e != expected_e:
            raise AssertionError(f"{case} with the full step: launch counts {launches_e}, "
                                 f"expected {expected_e}")
        if not (math.isfinite(npv_e) and abs(off_e) <= 0.05 and finite_e):
            raise AssertionError(f"{case} with the full step: NPV {npv_e} is {off_e:+.4f} SE from "
                                 f"{npv}, or its deltas or profile are not finite")
        if npv_e != CAPS_FULLSTEP_NPV[case]:
            raise AssertionError(f"{case} with the full step: NPV {npv_e!r}, not the pinned bits "
                                 f"{CAPS_FULLSTEP_NPV[case]!r}")
        out[case] = dict(terms=terms, factors=factors,
                         route=f"moments_{plan.body}_{plan.name}", npv=npv, se=se,
                         se_from_f64=off, launches=dict(launches), wall_s=wall,
                         walls_s=walls[False], peak_memory_gb=peak,
                         fullstep=dict(route=f"fullstep_{body}_{grid_route}", npv=npv_e, se=se_e,
                                       se_from_default=off_e,
                                       launches=dict(launches_e), walls_s=walls[True],
                                       peak_memory_gb=peak_e))
    return out


def bunched_grid(lower, upper):
    """The custom-grid headline's rows: ``NUM_GRID`` points bunched toward
    the lower bound (``custom_grid``'s bunching at one width)."""
    import numpy as np

    return lower + (upper - lower) * np.linspace(0.0, 1.0, NUM_GRID) ** 1.3


def linspace_grid(lower, upper):
    """Evenly spaced rows through ``grid_calc``: the default grid's."""
    import numpy as np

    return np.linspace(lower, upper, NUM_GRID)


def bunched_rows(params, g: int, real: int):
    """Rows [N, G] over each step's next band (from the packed parameters):
    ``real`` points bunched toward the lower bound, then the last repeated
    (a custom grid padded to one width)."""
    import torch

    from storage_tpu_torch.ops import forward_kernel

    lo = params[:, forward_kernel._P_GRID_LO]
    hi = params[:, forward_kernel._P_GRID_HI]
    u = torch.linspace(0.0, 1.0, real, device=params.device) ** 1.3
    rows = lo[:, None] + (hi - lo)[:, None] * u
    return torch.cat([rows, rows[:, -1:].expand(-1, g - real)], dim=1).contiguous()


def ascending_rows(params, g: int):
    """Bunched rows [N, G] over each step's band taken in ascending order,
    the last three points repeated: ``random_sweep``'s bands invert after
    step 100, where ``bunched_rows`` would descend; these ascend at every
    step, as a custom grid's rows do."""
    import torch

    from storage_tpu_torch.ops import forward_kernel

    lo = params[:, forward_kernel._P_GRID_LO]
    hi = params[:, forward_kernel._P_GRID_HI]
    a, b = torch.minimum(lo, hi), torch.maximum(lo, hi)
    u = torch.linspace(0.0, 1.0, g, device=params.device) ** 1.3
    rows = a[:, None] + (b - a)[:, None] * u
    rows[:, g - 3:] = rows[:, g - 4:g - 3]
    return rows.contiguous()


def custom_rows(params, g: int, seed: int):
    """Rows [N, G] over each step's next band of sorted random nodes with
    exact interior repeats (every fifth node the one before it): a custom
    grid that is neither evenly spaced nor bunched."""
    import torch

    from storage_tpu_torch.ops import forward_kernel

    gen = torch.Generator(device=params.device).manual_seed(seed)
    lo = params[:, forward_kernel._P_GRID_LO]
    hi = params[:, forward_kernel._P_GRID_HI]
    u = torch.sort(torch.rand((params.shape[0], g), generator=gen, device=params.device),
                   dim=1).values
    u[:, 0], u[:, -1] = 0.0, 1.0
    rep = u[:, 2:g - 1:5]
    u[:, 2:g - 1:5] = u[:, 1:g - 1:5][:, :rep.shape[1]]
    return (lo[:, None] + (hi - lo)[:, None] * u).contiguous()


# SHA-256 of kernel C's outputs on each digest case (c_digest_cases), from
# the kernels of the commit before the bucket-index search and the 16-byte
# coefficient loads (tools/torch_forward_probe.py --smoke-digests on an
# NVIDIA H100 80GB HBM3): every redesign of C keeps these bits.
C_DIGESTS = {
    "monomial_G100_shared":
        "9b255d429938d639b5c92bb366344021b8d4338b7ba41fc14124ae9b2d3bec1b",
    "general_bunched_G100_shared":
        "aee1af93c1759fbc6d0e047a443a8ae52b7f23b4687834dd86c9bdc9fa8cd44e",
    "general_padded_G100_shared":
        "c7a8afceb80728cf1c164f9259bfec77a7eb5546ef3b0a3e59a718517a5117a1",
    "general_custom_G100_shared":
        "3d3559d8531bb9a74411d9071ea6a74bf596d676299c7e5310a884ac5abf25d3",
    "design_G100_shared":
        "9b255d429938d639b5c92bb366344021b8d4338b7ba41fc14124ae9b2d3bec1b",
    "design_general_padded_G100_shared":
        "c7a8afceb80728cf1c164f9259bfec77a7eb5546ef3b0a3e59a718517a5117a1",
    "monomial_G100_large":
        "9b255d429938d639b5c92bb366344021b8d4338b7ba41fc14124ae9b2d3bec1b",
    "general_bunched_G100_large":
        "aee1af93c1759fbc6d0e047a443a8ae52b7f23b4687834dd86c9bdc9fa8cd44e",
    "general_padded_G100_large":
        "c7a8afceb80728cf1c164f9259bfec77a7eb5546ef3b0a3e59a718517a5117a1",
    "general_custom_G100_large":
        "3d3559d8531bb9a74411d9071ea6a74bf596d676299c7e5310a884ac5abf25d3",
    "design_G100_large":
        "9b255d429938d639b5c92bb366344021b8d4338b7ba41fc14124ae9b2d3bec1b",
    "design_general_padded_G100_large":
        "c7a8afceb80728cf1c164f9259bfec77a7eb5546ef3b0a3e59a718517a5117a1",
    "monomial_G1000_shared":
        "382b1ca1a1ef6f5d02d52f909df467bdd85587765415ceaa5525998d0fbd21de",
    "general_bunched_G1000_shared":
        "fab2e9bbf61a5c6b58dea6ec4051d9abea50dc87819b9a095e847f01e025f293",
    "general_padded_G1000_shared":
        "816b883e39b411b73e53db1f0e5d3b4f53196260a6df4c0fc56b89326bc68f81",
    "general_custom_G1000_shared":
        "7f2445f964b4534320cf88d42a87f8e74a1be1ecd157bca25af986dede9f20cc",
    "design_G1000_shared":
        "382b1ca1a1ef6f5d02d52f909df467bdd85587765415ceaa5525998d0fbd21de",
    "design_general_padded_G1000_shared":
        "816b883e39b411b73e53db1f0e5d3b4f53196260a6df4c0fc56b89326bc68f81",
    "monomial_G1000_large":
        "382b1ca1a1ef6f5d02d52f909df467bdd85587765415ceaa5525998d0fbd21de",
    "general_bunched_G1000_large":
        "fab2e9bbf61a5c6b58dea6ec4051d9abea50dc87819b9a095e847f01e025f293",
    "general_padded_G1000_large":
        "816b883e39b411b73e53db1f0e5d3b4f53196260a6df4c0fc56b89326bc68f81",
    "general_custom_G1000_large":
        "7f2445f964b4534320cf88d42a87f8e74a1be1ecd157bca25af986dede9f20cc",
    "design_G1000_large":
        "382b1ca1a1ef6f5d02d52f909df467bdd85587765415ceaa5525998d0fbd21de",
    "design_general_padded_G1000_large":
        "816b883e39b411b73e53db1f0e5d3b4f53196260a6df4c0fc56b89326bc68f81",
    "monomial_G4096_large":
        "690c52d3d508afb5c92f01f8fdc2bd9526f0ab0c597859ff569273c9af41e3f7",
    "general_bunched_G4096_large":
        "8cdb874d81209e1057d9c3c40ade215c8c946046e3f8369658e4b59e1ef11087",
    "general_padded_G4096_large":
        "95f087d6f3a73953c3abb722dfb2e48ff8f67d010cf632c448c71e867ac31b5a",
    "general_custom_G4096_large":
        "570722b9d84766f39bdd0d7e39b0ebf9b78e0958c2c71dba00b4f81b768a451c",
    "design_G4096_large":
        "690c52d3d508afb5c92f01f8fdc2bd9526f0ab0c597859ff569273c9af41e3f7",
    "design_general_padded_G4096_large":
        "95f087d6f3a73953c3abb722dfb2e48ff8f67d010cf632c448c71e867ac31b5a",
    "general_ascending_G1000_shared":
        "59822f8397cbff037a005dbb7b4ba46a163697112b2287125bcff06812891079",
    "general_ascending_G1000_large":
        "59822f8397cbff037a005dbb7b4ba46a163697112b2287125bcff06812891079",
}

# Kernel C's digest cases (c_digest_cases): N = 32 steps (160 on the
# ascending rows) at S = GRID_CHECK_SIMS, B = 9, F = 3.
C_DIGEST_STEPS = 32
C_LONG_STEPS = 160


def c_digest_cases(device) -> dict:
    """Kernel C's fixed inputs for its SHA-256 digests, {name: (mode, args,
    design, grid, route)}: ``random_sweep``'s tables (seed 41) at G = 100,
    1,000 and 4,096, on each route that takes them (the shared route up to
    1,000), in the monomial mode on evenly spaced rows, in the general-grid
    mode on bunched, padded (G/8 repeats of the last node) and custom rows,
    in the design mode, and in the design mode on padded rows; and 160 steps
    at G = 1,000 on ``ascending_rows``.  Every row is non-decreasing, as a
    valuation's are."""
    import torch

    from storage_tpu_torch.basis import design_columns

    cases = {}
    for g in (NUM_GRID, BIG_GRID, GRID_BIG):
        args = random_sweep(device, C_DIGEST_STEPS, GRID_CHECK_SIMS, g, 3, seed=41)
        design = torch.stack(design_columns(args[11], args[6], args[7]), dim=1)
        rows = dict(bunched=bunched_rows(args[0], g, g),
                    padded=bunched_rows(args[0], g, g - g // 8),
                    custom=custom_rows(args[0], g, seed=43))
        for route in ("shared", "large") if g <= BIG_GRID else ("large",):
            tag = f"G{g}_{route}"
            cases[f"monomial_{tag}"] = ("monomial", args, None, None, route)
            for kind, grid in rows.items():
                cases[f"general_{kind}_{tag}"] = ("monomial", args, None, grid, route)
            cases[f"design_{tag}"] = ("design", args, design, None, route)
            cases[f"design_general_padded_{tag}"] = ("design", args, design, rows["padded"], route)
    args = random_sweep(device, C_LONG_STEPS, GRID_CHECK_SIMS, BIG_GRID, 3, seed=41)
    grid = ascending_rows(args[0], BIG_GRID)
    for route in ("shared", "large"):
        cases[f"general_ascending_G{BIG_GRID}_{route}"] = ("monomial", args, None, grid, route)
    return cases


def c_outputs(fk, case) -> list:
    """Kernel C's outputs on a digest case through the forward_kernel module
    ``fk``: final inventory and PV, sums, summed design rows, and the four
    per-sim panels."""
    import torch

    mode, args, design, grid, route = case
    n, s = args[6].shape
    panels = [torch.empty((n, s), device=args[6].device) for _ in range(4)]
    if mode == "design":
        out = fk.forward_sweep_design(*design_args(args, design), panels=panels, grid=grid,
                                      route=route)
    else:
        out = fk.forward_sweep(*args, panels=panels, grid=grid, route=route)
    return [*out, *panels]


def sha256_of(tensors) -> str:
    """SHA-256 of tensors' bytes, in order."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def check_c_digests(device) -> dict:
    """Kernel C on every digest case: its outputs' SHA-256 digests against
    the parent commit's (``C_DIGESTS``, from ``tools/torch_forward_probe.py
    --smoke-digests``), and each case against its plain version with no
    error and no flipped path; the widest bracket of the bucket index on the
    padded rows (the in-bucket search's largest)."""
    from storage_tpu_torch.ops import forward_kernel

    t0 = time.perf_counter()
    cases = c_digest_cases(device)
    got, bad, widest = {}, [], {}
    for name, case in cases.items():
        mode, args, design, grid, route = case
        outs = c_outputs(forward_kernel, case)
        got[name] = sha256_of(outs)
        cmp = compare_sweep(args, tuple(outs[:4]), outs[4:], design=design, grid=grid)
        exact = cmp["max_abs_err"] == 0.0 and cmp["flips"] == 0 and cmp["ok"]
        if not exact or got[name] != C_DIGESTS.get(name):
            bad.append((name, got[name][:16], cmp["text"]))
        if grid is not None and "padded" in name:
            widest[name] = int(forward_kernel.general_brackets(
                forward_kernel.general_tail(grid)).max())
        del outs
    log(f"kernel C digests: {len(cases) - len(bad)} of {len(cases)} cases (every mode, both "
        f"routes, G = {NUM_GRID}, {BIG_GRID}, {GRID_BIG}; evenly spaced, bunched, padded, custom "
        f"and ascending rows) have the parent's SHA-256 digests and their plain version's values "
        f"(0 error, 0 flips); the in-bucket search's largest bracket on the padded rows: "
        f"{max(widest.values())} nodes ({widest}); {time.perf_counter() - t0:.1f} s")
    if bad:
        raise AssertionError(f"kernel C's outputs part from the parent's digests or from their "
                             f"plain version: {bad}")
    return dict(cases=len(cases), digests=got, largest_bracket_padded=max(widest.values()),
                brackets=widest)


def general_tail_work(n: int, g: int) -> tuple:
    """(bytes, fused, other issue slots, integer operations) of the bucket
    index over N rows of G nodes (``forward_kernel.general_tail``): each row
    read once, its 2G + 1 words written once; a node's copy, order check
    and bucket (~8 slots: the load, the store, the compare, the
    subtraction, product, floor and minimum) and a count's store and loop
    (~3 integer operations)."""
    return 4.0 * n * (g + 2 * g + 1), 0.0, 8.0 * n * g, 3.0 * n * g


def bucket_edges(rows):
    """The library form of ``general_tail``'s counts: each row's interior
    nodes [N, G − 2] and its K + 1 = G bucket edges row[0] + i·span/K [N, G],
    so that one batched ``torch.searchsorted(nodes, edges)`` counts the
    interior nodes below each edge (the kernel's counts up to the rounding
    of a node on an edge; the edges are made here, outside its timing)."""
    import torch

    n, g = rows.shape
    a, b = rows[:, :1], rows[:, g - 1:]
    steps = torch.arange(g, device=rows.device, dtype=rows.dtype) / (g - 1)
    return rows[:, 1:g - 1].contiguous(), (a + (b - a) * steps).contiguous()


def vjp_work(n: int, s: int) -> tuple:
    """(bytes, unfused f32 operations) of the forward sweep's VJP: three
    [N, S] panels and g [S] in, fwd and df_settle in and grad out [N]; per
    element an add, two multiplies and the sum's add."""
    return 4.0 * (3 * n * s + s + 3 * n), 4.0 * n * s


def check_adjoint_kernels(pkg, device) -> dict:
    """The forward sweep's VJP and kernel C's general-grid mode against their
    plain versions on the card.  The VJP on the main path's own volume, fuel
    and spot panels (relative error within 1e-5 of its largest entry), at
    g = 1/S against kernel C's pathwise-delta sums of the same sweep (the
    same tolerance: two independent computations), and at S = 1,000 with a
    random g in f32 and f64; timed beside its bound and one einsum.  The
    general-grid mode on the main path's tables on bunched rows (G = 100) in
    the monomial mode, on padded rows in the design mode, and at G = 1,000:
    the plain version's per-sim values, flips only on near-ties; timed
    beside the evenly spaced mode in this call."""
    import torch

    from storage_tpu_torch.basis import design_columns
    from storage_tpu_torch.ops import forward_kernel

    st = backward_step_inputs(pkg, device)
    fwd_all = st.arrays["fwd"]
    args = forward_sweep_inputs(pkg, device, st)
    del st
    n, s = args[6].shape
    spot, params = args[6], args[0]
    fwd, df = fwd_all[:n].contiguous(), params[:, forward_kernel._P_DF_SETTLE].contiguous()
    dec, cons = (torch.empty((n, s), device=device) for _ in range(2))
    _, _, sums, _ = forward_kernel.forward_sweep(*args, panels=[None, dec, cons, None])
    g = torch.full((s,), 1.0 / s, device=device)
    got = forward_kernel.forward_sweep_vjp(dec, cons, spot, fwd, df, g)
    want = forward_kernel.forward_sweep_vjp_plain(dec, cons, spot, fwd, df, g)
    pathwise = sums[:, forward_kernel._A_DELTA] / s / fwd * df
    err_main = rel_err(got, want)
    err_delta = rel_err(got, pathwise)
    small = {}
    for dtype in (torch.float32, torch.float64):
        gen = torch.Generator(device=device).manual_seed(23)
        rnd = lambda *shape: torch.randn(shape, generator=gen, device=device, dtype=dtype)  # noqa: E731,B023
        cut = lambda x: x[:, :1000].to(dtype).contiguous()  # noqa: E731,B023
        xs = (cut(dec), cut(cons), cut(spot), fwd.to(dtype), df.to(dtype), rnd(min(1000, s)))
        small[str(dtype).split(".")[1]] = rel_err(forward_kernel.forward_sweep_vjp(*xs),
                                                  forward_kernel.forward_sweep_vjp_plain(*xs))
    ms = cuda_ms(lambda: forward_kernel.forward_sweep_vjp(dec, cons, spot, fwd, df, g), 50)
    plain_ms = cuda_ms(lambda: forward_kernel.forward_sweep_vjp_plain(dec, cons, spot, fwd, df, g),
                       10)
    net = -(dec + cons)
    library_ms = cuda_ms(lambda: torch.einsum("ts,ts,s->t", net, spot, g), 10)
    del net
    vjp_bytes, vjp_ops = vjp_work(n, s)
    bnd = bound(vjp_bytes, 0.0, vjp_ops)
    log(f"forward_sweep_vjp [N={n}, S={s}], the main path's volume, fuel and spot panels, g = 1/S: "
        f"max rel err {err_main:.3e} against its plain version, {err_delta:.3e} against kernel C's "
        f"pathwise-delta sums (tolerance 1e-5 of the largest entry each); S=1,000, random g: "
        f"f32 {small['float32']:.3e} (tolerance 1e-5), f64 {small['float64']:.3e} (tolerance "
        f"1e-12); {ms:.4f} ms vs plain {plain_ms:.3f} ms, einsum('ts,ts,s->t') {library_ms:.4f} "
        f"ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
    if not (err_main <= 1e-5 and err_delta <= 1e-5 and small["float32"] <= 1e-5
            and small["float64"] <= 1e-12):
        raise AssertionError("forward_sweep_vjp disagrees with its plain version or with kernel "
                             "C's pathwise-delta sums")
    vjp = dict(max_abs_err=float((got - want).abs().max()), max_rel_err=err_main,
               rel_err_vs_pathwise_sums=err_delta, small_rel_err=small, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, **bnd)
    del dec, cons, got, want

    # ---- kernel C's general-grid mode.
    mono = args[11]
    b_dim, g_, r_ = len(mono), args[10].shape[2], args[3].shape[1]
    rows = bunched_rows(params, g_, g_)
    padded = bunched_rows(params, g_, g_ - 10)
    cmp_mono = compare_sweep(args, grid=rows)
    ms_general = cuda_ms(lambda: forward_kernel.forward_sweep(*args, grid=rows), 20)
    ms_uniform = cuda_ms(lambda: forward_kernel.forward_sweep(*args), 20)
    plain_general_ms = cuda_ms(lambda: forward_kernel.forward_sweep_plain(*args, grid=rows), 1)
    design = torch.stack(design_columns(mono, args[6], args[7]), dim=1)  # [N, B, S]
    cmp_design = compare_sweep(args, design=design, grid=padded)
    d_args = design_args(args, design)
    ms_design = cuda_ms(lambda: forward_kernel.forward_sweep_design(*d_args, grid=padded), 10)
    ms_design_uniform = cuda_ms(lambda: forward_kernel.forward_sweep_design(*d_args), 10)
    plain_design_ms = cuda_ms(
        lambda: forward_kernel.forward_sweep_plain(*args, design=design, grid=padded), 1)
    del d_args, design, args
    big = random_sweep(device, 8, BIG_SIMS, BIG_GRID, 3, seed=17)
    cmp_big = compare_sweep(big, grid=bunched_rows(big[0], BIG_GRID, BIG_GRID - 10))
    del big
    tails = {}
    big_rows = bunched_rows(params, GRID_BIG, GRID_BIG - GRID_BIG // 8)
    for name, rows_t in (("main", rows), ("padded", padded), ("big", big_rows)):
        got_t = forward_kernel.general_tail(rows_t)
        want_t = forward_kernel.general_tail_plain(rows_t)
        nodes, edges = bucket_edges(rows_t)
        kernel = lambda rows_t=rows_t: forward_kernel.general_tail(rows_t)  # noqa: E731
        library = lambda: torch.searchsorted(nodes, edges)  # noqa: E731,B023
        # Each one's own device time (torch.profiler, 50 calls, or a CUDA
        # graph's where the profiler saw none), beside the host's rate that
        # CUDA events around back-to-back calls measure.
        own, src_own, _ = own_launch_ms(kernel, "general_tail", 50)
        lib_own, src_lib, _ = own_launch_ms(library, "searchsorted", 50)
        tails[name] = dict(
            same=torch.equal(got_t.view(torch.int32), want_t.view(torch.int32)),
            ms=own, library_ms=lib_own, ms_source=src_own, library_ms_source=src_lib,
            wrapper_ms=cuda_ms(kernel, 50),
            library_wrapper_ms=cuda_ms(library, 50),
            plain_ms=cuda_ms(lambda rows_t=rows_t: forward_kernel.general_tail_plain(rows_t), 5),
            bound=bound(*general_tail_work(*rows_t.shape)),
            largest_bracket=int(forward_kernel.general_brackets(got_t).max()),
            grid=rows_t.shape[1])
        del got_t, want_t, nodes, edges
    log(f"general_tail (the general-grid mode's bucket index) [N={n}; G={g_}, padded, "
        f"{GRID_BIG}]: its plain version's bits: "
        f"{[t_['same'] for t_ in tails.values()]}; its own device time {tails['main']['ms']:.5f} / "
        f"{tails['big']['ms']:.5f} ms a launch (G={g_} / {GRID_BIG}; "
        f"{tails['main']['ms_source']} / {tails['big']['ms_source']} over 50 launches) "
        f"against one batched torch.searchsorted of the interior nodes against the bucket "
        f"edges, its own {tails['main']['library_ms']:.5f} / "
        f"{tails['big']['library_ms']:.5f} ms ({tails['main']['library_ms_source']} / "
        f"{tails['big']['library_ms_source']}); the host's rate back to back (CUDA events) "
        f"{tails['main']['wrapper_ms']:.4f} / {tails['big']['wrapper_ms']:.4f} ms against "
        f"{tails['main']['library_wrapper_ms']:.4f} / {tails['big']['library_wrapper_ms']:.4f} "
        f"ms; plain {tails['main']['plain_ms']:.3f} / {tails['big']['plain_ms']:.3f} ms, bound "
        f"{tails['main']['bound']['bound_ms']:.5f} / {tails['big']['bound']['bound_ms']:.5f} "
        f"ms; largest bracket {tails['padded']['largest_bracket']} nodes on the padded rows, "
        f"{tails['big']['largest_bracket']} at G={GRID_BIG}")
    if not all(t_["same"] for t_ in tails.values()):
        raise AssertionError("general_tail parts from its plain version's bits")
    info = forward_kernel.kernel_info(g_, b_dim, r_, 3, 0, device, general=True)
    info_d = forward_kernel.kernel_info(g_, b_dim, r_, 0, 0, device, design=True, general=True)
    bnd_g = bound(*forward_work(n, s, 3, b_dim, g_, r_, 3, panels=False, general=True))
    bnd_d = bound(*forward_work(n, s, 0, b_dim, g_, r_, 3, panels=False, design=True,
                                general=True))
    for name, c in (("bunched rows, monomial mode", cmp_mono),
                    ("padded rows, design mode", cmp_design)):
        log(f"kernel C general-grid mode [N={n}, S={s}, G={g_}, D=3, B={b_dim}, R={r_}], the main "
            f"path's tables and paths on {name}: {c['text']}")
    log(f"kernel C general-grid mode [big_grid: N=8, S={BIG_SIMS}, G={BIG_GRID}, padded rows]: "
        f"{cmp_big['text']}")
    log(f"kernel C general-grid mode: {ms_general:.4f} ms a sweep against {ms_uniform:.4f} ms "
        f"evenly spaced in this call, plain {plain_general_ms:.1f} ms, bound "
        f"{bnd_g['bound_ms']:.4f} ms ({bnd_g['bound_by']}); design mode {ms_design:.4f} ms "
        f"against {ms_design_uniform:.4f} ms, plain {plain_design_ms:.1f} ms, bound "
        f"{bnd_d['bound_ms']:.4f} ms; launch: {info['smem_bytes']} bytes of shared memory per "
        f"block (G <= {info['max_grid']}), {info['blocks_per_sm']} blocks per SM, "
        f"{info['registers']} registers (design mode {info_d['smem_bytes']} bytes, G <= "
        f"{info_d['max_grid']}, {info_d['registers']} registers)")
    for c in (cmp_mono, cmp_design, cmp_big):
        if not c["ok"]:
            raise AssertionError(f"kernel C's general-grid mode disagrees with its plain version: "
                                 f"{c['text']}")
    general = dict(
        max_abs_err=cmp_mono["max_abs_err"], ms=ms_general, plain_ms=plain_general_ms,
        uniform_ms=ms_uniform, big_grid={k: v_ for k, v_ in cmp_big.items() if k != "text"},
        smem_bytes=info["smem_bytes"], blocks_per_sm=info["blocks_per_sm"],
        registers=info["registers"], max_grid=info["max_grid"],
        butterfly_ms=butterfly_ms(n, s, b_dim),
        **{k: v_ for k, v_ in cmp_mono.items() if k not in ("text", "max_abs_err", "ok")}, **bnd_g)
    design_general = dict(
        max_abs_err=cmp_design["max_abs_err"], ms=ms_design, plain_ms=plain_design_ms,
        uniform_ms=ms_design_uniform, smem_bytes=info_d["smem_bytes"],
        blocks_per_sm=info_d["blocks_per_sm"], registers=info_d["registers"],
        butterfly_ms=butterfly_ms(n, s, b_dim),
        **{k: v_ for k, v_ in cmp_design.items() if k not in ("text", "max_abs_err", "ok")},
        **bnd_d)
    tail_row = dict(max_abs_err=0.0, ms=tails["main"]["ms"], plain_ms=tails["main"]["plain_ms"],
                    library_ms=tails["main"]["library_ms"], ms_source=tails["main"]["ms_source"],
                    wrapper_ms=tails["main"]["wrapper_ms"],
                    library_wrapper_ms=tails["main"]["library_wrapper_ms"],
                    grid=g_, big_grid_ms=tails["big"]["ms"],
                    big_grid_library_ms=tails["big"]["library_ms"],
                    big_grid_bound_ms=tails["big"]["bound"]["bound_ms"],
                    big_grid_wrapper_ms=tails["big"]["wrapper_ms"],
                    big_grid_library_wrapper_ms=tails["big"]["library_wrapper_ms"],
                    largest_bracket=tails["padded"]["largest_bracket"], **tails["main"]["bound"])
    return {"forward_sweep_vjp": vjp, "forward_sweep_general": general,
            "forward_sweep_design_general": design_general, "general_tail": tail_row}


def interleaved_walls(fns: dict, rounds: int) -> dict:
    """Host seconds of each of ``fns`` called in turns, ``rounds`` times
    each (every call synchronised): name -> list of walls."""
    import torch

    walls = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
    return walls


def adjoint_grid_phase(pkg, device, counts, main) -> dict:
    """Adjoint deltas and custom grids at the headline, each path with the
    launch counters reset just before it.  The adjoint valuation: the main
    path's NPV, SE, intrinsic value and profile bits, its deltas for t < N
    within 1e-5 of the largest pathwise delta, its last delta the terminal
    value's gradient (against mean(spot_N·inventory_N)/fwd_N in f64 on the
    same paths), one VJP launch; its wall (median of 3) beside the pathwise
    one's in turns, and its peak device memory.  The custom grid
    (``bunched_grid``): within 0.1 SE of its f64 answer (``F64_CUSTOM_NPV``),
    one general-mode sweep; evenly spaced rows through ``grid_calc`` the main
    path's bits; its adjoint deltas its pathwise ones; the replicated
    generic basis on it (kernel C's design mode in the general-grid mode,
    within 0.1 SE of the monomial basis); a checkpoint made on it revalued
    on the same valuation paths to its NPV bits."""
    import numpy as np
    import torch

    from storage_tpu_torch import checkpoint as ckpt
    from storage_tpu_torch.engines import lsmc as engine
    from storage_tpu_torch.models import spot_sim
    from storage_tpu_torch.ops import forward_kernel

    report = {}
    main_launches = dict(simulate_sweep=2, decision_update_moments=NUM_STEPS, forward_sweep=1,
                         intrinsic_dp=1)

    def run(expected, **kwargs):
        counts.reset()
        res = value(pkg, device, True, **kwargs)
        torch.cuda.synchronize()
        launches = counts.read()
        if launches != counts.expect(**expected):
            raise AssertionError(f"{kwargs}: launch counts {launches}, expected "
                                 f"{counts.expect(**expected)}")
        return res, launches

    # ---- adjoint deltas at the headline.
    torch.cuda.reset_peak_memory_stats(device)
    adj, adj_launches = run({**main_launches, "forward_sweep_vjp": 1}, deltas_method="adjoint")
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    d_adj, d_path = adj.deltas.to_numpy(), main.deltas.to_numpy()
    delta_err = float(np.abs(d_adj[:-1] - d_path[:-1]).max() / np.abs(d_path).max())
    same = ((adj.npv, adj.val_sim_standard_error, adj.intrinsic_npv)
            == (main.npv, main.val_sim_standard_error, main.intrinsic_npv)
            and adj.expected_profile.equals(main.expected_profile))
    # The terminal gradient's plain formula on the same paths, in f64.
    inputs, sim_in, arrays, monomials = engine_inputs(pkg, device)
    ids = torch.arange(NUM_SIMS, device=device)
    reg, val = (spot_sim.simulate_ou_paths(spot_sim.key_from_seed(k), ids, *sim_in)
                for k in (11, 13))
    with engine.full_f32_matmul():
        out = engine.lsmc_core(arrays, reg.spot, reg.factors, val.spot, val.factors, 100.0,
                               monomials, 0, False, terminal_npv, False, snap_interp=True,
                               return_sim_data=True, adjoint=True)
    end_grad = engine.adjoint_deltas(out.pop("adjoint_tape"))[-1]
    inv_end = out["sim_inventory"][NUM_STEPS].double()
    want_end = float((val.spot[NUM_STEPS].double() * inv_end).mean()
                     / float(arrays["fwd"][NUM_STEPS]))
    end_err = abs(float(end_grad) - want_end) / abs(want_end)
    engine_same = float(out["npv"]) == main.npv and float(end_grad) == float(d_adj[-1])
    del out, reg, val, inv_end
    walls = interleaved_walls({
        "adjoint": lambda: value(pkg, device, True, deltas_method="adjoint"),
        "pathwise": lambda: value(pkg, device, True)}, 3)
    adj_wall, path_wall = (float(np.median(walls[k])) for k in ("adjoint", "pathwise"))
    log(f"adjoint deltas at the headline: NPV {adj.npv!r} SE {adj.val_sim_standard_error!r}; the "
        f"main path's NPV, SE, intrinsic value and profile bits: {same}; deltas[:N] max diff "
        f"{delta_err:.3e} of the largest pathwise delta (tolerance 1e-5); deltas[N] "
        f"{float(d_adj[-1])!r}, the terminal gradient mean(spot_N*inv_N)/fwd_N in f64 {want_end!r} "
        f"(rel {end_err:.2e}, tolerance 1e-5; the engine run's bits: {engine_same}); wall median "
        f"{adj_wall:.4f} s vs pathwise {path_wall:.4f} s in turns (ratio "
        f"{adj_wall / path_wall:.3f}); peak device memory {peak_gb:.2f} GB; launches "
        f"{adj_launches}")
    if not (same and delta_err <= 1e-5 and end_err <= 1e-5 and engine_same):
        raise AssertionError("the adjoint valuation disagrees with the pathwise main path")
    report["adjoint"] = dict(npv=adj.npv, se=adj.val_sim_standard_error, delta_rel_err=delta_err,
                             terminal_delta=float(d_adj[-1]), terminal_delta_f64=want_end,
                             terminal_rel_err=end_err, wall_s=adj_wall, pathwise_wall_s=path_wall,
                             walls_s=walls, wall_ratio=adj_wall / path_wall,
                             peak_memory_gb=peak_gb, launches=adj_launches)

    # ---- the headline on a custom grid.
    general = {**main_launches, "forward_sweep_general": 1, "general_tail": 1}
    custom, custom_launches = run(general, grid_calc=bunched_grid)
    walls_c = api_walls(lambda: value(pkg, device, True, grid_calc=bunched_grid), 3)
    custom_wall = float(np.median(walls_c))
    off = (custom.npv - F64_CUSTOM_NPV) / custom.val_sim_standard_error
    linspace, _ = run(main_launches, grid_calc=linspace_grid)
    linspace_same = same_bits(linspace, main) and linspace.intrinsic_npv == main.intrinsic_npv
    custom_adj, _ = run({**general, "forward_sweep_vjp": 1}, grid_calc=bunched_grid,
                        deltas_method="adjoint")
    c_adj, c_path = custom_adj.deltas.to_numpy(), custom.deltas.to_numpy()
    custom_delta_err = float(np.abs(c_adj[:-1] - c_path[:-1]).max() / np.abs(c_path).max())
    custom_adj_same = (custom_adj.npv, custom_adj.val_sim_standard_error) == (
        custom.npv, custom.val_sim_standard_error)
    chunks = -(-NUM_STEPS // forward_kernel.DESIGN_CHUNK)
    replica, replica_launches = run(
        dict(simulate_sweep=2, decision_update=NUM_STEPS, pack_records=NUM_STEPS,
             forward_sweep_design=chunks, forward_sweep_design_general=chunks,
             general_tail=chunks, intrinsic_dp=1),
        basis=replica_basis(pkg), grid_calc=bunched_grid)
    replica_gap = (replica.npv - custom.npv) / custom.val_sim_standard_error
    log(f"custom grid (bunched_grid, {NUM_GRID} points) at the headline: NPV {custom.npv!r} SE "
        f"{custom.val_sim_standard_error!r}, {off:+.4f} SE from its f64 answer {F64_CUSTOM_NPV!r} "
        f"(tolerance 0.1); intrinsic {custom.intrinsic_npv!r}; wall median {custom_wall:.4f} s of "
        f"{[round(w, 4) for w in walls_c]}; launches {custom_launches}; evenly spaced rows "
        f"through grid_calc give the main path's bits: {linspace_same}; adjoint on the custom "
        f"grid: the pathwise NPV and SE bits {custom_adj_same}, deltas[:N] max diff "
        f"{custom_delta_err:.3e} of the largest (tolerance 1e-5); the replicated generic basis "
        f"on it (C's design mode, general rows): NPV {replica.npv!r}, {replica_gap:+.4f} SE from "
        f"the monomial basis (tolerance 0.1), launches {replica_launches}")
    if not (math.isfinite(custom.npv) and abs(off) <= 0.1 and linspace_same and custom_adj_same
            and custom_delta_err <= 1e-5 and abs(replica_gap) <= 0.1):
        raise AssertionError("the custom-grid valuations fail their checks")

    path = OUT / "checkpoint_custom.npz"
    res = value(pkg, device, True, grid_calc=bunched_grid, checkpoint_path=str(path))
    if not same_bits(res, custom):
        raise AssertionError("the valuation that wrote the custom-grid checkpoint is not the "
                             "custom-grid run's bits")
    _, sim_in, _, _ = engine_inputs(pkg, device)
    val = spot_sim.simulate_ou_paths(spot_sim.key_from_seed(13),
                                     torch.arange(NUM_SIMS, device=device), *sim_in)
    counts.reset()
    out = ckpt.revalue_from_checkpoint(ckpt.RegressionCheckpoint.load(str(path)), val.spot,
                                       val.factors, terminal_fn=terminal_npv, device=device)
    reval_npv = float(out["npv"])
    reval_launches = counts.read()
    log(f"custom-grid checkpoint revaluation on the same valuation paths: NPV {reval_npv!r}, the "
        f"custom-grid run's bits: {reval_npv == custom.npv}; launches {reval_launches}")
    if reval_npv != custom.npv or reval_launches != counts.expect(
            forward_sweep=1, forward_sweep_general=1, general_tail=1):
        raise AssertionError(f"custom-grid revaluation: NPV {reval_npv!r}, launches "
                             f"{reval_launches}")
    report["custom_grid"] = dict(
        npv=custom.npv, se=custom.val_sim_standard_error, z_vs_f64=off,
        intrinsic_npv=custom.intrinsic_npv, wall_s=custom_wall, walls_s=walls_c,
        launches=custom_launches, linspace_same_bits=linspace_same,
        adjoint_delta_rel_err=custom_delta_err, replica_npv=replica.npv,
        replica_gap_se=replica_gap, replica_launches=replica_launches,
        checkpoint_npv=reval_npv, checkpoint_launches=reval_launches)
    return report


HOURLY_STEPS = 8_760
HOURLY_STEPS = 8_760


def hourly_case(pkg):
    """An hourly year of the headline's facility shape (3 linear ratchet
    nodes, a loss), starting at 100: the band's long horizon."""
    import pandas as pd

    hour = pd.Period("2021-01-01 00:00", freq="h")
    storage = pkg.CmdtyStorage(
        "h", hour, hour + HOURLY_STEPS, 0.9, 0.7,
        ratchets=[(hour, [(0.0, -8.0, 12.5), (2500.0, -10.0, 10.0), (5000.0, -12.5, 8.0)])],
        ratchet_interp=pkg.RatchetInterp.LINEAR, inventory_loss=1e-6,
        terminal_storage_npv=terminal_npv,
    )
    return storage, hour


def median_s(fn, repeats: int) -> float:
    """Median host seconds of ``repeats`` calls of ``fn`` (``api_walls``)."""
    import numpy as np

    return float(np.median(api_walls(fn, repeats)))


def progress_marks(num_steps: int, seg_len: int = 16) -> list:
    """The progress fractions the JAX package's mapping gives an interactive
    valuation of ``num_steps`` steps (``storage_tpu/api_lsmc.py:547-595``):
    0.2, 0.3, a tick a segment of each pass, 0.9, 1.0."""
    total = -(-num_steps // seg_len)
    ticks = []
    for phase in ("backward", "forward"):
        for done in range(1, total + 1):
            frac = done / max(total, 1)
            part = 0.4 * frac if phase == "backward" else 0.4 + 0.2 * frac
            ticks.append(min(0.3 + part, 0.9))
    return [0.2, 0.3, *ticks, 0.9, 1.0]


def same_bits(got, want) -> bool:
    """NPV, SE, deltas and expected profile to the bit."""
    return ((got.npv, got.val_sim_standard_error) == (want.npv, want.val_sim_standard_error)
            and got.deltas.equals(want.deltas)
            and got.expected_profile.equals(want.expected_profile))


def band_checks(pkg, device) -> dict:
    """The C++ band reducer against the Python band on the headline and an
    hourly year (the same f64 bits; the C++ band's median of 5, the Python
    band's of 5 at the headline and its one timed call on the hourly year,
    which takes seconds), then the host prep of the headline with each, in
    turns."""
    from unittest import mock

    import numpy as np
    import torch

    from storage_tpu_torch import grid as gridmod
    from storage_tpu_torch import valuation_inputs

    storage, start, _ = bench_case(pkg)
    hourly, hour = hourly_case(pkg)
    report = {}
    for name, (st, val), repeats in (("headline", (storage, start), 5),
                                     ("hourly", (hourly, hour), 1)):
        native = gridmod.calculate_inventory_space(st, 100.0, val, use_native=True)
        t0 = time.perf_counter()
        python = gridmod.calculate_inventory_space(st, 100.0, val, use_native=False)
        python_s = [time.perf_counter() - t0] + api_walls(
            lambda: gridmod.calculate_inventory_space(st, 100.0, val, use_native=False),
            repeats - 1)
        err = max(float(np.max(np.abs(a - b))) for a, b in zip(native, python))
        same = all(np.array_equal(a, b) for a, b in zip(native, python))
        native_ms = 1e3 * median_s(
            lambda: gridmod.calculate_inventory_space(st, 100.0, val, use_native=True), 5)
        python_ms = 1e3 * float(np.median(python_s))
        how = "median of 5" if repeats > 1 else "one call"
        log(f"band ({name}, {len(native[0]) - 1} steps): the C++ reducer {native_ms:.4f} ms "
            f"(median of 5), the Python band {python_ms:.4f} ms ({how}); the same f64 bits: "
            f"{same}")
        if not same:
            raise AssertionError(f"the native band parts from the Python band on {name} by {err}")
        report[name] = dict(native_ms=native_ms, python_ms=python_ms, max_abs_err=err)

    band = gridmod.calculate_inventory_space
    python_band = mock.patch.object(valuation_inputs.gridmod, "calculate_inventory_space",
                                    lambda *a, **k: band(*a, **k, use_native=False))
    preps = {"native": [], "python": []}
    for _ in range(5):  # in turns: native, python
        for which in ("native", "python"):
            with python_band if which == "python" else contextlib.nullcontext():
                t0 = time.perf_counter()
                engine_inputs(pkg, device)
                torch.cuda.synchronize()
                preps[which].append(time.perf_counter() - t0)
    report["host_prep_native_s"] = float(np.median(preps["native"]))
    report["host_prep_python_s"] = float(np.median(preps["python"]))
    report["host_prep_runs_s"] = preps
    log(f"host prep (the phase timer's inputs) with the C++ band {report['host_prep_native_s']:.4f} "
        f"s, with the Python band {report['host_prep_python_s']:.4f} s (medians of 5, in turns)")
    return report


def interactive_checks(pkg, device, counts, main) -> dict:
    """An interactive headline valuation (the main path's bits, kernel C once
    a 16-step segment, the JAX mapping's fractions), its wall beside the
    main path's, and a cancel after the fifth progress call."""
    import numpy as np
    import torch

    fractions = []
    counts.reset()
    res = value(pkg, device, True, on_progress_update=fractions.append,
                cancellation_poll=lambda: False)
    torch.cuda.synchronize()
    launches = counts.read()
    segments = -(-NUM_STEPS // 16)
    expected = counts.expect(simulate_sweep=2, decision_update_moments=NUM_STEPS,
                             forward_sweep=segments, intrinsic_dp=1)
    marks = progress_marks(NUM_STEPS)
    same = same_bits(res, main)
    log(f"interactive valuation: NPV {res.npv!r} SE {res.val_sim_standard_error!r}, the main "
        f"path's bits: {same}; {len(fractions)} progress calls, the JAX mapping's list: "
        f"{fractions == marks}; launches {launches}")
    if launches != expected:
        raise AssertionError(f"launch counts {launches}, expected {expected}")
    if fractions != marks:
        raise AssertionError(f"progress {fractions}, expected {marks}")
    if not same:
        raise AssertionError("the interactive valuation is not the main path's bits")
    walls = api_walls(lambda: value(pkg, device, True, on_progress_update=lambda f: None), 3)
    log(f"interactive wall median {float(np.median(walls)):.4f} s of "
        f"{[round(w, 4) for w in walls]}")

    from storage_tpu_torch.jobs import JobCancelledError

    seen, polled = [], {}

    def poll():
        if len(seen) >= 5:
            polled.setdefault("t", time.perf_counter())
            return True
        return False

    try:
        value(pkg, device, True, on_progress_update=seen.append, cancellation_poll=poll)
    except JobCancelledError:
        latency = time.perf_counter() - polled["t"]
    else:
        raise AssertionError("the cancel poll did not stop the valuation")
    after = value(pkg, device, True)
    log(f"cancel: raised {1e3 * latency:.3f} ms after the poll turned true, progress seen "
        f"{[round(f, 4) for f in seen]}; the next valuation is the main path's bits: "
        f"{same_bits(after, main)}")
    if any(f > 0.7 for f in seen) or not same_bits(after, main):
        raise AssertionError("the cancel did not stop the backward, or the next run moved")
    return dict(launches=launches, progress_calls=len(fractions), wall_s=float(np.median(walls)),
                walls_s=walls, cancel_latency_ms=1e3 * latency)


def checkpoint_checks(pkg, device, counts, main) -> dict:
    """The main path with ``checkpoint_path``, then forward-only revaluations
    on its valuation paths, from the checkpoint and from the file read back:
    the main path's NPV, with one launch of kernel C and no other."""
    import numpy as np
    import torch

    from storage_tpu_torch import checkpoint as ckpt
    from storage_tpu_torch.models import spot_sim

    path = OUT / "checkpoint.npz"
    t0 = time.perf_counter()
    res = value(pkg, device, True, checkpoint_path=str(path))
    full_s = time.perf_counter() - t0
    if not same_bits(res, main):
        raise AssertionError("the valuation that wrote the checkpoint is not the main path's bits")
    _, sim_in, _, _ = engine_inputs(pkg, device)
    val = spot_sim.simulate_ou_paths(spot_sim.key_from_seed(13),
                                     torch.arange(NUM_SIMS, device=device), *sim_in)
    report = {"full_s": full_s}
    written = ckpt.RegressionCheckpoint.load(str(path))
    written.save(str(OUT / "checkpoint_again.npz"))
    again = ckpt.RegressionCheckpoint.load(str(OUT / "checkpoint_again.npz"))
    for name, source in (("written by the valuation", written), ("saved and read back", again)):
        counts.reset()
        out = ckpt.revalue_from_checkpoint(source, val.spot, val.factors,
                                           terminal_fn=terminal_npv, device=device)
        npv = float(out["npv"])
        launches = counts.read()
        walls = api_walls(lambda: float(ckpt.revalue_from_checkpoint(
            source, val.spot, val.factors, terminal_fn=terminal_npv, device=device)["npv"]), 3)
        log(f"checkpoint revaluation ({name}): NPV {npv!r}, the main path's bits: "
            f"{npv == main.npv}; {float(np.median(walls)):.4f} s (median of 3) beside the full "
            f"valuation's {full_s:.4f} s; launches {launches}")
        if launches != counts.expect(forward_sweep=1) or npv != main.npv:
            raise AssertionError(f"revaluation ({name}): NPV {npv!r}, launches {launches}")
        report[name.split()[0]] = dict(npv=npv, wall_s=float(np.median(walls)),
                                              launches=launches)
    return report


def service_checks(pkg, device, main) -> dict:
    """``CalculationService(device="cuda")`` in async mode: the main path's
    bits with progress pushed, a second calc cancelled; two valuations at
    once on a two-thread job engine, each its serial run's bits."""
    import torch

    storage, start, fwd = bench_case(pkg)
    kwargs = dict(val_date=start, inventory=100.0, fwd_curve=fwd, interest_rates=0.02,
                  settlement_rule=None, spot_mean_reversion=14.5, spot_vol=1.1,
                  long_term_vol=0.19, seasonal_vol=0.23, num_sims=NUM_SIMS, basis_funcs=BASIS,
                  discount_deltas=False, seed=11, fwd_sim_seed=13,
                  num_inventory_grid_points=NUM_GRID, dtype=torch.float32, snap_interp=True)
    report = {}
    with pkg.CalculationService(device=device) as svc:
        sh = svc.create_storage("headline", **bench_storage_kwargs(pkg))
        pushed, statuses = [], []
        ch = svc.storage_value_three_factor("main", sh, **kwargs)
        svc.subscribe_progress(ch, pushed.append)
        svc.subscribe_status(ch, statuses.append)
        t0 = time.perf_counter()
        svc.start_pending(ch)
        res = svc.calc_result(ch)
        report["calc_s"] = time.perf_counter() - t0
        deadline = time.time() + 10
        while time.time() < deadline and pkg.CalcStatus.SUCCESS not in statuses:
            time.sleep(0.01)
        status = svc.calc_status(ch)
        log(f"service: status {status.name}, {len(pushed)} progress pushes (last "
            f"{pushed[-1] if pushed else None}), the main path's bits: {same_bits(res, main)}; "
            f"{report['calc_s']:.4f} s; provider {svc.linear_algebra_provider()}")
        if status != pkg.CalcStatus.SUCCESS or not pushed or not same_bits(res, main):
            raise AssertionError("the service's calc did not give the main path's bits")
        ch2 = svc.storage_value_three_factor("cancelled", sh, **kwargs)
        svc.start_pending(ch2)
        deadline = time.time() + 60
        while svc.calc_progress(ch2) < 0.3 and time.time() < deadline:
            time.sleep(0.001)
        svc.cancel_running(ch2)
        while (svc.calc_status(ch2) in (pkg.CalcStatus.PENDING, pkg.CalcStatus.RUNNING)
               and time.time() < deadline):
            time.sleep(0.001)
        log(f"service: the second calc after cancel_running: {svc.calc_status(ch2).name} at "
            f"progress {svc.calc_progress(ch2):.4f}")
        if svc.calc_status(ch2) != pkg.CalcStatus.CANCELLED:
            raise AssertionError(f"the cancelled calc ended {svc.calc_status(ch2)}")

    seeds = ((11, 13), (17, 19))

    def serial_pair():
        t0 = time.perf_counter()
        out = [value(pkg, device, True, num_sims=BIG_SIMS, seed=a, fwd_sim_seed=b)
               for a, b in seeds]
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    serial, serial_s = serial_pair()
    with pkg.ValuationJobEngine(num_threads=2) as engine:
        t0 = time.perf_counter()
        jobs = [engine.submit(lambda ctl, a=a, b=b: value(pkg, device, True, num_sims=BIG_SIMS,
                                                          seed=a, fwd_sim_seed=b))
                for a, b in seeds]
        results = [job.result() for job in jobs]
        torch.cuda.synchronize()
        together_s = time.perf_counter() - t0
    serial_again_s = serial_pair()[1]
    same = [same_bits(r, w) for r, w in zip(results, serial)]
    log(f"job engine (2 threads): two {BIG_SIMS}-sim valuations at once in {together_s:.4f} s, "
        f"one after the other in this thread {serial_s:.4f} s before and {serial_again_s:.4f} s "
        f"after; each its serial run's bits: {same}")
    if not all(same):
        raise AssertionError("a concurrent valuation parted from its serial run")
    report.update(job_engine_s=together_s, job_engine_serial_s=[serial_s, serial_again_s])
    return report


def cli_checks(pkg, device) -> dict:
    """``python3 -m storage_tpu_torch three-factor`` on the headline's model
    and curve at 262,144 sims (a facility that ends empty: JSON holds no
    terminal value) in a subprocess: exit 0, and its printed lines and CSVs
    those of the same CLI call in this process; beside it, started at the
    same time, a run that gets SIGINT once it prints its first progress
    (20%): exit 130, "cancelled".  Each progress print is timed as it
    arrives."""
    import io
    import os
    import signal

    from storage_tpu_torch import cli

    storage, start, fwd = bench_case(pkg)
    folder = OUT / "cli"
    folder.mkdir(parents=True, exist_ok=True)
    specs = {
        "facility": {"freq": "D", "start": str(start), "end": str(storage.end),
                     "injection_cost": 0.9, "withdrawal_cost": 0.7,
                     "ratchets": [[str(start), [[0, -200, 300], [2500, -250, 250],
                                                [5000, -300, 200]]]],
                     "ratchet_interp": "linear"},
        "market": {"val_date": str(start), "inventory": 100.0, "interest_rate": 0.02,
                   "fwd": {str(p): float(v) for p, v in fwd.items()}},
        "model": {"spot_mean_reversion": 14.5, "spot_vol": 1.1, "long_term_vol": 0.19,
                  "seasonal_vol": 0.23, "num_sims": NUM_SIMS, "seed": 11, "basis_funcs": BASIS},
    }
    for name, spec in specs.items():
        (folder / f"{name}.json").write_text(json.dumps(spec))
    args = ["three-factor", *(str(folder / f"{n}.json") for n in ("facility", "market", "model"))]
    cmd = [sys.executable, "-m", "storage_tpu_torch", *args, "--device", device.type]

    def run(extra, signal_at=None):
        """The CLI in a subprocess, its stderr read as it comes: (exit code,
        stdout, stderr, seconds from the start to each progress fraction's
        first print and to "cancelled", seconds from start to exit).  With
        ``signal_at`` (a fraction) it gets SIGINT once that fraction is
        printed; the times are then from the signal."""
        t0 = time.perf_counter()
        proc = subprocess.Popen([*cmd, *extra], cwd=REPO, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE)
        err, seen, t_sig = b"", {}, None
        try:
            while True:
                chunk = os.read(proc.stderr.fileno(), 4096)
                if not chunk:
                    break
                err += chunk
                now = time.perf_counter() - t0
                for token in err.decode(errors="replace").replace("\n", "\r").split("\r"):
                    if "cancelled" in token:  # printed after the last progress, no newline
                        seen.setdefault("cancelled", now)
                    elif token.strip().endswith("%") and "valuing:" in token:
                        seen.setdefault(token.split("valuing:")[-1].strip(), now)
                if signal_at is not None and t_sig is None and signal_at in seen:
                    proc.send_signal(signal.SIGINT)
                    t_sig = time.perf_counter() - t0
            out = proc.communicate(timeout=300)[0]
            total = time.perf_counter() - t0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if t_sig is not None:  # times from the signal, of what came after it
            seen = {k: v - t_sig for k, v in seen.items() if v > t_sig}
            total -= t_sig
        return (proc.returncode, out.decode(), err.decode(errors="replace"),
                {k: round(v, 4) for k, v in seen.items()}, total)

    # The two processes start together: each spends most of its time
    # starting up on the host, so side by side they take little more than one.
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        full = pool.submit(run, ["--out", str(folder / "subprocess")])
        stopped = pool.submit(run, [], "20.0%")
        code, out, err, timeline, sub_s = full.result()
        sig_code, sig_out, sig_err, after, stop_s = stopped.result()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed), contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main([*args, "--device", device.type, "--out", str(folder / "in_process")])
    csvs = sorted(p.name for p in (folder / "in_process").glob("*.csv"))
    same_csvs = bool(csvs) and all(
        (folder / "subprocess" / n).read_bytes() == (folder / "in_process" / n).read_bytes()
        for n in csvs)
    marks = {k: v for k, v in timeline.items() if k in ("20.0%", "30.0%", "70.0%", "90.0%",
                                                        "100.0%")}
    log(f"CLI three-factor subprocess: exit {code} in {sub_s:.2f} s (progress printed at "
        f"{marks} s from the start); printed {out.split()[:2]}; the in-process call's lines: "
        f"{out == printed.getvalue()}, its CSVs {csvs}: {same_csvs}")
    if code != 0 or rc != 0 or out != printed.getvalue() or not same_csvs:
        raise AssertionError(f"the CLI run failed or parted from the in-process call:\n"
                             f"{err[-4000:]}")

    log(f"CLI three-factor with SIGINT once it printed 20% (run beside the first): after the "
        f"signal, progress printed {after}, exit {sig_code} after {stop_s:.3f} s; no result: "
        f"{not sig_out.strip()}")
    if sig_code != 130 or "cancelled" not in sig_err or sig_out.strip():
        raise AssertionError(f"the SIGINT run ended {sig_code}:\n{sig_err[-4000:]}")
    return dict(subprocess_s=sub_s, progress_s=timeline, sigint_progress_s=after,
                sigint_exit_s=stop_s)


def service_phase(pkg, device, counts, main) -> dict:
    """The native host runtime, interactive execution, checkpoints and the
    service layer on the card at the headline."""
    report = {"band": band_checks(pkg, device)}
    report["interactive"] = interactive_checks(pkg, device, counts, main)
    report["checkpoint"] = checkpoint_checks(pkg, device, counts, main)
    report["service"] = service_checks(pkg, device, main)
    report["cli"] = cli_checks(pkg, device)
    return report


# ---- the streamed engine (paths regenerated a segment at a time, or user
# panels fed from host memory).

HOURLY_SIMS = (65_536, 393_216)


def segments(num_steps: int) -> int:
    """The engine's segments of a pass (``engines.lsmc.SEG_LEN`` steps each)."""
    from storage_tpu_torch.engines import lsmc as engine

    return -(-num_steps // engine.SEG_LEN)


def hourly_fwd(pkg):
    """The hourly year's facility and a curve with a yearly and a daily shape."""
    import numpy as np
    import pandas as pd

    storage, hour = hourly_case(pkg)
    idx = pd.period_range(hour, storage.end, freq="h")
    i = np.arange(len(idx))
    fwd = pd.Series(index=idx, data=30.0 + 6 * np.sin(2 * np.pi * i / HOURLY_STEPS)
                    + 2 * np.sin(2 * np.pi * i / 24))
    return storage, hour, fwd


def hourly_value(pkg, device, num_sims, **kwargs):
    """The hourly year through ``three_factor_seasonal_value`` (the
    headline's model, basis, grid and seeds)."""
    import torch

    storage, hour, fwd = hourly_fwd(pkg)
    return pkg.three_factor_seasonal_value(
        storage, hour, 100.0, fwd, 0.02, None, 14.5, 1.1, 0.19, 0.23, num_sims, BASIS, False,
        seed=11, fwd_sim_seed=13, num_inventory_grid_points=NUM_GRID, dtype=torch.float32,
        device=device, snap_interp=True, **kwargs)


def case_inputs(pkg, device, storage, start, fwd, freq):
    """A case's engine inputs built the way the API builds them: (valuation
    inputs, the OU tables by name, engine arrays, monomials)."""
    import numpy as np
    import torch

    from storage_tpu_torch.basis import parse_basis_functions
    from storage_tpu_torch.engines import lsmc as engine
    from storage_tpu_torch.models import multi_factor as mf
    from storage_tpu_torch.valuation_inputs import prepare_valuation

    inputs = prepare_valuation(storage, start, 100.0, fwd, 0.02, None)
    factors, corrs = mf.create_3_factor_seasonal_params(freq, 14.5, 1.1, 0.19, 0.23, start,
                                                        storage.end)
    pre = mf.simulation_precompute(factors, corrs, inputs.val_day, list(inputs.periods), freq)
    as_t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=device)  # noqa: E731
    sim_in = {k: as_t(getattr(pre, k)) for k in ("decay", "chol", "vols", "half_var")}
    sim_in["fwd"] = as_t(inputs.fwd)
    arrays = engine.build_engine_arrays(
        inputs.compiled, inputs.fwd, inputs.df_settle, inputs.df_flow,
        inputs.inventory_lower, inputs.inventory_upper, NUM_GRID, torch.float32, device,
    )
    return inputs, sim_in, arrays, tuple(parse_basis_functions(BASIS))


def engine_pair(device, case, num_sims, adjoint=False):
    """The engine on one case two ways, at seeds 11/13 as the API draws them:
    ``materialised`` (both path sets simulated whole, then ``lsmc_core``) and
    ``streamed`` (``lsmc_core_streamed``): name -> a callable giving its
    results."""
    import torch

    from storage_tpu_torch.engines import lsmc as engine
    from storage_tpu_torch.models import spot_sim

    inputs, sim_in, arrays, monomials = case
    ids = torch.arange(num_sims, dtype=torch.int64, device=device)
    keys = spot_sim.key_from_seed(11), spot_sim.key_from_seed(13)
    tfn = inputs.compiled.terminal_value
    common = (inputs.starting_inventory, monomials, 0, False, tfn, inputs.compiled.ratchet_is_step)
    tables = [sim_in[k] for k in ("decay", "chol", "vols", "half_var", "fwd")]

    def materialised():
        reg, val = (spot_sim.simulate_ou_paths(k, ids, *tables) for k in keys)
        return engine.lsmc_core(arrays, reg.spot, reg.factors, val.spot, val.factors, *common,
                                snap_interp=True, adjoint=adjoint)

    def streamed():
        return engine.lsmc_core_streamed(arrays, sim_in, *keys, ids, *common, snap_interp=True,
                                         adjoint=adjoint)

    return {"materialised": materialised, "streamed": streamed}


def measured(fn, counts):
    """``fn()`` with the launch counters reset just before it: (its results,
    launches, host seconds ended by a synchronize, peak device GB)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, counts.read(), wall, torch.cuda.max_memory_allocated() / 1e9


@contextlib.contextmanager
def pass_timers(times: dict):
    """Host seconds, inside the block, of the engine's three passes over a
    rows source, each ended by a synchronize: the warmup
    (``_stream_warmup``), the backward after it and the forward."""
    from unittest import mock

    import torch

    from storage_tpu_torch.engines import lsmc as engine

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[name] = times.get(name, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    with mock.patch.object(engine, "_stream_warmup", timed("warmup_s", engine._stream_warmup)), \
            mock.patch.object(engine, "lsmc_backward_rows",
                              timed("backward_s", engine.lsmc_backward_rows)), \
            mock.patch.object(engine, "lsmc_forward_rows",
                              timed("forward_s", engine.lsmc_forward_rows)):
        yield
    times["backward_s"] -= times.get("warmup_s", 0.0)  # the backward after its warmup


def engine_same_bits(got: dict, want: dict) -> list:
    """The result keys whose tensors differ (NaN equal to NaN)."""
    import torch

    return [k for k in want if k != "adjoint_tape"
            and not torch.equal(got[k].nan_to_num(), want[k].nan_to_num())]


def check_resumed_sweep(pkg, device, card) -> dict:
    """The simulation sweep resumed at a start step from the state entering
    it, at S=1,000 over F = 1, 2, 3, 8, odd and even start steps, with and
    without antithetic signs: against rows start.. of the sweep from step 0
    and against its plain version resumed alike, the same bits.  Then one
    16-step segment of the hourly year's tables resumed at step 4,381 from
    an entry state at 393,216 paths (what every segment of a streamed
    hourly valuation launches), timed beside its bound."""
    import torch

    from storage_tpu_torch.models import spot_sim
    from storage_tpu_torch.ops import rng_kernel

    checks = {}
    path_ids = torch.arange(1000, device=device) + 77
    for f in (1, 2, 3, 8):
        tables = sweep_tables(device, 11, f, seed=40 + f)
        for start in (5, 6):
            for antithetic in (False, True):
                ids = (path_ids // 2 if antithetic else path_ids).to(torch.int32)
                sign = (1.0 - 2.0 * (path_ids % 2)).float() if antithetic else None
                whole = rng_kernel.simulate_sweep((5, 7), ids, sign, *tables)
                x0 = whole[0][start - 1].contiguous()
                tail = [t[start:].contiguous() for t in tables]
                got = rng_kernel.simulate_sweep((5, 7), ids, sign, *tail, start, x0)
                plain = rng_kernel.simulate_sweep_plain((5, 7), ids, sign, *tail, start, x0)
                checks[f"F={f},start={start}{',antithetic' if antithetic else ''}"] = all(
                    torch.equal(g, w) and torch.equal(g, full[start:])
                    for g, w, full in zip(got, plain, whole))
    log("resumed simulation sweep at S=1,000 against the sweep from step 0 and its plain "
        "version resumed alike (tolerance: the same bits): " + "; ".join(
            f"{k}: {'same bits' if v else 'DIFFERS'}" for k, v in checks.items()))
    if not all(checks.values()):
        raise AssertionError(f"the resumed sweep parts from the sweep: "
                             f"{[k for k, v in checks.items() if not v]}")
    storage, hour, fwd = hourly_fwd(pkg)
    _, sim_in, _, _ = case_inputs(pkg, device, storage, hour, fwd, "h")
    c = torch.log(sim_in["fwd"]) - sim_in["half_var"]
    start, s = (HOURLY_STEPS // 2) | 1, HOURLY_SIMS[1]  # an odd step mid-year
    ids = torch.arange(s, dtype=torch.int32, device=device)
    key = spot_sim.key_from_seed(11)
    seg = [sim_in[k][start:start + 16].contiguous() for k in ("decay", "chol", "vols")]
    seg.append(c[start:start + 16].contiguous())
    x0 = 0.1 * torch.randn((3, s), device=device)
    ms = cuda_ms(lambda: rng_kernel.simulate_sweep(key, ids, None, *seg, start, x0), 20)
    num_bytes, unfused, ints = sweep_work(16, 3, s, antithetic=False)
    bnd = bound(num_bytes + 4.0 * 3 * s, 0.0, unfused, ints)  # and the entry state read
    log(f"resumed sweep, a 16-step segment of the hourly tables at step {start} [P=16, F=3, "
        f"S={s}]: {ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}) [{card}]")
    return dict(checks=checks, resumed_ms=ms, resumed_bound_ms=bnd["bound_ms"],
                resumed_bound_by=bnd["bound_by"])


def streaming_phase(pkg, device, counts, main, src, from_sims, card) -> dict:
    """The streamed engine: the resumed sweep (``check_resumed_sweep``); the
    headline through ``lsmc_core_streamed`` against ``lsmc_core`` on the
    materialised panels (the same bits, both the main path's NPV; walls in
    turns and peak device memory), and their adjoints (deltas within 1e-7 of
    the largest); ``value_from_sims`` on the round trip's source frames with
    the threshold lowered (host-fed: the device-resident run's bits); the
    hourly year at 65,536 paths streamed against materialised (the same
    bits; the materialised peak beside its footprint) and at 393,216 through
    the API, where the footprint selects streaming (its log line), within 3
    combined SE of the 65,536-path NPV."""
    import logging

    import numpy as np
    import torch

    from storage_tpu_torch.engines import lsmc as engine
    from storage_tpu_torch.parallel import mesh as pmesh

    report = {"resumed_sweep": check_resumed_sweep(pkg, device, card)}
    n_seg = segments(NUM_STEPS)

    # The headline, streamed and materialised, pricing then adjoint.
    storage, start, fwd = bench_case(pkg)
    headline = case_inputs(pkg, device, storage, start, fwd, "D")
    runs = {}
    for adjoint in (False, True):
        pair = engine_pair(device, headline, NUM_SIMS, adjoint=adjoint)
        for name in (("materialised", "streamed", "streamed", "materialised") if not adjoint
                     else ("materialised", "streamed")):
            out, launches, wall, peak = measured(pair[name], counts)
            key = (name, adjoint)
            runs.setdefault(key, dict(walls=[], peaks=[]))
            runs[key].update(out=out, launches=launches)
            runs[key]["walls"].append(wall)
            runs[key]["peaks"].append(peak)
    mat, st = runs[("materialised", False)], runs[("streamed", False)]
    differ = engine_same_bits(st["out"], mat["out"])
    npv_mat = float(mat["out"]["npv"])
    expect_st = counts.expect(simulate_sweep=3 * n_seg, decision_update_moments=NUM_STEPS,
                              forward_sweep=n_seg)
    expect_mat = counts.expect(simulate_sweep=2, decision_update_moments=NUM_STEPS,
                               forward_sweep=1)
    log(f"headline streamed (lsmc_core_streamed) against materialised (lsmc_core), seeds 11/13: "
        f"NPV {float(st['out']['npv'])!r} / {npv_mat!r}, SE "
        f"{float(st['out']['standard_error'])!r}; every output the same bits: {not differ} "
        f"{differ or ''}(tolerance: the same bits); the materialised NPV is the main path's "
        f"{main.npv!r}: {npv_mat == main.npv}; walls in turns (mat, str, str, mat) streamed "
        f"{[round(w, 4) for w in st['walls']]} s, materialised "
        f"{[round(w, 4) for w in mat['walls']]} s; peak device memory streamed "
        f"{max(st['peaks']):.2f} GB, materialised {max(mat['peaks']):.2f} GB; launches streamed "
        f"{st['launches']} [{card}]")
    if differ or npv_mat != main.npv:
        raise AssertionError(f"the streamed headline parts from the materialised one: {differ}")
    for name, run, want in (("streamed", st, expect_st), ("materialised", mat, expect_mat)):
        if run["launches"] != want:
            raise AssertionError(f"{name} headline launches {run['launches']}, expected {want}")
    adj_st, adj_mat = runs[("streamed", True)], runs[("materialised", True)]
    d_st = engine.adjoint_deltas(adj_st["out"].pop("adjoint_tape"))
    d_mat = engine.adjoint_deltas(adj_mat["out"].pop("adjoint_tape"))
    adj_err = float((d_st - d_mat).abs().max() / d_mat.abs().max())
    adj_same = not engine_same_bits(adj_st["out"], st["out"])
    log(f"headline adjoint, streamed against materialised: deltas max rel {adj_err:.3e} "
        f"(tolerance 1e-7), the same bits: {bool(torch.equal(d_st, d_mat))}; pricing outputs the "
        f"streamed pricing run's bits: {adj_same}; VJP launches "
        f"{adj_st['launches']['forward_sweep_vjp']} (a segment each) [{card}]")
    if not (adj_err <= 1e-7 and adj_same
            and adj_st["launches"]["forward_sweep_vjp"] == n_seg):
        raise AssertionError("the streamed adjoint parts from the materialised one")
    report["headline"] = dict(
        npv=npv_mat, same_bits=not differ, streamed_walls_s=st["walls"],
        materialised_walls_s=mat["walls"], streamed_peak_gb=max(st["peaks"]),
        materialised_peak_gb=max(mat["peaks"]), streamed_launches=st["launches"],
        adjoint_rel_err=adj_err, adjoint_same_bits=bool(torch.equal(d_st, d_mat)),
        adjoint_launches=adj_st["launches"])
    del runs, mat, st, adj_st, adj_mat

    # User panels fed from host memory, the threshold lowered below them.
    saved = pmesh.stream_threshold
    pmesh.stream_threshold = lambda device: 0
    try:
        host_fed, launches, wall, peak = measured(lambda: value_from_frames(
            pkg, device, src.sim_spot_regress, src.sim_spot_valuation, BASIS,
            sim_factors_regress=src.sim_factors_regress,
            sim_factors_valuation=src.sim_factors_valuation), counts)
    finally:
        pmesh.stream_threshold = saved
    same = (same_bits(host_fed, from_sims)
            and host_fed.trigger_prices.equals(from_sims.trigger_prices))
    expected = counts.expect(decision_update_moments=NUM_STEPS, forward_sweep=n_seg,
                             intrinsic_dp=1)
    log(f"value_from_sims host-fed (the round trip's source frames, threshold 0): NPV "
        f"{host_fed.npv!r} SE {host_fed.val_sim_standard_error!r}; NPV, SE, deltas, profile and "
        f"trigger prices the device-resident run's bits: {same} (tolerance: the same bits); wall "
        f"{wall:.3f} s, peak device memory {peak:.2f} GB; launches {launches} [{card}]")
    if not same or launches != expected:
        raise AssertionError(f"host-fed panels part from device-resident ones (launches "
                             f"{launches}, expected {expected})")
    report["host_fed"] = dict(npv=host_fed.npv, same_bits=same, wall_s=wall, peak_gb=peak,
                              launches=launches)

    # The hourly year: both routes at 65,536 paths, then 393,216 by footprint.
    storage, hour, fwd = hourly_fwd(pkg)
    hourly = case_inputs(pkg, device, storage, hour, fwd, "h")
    n_h = segments(HOURLY_STEPS)
    pair = engine_pair(device, hourly, HOURLY_SIMS[0])
    passes = {"streamed_65k": {}, "materialised_65k": {}, "streamed_393k": {}}
    with pass_timers(passes["streamed_65k"]):
        out_st, l_st, w_st, p_st = measured(pair["streamed"], counts)
    with pass_timers(passes["materialised_65k"]):
        out_mat, l_mat, w_mat, p_mat = measured(pair["materialised"], counts)
    differ = engine_same_bits(out_st, out_mat)
    footprint = pmesh.footprint_bytes(HOURLY_STEPS, HOURLY_SIMS[0], 3, NUM_GRID, 4) / 1e9
    npv_65k, se_65k = float(out_st["npv"]), float(out_st["standard_error"])
    log(f"hourly year [{HOURLY_STEPS} x {HOURLY_SIMS[0]} x {NUM_GRID}] streamed against "
        f"materialised: NPV {npv_65k!r} SE {se_65k!r}; every output the same bits: {not differ} "
        f"{differ or ''}(tolerance: the same bits); walls streamed {w_st:.3f} s, materialised "
        f"{w_mat:.3f} s; peak device memory streamed {p_st:.2f} GB, materialised {p_mat:.2f} GB "
        f"against its footprint {footprint:.2f} GB (ratio {p_mat / footprint:.3f}); launches "
        f"streamed {l_st} [{card}]")
    if differ or l_st != counts.expect(
            simulate_sweep=3 * n_h, decision_update_moments=HOURLY_STEPS, forward_sweep=n_h) \
            or l_mat != counts.expect(simulate_sweep=2, decision_update_moments=HOURLY_STEPS,
                                      forward_sweep=1):
        raise AssertionError(f"the streamed hourly year parts from the materialised one: {differ}")
    del out_st, out_mat, pair
    records = []
    handler = logging.Handler()
    handler.emit = lambda record: records.append(record.getMessage())
    api_logger = logging.getLogger("storage_tpu_torch.multi_factor")
    level = api_logger.level
    api_logger.addHandler(handler)
    api_logger.setLevel(logging.INFO)
    try:
        with pass_timers(passes["streamed_393k"]):
            big, l_big, w_big, p_big = measured(
                lambda: hourly_value(pkg, device, HOURLY_SIMS[1]), counts)
    finally:
        api_logger.removeHandler(handler)
        api_logger.setLevel(level)
    route = [r for r in records if r.startswith("LSMC execution")]
    combined = math.sqrt(big.val_sim_standard_error ** 2 + se_65k ** 2)
    z = (big.npv - npv_65k) / combined
    rate = HOURLY_SIMS[1] * HOURLY_STEPS / w_big
    materialised_gb = pmesh.footprint_bytes(HOURLY_STEPS, HOURLY_SIMS[1], 3, NUM_GRID, 4) / 1e9
    log(f"hourly year [{HOURLY_STEPS} x {HOURLY_SIMS[1]} x {NUM_GRID}] through the API: {route}; "
        f"NPV {big.npv!r} SE {big.val_sim_standard_error!r}, {z:+.3f} combined SE from the "
        f"{HOURLY_SIMS[0]:,}-path NPV (tolerance 3); wall {w_big:.3f} s = {rate:.1f} paths*steps/s; peak "
        f"device memory {p_big:.2f} GB (materialised it would need {materialised_gb:.1f} GB); "
        f"launches {l_big} [{card}]")
    deltas = big.deltas.to_numpy()
    if not (len(route) == 1 and "paths=streamed" in route[0] and abs(z) <= 3.0
            and np.isfinite(deltas).all() and deltas.shape == (HOURLY_STEPS + 1,)
            and l_big == counts.expect(simulate_sweep=3 * n_h,
                                       decision_update_moments=HOURLY_STEPS,
                                       forward_sweep=n_h, intrinsic_dp=1)):
        raise AssertionError("the 393,216-path hourly year did not stream to a sound result")
    log("hourly year, the engine's passes (host seconds, synchronized): " + "; ".join(
        f"{name}: " + ", ".join(f"{k[:-2]} {v:.3f}" for k, v in times.items())
        for name, times in passes.items()) + f" [{card}]")
    report["hourly"] = dict(
        npv_65k=npv_65k, se_65k=se_65k, same_bits=not differ, streamed_wall_s=w_st,
        materialised_wall_s=w_mat, streamed_peak_gb=p_st, materialised_peak_gb=p_mat,
        materialised_footprint_gb=footprint, npv_393k=big.npv, se_393k=big.val_sim_standard_error,
        z_combined=z, wall_393k_s=w_big, paths_steps_per_s=rate, peak_393k_gb=p_big,
        launches_393k=l_big, route=route[0], passes_s=passes)
    return report


def reg_case(pkg):
    """The 2F regression facility and market of tests/test_lsmc.py (the
    intrinsic pins'): (storage, valuation date, forward curve, rates,
    settlement rule)."""
    import pandas as pd

    storage = pkg.CmdtyStorage(
        "D", "2019-12-01", "2020-04-01", 1.23, 0.98, min_inventory=0.0, max_inventory=100_000.0,
        max_injection_rate=700.0, max_withdrawal_rate=700.0)
    val_date = "2019-08-29"
    idx = pd.period_range(val_date, "2020-04-01", freq="D")
    fwd = pd.Series([23.87 if p < pd.Period("2020-03-12", freq="D") else 150.32 for p in idx],
                    index=idx)
    rates = pd.Series(0.03, index=pd.period_range(val_date, "2020-06-01", freq="D"))

    def settle(period):
        return (period.asfreq("M").asfreq("D", "end") + 20).start_time.date()

    return storage, val_date, fwd, rates, settle


def empty_case(pkg):
    """The 40-day facility of tests/_torch_intrinsic_case.py that must end
    empty (3 linear ratchet nodes, fuel, loss, inventory cost) and its
    curve: (storage, valuation date, forward curve).  At E >= 1 its walk
    withdraws to a band bound and snaps there."""
    import numpy as np
    import pandas as pd

    start = pd.Period("2021-03-01", freq="D")
    storage = pkg.CmdtyStorage(
        "D", start, start + 40, 0.05, 0.03,
        ratchets=[(start, [(0.0, -150.0, 250.0), (1500.0, -220.0, 180.0),
                           (3000.0, -300.0, 120.0)])],
        ratchet_interp=pkg.RatchetInterp.LINEAR, cmdty_consumed_inject=0.01,
        cmdty_consumed_withdraw=0.005, inventory_loss=0.0005, inventory_cost=0.002)
    idx = pd.period_range(start, start + 40, freq="D")
    i = np.arange(len(idx))
    return storage, start, pd.Series(20.0 + 4.0 * np.sin(2 * np.pi * i / 17.0) + 0.3 * np.cos(i),
                                     index=idx)


def snapped_steps(result, starting_inventory) -> int:
    """Steps of an intrinsic forward walk whose inventory is not ``previous +
    decision - loss`` as rounded in its dtype: where it snapped to a band
    bound (``engines.intrinsic.snap_to_band``)."""
    import torch

    inv = result.inventory[:-1]
    prev = torch.cat([torch.full((1,), float(starting_inventory), dtype=inv.dtype,
                                 device=inv.device), inv[:-1]])
    return int((prev + result.inject_withdraw[:-1] - result.inventory_loss[:-1] != inv).sum())


def custom_grid(lower, upper):
    """A user grid for the custom-grid case: points bunched toward the lower
    bound, more of them on wider bands (rows padded to one width)."""
    import numpy as np

    if upper <= lower:
        return np.array([lower])
    return lower + (upper - lower) * np.linspace(0.0, 1.0, 60 + int((upper - lower) // 250.0)) ** 1.3


def intrinsic_case(pkg, device, case: str, scheme: str, g: int, grid_calc=None):
    """The DP's tables of the headline facility, the 2F pin facility or the
    40-day facility that must end empty (``case``) on ``device`` in f64 and
    f32, on linspace, fixed-spacing or custom rows (``grid_calc``'s, else
    ``custom_grid``'s): (valuation inputs, {dtype: arrays})."""
    import numpy as np
    import torch

    from storage_tpu_torch import grid as gridmod
    from storage_tpu_torch.engines import lsmc as engine
    from storage_tpu_torch.valuation_inputs import prepare_valuation

    if case == "headline":
        storage, start, fwd = bench_case(pkg)
        inputs = prepare_valuation(storage, start, 100.0, fwd, 0.02, None)
    elif case == "empty40":
        storage, start, fwd = empty_case(pkg)
        inputs = prepare_valuation(storage, start, 800.0, fwd, 0.03, None)
    else:
        storage, val_date, fwd, rates, settle = reg_case(pkg)
        inputs = prepare_valuation(storage, val_date, 0.0, fwd, rates, settle)
    lo, hi = inputs.inventory_lower, inputs.inventory_upper
    if scheme == "linspace":
        grids = gridmod.inventory_grids(lo, hi, g)
    elif scheme == "fixed_spacing":
        grids = gridmod.inventory_grids_fixed_spacing(
            lo, hi, float(np.min(inputs.compiled.min_inv)), float(np.max(inputs.compiled.max_inv)), g)
    else:
        grids = gridmod.inventory_grids_custom(lo, hi, grid_calc or custom_grid)
    arrays = {dt: engine.build_engine_arrays(inputs.compiled, inputs.fwd, inputs.df_settle,
                                             inputs.df_flow, lo, hi, g, dt, device, grids)
              for dt in (torch.float64, torch.float32)}
    return inputs, arrays


def compare_intrinsic(inputs, arrays, e: int, interpolation: str, uniform: bool,
                      must_snap: bool = False, f32: bool = True) -> dict:
    """The DP kernel in f64 and f32 against ``intrinsic_plain`` in f64 on the
    card.  f64: the NPV within 1e-10 relative and every profile column
    within 1e-6 absolute; a decision may differ only where the plain
    version's two best totals at that step lie within 1e-9 relative (at the
    first step where the paths part).  f32 (unless ``f32`` is False): the
    NPV within 1e-5 relative of the f64 answer.  ``must_snap``: the
    kernel's walk, f64 and f32, must snap to the band at least once
    (``snapped_steps``)."""
    import torch

    from storage_tpu_torch.engines import intrinsic as ie

    f64 = arrays[torch.float64]
    tfn = None if inputs.compiled.must_be_empty_at_end else inputs.compiled.terminal_value
    args = (inputs.starting_inventory, e, tfn, inputs.compiled.ratchet_is_step, interpolation,
            uniform)
    want = ie.intrinsic_plain(f64, *args)
    got = ie.intrinsic_core(f64, *args)
    got32 = ie.intrinsic_core(arrays[torch.float32], *args) if f32 else got
    npv = float(want.npv)
    rel64 = abs(float(got.npv) - npv) / abs(npv)
    rel32 = abs(float(got32.npv) - npv) / abs(npv) if f32 else 0.0
    prof_err = max(float((getattr(got, k) - getattr(want, k)).abs().max())
                   for k in ie.IntrinsicEngineResult._fields[1:])
    dec_g, dec_w = got.inject_withdraw, want.inject_withdraw
    parted = ((dec_g - dec_w).abs() > 1e-6 * dec_w.abs().clamp(min=1.0)).nonzero().flatten()
    flips, near = int(parted.numel()), True
    if flips:
        t = int(parted[0])
        vs, moments = ie.backward_values(f64, e, tfn, inputs.compiled.ratchet_is_step,
                                         interpolation, uniform)
        inv = want.inventory[t - 1:t] if t else torch.full_like(want.inventory[:1], args[0])
        total = ie.decision_totals(ie.step_tables(f64, t), inv, vs[t + 1], moments[t + 1], e,
                                   inputs.compiled.ratchet_is_step, interpolation, uniform)[0][0]
        top2 = total.topk(2).values
        near = bool(top2[0] - top2[1] <= 1e-9 * top2[0].abs())
    snaps = {"f64": snapped_steps(got, args[0]), "f32": snapped_steps(got32, args[0]),
             "plain_f64": snapped_steps(want, args[0])}
    ok = (rel64 <= 1e-10 and rel32 <= 1e-5 and (prof_err <= 1e-6 if not flips else near)
          and (not must_snap or min(snaps["f64"], snaps["f32"]) >= 1))
    return dict(ok=ok, npv_f64_plain=npv, npv_f64=float(got.npv), npv_f32=float(got32.npv),
                npv_rel_err_f64=rel64, npv_rel_err_f32=rel32, profile_max_abs_err_f64=prof_err,
                decision_flips_f64=flips, first_flip_on_near_tie=near, snapped_steps=snaps)


def intrinsic_work(n: int, g: int, r: int, d: int, itemsize: int) -> tuple:
    """(bytes, unfused operations) of one DP: each input read once (the step
    scalars [N, 11], ratchets [N, R] x 3, grids [N+1, G], terminal values
    [G]) and each output written once ([5N + 1]); the backward decides at
    (N-1)·G inventories and the forward at N, each over D decisions."""
    num_bytes = itemsize * (11 * n + 3 * n * r + (n + 1) * g + g + 5 * n + 1)
    ops = float((n - 1) * g + n) * (DP_OPS_PER_INVENTORY + r + d * DP_OPS_PER_DECISION)
    return num_bytes, ops


def check_intrinsic(pkg, device) -> dict:
    """The DP kernel against its plain version on the card in f64 and f32:
    the headline's tables (N=365, G=100, linear), the 2F facility on fixed
    spacing and with cubic interpolation, a custom grid, G=1,000, E=1, and
    the 40-day facility that must end empty on fixed spacing at E=1 and E=2
    (its walk must snap to the band in f64 and f32); its times (CUDA events, f32 and f64, at the headline and at G=1,000),
    its bound, its plain version's time and its launch report; then the
    pins through ``intrinsic_value(device="cuda")`` in f64."""
    import torch

    from storage_tpu_torch.engines import intrinsic as ie
    from storage_tpu_torch.ops import intrinsic_kernel, tree_kernel

    cases = {
        "headline": ("headline", "linspace", NUM_GRID, 0, "linear"),
        "2F_fixed_spacing": ("2F", "fixed_spacing", NUM_GRID, 0, "linear"),
        "2F_cubic": ("2F", "linspace", NUM_GRID, 0, "cubic"),
        "custom_grid": ("2F", "custom", NUM_GRID, 0, "linear"),
        "G=1000": ("headline", "linspace", BIG_GRID, 0, "linear"),
        "E=1": ("2F", "linspace", NUM_GRID, 1, "linear"),
        "empty_E=1": ("empty40", "fixed_spacing", 15, 1, "linear"),
        "empty_E=2": ("empty40", "fixed_spacing", 15, 2, "linear"),
    }
    checks, timing = {}, {}
    for name, (case, scheme, g, e, interpolation) in cases.items():
        inputs, arrays = intrinsic_case(pkg, device, case, scheme, g)
        uniform = scheme == "linspace"
        checks[name] = c = compare_intrinsic(inputs, arrays, e, interpolation, uniform,
                                             must_snap=case == "empty40")
        width = arrays[torch.float64]["grids"].shape[1]
        log(f"intrinsic DP [{name}: N={inputs.num_steps}, G={width}, E={e}, {interpolation}, "
            f"{scheme}]: f64 NPV {c['npv_f64']!r} vs plain {c['npv_f64_plain']!r} (rel "
            f"{c['npv_rel_err_f64']:.2e}, tolerance 1e-10), profile max abs err "
            f"{c['profile_max_abs_err_f64']:.2e} (tolerance 1e-6), {c['decision_flips_f64']} "
            f"decision flips (first on a near-tie: {c['first_flip_on_near_tie']}); f32 NPV "
            f"{c['npv_f32']!r} (rel {c['npv_rel_err_f32']:.2e}, tolerance 1e-5); walk snapped "
            f"to the band at {c['snapped_steps']} steps")
        if name in ("headline", "G=1000"):
            tfn = inputs.compiled.terminal_value
            n, r = inputs.num_steps, arrays[torch.float32]["ratchet_inv"].shape[1]
            row = {}
            for dt, label in ((torch.float32, "f32"), (torch.float64, "f64")):
                row[f"ms_{label}"] = cuda_ms(lambda: ie.intrinsic_core(arrays[dt], 100.0, 0, tfn,
                                                                       False), 20)
            for dt, label in ((torch.float32, "f32"), (torch.float64, "f64")):
                row[f"kernel_ms_{label}"] = busy_total_ms(
                    lambda: ie.intrinsic_core(arrays[dt], 100.0, 0, tfn, False),
                    "intrinsic_dp_kernel", lambda: intrinsic_kernel.intrinsic_dp.launches)[0]
            row["plain_ms"] = cuda_ms(lambda: ie.intrinsic_plain(arrays[torch.float32], 100.0, 0,
                                                                 tfn, False), 1)
            num_bytes, ops = intrinsic_work(n, g, r, 3, 4)
            row.update(bound(num_bytes, 0.0, ops))
            row["ms_per_step_f32"] = row["ms_f32"] / (2 * n - 1)
            row["launch"] = {label: intrinsic_kernel.intrinsic_info(dt, device, g, r, 0, "linear")
                             for dt, label in ((torch.float32, "f32"), (torch.float64, "f64"))}
            # The chain floor: 2N - 1 links of one block barrier and one read
            # of another thread's shared memory, at the DP's block size.
            row["chain_step_ns"] = tree_kernel.chain_step_ns(
                "block", device, row["launch"]["f32"]["threads"])
            row["chain_floor_ms"] = (2 * n - 1) * row["chain_step_ns"] / 1e6
            timing[name] = row
            log(f"intrinsic DP [{name}] times: {row['ms_f32']:.4f} ms f32, {row['ms_f64']:.4f} ms "
                f"f64 a DP through intrinsic_core (one launch; {row['ms_per_step_f32'] * 1e3:.3f} "
                f"us a step of the {2 * n - 1}-step chain in f32), of it the kernel's own device "
                f"time {ms_text(row['kernel_ms_f32'])} / {ms_text(row['kernel_ms_f64'])} ms; plain "
                f"{row['plain_ms']:.1f} ms (f32), bound {row['bound_ms']:.6f} ms "
                f"({row['bound_by']}), chain floor {row['chain_floor_ms']:.4f} ms ({2 * n - 1} x "
                f"{row['chain_step_ns']:.1f} ns)")
            log(f"intrinsic DP launch report at G={g}: " + "; ".join(
                f"{label}: one block of {r_['threads']} threads (step tables "
                f"{'staged' if r_['stage_table'] else 'read from device memory'}, "
                f"{r_['walk_lanes']} lanes a forward step, {r_['chunk']} steps staged a chunk), "
                f"{r_['registers']} registers, {r_['local_bytes']} bytes local (spills), "
                f"{r_['smem_bytes']} bytes shared, {r_['blocks_per_sm']} blocks/SM, G up to "
                f"{r_['max_grid']}" for label, r_ in row["launch"].items()))
        del arrays
    limits = {f"{label}_{mode}": intrinsic_kernel.intrinsic_info(dt, device, NUM_GRID, 3, 0,
                                                                 mode)["max_grid"]
              for dt, label in ((torch.float32, "f32"), (torch.float64, "f64"))
              for mode in ("linear", "general", "cubic")}
    log(f"intrinsic DP: the largest G in the block's shared memory (R=3, E=0): {limits}")
    if limits["f64_linear"] < 8_192:
        raise AssertionError(f"the intrinsic DP takes G up to {limits['f64_linear']} in f64 on "
                             f"linear rows, below 8,192")
    pins = check_pins(pkg, device)
    bad = [name for name, c in checks.items() if not c["ok"]]
    if bad:
        raise AssertionError(f"the intrinsic DP kernel disagrees with its plain version: {bad}")
    head = timing["headline"]
    return dict(max_abs_err=checks["headline"]["profile_max_abs_err_f64"], ms=head["ms_f32"],
                ms_f64=head["ms_f64"], ms_per_step=head["ms_per_step_f32"],
                kernel_ms=head["kernel_ms_f32"], chain_floor_ms=head["chain_floor_ms"],
                plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                big_grid=timing["G=1000"], checks=checks, launch=head["launch"],
                max_grid=limits, pins=pins)


def check_pins(pkg, device) -> dict:
    """The intrinsic pins through ``intrinsic_value(device="cuda")`` in f64:
    the 2F facility on linspace and fixed-spacing rows within 1e-9 relative,
    the C# sample within 1e-3."""
    import pandas as pd
    import torch

    storage, val_date, fwd, rates, settle = reg_case(pkg)
    got = {}
    for scheme, pin in (("linspace", PIN_LINSPACE), ("fixed_spacing", PIN_FIXED_SPACING)):
        got[scheme] = (pkg.intrinsic_value(storage, val_date, 0.0, fwd, rates, settle,
                                           dtype=torch.float64, grid_scheme=scheme,
                                           device=device).npv, pin, 1e-9)
    csharp = pkg.CmdtyStorage("D", "2019-09-01", "2019-10-01", 0.48, 0.74, min_inventory=0.0,
                              max_inventory=1100.74, max_injection_rate=5.26,
                              max_withdrawal_rate=14.74)
    idx = pd.period_range("2019-09-15", "2019-10-01", freq="D")
    step_curve = pd.Series([56.6 if p < pd.Period("2019-09-23", freq="D") else 144.41 for p in idx],
                           index=idx)
    got["csharp"] = (pkg.intrinsic_value(csharp, "2019-09-15", 50.0, step_curve, 0.0, None,
                                         num_inventory_grid_points=101, dtype=torch.float64,
                                         device=device).npv, PIN_CSHARP, 1e-3)
    log("intrinsic pins, intrinsic_value(device='cuda', f64): " + "; ".join(
        f"{name} {npv!r} vs {pin!r} (rel {abs(npv - pin) / pin:.2e}, tolerance {tol:g})"
        for name, (npv, pin, tol) in got.items()))
    bad = [name for name, (npv, pin, tol) in got.items() if not abs(npv - pin) <= tol * pin]
    if bad:
        raise AssertionError(f"intrinsic pins missed: {bad}")
    return {name: dict(npv=npv, pin=pin, rel_err=abs(npv - pin) / pin)
            for name, (npv, pin, _) in got.items()}


# The trinomial tree (T1-T4 of PERF.md section 4).
TREE_PIN = 24_799.09  # the reference's C# trinomial sample (tests/test_reference_goldens.py:352)
TREE_ORACLE_SIMS = 65_536


def csharp_tree_case(pkg) -> dict:
    """T1: the reference's C# trinomial sample (tests/test_reference_goldens.py:
    268-352): 16 daily steps, ratchets, a = 5.5, G = 101."""
    import pandas as pd

    ratchets = [
        ("2019-09-01", [(0.0, -44.85, 56.8), (100.0, -45.01, 54.5), (300.0, -45.78, 52.01),
                        (600.0, -46.17, 51.9), (800.0, -46.99, 50.8), (1000.0, -47.12, 50.01)]),
        ("2019-09-20", [(0.0, -31.41, 48.33), (100.0, -31.85, 43.05), (300.0, -31.68, 41.22),
                        (600.0, -32.78, 40.08), (800.0, -33.05, 39.74), (1000.0, -34.80, 38.51)]),
    ]
    storage = pkg.CmdtyStorage("D", "2019-09-01", "2019-10-01", 0.48, 0.74, ratchets=ratchets,
                               ratchet_interp=pkg.RatchetInterp.LINEAR)
    idx = pd.period_range("2019-09-15", "2019-10-01", freq="D")
    fwd = pd.Series([56.6 if p <= pd.Period("2019-09-22", freq="D") else 56.6 + 87.81 for p in idx],
                    index=idx)
    vols = pd.Series([0.975, 0.97, 0.96, 0.91, 0.89, 0.895, 0.891, 0.89, 0.875, 0.872, 0.871,
                      0.870, 0.869, 0.868, 0.867, 0.866, 0.8655], index=idx)
    return dict(storage=storage, val_date="2019-09-15", inventory=50.0, fwd=fwd, vols=vols,
                a=5.5, rates=0.025, settle=lambda period: pd.Timestamp("2019-10-20").date(),
                g=101)


def oracle_tree_case(pkg, ratcheted: bool) -> dict:
    """T2: the LSMC-against-tree oracle facilities (tests/test_tree_oracles.py:
    44-126): 216 daily steps, a = 12.5, spot vol 0.95, G = 500."""
    import numpy as np
    import pandas as pd

    start, end, val_date = "2019-08-03", "2020-04-01", "2019-08-29"
    if ratcheted:
        storage = pkg.CmdtyStorage("D", start, end, 1.25, 0.93, ratchets=[
            (start, [(0.0, -702.7, 650.0), (15_000.0, -785.0, 552.5), (30_000.0, -790.6, 512.8),
                     (40_000.0, -825.6, 498.6), (52_500.0, -850.4, 480.0)]),
            ("2020-02-01", [(0.0, -645.35, 650.0), (13_000.0, -656.0, 552.5),
                            (28_000.0, -689.6, 512.8), (42_000.0, -701.06, 498.6),
                            (52_500.0, -718.04, 480.0)]),
        ], ratchet_interp=pkg.RatchetInterp.LINEAR)
    else:
        storage = pkg.CmdtyStorage("D", start, end, 1.25, 0.93, min_inventory=0.0,
                                   max_inventory=52_500.0, max_injection_rate=625.0,
                                   max_withdrawal_rate=850.0)
    idx = pd.period_range(val_date, end, freq="D")
    fwd = pd.Series(53.5 + np.sin(2 * np.pi / 365.0 * np.arange(len(idx))) * 24.6, index=idx)

    def settle(period):
        return (period.asfreq("M").asfreq("D", "end") + 20).start_time.date()

    return dict(storage=storage, val_date=val_date, inventory=5_685.0, fwd=fwd,
                vols=pd.Series(0.95, index=idx), a=12.5, rates=0.055, settle=settle, g=500)


def headline_tree_case(pkg, a: float) -> dict:
    """T3 (a = 5.5) and T4 (a = 1.5, the widest lattice that builds): the
    headline facility (365 daily steps, ratchets, terminal price·inventory)
    on a 1-factor tree with flat spot vol 0.95, G = 100."""
    import pandas as pd

    storage, start, fwd = bench_case(pkg)
    return dict(storage=storage, val_date=start, inventory=100.0, fwd=fwd,
                vols=pd.Series(0.95, index=fwd.index), a=a, rates=0.02, settle=None, g=NUM_GRID)


def wide_tree_case(pkg) -> dict:
    """T5: T1's sample (16 steps, M = 99) at G = 2,000: a slab whose rows,
    ev and step tables the cluster's shared memory cannot hold, so the tree
    kernel takes its large-slab route."""
    return dict(csharp_tree_case(pkg), g=2_000)


def tree_phases(pkg, case: dict, device, dtype) -> dict:
    """One ``trinomial_value`` call split into its host phases, host clock,
    the device synchronised at the end of each: the valuation inputs
    (``prepare_valuation``), the lattice (``build_tree``), the tables (the
    grids, the engine arrays and the lattice tensors on the card), the
    kernel (``tree_core``: the terminal values, the DP, the NPV's reduce)
    and the rest (the NPV read back, the API's own checks)."""
    import collections
    from unittest import mock

    import torch

    from storage_tpu_torch import api
    from storage_tpu_torch import grid as gridmod
    from storage_tpu_torch.engines import lsmc as engine
    from storage_tpu_torch.engines import tree as te
    from storage_tpu_torch.models import trinomial_tree as tt

    spans = collections.defaultdict(float)

    def timed(label, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spans[label] += time.perf_counter() - t0
            return out
        return run

    phases = ((api, "prepare_valuation", "inputs"), (tt, "build_tree", "lattice"),
              (gridmod, "inventory_grids", "tables"), (engine, "build_engine_arrays", "tables"),
              (te, "tree_arrays", "tables"), (te, "tree_core", "kernel"))
    with contextlib.ExitStack() as stack:
        for module, name, label in phases:
            stack.enter_context(mock.patch.object(module, name, timed(label, getattr(module, name))))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree_value(pkg, case, device, dtype)
        wall = time.perf_counter() - t0
    out = {f"{label}_s": spans[label] for label in ("inputs", "lattice", "tables", "kernel")}
    out.update(rest_s=wall - sum(spans.values()), wall_s=wall)
    return out


def tree_steps(case: dict) -> int:
    """The DP's steps: the active window from the valuation date (or the
    facility's start) to its end."""
    import pandas as pd

    storage = case["storage"]
    return (storage.end - max(pd.Period(case["val_date"], freq="D"), storage.start)).n


def tree_value(pkg, case: dict, device, dtype, **kwargs) -> float:
    """``trinomial_value`` of a tree case."""
    return pkg.trinomial_value(case["storage"], case["val_date"], case["inventory"], case["fwd"],
                               case["vols"], case["a"], 1 / 365.0, case["rates"], case["settle"],
                               num_inventory_grid_points=case["g"], dtype=dtype, device=device,
                               **kwargs)


def tree_tables(pkg, device, case: dict, grid_calc=None):
    """A tree case's DP tables on ``device`` in f64 and f32, as
    ``trinomial_value`` builds them: (valuation inputs, {dtype: (arrays,
    lattice)}, uniform rows)."""
    import numpy as np
    import torch

    from storage_tpu_torch import grid as gridmod
    from storage_tpu_torch.engines import lsmc as engine
    from storage_tpu_torch.engines import tree as te
    from storage_tpu_torch.models import trinomial_tree as tt
    from storage_tpu_torch.utils import periods as pu
    from storage_tpu_torch.valuation_inputs import prepare_valuation

    inputs = prepare_valuation(case["storage"], case["val_date"], case["inventory"], case["fwd"],
                               case["rates"], case["settle"])
    val_period = pu.to_period(case["val_date"], "D")
    horizon = pu.period_index(val_period, case["storage"].end)
    tree = tt.build_tree(case["fwd"].reindex(horizon).to_numpy(np.float64),
                         case["vols"].reindex(horizon).to_numpy(np.float64), case["a"], 1 / 365.0)
    offset = pu.period_offset(inputs.periods[0], val_period)
    lo, hi = inputs.inventory_lower, inputs.inventory_upper
    grids = (gridmod.inventory_grids(lo, hi, case["g"]) if grid_calc is None
             else gridmod.inventory_grids_custom(lo, hi, grid_calc))
    tables = {dt: (engine.build_engine_arrays(inputs.compiled, inputs.fwd, inputs.df_settle,
                                              inputs.df_flow, lo, hi, case["g"], dt, device, grids),
                   te.tree_arrays(tree, offset, inputs.num_steps, dt, device))
              for dt in (torch.float64, torch.float32)}
    return inputs, tables, gridmod.rows_uniform(grids)


def compare_tree(inputs, tables, e: int, interpolation: str, uniform: bool,
                 f32: bool = True) -> dict:
    """The tree DP kernel in f64 and f32 (unless ``f32`` is False) against
    ``tree_plain`` in f64 on the card.  f64: the NPV within 1e-10 relative and every value within 1e-9
    of its row's scale (the largest magnitude of its (t, node) row, at least
    1); along the centre, up and down branch paths the decisions read from
    the kernel's values may differ from those read from the plain version's
    only where the plain version's two best totals at that step lie within
    1e-9 relative (at the first step where the paths part).  f32: the NPV
    within 1e-5 relative of the f64 answer.  Where the slab takes the
    cluster route, the large-slab route must give its values' bits in f64
    and f32."""
    import torch

    from storage_tpu_torch.engines import tree as te
    from storage_tpu_torch.ops import tree_kernel

    arrays, lattice = tables[torch.float64]
    tfn = None if inputs.compiled.must_be_empty_at_end else inputs.compiled.terminal_value
    args = (e, tfn, inputs.compiled.ratchet_is_step, interpolation, uniform)
    want = te.tree_plain(arrays, lattice, *args)
    got = te.tree_core(arrays, lattice, *args)
    got32 = te.tree_core(*tables[torch.float32], *args) if f32 else got
    m, w = lattice["band"].shape[1:]
    g, r = arrays["grids"].shape[1], arrays["ratchet_inv"].shape[1]
    mode = "cubic" if interpolation == "cubic" else "linear" if uniform else "general"
    route = tree_kernel.kernel_info(g, torch.float64, mode, got.values.device, m, w, e)["route"]
    steps_same = None
    if route == "cluster":
        steps_same = all(
            torch.equal(te.tree_core(*tables[dt], *args, route="steps").values, res.values)
            for dt, res in ((torch.float64, got), (torch.float32, got32)))
    npv = float(want.npv)
    rel64 = abs(float(got.npv) - npv) / abs(npv)
    rel32 = abs(float(got32.npv) - npv) / abs(npv) if f32 else 0.0
    scale = want.values.abs().amax(dim=-1).clamp(min=1.0)
    values_err = float(((got.values - want.values).abs().amax(dim=-1) / scale).max())
    n = inputs.num_steps
    flips, near = 0, True
    for branch in (1, 2, 0):
        path = [branch] * n
        sims = [te.simulate_tree_decisions(arrays, lattice, r.values, path,
                                           inputs.starting_inventory, *args) for r in (got, want)]
        dec_g, dec_w = sims[0].decisions, sims[1].decisions
        parted = ((dec_g - dec_w).abs() > 1e-6 * dec_w.abs().clamp(min=1.0)).nonzero().flatten()
        if parted.numel():
            flips += 1
            t = int(parted[0])
            inv = (sims[1].inventory[t - 1:t] if t else
                   torch.full_like(sims[1].inventory[:1], inputs.starting_inventory))
            total = te.node_totals(arrays, lattice, want.values, t, int(sims[1].node_path[t]), inv,
                                   e, inputs.compiled.ratchet_is_step, interpolation, uniform)[0][0]
            top2 = total.topk(2).values
            near &= bool(top2[0] - top2[1] <= 1e-9 * top2[0].abs())
    ok = (rel64 <= 1e-10 and values_err <= 1e-9 and rel32 <= 1e-5 and near
          and steps_same is not False)
    return dict(ok=ok, npv_f64_plain=npv, npv_f64=float(got.npv), npv_f32=float(got32.npv),
                npv_rel_err_f64=rel64, npv_rel_err_f32=rel32, values_rel_err_f64=values_err,
                values_max_abs_err_f64=float((got.values - want.values).abs().max()),
                paths_parted=flips, first_parting_on_near_tie=near, route=route,
                steps_route_same_bits=steps_same)


def tree_work(n: int, m: int, g: int, w: int, r: int, d: int, itemsize: int) -> tuple:
    """(bytes, unfused operations) of one tree DP (linear interpolation):
    each input read once (step scalars [N, 11], ratchets [N, R] x 3, grids
    [N+1, G], spot [N+1, M], band [N, M, W] and its int64 first columns
    [N, M], terminal values [M, G]) and the values [N+1, M, G] written once;
    each of the N·M rows sums its band (2·W·G) and decides at G inventories
    over D decisions (``intrinsic_work``'s counts)."""
    num_bytes = (itemsize * (11 * n + 3 * n * r + (n + 1) * g + (n + 1) * m + n * m * w + m * g
                             + (n + 1) * m * g) + 8 * n * m)
    ops = float(n * m) * (2 * w * g + g * (DP_OPS_PER_INVENTORY + r + d * DP_OPS_PER_DECISION))
    return num_bytes, ops


def tree_table_work(n: int, m: int, g: int, w: int, r: int, d: int, itemsize: int) -> tuple:
    """(bytes, unfused operations) of one tree DP in the table form, the
    work any design must do: ``tree_work``'s bytes; one table column a step
    and grid point (``intrinsic_work``'s count a grid point), then each of
    the N·M·G cells sums its band once (2·W) and values D decisions from
    their table entries (``DP_OPS_PER_ENTRY``)."""
    num_bytes = tree_work(n, m, g, w, r, d, itemsize)[0]
    ops = (float(n * g) * (DP_OPS_PER_INVENTORY + r + d * DP_OPS_PER_DECISION)
           + float(n * m * g) * (2 * w + d * DP_OPS_PER_ENTRY))
    return num_bytes, ops


PROFILE_TRIES = 5


def kernel_busy_ms(fn, name: str, expected=None, counter=None) -> tuple:
    """(device ms, launches) of the kernels whose name holds ``name`` in one
    call of ``fn`` under torch.profiler: the kernels' own time, without the
    gaps between launches.  Late in a long process CUPTI can drop a share of
    a session's kernel records (11 of 20 launches seen, or none), so the call
    is profiled again, up to ``PROFILE_TRIES`` sessions, until one sees the
    ``expected`` launches (or as many as ``counter``, a wrapper's launch
    count, rose by in the warm-up call; with neither, any launch), and the
    session that saw the most is returned."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    before = counter() if counter is not None else 0
    fn()
    torch.cuda.synchronize()
    if counter is not None:
        expected = counter() - before
    best = (0.0, 0)
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and name in e.key]
        seen = sum(e.count for e in events)
        if seen > best[1]:
            best = (sum(e.self_device_time_total for e in events) / 1e3, seen)
        if seen and seen >= (expected or 1):
            break
    return best


def graph_launch_ms(call, repeats: int) -> float:
    """Device milliseconds a launch of ``call`` takes, by CUDA events around
    replays of a CUDA graph of ``repeats`` calls: no host time between the
    launches, but each graph node's own overhead on top of the kernel's."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(repeats):
            call()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (5 * repeats)
    del graph
    torch.cuda.empty_cache()
    return ms


def own_launch_ms(call, name: str, repeats: int) -> tuple:
    """(ms a launch, source, launches profiled) of ``call``'s kernel: its own
    device time under torch.profiler over ``repeats`` calls
    (``kernel_busy_ms``), or, where no session saw a launch of it, a CUDA
    graph's replays (``graph_launch_ms``), which the source names."""
    own, seen = kernel_busy_ms(lambda: [call() for _ in range(repeats)], name, expected=repeats)
    if seen:
        return own / seen, "profiler", seen
    return graph_launch_ms(call, repeats), "cuda graph", 0


def busy_total_ms(fn, name: str, counter) -> tuple:
    """(ms, launches profiled) of every launch of ``name`` in one call of
    ``fn``, by own device time (``kernel_busy_ms``; ``counter`` counts the
    launches): where no session saw them all, the mean of those seen times
    the count, and where none saw any, None ("not measured")."""
    import torch

    before = counter()
    fn()
    torch.cuda.synchronize()
    expected = counter() - before
    own, seen = kernel_busy_ms(fn, name, expected=expected)
    if not seen:
        return None, 0
    return own * expected / seen, seen


def ms_text(ms, digits: int = 4) -> str:
    """A time in ms to ``digits`` places, or "not measured" for None."""
    return "not measured" if ms is None else f"{ms:.{digits}f}"


def api_walls(fn, count: int) -> list:
    """Host seconds of ``count`` calls of ``fn`` (each reads its result back)."""
    walls = []
    for _ in range(count):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return walls


def check_tree(pkg, device, counts) -> dict:
    """T4's lattice timed on the host.  The tree DP kernel against
    ``tree_plain`` on the card in f64 and f32 (``compare_tree``) on T1-T4,
    T2's simple facility with cubic interpolation and with a custom grid,
    T3 at E=1 (each on the cluster route, whose bits the large-slab route
    must give too) and T5 (a slab beyond the cluster: the large-slab route);
    its times (CUDA events, f32 and f64, at T3 and T4, beside the large-slab
    route's on the same tables; the kernels' own device time under the
    profiler; T5), bound, chain floor, plain time and launch reports.  Then
    the paths through the API, each with the launch counters reset just
    before it: T1's pin (24,799.09 within 5e-4, f64), T2's LSMC-against-tree
    gate (the port's 1-factor ``multi_factor_value`` on the card, f32,
    65,536 sims, seeds 11/22, basis 1 + s + s² + s³, within 3e-3 of the f64
    tree), T3's ``trinomial_value`` (median of 5 warm calls, f32 and f64; T4
    one; T3's host phases), T5's (the large-slab route, a launch a step)
    and T3's ``trinomial_deltas`` over its 12 monthly contracts (24
    valuations).  Every ``trinomial_value`` on the cluster route launches
    the kernel once and no other kernel of the port."""
    import numpy as np
    import pandas as pd
    import torch

    from storage_tpu_torch.engines import tree as te
    from storage_tpu_torch.ops import tree_kernel

    from storage_tpu_torch.models import trinomial_tree as tt

    t1, t3, t4 = csharp_tree_case(pkg), headline_tree_case(pkg, 5.5), headline_tree_case(pkg, 1.5)
    t5 = wide_tree_case(pkg)
    t2 = {name: oracle_tree_case(pkg, name == "ratcheted") for name in ("simple", "ratcheted")}
    t_checks = time.perf_counter()
    # The lattice on the host at T4: build_tree (its transition a broadcast
    # view), and the [N, M, M] copy the JAX package makes of it.
    lattice_s = {}
    for _ in range(3):
        t0 = time.perf_counter()
        tree = tt.build_tree(t4["fwd"].to_numpy(), t4["vols"].to_numpy(), t4["a"], 1 / 365.0)
        t_view = time.perf_counter()
        copy = np.array(tree.transition)
        lattice_s = dict(build_tree_s=t_view - t0, copy_s=time.perf_counter() - t_view,
                         copy_bytes=copy.nbytes)
        del tree, copy
    log(f"T4 lattice on the host: build_tree {lattice_s['build_tree_s']:.4f} s (transition a "
        f"broadcast view); the JAX package's copy of it {lattice_s['copy_s']:.4f} s more, "
        f"{lattice_s['copy_bytes'] / 1e6:.1f} MB (the third of three runs)")
    cases = {  # name: (case, E, interpolation, grid_calc)
        "T1": (t1, 0, "linear", None),
        "T2_simple": (t2["simple"], 0, "linear", None),
        "T2_ratcheted": (t2["ratcheted"], 0, "linear", None),
        "T3": (t3, 0, "linear", None),
        "T4": (t4, 0, "linear", None),
        "T2_cubic": (t2["simple"], 0, "cubic", None),
        "T2_custom_grid": (t2["simple"], 0, "linear", custom_grid),
        "T3_E=1": (t3, 1, "linear", None),
        "T5": (t5, 0, "linear", None),
    }
    checks, timing = {}, {}
    for name, (case, e, interpolation, grid_calc) in cases.items():
        inputs, tables, uniform = tree_tables(pkg, device, case, grid_calc)
        checks[name] = c = compare_tree(inputs, tables, e, interpolation, uniform)
        arrays, lattice = tables[torch.float32]
        n, g = inputs.num_steps, arrays["grids"].shape[1]
        m, w = lattice["band"].shape[1:]
        r = arrays["ratchet_inv"].shape[1]
        log(f"tree DP [{name}: N={n}, M={m}, W={w}, G={g}, E={e}, {interpolation}, "
            f"{'uniform' if uniform else 'custom'} rows; {c['route']} route]: f64 NPV "
            f"{c['npv_f64']!r} vs plain {c['npv_f64_plain']!r} (rel {c['npv_rel_err_f64']:.2e}, "
            f"tolerance 1e-10), values {c['values_rel_err_f64']:.2e} of their rows' scale "
            f"(tolerance 1e-9), {c['paths_parted']} of 3 branch paths parted (first on a near-tie: "
            f"{c['first_parting_on_near_tie']}); f32 NPV {c['npv_f32']!r} (rel "
            f"{c['npv_rel_err_f32']:.2e}, tolerance 1e-5); the large-slab route's values the "
            f"same bits: {c['steps_route_same_bits']}")
        if name in ("T3", "T4", "T5"):
            tfn = inputs.compiled.terminal_value
            row = {}
            for dt, label in ((torch.float32, "f32"), (torch.float64, "f64")):
                arrays_dt, lattice_dt = tables[dt]
                run = lambda route=None: te.tree_core(arrays_dt, lattice_dt, 0, tfn, False,  # noqa: E731
                                                      route=route)
                row[f"ms_{label}"] = cuda_ms(run, 10)
                row[f"kernel_busy_ms_{label}"], row[f"profiled_launches_{label}"] = busy_total_ms(
                    run, "tree_", lambda: (tree_kernel.tree_dp.launches
                                           + tree_kernel.tree_dp.step_launches
                                           + tree_kernel.tree_dp.large_launches))
                if c["route"] == "cluster":
                    row[f"steps_route_ms_{label}"] = cuda_ms(lambda: run("steps"), 10)
            row["plain_ms"] = cuda_ms(lambda: te.tree_plain(arrays, lattice, 0, tfn, False), 1)
            num_bytes, ops = tree_work(n, m, g, w, r, 3, 4)
            row.update(bound(num_bytes, 0.0, ops))
            row["us_per_step_f32"] = 1e3 * row["ms_f32"] / n
            row["launch"] = {label: tree_kernel.kernel_info(g, dt, "linear", device, m, w)
                             for dt, label in ((torch.float32, "f32"), (torch.float64, "f64"))}
            row["route"] = c["route"]
            if c["route"] == "cluster":
                # The chain floor: N links of one cluster barrier and one
                # read of another CTA's shared memory, at the route's shape.
                f32 = row["launch"]["f32"]
                row["chain_step_ns"] = tree_kernel.chain_step_ns(
                    "cluster", device, f32["cluster_threads"], f32["cluster_size"])
                row["chain_floor_ms"] = n * row["chain_step_ns"] / 1e6
            timing[name] = row
            old = (f", the large-slab route {row['steps_route_ms_f32']:.4f} / "
                   f"{row['steps_route_ms_f64']:.4f} ms on the same tables"
                   if c["route"] == "cluster" else "")
            floor = (f", chain floor {row['chain_floor_ms']:.4f} ms ({n} x "
                     f"{row['chain_step_ns']:.1f} ns)" if c["route"] == "cluster" else "")
            log(f"tree DP [{name}] times ({c['route']} route): {row['ms_f32']:.4f} ms f32, "
                f"{row['ms_f64']:.4f} ms f64 a valuation ({row['us_per_step_f32']:.2f} us a step "
                f"in f32), of it the tree kernels' own device time "
                f"{ms_text(row['kernel_busy_ms_f32'])} ms f32 / "
                f"{ms_text(row['kernel_busy_ms_f64'])} ms f64 ({row['profiled_launches_f32']} "
                f"launches profiled){old}; plain {row['plain_ms']:.1f} ms (f32), bound "
                f"{row['bound_ms']:.6f} ms ({row['bound_by']}){floor}")
            log(f"tree DP launch report at {name}: " + "; ".join(
                f"{label}: route {r_['route']}; cluster of {r_['cluster_size']} CTAs of "
                f"{r_['cluster_threads']} threads, {r_['cluster_registers']} registers, "
                f"{r_['cluster_local_bytes']} bytes local (spills), {r_['cluster_smem_bytes']} "
                f"bytes shared a CTA, {r_['cluster_blocks_per_sm']} CTAs/SM, {r_['rows_per_cta']} "
                f"node rows a CTA, up to {r_['max_rows']} node rows at G={g}; "
                f"large-slab step kernel {r_['threads']} threads, {r_['registers']} registers, "
                f"{r_['local_bytes']} bytes local, {r_['smem_bytes']} bytes shared, "
                f"{r_['blocks_per_sm']} blocks/SM, G up to {r_['max_grid']}"
                for label, r_ in row["launch"].items()))
        del tables
    bad = [name for name, c in checks.items() if not c["ok"]]
    routes = {name: c["route"] for name, c in checks.items()}
    if routes != dict({name: "cluster" for name in checks}, T5="steps"):
        raise AssertionError(f"tree routes {routes}: T1-T4 take the cluster route, T5 the large "
                             f"slab")
    if bad:
        raise AssertionError(f"the tree DP kernel disagrees with its plain version: {bad}")
    checks_s = time.perf_counter() - t_checks
    t_paths = time.perf_counter()

    def on_path(expected, fn, route="tree_dp"):
        counts.reset()
        out = fn()
        torch.cuda.synchronize()
        launches = counts.read()
        if launches != counts.expect(**{route: expected}):
            raise AssertionError(f"tree path launches {launches}, expected {expected} of {route} "
                                 f"and no other kernel")
        return out, launches[route]

    paths = {}
    # T1: the C# sample's pin.
    npv, launches = on_path(1, lambda: tree_value(pkg, t1, device, torch.float64))
    paths["T1_pin"] = dict(npv=npv, pin=TREE_PIN, rel_err=abs(npv - TREE_PIN) / TREE_PIN,
                           launches=launches)
    log(f"tree pin, trinomial_value(device='cuda', f64) on T1: {npv!r} vs {TREE_PIN!r} (rel "
        f"{paths['T1_pin']['rel_err']:.2e}, tolerance 5e-4); {launches} tree launch(es)")
    if not paths["T1_pin"]["rel_err"] <= 5e-4:
        raise AssertionError(f"the trinomial pin missed: {npv} against {TREE_PIN}")
    # T2: the LSMC-against-tree oracle.
    for name, case in t2.items():
        tree_npv, launches = on_path(1, lambda: tree_value(pkg, case, device, torch.float64))
        counts.reset()
        lsmc = pkg.multi_factor_value(
            case["storage"], case["val_date"], case["inventory"], case["fwd"], case["rates"],
            case["settle"], [(case["a"], case["vols"])], None, TREE_ORACLE_SIMS,
            "1 + s + s**2 + s**3", False, seed=11, fwd_sim_seed=22, num_inventory_grid_points=100,
            dtype=torch.float32, device=device)
        torch.cuda.synchronize()
        lsmc_launches = counts.read()
        rel = abs(lsmc.npv - tree_npv) / tree_npv
        z = (lsmc.npv - tree_npv) / lsmc.val_sim_standard_error
        paths[f"T2_{name}"] = dict(tree_npv=tree_npv, lsmc_npv=lsmc.npv,
                                   lsmc_se=lsmc.val_sim_standard_error, rel=rel, z=z,
                                   tree_launches=launches, lsmc_launches=lsmc_launches)
        log(f"tree oracle T2 {name}: LSMC {lsmc.npv!r} (SE {lsmc.val_sim_standard_error!r}, f32, "
            f"{TREE_ORACLE_SIMS} sims) vs tree {tree_npv!r} (f64, G=500): rel {rel:.2e} "
            f"(tolerance 3e-3), z = {z:+.3f}; {launches} tree launch(es), the LSMC's "
            f"{lsmc_launches}")
        if not (rel < 3e-3 and lsmc_launches["tree_dp"] == 0
                and lsmc_launches["tree_dp_steps"] == 0 and lsmc_launches["intrinsic_dp"] == 1):
            raise AssertionError(f"the LSMC-against-tree oracle failed on {name}")
    # T3 (the timed case: five warm calls) and T4 (one) through the API; T3's
    # host phases and deltas; T5 on the large-slab route.
    for name, case, timed in (("T3", t3, 5), ("T4", t4, 1)):
        for dt, label in ((torch.float32, "f32"), (torch.float64, "f64")):
            run = lambda: tree_value(pkg, case, device, dt)  # noqa: E731
            run()  # warm-up
            npv, launches = on_path(1, run)
            walls = api_walls(run, timed)
            paths[f"{name}_{label}"] = dict(npv=npv, launches=launches, walls_s=walls,
                                            wall_s=float(np.median(walls)))
            log(f"trinomial_value {name} {label}: NPV {npv!r}; wall median "
                f"{paths[f'{name}_{label}']['wall_s']:.4f} s of {[round(x, 4) for x in walls]}; "
                f"{launches} tree launch(es)")
        if not math.isclose(paths[f"{name}_f32"]["npv"], paths[f"{name}_f64"]["npv"], rel_tol=1e-5):
            raise AssertionError(f"{name}: the f32 NPV is not within 1e-5 of the f64 NPV")
    paths["T3_phases"] = phases = tree_phases(pkg, t3, device, torch.float32)
    log("trinomial_value T3 f32 by phase (host clock, the device synchronised after each): "
        + ", ".join(f"{k[:-2]} {v:.4f} s" for k, v in phases.items()))
    npv, launches = on_path(tree_steps(t5), lambda: tree_value(pkg, t5, device, torch.float32),
                            route="tree_dp_steps")
    paths["T5_f32"] = dict(npv=npv, launches=launches)
    log(f"trinomial_value T5 f32 (large-slab route): NPV {npv!r}; {launches} step launches")
    months = pd.period_range(t3["storage"].start.asfreq("M"), periods=12, freq="M")
    contracts = [(month.asfreq("D", "start"), month.asfreq("D", "end")) for month in months]
    t0 = time.perf_counter()
    deltas, launches = on_path(2 * len(contracts), lambda: pkg.trinomial_deltas(
        t3["storage"], t3["val_date"], t3["inventory"], t3["fwd"], t3["vols"], t3["a"], 1 / 365.0,
        t3["rates"], t3["settle"], contracts, num_inventory_grid_points=NUM_GRID, device=device))
    deltas_s = time.perf_counter() - t0
    paths["T3_deltas"] = dict(deltas=deltas, wall_s=deltas_s, launches=launches)
    log(f"trinomial_deltas T3 f32 over {len(contracts)} monthly contracts: {deltas_s:.3f} s for "
        f"{2 * len(contracts)} valuations, {launches} tree launches; deltas "
        f"{[round(d, 3) for d in deltas]}")
    if not (len(deltas) == 12 and np.isfinite(deltas).all()):
        raise AssertionError("trinomial_deltas gave no finite delta per contract")
    paths_s = time.perf_counter() - t_paths
    log(f"tree phase: the kernel checks and timings {checks_s:.1f} s, the API paths "
        f"{paths_s:.1f} s")
    head, wide = timing["T3"], timing["T5"]
    steps_row = dict(max_abs_err=checks["T5"]["values_max_abs_err_f64"], ms=wide["ms_f32"],
                     ms_f64=wide["ms_f64"], kernel_busy_ms=wide["kernel_busy_ms_f32"],
                     plain_ms=wide["plain_ms"], bound_ms=wide["bound_ms"],
                     bound_by=wide["bound_by"], launches=paths["T5_f32"]["launches"],
                     launch=wide["launch"], dp_route="steps",
                     t3_ms=head["steps_route_ms_f32"], t3_ms_f64=head["steps_route_ms_f64"])
    return dict(max_abs_err=checks["T3"]["values_max_abs_err_f64"], ms=head["ms_f32"],
                ms_f64=head["ms_f64"], kernel_busy_ms=head["kernel_busy_ms_f32"],
                plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                launches=paths["T3_f32"]["launches"], widest=timing["T4"], checks=checks,
                launch=head["launch"], dp_route="cluster",
                cluster_size=head["launch"]["f32"]["cluster_size"],
                chain_floor_ms=head["chain_floor_ms"], chain_step_ns=head["chain_step_ns"],
                paths=paths, lattice=lattice_s, checks_s=checks_s, paths_s=paths_s,
                steps=steps_row)


# ---- the grids phase: inventory grids past the kernels' shared-memory
# routes.  Kernels B, E, D and C each take a large route there (the step
# tables a tile of grid points at a time; E's solve spread over blocks; C's
# coefficients and grid rows read from device memory), chosen from shapes.
GRID_BIG = 4_096
GRID_CHECK_SIMS = 65_536
GRID_F64_SIMS = 16_384
GRID_REPEATS = 3


def big_bunched_grid(lower, upper):
    """``bunched_grid``'s rows at ``GRID_BIG`` points."""
    import numpy as np

    return lower + (upper - lower) * np.linspace(0.0, 1.0, GRID_BIG) ** 1.3


@contextlib.contextmanager
def forced_routes(route: str, names=None):
    """Every grid-routed wrapper (B, D, E, C's two modes), or those
    ``names``, forced onto ``route`` inside the block.  A wrapper counts its
    launches on the name its module binds, the forcing wrapper inside the
    block: the counters are handed back to the wrapper on leaving it (read
    them after the block)."""
    import functools

    from storage_tpu_torch.ops import decision_kernel, forward_kernel

    targets = [(decision_kernel, name) for name in
               ("decision_update_moments", "decision_update", "decision_update_fullstep")]
    targets += [(forward_kernel, name) for name in ("forward_sweep", "forward_sweep_design")]
    if names is not None:
        targets = [(module, name) for module, name in targets if name in names]
    inners = {name: getattr(module, name) for module, name in targets}

    def forcing(inner):
        @functools.wraps(inner)
        def forced(*a, **k):
            return inner(*a, route=route, **k)
        return forced

    wrappers = {name: forcing(inner) for name, inner in inners.items()}
    for module, name in targets:
        setattr(module, name, wrappers[name])
    try:
        yield
    finally:
        for module, name in targets:
            setattr(module, name, inners[name])
            for counter in ("launches", "general_launches", "large_launches", "wide_launches",
                            "wide_smem_launches"):
                if hasattr(inners[name], counter):
                    setattr(inners[name], counter, getattr(wrappers[name], counter))


def check_grid_routes(device) -> dict:
    """The Python copies of the kernels' sizing (the route functions, which
    run on any device) against each built kernel's launch report, at shapes
    around the headline's: the same largest G of every shared route, and the
    same blocks per SM of each route the rule compares."""
    import types

    from storage_tpu_torch.ops import _build, decision_kernel, forward_kernel

    limit = _build.smem_limit(device)
    rows = []
    for d, b in ((3, 9), (3, 4), (3, 16), (5, 9), (7, 12), (3, 1)):
        rows.append((f"B D={d} B={b}", decision_kernel.moments_max_grid(d, b, limit),
                     decision_kernel.kernel_info("moments", 100, d, b, device)["max_grid"]))
    for d, b in ((3, 4), (3, 9), (5, 4), (3, 20), (3, 36)):
        rows.append((f"D D={d} B={b}", decision_kernel.update_max_grid(d, b, limit),
                     decision_kernel.kernel_info("update", 100, d, b, device)["max_grid"]))
    for b, r, f, e, design, general in ((9, 3, 3, 0, False, False), (9, 3, 3, 0, False, True),
                                        (9, 3, 0, 0, True, True), (9, 3, 0, 0, True, False),
                                        (4, 3, 0, 0, False, False), (16, 3, 8, 1, False, False),
                                        (1, 2, 1, 2, False, True), (20, 3, 0, 0, True, True)):
        v = b if design else f
        rows.append((f"C B={b} R={r} V={v} E={e} design={design} general={general}",
                     forward_kernel.sweep_max_grid(b, r, v, e, limit, design, general),
                     forward_kernel.kernel_info(100, b, r, f, e, device, design=design,
                                                general=general)["max_grid"]))
    bad = [row for row in rows if row[1] != row[2]]
    log(f"grid routes: the shared routes' largest G from the Python sizing equal the kernels' "
        f"launch reports at {len(rows) - len(bad)} of {len(rows)} shapes (smem limit {limit} B); "
        + "; ".join(f"{name}: {mine}" for name, mine, _ in rows[:1] + rows[6:7] + rows[11:14]))
    if bad:
        raise AssertionError(f"route sizing disagrees with kernel_info: {bad}")
    # The blocks per SM that the route rule of B, E and D counts from shapes
    # (the copied sizes, the SM's limits and each kernel's register limit),
    # against the launch reports: B's routes around its crossing, D's kernel
    # on both sides of each step of its register cap and on the wide route.
    occupancy = []
    for g, large in ((100, False), (112, False), (113, False), (400, False), (1_000, False),
                     (decision_kernel.TILE_B, True)):
        occupancy.append((f"B G={g}{' large' if large else ''}",
                          decision_kernel.moments_blocks_per_sm(g, 3, 9, limit),
                          decision_kernel.kernel_info("moments", g, 3, 9, device,
                                                      large=large)["blocks_per_sm"]))
    for b in (1, 4, 5, 8, 9, 16, 17, 20, 24, 28, 29, 32, 36):
        for g in (100, 400, decision_kernel.TILE_D):
            occupancy.append((f"D B={b} G={g}", decision_kernel.update_blocks_per_sm(g, 3, b, limit),
                              decision_kernel.kernel_info("update", g, 3, b,
                                                          device)["blocks_per_sm"]))
    # Kernel C's shared route on both sides of each crossing of its blocks
    # rule (SHARED_MIN_BLOCKS), where its shared memory limits the blocks.
    for b, v, design, general in ((9, 3, False, False), (9, 3, False, True),
                                  (9, 9, True, False), (9, 9, True, True),
                                  (4, 0, False, False), (4, 0, False, True)):
        last = max(g for g in range(2, 4_000)
                   if forward_kernel.sweep_route(g, b, 3, v, 0, limit, design, general)
                   == "shared")
        for g in (last, last + 1):
            occupancy.append((f"C B={b}{' design' if design else ''}"
                              f"{' general' if general else ''} G={g}",
                              forward_kernel.sweep_blocks_per_sm(g, b, 3, v, 0, limit, design,
                                                                 general),
                              forward_kernel.kernel_info(g, b, 3, 0 if design else v, 0, device,
                                                         design=design,
                                                         general=general)["blocks_per_sm"]))
    off = [row for row in occupancy if row[1] != row[2]]
    log(f"grid routes: blocks per SM from the Python copies equal the launch reports at "
        f"{len(occupancy) - len(off)} of {len(occupancy)} shapes; "
        + "; ".join(f"{name}: {mine}" for name, mine, _ in occupancy[:6] + occupancy[6:9]))
    if off:
        raise AssertionError(f"blocks per SM disagree with kernel_info: {off}")
    crossings = {name: max(g for g in range(2, 4_000) if fn(g).name == "shared")
                 for name, fn in (
                     ("B D=3 B=9", lambda g: decision_kernel.moments_route(g, 3, 9, limit)),
                     ("E D=3 B=9", lambda g: decision_kernel.fullstep_route(g, 3, 9, limit)),
                     ("D D=3 B=4", lambda g: decision_kernel.update_route(g, 3, 4, limit)),
                     ("D D=3 B=9", lambda g: decision_kernel.update_route(g, 3, 9, limit)),
                     ("C B=9 R=3 F=3", lambda g: types.SimpleNamespace(
                         name=forward_kernel.sweep_route(g, 9, 3, 3, 0, limit))))}
    log(f"grid routes: the largest G of each shared route under the rule: {crossings}")
    return dict(smem_limit=limit, shapes={name: mine for name, mine, _ in rows},
                blocks_per_sm={name: mine for name, mine, _ in occupancy}, crossings=crossings)


def random_design_update(device, g, s, seed, b):
    """Kernel D's arguments at G grid points, S sims and D=3 on a random
    standardised design of B terms, the rows following g in a band of ±5."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=device)  # noqa: E731
    idx_lo = (torch.arange(g, device=device)[:, None]
              + torch.tensor([-5, 0, 5], device=device)[None, :]).clamp(0, g - 2)
    return (100.0 + 30.0 * rnd(g, s), rnd(b, s), 30.0 + 5.0 * rnd(s),
            idx_lo.to(torch.int32).contiguous(), torch.rand((g, 3), generator=gen, device=device),
            20.0 * rnd(3, g, b), 2.0 * rnd(3, g), 20.0 * rnd(3, g))


def fullstep_args(args_b):
    """Kernel E's arguments from kernel B's: the moments of the step's design
    against 0.9·v, and the next moments' stats."""
    from storage_tpu_torch.ops import decision_kernel

    v, spot, fac, spot_p, fac_p, mean, std, mean_p, std_p, idx_lo, w_hi, _, a, b, mono = args_b
    dm = decision_kernel._standardised_design(mono, spot, fac, mean, std)
    return ((v, spot, fac, spot_p, fac_p, dm.T @ dm, dm.T @ (0.9 * v.T), mean, std, idx_lo,
             w_hi, a, b, mono), dict(mean_prev=mean_p, std_prev=std_p))


def same_outputs(x, y) -> bool:
    """Every output of two calls the same bits (tuples or tensors)."""
    import torch

    xs = x if isinstance(x, tuple) else (x,)
    ys = y if isinstance(y, tuple) else (y,)
    return all(torch.equal(a, b) for a, b in zip(xs, ys))


def forced_bits(fn, args, kwargs=None) -> bool:
    """``fn`` forced onto its large route gives its shared route's bits."""
    kwargs = kwargs or {}
    shared = fn(*args, route="shared", **kwargs)
    shared = tuple(t.clone() for t in shared) if isinstance(shared, tuple) else shared.clone()
    return same_outputs(shared, fn(*args, route="large", **kwargs))


def check_large_kernels(pkg, device) -> dict:
    """Each large route against its plain version at G = 4,096 on random
    inputs at S = 65,536 (B and E: argmax flips only on near-ties; D: the
    same bits; C in each mode: paths parting only on a near-tie), forced at
    smaller G to its shared route's bits, then timed with its plain version
    at the main path's S = 262,144 beside its bound and launch report."""
    import torch

    from storage_tpu_torch.basis import design_columns, parse_basis_functions
    from storage_tpu_torch.ops import decision_kernel, forward_kernel

    g, s, big_s = GRID_BIG, GRID_CHECK_SIMS, NUM_SIMS
    results = {}

    def row(name, check, ms, plain_ms, work, **extra):
        bnd = bound(*work)
        log(f"{name} large route [G={g}]: {check['text']}; {ms:.4f} ms vs plain {plain_ms:.3f} ms "
            f"at S={big_s}, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        if not check["ok"]:
            raise AssertionError(f"{name}'s large route disagrees with its plain version: "
                                 f"{check['text']}")
        results[name] = dict(max_abs_err=check["max_abs_err"], ms=ms, plain_ms=plain_ms,
                             checks={k: v for k, v in check.items() if k != "text"}, **extra,
                             **bnd)

    # Forced at small G: every route's large launch gives the shared bits.
    forced = {}
    small_b = random_step(device, NUM_GRID, s, seed=21)
    forced["B"] = forced_bits(decision_kernel.decision_update_moments, small_b)
    forced["E"] = forced_bits(decision_kernel.decision_update_fullstep, *fullstep_args(small_b))
    del small_b
    for b_dim in (4, 9):  # D's tiles (TILE_D) split a grid of 1,000
        forced[f"D B={b_dim}"] = forced_bits(decision_kernel.decision_update,
                                             random_design_update(device, BIG_GRID, s, 22, b_dim))
    sweep = random_sweep(device, 32, s, NUM_GRID, 3, seed=23)
    raw = torch.stack(design_columns(sweep[11], sweep[6], sweep[7]), dim=1)
    forced["C monomial"] = forced_bits(forward_kernel.forward_sweep, sweep)
    forced["C general"] = forced_bits(forward_kernel.forward_sweep, sweep,
                                      dict(grid=bunched_rows(sweep[0], NUM_GRID, NUM_GRID - 3)))
    forced["C design"] = forced_bits(forward_kernel.forward_sweep_design, design_args(sweep, raw))
    del sweep, raw
    log(f"large routes forced at G={NUM_GRID} (D at G={BIG_GRID}), S={s}: the shared route's "
        f"bits: {forced}")
    if not all(forced.values()):
        raise AssertionError(f"a large route parts from its shared route's bits: {forced}")

    # B and E.
    args = random_step(device, g, s, seed=24)
    cmp_b = compare_b(args)
    cmp_e = compare_e(*fullstep_args(args))
    del args
    # Timed on random rows spanning the grid and on rows following g (a
    # valuation's).
    args = random_step(device, g, big_s, seed=25)
    band = band_rows(args)
    out = torch.empty_like(args[0])
    ms = cuda_ms(lambda: decision_kernel.decision_update_moments(*args, out=out), 5)
    ms_band = cuda_ms(lambda: decision_kernel.decision_update_moments(*band, out=out), 5)
    plain_ms = cuda_ms(lambda: decision_kernel.decision_update_moments_plain(*args), 2)
    launch = moments_launch_report(device, decision_kernel.TILE_B, 9, large=True)
    log(f"decision_update_moments_large: {ms_band:.4f} ms on rows following g; its launch "
        f"(tiles of {decision_kernel.TILE_B}): {launch_text(launch)}")
    row("decision_update_moments_large", cmp_b, ms, plain_ms,
        decision_work(g, big_s, 3, 9, 3, moments=True), tile=decision_kernel.TILE_B,
        band_rows_ms=ms_band, **launch)
    e_args, prev = fullstep_args(args)
    e_band, _ = fullstep_args(band)
    ms = cuda_ms(lambda: decision_kernel.decision_update_fullstep(*e_args, **prev, out=out), 5)
    ms_band = cuda_ms(lambda: decision_kernel.decision_update_fullstep(*e_band, **prev, out=out), 5)
    plain_ms = cuda_ms(lambda: decision_kernel.decision_update_fullstep_plain(*e_args, **prev), 2)
    log(f"decision_update_fullstep_large: {ms_band:.4f} ms on rows following g")
    row("decision_update_fullstep_large", cmp_e, ms, plain_ms,
        decision_work(g, big_s, 3, 9, 3, moments=True, solve=True), tile=decision_kernel.TILE_B,
        band_rows_ms=ms_band, blocks_per_sm=launch["blocks_per_sm"])
    del args, band, e_args, e_band, out
    torch.cuda.empty_cache()

    # D at B = 4 (spot-only panels) and B = 9 (the generic replica): its
    # large route, after the record pack (checked and timed alone too).
    d_rows = {}
    pack = {}
    for g_p, b_dim in ((g, 4), (g, 9), (NUM_GRID, 4), (NUM_GRID, 9)):
        args = random_design_update(device, g_p, s, 26, b_dim)
        packed = decision_kernel.pack_records(*args[3:])
        same = torch.equal(packed.view(torch.int32),
                           decision_kernel.pack_records_plain(*args[3:]).view(torch.int32))
        # The kernel's own device time (torch.profiler, 20 launches, or a
        # CUDA graph's where the profiler saw none), apart from the wrapper's
        # host rate that events around back-to-back calls measure.
        own, source, launches = own_launch_ms(
            lambda: decision_kernel.pack_records(*args[3:]), "pack_records", 20)
        wrapper_ms = cuda_ms(lambda: decision_kernel.pack_records(*args[3:]), 20)
        pack[g_p, b_dim] = dict(
            same=same, ms=own, ms_source=source, launches_profiled=launches,
            wrapper_ms=wrapper_ms,
            plain_ms=cuda_ms(lambda: decision_kernel.pack_records_plain(*args[3:]), 5),
            bound=bound(*pack_work(g_p, 3, b_dim)))
        del args, packed
    for g_p in (g, NUM_GRID):
        p4, p9 = pack[g_p, 4], pack[g_p, 9]
        log(f"pack_records [G={g_p}, D=3, B=4 / 9]: the plain version's bits: "
            f"{p4['same']} / {p9['same']}; its own device time {p4['ms']:.5f} / {p9['ms']:.5f} "
            f"ms a launch ({p4['ms_source']}: torch.profiler saw {p4['launches_profiled']} of 20 "
            f"launches), the wrapper "
            f"back to back {p4['wrapper_ms']:.4f} / {p9['wrapper_ms']:.4f} ms (CUDA events) vs "
            f"plain {p4['plain_ms']:.4f} / {p9['plain_ms']:.4f} ms, bound "
            f"{p4['bound']['bound_ms']:.5f} / {p9['bound']['bound_ms']:.5f} ms")
    if not all(p_["same"] for p_ in pack.values()):
        raise AssertionError("pack_records parts from its plain version's bits")
    results["pack_records"] = dict(
        max_abs_err=0.0, ms=pack[g, 4]["ms"], ms_source=pack[g, 4]["ms_source"],
        plain_ms=pack[g, 4]["plain_ms"],
        b9_ms=pack[g, 9]["ms"], wrapper_ms=pack[g, 4]["wrapper_ms"],
        b9_wrapper_ms=pack[g, 9]["wrapper_ms"],
        **{f"g{NUM_GRID}_b{b_}_ms": pack[NUM_GRID, b_]["ms"] for b_ in (4, 9)},
        **{f"g{NUM_GRID}_b{b_}_bound_ms": pack[NUM_GRID, b_]["bound"]["bound_ms"]
           for b_ in (4, 9)},
        **pack[g, 4]["bound"])
    for b_dim in (4, 9):
        checks = [compare_d(random_update(device, g, s, seed=26, monotone=True) if b_dim == 4
                            else random_design_update(device, g, s, 26, b_dim))]
        if b_dim == 4:
            checks.append(compare_d(random_update(device, g, s, seed=27, monotone=False)))
        check = dict(checks[0], ok=all(c["ok"] for c in checks),
                     text="; ".join(c["text"] for c in checks),
                     max_abs_err=max(c["max_abs_err"] for c in checks))
        args = random_design_update(device, g, big_s, 28, b_dim)
        out = torch.empty_like(args[0])
        ms = cuda_ms(lambda: decision_kernel.decision_update(*args, out=out), 5)
        plain_ms = cuda_ms(lambda: decision_kernel.decision_update_plain(*args), 2)
        launch = update_launch_report(device, decision_kernel.TILE_D, b_dim)
        d_rows[b_dim] = (check, ms, plain_ms, launch)
        del args, out
        torch.cuda.empty_cache()
    check, ms, plain_ms, launch = d_rows[4]
    c9, ms9, plain9, launch9 = d_rows[9]
    bnd9 = bound(*decision_work(g, big_s, 3, 9, 0, moments=False, design_in_memory=True))
    row("decision_update_large", check, ms, plain_ms,
        decision_work(g, big_s, 3, 4, 0, moments=False, design_in_memory=True),
        tile=decision_kernel.TILE_D, smem_bytes=launch["smem_bytes"],
        blocks_per_sm=launch["blocks_per_sm"], registers=launch["registers"],
        spill_bytes=launch["spill_bytes"], b9_ms=ms9, b9_plain_ms=plain9,
        b9_bound_ms=bnd9["bound_ms"], b9_max_abs_err=c9["max_abs_err"],
        b9_blocks_per_sm=launch9["blocks_per_sm"], b9_smem_bytes=launch9["smem_bytes"],
        b9_registers=launch9["registers"], b9_spill_bytes=launch9["spill_bytes"])
    log(f"decision_update_large at B=4: its launch (tiles of {decision_kernel.TILE_D}): "
        f"{launch_text(launch)}")
    log(f"decision_update_large at B=9 [G={g}]: {c9['text']}; {ms9:.4f} ms vs plain "
        f"{plain9:.3f} ms at S={big_s}, bound {bnd9['bound_ms']:.4f} ms; its launch: "
        f"{launch_text(launch9)}")
    if not c9["ok"]:
        raise AssertionError(f"kernel D's large route at B=9 disagrees: {c9['text']}")

    # C in each mode: checked over 32 steps at S = 65,536, timed over the
    # main path's launches at S = 262,144 (365 steps; the design mode one
    # 32-step chunk, as the generic path launches it).
    mono = tuple(parse_basis_functions(BASIS))
    for mode in ("monomial", "general", "design"):
        args = random_sweep(device, 32, s, g, 3, seed=29)
        grid = bunched_rows(args[0], g, g - 3) if mode == "general" else None
        raw = (torch.stack(design_columns(mono, args[6], args[7]), dim=1)
               if mode == "design" else None)
        check = compare_sweep(args, design=raw, grid=grid)
        del args, raw
        n = forward_kernel.DESIGN_CHUNK if mode == "design" else NUM_STEPS
        args = random_sweep(device, n, big_s, g, 3, seed=30)
        # Rows that ascend at every step, as a custom grid's do (the bands
        # of random_sweep invert after step 100).
        grid = ascending_rows(args[0], g) if mode == "general" else None
        if mode == "design":
            raw = torch.stack(design_columns(mono, args[6], args[7]), dim=1)
            dargs = design_args(args, raw)
            ms = cuda_ms(lambda: forward_kernel.forward_sweep_design(*dargs), 3)
            plain_ms = cuda_ms(lambda: forward_kernel.forward_sweep_plain(*args, design=raw), 1)
            del raw, dargs
        else:
            ms = cuda_ms(lambda: forward_kernel.forward_sweep(*args, grid=grid), 3)
            plain_ms = cuda_ms(lambda: forward_kernel.forward_sweep_plain(*args, grid=grid), 1)
        launch = forward_kernel.kernel_info(g, 9, 3, 0 if mode == "design" else 3, 0, device,
                                            design=mode == "design", general=mode == "general",
                                            large=True)
        name = {"monomial": "forward_sweep_large", "general": "forward_sweep_general_large",
                "design": "forward_sweep_design_large"}[mode]
        row(name, check, ms, plain_ms,
            forward_work(n, big_s, 3, 9, g, 3, 3, panels=False, design=mode == "design",
                         general=mode == "general", large=True),
            steps=n, smem_bytes=launch["smem_bytes"], blocks_per_sm=launch["blocks_per_sm"],
            registers=launch["registers"], butterfly_ms=butterfly_ms(n, big_s, 9))
        del args, grid
        torch.cuda.empty_cache()
    return results


def grid_value(pkg, device, basis=BASIS, num_sims=None, num_grid=GRID_BIG, **kwargs):
    """The headline through the public API at ``num_grid`` grid points
    (``NUM_SIMS`` paths a set unless ``num_sims``)."""
    import torch

    storage, start, fwd = bench_case(pkg)
    return pkg.three_factor_seasonal_value(
        storage, start, 100.0, fwd, 0.02, None, 14.5, 1.1, 0.19, 0.23, num_sims or NUM_SIMS,
        basis, False, seed=11, fwd_sim_seed=13, num_inventory_grid_points=num_grid,
        dtype=torch.float32, device=device, snap_interp=True, **kwargs)


def grid_1000_valuation(pkg, device, counts) -> dict:
    """The headline at ``BIG_GRID`` = 1,000 grid points (262,144 paths x 365
    steps), where the route rule sends kernel B to its large route (its
    shared route would hold the step's records at 1 block per SM): its
    routes, NPV, SE, launches and wall (median of ``GRID_REPEATS``), and the
    same NPV and SE bits with every grid-routed kernel forced onto its
    shared route (one run, its wall beside)."""
    import math as _m

    import torch

    from storage_tpu_torch.basis import parse_basis_functions
    from storage_tpu_torch.engines import lsmc as engine
    from storage_tpu_torch.ops import _build

    routes = engine.grid_routes(BIG_GRID, 0, tuple(parse_basis_functions(BASIS)), 3, 3, False,
                                _build.smem_limit(device), NUM_STEPS, 4)
    row = timed_valuation(counts, lambda: grid_value(pkg, device, num_grid=BIG_GRID))
    res = row.pop("result")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with forced_routes("shared"):
        shared = grid_value(pkg, device, num_grid=BIG_GRID)
    torch.cuda.synchronize()
    shared_wall = time.perf_counter() - t0
    same = (res.npv, res.val_sim_standard_error) == (shared.npv, shared.val_sim_standard_error)
    log(f"G={BIG_GRID} headline [{NUM_SIMS} x {NUM_STEPS}]: routes {routes}; NPV {res.npv!r} SE "
        f"{res.val_sim_standard_error!r}; wall median {row['wall_s']:.3f} s of "
        f"{[round(w, 3) for w in row['walls_s']]}, launches {row['launches']}; every route "
        f"forced shared: NPV {shared.npv!r} SE {shared.val_sim_standard_error!r} (the same bits: "
        f"{same}), wall {shared_wall:.3f} s")
    if row["launches"]["decision_update_moments_large"] != NUM_STEPS:
        raise AssertionError(f"G={BIG_GRID}: kernel B took its shared route: {row['launches']}")
    if not (same and _m.isfinite(res.npv) and res.val_sim_standard_error > 0):
        raise AssertionError(f"G={BIG_GRID}: the rule's routes part from the shared route's bits")
    return dict(npv=res.npv, se=res.val_sim_standard_error, routes=routes,
                shared_wall_s=shared_wall, **row)


def grid_engine_inputs(pkg, device, num_sims, dtype, grid_calc=None):
    """The headline's engine arrays at ``GRID_BIG`` points (on ``grid_calc``'s
    rows, where given) in ``dtype``, and its f32 paths of seeds 11 and 13
    (the API's draws): (arrays, monomials, terminal function, reg, val)."""
    import torch

    from storage_tpu_torch import grid as gridmod
    from storage_tpu_torch.engines import lsmc as engine
    from storage_tpu_torch.models import spot_sim

    inputs, sim_in, _, monomials = engine_inputs(pkg, device)
    grids = None if grid_calc is None else gridmod.inventory_grids_custom(
        inputs.inventory_lower, inputs.inventory_upper, grid_calc)
    arrays = engine.build_engine_arrays(
        inputs.compiled, inputs.fwd, inputs.df_settle, inputs.df_flow, inputs.inventory_lower,
        inputs.inventory_upper, GRID_BIG, dtype, device, grids)
    ids = torch.arange(num_sims, device=device)
    reg, val = (spot_sim.simulate_ou_paths(spot_sim.key_from_seed(k), ids, *sim_in)
                for k in (11, 13))
    return arrays, monomials, inputs.compiled.terminal_value, reg, val


def grid_f64_npv(pkg, device, grid_calc=None) -> float:
    """The headline at ``GRID_BIG`` points (on ``grid_calc``'s rows) in f64:
    the kernels' plain versions on the f32 draws of ``GRID_F64_SIMS`` paths
    cast to f64 (``measure_f64``'s route at a path count whose [G, S] f64
    panels the plain versions sweep in seconds)."""
    import torch

    from storage_tpu_torch.engines import lsmc as engine

    arrays, monomials, tfn, reg, val = grid_engine_inputs(pkg, device, GRID_F64_SIMS,
                                                          torch.float64, grid_calc)
    f64 = lambda x: x.to(torch.float64)  # noqa: E731
    with plain_versions():
        out = engine.lsmc_core(arrays, f64(reg.spot), f64(reg.factors), f64(val.spot),
                               f64(val.factors), 100.0, monomials, 0, False, tfn, False,
                               snap_interp=True, uniform_grids=grid_calc is None)
    return float(out["npv"])


def timed_valuation(counts, run) -> dict:
    """``run()`` with the counters reset before it: its result, launches,
    wall (the median of ``GRID_REPEATS`` runs) and peak device memory."""
    import numpy as np
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for i in range(GRID_REPEATS):
        if i == 0:
            counts.reset()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if i == 0:
            launches = counts.read()
    return dict(result=res, launches=launches, wall_s=float(np.median(walls)), walls_s=walls,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def grid_valuations(pkg, device, counts, src, main) -> dict:
    """The headline with every large route forced at G = 100 (its pinned
    bits), then at G = 4,096 through each entry a user calls, each with its
    routes' launches, wall and peak memory: the headline, ``fullstep``
    (kernel E), the generic replica (kernel D at B = 9, C's design mode),
    ``value_from_sims`` on the spot panels (kernel D at B = 4) and the
    custom grid of 4,096 bunched rows (C's general-grid mode); the headline
    and the custom grid also at 16,384 paths against their f64 answers."""
    import math as _m
    import types

    import torch

    from storage_tpu_torch.engines import lsmc as engine

    report = {}
    counts.reset()
    with forced_routes("large"):
        res = value(pkg, device, snap_interp=True)
    launches = counts.read()
    expected = counts.expect(simulate_sweep=2, decision_update_moments=NUM_STEPS,
                             decision_update_moments_large=NUM_STEPS, forward_sweep=1,
                             forward_sweep_large=1, intrinsic_dp=1)
    log(f"headline at G={NUM_GRID} with every large route forced: NPV {res.npv!r} SE "
        f"{res.val_sim_standard_error!r} (the pinned bits {MAIN_NPV!r} {MAIN_SE!r}); launches "
        f"{launches}")
    if launches != expected:
        raise AssertionError(f"launch counts {launches}, expected {expected}")
    if (res.npv, res.val_sim_standard_error) != (MAIN_NPV, MAIN_SE):
        raise AssertionError("the large routes forced at G=100 part from the headline's bits")
    report["forced_g100"] = dict(npv=res.npv, se=res.val_sim_standard_error, launches=launches)
    report["g1000"] = grid_1000_valuation(pkg, device, counts)
    torch.cuda.empty_cache()

    def fullstep_run():
        out = engine.lsmc_core(arrays, reg.spot, reg.factors, val.spot, val.factors, 100.0,
                               monomials, 0, False, tfn, False, snap_interp=True, fullstep=True)
        return types.SimpleNamespace(npv=float(out["npv"]),
                                     val_sim_standard_error=float(out["standard_error"]))

    storage, start, fwd = bench_case(pkg)
    cases = {
        "headline": (lambda: grid_value(pkg, device),
                     dict(simulate_sweep=2, decision_update_moments=NUM_STEPS,
                          decision_update_moments_large=NUM_STEPS, forward_sweep=1,
                          forward_sweep_large=1, intrinsic_dp=1)),
        "fullstep": (fullstep_run,
                     dict(decision_update_fullstep=NUM_STEPS,
                          decision_update_fullstep_large=NUM_STEPS, forward_sweep=1,
                          forward_sweep_large=1)),
        "generic": (lambda: grid_value(pkg, device, basis=replica_basis(pkg)),
                    dict(simulate_sweep=2, decision_update=NUM_STEPS,
                         decision_update_large=NUM_STEPS, pack_records=NUM_STEPS,
                         forward_sweep_design=12,
                         forward_sweep_design_large=12, intrinsic_dp=1)),
        "spot_only": (lambda: pkg.value_from_sims(
            storage, start, 100.0, fwd, 0.02, None, src.sim_spot_regress, src.sim_spot_valuation,
            SPOT_BASIS, False, num_inventory_grid_points=GRID_BIG, dtype=torch.float32,
            device=device, snap_interp=True),
                      dict(decision_update=NUM_STEPS, decision_update_large=NUM_STEPS,
                           pack_records=NUM_STEPS, forward_sweep=1, forward_sweep_large=1,
                           intrinsic_dp=1)),
        "custom_grid": (lambda: grid_value(pkg, device, grid_calc=big_bunched_grid),
                        dict(simulate_sweep=2, decision_update_moments=NUM_STEPS,
                             decision_update_moments_large=NUM_STEPS, forward_sweep=1,
                             forward_sweep_general=1, forward_sweep_large=1, general_tail=1,
                             intrinsic_dp=1)),
    }
    for name, (run, counts_expected) in cases.items():
        if name == "fullstep":
            arrays, monomials, tfn, reg, val = grid_engine_inputs(pkg, device, NUM_SIMS,
                                                                  torch.float32)
        with engine.full_f32_matmul() if name == "fullstep" else contextlib.nullcontext():
            row = timed_valuation(counts, run)
        if name == "fullstep":
            del arrays, reg, val
        res = row.pop("result")
        npv, se = res.npv, res.val_sim_standard_error
        expected = counts.expect(**counts_expected)
        log(f"G={GRID_BIG} {name}: NPV {npv!r} SE {se!r}; wall median {row['wall_s']:.3f} s of "
            f"{[round(w, 3) for w in row['walls_s']]}, peak device memory {row['peak_gb']:.2f} GB; "
            f"launches {row['launches']}")
        if row["launches"] != expected:
            raise AssertionError(f"{name}: launch counts {row['launches']}, expected {expected}")
        if not (_m.isfinite(npv) and _m.isfinite(se) and se > 0):
            raise AssertionError(f"{name}: NPV {npv} SE {se} not finite")
        report[name] = dict(npv=npv, se=se, **row)
        torch.cuda.empty_cache()
    head = report["headline"]
    for name, tol in (("fullstep", 0.05), ("generic", 0.1)):
        off = (report[name]["npv"] - head["npv"]) / head["se"]
        report[name]["off_headline_se"] = off
        log(f"G={GRID_BIG} {name}: {off:+.4f} SE from the G={GRID_BIG} headline (tolerance {tol})")
        if not abs(off) <= tol:
            raise AssertionError(f"{name} at G={GRID_BIG} is {off} SE from the headline")
    report["headline"]["off_g100_se"] = (head["npv"] - main.npv) / main.val_sim_standard_error

    # The headline and the custom grid against their f64 answers on the
    # same draws, at 16,384 paths.
    for name, grid_calc in (("headline", None), ("custom_grid", big_bunched_grid)):
        f64 = grid_f64_npv(pkg, device, grid_calc)
        kwargs = {} if grid_calc is None else dict(grid_calc=grid_calc)
        res = grid_value(pkg, device, num_sims=GRID_F64_SIMS, **kwargs)
        off = (res.npv - f64) / res.val_sim_standard_error
        log(f"G={GRID_BIG} {name} at {GRID_F64_SIMS} paths: NPV {res.npv!r} SE "
            f"{res.val_sim_standard_error!r}, {off:+.4f} SE from its f64 answer {f64!r} "
            f"(tolerance 0.1)")
        if not abs(off) <= 0.1:
            raise AssertionError(f"{name} at G={GRID_BIG}: {off} SE from its f64 answer")
        report[name]["f64"] = dict(sims=GRID_F64_SIMS, npv=res.npv, se=res.val_sim_standard_error,
                                   f64_npv=f64, off_se=off)
        torch.cuda.empty_cache()
    return report


def grids_phase(pkg, device, counts, src, main) -> tuple:
    """The grids phase: the route sizing, the large routes' kernels, the
    valuations at G = 4,096.  Returns (kernel rows, report)."""
    import torch

    from storage_tpu_torch.engines import lsmc as engine

    torch.cuda.empty_cache()
    report = {"routes": check_grid_routes(device)}
    with engine.full_f32_matmul():
        kernels = check_large_kernels(pkg, device)
    torch.cuda.empty_cache()
    report["c_digests"] = check_c_digests(device)
    torch.cuda.empty_cache()
    report.update(grid_valuations(pkg, device, counts, src, main))
    return kernels, report


# ---- the DP grids phase: the intrinsic DP and the tree past their shared
# routes.  Each DP takes a large route there (its rows in device memory),
# chosen from shapes: ``intrinsic_kernel.intrinsic_route``,
# ``tree_kernel.tree_route``.
DP_GRID = 32_768          # the intrinsic DP in f32 on linear rows: past 29,034
DP_STEP = 0.5             # the headline facility's 5,000 units on a fixed step: 10,001 rows
DP_CUBIC_GRID = 6_144     # the intrinsic DP in f64, cubic: past 5,802
DP_TREE_GRID = 65_536     # the tree in f32 on linear rows: past 58,112
DP_TREE_CUBIC_GRID = 10_240  # the tree in f64, cubic: past 9,686
DP_SIMS = 16_384
H100_SMEM = 232_448
# The shared routes' largest G on an H100 (R = 3, E = 0), {mode: (f32, f64)}:
# the intrinsic DP's one block, the tree's large-slab block.
INTRINSIC_LIMITS = {"linear": (29_034, 14_506), "general": (14_517, 7_253),
                    "cubic": (11_613, 5_802)}
STEPS_LIMITS = {"linear": (58_112, 29_056), "general": (58_112, 29_056),
                "cubic": (19_371, 9_686)}
DP_MODES = ("linear", "general", "cubic")


def step_rows(step: float):
    """A ``grid_calc`` of a fixed volume step from each band's lower bound,
    capped at its upper (``IDoubleStateSpaceGridCalc``'s fixed spacing)."""
    import numpy as np

    def calc(lower, upper):
        if upper <= lower:
            return np.array([lower])
        k = int(np.ceil((upper - lower) / step - 1e-9))
        return np.minimum(lower + step * np.arange(k + 1), upper)
    return calc


def check_dp_routes(device) -> dict:
    """The route rules' copies of the DPs' sizing against the built kernels'
    launch reports, in the three modes and both dtypes (the intrinsic DP
    also at two more (R, E)): the same largest G of each shared route, and
    on an H100 the documented limits."""
    import torch

    from storage_tpu_torch.ops import _build, intrinsic_kernel, tree_kernel

    limit = _build.smem_limit(device)
    rows = []
    for dt, label, itemsize in ((torch.float32, "f32", 4), (torch.float64, "f64", 8)):
        for mode in DP_MODES:
            documented = (INTRINSIC_LIMITS[mode][itemsize // 8], STEPS_LIMITS[mode][itemsize // 8])
            rows.append((f"intrinsic {label} {mode} R=3 E=0",
                         intrinsic_kernel.max_grid(3, 0, mode, itemsize, limit),
                         intrinsic_kernel.intrinsic_info(dt, device, 100, 3, 0, mode)["max_grid"],
                         documented[0]))
            rows.append((f"tree {label} {mode}", tree_kernel.steps_max_grid(itemsize, mode, limit),
                         tree_kernel.kernel_info(100, dt, mode, device)["max_grid"],
                         documented[1]))
    for dt, label, itemsize, r, e, mode in ((torch.float64, "f64", 8, 6, 2, "general"),
                                            (torch.float32, "f32", 4, 2, 1, "cubic")):
        rows.append((f"intrinsic {label} {mode} R={r} E={e}",
                     intrinsic_kernel.max_grid(r, e, mode, itemsize, limit),
                     intrinsic_kernel.intrinsic_info(dt, device, 100, r, e, mode)["max_grid"],
                     None))
    # The large route's cooperative grid, from the card's SMs and the launch
    # report's blocks per SM, against the grid the launch report sizes.
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for dt, label, g, mode in ((torch.float32, "f32", DP_GRID, "linear"),
                               (torch.float64, "f64", DP_GRID, "linear"),
                               (torch.float64, "f64", 10_001, "general"),
                               (torch.float64, "f64", DP_CUBIC_GRID, "cubic"),
                               (torch.float32, "f32", NUM_GRID, "linear"),
                               (torch.float64, "f64", NUM_GRID, "cubic")):
        info = intrinsic_kernel.intrinsic_info(dt, device, g, 3, 0, mode)
        rows.append((f"intrinsic large grid {label} {mode} G={g}",
                     intrinsic_kernel.large_grid_blocks(g, mode, sms, info["large_blocks_per_sm"]),
                     info["large_grid_blocks"], None))
    bad = [row for row in rows if row[1] != row[2]
           or (limit == H100_SMEM and row[3] is not None and row[1] != row[3])]
    log(f"DP routes: the shared routes' largest G and the intrinsic large route's grid "
        f"blocks from the Python sizing equal the kernels' launch reports at "
        f"{len(rows) - len(bad)} of {len(rows)} shapes (smem limit {limit} B, {sms} SMs): "
        + "; ".join(f"{name}: {mine}" for name, mine, _, _ in rows))
    if bad:
        raise AssertionError(f"DP route sizing disagrees with the launch reports or the H100's "
                             f"limits: {bad}")
    return dict(smem_limit=limit, sms=sms, shapes={name: mine for name, mine, _, _ in rows})


def forced_dp_bits(pkg, device) -> dict:
    """Each DP forced onto its large route at the headline's shapes gives
    its own route's bits: the intrinsic DP on the headline's tables at G=100
    (linear, fixed-spacing rows, cubic; f32 and f64), the tree at T3 (its
    cluster route) and T5 (its large-slab route)."""
    import torch

    from storage_tpu_torch.engines import intrinsic as ie
    from storage_tpu_torch.engines import tree as te

    same = {}
    for mode, scheme in (("linear", "linspace"), ("general", "fixed_spacing"),
                         ("cubic", "linspace")):
        inputs, arrays = intrinsic_case(pkg, device, "headline", scheme, NUM_GRID)
        args = (inputs.starting_inventory, 0, inputs.compiled.terminal_value, False,
                "cubic" if mode == "cubic" else "linear", scheme == "linspace")
        for dt, label in ((torch.float32, "f32"), (torch.float64, "f64")):
            own = ie.intrinsic_core(arrays[dt], *args)
            large = ie.intrinsic_core(arrays[dt], *args, route="large")
            same[f"intrinsic {mode} {label}"] = all(
                torch.equal(getattr(own, k), getattr(large, k))
                for k in ie.IntrinsicEngineResult._fields)
    for name, case in (("T3", headline_tree_case(pkg, 5.5)), ("T5", wide_tree_case(pkg))):
        inputs, tables, _ = tree_tables(pkg, device, case)
        for dt, label in ((torch.float32, "f32"), (torch.float64, "f64")):
            run = lambda route=None: te.tree_core(*tables[dt], 0, inputs.compiled.terminal_value,  # noqa: E731
                                                  False, route=route).values
            same[f"tree {name} {label}"] = torch.equal(run(), run("large"))
        del tables
    log(f"DP large routes forced at the headline's shapes, the same bits as their own routes: "
        f"{same}")
    if not all(same.values()):
        raise AssertionError(f"a DP's large route parts from its own route's bits: {same}")
    return same


def random_lattice_tables(pkg, device, m: int, g: int, n: int, w: int = 3, seed: int = 5):
    """A small random lattice (m node rows, each row's band of w columns
    summing to 1; tests/test_torch_cuda_kernels.py _wide_lattice) on the 2F
    facility's tables over its last n steps at g linspace points, in f64:
    (valuation inputs, {f64: (arrays, lattice)})."""
    import numpy as np
    import torch

    from storage_tpu_torch import grid as gridmod
    from storage_tpu_torch.engines import lsmc as engine
    from storage_tpu_torch.valuation_inputs import prepare_valuation

    storage, _, fwd, rates, settle = reg_case(pkg)
    inputs = prepare_valuation(storage, storage.end - n, 100.0 * n, fwd, rates, settle)
    lo, hi = inputs.inventory_lower, inputs.inventory_upper
    arrays = engine.build_engine_arrays(inputs.compiled, inputs.fwd, inputs.df_settle,
                                        inputs.df_flow, lo, hi, g, torch.float64, device,
                                        gridmod.inventory_grids(lo, hi, g))
    rng = np.random.default_rng(seed)
    band = rng.uniform(0.1, 1.0, (n, m, w))
    band /= band.sum(axis=-1, keepdims=True)
    start = np.clip(np.arange(m) - w // 2, 0, m - w)
    as_t = lambda a, dt=torch.float64: torch.tensor(a, dtype=dt, device=device)  # noqa: E731
    lattice = {"spot": as_t(20.0 + 10.0 * rng.uniform(size=(n + 1, m))), "band": as_t(band),
               "band_start": as_t(np.broadcast_to(start, (n, m)).copy(), torch.int64),
               "q0": as_t(np.full(m, 1.0 / m)),
               "dest_centre": as_t(np.arange(m), torch.int64)}
    return inputs, {torch.float64: (arrays, lattice)}


def check_large_dps(pkg, device) -> tuple:
    """Past the shared routes' limits, each large route against its plain
    version (``compare_intrinsic``, ``compare_tree``: f64 NPV within 1e-10
    relative, profile within 1e-6, flips only on a near-tie; f32 within
    1e-5 of the f64 answer), its route asserted from the shape: the
    intrinsic DP in f32 (and f64) on the headline's tables at G=32,768, in
    f64 on its 10,001 fixed-step rows and in f64 cubic on the 2F facility at
    G=6,144; the tree in f32 (and f64) on T1's lattice at G=65,536 and in f64
    cubic on a random 8-row lattice at G=10,240.  Then the two kernel rows:
    each large route timed (CUDA events around its wrapper's launches, and
    through the engine's core) at the first case of each DP with its plain
    version, its bound and its launch report.  Returns (kernel rows,
    checks)."""
    import torch

    from storage_tpu_torch.engines import intrinsic as ie
    from storage_tpu_torch.engines import tree as te
    from storage_tpu_torch.ops import _build, intrinsic_kernel, tree_kernel

    limit = _build.smem_limit(device)
    checks, rows = {}, {}
    cases = {  # name: (facility, scheme, G, grid_calc, interpolation, f32 checked)
        "intrinsic_f32_linear_32768": ("headline", "linspace", DP_GRID, None, "linear", True),
        "intrinsic_f64_general_10001": ("headline", "custom", NUM_GRID, step_rows(DP_STEP),
                                        "linear", False),
        "intrinsic_f64_cubic_6144": ("2F", "linspace", DP_CUBIC_GRID, None, "cubic", False),
    }
    for name, (case, scheme, g, grid_calc, interpolation, f32) in cases.items():
        inputs, arrays = intrinsic_case(pkg, device, case, scheme, g, grid_calc)
        width = arrays[torch.float64]["grids"].shape[1]
        mode = ie.kernel_mode(interpolation, scheme == "linspace")
        dtypes = (torch.float32, torch.float64) if f32 else (torch.float64,)
        routes = {str(dt)[6:]: intrinsic_kernel.intrinsic_route(
            width, arrays[dt]["ratchet_inv"].shape[1], 0, mode, dt.itemsize, limit,
            inputs.num_steps) for dt in dtypes}
        t0 = time.perf_counter()
        checks[name] = c = compare_intrinsic(inputs, arrays, 0, interpolation,
                                             scheme == "linspace", f32=f32)
        c.update(routes=routes, grid=width, s=time.perf_counter() - t0)
        log(f"intrinsic DP [{name}: N={inputs.num_steps}, G={width}, {mode}; routes {routes}]: "
            f"f64 NPV {c['npv_f64']!r} vs plain {c['npv_f64_plain']!r} (rel "
            f"{c['npv_rel_err_f64']:.2e}, tolerance 1e-10), profile max abs err "
            f"{c['profile_max_abs_err_f64']:.2e} (tolerance 1e-6), {c['decision_flips_f64']} "
            f"decision flips (first on a near-tie: {c['first_flip_on_near_tie']})"
            + (f"; f32 NPV {c['npv_f32']!r} (rel {c['npv_rel_err_f32']:.2e}, tolerance 1e-5)"
               if f32 else "") + f"; {c['s']:.1f} s")
        if not c["ok"] or set(routes.values()) != {"large"}:
            raise AssertionError(f"intrinsic DP {name}: {c}")
        if name == "intrinsic_f64_general_10001":
            # Its bound: the DP's bytes and operations in f64, each decision
            # also a binary search of its next row (DP_SEARCH_OPS_PER_PROBE a
            # probe), at the f64 rate: half the f32 one (NVIDIA's data sheet,
            # 34 TFLOP/s FP64 against 67 f32).
            n, r = inputs.num_steps, arrays[torch.float64]["ratchet_inv"].shape[1]
            num_bytes, ops = intrinsic_work(n, width, r, 3, 8)
            probes = math.ceil(math.log2(max(width - 2, 2)))
            ops += float((n - 1) * width + n) * 3 * DP_SEARCH_OPS_PER_PROBE * probes
            c["bound"] = bound(num_bytes, 0.0, 2.0 * ops)
            rows["intrinsic_dp_large"]["general_10001_f64_bound_ms"] = c["bound"]["bound_ms"]
            log(f"intrinsic DP [{name}]: bound {c['bound']['bound_ms']:.4f} ms "
                f"({c['bound']['bound_by']}; f64 operations at half the f32 rate, {probes} "
                f"probes a decision's search)")
        if name == "intrinsic_f32_linear_32768":
            tfn, n = inputs.compiled.terminal_value, inputs.num_steps
            r = arrays[torch.float32]["ratchet_inv"].shape[1]
            row = dict(max_abs_err=c["profile_max_abs_err_f64"], grid=width)
            for dt, label in ((torch.float32, "f32"), (torch.float64, "f64")):
                run = lambda: ie.intrinsic_core(arrays[dt], 100.0, 0, tfn, False)  # noqa: E731
                row[f"core_ms_{label}"] = cuda_ms(run, 5)
                # The wrapper's launch alone, by CUDA events around it (the
                # profiler drops events this late in the run).
                row[f"ms_{label}"] = launch_ms(intrinsic_kernel, "intrinsic_dp", run, 5)[0]
            row["ms"] = row["ms_f32"]
            row["plain_ms"] = cuda_ms(lambda: ie.intrinsic_plain(arrays[torch.float32], 100.0, 0,
                                                                 tfn, False), 1)
            num_bytes, ops = intrinsic_work(n, width, r, 3, 4)
            row.update(bound(num_bytes, 0.0, ops))
            row["launch"] = {label: intrinsic_kernel.intrinsic_info(dt, device, width, r, 0,
                                                                    "linear")
                             for dt, label in ((torch.float32, "f32"), (torch.float64, "f64"))}
            f32r, f64r = row["launch"]["f32"], row["launch"]["f64"]
            if not (f32r["large_cooperative"] and f32r["large_grid_blocks"] > 1
                    and f64r["large_grid_blocks"] > 1):
                raise AssertionError(f"the intrinsic DP's large route does not spread a step "
                                     f"over blocks at G={width}: {row['launch']}")
            # The chain floor: N - 1 grid links (a grid sync over the launch's
            # blocks and a read of another block's word) and the walk's N
            # links (a block barrier and a read each).
            row["block_link_ns"] = tree_kernel.chain_step_ns("block", device)
            row["grid_link_ns"] = tree_kernel.chain_step_ns(
                "grid", device, f32r["large_threads"], f32r["large_grid_blocks"])
            row["chain_step_ns"] = row["grid_link_ns"]
            row["chain_floor_ms"] = ((n - 1) * row["grid_link_ns"] + n * row["block_link_ns"]) / 1e6
            rows["intrinsic_dp_large"] = row
            log(f"intrinsic DP large route at N={n}, G={width}: {row['ms_f32']:.4f} ms f32, "
                f"{row['ms_f64']:.4f} ms f64 a launch (CUDA events around intrinsic_dp), "
                f"{row['core_ms_f32']:.4f} / {row['core_ms_f64']:.4f} ms through intrinsic_core; "
                f"plain {row['plain_ms']:.1f} ms (f32); bound {row['bound_ms']:.6f} ms "
                f"({row['bound_by']}); chain floor {row['chain_floor_ms']:.4f} ms ({n - 1} x "
                f"{row['grid_link_ns']:.1f} ns grid links + {n} x {row['block_link_ns']:.1f} ns); "
                f"a cooperative launch of {f32r['large_grid_blocks']} / "
                f"{f64r['large_grid_blocks']} blocks (f32 / f64) of {f32r['large_threads']} "
                f"threads, {f32r['large_blocks_per_sm']} / {f64r['large_blocks_per_sm']} "
                f"blocks/SM, "
                f"{f32r['large_registers']} / {f64r['large_registers']} registers, "
                f"{f32r['large_local_bytes']} / {f64r['large_local_bytes']} bytes local (spills), "
                f"{f32r['large_smem_bytes']} bytes shared f32, {f32r['large_chunk']} steps "
                f"staged a chunk of the walk")
        del arrays
        torch.cuda.empty_cache()
    t1 = csharp_tree_case(pkg)
    for name, f32 in (("tree_f32_linear_65536", True), ("tree_f64_cubic_10240", False)):
        t0 = time.perf_counter()
        if f32:
            inputs, tables, uniform = tree_tables(pkg, device, dict(t1, g=DP_TREE_GRID))
            interpolation = "linear"
        else:
            inputs, tables = random_lattice_tables(pkg, device, 8, DP_TREE_CUBIC_GRID, 4)
            uniform, interpolation = True, "cubic"
        arrays, lattice = tables[torch.float64]
        (m, w), g = lattice["band"].shape[1:], arrays["grids"].shape[1]
        mode = ie.kernel_mode(interpolation, uniform)
        routes = {str(dt)[6:]: tree_kernel.tree_route(m, g, w, 0, mode, dt, device)
                  for dt in tables}
        checks[name] = c = compare_tree(inputs, tables, 0, interpolation, uniform, f32=f32)
        c.update(routes=routes, grid=g, s=time.perf_counter() - t0)
        log(f"tree DP [{name}: N={inputs.num_steps}, M={m}, W={w}, G={g}, {mode}; routes "
            f"{routes}]: f64 NPV {c['npv_f64']!r} vs plain {c['npv_f64_plain']!r} (rel "
            f"{c['npv_rel_err_f64']:.2e}, tolerance 1e-10), values {c['values_rel_err_f64']:.2e} "
            f"of their rows' scale (tolerance 1e-9), {c['paths_parted']} of 3 branch paths "
            f"parted (first on a near-tie: {c['first_parting_on_near_tie']})"
            + (f"; f32 NPV {c['npv_f32']!r} (rel {c['npv_rel_err_f32']:.2e}, tolerance 1e-5)"
               if f32 else "") + f"; {c['s']:.1f} s")
        if not c["ok"] or set(routes.values()) != {"large"}:
            raise AssertionError(f"tree DP {name}: {c}")
        if f32:
            tfn, n, r = inputs.compiled.terminal_value, inputs.num_steps, arrays[
                "ratchet_inv"].shape[1]
            row = dict(max_abs_err=c["values_max_abs_err_f64"], grid=g)
            for dt, label in ((torch.float32, "f32"), (torch.float64, "f64")):
                run = lambda: te.tree_core(*tables[dt], 0, tfn, False)  # noqa: E731
                # tree_core also values the facility's terminal function on
                # [M, G]; the wrapper's launches alone by CUDA events.
                row[f"core_ms_{label}"] = cuda_ms(run, 5)
                row[f"ms_{label}"] = launch_ms(tree_kernel, "tree_dp", run, 5)[0]
            row["ms"] = row["ms_f32"]
            row["plain_ms"] = cuda_ms(lambda: te.tree_plain(*tables[torch.float32], 0, tfn,
                                                            False), 1)
            num_bytes, ops = tree_work(n, m, g, w, r, 3, 4)
            row.update(bound(num_bytes, 0.0, ops))
            # The bound again in the table form: the work any design must do.
            table_bytes, table_ops = tree_table_work(n, m, g, w, r, 3, 4)
            row["table_form"] = bound(table_bytes, 0.0, table_ops)
            row["table_bound_ms"] = row["table_form"]["bound_ms"]
            row["launch"] = {label: tree_kernel.kernel_info(g, dt, "linear", device, m, w)
                             for dt, label in ((torch.float32, "f32"), (torch.float64, "f64"))}
            row["table_steps"] = tree_kernel.large_table_steps(n, g, 0, 4)
            row["table_bytes"] = {label: tree_kernel.large_table_steps(n, g, 0, dt.itemsize)
                                  * intrinsic_kernel.table_len(g, 0) * dt.itemsize
                                  for dt, label in ((torch.float32, "f32"), (torch.float64, "f64"))}
            row["launches_per_valuation"] = tree_kernel.large_launches(n, g, 0, "linear", 4)
            # The chain floor: one link a launch, a launch of the decide's
            # blocks reading what the launch before wrote.
            decide_blocks = -(-g // 256) * -(-m // tree_kernel.LARGE_DECIDE_ROWS)
            row["launch_link_ns"] = tree_kernel.chain_step_ns("launch", device, 256,
                                                              min(decide_blocks, 4096))
            row["chain_floor_ms"] = row["launches_per_valuation"] * row["launch_link_ns"] / 1e6
            rows["tree_dp_large"] = row
            f32r, f64r = row["launch"]["f32"], row["launch"]["f64"]
            log(f"tree DP large route at N={n}, M={m}, G={g}: {row['ms_f32']:.4f} ms f32, "
                f"{row['ms_f64']:.4f} ms f64 a valuation's {n} steps (CUDA events around "
                f"tree_dp), {row['core_ms_f32']:.4f} / {row['core_ms_f64']:.4f} ms through "
                f"tree_core; plain {row['plain_ms']:.1f} ms (f32); bound {row['bound_ms']:.6f} "
                f"ms ({row['bound_by']}; a whole decide a cell), {row['table_bound_ms']:.6f} ms "
                f"({row['table_form']['bound_by']}; the table form); chain floor "
                f"{row['chain_floor_ms']:.4f} ms ({row['launches_per_valuation']} launches x "
                f"{row['launch_link_ns']:.1f} ns); step tables {row['table_steps']} steps a fill "
                f"launch, {row['table_bytes']['f32']} / {row['table_bytes']['f64']} bytes f32 / "
                f"f64; blocks of {f32r['large_threads']} threads, {decide_blocks} decide blocks a "
                f"step ({f32r['large_blocks_per_sm']} / {f64r['large_blocks_per_sm']} a SM), "
                f"{f32r['large_registers']} / {f64r['large_registers']} registers (decide), "
                f"{f32r['large_table_registers']} / {f64r['large_table_registers']} (table), "
                f"{f32r['large_local_bytes']} / {f64r['large_local_bytes']} bytes local (spills), "
                f"{f32r['large_launches_per_step']} launches a step, not cooperative")
        del tables, arrays, lattice
        torch.cuda.empty_cache()
    return rows, checks


def dp_api_runs(pkg, device, counts) -> dict:
    """The DPs' large routes through the API, each with the launch counters
    reset just before it: ``intrinsic_value`` at G=32,768 in f32 and on the
    10,001 fixed-step rows in f64, ``trinomial_value`` at G=65,536 in f32
    on T1, and ``three_factor_seasonal_value`` at G=32,768 on 16,384 paths
    (seeds 11/13), whose log line shows the intrinsic DP's route beside B's
    and C's.  Each: its answer, wall (host clock, synchronised), the DP
    kernel's own time (CUDA events around its wrapper), launches by route
    and peak device memory."""
    import logging
    import math as _m

    import torch

    from storage_tpu_torch.ops import intrinsic_kernel, tree_kernel

    storage, start, fwd = bench_case(pkg)
    t1 = csharp_tree_case(pkg)
    routes_logged = []

    class Routes(logging.Handler):
        def emit(self, record):
            if "Kernel routes" in record.getMessage():
                routes_logged.append(record.getMessage())

    paths = {
        "intrinsic_value_f32_32768": (lambda: pkg.intrinsic_value(
            storage, start, 100.0, fwd, 0.02, None, num_inventory_grid_points=DP_GRID,
            dtype=torch.float32, device=device).npv, dict(intrinsic_dp=1, intrinsic_dp_large=1)),
        "intrinsic_value_f64_step_rows": (lambda: pkg.intrinsic_value(
            storage, start, 100.0, fwd, 0.02, None, grid_calc=step_rows(DP_STEP),
            dtype=torch.float64, device=device).npv, dict(intrinsic_dp=1, intrinsic_dp_large=1)),
        "trinomial_value_f32_65536": (lambda: tree_value(pkg, dict(t1, g=DP_TREE_GRID), device,
                                                         torch.float32),
                                      dict(tree_dp_large=tree_kernel.large_launches(
                                          tree_steps(t1), DP_TREE_GRID, 0, "linear", 4))),
        "three_factor_f32_32768": (lambda: pkg.three_factor_seasonal_value(
            storage, start, 100.0, fwd, 0.02, None, 14.5, 1.1, 0.19, 0.23, DP_SIMS, BASIS, False,
            seed=11, fwd_sim_seed=13, num_inventory_grid_points=DP_GRID, dtype=torch.float32,
            device=device, snap_interp=True),
                                   dict(simulate_sweep=2, decision_update_moments=NUM_STEPS,
                                        decision_update_moments_large=NUM_STEPS, forward_sweep=1,
                                        forward_sweep_large=1, intrinsic_dp=1,
                                        intrinsic_dp_large=1)),
    }
    report = {}
    handler = Routes()
    logger = logging.getLogger("storage_tpu_torch.multi_factor")
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        for name, (run, expected) in paths.items():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            counts.reset()
            with call_spans([(intrinsic_kernel, "intrinsic_dp"), (tree_kernel, "tree_dp")]) as sp:
                t0 = time.perf_counter()
                out = run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            launches = counts.read()
            kernel_ms = {k: spans_ms(v) for k, v in sp.items() if v}
            row = dict(wall_s=wall, kernel_ms=kernel_ms, launches=launches,
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9)
            if name.startswith("three_factor"):
                row.update(npv=out.npv, se=out.val_sim_standard_error,
                           intrinsic_npv=out.intrinsic_npv, routes_logged=list(routes_logged))
                finite = _m.isfinite(out.npv) and out.val_sim_standard_error > 0
            else:
                row["npv"] = float(out)
                finite = _m.isfinite(row["npv"])
            report[name] = row
            log(f"DP grids API {name}: NPV {row['npv']!r}; wall {wall:.3f} s, the DP kernel's "
                f"own {kernel_ms} ms (CUDA events around its wrapper), peak device memory "
                f"{row['peak_gb']:.2f} GB; launches {launches}"
                + (f"; {routes_logged[-1] if routes_logged else 'no route line logged'}"
                   if name.startswith("three_factor") else ""))
            if launches != counts.expect(**expected):
                raise AssertionError(f"{name}: launch counts {launches}, expected {expected}")
            if not finite:
                raise AssertionError(f"{name}: the answer {out} is not finite")
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    if not any("intrinsic intrinsic_dp (large)" in line for line in routes_logged):
        raise AssertionError(f"the valuation's route line lacks the intrinsic DP's large route: "
                             f"{routes_logged}")
    return report


def dp_grids_phase(pkg, device, counts) -> tuple:
    """The DP grids phase: the route sizing, each large route forced at the
    headline's shapes, each past its limits against its plain version and
    timed, the API runs.  Returns (kernel rows, report)."""
    import torch

    torch.cuda.empty_cache()
    report = {"routes": check_dp_routes(device), "forced": forced_dp_bits(pkg, device)}
    kernels, report["checks"] = check_large_dps(pkg, device)
    report["api"] = dp_api_runs(pkg, device, counts)
    torch.cuda.empty_cache()
    return kernels, report


@contextlib.contextmanager
def plain_versions():
    """Kernels B, D and C (both modes) replaced by their plain versions
    inside the block (the route of ``--f64``: f64 on the card)."""
    from unittest import mock

    from storage_tpu_torch.ops import decision_kernel, forward_kernel

    def design_plain(params, mean, std, r_inv, r_min, r_max, spot, design, inventory, pv, coeffs,
                     e, is_step, panels=None, out=None, grid=None):
        return forward_kernel.forward_sweep_plain(params, mean, std, r_inv, r_min, r_max, spot,
                                                  None, inventory, pv, coeffs, None, e, is_step,
                                                  panels, out, design=design, grid=grid)

    plain = [
        mock.patch.object(decision_kernel, "decision_update_moments",
                          lambda *a, out=None: decision_kernel.decision_update_moments_plain(*a)),
        mock.patch.object(decision_kernel, "decision_update",
                          lambda *a, out=None: decision_kernel.decision_update_plain(*a)),
        mock.patch.object(forward_kernel, "forward_sweep", forward_kernel.forward_sweep_plain),
        mock.patch.object(forward_kernel, "forward_sweep_design", design_plain),
    ]
    with contextlib.ExitStack() as stack:
        for patch in plain:
            stack.enter_context(patch)
        yield


def measure_f64(pkg, device):
    """The pinned f64 answers: the kernels' plain versions in f64 on the
    card, on the f32 draws of the headline case cast to f64."""
    import torch

    from storage_tpu_torch import grid as gridmod
    from storage_tpu_torch.basis import parse_basis_functions
    from storage_tpu_torch.engines import lsmc as engine
    from storage_tpu_torch.engines.intrinsic import intrinsic_plain
    from storage_tpu_torch.models import spot_sim

    inputs, sim_in, _, monomials = engine_inputs(pkg, device)
    arrays = engine.build_engine_arrays(
        inputs.compiled, inputs.fwd, inputs.df_settle, inputs.df_flow, inputs.inventory_lower,
        inputs.inventory_upper, NUM_GRID, torch.float64, device,
    )
    tfn = inputs.compiled.terminal_value
    ids = torch.arange(NUM_SIMS, device=device)
    reg, val = (spot_sim.simulate_ou_paths(spot_sim.key_from_seed(k), ids, *sim_in)
                for k in (11, 13))
    f64 = lambda x: x.to(torch.float64)  # noqa: E731
    with plain_versions():
        npvs = {}
        for snap in (True, False):
            out = engine.lsmc_core(arrays, f64(reg.spot), f64(reg.factors), f64(val.spot),
                                   f64(val.factors), 100.0, monomials, 0, False, tfn, False,
                                   snap_interp=snap)
            npvs[f"F64_NPV[{snap}]"] = float(out["npv"])
        spot_monomials = tuple(parse_basis_functions(SPOT_BASIS))
        out = engine.lsmc_core(arrays, f64(reg.spot), f64(reg.factors[:, :0]), f64(val.spot),
                               f64(val.factors[:, :0]), 100.0, spot_monomials, 0, False, tfn,
                               False, snap_interp=True)
        npvs["F64_SPOT_NPV"] = float(out["npv"])
        npvs["F64_INTRINSIC_NPV"] = float(intrinsic_plain(arrays, 100.0, 0, tfn, False).npv)
        custom = engine.build_engine_arrays(
            inputs.compiled, inputs.fwd, inputs.df_settle, inputs.df_flow,
            inputs.inventory_lower, inputs.inventory_upper, NUM_GRID, torch.float64, device,
            gridmod.inventory_grids_custom(inputs.inventory_lower, inputs.inventory_upper,
                                           bunched_grid))
        out = engine.lsmc_core(custom, f64(reg.spot), f64(reg.factors), f64(val.spot),
                               f64(val.factors), 100.0, monomials, 0, False, tfn, False,
                               snap_interp=True, uniform_grids=False)
        npvs["F64_CUSTOM_NPV"] = float(out["npv"])
        # The caps phase's valuations: BASIS_20 on the headline's paths, and
        # the 10-factor model's paths (seeds 11/13) with BASIS_10F; both take
        # the design in memory.
        out = engine.lsmc_core(arrays, f64(reg.spot), f64(reg.factors), f64(val.spot),
                               f64(val.factors), 100.0, tuple(parse_basis_functions(BASIS_20)), 0,
                               False, tfn, False, snap_interp=True)
        npvs["F64_CAPS_NPV[basis_20]"] = float(out["npv"])
        del reg, val
        _, sim10 = ten_factor_inputs(pkg, device)
        reg, val = (spot_sim.simulate_ou_paths(spot_sim.key_from_seed(k), ids, *sim10)
                    for k in (11, 13))
        out = engine.lsmc_core(arrays, f64(reg.spot), f64(reg.factors), f64(val.spot),
                               f64(val.factors), 100.0, tuple(parse_basis_functions(BASIS_10F)), 0,
                               False, tfn, False, snap_interp=True)
        npvs["F64_CAPS_NPV[factors_10]"] = float(out["npv"])
    return npvs


class LaunchCounts:
    """The kernels' launch counters: reset, read, and the expected counts of
    a path (every kernel it does not name at 0).  An entry is a wrapper (its
    ``launches``, under its name) or (name, wrapper, counter attribute)."""

    def __init__(self, fns):
        self.entries = [fn if isinstance(fn, tuple) else (fn.__name__, fn, "launches")
                        for fn in fns]

    def reset(self):
        for _, fn, attr in self.entries:
            setattr(fn, attr, 0)

    def read(self):
        return {name: getattr(fn, attr) for name, fn, attr in self.entries}

    def expect(self, **counts):
        return {name: counts.get(name, 0) for name, _, _ in self.entries}


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


# The multi-GPU phase: the headline's paths split over a process group, one
# rank a card (``parallel.mesh``).  A rank's share of the headline, and the
# f64 path count of the two-rank check.
MULTI_WORLD = 2
MULTI_SIMS = NUM_SIMS // MULTI_WORLD
F64_MULTI_SIMS = 16_384
# The wall limit of the phase (the two ranks' subprocesses are killed past
# RANK_TIMEOUT_S).
MULTI_PHASE_LIMIT_S = 90.0
RANK_TIMEOUT_S = 240.0


def launch_counts():
    """The kernels' launch counters (``LaunchCounts``) of every path."""
    from storage_tpu_torch.ops import (decision_kernel, forward_kernel, intrinsic_kernel,
                                       rng_kernel, tree_kernel)

    return LaunchCounts((rng_kernel.simulate_sweep, rng_kernel.normal_halves,
                         decision_kernel.decision_update_moments,
                         forward_kernel.forward_sweep, decision_kernel.decision_update,
                         decision_kernel.decision_update_fullstep, decision_kernel.pack_records,
                         intrinsic_kernel.intrinsic_dp,
                         tree_kernel.tree_dp,
                         ("tree_dp_steps", tree_kernel.tree_dp, "step_launches"),
                         # The DPs' large routes, counted in intrinsic_dp's launches too.
                         ("intrinsic_dp_large", intrinsic_kernel.intrinsic_dp, "large_launches"),
                         ("tree_dp_large", tree_kernel.tree_dp, "large_launches"),
                         forward_kernel.forward_sweep_design,
                         forward_kernel.forward_sweep_vjp, forward_kernel.general_tail,
                         ("forward_sweep_general", forward_kernel.forward_sweep,
                          "general_launches"),
                         ("forward_sweep_design_general", forward_kernel.forward_sweep_design,
                          "general_launches"),
                         # The large grid routes' launches, counted in the wrappers' too.
                         *((f"{fn.__name__}_large", fn, "large_launches") for fn in (
                             decision_kernel.decision_update_moments,
                             decision_kernel.decision_update,
                             decision_kernel.decision_update_fullstep,
                             forward_kernel.forward_sweep, forward_kernel.forward_sweep_design)),
                         # Kernel E's wide route, counted in its launches too, and
                         # the wide route's shared row, counted in those too; the
                         # same of kernel B, and C's monomial mode's wide route.
                         ("decision_update_fullstep_wide", decision_kernel.decision_update_fullstep,
                          "wide_launches"),
                         ("decision_update_fullstep_wide_smem",
                          decision_kernel.decision_update_fullstep, "wide_smem_launches"),
                         ("decision_update_moments_wide", decision_kernel.decision_update_moments,
                          "wide_launches"),
                         ("decision_update_moments_wide_smem",
                          decision_kernel.decision_update_moments, "wide_smem_launches"),
                         ("forward_sweep_wide", forward_kernel.forward_sweep, "wide_launches")))


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def f64_route_npv(pkg, device, num_sims: int, mesh) -> tuple:
    """(NPV, SE) of the headline by the ``--f64`` route at ``num_sims``
    paths: the f32 draws of seeds 11/13 cast to f64 and the kernels' plain
    versions in f64 on the card, over this rank's block of the paths in
    ``mesh`` (``parallel.mesh.lsmc_core_from_sims``; None: all of them)."""
    import torch

    from storage_tpu_torch.engines import lsmc as engine
    from storage_tpu_torch.models import spot_sim
    from storage_tpu_torch.parallel import mesh as pmesh

    inputs, sim_in, _, monomials = engine_inputs(pkg, device)
    arrays = engine.build_engine_arrays(
        inputs.compiled, inputs.fwd, inputs.df_settle, inputs.df_flow, inputs.inventory_lower,
        inputs.inventory_upper, NUM_GRID, torch.float64, device)
    ids = pmesh.path_ids(num_sims, mesh, device)
    reg, val = (spot_sim.simulate_ou_paths(spot_sim.key_from_seed(k), ids, *sim_in)
                for k in (11, 13))
    f64 = lambda x: x.to(torch.float64)  # noqa: E731
    with plain_versions():
        out = pmesh.lsmc_core_from_sims(
            arrays, f64(reg.spot), f64(reg.factors), f64(val.spot), f64(val.factors), 100.0,
            monomials, 0, False, inputs.compiled.terminal_value, False, mesh=mesh,
            snap_interp=True)
    return float(out["npv"]), float(out["standard_error"])


def result_digest(res) -> str:
    """A digest of a result's reduced outputs: NPV, SE, intrinsic value,
    deltas, expected profile and trigger prices, as f64 bytes."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for a in (res.npv, res.val_sim_standard_error, res.intrinsic_npv, res.deltas.to_numpy(),
              res.expected_profile.to_numpy(), res.trigger_prices.to_numpy()):
        h.update(np.ascontiguousarray(a, dtype=np.float64).tobytes())
    return h.hexdigest()


def panel_digest(panel) -> str:
    """A digest of a [P, S] panel's f32 values (the frames hold them in
    f64, exactly)."""
    import hashlib

    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(panel, dtype=np.float32).tobytes()).hexdigest()


def rank_main(argv) -> int:
    """One rank of the multi-GPU phase: ``chip_smoke.py --rank r world port
    backend report.json``.  Forms the group (gloo with every rank on card 0,
    or NCCL a card a rank), uses the parent's kernel library, and values
    the headline through the API on its share of the paths: warm-up, three
    timed runs (the first counted: launches, plain-version calls, peak
    memory), one with every collective bracketed by synchronisations (its
    count and seconds), the adjoint, the streamed route (the threshold
    0), the ``--f64`` route at 16,384 paths, then ``value_from_sims_host_local``
    on its half of the round trip's paths (regenerated by the sweep: their
    spot digests go to the parent) with the factors and on the spot alone.
    Writes its report as JSON; every check across ranks is the parent's."""
    import datetime

    import numpy as np
    import pandas as pd
    import torch
    import torch.distributed as dist

    rank, world, port, backend, report_path = int(argv[0]), int(argv[1]), argv[2], argv[3], argv[4]
    sys.path.insert(0, str(REPO))
    import storage_tpu_torch as stt
    from storage_tpu_torch.engines import intrinsic as intrinsic_engine
    from storage_tpu_torch.models import spot_sim
    from storage_tpu_torch.ops import _build, decision_kernel, forward_kernel, rng_kernel
    from storage_tpu_torch.parallel import distributed as pdist
    from storage_tpu_torch.parallel import mesh as pmesh

    # The host's cores shared between the ranks' intra-op threads.
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    prebuilt = _build.library_path().exists()
    index = rank if backend == "nccl" else 0
    t_start = time.perf_counter()
    pdist.initialize(f"localhost:{port}", world, rank, local_device_ids=[index], backend=backend,
                     timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    device = torch.device("cuda", index)
    mesh = pmesh.make_mesh()
    report = dict(rank=rank, backend=backend, device=str(device), library_prebuilt=prebuilt,
                  group_s=time.perf_counter() - t_start)
    counts = launch_counts()
    plain = {}
    for module, name in ((rng_kernel, "simulate_sweep_plain"),
                         (decision_kernel, "decision_update_moments_plain"),
                         (decision_kernel, "decision_update_plain"),
                         (forward_kernel, "forward_sweep_plain"),
                         (forward_kernel, "forward_sweep_vjp_plain"),
                         (intrinsic_engine, "intrinsic_plain")):
        def counted(*a, _inner=getattr(module, name), _name=name, **k):
            plain[_name] += 1
            return _inner(*a, **k)

        plain[name] = 0
        setattr(module, name, counted)

    def timed_value(**kwargs):
        dist.barrier()
        t0 = time.perf_counter()
        res = value(stt, device, True, **kwargs)
        torch.cuda.synchronize(device)
        return res, time.perf_counter() - t0

    value(stt, device, True)  # warm-up: this process's first valuation
    torch.cuda.synchronize(device)
    walls = []
    for i in range(3):
        if i == 0:
            counts.reset()
            plain.update(dict.fromkeys(plain, 0))
            torch.cuda.reset_peak_memory_stats(device)
        res, wall = timed_value()
        walls.append(wall)
        if i == 0:
            report.update(launches=counts.read(), plain_calls=dict(plain),
                          peak_gb=torch.cuda.max_memory_allocated(device) / 1e9)
    report.update(npv=res.npv, se=res.val_sim_standard_error, walls_s=walls,
                  wall_s=float(np.median(walls)), digest=result_digest(res))
    log(f"rank {rank}: group {report['group_s']:.1f} s, headline walls {walls}")

    # Every collective bracketed by synchronisations: their count and time
    # (waits for the other rank included) beside the run's wall.
    spans, originals = [], {n: getattr(dist, n) for n in ("all_reduce", "all_gather", "broadcast")}

    def bracketed(fn):
        def run(*a, **k):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize(device)
            spans.append(time.perf_counter() - t0)
            return out
        return run

    for n, fn in originals.items():
        setattr(dist, n, bracketed(fn))
    try:
        res_c, wall_c = timed_value()
    finally:
        for n, fn in originals.items():
            setattr(dist, n, fn)
    report.update(collectives=len(spans), collectives_s=sum(spans), instrumented_wall_s=wall_c,
                  instrumented_digest=result_digest(res_c))

    counts.reset()
    res_a, wall_a = timed_value(deltas_method="adjoint")
    report["adjoint"] = dict(npv=res_a.npv, wall_s=wall_a, launches=counts.read(),
                             digest=result_digest(res_a))

    saved = pmesh.stream_threshold
    pmesh.stream_threshold = lambda device: 0
    try:
        counts.reset()
        res_s, wall_s = timed_value()
    finally:
        pmesh.stream_threshold = saved
    report["streamed"] = dict(npv=res_s.npv, wall_s=wall_s, launches=counts.read(),
                              digest=result_digest(res_s))

    t0 = time.perf_counter()
    npv64, se64 = f64_route_npv(stt, device, F64_MULTI_SIMS, mesh)
    report["f64"] = dict(npv=npv64, se=se64, wall_s=time.perf_counter() - t0)
    log(f"rank {rank}: adjoint {wall_a:.3f} s, streamed {wall_s:.3f} s, f64 route "
        f"{report['f64']['wall_s']:.3f} s")

    # This rank's half of the round trip's paths as frames, fed to the
    # host-local entry point (3 factors), then their spot alone.
    inputs, sim_in, _, _ = engine_inputs(stt, device)
    ids = pmesh.path_ids(NUM_SIMS, mesh, device)
    frames, digests = [], []
    for seed in (11, 13):
        paths = spot_sim.simulate_ou_paths(spot_sim.key_from_seed(seed), ids, *sim_in)
        spot, factors = paths.spot.cpu().numpy(), paths.factors.cpu().numpy()
        digests.append(panel_digest(spot))
        frames.append((pd.DataFrame(spot, index=inputs.periods),
                       [pd.DataFrame(factors[:, i], index=inputs.periods) for i in range(3)]))
        del paths
    storage, start, fwd = bench_case(stt)
    for name, basis, with_factors in (("host_local", BASIS, True),
                                      ("host_local_spot", SPOT_BASIS, False)):
        counts.reset()
        dist.barrier()
        t0 = time.perf_counter()
        res_h = stt.value_from_sims_host_local(
            storage, start, 100.0, fwd, 0.02, None, frames[0][0], frames[1][0], basis, False,
            sim_factors_regress=frames[0][1] if with_factors else None,
            sim_factors_valuation=frames[1][1] if with_factors else None,
            num_inventory_grid_points=NUM_GRID, dtype=torch.float32, device=device,
            snap_interp=True)
        torch.cuda.synchronize(device)
        report[name] = dict(npv=res_h.npv, se=res_h.val_sim_standard_error,
                            wall_s=time.perf_counter() - t0, launches=counts.read(),
                            digest=result_digest(res_h), spot_digests=digests)
    dist.barrier()
    dist.destroy_process_group()
    report["rank_s"] = time.perf_counter() - t_start
    Path(report_path).write_text(json.dumps(report, indent=1, default=float))
    log(f"rank {rank}: done in {report['rank_s']:.1f} s")
    return 0


def rank_share_kernel_ms(pkg, device, src) -> dict:
    """Each kernel of the sharded path, ms a launch by CUDA events around each
    launch (``launches_ms``) over a valuation through the API, alone on the
    card, at a rank's share (131,072 paths) and, measured the same way in
    the same call, at the whole headline's 262,144: {kernel: {paths: ms}}.
    A, B, C and the VJP over an adjoint valuation; kernel D's on the
    spot-only path over the round trip's spot frames (the first half for a
    rank's share)."""
    from storage_tpu_torch.ops import decision_kernel, forward_kernel, rng_kernel

    out = {}
    for sims in (MULTI_SIMS, NUM_SIMS):
        frames = [frame.iloc[:, :sims] for frame in (src.sim_spot_regress,
                                                      src.sim_spot_valuation)]
        timed = launches_ms(
            [(rng_kernel, "simulate_sweep"), (decision_kernel, "decision_update_moments"),
             (forward_kernel, "forward_sweep"), (forward_kernel, "forward_sweep_vjp")],
            lambda: value(pkg, device, True, num_sims=sims, deltas_method="adjoint"), 2)
        timed.update(launches_ms([(decision_kernel, "decision_update")],
                                 lambda: value_from_frames(pkg, device, *frames, SPOT_BASIS), 1))
        for name, (ms, calls) in timed.items():
            out.setdefault(name, {})[sims] = ms / calls
    return out


def multi_gpu_phase(pkg, device, counts, main, src, from_sims, spot_only, card) -> dict:
    """(a) A one-rank NCCL group in this process: the headline through the
    API the main path's bits.  (b) Two ranks in subprocesses (``rank_main``;
    NCCL on two cards where there are two, else gloo with both on card 0),
    each PASS or FAIL: the headline within 0.05 SE of (a), every reduced
    output the same bits on both ranks (pathwise, adjoint, streamed,
    host-local), A 2 / B 365 / C 1 launches a rank and no plain version;
    streamed the materialised bits; the ``--f64`` route at 16,384 paths
    within 1e-9 of one rank's; ``value_from_sims_host_local`` on the round
    trip's halves (their spot digests checked against its frames) within
    0.05 SE of the single process's ``value_from_sims``, and on their spot
    alone (kernel D) within 0.1 SE of the spot-only f64 answer, as the
    one-process spot-only path.  Kernel times at a rank's
    share are taken in this process, alone on the card."""
    import datetime

    import torch
    import torch.distributed as dist

    from storage_tpu_torch.parallel import distributed as pdist

    t_phase = time.perf_counter()
    report = {}
    # (a) A group of one: the reducer takes no collective.
    pdist.initialize(f"localhost:{free_port()}", 1, 0, local_device_ids=[device.index or 0],
                     backend="nccl", timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        counts.reset()
        t0 = time.perf_counter()
        one = value(pkg, device, True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts.read()
    finally:
        dist.destroy_process_group()
    same = same_bits(one, main)
    expected = counts.expect(simulate_sweep=2, decision_update_moments=NUM_STEPS, forward_sweep=1,
                             intrinsic_dp=1)
    log(f"multi-GPU (a), a one-rank NCCL group: NPV {one.npv!r} SE {one.val_sim_standard_error!r}; "
        f"the main path's NPV, SE, deltas and profile bits: {same}; wall {wall:.4f} s; launches "
        f"{launches} [{card}]")
    if not same or launches != expected:
        raise AssertionError("a group of one parts from the main path")
    report["group_of_one"] = dict(npv=one.npv, se=one.val_sim_standard_error, same_bits=same,
                                  wall_s=wall, launches=launches)

    npv64, se64 = f64_route_npv(pkg, device, F64_MULTI_SIMS, None)
    report["rank_share_ms"] = rank_share_kernel_ms(pkg, device, src)
    log("multi-GPU kernel ms a launch inside a valuation, alone on the card, at a rank's share "
        f"({MULTI_SIMS} paths) and at {NUM_SIMS}: " + ", ".join(
            f"{k} {v[MULTI_SIMS]:.4f} / {v[NUM_SIMS]:.4f}"
            for k, v in report["rank_share_ms"].items()) + f" [{card}]")
    want_digests = [[panel_digest(frame.to_numpy()[:, r * MULTI_SIMS:(r + 1) * MULTI_SIMS])
                     for frame in (src.sim_spot_regress, src.sim_spot_valuation)]
                    for r in range(MULTI_WORLD)]

    # (b) Two ranks in subprocesses.
    torch.cuda.empty_cache()
    backend = "nccl" if torch.cuda.device_count() >= MULTI_WORLD else "gloo"
    port = free_port()
    paths = [OUT / f"rank{r}.json" for r in range(MULTI_WORLD)]
    for p in paths:
        p.unlink(missing_ok=True)
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        logs = [stack.enter_context(open(OUT / f"rank{r}.log", "w")) for r in range(MULTI_WORLD)]
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--rank", str(r), str(MULTI_WORLD),
             str(port), backend, str(paths[r])], stdout=logs[r], stderr=subprocess.STDOUT,
            cwd=str(REPO)) for r in range(MULTI_WORLD)]
        try:
            for proc in procs:
                proc.wait(timeout=max(1.0, RANK_TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            for proc in procs:
                proc.kill()
                proc.wait()
    ranks_s = time.perf_counter() - t0
    reports, failures = [], []
    for r, proc in enumerate(procs):
        if proc.returncode == 0 and paths[r].exists():
            reports.append(json.loads(paths[r].read_text()))
        else:
            reports.append(None)
            tail = (OUT / f"rank{r}.log").read_text()[-3000:]
            failures.append(f"rank {r} exited {proc.returncode}:\n{tail}")
    if failures:
        for r in range(MULTI_WORLD):
            log(f"multi-GPU rank {r} ({backend}): FAIL")
        raise AssertionError("multi-GPU ranks failed: " + "\n".join(failures))

    r0 = reports[0]
    se_one = one.val_sim_standard_error
    agree = {key: len({(rep[key] if key == "digest" else rep[key]["digest"]) for rep in reports})
             == 1 for key in ("digest", "adjoint", "streamed", "host_local", "host_local_spot")}
    agree["f64"] = len({rep["f64"]["npv"] for rep in reports}) == 1
    cross = dict(
        npv_gap_se=(r0["npv"] - one.npv) / se_one,
        f64_rel=abs(r0["f64"]["npv"] - npv64) / abs(npv64),
        host_local_gap_se=(r0["host_local"]["npv"] - from_sims.npv)
        / from_sims.val_sim_standard_error,
        spot_off_f64_se=(r0["host_local_spot"]["npv"] - F64_SPOT_NPV)
        / r0["host_local_spot"]["se"],
        streamed_same=r0["streamed"]["digest"] == r0["digest"],
        instrumented_same=r0["instrumented_digest"] == r0["digest"],
        adjoint_npv_same=r0["adjoint"]["npv"] == r0["npv"])
    cross_ok = (all(agree.values()) and abs(cross["npv_gap_se"]) <= 0.05
                and cross["f64_rel"] <= 1e-9 and abs(cross["host_local_gap_se"]) <= 0.05
                and abs(cross["spot_off_f64_se"]) <= 0.1 and cross["streamed_same"]
                and cross["instrumented_same"] and cross["adjoint_npv_same"])
    want = dict(main=counts.expect(simulate_sweep=2, decision_update_moments=NUM_STEPS,
                                   forward_sweep=1, intrinsic_dp=1),
                adjoint=counts.expect(simulate_sweep=2, decision_update_moments=NUM_STEPS,
                                      forward_sweep=1, intrinsic_dp=1, forward_sweep_vjp=1),
                streamed=counts.expect(simulate_sweep=3 * segments(NUM_STEPS),
                                       decision_update_moments=NUM_STEPS,
                                       forward_sweep=segments(NUM_STEPS), intrinsic_dp=1),
                host_local=counts.expect(decision_update_moments=NUM_STEPS, forward_sweep=1,
                                         intrinsic_dp=1),
                host_local_spot=counts.expect(decision_update=NUM_STEPS,
                                              pack_records=NUM_STEPS, forward_sweep=1,
                                              intrinsic_dp=1))
    ok_all = cross_ok
    for r, rep in enumerate(reports):
        rank_ok = (cross_ok and rep["library_prebuilt"] and rep["launches"] == want["main"]
                   and not any(rep["plain_calls"].values())
                   and all(rep[k]["launches"] == want[k]
                           for k in ("adjoint", "streamed", "host_local", "host_local_spot"))
                   and rep["host_local"]["spot_digests"] == want_digests[r])
        ok_all = ok_all and rank_ok
        log(f"multi-GPU rank {r} ({backend}, {rep['device']}): {'PASS' if rank_ok else 'FAIL'}: "
            f"NPV {rep['npv']!r} SE {rep['se']!r}; wall median {rep['wall_s']:.4f} s of "
            f"{[round(w, 4) for w in rep['walls_s']]}; peak device memory {rep['peak_gb']:.2f} GB; "
            f"{rep['collectives']} collectives {rep['collectives_s']:.4f} s of an instrumented "
            f"wall {rep['instrumented_wall_s']:.4f} s; adjoint {rep['adjoint']['wall_s']:.4f} s, "
            f"streamed {rep['streamed']['wall_s']:.4f} s, f64 route {rep['f64']['wall_s']:.2f} s, "
            f"host-local {rep['host_local']['wall_s']:.2f} s; launches {rep['launches']}, plain "
            f"calls {sum(rep['plain_calls'].values())}; library prebuilt {rep['library_prebuilt']}; "
            f"spot digests of the round trip's half: "
            f"{rep['host_local']['spot_digests'] == want_digests[r]} [{card}]")
    log(f"multi-GPU (b), {MULTI_WORLD} ranks on {backend}: ranks agree {agree}; NPV "
        f"{cross['npv_gap_se']:+.4f} SE from (a) (tolerance 0.05); f64 route at {F64_MULTI_SIMS} "
        f"paths {r0['f64']['npv']!r} against one rank's {npv64!r}, rel {cross['f64_rel']:.2e} "
        f"(tolerance 1e-9); streamed the materialised bits {cross['streamed_same']}; host-local "
        f"{r0['host_local']['npv']!r}, {cross['host_local_gap_se']:+.4f} SE from value_from_sims "
        f"{from_sims.npv!r} (tolerance 0.05); spot alone {r0['host_local_spot']['npv']!r}, "
        f"{cross['spot_off_f64_se']:+.4f} SE from its f64 answer {F64_SPOT_NPV} (tolerance 0.1, "
        f"the spot-only path's; the one-process run {spot_only['npv']!r}); ranks "
        f"{ranks_s:.1f} s")
    phase_s = time.perf_counter() - t_phase
    log(f"multi-GPU phase: {phase_s:.1f} s (limit {MULTI_PHASE_LIMIT_S:.0f})")
    if not ok_all:
        raise AssertionError("the multi-GPU phase failed")
    report.update(backend=backend, ranks=reports, cross=cross, agree=agree, ranks_s=ranks_s,
                  phase_s=phase_s, one_rank_f64=dict(npv=npv64, se=se64))
    return report


def main(argv) -> int:
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
    if argv[1:2] == ["--rank"]:
        return rank_main(argv[2:])

    import numpy as np

    import storage_tpu_torch as stt
    from storage_tpu_torch import grid as gridmod
    from storage_tpu_torch.engines import lsmc as engine
    from storage_tpu_torch.ops import _build

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

    if argv[1:] == ["--f64"]:
        log(json.dumps(measure_f64(stt, device)))
        return 0
    if argv[1:]:
        print(f"chip_smoke: unknown arguments {argv[1:]}", file=sys.stderr)
        return 2

    counts = launch_counts()

    # ---- kernels against their plain versions.
    with engine.full_f32_matmul():
        kernels = check_kernels(stt, device)
    kernels["intrinsic_dp"] = check_intrinsic(stt, device)
    # The tree: its kernel checks, then its paths through the API.
    t0 = time.perf_counter()
    kernels["tree_dp"] = check_tree(stt, device, counts)
    kernels["tree_dp_steps"] = kernels["tree_dp"].pop("steps")
    report["tree_phase_s"] = time.perf_counter() - t0
    log(f"tree phase: {report['tree_phase_s']:.1f} s")
    report["kernels"] = kernels

    # ---- the main path through the public API.
    value(stt, device, snap_interp=True)  # warm-up
    torch.cuda.synchronize()
    counts.reset()
    gridmod._native_inventory_space.launches = 0
    t0 = time.perf_counter()
    res = value(stt, device, snap_interp=True)
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    launches = counts.read()
    native_band_calls = gridmod._native_inventory_space.launches
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
    expected = counts.expect(simulate_sweep=2, decision_update_moments=NUM_STEPS,
                             forward_sweep=1, intrinsic_dp=1)
    if launches != expected:
        raise AssertionError(f"launch counts {launches}, expected {expected}")
    if (res.npv, res.val_sim_standard_error) != (MAIN_NPV, MAIN_SE):
        raise AssertionError(f"main path NPV {res.npv!r} SE {res.val_sim_standard_error!r}, not "
                             f"the pinned bits {MAIN_NPV!r} {MAIN_SE!r}")
    intrinsic_rel = abs(res.intrinsic_npv - F64_INTRINSIC_NPV) / F64_INTRINSIC_NPV
    log(f"main path intrinsic value: {res.intrinsic_npv!r} (f64 plain answer {F64_INTRINSIC_NPV!r}, "
        f"rel {intrinsic_rel:.2e}, tolerance 1e-5); the DP kernel launched "
        f"{launches['intrinsic_dp']} time(s) in the valuation")
    if not intrinsic_rel <= 1e-5:
        raise AssertionError(f"intrinsic NPV {res.intrinsic_npv} is not within 1e-5 of "
                             f"{F64_INTRINSIC_NPV}")
    if res.intrinsic_profile.shape != (NUM_STEPS + 1, 6) or not np.isfinite(
            res.intrinsic_profile.to_numpy()).all():
        raise AssertionError("the intrinsic profile does not match the facility")
    deltas = res.deltas.to_numpy()
    profile = res.expected_profile.to_numpy()
    if deltas.shape != (NUM_STEPS + 1,) or profile.shape != (NUM_STEPS + 1, 6):
        raise AssertionError("result shapes do not match the facility")
    if not (np.isfinite(deltas).all() and np.isfinite(profile).all()):
        raise AssertionError("non-finite deltas or profile")
    report["main_path"] = dict(npv=res.npv, se=res.val_sim_standard_error, wall_s=wall,
                               walls_s=walls, paths_steps_per_s=rate, z_vs_reference=z,
                               launches=dict(launches), intrinsic_npv=res.intrinsic_npv,
                               intrinsic_rel_err=intrinsic_rel)

    res_default = value(stt, device, snap_interp=False)
    torch.cuda.synchronize()
    z2 = check_npv(res_default.npv, res_default.val_sim_standard_error, snap_interp=False)
    log(f"main path (snap_interp=False, the port's default): NPV {res_default.npv!r} "
        f"SE {res_default.val_sim_standard_error!r} (z = {z2:+.3f})")
    report["main_path_default"] = dict(npv=res_default.npv, se=res_default.val_sim_standard_error)

    with engine.full_f32_matmul():
        npv_t, se_t, launches_t = tpu_numerics_valuation(stt, device, counts)
    torch.cuda.synchronize()
    z_t = (npv_t - REFERENCE_NPV) / se_t
    log(f"with the TPU run's numerics (bf16 inputs of L·z, u-coordinate moments): "
        f"NPV {npv_t!r} SE {se_t!r} (reference {REFERENCE_NPV}, z = {z_t:+.4f}, tolerance 0.1); "
        f"launches {launches_t}")
    if not (math.isfinite(npv_t) and abs(z_t) <= 0.1):
        raise AssertionError(f"NPV {npv_t} is not within 0.1 SE of {REFERENCE_NPV}")
    report["tpu_numerics"] = dict(npv=npv_t, se=se_t, z_vs_reference=z_t, launches=launches_t)
    report["antithetic"] = antithetic_valuation(stt, device, counts, res)

    # ---- user-supplied simulations and the full-step backward.
    src, from_sims, report["round_trip"] = round_trip(stt, device, counts, res.npv)
    report["spot_only"] = spot_only_valuation(stt, device, counts, src, res)
    launches.update(decision_update=report["spot_only"]["launches"]["decision_update"])

    # ---- the grids phase: G = 4,096, past every kernel's shared-memory
    # route (the round trip's spot panels feed its value_from_sims).
    t0 = time.perf_counter()
    grid_kernels, report["grids"] = grids_phase(stt, device, counts, src, res)
    report["grids_phase_s"] = time.perf_counter() - t0
    log(f"grids phase: {report['grids_phase_s']:.1f} s")
    kernels.update(grid_kernels)
    grids = report["grids"]
    launches.update(
        decision_update_moments_large=grids["headline"]["launches"]["decision_update_moments_large"],
        decision_update_large=grids["spot_only"]["launches"]["decision_update_large"],
        pack_records=grids["spot_only"]["launches"]["pack_records"],
        decision_update_fullstep_large=grids["fullstep"]["launches"][
            "decision_update_fullstep_large"],
        forward_sweep_large=grids["headline"]["launches"]["forward_sweep_large"],
        forward_sweep_design_large=grids["generic"]["launches"]["forward_sweep_design_large"],
        forward_sweep_general_large=grids["custom_grid"]["launches"]["forward_sweep_large"])
    kernels["decision_update_large"]["b9_launches"] = grids["generic"]["launches"][
        "decision_update_large"]

    # ---- the DP grids phase: the intrinsic DP and the tree past their
    # shared routes.
    t0 = time.perf_counter()
    dp_kernels, report["dp_grids"] = dp_grids_phase(stt, device, counts)
    report["dp_grids_phase_s"] = time.perf_counter() - t0
    log(f"dp_grids phase: {report['dp_grids_phase_s']:.1f} s")
    kernels.update(dp_kernels)
    dp_api = report["dp_grids"]["api"]
    launches.update(
        intrinsic_dp_large=dp_api["intrinsic_value_f32_32768"]["launches"]["intrinsic_dp_large"],
        tree_dp_large=dp_api["trinomial_value_f32_65536"]["launches"]["tree_dp_large"])

    # ---- the streamed engine (the round trip's frames feed its host-fed check).
    t0 = time.perf_counter()
    report["streaming"] = streaming_phase(stt, device, counts, res, src, from_sims, card)
    report["streaming_phase_s"] = time.perf_counter() - t0
    log(f"streaming phase: {report['streaming_phase_s']:.1f} s")
    # ---- the paths split over a process group (the round trip's frames
    # again, for the host-local entry point).
    report["multi_gpu"] = multi_gpu_phase(stt, device, counts, res, src, from_sims,
                                          report["spot_only"], card)
    del src, from_sims
    streamed = report["streaming"]["headline"]
    kernels["simulate_sweep"].update(
        {k: report["streaming"]["resumed_sweep"][k] for k in ("resumed_ms", "resumed_bound_ms")},
        streamed_launches=streamed["streamed_launches"]["simulate_sweep"])
    kernels["forward_sweep"]["streamed_launches"] = streamed["streamed_launches"]["forward_sweep"]
    report["fullstep"] = fullstep_valuation(stt, device, counts, res)
    launches.update(
        decision_update_fullstep=report["fullstep"]["launches"]["decision_update_fullstep"])

    # ---- the public host layer: generic bases, the builder, the simulator.
    t0 = time.perf_counter()
    with engine.full_f32_matmul():
        kernels["forward_sweep_design"] = check_design_mode(stt, device)
    report["host_layer"] = host_layer_phase(stt, device, counts, res, res_default)
    report["host_layer_phase_s"] = time.perf_counter() - t0
    log(f"host-layer phase: {report['host_layer_phase_s']:.1f} s")
    launches.update(
        forward_sweep_design=report["host_layer"]["replica"]["launches"]["forward_sweep_design"])

    # ---- the caps phase: a 20-term basis and a 10-factor model on kernel B
    # and C's monomial mode past their register caps, the kernels at those
    # sizes.
    t0 = time.perf_counter()
    with engine.full_f32_matmul():
        caps = check_caps(stt, device)
    report["caps"] = caps_valuations(stt, device, counts, report["main_path"])
    report["caps_phase_s"] = time.perf_counter() - t0
    log(f"caps phase: {report['caps_phase_s']:.1f} s")
    report["caps"]["fullstep_wide_checks"] = caps.pop("fullstep_wide_checks")
    caps_launches = {("decision_update_moments_wide", "b20f3"): ("basis_20",
                                                                 "decision_update_moments_wide"),
                     ("decision_update_moments_wide", "b13f10"): ("factors_10",
                                                                  "decision_update_moments_wide"),
                     ("forward_sweep_wide", "b20f3_uniform"): ("basis_20", "forward_sweep_wide"),
                     ("forward_sweep_wide", "b13f10_uniform"): ("factors_10",
                                                                "forward_sweep_wide"),
                     ("simulate_sweep", "f10"): ("factors_10", "simulate_sweep")}
    # Kernel E's wide route: its launches in the full-step valuation of each.
    fullstep_launches = {"b20f3": "basis_20", "b13f10": "factors_10"}
    for name, sizes in caps.items():
        for label, row in sizes.items():
            case = caps_launches.get((name, label))
            row["launches"] = report["caps"][case[0]]["launches"][case[1]] if case else 0
            if name == "decision_update_fullstep_wide" and label in fullstep_launches:
                row["launches"] = report["caps"][fullstep_launches[label]]["fullstep"][
                    "launches"]["decision_update_fullstep_wide"]
    for name, label in (("decision_update_fullstep_wide", "b20f3"),
                        ("decision_update_moments_wide", "b20f3"),
                        ("forward_sweep_wide", "b20f3_uniform")):
        kernels[name] = dict(caps[name][label])
        launches[name] = kernels[name]["launches"]
    report["caps"]["kernels"] = caps

    # ---- adjoint deltas and custom inventory grids.
    t0 = time.perf_counter()
    with engine.full_f32_matmul():
        kernels.update(check_adjoint_kernels(stt, device))
    report["adjoint_grid"] = adjoint_grid_phase(stt, device, counts, res)
    report["adjoint_grid_phase_s"] = time.perf_counter() - t0
    log(f"adjoint and custom-grid phase: {report['adjoint_grid_phase_s']:.1f} s")
    phase = report["adjoint_grid"]
    kernels["forward_sweep_vjp"]["streamed_launches"] = streamed["adjoint_launches"][
        "forward_sweep_vjp"]
    launches.update(
        forward_sweep_vjp=phase["adjoint"]["launches"]["forward_sweep_vjp"],
        forward_sweep_general=phase["custom_grid"]["launches"]["forward_sweep_general"],
        forward_sweep_design_general=phase["custom_grid"]["replica_launches"][
            "forward_sweep_design_general"],
        general_tail=phase["custom_grid"]["launches"]["general_tail"])

    # ---- the native host runtime, interactive runs, checkpoints, the service.
    t0 = time.perf_counter()
    report["service"] = service_phase(stt, device, counts, res)
    report["service_phase_s"] = time.perf_counter() - t0
    log(f"service phase: {report['service_phase_s']:.1f} s")
    # Each kernel's launches on the path that runs it: kernel A's draw-only
    # entry feeds the TPU-numerics emulation alone (the sweep draws for the
    # main path).
    launches.update(normal_halves=launches_t["normal_halves"],
                    tree_dp=kernels["tree_dp"]["launches"],
                    tree_dp_steps=kernels["tree_dp_steps"]["launches"])
    paths = dict(simulate_sweep="main", normal_halves="tpu_numerics",
                 decision_update_moments="main", forward_sweep="main",
                 decision_update="spot_only", decision_update_fullstep="fullstep",
                 intrinsic_dp="main", tree_dp="tree_T3", tree_dp_steps="tree_T5",
                 forward_sweep_design="generic",
                 forward_sweep_vjp="adjoint", forward_sweep_general="custom_grid",
                 forward_sweep_design_general="custom_grid_generic", general_tail="custom_grid",
                 decision_update_moments_large="grid_4096", decision_update_large="grid_4096_spot",
                 pack_records="grid_4096_spot",
                 decision_update_fullstep_large="grid_4096_fullstep",
                 decision_update_fullstep_wide="caps_basis_20_fullstep",
                 decision_update_moments_wide="caps_basis_20", forward_sweep_wide="caps_basis_20",
                 forward_sweep_large="grid_4096", forward_sweep_design_large="grid_4096_generic",
                 forward_sweep_general_large="grid_4096_custom",
                 intrinsic_dp_large="intrinsic_value_32768",
                 tree_dp_large="trinomial_value_t1_65536")

    phases = phase_breakdown(stt, device)
    log(f"phases: host prep {phases['host_prep_s']:.4f} s, simulate {phases['simulate_s']:.4f} s, "
        f"intrinsic {phases['intrinsic_s']:.4f} s, backward {phases['backward_s']:.4f} s, "
        f"forward {phases['forward_s']:.4f} s, peak device memory {phases['peak_memory_gb']:.2f} GB "
        f"[{card}]")
    report["phases"] = phases
    report["profile"] = profile_valuation(stt, device, card)

    # Each kernel of the sharded path: its launches on rank 0 of the
    # two-rank headline (the adjoint's VJP, the host-local spot-only run's
    # D) and its ms a launch at a rank's share, alone on the card.
    rank0 = report["multi_gpu"]["ranks"][0]
    rank_launches = dict(rank0["launches"],
                         forward_sweep_vjp=rank0["adjoint"]["launches"]["forward_sweep_vjp"],
                         decision_update=rank0["host_local_spot"]["launches"]["decision_update"])
    for name in ("simulate_sweep", "decision_update_moments", "forward_sweep", "decision_update",
                 "intrinsic_dp", "forward_sweep_vjp"):
        kernels[name]["rank_launches"] = rank_launches[name]
        kernels[name]["rank_share_ms"] = report["multi_gpu"]["rank_share_ms"].get(name)
    # ``rank_share_ms``: {paths: ms a launch inside a valuation}, at a rank's
    # share and at the headline's paths, measured the same way.
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    # Kernel C's ms is per sweep of all steps, its design mode's the sum of a
    # generic forward pass's chunk launches, the simulation sweep's per path
    # set; their launch reports beside them, and kernel D's.
    extra = {"forward_sweep": ("smem_bytes", "blocks_per_sm", "registers", "sass_instructions",
                               "streamed_launches"),
             "decision_update": ("launch",),
             "simulate_sweep": ("launch", "resumed_ms", "resumed_bound_ms", "streamed_launches"),
             "forward_sweep_design": ("chunk", "ms_per_launch", "ms_one_launch", "chunked_ms",
                                      "monomial_mode_ms", "smem_bytes",
                                      "blocks_per_sm", "registers", "decision_update_b9"),
             "intrinsic_dp": ("ms_f64", "ms_per_step", "kernel_ms", "chain_floor_ms", "launch"),
             "tree_dp": ("ms_f64", "kernel_busy_ms", "dp_route", "cluster_size", "chain_floor_ms",
                         "launch"),
             "tree_dp_steps": ("ms_f64", "kernel_busy_ms", "dp_route", "t3_ms", "t3_ms_f64"),
             "forward_sweep_vjp": ("streamed_launches",),
             "forward_sweep_general": ("uniform_ms", "smem_bytes", "blocks_per_sm", "registers"),
             "forward_sweep_design_general": ("uniform_ms", "smem_bytes", "blocks_per_sm",
                                              "registers"),
             "general_tail": ("grid", "ms_source", "wrapper_ms", "library_wrapper_ms",
                              "big_grid_ms", "big_grid_library_ms", "big_grid_bound_ms",
                              "big_grid_wrapper_ms", "big_grid_library_wrapper_ms",
                              "largest_bracket"),
             "decision_update_moments": ("random_rows_ms", "launch_report"),
             "decision_update_fullstep": ("random_rows_ms",),
             "decision_update_moments_large": ("tile", "band_rows_ms", "smem_bytes",
                                               "blocks_per_sm", "registers", "spill_bytes",
                                               "sass_instructions"),
             "decision_update_large": ("tile", "smem_bytes", "blocks_per_sm", "registers",
                                       "spill_bytes", "b9_ms", "b9_plain_ms", "b9_bound_ms",
                                       "b9_max_abs_err", "b9_blocks_per_sm", "b9_smem_bytes",
                                       "b9_registers", "b9_spill_bytes", "b9_launches"),
             "pack_records": ("b9_ms", "ms_source", "wrapper_ms", "b9_wrapper_ms",
                              "g100_b4_ms", "g100_b9_ms", "g100_b4_bound_ms",
                              "g100_b9_bound_ms"),
             "decision_update_fullstep_large": ("tile", "band_rows_ms", "blocks_per_sm"),
             "decision_update_fullstep_wide": ("B", "F", "body", "grid_route", "tile", "flips",
                                               "smem_bytes", "blocks_per_sm", "registers",
                                               "smem_row_ms"),
             "decision_update_moments_wide": ("B", "F", "body", "grid_route", "tile", "flips",
                                              "smem_bytes", "blocks_per_sm", "registers"),
             "forward_sweep_wide": ("B", "F", "N", "route", "flips", "smem_bytes",
                                    "blocks_per_sm", "registers", "design_mode_same_bits",
                                    "design_mode_launches", "design_mode_ms"),
             "intrinsic_dp_large": ("grid", "ms_f64", "core_ms_f32", "core_ms_f64",
                                    "chain_floor_ms", "grid_link_ns", "block_link_ns", "launch",
                                    "general_10001_f64_bound_ms"),
             "tree_dp_large": ("grid", "ms_f64", "core_ms_f32", "core_ms_f64", "table_bound_ms",
                               "chain_floor_ms", "launch_link_ns", "table_steps", "table_bytes",
                               "launch"),
             **{name: ("steps", "smem_bytes", "blocks_per_sm", "registers") for name in (
                 "forward_sweep_large", "forward_sweep_design_large",
                 "forward_sweep_general_large")}}
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": src_file, "replaces": rep,
         "launches": launches[name], "path": paths[name], **{k: kernels[name][k] for k in keys},
         # No single PyTorch call computes any of these functions but the
         # VJP's (an einsum).
         "library_ms": kernels[name].get("library_ms"),
         **{k: kernels[name][k] for k in extra.get(name, ())},
         **{k: kernels[name][k] for k in ("rank_launches", "rank_share_ms") if k in kernels[name]},
         # The caps phase's sizes (b20_ms, f10_ms, ...: ``check_caps``).
         **{f"{label}_{k}": v_ for label, row in caps.get(name, {}).items()
            for k, v_ in row.items() if k != "checks"}}
        for name, (src_file, rep) in SOURCES.items()
    ]}
    # The C++ band reducer runs on the host: no device bound, no library call.
    band = report["service"]["band"]["headline"]
    summary["kernels"].append({
        "name": "native_band", "route": "host",
        "source": "storage_tpu_torch/native/storage_native.cpp",
        "replaces": "storage_tpu/native/storage_native.cpp:166", "launches": native_band_calls,
        "path": "main", "max_abs_err": band["max_abs_err"], "ms": band["native_ms"],
        "plain_ms": band["python_ms"], "bound_ms": None, "bound_by": None, "library_ms": None,
        "hourly_ms": report["service"]["band"]["hourly"]["native_ms"],
        "hourly_plain_ms": report["service"]["band"]["hourly"]["python_ms"]})
    (OUT / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=float))
    print(json.dumps(summary))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
