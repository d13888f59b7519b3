"""Least-Squares Monte Carlo storage valuation engine (counterpart of the
fused and streamed paths of ``storage_tpu.engines.lsmc``).

* Both passes read their paths from a rows source a segment at a time:
  ``PanelRows`` (materialised panels, views), ``StreamedSims`` (simulated
  paths never materialised: each ``SEG_LEN``-step segment regenerated by
  kernel A's resumed sweep from the factor state entering it, which a
  warmup pass keeps as checkpoints) or ``HostRows`` (user panels in pinned
  host memory, copied a segment at a time).  Every source of the same
  paths gives the same bits.  ``parallel.mesh.footprint_bytes`` and
  ``stream_threshold`` decide, from shapes, when a valuation streams.
* Path-parallel runs (``group``, a ``torch.distributed`` process group with
  one rank per card, ``parallel.mesh``): each rank runs every pass on its
  own block of the paths, and every sum over sims is all-reduced across the
  group (``parallel.reduce``): the design stats, each backward step's
  moments in one buffer, the forward's sums and means.  Every rank then
  holds the same reduced outputs; per-sim panels stay the rank's own.
  Without a group, or in a group of one, nothing is reduced: the same bits.
* Backward induction runs one decision kernel per step (``ops.decision_kernel``):
  argmax on REGRESSED values while realising ACTUAL simulated continuations
  (LsmcStorageValuation.cs:310-336).  With factor panels, kernel B also
  accumulates the next step's regression moments in the same pass.  The
  moments are taken on design columns standardised by each step's exact
  two-pass stats, computed for all steps before the loop — the JAX XLA
  path's normal equations, where the TPU's fused path standardises step t−1
  by step t's stats and loses near-deterministic columns to cancellation.
  Between kernels, tensor code solves the [B, B] system and interpolates the
  coefficients to each (grid point, decision) target; ``fullstep=True`` runs
  kernel E instead, which does that solve on the card too, so a step is E's
  launches alone: for any monomial basis on factor panels, on E's register
  route within 16 terms and 8 factors and its wide route past them
  (``fullstep_body``).  Kernel B likewise takes its register kernels within
  the caps and the same wide body past them, up to 64 terms on any factor
  count (``decision_kernel.moments_plan``), as the JAX package's fused
  kernel takes any monomial basis.  Spot-only panels (no factor,
  ``value_from_sims``) and the shapes of ``design_in_memory`` (a basis with
  a user callable, ``basis.generic``, or of more than the wide route's 64
  terms) take the JAX package's plain body without ``fullstep``: each step
  regresses v on its standardised design (``fit_continuation``) and runs
  kernel D on it.
* The forward pass runs one forward sweep over all steps of materialised
  panels (kernel C, ``ops.forward_kernel``; a launch a segment on another
  source) on an independent valuation-sim set, re-using the
  saved regression (the dual-simulation lower-bound estimator,
  LsmcStorageValuation.cs:352-415), in its monomial mode at any basis of up
  to 64 terms on any factor count (its wide route past 16 terms or 8
  factors); the shapes of ``design_in_memory`` run the sweep's design mode
  on the design built a chunk of steps at a time
  (``forward_kernel.forward_sweep_generic``).  The forward pass produces NPV,
  standard error,
  pathwise deltas (:513-518), expected profiles and trigger prices
  (:523-592); with ``return_sim_data`` kernel C writes its per-sim outputs
  straight into [N, S] panels.
* An interactive run (``segment_cb``, the JAX package's host-chunked
  ``lsmc_core_chunked``) calls back after every 16-step segment of both
  passes: the backward loop between its steps, the forward sweep split into
  a launch a segment, the inventory and PV carried between launches.
* Custom grid rows that are not evenly spaced (``uniform_grids=False``, the
  JAX package's flag) place target inventories by search: the backward's
  interpolation tables by ``interp.interp_weights_general`` (kernels B, D
  and E read only the tables), the forward sweep in kernel C's general-grid
  mode, the trigger prices by ``interp.interp_vector_general``.
* Adjoint deltas (``adjoint=True``, then ``adjoint_deltas``) differentiate
  the pricing run's own forward sweep in the forward curve with the
  regression payload held fixed (the VJP kernel on the volume and fuel rows
  each launch of the sweep wrote), and the terminal value by autograd: no
  second backward pass, and NPV, SE, profiles and triggers stay the pricing
  run's.

Everything that does not depend on the loop carry — decision sets,
interpolation indices and weights, immediate-value coefficients, the forward
kernel's parameter vectors, the trigger prices — is computed for all steps at
once, outside the backward's loop, and nothing in that loop or in the
forward sweep reads a value back to the host.

Known deviations from the reference are those of the JAX package (see its
module docstring): threefry draws, linspace grids, each sim's own terminal
value, the valuation sims' end-period spot for the terminal PV.
"""
from __future__ import annotations

import contextlib
import dataclasses
import typing as tp

import numpy as np
import torch

from .. import grid as gridmod
from ..basis import design_columns, design_matrix, has_generic
from ..facility import CompiledStorage
from ..models import spot_sim
from ..ops import _build, decision_kernel, forward_kernel, interp, intrinsic_kernel
from ..ops.regression import column_stats, fit_continuation, fit_from_moments
from ..parallel import reduce as preduce

NUM_TRIGGER_PRICE_VOLUMES = 10  # LsmcStorageValuation.cs:383
# Steps between progress callbacks of an interactive run (the JAX package's
# ``lsmc_core_chunked`` default), and the segment a streamed pass regenerates
# or copies at a time.
SEG_LEN = 16

_SCALARS = (
    "df_settle", "df_flow", "inj_cost", "wdr_cost", "inj_pcnt", "wdr_pcnt",
    "loss_pcnt", "inv_cost_rate",
)


def design_in_memory(monomials, num_factors: int) -> bool:
    """The shape route, decided from the basis alone, before any
    allocation, simulation or launch, on every device and at any factor
    count (``num_factors`` does not enter): True where the design is built
    in memory, a chunk of steps at a time (the backward runs kernel D on
    each step's design, the forward kernel C's design mode), False where the
    kernels build a monomial design on the card (kernel B or E backward, C's
    monomial mode forward; past 16 terms or 8 factors on their wide routes),
    as the JAX package's fused kernels take any monomial basis.  True for a
    basis with a user callable, and for one of more terms than those
    kernels' wide routes take (``_build.MAX_WIDE_BASIS``).  Not a fallback:
    nothing is tried first.  (Spot-only panels also take kernel D backward,
    the JAX package's plain body, and keep C's monomial mode forward.)"""
    return has_generic(monomials) or len(monomials) > _build.MAX_WIDE_BASIS


def fullstep_body(monomials, num_factors: int, group=None) -> str:
    """Kernel E's body for ``fullstep=True``, decided from the basis, the
    factor count and the group alone, before any allocation, simulation or
    launch, on every device: "register" within the monomial kernels' 16
    terms and 8 factors, past either "wide" (the design row in registers,
    up to ``_build.MAX_WIDE_REGISTER_BASIS`` padded terms) or "wide-smem"
    (in shared memory, up to ``_build.MAX_WIDE_BASIS`` terms;
    ``decision_kernel.fullstep_body``).
    Raises ``ValueError`` where the full step does not run, as the JAX
    package's ``resolve_fullstep`` has it: spot-only panels and bases with a
    user callable (E builds a monomial design of factor panels on the
    card), and a group of more than one rank (E solves each step from its
    own moments).  Not a fallback: nothing is tried first."""
    if num_factors == 0 or has_generic(monomials):
        raise ValueError(
            "fullstep needs factor panels and a monomial basis (kernel E builds a monomial design "
            "of factor panels on the card, csrc/fullstep_kernel.cu): spot-only panels and "
            "generic bases run kernel D")
    if len(monomials) > _build.MAX_WIDE_BASIS:
        raise ValueError(f"fullstep takes at most {_build.MAX_WIDE_BASIS} basis functions "
                         f"(kernel E's wide route, csrc/common.cuh kMaxWideB), got "
                         f"{len(monomials)}")
    if preduce.active(group) is not None:
        raise ValueError("fullstep runs on one device: kernel E solves each step from its own "
                         "moments, which a path-parallel group sums between steps")
    return decision_kernel.fullstep_body(len(monomials), num_factors)


def grid_routes(num_grid: int, num_extra_decisions: int, monomials, num_factors: int,
                num_ratchet_nodes: int, general: bool, smem_limit: int, num_steps: int,
                itemsize: int) -> dict:
    """The grid routes of a valuation's kernels on a CUDA device, decided from
    shapes alone before any allocation, simulation or launch: {"intrinsic":
    (wrapper, route), "backward": (wrapper, route), "forward": (wrapper,
    route)}, each route "shared" (a step's tables, or the intrinsic DP's
    rows, in a block's shared memory) or "large" (past the grid those fit;
    any G).  The intrinsic phase runs the intrinsic DP at no extra decision
    over the N steps in the valuation's dtype (``itemsize`` bytes); the
    backward kernel B (its register kernels or its wide body,
    ``decision_kernel.moments_plan``), or kernel D on the design in memory
    (``design_in_memory``, spot-only panels); the forward kernel C's
    monomial or design mode, on general rows with ``general``.  The
    wrappers take the same routes from the same shapes
    (``intrinsic_kernel.intrinsic_route``, ``decision_kernel.moments_plan``,
    ``update_route``, ``forward_kernel.sweep_route``); ``smem_limit`` is the
    card's shared memory a block (``_build.smem_limit``).  Not a fallback:
    nothing is tried first."""
    d = 2 * num_extra_decisions + 3
    b = len(monomials)
    on_design = design_in_memory(monomials, num_factors)
    if on_design or num_factors == 0:
        backward = ("decision_update", decision_kernel.update_route(num_grid, d, b, smem_limit))
    else:
        backward = ("decision_update_moments",
                    decision_kernel.moments_plan(num_grid, d, b, num_factors, smem_limit))
    forward = ("forward_sweep_design" if on_design else "forward_sweep",
               forward_kernel.sweep_route(num_grid, b, num_ratchet_nodes,
                                          b if on_design else num_factors, num_extra_decisions,
                                          smem_limit, on_design, general))
    intrinsic = intrinsic_kernel.intrinsic_route(
        num_grid, num_ratchet_nodes, 0, "general" if general else "linear", itemsize, smem_limit,
        num_steps)
    return {"intrinsic": ("intrinsic_dp", intrinsic), "backward": (backward[0], backward[1].name),
            "forward": forward}


@contextlib.contextmanager
def full_f32_matmul():
    """Float32 matrix products in full float32 on the card (no TF32) inside
    the block — the regression moments are the JAX package's
    ``Precision.HIGHEST`` — and the caller's settings restored after it.
    The matmul TF32 flag is restored through the precision it belongs to:
    restoring the flag itself would mix torch's two precision APIs, which
    newer versions refuse to read back."""
    saved = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]


def build_engine_arrays(
    compiled: CompiledStorage,
    fwd: np.ndarray,
    df_settle: np.ndarray,
    df_flow: np.ndarray,
    inventory_lower: np.ndarray,
    inventory_upper: np.ndarray,
    num_grid_points: int,
    dtype,
    device,
    grids: tp.Optional[np.ndarray] = None,
) -> tp.Dict[str, torch.Tensor]:
    """The engines' per-step tables on ``device`` in ``dtype``: the inventory
    grids [N+1, G] (``grids``, or linspace rows of ``num_grid_points``), the
    curve, bands and discount factors, the facility's costs and ratchets."""
    if grids is None:
        grids = gridmod.inventory_grids(inventory_lower, inventory_upper, num_grid_points)
    host = {
        "grids": grids,
        "fwd": fwd,
        "lower": inventory_lower,
        "upper": inventory_upper,
        "df_settle": df_settle,
        "df_flow": df_flow,
        "inj_cost": compiled.inj_cost,
        "wdr_cost": compiled.wdr_cost,
        "inj_pcnt": compiled.inj_consumed_pcnt,
        "wdr_pcnt": compiled.wdr_consumed_pcnt,
        "loss_pcnt": compiled.loss_pcnt,
        "inv_cost_rate": compiled.inv_cost_rate,
        "ratchet_inv": compiled.ratchet_inv,
        "ratchet_min": compiled.ratchet_min,
        "ratchet_max": compiled.ratchet_max,
    }
    return {
        k: torch.tensor(np.asarray(v), dtype=dtype, device=device)
        for k, v in host.items()
    }


def _decision_cashflow_coeffs(decisions, x):
    """Per-decision immediate-PV decomposition pv = a·spot + b; ``x`` holds
    scalars broadcastable against ``decisions``."""
    is_inject = decisions > 0.0
    abs_d = torch.abs(decisions)
    consumed = torch.where(is_inject, x["inj_pcnt"], x["wdr_pcnt"]) * abs_d
    cost_npv = torch.where(is_inject, x["inj_cost"], x["wdr_cost"]) * abs_d * x["df_flow"]
    a = -(decisions + consumed) * x["df_settle"]
    return a, -cost_npv, consumed


def _terminal_values(terminal_fn, spot_end, grid_end, num_grid, num_sims, dtype):
    """Terminal storage values per (grid point, sim) — LsmcStorageValuation.cs:110-131.
    The user's terminal function receives tensors and is broadcast to [G, S]."""
    if terminal_fn is None:
        return torch.zeros((num_grid, num_sims), dtype=dtype, device=spot_end.device)
    value = terminal_fn(spot_end[None, :], grid_end[:, None])
    return torch.as_tensor(value, dtype=dtype, device=spot_end.device).expand(
        num_grid, num_sims
    ).contiguous()


def _backward_prep_all(arrays, num_extra_decisions: int, ratchet_is_step: bool,
                       snap_interp: bool, uniform_grids: bool = True):
    """Coefficient-independent per-step preparation for all N steps at once:
    interpolation rows/weights of every (step, grid point, decision) target
    inventory (by position arithmetic on evenly spaced rows, by search on
    others), and the immediate-value coefficients, in the kernel layouts
    (idx_lo, w_hi [N, G, D]; a, b [N, D, G])."""
    grids = arrays["grids"]
    n = grids.shape[0] - 1
    grid_t, grid_next = grids[:n], grids[1:]
    col = lambda key: arrays[key][:, None]  # noqa: E731  [N] -> [N, 1]
    min_rate, max_rate = gridmod.ratchet_rates(
        arrays["ratchet_inv"][:, None, :], arrays["ratchet_min"][:, None, :],
        arrays["ratchet_max"][:, None, :], ratchet_is_step, grid_t,
    )
    decisions = gridmod.bang_bang_decisions(
        min_rate, max_rate, grid_t, col("loss_pcnt"), arrays["lower"][1:, None],
        arrays["upper"][1:, None], num_extra_decisions,
    )  # [N, G, D]
    loss = col("loss_pcnt") * grid_t
    inv_after = grid_t[..., None] + decisions - loss[..., None]
    weights = interp.interp_weights if uniform_grids else interp.interp_weights_general
    idx_lo, w_hi = weights(grid_next, inv_after)
    if snap_interp:
        w_hi = decision_kernel.snap_weights(w_hi)
    scal = {k: arrays[k][:, None, None] for k in _SCALARS}
    a, b, _ = _decision_cashflow_coeffs(decisions, scal)
    b = b - (col("inv_cost_rate") * grid_t * col("df_flow"))[..., None]
    return {
        "idx_lo": idx_lo.to(torch.int32).contiguous(),
        "w_hi": w_hi.contiguous(),
        "a": a.transpose(1, 2).contiguous(),
        "b": b.transpose(1, 2).contiguous(),
    }


def _design_stats(monomials, spot, factors, chunk: tp.Optional[int] = None, group=None):
    """Exact two-pass column stats (mean, std) [N, B] of every step's design
    matrix, ``chunk`` steps at a time (``SEG_LEN`` where None: a segment's
    rows at a time, as the warmup takes them), over every rank's sims where
    ``group`` splits them.  They depend on the regression panels alone, so
    they are made before the backward loop; the decision kernel
    standardises step t−1's moments by them."""
    n = spot.shape[0]
    chunk = chunk or SEG_LEN
    means, stds = [], []
    for t0 in range(0, n, chunk):
        # Columns stacked [chunk, B, S] (a contiguous copy) and read through a
        # [chunk, S, B] view: stacking on the last axis interleaves B-strided
        # writes, measured ~50 ms per valuation on the card.
        cols = design_columns(monomials, spot[t0:t0 + chunk], factors[t0:t0 + chunk])
        m, s = column_stats(torch.stack(cols, dim=-2).transpose(-1, -2), group)
        means.append(m)
        stds.append(s)
    return torch.cat(means), torch.cat(stds)


def _fused_bootstrap(monomials, spot_last, factors_last, v_end, mean_last, std_last):
    """Moments of the LAST step's standardised design matrix against the
    terminal values, this rank's sims (every earlier step's come out of the
    decision kernel; the backward sums each step's over the group)."""
    u0 = (design_matrix(monomials, spot_last, factors_last) - mean_last) / std_last
    return u0.T @ u0, u0.T @ v_end.T


def _standardised_design_t(monomials, spot, factors, mean, std):
    """One step's standardised design, transposed: [B, S] contiguous, the
    layout kernel D reads."""
    cols = torch.stack(design_columns(monomials, spot, factors))  # [B, S]
    return (cols - mean[:, None]) / std[:, None]


def _ticker(segment_cb, phase: str, num_steps: int):
    """``tick(t)`` to call after step t of a pass: it calls
    ``segment_cb(phase, done, total)`` at the end of each ``SEG_LEN``-step
    segment (segments start at multiples of ``SEG_LEN``; the backward ends
    them at their first step, so a tail shorter than ``SEG_LEN`` comes
    first, as in the JAX package's ``lsmc_core_chunked``)."""
    seg_len = max(1, min(SEG_LEN, num_steps))
    total = -(-num_steps // seg_len)

    def tick(t: int) -> None:
        if segment_cb is not None and t % seg_len == 0:
            segment_cb(phase, total - t // seg_len, total)

    return tick


def _segments(num_steps: int, length: tp.Optional[int] = None):
    """The segments (t0, t1) of a pass, ``length`` steps each (``SEG_LEN``
    where None): from step 0 at multiples of it, a shorter tail last (365 =
    22·16 + 13), as ``_ticker`` counts them."""
    seg_len = max(1, min(length or SEG_LEN, num_steps))
    return [(t0, min(t0 + seg_len, num_steps)) for t0 in range(0, num_steps, seg_len)]


class PanelRows:
    """The rows source of materialised panels, spot [N+1, S] and factors
    [N+1, F, S]: ``rows(a, b)`` are views of rows a..b−1, no copy."""

    whole = True  # a pass may take all its steps at once

    def __init__(self, spot: torch.Tensor, factors: torch.Tensor):
        self.spot, self.factors = spot, factors
        self.num_sims, self.num_factors = spot.shape[1], factors.shape[1]

    def plan(self, starts) -> None:
        pass

    def rows(self, a: int, b: int):
        return self.spot[a:b], self.factors[a:b]

    def prefetch(self, a: int, b: int) -> None:
        pass


class StreamedSims:
    """The rows source of a simulated path set that is never materialised
    (the JAX package's ``StreamedSims``): ``rows(a, b)`` regenerates rows
    a..b−1 by the resumed simulation (``spot_sim.simulate_ou_segment``, the
    same bits as one simulation) from the factor state entering step a.  That
    state is zeros at step 0, the last row of the previous call where that
    call ended at a, or else a checkpoint: ``plan(starts)`` names the steps
    whose entry state the next pass keeps as it goes (the warmup keeps every
    backward segment's), and a checkpoint is dropped once used.

    ``sim_inputs`` holds the OU tables decay [N+1, F], chol [N+1, F, F], vols
    [N+1, F], half_var [N+1] and fwd [N+1] (``simulation_precompute`` and the
    curve); ``key`` and ``path_ids`` [S] address the draws, as
    ``simulate_ou_paths`` does."""

    whole = False

    def __init__(self, sim_inputs: tp.Mapping[str, torch.Tensor], key, path_ids,
                 antithetic: bool = False):
        self.decay, self.chol, self.vols = (sim_inputs[k] for k in ("decay", "chol", "vols"))
        self.c = torch.log(sim_inputs["fwd"]) - sim_inputs["half_var"]
        self.key, self.path_ids, self.antithetic = key, path_ids, antithetic
        self.num_sims, self.num_factors = path_ids.shape[0], self.decay.shape[1]
        self._keep: tp.Set[int] = set()
        self._entries: tp.Dict[int, torch.Tensor] = {}
        self._carry: tp.Tuple[int, tp.Optional[torch.Tensor]] = (0, None)

    def plan(self, starts) -> None:
        self._keep = {int(r) for r in starts if r > 0}

    def rows(self, a: int, b: int):
        if a == 0:
            x0 = None
        elif a == self._carry[0]:
            x0 = self._carry[1]
        elif a in self._entries:
            x0 = self._entries.pop(a)
        else:
            raise ValueError(f"StreamedSims: no state enters step {a}; plan() names the steps "
                             "a later pass starts at")
        res = spot_sim.simulate_ou_segment(
            self.key, self.path_ids, self.decay[a:b], self.chol[a:b], self.vols[a:b],
            self.c[a:b], a, x0, self.antithetic)
        for r in [r for r in self._keep if a < r <= b]:
            self._entries[r] = res.factors[r - 1 - a].clone()
            self._keep.discard(r)
        self._carry = (b, res.factors[-1])
        return res.spot, res.factors

    def prefetch(self, a: int, b: int) -> None:
        pass


class HostRows:
    """The rows source of user panels held in host memory, spot [N+1, S] and
    factors [N+1, F, S] (numpy): ``rows(a, b)`` copies rows a..b−1 to
    ``device``.  On CUDA the panels are pinned, and ``prefetch(a, b)`` starts
    the copy of the next rows on a side stream while the current ones are
    consumed."""

    whole = False

    def __init__(self, spot: np.ndarray, factors: np.ndarray, device):
        self.device = torch.device(device)
        # Read-only arrays (a frame's) are copied: torch tensors are writable.
        self.spot, self.factors = (torch.from_numpy(np.require(a, requirements=("C", "W")))
                                   for a in (spot, factors))
        self._side = None
        if self.device.type == "cuda":
            self.spot, self.factors = self.spot.pin_memory(), self.factors.pin_memory()
            self._side = torch.cuda.Stream(self.device)
        self.num_sims, self.num_factors = spot.shape[1], factors.shape[1]
        self._next = None

    def plan(self, starts) -> None:
        pass

    def _copy(self, a: int, b: int):
        return (self.spot[a:b].to(self.device, non_blocking=True),
                self.factors[a:b].to(self.device, non_blocking=True))

    def rows(self, a: int, b: int):
        if self._next is not None and self._next[0] == (a, b):
            _, event, out = self._next
            self._next = None
            torch.cuda.current_stream(self.device).wait_event(event)
            return out
        return self._copy(a, b)

    def prefetch(self, a: int, b: int) -> None:
        if self._side is None:
            return
        current = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._side):
            out = self._copy(a, b)
            event = torch.cuda.Event()
            event.record(self._side)
        for x in out:
            x.record_stream(current)  # freed only once the consuming stream is done
        self._next = ((a, b), event, out)


def _each_rows(src, ranges):
    """``src.rows(a, b)`` of each range in turn, the next range's rows
    prefetched while the caller consumes these."""
    for k, (a, b) in enumerate(ranges):
        rows = src.rows(a, b)
        if k + 1 < len(ranges):
            src.prefetch(*ranges[k + 1])
        yield rows


def _stream_warmup(src, monomials, num_steps: int, group=None):
    """One pass over a rows source before the backward: each segment's design
    stats (``_design_stats`` on the segment's rows, so the same bits as over
    whole panels) and, for a regenerated source, the checkpoints the backward
    starts from (the state entering each segment's previous step,
    ``_backward_ranges``).  The last segment also takes step N.  Returns mean
    and std [N, B], and spot and factors of step N−1 and the spot of step N
    (the terminal values and the moments' bootstrap).  The stats are over
    every rank's sims where ``group`` splits them."""
    n = num_steps
    segs = _segments(n)
    src.plan([a for a, _ in _backward_ranges(n)])
    ranges = [(t0, t1 + (t1 == n)) for t0, t1 in segs]
    means, stds = [], []
    for (t0, t1), (spot, factors) in zip(segs, _each_rows(src, ranges)):
        m = t1 - t0
        mean, std = _design_stats(monomials, spot[:m], factors[:m], group=group)
        means.append(mean)
        stds.append(std)
    return torch.cat(means), torch.cat(stds), (spot[m - 1], factors[m - 1], spot[m])


def _backward_ranges(num_steps: int):
    """The rows each backward segment reads, last segment first: its steps
    and the step before (kernels B and E read step t−1; at t = 0 step 0)."""
    return [(max(t0 - 1, 0), t1) for t0, t1 in reversed(_segments(num_steps))]


def lsmc_backward_rows(
    arrays: tp.Dict[str, torch.Tensor],
    src,
    monomials: tp.Tuple,
    num_extra_decisions: int,
    terminal_fn,
    ratchet_is_step: bool,
    snap_interp: bool = False,
    fullstep: bool = False,
    segment_cb: tp.Optional[tp.Callable[[str, int, int], None]] = None,
    uniform_grids: bool = True,
    group=None,
):
    """Backward induction over a rows source (``PanelRows``, ``StreamedSims``
    or ``HostRows``).  Returns (v0 [G, S], regression payload of stacked
    per-step mean [N, B], std [N, B], coeffs [N, B, G]).

    The warmup (``_stream_warmup``) takes every step's design stats first;
    then the segments run from the last, each reading its rows and the step
    before them once: every source gives the same bits.

    ``segment_cb("backward", done, total)``, where given, is called after
    each ``SEG_LEN``-step segment, from the last step down (``_ticker``);
    raising from it stops the pass between segments.

    ``snap_interp`` rounds the interpolation weights to the 1/256 grid, the
    quadrature of the TPU run.  Factor panels run kernel B with the tensor
    glue between steps, or kernel E alone with ``fullstep`` (any monomial
    basis of up to 64 terms: B's and E's register routes within 16 terms
    and 8 factors, their wide routes past them, ``moments_plan``,
    ``fullstep_body``); spot-only panels ([N+1, 0, S] factors)
    and the shapes of ``design_in_memory`` run the plain body with kernel D
    on the design read from memory, and spot-only panels and generic bases
    refuse ``fullstep`` (kernel E builds a monomial design of factor panels
    on the card).  ``uniform_grids=False`` places target inventories on the
    grid rows by search (``_backward_prep_all``).

    ``group`` (a process group, ``parallel.reduce``) splits the sims over
    its ranks: the stats, and each step's two moments in one all-reduce,
    are summed over it, so every rank solves the same regression.  Kernel E
    solves on the card from its own moments and takes no group larger than
    one (the JAX package's ``resolve_fullstep``)."""
    grids = arrays["grids"]
    n = grids.shape[0] - 1
    num_grid = grids.shape[1]
    dtype = grids.dtype
    on_design = src.num_factors == 0 or design_in_memory(monomials, src.num_factors)
    if fullstep:
        fullstep_body(monomials, src.num_factors, group)  # raises where E does not run
    mean, std, (spot_last, factors_last, spot_end) = _stream_warmup(src, monomials, n, group)
    v = _terminal_values(terminal_fn, spot_end, grids[n], num_grid, src.num_sims, dtype)
    prep = _backward_prep_all(arrays, num_extra_decisions, ratchet_is_step, snap_interp,
                              uniform_grids)
    coeffs_all = torch.empty((n, len(monomials), num_grid), dtype=dtype, device=grids.device)
    spare = torch.empty_like(v)
    step_args = lambda t: (prep["idx_lo"][t], prep["w_hi"][t])  # noqa: E731
    tick = _ticker(segment_cb, "backward", n)
    if fullstep or not on_design:
        xtx, xty = _fused_bootstrap(monomials, spot_last, factors_last, v, mean[n - 1],
                                    std[n - 1])
    if fullstep:
        # Kernel E writes the payload rows in place: no tensor glue.
        mean_out, std_out = torch.empty_like(mean), torch.empty_like(std)
    ranges = _backward_ranges(n)
    segs = reversed(_segments(n))
    for (t0, t1), (r0, _), (spot, factors) in zip(segs, ranges, _each_rows(src, ranges)):
        for t in range(t1 - 1, t0 - 1, -1):
            tq = max(t - 1, 0)  # the previous step; at t = 0 step 0 itself
            i, prev = t - r0, tq - r0  # their rows in the segment's
            if fullstep:
                # Kernel E solves each step's regression from the carried
                # moments (centred by the step's exact stats, so it recovers
                # them to rounding).
                best_act, xtx, xty, _, _, _ = decision_kernel.decision_update_fullstep(
                    v, spot[i], factors[i], spot[prev], factors[prev], xtx, xty, mean[t], std[t],
                    *step_args(t), prep["a"][t], prep["b"][t], monomials, mean_prev=mean[tq],
                    std_prev=std[tq], out=spare,
                    regression_out=(mean_out[t], std_out[t], coeffs_all[t]),
                )
            elif on_design:
                # Regression of the next period's values on this period's
                # standardised design (the JAX plain body, engines/lsmc.py:306-327).
                dm_t = _standardised_design_t(monomials, spot[i], factors[i], mean[t], std[t])
                coeffs = fit_continuation(dm_t.T, v.T, group)  # [B, G]
                ci = interp.interp_coeffs(coeffs, *step_args(t))
                best_act = decision_kernel.decision_update(
                    v, dm_t, spot[i], *step_args(t), ci, prep["a"][t], prep["b"][t], out=spare,
                )
                coeffs_all[t] = coeffs
            else:
                # Step t's moments arrive standardised by its exact stats: the
                # normal equations of the JAX XLA path, without a second pass
                # over v; every rank's, summed in one all-reduce.
                xtx, xty = preduce.psum_many((xtx, xty), group)
                coeffs = fit_from_moments(xtx, xty)  # [B, G]
                ci = interp.interp_coeffs(coeffs, *step_args(t))
                best_act, xtx, xty = decision_kernel.decision_update_moments(
                    v, spot[i], factors[i], spot[prev], factors[prev], mean[t], std[t],
                    mean[tq], std[tq], *step_args(t), ci, prep["a"][t], prep["b"][t],
                    monomials, out=spare,
                )
                coeffs_all[t] = coeffs
            spare, v = v, best_act
            tick(t)
    if fullstep:
        mean, std = mean_out, std_out
    return v, {"mean": mean, "std": std, "coeffs": coeffs_all}


def lsmc_backward(arrays, spot_reg: torch.Tensor, factors_reg: torch.Tensor, monomials,
                  num_extra_decisions: int, terminal_fn, ratchet_is_step: bool, **kwargs):
    """Backward induction over materialised regression panels, spot [N+1, S]
    and factors [N+1, F, S] (``lsmc_backward_rows`` on ``PanelRows``)."""
    return lsmc_backward_rows(arrays, PanelRows(spot_reg, factors_reg), monomials,
                              num_extra_decisions, terminal_fn, ratchet_is_step, **kwargs)


# The JAX package's name for the backward with every segment regenerated from
# its checkpoint: here ``lsmc_backward_rows`` given a ``StreamedSims``, whose
# results are ``lsmc_backward``'s on the same paths, to the bit.
lsmc_backward_streamed = lsmc_backward_rows


def _trigger_outputs(x, xbar, expected_inventory, ratchet_is_step: bool,
                     num_extra_decisions: int, dtype, uniform_grids: bool = True):
    """Trigger prices at the expected inventory (LsmcStorageValuation.cs:523-592)
    for all N steps at once: ``x`` holds [N]-shaped scalars, [N, R] ratchet
    tables, coeffs [N, B, G] and grid_next [N, G]; ``xbar`` [N, B] is the
    cross-sim mean standardised design row."""
    num_tv = NUM_TRIGGER_PRICE_VOLUMES
    cbar = torch.einsum("nb,nbg->ng", xbar, x["coeffs"])  # [N, G_next]
    e_loss = x["loss_pcnt"] * expected_inventory
    e_min_rate, e_max_rate = gridmod.ratchet_rates(
        x["ratchet_inv"], x["ratchet_min"], x["ratchet_max"], ratchet_is_step,
        expected_inventory,
    )
    e_decisions = gridmod.bang_bang_decisions(
        e_min_rate, e_max_rate, expected_inventory, x["loss_pcnt"], x["next_min"],
        x["next_max"], num_extra_decisions,
    )  # [N, D]
    inf = torch.tensor(float("inf"), dtype=dtype, device=e_decisions.device)
    nan = torch.tensor(float("nan"), dtype=dtype, device=e_decisions.device)
    col = lambda t: t[:, None]  # noqa: E731
    interp_fn = interp.interp_vector if uniform_grids else interp.interp_vector_general

    def pv_parts(volume):  # volume [N, K]
        is_inject = volume > 0.0
        abs_v = torch.abs(volume)
        consumed_v = torch.where(is_inject, col(x["inj_pcnt"]), col(x["wdr_pcnt"])) * abs_v
        cost_v = (
            torch.where(is_inject, col(x["inj_cost"]), col(x["wdr_cost"]))
            * abs_v * col(x["df_flow"])
        )
        cont_v = interp_fn(
            x["grid_next"], cbar,
            col(expected_inventory) + volume - col(e_loss),
        )
        return cont_v, cost_v, consumed_v

    def side(inject: bool):
        if inject:
            extreme = torch.max(e_decisions, dim=1).values
            alternative = torch.min(torch.where(e_decisions >= 0, e_decisions, inf), dim=1).values
            active = (extreme > 0) & (extreme > alternative)
        else:
            extreme = torch.min(e_decisions, dim=1).values
            alternative = torch.max(torch.where(e_decisions <= 0, e_decisions, -inf), dim=1).values
            active = (extreme < 0) & (extreme < alternative)
        alt_cont, alt_cost, alt_consumed = pv_parts(col(alternative))
        j = torch.arange(1, num_tv + 1, dtype=dtype, device=extreme.device)
        volumes = col(alternative) + j * col(extreme - alternative) / num_tv
        cont_v, cost_v, consumed_v = pv_parts(volumes)
        # Price making the trigger volume indifferent to the alternative
        # (CalcTriggerPrice, LsmcStorageValuation.cs:704-723).
        denom = col(x["df_settle"]) * (volumes - col(alternative) + consumed_v - alt_consumed)
        prices = ((cont_v - alt_cont) - (cost_v - alt_cost)) / denom
        volumes = torch.where(col(active), volumes, nan)
        prices = torch.where(col(active), prices, nan)
        return (
            volumes, prices,
            torch.where(active, extreme, nan),
            torch.where(active, prices[:, -1], nan),  # price at the max volume
            torch.where(active, prices[:, 0], nan),   # price nearest the alternative
        )

    inj_volumes, inj_prices, max_inj_vol, max_inj_price, _ = side(True)
    wdr_volumes, wdr_prices, max_wdr_vol, wdr_maxvol_price, wdr_near_price = side(False)
    return {
        "inj_volumes": inj_volumes,
        "inj_prices": inj_prices,
        "wdr_volumes": wdr_volumes,
        "wdr_prices": wdr_prices,
        "max_inj_vol": max_inj_vol,
        # Inject: the reference's MaxInjectTriggerPrice is the max-volume
        # point (LsmcStorageValuation.cs:556).
        "max_inj_price": max_inj_price,
        "max_wdr_vol": max_wdr_vol,
        # Withdraw: the price one increment from the alternative
        # (LsmcStorageValuation.cs:584); the max-volume price is kept apart.
        "max_wdr_price": wdr_near_price,
        "wdr_maxvol_price": wdr_maxvol_price,
    }


@dataclasses.dataclass
class AdjointTape:
    """What ``adjoint_deltas`` needs of an ``adjoint=True`` forward pass: the
    NPV's gradient in the forward curve's rows ``fwd[:N]`` (``rows`` [N],
    the VJP kernel's, a launch a chunk of the sweep) and, where the storage
    has a terminal value, the NPV with its autograd graph back to the
    curve's last entry (``fwd_end``).  In a process group both are this
    rank's, of its own mean; ``adjoint_deltas`` averages them over
    ``group``."""

    rows: torch.Tensor
    npv: torch.Tensor
    fwd_end: tp.Optional[torch.Tensor]
    df_settle: torch.Tensor
    discount_deltas: bool
    group: tp.Any = None


def lsmc_forward_rows(
    arrays: tp.Dict[str, torch.Tensor],
    src,
    regression: tp.Dict[str, torch.Tensor],
    starting_inventory,
    monomials: tp.Tuple,
    num_extra_decisions: int,
    discount_deltas: bool,
    terminal_fn,
    ratchet_is_step: bool,
    return_sim_data: bool = False,
    segment_cb: tp.Optional[tp.Callable[[str, int, int], None]] = None,
    uniform_grids: bool = True,
    adjoint: bool = False,
    group=None,
):
    """Forward simulation over a rows source (``PanelRows``, ``StreamedSims``
    or ``HostRows``) with a given regression payload.  Materialised panels
    take one forward sweep for all steps; other sources, and an interactive
    run (``segment_cb("forward", done, total)`` after each segment), a sweep
    launch a ``SEG_LEN``-step segment on that segment's rows, the inventory
    and PV carried between launches (the same bits:
    ``forward_kernel.sweep_in_chunks``); a generic basis builds its design a
    chunk of steps at a time (``forward_kernel.forward_sweep_generic``), as
    does a basis past 64 terms (``design_in_memory``); every other basis
    runs the sweep's monomial mode, on its wide route past 16 terms or 8
    factors.  The per-step reductions
    stay on the device until the result dict is read.

    ``return_sim_data`` (materialised panels only) adds the per-sim panels of
    the JAX package's ``_forward_finalise``: inventory and PV [N+1, S] (the
    last rows the final inventory and the terminal PV), and volume, fuel,
    loss and net volume [N, S].  ``uniform_grids=False`` runs kernel C's
    general-grid mode on the grid rows.  ``adjoint`` adds
    ``"adjoint_tape"``, an ``AdjointTape`` for ``adjoint_deltas``: after each
    chunk's sweep the VJP kernel takes that chunk's rows of the NPV's
    gradient from the chunk's volume, fuel and spot (grad[t] reads row t
    alone), so no [N, S] tape outlives its chunk; the other results are
    unchanged.  With a given regression payload this is the forward-only
    adjoint.

    ``group`` splits the sims over its ranks: kernel C's sums, the NPV, the
    SE's sum of squares and the means are all-reduced across it (the count
    is every rank's), the tape differentiates this rank's own mean."""
    grids = arrays["grids"]
    n = grids.shape[0] - 1
    dtype = grids.dtype
    device = grids.device
    s_count = src.num_sims
    if return_sim_data and not src.whole:
        raise ValueError("Per-sim panels require materialised paths; pass return_sim_data=False.")
    grid_next = grids[1:]
    grid_rows = None if uniform_grids else grid_next
    step = {k: arrays[k] for k in _SCALARS}
    step.update(next_min=arrays["lower"][1:], next_max=arrays["upper"][1:])
    params = forward_kernel.pack_params(step, grid_next, dtype=dtype)  # [N, 13]
    ratchets = [arrays[k].contiguous() for k in ("ratchet_inv", "ratchet_min", "ratchet_max")]

    inv0 = torch.full((s_count,), float(starting_inventory), dtype=dtype, device=device)
    panel = lambda rows: torch.empty((rows, s_count), dtype=dtype, device=device)  # noqa: E731
    rows = [None] * 4
    if return_sim_data:
        # Kernel C writes its per-sim outputs into panel rows: no copies.
        sim_inventory, sim_pv = panel(n + 1), panel(n + 1)
        sim_dec, sim_cons = panel(n), panel(n)
        sim_inventory[0] = inv0
        rows = [sim_inventory[1:], sim_dec, sim_cons, sim_pv[:n]]
    seg_len = max(1, min(SEG_LEN, n))
    chunk = n if src.whole and segment_cb is None else seg_len
    chunk_cb = None if segment_cb is None else (
        lambda done, total: segment_cb("forward", done, total))
    tables = (params, regression["mean"], regression["std"], *(r[:n] for r in ratchets))
    if adjoint:
        fwd_grad = torch.empty((n,), dtype=dtype, device=device)
        # d npv / d pv of each sim: autograd's gradient of this rank's mean,
        # 1/S (the group then averages the ranks' gradients, ``adjoint_deltas``).
        g = torch.ones((s_count,), dtype=dtype, device=device) / s_count
    ranges = [(t0, t1 + (t1 == n)) for t0, t1 in _segments(n, chunk)]
    each_rows = _each_rows(src, ranges)
    ends = {}
    on_design = design_in_memory(monomials, src.num_factors)

    def sweep_chunk(t0, t1, inventory, pv):
        spot, factors = next(each_rows)
        if t1 == n:
            ends["spot"] = spot[t1 - t0]  # the terminal spot, the last range's extra row
        spot, factors = spot[:t1 - t0], factors[:t1 - t0]
        panels = [None if p is None else p[t0:t1] for p in rows]
        if adjoint and panels[1] is None:
            panels[1], panels[2] = panel(t1 - t0), panel(t1 - t0)  # the volume and fuel the VJP reads
        grid = None if grid_rows is None else grid_rows[t0:t1]
        coeffs = regression["coeffs"][t0:t1]
        if on_design:
            out = forward_kernel.forward_sweep_generic(
                *(x[t0:t1] for x in tables), spot, factors, inventory, coeffs, monomials,
                num_extra_decisions, ratchet_is_step, panels=panels, grid=grid, pv=pv)
        else:
            out = forward_kernel.forward_sweep(
                *(x[t0:t1] for x in tables), spot, factors, inventory, pv, coeffs, monomials,
                num_extra_decisions, ratchet_is_step, panels=panels, grid=grid)
        if adjoint:
            fwd_grad[t0:t1] = forward_kernel.forward_sweep_vjp(
                panels[1], panels[2], spot, arrays["fwd"][t0:t1], arrays["df_settle"][t0:t1], g)
        return out

    inventory, pv, sums, xbar = forward_kernel.sweep_in_chunks(n, chunk, chunk_cb, sweep_chunk, inv0)
    spot_end = ends["spot"]
    fwd_end = None
    with torch.enable_grad() if adjoint else contextlib.nullcontext():
        # Terminal period PV for non-empty storage: each sim's own terminal value.
        if terminal_fn is not None:
            if adjoint:
                # The same values, with d spot_end / d fwd[N] = spot_end / fwd[N]
                # (spot = forward x stochastic part); inventory carries no gradient.
                fwd_end = arrays["fwd"][n].detach().clone().requires_grad_()
                f_n = arrays["fwd"][n]
                ratio = torch.where(f_n != 0, spot_end / f_n, torch.zeros_like(spot_end))
                spot_end = spot_end + (fwd_end - fwd_end.detach()) * ratio
            terminal_pv = torch.as_tensor(
                terminal_fn(spot_end, inventory), dtype=dtype, device=device
            ).expand(inventory.shape)
            pv = pv + terminal_pv
        else:
            terminal_pv = torch.zeros_like(pv)
        # The tape differentiates this rank's own mean; no collective is in
        # its graph.
        tape = AdjointTape(fwd_grad, pv.mean(), fwd_end, arrays["df_settle"], discount_deltas,
                           group) if adjoint else None
    pv, terminal_pv = pv.detach(), terminal_pv.detach()
    npv = preduce.global_mean_over_sims(pv, group)
    if terminal_fn is not None:
        end_pv = preduce.global_mean_over_sims(terminal_pv, group)
    else:
        end_pv = torch.zeros((), dtype=dtype, device=device)

    count = float(s_count * preduce.size(group))
    sums, xbar = preduce.psum_many((sums, xbar), group)
    xbar = xbar / count
    expected_inventory = sums[:, forward_kernel._A_INV] / count
    disc = arrays["df_settle"] if discount_deltas else torch.ones_like(arrays["df_settle"])
    delta = sums[:, forward_kernel._A_DELTA] / count / arrays["fwd"][:n] * disc
    trig = {
        **step, "grid_next": grid_next, "coeffs": regression["coeffs"],
        "ratchet_inv": ratchets[0], "ratchet_min": ratchets[1], "ratchet_max": ratchets[2],
    }
    triggers = _trigger_outputs(
        trig, xbar, expected_inventory, ratchet_is_step, num_extra_decisions, dtype,
        uniform_grids,
    )
    # Sample standard error (ddof=1; LsmcStorageValuation.cs:618).
    sq_sum = preduce.psum(torch.sum((pv - npv) ** 2), group)
    standard_error = torch.sqrt(sq_sum / (count - 1.0)) / np.sqrt(count)

    zero = torch.zeros((1,), dtype=dtype, device=device)
    sim_panels = {}
    if return_sim_data:
        sim_pv[n] = terminal_pv
        sim_panels = {
            "sim_inventory": sim_inventory,
            "sim_inject_withdraw": sim_dec,
            "sim_cmdty_consumed": sim_cons,
            # The kernel's loss, loss_pcnt·inventory, for all steps at once.
            "sim_inventory_loss": arrays["loss_pcnt"][:, None] * sim_inventory[:n],
            "sim_net_volume": -sim_dec - sim_cons,
            "sim_pv": sim_pv,
        }
    return {
        **sim_panels,
        **({"adjoint_tape": tape} if adjoint else {}),
        "npv": npv,
        "standard_error": standard_error,
        "deltas": torch.cat([delta, zero]),
        "profile_inventory": torch.cat([expected_inventory,
                                        preduce.global_mean_over_sims(inventory, group)[None]]),
        "profile_inject_withdraw": torch.cat([sums[:, forward_kernel._A_DEC] / count, zero]),
        "profile_cmdty_consumed": torch.cat([sums[:, forward_kernel._A_CONS] / count, zero]),
        "profile_inventory_loss": torch.cat([sums[:, forward_kernel._A_LOSS] / count, zero]),
        "profile_pv": torch.cat([sums[:, forward_kernel._A_IMM] / count, end_pv[None]]),
        "trigger_inject_volumes": triggers["inj_volumes"],
        "trigger_inject_prices": triggers["inj_prices"],
        "trigger_withdraw_volumes": triggers["wdr_volumes"],
        "trigger_withdraw_prices": triggers["wdr_prices"],
        "max_inject_volume": triggers["max_inj_vol"],
        "max_inject_trigger_price": triggers["max_inj_price"],
        "max_withdraw_volume": triggers["max_wdr_vol"],
        "max_withdraw_trigger_price": triggers["max_wdr_price"],
        "withdraw_max_volume_price": triggers["wdr_maxvol_price"],
    }


def lsmc_forward(arrays, spot_val: torch.Tensor, factors_val: torch.Tensor, regression,
                 starting_inventory, monomials, num_extra_decisions: int, discount_deltas: bool,
                 terminal_fn, ratchet_is_step: bool, **kwargs):
    """The forward pass over materialised valuation panels, spot [N+1, S] and
    factors [N+1, F, S] (``lsmc_forward_rows`` on ``PanelRows``)."""
    return lsmc_forward_rows(arrays, PanelRows(spot_val, factors_val), regression,
                             starting_inventory, monomials, num_extra_decisions, discount_deltas,
                             terminal_fn, ratchet_is_step, **kwargs)


# The JAX package's name for the forward with each segment simulated from the
# state the last one left: here ``lsmc_forward_rows`` given a ``StreamedSims``.
lsmc_forward_streamed = lsmc_forward_rows


def adjoint_deltas(tape: AdjointTape) -> torch.Tensor:
    """Deltas [N+1] by reverse mode through an ``adjoint=True`` forward pass
    (the JAX package's ``_forward_value_and_grad`` and
    ``_undiscount_deltas``): d NPV / d fwd, whose first N entries are the
    sweep's VJP and whose last is the terminal value's gradient.  They are
    discounted to the valuation date by construction; without
    ``discount_deltas`` the first N are divided by the settlement discount
    factors and the last is left as it is, as in the JAX package.  A tape
    of a process group holds this rank's gradient of its own mean: the
    ranks' are averaged (equal blocks, so the global mean's), as the JAX
    package's ``pmean`` after a collective-free gradient."""
    rows, end = tape.rows, None
    if tape.fwd_end is not None and tape.npv.requires_grad:
        # A terminal value that ignores the price leaves fwd_end unused: zero.
        (end,) = torch.autograd.grad(tape.npv, [tape.fwd_end], allow_unused=True)
    if end is None:
        end = torch.zeros((), dtype=rows.dtype, device=rows.device)
    grad = preduce.pmean(torch.cat([rows, end.detach().reshape(1)]), tape.group)
    if not tape.discount_deltas:
        grad = torch.cat([grad[:-1] / tape.df_settle, grad[-1:]])
    return grad.detach()


def lsmc_core_rows(
    arrays: tp.Dict[str, torch.Tensor],
    reg,
    val,
    starting_inventory,
    monomials: tp.Tuple,
    num_extra_decisions: int,
    discount_deltas: bool,
    terminal_fn,
    ratchet_is_step: bool,
    snap_interp: bool = False,
    return_regression: bool = False,
    return_sim_data: bool = False,
    fullstep: bool = False,
    segment_cb: tp.Optional[tp.Callable[[str, int, int], None]] = None,
    uniform_grids: bool = True,
    adjoint: bool = False,
    group=None,
) -> tp.Dict[str, torch.Tensor]:
    """Full LSMC valuation on one device over two rows sources: the
    regression set ``reg`` drives the backward pass, the valuation set
    ``val`` the forward pass (``PanelRows``, ``StreamedSims`` or
    ``HostRows``; every source of the same paths gives the same bits).
    Results stay on the device.  ``return_sim_data`` adds the per-sim panels
    (materialised panels only, ``lsmc_forward_rows``); ``fullstep`` runs
    each backward step as kernel E alone (factor panels and monomial bases
    only, on one device: ``fullstep_body``).  ``uniform_grids=False`` takes grid rows that are not evenly
    spaced (the search placement of both passes); ``adjoint`` adds the
    forward sweep's ``"adjoint_tape"`` for ``adjoint_deltas``.

    ``segment_cb(phase, done, total)`` makes the run interactive, as the JAX
    package's ``lsmc_core_chunked``: it is called after every
    ``SEG_LEN``-step segment of the backward (``phase`` "backward") and of
    the forward ("forward", whose sweep then runs a launch a segment), and
    raising from it aborts the valuation between segments.  An interactive
    run gives the uninterrupted run's bits.

    ``group`` (``parallel.reduce``) makes the sources this rank's block of
    paths and reduces every sum over sims across the group's ranks: the
    results are the whole panel's on every rank, the per-sim panels the
    rank's own."""
    with full_f32_matmul():
        v0, regression = lsmc_backward_rows(
            arrays, reg, monomials, num_extra_decisions, terminal_fn, ratchet_is_step,
            snap_interp=snap_interp, fullstep=fullstep, segment_cb=segment_cb,
            uniform_grids=uniform_grids, group=group,
        )
        result = lsmc_forward_rows(
            arrays, val, regression, starting_inventory, monomials, num_extra_decisions,
            discount_deltas, terminal_fn, ratchet_is_step, return_sim_data=return_sim_data,
            segment_cb=segment_cb, uniform_grids=uniform_grids, adjoint=adjoint, group=group,
        )
    # Backward (upper-ish) estimate: mean of the first-period values at the
    # known starting inventory (grid[0] is degenerate) — LsmcStorageValuation.cs:623.
    result["backward_npv"] = preduce.global_mean_over_sims(v0[0], group)
    if return_regression:
        result["regression_mean"] = regression["mean"]
        result["regression_std"] = regression["std"]
        result["regression_coeffs"] = regression["coeffs"]
    return result


def lsmc_core(arrays, spot_reg: torch.Tensor, factors_reg: torch.Tensor, spot_val: torch.Tensor,
              factors_val: torch.Tensor, starting_inventory, monomials, num_extra_decisions: int,
              discount_deltas: bool, terminal_fn, ratchet_is_step: bool, **kwargs):
    """Full LSMC valuation over materialised panels, spot [N+1, S] and
    factors [N+1, F, S] of each set (``lsmc_core_rows`` on ``PanelRows``).
    Given a ``segment_cb`` it is the JAX package's ``lsmc_core_chunked``."""
    return lsmc_core_rows(arrays, PanelRows(spot_reg, factors_reg),
                          PanelRows(spot_val, factors_val), starting_inventory, monomials,
                          num_extra_decisions, discount_deltas, terminal_fn, ratchet_is_step,
                          **kwargs)


# The JAX package's name for its host-chunked engine, which here is
# ``lsmc_core`` given a ``segment_cb``.
lsmc_core_chunked = lsmc_core


def streamed_sims(sim_inputs, reg_key, val_key, path_ids, antithetic: bool = False,
                  same_sims: bool = False):
    """The regression and valuation sets as ``StreamedSims``: ``reg_key``
    and ``val_key`` address the draws (``same_sims`` reuses the regression
    stream for both passes, each pass regenerating it)."""
    return (StreamedSims(sim_inputs, reg_key, path_ids, antithetic),
            StreamedSims(sim_inputs, reg_key if same_sims else val_key, path_ids, antithetic))


def lsmc_core_streamed(arrays, sim_inputs, reg_key, val_key, path_ids, starting_inventory,
                       monomials, num_extra_decisions: int, discount_deltas: bool, terminal_fn,
                       ratchet_is_step: bool, antithetic: bool = False, same_sims: bool = False,
                       **kwargs) -> tp.Dict[str, torch.Tensor]:
    """Full LSMC valuation with the paths regenerated a segment at a time and
    never materialised (the JAX package's function of the same name): the
    simulation's OU tables ``sim_inputs`` (decay, chol, vols, half_var, fwd
    [N+1, ...]), the keys and path ids [S] of ``simulate_ou_paths``.  Three
    passes simulate each segment: the warmup (the design stats and the
    backward's checkpoints, [⌈N/SEG_LEN⌉, F, S]), the backward and the
    forward.  Besides the [G, S] value panels, the device holds one segment's
    rows and the checkpoints.  The results are ``lsmc_core``'s on
    ``simulate_ou_paths``'s panels, to the bit; keywords as
    ``lsmc_core_rows`` (but ``return_sim_data``)."""
    reg, val = streamed_sims(sim_inputs, reg_key, val_key, path_ids, antithetic, same_sims)
    return lsmc_core_rows(arrays, reg, val, starting_inventory, monomials, num_extra_decisions,
                          discount_deltas, terminal_fn, ratchet_is_step, **kwargs)


def lsmc_npv_and_ad_deltas(
    arrays: tp.Dict[str, torch.Tensor],
    stoch_reg: torch.Tensor,  # [N+1, S] spot / forward (the stochastic part)
    factors_reg: torch.Tensor,
    stoch_val: torch.Tensor,
    factors_val: torch.Tensor,
    starting_inventory,
    monomials: tp.Tuple,
    num_extra_decisions: int,
    discount_deltas: bool,
    terminal_fn,
    ratchet_is_step: bool,
    uniform_grids: bool = True,
    snap_interp: bool = False,
    segment_cb: tp.Optional[tp.Callable[[str, int, int], None]] = None,
    group=None,
):
    """NPV and deltas [N+1] by reverse mode (the JAX package's function of
    the same name): the spot is fwd x stoch, one backward pass builds the
    regression, and ``adjoint_deltas`` differentiates that valuation's own
    forward sweep in the curve — the JAX package runs the backward again
    inside its differentiated function, to the same payload.  ``group``
    splits the sims (this rank's block), as in ``lsmc_core_rows``."""
    fwd = arrays["fwd"][:, None]
    result = lsmc_core(
        arrays, fwd * stoch_reg, factors_reg, fwd * stoch_val, factors_val, starting_inventory,
        monomials, num_extra_decisions, discount_deltas, terminal_fn, ratchet_is_step,
        snap_interp=snap_interp, segment_cb=segment_cb, uniform_grids=uniform_grids,
        adjoint=True, group=group,
    )
    return result["npv"], adjoint_deltas(result["adjoint_tape"])


def lsmc_npv_and_ad_deltas_streamed(arrays, sim_inputs, reg_key, val_key, path_ids,
                                    starting_inventory, monomials, num_extra_decisions: int,
                                    discount_deltas: bool, terminal_fn, ratchet_is_step: bool,
                                    antithetic: bool = False, same_sims: bool = False, **kwargs):
    """NPV and adjoint deltas [N+1] with streamed paths (the JAX package's
    function of the same name): ``lsmc_core_streamed`` with ``adjoint``, the
    VJP kernel run on each forward segment's rows as the segment is swept."""
    result = lsmc_core_streamed(
        arrays, sim_inputs, reg_key, val_key, path_ids, starting_inventory, monomials,
        num_extra_decisions, discount_deltas, terminal_fn, ratchet_is_step,
        antithetic=antithetic, same_sims=same_sims, adjoint=True, **kwargs)
    return result["npv"], adjoint_deltas(result["adjoint_tape"])


def lsmc_ad_deltas_path_chunked(arrays, regression, spot_val: np.ndarray, factors_val: np.ndarray,
                                starting_inventory, monomials, num_extra_decisions: int,
                                discount_deltas: bool, terminal_fn, ratchet_is_step: bool,
                                uniform_grids: bool = True, chunk_sims: int = 65536):
    """NPV and adjoint deltas [N+1] over host-resident valuation panels (the
    JAX package's function of the same name): with the regression payload
    fixed, the NPV is a mean over sims, so each chunk of ``chunk_sims`` paths
    is copied to the device and its forward pass differentiated
    (``lsmc_forward(adjoint=True)``), and the chunks' NPVs and gradients are
    averaged by their path counts."""
    device, dtype = arrays["grids"].device, arrays["grids"].dtype
    regression = {k: torch.tensor(np.asarray(v), dtype=dtype, device=device)
                  for k, v in regression.items()}
    total = spot_val.shape[1]
    npv_sum = grad_sum = 0.0
    for lo in range(0, total, chunk_sims):
        hi = min(lo + chunk_sims, total)
        spot_c, factors_c = (torch.tensor(np.ascontiguousarray(x[..., lo:hi]), dtype=dtype,
                                          device=device) for x in (spot_val, factors_val))
        out = lsmc_forward(arrays, spot_c, factors_c, regression, starting_inventory, monomials,
                           num_extra_decisions, True, terminal_fn, ratchet_is_step,
                           uniform_grids=uniform_grids, adjoint=True)
        npv_sum = npv_sum + out["npv"] * float(hi - lo)
        grad_sum = grad_sum + adjoint_deltas(out["adjoint_tape"]) * float(hi - lo)
    npv, grad = npv_sum / total, grad_sum / total
    if not discount_deltas:
        grad = torch.cat([grad[:-1] / arrays["df_settle"], grad[-1:]])
    return npv, grad
