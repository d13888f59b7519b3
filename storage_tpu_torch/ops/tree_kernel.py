"""The trinomial tree's backward induction as CUDA launches
(``csrc/tree_kernel.cu``) on one of three routes: the cluster route, one
launch a valuation of one thread-block cluster that keeps the node rows in
its shared memory and decides from step tables it fills first; for a slab
the cluster cannot hold, the large-slab route, one launch a step of one
block a node row; for rows too long for a block's shared memory, the large
route on rows in device memory: a launch fills a chunk of steps' decision
tables (``large_table_steps``), then each step an ev launch and a decide
launch (with a moments launch between them in cubic mode) decide every node
row from its step's table.  All give the same
bits.

No TPU kernel stands behind it: it replaces the ``lax.scan`` of
``storage_tpu.engines.tree._tree_core``.  The transition reaches the card as
a band (``band``): each period's row m holds its non-zeros in W adjacent
columns from ``start[t, m]``, W at most 2·num_substeps + 1, so nothing
[N, M, M] is copied there.  The plain version is
``engines.tree.tree_plain``, which ``engines.tree.tree_core`` runs for CPU
tensors; this wrapper takes CUDA tensors only, f32 or f64.
"""
from __future__ import annotations

import ctypes
import functools
import typing as tp

import numpy as np
import torch

from . import _build
from .intrinsic_kernel import MODES, pack_steps, table_len

_ENTRY = {"cluster": {torch.float32: "stt_tree_dp_f32", torch.float64: "stt_tree_dp_f64"},
          "steps": {torch.float32: "stt_tree_dp_steps_f32", torch.float64: "stt_tree_dp_steps_f64"},
          "large": {torch.float32: "stt_tree_dp_large_f32", torch.float64: "stt_tree_dp_large_f64"}}
ROUTES = tuple(_ENTRY)
# The large route's decision tables' scratch in bytes: the steps it holds
# are filled by one launch (all 16 of T1 at G = 65,536, 64 MiB in f32).
TABLE_SCRATCH_CAP = 1 << 28
# Node rows a block of the large route's decide takes at its grid points
# (csrc/tree_kernel.cu kDecideRows).
LARGE_DECIDE_ROWS = 4


def large_table_steps(n: int, g: int, e: int, itemsize: int) -> int:
    """Steps whose decision tables one launch of the large route fills into
    its scratch: as many as ``TABLE_SCRATCH_CAP`` holds, at least one, at
    most N."""
    return max(1, min(n, TABLE_SCRATCH_CAP // (table_len(g, e) * itemsize)))


def large_launches(n: int, g: int, e: int, mode: str, itemsize: int) -> int:
    """Launches of the large route for N steps: a table launch for each
    chunk of ``large_table_steps`` steps, and an ev and a decide launch a
    step (with a moments launch between them in cubic mode)."""
    chunk = large_table_steps(n, g, e, itemsize)
    return -(-n // chunk) + n * (3 if mode == "cubic" else 2)


def steps_max_grid(itemsize: int, mode: str, smem_limit: int) -> int:
    """The largest G of the large-slab route's block, a dtype of
    ``itemsize`` bytes in ``mode``, under ``smem_limit`` bytes of shared
    memory a block: a row's ev [G], and in cubic mode its moments [G] and
    rhs [G-2] (a copy of csrc/tree_kernel.cu step_smem_bytes, which
    chip_smoke.py holds to ``kernel_info``'s max_grid)."""
    per = smem_limit // itemsize
    return (per + 2) // 3 if mode == "cubic" else per


def band(transition: np.ndarray) -> tp.Tuple[np.ndarray, np.ndarray]:
    """The band of each period's transition [P, M, M]: (values [P, M, W],
    first column [P, M] int64) with ``transition[t, m, start[t, m] + w] =
    values[t, m, w]`` and every other entry of the row 0.  W is the widest
    row's span of non-zeros; a row's window is moved left where it would
    pass the last column (it then holds exact zeros at its start).  A
    matrix broadcast over the periods (``build_tree``'s view) is banded
    once."""
    t = np.asarray(transition)
    if t.ndim != 3 or t.shape[1] != t.shape[2]:
        raise ValueError(f"transition must be [P, M, M], got {t.shape}")
    p, m = t.shape[:2]
    if p > 1 and t.strides[0] == 0:
        values, start = band(t[:1])
        return (np.broadcast_to(values, (p,) + values.shape[1:]),
                np.broadcast_to(start, (p, m)))
    nonzero = t != 0
    first = nonzero.argmax(axis=-1)
    last = np.where(nonzero.any(axis=-1), m - 1 - nonzero[..., ::-1].argmax(axis=-1), first)
    width = int((last - first).max(initial=0)) + 1
    start = np.minimum(first, m - width).astype(np.int64)
    values = np.take_along_axis(t, start[..., None] + np.arange(width), axis=-1)
    return values, start


def dense(values: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """The [..., M, M] matrices of a band (values [..., M, W], start
    [..., M]): ``band``'s inverse."""
    m, w = values.shape[-2:]
    cols = start[..., None] + torch.arange(w, device=start.device)
    out = torch.zeros(values.shape[:-1] + (m,), dtype=values.dtype, device=values.device)
    return out.scatter_(-1, cols, values)


def choose_route(m: int, g: int, info: dict, route: tp.Optional[str] = None) -> str:
    """The route for an [M, G] slab, from ``kernel_info``'s report at that
    shape: the cluster route where its CTAs hold the M node rows
    (``max_rows``), else the large-slab route where a block holds a row's G
    points (``max_grid``), else the large route (any slab).  Not a
    fallback: nothing is tried first.  ``route`` names one instead, and
    raises ``ValueError`` where that route cannot take the slab, as does an
    unknown name."""
    if route is not None and route not in ROUTES:
        raise ValueError(f"tree_dp: route must be one of {ROUTES}, got {route!r}")
    fits = {"cluster": m <= info["max_rows"], "steps": g <= info["max_grid"], "large": True}
    if route is None:
        route = next(r for r in ROUTES if fits[r])
    if not fits[route]:
        raise ValueError(
            f"tree_dp: an [M={m}, G={g}] slab; the cluster route holds at most M="
            f"{info['max_rows']} node rows at this G, and the large-slab route at most "
            f"G={info['max_grid']} grid points in a block's shared memory")
    return route


def tree_route(m: int, g: int, w: int, e: int, mode: str, dtype, device,
               route: tp.Optional[str] = None) -> str:
    """The route ``tree_dp`` takes for an [M, G] slab of band width W and E
    extra decisions in ``dtype`` and ``mode`` on a CUDA device
    (``choose_route`` on ``kernel_info``'s report), from shapes alone,
    before anything is allocated or launched."""
    return choose_route(m, g, kernel_info(g, dtype, mode, device, m, w, e), route)


def tree_dp(
    arrays: tp.Dict[str, torch.Tensor],
    tree: tp.Dict[str, torch.Tensor],
    v_end: torch.Tensor,
    num_extra_decisions: int,
    ratchet_is_step: bool,
    mode: str,
    solver: tp.Optional[torch.Tensor] = None,
    route: tp.Optional[str] = None,
) -> torch.Tensor:
    """The backward induction over the tables of ``arrays`` (grids [N+1, G],
    costs, bands, ratchets; ``engines.lsmc.build_engine_arrays``) on the
    lattice of ``tree`` (spot [N+1, M], band [N, M, W], band_start [N, M]),
    from the terminal values ``v_end`` [M, G], t = N−1 .. 0.  ``mode`` is
    "linear" (uniform rows), "general" (any non-decreasing rows) or "cubic"
    (uniform rows, with ``solver`` [G-2, G-2] from
    ``interp.natural_cubic_solver``).  The route is ``tree_route``'s
    (``route`` forces one): the cluster route counts one launch in
    ``tree_dp.launches``, the large-slab route N in
    ``tree_dp.step_launches``, the large route ``large_launches`` (2N + 1 at
    T1's 16 steps, 3N + 1 in cubic mode) in ``tree_dp.large_launches``.
    Returns the values [N+1, M, G] on the card."""
    grids = arrays["grids"].contiguous()
    n, g = grids.shape[0] - 1, grids.shape[1]
    dtype = grids.dtype
    if dtype not in _ENTRY["steps"]:
        raise TypeError(f"tree_dp: the kernel takes float32 or float64, got {dtype}")
    if mode not in MODES:
        raise ValueError(f"tree_dp: mode must be one of {sorted(MODES)}, got {mode!r}")
    steps = pack_steps(arrays)
    ratchets = [arrays[k].contiguous() for k in ("ratchet_inv", "ratchet_min", "ratchet_max")]
    r = ratchets[0].shape[1]
    spot, values_band = tree["spot"].contiguous(), tree["band"].contiguous()
    start = tree["band_start"].contiguous()
    m, w = values_band.shape[1:]
    cubic = mode == "cubic"
    given = [solver.contiguous()] if cubic and solver is not None else []
    device = _build.require_cuda("tree_dp", grids, steps, *ratchets, spot, values_band, v_end,
                                 *given, dtype=dtype)
    _build.require_cuda("tree_dp", grids, start, dtype=None)
    if start.dtype != torch.int64:
        raise TypeError(f"tree_dp: band_start must be int64, got {start.dtype}")
    route = tree_route(m, g, w, num_extra_decisions, mode, dtype, device, route)
    if cubic and (not given or tuple(solver.shape) != (g - 2, g - 2)):
        raise ValueError(f"tree_dp: cubic needs the [{g - 2}, {g - 2}] spline solver")
    want = {"spot": (n + 1, m), "band": (n, m, w), "band_start": (n, m), "v_end": (m, g)}
    for name, t in (("spot", spot), ("band", values_band), ("band_start", start),
                    ("v_end", v_end)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"tree_dp: {name} is {tuple(t.shape)}, want {want[name]}")
    values = torch.empty((n + 1, m, g), dtype=dtype, device=device)
    values[n].copy_(v_end)
    # The routes' scratch, held until the launches are queued: the cluster
    # route's every step's decision table; the large route's decision tables
    # of a chunk of steps and the steps it holds, a step's ev [M, G] (never
    # values[t] itself: a grid point's decision reads ev at other points)
    # and in cubic mode its moments [M, G] and rhs [M, G-2].
    empty = lambda size: torch.empty(size, dtype=dtype, device=device)  # noqa: E731
    if route == "cluster":
        scratch = [empty(n * table_len(g, num_extra_decisions))]
    elif route == "large":
        chunk = large_table_steps(n, g, num_extra_decisions, dtype.itemsize)
        scratch = [empty(chunk * table_len(g, num_extra_decisions)), chunk, empty(m * g),
                   *((empty(m * g), empty(m * (g - 2))) if cubic else (None, None))]
    else:
        scratch = []
    rc = getattr(_build.library(), _ENTRY[route][dtype])(
        n, m, g, w, r, num_extra_decisions, int(ratchet_is_step), MODES[mode], steps.data_ptr(),
        *(t.data_ptr() for t in ratchets), grids.data_ptr(), spot.data_ptr(),
        values_band.data_ptr(), start.data_ptr(), given[0].data_ptr() if cubic else None,
        values.data_ptr(),
        *(t if t is None or isinstance(t, int) else t.data_ptr() for t in scratch),
        _build.stream_handle(device),
    )
    # The C entries of the step-wise routes launch their kernels for each step.
    if route == "cluster":
        tree_dp.launches += 1
    elif route == "steps":
        tree_dp.step_launches += n
    else:
        tree_dp.large_launches += large_launches(n, g, num_extra_decisions, mode, dtype.itemsize)
    _build.check(rc, f"tree_dp ({route} route)")
    return values


tree_dp.launches = 0
tree_dp.step_launches = 0
tree_dp.large_launches = 0

_STEP_FIELDS = ("threads", "registers", "local_bytes", "smem_bytes", "blocks_per_sm", "max_grid")
_CLUSTER_FIELDS = ("cluster_size", "cluster_threads", "cluster_registers", "cluster_local_bytes",
                   "cluster_smem_bytes", "cluster_blocks_per_sm", "rows_per_cta", "max_rows")
_LARGE_FIELDS = ("large_threads", "large_registers", "large_ev_registers",
                 "large_moments_registers", "large_local_bytes", "large_blocks_per_sm",
                 "large_launches_per_step", "large_table_registers")


@functools.lru_cache(maxsize=64)
def _info(is_double: bool, m: int, g: int, w: int, e: int, mode: int, device_index: int) -> dict:
    lib = _build.library()
    step = (ctypes.c_int * len(_STEP_FIELDS))()
    cluster = (ctypes.c_int * len(_CLUSTER_FIELDS))()
    large = (ctypes.c_int * len(_LARGE_FIELDS))()
    with torch.cuda.device(device_index):
        _build.check(lib.stt_tree_dp_info(int(is_double), g, mode, step), "stt_tree_dp_info")
        _build.check(lib.stt_tree_cluster_info(int(is_double), m, g, w, e, mode, cluster),
                     "stt_tree_cluster_info")
        _build.check(lib.stt_tree_dp_large_info(int(is_double), mode, large),
                     "stt_tree_dp_large_info")
    return {**dict(zip(_STEP_FIELDS, step)), **dict(zip(_CLUSTER_FIELDS, cluster)),
            **dict(zip(_LARGE_FIELDS, large))}


def kernel_info(g: int, dtype, mode: str, device, m: int = 1, w: int = 1, e: int = 0) -> dict:
    """Launch report of both routes for an [M, G] slab of band width W and E
    extra decisions in ``dtype`` and ``mode`` on a CUDA device.  The
    large-slab route's step kernel: threads a block, registers and local
    (spill) bytes a thread, dynamic shared memory at G, blocks per SM at G
    (0 where G does not fit) and the largest G a block holds
    (``max_grid``).  The cluster route: its cluster size (16 CTAs where the
    card co-schedules them, else 8; 0 where the slab does not fit), threads,
    registers and local bytes a thread, shared memory a CTA, CTAs per SM,
    node rows a CTA and the most node rows the cluster holds at this G
    (``max_rows``).  The large route (any slab; the ``large_*`` fields):
    threads a block, registers a thread of its decide, ev and moments
    kernels (the last cubic only, else 0), local bytes, decide blocks per
    SM, launches a step (ev and decide, and moments in cubic mode) and its
    table kernel's registers.  ``route`` is the one ``tree_dp`` takes
    for the slab."""
    info = dict(_info(dtype == torch.float64, int(m), int(g), int(w), int(e), MODES[mode],
                      torch.device(device).index or 0))
    info["route"] = choose_route(m, g, info)
    return info


def chain_step_ns(kind: str, device, threads: int = 1024, size: int = 16,
                  iters: int = 20_000) -> float:
    """Nanoseconds of one link of a DP's chain on the card
    (``csrc/chain_floor.cu``).  ``kind`` "block": one block of ``threads``
    threads, each step ended by ``__syncthreads`` and reading a value
    another thread wrote before it (the intrinsic DP's shared route's link);
    "cluster": one cluster of ``size`` CTAs, each step ended by the cluster
    barrier and reading the next CTA's shared memory (the tree's cluster
    route's link); "grid": a cooperative launch of ``size`` blocks of
    ``threads``, each step a read of the next block's word in device memory
    and a grid sync (the intrinsic DP's large route's link at a grid of that
    many blocks); "launch": a launch a step of ``size`` blocks, each reading
    a word the launch before wrote (the tree's large route's link).  CUDA
    events around ``iters`` links less none, the median of three.  A timing
    kernel only: no path launches it."""
    kinds = {"block": 0, "cluster": 1, "grid": 2, "launch": 3}
    if kind not in kinds:
        raise ValueError(f"chain_step_ns: kind must be one of {sorted(kinds)}, got {kind!r}")
    device = torch.device(device)
    lib, stream = _build.library(), _build.stream_handle(device)
    samples = []
    for _ in range(3):
        ms = []
        for count in (0, iters):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            rc = lib.stt_chain_steps(kinds[kind], size, threads, count, stream)
            end.record()
            _build.check(rc, "stt_chain_steps")
            torch.cuda.synchronize(device)
            ms.append(start.elapsed_time(end))
        samples.append(1e6 * (ms[1] - ms[0]) / iters)
    return sorted(samples)[1]
