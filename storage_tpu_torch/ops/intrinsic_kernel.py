"""The intrinsic DP as one CUDA launch (``csrc/intrinsic_kernel.cu``).

No TPU kernel stands behind it: it replaces the backward and forward
``lax.scan`` of ``storage_tpu.engines.intrinsic._intrinsic_core``.  One launch
runs the whole DP, on one of two routes (``intrinsic_route``, from the
shape).  The shared route, one block, fills every backward step's decision
table first (a device-memory scratch the wrapper allocates), then values the
grid points of each backward step from its table on value rows kept in
shared memory, a barrier between steps, then warp 0 walks the forward from
the starting inventory through staged chunks of steps.  The large route, for
a G beyond what the block's shared memory holds (``max_grid``) or a table
scratch past ``TABLE_SCRATCH_CAP``, is one cooperative launch over the card
(``large_grid_blocks``): each backward step's grid points decided whole
across every SM on value rows in device memory, a grid barrier between
steps, then block 0's warp 0 walks; it needs no table scratch: any G.  Both
give the same bits.  The plain
version is ``engines.intrinsic.intrinsic_plain``, which
``engines.intrinsic.intrinsic_core`` runs for CPU tensors; this wrapper
takes CUDA tensors only, f32 or f64.
"""
from __future__ import annotations

import ctypes
import functools
import typing as tp

import torch

from . import _build

# Step scalar slots of the kernel's [N, 11] table (csrc/intrinsic_kernel.cu).
STEP_KEYS = ("fwd", "df_settle", "df_flow", "inj_cost", "wdr_cost", "inj_pcnt", "wdr_pcnt",
             "loss_pcnt", "inv_cost_rate", "next_min", "next_max")
MODES = {"linear": 0, "general": 1, "cubic": 2}
_ENTRY = {"shared": {torch.float32: "stt_intrinsic_dp_f32", torch.float64: "stt_intrinsic_dp_f64"},
          "large": {torch.float32: "stt_intrinsic_dp_large_f32",
                    torch.float64: "stt_intrinsic_dp_large_f64"}}
ROUTES = tuple(_ENTRY)
# The shared route's decision tables' scratch in bytes, N·G·(1 + 5D)
# elements, past which a shape takes the large route (which needs none):
# 2.3 MB at the headline, 16.3 GB for an hourly year at G = 29,034 in f32.
TABLE_SCRATCH_CAP = 2 << 30

# The kernel's sizing, copied from csrc/intrinsic_kernel.cu (plan<T> and
# max_grid<T>) so that the route is decided from shapes on any device;
# chip_smoke.py holds the copy to ``intrinsic_info``'s max_grid.  The block's
# shared memory holds, in elements: backward, the value rows [2][G] (cubic
# also the moments [2][G] and the rhs [G]), two stages of a step's scalars
# and ratchets and, where they fit, two of its decision table; forward, two
# chunks of K steps' scalars, ratchets and next rows (vs, the moments in
# cubic mode, the grid row on general rows or where it fits).
_SCALAR_SLOTS = 12
_MAX_CHUNK = 32
_FORWARD_BUDGET = 48 * 1024
_MAX_SEARCH = 1 << 20


def table_len(g: int, e: int) -> int:
    """Values in one step's decision table (``csrc/dp_common.cuh``
    table_row): at each grid point the inventory cost's PV, then for each of
    the D = 2E + 3 decisions its volume, fuel, cost's PV and the
    continuation's node and weight."""
    return g * (1 + 5 * (2 * e + 3))


def _plan_bytes(n: int, g: int, r: int, e: int, mode: str, itemsize: int, smem_limit: int) -> int:
    """The shared route's shared memory in bytes at this shape (plan<T>)."""
    general, cubic = mode == "general", mode == "cubic"
    tab = _SCALAR_SLOTS + 3 * r
    tab += tab & 1
    stage = 2 * g + (3 * g if cubic else 0)
    table = stage + 2 * tab
    with_table = table + 2 * table_len(g, e)
    backward = with_table if itemsize * with_table <= smem_limit else table
    budget = max(backward, _FORWARD_BUDGET // itemsize)
    rows = 2 if cubic else 1
    with_grid, without = tab + (rows + 1) * g, tab + (rows + general) * g
    f_step = with_grid if general or 2 * with_grid <= budget else without
    f_step += f_step & 1
    chunk = min(_MAX_CHUNK, n, max(1, budget // (2 * f_step)))
    return itemsize * max(backward, 2 * chunk * f_step)


@functools.lru_cache(maxsize=64)
def max_grid(r: int, e: int, mode: str, itemsize: int, smem_limit: int) -> int:
    """The largest G of the shared route at R ratchet nodes, E extra
    decisions, in ``mode`` and a dtype of ``itemsize`` bytes, under
    ``smem_limit`` bytes of shared memory a block (max_grid<T>'s search)."""
    def fits(g):
        return _plan_bytes(_MAX_CHUNK, g, r, e, mode, itemsize, smem_limit) <= smem_limit

    lo, hi = 2, _MAX_SEARCH
    if not fits(lo):
        return 0
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return lo


def intrinsic_route(g: int, r: int, e: int, mode: str, itemsize: int, smem_limit: int, n: int,
                    route: tp.Optional[str] = None) -> str:
    """The DP's route for N steps on G grid points, R ratchet nodes, E extra
    decisions in ``mode`` and a dtype of ``itemsize`` bytes, from the shape
    and the card's shared memory a block (``_build.smem_limit``): "shared"
    up to ``max_grid`` while the decision tables' scratch stays within
    ``TABLE_SCRATCH_CAP``, else "large".  Not a fallback: nothing is tried
    first.  ``route`` names one instead; "shared" beyond ``max_grid``
    raises ``ValueError``, as does an unknown name."""
    if mode not in MODES:
        raise ValueError(f"intrinsic_dp: mode must be one of {sorted(MODES)}, got {mode!r}")
    if route is not None and route not in ROUTES:
        raise ValueError(f"intrinsic_dp: route must be one of {ROUTES}, got {route!r}")
    limit = max_grid(r, e, mode, itemsize, smem_limit)
    if route is None:
        scratch = n * table_len(g, e) * itemsize
        return "shared" if g <= limit and scratch <= TABLE_SCRATCH_CAP else "large"
    if route == "shared" and g > limit:
        raise ValueError(f"intrinsic_dp: G={g} grid points; the shared route holds at most "
                         f"G={limit} in {mode} mode in its block's shared memory")
    return route


# The large route's blocks (csrc/intrinsic_kernel.cu kGridThreads).
GRID_THREADS = 256


def large_grid_blocks(g: int, mode: str, sms: int, blocks_per_sm: int) -> int:
    """The large route's cooperative grid on a card of ``sms`` SMs holding
    ``blocks_per_sm`` of its blocks (``intrinsic_info``'s
    large_blocks_per_sm): one grid point a thread up to every block the card
    holds, and every block it holds in cubic mode, whose moment rows read
    the dense inverse across every SM (a copy of csrc/intrinsic_kernel.cu
    large_grid_blocks, which chip_smoke.py holds to ``intrinsic_info``'s
    large_grid_blocks)."""
    if mode not in MODES:
        raise ValueError(f"intrinsic_dp: mode must be one of {sorted(MODES)}, got {mode!r}")
    resident = sms * blocks_per_sm
    return resident if mode == "cubic" else min(resident, -(-g // GRID_THREADS))


def pack_steps(arrays: tp.Dict[str, torch.Tensor]) -> torch.Tensor:
    """Each step's scalars as one row of the kernel's table [N, 11]: the
    forward price, discount factors, costs, fuel, loss and inventory cost,
    and the next period's band."""
    n = arrays["grids"].shape[0] - 1
    cols = {k: arrays[k] for k in STEP_KEYS[1:9]}
    cols.update(fwd=arrays["fwd"][:n], next_min=arrays["lower"][1:], next_max=arrays["upper"][1:])
    return torch.stack([cols[k] for k in STEP_KEYS], dim=1).contiguous()


def intrinsic_dp(
    arrays: tp.Dict[str, torch.Tensor],
    v_end: torch.Tensor,
    starting_inventory: float,
    num_extra_decisions: int,
    ratchet_is_step: bool,
    mode: str,
    solver: tp.Optional[torch.Tensor] = None,
    route: tp.Optional[str] = None,
):
    """One launch of the DP over the tables of ``arrays`` (grids [N+1, G],
    curve, bands, costs, ratchets [N, R]; ``engines.lsmc.build_engine_arrays``)
    with the terminal values ``v_end`` [G] on the last grid.  ``mode`` is
    "linear" (uniform rows), "general" (any non-decreasing rows) or "cubic"
    (uniform rows, with ``solver`` [G-2, G-2] from
    ``interp.natural_cubic_solver``).  The route is ``intrinsic_route``'s,
    chosen before anything is allocated (``route`` forces one):
    ``intrinsic_dp.launches`` counts every launch, ``large_launches`` those
    of the large route.  Returns the forward path (inventory after each
    decision, volume, fuel, loss and immediate PV, each [N]) and the final
    inventory [1], all on the card: nothing is read back."""
    grids = arrays["grids"]
    n, g = grids.shape[0] - 1, grids.shape[1]
    dtype = grids.dtype
    if dtype not in _ENTRY["shared"]:
        raise TypeError(f"intrinsic_dp: the kernel takes float32 or float64, got {dtype}")
    if mode not in MODES:
        raise ValueError(f"intrinsic_dp: mode must be one of {sorted(MODES)}, got {mode!r}")
    cubic = mode == "cubic"
    if cubic and (solver is None or tuple(solver.shape) != (g - 2, g - 2)):
        raise ValueError(f"intrinsic_dp: cubic needs the [{g - 2}, {g - 2}] spline solver")
    steps = pack_steps(arrays)
    ratchets = [arrays[k].contiguous() for k in ("ratchet_inv", "ratchet_min", "ratchet_max")]
    r = ratchets[0].shape[1]
    grids = grids.contiguous()
    given = [solver.contiguous()] if cubic else []
    device = _build.require_cuda("intrinsic_dp", grids, steps, *ratchets, v_end, *given,
                                 dtype=dtype)
    for name, t in zip(("ratchet_inv", "ratchet_min", "ratchet_max"), ratchets):
        if tuple(t.shape) != (n, r):
            raise ValueError(f"intrinsic_dp: {name} is {tuple(t.shape)}, want {(n, r)}")
    if tuple(v_end.shape) != (g,):
        raise ValueError(f"intrinsic_dp: v_end is {tuple(v_end.shape)}, want {(g,)}")
    route = intrinsic_route(g, r, num_extra_decisions, mode, dtype.itemsize,
                            _build.smem_limit(device), n, route)
    empty = lambda *shape: torch.empty(shape, dtype=dtype, device=device)  # noqa: E731
    vs = empty(n + 1, g)
    moments = empty(n + 1, g) if cubic else None
    # The shared route's decision tables, or the large route's rhs row for
    # the moments (cubic).
    scratch = (empty(n * table_len(g, num_extra_decisions)) if route == "shared"
               else empty(g - 2) if cubic and g > 2 else None)
    out = empty(5 * n + 1)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = getattr(_build.library(), _ENTRY[route][dtype])(
        n, g, r, num_extra_decisions, int(ratchet_is_step), MODES[mode], steps.data_ptr(),
        *(t.data_ptr() for t in ratchets), grids.data_ptr(), v_end.data_ptr(),
        ptr(given[0] if cubic else None), float(starting_inventory), vs.data_ptr(), ptr(moments),
        ptr(scratch), out.data_ptr(), _build.stream_handle(device),
    )
    intrinsic_dp.launches += 1
    intrinsic_dp.large_launches += route == "large"
    _build.check(rc, f"intrinsic_dp ({route} route)")
    return (*out[:5 * n].view(5, n), out[5 * n:])


intrinsic_dp.launches = 0
intrinsic_dp.large_launches = 0  # those of the large route, counted in launches too

_INFO_FIELDS = ("threads", "registers", "local_bytes", "smem_bytes", "blocks_per_sm",
                "stage_table", "walk_lanes", "chunk", "max_grid")
_LARGE_FIELDS = ("large_threads", "large_registers", "large_local_bytes", "large_smem_bytes",
                 "large_blocks_per_sm", "large_walk_lanes", "large_chunk", "large_grid_blocks",
                 "large_cooperative")


@functools.lru_cache(maxsize=32)
def _info(is_double: bool, g: int, r: int, e: int, mode: int, device_index: int) -> dict:
    lib = _build.library()
    out = (ctypes.c_int * len(_INFO_FIELDS))()
    large = (ctypes.c_int * len(_LARGE_FIELDS))()
    with torch.cuda.device(device_index):
        _build.check(lib.stt_intrinsic_dp_info(int(is_double), g, r, e, mode, out),
                     "stt_intrinsic_dp_info")
        _build.check(lib.stt_intrinsic_dp_large_info(int(is_double), g, r, e, mode, large),
                     "stt_intrinsic_dp_large_info")
    return {**dict(zip(_INFO_FIELDS, out)), **dict(zip(_LARGE_FIELDS, large))}


def intrinsic_info(dtype, device, g: int = 100, r: int = 3, e: int = 0,
                   mode: str = "linear") -> dict:
    """Launch report of the DP kernel in ``dtype`` at G grid points, R
    ratchet nodes and E extra decisions in ``mode`` on a CUDA device: the
    threads of its one block, registers and local (spill) bytes a thread,
    dynamic shared memory, blocks per SM (0 where G does not fit), whether
    the backward stages each step's decision table in shared memory (1) or
    reads it from device memory (0), lanes a step in the forward walk,
    forward steps staged a chunk (at N >= 32) and the largest G the block's
    shared memory holds (``max_grid``); then the large route's (any G; the
    ``large_*`` fields): threads a block, registers, local bytes, shared
    memory a block, blocks per SM, lanes a forward step, steps staged a
    chunk, the cooperative grid's blocks at G (``large_grid_blocks``) and 1
    for a cooperative launch."""
    return _info(dtype == torch.float64, int(g), int(r), int(e), MODES[mode],
                 torch.device(device).index or 0)
