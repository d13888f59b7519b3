"""The intrinsic DP as one CUDA launch (``csrc/intrinsic_kernel.cu``).

No TPU kernel stands behind it: it replaces the backward and forward
``lax.scan`` of ``storage_tpu.engines.intrinsic._intrinsic_core``.  One block
runs the whole DP: it fills every backward step's decision table first (a
device-memory scratch the wrapper allocates), then values the grid points
of each backward step from its table on value rows kept in shared memory, a
barrier between steps, then warp 0 walks the forward from the starting
inventory through staged chunks of steps.  Shared memory bounds G
(``intrinsic_info``'s ``max_grid``; the JAX package has no such limit), and
the wrapper raises ``ValueError`` beyond it.  The plain version is ``engines.intrinsic.intrinsic_plain``, which
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
_ENTRY = {torch.float32: "stt_intrinsic_dp_f32", torch.float64: "stt_intrinsic_dp_f64"}


def table_len(g: int, e: int) -> int:
    """Values in one step's decision table (``csrc/dp_common.cuh``
    table_row): at each grid point the inventory cost's PV, then for each of
    the D = 2E + 3 decisions its volume, fuel, cost's PV and the
    continuation's node and weight."""
    return g * (1 + 5 * (2 * e + 3))


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
):
    """One launch of the DP over the tables of ``arrays`` (grids [N+1, G],
    curve, bands, costs, ratchets [N, R]; ``engines.lsmc.build_engine_arrays``)
    with the terminal values ``v_end`` [G] on the last grid.  ``mode`` is
    "linear" (uniform rows), "general" (any non-decreasing rows) or "cubic"
    (uniform rows, with ``solver`` [G-2, G-2] from
    ``interp.natural_cubic_solver``).  Returns the forward path (inventory
    after each decision, volume, fuel, loss and immediate PV, each [N]) and
    the final inventory [1], all on the card: nothing is read back.  Raises
    ``ValueError`` where G is beyond the block's shared memory
    (``intrinsic_info``)."""
    grids = arrays["grids"]
    n, g = grids.shape[0] - 1, grids.shape[1]
    dtype = grids.dtype
    if dtype not in _ENTRY:
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
    limit = intrinsic_info(dtype, device, g, r, num_extra_decisions, mode)["max_grid"]
    if g > limit:
        raise ValueError(f"intrinsic_dp: G={g} grid points; the kernel holds at most G={limit} "
                         f"in {dtype} {mode} mode in its block's shared memory")
    empty = lambda *shape: torch.empty(shape, dtype=dtype, device=device)  # noqa: E731
    vs = empty(n + 1, g)
    moments = empty(n + 1, g) if cubic else None
    table = empty(n * table_len(g, num_extra_decisions))
    out = empty(5 * n + 1)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = getattr(_build.library(), _ENTRY[dtype])(
        n, g, r, num_extra_decisions, int(ratchet_is_step), MODES[mode], steps.data_ptr(),
        *(t.data_ptr() for t in ratchets), grids.data_ptr(), v_end.data_ptr(),
        ptr(given[0] if cubic else None), float(starting_inventory), vs.data_ptr(), ptr(moments),
        table.data_ptr(), out.data_ptr(), _build.stream_handle(device),
    )
    intrinsic_dp.launches += 1
    _build.check(rc, "intrinsic_dp")
    return (*out[:5 * n].view(5, n), out[5 * n:])


intrinsic_dp.launches = 0

_INFO_FIELDS = ("threads", "registers", "local_bytes", "smem_bytes", "blocks_per_sm",
                "stage_table", "walk_lanes", "chunk", "max_grid")


@functools.lru_cache(maxsize=32)
def _info(is_double: bool, g: int, r: int, e: int, mode: int, device_index: int) -> dict:
    out = (ctypes.c_int * len(_INFO_FIELDS))()
    with torch.cuda.device(device_index):
        _build.check(_build.library().stt_intrinsic_dp_info(int(is_double), g, r, e, mode, out),
                     "stt_intrinsic_dp_info")
    return dict(zip(_INFO_FIELDS, out))


def intrinsic_info(dtype, device, g: int = 100, r: int = 3, e: int = 0,
                   mode: str = "linear") -> dict:
    """Launch report of the DP kernel in ``dtype`` at G grid points, R
    ratchet nodes and E extra decisions in ``mode`` on a CUDA device: the
    threads of its one block, registers and local (spill) bytes a thread,
    dynamic shared memory, blocks per SM (0 where G does not fit), whether
    the backward stages each step's decision table in shared memory (1) or
    reads it from device memory (0), lanes a step in the forward walk,
    forward steps staged a chunk (at N >= 32) and the largest G the block's
    shared memory holds (``max_grid``)."""
    return _info(dtype == torch.float64, int(g), int(r), int(e), MODES[mode],
                 torch.device(device).index or 0)
