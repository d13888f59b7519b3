"""The trinomial tree's backward induction as CUDA launches
(``csrc/tree_kernel.cu``): one launch a step, one block a node row.

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
from .intrinsic_kernel import MODES, pack_steps

_ENTRY = {torch.float32: "stt_tree_dp_f32", torch.float64: "stt_tree_dp_f64"}


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


def tree_dp(
    arrays: tp.Dict[str, torch.Tensor],
    tree: tp.Dict[str, torch.Tensor],
    v_end: torch.Tensor,
    num_extra_decisions: int,
    ratchet_is_step: bool,
    mode: str,
    solver: tp.Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The backward induction over the tables of ``arrays`` (grids [N+1, G],
    costs, bands, ratchets; ``engines.lsmc.build_engine_arrays``) on the
    lattice of ``tree`` (spot [N+1, M], band [N, M, W], band_start [N, M]),
    from the terminal values ``v_end`` [M, G]: N launches, t = N−1 .. 0.
    ``mode`` is "linear" (uniform rows), "general" (any non-decreasing rows)
    or "cubic" (uniform rows, with ``solver`` [G-2, G-2] from
    ``interp.natural_cubic_solver``).  Returns the values [N+1, M, G] on the
    card.  Raises ``ValueError`` where G is beyond the shared memory a block
    can hold (``kernel_info``)."""
    grids = arrays["grids"].contiguous()
    n, g = grids.shape[0] - 1, grids.shape[1]
    dtype = grids.dtype
    if dtype not in _ENTRY:
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
    limit = kernel_info(g, dtype, mode, device)["max_grid"]
    if g > limit:
        raise ValueError(f"tree_dp: G={g} grid points; the kernel holds at most G={limit} in "
                         f"{dtype} {mode} mode in a block's shared memory")
    if cubic and (not given or tuple(solver.shape) != (g - 2, g - 2)):
        raise ValueError(f"tree_dp: cubic needs the [{g - 2}, {g - 2}] spline solver")
    want = {"spot": (n + 1, m), "band": (n, m, w), "band_start": (n, m), "v_end": (m, g)}
    for name, t in (("spot", spot), ("band", values_band), ("band_start", start),
                    ("v_end", v_end)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"tree_dp: {name} is {tuple(t.shape)}, want {want[name]}")
    values = torch.empty((n + 1, m, g), dtype=dtype, device=device)
    values[n].copy_(v_end)
    rc = getattr(_build.library(), _ENTRY[dtype])(
        n, m, g, w, r, num_extra_decisions, int(ratchet_is_step), MODES[mode], steps.data_ptr(),
        *(t.data_ptr() for t in ratchets), grids.data_ptr(), spot.data_ptr(),
        values_band.data_ptr(), start.data_ptr(), given[0].data_ptr() if cubic else None,
        values.data_ptr(), _build.stream_handle(device),
    )
    tree_dp.launches += n  # the C entry launches the step kernel once for each step
    _build.check(rc, "tree_dp")
    return values


tree_dp.launches = 0

_INFO_FIELDS = ("threads", "registers", "local_bytes", "smem_bytes", "blocks_per_sm", "max_grid")


@functools.lru_cache(maxsize=32)
def _info(is_double: bool, g: int, mode: int, device_index: int) -> dict:
    out = (ctypes.c_int * len(_INFO_FIELDS))()
    with torch.cuda.device(device_index):
        _build.check(_build.library().stt_tree_dp_info(int(is_double), g, mode, out),
                     "stt_tree_dp_info")
    return dict(zip(_INFO_FIELDS, out))


def kernel_info(g: int, dtype, mode: str, device) -> dict:
    """Launch report of the step kernel at G grid points in ``dtype`` and
    ``mode`` on a CUDA device: threads a block, registers and local (spill)
    bytes a thread, dynamic shared memory at G, blocks per SM at G (0 where
    G does not fit) and the largest G that fits a block's shared memory."""
    return _info(dtype == torch.float64, int(g), MODES[mode], torch.device(device).index or 0)
