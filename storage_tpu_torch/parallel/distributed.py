"""Multi-process execution (the counterpart of
``storage_tpu.parallel.distributed``) on ``torch.distributed``.

* ``initialize`` forms the process group: under ``torchrun`` (torch's own
  ``torch.distributed.run``) from its environment (``env://``), or from an
  explicit coordinator address, process count and rank; NCCL where the host
  has a card, gloo otherwise (or as asked).  Each process then drives one
  card, its local rank's, unless ``local_device_ids`` names another.
* ``global_mesh`` is the world group, the paths mesh of ``parallel.mesh``.
* ``host_local_sims_to_global`` takes each process's block of simulated
  paths as its share of one global panel (process p owns global sims
  [p·S_local, (p+1)·S_local)), after checking that every process holds a
  block of the same shape.
* ``replicate_to_global`` and ``replicate_key`` give every rank rank 0's
  copy of inputs that are the same on each by construction.

A group that was asked for and does not form raises (``init_process_group``
times out or refuses); nothing here falls back to fewer ranks.  Reduced
outputs are the same on every rank; per-sim panels stay the rank's own.
"""
from __future__ import annotations

import datetime
import os
import typing as tp

import numpy as np
import torch
import torch.distributed as dist

from . import reduce as preduce
from .mesh import make_mesh


def initialize(
    coordinator_address: tp.Optional[str] = None,
    num_processes: tp.Optional[int] = None,
    process_id: tp.Optional[int] = None,
    local_device_ids: tp.Optional[tp.Sequence[int]] = None,
    *,
    backend: tp.Optional[str] = None,
    timeout: tp.Optional[datetime.timedelta] = None,
) -> None:
    """Form the process group of this job (a no-op where it is formed).

    With every argument None the group comes from the environment that
    ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``); otherwise pass ``coordinator_address``
    ('host:port'), ``num_processes`` and ``process_id``.  ``backend`` is
    NCCL where the host has a card and gloo otherwise; gloo on a card is the
    way to run two ranks on one card, which NCCL refuses.  On a card, the
    process takes ``local_device_ids[0]``, else its local rank
    (``LOCAL_RANK``, or ``process_id``), as its current device.
    ``timeout`` bounds forming the group and each collective (torch's
    default where None)."""
    if is_initialized():
        return
    cuda = torch.cuda.is_available()
    backend = backend or ("nccl" if cuda else "gloo")
    kwargs: tp.Dict[str, tp.Any] = {"backend": backend}
    if timeout is not None:
        kwargs["timeout"] = timeout
    if coordinator_address is None:
        kwargs["init_method"] = "env://"
        local_rank = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
    else:
        if num_processes is None or process_id is None:
            raise ValueError("initialize: a coordinator address needs num_processes and "
                             "process_id")
        kwargs.update(init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
                      rank=int(process_id))
        local_rank = int(process_id)
    if cuda:
        device = local_device_ids[0] if local_device_ids else local_rank % torch.cuda.device_count()
        torch.cuda.set_device(int(device))
    dist.init_process_group(**kwargs)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def global_mesh():
    """The paths mesh over every process of the job: the world group (None,
    a group of one, outside a job)."""
    return make_mesh()


def check_uniform(shapes: tp.Sequence[tp.Sequence[int]], mesh=None) -> None:
    """Raises ``ValueError`` on every rank where the ranks' ``shapes`` (a
    list of shapes) differ: one all-gather of them."""
    mesh = global_mesh() if mesh is None else mesh
    flat = [int(d) for shape in shapes for d in (len(shape), *shape)]
    gathered = preduce.gather_ints(flat, mesh)
    if not bool((gathered == gathered[0]).all()):
        raise ValueError(f"simulation panel shapes differ across processes: {gathered.tolist()}; "
                         "every process must supply path blocks of identical shape.")


def raise_if_any_failed(error: tp.Optional[BaseException], mesh=None) -> None:
    """Re-raises ``error`` where this rank failed, and raises
    ``RuntimeError`` on the others where any rank did, so that no rank waits
    in a later collective for one that left (one all-reduce)."""
    mesh = global_mesh() if mesh is None else mesh
    if preduce.any_rank(error is not None, mesh):
        if error is not None:
            raise error
        raise RuntimeError("another process of the group failed to prepare its paths")


def host_local_sims_to_global(spot_local, factors_local, mesh=None):
    """This process's block of paths, spot [N+1, S_local] and factors
    [N+1, F, S_local] (tensors or numpy arrays), as its share of the global
    panel: process p's block is global sims [p·S_local, (p+1)·S_local), the
    block the engine of ``parallel.mesh`` takes on rank p.  Checks that
    every process holds blocks of one shape (raising ``ValueError`` on
    every rank where they differ) and returns the blocks."""
    mesh = global_mesh() if mesh is None else mesh
    check_uniform([tuple(spot_local.shape), tuple(factors_local.shape)], mesh)
    return spot_local, factors_local


def _broadcast_leaf(x, mesh):
    if isinstance(x, torch.Tensor):
        nccl = dist.get_backend(mesh) == "nccl"
        t = x.detach().clone() if x.is_cuda or not nccl else x.detach().to(preduce.comm_device(mesh))
        dist.broadcast(t, src=dist.get_global_rank(mesh, 0), group=mesh)
        return t.to(x.device)
    if isinstance(x, np.ndarray):
        return _broadcast_leaf(torch.from_numpy(np.ascontiguousarray(x)), mesh).numpy()
    if isinstance(x, dict):
        return {k: _broadcast_leaf(v, mesh) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_broadcast_leaf(v, mesh) for v in x)
    return x


def replicate_to_global(tree, mesh=None):
    """Rank 0's copy of every tensor and array leaf of ``tree`` (dicts,
    lists and tuples; other leaves as they are) on every rank, a broadcast
    each.  The inputs it is meant for are the same on every rank by
    construction (engine tables built from the same valuation inputs); the
    broadcast makes that so.  Returns ``tree`` itself outside a group of
    more than one rank."""
    mesh = global_mesh() if mesh is None else mesh
    if preduce.active(mesh) is None:
        return tree
    return _broadcast_leaf(tree, mesh)


def replicate_key(key, mesh=None):
    """Rank 0's threefry key (a (k0, k1) pair of words) on every rank."""
    mesh = global_mesh() if mesh is None else mesh
    if preduce.active(mesh) is None:
        return key
    words = _broadcast_leaf(torch.tensor([int(k) for k in key], dtype=torch.int64), mesh)
    return tuple(int(w) for w in words.tolist())
