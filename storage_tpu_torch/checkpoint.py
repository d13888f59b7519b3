"""Checkpoint / resume for LSMC valuations (counterpart of
``storage_tpu.checkpoint``).

The reference keeps the per-period regression coefficients as the hand-off
between the backward induction and the forward pass
(``regressCoeffsBuilder``, LsmcStorageValuation.cs:159,212,360) but discards
them afterwards.  Here they are a first-class artifact: a
``RegressionCheckpoint`` captures everything the forward pass needs, so a
valuation can be persisted and resumed, or re-priced forward-only against
fresh valuation paths (new seed, more sims, or user-supplied scenarios)
without re-running the backward induction.  On the card a revaluation is
one launch of the forward sweep (kernel C) and no backward kernel.

The file is the JAX package's (``np.savez_compressed`` with ``arrays.*``,
``regression.*`` and ``meta_json``): a checkpoint written by either package
loads in the other.  It stores no grid flag: a revaluation tests the stored
grid rows and places inventories on rows that are not evenly spaced (custom
grids) by search, as the pricing run did.  (The JAX package's revaluation
uses the evenly spaced arithmetic on every checkpoint, so it misplaces them
on such rows.)
"""
from __future__ import annotations

import dataclasses
import json
import typing as tp

import numpy as np
import torch

from . import grid as gridmod
from .api import Device, resolve_device
from .basis import Monomial, parse_basis_functions
from .engines import lsmc as lsmc_engine


def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


@dataclasses.dataclass(frozen=True, eq=False)
class RegressionCheckpoint:
    """Everything needed to run (only) the forward pass of an LSMC valuation."""

    arrays: tp.Dict[str, np.ndarray]  # engine arrays (grids, curves, costs, ...)
    regression: tp.Dict[str, np.ndarray]  # mean [N,B], std [N,B], coeffs [N,B,G]
    basis_funcs: str
    starting_inventory: float
    num_extra_decisions: int
    discount_deltas: bool
    ratchet_is_step: bool
    must_be_empty_at_end: bool

    @property
    def monomials(self) -> tp.Tuple[Monomial, ...]:
        return tuple(parse_basis_functions(self.basis_funcs))

    def save(self, path: str) -> None:
        meta = {
            "basis_funcs": self.basis_funcs,
            "starting_inventory": self.starting_inventory,
            "num_extra_decisions": self.num_extra_decisions,
            "discount_deltas": self.discount_deltas,
            "ratchet_is_step": self.ratchet_is_step,
            "must_be_empty_at_end": self.must_be_empty_at_end,
        }
        payload = {f"arrays.{k}": np.asarray(v) for k, v in self.arrays.items()}
        payload.update({f"regression.{k}": np.asarray(v) for k, v in self.regression.items()})
        payload["meta_json"] = np.frombuffer(
            json.dumps(meta).encode("utf-8"), dtype=np.uint8
        )
        np.savez_compressed(path, **payload)

    @staticmethod
    def load(path: str) -> "RegressionCheckpoint":
        with np.load(path) as data:
            meta = json.loads(bytes(data["meta_json"]).decode("utf-8"))
            arrays = {
                k.split(".", 1)[1]: data[k] for k in data.files if k.startswith("arrays.")
            }
            regression = {
                k.split(".", 1)[1]: data[k]
                for k in data.files
                if k.startswith("regression.")
            }
        return RegressionCheckpoint(arrays=arrays, regression=regression, **meta)


def make_checkpoint(
    arrays: tp.Dict[str, tp.Any],
    regression: tp.Dict[str, tp.Any],
    basis_funcs: str,
    starting_inventory: float,
    num_extra_decisions: int,
    discount_deltas: bool,
    ratchet_is_step: bool,
    must_be_empty_at_end: bool,
) -> RegressionCheckpoint:
    """A checkpoint of the engine arrays and the regression payload (tensors
    on any device, or numpy arrays)."""
    return RegressionCheckpoint(
        arrays={k: _host(v) for k, v in arrays.items()},
        regression={k: _host(v) for k, v in regression.items()},
        basis_funcs=basis_funcs,
        starting_inventory=float(starting_inventory),
        num_extra_decisions=int(num_extra_decisions),
        discount_deltas=bool(discount_deltas),
        ratchet_is_step=bool(ratchet_is_step),
        must_be_empty_at_end=bool(must_be_empty_at_end),
    )


def run_backward_to_checkpoint(
    arrays: tp.Dict[str, torch.Tensor],
    spot_reg: torch.Tensor,
    factors_reg: torch.Tensor,
    basis_funcs: str,
    starting_inventory: float,
    num_extra_decisions: int = 0,
    discount_deltas: bool = False,
    terminal_fn=None,
    ratchet_is_step: bool = False,
) -> RegressionCheckpoint:
    """Backward induction only (on the device of ``arrays``), returning the
    persistent checkpoint."""
    monomials = tuple(parse_basis_functions(basis_funcs))
    with lsmc_engine.full_f32_matmul():
        _, regression = lsmc_engine.lsmc_backward(
            arrays, spot_reg, factors_reg, monomials, num_extra_decisions,
            terminal_fn, ratchet_is_step,
        )
    return make_checkpoint(
        arrays, regression, basis_funcs, starting_inventory,
        num_extra_decisions, discount_deltas, ratchet_is_step,
        must_be_empty_at_end=terminal_fn is None,
    )


def revalue_from_checkpoint(
    checkpoint: RegressionCheckpoint,
    spot_val,
    factors_val,
    terminal_fn=None,
    return_sim_data: bool = False,
    dtype=None,
    *,
    device: Device = "cuda",
) -> tp.Dict[str, torch.Tensor]:
    """Forward-only re-pricing from a checkpoint against new valuation paths
    spot [N+1, S] and factors [N+1, F, S] (tensors or arrays), on ``device``
    (CUDA unless the caller asks for the CPU) in ``dtype`` (the paths' where
    None).  Returns ``engines.lsmc.lsmc_forward``'s results on ``device``; on
    grid rows that are not evenly spaced it takes the general-grid placement
    (``grid.rows_uniform``), as the pricing run did.

    ``terminal_fn`` must be re-supplied for non-empty-at-end storage
    (callables do not persist)."""
    if checkpoint.must_be_empty_at_end:
        terminal_fn = None
    elif terminal_fn is None:
        raise ValueError(
            "Checkpoint was created for storage with a terminal value; pass terminal_fn."
        )
    device = resolve_device(device)
    spot_val = torch.as_tensor(spot_val)
    dtype = dtype or spot_val.dtype
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    arrays = {k: as_t(v) for k, v in checkpoint.arrays.items()}
    regression = {k: as_t(v) for k, v in checkpoint.regression.items()}
    with lsmc_engine.full_f32_matmul():
        return lsmc_engine.lsmc_forward(
            arrays, as_t(spot_val), as_t(factors_val), regression,
            checkpoint.starting_inventory, checkpoint.monomials,
            checkpoint.num_extra_decisions, checkpoint.discount_deltas, terminal_fn,
            checkpoint.ratchet_is_step, return_sim_data=return_sim_data,
            uniform_grids=gridmod.rows_uniform(checkpoint.arrays["grids"]),
        )
