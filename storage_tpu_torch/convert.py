"""Carry the JAX package's state into this package as numpy arrays, so that
both compute on identical inputs: engine arrays, simulation inputs, regression
payloads, path panels, raw threefry keys and trinomial lattices.  Nothing here imports JAX; the
caller hands over ``np.asarray`` of its arrays."""
from __future__ import annotations

import typing as tp

import numpy as np
import torch

from .models.trinomial_tree import TrinomialTree

Device = tp.Union[str, torch.device]


def _tensor(a, dtype, device: Device) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def engine_arrays_from_numpy(arrays: tp.Mapping[str, tp.Any], dtype,
                             device: Device) -> tp.Dict[str, torch.Tensor]:
    """The dict of ``engines.lsmc.build_engine_arrays`` (grids, curves, costs,
    ratchet tables)."""
    return {k: _tensor(v, dtype, device) for k, v in arrays.items()}


def sim_inputs_from_numpy(sim_inputs: tp.Mapping[str, tp.Any], dtype,
                          device: Device) -> tp.Dict[str, torch.Tensor]:
    """OU simulation inputs (decay, chol, vols, half_var, fwd) as the JAX
    package's ``parallel.mesh.sim_inputs_from_precompute`` builds them."""
    return {k: _tensor(sim_inputs[k], dtype, device)
            for k in ("decay", "chol", "vols", "half_var", "fwd")}


def regression_from_numpy(regression: tp.Mapping[str, tp.Any], dtype,
                          device: Device) -> tp.Dict[str, torch.Tensor]:
    """Per-step regression payload: mean [N, B], std [N, B], coeffs [N, B, G]."""
    return {k: _tensor(regression[k], dtype, device) for k in ("mean", "std", "coeffs")}


def panels_from_numpy(spot, factors, dtype, device: Device):
    """Path panels: spot [N+1, S] and factors [N+1, F, S]."""
    return _tensor(spot, dtype, device), _tensor(factors, dtype, device)


def key_words(key_data) -> tp.Tuple[int, int]:
    """Raw threefry key words (``jax.random.key_data(key)``) as Python ints."""
    words = np.asarray(key_data, dtype=np.uint32).reshape(-1)
    if words.shape != (2,):
        raise ValueError(f"expected two uint32 key words, got shape {words.shape}")
    return int(words[0]), int(words[1])


def tree_from_numpy(tree) -> TrinomialTree:
    """A lattice the JAX package built (its ``TrinomialTree`` of numpy
    arrays) as this package's ``TrinomialTree``, field by field."""
    return TrinomialTree(**{k: np.asarray(getattr(tree, k)) for k in TrinomialTree._fields})
