"""Exact-step multi-factor OU spot price simulation (counterpart of
``storage_tpu.models.spot_sim``).

Draws are addressed by (key, path, step, factor) on the threefry counter
space exactly as in the JAX package: draw (step, factor) is word
``W = step·F + factor`` of path ``path_id`` under the fixed key (f32; f64
uses block ``step·F + factor`` whole, two words per normal).  Keys are the raw
threefry word pairs ``(k0, k1)``; ``key_from_seed`` and ``fold_in`` derive
them as ``jax.random.key`` and ``jax.random.fold_in`` do, so both packages
simulate the same paths from the same seeds.

``simulate_ou_paths`` runs in f32 as one launch of the simulation sweep on
the card (``ops.rng_kernel.simulate_sweep``): it draws, steps the factors and
builds the spot in registers, and writes only the factors and the spot.
``simulate_ou_segment`` resumes it at any step from the factor state entering
that step: the streamed engine regenerates its segments so.
``draw_normal_halves`` materialises the f32 draws themselves (kernel A,
``ops.rng_kernel.normal_halves``, on the card); the package's paths do not
call it: the tests and ``chip_smoke.py``'s TPU-numerics emulation do.

``MultiFactorSpotSim`` is the facade of the reference's simulator: spot (and
factor) frames of periods x sims from a model, a forward curve and a seed.
"""
from __future__ import annotations

import typing as tp

import numpy as np
import pandas as pd
import torch

from ..ops import rng_kernel
from ..ops.rng_kernel import MASK32
from ..utils import periods as pu
from . import multi_factor as mf

Key = tp.Tuple[int, int]


class SpotSimResults(tp.NamedTuple):
    spot: torch.Tensor  # [P, S]
    factors: torch.Tensor  # [P, F, S]


def key_from_seed(seed: int) -> Key:
    """Raw threefry key words of ``jax.random.key(seed)``."""
    seed = int(seed)
    return (seed >> 32) & MASK32, seed & MASK32


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in``: the key hashed at counter (0, data)."""
    w0, w1 = rng_kernel.threefry2x32(
        key[0], key[1], torch.zeros(1, dtype=torch.int64),
        torch.tensor([int(data) & MASK32], dtype=torch.int64),
    )
    return int(w0[0]), int(w1[0])


def _hash_counter_pairs(key: Key, hi, lo):
    """Both threefry words of every (hi, lo) counter pair (int64 tensors of
    uint32 values, any broadcastable shapes) under the fixed key."""
    return rng_kernel.threefry2x32(key[0], key[1], hi, lo)


def _path_ids(path_ids, antithetic: bool):
    return path_ids // 2 if antithetic else path_ids


def _antithetic_sign(path_ids, dtype):
    one = torch.ones((), dtype=dtype, device=path_ids.device)
    return torch.where(path_ids % 2 == 0, one, -one)


def draw_normal_halves(key: Key, start_step: int, num_steps: int, path_ids,
                       num_factors: int, antithetic: bool, dtype=torch.float32):
    """f32 bulk draws as block halves: (z1, z2) [nb, S], the normals of the
    first/second words of blocks b0..b0+nb-1 with b0 = (start·F)//2, plus b0.
    ``step_z_from_halves`` assembles each step's [F, S] draws from them."""
    if dtype != torch.float32:
        raise ValueError("draw_normal_halves is the f32 layout; f64 uses multi_step_normals")
    ids = _path_ids(path_ids, antithetic)
    if ids.device.type == "cuda":
        ids = ids.to(torch.int32)
    nb = (num_steps * num_factors) // 2 + 1
    b0 = (int(start_step) * num_factors) // 2
    sign = _antithetic_sign(path_ids, dtype) if antithetic else None
    z1, z2 = rng_kernel.normal_halves(key, b0, nb, ids, sign)
    return z1, z2, b0


def step_z_from_halves(z1, z2, b0: int, step: int, num_factors: int):
    """Step ``step``'s [F, S] draws: word W = step·F + i lives at block row
    W//2 − b0, half W%2.  A JAX-parity reference for the tests; the package's
    paths do not call it."""
    words = []
    for i in range(num_factors):
        w = step * num_factors + i
        words.append((z1 if w % 2 == 0 else z2)[w // 2 - b0])
    return torch.stack(words, dim=0)


def multi_step_normals(key: Key, start_step: int, num_steps: int, path_ids,
                       num_factors: int, antithetic: bool, dtype):
    """[T, F, S] draws for steps start..start+T-1 in one hash call, in either
    word layout (f64: one block per draw; f32: one word per draw)."""
    ids = _path_ids(path_ids, antithetic).to(torch.int64)
    t, f, s = int(num_steps), num_factors, ids.shape[0]
    device = ids.device
    if dtype == torch.float64:
        nb = t * f
        blocks = int(start_step) * f + torch.arange(nb, dtype=torch.int64, device=device)
        w1, w2 = _hash_counter_pairs(key, ids[None, :], blocks[:, None] & MASK32)
        z = rng_kernel.bits_to_normal(w1, w2, dtype).reshape(t, f, s)
    else:
        nw = t * f
        nb = nw // 2 + 1
        w0 = int(start_step) * f
        blocks = w0 // 2 + torch.arange(nb, dtype=torch.int64, device=device)
        w1, w2 = _hash_counter_pairs(key, ids[None, :], blocks[:, None] & MASK32)
        words = torch.stack([w1, w2], dim=1).reshape(2 * nb, s)
        words = words[w0 % 2: w0 % 2 + nw]
        z = rng_kernel.bits_to_normal(words, None, dtype).reshape(t, f, s)
    if antithetic:
        return z * _antithetic_sign(path_ids, dtype)[None, None, :]
    return z


def ou_step(x, z, decay_k, chol_k):
    """One exact OU transition in the [F, S] layout: x_k = decay_k ⊙ x_{k-1} + L_k z_k.
    The package's own paths do not call it (``simulate_ou_paths`` takes
    whole paths from the sweep); it stays as the JAX package's one-step form,
    held against it by the tests.

    L_k z_k is a full-f32 product.  The JAX package leaves its precision to
    the backend, and a TPU then multiplies bf16-rounded inputs: that alone
    moves the headline valuation's NPV by 1.3 standard errors (PERF.md)."""
    return x * decay_k[:, None] + chol_k @ z


def spot_from_state(x, fwd_k, half_var_k, vols_k):
    """ln S_k = ln F_k − half_var_k + vols_k·x, per path ([F, S] → [S]); as
    ``ou_step``, a JAX-parity reference that the package's paths do not call."""
    return torch.exp(torch.log(fwd_k) - half_var_k + vols_k @ x)


def simulate_ou_segment(
    key: Key,
    path_ids,  # [S] global path indices (int64)
    decay,  # [P, F] the tables of steps start..start+P-1
    chol,  # [P, F, F]
    vols,  # [P, F]
    c,  # [P] ln F - half_var
    start: int = 0,
    x0=None,  # [F, S] the state entering step ``start`` (zeros where None)
    antithetic: bool = False,
) -> SpotSimResults:
    """Steps start..start+P−1 of the given paths, resumed from the entry state
    ``x0`` (the JAX package's ``_regen_segment``): the rows of one simulation
    from step 0, to the bit.  f32 goes through the resumed simulation sweep
    (one launch on the card, its plain version on the CPU); f64 draws the
    steps' words (``multi_step_normals``) and steps them by the sweep's plain
    loop.  With ``antithetic`` path 2m+1 takes the negated draws of path 2m."""
    p, f = decay.shape
    if decay.dtype == torch.float32:
        ids = _path_ids(path_ids, antithetic)
        if ids.device.type == "cuda":
            ids = ids.to(torch.int32)
        sign = _antithetic_sign(path_ids, decay.dtype) if antithetic else None
        factors, spot = rng_kernel.simulate_sweep(key, ids, sign, decay, chol, vols, c, start, x0)
    else:
        z = multi_step_normals(key, start, p, path_ids, f, antithetic, decay.dtype)
        factors, spot = rng_kernel.ou_sweep_plain(z, decay, chol, vols, c, x0)
    return SpotSimResults(spot=spot, factors=factors)


def simulate_ou_paths(
    key: Key,
    path_ids,  # [S] global path indices (int64)
    decay,  # [P, F]
    chol,  # [P, F, F]
    vols,  # [P, F]
    half_var,  # [P]
    fwd,  # [P]
    antithetic: bool = False,
) -> SpotSimResults:
    """Factor states and spot prices of the given paths on the device of
    ``decay``:

    x_i(t_k) = decay[k,i]·x_i(t_{k-1}) + (L_k z_k)_i,  z_k ~ N(0, I);
    ln S_k = ln F_k − half_var[k] + Σ_i vols[k,i]·x_i(t_k).

    f32 goes through the simulation sweep (one kernel launch on the card, its
    plain version on the CPU); f64 draws in its own layout
    (``multi_step_normals``) and steps them by the sweep's plain loop: no
    kernel in either package (``simulate_ou_segment`` from step 0).  With
    ``antithetic`` path 2m+1 takes the negated draws of path 2m."""
    return simulate_ou_segment(key, path_ids, decay, chol, vols, torch.log(fwd) - half_var,
                               antithetic=antithetic)


class MultiFactorSpotSim:
    """Simulator facade, mirroring the reference ``MultiFactorSpotSim``
    (multi_factor_spot_sim.py:39-88) and the JAX package's: built from the
    factors, their correlations, the forward curve and the periods to
    simulate; ``simulate(num_sims)`` returns the spot prices as a frame of
    periods x sims, ``simulate_with_factors`` also one frame per factor.

    The paths are the JAX package's for the same seed (``key_from_seed``):
    threefry counter draws, not the reference's Mersenne Twister.  They are
    simulated on ``device`` (CUDA unless the caller names another) in
    ``dtype``: in f32 one launch of the simulation sweep per call, in f64
    the plain loop.  The frames hold the simulation's dtype, as the JAX
    package's do."""

    def __init__(
        self,
        freq: str,
        factors: tp.Collection[mf.FactorType],
        factor_corrs: mf.FactorCorrsType,
        current_date,
        fwd_curve: tp.Union[pd.Series, tp.Dict],
        sim_periods: tp.Iterable,
        seed: tp.Optional[int] = None,
        antithetic: bool = False,
        dtype=torch.float32,
        *,
        device="cuda",
    ):
        from ..api import resolve_device

        pandas_freq = pu.normalise_freq(freq)
        self._freq = pandas_freq
        periods = [
            p if isinstance(p, pd.Period) else pd.Period(p, freq=pandas_freq)
            for p in sim_periods
        ]
        self._periods = periods
        pre = mf.simulation_precompute(factors, factor_corrs, current_date, periods, freq)
        if isinstance(fwd_curve, pd.Series):
            curve = fwd_curve.copy()
            if not isinstance(curve.index, pd.PeriodIndex):
                curve.index = pd.PeriodIndex(curve.index, freq=pandas_freq)
            lookup = {p: float(v) for p, v in curve.items()}
        else:
            lookup = {
                (k if isinstance(k, pd.Period) else pd.Period(k, freq=pandas_freq)): float(v)
                for k, v in fwd_curve.items()
            }
        for p in periods:
            if p not in lookup:
                raise ValueError(f"Forward curve has no point for period {p}.")
        self._device = resolve_device(device)
        as_t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=self._device)  # noqa: E731
        self._decay = as_t(pre.decay)
        self._chol = as_t(pre.chol)
        self._vols = as_t(pre.vols)
        self._half_var = as_t(pre.half_var)
        self._fwd = as_t([lookup[p] for p in periods])
        self._key = key_from_seed(0 if seed is None else int(seed))
        self._antithetic = antithetic

    def _simulate(self, num_sims: int) -> SpotSimResults:
        ids = torch.arange(num_sims, dtype=torch.int64, device=self._device)
        return simulate_ou_paths(self._key, ids, self._decay, self._chol, self._vols,
                                 self._half_var, self._fwd, antithetic=self._antithetic)

    def _frame(self, data: torch.Tensor) -> pd.DataFrame:
        index = pd.PeriodIndex(self._periods, freq=self._freq)
        return pd.DataFrame(data=data.detach().cpu().numpy(), index=index)

    def simulate(self, num_sims: int) -> pd.DataFrame:
        return self._frame(self._simulate(num_sims).spot)

    def simulate_with_factors(self, num_sims: int) -> tp.Tuple[pd.DataFrame, tp.List[pd.DataFrame]]:
        """Spot frame plus one frame per Markov factor (for ``value_from_sims``)."""
        res = self._simulate(num_sims)
        return self._frame(res.spot), [self._frame(res.factors[:, i, :])
                                       for i in range(res.factors.shape[1])]
