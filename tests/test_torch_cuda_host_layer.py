"""The host layer's kernels on the card: kernel C's design mode, a generic
basis valued through the entry point, and ``MultiFactorSpotSim``.  Marked
``cuda``: they need an NVIDIA GPU and nvcc, and skip elsewhere.  This file
imports no JAX, so it runs on the card with
``python -m pytest --noconftest tests/test_torch_cuda_host_layer.py``.

Tolerances: the design mode does the monomial mode's arithmetic on a design
the monomials would build, so the same bits; a generic basis that replicates
a monomial one regresses by kernel D and the plain normal equations where
the monomial basis runs kernel B's moments, so its NPV agrees within f32
regression noise (a tenth of a standard error).
"""
import numpy as np
import pandas as pd
import pytest
import torch

import storage_tpu_torch as tpkg
from storage_tpu_torch import basis as tbasis
from storage_tpu_torch.models import multi_factor as mf
from storage_tpu_torch.models import spot_sim
from storage_tpu_torch.ops import decision_kernel, forward_kernel, rng_kernel

from _torch_sweep_case import BASIS_9, sweep_case


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _on(case, device):
    """The case in f32 on the card, its design rebuilt from the f32 paths (as
    the monomial mode builds it), not rounded from the f64 one."""
    out = {k: (v.to(device, torch.float32).contiguous() if isinstance(v, torch.Tensor) else v)
           for k, v in case.items()}
    out["design"] = torch.stack(tbasis.design_columns(out["entries"], out["spot"],
                                                      out["factors"]), dim=1)
    return out


def _tables(c):
    return (c["params"], c["mean"], c["std"], c["ratchet_inv"], c["ratchet_min"],
            c["ratchet_max"])


@pytest.mark.cuda
@pytest.mark.parametrize("s", [300, 1000])
def test_design_mode_is_the_monomial_modes_bits(device, s):
    """On the monomials' own design, C's design mode computes what the
    monomial mode does, step for step: the same bits, panels included."""
    c = _on(sweep_case(s=s), device)
    n = c["spot"].shape[0]
    mono_panels = [torch.empty((n, s), device=device) for _ in range(4)]
    design_panels = [torch.empty((n, s), device=device) for _ in range(4)]
    mono = forward_kernel.forward_sweep(*_tables(c), c["spot"], c["factors"], c["inventory"], None,
                                        c["coeffs"], c["entries"], 1, False, panels=mono_panels)
    before = forward_kernel.forward_sweep_design.launches
    got = forward_kernel.forward_sweep_design(*_tables(c), c["spot"], c["design"], c["inventory"],
                                              None, c["coeffs"], 1, False, panels=design_panels)
    torch.cuda.synchronize()
    assert forward_kernel.forward_sweep_design.launches == before + 1
    for x, y in zip((*got, *design_panels), (*mono, *mono_panels)):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_forward_sweep_generic_launches_once_a_chunk(device):
    c = _on(sweep_case(n=40, s=500), device)
    entries = (*c["entries"][:-1], tbasis.generic(lambda sp, x: sp * sp, label="s*s"))
    want = forward_kernel.forward_sweep(*_tables(c), c["spot"], c["factors"], c["inventory"], None,
                                        c["coeffs"], c["entries"], 0, True)
    before = forward_kernel.forward_sweep_design.launches
    got = forward_kernel.forward_sweep_generic(*_tables(c), c["spot"], c["factors"],
                                               c["inventory"], c["coeffs"], entries, 0, True)
    torch.cuda.synchronize()
    assert forward_kernel.forward_sweep_design.launches - before == -(-40 // forward_kernel.DESIGN_CHUNK)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_design_mode_checks_its_inputs(device):
    c = _on(sweep_case(n=2, s=64), device)
    wide = c["design"].repeat(1, 2, 1)  # 18 design values against 9 coefficient rows
    with pytest.raises(ValueError, match="design is"):
        forward_kernel.forward_sweep_design(*_tables(c), c["spot"], wide, c["inventory"], None,
                                            c["coeffs"], 0, False)
    with pytest.raises(TypeError):
        forward_kernel.forward_sweep_design(*_tables(c), c["spot"], c["design"].double(),
                                            c["inventory"], None, c["coeffs"], 0, False)
    info = forward_kernel.kernel_info(100, 9, 3, 0, 0, device, design=True)
    assert info["blocks_per_sm"] > 0 and info["max_grid"] > 1000


def _storage_case():
    start = pd.Period("2021-01-01", freq="D")
    storage = tpkg.CmdtyStorage(
        "D", start, start + 40, 0.9, 0.7,
        ratchets=[(start, [(0.0, -200.0, 300.0), (2500.0, -250.0, 250.0),
                           (5000.0, -300.0, 200.0)])],
        ratchet_interp=tpkg.RatchetInterp.LINEAR,
        terminal_storage_npv=lambda price, inv: price * inv,
    )
    idx = pd.period_range(start, storage.end, freq="D")
    fwd = pd.Series(index=idx, data=30.0 + 6 * np.sin(2 * np.pi * np.arange(len(idx)) / 365.0))
    return storage, start, fwd


@pytest.mark.cuda
def test_generic_basis_values_on_the_card(device):
    """A generic basis replicating the 9 monomials through the entry point:
    kernel D once a step and C's design mode once a chunk, no kernel B; its
    NPV within 0.1 SE of the monomial valuation's."""
    storage, start, fwd = _storage_case()
    replica = [tpkg.ONE, lambda s, x: x[0], lambda s, x: x[1], lambda s, x: x[2],
               lambda s, x: x[0] * x[0], lambda s, x: x[1] * x[1], lambda s, x: x[2] * x[2],
               lambda s, x: s, lambda s, x: s * s]
    replica = [tpkg.generic(f, 3) if callable(f) else f for f in replica]

    def value(basis):
        return tpkg.three_factor_seasonal_value(storage, start, 100.0, fwd, 0.02, None, 14.5, 1.1,
                                                0.19, 0.23, 65_536, basis, False, seed=11,
                                                fwd_sim_seed=13, device="cuda")

    mono = value(BASIS_9)
    counters = (decision_kernel.decision_update, decision_kernel.decision_update_moments,
                forward_kernel.forward_sweep, forward_kernel.forward_sweep_design)
    before = [f.launches for f in counters]
    gen = value(replica)
    launches = [f.launches - b for f, b in zip(counters, before)]
    assert launches == [40, 0, 0, -(-40 // forward_kernel.DESIGN_CHUNK)]
    assert abs(gen.npv - mono.npv) <= 0.1 * mono.val_sim_standard_error


@pytest.mark.cuda
def test_spot_sim_on_the_card_is_the_sweep(device):
    storage, start, fwd = _storage_case()
    factors, corrs = mf.create_3_factor_seasonal_params(
        "D", 14.5, 1.1, 0.19, 0.23, start, storage.end)
    periods = list(fwd.index)
    sim = tpkg.MultiFactorSpotSim("D", factors, corrs, start, fwd, periods, seed=11)
    before = rng_kernel.simulate_sweep.launches
    frame = sim.simulate(1000)
    assert rng_kernel.simulate_sweep.launches == before + 1
    pre = mf.simulation_precompute(factors, corrs, start, periods, "D")
    sim_in = [torch.tensor(np.asarray(a), dtype=torch.float32, device=device)
              for a in (pre.decay, pre.chol, pre.vols, pre.half_var, fwd.to_numpy())]
    want = spot_sim.simulate_ou_paths(spot_sim.key_from_seed(11),
                                      torch.arange(1000, device=device), *sim_in).spot
    np.testing.assert_array_equal(frame.to_numpy(), want.cpu().numpy().astype(np.float64))
