"""The basis DSL of storage_tpu_torch and the generic-basis path against the
JAX package.

* Coercion: every string, combinator, mixed-list and ``+``-sum form gives
  the JAX package's entries (the same monomials, generics in the same
  places); a DSL string inside a list parses; a list coerces in time linear
  in its length; the JAX package's errors are kept.
* The design matrix with generic columns (broadcast scalars too) equals the
  JAX package's in f64.
* A basis with a user callable runs kernel D backward and kernel C's design
  mode forward.  On the CPU their plain versions run, and the valuation
  agrees with the JAX package's XLA path in f64 (the same normal equations
  and argmax, so to f64 rounding: 1e-9); a generic basis that replicates
  a monomial one gives the monomial valuation.
* The design mode's plain version: the same bits as the monomial sweep on
  the monomials' design, and the same bits chunked as whole.  The card's
  tests of the kernel are in ``test_torch_cuda_host_layer.py``.
"""
import gc
import re
import time

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import storage_tpu as jpkg
import storage_tpu.basis as jbasis
import storage_tpu_torch as tpkg
import storage_tpu_torch.basis as tbasis
from storage_tpu_torch.engines import lsmc as torch_lsmc
from storage_tpu_torch.ops import forward_kernel

from _torch_sweep_case import sweep_case

torch.set_num_threads(1)

RTOL = 1e-9  # f64: the same arithmetic up to summation order
MONO_2F = "1 + x0 + x0**2 + x1 + x1*x1"


def _shape(entries):
    """Entries as comparable values across the packages: a monomial as its
    tuple, a generic as its label and factor count."""
    out = []
    for e in entries:
        if isinstance(e, (jbasis.GenericBasisFunction, tbasis.GenericBasisFunction)):
            out.append(("generic", e.label, e.num_factors))
        else:
            out.append(("monomial", e.spot_power, tuple(e.factor_powers)))
    return out


FORMS = {
    "string": lambda b: "1 + s + s**2 + x0 + x0**2 + s*x1",
    "aliases": lambda b: "1 + x_st + x_lt**2 + s*x_sw",
    "combinator": lambda b: b.ONE + b.S + b.S ** 2 + b.X0 + b.X0 ** 2 + b.S * b.X1,
    "literal-one": lambda b: 1 + b.S + b.S ** 2 * b.X2,
    "times-one": lambda b: b.S * 1 + 1 * b.X1,
    "alias-atoms": lambda b: b.X_ST + b.X_LT * b.X_SW + b.X(7) ** 3,
    "powers": lambda b: b.ONE + b.spot_price_power(3) + b.markov_factor_power(1, 2),
    "atom": lambda b: b.X2,
    "mixed-list": lambda b: [b.ONE, b.S, b.S ** 2, b.X0, b.Monomial(0, ((1, 1),)),
                             b.generic(lambda s, x: x[0], num_factors=1, label="g"),
                             b.S * b.X1 + b.X2],
    "tuple": lambda b: (b.X0, b.Monomial(2, ()), b.generic(lambda s, x: s, label="s")),
    "generic-sum": lambda b: b.ONE + b.X0 + b.generic(lambda s, x: x[0], 1, label="t"),
    "generic-radd": lambda b: b.generic(lambda s, x: s, label="a") + b.ONE + b.S,
    "sum-of-lists": lambda b: b.ONE + [b.S, b.X1 ** 2],
    "single-generic": lambda b: b.generic(lambda s, x: s, label="only"),
}


@pytest.mark.parametrize("form", list(FORMS))
def test_coercion_matches_jax(form):
    want = jbasis.coerce_basis_functions(FORMS[form](jbasis))
    got = tbasis.coerce_basis_functions(FORMS[form](tbasis))
    assert _shape(got) == _shape(want)
    assert all(isinstance(e, tbasis.Monomial | tbasis.GenericBasisFunction) for e in got)


def test_bare_callable_wraps_as_generic():
    def cube(s, x):
        return s * s * s

    got = tbasis.coerce_basis_functions([tbasis.ONE, cube])
    assert isinstance(got[1], tbasis.GenericBasisFunction) and got[1].fn is cube
    assert _shape(got) == _shape(jbasis.coerce_basis_functions([jbasis.ONE, cube]))
    assert tbasis.has_generic(got) and not tbasis.has_generic(got[:1])


def test_string_inside_a_list_parses():
    """The JAX package raises TypeError on a DSL string inside a list; the
    port parses it where it stands."""
    got = tbasis.coerce_basis_functions(["1 + s", tbasis.X0, "x1**2"])
    want = jbasis.coerce_basis_functions("1 + s + x0 + x1**2")
    assert _shape(got) == _shape(want)
    with pytest.raises(TypeError):
        jbasis.coerce_basis_functions(["1 + s", jbasis.X0])
    with pytest.raises(ValueError, match="repeated"):
        tbasis.coerce_basis_functions(["1 + s", tbasis.S])


def test_list_coercion_is_linear():
    """Coercing a list takes time linear in its length (the JAX package's
    copy grows the list term by term, which is quadratic): 5,000 entries
    within 20x of 500, where linear is 10x and quadratic 100x.  Timed in
    the process's CPU seconds with the garbage collector off, so that other
    processes on a loaded host and a collection mid-call do not count."""

    def best(n):
        entries = [tbasis.S ** i * tbasis.X0 for i in range(n)]
        times = []
        gc.disable()
        try:
            for _ in range(7):
                t0 = time.process_time()
                out = tbasis.coerce_basis_functions(entries)
                times.append(time.process_time() - t0)
        finally:
            gc.enable()
        assert len(out) == n
        return min(times)

    best(500)  # warm-up
    assert best(5000) < 20.0 * best(500)


@pytest.mark.parametrize("case", ["repeated", "repeated-mixed", "not-callable", "negative-factors",
                                  "bad-power", "negative-index", "bad-term", "bad-token", "none"])
def test_errors_match_jax(case):
    calls = {
        "repeated": lambda b: b.coerce_basis_functions(b.ONE + b.S + b.S),
        "repeated-mixed": lambda b: b.coerce_basis_functions([b.ONE, b.S, 1]),
        "not-callable": lambda b: b.generic(3.0),
        "negative-factors": lambda b: b.generic(lambda s, x: s, num_factors=-1),
        "bad-power": lambda b: b.S ** 1.5,
        "negative-index": lambda b: b.X(-1),
        "bad-term": lambda b: b.coerce_basis_functions([b.ONE, 2.5]),
        "bad-token": lambda b: b.coerce_basis_functions("1 + y0"),
        "none": lambda b: b.parse_basis_functions(None),
    }
    with pytest.raises(Exception) as want:
        calls[case](jbasis)
    with pytest.raises(type(want.value), match=re.escape(str(want.value))):
        calls[case](tbasis)


def test_num_factors_required_counts_generics():
    for b in (jbasis, tbasis):
        entries = b.coerce_basis_functions(
            [b.ONE, b.X1, b.generic(lambda s, x: x[3], num_factors=4)])
        assert b.num_factors_required(entries) == 4
        assert b.num_factors_required(b.coerce_basis_functions("1 + s")) == 0


def test_design_matrix_matches_jax_f64():
    rng = np.random.default_rng(3)
    spot = 20.0 + 5.0 * rng.standard_normal(64)
    factors = rng.standard_normal((3, 64))

    def entries(b, xp):
        return b.coerce_basis_functions(
            b.coerce_basis_functions("1 + s + x1 + s**2*x2")
            + [b.generic(lambda s, x: xp.exp(-x[0]), num_factors=1, label="exp(-x0)"),
               b.generic(lambda s, x: 2.5, label="scalar"),
               b.generic(lambda s, x: s[:1] * 0.0 + 7.0, label="broadcast [1]"),
               b.generic(lambda s, x: (x[2] > 0) * s, num_factors=3, label="indicator")])

    want = np.asarray(jbasis.design_matrix(tuple(entries(jbasis, jnp)), jnp.asarray(spot),
                                           jnp.asarray(factors)))
    got = tbasis.design_matrix(tuple(entries(tbasis, torch)), torch.tensor(spot),
                               torch.tensor(factors)).numpy()
    assert got.shape == want.shape == (64, 8) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)


def test_design_columns_call_generics_one_period_at_a_time():
    """Over leading axes (the engine's chunks of steps) a generic entry still
    sees [S] and [F, S]: ``x[0]`` is factor 0, never step 0."""
    seen = []

    def first_factor(s, x):
        seen.append((tuple(s.shape), tuple(x.shape)))
        return x[0]

    spot = torch.rand(4, 6, dtype=torch.float64)
    factors = torch.rand(4, 2, 6, dtype=torch.float64)
    entries = tbasis.coerce_basis_functions([tbasis.X0, tbasis.generic(first_factor, 1)])
    cols = tbasis.design_columns(entries, spot, factors)
    assert torch.equal(cols[0], cols[1]) and cols[1].shape == (4, 6)
    assert seen == [((6,), (2, 6))] * 4


# ---------------------------------------------------------------- valuations


def _storage(pkg):
    return pkg.CmdtyStorage(
        "D", "2019-12-01", "2020-01-10", 1.23, 0.98,
        min_inventory=0.0, max_inventory=10_000.0,
        max_injection_rate=700.0, max_withdrawal_rate=700.0,
    )


def _market():
    """The 2F facility's market of tests/test_params_and_basis.py."""
    val_date = "2019-11-20"
    idx = pd.period_range(val_date, "2020-01-10", freq="D")
    fwd = pd.Series(index=idx, data=np.linspace(23.0, 28.0, len(idx)))
    rates = pd.Series(index=pd.period_range(val_date, "2020-03-01", freq="D"), data=0.03)

    def settle(period):
        return (period.asfreq("M").asfreq("D", "end") + 20).start_time.date()

    vol_idx = pd.period_range(val_date, "2020-03-01", freq="D")
    factors = [(0.0, pd.Series(index=vol_idx, data=0.14)),
               (16.2, pd.Series(index=vol_idx.copy(), data=1.15))]
    return val_date, fwd, rates, settle, factors


def _value_2f(pkg, basis, **kwargs):
    val_date, fwd, rates, settle, factors = _market()
    dtype = jnp.float64 if pkg is jpkg else torch.float64
    device = {} if pkg is jpkg else {"device": "cpu"}
    return pkg.multi_factor_value(
        _storage(pkg), val_date, 0.0, fwd, rates, settle, factors, 0.64, 512, basis, False,
        seed=11, fwd_sim_seed=11, dtype=dtype, **device, **kwargs)


def _exp_indicator(b, xp):
    """The exp/indicator basis of tests/test_params_and_basis.py."""
    return [
        b.generic(lambda s, x: xp.ones_like(s), label="1"),
        b.generic(lambda s, x: x[0], num_factors=1, label="x0"),
        b.generic(lambda s, x: xp.exp(x[0]), num_factors=1, label="exp(x0)"),
        b.generic(lambda s, x: xp.exp(-x[0]), num_factors=1, label="exp(-x0)"),
        b.generic(lambda s, x: (x[1] > 0) * xp.ones_like(s), num_factors=2, label="1{x1>0}"),
        b.generic(lambda s, x: x[1], num_factors=2, label="x1"),
    ]


def _assert_valuations_close(got, want):
    assert got.npv == pytest.approx(want.npv, rel=RTOL)
    assert got.val_sim_standard_error == pytest.approx(want.val_sim_standard_error, rel=RTOL)
    pd.testing.assert_index_equal(got.deltas.index, want.deltas.index)
    np.testing.assert_allclose(got.deltas, want.deltas, rtol=RTOL, atol=1e-7)
    pd.testing.assert_frame_equal(got.expected_profile, want.expected_profile, rtol=RTOL,
                                  atol=1e-7)
    pd.testing.assert_frame_equal(got.trigger_prices, want.trigger_prices, rtol=1e-7, atol=1e-7)


def test_exp_indicator_basis_matches_jax_f64():
    want = _value_2f(jpkg, _exp_indicator(jbasis, jnp))
    got = _value_2f(tpkg, _exp_indicator(tbasis, torch))
    _assert_valuations_close(got, want)


def test_generic_replicating_monomials_matches_monomial_valuation():
    """A generic basis computing 1 + x0 + x0**2 + x1 + x1*x1 values as the
    monomial basis does, through the design-in-memory path (kernel D, C's
    design mode), per-sim panels included."""
    flags = tpkg.SimulationDataReturned.ALL
    mono = _value_2f(tpkg, MONO_2F, sim_data_returned=flags)
    replica = [tpkg.ONE, lambda s, x: x[0], lambda s, x: x[0] * x[0],
               tpkg.generic(lambda s, x: x[1], num_factors=2), lambda s, x: x[1] * x[1]]
    gen = _value_2f(tpkg, replica, sim_data_returned=flags)
    _assert_valuations_close(gen, mono)
    for name in ("sim_pv", "sim_inventory", "sim_inject_withdraw", "sim_cmdty_consumed"):
        np.testing.assert_allclose(getattr(gen, name), getattr(mono, name), rtol=RTOL, atol=1e-6)


def test_combinator_basis_matches_string():
    string = _value_2f(tpkg, MONO_2F)
    comb = _value_2f(tpkg, tpkg.ONE + tpkg.X0 + tpkg.X0 ** 2 + tpkg.X1 + tpkg.X1 * tpkg.X1)
    assert comb.npv == string.npv
    pd.testing.assert_series_equal(comb.deltas, string.deltas)


def test_spot_only_generic_value_from_sims_matches_jax_f64():
    val_date, fwd, rates, settle, _ = _market()
    rng = np.random.default_rng(5)
    periods = pd.period_range(val_date, "2020-01-10", freq="D")
    steps = 0.02 * rng.standard_normal((2, len(periods), 512))
    steps[:, 0] = 0.0
    paths = fwd.to_numpy()[None, :, None] * np.exp(np.cumsum(steps, axis=1))
    reg, val = (pd.DataFrame(p, index=periods) for p in paths)

    def value(pkg, b, xp, **kwargs):
        basis = [b.ONE, b.S, b.generic(lambda s, x: xp.log(s), label="log s"),
                 b.generic(lambda s, x: xp.sqrt(s), label="sqrt s")]
        return pkg.value_from_sims(_storage(pkg), val_date, 0.0, fwd, rates, settle, reg, val,
                                   basis, True, extra_decisions=1, **kwargs)

    want = value(jpkg, jbasis, jnp, dtype=jnp.float64)
    got = value(tpkg, tbasis, torch, dtype=torch.float64, device="cpu")
    _assert_valuations_close(got, want)


def test_generic_basis_refuses_fullstep():
    entries = tuple(tbasis.coerce_basis_functions([tbasis.ONE, lambda s, x: x[0]]))
    with pytest.raises(ValueError, match="fullstep needs factor panels and a monomial basis"):
        torch_lsmc.lsmc_backward(
            {"grids": torch.zeros((3, 4), dtype=torch.float64)}, torch.ones((3, 8)),
            torch.ones((3, 1, 8)), entries, 0, None, False, fullstep=True)


def test_generic_basis_factor_count_checked():
    too_many = [tbasis.generic(lambda s, x: x[2], num_factors=3, label="x2")]
    with pytest.raises(ValueError, match="factor x2"):
        _value_2f(tpkg, too_many)


# ------------------------------------------------ kernel C's design mode


def _panels(n, s, dtype=torch.float64):
    return [torch.empty((n, s), dtype=dtype) for _ in range(4)]


def test_design_mode_plain_equals_monomial_sweep():
    c = sweep_case()
    n, s = c["spot"].shape
    tables = (c["params"], c["mean"], c["std"], c["ratchet_inv"], c["ratchet_min"],
              c["ratchet_max"])
    want_panels, got_panels = _panels(n, s), _panels(n, s)
    want = forward_kernel.forward_sweep(*tables, c["spot"], c["factors"], c["inventory"], None,
                                        c["coeffs"], c["entries"], 1, False, panels=want_panels)
    got = forward_kernel.forward_sweep_design(*tables, c["spot"], c["design"], c["inventory"],
                                              None, c["coeffs"], 1, False, panels=got_panels)
    for x, y in zip((*got, *got_panels), (*want, *want_panels)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("chunk", [1, 4, 9, None])
def test_forward_sweep_generic_chunks_carry_the_paths(chunk, monkeypatch):
    """Chunked design-mode sweeps carry inventory and PV from chunk to chunk:
    the same bits as one sweep over all steps, with generic entries too.  At
    ``DESIGN_CHUNK`` itself (``None``) over 40 steps, two chunk boundaries;
    at smaller chunk lengths (patched) over 9 steps, up to eight."""
    if chunk is None:
        c = sweep_case(n=40)
    else:
        monkeypatch.setattr(forward_kernel, "DESIGN_CHUNK", chunk)
        c = sweep_case()
    n, s = c["spot"].shape
    entries = (*c["entries"][:-1], tbasis.generic(lambda sp, x: sp * sp, label="s*s"))
    tables = (c["params"], c["mean"], c["std"], c["ratchet_inv"], c["ratchet_min"],
              c["ratchet_max"])
    want_panels, got_panels = _panels(n, s), _panels(n, s)
    want = forward_kernel.forward_sweep(*tables, c["spot"], c["factors"], c["inventory"], None,
                                        c["coeffs"], c["entries"], 0, True, panels=want_panels)
    got = forward_kernel.forward_sweep_generic(*tables, c["spot"], c["factors"], c["inventory"],
                                               c["coeffs"], entries, 0, True, panels=got_panels)
    for x, y in zip((*got, *got_panels), (*want, *want_panels)):
        assert torch.equal(x, y)
