"""The intrinsic engine of storage_tpu_torch against the JAX package.

* The engine (``intrinsic_core``, its plain version on CPU tensors) against
  ``storage_tpu.engines.intrinsic._intrinsic_core`` on the same tables, f64:
  linspace, fixed-spacing and custom grids (callable and array), cubic
  interpolation, 0-2 extra decisions, linear and step ratchets, a terminal
  value and a facility that must end empty, one step.  NPV within 1e-10
  relative, every profile column within 1e-6 absolute: the tolerances of the
  JAX package's own golden test (tests/test_reference_goldens.py:373-381).
  Both run the same arithmetic in the same order; only the sums differ.
  Facilities that must end empty run with no extra decision: withdrawn to
  zero, the forward's inventory is a residual of ~1e-32 whose sign decides
  whether holding is feasible, and XLA's fused arithmetic and the port's
  one-rounding-per-operation arithmetic give it different signs.  At E = 0
  both decision sets are then {0, 0, max injection}; at E >= 1 they differ
  (the hold's neighbours against a spread from the withdrawal endpoint),
  and the two paths part.  The LSMC's intrinsic value runs at E = 0.  The
  exact answer there is a DP in f64 built from the JAX package's own
  pieces, each operation rounded on its own, with the walk's residual
  snapped to the band (``_jax_snapped_dp``): at an inventory of exactly 0
  the decision set is the spread.  The port's
  walk snaps each step's inventory to the band bound it lands on
  (``engines.intrinsic.snap_to_band``) and gives it; the JAX package parts
  from it (a fault of the reference, which stays as it is).
* ``intrinsic_value`` frames against ``storage_tpu.intrinsic_value``, its
  degenerate cases and errors, the pins of ``BASELINE.md`` (1,705,564.28 on
  linspace, the reference's 1,703,773.0757192627 on fixed spacing, the C#
  example's 10,827.21), f32 against f32.
* The grid and interpolation functions the engine adds against their JAX
  originals.
"""
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import storage_tpu as jpkg
import storage_tpu_torch as tpkg
from storage_tpu import grid as jax_grid
from storage_tpu.engines import intrinsic as jax_intrinsic
from storage_tpu.ops import interp as jax_interp
from storage_tpu.valuation_inputs import prepare_valuation as jax_prepare
from storage_tpu_torch import grid as torch_grid
from storage_tpu_torch.engines import intrinsic as torch_intrinsic
from storage_tpu_torch.engines import lsmc as torch_lsmc
from storage_tpu_torch.ops import interp as torch_interp
from storage_tpu_torch.valuation_inputs import prepare_valuation as torch_prepare

from _torch_intrinsic_case import NUM_DAYS, START, snapped_steps
from _torch_intrinsic_case import curve as _curve
from _torch_intrinsic_case import facility as _facility

torch.set_num_threads(1)

NPV_RTOL = 1e-10
PROFILE_ATOL = 1e-6


def _inputs(pkg, prepare, ratchets="linear", terminal=True, val_offset=0, inventory=800.0):
    storage = _facility(pkg, ratchets, terminal)
    return prepare(storage, START + val_offset, inventory, _curve(), 0.03, None)


def _custom_calc(lower, upper):
    """A non-uniform grid whose length varies with the band: padding
    (repeated last points) on narrower rows."""
    if upper <= lower:
        return np.array([lower])
    k = 5 + int((upper - lower) // 400.0)
    return lower + (upper - lower) * np.linspace(0.0, 1.0, k) ** 1.5


def _grids(inputs, scheme, num_grid):
    lo, hi = inputs.inventory_lower, inputs.inventory_upper
    if scheme == "linspace":
        return torch_grid.inventory_grids(lo, hi, num_grid)
    if scheme == "fixed_spacing":
        return torch_grid.inventory_grids_fixed_spacing(
            lo, hi, float(np.min(inputs.compiled.min_inv)), float(np.max(inputs.compiled.max_inv)),
            num_grid)
    if scheme == "custom-callable":
        return torch_grid.inventory_grids_custom(lo, hi, _custom_calc)
    return torch_grid.inventory_grids_custom(lo, hi, [_custom_calc(a, b) for a, b in zip(lo, hi)])


def _engine_pair(scheme, interpolation, extra, ratchets, terminal, val_offset=0, num_grid=15,
                 dtype=torch.float64, inventory=800.0):
    """The port's and the JAX package's engine results on the same tables."""
    t_in = _inputs(tpkg, torch_prepare, ratchets, terminal, val_offset, inventory)
    j_in = _inputs(jpkg, jax_prepare, ratchets, terminal, val_offset, inventory)
    grids = _grids(t_in, scheme, num_grid)
    arrays = torch_lsmc.build_engine_arrays(
        t_in.compiled, t_in.fwd, t_in.df_settle, t_in.df_flow, t_in.inventory_lower,
        t_in.inventory_upper, num_grid, dtype, "cpu", grids)
    uniform = scheme == "linspace"
    t_fn = None if t_in.compiled.must_be_empty_at_end else t_in.compiled.terminal_value
    j_fn = None if j_in.compiled.must_be_empty_at_end else j_in.compiled.terminal_value
    got = torch_intrinsic.intrinsic_core(arrays, t_in.starting_inventory, extra, t_fn,
                                         t_in.compiled.ratchet_is_step, interpolation, uniform)
    j_dtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    j_arrays = {k: jnp.asarray(v.numpy(), j_dtype) for k, v in arrays.items()}
    want = jax_intrinsic._intrinsic_core(
        j_arrays, jnp.asarray(j_in.starting_inventory, j_dtype), extra, j_fn,
        j_in.compiled.ratchet_is_step, interpolation, uniform_grids=uniform)
    return got, want


def _assert_engine_close(got, want, npv_rtol=NPV_RTOL, atol=PROFILE_ATOL):
    assert float(got.npv) == pytest.approx(float(want.npv), rel=npv_rtol)
    for name in jax_intrinsic.IntrinsicEngineResult._fields[1:]:
        g = getattr(got, name).numpy()
        w = np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("scheme,interpolation,extra,ratchets,terminal", [
    ("linspace", "linear", 0, "linear", True),
    ("linspace", "linear", 1, "step", True),
    ("linspace", "linear", 2, "linear", True),
    ("linspace", "linear", 0, "linear", False),
    ("fixed_spacing", "linear", 0, "step", True),
    ("fixed_spacing", "linear", 1, "linear", True),
    ("fixed_spacing", "linear", 0, "linear", False),
    ("custom-callable", "linear", 0, "linear", True),
    ("custom-array", "linear", 2, "step", True),
    ("linspace", "cubic", 0, "linear", True),
    ("linspace", "cubic", 1, "step", True),
    ("linspace", "cubic", 0, "linear", False),
    ("linspace", "cubic", 2, "linear", True),
], ids=lambda v: str(v))
def test_engine_matches_jax(scheme, interpolation, extra, ratchets, terminal):
    """Facilities that must end empty run at E = 0: see the module notes."""
    got, want = _engine_pair(scheme, interpolation, extra, ratchets, terminal)
    assert got.inventory.shape == (NUM_DAYS + 1,)
    _assert_engine_close(got, want)


def _jax_snapped_dp(j_arrays, starting_inventory, extra, uniform):
    """The exact answer of a facility that must end empty, built from the
    JAX package's own pieces (``grid.ratchet_rates``/``bang_bang_decisions``,
    ``engines.intrinsic.immediate_pv``, ``ops.interp``), each operation
    rounded on its own: the backward value tables vs [N+1, G], and the NPV
    of the forward walk with each step's inventory set to a bound of the
    next band where it lies within 1e-9 of it (in exact arithmetic a fill or
    a withdrawal to a bound lands on it)."""
    grids, n = j_arrays["grids"], j_arrays["grids"].shape[0] - 1
    lerp = jax_interp.interp_vector if uniform else jax_interp.interp_vector_general

    def decide(t, inventory, v_next):
        x = {k: j_arrays[k][t] for k in ("fwd", "df_settle", "df_flow", "inj_cost", "wdr_cost",
                                          "inj_pcnt", "wdr_pcnt", "inv_cost_rate", "loss_pcnt",
                                          "ratchet_inv", "ratchet_min", "ratchet_max")}
        lo, hi = j_arrays["lower"][t + 1], j_arrays["upper"][t + 1]
        rates = jax_grid.ratchet_rates(x["ratchet_inv"], x["ratchet_min"], x["ratchet_max"],
                                       False, inventory)
        decisions = jax_grid.bang_bang_decisions(*rates, inventory, x["loss_pcnt"], lo, hi, extra)
        pv, _ = jax_intrinsic.immediate_pv(
            decisions, inventory[..., None], x["fwd"], x["df_settle"], x["df_flow"],
            x["inj_cost"], x["wdr_cost"], x["inj_pcnt"], x["wdr_pcnt"], x["inv_cost_rate"])
        loss = x["loss_pcnt"] * inventory
        total = pv + lerp(grids[t + 1], v_next, inventory[..., None] + decisions - loss[..., None])
        best = jnp.argmax(total, axis=-1)[..., None]
        take = lambda a: jnp.take_along_axis(a, best, axis=-1)[..., 0]  # noqa: E731
        return jnp.max(total, axis=-1), take(decisions), take(pv), loss, (lo, hi)

    vs = [jnp.zeros_like(grids[n])] * (n + 1)  # must end empty: no terminal value
    for t in range(n - 1, 0, -1):
        vs[t] = decide(t, grids[t], vs[t + 1])[0]
    inventory, npv = jnp.asarray([starting_inventory], grids.dtype), 0.0
    for t in range(n):
        _, decision, pv, loss, bounds = decide(t, inventory, vs[t + 1])
        inventory = inventory + decision - loss
        for bound in bounds:
            inventory = jnp.where(jnp.abs(inventory - bound) <= 1e-9 * max(1.0, abs(float(bound))),
                                  bound, inventory)
        npv += float(pv[0])
    return np.stack([np.asarray(v) for v in vs]), npv


@pytest.mark.parametrize("scheme,extra", [("linspace", 1), ("fixed_spacing", 1),
                                          ("linspace", 2), ("fixed_spacing", 2)])
def test_must_end_empty_with_extra_decisions_is_exact(scheme, extra):
    """A facility that must end empty, at E >= 1: the port's DP snaps its
    walk to the band and gives the exact answer, built from the JAX
    package's own pieces (``_jax_snapped_dp``; the port's backward value
    tables equal its tables first), and its walk snapped at least once; the
    JAX package parts from it in every case (at E = 1 its residual takes the
    other sign from the port's plain arithmetic: 32,996.16 against
    32,999.65; at E = 2 on fixed spacing both packages' residual is +3e-16,
    which the port once kept too)."""
    t_in = _inputs(tpkg, torch_prepare, "linear", False)
    grids = _grids(t_in, scheme, 15)
    arrays = torch_lsmc.build_engine_arrays(
        t_in.compiled, t_in.fwd, t_in.df_settle, t_in.df_flow, t_in.inventory_lower,
        t_in.inventory_upper, 15, torch.float64, "cpu", grids)
    uniform = scheme == "linspace"
    vs_jax, exact = _jax_snapped_dp({k: jnp.asarray(v.numpy()) for k, v in arrays.items()},
                                    t_in.starting_inventory, extra, uniform)
    vs_port, _ = torch_intrinsic.backward_values(arrays, extra, None, False, "linear", uniform)
    for t in range(1, len(vs_port)):
        np.testing.assert_allclose(vs_port[t].numpy(), vs_jax[t], rtol=NPV_RTOL, atol=PROFILE_ATOL)
    got, want = _engine_pair(scheme, "linear", extra, "linear", False)
    assert float(got.npv) == pytest.approx(exact, rel=NPV_RTOL)
    assert snapped_steps(got, t_in.starting_inventory) >= 1
    assert abs(float(want.npv) - exact) > 1e-6 * exact


@pytest.mark.parametrize("interpolation", ["linear", "cubic"])
@pytest.mark.parametrize("terminal", [True, False], ids=["terminal", "empty-at-end"])
def test_engine_one_step_matches_jax(interpolation, terminal):
    """N = 1: no backward step, the forward alone on the terminal values."""
    got, want = _engine_pair("linspace", interpolation, 1, "linear", terminal,
                             val_offset=NUM_DAYS - 1, inventory=100.0)
    assert got.inventory.shape == (2,)
    _assert_engine_close(got, want)


def test_engine_f32_matches_jax_f32():
    got, want = _engine_pair("linspace", "linear", 0, "linear", True, dtype=torch.float32)
    assert got.npv.dtype == torch.float32
    assert float(got.npv) == pytest.approx(float(want.npv), rel=1e-5)


def test_engine_refuses_bad_interpolation():
    t_in = _inputs(tpkg, torch_prepare)
    arrays = torch_lsmc.build_engine_arrays(
        t_in.compiled, t_in.fwd, t_in.df_settle, t_in.df_flow, t_in.inventory_lower,
        t_in.inventory_upper, 8, torch.float64, "cpu")
    with pytest.raises(ValueError, match="'linear' or 'cubic'"):
        torch_intrinsic.intrinsic_core(arrays, 800.0, 0, None, False, "quadratic")
    with pytest.raises(ValueError, match="linspace"):
        torch_intrinsic.intrinsic_core(arrays, 800.0, 0, None, False, "cubic", uniform_grids=False)


# ---------------------------------------------------------------- public API


def _value_pair(**kwargs):
    t_storage = _facility(tpkg, "linear", True)
    j_storage = _facility(jpkg, "linear", True)
    args = (START, 800.0, _curve(), 0.03, None)
    got = tpkg.intrinsic_value(t_storage, *args, dtype=torch.float64, device="cpu", **kwargs)
    want = jpkg.intrinsic_value(j_storage, *args, dtype=jnp.float64, **kwargs)
    return got, want


@pytest.mark.parametrize("kwargs", [
    dict(num_inventory_grid_points=12),
    dict(num_inventory_grid_points=12, grid_scheme="fixed_spacing"),
    dict(num_inventory_grid_points=12, interpolation="cubic"),
    dict(grid_calc=_custom_calc),
], ids=["linspace", "fixed_spacing", "cubic", "custom"])
def test_intrinsic_value_matches_jax(kwargs):
    got, want = _value_pair(**kwargs)
    assert isinstance(got, tpkg.IntrinsicValuationResults)
    assert got.npv == pytest.approx(want.npv, rel=NPV_RTOL)
    pd.testing.assert_frame_equal(got.profile, want.profile, rtol=0, atol=PROFILE_ATOL)


def test_intrinsic_value_f32_matches_jax_f32():
    t_storage, j_storage = _facility(tpkg, "step", True), _facility(jpkg, "step", True)
    args = (START, 800.0, _curve(), 0.03, None)
    got = tpkg.intrinsic_value(t_storage, *args, num_inventory_grid_points=12, device="cpu")
    want = jpkg.intrinsic_value(j_storage, *args, num_inventory_grid_points=12)
    assert got.npv == pytest.approx(want.npv, rel=1e-5)


def test_degenerate_cases_match_jax():
    fwd = _curve()
    for terminal in (True, False):
        t_storage, j_storage = _facility(tpkg, "linear", terminal), _facility(jpkg, "linear", terminal)
        for val_date, inventory in ((t_storage.end + 1, 500.0), (t_storage.end, 0.0)):
            got = tpkg.intrinsic_value(t_storage, val_date, inventory, fwd, 0.03, None,
                                       device="cpu")
            want = jpkg.intrinsic_value(j_storage, val_date, inventory, fwd, 0.03, None)
            assert got.npv == want.npv
            pd.testing.assert_frame_equal(got.profile, want.profile)
    storage = _facility(tpkg, "linear", True)
    at_end = tpkg.intrinsic_value(storage, storage.end, 500.0, fwd, 0.03, None, device="cpu")
    assert at_end.npv == pytest.approx(0.9 * fwd[storage.end] * 500.0)
    with pytest.raises(ValueError, match="empty at end"):
        tpkg.intrinsic_value(_facility(tpkg, "linear", False), storage.end, 500.0, fwd, 0.03,
                             None, device="cpu")


@pytest.mark.parametrize("kwargs,match", [
    (dict(grid_scheme="fixed_spacing", interpolation="cubic"), "linspace"),
    (dict(grid_calc=_custom_calc, interpolation="cubic"), "linspace"),
    (dict(grid_scheme="log"), "grid_scheme"),
    (dict(interpolation="quadratic"), "'linear' or 'cubic'"),
])
def test_intrinsic_value_errors(kwargs, match):
    storage = _facility(tpkg, "linear", True)
    with pytest.raises(ValueError, match=match):
        tpkg.intrinsic_value(storage, START, 800.0, _curve(), 0.03, None, device="cpu", **kwargs)


def test_intrinsic_value_needs_a_card_unless_told():
    import inspect

    assert inspect.signature(tpkg.intrinsic_value).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpkg.intrinsic_value(_facility(tpkg, "linear", True), START, 800.0, _curve(), 0.03, None)


# ---------------------------------------------------------------- pins


def _reg_market():
    """The 2F regression facility and market of tests/test_lsmc.py."""
    storage = tpkg.CmdtyStorage(
        "D", "2019-12-01", "2020-04-01", 1.23, 0.98,
        min_inventory=0.0, max_inventory=100_000.0,
        max_injection_rate=700.0, max_withdrawal_rate=700.0,
    )
    val_date = "2019-08-29"
    idx = pd.period_range(val_date, "2020-04-01", freq="D")
    fwd = pd.Series(index=idx, data=[23.87 if p < pd.Period("2020-03-12", freq="D") else 150.32
                                     for p in idx])
    rates = pd.Series(index=pd.period_range(val_date, "2020-06-01", freq="D"), data=0.03)

    def settle(period):
        return (period.asfreq("M").asfreq("D", "end") + 20).start_time.date()

    return storage, val_date, fwd, rates, settle


@pytest.mark.parametrize("grid_scheme,pin,rel", [
    ("linspace", 1_705_564.2806059965, 1e-9),  # tests/test_goldens.py:81
    ("fixed_spacing", 1_703_773.0757192627, 1e-12),  # the reference's intrinsic, exactly
])
def test_pins(grid_scheme, pin, rel):
    storage, val_date, fwd, rates, settle = _reg_market()
    res = tpkg.intrinsic_value(storage, val_date, 0.0, fwd, rates, settle, dtype=torch.float64,
                               grid_scheme=grid_scheme, device="cpu")
    assert res.npv == pytest.approx(pin, rel=rel)


def test_csharp_example_pin():
    """The reference's C# intrinsic sample (README.md:404-440): 10,827.21."""
    storage = tpkg.CmdtyStorage(
        "D", "2019-09-01", "2019-10-01", 0.48, 0.74,
        min_inventory=0.0, max_inventory=1100.74,
        max_injection_rate=5.26, max_withdrawal_rate=14.74,
    )
    idx = pd.period_range("2019-09-15", "2019-10-01", freq="D")
    fwd = pd.Series(index=idx, data=[56.6 if p < pd.Period("2019-09-23", freq="D") else 144.41
                                     for p in idx])
    res = tpkg.intrinsic_value(storage, "2019-09-15", 50.0, fwd, 0.0, None,
                               num_inventory_grid_points=101, dtype=torch.float64, device="cpu")
    assert res.npv == pytest.approx(10_827.21, rel=1e-3)


# ---------------------------------------------------------------- grids and interpolation


def _bands():
    lower = np.array([100.0, 0.0, 50.0, 300.0, 300.0])
    upper = np.array([100.0, 1000.0, 725.0, 2000.0, 300.0])
    return lower, upper


def test_fixed_spacing_grids_match_jax():
    lower, upper = _bands()
    for g in (2, 7, 31):
        got = torch_grid.inventory_grids_fixed_spacing(lower, upper, 0.0, 2000.0, g)
        want = jax_grid.inventory_grids_fixed_spacing(lower, upper, 0.0, 2000.0, g)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        torch_grid.inventory_grids_fixed_spacing(lower, upper, 5.0, 5.0, 10),
        jax_grid.inventory_grids_fixed_spacing(lower, upper, 5.0, 5.0, 10))


def test_custom_grids_match_jax():
    lower, upper = _bands()
    got = torch_grid.inventory_grids_custom(lower, upper, _custom_calc)
    want = jax_grid.inventory_grids_custom(lower, upper, _custom_calc)
    np.testing.assert_array_equal(got, want)
    assert (got[0] == 100.0).all()  # a one-point row padded to the width
    rows = [_custom_calc(a, b) for a, b in zip(lower, upper)]
    np.testing.assert_array_equal(torch_grid.inventory_grids_custom(lower, upper, rows), want)
    np.testing.assert_array_equal(torch_grid.inventory_grids_custom(lower, upper, want), want)
    assert torch_grid.rows_uniform(torch_grid.inventory_grids(lower, upper, 9))
    assert not torch_grid.rows_uniform(got)
    assert torch_grid.rows_uniform(got) == jax_grid.rows_uniform(want)


@pytest.mark.parametrize("grid_calc,match", [
    (lambda lo, hi: np.array([hi, lo]), "sorted"),
    (lambda lo, hi: np.array([lo - 1.0, hi]), "feasible band"),
    (lambda lo, hi: np.zeros((2, 2)), "1-D"),
    ([[0.0, 1.0]], "one row per period"),
])
def test_custom_grid_errors_match_jax(grid_calc, match):
    lower, upper = _bands()
    for module in (torch_grid, jax_grid):
        with pytest.raises(ValueError, match=match):
            module.inventory_grids_custom(lower[1:3], upper[1:3], grid_calc)


def test_general_interpolation_matches_jax():
    rng = np.random.default_rng(3)
    grid = np.array([0.0, 1.0, 2.5, 2.5, 4.0, 7.0, 7.0, 7.0])  # a zero-span segment, padding
    values = rng.normal(size=grid.size)
    x = np.concatenate([rng.uniform(-1.0, 8.0, 50), grid])
    got = torch_interp.interp_vector_general(torch.tensor(grid), torch.tensor(values), torch.tensor(x))
    want = jax_interp.interp_vector_general(jnp.asarray(grid), jnp.asarray(values), jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-15, atol=1e-15)
    idx, w = torch_interp.interp_weights_general(torch.tensor(grid), torch.tensor(x))
    j_idx, j_w = jax_interp.interp_weights_general(jnp.asarray(grid), jnp.asarray(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(w.numpy(), np.asarray(j_w), rtol=1e-15, atol=1e-15)


@pytest.mark.parametrize("degenerate", [False, True], ids=["band", "degenerate-band"])
def test_cubic_matches_jax(degenerate):
    rng = np.random.default_rng(5)
    g = 9
    grid = np.full(g, 40.0) if degenerate else np.linspace(10.0, 90.0, g)
    values = rng.normal(size=g) * 100.0
    x = rng.uniform(0.0, 100.0, 40)
    solver = torch_interp.natural_cubic_solver(g)
    np.testing.assert_allclose(solver.numpy(), np.asarray(jax_interp.natural_cubic_solver(g)),
                               rtol=1e-14, atol=1e-15)
    moments = torch_interp.cubic_moments(torch.tensor(grid), torch.tensor(values), solver)
    j_moments = jax_interp.cubic_moments(jnp.asarray(grid), jnp.asarray(values),
                                         jax_interp.natural_cubic_solver(g))
    np.testing.assert_allclose(moments.numpy(), np.asarray(j_moments), rtol=1e-12, atol=1e-12)
    if degenerate:
        assert (moments == 0).all()
    got = torch_interp.interp_vector_cubic(torch.tensor(grid), torch.tensor(values), moments,
                                           torch.tensor(x))
    want = jax_interp.interp_vector_cubic(jnp.asarray(grid), jnp.asarray(values), j_moments,
                                          jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-10)
    assert torch_interp.natural_cubic_solver(2).shape == (0, 0)
