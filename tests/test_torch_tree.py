"""The trinomial-tree engine of storage_tpu_torch against the JAX package.

* The lattice (``build_tree``, ``build_intrinsic_tree``): the same arrays to
  the bit, and the same ``ValueError`` where a branch probability is
  negative (weak mean reversion, a = 0 included).
* The band: the dense transition rebuilt from band + first column equals
  the lattice's, exactly.
* The engine (``tree_core``, its plain version on CPU tensors) against
  ``storage_tpu.engines.tree.tree_valuation`` on the same lattice, f64:
  linear, custom (``grid_calc``) and cubic rows, step and linear ratchets, a
  terminal value and a facility that must end empty, one step.  NPV within
  1e-10 relative, values within 1e-9 of their scale: both run the same
  arithmetic in the same order; only the sums differ.  Facilities that must
  end empty run with no extra decision (see tests/test_torch_intrinsic.py).
* ``simulate_tree_decisions`` on the centre, up and down branch paths.
* The DP kernel's route by slab (``ops.tree_kernel.choose_route``): the
  cluster route while its CTAs hold the node rows, the large-slab route
  beyond while a block holds a row, the large route beyond both, and a
  ``ValueError`` where the route asked for cannot hold it.
* ``trinomial_value`` and ``trinomial_deltas`` against the JAX API, their
  early returns and errors, the C# example's 24,799.09, and the intrinsic
  tree against ``intrinsic_value``.
"""
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import storage_tpu as jpkg
import storage_tpu_torch as tpkg
from storage_tpu.engines import tree as jax_tree
from storage_tpu.models import trinomial_tree as jax_tt
from storage_tpu.utils import periods as jax_periods
from storage_tpu.valuation_inputs import prepare_valuation as jax_prepare
from storage_tpu_torch import convert
from storage_tpu_torch.engines import tree as torch_tree
from storage_tpu_torch.models import trinomial_tree as torch_tt
from storage_tpu_torch.ops import tree_kernel
from storage_tpu_torch.valuation_inputs import prepare_valuation as torch_prepare

torch.set_num_threads(1)

NPV_RTOL = 1e-10
VALUES_RTOL = 1e-9
NUM_DAYS = 25
START = pd.Period("2021-03-01", freq="D")
VAL_OFFSET = 2  # the valuation date, days before the facility's start
MEAN_REVERSION = 8.0


def _facility(pkg, ratchets: str = "linear", terminal: bool = True):
    """A 25-day facility with ratchets (3 linear nodes, or 4 step nodes whose
    top two agree), costs, fuel, loss and inventory cost; either a terminal
    value or empty at the end."""
    if ratchets == "linear":
        nodes = [(0.0, -150.0, 250.0), (1500.0, -220.0, 180.0), (3000.0, -300.0, 120.0)]
    else:
        nodes = [(0.0, -150.0, 250.0), (1200.0, -220.0, 180.0), (2400.0, -300.0, 120.0),
                 (3000.0, -300.0, 120.0)]
    return pkg.CmdtyStorage(
        "D", START, START + NUM_DAYS, 0.05, 0.03,
        ratchets=[(START, nodes)],
        ratchet_interp=pkg.RatchetInterp.LINEAR if ratchets == "linear" else pkg.RatchetInterp.STEP,
        cmdty_consumed_inject=0.01, cmdty_consumed_withdraw=0.005,
        inventory_loss=0.0005, inventory_cost=0.002,
        terminal_storage_npv=(lambda price, inv: 0.9 * price * inv) if terminal else None,
    )


def _market():
    """Forward curve and spot vols from the valuation date to the end."""
    idx = pd.period_range(START - VAL_OFFSET, START + NUM_DAYS, freq="D")
    i = np.arange(len(idx))
    fwd = pd.Series(20.0 + 4.0 * np.sin(2 * np.pi * i / 17.0) + 0.3 * np.cos(i), index=idx)
    vols = pd.Series(0.8 + 0.1 * np.cos(i / 5.0), index=idx)
    return fwd, vols


def _custom_calc(lower, upper):
    """A non-uniform grid whose length varies with the band."""
    if upper <= lower:
        return np.array([lower])
    return lower + (upper - lower) * np.linspace(0.0, 1.0, 6 + int((upper - lower) // 400.0)) ** 1.5


# ---------------------------------------------------------------- lattice


@pytest.mark.parametrize("a,vols", [(5.5, "flat"), (14.5, "seasonal"), (2.0, "flat")])
@pytest.mark.parametrize("num_substeps", [1, 4])
def test_build_tree_matches_jax(a, vols, num_substeps):
    fwd = 30.0 + 5.0 * np.sin(np.arange(20) / 3.0)
    sigma = np.full(20, 0.9) if vols == "flat" else 0.7 + 0.2 * np.cos(np.arange(20) / 4.0)
    got = torch_tt.build_tree(fwd, sigma, a, 1 / 365.0, num_substeps=num_substeps)
    want = jax_tt.build_tree(fwd, sigma, a, 1 / 365.0, num_substeps=num_substeps)
    for name in jax_tt.TrinomialTree._fields:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert not got.transition.flags.writeable  # the one period matrix, broadcast
    got, want = torch_tt.build_intrinsic_tree(fwd), jax_tt.build_intrinsic_tree(fwd)
    for name in jax_tt.TrinomialTree._fields:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


@pytest.mark.parametrize("a", [0.0, 1.0])
def test_weak_mean_reversion_raises_as_jax_does(a):
    for module in (torch_tt, jax_tt):
        with pytest.raises(ValueError, match="Negative branch probability"):
            module.build_tree(np.full(30, 20.0), np.full(30, 0.9), a, 1 / 365.0)


@pytest.mark.parametrize("source", ["port", "jax-copy", "intrinsic"])
def test_band_rebuilds_the_transition(source):
    fwd, vols = np.full(12, 20.0), np.full(12, 0.9)
    if source == "port":
        transition = torch_tt.build_tree(fwd, vols, 3.0, 1 / 365.0).transition
    elif source == "jax-copy":
        transition = jax_tt.build_tree(fwd, vols, 3.0, 1 / 365.0).transition
    else:
        transition = torch_tt.build_intrinsic_tree(fwd).transition
    values, start = tree_kernel.band(transition)
    assert values.shape[-1] <= 9 and start.dtype == np.int64
    assert (start >= 0).all() and (start + values.shape[-1] <= transition.shape[-1]).all()
    rebuilt = tree_kernel.dense(torch.tensor(values), torch.tensor(start)).numpy()
    np.testing.assert_array_equal(rebuilt, transition)
    if source == "port":  # banded once through the view, as through the copy
        full = tree_kernel.band(np.array(transition))
        np.testing.assert_array_equal(values, full[0])
        np.testing.assert_array_equal(start, full[1])


# ---------------------------------------------------------------- engine


def _engine_pair(interpolation="linear", extra=0, ratchets="linear", terminal=True, grid_calc=None,
                 val_offset=-VAL_OFFSET, num_grid=12, lattice="tree"):
    """The port's and the JAX package's tree_valuation on one lattice (built
    by the JAX package and carried over with ``convert.tree_from_numpy``)."""
    fwd, vols = _market()
    val_date = START + val_offset
    j_in = jax_prepare(_facility(jpkg, ratchets, terminal), val_date, 800.0, fwd, 0.03, None)
    t_in = torch_prepare(_facility(tpkg, ratchets, terminal), val_date, 800.0, fwd, 0.03, None)
    horizon = fwd[val_date:]
    if lattice == "tree":
        tree = jax_tt.build_tree(horizon.to_numpy(), vols[val_date:].to_numpy(), MEAN_REVERSION,
                                 1 / 365.0)
    else:
        tree = jax_tt.build_intrinsic_tree(horizon.to_numpy())
    offset = jax_periods.period_offset(j_in.periods[0], val_date)
    kwargs = dict(num_grid_points=num_grid, num_extra_decisions=extra, interpolation=interpolation,
                  grid_calc=grid_calc)
    want = jax_tree.tree_valuation(
        j_in.compiled, tree, offset, j_in.starting_inventory, j_in.fwd, j_in.df_settle,
        j_in.df_flow, j_in.inventory_lower, j_in.inventory_upper, dtype=jnp.float64, **kwargs)
    got = torch_tree.tree_valuation(
        t_in.compiled, convert.tree_from_numpy(tree), offset, t_in.starting_inventory, t_in.fwd,
        t_in.df_settle, t_in.df_flow, t_in.inventory_lower, t_in.inventory_upper,
        dtype=torch.float64, device="cpu", **kwargs)
    return got, want, t_in


def _assert_engine_close(got, want):
    assert float(got.npv) == pytest.approx(float(want.npv), rel=NPV_RTOL)
    g, w = got.values.numpy(), np.asarray(want.values)
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=0, atol=VALUES_RTOL * np.abs(w).max())


@pytest.mark.parametrize("interpolation,extra,ratchets,terminal,grid_calc", [
    ("linear", 0, "linear", True, None),
    ("linear", 1, "linear", True, None),
    ("linear", 2, "step", True, None),
    ("linear", 0, "linear", False, None),
    ("cubic", 2, "linear", True, None),
    ("cubic", 0, "linear", True, None),
    ("cubic", 1, "step", True, None),
    ("cubic", 0, "linear", False, None),
    ("linear", 0, "linear", True, _custom_calc),
    ("linear", 1, "step", True, _custom_calc),
    ("linear", 0, "linear", False, _custom_calc),
], ids=lambda v: getattr(v, "__name__", str(v)))
def test_engine_matches_jax(interpolation, extra, ratchets, terminal, grid_calc):
    got, want, t_in = _engine_pair(interpolation, extra, ratchets, terminal, grid_calc)
    n = t_in.num_steps
    assert got[0].values.shape[0] == n + 1
    _assert_engine_close(got[0], want[0])


@pytest.mark.parametrize("interpolation", ["linear", "cubic"])
def test_engine_one_step_matches_jax(interpolation):
    """N = 1: one backward step on the terminal values."""
    got, want, t_in = _engine_pair(interpolation, 1, val_offset=NUM_DAYS - 1)
    assert t_in.num_steps == 1
    _assert_engine_close(got[0], want[0])


def test_intrinsic_lattice_matches_jax():
    got, want, _ = _engine_pair(lattice="intrinsic")
    assert got[0].values.shape[1] == 1
    _assert_engine_close(got[0], want[0])


def test_engine_refuses_bad_interpolation():
    fwd, vols = _market()
    t_in = torch_prepare(_facility(tpkg), START, 800.0, fwd, 0.03, None)
    tree = torch_tt.build_tree(fwd.to_numpy(), vols.to_numpy(), MEAN_REVERSION, 1 / 365.0)
    args = (t_in.compiled, tree, VAL_OFFSET, 800.0, t_in.fwd, t_in.df_settle, t_in.df_flow,
            t_in.inventory_lower, t_in.inventory_upper)
    with pytest.raises(ValueError, match="'linear' or 'cubic'"):
        torch_tree.tree_valuation(*args, interpolation="quadratic", device="cpu")
    with pytest.raises(ValueError, match="linspace"):
        torch_tree.tree_valuation(*args, interpolation="cubic", grid_calc=_custom_calc,
                                  device="cpu")


def test_tree_dp_takes_cuda_tensors_only():
    got, _, _ = _engine_pair()
    (_, arrays, lattice) = got
    v_end = torch.zeros(lattice["spot"].shape[1], arrays["grids"].shape[1], dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        tree_kernel.tree_dp(arrays, lattice, v_end, 0, False, "linear")
    with pytest.raises(TypeError, match="float32 or float64"):
        tree_kernel.tree_dp({**arrays, "grids": arrays["grids"].half()}, lattice, v_end, 0, False,
                            "linear")


# A launch report as tree_kernel.kernel_info gives it for some [M, G] slab:
# the cluster route holds up to 2,976 node rows there, a step block up to
# 58,112 grid points.
_INFO = {"max_rows": 2_976, "max_grid": 58_112}


@pytest.mark.parametrize("m,g,route,want", [
    (99, 100, None, "cluster"),              # T3
    (2_976, 100, None, "cluster"),           # the cluster's capacity
    (2_977, 100, None, "steps"),             # one row beyond it
    (2_977, 58_112, None, "steps"),          # the step block's capacity
    (99, 100, "steps", "steps"),             # forced, within both
    (2_976, 100, "cluster", "cluster"),
    (2_977, 58_113, None, "large"),          # beyond both shared-memory routes
], ids=["T3", "cluster-full", "just-over", "step-block-full", "forced-steps", "forced-cluster",
        "beyond-both"])
def test_tree_route_chosen_by_slab(m, g, route, want):
    """The cluster route where its CTAs hold the M node rows, else the
    large-slab route where a block holds a row's G points, else the large
    route, whose rows stay in device memory."""
    assert tree_kernel.choose_route(m, g, _INFO, route) == want


@pytest.mark.parametrize("m,g,route,match", [
    (2_977, 100, "cluster", "at most M=2976"),    # the cluster route forced beyond it
    (99, 58_113, "steps", "at most G=58112"),
    (99, 100, "one_block", "route must be one of"),
], ids=["forced-cluster-over", "forced-steps-over", "unknown-route"])
def test_tree_route_refuses_what_no_route_holds(m, g, route, match):
    """Nothing falls back quietly: a slab beyond the route asked for raises
    before any launch."""
    with pytest.raises(ValueError, match=match):
        tree_kernel.choose_route(m, g, _INFO, route)


@pytest.mark.parametrize("interpolation,grid_calc", [
    ("linear", None), ("cubic", None), ("linear", _custom_calc)], ids=["linear", "cubic", "custom"])
def test_simulated_decisions_match_jax(interpolation, grid_calc):
    """Centre, up and down branch paths through the values, as
    tests/test_misc_features.py:80-115 walks them."""
    (got, arrays, lattice), (want, j_arrays, j_lattice), t_in = _engine_pair(
        interpolation, 1, grid_calc=grid_calc)
    n = t_in.num_steps
    uniform = grid_calc is None
    tfn = t_in.compiled.terminal_value
    for branch in (1, 2, 0):
        path = np.full(n, branch, dtype=np.int32)
        sim = torch_tree.simulate_tree_decisions(arrays, lattice, got.values, path, 800.0, 1, tfn,
                                                 False, interpolation, uniform)
        ref = jax_tree.simulate_tree_decisions(
            j_arrays, j_lattice, want.values, jnp.asarray(path), 800.0, 1, tfn, False,
            interpolation=interpolation, uniform_grids=uniform)
        np.testing.assert_array_equal(sim.node_path.numpy(), np.asarray(ref.node_path))
        for name in ("decisions", "cmdty_consumed", "inventory"):
            np.testing.assert_allclose(getattr(sim, name).numpy(), np.asarray(getattr(ref, name)),
                                       rtol=0, atol=1e-9, err_msg=name)
        assert float(sim.npv) == pytest.approx(float(ref.npv), rel=1e-10)
        assert sim.decisions.shape == (n,) and sim.node_path.shape == (n + 1,)


# ---------------------------------------------------------------- public API


def _api_args(pkg, **facility):
    fwd, vols = _market()
    return (_facility(pkg, **facility), START - VAL_OFFSET, 800.0, fwd, vols, MEAN_REVERSION,
            1 / 365.0, 0.03, None)


@pytest.mark.parametrize("kwargs", [
    dict(num_inventory_grid_points=12),
    dict(num_inventory_grid_points=12, interpolation="cubic"),
    dict(grid_calc=_custom_calc),
], ids=["linear", "cubic", "custom"])
def test_trinomial_value_matches_jax(kwargs):
    got = tpkg.trinomial_value(*_api_args(tpkg), dtype=torch.float64, device="cpu", **kwargs)
    want = jpkg.trinomial_value(*_api_args(jpkg), dtype=jnp.float64, **kwargs)
    assert isinstance(got, float)
    assert got == pytest.approx(want, rel=NPV_RTOL)


def test_trinomial_value_f32_matches_jax_f32():
    got = tpkg.trinomial_value(*_api_args(tpkg), num_inventory_grid_points=12, device="cpu")
    want = jpkg.trinomial_value(*_api_args(jpkg), num_inventory_grid_points=12)
    assert got == pytest.approx(want, rel=1e-5)


def test_trinomial_deltas_match_jax():
    contracts = [START + 3, (START + 10, START + 16)]
    got = tpkg.trinomial_deltas(*_api_args(tpkg), contracts, num_inventory_grid_points=12,
                                dtype=torch.float64, device="cpu")
    want = jpkg.trinomial_deltas(*_api_args(jpkg), contracts, num_inventory_grid_points=12,
                                 dtype=jnp.float64)
    assert len(got) == 2
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # f32 takes the 1e-2 shift, as the JAX package does: at 1e-5 the f32 NPVs
    # would cancel.  Its deltas carry the NPVs' f32 rounding over 2e-2.
    got32 = tpkg.trinomial_deltas(*_api_args(tpkg), contracts[:1], num_inventory_grid_points=12,
                                  device="cpu")
    want32 = jpkg.trinomial_deltas(*_api_args(jpkg), contracts[:1], num_inventory_grid_points=12)
    np.testing.assert_allclose(got32, want32, rtol=1e-2)
    np.testing.assert_allclose(got32, got[:1], rtol=1e-2)


def test_early_returns_match_jax():
    fwd, vols = _market()
    for terminal in (True, False):
        t_storage = _facility(tpkg, terminal=terminal)
        j_storage = _facility(jpkg, terminal=terminal)
        for val_date, inventory in ((t_storage.end + 1, 500.0), (t_storage.end, 0.0)):
            args = (val_date, inventory, fwd, vols, MEAN_REVERSION, 1 / 365.0, 0.03, None)
            assert (tpkg.trinomial_value(t_storage, *args, device="cpu")
                    == jpkg.trinomial_value(j_storage, *args))
    storage = _facility(tpkg)
    at_end = tpkg.trinomial_value(storage, storage.end, 500.0, fwd, vols, MEAN_REVERSION,
                                  1 / 365.0, 0.03, None, device="cpu")
    assert at_end == pytest.approx(0.9 * fwd[storage.end] * 500.0)
    with pytest.raises(ValueError, match="empty at end"):
        tpkg.trinomial_value(_facility(tpkg, terminal=False), storage.end, 500.0, fwd, vols,
                             MEAN_REVERSION, 1 / 365.0, 0.03, None, device="cpu")


def _errors():
    fwd, vols = _market()
    monthly = pd.Series(0.8, index=pd.period_range("2021-01", "2021-06", freq="M"))
    return [
        (dict(spot_volatility=monthly), "different frequencies"),
        (dict(forward_curve=fwd[2:]), "starts too late"),
        (dict(spot_volatility=vols[:-3]), "does not cover"),
        (dict(mean_reversion=0.0), "Negative branch probability"),
        (dict(interpolation="cubic", grid_calc=_custom_calc), "linspace"),
        (dict(interpolation="quadratic"), "'linear' or 'cubic'"),
    ]


@pytest.mark.parametrize("case", range(6), ids=["freq", "fwd-late", "vols-short", "a=0",
                                                "cubic-custom", "interpolation"])
def test_trinomial_value_errors_match_jax(case):
    kwargs, match = _errors()[case]
    names = ("cmdty_storage", "val_date", "inventory", "forward_curve", "spot_volatility",
             "mean_reversion", "time_step", "interest_rates", "settlement_rule")
    for pkg, extra in ((tpkg, dict(device="cpu")), (jpkg, {})):
        args = dict(zip(names, _api_args(pkg)))
        args.update(kwargs)
        with pytest.raises(ValueError, match=match):
            pkg.trinomial_value(**args, **extra)


def test_trinomial_needs_a_card_unless_told():
    import inspect

    for fn in (tpkg.trinomial_value, tpkg.trinomial_deltas):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpkg.trinomial_value(*_api_args(tpkg))
    with pytest.raises(RuntimeError, match="CUDA"):
        tpkg.trinomial_deltas(*_api_args(tpkg), [START])


# ---------------------------------------------------------------- pins and oracles


def _csharp_case():
    """The reference's C# trinomial sample (README.md:552-622 of the
    reference; tests/test_reference_goldens.py:329-352)."""
    ratchets = [
        ("2019-09-01", [(0.0, -44.85, 56.8), (100.0, -45.01, 54.5), (300.0, -45.78, 52.01),
                        (600.0, -46.17, 51.9), (800.0, -46.99, 50.8), (1000.0, -47.12, 50.01)]),
        ("2019-09-20", [(0.0, -31.41, 48.33), (100.0, -31.85, 43.05), (300.0, -31.68, 41.22),
                        (600.0, -32.78, 40.08), (800.0, -33.05, 39.74), (1000.0, -34.80, 38.51)]),
    ]
    storage = tpkg.CmdtyStorage("D", "2019-09-01", "2019-10-01", 0.48, 0.74, ratchets=ratchets,
                                ratchet_interp=tpkg.RatchetInterp.LINEAR)
    idx = pd.period_range("2019-09-15", "2019-10-01", freq="D")
    fwd = pd.Series([56.6 if p <= pd.Period("2019-09-22", freq="D") else 56.6 + 87.81 for p in idx],
                    index=idx)
    vols = pd.Series([0.975, 0.97, 0.96, 0.91, 0.89, 0.895, 0.891, 0.89, 0.875, 0.872, 0.871,
                      0.870, 0.869, 0.868, 0.867, 0.866, 0.8655], index=idx)
    return storage, fwd, vols


def test_csharp_trinomial_pin():
    storage, fwd, vols = _csharp_case()
    npv = tpkg.trinomial_value(storage, "2019-09-15", 50.0, fwd, vols, 5.5, 1.0 / 365.0, 0.025,
                               lambda period: pd.Timestamp("2019-10-20").date(),
                               num_inventory_grid_points=101, dtype=torch.float64, device="cpu")
    assert npv == pytest.approx(24_799.09, rel=5e-4)


def test_intrinsic_tree_equals_intrinsic_value():
    """The single-node tree through the tree engine against the intrinsic
    engine (tests/test_tree_oracles.py:148-176): the ratcheted oracle
    facility at G=100; they differ by backward-value against forward-sum
    interpolation only."""
    ratchets = [
        ("2019-08-03", [(0.0, -702.7, 650.0), (15_000.0, -785.0, 552.5), (30_000.0, -790.6, 512.8),
                        (40_000.0, -825.6, 498.6), (52_500.0, -850.4, 480.0)]),
        ("2020-02-01", [(0.0, -645.35, 650.0), (13_000.0, -656.0, 552.5),
                        (28_000.0, -689.6, 512.8), (42_000.0, -701.06, 498.6),
                        (52_500.0, -718.04, 480.0)]),
    ]
    storage = tpkg.CmdtyStorage("D", "2019-08-03", "2020-04-01", 1.25, 0.93, ratchets=ratchets,
                                ratchet_interp=tpkg.RatchetInterp.LINEAR)
    idx = pd.period_range("2019-08-29", "2020-04-01", freq="D")
    fwd = pd.Series(53.5 + np.sin(2 * np.pi / 365.0 * np.arange(len(idx))) * 24.6, index=idx)

    def settle(period):
        return (period.asfreq("M").asfreq("D", "end") + 20).start_time.date()

    inputs = torch_prepare(storage, "2019-08-29", 5_685.0, fwd, 0.055, settle)
    tree = torch_tt.build_intrinsic_tree(fwd.to_numpy())
    offset = jax_periods.period_offset(inputs.periods[0], pd.Period("2019-08-29", freq="D"))
    result, _, _ = torch_tree.tree_valuation(
        inputs.compiled, tree, offset, inputs.starting_inventory, inputs.fwd, inputs.df_settle,
        inputs.df_flow, inputs.inventory_lower, inputs.inventory_upper, num_grid_points=100,
        dtype=torch.float64, device="cpu")
    intrinsic = tpkg.intrinsic_value(storage, "2019-08-29", 5_685.0, fwd, 0.055, settle,
                                     dtype=torch.float64, device="cpu")
    assert float(result.npv) == pytest.approx(intrinsic.npv, rel=1e-3)
