"""Inventory grids past the shared-memory routes of the two DP kernels.

* The route functions against the limits of an H100 (232,448 bytes of shared
  memory a block; R = 3 ratchet nodes, E = 0): the intrinsic DP's shared
  route (``intrinsic_kernel.intrinsic_route``) up to 29,034 grid points in
  f32 and 14,506 in f64 on linear rows, 14,517 / 7,253 on general rows and
  11,613 / 5,802 cubic, and not where its decision tables' scratch would
  pass ``TABLE_SCRATCH_CAP`` (an hourly year at 29,034 points); the tree's
  large-slab route (``tree_kernel.steps_max_grid``) up to 58,112 / 29,056
  (linear and general) and 19,371 / 9,686 (cubic), the large route beyond.
  Forced routes and unknown names.
* ``intrinsic_value(device="cpu")`` against the JAX package in f64 on the
  40-day facility, at 16,384 linspace points and on 10,001 custom rows of a
  fixed 0.3-unit step; ``trinomial_value(device="cpu")`` at 32,768 points on
  an 8-step lattice.  On the CPU the engines run their plain versions, which
  the large routes follow operation by operation on the card
  (tests/test_torch_cuda_kernels.py, ``chip_smoke.py``).  Tolerances: those
  of tests/test_torch_intrinsic.py and tests/test_torch_tree.py.
* With CUDA stood in (no card here), each entry point that runs a DP
  chooses the large route past those limits from shapes, before anything
  is built on the card, and raises no ``ValueError``; the headline's grid
  keeps the shared route and a T3-sized tree the cluster route.
"""
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import storage_tpu as jpkg
import storage_tpu_torch as tpkg
from storage_tpu_torch.engines import lsmc as torch_lsmc
from storage_tpu_torch.ops import _build, intrinsic_kernel, tree_kernel

from _torch_intrinsic_case import NUM_DAYS, START, curve, facility

torch.set_num_threads(1)

NPV_RTOL = 1e-10  # tests/test_torch_intrinsic.py, tests/test_torch_tree.py
PROFILE_ATOL = 1e-6
H100_SMEM = 232_448
MODES = ("linear", "general", "cubic")
# The shared routes' largest G on an H100 (R = 3, E = 0): {mode: (f32, f64)}.
INTRINSIC_LIMITS = {"linear": (29_034, 14_506), "general": (14_517, 7_253),
                    "cubic": (11_613, 5_802)}
STEPS_LIMITS = {"linear": (58_112, 29_056), "general": (58_112, 29_056),
                "cubic": (19_371, 9_686)}
HEADLINE_STEPS = 365
HOURLY_STEPS = 8_760


def step_rows(step):
    """A ``grid_calc`` of a fixed volume step from each band's lower bound,
    capped at its upper (``IDoubleStateSpaceGridCalc``'s fixed spacing)."""
    def calc(lower, upper):
        if upper <= lower:
            return np.array([lower])
        k = int(np.ceil((upper - lower) / step - 1e-9))
        return np.minimum(lower + step * np.arange(k + 1), upper)
    return calc


# ---- the routes, from shapes alone.

@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
@pytest.mark.parametrize("mode", MODES)
def test_intrinsic_route_switches_at_the_h100_limit(mode, itemsize):
    limit = INTRINSIC_LIMITS[mode][itemsize // 8]
    assert intrinsic_kernel.max_grid(3, 0, mode, itemsize, H100_SMEM) == limit
    route = lambda g: intrinsic_kernel.intrinsic_route(  # noqa: E731
        g, 3, 0, mode, itemsize, H100_SMEM, HEADLINE_STEPS)
    assert (route(100), route(limit), route(limit + 1)) == ("shared", "shared", "large")


def test_intrinsic_route_caps_the_table_scratch():
    """An hourly year at the f32 limit would fill 16.3 GB of decision tables:
    the large route, which needs none; the headline's year keeps the shared
    one."""
    g = INTRINSIC_LIMITS["linear"][0]
    scratch = HOURLY_STEPS * intrinsic_kernel.table_len(g, 0) * 4
    assert scratch > intrinsic_kernel.TABLE_SCRATCH_CAP
    route = lambda n: intrinsic_kernel.intrinsic_route(g, 3, 0, "linear", 4, H100_SMEM, n)  # noqa: E731
    assert (route(HEADLINE_STEPS), route(HOURLY_STEPS)) == ("shared", "large")


def test_intrinsic_forced_routes():
    route = intrinsic_kernel.intrinsic_route
    assert route(100, 3, 0, "cubic", 8, H100_SMEM, 10, route="large") == "large"
    assert route(100, 3, 0, "cubic", 8, H100_SMEM, 10, route="shared") == "shared"
    with pytest.raises(ValueError, match="at most G=14506"):
        route(14_507, 3, 0, "linear", 8, H100_SMEM, 10, route="shared")
    with pytest.raises(ValueError, match="route must be one of"):
        route(100, 3, 0, "linear", 8, H100_SMEM, 10, route="tiled")
    with pytest.raises(ValueError, match="mode must be one of"):
        route(100, 3, 0, "spline", 8, H100_SMEM, 10)


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
@pytest.mark.parametrize("mode", MODES)
def test_tree_route_switches_at_the_h100_limit(mode, itemsize):
    """Beyond the cluster (no node row fits it at these G), the large-slab
    route up to its block's limit, the large route one point past it."""
    limit = STEPS_LIMITS[mode][itemsize // 8]
    assert tree_kernel.steps_max_grid(itemsize, mode, H100_SMEM) == limit
    info = {"max_rows": 0, "max_grid": limit}
    assert tree_kernel.choose_route(99, limit, info) == "steps"
    assert tree_kernel.choose_route(99, limit + 1, info) == "large"
    assert tree_kernel.choose_route(99, 100, {"max_rows": 2_256, "max_grid": limit},
                                    route="large") == "large"
    with pytest.raises(ValueError, match=f"at most G={limit}"):
        tree_kernel.choose_route(99, limit + 1, info, route="steps")


# ---- the large grids against the JAX package (the plain versions on the CPU).

def _intrinsic_pair(**kwargs):
    args = (START, 800.0, curve(), 0.03, None)
    got = tpkg.intrinsic_value(facility(tpkg, "linear", True), *args, dtype=torch.float64,
                               device="cpu", **kwargs)
    want = jpkg.intrinsic_value(facility(jpkg, "linear", True), *args, dtype=jnp.float64,
                                **kwargs)
    return got, want


@pytest.mark.parametrize("kwargs", [
    dict(num_inventory_grid_points=16_384),
    dict(grid_calc=step_rows(0.3)),
], ids=["linspace-16384", "step-rows-10001"])
def test_intrinsic_value_at_large_grids_matches_jax(kwargs):
    got, want = _intrinsic_pair(**kwargs)
    if "grid_calc" in kwargs:  # the 3,000-unit band on a 0.3-unit step
        assert len(step_rows(0.3)(0.0, 3_000.0)) == 10_001
    assert got.npv == pytest.approx(want.npv, rel=NPV_RTOL)
    pd.testing.assert_frame_equal(got.profile, want.profile, rtol=0, atol=PROFILE_ATOL)


def _tree_args(pkg, horizon=8):
    """The 40-day facility valued over its last ``horizon`` days on a tree of
    flat spot vol 0.9, mean reversion 8."""
    fwd = curve()
    val_date = START + NUM_DAYS - horizon
    vols = pd.Series(0.9, index=fwd.index)
    return (facility(pkg, "linear", True), val_date, 800.0, fwd, vols, 8.0, 1 / 365.0, 0.03, None)


def test_trinomial_value_at_a_large_grid_matches_jax():
    got = tpkg.trinomial_value(*_tree_args(tpkg), num_inventory_grid_points=32_768,
                               dtype=torch.float64, device="cpu")
    want = jpkg.trinomial_value(*_tree_args(jpkg), num_inventory_grid_points=32_768,
                                dtype=jnp.float64)
    assert got == pytest.approx(want, rel=NPV_RTOL)


# ---- the routes chosen through the API, with CUDA stood in.

class _Routed(Exception):
    """Raised where a route has been chosen, to stop the valuation there."""


def _dp_launches():
    return (intrinsic_kernel.intrinsic_dp.launches, tree_kernel.tree_dp.launches,
            tree_kernel.tree_dp.step_launches, tree_kernel.tree_dp.large_launches)


def _stand_in_cuda(monkeypatch):
    """CUDA stood in with an H100's shared memory a block, and the tree's
    launch report as the card gives it: its cluster holds 2,256 node rows at
    G = 100 in f32 and 1,152 in f64 (PERF.md §6), and no row at the grids
    past the step block."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "smem_limit", lambda device: H100_SMEM)

    def tree_info(is_double, m, g, w, e, mode, device_index):
        itemsize = 8 if is_double else 4
        name = {v: k for k, v in intrinsic_kernel.MODES.items()}[mode]
        return {"max_rows": (1_152 if is_double else 2_256) if g <= 100 else 0,
                "max_grid": tree_kernel.steps_max_grid(itemsize, name, H100_SMEM)}

    monkeypatch.setattr(tree_kernel, "_info", tree_info)


def _route_of(monkeypatch, module, name, call) -> str:
    """Calls ``call()`` with CUDA stood in until ``module.name`` (a route
    function) has chosen: the route it returned, chosen before anything was
    built on the card (there is no card to build on) and with nothing
    launched."""
    _stand_in_cuda(monkeypatch)
    real, chosen = getattr(module, name), []

    def spy(*args, **kwargs):
        chosen.append(real(*args, **kwargs))
        raise _Routed

    monkeypatch.setattr(module, name, spy)
    before = _dp_launches()
    with pytest.raises(_Routed):
        call()
    assert _dp_launches() == before
    return chosen[0]


@pytest.mark.parametrize("kwargs,want", [
    (dict(num_inventory_grid_points=32_768), "large"),
    (dict(num_inventory_grid_points=32_768, interpolation="cubic"), "large"),
    (dict(grid_calc=step_rows(0.3), dtype=torch.float64), "large"),
    (dict(grid_calc=step_rows(0.3)), "shared"),    # f32 general rows hold 14,517
    (dict(num_inventory_grid_points=100), "shared"),
], ids=["f32-32768", "cubic-32768", "f64-step-rows", "f32-step-rows", "G=100"])
def test_intrinsic_value_routes_by_shape(monkeypatch, kwargs, want):
    route = _route_of(monkeypatch, intrinsic_kernel, "intrinsic_route", lambda: tpkg.intrinsic_value(
        facility(tpkg, "linear", True), START, 800.0, curve(), 0.03, None, device="cuda",
        **kwargs))
    assert route == want


@pytest.mark.parametrize("kwargs,want", [
    (dict(num_inventory_grid_points=65_536), "large"),
    (dict(num_inventory_grid_points=10_240, interpolation="cubic", dtype=torch.float64),
     "large"),
    (dict(num_inventory_grid_points=2_000), "steps"),
    (dict(num_inventory_grid_points=100), "cluster"),
], ids=["f32-65536", "f64-cubic-10240", "G=2000", "T3-sized"])
def test_trinomial_value_routes_by_shape(monkeypatch, kwargs, want):
    route = _route_of(monkeypatch, tree_kernel, "tree_route",
                      lambda: tpkg.trinomial_value(*_tree_args(tpkg), device="cuda", **kwargs))
    assert route == want


def test_trinomial_deltas_take_the_large_route(monkeypatch):
    """Each of the deltas' valuations has the valuation's shape: the first
    chooses the large route before anything is built on the card."""
    route = _route_of(monkeypatch, tree_kernel, "tree_route", lambda: tpkg.trinomial_deltas(
        *_tree_args(tpkg), [START + 35], num_inventory_grid_points=65_536, device="cuda"))
    assert route == "large"


def _lsmc_case(pkg):
    """The 40-day facility on the three-factor model's inputs."""
    return facility(pkg, "linear", True), START, curve()


@pytest.mark.parametrize("entry", ["three-factor", "value-from-sims"])
def test_lsmc_entry_points_log_the_intrinsic_route(monkeypatch, entry):
    """Every LSMC entry point runs the intrinsic DP in its dtype: at 32,768
    grid points in f32 its large route, chosen with B's and C's before
    anything is simulated."""
    import storage_tpu_torch.api_lsmc as api_lsmc

    storage, start, fwd = _lsmc_case(tpkg)
    if entry == "three-factor":
        call = lambda: tpkg.three_factor_seasonal_value(  # noqa: E731
            storage, start, 100.0, fwd, 0.02, None, 14.5, 1.1, 0.19, 0.23, 64,
            "1 + s + x_st + x_lt", False, num_inventory_grid_points=32_768, device="cuda")
    else:
        idx = pd.period_range(start, storage.end, freq="D")
        frame = pd.DataFrame(np.full((len(idx), 8), 20.0), index=idx)
        call = lambda: tpkg.value_from_sims(  # noqa: E731
            storage, start, 100.0, fwd, 0.02, None, frame, frame, "1 + s + s**2", False,
            num_inventory_grid_points=32_768, device="cuda")

    def no_sims(*args, **kwargs):
        raise AssertionError("simulated before the routes were chosen")

    monkeypatch.setattr(api_lsmc.spot_sim, "simulate_ou_paths", no_sims)
    monkeypatch.setattr(api_lsmc, "_frames_to_sims", no_sims)
    routes = _route_of(monkeypatch, torch_lsmc, "grid_routes", call)
    assert routes["intrinsic"] == ("intrinsic_dp", "large")
    assert routes["backward"][1] == "large" and routes["forward"][1] == "large"
