"""Inventory grids past the shared-memory routes of the LSMC kernels.

* The engine (``lsmc_core``) at G = 4,096 grid points on panels the JAX
  package simulated, against the JAX engine's XLA path in f64: the monomial
  basis, a generic basis and custom rows, to the tolerance of
  tests/test_torch_lsmc.py.  On the CPU the wrappers take their plain
  versions, which the kernels' large routes follow operation by operation
  on the card (tests/test_torch_cuda_kernels.py, ``chip_smoke.py``).
* Kernel E's route (``fullstep``) at G = 4,096 against the port's moments
  route, to the tolerance of tests/test_torch_fullstep.py.
* ``three_factor_seasonal_value(num_inventory_grid_points=4096)`` against
  the JAX API.
* The route functions against the limits of an H100 (232,448 bytes of
  shared memory a block): kernel B's shared route up to 1,553 grid points at
  D = 3, B = 9 (its records of 36 words a grid point); D's up to 2,905 at
  B = 4; C's up to 3,090 (monomial),
  2,528 (general rows) and 2,392 (design mode on general rows) at B = 9,
  R = 3, F = 3.
* With CUDA stood in (no card here), each entry point at G = 4,096 chooses
  the large routes (kernel C's shared one on spot-only panels, which stage
  no factor) from shapes before any simulation or launch, and raises no
  ``ValueError``.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import storage_tpu as jpkg
import storage_tpu_torch as tpkg
from storage_tpu.engines import lsmc as jax_lsmc
from storage_tpu.models.spot_sim import simulate_ou_paths as jax_simulate
from storage_tpu_torch import convert
from storage_tpu_torch import grid as gridmod
from storage_tpu_torch.basis import coerce_basis_functions, parse_basis_functions
from storage_tpu_torch.engines import lsmc as torch_lsmc
from storage_tpu_torch.ops import _build, decision_kernel, forward_kernel, rng_kernel

torch.set_num_threads(1)

BASIS = "1 + x_st + x_lt + x_sw + x_st**2 + x_lt**2 + x_sw**2 + s + s**2"
RTOL = 1e-9  # f64: the same arithmetic up to summation order
F64 = torch.float64
H100_SMEM = 232_448
GRID = 4_096
STEPS = 12
SIMS = 256


def _assert_results_close(got, want):
    for key in want:
        w = np.asarray(want[key], dtype=np.float64)
        g = np.asarray(got[key], dtype=np.float64)
        assert g.shape == w.shape, key
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=key)
        mask = ~np.isnan(w)
        scale = max(1.0, float(np.abs(w[mask]).max())) if mask.any() else 1.0
        np.testing.assert_allclose(g[mask], w[mask], rtol=RTOL, atol=RTOL * scale, err_msg=key)


@pytest.fixture(scope="module")
def jax_panels():
    """The bench facility cut to 12 days on 4,096 evenly spaced rows, and on
    custom rows bunched towards the floor (the last three repeated), with
    256 JAX-simulated paths a set."""
    from __graft_entry__ import _build_case

    inputs, arrays, sim_inputs, _ = _build_case(STEPS, GRID, SIMS, jnp.float64)
    g = np.asarray(arrays["grids"])
    rows = g[:, :1] + (g[:, -1:] - g[:, :1]) * np.linspace(0.0, 1.0, GRID) ** 1.5
    rows[:, -3:] = rows[:, -3:-2]
    assert not gridmod.rows_uniform(rows)
    sim = [sim_inputs[k] for k in ("decay", "chol", "vols", "half_var", "fwd")]
    reg = jax_simulate(jax.random.key(11), jnp.arange(SIMS), *sim)
    val = jax_simulate(jax.random.key(13), jnp.arange(SIMS), *sim)
    t_arrays = {
        kind: convert.engine_arrays_from_numpy(
            {k: np.asarray(v) for k, v in {**arrays, **extra}.items()}, F64, "cpu")
        for kind, extra in (("uniform", {}), ("custom", {"grids": rows}))}
    panels = (convert.panels_from_numpy(reg.spot, reg.factors, F64, "cpu"),
              convert.panels_from_numpy(val.spot, val.factors, F64, "cpu"))
    return dict(inputs=inputs, arrays=arrays, rows=rows, reg=reg, val=val, t_arrays=t_arrays,
                panels=panels)


def _bases(kind):
    if kind == "monomial":
        return tuple(jpkg.parse_basis_functions(BASIS)), tuple(parse_basis_functions(BASIS))
    from storage_tpu.basis import coerce_basis_functions as jax_coerce

    return (tuple(jax_coerce([jpkg.ONE, jpkg.S, jpkg.X0,
                              jpkg.generic(lambda s, x: jnp.exp(-x[1]), num_factors=2)])),
            tuple(coerce_basis_functions([tpkg.ONE, tpkg.S, tpkg.X0,
                                          tpkg.generic(lambda s, x: torch.exp(-x[1]),
                                                       num_factors=2)])))


@pytest.mark.parametrize("basis,rows", [("monomial", "uniform"), ("generic", "uniform"),
                                        ("monomial", "custom")])
def test_lsmc_core_matches_jax_at_4096_grid_points(jax_panels, basis, rows):
    c = jax_panels
    tfn = c["inputs"].compiled.terminal_value
    j_basis, t_basis = _bases(basis)
    arrays = c["arrays"] if rows == "uniform" else {**c["arrays"], "grids": jnp.asarray(c["rows"])}
    uniform = rows == "uniform"
    want = jax_lsmc.lsmc_core(
        arrays, c["reg"].spot, c["reg"].factors, c["val"].spot, c["val"].factors,
        jnp.asarray(100.0), j_basis, 1, True, tfn, False, use_pallas=False,
        uniform_grids=uniform)
    got = torch_lsmc.lsmc_core(c["t_arrays"][rows], *c["panels"][0], *c["panels"][1], 100.0,
                               t_basis, 1, True, tfn, False, uniform_grids=uniform)
    assert set(got) == set(want)
    _assert_results_close({k: v.numpy() for k, v in got.items()}, want)


def test_fullstep_at_4096_grid_points(jax_panels):
    """Kernel E's route against the moments route at G = 4,096: the same
    valuation to the rounding of its solve (tests/test_torch_fullstep.py's
    f64 route check)."""
    c = jax_panels
    args = (c["t_arrays"]["uniform"], *c["panels"][0], *c["panels"][1], 100.0,
            tuple(parse_basis_functions(BASIS)), 0, False, c["inputs"].compiled.terminal_value,
            False)
    want = torch_lsmc.lsmc_core(*args)
    got = torch_lsmc.lsmc_core(*args, fullstep=True)
    for key in ("npv", "standard_error", "deltas", "profile_inventory", "backward_npv"):
        scale = float(want[key].abs().max())
        torch.testing.assert_close(got[key], want[key], rtol=1e-10, atol=1e-10 * scale)


def _case(pkg, num_steps=STEPS):
    start = pd.Period("2021-01-01", freq="D")
    storage = pkg.CmdtyStorage(
        "D", start, start + num_steps, 0.9, 0.7,
        ratchets=[
            (start, [(0.0, -200.0, 300.0), (2500.0, -250.0, 250.0), (5000.0, -300.0, 200.0)]),
        ],
        ratchet_interp=pkg.RatchetInterp.LINEAR,
        terminal_storage_npv=lambda price, inv: price * inv,
    )
    idx = pd.period_range(start, storage.end, freq="D")
    i = np.arange(len(idx))
    fwd = pd.Series(index=idx, data=30.0 + 6 * np.sin(2 * np.pi * i / 365.0) + 0.4 * np.cos(i))
    return storage, start, fwd


_API_KWARGS = dict(
    inventory=100.0, interest_rates=0.02, settlement_rule=None, spot_mean_reversion=14.5,
    spot_vol=1.1, long_term_vol=0.19, seasonal_vol=0.23, num_sims=SIMS, basis_funcs=BASIS,
    discount_deltas=True, seed=11, fwd_sim_seed=13, num_inventory_grid_points=GRID,
)


def test_three_factor_seasonal_value_matches_jax_at_4096_grid_points():
    storage, start, fwd = _case(jpkg)
    want = jpkg.three_factor_seasonal_value(storage, start, fwd_curve=fwd, dtype=jnp.float64,
                                            **_API_KWARGS)
    storage, start, fwd = _case(tpkg)
    got = tpkg.three_factor_seasonal_value(storage, start, fwd_curve=fwd, dtype=torch.float64,
                                           device="cpu", **_API_KWARGS)
    assert got.npv == pytest.approx(want.npv, rel=RTOL)
    assert got.val_sim_standard_error == pytest.approx(want.val_sim_standard_error, rel=RTOL)
    np.testing.assert_allclose(got.deltas, want.deltas, rtol=RTOL, atol=1e-7)
    pd.testing.assert_frame_equal(got.expected_profile, want.expected_profile, rtol=RTOL,
                                  atol=1e-7)
    assert got.intrinsic_npv == pytest.approx(want.intrinsic_npv, rel=1e-10)


# ---- the routes, from shapes alone.

@pytest.mark.parametrize("name,max_grid,want", [
    ("B", lambda: decision_kernel.moments_max_grid(3, 9, H100_SMEM), 1_553),
    ("D", lambda: decision_kernel.update_max_grid(3, 4, H100_SMEM), 2_905),
    ("C-monomial", lambda: forward_kernel.sweep_max_grid(9, 3, 3, 0, H100_SMEM), 3_090),
    ("C-general", lambda: forward_kernel.sweep_max_grid(9, 3, 3, 0, H100_SMEM, general=True),
     2_528),
    ("C-design", lambda: forward_kernel.sweep_max_grid(9, 3, 9, 0, H100_SMEM, design=True,
                                                       general=True), 2_392)],
    ids=lambda x: x if isinstance(x, str) else None)
def test_shared_routes_hold_the_documented_limits(name, max_grid, want):
    assert max_grid() == want


def test_routes_switch_at_the_limits():
    """Kernels B, E and D take their shared route (the tile is the whole
    grid) while its blocks per SM are at least the large route's, and the
    large route one grid point past that; C's sweep while its shared route
    fits and leaves 4 blocks an SM (``SHARED_MIN_BLOCKS``) in every mode, the
    design mode's wide route while it fits.  A forced route still takes any
    shape it holds."""
    mk, up, sweep = (decision_kernel.moments_route, decision_kernel.update_route,
                     forward_kernel.sweep_route)
    assert mk(112, 3, 9, H100_SMEM) == ("shared", 112)
    assert mk(113, 3, 9, H100_SMEM) == ("large", decision_kernel.TILE_B)
    assert up(569, 3, 4, H100_SMEM) == ("shared", 569)
    assert up(570, 3, 4, H100_SMEM) == ("large", decision_kernel.TILE_D)
    for (b, v, design, general), last in {(9, 3, False, False): 658, (9, 3, False, True): 538,
                                          (9, 9, True, False): 492, (9, 9, True, True): 403,
                                          (4, 0, False, False): 1_691,
                                          (4, 0, False, True): 1_127}.items():
        assert sweep(last, b, 3, v, 0, H100_SMEM, design, general) == "shared"
        assert forward_kernel.sweep_blocks_per_sm(last, b, 3, v, 0, H100_SMEM, design,
                                                  general) == forward_kernel.SHARED_MIN_BLOCKS
        assert sweep(last + 1, b, 3, v, 0, H100_SMEM, design, general) == "large"
    assert sweep(1_169, 20, 3, 20, 0, H100_SMEM, design=True) == "shared"
    assert sweep(1_170, 20, 3, 20, 0, H100_SMEM, design=True) == "large"
    assert sweep(1_000_000, 9, 3, 9, 0, H100_SMEM, design=True, general=True) == "large"
    assert sweep(3_090, 9, 3, 3, 0, H100_SMEM, route="shared") == "shared"
    # Kernel E: shared where kernel B's rule is and its one-block solve fits.
    assert decision_kernel.fullstep_route(112, 3, 9, H100_SMEM).name == "shared"
    assert decision_kernel.fullstep_route(113, 3, 9, H100_SMEM).name == "large"
    assert decision_kernel.solve_max_grid(9, H100_SMEM) == 3_213
    # A forced route: the large one at any G, the shared one wherever it fits.
    assert mk(100, 3, 9, H100_SMEM, route="large") == ("large", decision_kernel.TILE_B)
    assert up(100, 3, 4, H100_SMEM, route="large") == ("large", 100)
    assert mk(1_553, 3, 9, H100_SMEM, route="shared") == ("shared", 1_553)
    assert up(2_905, 3, 4, H100_SMEM, route="shared") == ("shared", 2_905)
    assert decision_kernel.fullstep_route(1_553, 3, 9, H100_SMEM, route="shared").name == "shared"
    with pytest.raises(ValueError, match="at most G=1553"):
        mk(4_096, 3, 9, H100_SMEM, route="shared")
    with pytest.raises(ValueError, match="at most G=2905"):
        up(2_906, 3, 4, H100_SMEM, route="shared")
    with pytest.raises(ValueError, match="at most G=3090"):
        sweep(3_091, 9, 3, 3, 0, H100_SMEM, route="shared")
    with pytest.raises(ValueError, match="route must be one of"):
        sweep(100, 9, 3, 3, 0, H100_SMEM, route="tiled")
    with pytest.raises(ValueError, match="route must be one of"):
        decision_kernel.fullstep_route(100, 3, 9, H100_SMEM, route="tiled")


# An H100's SM (sm_90): 233,472 B of shared memory (a block's 232,448 and
# the 1 KB reserved for each block), allocated to a block in 128-byte
# units; 2,048 threads, 32 blocks.
H100_SM_SMEM = 232_448 + 1_024


# Kernel D's registers, capped by ``__launch_bounds__`` for these blocks per
# SM by padded basis size (36: the wide route).
D_REG_BLOCKS = {4: 5, 8: 4, 12: 4, 16: 4, 20: 3, 24: 3, 28: 3, 32: 2, 36: 4}


@pytest.mark.parametrize("b,want", [(1, 5), (4, 5), (5, 4), (9, 4), (16, 4), (17, 3), (28, 3),
                                    (29, 2), (32, 2), (33, 4), (100, 4)])
def test_update_register_blocks_follow_the_launch_bounds(b, want):
    assert decision_kernel.update_reg_blocks(b) == want


def _blocks_per_sm(smem: int, threads: int, reg_blocks: int) -> int:
    return min(H100_SM_SMEM // (128 * -(-smem // 128) + 1_024), 2_048 // threads, 32,
               reg_blocks)


@pytest.mark.parametrize("d", [3, 5])
@pytest.mark.parametrize("b", [4, 9, 16])
def test_routes_cross_where_the_blocks_per_sm_do(d, b):
    """The route rule from shapes alone: B, E and D leave their shared route
    at the first G whose blocks per SM fall below their large route's, as an
    H100 counts them from each launch's shared memory in 128-byte units (B:
    the static [8, 128] tile, the [B, 128] design tile and the records; D:
    the records), its threads a block (128, 256) and the blocks its
    registers allow (B's kMinBlocks = 9; D's ``__launch_bounds__`` minimum
    by padded basis size).  The headline (G = 100, D = 3, B = 9) keeps B's
    shared route, and G = 1,000 takes B's and E's large."""
    bp = 4 * -(-b // 4)
    record = 4 * (4 + (d - 1) * (4 + bp))

    def b_blocks(g):
        return _blocks_per_sm(4 * 8 * 128 + 4 * b * 128 + g * record, 128, 9)

    def d_blocks(g):
        return _blocks_per_sm(g * record, 256, D_REG_BLOCKS[bp])

    cross_b = max(g for g in range(1, 4_000) if b_blocks(g) >= b_blocks(min(g, 32)))
    cross_d = max(g for g in range(1, 4_000) if d_blocks(g) >= d_blocks(min(g, 256)))
    assert 32 <= cross_b < 1_000 and cross_d < 1_000
    for g, want in ((cross_b, "shared"), (cross_b + 1, "large"), (1_000, "large")):
        assert decision_kernel.moments_route(g, d, b, H100_SMEM).name == want
        assert decision_kernel.fullstep_route(g, d, b, H100_SMEM).name == want
    assert decision_kernel.update_route(cross_d, d, b, H100_SMEM).name == "shared"
    assert decision_kernel.update_route(cross_d + 1, d, b, H100_SMEM).name == "large"
    for g in (cross_b, 32, 100, 1_000):
        assert decision_kernel.moments_blocks_per_sm(g, d, b, H100_SMEM) == b_blocks(g)
    for g in (cross_d, 100, 256):
        assert decision_kernel.update_blocks_per_sm(g, d, b, H100_SMEM) == d_blocks(g)
    if (d, b) == (3, 9):
        assert decision_kernel.moments_route(100, d, b, H100_SMEM).name == "shared"
        assert cross_b == 112


def test_record_pack_follows_the_layout():
    """The large route's records (``pack_records``, its plain version on the
    CPU): per grid point {a, b, w_hi, idx_lo's bits} of decision 0, then for
    each later decision its entry and ci[d] − ci[0], zero-padded to whole
    float4s, as kernel D reads them."""
    rng = np.random.default_rng(4)
    for d, g, b in ((3, 7, 9), (2, 5, 4), (5, 3, 1), (3, 4, 36)):
        idx_lo = rng.integers(0, g - 1, (g, d)).astype(np.int32)
        w_hi, a, bb = rng.random((g, d)), rng.normal(size=(d, g)), rng.normal(size=(d, g))
        ci = rng.normal(size=(d, g, b))
        f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
        got = decision_kernel.pack_records(torch.tensor(idx_lo), f32(w_hi), f32(ci), f32(a),
                                           f32(bb)).numpy()
        bp = 4 * -(-b // 4)
        want = np.zeros((g, 4 + (d - 1) * (4 + bp)), dtype=np.float32)
        for gi in range(g):
            col = 0
            for k in range(d):
                want[gi, col:col + 4] = (a[k, gi], bb[k, gi], w_hi[gi, k],
                                         idx_lo[gi, k:k + 1].view(np.float32)[0])
                col += 4
                if k:
                    want[gi, col:col + b] = (ci[k, gi].astype(np.float32)
                                             - ci[0, gi].astype(np.float32))
                    col += bp
            assert col == want.shape[1] == decision_kernel.record_words(d, b)
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("d", [2, 3, 5])
@pytest.mark.parametrize("b", [1, 4, 9, 16])
def test_shared_route_sizing_follows_the_records(d, b):
    """Kernel B's shared route holds a step's records (csrc/decision_step.cuh):
    {a, b, w_hi, idx_lo} per decision and, after each decision past the
    first, its coefficients padded to whole float4s; beside them the static
    [8, 128] best_act tile and the [B, 128] design tile.  Kernel D's holds
    the same records alone."""
    bp = 4 * -(-b // 4)
    record = 4 + (d - 1) * (4 + bp)
    assert decision_kernel.record_words(d, b) == record
    words = H100_SMEM // 4
    assert decision_kernel.moments_max_grid(d, b, H100_SMEM) == (words - 8 * 128 - b * 128) // record
    assert decision_kernel.update_max_grid(d, b, H100_SMEM) == words // record


def test_large_tiles_shrink_to_fit():
    """A shape whose TILE_B grid points of tables do not fit takes fewer a
    tile (a multiple of kernel B's chunk of 8 where one fits)."""
    d, b = 91, 16  # a record of 1,804 words a grid point
    fits = decision_kernel.moments_max_grid(d, b, H100_SMEM)
    assert 8 <= fits < decision_kernel.TILE_B
    route = decision_kernel.moments_route(4_096, d, b, H100_SMEM)
    assert route.name == "large" and route.tile == fits - fits % 8


def _launch_counts():
    return [fn.launches for fn in (
        rng_kernel.normal_halves, rng_kernel.simulate_sweep, decision_kernel.decision_update_moments,
        decision_kernel.decision_update, decision_kernel.decision_update_fullstep,
        forward_kernel.forward_sweep, forward_kernel.forward_sweep_design)]


class _Routed(Exception):
    """Raised where the routes have been chosen, to stop the valuation there."""


def _routes_on_cuda(monkeypatch, call) -> list:
    """Calls ``call(device="cuda")`` with CUDA stood in (no card here) and an
    H100's shared memory a block: the grid routes must be chosen, from
    shapes alone, before any simulation or panel copy, without a
    ``ValueError``, and nothing must launch.  Returns the routes chosen."""
    import storage_tpu_torch.api_lsmc as api_lsmc

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "smem_limit", lambda device: H100_SMEM)

    def no_sims(*args, **kwargs):
        raise AssertionError("simulated before the routes were chosen")

    monkeypatch.setattr(api_lsmc.spot_sim, "simulate_ou_paths", no_sims)
    monkeypatch.setattr(api_lsmc, "_frames_to_sims", no_sims)
    routes, real = [], torch_lsmc.grid_routes

    def spy(*args):
        routes.append(real(*args))
        raise _Routed

    monkeypatch.setattr(torch_lsmc, "grid_routes", spy)
    before = _launch_counts()
    with pytest.raises(_Routed):
        call(device="cuda")
    assert _launch_counts() == before
    return routes


def _spot_frames(num_sims=8):
    storage, start, fwd = _case(tpkg)
    idx = pd.period_range(start, storage.end, freq="D")
    frame = pd.DataFrame(np.full((len(idx), num_sims), 30.0), index=idx)
    return storage, start, fwd, frame


_ENTRIES = {
    "three-factor": (lambda **kw: tpkg.three_factor_seasonal_value(
        *_case(tpkg)[:2], fwd_curve=_case(tpkg)[2], dtype=torch.float32, **_API_KWARGS, **kw),
        ("decision_update_moments", "large"), ("forward_sweep", "large")),
    # The headline's nine terms and a callable: past the shared routes of
    # kernel D (1,614 grid points at B = 10) and C's design mode (2,606).
    "generic": (lambda **kw: tpkg.three_factor_seasonal_value(
        *_case(tpkg)[:2], fwd_curve=_case(tpkg)[2], dtype=torch.float32,
        **{**_API_KWARGS, "basis_funcs": [*parse_basis_functions(BASIS), tpkg.generic(
            lambda s, x: torch.exp(-x[1]), num_factors=2)]}, **kw),
        ("decision_update", "large"), ("forward_sweep_design", "large")),
    "custom-rows": (lambda **kw: tpkg.three_factor_seasonal_value(
        *_case(tpkg)[:2], fwd_curve=_case(tpkg)[2], dtype=torch.float32,
        **{**_API_KWARGS, "grid_calc": lambda lo, hi: lo + (hi - lo) * np.linspace(
            0.0, 1.0, GRID) ** 1.5}, **kw),
        ("decision_update_moments", "large"), ("forward_sweep", "large")),
    "spot-only": (lambda **kw: tpkg.value_from_sims(
        _spot_frames()[0], _spot_frames()[1], 100.0, _spot_frames()[2], 0.02, None,
        _spot_frames()[3], _spot_frames()[3], "1 + s + s**2 + s**3", False,
        num_inventory_grid_points=GRID, dtype=torch.float32, **kw),
        # C stages no factor here: its shared route holds 7,163 grid points,
        # at 1 block an SM past 1,691.
        ("decision_update", "large"), ("forward_sweep", "large")),
}


@pytest.mark.parametrize("entry", list(_ENTRIES))
def test_large_routes_chosen_before_anything_runs(monkeypatch, entry):
    """The intrinsic DP keeps its shared route at G = 4,096 (it holds 29,034
    grid points in f32, 14,517 on general rows)."""
    call, backward, forward = _ENTRIES[entry]
    assert _routes_on_cuda(monkeypatch, call) == [
        {"intrinsic": ("intrinsic_dp", "shared"), "backward": backward, "forward": forward}]


def test_headline_grid_keeps_the_shared_routes(monkeypatch):
    """At the headline's 100 grid points every kernel keeps its shared route."""
    routes = _routes_on_cuda(monkeypatch, lambda **kw: tpkg.three_factor_seasonal_value(
        *_case(tpkg)[:2], fwd_curve=_case(tpkg)[2], dtype=torch.float32,
        **{**_API_KWARGS, "num_inventory_grid_points": 100}, **kw))
    assert routes == [{"intrinsic": ("intrinsic_dp", "shared"),
                       "backward": ("decision_update_moments", "shared"),
                       "forward": ("forward_sweep", "shared")}]


@pytest.mark.parametrize("b_dim", [9, 4, 1, 20])
def test_large_route_tables(b_dim):
    """The large route's packed rows hold the parts before the coefficients
    alone (``forward_sweep.cuh`` fixed_table_words), and its coefficients go
    beside them as [N, G, Bp]: each grid row's terms adjacent, zero-padded to
    whole 16-byte words (``padded_basis``, the kernel's vector loads); in
    general-grid mode the general tails [N, 2G + 1] go beside them too."""
    n, r, g = 3, 3, 50
    gen = torch.Generator().manual_seed(2)
    parts = [torch.randn(shape, generator=gen) for shape in (
        (n, forward_kernel.NUM_PARAMS), (n, b_dim), (n, b_dim), (n, r), (n, r), (n, r),
        (n, b_dim, g))]
    table, coeffs, tails = forward_kernel.pack_tables(*parts, large=True)
    _, width = forward_kernel.table_layout(b_dim, r, g, large=True)
    used = forward_kernel.NUM_PARAMS + 2 * b_dim + 3 * r
    assert table.shape == (n, width) and width == (used + 3) // 4 * 4
    assert torch.equal(table[:, :used], torch.cat(parts[:6], dim=1))
    bp = forward_kernel.padded_basis(b_dim)
    assert bp % 4 == 0 and b_dim <= bp < b_dim + 4 and tails is None
    assert coeffs.shape == (n, g, bp) and coeffs.is_contiguous()
    assert torch.equal(coeffs[..., :b_dim], parts[6].transpose(1, 2))
    assert torch.equal(coeffs[..., b_dim:], torch.zeros((n, g, bp - b_dim)))
    grid = torch.sort(torch.randn((n, g), generator=gen), dim=1).values
    table_g, coeffs_g, tails = forward_kernel.pack_tables(*parts, grid, large=True)
    assert torch.equal(table_g, table) and torch.equal(coeffs_g, coeffs)
    assert torch.equal(tails, forward_kernel.general_tail(grid))
    src = (Path(forward_kernel.__file__).resolve().parent.parent / "csrc"
           / "forward_sweep.cuh").read_text()
    assert "return table_words(B, R, 0, false);" in src
    assert "inline int padded_basis(int B) { return (B + 3) / 4 * 4; }" in src
