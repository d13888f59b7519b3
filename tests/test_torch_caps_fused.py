"""Kernel B and kernel C's monomial mode past the register caps (16 basis
terms, 8 factors): their wide routes, which the engine now takes for every
monomial basis of up to 64 terms on any factor count, as the JAX package's
fused kernels take any monomial basis.

* B's plain version (``decision_update_moments_plain``) against the Pallas
  TPU kernel it replaces (``decision_update_moments_pallas``, interpret
  mode, ``pred_passes=1``) at 20 terms on 3 factors and 13 terms on 10
  factors, with the tolerances of tests/test_torch_decision_kernel.py.
* C's plain monomial sweep (``forward_sweep`` on CPU tensors) against
  ``forward_step_pallas`` (interpret mode, ``pred_passes=1``) step by step
  at both shapes, each step from the sweep's own inventory before it, with
  the tolerances of tests/test_torch_forward_kernel.py.
* The routes' sizing copies (``moments_plan``, ``sweep_wide``,
  ``sweep_max_grid``, ``sweep_blocks_per_sm``, ``sweep_route``) against
  their formula on both sides of each crossing, at an H100's shared memory.
* A streamed valuation and a host-fed ``value_from_sims`` at 20 terms
  (the threshold lowered, as tests/test_torch_host_streamed_panels.py
  lowers it) against the materialised ones, and an interactive valuation
  against the uninterrupted one: the same bits; adjoint deltas against the
  pathwise ones.

The wide routes themselves run on the card (tests/test_torch_cuda_kernels.py,
``chip_smoke.py``); on the CPU the wrappers take the plain versions.
"""
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from storage_tpu.basis import parse_basis_functions as jax_parse
from storage_tpu.ops import decision_kernel as jdk
from storage_tpu.ops import forward_kernel as jfk
from storage_tpu.ops.interp import interp_weights as jax_interp_weights
import storage_tpu_torch as tpkg
from storage_tpu_torch.basis import design_matrix, parse_basis_functions
from storage_tpu_torch.ops import _build, decision_kernel, forward_kernel
from storage_tpu_torch.parallel import mesh as torch_mesh

torch.set_num_threads(1)

# The full quadratic in the spot and the three factors (15 terms), the four
# cubes and s**4: 20 terms (chip_smoke.py's BASIS_20).
BASIS_20 = ("1 + s + x0 + x1 + x2 + s**2 + x0**2 + x1**2 + x2**2 + s*x0 + s*x1 + s*x2 + x0*x1 "
            "+ x0*x2 + x1*x2 + s**3 + x0**3 + x1**3 + x2**3 + s**4")
TEN = 10
BASIS_10F = "1 + s + s**2 + " + " + ".join(f"x{i}" for i in range(TEN))  # 13 terms
SHAPES = {"20-terms-3-factors": (BASIS_20, 3), "13-terms-10-factors": (BASIS_10F, TEN)}
H100_SMEM = 232_448  # an H100's shared memory a block (opt-in)


def _stats(basis, spot, factors):
    """Each design column's mean and std on these paths (f64, then f32), so
    that the standardised entries are of order one, as the engine's are."""
    dm = design_matrix(tuple(parse_basis_functions(basis)), torch.tensor(spot, dtype=torch.float64),
                       torch.tensor(factors, dtype=torch.float64)).numpy()
    std = dm.std(axis=0)
    mean = np.where(std > 0, dm.mean(axis=0), 0.0)
    return mean.astype(np.float32), np.where(std > 0, std, 1.0).astype(np.float32)


def _b_case(basis, f, seed=5, g=12, s=256, d=3):
    """tests/test_torch_decision_kernel.py's case at another basis and
    factor count, with each step's design stats taken on its own paths."""
    rng = np.random.default_rng(seed)
    b_dim = len(jax_parse(basis))
    grid_next = np.linspace(0.0, 1000.0, g)
    idx_lo, w_hi = jax_interp_weights(jnp.asarray(grid_next),
                                      jnp.asarray(rng.uniform(-50.0, 1050.0, (g, d))))
    spot, spot_prev = rng.uniform(10.0, 50.0, s), rng.uniform(10.0, 50.0, s)
    factors, factors_prev = rng.normal(0.0, 1.0, (f, s)), rng.normal(0.0, 1.0, (f, s))
    mean, std = _stats(basis, spot, factors)
    case = dict(
        v=rng.normal(100.0, 30.0, (g, s)) + grid_next[:, None], spot=spot, factors=factors,
        spot_prev=spot_prev, factors_prev=factors_prev, mean=mean, std=std,
        idx_lo=np.asarray(idx_lo), w_hi=np.asarray(jdk.snap_weights(w_hi)),
        ci=rng.normal(0.0, 20.0, (d, g, b_dim)),
        a=rng.normal(0.0, 2.0, (d, g)), b=rng.normal(0.0, 20.0, (d, g)),
    )
    return {k: (v if k == "idx_lo" else np.asarray(v, np.float32)) for k, v in case.items()}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_b_plain_matches_pallas_kernel_past_the_caps(shape):
    basis, f = SHAPES[shape]
    c = _b_case(basis, f)
    g = c["v"].shape[0]
    j = {k: jnp.asarray(v) for k, v in c.items()}
    w_mat = jdk.interp_weight_matrix(j["idx_lo"], j["w_hi"], g, jnp.float32)
    want = jdk.decision_update_moments_pallas(
        j["v"], j["spot"], j["factors"], j["spot_prev"], j["factors_prev"], j["mean"], j["std"],
        w_mat, j["ci"], j["a"], j["b"], tuple(jax_parse(basis)), sim_tile=128,
        interpret=True, pred_passes=1,
    )
    t = {k: torch.tensor(v) for k, v in c.items()}
    before = decision_kernel.decision_update_moments.launches
    got = decision_kernel.decision_update_moments(
        t["v"], t["spot"], t["factors"], t["spot_prev"], t["factors_prev"], t["mean"], t["std"],
        t["mean"], t["std"], t["idx_lo"].to(torch.int32), t["w_hi"], t["ci"], t["a"], t["b"],
        tuple(parse_basis_functions(basis)))
    assert decision_kernel.decision_update_moments.launches == before  # the plain version
    scale = float(np.abs(c["v"]).max())
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=2.0**-15 * scale)
    # Moments over s sims: f32 sums in another order.
    for k in (1, 2):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=2e-5 * np.abs(w).max())


STEPS = 4


def _c_case(basis, f, seed=7, s=256, g=16, r=4, e=1):
    """tests/test_torch_forward_kernel.py's step at another basis and factor
    count, over STEPS steps: each step's paths, design stats and
    coefficients."""
    rng = np.random.default_rng(seed)
    b_dim = len(jax_parse(basis))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    scalars = dict(df_settle=0.97, df_flow=0.95, inj_cost=1.2, wdr_cost=0.9, inj_pcnt=0.015,
                   wdr_pcnt=0.01, loss_pcnt=0.02, inv_cost_rate=0.03, next_min=0.0,
                   next_max=1100.0)
    spot = rng.uniform(20.0, 60.0, (STEPS, s))
    factors = rng.normal(0.0, 0.5, (STEPS, f, s))
    stats = [_stats(basis, spot[t], factors[t]) for t in range(STEPS)]
    # Coefficients whose fitted values are of the order of the values, with a
    # slope in the inventory, so that the decisions differ from step to step.
    coeffs = rng.normal(0.0, 20.0, (STEPS, b_dim, g))
    coeffs[:, 0] = np.linspace(0.0, 30.0 * 1100.0, g)
    return dict(
        scalars={k: f32(v) for k, v in scalars.items()},
        grid_next=f32(np.linspace(0.0, 1100.0, g)),
        mean=f32([m for m, _ in stats]), std=f32([sd for _, sd in stats]),
        ratchet_inv=f32(np.linspace(0.0, 1000.0, r)),
        ratchet_min=f32(np.linspace(-30.0, -140.0, r)),
        ratchet_max=f32(np.linspace(150.0, 40.0, r)), spot=f32(spot), factors=f32(factors),
        inventory=f32(rng.uniform(0.0, 1000.0, s)), coeffs=f32(coeffs), e=e)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_c_plain_sweep_matches_pallas_kernel_past_the_caps(shape):
    """Each step of the port's sweep (the plain version on CPU tensors)
    against the Pallas kernel's step from the same inventory and PV: the
    sweep's own state before that step."""
    basis, f = SHAPES[shape]
    c = _c_case(basis, f)
    params = jfk.pack_params({k: jnp.asarray(v) for k, v in c["scalars"].items()},
                             jnp.asarray(c["grid_next"]))
    tparams = forward_kernel.pack_params({k: torch.tensor(v) for k, v in c["scalars"].items()},
                                         torch.tensor(c["grid_next"]))
    np.testing.assert_array_equal(tparams.numpy(), np.asarray(params))
    n, s = c["spot"].shape
    rep = lambda a: torch.tensor(a).expand(n, *a.shape).contiguous()  # noqa: E731
    rows = [torch.empty((n, s)) for _ in range(4)]  # inventory, volume, fuel, immediate PV
    before = forward_kernel.forward_sweep.launches
    inv_end, pv_end, sums, xbar = forward_kernel.forward_sweep(
        tparams.expand(n, -1).contiguous(), torch.tensor(c["mean"]), torch.tensor(c["std"]),
        rep(c["ratchet_inv"]), rep(c["ratchet_min"]), rep(c["ratchet_max"]),
        torch.tensor(c["spot"]), torch.tensor(c["factors"]), torch.tensor(c["inventory"]), None,
        torch.tensor(c["coeffs"]), tuple(parse_basis_functions(basis)), c["e"], False,
        panels=rows)
    assert forward_kernel.forward_sweep.launches == before  # the plain version
    inv, pv = c["inventory"], np.zeros(s, np.float32)
    for t in range(n):
        want = jfk.forward_step_pallas(
            params, *(jnp.asarray(c[k][t]) for k in ("mean", "std")),
            *(jnp.asarray(c[k]) for k in ("ratchet_inv", "ratchet_min", "ratchet_max")),
            jnp.asarray(c["spot"][t]), jnp.asarray(c["factors"][t]), jnp.asarray(inv),
            jnp.asarray(pv), jnp.asarray(c["coeffs"][t]), tuple(jax_parse(basis)), c["e"], False,
            128, interpret=True, pred_passes=1)
        got = (rows[0][t], pv + rows[3][t].numpy(), rows[1][t], rows[2][t])
        for name, g_arr, w_arr in zip(("inventory", "pv", "decision", "consumed"), got, want[:4]):
            np.testing.assert_allclose(np.asarray(g_arr), np.asarray(w_arr), rtol=1e-5,
                                       atol=1e-3, err_msg=f"{name} at step {t}")
        np.testing.assert_allclose(sums[t].numpy(), np.asarray(want[4]), rtol=1e-5,
                                   atol=1e-4 * s, err_msg=f"sums at step {t}")
        np.testing.assert_allclose(xbar[t].numpy(), np.asarray(want[5]), rtol=1e-5,
                                   atol=1e-5 * s, err_msg=f"xbar at step {t}")
        # The next step starts from the sweep's own state.
        inv, pv = rows[0][t].numpy(), pv + rows[3][t].numpy()
    np.testing.assert_array_equal(inv_end.numpy(), inv)
    np.testing.assert_allclose(pv_end.numpy(), pv, rtol=1e-6)


@pytest.mark.parametrize("terms,factors,body", [
    (16, 8, "register"), (17, 8, "wide"), (16, 9, "wide"), (20, 3, "wide"), (13, 10, "wide"),
    (32, 3, "wide"), (33, 3, "wide-smem"), (64, 10, "wide-smem")])
def test_moments_plan_by_shape(terms, factors, body):
    """Kernel B's body from B and F alone (the register kernels within 16
    terms and 8 factors, else kernel E's wide body: registers up to 32
    padded terms, shared memory to 64), and its grid route, shared up to the
    body's crossing and large past it: ``moments_route``'s on the register
    kernels, ``wide_route``'s on a wide body."""
    plan = decision_kernel.moments_plan(100, 3, terms, factors, H100_SMEM)
    assert (plan.body, plan.wide) == (body, body != "register")
    if body == "register":
        rule = lambda g: decision_kernel.moments_route(g, 3, terms, H100_SMEM)  # noqa: E731
    else:
        rule = lambda g: decision_kernel.wide_route(g, 3, terms, factors, H100_SMEM,  # noqa: E731
                                                    body=body)
    last = max(g for g in range(2, 3_000) if rule(g).name == "shared")
    for g in (last, last + 1, 4_096):
        plan = decision_kernel.moments_plan(g, 3, terms, factors, H100_SMEM)
        assert (plan.name, plan.tile, plan.body) == (*rule(g), body)
    assert decision_kernel.moments_plan(last + 1, 3, terms, factors, H100_SMEM).name == "large"


@pytest.mark.parametrize("route,body", [("wide-shared", "wide"), ("wide-smem-large", "wide-smem")])
def test_moments_plan_forced_body(route, body):
    """A route of ``WIDE_ROUTES`` forces kernel B's wide body at the
    headline's 9 terms on 3 factors; past 64 terms any body raises
    ``ValueError`` before any launch."""
    plan = decision_kernel.moments_plan(100, 3, 9, 3, H100_SMEM, route=route)
    assert (plan.body, plan.name) == (body, route.rsplit("-", 1)[1])
    with pytest.raises(ValueError, match="at most 64"):
        decision_kernel.moments_plan(100, 3, 65, 3, H100_SMEM)


def _sweep_formula(b, r, f, e, general):
    """The monomial sweep's shared memory (csrc/forward_sweep.cuh), written
    out: (static bytes, fixed words, words a grid point)."""
    wide = b > 16 or f > 8
    fixed = 2 * (13 + 2 * b + 3 * r + 3 + (1 + f) * 256) + 2 * (2 * e + 3) + 2 * int(general)
    if wide:
        fixed += 2 * 8 * (6 + b) + b * 256 + -(-b * (f + 1) // 4)
        static = 16 + 4
    else:
        static = 16 + 4 * 2 * 8 * (6 + b) + 4 * b * 10
    return -(-static // 128) * 128, fixed, 2 * (b + 2 * int(general))


@pytest.mark.parametrize("general", [False, True], ids=["uniform", "general"])
@pytest.mark.parametrize("terms,factors", [(16, 8), (17, 8), (16, 9), (20, 3), (13, 10),
                                           (32, 3), (64, 10)])
def test_sweep_sizing_matches_its_formula(terms, factors, general):
    """The monomial sweep's Python sizing against its formula on both sides
    of the wide route's crossing (16 terms, 8 factors) and of the shared
    route's largest grid: the wide route keeps its shared route while it
    fits; the compiled sizes while it also leaves 4 blocks an SM."""
    r, e = 3, 0
    assert forward_kernel.sweep_wide(terms, factors) == (terms > 16 or factors > 8)
    static, fixed, per_point = _sweep_formula(terms, r, factors, e, general)
    max_grid = ((H100_SMEM - static) // 4 - fixed) // per_point
    assert forward_kernel.sweep_max_grid(terms, r, factors, e, H100_SMEM,
                                         general=general) == max_grid
    for g in (50, max_grid):
        smem = static + 4 * (fixed + per_point * g)
        blocks = min((H100_SMEM + 1024) // (-(-smem // 128) * 128 + 1024), 2048 // 256)
        assert forward_kernel.sweep_blocks_per_sm(g, terms, r, factors, e, H100_SMEM,
                                                  general=general) == blocks
        route = "shared" if forward_kernel.sweep_wide(terms, factors) or blocks >= 4 else "large"
        assert forward_kernel.sweep_route(g, terms, r, factors, e, H100_SMEM,
                                          general=general) == route
    assert forward_kernel.sweep_route(max_grid + 1, terms, r, factors, e, H100_SMEM,
                                      general=general) == "large"
    with pytest.raises(ValueError, match="at most"):
        forward_kernel.sweep_route(max_grid + 1, terms, r, factors, e, H100_SMEM,
                                   general=general, route="shared")


SIMS = 100
BASIS_20_API = BASIS_20.replace("x0", "x_st").replace("x1", "x_lt").replace("x2", "x_sw")


def _three_factor(**kwargs):
    start = pd.Period("2021-01-01", freq="D")
    storage = tpkg.CmdtyStorage(
        "D", start, start + 20, 0.9, 0.7,
        ratchets=[(start, [(0.0, -200.0, 300.0), (2500.0, -250.0, 250.0),
                           (5000.0, -300.0, 200.0)])],
        ratchet_interp=tpkg.RatchetInterp.LINEAR,
        terminal_storage_npv=lambda price, inv: price * inv)
    idx = pd.period_range(start, storage.end, freq="D")
    i = np.arange(len(idx))
    fwd = pd.Series(index=idx, data=30.0 + 6 * np.sin(2 * np.pi * i / 365.0) + 0.4 * np.cos(i))
    args = (storage, start, 100.0, fwd, 0.02, None)
    return args, tpkg.three_factor_seasonal_value(
        *args, 14.5, 1.1, 0.19, 0.23, SIMS, BASIS_20_API, True, seed=11, fwd_sim_seed=13,
        extra_decisions=1, num_inventory_grid_points=10, device="cpu", **kwargs)


def _same_bits(got, want):
    assert got.npv == want.npv
    assert got.val_sim_standard_error == want.val_sim_standard_error
    pd.testing.assert_series_equal(got.deltas, want.deltas, rtol=0, atol=0)
    pd.testing.assert_frame_equal(got.expected_profile, want.expected_profile, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_streamed_20_terms_matches_materialised(monkeypatch, dtype):
    """At 20 terms on the 3-factor model, the valuation with its paths
    regenerated a segment at a time (``multi_factor``'s streamed engine), and
    ``value_from_sims`` on its panels fed from host memory a segment at a
    time, against the materialised runs: the same bits."""
    flags = tpkg.SimulationDataReturned
    args, whole = _three_factor(dtype=dtype, sim_data_returned=flags.SPOT_ALL | flags.FACTORS_ALL)
    frames = dict(sim_spot_regress=whole.sim_spot_regress,
                  sim_spot_valuation=whole.sim_spot_valuation,
                  sim_factors_regress=whole.sim_factors_regress,
                  sim_factors_valuation=whole.sim_factors_valuation)

    def from_sims():
        return tpkg.value_from_sims(*args, basis_funcs=BASIS_20_API, discount_deltas=True,
                                    extra_decisions=1, num_inventory_grid_points=10,
                                    dtype=dtype, device="cpu", **frames)

    from_whole = from_sims()
    monkeypatch.setattr(torch_mesh, "STREAM_THRESHOLD_BYTES", 1024)
    _, streamed = _three_factor(dtype=dtype)
    _same_bits(streamed, whole)
    _same_bits(from_sims(), from_whole)
    assert _build.MAX_WIDE_BASIS >= 20


def test_interactive_and_adjoint_20_terms_keep_the_bits():
    """At 20 terms on the 3-factor model, an interactive valuation (kernel
    C a launch a 16-step segment, the backward called back between
    segments) gives the uninterrupted valuation's bits; adjoint deltas keep
    its NPV, SE and profile and agree with its pathwise deltas before the
    last step (tests/test_torch_adjoint.py's relation)."""
    _, whole = _three_factor(dtype=torch.float64)
    marks = []
    _, interactive = _three_factor(dtype=torch.float64, on_progress_update=marks.append,
                                   cancellation_poll=lambda: False)
    _same_bits(interactive, whole)
    assert marks[-1] == 1.0 and len(marks) > 4
    _, adjoint = _three_factor(dtype=torch.float64, deltas_method="adjoint")
    assert (adjoint.npv, adjoint.val_sim_standard_error) == (whole.npv,
                                                             whole.val_sim_standard_error)
    pd.testing.assert_frame_equal(adjoint.expected_profile, whole.expected_profile,
                                  check_exact=True)
    np.testing.assert_allclose(adjoint.deltas.to_numpy()[:-1], whole.deltas.to_numpy()[:-1],
                               rtol=1e-9, atol=1e-9)
