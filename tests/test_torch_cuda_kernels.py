"""The CUDA kernels of storage_tpu_torch against their plain versions, on the
card, at small and ragged shapes (path counts that fill no whole block).
Marked ``cuda``: they need an NVIDIA GPU and nvcc, and skip elsewhere.  Run
them on the card with ``python -m pytest tests/test_torch_cuda_kernels.py``.

Tolerances: the kernels and the plain versions do the decision arithmetic in
the same order without fused multiply-adds, so per-path outputs match to f32
rounding; the cross-path sums are taken in another order (1e-5 relative).
Kernel E factors its [B, B] system in double by its own loop, the plain
version in double with torch.linalg, so its coefficients, and the values and
moments that follow from them, agree to 1e-4 relative.  The intrinsic DP
kernel does its plain version's arithmetic operation by operation; the
sums (the NPV, the cubic moments' matvec) go in another order: f64 within
1e-10 relative, f32 within 1e-5 of the f64 answer.  The tree's DP kernel
likewise: its expected continuation sums the band where the plain version
multiplies the dense matrix, so f64 values within 1e-9 of their scale and
the NPV within 1e-10 relative.  Kernel C's general-grid mode does its plain
version's arithmetic like the uniform one; the forward sweep's VJP sums in
another order (f32 within 1e-5 of the largest entry, f64 within 1e-12).
"""
import numpy as np
import pandas as pd
import pytest
import torch

import storage_tpu_torch as tpkg
from storage_tpu_torch import basis as tbasis
from storage_tpu_torch import grid as gridmod
from storage_tpu_torch.basis import parse_basis_functions
from storage_tpu_torch.engines import intrinsic as intrinsic_engine
from storage_tpu_torch.engines import lsmc as lsmc_engine
from storage_tpu_torch.engines import tree as tree_engine
from storage_tpu_torch.models import trinomial_tree
from storage_tpu_torch.ops import (_build, decision_kernel, forward_kernel, interp,
                                   intrinsic_kernel, rng_kernel, tree_kernel)
from storage_tpu_torch.valuation_inputs import prepare_valuation

from _torch_intrinsic_case import START, curve, facility, snapped_steps

pytestmark = pytest.mark.cuda

BASIS = "1 + s + x0 + x1 + x0**2 + s*x2"
BASIS_9 = "1 + x0 + x1 + x2 + x0**2 + x1**2 + x2**2 + s + s**2"  # the main path's 9 terms


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("with_sign", [False, True])
def test_normal_halves(device, with_sign):
    ids = torch.arange(5, 1005, dtype=torch.int32, device=device)
    sign = (1.0 - 2.0 * (torch.arange(1000, device=device) % 2)).float() if with_sign else None
    got = rng_kernel.normal_halves((3, 11), 7, 33, ids, sign)
    want = rng_kernel.normal_halves_plain((3, 11), 7, 33, ids, sign)
    for g, w in zip(got, want):
        assert int((g.view(torch.int32).long() - w.view(torch.int32).long()).abs().max()) <= 4
    w1, _ = rng_kernel.threefry_words((3, 11), 7, 33, ids)
    p1, _ = rng_kernel.threefry2x32(3, 11, ids.long()[None, :], 7 + torch.arange(33, device=device)[:, None])
    assert torch.equal(w1.long() & rng_kernel.MASK32, p1)


def _sweep_tables(device, p, f, seed=3):
    """OU step tables over P steps at F factors (decay, chol, vols, c)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    decay = 0.6 + 0.4 * torch.rand((p, f), generator=gen, device=device)
    chol = torch.tril(0.1 * torch.randn((p, f, f), generator=gen, device=device))
    vols = 0.5 + torch.rand((p, f), generator=gen, device=device)
    c = 3.4 + 0.1 * torch.randn(p, generator=gen, device=device)
    return decay, chol.contiguous(), vols, c


def _ulp(a, b) -> int:
    return int((a.view(torch.int32).long() - b.view(torch.int32).long()).abs().max())


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "antithetic"])
@pytest.mark.parametrize("f,p", [(1, 9), (2, 9), (3, 366), (3, 7), (8, 9), (9, 7), (10, 9),
                                 (12, 9), (13, 7), (20, 9)])
def test_simulate_sweep(device, f, p, antithetic):
    """The simulation sweep against its plain version at F = 1, 2, 3, 8, 9,
    10 and 12 (compiled per F) and 13 and 20 (the wide route, F at run time)
    over odd and even step counts (the word parity changes across steps when F
    is odd), with and without antithetic signs, on paths that fill no whole
    block: the factors to the bit, the spot to the bit (the same expf)."""
    s = 1000
    path_ids = torch.arange(s, device=device) + 77
    ids = (path_ids // 2 if antithetic else path_ids).to(torch.int32)
    sign = (1.0 - 2.0 * (path_ids % 2)).float() if antithetic else None
    tables = _sweep_tables(device, p, f)
    before = rng_kernel.simulate_sweep.launches
    factors, spot = rng_kernel.simulate_sweep((3, 11), ids, sign, *tables)
    assert rng_kernel.simulate_sweep.launches == before + 1
    want_f, want_s = rng_kernel.simulate_sweep_plain((3, 11), ids, sign, *tables)
    assert factors.shape == (p, f, s) and spot.shape == (p, s)
    assert torch.equal(factors, want_f)
    assert _ulp(spot, want_s) == 0


@pytest.mark.parametrize("antithetic", [False, True], ids=["plain", "antithetic"])
@pytest.mark.parametrize("f", [1, 2, 3, 8, 9, 10, 12, 13])
@pytest.mark.parametrize("start", [5, 6], ids=["odd", "even"])
def test_resumed_sweep(device, f, start, antithetic):
    """The sweep resumed at a start step from the state entering it (the
    streamed engine's segments) against its plain version resumed alike and
    against rows start.. of one sweep from step 0: the same bits, at odd and
    even start steps (at odd F and start the first word is the second half
    of its block)."""
    s, p = 1000, 11
    path_ids = torch.arange(s, device=device) + 77
    ids = (path_ids // 2 if antithetic else path_ids).to(torch.int32)
    sign = (1.0 - 2.0 * (path_ids % 2)).float() if antithetic else None
    tables = _sweep_tables(device, p, f)
    whole = rng_kernel.simulate_sweep((3, 11), ids, sign, *tables)
    x0 = whole[0][start - 1].contiguous()
    tail = [t[start:].contiguous() for t in tables]
    before = rng_kernel.simulate_sweep.launches
    got = rng_kernel.simulate_sweep((3, 11), ids, sign, *tail, start, x0)
    assert rng_kernel.simulate_sweep.launches == before + 1
    want = rng_kernel.simulate_sweep_plain((3, 11), ids, sign, *tail, start, x0)
    for g, w, full in zip(got, want, whole):
        assert torch.equal(g, w) and torch.equal(g, full[start:])


def test_simulate_sweep_raises(device):
    """Past the factors whose state and draws the wide route's shared memory
    holds the sweep raises ValueError naming that limit, before any launch;
    a wrong dtype or shape raises too."""
    ids = torch.arange(64, dtype=torch.int32, device=device)
    before = rng_kernel.simulate_sweep.launches
    most = rng_kernel.sweep_info(20, device)["max_factors"]
    assert most >= 100
    with pytest.raises(ValueError, match=f"at most F={most}"):
        rng_kernel.simulate_sweep((3, 11), ids, None, *_sweep_tables(device, 2, most + 1))
    with pytest.raises(TypeError):
        rng_kernel.simulate_sweep((3, 11), ids.long(), None, *_sweep_tables(device, 5, 3))
    decay, chol, vols, c = _sweep_tables(device, 5, 3)
    with pytest.raises(ValueError):
        rng_kernel.simulate_sweep((3, 11), ids, None, decay, chol[:4], vols, c)
    assert rng_kernel.simulate_sweep.launches == before


def test_simulate_sweep_launch_report(device):
    """The sweep's launch report: 256 paths a block, no shared memory up to 12
    factors and 2 KB a factor on the wide route beyond, and whole blocks
    resident on an SM at every F."""
    for f in (1, 3, 8, 10, 12, 13, 20):
        info = rng_kernel.sweep_info(f, device)
        assert info["paths_per_block"] == 256
        assert info["smem_bytes"] == (0 if f <= 12 else 2 * f * 256 * 4)
        assert info["blocks_per_sm"] >= 1 and 0 < info["registers"] <= 255


def _decision_args(device, g, s, d, f, basis=BASIS, seed=3):
    gen = torch.Generator(device=device).manual_seed(seed)
    monomials = tuple(parse_basis_functions(basis))
    b = len(monomials)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=device)  # noqa: E731
    return (100.0 + 30.0 * rnd(g, s), 30.0 + 5.0 * rnd(s), rnd(f, s), 30.0 + 5.0 * rnd(s),
            rnd(f, s), 0.3 * rnd(b), 1.0 + 0.2 * rnd(b).abs(), 0.3 * rnd(b), 1.0 + 0.2 * rnd(b).abs(),
            torch.randint(0, g - 1, (g, d), generator=gen, device=device, dtype=torch.int32),
            torch.rand((g, d), generator=gen, device=device), 20.0 * rnd(d, g, b), 2.0 * rnd(d, g),
            20.0 * rnd(d, g), monomials)


@pytest.mark.parametrize("g", [11, 400, 1000])
@pytest.mark.parametrize("f", [3, 0], ids=["factors", "spot-only"])
def test_decision_update_moments(device, f, g):
    """Kernel B, also on spot-only panels (an empty [0, S] factor tensor,
    whose data pointer may be null, is never read) and beyond 338 grid
    points, where its first design ran out of shared memory at D=3, B=9."""
    d = 5 if g == 11 else 3
    basis = (BASIS if g == 11 else BASIS_9) if f else "1 + s + s**2"
    args = _decision_args(device, g, 300, d, f, basis=basis)
    got = decision_kernel.decision_update_moments(*args)
    want = decision_kernel.decision_update_moments_plain(*args)
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=1e-4)
    for k in (1, 2):
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-5 * float(want[k].abs().max()))


def test_decision_update_moments_deterministic(device):
    """Two launches on the same inputs give the same bits: the moments are
    summed in a fixed order, with no atomics."""
    args = _decision_args(device, 100, 5000, 3, 3, basis=BASIS_9)
    first = [t.clone() for t in decision_kernel.decision_update_moments(*args)]
    second = decision_kernel.decision_update_moments(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_grid_beyond_shared_memory_raises(device):
    """Where the step tables exceed the card's shared memory, kernels B and E
    take their large route (the tables a tile at a time) in place of the
    refusal they once gave: B to its plain version, E's step to kernel B on
    its own regression, to the bit."""
    info = decision_kernel.kernel_info("moments", 100, 3, 9, device)
    g = info["max_grid"] + 1
    limit = _build.smem_limit(device)
    assert info["max_grid"] == decision_kernel.moments_max_grid(3, 9, limit)
    assert decision_kernel.moments_route(g - 1, 3, 9, limit, route="shared").name == "shared"
    assert decision_kernel.moments_route(g, 3, 9, limit).name == "large"
    with pytest.raises(ValueError, match="at most"):
        decision_kernel.moments_route(g, 3, 9, limit, route="shared")
    args = _decision_args(device, g, 64, 3, 3, basis=BASIS_9)
    before = decision_kernel.decision_update_moments.large_launches
    got = decision_kernel.decision_update_moments(*args)
    assert decision_kernel.decision_update_moments.large_launches == before + 1
    want = decision_kernel.decision_update_moments_plain(*args)
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=1e-4)
    for k in (1, 2):
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-5 * float(want[k].abs().max()))
    v, spot, factors, spot_prev, factors_prev, mean, std, _, _, idx_lo, w_hi, _, a, b, mono = args
    dm = decision_kernel._standardised_design(mono, spot, factors, mean, std)
    xtx, xty = dm.T @ dm, dm.T @ (v.T * 0.9)
    got = decision_kernel.decision_update_fullstep(v, spot, factors, spot_prev, factors_prev, xtx,
                                                   xty, mean, std, idx_lo, w_hi, a, b, mono)
    assert decision_kernel.decision_update_fullstep.large_launches >= 1
    step = decision_kernel.decision_update_moments(
        v, spot, factors, spot_prev, factors_prev, got[3], got[4], got[3], got[4], idx_lo, w_hi,
        interp.interp_coeffs(got[5], idx_lo, w_hi), a, b, mono)
    for k in range(3):
        assert torch.equal(got[k], step[k])


# Sixteen terms on three factors: the first B make a basis of B terms.
TERMS_16 = ("1", "s", "x0", "x1", "x2", "s**2", "x0**2", "x1**2", "x2**2", "s*x0", "s*x1",
            "x0*x1", "s**3", "x1*x2", "x0*x2", "s*x2")


@pytest.mark.parametrize("b", [1, 3, 4, 5, 8, 9, 12, 13, 16])
def test_decision_update_moments_every_padded_basis(device, b):
    """Kernel B is compiled per basis size padded to 4 (4, 8, 12, 16): at
    each, against its plain version, its large route forced at G = 100
    (tiles that split the grid) to the shared route's bits, and each route
    over two launches to the same bits."""
    args = _decision_args(device, 100, 1000, 3, 3, basis=" + ".join(TERMS_16[:b]))
    got = [t.clone() for t in decision_kernel.decision_update_moments(*args)]
    want = decision_kernel.decision_update_moments_plain(*args)
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=1e-4)
    for k in (1, 2):
        torch.testing.assert_close(got[k], want[k], rtol=1e-5,
                                   atol=1e-5 * float(want[k].abs().max()))
    again = decision_kernel.decision_update_moments(*args)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    large = [t.clone() for t in decision_kernel.decision_update_moments(*args, route="large")]
    assert all(torch.equal(x, y) for x, y in zip(got, large))
    again = decision_kernel.decision_update_moments(*args, route="large")
    assert all(torch.equal(x, y) for x, y in zip(large, again))


def _tie_args(device, g, s=1000):
    """Kernel B's arguments at D = 2 with the two decisions' regressed values
    equal to the bit (the same coefficients and immediate value: a zero
    centred gap) and their interpolation rows apart at every grid point."""
    args = list(_decision_args(device, g, s, 2, 3, basis=BASIS_9))
    idx_lo, ci, a, b = (args[k].clone() for k in (9, 11, 12, 13))
    ci[1], a[1], b[1] = ci[0], a[0], b[0]
    idx_lo[:, 1] = (idx_lo[:, 0] + g // 2) % (g - 1)
    args[9], args[11], args[12], args[13] = idx_lo.contiguous(), ci, a, b
    return tuple(args)


@pytest.mark.parametrize("route", ["shared", "large"])
@pytest.mark.parametrize("g", [100, 1000])
def test_exact_tie_keeps_decision_zero(device, g, route):
    """On an exact tie of the regressed values kernels B and E keep decision
    0 (strict >), as their plain versions do: best_act is decision 0's
    actual value to the bit on either route, 0 flips.  E's tie: zero values
    carry zero moments, which solve to zero coefficients."""
    args = _tie_args(device, g)
    v, spot, factors, spot_prev, factors_prev, mean, std, mean_p, std_p, idx_lo, w_hi, _, a, b, \
        mono = args
    lo, w = idx_lo[:, 0].long(), w_hi[:, 0:1]
    act0 = v[lo] * (1 - w) + v[lo + 1] * w + (a[0][:, None] * spot[None, :] + b[0][:, None])
    lo1, w1 = idx_lo[:, 1].long(), w_hi[:, 1:2]
    act1 = v[lo1] * (1 - w1) + v[lo1 + 1] * w1 + (a[0][:, None] * spot[None, :] + b[0][:, None])
    assert float((act1 - act0).abs().gt(1.0).float().mean()) > 0.9  # the tie decides
    got = decision_kernel.decision_update_moments(*args, route=route)
    assert torch.equal(got[0], decision_kernel.decision_update_moments_plain(*args)[0])
    assert torch.equal(got[0], act0)
    dm = decision_kernel._standardised_design(mono, spot, factors, mean, std)
    fargs = (v, spot, factors, spot_prev, factors_prev, dm.T @ dm,
             torch.zeros((len(mono), g), device=device), mean, std, idx_lo, w_hi, a, b, mono)
    prev = dict(mean_prev=mean_p, std_prev=std_p)
    got = decision_kernel.decision_update_fullstep(*fargs, **prev, route=route)
    assert not torch.any(got[5])
    assert torch.equal(got[0], act0)
    assert torch.equal(got[0], decision_kernel.decision_update_fullstep_plain(*fargs, **prev)[0])


def _update_args(device, g, s, d, kind, basis="1 + s + s**2 + s**3", seed=3):
    """Kernel D's arguments on a standardised design [B, S] read from memory,
    with interpolation rows of the given kind: random in [0, G−2] (spans as
    wide as the grid, in no order), "whole-grid" (every grid point reaching
    from row 0 to row G−2), "non-monotone" (rows falling as g rises) or
    "monotone" (a band of rows following g, as interpolated targets give)."""
    v, spot, _, _, _, _, _, _, _, idx_lo, w_hi, ci, a, b, _ = _decision_args(
        device, g, s, d, 0, basis=basis, seed=seed)
    gi = torch.arange(g, device=device)[:, None]
    band = torch.arange(d, device=device)[None, :] * (10 // max(d - 1, 1)) - 5
    if kind == "whole-grid":
        idx_lo[:, 0], idx_lo[:, -1] = 0, g - 2
    elif kind == "non-monotone":
        idx_lo = (g - 2 - gi + band + idx_lo % 5 - 2).clamp(0, g - 2).to(torch.int32)
    elif kind == "monotone":
        idx_lo = (gi + band).clamp(0, g - 2).to(torch.int32)
    gen = torch.Generator(device=device).manual_seed(seed + 5)
    dm_std_t = torch.randn((ci.shape[2], s), generator=gen, device=device)
    return v, dm_std_t, spot, idx_lo.contiguous(), w_hi, ci, a, b


@pytest.mark.parametrize("kind", ["random", "whole-grid", "non-monotone", "monotone"])
@pytest.mark.parametrize("g,s", [(11, 300), (100, 300), (100, 1001), (1000, 300)])
def test_decision_update(device, g, s, kind):
    """Kernel D against its plain version to the bit (no error, no flipped
    argmax) on rows in any order and span, at S a multiple of 4 or not, and
    on blocks of sims that S does not fill."""
    args = _update_args(device, g, s, 5 if g == 11 else 3, kind)
    got = decision_kernel.decision_update(*args)
    want = decision_kernel.decision_update_plain(*args)
    assert torch.equal(got, want)


def test_decision_update_deterministic(device):
    """Two launches of kernel D on the same inputs give the same bits."""
    args = _update_args(device, 100, 5000, 3, "monotone")
    first = decision_kernel.decision_update(*args).clone()
    assert torch.equal(first, decision_kernel.decision_update(*args))


def test_decision_update_grid_beyond_shared_memory_raises(device):
    """Kernel D takes every grid its first design took at D=3, B=4 (2,421
    points on an H100) on its shared route, and beyond that route's limit
    its large route (the records a tile at a time) in place of the refusal
    it once gave: both to the plain version's bits."""
    info = decision_kernel.kernel_info("update", 100, 3, 4, device)
    assert info["max_grid"] >= info["smem_limit"] // 96  # the first design: 96 B a grid point
    assert info["max_grid"] == decision_kernel.update_max_grid(3, 4, _build.smem_limit(device))
    args = _update_args(device, info["max_grid"], 64, 3, "monotone")
    got = decision_kernel.decision_update(*args, route="shared")
    assert torch.equal(got, decision_kernel.decision_update_plain(*args))
    args = _update_args(device, info["max_grid"] + 1, 64, 3, "monotone")
    before = decision_kernel.decision_update.large_launches
    got = decision_kernel.decision_update(*args)
    assert decision_kernel.decision_update.large_launches == before + 1
    assert torch.equal(got, decision_kernel.decision_update_plain(*args))


def _spot_basis(b: int) -> str:
    return " + ".join(["1"] + [f"s**{k}" for k in range(1, b)])


@pytest.mark.parametrize("kind", ["random", "monotone"])
@pytest.mark.parametrize("d", [3, 5])
@pytest.mark.parametrize("b", [4, 9, 20, 36])
def test_decision_update_large_route(device, b, d, kind):
    """Kernel D's large route (tiles of ``TILE_D`` grid points a block) at
    padded sizes 4, 12, 20 and the wide route (36 terms), on grids the tile
    does not divide (250: one partial tile; 1,001:
    three whole tiles and a partial one, not whole groups of 4) and S not a
    whole number of blocks: its plain version's bits, and the shared route's
    wherever that holds the grid."""
    limit = _build.smem_limit(device)
    for g in (250, 1_001):
        args = _update_args(device, g, 1_037, d, kind, basis=_spot_basis(b))
        before = decision_kernel.decision_update.large_launches
        large = decision_kernel.decision_update(*args, route="large").clone()
        assert decision_kernel.decision_update.large_launches == before + 1
        assert torch.equal(large, decision_kernel.decision_update_plain(*args))
        if g <= decision_kernel.update_max_grid(d, b, limit):
            assert torch.equal(large, decision_kernel.decision_update(*args, route="shared"))


@pytest.mark.parametrize("route", ["shared", "large"])
@pytest.mark.parametrize("b", [4, 9, 36])
def test_decision_update_exact_tie_keeps_decision_zero(device, b, route):
    """Kernel D on an exact tie of the regressed values (D = 2, the two
    decisions' coefficients and immediate values equal, their rows apart):
    decision 0 on either route, its actual value to the bit, 0 flips."""
    g = 301
    v, dm_std_t, spot, idx_lo, w_hi, ci, a, b_ = _update_args(device, g, 1_037, 2, "random",
                                                              basis=_spot_basis(b))
    ci[1], a[1], b_[1] = ci[0], a[0], b_[0]
    idx_lo[:, 1] = (idx_lo[:, 0] + g // 2) % (g - 1)
    args = (v, dm_std_t, spot, idx_lo.contiguous(), w_hi, ci, a, b_)
    lo, w = idx_lo[:, 0].long(), w_hi[:, 0:1]
    act0 = v[lo] * (1 - w) + v[lo + 1] * w + (a[0][:, None] * spot[None, :] + b_[0][:, None])
    got = decision_kernel.decision_update(*args, route=route)
    assert torch.equal(got, act0)
    assert torch.equal(got, decision_kernel.decision_update_plain(*args))


@pytest.mark.parametrize("d,b", [(2, 4), (3, 9), (5, 36), (3, 1)])
def test_pack_records(device, d, b):
    """Kernel D's record pack against its plain version, to the bit (the
    centred coefficients one f32 subtraction each)."""
    args = _update_args(device, 1_001, 64, d, "random", basis=_spot_basis(b))
    idx_lo, w_hi, ci, a, b_ = args[3:]
    before = decision_kernel.pack_records.launches
    got = decision_kernel.pack_records(idx_lo, w_hi, ci, a, b_)
    assert decision_kernel.pack_records.launches == before + 1
    want = decision_kernel.pack_records_plain(idx_lo, w_hi, ci, a, b_)
    assert got.shape == (1_001, decision_kernel.record_words(d, b))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_routes_at_1000_grid_points_keep_the_shared_bits(device):
    """At G = 1,000 (D = 3, B = 9) the rule sends kernels B and E to their
    large route, whose outputs are the shared route's bits."""
    limit = _build.smem_limit(device)
    assert decision_kernel.moments_route(1_000, 3, 9, limit).name == "large"
    assert decision_kernel.fullstep_route(1_000, 3, 9, limit).name == "large"
    args = _decision_args(device, 1_000, 1_037, 3, 3, basis=BASIS_9)
    v, spot, factors, spot_prev, factors_prev, mean, std, mean_p, std_p, idx_lo, w_hi, _, a, b, \
        mono = args
    dm = decision_kernel._standardised_design(mono, spot, factors, mean, std)
    fargs = (v, spot, factors, spot_prev, factors_prev, dm.T @ dm, dm.T @ (v.T * 0.9), mean, std,
             idx_lo, w_hi, a, b, mono)
    prev = dict(mean_prev=mean_p, std_prev=std_p)
    for fn, fn_args, kw in ((decision_kernel.decision_update_moments, args, {}),
                            (decision_kernel.decision_update_fullstep, fargs, prev)):
        before = fn.large_launches
        got = [t.clone() for t in fn(*fn_args, **kw)]
        assert fn.large_launches == before + 1
        shared = fn(*fn_args, route="shared", **kw)
        assert all(torch.equal(x, y) for x, y in zip(got, shared))


def test_route_occupancy_copies_match_kernel_info(device):
    """The blocks per SM the route rule counts from shapes (the Python
    copies of each kernel's sizes and register limits) are the launch
    reports' on this card: B's two routes, D's kernel at basis sizes on both
    sides of each step of its register cap and on the wide route."""
    limit = _build.smem_limit(device)
    for g in (32, 100, 112, 113, 400, 1_000):
        assert decision_kernel.kernel_info("moments", g, 3, 9, device)["blocks_per_sm"] == \
            decision_kernel.moments_blocks_per_sm(g, 3, 9, limit)
    assert decision_kernel.kernel_info("moments", 32, 3, 9, device, large=True)[
        "blocks_per_sm"] == decision_kernel.moments_blocks_per_sm(32, 3, 9, limit)
    for b in (1, 4, 5, 8, 9, 16, 17, 20, 24, 28, 29, 32, 36):
        for g in (100, 400, decision_kernel.TILE_D):
            info = decision_kernel.kernel_info("update", g, 3, b, device)
            assert info["blocks_per_sm"] == decision_kernel.update_blocks_per_sm(
                g, 3, b, limit), (b, g)


BASIS_17 = BASIS_9 + " + s**3 + s**4 + s*x0 + s*x1 + s*x2 + x0*x1 + x0*x2 + x1*x2"


@pytest.mark.parametrize("b", [17, 20, 36])
@pytest.mark.parametrize("kind", ["random", "monotone"])
def test_decision_update_beyond_16_terms(device, b, kind):
    """Kernel D at B = 17 and 20 (compiled per basis size) and 36 (the wide
    route, past the last compiled size, 32) against its plain version: the
    same bits."""
    basis = " + ".join(["1"] + [f"s**{k}" for k in range(1, b)])
    args = _update_args(device, 100, 1001, 3, kind, basis=basis)
    assert args[1].shape[0] == b
    before = decision_kernel.decision_update.launches
    got = decision_kernel.decision_update(*args)
    assert decision_kernel.decision_update.launches == before + 1
    assert torch.equal(got, decision_kernel.decision_update_plain(*args))
    info = decision_kernel.kernel_info("update", 100, 3, b, device)
    assert info["max_grid"] >= 100 and info["blocks_per_sm"] >= 1


@pytest.mark.parametrize("wrapper,case", [
    ("moments", "17-terms"), ("moments", "9-factors"), ("moments", "65-terms"),
    ("fullstep", "17-terms"), ("fullstep", "9-factors"), ("fullstep", "65-terms"),
    ("sweep", "17-terms"), ("sweep", "9-factors"), ("sweep", "65-terms")])
def test_caps_raise_value_error(device, wrapper, case):
    """Past 16 basis functions or 8 factors each wrapper of a kernel that
    builds the monomial design on the card (B, E, C's monomial mode) takes
    its wide route: one launch, no error, counted in ``wide_launches``.
    Past the wide routes' 64 terms each raises ValueError before it
    launches; the engine never routes such a basis to them (kernel D and C's
    design mode take any basis)."""
    basis, f = {"17-terms": (BASIS_17, 3), "9-factors": ("1 + s + x8", 9),
                "65-terms": (_spot_basis(65), 3)}[case]
    g, s, d = 11, 64, 3
    v, spot, factors, spot_prev, factors_prev, mean, std, mean_p, std_p, idx_lo, w_hi, ci, a, b, \
        mono = _decision_args(device, g, s, d, f, basis=basis)
    before = [fn.launches for fn in (decision_kernel.decision_update_moments,
                                     decision_kernel.decision_update,
                                     decision_kernel.decision_update_fullstep,
                                     forward_kernel.forward_sweep)]
    bdim = len(mono)
    calls = {
        "moments": lambda: decision_kernel.decision_update_moments(
            v, spot, factors, spot_prev, factors_prev, mean, std, mean_p, std_p, idx_lo, w_hi,
            ci, a, b, mono),
        "fullstep": lambda: decision_kernel.decision_update_fullstep(
            v, spot, factors, spot_prev, factors_prev, torch.eye(bdim, device=device),
            torch.ones((bdim, g), device=device), mean, std, idx_lo, w_hi, a, b, mono),
        "sweep": lambda: forward_kernel.forward_sweep(*_sweep_args(device, 2, s, g, f, basis=basis)),
    }
    counter = {"moments": decision_kernel.decision_update_moments,
               "fullstep": decision_kernel.decision_update_fullstep,
               "sweep": forward_kernel.forward_sweep}[wrapper]
    if case == "65-terms":
        with pytest.raises(ValueError, match="at most 64"):
            calls[wrapper]()
    else:
        wide = counter.wide_launches
        calls[wrapper]()
        assert counter.wide_launches == wide + 1
        before[{"moments": 0, "fullstep": 2, "sweep": 3}[wrapper]] += 1
    assert before == [fn.launches for fn in (decision_kernel.decision_update_moments,
                                             decision_kernel.decision_update,
                                             decision_kernel.decision_update_fullstep,
                                             forward_kernel.forward_sweep)]


def _basis_text(b: int, f: int) -> str:
    """The first B monomials of total degree up to 4 in the spot and F
    factors, by degree: 1, s, the factors, then products and powers."""
    import itertools

    names = ["s", *(f"x{i}" for i in range(f))]
    terms = ["1"]
    for degree in (1, 2, 3, 4):
        for combo in itertools.combinations_with_replacement(range(len(names)), degree):
            terms.append("*".join(names[i] + (f"**{combo.count(i)}" if combo.count(i) > 1 else "")
                                  for i in sorted(set(combo))))
    return " + ".join(terms[:b])


def _monomials(b: int, f: int):
    """``_basis_text``'s monomials."""
    monomials = tuple(parse_basis_functions(_basis_text(b, f)))
    assert len(monomials) == b
    return monomials


def _wide_fullstep_args(device, g, s, d, b, f, seed=3):
    """Kernel E's arguments at B terms on F factors: random paths, values and
    step tables, the step's design standardised by its exact stats (the
    engine's), its moments against 0.9·v, and step t−1's exact stats."""
    from storage_tpu_torch.basis import design_matrix
    from storage_tpu_torch.ops.regression import column_stats

    gen = torch.Generator(device=device).manual_seed(seed)
    monomials = _monomials(b, f)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=device)  # noqa: E731
    v = 100.0 + 30.0 * rnd(g, s)
    spot, spot_prev = 30.0 + 5.0 * rnd(s), 30.0 + 5.0 * rnd(s)
    factors, factors_prev = rnd(f, s), rnd(f, s)
    stats = []
    for sp, fac in ((spot, factors), (spot_prev, factors_prev)):
        stats.append(column_stats(design_matrix(monomials, sp, fac)))
    (mean, std), (mean_p, std_p) = stats
    dm = decision_kernel._standardised_design(monomials, spot, factors, mean, std)
    idx_lo = torch.randint(0, g - 1, (g, d), generator=gen, device=device, dtype=torch.int32)
    fargs = (v, spot, factors, spot_prev, factors_prev, dm.T @ dm, dm.T @ (0.9 * v.T), mean,
             std, idx_lo, torch.rand((g, d), generator=gen, device=device), 2.0 * rnd(d, g),
             20.0 * rnd(d, g), monomials)
    return fargs, dict(mean_prev=mean_p, std_prev=std_p)


@pytest.mark.parametrize("g", [100, 1000])
@pytest.mark.parametrize("b,f", [(17, 3), (17, 9), (17, 12), (20, 3), (20, 9), (20, 12),
                                 (32, 3), (32, 9), (32, 12), (64, 3)])
def test_decision_update_fullstep_wide(device, b, f, g):
    """Kernel E's wide route (past 16 terms or 8 factors, up to 64 terms)
    against its plain version: the regression to 1e-4 relative (as
    ``test_decision_update_fullstep``), the step to kernel B's plain version
    on E's own regression (per-path values to f32 rounding, the moments in
    another order), both grid routes of each wide body that takes the shape
    forced (the shared one where G fits it) to the same bits: the register
    row up to 32 padded terms and the shared row; the rule's body and route
    counted."""
    fe = decision_kernel.decision_update_fullstep
    fargs, prev = _wide_fullstep_args(device, g, 1000, 3, b, f)
    v, spot, factors, spot_prev, factors_prev, _, _, _, _, idx_lo, w_hi, a, b_, mono = fargs
    limit = _build.smem_limit(device)
    plan = decision_kernel.fullstep_route(g, 3, b, limit, num_factors=f)
    assert plan.body == ("wide" if b <= 32 else "wide-smem")
    before = (fe.launches, fe.wide_launches, fe.wide_smem_launches, fe.large_launches)
    got = [t.clone() for t in fe(*fargs, **prev)]
    assert (fe.launches, fe.wide_launches, fe.wide_smem_launches, fe.large_launches) == (
        before[0] + 1, before[1] + 1, before[2] + (plan.body == "wide-smem"),
        before[3] + (plan.name == "large"))
    for body in ("wide", "wide-smem") if b <= 32 else ("wide-smem",):
        fits = min(decision_kernel.wide_max_grid(3, b, f, limit, body),
                   decision_kernel.solve_max_grid(b, limit))
        for route in ("shared", "large") if g <= fits else ("large",):
            forced = fe(*fargs, **prev, route=f"{body}-{route}")
            assert all(torch.equal(x, y) for x, y in zip(got, forced)), (body, route)
    want = decision_kernel.decision_update_fullstep_plain(*fargs, **prev)
    for k in (3, 4, 5):  # mean, std, coeffs
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-4 * float(want[k].abs().max()))
    ci = interp.interp_coeffs(got[5], idx_lo, w_hi)
    step = decision_kernel.decision_update_moments_plain(
        v, spot, factors, spot_prev, factors_prev, got[3], got[4], prev["mean_prev"],
        prev["std_prev"], idx_lo, w_hi, ci, a, b_, mono)
    torch.testing.assert_close(got[0], step[0], rtol=1e-6, atol=1e-4)
    for k in (1, 2):
        torch.testing.assert_close(got[k], step[k], rtol=1e-5,
                                   atol=1e-5 * float(step[k].abs().max()))


@pytest.mark.parametrize("g", [100, 1000])
def test_fullstep_forced_wide_keeps_the_register_bits(device, g):
    """At the headline's B = 9, F = 3 kernel E forced onto each wide body
    (the register row, ``route="wide-shared"``, ``"wide-large"``, and the
    shared row, ``"wide-smem-shared"``, ``"wide-smem-large"``) gives its
    register route's bits on each grid route: the same entries, gaps,
    decisions and sums in the same order."""
    fe = decision_kernel.decision_update_fullstep
    args = _decision_args(device, g, 1_037, 3, 3, basis=BASIS_9)
    v, spot, factors, spot_prev, factors_prev, mean, std, mean_p, std_p, idx_lo, w_hi, _, a, b, \
        mono = args
    dm = decision_kernel._standardised_design(mono, spot, factors, mean, std)
    fargs = (v, spot, factors, spot_prev, factors_prev, dm.T @ dm, dm.T @ (v.T * 0.9), mean, std,
             idx_lo, w_hi, a, b, mono)
    prev = dict(mean_prev=mean_p, std_prev=std_p)
    for route in ("shared", "large"):
        register = [t.clone() for t in fe(*fargs, **prev, route=route)]
        for body in ("wide", "wide-smem"):
            wide, smem = fe.wide_launches, fe.wide_smem_launches
            forced = fe(*fargs, **prev, route=f"{body}-{route}")
            assert (fe.wide_launches, fe.wide_smem_launches) == (
                wide + 1, smem + (body == "wide-smem"))
            assert all(torch.equal(x, y) for x, y in zip(register, forced)), (body, route)


def test_wide_route_sizing_matches_kernel_info(device):
    """Each wide body's Python sizing (``wide_max_grid``,
    ``wide_blocks_per_sm``: its shared words and its register cap) is its
    launch report's on this card, on both sides of the rule's crossing and
    of each register cap's padded sizes."""
    limit = _build.smem_limit(device)
    for b, f in ((17, 3), (20, 3), (24, 3), (25, 3), (13, 10), (16, 9), (32, 12), (64, 3)):
        for body in ("wide", "wide-smem") if b <= 32 else ("wide-smem",):
            info = decision_kernel.kernel_info("wide", 100, 3, b, device, num_factors=f,
                                               body=body)
            assert info["max_grid"] == decision_kernel.wide_max_grid(3, b, f, limit, body), (
                b, f, body)
            last = max(g for g in range(2, 2_000) if decision_kernel.wide_route(
                g, 3, b, f, limit, body=body).name == "shared")
            for g in (decision_kernel.TILE_B, 100, last, last + 1, 400):
                info = decision_kernel.kernel_info("wide", g, 3, b, device, num_factors=f,
                                                   body=body)
                assert info["blocks_per_sm"] == decision_kernel.wide_blocks_per_sm(
                    g, 3, b, f, limit, body), (b, f, g, body)


@pytest.mark.parametrize("g", [11, 400, 1000])
@pytest.mark.parametrize("prev", [False, True], ids=["u-coordinates", "given-stats"])
def test_decision_update_fullstep(device, prev, g):
    """Kernel E from moments of a random design against random values, also
    beyond the 338 grid points of kernel B's first design."""
    args = _decision_args(device, g, 300, 5 if g == 11 else 3, 3, basis=BASIS if g == 11 else BASIS_9)
    v, spot, factors, spot_prev, factors_prev, mean, std, mean_p, std_p, idx_lo, w_hi, _, a, b, mono = args
    dm = (decision_kernel._standardised_design(mono, spot, factors, mean, std))
    xtx, xty = dm.T @ dm, dm.T @ (v.T * 0.9)
    kwargs = dict(mean_prev=mean_p, std_prev=std_p) if prev else {}
    fargs = (v, spot, factors, spot_prev, factors_prev, xtx, xty, mean, std, idx_lo, w_hi, a, b, mono)
    got = decision_kernel.decision_update_fullstep(*fargs, **kwargs)
    want = decision_kernel.decision_update_fullstep_plain(*fargs, **kwargs)
    for k in (3, 4, 5):  # mean, std, coeffs
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-4 * float(want[k].abs().max()))
    # The step itself is kernel B on E's own regression: to the bit.
    ci = interp.interp_coeffs(got[5], idx_lo, w_hi)
    step = decision_kernel.decision_update_moments(
        v, spot, factors, spot_prev, factors_prev, got[3], got[4],
        mean_p if prev else got[3], std_p if prev else got[4], idx_lo, w_hi, ci, a, b, mono)
    for k in range(3):
        assert torch.equal(got[k], step[k])


@pytest.mark.parametrize("is_step,f", [(False, 3), (True, 3), (False, 0)],
                         ids=["linear", "step", "spot-only"])
def test_forward_step(device, is_step, f):
    gen = torch.Generator(device=device).manual_seed(4)
    s, g = 300, 13
    monomials = tuple(parse_basis_functions(BASIS if f else "1 + s + s**2"))
    b = len(monomials)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=device)  # noqa: E731
    grid_next = torch.linspace(0.0, 1100.0, g, device=device)
    scalars = {k: torch.tensor(v, device=device) for k, v in dict(
        df_settle=0.97, df_flow=0.95, inj_cost=1.2, wdr_cost=0.9, inj_pcnt=0.015, wdr_pcnt=0.01,
        loss_pcnt=0.02, inv_cost_rate=0.03, next_min=0.0, next_max=1100.0).items()}
    params = forward_kernel.pack_params(scalars, grid_next)
    args = (params, 0.3 * rnd(b), 1.0 + 0.2 * rnd(b).abs(),
            torch.tensor([0.0, 500.0, 1000.0], device=device),
            torch.tensor([-30.0, -80.0, -140.0], device=device),
            torch.tensor([150.0, 90.0, 40.0], device=device), 30.0 + 5.0 * rnd(s), rnd(f, s),
            1000.0 * torch.rand(s, generator=gen, device=device), 100.0 * rnd(s), 20.0 * rnd(b, g),
            monomials, 1, is_step)
    imm = torch.empty(s, device=device)
    want_imm = torch.empty(s, device=device)
    got = forward_kernel.forward_step(*args, imm_out=imm)
    want = forward_kernel.forward_step_plain(*args, imm_out=want_imm)
    torch.testing.assert_close(imm, want_imm, rtol=1e-6, atol=1e-3)
    for k in range(4):
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-3)
    for k in (4, 5):
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-5 * float(want[k].abs().max()))


def _sweep_args(device, n, s, g, f, is_step=False, e=1, seed=6, basis=None):
    """``forward_sweep``'s arguments: N steps of tables that change from step
    to step over random paths (``factors`` [N, 0, S] where F = 0)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    monomials = tuple(parse_basis_functions(basis or (BASIS_9 if f else "1 + s + s**2")))
    b = len(monomials)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=device)  # noqa: E731
    t = torch.arange(n, dtype=torch.float32, device=device)
    next_min, next_max = 20.0 * t, 1100.0 - 30.0 * t
    scalars = dict(df_settle=0.97 - 0.01 * t, df_flow=0.95 - 0.01 * t, inj_cost=1.2 + 0.1 * t,
                   wdr_cost=0.9 + 0.0 * t, inj_pcnt=0.015 + 0.0 * t, wdr_pcnt=0.01 + 0.0 * t,
                   loss_pcnt=0.02 + 0.0 * t, inv_cost_rate=0.03 + 0.0 * t, next_min=next_min,
                   next_max=next_max)
    frac = torch.linspace(0.0, 1.0, g, device=device)
    params = forward_kernel.pack_params(
        scalars, next_min[:, None] + (next_max - next_min)[:, None] * frac[None, :])
    shift = 10.0 * t[:, None]
    return (params, 0.3 * rnd(n, b), 1.0 + 0.2 * rnd(n, b).abs(),
            (torch.tensor([0.0, 500.0, 1000.0], device=device) + shift).contiguous(),
            (torch.tensor([-30.0, -80.0, -140.0], device=device) - shift).contiguous(),
            (torch.tensor([150.0, 90.0, 40.0], device=device) + shift).contiguous(),
            30.0 + 5.0 * rnd(n, s), rnd(n, f, s), 1000.0 * torch.rand(s, generator=gen, device=device),
            100.0 * rnd(s), 20.0 * rnd(n, b, g), monomials, e, is_step)


@pytest.mark.parametrize("is_step,f,g,n", [(False, 3, 13, 9), (True, 3, 13, 9), (False, 0, 13, 9),
                                           (False, 3, 1000, 3)],
                         ids=["linear", "step", "spot-only", "G=1000"])
def test_forward_sweep(device, is_step, f, g, n):
    """The sweep against its plain version over N steps, with the per-sim
    panels, and against N launches of the one-step kernel: the same bits."""
    s = 300
    args = _sweep_args(device, n, s, g, f, is_step)
    panels = [torch.empty((n, s), device=device) for _ in range(4)]
    want_panels = [torch.empty((n, s), device=device) for _ in range(4)]
    got = forward_kernel.forward_sweep(*args, panels=panels)
    want = forward_kernel.forward_sweep_plain(*args, panels=want_panels)
    for k in range(2):
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-3)
    for row, want_row in zip(panels, want_panels):
        torch.testing.assert_close(row, want_row, rtol=1e-6, atol=1e-3)
    for k in (2, 3):
        torch.testing.assert_close(got[k], want[k], rtol=1e-5,
                                   atol=1e-5 * float(want[k].abs().max()))
    bare = forward_kernel.forward_sweep(*args)
    for x, y in zip(got, bare):
        assert torch.equal(x, y)
    params, mean, std, r_inv, r_min, r_max, spot, factors, inv, pv, coeffs, mono, e, step = args
    for t in range(n):
        imm = torch.empty(s, device=device)
        inv, pv, dec, cons, sums, xbar = forward_kernel.forward_step(
            params[t], mean[t], std[t], r_inv[t], r_min[t], r_max[t], spot[t], factors[t], inv,
            pv, coeffs[t], mono, e, step, imm_out=imm)
        for row, x in zip(panels, (inv, dec, cons, imm)):
            assert torch.equal(row[t], x)
        assert torch.equal(got[2][t], sums) and torch.equal(got[3][t], xbar)
    assert torch.equal(got[0], inv) and torch.equal(got[1], pv)


def test_forward_sweep_grid_beyond_shared_memory_raises(device):
    """Where two steps' tables exceed the card's shared memory, the sweep
    takes its large route (the coefficients read from device memory) in
    place of the refusal it once gave: its plain version's paths."""
    info = forward_kernel.kernel_info(100, 9, 3, 3, 1, device)
    g = info["max_grid"] + 1
    assert info["max_grid"] == forward_kernel.sweep_max_grid(9, 3, 3, 1,
                                                             _build.smem_limit(device))
    args = _sweep_args(device, 2, 64, g, 3)
    before = forward_kernel.forward_sweep.large_launches
    got = forward_kernel.forward_sweep(*args)
    assert forward_kernel.forward_sweep.large_launches == before + 1
    want = forward_kernel.forward_sweep_plain(*args)
    for k in range(2):
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-3)


def _sweep_mode_call(args, mode, route=None):
    """Kernel C in ``mode`` ("monomial", "design", "general") on ``args``
    (``_sweep_args``), with the per-sim panels, and its plain version:
    (got, want, got panels, want panels)."""
    n, s = args[6].shape
    g = args[10].shape[2]
    grid = _bunched_rows(args[0], g) if mode == "general" else None
    panels = [torch.empty((n, s), device=args[6].device) for _ in range(4)]
    want_panels = [torch.empty_like(p) for p in panels]
    if mode == "design":
        raw = torch.stack(tbasis.design_columns(args[11], args[6], args[7]), dim=1)
        dargs = (*args[:7], raw, *args[8:11], *args[12:])
        got = forward_kernel.forward_sweep_design(*dargs, panels=panels, route=route)
        want = forward_kernel.forward_sweep_plain(*args, panels=want_panels, design=raw)
    else:
        got = forward_kernel.forward_sweep(*args, panels=panels, grid=grid, route=route)
        want = forward_kernel.forward_sweep_plain(*args, panels=want_panels, grid=grid)
    return got, want, panels, want_panels


@pytest.mark.parametrize("mode", ["monomial", "design", "general"])
def test_forward_sweep_large_route(device, mode):
    """Kernel C's large route in each mode at G = 4,096, past every mode's
    shared route, against its plain version (per-sim values to f32 rounding),
    and forced at G = 100 to the shared route's bits."""
    args = _sweep_args(device, 3, 300, 4_096, 3)
    counter = forward_kernel.forward_sweep_design if mode == "design" else \
        forward_kernel.forward_sweep
    before = counter.large_launches
    got, want, panels, want_panels = _sweep_mode_call(args, mode)
    assert counter.large_launches == before + 1
    for k in range(2):
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-3)
    for row, want_row in zip(panels, want_panels):
        torch.testing.assert_close(row, want_row, rtol=1e-6, atol=1e-3)
    for k in (2, 3):
        torch.testing.assert_close(got[k], want[k], rtol=1e-5,
                                   atol=1e-5 * float(want[k].abs().max()))
    args = _sweep_args(device, 9, 300, 100, 3)
    shared = _sweep_mode_call(args, mode, route="shared")
    large = _sweep_mode_call(args, mode, route="large")
    for x, y in zip((*shared[0], *shared[2]), (*large[0], *large[2])):
        assert torch.equal(x, y)


@pytest.mark.parametrize("g", [100, 1_000, 4_096])
def test_decision_large_routes(device, g):
    """Kernels B, D (B = 4 and 9) and E on their large routes: at G = 4,096
    against their plain versions, forced at smaller G to their shared
    route's bits (B and E at G = 100 and 1,000; D at 1,000, where its tiles
    split the grid)."""
    args = _decision_args(device, g, 300, 3, 3, basis=BASIS_9)
    v, spot, factors, spot_prev, factors_prev, mean, std, mean_p, std_p, idx_lo, w_hi, _, a, b, \
        mono = args
    dm = decision_kernel._standardised_design(mono, spot, factors, mean, std)
    fargs = (v, spot, factors, spot_prev, factors_prev, dm.T @ dm, dm.T @ (v.T * 0.9), mean, std,
             idx_lo, w_hi, a, b, mono)
    prev = dict(mean_prev=mean_p, std_prev=std_p)
    kinds = {"B": (decision_kernel.decision_update_moments, args, {}),
             "E": (decision_kernel.decision_update_fullstep, fargs, prev)}
    for basis in ("1 + s + s**2 + s**3", BASIS_9):
        kinds[f"D{basis}"] = (decision_kernel.decision_update,
                              _update_args(device, g, 300, 3, "random", basis=basis), {})
    for name, (fn, fn_args, kw) in kinds.items():
        if g == 4_096:
            got = fn(*fn_args, **kw)
            if name == "B":
                want = decision_kernel.decision_update_moments_plain(*fn_args)
                torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=1e-4)
            elif name == "E":
                want = decision_kernel.decision_update_fullstep_plain(*fn_args, **kw)
                for k in (3, 4, 5):
                    torch.testing.assert_close(got[k], want[k], rtol=1e-4,
                                               atol=1e-4 * float(want[k].abs().max()))
            else:
                assert torch.equal(got, decision_kernel.decision_update_plain(*fn_args))
        elif not (name.startswith("D") and g == 100):  # one of D's tiles holds G = 100
            shared = fn(*fn_args, route="shared", **kw)
            shared = [t.clone() for t in shared] if isinstance(shared, tuple) else [shared.clone()]
            large = fn(*fn_args, route="large", **kw)
            large = list(large) if isinstance(large, tuple) else [large]
            for x, y in zip(shared, large):
                assert torch.equal(x, y), name


def _bunched_rows(params, g):
    """Each step's next grid row bunched towards its lower bound, the last
    three points repeated (a custom grid padded to one width): [N, G]."""
    lo = params[:, forward_kernel._P_GRID_LO]
    hi = params[:, forward_kernel._P_GRID_HI]
    u = torch.linspace(0.0, 1.0, g, device=params.device) ** 1.3
    rows = lo[:, None] + (hi - lo)[:, None] * u
    rows[:, g - 3:] = rows[:, g - 4:g - 3]
    return rows.contiguous()


@pytest.mark.parametrize("design,g", [(False, 13), (True, 13), (False, 1000)],
                         ids=["monomial", "design", "G=1000"])
def test_forward_sweep_general_grid(device, design, g):
    """Kernel C's general-grid mode (custom rows, zero-span padding) against
    its plain version, with the per-sim panels, in both modes: the plain
    version's arithmetic, so per-sim values to f32 rounding."""
    s, n = 300, 9 if g == 13 else 3
    args = _sweep_args(device, n, s, g, 3)
    grid = _bunched_rows(args[0], g)
    panels = [torch.empty((n, s), device=device) for _ in range(4)]
    want_panels = [torch.empty((n, s), device=device) for _ in range(4)]
    if design:
        raw = torch.stack(tbasis.design_columns(args[11], args[6], args[7]), dim=1)
        dargs = (*args[:7], raw, *args[8:11], *args[12:])
        got = forward_kernel.forward_sweep_design(*dargs, panels=panels, grid=grid)
        want = forward_kernel.forward_sweep_plain(*args, panels=want_panels, design=raw, grid=grid)
    else:
        got = forward_kernel.forward_sweep(*args, panels=panels, grid=grid)
        want = forward_kernel.forward_sweep_plain(*args, panels=want_panels, grid=grid)
    for k in range(2):
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-3)
    for row, want_row in zip(panels, want_panels):
        torch.testing.assert_close(row, want_row, rtol=1e-6, atol=1e-3)
    for k in (2, 3):
        torch.testing.assert_close(got[k], want[k], rtol=1e-5,
                                   atol=1e-5 * float(want[k].abs().max()))
    # Another valuation than the evenly spaced placement on the same tables.
    uniform = forward_kernel.forward_sweep(*args)
    assert not torch.equal(uniform[1], got[1])


def _general_rows(params, g, kind):
    """Next grid rows [N, G] of one kind over each step's band: "padded" (a
    quarter of the row repeats of its last node, one bucket of hundreds at
    G = 1,000), "custom" (sorted random nodes, every fifth one repeated),
    "bunched" (nodes bunched toward the lower bound) and "degenerate" (every
    node the band's lower bound): non-decreasing rows, as a valuation's
    are."""
    lo = params[:, forward_kernel._P_GRID_LO][:, None]
    hi = params[:, forward_kernel._P_GRID_HI][:, None]
    u = torch.linspace(0.0, 1.0, g, device=params.device) ** 1.3
    if kind == "padded":
        real = g - g // 4
        u = torch.cat([torch.linspace(0.0, 1.0, real, device=params.device),
                       torch.ones(g - real, device=params.device)])
    elif kind == "custom":
        gen = torch.Generator(device=params.device).manual_seed(8)
        u = torch.sort(torch.rand(g, generator=gen, device=params.device)).values
        u[0], u[-1] = 0.0, 1.0
        u[2:g - 1:5] = u[1:g - 1:5][:u[2:g - 1:5].shape[0]]
    rows = lo + (hi - lo) * u[None, :]
    if kind == "degenerate":
        rows = lo.expand(-1, g)
    return rows.contiguous()


@pytest.mark.parametrize("kind,g", [("padded", 1_000), ("custom", 100), ("bunched", 100),
                                    ("degenerate", 13), ("custom", 2), ("custom", 3),
                                    ("custom", 4_096), ("non-monotone", 100)])
def test_general_tail_kernel_gives_its_plain_bits(device, kind, g):
    """The index kernel (``general_tail``: one block a row) writes its plain
    version's words, bit for bit, alone and into a packed table's columns.
    On rows that are not non-decreasing (a descending row, a row with one
    step back: no valuation builds them, and their counts are not defined)
    it keeps the row and its scale and every count within [0, G − 2], so
    that a search reads inside the row; the non-decreasing rows beside them
    keep their plain bits."""
    args = _sweep_args(device, 5, 8, g, 3)
    grid = _general_rows(args[0], g, "custom" if kind == "non-monotone" else kind)
    bad = 0
    if kind == "non-monotone":
        grid[0] = grid[0].flip(0)
        grid[1, 7] = grid[1, 6] - 1.0
        bad = 2
    before = forward_kernel.general_tail.launches
    got = forward_kernel.general_tail(grid)
    assert forward_kernel.general_tail.launches == before + 1
    want = forward_kernel.general_tail_plain(grid)
    assert torch.equal(got[bad:].view(torch.int32), want[bad:].view(torch.int32))
    assert torch.equal(got[:, :g + 1].view(torch.int32), want[:, :g + 1].view(torch.int32))
    counts = got[:, g + 1:].contiguous().view(torch.int32)
    assert int(counts.min()) >= 0 and int(counts.max()) <= g - 2
    table = torch.zeros((5, got.shape[1] + 7), device=device)
    forward_kernel.general_tail(grid, out=table[:, 3:3 + got.shape[1]])
    assert torch.equal(table[:, 3:3 + got.shape[1]].view(torch.int32), got.view(torch.int32))
    assert not bool(table[:, :3].any()) and not bool(table[:, 3 + got.shape[1]:].any())


@pytest.mark.parametrize("route", ["shared", "large"])
@pytest.mark.parametrize("kind,g", [("padded", 1_000), ("custom", 100), ("bunched", 100),
                                    ("degenerate", 13), ("custom", 2), ("custom", 3)])
def test_forward_sweep_bucket_index_on_every_row_kind(device, kind, g, route):
    """Kernel C's general-grid mode, whose lower node comes from the bucket
    index (``forward_kernel.general_tail``), on rows of every kind and on
    both routes: its plain version's bits (the same node count and weight as
    ``interp.interp_weights_general``, the rest the same arithmetic), in the
    monomial and the design mode."""
    s, n = 300, 5
    args = _sweep_args(device, n, s, g, 3)
    grid = _general_rows(args[0], g, kind)
    raw = torch.stack(tbasis.design_columns(args[11], args[6], args[7]), dim=1)
    dargs = (*args[:7], raw, *args[8:11], *args[12:])
    for design in (False, True):
        panels = [torch.empty((n, s), device=device) for _ in range(4)]
        want_panels = [torch.empty((n, s), device=device) for _ in range(4)]
        if design:
            got = forward_kernel.forward_sweep_design(*dargs, panels=panels, grid=grid,
                                                      route=route)
            want = forward_kernel.forward_sweep_plain(*args, panels=want_panels, design=raw,
                                                      grid=grid)
        else:
            got = forward_kernel.forward_sweep(*args, panels=panels, grid=grid, route=route)
            want = forward_kernel.forward_sweep_plain(*args, panels=want_panels, grid=grid)
        for x, y in zip((*got[:2], *panels), (*want[:2], *want_panels)):
            assert torch.equal(x, y), (kind, g, route, design)
        for k in (2, 3):
            torch.testing.assert_close(got[k], want[k], rtol=1e-5,
                                       atol=1e-5 * float(want[k].abs().max()))


@pytest.mark.parametrize("b", [1, 2, 3, 4, 5, 6, 7, 9, 16, 20])
def test_forward_sweep_large_route_coefficients_in_16_byte_words(device, b):
    """The large route reads each coefficient row of [N, G, Bp] (B padded to
    whole 16-byte words: ``pack_tables(..., large=True)``) in ceil(B / 4)
    loads, at every remainder of B by 4 and on the wide route past 16
    terms: the packed rows are [N, G, B]'s (the layout before the padding)
    with zeros after, and the sweep gives the shared route's bits on the
    same tables and its plain version's per-sim values."""
    s, n, g = 300, 4, 100
    basis = " + ".join(["1", "s", "x0", "x1", "x2", "s**2", "x0**2", "x1**2", "x2**2", "s*x0",
                        "s*x1", "s*x2", "x0*x1", "x0*x2", "x1*x2", "s**3", "x0**3", "x1**3",
                        "x2**3", "s**4"][:b])
    args = _sweep_args(device, n, s, g, 3, basis=basis)
    table, coef, tails = forward_kernel.pack_tables(*args[:6], args[10], large=True)
    bp = forward_kernel.padded_basis(b)
    assert coef.shape == (n, g, bp) and coef.data_ptr() % 16 == 0 and tails is None
    assert torch.equal(coef[..., :b], args[10].transpose(1, 2).contiguous())
    assert not bool(coef[..., b:].any())
    raw = torch.stack(tbasis.design_columns(args[11], args[6], args[7]), dim=1)
    dargs = (*args[:7], raw, *args[8:11], *args[12:])
    outs = {}
    for route in ("shared", "large"):
        panels = [torch.empty((n, s), device=device) for _ in range(4)]
        outs[route] = (*forward_kernel.forward_sweep_design(*dargs, panels=panels, route=route),
                       *panels)
    for x, y in zip(outs["shared"], outs["large"]):
        assert torch.equal(x, y), b
    want_panels = [torch.empty((n, s), device=device) for _ in range(4)]
    want = forward_kernel.forward_sweep_plain(*args, panels=want_panels, design=raw)
    for x, y in zip((*outs["large"][:2], *outs["large"][4:]), (*want[:2], *want_panels)):
        assert torch.equal(x, y), b


BASIS_20 = ("1 + s + x0 + x1 + x2 + s**2 + x0**2 + x1**2 + x2**2 + s*x0 + s*x1 + s*x2 + x0*x1 "
            "+ x0*x2 + x1*x2 + s**3 + x0**3 + x1**3 + x2**3 + s**4")


@pytest.mark.parametrize("general", [False, True], ids=["uniform", "general"])
@pytest.mark.parametrize("g", [13, 100])
def test_forward_sweep_design_beyond_16_terms(device, general, g):
    """Kernel C's design mode at B = 20 (its wide route) on evenly spaced and
    on custom rows against its plain version, with the per-sim panels: the
    plain version's arithmetic, so per-sim values to f32 rounding; and over
    two launches the same bits."""
    s, n = 300, 9
    args = _sweep_args(device, n, s, g, 3, basis=BASIS_20)
    grid = _bunched_rows(args[0], g) if general else None
    raw = torch.stack(tbasis.design_columns(args[11], args[6], args[7]), dim=1)
    assert raw.shape == (n, 20, s)
    dargs = (*args[:7], raw, *args[8:11], *args[12:])
    panels = [torch.empty((n, s), device=device) for _ in range(4)]
    want_panels = [torch.empty((n, s), device=device) for _ in range(4)]
    before = forward_kernel.forward_sweep_design.launches
    got = forward_kernel.forward_sweep_design(*dargs, panels=panels, grid=grid)
    assert forward_kernel.forward_sweep_design.launches == before + 1
    want = forward_kernel.forward_sweep_plain(*args, panels=want_panels, design=raw, grid=grid)
    for k in range(2):
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-3)
    for row, want_row in zip(panels, want_panels):
        torch.testing.assert_close(row, want_row, rtol=1e-6, atol=1e-3)
    for k in (2, 3):
        torch.testing.assert_close(got[k], want[k], rtol=1e-5,
                                   atol=1e-5 * float(want[k].abs().max()))
    again = forward_kernel.forward_sweep_design(*dargs, grid=grid)
    for x, y in zip(got, again):
        assert torch.equal(x, y)
    info = forward_kernel.kernel_info(g, 20, 3, 0, 1, device, design=True, general=general)
    assert info["blocks_per_sm"] >= 1 and info["max_grid"] >= g


WIDE_SHAPES = [(17, 3), (20, 3), (13, 10), (16, 9), (17, 8), (32, 12), (33, 3), (64, 3)]


@pytest.mark.parametrize("g", [100, 1000])
@pytest.mark.parametrize("b,f", WIDE_SHAPES)
def test_decision_update_moments_wide(device, b, f, g):
    """Kernel B past 16 terms or 8 factors (its wide body, kernel E's after
    the solve) against its plain version: per-path values to f32 rounding,
    the moments in another order; the rule's body and grid route counted;
    each grid route of each wide body that takes the shape forced (the
    shared one where G fits it) to the same bits."""
    fm = decision_kernel.decision_update_moments
    fargs, prev = _wide_fullstep_args(device, g, 1000, 3, b, f)
    v, spot, factors, spot_prev, factors_prev, _, _, mean, std, idx_lo, w_hi, a, b_, mono = fargs
    ci = 20.0 * torch.randn((3, g, b), generator=torch.Generator(device=device).manual_seed(b),
                            device=device)
    args = (v, spot, factors, spot_prev, factors_prev, mean, std, prev["mean_prev"],
            prev["std_prev"], idx_lo, w_hi, ci, a, b_, mono)
    limit = _build.smem_limit(device)
    plan = decision_kernel.moments_plan(g, 3, b, f, limit)
    assert plan.body == ("wide" if b <= 32 else "wide-smem")
    before = (fm.launches, fm.wide_launches, fm.wide_smem_launches, fm.large_launches)
    got = [t.clone() for t in fm(*args)]
    assert (fm.launches, fm.wide_launches, fm.wide_smem_launches, fm.large_launches) == (
        before[0] + 1, before[1] + 1, before[2] + (plan.body == "wide-smem"),
        before[3] + (plan.name == "large"))
    want = decision_kernel.decision_update_moments_plain(*args)
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=1e-4)
    for k in (1, 2):
        torch.testing.assert_close(got[k], want[k], rtol=1e-5,
                                   atol=1e-5 * float(want[k].abs().max()))
    for body in ("wide", "wide-smem") if b <= 32 else ("wide-smem",):
        fits = decision_kernel.wide_max_grid(3, b, f, limit, body)
        for route in ("shared", "large") if g <= fits else ("large",):
            forced = fm(*args, route=f"{body}-{route}")
            assert all(torch.equal(x, y) for x, y in zip(got, forced)), (body, route)


@pytest.mark.parametrize("g", [100, 1000])
def test_moments_forced_wide_keeps_the_register_bits(device, g):
    """At the headline's B = 9, F = 3 kernel B forced onto each wide body
    gives its register kernels' bits on each grid route."""
    fm = decision_kernel.decision_update_moments
    args = _decision_args(device, g, 1_037, 3, 3, basis=BASIS_9)
    for route in ("shared", "large"):
        register = [t.clone() for t in fm(*args, route=route)]
        for body in ("wide", "wide-smem"):
            forced = fm(*args, route=f"{body}-{route}")
            assert all(torch.equal(x, y) for x, y in zip(register, forced)), (body, route)


def _standardised_sweep_args(device, n, s, g, b, f):
    """``_sweep_args`` at ``_basis_text(b, f)``, each step's design stats
    taken on its own paths (the engine's), so that every entry is of order
    one."""
    from storage_tpu_torch.basis import design_matrix
    from storage_tpu_torch.ops.regression import column_stats

    args = list(_sweep_args(device, n, s, g, f, basis=_basis_text(b, f)))
    stats = [column_stats(design_matrix(args[11], args[6][t], args[7][t])) for t in range(n)]
    args[1] = torch.stack([m for m, _ in stats]).contiguous()
    args[2] = torch.stack([sd for _, sd in stats]).contiguous()
    return tuple(args)


@pytest.mark.parametrize("general", [False, True], ids=["uniform", "general"])
@pytest.mark.parametrize("b,f", WIDE_SHAPES)
def test_forward_sweep_monomial_beyond_the_caps(device, b, f, general):
    """Kernel C's monomial mode past 16 terms or 8 factors (its wide route:
    the powers from a device table, each sim's design row in shared memory)
    on evenly spaced and custom rows against its plain version, with the
    per-sim panels, on the rule's grid route (shared at G = 100) and forced
    onto the large one: the same bits on both; counted in
    ``wide_launches``."""
    s, n, g = 300, 9, 100
    args = _standardised_sweep_args(device, n, s, g, b, f)
    assert forward_kernel.sweep_wide(b, f)
    fs = forward_kernel.forward_sweep
    before = (fs.launches, fs.wide_launches, fs.large_launches)
    got, want, panels, want_panels = _sweep_mode_call(args, "general" if general else "monomial")
    assert (fs.launches, fs.wide_launches, fs.large_launches) == (
        before[0] + 1, before[1] + 1, before[2])
    for k in range(2):
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-3)
    for row, want_row in zip(panels, want_panels):
        torch.testing.assert_close(row, want_row, rtol=1e-6, atol=1e-3)
    for k in (2, 3):
        torch.testing.assert_close(got[k], want[k], rtol=1e-5,
                                   atol=1e-5 * float(want[k].abs().max()))
    large = _sweep_mode_call(args, "general" if general else "monomial", route="large")
    assert fs.large_launches == before[2] + 1
    for x, y in zip((*got, *panels), (*large[0], *large[2])):
        assert torch.equal(x, y)


def test_forward_sweep_wide_sizing_matches_kernel_info(device):
    """The monomial sweep's Python sizing (``sweep_max_grid``, the wide
    route's shared words) is its launch report's on this card, on both
    sides of the wide route's crossing, in both grid modes and on the large
    route."""
    limit = _build.smem_limit(device)
    for b, f in ((16, 8), *WIDE_SHAPES, (64, 10)):
        for general in (False, True):
            info = forward_kernel.kernel_info(100, b, 3, f, 1, device, general=general)
            assert info["max_grid"] == forward_kernel.sweep_max_grid(
                b, 3, f, 1, limit, general=general), (b, f, general)
            large = forward_kernel.kernel_info(100, b, 3, f, 1, device, general=general,
                                               large=True)
            assert large["smem_bytes"] <= limit and large["blocks_per_sm"] >= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n,s", [(7, 1000), (3, 300), (2, 5000)])
def test_forward_sweep_vjp(device, dtype, n, s):
    """The VJP kernel against its plain version at ragged path counts:
    within 1e-5 of the largest entry in f32 (sums in another order), 1e-12
    in f64."""
    gen = torch.Generator(device=device).manual_seed(9)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=device, dtype=dtype)  # noqa: E731
    dec, cons, spot = 100.0 * rnd(n, s), rnd(n, s).abs(), 30.0 + 5.0 * rnd(n, s)
    fwd, df = 30.0 + rnd(n).abs(), 0.9 + 0.01 * rnd(n)
    g = rnd(s)
    before = forward_kernel.forward_sweep_vjp.launches
    got = forward_kernel.forward_sweep_vjp(dec, cons, spot, fwd, df, g)
    assert forward_kernel.forward_sweep_vjp.launches == before + 1
    want = forward_kernel.forward_sweep_vjp_plain(dec.double(), cons.double(), spot.double(),
                                                  fwd.double(), df.double(), g.double())
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(got.double(), want, rtol=0, atol=tol * float(want.abs().max()))
    assert torch.equal(got, forward_kernel.forward_sweep_vjp(dec, cons, spot, fwd, df, g))


def test_adjoint_and_custom_grid_valuations_on_the_card(device):
    """An adjoint valuation on a custom grid launches the sweep once (in its
    general-grid mode) and the VJP once; its deltas equal the pathwise ones
    for t < N within f32 rounding of their scale."""
    storage = tpkg.CmdtyStorage(
        "D", "2020-01-01", "2020-02-15", 0.6, 0.4, min_inventory=0.0, max_inventory=5000.0,
        max_injection_rate=400.0, max_withdrawal_rate=450.0)
    idx = pd.period_range("2020-01-01", "2020-02-15", freq="D")
    fwd = pd.Series(30.0 + 7.0 * np.sin(2 * np.pi * np.arange(len(idx)) / 46.0), index=idx)
    factors = [(9.0, pd.Series(0.8, index=pd.period_range("2020-01-01", "2020-03-15")))]

    def value(method):
        return tpkg.multi_factor_value(
            storage, "2020-01-01", 800.0, fwd, 0.04, None, factors, None, 4096,
            "1 + s + x0 + x0**2", True, seed=7, fwd_sim_seed=8, deltas_method=method,
            grid_calc=lambda lo, hi: lo + (hi - lo) * np.linspace(0.0, 1.0, 40) ** 2,
            device=device)

    pathwise = value("pathwise")
    before = (forward_kernel.forward_sweep.launches, forward_kernel.forward_sweep_vjp.launches)
    adjoint = value("adjoint")
    assert (forward_kernel.forward_sweep.launches - before[0],
            forward_kernel.forward_sweep_vjp.launches - before[1]) == (1, 1)
    assert adjoint.npv == pathwise.npv
    d_adj, d_path = adjoint.deltas.to_numpy(), pathwise.deltas.to_numpy()
    np.testing.assert_allclose(d_adj[:-1], d_path[:-1], rtol=0, atol=1e-5 * np.abs(d_path).max())


def _reg_market():
    """The 2F regression facility and market of tests/test_lsmc.py, whose
    intrinsic value moves with the grid and the interpolation."""
    storage = tpkg.CmdtyStorage(
        "D", "2019-12-01", "2020-04-01", 1.23, 0.98, min_inventory=0.0, max_inventory=100_000.0,
        max_injection_rate=700.0, max_withdrawal_rate=700.0)
    idx = pd.period_range("2019-08-29", "2020-04-01", freq="D")
    fwd = pd.Series([23.87 if p < pd.Period("2020-03-12", freq="D") else 150.32 for p in idx],
                    index=idx)
    rates = pd.Series(0.03, index=pd.period_range("2019-08-29", "2020-06-01", freq="D"))

    def settle(period):
        return (period.asfreq("M").asfreq("D", "end") + 20).start_time.date()

    return storage, fwd, rates, settle


def _intrinsic_case(device, dtype, mode, g, n):
    """The DP's tables of the 2F facility on ``device``, valued from the
    valuation date of its pins (n = None) or over its last n steps, on
    linspace rows ("linear", "cubic") or fixed-spacing rows ("general")."""
    storage, fwd, rates, settle = _reg_market()
    val_date = "2019-08-29" if n is None else storage.end - n
    inputs = prepare_valuation(storage, val_date, 0.0 if n is None else 100.0 * n, fwd, rates,
                               settle)
    lo, hi = inputs.inventory_lower, inputs.inventory_upper
    grids = (gridmod.inventory_grids_fixed_spacing(lo, hi, 0.0, 100_000.0, g) if mode == "general"
             else gridmod.inventory_grids(lo, hi, g))
    arrays = lsmc_engine.build_engine_arrays(
        inputs.compiled, inputs.fwd, inputs.df_settle, inputs.df_flow, lo, hi, g, dtype, device,
        grids)
    return inputs, arrays


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("mode", ["linear", "general", "cubic"])
@pytest.mark.parametrize("g,n", [(1000, None), (15, 1), (37, None), (1100, 40)],
                         ids=["G=1000", "N=1", "G=37", "G=1100"])
def test_intrinsic_dp(device, dtype, mode, g, n):
    """The DP kernel, one launch, against intrinsic_plain in f64 on the card
    (one extra decision: volumes off the grid points; G=37 fills no whole
    warp, G=1100 more grid points than the block's threads)."""
    inputs, arrays = _intrinsic_case(device, dtype, mode, g, n)
    args = (inputs.starting_inventory, 1, None, False, "cubic" if mode == "cubic" else "linear",
            mode != "general")
    before = intrinsic_kernel.intrinsic_dp.launches
    got = intrinsic_engine.intrinsic_core(arrays, *args)
    assert intrinsic_kernel.intrinsic_dp.launches == before + 1
    want = intrinsic_engine.intrinsic_plain(
        {k: v.to(torch.float64) for k, v in arrays.items()}, *args)
    assert got.npv.dtype == dtype and got.inventory.shape == (arrays["grids"].shape[0],)
    rel = 1e-10 if dtype == torch.float64 else 1e-5
    assert float(got.npv) == pytest.approx(float(want.npv), rel=rel)
    if dtype == torch.float64:
        for name in intrinsic_engine.IntrinsicEngineResult._fields[1:]:
            torch.testing.assert_close(getattr(got, name), getattr(want, name), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("extra", [1, 2], ids=["E=1", "E=2"])
def test_intrinsic_dp_snaps_must_end_empty(device, dtype, extra):
    """The 40-day facility that must end empty, on fixed-spacing rows (G=15)
    at E >= 1: the kernel's walk snaps to the band (at least one step's
    inventory is not previous + decision - loss as rounded) and gives its
    plain version's NPV (f64 1e-10, profile 1e-6; f32 1e-5 of the f64
    answer), whose walk snaps alike."""
    inputs = prepare_valuation(facility(tpkg, "linear", False), START, 800.0, curve(), 0.03, None)
    lo, hi = inputs.inventory_lower, inputs.inventory_upper
    grids = gridmod.inventory_grids_fixed_spacing(
        lo, hi, float(np.min(inputs.compiled.min_inv)), float(np.max(inputs.compiled.max_inv)), 15)
    arrays = lsmc_engine.build_engine_arrays(
        inputs.compiled, inputs.fwd, inputs.df_settle, inputs.df_flow, lo, hi, 15, dtype, device,
        grids)
    args = (inputs.starting_inventory, extra, None, False, "linear", False)
    got = intrinsic_engine.intrinsic_core(arrays, *args)
    want = intrinsic_engine.intrinsic_plain(
        {k: v.to(torch.float64) for k, v in arrays.items()}, *args)
    assert snapped_steps(got, inputs.starting_inventory) >= 1
    assert snapped_steps(want, inputs.starting_inventory) >= 1
    rel = 1e-10 if dtype == torch.float64 else 1e-5
    assert float(got.npv) == pytest.approx(float(want.npv), rel=rel)
    if dtype == torch.float64:
        for name in intrinsic_engine.IntrinsicEngineResult._fields[1:]:
            torch.testing.assert_close(getattr(got, name), getattr(want, name), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("mode", ["linear", "general", "cubic"])
def test_intrinsic_dp_large_route_gives_the_shared_bits(device, dtype, mode):
    """Forced onto the large route at G=100 (one extra decision), the DP
    gives the shared route's bits, one launch counted on each."""
    inputs, arrays = _intrinsic_case(device, dtype, mode, 100, None)
    args = (inputs.starting_inventory, 1, None, False, "cubic" if mode == "cubic" else "linear",
            mode != "general")
    shared = intrinsic_engine.intrinsic_core(arrays, *args)
    before = intrinsic_kernel.intrinsic_dp.launches, intrinsic_kernel.intrinsic_dp.large_launches
    large = intrinsic_engine.intrinsic_core(arrays, *args, route="large")
    assert (intrinsic_kernel.intrinsic_dp.launches,
            intrinsic_kernel.intrinsic_dp.large_launches) == (before[0] + 1, before[1] + 1)
    for name in intrinsic_engine.IntrinsicEngineResult._fields:
        assert torch.equal(getattr(large, name), getattr(shared, name)), name


def test_intrinsic_dp_grid_beyond_shared_memory_takes_the_large_route(device):
    """The block's shared memory bounds the shared route's G, as the route
    rule's copy of its sizing says; one point beyond it the DP takes the
    large route, one launch, and gives its plain version's answer (f64:
    NPV within 1e-10 relative, profile within 1e-6)."""
    _, arrays = _intrinsic_case(device, torch.float64, "linear", 15, 1)
    r = arrays["ratchet_inv"].shape[1]
    info = intrinsic_kernel.intrinsic_info(torch.float64, device, 100, r, 0, "linear")
    assert info["max_grid"] == intrinsic_kernel.max_grid(r, 0, "linear", 8,
                                                         _build.smem_limit(device))
    assert info["max_grid"] >= 8_192 and info["blocks_per_sm"] >= 1
    assert info["large_blocks_per_sm"] >= 1
    g = info["max_grid"] + 1
    inputs, arrays = _intrinsic_case(device, torch.float64, "linear", g, 1)
    args = (inputs.starting_inventory, 0, None, False)
    before = intrinsic_kernel.intrinsic_dp.launches, intrinsic_kernel.intrinsic_dp.large_launches
    got = intrinsic_engine.intrinsic_core(arrays, *args)
    assert (intrinsic_kernel.intrinsic_dp.launches,
            intrinsic_kernel.intrinsic_dp.large_launches) == (before[0] + 1, before[1] + 1)
    want = intrinsic_engine.intrinsic_plain(arrays, *args)
    assert float(got.npv) == pytest.approx(float(want.npv), rel=1e-10)
    for name in intrinsic_engine.IntrinsicEngineResult._fields[1:]:
        torch.testing.assert_close(getattr(got, name), getattr(want, name), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("mode", ["linear", "general", "cubic"])
def test_intrinsic_dp_large_route_spreads_over_the_card(device, dtype, mode):
    """The large route is one cooperative launch of the grid its launch
    report sizes (``large_grid_blocks`` from the card's SMs and its blocks per
    SM, more than one block at G = 32,768), and gives its plain version's
    answer (f64 NPV within 1e-10 relative, profile within 1e-6; f32 within
    1e-5 of the f64 answer) over 40 steps at G = 32,768 (cubic: 2,048, its
    dense inverse read every step)."""
    g = 2_048 if mode == "cubic" else 32_768
    inputs, arrays = _intrinsic_case(device, dtype, mode, g, 40)
    r = arrays["ratchet_inv"].shape[1]
    info = intrinsic_kernel.intrinsic_info(dtype, device, g, r, 0, mode)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    assert info["large_cooperative"] == 1 and info["large_grid_blocks"] > 1
    assert info["large_grid_blocks"] == intrinsic_kernel.large_grid_blocks(
        g, mode, sms, info["large_blocks_per_sm"])
    args = (inputs.starting_inventory, 0, None, False, "cubic" if mode == "cubic" else "linear",
            mode != "general")
    before = intrinsic_kernel.intrinsic_dp.launches, intrinsic_kernel.intrinsic_dp.large_launches
    got = intrinsic_engine.intrinsic_core(arrays, *args, route="large")
    assert (intrinsic_kernel.intrinsic_dp.launches,
            intrinsic_kernel.intrinsic_dp.large_launches) == (before[0] + 1, before[1] + 1)
    want = intrinsic_engine.intrinsic_plain(
        {k: v.to(torch.float64) for k, v in arrays.items()}, *args)
    rel = 1e-10 if dtype == torch.float64 else 1e-5
    assert float(got.npv) == pytest.approx(float(want.npv), rel=rel)
    if dtype == torch.float64:
        for name in intrinsic_engine.IntrinsicEngineResult._fields[1:]:
            torch.testing.assert_close(getattr(got, name), getattr(want, name), rtol=0, atol=1e-6)


def test_intrinsic_dp_refuses_cpu_tensors_and_other_dtypes(device):
    _, arrays = _intrinsic_case("cpu", torch.float64, "linear", 11, 1)
    v_end = torch.zeros(11, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        intrinsic_kernel.intrinsic_dp(arrays, v_end, 100.0, 0, False, "linear")
    _, arrays = _intrinsic_case(device, torch.float16, "linear", 11, 1)
    with pytest.raises(TypeError, match="float32 or float64"):
        intrinsic_kernel.intrinsic_dp(arrays, v_end.to(device), 100.0, 0, False, "linear")


def test_intrinsic_value_pins_on_the_card(device):
    """The 2F facility's pins through intrinsic_value(device="cuda") in f64."""
    storage, fwd, rates, settle = _reg_market()
    for scheme, pin in (("linspace", 1_705_564.2806059965), ("fixed_spacing", 1_703_773.0757192627)):
        res = tpkg.intrinsic_value(storage, "2019-08-29", 0.0, fwd, rates, settle,
                                   dtype=torch.float64, grid_scheme=scheme, device=device)
        assert res.npv == pytest.approx(pin, rel=1e-9)


def test_intrinsic_launches_once_per_lsmc_valuation(device):
    """Every LSMC valuation on the card runs the DP kernel once, in its
    dtype, and its intrinsic value is the plain version's on the CPU."""
    start = pd.Period("2021-01-01", freq="D")
    storage = tpkg.CmdtyStorage(
        "D", start, start + 20, 0.9, 0.7,
        ratchets=[(start, [(0.0, -200.0, 300.0), (2500.0, -250.0, 250.0),
                           (5000.0, -300.0, 200.0)])],
        ratchet_interp=tpkg.RatchetInterp.LINEAR, terminal_storage_npv=lambda p, inv: p * inv)
    fwd = pd.Series(30.0 + 6 * np.sin(np.arange(21) / 3.0),
                    index=pd.period_range(start, start + 20, freq="D"))
    args = (storage, start, 100.0, fwd, 0.02, None, 14.5, 1.1, 0.19, 0.23, 1000, BASIS_9, False)
    before = intrinsic_kernel.intrinsic_dp.launches
    got = tpkg.three_factor_seasonal_value(*args, seed=3, num_inventory_grid_points=20,
                                           device=device)
    assert intrinsic_kernel.intrinsic_dp.launches == before + 1
    want = tpkg.three_factor_seasonal_value(*args, seed=3, num_inventory_grid_points=20,
                                            dtype=torch.float64, device="cpu")
    assert got.intrinsic_npv == pytest.approx(want.intrinsic_npv, rel=1e-5)
    assert got.intrinsic_profile.shape == (21, 6)


def _tree_case(device, dtype, mode, g, n, a=5.5):
    """The tree DP's tables on the 2F facility over its last n steps (the
    tree from the valuation date), on linspace or fixed-spacing rows."""
    storage, fwd, rates, settle = _reg_market()
    val_date = storage.end - n
    inputs = prepare_valuation(storage, val_date, 100.0 * n, fwd, rates, settle)
    horizon = fwd[val_date:]
    tree = trinomial_tree.build_tree(horizon.to_numpy(), np.full(len(horizon), 0.9), a, 1 / 365.0)
    lo, hi = inputs.inventory_lower, inputs.inventory_upper
    grids = (gridmod.inventory_grids_fixed_spacing(lo, hi, 0.0, 100_000.0, g) if mode == "general"
             else gridmod.inventory_grids(lo, hi, g))
    arrays = lsmc_engine.build_engine_arrays(
        inputs.compiled, inputs.fwd, inputs.df_settle, inputs.df_flow, lo, hi, g, dtype, device,
        grids)
    lattice = tree_engine.tree_arrays(tree, 0, inputs.num_steps, dtype, device)
    return inputs, arrays, lattice


def _tree_f64(d):
    return {k: v.to(torch.float64) if v.is_floating_point() else v for k, v in d.items()}


def _tree_launches():
    return (tree_kernel.tree_dp.launches, tree_kernel.tree_dp.step_launches,
            tree_kernel.tree_dp.large_launches)


@pytest.mark.parametrize("route", ["cluster", "steps", "large"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("mode", ["linear", "general", "cubic"])
@pytest.mark.parametrize("g,n,e", [(37, 20, 1), (300, 3, 0), (15, 1, 1), (100, 20, 0)],
                         ids=["G=37", "G=300", "N=1", "T3-sized"])
def test_tree_dp(device, dtype, mode, g, n, e, route):
    """The tree kernel against tree_plain in f64 on the card, on every route
    (M = 99 node rows, T3's lattice width): the cluster route one launch a
    valuation, the large-slab route one a step, the large route a table
    launch and an ev and a decide launch a step (and a moments launch in
    cubic mode), the same bits."""
    inputs, arrays, lattice = _tree_case(device, dtype, mode, g, n)
    args = (e, None, False, "cubic" if mode == "cubic" else "linear", mode != "general")
    before = _tree_launches()
    got = tree_engine.tree_core(arrays, lattice, *args, route=route)
    counted = tuple(a - b for a, b in zip(_tree_launches(), before))
    large = tree_kernel.large_launches(n, g, e, mode, dtype.itemsize)
    assert large == 1 + n * (3 if mode == "cubic" else 2)
    assert counted == {"cluster": (1, 0, 0), "steps": (0, n, 0), "large": (0, 0, large)}[route]
    other = tree_engine.tree_core(arrays, lattice, *args,
                                  route="steps" if route == "cluster" else "cluster")
    assert torch.equal(got.values, other.values)
    want = tree_engine.tree_plain(_tree_f64(arrays), _tree_f64(lattice), *args)
    assert got.values.dtype == dtype and got.values.shape == want.values.shape
    rel = 1e-10 if dtype == torch.float64 else 1e-5
    assert float(got.npv) == pytest.approx(float(want.npv), rel=rel)
    if dtype == torch.float64:
        scale = float(want.values.abs().max())
        torch.testing.assert_close(got.values, want.values, rtol=0, atol=1e-9 * scale)


def test_tree_dp_grid_beyond_shared_memory_takes_the_large_route(device):
    """The routes' reports: at G=100 the cluster route takes the slab; one
    grid point beyond the step block's capacity (the route rule's copy of
    its sizing), a row fits neither route's shared memory and tree_dp takes
    the large route, a table launch and an ev and a decide launch for its
    one step, and gives tree_plain's values (within 1e-9 of their scale, the NPV
    within 1e-10)."""
    _, arrays, lattice = _tree_case(device, torch.float64, "linear", 100, 1)
    m, w = lattice["band"].shape[1:]
    info = tree_kernel.kernel_info(100, torch.float64, "linear", device, m, w)
    assert info["route"] == "cluster" and info["cluster_size"] in (8, 16)
    assert info["blocks_per_sm"] >= 1 and info["local_bytes"] == 0
    assert info["rows_per_cta"] * info["cluster_size"] >= m and info["max_rows"] >= m
    assert info["max_grid"] == tree_kernel.steps_max_grid(8, "linear", _build.smem_limit(device))
    assert info["large_blocks_per_sm"] >= 1
    g = info["max_grid"] + 1
    beyond = tree_kernel.kernel_info(g, torch.float64, "linear", device, m, w)
    assert beyond["blocks_per_sm"] == 0 and beyond["max_rows"] == 0
    assert beyond["route"] == "large"
    _, arrays, lattice = _tree_case(device, torch.float64, "linear", g, 1)
    before = _tree_launches()
    got = tree_engine.tree_core(arrays, lattice, 0, None, False)
    assert tuple(a - b for a, b in zip(_tree_launches(), before)) == (
        0, 0, tree_kernel.large_launches(1, g, 0, "linear", 8))
    want = tree_engine.tree_plain(arrays, lattice, 0, None, False)
    assert float(got.npv) == pytest.approx(float(want.npv), rel=1e-10)
    scale = float(want.values.abs().max())
    torch.testing.assert_close(got.values, want.values, rtol=0, atol=1e-9 * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("mode", ["linear", "general"])
def test_tree_dp_large_route_decides_from_step_tables(device, dtype, mode, monkeypatch):
    """At G = 65,536 (M = 99 node rows over 3 steps) the large route decides
    every node row from its step's table: with the table scratch cut to two
    steps' tables, two table launches and an ev and a decide launch a step;
    tree_plain's values (f64 within 1e-9 of their scale, the NPV within
    1e-10; f32 within 1e-5 of the f64 NPV) and the bits of the scratch
    holding all three."""
    n = 3
    inputs, arrays, lattice = _tree_case(device, dtype, mode, 65_536, n)
    g = arrays["grids"].shape[1]  # fixed-spacing rows hold fewer points
    args = (0, None, False, "linear", mode != "general")
    whole = tree_engine.tree_core(arrays, lattice, *args, route="large").values
    one_step = intrinsic_kernel.table_len(g, 0) * dtype.itemsize
    monkeypatch.setattr(tree_kernel, "TABLE_SCRATCH_CAP", 2 * one_step)
    assert tree_kernel.large_table_steps(n, g, 0, dtype.itemsize) == 2
    before = _tree_launches()
    got = tree_engine.tree_core(arrays, lattice, *args, route="large")
    assert tuple(a - b for a, b in zip(_tree_launches(), before)) == (0, 0, 2 + 2 * n)
    assert torch.equal(got.values, whole)
    want = tree_engine.tree_plain(_tree_f64(arrays), _tree_f64(lattice), *args)
    rel = 1e-10 if dtype == torch.float64 else 1e-5
    assert float(got.npv) == pytest.approx(float(want.npv), rel=rel)
    if dtype == torch.float64:
        scale = float(want.values.abs().max())
        torch.testing.assert_close(got.values, want.values, rtol=0, atol=1e-9 * scale)


def _wide_lattice(device, dtype, m, g, n=2, w=3, seed=5):
    """A random lattice of m node rows (each row's band of w columns, rows
    summing to 1) and the 2F facility's tables over its last n steps at g
    grid points."""
    inputs, arrays, _ = _tree_case(device, dtype, "linear", g, n)
    rng = np.random.default_rng(seed)
    band = rng.uniform(0.1, 1.0, (n, m, w))
    band /= band.sum(axis=-1, keepdims=True)
    start = np.clip(np.arange(m) - w // 2, 0, m - w)
    spot = 20.0 + 10.0 * rng.uniform(size=(n + 1, m))
    lattice = {"spot": torch.tensor(spot, dtype=dtype, device=device),
               "band": torch.tensor(band, dtype=dtype, device=device),
               "band_start": torch.tensor(np.broadcast_to(start, (n, m)).copy(), device=device),
               "q0": torch.full((m,), 1.0 / m, dtype=dtype, device=device)}
    return inputs, arrays, lattice


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_tree_route_at_the_cluster_capacity(device, dtype):
    """A slab of exactly the cluster's capacity in node rows takes the
    cluster route, one node row more the large-slab route; both against
    tree_plain in f64."""
    g = 100
    m = tree_kernel.kernel_info(g, dtype, "linear", device, 1, 3)["max_rows"]
    assert m >= 361  # T4's lattice
    for rows, route in ((m, "cluster"), (m + 1, "steps")):
        inputs, arrays, lattice = _wide_lattice(device, dtype, rows, g)
        assert tree_kernel.kernel_info(g, dtype, "linear", device, rows, 3)["route"] == route
        before = tree_kernel.tree_dp.launches, tree_kernel.tree_dp.step_launches
        got = tree_engine.tree_core(arrays, lattice, 0, None, False)
        after = tree_kernel.tree_dp.launches, tree_kernel.tree_dp.step_launches
        assert (after[0] - before[0], after[1] - before[1]) == (
            (1, 0) if route == "cluster" else (0, 2))
        want = tree_engine.tree_plain(_tree_f64(arrays), _tree_f64(lattice), 0, None, False)
        scale = float(want.values.abs().max())
        tol = 1e-9 if dtype == torch.float64 else 1e-5
        torch.testing.assert_close(got.values.to(torch.float64), want.values, rtol=0,
                                   atol=tol * scale)


def test_trinomial_value_pin_on_the_card(device):
    """The C# trinomial sample (24,799.09) through trinomial_value(device="cuda")
    in f64: one launch on the cluster route, the CPU's answer within 1e-10."""
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
    args = (storage, "2019-09-15", 50.0, fwd, vols, 5.5, 1 / 365.0, 0.025,
            lambda period: pd.Timestamp("2019-10-20").date())
    before = tree_kernel.tree_dp.launches, tree_kernel.tree_dp.step_launches
    got = tpkg.trinomial_value(*args, num_inventory_grid_points=101, dtype=torch.float64,
                               device=device)
    assert (tree_kernel.tree_dp.launches, tree_kernel.tree_dp.step_launches) == (
        before[0] + 1, before[1])
    want = tpkg.trinomial_value(*args, num_inventory_grid_points=101, dtype=torch.float64,
                                device="cpu")
    assert got == pytest.approx(want, rel=1e-10)
    assert got == pytest.approx(24_799.09, rel=5e-4)


def test_group_of_one_on_the_card_keeps_the_bits(device):
    """A one-rank NCCL group on the card: a valuation through the API (the
    reducer then takes no collective) gives the no-group run's bits."""
    import datetime
    import socket

    from storage_tpu_torch.parallel import distributed as pdist

    storage = tpkg.CmdtyStorage(
        "D", "2020-01-01", "2020-02-15", 0.6, 0.4, min_inventory=0.0, max_inventory=5000.0,
        max_injection_rate=400.0, max_withdrawal_rate=450.0)
    idx = pd.period_range("2020-01-01", "2020-02-15", freq="D")
    fwd = pd.Series(30.0 + 7.0 * np.sin(2 * np.pi * np.arange(len(idx)) / 46.0), index=idx)
    factors = [(9.0, pd.Series(0.8, index=pd.period_range("2020-01-01", "2020-03-15")))]

    def value(method):
        res = tpkg.multi_factor_value(
            storage, "2020-01-01", 800.0, fwd, 0.04, None, factors, None, 4096,
            "1 + s + x0 + x0**2", True, seed=7, fwd_sim_seed=8, deltas_method=method,
            device=device)
        return res.npv, res.val_sim_standard_error, res.deltas.to_numpy()

    want = [value(m) for m in ("pathwise", "adjoint")]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    pdist.initialize(f"localhost:{port}", 1, 0, backend="nccl",
                     timeout=datetime.timedelta(seconds=120))
    try:
        got = [value(m) for m in ("pathwise", "adjoint")]
    finally:
        torch.distributed.destroy_process_group()
    for (g_npv, g_se, g_d), (w_npv, w_se, w_d) in zip(got, want):
        assert (g_npv, g_se) == (w_npv, w_se)
        np.testing.assert_array_equal(g_d, w_d)
