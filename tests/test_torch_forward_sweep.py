"""The forward sweep of kernel C (``forward_sweep``: every step in one launch
on the card) through its plain version ``forward_sweep_plain``, against a
Python loop of the Pallas TPU kernel it replaces (``forward_step_pallas`` in
interpret mode, ``pred_passes=1``), over per-step tables that differ from
step to step: linear and step ratchets, 0 to 2 extra decisions, spot-only
(F = 0) and factor panels, a degenerate next-period grid, the per-sim panels
on and off; and its design mode on the raw design of 20 monomials (past the
16 of the monomial mode on the card).  Also: the sweep is its loop of
``forward_step_plain`` to the
bit, in f32 and f64, and the packed step table holds each part where the
kernel reads it.

Tolerance, as in ``tests/test_torch_forward_kernel.py``: the port evaluates
the fitted continuation at the two grid rows a decision touches and lerps;
the TPU kernel sums a hat over all G rows.  Both are f32 and land within a
few ULP of the continuation (|pred| ≲ 1e3 here), far below the gaps between
decisions, so the choices agree and per-sim outputs match to 1e-5 relative
over the steps; the cross-sim sums differ by summation order only.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from storage_tpu.basis import parse_basis_functions as jax_parse
from storage_tpu.ops import forward_kernel as jfk
from storage_tpu_torch.basis import design_columns, parse_basis_functions
from storage_tpu_torch.ops import forward_kernel as tfk

torch.set_num_threads(1)

BASIS = "1 + s + x0 + x0**2 + x1"
SPOT_BASIS = "1 + s + s**2"
# The sweep body both of kernel C's translation units compile.
CSRC = Path(tfk.__file__).resolve().parent.parent / "csrc" / "forward_sweep.cuh"


def _case(seed, *, n=5, s=256, g=16, f=2, e=1, is_step=False, r=4, loss=0.02,
          degenerate_step=None, basis=None):
    """N steps of tables that change from step to step, and the paths."""
    rng = np.random.default_rng(seed)
    basis = basis or (BASIS if f else SPOT_BASIS)
    b_dim = len(jax_parse(basis))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    t = np.arange(n)
    scalars = dict(
        df_settle=0.97 - 0.01 * t, df_flow=0.95 - 0.01 * t, inj_cost=1.2 + 0.1 * t,
        wdr_cost=0.9 + 0.05 * t, inj_pcnt=np.full(n, 0.015), wdr_pcnt=np.full(n, 0.01),
        loss_pcnt=np.full(n, loss), inv_cost_rate=0.03 + 0.01 * t,
        next_min=50.0 * t, next_max=1100.0 - 40.0 * t,
    )
    grid_next = np.stack([np.linspace(lo, hi, g) for lo, hi in
                          zip(scalars["next_min"], scalars["next_max"])])
    if degenerate_step is not None:  # the band collapses at that step
        scalars["next_min"][degenerate_step] = scalars["next_max"][degenerate_step] = 500.0
        grid_next[degenerate_step] = 500.0
    shift = 30.0 * t[:, None]
    return dict(
        scalars={k: f32(v) for k, v in scalars.items()}, grid_next=f32(grid_next),
        mean=f32(rng.normal(0.0, 1.0, (n, b_dim))), std=f32(rng.uniform(0.5, 2.0, (n, b_dim))),
        ratchet_inv=f32(np.linspace(0.0, 1000.0, r)[None, :] + shift),
        ratchet_min=f32(np.linspace(-30.0, -140.0, r)[None, :] - shift / 3),
        ratchet_max=f32(np.linspace(150.0, 40.0, r)[None, :] + shift / 3),
        spot=f32(rng.uniform(20.0, 60.0, (n, s))), factors=f32(rng.normal(0.0, 0.5, (n, f, s))),
        inventory=f32(rng.uniform(0.0, 1000.0, s)),
        coeffs=f32(rng.normal(0.0, 20.0, (n, b_dim, g))), e=e, is_step=is_step, basis=basis,
    )


def _torch_args(c, dtype=torch.float32):
    params = tfk.pack_params({k: torch.tensor(v) for k, v in c["scalars"].items()},
                             torch.tensor(c["grid_next"]), dtype=dtype)
    t = lambda k: torch.tensor(c[k], dtype=dtype)  # noqa: E731
    return (params, t("mean"), t("std"), t("ratchet_inv"), t("ratchet_min"), t("ratchet_max"),
            t("spot"), t("factors"), t("inventory"))


def _jax_loop(c):
    """The TPU kernel once per step, as the JAX engine's forward scan runs it:
    per step (new inventory, new PV, volume, fuel, sums, xbar).  Spot-only
    panels get one factor row the basis does not read (the Pallas kernel
    takes no empty factor block)."""
    factors = c["factors"] if c["factors"].shape[1] else np.ones_like(c["spot"])[:, None, :]
    mono = tuple(jax_parse(c["basis"]))
    inv, pv = jnp.asarray(c["inventory"]), jnp.zeros_like(jnp.asarray(c["inventory"]))
    steps = []
    for t in range(c["spot"].shape[0]):
        params = jfk.pack_params({k: jnp.asarray(v[t]) for k, v in c["scalars"].items()},
                                 jnp.asarray(c["grid_next"][t]))
        out = jfk.forward_step_pallas(
            params, *(jnp.asarray(c[k][t]) for k in ("mean", "std", "ratchet_inv",
                                                      "ratchet_min", "ratchet_max", "spot")),
            jnp.asarray(factors[t]), inv, pv, jnp.asarray(c["coeffs"][t]), mono, c["e"],
            c["is_step"], 128, interpret=True, pred_passes=1,
        )
        steps.append([np.asarray(x) for x in out])
        inv, pv = out[0], out[1]
    return steps


@pytest.mark.parametrize(
    "kwargs,with_panels",
    [
        (dict(), True),  # linear ratchets, 5 decisions, losses + fuel + inventory cost
        (dict(e=0, is_step=True, r=3, loss=0.0), False),  # step ratchets, bang-bang only
        (dict(degenerate_step=4), True),  # the last step's next band collapses
        (dict(e=2, s=384, g=24, r=5), False),  # 7 decisions, wider grid
        (dict(f=0), True),  # spot-only panels (value_from_sims)
        (dict(f=0, e=0, is_step=True, n=6), False),
    ],
    ids=["linear-e1-panels", "step-e0", "degenerate-grid-panels", "linear-e2", "spot-only-panels",
         "spot-only-step-e0"],
)
def test_sweep_plain_matches_pallas_loop(kwargs, with_panels):
    c = _case(21 + len(kwargs), **kwargs)
    want = _jax_loop(c)
    n, s = c["spot"].shape
    args = _torch_args(c)
    panels = [torch.full((n, s), np.nan) for _ in range(4)] if with_panels else None
    inv, pv, sums, xbar = tfk.forward_sweep(
        *args, None, torch.tensor(c["coeffs"]), tuple(parse_basis_functions(c["basis"])), c["e"],
        c["is_step"], panels=panels,
    )
    assert tfk.forward_sweep.launches == 0  # CPU tensors take the plain version
    close = lambda got, w, name: np.testing.assert_allclose(  # noqa: E731
        got, w, rtol=1e-5, atol=1e-3, err_msg=name)
    close(inv.numpy(), want[-1][0], "final inventory")
    close(pv.numpy(), want[-1][1], "final pv")
    for t, w in enumerate(want):
        np.testing.assert_allclose(sums[t].numpy(), w[4], rtol=1e-5, atol=1e-4 * s)
        np.testing.assert_allclose(xbar[t].numpy(), w[5], rtol=1e-5, atol=1e-5 * s)
        np.testing.assert_array_equal(sums[t].numpy()[6:], 0.0)
        if with_panels:
            close(panels[0][t].numpy(), w[0], f"inventory row {t}")
            close(panels[1][t].numpy(), w[2], f"volume row {t}")
            close(panels[2][t].numpy(), w[3], f"fuel row {t}")
            # The TPU kernel returns PVs only: its immediate PV is the step's
            # PV increment, exact to the rounding of the running PV.
            pv_prev = want[t - 1][1] if t else 0.0
            np.testing.assert_allclose(panels[3][t].numpy(), w[1] - pv_prev, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(w[1]).max()) + 1e-3)


# 20 terms on 3 factors: the full quadratic in the spot and the factors, the
# cubes and s**4, beyond the 16 terms of the monomial mode on the card.
BASIS_20 = ("1 + s + x0 + x1 + x2 + s**2 + x0**2 + x1**2 + x2**2 + s*x0 + s*x1 + s*x2 + x0*x1 "
            "+ x0*x2 + x1*x2 + s**3 + x0**3 + x1**3 + x2**3 + s**4")


def test_design_mode_plain_matches_pallas_loop_at_20_terms():
    """Kernel C's design mode (``forward_sweep_design``, on the card the wide
    route beyond 16 terms) through its plain version, on the 20 monomials'
    raw design, against the TPU kernel looped over the steps with those
    monomials: the tolerances of ``test_sweep_plain_matches_pallas_loop``."""
    c = _case(41, f=3, basis=BASIS_20, s=256, g=16)
    want = _jax_loop(c)
    n, s = c["spot"].shape
    args = _torch_args(c)
    monomials = tuple(parse_basis_functions(BASIS_20))
    design = torch.stack(design_columns(monomials, args[6], args[7]), dim=1)  # [N, 20, S] raw
    assert design.shape == (n, 20, s)
    panels = [torch.full((n, s), np.nan) for _ in range(4)]
    inv, pv, sums, xbar = tfk.forward_sweep_design(
        *args[:7], design, args[8], None, torch.tensor(c["coeffs"]), c["e"], c["is_step"],
        panels=panels)
    assert tfk.forward_sweep_design.launches == 0  # CPU tensors take the plain version
    close = lambda got, w, name: np.testing.assert_allclose(  # noqa: E731
        got, w, rtol=1e-5, atol=1e-3, err_msg=name)
    close(inv.numpy(), want[-1][0], "final inventory")
    close(pv.numpy(), want[-1][1], "final pv")
    for t, w in enumerate(want):
        np.testing.assert_allclose(sums[t].numpy(), w[4], rtol=1e-5, atol=1e-4 * s)
        np.testing.assert_allclose(xbar[t].numpy(), w[5], rtol=1e-5, atol=1e-5 * s)
        close(panels[0][t].numpy(), w[0], f"inventory row {t}")
        close(panels[1][t].numpy(), w[2], f"volume row {t}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_sweep_plain_is_the_step_loop(dtype):
    """Bit for bit the loop of forward_step_plain it stands for, with a
    starting PV, the panels and the ``out`` buffers."""
    c = _case(5, n=4, e=1)
    params, mean, std, r_inv, r_min, r_max, spot, factors, inv0 = _torch_args(c, dtype)
    coeffs = torch.tensor(c["coeffs"], dtype=dtype)
    mono = tuple(parse_basis_functions(c["basis"]))
    pv0 = torch.linspace(-50.0, 50.0, spot.shape[1], dtype=dtype)
    n, s = spot.shape
    panels = [torch.empty((n, s), dtype=dtype) for _ in range(4)]
    out = [torch.empty(s, dtype=dtype) for _ in range(2)]
    got = tfk.forward_sweep_plain(params, mean, std, r_inv, r_min, r_max, spot, factors, inv0,
                                  pv0, coeffs, mono, 1, False, panels=panels, out=out)
    assert got[0] is out[0] and got[1] is out[1]
    inv, pv = inv0, pv0
    for t in range(n):
        imm = torch.empty(s, dtype=dtype)
        inv, pv, dec, cons, sums, xbar = tfk.forward_step_plain(
            params[t], mean[t], std[t], r_inv[t], r_min[t], r_max[t], spot[t], factors[t], inv,
            pv, coeffs[t], mono, 1, False, imm_out=imm)
        for row, want in zip(panels, (inv, dec, cons, imm)):
            assert torch.equal(row[t], want)
        assert torch.equal(got[2][t], sums) and torch.equal(got[3][t], xbar)
    assert torch.equal(got[0], inv) and torch.equal(got[1], pv)
    # forward_step is the sweep at N = 1.
    step = tfk.forward_step(params[0], mean[0], std[0], r_inv[0], r_min[0], r_max[0], spot[0],
                            factors[0], inv0, pv0, coeffs[0], mono, 1, False)
    first = tfk.forward_step_plain(params[0], mean[0], std[0], r_inv[0], r_min[0], r_max[0],
                                   spot[0], factors[0], inv0, pv0, coeffs[0], mono, 1, False)
    for a, b in zip(step, first):
        assert torch.equal(a, b)


@pytest.mark.parametrize("b_dim,r,g", [(5, 4, 16), (9, 3, 100), (4, 1, 2)])
def test_packed_table_layout(b_dim, r, g):
    """Each part of a step's packed row sits at the offset the kernel reads
    it from, the row is a whole number of 16-byte words and its tail is
    zero, with and without the general-grid mode's grid row at its end; the
    kernel's width and group size are the wrapper's."""
    n = 3
    gen = torch.Generator().manual_seed(1)
    parts = dict(params=(n, tfk.NUM_PARAMS), mean=(n, b_dim), std=(n, b_dim), ratchet_inv=(n, r),
                 ratchet_min=(n, r), ratchet_max=(n, r), coeffs=(n, b_dim, g))
    tabs = {k: torch.randn(shape, generator=gen) for k, shape in parts.items()}
    for general in (False, True):
        if general:
            tabs["grid"] = torch.sort(torch.randn((n, g), generator=gen), dim=1).values
        table = tfk.pack_tables(*tabs.values())
        offsets, width = tfk.table_layout(b_dim, r, g, general)
        used = tfk.NUM_PARAMS + 2 * b_dim + 3 * r + b_dim * g + general * (2 * g + 1)
        assert table.shape == (n, width) and table.dtype == torch.float32 and table.is_contiguous()
        assert width % 4 == 0 and used <= width < used + 4
        assert width == (used + 3) // 4 * 4  # csrc/forward_sweep.cuh table_words
        for name, x in tabs.items():
            part = tfk.general_tail(x) if name == "grid" else x  # the row and its index
            size = part[0].numel()
            assert torch.equal(table[:, offsets[name]:offsets[name] + size],
                               part.reshape(n, size))
        assert torch.equal(table[:, used:], torch.zeros((n, width - used)))
    src = CSRC.read_text()
    assert int(re.search(r"constexpr int kThreads = (\d+);", src).group(1)) == tfk._GROUP
    assert ("(NUM_PARAMS + 2 * B + 3 * R + B * G + (general ? general_words(G) : 0) + 3) / 4 * 4"
            in src)
    assert "inline int general_words(int G) { return 2 * G + 1; }" in src
