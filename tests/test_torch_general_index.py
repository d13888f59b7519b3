"""Kernel C's general-grid search from a bucket index, on the CPU.

The kernel places each decision's target inventory on the next step's grid
row through a bucket index that its wrapper builds before the sweep
(``ops/forward_kernel.py general_tail``: K = G − 1 uniform buckets and the
count of interior nodes below each); ``indexed_weights_plain`` is that
search in tensor code.  On seeded numpy rows (random, bunched, a
fixed-spacing grid padded with repeats of its last node, rows with interior
repeats, a degenerate row, G = 2 and 3) and targets below, on, just beside
and above every node, it gives the lower node and the weight of
``interp.interp_weights_general`` and of the JAX package's
``interp_weights_general``, bit for bit in f32 and f64.  The index holds
its definition (a count of the nodes' buckets, computed with the kernel's
two roundings), and every target's node count lies in its bucket's
bracket.  The rows must be non-decreasing (a custom grid's are sorted); on
a row that is not, the answer is not defined, but every count and node
the search reads stays inside the row.
The plain sweep on such rows (``forward_sweep_plain(..., grid=)``, the
kernel's plain version) agrees with the JAX package's forward step on
general rows in f64 within 1e-9 relative, the engine tests' tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from storage_tpu import grid as jax_grid
from storage_tpu.basis import design_matrix as jax_design_matrix
from storage_tpu.basis import parse_basis_functions as jax_parse
from storage_tpu.engines import lsmc as jax_lsmc
from storage_tpu.ops import interp as jax_interp
from storage_tpu_torch import grid as gridmod
from storage_tpu_torch.basis import parse_basis_functions
from storage_tpu_torch.ops import forward_kernel as tfk
from storage_tpu_torch.ops import interp

torch.set_num_threads(1)

KINDS = ("random", "bunched", "fixed_spacing", "repeats", "degenerate", "g2", "g3")
RTOL = 1e-9  # f64: the same arithmetic up to summation order


def _rows(kind: str, n: int = 4, g: int = 40, seed: int = 3) -> np.ndarray:
    """Non-decreasing rows [N, G] of one kind, from a seed."""
    rng = np.random.default_rng(seed)
    if kind in ("g2", "g3"):
        g = int(kind[1])
    lo = rng.uniform(0.0, 100.0, (n, 1))
    hi = lo + rng.uniform(200.0, 1000.0, (n, 1))
    if kind == "bunched":
        return lo + (hi - lo) * np.linspace(0.0, 1.0, g) ** 1.3
    if kind == "fixed_spacing":
        # Rows of 5-unit steps over each band, padded to one width by
        # repeating the last node (grid.inventory_grids_fixed_spacing).
        lower = np.concatenate([[0.0], lo[:, 0]])
        upper = np.concatenate([[0.0], lo[:, 0] + rng.uniform(20.0, 150.0, n)])
        return gridmod.inventory_grids_fixed_spacing(lower, upper, 0.0, 1000.0, 201)[1:]
    if kind == "repeats":
        rows = lo + (hi - lo) * np.sort(rng.uniform(0.0, 1.0, (n, g)), axis=1)
        return np.round(rows / 40.0) * 40.0
    if kind == "degenerate":
        return np.repeat(lo, g, axis=1)
    rows = lo + (hi - lo) * np.sort(rng.uniform(0.0, 1.0, (n, g)), axis=1)
    rows[:, 0], rows[:, -1] = lo[:, 0], hi[:, 0]
    return rows


def _targets(rows: np.ndarray, dtype, seed: int = 4) -> np.ndarray:
    """Per row: random inventories across and beyond the row, every node,
    its neighbours one ulp away (in ``dtype``), and the midpoints."""
    rng = np.random.default_rng(seed)
    r = rows.astype(dtype)
    span = r[:, -1:] - r[:, :1]
    rand = r[:, :1] + (span + 10.0) * rng.uniform(-0.2, 1.2, (r.shape[0], 60)).astype(dtype)
    mids = (r[:, 1:] + r[:, :-1]) / dtype(2.0)
    down = np.nextafter(r, dtype(-np.inf))
    up = np.nextafter(r, dtype(np.inf))
    return np.concatenate([rand, r, down, up, mids, r[:, :1] - 5.0, r[:, -1:] + 5.0],
                          axis=1).astype(dtype)


def _buckets(rows: torch.Tensor, tail: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The bucket of each x of each row, as the kernel computes it."""
    g = rows.shape[1]
    xc = torch.minimum(torch.maximum(x, rows[:, :1]), rows[:, g - 1:])
    return torch.floor((xc - rows[:, :1]) * tail[:, g:g + 1]).clamp(min=0, max=g - 2).long()


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("kind", KINDS)
def test_indexed_search_matches_interp_and_jax(kind, dtype):
    rows = _rows(kind).astype(dtype)
    x = _targets(rows, dtype)
    t_rows, t_x = torch.from_numpy(rows), torch.from_numpy(x)
    tail = tfk.general_tail(t_rows)
    got_idx, got_w = tfk.indexed_weights_plain(tail, t_x)
    want_idx, want_w = interp.interp_weights_general(t_rows, t_x)
    assert torch.equal(got_idx, want_idx)
    assert torch.equal(got_w, want_w)
    jax_idx, jax_w = jax.vmap(jax_interp.interp_weights_general)(jnp.asarray(rows),
                                                                jnp.asarray(x))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(jax_idx))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(jax_w))
    # One row at a time is the same.
    idx0, w0 = tfk.indexed_weights_plain(tail[0], t_x[0])
    assert torch.equal(idx0, got_idx[0]) and torch.equal(w0, got_w[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("kind", KINDS)
def test_bucket_index_brackets_every_target(kind, dtype):
    """The counts are the nodes' buckets counted (cnt[i] = the interior nodes
    whose bucket is below i, from cnt[0] = 0 to cnt[K] = G − 2), and the
    node count of every target lies in its bucket's bracket."""
    rows = torch.from_numpy(_rows(kind)).to(dtype)
    n, g = rows.shape
    tail = tfk.general_tail(rows)
    assert tail.shape == (n, tfk.general_words(g)) and tail.dtype == dtype
    assert torch.equal(tail[:, :g], rows)
    ints = torch.int32 if dtype == torch.float32 else torch.int64
    counts = tail[:, g + 1:].contiguous().view(ints).long()
    node_buckets = _buckets(rows, tail, rows[:, 1:g - 1])
    for i in range(g):
        assert torch.equal(counts[:, i], (node_buckets < i).sum(dim=1))
    assert torch.equal(counts[:, 0], torch.zeros(n, dtype=torch.long))
    assert torch.equal(counts[:, g - 1], torch.full((n,), g - 2, dtype=torch.long))
    x = torch.from_numpy(_targets(rows.numpy(), rows.numpy().dtype.type))
    xc = torch.minimum(torch.maximum(x, rows[:, :1]), rows[:, g - 1:])
    node_count = (rows[:, None, 1:g - 1] <= xc[:, :, None]).sum(dim=2)
    b = _buckets(rows, tail, x)
    assert bool((torch.gather(counts, 1, b) <= node_count).all())
    assert bool((node_count <= torch.gather(counts, 1, b + 1)).all())
    widths = tfk.general_brackets(tail)
    assert widths.shape == (n, g - 1) and int(widths.min()) >= 0
    assert int(widths.sum(dim=1).max()) == g - 2


def test_rows_that_are_not_non_decreasing_stay_inside_the_row():
    """A descending row and a row with one step back, which no valuation
    builds: the index's counts stay within [0, G − 2] and the search's lower
    node within the row, with a finite weight; the non-decreasing
    row beside them keeps the general weights' answer."""
    rows = _rows("random", n=3).astype(np.float32)
    rows[0] = rows[0][::-1].copy()
    rows[1, 7] = rows[1, 6] - 1.0
    t_rows = torch.from_numpy(rows)
    tail = tfk.general_tail(t_rows)
    g = rows.shape[1]
    counts = tail[:, g + 1:].contiguous().view(torch.int32)
    assert int(counts.min()) >= 0 and int(counts.max()) <= g - 2
    x = torch.from_numpy(_targets(rows[2:], np.float32)).expand(3, -1).contiguous()
    idx, w = tfk.indexed_weights_plain(tail, x)
    assert int(idx.min()) >= 0 and int(idx.max()) <= g - 2
    assert bool(torch.isfinite(w).all())
    want = interp.interp_weights_general(t_rows[2:], x[2:])
    assert torch.equal(idx[2:], want[0]) and torch.equal(w[2:], want[1])


def test_padded_rows_bracket_their_repeats_in_one_bucket():
    """A fixed-spacing row padded with hundreds of repeats of its last node
    puts them in its last bucket: the widest bracket, which the kernel
    searches in log2(width) probes, never a scan."""
    lower = np.array([0.0, 0.0, 10.0])
    upper = np.array([0.0, 300.0, 2000.0])
    rows = gridmod.inventory_grids_fixed_spacing(lower, upper, 0.0, 2000.0, 401)[1:]
    tail = tfk.general_tail(torch.from_numpy(rows).float())
    widths = tfk.general_brackets(tail)
    repeats = int((rows[0] == rows[0, -1]).sum())
    assert repeats > 300 and int(widths[0, -1]) == repeats - 1
    assert int(widths[0, :-1].max()) <= 2 and int(widths[1].max()) <= 2
    x = torch.from_numpy(_targets(rows, np.float32)).float()
    assert torch.equal(tfk.indexed_weights_plain(tail, x)[0],
                       interp.interp_weights_general(torch.from_numpy(rows).float(), x)[0])


def _jax_forward_step(x, inventory, pv, monomials, e, is_step):
    """The JAX package's XLA forward step on general rows
    (``storage_tpu/engines/lsmc.py`` forward_step with
    ``interp_per_sim_general``): (new inventory, new PV)."""
    dm = jax_design_matrix(monomials, x["spot"], x["factors"])
    c_reg = jnp.dot((dm - x["mean"]) / x["std"], x["coeffs"])
    min_rate, max_rate = jax_grid.ratchet_rates(x["ratchet_inv"], x["ratchet_min"],
                                                x["ratchet_max"], is_step, inventory)
    decisions = jax_grid.bang_bang_decisions(min_rate, max_rate, inventory, x["loss_pcnt"],
                                             x["next_min"], x["next_max"], e)
    loss = x["loss_pcnt"] * inventory
    inv_after = inventory[:, None] + decisions - loss[:, None]
    cont = jax_interp.interp_per_sim_general(x["grid_next"], c_reg, inv_after)
    a, b, _ = jax_lsmc._decision_cashflow_coeffs(decisions, x)
    imm = a * x["spot"][:, None] + b - (x["inv_cost_rate"] * inventory * x["df_flow"])[:, None]
    best = jnp.argmax(imm + cont, axis=1)
    take = lambda arr: jnp.take_along_axis(arr, best[:, None], axis=1)[:, 0]  # noqa: E731
    return take(inv_after), pv + take(imm)


@pytest.mark.parametrize("kind", ["random", "bunched", "fixed_spacing", "g2", "g3"])
def test_plain_sweep_on_general_rows_matches_jax(kind):
    """``forward_sweep_plain`` on general rows (the kernel's plain version)
    against the JAX forward step, step by step, in f64."""
    rng = np.random.default_rng(11)
    basis = "1 + s + x0 + s**2 + x0**2"
    n, s, e = 3, 300, 1
    rows = _rows(kind, n=n)
    g = rows.shape[1]
    t = np.arange(n)
    scalars = dict(df_settle=0.98 - 0.01 * t, df_flow=0.97 - 0.01 * t, inj_cost=1.1 + 0.1 * t,
                   wdr_cost=0.8 + 0.05 * t, inj_pcnt=np.full(n, 0.01), wdr_pcnt=np.full(n, 0.02),
                   loss_pcnt=np.full(n, 0.005), inv_cost_rate=0.02 + 0.01 * t,
                   next_min=rows[:, 0].copy(), next_max=rows[:, -1].copy())
    b_dim = len(jax_parse(basis))
    tabs = dict(mean=rng.normal(0.0, 0.3, (n, b_dim)), std=1.0 + rng.uniform(0, 0.3, (n, b_dim)),
                coeffs=rng.normal(0.0, 40.0, (n, b_dim, g)),
                ratchet_inv=np.tile([0.0, 300.0, 900.0], (n, 1)),
                ratchet_min=np.tile([-60.0, -80.0, -100.0], (n, 1)),
                ratchet_max=np.tile([90.0, 70.0, 50.0], (n, 1)),
                spot=30.0 + 5.0 * rng.standard_normal((n, s)), factors=rng.standard_normal((n, 1, s)))
    inv0 = rows[0, 0] + (rows[0, -1] - rows[0, 0]) * rng.uniform(-0.1, 1.1, s)
    tt = lambda a: torch.tensor(a, dtype=torch.float64)  # noqa: E731
    params = tfk.pack_params({k: tt(v) for k, v in scalars.items()}, tt(rows),
                             dtype=torch.float64)
    got_inv, got_pv, _, _ = tfk.forward_sweep_plain(
        params, tt(tabs["mean"]), tt(tabs["std"]), tt(tabs["ratchet_inv"]),
        tt(tabs["ratchet_min"]), tt(tabs["ratchet_max"]), tt(tabs["spot"]), tt(tabs["factors"]),
        tt(inv0), None, tt(tabs["coeffs"]), tuple(parse_basis_functions(basis)), e, False,
        grid=tt(rows))
    inv, pv = jnp.asarray(inv0), jnp.zeros(s)
    monomials = tuple(jax_parse(basis))
    for k in range(n):
        step = {key: jnp.asarray(val[k]) for key, val in {**scalars, **tabs}.items()}
        step["grid_next"] = jnp.asarray(rows[k])
        inv, pv = _jax_forward_step(step, inv, pv, monomials, e, False)
    np.testing.assert_allclose(got_inv.numpy(), np.asarray(inv), rtol=RTOL, atol=1e-9)
    np.testing.assert_allclose(got_pv.numpy(), np.asarray(pv), rtol=RTOL,
                               atol=RTOL * float(np.abs(np.asarray(pv)).max()))
