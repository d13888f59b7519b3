"""Path-parallel LSMC of storage_tpu_torch (``parallel.mesh``) on the CPU: two
gloo processes (``tests/_torch_distributed_worker.py``, one spawn for the
whole file) against the JAX package's ``sharded_lsmc_core`` on a 2-device
mesh, at ``tests/test_sharding.py``'s case (40 steps, 30 grid points, 256
sims, f64).

* World 2 against JAX ``make_mesh(2)``: NPV and SE within 1e-9 relative,
  deltas, profiles and triggers within rtol 1e-8; every reduced output the
  same bits on both ranks; also at a 20-term basis, past the register
  kernels' 16 (kernel B's and C's wide routes on the card), whose moments
  the group sums as it does within the caps.  The same for ``lsmc_core_from_sims`` and both
  sharded adjoints (``sharded_ad_deltas``, ``sharded_ad_deltas_from_sims``).
* Streamed against materialised in world 2: the same bits; the route
  agreed when only one rank's threshold is below its share.
* Antithetic draws with an odd share (129 a rank): the pair (128, 129)
  spans the ranks and each rank's paths are the single process's columns to
  the bit; the valuation within 1e-9 of the single process's.
* A group of one against no group: every output the same bits.
* A path count that does not divide the group, and ``fullstep`` in a group
  of two, raise ``ValueError`` on every rank.
"""
import datetime
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 1)[0])
import _torch_distributed_worker as worker  # noqa: E402
from test_sharding import build_case as jax_case  # noqa: E402

from storage_tpu.basis import parse_basis_functions as jax_parse  # noqa: E402
from storage_tpu.models.spot_sim import simulate_ou_paths as jax_simulate  # noqa: E402
from storage_tpu.parallel import mesh as jax_mesh  # noqa: E402
from storage_tpu_torch.models import spot_sim  # noqa: E402
from storage_tpu_torch.parallel import distributed as pdist  # noqa: E402
from storage_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from storage_tpu_torch.parallel import reduce as preduce  # noqa: E402

torch.set_num_threads(1)

SIMS = worker.SHARDED_SIMS
SCALARS = ("npv", "standard_error", "backward_npv")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case of the sharding suite on two gloo ranks: {case: [rank 0's
    outputs, rank 1's]}."""
    return worker.spawn("sharding", str(tmp_path_factory.mktemp("sharding")))


@pytest.fixture(scope="module")
def jax_inputs():
    return jax_case()


def _jax_sharded(jax_inputs, **kwargs):
    inputs, arrays, sim_inputs, monomials = jax_inputs
    return jax_mesh.sharded_lsmc_core(
        jax_mesh.make_mesh(2), arrays, sim_inputs, jax.random.key(7), jax.random.key(9), SIMS,
        inputs.starting_inventory, monomials, num_extra_decisions=0, discount_deltas=False,
        terminal_fn=kwargs.pop("terminal_fn", None), ratchet_is_step=False, **kwargs)


def _jax_panels(jax_inputs):
    _, _, sim_inputs, _ = jax_inputs
    args = [sim_inputs[k] for k in ("decay", "chol", "vols", "half_var", "fwd")]
    reg, val = (jax_simulate(jax.random.key(seed), jnp.arange(SIMS), *args) for seed in (7, 9))
    return reg.spot, reg.factors, val.spot, val.factors


def _assert_close(got: dict, want: dict, keys=worker.RESULT_KEYS):
    for k in keys:
        w = np.asarray(want[k], dtype=np.float64)
        if k in SCALARS:
            assert float(got[k]) == pytest.approx(float(w), rel=1e-9), k
        else:
            scale = np.nanmax(np.abs(w)) if np.isfinite(w).any() else 1.0
            np.testing.assert_allclose(got[k], w, rtol=1e-8, atol=1e-8 * scale, equal_nan=True,
                                       err_msg=k)


def _same_bits(a: dict, b: dict, keys=worker.RESULT_KEYS):
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_world2_matches_jax_sharded(ranks, jax_inputs):
    _assert_close(ranks["sharded"][0], _jax_sharded(jax_inputs))


def test_world2_20_terms_matches_jax_sharded(ranks, jax_inputs):
    inputs, arrays, sim_inputs, _ = jax_inputs
    monomials = tuple(jax_parse(worker.BASIS_20))
    assert len(monomials) == 20
    _assert_close(ranks["sharded_20_terms"][0],
                  _jax_sharded((inputs, arrays, sim_inputs, monomials)))


@pytest.mark.parametrize("case", ["sharded", "streamed", "sharded_20_terms", "routed", "antithetic",
                                  "from_sims"])
def test_ranks_hold_the_same_bits(ranks, case):
    _same_bits(*ranks[case])


def test_world2_streamed_is_materialised_to_the_bit(ranks):
    for rank in (0, 1):
        _same_bits(ranks["streamed"][rank], ranks["sharded"][rank])


def test_route_agreed_by_every_rank(ranks):
    """Only rank 1's threshold lies below its share; both ranks stream, to
    the materialised bits."""
    assert [int(r["streamed"]) for r in ranks["routed"]] == [1, 1]
    _same_bits(ranks["routed"][0], ranks["sharded"][0])


def test_per_sim_panels_stay_on_their_rank(ranks, jax_inputs):
    want = _jax_sharded(jax_inputs, return_sim_data=True)
    got = np.concatenate([r["sim_inventory"] for r in ranks["per_sim"]], axis=1)
    assert [r["sim_inventory"].shape for r in ranks["per_sim"]] == [(41, SIMS // 2)] * 2
    np.testing.assert_allclose(got[0], 100.0)
    np.testing.assert_allclose(got, np.asarray(want["sim_inventory"]), rtol=1e-8, atol=1e-6)
    pv = np.concatenate([r["sim_pv"] for r in ranks["per_sim"]], axis=1)
    assert float(pv.sum(axis=0).mean()) == pytest.approx(float(want["npv"]), rel=1e-9)


def test_antithetic_pair_spans_the_ranks(ranks):
    inputs, arrays, sim_inputs, monomials = worker.sharding_case()
    args = [sim_inputs[k] for k in ("decay", "chol", "vols", "half_var", "fwd")]
    paths = spot_sim.simulate_ou_paths(spot_sim.key_from_seed(7),
                                       torch.arange(worker.ANTITHETIC_SIMS), *args,
                                       antithetic=True)
    whole = paths.spot.numpy()
    ids = [r["ids"] for r in ranks["antithetic"]]
    assert ids[0][-1] == 128 and ids[1][0] == 129 and len(ids[0]) % 2 == 1
    for r, rank_ids in zip(ranks["antithetic"], ids):
        np.testing.assert_array_equal(r["spot"], whole[:, rank_ids])
    # Path 129 (rank 1) takes path 128's draws (rank 0) negated: its first
    # factor state is the negation.
    first = paths.factors[0].numpy()
    np.testing.assert_array_equal(first[:, 129], -first[:, 128])
    single = worker._engine_out(worker._sharded(num_sims=worker.ANTITHETIC_SIMS, antithetic=True))
    _assert_close(ranks["antithetic"][0], single)


def test_sharded_adjoint_matches_jax(ranks, jax_inputs):
    inputs, arrays, sim_inputs, monomials = jax_inputs
    want_npv, want = jax_mesh.sharded_ad_deltas(
        jax_mesh.make_mesh(2), arrays, sim_inputs, jax.random.key(7), jax.random.key(9), SIMS,
        inputs.starting_inventory, monomials, 0, True, worker.terminal, False)
    for r in ranks["adjoint"]:
        assert float(r["npv"]) == pytest.approx(float(want_npv), rel=1e-9)
        want = np.asarray(want)
        np.testing.assert_allclose(r["deltas"], want, rtol=1e-8, atol=1e-8 * np.abs(want).max())
    _same_bits(*ranks["adjoint"], keys=("npv", "deltas"))


def test_lsmc_core_from_sims_matches_jax(ranks, jax_inputs):
    inputs, arrays, _, monomials = jax_inputs
    want = jax_mesh.lsmc_core_from_sims(
        arrays, *_jax_panels(jax_inputs), inputs.starting_inventory, monomials, 0, False,
        worker.terminal, False, mesh=jax_mesh.make_mesh(2))
    _assert_close(ranks["from_sims"][1], want)


def test_sharded_ad_deltas_from_sims_matches_jax(ranks, jax_inputs):
    inputs, arrays, _, monomials = jax_inputs
    want_npv, want = jax_mesh.sharded_ad_deltas_from_sims(
        arrays, *_jax_panels(jax_inputs), inputs.starting_inventory, monomials, 0, False,
        worker.terminal, False, mesh=jax_mesh.make_mesh(2))
    want = np.asarray(want)
    for r in ranks["ad_from_sims"]:
        assert float(r["npv"]) == pytest.approx(float(want_npv), rel=1e-9)
        np.testing.assert_allclose(r["deltas"], want, rtol=1e-8, atol=1e-8 * np.abs(want).max())
    _same_bits(*ranks["ad_from_sims"], keys=("npv", "deltas"))


@pytest.mark.parametrize("case,match", [("indivisible", "pad_num_sims"),
                                        ("fullstep", "fullstep runs on one device")])
def test_refused_on_every_rank(ranks, case, match):
    for r in ranks[case]:
        assert "ValueError" in str(r["error"]) and match in str(r["error"])


def test_group_of_one_keeps_the_bits():
    """A gloo group of one rank in this process: the sharded engine, its
    adjoint and its streamed route give the no-group run's bits."""
    want = worker._engine_out(worker._sharded())
    want_streamed = worker._engine_out(worker._sharded(stream=True))
    pdist.initialize(f"localhost:{worker.free_port()}", 1, 0, backend="gloo",
                     timeout=datetime.timedelta(seconds=60))
    try:
        assert pmesh.make_mesh() is not None and preduce.active(pmesh.make_mesh()) is None
        got = worker._engine_out(worker._sharded())
        got_streamed = worker._engine_out(worker._sharded(stream=True))
    finally:
        torch.distributed.destroy_process_group()
    _same_bits(got, want)
    _same_bits(got_streamed, want_streamed)


def test_mesh_helpers_without_a_group():
    assert pmesh.make_mesh() is None and pmesh.make_mesh(1) is None
    with pytest.raises(ValueError, match="initialize"):
        pmesh.make_mesh(2)
    assert pmesh.pad_num_sims(255, 2) == 256 and pmesh.pad_num_sims(256, 8) == 256
    assert pmesh.local_sims(256, None) == 256
    assert torch.equal(pmesh.path_ids(5, None, "cpu"), torch.arange(5))
    x = torch.arange(6, dtype=torch.float64).reshape(2, 3)
    assert preduce.psum(x, None) is x and preduce.pmean(x, None) is x
    assert torch.equal(preduce.global_mean_over_sims(x, None), x.mean(dim=-1))
    assert preduce.any_rank(True, None) and not preduce.any_rank(False, None)
    assert not pmesh.streams(pmesh.footprint_bytes(365, 1000, 3, 100, 4), "cpu", None)
    assert pmesh.streams(pmesh.footprint_bytes(365, 1_048_576, 3, 100, 4), "cpu", None)
