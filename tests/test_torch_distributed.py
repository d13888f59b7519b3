"""Multi-process valuation through the API of storage_tpu_torch
(``parallel.distributed``, ``value_from_sims_host_local``) on the CPU: two
gloo processes (``tests/_torch_distributed_worker.py``, one spawn for the
whole file) against the JAX package in one process, at
``tests/test_distributed.py``'s cases (the ratcheted 59-day facility, 64
sims, f64).

* ``value_from_sims_host_local`` over each process's block of the panels
  against JAX ``value_from_sims`` on all of them (NPV and SE within 1e-9
  relative, deltas and profile within rtol 1e-8), pathwise and adjoint, and
  its trigger prices against the port's single process (rtol 1e-8: the two
  packages settle a near-tie of this facility's withdrawal trigger apart,
  as ``tests/test_torch_host_streamed_panels.py`` notes);
  ``value_from_sims`` on the whole panel in a group takes each rank's
  block, to the same bits; blocks of two shapes raise on every rank.
* ``multi_factor_value`` in a group of two against the JAX single-process
  run, pathwise and adjoint (the adjoint's NPV the pathwise bits, its
  deltas the pathwise series); streamed when one rank's threshold is below
  its share, to the same bits; interactive, to the same bits with the same
  progress marks as one process; a cancel polled on rank 1 stops both ranks
  at the same mark; only rank 0 writes the checkpoint; per-sim panels and
  an indivisible path count raise on every rank.
* The helpers in a group (rank 0's copy of each rank's values) and outside
  one; a group of one gives the single process's bits; a group that does
  not form raises.
"""
import datetime
import os
import sys

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 1)[0])
import _torch_distributed_worker as worker  # noqa: E402
from _distributed_worker import build_case as jax_case  # noqa: E402

import storage_tpu as jpkg  # noqa: E402
from storage_tpu_torch.parallel import distributed as pdist  # noqa: E402

torch.set_num_threads(1)

F64 = jnp.float64
SIMS = worker.HOST_LOCAL_SIMS


@pytest.fixture(scope="module")
def out_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("distributed"))


@pytest.fixture(scope="module")
def ranks(out_dir):
    """Every case of the API suite on two gloo ranks: {case: [rank 0's
    outputs, rank 1's]}."""
    return worker.spawn("distributed", out_dir)


def _jax_from_sims(**kwargs):
    storage, val_date, fwd, frames, basis = jax_case(SIMS)
    spot, factors = frames(list(range(SIMS)))
    return worker._results_out(jpkg.value_from_sims(
        storage, val_date, 500.0, fwd, 0.03, None, spot, spot, basis, False,
        sim_factors_regress=factors, sim_factors_valuation=factors, num_inventory_grid_points=30,
        dtype=F64, **kwargs))


def _jax_multi_factor(**kwargs):
    storage, val_date, fwd, _, _ = jax_case(8)
    return worker._results_out(jpkg.multi_factor_value(
        storage, val_date, 500.0, fwd, 0.03, None, [(5.0, pd.Series(0.6, index=fwd.index))],
        None, SIMS, "1 + s + x0", False, seed=7, fwd_sim_seed=9, num_inventory_grid_points=30,
        dtype=F64, **kwargs))


def _assert_close(got, want, arrays=("deltas", "profile")):
    for k in ("npv", "standard_error", "intrinsic_npv"):
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-9), k
    for k in arrays:
        w = np.asarray(want[k], dtype=np.float64)
        np.testing.assert_allclose(got[k], w, rtol=1e-8, atol=1e-8 * np.nanmax(np.abs(w)),
                                   equal_nan=True, err_msg=k)


def _same_bits(a, b, keys=("npv", "standard_error", "deltas", "profile", "triggers")):
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_host_local_matches_jax_value_from_sims(ranks):
    _assert_close(ranks["host_local"][0], _jax_from_sims())


def test_host_local_adjoint_matches_jax(ranks):
    got = ranks["host_local_adjoint"]
    _assert_close(got[1], _jax_from_sims(deltas_method="adjoint"))
    _same_bits(got[0], ranks["host_local"][0], keys=("npv", "standard_error", "profile"))
    scale = max(1.0, float(np.abs(ranks["host_local"][0]["deltas"]).max()))
    assert np.abs(got[0]["deltas"] - ranks["host_local"][0]["deltas"]).max() < 1e-6 * scale


@pytest.mark.parametrize("case", ["host_local", "host_local_adjoint", "value_from_sims",
                                  "multi_factor", "multi_factor_adjoint", "multi_factor_streamed",
                                  "interactive", "checkpoint"])
def test_ranks_hold_the_same_bits(ranks, case):
    _same_bits(*ranks[case])


@pytest.mark.parametrize("case,single", [
    ("host_local", lambda: worker._host_local(0, 1)),
    ("multi_factor", worker._multi_factor),
    ("multi_factor_adjoint", lambda: worker._multi_factor(deltas_method="adjoint")),
])
def test_group_of_two_matches_one_process(ranks, case, single):
    """Every output, the trigger prices too, against the port in one
    process on the same paths."""
    _assert_close(ranks[case][0], worker._results_out(single()),
                  arrays=("deltas", "profile", "triggers"))


def test_value_from_sims_in_a_group_takes_each_ranks_block(ranks):
    _same_bits(ranks["value_from_sims"][0], ranks["host_local"][0])


def test_multi_factor_matches_jax_single_process(ranks):
    _assert_close(ranks["multi_factor"][0], _jax_multi_factor())


def test_multi_factor_adjoint(ranks):
    """The adjoint's NPV is the pricing run's; its deltas are the pathwise
    series (the envelope identity) and the JAX package's adjoint ones."""
    got, pathwise = ranks["multi_factor_adjoint"][0], ranks["multi_factor"][0]
    _same_bits(got, pathwise, keys=("npv", "standard_error", "profile"))
    scale = max(1.0, float(np.abs(pathwise["deltas"]).max()))
    assert np.abs(got["deltas"] - pathwise["deltas"]).max() < 1e-6 * scale
    _assert_close(got, _jax_multi_factor(deltas_method="adjoint"))


@pytest.mark.parametrize("case", ["multi_factor_streamed", "interactive", "checkpoint"])
def test_route_and_callbacks_keep_the_bits(ranks, case):
    """Streamed (agreed from one rank's threshold), interactive and
    checkpointing runs in a group give the plain run's bits."""
    _same_bits(ranks[case][0], ranks["multi_factor"][0])


def test_interactive_marks_are_one_process_marks(ranks):
    marks = []
    worker._multi_factor(on_progress_update=marks.append)
    for r in ranks["interactive"]:
        np.testing.assert_array_equal(r["marks"], marks)


def test_cancel_on_one_rank_stops_every_rank_at_one_mark(ranks):
    """Rank 1's poll turns true at its sixth call (the fourth backward
    segment's mark): both ranks raise there, having reported the same five
    marks."""
    got = ranks["cancel"]
    assert [int(r["cancelled"]) for r in got] == [1, 1]
    np.testing.assert_array_equal(got[0]["marks"], got[1]["marks"])
    assert len(got[0]["marks"]) == 5 and got[0]["marks"][:2].tolist() == [0.2, 0.3]


def test_only_rank_zero_writes_the_checkpoint(ranks, out_dir):
    assert os.path.exists(os.path.join(out_dir, "regression_checkpoint.rank0.npz"))
    assert not os.path.exists(os.path.join(out_dir, "regression_checkpoint.rank1.npz"))


@pytest.mark.parametrize("case,match", [
    ("sim_data", "not available in a group of processes"),
    ("api_indivisible", "pad_num_sims"),
    ("shape_mismatch", "shapes differ across processes"),
])
def test_refused_on_every_rank(ranks, case, match):
    for r in ranks[case]:
        assert "ValueError" in str(r["error"]) and match in str(r["error"])


def test_helpers_in_a_group(ranks):
    for rank, r in enumerate(ranks["helpers"]):
        assert int(r["count"]) == 2 and int(r["index"]) == rank and int(r["initialized"]) == 1
        np.testing.assert_array_equal(r["a"], np.zeros(3, np.float32))
        np.testing.assert_array_equal(r["b0"], np.arange(2))
        assert float(r["b1"]) == 7.0 and r["key"].tolist() == [1, 2]


def test_helpers_outside_a_group():
    assert not pdist.is_initialized()
    assert pdist.process_count() == 1 and pdist.process_index() == 0
    assert pdist.global_mesh() is None
    tree = {"a": np.ones(3), "b": 2.0}
    assert pdist.replicate_to_global(tree) is tree
    assert pdist.replicate_key((3, 4)) == (3, 4)
    spot, factors = np.ones((5, 16)), np.zeros((5, 1, 16))
    got = pdist.host_local_sims_to_global(spot, factors)
    assert got[0] is spot and got[1] is factors


def test_group_of_one_keeps_the_bits():
    want = worker._results_out(worker._multi_factor())
    want_local = worker._results_out(worker._host_local(0, 1))
    pdist.initialize(f"localhost:{worker.free_port()}", 1, 0, backend="gloo",
                     timeout=datetime.timedelta(seconds=60))
    try:
        got = worker._results_out(worker._multi_factor())
        got_local = worker._results_out(worker._host_local(0, 1))
    finally:
        torch.distributed.destroy_process_group()
    _same_bits(got, want)
    _same_bits(got_local, want_local)


def test_group_that_does_not_form_raises(monkeypatch):
    """Two processes asked for and one present: the group times out and
    raises; nothing runs on one rank."""
    with pytest.raises(Exception, match="[Tt]imed out|clients"):
        pdist.initialize(f"localhost:{worker.free_port()}", 2, 0, backend="gloo",
                         timeout=datetime.timedelta(seconds=2))
    assert not pdist.is_initialized()
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError):
        pdist.initialize(backend="gloo")
    with pytest.raises(ValueError, match="num_processes"):
        pdist.initialize("localhost:1234")
    assert not pdist.is_initialized()


def test_f32_frames_give_contiguous_panels():
    """Frames of f32 values (as a rank builds from its simulated block) come
    out of pandas in Fortran order; the API's arrays are C order, the
    layout the kernels take."""
    from storage_tpu_torch import api_lsmc

    storage, val_date, fwd, frames, _ = worker.host_local_case(8)
    spot, factors = frames(list(range(8)))
    inputs = api_lsmc.prepare_valuation(storage, val_date, 500.0, fwd, 0.03, None)
    spot32 = spot.astype(np.float32)
    arrays = api_lsmc._frames_to_sims(spot32, [f.astype(np.float32) for f in factors], inputs,
                                      "regress", torch.float32)
    for a in arrays:
        assert a.flags["C_CONTIGUOUS"] and a.dtype == np.float32
    np.testing.assert_array_equal(arrays[0], spot32.reindex(inputs.periods).to_numpy())
