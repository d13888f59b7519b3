"""Worker of the two-process tests of storage_tpu_torch's path-parallel
engine (``tests/test_torch_sharding.py``, ``tests/test_torch_distributed.py``).

Launched as
``python tests/_torch_distributed_worker.py <suite> <rank> <world> <port> <out_dir>``:
forms a gloo group of ``world`` processes on the CPU
(``parallel.distributed.initialize``), runs every case of ``suite`` in turn
and writes each case's outputs to ``<out_dir>/<case>.rank<r>.npz`` (an
``error`` entry, the exception's type and message, where the case raised).
It imports neither JAX nor pytest; the cases' inputs are made here with the
port, from the same numbers as the JAX package's tests (``sharding_case``:
``tests/test_sharding.build_case``; ``host_local_case``:
``tests/_distributed_worker.build_case``), so the test files import them too.
"""
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARDED_SIMS = 256
ANTITHETIC_SIMS = 258  # 129 a rank: the pair (128, 129) spans the two ranks
HOST_LOCAL_SIMS = 64
RESULT_KEYS = (
    "npv", "standard_error", "backward_npv", "deltas", "profile_inventory",
    "profile_inject_withdraw", "profile_cmdty_consumed", "profile_inventory_loss", "profile_pv",
    "trigger_inject_volumes", "trigger_inject_prices", "trigger_withdraw_volumes",
    "trigger_withdraw_prices", "max_inject_volume", "max_inject_trigger_price",
    "max_withdraw_volume", "max_withdraw_trigger_price", "withdraw_max_volume_price",
)


def terminal(price, inventory):
    return price * inventory * 0.5


def sharding_case(num_steps=40, num_grid=30):
    """The port's inputs of ``tests/test_sharding.build_case`` in f64 on the
    CPU: (inputs, engine arrays, OU tables, monomials)."""
    import numpy as np
    import pandas as pd
    import torch

    from storage_tpu_torch import CmdtyStorage
    from storage_tpu_torch.basis import parse_basis_functions
    from storage_tpu_torch.engines import lsmc as lsmc_engine
    from storage_tpu_torch.models import multi_factor as mf
    from storage_tpu_torch.parallel import mesh as pmesh
    from storage_tpu_torch.valuation_inputs import prepare_valuation

    storage = CmdtyStorage(
        "D", "2021-01-01", pd.Period("2021-01-01", freq="D") + num_steps, 0.9, 0.7,
        min_inventory=0.0, max_inventory=5_000.0,
        max_injection_rate=300.0, max_withdrawal_rate=300.0,
    )
    idx = pd.period_range("2021-01-01", storage.end, freq="D")
    i = np.arange(len(idx))
    fwd = pd.Series(index=idx, data=30.0 + 6 * np.sin(2 * np.pi * i / 30.0))
    inputs = prepare_valuation(storage, "2021-01-01", 100.0, fwd, 0.02, None)
    vol_curve = pd.Series(index=idx.copy(), data=0.8)
    lt_curve = pd.Series(index=idx.copy(), data=0.2)
    pre = mf.simulation_precompute([(10.0, vol_curve), (0.0, lt_curve)], 0.4, inputs.val_day,
                                   list(inputs.periods), "D")
    arrays = lsmc_engine.build_engine_arrays(
        inputs.compiled, inputs.fwd, inputs.df_settle, inputs.df_flow, inputs.inventory_lower,
        inputs.inventory_upper, num_grid, torch.float64, "cpu")
    sim_inputs = pmesh.sim_inputs_from_precompute(pre, inputs.fwd, torch.float64, "cpu")
    return inputs, arrays, sim_inputs, tuple(parse_basis_functions("1 + x0 + x0**2 + x1 + s"))


def host_local_case(num_sims_global: int):
    """The port's form of ``tests/_distributed_worker.build_case``: the
    ratcheted facility, its curve, the full numpy panels (seed 42) as
    ``frames(cols)`` and the basis."""
    import numpy as np
    import pandas as pd

    import storage_tpu_torch as tpkg

    storage = tpkg.CmdtyStorage(
        "D", "2021-02-01", "2021-04-01", 0.7, 0.5,
        ratchets=[("2021-02-01", [(0.0, -250.0, 380.0), (3_000.0, -330.0, 260.0),
                                  (6_000.0, -400.0, 190.0)])],
        ratchet_interp=tpkg.RatchetInterp.LINEAR,
    )
    val_date = "2021-02-01"
    idx = pd.period_range(val_date, "2021-04-01", freq="D")
    i = np.arange(len(idx))
    fwd = pd.Series(index=idx, data=28.0 + 6.0 * np.sin(2 * np.pi * i / 59.0))
    rng = np.random.default_rng(42)
    n = len(idx)
    z = rng.standard_normal((n, num_sims_global))
    x = 0.25 * np.cumsum(z, axis=0) / np.sqrt(np.arange(1, n + 1))[:, None]
    spot = fwd.to_numpy()[:, None] * np.exp(x - 0.5 * 0.25**2)

    def frames(cols):
        return pd.DataFrame(spot[:, cols], index=idx), [pd.DataFrame(x[:, cols], index=idx)]

    return storage, val_date, fwd, frames, "1 + s + s**2 + x0"


def _engine_out(result) -> dict:
    return {k: result[k].detach().numpy() for k in RESULT_KEYS}


def _results_out(res) -> dict:
    import numpy as np

    return {"npv": np.float64(res.npv), "standard_error": np.float64(res.val_sim_standard_error),
            "deltas": res.deltas.to_numpy(), "profile": res.expected_profile.to_numpy(),
            "triggers": res.trigger_prices.to_numpy(), "intrinsic_npv": np.float64(res.intrinsic_npv)}


# ---- the engine's cases (tests/test_torch_sharding.py)

# The full cubic in the spot and the case's two factors: 20 terms, past the
# register kernels' 16 (kernel B's and C's wide routes on the card).
BASIS_20 = ("1 + s + x0 + x1 + s**2 + x0**2 + x1**2 + s*x0 + s*x1 + x0*x1 + s**3 + x0**3 + x1**3 "
            "+ s**2*x0 + s**2*x1 + s*x0**2 + x0**2*x1 + s*x1**2 + x0*x1**2 + s*x0*x1")


def _sharded(**kwargs):
    from storage_tpu_torch.basis import parse_basis_functions
    from storage_tpu_torch.models import spot_sim
    from storage_tpu_torch.parallel import mesh as pmesh

    inputs, arrays, sim_inputs, monomials = sharding_case()
    if "basis" in kwargs:
        monomials = tuple(parse_basis_functions(kwargs.pop("basis")))
    num_sims = kwargs.pop("num_sims", SHARDED_SIMS)
    return pmesh.sharded_lsmc_core(
        pmesh.make_mesh(), arrays, sim_inputs, spot_sim.key_from_seed(7),
        spot_sim.key_from_seed(9), num_sims, inputs.starting_inventory, monomials, 0, False,
        kwargs.pop("terminal_fn", None), False, **kwargs)


def case_sharded(rank, out_dir):
    return _engine_out(_sharded())


def case_streamed(rank, out_dir):
    return _engine_out(_sharded(stream=True))


def case_sharded_20_terms(rank, out_dir):
    return _engine_out(_sharded(basis=BASIS_20))


def case_routed(rank, out_dir):
    """Rank 1's threshold below its share, rank 0's above: every rank must
    stream (the route is agreed)."""
    import numpy as np

    from storage_tpu_torch.engines import lsmc as lsmc_engine
    from storage_tpu_torch.parallel import mesh as pmesh

    calls = []
    saved = pmesh.STREAM_THRESHOLD_BYTES, lsmc_engine.streamed_sims
    if rank == 1:
        pmesh.STREAM_THRESHOLD_BYTES = 1024
    lsmc_engine.streamed_sims = lambda *a, **k: calls.append(1) or saved[1](*a, **k)
    try:
        out = _engine_out(_sharded())
    finally:
        pmesh.STREAM_THRESHOLD_BYTES, lsmc_engine.streamed_sims = saved
    return {**out, "streamed": np.int64(len(calls))}


def case_per_sim(rank, out_dir):
    res = _sharded(return_sim_data=True)
    return {"npv": res["npv"].numpy(), "sim_inventory": res["sim_inventory"].numpy(),
            "sim_pv": res["sim_pv"].numpy()}


def case_antithetic(rank, out_dir):
    from storage_tpu_torch.models import spot_sim
    from storage_tpu_torch.parallel import mesh as pmesh

    inputs, arrays, sim_inputs, monomials = sharding_case()
    ids = pmesh.path_ids(ANTITHETIC_SIMS, pmesh.make_mesh(), "cpu")
    args = [sim_inputs[k] for k in ("decay", "chol", "vols", "half_var", "fwd")]
    spot = spot_sim.simulate_ou_paths(spot_sim.key_from_seed(7), ids, *args, antithetic=True).spot
    out = _engine_out(_sharded(num_sims=ANTITHETIC_SIMS, antithetic=True))
    return {**out, "ids": ids.numpy(), "spot": spot.numpy()}


def case_adjoint(rank, out_dir):
    import numpy as np

    from storage_tpu_torch.models import spot_sim
    from storage_tpu_torch.parallel import mesh as pmesh

    inputs, arrays, sim_inputs, monomials = sharding_case()
    npv, deltas = pmesh.sharded_ad_deltas(
        pmesh.make_mesh(), arrays, sim_inputs, spot_sim.key_from_seed(7),
        spot_sim.key_from_seed(9), SHARDED_SIMS, inputs.starting_inventory, monomials, 0, True,
        terminal, False)
    return {"npv": np.float64(npv), "deltas": deltas.numpy()}


def _rank_panels():
    from storage_tpu_torch.models import spot_sim
    from storage_tpu_torch.parallel import mesh as pmesh

    inputs, arrays, sim_inputs, monomials = sharding_case()
    ids = pmesh.path_ids(SHARDED_SIMS, pmesh.make_mesh(), "cpu")
    args = [sim_inputs[k] for k in ("decay", "chol", "vols", "half_var", "fwd")]
    reg, val = (spot_sim.simulate_ou_paths(spot_sim.key_from_seed(seed), ids, *args)
                for seed in (7, 9))
    return inputs, arrays, monomials, (reg.spot, reg.factors, val.spot, val.factors)


def case_from_sims(rank, out_dir):
    from storage_tpu_torch.parallel import mesh as pmesh

    inputs, arrays, monomials, panels = _rank_panels()
    return _engine_out(pmesh.lsmc_core_from_sims(
        arrays, *panels, inputs.starting_inventory, monomials, 0, False, terminal, False))


def case_ad_from_sims(rank, out_dir):
    import numpy as np

    from storage_tpu_torch.parallel import mesh as pmesh

    inputs, arrays, monomials, panels = _rank_panels()
    npv, deltas = pmesh.sharded_ad_deltas_from_sims(
        arrays, *panels, inputs.starting_inventory, monomials, 0, False, terminal, False)
    return {"npv": np.float64(npv), "deltas": deltas.numpy()}


def case_indivisible(rank, out_dir):
    return _engine_out(_sharded(num_sims=SHARDED_SIMS - 1))


def case_fullstep(rank, out_dir):
    return _engine_out(_sharded(fullstep=True))


# ---- the API's cases (tests/test_torch_distributed.py)

def _host_local(rank, world, num_sims=HOST_LOCAL_SIMS, **kwargs):
    import torch

    import storage_tpu_torch as tpkg

    storage, val_date, fwd, frames, basis = host_local_case(num_sims)
    s_local = num_sims // world
    spot, factors = frames(list(range(rank * s_local, (rank + 1) * s_local)))
    return tpkg.value_from_sims_host_local(
        storage, val_date, 500.0, fwd, 0.03, None, spot, spot, basis, False,
        sim_factors_regress=factors, sim_factors_valuation=factors, num_inventory_grid_points=30,
        dtype=torch.float64, device="cpu", **kwargs)


def _multi_factor(num_sims=HOST_LOCAL_SIMS, **kwargs):
    import pandas as pd
    import torch

    import storage_tpu_torch as tpkg

    storage, val_date, fwd, _, _ = host_local_case(8)
    return tpkg.multi_factor_value(
        storage, val_date, 500.0, fwd, 0.03, None, [(5.0, pd.Series(0.6, index=fwd.index))],
        None, num_sims, "1 + s + x0", False, seed=7, fwd_sim_seed=9,
        num_inventory_grid_points=30, dtype=torch.float64, device="cpu", **kwargs)


def case_host_local(rank, out_dir):
    return _results_out(_host_local(rank, 2))


def case_host_local_adjoint(rank, out_dir):
    return _results_out(_host_local(rank, 2, deltas_method="adjoint"))


def case_value_from_sims(rank, out_dir):
    """``value_from_sims`` on the whole panel in a group: each rank its own
    block of the columns."""
    import torch

    import storage_tpu_torch as tpkg

    storage, val_date, fwd, frames, basis = host_local_case(HOST_LOCAL_SIMS)
    spot, factors = frames(list(range(HOST_LOCAL_SIMS)))
    return _results_out(tpkg.value_from_sims(
        storage, val_date, 500.0, fwd, 0.03, None, spot, spot, basis, False,
        sim_factors_regress=factors, sim_factors_valuation=factors, num_inventory_grid_points=30,
        dtype=torch.float64, device="cpu"))


def case_shape_mismatch(rank, out_dir):
    """Blocks of 32 and 33 paths (column 31 in both): refused on every rank."""
    import torch

    import storage_tpu_torch as tpkg

    storage, val_date, fwd, frames, basis = host_local_case(HOST_LOCAL_SIMS)
    spot, factors = frames(list(range(31 * rank, 32 + 32 * rank)))
    return _results_out(tpkg.value_from_sims_host_local(
        storage, val_date, 500.0, fwd, 0.03, None, spot, spot, basis, False,
        sim_factors_regress=factors, sim_factors_valuation=factors, num_inventory_grid_points=30,
        dtype=torch.float64, device="cpu"))


def case_multi_factor(rank, out_dir):
    return _results_out(_multi_factor())


def case_multi_factor_adjoint(rank, out_dir):
    return _results_out(_multi_factor(deltas_method="adjoint"))


def case_multi_factor_streamed(rank, out_dir):
    """Rank 0's threshold below its share: both ranks stream."""
    from storage_tpu_torch.parallel import mesh as pmesh

    saved = pmesh.STREAM_THRESHOLD_BYTES
    if rank == 0:
        pmesh.STREAM_THRESHOLD_BYTES = 1024
    try:
        return _results_out(_multi_factor())
    finally:
        pmesh.STREAM_THRESHOLD_BYTES = saved


def case_interactive(rank, out_dir):
    import numpy as np

    marks = []
    res = _multi_factor(on_progress_update=marks.append)
    return {**_results_out(res), "marks": np.asarray(marks)}


def case_cancel(rank, out_dir):
    """Rank 1's poll turns true at its 6th call; rank 0 only reports
    progress.  Both must stop at the same mark."""
    import numpy as np

    from storage_tpu_torch import JobCancelledError

    marks, polls = [], []

    def poll():
        polls.append(1)
        return len(polls) > 5

    try:
        _multi_factor(on_progress_update=marks.append,
                      cancellation_poll=poll if rank == 1 else None)
    except JobCancelledError:
        return {"cancelled": np.int64(1), "marks": np.asarray(marks)}
    return {"cancelled": np.int64(0), "marks": np.asarray(marks)}


def case_checkpoint(rank, out_dir):
    path = os.path.join(out_dir, f"regression_checkpoint.rank{rank}.npz")
    return _results_out(_multi_factor(checkpoint_path=path))


def case_sim_data(rank, out_dir):
    from storage_tpu_torch import SimulationDataReturned

    return _results_out(_multi_factor(sim_data_returned=SimulationDataReturned.PV))


def case_api_indivisible(rank, out_dir):
    return _results_out(_multi_factor(num_sims=HOST_LOCAL_SIMS - 1))


def case_helpers(rank, out_dir):
    """The group's helpers: its size and rank, rank 0's copy of a rank's own
    values, a key."""
    import numpy as np
    import torch

    from storage_tpu_torch.parallel import distributed as pdist

    tree = {"a": torch.full((3,), float(rank)), "b": [np.arange(2) + rank, 7.0]}
    got = pdist.replicate_to_global(tree)
    key = pdist.replicate_key((rank + 1, rank + 2))
    return {"count": np.int64(pdist.process_count()), "index": np.int64(pdist.process_index()),
            "a": got["a"].numpy(), "b0": got["b"][0], "b1": np.float64(got["b"][1]),
            "key": np.asarray(key), "initialized": np.int64(pdist.is_initialized())}


SUITES = {
    "sharding": (case_sharded, case_streamed, case_sharded_20_terms, case_routed, case_per_sim,
                 case_antithetic, case_adjoint, case_from_sims, case_ad_from_sims,
                 case_indivisible, case_fullstep),
    "distributed": (case_host_local, case_host_local_adjoint, case_value_from_sims,
                    case_shape_mismatch, case_multi_factor, case_multi_factor_adjoint,
                    case_multi_factor_streamed, case_interactive, case_cancel, case_checkpoint,
                    case_sim_data, case_api_indivisible, case_helpers),
}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(suite: str, out_dir: str, world: int = 2, timeout: float = 300.0) -> dict:
    """Runs ``suite`` in ``world`` worker processes (a free port, a timeout
    for all: on expiry every process is killed and ``RuntimeError``
    raised) and returns {case: [each rank's outputs]}."""
    import subprocess

    import numpy as np

    port = free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), suite, str(r), str(world),
                               str(port), out_dir],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO)
             for r in range(world)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for proc in procs:
            proc.kill()
        raise RuntimeError(f"{suite} workers did not finish in {timeout} s:\n"
                           + "\n".join(p.communicate()[0][-4000:] for p in procs))
    failed = [f"rank {r} ({proc.returncode}):\n{log[-6000:]}"
              for r, (proc, log) in enumerate(zip(procs, logs)) if proc.returncode != 0]
    if failed:
        raise RuntimeError(f"{suite} workers failed: " + "\n".join(failed))
    out = {}
    for case in SUITES[suite]:
        name = case.__name__[len("case_"):]
        out[name] = []
        for r in range(world):
            with np.load(os.path.join(out_dir, f"{name}.rank{r}.npz")) as z:
                out[name].append({k: z[k] for k in z.files})
    return out


def main():
    suite, rank, world, port, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    sys.path.insert(0, REPO)
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from storage_tpu_torch.parallel import distributed as pdist

    torch.set_num_threads(1)
    pdist.initialize(f"localhost:{port}", world, rank, backend="gloo",
                     timeout=datetime.timedelta(seconds=120))
    for case in SUITES[suite]:
        name = case.__name__[len("case_"):]
        try:
            out = case(rank, out_dir)
        except (ValueError, RuntimeError) as exc:
            out = {"error": np.asarray(f"{type(exc).__name__}: {exc}")}
        np.savez(os.path.join(out_dir, f"{name}.rank{rank}.npz"), **out)
        print(f"case {name} done", flush=True)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
