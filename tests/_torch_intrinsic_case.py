"""The 40-day ratcheted facility of the intrinsic engine's tests, shared by
the CPU tests against the JAX package (``test_torch_intrinsic.py``) and the
DP kernel's card tests (``test_torch_cuda_kernels.py``).  Imports neither
JAX nor pytest."""
import numpy as np
import pandas as pd
import torch

NUM_DAYS = 40
START = pd.Period("2021-03-01", freq="D")


def facility(pkg, ratchets: str, terminal: bool):
    """A 40-day facility of ``pkg`` with ratchets (3 linear nodes, or 4 step
    nodes whose top two agree, as a step table must), costs, fuel, loss and
    inventory cost; either a terminal value or empty at the end (step
    ratchets need a terminal value)."""
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


def curve():
    idx = pd.period_range(START, START + NUM_DAYS, freq="D")
    i = np.arange(len(idx))
    return pd.Series(index=idx, data=20.0 + 4.0 * np.sin(2 * np.pi * i / 17.0) + 0.3 * np.cos(i))


def snapped_steps(result, starting_inventory) -> int:
    """Steps of an intrinsic forward walk (an ``IntrinsicEngineResult``, any
    device) whose inventory is not ``previous + decision - loss`` as rounded
    in its dtype: where the walk snapped to a band bound."""
    inv = result.inventory[:-1]
    prev = torch.cat([torch.full((1,), float(starting_inventory), dtype=inv.dtype,
                                 device=inv.device), inv[:-1]])
    walked = prev + result.inject_withdraw[:-1] - result.inventory_loss[:-1]
    return int((walked != inv).sum())
