"""Random arguments of kernel C's forward sweep, shared by the CPU tests of
its design mode (``test_torch_basis.py``) and their card counterparts
(``test_torch_cuda_host_layer.py``).  Imports neither JAX nor pytest."""
import numpy as np
import torch

from storage_tpu_torch import basis as tbasis
from storage_tpu_torch.ops import forward_kernel

BASIS_9 = "1 + x0 + x1 + x2 + x0**2 + x1**2 + x2**2 + s + s**2"  # the main path's 9 terms


def sweep_case(n=9, s=300, g=12, seed=7):
    """``forward_sweep``'s arguments for N random steps over random f64 paths
    (numpy-seeded), with the main path's 9-term basis and its raw design
    [N, B, S]."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    f64 = lambda a: torch.tensor(np.asarray(a, dtype=np.float64))  # noqa: E731
    next_min, next_max = 20.0 * t, 5000.0 - 30.0 * t
    scalars = {k: f64(v + 0.0 * t) for k, v in dict(
        df_settle=0.99, df_flow=0.98, inj_cost=0.9, wdr_cost=0.7, inj_pcnt=0.01,
        wdr_pcnt=0.005, loss_pcnt=0.001, inv_cost_rate=0.02).items()}
    scalars.update(next_min=f64(next_min), next_max=f64(next_max))
    grid_next = next_min[:, None] + (next_max - next_min)[:, None] * np.linspace(0, 1, g)
    params = forward_kernel.pack_params(scalars, f64(grid_next), dtype=torch.float64)
    entries = tuple(tbasis.parse_basis_functions(BASIS_9))
    b = len(entries)
    coeffs = 50.0 * rng.standard_normal((n, b, g))
    coeffs[:, 0] = 30.0 * grid_next
    nodes = np.array([0.0, 2500.0, 5000.0])[None, :] + 10.0 * t[:, None]
    spot = 30.0 + 5.0 * rng.standard_normal((n, s))
    factors = rng.standard_normal((n, 3, s))
    design = torch.stack(tbasis.design_columns(entries, f64(spot), f64(factors)), dim=1)
    mean = design.mean(dim=2)
    std = design.std(dim=2) + 1.0
    return dict(params=params, mean=mean, std=std, ratchet_inv=f64(nodes),
                ratchet_min=f64(np.array([-200.0, -250.0, -300.0]) - t[:, None]),
                ratchet_max=f64(np.array([300.0, 250.0, 200.0]) + t[:, None]),
                spot=f64(spot), factors=f64(factors), inventory=f64(5000.0 * rng.random(s)),
                coeffs=f64(coeffs), entries=entries, design=design)
