"""storage_tpu_torch — commodity storage valuation in PyTorch with
hand-written CUDA kernels for one NVIDIA H100.

The port of ``storage_tpu`` (JAX on a TPU), which stays beside it as the
reference.  It carries the LSMC valuation on one card: facility model, path
simulation, backward induction and forward pass, on simulated paths
(``three_factor_seasonal_value``, ``multi_factor_value``) or on the user's
own (``value_from_sims``), with per-sim panels, the intrinsic valuation
(``intrinsic_value``, also in every LSMC result) and the one-factor
trinomial tree (``trinomial_value``, ``trinomial_deltas``).  The simulation
sweep, the backward decision steps, the forward sweep, the intrinsic DP and
the tree's backward induction are CUDA kernels (``csrc/``); entry points run
on CUDA unless the caller passes ``device="cpu"``, where the kernels' plain
tensor versions run.
"""

from .facility import (
    CmdtyStorage,
    InventoryConstraintsCannotBeFulfilledException,
    InjectWithdrawRange,
    RatchetInterp,
)
from .constraints import (
    ConstantInjectWithdrawConstraint,
    InjectWithdrawRangeByInventory,
    InjectWithdrawRangeByInventoryAndPeriod,
    PiecewiseLinearInjectWithdrawConstraint,
    PolynomialInjectWithdrawConstraint,
    StepInjectWithdrawConstraint,
)
from .api import (
    IntrinsicValuationResults,
    intrinsic_value,
    trinomial_deltas,
    trinomial_value,
)
from .api_lsmc import (
    multi_factor_value,
    three_factor_seasonal_value,
    value_from_sims,
    value_from_sims_host_local,
)
from .basis import Monomial, parse_basis_functions
from .results import (
    MultiFactorValuationResults,
    SimulationDataReturned,
    TriggerPricePoint,
    TriggerPriceProfile,
)

__version__ = "0.1.0"

__all__ = [
    "CmdtyStorage",
    "RatchetInterp",
    "InjectWithdrawRange",
    "InventoryConstraintsCannotBeFulfilledException",
    "ConstantInjectWithdrawConstraint",
    "PiecewiseLinearInjectWithdrawConstraint",
    "PolynomialInjectWithdrawConstraint",
    "StepInjectWithdrawConstraint",
    "InjectWithdrawRangeByInventory",
    "InjectWithdrawRangeByInventoryAndPeriod",
    "intrinsic_value",
    "IntrinsicValuationResults",
    "trinomial_value",
    "trinomial_deltas",
    "three_factor_seasonal_value",
    "multi_factor_value",
    "value_from_sims",
    "value_from_sims_host_local",
    "Monomial",
    "parse_basis_functions",
    "MultiFactorValuationResults",
    "SimulationDataReturned",
    "TriggerPricePoint",
    "TriggerPriceProfile",
    "__version__",
]
