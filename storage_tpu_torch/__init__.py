"""storage_tpu_torch — commodity storage valuation in PyTorch with
hand-written CUDA kernels for one NVIDIA H100.

The port of ``storage_tpu`` (JAX on a TPU), which stays beside it as the
reference.  This slice carries the 3-factor seasonal LSMC main path: facility
model, path simulation, backward induction and forward pass, with the draw,
the backward decision step and the forward step as CUDA kernels
(``csrc/``).  CPU tensors run the kernels' plain tensor versions.
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
from .api_lsmc import three_factor_seasonal_value, multi_factor_value
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
    "three_factor_seasonal_value",
    "multi_factor_value",
    "Monomial",
    "parse_basis_functions",
    "MultiFactorValuationResults",
    "SimulationDataReturned",
    "TriggerPricePoint",
    "TriggerPriceProfile",
    "__version__",
]
