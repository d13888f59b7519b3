"""storage_tpu_torch — commodity storage valuation in PyTorch with
hand-written CUDA kernels for one NVIDIA H100.

The port of ``storage_tpu`` (JAX on a TPU), which stays beside it as the
reference.  It carries the LSMC valuation on one card: facility model, path
simulation, backward induction and forward pass, on simulated paths
(``three_factor_seasonal_value``, ``multi_factor_value``) or on the user's
own (``value_from_sims``), with per-sim panels, the intrinsic valuation
(``intrinsic_value``, also in every LSMC result) and the one-factor
trinomial tree (``trinomial_value``, ``trinomial_deltas``); with the JAX
package's host layer around them: the basis DSL and its combinators and
generic callables, the parameter builder (``lsmc_value``), the simulator
facade (``MultiFactorSpotSim``) and the curve helpers; and its host runtime
and service layer: the C++ inventory-band reducer and job engine
(``native/``), interactive valuations with progress and cancellation,
regression checkpoints (``checkpoint``), the asynchronous
``CalculationService`` and the command line (``python -m storage_tpu_torch``).  The simulation
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
from .utils.discount import log_linear_discount_factors
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
from .basis import (
    Monomial,
    parse_basis_functions,
    BasisFunctionList,
    GenericBasisFunction,
    generic,
    MonomialBuilder,
    ONE,
    S,
    X,
    X0, X1, X2, X3, X4, X5, X6, X7, X8, X9,
    X_ST, X_LT, X_SW,
    spot_price_power,
    markov_factor_power,
)
from .lsmc_params import (
    LsmcValuationParameters,
    LsmcValuationParametersBuilder,
    MultiFactorSimSpec,
    PanelSimSpec,
    lsmc_value,
)
from .curves import interpolate_curve_to_daily
from .jobs import Job, JobCancelledError, JobControl, JobStatus, ValuationJobEngine
from .calc_service import CalcMode, CalcStatus, CalculationService, ObjectCache
from .models.multi_factor import MultiFactorModel
from .models.spot_sim import MultiFactorSpotSim
from .results import (
    DomesticCashFlow,
    InventoryRange,
    MultiFactorValuationResults,
    SimulationDataReturned,
    StorageProfile,
    TriggerPricePoint,
    TriggerPriceProfile,
    TriggerPrices,
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
    "MultiFactorModel",
    "MultiFactorSpotSim",
    "MultiFactorValuationResults",
    "SimulationDataReturned",
    "TriggerPricePoint",
    "TriggerPriceProfile",
    "TriggerPrices",
    "StorageProfile",
    "DomesticCashFlow",
    "InventoryRange",
    "log_linear_discount_factors",
    "Monomial",
    "parse_basis_functions",
    "GenericBasisFunction",
    "generic",
    "BasisFunctionList",
    "MonomialBuilder",
    "ONE", "S", "X",
    "X0", "X1", "X2", "X3", "X4", "X5", "X6", "X7", "X8", "X9",
    "X_ST", "X_LT", "X_SW",
    "spot_price_power",
    "markov_factor_power",
    "LsmcValuationParameters",
    "LsmcValuationParametersBuilder",
    "MultiFactorSimSpec",
    "PanelSimSpec",
    "lsmc_value",
    "Job",
    "JobCancelledError",
    "JobControl",
    "JobStatus",
    "ValuationJobEngine",
    "CalcMode",
    "CalcStatus",
    "CalculationService",
    "ObjectCache",
    "interpolate_curve_to_daily",
    "__version__",
]
