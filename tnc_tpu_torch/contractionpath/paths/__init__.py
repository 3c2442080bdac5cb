"""Path finders."""

from tnc_tpu_torch.contractionpath.paths.base import (  # noqa: F401
    BasicContractionPathResult,
    ContractionPathResult,
    CostType,
    Pathfinder,
)
from tnc_tpu_torch.contractionpath.paths.greedy import Greedy, OptMethod  # noqa: F401
