"""Path finders."""

from tnc_tpu_torch.contractionpath.paths.base import (  # noqa: F401
    BasicContractionPathResult,
    ContractionPathResult,
    CostType,
    Pathfinder,
)
from tnc_tpu_torch.contractionpath.paths.branchbound import (  # noqa: F401
    BranchBound,
    WeightedBranchBound,
)
from tnc_tpu_torch.contractionpath.paths.greedy import Greedy, OptMethod  # noqa: F401
from tnc_tpu_torch.contractionpath.paths.hyper import Hyperoptimizer  # noqa: F401
from tnc_tpu_torch.contractionpath.paths.optimal import Optimal  # noqa: F401
from tnc_tpu_torch.contractionpath.paths.tree_refine import (  # noqa: F401
    TreeAnnealing,
    TreeReconfigure,
    TreeTempering,
)
