"""Multi-device execution (the port's counterpart of ``tnc_tpu.parallel``):
partition-parallel contraction with its fan-in
(:mod:`~tnc_tpu_torch.parallel.partitioned`) and slice-parallel
contraction (:mod:`~tnc_tpu_torch.parallel.sliced_parallel`), from one
process over a list of ``torch.device``\\ s or one process per GPU under
``torch.distributed``."""

from tnc_tpu_torch.parallel.partitioned import (  # noqa: F401
    Communication,
    DeviceTensorMapping,
    PartitionExecutionError,
    distributed_partitioned_contraction,
    intermediate_reduce,
    local_contract_partitions,
    scatter_partitions,
)
from tnc_tpu_torch.parallel.sliced_parallel import (  # noqa: F401
    distributed_sliced_contraction,
    make_mesh,
)
