"""Repartitioning: improve a partitioning with simulated annealing.

The port of the reference's ``examples/repartitioning.py``: start from the
hypergraph partitioner's assignment, then let the SA engine
(``IntermediatePartitioningModel``, the reference's best model) shift
subtrees between partitions to reduce the critical-path cost. Host work
only: nothing here touches the device.

Run:  python -m tnc_tpu_torch.examples.repartitioning
"""

import random

import numpy as np

from tnc_tpu_torch.builders.connectivity import ConnectivityLayout
from tnc_tpu_torch.builders.random_circuit import random_circuit
from tnc_tpu_torch.contractionpath.repartitioning import compute_solution
from tnc_tpu_torch.contractionpath.repartitioning.simulated_annealing import (
    IntermediatePartitioningModel,
    balance_partitions,
)
from tnc_tpu_torch.tensornetwork.partitioning import find_partitioning

MAX_TIME = 10.0


def main() -> dict:
    rng = np.random.default_rng(7)
    tn = random_circuit(16, 8, 0.9, 0.8, rng, ConnectivityLayout.LINE)

    k = 4
    initial = find_partitioning(tn, k)
    _, _, parallel0, serial0 = compute_solution(tn, initial)
    print(f"initial : parallel flops {parallel0:.3g}  (sum {serial0:.3g})")

    model = IntermediatePartitioningModel(tn)
    sa_rng = random.Random(0)
    best, _score = balance_partitions(
        model, model.initial_solution(initial), sa_rng, max_time=MAX_TIME
    )
    improved = list(best[0])
    _, _, parallel1, serial1 = compute_solution(tn, improved)
    print(f"annealed: parallel flops {parallel1:.3g}  (sum {serial1:.3g})")
    print(f"improvement: {parallel0 / max(parallel1, 1):.2f}x on the critical path")
    return {"initial": list(initial), "parallel0": parallel0, "serial0": serial0,
            "annealed": improved, "parallel1": parallel1, "serial1": serial1}


if __name__ == "__main__":
    main()
