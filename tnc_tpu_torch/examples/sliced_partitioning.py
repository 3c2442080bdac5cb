"""Partitioning × slicing: the composition the reference's source lists
as future work ("Slicing is currently not supported, as it is not easy to
combine it with partitioning").

The port of the reference's ``examples/sliced_partitioning.py``. Legs are
sliced across the whole network — partition cut edges included, which
shrinks the externals that dominate partition memory — and for every
slice each device slot contracts its partition, the fan-in reduces over
the slots, and the results accumulate on the root slot. This is BASELINE
config #5's pipeline at toy scale, on the reference's 4 devices as 4 slots
on the visible cards in turn (one card: ``[cuda:0] * 4``).

Run:  python -m tnc_tpu_torch.examples.sliced_partitioning
"""

import random

import numpy as np

from tnc_tpu_torch.builders.sycamore_circuit import sycamore_circuit
from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
from tnc_tpu_torch.contractionpath.repartitioning import compute_solution
from tnc_tpu_torch.parallel._devices import device_slots
from tnc_tpu_torch.parallel.partitioned import distributed_partitioned_sliced_contraction
from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network
from tnc_tpu_torch.tensornetwork.partitioning import find_partitioning
from tnc_tpu_torch.tensornetwork.simplify import simplify_network

SLOTS = 4


def main() -> dict:
    devices = device_slots(SLOTS)
    n_devices = len(devices)

    rng = np.random.default_rng(7)
    circuit = sycamore_circuit(16, 8, rng)
    raw, _ = circuit.into_amplitude_network("0" * 16)
    tn = simplify_network(raw)
    print(f"network: {len(raw)} tensors -> {len(tn)} cores")

    partitioning = find_partitioning(tn, n_devices)
    ptn, ppath, parallel_cost, serial_cost = compute_solution(
        tn, partitioning, rng=random.Random(7)
    )
    print(
        f"partitioned over {n_devices} devices: critical path "
        f"{parallel_cost:.3e} flops (serial {serial_cost:.3e})"
    )

    # slice until each per-slice program is tiny (toy target); on real
    # hardware, omit target_size and the device memory budget decides
    result, slicing = distributed_partitioned_sliced_contraction(
        ptn, ppath, devices=devices, target_size=2**10
    )
    amp = complex(np.asarray(result.data.into_data()).reshape(-1)[0])
    print(
        f"composed run: {slicing.num_slices} slices x {n_devices} devices "
        f"-> amplitude {amp:.6g}"
    )

    flat = Greedy(OptMethod.GREEDY).find_path(tn)
    oracle = contract_tensor_network(tn, flat.replace_path(), backend="numpy")
    want = complex(np.asarray(oracle.data.into_data()).reshape(-1)[0])
    assert abs(amp - want) <= 1e-5 * max(1.0, abs(want)), (amp, want)
    print("matches the single-device oracle")
    return {"partitioning": list(partitioning), "parallel_cost": parallel_cost,
            "serial_cost": serial_cost, "num_slices": slicing.num_slices,
            "amplitude": amp, "oracle": want}


if __name__ == "__main__":
    main()
