"""Distributed contraction: partition a Sycamore network over devices.

The port of the reference's ``examples/distributed_contraction.py``: the
partitioner assigns one sub-network per device slot, every slot contracts
its partition on a CUDA stream of its own, and the toplevel path drives
the fan-in reduce between the slots. The reference's documented command
gives it 4 of 8 devices; here the 4 slots sit on the visible cards in
turn, so one card runs all four (``[cuda:0] * 4``).

Run:  python -m tnc_tpu_torch.examples.distributed_contraction
"""

import numpy as np

from tnc_tpu_torch import CompositeTensor
from tnc_tpu_torch.builders.sycamore_circuit import sycamore_circuit
from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
from tnc_tpu_torch.parallel import distributed_partitioned_contraction
from tnc_tpu_torch.parallel._devices import device_slots
from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network
from tnc_tpu_torch.tensornetwork.partitioning import (
    find_partitioning,
    partition_tensor_network,
)

SLOTS = 4


def main() -> dict:
    devices = device_slots(SLOTS)
    print(f"{len(devices)} {devices[0].type} device slot(s)")

    rng = np.random.default_rng(42)
    circuit = sycamore_circuit(12, 8, rng)
    tn, _ = circuit.into_amplitude_network("0" * 12)

    k = len(devices)
    partitioning = find_partitioning(tn, k)
    grouped = partition_tensor_network(CompositeTensor(list(tn.tensors)), partitioning)
    print(f"partitioned into {len(grouped)} blocks")

    # nested paths per partition + toplevel communication schedule
    path = Greedy(OptMethod.GREEDY).find_path(grouped).replace_path()

    out = distributed_partitioned_contraction(grouped, path, devices=devices)
    amplitude = complex(np.asarray(out.data.into_data()).reshape(-1)[0])
    print(f"amplitude <0...0|C|0...0> = {amplitude}")

    # single-device oracle: the complex128 host contraction
    flat = Greedy(OptMethod.GREEDY).find_path(tn).replace_path()
    want = complex(contract_tensor_network(tn, flat, backend="numpy").data.into_data())
    print(f"oracle                    = {want}")
    assert abs(amplitude - want) < 1e-4
    return {"partitioning": list(partitioning), "blocks": len(grouped),
            "amplitude": amplitude, "oracle": want}


if __name__ == "__main__":
    main()
