"""Local contraction: QASM2 circuit → statevector on one device.

The port of the reference's ``examples/local_contraction.py``: import a
QASM2 circuit, build the statevector network, find a greedy path,
contract, and restore natural qubit order.

Run:  python -m tnc_tpu_torch.examples.local_contraction
"""

import numpy as np

from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
from tnc_tpu_torch.io.qasm import import_qasm
from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network

QASM = """
OPENQASM 2.0;
include "qelib1.inc";
qreg q[3];
h q[0];
cx q[0], q[1];
cx q[1], q[2];
"""


def main() -> dict:
    circuit = import_qasm(QASM)
    tn, permutor = circuit.into_statevector_network()

    result = Greedy(OptMethod.GREEDY).find_path(tn)
    print(f"path found: flops={result.flops:.0f} size={result.size:.0f}")

    # backend="torch" runs the path through TorchBackend on the card (the
    # host under TNC_TPU_PLATFORM=cpu); "numpy" is the complex128 oracle.
    final = contract_tensor_network(tn, result.replace_path(), backend="torch")
    final = permutor.apply(final)

    statevector = np.asarray(final.data.into_data()).reshape(-1)
    print("GHZ statevector:")
    for i, amp in enumerate(statevector):
        if abs(amp) > 1e-12:
            print(f"  |{i:03b}⟩  {amp:.6f}")
    return {"flops": result.flops, "size": result.size, "statevector": statevector}


if __name__ == "__main__":
    main()
