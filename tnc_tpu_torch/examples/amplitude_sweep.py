"""Amplitude sweep: many bitstrings through one batched call.

The port of the reference's ``examples/amplitude_sweep.py``: an amplitude
network's structure does not depend on the bitstring, so one contraction
path and one program evaluate a whole batch of amplitudes, the bras a
leading batch axis of every buffer they reach — one dispatch on the card.

Run:  python -m tnc_tpu_torch.examples.amplitude_sweep
"""

import numpy as np

from tnc_tpu_torch.builders.connectivity import ConnectivityLayout
from tnc_tpu_torch.builders.random_circuit import random_open_circuit
from tnc_tpu_torch.tensornetwork import amplitude_sweep


def main() -> dict:
    rng = np.random.default_rng(7)
    qubits, depth = 16, 10
    circuit = random_open_circuit(
        qubits, depth, 0.4, 0.4, rng, ConnectivityLayout.LINE
    )

    sample = np.random.default_rng(0)
    bitstrings = [
        "".join(sample.choice(["0", "1"]) for _ in range(qubits))
        for _ in range(32)
    ]
    amps = amplitude_sweep(circuit, bitstrings)  # TorchBackend(): the card

    probs = np.abs(amps) ** 2
    print(f"{len(bitstrings)} amplitudes from one batched call")
    for b, a, p in list(zip(bitstrings, amps, probs))[:5]:
        print(f"  <{b}|C|0...0> = {a:.3e}  |.|^2 = {p:.3e}")
    print(f"  sum of sampled probabilities: {probs.sum():.3e}")
    return {"bitstrings": bitstrings, "amplitudes": np.asarray(amps),
            "probability_sum": float(probs.sum())}


if __name__ == "__main__":
    main()
