"""Networks and comparisons shared by the partitioned planner's tests
(``tests/test_torch_partitioning.py``, ``tests/test_torch_repartitioning.py``):
the same network in both packages from one numpy seed, and tensors and
nested paths as plain tuples so that the two packages' results compare
with ``==``."""

import numpy as np

from tnc_tpu.builders.connectivity import ConnectivityLayout as RefLayout
from tnc_tpu.builders.random_circuit import random_circuit as ref_random_circuit
from tnc_tpu.tensornetwork.tensor import CompositeTensor as RefComposite
from tnc_tpu.tensornetwork.tensor import LeafTensor as RefLeaf
from tnc_tpu_torch.builders.connectivity import ConnectivityLayout
from tnc_tpu_torch.builders.random_circuit import random_circuit
from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor

# a fitted model's constants (flops/s, launch seconds, bytes/s)
MODEL = (9.8e12, 6.1e-6, 2.4e12)


def tensor_obj(t):
    """A tensor (leaf or nested composite) as plain tuples, to compare
    the two packages' networks."""
    if isinstance(t, (CompositeTensor, RefComposite)):
        return ("c", tuple(tensor_obj(c) for c in t.tensors))
    return ("l", tuple(t.legs), tuple(t.bond_dims))


def path_obj(p):
    """A nested contraction path as plain tuples."""
    return (tuple(sorted((k, path_obj(v)) for k, v in p.nested.items())),
            tuple(tuple(pair) for pair in p.toplevel))


def random_network(n, seed, extra=3, max_dim=4):
    """The same connected random network of ``n`` small tensors in both
    packages: a ring plus ``extra`` chords and one open leg every few
    tensors, bond dims 2..max_dim from one numpy seed."""
    rng = np.random.default_rng(seed)
    edges = [(i, (i + 1) % n) for i in range(n)]
    for _ in range(extra):
        a, b = rng.choice(n, size=2, replace=False)
        edges.append((int(a), int(b)))
    legs = [[] for _ in range(n)]
    dims = [[] for _ in range(n)]
    for e, (a, b) in enumerate(edges):
        d = int(rng.integers(2, max_dim + 1))
        for v in (a, b):
            legs[v].append(e)
            dims[v].append(d)
    for v in range(0, n, 3):
        legs[v].append(len(edges) + v)
        dims[v].append(2)
    port = CompositeTensor([LeafTensor(l, d) for l, d in zip(legs, dims)])
    ref = RefComposite([RefLeaf(l, d) for l, d in zip(legs, dims)])
    return port, ref


def circuits(qubits=10, depth=5, seed=8):
    """The same random circuit network in both packages (the layout and
    probabilities of the reference's repartitioning tests)."""
    port = random_circuit(qubits, depth, 0.9, 0.8, np.random.default_rng(seed),
                          ConnectivityLayout.LINE)
    ref = ref_random_circuit(qubits, depth, 0.9, 0.8, np.random.default_rng(seed),
                             RefLayout.LINE)
    assert tensor_obj(port) == tensor_obj(ref)
    return port, ref
