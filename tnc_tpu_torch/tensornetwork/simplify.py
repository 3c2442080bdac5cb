"""Exact network preprocessing: absorb rank<=2 tensors numerically (the
port's copy of ``tnc_tpu.tensornetwork.simplify``).

Quantum-circuit networks are dominated by rank-1 kets/bras and rank-2
single-qubit gates. Contracting them into their neighbours on the host is
exact and cheap, and shrinks a Sycamore-53 depth-10 amplitude network from
904 tensors to 170 rank>=3 cores: the path finder plans over the cores
that carry the work, and the device program runs a few hundred real
products instead of a thousand 2x2 ones.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor
from tnc_tpu_torch.tensornetwork.tensordata import TensorData


def _contract_pair_np(a: LeafTensor, b: LeafTensor) -> LeafTensor:
    """Pairwise contraction on host, legs ordered as ``a ^ b``
    (``tensordot`` free-leg order matches the reference's ``^``)."""
    b_set = set(b.legs)
    a_set = set(a.legs)
    shared = [leg for leg in a.legs if leg in b_set]
    a_pos = [a.legs.index(leg) for leg in shared]
    b_pos = [b.legs.index(leg) for leg in shared]
    da = np.asarray(a.data.into_data(), dtype=np.complex128)
    db = np.asarray(b.data.into_data(), dtype=np.complex128)
    out = np.tensordot(da, db, axes=(a_pos, b_pos))
    out_legs = [leg for leg in a.legs if leg not in b_set] + [
        leg for leg in b.legs if leg not in a_set
    ]
    dim_of = dict(a.edges())
    dim_of.update(b.edges())
    result = LeafTensor(out_legs, [dim_of[leg] for leg in out_legs])
    result.data = TensorData.matrix(out)
    return result


def simplify_network(tn: CompositeTensor, max_rank: int = 2) -> CompositeTensor:
    """Contract every tensor of rank <= ``max_rank`` into a neighbour,
    repeatedly, materializing data on host. Returns the reduced network
    (flat; surviving tensors keep their relative order).

    Disconnected low-rank tensors (no shared legs) are left in place.
    The result is numerically identical to contracting the original
    network: only exact pairwise contractions are applied.

    >>> import numpy as np
    >>> from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor
    >>> from tnc_tpu_torch.tensornetwork.tensordata import TensorData
    >>> ket0 = LeafTensor([0], [2]); ket0.data = TensorData.matrix(np.array([1.0, 0]))
    >>> ket1 = LeafTensor([1], [2]); ket1.data = TensorData.matrix(np.array([0, 1.0]))
    >>> core = LeafTensor([0, 1, 2], [2, 2, 2])
    >>> core.data = TensorData.matrix(np.arange(8.0).reshape(2, 2, 2))
    >>> reduced = simplify_network(CompositeTensor([ket0, ket1, core]))
    >>> len(reduced)   # one ket absorbed; networks stop shrinking at 2
    2
    """
    tensors: dict[int, LeafTensor] = {i: t for i, t in enumerate(tn.tensors)}
    if any(isinstance(t, CompositeTensor) for t in tn.tensors):
        raise ValueError("simplify_network expects a flat network")

    leg_owners: dict[int, set[int]] = {}
    for i, t in tensors.items():
        for leg in t.legs:
            leg_owners.setdefault(leg, set()).add(i)

    next_id = len(tn.tensors)
    order: list[int] = list(tensors)  # insertion order for stable output

    queue = deque(i for i, t in tensors.items() if t.dims() <= max_rank)
    while queue:
        i = queue.popleft()
        if i not in tensors or tensors[i].dims() > max_rank:
            continue
        if len(tensors) <= 2:
            break
        neighbour = -1
        neighbour_rank = 1 << 30
        for leg in tensors[i].legs:
            for j in leg_owners.get(leg, ()):
                if j != i and j in tensors and tensors[j].dims() < neighbour_rank:
                    neighbour = j
                    neighbour_rank = tensors[j].dims()
        if neighbour < 0:
            continue  # disconnected; leave it

        merged = _contract_pair_np(tensors[i], tensors[neighbour])
        for leg in set(tensors[i].legs) | set(tensors[neighbour].legs):
            owners = leg_owners.get(leg)
            if owners is not None:
                owners.discard(i)
                owners.discard(neighbour)
        del tensors[i], tensors[neighbour]

        new_id = next_id
        next_id += 1
        tensors[new_id] = merged
        order.append(new_id)
        for leg in merged.legs:
            leg_owners.setdefault(leg, set()).add(new_id)
        if merged.dims() <= max_rank:
            queue.append(new_id)

    surviving = [tensors[i] for i in order if i in tensors]
    return CompositeTensor(surviving)
