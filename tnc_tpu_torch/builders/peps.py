"""PEPS sandwich network generation (the port's copy of
``tnc_tpu.builders.peps``).

Builds the 2-D tensor network of ⟨PEPS|PEPO^layers|PEPS⟩ on a
``length × depth`` grid — a bottom PEPS layer, ``layers`` PEPO layers and
a top (bra) PEPS layer, the counterpart of TNC's
``builders/peps.rs:446-460``. Virtual bonds (dimension ``virtual_dim``)
connect lattice neighbours within a layer; physical bonds (dimension
``physical_dim``) connect consecutive layers vertically. The network is
closed (no open legs) and its leaves are metadata-only:
:func:`tnc_tpu_torch.tensornetwork.approximate.attach_random_data` gives
them data. Leg ids, dims and leaf order equal the reference's, so both
packages plan the same contraction.
"""

from __future__ import annotations

from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor


def peps(
    length: int,
    depth: int,
    physical_dim: int,
    virtual_dim: int,
    layers: int,
) -> CompositeTensor:
    """Build the closed PEPS/PEPO sandwich network of
    ``(layers + 2) * length * depth`` tensors.

    >>> tn = peps(3, 3, 2, 3, 1)
    >>> len(tn.tensors)            # (1 + 2) * 3 * 3
    27
    >>> tn.external_tensor().legs  # closed sandwich: no open legs
    []
    """
    if length < 2:
        raise ValueError("PEPS should have length greater than 1")
    if depth < 2:
        raise ValueError("PEPS should have depth greater than 1")

    next_edge = 0

    def new_edge() -> int:
        nonlocal next_edge
        edge = next_edge
        next_edge += 1
        return edge

    n_layers = layers + 2  # bottom PEPS + PEPOs + top PEPS

    # virtual bonds within each layer: right[(k, r, c)] joins (r, c) and
    # (r, c+1), down[(k, r, c)] joins (r, c) and (r+1, c)
    right: dict[tuple[int, int, int], int] = {}
    down: dict[tuple[int, int, int], int] = {}
    for k in range(n_layers):
        for r in range(depth):
            for c in range(length):
                if c + 1 < length:
                    right[(k, r, c)] = new_edge()
                if r + 1 < depth:
                    down[(k, r, c)] = new_edge()

    # physical bonds between consecutive layers
    vertical: dict[tuple[int, int, int], int] = {}
    for k in range(n_layers - 1):
        for r in range(depth):
            for c in range(length):
                vertical[(k, r, c)] = new_edge()

    tensors: list[LeafTensor] = []
    for k in range(n_layers):
        for r in range(depth):
            for c in range(length):
                legs: list[int] = []
                dims: list[int] = []
                # physical legs: down to the layer below, up to the one above
                if k > 0:
                    legs.append(vertical[(k - 1, r, c)])
                    dims.append(physical_dim)
                if k + 1 < n_layers:
                    legs.append(vertical[(k, r, c)])
                    dims.append(physical_dim)
                # virtual bonds: left, right, up, down within the layer
                if c > 0:
                    legs.append(right[(k, r, c - 1)])
                    dims.append(virtual_dim)
                if c + 1 < length:
                    legs.append(right[(k, r, c)])
                    dims.append(virtual_dim)
                if r > 0:
                    legs.append(down[(k, r - 1, c)])
                    dims.append(virtual_dim)
                if r + 1 < depth:
                    legs.append(down[(k, r, c)])
                    dims.append(virtual_dim)
                tensors.append(LeafTensor(legs, dims))

    return CompositeTensor(tensors)
