"""Approximate contraction: boundary-MPS with SVD truncation (the port's
counterpart of ``tnc_tpu.tensornetwork.approximate``).

The standard boundary-MPS scheme for 2-D grid networks (PEPS sandwiches,
and the qubit×depth grids :mod:`tnc_tpu_torch.approx.program` flattens
circuits into): the top row is an MPS, every interior row an MPO; after
each MPS·MPO application the boundary MPS is compressed to bond dimension
``chi`` by a QR canonicalization sweep followed by truncated SVDs. Memory
and time are then polynomial in ``chi`` instead of exponential in the grid
width — the accuracy-for-cost dial exact contraction lacks.

Beyond the value, every sweep reports its **accumulated discarded SVD
weight** (:func:`boundary_contract_with_weight`) — the sum over all
truncations of the relative discarded singular-value mass. Zero weight
means nothing was truncated and the sweep is exact (up to roundoff);
the :mod:`tnc_tpu_torch.approx.ladder` chi-ladder turns the weight plus
inter-rung deltas into a per-answer error estimate.

Scope notes:

- Sites may be connected by *several* parallel bonds (a PEPS sandwich
  has one bond per layer between neighbours); bonds per direction are
  fused into one dense axis, neighbours aligned by sorted leg id.
- ``backend="torch"``, the default, runs the sweep **on the card**
  (``device=None`` is CUDA; it raises without it): ``torch.linalg.qr``
  and ``torch.linalg.svd`` on complex CUDA tensors in ``dtype``
  (default ``complex64``), the SVD through cuSOLVER's Jacobi
  ``gesvdj``.
  Rows are grouped, moved to the device and consumed ONE AT A TIME, so
  only one interior row's dense site tensors are alive, as on the host.
  The kept rank is cut by ``chi`` alone (the reference's jitted sweep
  rule), so ``cutoff`` is rejected there. Eager PyTorch compiles
  nothing, so there is no per-shape row cache.
- ``backend="numpy"`` runs the linear algebra on the host in complex128,
  with the optional value-dependent ``cutoff``.
- :func:`collapse_peps_sandwich` flattens the ``builders.peps`` sandwich
  (layer-major ordering) into the single-layer grid this module consumes.

:func:`attach_random_data` fills metadata-only builder networks with
seeded complex Gaussian entries, drawing the same numbers from the same
``numpy`` Generator as the reference, so both packages contract identical
networks; :func:`unit_scale` (the port's own) picks a scale that keeps a
closed network's value of order one.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from tnc_tpu_torch import obs
from tnc_tpu_torch.ops.program import flat_leaf_tensors
from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor
from tnc_tpu_torch.tensornetwork.tensordata import DataKind, TensorData

#: accumulated relative discarded weight below this is roundoff, not
#: truncation — the sweep computed the closed network exactly (the
#: chi-ladder reports err ≈ 0 at such rungs)
EXACT_WEIGHT = 1e-20

#: complex128 element width: the bytes side of the host sweep's roofline
#: (a ``torch`` sweep counts its ``dtype``'s width, :func:`elem_bytes`)
_ELEM_BYTES = 16

#: cuSOLVER routine behind ``torch.linalg.svd`` in the card's sweep
#: (``driver=``): Jacobi ``gesvdj``, accurate to working precision and
#: faster than ``gesvd`` on the sweep's matrices
#: (``scripts/svd_driver_times.py`` times both)
_CUDA_SVD_DRIVER = "gesvdj"


def elem_bytes(backend: str = "torch", dtype: str = "complex64") -> int:
    """Bytes of one complex element in a sweep: complex128 on the host,
    ``dtype``'s width on the ``torch`` path.

    >>> elem_bytes(), elem_bytes("torch", "complex128"), elem_bytes("numpy")
    (8, 16, 16)
    """
    if backend != "torch":
        return _ELEM_BYTES
    return np.dtype(str(dtype).removeprefix("torch.")).itemsize


def attach_random_data(
    tn: CompositeTensor, rng: np.random.Generator, scale: float | None = None
) -> CompositeTensor:
    """Fill every metadata-only leaf of ``tn`` (in place, nested networks
    included) with ``(N(0,1) + i·N(0,1)) · scale`` entries; ``scale``
    defaults to each leaf's ``1/sqrt(size)``. Leaves that already carry
    data are left as they are, after checking that their payload has the
    leaf's declared size. Returns ``tn``.

    >>> from tnc_tpu_torch.builders.peps import peps
    >>> tn = attach_random_data(peps(2, 2, 2, 2, 0), np.random.default_rng(0))
    >>> tn.tensors[0].data.into_data().shape
    (2, 2, 2)
    """
    for i, leaf in enumerate(tn.tensors):
        if isinstance(leaf, CompositeTensor):
            attach_random_data(leaf, rng, scale)
            continue
        if leaf.data.kind is not DataKind.NONE:
            have = int(np.asarray(leaf.data.into_data()).size)
            want = int(np.prod(leaf.shape, initial=1))
            if have != want:
                raise ValueError(
                    f"attach_random_data: leaf {i} (legs {list(leaf.legs)}) "
                    f"carries data of {have} elements but its declared "
                    f"shape {leaf.shape} needs {want}"
                )
            continue
        shape = leaf.shape
        s = scale if scale is not None else 1.0 / np.sqrt(
            max(1.0, float(np.prod(shape)))
        )
        data = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * s
        leaf.data = TensorData.matrix(data.astype(np.complex128))
    return tn


def unit_scale(tn: CompositeTensor) -> float:
    """The per-leaf ``scale`` for :func:`attach_random_data` that keeps the
    expected magnitude of the closed network's contraction of order one:
    ``(2 · (∏ bond dims)^(1/n))^(-1/2)`` over the network's ``n`` leaves and
    each bond once (an entry ``N(0,1) + i·N(0,1)`` has ``E|z|² = 2``). The
    default ``1/sqrt(size)`` per leaf shrinks the result geometrically with
    the bond dims: for ``peps(4, 4, 2, 32, 0)`` to about 2^-112, at the edge
    of float32's range; this rule gives 2^-4.5 there.

    >>> from tnc_tpu_torch.builders.peps import peps
    >>> unit_scale(peps(4, 4, 2, 32, 0)) == 2 ** -4.5
    True
    """
    leaves = flat_leaf_tensors(tn)
    dims: dict[int, int] = {}
    for leaf in leaves:
        dims.update(zip(leaf.legs, leaf.bond_dims))
    log2_prod = sum(math.log2(d) for d in dims.values())
    return (2.0 * 2.0 ** (log2_prod / len(leaves))) ** -0.5


def _site_array(t: LeafTensor) -> np.ndarray:
    return np.asarray(t.data.into_data(), dtype=np.complex128).reshape(t.shape)


def _grouped(t: LeafTensor, groups: Sequence[Sequence[int]]) -> np.ndarray:
    """Dense site tensor with axes permuted/fused to the leg groups
    (one fused axis per group, legs within a group in the given order;
    missing groups become dim-1 axes)."""
    arr = _site_array(t)
    pos = {leg: i for i, leg in enumerate(t.legs)}
    perm: list[int] = []
    shape: list[int] = []
    for group in groups:
        size = 1
        for leg in group:
            perm.append(pos[leg])
            size *= t.bond_dims[pos[leg]]
        shape.append(size)
    if len(perm) != len(t.legs):
        raise ValueError(
            f"site tensor has legs {sorted(t.legs)} outside its grid "
            f"neighbourhood {sorted(l for g in groups for l in g)}"
        )
    return np.transpose(arr, perm).reshape(shape)


def _grid_groups(grid) -> list[list[tuple[list, list, list, list]]]:
    """Per-site ``(left, right, up, down)`` leg groups of a rectangular
    grid (shared validation for the contractor and the geometry/cost
    helpers)."""
    rows = len(grid)
    if rows < 2 or any(len(r) != len(grid[0]) for r in grid):
        raise ValueError("grid must be rectangular with >= 2 rows")
    cols = len(grid[0])
    if cols < 1:
        raise ValueError("grid rows must be non-empty")
    legs_of = [[set(t.legs) for t in row] for row in grid]

    def shared(r1, c1, r2, c2) -> list[int]:
        if 0 <= r2 < rows and 0 <= c2 < cols:
            return sorted(legs_of[r1][c1] & legs_of[r2][c2])
        return []

    return [
        [
            (
                shared(r, c, r, c - 1),   # left
                shared(r, c, r, c + 1),   # right
                shared(r, c, r - 1, c),   # up
                shared(r, c, r + 1, c),   # down
            )
            for c in range(cols)
        ]
        for r in range(rows)
    ]


def grid_site_dims(grid) -> list[list[tuple[int, int, int, int]]]:
    """Per-site fused ``(left, right, up, down)`` bond dims — the
    geometry the closed-form sweep cost model
    (:mod:`tnc_tpu_torch.approx.cost`) walks without materializing any
    site data.

    >>> from tnc_tpu_torch.builders.peps import peps
    >>> rng = np.random.default_rng(0)
    >>> tn = attach_random_data(peps(3, 3, 2, 2, 0), rng)
    >>> grid = collapse_peps_sandwich(tn, 3, 3, 0)
    >>> grid_site_dims(grid)[1][1]  # interior site of a vd=2 sandwich
    (4, 4, 4, 4)
    """
    groups = _grid_groups(grid)
    out: list[list[tuple[int, int, int, int]]] = []
    for row, grow in zip(grid, groups):
        dims_row = []
        for t, site_groups in zip(row, grow):
            dim_of = dict(zip(t.legs, t.bond_dims))
            dims_row.append(
                tuple(
                    int(np.prod([dim_of[l] for l in g], initial=1))
                    for g in site_groups
                )
            )
        out.append(dims_row)
    return out


class _TorchOps:
    """The array namespace the sweep helpers call (``xp``), over torch
    tensors on one device: ``linalg.qr``, ``linalg.svd`` (through
    ``gesvdj`` on a CUDA device), ``tensordot``,
    ``transpose``, ``sum``, ``where`` and ``ones`` as numpy spells them."""

    def __init__(self, device) -> None:
        import torch

        self.torch = torch
        self.device = device
        self.linalg = self
        self.driver = _CUDA_SVD_DRIVER if device.type == "cuda" else None

    def qr(self, m):
        return self.torch.linalg.qr(m)

    def svd(self, m, full_matrices: bool = False):
        return self.torch.linalg.svd(m, full_matrices=full_matrices, driver=self.driver)

    def tensordot(self, a, b, axes):
        # numpy's ``(i, j)`` pairs one axis of each; torch wants lists
        dims = tuple([x] if isinstance(x, int) else list(x) for x in axes)
        return self.torch.tensordot(a, b, dims=dims)

    def transpose(self, t, perm):
        return t.permute(perm)

    def sum(self, x):
        return self.torch.sum(x)

    def where(self, cond, a, b):
        return self.torch.where(cond, a, self.torch.zeros_like(a) + b)

    def ones(self, shape, dtype):
        return self.torch.ones(shape, dtype=dtype, device=self.device)


def _truncated_svd(m, chi: int, cutoff: float, xp=np):
    """Truncated SVD plus the **relative discarded weight** (discarded
    singular mass over total; 0.0 when nothing real was cut)."""
    u, s, vh = xp.linalg.svd(m, full_matrices=False)
    if xp is np:
        keep = int(np.sum(s > cutoff * (s[0] if s.size else 1.0)))
        keep = max(1, min(keep, chi))
        total = float(np.sum(s * s))
        disc = float(np.sum(s[keep:] * s[keep:]))
        rel = disc / total if total > 0.0 else 0.0
    else:
        # device path: the kept rank is static, cut by chi alone
        # (cutoff-based rank is value-dependent and would sync the host)
        keep = max(1, min(int(s.shape[0]), chi))
        total = xp.sum(s * s)
        disc = xp.sum(s[keep:] * s[keep:])
        rel = xp.where(total > 0.0, disc / total, 0.0)
    return u[:, :keep], s[:keep], vh[:keep], rel


def _compress_mps(mps, chi: int, cutoff: float, xp=np):
    """Canonicalize left-to-right (QR), then truncate right-to-left
    (SVD). Tensors are (Dl, d, Dr). Returns ``(mps, weight)`` where
    ``weight`` is the summed relative discarded SVD weight."""
    mps = list(mps)
    n = len(mps)
    weight = 0.0
    # left-to-right QR: left-canonical form
    for i in range(n - 1):
        dl, d, dr = mps[i].shape
        q, r = xp.linalg.qr(mps[i].reshape(dl * d, dr))
        mps[i] = q.reshape(dl, d, q.shape[1])
        mps[i + 1] = xp.tensordot(r, mps[i + 1], axes=(1, 0))
    # right-to-left truncated SVD
    for i in range(n - 1, 0, -1):
        dl, d, dr = mps[i].shape
        u, s, vh, rel = _truncated_svd(
            mps[i].reshape(dl, d * dr), chi, cutoff, xp
        )
        weight = weight + rel
        mps[i] = vh.reshape(vh.shape[0], d, dr)
        carry = u * s  # (dl, keep)
        mps[i - 1] = xp.tensordot(mps[i - 1], carry, axes=(2, 0))
    return mps, weight


def _apply_mpo(mps, mpo, xp=np):
    """MPS (Dl, d_up, Dr) x MPO (Wl, Wr, d_up, d_down) →
    fat MPS (Dl·Wl, d_down, Dr·Wr)."""
    out = []
    for a, w in zip(mps, mpo):
        dl, dup, dr = a.shape
        wl, wr, wup, wdown = w.shape
        if dup != wup:
            raise ValueError(f"vertical bond mismatch: {dup} vs {wup}")
        t = xp.tensordot(a, w, axes=(1, 2))  # (dl, dr, wl, wr, wdown)
        t = xp.transpose(t, (0, 2, 4, 1, 3))  # (dl, wl, wdown, dr, wr)
        out.append(t.reshape(dl * wl, wdown, dr * wr))
    return out


def _apply_compress(xp, mps, mpo, chi: int, cutoff: float):
    mps = _apply_mpo(mps, mpo, xp)
    return _compress_mps(mps, chi, cutoff, xp)


def _close(xp, mps, bottom):
    env = xp.ones((1, 1), dtype=mps[0].dtype)
    for a, site in zip(mps, bottom):
        # env (Dl, Bl) · a (Dl, d, Dr) · site (Bl, d, Br) -> (Dr, Br)
        tmp = xp.tensordot(env, a, axes=(0, 0))  # (Bl, d, Dr)
        env = xp.tensordot(tmp, site, axes=((0, 1), (0, 1)))
    return env


def row_cost(
    mps_shapes: Sequence[tuple], mpo_shapes: Sequence[tuple], chi: int,
    itemsize: int = _ELEM_BYTES,
) -> tuple[float, float, int, list[tuple]]:
    """Leading-order cost of ONE apply+compress boundary step:
    ``(flops, bytes, ops, out_shapes)``.

    Flops are naive complex multiply-add counts (the same ``k·m·n``
    convention as :func:`tnc_tpu_torch.ops.program.step_flops`, so
    :class:`~tnc_tpu_torch.obs.calibrate.CalibratedCostModel` prices them
    in the domain it was fitted in); QR is counted as ``2·m·n·min`` and
    SVD as ``4·m·n·min``. ``bytes`` is the traffic of every operand
    read and result written, at ``itemsize`` bytes an element (complex128
    by default; :func:`elem_bytes`); ``ops`` the dispatched linalg
    calls (the cost model's per-dispatch overhead multiplier);
    ``out_shapes`` the compressed boundary shapes, so a caller can walk
    a whole sweep row by row without materializing data
    (:func:`tnc_tpu_torch.approx.cost.sweep_cost`)."""
    flops = 0.0
    elems = 0.0
    ops = 0
    shapes: list[tuple] = []
    for (dl, d, dr), (wl, wr, wup, wdown) in zip(mps_shapes, mpo_shapes):
        if d != wup:
            raise ValueError(f"vertical bond mismatch: {d} vs {wup}")
        flops += float(dl) * dr * d * wl * wr * wdown
        elems += dl * d * dr + wl * wr * wup * wdown
        elems += dl * wl * wdown * dr * wr
        ops += 1
        shapes.append((dl * wl, wdown, dr * wr))
    n = len(shapes)
    # left-to-right QR canonicalization
    for i in range(n - 1):
        dl, d, dr = shapes[i]
        m, k = dl * d, dr
        r = min(m, k)
        flops += 2.0 * m * k * r
        elems += m * k + m * r + r * k
        ops += 1
        shapes[i] = (dl, d, r)
        dl2, d2, dr2 = shapes[i + 1]
        flops += float(r) * k * d2 * dr2
        elems += r * k + k * d2 * dr2 + r * d2 * dr2
        ops += 1
        shapes[i + 1] = (r, d2, dr2)
    # right-to-left truncated SVD
    for i in range(n - 1, 0, -1):
        dl, d, dr = shapes[i]
        m, k = dl, d * dr
        r = min(m, k, chi)
        flops += 4.0 * m * k * min(m, k)
        elems += m * k + m * r + r * k
        ops += 1
        shapes[i] = (r, d, dr)
        dl0, d0, dr0 = shapes[i - 1]
        flops += float(dl0) * d0 * dr0 * r
        elems += dl0 * d0 * dr0 + dr0 * r + dl0 * d0 * r
        ops += 1
        shapes[i - 1] = (dl0, d0, r)
    return flops, elems * itemsize, ops, shapes


def close_cost(
    mps_shapes: Sequence[tuple], bottom_shapes: Sequence[tuple],
    itemsize: int = _ELEM_BYTES,
) -> tuple[float, float, int]:
    """Leading-order cost ``(flops, bytes, ops)`` of contracting the
    final boundary MPS against the bottom row (bytes as in
    :func:`row_cost`)."""
    flops = 0.0
    elems = 0.0
    ops = 0
    eb = 1
    for (dl, d, dr), (bl, bd, br) in zip(mps_shapes, bottom_shapes):
        # env (dl, eb) · a (dl, d, dr): k=dl, out (eb, d, dr)
        flops += float(eb) * dl * d * dr
        # tmp (eb, d, dr) · site (eb==bl, d, br): k=eb·d, out (dr, br)
        flops += float(eb) * d * dr * br
        elems += dl * eb + dl * d * dr + bl * bd * br + dr * br
        ops += 2
        eb = br
    return flops, elems * itemsize, ops


def _sweep_numpy(top, mid_rows, bottom, chi: int, cutoff: float):
    """Host sweep: one interior row's grouped site tensors alive at a
    time, one ``approx.row`` span per row carrying the row's
    closed-form flop/byte counts."""
    mps = list(top)
    weight = 0.0
    for r, mpo in enumerate(mid_rows, start=1):
        flops, nbytes, _ops, _shapes = row_cost(
            [a.shape for a in mps], [w.shape for w in mpo], chi
        )
        with obs.span("approx.row", row=r, chi=chi) as sp:
            mps, w = _apply_compress(np, mps, mpo, chi, cutoff)
            sp.set(flops=flops, bytes=nbytes)
        weight += float(w)
    env = _close(np, mps, bottom)
    return env, weight


def _sweep_torch(top_fn, mid_iter, bottom_fn, chi: int, dtype, device):
    """Streaming device sweep: rows are grouped on the host, moved to
    ``device`` and consumed ONE AT A TIME (the same one-row-alive bound as
    the numpy path), each through the eager apply+compress step. The
    discarded weights stay on the device until the sweep ends. While
    tracing is on, each ``approx.row`` span (the row's flops and bytes in
    ``dtype``) closes after a synchronise, so it times the device's row;
    off, the host never waits inside the sweep."""
    import torch

    from tnc_tpu_torch.ops.backends import _complex_dtype

    ctype = _complex_dtype(dtype)
    itemsize = elem_bytes("torch", dtype)
    xp = _TorchOps(device)
    sync = device.type == "cuda" and obs.enabled()

    def put_row(row):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=ctype)
                for a in row]

    with torch.no_grad():
        mps = put_row(top_fn())
        weights = []
        for r, row in enumerate(mid_iter, start=1):
            mpo = put_row(row)
            flops, nbytes, _ops, _shapes = row_cost(
                [tuple(a.shape) for a in mps], [tuple(w.shape) for w in mpo], chi,
                itemsize,
            )
            with obs.span("approx.row", row=r, chi=chi) as sp:
                mps, w = _apply_compress(xp, mps, mpo, chi, 0.0)
                if sync:
                    torch.cuda.synchronize(device)
                sp.set(flops=flops, bytes=nbytes)
            weights.append(w)
        env = _close(xp, mps, put_row(bottom_fn()))
    return env.cpu().numpy(), sum(float(w) for w in weights)


def boundary_contract_with_weight(
    grid: Sequence[Sequence[LeafTensor]],
    chi: int,
    cutoff: float = 0.0,
    backend: str = "torch",
    dtype: str = "complex64",
    device=None,
) -> tuple[complex, float]:
    """Contract a closed 2-D grid network approximately, returning
    ``(value, weight)`` where ``weight`` is the sweep's accumulated
    relative discarded SVD mass — ``0.0`` (or roundoff below
    :data:`EXACT_WEIGHT`) means no truncation happened and the value is
    exact up to floating point. The whole sweep runs under an
    ``approx.sweep`` obs span with per-row ``approx.row`` children
    carrying closed-form flop/byte counters.

    ``backend="torch"`` (the default): on ``device`` (``None``: CUDA,
    raising without it) in ``dtype`` (``complex64`` or ``complex128``);
    ``cutoff`` must be 0 there. ``backend="numpy"``: complex128 on the
    host, ``dtype`` and ``device`` unused.
    """
    rows = len(grid)
    groups = _grid_groups(grid)
    cols = len(grid[0])
    if chi < 1:
        raise ValueError("chi must be >= 1")
    if backend not in ("numpy", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "torch" and cutoff:
        raise ValueError(
            "cutoff-based rank is value-dependent; the torch sweep "
            "supports chi truncation only"
        )

    def top_row():
        out = []
        for c in range(cols):
            left, right, up, down = groups[0][c]
            if up:
                raise ValueError("top row must have no upward bonds")
            out.append(_grouped(grid[0][c], (left, down, right)))
        return out

    def mid_rows():
        # lazy per row: only one interior row's dense grouped copies are
        # alive at a time (both backends)
        for r in range(1, rows - 1):
            yield [
                _grouped(grid[r][c], groups[r][c]) for c in range(cols)
            ]

    def bottom_row():
        out = []
        for c in range(cols):
            left, right, up, down = groups[rows - 1][c]
            if down:
                raise ValueError("bottom row must have no downward bonds")
            out.append(_grouped(grid[rows - 1][c], (left, up, right)))
        return out

    with obs.span(
        "approx.sweep", rows=rows, cols=cols, chi=chi, backend=backend
    ):
        if backend == "torch":
            from tnc_tpu_torch.ops.backends import resolve_device

            device = resolve_device(device, "boundary_contract_with_weight")
            env, weight = _sweep_torch(top_row, mid_rows(), bottom_row, chi, dtype, device)
        else:
            env, weight = _sweep_numpy(
                top_row(), mid_rows(), bottom_row(), chi, cutoff
            )
    if env.shape != (1, 1):
        raise ValueError("grid did not close to a scalar")
    return complex(env[0, 0]), float(weight)


def boundary_mps_contract(
    grid: Sequence[Sequence[LeafTensor]],
    chi: int,
    cutoff: float = 0.0,
    backend: str = "torch",
    dtype: str = "complex64",
    device=None,
) -> complex:
    """Contract a closed 2-D grid network approximately.

    ``grid[r][c]`` are data-carrying leaf tensors whose legs connect
    only to the four lattice neighbours (parallel bonds allowed, fused
    per direction). ``chi`` caps the boundary-MPS bond dimension; with
    ``chi`` at least the exact boundary rank the result is exact.
    ``backend``, ``dtype`` and ``device`` as in
    :func:`boundary_contract_with_weight`.

    >>> from tnc_tpu_torch.builders.peps import peps
    >>> rng = np.random.default_rng(7)
    >>> tn = attach_random_data(peps(3, 3, 2, 2, 1), rng)
    >>> from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
    >>> from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network
    >>> path = Greedy(OptMethod.GREEDY).find_path(tn).replace_path()
    >>> want = complex(contract_tensor_network(tn, path,
    ...     backend="numpy").data.into_data().reshape(-1)[0])
    >>> grid = collapse_peps_sandwich(tn, 3, 3, 1)
    >>> got = boundary_mps_contract(grid, chi=4096,  # chi >= exact rank
    ...                             backend="numpy")
    >>> abs(got - want) <= 1e-8 * max(1.0, abs(want))
    True
    """
    value, _weight = boundary_contract_with_weight(
        grid, chi, cutoff=cutoff, backend=backend, dtype=dtype, device=device
    )
    return value


def collapse_peps_sandwich(
    tn: CompositeTensor, length: int, depth: int, layers: int
) -> list[list[LeafTensor]]:
    """Flatten a ``builders.peps`` sandwich (data attached) into the
    single-layer ``depth × length`` grid ``boundary_mps_contract``
    consumes: each site's ``layers + 2`` stacked tensors are contracted
    over their vertical physical bonds (greedy local path, complex128 on
    the host), leaving the per-layer horizontal bonds as parallel grid
    bonds. A failure inside one site's local contraction (wrong attached
    data shape, broken bonds) is re-raised naming the offending site
    ``(row, col)``."""
    from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
    from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network

    n_layers = layers + 2
    leaves = list(tn.tensors)
    if len(leaves) != n_layers * depth * length:
        raise ValueError(
            f"expected {n_layers * depth * length} tensors "
            f"(layer-major peps ordering), got {len(leaves)}"
        )

    def site_index(k, r, c):
        return k * depth * length + r * length + c

    grid: list[list[LeafTensor]] = []
    with obs.span(
        "approx.collapse", length=length, depth=depth, layers=layers
    ):
        for r in range(depth):
            row = []
            for c in range(length):
                stack = CompositeTensor(
                    [
                        leaves[site_index(k, r, c)].copy()
                        for k in range(n_layers)
                    ]
                )
                try:
                    result = Greedy(OptMethod.GREEDY).find_path(stack)
                    merged = contract_tensor_network(
                        stack, result.replace_path(), backend="numpy"
                    )
                except Exception as exc:
                    raise ValueError(
                        f"collapse_peps_sandwich: site (row {r}, col {c}) "
                        f"failed to contract its {n_layers}-layer stack "
                        f"({type(exc).__name__}: {exc})"
                    ) from exc
                row.append(merged)
            grid.append(row)
    return grid
