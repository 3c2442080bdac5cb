"""The port's HDF5 IO (``tnc_tpu_torch.io.hdf5``) and ``FILE`` payload
against the reference's on the CPU: a file written by either package loads
in the other, lazily (``FILE`` references resolved at contraction) and
eagerly, through the payloads and their symbolic adjoints; the loaded
networks contract to the same values (complex128 numpy, within 1e-12)."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

from tnc_tpu.contractionpath.paths import Greedy as RefGreedy
from tnc_tpu.contractionpath.paths import OptMethod as RefOptMethod
from tnc_tpu.io import hdf5 as ref_hdf5
from tnc_tpu.tensornetwork.contraction import contract_tensor_network as ref_contract
from tnc_tpu.tensornetwork.tensor import LeafTensor as RefLeaf
from tnc_tpu.tensornetwork.tensordata import DataKind as RefKind
from tnc_tpu.tensornetwork.tensordata import TensorData as RefData
from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
from tnc_tpu_torch.io import hdf5
from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network
from tnc_tpu_torch.tensornetwork.tensor import LeafTensor
from tnc_tpu_torch.tensornetwork.tensordata import DataKind, TensorData, matrix_adjoint

VALUE_TOL = 1e-12  # complex128 contractions of the same data

PACKAGES = {
    "port": (hdf5, LeafTensor, TensorData),
    "reference": (ref_hdf5, RefLeaf, RefData),
}


def network_arrays(seed: int):
    """A small closed network's legs and complex128 leaf data: a ring of
    five tensors with bond dims 2..3, one chord."""
    rng = np.random.default_rng(seed)
    legs = [[0, 1], [1, 2, 5], [2, 3], [3, 4, 5], [4, 0]]
    dims = {0: 2, 1: 3, 2: 2, 3: 3, 4: 2, 5: 2}
    return [(l, rng.normal(size=[dims[e] for e in l]) + 1j * rng.normal(size=[dims[e] for e in l]))
            for l in legs]


def write(package: str, path, seed: int) -> list:
    mod, leaf_cls, data_cls = PACKAGES[package]
    arrays = network_arrays(seed)
    for tid, (legs, arr) in enumerate(arrays):
        mod.store_data(path, tid, leaf_cls(legs, list(arr.shape), data_cls.matrix(arr)))
    return arrays


def port_value(tn) -> complex:
    path = Greedy(OptMethod.GREEDY).find_path(tn).replace_path()
    return complex(contract_tensor_network(tn, path, "numpy").data.into_data())


def ref_value(tn) -> complex:
    path = RefGreedy(RefOptMethod.GREEDY).find_path(tn).replace_path()
    return complex(ref_contract(tn, path, "numpy").data.into_data())


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("lazy", [True, False])
def test_files_cross_load(tmp_path, writer, lazy):
    """Either package's file loads in both, lazy and eager, with the same
    legs, shapes, data and contracted value."""
    path = str(tmp_path / "net.h5")
    arrays = write(writer, path, seed=3)
    port_tn = hdf5.load_tensor(path, lazy=lazy)
    ref_tn = ref_hdf5.load_tensor(path, lazy=lazy)
    assert len(port_tn.tensors) == len(ref_tn.tensors) == len(arrays)
    for p, r, (legs, arr) in zip(port_tn.tensors, ref_tn.tensors, arrays):
        assert list(p.legs) == list(r.legs) == legs
        assert list(p.bond_dims) == list(r.bond_dims) == list(arr.shape)
        assert p.data.kind is (DataKind.FILE if lazy else DataKind.MATRIX)
        assert r.data.kind is (RefKind.FILE if lazy else RefKind.MATRIX)
        np.testing.assert_array_equal(p.data.into_data(), arr)
        np.testing.assert_array_equal(r.data.into_data(), arr)
    assert abs(port_value(port_tn) - ref_value(ref_tn)) <= VALUE_TOL * abs(ref_value(ref_tn))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_file_payload_adjoint(tmp_path, writer):
    """A ``FILE`` payload's adjoint is symbolic (the flag flips, the data is
    read when materialized) and equals the reference's."""
    path = str(tmp_path / "gate.h5")
    mod, leaf_cls, data_cls = PACKAGES[writer]
    rng = np.random.default_rng(5)
    arr = rng.normal(size=(2, 2, 2, 2)) + 1j * rng.normal(size=(2, 2, 2, 2))
    mod.store_data(path, 7, leaf_cls([0, 1, 2, 3], [2, 2, 2, 2], data_cls.matrix(arr)))
    port, ref = TensorData.file(path, 7), RefData.file(path, 7)
    adj = port.adjoint()
    assert adj.kind is DataKind.FILE and adj.payload == (path, 7, True)
    assert adj.adjoint() == port
    np.testing.assert_array_equal(adj.into_data(), matrix_adjoint(arr))
    np.testing.assert_array_equal(adj.into_data(), ref.adjoint().into_data())
    np.testing.assert_array_equal(port.into_data(), ref.into_data())
    assert repr(port) == repr(ref)


def test_lazy_adjoint_network(tmp_path):
    """Every payload of a lazily loaded network, adjointed, materializes to
    the reference's adjoint (the even-rank ones; an odd rank has no
    half-swap), and a double adjoint to the data itself."""
    path = str(tmp_path / "net.h5")
    arrays = write("reference", path, seed=9)
    port_tn = hdf5.load_tensor(path)
    ref_tn = ref_hdf5.load_tensor(path)
    even = 0
    for p, r, (_, arr) in zip(port_tn.tensors, ref_tn.tensors, arrays):
        adj, ref_adj = p.data.adjoint(), r.data.adjoint()
        assert adj.kind is DataKind.FILE and adj.payload[2]
        np.testing.assert_array_equal(adj.adjoint().into_data(), arr)
        if arr.ndim % 2 == 0:
            np.testing.assert_array_equal(adj.into_data(), ref_adj.into_data())
            np.testing.assert_array_equal(adj.into_data(), matrix_adjoint(arr))
            even += 1
    assert even == 3


def test_output_tensor_skipped_and_memory_file(tmp_path):
    """The ``-1`` output dataset is skipped on load, and an in-memory file
    loads eagerly in both packages."""
    f = hdf5.memory_file()
    try:
        arrays = write("port", f, seed=1)
        out = LeafTensor([9], [2], TensorData.matrix(np.ones(2, dtype=complex)))
        hdf5.store_data(f, -1, out)
        port_tn = hdf5.load_tensor(f)
        ref_tn = ref_hdf5.load_tensor(f)
        assert len(port_tn.tensors) == len(ref_tn.tensors) == len(arrays)
        assert all(t.data.kind is DataKind.MATRIX for t in port_tn.tensors)
        np.testing.assert_array_equal(hdf5.load_data(f, 2), ref_hdf5.load_data(f, 2))
    finally:
        f.close()


def test_store_overwrites(tmp_path):
    path = str(tmp_path / "t.h5")
    hdf5.store_data(path, 0, LeafTensor([0], [2], TensorData.matrix(np.ones(2))))
    ref_hdf5.store_data(path, 0, RefLeaf([0], [2], RefData.matrix(np.full(2, 3.0))))
    np.testing.assert_array_equal(hdf5.load_data(path, 0), [3.0, 3.0])
    hdf5.store_data(path, 0, LeafTensor([0], [2], TensorData.matrix(np.zeros(2))))
    np.testing.assert_array_equal(ref_hdf5.load_data(path, 0), [0.0, 0.0])


def test_rank_mismatch_raises(tmp_path):
    import h5py

    path = str(tmp_path / "bad.h5")
    with h5py.File(path, "w") as f:
        ds = f.require_group("tensors").create_dataset("0", data=np.ones((2, 2)))
        ds.attrs["bids"] = np.asarray([0], dtype=np.int64)
    with pytest.raises(ValueError, match="1 leg ids but rank 2"):
        hdf5.load_tensor(path)


def test_hdf5_is_imported_lazily():
    """Importing the port's IO modules (and materializing a GATE payload)
    imports no h5py: the card's machine has none."""
    code = ("import sys; import tnc_tpu_torch.io, tnc_tpu_torch.io.hdf5, tnc_tpu_torch.io.qasm; "
            "from tnc_tpu_torch.tensornetwork.tensordata import TensorData; "
            "TensorData.gate('h').into_data(); print('h5py' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=str(pathlib.Path(__file__).parents[1]))
    assert out.stdout.strip() == "False"


def test_doctests():
    import doctest

    assert doctest.testmod(hdf5).failed == 0
