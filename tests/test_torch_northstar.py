"""The north-star slice of the port at small size, on the CPU.

One Sycamore-20 depth-8 amplitude (``sycamore_circuit(20, 8,
default_rng(7))`` on the all-zeros bitstring, simplified) is planned by
the port's :func:`~tnc_tpu_torch.benchmark.northstar.plan_northstar` —
the ``Hyperoptimizer`` at small settings and ``slice_and_reconfigure`` to
2^12 elements, every wall-clock budget off — and by the reference's
planner with the same arguments; the two plans must be equal. The port's
plan then runs through ``contract_tensor_network_sliced`` on
``TorchBackend(device="cpu")`` (the default sliced path: stem hoisted,
residual chunked and batched over slices, the kernels' plain versions),
and its amplitude must match the reference's ``JaxBackend(split_complex=
True)`` (Pallas in interpret mode) on the same plan and the complex128
``NumpyBackend`` within 1e-5 relative.
"""

import functools

import numpy as np
import pytest

from tnc_tpu.builders.sycamore_circuit import sycamore_circuit as ref_sycamore
from tnc_tpu.contractionpath.contraction_path import ContractionPath as RefPath
from tnc_tpu.contractionpath.paths.hyper import Hyperoptimizer as RefHyperoptimizer
from tnc_tpu.contractionpath.slicing import slice_and_reconfigure as ref_slice_and_reconfigure
from tnc_tpu.contractionpath.slicing import sliced_flops as ref_sliced_flops
from tnc_tpu.ops.backends import JaxBackend
from tnc_tpu.ops.backends import NumpyBackend as RefNumpyBackend
from tnc_tpu.ops.program import flat_leaf_tensors as ref_flat
from tnc_tpu.ops.sliced import build_sliced_program as ref_build_sliced
from tnc_tpu.tensornetwork.simplify import simplify_network as ref_simplify
from tnc_tpu_torch.benchmark.northstar import plan_northstar
from tnc_tpu_torch.ops.backends import NumpyBackend, TorchBackend
from tnc_tpu_torch.ops.chunked import chunk_plan, resolve_batch
from tnc_tpu_torch.ops.hoist import hoist_sliced_program
from tnc_tpu_torch.ops.sliced import build_sliced_program
from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network_sliced

# (qubits, depth, rng seed, trials, log2 of the slicing target)
SMALL = (20, 8, 7, 4, 12.0)
HYPER = dict(polish_rounds=1, polish_steps=400, reconfigure_budget=None,
             joint_sa_steps=300, joint_sa_rounds=1)
SLICE = dict(step_budget=None, final_budget=None)


@functools.lru_cache(maxsize=None)
def _port_plan():
    return plan_northstar(*SMALL, hyper_options=HYPER, slice_options=SLICE)


@functools.lru_cache(maxsize=None)
def _ref_plan():
    """The reference's ``bench_sycamore_amplitude`` plan with the same
    arguments: its network, replace path, slicing and sliced program."""
    q, m, seed, ntrials, target_log2 = SMALL
    raw, _ = ref_sycamore(q, m, np.random.default_rng(seed)).into_amplitude_network("0" * q)
    tn = ref_simplify(raw)
    result = RefHyperoptimizer(ntrials=ntrials, seed=seed, target_size=2.0 ** target_log2,
                               **HYPER).find_path(tn)
    replace, slicing = ref_slice_and_reconfigure(
        list(tn.tensors), result.ssa_path.toplevel, 2.0 ** target_log2, **SLICE)
    path = RefPath.simple(replace)
    return {"tn": tn, "result": result, "path": path, "slicing": slicing,
            "sp": ref_build_sliced(tn, path, slicing),
            "arrays": [leaf.data.into_data() for leaf in ref_flat(tn)]}


@pytest.fixture(autouse=True)
def _serial_trials(monkeypatch):
    monkeypatch.setenv("TNC_TPU_HYPER_WORKERS", "1")


def test_plan_matches_reference():
    port, ref = _port_plan(), _ref_plan()
    rec = port.record
    assert rec["tensors"] == len(ref["tn"].tensors)
    assert port.path.toplevel == ref["path"].toplevel
    assert (port.slicing.legs, port.slicing.dims) == (ref["slicing"].legs, ref["slicing"].dims)
    assert (rec["path_flops"], rec["path_peak"]) == (ref["result"].flops, ref["result"].size)
    assert rec["sliced_total_flops"] == ref_sliced_flops(
        list(ref["tn"].tensors), ref["path"].toplevel, ref["slicing"])
    assert rec["slices"] == 16 and rec["slice_peak"] <= 2.0 ** SMALL[4]
    assert rec["native"] == "native"
    assert rec["trials"] == {"mode": "serial", "workers": 1, "pool_error": None}


def test_program_and_hoist_match_reference():
    from tnc_tpu.ops.hoist import hoist_split_counts as ref_counts
    from tnc_tpu_torch.ops.hoist import hoist_split_counts

    port, ref = _port_plan(), _ref_plan()
    sp = build_sliced_program(port.tn, port.path, port.slicing)
    assert [(st.lhs, st.rhs, st.a_view, st.b_view, st.out_store) for st in sp.program.steps] == [
        (st.lhs, st.rhs, st.a_view, st.b_view, st.out_store) for st in ref["sp"].program.steps]
    assert hoist_split_counts(sp) == ref_counts(ref["sp"])
    residual = hoist_sliced_program(sp).residual
    batch = resolve_batch(residual, 8, True, "complex64", "cpu")[0]
    plans = chunk_plan(residual, batch, 64, True, None)
    assert batch == 8
    assert sum(len(cp.chunk.steps) for cp in plans) == len(residual.program.steps)


def test_amplitude_matches_reference_and_complex128():
    port, ref = _port_plan(), _ref_plan()
    got = complex(contract_tensor_network_sliced(
        port.tn, port.path, port.slicing, TorchBackend(device="cpu")).data.into_data())
    jax_amp = complex(np.asarray(JaxBackend(split_complex=True).execute_sliced(
        ref["sp"], ref["arrays"])).reshape(()))
    numpy_amp = complex(np.asarray(RefNumpyBackend().execute_sliced(
        ref["sp"], ref["arrays"])).reshape(()))
    port_numpy = complex(contract_tensor_network_sliced(
        port.tn, port.path, port.slicing, NumpyBackend()).data.into_data())
    assert abs(got - jax_amp) <= 1e-5 * abs(jax_amp)
    assert abs(got - numpy_amp) <= 1e-5 * abs(numpy_amp)
    assert abs(port_numpy - numpy_amp) <= 1e-12 * abs(numpy_amp)
