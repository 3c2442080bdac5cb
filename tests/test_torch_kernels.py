"""The port's kernel module (``tnc_tpu_torch.ops.cuda_complex``) against
the JAX package's Pallas kernels, on the CPU.

The CUDA kernels themselves run only on a GPU (``chip_smoke.py`` holds
them against their plain versions there, and so does
``tests/test_torch_cuda.py``, which imports no JAX). Here the plain versions — what the wrappers run on CPU tensors —
are held against ``fused_complex_dot_kl`` / ``fused_chain_kl`` in Pallas
interpret mode and against the reference's own plain chain body, on
chains cut from a real program; and the stage table the chain kernel
reads is replayed in torch to pin its shapes, strides and buffer routing.

Tolerances: float32 max|Δ| ≤ 1e-5·max|ref| (different summation orders
of f32 products), float64 ≤ 1e-12·max|ref|.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tnc_tpu.ops.pallas_complex as ref_pc
import tnc_tpu.ops.split_complex as ref_sc
from tnc_tpu.contractionpath.paths import Greedy, OptMethod
from tnc_tpu.builders.connectivity import ConnectivityLayout
from tnc_tpu.ops.program import build_program, flat_leaf_tensors
from tnc_tpu_torch.interop import network_from_arrays, path_from_pairs
from tnc_tpu_torch.ops import cuda_complex as cc
from tnc_tpu_torch.ops import program as port_prog
from tnc_tpu_torch.ops import split_complex as port_sc

ref_rc = importlib.import_module("tnc_tpu.builders.random_circuit")

TOL = {np.float32: 1e-5, np.float64: 1e-12}
TORCH = {np.float32: torch.float32, np.float64: torch.float64}


def _close(got, want, dtype):
    got = [np.asarray(g, dtype=np.float64) for g in got]
    want = [np.asarray(w, dtype=np.float64) for w in want]
    for g, w in zip(got, want):
        assert g.shape == w.shape
    scale = max(float(np.max(np.abs(w))) for w in want)
    err = max(float(np.max(np.abs(g - w))) for g, w in zip(got, want))
    assert err <= TOL[dtype] * scale, (err, scale)


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def program12():
    """The 12-qubit random-circuit statevector program (8 chains)."""
    tn = ref_rc.random_circuit(
        12, 12, 0.4, 0.4, np.random.default_rng(42),
        ConnectivityLayout.SYCAMORE, bitstring="*" * 12,
    )
    path = Greedy(OptMethod.GREEDY).find_path(tn).replace_path()
    ref_program = build_program(tn, path)
    leaves = [(l.legs, l.bond_dims, l.data.into_data()) for l in flat_leaf_tensors(tn)]
    port_program = port_prog.build_program(
        network_from_arrays(leaves), path_from_pairs(path.toplevel)
    )
    return ref_program, port_program


def _chain_buffers(steps, n_slots, dtype, seed):
    """Random (re, im) numpy buffers for the slots a chain reads."""
    rng = np.random.default_rng(seed)
    head = steps[0]
    sizes = {head.lhs: int(np.prod(head.a_view)), head.rhs: int(np.prod(head.b_view))}
    run = head.lhs
    for st in steps[1:]:
        if st.lhs == run:
            sizes[st.rhs] = int(np.prod(st.b_view))
        else:
            sizes[st.lhs] = int(np.prod(st.a_view))
        run = st.lhs
    bufs = [None] * n_slots
    for slot, size in sizes.items():
        bufs[slot] = tuple(rng.standard_normal(size).astype(dtype) for _ in range(2))
    return bufs


def _port_buffers(bufs):
    return [None if b is None else tuple(torch.from_numpy(x.copy()) for x in b) for b in bufs]


def _ref_links(links):
    return [ref_pc.ChainLink(*link.key()) for link in links]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_chain_reference_vs_pallas_on_program_chains(program12, dtype):
    """Every chain of the 12-qubit program: the port's operands and plain
    chain body against ``fused_chain_kl`` in interpret mode and the
    reference's ``fused_chain_reference`` on the same operands."""
    ref_program, port_program = program12
    chains = port_sc.plan_kernels(port_program).chains
    assert len(chains) == 8
    for idx, (s, e) in enumerate(chains):
        bufs = _chain_buffers(port_program.steps[s:e], port_program.num_inputs,
                              dtype, seed=idx)
        first_ops, link_ops, links = port_sc.chain_operands(
            port_program.steps[s:e], _port_buffers(bufs)
        )
        got = cc.fused_chain_reference(first_ops, link_ops, links)
        assert got[0].dtype == TORCH[dtype]
        j_first = tuple(jnp.asarray(_np(t)) for t in first_ops)
        j_links = [(jnp.asarray(_np(a)), jnp.asarray(_np(b))) for a, b in link_ops]
        kernel = ref_pc.fused_chain_kl(j_first, j_links, _ref_links(links), interpret=True)
        plain = ref_pc.fused_chain_reference(j_first, j_links, _ref_links(links))
        _close([_np(g) for g in got], kernel, dtype)
        _close([_np(g) for g in got], plain, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_run_chain_split_matches_reference(program12, dtype):
    """Buffer bookkeeping and result of one chain group: the port's
    ``run_chain_split`` against the reference's (Pallas interpret)."""
    ref_program, port_program = program12
    s, e = port_sc.plan_kernels(port_program).chains[-1]
    steps = port_program.steps[s:e]
    bufs = _chain_buffers(steps, port_program.num_inputs, dtype, seed=99)
    port_bufs = _port_buffers(bufs)
    ref_bufs = [None if b is None else tuple(jnp.asarray(x) for x in b) for b in bufs]
    out = port_sc.run_chain_split(steps, port_bufs)
    want = ref_sc.run_chain_split(jnp, ref_program.steps[s:e], ref_bufs)
    _close([_np(o) for o in out], want, dtype)
    assert [b is None for b in port_bufs] == [b is None for b in ref_bufs]
    assert port_bufs[steps[-1].lhs][0].shape == tuple(steps[-1].out_store)


def test_handmade_chain_vs_pallas():
    """The reference's 3-step interpret-mode template chain."""
    rng = np.random.default_rng(13)

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    first = (f32(8, 16), f32(8, 16), f32(8, 4), f32(8, 4))
    link_ops = [(f32(8, 4), f32(8, 4)), (f32(4, 16), f32(4, 16))]
    links = [cc.ChainLink(True, (8, 8), 0), cc.ChainLink(False, (4, 8), 0)]
    got = cc.fused_chain(
        tuple(torch.from_numpy(x) for x in first),
        [tuple(torch.from_numpy(x) for x in pair) for pair in link_ops],
        links,
    )
    want = ref_pc.fused_chain_kl(
        tuple(jnp.asarray(x) for x in first),
        [tuple(jnp.asarray(x) for x in pair) for pair in link_ops],
        _ref_links(links), interpret=True,
    )
    assert tuple(got[0].shape) == (16, 8)
    _close([_np(g) for g in got], want, np.float32)


@pytest.mark.parametrize("kmn", [(128, 128, 128), (256, 64, 128), (64, 32, 256)])
def test_fused_complex_dot_reference_vs_pallas(kmn):
    k, m, n = kmn
    rng = np.random.default_rng(k + m + n)
    ar, ai = (rng.standard_normal((k, m)).astype(np.float32) for _ in range(2))
    br, bi = (rng.standard_normal((k, n)).astype(np.float32) for _ in range(2))
    got = cc.fused_complex_dot_reference(*(torch.from_numpy(x) for x in (ar, ai, br, bi)))
    want = ref_pc.fused_complex_dot_kl(
        *(jnp.asarray(x) for x in (ar, ai, br, bi)), interpret=True
    )
    _close([_np(g) for g in got], want, np.float32)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_wrappers_run_plain_version_on_cpu(dtype):
    """On CPU tensors the wrappers are the plain versions — no kernel is
    launched, so no launch is counted."""
    rng = np.random.default_rng(5)
    ops = [torch.from_numpy(rng.standard_normal(s).astype(dtype))
           for s in ((7, 5), (7, 5), (7, 3), (7, 3))]
    cc.reset_launches()
    got = cc.fused_complex_dot(*ops)
    want = (ops[0].T @ ops[2] - ops[1].T @ ops[3], ops[0].T @ ops[3] + ops[1].T @ ops[2])
    _close([_np(g) for g in got], [_np(w) for w in want], dtype)
    # any strides: a transposed view of the same values gives the same product
    got_t = cc.fused_complex_dot(ops[0].T.contiguous().T, ops[1].T.contiguous().T,
                                 ops[2], ops[3])
    _close([_np(g) for g in got_t], [_np(w) for w in want], dtype)
    assert cc.LAUNCHES == {"fused_chain": 0, "fused_complex_dot": 0}


def test_wrapper_validation():
    a = torch.zeros(4, 3)
    b = torch.zeros(4, 5)
    with pytest.raises(ValueError, match="contract dims"):
        cc.fused_complex_dot(a, a, torch.zeros(5, 5), torch.zeros(5, 5))
    with pytest.raises(ValueError, match="dtypes"):
        cc.fused_complex_dot(a, a.double(), b, b)
    with pytest.raises(ValueError, match="2-D"):
        cc.fused_complex_dot(a.reshape(-1), a.reshape(-1), b, b)
    with pytest.raises(ValueError, match="real and imaginary"):
        cc.fused_complex_dot(a, torch.zeros(4, 4), b, b)
    with pytest.raises(ValueError, match="pair up"):
        cc.fused_chain((a, a, b, b), [], [cc.ChainLink(True, (3, 5), 0)])
    with pytest.raises(ValueError, match="regroups"):
        cc.fused_chain((a, a, b, b), [(b, b)], [cc.ChainLink(True, (4, 4), 0)])
    with pytest.raises(ValueError, match="contracts"):
        cc.fused_chain((a, a, b, b), [(b, b)], [cc.ChainLink(True, (3, 5), 0)])


def test_eligibility_keeps_flop_floor_drops_tile_floor():
    for kmn in [(512, 1024, 1024), (4, 4, 4), (1024, 4, 1024), (1, 4096, 4096),
                (128, 128, 128), (127, 128, 128)]:
        ref = ref_pc.ineligible_reason(*kmn)
        port = cc.ineligible_reason(*kmn)
        assert port == (ref if ref == "flop_floor" else None)
        assert cc.eligible(*kmn) == (port is None)
    assert cc.MIN_FLOPS == ref_pc.MIN_FLOPS
    assert cc.CHAIN_MAX_ELEMS == ref_pc.CHAIN_MAX_ELEMS


def test_chain_link_shapes_match_reference():
    for carried_first in (True, False):
        for k_axis in (0, 1):
            port = cc.ChainLink(carried_first, (4, 8), k_axis)
            ref = ref_pc.ChainLink(carried_first, (4, 8), k_axis)
            assert port.out_shape(3) == ref.out_shape(3)
    links = [cc.ChainLink(True, (8, 8), 0), cc.ChainLink(False, (4, 8), 0)]
    assert cc.chain_out_shape(16, 4, links, [4, 16]) == ref_pc.chain_out_shape(
        16, 4, _ref_links(links), [4, 16]
    )


def _replay_table(plan, flat):
    """Run the chain kernel's stage table in torch exactly as the kernel
    reads it: operand pair ``p`` is ``flat[2p], flat[2p+1]``; negative
    sources and destinations are the two scratch pairs and the output."""
    s_len = max(plan.scratch_elems, 1)
    scratch = torch.zeros(4 * s_len, dtype=flat[0].dtype)
    out = torch.zeros(plan.out_shape, dtype=flat[0].dtype)

    def view(src, sk, sf, rows, cols):
        if src >= 0:
            return [torch.as_strided(t, (rows, cols), (sk, sf), t.storage_offset())
                    for t in flat[2 * src: 2 * src + 2]]
        pair = -src - 1
        return [torch.as_strided(scratch, (rows, cols), (sk, sf), (2 * pair + j) * s_len)
                for j in range(2)]

    outs = (out, out.clone())
    for a_src, ask, asf, b_src, bsk, bsf, k, m, n, dst in plan.table.tolist():
        ar, ai = view(a_src, ask, asf, k, m)
        br, bi = view(b_src, bsk, bsf, k, n)
        re, im = cc.fused_complex_dot_reference(ar, ai, br, bi)
        if dst == -3:
            outs = (re, im)
        else:
            pair = -dst - 1
            scratch[2 * pair * s_len: 2 * pair * s_len + m * n] = re.reshape(-1)
            scratch[(2 * pair + 1) * s_len: (2 * pair + 1) * s_len + m * n] = im.reshape(-1)
    return outs


@pytest.mark.parametrize("transposed", [False, True])
def test_chain_stage_table_replays_to_reference(program12, transposed):
    """The stage table the CUDA chain kernel reads computes the chain:
    replayed in torch it equals ``fused_chain_reference``, for every
    chain of the program, with contiguous and with transposed-view link
    operands (the strides the kernel is handed)."""
    _, port_program = program12
    for idx, (s, e) in enumerate(port_sc.plan_kernels(port_program).chains):
        bufs = _chain_buffers(port_program.steps[s:e], port_program.num_inputs,
                              np.float64, seed=idx)
        first_ops, link_ops, links = port_sc.chain_operands(
            port_program.steps[s:e], _port_buffers(bufs)
        )
        if transposed:
            link_ops = [tuple(t.T.contiguous().T for t in pair) for pair in link_ops]
        plan = cc._ChainPlan(first_ops, link_ops, links)
        assert plan.n_stages == e - s
        flat = list(first_ops) + [t for pair in link_ops for t in pair]
        got = _replay_table(plan, flat)
        want = cc.fused_chain_reference(first_ops, link_ops, links)
        _close([_np(g) for g in got], [_np(w) for w in want], np.float64)


def test_kernel_library_paths(monkeypatch, tmp_path):
    """Libraries are keyed by a digest of sources and flags, and built
    under ``TNC_TPU_TORCH_KERNEL_DIR`` when it is set."""
    monkeypatch.setenv("TNC_TPU_TORCH_KERNEL_DIR", str(tmp_path))
    paths = {name: cc.library_path(name) for name in ("fused_chain", "fused_complex_dot")}
    for name, path in paths.items():
        assert path.parent == tmp_path and path.name.startswith(name + "-")
        assert cc.library_path(name) == path  # stable
    assert paths["fused_chain"].name != paths["fused_complex_dot"].name
    monkeypatch.setattr(cc, "NVCC_FLAGS", cc.NVCC_FLAGS + ("-DX",))
    assert cc.library_path("fused_chain") != paths["fused_chain"]


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A missing compiler is an error at first use, never a silent
    fallback to the plain versions."""
    import shutil
    from pathlib import Path

    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this host has nvcc")
    monkeypatch.setenv("TNC_TPU_TORCH_KERNEL_DIR", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cc.build_kernels()
    assert not list(tmp_path.iterdir())

