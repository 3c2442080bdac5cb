"""The dot-precision ladder in the port against the JAX package, on the CPU.

The port computes each rung (``float32``, ``high`` = 3xTF32, ``default`` =
one TF32 pass; ``split_complex.RUNGS``) on the card; on the host its plain
versions round the same values in FP32 torch ops. JAX on the CPU ignores
``lax.Precision`` and computes every rung in exact FP32, so each
comparison with the reference allows the rung's own error:

- ``rna_tf32`` bit for bit against a numpy model of ``cvt.rna.tf32.f32``
  (ties away from zero, signs, subnormals, a carry into the exponent);
- the reference's contract from ``scripts/precision_parity_smoke.py`` on
  the port's plain rungs (K = 64, 512, 2048; M = N = 256): ``high`` under
  ``HIGH_PRECISION_STEP_REL / 4``, ``default`` missing the 1e-5 amplitude
  target (3xTF32's split error, ~2^-22, lies under FP32's own sums, so
  ``high`` and ``float32`` are not ordered as the reference's bf16x3 and
  FP32 are);
- each kernel's plain version at each rung against the Pallas kernel in
  interpret mode at that ``precision`` (:data:`PRODUCT_TOL`);
- ``TorchBackend(device="cpu", split_complex=True, precision=r)`` on a
  20-qubit random circuit and ``peps(3, 3, 2, 16, 0)`` against
  ``JaxBackend(precision=r, split_complex=True)`` and the complex128
  ``NumpyBackend`` (:data:`RESULT_TOL`);
- the rung reaches every product: ``high`` and ``default`` change the bits
  of the dots (every kernel mode), the chains and the Strassen
  sub-products, forced by ``TNC_TPU_DOT_PRECISION`` or planned by the
  calibrated ladder (whose ``high`` stem step changes the result and the
  policy key together); complex128 keeps its bits at every rung.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

import tnc_tpu.ops.pallas_complex as ref_pc
import tnc_tpu.ops.program as ref_prog
from tnc_tpu.builders.connectivity import ConnectivityLayout as RefLayout
from tnc_tpu.builders.peps import peps as ref_peps
from tnc_tpu.contractionpath.paths import Greedy as RefGreedy
from tnc_tpu.contractionpath.paths import OptMethod as RefOptMethod
from tnc_tpu.ops.backends import JaxBackend
from tnc_tpu.tensornetwork.approximate import attach_random_data as ref_attach
from tnc_tpu_torch.builders.connectivity import ConnectivityLayout
from tnc_tpu_torch.builders.peps import peps as port_peps
from tnc_tpu_torch.contractionpath.contraction_path import ContractionPath
from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
from tnc_tpu_torch.obs import calibrate as port_cal
from tnc_tpu_torch.ops import cuda_complex as cc
from tnc_tpu_torch.ops import program as port_prog
from tnc_tpu_torch.ops import split_complex as sc
from tnc_tpu_torch.ops import strassen as port_st
from tnc_tpu_torch.ops.backends import NumpyBackend, TorchBackend
from tnc_tpu_torch.tensornetwork.approximate import attach_random_data, unit_scale
from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor
from tnc_tpu_torch.tensornetwork.tensordata import TensorData

ref_rc = importlib.import_module("tnc_tpu.builders.random_circuit")
port_rc = importlib.import_module("tnc_tpu_torch.builders.random_circuit")

RUNGS = ("float32", "high", "default")

#: one product's max|Δ| against exact FP32, over max|ref|: today's 1e-5 at
#: float32 (FP32 sums in another order); 2^-18 at ``high`` (the reference's
#: documented per-dot rung, ``HIGH_PRECISION_STEP_REL``); 2^-10 at
#: ``default`` (10 mantissa bits: each operand off by up to 2^-11)
PRODUCT_TOL = {"float32": 1e-5, "high": sc.HIGH_PRECISION_STEP_REL, "default": 2.0 ** -10}

#: a whole contraction's max|Δ| over max|ref|: the gates the port's CPU
#: tests hold FP32 to (1e-5 for a statevector, 1e-4 for a PEPS norm) at
#: float32 and ``high``, whose products stay within 2^-18; at ``default``
#: 2^-11 a product compounded over the steps, 1e-2
RESULT_TOL = {"float32": 1e-5, "high": 1e-5, "default": 1e-2}
PEPS_TOL = {"float32": 1e-4, "high": 1e-4, "default": 1e-2}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rel(got, want) -> float:
    got = [np.asarray(g, dtype=np.float64) for g in got]
    want = [np.asarray(w, dtype=np.float64) for w in want]
    scale = max(float(np.max(np.abs(w))) for w in want)
    return max(float(np.max(np.abs(g - w))) for g, w in zip(got, want)) / scale


# -- rna_tf32 ----------------------------------------------------------------------


def _rna_model(x: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32`` from its definition, in float64: the nearest
    value with 11 significant bits (the exponent range of float32,
    subnormals spaced 2^-136), ties away from zero."""
    x = x.astype(np.float64)
    out = np.zeros_like(x)
    for i, v in enumerate(x):
        if v == 0.0 or not np.isfinite(v):
            out[i] = v
            continue
        e = max(int(np.floor(np.log2(abs(v)))), -126)  # subnormals: the last binade's step
        ulp = 2.0 ** (e - 10)
        q = abs(v) / ulp
        out[i] = np.copysign(np.floor(q + 0.5) * ulp, v)  # q + 0.5 is exact here
    return out


def test_rna_tf32_is_cvt_rna_bit_for_bit():
    """Ties, signs, subnormals, a carry into the next binade and zeros,
    then seeded values across the float32 range."""
    one = 1.0
    hand = [
        one, -one, 0.0, -0.0,
        one + 2.0 ** -11,            # a tie: away from zero
        -(one + 2.0 ** -11),
        one + 3 * 2.0 ** -11,        # a tie on an odd last bit
        one + 2.0 ** -11 - 2.0 ** -23,  # just under a tie: down
        one + 2.0 ** -11 + 2.0 ** -23,  # just over: up
        2.0 - 2.0 ** -23,            # carries into the exponent: 2
        1.5 * 2.0 ** -140, -2.0 ** -149, 2.0 ** -137 * 3, 2.0 ** -126 * (1 - 2.0 ** -12),
        3.4e38, 1e-38, -7.25e-20, 65504.0,
    ]
    rng = np.random.default_rng(20)
    seeded = (rng.standard_normal(4096) * 2.0 ** rng.integers(-140, 120, 4096))
    for values in (np.array(hand), seeded):
        x = values.astype(np.float32)
        got = sc.rna_tf32(_t(x)).numpy()
        want = _rna_model(x).astype(np.float32)
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
        assert np.all(got.view(np.uint32) & 0x1FFF == 0)
    hi, lo = sc.split_tf32(_t(seeded.astype(np.float32)))
    assert np.all(lo.numpy().view(np.uint32) & 0x1FFF == 0)
    x64 = seeded.astype(np.float32).astype(np.float64)
    normal = np.abs(x64) >= 2.0 ** -100
    resid = np.abs(x64 - hi.numpy().astype(np.float64) - lo.numpy().astype(np.float64))
    assert np.all(resid[normal] <= 2.0 ** -21 * np.abs(x64[normal]))


# -- the reference's contract on the port's plain rungs ------------------------------


#: scripts/precision_parity_smoke.py's buckets: (K, seed)
BUCKET_K = {"small": (64, 101), "medium": (512, 102), "stem": (2048, 103)}


@pytest.mark.parametrize("bucket", list(BUCKET_K))
def test_precision_parity_contract_holds_for_the_port_rungs(bucket):
    """The reference smoke's measure (max|Δ| of the naive split-complex
    product over max|ref|, against float64) on the port's plain rungs:
    ``high`` under a quarter of ``HIGH_PRECISION_STEP_REL``, ``default``
    over the 1e-5 amplitude target and over ``high``."""
    k, seed = BUCKET_K[bucket]
    rng = np.random.default_rng(seed)
    m = n = 256
    ar, ai = (rng.standard_normal((m, k)).astype(np.float32) for _ in range(2))
    br, bi = (rng.standard_normal((k, n)).astype(np.float32) for _ in range(2))
    want = (ar.astype(np.float64) + 1j * ai) @ (br.astype(np.float64) + 1j * bi)
    scale = float(np.abs(want).max())
    err = {}
    for rung in RUNGS:
        # the plain version takes contract-first operands: (K, M), (K, N)
        re, im = cc.fused_complex_dot_reference(_t(ar.T), _t(ai.T), _t(br), _t(bi), rung)
        got = re.numpy().astype(np.float64) + 1j * im.numpy()
        err[rung] = float(np.abs(got - want).max()) / scale
    assert err["high"] < sc.HIGH_PRECISION_STEP_REL / 4, err
    assert err["default"] > 1e-5, err
    assert err["default"] > 10 * err["high"], err


# -- the plain versions against the Pallas kernels at each precision ---------------------


def _operands(rng, k, m, n):
    return [rng.standard_normal(s).astype(np.float32) for s in ((k, m), (k, m), (k, n), (k, n))]


@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("kmn", [(128, 64, 256), (512, 256, 128)])
def test_fused_complex_dot_plain_matches_pallas_at_each_rung(rung, kmn):
    ops = _operands(np.random.default_rng(sum(kmn)), *kmn)
    got = cc.fused_complex_dot(*(_t(x) for x in ops), precision=rung)
    want = ref_pc.fused_complex_dot_kl(*ops, interpret=True,
                                       precision=ref_precision(rung))
    assert _rel([g.numpy() for g in got], want) <= PRODUCT_TOL[rung]


def ref_precision(rung: str):
    """The reference's ``lax.Precision`` for a port rung."""
    from tnc_tpu.ops.split_complex import _resolve_precision

    return _resolve_precision(rung)


@pytest.mark.parametrize("rung", RUNGS)
def test_fused_transpose_plain_matches_pallas_at_each_rung(rung):
    """A rank-3 macro transpose on the first operand, the contract index
    last on the second (the reference test's layouts)."""
    rng = np.random.default_rng(7)
    a_view, b_view = (4, 256, 64), (256, 256)
    a_ref = ref_pc.operand_layout(a_view, (0, 2, 1), (256, 256), True)
    b_ref = ref_pc.operand_layout(b_view, None, (256, 256), False)
    a_lay = cc.OperandLayout(a_ref.view, a_ref.k_axes, a_ref.f_axes)
    b_lay = cc.OperandLayout(b_ref.view, b_ref.k_axes, b_ref.f_axes)
    ar, ai = (rng.standard_normal(a_view).astype(np.float32) for _ in range(2))
    br, bi = (rng.standard_normal(b_view).astype(np.float32) for _ in range(2))
    got = cc.fused_transpose_dot(*(_t(x) for x in (ar, ai, br, bi)), a_lay, b_lay, rung)
    want = jax.jit(lambda a, b, c, d: ref_pc.fused_transpose_dot_kl(
        a, b, c, d, a_ref, b_ref, interpret=True, precision=ref_precision(rung)))(ar, ai, br, bi)
    assert _rel([g.numpy() for g in got], want) <= PRODUCT_TOL[rung]
    plain = ref_pc.fused_transpose_reference(ar, ai, br, bi, a_ref, b_ref,
                                             precision=ref_precision(rung))
    assert _rel([g.numpy() for g in got], plain) <= PRODUCT_TOL[rung]


@pytest.mark.parametrize("rung", RUNGS)
def test_fused_chain_plain_matches_pallas_at_each_rung(rung):
    """A three-step chain (carried first, then second): the plain chain at
    each rung against ``fused_chain_kl`` and the reference's plain chain."""
    rng = np.random.default_rng(13)

    def r(*s):
        return rng.standard_normal(s).astype(np.float32)

    first = (r(16, 8), r(16, 8), r(16, 32), r(16, 32))
    link_ops = [(r(32, 4), r(32, 4)), (r(16, 64), r(16, 64))]
    links = [cc.ChainLink(True, (8, 32), 1), cc.ChainLink(False, (16, 2), 0)]
    ref_links = [ref_pc.ChainLink(*link.key()) for link in links]
    got = cc.fused_chain(tuple(_t(x) for x in first),
                         [tuple(_t(x) for x in p) for p in link_ops], links, precision=rung)
    prec = ref_precision(rung)
    kernel = ref_pc.fused_chain_kl(first, link_ops, ref_links, interpret=True, precision=prec)
    plain = ref_pc.fused_chain_reference(first, link_ops, ref_links, precision=prec)
    for want in (kernel, plain):
        # two products a value: the first rounds the carried value again
        assert _rel([g.numpy() for g in got], want) <= 2 * PRODUCT_TOL[rung]


@pytest.mark.parametrize("rung", RUNGS)
def test_strassen_sub_products_run_the_rung(rung):
    """``gauss_strassen_dot_kl(precision=)`` against the exact product,
    within the rung's error (the quadrant sums mix magnitudes: twice it),
    and against its own float32 bits."""
    rng = np.random.default_rng(3)
    ar, ai, br, bi = (_t(x) for x in _operands(rng, 128, 96, 64))
    re, im = port_st.gauss_strassen_dot_kl(ar, ai, br, bi, precision=rung)
    want = cc.fused_complex_dot_reference(*(x.double() for x in (ar, ai, br, bi)))
    assert _rel([re.numpy(), im.numpy()], [w.numpy() for w in want]) <= 2 * PRODUCT_TOL[rung]
    re32, im32 = port_st.gauss_strassen_dot_kl(ar, ai, br, bi)
    assert torch.equal(re, re32) == (rung == "float32")
    assert torch.equal(im, im32) == (rung == "float32")


# -- whole contractions against the reference and complex128 -----------------------------


def _circuit(qubits):
    """The port's and the reference's networks, paths and programs of one
    random circuit's statevector."""
    out = []
    for rc, layout, greedy, opt, prog in (
        (port_rc, ConnectivityLayout, Greedy, OptMethod, port_prog),
        (ref_rc, RefLayout, RefGreedy, RefOptMethod, ref_prog),
    ):
        tn = rc.random_circuit(qubits, 12, 0.4, 0.4, np.random.default_rng(42),
                               layout.SYCAMORE, bitstring="*" * qubits)
        path = greedy(opt.GREEDY).find_path(tn).replace_path()
        out.append((tn, prog.build_program(tn, path)))
    return out


def _peps(args):
    tn = port_peps(*args)
    scale = unit_scale(tn)
    attach_random_data(tn, np.random.default_rng(42), scale=scale)
    ref_tn = ref_attach(ref_peps(*args), np.random.default_rng(42), scale=scale)
    path = Greedy(OptMethod.GREEDY).find_path(tn).replace_path()
    ref_path = RefGreedy(RefOptMethod.GREEDY).find_path(ref_tn).replace_path()
    return (tn, port_prog.build_program(tn, path)), (ref_tn, ref_prog.build_program(ref_tn, ref_path))


def _arrays(prog_mod, tn):
    return [leaf.data.into_data() for leaf in prog_mod.flat_leaf_tensors(tn)]


@pytest.fixture(scope="module")
def random20():
    return _circuit(20)


@pytest.fixture(scope="module")
def random14():
    return _circuit(14)


@pytest.fixture(scope="module")
def peps33():
    return _peps((3, 3, 2, 16, 0))


@pytest.fixture
def no_env(monkeypatch):
    monkeypatch.delenv("TNC_TPU_COMPLEX_MULT", raising=False)
    monkeypatch.delenv("TNC_TPU_DOT_PRECISION", raising=False)


@pytest.mark.parametrize("rung", RUNGS)
def test_random20_at_each_rung_matches_the_reference(rung, random20, no_env):
    (tn, program), (ref_tn, ref_program) = random20
    got = TorchBackend(device="cpu", split_complex=True, precision=rung).execute(
        program, _arrays(port_prog, tn))
    want = np.asarray(JaxBackend(dtype="complex64", split_complex=True, precision=rung)
                      .execute(ref_program, _arrays(ref_prog, ref_tn)))
    oracle = NumpyBackend().execute(program, _arrays(port_prog, tn))
    scale = float(np.max(np.abs(oracle)))
    assert float(np.max(np.abs(got - want))) <= RESULT_TOL[rung] * scale
    assert float(np.max(np.abs(got - oracle))) <= RESULT_TOL[rung] * scale
    if rung == "default":
        # TF32 shows: further from complex128 than FP32's 1e-5
        assert float(np.max(np.abs(got - oracle))) > 1e-5 * scale


@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("force", [None, "fused_transpose"])
def test_peps_norm_at_each_rung_matches_the_reference(rung, force, peps33, monkeypatch):
    """The default policy and the forced ``fused_transpose`` rung (the
    transpose kernel's plain version on two steps at the rung)."""
    monkeypatch.delenv("TNC_TPU_DOT_PRECISION", raising=False)
    if force is None:
        monkeypatch.delenv("TNC_TPU_COMPLEX_MULT", raising=False)
    else:
        monkeypatch.setenv("TNC_TPU_COMPLEX_MULT", force)
    (tn, program), (ref_tn, ref_program) = peps33
    got = complex(np.asarray(TorchBackend(device="cpu", split_complex=True, precision=rung)
                             .execute(program, _arrays(port_prog, tn))).reshape(()))
    want = complex(np.asarray(JaxBackend(dtype="complex64", split_complex=True, precision=rung)
                              .execute(ref_program, _arrays(ref_prog, ref_tn))).reshape(()))
    oracle = complex(np.asarray(NumpyBackend().execute(program, _arrays(port_prog, tn)))
                     .reshape(()))
    assert 0.1 < abs(oracle) < 10.0
    assert abs(got - want) <= PEPS_TOL[rung] * abs(oracle)
    assert abs(got - oracle) <= PEPS_TOL[rung] * abs(oracle)


# -- the rung reaches every product --------------------------------------------------------


def _run(program, arrays, precision, dtype="complex64"):
    return TorchBackend(device="cpu", split_complex=True, precision=precision,
                        dtype=dtype).execute(program, arrays)


@pytest.mark.parametrize("mode", ["gauss", "naive", "fused", "chain"])
def test_high_and_default_change_the_bits_of_every_mode(mode, random14, monkeypatch):
    """Under each forced mode (``chain``: every groupable run fused, the
    rest gauss) the TF32 rungs give other bits than float32, and a forced
    ``TNC_TPU_DOT_PRECISION=high`` gives the bits of ``precision="high"``."""
    monkeypatch.setenv("TNC_TPU_COMPLEX_MULT", mode)
    monkeypatch.delenv("TNC_TPU_DOT_PRECISION", raising=False)
    (tn, program), _ = random14
    arrays = _arrays(port_prog, tn)
    out = {rung: _run(program, arrays, rung) for rung in RUNGS}
    assert not np.array_equal(out["high"], out["float32"])
    assert not np.array_equal(out["default"], out["float32"])
    assert not np.array_equal(out["default"], out["high"])
    monkeypatch.setenv("TNC_TPU_DOT_PRECISION", "high")
    assert np.array_equal(_run(program, arrays, "float32"), out["high"])


def test_chains_run_the_rung(random14, no_env):
    """A chain alone at each rung (``run_chain_split``): the TF32 rungs
    change its bits, and ``high`` gives the plain chain's at ``high``."""
    (_, program), _ = random14
    policy = sc.plan_kernels(program)
    s, e = policy.chains[0]
    steps = program.steps[s:e]
    rng = np.random.default_rng(5)
    bufs = [None] * program.num_inputs
    for st in steps:
        for slot, view in ((st.lhs, st.a_view), (st.rhs, st.b_view)):
            if bufs[slot] is None:
                bufs[slot] = tuple(_t(rng.standard_normal(int(np.prod(view))).astype(np.float32))
                                   for _ in range(2))
    out = {}
    for rung in RUNGS:
        copy = list(bufs)
        out[rung] = sc.run_chain_split(steps, copy, None, None, None, rung)
    for rung in ("high", "default"):
        assert not torch.equal(out[rung][0], out["float32"][0])
    want = cc.fused_chain_reference(*sc.chain_operands(steps, list(bufs)), "high")
    assert torch.equal(out["high"][0].reshape(-1), want[0].reshape(-1))


def test_complex128_keeps_its_bits_at_every_rung(peps33, no_env):
    """float64 parts ignore the rung, on the split path and the kernels."""
    (tn, program), _ = peps33
    arrays = _arrays(port_prog, tn)
    out = [_run(program, arrays, rung, dtype="complex128") for rung in RUNGS]
    assert all(np.array_equal(o, out[0]) for o in out[1:])
    rng = np.random.default_rng(1)
    ops = [_t(x.astype(np.float64)) for x in _operands(rng, 32, 16, 24)]
    base = cc.fused_complex_dot(*ops)
    for rung in RUNGS:
        got = cc.fused_complex_dot(*ops, precision=rung)
        assert all(torch.equal(g, b) for g, b in zip(got, base))


def _stem_program():
    """One 2048^3 complex product (two matrices), its data seeded."""
    rng = np.random.default_rng(9)
    leaves = []
    for legs in ([0, 1], [1, 2]):
        data = (rng.standard_normal((2048, 2048)) + 1j * rng.standard_normal((2048, 2048))) / 64
        leaves.append(LeafTensor(legs, [2048, 2048], TensorData.matrix(data)))
    tn = CompositeTensor(leaves)
    return port_prog.build_program(tn, ContractionPath.simple([(0, 1)])), tn


def test_calibrated_high_stem_changes_result_and_policy_key_together(no_env):
    """A fitted model under which the stem is compute-bound promotes it to
    ``high`` (on gauss); one under which it is bandwidth-bound keeps it at
    the backend's float32 (on gauss too). The two backends' policy keys
    differ, and so do their bits; the ``high`` result stays within the
    rung's error of the float32 one."""
    program, tn = _stem_program()
    arrays = _arrays(port_prog, tn)
    promote = port_cal.CalibratedCostModel(1e12, 0.0, 100.0 * 1e12 / 2048)
    keep = port_cal.CalibratedCostModel(1e12, 0.0, 1e10)
    results, keys = {}, {}
    for name, model in (("high", promote), ("float32", keep)):
        backend = TorchBackend(device="cpu", split_complex=True)
        backend._fit = (model,)
        policy = backend.kernel_policy(program)
        assert policy.modes == ("gauss",)
        assert policy.precision_modes == (() if name == "float32" else ("high",))
        results[name], keys[name] = backend.execute(program, arrays), backend.policy_key()
    assert keys["high"] != keys["float32"]
    assert not np.array_equal(results["high"], results["float32"])
    scale = float(np.max(np.abs(results["float32"])))
    assert float(np.max(np.abs(results["high"] - results["float32"]))) <= 1e-5 * scale


def _counting(monkeypatch, calls):
    """``cuda_complex.fused_complex_dot`` counting its calls by rung."""
    real = cc.fused_complex_dot

    def counted(*args, precision=None):
        calls[precision] = calls.get(precision, 0) + 1
        return real(*args, precision=precision)

    monkeypatch.setattr(cc, "fused_complex_dot", counted)


@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("mode", ["gauss", "naive", "strassen", "fused", "fused_transpose"])
def test_tf32_steps_run_fused_complex_dot_whatever_their_mode(mode, rung, random14, monkeypatch):
    """At a TF32 rung every step outside the chains (and outside the
    admitted ``fused_transpose`` steps) calls ``fused_complex_dot`` at the
    rung, once, whatever its mode; at ``float32`` no call carries a rung.
    The result is the one the unpatched wrapper gives."""
    monkeypatch.setenv("TNC_TPU_COMPLEX_MULT", mode)
    monkeypatch.delenv("TNC_TPU_DOT_PRECISION", raising=False)
    (tn, program), _ = random14
    arrays = _arrays(port_prog, tn)
    want = _run(program, arrays, rung)
    calls: dict = {}
    _counting(monkeypatch, calls)
    backend = TorchBackend(device="cpu", split_complex=True, precision=rung)
    got = backend.execute(program, arrays)
    assert np.array_equal(got, want)
    policy = backend.kernel_policy(program)
    chained = policy.chained_steps()
    steps = sum(1 for i, st in enumerate(program.steps) if i not in chained
                and not (policy.modes[i] == "fused_transpose"
                         and sc.fused_transpose_ineligible_reason(st) is None))
    if rung == "float32":
        assert set(calls) <= {None}
    else:
        assert calls == {rung: steps} and steps > 0


@pytest.mark.parametrize(("k", "tiles", "batch", "want"), [
    (2 ** 23, 1, 8, 128),      # m10's long dots: the batch cut to fill the card
    (16384, 32768, 1, 1),      # the random28 stem: tiles enough
    (1024, 1, 1, 1),           # pieces would fall under SPLIT_K_MIN
    (3 * 2 ** 12, 1, 1, 4),    # cut while the pieces divide K and stay long
    (2 ** 20, 1, 40000, 1),    # the grid's rows would pass 65535
    (2 ** 16, 100, 1, 8),      # the least power of two giving 4 blocks an SM
])
def test_split_k_pieces(k, tiles, batch, want):
    assert cc.split_k_pieces(k, tiles, batch, 132) == want


SPLIT_CASES = {
    # (a lead, b lead, a transposed): which sides carry the batch of 3
    "unbatched": ((), (), False), "both": ((3,), (3,), False),
    "a_batched": ((3,), (), False), "b_batched": ((), (3,), False),
    "a_strided": ((), (), True),
}


@pytest.mark.parametrize("pieces", [2, 8])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_contraction_pieces_sum_to_the_product(case, pieces):
    """A TF32-rung product cut into ``pieces`` along its contraction (each
    piece a batch row, as the card launches it) and summed equals the
    uncut product at the rung, up to FP32's order of sums."""
    a_lead, b_lead, transposed = SPLIT_CASES[case]
    rng = np.random.default_rng(17)
    k, m, n = 4096, 24, 40
    if transposed:
        ar, ai = (_t(rng.standard_normal((m, k)).astype(np.float32)).mT for _ in range(2))
    else:
        ar, ai = (_t(rng.standard_normal(a_lead + (k, m)).astype(np.float32))
                  for _ in range(2))
    br, bi = (_t(rng.standard_normal(b_lead + (k, n)).astype(np.float32)) for _ in range(2))
    batch = 3 if a_lead or b_lead else None
    parts = cc.split_contraction((ar, ai, br, bi), batch, pieces)
    assert all(t.shape == ((batch or 1) * pieces, k // pieces, t.shape[-1]) for t in parts)
    cut = [cc.merge_pieces(t, batch, pieces)
           for t in cc.fused_complex_dot_reference(*parts, "high")]
    whole = cc.fused_complex_dot_reference(ar, ai, br, bi, "high")
    assert cut[0].shape == whole[0].shape
    assert _rel([t.numpy() for t in cut], [t.numpy() for t in whole]) <= 1e-5


@pytest.mark.parametrize("rung", ["high", "default"])
def test_rung_matmul_is_fp32_arithmetic_on_tf32_values(rung, monkeypatch):
    """The plain version of a rung product: the rounded (``default``) or
    split (``high``) operands multiplied in FP32, bit for bit, and the
    cuBLAS TF32 switch left as it was."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    rng = np.random.default_rng(23)
    x, y = (_t(rng.standard_normal(s).astype(np.float32)) for s in ((96, 512), (512, 40)))
    got = sc.rung_matmul(x, y, rung)
    if rung == "default":
        want = sc.rna_tf32(x) @ sc.rna_tf32(y)
    else:
        (xh, xl), (yh, yl) = sc.split_tf32(x), sc.split_tf32(y)
        want = xh @ yl + xl @ yh + xh @ yh
    assert torch.equal(got, want)
    assert torch.backends.cuda.matmul.allow_tf32 is False


#: the single-product probe the card's holds use (``chip_smoke.PROBE_VALUE``):
#: hi = rna_tf32 = 1, lo = 2^-11 - 2^-21
PROBE_VALUE = 1.0 + 2.0 ** -11 - 2.0 ** -21
#: what one probe product is at each rung, exactly: FP32's rounding of the
#: square; 3xTF32 drops lo·lo and sums exactly; one TF32 pass sees 1·1
PROBE_OUT = {"float32": float(np.float32(PROBE_VALUE) * np.float32(PROBE_VALUE)),
             "high": 1.0 + 2.0 ** -10 - 2.0 ** -20, "default": 1.0}


def _probe_parts(shapes, to_kf=None, first=4):
    out = []
    for i, shape in enumerate(shapes):
        z = torch.zeros(shape, dtype=torch.float32)
        if i % 2 == 0:
            value = PROBE_VALUE if i < first else 1.0
            if to_kf is None:
                z[..., 0, :] = value
            else:
                z.view(-1)[to_kf(i, torch.arange(z.numel()).reshape(shape))[0]] = value
        out.append(z)
    return out


@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("kernel", ["complex_dot", "batched_dot", "transpose", "chain"])
def test_single_product_probe_fixes_each_rung_exactly(kernel, rung):
    """Operands zero but for contract index 0 of the real parts make every
    output one product, which each rung's plain version computes exactly:
    three distinct values, so a kernel on the card that ran another rung's
    arithmetic gives other bits."""
    if kernel in ("complex_dot", "batched_dot"):
        lead = (3,) if kernel == "batched_dot" else ()
        parts = _probe_parts([lead + (64, 8), lead + (64, 8), (64, 16), (64, 16)])
        got = cc.fused_complex_dot(*parts, precision=rung)
    elif kernel == "transpose":
        a_ref = ref_pc.operand_layout((4, 256, 64), (0, 2, 1), (256, 256), True)
        b_ref = ref_pc.operand_layout((256, 256), None, (256, 256), False)
        a_lay = cc.OperandLayout(a_ref.view, a_ref.k_axes, a_ref.f_axes)
        b_lay = cc.OperandLayout(b_ref.view, b_ref.k_axes, b_ref.f_axes)
        parts = _probe_parts([a_lay.view] * 2 + [b_lay.view] * 2,
                             to_kf=lambda i, t: cc._as_kf(t, a_lay if i < 2 else b_lay))
        got = cc.fused_transpose_dot(*parts, a_lay, b_lay, rung)
    else:
        parts = _probe_parts([(16, 8), (16, 8), (16, 32), (16, 32), (32, 4), (32, 4),
                              (16, 64), (16, 64)])
        links = [cc.ChainLink(True, (8, 32), 1), cc.ChainLink(False, (16, 2), 0)]
        got = cc.fused_chain(tuple(parts[:4]), [tuple(parts[4:6]), tuple(parts[6:8])],
                             links, precision=rung)
    assert bool((got[0] == PROBE_OUT[rung]).all()) and bool((got[1] == 0).all())
    assert len(set(PROBE_OUT.values())) == 3
