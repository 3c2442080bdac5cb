"""The port's CUDA kernels against their plain versions on a GPU.

Marked ``cuda``: each test skips where there is no CUDA device. The file
imports only ``torch`` and the port, so it runs on a GPU machine that has
no JAX::

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest
"""

import pytest
import torch

from tnc_tpu_torch.ops import cuda_complex as cc


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")


def _max_rel_err(got, want) -> float:
    scale = max(float(w.abs().max()) for w in want)
    return max(float((a - b).abs().max()) for a, b in zip(got, want)) / scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_on_the_card(dtype):
    """Both kernels on ragged shapes and strided operands, each launch
    counted once."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(0)
    tol = 1e-5 if dtype == torch.float32 else 1e-12

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda", dtype=dtype)

    cc.reset_launches()
    ops = (rnd(37, 101), rnd(37, 101), rnd(37, 203), rnd(37, 203))
    got = cc.fused_complex_dot(*ops)
    assert _max_rel_err(got, cc.fused_complex_dot_reference(*ops)) <= tol
    first = (rnd(8, 16), rnd(8, 16), rnd(8, 4), rnd(8, 4))
    # the second link operand as transposed views: strides (1, 4)
    link_ops = [(rnd(8, 4), rnd(8, 4)), (rnd(16, 4).T, rnd(16, 4).T)]
    links = [cc.ChainLink(True, (8, 8), 0), cc.ChainLink(False, (4, 8), 0)]
    got = cc.fused_chain(first, link_ops, links)
    assert _max_rel_err(got, cc.fused_chain_reference(first, link_ops, links)) <= tol
    assert cc.LAUNCHES == {
        "fused_chain": 1, "fused_complex_dot": 1, "fused_transpose_dot": 0,
    }


# (first, second, reason the gate gives): the layouts of steps 0 and 4 of
# the ``peps(4, 4, 2, 32, 0)`` plan, which the gate admits; and those of its
# steps 11 and 15 (two permuted axes on each side) with the contract dim
# cut to 32 x 8 and a ragged free dim 37, off the reference's TPU tiles
# (the kernel takes it all the same)
PEPS_LAYOUTS = [
    (((2, 32, 32), (1,), (0, 2)), ((2, 32, 1024), (1,), (0, 2)), None),
    (((2, 32, 32, 8, 32), (1, 3), (0, 2, 4)), ((64, 32, 37, 8), (1, 3), (0, 2)),
     "tile_floor"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("layouts", PEPS_LAYOUTS, ids=["steps0_4", "steps11_15_cut"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_transpose_kernel_on_a_peps_layout(dtype, layouts):
    """``fused_transpose_dot`` on PEPS operand layouts against its plain
    version, twice (the second call reads the cached offset tables); one
    launch per call."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(1)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    a_lay, b_lay = cc.OperandLayout(*layouts[0]), cc.OperandLayout(*layouts[1])
    k, m, n = a_lay.k_size, a_lay.f_size, b_lay.f_size
    assert cc.transpose_dot_ineligible_reason(a_lay, b_lay, k, m, n) == layouts[2]

    def rnd(shape):
        return torch.randn(shape, generator=g, device="cuda", dtype=dtype)

    cc.reset_launches()
    for _ in range(2):
        ops = (rnd(a_lay.view), rnd(a_lay.view), rnd(b_lay.view), rnd(b_lay.view))
        got = cc.fused_transpose_dot(*ops, a_lay, b_lay)
        torch.cuda.synchronize()
        assert got[0].shape == (m, n)
        want = cc.fused_transpose_reference(*ops, a_lay, b_lay)
        assert _max_rel_err(got, want) <= tol
    assert cc.LAUNCHES["fused_transpose_dot"] == 2


@pytest.mark.cuda
def test_wrapper_rejects_mixed_devices():
    """A CUDA operand beside a CPU one is refused before any launch."""
    _card()
    a = torch.zeros(4, 4, device="cuda")
    with pytest.raises(ValueError, match="different devices"):
        cc.fused_complex_dot(a, a, a.cpu(), a.cpu())
