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
    assert cc.LAUNCHES == {"fused_chain": 1, "fused_complex_dot": 1}


@pytest.mark.cuda
def test_wrapper_rejects_mixed_devices():
    """A CUDA operand beside a CPU one is refused before any launch."""
    _card()
    a = torch.zeros(4, 4, device="cuda")
    with pytest.raises(ValueError, match="different devices"):
        cc.fused_complex_dot(a, a, a.cpu(), a.cpu())
