"""The port's Quick start as an executable test: the first Python block of
the README's port section, run on a GHZ file under the host pin, as
``tests/test_readme.py`` runs the reference's."""

import re
from pathlib import Path

import numpy as np

import tnc_tpu_torch.ops.backends as port_backends
from tnc_tpu_torch.utils import logging_config

README = Path(__file__).resolve().parent.parent / "README.md"
SECTION = "## PyTorch/CUDA port (`tnc_tpu_torch`)"

GHZ_QASM = """\
OPENQASM 2.0;
include "qelib1.inc";
qreg q[3];
h q[0];
cx q[0], q[1];
cx q[1], q[2];
"""


def port_blocks() -> list[str]:
    text = README.read_text()
    section = text[text.index(SECTION):]
    end = section.find("\n## ", len(SECTION))
    return re.findall(r"```python\n(.*?)```", section if end < 0 else section[:end], re.DOTALL)


def test_port_quick_start_runs(tmp_path, monkeypatch):
    blocks = port_blocks()
    assert blocks and "tnc_tpu_torch" in blocks[0] and 'backend="torch"' in blocks[0]
    assert "import tnc_tpu." not in blocks[0] and "from tnc_tpu." not in blocks[0]
    (tmp_path / "ghz.qasm").write_text(GHZ_QASM)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(logging_config, "_PINNED", "cpu")
    monkeypatch.setattr(port_backends, "_BACKENDS", {})
    printed: list = []
    exec(compile(blocks[0], str(README), "exec"),
         {"__name__": "__readme__", "print": lambda *a: printed.extend(a)})
    # the GHZ statevector: 1/sqrt(2) at |000> and |111>, zero elsewhere
    values = np.asarray(printed[-1]).reshape(-1)
    assert values.shape == (8,)
    assert abs(abs(values[0]) - 1 / np.sqrt(2)) < 1e-5
    assert abs(abs(values[-1]) - 1 / np.sqrt(2)) < 1e-5
    assert np.allclose(abs(values[1:-1]), 0, atol=1e-6)
