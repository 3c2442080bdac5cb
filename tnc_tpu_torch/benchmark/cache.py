"""Artifact cache: optimized partitioned network + path, compressed (the
port's copy of ``tnc_tpu.benchmark.cache``).

The expensive Sweep phase writes its result keyed by
``{scheme}_{circuit_hash}_{seed}_{partitions}_{method}``, and the Run
phase — possibly a separate job on other hardware — loads it back without
re-optimizing. The key is the reference's (:func:`cache_key` on the same
:func:`~tnc_tpu_torch.utils.digest.stable_digest`); the artifact pickles
the port's own objects, so an artifact the reference wrote (naming
``tnc_tpu`` classes) is not readable here, nor the other way round.

Tensor *data* is not stored: leaf tensors carry symbolic
:class:`TensorData` (gates / file refs), so artifacts stay small and the
Run phase materializes data on its own device.
"""

from __future__ import annotations

import pickle
import zlib
from pathlib import Path

from tnc_tpu_torch.contractionpath.contraction_path import ContractionPath
from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor
from tnc_tpu_torch.utils.digest import stable_digest


def cache_key(
    scheme: str, circuit_text: str, seed: int, partitions: int, method: str
) -> str:
    """Deterministic artifact key (circuit text hashed, params inline).

    >>> key = cache_key("greedy", "OPENQASM 2.0;", 7, 4, "sa")
    >>> key == cache_key("greedy", "OPENQASM 2.0;", 7, 4, "sa")
    True
    >>> key.startswith("greedy_") and key.endswith("_7_4_sa")
    True
    """
    digest = stable_digest(circuit_text)[:16]
    return f"{scheme}_{digest}_{seed}_{partitions}_{method}"


class ArtifactCache:
    """Keyed compressed artifact store with atomic writes.

    >>> import tempfile
    >>> cache = ArtifactCache(tempfile.mkdtemp())
    >>> cache.store_obj("k", {"plan": [1, 2]})
    >>> cache.load_obj("k")
    {'plan': [1, 2]}
    >>> cache.load_obj("missing") is None
    True
    """

    def __init__(self, directory: str | Path):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)

    def _path(self, key: str) -> Path:
        return self.directory / key

    def store(
        self, key: str, tn: CompositeTensor, path: ContractionPath
    ) -> None:
        blob = zlib.compress(pickle.dumps((tn, path)), level=6)
        target = self._path(key)
        tmp = target.with_suffix(".tmp")
        tmp.write_bytes(blob)
        tmp.replace(target)  # atomic: concurrent runs see all or nothing

    def load(self, key: str) -> tuple[CompositeTensor, ContractionPath] | None:
        target = self._path(key)
        if not target.exists():
            return None
        tn, path = pickle.loads(zlib.decompress(target.read_bytes()))
        return tn, path

    def has(self, key: str) -> bool:
        return self._path(key).exists()

    def store_obj(self, key: str, obj: object) -> None:
        """Generic artifact (e.g. a sliced plan): same zlib+pickle wire
        format and atomic-replace discipline as :meth:`store`."""
        blob = zlib.compress(pickle.dumps(obj), level=6)
        target = self._path(key)
        tmp = target.with_suffix(".tmp")
        tmp.write_bytes(blob)
        tmp.replace(target)

    def load_obj(self, key: str) -> object | None:
        target = self._path(key)
        if not target.exists():
            return None
        try:
            return pickle.loads(zlib.decompress(target.read_bytes()))
        except Exception:
            return None  # corrupt/partial artifact: replan rather than die
