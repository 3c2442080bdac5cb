"""Canonical structure digests (the port's copy of
``tnc_tpu.utils.digest``): the stable identity of a compiled program
(:meth:`~tnc_tpu_torch.ops.program.ContractionProgram.signature_digest`)
that the serving layer (:mod:`tnc_tpu_torch.serve.rebind`) compares.
``repr`` of dicts/sets depends on insertion order and Python hash seeds,
so "the same plan" could digest differently across processes; this
encoding does not.

:func:`canonical_bytes` encodes a value tree deterministically:

- containers are length-prefixed and type-tagged; dict items are sorted
  by their *encoded key bytes* (not hash order), sets likewise;
- dataclasses (e.g. :class:`~tnc_tpu_torch.ops.program.PairStep`,
  :class:`~tnc_tpu_torch.contractionpath.slicing.Slicing`) encode as their
  class name + field name/value pairs;
- floats encode as IEEE-754 big-endian doubles, ints as decimal text,
  enums as class + value — never ``repr``.

The encoding is stable across Python hash seeds, dict insertion
orders, and interpreter versions (for the types above).

>>> stable_digest((1, "a", 2.5)) == stable_digest((1, "a", 2.5))
True
>>> stable_digest({"b": 1, "a": 2}) == stable_digest({"a": 2, "b": 1})
True
>>> stable_digest(1) == stable_digest("1")
False
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import struct
from typing import Any


def _encode(obj: Any, out: list[bytes]) -> None:
    if obj is None:
        out.append(b"N")
    elif isinstance(obj, bool):  # before int: bool subclasses int
        out.append(b"T" if obj else b"F")
    elif isinstance(obj, int):
        body = str(obj).encode()
        out.append(b"i%d:" % len(body) + body)
    elif isinstance(obj, float):
        out.append(b"f" + struct.pack("!d", obj))
    elif isinstance(obj, str):
        body = obj.encode("utf-8")
        out.append(b"s%d:" % len(body) + body)
    elif isinstance(obj, bytes):
        out.append(b"b%d:" % len(obj) + obj)
    elif isinstance(obj, enum.Enum):
        _encode((type(obj).__name__, obj.value), out)
        out.append(b"E")
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        fields = tuple(
            (f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj)
        )
        _encode((type(obj).__name__, fields), out)
        out.append(b"D")
    elif isinstance(obj, (list, tuple)):
        out.append(b"l" if isinstance(obj, list) else b"t")
        out.append(b"%d:" % len(obj))
        for item in obj:
            _encode(item, out)
    elif isinstance(obj, (set, frozenset)):
        items = sorted(canonical_bytes(item) for item in obj)
        out.append(b"S%d:" % len(items))
        out.extend(items)
    elif isinstance(obj, dict):
        items = sorted(
            (canonical_bytes(k), canonical_bytes(v)) for k, v in obj.items()
        )
        out.append(b"d%d:" % len(items))
        for k, v in items:
            out.append(k)
            out.append(v)
    else:
        # numpy scalars and other number-likes: fold to the plain type
        # BY NUMERIC KIND, not by value (dtype-qualified reprs differ
        # across versions, and value-based folding would make
        # np.float32(2.0) digest as an int while 2.0 digests as a
        # float — the same parameter arriving with a different type
        # must not change an on-disk signature)
        import numbers

        if isinstance(obj, numbers.Integral):
            _encode(int(obj), out)
        elif isinstance(obj, numbers.Real):
            _encode(float(obj), out)
        elif isinstance(obj, numbers.Complex):
            _encode((float(obj.real), float(obj.imag)), out)
            out.append(b"C")
        else:
            raise TypeError(
                f"stable_digest cannot canonically encode "
                f"{type(obj).__name__!r}"
            )


def canonical_bytes(obj: Any) -> bytes:
    """Deterministic byte encoding of a value tree (see module doc)."""
    out: list[bytes] = []
    _encode(obj, out)
    return b"".join(out)


def stable_digest(*parts: Any) -> str:
    """Hex sha256 over the canonical encoding of ``parts``."""
    return hashlib.sha256(canonical_bytes(tuple(parts))).hexdigest()
