"""tnc_tpu_torch.serve — bra rebinding (the port's part of
``tnc_tpu.serve``).

- :class:`BoundProgram` / :func:`bind_template` / :func:`bind_circuit`
  (``rebind.py``) — one planned program per circuit *structure*;
  per-request bra leaf data is rebound, and B requests batched into one
  dispatch, without replanning.

The reference's service queue, plan cache, cross-request reuse,
replanner, multi-host and elastic layers are not ported yet (ROADMAP
A10).
"""

from tnc_tpu_torch.serve.rebind import (  # noqa: F401
    BoundProgram,
    bind_circuit,
    bind_template,
    plan_signature,
    plan_structure,
    pow2_bucket,
    stacked_bras,
    thread_batch,
)
