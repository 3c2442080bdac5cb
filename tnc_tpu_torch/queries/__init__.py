"""tnc_tpu_torch.queries — marginal sweeps and chain-rule sampling (the
port's part of ``tnc_tpu.queries``), riding the rebinding and batching
machinery of :mod:`tnc_tpu_torch.serve.rebind`:

- **Marginal sweeps** (``marginal.py``) — wildcard patterns contract as
  traced sandwich legs, returning marginal probabilities of the
  determined positions (``amplitude_sweep``'s ``'*'`` case).
- **Sampling** (``sampling.py``) — qubit-by-qubit chain-rule sampling
  over marginal sandwich networks: one planned structure per prefix
  length, conditionals rebound and batched across all in-flight
  samples, seeded-deterministic streams.

Expectation values, the service handlers and the dense oracle are not
ported yet (ROADMAP A8, A10).
"""

from tnc_tpu_torch.queries.marginal import (  # noqa: F401
    bind_marginal,
    marginal_probabilities,
    marginal_sweep,
    wildcard_mask,
)
from tnc_tpu_torch.queries.sampling import (  # noqa: F401
    ChainSampler,
    sample_bitstrings,
)
