"""tnc_tpu_torch.queries — the query engine (the port's part of
``tnc_tpu.queries``): Pauli expectation values, marginal sweeps and
chain-rule sampling, riding the rebinding and batching machinery of
:mod:`tnc_tpu_torch.serve.rebind`:

- **Expectation values** (``expectation.py``) — ⟨ψ|P|ψ⟩ sandwich
  networks with rebindable observable leaves; Pauli-sum terms batch
  like bras through one planned program; ``value_and_grad`` through
  ``torch.autograd``.
- **Marginal sweeps** (``marginal.py``) — wildcard patterns contract as
  traced sandwich legs, returning marginal probabilities of the
  determined positions (``amplitude_sweep``'s ``'*'`` case).
- **Sampling** (``sampling.py``) — qubit-by-qubit chain-rule sampling
  over marginal sandwich networks: one planned structure per prefix
  length, conditionals rebound and batched across all in-flight
  samples, seeded-deterministic streams.
- **Dense oracle** (``statevector.py``) — brute-force ``O(2^n)`` ground
  truth for all of the above, used by the exactness pins.
- **Service handlers** (``handlers.py``) — the three types as
  ``submit()``-able requests on a
  :class:`~tnc_tpu_torch.serve.service.ContractionService` mixed queue
  with per-type batching keys.
"""

from tnc_tpu_torch.queries.expectation import (  # noqa: F401
    ExpectationProgram,
    bind_expectation,
    pauli_expectation,
    pauli_expectation_value_and_grad,
    pauli_sum_expectation,
)
from tnc_tpu_torch.queries.handlers import (  # noqa: F401
    ExpectationQueryHandler,
    MarginalQueryHandler,
    SampleQueryHandler,
    attach_query_handlers,
)
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

# NOTE: the dense-oracle helpers live in ``tnc_tpu_torch.queries.statevector``
# (not re-exported here: the module shares its name with its main
# function, and the module is the stable import path).
