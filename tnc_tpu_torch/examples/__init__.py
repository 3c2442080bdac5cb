"""The reference's eight examples, on the port.

Each is a module with a ``main()`` that prints what the reference's
example prints and returns the values it printed (amplitudes, norms,
gradients, costs):

- :mod:`.local_contraction` — a QASM2 GHZ circuit to its statevector;
- :mod:`.amplitude_sweep` — 32 amplitudes of a 16-qubit circuit in one
  batched call;
- :mod:`.autodiff_gradients` — gradients through ``torch.autograd``;
- :mod:`.approximate_peps` — the boundary-MPS chi sweep of a 4x4 PEPS, the
  chi ladder, and an ``rtol=`` request through ``ContractionService``;
- :mod:`.repartitioning` — simulated annealing on a partitioning (host
  only);
- :mod:`.distributed_contraction` — Sycamore-12 over 4 partitions;
- :mod:`.sliced_partitioning` — Sycamore-16, 4 partitions, sliced;
- :mod:`.strategy_selection` — partitioning, tree cut and slices over 8
  device slots.

Every device example runs on the card (``TorchBackend()``, ``backend=
"torch"``) and raises without CUDA; ``TNC_TPU_PLATFORM=cpu`` runs it on
the host. The multi-device examples take the reference's device count
(4, 4 and 8) as device slots placed on the visible cards in turn
(:func:`~tnc_tpu_torch.parallel._devices.device_slots`): one card runs
them all on ``cuda:0``.

Run:  python -m tnc_tpu_torch.examples.local_contraction
      TNC_TPU_PLATFORM=cpu python -m tnc_tpu_torch.examples.local_contraction
"""
