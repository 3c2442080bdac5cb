#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tnc_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs one CUDA device and ``nvcc`` (``CUDA_HOME`` or ``/usr/local/cuda``).
Phases, each of which raises on failure (nothing is caught):

1. the card's name and power limit; build the three hand kernels from
   ``tnc_tpu_torch/ops/csrc`` (one ``nvcc`` per source, in parallel) and
   print each kernel's registers and spills from ``ptxas -v``;
2. plan the main path's configuration — a 28-qubit, depth-12 random
   circuit on the Sycamore layout (p1 = p2 = 0.4, seed 42), contracted to
   its open statevector with the ``Greedy`` path — and hold each kernel
   against its plain PyTorch version on the card at the program's own
   shapes: every chain group through ``fused_chain`` (planned once, the
   form it takes printed, two launches bitwise equal, the error also
   against the chain in float64); the chain kernel's grid form on a
   synthetic chain whose carried value exceeds shared memory, and the
   floor of one empty launch of each form; every distinct
   shape the forced ``fused`` rung launches (and a ragged shape) through
   ``fused_complex_dot``, the stem's result also against a float64
   product beside cuBLAS's; one float64 case each; time kernel, plain
   version and library call (device and wall time per call, from CUDA
   events) beside the bound, ``fused_complex_dot``'s record weighted by
   the rung's launches; every kernel row is also timed inside a CUDA
   graph (its calls captured by the port's ``graphs.GraphSet`` and
   replayed), whose output must have the eager launch's bits;
3. the main path: ``contract_tensor_network(tn, path, TorchBackend())``
   once to warm up and twice timed, launch counts (and the chain's
   launches by form) reset just before each timed run and read just
   after it;
4. correctness: statevector norm, four amplitudes against complex128
   amplitude networks contracted natively on the card, and the whole
   20-qubit statevector against the complex128 numpy oracle;
5. the forced ``fused`` rung (``TNC_TPU_COMPLEX_MULT=fused``) of the same
   contraction, which must launch ``fused_complex_dot``;
6. where the time goes: the device-resident part of the main path timed
   alone, and one run under ``torch.profiler`` (device time by kernel,
   busy share);
7. the PEPS cell — the norm of ``peps(4, 4, 2, 32, 0)`` with seeded
   random leaves at the O(1) scale 2^-4.5, ``Greedy`` path: first
   ``fused_transpose_dot`` against its plain version at each distinct
   shape of the steps its gate admits (float64 once; the heaviest, steps
   18/19, also against a float64 product beside cuBLAS's), timed beside
   the bound, the plain version and ``torch.einsum`` and weighted by the
   steps that have each shape; then the norm under the
   default policy (one warm-up, one timed run, the device-resident part
   and a profile), under the forced ``fused_transpose`` rung (its launches
   and routed steps must equal the plan's gate), both against the norm in
   complex128 on the card; and ``peps(3, 3, 2, 16, 0)`` on the forced
   rung against the complex128 numpy oracle; the CUDA-event time of every
   step of the PEPS norm (``run_steps_timed``); the norm on the forced
   rung through ``bind_resident``, three calls (eager; captured and
   replayed; replayed), each the first's bits in a fresh tensor;
8. the sliced cell on the per-slice loop, unhoisted
   (``TorchBackend(sliced_strategy="loop", hoist=False)``) — one amplitude
   of ``sycamore_circuit(53, 10, default_rng(42))`` on the all-zeros
   bitstring, ``simplify_network``, ``Greedy`` path, ``find_slicing`` to
   2^29 elements: 128 slices of 169 steps. ``fused_chain`` against its
   plain version on the chain operands
   slice 0 builds; ``contract_tensor_network_sliced`` once to warm up and
   once timed (``fused_chain`` launched once per chain and slice);
   the device-resident part, a profile of four eager slices and the CUDA-event
   time of every step of slice 0; slices 0-7 and the whole amplitude against
   complex128 on the card (the first 32 slices only if complex128 of all
   would take over 30 s); the forced ``fused`` rung on slices 0-7 (its
   ``fused_complex_dot`` launches held against the plain version on slice
   0's operands, its launches and routed steps against the plan's gate,
   its sum against the default rung's); a 20-qubit depth-6 amplitude over
   4 slices against the complex128 numpy oracle;
9. the same cell on the default ``TorchBackend()``: the slice-invariant
   stem hoisted (128 steps, once), the 41 residual steps chunked and
   batched over 8 slices at a time. The plan (prelude and residual, chunks,
   modes, the batch requested and run, the modeled peak); the amplitude
   once to warm up and once timed; the device-resident part, the
   prelude timed apart and a profile of one eager batch of the residual;
   the amplitude against
   phase 8's complex128 partials and the loop's amplitude; the forced
   ``fused`` rung on the first two batches (the ``fused_complex_dot``
   launches of the first, batched over the slices, held against the plain
   version on the operands the executor builds, each distinct pair of
   operand shapes once; launches and routed steps against the
   plan's gate; the sum against the default rung's); then
   ``sycamore_circuit(20, 6, rng 7)`` over 4 slices and ``(20, 8, rng 7)``
   over 16, whose residuals keep chains, against the numpy oracle, each
   batched ``fused_chain`` launch held against its plain version (2
   launches each);
10. the north star, BASELINE config #3: ``sycamore_circuit(53, 14,
   default_rng(42))`` on the all-zeros bitstring, simplified, planned
   afresh by the port's ``plan_northstar`` — ``Hyperoptimizer`` (128
   trials, target 2^29) and ``slice_and_reconfigure`` with the
   reference's defaults, its wall seconds, trial pool and planner
   engines (native or Python) printed. The plan is host work: a process
   of its own (``python3 chip_smoke.py --northstar-plan-to DIR``, its
   trial pool one worker short of the host's cores) makes it while
   phases 2-9 run on the card, and this phase waits for it and loads it.
   It is held to its per-slice peak (at
   most 2^29 elements) and to within 1.25x of the sliced flops of the
   reference's plan; the default path's plan (prelude, residual chunks,
   modes, chains, batch, modeled peak) and the transpose gate's count;
   each chain of the first batch held against its plain version; the
   first 24 of its 4096 slices (``NORTHSTAR_RUN``; all of them take ~11
   minutes) through ``TorchBackend().execute_sliced`` (a warm-up batch,
   one timed run), the device-resident part, the prelude apart and a
   profile of one batch; slices 0-15 one by one and the sum of the
   slices run against complex128 on the card; the forced ``fused`` rung
   on the first two batches, as in phase 9;
   In phases 8-10 and the small amplitudes the timed runs are the
   executors' default, which replays a CUDA graph of the loop's body for
   every slice after the first, or one graph per chunk for every batch
   after the first (the 4-slice amplitude is also run in batches of 2, so
   that a batch replays); each cell also runs once eagerly
   (``graphs=False``), and the two must agree bit for bit, in launch and
   routing counts and within 1.05x in peak memory. Printed per cell
   (``[graphs ...]``): ms per batch or slice of each from CUDA events
   around every batch, the capture's host ms, graphs and replays; and
   the busy share of one replayed batch (the second replay of a call of
   three batches or slices, the first where a cell has two), run alone
   under ``torch.profiler`` beside its ``fused_chain`` records and
   launches, as one eager batch is profiled;
11. the calibrated kernel ladder: with ``obs.configure(enabled=True,
   step_time=True)`` and a fresh registry, random28 and peps44_b32 run once
   each through ``contract_tensor_network(..., TorchBackend())`` on the
   default policy (planned before any sample exists; one untraced warm-up
   first), every launch unit synchronised inside its step span; the
   device model fitted to the card's ``torch`` samples
   (``fit_device_model``: flops/s, bytes/s, launch seconds, terms) and the
   worst-predicted steps; step timing and tracing off, the registry kept,
   a fresh ``TorchBackend()`` plans both cells through ``kernel_policy``,
   whose rungs (chains and chained steps, strassen, fused_transpose, gauss,
   ``high``) and chain ceiling are printed beside the no-model policy's;
   every chain the calibrated policy forms held against its plain version;
   each cell under it, one warm-up and one timed run, ``fused_chain``
   launches held to the policy's chains and ``fused_transpose_dot``
   launches plus routed steps to its ``fused_transpose`` steps, results
   held to phase 3's statevector (the forced rung's tolerance), the four
   complex128 amplitudes of phase 4 and phase 7's norms, wall and
   device-resident times beside phases 3 and 7; then ``gauss`` against one
   Strassen level on square FP32 split products at n = 1024 to 8192 and at
   the PEPS cell's Strassen stems, each measured saving beside
   ``_strassen_saving_s`` under the fitted model, and the smallest n at
   which Strassen wins (no constant changes); the registry is then reset;
12. the batched amplitude sweep (``sycamore53_m8_sweep``): 8 bitstrings
   (all zeros and 7 rows of ``default_rng(7)``) of the raw
   ``sycamore_circuit(53, 8, default_rng(42))`` amplitude network through
   ``amplitude_sweep`` — one ``TorchBackend().execute_batched``, the bras
   a leading batch axis of every buffer they reach: each distinct
   ``fused_chain`` launch held against its plain version (the chains on
   the bra batch batched, the others once), one warm-up and two timed
   runs (wall, the CUDA-event span of ``execute_batched``, peak, launches
   by form held to the policy's chains), each amplitude against
   complex128 on the card within 1e-4 max|ref| and against the bitstrings
   run alone within 1e-5 max|alone|; the same bitstrings through
   ``bind_template`` / ``BoundProgram.amplitudes`` (the sweep's program:
   bitwise equal), two through the sliced serving branch
   (``target_size=2**26``); the forced ``fused`` rung on the sweep (each
   distinct batched ``fused_complex_dot`` launch held against its plain
   version, launches and routed steps against the plan's gate); and at 20
   qubits (``sycamore_circuit(20, 8, rng 42)``) ``marginal_sweep`` of 16
   patterns against the complex128 statevector on the card (its chains
   held against the plain version), ``amplitude_sweep`` of the same
   patterns on the same route, and ``ChainSampler(...).sample(64,
   seed=0)`` against the complex128 sampler (conditionals within 1e-5;
   samples equal except where a uniform lies within 1e-4 of a threshold);
13. gradients and the approximate tier: BASELINE config #4,
   ``qaoa_circuit(30, 2, default_rng(42))`` on a line — its ⟨Z…Z⟩ through
   ``pauli_expectation(..., backend=TorchBackend())`` (each distinct
   ``fused_chain`` held against its plain version; one warm-up, three
   timed runs) within 1e-5 absolute and 1e-3 relative of the complex128
   numpy value; the MaxCut
   energy's ``pauli_expectation_value_and_grad`` over every gate leaf in
   complex64, timed beside its forward alone and profiled once for the
   card's busy share, its value against
   ``pauli_sum_expectation``, its cotangents by the linearity oracle in
   complex128 on the card on 8 seeded leaves, d/dγ of round 1 against a
   central difference; ``sliced_contraction_value_and_grad`` of the
   amplitude "0"x53 of ``sycamore_circuit(53, 8, default_rng(42))`` (raw
   network, ``Greedy``, ``find_slicing`` to 2^26.15: 32 slices) over 8
   seeded leaves, timed beside the sliced forward and one slice's
   forward-with-grad, its
   value against the complex128 slices, its cotangents by the linearity
   oracle against the unsliced complex128 forward, its peak within 1.5x of
   one slice's; ``amplitude_sweep_value_and_grad`` of 16 bitstrings of
   ``sycamore_circuit(20, 8, default_rng(42))`` by the product rule in
   complex128; and the boundary-MPS sweep on the card
   (``backend="torch"``): the QAOA ⟨Z…Z⟩ up ``ChiLadder(chi_cap=64)`` in
   complex128 (must converge) and complex64 (its top two rungs),
   ``peps(6, 6, 2, 2, 1)`` in
   complex128 up to its exact chi 512 (against the numpy host sweep), and
   ``peps(8, 8, 2, 2, 1)`` in complex64 up to chi 256, every rung's err at
   least its distance from the exact value, each rung's seconds (its
   ``approx.sweep`` span, tracing on) beside ``rung_seconds`` under phase
   11's fitted model, and one 8x8 rung profiled for the card's busy share;
14. the serving front end and resilience (every answer held to complex128):
   ``ContractionService.from_circuit`` of phase 12's circuit on one
   ``TorchBackend()`` with a plan cache (``max_batch=8``, ``max_wait_ms=20``),
   40 amplitude requests from 4 threads in 5 rounds (5 repeats, collapsed by
   dedup) within 1e-4 max|ref|, latency percentiles, batches and peak memory;
   a deadline of 0, a transient and a fatal ``serve.dispatch`` fault (retry
   in place; one batch degraded to 8 singletons), a transient
   ``backend.dispatch`` fault, a ``max_queue=2`` service rejecting, a warm
   ``from_circuit`` that hits the cache and plans nothing; the same service
   over an ``IntermediateStore`` (residual steps, cached bytes and their
   upload seconds, the store's counts); the sliced branch planned to 2^21
   (128 slices) under ``TNC_TPU_CKPT`` with a checkpoint every 8 slices:
   interrupted at the batch starting at slice 64 and resumed there bitwise,
   an injected OOM at slice 32 halving the batch to 4, a fault inside a
   CUDA graph capture retried bitwise; ``sycamore_circuit(20, 8)`` with
   ``queries=True``, amplitudes, marginals, samples and Pauli sums
   interleaved from 4 threads, no batch mixing two batching keys; and
   config #4's circuit with ``approx=True`` (``chi_cap`` 8): the exact
   ⟨Z…Z⟩, ``rtol=1e-2`` met by the ladder with an honest error bar,
   ``rtol=1e-7`` escalated at the ``COMPLEX64_ERR_REL`` floor;
15. the in-process serving planes: phase 14's Sycamore-53 rows served with
   the background replanner (its bounded ``Hyperoptimizer`` swapping the
   Greedy plan, both predicted costs printed), the shared-cache watcher,
   the telemetry endpoint (``/metrics`` and ``/healthz`` scraped over
   loopback during a round, the completed count that of ``stats()``), the
   SLO engine (no burn alert until a ``slow`` ``serve.dispatch`` fault
   longer than the budget, 5x round 0's median latency, then one in
   ``stats()["slo"]`` and on ``/slo``), the cost-truth loop (a manual
   refit published to a ``ModelRegistry`` and adopted, ``policy_key()``
   unchanged), a round under ``maybe_jax_profiler_trace`` (a non-empty
   torch trace) and the Chrome trace exported at the end (its rollup counts
   every request); a second service picking the swapped plan up through
   ``SharedCacheWatcher.poll_once``; phase 12's all-zeros amplitude at
   2^26 through ``execute_sliced_resilient`` on the per-slice loop under a
   memory cap below its modeled peak (a real CUDA OOM, a replan to a
   slicing that fits, the allocated memory back where it was, the
   amplitude within 1e-5 relative of complex128), then its fallback rung
   (an injected ``oom``, the chunked executor at batch 1);
   ``sycamore_circuit(20, 8)`` with ``plansvc=True``, a round before and a
   round after the pod's merge swaps the plan. Every answer is held to
   complex128 and every ``fused_chain`` launch to its plain version;
16. the partitioned planner: BASELINE config #4's ⟨Z…Z⟩ network,
   simplified, planned as the reference bench plans it —
   ``find_partitioning(tn, 4)``, four work-bounded rounds of simulated
   annealing with ``IntermediatePartitioningModel`` (48 chains a round on
   the spawn pool, ``random.Random(42)``; each round's best score
   printed), ``compute_solution`` (and, priced by phase 11's fitted model,
   its predicted critical path in seconds) — contracted through
   ``TorchBackend(dtype="complex64").bind_resident`` (three calls: eager,
   captured, replayed) within 1e-5 absolute and 1e-3 relative of the
   complex128 numpy value, its steps, multiply-adds and peak beside the
   ``Greedy`` plans'; the same network under ``Greedy`` and under
   ``balance_partitions_iter``'s plan on the same gates; then the tree
   cut: phase 12's raw network, its ``Greedy`` SSA path cut into 4 blocks
   by ``plan_treecut(..., seed=3)``, ``compute_solution_with_paths`` with
   the GREEDY fan-in, contracted on ``TorchBackend()`` (one warm-up, three
   timed runs: wall, CUDA-event seconds, peak against
   ``compute_memory_requirements``; the device-resident part timed and
   profiled for the card's busy share) within 1e-4·max(|ref|, 2^-14) of
   complex128 on the card and of phase 12's value. Every chain of every
   plan is held against its plain version;
17. the multi-GPU executors (``tnc_tpu_torch.parallel``) on the one card:
   phase 16's tree cut through ``distributed_partitioned_contraction`` on
   ``[cuda:0] * 4`` (the local phases on streams of their own, the fan-in
   by ``.to()``), then with ``hbm_bytes`` at half the largest partition's
   modeled peak, so that it slices locally through the chunked executor
   (each: the local phase timed together and one by one, one counted run
   with its fan-in levels' bytes and flops, the amplitude within
   1e-4·max(|ref|, 2^-14) of complex128); BASELINE config #5 planned as
   ``bench.py:1442-1500`` plans it (``sycamore_circuit(24, 20, rng 42)``,
   ``find_partitioning`` into 8, four work-bounded SA rounds,
   ``compute_solution``) through ``partitioned_sliced_executor`` on
   ``[cuda:0] * 8`` at the bench's 16 GiB budget, ``run(1)``, ``run(2)``
   and ``run()``, the sum against a complex128 contraction of the
   flattened plan on the card; phase 8's amplitude through
   ``distributed_sliced_contraction`` in a spawned rank of an NCCL group,
   all 128 slices, within 1e-4·Σ_s|ref_s| of phase 8's complex128
   slices; and two spawned gloo ranks sharing ``cuda:0`` over a
   ``TCPStore``: ``broadcast_path`` of config #4's plan, its
   process-sharded contraction (the same bits on both ranks, phase 16's
   gates), phase 8's amplitude over the two ranks (64 slices each, the
   ranks bitwise equal, within those gates of the NCCL rank's value), and
   ``gather_objects`` with rank 1 withholding its part (``GatherLost(1)``).
   Every ``fused_chain`` launch, the ranks' included, is held against its
   plain version; a rank that fails or outlives its timeout fails the run
   (the group killed first);
18. the fleet on one card (``tnc_tpu_torch.serve.multihost``,
   ``serve.elastic``, ``obs.fleet``): two spawned gloo ranks sharing
   ``cuda:0`` over a ``TCPStore``, both binding phase 14's two Sycamore-53
   depth-8 programs from a plan cache the parent fills (no planner call in
   either rank): the sliced program at 2^21 through a ``ClusterDispatcher``
   (64 slices a rank, the range partials summed within 1e-4 max|ref| of
   phase 14's uninterrupted value); rank 0's ``ContractionService`` over
   the serving program with a roster-aware ``ClusterDispatcher``,
   ``attach_fleet`` and ``serve_telemetry``, rank 1 in ``serve_cluster``
   with a registry, telemetry and the flight recorder: rounds of phase
   14's rows, every row bitwise one process's ``amplitudes_det`` of its
   shard and within 1e-4 max|ref| of complex128, the ranks on one
   ``policy_key``; rank 1's dispatch spans (and its flight dump) wearing
   the root's riders and sequence; rank 0's ``/fleet`` listing both
   replicas live and summing rank 1's batches; rank 1 SIGKILLed on a
   command: its slot ``GatherLost``, its rows recomputed bitwise at the
   root, one ``serve.elastic.reassigned``, no request failed, and once its
   heartbeat is stale a round with no range for it that waits for nothing;
   then elastic scheduling on rank 0 (a tenant over its quota rejected, the
   dispatch order ``weighted_fair_order``'s, a priority request next and
   nothing preempted: the card's backend has no slice hooks). Every
   ``fused_chain`` launch of both ranks is held against its plain version;
   the ranks' peaks together must fit the card;
19. the benchmark CLI (``python -m tnc_tpu_torch.benchmark``) on two
   OpenQASM 2.0 circuits the phase writes from ``default_rng(42)``
   (``qasm_text``: 28 and 24 qubits, 12 rounds on the Sycamore couplers;
   qelib1 and registry gates, a user ``gate`` with parameter expressions, a
   register broadcast), imported by the port's QASM importer: ``sweep``
   with ``tree-temper`` (28 qubits) and ``greedy`` over 2 partitions (24
   qubits) in a process of its own beside phases 2-9 (``python3
   chip_smoke.py --qasm-sweep-to DIR``), which also sweeps both again (every
   cell skipped) and computes the observable network's complex128 numpy
   value; then one ``run`` process over both artifacts (``--repeats 2``,
   ``--backend torch``, ``TNC_TPU_PLATFORM`` unset), held to its outputs
   (one ``OptimizationResult`` and one ``RunResult`` a cell, ``Done`` for
   every id, no ``ERROR`` log record), not its exit code; each artifact
   loaded with ``ArtifactCache.load`` and contracted once on
   ``TorchBackend()``, synchronised and timed, every chain recorded and
   held after the run against its plain version: the norm within 1e-4 of
   1 and four amplitudes against complex128 amplitude networks on the card
   (one tree-tempered path for the four);
   the 24-qubit cell's 2-partition plan once more through the CLI's
   ``--distributed`` (``benchmark.driver.do_run(..., distributed=True)``
   in this process: one device slot a partition on ``cuda:0``, its
   statevector within 1e-5 relative of the in-process contraction, its
   chains held); and ``random_circuit_with_observable(16, 8, 0.4, 0.4, 0.5,
   default_rng(42), SYCAMORE)`` on the card within 1e-5 of numpy;
20. the port's examples (``tnc_tpu_torch/examples/``): the seven that touch
   the device (``repartitioning`` is host-only) through their ``main()``,
   with the reference's sizes and seeds, the multi-device ones on
   ``[cuda:0] * 4``, ``* 4`` and ``* 8``; each synchronised and timed, its
   own asserts met, its returned values held to the complex128 host oracle
   at the gates above, and every ``fused_chain`` launch it made (CUDA-graph
   replays included) held after it against the plain version;
21. the dot-precision rungs ``high`` (3xTF32) and ``default`` (one TF32
   pass) on the card. At a TF32 rung every step outside the chains and
   the admitted ``fused_transpose`` steps runs ``fused_complex_dot``'s
   tensor-core tile, whatever its mode. Each kernel at each rung against
   its plain version at that rung (1e-5·max|plain|; where two FP32 orders
   of a long, cancelling sum differ by more, the kernel as near a float64
   product as twice the plain version), on an exact single-product probe
   (each rung's own bits, which FP32 arithmetic does not give), and
   against a float64 computation from the same FP32 inputs (relative
   Frobenius: ``high`` within 2^-20 a product or twice the plain float32
   version's error, ``default`` at least 10x ``high``'s), timed beside its
   float32 time, its plain version, the bound at the tensor cores' TF32
   rate (494.7 TFLOP/s, or the bytes) and the library call (a complex64
   ``matmul`` / ``einsum`` with TF32 on at ``default``, none at ``high``):
   ``fused_transpose_dot`` at every layout the PEPS cell's forced
   ``fused_transpose`` rung launches and ``fused_chain`` on each of
   random28's chains, with random operands; every ``fused_complex_dot``
   launch of the runs below recorded (each distinct shape's operands once,
   a large one's leading block) and held after its run. Then at each rung,
   counts reset just before each run and read just after: random28 under
   the forced ``fused`` rung and through ``contract_tensor_network`` with
   ``TorchBackend(precision=r)`` (its chains through ``fused_chain`` at the
   rung), the PEPS norm under the forced ``fused_transpose`` rung (each
   run's ``fused_complex_dot`` launches equal to its steps and to the
   recorded count), and at ``high`` the m10 amplitude on the chunked path
   (its chains recorded and held after the run). ``high`` meets the
   complex64 gates against phases 4, 7 and 8's complex128 values; the
   ``default`` errors are printed and must be finite and larger;
22. one JSON line of path numbers (with each kernel's per-shape rows,
   float64 errors and launches by path), one of per-kernel numbers over
   the launches of every path (each kernel's top-level numbers the float32
   paths', ``launches`` every rung's, ``by_rung`` each rung's launches,
   times, bound and library time), the card line, and the last line
   ``{"ok": true, "device": {...}}``.

It exits non-zero without a result when CUDA is unavailable or the
``tnc_tpu_torch`` package is not beside it.

``python3 chip_smoke.py --northstar-full`` builds the kernels and runs
phase 10 alone over all the north star's slices through
``contract_tensor_network_sliced``, once timed, complex128 on the first
256 slices (about a quarter of an hour on one H100), and ends with its
JSON record and the card line. ``python3 chip_smoke.py --calibrated`` builds
the kernels and runs phase 11 alone (its references made first: the default
policy's statevector and PEPS norm, the amplitudes and the norm in
complex128), and ends with its JSON record and the card line.
``python3 chip_smoke.py --sweep`` builds the kernels and runs phase 12
alone, and ends with its JSON record and the card line.
``python3 chip_smoke.py --grad`` builds the kernels and runs phase 13 alone
(its rungs then have no fitted model to be priced by), and ends with its
JSON record and the card line. ``python3 chip_smoke.py --serve`` builds the
kernels and runs phase 14 alone, and ends with its JSON record and the card
line. ``python3 chip_smoke.py --planes`` builds the kernels and runs phase 15
alone (its complex128 references made through the swapped plan), and ends
with its JSON record and the card line. ``python3 chip_smoke.py
--partitioned`` builds the kernels and runs phase 16 alone (no fitted model,
no phase 12 value), and ends with its JSON record and the card line.
``python3 chip_smoke.py --parallel`` builds the kernels, runs phase 16 (for
its plans), makes phase 8's plan and complex128 slices, runs phase 17, and
ends with its JSON record and the card line. ``python3 chip_smoke.py
--fleet`` builds the kernels, makes phase 14's complex128 amplitudes of the
rows phase 18 serves and its sliced cell's uninterrupted value, runs phase
18 alone, and ends with its JSON record and the card line. ``python3
chip_smoke.py --qasm`` builds the kernels, makes phase 19's sweeps (waiting
for them), runs phase 19 alone, and ends with its JSON record and the card
line. ``python3 chip_smoke.py --examples`` builds the kernels, runs phase 20
alone, and ends with its JSON record and the card line. ``python3
chip_smoke.py --precision`` builds the kernels, makes phase 21's complex128
references (random28's four amplitudes, the PEPS norm, m10's slices), runs
phase 21 alone, and ends with its JSON record and the card line.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

QUBITS = 28
DEPTH = 12
SEED = 42
SMALL_QUBITS = 20  # the configuration checked whole against the host oracle
# the PEPS cell: peps(length, depth, physical_dim, virtual_dim, layers), its
# norm contracted exactly; and a small one checked against the host oracle
PEPS = (4, 4, 2, 32, 0)
PEPS_SMALL = (3, 3, 2, 16, 0)
# the sliced cell: a Sycamore single amplitude (qubits, depth, rng seed, log2 of
# the slicing target), and a small one checked against the host oracle
SLICED = (53, 10, 42, 29)
MAIN_SLICED_REPS = 1  # timed runs of its 128 slices in phases 8 and 9
SLICED_SMALL = (20, 6, 7, 7)
# the small amplitudes whose residuals keep chains on the default sliced path
# (the cell's residual has none): 4 slices in one batch, 2 chains; 16 slices
# in two batches of 8, 1 chain
CHUNKED_SMALL = ((20, 6, 7, 7), (20, 8, 7, 17))
SLICED_CHECK_S = 30.0  # complex128 of every slice if it takes at most this, else 32
FUSED_RANGE = (0, 8)  # the slices the sliced cell's forced fused rung runs
# the north star, BASELINE config #3: (qubits, depth, rng seed, hyper-optimizer
# trials, log2 of the slicing target), planned by the port's Hyperoptimizer and
# slice_and_reconfigure with the reference's defaults
NORTHSTAR = (53, 14, 42, 128, 29)
# sliced flops of the reference's plan of the same arguments, made with tnc_tpu on
# an 8-core CPU (PERF.md); the plan's clock budgets depend on the host's speed, so
# the port's plan is held to within NORTHSTAR_QUALITY of it, not to equality
NORTHSTAR_REF_SLICED_FLOPS = 7.894e13
NORTHSTAR_QUALITY = 1.25
NORTHSTAR_PARITY = 16  # slices held one by one (the reference bench's parity_slices)
NORTHSTAR_CHECK_S = 60.0  # complex128 of every slice if it takes at most this,
NORTHSTAR_CHECK_FEW = 256  # else of this many
# the slices phase 10 contracts, 3 batches of 8 (a replayed batch between two
# others): all 4096 take ~11 min on the card, more than this script's time
# allows (24, not 64, since phases 15 and 17 need the room);
# `python3 chip_smoke.py --northstar-full` contracts them all
NORTHSTAR_RUN = 24
# the full run plans the north star in a process of its own while phases 2-9 run
# (host work beside device work); phase 10 waits at most this long for it
NORTHSTAR_PLAN_FLAG = "--northstar-plan-to"
NORTHSTAR_PLAN_WAIT_S = 900.0
# the square FP32 split products the Strassen crossover is timed at (phase 11)
STRASSEN_SIZES = (1024, 2048, 4096, 8192)
# the batched sweep (phase 12): a Sycamore amplitude network (qubits, depth, rng
# seed) closed on SWEEP_BATCH bitstrings at once, the all-zeros one and rows of
# default_rng(SWEEP_BITS_SEED); two of them also through the sliced serving
# branch, planned to 2^SWEEP_SLICED_TARGET elements
SWEEP = (53, 8, 42)
SWEEP_BATCH = 8
SWEEP_BITS_SEED = 7
SWEEP_SLICED_TARGET = 26
SWEEP_SLICED_ROWS = 2
# the queries (phase 12): marginal sweeps and chain sampling at the width at
# which Greedy plans the sandwich networks (at 30 qubits and more their peak
# passes 2^38); the marginal patterns fix the first QUERY_FIXED qubits
QUERY = (20, 8, 42)
QUERY_FIXED = 10
QUERY_PATTERNS = 16
QUERY_SAMPLES = 64
SAMPLE_NEAR = 1e-4  # a uniform this close to a threshold may fall either way

# phase 13: BASELINE config #4 (bench.py:1349-1397), qaoa_circuit(30, 2,
# default_rng(42)) on a line, its <Z...Z> and MaxCut energy with gradients
QAOA = (30, 2, 42)
GRAD_SLOTS = 8  # seeded leaves each gradient is held to the linearity oracle on
GRAD_SEED = 11
GRAD_EPS = 1e-4  # the central difference of d/dgamma
# the sliced gradient at real size: phase 12's sweep circuit, raw network,
# Greedy, find_slicing to 2^26.15 (32 slices, so that the peak gate below sees
# a state kept across slices), unless the gradient would pass
# GRAD_SLICED_BUDGET_S at the fitted rate below three times over: then
# 2^26.25 (16 slices)
GRAD_SLICED = (53, 8, 42, 26.15)
GRAD_SLICED_FALLBACK = 26.25
GRAD_SLICED_BUDGET_S = 60.0
FITTED_MADDS_PER_S = 9.8e12  # phase 11's fitted complex multiply-adds/s (PERF.md)
GRAD_SWEEP = (20, 8, 42)  # phase 12's query circuit
GRAD_SWEEP_BITS = 16
# the approximate tier: the QAOA <Z...Z> ladder, then PEPS sandwiches
# peps(L, L, 2, 2, 1) with data from default_rng(3) at unit_scale (the
# default per-leaf scale puts the 8x8 value near 1e-43, under float32's
# normal range), (L, chis, dtype)
APPROX_QAOA_CAP = 64
APPROX_QAOA_START = 4  # the QAOA ladders' first rung
APPROX_PEPS = ((6, (16, 32, 64, 128, 256, 512), "complex128"),
               (8, (16, 32, 64, 128, 256), "complex64"))
APPROX_PROFILE_CHI = 64  # the 8x8 rung profiled for the card's busy share

# phase 14: the service serves SERVE_ROUNDS rounds of SERVE_BATCH amplitude
# requests of phase 12's circuit (SERVE_BATCH - 1 distinct and one repeat a
# round); the checkpointed sliced branch plans to 2^CKPT_TARGET elements (128
# slices: phase 12's 2^26 gives 4). Five rounds (eight until phase 18 came):
# phase 15 serves round 4 and phase 18 rounds 0-4; every row's complex128
# reference is made on the card
SERVE_ROUNDS = 5
SERVE_BATCH = 8
CKPT_TARGET = 21
# phase 15: the in-process serving planes. The SLO objective's budget is
# PLANES_SLO_FACTOR times round 0's median latency; the watcher's replica
# serves round PLANES_ROUNDS of phase 14's rows; the plansvc cell plans phase
# 14's mixed circuit under 2^PLANSVC_TARGET elements (above its Greedy peak,
# 2^16.6, so that its plans stay unsliced) with PLANSVC_TRIALS trials; the
# degrade cell caps the card's memory at DEGRADE_CAP of its program's modeled
# peak above what the allocator holds, holds the amplitude to DEGRADE_REL of
# complex128 and the memory after the ladder to DEGRADE_SLACK bytes of before
PLANES_ROUNDS = 4
PLANES_SLO_FACTOR = 5.0
PLANSVC_TARGET = 17
PLANSVC_TRIALS = 6
DEGRADE_CAP = 0.9
DEGRADE_REL = 1e-5
DEGRADE_SLACK = 64 << 20
# phase 16: the partitioned planner. Config #4 split into PARTS blocks by
# find_partitioning, then SA_ROUNDS work-bounded rounds of SA_TRIALS chains
# (the bench's engine settings, bench.py:1013-1053, its plan independent of
# the host); phase 12's raw network cut into TREECUT_PARTS blocks by
# plan_treecut(seed=TREECUT_SEED), its fan-in drawn from random.Random(TREECUT_RNG)
PARTS = 4
SA_ROUNDS = 4
SA_TRIALS = 48
TREECUT_PARTS = 4
TREECUT_SEED = 3
TREECUT_RNG = 0

# published H100 SXM peaks (dense, no sparsity) the bounds are taken from
# phase 17: the multi-GPU executors on one card
PARALLEL_DEVICES = 4  # the tree cut's partitions on [cuda:0] * 4
CONFIG5 = (24, 20, 42, 8)  # BASELINE config #5 (bench.py:1427-1430): qubits, depth, seed, k
CONFIG5_HBM = 16 << 30  # the bench's pinned device budget (bench.py:1475)
CHILD_TIMEOUT_S = 300.0  # a spawned rank's limit from the phase's start
# phase 18: the fleet on one card. Two gloo ranks share cuda:0: rank 0 serves
# FLEET_ROUNDS rounds of phase 14's rows through a ClusterDispatcher while rank 1
# parks in serve_cluster; then rank 1 is killed in the next round. The heartbeat,
# staleness and gather bounds set how long the worker loss waits
FLEET_ROUNDS = 3
FLEET_HEARTBEAT_S = 0.5
FLEET_STALE_S = 2.0
FLEET_TIMEOUT_S = 3.0
# phase 19: the benchmark CLI (python -m tnc_tpu_torch.benchmark sweep|run) on two
# QASM circuits the phase writes: (name, qubits, sweep method, partitions), each
# QASM_ROUNDS rounds on the Sycamore layout's couplers from default_rng(QASM_SEED)
QASM_CELLS = (("qasm28_d12", 28, "tree-temper", 4), ("qasm24_d12", 24, "greedy", 2))
QASM_ROUNDS = 12
QASM_SEED = 42
QASM_P1 = QASM_P2 = 0.4  # single- and two-qubit gate probabilities, as random28's
QASM_REPEATS = 2  # the run process's --repeats
QASM_AMPLITUDES = 4  # amplitudes of each circuit held to complex128 on the card
QASM_SWEEP_FLAG = "--qasm-sweep-to"
QASM_RUN_TIMEOUT_S = 300.0
# the observable network held to numpy: random_circuit_with_observable(qubits,
# rounds, p1, p2, p_observable, default_rng(seed), SYCAMORE)
OBSERVABLE = (16, 8, 0.4, 0.4, 0.5, 42)

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}  # CUDA-core FMA rates
# real flops per complex multiply-add in a bound: the Gauss identity needs
# three real products (6 flops), the least any lowering of the product
# needs, and what the single-product hand kernels do
COMPLEX_MAC_FLOPS = 6.0

F32_REL_TOL = 1e-5
F64_REL_TOL = 1e-12
# cycles of torch.cuda._sleep per second, at or above the H100's top SM
# clock (1980 MHz), so a sleep lasts at least its nominal time
SLEEP_CYCLES_PER_S = 2.0e9


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, reps: int = 20, warmup: int = 2) -> tuple[float, float]:
    """``(device_ms, wall_ms)`` per call of ``fn()``, both from CUDA events.

    ``wall_ms``: events around a loop of ``reps`` back-to-back calls, over
    ``reps`` — what a caller waits per call, host overhead included.
    ``device_ms``: the same loop queued behind ``torch.cuda._sleep`` (twice
    as long as the host took to issue the loop), so the card runs the calls
    back to back with no host gaps: its own time per call. (The profiler's
    ``key_averages()`` was tried for this and, late in this script, kept
    only some of the records of a kernel launched through ctypes.)"""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    issue_s = time.perf_counter() - t0
    end.synchronize()
    wall = start.elapsed_time(end) / reps
    torch.cuda._sleep(int(2 * issue_s * SLEEP_CYCLES_PER_S) + 1000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, wall


def graph_ms(fn, want, label: str, reps: int = 20) -> float:
    """Device ms per call of ``fn()`` inside a CUDA graph: ``reps`` calls
    captured as one graph by the port's ``graphs.GraphSet``, replayed once
    to warm up and once between CUDA events. The replay's last output must
    have the bits of ``want``, the same call run eagerly (``fn`` has run
    eagerly before, as the executors run a unit before capturing it)."""
    import torch

    from tnc_tpu_torch.ops import graphs

    def body():
        out = None
        for _ in range(reps):
            out = fn()
        return out

    graph_set = graphs.GraphSet(graphs.graph_class("cuda"))
    out = graph_set.capture(f"{label} x{reps}", body)
    graph_set.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph_set.replay()
    end.record()
    end.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(out, want)),
          f"{label}: the launch inside a CUDA graph differs from the eager launch")
    return start.elapsed_time(end) / reps


#: the rung of each kernel instantiation's code (``tnc::gemm::Rung``)
RUNG_NAMES = {0: "float32", 1: "high", 2: "default"}


def kernel_instances(log: str) -> list[tuple[str, int, int]]:
    """``(label, registers, spill store bytes)`` of every kernel in a
    ``ptxas -v`` log, labelled by its template arguments: element type,
    the tile variant's integers (``Variant<T, GM, TM, TN, BK, stages, fold,
    unroll, pads>``), for the transpose kernel the offset type and pipeline,
    and the dot-precision rung (the mma.sync tiles at the TF32 rungs); the
    wgmma kernels by their tile (``tf32::Tile<XR, YC, BK, raw slots>``) and
    rung. A wgmma kernel's registers are its entry allocation; setmaxnreg
    moves its warpgroups to 208 and 88."""
    out = []
    name, spill = "", 0
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            t = re.search(r"VariantI([fd])((?:Li\d+E)+)", name)
            label = name[:40]
            c = re.search(r"chain_(resident|grid)I([fd])(?:Lb([01])E)?(?:Li([012])E)?E", name)
            if c:
                label = f"{c.group(1)}<{'float' if c.group(2) == 'f' else 'double'}>"
                if c.group(3) is not None:
                    label += " full" if c.group(3) == "1" else " lean"
                if c.group(4) is not None:
                    label += f" {RUNG_NAMES[int(c.group(4))]}"
            w = re.search(r"tf32_kernelIN3tnc4tf324TileILi(\d+)ELi(\d+)ELi(\d+)"
                          r"ELi\d+ELi\d+EEELi([012])E", name)
            if w:
                xr, yc, bk, rung = w.groups()
                label = f"tf32 tile<{xr},{yc},{bk}> {RUNG_NAMES[int(rung)]}"
            if t:
                ints = ",".join(re.findall(r"Li(\d+)E", t.group(2)))
                label = f"{'float' if t.group(1) == 'f' else 'double'}<{ints}>"
                tail = re.match(r"EE(?:([ix])Lb([01])E)?(?:Li([012])E)?", name[t.end():])
                if tail and tail.group(1):
                    label += " int32" if tail.group(1) == "i" else " int64"
                    label += " staged" if tail.group(2) == "1" else " direct"
                if tail and tail.group(3):
                    label += f" {RUNG_NAMES[int(tail.group(3))]}"
            out.append((label, int(m.group(1)), spill))
            name = ""
    return out


#: the SASS instructions each library's TF32 kernels must contain: wgmma
#: (HGMMA ... TF32) in both, TMA loads (UTMALDG) where the tile takes TMA
#: boxes (fused_complex_dot's operands with a stride-1 free index)
SASS_NEEDS = {"fused_complex_dot": ("HGMMA", "UTMALDG"), "fused_transpose_dot": ("HGMMA",)}


def check_sass(paths: dict) -> dict:
    """``cuobjdump -sass`` of the ``fused_complex_dot`` and
    ``fused_transpose_dot`` libraries: the count of each instruction of
    :data:`SASS_NEEDS` and of the TF32 wgmma shapes; fails where one is
    missing (a TF32 launch would not reach the tensor cores' wgmma path)."""
    from tnc_tpu_torch.ops import cuda_complex as cc

    cuobjdump = str(Path(cc._nvcc()).with_name("cuobjdump"))
    out = {}
    for name, needs in SASS_NEEDS.items():
        sass = subprocess.run([cuobjdump, "-sass", str(paths[name])], capture_output=True,
                              text=True, check=True).stdout
        counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in needs}
        shapes = collections.Counter(re.findall(r"\bHGMMA\.(\w+)\.F32\.TF32\b", sass))
        counts["HGMMA TF32"] = sum(shapes.values())
        print(f"  {name} SASS: {counts}, HGMMA TF32 shapes {dict(shapes)}", flush=True)
        for op in needs:
            check(counts[op] > 0, f"{name}: no {op} in its SASS")
        check(counts["HGMMA TF32"] > 0, f"{name}: no TF32 HGMMA in its SASS")
        out[name] = {**counts, "hgmma_tf32_shapes": dict(shapes)}
    return out


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want) -> tuple[float, float]:
    """(max |got - want| over both parts, max |want| over both parts)."""
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    return err, scale


def statevector_norm(sv: np.ndarray) -> float:
    """⟨ψ|ψ⟩ of a host statevector, summed in its memory order, so the
    canonical result's transposed layout is read in place, not copied. One
    non-finite amplitude makes it non-finite."""
    flat = sv.ravel(order="K")
    return float(np.vdot(flat, flat).real)


def statevector_stats(sv: np.ndarray, ref: np.ndarray) -> dict:
    """The checks of a host statevector against another over their 2^28
    elements, computed on the card (numpy took 10-15 s for them on the
    host) and freed there: ``finite``, the ``norm`` ``<sv|sv>``, ``scale``
    (max|ref|), ``diff`` (max|sv - ref|) and ``close`` (numpy's
    ``allclose(sv, ref, rtol=1e-4, atol=1e-4 * scale)``)."""
    import torch

    if sv.shape == ref.shape and sv.strides == ref.strides:
        # one layout (the same program's canonical result): read both in
        # memory order, element for element, without a transposing copy
        sv, ref = sv.ravel(order="K"), ref.ravel(order="K")
    a = torch.from_numpy(np.ascontiguousarray(sv)).to("cuda").reshape(-1)
    b = torch.from_numpy(np.ascontiguousarray(ref)).to("cuda").reshape(-1)
    scale = float(b.abs().max())
    out = {"finite": bool(torch.isfinite(a).all()), "norm": float(torch.vdot(a, a).real),
           "scale": scale, "diff": float((a - b).abs().max()),
           "close": bool(torch.allclose(a, b, rtol=1e-4, atol=1e-4 * scale))}
    del a, b
    torch.cuda.empty_cache()
    return out


def build_config(qubits: int, bitstring: str | None = None):
    from tnc_tpu_torch.builders.connectivity import ConnectivityLayout
    from tnc_tpu_torch.builders.random_circuit import random_open_circuit

    circuit = random_open_circuit(
        qubits, DEPTH, 0.4, 0.4, np.random.default_rng(SEED),
        ConnectivityLayout.SYCAMORE,
    )
    return circuit.into_amplitude_network(bitstring or "*" * qubits)


def plan(tn):
    from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod

    return Greedy(OptMethod.GREEDY).find_path(tn).replace_path()


def random_buffers(program, slots_sizes, dtype, gen):
    import torch

    buffers = [None] * program.num_inputs
    for slot, size in slots_sizes.items():
        buffers[slot] = tuple(
            torch.randn(size, generator=gen, device="cuda", dtype=dtype)
            for _ in range(2)
        )
    return buffers


def chain_slot_sizes(steps) -> dict[int, int]:
    """Buffer sizes of the slots a chain group reads from outside."""
    head = steps[0]
    sizes = {head.lhs: math.prod(head.a_view), head.rhs: math.prod(head.b_view)}
    run = head.lhs
    for st in steps[1:]:
        if st.lhs == run:
            sizes[st.rhs] = math.prod(st.b_view)
        else:
            sizes[st.lhs] = math.prod(st.a_view)
        run = st.lhs
    return sizes


def hold_chain(first_ops, link_ops, links, label: str, launches: int) -> dict:
    """One chain group through ``fused_chain`` against
    ``fused_chain_reference`` on the same operands, timed beside the bound
    and the plain version; a row weighted by ``launches``. The chain is
    planned once (``chain_plan``, as the path keeps it) and every timed
    call only fills pointers and launches. Two launches must give the same
    bits, and the kernel must stay within the float32 gate of the plain
    version and of the chain computed in float64 from the same inputs."""
    import torch

    from tnc_tpu_torch.ops import cuda_complex

    plan = cuda_complex.chain_plan(first_ops, link_ops, links)
    got = cuda_complex.fused_chain(first_ops, link_ops, links, plan)
    again = cuda_complex.fused_chain(first_ops, link_ops, links, plan)
    torch.cuda.synchronize()
    check(all(torch.equal(g, a) for g, a in zip(got, again)),
          f"fused_chain {label}: two launches on the same operands differ")
    want = cuda_complex.fused_chain_reference(first_ops, link_ops, links)
    err, scale = max_err(got, want)
    check(err <= F32_REL_TOL * scale,
          f"fused_chain {label}: max|err| {err} > {F32_REL_TOL} * {scale}")
    exact = cuda_complex.fused_chain_reference(
        tuple(t.double() for t in first_ops),
        [tuple(t.double() for t in pair) for pair in link_ops], links)
    err64, scale64 = max_err([g.double() for g in got], exact)
    plain64, _ = max_err([w.double() for w in want], exact)
    check(err64 <= F32_REL_TOL * scale64,
          f"fused_chain {label}: max|err| against float64 {err64} > {F32_REL_TOL} * {scale64}")
    ms, wall = time_ms(lambda: cuda_complex.fused_chain(first_ops, link_ops, links, plan))
    in_graph = graph_ms(lambda: cuda_complex.fused_chain(first_ops, link_ops, links, plan),
                        got, f"fused_chain {label}")
    plain, plain_wall = time_ms(
        lambda: cuda_complex.fused_chain_reference(first_ops, link_ops, links))
    ops = list(first_ops) + [t for pair in link_ops for t in pair]
    # each operand read once (a 2-D operand of a batched launch is shared by
    # every row), the output written once
    nbytes = sum(t.numel() for t in ops) * 4 + 2 * got[0].numel() * 4
    rows = got[0].shape[0] if got[0].dim() == 3 else 1
    shape = (first_ops[0].shape[-1], first_ops[2].shape[-1])
    flops = COMPLEX_MAC_FLOPS * rows * first_ops[0].shape[-2] * shape[0] * shape[1]
    for (cr, _), link in zip(link_ops, links):
        x = cr.shape[-1]
        # a link contracts all K*F elements of the carried value with X
        flops += COMPLEX_MAC_FLOPS * rows * shape[0] * shape[1] * x
        shape = link.out_shape(x)
    b_ms, b_by = bound_ms(nbytes, flops, "float32")
    row_ms = None
    if rows > 1:
        # the same chain on one slice's operands: what the per-slice loop
        # launches once per slice
        one = [t[0] if t.dim() == 3 else t for t in ops]
        one_ops = (tuple(one[:4]), [tuple(one[4 + 2 * i:6 + 2 * i]) for i in range(len(links))],
                   links)
        one_plan = cuda_complex.chain_plan(*one_ops)
        row_ms, _ = time_ms(lambda: cuda_complex.fused_chain(*one_ops, one_plan))
    forms = ",".join(plan.forms)
    stages = [[int(first_ops[0].shape[-2]), int(first_ops[0].shape[-1]),
               int(first_ops[2].shape[-1])]]
    shape = (first_ops[0].shape[-1], first_ops[2].shape[-1])
    for (cr, _), link in zip(link_ops, links):
        k, f = link.carried_shape[link.k_axis], link.carried_shape[1 - link.k_axis]
        x = int(cr.shape[-1])
        stages.append([int(k), int(f), x] if link.carried_first else [int(k), x, int(f)])
    shapes = [f"({k},{m},{n}) tm {sh.tm} tn {sh.tn} ks {sh.ks}"
              for (k, m, n), sh in zip(stages, plan.stages)]
    print(f"  fused_chain {label}: {forms} form, stages {'; '.join(shapes)}; err "
          f"{err:.3e} (scale {scale:.3e}), against float64 {err64:.3e} (plain {plain64:.3e}); "
          f"two launches bitwise equal, and a launch in a CUDA graph; device: kernel "
          f"{ms:.5f} ms (in a graph {in_graph:.5f} ms) plain {plain:.5f} ms; "
          f"wall per call: kernel {wall:.5f} ms plain {plain_wall:.5f} ms; bound "
          f"{b_ms:.3e} ms ({b_by})" + (f"; batch {rows}, one slice's chain {row_ms:.5f} ms"
                                       if row_ms is not None else ""), flush=True)
    return {"label": label, "launches": launches, "batch": rows, "form": forms,
            "stages": stages, "err": err, "err_f64": err64, "plain_err_f64": plain64,
            "ms": ms, "graph_ms": in_graph, "plain_ms": plain, "wall_ms": wall,
            "plain_wall_ms": plain_wall, "bound_ms": b_ms, "bound_by": b_by,
            "one_slice_ms": row_ms}


def chain_key(first, link_ops, links) -> tuple:
    """What makes two chain launches the same chain: its operands' shapes,
    its links and its batch."""
    return (tuple(tuple(t.shape) for t in first),
            tuple(tuple(t.shape) for pair in link_ops for t in pair),
            tuple(link.key() for link in links))


def hold_chain_run(label_of, launches: int, rows: list, seen: dict | None = None):
    """A hold for :func:`holding` of ``split_complex.run_chain_split``: the
    chain the path is about to run, on its own operands, through
    :func:`hold_chain`; its row appended to ``rows``, labelled
    ``label_of(count of rows so far)``. With a ``seen`` dict, each distinct
    chain (its operands' shapes, links and batch) is held once and a
    repeat adds ``launches`` to its row. The launches a hold makes to
    compare and time the kernel are taken back out of the launch counts,
    so a held run counts what the path launched."""
    from tnc_tpu_torch.ops.cuda_complex import CHAIN_FORMS, LAUNCHES
    from tnc_tpu_torch.ops.split_complex import chain_operands

    def hold(steps, buffers, batched=None, *_):
        first, link_ops, links = chain_operands(steps, buffers,
                                                set() if batched is None else batched)
        if seen is not None:
            key = chain_key(first, link_ops, links)
            if key in seen:
                rows[seen[key]]["launches"] += launches
                return
            seen[key] = len(rows)
        counts = dict(LAUNCHES), dict(CHAIN_FORMS)
        rows.append(hold_chain(first, link_ops, links, label_of(len(rows)), launches))
        for live, saved in zip((LAUNCHES, CHAIN_FORMS), counts):
            live.clear()
            live.update(saved)

    return hold


def check_grid_chain(gen) -> dict:
    """The chain kernel's grid form, which no path launches: a synthetic
    chain whose carried value does not fit one block's shared memory — a
    (16, 256, 256) head (65536 carried values, 512 KB in float32) and a
    65536-long dot to a scalar, within ``chain_groups``' bounds — held
    against the plain version and a float64 product, timed; then in
    float64."""
    import torch

    from tnc_tpu_torch.ops import cuda_complex

    def ops(dtype):
        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)

        first = (rnd(16, 256), rnd(16, 256), rnd(16, 256), rnd(16, 256))
        link = [(rnd(65536, 1), rnd(65536, 1))]
        return first, link, [cuda_complex.ChainLink(True, (65536, 1), 0)]

    first, link, links = ops(torch.float32)
    plan = cuda_complex.chain_plan(first, link, links)
    check(plan.forms == (cuda_complex.CHAIN_GRID,), f"synthetic chain took {plan.forms}")
    row = hold_chain(first, link, links, "synthetic grid form", 0)
    first, link, links = ops(torch.float64)
    got = cuda_complex.fused_chain(first, link, links)
    err, scale = max_err(got, cuda_complex.fused_chain_reference(first, link, links))
    check(err <= F64_REL_TOL * scale,
          f"fused_chain grid form float64: max|err| {err} > {F64_REL_TOL} * {scale}")
    print(f"  fused_chain synthetic grid form float64: err {err:.3e} (scale {scale:.3e})",
          flush=True)
    return {**row, "float64_err": err}


def launch_floors() -> dict:
    """Device and wall ms of one empty launch of the chain kernel's block
    size, ordinary and cooperative, on 1, 8 and 132 blocks."""
    from tnc_tpu_torch.ops.cuda_complex import empty_chain_launch

    out = {}
    for form, coop in (("ordinary", False), ("cooperative", True)):
        for grid in (1, 8, 132):
            ms, wall = time_ms(lambda: empty_chain_launch(coop, grid), reps=50)
            out[f"{form} {grid}"] = {"ms": ms, "wall_ms": wall}
            print(f"  empty {form} launch, {grid} blocks of 256 threads: device {ms:.5f} ms, "
                  f"wall per call {wall:.5f} ms", flush=True)
    return out


def check_chains(program, policy, gen) -> list[dict]:
    """Every chain group of the program through ``fused_chain`` against
    ``fused_chain_reference`` on the card, on random operands; returns the
    rows (one launch each)."""
    import torch

    from tnc_tpu_torch.ops.cuda_complex import fused_chain, fused_chain_reference
    from tnc_tpu_torch.ops.split_complex import chain_operands

    rows = []
    for s, e in policy.chains:
        steps = program.steps[s:e]
        buffers = random_buffers(program, chain_slot_sizes(steps), torch.float32, gen)
        rows.append(hold_chain(*chain_operands(steps, buffers), f"steps {s}..{e - 1}", 1))
    # one float64 case: the longest chain group
    s, e = max(policy.chains, key=lambda c: c[1] - c[0])
    steps = program.steps[s:e]
    buffers = random_buffers(program, chain_slot_sizes(steps), torch.float64, gen)
    ops64 = chain_operands(steps, buffers)
    got64 = fused_chain(*ops64)
    check(all(torch.equal(g, a) for g, a in zip(got64, fused_chain(*ops64))),
          f"fused_chain float64 {s}..{e}: two launches differ")
    err, scale = max_err(got64, fused_chain_reference(*ops64))
    check(err <= F64_REL_TOL * scale,
          f"fused_chain float64 {s}..{e}: max|err| {err} > {F64_REL_TOL} * {scale}")
    print(f"  fused_chain float64 steps {s}..{e - 1}: err {err:.3e} (scale {scale:.3e})",
          flush=True)
    print("  fused_chain: no single PyTorch call computes a chain of steps; "
          "library_ms is null", flush=True)
    return rows


def chain_record(rows) -> dict:
    """The chain kernel's record over its rows, each time a mean over the
    rows' launches."""
    n = sum(r["launches"] for r in rows)

    def mean(key):
        return sum(r["launches"] * r[key] for r in rows) / n

    by_bytes = sum(r["launches"] for r in rows if r["bound_by"] == "bytes")
    return {
        "max_abs_err": max(r["err"] for r in rows),
        "ms": mean("ms"), "graph_ms": mean("graph_ms"), "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"),
        "bound_by": "bytes" if 2 * by_bytes >= n else "operations",
        "library_ms": None,
    }


def fused_rung_shapes(program) -> collections.Counter:
    """``(K, M, N)`` of every ``fused_complex_dot`` launch the forced
    ``fused`` rung makes on ``program``, counted: the steps whose gate
    admits them (both operands contract-first, over the flop floor), in
    the kernel's operand order (``split_complex._try_fused_step``)."""
    from tnc_tpu_torch.ops.cuda_complex import eligible
    from tnc_tpu_torch.ops.program import step_dims

    shapes: collections.Counter = collections.Counter()
    for st in program.steps:
        m, k, n = step_dims(st)
        if st.swap:
            m, n = n, m
        if st.a_cfirst and st.b_cfirst and eligible(k, m, n):
            shapes[(k, m, n)] += 1
    return shapes


def against_float64(what, got, want, exact, scale) -> tuple[float, float]:
    """The kernel's and cuBLAS's (the plain version's) largest error
    against a float64 product, over max|C|; fails when the kernel's is
    more than twice cuBLAS's."""
    k_err = max_err([g.double() for g in got], exact)[0] / scale
    p_err = max_err([w.double() for w in want], exact)[0] / scale
    print(f"  {what} against float64: kernel {k_err:.3e}, plain (cuBLAS) "
          f"{p_err:.3e} of max|C|", flush=True)
    check(k_err <= 2 * p_err, f"{what}: error {k_err} against float64 is over "
          f"twice cuBLAS's {p_err}")
    return k_err, p_err


def hold_dot(ar, ai, br, bi, launches: int, label: str, f64: bool = False) -> dict:
    """``fused_complex_dot`` on these operands against the plain version
    (and, with ``f64``, both against a float64 product beside cuBLAS's),
    timed beside the plain version, the library call and the bound; a row
    weighted by ``launches``."""
    import torch

    from tnc_tpu_torch.ops import cuda_complex

    (k, m), n = ar.shape[-2:], br.shape[-1]
    rows = max(ar.shape[0] if ar.dim() == 3 else 1, br.shape[0] if br.dim() == 3 else 1)
    got = cuda_complex.fused_complex_dot(ar, ai, br, bi)
    torch.cuda.synchronize()
    want = cuda_complex.fused_complex_dot_reference(ar, ai, br, bi)
    err, scale = max_err(got, want)
    check(err <= F32_REL_TOL * scale,
          f"fused_complex_dot {(k, m, n)}: max|err| {err} > {F32_REL_TOL} * {scale}")
    row = {"k": k, "m": m, "n": n, "batch": rows, "launches": launches, "err": err}
    if f64:
        exact = cuda_complex.fused_complex_dot_reference(
            *(t.double() for t in (ar, ai, br, bi)))
        row["float64"] = against_float64(f"fused_complex_dot K={k} M={m} N={n}", got,
                                         want, exact, scale)
        del exact
    macs = rows * k * m * n
    reps = 3 if 8.0 * macs > 1e12 else 10 if 8.0 * macs > 1e11 else 20
    del want
    in_graph = graph_ms(lambda: cuda_complex.fused_complex_dot(ar, ai, br, bi), got,
                        f"fused_complex_dot {label}", reps)
    del got
    ms, wall = time_ms(lambda: cuda_complex.fused_complex_dot(ar, ai, br, bi), reps, 1)
    plain, _ = time_ms(lambda: cuda_complex.fused_complex_dot_reference(ar, ai, br, bi),
                       reps, 1)
    a_c, b_c = torch.complex(ar, ai), torch.complex(br, bi)
    lib, _ = time_ms(lambda: a_c.mT @ b_c, reps, 1)
    del a_c, b_c
    # each operand read once (a 2-D side of a batched launch is shared), the
    # outputs written once
    nbytes = 4.0 * 2 * (ar.numel() + br.numel() + rows * m * n)
    b_ms, b_by = bound_ms(nbytes, COMPLEX_MAC_FLOPS * macs, "float32")
    row.update(ms=ms, graph_ms=in_graph, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
               bound_by=b_by)
    batch = f" batch {rows} ({'both' if ar.dim() == br.dim() == 3 else 'one side'})" \
        if rows > 1 else ""
    print(f"  fused_complex_dot {label}{batch} K={k} M={m} N={n}: err {err:.3e} "
          f"(scale {scale:.3e}) device: kernel {ms:.4f} ms (in a CUDA graph {in_graph:.4f} "
          f"ms, bitwise equal) plain {plain:.4f} ms "
          f"complex64 matmul {lib:.4f} ms; kernel wall per call {wall:.4f} ms; "
          f"bound {b_ms:.4f} ms ({b_by}, {COMPLEX_MAC_FLOPS:g} flops per complex "
          f"multiply-add); kernel/plain {ms / plain:.3f}", flush=True)
    return row


def check_dot(program, gen) -> dict:
    """Every distinct ``(K, M, N)`` the forced ``fused`` rung launches
    ``fused_complex_dot`` at, a ragged shape and a float64 case, against
    the plain version, on random operands; returns the per-shape rows
    (``shapes``, each weighted by the rung's launches at that shape), the
    rung's launch count (``expect``) and the stem's float64 errors."""
    import torch

    from tnc_tpu_torch.ops.cuda_complex import (
        fused_complex_dot,
        fused_complex_dot_reference,
    )

    counts = fused_rung_shapes(program)
    # heaviest first, so the stem's float64 product fits beside nothing else
    shapes = [(k, m, n, counts[(k, m, n)])
              for k, m, n in sorted(counts, key=lambda s: -math.prod(s))]
    k, m, n, _ = shapes[len(shapes) // 2]
    shapes.append((k + 3, m + 17, n + 29, 0))  # ragged: not a launch of the rung

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)

    rows = []
    for i, (k, m, n, launches) in enumerate(shapes):
        row = hold_dot(rnd(k, m), rnd(k, m), rnd(k, n), rnd(k, n), launches,
                       f"x{launches}" if launches else "ragged", f64=i == 0)
        rows.append(row)
        torch.cuda.empty_cache()
    # one float64 case at the middle shape
    k, m, n, _ = shapes[len(shapes) // 2]
    ops = [rnd(k, m, dtype=torch.float64), rnd(k, m, dtype=torch.float64),
           rnd(k, n, dtype=torch.float64), rnd(k, n, dtype=torch.float64)]
    err, scale = max_err(fused_complex_dot(*ops), fused_complex_dot_reference(*ops))
    check(err <= F64_REL_TOL * scale,
          f"fused_complex_dot float64 {(k, m, n)}: max|err| {err} > {F64_REL_TOL} * {scale}")
    print(f"  fused_complex_dot float64 K={k} M={m} N={n}: err {err:.3e} "
          f"(scale {scale:.3e})", flush=True)
    return {"expect": sum(counts.values()), "float64_errors": rows[0]["float64"],
            "shapes": [r for r in rows if r["launches"]], "ragged_err": rows[-1]["err"]}


def launch_weighted(rows) -> dict:
    """Times of per-shape rows as means over launches (each row weighted by
    its ``launches``); ``bound_by`` is the term that decides most of the
    launch-summed bound."""
    n = sum(r["launches"] for r in rows)

    def mean(key):
        return sum(r["launches"] * r[key] for r in rows) / n

    by_bytes = sum(r["launches"] * r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
    return {
        "ms": mean("ms"), "graph_ms": mean("graph_ms"), "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"),
        "bound_by": "bytes" if 2 * by_bytes > n * mean("bound_ms") else "operations",
        "library_ms": mean("library_ms"),
    }


def run_counted(fn, label: str, reps: int = 3, warmup=None) -> dict:
    """One warm-up (``warmup()``, default ``fn()``) and ``reps`` timed calls
    of ``fn()`` (a contraction from host leaves to the host result). Launch
    and routing counts are reset just before each timed call and read just
    after it. Returns the last
    result (``out``), the wall seconds of every timed call (``walls``) and
    its elapsed seconds between CUDA events recorded just before and just
    after it (``elapsed``: the card's clock, host gaps included), and the
    launch counts, routed steps and peak device memory of the last one."""
    import torch

    from tnc_tpu_torch.ops import graphs
    from tnc_tpu_torch.ops.cuda_complex import CHAIN_FORMS, LAUNCHES, reset_launches
    from tnc_tpu_torch.ops.split_complex import (
        FUSED_ROUTED,
        FUSED_TRANSPOSE_ROUTED,
        reset_routed,
    )

    (warmup or fn)()
    walls, elapsed, replay_ms = [], [], []
    run = {"out": None}
    for _ in range(reps):
        run["out"] = None
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        reset_routed()
        graphs.reset_stats()
        graphs.BATCH_EVENTS = []
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        elapsed.append(start.elapsed_time(end) / 1e3)
        events, graphs.BATCH_EVENTS = graphs.BATCH_EVENTS, None
        batch_ms: dict = {}
        for kind, start, end in events:
            batch_ms.setdefault(kind, []).append(start.elapsed_time(end))
        if "replay" in batch_ms:
            replay_ms.append(statistics.mean(batch_ms["replay"]))
        run = {
            "out": out, "walls": walls, "elapsed": elapsed, "launches": dict(LAUNCHES),
            "chain_forms": dict(CHAIN_FORMS), "routed": dict(FUSED_ROUTED),
            "transpose_routed": dict(FUSED_TRANSPOSE_ROUTED),
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "graphs": dict(graphs.STATS), "batch_ms": batch_ms,
            "replay_ms_runs": replay_ms,
        }
        del out
        kinds = ", ".join(f"{kind} {len(ms)} x {statistics.mean(ms):.3f} ms"
                          for kind, ms in batch_ms.items())
        print(f"[{label}] wall {walls[-1]:.4f} s, elapsed (CUDA events) {elapsed[-1]:.4f} s, "
              f"max_memory_allocated "
              f"{run['peak_bytes']} bytes, launches {run['launches']}, fused_chain by form "
              f"{run['chain_forms']}, "
              f"routed {run['routed']}, transpose routed "
              f"{run['transpose_routed']}; CUDA graphs {run['graphs']['graphs']} captured in "
              f"{run['graphs']['capture_ms']:.3f} ms, {run['graphs']['replays']} replays"
              + (f"; batches (CUDA events): {kinds}" if kinds else ""), flush=True)
    return run


def values(result) -> np.ndarray:
    """A contraction's result as a complex128 numpy array (exact for a
    complex64 result): a leaf tensor's data, an array, or a device (real,
    imag) pair."""
    import torch

    if hasattr(result, "legs"):
        result = result.data.into_data()
    elif isinstance(result, tuple):
        result = torch.complex(*result).cpu().numpy()
    return np.asarray(result).astype(np.complex128)


def compare_graphed(label: str, graphed: dict, eager: dict, units: int, batches: int,
                    replay: dict | None = None) -> dict:
    """A cell's graphed runs (:func:`run_counted`, the executors' default)
    against its eager run (``graphs=False``) in this script: the same bits
    and the same launch and routing counts; ``units`` graphs captured (one
    per chunk, or the loop's body) and replayed for each of ``batches - 1``
    batches (or slices); the graphed peak within 1.05x of the eager one.
    Prints and returns ms per batch of each (CUDA events around each
    batch), the capture, and ``replay``, the profile of one replayed batch
    (:func:`profile_replay`)."""
    same_bits = values(graphed["out"]).tobytes() == values(eager["out"]).tobytes()
    keys = ("launches", "chain_forms", "routed", "transpose_routed")
    check(same_bits, f"{label}: the graphed result differs from the eager run's bits")
    for key in keys:
        check(graphed[key] == eager[key],
              f"{label}: graphed {key} {graphed[key]} differ from the eager run's {eager[key]}")
    stats = graphed["graphs"]
    want = (units, units * (batches - 1)) if batches > 1 else (0, 0)
    check((stats["graphs"], stats["replays"]) == want,
          f"{label}: {stats['graphs']} graphs, {stats['replays']} replays; expected {want}")
    ratio = graphed["peak_bytes"] / eager["peak_bytes"]
    check(ratio <= 1.05, f"{label}: graphed peak {graphed['peak_bytes']} over 1.05x the "
                         f"eager peak {eager['peak_bytes']}")
    eager_ms = statistics.mean(eager["batch_ms"]["eager"])
    first_ms = graphed["batch_ms"]["eager"][0]
    capture_batch_ms = graphed["batch_ms"].get("capture", [None])[0]
    replay_ms = (statistics.median(graphed["replay_ms_runs"])
                 if graphed["replay_ms_runs"] else None)
    record = {
        "units": units, "batches": batches, "graphs": stats["graphs"],
        "replays": stats["replays"], "capture_ms": stats["capture_ms"],
        "eager_wall_s": eager["walls"][0], "graphed_wall_s": statistics.median(graphed["walls"]),
        "graphed_wall_runs_s": graphed["walls"], "eager_batch_ms": eager_ms,
        "graphed_first_batch_ms": first_ms, "graphed_capture_batch_ms": capture_batch_ms,
        "graphed_replay_batch_ms": replay_ms,
        "graphed_replay_batch_ms_runs": graphed["replay_ms_runs"],
        "replay_profile": replay,
        "eager_peak_bytes": eager["peak_bytes"], "graphed_peak_bytes": graphed["peak_bytes"],
        "peak_ratio": ratio, "bitwise_equal": same_bits, "counts_equal": True,
    }
    print(f"[graphs {label}] eager: wall {eager['walls'][0]:.4f} s, {eager_ms:.3f} ms a batch "
          f"({len(eager['batch_ms']['eager'])} batches); graphed: wall "
          f"{statistics.median(graphed['walls']):.4f} s (runs "
          f"{[round(w, 4) for w in graphed['walls']]}), first batch (eager) {first_ms:.3f} ms"
          + (f", capture batch {capture_batch_ms:.3f} ms" if capture_batch_ms else "")
          + (f", {replay_ms:.3f} ms a replayed batch (runs "
             f"{[round(r, 3) for r in graphed['replay_ms_runs']]})" if replay_ms else "")
          + f"; {stats['graphs']} graphs captured in {stats['capture_ms']:.3f} ms, "
          f"{stats['replays']} replays; max_memory_allocated eager "
          f"{eager['peak_bytes']} graphed {graphed['peak_bytes']} ({ratio:.4f}x); bits equal, "
          f"launch and routing counts equal", flush=True)
    return record


def run_main_path(tn, path, backend, label: str, reps: int = 3) -> dict:
    """:func:`run_counted` of ``contract_tensor_network(tn, path, backend)``."""
    from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network

    return run_counted(lambda: contract_tensor_network(tn, path, backend), label, reps)


def device_run(tn, path, backend):
    """A callable running the device-resident part of the contraction
    (``execute_on_device``: placement and every step, no copy back)."""
    from tnc_tpu_torch.ops.program import build_program, flat_leaf_tensors

    program = build_program(tn, path)
    arrays = [leaf.data.into_data() for leaf in flat_leaf_tensors(tn)]
    return lambda: backend.execute_on_device(program, arrays)


def profile_device_path(run, label: str, reps: int = 3, profiled=None) -> dict:
    """Where a path's time goes: its device-resident part ``run()`` timed
    on its own ``reps`` times, then one call of ``profiled`` (default:
    ``run``) under ``torch.profiler`` for device time by kernel and the
    device's busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del out
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = (profiled or run)()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    del out
    # device-side rows only: an operator row (aten::mm) repeats the time
    # of the kernels it launched
    rows = [
        (ev.self_device_time_total, ev.key, ev.count)
        for ev in prof.key_averages()
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
    ]
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    print(f"[profile {label}] device-resident run: {[f'{t:.4f}' for t in times]} s; "
          f"profiled run {prof_wall:.4f} s, device busy {busy_s:.4f} s "
          f"({busy_s / prof_wall:.3f} of it)", flush=True)
    for dev, key, count in rows[:14]:
        print(f"  {dev / 1e3:10.3f} ms  x{count:<5d} {key[:90]}", flush=True)
    return {"device_s": statistics.median(times), "device_runs_s": times,
            "profiled_s": prof_wall, "device_busy_s": busy_s}


def profile_replay(fn, label: str, nth: int, attempts: int = 3) -> dict:
    """One call of ``fn()``, a graphed executor's run, in which the
    ``nth`` replay of its graphs (1: the capture batch's) runs alone under
    ``torch.profiler``, the card synchronized just before and just after
    it: the replay's wall (host clock), the device time of the kernel
    records the profiler took in it and their share of the wall (the
    replayed batch's busy share, the profiler's own host cost included)
    and of the trace's device span (first record's start to last record's
    end: the idle time inside the replay), with the ``fused_chain`` kernel
    records beside the launches the replay counts (the profiler is known
    to drop records of the ctypes kernels: fewer records than launches
    would make the shares read low).

    The profiler can hand back no device record at all for a short replay
    (seen once on the H100 for a replay of a few ms). ``fn()`` is then
    called again, up to ``attempts`` calls; if none of them gives a device
    record, the shares are ``None`` (not measured) and the record says so.
    The measurement is only reported: no check reads it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tnc_tpu_torch.ops import graphs
    from tnc_tpu_torch.ops.cuda_complex import LAUNCHES

    real = graphs.GraphSet.replay
    seen, record = [], {}

    def replay(self):
        seen.append(1)
        if len(seen) != nth:
            return real(self)
        chains = LAUNCHES["fused_chain"]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            real(self)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [ev for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
        ranges = [ev.time_range for ev in prof.events() if ev.device_type == DeviceType.CUDA]
        record.update(replay=nth, wall_ms=wall * 1e3, device_records=len(ranges),
                      chain_launches=LAUNCHES["fused_chain"] - chains)
        if not ranges:
            return
        busy_s = sum(ev.self_device_time_total for ev in kernels) / 1e6
        span_s = (max(r.end for r in ranges) - min(r.start for r in ranges)) / 1e6
        record.update(
            device_busy_ms=busy_s * 1e3, busy=busy_s / wall, device_span_ms=span_s * 1e3,
            busy_in_span=busy_s / span_s,
            kernel_records=sum(ev.count for ev in kernels),
            chain_records=sum(ev.count for ev in kernels if "chain_" in ev.key))

    graphs.GraphSet.replay = replay
    try:
        for attempt in range(1, attempts + 1):
            seen.clear()
            record.clear()
            out = fn()
            del out
            if record.get("device_records", 1):
                break
            print(f"[profile {label}, replay {nth}] call {attempt}: the profiler took no "
                  f"device record", flush=True)
    finally:
        graphs.GraphSet.replay = real
    check(bool(record), f"{label}: the run made no replay {nth}")
    record["calls"] = attempt
    if not record["device_records"]:
        record.update(device_busy_ms=None, busy=None, device_span_ms=None,
                      busy_in_span=None, kernel_records=0, chain_records=0)
        print(f"[profile {label}, replay {nth}] wall {record['wall_ms']:.3f} ms; busy share "
              f"not measured: the profiler took no device record in {attempt} calls",
              flush=True)
        return record
    print(f"[profile {label}, replay {nth}] wall {record['wall_ms']:.3f} ms, device busy "
          f"{record['device_busy_ms']:.3f} ms ({record['busy']:.4f} of it; "
          f"{record['busy_in_span']:.4f} of the trace's device span "
          f"{record['device_span_ms']:.3f} ms), {record['kernel_records']} kernel records, fused_chain records "
          f"{record['chain_records']} of {record['chain_launches']} launches", flush=True)
    return record


def build_peps(args):
    """``peps(*args)`` with seeded random leaves at the O(1) scale
    (``unit_scale``: 2^-4.5 for the PEPS cell, where the default per-leaf
    scale would put the norm near float32's underflow)."""
    from tnc_tpu_torch.builders.peps import peps
    from tnc_tpu_torch.tensornetwork.approximate import attach_random_data, unit_scale

    tn = peps(*args)
    return attach_random_data(tn, np.random.default_rng(SEED), scale=unit_scale(tn))


def transpose_gate(program) -> tuple[int, dict]:
    """``(admitted, routed)``: how many steps of the program the fused
    transpose-dot's gate admits, and how many it routes, per reason."""
    from tnc_tpu_torch.ops.split_complex import fused_transpose_ineligible_reason

    reasons = [fused_transpose_ineligible_reason(st) for st in program.steps]
    return reasons.count(None), dict(collections.Counter(r for r in reasons if r))


def transpose_cases(program) -> list:
    """The distinct ``(first, second, step indices)`` operand layouts of the
    steps the fused transpose-dot's gate admits."""
    from tnc_tpu_torch.ops.split_complex import (
        _fused_transpose_layouts,
        fused_transpose_step_eligible,
    )

    cases: dict = {}
    for i, st in enumerate(program.steps):
        if fused_transpose_step_eligible(st):
            first, second = _fused_transpose_layouts(st)
            cases.setdefault((first.key(), second.key()), (first, second, []))[2].append(i)
    return list(cases.values())


def einsum_spec(a_lay, b_lay) -> str:
    """The ``torch.einsum`` equation of a transpose-dot on the stored views:
    contract digits paired in order, output the first operand's free digits
    then the second's (the kernel's flat ``(M, N)`` order)."""
    if [a_lay.view[a] for a in a_lay.k_axes] != [b_lay.view[b] for b in b_lay.k_axes]:
        fail(f"contract digits of {a_lay.key()} and {b_lay.key()} differ")
    letters = iter("abcdefghijklmnopqrstuvwxyz")
    a = [""] * len(a_lay.view)
    b = [""] * len(b_lay.view)
    for ax, bx in zip(a_lay.k_axes, b_lay.k_axes):
        a[ax] = b[bx] = next(letters)
    for ax in a_lay.f_axes:
        a[ax] = next(letters)
    for bx in b_lay.f_axes:
        b[bx] = next(letters)
    out = "".join(a[ax] for ax in a_lay.f_axes) + "".join(b[bx] for bx in b_lay.f_axes)
    return f"{''.join(a)},{''.join(b)}->{out}"


def check_transpose(program, gen) -> dict:
    """Every distinct admitted layout of the PEPS plan through
    ``fused_transpose_dot`` against ``fused_transpose_reference`` on the
    card, timed beside the bound, the plain version and ``torch.einsum``;
    returns the kernel's record, each time a mean over the plan's launches
    (each shape weighted by the steps that have it), and the per-shape rows
    (``shapes``)."""
    import torch

    from tnc_tpu_torch.ops.cuda_complex import (
        fused_transpose_dot,
        fused_transpose_reference,
        gather_copy_mode,
    )

    def rnd(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)

    rows = []
    worst = 0.0
    cases = sorted(transpose_cases(program),
                   key=lambda c: -c[0].k_size * c[0].f_size * c[1].f_size)
    f64 = None
    for first, second, steps in cases:
        k, m, n = first.k_size, first.f_size, second.f_size
        ops = (rnd(first.view), rnd(first.view), rnd(second.view), rnd(second.view))
        got = fused_transpose_dot(*ops, first, second)
        torch.cuda.synchronize()
        want = fused_transpose_reference(*ops, first, second)
        err, scale = max_err(got, want)
        check(err <= F32_REL_TOL * scale,
              f"fused_transpose_dot {first.key()} x {second.key()}: max|err| "
              f"{err} > {F32_REL_TOL} * {scale}")
        worst = max(worst, err)
        if f64 is None:
            # the heaviest (longest K) case against a float64 product
            exact = fused_transpose_reference(*(t.double() for t in ops), first, second)
            f64 = against_float64(f"fused_transpose_dot K={k} M={m} N={n}", got, want,
                                  exact, scale)
            del exact
        reps = 10 if 8.0 * k * m * n > 1e11 else 20
        in_graph = graph_ms(lambda: fused_transpose_dot(*ops, first, second), got,
                            f"fused_transpose_dot {first.key()} x {second.key()}", reps)
        del got
        a_c, b_c = torch.complex(ops[0], ops[1]), torch.complex(ops[2], ops[3])
        spec = einsum_spec(first, second)
        lib_err = float((torch.einsum(spec, a_c, b_c).reshape(m, n)
                         - torch.complex(*want)).abs().max())
        check(lib_err <= F32_REL_TOL * 2 * scale,
              f"einsum {spec} disagrees with the plain version by {lib_err}")
        del want
        ms, wall = time_ms(lambda: fused_transpose_dot(*ops, first, second), reps, 1)
        plain, _ = time_ms(lambda: fused_transpose_reference(*ops, first, second), reps, 1)
        lib, _ = time_ms(lambda: torch.einsum(spec, a_c, b_c), reps, 1)
        del a_c, b_c
        nbytes = 4.0 * 2 * (ops[0].numel() + ops[2].numel() + m * n)
        b_ms, b_by = bound_ms(nbytes, COMPLEX_MAC_FLOPS * k * m * n, "float32")
        modes = (gather_copy_mode(ops[0], ops[1], first), gather_copy_mode(ops[2], ops[3], second))
        rows.append({"k": k, "m": m, "n": n, "launches": len(steps), "steps": steps,
                     "modes": modes, "ms": ms, "graph_ms": in_graph, "plain_ms": plain,
                     "library_ms": lib,
                     "bound_ms": b_ms, "bound_by": b_by})
        print(f"  fused_transpose_dot steps {steps} {first.view} k{first.k_axes} x "
              f"{second.view} k{second.k_axes} (K={k} M={m} N={n}, copy modes "
              f"{modes}): err {err:.3e} (scale {scale:.3e}) device: kernel {ms:.4f} "
              f"ms (in a CUDA graph {in_graph:.4f} ms, bitwise equal) plain {plain:.4f} ms "
              f"einsum {lib:.4f} ms; kernel wall per call "
              f"{wall:.4f} ms; bound {b_ms:.4f} ms ({b_by}, {COMPLEX_MAC_FLOPS:g} flops "
              f"per complex multiply-add); kernel/plain {ms / plain:.3f}", flush=True)
        del ops
        torch.cuda.empty_cache()
    # one float64 case at the smallest admitted shape
    first, second, _ = cases[-1]
    ops = [rnd(first.view, torch.float64), rnd(first.view, torch.float64),
           rnd(second.view, torch.float64), rnd(second.view, torch.float64)]
    err, scale = max_err(fused_transpose_dot(*ops, first, second),
                         fused_transpose_reference(*ops, first, second))
    check(err <= F64_REL_TOL * scale,
          f"fused_transpose_dot float64 {first.key()}: max|err| {err} > {F64_REL_TOL} * {scale}")
    print(f"  fused_transpose_dot float64 {first.view} x {second.view}: err {err:.3e} "
          f"(scale {scale:.3e})", flush=True)
    return {"max_abs_err": worst, **launch_weighted(rows), "float64_errors": f64,
            "shapes": rows}


def run_peps(backend) -> dict:
    """The PEPS cell: its norm under the default policy (timed, profiled)
    and under the forced ``fused_transpose`` rung (launches and routed
    steps held to the plan's gate), both held to the same network
    contracted in complex128 on the card; then the small PEPS on the
    forced rung against the host oracle."""
    import torch

    from tnc_tpu_torch.ops.backends import NumpyBackend, TorchBackend
    from tnc_tpu_torch.ops.program import build_program, step_flops
    from tnc_tpu_torch.ops.split_complex import plan_kernels
    from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network

    def forced(tn, path, label):
        os.environ["TNC_TPU_COMPLEX_MULT"] = "fused_transpose"
        try:
            return run_main_path(tn, path, backend, label, reps=1)
        finally:
            del os.environ["TNC_TPU_COMPLEX_MULT"]

    tn = build_peps(PEPS)
    path = plan(tn)
    program = build_program(tn, path)
    admitted, routed = transpose_gate(program)
    modes = plan_kernels(program).modes
    flops = [step_flops(st) for st in program.steps]
    stems = [i for i, mode in enumerate(modes) if mode == "strassen"]
    stem_flops = sum(flops[i] for i in stems)
    print(f"[peps] peps{PEPS}: {len(program.steps)} steps, {sum(flops):.4e} complex "
          f"multiply-adds, default modes {dict(collections.Counter(modes))}, Strassen "
          f"steps {stems} carry {stem_flops:.4e} ({stem_flops / sum(flops):.3f}); "
          f"fused_transpose gate admits {admitted}, routes {routed}", flush=True)

    default = run_main_path(tn, path, backend, "peps default", reps=1)
    z = scalar(default.pop("out"))
    prof = profile_device_path(device_run(tn, path, backend), "peps", reps=1)
    steps = timed_steps(backend, program, device_buffers(backend, tn), "peps")
    ft = forced(tn, path, "peps fused_transpose rung")
    z_ft = scalar(ft.pop("out"))
    check(ft["launches"]["fused_transpose_dot"] == admitted,
          f"fused_transpose_dot launched {ft['launches']['fused_transpose_dot']} "
          f"times for {admitted} admitted steps")
    check(ft["transpose_routed"] == routed,
          f"routed {ft['transpose_routed']}, the plan's gate says {routed}")
    torch.cuda.empty_cache()
    bound = run_bound(backend, program, tn, admitted)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    z128 = scalar(contract_tensor_network(
        tn, path, TorchBackend(dtype="complex128", split_complex=False)))
    t128 = time.perf_counter() - t0
    for name, got in (("default rung", z), ("fused_transpose rung", z_ft)):
        rel = abs(got - z128) / abs(z128)
        print(f"[check] peps{PEPS} {name} {got!r} vs complex128 on the card "
              f"{z128!r}: relative {rel:.3e}", flush=True)
        check(rel <= 1e-4, f"peps {name} off complex128 by {rel}")
    print(f"[peps] complex128 native contraction {t128:.4f} s wall", flush=True)
    del tn

    small = build_peps(PEPS_SMALL)
    small_path = plan(small)
    run = forced(small, small_path, "peps small fused_transpose rung")
    got = scalar(run["out"])
    want = scalar(contract_tensor_network(small, small_path, NumpyBackend()))
    rel = abs(got - want) / abs(want)
    print(f"[check] peps{PEPS_SMALL} fused_transpose rung {got!r} vs numpy complex128 "
          f"{want!r}: relative {rel:.3e}", flush=True)
    check(rel <= 1e-4, f"peps{PEPS_SMALL} off the host oracle by {rel}")
    check(run["launches"]["fused_transpose_dot"] == 2,
          f"peps{PEPS_SMALL} launched fused_transpose_dot "
          f"{run['launches']['fused_transpose_dot']} times, not 2")
    return {
        "config": list(PEPS), "seed": SEED, "steps": len(program.steps),
        "admitted": admitted, "wall_s": statistics.median(default["walls"]),
        "wall_runs_s": default["walls"], "peak_bytes": default["peak_bytes"],
        **prof, "step_times": steps, "fused_transpose_wall_s": ft["walls"][0],
        "fused_transpose_peak_bytes": ft["peak_bytes"],
        "fused_transpose_launches": ft["launches"]["fused_transpose_dot"],
        "norm": [z.real, z.imag], "norm_fused_transpose": [z_ft.real, z_ft.imag],
        "norm_complex128": [z128.real, z128.imag], "complex128_wall_s": t128,
        "bind_resident": bound,
    }


def run_bound(backend, program, tn, admitted: int) -> dict:
    """The PEPS norm through ``TorchBackend.bind_resident`` under the forced
    ``fused_transpose`` rung, three calls: eager, captured and replayed,
    replayed. Each call timed (host wall, synchronised) and counted; every
    call gives the first call's bits in a fresh tensor, launches
    ``fused_transpose_dot`` at each of the ``admitted`` steps (inside the
    graph from the second call on), and peaks within 1.05x of the first."""
    import torch

    from tnc_tpu_torch.ops import graphs
    from tnc_tpu_torch.ops.cuda_complex import LAUNCHES, reset_launches
    from tnc_tpu_torch.ops.program import flat_leaf_tensors

    arrays = [leaf.data.into_data() for leaf in flat_leaf_tensors(tn)]
    os.environ["TNC_TPU_COMPLEX_MULT"] = "fused_transpose"
    try:
        bound = backend.bind_resident(program, arrays)
        calls = []
        for _ in range(3):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            graphs.reset_stats()
            t0 = time.perf_counter()
            out = bound()
            torch.cuda.synchronize()
            calls.append({"wall_s": time.perf_counter() - t0, "out": out,
                          "launches": LAUNCHES["fused_transpose_dot"],
                          "graphs": dict(graphs.STATS),
                          "peak_bytes": torch.cuda.max_memory_allocated()})
    finally:
        del os.environ["TNC_TPU_COMPLEX_MULT"]
    first = calls[0]["out"]
    for i, call in enumerate(calls):
        check(call["launches"] == admitted,
              f"bind_resident call {i}: {call['launches']} fused_transpose_dot launches, "
              f"not {admitted}")
        check(call["peak_bytes"] <= 1.05 * calls[0]["peak_bytes"],
              f"bind_resident call {i} peaked at {call['peak_bytes']} bytes, over 1.05x "
              f"the eager call's {calls[0]['peak_bytes']}")
        if i:
            check(all(torch.equal(a, b) and a.data_ptr() != b.data_ptr()
                      for a, b in zip(call["out"], calls[i - 1]["out"])),
                  f"bind_resident call {i}: not the previous call's bits in a fresh tensor")
    check([(c["graphs"]["graphs"], c["graphs"]["replays"]) for c in calls]
          == [(0, 0), (1, 1), (0, 1)],
          f"bind_resident graphs and replays by call: {[c['graphs'] for c in calls]}")
    del bound
    z = complex(torch.complex(*first).cpu().numpy().reshape(()))
    record = {"walls_s": [c["wall_s"] for c in calls],
              "capture_ms": calls[1]["graphs"]["capture_ms"],
              "peak_bytes": [c["peak_bytes"] for c in calls],
              "launches": [c["launches"] for c in calls], "norm": [z.real, z.imag]}
    print(f"[graphs peps{PEPS} bind_resident, forced fused_transpose rung] calls: eager "
          f"{calls[0]['wall_s']:.4f} s, captured and replayed {calls[1]['wall_s']:.4f} s "
          f"(capture {record['capture_ms']:.3f} ms), replayed {calls[2]['wall_s']:.4f} s; "
          f"{admitted} fused_transpose_dot launches a call; max_memory_allocated "
          f"{record['peak_bytes']}; every call the first's bits in a fresh tensor", flush=True)
    return record


def device_buffers(backend, tn):
    """A callable giving a fresh buffer list over the network's leaves,
    placed on the card once."""
    from tnc_tpu_torch.ops.backends import place_buffers
    from tnc_tpu_torch.ops.program import flat_leaf_tensors

    full = place_buffers([leaf.data.into_data() for leaf in flat_leaf_tensors(tn)],
                         backend.dtype, backend.split_complex, backend.device)
    return lambda: list(full)


def timed_steps(backend, program, buffers, label: str, top: int = 8) -> dict:
    """Time between CUDA events around every step and chain of one run of
    ``program`` under the backend's policy (``run_steps_timed``). A first
    run gives the wall time of the whole; the timed run is queued behind a
    ``torch.cuda._sleep`` twice as long (at most 2 s), so the card runs
    the steps back to back while the host stays ahead. Where the host
    falls behind (many small units), a unit's event time holds its issue
    time too, so the sum is ``event_ms``, beside the host's ``host_ms``,
    and not device time. ``buffers()`` gives the run's own buffer list."""
    import torch

    from tnc_tpu_torch.ops.backends import run_steps_timed

    policy = backend.kernel_policy(program)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, _ = run_steps_timed(program, buffers(), policy)
    wall = time.perf_counter() - t0
    del out
    torch.cuda._sleep(int(min(2 * wall, 2.0) * SLEEP_CYCLES_PER_S))
    out, records = run_steps_timed(program, buffers(), policy)
    del out
    total = sum(r["ms"] for r in records)
    host = sum(r["host_ms"] for r in records)
    by_mode: dict = collections.defaultdict(float)
    for r in records:
        by_mode[r["mode"]] += r["ms"]
    heavy = sorted(records, key=lambda r: -r["ms"])[:top]
    print(f"[steps {label}] {len(records)} launch units, {total:.3f} ms between their "
          f"events, issued in {host:.3f} ms of host time (untimed run {wall * 1e3:.3f} ms "
          f"wall); by mode "
          f"{ {m: round(v, 4) for m, v in by_mode.items()} }", flush=True)
    for r in heavy:
        print(f"  {r['ms']:10.4f} ms ({r['ms'] / total:.3f})  {r['mode']:<9s} {r['label']}  "
              f"{r['flops']:.3e} multiply-adds, issued in {r['host_ms']:.4f} ms", flush=True)
    return {"units": len(records), "event_ms": total, "host_ms": host,
            "untimed_wall_ms": wall * 1e3, "by_mode_ms": dict(by_mode),
            "heaviest": [{k: r[k] for k in ("label", "mode", "flops", "ms", "host_ms")}
                         for r in heavy]}


@contextlib.contextmanager
def holding(name: str, hold, module=None):
    """While active, every call the port makes to ``<module>.<name>``
    (default ``cuda_complex``; the split-complex step glue looks the
    wrappers, and ``split_complex.run_chain_split``, up at each call) first
    goes to ``hold(*args, **kw)`` with the real function in place, which
    holds the kernel against its plain version on exactly those operands."""
    if module is None:
        from tnc_tpu_torch.ops import cuda_complex as module

    real = getattr(module, name)

    def wrapper(*args, **kw):
        setattr(module, name, real)
        try:
            hold(*args, **kw)
        finally:
            setattr(module, name, wrapper)
        return real(*args, **kw)

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, real)


def build_sliced(cfg):
    """``(tn, path, slicing)`` of a Sycamore single amplitude: the circuit
    ``sycamore_circuit(qubits, depth, default_rng(seed))`` closed on the
    all-zeros bitstring, ``simplify_network``, the ``Greedy`` path and
    ``find_slicing`` to 2^target elements."""
    from tnc_tpu_torch.builders.sycamore_circuit import sycamore_circuit
    from tnc_tpu_torch.contractionpath.slicing import find_slicing
    from tnc_tpu_torch.tensornetwork.simplify import simplify_network

    qubits, depth, seed, target = cfg
    tn, _ = sycamore_circuit(qubits, depth, np.random.default_rng(seed)
                             ).into_amplitude_network("0" * qubits)
    tn = simplify_network(tn)
    path = plan(tn)
    return tn, path, find_slicing(tn.tensors, path.toplevel, float(2 ** target))


def fused_gate(program) -> tuple[list, dict]:
    """``(admitted, routed)``: the steps whose ``fused_complex_dot`` gate
    admits them, in order, and the others counted per reason — what the
    forced ``fused`` rung does (``split_complex._try_fused_step``)."""
    return fused_gate_steps(program.steps)


def fused_gate_steps(steps) -> tuple[list, dict]:
    """:func:`fused_gate` of a bare step sequence."""
    from tnc_tpu_torch.ops.cuda_complex import ineligible_reason
    from tnc_tpu_torch.ops.program import step_dims

    admitted, routed = [], collections.Counter()
    for i, st in enumerate(steps):
        m, k, n = step_dims(st)
        if st.swap:
            m, n = n, m
        reason = "layout" if not (st.a_cfirst and st.b_cfirst) else ineligible_reason(k, m, n)
        if reason is None:
            admitted.append(i)
        else:
            routed[reason] += 1
    return admitted, dict(routed)


def scalar(result) -> complex:
    """The one value of a contraction's result: a leaf tensor or an array."""
    if hasattr(result, "legs"):
        result = result.data.into_data()
    z = complex(np.asarray(result).reshape(()))
    check(math.isfinite(z.real) and math.isfinite(z.imag), f"non-finite amplitude {z}")
    return z


def run_sliced(backend) -> dict:
    """The sliced cell on the per-slice loop, unhoisted (``backend`` is a
    ``TorchBackend(sliced_strategy="loop", hoist=False)``): one Sycamore-53
    depth-10 amplitude over its 128 slices (``SLICED``). Plan; ``fused_chain`` held against its plain
    version on slice 0's own chain operands; the amplitude through
    ``contract_tensor_network_sliced`` (one warm-up, two timed runs,
    ``fused_chain`` launched once per chain and slice), its device-resident
    part, a profile and the CUDA-event time of every step of one slice;
    complex128 on the card slice by slice; the forced ``fused`` rung on
    ``FUSED_RANGE`` (``fused_complex_dot`` held against its plain version
    on slice 0's own operands, then launches and routed steps held to the
    plan's gate); and the small configuration against the numpy oracle.
    Returns the path record, the kernels' rows, and the cell (network,
    plan, leaves, complex128 partials) for the chunked phase."""
    import torch

    from tnc_tpu_torch.contractionpath.slicing import sliced_flops, sliced_peak
    from tnc_tpu_torch.ops import split_complex
    from tnc_tpu_torch.ops.backends import NumpyBackend, TorchBackend, place_buffers
    from tnc_tpu_torch.ops.chunked import slice_index_rows
    from tnc_tpu_torch.ops.cuda_complex import LAUNCHES, reset_launches
    from tnc_tpu_torch.ops.program import flat_leaf_tensors, step_flops
    from tnc_tpu_torch.ops.sliced import build_sliced_program
    from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network_sliced

    qubits, depth, seed, target = SLICED
    t0 = time.perf_counter()
    tn, path, sl = build_sliced(SLICED)
    sp = build_sliced_program(tn, path, sl)
    plan_s = time.perf_counter() - t0
    arrays = [leaf.data.into_data() for leaf in flat_leaf_tensors(tn)]
    policy = backend.kernel_policy(sp.program)
    n = sl.num_slices
    per_slice = sum(step_flops(st) for st in sp.program.steps)
    total = sliced_flops(tn.tensors, path.toplevel, sl)
    peak = sliced_peak(tn.tensors, path.toplevel, sl)
    admitted, routed = fused_gate(sp.program)
    modes = dict(collections.Counter(policy.modes))
    print(f"[sliced plan] sycamore({qubits}, {depth}, rng {seed}), {len(tn.tensors)} tensors "
          f"after simplify, planned in {plan_s:.2f} s: {n} slices over legs {list(sl.legs)} "
          f"(dims {list(sl.dims)}), per-slice peak {peak:.4e} elements (target 2^{target}), "
          f"{per_slice:.4e} complex multiply-adds per slice, {total:.4e} in all; "
          f"{len(sp.program.steps)} steps, default modes {modes}, chains "
          f"{list(policy.chains)}; forced fused gate admits {len(admitted)} {admitted}, "
          f"routes {routed}", flush=True)

    # fused_chain on the chain operands slice 0 builds, in the order it runs them
    print("[kernels] fused_chain against fused_chain_reference on slice 0's operands",
          flush=True)
    chain_rows = []
    labels = [f"sliced steps {s}..{e - 1}" for s, e in policy.chains]
    with holding("run_chain_split", hold_chain_run(
            lambda i: labels[i] if i < len(labels) else f"sliced chain {i}", n, chain_rows),
            split_complex):
        backend.execute_sliced(sp, arrays, slice_range=(0, 1))
    check(len(chain_rows) == len(policy.chains),
          f"slice 0 ran {len(chain_rows)} chains, the policy has {len(policy.chains)}")
    torch.cuda.empty_cache()

    # the amplitude, all slices
    main = run_counted(lambda: contract_tensor_network_sliced(tn, path, sl, backend),
                       "sliced main path", reps=MAIN_SLICED_REPS)
    z = scalar(main["out"])
    check(main["launches"]["fused_chain"] == len(policy.chains) * n,
          f"fused_chain launched {main['launches']['fused_chain']} times for "
          f"{len(policy.chains)} chains x {n} slices")
    eager = run_counted(lambda: backend.execute_sliced(sp, arrays, graphs=False),
                        "sliced main path, eager", reps=1, warmup=lambda: None)
    prof = profile_device_path(
        lambda: backend.execute_sliced(sp, arrays, host=False), "sliced", reps=1,
        profiled=lambda: backend.execute_sliced(sp, arrays, slice_range=(0, 4), host=False,
                                                graphs=False))
    replay = profile_replay(
        lambda: backend.execute_sliced(sp, arrays, slice_range=(0, 3), host=False),
        "sliced", 2)
    graphed = compare_graphed("sycamore53_m10 loop", main, eager, 1, n, replay)
    del eager
    full = place_buffers(arrays, backend.dtype, backend.split_complex, backend.device)
    row = torch.from_numpy(slice_index_rows(sp.slicing, 0, 1)).to(backend.device)
    steps = timed_steps(backend, sp.program, lambda: backend.slice_buffers(sp, full, row),
                        "sliced slice 0")
    del full
    torch.cuda.empty_cache()

    # complex128 on the card, slice by slice
    oracle = TorchBackend(dtype="complex128", split_complex=False, sliced_strategy="loop",
                          hoist=False)
    refs = []
    limit = n
    t0 = time.perf_counter()
    while len(refs) < limit:
        s = len(refs)
        refs.append(scalar(oracle.execute_sliced(sp, arrays, slice_range=(s, s + 1))))
        if s == 7 and (time.perf_counter() - t0) / 8 * n > SLICED_CHECK_S:
            limit = 32
    t128 = time.perf_counter() - t0
    scale8 = max(abs(r) for r in refs[:8])
    worst8 = 0.0
    for s in range(8):
        got = scalar(backend.execute_sliced(sp, arrays, slice_range=(s, s + 1)))
        worst8 = max(worst8, abs(got - refs[s]))
        check(abs(got - refs[s]) <= 1e-4 * scale8,
              f"slice {s}: {got!r} off complex128 {refs[s]!r} by {abs(got - refs[s])}")
    if limit == n:
        scope, got_sum = f"all {n} slices", z
    else:
        scope = "the first 32 slices (complex128 of all would take over "\
                f"{SLICED_CHECK_S:g} s)"
        got_sum = scalar(backend.execute_sliced(sp, arrays, slice_range=(0, 32)))
    want_sum = sum(refs)
    abs_sum = sum(abs(r) for r in refs)
    print(f"[check] sliced slices 0-7 against complex128 on the card: max|diff| "
          f"{worst8:.3e} (gate 1e-4 x max|ref_s| = {1e-4 * scale8:.3e}); {scope}: "
          f"{got_sum!r} vs {want_sum!r}, |diff| {abs(got_sum - want_sum):.3e} (gate 1e-4 x "
          f"sum|ref_s| = {1e-4 * abs_sum:.3e}); complex128 slices took {t128:.3f} s",
          flush=True)
    check(abs(got_sum - want_sum) <= 1e-4 * abs_sum,
          f"sliced amplitude over {scope} off complex128 by {abs(got_sum - want_sum)}")

    # the forced fused rung on the first slices
    lo, hi = FUSED_RANGE
    width = hi - lo
    default_range = scalar(backend.execute_sliced(sp, arrays, slice_range=FUSED_RANGE))
    print("[kernels] fused_complex_dot against fused_complex_dot_reference on slice 0's "
          "operands (forced fused rung)", flush=True)
    dot_rows = []
    steps_iter = iter(admitted)
    os.environ["TNC_TPU_COMPLEX_MULT"] = "fused"
    try:
        with holding("fused_complex_dot", lambda ar, ai, br, bi: dot_rows.append(
                hold_dot(ar, ai, br, bi, width, f"sliced step {next(steps_iter)}"))):
            backend.execute_sliced(sp, arrays, slice_range=(0, 1))
        torch.cuda.empty_cache()
        fused = run_counted(lambda: backend.execute_sliced(sp, arrays, slice_range=FUSED_RANGE),
                            "sliced fused rung", reps=1)
    finally:
        del os.environ["TNC_TPU_COMPLEX_MULT"]
    check(len(dot_rows) == len(admitted),
          f"slice 0 launched fused_complex_dot {len(dot_rows)} times, gate admits "
          f"{len(admitted)}")
    check(fused["launches"]["fused_complex_dot"] == len(admitted) * width,
          f"fused rung launched fused_complex_dot {fused['launches']['fused_complex_dot']} "
          f"times over {width} slices; the gate admits {len(admitted)} steps a slice")
    want_routed = {r: c * width for r, c in routed.items()}
    check(fused["routed"] == want_routed,
          f"fused rung routed {fused['routed']}, the plan's gate says {want_routed}")
    z_fused = scalar(fused["out"])
    gate = 1e-5 * sum(abs(r) for r in refs[lo:hi])
    print(f"[check] sliced fused rung on slices {lo}-{hi - 1}: {z_fused!r} vs default rung "
          f"{default_range!r}, |diff| {abs(z_fused - default_range):.3e} (gate {gate:.3e})",
          flush=True)
    check(abs(z_fused - default_range) <= gate, "sliced fused rung disagrees with the default")

    # the small sliced configuration against the host oracle
    small_tn, small_path, small_sl = build_sliced(SLICED_SMALL)
    reset_launches()
    got = scalar(contract_tensor_network_sliced(small_tn, small_path, small_sl, backend))
    small_chains = LAUNCHES["fused_chain"]
    want = scalar(contract_tensor_network_sliced(small_tn, small_path, small_sl, NumpyBackend()))
    small_rel = abs(got - want) / abs(want)
    print(f"[check] sycamore{SLICED_SMALL[:3]} over {small_sl.num_slices} slices: {got!r} vs "
          f"numpy complex128 {want!r}, relative {small_rel:.3e}; fused_chain launched "
          f"{small_chains} times", flush=True)
    check(small_rel <= 1e-5, f"small sliced amplitude off the host oracle by {small_rel}")
    check(small_chains > 0, "the small sliced amplitude launched no fused_chain")

    record = {
        "config": list(SLICED), "tensors": len(tn.tensors), "slices": n,
        "legs": list(sl.legs), "peak_elems": peak, "macs_per_slice": per_slice,
        "macs": total, "steps": len(sp.program.steps), "modes": modes,
        "chains": [list(c) for c in policy.chains], "fused_admitted": admitted,
        "fused_routed": routed, "plan_s": plan_s,
        "wall_s": statistics.median(main["walls"]), "wall_runs_s": main["walls"],
        "peak_bytes": main["peak_bytes"], "launches": main["launches"],
        "chain_forms": main["chain_forms"], **prof,
        "per_slice_ms": prof["device_s"] / n * 1e3, "graphs": graphed, "step_times": steps,
        "amplitude": [z.real, z.imag], "check_scope": scope,
        "complex128": [want_sum.real, want_sum.imag], "complex128_sum_abs": abs_sum,
        "complex128_s": t128, "slices_0_7_max_diff": worst8,
        "fused_range": list(FUSED_RANGE), "fused_wall_s": fused["walls"][0],
        "fused_launches": fused["launches"], "fused_diff": abs(z_fused - default_range),
        "small": {"config": list(SLICED_SMALL), "slices": small_sl.num_slices,
                  "relative": small_rel, "fused_chain_launches": small_chains},
    }
    return {"record": record, "chain_rows": chain_rows, "dot_rows": dot_rows,
            "chain_launches": main["launches"]["fused_chain"],
            "dot_launches": fused["launches"]["fused_complex_dot"],
            "cell": {"tn": tn, "path": path, "slicing": sl, "sp": sp, "arrays": arrays,
                     "refs": refs, "loop_sum": got_sum}}


def chunked_plan(backend, sp) -> dict:
    """The default sliced path's plan for ``sp``: the hoist split, the
    residual's chunks and their kernel modes, the slice batch requested and
    the one the memory budget and the divisor rule leave, and the modeled
    peak at that batch."""
    from tnc_tpu_torch.ops.budget import program_peak_bytes
    from tnc_tpu_torch.ops.chunked import chunk_plan, resolve_batch
    from tnc_tpu_torch.ops.hoist import hoist_sliced_program, hoist_split_counts

    residual = hoist_sliced_program(sp).residual
    batch = resolve_batch(residual, backend.slice_batch, backend.split_complex,
                          backend.dtype, backend.device)[0]
    plans = chunk_plan(residual, batch, backend.chunk_steps, backend.split_complex,
                       backend.precision)
    peak = program_peak_bytes(residual.program, batch=batch)
    return {
        **hoist_split_counts(sp), "residual_inputs": residual.program.num_inputs,
        "chunks": len(plans), "batch_requested": backend.slice_batch, "batch": batch,
        "modes": [dict(collections.Counter(cp.policy.modes)) for cp in plans],
        "chains": [list(cp.policy.chains) for cp in plans],
        "modeled_peak_bytes": peak.peak_bytes, "modeled_peak_step": peak.peak_step,
        "modeled_bytes_per_slice": peak.bytes_per_batch_unit,
    }


def print_chunked_plan(label: str, plan_rec: dict, backend) -> None:
    """One line of :func:`chunked_plan`'s record, and a second where the
    memory budget clamped the batch."""
    print(f"[chunked plan] {label}: prelude {plan_rec['prelude_steps']} steps "
          f"({plan_rec['invariant_flops']:.4e} complex multiply-adds, once), residual "
          f"{plan_rec['residual_steps']} steps ({plan_rec['residual_flops']:.4e} a slice) over "
          f"{plan_rec['residual_inputs']} inputs; {plan_rec['chunks']} chunk(s) of at most "
          f"{backend.chunk_steps} steps, modes {plan_rec['modes']}, chains "
          f"{plan_rec['chains']}; slice batch requested {plan_rec['batch_requested']}, "
          f"run at {plan_rec['batch']}; modeled peak {plan_rec['modeled_peak_bytes']} bytes "
          f"(step {plan_rec['modeled_peak_step']}, {plan_rec['modeled_bytes_per_slice']} bytes "
          f"a slice of the batch)", flush=True)
    if plan_rec["batch"] < plan_rec["batch_requested"]:
        print(f"[chunked plan] the memory budget clamped the slice batch "
              f"{plan_rec['batch_requested']} -> {plan_rec['batch']}", flush=True)


def check_fused_first_batch(backend, sp, arrays, batch: int, refs, label: str) -> dict:
    """The forced ``fused`` rung on the default sliced path: the
    ``fused_complex_dot`` launches of the first ``batch`` slices held against
    the plain version on the operands the executor builds, each distinct
    pair of operand shapes once, its row weighing every launch at those
    shapes (prelude launches once, residual launches batched over the
    slices); then the first two
    batches counted, graphed (the second batch replays the chunks' graphs,
    so the kernel runs inside a CUDA graph) and eagerly: the same bits and
    counts, launches and routed steps held to the plan's gate, and the sum
    held to the default rung's within 1e-5 x sum|ref_s| over those slices
    (``refs``: complex128 per slice)."""
    import torch

    from tnc_tpu_torch.ops.chunked import chunk_plan
    from tnc_tpu_torch.ops.hoist import hoist_sliced_program

    hp = hoist_sliced_program(sp)
    lo, hi = 0, 2 * batch
    admitted_pre, routed_pre = fused_gate_steps([ps.step for ps in hp.prelude_steps])
    admitted_res, routed_res = fused_gate_steps(hp.residual.program.steps)
    default_range = scalar(backend.execute_sliced(sp, arrays, slice_range=(lo, hi)))
    print(f"[kernels] fused_complex_dot against fused_complex_dot_reference on the operands "
          f"the chunked executor builds for slices 0-{batch - 1} of {label} (forced fused "
          f"rung: {len(admitted_pre)} prelude launches, {len(admitted_res)} batched)",
          flush=True)
    dot_rows, seen = [], {}
    labels = iter([f"{label} prelude step {i}" for i in admitted_pre]
                  + [f"{label} residual step {i}" for i in admitted_res])

    def hold(ar, ai, br, bi):
        # each distinct pair of operand shapes held once, on the first
        # step's operands; its row weighs every launch at those shapes
        step, key = next(labels), (tuple(ar.shape), tuple(br.shape))
        if key in seen:
            dot_rows[seen[key]]["launches"] += 1
            return
        seen[key] = len(dot_rows)
        dot_rows.append(hold_dot(ar, ai, br, bi, 1, step))

    os.environ["TNC_TPU_COMPLEX_MULT"] = "fused"
    try:
        with holding("fused_complex_dot", hold):
            backend.execute_sliced(sp, arrays, slice_range=(0, batch))
        torch.cuda.empty_cache()
        fused = run_counted(lambda: backend.execute_sliced(sp, arrays, slice_range=(lo, hi)),
                            f"{label} fused rung", reps=1)
        eager = run_counted(
            lambda: backend.execute_sliced(sp, arrays, slice_range=(lo, hi), graphs=False),
            f"{label} fused rung, eager", reps=1, warmup=lambda: None)
    finally:
        del os.environ["TNC_TPU_COMPLEX_MULT"]
    chunks = chunk_plan(hp.residual, batch, backend.chunk_steps, backend.split_complex,
                        backend.precision)
    graphed = compare_graphed(f"{label} fused rung", fused, eager, len(chunks), 2)
    del eager
    # prelude launches run once, unbatched; residual launches batched
    held = {b: sum(r["launches"] for r in dot_rows if (r["batch"] > 1) == b)
            for b in (False, True)}
    check(held == {False: len(admitted_pre), True: len(admitted_res)},
          f"{label} fused rung called fused_complex_dot {held[False]} times unbatched and "
          f"{held[True]} times batched; the gate admits {len(admitted_pre)} prelude and "
          f"{len(admitted_res)} residual steps")
    want_launches = len(admitted_pre) + 2 * len(admitted_res)
    check(fused["launches"]["fused_complex_dot"] == want_launches,
          f"{label} fused rung launched fused_complex_dot "
          f"{fused['launches']['fused_complex_dot']} times; the gate admits "
          f"{len(admitted_pre)} prelude steps and {len(admitted_res)} residual steps a batch")
    want_routed = collections.Counter(routed_pre)
    for reason, count in routed_res.items():
        want_routed[reason] += count * (hi - lo)
    check(fused["routed"] == dict(want_routed),
          f"{label} fused rung routed {fused['routed']}, the plan's gate says "
          f"{dict(want_routed)}")
    check(all(r["batch"] in (1, batch) for r in dot_rows),
          f"a launch of {label}'s forced rung was batched over other than {batch} slices")
    z_fused = scalar(fused["out"])
    gate = 1e-5 * sum(abs(r) for r in refs[lo:hi])
    print(f"[check] {label} fused rung on slices {lo}-{hi - 1}: {z_fused!r} vs default "
          f"rung {default_range!r}, |diff| {abs(z_fused - default_range):.3e} (gate "
          f"{gate:.3e})", flush=True)
    check(abs(z_fused - default_range) <= gate,
          f"{label} fused rung disagrees with the default rung")
    return {"dot_rows": dot_rows, "record": {
        "fused_range": [lo, hi], "fused_wall_s": fused["walls"][0],
        "fused_launches": fused["launches"], "fused_routed": fused["routed"],
        "fused_diff": abs(z_fused - default_range), "fused_graphs": graphed}}


def time_prelude(backend, sp, arrays, reps: int = 3) -> list[float]:
    """Seconds of the hoisted prelude alone, on resident leaves."""
    import torch

    from tnc_tpu_torch.ops.backends import place_buffers
    from tnc_tpu_torch.ops.hoist import hoisted

    full = place_buffers(arrays, backend.dtype, backend.split_complex, backend.device)
    prelude_s = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            _, cached = hoisted(sp, full, backend.split_complex, backend.precision)
        torch.cuda.synchronize()
        prelude_s.append(time.perf_counter() - t0)
        del cached
    del full
    torch.cuda.empty_cache()
    return prelude_s


def residual_batch(backend, sp, arrays, batch: int):
    """A callable running the default path's residual on slices 0 to
    ``batch - 1`` eagerly (one batch, ``graphs=False``), over resident
    leaves and the prelude's cached values computed here once: one batch
    of the slice loop and nothing else, for a profile."""
    import torch

    from tnc_tpu_torch.ops.backends import place_buffers
    from tnc_tpu_torch.ops.chunked import run_sliced_chunked_placed
    from tnc_tpu_torch.ops.hoist import hoisted

    full = place_buffers(arrays, backend.dtype, backend.split_complex, backend.device)
    with torch.inference_mode():
        residual, cached = hoisted(sp, full, backend.split_complex, backend.precision)
    del full
    return lambda: run_sliced_chunked_placed(
        residual, cached, batch=backend.slice_batch, chunk_steps=backend.chunk_steps,
        split_complex=backend.split_complex, precision=backend.precision,
        dtype=backend.dtype, device=backend.device, slice_range=(0, batch), graphs=False)


def run_sliced_chunked(backend, cell) -> dict:
    """The sliced cell on the default ``TorchBackend()``: the stem hoisted,
    the residual chunked and batched over slices. Plan; the amplitude through
    ``contract_tensor_network_sliced`` (one warm-up, two timed runs), the
    device-resident part, the prelude timed apart and a profile of one
    batch; the amplitude against phase 8's complex128 partials and the
    loop's amplitude; the forced ``fused`` rung on the first two batches
    (``fused_complex_dot`` held against its plain version on the batched
    operands the executor builds, launches and routed steps held to the
    plan's gate, the sum against the default rung's)."""
    from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network_sliced

    tn, path, sl, sp = cell["tn"], cell["path"], cell["slicing"], cell["sp"]
    arrays, refs = cell["arrays"], cell["refs"]
    n = sl.num_slices
    plan_rec = chunked_plan(backend, sp)
    print_chunked_plan(f"sycamore{SLICED[:3]}", plan_rec, backend)

    main = run_counted(lambda: contract_tensor_network_sliced(tn, path, sl, backend),
                       "sliced chunked main path", reps=MAIN_SLICED_REPS)
    z = scalar(main["out"])
    eager = run_counted(lambda: backend.execute_sliced(sp, arrays, graphs=False),
                        "sliced chunked main path, eager", reps=1, warmup=lambda: None)
    prof = profile_device_path(
        lambda: backend.execute_sliced(sp, arrays, host=False), "sliced chunked", reps=1,
        profiled=residual_batch(backend, sp, arrays, plan_rec["batch"]))
    prelude_s = time_prelude(backend, sp, arrays)
    batches = n // plan_rec["batch"]
    replay = profile_replay(
        lambda: backend.execute_sliced(sp, arrays, slice_range=(0, 3 * plan_rec["batch"]),
                                       host=False), "sliced chunked", 2)
    graphed = compare_graphed("sycamore53_m10 chunked", main, eager, plan_rec["chunks"],
                              batches, replay)
    del eager
    per_batch_ms = (prof["device_s"] - statistics.median(prelude_s)) / batches * 1e3
    print(f"[chunked] wall {statistics.median(main['walls']):.4f} s (runs "
          f"{[round(w, 4) for w in main['walls']]}), device-resident {prof['device_s']:.4f} s, "
          f"prelude {statistics.median(prelude_s) * 1e3:.3f} ms (runs "
          f"{[round(t * 1e3, 3) for t in prelude_s]}), {batches} batches of "
          f"{plan_rec['batch']}: {per_batch_ms:.3f} ms a batch, "
          f"{per_batch_ms / plan_rec['batch']:.3f} ms a slice; max_memory_allocated "
          f"{main['peak_bytes']} bytes against the modeled {plan_rec['modeled_peak_bytes']}",
          flush=True)

    # against complex128 and the loop
    # phase 8's complex128 partials and loop sum cover all slices, or the
    # first 32 when complex128 of all would have taken too long
    if len(refs) == n:
        scope, got = f"all {n} slices", z
    else:
        scope = f"the first {len(refs)} slices"
        got = scalar(backend.execute_sliced(sp, arrays, slice_range=(0, len(refs))))
    loop_z, want = cell["loop_sum"], sum(refs)
    abs_sum = sum(abs(r) for r in refs)
    print(f"[check] sliced chunked over {scope}: {got!r} vs complex128 {want!r}, |diff| "
          f"{abs(got - want):.3e} (gate 1e-4 x sum|ref_s| = {1e-4 * abs_sum:.3e}); vs the "
          f"unhoisted loop {loop_z!r}, |diff| {abs(got - loop_z):.3e} (gate 1e-5 x sum|ref_s| "
          f"= {1e-5 * abs_sum:.3e})", flush=True)
    check(abs(got - want) <= 1e-4 * abs_sum,
          f"chunked amplitude over {scope} off complex128 by {abs(got - want)}")
    check(abs(got - loop_z) <= 1e-5 * abs_sum,
          f"chunked amplitude over {scope} off the loop's by {abs(got - loop_z)}")

    # the forced fused rung on the first two batches
    fused = check_fused_first_batch(backend, sp, arrays, plan_rec["batch"], refs,
                                    "sliced chunked")
    record = {
        "plan": plan_rec, "wall_s": statistics.median(main["walls"]),
        "wall_runs_s": main["walls"], "peak_bytes": main["peak_bytes"],
        "launches": main["launches"], **prof, "prelude_s": statistics.median(prelude_s),
        "prelude_runs_s": prelude_s, "per_batch_ms": per_batch_ms,
        "per_slice_ms": per_batch_ms / plan_rec["batch"], "graphs": graphed,
        "amplitude": [z.real, z.imag],
        "check_scope": scope, "complex128_diff": abs(got - want),
        "loop_diff": abs(got - loop_z), **fused["record"],
    }
    return {"record": record, "dot_rows": fused["dot_rows"],
            "dot_launches": fused["record"]["fused_launches"]["fused_complex_dot"]}


class HostJob:
    """``python3 chip_smoke.py FLAG DIR``: host work in a process group of
    its own beside the card's phases, its output in ``DIR/job.log``.
    ``wait()`` waits for it (at most ``NORTHSTAR_PLAN_WAIT_S``) and checks
    its exit; ``stop()`` (also run at exit) ends the group, pools included,
    and removes ``DIR``."""

    def __init__(self, flag: str, what: str, env: dict | None = None) -> None:
        import atexit
        import tempfile

        self.what = what
        self.dir = tempfile.mkdtemp(prefix=flag.strip("-") + "-")
        self.log = open(os.path.join(self.dir, "job.log"), "w+")
        self.stopped = False
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), flag, self.dir],
            stdout=self.log, stderr=subprocess.STDOUT, env=env, start_new_session=True)
        atexit.register(self.stop)

    def stop(self) -> None:
        import shutil
        import signal

        if self.stopped:
            return
        self.stopped = True
        with contextlib.suppress(ProcessLookupError):
            os.killpg(self.proc.pid, signal.SIGKILL)
        self.proc.wait()
        self.log.close()
        shutil.rmtree(self.dir, ignore_errors=True)

    def wait(self) -> float:
        """This process's seconds waiting for the job."""
        t0 = time.perf_counter()
        try:
            rc = self.proc.wait(timeout=NORTHSTAR_PLAN_WAIT_S)
        except subprocess.TimeoutExpired:
            fail(f"{self.what} took over {NORTHSTAR_PLAN_WAIT_S:g} s")
        wait_s = time.perf_counter() - t0
        self.log.seek(0)
        check(rc == 0, f"{self.what} exited with {rc}: {self.log.read()[-4000:]}")
        return wait_s


class BackgroundPlan(HostJob):
    """The north star's plan made by ``python3 chip_smoke.py
    --northstar-plan-to DIR``, which keeps the plan in ``DIR`` (the port's
    ``plan_northstar`` cache). Its trial pool has one worker fewer than the
    host's cores, so the card's phases keep a core; the trials' merge is the
    same at any worker count."""

    def __init__(self) -> None:
        env = dict(os.environ)
        env.setdefault("TNC_TPU_HYPER_WORKERS", str(max(1, len(os.sched_getaffinity(0)) - 1)))
        self.workers = env["TNC_TPU_HYPER_WORKERS"]
        super().__init__(NORTHSTAR_PLAN_FLAG, "the north-star plan process", env)

    def result(self):
        """Wait for the plan and load it; the record keeps the child's
        ``plan_s`` and adds ``wait_s`` (this process's wait) and ``load_s``."""
        from tnc_tpu_torch.benchmark.northstar import plan_northstar

        qubits, depth, seed, ntrials, target = NORTHSTAR
        wait_s = self.wait()
        kept = [f for f in os.listdir(self.dir) if f.endswith(".json")]
        check(len(kept) == 1, f"the north-star plan process kept {kept}")
        with open(os.path.join(self.dir, kept[0])) as f:
            plan_s = json.load(f)["record"]["plan_s"]
        plan = plan_northstar(qubits, depth, seed, ntrials, float(target), cache=True,
                              cache_dir=self.dir)
        check(plan.record["cached"], "the kept north-star plan did not load")
        plan.record.update(load_s=plan.record["plan_s"], plan_s=plan_s, wait_s=wait_s)
        return plan


def make_northstar_plan(directory: str) -> int:
    """``--northstar-plan-to DIR``: plan the north star and keep it in
    ``DIR``; host work only, no torch."""
    from tnc_tpu_torch.benchmark.northstar import plan_northstar

    qubits, depth, seed, ntrials, target = NORTHSTAR
    plan_northstar(qubits, depth, seed, ntrials, float(target), cache=True,
                   cache_dir=directory)
    return 0


def run_northstar(backend, reps: int = 3, run_slices: int | None = NORTHSTAR_RUN,
                  planned: BackgroundPlan | None = None) -> dict:
    """The north star (``NORTHSTAR``, BASELINE config #3): one Sycamore-53
    depth-14 amplitude planned afresh by the port's ``plan_northstar``
    (``Hyperoptimizer`` and ``slice_and_reconfigure`` with the reference's
    defaults) and contracted on the default ``TorchBackend()``. The plan,
    held to its bound and to the reference's plan quality; the default
    path's plan; each chain of the first batch held against its plain
    version; the first ``run_slices`` slices (``None``: all, through
    ``contract_tensor_network_sliced``; else ``TorchBackend.execute_sliced``
    over that range) after a warm-up on the first batch, ``reps`` timed
    runs, then the device-resident part once, the prelude apart and a
    profile of one batch; slices 0-15 one by one and the sum of those
    slices against complex128 on the card; the forced ``fused`` rung on the
    first two batches."""
    import torch

    from tnc_tpu_torch.benchmark.northstar import plan_northstar
    from tnc_tpu_torch.ops import split_complex
    from tnc_tpu_torch.ops.backends import TorchBackend
    from tnc_tpu_torch.ops.hoist import hoist_sliced_program
    from tnc_tpu_torch.ops.program import flat_leaf_tensors, step_dims
    from tnc_tpu_torch.ops.sliced import build_sliced_program
    from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network_sliced

    qubits, depth, seed, ntrials, target = NORTHSTAR
    if planned is None:
        plan = plan_northstar(qubits, depth, seed, ntrials, float(target))
        where = ""
    else:
        plan = planned.result()
        where = (f" (in a process beside phases 2-9 with a pool of {planned.workers}; "
                 f"waited {plan.record['wait_s']:.2f} s for it, loaded in "
                 f"{plan.record['load_s']:.2f} s)")
        planned.stop()
    rec = plan.record
    tn, path, sl = plan.tn, plan.path, plan.slicing
    n = sl.num_slices
    limit = NORTHSTAR_QUALITY * NORTHSTAR_REF_SLICED_FLOPS
    trials = (f"spawn pool of {rec['trials']['workers']} workers"
              if rec["trials"]["mode"] == "pool"
              else f"serial loop (pool error: {rec['trials']['pool_error']})")
    print(f"[northstar plan] sycamore({qubits}, {depth}, rng {seed}): {rec['tensors_raw']} -> "
          f"{rec['tensors']} tensors; Hyperoptimizer(ntrials={ntrials}, "
          f"target_size=2^{target}) {rec['hyper_s']:.2f} s on the {trials} "
          f"({rec['cpu_count']} host cores), slice_and_reconfigure {rec['slice_s']:.2f} s, "
          f"plan {rec['plan_s']:.2f} s in all{where}; planner engines: {rec['native']}; path flops "
          f"{rec['path_flops']:.4e}, unsliced peak {rec['path_peak']:.4e}; {n} slices over "
          f"legs {rec['sliced_legs']}, per-slice peak {rec['slice_peak']:.4e} elements; sliced "
          f"flops {rec['sliced_total_flops']:.4e} (gate {limit:.4e} = {NORTHSTAR_QUALITY} x the "
          f"reference's {NORTHSTAR_REF_SLICED_FLOPS:.4e}), hoisted {rec['hoisted_total_flops']:.4e}",
          flush=True)
    check(rec["slice_peak"] <= 2.0 ** target,
          f"north-star per-slice peak {rec['slice_peak']} over 2^{target}")
    check(rec["sliced_total_flops"] <= limit,
          f"north-star sliced flops {rec['sliced_total_flops']} over {limit}")
    sp = build_sliced_program(tn, path, sl)
    arrays = [leaf.data.into_data() for leaf in flat_leaf_tensors(tn)]
    plan_rec = chunked_plan(backend, sp)
    batch = plan_rec["batch"]
    batches = n // batch
    chains = [(c, span) for c, spans in enumerate(plan_rec["chains"]) for span in spans]
    t_admitted, t_routed = transpose_gate(sp.program)
    # the residual's least traffic a slice: each step's operands read once and
    # its output written once, as split-complex float32 (8 bytes an element)
    res_bytes = sum(8.0 * (m * k + k * n + m * n) for m, k, n in (
        step_dims(st) for st in hoist_sliced_program(sp).residual.program.steps))
    batch_bound_ms = batch * res_bytes / PEAK_BYTES_PER_S * 1e3
    print_chunked_plan(f"sycamore{NORTHSTAR[:3]}", plan_rec, backend)
    print(f"[northstar plan] fused_transpose gate admits {t_admitted} steps (routes "
          f"{t_routed}): no shape of this plan for fused_transpose_dot", flush=True)
    check(t_admitted == 0, "the transpose gate admits a north-star step: hold it")

    run_n = n if run_slices is None else run_slices
    check(run_n % batch == 0, f"{run_n} slices are no whole number of batches of {batch}")

    # each chain of the first batch, on the operands the executor builds; a
    # row weighs the launches the run below makes at its operands
    print(f"[kernels] fused_chain against fused_chain_reference on the batched operands of "
          f"the first batch ({len(chains)} residual chains, {batches} batches, "
          f"{run_n // batch} run)", flush=True)
    chain_rows = []
    with holding("run_chain_split", hold_chain_run(
            lambda i: f"m14 chunk {chains[i][0]} steps {chains[i][1][0]}..{chains[i][1][1] - 1}"
            if i < len(chains) else f"m14 chain {i}", run_n // batch, chain_rows),
            split_complex):
        backend.execute_sliced(sp, arrays, slice_range=(0, batch))
    check(len(chain_rows) == len(chains),
          f"the first batch ran {len(chain_rows)} chains, the plan has {len(chains)}")
    check(all(r["batch"] == batch for r in chain_rows), "a north-star chain was not batched")
    torch.cuda.empty_cache()

    # the amplitude over the run's slices
    if run_n == n:
        label, contract = "northstar all slices", (
            lambda: contract_tensor_network_sliced(tn, path, sl, backend))
    else:
        label, contract = f"northstar slices 0-{run_n - 1}", (
            lambda: backend.execute_sliced(sp, arrays, slice_range=(0, run_n)))
    main = run_counted(contract, label, reps,
                       warmup=lambda: backend.execute_sliced(sp, arrays, slice_range=(0, batch)))
    z = scalar(main["out"])
    check(main["launches"]["fused_chain"] == len(chains) * (run_n // batch),
          f"fused_chain launched {main['launches']['fused_chain']} times for "
          f"{len(chains)} chains x {run_n // batch} batches")
    # the same slices eagerly, once, beside the graphed runs (not over all
    # 4096 slices: that would take another eleven minutes)
    eager = None if run_n == n else run_counted(
        lambda: backend.execute_sliced(sp, arrays, slice_range=(0, run_n), graphs=False),
        f"{label}, eager", reps=1, warmup=lambda: None)
    prof = profile_device_path(
        lambda: backend.execute_sliced(sp, arrays, slice_range=(0, run_n), host=False),
        "northstar", reps=1, profiled=residual_batch(backend, sp, arrays, batch))
    prelude_s = time_prelude(backend, sp, arrays)
    per_batch_ms = (prof["device_s"] - statistics.median(prelude_s)) / (run_n // batch) * 1e3
    replay = profile_replay(
        lambda: backend.execute_sliced(sp, arrays, slice_range=(0, 3 * batch), host=False),
        "northstar", 2)
    if eager is None:
        stats = main["graphs"]
        check((stats["graphs"], stats["replays"])
              == (plan_rec["chunks"], plan_rec["chunks"] * (run_n // batch - 1)),
              f"{label}: {stats['graphs']} graphs and {stats['replays']} replays")
        graphed = {"graphs": stats["graphs"], "replays": stats["replays"],
                   "capture_ms": stats["capture_ms"],
                   "graphed_replay_batch_ms": statistics.mean(main["batch_ms"]["replay"]),
                   "replay_profile": replay}
        print(f"[graphs {label}] {stats['graphs']} graphs captured in "
              f"{stats['capture_ms']:.3f} ms, {stats['replays']} replays, "
              f"{graphed['graphed_replay_batch_ms']:.3f} ms a replayed batch", flush=True)
    else:
        graphed = compare_graphed(f"sycamore53_m14 {label}", main, eager, plan_rec["chunks"],
                                  run_n // batch, replay)
    del eager
    print(f"[northstar] {label}: wall {statistics.median(main['walls']):.4f} s (runs "
          f"{[round(w, 4) for w in main['walls']]}), device-resident {prof['device_s']:.4f} s, "
          f"prelude {statistics.median(prelude_s) * 1e3:.3f} ms (runs "
          f"{[round(t * 1e3, 3) for t in prelude_s]}), {per_batch_ms:.3f} ms a batch of {batch} "
          f"({run_n // batch} of the amplitude's {batches} batches), {per_batch_ms / batch:.3f} "
          f"ms a slice (byte bound {batch_bound_ms:.3f} ms a batch: {res_bytes:.4e} bytes a "
          f"slice); max_memory_allocated {main['peak_bytes']} bytes against the modeled "
          f"{plan_rec['modeled_peak_bytes']}", flush=True)

    # complex128 on the card, slice by slice: the parity slices one by one,
    # then every slice run, or the first NORTHSTAR_CHECK_FEW if all would take long
    oracle = TorchBackend(dtype="complex128", split_complex=False)
    refs, worst = [], 0.0
    t0 = time.perf_counter()
    want_n = run_n
    while len(refs) < want_n:
        s = len(refs)
        refs.append(scalar(oracle.execute_sliced(sp, arrays, slice_range=(s, s + 1))))
        if s == NORTHSTAR_PARITY - 1 and (time.perf_counter() - t0) / NORTHSTAR_PARITY * run_n \
                > NORTHSTAR_CHECK_S:
            want_n = min(run_n, NORTHSTAR_CHECK_FEW)
    t_ref = time.perf_counter() - t0
    scale = max(abs(r) for r in refs[:NORTHSTAR_PARITY])
    for s in range(NORTHSTAR_PARITY):
        got = scalar(backend.execute_sliced(sp, arrays, slice_range=(s, s + 1)))
        worst = max(worst, abs(got - refs[s]))
        check(abs(got - refs[s]) <= 1e-4 * scale,
              f"north-star slice {s}: {got!r} off complex128 {refs[s]!r} by {abs(got - refs[s])}")
    if want_n == run_n:
        scope, got_sum = f"all {run_n} slices run", z
    else:
        scope = (f"the first {want_n} slices (complex128 of all {run_n} would take over "
                 f"{NORTHSTAR_CHECK_S:g} s)")
        got_sum = scalar(backend.execute_sliced(sp, arrays, slice_range=(0, want_n)))
    want_sum, abs_sum = sum(refs), sum(abs(r) for r in refs)
    print(f"[check] northstar slices 0-{NORTHSTAR_PARITY - 1} against complex128 on the card: "
          f"max|diff| {worst:.3e} (gate 1e-4 x max|ref_s| = {1e-4 * scale:.3e}); {scope}: "
          f"{got_sum!r} vs {want_sum!r}, |diff| {abs(got_sum - want_sum):.3e} (gate 1e-4 x "
          f"sum|ref_s| = {1e-4 * abs_sum:.3e}); complex128 of {len(refs)} slices took "
          f"{t_ref:.3f} s", flush=True)
    check(abs(got_sum - want_sum) <= 1e-4 * abs_sum,
          f"north-star amplitude over {scope} off complex128 by {abs(got_sum - want_sum)}")
    torch.cuda.empty_cache()

    # the forced fused rung on the first two batches
    fused = check_fused_first_batch(backend, sp, arrays, batch, refs, "northstar")
    record = {
        "plan": rec, "chunked_plan": plan_rec, "transpose_gate": [t_admitted, t_routed],
        "wall_s": statistics.median(main["walls"]), "wall_runs_s": main["walls"],
        "peak_bytes": main["peak_bytes"], "launches": main["launches"],
        "chain_forms": main["chain_forms"], **prof, "run_slices": run_n,
        "prelude_s": statistics.median(prelude_s), "prelude_runs_s": prelude_s,
        "per_batch_ms": per_batch_ms, "per_slice_ms": per_batch_ms / batch,
        "graphs": graphed, "residual_bytes_per_slice": res_bytes, "batch_bound_ms": batch_bound_ms,
        "amplitude": [z.real, z.imag], "check_scope": scope,
        "complex128": [want_sum.real, want_sum.imag], "complex128_sum_abs": abs_sum,
        "complex128_slices": len(refs), "complex128_s": t_ref,
        "parity_max_diff": worst, **fused["record"],
    }
    return {"record": record, "chain_rows": chain_rows, "dot_rows": fused["dot_rows"],
            "chain_launches": main["launches"]["fused_chain"],
            "dot_launches": fused["record"]["fused_launches"]["fused_complex_dot"]}


def run_chunked_small(backend) -> dict:
    """The two small Sycamore amplitudes (``CHUNKED_SMALL``) on the default
    sliced path, against the complex128 numpy oracle. Each batched
    ``fused_chain`` launch of an eager run is held against its plain
    version on the batched operands the executor builds; then counted runs,
    graphed (the default: every batch after the first replays the chunks'
    graphs) against eager, whose launches must be one per residual chain
    and batch. The 4-slice amplitude runs in one batch of 4, so it is also
    run in batches of 2, where the second batch replays."""
    from tnc_tpu_torch.ops import split_complex
    from tnc_tpu_torch.ops.backends import NumpyBackend, TorchBackend
    from tnc_tpu_torch.ops.chunked import chunk_plan, resolve_batch
    from tnc_tpu_torch.ops.hoist import hoist_sliced_program
    from tnc_tpu_torch.ops.program import flat_leaf_tensors
    from tnc_tpu_torch.ops.sliced import build_sliced_program
    from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network_sliced

    rows, records, launches = [], {}, {}
    for cfg in CHUNKED_SMALL:
        name = f"sycamore{cfg[0]}_m{cfg[1]}_t{cfg[3]} chunked"
        tn, path, sl = build_sliced(cfg)
        sp = build_sliced_program(tn, path, sl)
        arrays = [leaf.data.into_data() for leaf in flat_leaf_tensors(tn)]
        residual = hoist_sliced_program(sp).residual
        want = scalar(contract_tensor_network_sliced(tn, path, sl, NumpyBackend()))
        cells = {}  # requested slice batch -> (batch run, chunks, residual chains)
        for slice_batch in (backend.slice_batch, 2):
            batch = resolve_batch(residual, slice_batch, device=backend.device)[0]
            if any(batch == cell[0] for cell in cells.values()):
                continue  # already run in batches of this size
            plans = chunk_plan(residual, batch, backend.chunk_steps, True, backend.precision)
            cells[slice_batch] = (batch, len(plans),
                                  sum(len(cp.policy.chains) for cp in plans))
        for slice_batch, (batch, chunks, chains) in cells.items():
            run_backend = (backend if slice_batch == backend.slice_batch
                           else TorchBackend(slice_batch=slice_batch))
            label = name if slice_batch == backend.slice_batch else f"{name}, batch {batch}"
            batches = sl.num_slices // batch
            expect = chains * batches
            print(f"[kernels] fused_chain against fused_chain_reference on the batched "
                  f"operands of sycamore{cfg[:3]} ({sl.num_slices} slices, batch {batch}, "
                  f"{chains} residual chain(s))", flush=True)
            held = []
            with holding("run_chain_split", hold_chain_run(
                    lambda i: f"{label} launch {i}", 1, held), split_complex):
                run_backend.execute_sliced(sp, arrays, graphs=False)
            check(len(held) == expect, f"{label}: {len(held)} chain calls, expected {expect}")
            check(all(r["batch"] == batch for r in held),
                  f"{label}: a chain launch was not batched")
            rows += held
            graphed = run_counted(
                lambda: contract_tensor_network_sliced(tn, path, sl, run_backend), label)
            eager = run_counted(lambda: run_backend.execute_sliced(sp, arrays, graphs=False),
                                f"{label}, eager", reps=1, warmup=lambda: None)
            replay = None if batches == 1 else profile_replay(
                lambda: run_backend.execute_sliced(sp, arrays, host=False), label,
                min(2, batches - 1))
            compared = compare_graphed(label, graphed, eager, chunks, batches, replay)
            got = scalar(graphed["out"])
            launches[label] = graphed["launches"]["fused_chain"]
            forms = graphed["chain_forms"]
            rel = abs(got - want) / abs(want)
            print(f"[check] {label} over {sl.num_slices} slices: {got!r} vs numpy complex128 "
                  f"{want!r}, relative {rel:.3e}; fused_chain launched {launches[label]} "
                  f"times, by form {forms}", flush=True)
            check(rel <= 1e-5, f"{label} off the host oracle by {rel}")
            check(launches[label] == expect,
                  f"{label}: fused_chain launched {launches[label]} times, expected {expect}")
            records[label] = {"config": list(cfg), "slices": sl.num_slices, "batch": batch,
                              "chains": chains, "relative": rel,
                              "fused_chain_launches": launches[label],
                              "fused_chain_forms": forms, "graphs": compared}
    return {"records": records, "chain_rows": rows, "launches": launches}


def event_ms(fn, reps: int, warmup: int = 1) -> float:
    """Device ms per call of ``fn()``: CUDA events around ``reps`` calls
    after ``warmup`` calls (products large enough that the host stays ahead
    of the card)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rung_counts(policy, forms: dict | None = None) -> dict:
    """A policy's rungs: chains and chained steps (and, from a run, its
    chain launches by form), then steps by mode and ``high`` rungs."""
    modes = collections.Counter(
        m for i, m in enumerate(policy.modes) if i not in policy.chained_steps())
    out = {"chains": len(policy.chains), "chained_steps": len(policy.chained_steps()),
           **{mode: modes.get(mode, 0) for mode in ("strassen", "fused_transpose", "gauss")},
           "high": list(policy.precision_modes).count("high")}
    if forms is not None:
        out["chain_launches_by_form"] = forms
    return out


def calibrated_refs(backend) -> dict:
    """What the calibrated phase holds its results to when it runs alone
    (``--calibrated``): the default policy's statevector and PEPS norm,
    four amplitudes and the norm in complex128 on the card, as phases 3, 4
    and 7 make them."""
    from tnc_tpu_torch.ops.backends import TorchBackend
    from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network

    tn, permutor = build_config(QUBITS)
    leaf = contract_tensor_network(tn, plan(tn), backend)
    oracle = TorchBackend(dtype="complex128", split_complex=False)
    amps = []
    for bits in np.random.default_rng(7).integers(0, 2, size=(4, QUBITS)):
        bitstring = "".join(str(int(b)) for b in bits)
        amp_tn, _ = build_config(QUBITS, bitstring)
        amps.append((bits, complex(contract_tensor_network(amp_tn, plan(amp_tn), oracle)
                                   .data.into_data())))
    peps_tn = build_peps(PEPS)
    peps_path = plan(peps_tn)
    z = scalar(contract_tensor_network(peps_tn, peps_path, backend))
    z128 = scalar(contract_tensor_network(peps_tn, peps_path, oracle))
    return {"sv": np.asarray(leaf.data.into_data()),
            "qubit_of": {leg: q for q, leg in enumerate(permutor.target_leg_order)},
            "amplitudes": amps, "peps_norm": z, "peps_norm_complex128": z128,
            "main_walls": [], "main_device_s": None, "peps_wall_s": None,
            "peps_device_s": None}


def device_times(run, reps: int = 3) -> list[float]:
    """Wall seconds of ``reps`` synchronised calls of ``run()`` (a
    contraction's device-resident part)."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del out
    return times


def strassen_crossover(model, peps_program, gen) -> dict:
    """The H100's Strassen crossover: ``gauss`` (``apply_step_split``)
    against one Strassen level (its ``strassen`` branch, run whatever the
    step's eligibility) on square FP32 split products at
    :data:`STRASSEN_SIZES` and at the PEPS cell's Strassen stems, device ms
    from CUDA events; each measured saving printed beside
    ``_strassen_saving_s`` under the fitted model. Every constant stays as
    it is."""
    import torch

    from tnc_tpu_torch.ops.program import build_program, step_dims
    from tnc_tpu_torch.ops.split_complex import (
        _step_operands,
        _strassen_saving_s,
        _strassen_step_eligible,
        apply_step_split,
    )
    from tnc_tpu_torch.ops.strassen import gauss_strassen_dot_kl

    def strassen(apair, bpair, st):
        # apply_step_split's strassen branch without its eligibility gate
        ar, ai, br, bi = _step_operands(apair, bpair, st)
        re, im = (gauss_strassen_dot_kl(br, bi, ar, ai) if st.swap
                  else gauss_strassen_dot_kl(ar, ai, br, bi))
        return re.reshape(st.out_store), im.reshape(st.out_store)
    from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor, LeafTensor
    from tnc_tpu_torch.contractionpath.contraction_path import ContractionPath

    cases = []
    for n in STRASSEN_SIZES:
        tn = CompositeTensor([LeafTensor([0, 1], [n, n]), LeafTensor([1, 2], [n, n])])
        cases.append((f"square n={n}", n, build_program(tn, ContractionPath.simple([(0, 1)]))
                      .steps[0]))
    for i, st in enumerate(peps_program.steps):
        if _strassen_step_eligible(st):
            cases.append((f"peps step {i}", None, st))
    rows = []
    for label, n, st in cases:
        m, k, nn = step_dims(st)

        def pair(view):
            return tuple(torch.randn(math.prod(view), generator=gen, device="cuda")
                         for _ in range(2))

        a, b = pair(st.a_view), pair(st.b_view)
        reps = 5 if m * k * nn <= 2 ** 39 else 1
        ms = {"gauss": event_ms(lambda: apply_step_split(a, b, st, mode="gauss"), reps),
              "strassen": event_ms(lambda: strassen(a, b, st), reps)}
        got = strassen(a, b, st)
        want = apply_step_split(a, b, st, mode="gauss")
        err, scale = max_err(got, want)
        del got, want, a, b
        torch.cuda.empty_cache()
        check(err <= 1e-3 * scale, f"strassen {label}: max|err| {err} > 1e-3 * {scale}")
        predicted = _strassen_saving_s(model, m, k, nn) * 1e3
        eligible = _strassen_step_eligible(st)
        row = {"label": label, "n": n, "m": m, "k": k, "n_out": nn, "eligible": eligible,
               "gauss_ms": ms["gauss"], "strassen_ms": ms["strassen"],
               "saving_ms": ms["gauss"] - ms["strassen"], "predicted_saving_ms": predicted,
               "err": err, "scale": scale}
        rows.append(row)
        print(f"  strassen {label} (m {m}, k {k}, n {nn}; eligible {eligible}): gauss "
              f"{ms['gauss']:.4f} ms, one Strassen level {ms['strassen']:.4f} ms, saving "
              f"{row['saving_ms']:.4f} ms measured, {predicted:.4f} ms under the fitted model; "
              f"max|err| against gauss {err:.3e} (scale {scale:.3e})", flush=True)
    square = [r for r in rows if r["n"] is not None]
    wins = [r["n"] for r in square if r["saving_ms"] > 0]
    # the crossover: the smallest n from which one level wins at every
    # larger size timed
    crossover = next((r["n"] for i, r in enumerate(square)
                      if all(s["saving_ms"] > 0 for s in square[i:])), None)
    print(f"[strassen] one Strassen level wins at square n = {wins}; the smallest n from "
          f"which it wins at every larger size timed: {crossover} (the port keeps the "
          f"reference's 2^11 floor)", flush=True)
    return {"rows": rows, "wins_n": wins, "crossover_n": crossover}


def run_calibrated(refs: dict, gen) -> dict:
    """The calibrated kernel ladder on the card: a step-timed calibration
    pass of random28 and peps44_b32 on the default policy, the device
    model fitted to its ``torch`` step spans, both cells planned and run
    under the calibrated policy (launches held to the policy, every chain
    it launches held against its plain version, results against the
    default policy's and complex128's), and the Strassen crossover."""
    import torch

    from tnc_tpu_torch import obs
    from tnc_tpu_torch.obs.calibrate import (
        CalibratedCostModel,
        aggregate_samples,
        calibration_report,
        fit_device_model,
        format_calibration_table,
        step_samples,
    )
    from tnc_tpu_torch.ops.backends import TorchBackend
    from tnc_tpu_torch.ops.program import build_program
    from tnc_tpu_torch.ops.split_complex import chain_flop_ceiling, plan_kernels
    from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network

    tn, _ = build_config(QUBITS)
    path = plan(tn)
    program = build_program(tn, path)
    peps_tn = build_peps(PEPS)
    peps_path = plan(peps_tn)
    peps_program = build_program(peps_tn, peps_path)
    cells = (("random28", tn, path, program), ("peps44_b32", peps_tn, peps_path, peps_program))

    # 1. the calibration pass, on the default (no-model) policy: planned
    # before any sample exists, one untraced warm-up, then one traced run
    # of each cell, every launch unit synchronised inside its span
    obs.configure(enabled=False, step_time=False)
    obs.reset()
    calib = TorchBackend()
    for _, cell_tn, cell_path, cell_program in cells:
        calib.kernel_policy(cell_program)
        contract_tensor_network(cell_tn, cell_path, calib)
    obs.configure(enabled=True, step_time=True)
    obs.reset()
    t0 = time.perf_counter()
    for _, cell_tn, cell_path, _ in cells:
        contract_tensor_network(cell_tn, cell_path, calib)
    calib_s = time.perf_counter() - t0
    obs.configure(enabled=False, step_time=False)  # the registry stays
    samples = step_samples()
    torch_samples = [s for s in samples if s.source == "torch"]
    units = sum(calib.kernel_policy(p).dispatch_count() for *_, p in cells)
    print(f"[calibrated] calibration pass: {len(torch_samples)} torch step samples "
          f"({units} launch units in the two cells), {calib_s:.3f} s", flush=True)
    check(len(torch_samples) == units,
          f"{len(torch_samples)} torch step spans for {units} launch units")

    # 2. the H100's device model
    model = fit_device_model([s for s in aggregate_samples(samples) if s.source == "torch"])
    check(model is not None, "no device model could be fitted to the card's step spans")
    report = calibration_report(top=8)
    print(f"[calibrated] device model: flops_per_s {model.flops_per_s:.6e} (complex "
          f"multiply-adds/s), bytes_per_s {model.bytes_per_s}, dispatch_s "
          f"{model.dispatch_s:.6e}, terms {model.terms}, n_samples {model.n_samples}",
          flush=True)
    for line in format_calibration_table(report).splitlines():
        print(f"  {line}", flush=True)

    # 3. the calibrated policy, planned by a fresh backend from the registry
    cost_model = CalibratedCostModel.from_registry()
    backend = TorchBackend()
    ceiling = chain_flop_ceiling(cost_model)
    print(f"[calibrated] chain ceiling {ceiling:.6e} (2*k*m*n units; no model "
          f"{chain_flop_ceiling(None):.6e})", flush=True)
    policies = {}
    for name, _, _, cell_program in cells:
        policy = backend.kernel_policy(cell_program)
        check(policy.signature() == plan_kernels(cell_program, cost_model=cost_model)
              .signature(), f"{name}: kernel_policy is not the calibrated plan")
        policies[name] = policy
        default = plan_kernels(cell_program)
        print(f"[calibrated {name}] policy: calibrated {rung_counts(policy)}; no model "
              f"{rung_counts(default)}; chains {list(policy.chains)}", flush=True)

    # 4. both cells under the calibrated policy
    chain_rows, records = [], {}
    rung_dots = rung_dot_state()
    for name, cell_tn, cell_path, cell_program in cells:
        policy = policies[name]
        if policy.chains:
            print(f"[kernels] fused_chain on the calibrated {name} policy's chains", flush=True)
            rows = check_chains(cell_program, policy, gen)
            for row in rows:
                row["label"] = f"{name} calibrated {row['label']}"
            chain_rows += rows
        torch.cuda.empty_cache()
        # a stem step the model promotes to high launches fused_complex_dot
        # at the rung: every such launch held (none when nothing promotes)
        with holding_rung_dots(rung_dots, f"{name} calibrated"):
            run = run_main_path(cell_tn, cell_path, backend, f"{name} calibrated", reps=1)
        check(run["launches"]["fused_chain"] == len(policy.chains),
              f"{name} calibrated: fused_chain launched {run['launches']['fused_chain']} "
              f"times for {len(policy.chains)} chains")
        promoted = policy.modes.count("fused_transpose")
        routed = sum(run["transpose_routed"].values())
        check(run["launches"]["fused_transpose_dot"] + routed == promoted,
              f"{name} calibrated: {run['launches']['fused_transpose_dot']} fused_transpose_dot "
              f"launches and {routed} routed steps for {promoted} promoted steps")
        out = run.pop("out")
        with holding_rung_dots(rung_dots, f"{name} calibrated"):
            dev = device_times(device_run(cell_tn, cell_path, backend), reps=1)
        records[name] = {
            "policy": rung_counts(policy, dict(run["chain_forms"])),
            "no_model_policy": rung_counts(plan_kernels(cell_program)),
            "chains": [list(c) for c in policy.chains],
            "wall_s": statistics.median(run["walls"]), "wall_runs_s": run["walls"],
            "device_s": statistics.median(dev), "device_runs_s": dev,
            "peak_bytes": run["peak_bytes"], "launches": run["launches"],
            "transpose_routed": run["transpose_routed"]}
        if name == "random28":
            sv = np.asarray(out.data.into_data())
            stats = statevector_stats(sv, refs["sv"])
            check(sv.shape == (2,) * QUBITS and stats["finite"],
                  f"calibrated statevector has shape {sv.shape} or non-finite values")
            scale, diff, norm = stats["scale"], stats["diff"], stats["norm"]
            check(stats["close"], "random28 calibrated disagrees with the default policy")
            check(abs(norm - 1.0) <= 1e-4, f"calibrated norm {norm} not within 1e-4 of 1")
            worst = 0.0
            for bits, ref in refs["amplitudes"]:
                got = complex(sv[tuple(int(bits[refs["qubit_of"][leg]]) for leg in out.legs)])
                tol = 1e-4 * max(abs(ref), 2.0 ** -14)
                check(abs(got - ref) <= tol, f"calibrated amplitude off by {abs(got - ref)}")
                worst = max(worst, abs(got - ref) / tol)
            records[name].update(max_diff_default=diff, norm=norm, amplitude_worst_of_tol=worst)
            print(f"[check] random28 calibrated: max|diff| vs the default policy {diff:.3e} "
                  f"(scale {scale:.3e}), norm {norm:.8f}, four amplitudes against complex128 "
                  f"within {worst:.3f} of their tolerance", flush=True)
            before = (f"phase 3 wall {statistics.median(refs['main_walls']):.4f} s, "
                      f"device-resident {refs['main_device_s']:.4f} s; "
                      if refs["main_walls"] else "")
            del sv
        else:
            z = scalar(out)
            rel128 = abs(z - refs["peps_norm_complex128"]) / abs(refs["peps_norm_complex128"])
            rel = abs(z - refs["peps_norm"]) / abs(refs["peps_norm"])
            check(rel128 <= 1e-4, f"peps calibrated off complex128 by {rel128}")
            check(rel <= 1e-4, f"peps calibrated off the default policy by {rel}")
            records[name].update(norm=[z.real, z.imag], rel_complex128=rel128,
                                 rel_default=rel)
            print(f"[check] peps{PEPS} calibrated {z!r}: relative {rel128:.3e} to complex128, "
                  f"{rel:.3e} to the default policy", flush=True)
            before = (f"phase 7 wall {refs['peps_wall_s']:.4f} s, device-resident "
                      f"{refs['peps_device_s']:.4f} s; " if refs["peps_wall_s"] else "")
        del out
        print(f"[calibrated {name}] {before}calibrated wall {records[name]['wall_s']:.4f} s "
              f"(runs {[round(w, 4) for w in run['walls']]}), device-resident "
              f"{records[name]['device_s']:.4f} s (runs {[round(t, 4) for t in dev]}); "
              f"fused_chain by form {run['chain_forms']}", flush=True)
        torch.cuda.empty_cache()

    hold_rung_dots(rung_dots)  # the promoted stem steps' launches, if any

    # 5. the Strassen crossover on this card
    print("[strassen] gauss against one Strassen level, FP32 split products", flush=True)
    strassen = strassen_crossover(cost_model, peps_program, gen)
    obs.configure(enabled=False, step_time=False)
    obs.reset()  # no later call plans from these samples
    record = {
        "samples": len(torch_samples), "calibration_s": calib_s,
        "model": {"flops_per_s": model.flops_per_s, "bytes_per_s": model.bytes_per_s,
                  "dispatch_s": model.dispatch_s, "terms": list(model.terms),
                  "n_samples": model.n_samples},
        "report": {k: v for k, v in report.items() if k != "worst_steps"},
        "worst_steps": report["worst_steps"], "chain_ceiling": ceiling,
        "cells": records, "strassen": strassen,
    }
    return {"record": record, "chain_rows": chain_rows,
            "chain_launches": {f"{n} calibrated": r["launches"]["fused_chain"]
                               for n, r in records.items()},
            "transpose_launches": sum(r["launches"]["fused_transpose_dot"]
                                      for r in records.values()),
            "rung_dots": rung_dots}


def sweep_bits(seed: int = SWEEP_BITS_SEED) -> list[str]:
    rows = np.random.default_rng(seed).integers(
        0, 2, (SWEEP_BATCH - 1, SWEEP[0]))
    return ["0" * SWEEP[0]] + ["".join(str(int(b)) for b in r) for r in rows]


def sycamore(cfg):
    from tnc_tpu_torch.builders.sycamore_circuit import sycamore_circuit

    qubits, depth, seed = cfg
    return sycamore_circuit(qubits, depth, np.random.default_rng(seed))


def hold_dot_distinct(label: str, rows: list, seen: dict):
    """A hold for :func:`holding` of ``cuda_complex.fused_complex_dot`` that
    holds each distinct operand shape once through :func:`hold_dot`, its
    row weighed by the launches at that shape."""
    def hold(ar, ai, br, bi):
        key = (tuple(ar.shape), tuple(br.shape))
        if key in seen:
            rows[seen[key]]["launches"] += 1
            return
        seen[key] = len(rows)
        rows.append(hold_dot(ar, ai, br, bi, 1, f"{label} {len(rows)}"))

    return hold


def timed_batched(backend, spans: list):
    """``backend`` with its ``execute_batched`` timed by CUDA events around
    each call (seconds appended to ``spans``)."""
    import torch

    real = backend.execute_batched

    def run(program, arrays, batched):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(program, arrays, batched)
        end.record()
        end.synchronize()
        spans.append(start.elapsed_time(end) / 1e3)
        return out

    backend.execute_batched = run
    return backend


def sweep_rows(label, bits, amps, program, arrays, bras):
    """Each row of a sweep against complex128 on the card
    (``TorchBackend(dtype="complex128", split_complex=False).execute`` of
    that bitstring alone), within 1e-4 max|ref|, and against the bitstring
    run alone through ``TorchBackend().execute``, within 1e-5 max|alone|;
    each row's absolute and relative gaps printed. Returns ``(refs, alone,
    max|amp - ref|, |amp - alone| per row, bitwise equal per row)``."""
    import torch

    from tnc_tpu_torch.ops.backends import TorchBackend

    oracle = TorchBackend(dtype="complex128", split_complex=False)
    single = TorchBackend()
    refs, alone = [], []
    t0 = time.perf_counter()
    for i in range(len(bits)):
        per = [a[i] if s in bras else a for s, a in enumerate(arrays)]
        refs.append(complex(np.asarray(oracle.execute(program, per)).reshape(())))
        alone.append(complex(np.asarray(single.execute(program, per)).reshape(())))
    oracle_s = time.perf_counter() - t0
    refs, alone = np.array(refs), np.array(alone)
    scale = float(np.max(np.abs(refs)))
    err = float(np.max(np.abs(amps - refs)))
    row_err = np.abs(amps - alone)
    bitwise = [amps[i].tobytes() == alone[i].tobytes() for i in range(len(bits))]
    for i, b in enumerate(bits):
        print(f"[check] {label} {b[:12]}...: {amps[i]:.6e} complex128 {refs[i]:.6e} alone "
              f"{alone[i]:.6e} (bitwise {bitwise[i]}); |batched - alone| {row_err[i]:.3e}, "
              f"over |alone| {row_err[i] / abs(alone[i]):.3e}", flush=True)
    print(f"[check] {label}: max|amp - complex128| {err:.3e} (gate 1e-4 x {scale:.3e}); "
          f"max|batched - alone| {float(np.max(row_err)):.3e} (gate 1e-5 x "
          f"{float(np.max(np.abs(alone))):.3e}), over |alone| "
          f"{float(np.max(row_err / np.abs(alone))):.3e}; "
          f"{sum(bitwise)} of {len(bits)} rows bitwise equal to their run alone; complex128 "
          f"and alone runs {oracle_s:.2f} s", flush=True)
    check(err <= 1e-4 * scale, f"{label}: an amplitude is off complex128 by {err}")
    # both are float32 evaluations whose rounding scales with the batch's
    # amplitudes, not with one small amplitude's modulus
    alone_scale = float(np.max(np.abs(alone)))
    check(np.all(row_err <= 1e-5 * alone_scale),
          f"{label}: a batched row is off its run alone by {float(np.max(row_err))} "
          f"(gate 1e-5 x {alone_scale})")
    del oracle, single
    torch.cuda.empty_cache()
    return refs, alone, err, row_err, bitwise


def run_sweep() -> dict:
    """Phase 12: the batched amplitude sweep and the query path.

    (a) ``amplitude_sweep`` of ``SWEEP_BATCH`` bitstrings of the raw
    ``sycamore_circuit(53, 8)`` amplitude network through one
    ``TorchBackend().execute_batched``: every distinct ``fused_chain``
    launch held against its plain version (batched chains on the bra
    batch, the others once), one warm-up and two timed runs (wall,
    CUDA-event span of ``execute_batched``, peak, launches by form held to
    the policy's chains); each amplitude against complex128 on the card
    (``TorchBackend(dtype="complex128", split_complex=False).execute`` per
    bitstring) within 1e-4 max|ref| and against the same bitstrings run
    alone through ``TorchBackend().execute`` within 1e-5 max|alone|
    (:func:`sweep_rows`), then the same on a second batch of bitstrings.
    (b) the same bitstrings through ``bind_template`` /
    ``BoundProgram.amplitudes`` (the same program: bitwise equal to (a)),
    then ``SWEEP_SLICED_ROWS`` of them through the sliced branch under
    ``target_size=2**SWEEP_SLICED_TARGET`` against (a)'s complex128.
    (c) the forced ``fused`` rung on the sweep: each distinct
    ``fused_complex_dot`` launch held against its plain version, launches
    and routed steps against the plan's gate, the amplitudes against (a).
    (d) at 20 qubits: ``marginal_sweep`` over ``QUERY_PATTERNS`` patterns
    (the first ``QUERY_FIXED`` qubits fixed) against marginals summed from
    the complex128 statevector on the card, ``amplitude_sweep`` of the same
    patterns on the same route and bits; ``ChainSampler(...).sample(64,
    seed=0)`` on ``TorchBackend()`` (a first pass holds each distinct chain
    of its 20 structures against its plain version, and its launches must
    equal the timed pass's), each step's conditionals against
    complex128 on the card within 1e-5, the samples against the complex128
    sampler's, equal except where a uniform lies within ``SAMPLE_NEAR`` of
    its threshold."""
    import torch

    from tnc_tpu_torch.ops import cuda_complex, split_complex
    from tnc_tpu_torch.ops.backends import TorchBackend
    from tnc_tpu_torch.ops.batched import thread_batch
    from tnc_tpu_torch.ops.program import step_dims, step_flops
    from tnc_tpu_torch.serve import rebind
    from tnc_tpu_torch.serve.rebind import bind_template, plan_signature
    from tnc_tpu_torch.tensornetwork.sweep import _sweep_program, amplitude_sweep

    qubits, depth, seed = SWEEP
    label = f"sycamore{qubits}_m{depth}_sweep"
    bits = sweep_bits()
    t0 = time.perf_counter()
    program, arrays, bras = _sweep_program(sycamore(SWEEP), bits, None)
    plan_s = time.perf_counter() - t0
    spans: list = []
    backend = timed_batched(TorchBackend(), spans)
    policy = backend.kernel_policy(program)
    flags, feasible = thread_batch(program, bras)
    batched_chains = [(s, e) for s, e in policy.chains if any(any(f) for f in flags[s:e])]
    largest = max(math.prod(st.out_store) for st, f in zip(program.steps, flags) if any(f))
    print(f"[{label}] {len(program.steps)} steps, {sum(step_flops(st) for st in program.steps):.4e} "
          f"multiply-adds a bitstring, planned in {plan_s:.3f} s; batch {len(bits)} on "
          f"{len(bras)} bra slots, thread_batch feasible {feasible} (ignored by "
          f"TorchBackend); {len(policy.chains)} chains, {len(batched_chains)} batched; "
          f"largest batched intermediate 2^{math.log2(largest):.1f} elements a row",
          flush=True)

    # (a) the sweep: the kernels held on the path's own operands, then timed
    chain_rows: list = []
    print(f"[kernels] fused_chain against fused_chain_reference on the operands of "
          f"{label} (each distinct chain once)", flush=True)
    with holding("run_chain_split", hold_chain_run(lambda i: f"{label} chain {i}", 1,
                                                   chain_rows, {}), split_complex):
        amplitude_sweep(sycamore(SWEEP), bits, backend=backend)
    check(sum(r["launches"] for r in chain_rows) == len(policy.chains),
          f"{label}: {sum(r['launches'] for r in chain_rows)} chain calls for "
          f"{len(policy.chains)} chains")
    check(sum(r["launches"] for r in chain_rows if r["batch"] == len(bits))
          == len(batched_chains), f"{label}: batched chain launches differ from the plan")
    torch.cuda.empty_cache()
    spans.clear()
    run = run_counted(lambda: amplitude_sweep(sycamore(SWEEP), bits, backend=backend), label,
                      reps=2)
    device_s = spans[1:]  # the warm-up's span first
    amps = np.asarray(run["out"])
    check(amps.shape == (len(bits),) and np.all(np.isfinite(amps)),
          f"{label}: amplitudes of shape {amps.shape} or non-finite")
    check(run["launches"]["fused_chain"] == len(policy.chains),
          f"{label}: fused_chain launched {run['launches']['fused_chain']} times for "
          f"{len(policy.chains)} chains")
    print(f"[{label}] wall {[round(w, 4) for w in run['walls']]} s, execute_batched CUDA-event "
          f"span {[round(d, 4) for d in device_s]} s, max_memory_allocated "
          f"{run['peak_bytes']} bytes; fused_chain {run['launches']['fused_chain']} launches "
          f"by form {run['chain_forms']}, dispatch TorchBackend.execute_batched (split "
          f"complex)", flush=True)

    refs, alone, err, row_err, bitwise = sweep_rows(label, bits, amps, program, arrays, bras)
    scale = float(np.max(np.abs(refs)))
    # the per-row gaps on a second batch of bitstrings, through the same path
    bits2 = sweep_bits(SWEEP_BITS_SEED + 1)
    program2, arrays2, bras2 = _sweep_program(sycamore(SWEEP), bits2, None)
    amps2 = amplitude_sweep(sycamore(SWEEP), bits2, backend=backend)
    gaps2 = sweep_rows(f"{label} seed {SWEEP_BITS_SEED + 1}", bits2, amps2, program2, arrays2,
                       bras2)
    del program2, arrays2
    torch.cuda.empty_cache()

    # (b) the serving path: the same program, so the same bits; then sliced
    rebind.reset_dispatch()
    t0 = time.perf_counter()
    bound = bind_template(sycamore(SWEEP).into_amplitude_template("0" * qubits))
    bind_s = time.perf_counter() - t0
    check(plan_signature(bound) == program.signature_digest() and bound.bra_slots == tuple(bras),
          f"{label}: bind_template planned another program than the sweep")
    served = bound.amplitudes(bits, backend)
    check(rebind.DISPATCH == {"batched": 1}, f"{label}: dispatch {rebind.DISPATCH}")
    served_bitwise = served.tobytes() == amps.tobytes()
    print(f"[{label} serve] bind_template {bind_s:.3f} s, the sweep's program; "
          f"BoundProgram.amplitudes dispatch {rebind.DISPATCH}; bitwise equal to the sweep "
          f"{served_bitwise}", flush=True)
    check(served_bitwise, f"{label}: BoundProgram.amplitudes differs from the sweep's bits")
    rebind.reset_dispatch()
    t0 = time.perf_counter()
    sliced = bind_template(sycamore(SWEEP).into_amplitude_template("0" * qubits),
                           target_size=2.0 ** SWEEP_SLICED_TARGET)
    sliced_plan_s = time.perf_counter() - t0
    check(sliced.sliced is not None, f"{label}: target 2^{SWEEP_SLICED_TARGET} did not slice")
    t0 = time.perf_counter()
    got = sliced.amplitudes(bits[:SWEEP_SLICED_ROWS], TorchBackend())
    sliced_s = time.perf_counter() - t0
    want = refs[:SWEEP_SLICED_ROWS]
    sliced_err = float(np.max(np.abs(got - want)))
    sliced_scale = float(np.max(np.abs(want)))
    n_slices = sliced.sliced.slicing.num_slices
    print(f"[{label} serve, sliced] target 2^{SWEEP_SLICED_TARGET}: "
          f"{sliced.sliced.slicing.num_slices} slices planned in {sliced_plan_s:.3f} s; "
          f"{SWEEP_SLICED_ROWS} bitstrings in {sliced_s:.3f} s, dispatch {rebind.DISPATCH}; "
          f"max|amp - complex128| {sliced_err:.3e} (gate 1e-4 x {sliced_scale:.3e})",
          flush=True)
    check(rebind.DISPATCH == {"sliced": 1}, f"{label}: sliced dispatch {rebind.DISPATCH}")
    check(sliced_err <= 1e-4 * sliced_scale, f"{label}: the sliced branch is off by "
                                             f"{sliced_err}")
    del bound, sliced
    torch.cuda.empty_cache()

    # (c) the forced fused rung on the sweep
    admitted, routed = fused_gate(program)
    dot_rows: list = []
    os.environ["TNC_TPU_COMPLEX_MULT"] = "fused"
    try:
        print(f"[kernels] fused_complex_dot against fused_complex_dot_reference on the "
              f"operands of {label}'s forced fused rung (each distinct shape once; the gate "
              f"admits {len(admitted)} steps, routes {routed})", flush=True)
        with holding("fused_complex_dot", hold_dot_distinct(f"{label} fused rung", dot_rows,
                                                            {})):
            amplitude_sweep(sycamore(SWEEP), bits, backend=backend)
        torch.cuda.empty_cache()
        fused = run_counted(lambda: amplitude_sweep(sycamore(SWEEP), bits, backend=backend),
                            f"{label} fused rung", reps=1, warmup=lambda: None)
    finally:
        del os.environ["TNC_TPU_COMPLEX_MULT"]
    fused_amps = np.asarray(fused["out"])
    fused_err = float(np.max(np.abs(fused_amps - refs)))
    want_routed = collections.Counter()
    for i, st in enumerate(program.steps):
        if i not in admitted:
            m, k, n = step_dims(st)
            if st.swap:
                m, n = n, m
            reason = ("layout" if not (st.a_cfirst and st.b_cfirst)
                      else cuda_complex.ineligible_reason(k, m, n))
            # a batched step is counted once per row it stands for
            want_routed[reason] += len(bits) if any(flags[i]) else 1
    print(f"[check] {label} fused rung: fused_complex_dot {fused['launches']['fused_complex_dot']}"
          f" launches, routed {fused['routed']}; max|amp - complex128| {fused_err:.3e}, "
          f"|fused - default| {float(np.max(np.abs(fused_amps - amps))):.3e}", flush=True)
    check(sum(r["launches"] for r in dot_rows) == len(admitted)
          == fused["launches"]["fused_complex_dot"],
          f"{label} fused rung: {fused['launches']['fused_complex_dot']} launches, "
          f"{sum(r['launches'] for r in dot_rows)} held, the gate admits {len(admitted)}")
    check(fused["routed"] == dict(want_routed),
          f"{label} fused rung routed {fused['routed']}, the gate says {dict(want_routed)}")
    on_bras = sum(1 for i in admitted if any(flags[i]))
    check(sum(r["launches"] for r in dot_rows if r["batch"] == len(bits)) == on_bras,
          f"{label}'s forced rung: the batched fused_complex_dot launches differ from the "
          f"{on_bras} admitted steps the bras reach")
    check(fused_err <= 1e-4 * scale, f"{label} fused rung is off complex128 by {fused_err}")
    torch.cuda.empty_cache()

    query = run_queries()
    record = {
        "config": list(SWEEP), "bitstrings": bits, "steps": len(program.steps),
        "multiply_adds_per_bitstring": sum(step_flops(st) for st in program.steps),
        "plan_s": plan_s, "chains": len(policy.chains), "batched_chains": len(batched_chains),
        "largest_batched_elems": largest, "thread_batch_feasible": feasible,
        "wall_s": statistics.median(run["walls"]), "wall_runs_s": run["walls"],
        "device_s": statistics.median(device_s), "device_runs_s": device_s,
        "peak_bytes": run["peak_bytes"], "launches": run["launches"],
        "chain_forms": run["chain_forms"],
        "amplitudes": [[float(a.real), float(a.imag)] for a in amps],
        "complex128": [[float(a.real), float(a.imag)] for a in refs], "max_abs_err": err,
        "rows_bitwise_alone": sum(bitwise), "max_abs_err_alone": float(np.max(row_err)),
        "max_rel_err_alone": float(np.max(row_err / np.abs(alone))),
        "second_batch": {"seed": SWEEP_BITS_SEED + 1, "max_abs_err": gaps2[2],
                         "rows_bitwise_alone": sum(gaps2[4]),
                         "max_abs_err_alone": float(np.max(gaps2[3])),
                         "max_rel_err_alone": float(np.max(gaps2[3] / np.abs(gaps2[1]))),
                         "alone_scale": float(np.max(np.abs(gaps2[1])))},
        "serve_bitwise": served_bitwise, "bind_s": bind_s,
        "sliced": {"target_log2": SWEEP_SLICED_TARGET,
                   "slices": n_slices, "plan_s": sliced_plan_s, "rows": SWEEP_SLICED_ROWS,
                   "wall_s": sliced_s, "max_abs_err": sliced_err},
        "fused_rung": {"launches": fused["launches"], "routed": fused["routed"],
                       "wall_s": fused["walls"][0], "max_abs_err": fused_err},
        "queries": query["record"],
    }
    return {"record": record, "chain_rows": chain_rows + query["chain_rows"],
            "dot_rows": dot_rows, "chain_launches": run["launches"]["fused_chain"],
            "query_chain_launches": query["chain_launches"],
            "dot_launches": fused["launches"]["fused_complex_dot"], "label": label}


def sample_replay(samples: list, p1_of, n: int, seed: int) -> tuple[int, int]:
    """``ChainSampler``'s draws for one request of ``n`` samples under
    ``seed`` (one uniform vector a position, sample-major) replayed on
    another sampler's conditionals: ``p1_of(k, prefix)`` is that sampler's
    probability of a 1 at position ``k`` after ``prefix``. Returns
    ``(samples whose replayed bits differ, those whose first difference is
    not within SAMPLE_NEAR of its threshold)``."""
    rng = np.random.default_rng(seed)
    draws = [rng.random(n) for _ in range(len(samples[0]))]
    differ = unexplained = 0
    for i, got in enumerate(samples):
        for k, bit in enumerate(got):
            p1 = p1_of(k, got[:k])
            if ("1" if draws[k][i] < p1 else "0") != bit:
                differ += 1
                unexplained += abs(draws[k][i] - p1) > SAMPLE_NEAR
                break
    return differ, unexplained


def run_queries() -> dict:
    """Phase 12 (d): the marginal sweep and chain sampling at 20 qubits
    (:func:`run_sweep`)."""
    import torch

    from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
    from tnc_tpu_torch.ops import split_complex
    from tnc_tpu_torch.ops.backends import TorchBackend
    from tnc_tpu_torch.ops.cuda_complex import LAUNCHES, reset_launches
    from tnc_tpu_torch.queries import ChainSampler, marginal_sweep
    from tnc_tpu_torch.serve import rebind
    from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network
    from tnc_tpu_torch.tensornetwork.sweep import amplitude_sweep

    qubits, depth, seed = QUERY
    label = f"sycamore{qubits}_m{depth}"
    backend = TorchBackend()
    oracle = TorchBackend(dtype="complex128", split_complex=False)
    # the complex128 statevector on the card, in qubit order
    tn, permutor = sycamore(QUERY).into_statevector_network()
    path = Greedy(OptMethod.GREEDY).find_path(tn).replace_path()
    sv = permutor.apply(contract_tensor_network(tn, path, oracle)).data.into_data()
    probs = np.abs(np.asarray(sv).reshape((2,) * qubits)) ** 2
    del sv
    norm = float(probs.sum())
    check(abs(norm - 1.0) <= 1e-10, f"{label} statevector norm {norm}")

    # marginals
    rows = np.random.default_rng(5).integers(0, 2, (QUERY_PATTERNS, QUERY_FIXED))
    patterns = ["".join(str(int(b)) for b in r) + "*" * (qubits - QUERY_FIXED) for r in rows]
    want = np.array([probs[tuple(int(c) for c in p[:QUERY_FIXED])].sum() for p in patterns])
    chain_rows: list = []
    rebind.reset_dispatch()
    print(f"[kernels] fused_chain against fused_chain_reference on the operands of "
          f"{label}'s marginal sweep (each distinct chain once)", flush=True)
    with holding("run_chain_split", hold_chain_run(lambda i: f"{label} marginals chain {i}",
                                                   1, chain_rows, {}), split_complex):
        marginal_sweep(sycamore(QUERY), patterns, backend=backend)
    torch.cuda.empty_cache()
    rebind.reset_dispatch()
    run = run_counted(lambda: marginal_sweep(sycamore(QUERY), patterns, backend=backend),
                      f"{label} marginal_sweep", reps=1, warmup=lambda: None)
    got = np.asarray(run["out"])
    route = dict(rebind.DISPATCH)
    rebind.reset_dispatch()
    via_sweep = amplitude_sweep(sycamore(QUERY), patterns, backend=backend)
    same_route = dict(rebind.DISPATCH) == route
    m_err = float(np.max(np.abs(got - want)))
    m_scale = float(np.max(want))
    print(f"[check] {label} marginal_sweep of {QUERY_PATTERNS} patterns "
          f"({'?' * QUERY_FIXED + '*' * (qubits - QUERY_FIXED)}): max|p - statevector| "
          f"{m_err:.3e} (gate 1e-4 x {m_scale:.3e}); dispatch {route}; amplitude_sweep of the "
          f"same patterns: dispatch {dict(rebind.DISPATCH)}, bitwise equal "
          f"{via_sweep.tobytes() == got.tobytes()}", flush=True)
    check(m_err <= 1e-4 * m_scale, f"{label}: a marginal is off by {m_err}")
    check(route == {"batched": 1} and same_route,
          f"{label}: marginal_sweep took {route}, amplitude_sweep {dict(rebind.DISPATCH)}")
    check(np.allclose(via_sweep, got, rtol=0, atol=1e-5 * m_scale),
          f"{label}: amplitude_sweep's marginals differ from marginal_sweep's")
    torch.cuda.empty_cache()

    # chain sampling, FP32 against complex128. A first pass plans the 20
    # structures and holds each distinct chain of the sandwich structures
    # (`?`*k + `o` + `*`*(19-k)) against its plain version; the same draws
    # are then timed, with each step's prefixes and conditionals kept.
    sampler = ChainSampler(sycamore(QUERY), backend=backend)
    sampler_rows: list = []
    print(f"[kernels] fused_chain against fused_chain_reference on the operands of "
          f"{label}'s ChainSampler (each distinct chain once)", flush=True)
    with holding("run_chain_split", hold_chain_run(lambda i: f"{label} sampler chain {i}",
                                                   1, sampler_rows, {}), split_complex):
        sampler.sample(QUERY_SAMPLES, seed=0)
    torch.cuda.empty_cache()
    steps: list = []
    real = sampler.conditionals

    def conditionals(prefixes, backend=None):
        out = real(prefixes, backend)
        steps.append((list(prefixes), out))
        return out

    sampler.conditionals = conditionals
    rebind.reset_dispatch()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    samples = sampler.sample(QUERY_SAMPLES, seed=0)
    sample_s = time.perf_counter() - t0
    sample_launches = LAUNCHES["fused_chain"]
    sample_peak = torch.cuda.max_memory_allocated()
    sample_route = dict(rebind.DISPATCH)
    check(len(steps) == qubits, f"{label}: the sampler walked {len(steps)} steps")
    check(sum(r["launches"] for r in sampler_rows) == sample_launches,
          f"{label}: {sum(r['launches'] for r in sampler_rows)} chain calls held for the "
          f"sampler's {sample_launches} launches")
    cond_err = 0.0
    p128_at = []  # position -> {prefix: complex128 probability of a 1}
    for prefixes, p32 in steps:
        p128 = ChainSampler.conditionals(sampler, prefixes, oracle)
        cond_err = max(cond_err, float(np.max(np.abs(p32 - p128))))
        p128_at.append({p: float(row[1]) for p, row in zip(prefixes, p128)})
    t0 = time.perf_counter()
    samples128 = ChainSampler(sycamore(QUERY), backend=oracle).sample(QUERY_SAMPLES, seed=0)
    sample128_s = time.perf_counter() - t0
    differ = sum(s != t for s, t in zip(samples, samples128))
    replayed, unexplained = sample_replay(samples, lambda k, p: p128_at[k][p],
                                          QUERY_SAMPLES, 0)
    print(f"[check] {label} ChainSampler.sample({QUERY_SAMPLES}, seed=0): {sample_s:.3f} s, "
          f"{sum(len(p) for p, _ in steps)} conditionals over {len(steps)} steps, dispatch "
          f"{sample_route}, fused_chain {sample_launches} launches, max_memory_allocated "
          f"{sample_peak} bytes; conditionals against complex128 max|diff| {cond_err:.3e} "
          f"(gate 1e-5); complex128 sampler {sample128_s:.3f} s; {differ} of "
          f"{QUERY_SAMPLES} samples differ ({replayed} by the draws replayed on its "
          f"conditionals), {unexplained} away from a threshold ({SAMPLE_NEAR}); "
          f"{len(sampler_rows)} distinct chains held", flush=True)
    check(cond_err <= 1e-5, f"{label}: a conditional is off complex128 by {cond_err}")
    check(replayed == differ, f"{label}: the replayed draws give {replayed} differing samples, "
                              f"the complex128 sampler {differ}")
    check(unexplained == 0, f"{label}: a sample differs from complex128's away from a threshold")
    return {"chain_rows": chain_rows + sampler_rows,
            "chain_launches": {f"{label} marginal_sweep": run["launches"]["fused_chain"],
                               f"{label} sample": sample_launches},
            "record": {
                "config": list(QUERY), "patterns": QUERY_PATTERNS, "fixed": QUERY_FIXED,
                "marginal_wall_s": run["walls"][0], "marginal_peak_bytes": run["peak_bytes"],
                "marginal_max_abs_err": m_err, "marginal_scale": m_scale,
                "marginal_dispatch": route, "marginal_launches": run["launches"],
                "sample_wall_s": sample_s, "sample_peak_bytes": sample_peak,
                "sample_dispatch": sample_route, "sample_launches": sample_launches,
                "conditionals": sum(len(p) for p, _ in steps),
                "conditional_max_abs_err": cond_err, "samples_differ": differ,
                "complex128_sample_wall_s": sample128_s}}


def median_run(run: dict) -> dict:
    """The medians of a :func:`run_counted` record's wall and elapsed
    seconds, beside its peak bytes."""
    return {"wall_s": statistics.median(run["walls"]),
            "elapsed_s": statistics.median(run["elapsed"]), "peak_bytes": run["peak_bytes"]}


def seeded_leaf(shape, rng) -> np.ndarray:
    """A seeded complex128 direction shaped like a leaf."""
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def maxcut_terms(qubits: int) -> list:
    """The MaxCut energy's Pauli terms on a line, ``E = Σ_edges 0.5·(1 -
    ⟨Z_u Z_v⟩) = 0.5·(qubits - 1) + Σ (-0.5)·⟨Z_u Z_v⟩``: the terms of the
    second sum."""
    return [(-0.5, "i" * u + "zz" + "i" * (qubits - u - 2)) for u in range(qubits - 1)]


def hold_value(label: str, got: complex, ref: complex) -> float:
    """Config #4's gates: within 1e-5 absolute (the observable's norm is 1)
    and 1e-3 relative of the complex128 value."""
    err = abs(got - ref)
    print(f"[check] {label} <Z...Z> {got.real:.10e} (complex128 {ref.real:.10e}): |diff| "
          f"{err:.3e} (gate 1e-5), relative {err / abs(ref):.3e} (gate 1e-3)", flush=True)
    check(err <= 1e-5, f"{label}: <Z...Z> off complex128 by {err}")
    check(err <= 1e-3 * abs(ref), f"{label}: <Z...Z> off complex128 by {err / abs(ref)} "
          f"relative")
    return err


def grad_qaoa() -> dict:
    """Phase 13 (a): BASELINE config #4 at full width.

    ⟨Z…Z⟩ of ``qaoa_circuit(30, 2, default_rng(42))`` through
    ``pauli_expectation(..., backend=TorchBackend())`` (split complex; its
    chains through ``fused_chain``, each distinct chain held against its
    plain version first), one warm-up and three timed runs, held within
    1e-5 absolute (the observable's norm is 1) and 1e-3 relative of the
    complex128 ``NumpyBackend`` value. Then the MaxCut energy:
    ``pauli_expectation_value_and_grad`` of its 29 terms on the card in
    complex64 over every gate leaf of both layers (timed beside the same
    forward alone, natively, and profiled once for the card's busy share), its value
    within 1e-5·29 of ``pauli_sum_expectation`` on the split path; the
    linearity oracle in complex128 on the card on ``GRAD_SLOTS`` seeded
    leaves; and d/dγ of round 1 by the chain rule over its rz leaves in
    both layers against a central difference of the complex128 energy."""
    import torch

    from tnc_tpu_torch.builders.qaoa_circuit import qaoa_circuit
    from tnc_tpu_torch.ops import split_complex
    from tnc_tpu_torch.ops.backends import NumpyBackend, TorchBackend
    from tnc_tpu_torch.ops.program import flat_leaf_tensors, step_flops
    from tnc_tpu_torch.queries import (
        bind_expectation,
        expectation,
        pauli_expectation,
        pauli_expectation_value_and_grad,
        pauli_sum_expectation,
    )
    from tnc_tpu_torch.tensornetwork.tensordata import TensorData

    qubits, rounds, seed = QAOA
    label = f"qaoa{qubits}_p{rounds}"
    zz = "z" * qubits

    def circuit():
        return qaoa_circuit(qubits, rounds, np.random.default_rng(seed))

    t0 = time.perf_counter()
    ref = pauli_expectation(circuit(), zz, backend=NumpyBackend())
    ref_s = time.perf_counter() - t0
    backend = TorchBackend()
    bound = bind_expectation(circuit())
    program = bound.bound.program
    policy = backend.kernel_policy(program)
    print(f"[{label}] <Z...Z> sandwich: {len(program.steps)} steps, "
          f"{sum(step_flops(st) for st in program.steps):.4e} multiply-adds, largest "
          f"intermediate {max(math.prod(st.out_store) for st in program.steps)} elements, "
          f"{len(policy.chains)} chains; complex128 NumpyBackend {ref.real:.10e} in "
          f"{ref_s:.3f} s", flush=True)
    check(policy.chains, f"{label}: the policy forms no chain")

    chain_rows: list = []
    print(f"[kernels] fused_chain against fused_chain_reference on the operands of {label}'s "
          f"<Z...Z> (each distinct chain once)", flush=True)
    with holding("run_chain_split", hold_chain_run(lambda i: f"{label} chain {i}", 1,
                                                   chain_rows, {}), split_complex):
        pauli_expectation(circuit(), zz, backend=backend)
    check(sum(r["launches"] for r in chain_rows) == len(policy.chains),
          f"{label}: {sum(r['launches'] for r in chain_rows)} chain calls held for "
          f"{len(policy.chains)} chains")
    expectation.reset_dispatch()
    run = run_counted(lambda: pauli_expectation(circuit(), zz, backend=backend), label)
    check(set(expectation.DISPATCH) == {"batched"}, f"{label}: dispatch {expectation.DISPATCH}")
    got = complex(run["out"])
    check(run["launches"]["fused_chain"] == len(policy.chains),
          f"{label}: fused_chain launched {run['launches']['fused_chain']} times for "
          f"{len(policy.chains)} chains")
    err = hold_value(f"{label} (dispatch {expectation.DISPATCH})", got, ref)
    torch.cuda.empty_cache()

    # the MaxCut energy and its gradient
    terms = maxcut_terms(qubits)
    const = 0.5 * len(terms)
    grad_run = run_counted(lambda: pauli_expectation_value_and_grad(circuit(), terms),
                           f"{label} energy value_and_grad")
    value, vals, grads = grad_run["out"]
    grad = median_run(grad_run)
    forward = median_run(run_counted(lambda: pauli_sum_expectation(
        circuit(), terms, backend=TorchBackend(split_complex=False)),
        f"{label} energy forward alone (native complex64)"))
    profiled = profile_device_path(
        lambda: pauli_expectation_value_and_grad(circuit(), terms),
        f"{label} energy value_and_grad", reps=1)
    busy = profiled["device_busy_s"] / profiled["profiled_s"]
    split_value = pauli_sum_expectation(circuit(), terms, backend=backend).real
    print(f"[check] {label} MaxCut energy {const + value:.10f} ({len(terms)} terms); split "
          f"path {const + split_value:.10f}, |diff| {abs(value - split_value):.3e} (gate "
          f"1e-5 x {len(terms)}); gradient over {len(grads)} gate leaves; wall gradient / "
          f"forward {grad['wall_s'] / forward['wall_s']:.3f}, elapsed (CUDA events) "
          f"{grad['elapsed_s'] / forward['elapsed_s']:.3f}; the card busy {busy:.4f} of the "
          f"profiled gradient ({sum(step_flops(st) for st in program.steps):.3e} "
          f"multiply-adds a term)", flush=True)
    check(abs(value - split_value) <= 1e-5 * len(terms),
          f"{label}: the gradient's value {value} differs from pauli_sum_expectation's "
          f"{split_value}")
    check(all(np.all(np.isfinite(g)) for g in grads), f"{label}: a non-finite cotangent")

    # the linearity oracle in complex128 on the card
    template = circuit().into_sandwich_template("p" * qubits)
    leaves = flat_leaf_tensors(template.network)
    n_circuit = len(circuit().tensor_network.tensors)
    wrt = [s for s in range(2 * n_circuit) if len(leaves[s].legs) > 1]
    check(len(wrt) == len(grads), f"{label}: {len(grads)} cotangents for {len(wrt)} leaves")
    oracle = TorchBackend(dtype="complex128", split_complex=False)
    arrays = bound.bound.arrays
    base = list(arrays)
    f128 = bound.pauli_sum(terms, oracle)[0].real
    rng = np.random.default_rng(GRAD_SEED)
    lin = []
    for k in sorted(rng.choice(len(wrt), GRAD_SLOTS, replace=False)):
        s = wrt[k]
        d = seeded_leaf(grads[k].shape, rng)
        arrays[s] = d
        f_d = bound.pauli_sum(terms, oracle)[0].real
        arrays[s] = base[s]
        pred = float(np.sum(grads[k] * d).real)
        lin.append({"slot": s, "grad": pred, "f": f_d, "err": abs(pred - f_d)})
    tol = 1e-4 * max(abs(f128), 1.0)
    lin_err = max(r["err"] for r in lin)
    print(f"[check] {label} linearity oracle on {GRAD_SLOTS} slots {[r['slot'] for r in lin]}: "
          f"max|Re(sum g*D) - f(leaf := D)| {lin_err:.3e} (gate {tol:.3e}); f complex128 "
          f"{f128:.10f}, complex64 {value:.10f}", flush=True)
    check(lin_err <= tol, f"{label}: a cotangent fails the linearity oracle by {lin_err}")

    # d/dgamma of round 1: its rz(2 gamma) leaves in both layers
    gamma = float(np.random.default_rng(seed).uniform(0, 2 * np.pi))
    edges = qubits - 1
    rz_slots = [2 * qubits + 3 * e + 1 for e in range(edges)]
    adj_slots = [n_circuit + s for s in rz_slots]

    def rz(g):
        return TensorData.gate("rz", (2.0 * g,)).into_data()

    def rz_adj(g):
        return TensorData.gate("rz", (2.0 * g,)).adjoint().into_data()

    check(all(np.array_equal(base[s], rz(gamma)) for s in rz_slots)
          and all(np.array_equal(base[s], rz_adj(gamma)) for s in adj_slots),
          f"{label}: the round-1 rz slots do not hold rz(2 gamma)")
    d_g = np.diag([-1j * np.exp(-1j * gamma), 1j * np.exp(1j * gamma)])
    slot_of = {s: i for i, s in enumerate(wrt)}
    dgamma = sum(float(np.sum(grads[slot_of[s]] * d_g).real) for s in rz_slots) + sum(
        float(np.sum(grads[slot_of[s]] * np.conj(d_g).T).real) for s in adj_slots)

    def energy(g):
        for s in rz_slots:
            arrays[s] = rz(g)
        for s in adj_slots:
            arrays[s] = rz_adj(g)
        return bound.pauli_sum(terms, oracle)[0].real

    fd = (energy(gamma + GRAD_EPS) - energy(gamma - GRAD_EPS)) / (2 * GRAD_EPS)
    arrays[:] = base
    tol_g = 1e-4 * max(abs(dgamma), 1.0)
    print(f"[check] {label} dE/dgamma (round 1, {2 * edges} rz leaves) {dgamma:.10f}, central "
          f"difference of complex128 (eps {GRAD_EPS}) {fd:.10f}, |diff| {abs(dgamma - fd):.3e} "
          f"(gate {tol_g:.3e})", flush=True)
    check(abs(dgamma - fd) <= tol_g, f"{label}: dE/dgamma off the central difference")
    del oracle
    torch.cuda.empty_cache()
    record = {
        "config": list(QAOA), "steps": len(program.steps), "chains": len(policy.chains),
        "zz": [got.real, got.imag], "zz_complex128": [ref.real, ref.imag], "zz_abs_err": err,
        "zz_rel_err": err / abs(ref), "zz_wall_s": statistics.median(run["walls"]),
        "zz_launches": run["launches"], "zz_peak_bytes": run["peak_bytes"],
        "energy": const + value, "energy_split": const + split_value,
        "grad_leaves": len(grads), "grad_wall_s": grad["wall_s"],
        "grad_elapsed_s": grad["elapsed_s"], "grad_peak_bytes": grad["peak_bytes"],
        "grad_busy_share": busy, "grad_profiled_s": profiled["profiled_s"],
        "forward_wall_s": forward["wall_s"], "forward_elapsed_s": forward["elapsed_s"],
        "forward_peak_bytes": forward["peak_bytes"],
        "linearity_max_err": lin_err, "linearity_tol": tol, "dgamma": dgamma,
        "dgamma_central_difference": fd,
    }
    return {"record": record, "chain_rows": chain_rows, "zz_complex128": ref.real,
            "chain_launches": run["launches"]["fused_chain"], "label": label}


def saved_bytes(program, elem_bytes: int = 8) -> int:
    """Bytes autograd keeps for a program: the prepared operands of every
    step (each product saves both), at ``elem_bytes`` an element."""
    return elem_bytes * sum(math.prod(st.a_view) + math.prod(st.b_view) for st in program.steps)


def grad_sliced() -> dict:
    """Phase 13 (b): the sliced gradient at real size.

    The raw amplitude network "0"x53 of ``sycamore_circuit(53, 8,
    default_rng(42))``, ``Greedy``, ``find_slicing`` to 2^26.15 (2^26.25 if the
    gradient would pass ``GRAD_SLICED_BUDGET_S`` at three times phase 11's
    fitted rate, ``FITTED_MADDS_PER_S``). ``sliced_contraction_value_and_grad`` on the card in
    complex64 over ``GRAD_SLOTS`` seeded gate leaves, timed beside the
    sliced forward alone (the native loop) and one slice's
    forward-with-grad run alone; its value within 1e-4·Σ_s|ref_s| of the
    complex128 slices on the card; each cotangent by the linearity oracle
    against the unsliced complex128 forward on the card; its peak within
    1.5x of one slice's forward-with-grad peak."""
    import torch

    from tnc_tpu_torch.contractionpath.slicing import find_slicing
    from tnc_tpu_torch.ops.autodiff import grad_of, leaf_tensors
    from tnc_tpu_torch.ops.autodiff import sliced_contraction_value_and_grad
    from tnc_tpu_torch.ops.backends import TorchBackend, _run_steps, resolve_device
    from tnc_tpu_torch.ops.program import build_program, flat_leaf_tensors, step_flops
    from tnc_tpu_torch.ops.sliced import _slice_indices, build_sliced_program, index_buffer

    qubits, depth, seed, target = GRAD_SLICED
    label = f"sycamore{qubits}_m{depth}_grad"
    tn, _ = sycamore((qubits, depth, seed)).into_amplitude_network("0" * qubits)
    path = plan(tn)
    program = build_program(tn, path)

    def sliced_plan(log2):
        slicing = find_slicing(tn.tensors, path.toplevel, float(2 ** log2))
        sp = build_sliced_program(tn, path, slicing)
        madds = sum(step_flops(st) for st in sp.program.steps) * slicing.num_slices
        return slicing, sp, madds

    slicing, sp, madds = sliced_plan(target)
    predicted = 3 * madds / FITTED_MADDS_PER_S
    fallback = predicted > GRAD_SLICED_BUDGET_S
    if fallback:
        print(f"[{label}] 2^{target}: {slicing.num_slices} slices, {madds:.4e} multiply-adds, "
              f"{predicted:.1f} s predicted for the gradient: over {GRAD_SLICED_BUDGET_S} s, "
              f"so 2^{GRAD_SLICED_FALLBACK}", flush=True)
        target = GRAD_SLICED_FALLBACK
        slicing, sp, madds = sliced_plan(target)
        predicted = 3 * madds / FITTED_MADDS_PER_S
    num = slicing.num_slices
    print(f"[{label}] raw network, Greedy: {len(program.steps)} steps; find_slicing to "
          f"2^{target}: {num} slices, {madds:.4e} sliced multiply-adds, gradient predicted "
          f"{predicted:.2f} s (3 x at {FITTED_MADDS_PER_S:.2e}/s); autograd keeps "
          f"{saved_bytes(sp.program)} bytes a slice, {saved_bytes(program)} unsliced "
          f"(complex64 prepared operands of every step)", flush=True)
    leaves = flat_leaf_tensors(tn)
    host = [leaf.data.into_data() for leaf in leaves]
    rng = np.random.default_rng(GRAD_SEED)
    gates = [s for s, leaf in enumerate(leaves) if len(leaf.legs) > 1]
    wrt = sorted(int(s) for s in rng.choice(gates, GRAD_SLOTS, replace=False))
    device = resolve_device()

    # the sliced forward alone: the native loop, the runner the gradient runs
    loop = TorchBackend(split_complex=False, sliced_strategy="loop", hoist=False)
    forward = median_run(run_counted(lambda: loop.execute_sliced(sp, host, graphs=False),
                                     f"{label} sliced forward alone (eager)", reps=1))

    # one slice's forward-with-grad, alone
    def one_slice():
        arrays = leaf_tensors(host, wrt, "complex64", device)
        idx = _slice_indices(sp.slicing, 0)
        with torch.enable_grad():
            c = _run_steps(sp.program, [index_buffer(a, info, idx)
                                        for a, info in zip(arrays, sp.slot_slices)])
            return grad_of(c, [arrays[s] for s in wrt], grad_outputs=torch.ones_like(c))

    one = median_run(run_counted(one_slice, f"{label} one slice's forward-with-grad", reps=1))
    one_wall, one_peak = one["wall_s"], one["peak_bytes"]
    grad_run = run_counted(lambda: sliced_contraction_value_and_grad(tn, path, slicing, wrt=wrt),
                           f"{label} value_and_grad", reps=1, warmup=lambda: None)
    value, grads = grad_run["out"]
    grad_wall, grad_elapsed, grad_peak = (grad_run["walls"][0], grad_run["elapsed"][0],
                                          grad_run["peak_bytes"])
    got = complex(np.asarray(value).reshape(()))
    print(f"[{label}] sliced_contraction_value_and_grad over {len(wrt)} leaves {wrt}: wall "
          f"{grad_wall:.4f} s, elapsed (CUDA events) {grad_elapsed:.4f} s, max_memory_allocated "
          f"{grad_peak} bytes; sliced forward alone wall {forward['wall_s']:.4f} s, peak "
          f"{forward['peak_bytes']} bytes (gradient / forward wall "
          f"{grad_wall / forward['wall_s']:.3f}); one slice's forward-with-grad alone wall "
          f"{one_wall:.4f} s, peak {one_peak} bytes (gradient peak / it "
          f"{grad_peak / one_peak:.4f}, gate 1.5)", flush=True)
    check(grad_peak <= 1.5 * one_peak,
          f"{label}: the gradient's peak {grad_peak} passes 1.5 x one slice's {one_peak}")

    # complex128 of every slice on the card
    oracle = TorchBackend(dtype="complex128", split_complex=False, sliced_strategy="loop",
                          hoist=False)
    t0 = time.perf_counter()
    refs = np.array([complex(np.asarray(oracle.execute_sliced(sp, host, slice_range=(s, s + 1)))
                             .reshape(())) for s in range(num)])
    refs_s = time.perf_counter() - t0
    ref = complex(refs.sum())
    scale = float(np.abs(refs).sum())
    err = abs(got - ref)
    print(f"[check] {label} amplitude {got:.6e} complex128 {ref:.6e}: |diff| {err:.3e} (gate "
          f"1e-4 x sum|slice| {scale:.3e}); complex128 slices in {refs_s:.2f} s", flush=True)
    check(err <= 1e-4 * scale, f"{label}: the sliced amplitude is off complex128 by {err}")

    # the linearity oracle against the unsliced complex128 forward
    unsliced = TorchBackend(dtype="complex128", split_complex=False)
    t0 = time.perf_counter()
    lin = []
    for s, g in zip(wrt, grads):
        d = seeded_leaf(g.shape, rng)
        d *= np.linalg.norm(host[s]) / np.linalg.norm(d)  # the leaf's own norm
        per = list(host)
        per[s] = d
        f_d = complex(np.asarray(unsliced.execute(program, per)).reshape(())).real
        pred = float(np.sum(g * d).real)
        lin.append({"slot": s, "grad": pred, "f": f_d, "err": abs(pred - f_d)})
    lin_s = time.perf_counter() - t0
    tol = 1e-4 * max(max(abs(r["f"]) for r in lin), scale)
    lin_err = max(r["err"] for r in lin)
    print(f"[check] {label} linearity oracle on {len(wrt)} slots (D of each leaf's norm): "
          f"max|Re(sum g*D) - f(leaf := D)| {lin_err:.3e} (gate 1e-4 x max(|f|, sum|slice|) "
          f"{tol:.3e}), relative to |f| {max(r['err'] / abs(r['f']) for r in lin):.3e}; "
          f"unsliced complex128 forwards in {lin_s:.2f} s", flush=True)
    check(lin_err <= tol, f"{label}: a cotangent fails the linearity oracle by {lin_err}")
    del oracle, unsliced
    torch.cuda.empty_cache()
    return {"record": {
        "config": list(GRAD_SLICED[:3]), "target_log2": target, "fallback": fallback,
        "slices": num, "sliced_multiply_adds": madds, "predicted_s": predicted,
        "saved_bytes_slice": saved_bytes(sp.program), "saved_bytes_unsliced": saved_bytes(program),
        "wrt": wrt, "grad_wall_s": grad_wall, "grad_elapsed_s": grad_elapsed,
        "grad_peak_bytes": grad_peak, "forward_wall_s": forward["wall_s"],
        "forward_elapsed_s": forward["elapsed_s"], "forward_peak_bytes": forward["peak_bytes"],
        "one_slice_wall_s": one_wall, "one_slice_peak_bytes": one_peak,
        "amplitude": [got.real, got.imag], "complex128": [ref.real, ref.imag],
        "abs_err": err, "sum_abs_slices": scale, "linearity_max_err": lin_err,
        "linearity_tol": tol}}


def grad_sweep() -> dict:
    """Phase 13 (c): ``amplitude_sweep_value_and_grad`` on
    ``sycamore_circuit(20, 8, default_rng(42))`` with ``GRAD_SWEEP_BITS``
    seeded bitstrings on the card in complex64, timed beside the forward
    sweep alone (natively); the amplitudes within 1e-4 max|ref| of
    complex128 on the card, and on ``GRAD_SLOTS`` seeded leaves the product
    rule ``Re(Σ g·D) = Σ_b 2·Re(conj(a_b)·a_b[s := D])`` in complex128, to
    1e-4 of the sum of the terms' moduli."""
    import torch

    from tnc_tpu_torch.ops.backends import TorchBackend
    from tnc_tpu_torch.tensornetwork.sweep import (
        _sweep_program,
        amplitude_sweep,
        amplitude_sweep_value_and_grad,
    )

    qubits, depth, seed = GRAD_SWEEP
    label = f"sycamore{qubits}_m{depth}_sweep_grad"
    rng = np.random.default_rng(GRAD_SEED)
    bits = ["".join(str(int(b)) for b in row)
            for row in rng.integers(0, 2, (GRAD_SWEEP_BITS, qubits))]
    grad_run = run_counted(lambda: amplitude_sweep_value_and_grad(sycamore(GRAD_SWEEP), bits),
                           f"{label} value_and_grad")
    amps, grads = grad_run["out"]
    grad = median_run(grad_run)
    forward = median_run(run_counted(lambda: amplitude_sweep(
        sycamore(GRAD_SWEEP), bits, backend=TorchBackend(split_complex=False)),
        f"{label} forward alone (native complex64)"))
    program, arrays, bras = _sweep_program(sycamore(GRAD_SWEEP), bits, None)
    oracle = TorchBackend(dtype="complex128", split_complex=False)
    ref = oracle.execute_batched(program, arrays, bras).reshape(len(bits))
    amp_err = float(np.max(np.abs(amps - ref)))
    amp_scale = float(np.max(np.abs(ref)))
    bra_set = set(bras)
    wrt = [s for s in range(len(arrays)) if s not in bra_set]
    check(len(wrt) == len(grads), f"{label}: {len(grads)} cotangents for {len(wrt)} leaves")
    rows = []
    for k in sorted(rng.choice(len(wrt), GRAD_SLOTS, replace=False)):
        s = wrt[k]
        d = seeded_leaf(grads[k].shape, rng)
        per = list(arrays)
        per[s] = d
        a_d = oracle.execute_batched(program, per, bras).reshape(len(bits))
        want = float(np.sum(2 * (np.conj(ref) * a_d).real))
        pred = float(np.sum(grads[k] * d).real)
        rows.append({"slot": s, "err": abs(pred - want),
                     "scale": float(np.sum(2 * np.abs(ref) * np.abs(a_d)))})
    worst = max(r["err"] / r["scale"] for r in rows)
    print(f"[check] {label}: {len(bits)} amplitudes, max|amp - complex128| {amp_err:.3e} (gate "
          f"1e-4 x {amp_scale:.3e}); product rule on {GRAD_SLOTS} slots "
          f"{[r['slot'] for r in rows]}: max |Re(sum g*D) - sum_b 2 Re(conj(a_b) a_b[s:=D])| "
          f"over sum_b 2|a_b||a_b[s:=D]| {worst:.3e} (gate 1e-4); wall gradient / forward "
          f"{grad['wall_s'] / forward['wall_s']:.3f}, elapsed (CUDA events) "
          f"{grad['elapsed_s'] / forward['elapsed_s']:.3f}", flush=True)
    check(amp_err <= 1e-4 * amp_scale, f"{label}: amplitudes off complex128 by {amp_err}")
    check(worst <= 1e-4, f"{label}: a cotangent fails the product rule by {worst} relative")
    del oracle
    torch.cuda.empty_cache()
    return {"record": {
        "config": list(GRAD_SWEEP), "bitstrings": len(bits), "leaves": len(grads),
        "grad_wall_s": grad["wall_s"], "grad_elapsed_s": grad["elapsed_s"],
        "grad_peak_bytes": grad["peak_bytes"], "forward_wall_s": forward["wall_s"],
        "forward_elapsed_s": forward["elapsed_s"], "forward_peak_bytes": forward["peak_bytes"],
        "amp_max_abs_err": amp_err, "product_rule_max_rel_err": worst}}


def traced_ladder(ladder, prog, label: str, **kw):
    """``ladder.run(prog, **kw)`` once through :func:`run_counted`, with the
    port's tracing on: the ladder's result and run record, and each rung's
    seconds from its ``approx.sweep`` span (host clock; the span closes once
    the value is on the host, and each ``approx.row`` inside it after a
    synchronise). Each rung's ``approx.row`` spans are held to the rung's
    ``sweep_cost`` rows at the sweep dtype's element width."""
    from tnc_tpu_torch import obs
    from tnc_tpu_torch.tensornetwork.approximate import elem_bytes

    was = obs.enabled()
    obs.configure(enabled=True)
    obs.reset()
    try:
        run = run_counted(lambda: ladder.run(prog, **kw), label, reps=1, warmup=lambda: None)
        records = obs.get_registry().span_records()
    finally:
        obs.configure(enabled=was)
        obs.reset()
    res = run["out"]
    sweeps = [r for r in records if r.name == "approx.sweep"]
    check(len(sweeps) == len(res.rungs),
          f"{label}: {len(sweeps)} approx.sweep spans for {len(res.rungs)} rungs")
    itemsize = elem_bytes(kw.get("backend", "torch"), kw.get("dtype", "complex64"))
    for rung in res.rungs:
        rows = [r for r in records if r.name == "approx.row" and r.args["chi"] == rung.chi]
        cost = prog.sweep_cost(rung.chi, itemsize)
        check([(r.args["flops"], r.args["bytes"]) for r in rows]
              == [(f, b) for f, b, _ in cost.rows[:-1]],
              f"{label}: chi {rung.chi}'s approx.row spans differ from its sweep_cost rows")
    return res, run, [r.dur_ns / 1e9 for r in sweeps]


def ladder_rows(label, res, times, ref=None) -> list:
    """Print and return one row per rung: chi, weight, err, seconds (its
    ``approx.sweep`` span), predicted ``rung_seconds`` and, with ``ref``,
    the distance to it."""
    rows = []
    for rung, sec in zip(res.rungs, times):
        row = {"chi": rung.chi, "value": [rung.value.real, rung.value.imag],
               "weight": rung.weight, "err": rung.err, "s": sec,
               "predicted_s": rung.predicted_s}
        if ref is not None:
            row["distance"] = abs(rung.value - ref)
        rows.append(row)
        pred = ("not predicted (no fitted model)" if rung.predicted_s is None
                else f"{rung.predicted_s:.4f} s")
        dist = "" if ref is None else f", |value - exact| {row['distance']:.3e}"
        print(f"  [{label}] chi {rung.chi}: value {rung.value:.10e}, weight {rung.weight:.3e}, "
              f"err {rung.err:.3e}{dist}; {sec:.4f} s (approx.sweep span), rung_seconds {pred}",
              flush=True)
    return rows


def run_approx(cost_model, qaoa_ref: float) -> dict:
    """Phase 13 (d): the approximate tier on the card, ``backend="torch"``.

    The QAOA ⟨Z…Z⟩ grid (``ApproxProgram.sandwich_from_circuit(...)
    .rebind_pauli``) up ``ChiLadder(chi_start=8, chi_cap=64)`` at ``rtol=1e-6,
    scale=1.0`` in complex128 (it must converge; every rung's err at least
    its distance from (a)'s complex128 value), then in complex64 on the
    top two of those rungs, half the chi at which complex128 converged and
    that chi (its floating-point floor, 1e-4 x max(|v|, scale), lies above
    that tolerance: reported, not converged). ``peps(6, 6, 2, 2, 1)`` (leaves at
    ``unit_scale``) in complex128 up
    (16 ... 512): the chi-512 rung truncation-free and within 1e-10 of the
    host's numpy sweep at chi 512, every lower rung's err at least its
    distance from it. ``peps(8, 8, 2, 2, 1)`` in complex64 up (16 ... 256),
    and its chi-``APPROX_PROFILE_CHI`` rung once under ``torch.profiler``
    for the card's busy share. Each ladder runs through
    :func:`traced_ladder`; every rung printed with its seconds and
    ``rung_seconds`` under phase 11's fitted model."""
    import torch

    from tnc_tpu_torch.approx import ApproxProgram, ChiLadder, exact_chi_bound
    from tnc_tpu_torch.builders.peps import peps
    from tnc_tpu_torch.builders.qaoa_circuit import qaoa_circuit
    from tnc_tpu_torch.tensornetwork.approximate import (
        EXACT_WEIGHT,
        attach_random_data,
        unit_scale,
    )

    qubits, rounds, seed = QAOA
    label = f"qaoa{qubits}_p{rounds} approx"
    prog = ApproxProgram.sandwich_from_circuit(
        qaoa_circuit(qubits, rounds, np.random.default_rng(seed))).rebind_pauli("z" * qubits)
    print(f"[{label}] grid {len(prog.grid)} x {len(prog.grid[0])}, exact chi bound "
          f"{exact_chi_bound(prog)}", flush=True)
    record: dict = {}
    # from chi 8: the chi-2 boundary of this grid keeps nothing of the value
    # (1e-125 against 1.17e-6), the chi-4 one misses it by 84% (9.8e-7), and
    # each costs a rung of ~5 s
    ladder = ChiLadder(chi_start=2 * APPROX_QAOA_START, chi_cap=APPROX_QAOA_CAP)
    for dtype in ("complex128", "complex64"):
        res, run, times = traced_ladder(
            ladder, prog, f"{label} {dtype} ladder", rtol=1e-6,
            scale=1.0, backend="torch", dtype=dtype, cost_model=cost_model)
        wall = run["walls"][0]
        rows = ladder_rows(f"{label} {dtype}", res, times, qaoa_ref)
        print(f"[check] {label} {dtype}: converged {res.converged} at chi {res.chi_used}, value "
              f"{res.value.real:.10e} (complex128 exact {qaoa_ref:.10e}), err {res.err:.3e}; "
              f"{len(res.rungs)} rungs in {wall:.3f} s", flush=True)
        check(all(r["err"] >= r["distance"] for r in rows),
              f"{label} {dtype}: a rung's err is below its distance from the exact value")
        if dtype == "complex128":
            check(res.converged, f"{label}: the complex128 ladder did not converge")
            # past its chi the complex64 rungs are truncation-free too; the rungs
            # below the top two repeat the complex128 ones at a coarser width
            ladder = ChiLadder(chis=(max(res.chi_used // 2, 1), res.chi_used))
        record[f"qaoa_{dtype}"] = {"converged": res.converged, "chi_used": res.chi_used,
                                   "value": res.value.real, "err": res.err, "wall_s": wall,
                                   "elapsed_s": run["elapsed"][0],
                                   "peak_bytes": run["peak_bytes"], "rungs": rows}
        torch.cuda.empty_cache()

    for length, chis, dtype in APPROX_PEPS:
        name = f"peps{length}{length}_b2 approx"
        tn = peps(length, length, 2, 2, 1)
        tn = attach_random_data(tn, np.random.default_rng(3), scale=unit_scale(tn))
        prog = ApproxProgram.from_peps_sandwich(tn, length, length, 1)
        # a tolerance no rung meets, so that every rung runs
        res, run, times = traced_ladder(
            ChiLadder(chis=chis), prog, f"{name} ladder", rtol=1e-12, backend="torch",
            dtype=dtype, cost_model=cost_model)
        wall = run["walls"][0]
        print(f"[{name}] grid {length} x {length}, exact chi bound {exact_chi_bound(prog)}, "
              f"{dtype}, {len(res.rungs)} rungs in {wall:.3f} s", flush=True)
        entry = {"dtype": dtype, "exact_chi_bound": exact_chi_bound(prog), "wall_s": wall,
                 "elapsed_s": run["elapsed"][0], "peak_bytes": run["peak_bytes"]}
        if dtype == "complex128":
            top = res.rungs[-1]
            rows = ladder_rows(name, res, times, top.value)
            t0 = time.perf_counter()
            host, host_w = prog.contract(top.chi, backend="numpy")
            host_s = time.perf_counter() - t0
            rel = abs(top.value - host) / abs(host)
            print(f"[check] {name}: chi {top.chi} weight {top.weight:.3e} (exact at "
                  f"<= {EXACT_WEIGHT}); against the numpy host sweep at chi {top.chi} "
                  f"({host_s:.2f} s, weight {host_w:.3e}): relative {rel:.3e} (gate 1e-10)",
                  flush=True)
            check(top.weight <= EXACT_WEIGHT, f"{name}: the chi-{top.chi} rung truncated")
            check(rel <= 1e-10, f"{name}: the card's chi-{top.chi} rung is off the host by {rel}")
            check(all(r["err"] >= r["distance"] for r in rows[:-1]),
                  f"{name}: a rung's err is below its distance from the exact rung")
            entry.update(host_s=host_s, host_rel_err=rel)
        else:
            rows = ladder_rows(name, res, times)
            check(all(np.isfinite(r["value"][0]) for r in rows), f"{name}: a non-finite rung")
            profiled = profile_device_path(
                lambda: prog.contract(APPROX_PROFILE_CHI, dtype=dtype),
                f"{name} chi {APPROX_PROFILE_CHI}", reps=1)
            entry["profile"] = {"chi": APPROX_PROFILE_CHI, **profiled,
                                "busy_share": profiled["device_busy_s"] / profiled["profiled_s"]}
        entry["rungs"] = rows
        record[name] = entry
        torch.cuda.empty_cache()
    return {"record": record}


def run_grad(cost_model=None) -> dict:
    """Phase 13: gradients and the approximate tier (:func:`grad_qaoa`,
    :func:`grad_sliced`, :func:`grad_sweep`, :func:`run_approx`)."""
    t0 = time.perf_counter()
    qaoa = grad_qaoa()
    sliced = grad_sliced()
    sweep = grad_sweep()
    approx = run_approx(cost_model, qaoa["zz_complex128"])
    seconds = time.perf_counter() - t0
    print(f"[grad] phase 13 in {seconds:.1f} s", flush=True)
    return {"record": {"qaoa": qaoa["record"], "sliced": sliced["record"],
                       "sweep": sweep["record"], "approx": approx["record"],
                       "seconds": seconds},
            "chain_rows": qaoa["chain_rows"], "label": qaoa["label"],
            "chain_launches": qaoa["chain_launches"]}


# --- phase 14: the serving front end and resilience -------------------------


def obs_window():
    """A context manager: the port's tracing on with a fresh registry, its
    resilience counters read back through ``obs.counters_by_prefix``; the
    previous state restored on exit."""
    from tnc_tpu_torch import obs
    from tnc_tpu_torch.obs import core

    @contextlib.contextmanager
    def window():
        saved = (core._ENABLED, core._REGISTRY)
        obs.configure(enabled=True, registry=core.MetricsRegistry())
        try:
            yield obs
        finally:
            core._ENABLED, core._REGISTRY = saved

    return window()


def held_chains(label: str, rows: list, seen: dict, launches: int):
    """:func:`holding` of ``split_complex.run_chain_split`` through
    :func:`hold_chain_run` with ``seen``: each distinct chain the port runs
    meanwhile held against its plain version once (its row labelled
    ``"<label> chain <i>"``), and every call adding ``launches`` to its
    row. A service's dispatcher thread runs the holds: no other thread
    touches the card while they synchronise and capture. A warm-up held
    with ``launches=0`` before a counted run held with 1 (phase 14's
    serving cell, phase 18's ranks) makes the rows weigh exactly the
    counted run's launches (:func:`check_held`)."""
    from tnc_tpu_torch.ops import split_complex

    return holding("run_chain_split", hold_chain_run(lambda i: f"{label} chain {i}",
                                                     launches, rows, seen), split_complex)


def check_held(label: str, rows: list, launches: int, before: int = 0) -> None:
    """The launches ``rows`` counted since they summed to ``before`` equal
    the ``launches`` the path made: every ``fused_chain`` launch of the run
    was on a chain held against its plain version."""
    held = sum(r["launches"] for r in rows) - before
    check(held == launches > 0,
          f"{label}: {held} fused_chain launches on held chains, the path made {launches}")


def serve_rows(seed: int = SWEEP_BITS_SEED) -> list[str]:
    """The ``SERVE_ROUNDS * (SERVE_BATCH - 1)`` distinct bitstrings phase 14
    serves: rows of ``default_rng(seed)``."""
    rows = np.random.default_rng(seed).integers(
        0, 2, (SERVE_ROUNDS * (SERVE_BATCH - 1), SWEEP[0]))
    return ["".join(str(int(b)) for b in r) for r in rows]


def submit_round(svc, requests: list, threads: int = 4) -> list:
    """Submit one round of requests (callables ``svc -> future``) from
    ``threads`` threads released together by a barrier, each taking a
    contiguous share in order, and wait for every answer. Returns the
    answers, or the exceptions raised, in request order. No thread but the
    service's dispatcher touches the card meanwhile."""
    import threading

    futures = [None] * len(requests)
    barrier = threading.Barrier(threads)
    share = -(-len(requests) // threads)

    def submit(k):
        barrier.wait(timeout=60)
        for i in range(k * share, min((k + 1) * share, len(requests))):
            futures[i] = requests[i](svc)

    workers = [threading.Thread(target=submit, args=(k,)) for k in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=120)
    out = []
    for f in futures:
        try:
            out.append(f.result(timeout=600))
        except Exception as e:  # noqa: BLE001 - the caller checks each outcome
            out.append(e)
    return out


def round_bits(rows: list[str], r: int) -> list[str]:
    """Round ``r`` of phase 14's Sycamore-53 traffic: its ``SERVE_BATCH - 1``
    distinct bitstrings of ``rows`` and a repeat of the first beside it."""
    unique = rows[r * (SERVE_BATCH - 1):(r + 1) * (SERVE_BATCH - 1)]
    return [unique[0]] + unique


def hold_amps(label: str, got, bits, refs: dict, tol: float = 1e-4) -> float:
    """Each amplitude of ``bits`` against its complex128 reference within
    ``tol`` max|ref| (phase 12's gate 1e-4 by default); returns
    max|amp - ref|."""
    want = np.array([refs[b] for b in bits])
    got = np.asarray(got, dtype=np.complex128)
    check(got.shape == want.shape and np.all(np.isfinite(got)),
          f"{label}: answers of shape {got.shape} or non-finite")
    err = float(np.max(np.abs(got - want)))
    scale = float(np.max(np.abs(want)))
    check(err <= tol * scale, f"{label}: an amplitude is off complex128 by {err} "
                              f"(gate {tol:g} x {scale})")
    return err


def complex128_amps(bound, bits: list[str], batch: int = 2) -> dict:
    """The complex128 amplitude of every bitstring on the card
    (``TorchBackend(dtype="complex128", split_complex=False)``, ``batch``
    bitstrings a call through ``bound``'s program)."""
    import torch

    from tnc_tpu_torch.ops.backends import TorchBackend

    oracle = TorchBackend(dtype="complex128", split_complex=False)
    refs = {}
    for i in range(0, len(bits), batch):
        chunk = bits[i:i + batch]
        for b, a in zip(chunk, bound.amplitudes(chunk, oracle)):
            refs[b] = complex(a)
    torch.cuda.empty_cache()
    return refs


def run_serve_sycamore(rows: list[str]) -> dict:
    """Phase 14 (a): ``sycamore53_m8_serve`` and ``sycamore53_m8_serve_reuse``.

    The service over ``sycamore_circuit(53, 8, rng 42)``'s amplitude
    template on one ``TorchBackend()``, a plan cache in a temporary
    directory, ``max_batch=8``, ``max_wait_ms=20``: a warm-up round that
    holds each distinct chain against its plain version, then
    ``SERVE_ROUNDS`` counted rounds of 8 requests from 4 threads (7 distinct
    bitstrings and one repeat a round: 40 requests, 5 repeats, each
    collapsed by the dispatcher's dedup), every launch on a held chain;
    every answer within 1e-4 max|ref| of complex128 on the card;
    latency percentiles, batches, peak memory against phase 12's. Then a
    deadline of 0 (``DeadlineExceededError``), a transient
    ``serve.dispatch`` fault retried in place, a fatal one degrading a
    batch of 8 to singletons (each within the gate), a transient
    ``backend.dispatch`` fault retried once; a ``max_queue=2`` service
    rejecting a third request with ``QueueFullError``; a second
    ``from_circuit`` over the same cache directory that hits it and calls
    no planner. Then the same service with an ``IntermediateStore`` (a
    warm-up service over a store of its own holding the chains first): the
    residual's steps against the program's, the cached inputs' bytes and
    their upload seconds, the store's counts after two batches, answers
    within the gate. Only the dispatcher thread touches the card while a
    service runs; the references are made after it stops."""
    import tempfile

    import torch

    from tnc_tpu_torch.ops.backends import TorchBackend, place_buffers
    from tnc_tpu_torch.ops.cuda_complex import LAUNCHES, reset_launches
    from tnc_tpu_torch.resilience import faults
    from tnc_tpu_torch.serve import (
        ContractionService,
        DeadlineExceededError,
        IntermediateStore,
        PlanCache,
        QueueFullError,
        rebind,
    )

    qubits, depth, _ = SWEEP
    label = f"sycamore{qubits}_m{depth}_serve"
    planned = []
    real_plan = rebind.plan_structure

    def counted_plan(*a, **k):
        planned.append(1)
        return real_plan(*a, **k)

    rebind.plan_structure = counted_plan
    record: dict = {}
    launches: dict = {}
    with tempfile.TemporaryDirectory() as cache_dir:
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            svc = ContractionService.from_circuit(
                sycamore(SWEEP), backend=TorchBackend(), plan_cache=PlanCache(cache_dir),
                max_batch=SERVE_BATCH, max_wait_ms=20)
            cold_s = time.perf_counter() - t0
            cold_planned = len(planned)
            answers, served = [], []
            held, seen = [], {}
            try:
                # a warm-up round holds each distinct chain; then the counted rounds
                with held_chains(label, held, seen, 0):
                    warmup = submit_round(svc, [lambda s, b=b: s.submit(b)
                                                for b in round_bits(rows, 0)])
                svc.reset_stats()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launches()
                t0 = time.perf_counter()
                with held_chains(label, held, seen, 1):
                    for r in range(SERVE_ROUNDS):
                        bits = round_bits(rows, r)
                        answers += submit_round(svc, [lambda s, b=b: s.submit(b) for b in bits])
                        served += bits
                traffic_s = time.perf_counter() - t0
                stats = svc.stats()
                peak = torch.cuda.max_memory_allocated()
                launches[label] = LAUNCHES["fused_chain"]
                check_held(label, held, launches[label])
                check(not any(isinstance(a, Exception) for a in answers),
                      f"{label}: a request failed: {[a for a in answers if isinstance(a, Exception)][:1]}")
                check(stats["counts"]["deduped"] == SERVE_ROUNDS,
                      f"{label}: deduped {stats['counts']['deduped']}, expected {SERVE_ROUNDS}")
                # a deadline of 0 expires in the queue
                late = svc.submit(rows[0], timeout_s=0.0)
                try:
                    late.result(timeout=600)
                    expired = False
                except DeadlineExceededError:
                    expired = True
                check(expired, f"{label}: a request with timeout 0 was answered")
                faulted = {}
                distinct = rows[:SERVE_BATCH]
                jobs = [lambda s, b=b: s.submit(b) for b in distinct]
                with obs_window() as obs:
                    before = dict(svc.stats()["counts"])
                    with faults("serve.dispatch=transient*1"):
                        faulted["serve transient"] = submit_round(svc, jobs)
                    after = svc.stats()["counts"]
                    serve_retries = obs.counters_by_prefix("resilience.retry.attempts")
                    check(after["degraded_batches"] == before["degraded_batches"]
                          and serve_retries == {"resilience.retry.attempts{site=serve.dispatch}": 1.0},
                          f"{label}: the transient serve.dispatch fault was not retried in place "
                          f"({serve_retries}, {after})")
                with faults(f"serve.dispatch(batch={SERVE_BATCH})=fatal*1"):
                    faulted["serve fatal"] = submit_round(svc, jobs)
                degraded = svc.stats()["counts"]["degraded_batches"] - before["degraded_batches"]
                check(degraded == 1, f"{label}: {degraded} batches degraded, expected 1")
                with obs_window() as obs:
                    with faults("backend.dispatch=transient*1"):
                        faulted["backend transient"] = submit_round(svc, jobs)
                    backend_retries = obs.counters_by_prefix("resilience.retry.attempts")
                check(backend_retries == {"resilience.retry.attempts{site=backend.dispatch}": 1.0},
                      f"{label}: backend.dispatch retries {backend_retries}")
                final = svc.stats()
            finally:
                svc.stop()
            check(final["counts"]["failed"] == 0, f"{label}: {final['counts']['failed']} failed")
            # admission control on a second service over the warm program
            small = ContractionService(svc.bound, backend=svc.backend, max_queue=2,
                                       max_batch=1, max_wait_ms=0)
            with small:
                with faults("serve.dispatch=slow:0.5*1"):
                    first = small.submit(rows[0])
                    time.sleep(0.2)
                    queued = [small.submit(rows[1]), small.submit(rows[2])]
                    try:
                        small.submit(rows[3])
                        rejected = False
                    except QueueFullError:
                        rejected = True
                    admitted = [f.result(timeout=600) for f in [first] + queued]
            check(rejected, f"{label}: a max_queue=2 service admitted a third request")
            # the warm service: the same cache directory, no planner
            t0 = time.perf_counter()
            warm = ContractionService.from_circuit(
                sycamore(SWEEP), backend=svc.backend, plan_cache=PlanCache(cache_dir),
                max_batch=SERVE_BATCH, max_wait_ms=20)
            warm_s = time.perf_counter() - t0
            warm_planned = len(planned) - cold_planned
            warm_cache = warm.stats()["plan_cache"]["counts"]
            warm.stop()
            check(warm_planned == 0 and warm_cache["hit"] == 1,
                  f"{label}: the warm service planned {warm_planned} times, cache {warm_cache}")

            # the reuse cell: the same service over an IntermediateStore. A
            # warm-up service over a store of its own holds each distinct
            # chain (the store's materializations and the residual's), then
            # a fresh one is counted
            def reuse_service():
                return ContractionService.from_circuit(
                    sycamore(SWEEP), backend=TorchBackend(), plan_cache=PlanCache(cache_dir),
                    reuse_store=IntermediateStore(), max_batch=SERVE_BATCH, max_wait_ms=20)

            reuse_held, reuse_seen = [], {}
            with held_chains(f"{label}_reuse", reuse_held, reuse_seen, 0):
                with reuse_service() as warm_reuse:
                    submit_round(warm_reuse, [lambda s, b=b: s.submit(b)
                                              for b in rows[:SERVE_BATCH]])
            torch.cuda.empty_cache()
            reset_launches()
            with held_chains(f"{label}_reuse", reuse_held, reuse_seen, 1):
                t0 = time.perf_counter()
                reuse = reuse_service()
                reuse_bind_s = time.perf_counter() - t0
                try:
                    reuse_answers = []
                    round_s = []
                    for r in range(2):
                        bits = rows[r * SERVE_BATCH:(r + 1) * SERVE_BATCH]
                        t0 = time.perf_counter()
                        reuse_answers += submit_round(reuse, [lambda s, b=b: s.submit(b)
                                                              for b in bits])
                        round_s.append(time.perf_counter() - t0)
                    reuse_stats = reuse.stats()
                finally:
                    reuse.stop()
            launches[f"{label}_reuse"] = LAUNCHES["fused_chain"]
            check_held(f"{label}_reuse", reuse_held, launches[f"{label}_reuse"])
        finally:
            rebind.plan_structure = real_plan
    check(not any(isinstance(a, Exception) for a in reuse_answers),
          f"{label}_reuse: a request failed")

    # the references, every service stopped
    refs = complex128_amps(svc.bound, rows)
    err = hold_amps(label, answers, served, refs)
    hold_amps(f"{label} warm-up", warmup, round_bits(rows, 0), refs)
    fault_errs = {name: hold_amps(f"{label} {name}", got, rows[:SERVE_BATCH], refs)
                  for name, got in faulted.items()}
    hold_amps(f"{label} max_queue=2", admitted, rows[:3], refs)
    reuse_err = hold_amps(f"{label}_reuse", reuse_answers, rows[:2 * SERVE_BATCH], refs)

    bound = reuse.bound
    split = bound.reuse.split
    cached = [a for (kind, _), a in zip(split.sources, bound.reuse.arrays_for(reuse.backend))
              if kind == "cached"]
    cached_bytes = int(sum(np.asarray(a).nbytes for a in cached))
    upload_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        place_buffers(cached, reuse.backend.dtype, reuse.backend.split_complex,
                      reuse.backend.device)
        torch.cuda.synchronize()
        upload_s.append(time.perf_counter() - t0)
    lat = stats["latency_s"]
    print(f"[{label}] cold from_circuit {cold_s:.3f} s ({cold_planned} plan), warm "
          f"{warm_s:.3f} s ({warm_planned} plans, cache {warm_cache}); {len(served)} requests "
          f"in {SERVE_ROUNDS} rounds from 4 threads in {traffic_s:.3f} s: "
          f"{stats['counts']['batches']} batches (sizes {stats['batch_size']}), deduped "
          f"{stats['counts']['deduped']}; latency p50 {lat['p50']:.4f} p90 {lat['p90']:.4f} "
          f"p99 {lat['p99']:.4f} max {lat['max']:.4f} s; max_memory_allocated {peak} bytes "
          f"(phase 12's sweep of 8: 43.15 GB); fused_chain {launches[label]} launches; "
          f"max|amp - complex128| {err:.3e}", flush=True)
    print(f"[{label} resilience] deadline 0 expired {expired}; serve.dispatch transient "
          f"retried in place {serve_retries}; fatal degraded {degraded} batch of "
          f"{SERVE_BATCH} to singletons; backend.dispatch transient {backend_retries}; "
          f"max_queue=2 rejected the third {rejected}; answers off complex128 by "
          f"{fault_errs}; final counts {final['counts']}", flush=True)
    print(f"[{label}_reuse] from_circuit {reuse_bind_s:.3f} s; residual {len(bound.program.steps)} "
          f"steps of the program's {len(split.steps)} ({len(split.cached_idx)} cached inputs, "
          f"{cached_bytes} bytes, uploaded in {[round(s, 6) for s in upload_s]} s a dispatch); "
          f"rounds {[round(s, 3) for s in round_s]} s (the first materializes); store after two "
          f"batches {reuse_stats['reuse']}; fused_chain {launches[f'{label}_reuse']} launches; "
          f"max|amp - complex128| {reuse_err:.3e}", flush=True)
    record.update({
        label: {"requests": len(served), "distinct": len(set(served)),
                "cold_from_circuit_s": cold_s, "warm_from_circuit_s": warm_s,
                "cold_plans": cold_planned, "warm_plans": warm_planned,
                "warm_cache": warm_cache, "traffic_s": traffic_s,
                "counts": stats["counts"], "batch_size": stats["batch_size"],
                "latency_s": lat, "peak_bytes": peak, "fused_chain_launches": launches[label],
                "max_abs_err": err, "expired": expired, "serve_retries": serve_retries,
                "degraded": degraded, "backend_retries": backend_retries,
                "rejected": rejected, "fault_max_abs_err": fault_errs,
                "final_counts": final["counts"]},
        f"{label}_reuse": {"residual_steps": len(bound.program.steps),
                           "program_steps": len(split.steps),
                           "cached_inputs": len(split.cached_idx), "cached_bytes": cached_bytes,
                           "upload_s": upload_s, "round_s": round_s,
                           "from_circuit_s": reuse_bind_s, "store": reuse_stats["reuse"],
                           "fused_chain_launches": launches[f"{label}_reuse"],
                           "max_abs_err": reuse_err},
    })
    return {"record": record, "launches": launches, "refs": refs,
            "chain_rows": {label: held, f"{label}_reuse": reuse_held}}


def run_sliced_ckpt(rows: list[str], refs: dict) -> dict:
    """Phase 14 (b): ``sycamore53_m8_sliced_ckpt``. The sliced serving
    branch, ``bind_circuit(sycamore_circuit(53, 8, rng 42),
    target_size=2**CKPT_TARGET)`` (128 slices; phase 12's 2^26 gives 4,
    too few for the cursors below), two bitstrings through the default
    chunked path (batch 8, graphed) of one ``TorchBackend()``, with
    ``TNC_TPU_CKPT`` a temporary directory and ``TNC_TPU_CKPT_EVERY=8``:
    (a) uninterrupted; (b) a fatal ``chunked.batch(start=64)`` fault raises,
    the checkpoint on disk holds cursor 64, the call made again resumes
    there and equals (a) bitwise; (c) an ``oom`` at the batch starting at
    slice 32 halves the batch to 4 (``resilience.degrade.batch_shrink``),
    the result within the gate of (a); (d) a transient fault inside a CUDA
    graph capture (``graphs.capture``) ends the capture and the batch runs
    again, bitwise (a). No stream is left capturing. (a) and (c) run again
    eagerly (``graphs=False``, bitwise theirs) with every chain held
    against its plain version: the launches held equal the graphed runs'
    launches, which the ``kernels`` line counts."""
    import glob
    import tempfile

    import torch

    from tnc_tpu_torch.ops import graphs
    from tnc_tpu_torch.ops.backends import TorchBackend
    from tnc_tpu_torch.ops.cuda_complex import LAUNCHES, reset_launches
    from tnc_tpu_torch.resilience import faults
    from tnc_tpu_torch.resilience.faultinject import InjectedFatal
    from tnc_tpu_torch.serve import bind_circuit

    qubits, depth, _ = SWEEP
    label = f"sycamore{qubits}_m{depth}_sliced_ckpt"
    bits = rows[:2]
    t0 = time.perf_counter()
    bound = bind_circuit(sycamore(SWEEP), "0" * qubits, target_size=2.0 ** CKPT_TARGET)
    plan_s = time.perf_counter() - t0
    slices = bound.sliced.slicing.num_slices
    check(slices >= 128, f"{label}: {slices} slices, the checks need 128")
    backend = TorchBackend()
    # the same calls run eagerly (graphs=False: the same bits) with every
    # chain held against its plain version; a replayed graph calls no Python
    eager = TorchBackend()
    eager.execute_sliced = functools.partial(eager.execute_sliced, graphs=False)
    held, seen = [], {}
    reset_launches()
    graphs.reset_stats()
    t0 = time.perf_counter()
    clean = bound.amplitudes(bits, backend)
    clean_s = time.perf_counter() - t0
    clean_launches = LAUNCHES["fused_chain"]
    clean_graphs = dict(graphs.STATS)
    err = hold_amps(label, clean, bits, refs)
    with held_chains(label, held, seen, 1):
        clean_eager = bound.amplitudes(bits, eager)
    check_held(label, held, clean_launches)
    check(clean_eager.tobytes() == clean.tobytes(), f"{label}: the eager run differs from the "
                                                    f"graphed run's bits")
    with tempfile.TemporaryDirectory() as ckpt_dir:
        os.environ["TNC_TPU_CKPT"] = ckpt_dir
        os.environ["TNC_TPU_CKPT_EVERY"] = "8"
        try:
            raised = False
            with faults("chunked.batch(start=64)=fatal*1"):
                try:
                    bound.amplitudes(bits, backend)
                except InjectedFatal:
                    raised = True
            check(raised, f"{label}: the chunked.batch(start=64) fault did not raise")
            check(not torch.cuda.is_current_stream_capturing(),
                  f"{label}: a stream is left capturing")
            files = glob.glob(os.path.join(ckpt_dir, "*.npz"))
            check(len(files) == 1, f"{label}: {len(files)} checkpoint files")
            with np.load(files[0]) as z:
                cursor = json.loads(str(z["meta"]))["cursor"]
            with obs_window() as obs:
                t0 = time.perf_counter()
                resumed = bound.amplitudes(bits, backend)
                resume_s = time.perf_counter() - t0
                ckpt_counts = obs.counters_by_prefix("resilience.ckpt")
            left = glob.glob(os.path.join(ckpt_dir, "*.npz"))
            reset_launches()
            with obs_window() as obs:
                with faults("chunked.batch(start=32)=oom*1"):
                    halved = bound.amplitudes(bits, backend)
                shrink = obs.counters_by_prefix("resilience.degrade")
                shrunk_to = obs.get_registry().gauges().get(("resilience.degrade.batch", ()))
            halved_launches = LAUNCHES["fused_chain"]
            before = sum(r["launches"] for r in held)
            with held_chains(label, held, seen, 1), faults("chunked.batch(start=32)=oom*1"):
                halved_eager = bound.amplitudes(bits, eager)
            check_held(f"{label} halved", held, halved_launches, before)
            with obs_window() as obs:
                with faults("graphs.capture=transient*1"):
                    recaptured = bound.amplitudes(bits, backend)
                capture_retries = obs.counters_by_prefix("resilience.retry.attempts")
        finally:
            del os.environ["TNC_TPU_CKPT"], os.environ["TNC_TPU_CKPT_EVERY"]
    check(not torch.cuda.is_current_stream_capturing(), f"{label}: a stream is left capturing")
    bitwise = resumed.tobytes() == clean.tobytes()
    check(cursor == 64, f"{label}: the checkpoint holds cursor {cursor}, not 64")
    check(bitwise, f"{label}: the resumed run differs from the uninterrupted run's bits")
    check(not left, f"{label}: the finished run left {left}")
    check(ckpt_counts.get("resilience.ckpt.resumed") == 1.0,
          f"{label}: checkpoint counters {ckpt_counts}")
    check(shrink == {"resilience.degrade.batch_shrink": 1.0} and shrunk_to == 4.0,
          f"{label}: the injected oom gave {shrink}, batch {shrunk_to}")
    scale = float(np.max(np.abs(clean)))
    halved_err = float(np.max(np.abs(halved - clean)))
    check(halved_err <= 1e-4 * scale, f"{label}: the halved batch is off (a) by {halved_err}")
    check(halved_eager.tobytes() == halved.tobytes(),
          f"{label}: the eager halved run differs from the graphed one's bits")
    check(recaptured.tobytes() == clean.tobytes()
          and capture_retries == {"resilience.retry.attempts{site=chunked.batch}": 1.0},
          f"{label}: the capture fault gave {capture_retries}, bits equal "
          f"{recaptured.tobytes() == clean.tobytes()}")
    print(f"[{label}] target 2^{CKPT_TARGET}: {slices} slices planned in {plan_s:.3f} s; (a) "
          f"{len(bits)} bitstrings in {clean_s:.3f} s, fused_chain {clean_launches} launches, "
          f"graphs {clean_graphs}, max|amp - complex128| {err:.3e}; (b) the fault at start=64 "
          f"raised, checkpoint cursor {cursor}, resumed in {resume_s:.3f} s bitwise equal "
          f"{bitwise}, {ckpt_counts}; (c) oom at start=32: {shrink}, batch {shrunk_to}, "
          f"|halved - (a)| {halved_err:.3e}, fused_chain {halved_launches} launches; (d) a "
          f"capture fault retried {capture_retries}, bitwise equal True; (a) and (c) again "
          f"eagerly, bitwise equal, {len(held)} distinct chains held", flush=True)
    return {"launches": clean_launches + halved_launches, "chain_rows": held, "clean": clean,
            "record": {
        "target_log2": CKPT_TARGET, "slices": slices, "plan_s": plan_s, "wall_s": clean_s,
        "fused_chain_launches": clean_launches, "halved_fused_chain_launches": halved_launches,
        "graphs": clean_graphs, "max_abs_err": err,
        "cursor": cursor, "resume_s": resume_s, "resumed_bitwise": bitwise,
        "ckpt_counters": ckpt_counts, "batch_shrink": shrink, "shrunk_to": shrunk_to,
        "halved_max_abs_err": halved_err, "capture_retries": capture_retries}}


def run_serve_mixed() -> dict:
    """Phase 14 (c): ``sycamore20_m8_mixed``. ``from_circuit(sycamore_circuit(
    20, 8, rng 42), queries=True)`` on one ``TorchBackend()``
    (``max_batch=16``, ``max_wait_ms=20``): from 4 threads, 16 amplitudes,
    8 marginals, 8 ``submit_sample(8, seed=k)`` and 8 two-term Pauli sums,
    interleaved. Amplitudes within 1e-4 max|ref| and marginals within 1e-4
    max p of the complex128 statevector; samples those of the complex128
    conditionals unless a uniform lies within ``SAMPLE_NEAR`` of its
    threshold; each expectation within 1e-5 absolute (and 1e-3 relative
    where |ref| > 1e-2) of the statevector's. Every dispatched batch holds
    one batching key; ``stats()["by_type"]`` printed. One pass: each
    distinct chain is held against its plain version when it first runs
    (its hold inside the pass's time), and the pass's launches must all
    fall on held chains."""
    from tnc_tpu_torch.ops.backends import TorchBackend
    from tnc_tpu_torch.ops.cuda_complex import LAUNCHES, reset_launches
    from tnc_tpu_torch.queries import statevector as sv_oracle
    from tnc_tpu_torch.serve import ContractionService

    qubits, depth, _ = QUERY
    label = f"sycamore{qubits}_m{depth}_mixed"
    rng = np.random.default_rng(17)
    amp_bits = ["".join(str(int(b)) for b in r) for r in rng.integers(0, 2, (16, qubits))]
    patterns = ["".join(str(int(b)) for b in r) + "*" * (qubits - QUERY_FIXED)
                for r in rng.integers(0, 2, (8, QUERY_FIXED))]
    paulis = ["".join("ixyz"[int(c)] for c in r) for r in rng.integers(0, 4, (16, qubits))]
    sums = [[(1.0, "z" * (k + 1) + "i" * (qubits - k - 1)), (0.5, paulis[k])] for k in range(8)]
    jobs = []
    for k in range(8):
        jobs += [lambda s, b=amp_bits[2 * k]: s.submit(b),
                 lambda s, p=patterns[k]: s.submit_marginal(p),
                 lambda s, k=k: s.submit_sample(8, seed=k),
                 lambda s, t=sums[k]: s.submit_expectation(t),
                 lambda s, b=amp_bits[2 * k + 1]: s.submit(b)]
    t0 = time.perf_counter()
    svc = ContractionService.from_circuit(sycamore(QUERY), backend=TorchBackend(), queries=True,
                                          max_batch=16, max_wait_ms=20)
    bind_s = time.perf_counter() - t0
    groups = []
    real = svc._dispatch_group

    def record(kind, payloads, bound):
        if kind == "amplitude":
            keys = {("amplitude",)}
        else:
            keys = {svc._handlers[kind].validate(p)[1] for p in payloads}
        groups.append((kind, len(payloads), sorted(keys)))
        return real(kind, payloads, bound)

    svc._dispatch_group = record
    held, seen = [], {}
    try:
        # one counted pass; each distinct chain held as it first runs
        reset_launches()
        t0 = time.perf_counter()
        with held_chains(label, held, seen, 1):
            answers = submit_round(svc, jobs)
        traffic_s = time.perf_counter() - t0
        stats = svc.stats()
    finally:
        svc.stop()
    launches = LAUNCHES["fused_chain"]
    check_held(label, held, launches)
    bad = [a for a in answers if isinstance(a, Exception)]
    check(not bad, f"{label}: a request failed: {bad[:1]}")
    check(all(len(keys) == 1 for _, _, keys in groups),
          f"{label}: a dispatched batch mixed batching keys: {groups}")
    state = sv_oracle.statevector(sycamore(QUERY))
    probs = np.abs(state) ** 2
    amps = np.array([answers[5 * k] for k in range(8)] + [answers[5 * k + 4] for k in range(8)])
    want = np.array([sv_oracle.amplitude(state, b)
                     for b in amp_bits[0::2] + amp_bits[1::2]])
    amp_err = float(np.max(np.abs(amps - want)))
    check(amp_err <= 1e-4 * float(np.max(np.abs(want))), f"{label}: amplitudes off by {amp_err}")
    marg = np.array([answers[5 * k + 1] for k in range(8)])
    marg_want = np.array([sv_oracle.marginal_probability(state, p) for p in patterns])
    marg_err = float(np.max(np.abs(marg - marg_want)))
    check(marg_err <= 1e-4 * float(np.max(marg_want)), f"{label}: marginals off by {marg_err}")
    def p1_of(k, prefix):
        p = probs[tuple(int(c) for c in prefix)].reshape(2, -1).sum(axis=1)
        return p[1] / p.sum() if p.sum() > 0 else 0.5

    differ = unexplained = 0
    for k in range(8):
        d, u = sample_replay(answers[5 * k + 2], p1_of, 8, k)
        differ, unexplained = differ + d, unexplained + u
    check(unexplained == 0, f"{label}: {unexplained} samples differ from complex128's away "
                            f"from a threshold")
    ev = np.array([answers[5 * k + 3] for k in range(8)])
    ev_want = np.array([sum(c * sv_oracle.pauli_expectation(state, p) for c, p in t)
                        for t in sums])
    ev_err = np.abs(ev - ev_want)
    check(np.all(ev_err <= 1e-5), f"{label}: an expectation is off by {float(np.max(ev_err))}")
    big = np.abs(ev_want) > 1e-2
    check(np.all(ev_err[big] <= 1e-3 * np.abs(ev_want[big])),
          f"{label}: an expectation is off by more than 1e-3 relative")
    by_type = {kind: {"counts": row["counts"], "latency_s": row["latency_s"]}
               for kind, row in stats["by_type"].items()}
    counted = [(k, n) for k, n, _ in groups]
    print(f"[{label}] from_circuit {bind_s:.3f} s; {len(jobs)} requests from 4 threads in "
          f"{traffic_s:.3f} s (each distinct chain held against its plain version as it "
          f"first ran), {len(counted)} batches {counted}, each one batching key; fused_chain "
          f"{launches} launches, {len(held)} distinct chains held; amplitudes max|diff| "
          f"{amp_err:.3e}, "
          f"marginals {marg_err:.3e}, expectations {float(np.max(ev_err)):.3e}, samples differing "
          f"from complex128 {differ} (all at a threshold); by_type {by_type}", flush=True)
    return {"launches": launches, "chain_rows": held, "record": {
        "bind_s": bind_s, "traffic_s": traffic_s, "batches": counted,
        "fused_chain_launches": launches, "amp_max_abs_err": amp_err,
        "marginal_max_abs_err": marg_err, "expectation_max_abs_err": float(np.max(ev_err)),
        "samples_differ": differ, "by_type": by_type}}


def run_serve_approx() -> dict:
    """Phase 14 (d): ``qaoa30_p2_approx``. BASELINE config #4's circuit
    (``qaoa_circuit(30, 2, rng 42)``) served with ``queries=True`` and
    ``approx=True, approx_options={"chi_start": 4, "chi_cap": 8}`` on one
    ``TorchBackend()``: the exact ⟨Z…Z⟩ within 1e-5 absolute and 1e-3
    relative of complex128 numpy (phase 13's gate), its chains held against
    their plain versions on a warm-up request; ``rtol=1e-2`` met by the
    ladder, its err at least its true error; ``rtol=1e-7`` escalated with
    the floor ``COMPLEX64_ERR_REL`` to the exact answer, bit for bit. The
    rungs and each request's seconds printed."""
    from tnc_tpu_torch.approx.ladder import COMPLEX64_ERR_REL
    from tnc_tpu_torch.builders.qaoa_circuit import qaoa_circuit
    from tnc_tpu_torch.ops.backends import NumpyBackend, TorchBackend
    from tnc_tpu_torch.ops.cuda_complex import LAUNCHES, reset_launches
    from tnc_tpu_torch.queries import pauli_expectation
    from tnc_tpu_torch.serve import ApproxAnswer, ContractionService

    qubits, rounds, seed = QAOA
    label = f"qaoa{qubits}_p{rounds}_approx"
    zz = "z" * qubits

    def circuit():
        return qaoa_circuit(qubits, rounds, np.random.default_rng(seed))

    ref = complex(pauli_expectation(circuit(), zz, backend=NumpyBackend()))
    t0 = time.perf_counter()
    # the ladder from chi 4, as phase 13's: the chi-2 rung costs each
    # request ~6.5 s and holds nothing of the value
    svc = ContractionService.from_circuit(
        circuit(), backend=TorchBackend(), queries=True, approx=True,
        approx_options={"chi_start": APPROX_QAOA_START, "chi_cap": 8})
    bind_s = time.perf_counter() - t0
    seconds = {}
    held, seen = [], {}
    try:
        # a warm-up request holds each distinct chain; then the counted one
        with held_chains(label, held, seen, 0):
            svc.expectation(zz, timeout_s=600)
        reset_launches()
        t0 = time.perf_counter()
        with held_chains(label, held, seen, 1):
            exact = complex(svc.expectation(zz, timeout_s=600))
        seconds["exact"] = time.perf_counter() - t0
        launches = LAUNCHES["fused_chain"]
        check_held(label, held, launches)
        t0 = time.perf_counter()
        tolerant = svc.expectation(zz, timeout_s=600, rtol=1e-2)
        seconds["rtol 1e-2"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tight = svc.expectation(zz, timeout_s=600, rtol=1e-7)
        seconds["rtol 1e-7"] = time.perf_counter() - t0
        approx_stats = svc.stats()["by_tier"]
    finally:
        svc.stop()
    err = abs(exact - ref)
    check(err <= 1e-5 and err <= 1e-3 * abs(ref),
          f"{label}: <Z...Z> {exact} off complex128 {ref} by {err}")
    check(isinstance(tolerant, ApproxAnswer) and not tolerant.escalated
          and tolerant.tolerance_met, f"{label}: rtol 1e-2 gave {tolerant}")
    true_err = abs(tolerant.value - ref)
    check(tolerant.err >= true_err, f"{label}: err {tolerant.err} under the true {true_err}")
    check(tolerant.err <= 1e-2 * max(abs(tolerant.value), 1.0),
          f"{label}: rtol 1e-2 answer's err {tolerant.err} over its tolerance")
    floor = COMPLEX64_ERR_REL * max(abs(tight.value), 1.0)
    check(tight.escalated and tight.err == floor,
          f"{label}: rtol 1e-7 gave {tight}, floor {floor}")
    # escalation runs the exact request's handler on the same backend
    tight_err = abs(tight.value - ref)
    check(complex(tight.value) == exact and tight_err <= 1e-5 and tight_err <= 1e-3 * abs(ref),
          f"{label}: the escalated answer {tight.value} is not the exact one {exact} (off "
          f"complex128 by {tight_err})")
    router = approx_stats["approx"]["router"]
    print(f"[{label}] from_circuit {bind_s:.3f} s; exact <Z...Z> {exact.real:.10e} (complex128 "
          f"{ref.real:.10e}, |diff| {err:.3e}), fused_chain {launches} launches; rtol 1e-2: "
          f"{tolerant} (true error {true_err:.3e}); rtol 1e-7: {tight}; rungs {router['rungs']}; "
          f"seconds a request {seconds}; tiers {approx_stats['approx']['counts']}", flush=True)
    return {"launches": launches, "chain_rows": held, "record": {
        "bind_s": bind_s, "exact": [exact.real, exact.imag], "complex128": [ref.real, ref.imag],
        "max_abs_err": err, "fused_chain_launches": launches,
        "tolerant": {"value": [tolerant.value.real, tolerant.value.imag], "err": tolerant.err,
                     "true_err": true_err, "chi_used": tolerant.chi_used,
                     "sweeps": tolerant.sweeps},
        "tight": {"escalated": tight.escalated, "err": tight.err, "sweeps": tight.sweeps},
        "rungs": router["rungs"], "seconds": seconds,
        "tier_counts": approx_stats["approx"]["counts"]}}


def run_serve() -> dict:
    """Phase 14: the serving front end and resilience on the card
    (:func:`run_serve_sycamore`, :func:`run_sliced_ckpt`,
    :func:`run_serve_mixed`, :func:`run_serve_approx`)."""
    import torch

    from tnc_tpu_torch.resilience import RetryPolicy, configure_retry

    t0 = time.perf_counter()
    # backoffs of a few ms: the injected transients need no real wait
    configure_retry(RetryPolicy(max_attempts=3, base_delay_s=0.005))
    try:
        rows = serve_rows()
        syc = run_serve_sycamore(rows)
        torch.cuda.empty_cache()
        sliced = run_sliced_ckpt(rows, syc["refs"])
        torch.cuda.empty_cache()
        mixed = run_serve_mixed()
        torch.cuda.empty_cache()
        approx = run_serve_approx()
        torch.cuda.empty_cache()
    finally:
        configure_retry(None)
    seconds = time.perf_counter() - t0
    print(f"[serve] phase 14 in {seconds:.1f} s", flush=True)
    cells = {f"sycamore{SWEEP[0]}_m{SWEEP[1]}_sliced_ckpt": sliced,
             f"sycamore{QUERY[0]}_m{QUERY[1]}_mixed": mixed,
             f"qaoa{QAOA[0]}_p{QAOA[1]}_approx": approx}
    launches = {**{f"{k} (phase 14)": v for k, v in syc["launches"].items()},
                **{f"{k} (phase 14)": cell["launches"] for k, cell in cells.items()}}
    # each cell's held chains, their launches those the cell counted
    rows = {**{f"{k} (phase 14)": v for k, v in syc["chain_rows"].items()},
            **{f"{k} (phase 14)": cell["chain_rows"] for k, cell in cells.items()}}
    check(all(sum(r["launches"] for r in rows[k]) == n for k, n in launches.items()),
          "phase 14: a cell's held launches differ from its count")
    record = {**syc["record"], **{k: cell["record"] for k, cell in cells.items()},
              "seconds": seconds}
    return {"record": record, "chain_launches": launches, "chain_rows": rows,
            "refs": syc["refs"], "sliced_clean": sliced["clean"]}


# --- phase 15: the in-process serving planes ----------------------------------


def http_get(url: str) -> bytes:
    """One GET over loopback (the service's telemetry endpoint)."""
    import urllib.request

    with urllib.request.urlopen(url, timeout=30) as resp:
        return resp.read()


def rung_times(attempts: list) -> list:
    """The seconds of each rung of one ladder call from its attempts (each
    ``{"outcome", "slices", "t0", "t1", "launches"}``): every attempt's run,
    and the replan between a failed attempt and the next."""
    out = []
    for i, a in enumerate(attempts):
        if i:
            out.append({"rung": "replan", "s": a["t0"] - attempts[i - 1]["t1"]})
        out.append({"rung": a["outcome"], "slices": a["slices"], "s": a["t1"] - a["t0"],
                    "launches": a["launches"]})
    return out


def hold_one_slice(label: str, backend, sp, arrays, rows: list) -> None:
    """Each distinct chain of one slice (or batch of one) of ``sp`` held
    against its plain version: slice 0 run eagerly on ``backend`` with
    every ``run_chain_split`` held, each row weighing the launches one
    slice makes at its operands, then weighed by the slices of the
    sliced run (every slice launches the same chains)."""
    fresh: list = []
    with held_chains(label, fresh, {}, 1):
        backend.execute_sliced(sp, arrays, max_slices=1, graphs=False)
    for r in fresh:
        r["launches"] *= sp.slicing.num_slices
    rows += fresh


def run_planes_serve(rows: list[str], refs: dict | None, meanwhile=None) -> dict:
    """Phase 15 (a): ``sycamore53_m8_planes``. Phase 14's Sycamore-53 rows
    served by ``ContractionService.from_circuit(sycamore_circuit(53, 8, rng
    42), plan_cache=<tmp>, background_replan=True, shared_cache_watch=True,
    telemetry_port=0, cost_truth=True, slo=...)`` on one ``TorchBackend()``
    with ``TNC_TPU_TRACE`` naming a file: a warm-up round holding the Greedy
    plan's chains, round 0, then ``meanwhile()`` (another cell's card work,
    the service idle) while the replanner searches on the host; its swap
    (the reference's margin 0.95 and its bounded ``Hyperoptimizer``; both
    predicted costs printed) adopted by a round that holds the swapped
    plan's chains at the rounds' batch, the SLO budget set to ``PLANES_SLO_FACTOR``
    times round 0's median latency, round 1 under
    ``maybe_jax_profiler_trace`` (``TNC_TPU_TRACE_JAX``: a non-empty torch
    trace), round 2 while ``/metrics`` and ``/healthz`` are scraped over
    loopback (the last scrape's completed count is ``stats()``'s), no burn
    alert after rounds 1 and 2, round 3 under a ``slow`` ``serve.dispatch``
    fault longer than the budget (a burn alert in ``stats()["slo"]`` and on
    ``/slo``); then ``maybe_refit(trigger="manual")`` publishes a generation
    to a temporary ``ModelRegistry``, one request adopts it, and
    ``backend.policy_key()`` is unchanged; the exported Chrome trace rolls
    up to every request served; a second service on the same cache
    directory picks the swapped plan up through
    ``SharedCacheWatcher.poll_once`` and serves one round. Every answer
    within ``F32_REL_TOL`` max|ref| of complex128 (phase 14's references,
    or made here through the swapped plan); every ``fused_chain`` launch on
    a held chain."""
    import tempfile
    import threading

    from tnc_tpu_torch import obs
    from tnc_tpu_torch.contractionpath.contraction_cost import FlopsObjective
    from tnc_tpu_torch.contractionpath.contraction_path import ContractionPath
    from tnc_tpu_torch.obs import core
    from tnc_tpu_torch.obs.cost_truth import CostTruthConfig, ModelRegistry
    from tnc_tpu_torch.obs.export import (
        export_chrome_trace,
        load_trace_events,
        serve_trace_rollup,
    )
    from tnc_tpu_torch.obs.http import parse_prometheus, wait_port_released
    from tnc_tpu_torch.obs.slo import BurnWindow, LatencyObjective, SLOConfig
    from tnc_tpu_torch.ops.backends import TorchBackend
    from tnc_tpu_torch.ops.cuda_complex import LAUNCHES, reset_launches
    from tnc_tpu_torch.ops.program import flat_leaf_tensors, steps_flops
    from tnc_tpu_torch.resilience import faults
    from tnc_tpu_torch.serve import ContractionService, PlanCache
    from tnc_tpu_torch.serve.rebind import plan_signature
    from tnc_tpu_torch.serve.replan import SharedCacheWatcher, plan_predicted_cost

    qubits, depth, _ = SWEEP
    label = f"sycamore{qubits}_m{depth}_planes"
    held, seen = [], {}
    served: list = []  # (bits, answers) of every request, held at the end
    saved = (core._ENABLED, core._REGISTRY, core._TRACE_PATH)
    tmp = tempfile.TemporaryDirectory()
    trace_file = os.path.join(tmp.name, "trace.json")
    prof_dir = os.path.join(tmp.name, "profile")
    cache_dir = os.path.join(tmp.name, "plans")
    registry_dir = os.path.join(tmp.name, "models")
    os.environ["TNC_TPU_TRACE"] = trace_file
    core._REGISTRY = core.MetricsRegistry()
    obs.refresh_from_env()
    svc = svc2 = None
    try:
        check(obs.enabled() and obs.trace_path() == trace_file,
              f"{label}: TNC_TPU_TRACE={trace_file} did not arm the trace export")
        backend = TorchBackend()
        t0 = time.perf_counter()
        svc = ContractionService.from_circuit(
            sycamore(SWEEP), backend=backend, plan_cache=PlanCache(cache_dir),
            max_batch=SERVE_BATCH, max_wait_ms=20, background_replan=True,
            shared_cache_watch=True, telemetry_port=0, cost_truth=True,
            cost_truth_options={"registry": registry_dir, "config": CostTruthConfig(
                refit_min_samples=2, refit_cooldown_s=0.0)},
            # an objective no request misses until round 0 sets the budget
            slo=SLOConfig(objectives=(LatencyObjective("amplitude", 3600.0, 0.9),)))
        bind_s = time.perf_counter() - t0
        greedy = svc.bound
        url = svc._telemetry.url
        # a second replica on the same cache directory, its watcher polled by hand
        svc2 = ContractionService.from_circuit(
            sycamore(SWEEP), backend=backend, plan_cache=PlanCache(cache_dir),
            max_batch=SERVE_BATCH, max_wait_ms=20)
        watcher = SharedCacheWatcher(svc2, svc2._plan_cache)
        check(plan_signature(svc2.bound) == plan_signature(greedy),
              f"{label}: the second service did not load the first's Greedy plan")
        submitted = 0

        def serve_round(service, bits):
            nonlocal submitted
            if service is svc:
                submitted += len(bits)
            got = submit_round(service, [lambda s, b=b: s.submit(b) for b in bits])
            check(not any(isinstance(a, Exception) for a in got),
                  f"{label}: a request failed: {[a for a in got if isinstance(a, Exception)][:1]}")
            served.append((bits, got))
            return got

        # a warm-up round holds the Greedy plan's chains (launches 0)
        with held_chains(label, held, seen, 0):
            serve_round(svc, round_bits(rows, 0))
        reset_launches()
        svc.reset_stats()
        with held_chains(label, held, seen, 1):
            t0 = time.perf_counter()
            serve_round(svc, round_bits(rows, 0))
            round0_s = time.perf_counter() - t0
        round0 = svc.stats()["latency_s"]
        budget = PLANES_SLO_FACTOR * round0["p50"]

        # the replanner searches on the host while the queue is empty; the
        # card meanwhile runs another cell (the dispatcher stays idle)
        replanner = svc._replanner
        t0 = time.perf_counter()
        counted = dict(LAUNCHES)  # the other cell counts its own launches
        meanwhile_out = meanwhile() if meanwhile is not None else None
        LAUNCHES.update(counted)
        meanwhile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        while replanner.stats["swaps"] + replanner.stats["rejects"] < 1:
            check(time.perf_counter() - t0 < 600, f"{label}: no replan verdict in 600 s")
            time.sleep(0.05)
        verdict_wait_s = time.perf_counter() - t0
        rstats = dict(replanner.stats)
        check(rstats["swaps"] == 1, f"{label}: the replanner did not swap: {rstats}")
        cache = svc._plan_cache
        key = cache.key_for_network(greedy.template.network, greedy.target_size)
        swapped_plan = cache.load(key)
        leaves = flat_leaf_tensors(greedy.template.network)

        def cost(record):
            return plan_predicted_cost(
                leaves, ContractionPath.from_obj(record["pairs"]).toplevel,
                cache.plan_slicing(record), FlopsObjective())

        greedy_cost, swapped_cost = cost(greedy.plan), cost(swapped_plan)
        check(swapped_plan.get("finder") == "Hyperoptimizer"
              and swapped_cost < replanner.margin * greedy_cost,
              f"{label}: the cached plan ({swapped_plan.get('finder')}) costs {swapped_cost:.4e} "
              f"against Greedy's {greedy_cost:.4e}")
        # a round adopts the swap at its batch boundary and holds the swapped
        # plan's chains at the batch the later rounds run
        with held_chains(label, held, seen, 1):
            serve_round(svc, round_bits(rows, 0))
        swapped = svc.bound
        check(svc.stats()["counts"]["plan_swaps"] >= 1 and swapped is not greedy
              and swapped.plan.get("finder") == "Hyperoptimizer",
              f"{label}: the swap was not adopted ({svc.stats()['counts']})")
        swapped_flops = steps_flops(swapped.program.steps)

        # the objective: round 0's median latency times PLANES_SLO_FACTOR
        svc.attach_slo(SLOConfig(
            objectives=(LatencyObjective("amplitude", budget, target=0.9),),
            windows=(BurnWindow(60.0, 120.0, 2.0),), min_requests=SERVE_BATCH))
        # round 1 under the torch profiler
        os.environ["TNC_TPU_TRACE_JAX"] = prof_dir
        round_s = []
        try:
            with held_chains(label, held, seen, 1):
                with obs.maybe_jax_profiler_trace() as prof:
                    t0 = time.perf_counter()
                    serve_round(svc, round_bits(rows, 1))
                    round_s.append(time.perf_counter() - t0)
        finally:
            del os.environ["TNC_TPU_TRACE_JAX"]
        prof_events = 0
        if prof.path is not None:
            with open(prof.path, encoding="utf-8") as fh:
                doc = json.load(fh)
            prof_events = len(doc.get("traceEvents", doc) if isinstance(doc, dict) else doc)
        check(prof.path is not None and prof_events > 0,
              f"{label}: the profiler wrote {prof.path} with {prof_events} events")
        alerts1 = svc.stats()["slo"]["alerts"]
        # round 2 while /metrics and /healthz are scraped
        scrapes: list = []
        done = threading.Event()

        def scrape():
            while not done.is_set():
                scrapes.append((http_get(f"{url}/metrics").decode(),
                                json.loads(http_get(f"{url}/healthz"))))
                done.wait(0.05)

        scraper = threading.Thread(target=scrape)
        scraper.start()
        try:
            with held_chains(label, held, seen, 1):
                t0 = time.perf_counter()
                serve_round(svc, round_bits(rows, 2))
                round_s.append(time.perf_counter() - t0)
        finally:
            done.set()
            scraper.join(timeout=60)
        last = parse_prometheus(http_get(f"{url}/metrics").decode())
        health = json.loads(http_get(f"{url}/healthz"))
        completed = svc.stats()["counts"]["completed"]
        scraped = last.get('tnc_tpu_serve_requests_total{outcome="completed"}')
        check(scrapes and all(h["status"] == "ok" for _, h in scrapes) and health["status"] == "ok",
              f"{label}: {len(scrapes)} scrapes during round 2, health {health}")
        check(scraped == completed, f"{label}: /metrics says {scraped} completed, "
                                    f"stats() {completed}")
        alerts2 = svc.stats()["slo"]["alerts"]
        check(not alerts1 and not alerts2,
              f"{label}: burn alerts before the slow round (rounds 1, 2 took {round_s} s, "
              f"budget {budget:.4f} s): {alerts1} {alerts2}")
        # round 3 under a serve.dispatch fault slower than the budget
        slow_s = budget + 0.5
        with held_chains(label, held, seen, 1), faults(f"serve.dispatch=slow:{slow_s:.3f}*1"):
            t0 = time.perf_counter()
            serve_round(svc, round_bits(rows, 3))
            round_s.append(time.perf_counter() - t0)
        slo_stats = svc.stats()["slo"]
        slo_http = json.loads(http_get(f"{url}/slo"))
        check(any(a["kind"] == "burn" for a in slo_stats["alerts"])
              and any(a["kind"] == "burn" for a in slo_http["alerts"]),
              f"{label}: no burn alert after the slow round: {slo_stats['alerts']}, "
              f"/slo {slo_http.get('alerts')}")
        burn = slo_stats["objectives"][0]["windows"][0]

        # the cost-truth loop: a manual refit, adopted at the next batch boundary
        key_before = backend.policy_key()
        ct = svc._cost_truth
        refitted = ct.maybe_refit(trigger="manual")
        pending = ct.stats()["pending_version"]
        check(refitted and pending is not None,
              f"{label}: the manual refit staged nothing: {ct.stats()['last_refit']}")
        with held_chains(label, held, seen, 1):
            serve_round(svc, [rows[1]])
        cal = svc.stats()["calibration"]
        published = ModelRegistry(registry_dir).latest()
        key_after = backend.policy_key()
        check(cal["model_version"] == pending and svc.cost_model is ct.model
              and published is not None and published[0] == pending,
              f"{label}: generation {pending} not adopted ({cal['model_version']}, "
              f"registry {published and published[0]})")
        check(key_before == key_after,
              f"{label}: policy_key moved across the adoption: {key_before} -> {key_after}")
        telemetry_port = svc._telemetry.port
        final = svc.stats()
        svc.stop()
        check(wait_port_released("127.0.0.1", telemetry_port),
              f"{label}: the telemetry port {telemetry_port} is still bound")
        check(final["counts"]["failed"] == 0, f"{label}: {final['counts']['failed']} failed")

        # the trace: every request of the first service rolls up
        export_chrome_trace(trace_file)
        rollup = serve_trace_rollup(load_trace_events(trace_file))
        check(len(rollup["requests"]) == submitted,
              f"{label}: the trace rolls up {len(rollup['requests'])} requests of {submitted}")

        # the second replica adopts the swapped plan through its watcher
        adopted = watcher.poll_once()
        check(adopted, f"{label}: the watcher did not pick the swapped plan up")
        with held_chains(label, held, seen, 1):
            serve_round(svc2, round_bits(rows, PLANES_ROUNDS))
        check(svc2.stats()["counts"]["plan_swaps"] == 1
              and plan_signature(svc2.bound) == plan_signature(swapped),
              f"{label}: the second service serves {svc2.bound.plan.get('finder')}")
        svc2.stop()
        launches = LAUNCHES["fused_chain"]
        check_held(label, held, launches)
    finally:
        for service in (svc, svc2):
            if service is not None:
                service.stop()
        core._ENABLED, core._REGISTRY, core._TRACE_PATH = saved
        os.environ.pop("TNC_TPU_TRACE", None)
        tmp.cleanup()

    # every answer against complex128 (phase 14's, or through the swapped plan)
    refs = dict(refs or {})
    need = sorted({b for bits, _ in served for b in bits} | {"0" * qubits})
    missing = [b for b in need if b not in refs]
    if missing:
        refs.update(complex128_amps(swapped, missing))
    err = max(hold_amps(label, got, bits, refs, tol=F32_REL_TOL) for bits, got in served)
    n_served = sum(len(bits) for bits, _ in served)
    model = cal["model"]
    print(f"[{label}] from_circuit {bind_s:.3f} s (Greedy, {len(greedy.program.steps)} steps); "
          f"round 0 {round0_s:.3f} s, latency p50 {round0['p50']:.4f} s: budget "
          f"{budget:.4f} s; {meanwhile_s:.2f} s of another cell, then the replan verdict "
          f"{verdict_wait_s:.2f} s later: {rstats}; rounds 1-3 {[round(t, 3) for t in round_s]} s; "
          f"predicted flops Greedy {greedy_cost:.4e}, Hyperoptimizer {swapped_cost:.4e} "
          f"(margin {replanner.margin}); swapped program {swapped_flops:.4e} multiply-adds, "
          f"{len(swapped.program.steps)} steps", flush=True)
    print(f"[{label} slo] alerts after rounds 1, 2: {len(alerts1)}, {len(alerts2)}; round 3 "
          f"slowed {slow_s:.3f} s: {[a['key'] for a in slo_stats['alerts']]} (burn "
          f"{burn['burn_short']}/{burn['burn_long']}, /slo {len(slo_http['alerts'])} alerts); "
          f"profiler round 1: {prof_events} events; {len(scrapes)} scrapes of /metrics and "
          f"/healthz during round 2, completed {scraped} = stats() {completed}", flush=True)
    print(f"[{label} cost truth] generation v{cal['model_version']} adopted: "
          f"{model['flops_per_s']:.4e} multiply-adds/s, {model['dispatch_s']:.4e} s a step, "
          f"bytes/s {model['bytes_per_s']}; policy_key unchanged {key_before == key_after}; "
          f"counts {cal['counts']}", flush=True)
    print(f"[{label} trace] {len(rollup['requests'])} requests rolled up, "
          f"{rollup['attributed_share']:.4f} of {rollup['dispatch_wall_ms']:.2f} ms dispatch "
          f"wall attributed; watcher adopted {adopted}; {n_served} answers, max|amp - "
          f"complex128| {err:.3e}; fused_chain {launches} launches on {len(held)} held chains",
          flush=True)
    return {"launches": launches, "chain_rows": held, "zero_ref": refs["0" * qubits],
            "meanwhile": meanwhile_out,
            "record": {
                "from_circuit_s": bind_s, "round0_s": round0_s, "round0_latency_s": round0,
                "budget_s": budget, "meanwhile_s": meanwhile_s,
                "replan_wait_s": verdict_wait_s, "replanner": rstats, "rounds_1_3_s": round_s,
                "greedy_cost": greedy_cost, "swapped_cost": swapped_cost,
                "margin": replanner.margin, "swapped_flops": swapped_flops,
                "alerts_rounds_1_2": len(alerts1) + len(alerts2),
                "alerts_round_3": [a["key"] for a in slo_stats["alerts"]], "burn": burn,
                "profiler_events": prof_events, "scrapes": len(scrapes),
                "scraped_completed": scraped, "stats_completed": completed,
                "model_version": cal["model_version"], "model": model,
                "cost_truth_counts": cal["counts"], "policy_key_unchanged": True,
                "trace_requests": len(rollup["requests"]),
                "attributed_share": rollup["attributed_share"],
                "watcher_adopted": adopted, "answers": n_served, "max_abs_err": err,
                "fused_chain_launches": launches}}


def run_degrade() -> dict:
    """Phase 15 (b): ``sycamore53_m8_degrade``. Phase 12's all-zeros
    amplitude of ``sycamore_circuit(53, 8, rng 42)``: the raw network,
    ``Greedy``, ``find_slicing`` to 2^``SWEEP_SLICED_TARGET``, through
    ``execute_sliced_resilient`` on ``TorchBackend(sliced_strategy="loop",
    hoist=False)`` with the card's memory capped
    (``set_per_process_memory_fraction``) at what the allocator holds plus
    ``DEGRADE_CAP`` of the program's modeled peak: a real
    ``torch.cuda.OutOfMemoryError`` reaches the ladder, which replans finer
    until the slicing fits; the cap restored however the call ends; the
    allocated memory back within ``DEGRADE_SLACK`` of its level before; the
    amplitude within ``DEGRADE_REL`` of complex128 (the unsliced path on the
    card, ``TorchBackend(dtype="complex128", split_complex=False)``). Then
    the fallback rung:
    ``max_replans=0``, no cap, one injected ``oom`` at ``backend.dispatch``,
    the chunked executor at batch 1, held the same way. Each rung's chains
    held on slice 0's operands, weighed by its slices."""
    import torch

    from tnc_tpu_torch.contractionpath.slicing import find_slicing
    from tnc_tpu_torch.ops.backends import TorchBackend
    from tnc_tpu_torch.ops.budget import program_peak_bytes
    from tnc_tpu_torch.ops.cuda_complex import LAUNCHES, reset_launches
    from tnc_tpu_torch.ops.program import flat_leaf_tensors
    from tnc_tpu_torch.ops.sliced import build_sliced_program
    from tnc_tpu_torch.resilience import execute_sliced_resilient, faults
    from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network

    qubits, depth, _ = SWEEP
    label = f"sycamore{qubits}_m{depth}_degrade"
    tn, _ = sycamore(SWEEP).into_amplitude_network("0" * qubits)
    path = plan(tn)
    zero_ref = complex(contract_tensor_network(
        tn, path, TorchBackend(dtype="complex128", split_complex=False)).data.into_data())
    slicing = find_slicing(tn.tensors, path.toplevel, 2.0 ** SWEEP_SLICED_TARGET)
    sp = build_sliced_program(tn, path, slicing)
    modeled = program_peak_bytes(sp.program).peak_bytes
    arrays = [np.asarray(leaf.data.into_data()) for leaf in flat_leaf_tensors(tn)]
    backend = TorchBackend(sliced_strategy="loop", hoist=False)
    real = backend.execute_sliced
    attempts: list = []

    def attempt(sp_, *args, **kwargs):
        start = LAUNCHES["fused_chain"]
        t0 = time.perf_counter()
        try:
            out = real(sp_, *args, **kwargs)
        except BaseException as exc:
            attempts.append({"outcome": type(exc).__name__, "slices": sp_.slicing.num_slices,
                             "t0": t0, "t1": time.perf_counter(),
                             "launches": LAUNCHES["fused_chain"] - start})
            raise
        attempts.append({"outcome": "ok", "slices": sp_.slicing.num_slices, "t0": t0,
                         "t1": time.perf_counter(),
                         "launches": LAUNCHES["fused_chain"] - start, "sp": sp_})
        return out

    backend.execute_sliced = attempt
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    cap = torch.cuda.memory_reserved() + DEGRADE_CAP * modeled
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.set_per_process_memory_fraction(cap / total)
    try:
        with obs_window() as obs:
            t0 = time.perf_counter()
            out, used = execute_sliced_resilient(tn, path, slicing, arrays=arrays,
                                                 backend=backend)
            wall = time.perf_counter() - t0
            ladder = obs.counters_by_prefix("resilience.ladder")
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    after = torch.cuda.memory_allocated()
    backend.execute_sliced = real
    ok = attempts[-1]
    check(attempts[0]["outcome"] == "OutOfMemoryError",
          f"{label}: the first attempt ended {attempts[0]['outcome']}, not a CUDA OOM "
          f"(cap {cap:.4e} bytes, modeled peak {modeled:.4e})")
    check(ladder.get("resilience.ladder.replans", 0) >= 1 and ok["outcome"] == "ok",
          f"{label}: ladder counters {ladder}, attempts {[a['outcome'] for a in attempts]}")
    check(abs(after - before) <= DEGRADE_SLACK,
          f"{label}: {after - before} bytes more allocated after the ladder than before")
    amp = complex(np.asarray(out).reshape(-1)[0])
    rel = abs(amp - zero_ref) / abs(zero_ref)
    check(rel <= DEGRADE_REL, f"{label}: the amplitude is off complex128 by {rel:.3e} relative")
    rows: list = []
    hold_one_slice(label, backend, ok["sp"], arrays, rows)
    check_held(label, rows, ok["launches"])
    final_peak = program_peak_bytes(ok["sp"].program).peak_bytes

    # the fallback rung: no replans, an injected oom, the chunked executor at batch 1
    loop = TorchBackend(sliced_strategy="loop", hoist=False)
    torch.cuda.empty_cache()
    reset_launches()
    with obs_window() as obs, faults("backend.dispatch=oom*1"):
        t0 = time.perf_counter()
        fb_out, fb_used = execute_sliced_resilient(tn, path, slicing, arrays=arrays,
                                                   backend=loop, max_replans=0)
        fb_s = time.perf_counter() - t0
        fallback = obs.counters_by_prefix("resilience.ladder")
    fb_launches = LAUNCHES["fused_chain"]
    check(fallback == {"resilience.ladder.fallback_chunked": 1.0}
          and fb_used.num_slices == slicing.num_slices,
          f"{label}: the fallback rung gave {fallback}, {fb_used.num_slices} slices")
    fb_amp = complex(np.asarray(fb_out).reshape(-1)[0])
    fb_rel = abs(fb_amp - zero_ref) / abs(zero_ref)
    check(fb_rel <= DEGRADE_REL, f"{label}: the fallback's amplitude is off by {fb_rel:.3e}")
    fb_rows: list = []
    hold_one_slice(f"{label} fallback",
                   TorchBackend(sliced_strategy="chunked", slice_batch=1, hoist=False),
                   sp, arrays, fb_rows)
    check_held(f"{label} fallback", fb_rows, fb_launches)
    rungs = rung_times(attempts)
    print(f"[{label}] Greedy, find_slicing to 2^{SWEEP_SLICED_TARGET}: "
          f"{slicing.num_slices} slices, modeled peak {modeled} bytes; memory capped at "
          f"{cap:.4e} bytes ({DEGRADE_CAP} of the peak above {cap - DEGRADE_CAP * modeled:.4e} "
          f"reserved): attempts {[(a['outcome'], a['slices']) for a in attempts]}, ladder "
          f"{ladder}; rungs {[(r['rung'], round(r['s'], 3)) for r in rungs]}; final "
          f"{used.num_slices} slices (legs {list(used.legs)}), modeled peak {final_peak} bytes; "
          f"{wall:.3f} s, max_memory_allocated {peak} bytes; allocated {before} before, "
          f"{after} after; amplitude {amp:.6e} against complex128 {zero_ref:.6e}: {rel:.3e} "
          f"relative; fused_chain {ok['launches']} launches ({attempts[0]['launches']} in the "
          f"failed attempt, not counted)", flush=True)
    print(f"[{label} fallback] backend.dispatch oom, max_replans=0: {fallback}, chunked batch "
          f"1 over {fb_used.num_slices} slices in {fb_s:.3f} s; {fb_rel:.3e} relative; "
          f"fused_chain {fb_launches} launches", flush=True)
    return {"launches": ok["launches"] + fb_launches, "chain_rows": rows + fb_rows,
            "zero_ref": zero_ref, "record": {"slices": slicing.num_slices, "modeled_peak_bytes": modeled,
                       "cap_bytes": cap, "attempts": [(a["outcome"], a["slices"])
                                                      for a in attempts],
                       "ladder": ladder, "rungs": rungs, "final_slices": used.num_slices,
                       "final_modeled_peak_bytes": final_peak, "wall_s": wall,
                       "peak_bytes": peak, "allocated_before": before,
                       "allocated_after": after, "rel_err": rel,
                       "fused_chain_launches": ok["launches"],
                       "failed_attempt_launches": attempts[0]["launches"],
                       "fallback": fallback, "fallback_s": fb_s, "fallback_rel_err": fb_rel,
                       "fallback_fused_chain_launches": fb_launches}}


def run_plansvc() -> dict:
    """Phase 15 (c): ``sycamore20_m8_plansvc``. Phase 14's mixed circuit,
    ``sycamore_circuit(20, 8, rng 42)``, served with ``plansvc=True`` on a
    plan cache in a temporary directory under ``target_size=2**
    PLANSVC_TARGET`` (above its Greedy peak: the plans stay unsliced) with
    ``PLANSVC_TRIALS`` trials: one round of 8 amplitudes before the pod's
    merge swaps the plan and one after, both against complex128 numpy
    within ``F32_REL_TOL`` max|ref|; every chain held."""
    import tempfile

    from tnc_tpu_torch.ops.backends import NumpyBackend, TorchBackend
    from tnc_tpu_torch.ops.cuda_complex import LAUNCHES, reset_launches
    from tnc_tpu_torch.serve import ContractionService, PlanCache
    from tnc_tpu_torch.serve.rebind import plan_signature

    qubits, depth, _ = QUERY
    label = f"sycamore{qubits}_m{depth}_plansvc"
    rng = np.random.default_rng(23)
    bits = ["".join(str(int(b)) for b in r) for r in rng.integers(0, 2, (2 * SERVE_BATCH, qubits))]
    held, seen = [], {}
    reset_launches()
    with tempfile.TemporaryDirectory() as cache_dir:
        t0 = time.perf_counter()
        svc = ContractionService.from_circuit(
            sycamore(QUERY), backend=TorchBackend(), plan_cache=PlanCache(cache_dir),
            target_size=2.0 ** PLANSVC_TARGET, max_batch=SERVE_BATCH, max_wait_ms=20,
            plansvc=True, plansvc_options={"ntrials": PLANSVC_TRIALS})
        try:
            bind_s = time.perf_counter() - t0
            greedy = svc.bound
            with held_chains(label, held, seen, 1):
                before = submit_round(svc, [lambda s, b=b: s.submit(b)
                                            for b in bits[:SERVE_BATCH]])
            swaps_before = svc.stats()["counts"]["plan_swaps"]
            pod = svc._plansvc
            t0 = time.perf_counter()
            # the pod counts a merge as it starts it: wait for its verdict
            while sum(pod.stats()["counts"][k] for k in ("swaps", "rejects",
                                                           "merge_failures")) < 1:
                check(time.perf_counter() - t0 < 600, f"{label}: no merge verdict in 600 s")
                time.sleep(0.05)
            merge_s = time.perf_counter() - t0
            pod_stats = pod.stats()
            check(pod_stats["counts"]["swaps"] == 1, f"{label}: the merge did not swap: {pod_stats}")
            with held_chains(label, held, seen, 1):
                after = submit_round(svc, [lambda s, b=b: s.submit(b)
                                           for b in bits[SERVE_BATCH:]])
            stats = svc.stats()
            swapped = svc.bound
        finally:
            svc.stop()
    check(swaps_before == 0 and stats["counts"]["plan_swaps"] == 1
          and swapped.plan.get("finder") == "PlannerFleet"
          and plan_signature(swapped) != plan_signature(greedy),
          f"{label}: swaps {swaps_before} before the merge, {stats['counts']['plan_swaps']} "
          f"after; serving {swapped.plan.get('finder')}")
    launches = LAUNCHES["fused_chain"]
    check_held(label, held, launches)
    refs = dict(zip(bits, greedy.amplitudes(bits, NumpyBackend())))
    err = max(hold_amps(f"{label} before", before, bits[:SERVE_BATCH], refs, tol=F32_REL_TOL),
              hold_amps(f"{label} after", after, bits[SERVE_BATCH:], refs, tol=F32_REL_TOL))
    print(f"[{label}] from_circuit {bind_s:.3f} s (Greedy, target 2^{PLANSVC_TARGET}); "
          f"{PLANSVC_TRIALS} trials, merged {merge_s:.2f} s after the first round: role "
          f"{pod_stats['role']}, counts {pod_stats['counts']}, board {pod_stats['board']}, best "
          f"{pod_stats['best_cost']:.4e} multiply-adds ({pod_stats['best_delta']:.4f} below "
          f"Greedy); swaps {swaps_before} -> {stats['counts']['plan_swaps']}; max|amp - "
          f"complex128| {err:.3e}; fused_chain {launches} launches on {len(held)} held chains",
          flush=True)
    return {"launches": launches, "chain_rows": held, "record": {
        "from_circuit_s": bind_s, "ntrials": PLANSVC_TRIALS, "target_log2": PLANSVC_TARGET,
        "merge_s": merge_s, "pod": pod_stats, "plan_swaps": stats["counts"]["plan_swaps"],
        "max_abs_err": err, "fused_chain_launches": launches}}


def run_planes(refs: dict | None = None) -> dict:
    """Phase 15: the in-process serving planes on the card
    (:func:`run_planes_serve`, with :func:`run_degrade` run on the card while
    its replanner searches on the host; :func:`run_plansvc`).
    ``refs``: phase 14's complex128 amplitudes of its rows, if it ran."""
    import torch

    from tnc_tpu_torch.resilience import RetryPolicy, configure_retry

    t0 = time.perf_counter()
    configure_retry(RetryPolicy(max_attempts=3, base_delay_s=0.005))
    try:
        # the degradation ladder's cell runs while the replanner searches
        planes = run_planes_serve(serve_rows(), refs, meanwhile=run_degrade)
        degrade = planes["meanwhile"]
        gap = abs(degrade["zero_ref"] - planes["zero_ref"])
        check(gap <= 1e-10 * abs(planes["zero_ref"]),
              f"phase 15: the two complex128 all-zeros amplitudes differ by {gap}")
        torch.cuda.empty_cache()
        plansvc = run_plansvc()
        torch.cuda.empty_cache()
    finally:
        configure_retry(None)
    seconds = time.perf_counter() - t0
    print(f"[planes] phase 15 in {seconds:.1f} s", flush=True)
    cells = {f"sycamore{SWEEP[0]}_m{SWEEP[1]}_planes": planes,
             f"sycamore{SWEEP[0]}_m{SWEEP[1]}_degrade": degrade,
             f"sycamore{QUERY[0]}_m{QUERY[1]}_plansvc": plansvc}
    launches = {f"{k} (phase 15)": cell["launches"] for k, cell in cells.items()}
    rows = {f"{k} (phase 15)": cell["chain_rows"] for k, cell in cells.items()}
    check(all(sum(r["launches"] for r in rows[k]) == n for k, n in launches.items()),
          "phase 15: a cell's held launches differ from its count")
    record = {**{k: cell["record"] for k, cell in cells.items()}, "seconds": seconds}
    return {"record": record, "chain_launches": launches, "chain_rows": rows}


# --- phase 16: the partitioned planner ----------------------------------------


def plan_numbers(program) -> dict:
    """A program's steps, naive multiply-adds and largest intermediate
    (elements)."""
    from tnc_tpu_torch.ops.program import step_flops

    return {"steps": len(program.steps),
            "madds": sum(step_flops(st) for st in program.steps),
            "peak": max(math.prod(st.out_store) for st in program.steps)}


def plan_line(name: str, numbers: dict) -> str:
    return (f"{name + ' ' if name else ''}{numbers['steps']} steps, "
            f"{numbers['madds']:.4e} multiply-adds, largest intermediate "
            f"2^{math.log2(numbers['peak']):.2f} elements")


@contextlib.contextmanager
def sa_round_scores(sa, n_trials: int):
    """While active, the best chain score of every round of a simulated-
    annealing run of ``sa`` (the port's ``simulated_annealing`` module) is
    appended to the yielded list, with how the round ran: ``"pool"`` (its
    chains on the spawn pool, read from ``pool_map_with_retry``'s results)
    or ``"serial"`` (the engine's own serial path, read from each
    ``_run_chain`` in this process). Both names are looked up at each call."""
    rounds: list = []
    serial: list = []
    real_map, real_chain = sa.pool_map_with_retry, sa._run_chain

    def pool_map(pool, submit, rebuild, log, what):
        results, pool = real_map(pool, submit, rebuild, log, what)
        if results is not None:
            rounds.append(("pool", min(score for score, _ in results)))
        return results, pool

    def run_chain(*args):
        out = real_chain(*args)
        serial.append(out[0])
        if len(serial) == n_trials:
            rounds.append(("serial", min(serial)))
            serial.clear()
        return out

    sa.pool_map_with_retry, sa._run_chain = pool_map, run_chain
    try:
        yield rounds
    finally:
        sa.pool_map_with_retry, sa._run_chain = real_map, real_chain


def held_contraction(label: str, tn, path, backend) -> dict:
    """``contract_tensor_network(tn, path, backend)`` once with each distinct
    chain held against its plain version (a repeat weighs one launch), its
    launches counted; the program's chains must all have launched."""
    import torch

    from tnc_tpu_torch.ops import split_complex
    from tnc_tpu_torch.ops.cuda_complex import LAUNCHES, reset_launches
    from tnc_tpu_torch.ops.program import build_program
    from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network

    chains = len(backend.kernel_policy(build_program(tn, path)).chains)
    rows: list = []
    torch.cuda.synchronize()
    reset_launches()
    with holding("run_chain_split",
                 hold_chain_run(lambda i: f"{label} chain {i}", 1, rows, {}),
                 split_complex):
        out = contract_tensor_network(tn, path, backend)
    torch.cuda.synchronize()
    launches = LAUNCHES["fused_chain"]
    check(launches == chains, f"{label}: fused_chain launched {launches} times for "
          f"{chains} chains")
    print(f"[{label}] {launches} fused_chain launches, {len(rows)} distinct chains held",
          flush=True)
    return {"out": out, "launches": launches, "rows": rows}


def run_partitioned_qaoa(cost_model=None) -> dict:
    """Phase 16 (a): BASELINE config #4 planned the reference bench's way
    (``bench.py:1350-1377``): ``qaoa_circuit(30, 2, default_rng(42))``'s
    ⟨Z…Z⟩ network, ``simplify_network``, ``find_partitioning(tn, 4)``,
    ``SA_ROUNDS`` work-bounded rounds of simulated annealing with
    ``IntermediatePartitioningModel`` (48 chains a round on the spawn pool,
    ``random.Random(42)``; the best chain score of each round printed), then
    ``compute_solution`` and ``build_program``; contracted through
    ``TorchBackend(dtype="complex64").bind_resident`` as the bench does:
    every distinct chain held against its plain version first, then three
    calls (eager; captured and replayed; replayed), each timed and counted,
    within 1e-5 absolute and 1e-3 relative of the complex128 ``NumpyBackend``
    value of the same program, the three calls bitwise equal. The same
    network under ``Greedy`` and under ``balance_partitions_iter``'s plan
    (its chains held) on the same gates. With ``cost_model`` (phase 11's
    fit), ``compute_solution`` in the seconds domain too."""
    import random

    import torch

    from tnc_tpu_torch.builders.qaoa_circuit import qaoa_circuit
    from tnc_tpu_torch.contractionpath.balancing import (
        BalanceSettings,
        balance_partitions_iter,
    )
    from tnc_tpu_torch.contractionpath.repartitioning import compute_solution
    from tnc_tpu_torch.contractionpath.repartitioning import simulated_annealing as sa
    from tnc_tpu_torch.ops import graphs, split_complex
    from tnc_tpu_torch.ops.backends import NumpyBackend, TorchBackend
    from tnc_tpu_torch.ops.cuda_complex import LAUNCHES, reset_launches
    from tnc_tpu_torch.ops.program import build_program, flat_leaf_tensors
    from tnc_tpu_torch.queries import bind_expectation
    from tnc_tpu_torch.tensornetwork.partitioning import find_partitioning
    from tnc_tpu_torch.tensornetwork.simplify import simplify_network

    qubits, rounds, seed = QAOA
    label = f"qaoa{qubits}_p{rounds}_partitioned"
    t0 = time.perf_counter()
    raw = qaoa_circuit(qubits, rounds, np.random.default_rng(seed)) \
        .into_expectation_value_network()
    tn = simplify_network(raw)
    simplify_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    initial = find_partitioning(tn, PARTS)
    partition_s = time.perf_counter() - t0
    sizes = [initial.count(b) for b in range(PARTS)]
    print(f"[{label}] {len(raw)} -> {len(tn)} tensors ({simplify_s:.2f} s); "
          f"find_partitioning into {PARTS}: blocks {sizes} ({partition_s:.3f} s)", flush=True)

    sa_rng = random.Random(seed)
    model = sa.IntermediatePartitioningModel(tn)
    t0 = time.perf_counter()
    with sa_round_scores(sa, SA_TRIALS) as round_scores:
        best, score = sa.balance_partitions(model, model.initial_solution(initial), sa_rng,
                                            n_trials=SA_TRIALS, max_rounds=SA_ROUNDS)
    sa_s = time.perf_counter() - t0
    assignment = best[0]
    check(len(round_scores) == SA_ROUNDS, f"{label}: {len(round_scores)} SA rounds seen, "
          f"not {SA_ROUNDS}")
    print(f"[{label}] SA ({SA_ROUNDS} rounds of {SA_TRIALS} chains, "
          f"{sorted({how for how, _ in round_scores})}): best chain score by round "
          f"{[s for _, s in round_scores]}, best {score:.6g}, blocks "
          f"{[assignment.count(b) for b in range(PARTS)]} in {sa_s:.2f} s", flush=True)
    check(score <= min(s for _, s in round_scores),
          f"{label}: the SA's best {score} is above a round's best chain")
    t0 = time.perf_counter()
    ptn, ppath, parallel, serial = compute_solution(tn, assignment, rng=sa_rng)
    solution_s = time.perf_counter() - t0
    program = build_program(ptn, ppath)
    arrays = [leaf.data.into_data() for leaf in flat_leaf_tensors(ptn)]
    numbers = plan_numbers(program)
    greedy_path = plan(tn)
    greedy_numbers = plan_numbers(build_program(tn, greedy_path))
    phase13_numbers = plan_numbers(bind_expectation(
        qaoa_circuit(qubits, rounds, np.random.default_rng(seed))).bound.program)
    print(f"[{label}] compute_solution ({solution_s:.3f} s): parallel cost {parallel:.6g}, "
          f"serial cost {serial:.6g}; {plan_line('partitioned', numbers)}; "
          f"{plan_line('Greedy on the simplified network', greedy_numbers)}; "
          f"{plan_line('phase 13 Greedy sandwich', phase13_numbers)}", flush=True)
    record = {"tensors": [len(raw), len(tn)], "blocks": sizes, "sa_rounds": SA_ROUNDS,
              "sa_trials": SA_TRIALS, "sa_round_scores": [s for _, s in round_scores],
              "sa_mode": sorted({how for how, _ in round_scores}), "sa_score": score,
              "sa_s": sa_s, "sa_blocks": [assignment.count(b) for b in range(PARTS)],
              "parallel_cost": parallel, "serial_cost": serial, "plan": numbers,
              "greedy_plan": greedy_numbers, "phase13_plan": phase13_numbers}
    if cost_model is not None:
        _, _, par_s, ser_s = compute_solution(tn, assignment, rng=random.Random(seed),
                                              cost_model=cost_model)
        print(f"[{label}] under phase 11's fitted model: predicted critical path "
              f"{par_s:.6g} s, serial {ser_s:.6g} s", flush=True)
        record.update(predicted_critical_s=par_s, predicted_serial_s=ser_s)

    t0 = time.perf_counter()
    ref = complex(np.asarray(NumpyBackend().execute(program, arrays)).reshape(-1)[0])
    print(f"[{label}] complex128 NumpyBackend {ref.real:.10e} in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    backend = TorchBackend(dtype="complex64")
    policy = backend.kernel_policy(program)
    check(policy.chains, f"{label}: the policy forms no chain")
    rows: list = []
    seen: dict = {}
    print(f"[kernels] fused_chain against fused_chain_reference on the operands of "
          f"{label} (each distinct chain once)", flush=True)
    with holding("run_chain_split",
                 hold_chain_run(lambda i: f"{label} chain {i}", 1, rows, seen), split_complex):
        backend.bind_resident(program, arrays, graphs=False)()
    check(sum(r["launches"] for r in rows) == len(policy.chains),
          f"{label}: {sum(r['launches'] for r in rows)} chain calls held for "
          f"{len(policy.chains)} chains")
    bound = backend.bind_resident(program, arrays)
    calls = []
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        graphs.reset_stats()
        t0 = time.perf_counter()
        out = bound()
        torch.cuda.synchronize()
        calls.append({"wall_s": time.perf_counter() - t0, "out": out,
                      "launches": LAUNCHES["fused_chain"], "graphs": dict(graphs.STATS),
                      "peak_bytes": torch.cuda.max_memory_allocated()})
    for i, call in enumerate(calls):
        check(call["launches"] == len(policy.chains),
              f"{label} bound call {i}: fused_chain launched {call['launches']} times for "
              f"{len(policy.chains)} chains")
        check(all(torch.equal(a, b) for a, b in zip(call["out"], calls[0]["out"])),
              f"{label} bound call {i}: not the first call's bits")
    del bound
    got = complex(torch.complex(*calls[-1]["out"]).cpu().numpy().reshape(-1)[0])
    print(f"[{label}] bind_resident calls: eager {calls[0]['wall_s']:.6f} s, captured and "
          f"replayed {calls[1]['wall_s']:.6f} s, replayed {calls[2]['wall_s']:.6f} s; "
          f"{len(policy.chains)} fused_chain launches a call; graphs "
          f"{[c['graphs']['graphs'] for c in calls]}, replays "
          f"{[c['graphs']['replays'] for c in calls]}; max_memory_allocated "
          f"{[c['peak_bytes'] for c in calls]}", flush=True)
    err = hold_value(label, got, ref)
    # the path's launches are the three bound calls': each held row weighs
    # one launch a call
    launches = {label: sum(c["launches"] for c in calls)}
    for r in rows:
        r["launches"] *= len(calls)
    record.update(chains=len(policy.chains), value=[got.real, got.imag],
                  complex128=[ref.real, ref.imag], abs_err=err,
                  bound_walls_s=[c["wall_s"] for c in calls],
                  bound_peak_bytes=[c["peak_bytes"] for c in calls])

    # the same network under Greedy, then under balance_partitions_iter's plan
    greedy_label = f"qaoa{qubits}_p{rounds}_greedy"
    greedy = held_contraction(greedy_label, tn, greedy_path, backend)
    greedy_got = complex(greedy["out"].data.into_data())
    hold_value(greedy_label, greedy_got, ref)
    launches[greedy_label] = greedy["launches"]

    balanced_label = f"qaoa{qubits}_p{rounds}_balanced"
    t0 = time.perf_counter()
    best_iter, btn, bpath, history = balance_partitions_iter(
        tn, initial, BalanceSettings(), random.Random(seed))
    balance_s = time.perf_counter() - t0
    bprogram = build_program(btn, bpath)
    bnumbers = plan_numbers(bprogram)
    barrays = [leaf.data.into_data() for leaf in flat_leaf_tensors(btn)]
    bref = complex(np.asarray(NumpyBackend().execute(bprogram, barrays)).reshape(-1)[0])
    print(f"[{balanced_label}] balance_partitions_iter ({balance_s:.2f} s): best iteration "
          f"{best_iter} of {len(history) - 1}, cost {history[0]:.6g} -> {min(history):.6g}, "
          f"blocks {[len(b) for b in btn]}; {plan_line('balanced', bnumbers)}; complex128 "
          f"{bref.real:.10e}", flush=True)
    balanced = held_contraction(balanced_label, btn, bpath, backend)
    hold_value(balanced_label, complex(balanced["out"].data.into_data()), bref)
    hold_value(f"{balanced_label} complex128 against the partitioned plan's", bref, ref)
    launches[balanced_label] = balanced["launches"]
    record.update(greedy_value=[greedy_got.real, greedy_got.imag],
                  balanced={"best_iteration": best_iter, "history": history,
                            "blocks": [len(b) for b in btn], "plan": bnumbers,
                            "seconds": balance_s, "complex128": [bref.real, bref.imag]})
    torch.cuda.empty_cache()
    return {"record": record, "chain_launches": launches,
            "chain_rows": {label: rows, greedy_label: greedy["rows"],
                           balanced_label: balanced["rows"]},
            "cell": {"ptn": ptn, "ppath": ppath, "ref": ref}}


def run_treecut(amp_ref: complex | None = None) -> dict:
    """Phase 16 (b): the tree cut on the card. The amplitude "0"x53 of
    ``sycamore_circuit(53, 8, default_rng(42))`` (phase 12's raw network),
    its ``Greedy`` SSA path cut into ``TREECUT_PARTS`` blocks by
    ``plan_treecut(..., seed=TREECUT_SEED)``, the partitioned plan from
    ``compute_solution_with_paths(..., rng=random.Random(0))`` (the default
    GREEDY fan-in), contracted by ``contract_tensor_network(ptn, ppath,
    TorchBackend())`` on one card: its chains held against their plain
    version in the warm-up, three timed runs (wall, CUDA-event seconds,
    peak against ``compute_memory_requirements``), the device-resident
    part timed alone and profiled once (device busy seconds and share), the
    amplitude within
    1e-4·max(|ref|, 2^-14) of complex128 on the card (and of phase 12's
    complex128 value for the bitstring, ``amp_ref``, where it ran)."""
    import random

    import torch

    from tnc_tpu_torch.contractionpath.contraction_cost import (
        communication_path_op_costs,
        compute_memory_requirements,
    )
    from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
    from tnc_tpu_torch.contractionpath.repartitioning import compute_solution_with_paths
    from tnc_tpu_torch.contractionpath.treecut import plan_treecut
    from tnc_tpu_torch.ops import split_complex
    from tnc_tpu_torch.ops.backends import TorchBackend
    from tnc_tpu_torch.ops.program import build_program
    from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network

    qubits, depth, _ = SWEEP
    label = f"sycamore{qubits}_m{depth}_treecut"
    tn, _ = sycamore(SWEEP).into_amplitude_network("0" * qubits)
    t0 = time.perf_counter()
    greedy = Greedy(OptMethod.GREEDY).find_path(tn)
    greedy_s = time.perf_counter() - t0
    greedy_numbers = plan_numbers(build_program(tn, greedy.replace_path()))
    t0 = time.perf_counter()
    cut = plan_treecut(list(tn.tensors), greedy.ssa_path.toplevel, TREECUT_PARTS,
                       seed=TREECUT_SEED)
    cut_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ptn, ppath, parallel, serial = compute_solution_with_paths(
        tn, cut.assignment, cut.local_paths, rng=random.Random(TREECUT_RNG))
    solution_s = time.perf_counter() - t0
    program = build_program(ptn, ppath)
    numbers = plan_numbers(program)
    top = build_program(*compute_solution_with_paths(
        tn, cut.assignment, cut.local_paths, communication_path=cut.toplevel)[:2])
    top_numbers = plan_numbers(top)
    mem = compute_memory_requirements(ptn.tensors, ppath)
    print(f"[{label}] {len(tn)} tensors; Greedy ({greedy_s:.2f} s): "
          f"{plan_line('', greedy_numbers)}; plan_treecut into {TREECUT_PARTS} "
          f"(seed {TREECUT_SEED}, {cut_s:.2f} s): blocks "
          f"{[cut.assignment.count(b) for b in range(TREECUT_PARTS)]}, critical estimate "
          f"{cut.critical_estimate:.6g}, serial {cut.serial_estimate:.6g}, speedup estimate "
          f"{cut.speedup_estimate:.3f}; compute_solution_with_paths ({solution_s:.2f} s, "
          f"GREEDY fan-in {ppath.toplevel}): parallel {parallel:.6g}, serial {serial:.6g}; "
          f"{plan_line('partitioned', numbers)}; with the cut's own fan-in "
          f"{cut.toplevel}: {plan_line('', top_numbers)}; compute_memory_requirements "
          f"{mem:.6g} elements", flush=True)

    backend = TorchBackend()
    policy = backend.kernel_policy(program)
    rows: list = []
    seen: dict = {}

    def held():
        with holding("run_chain_split",
                     hold_chain_run(lambda i: f"{label} chain {i}", 1, rows, seen),
                     split_complex):
            return contract_tensor_network(ptn, ppath, backend)

    print(f"[kernels] fused_chain against fused_chain_reference on the operands of {label} "
          f"(each distinct chain once, in the warm-up)", flush=True)
    run = run_counted(lambda: contract_tensor_network(ptn, ppath, backend), label,
                      warmup=held)
    check(sum(r["launches"] for r in rows) == len(policy.chains),
          f"{label}: {sum(r['launches'] for r in rows)} chain calls held for "
          f"{len(policy.chains)} chains")
    check(run["launches"]["fused_chain"] == len(policy.chains),
          f"{label}: fused_chain launched {run['launches']['fused_chain']} times for "
          f"{len(policy.chains)} chains")
    got = complex(run["out"].data.into_data())
    del run["out"]
    prof = profile_device_path(device_run(ptn, ppath, backend), label)
    t0 = time.perf_counter()
    oracle = TorchBackend(dtype="complex128", split_complex=False)
    ref = complex(contract_tensor_network(ptn, ppath, oracle).data.into_data())
    ref_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    tol = 1e-4 * max(abs(ref), 2.0 ** -14)
    err = abs(got - ref)
    peak = run["peak_bytes"]
    print(f"[check] {label} amplitude {got:.6e}, complex128 on the card {ref:.6e} "
          f"({ref_s:.2f} s): |diff| {err:.3e} (gate {tol:.3e}); wall "
          f"{statistics.median(run['walls']):.4f} s, CUDA-event span "
          f"{statistics.median(run['elapsed']):.4f} s; max_memory_allocated {peak} bytes, "
          f"{peak / (8 * mem):.3f}x compute_memory_requirements at 8 bytes an element",
          flush=True)
    check(err <= tol, f"{label}: amplitude off complex128 by {err}")
    if amp_ref is not None:
        gap = abs(got - amp_ref)
        print(f"[check] {label} against phase 12's complex128 amplitude {amp_ref:.6e}: "
              f"|diff| {gap:.3e} (gate {tol:.3e})", flush=True)
        check(gap <= tol, f"{label}: amplitude off phase 12's complex128 by {gap}")
    record = {"tensors": len(tn), "greedy_plan": greedy_numbers, "greedy_s": greedy_s,
              "treecut_s": cut_s, "blocks": [cut.assignment.count(b)
                                             for b in range(TREECUT_PARTS)],
              "critical_estimate": cut.critical_estimate,
              "serial_estimate": cut.serial_estimate, "parallel_cost": parallel,
              "serial_cost": serial, "plan": numbers, "toplevel_plan": top_numbers,
              "memory_requirement": mem, "chains": len(policy.chains),
              "amplitude": [got.real, got.imag], "complex128": [ref.real, ref.imag],
              "abs_err": err, "wall_s": run["walls"], "elapsed_s": run["elapsed"],
              "peak_bytes": peak, **prof,
              "busy_share": prof["device_busy_s"] / prof["profiled_s"]}
    return {"record": record, "chain_launches": {label: run["launches"]["fused_chain"]},
            "chain_rows": {label: rows}, "cell": {"ptn": ptn, "ppath": ppath, "ref": ref}}


def run_partitioned(cost_model=None, amp_ref: complex | None = None) -> dict:
    """Phase 16: the partitioned planner (:func:`run_partitioned_qaoa`,
    :func:`run_treecut`)."""
    t0 = time.perf_counter()
    qaoa = run_partitioned_qaoa(cost_model)
    cut = run_treecut(amp_ref)
    seconds = time.perf_counter() - t0
    print(f"[partitioned] phase 16 in {seconds:.1f} s", flush=True)
    rows = {**qaoa["chain_rows"], **cut["chain_rows"]}
    launches = {**qaoa["chain_launches"], **cut["chain_launches"]}
    check(all(sum(r["launches"] for r in rows[k]) == n for k, n in launches.items()),
          "phase 16: a cell's held launches differ from its count")
    return {"record": {"qaoa30_p2_partitioned": qaoa["record"],
                       "sycamore53_m8_treecut": cut["record"], "seconds": seconds},
            "chain_launches": launches, "chain_rows": rows,
            "cells": {"qaoa": qaoa["cell"], "treecut": cut["cell"]}}


def sliced_refs(cell) -> list:
    """The complex128 value of every slice of phase 8's cell on the card: its
    own partials (phase 8 keeps all of them unless complex128 of all would
    have taken over ``SLICED_CHECK_S``), completed here where it kept 32."""
    from tnc_tpu_torch.ops.backends import TorchBackend

    refs = list(cell["refs"])
    n = cell["slicing"].num_slices
    if len(refs) < n:
        oracle = TorchBackend(dtype="complex128", split_complex=False,
                              sliced_strategy="loop", hoist=False)
        refs += [scalar(oracle.execute_sliced(cell["sp"], cell["arrays"], slice_range=(s, s + 1)))
                 for s in range(len(refs), n)]
    return refs


def m10_cell() -> dict:
    """Phase 8's plan (``SLICED``) and complex128 partials, made here when
    phase 17 runs alone."""
    from tnc_tpu_torch.ops.program import flat_leaf_tensors
    from tnc_tpu_torch.ops.sliced import build_sliced_program

    tn, path, sl = build_sliced(SLICED)
    cell = {"tn": tn, "path": path, "slicing": sl, "sp": build_sliced_program(tn, path, sl),
            "arrays": [leaf.data.into_data() for leaf in flat_leaf_tensors(tn)], "refs": []}
    t0 = time.perf_counter()
    cell["refs"] = sliced_refs(cell)
    print(f"[parallel] sycamore{SLICED[:3]} at 2^{SLICED[3]}: {sl.num_slices} slices, "
          f"complex128 of each on the card in {time.perf_counter() - t0:.2f} s", flush=True)
    return cell


def path_obj(p):
    """A nested contraction path as plain tuples."""
    return (tuple(sorted((k, path_obj(v)) for k, v in p.nested.items())),
            tuple(tuple(pair) for pair in p.toplevel))


def treecut_distributed(cell) -> dict:
    """Phase 17 (1): phase 16's tree cut of the Sycamore-53 depth-8 amplitude
    through ``distributed_partitioned_contraction`` on ``[cuda:0] *
    PARALLEL_DEVICES``, then again with ``hbm_bytes`` at half the largest
    partition's modeled peak, so that it slices locally through the chunked
    executor. Each budget: the scattered partitions' local phase run once
    with each distinct chain held against its plain version (one launch a
    call; the fan-in's pair programs form no chain), then timed with the
    partitions issued together on their streams and one by one; then one
    counted run of the entry point (wall, CUDA-event seconds, peak,
    launches equal to the held local phase's) traced for the fan-in levels'
    bytes and flops, its amplitude within 1e-4·max(|ref|, 2^-14) of phase
    16's complex128 value."""
    import torch

    from tnc_tpu_torch.ops.budget import program_peak_bytes
    from tnc_tpu_torch.ops.program import build_program
    from tnc_tpu_torch.parallel.partitioned import resolve_devices

    ptn, ppath, ref = cell["ptn"], cell["ppath"], cell["ref"]
    label = f"sycamore{SWEEP[0]}_m{SWEEP[1]}_treecut_distributed"
    devices = resolve_devices([torch.device("cuda:0")] * PARALLEL_DEVICES)
    tol = 1e-4 * max(abs(ref), 2.0 ** -14)
    peaks = [program_peak_bytes(build_program(child, ppath.nested[i])).peak_bytes
             for i, child in enumerate(ptn.tensors)]
    largest = peaks.index(max(peaks))
    budget = max(peaks) // 2
    rows: list = []
    seen: dict = {}
    launches = 0
    record = {"devices": len(devices), "partition_peak_bytes": peaks, "budget_bytes": budget,
              "toplevel": [list(p) for p in ppath.toplevel], "runs": {}}
    for name, kw in (("unbudgeted", {}), ("half the largest peak", {"hbm_bytes": budget})):
        # one fresh trace a budget: the policies plan without a fitted model
        # in every run, and its spans are this budget's alone
        with obs_window() as obs:
            rec = treecut_budget(ptn, ppath, devices, kw, f"{label} {name}", rows, seen, obs)
        if kw:
            check(largest in rec["sliced_partitions"], f"{label}: the largest partition "
                  f"({largest}, {peaks[largest]} bytes modeled) did not slice under {budget} "
                  f"bytes")
        err = abs(complex(*rec["amplitude"]) - ref)
        print(f"[check] {label} {name}: amplitude {complex(*rec['amplitude']):.6e} vs "
              f"complex128 {ref:.6e}, |diff| {err:.3e} (gate {tol:.3e})", flush=True)
        check(err <= tol, f"{label} {name}: amplitude off complex128 by {err}")
        record["runs"][name] = {**rec, "abs_err": err}
        launches += rec["launches"]
        torch.cuda.empty_cache()
    record["complex128"] = [ref.real, ref.imag]
    return {"label": label, "record": record, "launches": launches, "rows": rows}


def treecut_budget(ptn, ppath, devices, kw: dict, label: str, rows: list, seen: dict,
                   obs) -> dict:
    """One budget of :func:`treecut_distributed`: the scatter, the local
    phase held then timed together and one by one, the counted run of
    ``distributed_partitioned_contraction(..., **kw)`` and its fan-in
    levels' spans."""
    import torch

    from tnc_tpu_torch.ops.sliced import SlicedProgram
    from tnc_tpu_torch.parallel.partitioned import (
        Communication,
        DeviceTensorMapping,
        distributed_partitioned_contraction,
        local_contract_partitions,
        scatter_partitions,
    )

    comm, buffers = scatter_partitions(ptn, ppath, devices, "complex64", True, **kw)
    sliced = {i: p.slicing.num_slices for i, p in enumerate(comm.programs)
              if isinstance(p, SlicedProgram)}

    def local(subset):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        local_contract_partitions(
            Communication(DeviceTensorMapping(tuple(range(len(subset)))), devices,
                          [comm.programs[i] for i in subset],
                          [comm.results_meta[i] for i in subset]),
            [buffers[i] for i in subset], True, "float32")
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3

    parts = list(range(len(comm.programs)))
    # the local phase once with each distinct chain held (the fan-in's pair
    # programs form no chain), then timed together and one by one
    before = sum(r["launches"] for r in rows)
    with held_chains(label, rows, seen, 1):
        local(parts)
    together = local(parts)
    alone = [local([i]) for i in parts]
    del comm, buffers
    run = run_counted(lambda: distributed_partitioned_contraction(ptn, ppath, devices=devices,
                                                                  **kw),
                      label, reps=1, warmup=lambda: None)
    check_held(label, rows, run["launches"]["fused_chain"], before)
    levels = [{k: r.args[k] for k in ("pairs", "bytes", "flops")}
              for r in obs.get_registry().span_records() if r.name == "partitioned.fanin_level"]
    got = complex(run["out"].data.into_data())
    print(f"[{label}] partitions sliced {sliced}; local phase on {len(parts)} streams "
          f"{together:.4f} s (CUDA events), one by one {sum(alone):.4f} s "
          f"({[round(a, 4) for a in alone]}); fan-in levels {levels}", flush=True)
    return {"sliced_partitions": sliced, "wall_s": run["walls"][0],
            "elapsed_s": run["elapsed"][0], "peak_bytes": run["peak_bytes"],
            "launches": run["launches"]["fused_chain"], "local_together_s": together,
            "local_alone_s": alone, "fanin_levels": levels, "amplitude": [got.real, got.imag]}


def config5() -> dict:
    """Phase 17 (2): BASELINE config #5 planned as ``bench.py:1442-1500``
    plans it — ``sycamore_circuit(24, 20, default_rng(42))``'s amplitude
    "0"x24, ``simplify_network``, ``find_partitioning(tn, 8)``, ``SA_ROUNDS``
    work-bounded rounds of simulated annealing with
    ``IntermediatePartitioningModel`` from ``random.Random(42)``,
    ``compute_solution`` — through ``partitioned_sliced_executor(...,
    devices=[cuda:0] * 8, hbm_bytes=16 GiB, plan_max_slices=1 << 40)``, as the bench
    passes it: ``run(1)`` to warm up (each
    distinct chain held against its plain version), ``run(2)`` timed (the
    bench's probe) and ``run()`` over every global slice, each counted; the
    full sum within 1e-4·max(|ref|, 2^-14) of a complex128 contraction of
    the ``flatten_partitioned_path`` plan on the card."""
    import random

    import torch

    from tnc_tpu_torch.builders.sycamore_circuit import sycamore_circuit
    from tnc_tpu_torch.contractionpath.contraction_path import ContractionPath
    from tnc_tpu_torch.contractionpath.repartitioning import compute_solution
    from tnc_tpu_torch.contractionpath.repartitioning import simulated_annealing as sa
    from tnc_tpu_torch.contractionpath.slicing import sliced_flops, sliced_peak
    from tnc_tpu_torch.ops.backends import TorchBackend
    from tnc_tpu_torch.ops.cuda_complex import LAUNCHES, reset_launches
    from tnc_tpu_torch.parallel.partitioned import (
        flatten_partitioned_path,
        partitioned_sliced_executor,
    )
    from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network
    from tnc_tpu_torch.tensornetwork.partitioning import find_partitioning
    from tnc_tpu_torch.tensornetwork.simplify import simplify_network
    from tnc_tpu_torch.tensornetwork.tensor import CompositeTensor

    qubits, depth, seed, k = CONFIG5
    label = f"sycamore{qubits}_m{depth}_partitioned{k}"
    t0 = time.perf_counter()
    raw, _ = sycamore_circuit(qubits, depth, np.random.default_rng(seed)) \
        .into_amplitude_network("0" * qubits)
    tn = simplify_network(raw)
    initial = find_partitioning(tn, k)
    model = sa.IntermediatePartitioningModel(tn)
    with sa_round_scores(sa, SA_TRIALS) as round_scores:
        best, score = sa.balance_partitions(model, model.initial_solution(initial),
                                            random.Random(seed), n_trials=SA_TRIALS,
                                            max_rounds=SA_ROUNDS)
    ptn, ppath, parallel, serial = compute_solution(tn, best[0], rng=random.Random(seed))
    plan_s = time.perf_counter() - t0
    devices = [torch.device("cuda:0")] * k
    t0 = time.perf_counter()
    run, slicing, meta = partitioned_sliced_executor(ptn, ppath, devices=devices,
                                                     hbm_bytes=CONFIG5_HBM,
                                                     plan_max_slices=1 << 40)
    setup_s = time.perf_counter() - t0
    leaves, pairs = flatten_partitioned_path(ptn, ppath)
    num = slicing.num_slices
    peak = sliced_peak(leaves, pairs, slicing)
    madds = sliced_flops(leaves, pairs, slicing)
    print(f"[{label}] {len(raw)} -> {len(tn)} tensors, find_partitioning into {k}: blocks "
          f"{[initial.count(b) for b in range(k)]}; SA best chain score by round "
          f"{[s for _, s in round_scores]}, best {score:.6g}; compute_solution: parallel "
          f"{parallel:.6g}, serial {serial:.6g}; planned in {plan_s:.2f} s; global slicing at "
          f"2^{math.log2(CONFIG5_HBM / 64):.0f} elements (hbm {CONFIG5_HBM} bytes): {num} slices "
          f"over legs {list(slicing.legs)}, per-slice peak {peak:.4e} elements, "
          f"{madds:.4e} multiply-adds over all slices; executor set up in {setup_s:.3f} s",
          flush=True)
    rows: list = []
    seen: dict = {}
    torch.cuda.synchronize()
    reset_launches()
    with held_chains(f"{label} run(1)", rows, seen, 1):
        run(1)
    per_slice = sum(r["launches"] for r in rows)
    check(LAUNCHES["fused_chain"] == per_slice > 0,
          f"{label}: run(1) launched fused_chain {LAUNCHES['fused_chain']} times, held "
          f"{per_slice}")
    probe = run_counted(lambda: run(2), f"{label} run(2)", reps=1, warmup=lambda: None)
    full = run_counted(lambda: run(), f"{label} run()", reps=1, warmup=lambda: None)
    for name, r, n in (("run(2)", probe, min(2, num)), ("run()", full, num)):
        check(r["launches"]["fused_chain"] == per_slice * n,
              f"{label} {name}: fused_chain launched {r['launches']['fused_chain']} times, "
              f"{per_slice} a slice over {n} slices")
    runs = 1 + min(2, num) + num
    for r in rows:
        r["launches"] *= runs
    got = complex(full["out"].reshape(-1)[0])
    t0 = time.perf_counter()
    oracle = TorchBackend(dtype="complex128", split_complex=False)
    ref = complex(contract_tensor_network(CompositeTensor([leaf.copy() for leaf in leaves]),
                                          ContractionPath.simple(pairs), oracle)
                  .data.into_data())
    ref_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    tol = 1e-4 * max(abs(ref), 2.0 ** -14)
    err = abs(got - ref)
    probe_s = probe["walls"][0] / min(2, num)
    print(f"[check] {label}: {got:.6e} vs complex128 of the flattened plan on the card "
          f"{ref:.6e} ({ref_s:.2f} s), |diff| {err:.3e} (gate {tol:.3e}); run(2) "
          f"{probe['walls'][0]:.4f} s ({probe_s:.4f} s a slice), run() {full['walls'][0]:.4f} "
          f"s over {num} slices ({full['walls'][0] / num:.4f} s a slice, CUDA events "
          f"{full['elapsed'][0]:.4f} s), peak {full['peak_bytes']} bytes; {per_slice} "
          f"fused_chain launches a slice", flush=True)
    check(math.isfinite(got.real) and math.isfinite(got.imag), f"{label}: non-finite sum")
    check(err <= tol, f"{label}: sum off complex128 by {err}")
    record = {"tensors": [len(raw), len(tn)], "blocks": [initial.count(b) for b in range(k)],
              "sa_round_scores": [s for _, s in round_scores], "sa_score": score,
              "parallel_cost": parallel, "serial_cost": serial, "plan_s": plan_s,
              "slices": num, "legs": list(slicing.legs), "per_slice_peak_elems": peak,
              "sliced_multiply_adds": madds, "probe_wall_s": probe["walls"][0],
              "probe_s_per_slice": probe_s, "wall_s": full["walls"][0],
              "elapsed_s": full["elapsed"][0], "s_per_slice": full["walls"][0] / num,
              "peak_bytes": full["peak_bytes"], "chains_per_slice": per_slice,
              "amplitude": [got.real, got.imag], "complex128": [ref.real, ref.imag],
              "abs_err": err}
    return {"label": label, "record": record, "launches": per_slice * runs, "rows": rows}


def spmd_share(rank: int, world: int, tn, path, slicing, label: str) -> dict:
    """This rank's run of ``distributed_sliced_contraction`` under the
    process group on ``cuda:0``: a warm-up of one slice a rank with each
    distinct chain held against its plain version, then the counted run
    over every slice (this rank's share, ``all_reduce``-d), whose launches
    the held rows weigh."""
    from tnc_tpu_torch.parallel import distributed_sliced_contraction

    rows: list = []
    with held_chains(f"{label} rank {rank}", rows, {}, 1):
        distributed_sliced_contraction(tn, path, slicing, max_slices=world, device="cuda:0")
    per_slice = sum(r["launches"] for r in rows)
    run = run_counted(lambda: distributed_sliced_contraction(tn, path, slicing, device="cuda:0"),
                      f"{label} rank {rank}", reps=1, warmup=lambda: None)
    chunk = slicing.num_slices // world
    launches = run["launches"]["fused_chain"]
    check(launches == per_slice * chunk > 0,
          f"{label} rank {rank}: fused_chain launched {launches} times, {per_slice} a slice "
          f"over {chunk} slices")
    for r in rows:
        r["launches"] *= chunk
    z = scalar(run["out"])
    return {"value": [z.real, z.imag], "launches": launches, "rows": rows,
            "wall_s": run["walls"][0], "elapsed_s": run["elapsed"][0],
            "peak_bytes": run["peak_bytes"], "slices": chunk}


def rank_spmd(rank: int, world: int, tn, path, slicing, label: str) -> dict:
    """Phase 17 (3), in its one rank of an NCCL group: :func:`spmd_share`."""
    return spmd_share(rank, world, tn, path, slicing, label)


def rank_pair(rank: int, world: int, ptn, ppath, tn, path, slicing, labels) -> dict:
    """Phase 17 (4), in each of two gloo ranks sharing ``cuda:0``: rank 0
    ``broadcast_path``s config #4's plan (the other rank passes an empty
    path); the process-sharded ``distributed_partitioned_contraction`` of
    it (each rank's chains held, one launch a call); :func:`spmd_share` of
    the m10 amplitude (64 slices a rank); everything gathered on rank 0
    with ``gather_objects``; then a gather that rank 1 withholds from,
    whose slot must come back ``GatherLost(1)`` after 2 s."""
    import torch

    from tnc_tpu_torch.contractionpath.contraction_path import ContractionPath
    from tnc_tpu_torch.ops.cuda_complex import LAUNCHES, reset_launches
    from tnc_tpu_torch.parallel.partitioned import (
        broadcast_path,
        distributed_partitioned_contraction,
        gather_objects,
    )

    qaoa_label, m10_label = labels
    got_path = broadcast_path(ppath if rank == 0 else ContractionPath.simple([]))
    rows: list = []
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with held_chains(f"{qaoa_label} rank {rank}", rows, {}, 1):
        out = distributed_partitioned_contraction(ptn, got_path, dtype="complex64",
                                                  device="cuda:0")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = LAUNCHES["fused_chain"]
    # a rank's partitions may hold no chain; the cell's launches are checked
    # over both ranks
    check(sum(r["launches"] for r in rows) == launches,
          f"{qaoa_label} rank {rank}: {sum(r['launches'] for r in rows)} fused_chain "
          f"launches on held chains, the path made {launches}")
    data = np.asarray(out.data.into_data())
    mine = {"path": path_obj(got_path), "qaoa": {"data": data, "launches": launches,
                                                 "rows": rows, "wall_s": wall},
            "m10": spmd_share(rank, world, tn, path, slicing, m10_label)}
    parts = gather_objects(mine, timeout_s=CHILD_TIMEOUT_S)
    if rank != 0:
        return {"gathered": None, "lost": None}
    t0 = time.perf_counter()
    lost = gather_objects(f"rank {rank}", timeout_s=2, missing_ok=True)
    return {"gathered": parts, "lost": lost, "lost_s": time.perf_counter() - t0}


RANK_TASKS = {"spmd": rank_spmd, "pair": rank_pair}


def rank_main(rank: int, world: int, port: int, prefix: str, backend_name: str, task: str,
              kwargs: dict, go, out_dir: str) -> None:
    """The entry point of one rank of phase 17's process groups, spawned by
    :class:`Ranks`: joins the group (``backend_name`` over the parent's
    ``TCPStore`` at ``port``, under ``prefix``), sets its communicator up
    with one collective, waits for the parent's ``go`` (its start-up
    overlaps the parent's work), runs ``task`` on ``cuda:0`` and writes what
    it returns to ``out_dir``."""
    import datetime
    import pickle

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    store = dist.PrefixStore(prefix, dist.TCPStore(
        "127.0.0.1", port, is_master=False,
        timeout=datetime.timedelta(seconds=CHILD_TIMEOUT_S)))
    dist.init_process_group(backend_name, store=store, rank=rank, world_size=world)
    try:
        # set the communicator up before the gate (NCCL builds it at the
        # first collective, seconds), so the timed work after it is the task's
        from tnc_tpu_torch.parallel.partitioned import rank_device

        dist.all_reduce(torch.zeros(1, device=rank_device("cuda:0")))
        torch.cuda.synchronize()
        check(go.wait(CHILD_TIMEOUT_S), f"{prefix} rank {rank}: never told to start")
        out = RANK_TASKS[task](rank, world, **kwargs)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{prefix.strip('/')}-{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


class Ranks:
    """The ``world`` spawned processes of one process group on the card
    (:func:`rank_main`), started at once and held at a gate until
    :meth:`finish`. A rank that exits non-zero, or outlives
    ``CHILD_TIMEOUT_S`` after the gate opens, fails the run: every rank of
    the group is killed first."""

    def __init__(self, ctx, world: int, port: int, prefix: str, backend_name: str, task: str,
                 kwargs_of, out_dir: str):
        self.prefix, self.out_dir = prefix, out_dir
        self.go = ctx.Event()
        self.procs = [ctx.Process(target=rank_main, args=(
            rank, world, port, prefix, backend_name, task, kwargs_of(rank), self.go, out_dir))
            for rank in range(world)]
        for p in self.procs:
            p.start()

    def kill(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(30)

    def finish(self, exits: tuple | None = None) -> tuple[list, float]:
        """Open the gate, wait for every rank; their results (``None`` for a
        rank whose expected exit code in ``exits`` is not 0) and the seconds
        from the gate to the last exit. ``exits``: each rank's expected exit
        code (default 0 for all); any other code fails the run."""
        import pickle

        t0 = time.perf_counter()
        self.go.set()
        for p in self.procs:
            p.join(max(CHILD_TIMEOUT_S - (time.perf_counter() - t0), 1.0))
        seconds = time.perf_counter() - t0
        hung = [rank for rank, p in enumerate(self.procs) if p.is_alive()]
        self.kill()
        codes = [p.exitcode for p in self.procs]
        check(not hung, f"{self.prefix}: ranks {hung} still running {CHILD_TIMEOUT_S} s "
              f"after the start (killed)")
        want = list(exits) if exits is not None else [0] * len(self.procs)
        check(codes == want, f"{self.prefix}: ranks exited {codes}, expected {want}")
        out = []
        for rank in range(len(self.procs)):
            if want[rank] != 0:
                out.append(None)
                continue
            with open(os.path.join(self.out_dir, f"{self.prefix.strip('/')}-{rank}.pkl"),
                      "rb") as f:
                out.append(pickle.load(f))
        return out, seconds


def run_parallel(cells: dict, m10: dict) -> dict:
    """Phase 17: the multi-GPU executors on the one card —
    :func:`treecut_distributed`, :func:`config5`, then two spawned process
    groups on ``cuda:0``, started at the phase's start so that their
    start-up overlaps (1) and (2): (3) phase 8's m10 amplitude through
    ``distributed_sliced_contraction`` in one rank of an NCCL group, all
    128 slices, within 1e-4·Σ_s|ref_s| of phase 8's complex128 slices; (4)
    two gloo ranks (:func:`rank_pair`): the broadcast path, the
    process-sharded config #4 ⟨Z…Z⟩ (the same bits on both ranks, within
    1e-5 absolute and 1e-3 relative of complex128), the m10 amplitude over
    the two ranks (bitwise equal on both, within that gate of (3)'s value
    and 1e-4·Σ_s|ref_s| of complex128), and ``GatherLost(1)``. Every
    ``fused_chain`` launch of every path, the ranks' included, is held
    against its plain version; the ranks' rows come back through
    ``gather_objects`` and their results files."""
    import multiprocessing
    import tempfile

    import torch
    import torch.distributed as dist

    t_phase = time.perf_counter()
    refs = sliced_refs(m10)
    m10_ref, m10_abs = sum(refs), sum(abs(r) for r in refs)
    qaoa = cells["qaoa"]
    qubits, depth = SLICED[:2]
    spmd_label = f"sycamore{qubits}_m{depth}_spmd"
    pair_labels = (f"qaoa{QAOA[0]}_p{QAOA[1]}_partitioned_2ranks",
                   f"sycamore{qubits}_m{depth}_spmd_2ranks")
    sliced = {"tn": m10["tn"], "path": m10["path"], "slicing": m10["slicing"]}
    ctx = multiprocessing.get_context("spawn")
    server = dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False)
    groups = []
    with tempfile.TemporaryDirectory() as out_dir:
        try:
            nccl = Ranks(ctx, 1, server.port, "nccl/", "nccl", "spmd",
                         lambda r: {**sliced, "label": spmd_label}, out_dir)
            groups.append(nccl)
            pair = Ranks(ctx, 2, server.port, "gloo/", "gloo", "pair",
                         lambda r: {"ptn": qaoa["ptn"],
                                    "ppath": qaoa["ppath"] if r == 0 else None,
                                    **sliced, "labels": pair_labels}, out_dir)
            groups.append(pair)
            cut = treecut_distributed(cells["treecut"])
            cfg5 = config5()
            torch.cuda.empty_cache()
            (spmd,), spmd_s = nccl.finish()
            (pair0, _), pair_s = pair.finish()
        finally:
            for group in groups:
                group.kill()

    z = complex(*spmd["value"])
    err = abs(z - m10_ref)
    print(f"[check] {spmd_label}: one NCCL rank, {spmd['slices']} slices in "
          f"{spmd['wall_s']:.4f} s (CUDA events {spmd['elapsed_s']:.4f} s, peak "
          f"{spmd['peak_bytes']} bytes): {z!r} vs complex128 {m10_ref!r}, |diff| {err:.3e} "
          f"(gate 1e-4 x sum|ref_s| = {1e-4 * m10_abs:.3e}); the rank took {spmd_s:.1f} s "
          f"from the start", flush=True)
    check(err <= 1e-4 * m10_abs, f"{spmd_label}: amplitude off complex128 by {err}")

    ranks = pair0["gathered"]
    qaoa_label, pair_m10_label = pair_labels
    check(ranks[0]["path"] == ranks[1]["path"] == path_obj(qaoa["ppath"]),
          f"{qaoa_label}: broadcast_path gave rank 1 another path")
    check(np.array_equal(ranks[0]["qaoa"]["data"], ranks[1]["qaoa"]["data"]),
          f"{qaoa_label}: the ranks' values differ")
    zq = complex(ranks[0]["qaoa"]["data"].reshape(-1)[0])
    qaoa_err = hold_value(f"{qaoa_label} (process-sharded over 2 gloo ranks)", zq, qaoa["ref"])
    values = [complex(*r["m10"]["value"]) for r in ranks]
    check(values[0] == values[1], f"{pair_m10_label}: the ranks' sums differ: {values}")
    z2 = values[0]
    err2, gap = abs(z2 - m10_ref), abs(z2 - z)
    print(f"[check] {pair_m10_label}: {[r['m10']['slices'] for r in ranks]} slices a rank in "
          f"{[round(r['m10']['wall_s'], 4) for r in ranks]} s, the ranks bitwise equal: "
          f"{z2!r}; vs complex128 |diff| {err2:.3e} (gate {1e-4 * m10_abs:.3e}); vs the NCCL "
          f"rank's |diff| {gap:.3e} (gates 1e-5, 1e-3 x |value| = {1e-3 * abs(z):.3e}); "
          f"the group took {pair_s:.1f} s from the start", flush=True)
    check(err2 <= 1e-4 * m10_abs, f"{pair_m10_label}: amplitude off complex128 by {err2}")
    check(gap <= 1e-5 and gap <= 1e-3 * abs(z),
          f"{pair_m10_label}: amplitude off the NCCL rank's by {gap}")
    from tnc_tpu_torch.parallel.partitioned import GatherLost

    print(f"[check] gather_objects with rank 1 withholding (timeout 2 s, missing_ok): "
          f"{pair0['lost']} in {pair0['lost_s']:.2f} s", flush=True)
    check(pair0["lost"] == ["rank 0", GatherLost(1)],
          f"gather_objects gave {pair0['lost']}, not ['rank 0', GatherLost(1)]")

    seconds = time.perf_counter() - t_phase
    print(f"[parallel] phase 17 in {seconds:.1f} s", flush=True)
    launches = {cut["label"]: cut["launches"], cfg5["label"]: cfg5["launches"],
                spmd_label: spmd["launches"],
                qaoa_label: sum(r["qaoa"]["launches"] for r in ranks),
                pair_m10_label: sum(r["m10"]["launches"] for r in ranks)}
    rows = {cut["label"]: cut["rows"], cfg5["label"]: cfg5["rows"], spmd_label: spmd["rows"],
            qaoa_label: [row for r in ranks for row in r["qaoa"]["rows"]],
            pair_m10_label: [row for r in ranks for row in r["m10"]["rows"]]}
    check(all(sum(r["launches"] for r in rows[k]) == n > 0 for k, n in launches.items()),
          f"phase 17: a cell's held launches differ from its count, or it launched no "
          f"fused_chain: {launches}")
    record = {
        cut["label"]: cut["record"], cfg5["label"]: cfg5["record"],
        spmd_label: {k: spmd[k] for k in ("value", "launches", "wall_s", "elapsed_s",
                                          "peak_bytes", "slices")}
        | {"abs_err": err, "complex128": [m10_ref.real, m10_ref.imag], "seconds": spmd_s},
        qaoa_label: {"value": [zq.real, zq.imag], "abs_err": qaoa_err,
                     "launches": launches[qaoa_label],
                     "wall_s": [r["qaoa"]["wall_s"] for r in ranks]},
        pair_m10_label: {"value": [z2.real, z2.imag], "abs_err": err2, "gap_to_nccl": gap,
                         "wall_s": [r["m10"]["wall_s"] for r in ranks],
                         "slices": [r["m10"]["slices"] for r in ranks], "seconds": pair_s},
        "gather_lost_s": pair0["lost_s"], "seconds": seconds}
    return {"record": record, "chain_launches": launches, "chain_rows": rows}


# --- phase 18: the fleet on one card -------------------------------------------


def fleet_bind(cache_dir: str):
    """Phase 14's two Sycamore-53 depth-8 programs bound through the plan
    cache in ``cache_dir``: the serving plan (``from_circuit``'s) and the
    sliced one at ``2**CKPT_TARGET`` (128 slices). Returns both and the
    cache."""
    from tnc_tpu_torch.serve import PlanCache, bind_circuit

    cache = PlanCache(cache_dir)
    bound = bind_circuit(sycamore(SWEEP), plan_cache=cache)
    sliced = bind_circuit(sycamore(SWEEP), "0" * SWEEP[0], plan_cache=cache,
                          target_size=2.0 ** CKPT_TARGET)
    return bound, sliced, cache


def wait_roster(registry, pred, what: str, timeout_s: float = 60.0) -> float:
    """Poll ``registry.roster()`` until ``pred(rows by name)`` holds; the
    seconds it took. Fails the run past ``timeout_s``."""
    t0 = time.perf_counter()
    while True:
        rows = {r["name"]: r for r in registry.roster()["replicas"]}
        if pred(rows):
            return time.perf_counter() - t0
        check(time.perf_counter() - t0 < timeout_s, f"phase 18: {what} within {timeout_s} s")
        time.sleep(0.05)


def fleet_scheduling(bound, backend, rows: list[str]) -> dict:
    """Phase 18 (f) on rank 0: a local service under ``enable_elastic``
    (tenant weights a 2, b 1; tenant b's quota 3), one request a batch. A
    request held in dispatch by a slow ``serve.dispatch`` fault, then tenant
    traffic queued behind it and a priority-1 request last: b's fourth is
    rejected at admission (``TenantQuotaError``); the rest dispatch in the
    order that taking ``weighted_fair_order``'s first of what is queued
    gives, the priority request first. Nothing is preempted: a
    ``TorchBackend`` has no slice hooks."""
    from tnc_tpu_torch.resilience import faults
    from tnc_tpu_torch.serve import ContractionService, ElasticConfig, TenantQuotaError
    from tnc_tpu_torch.serve import elastic

    weights = {"a": 2.0, "b": 1.0}
    queued = [("b", 0, rows[1]), ("b", 0, rows[2]), ("b", 0, rows[3]), ("a", 0, rows[4]),
              ("a", 0, rows[5]), ("c", 1, rows[6])]
    done, futs = [], []
    before = elastic.counters().get("preempted", 0)
    svc = ContractionService(bound, backend=backend, max_batch=1, max_wait_ms=0)
    svc.enable_elastic(ElasticConfig(tenant_weights=weights, tenant_quotas={"b": 3}))
    with faults("serve.dispatch=slow:1.0*1"), svc:
        first = svc.submit(rows[0], tenant="a")
        time.sleep(0.3)  # the first request is in dispatch, asleep
        for i, (tenant, prio, bits) in enumerate(queued):
            futs.append(svc.submit(bits, tenant=tenant, priority=prio))
            futs[-1].add_done_callback(lambda _f, i=i: done.append(i))
        try:
            svc.submit(rows[7], tenant="b")
            rejected = False
        except TenantQuotaError:
            rejected = True
        tenants = svc.stats()["elastic"]["tenants"]
        answers = [f.result(timeout=600) for f in [first] + futs]
        stats = svc.stats()
    expect, left = [], list(range(len(queued)))
    while left:  # the window takes the first of a fresh order each batch
        pick = elastic.weighted_fair_order([queued[i] for i in left], lambda q: q[0],
                                           lambda q: q[1], weights=weights)[0]
        expect.append(left.pop(pick))
    return {"order": done, "expect": expect, "rejected": rejected, "tenants": tenants,
            "answers": answers, "bits": [rows[0]] + [q[2] for q in queued],
            "counts": stats["counts"],
            "preempted": elastic.counters().get("preempted", 0) - before}


def fleet_root(bound, sliced, backend, rows: list[str], fleet_dir: str) -> dict:
    """Rank 0 of phase 18: (b) the sliced program through a frozen
    ``ClusterDispatcher`` (64 slices a rank); (a) a service over the serving
    program with a roster-aware dispatcher, ``attach_fleet`` and
    ``serve_telemetry``, ``FLEET_ROUNDS`` rounds of phase 14's rows, then
    its ``/fleet`` view (d); (e) a second service over a new dispatcher
    once rank 1 parks again: the round in which rank 1 dies (its slot
    ``GatherLost``, its rows recomputed here, the process lost for good),
    then, once the roster also reads its heartbeat stale, a round with no
    range for it (given because it is lost; a live process placed out by
    its stale heartbeat alone is a CPU test's case,
    ``tests/test_torch_elastic.py``); (f) :func:`fleet_scheduling`.
    Every dispatch is logged: its sequence, riders, bits, ranges, rows and
    seconds."""
    from tnc_tpu_torch.obs.fleet import FleetRegistry, current_dispatch_context
    from tnc_tpu_torch.serve import ClusterDispatcher, ContractionService
    from tnc_tpu_torch.serve import elastic

    log: list = []

    class Recording(ClusterDispatcher):
        def __call__(self, bound, bits, backend=None):
            t0 = time.perf_counter()
            out = super().__call__(bound, bits, backend)
            ctx = current_dispatch_context()
            log.append({"stage": self.stage, "seq": self._seq,
                        "riders": ctx.riders if ctx is not None else "", "bits": list(bits),
                        "ranges": self.last_ranges, "out": np.asarray(out),
                        "s": time.perf_counter() - t0})
            return out

    def dispatcher(stage: str):
        d = Recording(registry=FleetRegistry(fleet_dir, stale_after_s=FLEET_STALE_S),
                      timeout_s=FLEET_TIMEOUT_S)
        d.stage = stage
        return d

    # a reader of the roster (it never heartbeats)
    watch = FleetRegistry(fleet_dir, name="watch", stale_after_s=FLEET_STALE_S)

    def service(d):
        svc = ContractionService(bound, backend=backend, dispatcher=d, max_batch=SERVE_BATCH,
                                 max_wait_ms=20).start()
        tel = svc.serve_telemetry(port=0)
        svc.attach_fleet(directory=fleet_dir, heartbeat_s=FLEET_HEARTBEAT_S,
                         stale_after_s=FLEET_STALE_S)
        return svc, tel

    def requests(r):
        return [lambda s, b=b: s.submit(b) for b in round_bits(rows, r)]

    out: dict = {}
    # (b) slices: a frozen fleet, the sliced program's two bitstrings
    d1 = Recording()
    d1.stage = "slices"
    sbits = [sliced.template.request_bits(b) for b in rows[:2]]
    out["slices"] = d1(sliced, sbits, backend)
    d1.stop()

    # (a) bras rounds, (d) the federated view
    d2 = dispatcher("bras")
    svc, tel = service(d2)
    try:
        out["join_s"] = wait_roster(watch, lambda r: r.get("p1", {}).get("state") == "live",
                                    "rank 1 on the roster")
        out["answers"] = []
        for r in range(FLEET_ROUNDS):
            out["answers"].append(submit_round(svc, requests(r)))
        # the worker counts a batch just after it hands its rows over: read
        # the federated view until it has counted every batch it served
        served = len(log)
        key = "tnc_tpu_serve_cluster_worker_batches_total"
        t0 = time.perf_counter()
        while True:
            out["view"] = json.loads(http_get(tel.url + "/fleet"))
            if (out["view"]["counters"].get(key) == served
                    or time.perf_counter() - t0 > 10.0):
                break
            time.sleep(0.1)
        out["bras_stats"] = svc.stats()
    finally:
        svc.stop()
        d2.stop()

    # (e) worker loss: rank 1 parks again (its progress back at 0 batches)
    d3 = dispatcher("loss")
    svc, tel = service(d3)
    try:
        wait_roster(watch, lambda r: r.get("p1", {}).get("state") == "live"
                    and r["p1"]["payload"].get("batches_served") == 0, "rank 1 parked again")
        before = elastic.counters().get("reassigned", 0)
        out["loss_answers"] = submit_round(svc, requests(FLEET_ROUNDS))
        out["reassigned"] = elastic.counters().get("reassigned", 0) - before
        out["lost"] = sorted(d3.lost)
        out["stale_wait_s"] = wait_roster(
            watch, lambda r: r.get("p1", {}).get("state") == "stale", "rank 1 stale")
        out["after_answers"] = submit_round(svc, requests(FLEET_ROUNDS + 1))
        out["reassigned_after"] = elastic.counters().get("reassigned", 0) - before
        out["loss_stats"] = svc.stats()
    finally:
        svc.stop()
        d3.stop()
    out["log"] = log

    # (f) elastic scheduling on this rank alone
    out["scheduling"] = fleet_scheduling(bound, backend, rows)
    return out


def fleet_oracle(bound, backend, log: list) -> list:
    """Each logged bras dispatch against one process's ``amplitudes_det`` of
    the same shards (its ranges, or the even split) on ``backend``: whether
    its rows are bitwise those, and their largest difference."""
    from tnc_tpu_torch.serve import shard_ranges

    checked = []
    for entry in log:
        if entry["stage"] == "slices":
            continue
        ranges = entry["ranges"] or shard_ranges(len(entry["bits"]), 2)
        parts = [bound.amplitudes_det(entry["bits"][lo:hi], backend)
                 for lo, hi in ranges if hi > lo]
        want = np.concatenate(parts)
        got = entry["out"]
        checked.append({"seq": entry["seq"], "stage": entry["stage"],
                        "bitwise": got.dtype == want.dtype and got.tobytes() == want.tobytes(),
                        "max_diff": float(np.max(np.abs(got - want)))})
    return checked


def rank_fleet(rank: int, world: int, cache_dir: str, fleet_dir: str, flight_dir: str,
               out_dir: str, rows: list, label: str) -> dict:
    """Phase 18, in each of two gloo ranks sharing ``cuda:0``: both bind
    phase 14's programs through the parent's plan cache (hits, no planner
    call) on one ``TorchBackend`` whose sliced runs are eager; each holds
    the chains of a round's two shards in a warm-up, then runs the fleet
    with every ``fused_chain`` launch held (:func:`held_chains`). Rank 0:
    :func:`fleet_root`, then :func:`fleet_oracle` of its dispatches. Rank
    1 (``TNC_TPU_FLIGHT_RECORDER`` set): ``serve_cluster`` of the sliced
    program, then of the serving program (registry, telemetry), writes its
    record to ``out_dir``, and parks a third time under a ``kill`` rule at
    ``cluster.broadcast(side=worker)``: the next command SIGKILLs it."""
    import torch

    from tnc_tpu_torch import obs
    from tnc_tpu_torch.obs.core import MetricsRegistry
    from tnc_tpu_torch.ops.backends import TorchBackend
    from tnc_tpu_torch.ops.cuda_complex import LAUNCHES, reset_launches
    from tnc_tpu_torch.resilience import faults
    from tnc_tpu_torch.serve import serve_cluster

    obs.configure(enabled=True, registry=MetricsRegistry())
    if rank == 1:
        os.environ["TNC_TPU_FLIGHT_RECORDER"] = flight_dir
        os.environ["TNC_TPU_FLIGHT_INTERVAL"] = "0.25"
        obs.refresh_from_env()
    t0 = time.perf_counter()
    bound, sliced, cache = fleet_bind(cache_dir)
    bind_s = time.perf_counter() - t0
    planned = sum(1 for r in obs.get_registry().span_records() if r.name.startswith("plan."))
    cache_counts = dict(cache.stats()["counts"])
    backend = TorchBackend()
    backend.execute_sliced = functools.partial(backend.execute_sliced, graphs=False)
    held, seen = [], {}
    unique = round_bits(rows, 0)[1:]
    with held_chains(f"{label} rank {rank}", held, seen, 0):
        for lo, hi in ((0, 4), (4, len(unique))):
            bound.amplitudes_det(unique[lo:hi], backend)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    record = {"bind_s": bind_s, "planned": planned, "cache": cache_counts,
              "policy_key": repr(backend.policy_key()), "obs_enabled": obs.enabled()}
    t0 = time.perf_counter()
    with held_chains(f"{label} rank {rank}", held, seen, 1):
        if rank == 0:
            record.update(fleet_root(bound, sliced, backend, rows, fleet_dir))
        else:
            record["served"] = [serve_cluster(sliced, backend),
                                serve_cluster(bound, backend, plan_cache=cache,
                                              fleet_dir=fleet_dir, telemetry_port=0,
                                              heartbeat_s=FLEET_HEARTBEAT_S)]
    torch.cuda.synchronize()
    record.update({"run_s": time.perf_counter() - t0, "launches": LAUNCHES["fused_chain"],
                   "rows": held, "peak_bytes": torch.cuda.max_memory_allocated()})
    if rank == 0:
        record["oracle"] = fleet_oracle(bound, backend, record["log"])
        for entry in record["log"]:
            entry["out"] = entry["out"].tolist() if entry["stage"] == "slices" else None
        return record
    import pickle

    record["spans"] = [(r.name, dict(r.args)) for r in obs.get_registry().span_records()
                       if r.name == "serve.dispatch"]
    with open(os.path.join(out_dir, "fleet-1-record.pkl"), "wb") as f:
        pickle.dump(record, f)
    with faults("cluster.broadcast(side=worker)=kill*1"):
        serve_cluster(bound, backend, plan_cache=cache, fleet_dir=fleet_dir,
                      heartbeat_s=FLEET_HEARTBEAT_S)
    fail("phase 18: rank 1 outlived its kill rule")


RANK_TASKS["fleet"] = rank_fleet


def flight_dump(flight_dir: str) -> dict:
    """Rank 1's flight-recorder dump (``flight-p1-<pid>.json``), parsed."""
    import glob

    files = glob.glob(os.path.join(flight_dir, "flight-p1-*.json"))
    check(len(files) == 1, f"phase 18: flight dumps {os.listdir(flight_dir)}")
    with open(files[0], encoding="utf-8") as fh:
        return json.load(fh)


def fleet_refs(rows: list[str]) -> tuple[dict, np.ndarray]:
    """What phase 18 holds its answers to when it runs alone: the complex128
    amplitude of each row it serves (as phase 14 makes them) and phase
    14's uninterrupted value of the sliced cell's two bitstrings."""
    from tnc_tpu_torch.ops.backends import TorchBackend
    from tnc_tpu_torch.serve import bind_circuit

    need = rows[:(FLEET_ROUNDS + 2) * (SERVE_BATCH - 1)]
    refs = complex128_amps(bind_circuit(sycamore(SWEEP)), need)
    sliced = bind_circuit(sycamore(SWEEP), "0" * SWEEP[0], target_size=2.0 ** CKPT_TARGET)
    return refs, sliced.amplitudes(rows[:2], TorchBackend())


def run_fleet(refs: dict, sliced_clean) -> dict:
    """Phase 18: the fleet on one card. Two gloo ranks sharing ``cuda:0``
    over a ``TCPStore`` the parent opens (:func:`rank_fleet`), started at
    the phase's start while the parent plans phase 14's two programs into a
    plan cache both ranks bind from. The gates: (a) bras mode, every row of
    every dispatch bitwise one process's ``amplitudes_det`` of the same
    shards, and within phase 14's gate of complex128, the ranks on one
    ``policy_key``; (b) slices mode, the two ranks' range partials summed
    in range order within phase 14's gate of its uninterrupted value; (c)
    rank 1's ``serve.dispatch`` spans carry rank 0's riders and sequence,
    also in its flight-recorder dump; (d) rank 0's ``/fleet`` lists both
    replicas live and its merged ``serve.cluster.worker_batches`` equals
    the batches rank 1 served; (e) rank 1 SIGKILLed on a command: its slot
    lost, its rows recomputed bitwise, one ``serve.elastic.reassigned``, no
    request failed; the next round gives the lost process ``(0, 0)`` and
    does not wait (the roster reads it stale by then, but the lost set
    alone gives that range); (f) :func:`fleet_scheduling`. Every
    ``fused_chain`` launch of both ranks held against its plain version;
    the two ranks' peaks together within the card."""
    import multiprocessing
    import pickle
    import tempfile

    import torch
    import torch.distributed as dist

    t_phase = time.perf_counter()
    qubits, depth, _ = SWEEP
    label = f"sycamore{qubits}_m{depth}_cluster"
    rows = serve_rows()
    ctx = multiprocessing.get_context("spawn")
    server = dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False)
    with tempfile.TemporaryDirectory() as work:
        dirs = {name: os.path.join(work, name) for name in ("plans", "fleet", "flight", "out")}
        for d in dirs.values():
            os.makedirs(d)
        ranks = Ranks(ctx, 2, server.port, "fleet/", "gloo", "fleet", lambda r: {
            "cache_dir": dirs["plans"], "fleet_dir": dirs["fleet"],
            "flight_dir": dirs["flight"], "out_dir": dirs["out"], "rows": rows,
            "label": label}, dirs["out"])
        try:
            t0 = time.perf_counter()
            num = fleet_bind(dirs["plans"])[1].sliced.slicing.num_slices
            plan_s = time.perf_counter() - t0
            (root, _), ranks_s = ranks.finish(exits=(0, -9))
        finally:
            ranks.kill()
        with open(os.path.join(dirs["out"], "fleet-1-record.pkl"), "rb") as f:
            work1 = pickle.load(f)
        flight = flight_dump(dirs["flight"])

    # neither rank planned; both on one kernel policy
    for rank, rec in enumerate((root, work1)):
        check(rec["planned"] == 0 and rec["cache"].get("hit") == 2 and not rec["cache"].get("miss"),
              f"{label}: rank {rank} planned {rec['planned']} times, cache {rec['cache']}")
    check(root["policy_key"] == work1["policy_key"],
          f"{label}: the ranks plan other kernel policies: {root['policy_key']} vs "
          f"{work1['policy_key']}")
    check(work1["obs_enabled"], f"{label}: the flight recorder left rank 1's spans off")

    # (a) bras: bitwise one process of the same shards, and within the gate
    bras = [c for c in root["oracle"] if c["stage"] == "bras"]
    check(len(bras) >= FLEET_ROUNDS and all(c["bitwise"] for c in root["oracle"]),
          f"{label}: a dispatch's rows differ from one process's: {root['oracle']}")
    err = 0.0
    for r, got in enumerate(root["answers"]):
        check(not any(isinstance(a, Exception) for a in got), f"{label}: a request failed")
        err = max(err, hold_amps(f"{label} round {r}", got, round_bits(rows, r), refs))

    # (b) slices: the range partials' sum against phase 14's uninterrupted run
    slices = np.asarray(root["slices"])
    clean = np.asarray(sliced_clean)
    s_err = float(np.max(np.abs(slices - clean)))
    s_scale = float(np.max(np.abs(clean)))
    check(slices.shape == clean.shape and np.all(np.isfinite(slices)) and s_err <= 1e-4 * s_scale,
          f"{label} slices: off phase 14's uninterrupted value by {s_err} (gate 1e-4 x {s_scale})")
    sliced_log = [e for e in root["log"] if e["stage"] == "slices"]
    check(sliced_log[0]["ranges"] is None and work1["served"][0] == 1,
          f"{label} slices: {sliced_log}, rank 1 served {work1['served']}")

    # (c) trace propagation: rank 1's spans wear the root's riders and sequence
    sent = {(e["stage"], e["seq"]): e["riders"] for e in root["log"] if e["stage"] == "bras"}
    remote = [a for name, a in work1["spans"] if a.get("remote") == 1]
    got_bras = {a["seq"]: a["riders"] for a in remote if a.get("kind") == "amplitude"}
    check(got_bras == {seq: riders for (_, seq), riders in sent.items()},
          f"{label}: rank 1's dispatch spans carry {got_bras}, the root sent {sent}")
    # the dump's ring holds the most recent spans: the last round's at least
    flown = {s["args"].get("seq"): s["args"].get("riders") for s in flight["spans"]
             if s["name"] == "serve.dispatch" and s["args"].get("remote") == 1
             and s["args"].get("kind") == "amplitude"}
    check(max(got_bras) in flown and all(got_bras.get(k) == v for k, v in flown.items()),
          f"{label}: rank 1's flight dump holds {flown}, its spans {got_bras}")

    # (d) the federated view while both lived
    view = root["view"]
    key = "tnc_tpu_serve_cluster_worker_batches_total"
    roster = {r["name"]: r["state"] for r in view["roster"]["replicas"]}
    served = work1["served"][0] + work1["served"][1]
    check(view["enabled"] and roster == {"p0": "live", "p1": "live"} and not view["unreachable"],
          f"{label}: /fleet roster {roster}, unreachable {view['unreachable']}")
    check(view["counters"].get(key) == served == 1 + len(bras),
          f"{label}: /fleet sums {view['counters'].get(key)} worker batches, rank 1 served "
          f"{work1['served']}, the root dispatched {1 + len(bras)}")

    # (e) worker loss
    loss = [e for e in root["log"] if e["stage"] == "loss"]
    check(len(loss) == 2, f"{label}: {len(loss)} dispatches after the loss, expected 2")
    kill, after = loss
    n = len(after["bits"])
    check(root["lost"] == [1] and root["reassigned"] == 1 and root["reassigned_after"] == 1,
          f"{label}: lost {root['lost']}, reassigned {root['reassigned']} then "
          f"{root['reassigned_after']}")
    check(kill["ranges"] == [(0, 4), (4, n)] and after["ranges"] == [(0, n), (0, 0)],
          f"{label}: ranges {kill['ranges']} then {after['ranges']}")
    check(after["s"] < FLEET_TIMEOUT_S <= kill["s"],
          f"{label}: the round after the loss took {after['s']:.3f} s, the lost one "
          f"{kill['s']:.3f} s (gather bound {FLEET_TIMEOUT_S} s)")
    for name, got, r in (("loss", root["loss_answers"], FLEET_ROUNDS),
                         ("after", root["after_answers"], FLEET_ROUNDS + 1)):
        check(not any(isinstance(a, Exception) for a in got), f"{label} {name}: a request failed")
        hold_amps(f"{label} {name}", got, round_bits(rows, r), refs)
    check(root["loss_stats"]["counts"]["failed"] == 0 and root["bras_stats"]["counts"]["failed"] == 0,
          f"{label}: failed requests {root['loss_stats']['counts']}")
    check(flight["name"] == "p1" and flight["spans"], f"{label}: rank 1's flight dump is empty")

    # (f) elastic scheduling
    sched = root["scheduling"]
    check(sched["rejected"] and sched["tenants"] == {"b": 3, "a": 2, "c": 1},
          f"{label} scheduling: quota rejection {sched['rejected']}, queue {sched['tenants']}")
    check(sched["order"] == sched["expect"] and sched["expect"][0] == 5,
          f"{label} scheduling: dispatched {sched['order']}, weighted_fair_order gives "
          f"{sched['expect']}")
    check(sched["preempted"] == 0 and sched["counts"]["failed"] == 0,
          f"{label} scheduling: preempted {sched['preempted']}, {sched['counts']}")
    hold_amps(f"{label} scheduling", sched["answers"], sched["bits"], refs)

    # every launch of both ranks on a held chain; both ranks fit the card
    for rank, rec in enumerate((root, work1)):
        check_held(f"{label} rank {rank}", rec["rows"], rec["launches"])
    launches = root["launches"] + work1["launches"]
    card = torch.cuda.get_device_properties(0).total_memory
    peaks = [root["peak_bytes"], work1["peak_bytes"]]
    check(sum(peaks) <= card, f"{label}: the ranks' peaks {peaks} exceed the card's {card}")

    seconds = time.perf_counter() - t_phase
    print(f"[{label}] two gloo ranks on cuda:0, one plan cache (planned in the parent in "
          f"{plan_s:.2f} s; the ranks bound it in {root['bind_s']:.2f} and "
          f"{work1['bind_s']:.2f} s, caches {root['cache']} / {work1['cache']}, 0 planner "
          f"calls), policy_key equal {root['policy_key']}", flush=True)
    print(f"[check] {label} (a) bras: {len(bras)} dispatches of {FLEET_ROUNDS} rounds over 2 "
          f"ranks, every row bitwise one process's amplitudes_det of its shard "
          f"({[c['max_diff'] for c in bras]}); max|amp - complex128| {err:.3e}", flush=True)
    print(f"[check] {label} (b) slices: {num // 2} slices a rank, range partials summed: |sum - "
          f"phase 14's uninterrupted| {s_err:.3e} (gate {1e-4 * s_scale:.3e}) in "
          f"{sliced_log[0]['s']:.3f} s", flush=True)
    print(f"[check] {label} (c) rank 1's serve.dispatch spans carry the root's riders and "
          f"seq {got_bras}; its flight dump ({flight['reason']}, {len(flight['spans'])} spans) "
          f"holds them", flush=True)
    print(f"[check] {label} (d) /fleet: roster {roster}, {key} {view['counters'].get(key)} = "
          f"batches rank 1 served {work1['served']}; rank 1 joined in {root['join_s']:.2f} s",
          flush=True)
    print(f"[check] {label} (e) rank 1 SIGKILLed on command {kill['seq']}: GatherLost, lost "
          f"{root['lost']}, reassigned {root['reassigned']}, rows bitwise; the round took "
          f"{kill['s']:.3f} s (gather bound {FLEET_TIMEOUT_S} s); its heartbeat stale "
          f"after {root['stale_wait_s']:.2f} s more; the next round {after['ranges']} (rank "
          f"1 lost) in {after['s']:.3f} s; no request failed", flush=True)
    print(f"[check] {label} (f) tenant b's 4th rejected {sched['rejected']}; dispatch order "
          f"{sched['order']} = weighted_fair_order {sched['expect']} (priority 1 first); not "
          f"preempted: TorchBackend has no slice hooks (preempted +{sched['preempted']})",
          flush=True)
    print(f"[{label}] fused_chain {launches} launches ({root['launches']} + "
          f"{work1['launches']}), all on held chains; max_memory_allocated {peaks} bytes "
          f"(together {sum(peaks)} of {card}); ranks {ranks_s:.1f} s from the gate", flush=True)
    print(f"[fleet] phase 18 in {seconds:.1f} s", flush=True)
    record = {"plan_s": plan_s, "bind_s": [root["bind_s"], work1["bind_s"]],
              "policy_key": root["policy_key"], "bras_dispatches": len(bras),
              "max_abs_err": err, "slices": num, "slices_abs_err": s_err,
              "slices_s": sliced_log[0]["s"],
              "trace": {str(k): v for k, v in got_bras.items()},
              "worker_batches": view["counters"].get(key), "join_s": root["join_s"],
              "kill_round_s": kill["s"], "stale_wait_s": root["stale_wait_s"],
              "after_round_s": after["s"], "after_ranges": after["ranges"],
              "reassigned": root["reassigned"], "scheduling_order": sched["order"],
              "launches": [root["launches"], work1["launches"]], "peak_bytes": peaks,
              "run_s": [root["run_s"], work1["run_s"]], "ranks_s": ranks_s,
              "seconds": seconds}
    rows_held = root["rows"] + work1["rows"]
    return {"record": record, "chain_launches": {label: launches},
            "chain_rows": {label: rows_held}}


def qasm_text(name: str, qubits: int, rounds: int) -> str:
    """An OpenQASM 2.0 circuit on the Sycamore layout's couplers: an H layer
    by register broadcast, then ``rounds - 1`` rounds placed as
    ``random_circuit`` places them, from ``default_rng(QASM_SEED)`` in its
    order (a single-qubit gate with probability ``QASM_P1`` on each qubit,
    then a two-qubit gate with probability ``QASM_P2`` on each coupler), with
    a ``barrier`` between the two. The gates' kinds and angles come from
    ``default_rng(QASM_SEED + 1)``: ``sx``, ``sy``, and for the third choice
    ``t`` from the registry, a parameterised ``u3`` from qelib1, or the user
    gate ``zxz``, whose body folds parameter expressions; ``fsim`` at fixed
    angles or ``cz`` on a coupler. Angles are written exactly (``repr``), so
    both packages import the same network from the text."""
    from tnc_tpu_torch.builders.connectivity import Connectivity, ConnectivityLayout

    rng = np.random.default_rng(QASM_SEED)
    flavour = np.random.default_rng(QASM_SEED + 1)
    pairs = [(u, v) for u, v in Connectivity.new(ConnectivityLayout.SYCAMORE, qubits).connectivity
             if u < qubits and v < qubits]
    lines = ["OPENQASM 2.0;", 'include "qelib1.inc";',
             f"// {name}: {qubits} qubits, {rounds} rounds on the Sycamore couplers",
             "gate zxz(a, b) q { rz(a) q; sx q; rz(-b/2 + pi*a^2) q; }",
             f"qreg q[{qubits}];", f"creg c[{qubits}];", "h q;"]

    def angle() -> str:
        return repr(float(flavour.uniform(0.0, 2.0 * math.pi)))

    for _ in range(1, rounds):
        for i in range(qubits):
            if rng.random() < QASM_P1:
                kind = int(rng.integers(0, 3))
                if kind < 2:
                    lines.append(f"{('sx', 'sy')[kind]} q[{i}];")
                else:
                    third = int(flavour.integers(0, 3))
                    lines.append(("t q[{i}];", f"u3({angle()}, {angle()}, {angle()}) q[{{i}}];",
                                  f"zxz({angle()}, {angle()}) q[{{i}}];")[third].format(i=i))
        lines.append("barrier q;")
        for u, v in pairs:
            if rng.random() < QASM_P2:
                gate = "fsim(0.3, 0.2)" if flavour.random() < 0.5 else "cz"
                lines.append(f"{gate} q[{u}], q[{v}];")
    return "\n".join(lines) + "\n"


def qasm_cli(mode: str, directory: str, circuits: str, methods, partitions, *extra):
    """The argument list of ``python -m tnc_tpu_torch.benchmark <mode>`` with
    its outputs under ``directory``: the artifact cache, results, protocol
    and JSON logs."""
    return [sys.executable, "-m", "tnc_tpu_torch.benchmark", mode,
            "--circuits-dir", os.path.join(directory, "circuits", circuits),
            "--cache-dir", os.path.join(directory, "cache"),
            "--out", os.path.join(directory, "results.jsonl"),
            "--protocol", os.path.join(directory, "protocol.jsonl"),
            "--log-dir", os.path.join(directory, "logs"),
            "--methods", *methods, "--partitions", *[str(p) for p in partitions], *extra]


# the cells in the "both" directory as the CLI enumerates them: circuits sorted
# (qasm24_d12, qasm28_d12), then partitions (2, 4), then methods (greedy,
# tree-temper); the two cells are indices 0 and 7, the rest excluded
QASM_BOTH = (("greedy", "tree-temper"), (2, 4), ("--include", "0", "8", "--exclude", "1", "7"))


def qasm_env() -> dict:
    """The CLI processes' environment: this one, the repository first on the
    path."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([here] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


def make_qasm_sweep(directory: str) -> int:
    """``--qasm-sweep-to DIR``: write the two circuits, sweep each with its
    method through ``python -m tnc_tpu_torch.benchmark sweep``, then sweep
    both again (every cell must be skipped), and compute the observable
    network's value on the complex128 numpy oracle; keep the seconds in
    ``DIR/sweep.json``. Host work only, no torch."""
    from tnc_tpu_torch.builders.connectivity import ConnectivityLayout
    from tnc_tpu_torch.builders.random_circuit import random_circuit_with_observable
    from tnc_tpu_torch.ops.backends import NumpyBackend
    from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network

    here = os.path.dirname(os.path.abspath(__file__))
    both = os.path.join(directory, "circuits", "both")
    os.makedirs(both, exist_ok=True)
    texts = {}
    for name, qubits, _, _ in QASM_CELLS:
        texts[name] = qasm_text(name, qubits, QASM_ROUNDS)
        os.makedirs(os.path.join(directory, "circuits", name), exist_ok=True)
        for sub in (name, "both"):
            with open(os.path.join(directory, "circuits", sub, f"{name}.qasm"), "w") as f:
                f.write(texts[name])
    out = {"sweep_s": {}, "rc": {}}
    for name, _, method, parts in QASM_CELLS:
        t0 = time.perf_counter()
        rc = subprocess.run(qasm_cli("sweep", directory, name, [method], [parts]),
                            cwd=here, env=qasm_env()).returncode
        out["sweep_s"][name], out["rc"][name] = time.perf_counter() - t0, rc
    methods, parts, pick = QASM_BOTH
    t0 = time.perf_counter()
    out["rc"]["again"] = subprocess.run(qasm_cli("sweep", directory, "both", methods, parts, *pick),
                                        cwd=here, env=qasm_env()).returncode
    out["again_s"] = time.perf_counter() - t0
    qubits, rounds, p1, p2, p_obs, seed = OBSERVABLE
    tn = random_circuit_with_observable(qubits, rounds, p1, p2, p_obs,
                                        np.random.default_rng(seed), ConnectivityLayout.SYCAMORE)
    t0 = time.perf_counter()
    value = complex(contract_tensor_network(tn, plan(tn), NumpyBackend()).data.into_data())
    out["observable"] = [value.real, value.imag]
    out["observable_numpy_s"] = time.perf_counter() - t0
    with open(os.path.join(directory, "sweep.json"), "w") as f:
        json.dump(out, f)
    return 0


class QasmSweep(HostJob):
    """Phase 19's host work, made by ``python3 chip_smoke.py --qasm-sweep-to
    DIR`` (:func:`make_qasm_sweep`) beside the card's phases."""

    def __init__(self) -> None:
        super().__init__(QASM_SWEEP_FLAG, "the QASM sweep process")

    def result(self) -> dict:
        """Wait for the sweeps; their record with ``wait_s`` added."""
        wait_s = self.wait()
        with open(os.path.join(self.dir, "sweep.json")) as f:
            out = json.load(f)
        check(all(v == 0 for v in out["rc"].values()), f"a sweep exited with {out['rc']}")
        out["wait_s"] = wait_s
        return out


def record_chain_run(recorded: dict, counts: dict | None = None):
    """A hold for :func:`holding` of ``split_complex.run_chain_split`` that
    only records: a clone of each distinct chain's operands (its shapes,
    links and batch; the layout of a view is kept) and how many times the
    path ran it, in ``counts`` when given (:func:`recording_chains`). The
    clone is taken at a chain's first run, which every graphed executor
    runs eagerly. :func:`hold_recorded` holds them after the run, so the
    run itself is timed as a user runs it."""
    from tnc_tpu_torch.ops.split_complex import chain_operands

    def hold(steps, buffers, batched=None, *_):
        first, link_ops, links = chain_operands(steps, buffers,
                                                set() if batched is None else batched)
        key = chain_key(first, link_ops, links)
        if key in recorded:
            recorded[key][3] += 1
        else:
            recorded[key] = [tuple(t.clone() for t in first),
                             [tuple(t.clone() for t in pair) for pair in link_ops], links, 1]
        if counts is not None:
            counts[key] = counts.get(key, 0) + 1

    return hold


@contextlib.contextmanager
def recording_chains(recorded: dict):
    """:func:`record_chain_run` on every ``run_chain_split`` call while
    active, its counts in a dict (yielded) that the port's CUDA graphs
    treat as one of their host counters (``graphs._counters``): a capture
    takes back what it counted and each replay adds it again, as for
    ``cuda_complex.LAUNCHES``. So the counts weigh every launch of a
    graphed run, replays included."""
    from tnc_tpu_torch.ops import graphs, split_complex

    counts: dict = {}
    real = graphs._counters
    graphs._counters = lambda: real() + (counts,)
    try:
        with holding("run_chain_split", record_chain_run(recorded, counts), split_complex):
            yield counts
    finally:
        graphs._counters = real


def hold_recorded(label: str, recorded: dict, counts: dict | None = None) -> list:
    """Each recorded chain through :func:`hold_chain` (two launches bitwise
    equal, against the plain version and float64), its row weighing the
    launches the path made on it (``counts``, when the recording had them);
    the holds' own launches are taken back out of the counts."""
    from tnc_tpu_torch.ops.cuda_complex import CHAIN_FORMS, LAUNCHES

    saved = dict(LAUNCHES), dict(CHAIN_FORMS)
    rows = [hold_chain(first, link_ops, links, f"{label} chain {i}",
                       n if counts is None else counts.get(key, 0))
            for i, (key, (first, link_ops, links, n)) in enumerate(recorded.items())]
    for live, before in zip((LAUNCHES, CHAIN_FORMS), saved):
        live.clear()
        live.update(before)
    return rows


def recorded_contraction(label: str, tn, path, backend) -> dict:
    """``contract_tensor_network(tn, path, backend)`` once, synchronised
    and timed, its chains recorded (:func:`record_chain_run`) and held after
    it; the program's chains must all have launched, and the rows weigh
    exactly the launches."""
    import torch

    from tnc_tpu_torch.ops import split_complex
    from tnc_tpu_torch.ops.cuda_complex import LAUNCHES, reset_launches
    from tnc_tpu_torch.ops.program import build_program
    from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network

    chains = len(backend.kernel_policy(build_program(tn, path)).chains)
    recorded: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with holding("run_chain_split", record_chain_run(recorded), split_complex):
        out = contract_tensor_network(tn, path, backend)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, peak = LAUNCHES["fused_chain"], torch.cuda.max_memory_allocated()
    check(launches == chains, f"{label}: fused_chain launched {launches} times for "
          f"{chains} chains")
    t0 = time.perf_counter()
    rows = hold_recorded(label, recorded)
    holds_s = time.perf_counter() - t0
    if launches:
        check_held(label, rows, launches)
    print(f"[{label}] contract_tensor_network wall {wall:.4f} s (synchronised), "
          f"max_memory_allocated {peak} bytes; {launches} fused_chain launches on "
          f"{len(rows)} distinct chains, each held after the run (in {holds_s:.2f} s)",
          flush=True)
    return {"out": out, "wall_s": wall, "peak_bytes": peak, "launches": launches,
            "holds_s": holds_s, "rows": rows}


def qasm_outputs(directory: str, cells: list) -> dict:
    """Hold the CLI to its outputs, not its exit code: one
    ``OptimizationResult`` and one ``RunResult`` per cell (backend
    ``torch``, ``time_to_solution`` > 0), ``Done`` in the protocol for every
    id, no ``ERROR`` record in any JSON log, and the second sweep skipping
    both cells."""
    from tnc_tpu_torch.benchmark.results import ResultWriter

    records = ResultWriter(os.path.join(directory, "results.jsonl")).read_all()
    with open(os.path.join(directory, "protocol.jsonl")) as f:
        journal = [json.loads(line) for line in f if line.strip()]
    done = {r["id"] for r in journal if r["state"] == "done"}
    out = {}
    for name, sc in cells:
        opt = [r for r in records if r["kind"] == "OptimizationResult"
               and r["id"] == f"sweep/{sc.run_id}"]
        run = [r for r in records if r["kind"] == "RunResult"
               and r["id"] == f"run-torch/{sc.run_id}"]
        check(len(opt) == 1 and len(run) == 1,
              f"{name}: {len(opt)} OptimizationResult and {len(run)} RunResult records")
        check(run[0]["backend"] == "torch" and run[0]["time_to_solution"] > 0,
              f"{name}: RunResult {run[0]}")
        for rid in (opt[0]["id"], run[0]["id"]):
            check(rid in done, f"{name}: the protocol has no Done for {rid}")
        out[name] = {"sweep": opt[0], "run": run[0]}
    check(len(records) == 2 * len(cells), f"results.jsonl holds {len(records)} records")
    check(len(done) == len({r["id"] for r in journal}),
          f"protocol ids without Done: {sorted({r['id'] for r in journal} - done)}")
    logs = []
    for file in sorted(os.listdir(os.path.join(directory, "logs"))):
        with open(os.path.join(directory, "logs", file)) as f:
            logs += [json.loads(line) for line in f if line.strip()]
    errors = [r for r in logs if r["level"] in ("ERROR", "CRITICAL")]
    check(not errors, f"the CLI logged {errors[:2]}")
    skipped = [r["msg"] for r in logs if r["msg"].startswith("skipping sweep/")]
    check(sorted(skipped) == sorted(f"skipping sweep/{sc.run_id} (already done or failed)"
                                    for _, sc in cells),
          f"the second sweep skipped {skipped}")
    print(f"[qasm] results.jsonl {len(records)} records, protocol {len(done)} ids Done, "
          f"{len(logs)} JSON log records (no ERROR), the second sweep skipped "
          f"{len(skipped)} cells", flush=True)
    return out


def run_qasm(sweeps: "QasmSweep") -> dict:
    """Phase 19: the benchmark CLI on the card. The two circuits were written
    and swept beside phases 2-9 (:class:`QasmSweep`); one ``python -m
    tnc_tpu_torch.benchmark run`` process (``--repeats 2``, the default
    ``--backend torch``, no ``TNC_TPU_PLATFORM``) contracts both artifacts,
    and its outputs are checked (:func:`qasm_outputs`). Then, in this
    process, each artifact loaded with ``ArtifactCache.load`` is contracted
    once on ``TorchBackend()`` (:func:`recorded_contraction`, every chain
    held): the statevector's norm within 1e-4 of 1 and four amplitudes of
    the imported circuit's amplitude networks, contracted natively in
    complex128 on the card, within 1e-4·max(|ref|, 2^-14); and the
    observable network against the numpy value, within 1e-5."""
    import torch

    from tnc_tpu_torch.benchmark.cache import ArtifactCache
    from tnc_tpu_torch.benchmark.driver import Scenario
    from tnc_tpu_torch.builders.connectivity import ConnectivityLayout
    from tnc_tpu_torch.builders.random_circuit import random_circuit_with_observable
    from tnc_tpu_torch.contractionpath.paths import TreeTempering
    from tnc_tpu_torch.io.qasm import import_qasm
    from tnc_tpu_torch.ops.backends import TorchBackend
    from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network

    t_phase = time.perf_counter()
    check("TNC_TPU_PLATFORM" not in os.environ,
          "phase 19 runs the CLI on the card: TNC_TPU_PLATFORM must be unset")
    swept = sweeps.result()
    directory = sweeps.dir
    print(f"[qasm] sweeps {', '.join(f'{k} {v:.2f} s' for k, v in swept['sweep_s'].items())}, "
          f"the second {swept['again_s']:.2f} s, the observable's numpy value in "
          f"{swept['observable_numpy_s']:.2f} s, beside the card's phases; waited "
          f"{swept['wait_s']:.2f} s", flush=True)
    methods, parts, pick = QASM_BOTH
    t0 = time.perf_counter()
    proc = subprocess.Popen(qasm_cli("run", directory, "both", methods, parts, *pick,
                                     "--repeats", str(QASM_REPEATS)),
                            cwd=os.path.dirname(os.path.abspath(__file__)), env=qasm_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    # meanwhile, host work only: the circuits imported, their amplitude
    # networks planned, the observable network built and planned
    cells, refs = [], {}
    for name, qubits, method, n_parts in QASM_CELLS:
        with open(os.path.join(directory, "circuits", name, f"{name}.qasm")) as f:
            text = f.read()
        sc = Scenario(name, text, n_parts, 0, method)
        _, permutor = import_qasm(text).into_statevector_network()
        amps = []
        for bits in np.random.default_rng(7).integers(0, 2, size=(QASM_AMPLITUDES, qubits)):
            bitstring = "".join(str(int(b)) for b in bits)
            amp_tn, _ = import_qasm(text).into_amplitude_network(bitstring)
            amps.append((bits, bitstring, amp_tn))
        # the amplitude networks differ in their bras' data only: one
        # tree-tempered path serves the four (Greedy's takes 164x its flops
        # at 28 qubits); planned on the host while the run process runs
        amp_path = TreeTempering(seed=0).find_path(amps[0][2]).replace_path()
        check(all([t.legs for t in tn.tensors] == [t.legs for t in amps[0][2].tensors]
                  for _, _, tn in amps), f"{name}: amplitude networks of other legs")
        amps = [(bits, bitstring, tn, amp_path) for bits, bitstring, tn in amps]
        cells.append((name, sc))
        refs[name] = (permutor, amps)
    qubits, rounds, p1, p2, p_obs, seed = OBSERVABLE
    obs_tn = random_circuit_with_observable(qubits, rounds, p1, p2, p_obs,
                                            np.random.default_rng(seed),
                                            ConnectivityLayout.SYCAMORE)
    obs_path = plan(obs_tn)
    try:
        log, _ = proc.communicate(timeout=QASM_RUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        fail(f"the CLI run process took over {QASM_RUN_TIMEOUT_S:g} s")
    run_s = time.perf_counter() - t0
    print(f"[qasm] python -m tnc_tpu_torch.benchmark run: exit {proc.returncode} in "
          f"{run_s:.2f} s (the exit code is not the check); its stderr:\n"
          + "\n".join("  " + line for line in log.splitlines()[-8:]), flush=True)
    outputs = qasm_outputs(directory, cells)
    cache = ArtifactCache(os.path.join(directory, "cache"))
    backend = TorchBackend()
    oracle = TorchBackend(dtype="complex128", split_complex=False)
    card = card_line()
    record, launches, rows = {}, {}, {}
    for name, sc in cells:
        label = {"qasm28_d12": "qasm28_d12_treetemper_cli",
                 "qasm24_d12": "qasm24_d12_p2_greedy_cli"}[name]
        t0 = time.perf_counter()
        tn, path = cache.load(sc.key())
        load_s = time.perf_counter() - t0
        res = recorded_contraction(label, tn, path, backend)
        permutor, amps = refs[name]
        qubit_of = {leg: q for q, leg in enumerate(permutor.target_leg_order)}
        leaf = res.pop("out")
        check(sorted(leaf.legs) == sorted(qubit_of),
              f"{label}: the artifact's open legs are not the imported circuit's")
        t0 = time.perf_counter()
        sv = np.asarray(leaf.data.into_data())
        norm = statevector_norm(sv)
        check(sv.shape == (2,) * len(qubit_of) and math.isfinite(norm),
              f"{label}: statevector of shape {sv.shape} or not finite")
        check(abs(norm - 1.0) <= 1e-4, f"{label}: norm {norm} not within 1e-4 of 1")
        norm_s = time.perf_counter() - t0
        worst = 0.0
        t0 = time.perf_counter()
        for bits, bitstring, amp_tn, amp_path in amps:
            ref = complex(contract_tensor_network(amp_tn, amp_path, oracle).data.into_data())
            got = complex(sv[tuple(int(bits[qubit_of[leg]]) for leg in leaf.legs)])
            tol = 1e-4 * max(abs(ref), 2.0 ** -14)
            check(abs(got - ref) <= tol, f"{label}: amplitude {bitstring} {got} against "
                  f"complex128 {ref}, |diff| {abs(got - ref)} > {tol}")
            worst = max(worst, abs(got - ref) / tol)
        amps_s = time.perf_counter() - t0
        distributed = None
        if path.nested:
            # the CLI's --distributed on the partitioned plan (the 24-qubit
            # cell's; the tree-tempered one is flat), one device slot a
            # partition, against this contraction
            dist_label = f"{label} --distributed"
            distributed = distributed_cli(dist_label, sc, cache, directory, leaf)
            dist_rows = distributed.pop("rows")
            if distributed["launches"]:
                launches[dist_label], rows[dist_label] = distributed["launches"], dist_rows
        del sv, leaf
        sweep_rec, run_rec = outputs[name]["sweep"], outputs[name]["run"]
        print(f"[check] {label}: norm {norm:.8f} (the host's checks {norm_s:.2f} s); "
              f"{len(amps)} amplitudes against complex128 on the card (in {amps_s:.2f} s) "
              f"within {worst:.3f} of their tolerance", flush=True)
        print(f"[{label}] {sc.method}, {sc.partitions} partitions: plan "
              f"{sweep_rec['optimization_time']:.3f} s, peak 2^"
              f"{math.log2(sweep_rec['memory']):.2f} B (complex128), flops "
              f"{sweep_rec['flops']:.4e} (serial Greedy {sweep_rec['serial_flops']:.4e}); "
              f"time_to_solution {run_rec['time_to_solution']:.4f} s (best of "
              f"{QASM_REPEATS}); in process {res['wall_s']:.4f} s (artifact loaded in "
              f"{load_s:.3f} s); fused_chain {res['launches']} launches; {card}", flush=True)
        launches[label], rows[label] = res["launches"], res.pop("rows")
        record[label] = {"method": sc.method, "partitions": sc.partitions,
                         "plan_s": sweep_rec["optimization_time"],
                         "plan_peak_bytes": sweep_rec["memory"], "flops": sweep_rec["flops"],
                         "flops_sum": sweep_rec["flops_sum"],
                         "serial_flops": sweep_rec["serial_flops"],
                         "sweep_wall_s": swept["sweep_s"][name],
                         "time_to_solution": run_rec["time_to_solution"],
                         "load_s": load_s, "norm": norm, "amplitude_worst": worst,
                         "amplitudes_s": amps_s, "norm_s": norm_s, "distributed": distributed,
                         **res}
    label = "observable16_m8"
    res = recorded_contraction(label, obs_tn, obs_path, backend)
    got = complex(res.pop("out").data.into_data())
    want = complex(*swept["observable"])
    check(abs(got - want) <= 1e-5, f"{label}: {got} against numpy {want}")
    print(f"[check] {label}: {got:.10f} against numpy {want:.10f}, |diff| "
          f"{abs(got - want):.3e} (gate 1e-5)", flush=True)
    if res["launches"]:
        launches[label], rows[label] = res["launches"], res.pop("rows")
    record[label] = {"value": [got.real, got.imag], "numpy": swept["observable"], **{
        k: v for k, v in res.items() if k != "rows"}}
    torch.cuda.empty_cache()
    check("h5py" not in sys.modules, "phase 19 imported h5py, which the card's machine lacks")
    record["run_process_s"] = run_s
    record["seconds"] = time.perf_counter() - t_phase
    print(f"[qasm] phase 19 in {record['seconds']:.1f} s", flush=True)
    return {"record": record, "chain_launches": launches, "chain_rows": rows}


def recorded_call(label: str, fn) -> dict:
    """``fn()`` once, synchronised and timed, every ``fused_chain`` launch
    it makes recorded (:func:`recording_chains`, graphed replays included)
    and held after it against its plain version; the rows weigh exactly
    the launches it made."""
    import torch

    from tnc_tpu_torch.ops.cuda_complex import LAUNCHES, reset_launches

    recorded: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with recording_chains(recorded) as counts:
        out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, peak = LAUNCHES["fused_chain"], torch.cuda.max_memory_allocated()
    check(sum(counts.values()) == launches, f"{label}: recorded {sum(counts.values())} chain "
          f"runs, fused_chain launched {launches} times")
    t0 = time.perf_counter()
    rows = hold_recorded(label, recorded, counts)
    holds_s = time.perf_counter() - t0
    if launches:
        check_held(label, rows, launches)
    return {"out": out, "wall_s": wall, "peak_bytes": peak, "launches": launches,
            "holds_s": holds_s, "rows": rows}


def distributed_cli(label: str, sc, cache, directory: str, leaf) -> dict:
    """Phase 19's ``--distributed`` run: ``benchmark.driver.do_run(...,
    distributed=True)`` in this process (a run process of its own would pay
    the card's start-up again) on the cell's artifact, into results and a
    protocol of its own; its ``distributed_partitioned_contraction`` must
    place one device slot a partition on ``cuda:0`` and give the in-process
    contraction ``leaf`` within 1e-5 relative (2-norm); every chain held."""
    import torch

    from tnc_tpu_torch import parallel
    from tnc_tpu_torch.benchmark.driver import do_run
    from tnc_tpu_torch.benchmark.protocol import Protocol
    from tnc_tpu_torch.benchmark.results import ResultWriter

    out_dir = os.path.join(directory, "distributed")
    os.makedirs(out_dir, exist_ok=True)
    seen = []
    real = parallel.distributed_partitioned_contraction

    def spy(tn, path, **kw):
        result = real(tn, path, **kw)
        seen.append((kw.get("devices"), result))
        return result

    parallel.distributed_partitioned_contraction = spy
    try:
        res = recorded_call(label, lambda: do_run(
            sc, cache, ResultWriter(os.path.join(out_dir, "results.jsonl")),
            Protocol(os.path.join(out_dir, "protocol.jsonl")), distributed=True))
    finally:
        parallel.distributed_partitioned_contraction = real
    record = res.pop("out")
    check(record is not None and record.time_to_solution > 0 and record.backend == "torch",
          f"{label}: RunResult {record}")
    check(len(seen) == 1, f"{label}: {len(seen)} distributed contractions")
    devices, dist = seen[0]
    check(devices == [torch.device("cuda", 0)] * sc.partitions,
          f"{label}: device slots {devices} for {sc.partitions} partitions")
    check(sorted(dist.legs) == sorted(leaf.legs), f"{label}: open legs differ")
    got = np.transpose(np.asarray(dist.data.into_data()), [dist.legs.index(g) for g in leaf.legs])
    want = np.asarray(leaf.data.into_data())
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    check(rel <= 1e-5, f"{label}: {rel} relative (2-norm) off the in-process contraction")
    print(f"[check] {label}: do_run(distributed=True) on {len(devices)} device slots "
          f"{sorted({str(d) for d in devices})}: time_to_solution "
          f"{record.time_to_solution:.4f} s (wall {res['wall_s']:.4f} s), {rel:.3e} relative "
          f"(2-norm) off the in-process contraction (gate 1e-5); {res['launches']} fused_chain "
          f"launches, held after the run", flush=True)
    return {**res, "time_to_solution": record.time_to_solution, "rel_err": rel,
            "devices": [str(d) for d in devices]}


#: the examples that touch the device; ``repartitioning`` is host-only (SA
#: with a 10 s ``max_time``) and runs in the CPU tests
DEVICE_EXAMPLES = ("local_contraction", "amplitude_sweep", "autodiff_gradients",
                   "approximate_peps", "distributed_contraction", "sliced_partitioning",
                   "strategy_selection")


def example_oracle(name: str, out: dict) -> dict:
    """Hold one example's returned values against the complex128 host
    oracle (``NumpyBackend``, or the numpy contraction the example returns)
    at the existing tolerances: amplitudes within 1e-4·max(|ref|, 2^-14),
    a small statevector within 1e-5 of numpy with its norm within 1e-4 of
    1, complex128 results on the card within 1e-10, the gradients within
    1e-10 of the port's complex128 host gradient, a served approximate
    amplitude within its request's rtol. Returns the errors."""
    from tnc_tpu_torch.ops.backends import NumpyBackend
    from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network

    def amp_err(got, want) -> float:
        got, want = np.asarray(got), np.asarray(want)
        ratio = float(np.max(np.abs(got - want) / (1e-4 * np.maximum(np.abs(want), 2.0 ** -14))))
        check(ratio <= 1.0, f"example {name}: amplitudes off complex128 ({ratio} of the gate)")
        return ratio

    if name == "local_contraction":
        from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
        from tnc_tpu_torch.examples.local_contraction import QASM
        from tnc_tpu_torch.io.qasm import import_qasm

        tn, permutor = import_qasm(QASM).into_statevector_network()
        path = Greedy(OptMethod.GREEDY).find_path(tn).replace_path()
        want = np.asarray(permutor.apply(contract_tensor_network(tn, path, NumpyBackend()))
                          .data.into_data()).reshape(-1)
        diff = float(np.max(np.abs(out["statevector"] - want)))
        norm = statevector_norm(out["statevector"])
        check(diff <= 1e-5 and abs(norm - 1.0) <= 1e-4,
              f"example {name}: max|diff| {diff} (gate 1e-5), norm {norm}")
        return {"max_abs_diff": diff, "norm": norm}
    if name == "amplitude_sweep":
        from tnc_tpu_torch.builders.connectivity import ConnectivityLayout
        from tnc_tpu_torch.builders.random_circuit import random_open_circuit
        from tnc_tpu_torch.tensornetwork import amplitude_sweep

        circuit = random_open_circuit(16, 10, 0.4, 0.4, np.random.default_rng(7),
                                      ConnectivityLayout.LINE)
        want = amplitude_sweep(circuit, out["bitstrings"], backend=NumpyBackend())
        return {"amplitudes_of_gate": amp_err(out["amplitudes"], want)}
    if name == "autodiff_gradients":
        from tnc_tpu_torch.builders.circuit_builder import Circuit
        from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
        from tnc_tpu_torch.examples.autodiff_gradients import BITSTRINGS, THETA
        from tnc_tpu_torch.ops.autodiff import contraction_value_and_grad
        from tnc_tpu_torch.tensornetwork import amplitude_sweep
        from tnc_tpu_torch.tensornetwork.sweep import amplitude_sweep_value_and_grad
        from tnc_tpu_torch.tensornetwork.tensordata import TensorData

        def rx():
            c = Circuit()
            c.append_gate(TensorData.gate("rx", [THETA]), [c.allocate_register(1).qubit(0)])
            return c.into_expectation_value_network()

        def bell():
            c = Circuit()
            reg = c.allocate_register(3)
            c.append_gate(TensorData.gate("h"), [reg.qubit(0)])
            c.append_gate(TensorData.gate("cx"), [reg.qubit(0), reg.qubit(1)])
            c.append_gate(TensorData.gate("ry", [0.3]), [reg.qubit(2)])
            return c

        tn = rx()
        path = Greedy(OptMethod.GREEDY).find_path(tn).replace_path()
        z = complex(contract_tensor_network(tn, path, NumpyBackend()).data.into_data()).real
        _, grads = contraction_value_and_grad(rx(), path, wrt=out["slots"],
                                              dtype="complex128", device="cpu")
        amps = amplitude_sweep(bell(), BITSTRINGS, backend=NumpyBackend())
        _, sweep_grads = amplitude_sweep_value_and_grad(bell(), BITSTRINGS, dtype="complex128",
                                                        device="cpu")
        errs = {"z": abs(out["z"] - z),
                "grads": max(float(np.max(np.abs(g - w))) for g, w in zip(out["grads"], grads)),
                "sweep_amplitudes": float(np.max(np.abs(out["sweep_amplitudes"] - amps))),
                "sweep_grads": max(float(np.max(np.abs(g - w)))
                                   for g, w in zip(out["sweep_grads"], sweep_grads)),
                "dz_dtheta": abs(out["dz_dtheta"] + math.sin(THETA))}
        check(all(v <= 1e-10 for k, v in errs.items() if k != "dz_dtheta")
              and errs["dz_dtheta"] <= 1e-5, f"example {name}: {errs}")
        return errs
    if name == "approximate_peps":
        from tnc_tpu_torch.builders.random_circuit import brickwork_circuit
        from tnc_tpu_torch.tensornetwork import amplitude_sweep

        exact = out["exact"]
        sweep_rel = abs(out["sweep"][64] - exact) / abs(exact)
        want = complex(amplitude_sweep(brickwork_circuit(8, 5, np.random.default_rng(0)),
                                       ["10100110"], backend=NumpyBackend())[0])
        served = out["service"]
        served_rel = abs(served["value"] - want) / abs(want)
        ladder = out["ladder"]
        check(sweep_rel <= 1e-8 and ladder["converged"] and ladder["err"] >= ladder["true_err"]
              and served_rel <= 1e-2 and served["approx_completed"] == 1,
              f"example {name}: chi=64 {sweep_rel}, ladder {ladder}, served {served_rel}")
        return {"chi64_rel": sweep_rel, "ladder_true_err": ladder["true_err"],
                "ladder_err": ladder["err"], "served_rel": served_rel}
    return {"amplitude_of_gate": amp_err(out["amplitude"], out["oracle"])}


def run_examples() -> dict:
    """Phase 20: the port's examples (``tnc_tpu_torch/examples/``), each
    that touches the device run here through its ``main()`` on the card
    (their printed lines shown), with the reference's sizes and seeds and
    the reference's device counts as slots on ``cuda:0`` (4, 4 and 8).
    Each run is synchronised and timed, its ``fused_chain`` launches
    recorded (graphed replays included) and held after it against the
    plain version (:func:`recorded_call`); each example's own asserts run
    inside it, and its returned values are then held to the complex128
    host oracle (:func:`example_oracle`)."""
    import importlib

    import torch

    t_phase = time.perf_counter()
    check("TNC_TPU_PLATFORM" not in os.environ,
          "phase 20 runs the examples on the card: TNC_TPU_PLATFORM must be unset")
    record, launches, rows = {}, {}, {}
    for name in DEVICE_EXAMPLES:
        label = f"example {name}"
        module = importlib.import_module(f"tnc_tpu_torch.examples.{name}")
        print(f"[{label}] python -m tnc_tpu_torch.examples.{name}:", flush=True)
        res = recorded_call(label, module.main)
        t0 = time.perf_counter()
        errs = example_oracle(name, res.pop("out"))
        oracle_s = time.perf_counter() - t0
        print(f"[check] {label}: {res['wall_s']:.3f} s on the card (synchronised), peak "
              f"{res['peak_bytes']} bytes, {res['launches']} fused_chain launches on "
              f"{len(res['rows'])} distinct chains held after it (in {res['holds_s']:.2f} s); "
              f"against complex128 {errs} (in {oracle_s:.2f} s)", flush=True)
        if res["launches"]:
            launches[label], rows[label] = res["launches"], res["rows"]
        res.pop("rows")
        record[name] = {**res, "oracle": errs, "oracle_s": oracle_s}
        torch.cuda.empty_cache()
    check(sum(launches.values()) > 0, "phase 20: no example launched fused_chain")
    record["seconds"] = time.perf_counter() - t_phase
    print(f"[examples] phase 20 in {record['seconds']:.1f} s", flush=True)
    return {"record": record, "chain_launches": launches, "chain_rows": rows}


# -- phase 21: the dot-precision rungs ----------------------------------------------

#: the TF32 rungs phase 21 runs (``float32`` is every other phase's)
PRECISION_RUNGS = ("high", "default")
#: tensor-core passes a real product takes at each rung
RUNG_PASSES = {"float32": 1, "high": 3, "default": 1}
#: the H100 SXM's dense TF32 rate on the tensor cores (half the data sheet's
#: 989 TFLOP/s, which counts sparsity), FLOP/s
TF32_PEAK_FLOPS = 494.7e12
#: each kernel's ``high`` rung against a float64 product of its FP32 inputs:
#: a quarter of the reference's ``HIGH_PRECISION_STEP_REL`` (2^-18), relative
#: Frobenius error, per product (a chain of s stages: s products)
HIGH_F64_REL = 2.0 ** -20
#: ``default``'s error must be at least this many times ``high``'s (the TF32
#: path ran)
DEFAULT_OVER_HIGH = 10.0


def rung_reps(macs: float) -> int:
    """Timed calls of one rung case: fewer where a call is long."""
    return 1 if 8.0 * macs > 1e13 else 3 if 8.0 * macs > 1e12 else 10


def rung_bound_ms(nbytes: float, macs: float, rung: str) -> tuple[float, str]:
    """The least time of a product at a rung: the larger of its bytes over
    3.35 TB/s and its operations over the tensor cores' TF32 rate (the naive
    four real products, 8 flops a complex multiply-add, times the rung's
    passes); at ``float32`` the CUDA cores' FP32 bound of the other phases."""
    if rung == "float32":
        return bound_ms(nbytes, COMPLEX_MAC_FLOPS * macs, "float32")
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 8.0 * macs * RUNG_PASSES[rung] / TF32_PEAK_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def frob_rel(got, exact, chunk: int = 1 << 24) -> float:
    """``||got - exact||_F / ||exact||_F`` over both parts, in float64,
    ``chunk`` elements at a time (a large output's float64 copy would not
    fit beside it)."""
    num = den = 0.0
    for g, e in zip(got, exact):
        g, e = g.reshape(-1), e.reshape(-1)
        for i in range(0, g.numel(), chunk):
            gd, ed = g[i:i + chunk].double(), e[i:i + chunk].double()
            num += float(((gd - ed) ** 2).sum())
            den += float((ed ** 2).sum())
    return math.sqrt(num / den)


def hold_rungs(what: str, kernel, plain, exact, nbytes: float, macs: float,
               launches: int, library=None, stages: int = 1, reps: int = 10,
               probe=None) -> dict:
    """One kernel case at each rung: ``kernel(rung)`` against ``plain(rung)``
    within 1e-5·max|plain| (``float32``, a baseline the rung's path does
    not launch, is printed, not held), or, where the
    two FP32 orders of a long, cancelling contraction differ by more, no
    further from ``exact`` than twice the plain version's distance. On the
    ``probe`` (:func:`hold_probe`) each rung must give its own exact bits,
    so the rung's own arithmetic ran. On the case's random data the distances of the rung's
    and the float32 output to the rung's plain version are printed, and
    whether their bits differ: 3xTF32 lies within FP32's own rounding of
    FP32, so neither is ordered (a K = 2, M = 1, N = 4 product gave the
    float32 bits at ``high``). Each rung's relative
    Frobenius error against ``exact`` (a float64 computation from the same
    FP32 inputs; ``None``: not formed, the operands too large): ``high``
    within ``HIGH_F64_REL`` a product (``stages`` products) or twice the
    plain float32 version's own error, whichever is larger (a result that
    cancels leaves FP32 itself further off), ``default`` at least
    ``DEFAULT_OVER_HIGH`` times ``high``'s. Each rung timed (CUDA
    events) beside its plain version, the bound and ``library(rung)``
    (``None``: no PyTorch call computes it). A row per TF32 rung, weighted
    by ``launches``."""
    import torch

    rows, errs, f32_ms, f32_out = {}, {}, None, None
    for rung in ("float32",) + PRECISION_RUNGS:
        got, k_reps = timed_once(lambda: kernel(rung), reps)
        want, p_reps = timed_once(lambda: plain(rung), reps)
        err, scale = max_err(got, want)
        if rung == "float32":
            # the baseline: a launch the rung's path does not make (at
            # float32 such a step may run cuBLAS), printed, not held
            if err > F32_REL_TOL * scale:
                k64 = None if exact is None else max_err(got, exact)[0]
                p64 = None if exact is None else max_err(want, exact)[0]
                print(f"  {what}: the float32 baseline is {err:.3e} off its plain version "
                      f"(scale {scale:.3e}; against float64 kernel {k64}, plain {p64})",
                      flush=True)
        elif err > F32_REL_TOL * scale and exact is not None:
            # two FP32 orders of a long contraction whose result cancels
            # part away can differ by more than 1e-5 of it: then the
            # kernel must be as near the float64 product as the plain
            # version is (within 2x, phase 2's rule)
            k64, p64 = max_err(got, exact)[0], max_err(want, exact)[0]
            print(f"  {what} at {rung}: max|err| against the plain version {err:.3e} > "
                  f"{F32_REL_TOL} * {scale:.3e}; against float64 the kernel {k64:.3e}, the "
                  f"plain version {p64:.3e}", flush=True)
            check(k64 <= 2 * p64, f"{what} at {rung}: max|err| against float64 {k64} is "
                  f"over twice the plain version's {p64}")
        else:
            check(err <= F32_REL_TOL * scale,
                  f"{what} at {rung}: max|err| against the plain version {err} > "
                  f"{F32_REL_TOL} * {scale}")
        if exact is not None:
            errs[rung] = frob_rel(got, exact)
            if rung == "float32":
                plain32 = frob_rel(want, exact)
        if rung == "float32":
            f32_out = got
        else:
            nearness = (frob_rel(got, want), frob_rel(f32_out, want),
                        not all(torch.equal(g, f) for g, f in zip(got, f32_out)))
        del got, want
        ms, wall = time_ms(lambda: kernel(rung), k_reps, 0)  # timed_once warmed both
        if rung == "float32":
            f32_ms = ms
            continue
        plain_ms, _ = time_ms(lambda: plain(rung), p_reps, 0)
        lib = None if library is None or library(rung) is None else \
            time_ms(library(rung), p_reps, 1)[0]
        b_ms, b_by = rung_bound_ms(nbytes, macs, rung)
        rows[rung] = {"label": what, "rung": rung, "launches": launches, "err": err,
                      "scale": scale, "f64_rel": errs.get(rung), "plain_rel": nearness[0],
                      "float32_plain_rel": nearness[1], "bits_differ": nearness[2],
                      "ms": ms, "wall_ms": wall,
                      "plain_ms": plain_ms, "library_ms": lib, "bound_ms": b_ms,
                      "bound_by": b_by, "float32_ms": f32_ms}
    del f32_out
    if probe is not None:
        hold_probe(what, probe)
    if exact is not None:
        # where the result cancels, FP32 itself (the plain float32 version)
        # may lie further from float64 than 2^-20: high then holds to twice that
        high_gate = max(HIGH_F64_REL * stages, 2 * plain32)
        check(errs["high"] <= high_gate,
              f"{what}: high's error against float64 {errs['high']:.3e} > {high_gate:.3e} "
              f"(2^-20 x {stages}, or twice the plain float32 version's {plain32:.3e})")
        check(errs["default"] >= DEFAULT_OVER_HIGH * errs["high"],
              f"{what}: default's error against float64 {errs['default']:.3e} is not "
              f"{DEFAULT_OVER_HIGH:g}x high's {errs['high']:.3e}")
    for rung, row in rows.items():
        lib = "null" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms"
        f64 = "not formed" if exact is None else \
            f"{row['f64_rel']:.3e} (float32 {errs['float32']:.3e}, plain float32 {plain32:.3e})"
        print(f"  {what} {rung}: err {row['err']:.3e} (scale {row['scale']:.3e}); off the "
              f"rung's plain version {row['plain_rel']:.3e}, the float32 kernel "
              f"{row['float32_plain_rel']:.3e} (bits differ: {row['bits_differ']}); against "
              f"float64 {f64}; device: kernel "
              f"{row['ms']:.5f} ms (float32 {f32_ms:.5f} ms) plain {row['plain_ms']:.5f} ms "
              f"library {lib}; bound {row['bound_ms']:.3e} ms ({row['bound_by']}, "
              f"{RUNG_PASSES[rung]} TF32 pass{'es' if RUNG_PASSES[rung] > 1 else ''} at "
              f"494.7 TFLOP/s)", flush=True)
    return rows


#: the probe's operand value: hi = rna_tf32 = 1 and lo = 2^-11 - 2^-21, so
#: one product is 1 + 2^-10 - 2^-20 at ``high`` (lo·lo dropped, every sum
#: exact), 1 at ``default`` and 1 + 2^-10 - 2^-20 + 2^-22 in FP32
PROBE_VALUE = 1.0 + 2.0 ** -11 - 2.0 ** -21


def probe_parts(parts, first: int = 4, to_kf=None) -> list:
    """Operands shaped as ``parts`` ((real, imag) pairs, each ``(..., K,
    F)``) for :func:`hold_probe`: zero but for contract index 0 of the real
    parts, :data:`PROBE_VALUE` on the first ``first`` parts (the product's
    two operands) and 1 on the rest (a chain's links, whose products then
    keep the carried value exact at every rung). ``to_kf(i, t)``: part
    ``i`` as its ``(K, F)`` matrix where it is stored otherwise (the
    transpose kernel's layouts)."""
    import torch

    out = []
    for i, t in enumerate(parts):
        z = torch.zeros(t.shape, dtype=t.dtype, device=t.device)
        if i % 2 == 0:
            value = PROBE_VALUE if i < first else 1.0
            if to_kf is None:
                z[..., 0, :] = value
            else:
                idx = torch.arange(z.numel(), device=z.device).reshape(z.shape)
                z.view(-1)[to_kf(i, idx)[0]] = value
        out.append(z)
    return out


#: the one product every probe output is, exactly, at each rung, as the
#: plain versions compute it (tests/test_torch_precision.py): FP32's
#: rounding of the square; 3xTF32 drops lo·lo and sums exactly; one TF32
#: pass multiplies 1 by 1
PROBE_OUT = {"float32": float(np.float32(PROBE_VALUE) * np.float32(PROBE_VALUE)),
             "high": 1.0 + 2.0 ** -10 - 2.0 ** -20, "default": 1.0}


def hold_probe(what: str, probe) -> None:
    """``probe(rung)`` is the kernel's output on :func:`probe_parts`
    operands, every output one product (the rest of each contraction
    zero) whose value each rung fixes exactly (:data:`PROBE_OUT`, three
    distinct values): at each rung the kernel gives its rung's value bit
    for bit and a zero imaginary part, so a launch that ran another rung's
    arithmetic (FP32 under ``high``) cannot pass."""
    for rung in ("float32",) + PRECISION_RUNGS:
        re, im = probe(rung)
        check(bool((re == PROBE_OUT[rung]).all()) and not bool(im.any()),
              f"{what} at {rung}: the probe's output is not {PROBE_OUT[rung]!r} + 0i "
              f"everywhere (values {re.unique()[:4].tolist()})")
    print(f"  {what}: the probe gives each rung's bits", flush=True)


#: device milliseconds one timed case of :func:`hold_rungs` may take
RUNG_TIMING_MS = 100.0


def timed_once(fn, reps: int):
    """``(fn(), n)``: one call, its device time read through CUDA events,
    and the timed repetitions to make of it: ``reps``, fewer where
    ``reps`` calls would pass ``RUNG_TIMING_MS``."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, max(1, min(reps, int(RUNG_TIMING_MS / max(start.elapsed_time(end), 1e-3))))


@contextlib.contextmanager
def tf32_matmul():
    """cuBLAS TF32 on while active: the library time of the ``default``
    rung (a complex64 product with TF32 on). The port never turns it on."""
    import torch

    matmul = torch.backends.cuda.matmul
    was = matmul.allow_tf32
    matmul.allow_tf32 = True
    try:
        yield
    finally:
        matmul.allow_tf32 = was


#: a recorded rung launch whose parts pass this many elements keeps its
#: first batch row only, and one whose output passes RUNG_RECORD_OUT
#: elements a part a leading block of its rows and columns, its
#: contraction whole: its operands are copied while the contraction's own
#: buffers are live, and its hold (the plain version's split copies, the
#: float64 product, each rung's outputs) and timings run on what was kept
RUNG_RECORD_ELEMS = 1 << 28
RUNG_RECORD_OUT = 1 << 26
#: past this many output elements a part, a held launch forms no float64
#: product
RUNG_F64_ELEMS = 1 << 28


def rung_dot_state() -> dict:
    """Where :func:`rung_dot_hold` keeps what it saw: the operands of each
    distinct launch shape and the TF32 tile it takes at each rung
    (``recorded``, held by :func:`hold_rung_dots`), ``rows`` by rung, the
    launches ``counts`` per (shape, rung) and ``tiles`` per "<rung>
    <tile>"."""
    return {"recorded": {}, "rows": {rung: [] for rung in PRECISION_RUNGS}, "counts": {},
            "tiles": {}}


def rung_dot_hold(label: str, state: dict):
    """A hold for :func:`holding` of ``cuda_complex.fused_complex_dot`` that
    records every launch at a TF32 rung: the operands of each distinct pair
    of operand shapes, copied at its first launch (the first batch row
    where a part passes ``RUNG_RECORD_ELEMS``, a leading block of rows and
    columns where the output passes ``RUNG_RECORD_OUT``) with the tile the
    launch takes at each TF32 rung (``cuda_complex.tf32_config`` of its
    whole shape: the held block runs on it), and every launch counted in
    ``state["counts"]`` under its shapes and rung and in ``state["tiles"]``
    under its rung and tile (graph host counters: replays count)."""
    from tnc_tpu_torch.ops import cuda_complex as cc

    def hold(ar, ai, br, bi, precision=None):
        if precision in (None, "float32"):
            return
        key = (tuple(ar.shape), tuple(br.shape))
        (k, m0), n0 = ar.shape[-2:], br.shape[-1]
        batch = max(t.shape[0] if t.dim() == 3 else 1 for t in (ar, br))
        tiles = {rung: cc.tf32_config(k, m0, n0, rung, batch=batch,
                                      sms=cc._sm_count(ar.device)).name
                 for rung in PRECISION_RUNGS}
        tile_key = f"{precision} {tiles[precision]}"
        state["tiles"][tile_key] = state["tiles"].get(tile_key, 0) + 1
        if key not in state["recorded"]:
            parts = (ar, ai, br, bi)
            if max(t.numel() for t in parts) > RUNG_RECORD_ELEMS:
                parts = tuple(t[:1] if t.dim() == 3 else t for t in parts)
            rows = max(t.shape[0] if t.dim() == 3 else 1 for t in parts)
            m, n = ar.shape[-1], br.shape[-1]
            while rows * m * n > RUNG_RECORD_OUT:
                m, n = (-(-m // 2), n) if m > n else (m, -(-n // 2))
            parts = (parts[0][..., :m], parts[1][..., :m], parts[2][..., :n], parts[3][..., :n])
            state["recorded"][key] = (label, tuple(t.clone() for t in parts), tiles)
        state["counts"][(key, precision)] = state["counts"].get((key, precision), 0) + 1

    return hold


def hold_rung_dots(state: dict) -> None:
    """Each recorded launch shape not yet held, after the run that made it:
    :func:`hold_rungs` at every rung on its recorded operands (with the
    probe), each TF32 rung on the tile the whole launch takes there (a
    held block may be smaller than the launch; its launches must have run
    on that tile), the library a complex64 ``matmul`` with TF32 on at
    ``default``; its rows weigh the launches counted at its shapes (set by
    :func:`rung_dot_rows`). The holds' own launches are taken back out of
    the kernels' counts."""
    import torch

    from tnc_tpu_torch.ops import cuda_complex as cc

    held = {row["key"] for rows in state["rows"].values() for row in rows}
    for key, (label, parts, tiles) in list(state["recorded"].items()):
        if key in held:
            continue
        (k, m), n = parts[0].shape[-2:], parts[2].shape[-1]
        rows = max(t.shape[0] if t.dim() == 3 else 1 for t in parts)
        exact = None if rows * m * n > RUNG_F64_ELEMS else \
            cc.fused_complex_dot_reference(*(t.double() for t in parts))
        a_c, b_c = torch.complex(parts[0], parts[1]), torch.complex(parts[2], parts[3])

        def library(rung):
            if rung != "default":
                return None

            def call():
                with tf32_matmul():
                    return a_c.mT @ b_c
            return call

        saved = dict(cc.LAUNCHES), dict(cc.RUNG_LAUNCHES), dict(cc.TILE_LAUNCHES)
        batch = f" batch {rows}" if rows > 1 else ""
        cut = "" if (parts[0].shape, parts[2].shape) == key else \
            f" (held on a block of {key[0]} x {key[1]})"
        probe = probe_parts(parts)
        cc.TILE_LAUNCHES.clear()
        out = hold_rungs(
            f"fused_complex_dot {label}{batch} K={k} M={m} N={n}{cut} (tiles {tiles})",
            lambda rung: cc.fused_complex_dot(*parts, precision=rung, tile=tiles.get(rung)),
            lambda rung: cc.fused_complex_dot_reference(*parts, rung), exact,
            4.0 * 2 * (parts[0].numel() + parts[2].numel() + rows * m * n),
            rows * k * m * n, 0, library, reps=rung_reps(rows * k * m * n),
            probe=lambda rung: cc.fused_complex_dot(*probe, precision=rung,
                                                    tile=tiles.get(rung)))
        check(set(cc.TILE_LAUNCHES) == {f"fused_complex_dot {rung} {tiles[rung]}"
                                        for rung in PRECISION_RUNGS},
              f"fused_complex_dot {label} K={k} M={m} N={n}: held on the tiles "
              f"{cc.TILE_LAUNCHES}, its launch takes {tiles}")
        for live, before in zip((cc.LAUNCHES, cc.RUNG_LAUNCHES, cc.TILE_LAUNCHES), saved):
            live.clear()
            live.update(before)
        for rung, row in out.items():
            row.update(k=k, m=m, n=n, batch=rows, key=key, tile=tiles[rung])
            state["rows"][rung].append(row)
        state["recorded"][key] = (label, None, tiles)  # held: the copies go
        del parts, probe, exact, a_c, b_c
        torch.cuda.empty_cache()


@contextlib.contextmanager
def holding_rung_dots(state: dict, label: str):
    """:func:`rung_dot_hold` on every ``fused_complex_dot`` call while
    active, its counts joined to the graphs' host counters (the recorded
    shapes are held after, by :func:`hold_rung_dots`)."""
    from tnc_tpu_torch.ops import graphs

    real = graphs._counters
    graphs._counters = lambda: real() + (state["counts"], state["tiles"])
    try:
        with holding("fused_complex_dot", rung_dot_hold(label, state)):
            yield
    finally:
        graphs._counters = real


def held_rung_launches(state: dict, rung: str) -> int:
    """The ``fused_complex_dot`` launches at ``rung`` the holds counted."""
    return sum(n for (_, r), n in state["counts"].items() if r == rung)


def rung_dot_rows(state: dict) -> dict:
    """The held rows by rung, each weighed by the launches counted at its
    shapes and rung; every recorded shape must have been held."""
    check(all(parts is None for _, parts, _ in state["recorded"].values()),
          "a recorded fused_complex_dot rung launch was never held")
    for rung, rows in state["rows"].items():
        for row in rows:
            row["launches"] = state["counts"].get((row["key"], rung), 0)
    return state["rows"]


def rung_transpose_rows(program, gen) -> dict:
    """``fused_transpose_dot`` at every distinct admitted layout of the PEPS
    plan, at each rung (the library a complex64 ``einsum`` with TF32 on at
    ``default``), each weighted by the steps that have it."""
    import torch

    from tnc_tpu_torch.ops import cuda_complex as cc

    rows = {rung: [] for rung in PRECISION_RUNGS}
    for first, second, steps in sorted(transpose_cases(program),
                                       key=lambda c: -c[0].k_size * c[0].f_size * c[1].f_size):
        k, m, n = first.k_size, first.f_size, second.f_size
        ops = [torch.randn(v, generator=gen, device="cuda")
               for v in (first.view, first.view, second.view, second.view)]
        exact = cc.fused_transpose_reference(*(t.double() for t in ops), first, second)
        a_c, b_c = torch.complex(ops[0], ops[1]), torch.complex(ops[2], ops[3])
        try:
            spec = einsum_spec(first, second)
        except RuntimeError:  # contract digits grouped otherwise: no one call
            spec = None

        def library(rung):
            if rung != "default" or spec is None:
                return None

            def call():
                with tf32_matmul():
                    return torch.einsum(spec, a_c, b_c)
            return call

        probe = probe_parts(ops, to_kf=lambda i, t: cc._as_kf(t, first if i < 2 else second))
        tiles_before = dict(cc.TILE_LAUNCHES)
        held = hold_rungs(
            f"fused_transpose_dot steps {steps} K={k} M={m} N={n}",
            lambda rung: cc.fused_transpose_dot(*ops, first, second, rung),
            lambda rung: cc.fused_transpose_reference(*ops, first, second, rung), exact,
            4.0 * 2 * (ops[0].numel() + ops[2].numel() + m * n), k * m * n, len(steps),
            library, reps=rung_reps(k * m * n),
            probe=lambda rung: cc.fused_transpose_dot(*probe, first, second, rung))
        del probe
        # the tile each rung's launches ran on
        tiles = {key.split()[1]: key.split()[2] for key, n_ in cc.TILE_LAUNCHES.items()
                 if key.startswith("fused_transpose_dot ") and n_ != tiles_before.get(key, 0)}
        check(sorted(tiles) == sorted(PRECISION_RUNGS),
              f"fused_transpose_dot steps {steps}: TF32 launches by tile {cc.TILE_LAUNCHES}")
        for rung, row in held.items():
            rows[rung].append({**row, "k": k, "m": m, "n": n, "steps": steps,
                               "tile": tiles[rung]})
        del ops, exact, a_c, b_c
        torch.cuda.empty_cache()
    return rows


def hold_chain_rungs(first_ops, link_ops, links, label: str, launches: int,
                     rungs=PRECISION_RUNGS) -> dict:
    """One chain through ``fused_chain`` at each rung: planned at the rung,
    two launches bitwise equal, then :func:`hold_rungs` (a chain of s
    stages is s products against float64). The holds' launches are taken
    back out of the counts."""
    import torch

    from tnc_tpu_torch.ops import cuda_complex as cc

    saved = dict(cc.LAUNCHES), dict(cc.CHAIN_FORMS), dict(cc.RUNG_LAUNCHES)
    plans = {rung: cc.chain_plan(first_ops, link_ops, links, precision=rung)
             for rung in ("float32",) + PRECISION_RUNGS}
    for rung, plan_r in plans.items():
        a = cc.fused_chain(first_ops, link_ops, links, plan_r, rung)
        b = cc.fused_chain(first_ops, link_ops, links, plan_r, rung)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"fused_chain {label} at {rung}: two launches differ")
    exact = cc.fused_chain_reference(tuple(t.double() for t in first_ops),
                                     [tuple(t.double() for t in pair) for pair in link_ops],
                                     links)
    ops = list(first_ops) + [t for pair in link_ops for t in pair]
    flat = probe_parts(ops)
    p_first, p_links = tuple(flat[:4]), [tuple(flat[i:i + 2]) for i in range(4, len(flat), 2)]

    def probe(rung):
        plan_p = cc.chain_plan(p_first, p_links, links, precision=rung)
        return cc.fused_chain(p_first, p_links, links, plan_p, rung)

    rows = hold_rungs(
        f"fused_chain {label} ({','.join(plans['high'].forms)})",
        lambda rung: cc.fused_chain(first_ops, link_ops, links, plans[rung], rung),
        lambda rung: cc.fused_chain_reference(first_ops, link_ops, links, rung), exact,
        sum(t.numel() for t in ops) * 4 + 2 * exact[0].numel() * 4,
        chain_macs(first_ops, link_ops, links), launches, stages=len(links) + 1, reps=20,
        probe=probe)
    del flat, p_first, p_links
    for live, before in zip((cc.LAUNCHES, cc.CHAIN_FORMS, cc.RUNG_LAUNCHES), saved):
        live.clear()
        live.update(before)
    return {rung: rows[rung] for rung in rungs}


def chain_macs(first_ops, link_ops, links) -> float:
    """Complex multiply-adds of a chain (every batch row)."""
    rows = max([t.shape[0] for t in list(first_ops) + [p[0] for p in link_ops]
                if t.dim() == 3], default=1)
    shape = (first_ops[0].shape[-1], first_ops[2].shape[-1])
    macs = rows * first_ops[0].shape[-2] * shape[0] * shape[1]
    for (cr, _), link in zip(link_ops, links):
        x = cr.shape[-1]
        macs += rows * shape[0] * shape[1] * x
        shape = link.out_shape(x)
    return float(macs)


def record_rung_chain_run(recorded: dict, counts: dict):
    """A hold for :func:`holding` of ``split_complex.run_chain_split`` that
    records, as :func:`record_chain_run` does, each distinct chain's operands
    and its rung (the chain's own: the backend's precision and the policy's
    entry), and counts its runs in ``counts`` (a graph host counter: replays
    count)."""
    from tnc_tpu_torch.ops.split_complex import _resolve_step_precision, chain_operands

    def hold(steps, buffers, batched=None, runs=None, key=None, precision=None,
             precision_mode="", *_):
        rung = _resolve_step_precision(precision, precision_mode)
        first, link_ops, links = chain_operands(steps, buffers,
                                                set() if batched is None else batched)
        k = (rung, chain_key(first, link_ops, links))
        if k not in recorded:
            recorded[k] = [tuple(t.clone() for t in first),
                           [tuple(t.clone() for t in pair) for pair in link_ops], links]
        counts[k] = counts.get(k, 0) + 1

    return hold


@contextlib.contextmanager
def recording_rung_chains(recorded: dict):
    """:func:`record_rung_chain_run` on every ``run_chain_split`` call while
    active; yields the counts, which CUDA-graph replays add to."""
    from tnc_tpu_torch.ops import graphs, split_complex

    counts: dict = {}
    real = graphs._counters
    graphs._counters = lambda: real() + (counts,)
    try:
        with holding("run_chain_split", record_rung_chain_run(recorded, counts),
                     split_complex):
            yield counts
    finally:
        graphs._counters = real


def rung_statevector_errors(leaf, refs) -> dict:
    """A random28 statevector's norm error and its four amplitudes' errors
    against complex128 (phase 4's), each over its gate: ``norm`` |<ψ|ψ> - 1|
    over 1e-4, ``amps`` |Δ| over 1e-4·max(|ref|, 2^-14)."""
    sv = np.asarray(leaf.data.into_data())
    norm = statevector_norm(sv)
    check(sv.shape == (2,) * QUBITS and math.isfinite(norm),
          f"statevector of shape {sv.shape} or a non-finite value")
    amps = []
    for bits, ref in refs["amplitudes"]:
        got = complex(sv[tuple(int(bits[refs["qubit_of"][leg]]) for leg in leaf.legs)])
        check(math.isfinite(got.real) and math.isfinite(got.imag), "non-finite amplitude")
        amps.append(abs(got - ref) / (1e-4 * max(abs(ref), 2.0 ** -14)))
    return {"norm": abs(norm - 1.0) / 1e-4, "amps": amps,
            "worst": max([abs(norm - 1.0) / 1e-4] + amps)}


def precision_refs(backend) -> dict:
    """What phase 21 holds its results to when it runs alone: phase 4's
    complex128 amplitudes of random28, phase 7's complex128 PEPS norm and
    phase 8's complex128 slices of m10, made here."""
    from tnc_tpu_torch.ops.backends import TorchBackend
    from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network

    tn, permutor = build_config(QUBITS)
    oracle = TorchBackend(dtype="complex128", split_complex=False)
    amplitudes = []
    for bits in np.random.default_rng(7).integers(0, 2, size=(4, QUBITS)):
        amp_tn, _ = build_config(QUBITS, "".join(str(int(b)) for b in bits))
        amplitudes.append((bits, complex(contract_tensor_network(
            amp_tn, plan(amp_tn), oracle).data.into_data())))
    peps_tn = build_peps(PEPS)
    z128 = scalar(contract_tensor_network(peps_tn, plan(peps_tn), oracle))
    return {"amplitudes": amplitudes,
            "qubit_of": {leg: q for q, leg in enumerate(permutor.target_leg_order)},
            "peps_norm_complex128": z128, "m10": m10_cell()}


def tf32_dot_steps(program, policy) -> int:
    """Steps of ``program`` that launch ``fused_complex_dot`` at a TF32
    rung under ``policy``: every step outside its chains but the
    ``fused_transpose`` steps whose gate admits them
    (``split_complex.apply_step_split``)."""
    from tnc_tpu_torch.ops.split_complex import fused_transpose_ineligible_reason

    chained = policy.chained_steps()
    return sum(1 for i, st in enumerate(program.steps) if i not in chained
               and not (policy.modes[i] == "fused_transpose"
                        and fused_transpose_ineligible_reason(st) is None))


def run_precision(refs: dict, gen) -> dict:
    """Phase 21: the dot-precision rungs ``high`` (3xTF32) and ``default``
    (one TF32 pass) on the card. At a TF32 rung every step outside the
    chains and the admitted ``fused_transpose`` steps launches
    ``fused_complex_dot`` at the rung, whatever its mode. Each kernel at
    each rung against its plain version at that rung and a float64
    product, timed beside its float32 time, the bound at the TF32 rate and
    the library call: every layout the PEPS cell's forced
    ``fused_transpose`` rung launches and each of random28's chains, with
    random operands; every ``fused_complex_dot`` launch of the runs below
    on its own operands, each distinct shape once (:func:`rung_dot_hold`).
    Then, at each rung: random28 under the forced ``fused`` rung and
    through ``contract_tensor_network`` with ``TorchBackend(precision=r)``
    (its chains through ``fused_chain`` at the rung), the PEPS norm under
    the forced ``fused_transpose`` rung, each launch count held to the
    steps and the holds; and m10 chunked at ``high``. ``high`` meets the
    complex64 gates against complex128; ``default``'s errors are printed,
    finite and larger."""
    import torch

    from tnc_tpu_torch.ops import cuda_complex as cc
    from tnc_tpu_torch.ops.backends import TorchBackend
    from tnc_tpu_torch.ops.program import build_program
    from tnc_tpu_torch.ops.split_complex import chain_operands, plan_kernels
    from tnc_tpu_torch.tensornetwork.contraction import (
        contract_tensor_network,
        contract_tensor_network_sliced,
    )

    def forced(mode, fn):
        os.environ["TNC_TPU_COMPLEX_MULT"] = mode
        try:
            return fn()
        finally:
            del os.environ["TNC_TPU_COMPLEX_MULT"]

    tn, _ = build_config(QUBITS)
    path = plan(tn)
    program = build_program(tn, path)
    policy = plan_kernels(program)
    peps_tn = build_peps(PEPS)
    peps_path = plan(peps_tn)
    peps_program = build_program(peps_tn, peps_path)
    admitted, _ = transpose_gate(peps_program)
    steps_of = {"random28": tf32_dot_steps(program, policy),
                "random28 forced fused": forced("fused", lambda: tf32_dot_steps(
                    program, plan_kernels(program))),
                "peps44_b32 forced fused_transpose": forced(
                    "fused_transpose", lambda: tf32_dot_steps(
                        peps_program, plan_kernels(peps_program)))}

    t0 = time.perf_counter()
    print("[precision] fused_transpose_dot at the PEPS cell's admitted layouts", flush=True)
    transpose_rows = rung_transpose_rows(peps_program, gen)
    print("[precision] fused_chain on random28's chains", flush=True)
    chain_rows = {rung: [] for rung in PRECISION_RUNGS}
    for s, e in policy.chains:
        steps = program.steps[s:e]
        buffers = random_buffers(program, chain_slot_sizes(steps), torch.float32, gen)
        for rung, row in hold_chain_rungs(*chain_operands(steps, buffers),
                                          f"random28 steps {s}..{e - 1}", 1).items():
            chain_rows[rung].append(row)
    torch.cuda.empty_cache()
    holds_s = time.perf_counter() - t0
    print(f"[precision] the transpose and chain rung holds in {holds_s:.1f} s", flush=True)

    dots = rung_dot_state()

    def counted(fn, label, rung, steps=None):
        """One synchronised, timed call with every count reset just before;
        its ``fused_complex_dot`` launches at ``rung`` equal to the holds'
        count and to ``steps``, and each shape first seen in it held after
        it."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cc.reset_launches()
        seen, before = len(dots["recorded"]), held_rung_launches(dots, rung)
        tiles_before = dict(dots["tiles"])
        t0 = time.perf_counter()
        with holding_rung_dots(dots, label):
            out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run = {"out": out, "wall_s": wall, "launches": dict(cc.RUNG_LAUNCHES),
               "tile_launches": dict(cc.TILE_LAUNCHES),
               "peak_bytes": torch.cuda.max_memory_allocated(),
               "shapes_recorded": len(dots["recorded"]) - seen}
        got = run["launches"].get(f"fused_complex_dot {rung}", 0)
        print(f"[precision {label}] wall {wall:.4f} s ({run['shapes_recorded']} launch "
              f"shapes first recorded in it), max_memory_allocated {run['peak_bytes']} "
              f"bytes, launches by rung {run['launches']}, TF32 launches by tile "
              f"{run['tile_launches']}", flush=True)
        check(sum(n for key, n in run["tile_launches"].items() if key.endswith(
            tuple(f" {t.name}" for t in cc.TF32_TILES)) and f" {rung} " in key)
              == sum(n for key, n in run["launches"].items() if key.endswith(f" {rung}")
                     and not key.startswith("fused_chain")),
              f"{label}: TF32 launches by tile {run['tile_launches']} do not add up to the "
              f"kernels' {run['launches']}")
        hook_tiles = {f"fused_complex_dot {key}": n - tiles_before.get(key, 0)
                      for key, n in dots["tiles"].items() if n != tiles_before.get(key, 0)}
        check(hook_tiles == {key: n for key, n in run["tile_launches"].items()
                             if key.startswith("fused_complex_dot ")},
              f"{label}: the holds recorded fused_complex_dot launches on the tiles "
              f"{hook_tiles}, the kernel counted {run['tile_launches']}")
        check(got == held_rung_launches(dots, rung) - before,
              f"{label}: {got} fused_complex_dot launches at {rung}, the holds counted "
              f"{held_rung_launches(dots, rung) - before}")
        check(steps is None or got == steps,
              f"{label}: {got} fused_complex_dot launches at {rung} for {steps} steps")
        t0 = time.perf_counter()
        hold_rung_dots(dots)
        run["holds_s"] = time.perf_counter() - t0
        print(f"[precision {label}] its {run['shapes_recorded']} new launch shapes held in "
              f"{run['holds_s']:.1f} s", flush=True)
        return run

    errors, records = {}, {}
    m10 = refs["m10"]
    chain_recorded: dict = {}
    m10_counts: dict = {}
    for rung in PRECISION_RUNGS:
        backend = TorchBackend(precision=rung)
        # the forced rung first: it records the shapes the default
        # policy's run then reuses
        fused = counted(lambda: forced("fused", lambda: contract_tensor_network(
            tn, path, backend)), f"random28 forced fused {rung}", rung,
            steps_of["random28 forced fused"])
        fused_err = rung_statevector_errors(fused.pop("out"), refs)
        main = counted(lambda: contract_tensor_network(tn, path, backend),
                       f"random28 {rung}", rung, steps_of["random28"])
        check(main["launches"].get(f"fused_chain {rung}", 0) == len(policy.chains),
              f"random28 at {rung}: fused_chain at the rung launched "
              f"{main['launches']} for {len(policy.chains)} chains")
        main_err = rung_statevector_errors(main.pop("out"), refs)
        ft = counted(lambda: forced("fused_transpose", lambda: contract_tensor_network(
            peps_tn, peps_path, backend)), f"peps44_b32 forced fused_transpose {rung}", rung,
            steps_of["peps44_b32 forced fused_transpose"])
        check(ft["launches"].get(f"fused_transpose_dot {rung}", 0) == admitted,
              f"peps forced fused_transpose at {rung}: {ft['launches']} for {admitted} "
              f"admitted steps")
        z, z128 = scalar(ft.pop("out")), refs["peps_norm_complex128"]
        peps_rel = abs(z - z128) / abs(z128)
        errors[rung] = {"random28": main_err, "random28_fused": fused_err,
                        "peps44_b32_fused_transpose": peps_rel / 1e-4}
        records[rung] = {"random28_wall_s": main["wall_s"],
                         "random28_shapes_recorded": main["shapes_recorded"],
                         "random28_peak_bytes": main["peak_bytes"],
                         "random28_launches": main["launches"],
                         "random28_tile_launches": main["tile_launches"],
                         "random28_fused_tile_launches": fused["tile_launches"],
                         "peps44_b32_fused_transpose_tile_launches": ft["tile_launches"],
                         "random28_fused_wall_s": fused["wall_s"],
                         "random28_fused_launches": fused["launches"],
                         "peps44_b32_fused_transpose_wall_s": ft["wall_s"],
                         "peps44_b32_fused_transpose_launches": ft["launches"],
                         "peps_norm": [z.real, z.imag], "peps_rel": peps_rel,
                         "errors_over_gate": errors[rung]}
        print(f"[precision {rung}] against complex128, over each gate: random28 norm "
              f"{main_err['norm']:.3e}, amplitudes "
              f"{[round(a, 4) for a in main_err['amps']]}; forced fused norm "
              f"{fused_err['norm']:.3e}, amplitudes {[round(a, 4) for a in fused_err['amps']]}; "
              f"peps44_b32 forced fused_transpose relative {peps_rel:.3e} (gate 1e-4)",
              flush=True)
        if rung == "high":
            # m10 chunked at high: every chain recorded and held after the
            # run, every fused_complex_dot launch held in it
            with recording_rung_chains(chain_recorded) as m10_counts:
                sl = counted(lambda: contract_tensor_network_sliced(
                    m10["tn"], m10["path"], m10["slicing"], backend), "m10 chunked high",
                    rung)
            got, want = scalar(sl.pop("out")), sum(m10["refs"])
            abs_sum = sum(abs(r) for r in m10["refs"])
            m10_over = abs(got - want) / (1e-4 * abs_sum)
            print(f"[precision high] sycamore53_m10 chunked: {got!r} vs complex128 {want!r}, "
                  f"|diff| over its gate (1e-4 x sum|ref_s|) {m10_over:.3e}", flush=True)
            check(m10_over <= 1.0, f"m10 chunked at high off complex128 by {abs(got - want)}")
            check(sl["launches"].get("fused_chain high", 0) == sum(m10_counts.values()),
                  f"m10 at high: {sl['launches']} against {sum(m10_counts.values())} recorded")
            records[rung].update(m10_wall_s=sl["wall_s"], m10_peak_bytes=sl["peak_bytes"],
                                 m10_launches=sl["launches"], m10_over_gate=m10_over,
                                 m10_tile_launches=sl["tile_launches"],
                                 m10_shapes_recorded=sl["shapes_recorded"],
                                 amplitude_m10=[got.real, got.imag])
            for over in (main_err["worst"], fused_err["worst"], peps_rel / 1e-4):
                check(over <= 1.0, f"high misses a complex64 gate: {errors['high']}")
        torch.cuda.empty_cache()
    for key in ("random28", "random28_fused"):
        check(errors["default"][key]["worst"] > errors["high"][key]["worst"],
              f"{key}: default's error {errors['default'][key]['worst']} is not above "
              f"high's {errors['high'][key]['worst']}")
    check(errors["default"]["peps44_b32_fused_transpose"]
          > errors["high"]["peps44_b32_fused_transpose"],
          "peps44_b32: default's error is not above high's")
    # m10's chains at high, held after the run
    for i, (key, (first, link_ops, links)) in enumerate(chain_recorded.items()):
        rung = key[0]
        held = hold_chain_rungs(first, link_ops, links, f"m10 chunked chain {i}",
                                m10_counts.get(key, 0), rungs=(rung,))
        chain_rows[rung].append(held[rung])
    records["holds_s"] = holds_s
    records["tf32_dot_steps"] = steps_of
    dot_rows = rung_dot_rows(dots)
    records["largest"] = {"fused_complex_dot": largest_rows("fused_complex_dot", dot_rows),
                          "fused_transpose_dot": largest_rows("fused_transpose_dot",
                                                              transpose_rows)}
    return {"record": records, "dot_rows": dot_rows,
            "transpose_rows": transpose_rows, "chain_rows": chain_rows}


def largest_rows(name: str, rows_by_rung: dict, top: int = 4) -> dict:
    """The ``top`` held shapes with the most multiply-adds of a kernel at
    each TF32 rung, printed and returned: the tile, ms beside the library's
    TF32 call (``default``) and the bound, and the share of the bound."""
    from tnc_tpu_torch.ops import cuda_complex as cc

    out = {}
    for rung, rows in rows_by_rung.items():
        big = sorted(rows, key=lambda r: -r.get("batch", 1) * r["k"] * r["m"] * r["n"])[:top]
        out[rung] = []
        for r in big:
            tile = r.get("tile") or cc.tf32_config(r["k"], r["m"], r["n"], rung).name
            lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
            share = r["bound_ms"] / r["ms"]
            print(f"[precision] {name} {rung} largest: batch {r.get('batch', 1)} K={r['k']} "
                  f"M={r['m']} N={r['n']} ({tile}, {r['launches']} launches): {r['ms']:.4f} ms, "
                  f"library {lib}, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
                  f"{share:.1%} of the bound", flush=True)
            out[rung].append({"k": r["k"], "m": r["m"], "n": r["n"],
                              "batch": r.get("batch", 1), "tile": tile,
                              "launches": r["launches"], "ms": r["ms"],
                              "library_ms": r["library_ms"], "bound_ms": r["bound_ms"],
                              "share_of_bound": share})
    return out


def precision_kernels(prec: dict, calibrated_dots: dict | None = None) -> dict:
    """Each kernel's record at each TF32 rung (:func:`rung_record`), the
    rows weighing exactly the launches phase 21's paths counted, and
    ``fused_complex_dot``'s also those of the stem steps phase 11's fitted
    model promoted to ``high`` (``calibrated_dots``, its hold state)."""
    rows = {name: dict(prec[key]) for name, key in (
        ("fused_complex_dot", "dot_rows"), ("fused_transpose_dot", "transpose_rows"),
        ("fused_chain", "chain_rows"))}
    if calibrated_dots is not None:
        for rung, extra in rung_dot_rows(calibrated_dots).items():
            rows["fused_complex_dot"][rung] = rows["fused_complex_dot"][rung] + extra
    return {name: {rung: rung_record(by[rung]) for rung in PRECISION_RUNGS}
            for name, by in rows.items()}


def rung_record(rows) -> dict:
    """A kernel's record at one rung over its rows, each time a mean over
    the rows' launches."""
    n = sum(r["launches"] for r in rows)

    def mean(key):
        vals = [r[key] for r in rows]
        if n == 0 or any(v is None for v in vals):
            return None
        return sum(r["launches"] * r[key] for r in rows) / n

    if not n:
        return {"launches": 0}
    by_bytes = sum(r["launches"] * r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
    return {"launches": n, "max_abs_err": max(r["err"] for r in rows),
            "max_f64_rel": max(r["f64_rel"] for r in rows if r["f64_rel"] is not None),
            "max_plain_rel": max(r["plain_rel"] for r in rows),
            "ms": mean("ms"), "float32_ms": mean("float32_ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": mean("bound_ms"),
            "bound_by": "bytes" if 2 * by_bytes > n * mean("bound_ms") else "operations",
            "library_ms": mean("library_ms")}


def main() -> int:
    if sys.argv[1:2] == [NORTHSTAR_PLAN_FLAG] and len(sys.argv) == 3:
        return make_northstar_plan(sys.argv[2])
    if sys.argv[1:2] == [QASM_SWEEP_FLAG] and len(sys.argv) == 3:
        return make_qasm_sweep(sys.argv[2])
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from tnc_tpu_torch.ops import cuda_complex
    except ImportError as e:
        print(f"chip_smoke: the tnc_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 2
    from tnc_tpu_torch.ops.backends import NumpyBackend, TorchBackend
    from tnc_tpu_torch.ops.program import build_program
    from tnc_tpu_torch.ops.split_complex import plan_kernels
    from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network

    card = card_line()
    print(f"[card] {card}", flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # 1. build
    t0 = time.perf_counter()
    phase_s: dict = {}
    clock = [t0]

    def phase_done(n: int) -> None:
        """Print and keep the seconds since the previous phase ended."""
        now = time.perf_counter()
        phase_s[n] = now - clock[0]
        clock[0] = now
        print(f"[phase {n}] {phase_s[n]:.1f} s", flush=True)

    libs = cuda_complex.build_kernels()
    print(f"[build] {len(cuda_complex.BUILD_LOG)} kernels in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in cuda_complex.BUILD_LOG.items():
        for label, regs, spill in kernel_instances(log):
            print(f"  {name} {label}: {regs} registers, {spill} bytes spill stores",
                  flush=True)
            check(not label.startswith("tf32") or spill == 0,
                  f"{name} {label} spills {spill} bytes")
    sass = check_sass(libs)

    backend = TorchBackend()  # turns TF32 off
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul left on")
    if "--northstar-full" in sys.argv[1:]:
        # the north star over all its slices, once: phase 10 alone
        full = run_northstar(backend, reps=1, run_slices=None)
        print(json.dumps({"sycamore53_m14_hyper_full": full["record"],
                          "shapes": {"fused_chain": full["chain_rows"],
                                     "fused_complex_dot": full["dot_rows"]}}), flush=True)
        print(card_line(), flush=True)
        return 0
    if "--calibrated" in sys.argv[1:]:
        # the calibrated kernel ladder alone: phase 11, its references made here
        cal = run_calibrated(calibrated_refs(backend),
                             torch.Generator(device="cuda").manual_seed(SEED))
        print(json.dumps({"calibrated": cal["record"],
                          "shapes": {"fused_chain": cal["chain_rows"]}}), flush=True)
        print(card_line(), flush=True)
        return 0

    if "--grad" in sys.argv[1:]:
        # gradients and the approximate tier alone: phase 13, no fitted model
        grad = run_grad()
        print(json.dumps({"grad": grad["record"],
                          "shapes": {"fused_chain": grad["chain_rows"]}}), flush=True)
        print(card_line(), flush=True)
        return 0

    if "--serve" in sys.argv[1:]:
        # the serving front end and resilience alone: phase 14
        serve = run_serve()
        print(json.dumps({"serve": serve["record"],
                          "launches_by_path": {"fused_chain": serve["chain_launches"]},
                          "kernels_by_path": {"fused_chain": {
                              k: chain_record(r) for k, r in serve["chain_rows"].items()}},
                          "shapes": {"fused_chain": [
                              r for rows in serve["chain_rows"].values() for r in rows]}}),
              flush=True)
        print(card_line(), flush=True)
        return 0

    if "--planes" in sys.argv[1:]:
        # the in-process serving planes alone: phase 15, its references made here
        planes = run_planes()
        print(json.dumps({"planes": planes["record"],
                          "launches_by_path": {"fused_chain": planes["chain_launches"]},
                          "kernels_by_path": {"fused_chain": {
                              k: chain_record(r) for k, r in planes["chain_rows"].items()}},
                          "shapes": {"fused_chain": [
                              r for rows in planes["chain_rows"].values() for r in rows]}}),
              flush=True)
        print(card_line(), flush=True)
        return 0

    if "--partitioned" in sys.argv[1:]:
        # the partitioned planner alone: phase 16, no fitted model
        part = run_partitioned()
        print(json.dumps({"partitioned": part["record"],
                          "launches_by_path": {"fused_chain": part["chain_launches"]},
                          "kernels_by_path": {"fused_chain": {
                              k: chain_record(r) for k, r in part["chain_rows"].items()}},
                          "shapes": {"fused_chain": [
                              r for rows in part["chain_rows"].values() for r in rows]}}),
              flush=True)
        print(card_line(), flush=True)
        return 0

    if "--fleet" in sys.argv[1:]:
        # the fleet on one card alone: phase 18, phase 14's references made here
        fleet = run_fleet(*fleet_refs(serve_rows()))
        print(json.dumps({"fleet": fleet["record"],
                          "launches_by_path": {"fused_chain": fleet["chain_launches"]},
                          "kernels_by_path": {"fused_chain": {
                              k: chain_record(r) for k, r in fleet["chain_rows"].items()}},
                          "shapes": {"fused_chain": [
                              r for rows in fleet["chain_rows"].values() for r in rows]}}),
              flush=True)
        print(card_line(), flush=True)
        return 0

    if "--parallel" in sys.argv[1:]:
        # the multi-GPU executors alone: phase 17 on phase 16's plans (run
        # first, no fitted model, no phase 12 value) and phase 8's plan
        part = run_partitioned()
        par = run_parallel(part["cells"], m10_cell())
        rows = {**part["chain_rows"], **par["chain_rows"]}
        print(json.dumps({"partitioned": part["record"], "parallel": par["record"],
                          "launches_by_path": {"fused_chain": {
                              **part["chain_launches"], **par["chain_launches"]}},
                          "kernels_by_path": {"fused_chain": {
                              k: chain_record(r) for k, r in rows.items()}},
                          "shapes": {"fused_chain": [
                              r for cell in rows.values() for r in cell]}}), flush=True)
        print(card_line(), flush=True)
        return 0

    if "--qasm" in sys.argv[1:]:
        # the benchmark CLI on QASM circuits alone: phase 19, its sweeps waited for
        qasm = run_qasm(QasmSweep())
        print(json.dumps({"qasm": qasm["record"],
                          "launches_by_path": {"fused_chain": qasm["chain_launches"]},
                          "kernels_by_path": {"fused_chain": {
                              k: chain_record(r) for k, r in qasm["chain_rows"].items()}},
                          "shapes": {"fused_chain": [
                              r for rows in qasm["chain_rows"].values() for r in rows]}}),
              flush=True)
        print(card_line(), flush=True)
        return 0

    if "--examples" in sys.argv[1:]:
        # the port's examples that touch the device alone: phase 20
        ex = run_examples()
        print(json.dumps({"examples": ex["record"],
                          "launches_by_path": {"fused_chain": ex["chain_launches"]},
                          "kernels_by_path": {"fused_chain": {
                              k: chain_record(r) for k, r in ex["chain_rows"].items()}},
                          "shapes": {"fused_chain": [
                              r for rows in ex["chain_rows"].values() for r in rows]}}),
              flush=True)
        print(card_line(), flush=True)
        return 0

    if "--precision" in sys.argv[1:]:
        # the dot-precision rungs alone: phase 21, its references made here
        prec = run_precision(precision_refs(backend),
                             torch.Generator(device="cuda").manual_seed(SEED))
        print(json.dumps({"precision": prec["record"], "sass": sass,
                          "kernels_by_rung": precision_kernels(prec)}), flush=True)
        print(card_line(), flush=True)
        return 0

    if "--sweep" in sys.argv[1:]:
        # the batched sweep and the query path alone: phase 12
        sweep = run_sweep()
        print(json.dumps({sweep["label"]: sweep["record"],
                          "shapes": {"fused_chain": sweep["chain_rows"],
                                     "fused_complex_dot": sweep["dot_rows"]}}), flush=True)
        print(card_line(), flush=True)
        return 0

    # the north star's plan (phase 10) and phase 19's QASM sweeps are made
    # beside phases 2-9
    northstar_plan = BackgroundPlan()
    qasm_sweeps = QasmSweep()
    phase_done(1)

    # 2. plan + kernels against their plain versions
    tn, permutor = build_config(QUBITS)
    path = plan(tn)
    program = build_program(tn, path)
    policy = plan_kernels(program)
    admitted, routed = transpose_gate(program)
    print(f"[plan] {QUBITS} qubits: {len(program.steps)} steps, "
          f"{len(policy.chains)} chains {list(policy.chains)}; fused_transpose gate "
          f"admits {admitted}, routes {routed}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    print("[kernels] fused_chain against fused_chain_reference", flush=True)
    chain_rows = check_chains(program, policy, gen)
    print("[kernels] fused_chain grid form, on a synthetic chain beyond shared memory",
          flush=True)
    grid_row = check_grid_chain(gen)
    print("[kernels] launch floors", flush=True)
    floors = launch_floors()
    print("[kernels] fused_complex_dot against fused_complex_dot_reference", flush=True)
    dot_rec = check_dot(program, gen)
    torch.cuda.empty_cache()

    phase_done(2)

    # 3. main path
    main = run_main_path(tn, path, backend, "main path", reps=2)
    sv_leaf, walls, launches = main["out"], main["walls"], main["launches"]
    main_forms = main["chain_forms"]
    del main
    check(launches["fused_chain"] == len(policy.chains),
          f"fused_chain launched {launches['fused_chain']} times for "
          f"{len(policy.chains)} chains")
    check(launches["fused_chain"] > 0, "main path launched no fused_chain")
    chain_launches = {"random28": launches["fused_chain"]}
    chain_forms = {"random28": main_forms}

    phase_done(3)

    # 4. correctness
    sv = np.asarray(sv_leaf.data.into_data())
    norm = statevector_norm(sv)
    check(sv.shape == (2,) * QUBITS and math.isfinite(norm),
          f"statevector has shape {sv.shape} or non-finite values")
    print(f"[check] statevector norm {norm:.8f}", flush=True)
    check(abs(norm - 1.0) <= 1e-4, f"norm {norm} not within 1e-4 of 1")
    qubit_of = {leg: q for q, leg in enumerate(permutor.target_leg_order)}
    oracle = TorchBackend(dtype="complex128", split_complex=False)
    amplitudes = []
    for bits in np.random.default_rng(7).integers(0, 2, size=(4, QUBITS)):
        bitstring = "".join(str(int(b)) for b in bits)
        amp_tn, _ = build_config(QUBITS, bitstring)
        ref = complex(contract_tensor_network(amp_tn, plan(amp_tn), oracle)
                      .data.into_data())
        got = complex(sv[tuple(int(bits[qubit_of[leg]]) for leg in sv_leaf.legs)])
        tol = 1e-4 * max(abs(ref), 2.0 ** -14)
        print(f"[check] amplitude {bitstring}: statevector {got:.6e} "
              f"complex128 {ref:.6e} |diff| {abs(got - ref):.3e} (tol {tol:.3e})",
              flush=True)
        check(abs(got - ref) <= tol, f"amplitude {bitstring} off by {abs(got - ref)}")
        amplitudes.append((bits, ref))
    small_tn, _ = build_config(SMALL_QUBITS)
    small_path = plan(small_tn)
    got = contract_tensor_network(small_tn, small_path, backend).data.into_data()
    want = contract_tensor_network(small_tn, small_path, NumpyBackend()).data.into_data()
    diff = float(np.max(np.abs(got - want)))
    print(f"[check] {SMALL_QUBITS}-qubit statevector vs complex128 numpy: "
          f"max|diff| {diff:.3e}", flush=True)
    check(diff <= 1e-5, f"{SMALL_QUBITS}-qubit statevector off by {diff}")
    del sv_leaf

    phase_done(4)

    # 5. forced fused rung
    os.environ["TNC_TPU_COMPLEX_MULT"] = "fused"
    try:
        fused = run_main_path(tn, path, backend, "fused rung", reps=1)
    finally:
        del os.environ["TNC_TPU_COMPLEX_MULT"]
    fused_leaf, fused_walls, launches = fused["out"], fused["walls"], fused["launches"]
    del fused
    check(launches["fused_complex_dot"] > 0, "fused rung launched no fused_complex_dot")
    check(launches["fused_complex_dot"] == dot_rec["expect"],
          f"fused rung launched fused_complex_dot {launches['fused_complex_dot']} times; "
          f"its timed shapes weigh {dot_rec['expect']} launches")
    dot_launches = {"random28 fused rung": launches["fused_complex_dot"]}
    fused_sv = np.asarray(fused_leaf.data.into_data())
    stats = statevector_stats(fused_sv, sv)
    scale, fdiff = stats["scale"], stats["diff"]
    print(f"[fused rung] max|diff| vs main path {fdiff:.3e} (scale {scale:.3e})",
          flush=True)
    check(stats["close"], "fused rung disagrees with the main path")
    del fused_leaf, fused_sv

    phase_done(5)

    # 6. where the main path's time goes
    prof = profile_device_path(device_run(tn, path, backend), "random28")

    phase_done(6)

    # 7. the PEPS cell: the transpose kernel at the plan's shapes, then
    # the path under the default policy and the forced fused_transpose rung
    peps_tn = build_peps(PEPS)
    peps_program = build_program(peps_tn, plan(peps_tn))
    del peps_tn
    print("[kernels] fused_transpose_dot against fused_transpose_reference", flush=True)
    transpose_rec = check_transpose(peps_program, gen)
    torch.cuda.empty_cache()
    peps_rec = run_peps(backend)
    transpose_rec["launches"] = peps_rec["fused_transpose_launches"]
    torch.cuda.empty_cache()

    phase_done(7)

    # 8. the sliced cell on the per-slice loop, unhoisted
    sliced = run_sliced(TorchBackend(sliced_strategy="loop", hoist=False))
    chain_launches["sycamore53_m10_sliced"] = sliced["chain_launches"]
    chain_forms["sycamore53_m10_sliced"] = sliced["record"]["chain_forms"]
    dot_launches["sycamore53_m10_sliced fused rung"] = sliced["dot_launches"]
    torch.cuda.empty_cache()

    phase_done(8)

    # 9. the sliced cell on the default path (stem hoisted, residual chunked
    # and batched over slices), and the two small amplitudes whose residuals
    # keep chains, through the batched fused_chain
    m10 = sliced.pop("cell")  # phase 17 runs its plan again
    chunked = run_sliced_chunked(backend, m10)
    dot_launches["sycamore53_m10_chunked fused rung"] = chunked["dot_launches"]
    torch.cuda.empty_cache()
    small = run_chunked_small(backend)
    chain_launches.update(small["launches"])
    chain_forms.update({name: r["fused_chain_forms"] for name, r in small["records"].items()})
    torch.cuda.empty_cache()

    phase_done(9)

    # 10. the north star: sycamore(53, 14) planned by the port's hyper-optimizer
    # and slice_and_reconfigure, all its slices on the default path
    northstar = run_northstar(backend, reps=1, planned=northstar_plan)
    chain_launches["sycamore53_m14_hyper"] = northstar["chain_launches"]
    chain_forms["sycamore53_m14_hyper"] = northstar["record"]["chain_forms"]
    dot_launches["sycamore53_m14_hyper fused rung"] = northstar["dot_launches"]
    torch.cuda.empty_cache()

    phase_done(10)

    # 11. the calibrated kernel ladder: a device model fitted to the card's
    # step spans, random28 and peps44_b32 planned and run under it, and the
    # card's Strassen crossover
    calibrated = run_calibrated(
        {"sv": sv, "qubit_of": qubit_of, "amplitudes": amplitudes,
         "peps_norm": complex(*peps_rec["norm"]),
         "peps_norm_complex128": complex(*peps_rec["norm_complex128"]),
         "main_walls": walls, "main_device_s": prof["device_s"],
         "peps_wall_s": peps_rec["wall_s"], "peps_device_s": peps_rec["device_s"]}, gen)
    del sv
    chain_launches.update(calibrated["chain_launches"])
    transpose_rec["launches"] += calibrated["transpose_launches"]
    torch.cuda.empty_cache()

    phase_done(11)

    # 12. the batched amplitude sweep of sycamore(53, 8), its serving path and
    # forced fused rung, and the marginal and sampling queries at 20 qubits
    sweep = run_sweep()
    chain_launches[sweep["label"]] = sweep["chain_launches"]
    chain_launches.update(sweep["query_chain_launches"])
    chain_forms[sweep["label"]] = sweep["record"]["chain_forms"]
    dot_launches[f"{sweep['label']} fused rung"] = sweep["dot_launches"]
    torch.cuda.empty_cache()

    phase_done(12)

    # 13. gradients and the approximate tier: config #4's expectation value
    # and MaxCut gradient, the 53-qubit sliced gradient, the sweep gradient,
    # and the chi ladders, each rung priced by phase 11's fitted model
    from tnc_tpu_torch.obs.calibrate import CalibratedCostModel

    fitted = calibrated["record"]["model"]
    grad = run_grad(CalibratedCostModel(fitted["flops_per_s"], fitted["dispatch_s"],
                                        fitted["bytes_per_s"]))
    chain_launches[f"{grad['label']} <Z...Z>"] = grad["chain_launches"]
    torch.cuda.empty_cache()

    phase_done(13)

    # 14. the serving front end and resilience: the micro-batching service
    # over phase 12's circuit (plan cache, reuse store, fault frames), the
    # checkpointed sliced branch, the mixed query queue, the approximate tier
    serve = run_serve()
    chain_launches.update(serve["chain_launches"])
    torch.cuda.empty_cache()

    phase_done(14)

    # 15. the in-process serving planes: the replanner's swap, the SLO engine,
    # telemetry, cost truth and trace export on phase 14's rows, the OOM
    # degradation ladder on phase 12's amplitude, the planner pod at 20 qubits
    planes = run_planes(serve["refs"])
    chain_launches.update(planes["chain_launches"])
    torch.cuda.empty_cache()

    phase_done(15)

    # 16. the partitioned planner: config #4 planned by find_partitioning and
    # SA (and by balance_partitions_iter), phase 12's network cut by
    # plan_treecut, each contracted on the card
    zero = sweep["record"]["complex128"][0]
    part = run_partitioned(CalibratedCostModel(fitted["flops_per_s"], fitted["dispatch_s"],
                                               fitted["bytes_per_s"]),
                           complex(zero[0], zero[1]))
    chain_launches.update(part["chain_launches"])
    phase_done(16)

    # 17. the multi-GPU executors on the one card: phase 16's tree cut over
    # four device slots, config #5 partitioned and globally sliced over eight,
    # phase 8's amplitude in an NCCL rank, and two gloo ranks sharing the card
    par = run_parallel(part["cells"], m10)
    chain_launches.update(par["chain_launches"])
    torch.cuda.empty_cache()
    phase_done(17)

    # 18. the fleet on one card: two gloo ranks serving phase 14's rows through
    # a ClusterDispatcher and serve_cluster, the federated view, a killed worker,
    # elastic scheduling
    fleet = run_fleet(serve["refs"], serve["sliced_clean"])
    chain_launches.update(fleet["chain_launches"])
    phase_done(18)

    # 19. the benchmark CLI: two QASM circuits swept beside phases 2-9, one
    # run process over both artifacts, then each artifact contracted here
    qasm = run_qasm(qasm_sweeps)
    chain_launches.update(qasm["chain_launches"])
    phase_done(19)

    # 20. the port's examples that touch the device, each main() on the card
    examples = run_examples()
    chain_launches.update(examples["chain_launches"])
    torch.cuda.empty_cache()
    phase_done(20)

    # 21. the dot-precision rungs: each kernel at high (3xTF32) and default
    # (TF32) against its plain version and float64; random28, its forced
    # fused rung, the PEPS cell's forced fused_transpose rung at both, m10
    # chunked at high, against phase 4's, 7's and 8's complex128 values
    prec = run_precision({"amplitudes": amplitudes, "qubit_of": qubit_of,
                          "peps_norm_complex128": complex(*peps_rec["norm_complex128"]),
                          "m10": {**m10, "refs": sliced_refs(m10)}}, gen)
    by_rung = precision_kernels(prec, calibrated["rung_dots"])
    torch.cuda.empty_cache()
    phase_done(21)

    # 22. the records

    # each kernel's record over the launches of every path: a row's times
    # weigh as many launches as that path makes at the row's operands
    calibrated_chains = {}
    for name in ("random28", "peps44_b32"):
        rows = [r for r in calibrated["chain_rows"]
                if r["label"].startswith(f"{name} calibrated")]
        if rows:
            calibrated_chains[f"{name} calibrated"] = chain_record(rows)
    # the sweep's chains apart by kind: batched on the bras, unbatched, the queries'
    sweep_kinds = {
        f"{sweep['label']} batched": lambda r: r["label"].startswith(sweep["label"])
        and r["batch"] > 1,
        f"{sweep['label']} unbatched": lambda r: r["label"].startswith(sweep["label"])
        and r["batch"] == 1,
        "sycamore20_m8 marginals": lambda r: r["label"].startswith("sycamore20_m8 marginals"),
        "sycamore20_m8 sampler": lambda r: r["label"].startswith("sycamore20_m8 sampler"),
    }
    sweep_chains = {name: chain_record(rows) for name, keep in sweep_kinds.items()
                    if (rows := [r for r in sweep["chain_rows"] if keep(r)])}
    by_path = {
        "fused_chain": {"random28": chain_record(chain_rows),
                        "sycamore53_m10_sliced": chain_record(sliced["chain_rows"]),
                        **{name: chain_record([r for r in small["chain_rows"]
                                               if r["label"].startswith(f"{name} launch")])
                           for name in small["launches"]},
                        "sycamore53_m14_hyper": chain_record(northstar["chain_rows"]),
                        **calibrated_chains,
                        **sweep_chains,
                        f"{grad['label']} <Z...Z>": chain_record(grad["chain_rows"]),
                        **{k: chain_record(r) for k, r in serve["chain_rows"].items()},
                        **{k: chain_record(r) for k, r in planes["chain_rows"].items()},
                        **{k: chain_record(r) for k, r in part["chain_rows"].items()},
                        **{k: chain_record(r) for k, r in par["chain_rows"].items()},
                        **{k: chain_record(r) for k, r in fleet["chain_rows"].items()},
                        **{k: chain_record(r) for k, r in qasm["chain_rows"].items()},
                        **{k: chain_record(r) for k, r in examples["chain_rows"].items()}},
        "fused_complex_dot": {"random28 fused rung": launch_weighted(dot_rec["shapes"]),
                              "sycamore53_m10_sliced fused rung":
                                  launch_weighted(sliced["dot_rows"]),
                              "sycamore53_m10_chunked fused rung":
                                  launch_weighted(chunked["dot_rows"]),
                              "sycamore53_m14_hyper fused rung":
                                  launch_weighted(northstar["dot_rows"]),
                              f"{sweep['label']} fused rung":
                                  launch_weighted(sweep["dot_rows"])},
        "fused_transpose_dot": {"peps44_b32 fused_transpose rung":
                                launch_weighted(transpose_rec["shapes"])},
    }
    chain_rows += (sliced["chain_rows"] + small["chain_rows"] + northstar["chain_rows"]
                   + calibrated["chain_rows"] + sweep["chain_rows"] + grad["chain_rows"]
                   + [r for rows in serve["chain_rows"].values() for r in rows]
                   + [r for rows in planes["chain_rows"].values() for r in rows]
                   + [r for rows in part["chain_rows"].values() for r in rows]
                   + [r for rows in par["chain_rows"].values() for r in rows]
                   + [r for rows in fleet["chain_rows"].values() for r in rows]
                   + [r for rows in qasm["chain_rows"].values() for r in rows]
                   + [r for rows in examples["chain_rows"].values() for r in rows])
    # every path's rows weigh the launches it counted, so the record's times
    # are means over exactly the launches the line reports
    weighed = sum(r["launches"] for r in chain_rows)
    check(weighed == sum(chain_launches.values()),
          f"fused_chain rows weigh {weighed} launches, the paths counted "
          f"{sum(chain_launches.values())}")
    chain_rec = {**chain_record(chain_rows), "launches": sum(chain_launches.values())}
    dot_rows = (dot_rec["shapes"] + sliced["dot_rows"] + chunked["dot_rows"]
                + northstar["dot_rows"] + sweep["dot_rows"])
    dot_rec = {**launch_weighted(dot_rows), "launches": sum(dot_launches.values()),
               "max_abs_err": max([r["err"] for r in dot_rows] + [dot_rec["ragged_err"]]),
               "float64_errors": dot_rec["float64_errors"]}

    kernels = [
        dict(name="fused_chain", route="cuda",
             source="tnc_tpu_torch/ops/csrc/fused_chain.cu",
             replaces="tnc_tpu/ops/pallas_complex.py:637", **chain_rec),
        dict(name="fused_complex_dot", route="cuda",
             source="tnc_tpu_torch/ops/csrc/fused_complex_dot.cu",
             replaces="tnc_tpu/ops/pallas_complex.py:113", **dot_rec),
        dict(name="fused_transpose_dot", route="cuda",
             source="tnc_tpu_torch/ops/csrc/fused_transpose_dot.cu",
             replaces="tnc_tpu/ops/pallas_complex.py:391", **transpose_rec),
    ]
    # the top-level numbers are the float32 paths' (phases 2-20); launches
    # count every rung's, and by_rung gives each rung's launches and times
    for rec in kernels:
        float32 = {k: rec[k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms")}
        rec["by_rung"] = {"float32": float32, **by_rung[rec["name"]]}
        rec["launches"] = sum(r["launches"] for r in rec["by_rung"].values())
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "by_rung")
    phase_done(22)
    print(json.dumps({
        "main_path": {"qubits": QUBITS, "depth": DEPTH, "seed": SEED,
                      "steps": len(program.steps), "chains": len(policy.chains),
                      "wall_s": statistics.median(walls), "wall_runs_s": walls,
                      "fused_rung_wall_s": fused_walls[0], **prof},
        "peps": peps_rec,
        "sycamore53_m10_sliced": sliced["record"],
        "sycamore53_m10_chunked": chunked["record"],
        "chunked_small": small["records"],
        "sycamore53_m14_hyper": northstar["record"],
        "calibrated": calibrated["record"],
        sweep["label"]: sweep["record"],
        "grad": grad["record"],
        "serve": serve["record"],
        "planes": planes["record"],
        "partitioned": part["record"],
        "parallel": par["record"],
        "fleet": fleet["record"],
        "qasm": qasm["record"],
        "examples": examples["record"],
        "precision": prec["record"],
        "sass": sass,
        "phase_seconds": phase_s,
        "launches_by_path": {"fused_chain": chain_launches,
                             "fused_complex_dot": dot_launches},
        "fused_chain_forms_by_path": chain_forms,
        "fused_chain_grid_form": grid_row,
        "launch_floors": floors,
        "kernels_by_path": by_path,
        "shapes": {"fused_chain": chain_rows, "fused_complex_dot": dot_rows,
                   "fused_transpose_dot": transpose_rec["shapes"]},
        "float64_errors": {"fused_complex_dot": dot_rec["float64_errors"],
                           "fused_transpose_dot": transpose_rec["float64_errors"]},
    }), flush=True)
    print(json.dumps({"kernels": [{k: rec[k] for k in keys} for rec in kernels]}),
          flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
