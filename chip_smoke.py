#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tnc_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs one CUDA device and ``nvcc`` (``CUDA_HOME`` or ``/usr/local/cuda``).
Phases, each of which raises on failure (nothing is caught):

1. the card's name and power limit; build both hand kernels from
   ``tnc_tpu_torch/ops/csrc`` (one ``nvcc`` per source, in parallel);
2. plan the main path's configuration — a 28-qubit, depth-12 random
   circuit on the Sycamore layout (p1 = p2 = 0.4, seed 42), contracted to
   its open statevector with the ``Greedy`` path — and hold each kernel
   against its plain PyTorch version on the card at the program's own
   shapes: every chain group through ``fused_chain``, medium and stem
   steps (and a ragged shape) through ``fused_complex_dot``, with one
   float64 case each; time kernel, plain version and library call (device
   time from ``torch.profiler``, and wall time per call) beside the bound;
3. the main path: ``contract_tensor_network(tn, path, TorchBackend())``
   once to warm up and three times timed, launch counts reset just before
   each timed run and read just after it;
4. correctness: statevector norm, four amplitudes against complex128
   amplitude networks contracted natively on the card, and the whole
   20-qubit statevector against the complex128 numpy oracle;
5. the forced ``fused`` rung (``TNC_TPU_COMPLEX_MULT=fused``) of the same
   contraction, which must launch ``fused_complex_dot``;
6. where the time goes: the device-resident part of the main path timed
   alone, and one run under ``torch.profiler`` (device time by kernel,
   busy share);
7. one JSON line of per-kernel numbers, the card line, and the last line
   ``{"ok": true, "device": {...}}``.

It exits non-zero without a result when CUDA is unavailable or the
``tnc_tpu_torch`` package is not beside it.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

QUBITS = 28
DEPTH = 12
SEED = 42
SMALL_QUBITS = 20  # the configuration checked whole against the host oracle

# published H100 SXM peaks (dense, no sparsity) the bounds are taken from
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}  # CUDA-core FMA rates
# real flops per complex multiply-add in a bound: the Gauss identity needs
# three real products (6 flops), the least any lowering of the product
# needs; the hand kernels do four (8 flops), so their share of the bound
# is at most 6/8
COMPLEX_MAC_FLOPS = 6.0

F32_REL_TOL = 1e-5
F64_REL_TOL = 1e-12


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
    """``(device_ms, wall_ms)`` per call of ``fn()``.

    ``device_ms`` is the device time of every kernel, copy and memset the
    ``reps`` calls ran, from ``torch.profiler``, over ``reps``: the card's
    own time, without the host's cost of launching. ``wall_ms`` is CUDA
    events around a loop of ``reps`` back-to-back calls, over ``reps``:
    what a caller waits per call, host overhead included."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    wall = start.elapsed_time(end) / reps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    device_us = sum(
        ev.self_device_time_total for ev in prof.key_averages()
        if ev.device_type == DeviceType.CUDA
    )
    if device_us == 0:
        print("  torch.profiler recorded no device time; device ms falls back "
              "to the CUDA-event loop", flush=True)
        return wall, wall
    return device_us / 1e3 / reps, wall


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want) -> tuple[float, float]:
    """(max |got - want| over both parts, max |want| over both parts)."""
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    return err, scale


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


def check_chains(program, policy, gen) -> dict:
    """Every chain group of the program through ``fused_chain`` against
    ``fused_chain_reference`` on the card; returns the kernel's record."""
    import torch

    from tnc_tpu_torch.ops.cuda_complex import fused_chain, fused_chain_reference
    from tnc_tpu_torch.ops.split_complex import chain_operands

    rows = []
    worst = 0.0
    for s, e in policy.chains:
        steps = program.steps[s:e]
        buffers = random_buffers(program, chain_slot_sizes(steps), torch.float32, gen)
        first_ops, link_ops, links = chain_operands(steps, buffers)
        got = fused_chain(first_ops, link_ops, links)
        torch.cuda.synchronize()
        want = fused_chain_reference(first_ops, link_ops, links)
        err, scale = max_err(got, want)
        check(err <= F32_REL_TOL * scale,
              f"fused_chain {s}..{e}: max|err| {err} > {F32_REL_TOL} * {scale}")
        worst = max(worst, err)
        ms, wall = time_ms(lambda: fused_chain(first_ops, link_ops, links))
        plain, plain_wall = time_ms(lambda: fused_chain_reference(first_ops, link_ops, links))
        ops = list(first_ops) + [t for pair in link_ops for t in pair]
        nbytes = sum(t.numel() for t in ops) * 4 + 2 * got[0].numel() * 4
        shape = (first_ops[0].shape[1], first_ops[2].shape[1])
        flops = COMPLEX_MAC_FLOPS * first_ops[0].shape[0] * shape[0] * shape[1]
        for (cr, _), link in zip(link_ops, links):
            x = cr.shape[1]
            # a link contracts all K*F elements of the carried value with X
            flops += COMPLEX_MAC_FLOPS * shape[0] * shape[1] * x
            shape = link.out_shape(x)
        b_ms, b_by = bound_ms(nbytes, flops, "float32")
        rows.append((ms, plain, b_ms, b_by))
        print(f"  fused_chain steps {s}..{e - 1}: err {err:.3e} (scale {scale:.3e}) "
              f"device: kernel {ms:.5f} ms plain {plain:.5f} ms; wall per call: "
              f"kernel {wall:.5f} ms plain {plain_wall:.5f} ms; bound {b_ms:.3e} ms "
              f"({b_by})", flush=True)
    # one float64 case: the longest chain group
    s, e = max(policy.chains, key=lambda c: c[1] - c[0])
    steps = program.steps[s:e]
    buffers = random_buffers(program, chain_slot_sizes(steps), torch.float64, gen)
    ops64 = chain_operands(steps, buffers)
    err, scale = max_err(fused_chain(*ops64), fused_chain_reference(*ops64))
    check(err <= F64_REL_TOL * scale,
          f"fused_chain float64 {s}..{e}: max|err| {err} > {F64_REL_TOL} * {scale}")
    print(f"  fused_chain float64 steps {s}..{e - 1}: err {err:.3e} (scale {scale:.3e})",
          flush=True)
    print("  fused_chain: no single PyTorch call computes a chain of steps; "
          "library_ms is null", flush=True)
    n = len(rows)
    return {
        "max_abs_err": worst,
        "ms": sum(r[0] for r in rows) / n,
        "plain_ms": sum(r[1] for r in rows) / n,
        "bound_ms": sum(r[2] for r in rows) / n,
        "bound_by": "bytes" if sum(r[3] == "bytes" for r in rows) * 2 >= n else "operations",
        "library_ms": None,
    }


def check_dot(program, gen) -> dict:
    """Medium and stem steps of the program (the forced ``fused`` rung's
    shapes), a ragged shape and a float64 case through
    ``fused_complex_dot`` against its plain version; returns the kernel's
    record (times averaged over the program's shapes)."""
    import torch

    from tnc_tpu_torch.ops.cuda_complex import (
        eligible,
        fused_complex_dot,
        fused_complex_dot_reference,
    )
    from tnc_tpu_torch.ops.program import step_dims, step_flops
    from tnc_tpu_torch.ops.split_complex import step_bucket

    fusable = [
        st for st in program.steps
        if st.a_cfirst and st.b_cfirst and step_bucket(st) != "small"
        and eligible(step_dims(st)[1], step_dims(st)[0], step_dims(st)[2])
    ]
    fusable.sort(key=step_flops)
    # the stem step, the heaviest medium step, and a mid-sized medium one
    picks = [fusable[-1], fusable[-2], fusable[len(fusable) // 2]]
    shapes = [(step_dims(st)[1], step_dims(st)[0], step_dims(st)[2], "step")
              for st in picks]
    k, m, n, _ = shapes[-1]
    shapes.append((k + 3, m + 17, n + 29, "ragged"))

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)

    rows = []
    worst = 0.0
    for k, m, n, kind in shapes:
        ar, ai, br, bi = rnd(k, m), rnd(k, m), rnd(k, n), rnd(k, n)
        got = fused_complex_dot(ar, ai, br, bi)
        torch.cuda.synchronize()
        want = fused_complex_dot_reference(ar, ai, br, bi)
        err, scale = max_err(got, want)
        check(err <= F32_REL_TOL * scale,
              f"fused_complex_dot {(k, m, n)}: max|err| {err} > {F32_REL_TOL} * {scale}")
        worst = max(worst, err)
        if (k, m, n) == shapes[0][:3]:
            # the longest K: both float32 results against a float64 product
            exact = fused_complex_dot_reference(*(t.double() for t in (ar, ai, br, bi)))
            k_err = max_err([g.double() for g in got], exact)[0] / scale
            p_err = max_err([w.double() for w in want], exact)[0] / scale
            del exact
            print(f"  fused_complex_dot K={k} M={m} N={n} against float64: kernel "
                  f"{k_err:.3e}, plain (cuBLAS) {p_err:.3e} of max|C|", flush=True)
        del got, want
        reps = 10 if 8.0 * k * m * n > 1e12 else 20
        ms, wall = time_ms(lambda: fused_complex_dot(ar, ai, br, bi), reps, 1)
        plain, _ = time_ms(lambda: fused_complex_dot_reference(ar, ai, br, bi), reps, 1)
        a_c, b_c = torch.complex(ar, ai), torch.complex(br, bi)
        lib, _ = time_ms(lambda: a_c.mT @ b_c, reps, 1)
        del a_c, b_c
        nbytes = 4.0 * 2 * (k * m + k * n + m * n)
        b_ms, b_by = bound_ms(nbytes, COMPLEX_MAC_FLOPS * k * m * n, "float32")
        if kind == "step":
            rows.append((ms, plain, b_ms, b_by, lib))
        print(f"  fused_complex_dot {kind} K={k} M={m} N={n}: err {err:.3e} "
              f"(scale {scale:.3e}) device: kernel {ms:.4f} ms plain {plain:.4f} ms "
              f"complex64 matmul {lib:.4f} ms; kernel wall per call {wall:.4f} ms; "
              f"bound {b_ms:.4f} ms ({b_by}, {COMPLEX_MAC_FLOPS:g} flops per complex "
              f"multiply-add)", flush=True)
        del ar, ai, br, bi
        torch.cuda.empty_cache()
    # one float64 case at a mid-sized step's shape
    k, m, n, _ = shapes[2]
    ops = [rnd(k, m, dtype=torch.float64), rnd(k, m, dtype=torch.float64),
           rnd(k, n, dtype=torch.float64), rnd(k, n, dtype=torch.float64)]
    err, scale = max_err(fused_complex_dot(*ops), fused_complex_dot_reference(*ops))
    check(err <= F64_REL_TOL * scale,
          f"fused_complex_dot float64 {(k, m, n)}: max|err| {err} > {F64_REL_TOL} * {scale}")
    print(f"  fused_complex_dot float64 K={k} M={m} N={n}: err {err:.3e} "
          f"(scale {scale:.3e})", flush=True)
    n_rows = len(rows)
    return {
        "max_abs_err": worst,
        "ms": sum(r[0] for r in rows) / n_rows,
        "plain_ms": sum(r[1] for r in rows) / n_rows,
        "bound_ms": sum(r[2] for r in rows) / n_rows,
        "bound_by": "bytes" if sum(r[3] == "bytes" for r in rows) * 2 > n_rows else "operations",
        "library_ms": sum(r[4] for r in rows) / n_rows,
    }


def run_main_path(tn, path, backend, label: str, reps: int = 3):
    """One warm-up and ``reps`` timed ``contract_tensor_network`` runs.
    Launch and routing counts are reset just before each timed run and
    read just after it. Returns the last result, the wall seconds of
    every timed run and the counts of the last one."""
    import torch

    from tnc_tpu_torch.ops.cuda_complex import LAUNCHES, reset_launches
    from tnc_tpu_torch.ops.split_complex import FUSED_ROUTED, reset_routed
    from tnc_tpu_torch.tensornetwork.contraction import contract_tensor_network

    contract_tensor_network(tn, path, backend)
    walls = []
    out = None
    for _ in range(reps):
        del out
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        reset_routed()
        t0 = time.perf_counter()
        out = contract_tensor_network(tn, path, backend)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts = (dict(LAUNCHES), dict(FUSED_ROUTED))
        print(f"[{label}] wall {walls[-1]:.4f} s, max_memory_allocated "
              f"{torch.cuda.max_memory_allocated()} bytes, launches {counts[0]}, "
              f"routed {counts[1]}", flush=True)
    return out, walls, counts


def profile_device_path(tn, path, backend, reps: int = 3) -> dict:
    """Where the main path's time goes: the device-resident part
    (``execute_on_device``: placement and every step, no copy back) timed
    on its own, then one run under ``torch.profiler`` for device time by
    kernel and the device's busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tnc_tpu_torch.ops.program import build_program, flat_leaf_tensors

    program = build_program(tn, path)
    arrays = [leaf.data.into_data() for leaf in flat_leaf_tensors(tn)]
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = backend.execute_on_device(program, arrays)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del out
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = backend.execute_on_device(program, arrays)
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
    print(f"[profile] device-resident run: {[f'{t:.4f}' for t in times]} s; "
          f"profiled run {prof_wall:.4f} s, device busy {busy_s:.4f} s "
          f"({busy_s / prof_wall:.3f} of it)", flush=True)
    for dev, key, count in rows[:14]:
        print(f"  {dev / 1e3:10.3f} ms  x{count:<5d} {key[:90]}", flush=True)
    return {"device_s": statistics.median(times), "profiled_s": prof_wall,
            "device_busy_s": busy_s}


def main() -> int:
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
    cuda_complex.build_kernels()
    print(f"[build] both kernels in {time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in cuda_complex.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    backend = TorchBackend()  # turns TF32 off
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul left on")

    # 2. plan + kernels against their plain versions
    tn, permutor = build_config(QUBITS)
    path = plan(tn)
    program = build_program(tn, path)
    policy = plan_kernels(program)
    print(f"[plan] {QUBITS} qubits: {len(program.steps)} steps, "
          f"{len(policy.chains)} chains {list(policy.chains)}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    print("[kernels] fused_chain against fused_chain_reference", flush=True)
    chain_rec = check_chains(program, policy, gen)
    print("[kernels] fused_complex_dot against fused_complex_dot_reference", flush=True)
    dot_rec = check_dot(program, gen)
    torch.cuda.empty_cache()

    # 3. main path
    sv_leaf, walls, (launches, _) = run_main_path(tn, path, backend, "main path")
    check(launches["fused_chain"] == len(policy.chains),
          f"fused_chain launched {launches['fused_chain']} times for "
          f"{len(policy.chains)} chains")
    check(launches["fused_chain"] > 0, "main path launched no fused_chain")
    chain_rec["launches"] = launches["fused_chain"]

    # 4. correctness
    sv = np.asarray(sv_leaf.data.into_data())
    check(sv.shape == (2,) * QUBITS and np.all(np.isfinite(sv)),
          f"statevector has shape {sv.shape} or non-finite values")
    norm = float(np.vdot(sv.reshape(-1), sv.reshape(-1)).real)
    print(f"[check] statevector norm {norm:.8f}", flush=True)
    check(abs(norm - 1.0) <= 1e-4, f"norm {norm} not within 1e-4 of 1")
    qubit_of = {leg: q for q, leg in enumerate(permutor.target_leg_order)}
    oracle = TorchBackend(dtype="complex128", split_complex=False)
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
    small_tn, _ = build_config(SMALL_QUBITS)
    small_path = plan(small_tn)
    got = contract_tensor_network(small_tn, small_path, backend).data.into_data()
    want = contract_tensor_network(small_tn, small_path, NumpyBackend()).data.into_data()
    diff = float(np.max(np.abs(got - want)))
    print(f"[check] {SMALL_QUBITS}-qubit statevector vs complex128 numpy: "
          f"max|diff| {diff:.3e}", flush=True)
    check(diff <= 1e-5, f"{SMALL_QUBITS}-qubit statevector off by {diff}")
    del sv_leaf

    # 5. forced fused rung
    os.environ["TNC_TPU_COMPLEX_MULT"] = "fused"
    try:
        fused_leaf, fused_walls, (launches, _) = run_main_path(
            tn, path, backend, "fused rung", reps=1
        )
    finally:
        del os.environ["TNC_TPU_COMPLEX_MULT"]
    check(launches["fused_complex_dot"] > 0, "fused rung launched no fused_complex_dot")
    dot_rec["launches"] = launches["fused_complex_dot"]
    fused_sv = np.asarray(fused_leaf.data.into_data())
    scale = float(np.max(np.abs(sv)))
    fdiff = float(np.max(np.abs(fused_sv - sv)))
    print(f"[fused rung] max|diff| vs main path {fdiff:.3e} (scale {scale:.3e})",
          flush=True)
    check(np.allclose(fused_sv, sv, rtol=1e-4, atol=1e-4 * scale),
          "fused rung disagrees with the main path")
    del fused_leaf, fused_sv, sv

    # 6. where the main path's time goes
    prof = profile_device_path(tn, path, backend)

    kernels = [
        dict(name="fused_chain", route="cuda",
             source="tnc_tpu_torch/ops/csrc/fused_chain.cu",
             replaces="tnc_tpu/ops/pallas_complex.py:637", **chain_rec),
        dict(name="fused_complex_dot", route="cuda",
             source="tnc_tpu_torch/ops/csrc/fused_complex_dot.cu",
             replaces="tnc_tpu/ops/pallas_complex.py:113", **dot_rec),
    ]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({
        "main_path": {"qubits": QUBITS, "depth": DEPTH, "seed": SEED,
                      "steps": len(program.steps), "chains": len(policy.chains),
                      "wall_s": statistics.median(walls), "wall_runs_s": walls,
                      "fused_rung_wall_s": fused_walls[0], **prof},
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
