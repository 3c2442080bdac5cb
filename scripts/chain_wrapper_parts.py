#!/usr/bin/env python3
"""Break the host time of one ``fused_chain`` call down by part, on the card.

Usage (from the repository root, one CUDA device)::

    python3 scripts/chain_wrapper_parts.py [--repo DIR] [--label NAME] [--reps N]

``--repo`` imports ``tnc_tpu_torch`` (and ``chip_smoke.py``'s builders) from
another checkout, so an earlier wrapper can be measured in the same call as
this one. Two chains are captured from real runs of the port's main paths,
as ``split_complex.run_chain_split`` receives them: the first chain of the
20-qubit random-circuit statevector (unbatched, two tiny stages) and the
residual chain of ``sycamore_circuit(20, 8, rng 7)`` sliced to 2^17 on the
default chunked path (batch 8, a K = 2048 dot to a scalar). For each, every
part of the wrapper's per-call work is timed alone on the host
(``time.perf_counter`` over many calls, in microseconds a call), then the
whole call and the path's call (``run_chain_split``, operand prep
included); a wrapper that plans per call (a ``_chain_plan`` lookup keyed
by every operand's shape and strides) and one planned once (``chain_plan``
kept by the caller) have different parts. Ends with one JSON object of the
parts and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path


def host_us(fn, reps: int, rounds: int = 5) -> float:
    """Host microseconds a call of ``fn()``: the least, over ``rounds``
    rounds, of the mean over ``reps`` calls (after a warm-up; the card
    synchronised before each round, not inside it). A part that launches
    kernels is timed in rounds short enough that the launch queue does not
    fill, so the host is not held back by the card."""
    import torch

    for _ in range(3):
        fn()
    best = float("inf")
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, (time.perf_counter() - t0) / reps * 1e6)
    torch.cuda.synchronize()
    return best


def capture(run):
    """``(steps, buffers, batched)`` of the first chain ``run()`` executes."""
    from tnc_tpu_torch.ops import split_complex

    real = split_complex.run_chain_split
    got = []

    def wrapper(steps, buffers, *args, **kwargs):
        if not got:
            batched = args[0] if args else kwargs.get("batched")
            got.append((steps, list(buffers), set(batched or ())))
        return real(steps, buffers, *args, **kwargs)

    split_complex.run_chain_split = wrapper
    try:
        run()
    finally:
        split_complex.run_chain_split = real
    if not got:
        raise RuntimeError("the run executed no chain")
    return got[0]


def parts_per_call_plan(cc, sc, steps, buffers, batched, reps):
    """The parts of a wrapper that plans (and checks) on every call."""
    import torch

    first_ops, link_ops, links = sc.chain_operands(steps, buffers, batched)
    flat = list(first_ops) + [t for pair in link_ops for t in pair]
    plan = cc._chain_plan(first_ops, link_ops, links)
    dev = flat[0].device
    batch = 1 if plan.batch is None else plan.batch
    lib = cc._library("fused_chain")
    fn = lib.tnc_fused_chain_f32 if flat[0].dtype == torch.float32 else lib.tnc_fused_chain_f64
    stride = batch * max(plan.scratch_elems, 1)
    out_r = torch.empty(plan.out_shape, dtype=flat[0].dtype, device=dev)
    out_i = torch.empty(plan.out_shape, dtype=flat[0].dtype, device=dev)
    scratch = torch.empty((4 * stride,), dtype=flat[0].dtype, device=dev)
    ptrs = (ctypes.c_void_p * len(flat))(*[t.data_ptr() for t in flat])
    stream = cc._stream(dev)

    def checks():
        cc._check_parts("fused_chain", flat)
        for j in range(0, len(flat), 2):
            cc._check_pair("fused_chain", flat[j], flat[j + 1])

    def device_switch():
        with torch.cuda.device(dev):
            pass

    def launch():
        fn(ptrs, plan.table.ctypes.data, plan.n_stages, batch, scratch.data_ptr(), stride,
           out_r.data_ptr(), out_i.data_ptr(), stream)

    parts = {
        "operand prep (chain_operands)": lambda: sc.chain_operands(steps, buffers, batched),
        "checks (_check_parts, _check_pair)": checks,
        "plan key and lookup (_chain_plan)": lambda: cc._chain_plan(first_ops, link_ops, links),
        "library lookup": lambda: cc._library("fused_chain"),
        "three torch.empty": lambda: (
            torch.empty(plan.out_shape, dtype=flat[0].dtype, device=dev),
            torch.empty(plan.out_shape, dtype=flat[0].dtype, device=dev),
            torch.empty((4 * stride,), dtype=flat[0].dtype, device=dev)),
        "ctypes pointer array": lambda: (ctypes.c_void_p * len(flat))(
            *[t.data_ptr() for t in flat]),
        "torch.cuda.device switch": device_switch,
        "stream (current_stream().cuda_stream)": lambda: cc._stream(dev),
        "C call (launch)": launch,
    }
    out = {name: host_us(f, reps) for name, f in parts.items()}
    out["whole: fused_chain(first_ops, link_ops, links)"] = host_us(
        lambda: cc.fused_chain(first_ops, link_ops, links), reps)
    return out, plan.out_shape, batch


def parts_planned_once(cc, sc, steps, buffers, batched, reps):
    """The parts of a wrapper planned once per span and batch."""
    from array import array

    import torch

    first_ops, link_ops, links = sc.chain_operands(steps, buffers, batched)
    flat = list(first_ops) + [t for pair in link_ops for t in pair]
    run = sc._ChainRun(steps, buffers, batched)
    plan = cc.chain_plan(first_ops, link_ops, links)
    dev = flat[0].device
    lib = cc._library("fused_chain")
    fn = lib.tnc_fused_chain_f32 if flat[0].dtype == torch.float32 else lib.tnc_fused_chain_f64
    buf = torch.empty(plan.alloc_shape, dtype=plan.dtype, device=dev)
    bases = [t.data_ptr() for t in flat] + [buf.data_ptr()]
    lc = plan.launches[0]
    ptrs = array("Q", [bases[b] + off for b, off in lc.recipe])
    stream = cc._raw_stream(dev)

    def pointers_from_buffers():
        ptrs, keep = [], []
        for spec, read in zip(run.specs, run.reads):
            if read is None:
                op = sc._prep_spec(spec, buffers, batched)
                keep.append(op)
                ptrs.extend(t.data_ptr() for t in op)
            else:
                re, im = buffers[spec[0]]
                ptrs.append(re.data_ptr() + read[0])
                ptrs.append(im.data_ptr() + read[1])
        return ptrs

    parts = {
        "layout check (_ChainRun.matches)": lambda: run.matches(buffers, batched),
        "pointers from buffers": pointers_from_buffers,
        "pointers from operands (data_ptr)": lambda: [t.data_ptr() for t in flat],
        "device check (current_device)": lambda: torch.cuda.current_device(),
        "one torch.empty": lambda: torch.empty(plan.alloc_shape, dtype=plan.dtype, device=dev),
        "stream (raw handle)": lambda: cc._raw_stream(dev),
        "stream (current_stream().cuda_stream)": lambda: cc._stream(dev),
        "pointer array (array('Q'))": lambda: array(
            "Q", [bases[b] + off for b, off in lc.recipe]).buffer_info()[0],
        "C call (launch)": lambda: fn(ptrs.buffer_info()[0], len(lc.recipe), lc.table_addr,
                                      stream),
        "outputs (buf[0], buf[1])": lambda: (buf[0], buf[1]),
    }
    out = {name: host_us(f, reps) for name, f in parts.items()}
    out["whole: fused_chain(first_ops, link_ops, links, plan)"] = host_us(
        lambda: cc.fused_chain(first_ops, link_ops, links, plan), reps)
    out["form"] = ",".join(plan.forms)
    out["operands prepped per call"] = sum(read is None for read in run.reads)
    return out, plan.out_shape, plan.batch or 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--label", default="this")
    ap.add_argument("--reps", type=int, default=100)
    args = ap.parse_args()
    repo = Path(args.repo).resolve()
    sys.path.insert(0, str(repo))
    import torch

    if not torch.cuda.is_available():
        print("chain_wrapper_parts: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke
    from tnc_tpu_torch.ops import cuda_complex as cc
    from tnc_tpu_torch.ops import split_complex as sc
    from tnc_tpu_torch.ops.backends import TorchBackend
    from tnc_tpu_torch.tensornetwork.contraction import (
        contract_tensor_network,
        contract_tensor_network_sliced,
    )

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    backend = TorchBackend()
    cc.build_kernels(["fused_chain"])
    tn, _ = chip_smoke.build_config(20)
    path = chip_smoke.plan(tn)
    cfg = chip_smoke.CHUNKED_SMALL[1]
    stn, spath, sl = chip_smoke.build_sliced(cfg)
    cases = {
        "random20 statevector, first chain": capture(
            lambda: contract_tensor_network(tn, path, backend)),
        f"sycamore{cfg[0]}_m{cfg[1]}_t{cfg[3]} chunked residual chain": capture(
            lambda: contract_tensor_network_sliced(stn, spath, sl, backend)),
    }
    planned_once = hasattr(cc, "chain_plan")
    record = {"repo": str(repo), "label": args.label, "card": card,
              "wrapper": "planned once" if planned_once else "planned per call",
              "reps": args.reps, "cases": {}}
    for name, (steps, buffers, batched) in cases.items():
        measure = parts_planned_once if planned_once else parts_per_call_plan
        parts, out_shape, batch = measure(cc, sc, steps, buffers, batched, args.reps)
        runs: dict = {}

        def path_call():
            kwargs = {"runs": runs, "key": 0} if planned_once else {}
            sc.run_chain_split(steps, list(buffers), set(batched), **kwargs)

        parts["path: run_chain_split"] = host_us(path_call, args.reps)
        record["cases"][name] = {"out_shape": list(out_shape), "batch": batch,
                                 "us_per_call": parts}
        print(f"[{args.label}] {name} (batch {batch}, {record['wrapper']}):", flush=True)
        for part, us in parts.items():
            print(f"  {part}: {us if not isinstance(us, float) else f'{us:.3f} us'}",
                  flush=True)
    print(json.dumps(record), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONDONTWRITEBYTECODE", "1")
    sys.exit(main())
