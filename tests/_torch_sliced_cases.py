"""Sycamore sliced-amplitude configurations shared by the port's sliced
tests, built on both sides: the port's and the reference's network, path,
slicing and sliced program from the same seeds."""

import functools

import numpy as np

import tnc_tpu.contractionpath.slicing as ref_slicing
from tnc_tpu.builders.sycamore_circuit import sycamore_circuit as ref_sycamore
from tnc_tpu.contractionpath.paths import Greedy as RefGreedy
from tnc_tpu.contractionpath.paths import OptMethod as RefOptMethod
from tnc_tpu.ops.program import flat_leaf_tensors as ref_flat
from tnc_tpu.ops.sliced import build_sliced_program as ref_build_sliced
from tnc_tpu.tensornetwork.simplify import simplify_network as ref_simplify
from tnc_tpu_torch.builders.sycamore_circuit import sycamore_circuit
from tnc_tpu_torch.contractionpath import slicing
from tnc_tpu_torch.contractionpath.paths import Greedy, OptMethod
from tnc_tpu_torch.ops.program import flat_leaf_tensors
from tnc_tpu_torch.ops.sliced import build_sliced_program
from tnc_tpu_torch.tensornetwork.simplify import simplify_network

# (qubits, depth, rng seed, log2 of the slicing target)
SMALL = (20, 6, 7, 7)  # 4 slices
SIXTEEN = (20, 8, 7, 17)  # 16 slices
WIDE = (20, 8, 7, 14)  # 256 slices
CELL = (53, 10, 42, 29)  # 128 slices: the cell chip_smoke.py runs on the card


def _ids(cfgs):
    return [f"q{q}m{m}r{r}t{t}" for q, m, r, t in cfgs]


@functools.lru_cache(maxsize=None)
def _both(cfg, bitstring=None):
    """The port's and the reference's simplified network, path, slicing and
    sliced program for one configuration (``bitstring`` defaults to all
    zeros; ``*`` leaves a qubit open)."""
    q, m, seed, target = cfg
    bitstring = bitstring or "0" * q
    out = {}
    for side, build, simplify, greedy, opt, find, compile_ in (
        ("port", sycamore_circuit, simplify_network, Greedy, OptMethod,
         slicing.find_slicing, build_sliced_program),
        ("ref", ref_sycamore, ref_simplify, RefGreedy, RefOptMethod,
         ref_slicing.find_slicing, ref_build_sliced),
    ):
        tn, _ = build(q, m, np.random.default_rng(seed)).into_amplitude_network(bitstring)
        tn = simplify(tn)
        path = greedy(opt.GREEDY).find_path(tn).replace_path()
        sl = find(tn.tensors, path.toplevel, float(2 ** target))
        out[side] = {"tn": tn, "path": path, "slicing": sl,
                     "sp": compile_(tn, path, sl)}
    out["port"]["arrays"] = [l.data.into_data() for l in flat_leaf_tensors(out["port"]["tn"])]
    out["ref"]["arrays"] = [l.data.into_data() for l in ref_flat(out["ref"]["tn"])]
    return out


def _scalar(x) -> complex:
    return complex(np.asarray(x).reshape(()))
