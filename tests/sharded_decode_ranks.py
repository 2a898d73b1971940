"""The port's side of ``test_torch_sharded_decode.py``: one gloo rank of 8.

Imports torch and ``repro_torch`` only, so the 8 spawned ranks load no
JAX.  ``run(rank, world, store, inputs, params, fed, out)`` reads the
cases from the pickle ``inputs`` (architectures, meshes, positions), waits
for ``repro``'s runs to write their parameters (the pickles ``params``, as
numpy trees by architecture) and sets each case up, then waits for the
tokens their greedy decodes fed (the pickles ``fed``) and decodes them;
rank 0 pickles every result to ``out``.
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy, lm_params_on_mesh
from repro_torch.launch.sharding import make_rules
from repro_torch.models import attention, build_model
from repro_torch.train.trainer import make_decode_step

CPU = torch.device("cpu")


def _np(t) -> np.ndarray:
    return (t.full_tensor() if isinstance(t, DTensor) else t).numpy().copy()


class _SpySeqSharded:
    """Counts the calls of ``attention.decode_attention_seq_sharded`` (the
    merge of row 10's partials) while in use."""

    def __enter__(self):
        self.calls, self._real = 0, attention.decode_attention_seq_sharded

        def spy(*args):
            self.calls += 1
            return self._real(*args)

        attention.decode_attention_seq_sharded = spy
        return self

    def __exit__(self, *exc):
        attention.decode_attention_seq_sharded = self._real
        return False


def _setup(case: dict, tree: dict, world: int) -> dict:
    cfg = get_smoke_config(case["arch"]).replace(dtype=torch.float32)
    api = build_model(cfg)
    mesh = DeviceMesh("cpu", torch.arange(world).reshape(case["mesh"]),
                      mesh_dim_names=("data", "model"))
    rules = make_rules(cfg, mesh)
    params = lm_params_on_mesh(tree, cfg, CPU, rules)
    whole = lm_params_from_numpy(tree, cfg, CPU)
    b, slots = len(case["pos0"]), case["slots"]
    cache = api.init_cache(b, slots, device="cpu", rules=rules)
    plain = api.init_cache(b, slots, device="cpu")
    return {"params": params, "whole": whole, "cache": cache, "plain": plain,
            "step": make_decode_step(api, rules), "step_plain": make_decode_step(api)}


def _case(case: dict, run: dict, fed: list) -> dict:
    cache, plain = run["cache"], run["plain"]
    out = {"logits": [], "unsharded": [],
           "layouts": {k: tuple(p.dim if p.is_shard() else None for p in t.placements)
                       for k, t in cache.items()}}
    with _SpySeqSharded() as spy:
        for i, tokens in enumerate(fed):
            batch = {"tokens": tokens, "pos": case["pos0"] + i}
            logits, cache = run["step"](run["params"], cache, batch)
            out["logits"].append(_np(logits))
            logits_plain, plain = run["step_plain"](run["whole"], plain, batch)
            out["unsharded"].append(logits_plain.numpy().copy())
    out["merges"] = spy.calls
    out["logits_is_dtensor"] = isinstance(logits, DTensor)
    out["cache"] = {k: _np(t) for k, t in cache.items()}
    out["cache_unsharded"] = {k: t.numpy().copy() for k, t in plain.items()}
    return out


def _wait_for(paths: list[str], seconds: float = 600.0) -> dict:
    """The pickles at ``paths``, merged, once their writers have renamed them
    into place."""
    end = time.monotonic() + seconds
    out = {}
    for path in paths:
        while not os.path.exists(path):
            if time.monotonic() > end:
                raise TimeoutError(f"no {path} after {seconds} s")
            time.sleep(0.1)
        with open(path, "rb") as f:
            got = pickle.load(f)
        if "error" in got:
            raise RuntimeError(f"the reference run failed:\n{got['error']}")
        out.update(got)
    return out


def run(rank: int, world: int, store: str, inputs: str, params: list[str], fed: list[str],
        out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        with open(inputs, "rb") as f:
            cases = pickle.load(f)
        trees = _wait_for(params)
        runs = {name: _setup(case, trees[case["arch"]], world) for name, case in cases.items()}
        fed_by = _wait_for(fed)
        results = {name: _case(case, runs[name], fed_by[name]["fed"])
                   for name, case in cases.items()}
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(results, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
