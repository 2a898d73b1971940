"""The port's side of ``test_torch_sharded_whisper.py``: one gloo rank of 8.

Imports torch and ``repro_torch`` only, so the 8 spawned ranks load no
JAX.  ``run(rank, world, store, inputs, params, out)`` reads the cases
from the pickle ``inputs`` (meshes, batches, decode tokens), waits for
``repro``'s runs to write their parameters (the pickles ``params``, one
numpy tree each, the same tree), and runs each case under its mesh: the
loss and every gradient, the teacher-forced logits, and three decode steps
over a cache from ``api.init_cache(..., rules=rules)`` whose cross slots
``fill_cross_cache`` fills from the encoding; rank 0 pickles every result
to ``out``.
"""

from __future__ import annotations

import pickle

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch.configs import get_smoke_config
from repro_torch.convert import whisper_params_from_numpy
from repro_torch.launch.sharding import make_rules
from repro_torch.models import build_model
from repro_torch.models import whisper as wh
from repro_torch.models.transformer import bind
from sharded_decode_ranks import _np, _SpySeqSharded, _wait_for

ARCH = "whisper-small"


def _case(case: dict, tree: dict, world: int) -> dict:
    cfg = get_smoke_config(ARCH).replace(dtype=torch.float32)
    api = build_model(cfg)
    mesh = DeviceMesh("cpu", torch.arange(world).reshape(case["mesh"]),
                      mesh_dim_names=("data", "model"))
    rules = make_rules(cfg, mesh)
    params = rules.place_params(whisper_params_from_numpy(tree, cfg, "cpu"))
    batch = case["batch"]

    copies = {n: p.detach().requires_grad_() for n, p in params.named_parameters()}
    loss = api.loss_fn(bind(params, copies), rules.place_batch(batch, "cpu"), rules)
    grads = torch.autograd.grad(loss, list(copies.values()))
    out = {"loss": float(_np(loss.detach())),
           "grads": {n: _np(g) for n, g in zip(copies, grads)},
           "logits": _np(api.forward(params, batch, rules))}

    b = batch["enc_frames"].shape[0]
    cache = api.init_cache(b, case["slots"], case["s_enc"], device="cpu", rules=rules)
    frames = rules.place_batch({"enc_frames": batch["enc_frames"]}, "cpu")["enc_frames"]
    with torch.no_grad():
        wh.fill_cross_cache(params, cache, wh.whisper_encode(params, frames, cfg, rules=rules),
                            cfg)
    out["layouts"] = {k: tuple(p.dim if p.is_shard() else None for p in t.placements)
                      for k, t in cache.items()}
    out["decode"] = []
    with _SpySeqSharded() as spy:
        for i, tokens in enumerate(case["tokens"]):
            logits, cache = api.decode_step(params, cache,
                                            {"tokens": tokens, "pos": case["pos0"] + i}, rules)
            out["decode"].append(_np(logits))
    out["merges"] = spy.calls
    out["logits_is_dtensor"] = isinstance(logits, DTensor)
    out["cache"] = {k: _np(t) for k, t in cache.items()}
    return out


def run(rank: int, world: int, store: str, inputs: str, params: list[str], out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        with open(inputs, "rb") as f:
            cases = pickle.load(f)
        tree = _wait_for(params)["params"]
        results = {name: _case(case, tree, world) for name, case in cases.items()}
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(results, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()

