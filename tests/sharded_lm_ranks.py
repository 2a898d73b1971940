"""The port's side of ``test_torch_sharded_lm.py``: one gloo rank of 8.

Imports torch and ``repro_torch`` only, so the 8 spawned ranks load no
JAX.  ``run(rank, world, store, inputs, out)`` reads the cases from the
pickle ``inputs`` (``repro``'s parameters as numpy trees, the batches) and
rank 0 pickles every result to ``out``.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy, lm_params_on_mesh
from repro_torch.launch.sharding import make_rules
from repro_torch.models import build_model, moe
from repro_torch.models.transformer import bind
from repro_torch.train.optim import AdamW, AdamWState
from repro_torch.train.trainer import compute_copies, init_train_state, make_train_step

CPU = torch.device("cpu")


def _np(t) -> np.ndarray:
    t = t.detach()
    return (t.full_tensor() if isinstance(t, DTensor) else t).numpy().copy()


class _SpyShardedMoE:
    """Counts the calls of ``moe.moe_ffn_sharded`` while in use."""

    def __enter__(self):
        self.calls, self._real = 0, moe.moe_ffn_sharded

        def spy(*args):
            self.calls += 1
            return self._real(*args)

        moe.moe_ffn_sharded = spy
        return self

    def __exit__(self, *exc):
        moe.moe_ffn_sharded = self._real
        return False


def _case(case: dict, world: int) -> dict:
    cfg = get_smoke_config(case["arch"]).replace(dtype=torch.float32)
    api = build_model(cfg)
    mesh = DeviceMesh("cpu", torch.arange(world).reshape(case["mesh"]),
                      mesh_dim_names=("data", "model"))
    rules = make_rules(cfg, mesh)
    params = lm_params_on_mesh(case["params"], cfg, CPU, rules)
    copies = compute_copies(params, cfg)
    with _SpyShardedMoE() as spy:
        loss = api.loss_fn(bind(params, copies), rules.place_batch(case["batches"][0], CPU),
                           rules)
    grads = torch.autograd.grad(loss, list(copies.values()))
    out = {"loss": float(_np(loss)), "grads": {n: _np(g) for n, g in zip(copies, grads)},
           "moe_sharded_calls": spy.calls,
           # the tensor dim each mesh dim splits (None: whole)
           "placements": {n: tuple(p.dim if p.is_shard() else None for p in t.placements)
                          for n, t in params.named_parameters()}}

    opt = AdamW(learning_rate=case["lr"])
    state = {"params": params, "opt": opt.init(dict(params.named_parameters()))}
    step = make_train_step(api, opt, rules)
    out["metrics"] = []
    for batch in case["batches"][1:]:
        state, m = step(state, batch)
        out["metrics"].append({k: float(v) for k, v in m.items()})
    out["stepped"] = {n: _np(p) for n, p in state["params"].named_parameters()}
    if "ckpt" in case:
        out["ckpt"] = _checkpoint(case, cfg, rules, opt, state)
    out["layouts_kept"] = all(
        isinstance(t, DTensor) and t.placements == p.placements
        for (n, p) in state["params"].named_parameters()
        for t in (state["opt"].m[n], state["opt"].v[n]))

    # a batch of equal rows: every data shard's auxiliary loss is the whole batch's
    same = {k: np.repeat(v[:1], v.shape[0], axis=0) for k, v in case["batches"][0].items()}
    fresh = lm_params_on_mesh(case["params"], cfg, CPU, rules)
    with torch.no_grad():
        out["same_rows"] = float(_np(api.loss_fn(fresh, rules.place_batch(same, CPU), rules)))
        whole = lm_params_from_numpy(case["params"], cfg, CPU)
        out["same_rows_unsharded"] = float(api.loss_fn(whole, same))
        out["unsharded"] = float(api.loss_fn(whole, case["batches"][0]))
        if "dense_dispatch" in case:
            batch = case["dense_dispatch"]
            with _SpyShardedMoE() as spy:
                sharded = api.loss_fn(fresh, rules.place_batch(batch, CPU), rules)
            out["dense_dispatch"] = {"loss": float(_np(sharded)), "moe_sharded_calls": spy.calls,
                                     "unsharded": float(api.loss_fn(whole, batch))}
    out["init"] = _init(api, opt, rules, params)
    return out


def _init(api, opt, rules, placed) -> dict:
    """``init_train_state`` under ``rules`` against the unsharded init and the
    layouts of ``placed`` (the same leaves placed by ``lm_params_on_mesh``)."""
    state = init_train_state(api, opt, 0, CPU, rules)
    whole = dict(api.init_params(0, device="cpu").named_parameters())
    got = dict(state["params"].named_parameters())
    layouts = {n: t.placements for n, t in placed.named_parameters()}
    return {"equal": all(torch.equal(t.full_tensor(), whole[n]) for n, t in got.items()),
            "layouts": all(isinstance(t, DTensor) and t.placements == layouts[n]
                           for n, t in got.items()),
            "moments": all(d[n].placements == t.placements and not torch.any(d[n].full_tensor())
                           for n, t in got.items() for d in (state["opt"].m, state["opt"].v))}


def _checkpoint(case: dict, cfg, rules, opt, state: dict) -> dict:
    """Save the sharded state; save an unsharded copy of it; load the first
    into a fresh sharded template."""
    sharded = CheckpointManager(f"{case['ckpt']}/mesh")
    sharded.save(2, state, metadata={"data_step": 2})
    whole = lm_params_from_numpy(case["params"], cfg, CPU)
    with torch.no_grad():
        for (_, a), (_, b) in zip(whole.named_parameters(), state["params"].named_parameters()):
            a.copy_(b.full_tensor())
    o = state["opt"]
    plain = {"params": whole, "opt": AdamWState(o.step, *({n: t.full_tensor() for n, t in d.items()}
                                                          for d in (o.m, o.v)))}
    CheckpointManager(f"{case['ckpt']}/plain").save(2, plain, metadata={"data_step": 2})
    fresh = lm_params_on_mesh(case["params"], cfg, CPU, rules)
    template = {"params": fresh, "opt": opt.init(dict(fresh.named_parameters()))}
    restored, manifest = sharded.load(template)
    pairs = [(a, b) for (_, a), (_, b) in zip(restored["params"].named_parameters(),
                                             state["params"].named_parameters())]
    pairs += [(restored["opt"].m[n], o.m[n]) for n in o.m]
    pairs += [(restored["opt"].v[n], o.v[n]) for n in o.v]
    return {"restored": all(a.placements == b.placements and torch.equal(a.full_tensor(),
                                                                          b.full_tensor())
                            for a, b in pairs),
            "step": int(restored["opt"].step), "data_step": manifest["data_step"]}


def run(rank: int, world: int, store: str, inputs: str, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        with open(inputs, "rb") as f:
            cases = pickle.load(f)
        results = {name: _case(case, world) for name, case in cases.items()}
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(results, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
