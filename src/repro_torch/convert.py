"""Carry state across from the JAX package as plain numpy arrays.

Nothing here imports ``repro``: the caller hands over arrays.

  - ``instance_from_arrays(p, edges, e, C)`` rebuilds an instance;
  - ``warm_start_from_arrays({"w": ..., "V": ...})`` turns a ``repro``
    ``SDPSolution.state`` into the port's ``solve_sdp(warm_start=...)``
    payload (the same layout: DR iterate w over (vec(Y), t, s) and, when
    present, the tracked eigenbasis V).

A solved ``Y`` passes as the plain array it already is
(``randomized_rounding(..., Y)``).

The gossip-FL slice keeps ``repro``'s parameter layouts (conv HWIO, fully
connected ``(in, out)``), so its conversions only lay trees out flat:

  - ``stacked_params_from_arrays(params, num_users)``: one user's CNN tree
    (a dict of numpy arrays, as ``repro.fl.cnn.init_cnn_params`` returns it)
    -> the trainer's ``(N_T, L)`` replica buffer, one copy per user;
  - ``params_from_stacked(stacked, like)``: an ``(N_T, L)`` buffer -> one
    tree of numpy arrays per user, shaped like ``like``;
  - ``epoch_perms_from_arrays(perms, num_users, chunk)``: a checked
    ``(N_T, epochs, chunk)`` int64 table of per-user data permutations for
    epochs 1, 2, … (``repro``'s ``GossipTrainer._host_epoch_perm``).

All three gossip engines (stacked, sharded, reference) take the same
``init_params`` tree and ``epoch_perms`` table, so none needs a converter
of its own.  ``repro``'s sharded engine pads the population to a multiple
of the shard count with inert users whose reshuffle keys continue the
``fold_in`` stream past N_T; the port's pads the same slots but takes only
the N_T real rows from the table (padding users walk their zero data in
order), so the table of the stacked engine serves every shard count.

The decoder LMs keep ``repro``'s parameter names and ``(in, out)`` layouts
(the block's ``attn.*``, ``mlp.*``, ``moe.*``, ``mixer.*`` and ``rec.*``
leaves flattened to the block module's attributes):

  - ``lm_params_from_numpy(params, cfg, device)``: ``repro``'s LM tree as
    numpy arrays (``embed``, ``final_norm``, ``lm_head``, ``groups``: one
    block dict per position of the block pattern, each stacked along a
    leading group axis, and ``remainder``: the unstacked block dicts of the
    layers past the last whole group) -> the port's ``LM`` in
    ``cfg.param_dtype`` on ``device``; layer l < G·P (P kinds a pattern, G
    groups) is ``groups[l % P]`` at index ``l // P``, layer G·P + r is
    ``remainder[r]``;
  - ``whisper_params_from_numpy(params, cfg, device)``: ``repro``'s Whisper
    tree (``embed``, ``enc_layers`` and ``dec_layers`` stacked along a
    leading layer axis, ``enc_norm``, ``dec_norm``, ``lm_head``) -> the
    port's ``Whisper``;
  - ``train_state_from_numpy(state, cfg, device)``: ``repro``'s train state
    ``{"params", "opt": AdamWState(step, m, v)}`` as numpy arrays (m and v
    are trees shaped like the parameters) -> the port's ``{"params": LM,
    "opt": AdamWState}``, the moments float32 and keyed by the ``LM``'s
    parameter names;
  - ``lm_params_on_mesh(params, cfg, device, rules)``: ``lm_params_from_numpy``
    with each parameter then a DTensor laid out by its spec under ``rules``
    (``launch.sharding.MeshRules.place_params``; every rank passes the same
    arrays and keeps its blocks).
"""

from __future__ import annotations

import numpy as np

import torch

from repro_torch.core.graphs import ComputeGraph, TaskGraph
from repro_torch.models.transformer import LM
from repro_torch.models.whisper import Whisper
from repro_torch.train.optim import AdamWState
from repro_torch.train.tree import ParamLayout


def instance_from_arrays(p, edges, e, C) -> tuple[TaskGraph, ComputeGraph]:
    """(TaskGraph, ComputeGraph) from work p, (i, j) edges, speeds e, delays C."""
    task_graph = TaskGraph(
        p=np.asarray(p, dtype=np.float64),
        edges=tuple((int(i), int(j)) for (i, j) in edges),
    )
    return task_graph, ComputeGraph(e=np.asarray(e), C=np.asarray(C))


def warm_start_from_arrays(state: dict) -> dict:
    """``{"w": (dim,), "V": (n+1, k) or absent}`` -> the port's warm start."""
    out = {"w": np.asarray(state["w"], dtype=np.float64)}
    if state.get("V") is not None:
        out["V"] = np.asarray(state["V"], dtype=np.float64)
    return out


def stacked_params_from_arrays(params: dict, num_users: int) -> np.ndarray:
    """One user's parameter tree -> (num_users, L) float32, one row per user."""
    row = ParamLayout(params).flatten(params)
    return np.ascontiguousarray(np.broadcast_to(row, (num_users, row.size)))


def params_from_stacked(stacked, like: dict) -> list[dict]:
    """(N_T, L) replicas (numpy or a tensor) -> N_T trees shaped like ``like``."""
    if hasattr(stacked, "detach"):
        stacked = stacked.detach().to("cpu", copy=True).numpy()
    layout = ParamLayout(like)
    stacked = np.asarray(stacked)
    if stacked.ndim != 2 or stacked.shape[1] != layout.size:
        raise ValueError(f"need (N_T, {layout.size}) replicas, got {stacked.shape}")
    return [layout.unflatten(row) for row in stacked]


def epoch_perms_from_arrays(perms, num_users: int, chunk: int) -> np.ndarray:
    """Check an (N_T, epochs, chunk) table of permutations of range(chunk)."""
    out = np.ascontiguousarray(np.asarray(perms, dtype=np.int64))
    if out.ndim != 3 or out.shape[0] != num_users or out.shape[2] != chunk:
        raise ValueError(f"need a ({num_users}, epochs, {chunk}) permutation table, "
                         f"got {out.shape}")
    if not np.array_equal(np.sort(out, axis=2), np.broadcast_to(np.arange(chunk), out.shape)):
        raise ValueError("every row of the table must be a permutation of range(chunk)")
    return out


_ATTN = ("wq", "wk", "wv", "wo", "q_norm", "k_norm")
_FFN = ("w_gate", "w_up", "w_down")


def _block_path(block: dict, name: str) -> tuple[str, ...]:
    """The path of a block leaf in ``repro``'s block dict, keyed by what the
    block holds: ``conv_w``, ``conv_b`` and ``out_proj`` are in ``rec``
    (RG-LRU) or ``mixer`` (Mamba-2), the FFN leaves in ``moe`` or ``mlp``."""
    if name in ("ln1", "ln2", "ln_x"):
        return (name,)
    if name.startswith("xattn."):
        return tuple(name.split("."))
    if name in _ATTN:
        return ("attn", name)
    if name == "router":
        return ("moe", name)
    if name in _FFN and ("moe" in block or "mlp" in block):
        return ("moe" if "moe" in block else "mlp", name)
    return ("rec" if "rec" in block else "mixer", name)


def _get(block: dict, path) -> np.ndarray:
    for key in path:
        block = block[key]
    return np.asarray(block)


def _stack_len(tree) -> int:
    """The leading axis of the first array in a stacked block dict."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return np.asarray(tree).shape[0]


def _lm_leaf(tree: dict, name: str) -> np.ndarray:
    """The array of ``repro``'s LM or Whisper tree behind a parameter name of
    the port's ``LM`` ("blocks.3.wq") or ``Whisper`` ("dec_blocks.1.xattn.wq")."""
    head, _, rest = name.partition(".")
    if head in ("enc_blocks", "dec_blocks"):
        layer, _, leaf = rest.partition(".")
        stack = tree["enc_layers" if head == "enc_blocks" else "dec_layers"]
        return _get(stack, _block_path(stack, leaf))[int(layer)]
    if head != "blocks":
        return np.asarray(tree[name])
    layer, _, leaf = rest.partition(".")
    layer = int(layer)
    groups, remainder = tree["groups"] or (), tree.get("remainder", ())
    n_grouped = _stack_len(groups[0]) * len(groups) if groups else 0
    if layer >= n_grouped:
        block = remainder[layer - n_grouped]
        return _get(block, _block_path(block, leaf))
    block = groups[layer % len(groups)]
    return _get(block, _block_path(block, leaf))[layer // len(groups)]


def _put(dst: torch.Tensor, arr: np.ndarray) -> None:
    if arr.shape != tuple(dst.shape):
        raise ValueError(f"shape {arr.shape} does not fit {tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))


@torch.no_grad()
def _from_numpy(model, params: dict):
    for name, dst in model.named_parameters():
        _put(dst, _lm_leaf(params, name))
    return model


def lm_params_from_numpy(params: dict, cfg, device) -> LM:
    """``repro``'s LM parameter tree (numpy arrays) -> an ``LM``."""
    return _from_numpy(LM(cfg, torch.device(device)), params)


def lm_params_on_mesh(params: dict, cfg, device, rules) -> LM:
    """``repro``'s LM parameter tree (numpy arrays) -> an ``LM`` of DTensors
    laid out under ``rules``."""
    return rules.place_params(lm_params_from_numpy(params, cfg, device))


def whisper_params_from_numpy(params: dict, cfg, device) -> Whisper:
    """``repro``'s Whisper parameter tree (numpy arrays) -> a ``Whisper``."""
    return _from_numpy(Whisper(cfg, torch.device(device)), params)


@torch.no_grad()
def train_state_from_numpy(state: dict, cfg, device) -> dict:
    """``repro``'s ``{"params", "opt": (step, m, v)}`` (numpy) -> the port's train state."""
    params = lm_params_from_numpy(state["params"], cfg, device)
    step, m, v = state["opt"]
    moments = []
    for tree in (m, v):
        out = {}
        for name, p in params.named_parameters():
            out[name] = torch.empty(p.shape, dtype=torch.float32, device=p.device)
            _put(out[name], _lm_leaf(tree, name))
        moments.append(out)
    step = torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=params.device)
    return {"params": params, "opt": AdamWState(step=step, m=moments[0], v=moments[1])}
