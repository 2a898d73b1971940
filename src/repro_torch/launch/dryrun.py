"""Dry run: one sharded step of every (arch × shape × mesh) cell, counted on
a fake world (counterpart of ``repro.launch.dryrun``).

``repro`` lowers and compiles each cell on forced host devices and reads
its FLOPs, bytes and collectives off the compiled HLO.  The port traces
instead: ``init_fake_world`` starts a world of 256 (512 with
``--multipod``) ranks in this one process over torch's fake backend, the
production mesh is a ``DeviceMesh`` over it, and the cell's step runs once
under ``FakeTensorMode`` with its state, cache and batch as fake DTensors
laid out by ``param_specs`` / ``cache_specs`` / ``batch_specs`` (nothing
drawn, nothing allocated: the counterpart of ``jax.eval_shape``), while
``step_stats.analyze_step`` counts what rank 0 dispatches.  No GPU is
touched; the kernels' wrappers take their plain versions on the fake CPU
tensors, and DTensor's shard-to-shard re-layouts are counted as the
all-to-alls the card runs (on a CPU mesh DTensor would take an all-gather
and a chunk).  A serving cell's parameters are bfloat16, as ``repro``'s are.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]

Each cell writes ``repro``'s record to
``<out>/<arch>__<shape>__<pod|multipod>[__tag].json`` (default ``--out``
``artifacts/dryrun``): ``arch``, ``shape``, ``mesh``, ``devices``,
``status``, ``la_flops_per_device``, ``la_bytes_per_device``,
``la_link_bytes_per_device``, ``collectives`` {``counts``,
``payload_bytes``, ``link_bytes``}, ``model_flops_total``,
``params_total``, ``params_active``, ``model_flops_per_device``,
``useful_flops_ratio`` and ``roofline_terms``' keys (on the H100's rates),
plus ``trace_s`` and ``argument_size_in_bytes`` (rank 0's local shards of
the state, cache and batch).  A failure is recorded as data (``status``
"fail", ``error``, ``traceback``).  ``repro``'s keys that need a compiler
are left out: ``hlo_*`` (XLA's own cost analysis), ``lower_s`` /
``compile_s``, ``temp_size_in_bytes`` and the other memory-analysis sizes,
and ``hbm_peak_bytes_per_device``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import inspect
import json
import os
import sys
import time
import traceback
from unittest import mock

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import _disable_current_modes
from torch.distributed.tensor import DTensor

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.collectives import roofline_terms, tensor_bytes
from repro_torch.launch.mesh import init_fake_world, make_production_mesh, mesh_summary
from repro_torch.launch.sharding import make_rules
from repro_torch.launch.step_stats import analyze_step
from repro_torch.models import build_model
from repro_torch.models.flops import model_flops
from repro_torch.models.transformer import LM
from repro_torch.models.whisper import Whisper
from repro_torch.shapes import SHAPES, shape_applicable
from repro_torch.train.optim import AdamW
from repro_torch.train.trainer import make_decode_step, make_prefill_step, make_train_step

CPU = torch.device("cpu")


def _fake(t: torch.Tensor) -> torch.Tensor:
    """A fake CPU tensor of ``t``'s shape and dtype (under ``FakeTensorMode``)."""
    return torch.empty(t.shape, dtype=t.dtype, device=CPU)


def _skeleton(cfg, rules):
    """The cell's model with every parameter a fake DTensor laid out by its spec."""
    params = (Whisper if cfg.family == "encdec" else LM)(cfg, "meta")
    params.rope_freqs = _fake(params.rope_freqs)
    for name, p in list(params.named_parameters()):
        rules.place_param(params, name, _fake(p))
    return params


def _card_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's shard-to-shard re-layout as it runs on a card: one
    ``_dtensor.shard_dim_alltoall`` (on a CPU mesh DTensor takes an
    all-gather and a chunk instead, as gloo has no all-to-all)."""
    group = mesh.get_group(mesh_dim)
    return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim, group.group_name)


def _host_arithmetic(cls, name: str):
    """``cls.name`` run with no dispatch mode on (no fake tensors, nothing
    counted), each distinct call once: DTensor's host-side planning.
    ``_StridedShard``'s local sizes and offsets build index tensors of a
    dim's length and read them back, which fake tensors cannot do; a
    redistribute plan searches a graph of placements (tens of ms on a 3-D
    mesh) for every candidate strategy of every op."""
    raw = inspect.getattr_static(cls, name)
    fn = raw.__func__ if isinstance(raw, (staticmethod, classmethod)) else raw
    memo = {}

    @functools.wraps(fn)
    def real(*args, **kwargs):
        key = (args, tuple(sorted(kwargs.items())))
        if key not in memo:
            with _disable_current_modes():
                memo[key] = fn(*args, **kwargs)
        return memo[key]

    return mock.patch.object(cls, name, type(raw)(real) if fn is not raw else real)


def _not_tracing() -> bool:
    return False


@contextlib.contextmanager
def _fake_world_patches():
    """While on, DTensor runs the fake step as it runs an eager one (each
    patch where this torch has its hook):

      - it reads an active fake mode as a ``torch.compile`` trace
        (``_are_we_tracing``) and then bypasses its caches of sharding
        strategies, redistribute plans and output shapes, which makes each
        op cost seconds on a 3-D mesh: it is told that it is not tracing;
      - it re-lays shard to shard as on the card (``_card_alltoall``);
      - its placement arithmetic and redistribute plans run on host tensors,
        once each (``_host_arithmetic``)."""
    from torch.distributed.tensor import placement_types as pt

    with contextlib.ExitStack() as stack:
        for name, mod in list(sys.modules.items()):
            if name.startswith("torch.distributed.tensor") and callable(
                    getattr(mod, "_are_we_tracing", None)):
                stack.enter_context(mock.patch.object(mod, "_are_we_tracing", _not_tracing))
        from torch.distributed.tensor import _redistribute as rd
        if hasattr(rd, "_gen_transform_infos_non_cached"):
            stack.enter_context(_host_arithmetic(rd, "_gen_transform_infos_non_cached"))
        if hasattr(pt, "shard_dim_alltoall"):
            stack.enter_context(mock.patch.object(pt, "shard_dim_alltoall", _card_alltoall))
        strided = getattr(pt, "_StridedShard", None)
        if strided is not None and hasattr(strided, "local_shard_size_and_offset"):
            stack.enter_context(_host_arithmetic(strided, "local_shard_size_and_offset"))
        yield


def _local_bytes(tree) -> int:
    """The bytes of this rank's shards of the DTensors in ``tree``."""
    flat = tree.values() if isinstance(tree, dict) else tree
    return sum(tensor_bytes(t.to_local() if isinstance(t, DTensor) else t) for t in flat)


def trace_cell(arch: str, shape_name, mesh, *, sharding_overrides=None,
               cfg_overrides=None) -> tuple:
    """Build one cell's state on fake tensors and count one step (counterpart
    of ``lower_cell``; ``shape_name`` is a ``SHAPES`` name or a
    ``ShapeSpec``).  Returns (``StepStats``, meta: ``cfg``, ``spec``,
    ``argument_size_in_bytes``)."""
    cfg = get_config(arch)
    spec = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if spec.kind in ("prefill", "decode"):
        # serving checkpoints are bf16 (no fp32 master / optimizer state)
        cfg = cfg.replace(param_dtype=torch.bfloat16)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    api = build_model(cfg)
    rules = make_rules(cfg, mesh, **(sharding_overrides or {}))
    with FakeTensorMode(), _fake_world_patches():
        params = _skeleton(cfg, rules)
        batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=CPU)
                 for k, v in api.input_specs(spec).items()}
        args = _local_bytes(dict(params.named_parameters()))
        args += _local_bytes(rules.place_batch(batch, CPU))
        if spec.kind == "train":
            opt = AdamW(learning_rate=1e-4)
            state = {"params": params, "opt": opt.init(dict(params.named_parameters()))}
            args += _local_bytes(state["opt"].m) + _local_bytes(state["opt"].v)
            stats = analyze_step(make_train_step(api, opt, rules), state, batch)
        elif spec.kind == "prefill":
            stats = analyze_step(make_prefill_step(api, rules), params, batch)
        else:
            cache = rules.place_cache({k: _fake(v) for k, v in api.cache_specs(spec).items()})
            args += _local_bytes(cache)
            stats = analyze_step(make_decode_step(api, rules), params, cache, batch)
    return stats, {"cfg": cfg, "spec": spec, "argument_size_in_bytes": args}


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str, *,
             sharding_overrides=None, tag: str = "") -> dict:
    """One cell on the production mesh (a fake world of its size is started
    if none runs) -> ``repro``'s record, also written under ``out_dir``."""
    n = 512 if multi_pod else 256
    if not torch.distributed.is_initialized():
        init_fake_world(n)
    mesh = make_production_mesh(multi_pod=multi_pod, device=CPU)
    n_dev = mesh.size()
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_summary(mesh), "devices": int(n_dev),
           "status": "ok"}
    t0 = time.perf_counter()
    try:
        stats, meta = trace_cell(arch, shape_name, mesh, sharding_overrides=sharding_overrides)
        rec["trace_s"] = round(time.perf_counter() - t0, 2)
        rec["argument_size_in_bytes"] = int(meta["argument_size_in_bytes"])
        rec["la_flops_per_device"] = stats.flops
        rec["la_bytes_per_device"] = stats.bytes
        rec["la_link_bytes_per_device"] = stats.link_bytes
        rec["collectives"] = {"counts": stats.coll_counts, "payload_bytes": stats.coll_payload,
                              "link_bytes": stats.link_bytes}
        mf = model_flops(meta["cfg"], meta["spec"])
        rec["model_flops_total"] = mf["model_flops"]
        rec["params_total"] = mf["total"]
        rec["params_active"] = mf["active"]
        rec["model_flops_per_device"] = mf["model_flops"] / n_dev
        rec["useful_flops_ratio"] = (rec["model_flops_per_device"] / stats.flops
                                     if stats.flops else 0.0)
        rec.update(roofline_terms(stats.flops, stats.bytes, stats.link_bytes))
    except Exception as e:  # noqa: BLE001 (failures are recorded as data)
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        path = os.path.join(out_dir, f"{arch}__{shape_name}__"
                                     f"{'multipod' if multi_pod else 'pod'}{suffix}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true", help="2x16x16 mesh")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else (args.arch,)
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) else [args.multipod]
    cells = [(a, s, mp) for a in archs for s in shapes if shape_applicable(a, s) for mp in meshes]
    init_fake_world(512 if any(mp for _, _, mp in cells) else 256)

    n_fail = 0
    for a, s, mp in cells:
        rec = run_cell(a, s, mp, args.out)
        if rec["status"] == "ok":
            print(f"OK   {a:20s} {s:12s} {rec['mesh']:28s} trace {rec['trace_s']:6.1f}s "
                  f"flops/dev {rec['la_flops_per_device']:.3e} "
                  f"coll {rec['collectives']['link_bytes']:.3e}B dominant={rec['dominant']}",
                  flush=True)
        else:
            n_fail += 1
            print(f"FAIL {a:20s} {s:12s} multipod={mp}: {rec['error']}", flush=True)
    print(f"\n{len(cells) - n_fail}/{len(cells)} cells OK")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
