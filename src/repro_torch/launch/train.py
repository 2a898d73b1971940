"""Training launcher: AdamW steps of a decoder LM on the synthetic token stream.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b --smoke \
        --steps 50 --seq 128 --batch 4

The counterpart of ``repro.launch.train``, with the same flags and
``--device`` (default: the CUDA card; ``cpu`` runs the kernels' plain
versions).  Parameters are drawn from seed 0, the optimizer is
``AdamW(cosine_warmup_schedule(--lr, 20, --steps))`` and batch i is
``LMStream(vocab, --seq, --batch).batch(i)``.  With ``--ckpt-dir`` a
checkpoint is written every ``--ckpt-every`` steps and ``--resume`` starts
from the latest one.  A VLM or encoder-decoder config exits as ``repro``'s
launcher does (``SystemExit``): it needs a frontend stub batch.

``--mesh debug|pod|multipod`` trains under ``make_rules(cfg, mesh)`` on
``make_debug_mesh()`` (all ranks, model axis 2; one rank is a mesh of 1 ×
1) or the production mesh (256 or 512 ranks; fewer raise ``ValueError``):
the state and each batch are DTensors laid out by the specs, and the
launcher prints ``mesh: …``.  Without ``torchrun`` (``RANK`` /
``WORLD_SIZE``) it starts a world of one; ``--device cpu`` runs gloo, the
card nccl, each rank of ``torchrun --nproc-per-node N`` on card
``LOCAL_RANK``.  Every rank prints.  Every decoder family trains under a
mesh (Mamba-2 and the RG-LRU hybrid with their mixers whole on each rank's
batch rows).

    torchrun --nproc-per-node 8 -m repro_torch.launch.train --arch qwen3-8b \
        --smoke --mesh debug
"""

from __future__ import annotations

import argparse
import time

import torch.distributed as dist

from repro_torch.ckpt.checkpoint import CheckpointManager, config_hash
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data.synthetic import LMStream
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (init_world, make_debug_mesh, make_production_mesh,
                                     mesh_summary)
from repro_torch.launch.sharding import make_rules
from repro_torch.models import build_model
from repro_torch.train.optim import AdamW, cosine_warmup_schedule
from repro_torch.train.trainer import init_train_state, make_train_step


def main(argv=None) -> dict:
    """Run the launcher; returns the last step's metrics as floats."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", choices=["none", "debug", "pod", "multipod"],
                    default="none")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family in ("vlm", "encdec"):
        raise SystemExit(
            f"{args.arch} needs a frontend stub batch; use dryrun/smoke tests"
        )
    dev = resolve_device(args.device)
    if args.mesh == "none":
        return _train(args, cfg, dev, None)
    started = init_world(dev)
    try:
        mesh = (make_debug_mesh(device=dev) if args.mesh == "debug"
                else make_production_mesh(multi_pod=args.mesh == "multipod", device=dev))
        print(f"mesh: {mesh_summary(mesh)}")
        return _train(args, cfg, dev, make_rules(cfg, mesh))
    finally:
        if started:
            dist.destroy_process_group()


def _train(args, cfg, dev, rules) -> dict:
    api = build_model(cfg)
    opt = AdamW(learning_rate=cosine_warmup_schedule(args.lr, 20, args.steps))
    state = init_train_state(api, opt, 0, device=dev, rules=rules)
    n_params = sum(p.numel() for p in state["params"].parameters())
    print(f"{args.arch}{' (smoke)' if args.smoke else ''}: "
          f"{n_params/1e6:.1f}M params, {args.steps} steps on {dev}")

    start = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        if args.resume and mgr.latest_step() is not None:
            state, manifest = mgr.load(state)
            start = manifest["step"]
            print(f"resumed at step {start}")

    step_fn = make_train_step(api, opt, rules)
    stream = LMStream(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch
    )
    metrics = {}
    t0 = time.perf_counter()
    for i in range(start, args.steps):
        state, metrics = step_fn(state, stream.batch(i))
        if (i + 1) % 10 == 0 or i == start:
            print(f"step {i+1:4d}  loss {float(metrics['loss']):.4f}", flush=True)
        if mgr and (i + 1) % args.ckpt_every == 0:
            mgr.save(i + 1, state,
                     metadata={"data_step": i + 1,
                               "config": config_hash(cfg)})
    out = {k: float(v) for k, v in metrics.items()}
    print(f"done in {time.perf_counter()-t0:.0f}s; "
          f"final loss {out.get('loss', float('nan')):.4f}")
    return out


if __name__ == "__main__":
    main()
