"""Serving launcher: batched greedy decode against the KV-cache path.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b --smoke \
        --batch 8 --tokens 32

The counterpart of ``repro.launch.serve``, with the same flags and
``--device`` (default: the CUDA card; ``cpu`` runs the kernels' plain
versions).  Parameters are drawn from seed 0 in bfloat16 (there are no
weights to load), the cache holds ``--cache`` slots per sequence, and every
sequence starts from token 0 at position 0.  A VLM (qwen2-vl) is fed
``repro``'s frontend stub at every step, a (B, 1, d_model) tensor of ones
in ``cfg.dtype``, in place of its tokens.  Whisper decodes tokens against
the cross cache ``init_cache`` gives it (zeros, as ``repro``'s serve
does; ``models.whisper.fill_cross_cache`` writes an encoding's).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model


def greedy_decode(api, params, cache, tokens: torch.Tensor, pos: torch.Tensor, steps: int):
    """``steps`` greedy tokens for each sequence, from (B,) tokens at (B,)
    positions, the cache updated in place (a VLM reads the stub embeddings
    in place of the tokens).  Returns the (B, steps) tokens, the last
    step's logits and a device flag: every step's logits finite."""
    cfg = api.cfg
    stub = None
    if cfg.family == "vlm":
        stub = torch.ones((tokens.shape[0], 1, cfg.d_model), dtype=cfg.dtype,
                          device=tokens.device)
    out = []
    finite = torch.ones((), dtype=torch.bool, device=tokens.device)
    logits = None
    for i in range(steps):
        batch = {"pos": pos + i}
        if stub is None:
            batch["tokens"] = tokens
        else:
            batch["inputs_embeds"] = stub
        logits, cache = api.decode_step(params, cache, batch)
        finite &= torch.isfinite(logits).all()
        tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tokens)
    return torch.stack(out, dim=1), logits, finite


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--cache", type=int, default=256)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.replace(param_dtype=torch.bfloat16)
    dev = resolve_device(args.device)
    api = build_model(cfg)
    params = api.init_params(0, device=dev)
    cache = api.init_cache(args.batch, args.cache, device=dev)

    tokens = torch.zeros((args.batch,), dtype=torch.int32, device=dev)
    pos = torch.zeros((args.batch,), dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    generated, _, finite = greedy_decode(api, params, cache, tokens, pos, args.tokens)
    ok = bool(finite)                          # waits for the device
    dt = time.perf_counter() - t0
    if not ok:
        raise RuntimeError("non-finite logits")
    print(f"{args.arch}: {args.batch} seqs x {args.tokens} tokens in {dt:.2f}s "
          f"({args.batch * args.tokens / dt:.1f} tok/s) on {dev}")
    return generated


if __name__ == "__main__":
    main()
