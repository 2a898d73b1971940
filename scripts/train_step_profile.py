"""Where a dense-LM training step's time goes on the card.

    python3 scripts/train_step_profile.py [layers]

Builds ``chip_smoke.py`` phase 19 (a)'s step: qwen3-8b at full width with
the depth cut to ``layers`` (default 8), bfloat16 compute over float32
masters, remat, 2 × 4096 tokens of ``LMStream``, ``AdamW(
cosine_warmup_schedule(3e-4, 20, 3))``.  After two warm steps it profiles
one step and prints the device time by kind of kernel (the flash and
RMSNorm kernels, bfloat16 and float32 matrix products, elementwise and
reduction kernels) and the kernels that take the most of it.  Then it times the step's pieces alone
with CUDA events, each beside its bound (bytes once over 3.35 TB/s,
operations over the rate of their type): one layer's attention backward
(``flash_backward``, float32 products over 1024-row blocks), one
``AdamW.update`` over every parameter, and the head with the cross-entropy
(forward and backward).  Needs one CUDA card.
"""

from __future__ import annotations

import math
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import LMStream  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import LM, build_model  # noqa: E402
from repro_torch.models.attention import flash_backward  # noqa: E402
from repro_torch.models.common import softmax_cross_entropy  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.train.optim import AdamW, cosine_warmup_schedule  # noqa: E402
from repro_torch.train.trainer import init_train_state, make_train_step  # noqa: E402

HBM = 3.35e12
RATES = {"bf16": 989e12, "f32": 67e12}
B, S = 2, 4096


def kind(name: str) -> str:
    """A kernel's kind by its name: the port's kernels, cuBLAS's and CUTLASS's
    float32 SIMT products (sgemm, f32f32), its bfloat16 products (nvjet, the
    rest of its gemm kernels), PyTorch's elementwise and reduction kernels."""
    if "flash" in name:
        return "flash kernel"
    if "rmsnorm" in name:
        return "rmsnorm kernel"
    if "sgemm" in name or "f32f32" in name:
        return "float32 products"
    if "nvjet" in name or "gemm" in name.lower():
        return "bf16 products"
    if "elementwise" in name:
        return "elementwise"
    if "reduce" in name.lower():
        return "reductions"
    if "Memcpy" in name or "Memset" in name:
        return "copies"
    return "other"


def events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def main() -> int:
    layers = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    dev = resolve_device(None)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    cfg = get_config("qwen3-8b").replace(num_layers=layers)
    api = build_model(cfg)
    opt = AdamW(learning_rate=cosine_warmup_schedule(3e-4, 20, 3))
    state = init_train_state(api, opt, 0, device=dev)
    step = make_train_step(api, opt)
    batches = [LMStream(cfg.vocab_size, S, B).batch(i) for i in range(3)]
    for batch in batches[:2]:
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batches[2])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name, count = defaultdict(float), defaultdict(int)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e3
            count[e.name] += 1
    by_kind = defaultdict(float)
    for name, ms in by_name.items():
        by_kind[kind(name)] += ms
    total = sum(by_kind.values())
    print(f"profiled step: {wall * 1e3:.2f} ms wall, kernels {total:.2f} ms (summed), "
          f"{sum(count.values())} device events", flush=True)
    for k, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {k}: {ms:.2f} ms ({ms / total:.3f})", flush=True)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {ms:9.2f} ms  x{count[name]:<5d} {name[:110]}", flush=True)
    del state, step
    torch.cuda.empty_cache()

    g = torch.Generator(device=dev).manual_seed(0)
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim

    def randn(*shape, dt=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=dev).to(dt)

    q, k, v, dout = randn(B, S, H, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D), randn(B, S, H, D)
    out, lse = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                               return_lse=True)
    out = out.transpose(1, 2)
    ms = events_ms(lambda: flash_backward(q, k, v, out, lse, dout, causal=True, window=0,
                                          q_block=cfg.attn_chunk, kv_chunk=cfg.attn_chunk), 5)
    nb = S // cfg.attn_chunk
    pairs = nb * (nb + 1) // 2
    flops = pairs * 5 * 2 * B * H * cfg.attn_chunk ** 2 * D
    nbytes = 2 * (4 * B * S * H * D + 4 * B * S * Hkv * D) + 4 * B * H * S
    bound = max(flops / RATES["f32"], nbytes / HBM) * 1e3
    print(f"attention backward, one layer ({B}, {H}, {Hkv}, {S}, {D}) bf16 in, float32 products "
          f"over {pairs} block pairs: {ms:.2f} ms (x{layers} = {ms * layers:.1f} ms a step), "
          f"{flops / ms / 1e9:.1f} TFLOP/s, bound {bound:.2f} ms (float32 at 67 TFLOP/s)",
          flush=True)
    del q, k, v, dout, out, lse

    params = api.init_params(1, device=dev)
    named = dict(params.named_parameters())
    n = sum(p.numel() for p in named.values())
    grads = {k_: torch.randn(p.shape, generator=g, device=dev).to(cfg.dtype)
             for k_, p in named.items()}
    opt_state = [opt.init(named)]

    def update():
        opt_state[0] = opt.update(grads, opt_state[0], named)[1]

    ms = events_ms(update, 3)
    nbytes = n * (2 + 3 * 4 + 3 * 4)        # the gradient, then p, m, v read and written once
    print(f"AdamW.update over {n} parameters ({len(named)} leaves): {ms:.2f} ms, bound "
          f"{nbytes / HBM * 1e3:.2f} ms (bytes: {nbytes / n:.0f} a parameter)", flush=True)
    del grads, opt_state, params, named
    torch.cuda.empty_cache()

    x = randn(B, S, cfg.d_model).requires_grad_()
    w = (randn(cfg.d_model, cfg.padded_vocab) * 0.02).requires_grad_()
    labels = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=dev)

    def head():
        loss = softmax_cross_entropy(x @ w, labels)
        torch.autograd.grad(loss, (x, w))

    ms = events_ms(head, 3)
    flops = 3 * 2 * B * S * cfg.d_model * cfg.padded_vocab
    print(f"head and cross-entropy, forward and backward ({B * S} tokens x "
          f"{cfg.padded_vocab}): {ms:.2f} ms, products bound {flops / RATES['bf16'] * 1e3:.2f} "
          f"ms (bf16); logits {B * S * cfg.padded_vocab * 4 / 1e9:.2f} GB in float32", flush=True)
    blocks = layers * sum(p.numel() for name, p in LM(cfg, torch.device("meta"))
                          .named_parameters() if name.startswith("blocks.0.") and p.dim() == 2)
    head_params = cfg.d_model * cfg.padded_vocab
    # forward and backward (3x) of every product, and the blocks' forward again (remat)
    flops = 2 * B * S * (3 * (blocks + head_params) + blocks)
    print(f"matrix products a step without attention: {flops / 1e12:.1f} TFLOP "
          f"({flops / RATES['bf16'] * 1e3:.1f} ms at 989 TFLOP/s); ln V "
          f"{math.log(cfg.padded_vocab):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
