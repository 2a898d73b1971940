"""Where the mixture-of-experts FFN's non-product time goes on the card.

    python3 scripts/moe_dispatch_profile.py

At the prefill shapes of ``chip_smoke.py`` phase 20 (olmoe-1b-7b, S =
4096, 64 experts top-8; mixtral-8x7b, S = 8192, 8 experts top-2; and
olmoe's decode, B = 8, S = 1):

  - times ``repro_torch.models.moe.dispatch_slots`` (a scan of an (B, E,
    S·k) one-hot along its last axis) against ``repro``'s layout, the same
    scan along the choices of an (B, S·k, E) one-hot (``along_choices``
    below), in turns with CUDA events, and checks that both give the same
    slots and keep mask;
  - profiles one ``moe_ffn`` (random bfloat16 weights at full width) and
    prints its kernels by device time.

Needs one CUDA card.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import moe  # noqa: E402


def along_choices(gate_idx, num_experts: int, cap: int):
    """``repro``'s layout: the running count scanned along axis 1 of (B, S·k, E)."""
    b = gate_idx.shape[0]
    expert_of = gate_idx.reshape(b, -1)
    onehot = F.one_hot(expert_of, num_experts)
    pos = torch.amax(torch.cumsum(onehot, dim=1) * onehot, dim=-1) - 1
    keep = (pos >= 0) & (pos < cap)
    return expert_of * cap + torch.where(keep, pos, 0), keep


def events_ms(fn, reps: int = 20) -> float:
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
    dev = resolve_device(None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    for arch, s, b in (("olmoe-1b-7b", 4096, 1), ("mixtral-8x7b", 8192, 1), ("olmoe-1b-7b", 1, 8)):
        cfg = get_config(arch)
        e, k = cfg.num_experts, cfg.num_experts_per_tok
        g = torch.Generator(device=dev).manual_seed(0)
        probs = torch.softmax(torch.randn(b, s, e, generator=g, device=dev), dim=-1)
        idx = moe.route(probs.log(), torch.eye(e, device=dev), k)[2]
        cap = moe.capacity(cfg, s)
        (s1, k1), (s2, k2) = moe.dispatch_slots(idx, e, cap), along_choices(idx, e, cap)
        same = torch.equal(k1, k2) and torch.equal(s1[k1], s2[k2])
        times = {"dispatch_slots": [], "along_choices": []}
        for name in ("along_choices", "dispatch_slots", "dispatch_slots", "along_choices"):
            fn = moe.dispatch_slots if name == "dispatch_slots" else along_choices
            times[name].append(round(events_ms(lambda: fn(idx, e, cap)), 4))
        print(f"dispatch {arch} B={b} S={s} E={e} k={k} C={cap}: same slots and keep {same}; ms "
              f"(in turns) {times}", flush=True)
        if not same:
            return 1
    for arch, s in (("olmoe-1b-7b", 4096), ("mixtral-8x7b", 8192)):
        cfg = get_config(arch)
        d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
        g = torch.Generator(device=dev).manual_seed(1)
        p = SimpleNamespace(**{n: (torch.randn(*sh, generator=g, device=dev) * 0.02).to(
            torch.bfloat16) for n, sh in (("router", (d, e)), ("w_gate", (e, d, f)),
                                          ("w_up", (e, d, f)), ("w_down", (e, f, d)))})
        x = torch.randn(1, s, d, generator=g, device=dev).to(torch.bfloat16)
        moe.moe_ffn(p, x, cfg)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            moe.moe_ffn(p, x, cfg)
            torch.cuda.synchronize()
        by = {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                by[ev.name[:80]] = by.get(ev.name[:80], 0.0) + (
                    ev.time_range.end - ev.time_range.start) / 1e3
        top = sorted(by.items(), key=lambda kv: -kv[1])[:6]
        print(f"moe_ffn {arch} S={s}: {sum(by.values()):.3f} ms of kernels; largest "
              f"{[(n, round(v, 3)) for n, v in top]}", flush=True)
        del p, x
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
