"""Row 10's partials mode and ``chip_smoke.py`` phase 24 alone on the card.

    python3 scripts/mesh_serve_alone.py

Builds the kernels, then runs phase 10's decode checks with the partials
mode (``chip_smoke.partials_check``: out and lse against the plain
version, both dtypes, valid_len 0, 1 and S), times the decode kernel at
phase 10's shape (B = 8, S = 32,768, bfloat16) in its default and partials
modes, in turns, twice, and runs phase 24 (``chip_smoke.mesh_serve_phase``:
serving under a mesh of 1 × 1 beside the unsharded step, and the recurrent
families' training there).  Needs one CUDA card.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention,
    decode_attention_plain,
)


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    print(f"nvidia-smi: {cs.smi()}", flush=True)
    t0 = time.perf_counter()
    build.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)
    dev = resolve_device(None)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dt=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=dev).to(dt)

    H, D, B, S = 32, 128, 8, 32768
    lens = torch.linspace(1, S, B, device=dev).round().to(torch.int32)
    short = torch.tensor([0, 1, 999, 1000, 513, 7, 512, 2000], dtype=torch.int32, device=dev)
    for dt, S_, lens_ in ((torch.bfloat16, S, lens), (torch.float32, S, lens),
                          (torch.float32, 1000, short), (torch.bfloat16, 1000, short)):
        q = randn(B, H, D, dt=dt)
        kc, vc = randn(B, S_, 8, D, dt=dt), randn(B, S_, 8, D, dt=dt)
        got, want = decode_attention(q, kc, vc, lens_), decode_attention_plain(q, kc, vc, lens_)
        print(f"decode_attention S={S_} {dt}: {cs.attn_share(got, want):.3f} of its bound",
              flush=True)
        cs.partials_check(q, kc, vc, lens_, got)
        del q, kc, vc, got, want
    torch.cuda.empty_cache()
    lens = (cs.LONG_POS0 - 4096 * torch.arange(B, device=dev) + 1).to(torch.int32)
    sets = cs.copies(lambda: (randn(B, H, D), randn(B, S, 8, D), randn(B, S, 8, D), lens),
                     2 * B * S * 8 * D * 2)
    for _ in range(2):
        default = cs.device_ms(decode_attention, sets, 50)
        partials = cs.device_ms(lambda *a: decode_attention(*a, return_lse=True), sets, 50)
        print(f"decode_attention B={B} S={S} bf16: default {default * 1e3:.2f} us, partials "
              f"{partials * 1e3:.2f} us", flush=True)
    del sets
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cs.mesh_serve_phase(dev)
    print(f"phase 24: {time.perf_counter() - t0:.2f} s wall", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
