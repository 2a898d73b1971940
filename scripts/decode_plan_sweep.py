"""Time the decode-attention kernel (PERF.md row 10) under other split plans.

    python3 scripts/decode_plan_sweep.py [chunk,chunk,...]

At the eight shapes of row 10 (``kernel_ab.DECODE_SHAPES``, bfloat16, B = 8)
it prints the kernel's build lines (``chip_smoke.decode_build_lines``), holds
the wrapper against the plain version (``chip_smoke.attn_share``) and a
second call bit-equal, then times the wrapper's own plan (``decode_plan``)
and the plans of the given split lengths (multiples of 64; default 64, 128,
256, 512, 1024, 2048, 4096 and 8192, those below S) through
``decode_attention.launch``, beside the bound and one SDPA call with a
boolean mask.  CUDA events around repeated calls whose inputs exceed the L2.
Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

from chip_smoke import attn_share, decode_build_lines, smi  # noqa: E402
from kernel_ab import DECODE_SHAPES, decode_bound, decode_lengths, decode_sets  # noqa: E402
from kernel_ab import device_us  # noqa: E402
from repro_torch.device import sm_count  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    UNIT,
    DecodePlan,
    decode_attention,
    decode_attention_plain,
    decode_plan,
    launch,
)


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    chunks = ([int(c) for c in sys.argv[1].split(",")] if len(sys.argv) > 1 else
              [64, 128, 256, 512, 1024, 2048, 4096, 8192])
    if any(c <= 0 or c % UNIT for c in chunks):
        raise SystemExit(f"split lengths must be positive multiples of {UNIT}: {chunks}")
    dev = torch.device("cuda")
    build.library()
    print(f"nvidia-smi: {smi()}", flush=True)
    decode_build_lines()
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = sm_count(dev.index)
    for label, B, H, Hkv, S, D, kind in DECODE_SHAPES:
        lens = decode_lengths(kind, B, S, dev)
        sets = decode_sets(gen, dev, B, H, Hkv, S, D, lens)
        got = decode_attention(*sets[0])
        share = attn_share(got, decode_attention_plain(*sets[0]))
        same = torch.equal(decode_attention(*sets[0]), got)
        if share > 1 or not same:
            raise SystemExit(f"decode {label}: attn_share {share:.3f}, second call equal {same}")
        reps = 20 if S >= 32768 else 200
        bound, by = decode_bound(B, H, Hkv, D, lens)
        mask = (torch.arange(S, device=dev)[None] < lens[:, None])[:, None, None]

        def sdpa(q, k, v, _lens):
            return torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
                enable_gqa=True)
        plan = decode_plan(B, H, Hkv, S, D, sms)
        out = torch.empty_like(got)
        times = {}
        for chunk in sorted({plan.chunk, *(c for c in chunks if c < S + UNIT)}):
            p = DecodePlan(chunk, -(-S // chunk), plan.head_groups)
            times[chunk] = device_us(lambda q, k, v, l: launch(q, k, v, l, out, p), sets, reps)
        print(f"sweep decode {label} (lengths {lens.tolist()}): attn_share {share:.3f}, "
              f"bit-equal on a second call; bound {bound * 1e3:.2f} us ({by}); plan "
              f"{tuple(plan)} {times[plan.chunk]:.2f} us; SDPA with a mask "
              f"{device_us(sdpa, sets, reps):.2f} us; by split length (us): "
              + ", ".join(f"{c}: {t:.2f}" for c, t in times.items()), flush=True)
        del sets, got, mask, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
