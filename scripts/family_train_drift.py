"""Where a float32 smoke training run on the card parts from the same run on
the CPU, element by element: the run ``chip_smoke.py`` phase 22 (c) makes
side by side.

    python3 scripts/family_train_drift.py                 # olmoe-1b-7b
    python3 scripts/family_train_drift.py mixtral-8x7b mamba2-1.3b

Each architecture's smoke config (float32, lr 1e-3, 3 AdamW steps of 4 × 64
tokens from seed 0) runs on the card and on the CPU from the same
parameters.  After each step, for every leaf whose parameters part by more
than 2e-5 (and for the embedding always): the largest |difference|, where
it lies, that element's gradient, first and second moments on each side,
the leaf's relative gradient error and its largest |gradient|; for the
embedding also how often the element's token is in the step's batch.  An
element whose gradient lies within the float32 noise of zero can take
AdamW's first update, about lr times the gradient's sign, either way.
"""

from __future__ import annotations

import copy
import dataclasses
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import LMStream  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train.optim import AdamW  # noqa: E402
from repro_torch.train.trainer import init_train_state, make_train_step  # noqa: E402


def main(archs: list[str]) -> None:
    dev = resolve_device(None)
    build.library()
    grads = {}

    @dataclasses.dataclass(frozen=True)
    class GradSpy(AdamW):                   # keeps each side's gradients
        def update(self, g, state, params):
            side = next(iter(params.values())).device.type
            grads[side] = {n: t.detach().float().cpu() for n, t in g.items()}
            return super().update(g, state, params)

    for arch in archs:
        cfg = get_smoke_config(arch).replace(dtype=torch.float32)
        api, opt = build_model(cfg), GradSpy(learning_rate=1e-3)
        stream = LMStream(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4, seed=0)
        on_cpu = init_train_state(api, opt, 0, device="cpu")
        step = make_train_step(api, opt)
        states = {"cpu": copy.deepcopy(on_cpu), "cuda": cs.state_on(dev, on_cpu)}
        for i in range(3):
            batch = stream.batch(i)
            for side in ("cpu", "cuda"):
                states[side], _ = step(states[side], batch)
            for n, g_cpu in grads["cpu"].items():
                g_card = grads["cuda"][n]
                p_cpu = states["cpu"]["params"].get_parameter(n).detach()
                p_card = states["cuda"]["params"].get_parameter(n).detach().cpu()
                d = (p_cpu - p_card).abs()
                if float(d.max()) <= 2e-5 and n != "embed":
                    continue
                k = int(d.argmax())
                at = [int(j) for j in torch.unravel_index(torch.tensor(k), d.shape)]

                def moment(side, which):
                    return float(getattr(states[side]["opt"], which)[n].reshape(-1)[k])

                extra = ""
                if n == "embed":
                    tokens = torch.as_tensor(batch["tokens"])
                    extra = f"; token {at[0]} {int((tokens == at[0]).sum())}x in the batch"
                print(f"{arch} step {i + 1} {n}: max |dp| {float(d.max()):.3g} at {at}: g cpu "
                      f"{float(g_cpu.reshape(-1)[k]):.4g} card {float(g_card.reshape(-1)[k]):.4g}, "
                      f"m cpu {moment('cpu', 'm'):.4g} card {moment('cuda', 'm'):.4g}, v cpu "
                      f"{moment('cpu', 'v'):.4g} card {moment('cuda', 'v'):.4g}; leaf gradient "
                      f"relative error {cs.rel_err(g_card, g_cpu):.3g}, largest |g| "
                      f"{float(g_cpu.abs().max()):.3g}{extra}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["olmoe-1b-7b"])
