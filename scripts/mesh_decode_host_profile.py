"""The host's cost of a decode step under a mesh of 1 × 1 against unsharded.

    python3 scripts/mesh_decode_host_profile.py [cuda|cpu] [layers]

qwen3-8b's smoke config in float32 with ``layers`` layers (default 4), 8
sequences, 256 cache slots: 20 steps of ``make_decode_step(api)`` and of
``make_decode_step(api, rules)`` over a world of one (gloo on the CPU,
nccl on the card) and ``make_debug_mesh()``, each after 3 warm-up steps,
then one more step of each under ``torch.profiler`` (CPU activity): ms a
step and the ops that take the most of the host's time (DTensor's
dispatch shows as ``PythonSubclass``, ``Redistribute`` and
``_FromTorchTensor``).  Default device: the CPU.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.mesh import init_world, make_debug_mesh  # noqa: E402
from repro_torch.launch.sharding import make_rules  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train.trainer import make_decode_step  # noqa: E402


def main() -> int:
    dev = torch.device(sys.argv[1] if len(sys.argv) > 1 else "cpu")
    layers = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    if dev.type == "cpu":
        torch.set_num_threads(1)
    cfg = get_smoke_config("qwen3-8b").replace(dtype=torch.float32, num_layers=layers)
    api = build_model(cfg)
    init_world(dev)
    rules = make_rules(cfg, make_debug_mesh(device=dev.type))
    B = 8
    for name, r in (("unsharded", None), ("mesh", rules)):
        params = api.init_params(0, device=dev)
        if r is not None:
            r.place_params(params)
        cache = api.init_cache(B, 256, device=dev, rules=r)
        step = make_decode_step(api, r)
        tokens = torch.zeros(B, dtype=torch.int32, device=dev)

        def at(i):
            return {"tokens": tokens, "pos": torch.full((B,), i, dtype=torch.int32, device=dev)}

        for i in range(3):
            step(params, cache, at(i))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(3, 23):
            step(params, cache, at(i))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 20 * 1e3
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(params, cache, at(23))
        print(f"{name}: {ms:.2f} ms a step ({layers} layers, {dev.type})", flush=True)
        for e in sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:12]:
            print(f"    {e.key[:60]:60s} calls {e.count:5d}  self {e.self_cpu_time_total / 1e3:.2f} "
                  f"ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
