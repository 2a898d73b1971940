"""``chip_smoke.py`` phase 25 alone on the card.

    python3 scripts/whisper_mesh_alone.py

Builds the kernels, then runs phase 25 (``chip_smoke.whisper_mesh_phase``):
whisper-small at full width and depth under a mesh of 1 × 1 beside
unsharded (one forward of 8 × 448 tokens against 1,500 frames, 8 decode
steps over the cross cache; logits bit-equal, ms, idle share, launches),
then the dry run of granite-3-2b ``decode_32k`` in a subprocess.  Needs one
CUDA card.
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


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    print(f"nvidia-smi: {cs.smi()}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    build.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    counts = cs.whisper_mesh_phase(resolve_device(None))
    print(f"phase 25: {time.perf_counter() - t0:.2f} s wall; launches {counts}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
