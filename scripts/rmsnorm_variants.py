"""Time variants of the RMSNorm kernel (PERF.md row 11) on the card, to see
what each lever of its design is worth.

    python3 scripts/rmsnorm_variants.py [name,name,...] [R:D,R:D,...]

A source variant is ``src/repro_torch/kernels/csrc/rmsnorm.cu`` with a few
lines replaced, compiled by its own ``nvcc`` (the flags of
``repro_torch.kernels.build``, all started together) into
``build/rmsnorm_variants/<name>/`` and called through its C entry point under
the wrapper's plan (``rmsnorm_plan``); a plan variant is the shipped kernel
under another plan.  All run in one process on one card, bfloat16 x and
scale, at ``kernel_ab.NORM_SHAPES`` (or the shapes given), timed in turns (a,
b, …, b, a; CUDA events around 100 calls on inputs cycled past the 50 MB L2);
every variant is held to the plain version under ``chip_smoke.rmsnorm_ok``.
The variants:

  base        the shipped kernel
  scalelate   1 + scale read at its use, after the reduction, also where a
              thread has one load
  scalefirst  1 + scale read beside x wherever its floats fit in 32
              registers (not only at one load a thread)
  plainstore  results stored with st.global (no evict-first hint)
  l2pf        loads with the .L2::256B prefetch hint
  loadsK      plan: aim at K loads a thread where rows are many and a row
              spans warps (K = 1, 3, 4, 6, 8; the shipped plan aims at 2)
  nospread    plan: few rows keep the many-row split (not spread over the
              most threads)

Names join with '+': ``plainstore+loads4`` is the source with that edit
under the plan aiming at four loads.

Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import importlib
import re
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

from chip_smoke import bound_ms, rmsnorm_ok, smi  # noqa: E402
from kernel_ab import NORM_SHAPES  # noqa: E402
from repro_torch.device import sm_count  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.rmsnorm import RMSNormPlan, rmsnorm_plain, rmsnorm_plan  # noqa: E402
from variant_build import build_variants, in_turns, patched  # noqa: E402

PLAN = importlib.import_module("repro_torch.kernels.rmsnorm")   # the module, for its LOADS
SOURCE = build.CSRC / "rmsnorm.cu"
OUT = REPO / "build" / "rmsnorm_variants"
SOURCE_VARIANTS = {
    "base": [],
    "scalelate": [("constexpr bool kScaleFirst = NV == 1;",
                   "constexpr bool kScaleFirst = false;")],
    "scalefirst": [("constexpr bool kScaleFirst = NV == 1;",
                    "constexpr bool kScaleFirst = NV * VEC <= 32;")],
    "plainstore": [("st.global.cs.v4.u32", "st.global.v4.u32")],
    "l2pf": [("const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));",
              "uint4 u;\n  asm(\"ld.global.nc.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\"\n"
              "               : \"=r\"(u.x), \"=r\"(u.y), \"=r\"(u.z), \"=r\"(u.w)\n"
              "               : \"l\"(__cvta_generic_to_global(p)));")],
}


def aim(loads: int):
    """The wrapper's plan with its module's LOADS set to ``loads`` for the call."""
    def plan_fn(R: int, D: int, sms: int) -> RMSNormPlan:
        saved, PLAN.LOADS = PLAN.LOADS, loads
        rmsnorm_plan.cache_clear()
        try:
            return rmsnorm_plan(R, D, 2, sms)
        finally:
            PLAN.LOADS = saved
            rmsnorm_plan.cache_clear()
    return plan_fn


PLAN_VARIANTS = {**{f"loads{k}": aim(k) for k in (1, 3, 4, 6, 8)},
                 "nospread": lambda R, D, sms: rmsnorm_plan(R, D, 2, 0)}


def parts(name: str) -> tuple[str, object]:
    """A variant is one or more names joined by '+': the source edits of its
    source variants (compiled together) and at most one plan variant.
    Returns (the source key, the plan function or None)."""
    src = [p for p in name.split("+") if p in SOURCE_VARIANTS and p != "base"]
    plans = [PLAN_VARIANTS[p] for p in name.split("+") if p in PLAN_VARIANTS]
    bad = [p for p in name.split("+") if p not in SOURCE_VARIANTS and p not in PLAN_VARIANTS]
    if bad or len(plans) > 1:
        raise SystemExit(f"variant {name}: unknown parts {bad} or more than one plan")
    return "+".join(src) or "base", (plans[0] if plans else None)


SPILLED: dict[str, set] = {}


def spilled_kernels(log: str) -> set:
    """(x itemsize, threads, loads) of every instantiation that spills."""
    out, cur = set(), None
    for line in log.splitlines():
        m = re.search(r"entry function '\S*rmsnorm_kernelI(\w+?)Li(\d+)ELi(\d+)E", line)
        if m:
            cur = (2 if "bfloat16" in m.group(1) else 4, int(m.group(2)), int(m.group(3)))
        elif cur and re.search(r"[1-9]\d* bytes spill", line):
            out.add(cur)
    return out


def compile_all(keys) -> dict:
    """Each source key's library (its source variants' edits together)."""
    texts = {k: patched(SOURCE, [e for n in k.split("+") for e in SOURCE_VARIANTS[n]], k)
             for k in keys}
    libs = build_variants(SOURCE, OUT, texts, ("rmsnorm",))
    for k, (_, log) in libs.items():
        SPILLED[k] = spilled_kernels(log)
        print(f"variant {k}: built, {len(SPILLED[k])} kernels with spills", flush=True)
    return {k: lib for k, (lib, _) in libs.items()}


def runner(lib, plan_fn, sms: int):
    plans = {}

    def run(x, s):
        R, D = x.shape
        if (R, D) not in plans:
            plans[R, D] = (plan_fn(R, D, sms) if plan_fn
                           else rmsnorm_plan(R, D, x.element_size(), sms))
        plan = plans[R, D]
        out = torch.empty_like(x)
        build.check(lib.rmsnorm(x.data_ptr(), s.data_ptr(), out.data_ptr(), R, D, 1e-6,
                                int(x.dtype == torch.bfloat16), int(s.dtype == torch.bfloat16),
                                *plan, torch.cuda.current_stream().cuda_stream), "variant")
        return out
    return run


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    names = (sys.argv[1].split(",") if len(sys.argv) > 1
             else list(SOURCE_VARIANTS) + list(PLAN_VARIANTS))
    shapes = (tuple(tuple(int(v) for v in a.split(":")) for a in sys.argv[2].split(","))
              if len(sys.argv) > 2 else NORM_SHAPES)
    dev = torch.device("cuda")
    sms = sm_count(dev.index)
    print(f"nvidia-smi: {smi()}", flush=True)
    keys = {n: parts(n) for n in names}
    libs = compile_all(sorted({k for k, _ in keys.values()}))
    runs = {n: runner(libs[k], plan_fn, sms) for n, (k, plan_fn) in keys.items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    for R, D in shapes:
        sets = [(torch.randn(R, D, generator=gen, device=dev).to(torch.bfloat16),
                 (torch.randn(D, generator=gen, device=dev) * 0.5).to(torch.bfloat16))
                for _ in range(max(2, -(-100_000_000 // (4 * R * D))))]
        want = rmsnorm_plain(*sets[0])
        for n, fn in runs.items():
            if not rmsnorm_ok(fn(*sets[0]), want):
                raise SystemExit(f"variant {n} ({R}, {D}): outside rmsnorm_ok")
        bound, by = bound_ms(2 * (2 * R * D + D), 4 * R * D)
        t = in_turns(runs, sets, 100)

        def tag(n):
            k, plan_fn = keys[n]
            plan = plan_fn(R, D, sms) if plan_fn else rmsnorm_plan(R, D, 2, sms)
            t = 0 if plan.threads > 32 else plan.threads
            spill = " SPILLS" if (2, t, plan.loads) in SPILLED[k] else ""
            return f"{n} {tuple(plan)}{spill}"
        print(f"variants rmsnorm ({R}, {D}) bf16 (bound {bound * 1e3:.2f} us, {by}): "
              + ", ".join(f"{tag(n)} {a:.2f} / {b:.2f}" for n, (a, b) in t.items()) + " us",
              flush=True)
        del sets, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
