"""What the kernel-variant scripts (``scripts/*_variants.py``) share: a kernel
source with a few lines replaced, every variant built by its own ``nvcc``
(all started together), and device times of several runs taken in turns.

A variant script names its source file under ``src/repro_torch/kernels/csrc``,
a table of edits (``(old, new)`` pairs) a variant, and the C entry points it
calls; ``build_variants`` writes each variant's source under
``build/<script>/<name>/``, compiles it with the flags of
``repro_torch.kernels.build`` (``-I csrc``, so the shared headers resolve),
and binds the entry points to ``build.SIGNATURES``.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import build


def patched(source: Path, edits, name: str) -> str:
    """``source``'s text with each ``(old, new)`` of ``edits`` replaced."""
    src = source.read_text()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"variant {name}: the text to replace is not in {source.name}: "
                             f"{old[:60]!r}")
        src = src.replace(old, new)
    return src


def build_variants(source: Path, out: Path, texts: dict[str, str],
                   entries) -> dict[str, tuple[ctypes.CDLL, str]]:
    """Compile each ``texts[name]`` (a variant of ``source``) into
    ``out/<name>/lib.so``, all ``nvcc`` processes at once.  Returns each
    variant's library, its ``entries`` bound, and what ``nvcc`` printed
    (``ptxas -v``)."""
    procs = {}
    for name, text in texts.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / source.name).write_text(text)
        procs[name] = subprocess.Popen(
            [build.tool(), *build.ARCH_FLAGS, *build.CFLAGS, "-I", str(build.CSRC), "-shared",
             str(d / source.name), "-o", str(d / "lib.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name}: nvcc failed\n{log[-4000:]}")
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        for entry in entries:
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = build.SIGNATURES[entry]
        libs[name] = (lib, log)
    return libs


def ptxas_line(log: str, kernel: str) -> str:
    """Registers and spills ``ptxas -v`` reports for the first entry function
    whose mangled name matches the regular expression ``kernel``."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if re.search(rf"entry function '\S*{kernel}", line):
            return " ".join(x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                            if "spill" in x or "Used" in x)
    return "not found"


def device_us(fn, sets: list, reps: int) -> float:
    """Device µs a call of ``fn(*args)``: CUDA events around ``reps`` calls on
    the argument tuples ``sets`` in turn (cycled past the L2 where the caller
    makes enough of them), the stream held by a sleep first so the host's
    launches queue ahead of the card."""
    for args in sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for i in range(reps):
        fn(*sets[i % len(sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def in_turns(runs: dict, sets: list, reps: int) -> dict[str, list[float]]:
    """``device_us`` of each run, timed a, b, …, b, a: two readings a run."""
    names = list(runs)
    times = {name: [] for name in names}
    for name in names + names[::-1]:
        times[name].append(device_us(runs[name], sets, reps))
    return times
