"""Builds the port's CUDA kernels and loads them with ``ctypes``.

Every ``csrc/*.cu`` file (with the ``*.cuh`` headers it includes) is
compiled by its own ``nvcc`` process (all started together) for
``sm_90a`` into an object file; one more ``nvcc`` call links the objects
into a shared library with a plain C interface.  The build runs at first
use, into ``build/repro_torch/<hash>/`` at the root of the checkout, keyed
by a hash of the sources, headers and flags, so a fresh checkout builds
everything on its first kernel launch and a later process reuses the
library.  ``ptxas -v`` reports each kernel's registers, shared memory and
spills; the build keeps it beside the library (``ptxas_log``).  Nothing
outside the checkout is read or written, apart from the CUDA toolkit itself.
The bfloat16 flash-attention kernel looks up ``cuTensorMapEncodeTiled`` at
run time (``cudaGetDriverEntryPoint``), so the link needs no ``-lcuda``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "librepro_torch_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# C entry point -> (argtypes, restype)
SIGNATURES = {
    "sdp_subspace_scratch_floats": ([_I, _I], _LL),
    # Y, V, YV, G, ss, scratch, n, k, lanes, stream
    "sdp_subspace_f32": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _P], _I),
    "sdp_subspace_bf16": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _P], _I),
    # Y, A, B, out, n, k, lanes, stream
    "rank_k_update_f32": ([_P, _P, _P, _P, _I, _I, _I, _P], _I),
    "rank_k_update_bf16": ([_P, _P, _P, _P, _I, _I, _I, _P], _I),
    "bottleneck_eval_smem_bytes": ([_I, _I, _I], _LL),
    # assign, p, e, C, src, dst, out, B, S, T, K, E, stream
    "bottleneck_eval": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
    "gossip_mix_all_scratch_floats": ([_I, _I], _LL),
    "gossip_mix_all_f32": ([_P, _P, _P, _P, _I, _I, _LL, _P], _I),
    "gossip_mix_all_bf16": ([_P, _P, _P, _I, _I, _LL, _P], _I),
    "gossip_mix_block_scratch_floats": ([_I, _I], _LL),
    "gossip_mix_block_f32": ([_P, _P, _P, _P, _P, _P, _I, _I, _LL, _P], _I),
    "gossip_mix_block_bf16": ([_P, _P, _P, _P, _P, _I, _I, _LL, _P], _I),
    "gossip_mix_f32": ([_P, _P, _P, _I, _LL, _P], _I),
    "gossip_mix_bf16": ([_P, _P, _P, _I, _LL, _P], _I),
}
SIGNATURES.update({
    "rmsnorm": ([_P, _P, _P, _LL, _I, _F, _I, _I, _P], _I),
    "flash_attention": ([_P, _P, _P, _P, ctypes.POINTER(_LL), _I, _I, _I, _I, _I, _I, _I, _F, _I,
                         _P], _I),
    "decode_attention_splits": ([_I], _I),
    "decode_attention": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P], _I),
})
for _name in ("topk_mask", "int8_roundtrip"):
    for _tag in ("f32", "bf16"):
        # x, ldx, stat, msg, ldm, resid, ldr, N, column table (start, stop pairs), leaves, stream
        SIGNATURES[f"{_name}_{_tag}"] = ([_P, _LL, _P, _P, _LL, _P, _LL, _I, _P, _I, _P], _I)

_LIB: ctypes.CDLL | None = None
BUILD_SECONDS: float | None = None   # wall time of this process's build, if it built


class KernelInputError(ValueError):
    """A kernel wrapper refusing its inputs: a shape, dtype, device or
    layout it does not take, or a size past its kernel's limits.  A
    ``ValueError``, so argument checks catch it as before; a caller that
    retries failed solves (``repro_torch.launch.elastic``) lets it pass,
    since running the same inputs again cannot help."""


def tool(name: str = "nvcc") -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``)."""
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", name),
        shutil.which(name),
        f"/usr/local/cuda/bin/{name}",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"{name} not found: the CUDA kernels cannot be built or inspected")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):     # the sources and the headers they include
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS + CFLAGS).encode())
    return h.hexdigest()[:16]


def _build(out: Path) -> None:
    nvcc = tool()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        objs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            cmd = [nvcc, *ARCH_FLAGS, *CFLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        failed = []
        for src, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
            (out.parent / f"{src.stem}.ptxas.txt").write_text(log)
        if failed:
            raise RuntimeError("nvcc failed\n" + "\n".join(failed))
        lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed\n" + link.stdout)
        os.replace(lib, out)   # atomic: a concurrent build never sees half a file


def library_path() -> Path:
    return BUILD_ROOT / _digest() / LIB_NAME


def ptxas_log(stem: str) -> str:
    """What ``nvcc -Xptxas -v`` printed for ``csrc/<stem>.cu`` in the last build."""
    return (library_path().parent / f"{stem}.ptxas.txt").read_text()


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if this hash is new."""
    global _LIB, BUILD_SECONDS
    if _LIB is not None:
        return _LIB
    path = library_path()
    if not path.exists():
        t0 = time.perf_counter()
        _build(path)
        BUILD_SECONDS = time.perf_counter() - t0
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _LIB = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {err}")
