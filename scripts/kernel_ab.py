"""Time this tree's ``gossip_mix_all``, ``gossip_mix_block``, ``sdp_subspace``
and ``rank_k_update`` kernels against another tree's (the parent commit's) on
one card, in turns.

    git archive <parent> src/repro_torch/kernels | tar -x -C build/parent
    python3 scripts/kernel_ab.py build/parent/src/repro_torch/kernels/csrc

The other tree's ``gossip_mix.cu`` and ``sdp_proj.cu`` are compiled by their
own ``nvcc`` (the flags of ``repro_torch.kernels.build``) into
``build/kernel_ab/`` and called through their C entry points, with the
signatures that the other tree's own ``build.py`` (beside its ``csrc``)
declares: ``gossip_mix_all_f32`` and ``gossip_mix_block_f32`` get a scratch
where that tree sizes one (``gossip_mix_all_scratch_floats``,
``gossip_mix_block_scratch_floats``); this tree's kernels go through the
wrappers.
Each case is timed parent, change, change, parent (CUDA events around
repeated calls, inputs cycled past the 50 MB L2 where the caller finds them
cold), beside ``torch.matmul`` for the exchange:

  - ``gossip_mix_all`` at N_T = 10, 128 and 1024 users of the CIFAR-10 CNN
    (L = 552,714), float32, the weights of a random sparse mixing matrix;
  - ``gossip_mix_block`` at the sharded path's shape (m = 128, H = 16) and a
    heavy halo (m = 125, H = 472), L = 552,714, random sparse blocks;
  - ``sdp_subspace`` at n = 1665, k = 16, cold (10 distinct Y) and warm (one
    Y, as the DR loop's 5 calls an iteration find it in L2);
  - ``rank_k_update`` at n = 1665, k = 16, cold (10 distinct Y).

Every result is also checked against the plain version (relative 1e-5).
Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.gossip_mix import (  # noqa: E402
    gossip_mix_all,
    gossip_mix_all_plain,
    gossip_mix_block,
    gossip_mix_block_plain,
)
from repro_torch.kernels.sdp_proj import (  # noqa: E402
    rank_k_update,
    rank_k_update_plain,
    sdp_subspace,
    sdp_subspace_plain,
)

OUT = REPO / "build" / "kernel_ab"
ENTRIES = ("gossip_mix_all_f32", "gossip_mix_all_scratch_floats", "gossip_mix_block_f32",
           "gossip_mix_block_scratch_floats", "sdp_subspace_f32", "sdp_subspace_scratch_floats",
           "rank_k_update_f32")


def parent_signatures(csrc: Path) -> dict:
    """``SIGNATURES`` of the other tree's ``build.py`` (it imports only the
    standard library and builds nothing when imported)."""
    spec = importlib.util.spec_from_file_location("parent_build", csrc.parent / "build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SIGNATURES


def compile_parent(csrc: Path) -> ctypes.CDLL:
    """The other tree's two sources -> one shared library (one nvcc per file),
    its entry points typed as that tree declares them."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = build.tool()
    procs = [subprocess.Popen([nvcc, *build.ARCH_FLAGS, *build.CFLAGS, "-c", str(csrc / f"{s}.cu"),
                               "-o", str(OUT / f"{s}.o")], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s in ("gossip_mix", "sdp_proj")]
    for p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed:\n{log}")
    lib = OUT / "libparent.so"
    subprocess.run([nvcc, *build.ARCH_FLAGS, "-shared", str(OUT / "gossip_mix.o"),
                    str(OUT / "sdp_proj.o"), "-o", str(lib)], check=True)
    dll = ctypes.CDLL(str(lib))
    for name, (args, res) in parent_signatures(csrc).items():
        if name in ENTRIES:
            getattr(dll, name).argtypes, getattr(dll, name).restype = args, res
    return dll


def device_us(fn, arg_sets, reps: int) -> float:
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def rel(a, b) -> float:
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    return float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)), 1e-30))


def turns(label: str, parent, change, sets, reps: int) -> None:
    t = [device_us(f, sets, reps) for f in (parent, change, change, parent)]
    print(f"ab {label}: parent {t[0]:.2f} / {t[3]:.2f} us, change {t[1]:.2f} / {t[2]:.2f} us "
          f"(parent, change, change, parent)", flush=True)


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    old = compile_parent(Path(sys.argv[1]))
    build.library()
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {out}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)

    def stream() -> int:
        return torch.cuda.current_stream().cuda_stream

    L = 552714
    for n in (10, 128, 1024):
        W = torch.rand(n, n, generator=gen, device=dev) * (
            torch.rand(n, n, generator=gen, device=dev) < 6.5 / n)
        W += torch.eye(n, device=dev)
        W /= W.sum(dim=1, keepdim=True)
        sets = [(torch.randn(n, L, generator=gen, device=dev), W)
                for _ in range(max(1, min(4, 200_000_000 // (n * L * 4))))]
        o = torch.empty(n, L, device=dev)
        if hasattr(old, "gossip_mix_all_scratch_floats"):
            scratch = torch.empty(old.gossip_mix_all_scratch_floats(n, n), device=dev)
            ptrs = (o.data_ptr(), scratch.data_ptr())
        else:                                     # before the tensor-core exchange: no scratch
            ptrs = (o.data_ptr(),)

        def parent(X, W_):
            err = old.gossip_mix_all_f32(X.data_ptr(), W_.data_ptr(), *ptrs, n, n, L, stream())
            if err:
                raise SystemExit(f"parent gossip_mix_all_f32: cudaError_t {err}")

        want = gossip_mix_all_plain(*sets[0])
        parent(*sets[0])
        e_old, e_new = rel(o, want), rel(gossip_mix_all(*sets[0]), want)
        print(f"ab gossip_mix_all N_T={n}: rel error parent {e_old:.3e}, change {e_new:.3e}",
              flush=True)
        if max(e_old, e_new) > 1e-5:
            raise SystemExit("FAILED: gossip_mix_all disagrees with its plain version")
        reps = 5 if n == 1024 else 50
        turns(f"gossip_mix_all N_T={n} L={L}", parent, lambda X, W_: gossip_mix_all(X, W_, out=o),
              sets, reps)
        print(f"ab gossip_mix_all N_T={n}: torch.matmul "
              f"{device_us(lambda X, W_: torch.matmul(W_, X), sets, reps):.2f} us", flush=True)
        del sets, o, want
        torch.cuda.empty_cache()

    def sparse(rows, cols, p):
        return torch.rand(rows, cols, generator=gen, device=dev) * (
            torch.rand(rows, cols, generator=gen, device=dev) < p)

    for m, h in ((128, 16), (125, 472)):
        wb, wh = sparse(m, m, 3.5 / m), sparse(m, h, 0.5)
        scale = (wb.sum(dim=1, keepdim=True) + wh.sum(dim=1, keepdim=True)).clamp_min(1e-30)
        wb, wh = wb / scale, wh / scale
        sets = [(torch.randn(m, L, generator=gen, device=dev), wb,
                 torch.randn(h, L, generator=gen, device=dev), wh)
                for _ in range(max(2, 200_000_000 // ((m + h) * L * 4)))]
        o = torch.empty(m, L, device=dev)
        if hasattr(old, "gossip_mix_block_scratch_floats"):
            scratch = torch.empty(old.gossip_mix_block_scratch_floats(m, h), device=dev)
            ptrs = (o.data_ptr(), scratch.data_ptr())
        else:                                     # before the tensor-core block: no scratch
            ptrs = (o.data_ptr(),)

        def parent_block(x, wb_, hx, wh_):
            err = old.gossip_mix_block_f32(x.data_ptr(), wb_.data_ptr(), hx.data_ptr(),
                                           wh_.data_ptr(), *ptrs, m, h, L, stream())
            if err:
                raise SystemExit(f"parent gossip_mix_block_f32: cudaError_t {err}")

        want = gossip_mix_block_plain(*sets[0])
        parent_block(*sets[0])
        e_old, e_new = rel(o, want), rel(gossip_mix_block(*sets[0]), want)
        print(f"ab gossip_mix_block m={m} H={h}: rel error parent {e_old:.3e}, change "
              f"{e_new:.3e}", flush=True)
        if max(e_old, e_new) > 1e-5:
            raise SystemExit("FAILED: gossip_mix_block disagrees with its plain version")
        turns(f"gossip_mix_block m={m} H={h} L={L}", parent_block,
              lambda x, wb_, hx, wh_: gossip_mix_block(x, wb_, hx, wh_, out=o), sets, 20)
        del sets, o, want
        torch.cuda.empty_cache()

    n, k = 1665, 16
    sets = []
    for _ in range(10):
        Y = torch.randn(n, n, generator=gen, device=dev)
        sets.append(((Y + Y.T).contiguous(),
                     torch.linalg.qr(torch.randn(n, k, generator=gen, device=dev)).Q.contiguous()))
    YV = torch.empty(n, k, device=dev)
    G = torch.empty(k, k, device=dev)
    ss = torch.empty((), device=dev)
    scratch = torch.empty(old.sdp_subspace_scratch_floats(n, k), device=dev)

    def parent_sdp(Y, V):
        old.sdp_subspace_f32(Y.data_ptr(), V.data_ptr(), YV.data_ptr(), G.data_ptr(),
                             ss.data_ptr(), scratch.data_ptr(), n, k, stream())

    parent_sdp(*sets[0])
    want = sdp_subspace_plain(*sets[0])
    e_old = max(rel(a, b) for a, b in zip((YV, G, ss), want))
    e_new = max(rel(a, b) for a, b in zip(sdp_subspace(*sets[0]), want))
    print(f"ab sdp_subspace n={n} k={k}: rel error parent {e_old:.3e}, change {e_new:.3e}",
          flush=True)
    if max(e_old, e_new) > 1e-5:
        raise SystemExit("FAILED: sdp_subspace disagrees with its plain version")
    turns(f"sdp_subspace n={n} k={k} cold", parent_sdp, sdp_subspace, sets, 200)
    turns(f"sdp_subspace n={n} k={k} warm", parent_sdp, sdp_subspace, sets[:1], 200)

    sets = [(Y, torch.randn(n, k, generator=gen, device=dev),
             torch.randn(n, k, generator=gen, device=dev)) for Y, _ in sets]
    o = torch.empty(n, n, device=dev)

    def parent_rank_k(Y, A, B):
        old.rank_k_update_f32(Y.data_ptr(), A.data_ptr(), B.data_ptr(), o.data_ptr(), n, k,
                              stream())

    parent_rank_k(*sets[0])
    want = rank_k_update_plain(*sets[0])
    e_old, e_new = rel(o, want), rel(rank_k_update(*sets[0]), want)
    print(f"ab rank_k_update n={n} k={k}: rel error parent {e_old:.3e}, change {e_new:.3e}",
          flush=True)
    if max(e_old, e_new) > 1e-5:
        raise SystemExit("FAILED: rank_k_update disagrees with its plain version")
    turns(f"rank_k_update n={n} k={k} cold", parent_rank_k, rank_k_update, sets, 200)
    return 0


if __name__ == "__main__":
    sys.exit(main())
