"""Time this tree's ``gossip_mix_all``, ``gossip_mix_block``, ``sdp_subspace``,
``rank_k_update``, ``bottleneck_eval``, ``topk_mask``, ``int8_roundtrip``,
``flash_attention``, ``decode_attention`` and ``rmsnorm`` kernels against
another tree's (the parent commit's) on one card, in turns.

    git archive <parent> src/repro_torch/kernels | tar -x -C build/parent
    python3 scripts/kernel_ab.py build/parent/src/repro_torch/kernels/csrc [groups]

The other tree's ``gossip_mix.cu``, ``sdp_proj.cu``, ``bottleneck.cu``,
``compress.cu``, ``flash_attention.cu``, ``decode_attention.cu`` and ``rmsnorm.cu`` are
compiled by their own ``nvcc`` (the flags of ``repro_torch.kernels.build``) into
``build/kernel_ab/`` and called through their C entry points, with the
signatures that the other tree's own ``build.py`` (beside its ``csrc``)
declares: ``gossip_mix_all_f32`` and ``gossip_mix_block_f32`` get a scratch
where that tree sizes one (``gossip_mix_all_scratch_floats``,
``gossip_mix_block_scratch_floats``); this tree's kernels go through the
wrappers, its compression kernels through their C entries, as the other
tree's.
Each case is timed parent, change, change, parent (CUDA events around
repeated calls, inputs cycled past the 50 MB L2 where the caller finds them
cold), beside ``torch.matmul`` for the exchange:

  - ``gossip_mix_all`` at N_T = 10, 128 and 1024 users of the CIFAR-10 CNN
    (L = 552,714), float32, the weights of a random sparse mixing matrix;
  - ``gossip_mix_block`` at the sharded path's shape (m = 128, H = 16) and a
    heavy halo (m = 125, H = 472), L = 552,714, random sparse blocks;
  - ``sdp_subspace`` at n = 1665, k = 16, cold (10 distinct Y) and warm (one
    Y, as the DR loop's 5 calls an iteration find it in L2);
  - ``rank_k_update`` at n = 1665, k = 16, cold (10 distinct Y);
  - ``bottleneck_eval`` at the batched scheduler's shape (64 lanes × 4000
    samples, T = 128, K = 8, E = 384) and at the single schedule's (one lane
    × 4000, T = 104, K = 16, E = 302), random edges sorted by source as a
    ``TaskGraph`` keeps them: a tree whose entry takes one lane is called
    once per lane, one that takes a lane axis once;
  - ``topk_mask`` and ``int8_roundtrip``, float32: one round's compression of
    the (N_T, 552,714) delta at N_T = 10 and 128, every leaf of the CIFAR-10
    CNN (both trees through their C entries: a tree whose entry takes one
    column range is called once per leaf, one that takes a table of ranges
    once a round), both outputs bit-equal to the plain version; then, for
    each tree, each leaf's launch alone and the big leaf (N, 524,288) with
    rows as they lie in the flat buffer (stride 552,714 floats, odd rows 8
    bytes off 16-byte alignment) and with every row aligned (stride
    552,716), each launch on memory no other launch of the timing touched,
    after a 128 MB write that pushes everything else out of the L2;
  - ``flash_attention``, causal bfloat16 at the training path's shape (B =
    2, S = 4096) and the prefill's (B = 1, S = 32,768), H = 32, Hkv = 8, D =
    128: the other tree's C entry (with a null logsumexp pointer where it
    takes one) against this tree's wrapper without and with the logsumexp
    output, the three outputs bit-equal;
  - ``decode_attention``, bfloat16, B = 8, at the eight shapes of PERF.md row
    10 (``DECODE_SHAPES``): the other tree's C entry (sized by its own
    ``decode_attention_splits`` where it has one, else by this tree's
    ``decode_plan``) against this tree's wrapper, beside one SDPA call with
    a boolean mask; the two outputs within ``chip_smoke.attn_share``'s bound
    of each other and of the plain version;
  - ``rmsnorm``, bfloat16 x and scale, at ``NORM_SHAPES`` (PERF.md row 11's
    shapes and the registry's widths 5,120, 8,192 and 12,288 at 8 and 4,096
    rows): the other tree's C entry (given this tree's plan where it takes
    one) against this tree's wrapper, beside ``F.rms_norm`` with the bfloat16
    weight 1 + scale, both outputs within ``chip_smoke.rmsnorm_ok`` of the
    plain version; the host's µs a call of the wrapper and of ``F.rms_norm``
    at (8, 4,096) while a sleep kernel holds the stream, beside the other
    tree's own ``rmsnorm.py`` wrapper over its library; and rows 9 and 10 of
    the two trees bit-equal at one flash and two decode shapes.

A second argument picks groups of rows, comma-separated: ``exchange`` (rows
4, 5), ``scheduler`` (rows 1-3), ``compression`` (rows 7, 8), ``attention``
(row 9), ``decode`` (row 10), ``rmsnorm`` (row 11); all by default.

Every result is also checked against the plain version (relative 1e-5;
``bottleneck_eval`` to the float32 rounding of its machine loads).
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
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

from chip_smoke import attn_share, bound_ms, host_us, rmsnorm_ok  # noqa: E402

from repro_torch.device import sm_count  # noqa: E402
from repro_torch.fl.cnn import init_cnn_params  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.bottleneck import bottleneck_eval, bottleneck_eval_plain  # noqa: E402
from repro_torch.kernels.compress import int8_roundtrip_plain, topk_mask_plain  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention,
    decode_attention_plain,
    decode_plan,
)
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
from repro_torch.train.compression import int8_scale, topk_count  # noqa: E402
from repro_torch.train.tree import ParamLayout  # noqa: E402
from variant_build import device_us  # noqa: E402

OUT = REPO / "build" / "kernel_ab"
ENTRIES = ("gossip_mix_all_f32", "gossip_mix_all_scratch_floats", "gossip_mix_block_f32",
           "gossip_mix_block_scratch_floats", "sdp_subspace_f32", "sdp_subspace_scratch_floats",
           "rank_k_update_f32", "topk_mask_f32", "int8_roundtrip_f32", "bottleneck_eval",
           "flash_attention", "decode_attention", "decode_attention_splits", "rmsnorm")
SOURCES = ("gossip_mix", "sdp_proj", "compress", "bottleneck", "flash_attention",
           "decode_attention", "rmsnorm")
# row 10's shapes (PERF.md §6): label, B, H, Hkv, S, D, lengths ("spread": 1..S
# over the batch, "full": S each, "phase 10": 32,737 − 4,096·b, chip_smoke.py
# phase 10's)
DECODE_SHAPES = (
    ("recurrentgemma ring g=16 D=256 S=2048", 8, 16, 1, 2048, 256, "spread"),
    ("qwen2-vl g=8 S=256", 8, 64, 8, 256, 128, "spread"),
    ("qwen2-vl g=8 S=4096", 8, 64, 8, 4096, 128, "spread"),
    ("whisper self g=1 D=64 S=448", 8, 12, 12, 448, 64, "spread"),
    ("olmoe g=1 S=256", 8, 16, 16, 256, 128, "spread"),
    ("whisper cross g=1 D=64 S=1500", 8, 12, 12, 1500, 64, "full"),
    ("olmoe g=1 S=4096", 8, 16, 16, 4096, 128, "spread"),
    ("qwen3-8b g=4 S=32768", 8, 32, 8, 32768, 128, "phase 10"),
)
# row 11's shapes (PERF.md §6), bfloat16: (R, D)
NORM_SHAPES = ((12000, 768), (4096, 2048), (4096, 4096), (8192, 4096), (32768, 4096),
               (32768 * 32, 128), (8, 4096), (8, 2048), (8, 5120), (4096, 5120), (8, 8192),
               (4096, 8192), (8, 12288), (4096, 12288))


def parent_signatures(csrc: Path) -> dict:
    """``SIGNATURES`` of the other tree's ``build.py`` (it imports only the
    standard library and builds nothing when imported)."""
    spec = importlib.util.spec_from_file_location("parent_build", csrc.parent / "build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SIGNATURES


def compile_parent(csrc: Path) -> ctypes.CDLL:
    """The other tree's sources -> one shared library (one nvcc per file),
    its entry points typed as that tree declares them."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = build.tool()
    procs = [subprocess.Popen([nvcc, *build.ARCH_FLAGS, *build.CFLAGS, "-c", str(csrc / f"{s}.cu"),
                               "-o", str(OUT / f"{s}.o")], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s in SOURCES]
    for p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed:\n{log}")
    lib = OUT / "libparent.so"
    subprocess.run([nvcc, *build.ARCH_FLAGS, "-shared", *(str(OUT / f"{s}.o") for s in SOURCES),
                    "-o", str(lib)], check=True)
    dll = ctypes.CDLL(str(lib))
    for name, (args, res) in parent_signatures(csrc).items():
        if name in ENTRIES:
            getattr(dll, name).argtypes, getattr(dll, name).restype = args, res
    dll.csrc = csrc
    return dll


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def compress_entry(lib, name: str):
    """``run(x, stat, msg, resid, ranges)`` through ``lib``'s C entry ``name``
    (float32): x, msg and resid share their row stride; ``stat`` is (N,
    len(ranges)).  An entry that takes one column range (10 arguments) is
    called once per range with that range's statistics (a contiguous copy,
    made before the timing by ``leaf_stats``); one that takes a table of
    ranges is called once."""
    fn = getattr(lib, name)
    grouped = len(fn.argtypes) != 10

    def run(x, stat, msg, resid, ranges, leaf_stats=None):
        n, ld = x.shape[0], x.stride(0)
        if grouped:
            table = (ctypes.c_longlong * (2 * len(ranges)))(*(c for r in ranges for c in r))
            errs = [fn(x.data_ptr(), ld, stat.data_ptr(), msg.data_ptr(), ld, resid.data_ptr(),
                       ld, n, table, len(ranges), stream())]
        else:
            stats = leaf_stats if leaf_stats is not None else [
                stat[:, j].contiguous() for j in range(len(ranges))]
            errs = [fn(x.data_ptr() + 4 * a, ld, st.data_ptr(), msg.data_ptr() + 4 * a, ld,
                       resid.data_ptr() + 4 * a, ld, n, b - a, stream())
                    for (a, b), st in zip(ranges, stats)]
        if any(errs):
            raise SystemExit(f"{name}: cudaError_t {errs}")
    return run


def cold_us(fn, arg_sets, flush) -> float:
    """Device time of one call, each of ``arg_sets`` touching memory no other
    one touches, after ``flush`` is written over the L2 (the first set warms
    up and is not timed)."""
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    flush.zero_()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for args in arg_sets[1:]:
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (len(arg_sets) - 1) * 1e3


def windows(pool, n: int, a: int, b: int, count: int) -> list:
    """Up to ``count`` (n, b − a) column windows of ``pool`` (k·n rows) on
    disjoint memory: the range shifted right in steps of whole 64-column
    blocks (the same 16-byte alignment as at ``a``), then the next n rows."""
    w, step = b - a, -(-(b - a) // 64) * 64
    out = []
    for r in range(0, pool.shape[0] - n + 1, n):
        for c in range(a, pool.shape[1] - w + 1, step):
            out.append(pool[r:r + n, c:c + w])
            if len(out) == count:
                return out
    return out


def compress_split(run, n: int, cols, L: int, gen, flush) -> str:
    """Each leaf's launch alone (cold), and the big leaf with rows as they lie
    in the flat buffer and with every row 16-byte aligned."""
    dev = flush.device
    times = []
    for ld, ranges in ((L, cols), (L + 2, [max(cols, key=lambda r: r[1] - r[0])])):
        k = max(4, -(-400_000_000 // (n * ld * 4)))
        pool = torch.randn(k * n, ld, generator=gen, device=dev)
        out = torch.empty_like(pool)
        for a, b in ranges:
            sets = []
            for x in windows(pool, n, a, b, 65):
                r0, c0 = divmod(x.storage_offset(), ld)
                st = torch.rand(n, 1, device=dev) + 0.5
                sets.append((x, st, out[r0:r0 + n, c0:c0 + b - a], [st[:, 0]]))
            # msg over x in place, as the trainer does; the residual to its own buffer
            times.append(cold_us(lambda x, st, r, ls: run(x, st, x, r, [(0, b - a)], ls),
                                 sets, flush))
        del pool, out
        torch.cuda.empty_cache()
    big = max(range(len(cols)), key=lambda j: cols[j][1] - cols[j][0])
    per = ", ".join(f"{b - a}: {t:.2f}" for (a, b), t in zip(cols, times))
    return (f"each leaf alone (columns: us) {per}; sum {sum(times[:len(cols)]):.2f} us; big leaf "
            f"rows as they lie {times[big]:.2f} us, every row aligned {times[-1]:.2f} us")


def rel(a, b) -> float:
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    return float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)), 1e-30))


def turns(label: str, parent, change, sets, reps: int) -> None:
    t = [device_us(f, sets, reps) for f in (parent, change, change, parent)]
    print(f"ab {label}: parent {t[0]:.2f} / {t[3]:.2f} us, change {t[1]:.2f} / {t[2]:.2f} us "
          f"(parent, change, change, parent)", flush=True)


def bottleneck_ab(old, gen, dev) -> None:
    """Row 3: the other tree's ``bottleneck_eval`` (one launch a lane where its
    entry takes one lane) against this tree's (one launch)."""
    fn = old.bottleneck_eval
    per_lane = len(fn.argtypes) == 12        # assign, p, e, C, src, dst, out, S, T, K, E, stream
                                             # (a lane axis adds B after out)

    for B, S, T, K, E in ((64, 4000, 128, 8, 384), (1, 4000, 104, 16, 302)):
        def inputs():
            # edges sorted by (source, destination), as a TaskGraph keeps them
            key = torch.sort(torch.randint(0, T * T, (B, E), generator=gen, device=dev),
                             dim=1).values
            return (torch.randint(0, K, (B, S, T), generator=gen, device=dev, dtype=torch.int32),
                    torch.rand(B, T, generator=gen, device=dev) * 3,
                    torch.rand(B, K, generator=gen, device=dev) + 0.5,
                    torch.rand(B, K, K, generator=gen, device=dev) * 3,
                    (key // T).to(torch.int32), (key % T).to(torch.int32))

        sets = [inputs() for _ in range(max(2, -(-100_000_000 // (B * S * T * 4))))]
        out = torch.empty(B, S, device=dev)

        def parent(a, p, e, C, src, dst):
            if per_lane:
                errs = [fn(a[i].data_ptr(), p[i].data_ptr(), e[i].data_ptr(), C[i].data_ptr(),
                           src[i].data_ptr(), dst[i].data_ptr(), out[i].data_ptr(), S, T, K, E,
                           stream()) for i in range(B)]
            else:
                errs = [fn(a.data_ptr(), p.data_ptr(), e.data_ptr(), C.data_ptr(), src.data_ptr(),
                           dst.data_ptr(), out.data_ptr(), B, S, T, K, E, stream())]
            if any(errs):
                raise SystemExit(f"parent bottleneck_eval: cudaError_t {errs}")

        want = bottleneck_eval_plain(*sets[0])
        parent(*sets[0])
        tol = 2 * T * 2.0 ** -24 * want.abs()
        ok_old = bool(torch.all((out - want).abs() <= tol))
        ok_new = bool(torch.all((bottleneck_eval(*sets[0]) - want).abs() <= tol))
        print(f"ab bottleneck_eval B={B} S={S} T={T} K={K} E={E}: within the load-sum rounding "
              f"of the plain version: parent {ok_old}, change {ok_new}", flush=True)
        if not (ok_old and ok_new):
            raise SystemExit("FAILED: bottleneck_eval disagrees with its plain version")
        turns(f"bottleneck_eval B={B} S={S} T={T} K={K} E={E} (parent: "
              f"{B if per_lane else 1} launches)", parent, bottleneck_eval, sets,
              10 if B > 1 else 200)
        del sets, out, want
        torch.cuda.empty_cache()


L = 552714                     # parameters of the CIFAR-10 CNN


def exchange_ab(old, gen, dev) -> None:
    """Rows 4 and 5."""
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



def scheduler_ab(old, gen, dev) -> None:
    """Rows 1, 2 and 3."""
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
    # a tree whose entries take a lane count gets one lane
    one_lane = (1,) if len(old.sdp_subspace_f32.argtypes) == 10 else ()

    def parent_sdp(Y, V):
        old.sdp_subspace_f32(Y.data_ptr(), V.data_ptr(), YV.data_ptr(), G.data_ptr(),
                             ss.data_ptr(), scratch.data_ptr(), n, k, *one_lane, stream())

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
                              *one_lane, stream())

    parent_rank_k(*sets[0])
    want = rank_k_update_plain(*sets[0])
    e_old, e_new = rel(o, want), rel(rank_k_update(*sets[0]), want)
    print(f"ab rank_k_update n={n} k={k}: rel error parent {e_old:.3e}, change {e_new:.3e}",
          flush=True)
    if max(e_old, e_new) > 1e-5:
        raise SystemExit("FAILED: rank_k_update disagrees with its plain version")
    turns(f"rank_k_update n={n} k={k} cold", parent_rank_k, rank_k_update, sets, 200)
    del sets, o, YV, G, ss, scratch
    torch.cuda.empty_cache()
    bottleneck_ab(old, gen, dev)


def compression_ab(old, gen, dev) -> None:
    """Rows 7 and 8."""
    cols = ParamLayout(init_cnn_params(torch.Generator(), (32, 32, 3))).columns()
    flush = torch.empty(32_000_000, device=dev)
    for name, plain in (("topk_mask", topk_mask_plain), ("int8_roundtrip", int8_roundtrip_plain)):
        runs = {"parent": compress_entry(old, f"{name}_f32"),
                "change": compress_entry(build.library(), f"{name}_f32")}
        for n in (10, 128):
            sets = []
            for _ in range(max(2, -(-100_000_000 // (n * L * 4)))):
                x = torch.randn(n, L, generator=gen, device=dev)
                if name == "topk_mask":
                    st = torch.stack([torch.topk(x[:, a:b].abs(), topk_count(0.05, b - a),
                                                 dim=1).values[:, -1] for a, b in cols], dim=1)
                else:
                    st = torch.stack([int8_scale(x[:, a:b]) for a, b in cols], dim=1)
                sets.append((x, st, [st[:, j].contiguous() for j in range(len(cols))]))
            msg, resid = torch.empty_like(sets[0][0]), torch.empty_like(sets[0][0])
            x, st, _ = sets[0]
            for side, run in runs.items():
                msg.fill_(float("nan"))
                resid.fill_(float("nan"))
                run(x, st, msg, resid, cols)
                ok = True
                for j, (a, b) in enumerate(cols):
                    want = plain(x[:, a:b], st[:, j])
                    ok &= torch.equal(msg[:, a:b], want[0]) and torch.equal(resid[:, a:b], want[1])
                if not ok:
                    raise SystemExit(f"FAILED: {name} ({side}) is not bit-equal to its plain "
                                     "version")
            print(f"ab {name} N_T={n}: both outputs of parent and change bit-equal to the plain "
                  "version over every leaf", flush=True)
            turns(f"{name} N_T={n} L={L}, a round of {len(cols)} leaves",
                  *(lambda x, st, ls, r=runs[s]: r(x, st, msg, resid, cols, ls)
                    for s in ("parent", "change")), sets, 100)
            del sets, msg, resid, x, st
            torch.cuda.empty_cache()
            for side, run in runs.items():
                print(f"ab {name} N_T={n} {side}: {compress_split(run, n, cols, L, gen, flush)}",
                      flush=True)


def flash_parent(old):
    """The other tree's causal bfloat16 flash forward through its C entry."""
    import math

    fn = old.flash_attention
    # the other tree's entry point: 15 arguments, 16 with the lse pointer, 17 with
    # separate query and key lengths
    with_lse, two_lengths = len(fn.argtypes) >= 16, len(fn.argtypes) >= 17

    def parent(q, k, v):
        out = torch.empty_like(q)
        B, H, S, D = q.shape
        strides = (ctypes.c_longlong * 12)(*(x for t in (q, k, v, out) for x in t.stride()[:3]))
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()] + [None] * with_lse
        lengths = (S, S) if two_lengths else (S,)
        build.check(fn(*ptrs, strides, B, H, k.shape[1], *lengths, D, 1, 0, 1.0 / math.sqrt(D),
                       1, stream()), "parent flash_attention")
        return out
    return parent


def attention_ab(old, gen, dev) -> None:
    """Row 9: the other tree's bfloat16 flash forward against this tree's,
    without and with the logsumexp output."""
    from repro_torch.kernels.flash_attention import flash_attention

    parent = flash_parent(old)

    def change(q, k, v):
        return flash_attention(q, k, v)

    def change_lse(q, k, v):
        return flash_attention(q, k, v, return_lse=True)[0]

    for B, S, reps in ((2, 4096, 20), (1, 32768, 3)):
        sets = [tuple(torch.randn(B, S, h, 128, generator=gen, device=dev).to(torch.bfloat16)
                      .transpose(1, 2) for h in (32, 8, 8)) for _ in range(2)]
        a, b, c = (f(*sets[0]) for f in (parent, change, change_lse))
        print(f"ab flash_attention B={B} S={S}: parent, change and change with lse bit-equal "
              f"{torch.equal(a, b) and torch.equal(b, c)}", flush=True)
        turns(f"flash_attention B={B} S={S} causal bf16", parent, change, sets, reps)
        turns(f"flash_attention B={B} S={S} causal bf16, change with lse", parent, change_lse,
              sets, reps)
        del sets, a, b, c
        torch.cuda.empty_cache()


def decode_lengths(kind: str, B: int, S: int, dev) -> torch.Tensor:
    if kind == "full":
        return torch.full((B,), S, dtype=torch.int32, device=dev)
    if kind == "phase 10":
        return (32736 - 4096 * torch.arange(B, device=dev) + 1).to(torch.int32)
    return torch.linspace(1, S, B, device=dev).round().to(torch.int32)


def decode_sets(gen, dev, B, H, Hkv, S, D, lens) -> list:
    """Distinct bfloat16 (q, k, v, lengths) sets, more bytes than twice the L2."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)
    n = max(2, -(-100_000_000 // (2 * B * S * Hkv * D * 2)))
    return [(randn(B, H, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D), lens) for _ in range(n)]


def decode_bound(B, H, Hkv, D, lens) -> tuple[float, str]:
    """chip_smoke.py's bound: the live slots' k and v, q and out, the lengths."""
    valid = int(lens.clamp(min=0).sum())
    return bound_ms(2 * (2 * valid * Hkv * D + 2 * B * H * D) + 4 * B, 4 * H * D * valid, 989e12)


def decode_parent(old, dev):
    """The other tree's bfloat16 decode attention through its C entry (and
    its own scratch sizing)."""
    import math

    fn = old.decode_attention
    chunked = len(fn.argtypes) == 17       # q … out, pacc, pml, tickets, B … D, chunk, …
    tickets = torch.zeros(1 << 16, dtype=torch.int32, device=dev)

    def parent(q, k, v, lens):
        B, H, D = q.shape
        S, Hkv = k.shape[1], k.shape[2]
        out = torch.empty_like(q)
        if chunked:
            plan = decode_plan(B, H, Hkv, S, D, sm_count(dev.index))
            n, extra = plan.splits, ([tickets.data_ptr()], [plan.chunk])
        else:
            n, extra = old.decode_attention_splits(S), ([], [])
        pa = torch.empty((B, H, n, D), dtype=torch.float32, device=dev)
        pm = torch.empty((B, H, n, 2), dtype=torch.float32, device=dev)
        build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(),
                       pa.data_ptr(), pm.data_ptr(), *extra[0], B, H, Hkv, S, D, *extra[1],
                       1.0 / math.sqrt(D), 1, stream()), "parent decode_attention")
        return out
    return parent


def decode_ab(old, gen, dev) -> None:
    """Row 10: the other tree's decode kernel (through its C entry and its own
    scratch sizing) against this tree's wrapper, beside SDPA with a mask."""
    parent = decode_parent(old, dev)
    for label, B, H, Hkv, S, D, kind in DECODE_SHAPES:
        lens = decode_lengths(kind, B, S, dev)
        sets = decode_sets(gen, dev, B, H, Hkv, S, D, lens)
        a, b = parent(*sets[0]), decode_attention(*sets[0])
        want = decode_attention_plain(*sets[0])
        shares = (attn_share(b, a), attn_share(a, b), attn_share(b, want), attn_share(a, want))
        if max(shares) > 1:
            raise SystemExit(f"ab decode_attention {label}: outputs apart, attn_share {shares}")
        mask = (torch.arange(S, device=dev)[None] < lens[:, None])[:, None, None]

        def sdpa(q, k, v, _lens):
            return torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
                enable_gqa=True)
        reps = 20 if S >= 32768 else 200
        plan = decode_plan(B, H, Hkv, S, D, sm_count(dev.index))
        bound, by = decode_bound(B, H, Hkv, D, lens)
        print(f"ab decode_attention {label}: lengths {lens.tolist()}, plan {tuple(plan)}; "
              f"attn_share change/parent {shares[0]:.3f}, parent/change {shares[1]:.3f}, "
              f"change/plain {shares[2]:.3f}, parent/plain {shares[3]:.3f}; bound "
              f"{bound * 1e3:.2f} us ({by}); SDPA with a mask {device_us(sdpa, sets, reps):.2f} us",
              flush=True)
        turns(f"decode_attention {label}", parent, decode_attention, sets, reps)
        del sets, a, b, want, mask
        torch.cuda.empty_cache()


def parent_wrapper(old):
    """The other tree's ``rmsnorm.py`` wrapper, its ``build`` pointed at the
    other tree's library (so its own host path calls its own C entry)."""
    import types

    spec = importlib.util.spec_from_file_location("parent_rmsnorm",
                                                  old.csrc.parent / "rmsnorm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.build = types.SimpleNamespace(library=lambda: old, check=build.check)
    return mod.rmsnorm


def rmsnorm_host(gen, dev, parent=None) -> None:
    """The host's µs a call at (8, 4096) bf16, the stream held by a sleep
    kernel: the wrapper (and the other tree's, where given), ``F.rms_norm``,
    and the wrapper's steps alone."""
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plan

    x = torch.randn(8, 4096, generator=gen, device=dev).to(torch.bfloat16)
    s = torch.randn(4096, generator=gen, device=dev).to(torch.bfloat16)
    w, out = 1.0 + s, torch.empty_like(x)
    plan = rmsnorm_plan(8, 4096, 2, sm_count(dev.index))
    entry = build.library().rmsnorm
    args = (x.data_ptr(), s.data_ptr(), out.data_ptr(), 8, 4096, 1e-6, 1, 1, *plan, stream())

    def device_scope():
        with torch.cuda.device(dev):
            pass

    steps = {"rmsnorm": lambda: rmsnorm(x, s),
             "F.rms_norm": lambda: F.rms_norm(x, (4096,), w, 1e-6),
             "torch.empty_like": lambda: torch.empty_like(x),
             "torch.cuda.device scope": device_scope,
             "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
             "rmsnorm_plan (cached)": lambda: rmsnorm_plan(8, 4096, 2, sm_count(dev.index)),
             "ctypes call (launch)": lambda: entry(*args)}
    if parent is not None:
        steps["parent rmsnorm"] = lambda: parent(x, s)
    for _ in range(2):        # in turns
        t = {k: host_us(f) for k, f in steps.items()}
        print("ab rmsnorm host (8, 4096) bf16, us a call (the stream held by a sleep kernel): "
              + ", ".join(f"{k} {v:.2f}" for k, v in t.items()), flush=True)


def rmsnorm_ab(old, gen, dev) -> None:
    """Row 11: the other tree's RMSNorm (through its C entry) against this
    tree's wrapper, beside ``F.rms_norm`` with a bfloat16 weight; the host's
    cost a call; rows 9 and 10 of the two trees bit-equal."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain, rmsnorm_plan

    fn = old.rmsnorm
    planned = len(fn.argtypes) == 13          # … x bf16, scale bf16, the plan, stream
    sms = sm_count(dev.index)

    def parent(x, s):
        out = torch.empty_like(x)
        R, D = x.shape
        plan = tuple(rmsnorm_plan(R, D, x.element_size(), sms)) if planned else ()
        build.check(fn(x.data_ptr(), s.data_ptr(), out.data_ptr(), R, D, 1e-6,
                       int(x.dtype == torch.bfloat16), int(s.dtype == torch.bfloat16), *plan,
                       stream()), "parent rmsnorm")
        return out

    for R, D in NORM_SHAPES:
        def one_set():
            return (torch.randn(R, D, generator=gen, device=dev).to(torch.bfloat16),
                    (torch.randn(D, generator=gen, device=dev) * 0.5).to(torch.bfloat16))
        sets = [one_set() for _ in range(max(2, -(-100_000_000 // (4 * R * D))))]
        a, b = parent(*sets[0]), rmsnorm(*sets[0])
        want = rmsnorm_plain(*sets[0])
        if not (rmsnorm_ok(a, want) and rmsnorm_ok(b, want)):
            raise SystemExit(f"FAILED: rmsnorm ({R}, {D}) outside rmsnorm_ok: parent "
                             f"{rmsnorm_ok(a, want)}, change {rmsnorm_ok(b, want)}")
        bound, by = bound_ms(2 * (2 * R * D + D), 4 * R * D)
        weights = [(x, 1.0 + s) for x, s in sets]      # F.rms_norm's weight, made before timing
        lib = device_us(lambda x, w: F.rms_norm(x, (D,), w, 1e-6), weights, 100)
        print(f"ab rmsnorm ({R}, {D}) bf16: plan {tuple(rmsnorm_plan(R, D, 2, sms))}, both within "
              f"rmsnorm_ok, bit-equal {torch.equal(a, b)}; bound {bound * 1e3:.2f} us ({by}); "
              f"F.rms_norm (bf16 weight) {lib:.2f} us", flush=True)
        turns(f"rmsnorm ({R}, {D}) bf16", parent, rmsnorm, sets, 100)
        del sets, weights, a, b, want
        torch.cuda.empty_cache()

    rmsnorm_host(gen, dev, parent_wrapper(old))
    flash_old = flash_parent(old)
    q, k, v = (torch.randn(1, 4096, h, 128, generator=gen, device=dev).to(torch.bfloat16)
               .transpose(1, 2) for h in (32, 8, 8))
    same = torch.equal(flash_old(q, k, v), flash_attention(q, k, v))
    decode_old = decode_parent(old, dev)
    for label, B, H, Hkv, S, D, kind in (DECODE_SHAPES[2], DECODE_SHAPES[3]):
        args = decode_sets(gen, dev, B, H, Hkv, S, D, decode_lengths(kind, B, S, dev))[0]
        same = same and torch.equal(decode_old(*args), decode_attention(*args))
    print(f"ab rmsnorm: flash (1, 32, 8, 4096, 128) causal and decode {DECODE_SHAPES[2][0]}, "
          f"{DECODE_SHAPES[3][0]} bit-equal to the parent's: {same}", flush=True)
    if not same:
        raise SystemExit("FAILED: rows 9 and 10 differ from the parent's")


GROUPS = {"exchange": exchange_ab, "scheduler": scheduler_ab, "compression": compression_ab,
          "attention": attention_ab, "decode": decode_ab, "rmsnorm": rmsnorm_ab}


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    old = compile_parent(Path(sys.argv[1]))
    build.library()
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {out}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)

    for name in (sys.argv[2].split(",") if len(sys.argv) == 3 else GROUPS):
        GROUPS[name](old, gen, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
