"""Which operations of the DR loop and the rounding give a lane of a batch
different bits from the same lane alone, or different bits from run to run?

    python3 scripts/lane_ops.py [cuda|cpu]

On the dense operator of ``ring_uniform`` and ``torus_cluster`` (the
scenario presets the sweep batches, n + 1 = 49 and 97) and at phase 16's
batched shapes, each operation runs on B = 4 stacked lanes and on each lane
alone (a batch of one), twice; a line says whether lane 0 of the batch
equals lane 0 alone bit for bit, whether two runs agree, and the time of
one call.  The constraint sums are tried five ways: ``index_add_``
(atomics), ``index_put_(accumulate=True)`` (a sort a call), the sorted
triplets through ``torch.segment_reduce``, a CSR sparse matrix product,
and a dense batched product.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

B = 4


def timed(fn, reps: int = 20) -> float:
    fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3, out


def report(name: str, batched, alone) -> None:
    """``batched(x)`` on the (B, …) inputs against ``alone`` on lane 0."""
    ms, got = timed(batched)
    _, again = timed(batched, 1)
    ms1, one = timed(alone)
    got, again, one = (t[0] if isinstance(t, tuple) else t for t in (got, again, one))
    lane_same = bool(torch.equal(got[0], one[0]))
    run_same = bool(torch.equal(got, again))
    diff = float(torch.max(torch.abs(got[0].double() - one[0].double())))
    print(f"{name}: lane 0 bit-equal alone {lane_same} (max diff {diff:.3g}), runs bit-equal "
          f"{run_same}; {ms:.3f} ms for {B} lanes, {ms1:.3f} ms alone", flush=True)


def operator(name: str, dev):
    from repro_torch.core import build_bqp
    from repro_torch.core.sdp import _AffineProjector
    from repro_torch.scenarios import get_scenario
    from repro_torch.scenarios.engine import build_compute_graph, build_task_graph

    sc = get_scenario(name)
    rng = np.random.default_rng(0)
    tg = build_task_graph(sc, rng)
    cg, _ = build_compute_graph(sc, rng)
    bqp = build_bqp(tg, cg)
    proj = _AffineProjector(bqp)
    rows, cols, vals, b = proj.export_csr()
    return (torch.as_tensor(np.asarray(vals, np.float32), device=dev),
            torch.as_tensor(np.asarray(rows, np.int64), device=dev),
            torch.as_tensor(np.asarray(cols, np.int64), device=dev), len(b), proj)


def sums(name: str, dev) -> None:
    val, row, col, m, proj = operator(name, dev)
    dim = int(col.max()) + 1
    g = torch.Generator(device=dev).manual_seed(0)
    v = torch.randn(B, dim, generator=g, device=dev)
    lanes = torch.arange(B, device=dev)[:, None]

    def with_lanes(k):
        return (row + lanes[:k] * m).reshape(-1), (col + lanes[:k] * dim).reshape(-1)

    def add(vv):
        k = vv.shape[0]
        r, c = with_lanes(k)
        return torch.zeros(k * m, device=dev).index_add_(0, r, (val * vv.reshape(-1)[c]
                                                                .view(k, -1)).reshape(-1)).view(k, m)

    def put(vv):
        k = vv.shape[0]
        r, c = with_lanes(k)
        return torch.zeros(k * m, device=dev).index_put_(
            (r,), (val * vv.reshape(-1)[c].view(k, -1)).reshape(-1), accumulate=True).view(k, m)

    order = torch.argsort(row, stable=True)
    lengths = torch.bincount(row, minlength=m)

    def seg(vv):
        k = vv.shape[0]
        terms = (val[order] * vv[:, col[order]]).reshape(-1)
        return torch.segment_reduce(terms, "sum", lengths=lengths.repeat(k)).view(k, m)

    def csr(vv):
        k = vv.shape[0]
        r, c = with_lanes(k)
        A = torch.sparse_coo_tensor(torch.stack([r, c]), val.repeat(k), (k * m, k * dim)
                                    ).coalesce().to_sparse_csr()
        return (A @ vv.reshape(-1, 1)).view(k, m)

    L = torch.zeros(m, dim, device=dev)
    L.index_put_((row, col), val, accumulate=True)

    def dense(vv):
        return torch.bmm(L.expand(vv.shape[0], m, dim), vv[:, :, None])[:, :, 0]

    print(f"{name}: m = {m} rows, dim = {dim}, {val.numel()} triplets", flush=True)
    for label, fn in (("index_add_", add), ("index_put_", put), ("segment_reduce", seg),
                      ("sparse csr", csr), ("dense bmm", dense)):
        report(f"  matvec {label}", lambda: fn(v), lambda: fn(v[:1]))


def linalg(n1: int, m: int, dev, k: int = 16) -> None:
    g = torch.Generator(device=dev).manual_seed(1)
    Y = torch.randn(B, n1, n1, generator=g, device=dev)
    Y = 0.5 * (Y + Y.transpose(1, 2))
    V = torch.randn(B, n1, k, generator=g, device=dev)
    G = torch.randn(B, k, k, generator=g, device=dev)
    G = 0.5 * (G + G.transpose(1, 2))
    A = torch.randn(B, m, m, generator=g, device=dev)
    CL = torch.linalg.cholesky(A @ A.transpose(1, 2) + m * torch.eye(m, device=dev))
    r = torch.randn(B, m, 1, generator=g, device=dev)
    print(f"linear algebra at n + 1 = {n1}, k = {k}, m = {m}:", flush=True)
    ops = {
        "eigh (n+1)": lambda x: torch.linalg.eigh(x[0])[1],
        "eigh (k)": lambda x: torch.linalg.eigh(x[1])[1],
        "qr (n+1, k)": lambda x: torch.linalg.qr(x[2]).Q,
        "bmm (n+1, k)(k, k)": lambda x: x[2] @ x[1],
        "bmm (n+1)(n+1)": lambda x: x[0] @ x[0].transpose(1, 2),
        "solve_triangular": lambda x: torch.linalg.solve_triangular(x[3], x[4], upper=False),
        "sum over rows": lambda x: torch.sum(x[2] * x[2], dim=1),
        "sum of squares a lane": lambda x: torch.sum(x[0].reshape(x[0].shape[0], -1) ** 2, dim=1),
    }
    xs = (Y, G, V, CL, r)
    for label, fn in ops.items():
        report(f"  {label}", lambda: fn(xs), lambda: fn(tuple(t[:1] for t in xs)))


def main(argv: list[str]) -> int:
    from repro_torch.device import resolve_device

    dev = resolve_device(argv[0] if argv else None)
    print(f"device {dev}, torch {torch.__version__}", flush=True)
    for name in ("ring_uniform", "torus_cluster"):
        sums(name, dev)
    for n1, m in ((49, 85), (97, 165), (1025, 1400)):
        linalg(n1, m, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
