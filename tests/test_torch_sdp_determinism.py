"""The factored operator's DR loop sums in a fixed order.

On CUDA a float ``scatter_add`` (or ``index_add_``, or an ``index_put_``
that accumulates) sums through atomics in whatever order they land, and the
DR loop amplifies that noise into other iterates and other schedules from
run to run.  The factored operator's ``rmatvec`` therefore sums its edge
weights as sorted segments.  These tests hold it on the CPU, where no card
is present:

  (a) no op that accumulates by atomics on CUDA runs in a factored solve, a
      lone one or a batch of three lanes (the aten ops recorded under a
      ``TorchDispatchMode``);
  (b) the factored ``matvec`` / ``rmatvec`` equal the dense ("csr")
      operator's on the same instance in float64 to 1e-10, and satisfy the
      adjoint identity <A v, y> = <v, Aᵀ y>;
  (c) the factored solve still matches ``repro``'s jax solve as
      ``tests/test_torch_sdp.py`` holds it (equal iteration and projection
      counts; Y, t and the residual within 1e-3).

The run-to-run equality itself needs the card:
``tests/test_torch_card.py::test_factored_schedule_same_on_every_run`` and
``::test_factored_batch_same_on_every_run``.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.core as R
import repro_torch.core as P
from repro.core.sdp import SDPOptions as ROptions
from repro_torch.core import sdp as psdp
from repro_torch.core.sdp import SDPOptions


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: intra-op threads only contend with the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32_ATOL = 1e-3                         # tests/test_torch_sdp.py's tolerance
F64_TOL = 1e-10
FIXED = dict(max_iters=400, tol=0.0, check_every=25)
# (tasks, machines, degree_low, degree_high, seed): tests/test_sdp_jax.py's
# 6×3 instance and a 20 × 4 one drawn as the paper's §4.1.2 instances are
SIZES = {"6x3": (6, 3, 1, 3, 42), "20x4": (20, 4, 2, 4, 7)}

# ops that CUDA runs with atomic adds (float sums in arrival order)
ATOMIC_OPS = {"scatter_add", "scatter_add_", "index_add", "index_add_", "scatter_reduce",
              "scatter_reduce_", "_scatter_reduce"}
# ops that do so only when they accumulate: the position of ``accumulate``
ACCUMULATE_AT = {"index_put": 3, "index_put_": 3, "_index_put_impl_": 3,
                 "_unsafe_index_put": 3, "put": 3, "put_": 3}


class _AtomicOps(TorchDispatchMode):
    """Records every aten op that runs, and names those that would sum by
    atomics on CUDA."""

    def __init__(self):
        super().__init__()
        self.names: set[str] = set()
        self.atomic: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        self.names.add(name)
        at = ACCUMULATE_AT.get(name)
        accumulates = at is not None and bool(
            args[at] if len(args) > at else kwargs.get("accumulate", False))
        if (name in ATOMIC_OPS or accumulates
                or name in ("scatter", "scatter_") and "reduce" in kwargs
                or name == "bincount" and (len(args) > 1 and args[1] is not None
                                           or kwargs.get("weights") is not None)):
            self.atomic.append(str(func))
        return func(*args, **kwargs)


def _instance(pkg, size: str, speeds: float = 1.0):
    n_t, n_k, lo, hi, seed = SIZES[size]
    rng = np.random.default_rng(seed)
    tg = pkg.random_task_graph(rng, n_t, degree_low=lo, degree_high=hi)
    cg = pkg.random_compute_graph(rng, n_k)
    return tg, pkg.ComputeGraph(e=cg.e * speeds, C=cg.C)


def test_dispatch_recorder_names_atomic_ops():
    """The recorder itself: it names an atomic sum and an accumulating
    ``index_put_``, and passes a plain write and a gather."""
    x, i = torch.zeros(4), torch.tensor([0, 2, 2])
    with _AtomicOps() as ops:
        x.index_put_((i,), torch.ones(3))
        x.gather(0, i)
    assert ops.atomic == []
    with _AtomicOps() as ops:
        x.scatter_add(0, i, torch.ones(3))
        x.index_put_((i,), torch.ones(3), accumulate=True)
    assert len(ops.atomic) == 2, ops.atomic


@pytest.mark.parametrize("size", sorted(SIZES))
def test_factored_solve_sums_without_atomics(size):
    """(a) A lone factored solve and a 3-lane factored batch run no op that
    CUDA sums by atomics; the edge sums are segment reductions."""
    opts = SDPOptions(max_iters=50, tol=0.0)
    lone = P.build_factored_bqp(*_instance(P, size))
    lanes = [P.build_factored_bqp(*_instance(P, size, s)) for s in (1.0, 0.8, 1.3)]
    with _AtomicOps() as ops:
        sol = P.solve_sdp(lone, opts, device="cpu")
        batch = P.solve_sdp_batch(lanes, opts, device="cpu")
    assert ops.atomic == [], sorted(set(ops.atomic))
    assert "segment_reduce" in ops.names
    assert sol.stats["constraint_kind"] == "factored" and sol.stats["eig_partial"] > 0
    assert all(b.stats["constraint_kind"] == "factored" and b.stats["batch"] == 3
               for b in batch)


def _f64(a):
    a = np.asarray(a)
    return torch.as_tensor(a, dtype=torch.int64 if a.dtype.kind in "iu" else torch.float64)


@pytest.mark.parametrize("size", sorted(SIZES))
def test_factored_operator_is_the_csr_operator(size):
    """(b) In float64, the factored closures of 3 lanes at once equal each
    lane's dense ("csr") operator to 1e-10, and Aᵀ is the adjoint of A."""
    speeds = (1.0, 0.8, 1.3)
    fbs = [P.build_factored_bqp(*_instance(P, size, s)) for s in speeds]
    n1, n_t, n_k = fbs[0].n + 1, fbs[0].n_tasks, fbs[0].n_machines
    projs = [psdp._AffineProjector(fb) for fb in fbs]
    dim, m = projs[0].dim, projs[0].m
    factored = tuple(torch.stack([_f64(getattr(fb, a)) for fb in fbs])
                     for a in ("p", "d", "C", "src", "dst", "q_scale"))
    matvec, rmatvec, b = psdp._make_device_ops("factored", factored, n1, dim, n_t, n_k)

    rng = np.random.default_rng(0)
    v = torch.as_tensor(rng.standard_normal((3, dim)))
    y = torch.as_tensor(rng.standard_normal((3, m)))
    Av, Aty = matvec(v), rmatvec(y)
    assert Av.dtype == Aty.dtype == torch.float64
    for i, fb in enumerate(fbs):
        dense = P.build_bqp(*_instance(P, size, speeds[i]))
        rows, cols, vals, b_csr = psdp._AffineProjector(dense).export_csr()
        c_mv, c_rmv, c_b = psdp._make_device_ops(
            "csr", tuple(_f64(a)[None] for a in (vals, rows, cols, b_csr)), n1, dim, 0, 0)
        want_v, want_y = c_mv(v[i: i + 1])[0], c_rmv(y[i: i + 1])[0]
        scale_v, scale_y = float(want_v.abs().max()), float(want_y.abs().max())
        assert float((Av[i] - want_v).abs().max()) <= F64_TOL * scale_v
        assert float((Aty[i] - want_y).abs().max()) <= F64_TOL * scale_y
        assert torch.equal(b[i], c_b[0].to(b.dtype))
    lhs = torch.sum(Av * y, dim=1)
    rhs = torch.sum(v * Aty, dim=1)
    assert torch.all((lhs - rhs).abs() <= F64_TOL * (lhs.abs() + rhs.abs())), (lhs, rhs)


def test_factored_solve_still_matches_repro():
    """(c) At 20 × 4 the factored solve matches ``repro``'s jax solve:
    equal iteration and projection counts, Y, t and residual within 1e-3."""
    tg, cg = _instance(R, "20x4")
    sj = R.solve_sdp(R.build_factored_bqp(tg, cg), ROptions(backend="jax", **FIXED))
    sp = P.solve_sdp(P.build_factored_bqp(*_instance(P, "20x4")), SDPOptions(**FIXED),
                     device="cpu")
    assert sj.stats["constraint_kind"] == sp.stats["constraint_kind"] == "factored"
    assert sp.stats["eig_partial"] > 0
    assert sp.iterations == sj.iterations
    assert sp.stats["eig_full"] == sj.stats["eig_full"]
    assert sp.stats["eig_partial"] == sj.stats["eig_partial"]
    np.testing.assert_allclose(sp.Y, sj.Y, atol=F32_ATOL)
    assert np.isclose(sp.t, sj.t, atol=F32_ATOL)
    assert np.isclose(sp.residual, sj.residual, atol=F32_ATOL)
