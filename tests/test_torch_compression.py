"""The compressors' wire form (``TopK`` / ``Int8`` ``compress`` and
``decompress``) against ``repro``'s on the same numpy inputs, on the CPU.

  - TopK: the kept indices equal ``repro``'s as sets, the kept values and
    the residual bit-equal;
  - Int8: the scales bit-equal; each int8 code equal, or one step apart only
    where x/scale lies within float32 error of a half-integer (XLA may
    evaluate the quotient differently); the residual bit-equal at every
    other element;
  - in the port, ``decompress ∘ compress`` equals ``roundtrip`` bit for bit,
    and the residual is x − decompress(compress(x)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train.compression import Int8 as JInt8
from repro.train.compression import TopK as JTopK
from repro_torch.train.compression import Int8, TopK
from repro_torch.train.tree import leaves


def _tree(seed, scale=1.0):
    """A CNN-like tree of leaves with ties unlikely: a conv kernel, a bias,
    a dense matrix and a one-entry leaf."""
    rng = np.random.default_rng(seed)
    return {
        "conv": {"w": (rng.standard_normal((5, 5, 3, 8)) * scale).astype(np.float32),
                 "b": (rng.standard_normal(8) * 0.1 * scale).astype(np.float32)},
        "fc": {"w": (rng.standard_normal((64, 10)) * scale).astype(np.float32),
               "b": np.array([0.25 * scale], np.float32)},
    }


def _torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


@pytest.mark.parametrize("fraction", [0.01, 0.05, 0.5])
@pytest.mark.parametrize("seed", [0, 1])
def test_topk_wire_form_matches_repro(fraction, seed):
    x = _tree(seed)
    jcomp, jres = JTopK(fraction).compress(jax.tree.map(jnp.asarray, x))
    comp, res = TopK(fraction).compress(_torch(x))
    jl = jax.tree_util.tree_leaves(jcomp, is_leaf=lambda c: isinstance(c, tuple))
    for (jidx, jkept, jshape), (idx, kept, shape) in zip(jl, leaves(comp)):
        assert shape == tuple(jshape) and idx.dtype == torch.int64
        assert set(idx.tolist()) == set(np.asarray(jidx).tolist())
        order, jorder = np.argsort(idx.numpy()), np.argsort(np.asarray(jidx))
        np.testing.assert_array_equal(kept.numpy()[order], np.asarray(jkept)[jorder])
    for got, want in zip(leaves(res), jax.tree.leaves(jres)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(leaves(TopK(fraction).decompress(comp)),
                         jax.tree.leaves(JTopK(fraction).decompress(jcomp))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("scale", [1.0, 3e-4, 250.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_int8_wire_form_matches_repro(scale, seed):
    x = _tree(seed, scale)
    jcomp, jres = JInt8().compress(jax.tree.map(jnp.asarray, x))
    comp, res = Int8().compress(_torch(x))
    jl = jax.tree_util.tree_leaves(jcomp, is_leaf=lambda c: isinstance(c, tuple))
    for leaf, (jq, js), (q, s), r, jr in zip(jax.tree.leaves(x), jl, leaves(comp),
                                            leaves(res), jax.tree.leaves(jres)):
        assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.dim() == 0
        assert float(s) == float(js)                          # bit-equal scales
        diff = q.numpy().astype(np.int32) - np.asarray(jq).astype(np.int32)
        off = diff != 0
        assert np.all(np.abs(diff) <= 1)
        ratio = leaf.astype(np.float64) / np.float64(float(s))
        frac = np.abs(ratio - np.floor(ratio) - 0.5)        # 0 at a half-integer
        near = 4 * np.finfo(np.float32).eps * np.maximum(1, np.abs(ratio))
        assert np.all(frac[off] <= near[off])
        np.testing.assert_array_equal(r.numpy()[~off], np.asarray(jr)[~off])


@pytest.mark.parametrize("comp", [TopK(0.05), TopK(0.5), Int8()], ids=["topk0.05", "topk0.5",
                                                                        "int8"])
def test_decompress_of_compress_is_roundtrip(comp):
    x = _torch(_tree(3))
    wire, res = comp.compress(x)
    for dense, rt, r, leaf in zip(leaves(comp.decompress(wire)), leaves(comp.roundtrip(x)),
                                  leaves(res), leaves(x)):
        assert torch.equal(dense, rt)
        assert torch.equal(r, leaf - dense)
