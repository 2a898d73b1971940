"""The loss, gradients and train step of the mixture-of-experts, Mamba-2
and VLM families on the CPU against ``repro``.

``repro``'s parameters and inputs reach the port as in
``tests/test_torch_families.py`` (its helpers), at the smoke configs of
mixtral-8x7b, olmoe-1b-7b, mamba2-1.3b and qwen2-vl-72b:

  - ``loss_fn`` with the mixture-of-experts auxiliary term (checked to be
    in the loss) and the gradient of every parameter, with and without
    ``remat``; qwen2-vl from ``inputs_embeds`` and (3, B, S) positions, its
    embedding table without a gradient on either side;
  - one ``make_train_step`` step (AdamW) against ``repro``'s for mixtral
    (4 microbatches, its config's ``train_microbatches``), olmoe and
    mamba2; ``launch/train.py`` refuses qwen2-vl, as ``repro``'s does, and
    trains mixtral, olmoe, mamba2 and recurrentgemma (``--smoke --device
    cpu --steps 3``: a finite loss at step 3).

Tolerances: the loss to 1e-5 relative and each gradient leaf to 1e-4
relative Frobenius (the expert and scan sums run in other orders; the
router's gradient is the smallest leaf); the train step's loss to 1e-5
relative, gradient norm 1e-4, parameters within 5e-4 at lr 1e-3
(``tests/test_torch_train.py``'s bounds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as repro_build_model
from repro.train import optim as repro_optim
from repro.train.trainer import init_train_state as repro_init_train_state
from repro.train.trainer import make_train_step as repro_make_train_step
from repro_torch.convert import _lm_leaf, train_state_from_numpy
from repro_torch.data import LMStream
from repro_torch.launch import train as train_launcher
from repro_torch.models import build_model
from repro_torch.models import transformer as tf
from repro_torch.models.common import softmax_cross_entropy
from repro_torch.train.optim import AdamW
from repro_torch.train.trainer import make_train_step
from test_torch_families import ARCHS, _batch, _both, _configs, _params

GRAD_REL = 1e-4


def _rel(got, want) -> float:
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("arch,remat", [(a, False) for a in ARCHS] +
                         [("olmoe-1b-7b", True), ("mamba2-1.3b", True)])
def test_lm_loss_and_grads_match_repro(arch, remat):
    rcfg, pcfg = _configs(arch, remat=remat)
    rapi, rparams, tree, api, params = _params(rcfg, pcfg, seed=3)
    batch = _batch(rcfg, 2, 64, 6)
    labels = np.random.default_rng(7).integers(0, rcfg.vocab_size, (2, 64)).astype(np.int32)
    labels[1, -5:] = -1                                  # ignored labels at the end
    batch["labels"] = labels
    rb, pb = _both(batch)
    loss, grads = jax.jit(jax.value_and_grad(rapi.loss_fn))(rparams, rb)
    grads = jax.tree.map(np.asarray, grads)
    tensors = {n: p.detach().clone().requires_grad_() for n, p in params.named_parameters()}
    got = api.loss_fn(tf.bind(params, tensors), pb)
    got.backward()
    got = got.detach()
    assert abs(float(got) - float(loss)) <= 1e-5 * float(loss), (float(got), float(loss))
    for name, t in tensors.items():
        # qwen2-vl reads inputs_embeds: its embedding table gets no gradient
        err = _rel(torch.zeros_like(t) if t.grad is None else t.grad, _lm_leaf(grads, name))
        assert err <= GRAD_REL, (name, err)
    if pcfg.num_experts:          # the auxiliary term is in the loss
        ce = softmax_cross_entropy(api.forward(params, pb), pb["labels"])
        aux = (float(got) - float(ce)) / tf.AUX_LOSS_COEF
        assert pcfg.num_layers * 0.9 <= aux <= pcfg.num_layers * pcfg.num_experts, aux


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "olmoe-1b-7b", "mamba2-1.3b"])
def test_train_step_matches_repro(arch):
    rcfg, pcfg = _configs(arch, vocab_size=64)
    kw = dict(weight_decay=0.01, grad_clip=1.0)
    ropt = repro_optim.AdamW(learning_rate=1e-3, **kw)
    rapi = repro_build_model(rcfg)
    rstate = repro_init_train_state(rapi, ropt, jax.random.PRNGKey(1))
    port = train_state_from_numpy(jax.tree.map(np.asarray, rstate), pcfg, "cpu")
    rstep = jax.jit(repro_make_train_step(rapi, ropt))
    pstep = make_train_step(build_model(pcfg), AdamW(learning_rate=1e-3, **kw))
    # mixtral's config splits a batch into 4 microbatches (train_microbatches)
    batch = LMStream(vocab_size=64, seq_len=32, global_batch=4, seed=1).batch(0)
    rstate, rm = rstep(rstate, {k: jnp.asarray(v) for k, v in batch.items()})
    port, pm = pstep(port, batch)
    assert abs(float(pm["loss"]) - float(rm["loss"])) <= 1e-5 * float(rm["loss"])
    assert abs(float(pm["grad_norm"]) - float(rm["grad_norm"])) <= 1e-4 * float(rm["grad_norm"])
    assert int(pm["step"]) == int(rm["step"]) == 1
    want = jax.tree.map(np.asarray, rstate["params"])
    for name, p in port["params"].named_parameters():
        assert np.max(np.abs(p.detach().numpy() - _lm_leaf(want, name))) <= 5e-4, name


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "olmoe-1b-7b", "mamba2-1.3b",
                                  "recurrentgemma-9b"])
def test_train_launcher_trains_the_family_on_cpu(arch):
    out = train_launcher.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "3"])
    assert out["step"] == 3
    assert np.isfinite(out["loss"]) and np.isfinite(out["grad_norm"]) and out["grad_norm"] > 0


def test_train_launcher_refuses_a_vlm():
    with pytest.raises(SystemExit, match="frontend stub"):
        train_launcher.main(["--arch", "qwen2-vl-72b", "--smoke", "--device", "cpu",
                             "--steps", "1"])


