"""The paper's CNN (§4.2): two conv layers and three fully connected layers,
for every user at once (counterpart of ``repro.fl.cnn``).

Parameters keep ``repro``'s layouts: conv weights HWIO ``(3, 3, C_in,
C_out)``, fully connected weights ``(in, out)``, images NHWC.  The stacked
forward takes every leaf with a leading user axis ``(N_T, …)`` and images
``(N_T, B, H, W, C)``:

  - both convolutions run as one ``F.conv2d(groups=N_T)`` over the users'
    channels side by side;
  - the fully connected layers are batched products ``(N_T, B, in) @
    (N_T, in, out)``;
  - ``fc1`` flattens the pooled activations in NHWC order, as ``repro``
    does (an NCHW flatten would train too, but compute another function).

``StackedCNN`` holds all users' parameters as one flat ``(N_T, L)``
parameter whose per-leaf tensors are views of it (``train.tree.ParamLayout``),
so its ``.grad`` is every user's gradient in one buffer.  ``cnn_forward``,
``cnn_loss`` and ``cnn_accuracy`` are the single-user functions of
``repro``, run as a population of one.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.train.tree import ParamLayout, tree_map


def init_cnn_params(generator: torch.Generator, input_shape=(28, 28, 1),
                    num_classes: int = 10) -> dict:
    """He-normal weights and zero biases on the CPU, from ``generator``.

    The shapes and scales are ``repro``'s; the numbers are not (``repro``
    draws from JAX's PRNG): a parity test hands ``repro``'s initial
    parameters over instead.
    """
    h, w, c = input_shape

    def normal(shape, fan_in):
        return torch.randn(shape, generator=generator) * float(np.sqrt(2.0 / fan_in))

    flat = (h // 4) * (w // 4) * 64
    return {
        "conv1": {"w": normal((3, 3, c, 32), 9 * c), "b": torch.zeros(32)},
        "conv2": {"w": normal((3, 3, 32, 64), 9 * 32), "b": torch.zeros(64)},
        "fc1": {"w": normal((flat, 128), flat), "b": torch.zeros(128)},
        "fc2": {"w": normal((128, 64), 128), "b": torch.zeros(64)},
        "fc3": {"w": normal((64, num_classes), 64), "b": torch.zeros(num_classes)},
    }


def _conv_relu_pool(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x (B, N·C_in, H, W), w (N, 3, 3, C_in, C_out) HWIO, b (N, C_out)."""
    n, kh, kw, cin, cout = w.shape
    wt = w.permute(0, 4, 3, 1, 2).reshape(n * cout, cin, kh, kw)
    y = F.conv2d(x, wt, padding=kh // 2, groups=n) + b.reshape(1, n * cout, 1, 1)
    return F.max_pool2d(F.relu(y), 2)          # "SAME" 3×3 conv, 2×2 "VALID" pool


def stacked_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """params with leading (N,), x (N, B, H, W, C) -> (N, B, num_classes) logits."""
    n, b, h, w, c = x.shape
    z = (x - 0.5).permute(1, 0, 4, 2, 3).reshape(b, n * c, h, w)
    z = _conv_relu_pool(z, params["conv1"]["w"], params["conv1"]["b"])
    z = _conv_relu_pool(z, params["conv2"]["w"], params["conv2"]["b"])
    cout, h4, w4 = z.shape[1] // n, z.shape[2], z.shape[3]
    z = z.reshape(b, n, cout, h4, w4).permute(1, 0, 3, 4, 2).reshape(n, b, h4 * w4 * cout)
    for name in ("fc1", "fc2"):
        z = F.relu(torch.bmm(z, params[name]["w"]) + params[name]["b"][:, None])
    return torch.bmm(z, params["fc3"]["w"]) + params["fc3"]["b"][:, None]


def stacked_loss(params: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Each user's mean cross-entropy over its batch: (N,)."""
    logits = stacked_forward(params, x)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y[..., None].long())[..., 0]
    return torch.mean(logz - gold, dim=-1)


class StackedCNN(nn.Module):
    """Every user's CNN as one flat ``(N_T, L)`` float32 parameter."""

    def __init__(self, params: dict, num_users: int, device):
        """``params``: one user's tree (numpy or tensors), copied to every user."""
        super().__init__()
        self.layout = ParamLayout(params)
        row = torch.from_numpy(self.layout.flatten(params)).to(device)
        self.flat = nn.Parameter(row.expand(num_users, -1).contiguous())

    def params(self) -> dict:
        return self.layout.views(self.flat)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return stacked_forward(self.params(), x)

    def losses(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return stacked_loss(self.params(), x, y)


def _one(params: dict) -> dict:
    return tree_map(lambda t: torch.as_tensor(t)[None], params)


def cnn_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """One user: x (B, H, W, C) -> (B, num_classes) logits."""
    return stacked_forward(_one(params), x[None])[0]


def cnn_loss(params: dict, batch: dict) -> torch.Tensor:
    return stacked_loss(_one(params), batch["x"][None], batch["y"][None])[0]


@torch.no_grad()
def cnn_accuracy(params: dict, x: np.ndarray, y: np.ndarray, batch: int = 512) -> float:
    """Share of ``x`` classified as ``y``, on the device of ``params``."""
    one = _one(params)
    dev = one["fc3"]["w"].device
    correct = 0
    for i in range(0, len(y), batch):
        xb = torch.as_tensor(x[i:i + batch], device=dev)
        pred = torch.argmax(stacked_forward(one, xb[None])[0], dim=-1)
        correct += int(torch.sum(pred == torch.as_tensor(y[i:i + batch], device=dev).long()))
    return correct / len(y)
