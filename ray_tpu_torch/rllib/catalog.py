"""Catalog — obs-space-driven encoder construction: the port of
``ray_tpu/rllib/catalog.py``.

Reference parity: rllib/core/models/catalog.py:33 (Catalog decides the
encoder family from the observation space: CNN for image spaces, MLP for
vectors) and the default Atari conv stack from models/utils.py. The
encoder is a pair of plain functions over a param tree:

- conv params are ``{"conv": [{"w", "b"}, ...], "proj": {"w", "b"}}``
  with each conv weight in ``F.conv2d``'s OIHW layout (the JAX package
  keeps HWIO); observations stay NHWC, as in the JAX package, and are
  turned to NCHW for the convolutions and back before the flatten, so
  the projection reads the map in (h, w, c) order and its weights carry
  over from the JAX package unchanged;
- the strides are static: they come from the filter spec and are passed
  beside the tree (`conv_strides`), never stored as a leaf the
  optimizer would update (the JAX package keeps them as static pytree
  metadata of its ``ConvLayer``);
- padding is XLA's ``"SAME"``: ``max((ceil(in/s) - 1)·s + k - in, 0)``
  in all, ``total // 2`` before and the rest after, which ``F.pad``
  applies (torch's ``padding="same"`` refuses a stride above 1, and an
  even split is wrong whenever the total is odd).

``F.conv2d`` may run cuDNN on the card, as XLA runs these convolutions
outside any Pallas kernel. cuDNN's fastest weight-gradient algorithms
sum with atomics, so a seeded run would not repeat on the card; the
learners run their updates under `deterministic_convs`, which holds
cuDNN to its deterministic algorithms (JAX on its device is
deterministic without a flag).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

# (out_channels, kernel, stride)
ATARI_FILTERS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))
SMALL_FILTERS = ((16, 3, 2), (32, 3, 2))


@contextlib.contextmanager
def deterministic_convs():
    """Hold cuDNN to deterministic convolution algorithms (forward and
    both backward passes) for the body, then restore the setting. The
    flag is read when a convolution runs, so the body must hold the
    backward as well as the forward."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def conv_filters_for(obs_shape) -> tuple:
    """Default filter spec by input resolution (reference:
    catalog._get_encoder_config image branch)."""
    h = obs_shape[0]
    return ATARI_FILTERS if h >= 64 else SMALL_FILTERS


def conv_strides(filters) -> tuple[int, ...]:
    """The static strides of a filter spec, one per conv layer."""
    return tuple(int(s) for (_, _, s) in filters)


def same_padding(size: int, k: int, s: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: (before, after)."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _normal(gen, shape, scale, device):
    return torch.randn(shape, generator=gen, device=device) * scale


def init_conv_encoder(gen, obs_shape, filters=None, out_dim: int = 256,
                      device=None):
    """Params for conv stack + dense projection. obs NHWC float32."""
    filters = filters or conv_filters_for(obs_shape)
    h, w, c = obs_shape
    params = {"conv": [], "proj": None}
    for (oc, k, s) in filters:
        fan_in = k * k * c
        params["conv"].append({
            "w": _normal(gen, (oc, c, k, k), np.sqrt(2.0 / fan_in), device),
            "b": torch.zeros(oc, device=device),
        })
        h = -(-h // s)
        w = -(-w // s)
        c = oc
    flat = h * w * c
    params["proj"] = {
        "w": _normal(gen, (flat, out_dim), np.sqrt(2.0 / flat), device),
        "b": torch.zeros(out_dim, device=device),
    }
    return params, out_dim


def apply_conv_encoder(params, obs, strides):
    """obs (B, H, W, C) float32 -> features (B, out_dim)."""
    x = obs.permute(0, 3, 1, 2)
    for lyr, s in zip(params["conv"], strides, strict=True):
        k = lyr["w"].shape[-1]
        top, bottom = same_padding(x.shape[2], k, s)
        left, right = same_padding(x.shape[3], k, s)
        x = F.conv2d(F.pad(x, (left, right, top, bottom)), lyr["w"],
                     lyr["b"], stride=s)
        x = torch.relu(x)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    p = params["proj"]
    return torch.relu(x @ p["w"] + p["b"])


def init_mlp_encoder(gen, in_dim: int, hidden=(64, 64), device=None):
    sizes = (in_dim, *hidden)
    layers = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        layers.append({
            "w": _normal(gen, (fan_in, fan_out), np.sqrt(2.0 / fan_in),
                         device),
            "b": torch.zeros(fan_out, device=device),
        })
    return {"mlp": layers}, (hidden[-1] if hidden else in_dim)


def apply_mlp_encoder(params, obs):
    x = obs
    for lyr in params["mlp"]:
        x = torch.tanh(x @ lyr["w"] + lyr["b"])
    return x


def init_head(gen, in_dim: int, out_dim: int, scale: float = 0.01,
              device=None):
    return {"w": _normal(gen, (in_dim, out_dim), scale, device),
            "b": torch.zeros(out_dim, device=device)}


def apply_head(params, x):
    return x @ params["w"] + params["b"]


class Catalog:
    """Encoder/head factory keyed on the observation shape (reference:
    Catalog.build_encoder, core/models/catalog.py:33)."""

    @staticmethod
    def is_image(obs_shape) -> bool:
        return len(obs_shape) == 3

    @staticmethod
    def filters(obs_shape, model_config=None) -> tuple:
        """The conv filter spec an image encoder is built from."""
        mc = model_config or {}
        return tuple(mc.get("conv_filters") or conv_filters_for(obs_shape))

    @staticmethod
    def build_encoder(gen, obs_shape, model_config=None, device=None):
        """Returns (params, apply_fn, feature_dim); a conv encoder's
        apply_fn takes the strides of `Catalog.filters` as well."""
        mc = model_config or {}
        if Catalog.is_image(obs_shape):
            params, dim = init_conv_encoder(
                gen, obs_shape, filters=Catalog.filters(obs_shape, mc),
                out_dim=mc.get("conv_out", 256), device=device)
            return params, apply_conv_encoder, dim
        in_dim = int(np.prod(obs_shape))
        params, dim = init_mlp_encoder(
            gen, in_dim, hidden=mc.get("hidden", (64, 64)), device=device)
        return params, apply_mlp_encoder, dim
