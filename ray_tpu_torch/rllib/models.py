"""Policy/value networks as plain functions over param trees: the port
of ``ray_tpu/rllib/models.py``.

Reference parity: RLModule (rllib/core/rl_module/rl_module.py:260 —
forward_inference/_exploration/_train) + the default MLP catalog
(rllib/core/models/catalog.py). Params are a tree of tensors and
`forward` is a plain function of (params, obs), so the learner's update
and the env runner's sampling run the same code. Initialisation draws
from a `torch.Generator` on the params' device; it cannot reproduce
``jax.random``'s draws, so tests carry JAX weights across with
``interop.rl_params_from_jax``.
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.rllib import catalog as C


def init_mlp_policy(gen, obs_dim: int, n_actions: int, hidden=(64, 64),
                    device=None) -> dict:
    """Separate policy and value MLP towers (reference default for
    PPO-style actor-critic with vf_share_layers=False)."""

    def tower(sizes):
        params = []
        for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
            scale = np.sqrt(2.0 / fan_in) if i < len(sizes) - 2 else 0.01
            params.append({
                "w": torch.randn((fan_in, fan_out), generator=gen,
                                 device=device) * scale,
                "b": torch.zeros(fan_out, device=device),
            })
        return params

    return {
        "pi": tower((obs_dim, *hidden, n_actions)),
        "vf": tower((obs_dim, *hidden, 1)),
    }


def _mlp(layers, x):
    for i, lyr in enumerate(layers):
        x = x @ lyr["w"] + lyr["b"]
        if i < len(layers) - 1:
            x = torch.tanh(x)
    return x


def init_actor_critic(gen, obs_shape, n_actions: int,
                      model_config: dict | None = None,
                      device=None) -> dict:
    """Catalog-built actor-critic: a shared encoder (conv for image
    spaces, MLP for vectors — reference: catalog.py:33 encoder choice +
    the shared-trunk Atari default) with small policy/value heads."""
    enc_params, _, dim = C.Catalog.build_encoder(
        gen, tuple(obs_shape), model_config, device=device)
    return {
        "encoder": enc_params,
        "pi_head": C.init_head(gen, dim, n_actions, device=device),
        "vf_head": C.init_head(gen, dim, 1, scale=1.0, device=device),
    }


def forward(params: dict, obs: torch.Tensor, strides=()
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """obs (B, *obs_shape) -> (logits (B, A), value (B,)). Dispatches on
    the param-tree structure: catalog actor-critic (shared encoder) or
    the separate MLP towers. `strides` are a conv encoder's
    (``catalog.conv_strides`` of its filters)."""
    if "encoder" in params:
        enc = params["encoder"]
        feats = (C.apply_conv_encoder(enc, obs, strides) if "conv" in enc
                 else C.apply_mlp_encoder(enc, obs))
        logits = C.apply_head(params["pi_head"], feats)
        value = C.apply_head(params["vf_head"], feats)[..., 0]
        return logits, value
    logits = _mlp(params["pi"], obs)
    value = _mlp(params["vf"], obs)[..., 0]
    return logits, value


def categorical(logits: torch.Tensor, gen) -> torch.Tensor:
    """One draw per row of the categorical over `logits`, by the
    Gumbel-max trick (as ``jax.random.categorical``), from `gen` on the
    logits' device: no host sync. The draws differ from JAX's."""
    tiny = torch.finfo(logits.dtype).tiny
    u = torch.rand(logits.shape, generator=gen, device=logits.device,
                   dtype=logits.dtype).clamp_(min=tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def sample_actions(params: dict, obs: torch.Tensor, gen,
                   strides=()) -> tuple:
    """forward_exploration: sample from the categorical head."""
    logits, value = forward(params, obs, strides)
    action = categorical(logits, gen)
    logp = torch.log_softmax(logits, dim=-1).gather(
        -1, action[:, None])[:, 0]
    return action, logp, value
