"""RLModule — the neural-network abstraction of the new API stack: the
port of ``ray_tpu/rllib/rl_module.py``.

Reference parity: rllib/core/rl_module/rl_module.py:260 (RLModule with
forward_inference / forward_exploration / forward_train) and
RLModuleSpec (:65 — build() from observation/action spaces + model
config). As in the JAX package the module is functional: params are a
tree of tensors created by `init`, every forward is a function of
(params, batch), and weight sync is a tree copy.

Exploration samples with a `torch.Generator` on the module's device
(`models.categorical`), where the JAX package draws with
``jax.random.categorical``: sampled actions differ from JAX's, while
greedy actions and every logit, log-prob and value given the same
params agree.
"""

from __future__ import annotations

import abc
import dataclasses

import numpy as np
import torch

from ray_tpu_torch.rllib import catalog, models
from ray_tpu_torch.util.device import resolve_device


class RLModule(abc.ABC):
    """Functional policy/value module. Subclasses define the param tree
    (`init`) and the three forward passes; defaults derive inference
    (greedy) and exploration (sampled) from `forward_train`'s action
    logits."""

    @abc.abstractmethod
    def init(self, gen: torch.Generator) -> dict:
        """Create the parameter tree, drawing from `gen` on its device."""

    @abc.abstractmethod
    def forward_train(self, params: dict, batch: dict) -> dict:
        """Training forward: returns at least {"action_dist_inputs",
        "vf_preds"} (reference: forward_train output keys)."""

    def forward_inference(self, params: dict, batch: dict) -> dict:
        """Greedy action selection (reference: forward_inference —
        deterministic, used for evaluation/serving)."""
        out = self.forward_train(params, batch)
        out["actions"] = torch.argmax(out["action_dist_inputs"], dim=-1)
        return out

    def forward_exploration(self, params: dict, batch: dict,
                            gen: torch.Generator) -> dict:
        """Stochastic action selection (reference: forward_exploration —
        used by env runners while sampling)."""
        out = self.forward_train(params, batch)
        logits = out["action_dist_inputs"]
        actions = models.categorical(logits, gen)
        logp = torch.log_softmax(logits, dim=-1).gather(
            1, actions[:, None])[:, 0]
        out["actions"] = actions
        out["action_logp"] = logp
        return out

    # -- flat helpers for the env-runner hot loop -------------------------

    def explore(self, params, obs, gen):
        """(action, logp, value) triple — the env runner's sampling
        signature."""
        out = self.forward_exploration(params, {"obs": obs}, gen)
        return out["actions"], out["action_logp"], out["vf_preds"]

    def infer(self, params, obs):
        out = self.forward_inference(params, {"obs": obs})
        return out["actions"]


class DefaultActorCriticModule(RLModule):
    """Catalog-backed discrete actor-critic: conv encoder for image
    spaces, MLP towers for vectors (reference: DefaultPPORLModule +
    catalog.py:33 encoder selection). A conv module keeps its filters'
    static strides (`strides`) beside the params. Its params live on
    `device`: the card unless the caller passes another."""

    def __init__(self, obs_spec, n_actions: int,
                 model_config: dict | None = None, device=None):
        self.obs_spec = obs_spec
        self.n_actions = int(n_actions)
        self.model_config = dict(model_config or {})
        self.model_config.setdefault("hidden", (64, 64))
        self.device = resolve_device(device)
        self.strides = ()
        if self._image:
            self.strides = catalog.conv_strides(catalog.Catalog.filters(
                self.obs_spec, self.model_config))

    @property
    def _image(self) -> bool:
        return isinstance(self.obs_spec, tuple) and len(self.obs_spec) == 3

    def init(self, gen: torch.Generator) -> dict:
        if self._image:
            return models.init_actor_critic(
                gen, self.obs_spec, self.n_actions, self.model_config,
                device=self.device)
        return models.init_mlp_policy(
            gen, int(np.prod(self.obs_spec)), self.n_actions,
            tuple(self.model_config["hidden"]), device=self.device)

    def forward_train(self, params: dict, batch: dict) -> dict:
        logits, value = models.forward(params, batch["obs"], self.strides)
        return {"action_dist_inputs": logits, "vf_preds": value}


@dataclasses.dataclass
class RLModuleSpec:
    """Build recipe (reference: RLModuleSpec — module class + spaces +
    model config, resolved inside learners and env runners so both
    construct identical modules from plain data)."""

    module_class: type = DefaultActorCriticModule
    obs_spec: tuple | int = 4
    n_actions: int = 2
    model_config: dict | None = None

    def build(self, device=None) -> RLModule:
        return self.module_class(self.obs_spec, self.n_actions,
                                 self.model_config, device=device)
