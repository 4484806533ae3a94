"""APPO — asynchronous PPO (IMPALA architecture + clipped surrogate): the
port of ``ray_tpu/rllib/appo.py``.

Reference parity: rllib/algorithms/appo/appo.py (APPOConfig: IMPALA's
async sampling/learner pipeline with the PPO clipped-ratio loss,
optional KL penalty against a periodically-updated TARGET network —
appo.py:36 docstring, target_network_update_freq, use_kl_loss). Built on
the port's IMPALA driver: the same env-runner/queue/learner-thread
plumbing, the learner's step swapped for the APPO loss. The target is a
copy of the params, taken on the learner thread every
`target_update_freq` steps.
"""

from __future__ import annotations

import dataclasses

import torch

from ray_tpu_torch.rllib import models
from ray_tpu_torch.rllib.impala import (
    IMPALA,
    IMPALAConfig,
    entropy_of,
    logp_of,
    masked_mean,
)
from ray_tpu_torch.util import tree


@dataclasses.dataclass
class APPOConfig(IMPALAConfig):
    clip_param: float = 0.2
    use_kl_loss: bool = False
    kl_coeff: float = 0.2
    target_update_freq: int = 20  # learner steps between target syncs
    lr: float = 3e-4

    def build(self) -> "APPO":
        return APPO(self)


def _copy(params):
    return tree.tree_map(lambda t: t.detach().clone(), params)


class APPO(IMPALA):
    def __init__(self, config: APPOConfig):
        super().__init__(config)
        self.target_params = _copy(self.params)
        self._appo_updates = 0
        self._target_syncs = 0

    def _loss(self, batch: dict) -> torch.Tensor:
        cfg = self.config
        logits, value = models.forward(self.params, batch["obs"])
        logp_all, logp = logp_of(logits, batch["actions"])
        # clipped surrogate against the BEHAVIOR policy's logp (the
        # sample is off-policy; V-trace already corrected the targets)
        ratio = torch.exp(logp - batch["logp_old"])
        adv = batch["advantages"]
        surr = torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - cfg.clip_param, 1 + cfg.clip_param) * adv)
        m = batch["mask"]  # autoreset steps carry no loss
        pg = -masked_mean(m, surr)
        vf = masked_mean(m, (value - batch["vs"]) ** 2)
        ent = masked_mean(m, entropy_of(logp_all))
        total = pg + cfg.vf_loss_coeff * vf - cfg.entropy_coeff * ent
        if cfg.use_kl_loss:
            with torch.no_grad():
                t_logits, _ = models.forward(self.target_params,
                                             batch["obs"])
                t_logp_all = torch.log_softmax(t_logits, dim=-1)
            kl = masked_mean(m, torch.sum(
                torch.exp(t_logp_all) * (t_logp_all - logp_all), dim=-1))
            total = total + cfg.kl_coeff * kl
        return total

    def _update(self, batch: dict) -> torch.Tensor:
        """The APPO step, then the target copy every
        `target_update_freq` steps (the learner thread calls this)."""
        loss = self._apply(self._loss(batch))
        self._appo_updates += 1
        if self._appo_updates % self.config.target_update_freq == 0:
            self.target_params = _copy(self.params)
            self._target_syncs += 1
        return loss
