"""DreamerV3 — model-based RL: world model + actor-critic in imagination.
The port of ``ray_tpu/rllib/dreamerv3.py``.

Reference parity: rllib/algorithms/dreamerv3/dreamerv3.py:1 (config:
model_size presets + training_ratio), dreamerv3_rl_module.py (world
model = RSSM with discrete categorical latents, reward/continue heads,
symlog/twohot targets; actor/critic heads), dreamerv3_learner.py (the
three losses: world-model prediction + KL-balanced dynamics/
representation, critic twohot + EMA regularizer, actor REINFORCE with
percentile return normalization).

The JAX package runs the whole update as one jitted program whose RSSM
and imagination scans are ``lax.scan``s. Here each scan is a Python
loop over T or H with its carry explicit, on the algorithm's device
(the card unless the config says ``device="cpu"``). Two steps that do
not depend on the carry leave their loop and run batched: the encoder
over all B x T observations, and the prior head over all posterior
states. The three optimizers write the params in place, so every
gradient of an update is taken before the first step is applied, as the
JAX update computes all three from the same params.

Categorical draws (`latent`, the imagined and the acted actions) are
``argmax(logits + gumbel)``, which is ``jax.random.categorical``; the
Gumbel noise comes from the algorithm's `torch.Generator`, or from the
caller, so a test can pass ``jax.random.gumbel`` of JAX's own keys.

Observations: vectors (symlog MLP encoder + symlog-MSE decoder) and
images (the catalog's conv encoder over [-0.5, 0.5]-scaled pixels + a
dense pixel decoder); uint8 pixels stay uint8 in replay and are scaled
on the device.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.interop import params_to_numpy
from ray_tpu_torch.rllib import catalog
from ray_tpu_torch.rllib import envs as _envs
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.train.optim import adam
from ray_tpu_torch.util import tree

# ------------------------------------------------------------ symlog/twohot
# Reference: utils/symlog used throughout DreamerV3 (predict in a
# squashed space so one set of hyperparams survives reward scales).


def symlog(x):
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x):
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


NUM_BINS = 63
BINS = torch.linspace(-20.0, 20.0, NUM_BINS)


def _bins(like: torch.Tensor) -> torch.Tensor:
    return BINS.to(like.device)


def twohot(y):
    """Symlog value -> two-hot distribution over the fixed bins."""
    bins = _bins(y)
    y = torch.clamp(symlog(y), bins[0], bins[-1])
    idx = torch.sum((bins <= y[..., None]).to(torch.int64), dim=-1) - 1
    idx = torch.clamp(idx, 0, NUM_BINS - 2)
    lo, hi = bins[idx], bins[idx + 1]
    w_hi = (y - lo) / (hi - lo)
    oh_lo = F.one_hot(idx, NUM_BINS) * (1.0 - w_hi)[..., None]
    oh_hi = F.one_hot(idx + 1, NUM_BINS) * w_hi[..., None]
    return oh_lo + oh_hi


def twohot_mean(logits):
    """Expected symexp'd value of a twohot head."""
    return symexp(torch.sum(torch.softmax(logits, -1) * _bins(logits), -1))


# ------------------------------------------------------------ tiny nn


def _dense_init(gen, sizes, device=None):
    layers = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        layers.append({
            "w": torch.randn((a, b), generator=gen, device=device)
            * np.sqrt(1.0 / a),
            "b": torch.zeros(b, device=device)})
    return layers


def _mlp(layers, x, act=F.silu, out_act=False):
    for i, lyr in enumerate(layers):
        x = x @ lyr["w"] + lyr["b"]
        if i < len(layers) - 1 or out_act:
            x = act(x)
    return x


def _gru_init(gen, in_dim, units, device=None):
    return {"wi": torch.randn((in_dim, 3 * units), generator=gen,
                              device=device) * np.sqrt(1.0 / in_dim),
            "wh": torch.randn((units, 3 * units), generator=gen,
                              device=device) * np.sqrt(1.0 / units),
            "b": torch.zeros(3 * units, device=device)}


def _gru(p, h, x):
    gates = x @ p["wi"] + h @ p["wh"] + p["b"]
    r, z, n = gates.chunk(3, dim=-1)
    r, z = torch.sigmoid(r), torch.sigmoid(z)
    n = torch.tanh(r * n)
    return (1.0 - z) * n + z * h


def gumbel(shape, gen, device) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(u)) of a uniform u in (0, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=gen, device=device).clamp_(min=tiny)
    return -torch.log(-torch.log(u))


def sigmoid_bce(logits, labels):
    """optax.sigmoid_binary_cross_entropy."""
    return -labels * F.logsigmoid(logits) - (1 - labels) * F.logsigmoid(
        -logits)


def _zero_where(first, x):
    return torch.where(first[:, None] != 0, torch.zeros_like(x), x)


# ------------------------------------------------------------ buffer


class EpisodeSequenceBuffer:
    """Sequence replay for world-model training (reference role:
    utils/env_runner + the episode replay buffer DreamerV3 samples
    (B, T) windows from). One contiguous stream per vector env; windows
    are time-contiguous within a stream and `first` flags let the RSSM
    reset latents at episode boundaries inside a window. A copy of the
    JAX package's buffer (numpy, the same draws)."""

    def __init__(self, capacity: int, num_envs: int, seed: int = 0):
        self._cap = max(1, capacity // max(1, num_envs))
        self._streams = [{} for _ in range(num_envs)]
        self._rng = np.random.default_rng(seed)

    def add_step(self, batch: dict):
        """batch: field -> (num_envs, ...) arrays for ONE env step."""
        for i, stream in enumerate(self._streams):
            for k, v in batch.items():
                buf = stream.setdefault(k, [])
                buf.append(np.asarray(v[i]))
                if len(buf) > self._cap:
                    del buf[:len(buf) - self._cap]

    def __len__(self):
        return sum(len(next(iter(s.values()), [])) for s in self._streams)

    def can_sample(self, B: int, T: int) -> bool:
        return any(len(next(iter(s.values()), [])) >= T
                   for s in self._streams)

    def sample_sequences(self, B: int, T: int) -> dict:
        eligible = [i for i, s in enumerate(self._streams)
                    if len(next(iter(s.values()), [])) >= T]
        out: dict[str, list] = {}
        for _ in range(B):
            s = self._streams[self._rng.choice(eligible)]
            n = len(next(iter(s.values())))
            off = int(self._rng.integers(0, n - T + 1))
            for k, buf in s.items():
                out.setdefault(k, []).append(np.stack(buf[off:off + T]))
        return {k: np.stack(v) for k, v in out.items()}  # (B, T, ...)


# ------------------------------------------------------------ config


@dataclasses.dataclass
class DreamerV3Config(AlgorithmConfig):
    """Reference: DreamerV3Config (dreamerv3.py) — the two knobs that
    matter are model_size and training_ratio; rides the shared
    AlgorithmConfig so DreamerV3 runs as a Tune trial."""

    env: str = "CartPole-v1"
    model_size: str = "XS"  # XS | S (test scale; larger follow the table)
    training_ratio: float = 512.0  # replayed steps per env step
    batch_size_B: int = 8
    batch_length_T: int = 16
    horizon_H: int = 15
    gamma: float = 0.997
    gae_lambda: float = 0.95
    lr_world: float = 1e-4
    lr_actor: float = 3e-5
    lr_critic: float = 3e-5
    entropy_scale: float = 3e-4
    free_bits: float = 1.0
    buffer_capacity: int = 100_000
    num_envs: int = 4
    rollout_fragment_length: int = 16

    def dims(self):
        # reference model-size table (dreamerv3.py): deter/units scale
        table = {"XS": (128, 128, 4, 4), "S": (512, 512, 32, 32)}
        deter, units, n_cat, n_cls = table[self.model_size]
        return {"deter": deter, "units": units, "n_cat": n_cat,
                "n_cls": n_cls}

    def build(self) -> "DreamerV3":
        return DreamerV3(self)


# ------------------------------------------------------------ algorithm


class DreamerV3(Algorithm):
    config_class = DreamerV3Config
    STATE_COMPONENTS = ("wm", "actor", "critic", "critic_ema",
                        "_env_steps", "_iteration", "_timesteps_total")

    def setup(self, config: DreamerV3Config):
        if config.evaluation_interval:
            raise ValueError(
                "DreamerV3 has no separate evaluation runner — "
                "episode_return_mean from training IS the "
                "evaluation surface; unset evaluation_interval")
        cfg = config
        d = cfg.dims()
        self.deter, units = d["deter"], d["units"]
        self.n_cat, self.n_cls = d["n_cat"], d["n_cls"]
        self.stoch = stoch = self.n_cat * self.n_cls

        self.envs = _envs.make_vec(cfg.env, cfg.num_envs)
        obs_shape = tuple(self.envs.single_observation_space.shape)
        self._obs_shape = obs_shape
        self._image_obs = catalog.Catalog.is_image(obs_shape)
        self.obs_dim = int(np.prod(obs_shape))
        self.n_actions = int(self.envs.single_action_space.n)
        A, O, dev = self.n_actions, self.obs_dim, self.device

        gen = torch.Generator(device=dev)
        gen.manual_seed(cfg.seed)
        self._strides = ()
        if self._image_obs:
            filters = catalog.conv_filters_for(obs_shape)
            self._strides = catalog.conv_strides(filters)
            encoder, _ = catalog.init_conv_encoder(
                gen, obs_shape, filters, out_dim=units, device=dev)
        else:
            encoder = _dense_init(gen, (O, units, units), dev)
        feat = self.deter + stoch
        # world model (reference: dreamerv3_rl_module.py components)
        self.wm = {
            "encoder": encoder,
            "gru_in": _dense_init(gen, (stoch + A, units), dev),
            "gru": _gru_init(gen, units, self.deter, dev),
            "prior": _dense_init(gen, (self.deter, units, stoch), dev),
            "post": _dense_init(gen, (self.deter + units, units, stoch), dev),
            "decoder": _dense_init(gen, (feat, units, units, O), dev),
            "reward": _dense_init(gen, (feat, units, NUM_BINS), dev),
            "cont": _dense_init(gen, (feat, units, 1), dev),
        }
        self.actor = _dense_init(gen, (feat, units, units, A), dev)
        self.critic = _dense_init(gen, (feat, units, units, NUM_BINS), dev)
        self.critic_ema = tree.tree_map(torch.clone, self.critic)

        self.wm_tx = adam(cfg.lr_world)
        self.actor_tx = adam(cfg.lr_actor)
        self.critic_tx = adam(cfg.lr_critic)
        self.wm_opt = self.wm_tx.init(self.wm)
        self.actor_opt = self.actor_tx.init(self.actor)
        self.critic_opt = self.critic_tx.init(self.critic)

        self.buffer = EpisodeSequenceBuffer(cfg.buffer_capacity,
                                            cfg.num_envs, seed=cfg.seed)
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(cfg.seed + 1)
        self.obs, _ = self.envs.reset(seed=cfg.seed)
        self._h = torch.zeros((cfg.num_envs, self.deter), device=dev)
        self._z = torch.zeros((cfg.num_envs, stoch), device=dev)
        self._prev_done = np.zeros(cfg.num_envs, np.bool_)
        self._ep_returns = np.zeros(cfg.num_envs)
        self._completed: list[float] = []
        self._env_steps = 0
        self._replayed = 0

    # -------------------------------------------------------------- noise

    def _gumbel(self, *shape) -> torch.Tensor:
        return gumbel(shape, self._gen, self.device)

    def _categorical(self, logits, noise=None):
        """One draw per row (``jax.random.categorical``): the argmax of
        logits plus Gumbel noise (drawn when not given)."""
        g = self._gumbel(*logits.shape) if noise is None else noise
        return torch.argmax(logits + g, dim=-1)

    # -------------------------------------------------------------- fns

    def _latent(self, logits, noise=None):
        """Sample the categorical latent with straight-through gradients
        and 1% uniform mixing (reference: 'unimix' in the RSSM); `noise`
        is Gumbel noise of shape (*batch, n_cat, n_cls)."""
        B = logits.shape[:-1]
        lg = logits.reshape(*B, self.n_cat, self.n_cls)
        probs = 0.99 * torch.softmax(lg, -1) + 0.01 / self.n_cls
        logp = torch.log(probs)
        idx = self._categorical(logp, noise)
        oh = F.one_hot(idx, self.n_cls).to(probs.dtype)
        oh = oh + probs - probs.detach()  # straight-through
        return oh.reshape(*B, self.n_cat * self.n_cls), logp

    def _prep(self, obs):
        """Raw obs -> the encoder/decoder target space: pixels scale to
        [-0.5, 0.5] (reference image preprocessing), vectors go through
        symlog."""
        obs = obs.to(torch.float32)
        return obs / 255.0 - 0.5 if self._image_obs else symlog(obs)

    def _encode(self, wm, obs):
        if self._image_obs:
            return catalog.apply_conv_encoder(wm["encoder"], obs,
                                              self._strides)
        return _mlp(wm["encoder"], obs, out_act=True)

    def _img_step(self, wm, h, z, a_onehot, noise=None):
        x = _mlp(wm["gru_in"], torch.cat([z, a_onehot], -1), out_act=True)
        h = _gru(wm["gru"], h, x)
        z, _ = self._latent(_mlp(wm["prior"], h), noise)
        return h, z

    def _kl_cat(self, lhs_logits, rhs_logits):
        """KL between the n_cat categorical factors, summed."""
        n_cat, n_cls = self.n_cat, self.n_cls
        ll = lhs_logits.reshape(*lhs_logits.shape[:-1], n_cat, n_cls)
        rl = rhs_logits.reshape(*rhs_logits.shape[:-1], n_cat, n_cls)
        lp = 0.99 * torch.softmax(ll, -1) + 0.01 / n_cls
        rp = 0.99 * torch.softmax(rl, -1) + 0.01 / n_cls
        return torch.sum(lp * (torch.log(lp) - torch.log(rp)), dim=(-2, -1))

    def wm_loss(self, wm, batch: dict, noise=None):
        """World-model loss over (B, T) sequences (reference:
        dreamerv3_tf_learner.py world-model part): symlog MSE decoder +
        twohot reward + bernoulli continue + KL-balanced dyn/rep with
        free bits. `noise`: the posterior draws' Gumbel noise, (T, B,
        n_cat, n_cls). Returns (total, feat (B, T, F), metrics)."""
        cfg = self.config
        obs = batch["obs"]
        B, T = obs.shape[:2]
        A = self.n_actions
        h = torch.zeros((B, self.deter), device=obs.device)
        z = torch.zeros((B, self.stoch), device=obs.device)
        a_oh = F.one_hot(batch["actions"].long(), A).to(torch.float32)
        a_prev = torch.cat([torch.zeros_like(a_oh[:, :1]), a_oh[:, :-1]], 1)
        enc_in = self._prep(obs)  # encoder + decoder target space
        # the encoder does not depend on the carry: one batched call
        emb = self._encode(wm, enc_in.reshape(B * T, *enc_in.shape[2:]))
        emb = emb.reshape(B, T, -1)
        first = batch["first"]
        hs, zs, post_ls = [], [], []
        for t in range(T):  # the posterior scan
            # episode boundary: reset the latent state
            h = _zero_where(first[:, t], h)
            z = _zero_where(first[:, t], z)
            a = _zero_where(first[:, t], a_prev[:, t])
            x = _mlp(wm["gru_in"], torch.cat([z, a], -1), out_act=True)
            h = _gru(wm["gru"], h, x)
            post_l = _mlp(wm["post"], torch.cat([h, emb[:, t]], -1))
            z, _ = self._latent(post_l,
                                None if noise is None else noise[t])
            hs.append(h)
            zs.append(z)
            post_ls.append(post_l)
        hs, zs = torch.stack(hs, 1), torch.stack(zs, 1)
        post_l = torch.stack(post_ls, 1)
        prior_l = _mlp(wm["prior"], hs)
        feat = torch.cat([hs, zs], -1)

        recon = _mlp(wm["decoder"], feat)
        l_dec = torch.mean(torch.sum(
            (recon - enc_in.reshape(B, T, -1)) ** 2, -1))
        r_logits = _mlp(wm["reward"], feat)
        l_rew = -torch.mean(torch.sum(
            twohot(batch["rewards"]) * torch.log_softmax(r_logits, -1), -1))
        c_logit = _mlp(wm["cont"], feat)[..., 0]
        cont = 1.0 - batch["dones"]
        l_cont = torch.mean(sigmoid_bce(c_logit, cont))
        # KL balancing (0.5 dyn / 0.1 rep) with free bits
        dyn = self._kl_cat(post_l.detach(), prior_l)
        rep = self._kl_cat(post_l, prior_l.detach())
        l_dyn = torch.mean(torch.clamp(dyn, min=cfg.free_bits))
        l_rep = torch.mean(torch.clamp(rep, min=cfg.free_bits))
        total = l_dec + l_rew + l_cont + 0.5 * l_dyn + 0.1 * l_rep
        return total, feat, {"wm/decoder": l_dec, "wm/reward": l_rew,
                             "wm/continue": l_cont, "wm/dyn": l_dyn,
                             "wm/rep": l_rep}

    @torch.no_grad()
    def imagine(self, wm, actor, feat0, noise=None):
        """Dream H steps from every posterior state (S starts): the
        features the actor saw at each step (H, S, F), the actions taken
        (H, S) and the features reached (H, S, F). `noise`: Gumbel noise
        {"action": (H, S, A), "latent": (H, S, n_cat, n_cls)}."""
        H, A = self.config.horizon_H, self.n_actions
        h, z = feat0[:, :self.deter], feat0[:, self.deter:]
        seen, actions, feats = [], [], []
        for t in range(H):  # the imagination scan
            feat = torch.cat([h, z], -1)
            probs = 0.99 * torch.softmax(_mlp(actor, feat), -1) + 0.01 / A
            a = self._categorical(torch.log(probs),
                                  None if noise is None
                                  else noise["action"][t])
            h, z = self._img_step(wm, h, z, F.one_hot(a, A).to(h.dtype),
                                  None if noise is None
                                  else noise["latent"][t])
            seen.append(feat)
            actions.append(a)
            feats.append(torch.cat([h, z], -1))
        return torch.stack(seen), torch.stack(actions), torch.stack(feats)

    def lambda_returns(self, rewards, conts, values):
        """TD(lambda) over the imagined horizon: (H+1, S) -> (H, S)."""
        cfg = self.config
        nxt = values[-1]
        rets = [None] * (values.shape[0] - 1)
        for t in range(len(rets) - 1, -1, -1):
            nxt = rewards[t] + cfg.gamma * conts[t] * (
                (1 - cfg.gae_lambda) * values[t + 1] + cfg.gae_lambda * nxt)
            rets[t] = nxt
        return torch.stack(rets)

    def ac_losses(self, actor, critic, critic_ema, wm, feat_post,
                  noise=None):
        """(actor loss, critic loss, metrics) over the dream from every
        posterior state of `feat_post` (no gradient reaches it or the
        world model)."""
        cfg = self.config
        A = self.n_actions
        feat0 = feat_post.reshape(-1, feat_post.shape[-1]).detach()
        seen, actions, dreamt = self.imagine(wm, actor, feat0, noise)
        probs = 0.99 * torch.softmax(_mlp(actor, seen), -1) + 0.01 / A
        logprobs = torch.log(probs)
        logps = logprobs.gather(-1, actions[..., None])[..., 0]
        ents = -torch.sum(probs * logprobs, -1)
        with torch.no_grad():
            feats = torch.cat([feat0[None], dreamt], 0)  # (H+1, S, F)
            rew = twohot_mean(_mlp(wm["reward"], feats))
            cont = torch.sigmoid(_mlp(wm["cont"], feats)[..., 0])
            v = twohot_mean(_mlp(critic, feats))
            rets = self.lambda_returns(rew, cont, v)  # (H, S)
            weights = torch.cumprod(torch.cat(
                [torch.ones_like(cont[:1]), cfg.gamma * cont[:-1]], 0), 0)
            # actor: REINFORCE on percentile-normalized returns
            # (reference: the 5th-95th percentile scale)
            offset = torch.quantile(rets, 0.05)
            scale = torch.clamp(torch.quantile(rets, 0.95) - offset,
                                min=1.0)
            adv = (rets - v[:-1]) / scale
            tgt = twohot(rets)
            ema_tgt = torch.softmax(_mlp(critic_ema, feats[:-1]), -1)
        l_actor = -torch.mean(weights[:-1] * (logps * adv +
                                              cfg.entropy_scale * ents))
        # critic: twohot CE toward lambda returns + EMA regularizer
        c_logp = torch.log_softmax(_mlp(critic, feats[:-1]), -1)
        l_critic = -torch.mean(weights[:-1] * torch.sum(tgt * c_logp, -1))
        l_critic = l_critic - torch.mean(
            weights[:-1] * torch.sum(ema_tgt * c_logp, -1))
        return l_actor, l_critic, {
            "actor/entropy": torch.mean(ents.detach()),
            "actor/adv": torch.mean(adv),
            "critic/value": torch.mean(v),
            "imagined_return": torch.mean(rets),
        }

    def _noise(self, B: int, T: int) -> dict:
        H, A = self.config.horizon_H, self.n_actions
        S = B * T
        return {"wm": self._gumbel(T, B, self.n_cat, self.n_cls),
                "action": self._gumbel(H, S, A),
                "latent": self._gumbel(H, S, self.n_cat, self.n_cls)}

    def _update(self, batch: dict, noise=None) -> dict:
        """One world-model, actor and critic step and the EMA critic on a
        (B, T) batch of device tensors; `noise` as `_noise` gives it
        (drawn when not given). Returns the metrics as 0-d tensors."""
        B, T = batch["obs"].shape[:2]
        noise = self._noise(B, T) if noise is None else noise
        groups = (self.wm, self.actor, self.critic)
        for p in tree.leaves(groups):
            p.requires_grad_(True)
        with catalog.deterministic_convs():
            wl, feat, wmetrics = self.wm_loss(self.wm, batch, noise["wm"])
            wgrads = torch.autograd.grad(wl, tree.leaves(self.wm))
        la, lc, acm = self.ac_losses(self.actor, self.critic,
                                     self.critic_ema, self.wm, feat,
                                     noise)
        agrads = torch.autograd.grad(la, tree.leaves(self.actor))
        cgrads = torch.autograd.grad(lc, tree.leaves(self.critic))
        self.wm, self.wm_opt = self.wm_tx.update(
            tree.unflatten(self.wm, wgrads), self.wm_opt, self.wm)
        self.actor, self.actor_opt = self.actor_tx.update(
            tree.unflatten(self.actor, agrads), self.actor_opt, self.actor)
        self.critic, self.critic_opt = self.critic_tx.update(
            tree.unflatten(self.critic, cgrads), self.critic_opt,
            self.critic)
        with torch.no_grad():
            ema, c = tree.leaves(self.critic_ema), tree.leaves(self.critic)
            torch._foreach_mul_(ema, 0.98)
            torch._foreach_add_(ema, c, alpha=0.02)
        metrics = {**wmetrics, **acm, "wm/total": wl, "critic/loss": lc}
        return {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def act(self, h, z, obs, first, noise=None):
        """One step of the posterior policy for the env lanes: (actions,
        h, z) on the device. `noise`: {"latent": (N, n_cat, n_cls),
        "action": (N, A)} Gumbel noise, drawn when not given."""
        A = self.n_actions
        wm = self.wm
        h = _zero_where(first, h)
        z = _zero_where(first, z)
        emb = self._encode(wm, self._prep(obs))
        post_logits = _mlp(wm["post"], torch.cat([h, emb], -1))
        z, _ = self._latent(post_logits,
                            None if noise is None else noise["latent"])
        probs = 0.99 * torch.softmax(_mlp(self.actor, torch.cat([h, z], -1)),
                                     -1) + 0.01 / A
        a = self._categorical(torch.log(probs),
                              None if noise is None else noise["action"])
        x = _mlp(wm["gru_in"], torch.cat([z, F.one_hot(a, A).to(z.dtype)],
                                         -1), out_act=True)
        h = _gru(wm["gru"], h, x)
        return a, h, z

    # ------------------------------------------------------------ train

    def training_step(self) -> dict:
        cfg = self.config
        t0 = time.perf_counter()
        dev = self.device
        # -- collect real experience through the posterior policy
        for _ in range(cfg.rollout_fragment_length):
            first = self._prev_done.copy()
            a, self._h, self._z = self.act(
                self._h, self._z, torch.from_numpy(self.obs).to(dev),
                torch.from_numpy(first).to(dev))
            a = a.cpu().numpy()
            nxt, rew, term, trunc, _ = self.envs.step(a)
            done = np.logical_or(term, trunc)
            # next-step autoreset: the step AFTER done carries the reset
            # obs with the action ignored — store it as a sequence start
            self.buffer.add_step({
                # native dtype: uint8 pixels stay uint8 in replay (4x
                # smaller); _prep scales on the device at train time
                "obs": np.asarray(self.obs),
                "actions": a,
                "rewards": np.asarray(rew, np.float32),
                "dones": np.asarray(term, np.float32),
                "first": first.astype(np.float32),
            })
            self._prev_done = done
            self._ep_returns += rew
            for i in np.nonzero(done)[0]:
                self._completed.append(float(self._ep_returns[i]))
                self._ep_returns[i] = 0.0
            self.obs = nxt
            self._env_steps += cfg.num_envs

        # -- replay-train at the configured training ratio (bounded per
        # iteration so one train() call stays responsive)
        metrics = {}
        want = self._env_steps * cfg.training_ratio
        max_updates = 64
        while max_updates > 0 and self._replayed < want and \
                self.buffer.can_sample(cfg.batch_size_B, cfg.batch_length_T):
            max_updates -= 1
            batch = self.buffer.sample_sequences(cfg.batch_size_B,
                                                 cfg.batch_length_T)
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in batch.items()}
            metrics = self._update(batch)
            self._replayed += cfg.batch_size_B * cfg.batch_length_T
        if metrics:  # the last update's metrics, in one host copy
            names = sorted(metrics)
            vals = torch.stack([metrics[k] for k in names]).cpu().tolist()
            metrics = dict(zip(names, vals))

        window = self._completed[-100:]
        self._completed = window
        return {
            "episode_return_mean": float(np.mean(window)) if window
            else float("nan"),
            "num_env_steps_sampled_lifetime": self._env_steps,
            "num_steps_replayed": self._replayed,
            "time_s": time.perf_counter() - t0,
            **metrics,
        }

    def get_weights(self):
        return params_to_numpy({"wm": self.wm, "actor": self.actor,
                                "critic": self.critic})

    def evaluate(self) -> dict:
        # Dreamer's env loop lives in the driver with its own buffer —
        # episode_return_mean from training is the evaluation surface
        raise NotImplementedError(
            "DreamerV3 evaluation rides episode_return_mean from training")

    def cleanup(self):
        self.envs.close()
