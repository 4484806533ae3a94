"""Trial schedulers: FIFO and ASHA early stopping (and median stopping,
PBT, PB2 and the resource-changing wrapper below). The port's copy of
``ray_tpu/tune/schedulers.py`` (pure Python; PB2's GP is numpy).

Reference parity: ray.tune.schedulers — FIFOScheduler (trial_scheduler.py)
and ASHAScheduler / AsyncSuccessiveHalving (async_hyperband.py): rungs at
grace_period * reduction_factor^k; when a trial reaches a rung, it stops
unless its metric is in the top 1/reduction_factor of results recorded at
that rung.
"""

from __future__ import annotations


CONTINUE = "CONTINUE"
STOP = "STOP"


class FIFOScheduler:
    def on_result(self, trial_id: str, result: dict) -> str:
        return CONTINUE

    def on_trial_complete(self, trial_id: str):
        pass


class ASHAScheduler:
    def __init__(self, metric: str | None = None, mode: str | None = None,
                 time_attr: str = "training_iteration",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: int = 4, brackets: int = 1):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.max_t = max_t
        self.grace_period = grace_period
        self.rf = reduction_factor
        # milestones: grace, grace*rf, grace*rf^2 ... < max_t
        self.milestones: list[int] = []
        m = grace_period
        while m < max_t:
            self.milestones.append(m)
            m *= reduction_factor
        # rung -> list of recorded metric values
        self._rungs: dict[int, list[float]] = {m: [] for m in self.milestones}
        self._trial_progress: dict[str, int] = {}

    def set_objective(self, metric: str, mode: str):
        self.metric = self.metric or metric
        self.mode = self.mode or mode

    def on_result(self, trial_id: str, result: dict) -> str:
        t = result.get(self.time_attr)
        value = result.get(self.metric)
        if t is None or value is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP
        decision = CONTINUE
        for m in self.milestones:
            if self._trial_progress.get(trial_id, 0) < m <= t:
                rung = self._rungs[m]
                rung.append(float(value))
                if not self._in_top_fraction(float(value), rung):
                    decision = STOP
        self._trial_progress[trial_id] = t
        return decision

    def _in_top_fraction(self, value: float, rung: list[float]) -> bool:
        if len(rung) < self.rf:
            return True  # not enough evidence to cut yet
        ranked = sorted(rung, reverse=(self.mode == "max"))
        k = max(1, len(ranked) // self.rf)
        cutoff = ranked[k - 1]
        return value >= cutoff if self.mode == "max" else value <= cutoff

    def on_trial_complete(self, trial_id: str):
        self._trial_progress.pop(trial_id, None)


class MedianStoppingRule:
    """Stop a trial whose running-average metric at step t is worse than
    the median of the other trials' running averages at t (reference:
    ray.tune.schedulers.MedianStoppingRule, median_stopping_rule.py)."""

    def __init__(self, metric: str | None = None, mode: str | None = None,
                 time_attr: str = "training_iteration",
                 grace_period: int = 1, min_samples_required: int = 3):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self._sums: dict[str, float] = {}
        self._counts: dict[str, int] = {}

    def set_objective(self, metric: str, mode: str):
        self.metric = self.metric or metric
        self.mode = self.mode or mode

    def on_result(self, trial_id: str, result: dict) -> str:
        t = result.get(self.time_attr)
        value = result.get(self.metric)
        if t is None or value is None:
            return CONTINUE
        self._sums[trial_id] = self._sums.get(trial_id, 0.0) + float(value)
        self._counts[trial_id] = self._counts.get(trial_id, 0) + 1
        if t <= self.grace_period:
            return CONTINUE
        others = [self._sums[k] / self._counts[k]
                  for k in self._sums if k != trial_id]
        if len(others) < self.min_samples:
            return CONTINUE
        med = sorted(others)[len(others) // 2]
        mine = self._sums[trial_id] / self._counts[trial_id]
        worse = mine < med if self.mode == "max" else mine > med
        return STOP if worse else CONTINUE

    def on_trial_complete(self, trial_id: str):
        pass


class PopulationBasedTraining:
    """PBT: bottom-quantile trials clone a top-quantile trial's checkpoint
    and perturb its hyperparams (reference:
    ray.tune.schedulers.pbt.PopulationBasedTraining, pbt.py:221 —
    _checkpoint_or_exploit / _exploit / explore).

    The Tuner acts on the ("EXPLOIT", source_trial_id, new_config)
    decision by restarting the trial's actor from the source trial's
    latest reported checkpoint with the mutated config.
    """

    def __init__(self, time_attr: str = "training_iteration",
                 metric: str | None = None, mode: str | None = None,
                 perturbation_interval: int = 5,
                 hyperparam_mutations: dict | None = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 perturbation_factors=(1.2, 0.8),
                 seed: int | None = None):
        import random

        self.time_attr = time_attr
        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        self.mutations = dict(hyperparam_mutations or {})
        self.quantile = quantile_fraction
        self.resample_prob = resample_probability
        self.factors = perturbation_factors
        self._rng = random.Random(seed)
        self._scores: dict[str, float] = {}   # latest metric per trial
        self._configs: dict[str, dict] = {}
        self._last_perturb: dict[str, int] = {}
        self._pending_exploit: dict[str, tuple] = {}
        self.exploit_count = 0  # observability / tests

    def set_objective(self, metric: str, mode: str):
        self.metric = self.metric or metric
        self.mode = self.mode or mode

    def on_trial_add(self, trial_id: str, config: dict):
        self._configs[trial_id] = dict(config)

    def on_result(self, trial_id: str, result: dict):
        t = result.get(self.time_attr)
        value = result.get(self.metric)
        if t is None or value is None:
            return CONTINUE
        self._scores[trial_id] = float(value)
        if t - self._last_perturb.get(trial_id, 0) < self.interval:
            return CONTINUE
        prev_perturb = self._last_perturb.get(trial_id, 0)
        self._last_perturb[trial_id] = t
        lower, upper = self._quantiles()
        if trial_id not in lower or not upper:
            return CONTINUE
        source = self._rng.choice(upper)
        new_config = self._explore(self._configs.get(source, {}))
        # remember pre-exploit state: the Tuner aborts the exploit when
        # the source has no checkpoint yet, and scheduler state must then
        # match the trial's ACTUAL (unchanged) config
        self._pending_exploit[trial_id] = (
            dict(self._configs.get(trial_id, {})), prev_perturb)
        self._configs[trial_id] = dict(new_config)
        self.exploit_count += 1
        return ("EXPLOIT", source, new_config)

    def on_exploit_applied(self, trial_id: str):
        self._pending_exploit.pop(trial_id, None)

    def on_exploit_aborted(self, trial_id: str):
        """The Tuner could not apply the exploit (no source checkpoint):
        roll back config + perturbation clock."""
        saved = self._pending_exploit.pop(trial_id, None)
        if saved is not None:
            old_config, old_perturb = saved
            self._configs[trial_id] = old_config
            self._last_perturb[trial_id] = old_perturb
            self.exploit_count -= 1

    def _quantiles(self):
        """(bottom, top) trial-id lists by latest score."""
        if len(self._scores) < 2:
            return [], []
        ranked = sorted(self._scores, key=self._scores.get,
                        reverse=(self.mode == "max"))
        k = max(1, int(len(ranked) * self.quantile))
        return ranked[-k:], ranked[:k]

    def _explore(self, config: dict) -> dict:
        out = dict(config)
        for key, spec in self.mutations.items():
            if isinstance(spec, (list, tuple)):
                out[key] = self._rng.choice(list(spec))
                continue
            if callable(spec):
                out[key] = spec()
                continue
            cur = out.get(key)
            if isinstance(cur, (int, float)) and \
                    self._rng.random() >= self.resample_prob:
                out[key] = cur * self._rng.choice(self.factors)
                if isinstance(cur, int):
                    out[key] = max(1, int(out[key]))
        return out

    def on_trial_complete(self, trial_id: str):
        self._scores.pop(trial_id, None)


class PB2(PopulationBasedTraining):
    """Population Based Bandits (reference:
    ray.tune.schedulers.pb2.PB2, tune/schedulers/pb2.py — Parker-Holder
    et al. 2020): PBT's exploit step kept, but the EXPLORE step replaced
    by a GP-bandit. Observed (config, reward-change) pairs fit a GP; the
    new config maximizes UCB mean + kappa*std over `hyperparam_bounds`,
    so the population searches the continuous box directly instead of
    multiplying current values by fixed factors — which is what lets PB2
    escape a bad initialization PBT would only crawl away from.
    """

    def __init__(self, time_attr: str = "training_iteration",
                 metric: str | None = None, mode: str | None = None,
                 perturbation_interval: int = 5,
                 hyperparam_bounds: dict | None = None,
                 quantile_fraction: float = 0.25,
                 kappa: float = 1.5, seed: int | None = None):
        super().__init__(time_attr=time_attr, metric=metric, mode=mode,
                         perturbation_interval=perturbation_interval,
                         hyperparam_mutations={},
                         quantile_fraction=quantile_fraction, seed=seed)
        self.bounds = dict(hyperparam_bounds or {})
        self.kappa = kappa
        # (normalized config vector, reward delta) observations
        self._gp_data: list[tuple[list[float], float]] = []
        self._last_obs: dict[str, tuple[float, float]] = {}  # t, value

    # -- data collection --------------------------------------------------

    def on_result(self, trial_id: str, result: dict):
        t = result.get(self.time_attr)
        value = result.get(self.metric)
        if t is not None and value is not None and self.bounds:
            prev = self._last_obs.get(trial_id)
            if prev is not None and t > prev[0]:
                delta = (float(value) - prev[1]) / (t - prev[0])
                if self.mode == "min":
                    delta = -delta
                vec = self._normalize(self._configs.get(trial_id, {}))
                if vec is not None:
                    self._gp_data.append((vec, delta))
                    if len(self._gp_data) > 200:
                        self._gp_data.pop(0)
            self._last_obs[trial_id] = (float(t), float(value))
        return super().on_result(trial_id, result)

    def _normalize(self, config: dict) -> list[float] | None:
        vec = []
        for k, (lo, hi) in self.bounds.items():
            v = config.get(k)
            if not isinstance(v, (int, float)):
                return None
            vec.append((float(v) - lo) / max(hi - lo, 1e-12))
        return vec

    # -- GP-UCB explore ---------------------------------------------------

    def _explore(self, config: dict) -> dict:
        out = dict(config)
        if not self.bounds:
            return out
        keys = list(self.bounds)
        cand = self._candidates(config)
        best = cand[0]
        if len(self._gp_data) >= 4:
            import numpy as np

            X = np.array([d[0] for d in self._gp_data])
            y = np.array([d[1] for d in self._gp_data])
            y = (y - y.mean()) / (y.std() + 1e-9)
            mu, sd = _gp_predict(X, y, np.array(cand))
            best = cand[int(np.argmax(mu + self.kappa * sd))]
        for i, k in enumerate(keys):
            lo, hi = self.bounds[k]
            v = lo + best[i] * (hi - lo)
            cur = config.get(k)
            out[k] = int(round(v)) if isinstance(cur, int) else v
        return out

    def _candidates(self, config: dict, n: int = 64) -> list[list[float]]:
        d = len(self.bounds)
        cand = [[self._rng.random() for _ in range(d)] for _ in range(n)]
        base = self._normalize(config)
        if base is not None:
            # local jitters around the exploited config keep exploitation
            # of a good region possible alongside global draws
            for _ in range(n // 4):
                cand.append([min(1.0, max(0.0,
                             b + self._rng.gauss(0, 0.1))) for b in base])
        return cand


class ResourceChangingScheduler:
    """Reallocate trial resources mid-flight (reference:
    ray.tune.schedulers.ResourceChangingScheduler,
    resource_changing_scheduler.py — wraps a base scheduler; a
    resources_allocation_function decides each trial's new allocation
    from the population's results). The Tuner acts on the
    ("REALLOCATE", resources) decision by restarting the trial's actor
    from its latest checkpoint with the new resource request — the same
    checkpoint-restart machinery PBT's exploit uses.

    The default allocation function is DistributeResourcesToTopJob-
    shaped: the current best trial gets `top_cpus`, everyone else
    `base_cpus`."""

    def __init__(self, base_scheduler=None,
                 resources_allocation_function=None,
                 reallocation_interval: int = 4,
                 time_attr: str = "training_iteration",
                 base_cpus: float = 1.0, top_cpus: float = 2.0,
                 metric: str | None = None, mode: str | None = None):
        self.base = base_scheduler or FIFOScheduler()
        self.fn = resources_allocation_function
        self.interval = reallocation_interval
        self.time_attr = time_attr
        self.base_cpus = base_cpus
        self.top_cpus = top_cpus
        self.metric = metric
        self.mode = mode
        self._scores: dict[str, float] = {}
        self._alloc: dict[str, float] = {}  # current CPUs per trial
        self._last_realloc: dict[str, int] = {}
        self.realloc_count = 0

    def set_objective(self, metric: str, mode: str):
        self.metric = self.metric or metric
        self.mode = self.mode or mode
        if hasattr(self.base, "set_objective"):
            self.base.set_objective(metric, mode)

    def on_trial_add(self, trial_id: str, config: dict):
        self._alloc.setdefault(trial_id, self.base_cpus)
        if hasattr(self.base, "on_trial_add"):
            self.base.on_trial_add(trial_id, config)

    def on_trial_complete(self, trial_id: str):
        self._scores.pop(trial_id, None)
        self._alloc.pop(trial_id, None)
        self.base.on_trial_complete(trial_id)

    def _default_allocation(self, trial_id: str) -> dict | None:
        if len(self._scores) < 2:
            return None
        best = (max if self.mode == "max" else min)(
            self._scores, key=self._scores.get)
        want = self.top_cpus if trial_id == best else self.base_cpus
        if abs(self._alloc.get(trial_id, self.base_cpus) - want) < 1e-9:
            return None  # unchanged: no restart
        return {"CPU": want}

    def on_result(self, trial_id: str, result: dict):
        value = result.get(self.metric)
        if value is not None:
            self._scores[trial_id] = float(value)
        d = self.base.on_result(trial_id, result)
        if d != CONTINUE:
            return d
        t = result.get(self.time_attr)
        if t is None or \
                t - self._last_realloc.get(trial_id, 0) < self.interval:
            return CONTINUE
        self._last_realloc[trial_id] = t
        new_res = (self.fn(trial_id, dict(self._scores),
                           dict(self._alloc))
                   if self.fn else self._default_allocation(trial_id))
        if not new_res:
            return CONTINUE
        self._pending_realloc = (trial_id,
                                 self._alloc.get(trial_id, self.base_cpus),
                                 self._last_realloc[trial_id])
        self._alloc[trial_id] = new_res.get("CPU", self.base_cpus)
        self.realloc_count += 1
        return ("REALLOCATE", new_res)

    def on_realloc_aborted(self, trial_id: str):
        """The Tuner could not resize (no checkpoint yet): roll back the
        allocation view and the interval clock so a later report retries
        instead of believing the resize happened."""
        pending = getattr(self, "_pending_realloc", None)
        if pending is not None and pending[0] == trial_id:
            _, old_alloc, old_t = pending
            self._alloc[trial_id] = old_alloc
            # rewind the clock so the next report past the interval
            # fires again
            self._last_realloc[trial_id] = old_t - self.interval
            self.realloc_count -= 1
            self._pending_realloc = None


def _gp_predict(X, y, Xq, lengthscale: float = 0.3, noise: float = 1e-2):
    """RBF-kernel GP posterior mean/std at query points (inputs already
    normalized to [0,1]^d)."""
    import numpy as np

    def k(A, B):
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / lengthscale ** 2)

    K = k(X, X) + noise * np.eye(len(X))
    L = np.linalg.cholesky(K)
    alpha = np.linalg.solve(L.T, np.linalg.solve(L, y))
    Ks = k(Xq, X)
    mu = Ks @ alpha
    v = np.linalg.solve(L, Ks.T)
    var = np.clip(1.0 - (v ** 2).sum(0), 1e-9, None)
    return mu, np.sqrt(var)
