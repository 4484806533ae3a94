"""Search spaces + trial generation: the port's copy of
``ray_tpu/tune/search.py`` (pure Python; the port imports nothing of the
JAX package).

Reference parity: ray.tune search-space API (tune/search/sample.py —
uniform/loguniform/choice/randint, grid_search marker) and the
BasicVariantGenerator (tune/search/basic_variant.py) that crosses grid
axes and samples stochastic domains num_samples times.
"""

from __future__ import annotations

import itertools
import random
from typing import Any


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Float(Domain):
    def __init__(self, lower: float, upper: float, log: bool = False):
        self.lower, self.upper, self.log = lower, upper, log

    def sample(self, rng):
        if self.log:
            import math

            return math.exp(rng.uniform(math.log(self.lower),
                                        math.log(self.upper)))
        return rng.uniform(self.lower, self.upper)


class Integer(Domain):
    def __init__(self, lower: int, upper: int):
        self.lower, self.upper = lower, upper

    def sample(self, rng):
        return rng.randrange(self.lower, self.upper)


class Categorical(Domain):
    def __init__(self, categories):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


def uniform(lower: float, upper: float) -> Float:
    return Float(lower, upper)


def loguniform(lower: float, upper: float) -> Float:
    return Float(lower, upper, log=True)


def randint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper)


def choice(categories) -> Categorical:
    return Categorical(categories)


def grid_search(values) -> dict:
    return {"grid_search": list(values)}


def _is_grid(v) -> bool:
    return isinstance(v, dict) and set(v.keys()) == {"grid_search"}


class Searcher:
    """Model-based search algorithm ABC (reference:
    tune/search/searcher.py Searcher — suggest/on_trial_complete). The
    Tuner asks `suggest` for each new trial's config and feeds the final
    metric back through `on_trial_complete`, so the searcher can
    condition later draws on earlier results (unlike the stateless
    BasicVariantGenerator path)."""

    def set_objective(self, metric: str, mode: str):
        self.metric = getattr(self, "metric", None) or metric
        self.mode = getattr(self, "mode", None) or mode

    def suggest(self, trial_id: str) -> dict | None:
        raise NotImplementedError

    def on_trial_result(self, trial_id: str, result: dict):
        pass

    def on_trial_complete(self, trial_id: str, result: dict | None = None):
        pass


class TPESearcher(Searcher):
    """Tree-structured Parzen Estimator (reference role:
    tune/search/optuna/optuna_search.py, whose default sampler is TPE —
    Bergstra et al. 2011). Dependency-free implementation:

    - first `n_initial` trials are random draws;
    - afterwards, observations are split into the top `gamma` fraction
      ("good") and the rest ("bad"); per dimension a Parzen KDE is built
      over each split, candidates are drawn from the good KDE and ranked
      by the density ratio l(x)/g(x); the best candidate wins.

    Supports Float (linear/log), Integer, and Categorical domains; plain
    values pass through untouched.
    """

    def __init__(self, space: dict, metric: str | None = None,
                 mode: str | None = None, n_initial: int = 10,
                 gamma: float = 0.25, n_candidates: int = 24,
                 seed: int | None = None):
        self.space = dict(space)
        for k, v in self.space.items():
            if _is_grid(v):
                raise ValueError(
                    f"grid_search({k!r}) is incompatible with TPESearcher; "
                    "use choice() instead")
        self.metric = metric
        self.mode = mode
        self.n_initial = n_initial
        self.gamma = gamma
        self.n_candidates = n_candidates
        self._rng = random.Random(seed)
        self._suggested: dict[str, dict] = {}
        self._observed: list[tuple[dict, float]] = []

    # -- observation ------------------------------------------------------

    def on_trial_complete(self, trial_id: str, result: dict | None = None):
        cfg = self._suggested.pop(trial_id, None)
        if cfg is None or not result:
            return
        value = result.get(self.metric)
        if value is None:
            return
        score = float(value) if self.mode == "min" else -float(value)
        self._observed.append((cfg, score))

    # -- suggestion -------------------------------------------------------

    def suggest(self, trial_id: str) -> dict:
        if len(self._observed) < self.n_initial:
            cfg = self._sample_random()
        else:
            cfg = self._sample_tpe()
        self._suggested[trial_id] = cfg
        return dict(cfg)

    def _sample_random(self) -> dict:
        return {k: (v.sample(self._rng) if isinstance(v, Domain) else v)
                for k, v in self.space.items()}

    def _split(self):
        ranked = sorted(self._observed, key=lambda o: o[1])
        n_good = max(1, int(len(ranked) * self.gamma))
        return ranked[:n_good], ranked[n_good:]

    def _sample_tpe(self) -> dict:
        import math

        good, bad = self._split()
        out = {}
        for k, dom in self.space.items():
            if not isinstance(dom, Domain):
                out[k] = dom
                continue
            if isinstance(dom, Categorical):
                out[k] = self._tpe_categorical(k, dom, good, bad)
                continue
            log = isinstance(dom, Float) and dom.log
            to_x = (lambda v: math.log(v)) if log else (lambda v: float(v))
            lo, hi = to_x(dom.lower), to_x(dom.upper)
            gx = [to_x(c[k]) for c, _ in good]
            bx = [to_x(c[k]) for c, _ in bad] or gx
            # Parzen bandwidth: Silverman-flavored, floored to a fraction
            # of the range so early KDEs stay explorative
            def kde(xs, x):
                bw = max((hi - lo) / 12.0,
                         1.06 * (_std(xs) or (hi - lo)) *
                         max(len(xs), 1) ** -0.2)
                return sum(math.exp(-0.5 * ((x - xi) / bw) ** 2)
                           for xi in xs) / (len(xs) * bw) + 1e-12
            best_x, best_ratio = None, -1.0
            for _ in range(self.n_candidates):
                # draw from the good KDE: pick an anchor, jitter by bw
                anchor = self._rng.choice(gx)
                bw = max((hi - lo) / 12.0,
                         1.06 * (_std(gx) or (hi - lo)) *
                         max(len(gx), 1) ** -0.2)
                x = min(hi, max(lo, self._rng.gauss(anchor, bw)))
                ratio = kde(gx, x) / kde(bx, x)
                if ratio > best_ratio:
                    best_x, best_ratio = x, ratio
            v = math.exp(best_x) if log else best_x
            if isinstance(dom, Integer):
                v = min(dom.upper - 1, max(dom.lower, int(round(v))))
            out[k] = v
        return out

    def _tpe_categorical(self, k, dom, good, bad):
        cats = dom.categories
        # smoothed count ratio good/bad per category
        gcount = {c: 1.0 for c in cats}
        bcount = {c: 1.0 for c in cats}
        for cfg, _ in good:
            gcount[cfg[k]] = gcount.get(cfg[k], 1.0) + 1.0
        for cfg, _ in bad:
            bcount[cfg[k]] = bcount.get(cfg[k], 1.0) + 1.0
        scores = [gcount[c] / bcount[c] for c in cats]
        total = sum(scores)
        r = self._rng.random() * total
        acc = 0.0
        for c, s in zip(cats, scores):
            acc += s
            if r <= acc:
                return c
        return cats[-1]


def _std(xs):
    if len(xs) < 2:
        return 0.0
    m = sum(xs) / len(xs)
    return (sum((x - m) ** 2 for x in xs) / (len(xs) - 1)) ** 0.5


def generate_variants(param_space: dict, num_samples: int,
                      seed: int | None = None) -> list[dict]:
    """Cross-product of grid axes × num_samples draws of stochastic
    domains (reference: BasicVariantGenerator semantics — num_samples
    multiplies the grid)."""
    rng = random.Random(seed)
    grid_keys = [k for k, v in param_space.items() if _is_grid(v)]
    grid_values = [param_space[k]["grid_search"] for k in grid_keys]
    combos = list(itertools.product(*grid_values)) if grid_keys else [()]
    variants = []
    for _ in range(max(1, num_samples)):
        for combo in combos:
            cfg = {}
            for k, v in param_space.items():
                if k in grid_keys:
                    cfg[k] = combo[grid_keys.index(k)]
                elif isinstance(v, Domain):
                    cfg[k] = v.sample(rng)
                else:
                    cfg[k] = v
            variants.append(cfg)
    return variants
