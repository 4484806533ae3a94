"""The port's speculative-decoding config and proposer
(ray_tpu_torch.serve.llm.spec) against the JAX package's: the same
drafts over seeded token streams (random, a period-p cycle that the
copy-forward extends past the end of history, short contexts, every
n-gram range), and the same validation of SpeculativeConfig."""

import dataclasses

import numpy as np
import pytest

from ray_tpu.serve.llm import spec as jax_spec
from ray_tpu_torch.serve.llm import config as t_config
from ray_tpu_torch.serve.llm import spec as t_spec


def _streams():
    rng = np.random.RandomState(31)
    out = [rng.randint(0, 6, n).tolist() for n in (1, 2, 3, 9, 40, 120)]
    out += [rng.randint(0, 500, 80).tolist()]  # mostly no match
    for p in (1, 2, 3, 5, 8):  # period-p cycles after a random head
        head = rng.randint(100, 200, 4).tolist()
        motif = rng.randint(0, 50, p).tolist()
        out.append(head + motif * (3 + 12 // p) + motif[:p // 2])
    return out


@pytest.mark.parametrize("max_ngram,min_ngram", [(3, 1), (1, 1), (4, 2),
                                                 (2, 2)])
def test_ngram_drafts_match_jax(max_ngram, min_ngram):
    mine = t_spec.NGramProposer(max_ngram=max_ngram, min_ngram=min_ngram)
    ref = jax_spec.NGramProposer(max_ngram=max_ngram, min_ngram=min_ngram)
    drafted = 0
    for toks in _streams():
        for k in (0, 1, 4, 7):
            for cut in range(1, len(toks) + 1, 3):
                got = mine.propose(toks[:cut], k)
                assert got == ref.propose(toks[:cut], k), (toks[:cut], k)
                drafted += bool(got)
    assert drafted > 100


def test_period_cycle_extends_to_k():
    """A period-3 cycle yields the full k drafts, read forward out of the
    draft itself past the end of history."""
    toks = [9, 8] + [1, 2, 3] * 3
    got = t_spec.NGramProposer().propose(toks, 7)
    assert got == [1, 2, 3, 1, 2, 3, 1]
    assert got == jax_spec.NGramProposer().propose(toks, 7)


def _outcome(cls, payload):
    try:
        return ("ok", dataclasses.asdict(cls.from_payload(payload))
                if payload is not None else None)
    except (TypeError, ValueError) as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("payload", [
    None, {}, {"num_draft_tokens": 3}, {"num_draft_tokens": 0},
    {"bogus": 1}, {"method": "eagle"}, {"max_ngram": 1, "min_ngram": 2},
    {"min_ngram": 0}, {"num_draft_tokens": 8, "max_ngram": 5}, 3, "ngram",
])
def test_speculative_config_validates_like_jax(payload):
    assert _outcome(t_spec.SpeculativeConfig, payload) \
        == _outcome(jax_spec.SpeculativeConfig, payload)


def test_build_proposer_and_engine_config():
    cfg = t_spec.SpeculativeConfig(num_draft_tokens=2, max_ngram=2)
    prop = t_spec.build_proposer(cfg)
    assert isinstance(prop, t_spec.NGramProposer)
    assert (prop.max_ngram, prop.min_ngram) == (2, 1)
    ec = t_config.EngineConfig(speculative={"num_draft_tokens": 2})
    assert isinstance(ec.speculative, t_spec.SpeculativeConfig)
    assert t_config.EngineConfig(speculative=cfg).speculative is cfg
    with pytest.raises(ValueError):
        t_spec.NGramProposer(max_ngram=1, min_ngram=2)
    with pytest.raises(NotImplementedError):
        t_spec.DraftProposer().propose([1, 2], 3)
