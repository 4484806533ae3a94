"""LLMEngine: cache pool + runner + scheduler + streaming outputs.

The port of ``ray_tpu/serve/llm/engine.py``. One engine instance serves
one model replica on one device. Requests arrive from any thread
(`add_request` / `generate`); exactly one thread drives `step()`. Each
request gets a `RequestStream`, an iterator of token events fed by the
step loop and closed with a final summary event, whose ``breakdown``
carries the per-phase accounting kept on each `Sequence`.

The engine runs on CUDA unless the caller passes ``device="cpu"`` (the
tests do); without a card it raises instead of dropping to the CPU.
With ``mesh=`` (a ``DeviceMesh`` of ``parallel.build_mesh``) it serves
on a mesh as the JAX engine does: the pool is sized per shard of the
``tensor`` axis and the runner lays the params and pages out over the
mesh (``runner.py``). Every rank of the mesh runs the same engine with
the same requests and produces the same streams.

It serves at the JAX engine's defaults: prompts that fit one chunk
prefill monolithically (kernel K1), longer ones and prefix-cache hits
in page-aligned chunks against the gathered context, and decode runs
over a dense gathered context; with ``use_paged_attention`` decode and
the speculative verify window run through kernel K4 instead. With
``speculative`` set, a host-side proposer drafts tokens for each lane
and one verify step a lane scores them. Each request records its waterfall
as an ``llm.request`` span with one child a phase, under the trace that
submitted it, and a weight swap an ``rl.weight_swap`` span
(``util/tracing.py``); its metrics go to the port's own registry
(``ray_tpu_torch.util``).
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from typing import Any, Sequence as Seq

import torch

from ray_tpu_torch.parallel.mesh import mesh_shape
from ray_tpu_torch.serve.llm.cache import BlockPool, auto_num_blocks
from ray_tpu_torch.serve.llm.config import EngineConfig, SamplingParams
from ray_tpu_torch.serve.llm.runner import (
    DecodeItem,
    ModelRunner,
    adapters,
    logprob_at,
)
from ray_tpu_torch.serve.llm.scheduler import (
    DecodeWork,
    PrefillWork,
    Scheduler,
    Sequence,
)
from ray_tpu_torch.serve.llm.spec import build_proposer
from ray_tpu_torch.util import tree
from ray_tpu_torch.util.device import resolve_device

_FINAL = object()


class RequestStream:
    """Iterator over one request's token events.

    Yields ``{"token": id, "index": n}`` dicts as tokens are produced,
    then raises StopIteration; `final()` returns the summary event
    (token_ids, finish_reason, counts) once the stream is drained."""

    def __init__(self, seq_id: int):
        self.seq_id = seq_id
        self._q: "queue.Queue[Any]" = queue.Queue()
        self._final: dict | None = None
        self._ended = False  # sentinel consumed (iteration or next_event)

    # engine side -----------------------------------------------------
    def _emit(self, ev: dict) -> None:
        self._q.put(ev)

    def _close(self, final: dict) -> None:
        self._final = final
        self._q.put(_FINAL)

    # consumer side ---------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        if self._ended:
            raise StopIteration
        ev = self._q.get()
        if ev is _FINAL:
            self._ended = True
            raise StopIteration
        return ev

    def next_event(self, timeout: float | None = None):
        """Blocking fetch; returns None at end-of-stream (persistently —
        mixing with iteration is safe) and raises TimeoutError if no
        event arrives within `timeout` seconds."""
        if self._ended:
            return None
        try:
            ev = self._q.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError(
                f"no token event within {timeout}s") from None
        if ev is _FINAL:
            self._ended = True
            return None
        return ev

    def final(self) -> dict | None:
        return self._final


class LLMEngine:
    """Continuous-batching engine for one model instance."""

    def __init__(self, config: EngineConfig, *, params: Any = None,
                 mesh=None, device=None):
        self.device = resolve_device(device)
        self.config = config
        reg = adapters()
        if config.model not in reg:
            raise ValueError(
                f"unknown model {config.model!r}; have {sorted(reg)}")
        adapter = reg[config.model]
        if config.model_config is not None:
            cfg = config.model_config
        else:
            try:
                cfg = adapter.presets[config.preset]()
            except KeyError:
                raise ValueError(
                    f"unknown preset {config.preset!r} for "
                    f"{config.model}; have {sorted(adapter.presets)}")
        self.model_cfg = cfg
        max_len = config.max_model_len or cfg.block_size
        if max_len > cfg.block_size:
            raise ValueError(
                f"max_model_len {max_len} exceeds the model's positional "
                f"range {cfg.block_size}")

        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(config.seed)
            params = adapter.init_fn(gen, cfg, device=self.device)
        else:
            # tensors or host arrays (a learner's get_weights()), on the
            # engine's device
            params = tree.tree_map(
                lambda t: torch.as_tensor(t, device=self.device), params)

        num_blocks = config.num_blocks
        if num_blocks is None:
            num_blocks = auto_num_blocks(
                n_layer=cfg.n_layer,
                n_kv_head=adapter.kv_heads(cfg),
                head_dim=cfg.head_dim,
                block_size=config.block_size,
                dtype_bytes=torch.empty((), dtype=cfg.dtype).element_size(),
                max_model_len=max_len,
                max_batch_size=config.max_batch_size,
                memory_fraction=config.memory_fraction,
                tensor_ways=(mesh_shape(mesh).get("tensor", 1)
                             if mesh is not None else 1),
                device=self.device,
            )
        max_blocks_per_seq = (max_len + config.block_size - 1) \
            // config.block_size
        if num_blocks - 1 < max_blocks_per_seq:
            raise ValueError(
                f"pool of {num_blocks} blocks cannot hold one "
                f"max_model_len={max_len} sequence "
                f"({max_blocks_per_seq} blocks needed); raise num_blocks "
                f"or lower max_model_len")

        # prefix reuse needs the prefill-from-offset (chunk) step: with
        # chunking disabled the pool runs as a plain allocator
        chunking = config.prefill_chunk_size > 0
        self.pool = BlockPool(
            num_blocks, config.block_size,
            enable_prefix_cache=(config.enable_prefix_cache and chunking))
        # speculative decoding: proposer on the host, verify step on the
        # device
        spec_cfg = config.speculative
        self._proposer = build_proposer(spec_cfg) if spec_cfg else None
        self._spec_k = spec_cfg.num_draft_tokens if spec_cfg else 0
        self.runner = ModelRunner(
            adapter, cfg, params,
            block_size=config.block_size,
            num_blocks=num_blocks,
            max_model_len=max_len,
            max_batch_size=config.max_batch_size,
            device=self.device,
            prefill_bucket_min=config.prefill_bucket_min,
            prefill_chunk_size=(config.prefill_chunk_size if chunking
                                else None),
            mesh=mesh,
            sample_seed=config.seed + 1,
            num_draft_tokens=self._spec_k,
            use_paged_attention=config.use_paged_attention,
        )
        self.scheduler = Scheduler(
            self.pool, max_batch_size=config.max_batch_size,
            max_model_len=max_len,
            # the runner rounds the chunk to a page-aligned size; reuse
            # its value so scheduler chunks match its buckets
            chunk_size=(self.runner.prefill_chunk_size or 0),
            spec_tokens=self._spec_k)

        self._ids = itertools.count()
        self._streams: dict[int, RequestStream] = {}  # guarded_by(_lock)
        self._lock = threading.Lock()
        self._step_lock = threading.Lock()
        self._tokens_window: list[tuple[float, int]] = []  # (t, n)
        # weight hot-swap state: bumped only by update_weights(), which
        # holds _step_lock — so within one step() every sampled token
        # sees ONE version (no mid-decode-step version mix)
        self._weight_version = 0  # guarded_by(_step_lock)
        # cumulative per-phase seconds over finished requests
        self._phase_totals: dict[str, float] = {}  # guarded_by(_lock)
        self._finished_requests = 0  # guarded_by(_lock)
        self._build_metrics()

    # ----------------------------------------------------------- metrics

    def _build_metrics(self):
        from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

        tags = ("model",)
        self._m_tags = {"model": self.config.model}
        self._m_tokens = Counter(
            "serve_llm_tokens_generated_total",
            "Tokens generated by this engine", tag_keys=tags)
        self._m_requests = Counter(
            "serve_llm_requests_total",
            "Requests finished, by outcome",
            tag_keys=("model", "outcome"))
        self._m_preempt = Counter(
            "serve_llm_preemptions_total",
            "Sequences preempted on cache exhaustion", tag_keys=tags)
        self._m_queue = Gauge(
            "serve_llm_queue_depth", "Waiting requests", tag_keys=tags)
        self._m_running = Gauge(
            "serve_llm_running", "Sequences in the decode set",
            tag_keys=tags)
        self._m_cache = Gauge(
            "serve_llm_cache_utilization",
            "KV pool pages in use / usable pages", tag_keys=tags)
        self._m_tps = Gauge(
            "serve_llm_tokens_per_sec",
            "Generation throughput over the last ~5s", tag_keys=tags)
        self._m_ttft = Histogram(
            "serve_llm_ttft_ms", "Time to first token",
            boundaries=(1, 5, 10, 25, 50, 100, 250, 500, 1000, 5000),
            tag_keys=tags)
        self._m_step = Histogram(
            "serve_llm_step_ms", "Engine step latency",
            boundaries=(1, 5, 10, 25, 50, 100, 250, 500, 1000),
            tag_keys=("model", "kind"))
        self._m_prefix_hits = Counter(
            "serve_llm_prefix_cache_hits_total",
            "KV pages served from the prefix cache at admission",
            tag_keys=tags)
        self._m_prefix_misses = Counter(
            "serve_llm_prefix_cache_misses_total",
            "KV pages that had to be prefilled at admission",
            tag_keys=tags)
        self._m_prefix_evict = Counter(
            "serve_llm_prefix_cache_evictions_total",
            "Cached refcount-0 pages evicted for reuse", tag_keys=tags)
        self._m_cached_blocks = Gauge(
            "serve_llm_prefix_cached_blocks",
            "Refcount-0 pages retained for prefix reuse", tag_keys=tags)
        self._m_chunks = Counter(
            "serve_llm_prefill_chunks_total",
            "Prefill chunks executed", tag_keys=tags)
        self._m_stall = Histogram(
            "serve_llm_prefill_stall_ms",
            "Decode stall imposed by a prefill step that ran while "
            "decode-ready lanes were waiting",
            boundaries=(1, 5, 10, 25, 50, 100, 250, 500, 1000),
            tag_keys=tags)
        self._m_swaps = Counter(
            "serve_llm_weight_swaps_total",
            "Weight hot-swaps installed at a step boundary",
            tag_keys=tags)
        self._m_swap_s = Histogram(
            "rl_weight_swap_seconds",
            "Wall time of a drain-free weight hot-swap, streams in flight",
            boundaries=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10),
            tag_keys=tags)
        self._m_slo_ttft = Histogram(
            "serve_slo_ttft_ms",
            "Time to first token, decomposed: phase=queue (admission "
            "wait), phase=prefill (prefill work), phase=total",
            boundaries=(1, 5, 10, 25, 50, 100, 250, 500, 1000, 5000),
            tag_keys=("model", "phase"))
        self._m_slo_tpot = Histogram(
            "serve_slo_tpot_ms",
            "Time per output token after the first (decode + verify "
            "phase seconds / tokens committed after the first: a "
            "speculative step commits several tokens)",
            boundaries=(0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500),
            tag_keys=tags)
        # speculative decoding: proposed = draft tokens sent to verify;
        # accepted + rejected = proposed
        self._m_spec_proposed = Counter(
            "serve_llm_spec_proposed_total",
            "Draft tokens proposed to the verify step", tag_keys=tags)
        self._m_spec_accepted = Counter(
            "serve_llm_spec_accepted_total",
            "Draft tokens accepted by the verify step", tag_keys=tags)
        self._m_spec_rejected = Counter(
            "serve_llm_spec_rejected_total",
            "Draft tokens rejected by the verify step", tag_keys=tags)
        self._m_spec_ratio = Gauge(
            "serve_llm_spec_accept_ratio",
            "Cumulative draft acceptance ratio (accepted / proposed)",
            tag_keys=tags)
        self._m_verify_ms = Histogram(
            "serve_llm_verify_step_ms",
            "Speculative verify step latency (one drafted run)",
            boundaries=(1, 5, 10, 25, 50, 100, 250, 500, 1000),
            tag_keys=tags)
        self._m_paged = Gauge(
            "serve_llm_paged_attn_enabled",
            "1 when decode/verify run the paged-attention kernel, 0 on "
            "the dense gathered context", tag_keys=tags)
        self._m_paged.set(
            1.0 if self.runner.use_paged_attention else 0.0,
            tags=self._m_tags)
        self._spec_proposed_total = 0
        self._spec_accepted_total = 0
        # counter deltas are computed against the last pump
        self._last_prefix = (0, 0, 0)

    def _note_tokens(self, n: int) -> None:
        self._m_tokens.inc(n, tags=self._m_tags)
        now = time.monotonic()
        self._tokens_window.append((now, n))
        cutoff = now - 5.0
        while self._tokens_window and self._tokens_window[0][0] < cutoff:
            self._tokens_window.pop(0)
        span = max(1e-3, now - self._tokens_window[0][0]) \
            if self._tokens_window else 1.0
        self._m_tps.set(
            sum(k for _, k in self._tokens_window) / span,
            tags=self._m_tags)

    # ------------------------------------------------------------ intake

    def add_request(self, prompt: Seq[int],
                    sampling: SamplingParams | None = None
                    ) -> RequestStream:
        sampling = sampling or SamplingParams()
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        seq = Sequence(seq_id=next(self._ids), prompt=prompt,
                       sampling=sampling)
        # the request's trace context: a child of whatever span chain
        # submitted it (handle call, proxy request), so the finalize-
        # time waterfall spans correlate by trace_id
        from ray_tpu_torch.util import tracing
        from ray_tpu_torch.utils.events import child_trace

        seq.trace = child_trace(tracing.current_trace())
        stream = RequestStream(seq.seq_id)
        with self._lock:
            # validate (scheduler.add raises on over-long prompts) BEFORE
            # registering the stream, or rejected requests leak entries
            self.scheduler.add(seq)
            self._streams[seq.seq_id] = stream
        self._m_queue.set(len(self.scheduler.waiting), tags=self._m_tags)
        return stream

    def generate(self, prompt: Seq[int],
                 sampling: SamplingParams | None = None,
                 *, drive: bool = False, timeout: float = 120.0) -> dict:
        """Blocking convenience: returns the final event. With
        ``drive=True`` the caller's thread steps the engine itself
        (tests, bench — no loop thread needed)."""
        stream = self.add_request(prompt, sampling)
        deadline = time.monotonic() + timeout
        if drive:
            while stream.final() is None:
                if not self.step():
                    time.sleep(0.001)
                if time.monotonic() > deadline:
                    raise TimeoutError("generate() timed out")
            for _ in stream:
                pass
            return stream.final()
        while True:
            ev = stream.next_event(
                timeout=max(0.01, deadline - time.monotonic()))
            if ev is None:  # end of stream
                return stream.final()
            if time.monotonic() > deadline:
                raise TimeoutError("generate() timed out")

    # -------------------------------------------------------------- step

    def step(self) -> bool:
        """One scheduler decision + one device step. Returns False when
        there was nothing to do. Serialized: concurrent callers queue
        behind `_step_lock`."""
        with self._step_lock:
            with self._lock:
                pre = self.scheduler.preemption_count
                work = self.scheduler.schedule()  # may preempt lanes
                d_pre = self.scheduler.preemption_count - pre
                retired = self.scheduler.take_retired()
            if d_pre:
                self._m_preempt.inc(d_pre, tags=self._m_tags)
            for s in retired:  # schedule() closed these out itself
                self._finalize(s)
            if work is None:
                return retired != []
            t0 = time.perf_counter()
            if isinstance(work, PrefillWork):
                with self._lock:
                    # lanes this prefill step is holding back
                    stalled = sum(
                        1 for s in self.scheduler.running
                        if s is not work.seq and not s.prefill_pending)
                self._do_prefill(work)
                kind = "prefill"
                if stalled:
                    self._m_stall.observe(
                        (time.perf_counter() - t0) * 1e3,
                        tags=self._m_tags)
            else:
                self._do_decode(work)
                kind = "decode"
            self._m_step.observe(
                (time.perf_counter() - t0) * 1e3,
                tags={"model": self.config.model, "kind": kind})
            depth = self.scheduler.depth()
            self._m_queue.set(depth["waiting"], tags=self._m_tags)
            self._m_running.set(depth["running"], tags=self._m_tags)
            self._m_cache.set(depth["cache_utilization"],
                              tags=self._m_tags)
            self._m_cached_blocks.set(depth["blocks_cached"],
                                      tags=self._m_tags)
            now = (depth["prefix_hit_pages"], depth["prefix_miss_pages"],
                   depth["prefix_evictions"])
            for counter, last, cur in zip(
                    (self._m_prefix_hits, self._m_prefix_misses,
                     self._m_prefix_evict), self._last_prefix, now):
                if cur > last:
                    counter.inc(cur - last, tags=self._m_tags)
            self._last_prefix = now
            return True

    def _do_prefill(self, work: PrefillWork) -> None:
        seq = work.seq
        sp = seq.sampling
        ver = self._weight_version  # stable: step holds _step_lock
        tokens = seq.refill_tokens[work.start:work.end]
        try:
            if work.start == 0 and work.is_last:
                # whole prompt in one go and nothing cached: the
                # monolithic step needs no context gather
                nxt, last = self.runner.prefill(
                    tokens, seq.table, sp.temperature, sp.top_k, sp.top_p)
            else:
                nxt, last = self.runner.prefill_chunk(
                    tokens, work.start, seq.table, sp.temperature,
                    sp.top_k, sp.top_p)
        except Exception as e:  # noqa: BLE001
            with self._lock:
                self.scheduler.abort(seq, f"error:{e!r}")
            self._finalize(seq)
            return
        self._m_chunks.inc(tags=self._m_tags)
        seq.note_phase("prefill")  # chunk + its scheduling gap
        with self._lock:
            # full pages covered by this chunk are now shareable (the
            # state check skips sequences aborted mid-flight: their
            # pages may already belong to someone else)
            self.scheduler.register_prefilled_pages(seq, work.end)
        if not work.is_last:
            return  # intermediate chunk: no token was produced
        if seq.first_token_at is None:
            now = time.monotonic()
            self._m_ttft.observe(
                (now - seq.enqueued_at) * 1e3, tags=self._m_tags)
            # TTFT split for the SLO plane: queue vs prefill work
            ph = seq.phases
            self._m_slo_ttft.observe(
                (ph.get("queue", 0.0) + ph.get("preempt", 0.0)) * 1e3,
                tags={"model": self.config.model, "phase": "queue"})
            self._m_slo_ttft.observe(
                (ph.get("prefix_match", 0.0) + ph.get("prefill", 0.0))
                * 1e3,
                tags={"model": self.config.model, "phase": "prefill"})
            self._m_slo_ttft.observe(
                (now - seq.enqueued_at) * 1e3,
                tags={"model": self.config.model, "phase": "total"})
        if sp.logprobs:
            seq.logprobs.append(self._logprob_of(last, nxt, sp.temperature))
        with self._lock:
            seq.token_versions.append(ver)
            done = self.scheduler.commit_token(seq, nxt)
        self._emit_token(seq, nxt, ver)
        self._note_tokens(1)
        if done:
            self._finalize(seq)

    def _do_decode(self, work: DecodeWork) -> None:
        ver = self._weight_version  # stable: step holds _step_lock
        plain: list[Sequence] = []
        drafted: list[tuple[Sequence, list[int]]] = []
        for s in work.seqs:
            d = self._propose_for(s) if self._proposer is not None else []
            if d:
                drafted.append((s, d))
            else:
                plain.append(s)
        if plain:
            self._decode_plain(plain, ver)
        for s, d in drafted:
            self._verify_one(s, d, ver)

    def _propose_for(self, seq: Sequence) -> list[int]:
        """Draft tokens for one lane, clamped so every drafted write
        position fits the pages the lane owns, stays below
        max_model_len, and cannot overshoot the request's max_tokens:
        under cache pressure the clamp hits zero and the lane decodes
        exactly as without spec."""
        room = min(
            len(seq.table) * self.pool.block_size - seq.pos,
            self.runner.max_model_len - seq.pos,
            seq.sampling.max_tokens - len(seq.generated) - 1)
        k = min(self._spec_k, room)
        if k <= 0:
            return []
        return self._proposer.propose(
            list(seq.prompt) + list(seq.generated), k)[:k]

    def _decode_plain(self, seqs: list[Sequence], ver: int) -> None:
        # the lane feeds generated[-1], which LIVES at absolute position
        # pos-1 (it was sampled but never cached): the position
        # embedding, the context length and the KV scatter all key off
        # that position
        items = [DecodeItem(s.last_token, s.pos - 1, s.table,
                            s.sampling.temperature, s.sampling.top_k,
                            s.sampling.top_p) for s in seqs]
        try:
            next_tokens, logits = self.runner.decode(items)
        except Exception as e:  # noqa: BLE001
            with self._lock:
                for s in seqs:
                    self.scheduler.abort(s, f"error:{e!r}")
            for s in seqs:
                self._finalize(s)
            return
        for i, (s, tok) in enumerate(zip(seqs, next_tokens)):
            if s.sampling.logprobs:
                s.logprobs.append(self._logprob_of(
                    logits[i], tok, s.sampling.temperature))
        now = time.monotonic()
        for s in seqs:
            s.note_phase("decode", now)  # step + its scheduling gap
        finished = []
        with self._lock:
            for s, tok in zip(seqs, next_tokens):
                s.token_versions.append(ver)
                if self.scheduler.commit_token(s, tok):
                    finished.append(s)
        for s, tok in zip(seqs, next_tokens):
            self._emit_token(s, tok, ver)
        self._note_tokens(len(next_tokens))
        for s in finished:
            self._finalize(s)

    def _verify_one(self, seq: Sequence, draft: list[int],
                    ver: int) -> None:
        """One speculative step for one lane: a single verify step
        scores the frontier token plus the drafts, the acceptance rule
        runs on the device, and every returned token is already backed
        by KV; commit them in order (stopping if the lane retires
        mid-run on eos / max_tokens) and emit with explicit indices."""
        sp = seq.sampling
        t0 = time.perf_counter()
        try:
            tokens, logits = self.runner.verify(
                seq.last_token, seq.pos - 1, draft, seq.table,
                sp.temperature, sp.top_k, sp.top_p)
        except Exception as e:  # noqa: BLE001
            with self._lock:
                self.scheduler.abort(seq, f"error:{e!r}")
            self._finalize(seq)
            return
        self._m_verify_ms.observe(
            (time.perf_counter() - t0) * 1e3, tags=self._m_tags)
        n_acc = len(tokens) - 1
        self._spec_proposed_total += len(draft)
        self._spec_accepted_total += n_acc
        self._m_spec_proposed.inc(len(draft), tags=self._m_tags)
        if n_acc:
            self._m_spec_accepted.inc(n_acc, tags=self._m_tags)
        if len(draft) > n_acc:
            self._m_spec_rejected.inc(len(draft) - n_acc,
                                      tags=self._m_tags)
        self._m_spec_ratio.set(
            self._spec_accepted_total
            / max(1, self._spec_proposed_total), tags=self._m_tags)
        seq.note_phase("verify", time.monotonic())
        # the rows stay on the card unless the request wants logprobs
        rows = logits.cpu().numpy() if sp.logprobs else None
        committed: list[int] = []
        done = False
        with self._lock:
            for i, tok in enumerate(tokens):
                if sp.logprobs:
                    seq.logprobs.append(self._logprob_of(
                        rows[i], tok, sp.temperature))
                seq.token_versions.append(ver)
                committed.append(tok)
                if self.scheduler.commit_token(seq, tok):
                    done = True
                    break
        base = len(seq.generated) - len(committed)
        for j, tok in enumerate(committed):
            self._emit_token(seq, tok, ver, index=base + j)
        self._note_tokens(len(committed))
        if done:
            self._finalize(seq)

    # ------------------------------------------------------------ output

    def _logprob_of(self, logits, token: int, temperature: float) -> float:
        """See runner.logprob_at — the ONE logprob definition."""
        return logprob_at(logits, token, temperature,
                          self.model_cfg.vocab_size)

    def _emit_token(self, seq: Sequence, token: int,
                    version: int, index: int | None = None) -> None:
        """`version` is the step-stable weight version the caller read
        under `_step_lock`. `index` is the token's stream position; None
        means the latest (single-token commits): a speculative step
        commits several tokens before emitting and passes each one's
        index."""
        with self._lock:
            stream = self._streams.get(seq.seq_id)
        if stream is not None:
            idx = len(seq.generated) - 1 if index is None else index
            ev = {"token": int(token), "index": idx}
            if seq.sampling.logprobs:
                ev["logprob"] = seq.logprobs[idx]
                ev["weight_version"] = version
            stream._emit(ev)

    def _finalize(self, seq: Sequence) -> None:
        with self._lock:
            stream = self._streams.pop(seq.seq_id, None)
        if stream is None:
            return  # already finalized (idempotent: no double-count)
        outcome = (seq.finish_reason or "unknown").split(":", 1)[0]
        self._m_requests.inc(
            tags={"model": self.config.model, "outcome": outcome})
        # ---- latency attribution: close the waterfall -----------------
        now = time.monotonic()
        # the tail interval (last step end -> this close): queue time if
        # the request never ran (aborted while waiting), else emit
        seq.note_phase("emit" if seq.phases else "queue", now)
        e2e = now - seq.enqueued_at
        breakdown = {k: round(v, 6) for k, v in seq.phases.items()}
        breakdown["e2e"] = round(e2e, 6)
        # speculative steps commit several tokens a verify step, so the
        # verify phase and the full token count both enter TPOT
        dec_s = seq.phases.get("decode", 0.0) + seq.phases.get(
            "verify", 0.0)
        if len(seq.generated) > 1 and dec_s > 0:
            self._m_slo_tpot.observe(
                dec_s * 1e3 / (len(seq.generated) - 1),
                tags=self._m_tags)
        with self._lock:
            self._finished_requests += 1
            for k, v in seq.phases.items():
                self._phase_totals[k] = self._phase_totals.get(k, 0.0) + v
        self._record_request_spans(seq, now)
        versions = sorted(set(seq.token_versions))
        final = {
            "done": True,
            "finish_reason": seq.finish_reason,
            "num_generated": len(seq.generated),
            "token_ids": list(seq.generated),
            "preemptions": seq.preemptions,
            # prompt tokens served from the prefix cache at the last
            # admission (vLLM/OpenAI `cached_tokens` usage field)
            "cached_tokens": seq.cached_tokens,
            # weight-version contract (RL.md): `stale` means the tokens
            # (or the KV they were decoded against) span more than one
            # version
            "weight_version": (versions[-1] if versions
                               else self._weight_version),
            "weight_versions": versions,
            "stale": seq.kv_stale or len(versions) > 1,
        }
        final["breakdown"] = breakdown
        if seq.sampling.echo:
            final["prompt_token_ids"] = list(seq.prompt)
        if seq.sampling.logprobs:
            final["logprobs"] = list(seq.logprobs)
        stream._close(final)

    # deterministic waterfall order for the laid-out request spans
    _PHASE_ORDER = ("queue", "prefix_match", "prefill", "preempt",
                    "decode", "verify", "emit")

    def _record_request_spans(self, seq: Sequence, now: float) -> None:
        """Emit the request's waterfall as child spans: one parent
        `llm.request` over [enqueue, close] plus one child per nonzero
        phase, laid out contiguously in waterfall order (phases
        interleave in real time — chunked prefill alternates with
        decode — so the contiguous layout is the readable summary, and
        the durations are the exact per-phase totals). All hang off the
        request's propagated trace context."""
        from ray_tpu_torch.util import tracing
        from ray_tpu_torch.utils.events import child_trace

        tracing.record_interval("llm.request", seq.enqueued_at, now,
                                category="serve", trace=seq.trace)
        cursor = seq.enqueued_at
        for phase in self._PHASE_ORDER:
            dur = seq.phases.get(phase, 0.0)
            if dur <= 0.0:
                continue
            tracing.record_interval(
                f"llm.request.{phase}", cursor, cursor + dur,
                category="serve", trace=child_trace(seq.trace))
            cursor += dur

    # ------------------------------------------------------------- admin

    @property
    def weight_version(self) -> int:
        return self._weight_version

    def update_weights(self, version: int, params: Any) -> dict:
        """Drain-free weight hot-swap, installed at a step boundary.

        Taking `_step_lock` means no device step is in flight, so every
        token sampled by one decode step carries one weight version.
        Running sequences keep their old-version KV pages and are
        tagged ``stale``; the prefix cache is invalidated, so that no
        later admission matches old-weight KV, and stale sequences stop
        registering pages; `version` must be strictly increasing."""
        from ray_tpu_torch.util import tracing

        t0 = time.perf_counter()
        with self._step_lock:
            if version <= self._weight_version:
                raise ValueError(
                    f"weight version must increase: engine at "
                    f"{self._weight_version}, got {version}")
            with tracing.span("rl.weight_swap"):
                self.runner.set_params(params)
                dropped = self.pool.invalidate_prefix_cache()
                with self._lock:
                    previous = self._weight_version
                    self._weight_version = version
                    running = list(self.scheduler.running)
                    for s in running:
                        s.kv_stale = True
                    in_flight = len(running) + len(self.scheduler.waiting)
        dt = time.perf_counter() - t0
        self._m_swaps.inc(tags=self._m_tags)
        self._m_swap_s.observe(dt, tags=self._m_tags)
        return {"version": version, "previous_version": previous,
                "swap_seconds": dt, "in_flight_streams": in_flight,
                "registrations_dropped": dropped}

    def warmup(self) -> int:
        """Run every bucketed step shape once, so no request pays a
        first-call cost; returns the number of shapes run."""
        with self._step_lock:
            return self.runner.warmup()

    def has_work(self) -> bool:
        with self._lock:
            return bool(self.scheduler.waiting or self.scheduler.running)

    def stats(self) -> dict:
        d = self.scheduler.depth()
        with self._lock:
            phase_totals = dict(self._phase_totals)
            finished = self._finished_requests
        d.update({
            "model": self.config.model,
            "device": str(self.device),
            "block_size": self.pool.block_size,
            "max_batch_size": self.config.max_batch_size,
            "max_model_len": self.runner.max_model_len,
            "weight_version": self._weight_version,
            "phase_seconds": phase_totals,
            "finished_requests": finished,
            "spec_proposed": self._spec_proposed_total,
            "spec_accepted": self._spec_accepted_total,
            "paged_attention": self.runner.use_paged_attention,
        })
        return d

    def abort_request(self, stream: RequestStream,
                      reason: str = "aborted") -> None:
        with self._lock:
            seqs = [s for s in
                    list(self.scheduler.waiting) + self.scheduler.running
                    if s.seq_id == stream.seq_id]
        for s in seqs:
            with self._lock:
                self.scheduler.abort(s, reason)
            self._finalize(s)
