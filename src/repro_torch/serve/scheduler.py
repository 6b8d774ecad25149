"""Continuous-batching serving engine: bucketed or chunked prefill over
dense or paged KV.

The port of the JAX package's ``serve/scheduler.py`` (one device).  Two
admission paths:

* **bucketed** (the default): queued prompts are right-padded to
  power-of-2 length buckets and prefilled together, ``prefill_batch`` at a
  time, in one full-sequence step per group — one prefill graph per
  bucket, ever.  The prefill's dense caches are then spliced into the
  admitted slots (dense backend) or scattered into their pages (paged
  backend), and the first token is the greedy argmax of each prompt's last
  row;
* **chunked** (``chunked_prefill=True``, paged backend only): prompts are
  fed through the model as fixed-size token slabs interleaved with decode
  steps; with ``prefix_cache=True`` the paged pool shares prompt prefixes
  across requests (radix index + refcounted pages + copy-on-write at a
  mid-page divergence, ``serve.kvcache``) and a prefix hit starts the
  chunk walk at the first un-cached token.

Scheduling policy: admission, chunk order and capacity-pressure deferral
are strictly FIFO; each chunked cycle runs at most ``chunks_per_step``
prefill slabs and then one decode step over every decoding slot.  Decode is
greedy, or samples at ``temperature`` from a stateless counter-based
sampler keyed by each admission's nonce (``serve.step.sample``).

Compiled steps (the default): the prefill steps (one per bucket, or the
chunk step) and the decode step run as CUDA graphs
(``serve.graphs.StepGraph``), each captured once at its fixed shapes on
its first call and replayed after, as the JAX scheduler ``jax.jit``s its
steps; the scheduler hands them host arrays.  The bucket graphs share one
memory pool.  On the CPU the same binding calls the steps on their static
buffers.  ``capture=False`` steps eagerly, launch by launch from Python:
the port's counterpart of ``jax.disable_jit()``.

Async dispatch (the default): graph replays and PyTorch launches are
asynchronous, so the decode step submitted in cycle N (``_submit_decode``,
which never waits on the device) is consumed at the start of cycle N+1
(``_consume``, whose ``.cpu()`` of the tokens is the engine's sync point),
and the chunked engine's host-side admission overlaps the in-flight step.
Host->device inputs go through pinned memory with non-blocking copies for
the same reason.  The decode graph's tokens are one static buffer, so a
cycle consumes them before it submits the next step.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.serve.config import EngineConfig
from repro_torch.serve.graphs import StepGraph
from repro_torch.serve.kvcache import (PagedBackend, bucket_length,
                                      copy_page, kv_row_bytes, make_backend)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (T,) int32
    max_new_tokens: int = 16
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # lifecycle metadata (*_step counters are engine cycles; *_t markers are
    # wall-clock perf_counter seconds)
    submit_step: int = -1
    admit_step: int = -1
    first_token_step: int = -1
    finish_step: int = -1
    submit_t: float = 0.0
    admit_t: float = 0.0
    first_token_t: float = 0.0
    finish_t: float = 0.0

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def ttft_s(self) -> float:
        """Time to first token: submit -> first generated token."""
        return self.first_token_t - self.submit_t

    @property
    def decode_tok_s(self) -> float:
        """Steady-state decode rate: tokens after the first, per second."""
        dt = self.finish_t - self.first_token_t
        return (len(self.out) - 1) / dt if dt > 0 and len(self.out) > 1 \
            else 0.0


class ServingEngine:
    """Slot-based continuous batching over the cache backend
    ``config.backend`` names (``serve.kvcache.make_backend``), bucketed or
    chunked as ``config.chunked_prefill`` says.  ``model`` is a
    ``repro_torch.models.Model``; the engine runs on the model's device.
    ``troop_configs`` (``serve.step.tuned_kernel_configs``, which
    ``build_engine`` resolves) sets the kernels' launch parameters; without
    them they launch with ``LaunchConfig()``.  The steps run as captured
    CUDA graphs (on the CPU: bound to static buffers) unless
    ``capture=False``, which steps eagerly."""

    def __init__(self, model, config: EngineConfig, troop_configs=None, *,
                 capture: bool = True):
        config.validate().check_ported()
        self.backend = backend = make_backend(config)
        self.config = config
        self.chunked = config.chunked_prefill
        slots, cache_len = config.slots, config.cache_len
        if isinstance(backend, PagedBackend) and backend.kv_dtype is None:
            backend.kv_dtype = model.rt.kv_dtype()
        self.kv_dtype = getattr(backend, "kv_dtype", None) \
            or model.rt.kv_dtype()
        from repro_torch.serve.step import (launch_config, make_chunk_step,
                                            make_prefill_step,
                                            make_serve_step)
        launch = launch_config(troop_configs, self.kv_dtype)
        self.prefill_step = make_prefill_step(model, launch)
        self.chunk_step = make_chunk_step(model, launch)
        self.serve_step = make_serve_step(model,
                                          temperature=config.temperature,
                                          seed=config.seed,
                                          troop_configs=troop_configs,
                                          launch=launch)

        self.model = model
        self.device = model.device
        self.slots = slots
        self.cache_len = cache_len
        self.prefill_batch = config.prefill_batch or min(slots, 4)
        self.min_bucket = min(config.min_bucket, cache_len)
        self.chunk_size = min(config.chunk_size, cache_len)
        self.chunks_per_step = max(1, config.chunks_per_step)
        self._async = bool(config.async_dispatch)
        self._sampled = config.temperature > 0
        if self.chunked and self.kv_dtype == "int8":
            # int8 pools: stage this request's own rows in bf16 so a later
            # chunk never re-reads its predecessors quantized
            backend.chunk_stage = self.chunk_size
        self.caches = backend.init_caches(model, slots, cache_len)
        self.capture = capture
        self.chunk_graph = self.decode_graph = None
        self.prefill_graphs: Dict[int, StepGraph] = {}
        self._prefill_pool = None
        if capture:
            if self.chunked:
                self.chunk_graph = StepGraph(self.chunk_step, self.caches,
                                             self.device)
            self.decode_graph = StepGraph(self.serve_step, self.caches,
                                          self.device)
        self._kv_row_bytes = kv_row_bytes(model.cfg, self.kv_dtype)

        self.active: Dict[int, Optional[Request]] = {
            i: None for i in range(slots)}
        self.pos = np.zeros((slots,), np.int32)
        self.last_tok = np.zeros((slots,), np.int32)
        # per-admission nonce: a request reusing a slot must not replay its
        # predecessor's sampling randomness at equal positions
        self._nonce = np.zeros((slots,), np.int32)
        self._admission_seq = 0            # the nonce source; never resets
        self.queue: deque = deque()
        self.stop_token = config.stop_token
        self.steps = 0                     # engine cycles (admit/chunk/decode)
        self.decode_steps = 0              # cycles that ran serve_step
        self._prefilling: deque = deque()            # slots mid-prefill
        self._decoding: set = set()                  # slots generating
        self._chunk_off: Dict[int, int] = {}         # next token to prefill
        self._stage_base: Dict[int, int] = {}        # first non-shared pos
        self._inflight = None
        # metrics
        self.tokens_generated = 0
        self.requests_admitted = 0
        self.requests_finished = 0
        self.deferrals = 0
        self.prefill_calls = 0
        self.prefill_buckets: Dict[int, int] = {}    # bucketed calls a bucket
        self.prefill_s = 0.0
        self.decode_s = 0.0
        self.chunk_calls = 0
        self.chunk_tokens = 0
        self.prefill_tokens = 0
        self.shared_tokens = 0
        self.kv_bytes_streamed = 0
        self.host_overlap_s = 0.0
        self.stream_wait_s = 0.0
        self._ttfts: deque = deque(maxlen=config.metrics_window)
        self._decode_rates: deque = deque(maxlen=config.metrics_window)

    # ---------------------------------------------------------- device I/O
    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without waiting on the device: a
        pinned staging copy and a non-blocking transfer on the current
        stream (a pageable copy would synchronize the stream)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t.clone()
        return t.pin_memory().to(self.device, non_blocking=True)

    def _run(self, graph: Optional[StepGraph], step, host) -> torch.Tensor:
        """One step on the host arrays ``host``: through its graph, or
        eagerly on fresh device tensors when the engine does not capture."""
        if graph is not None:
            return graph.run(host)
        tok, self.caches = step({k: self._dev(a) for k, a in host.items()},
                                self.caches)
        return tok

    @property
    def captures(self):
        """Bindings of each step kind (``StepGraph.captures``): a chunked
        engine's ``{"chunk": n, "decode": n}``, one each once it has run
        both; a bucketed engine's ``{"prefill": {bucket: n}, "decode":
        n}``, one for each bucket it has prefilled; none with
        ``capture=False``."""
        decode = 0 if self.decode_graph is None else \
            self.decode_graph.captures
        if self.chunked:
            chunk = 0 if self.chunk_graph is None else \
                self.chunk_graph.captures
            return {"chunk": chunk, "decode": decode}
        return {"prefill": {b: g.captures
                            for b, g in sorted(self.prefill_graphs.items())},
                "decode": decode}

    @property
    def prefill_traces(self) -> int:
        """Prefill steps bound so far: one per bucket used (bucketed), one
        in all (chunked); 0 with ``capture=False``."""
        if self.chunked:
            return self.captures["chunk"]
        return sum(self.captures["prefill"].values())

    def _graphs(self) -> List[StepGraph]:
        return [g for g in (self.chunk_graph, self.decode_graph,
                            *self.prefill_graphs.values()) if g is not None]

    def _prefill(self, bucket: int, host):
        """The bucketed prefill step on ``host``: through its bucket's graph
        (bound on first use, on the pool the bucket graphs share), or
        eagerly.  Returns (next tokens, prefill caches)."""
        if not self.capture:
            return self.prefill_step(
                {k: self._dev(a) for k, a in host.items()})
        graph = self.prefill_graphs.get(bucket)
        if graph is None:
            if self.device.type == "cuda" and self._prefill_pool is None:
                self._prefill_pool = torch.cuda.graph_pool_handle()
            graph = StepGraph(self.prefill_step, None, self.device,
                              pool=self._prefill_pool)
            self.prefill_graphs[bucket] = graph
        tok = graph.run(host)
        return tok, graph.caches_out

    # -------------------------------------------------------------- admit
    def submit(self, req: Request):
        # impossible requests fail here, loudly — once queued, a request is
        # only ever deferred (transient pool pressure), never dropped
        if req.prompt_len >= self.cache_len:
            raise ValueError(
                f"prompt needs {req.prompt_len} cache rows but cache_len is "
                f"{self.cache_len}")
        self.backend.check_admissible(req.prompt_len + req.max_new_tokens)
        req.submit_step = self.steps
        req.submit_t = time.perf_counter()
        self.queue.append(req)

    def _free_slots(self) -> List[int]:
        return [s for s, r in self.active.items() if r is None]

    def _admit_group(self, group, slots_for) -> List[Request]:
        """One bucketed batched prefill for ``group`` (a list of Requests);
        returns the requests whose first token already finished them (stop
        token, or ``max_new_tokens`` 1).  A group smaller than
        ``prefill_batch`` is padded with one-token rows that are never
        admitted."""
        bucket = max(bucket_length(r.prompt_len, self.min_bucket,
                                   self.cache_len) for r in group)
        Bp = self.prefill_batch
        tokens = np.zeros((Bp, bucket), np.int32)
        lengths = np.ones((Bp,), np.int32)
        for i, req in enumerate(group):
            tokens[i, :req.prompt_len] = req.prompt
            lengths[i] = req.prompt_len
        t0 = time.perf_counter()
        next_tok, prefill_caches = self._prefill(
            bucket, {"tokens": tokens, "length": lengths})
        next_tok = next_tok.cpu().numpy()
        self.prefill_calls += 1
        self.prefill_buckets[bucket] = self.prefill_buckets.get(bucket, 0) + 1

        finished: List[Request] = []
        for i, req in enumerate(group):
            slot = slots_for[i]
            # eager, not captured: the slot and its pages are host integers
            self.caches = self.backend.admit(
                self.caches, prefill_caches, row=i, slot=slot,
                prompt_len=req.prompt_len)
            self.active[slot] = req
            req.admit_step = self.steps
            req.admit_t = time.perf_counter()
            self.requests_admitted += 1
            self._admission_seq += 1
            self.prefill_tokens += req.prompt_len
            self._nonce[slot] = self._admission_seq
            self.pos[slot] = req.prompt_len
            tok = int(next_tok[i])
            req.out.append(tok)
            req.first_token_step = self.steps
            req.first_token_t = time.perf_counter()
            self.tokens_generated += 1
            self.last_tok[slot] = tok
            # the first token obeys the decode tokens' finish rules (both
            # prefill paths emit the same streams)
            if len(req.out) >= req.max_new_tokens or tok == self.stop_token:
                finished.append(self._finish(slot, req))
            else:
                self._decoding.add(slot)
        self.prefill_s += time.perf_counter() - t0
        return finished

    def _admit(self) -> List[Request]:
        """Admit as many queued requests as slots and cache capacity allow
        (possibly several bucketed prefill calls); returns the requests
        their first token already finished."""
        finished: List[Request] = []
        while self.queue:
            free = self._free_slots()
            if not free:
                break
            group, slots_for = self._gather_group(free)
            if not group:
                break
            finished.extend(self._admit_group(group, slots_for))
        return finished

    def _gather_group(self, free):
        """Pop a bucketed-prefill admission group off the queue, FIFO: a
        request the backend cannot hold now ends the group and stays at
        the head of the queue."""
        group, slots_for = [], []
        while self.queue and free and len(group) < self.prefill_batch:
            req = self.queue[0]
            slot = free[0]
            if not self.backend.reserve(slot, req.prompt_len
                                        + req.max_new_tokens):
                self._defer()
                break
            self.queue.popleft()
            free.pop(0)
            group.append(req)
            slots_for.append(slot)
        return group, slots_for

    def _admit_chunked(self, count_defer: bool = True):
        """Assign slots + pages to queued requests, strictly FIFO: a
        request the pool cannot hold right now blocks admission until
        releases free pages (the starvation guard)."""
        while self.queue:
            free = self._free_slots()
            if not free:
                return
            req = self.queue[0]
            slot = free[0]
            need = req.prompt_len + req.max_new_tokens
            if self.backend.prefix_cache:
                offset = self.backend.reserve_with_prefix(
                    slot, need, req.prompt)
                if offset is None:
                    self._defer(count_defer)
                    return                 # pool exhausted: defer (FIFO)
                cow = self.backend.take_cow(slot)
                if cow is not None:
                    src, dst = cow
                    # eager, not captured: rare, and its pages are host
                    # integers (a graph would need them as device buffers)
                    copy_page(self.caches, src, dst)
                    self.backend.cow_done(slot)
            else:
                if not self.backend.reserve(slot, need):
                    self._defer(count_defer)
                    return
                offset = 0
            self.queue.popleft()
            self.active[slot] = req
            req.admit_step = self.steps
            req.admit_t = time.perf_counter()
            self.requests_admitted += 1
            self._admission_seq += 1
            self._nonce[slot] = self._admission_seq
            self.prefill_tokens += req.prompt_len
            self.shared_tokens += offset
            self.pos[slot] = 0
            self._chunk_off[slot] = offset
            self._stage_base[slot] = offset
            self._prefilling.append(slot)

    def _defer(self, count: bool = True):
        """Head-of-queue request cannot reserve pages this cycle.  The
        early admission pass (``count=False``) retries after the in-flight
        decode is consumed, and only the retry counts."""
        if count:
            self.deferrals += 1

    def _chunk_one(self) -> List[Request]:
        """Run one prefill slab for the oldest mid-prefill request; on the
        prompt's final slab, emit its first token."""
        slot = self._prefilling[0]
        req = self.active[slot]
        C = self.chunk_size
        off = self._chunk_off[slot]
        end = min(off + C, req.prompt_len)
        valid = end - off
        tokens = np.zeros((1, C), np.int32)
        tokens[0, :valid] = req.prompt[off:end]
        host = {"tokens": tokens,
                "offset": np.asarray([off], np.int32),
                "valid": np.asarray([valid], np.int32),
                "stage_base": np.asarray([self._stage_base[slot]], np.int32),
                "block_tables": self.backend.block_tables[slot:slot + 1]}
        t0 = time.perf_counter()
        next_tok = self._run(self.chunk_graph, self.chunk_step, host)
        self.prefill_s += time.perf_counter() - t0
        self.chunk_calls += 1
        self.chunk_tokens += valid
        self._chunk_off[slot] = end
        if end < req.prompt_len:
            return []
        # prompt fully on-pool: index its pages for prefix reuse, start
        # decoding from its first generated token
        self._prefilling.popleft()
        if self.backend.prefix_cache:
            self.backend.register_prefix(slot, req.prompt)
        self.prefill_calls += 1
        tok = int(next_tok.cpu()[0])
        req.out.append(tok)
        req.first_token_step = self.steps
        req.first_token_t = time.perf_counter()
        self.tokens_generated += 1
        self.last_tok[slot] = tok
        self.pos[slot] = req.prompt_len
        if len(req.out) >= req.max_new_tokens or tok == self.stop_token:
            return [self._finish(slot, req)]
        self._decoding.add(slot)
        return []

    def _finish(self, slot: int, req: Request) -> Request:
        req.done = True
        req.finish_step = self.steps
        req.finish_t = time.perf_counter()
        self.active[slot] = None
        self._decoding.discard(slot)
        self.backend.release(slot)
        self.requests_finished += 1
        if req.out and req.first_token_t > 0.0:
            self._ttfts.append(req.ttft_s)
        if len(req.out) > 1 and req.finish_t > req.first_token_t:
            self._decode_rates.append(req.decode_tok_s)
        return req

    # -------------------------------------------------------------- decode
    def _decode_block_tables(self) -> np.ndarray:
        """Block tables for the decode batch: slots that are not decoding
        (idle or mid-prefill) are masked to the NULL page, so the garbage
        rows the step computes for them never write a live page.  (The
        bucketed engine has no slot mid-prefill and releases a finished
        slot's table to NULL, so the mask changes nothing there: the JAX
        package passes it the tables unmasked.)"""
        bt = self.backend.block_tables
        mask = np.zeros((self.slots, 1), bt.dtype)
        for s in self._decoding:
            mask[s] = 1
        return bt * mask

    def _submit_decode(self):
        """Enqueue one decode step over the decoding slots and return
        without waiting on the device: the token tensor, the decoding-slot
        snapshot and the submit timestamps park in ``_inflight`` until
        ``_consume`` reads the tokens.  The decode graph writes them to one
        static buffer, so the step before must have been consumed."""
        if self._inflight is not None:
            raise RuntimeError("a decode step is submitted before the last "
                               "one's tokens were consumed")
        host = {"tokens": self.last_tok[:, None], "pos": self.pos}
        if isinstance(self.backend, PagedBackend):
            host["block_tables"] = self._decode_block_tables()
        if self._sampled:
            host["sample_nonce"] = self._nonce
        t0 = time.perf_counter()
        next_tok = self._run(self.decode_graph, self.serve_step, host)
        t_sub = time.perf_counter()
        rows = int(sum(int(self.pos[s]) + 1 for s in self._decoding))
        self.kv_bytes_streamed += rows * self._kv_row_bytes
        self._inflight = (next_tok, tuple(sorted(self._decoding)), t0, t_sub)

    def _consume(self) -> List[Request]:
        """Wait for the in-flight decode step's tokens (the engine's sync
        point) and apply them to the slots that were decoding at submit."""
        if self._inflight is None:
            return []
        next_tok, slots, t0, t_sub = self._inflight
        self._inflight = None
        t_wait = time.perf_counter()
        toks = next_tok.cpu().numpy()[:, 0]        # stream-out: blocks
        t_done = time.perf_counter()
        if self._async:
            self.host_overlap_s += max(0.0, t_wait - t_sub)
        self.stream_wait_s += t_done - t_wait
        self.decode_s += (t_sub - t0) + (t_done - t_wait)
        self.decode_steps += 1
        finished: List[Request] = []
        for slot in slots:
            req = self.active[slot]
            tok = int(toks[slot])
            req.out.append(tok)
            self.tokens_generated += 1
            self.last_tok[slot] = tok
            self.pos[slot] += 1
            if len(req.out) >= req.max_new_tokens or tok == self.stop_token \
                    or self.pos[slot] >= self.cache_len - 1:
                finished.append(self._finish(slot, req))
        return finished

    def step(self) -> Optional[List[Request]]:
        """One engine cycle: admit, run prefill slabs, then decode every
        generating slot.  Returns the requests that finished this cycle, or
        ``None`` when the engine is idle."""
        finished: List[Request] = []
        if self.chunked:
            if self._inflight is not None:
                # overlap host-side admission with the in-flight decode; a
                # deferral here is retried (and counted) after consume
                self._admit_chunked(count_defer=False)
            finished.extend(self._consume())
            self._admit_chunked()
            chunk_finished: List[Request] = []
            for _ in range(self.chunks_per_step):
                if not self._prefilling:
                    break
                chunk_finished.extend(self._chunk_one())
            # a finish above may unblock a deferred reservation
            if chunk_finished:
                self._admit_chunked()
            finished.extend(chunk_finished)
        else:
            finished.extend(self._consume())
            finished.extend(self._admit())
        if not self._decoding:
            if self._prefilling or finished:
                self.steps += 1
                return finished
            return None
        self._submit_decode()
        if not self._async:
            finished.extend(self._consume())
        self.steps += 1
        return finished

    def run_until_drained(self, max_steps: int = 10_000) -> List[Request]:
        """Run until queue + slots are empty (or ``max_steps`` cycles have
        run in this call); returns every request that finished."""
        finished: List[Request] = []
        start = self.steps
        while (self.queue or any(r is not None
                                 for r in self.active.values())):
            if self.steps - start >= max_steps:
                break
            out = self.step()
            if out is None:
                break
            finished.extend(out)
        return finished

    # ------------------------------------------------------------- metrics
    def metrics(self) -> Dict[str, object]:
        """Engine throughput/latency counters + backend occupancy.  Times
        are host wall-clock seconds."""
        busy = self.decode_s + self.prefill_s
        m = {
            "engine_cycles": self.steps,
            "decode_steps": self.decode_steps,
            "tokens_generated": self.tokens_generated,
            "requests_admitted": self.requests_admitted,
            "requests_finished": self.requests_finished,
            "prefill_calls": self.prefill_calls,
            "prefill_s": self.prefill_s,
            "decode_s": self.decode_s,
            "decode_steps_per_s": (self.decode_steps / self.decode_s
                                   if self.decode_s else 0.0),
            "tokens_per_s": self.tokens_generated / busy if busy else 0.0,
            "deferrals": self.deferrals,
            "async_dispatch": self._async,
            "kv_bytes_streamed": self.kv_bytes_streamed,
            "host_overlap_s": self.host_overlap_s,
            "stream_wait_s": self.stream_wait_s,
            "ttft_s_mean": (float(np.mean(self._ttfts))
                            if self._ttfts else 0.0),
            "ttft_s_p95": (float(np.percentile(self._ttfts, 95))
                           if self._ttfts else 0.0),
            "decode_tok_s_mean": (float(np.mean(self._decode_rates))
                                  if self._decode_rates else 0.0),
            "prefill_traces": self.prefill_traces,
            "prefill_buckets": dict(sorted(self.prefill_buckets.items())),
            "capture_s": sum(g.capture_s for g in self._graphs()),
        }
        if self.chunked:
            m.update({
                "chunked_prefill": True,
                "chunk_size": self.chunk_size,
                "chunk_calls": self.chunk_calls,
                "chunk_utilization": (
                    self.chunk_tokens / (self.chunk_calls * self.chunk_size)
                    if self.chunk_calls else 0.0),
                "prefix_hit_rate": (self.shared_tokens / self.prefill_tokens
                                    if self.prefill_tokens else 0.0),
            })
        m.update(self.backend.stats())
        return m
