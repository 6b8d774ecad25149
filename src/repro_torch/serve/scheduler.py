"""Continuous-batching serving engine: chunked prefill over paged KV.

The port of the chunked path of the JAX package's ``serve/scheduler.py``.
Prompts are fed through the model as fixed-size token slabs interleaved with
decode steps; with ``prefix_cache=True`` the paged pool shares prompt
prefixes across requests (radix index + refcounted pages + copy-on-write at
a mid-page divergence, ``serve.kvcache``) and a prefix hit starts the chunk
walk at the first un-cached token.

Scheduling policy: admission, chunk order and capacity-pressure deferral
are strictly FIFO; each cycle runs at most ``chunks_per_step`` prefill slabs
and then one decode step over every decoding slot.

Async dispatch (the default): PyTorch launches are asynchronous already,
so the decode step submitted in cycle N (``_submit_decode``, which never
waits on the device) is consumed at the start of cycle N+1 (``_consume``,
whose ``.cpu()`` of the tokens is the engine's sync point), and host-side
admission overlaps the in-flight step.  Host->device inputs go through
pinned memory with non-blocking copies for the same reason.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.serve.config import EngineConfig, resolve_page_size
from repro_torch.serve.kvcache import PagedBackend, copy_page, kv_row_bytes


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
    """Slot-based continuous batching with chunked prefill over a
    ``PagedBackend`` shaped by ``config``.  ``model`` is a
    ``repro_torch.models.Model``; the engine runs on the model's device.
    ``troop_configs`` (``serve.step.tuned_kernel_configs``, which
    ``build_engine`` resolves) sets the kernels' launch parameters; without
    them they launch with ``LaunchConfig()``."""

    def __init__(self, model, config: EngineConfig, troop_configs=None):
        config.validate().check_ported()
        self.backend = PagedBackend(
            page_size=resolve_page_size(config), num_pages=config.num_pages,
            kv_dtype="int8" if config.kv_cache_dtype == "int8" else None,
            prefix_cache=config.prefix_cache)
        self.config = config
        slots, cache_len = config.slots, config.cache_len
        from repro_torch.serve.step import (launch_config, make_chunk_step,
                                            make_serve_step)
        launch = launch_config(
            troop_configs, self.backend.kv_dtype or model.rt.kv_dtype())
        self.chunk_step = make_chunk_step(model, launch)
        self.serve_step = make_serve_step(model,
                                          temperature=config.temperature,
                                          troop_configs=troop_configs,
                                          launch=launch)

        self.model = model
        self.device = model.device
        self.slots = slots
        self.cache_len = cache_len
        self.chunk_size = min(config.chunk_size, cache_len)
        self.chunks_per_step = max(1, config.chunks_per_step)
        self._async = bool(config.async_dispatch)
        if (self.backend.kv_dtype or model.rt.kv_dtype()) == "int8":
            # int8 pools: stage this request's own rows in bf16 so a later
            # chunk never re-reads its predecessors quantized
            self.backend.chunk_stage = self.chunk_size
        self.caches = self.backend.init_caches(model, slots, cache_len)
        self.kv_dtype = self.backend.kv_dtype
        self._kv_row_bytes = kv_row_bytes(model.cfg, self.kv_dtype)

        self.active: Dict[int, Optional[Request]] = {
            i: None for i in range(slots)}
        self.pos = np.zeros((slots,), np.int32)
        self.last_tok = np.zeros((slots,), np.int32)
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
        batch = {
            "tokens": self._dev(tokens),
            "offset": self._dev(np.asarray([off], np.int32)),
            "valid": self._dev(np.asarray([valid], np.int32)),
            "stage_base": self._dev(np.asarray([self._stage_base[slot]],
                                               np.int32)),
            "block_tables": self._dev(
                self.backend.block_tables[slot:slot + 1]),
        }
        t0 = time.perf_counter()
        next_tok, self.caches = self.chunk_step(batch, self.caches)
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
        rows the step computes for them never write a live page."""
        bt = self.backend.block_tables
        mask = np.zeros((self.slots, 1), bt.dtype)
        for s in self._decoding:
            mask[s] = 1
        return bt * mask

    def _submit_decode(self):
        """Enqueue one decode step over the decoding slots and return
        without waiting on the device: the token tensor, the decoding-slot
        snapshot and the submit timestamps park in ``_inflight`` until
        ``_consume`` reads the tokens."""
        batch = {"tokens": self._dev(self.last_tok[:, None]),
                 "pos": self._dev(self.pos),
                 "block_tables": self._dev(self._decode_block_tables())}
        t0 = time.perf_counter()
        next_tok, self.caches = self.serve_step(batch, self.caches)
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
            "chunked_prefill": True,
            "chunk_size": self.chunk_size,
            "chunk_calls": self.chunk_calls,
            "chunk_utilization": (
                self.chunk_tokens / (self.chunk_calls * self.chunk_size)
                if self.chunk_calls else 0.0),
            "prefix_hit_rate": (self.shared_tokens / self.prefill_tokens
                                if self.prefill_tokens else 0.0),
        }
        m.update(self.backend.stats())
        return m
