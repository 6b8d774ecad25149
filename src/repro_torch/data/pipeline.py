"""Deterministic synthetic data pipeline: sharded, prefetched, checkpointable.

A copy of ``repro.data.pipeline`` whose batches are numpy (the same
``default_rng`` seeding per (step, shard), so the token stream is the JAX
package's byte for byte): any restart from a checkpoint regenerates
byte-identical batches.  ``PrefetchIterator`` and ``to_device`` put batches
on the port's device.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, resolve_device


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend_tokens: int = 0      # vision stub prefix
    frontend_dim: int = 0
    enc_frames: int = 0           # whisper stub frames
    prefetch: int = 2


class SyntheticLM:
    """Markov-ish synthetic LM stream: next-token structure so loss can fall."""

    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1):
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        assert cfg.global_batch % num_shards == 0
        self.local_batch = cfg.global_batch // num_shards
        self.step = 0

    def state_dict(self):
        return {"step": self.step, "shard": self.shard,
                "num_shards": self.num_shards}

    def load_state_dict(self, st):
        assert st["num_shards"] == self.num_shards, "reshard via set_step"
        self.step = st["step"]

    def set_step(self, step: int):
        self.step = step

    def _rng(self, step):
        return np.random.default_rng(
            (self.cfg.seed * 1_000_003 + step) * 65_537 + self.shard)

    def batch_at(self, step: int) -> dict:
        c = self.cfg
        rng = self._rng(step)
        B, T, V = self.local_batch, c.seq_len, c.vocab_size
        # structured stream: tokens follow t_{i+1} = (a*t_i + b) % Veff with
        # noise — learnable short-range structure.
        veff = min(V, 4096)
        a = 1 + 4 * rng.integers(1, 8)
        b = rng.integers(1, veff)
        t0 = rng.integers(0, veff, size=(B, 1))
        toks = [t0]
        for _ in range(T):
            nxt = (a * toks[-1] + b) % veff
            flip = rng.random((B, 1)) < 0.1
            nxt = np.where(flip, rng.integers(0, veff, size=(B, 1)), nxt)
            toks.append(nxt)
        seq = np.concatenate(toks, axis=1).astype(np.int32)
        batch = {"tokens": seq[:, :T], "targets": seq[:, 1:T + 1]}
        if c.frontend_tokens:
            batch["frontend"] = rng.standard_normal(
                (B, c.frontend_tokens, c.frontend_dim)).astype(np.float32)
        if c.enc_frames:
            batch["frontend"] = rng.standard_normal(
                (B, c.enc_frames, c.frontend_dim)).astype(np.float32)
        return batch

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()

    def next_batch(self) -> dict:
        b = self.batch_at(self.step)
        self.step += 1
        return b


def to_device(batch: Dict[str, np.ndarray],
              device: torch.device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``.  To the card through pinned
    memory without waiting (``non_blocking``): the copy queues behind the
    step in flight instead of synchronizing the host with it."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = (t.pin_memory().to(device, non_blocking=True)
                  if device.type == "cuda" else t.to(device))
    return out


class PrefetchIterator:
    """Background-thread prefetch (overlaps host datagen with device step):
    batches arrive as tensors on ``device`` (the CUDA card unless
    ``device="cpu"``)."""

    def __init__(self, source: SyntheticLM, device: DeviceLike = None,
                 depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        dev = resolve_device(device)
        self.device_put = lambda b: to_device(b, dev)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self):
        while not self._stop.is_set():
            batch = self.source.next_batch()
            try:
                self.q.put(self.device_put(batch), timeout=1.0)
            except queue.Full:
                if self._stop.is_set():
                    return
                self.q.put(self.device_put(batch))

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            self.q.get_nowait()
        except queue.Empty:
            pass
