"""Persistent tuned-config cache + the ``get_tuned`` dispatch lookup.

The port's counterpart of the JAX package's ``repro/tune/cache.py``.
Entries are keyed ``kernel|shapes/dtypes|backend`` and stored as JSON so
tuned configs survive across processes; an in-process LRU view keeps hot
lookups off the disk dict.  The cache path resolves, in order:

  1. an explicit ``path=`` argument,
  2. the ``REPRO_TORCH_TUNE_CACHE`` environment variable,
  3. ``~/.cache/repro_torch/tune_cache.json``.

The two packages keep separate files: their configs are different types
(``LaunchConfig`` here, ``TroopConfig`` there) and must not share entries.
``default_cache()`` returns a per-path singleton, so pointing
``REPRO_TORCH_TUNE_CACHE`` somewhere else (tests, a chip run) yields a
fresh instance without any global reset.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from collections import OrderedDict
from typing import Any, Dict, Optional

from repro_torch.core.troop import LaunchConfig
from repro_torch.tune import registry

ENV_VAR = "REPRO_TORCH_TUNE_CACHE"
LRU_CAPACITY = 256

_CFG_FIELDS = {f.name for f in dataclasses.fields(LaunchConfig)}


def config_to_dict(cfg: LaunchConfig) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def config_from_dict(d: Dict[str, Any]) -> LaunchConfig:
    # tolerate fields added/removed across versions of LaunchConfig
    return LaunchConfig(**{k: v for k, v in d.items() if k in _CFG_FIELDS})


def resolve_path(path: Optional[str] = None) -> str:
    if path:
        return os.path.abspath(os.path.expanduser(path))
    env = os.environ.get(ENV_VAR)
    if env:
        return os.path.abspath(os.path.expanduser(env))
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "tune_cache.json")


class TuneCache:
    """JSON-backed store of tune results with an in-process LRU view."""

    def __init__(self, path: Optional[str] = None,
                 capacity: int = LRU_CAPACITY):
        self.path = resolve_path(path)
        self.capacity = capacity
        self._disk: Dict[str, Dict[str, Any]] = {}
        self._lru: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.load()

    def load(self) -> int:
        """(Re)read the JSON file; returns the number of entries loaded."""
        self._disk = {}
        self._lru.clear()
        try:
            with open(self.path) as f:
                data = json.load(f)
            if isinstance(data, dict):
                self._disk = {k: v for k, v in data.items()
                              if isinstance(v, dict)}
        except (OSError, ValueError):
            pass                          # missing or corrupt -> empty
        return len(self._disk)

    def save(self):
        """Merge-then-atomic-write: re-read the file and overlay our entries
        so concurrent tuning processes don't clobber each other's keys
        (last writer wins only on the *same* key); tmp file + rename keeps
        readers from ever seeing a torn JSON document."""
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        try:
            with open(self.path) as f:
                on_disk = json.load(f)
            if isinstance(on_disk, dict):
                self._disk = {**{k: v for k, v in on_disk.items()
                                 if isinstance(v, dict)}, **self._disk}
        except (OSError, ValueError):
            pass
        fd, tmp = tempfile.mkstemp(dir=d or ".", suffix=".tune.tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self._disk, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def get(self, key: str) -> Optional[Dict[str, Any]]:
        if key in self._lru:
            self._lru.move_to_end(key)
            self.hits += 1
            return self._lru[key]
        if key in self._disk:
            self._touch(key, self._disk[key])
            self.hits += 1
            return self._disk[key]
        self.misses += 1
        return None

    def put(self, key: str, entry: Dict[str, Any]):
        self._disk[key] = entry
        self._touch(key, entry)

    def _touch(self, key: str, entry: Dict[str, Any]):
        self._lru[key] = entry
        self._lru.move_to_end(key)
        while len(self._lru) > self.capacity:
            self._lru.popitem(last=False)

    def clear(self):
        self._disk.clear()
        self._lru.clear()

    def __len__(self) -> int:
        return len(self._disk)

    def __contains__(self, key: str) -> bool:
        return key in self._disk


_instances: Dict[str, TuneCache] = {}


def default_cache(path: Optional[str] = None) -> TuneCache:
    p = resolve_path(path)
    if p not in _instances:
        _instances[p] = TuneCache(p)
    return _instances[p]


def get_tuned(name: str, *args, cache: Optional[TuneCache] = None,
              variant_kwargs: Optional[Dict[str, Any]] = None
              ) -> LaunchConfig:
    """Dispatch lookup: cached best config for (kernel, shapes, backend,
    variant), else the kernel's default.  Args may be real or ``meta``
    tensors — only shapes/dtypes are read.  ``variant_kwargs`` contributes
    the spec's declared ``key_kwargs`` to the key.  Every registered name
    answers, ported or not."""
    spec = registry.get(name)
    c = cache if cache is not None else default_cache()
    entry = c.get(spec.key(*args, kwargs=variant_kwargs))
    if entry is not None and "config" in entry:
        return config_from_dict(entry["config"])
    return spec.heuristic(*args)
