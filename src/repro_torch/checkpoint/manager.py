"""Checkpointing: atomic, async, keep-k.

The port of ``repro.checkpoint.manager``, on the same layout: one directory
per step (``step_00000042/``) holding ``manifest.json`` (keys, shapes,
dtypes, the caller's ``extra``) and one ``leaf_XXXXX.npy`` per tensor.
Writes go to a ``.tmp`` directory first and are renamed into place (atomic
with respect to crashes); in async mode the files are written by a thread
off the training loop (the copy to the host is the only synchronous part,
and a copy it is, also for CPU tensors: the loop updates its tensors in
place while the thread writes).
A tree is a dict from the port's own names (parameters and optimizer
state) to tensors.  ``restore`` copies the stored values into the
template's tensors in place, so the model keeps its parameter objects and
nothing the size of the model is allocated twice.  bf16 tensors, which
numpy lacks, are stored as their 16-bit patterns under the dtype name
``bfloat16``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Dict, Optional

import numpy as np
import torch


def _to_host(t: torch.Tensor):
    """A host copy of ``t`` that owns its memory: the caller goes on
    updating ``t`` in place while the writer thread saves the copy (for a
    CPU tensor ``.cpu()`` would return the same storage)."""
    t = t.detach()
    bf16 = t.dtype == torch.bfloat16
    a = (t.view(torch.int16) if bf16 else t).cpu().numpy()
    if t.device.type == "cpu":
        a = a.copy()
    return a, "bfloat16" if bf16 else str(a.dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Dict[str, torch.Tensor],
             extra: Optional[dict] = None):
        self.wait()                       # one in-flight save at a time
        keys = list(tree)
        host = [_to_host(tree[k]) for k in keys]

        def write():
            tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
            final = os.path.join(self.dir, f"step_{step:08d}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            manifest = {"step": step, "extra": extra or {}, "leaves": []}
            for i, (k, (arr, dtype)) in enumerate(zip(keys, host)):
                np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
                manifest["leaves"].append(
                    {"key": k, "shape": list(arr.shape), "dtype": dtype})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    @torch.no_grad()
    def restore(self, template: Dict[str, torch.Tensor],
                step: Optional[int] = None):
        """Copy step ``step`` (default: the latest) into the tensors of
        ``template``, whose keys must be the checkpoint's, in order; returns
        (template, extra)."""
        step = self.latest_step() if step is None else step
        assert step is not None, "no checkpoint found"
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        assert list(template) == [l["key"] for l in manifest["leaves"]], \
            "checkpoint/template tree mismatch"
        for i, (k, leaf) in enumerate(zip(template, manifest["leaves"])):
            src = torch.from_numpy(np.load(os.path.join(
                d, f"leaf_{i:05d}.npy")))
            if leaf["dtype"] == "bfloat16":
                src = src.view(torch.bfloat16)
            dst = template[k]
            assert tuple(dst.shape) == tuple(leaf["shape"]), \
                f"{k}: checkpoint shape {leaf['shape']}, template " \
                f"{tuple(dst.shape)}"
            dst.copy_(src)
        return template, manifest["extra"]
