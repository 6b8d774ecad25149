"""Serving steps captured as CUDA graphs: the port's counterpart of the JAX
scheduler's ``jax.jit`` of its steps (``repro.serve.scheduler``:
``jax.jit(serve_step, donate_argnums=(2,))``, and the chunk step compiled
the same way).

A ``StepGraph`` binds a step function ``(batch, caches) -> (tokens,
caches)`` to one static device buffer per batch key, to the caches (which
the step updates in place: JAX's donation) and to one static output.  The
first batch fixes the buffers' shapes and dtypes, the engine's fixed
shapes; a later batch of another shape raises.  ``run(host_arrays)``
copies each host array into its buffer and runs the step:

* on the card, the first ``run`` binds the graph: one eager warm-up step on
  that batch (it fills the wrappers' cached host queries,
  ``_build.resident`` and ``sm_count``, and loads the kernel libraries
  outside the capture), then one capture with ``torch.cuda.graph`` on a
  private memory pool, then the replay; every later ``run`` replays.  The
  warm-up and the first replay run the same step on the same inputs: a
  serving step writes its KV rows (and its pad and idle rows into the
  NULL page) before it reads them, and accumulates nothing, so running it
  twice leaves the caches as running it once does.  A warm-up on other
  inputs would leave other rows in the NULL page, which idle slots read
  back and route through a MoE, whose capacity their rows share with the
  live ones.  A capture or a replay that fails raises: nothing here steps
  eagerly in its place;
* on the CPU (which the caller has to ask for) it calls the step on its
  static buffers, without capture, and copies the tokens into its static
  output.

``captures`` counts the bindings, as the JAX scheduler counts traces:
CUDA-graph captures on the card, the first call on the CPU; ``capture_s``
is the host seconds the card's warm-up and capture took.  A replay runs
no Python wrapper, so the kernels' launch counters
(``kernels.ops.launch_counts``) would not see it: the warm-up and the
capture leave the counters as they found them, and every replay adds the
launches the capture recorded, so the counters still count device
launches.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch


def _growth(before, after):
    """The launches (by kernel, and ``mx_qgemv``'s by shape) from the
    ``ops.launch_snapshot()`` ``before`` to ``after``."""
    (c0, s0), (c1, s1) = before, after
    return ({k: n - c0[k] for k, n in c1.items() if n != c0[k]},
            {k: n - s0.get(k, 0) for k, n in s1.items()
             if n != s0.get(k, 0)})


def _negated(growth):
    counts, by_shape = growth
    return ({k: -n for k, n in counts.items()},
            {k: -n for k, n in by_shape.items()})


class StepGraph:
    """One serving step bound to static buffers on ``device`` (the
    engine's); see the module docstring."""

    def __init__(self, step, caches, device: torch.device):
        self.step = step
        self.caches = caches
        self.device = device
        self.inputs = None
        self.out = None
        self.captures = 0
        self.capture_s = 0.0
        self._graph = None
        self._routed = None           # kernel routing at capture
        self._replay_launches = None  # launches one replay makes

    def run(self, host: Dict[str, np.ndarray]) -> torch.Tensor:
        """Copy ``host`` into the static buffers and run the step; returns
        the static output (overwritten by the next ``run``)."""
        if self.inputs is None:
            self.inputs = {k: torch.tensor(np.ascontiguousarray(a),
                                           device=self.device)
                           for k, a in host.items()}
        else:
            self._copy_in(host)
        if self.device.type != "cuda":
            tok, _ = self.step(self.inputs, self.caches)
            if self.out is None:
                self.out = tok
                self.captures += 1
            else:
                self.out.copy_(tok)
            return self.out
        from repro_torch.kernels import ops
        from repro_torch.models import modules as M
        if self._graph is None:
            self._capture()
        elif M.kernel_routed() != self._routed:
            raise RuntimeError(
                f"this step was captured with kernel routing "
                f"{self._routed}; it cannot replay with routing "
                f"{M.kernel_routed()} (build another engine)")
        self._graph.replay()
        ops.add_launches(*self._replay_launches)
        return self.out

    def _copy_in(self, host):
        """Each host array into its buffer: on the card from freshly pinned
        memory, non-blocking on the current stream (stream order puts it
        after the last replay that read the buffer)."""
        if host.keys() != self.inputs.keys():
            raise ValueError(f"batch keys {sorted(host)}; the step is bound "
                             f"to {sorted(self.inputs)}")
        for key, buf in self.inputs.items():
            a = np.ascontiguousarray(host[key])
            if a.shape != tuple(buf.shape):
                raise ValueError(f"batch[{key!r}] has shape {a.shape}; the "
                                 f"step is bound to {tuple(buf.shape)}")
            t = torch.from_numpy(a)
            if self.device.type == "cuda":
                buf.copy_(t.pin_memory(), non_blocking=True)
            else:
                buf.copy_(t)

    def _capture(self):
        from repro_torch.kernels import ops
        from repro_torch.models import modules as M
        dev = self.device
        t0 = time.perf_counter()
        start = ops.launch_snapshot()
        try:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self.step(self.inputs, self.caches)          # warm-up
            torch.cuda.current_stream(dev).wait_stream(side)
            warm = ops.launch_snapshot()
            graph = torch.cuda.CUDAGraph()
            # torch.cuda.graph synchronizes and empties the allocator's
            # cache first: the warm-up's blocks go back to the card before
            # the graph's private pool takes its own, so capture holds no
            # second copy of a step's working set (the dequantized stacks)
            with torch.cuda.graph(graph):
                out, _ = self.step(self.inputs, self.caches)
            recorded = _growth(warm, ops.launch_snapshot())
        finally:
            ops.add_launches(*_negated(_growth(start,
                                               ops.launch_snapshot())))
        self._graph, self.out = graph, out
        self._routed = M.kernel_routed()
        self._replay_launches = recorded
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
