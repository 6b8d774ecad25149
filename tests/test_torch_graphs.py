"""The serving engine's compiled steps (``serve.graphs.StepGraph``) against
the JAX engine, on the CPU.

On the CPU a ``StepGraph`` calls its step on its static buffers without
capture: the binding the card captures and replays.  Through it, the
chunked + prefix-cache engine must emit exactly the JAX engine's greedy
streams (fp32, seeded weights bridged from the JAX init) for the reduced
qwen1.5-0.5b and qwen2-moe-a2.7b, with raw weights over fp32 pages and
with mx4 weights over int8 pages, with kernel routing on (the kernel
path's structure; on CPU tensors each kernel wrapper runs its plain
version).  The binding must give the same streams as ``capture=False``
and under sync dispatch, keep every static buffer at one address across
cycles and bind each step kind once.  The launch counters' replay
bookkeeping is checked as arithmetic here; on the card,
``tests/test_torch_cuda.py`` holds graph against eager (tokens bit for
bit, launch counts, no host sync in a replay, a failed capture).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import RuntimeConfig as JaxRuntimeConfig  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import modules as JM  # noqa: E402
from repro.quant import params as JQP  # noqa: E402
from repro.serve import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serve import build_engine as jax_build_engine  # noqa: E402
from repro.serve.scheduler import Request as JaxRequest  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import ops as TK  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import modules as TM  # noqa: E402
from repro_torch.serve import EngineConfig, Request, build_engine  # noqa
from repro_torch.serve import graphs as G  # noqa: E402

ENGINE = dict(slots=3, cache_len=96, backend="paged", chunked_prefill=True,
              chunk_size=8, prefix_cache=True)
# raw weights over fp32 pages; mx4 weights over int8 pages
FORMATS = {"raw": {}, "mx4": dict(kv_cache_dtype="int8",
                                  quantize_weights="mx4")}
ARCHS = ("qwen1.5-0.5b", "qwen2-moe-a2.7b")
CASES = [(a, f) for a in ARCHS for f in FORMATS]


def trace():
    """A 40-token system prompt (2.5 pages of 16 rows, 1.25 of 32: later
    requests copy-on-write a page) ahead of 24..40-token bodies, then two
    prompts that share 40 tokens and diverge inside the next page."""
    rng = np.random.default_rng(0)
    sysp = rng.integers(1, 500, 40)
    prompts = [np.concatenate([sysp, rng.integers(1, 500, int(n))])
               for n in rng.integers(24, 41, 6)]
    base = rng.integers(1, 500, 72)
    b = base.copy()
    b[40] = 7
    prompts += [np.concatenate([base, [37, 2, 3]]),
                np.concatenate([b, [4, 5, 6]])]
    return [p.astype(np.int32) for p in prompts]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(JAX streams, JAX metrics, port config, bridged port params) of a
    (arch, format), served on demand: the JAX engine on its plain path, on
    its seed-0 init (quantized by the JAX package for mx4)."""
    done = {}

    def serve(arch, fmt):
        if (arch, fmt) in done:
            return done[arch, fmt]
        over = FORMATS[fmt]
        jcfg = dataclasses.replace(jax_reduced(jax_get_config(arch)),
                                   dtype="float32")
        tcfg = dataclasses.replace(reduced(get_config(arch)),
                                   dtype="float32")
        jm = jax_build_model(jcfg, JaxRuntimeConfig(
            remat="none", kv_cache_dtype=over.get("kv_cache_dtype", ""),
            quantize_weights=over.get("quantize_weights", "none")))
        params = JM.unbox(jm.init(jax.random.PRNGKey(0)))
        if fmt != "raw":
            params = JQP.quantize_params(params, fmt=fmt)
        mp = pytest.MonkeyPatch()
        mp.setenv("REPRO_TUNE_CACHE",
                  str(tmp_path_factory.mktemp("tune") / "tune.json"))
        try:
            eng = jax_build_engine(jm, JaxEngineConfig(**ENGINE, **over),
                                   params=params)
            reqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=6)
                    for i, p in enumerate(trace())]
            for r in reqs:
                eng.submit(r)
            assert len(eng.run_until_drained()) == len(reqs)
        finally:
            mp.undo()
        tp = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                               device="cpu", dtype=torch.float32)
        done[arch, fmt] = ({r.rid: r.out for r in reqs}, eng.metrics(),
                           tcfg, tp)
        return done[arch, fmt]
    return serve


def engine(tcfg, tp, fmt, **kw):
    over = {k: v for k, v in kw.items() if k != "capture"}
    return build_engine(build_model(tcfg, params=tp, device="cpu"),
                        EngineConfig(**{**ENGINE, **FORMATS[fmt], **over}),
                        capture=kw.get("capture", True))


def submit(eng):
    reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(trace())]
    for r in reqs:
        eng.submit(r)
    return reqs


def streams(eng):
    reqs = submit(eng)
    with TM.kernel_routing():
        finished = eng.run_until_drained()
    assert len(finished) == len(reqs) and all(r.done for r in reqs)
    return {r.rid: r.out for r in reqs}


@pytest.mark.parametrize("arch,fmt", CASES)
def test_graph_engine_token_identical_to_jax(served, arch, fmt):
    """The static binding emits the JAX engine's greedy streams, binds each
    step kind once and serves the JAX engine's cycles."""
    want, jm, tcfg, tp = served(arch, fmt)
    eng = engine(tcfg, tp, fmt)
    assert eng.captures == {"chunk": 0, "decode": 0}
    assert streams(eng) == want
    assert eng.captures == {"chunk": 1, "decode": 1}
    m = eng.metrics()
    assert m["prefix_hits"] >= 1 and m["cow_copies"] >= 1
    for k in ("prefix_hits", "cow_copies", "chunk_calls", "decode_steps",
              "tokens_generated", "kv_dtype", "page_size"):
        assert m[k] == jm[k], k


@pytest.mark.parametrize("variant", [dict(capture=False),
                                     dict(async_dispatch=False)],
                         ids=["eager", "sync"])
@pytest.mark.parametrize("arch,fmt", CASES)
def test_eager_and_sync_dispatch_give_the_binding_streams(served, arch, fmt,
                                                         variant):
    """``capture=False`` (the eager steps, on fresh tensors each cycle) and
    sync dispatch give the streams of the async static binding."""
    want, _, tcfg, tp = served(arch, fmt)
    eng = engine(tcfg, tp, fmt, **variant)
    assert streams(eng) == want
    bound = 0 if variant.get("capture") is False else 1
    assert eng.captures == {"chunk": bound, "decode": bound}


def static_addresses(eng):
    return {(name, key): t.data_ptr()
            for name, g in (("chunk", eng.chunk_graph),
                            ("decode", eng.decode_graph))
            for key, t in [*(g.inputs or {}).items(), ("out", g.out)]
            if t is not None}


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_static_buffers_keep_their_addresses(served, fmt):
    """Every static input and output keeps its storage across cycles: the
    scheduler copies into the buffers, the step reads them in place."""
    _, _, tcfg, tp = served("qwen1.5-0.5b", fmt)
    eng = engine(tcfg, tp, fmt)
    submit(eng)
    seen = {}
    with TM.kernel_routing():
        while eng.step() is not None:
            for key, ptr in static_addresses(eng).items():
                assert seen.setdefault(key, ptr) == ptr, key
    # every buffer of both graphs, the two outputs included, was bound
    assert len(seen) == 5 + 3 + 2


def test_a_batch_of_another_shape_raises(served):
    """The first batch fixes a step's static shapes and keys."""
    _, _, tcfg, tp = served("qwen1.5-0.5b", "raw")
    eng = engine(tcfg, tp, "raw")
    streams(eng)
    host = {k: np.zeros(tuple(t.shape), np.int32)
            for k, t in eng.decode_graph.inputs.items()}
    host["pos"] = np.zeros(ENGINE["slots"] + 1, np.int32)
    with pytest.raises(ValueError, match="bound to"):
        eng.decode_graph.run(host)
    del host["pos"]
    with pytest.raises(ValueError, match="bound to"):
        eng.decode_graph.run(host)


def test_submit_before_consume_raises(served):
    """The decode graph's tokens are one static buffer: a second submit
    before the first step's tokens are consumed raises."""
    _, _, tcfg, tp = served("qwen1.5-0.5b", "raw")
    eng = engine(tcfg, tp, "raw")
    submit(eng)
    with TM.kernel_routing():
        while eng._inflight is None:      # async: a step stays in flight
            eng.step()
        with pytest.raises(RuntimeError, match="consumed"):
            eng._submit_decode()


def test_replay_bookkeeping_counts_like_the_eager_path():
    """A replay runs no wrapper: ``StepGraph`` takes back the warm-up's and
    the capture's launches and adds the capture's growth at every replay.
    That arithmetic (``_growth``, ``_negated``, ``ops.add_launches``, by
    kernel and ``mx_qgemv``'s by shape) leaves after N replays the counts
    of N eager steps; ``add_launches`` stands in for the wrappers here."""
    step = ({"rmsnorm": 5, "gemv": 7, "mx_qgemv": 2},
            {"fp4 128->512": 2})
    TK.reset_launch_counts()
    TK.add_launches({"gemv": 3}, {"fp4 128->128": 1})     # earlier work
    start = TK.launch_snapshot()
    TK.add_launches(*step)                                 # warm-up
    warm = TK.launch_snapshot()
    TK.add_launches(*step)                                 # capture
    recorded = G._growth(warm, TK.launch_snapshot())
    TK.add_launches(*G._negated(G._growth(start, TK.launch_snapshot())))
    assert TK.launch_snapshot() == start
    assert recorded == step
    for _ in range(3):
        TK.add_launches(*recorded)
    replayed = TK.launch_snapshot()
    TK.reset_launch_counts()
    TK.add_launches({"gemv": 3}, {"fp4 128->128": 1})
    for _ in range(3):
        TK.add_launches(*step)
    assert TK.launch_snapshot() == replayed
    TK.reset_launch_counts()
    assert TK.mx_qgemv_launches_by_shape() == {}
