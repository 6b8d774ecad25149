"""The port's bucketed engine (the JAX package's default) against the JAX
engine, on the CPU: qwen1.5-0.5b and qwen2-moe-a2.7b.

One seeded trace of mixed-length prompts (buckets of 4 to 64, a group
smaller than ``prefill_batch``) goes through the JAX engine's bucketed path
and through the port's on the same bridged fp32 weights
(``torch_engine_cases``): on the dense backend (the ``EngineConfig()``
default) with bf16 and with int8 caches, and on the paged backend with
bf16 pages and with int8 pages (filled from int8 prefill caches verbatim,
or from bf16 ones quantized at admission).  The greedy token streams must
be identical, the engines must run the same cycles, prefill calls, prefill
bindings and streamed KV bytes, and the paged allocator must balance after
drain; the port's engine runs with kernel routing off and on (on CPU
tensors each kernel wrapper runs its plain version).  The other dense
archs are in ``test_torch_bucketed_archs.py``.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_engine_cases import (BACKENDS, ENGINE, bridged,  # noqa: E402
                                check_engine, jax_pair, port_model, serve,
                                serve_jax, trace)
from repro_torch.serve import EngineConfig, build_engine  # noqa: E402

ARCHS = ("qwen1.5-0.5b", "qwen2-moe-a2.7b")


@pytest.fixture(scope="module", params=ARCHS)
def served_jax(request, tmp_path_factory):
    arch = request.param
    return (arch, *serve_jax(arch, BACKENDS,
                             tmp_path_factory.mktemp("tune") / "tune.json"))


@pytest.mark.parametrize("routed", [False, True])
@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_bucketed_engine_token_identical_to_jax(served_jax, backend,
                                                routed):
    arch, out, tp = served_jax
    check_engine(arch, backend, routed, out, tp)


def test_pad_rows_of_a_short_group_never_reach_admit(monkeypatch):
    """The last group holds one request and two pad rows: only row 0 of
    its prefill is admitted, and every admitted row is a real prompt's."""
    _, jp = jax_pair("qwen1.5-0.5b", "")
    eng = build_engine(port_model("qwen1.5-0.5b", "",
                                  bridged("qwen1.5-0.5b", jp)),
                       EngineConfig(**ENGINE))
    rows = []
    real = eng.backend.admit

    def spy(caches, prefill_caches, *, row, slot, prompt_len):
        rows.append((row, prompt_len, prefill_caches[0].k.shape[0]))
        return real(caches, prefill_caches, row=row, slot=slot,
                    prompt_len=prompt_len)
    monkeypatch.setattr(eng.backend, "admit", spy)
    serve(eng)
    assert len(rows) == len(trace())
    assert sorted(n for _, n, _ in rows) == sorted(len(p) for p in trace())
    assert all(Bp == 3 for _, _, Bp in rows)
    assert rows[-1][0] == 0
