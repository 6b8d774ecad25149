"""The port's bucketed engine against the JAX engine, on the CPU: the
other dense archs at their group sizes — glm4-9b (G = 16), qwen3-14b
(G = 5, qk-norm) and qwen1.5-32b (MHA), reduced as in
``test_torch_archs.py``.

The same trace and checks as ``test_torch_bucketed_engine.py``
(``torch_engine_cases``) on the dense backend (the ``EngineConfig()``
default) and on the paged backend with bf16 and int8 pages: identical
greedy streams and counters, one prefill binding a bucket, a balanced
allocator.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_engine_cases import check_engine, serve_jax  # noqa: E402

ARCHS = ("glm4-9b", "qwen3-14b", "qwen1.5-32b")
BACKENDS = ("dense", "paged", "paged int8")


@pytest.fixture(scope="module", params=ARCHS)
def served_jax(request, tmp_path_factory):
    arch = request.param
    return (arch, *serve_jax(arch, BACKENDS,
                             tmp_path_factory.mktemp("tune") / "tune.json"))


@pytest.mark.parametrize("routed", [False, True])
@pytest.mark.parametrize("backend", BACKENDS)
def test_bucketed_engine_token_identical_to_jax(served_jax, backend,
                                                routed):
    arch, out, tp = served_jax
    check_engine(arch, backend, routed, out, tp)
