"""Port serving engine against the JAX engine, plus the port's API rules.

The slice test serves one seeded trace — prompts longer than one slab, a
shared system prompt, a mid-page copy-on-write divergence — through the JAX
chunked + prefix-cache engine (its plain jnp path) and through the port's
engine on the same bridged fp32 weights: the greedy token streams must be
identical and the port's allocator must balance after drain.
"""
import ast
import dataclasses
import re
from pathlib import Path

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
from repro.serve import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serve.kvcache import BlockAllocator as JaxBlockAllocator  # noqa
from repro.serve.kvcache import PrefixIndex as JaxPrefixIndex  # noqa: E402
from repro.serve.scheduler import Request as JaxRequest  # noqa: E402
from repro.serve.scheduler import ServingEngine as JaxEngine  # noqa: E402
from repro.serve.step import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import _NOT_PORTED, get_config, reduced  # noqa
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import modules as TM  # noqa: E402
from repro_torch.serve import (BlockAllocator, EngineConfig,  # noqa: E402
                               PrefixIndex, Request, build_engine)

ROOT = Path(__file__).resolve().parents[1]
ENGINE = dict(slots=3, cache_len=96, backend="paged", chunked_prefill=True,
              chunk_size=8, prefix_cache=True)


def trace():
    """A 20-token system prompt (one full page + 4 rows: later requests
    copy-on-write the second page) ahead of 5..30-token bodies, then two
    prompts that share three pages' worth of tokens but diverge inside the
    third page."""
    rng = np.random.default_rng(0)
    sysp = rng.integers(1, 500, 20)
    prompts = [np.concatenate([sysp, rng.integers(1, 500, int(n))])
               for n in rng.integers(5, 31, 6)]
    base = rng.integers(1, 500, 48)
    b = base.copy()
    b[40] = 7
    prompts += [np.concatenate([base, [37, 2, 3]]),
                np.concatenate([b, [4, 5, 6]])]
    return [p.astype(np.int32) for p in prompts]


@pytest.fixture(scope="module")
def served_jax():
    """The JAX engine's streams + the bridged fp32 weights for the port."""
    cfg = dataclasses.replace(jax_reduced(jax_get_config("qwen1.5-0.5b")),
                              dtype="float32")
    model = jax_build_model(cfg, JaxRuntimeConfig(remat="none"))
    params = JM.unbox(model.init(jax.random.PRNGKey(0)))
    eng = JaxEngine(model, params=params,
                    prefill_step=make_prefill_step(model),
                    serve_step=make_serve_step(model),
                    config=JaxEngineConfig(**ENGINE))
    reqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(trace())]
    for r in reqs:
        eng.submit(r)
    assert len(eng.run_until_drained()) == len(reqs)
    tcfg = dataclasses.replace(reduced(get_config("qwen1.5-0.5b")),
                               dtype="float32")
    tp = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                           device="cpu")
    return {r.rid: r.out for r in reqs}, eng.metrics(), tcfg, tp


def serve_port(tcfg, tp, routed=False, **over):
    eng = build_engine(build_model(tcfg, params=tp, device="cpu"),
                       EngineConfig(**{**ENGINE, **over}))
    reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(trace())]
    for r in reqs:
        eng.submit(r)
    with TM.kernel_routing(routed):
        finished = eng.run_until_drained()
    assert len(finished) == len(reqs) and all(r.done for r in reqs)
    return {r.rid: r.out for r in reqs}, eng


@pytest.mark.parametrize("routed", [False, True])
def test_engine_token_identical_to_jax(served_jax, routed):
    want, jm, tcfg, tp = served_jax
    got, eng = serve_port(tcfg, tp, routed=routed)
    assert got == want
    m = eng.metrics()
    assert m["prefix_hits"] >= 1 and m["cow_copies"] >= 2
    for k in ("prefix_hits", "cow_copies", "prefix_shared_tokens",
              "chunk_calls", "decode_steps", "tokens_generated"):
        assert m[k] == jm[k], k
    # allocator balance: after drain only the index holds pages (1 ref)
    be = eng.backend
    total = be.spec.num_pages - 1
    assert be.allocator.num_free == total - be.prefix_index.num_pages
    assert all(n == 1 for n in be.allocator._refs.values())
    be.prefix_index.clear()
    assert be.allocator.num_free == total


def test_async_and_sync_dispatch_identical(served_jax):
    want, _, tcfg, tp = served_jax
    got, _ = serve_port(tcfg, tp, async_dispatch=False)
    assert got == want


def test_host_paging_matches_jax():
    """Allocator + radix index hand out the same pages as the JAX ones."""
    outs = []
    for Alloc, Index in ((JaxBlockAllocator, JaxPrefixIndex),
                         (BlockAllocator, PrefixIndex)):
        al = Alloc(12)
        ix = Index(4, al)
        a = al.alloc(3)
        ix.insert(list(range(12)), a)
        hit = ix.match(list(range(10)) + [99, 98])
        al.free(a)
        evicted = ix.evict(2)
        outs.append((a, hit, evicted, al.num_free, dict(al._refs)))
    assert outs[0] == outs[1]


# ------------------------------------------------------------- API + rules
BAD_CONFIGS = [
    dict(backend="ring"),
    dict(chunked_prefill=True),
    dict(prefix_cache=True),
    dict(kernel_decode=True),
    dict(speculate_k=-1),
    dict(backend="paged", speculate_k=2),
    dict(backend="paged", chunked_prefill=True, speculate_k=2, tp=2),
    dict(draft_arch="qwen1.5-0.5b"),
    dict(tp=0),
    dict(quantize_weights="int3"),
    dict(quantize_weights="mx4", tp=2),
]


@pytest.mark.parametrize("kw", BAD_CONFIGS)
def test_engine_config_validate_matches_jax(kw):
    with pytest.raises(ValueError) as want:
        JaxEngineConfig(**kw).validate()
    with pytest.raises(ValueError) as got:
        EngineConfig(**kw).validate()
    assert str(got.value) == str(want.value)
    assert [f.name for f in dataclasses.fields(EngineConfig)] == \
        [f.name for f in dataclasses.fields(JaxEngineConfig)]


@pytest.mark.parametrize("kw", [
    dict(),                                              # dense backend
    dict(backend="paged"),                               # bucketed prefill
    dict(backend="paged", chunked_prefill=True, temperature=0.7),
    dict(backend="paged", chunked_prefill=True, quantize_weights="int4"),
    dict(backend="paged", chunked_prefill=True, quantize_weights="int8"),
    dict(backend="paged", chunked_prefill=True, tp=2),
])
def test_unported_options_raise_naming_roadmap(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        EngineConfig(**kw).validate().check_ported()


NO_SHARED_EXPERT = "qwen2-moe-a2.7b without its shared expert"


@pytest.mark.parametrize("arch", sorted(_NOT_PORTED) + [NO_SHARED_EXPERT])
def test_unported_arch_raises_naming_roadmap(arch):
    """Every JAX-package arch id the port does not serve yet raises naming
    its ROADMAP item, and so does a MoE of another shape than qwen2-moe's."""
    if arch != NO_SHARED_EXPERT:
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP {re.escape(_NOT_PORTED[arch])}"):
            get_config(arch)
        return
    cfg = reduced(get_config("qwen2-moe-a2.7b"))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_shared_experts=0, shared_d_ff=0,
        shared_expert_gate=False))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 13"):
        build_model(cfg, device="cpu")


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("qwen1.5-0.5b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_engine(cfg, EngineConfig(backend="paged",
                                       chunked_prefill=True))
    with pytest.raises(SystemExit):
        launcher.main(["--arch", "qwen1.5-0.5b", "--smoke",
                       "--chunked-prefill"])
    assert build_model(cfg, device="cpu").device.type == "cpu"


def launcher_smoke(capsys, arch, quant):
    rc = launcher.main(["--arch", arch, "--smoke",
                        "--chunked-prefill", "--prefix-cache",
                        "--kernel-decode", "--device", "cpu",
                        "--requests", "4", "--max-new", "4", *quant])
    assert rc == 0
    return capsys.readouterr().out


QUANT = [[], ["--quantize-weights", "mx4", "--kv-cache-dtype", "int8"]]


@pytest.mark.parametrize("quant", QUANT)
def test_launcher_smoke_on_cpu(capsys, quant):
    out = launcher_smoke(capsys, "qwen1.5-0.5b", quant)
    assert "served 4/4 requests" in out
    if quant:
        assert "quantized 15 weight leaves (mx4)" in out
        assert '"kv_dtype": "int8"' in out and '"page_size": 32' in out


@pytest.mark.parametrize("quant", QUANT)
def test_moe_launcher_smoke_on_cpu(capsys, quant):
    """Per layer q/k/v/o, three expert stacks and the shared expert's three
    quantize (router and shared gate stay raw), + lm_head."""
    out = launcher_smoke(capsys, "qwen2-moe-a2.7b", quant)
    assert "served 4/4 requests" in out
    if quant:
        assert "quantized 21 weight leaves (mx4)" in out
        assert '"kv_dtype": "int8"' in out and '"page_size": 32' in out


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_nothing_of_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = [(f.name, m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []
