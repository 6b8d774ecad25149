"""The port's training path against the JAX package, on the CPU.

The same numpy inputs and the same (bridged) fp32 weights go through the JAX
function and its counterpart in the port.  Tolerances, each with its reason:

* ``ref.fused_adamw``, the kernel's plain version and the optimizers:
  rtol 1e-6 and an atol of 4e-7 times the tensor's largest magnitude
  (``OPT_TOL``: ~3 fp32 ulps at its scale) — the same fp32 operations in
  the same order, but XLA may contract a multiply and an add into one
  rounding, and the bias correction ``1 - b1 ** t`` comes from two
  ``pow``s; measured: parameters 1.2e-7 apart (one ulp at 1), moments
  3.5e-7 relative.  bf16 masters: one bf16 ulp (rtol 8e-3) — an fp32
  result an ulp apart can round to the neighbouring bf16 value.
* loss and gradients of the reduced fp32 qwen1.5-0.5b: rtol 1e-4, atol
  1e-6 — fp32 forward and backward through 2 layers, summed in other
  orders (the forward tolerance of ``test_torch_models.py``'s whole steps).
* three train steps: losses and gradient norms rtol 1e-5 (measured 2.5e-7
  and 8e-7).  Parameters: every element within 1e-4 (4% of the 2.5e-3
  that the three steps' learning rates sum to; measured 4.1e-5), and all
  but 1 in 1000 within 1e-6 (measured 1.6 in 10,000).  Adam divides by the
  gradient's own running scale, so an element whose gradient is at the
  level of the rounding noise moves by a noise-driven fraction of lr: the
  key biases (their gradient is zero in exact arithmetic, softmax being
  shift-invariant per query) and a few MLP weights.
* the Trainer's recovery: the JAX test's own rtol 1e-5, atol 1e-6.
"""
import dataclasses
import io
import json
import os
import threading
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JaxCkpt  # noqa
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core.troop import TroopConfig  # noqa: E402
from repro.data.pipeline import DataConfig as JaxDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro.kernels.fused_adamw import fused_adamw as jax_fused  # noqa: E402
from repro.models import RuntimeConfig as JaxRuntimeConfig  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import modules as JM  # noqa: E402
from repro.optim import adamw as JO  # noqa: E402
from repro.train import losses as JL  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro_torch.bridge import (opt_state_from_numpy,  # noqa: E402
                                params_from_numpy)
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data import (DataConfig, PrefetchIterator,  # noqa: E402
                              SyntheticLM, to_device)
from repro_torch.ft import (FailureInjector, StepWatchdog,  # noqa: E402
                            elastic_meshes, reshard_tree)
from repro_torch.kernels import ops as TK  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import RuntimeConfig, build_model  # noqa: E402
from repro_torch.optim import (OptConfig, clip_by_global_norm,  # noqa: E402
                               global_norm, leaf_groups, lr_at,
                               make_optimizer)
from repro_torch.train import (Trainer, TrainerConfig,  # noqa: E402
                               make_eval_step, make_loss_fn, make_train_step)
from repro_torch.train.losses import token_accuracy  # noqa: E402

HP = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, wd=0.1,
          bc1=1 - 0.9 ** 3, bc2=1 - 0.95 ** 3)
OPT_TOL = dict(rtol=1e-6, scaled_atol=4e-7)
BF16_TOL = dict(rtol=8e-3, atol=1e-9)


@pytest.fixture
def jax_tune_cache(monkeypatch, tmp_path):
    """The JAX fused route dispatches its Pallas kernel through the tune
    cache: point it at an empty file so the lookup is the heuristic."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax params, port cfg): reduced qwen1.5-0.5b in fp32 and
    JAX's seed-0 init."""
    jcfg = dataclasses.replace(jax_reduced(jax_get_config("qwen1.5-0.5b")),
                               dtype="float32")
    tcfg = dataclasses.replace(reduced(get_config("qwen1.5-0.5b")),
                               dtype="float32")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jm = jax_build_model(jcfg, JaxRuntimeConfig(remat="none"))
    jp = JM.unbox(jm.init(jax.random.PRNGKey(0)))
    return jcfg, jp, tcfg


def masters(jp, tcfg):
    """A fresh port copy of the JAX parameters (fp32 masters)."""
    return params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                             device="cpu", trainable=True)


def by_name(tree, tcfg):
    """A JAX tree shaped like the parameters (weights, gradients, moments),
    keyed by the port's parameter names."""
    p = params_from_numpy(jax.tree.map(np.asarray, tree), tcfg, device="cpu",
                          dtype=torch.float32)
    return {k: v.detach().numpy() for k, v in p.named_parameters()}


def allclose(got, want, rtol, atol=0.0, scaled_atol=0.0, err_msg=""):
    """assert_allclose with an atol of ``scaled_atol`` x max |want| added."""
    want = np.asarray(want, np.float32)
    atol = atol + scaled_atol * float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=atol, err_msg=err_msg)


def close_named(got, want, **tol):
    assert list(got) == list(want)
    for k in got:
        g = got[k].detach().float().numpy() if isinstance(got[k],
                                                          torch.Tensor) \
            else got[k]
        allclose(g, want[k], err_msg=k, **tol)


def batch_np(vocab, B=2, T=16, step=0):
    return SyntheticLM(DataConfig(vocab_size=vocab, seq_len=T,
                                  global_batch=B)).batch_at(step)


def adam_case(rng, n, dtype):
    p = rng.standard_normal(n).astype(np.float32)
    g = (0.1 * rng.standard_normal(n)).astype(np.float32)
    mu = (0.01 * rng.standard_normal(n)).astype(np.float32)
    nu = (1e-4 * rng.random(n)).astype(np.float32)
    if dtype == "bfloat16":
        p = np.asarray(jnp.asarray(p, jnp.bfloat16).astype(jnp.float32))
        g = np.asarray(jnp.asarray(g, jnp.bfloat16).astype(jnp.float32))
    return p, g, mu, nu


def jt(a, dtype="float32"):
    return jnp.asarray(a, jnp.float32).astype(dtype)


def tt(a, dtype="float32"):
    return torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))


# --------------------------------------------------------------- fused_adamw
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_fused_adamw_matches_jax_oracle(dtype):
    p, g, mu, nu = adam_case(np.random.default_rng(0), 1000, dtype)
    want = JR.fused_adamw(jt(p, dtype), jt(g, dtype), jt(mu), jt(nu), **HP)
    got = TR.fused_adamw(tt(p, dtype), tt(g, dtype), tt(mu), tt(nu), **HP)
    assert got[0].dtype == getattr(torch, dtype)
    tol = BF16_TOL if dtype == "bfloat16" else OPT_TOL
    allclose(got[0].float().numpy(), want[0], **tol)
    for a, b in zip(got[1:], want[1:]):
        allclose(a.numpy(), b, **OPT_TOL)


@pytest.mark.parametrize("streams", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_adamw_wrapper_matches_interpret_pallas(streams, dtype):
    """The wrapper on CPU tensors (the kernel's plain version, in place, over
    a list of tensors: one JAX leaf) against the interpret-mode Pallas
    kernel on each tensor; sizes that are not multiples of 128 (with an
    even number of 128-lane rows: the JAX kernel's two streams split the
    rows in halves and refuse an odd count)."""
    rng = np.random.default_rng(1)
    shapes = [(3, 333), (5, 77), (2, 5, 13)]
    cases = [adam_case(rng, int(np.prod(s)), dtype) for s in shapes]
    hyper = torch.tensor([HP[k] for k in ("lr", "b1", "b2", "eps", "wd",
                                          "bc1", "bc2")], dtype=torch.float32)
    ps = [tt(c[0], dtype).reshape(s) for c, s in zip(cases, shapes)]
    gs = [tt(c[1], dtype).reshape(s) for c, s in zip(cases, shapes)]
    mus = [tt(c[2]).reshape(s) for c, s in zip(cases, shapes)]
    nus = [tt(c[3]).reshape(s) for c, s in zip(cases, shapes)]
    before = TK.launch_counts()["fused_adamw"]
    TK.fused_adamw(ps, gs, mus, nus, hyper)
    assert TK.launch_counts()["fused_adamw"] == before   # CPU: plain, no
    #   launch
    cfg = TroopConfig(streams=streams, interpret=True)
    for (p, g, mu, nu), s, tp, tm, tn in zip(cases, shapes, ps, mus, nus):
        wp, wm, wn = jax_fused(jt(p, dtype).reshape(s),
                               jt(g, dtype).reshape(s), jt(mu).reshape(s),
                               jt(nu).reshape(s), **HP, cfg=cfg)
        tol = BF16_TOL if dtype == "bfloat16" else OPT_TOL
        allclose(tp.float().numpy(), wp, **tol)
        allclose(tm.numpy(), wm, **OPT_TOL)
        allclose(tn.numpy(), wn, **OPT_TOL)


def test_fused_adamw_wrapper_refuses_mismatched_lists():
    t = torch.zeros(4)
    with pytest.raises(ValueError):
        TK.fused_adamw([t, t], [t], [t], [t], torch.zeros(7))


# ----------------------------------------------------------------- optimizer
def test_leaf_groups_are_the_jax_leaves(pair):
    """24 layers of per-layer tensors group into the JAX tree's 15 leaves
    (layers stacked) — one fused launch each."""
    jcfg, _, tcfg = pair
    cfg = dataclasses.replace(tcfg, num_layers=24)
    jleaves = jax.eval_shape(lambda: JM.unbox(jax_build_model(
        dataclasses.replace(jcfg, num_layers=24)).init(
            jax.random.PRNGKey(0))))
    model = build_model(cfg, RuntimeConfig(remat="none"), device="cpu",
                        trainable=True)
    groups = leaf_groups(dict(model.params.named_parameters()))
    assert len(groups) == len(jax.tree.leaves(jleaves)) == 15
    assert sorted(len(v) for v in groups.values()) == [1] * 3 + [24] * 12
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in model.params.parameters())


def test_lr_schedule_matches_jax():
    cfg = OptConfig(lr=3e-4, warmup_steps=10, decay_steps=50)
    jcfg = JO.OptConfig(lr=3e-4, warmup_steps=10, decay_steps=50)
    steps = np.arange(0, 70, 3, dtype=np.int32)
    got = lr_at(cfg, torch.from_numpy(steps)).numpy()
    want = np.asarray(JO.lr_at(jcfg, jnp.asarray(steps)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def grads_like(jp, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: jnp.asarray(
        scale * rng.standard_normal(p.shape), jnp.float32), jp)


def test_global_norm_and_clip_match_jax(pair):
    _, jp, tcfg = pair
    jg = grads_like(jp, 3, scale=1.0)
    g = {k: torch.from_numpy(v.copy()) for k, v in by_name(jg, tcfg).items()}
    np.testing.assert_allclose(float(global_norm(g)),
                               float(JO.global_norm(jg)), rtol=1e-6)
    want, wnorm = JO.clip_by_global_norm(jg, 1.0)
    got, norm = clip_by_global_norm(g, 1.0)
    np.testing.assert_allclose(float(norm), float(wnorm), rtol=1e-6)
    close_named(got, by_name(want, tcfg), rtol=2e-7, atol=1e-9)


@pytest.mark.parametrize("name,fused", [("adamw", False), ("adamw", True),
                                        ("lion", False), ("sgdm", False)])
def test_optimizer_matches_jax_over_4_steps(pair, jax_tune_cache, name,
                                            fused):
    _, jp, tcfg = pair
    kw = dict(name=name, lr=1e-2, warmup_steps=1, fused=fused)
    jopt, opt = JO.make_optimizer(JO.OptConfig(**kw)), \
        make_optimizer(OptConfig(**kw))
    params = masters(jp, tcfg)
    js, st = jopt.init(jp), opt.init(params)
    launches = TK.launch_counts()["fused_adamw"]
    for i in range(4):
        jg = grads_like(jp, 10 + i)
        g = {k: torch.from_numpy(v.copy())
             for k, v in by_name(jg, tcfg).items()}
        jp, js, jlr = jopt.update(jg, js, jp)
        params, st, lr = opt.update(g, st, params)
        np.testing.assert_allclose(float(lr), float(jlr), rtol=1e-6)
    assert TK.launch_counts()["fused_adamw"] == launches
    assert int(st.step) == int(js.step) == 4
    close_named(dict(params.named_parameters()), by_name(jp, tcfg),
                **OPT_TOL)
    close_named(st.mu, by_name(js.mu, tcfg), **OPT_TOL)
    if name == "adamw":
        close_named(st.nu, by_name(js.nu, tcfg), **OPT_TOL)
    else:
        assert st.nu is None and js.nu is None


def test_opt_state_from_numpy_carries_a_jax_state(pair):
    _, jp, tcfg = pair
    jopt = JO.make_optimizer(JO.OptConfig(lr=1e-2, warmup_steps=1))
    _, js, _ = jopt.update(grads_like(jp, 5), jopt.init(jp), jp)
    st = opt_state_from_numpy(jax.tree.map(np.asarray, js), tcfg,
                              device="cpu")
    assert st.step.dtype == torch.int32 and int(st.step) == 1
    names = [k for k, _ in masters(jp, tcfg).named_parameters()]
    assert list(st.mu) == list(st.nu) == names
    close_named(st.mu, by_name(js.mu, tcfg), rtol=0, atol=0)
    close_named(st.nu, by_name(js.nu, tcfg), rtol=0, atol=0)


@pytest.mark.parametrize("name,fused", [("adamw", False), ("adamw", True),
                                        ("lion", False), ("sgdm", False)])
def test_update_keeps_its_state_whether_or_not_it_is_kept(pair, name, fused):
    """``update`` advances the step counter in place, as it does the
    moments: a caller that drops the returned state ends where one that
    keeps it does."""
    _, jp, tcfg = pair
    opt = make_optimizer(OptConfig(name=name, lr=1e-2, warmup_steps=1,
                                   fused=fused))
    kept, dropped = masters(jp, tcfg), masters(jp, tcfg)
    sk, sd = opt.init(kept), opt.init(dropped)
    for i in range(3):
        g = {k: torch.from_numpy(v.copy())
             for k, v in by_name(grads_like(jp, 30 + i), tcfg).items()}
        kept, sk, _ = opt.update(g, sk, kept)
        opt.update(g, sd, dropped)
    assert int(sd.step) == int(sk.step) == 3
    close_named(dict(dropped.named_parameters()),
                {k: v.detach().numpy() for k, v in kept.named_parameters()},
                rtol=0)
    close_named(sd.mu, {k: v.numpy() for k, v in sk.mu.items()}, rtol=0)


# ------------------------------------------------------ loss and gradients
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("remat,loss_chunk", [("none", 0), ("full", 0),
                                              ("dots", 0), ("dots", 8)])
def test_loss_and_grads_match_jax(pair, remat, loss_chunk):
    jcfg, jp, tcfg = pair
    jm = jax_build_model(jcfg, JaxRuntimeConfig(remat=remat,
                                                loss_chunk=loss_chunk))
    b = batch_np(tcfg.vocab_size)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (jloss, jaux), jgrads = jax.value_and_grad(
        JS.make_loss_fn(jm, jm.rt), has_aux=True)(jp, jb)

    model = build_model(tcfg, RuntimeConfig(remat=remat,
                                            loss_chunk=loss_chunk),
                        params=masters(jp, tcfg), device="cpu",
                        trainable=True)
    loss, aux = make_loss_fn(model, model.rt)(model.params,
                                              to_device(b, model.device))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux["xent"].detach()),
                               float(jaux["xent"]), rtol=1e-5)
    close_named({k: p.grad for k, p in model.params.named_parameters()},
                by_name(jgrads, tcfg), **LOSS_TOL)
    if loss_chunk == 0:
        logits, _ = model.train_logits(to_device(b, model.device))
        jlogits, _ = jm.train_logits(jp, jb)
        np.testing.assert_allclose(logits.detach().numpy(),
                                   np.asarray(jlogits), **LOSS_TOL)


def test_eval_step_and_token_accuracy_match_jax(pair):
    jcfg, jp, tcfg = pair
    jm = jax_build_model(jcfg, JaxRuntimeConfig(remat="none"))
    b = batch_np(tcfg.vocab_size, step=3)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    model = build_model(tcfg, RuntimeConfig(remat="none"),
                        params=masters(jp, tcfg), device="cpu",
                        trainable=True)
    tb = to_device(b, model.device)
    got = make_eval_step(model)(model.params, tb)
    want = JS.make_eval_step(jm)(jp, jb)
    assert sorted(got) == sorted(want) == ["aux", "loss", "xent"]
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)
    logits, _ = model.train_logits(tb)
    np.testing.assert_allclose(
        float(token_accuracy(logits, tb["targets"])),
        float(JL.token_accuracy(jm.train_logits(jp, jb)[0], jb["targets"])),
        rtol=0, atol=1 / b["targets"].size)


@pytest.mark.parametrize("fused,microbatches", [(False, 1), (True, 1),
                                                (True, 2)])
def test_three_train_steps_match_jax(pair, jax_tune_cache, fused,
                                     microbatches):
    jcfg, jp, tcfg = pair
    ocfg = dict(lr=1e-3, warmup_steps=2, fused=fused)
    jm = jax_build_model(jcfg, JaxRuntimeConfig(remat="dots"))
    jstep, jopt = JS.make_train_step(jm, JO.OptConfig(**ocfg),
                                     microbatches=microbatches)
    model = build_model(tcfg, RuntimeConfig(remat="dots"),
                        params=masters(jp, tcfg), device="cpu",
                        trainable=True)
    step, opt = make_train_step(model, OptConfig(**ocfg),
                                microbatches=microbatches)
    js, st = jopt.init(jp), opt.init(model.params)
    params = model.params
    for i in range(3):
        b = batch_np(tcfg.vocab_size, B=4, step=i)
        jp, js, jmet = jstep(jp, js, {k: jnp.asarray(v)
                                      for k, v in b.items()})
        params, st, met = step(params, st, to_device(b, model.device))
        for k in ("loss", "xent", "grad_norm", "lr"):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                       rtol=1e-5, err_msg=k)
    want = by_name(jp, tcfg)
    close_named(dict(params.named_parameters()), want, rtol=0, atol=1e-4)
    diff = np.concatenate([np.abs(p.detach().numpy() - want[k]).ravel()
                           for k, p in params.named_parameters()])
    assert (diff > 1e-6).mean() < 1e-3
    assert all(p.grad is None for p in params.parameters())


def test_remat_modes_give_one_gradient(pair):
    """none, full and dots recompute, never change, the gradients."""
    _, jp, tcfg = pair
    b = batch_np(tcfg.vocab_size)
    grads = []
    for remat in ("none", "full", "dots"):
        m = build_model(tcfg, RuntimeConfig(remat=remat),
                        params=masters(jp, tcfg), device="cpu",
                        trainable=True)
        loss, _ = make_loss_fn(m, m.rt)(m.params, to_device(b, m.device))
        loss.backward()
        grads.append({k: p.grad.clone()
                      for k, p in m.params.named_parameters()})
    for g in grads[1:]:
        for k in g:
            torch.testing.assert_close(g[k], grads[0][k], rtol=0, atol=0)


def test_training_leaves_serving_weights_alone(pair):
    """A serving build still holds frozen weights cast once to the compute
    dtype; only a trainable build holds fp32 masters that require grad."""
    _, jp, _ = pair
    cfg = reduced(get_config("qwen1.5-0.5b"))
    serve = build_model(cfg, device="cpu")
    w = serve.params["layers"][0]["mixer"]["wq"]["w"]
    assert w.dtype == torch.bfloat16 and not w.requires_grad
    train = build_model(cfg, device="cpu", trainable=True)
    w = train.params["layers"][0]["mixer"]["wq"]["w"]
    assert w.dtype == torch.float32 and w.requires_grad
    # the same seed gives the same weights, cast once for serving
    torch.testing.assert_close(
        train.params["lm_head"]["w"].detach().to(torch.bfloat16),
        serve.params["lm_head"]["w"], rtol=0, atol=0)
    fresh = train.init(0)
    torch.testing.assert_close(fresh["lm_head"]["w"],
                               train.params["lm_head"]["w"], rtol=0, atol=0)


# --------------------------------------------------------------------- data
@pytest.mark.parametrize("kw", [dict(vocab_size=512, seq_len=16,
                                     global_batch=4),
                                dict(vocab_size=151936, seq_len=33,
                                     global_batch=6, seed=7),
                                dict(vocab_size=300, seq_len=8,
                                     global_batch=2, frontend_tokens=3,
                                     frontend_dim=5)])
def test_synthetic_batches_are_the_jax_packages_bytes(kw):
    for shard, num in ((0, 1), (1, 2)):
        a = SyntheticLM(DataConfig(**kw), shard=shard, num_shards=num)
        b = JaxSyntheticLM(JaxDataConfig(**kw), shard=shard, num_shards=num)
        for step in (0, 1, 17):
            x, y = a.batch_at(step), b.batch_at(step)
            assert list(x) == list(y)
            for k in x:
                assert x[k].dtype == y[k].dtype
                assert x[k].tobytes() == y[k].tobytes()
        assert [a.next_batch()["tokens"].tobytes() for _ in range(2)] == \
            [b.next_batch()["tokens"].tobytes() for _ in range(2)]


def test_prefetch_iterator_puts_batches_on_the_device():
    src = SyntheticLM(DataConfig(vocab_size=512, seq_len=8, global_batch=2))
    ref = SyntheticLM(DataConfig(vocab_size=512, seq_len=8, global_batch=2))
    it = PrefetchIterator(src, device="cpu")
    try:
        for _ in range(3):
            got, want = next(it), ref.next_batch()
            assert got["tokens"].dtype == torch.int32
            assert np.array_equal(got["tokens"].numpy(), want["tokens"])
            assert np.array_equal(got["targets"].numpy(), want["targets"])
    finally:
        it.close()


# --------------------------------------------------------------- checkpoint
def tree(seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return {"a": scale * torch.randn(16, 8, generator=g),
            "b/s": torch.zeros((), dtype=torch.int32),
            "b/w": scale * torch.randn(32, generator=g),
            "c": torch.randn(5, generator=g).to(torch.bfloat16)}


def like(t):
    return {k: torch.zeros_like(v) for k, v in t.items()}


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_roundtrip(tmp_path, async_save):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=async_save)
    t = tree(0, scale=2.0)
    mgr.save(7, t, extra={"data_step": 7})
    mgr.wait()
    into = like(t)
    got, extra = mgr.restore(into)
    assert got is into and extra["data_step"] == 7
    for k in t:
        assert got[k].dtype == t[k].dtype
        torch.testing.assert_close(got[k], t[k], rtol=0, atol=0)


def hold_np_save(monkeypatch):
    """Make ``np.save`` wait until the returned event is set, so that a
    test decides when the writer thread writes."""
    gate = threading.Event()
    np_save = np.save

    def held(*a, **k):
        assert gate.wait(60), "np.save held too long"
        np_save(*a, **k)
    monkeypatch.setattr(np, "save", held)
    return gate


def test_async_save_writes_the_values_it_was_given(tmp_path, monkeypatch):
    """The writer thread saves the tree as it was at ``save``, also when
    the caller updates its tensors in place before the thread writes
    (the trainer's next step does)."""
    gate = hold_np_save(monkeypatch)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    t = tree(0)
    want = {k: v.clone() for k, v in t.items()}
    mgr.save(1, t)
    for v in t.values():
        v.add_(1)
    gate.set()
    mgr.wait()
    got, _ = mgr.restore(like(t))
    for k in t:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_checkpoint_keep_k_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree(s))
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4
    got, _ = mgr.restore(like(tree(0)), step=3)
    torch.testing.assert_close(got["a"], tree(3)["a"], rtol=0, atol=0)


def test_checkpoint_atomic_rename_and_mismatch(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(5, tree(0))
    assert sorted(os.listdir(tmp_path)) == ["step_00000005"]
    d = tmp_path / "step_00000005"
    assert sorted(os.listdir(d)) == ["leaf_00000.npy", "leaf_00001.npy",
                                     "leaf_00002.npy", "leaf_00003.npy",
                                     "manifest.json"]
    man = json.loads((d / "manifest.json").read_text())
    assert [l["key"] for l in man["leaves"]] == list(tree(0))
    assert man["leaves"][3]["dtype"] == "bfloat16"
    # a leftover .tmp of an interrupted save is not a checkpoint
    (tmp_path / "step_00000009.tmp").mkdir()
    assert mgr.latest_step() == 5
    with pytest.raises(AssertionError):
        mgr.restore({"a": torch.zeros(16, 8), "z": torch.zeros(4)})


def test_checkpoint_layout_is_the_jax_packages(tmp_path):
    """Either package reads what the other wrote (fp32 and int32 leaves;
    keys in the JAX tree's flattened order)."""
    t = {k: v for k, v in tree(1).items() if k != "c"}
    CheckpointManager(str(tmp_path / "port"), async_save=False).save(3, t)
    jt_ = {"a": jnp.zeros((16, 8)), "b": {"s": jnp.zeros((), jnp.int32),
                                          "w": jnp.zeros((32,))}}
    got, _ = JaxCkpt(str(tmp_path / "port"), async_save=False).restore(jt_)
    np.testing.assert_array_equal(np.asarray(got["b"]["w"]), t["b/w"].numpy())
    JaxCkpt(str(tmp_path / "jax"), async_save=False).save(4, got)
    back, _ = CheckpointManager(str(tmp_path / "jax")).restore(like(t))
    for k in t:
        torch.testing.assert_close(back[k], t[k], rtol=0, atol=0)


# ------------------------------------------------------------------ trainer
def make_trainer(tmp_path, fail_at=(), total=24, fused=False,
                 async_ckpt=False):
    cfg = reduced(get_config("qwen1.5-0.5b"),
                  num_layers=2, d_model=64, d_ff=128, vocab_size=256,
                  num_heads=2, num_kv_heads=2, head_dim=32)
    model = build_model(cfg, RuntimeConfig(remat="none"), device="cpu",
                        trainable=True)
    tcfg = TrainerConfig(total_steps=total, ckpt_every=8,
                         ckpt_dir=str(tmp_path), log_every=4,
                         async_ckpt=async_ckpt)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                          global_batch=4)
    return Trainer(model, OptConfig(lr=1e-3, warmup_steps=4, fused=fused),
                   data_cfg, tcfg,
                   failure_injector=FailureInjector(fail_at=set(fail_at)))


@pytest.mark.parametrize("fused", [False, True])
def test_trainer_runs_to_completion(tmp_path, fused):
    t = make_trainer(tmp_path, total=12, fused=fused)
    _, opt_state, hist = t.run()
    assert hist[-1]["step"] == 12 and int(opt_state.step) == 12
    assert np.isfinite(hist[-1]["loss"])


def test_trainer_loss_decreases(tmp_path):
    t = make_trainer(tmp_path, total=24)
    _, _, hist = t.run()
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_trainer_failure_recovery_resumes_from_checkpoint(tmp_path):
    t = make_trainer(tmp_path, fail_at=(10, 17), total=24)
    _, _, hist = t.run()
    assert hist[-1]["step"] == 24
    assert t.injector.fired == {10, 17}
    assert t.ckpt.latest_step() == 24


def test_trainer_recovery_matches_uninterrupted_run(tmp_path):
    """A run with a failure equals one without (deterministic data, restore
    from the step-8 checkpoint)."""
    a = make_trainer(tmp_path / "a", total=16)
    pa, sa, _ = a.run()
    b = make_trainer(tmp_path / "b", fail_at=(11,), total=16)
    pb, sb, _ = b.run()
    assert b.injector.fired == {11}
    close_named(dict(pb.named_parameters()),
                {k: v.detach().numpy() for k, v in pa.named_parameters()},
                rtol=1e-5, atol=1e-6)
    close_named(sb.mu, {k: v.numpy() for k, v in sa.mu.items()},
                rtol=1e-5, atol=1e-6)


def test_trainer_async_checkpoint_holds_its_step(tmp_path, monkeypatch):
    """With async checkpoints, the step-8 checkpoint holds step 8's state
    though its writer is held until step 9 has updated the parameters,
    the moments and the step counter in place: its files are a
    synchronous run's, byte for byte."""
    gate = hold_np_save(monkeypatch)
    a = make_trainer(tmp_path / "async", total=12, fused=True,
                     async_ckpt=True)
    saving, save, step_fn = [], a.ckpt.save, a.step_fn

    def ckpt_save(*args, **kw):
        saving.append(True)
        save(*args, **kw)

    def stepped(*args):
        out = step_fn(*args)
        if saving:
            gate.set()
        return out
    a.ckpt.save, a.step_fn = ckpt_save, stepped
    a.run()
    assert saving and gate.is_set()
    make_trainer(tmp_path / "sync", total=12, fused=True).run()
    for d in ("step_00000008", "step_00000012"):
        files = sorted(os.listdir(tmp_path / "sync" / d))
        assert sorted(os.listdir(tmp_path / "async" / d)) == files
        for f in files:
            if f.endswith(".npy"):
                np.testing.assert_array_equal(
                    np.load(tmp_path / "async" / d / f),
                    np.load(tmp_path / "sync" / d / f), err_msg=f"{d}/{f}")


def test_trainer_restarts_from_the_init_without_a_checkpoint(tmp_path):
    t = make_trainer(tmp_path, fail_at=(3,), total=6)
    _, _, hist = t.run()
    assert t.injector.fired == {3} and hist[-1]["step"] == 6


def test_watchdog_escalates_on_stragglers():
    wd = StepWatchdog(threshold=2.0, patience=2, warmup=0)
    out = []
    for s in range(8):
        dt = 1.0 if s < 5 else 10.0      # straggler from step 5
        out.append(wd.record(s, dt))
    assert out[-1] is True               # escalation after patience
    assert len(wd.events) >= 2


# ------------------------------------------------------- entry points
def test_train_launcher_smoke_on_cpu(tmp_path):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = train_launcher.main(["--arch", "qwen1.5-0.5b", "--smoke",
                                  "--steps", "4", "--device", "cpu",
                                  "--ckpt-dir", str(tmp_path)])
    assert rc == 0
    text = out.getvalue()
    assert "trained 4 steps on cpu" in text and "'step': 4" in text
    assert CheckpointManager(str(tmp_path)).latest_step() == 4


def test_unported_training_parts_raise():
    with pytest.raises(NotImplementedError, match="item 12"):
        RuntimeConfig(remat="dots_tp").validate()
    moe = reduced(get_config("qwen2-moe-a2.7b"))
    with pytest.raises(NotImplementedError, match="item 14"):
        build_model(moe, device="cpu", trainable=True)
    m = build_model(moe, device="cpu")
    with pytest.raises(NotImplementedError, match="item 14"):
        m.train_logits({"tokens": torch.zeros((1, 4), dtype=torch.int32)})
    dense = build_model(reduced(get_config("qwen1.5-0.5b")), device="cpu",
                        trainable=True)
    with pytest.raises(NotImplementedError, match="item 12"):
        make_train_step(dense, OptConfig(), compression=lambda g: g)
    with pytest.raises(NotImplementedError, match="item 12"):
        elastic_meshes(1)
    with pytest.raises(NotImplementedError, match="item 12"):
        reshard_tree({}, {})
    with pytest.raises(NotImplementedError, match="item 12"):
        train_launcher.main(["--arch", "qwen1.5-0.5b", "--smoke",
                             "--multi-pod", "--device", "cpu"])
