"""Mixture-of-Experts with capacity dispatch (gather-based), one device.

The port of ``repro.models.moe`` for tp = 1 (the JAX package's
``shard_map`` and sharding constraints have nothing to pin here).  All the
step's rows route as one group (the JAX package's routing groups align
with data shards, which serving on one device does not have; they come
back with training, ROADMAP item 14); each (token, slot) pick takes the
next free column of its expert's ``capacity`` columns in flat (token,
slot) order, and picks past capacity contribute zero — pad rows of a
prompt slab and idle decode slots route too and take capacity, as in the
JAX package.

Two paths, as in the JAX package:

* the gather path (any row count): fp32 router, ``_route_group``, the
  dispatch gather, three expert einsums over the whole stacks (MX stacks
  dequantize in the graph first), the gates and the combine, then the
  shared SwiGLU expert times ``sigmoid(shared_gate(x))``;
* the routed path (one row under ``kernel_routing``): the fp32 router
  through ``gemv``, then per projection either one ``gemv`` per picked
  expert of a raw stack (the expert id stays on the device: the kernel
  reads it) or one ``grouped_expert_qgemv`` over all k picks of an MX stack.

Raw stacks are stored ``(E, out, in)`` in the compute dtype (each expert in
the port's ``(out, in)`` convention, the layout ``gemv`` reads); MX stacks
are stored as the JAX package stores them, ``(E, K | K/2, N)`` codes with
``(E, K/32, N)`` E8M0 scales.  The router stays an fp32 ``(E, d)`` weight
applied in fp32, as in the JAX package (bf16 logits flip near-tied top-k
picks); ``shared_gate`` is applied in the compute dtype.

Where the port departs from the JAX package's operations (ROADMAP §3):
picks past capacity are written to an extra, sliced-off column (the JAX
scatter drops them, ``mode="drop"``), and the combine sums each token's
expert rows in ascending expert order by a gather (the JAX scatter-add's
order on the CPU; ``index_add_`` on CUDA would add with atomics in an
order that changes from run to run).  Serving drops the aux load-balancing
loss, as the JAX decode path does; training brings it (ROADMAP item 14).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import xla_cpu
from repro_torch.models import modules as M
from repro_torch.quant.tensor import QuantizedTensor


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------
def moe_init(cfg, *, dtype, generator, device) -> nn.ModuleDict:
    mo, d = cfg.moe, cfg.d_model
    kw = dict(dtype=dtype, generator=generator, device=device)
    p = nn.ModuleDict({
        "router": M.dense_init(d, mo.num_experts, bias=False,
                               dtype=torch.float32, generator=generator,
                               device=device),
        "wi_up": _experts_init(mo.num_experts, d, mo.d_ff, **kw),
        "wo": _experts_init(mo.num_experts, mo.d_ff, d, **kw),
    })
    if cfg.act == "swiglu":
        p["wi_gate"] = _experts_init(mo.num_experts, d, mo.d_ff, **kw)
    if mo.shared_d_ff:
        p["shared"] = M.mlp_init(d, mo.shared_d_ff, **kw)
        if mo.shared_expert_gate:
            p["shared_gate"] = M.dense_init(d, 1, bias=False, **kw)
    return p


def _experts_init(e, din, dout, *, dtype, generator,
                  device) -> nn.ParameterDict:
    """A stack of ``e`` fan-in scaled experts, stored (e, dout, din) in
    ``dtype``."""
    w = M._normal((e, dout, din), 1.0 / math.sqrt(din), generator, device)
    return nn.ParameterDict({"w": M.frozen(w.to(dtype))})


def _expert_stack(w, dtype):
    """The JAX layout (E, in, out) of a stack, for the gather path's
    einsums: an MX stack dequantizes in the graph (fp32, cast to
    ``dtype``); a raw one is a transposed view of the stored (E, out,
    in)."""
    if isinstance(w, QuantizedTensor):
        return w.dequantize(dtype)
    return w.transpose(-2, -1).to(dtype)


# --------------------------------------------------------------------------
# Routing
# --------------------------------------------------------------------------
def _softmax(x):
    """``jax.nn.softmax`` over the last axis: exp(x - max) / sum (on the
    CPU with XLA's own ``exp``, so that gates and drops are the JAX
    package's bit for bit)."""
    u = xla_cpu.exp(x - x.amax(dim=-1, keepdim=True))
    return u / u.sum(dim=-1, keepdim=True)


def _top_k(logits, mo):
    """fp32 router probabilities -> (top_p, top_e) over the last axis:
    the k largest in descending order, renormalized and scaled as the
    config says."""
    probs = _softmax(logits.float())
    top_p, top_e = torch.topk(probs, mo.num_experts_per_tok, dim=-1)
    if mo.norm_topk_prob:
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    return top_p * mo.routed_scaling_factor, top_e


def _route_group(logits, mo, capacity):
    """The step's n rows as one routing group: logits (n, E) -> (dispatch,
    valid, gates, rows).

    dispatch (E, capacity) int32: the token in each (expert, column)
    (0 where empty); valid and gates (E, capacity) fp32; rows (n, k) int64:
    each token's picks as rows of the flattened (E * capacity) expert
    output, in ascending expert order, ``E * capacity`` for a dropped pick
    (the combine reads a zero row there).  A pick's column is its rank
    among the picks of its expert in flat (token, slot) order; picks past
    capacity are written to column ``capacity``, which is sliced off."""
    n, E = logits.shape
    k = mo.num_experts_per_tok
    top_p, top_e = _top_k(logits, mo)                          # (n, k)
    flat_e = top_e.reshape(-1)
    flat_t = torch.arange(n, device=logits.device).repeat_interleave(k)
    onehot = F.one_hot(flat_e, E)                              # (n*k, E)
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1   # (n*k,)
    keep = pos < capacity
    col = torch.where(keep, pos, capacity)

    def table(dtype, values):
        t = torch.zeros((E, capacity + 1), dtype=dtype, device=logits.device)
        return t.index_put_((flat_e, col), values.to(dtype))[:, :capacity]

    dispatch = table(torch.int32, flat_t)
    valid = table(torch.float32, torch.ones_like(top_p).reshape(-1))
    gates = table(torch.float32, top_p.reshape(-1))
    row = torch.where(keep, flat_e * capacity + pos, E * capacity)
    _, order = top_e.sort(dim=-1)
    rows = torch.gather(row.reshape(n, k), 1, order)
    return dispatch, valid, gates, rows


def _combine(yv, rows):
    """yv (E*C, d) expert rows (zero where invalid), rows (n, k) -> (n, d):
    each token's k rows summed in ascending expert order, in yv's dtype,
    starting from zero as the JAX scatter-add does."""
    n, k = rows.shape
    yz = torch.cat([yv, yv.new_zeros((1, yv.shape[1]))])
    picked = yz[rows]                                          # (n, k, d)
    y = torch.zeros((n, yv.shape[1]), dtype=yv.dtype, device=yv.device)
    for j in range(k):
        y = y + picked[:, j]
    return y


# --------------------------------------------------------------------------
# Apply
# --------------------------------------------------------------------------
def _add_shared(p, cfg, x, y, dtype):
    if "shared" in p:
        ys = M.apply_mlp(p["shared"], x, cfg.act, dtype)
        if "shared_gate" in p:
            ys = ys * torch.sigmoid(M.apply_dense(p["shared_gate"], x, dtype))
        y = y + ys
    return y


def _apply_moe_routed(p, cfg, x, *, dtype):
    """One token through the kernels: the fp32 router ``gemv``, top-k, then
    per raw projection one ``gemv`` per picked expert (the stack and the
    device-resident id go to the kernel) summed in bf16 in top-k order, or
    per MX projection one ``grouped_expert_qgemv`` over all k picks summed
    in fp32; then the shared expert and its gate."""
    from repro_torch.kernels import ops as KO
    mo = cfg.moe
    B, T, d = x.shape
    k = mo.num_experts_per_tok
    logits = M.apply_dense(p["router"], x.reshape(1, d), torch.float32)
    top_p, top_e = _top_k(logits.reshape(-1), mo)
    ids = top_e.to(torch.int32)
    xv = x.reshape(d).to(dtype).contiguous()
    wu, wg, wo = (p[n]["w"] for n in ("wi_up", "wi_gate", "wo"))
    if isinstance(wu, QuantizedTensor):
        # one grouped call per projection: each block of the kernel reads
        # its row's expert id and walks only that expert's codes
        xs = xv.expand(k, d).contiguous()
        up = KO.grouped_expert_qgemv(wu.values, wu.scales, xs, ids)
        gate = KO.grouped_expert_qgemv(wg.values, wg.scales, xs, ids)
        h = (F.silu(gate) * up).to(dtype)                      # (k, d_ff)
        yk = KO.grouped_expert_qgemv(wo.values, wo.scales, h, ids)
        y = torch.sum(top_p[:, None] * yk, dim=0).to(dtype)
    else:
        y = torch.zeros((d,), dtype=dtype, device=x.device)
        for j in range(k):
            e = ids[j:j + 1]
            up = KO.gemv(wu, xv, e)
            h = F.silu(KO.gemv(wg, xv, e)) * up
            yj = KO.gemv(wo, h.to(dtype), e)
            y = y + top_p[j].to(dtype) * yj.to(dtype)
    return _add_shared(p, cfg, x, y.reshape(B, T, d), dtype)


def apply_moe(p, cfg, x, *, dtype):
    """x: (B, T, d) -> (B, T, d)."""
    mo = cfg.moe
    B, T, d = x.shape
    E, k = mo.num_experts, mo.num_experts_per_tok
    if p["wi_up"]["w"].shape[0] != E:
        raise NotImplementedError(
            "expert-parallel (sharded) expert stacks are not ported yet: "
            "ROADMAP queue 1 item 12 (tensor parallel)")
    if M.kernel_routed() and B * T == 1:
        return _apply_moe_routed(p, cfg, x, dtype=dtype)
    n = B * T
    capacity = max(int(n * k / E * mo.capacity_factor + 0.5), k)
    xf = x.reshape(n, d)

    logits = M.apply_dense(p["router"], xf, torch.float32)     # (n, E)
    dispatch, valid, gates, rows = _route_group(logits, mo, capacity)

    # gather tokens into per-expert buffers (E, C, d)
    xe = xf[dispatch.long()].to(dtype) * valid[..., None].to(dtype)
    up = torch.einsum("ecd,edf->ecf", xe,
                      _expert_stack(p["wi_up"]["w"], dtype))
    gate = torch.einsum("ecd,edf->ecf", xe,
                        _expert_stack(p["wi_gate"]["w"], dtype))
    h = F.silu(gate) * up
    ye = torch.einsum("ecf,efd->ecd", h, _expert_stack(p["wo"]["w"], dtype))
    ye = ye * gates[..., None].to(dtype)
    y = _combine(ye.reshape(E * capacity, d)
                 * valid.reshape(-1, 1).to(dtype), rows)
    return _add_shared(p, cfg, x, y.reshape(B, T, d), dtype)
