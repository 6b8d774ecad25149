"""``quantize_params``: MX-quantize the projection weights of a parameter
tree by path policy (the JAX package's ``quant/params.py``, MX formats).

The policy is the JAX package's MX policy: the ``w`` leaves of the dense
projections applied through ``modules.apply_dense`` (attention q/k/v/o, the
MLP halves, the ``lm_head``) quantize, and so do the MoE expert stacks
``wi_up`` / ``wi_gate`` / ``wo`` (the JAX package's policy flip: its int
formats keep expert stacks raw, MX quantizes them for the grouped expert
kernel); embeddings, norms, biases, MoE routers and ``shared_gate`` stay
raw.  The port's projections are stored ``(out, in)`` (expert stacks
``(E, out, in)``); a quantized one is stored as the JAX package stores it,
``(in, out)`` (``(E, in, out)``) with the E8M0 blocks running down the
contraction axis (``axis=-2``), so the codes are the JAX package's byte for
byte and the MX kernels walk them without a transpose.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
from torch import nn

from repro_torch.quant.tensor import QuantizedTensor, quantize_mx

# dense projections that every model applies via modules.apply_dense
QUANTIZE_KEYS = frozenset({
    "wq", "wk", "wv", "wo", "wg", "wr", "wdkv",
    "wi_gate", "wi_up", "lm_head",
})
# raw-array access in model code: never quantize these
EXCLUDE_KEYS = frozenset({"wuk", "wuv", "embed", "pos_table", "router"})


def default_policy(keys: Tuple[str, ...], leaf) -> bool:
    """True iff the leaf at module path ``keys`` is a quantizable weight."""
    if len(keys) < 2 or keys[-1] != "w":
        return False
    if any(k in EXCLUDE_KEYS for k in keys) or keys[-2] not in QUANTIZE_KEYS:
        return False
    return (isinstance(leaf, torch.Tensor) and leaf.dim() >= 2
            and leaf.is_floating_point())


def quantize_params(params: nn.Module, *, fmt: str) -> nn.Module:
    """The tree ``params`` with each ``default_policy``-selected ``w`` leaf
    replaced by its ``QuantizedTensor`` (``fmt="mx4"``: fp4 e2m1 codes,
    ``"fp8"``: e4m3 codes; E8M0 scales per 32-row block either way), for
    one device (the JAX package's ``tp=1``).  The raw leaves are shared
    with ``params``, which is left as it was."""
    if fmt not in ("mx4", "fp8"):
        raise NotImplementedError(f"fmt {fmt!r}: int8/int4 weights are not "
                                  f"ported yet — ROADMAP queue 1 item 7")
    elem = "fp4" if fmt == "mx4" else "fp8"

    def visit(keys, node):
        if isinstance(node, nn.ParameterDict):
            out = nn.ParameterDict()
            for k, v in node.items():
                out[k] = quantize_mx(v.detach().transpose(-2, -1),
                                     elem=elem, axis=-2) \
                    if default_policy(keys + (k,), v) else v
            return out
        if isinstance(node, nn.ModuleDict):
            return nn.ModuleDict({k: visit(keys + (k,), v)
                                  for k, v in node.items()})
        if isinstance(node, nn.ModuleList):
            return nn.ModuleList([visit(keys + (str(i),), v)
                                  for i, v in enumerate(node)])
        return node

    return visit((), params)


def quantized_stats(params: nn.Module) -> Dict[str, Any]:
    """Byte accounting of a (possibly) quantized tree: quantized and raw
    leaf counts, their bytes, and the fp32 bytes the quantized leaves
    replaced."""
    n_q = n_raw = b_q = b_raw = b_was = 0
    inside = set()
    for m in params.modules():
        if isinstance(m, QuantizedTensor):
            n_q += 1
            b_q += m.nbytes
            b_was += math.prod(m.shape) * 4
            inside.update(id(p) for p in m.parameters())
    for p in params.parameters():
        if id(p) not in inside:
            n_raw += 1
            b_raw += p.numel() * p.element_size()
    return {"quantized_leaves": n_q, "raw_leaves": n_raw,
            "quantized_bytes": int(b_q), "raw_bytes": int(b_raw),
            "quantized_fp32_bytes": int(b_was)}
