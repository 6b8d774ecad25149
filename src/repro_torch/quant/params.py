"""``quantize_params``: quantize the projection weights of a parameter
tree by path policy (the JAX package's ``quant/params.py``): absmax int8 or
int4 (``fmt="int"``) or MX (``fmt="mx4"`` / ``"fp8"``).

The policy is the JAX package's: the ``w`` leaves of the dense projections
applied through ``modules.apply_dense`` (attention q/k/v/o, the MLP halves,
the ``lm_head``) quantize; embeddings, norms, biases, MoE routers and
``shared_gate`` stay raw.  The MoE expert stacks ``wi_up`` / ``wi_gate`` /
``wo`` stay raw under ``fmt="int"`` and quantize under MX (the JAX
package's policy flip: the grouped expert kernel reads MX stacks).  The
port's projections are stored ``(out, in)`` (expert stacks ``(E, out,
in)``); a quantized one is stored as the JAX package stores it, ``(in,
out)`` (``(E, in, out)``) with its scale groups (int: ``group_size`` rows;
MX: 32-row E8M0 blocks) running down the contraction axis (``axis=-2``),
so the codes are the JAX package's byte for byte and carry across the
bridge unchanged.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
from torch import nn

from repro_torch.quant.tensor import (QuantizedTensor, granule, quantize,
                                      quantize_mx)

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


def quantizer(*, bits: int = 8, group_size: int = 128, fmt: str = "int"):
    """``visit(keys, node)``: the subtree ``node`` at module path ``keys``
    with each ``default_policy``-selected ``w`` leaf replaced by its
    ``QuantizedTensor`` (see ``quantize_params``).  A model's init applies
    it to each layer and to the read-out as it makes them (``init_lm``'s
    ``quantize``), so the whole raw init never sits beside its codes; the
    result is ``quantize_params`` of the whole init, leaf for leaf."""
    if fmt not in ("int", "mx4", "fp8"):
        raise ValueError(f"fmt must be int|mx4|fp8: {fmt}")
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if group_size % granule():
        raise ValueError(
            f"group_size {group_size} not a multiple of the {granule()}-row "
            f"int8 layout granule")
    mx = fmt != "int"

    def quantized(v):
        w = v.detach().transpose(-2, -1)                  # (in, out)
        if mx:
            return quantize_mx(w, elem="fp4" if fmt == "mx4" else "fp8",
                               axis=-2)
        # int4 packs pairs along the contraction axis: odd extents stay int8
        b = bits if (bits == 8 or w.shape[-2] % 2 == 0) else 8
        return quantize(w, bits=b, group_size=group_size, axis=-2)

    def visit(keys, node, experts=False):
        if isinstance(node, nn.ParameterDict):
            out = nn.ParameterDict()
            for k, v in node.items():
                out[k] = quantized(v) if default_policy(keys + (k,), v) \
                    and not (experts and not mx) else v
            return out
        if isinstance(node, nn.ModuleDict):
            # a dict that holds a router is a MoE block: its direct
            # projection dicts are the stacked expert weights
            moe = "router" in node
            return nn.ModuleDict({k: visit(keys + (k,), v, moe)
                                  for k, v in node.items()})
        if isinstance(node, nn.ModuleList):
            return nn.ModuleList([visit(keys + (str(i),), v)
                                  for i, v in enumerate(node)])
        return node

    return visit


def quantize_params(params: nn.Module, *, bits: int = 8,
                    group_size: int = 128, fmt: str = "int") -> nn.Module:
    """The tree ``params`` with each ``default_policy``-selected ``w`` leaf
    replaced by its ``QuantizedTensor``, for one device (the JAX package's
    ``tp=1``).  ``fmt="int"``: absmax int8 (``bits=8``) or int4 (``bits=4``,
    two values a byte along the contraction axis; a leaf whose contraction
    extent is odd stays int8) in groups of ``group_size`` rows, a multiple
    of the int8 layout granule, with fp32 scales; MoE expert stacks stay
    raw.  ``fmt="mx4"`` / ``"fp8"``: fp4 e2m1 / e4m3 codes with E8M0
    scales per 32-row block (``bits`` and ``group_size`` are not read),
    expert stacks included.  The raw leaves are shared with ``params``,
    which is left as it was."""
    return quantizer(bits=bits, group_size=group_size, fmt=fmt)((), params)


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
