"""JAX parameter trees -> the port's parameters, through numpy.

``params_from_numpy`` takes the JAX package's parameter tree after
``modules.unbox`` and ``np.asarray`` on each leaf — nested dicts and lists of
numpy arrays, with each layer group's leaves stacked over a leading layer
axis — and returns the ``nn.ModuleDict`` the port's model reads:

* the layer axis is unstacked into one entry per layer;
* every projection weight is transposed from JAX's ``(in, out)`` to
  ``(out, in)`` (the layout ``F.linear`` and the routed ``gemv`` read, so no
  call transposes) and cast once to the compute dtype — the values JAX gets
  from casting the fp32 master weights on every call;
* norm scales stay fp32; biases and the embedding keep their stored dtype;
* a ``QuantizedTensor`` leaf (MX weights from ``quantize_params``) becomes
  the port's ``QuantizedTensor`` with the JAX ``(K | K/2, N)`` codes and
  ``(K/32, N)`` scales byte for byte — no transpose; fp8 codes (ml_dtypes
  ``float8_e4m3fn``, which ``torch.from_numpy`` does not take) cross as
  their bytes and are viewed back as ``torch.float8_e4m3fn``.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, List

import numpy as np
import torch
from torch import nn

from repro_torch.core.device import DeviceLike, dtype_of, resolve_device
from repro_torch.models.modules import frozen
from repro_torch.models.transformer import check_supported
from repro_torch.quant.tensor import QuantizedTensor


def _is_quantized(leaf) -> bool:
    """A JAX ``QuantizedTensor`` (or its unstacked layer), duck-typed."""
    return hasattr(leaf, "fmt") and hasattr(leaf, "scales")


def _quantized(q, device) -> QuantizedTensor:
    v = np.asarray(q.values)
    fp8 = v.dtype.name == "float8_e4m3fn"
    values = _tensor(v.view(np.uint8) if fp8 else v, device)
    if fp8:
        values = values.view(torch.float8_e4m3fn)
    return QuantizedTensor(values, _tensor(q.scales, device), q.bits,
                           q.group_size, q.axis, q.fmt)


def _tensor(a, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a)).to(device)    # a writable copy
    return t if dtype is None else t.to(dtype)


def _dense(p: Dict[str, Any], device, dtype) -> nn.ParameterDict:
    w = p["w"]
    out = nn.ParameterDict({"w": _quantized(w, device) if _is_quantized(w)
                            else frozen(_tensor(np.asarray(w).T, device,
                                                dtype).contiguous())})
    if "b" in p:
        out["b"] = frozen(_tensor(p["b"], device))
    return out


def _norm(p, device) -> nn.ParameterDict:
    return nn.ParameterDict({"scale": frozen(
        _tensor(p["scale"], device, torch.float32))})


def _layer(p, device, dtype) -> nn.ModuleDict:
    return nn.ModuleDict({
        "norm1": _norm(p["norm1"], device),
        "mixer": nn.ModuleDict({k: _dense(p["mixer"][k], device, dtype)
                                for k in ("wq", "wk", "wv", "wo")}),
        "norm2": _norm(p["norm2"], device),
        "ffn": nn.ModuleDict({k: _dense(v, device, dtype)
                              for k, v in p["ffn"].items()}),
    })


def _unstack(tree, i: int):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    if _is_quantized(tree):
        return SimpleNamespace(values=np.asarray(tree.values)[i],
                               scales=np.asarray(tree.scales)[i],
                               bits=tree.bits, group_size=tree.group_size,
                               axis=tree.axis, fmt=tree.fmt)
    return np.asarray(tree)[i]


def _layers(groups: List[List[Dict[str, Any]]]) -> List[Dict[str, Any]]:
    """Per-layer dicts in execution order: group by group, repeat by repeat,
    sublayer by sublayer.  A group of R > 1 repeats carries its leaves
    stacked over a leading axis of extent R."""
    out = []
    for pattern in groups:
        stacked = np.asarray(pattern[0]["norm1"]["scale"]).ndim == 2
        reps = np.asarray(pattern[0]["norm1"]["scale"]).shape[0] \
            if stacked else 1
        for r in range(reps):
            for sub in pattern:
                out.append(_unstack(sub, r) if stacked else sub)
    return out


def params_from_numpy(tree: Dict[str, Any], cfg, device: DeviceLike = None,
                      dtype=None) -> nn.ModuleDict:
    """The JAX tree (numpy leaves) of ``cfg`` as the port's parameters on
    ``device`` (the CUDA card unless ``device="cpu"``), projections in
    ``dtype`` (default: ``cfg.dtype``)."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = dtype_of(dtype or cfg.dtype)
    layers = _layers(tree["groups"])
    assert len(layers) == cfg.num_layers, (len(layers), cfg.num_layers)
    p = nn.ModuleDict({
        "embed": nn.ParameterDict({"table": frozen(
            _tensor(tree["embed"]["table"], dev))}),
        "layers": nn.ModuleList([_layer(lp, dev, dt) for lp in layers]),
        "final_norm": _norm(tree["final_norm"], dev),
    })
    if "lm_head" in tree:
        p["lm_head"] = _dense(tree["lm_head"], dev, dt)
    return p
