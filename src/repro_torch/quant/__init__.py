"""Quantization of the port: ``QuantizedTensor``, absmax int8 (the KV-page
layout) and MX microscaling (``tensor``), and the weight pass
``quantize_params`` and its per-subtree ``quantizer`` (``params``).  The
MX kernels are in ``repro_torch.kernels``."""
from repro_torch.quant.params import (QUANTIZE_KEYS, default_policy,
                                      quantize_params, quantized_stats,
                                      quantizer)
from repro_torch.quant.tensor import (QuantizedTensor, absmax_scales,
                                      dequantize, dequantize_kv, e8m0_decode,
                                      fp4_decode, fp4_encode, granule,
                                      pack_fp4, quantize, quantize_kv,
                                      quantize_mx, unpack_fp4)

__all__ = ["QuantizedTensor", "absmax_scales", "quantize", "quantize_mx",
           "dequantize", "quantize_kv", "dequantize_kv", "fp4_encode",
           "fp4_decode", "pack_fp4", "unpack_fp4", "e8m0_decode", "granule",
           "QUANTIZE_KEYS", "default_policy", "quantize_params",
           "quantized_stats", "quantizer"]
