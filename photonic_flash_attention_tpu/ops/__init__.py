"""Compute kernels: flash attention, fused short-seq, quantization, paging."""

from .flash import flash_attention
from .fused import fused_attention
from .nonlinearity import (
    NonlinearityType,
    apply_nonlinearity,
    fused_layer_norm,
    fused_rms_norm,
    fused_softmax,
)
from .rel_bias import ALiBi, T5RelBias, alibi_slopes, materialize
from .quantization import (
    QuantizedTensor,
    dequantize,
    quantization_error,
    quantize,
    quantize_kv,
)
from .reference import attention_blockwise, attention_reference

__all__ = [
    "ALiBi",
    "NonlinearityType",
    "QuantizedTensor",
    "apply_nonlinearity",
    "fused_layer_norm",
    "fused_rms_norm",
    "fused_softmax",
    "T5RelBias",
    "alibi_slopes",
    "materialize",
    "attention_blockwise",
    "attention_reference",
    "dequantize",
    "flash_attention",
    "fused_attention",
    "quantization_error",
    "quantize",
    "quantize_kv",
]
