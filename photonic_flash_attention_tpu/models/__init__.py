"""Model integration: attention dispatch, GPT-2/Llama/T5/BERT families,
HF conversion.

GPT-2 and Llama are pure functions over their parameter trees and import
without Flax; the Flax modules (the drop-in attention layers, T5's model
classes, BERT) load on first use.
"""

from .attention import dispatch_attention, padding_mask_to_lens_bias
from .convert import (
    AttentionLayerDetector,
    ConversionReport,
    PhotonicConfig,
    convert_to_photonic,
)
from .gpt2 import GPT2Config, GPT2LMHead, load_hf_gpt2, param_sharding_rules
from .llama import (
    LlamaConfig,
    LlamaForCausalLM,
    llama_param_sharding_rules,
    load_hf_llama,
    transfer_hf_llama,
)
from .t5 import T5Config, load_hf_t5, transfer_hf_t5

_LAZY = {
    "PhotonicFlashAttention": ".attention_modules",
    "PhotonicMultiHeadAttention": ".attention_modules",
    "T5ForConditionalGeneration": ".t5_modules",
    "T5Model": ".t5_modules",
    "BertConfig": ".bert",
    "BertModel": ".bert",
    "load_hf_bert": ".bert",
    "transfer_hf_bert": ".bert",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AttentionLayerDetector",
    "BertConfig",
    "BertModel",
    "ConversionReport",
    "GPT2Config",
    "GPT2LMHead",
    "LlamaConfig",
    "LlamaForCausalLM",
    "PhotonicConfig",
    "PhotonicFlashAttention",
    "PhotonicMultiHeadAttention",
    "T5Config",
    "T5ForConditionalGeneration",
    "T5Model",
    "convert_to_photonic",
    "dispatch_attention",
    "llama_param_sharding_rules",
    "load_hf_bert",
    "load_hf_gpt2",
    "load_hf_llama",
    "load_hf_t5",
    "padding_mask_to_lens_bias",
    "param_sharding_rules",
    "transfer_hf_llama",
    "transfer_hf_bert",
    "transfer_hf_t5",
]
