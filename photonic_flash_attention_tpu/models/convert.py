"""HF-model conversion — ``convert_to_photonic`` reborn for JAX.

The reference's ``ModelConverter`` (reference
integration/pytorch/convert.py:46-622) deep-copies a torch model and
swaps detected attention layers in place. On JAX, module surgery is not
idiomatic — models are (module, params) pairs — so conversion means:
detect the source model's attention geometry with the reference's exact
tactics (class-name regex + q/k/v attribute sniffing, convert.py:93-150),
build the equivalent model from this package's model zoo on the
attention engine, transfer every weight (including the fused-QKV splits
the reference special-cases per family, convert.py:361-450), and emit a
``ConversionReport`` (conversion rate, estimates, warnings,
convert.py:77-90).

``convert_to_photonic(model_name_or_model)`` accepts an HF model name or
a loaded ``transformers`` PyTorch model and returns
``(flax_module, variables, report)``.
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Any, Dict, List, Optional, Tuple

import jax.numpy as jnp

from ..utils.exceptions import ConfigurationError
from ..utils.logging import get_logger

logger = get_logger("convert")

# Attention-layer detection tactics (reference convert.py:93-150).
_ATTENTION_CLASS_RE = re.compile(
    r"(attention|attn|multihead|mha|selfattention)", re.IGNORECASE
)
_QKV_ATTRS = (
    ("q_proj", "k_proj", "v_proj"),
    ("query", "key", "value"),
    ("q_lin", "k_lin", "v_lin"),
    ("c_attn",),  # GPT-2 fused
    ("qkv_proj",),
    ("in_proj_weight",),
)


@dataclasses.dataclass
class PhotonicConfig:
    """Conversion gates (reference convert.py:54-74 + :324-344)."""

    min_heads: int = 8
    min_embed_dim: int = 512
    strategy: str = "replace_all"  # replace_all | selective
    dtype: Any = jnp.bfloat16


@dataclasses.dataclass
class ConversionReport:
    """What the conversion did (reference ConversionReport :77-90)."""

    model_family: str
    total_attention_layers: int
    converted_layers: int
    skipped_layers: int
    parameters_transferred: int
    warnings: List[str]
    elapsed_s: float

    @property
    def conversion_rate(self) -> float:
        if self.total_attention_layers == 0:
            return 0.0
        return self.converted_layers / self.total_attention_layers

    def summary(self) -> str:
        return (
            f"{self.model_family}: converted {self.converted_layers}/"
            f"{self.total_attention_layers} attention layers "
            f"({self.conversion_rate:.0%}), {self.parameters_transferred:,} "
            f"params transferred in {self.elapsed_s:.1f}s"
        )


class AttentionLayerDetector:
    """Find attention layers in a torch module tree (convert.py:93-150)."""

    @staticmethod
    def is_attention_layer(module: Any) -> bool:
        name = type(module).__name__
        if _ATTENTION_CLASS_RE.search(name):
            return True
        for attrs in _QKV_ATTRS:
            if all(hasattr(module, a) for a in attrs):
                return True
        return False

    @classmethod
    def find_attention_layers(cls, model: Any) -> List[Tuple[str, Any]]:
        found: List[Tuple[str, Any]] = []
        for path, module in model.named_modules():
            if not path:
                continue
            if cls.is_attention_layer(module):
                # Keep only the outermost attention wrappers.
                if found and path.startswith(found[-1][0] + "."):
                    continue
                found.append((path, module))
        return found


def _detect_family(model: Any) -> str:
    cfg = getattr(model, "config", None)
    mt = getattr(cfg, "model_type", "") if cfg is not None else ""
    if mt:
        return mt
    name = type(model).__name__.lower()
    for fam in ("gpt2", "bert", "t5", "llama", "gpt_neox"):
        if fam in name:
            return fam
    return "unknown"


def convert_to_photonic(
    model: Any,
    config: Optional[PhotonicConfig] = None,
) -> Tuple[Any, Dict, ConversionReport]:
    """Convert an HF model (name or torch module) to this engine.

    Returns (flax_module, variables, report). Supported families today:
    ``gpt2`` (full weight transfer through :func:`..models.gpt2.load_hf_gpt2`).
    Unknown families raise ``ConfigurationError`` listing what the
    detector found, so callers can file the gap precisely.
    """
    config = config or PhotonicConfig()
    t0 = time.time()
    warnings: List[str] = []

    if isinstance(model, str):
        from transformers import AutoModel

        name = model
        try:
            from transformers import AutoModelForCausalLM

            model = AutoModelForCausalLM.from_pretrained(name)
        except (OSError, ValueError):
            model = AutoModel.from_pretrained(name)

    family = _detect_family(model)
    layers = AttentionLayerDetector.find_attention_layers(model)
    logger.info("detected %d attention layers in %s model", len(layers), family)

    if family == "gpt2":
        hf_cfg = model.config
        if hf_cfg.n_head < config.min_heads or hf_cfg.n_embd < config.min_embed_dim:
            warnings.append(
                f"model below conversion gates (heads={hf_cfg.n_head}, "
                f"embed={hf_cfg.n_embd}); converting anyway per strategy"
            )
        flax_model, variables, _ = _load_gpt2_from_loaded(model, config.dtype)
    elif family == "bert":
        from .bert import transfer_hf_bert

        hf_cfg = model.config
        if (
            hf_cfg.num_attention_heads < config.min_heads
            or hf_cfg.hidden_size < config.min_embed_dim
        ):
            warnings.append(
                f"model below conversion gates "
                f"(heads={hf_cfg.num_attention_heads}, "
                f"embed={hf_cfg.hidden_size}); converting anyway per strategy"
            )
        flax_model, variables, _ = transfer_hf_bert(model, config.dtype)
    elif family == "t5":
        from .t5 import transfer_hf_t5

        flax_model, variables, _ = transfer_hf_t5(model, config.dtype)
    elif family == "llama":
        from .llama import transfer_hf_llama

        flax_model, variables, _ = transfer_hf_llama(model, config.dtype)
    else:
        raise ConfigurationError(
            f"unsupported model family {family!r} "
            f"(detected {len(layers)} attention layers: "
            f"{[p for p, _ in layers[:4]]}...)"
        )

    n_params = sum(
        int(p.size) for p in __import__("jax").tree_util.tree_leaves(variables)
    )
    report = ConversionReport(
        model_family=family,
        total_attention_layers=len(layers),
        converted_layers=len(layers),
        skipped_layers=0,
        parameters_transferred=n_params,
        warnings=warnings,
        elapsed_s=time.time() - t0,
    )
    logger.info(report.summary())
    return flax_model, variables, report


def _load_gpt2_from_loaded(hf_model: Any, dtype) -> Tuple[Any, Dict, Any]:
    """Weight transfer from an already-loaded HF GPT-2 (no re-download)."""
    from .gpt2 import transfer_hf_gpt2

    return transfer_hf_gpt2(hf_model, dtype)
