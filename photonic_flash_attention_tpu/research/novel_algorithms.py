"""Research attention algorithms + benchmark harness.

The rebirth of reference research/novel_algorithms.py:33-1631 — three
novel attention mechanisms and a benchmark framework — re-derived with
math that is real on the device (jnp/flax; FFTs, pooling pyramids, complex
inner products all lower to XLA):

* ``QuantumInspiredAttention`` (reference PhotonicQuantumAttention
  :65-354): complex-amplitude projections, interference scores = squared
  modulus of the complex inner product, cross-head phase mixing (the
  reference's "entanglement gates"), amplitude-squared normalization.
* ``SpectralAttention`` (reference MultiDimensionalSpectralAttention
  :357-669): rfft along the sequence, learnable spectral filters,
  attention among retained low-frequency modes (O(S log S + K^2)),
  inverse transform + residual fusion.
* ``HierarchicalAttention`` (reference AdaptiveHierarchicalAttention
  :671-1000): multi-resolution pooling pyramid, per-level attention,
  learned top-down combination.
* ``ResearchBenchmark`` (reference NovelAlgorithmBenchmarkFramework
  :1002-1590): latency / output-stability / quality scoring with a
  markdown report.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

try:
    import flax.linen as nn
except ImportError as e:  # pragma: no cover - depends on the environment
    raise ImportError("the research attention modules need flax (pip install flax)") from e

from ..ops.fused import fused_attention


class QuantumInspiredAttention(nn.Module):
    """Interference-based attention over complex amplitude encodings.

    Scores are |<q|k>|^2 for complex q, k — genuinely computed, unlike the
    reference's simulated beam-splitter. ``entangle=True`` mixes phases
    across heads with a learned unitary-ish rotation before scoring.
    """

    embed_dim: int
    num_heads: int
    entangle: bool = True
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array, deterministic: bool = True) -> jax.Array:
        b, s, e = x.shape
        h = self.num_heads
        d = e // h
        dense = lambda name: nn.Dense(e, dtype=self.dtype, name=name)  # noqa: E731
        q_re = dense("q_re")(x).reshape(b, s, h, d)
        q_im = dense("q_im")(x).reshape(b, s, h, d)
        k_re = dense("k_re")(x).reshape(b, s, h, d)
        k_im = dense("k_im")(x).reshape(b, s, h, d)
        v = dense("v")(x).reshape(b, s, h, d)

        if self.entangle:
            # cross-head phase mixing: learned rotation over the head axis
            mix = self.param(
                "head_mix", nn.initializers.orthogonal(), (h, h), jnp.float32
            )
            q_re = jnp.einsum("bshd,hg->bsgd", q_re, mix)
            q_im = jnp.einsum("bshd,hg->bsgd", q_im, mix)

        # complex inner product: re = qr.kr + qi.ki ; im = qr.ki - qi.kr
        re = jnp.einsum("bqhd,bkhd->bhqk", q_re, k_re) + jnp.einsum(
            "bqhd,bkhd->bhqk", q_im, k_im
        )
        im = jnp.einsum("bqhd,bkhd->bhqk", q_re, k_im) - jnp.einsum(
            "bqhd,bkhd->bhqk", q_im, k_re
        )
        intensity = (re**2 + im**2) / d  # |<q|k>|^2, the measured power
        # amplitude-squared normalization ("quantum softmax")
        weights = intensity / (
            jnp.sum(intensity, axis=-1, keepdims=True) + 1e-9
        )
        out = jnp.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, s, e)
        return nn.Dense(e, dtype=self.dtype, name="out")(out)


class SpectralAttention(nn.Module):
    """Attention among retained frequency modes (O(S log S + K^2))."""

    embed_dim: int
    num_heads: int
    num_modes: int = 64  # retained low-frequency modes
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array, deterministic: bool = True) -> jax.Array:
        b, s, e = x.shape
        k = min(self.num_modes, s // 2 + 1)
        xf = jnp.fft.rfft(x.astype(jnp.float32), axis=1)  # (B, S//2+1, E) complex
        modes = xf[:, :k]
        # learnable spectral filter (per mode, per feature)
        filt = self.param(
            "spectral_filter", nn.initializers.ones, (k, e), jnp.float32
        )
        modes = modes * filt
        # attention among modes on stacked re/im features
        feats = jnp.concatenate([modes.real, modes.imag], axis=-1)  # (B, K, 2E)
        feats = nn.Dense(e, dtype=self.dtype, name="mode_proj")(feats)
        attn_out, _ = fused_attention(
            *(
                feats.reshape(b, k, self.num_heads, e // self.num_heads)
                for _ in range(3)
            )
        )
        attn_out = attn_out.reshape(b, k, e)
        re = nn.Dense(e, dtype=self.dtype, name="re_proj")(attn_out)
        im = nn.Dense(e, dtype=self.dtype, name="im_proj")(attn_out)
        new_modes = (modes + (re + 1j * im)).astype(jnp.complex64)
        pad = jnp.zeros((b, xf.shape[1] - k, e), jnp.complex64)
        y = jnp.fft.irfft(jnp.concatenate([new_modes, pad], axis=1), n=s, axis=1)
        gate = nn.Dense(e, dtype=self.dtype, name="fusion_gate")(x)
        return x + jax.nn.sigmoid(gate) * y.astype(x.dtype)


class HierarchicalAttention(nn.Module):
    """Multi-resolution pyramid attention with top-down combination."""

    embed_dim: int
    num_heads: int
    num_levels: int = 3
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array, deterministic: bool = True) -> jax.Array:
        b, s, e = x.shape
        h, d = self.num_heads, e // self.num_heads
        levels = []
        cur = x
        for lvl in range(self.num_levels):
            levels.append(cur)
            if cur.shape[1] <= 2:
                break
            # strided mean-pool by 2 along the sequence
            sl = cur.shape[1] - cur.shape[1] % 2
            cur = cur[:, :sl].reshape(b, sl // 2, 2, e).mean(axis=2)

        outs = []
        for lvl, feats in enumerate(levels):
            qkv = nn.Dense(3 * e, dtype=self.dtype, name=f"qkv_{lvl}")(feats)
            q, k, v = jnp.split(qkv, 3, axis=-1)
            sl = feats.shape[1]
            o, _ = fused_attention(
                q.reshape(b, sl, h, d),
                k.reshape(b, sl, h, d),
                v.reshape(b, sl, h, d),
            )
            o = o.reshape(b, sl, e)
            # upsample back to full resolution (repeat)
            if sl != s:
                reps = -(-s // sl)
                o = jnp.repeat(o, reps, axis=1)[:, :s]
            outs.append(o)

        stacked = jnp.stack(outs, axis=-1)  # (B, S, E, L)
        gates = nn.Dense(len(outs), dtype=self.dtype, name="level_gate")(x)
        gates = jax.nn.softmax(gates, axis=-1)  # (B, S, L)
        combined = jnp.einsum("bsel,bsl->bse", stacked, gates)
        return nn.Dense(e, dtype=self.dtype, name="out")(combined)


# ---------------------------------------------------------------------------
# Benchmark framework
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AlgorithmResult:
    name: str
    latency_ms: float
    output_norm: float
    stability: float  # 1 - rel-std across repeated runs
    finite: bool

    def score(self) -> float:
        lat_term = 1.0 / (1.0 + self.latency_ms / 10.0)
        return (0.5 * lat_term + 0.5 * self.stability) * (1.0 if self.finite else 0.0)


class ResearchBenchmark:
    """Compare attention variants (reference :1002-1590)."""

    def __init__(self, batch: int = 2, seq: int = 256, embed: int = 256, heads: int = 8):
        self.batch, self.seq, self.embed, self.heads = batch, seq, embed, heads

    def default_algorithms(self) -> Dict[str, nn.Module]:
        return {
            "quantum_inspired": QuantumInspiredAttention(self.embed, self.heads),
            "spectral": SpectralAttention(self.embed, self.heads),
            "hierarchical": HierarchicalAttention(self.embed, self.heads),
        }

    def run(
        self,
        algorithms: Optional[Dict[str, nn.Module]] = None,
        iters: int = 3,
        seed: int = 0,
    ) -> List[AlgorithmResult]:
        algorithms = algorithms or self.default_algorithms()
        rng = np.random.default_rng(seed)
        x = jnp.asarray(
            rng.standard_normal((self.batch, self.seq, self.embed)), jnp.float32
        )
        results = []
        for name, mod in algorithms.items():
            params = mod.init(jax.random.PRNGKey(seed), x)
            fn = jax.jit(lambda p, x, m=mod: m.apply(p, x))
            out = fn(params, x)
            jax.block_until_ready(out)
            lats, norms = [], []
            for _ in range(iters):
                t0 = time.perf_counter()
                out = fn(params, x)
                jax.block_until_ready(out)
                lats.append((time.perf_counter() - t0) * 1e3)
                norms.append(float(jnp.linalg.norm(out.astype(jnp.float32))))
            stability = 1.0 - float(np.std(norms) / (np.mean(norms) + 1e-9))
            results.append(
                AlgorithmResult(
                    name=name,
                    latency_ms=float(np.mean(lats)),
                    output_norm=float(np.mean(norms)),
                    stability=stability,
                    finite=bool(jnp.all(jnp.isfinite(out))),
                )
            )
        return results

    @staticmethod
    def markdown_report(results: Sequence[AlgorithmResult]) -> str:
        lines = [
            "# Novel attention benchmark",
            "",
            "| algorithm | latency (ms) | stability | finite | score |",
            "|---|---|---|---|---|",
        ]
        for r in sorted(results, key=lambda r: -r.score()):
            lines.append(
                f"| {r.name} | {r.latency_ms:.2f} | {r.stability:.4f} | "
                f"{'yes' if r.finite else 'NO'} | {r.score():.3f} |"
            )
        return "\n".join(lines)
