"""Checkpoint/resume: params (orbax), KV cache, engine state.

The reference persists only the autonomous optimizer's learned state
(reference core/autonomous_optimizer.py:537-576); this suite covers the
this build's full checkpoint surface (SURVEY.md §5.4).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from photonic_flash_attention_tpu.core.checkpoint import (
    CheckpointManager,
    engine_state_dict,
    restore_engine_state,
    restore_kv_cache,
    save_kv_cache,
)
from photonic_flash_attention_tpu.utils.exceptions import CheckpointError


def make_params(rng):
    return {
        "layer": {
            "kernel": jnp.asarray(rng.standard_normal((8, 8)), jnp.float32),
            "bias": jnp.zeros((8,), jnp.float32),
        },
        "head": jnp.asarray(rng.standard_normal((8, 4)), jnp.float32),
    }


class TestCheckpointManager:
    def test_save_restore_roundtrip(self, tmp_path, rng):
        mgr = CheckpointManager(str(tmp_path))
        params = make_params(rng)
        mgr.save(10, params, metadata={"note": "test"})
        out = mgr.restore()
        assert out["meta"]["step"] == 10
        assert out["meta"]["note"] == "test"
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
            params,
            out["params"],
        )

    def test_latest_and_specific_step(self, tmp_path, rng):
        mgr = CheckpointManager(str(tmp_path))
        p1, p2 = make_params(rng), make_params(rng)
        mgr.save(1, p1)
        mgr.save(2, p2)
        assert mgr.latest_step() == 2
        out1 = mgr.restore(step=1)
        np.testing.assert_array_equal(
            np.asarray(out1["params"]["head"]), np.asarray(p1["head"])
        )

    def test_retention(self, tmp_path, rng):
        mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, make_params(rng))
        assert mgr.all_steps() == [3, 4]

    def test_missing_raises(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        with pytest.raises(CheckpointError):
            mgr.restore()

    def test_incomplete_checkpoint_ignored(self, tmp_path, rng):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(5, make_params(rng))
        # a crashed save: directory exists but meta.json missing
        os.makedirs(tmp_path / "step_9" / "params", exist_ok=True)
        assert mgr.latest_step() == 5


class TestEngineState:
    def test_roundtrip(self, tmp_path, rng):
        from photonic_flash_attention_tpu.core.engine import AttentionEngine
        from photonic_flash_attention_tpu.core.router import AdaptiveRouter

        eng = AttentionEngine(router=AdaptiveRouter(exploration_rate=0.0, seed=0))
        q = jnp.asarray(rng.standard_normal((1, 128, 4, 64)), jnp.float32)
        for _ in range(3):
            eng(q, q, q)
        state = engine_state_dict(eng)
        assert state["router_latency"]

        eng2 = AttentionEngine(router=AdaptiveRouter(exploration_rate=0.0, seed=0))
        restore_engine_state(eng2, state)
        assert engine_state_dict(eng2)["router_latency"] == state["router_latency"]

    def test_saved_with_manager(self, tmp_path, rng):
        from photonic_flash_attention_tpu.core.engine import AttentionEngine
        from photonic_flash_attention_tpu.core.router import AdaptiveRouter

        eng = AttentionEngine(router=AdaptiveRouter(seed=0))
        q = jnp.asarray(rng.standard_normal((1, 128, 4, 64)), jnp.float32)
        eng(q, q, q)
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, {"w": jnp.ones(2)}, engine_state=engine_state_dict(eng))
        out = mgr.restore()
        assert out["engine_state"]["version"] == 1


class TestKVCacheCheckpoint:
    @pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.int8], ids=["bf16", "int8"])
    def test_roundtrip(self, tmp_path, rng, dtype):
        from photonic_flash_attention_tpu.core.kv_cache import PagedKVCache

        cache = PagedKVCache(
            num_pages=16, page_size=8, num_kv_heads=2, head_dim=16, dtype=dtype
        )
        sid = cache.allocate_sequence()
        k = jnp.asarray(rng.standard_normal((20, 2, 16)), jnp.float32)
        v = jnp.asarray(rng.standard_normal((20, 2, 16)), jnp.float32)
        cache.append(sid, k, v)
        k_orig, v_orig = cache.gather_kv(sid)

        p = str(tmp_path / "kv")
        save_kv_cache(cache, p)
        restored = restore_kv_cache(p)
        assert restored.sequence_length(sid) == 20
        k_new, v_new = restored.gather_kv(sid)
        np.testing.assert_array_equal(np.asarray(k_orig), np.asarray(k_new))
        np.testing.assert_array_equal(np.asarray(v_orig), np.asarray(v_new))

        # allocation state also restored: new sequences don't collide
        sid2 = restored.allocate_sequence(8)
        assert sid2 != sid
        stats = restored.get_memory_stats()
        assert stats["sequences"] == 2
