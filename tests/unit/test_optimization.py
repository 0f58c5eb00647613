"""Caching, profiling, and adaptive-learning subsystems."""

import time

import jax.numpy as jnp
import numpy as np
import pytest

from photonic_flash_attention_tpu.intelligence.adaptive_learning import (
    AdaptiveDecisionEngine,
    Outcome,
    UCB1Bandit,
    WorkloadPatternAnalyzer,
    workload_features,
)
from photonic_flash_attention_tpu.core.router import WorkloadCharacteristics
from photonic_flash_attention_tpu.optimization.caching import (
    CompileCacheManager,
    ResultCache,
    cached_computation,
)
from photonic_flash_attention_tpu.optimization.performance_optimizer import (
    AdaptiveOptimizer,
    WorkloadProfiler,
)


class TestResultCache:
    def test_lru_eviction(self):
        c = ResultCache(capacity=2, policy="lru")
        c.put("a", 1)
        c.put("b", 2)
        c.get("a")  # refresh a
        c.put("c", 3)  # evicts b
        assert c.get("a") == 1
        assert c.get("b") is None
        assert c.stats.evictions == 1

    def test_lfu_eviction(self):
        c = ResultCache(capacity=2, policy="lfu")
        c.put("a", 1)
        c.put("b", 2)
        for _ in range(3):
            c.get("a")
        c.put("c", 3)  # evicts b (least frequent)
        assert c.get("a") == 1
        assert c.get("b") is None

    def test_ttl_expiry(self):
        c = ResultCache(capacity=8, ttl_s=0.05)
        c.put("a", 1)
        assert c.get("a") == 1
        time.sleep(0.06)
        assert c.get("a") is None
        assert c.stats.expirations == 1

    def test_bad_policy_rejected(self):
        with pytest.raises(ValueError):
            ResultCache(policy="magic")

    def test_cached_computation_distinguishes_data(self, rng):
        calls = {"n": 0}

        @cached_computation()
        def f(x):
            calls["n"] += 1
            return jnp.sum(x)

        a = jnp.asarray(rng.standard_normal((64,)), jnp.float32)
        b = jnp.asarray(rng.standard_normal((64,)), jnp.float32)
        f(a)
        f(a)  # hit
        f(b)  # different content, same shape -> miss
        assert calls["n"] == 2
        assert f.cache.stats.hits == 1

    def test_compile_cache_manager(self, tmp_path, monkeypatch):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "xla"))
        m = CompileCacheManager()
        m.enable()
        s = m.stats()
        assert s["enabled"] and s["dir"].endswith("xla")


class TestCompileCacheDir:
    """JAX_COMPILATION_CACHE_DIR when set; else .jax_cache/ in the checkout."""

    @pytest.fixture(autouse=True)
    def _restore_jax_cache_dir(self):
        import jax

        before = jax.config.jax_compilation_cache_dir
        yield
        jax.config.update("jax_compilation_cache_dir", before)

    def test_env_var_wins(self, tmp_path, monkeypatch):
        import jax

        from photonic_flash_attention_tpu.optimization.caching import (
            compile_cache_dir,
            enable_compile_cache,
        )

        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
        assert compile_cache_dir() == str(tmp_path / "c")
        assert enable_compile_cache() == str(tmp_path / "c")
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")
        assert (tmp_path / "c").is_dir()

    def test_default_is_fixed_dir_in_checkout(self, monkeypatch):
        import os

        import photonic_flash_attention_tpu
        from photonic_flash_attention_tpu.optimization.caching import compile_cache_dir

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        root = os.path.dirname(os.path.dirname(photonic_flash_attention_tpu.__file__))
        assert compile_cache_dir() == os.path.join(root, ".jax_cache")

    def test_no_other_path_is_read(self, monkeypatch):
        from photonic_flash_attention_tpu.optimization.caching import compile_cache_dir

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setenv("PFA_COMPILE_CACHE", "/elsewhere")
        assert compile_cache_dir().endswith(".jax_cache")

    def test_checkout_cache_is_gitignored(self):
        import os

        import photonic_flash_attention_tpu

        root = os.path.dirname(os.path.dirname(photonic_flash_attention_tpu.__file__))
        with open(os.path.join(root, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


class TestProfiler:
    def test_profile_and_summary(self):
        p = WorkloadProfiler()
        pid = p.start_profiling("attn", batch_size=4)
        time.sleep(0.01)
        rec = p.end_profiling(pid)
        assert rec.duration_ms >= 10
        s = p.summary()
        assert s["operations"]["attn"]["count"] == 1

    def test_classification_batch(self):
        p = WorkloadProfiler()
        for _ in range(5):
            pid = p.start_profiling("x", batch_size=16)
            p.end_profiling(pid)
        assert p.classify_workload() == "batch"

    def test_adaptive_optimizer_memoizes(self, rng):
        opt = AdaptiveOptimizer()
        calls = {"n": 0}

        def fn(x):
            calls["n"] += 1
            return jnp.sum(x)

        x = jnp.asarray(rng.standard_normal((32,)), jnp.float32)
        opt.optimize_operation(fn, x, operation="sum", cacheable=True)
        opt.optimize_operation(fn, x, operation="sum", cacheable=True)
        assert calls["n"] == 1
        assert opt.get_stats()["cache"]["hits"] == 1


def wc(**kw):
    kw.setdefault("batch_size", 2)
    kw.setdefault("q_len", 1024)
    kw.setdefault("kv_len", 1024)
    kw.setdefault("num_heads", 8)
    kw.setdefault("head_dim", 64)
    return WorkloadCharacteristics(**kw)


class TestAdaptiveLearning:
    def test_pattern_clustering_groups_similar(self):
        a = WorkloadPatternAnalyzer()
        p1 = a.assign(workload_features(wc(q_len=1024)))
        p2 = a.assign(workload_features(wc(q_len=1100)))
        p3 = a.assign(workload_features(wc(q_len=65536, batch_size=64)))
        assert p1 == p2
        assert p3 != p1

    def test_ucb1_converges_to_best_arm(self):
        b = UCB1Bandit(["a", "b", "c"], c=0.5)
        rng = np.random.default_rng(0)
        for _ in range(300):
            arm = b.select()
            reward = {"a": 0.2, "b": 0.9, "c": 0.4}[arm] + rng.normal(0, 0.05)
            b.update(arm, reward)
        stats = b.stats()
        assert stats["b"]["count"] > stats["a"]["count"]
        assert stats["b"]["count"] > stats["c"]["count"]

    def test_decision_engine_rules(self):
        eng = AdaptiveDecisionEngine()
        d = eng.make_decision(wc(need_weights=True))
        assert d["action"] == "fused" and d["source"] == "rule"
        d = eng.make_decision(wc(q_len=32, kv_len=32))
        assert d["action"] == "fused"

    def test_decision_engine_learns(self):
        eng = AdaptiveDecisionEngine(exploration_rate=0.0, seed=1)
        w = wc(q_len=4096)
        # flash consistently fast, fused consistently slow
        for _ in range(10):
            eng.record_outcome(w, Outcome("flash", latency_ms=1.0, tokens=4096))
            eng.record_outcome(w, Outcome("fused", latency_ms=50.0, tokens=4096))
        d = eng.make_decision(w)
        assert d["action"] == "flash"
        assert d["source"].startswith("pattern")

    def test_stats_surfaces(self):
        eng = AdaptiveDecisionEngine()
        eng.make_decision(wc())
        s = eng.get_stats()
        assert "bandit" in s and "patterns" in s


class TestMultiLevelCache:
    def test_entry_starts_in_l2_and_promotes(self):
        from photonic_flash_attention_tpu.optimization.caching import (
            MultiLevelCacheManager,
        )

        m = MultiLevelCacheManager()
        m.put("k", 42)
        assert len(m.l2) == 1 and len(m.l1) == 0
        for _ in range(3):  # promotion threshold
            assert m.get("k") == 42
        assert len(m.l1) == 1 and len(m.l2) == 0

    def test_l2_eviction_demotes_to_l3(self):
        from photonic_flash_attention_tpu.optimization.caching import (
            MultiLevelCacheManager,
        )

        m = MultiLevelCacheManager(l2_capacity=2)
        m.put("a", 1)
        m.put("b", 2)
        m.put("c", 3)  # evicts "a" from L2 -> demoted into L3
        assert m.get("a") == 1  # still retrievable (from L3)
        assert len(m.l3) >= 1

    def test_l3_compression_roundtrip(self):
        from photonic_flash_attention_tpu.optimization.caching import (
            MultiLevelCacheManager,
        )

        m = MultiLevelCacheManager(l2_capacity=1, compress_l3=True)
        payload = {"big": list(range(1000))}
        m.put("x", payload)
        m.put("y", 0)  # demote x to L3 (compressed)
        assert m.get("x") == payload

    def test_miss_and_stats(self):
        from photonic_flash_attention_tpu.optimization.caching import (
            MultiLevelCacheManager,
        )

        m = MultiLevelCacheManager()
        assert m.get("nope", "default") == "default"
        m.put("k", 1)
        m.get("k")
        s = m.get_stats()
        assert s["overall"]["hits"] == 1 and s["overall"]["misses"] == 1
        assert s["l2"]["entries"] == 1
