"""Load balancer strategies + autoscaler decisions (reference scaling tests)."""

import time

import pytest

from photonic_flash_attention_tpu.scaling.autoscaler import AutoScalingOrchestrator
from photonic_flash_attention_tpu.scaling.load_balancer import (
    ConsistentHashRing,
    LoadBalancer,
)
from photonic_flash_attention_tpu.utils.exceptions import DistributionError


class TestConsistentHashRing:
    def test_stable_assignment(self):
        r = ConsistentHashRing()
        for n in ("a", "b", "c"):
            r.add(n)
        assert r.lookup("key1") == r.lookup("key1")

    def test_minimal_disruption_on_removal(self):
        r = ConsistentHashRing()
        for n in ("a", "b", "c"):
            r.add(n)
        before = {k: r.lookup(k) for k in map(str, range(200))}
        r.remove("b")
        after = {k: r.lookup(k) for k in map(str, range(200))}
        moved = sum(
            1 for k in before if before[k] != after[k] and before[k] != "b"
        )
        assert moved == 0  # only keys owned by 'b' may move
        assert all(v != "b" for v in after.values())


class TestLoadBalancer:
    def test_round_robin_cycles(self):
        lb = LoadBalancer("round_robin")
        for n in ("a", "b"):
            lb.add_node(n)
        picks = [lb.select_node() for _ in range(4)]
        assert picks == ["a", "b", "a", "b"]

    def test_least_connections(self):
        lb = LoadBalancer("least_connections")
        lb.add_node("a")
        lb.add_node("b")
        lb._nodes["a"].active_requests = 5
        assert lb.select_node() == "b"

    def test_performance_prefers_fast_node(self):
        lb = LoadBalancer("performance")
        lb.add_node("slow")
        lb.add_node("fast")
        lb._nodes["slow"].ema_latency_ms = 50.0
        lb._nodes["fast"].ema_latency_ms = 5.0
        assert lb.select_node() == "fast"

    def test_unhealthy_excluded(self):
        lb = LoadBalancer("round_robin")
        lb.add_node("a")
        lb.add_node("b")
        lb.set_health("a", False)
        assert all(lb.select_node() == "b" for _ in range(3))

    def test_no_healthy_raises(self):
        lb = LoadBalancer()
        lb.add_node("a")
        lb.set_health("a", False)
        with pytest.raises(DistributionError):
            lb.select_node()

    def test_sticky_sessions(self):
        lb = LoadBalancer("round_robin")
        for n in ("a", "b", "c"):
            lb.add_node(n)
        first = lb.select_node(session_id="s1")
        assert all(lb.select_node(session_id="s1") == first for _ in range(5))

    def test_consistent_hash_strategy(self):
        lb = LoadBalancer("consistent_hash")
        for n in ("a", "b", "c"):
            lb.add_node(n)
        assert lb.select_node("user-7") == lb.select_node("user-7")

    def test_execute_request_retries_on_failure(self):
        lb = LoadBalancer("round_robin")
        lb.add_node("bad")
        lb.add_node("good")
        calls = []

        def fn(node_id):
            calls.append(node_id)
            if node_id == "bad":
                raise RuntimeError("down")
            return f"ok:{node_id}"

        out = lb.execute_request(fn)
        assert out == "ok:good"
        assert "bad" in calls and "good" in calls
        assert lb.get_stats()["nodes"]["bad"]["failures"] == 1

    def test_all_nodes_fail(self):
        lb = LoadBalancer()
        lb.add_node("a")
        with pytest.raises(DistributionError):
            lb.execute_request(lambda n: (_ for _ in ()).throw(RuntimeError("x")))

    def test_unknown_strategy(self):
        with pytest.raises(DistributionError):
            LoadBalancer("chaos")


class TestAutoscaler:
    def test_scales_up_on_high_utilization(self):
        a = AutoScalingOrchestrator(min_replicas=1, max_replicas=8, cooldown_s=0)
        for _ in range(3):
            a.record_metrics(0.95, queue_depth=10)
        d = a.make_decision()
        assert d.action == "scale_up"
        assert a.replicas > 1

    def test_scales_down_when_idle(self):
        a = AutoScalingOrchestrator(min_replicas=1, max_replicas=8, cooldown_s=0)
        a.replicas = 4
        for _ in range(5):
            a.record_metrics(0.05, queue_depth=0)
        d = a.make_decision()
        assert d.action == "scale_down"
        assert d.target_replicas == 3

    def test_cooldown_holds(self):
        a = AutoScalingOrchestrator(cooldown_s=3600)
        a.record_metrics(0.99, queue_depth=50)
        assert a.make_decision().action == "scale_up"
        a.record_metrics(0.99, queue_depth=50)
        assert a.make_decision().action == "hold"  # cooling down

    def test_bounds_respected(self):
        a = AutoScalingOrchestrator(min_replicas=1, max_replicas=2, cooldown_s=0)
        for _ in range(5):
            a.record_metrics(0.99, queue_depth=100)
            a.make_decision()
        assert a.replicas <= 2

    def test_trend_prediction_anticipates(self):
        # prediction extrapolates one cooldown ahead of a rising trend
        a = AutoScalingOrchestrator(cooldown_s=10)
        base = time.time()
        for i in range(10):
            a.record_metrics(0.3 + i * 0.05)
            a._metrics[-1].timestamp = base + i
        assert a._predict_utilization() > 0.9

    def test_cost_report(self):
        a = AutoScalingOrchestrator(replica_type="h100-1")
        r = a.cost_report()
        assert r["hourly_cost_usd"] > 0
        assert "startup_time_s" in r

    def test_status_surface(self):
        a = AutoScalingOrchestrator()
        a.record_metrics(0.5)
        a.make_decision()
        s = a.get_scaling_status()
        assert s["replicas"] >= 1
        assert len(s["recent_decisions"]) == 1
