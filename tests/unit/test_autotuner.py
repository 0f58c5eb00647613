"""Autotuner candidate model + profile store unit tests."""

import pytest

from photonic_flash_attention_tpu.core.autotuner import (
    Autotuner,
    TuneResult,
    candidate_blocks,
)


class TestCandidateBlocks:
    def test_d128_includes_1024_square(self):
        """Candidates follow the Triton kernel's limits: the measured
        D=128 tile (128 x 64) is offered, oversized tiles such as
        1024 x 1024 are not."""
        cands = candidate_blocks(4096, 4096, 128)
        assert (128, 64) in cands
        assert (1024, 1024) not in cands

    def test_small_seq_clamps(self):
        cands = candidate_blocks(256, 256, 64)
        assert all(bq <= 256 and bkv <= 256 for bq, bkv in cands)
        assert cands  # never empty

    def test_vmem_budget_excludes_oversized(self):
        # The fp32 score tile plus accumulator must fit one program's
        # registers: 128 x 128 at D=128 does not, at D=64 it does.
        assert (128, 128) not in candidate_blocks(8192, 8192, 128)
        assert (128, 128) in candidate_blocks(8192, 8192, 64)

    def test_never_empty_fallback(self):
        assert candidate_blocks(8, 8, 64) == [(16, 16)]

    @pytest.mark.parametrize("s,d", [(64, 64), (1024, 64), (4096, 128), (300, 80)])
    def test_candidates_are_powers_of_two_within_smem(self, s, d):
        from photonic_flash_attention_tpu.core.autotuner import _SMEM_BYTES

        for bq, bkv in candidate_blocks(s, s, d):
            assert bq & (bq - 1) == 0 and bkv & (bkv - 1) == 0
            assert 16 <= bq <= 128 and 16 <= bkv <= 128
            dp = 1 << (d - 1).bit_length()
            assert (bq * dp + 4 * bkv * dp) * 2 <= _SMEM_BYTES


class TestProfileStore:
    def test_record_lookup_roundtrip(self, tmp_path):
        p = str(tmp_path / "p.json")
        t = Autotuner(state_path=p)
        key = Autotuner.profile_key(2048, 2048, 64, 4, 12)
        t.record(key, TuneResult(512, 512, 0.5))
        got = t.lookup(key)
        assert (got.block_q, got.block_kv) == (512, 512)
        t.save_state()
        # persisted: a fresh instance reloads it
        t2 = Autotuner(state_path=p)
        got2 = t2.lookup(key)
        assert got2 is not None and got2.block_q == 512
