"""The frozen counts give the bounds and step FLOPs that PERF.md records."""

import pytest

from portbench import flops, spec


def test_flash_bounds_at_the_recorded_shape():
    f = flops.attention_flops(4, 2048, 2048, 32, 64)
    assert flops.roofline_s(f, 0) * 1e3 == pytest.approx(0.0695, abs=5e-5)
    b = flops.attention_bwd_flops(4, 2048, 2048, 32, 64)
    assert flops.roofline_s(b, 0) * 1e3 == pytest.approx(0.1738, abs=1e-4)


def test_minicpm_bounds_are_operation_bound():
    # forward 0.0782 ms and backward 0.1955 ms at (4, 2048, 36, 64)
    f = flops.attention_flops(4, 2048, 2048, 36, 64)
    by_bytes = flops.attention_bytes(4, 2048, 2048, 36, 64, 2, lse=True)
    assert flops.roofline_s(f, by_bytes) * 1e3 == pytest.approx(0.0782,
                                                                abs=5e-5)
    assert by_bytes / flops.PEAK_HBM_BYTES_PER_S < f / flops.PEAK_BF16_FLOPS
    b = flops.attention_bwd_flops(4, 2048, 2048, 36, 64)
    bb = flops.attention_bwd_bytes(4, 2048, 2048, 36, 64, 2)
    assert flops.roofline_s(b, bb) * 1e3 == pytest.approx(0.1955, abs=1e-4)


def test_minicpm_train_step_flops():
    cfg = spec.config("minicpm-2b")
    assert flops.non_embedding_active_params(cfg) == 40 * (
        4 * 2304 * 2304 + 3 * 2304 * 5760)
    assert flops.train_step_flops(cfg, 4, 2048) == pytest.approx(1.43e14,
                                                                 rel=2e-3)


def test_prefill_unembeds_only_the_last_position():
    cfg = spec.config("minicpm-2b")
    d, v = cfg["d_model"], cfg["vocab"]
    with_all = flops.prefill_flops(cfg, 4, 2048) + 2 * d * v * 4 * 2047
    assert flops.prefill_flops(cfg, 4, 2048) < with_all
    per_token = 2 * flops.non_embedding_active_params(cfg)
    attn = 40 * flops.attention_flops(4, 2048, 2048, 36, 64)
    assert flops.prefill_flops(cfg, 4, 2048) == pytest.approx(
        per_token * 8192 + 2 * d * v * 4 + attn)


def test_moe_counts_the_active_experts():
    cfg = spec.config("deepseek-moe-16b")
    m, d = cfg["moe"], cfg["d_model"]
    attn = 4 * d * d
    want = (28 * attn + 3 * d * m["dense_d_ff"]
            + 27 * (d * 64 + 3 * d * 1408 * 8))
    assert flops.non_embedding_active_params(cfg) == want
    # 4 x 2048 prefill: about 4.1e13 FLOPs (158.6 ms on the H100: 26 %)
    assert flops.prefill_flops(cfg, 4, 2048) == pytest.approx(4.14e13,
                                                              rel=1e-2)
