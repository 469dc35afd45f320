"""The port's bench (`lhrs_bot_tpu_torch.bench`) and int8-dots A/B on the CPU
at a 2-layer, narrow config: every cell runs and the line carries every key
of the JAX package's `bench.py` line, minus its TPU-set ratios, plus the
card's; a failing cell raises instead of writing an error into the line.
"""

import re
from pathlib import Path

import pytest
import torch

from lhrs_bot_tpu_torch import bench
from lhrs_bot_tpu_torch.benchmarks import int8dots_ab
from lhrs_bot_tpu_torch.models.llama import LlamaConfig
from lhrs_bot_tpu_torch.models.vlm import VLMConfig

REPO = Path(__file__).resolve().parents[1]
TPU_RATIOS = {"prefill_vs_target", "prefill_vs_a100_raw_target"}
# the metric of its prefill-only line, written when its decode failed: the
# port's bench raises there instead
FALLBACK_METRIC = "vit_perceiver_prefill_throughput"
TINY = dict(s_full=48, fill_full=40, s_short=32, fill_short=16)


def _jax_bench_keys():
    """The `extra` keys of the JAX bench.py's line, read from its source."""
    text = (REPO / "bench.py").read_text()
    keys = set(re.findall(r'"((?:decode|prefill|vit)_[a-z0-9_]+)"', text))
    return keys - TPU_RATIOS - {FALLBACK_METRIC}


@pytest.fixture(scope="module")
def line():
    cfg = LlamaConfig.tiny_test()
    decode = bench.bench_decode(cfg, device="cpu", steps=2, reps=1,
                                cells=bench.decode_cells(**TINY))
    prefill = bench.bench_prefill(VLMConfig.tiny_test(), device="cpu",
                                  batch=2, iters=1)
    return bench.bench_line(decode, prefill, {"name": "cpu (test)",
                                              "power_limit": "n/a"})


def test_bench_line_has_every_key_of_the_jax_bench(line):
    keys = _jax_bench_keys()
    assert len(keys) == 11
    assert set(line["extra"]) == keys
    assert line["metric"] == "llama2_7b_decode_w4a8_full_context_single_chip"
    assert line["unit"] == "tok/s/seq"
    assert line["value"] == line["extra"][bench.HEADLINE] > 0
    assert all(v > 0 for v in line["extra"].values())
    assert set(line["device"]) == {"name", "power_limit"}


def test_a_failing_cell_raises(monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("cell failed")

    monkeypatch.setattr(bench, "measure_decode", broken)
    with pytest.raises(RuntimeError, match="cell failed"):
        bench.bench_decode(LlamaConfig.tiny_test(), device="cpu", steps=1,
                           reps=1, cells=bench.decode_cells(**TINY)[:1])


def test_a_cell_past_the_cache_raises():
    with pytest.raises(ValueError, match="overrun"):
        bench.measure_decode(None, LlamaConfig.tiny_test(), 1, 32, 30,
                             steps=4, device="cpu")


def test_bench_line_refuses_a_non_positive_value():
    with pytest.raises(ValueError, match="gave"):
        bench.bench_line({bench.HEADLINE: 0.0}, {}, {})


def test_int8dots_ab_runs(monkeypatch):
    monkeypatch.delenv("LHRS_DECODE_INT8_DOTS", raising=False)
    report = int8dots_ab.run_ab(LlamaConfig.tiny_test(), device="cpu", b=1,
                                s_max=48, fill=40, steps=2, reps=1)
    assert set(report) == {
        "attn_bf16dots_ms", "attn_bf16dots_eff_gbs", "attn_int8dots_ms",
        "attn_int8dots_eff_gbs", "onecall_max_abs_diff",
        "total_w4h_bf16dots_ms", "total_w4h_bf16dots_tok_s",
        "total_w4h_int8dots_ms", "total_w4h_int8dots_tok_s"}
    assert all(v > 0 for v in report.values())
    assert report["onecall_max_abs_diff"] < 0.1


def test_decode_run_is_greedy_and_deterministic():
    cfg = LlamaConfig.tiny_test()
    params = bench.make_decoder_params(cfg, 8, True, device="cpu")
    cache = bench.filled_cache(cfg, 2, 32, torch.int8, device="cpu")
    a = bench.decode_run(params, cfg, cache, 16, 3)
    b = bench.decode_run(params, cfg, cache, 16, 3)
    assert a == b
