"""The ``st_mem`` configuration's pieces of the benchmark: the cell run small
on the host through ``run_cell``'s ``overrides`` (sound, then with a planted
fault in the timed path), its operation counts against hand counts, and the
attention readers on synthetic windows."""

import pytest

from benchmark import drive, roofline, roofline_st_mem, run
from benchmark.kinds import closed_st_mem
from benchmark.metrics import attn_roofline, attn_us
from benchmark.reference import st_mem as reference
from benchmark.trace import Reduced, Spans
from ptbxl_torch.models import st_mem as program
from ptbxl_torch.utils import profiling

BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
CFG = run.load_json(run.ROOT / "benchmark/configs/st_mem.json")
CELL = "st_mem.bulk_bf16"
SMALL = {"width": 128, "depth": 2, "heads": 2, "mlp": 128}  # Predictor's heads are 64 wide
OVERRIDES = {
    "config": {**SMALL, "params": reference.param_shapes({**CFG, **SMALL})},
    "traffic": {"call_records": 16, "pool_records": 16,
                "predictor": {"precision": "default", "engine": "auto", "chunk_size": 8}},
}


def _run():
    return run.run_cell(BENCH, CELL, 3000000017, 0.5, False, "cpu", OVERRIDES)[0]


def test_the_configuration_is_the_published_widths():
    entry = next(c for c in BENCH["configs"] if c["name"] == "st_mem")
    assert entry["reduced"] == [] and CFG["source"] == entry["source"]
    assert {k: CFG[k] for k in ("arch", "input_length", "sample_rate_hz", "model_sample_rate_hz",
                                "model_samples", "patch", "leads", "width", "depth", "heads",
                                "mlp", "feat_dim", "num_labels")} == {
        "arch": "st_mem", "input_length": 5000, "sample_rate_hz": 500,
        "model_sample_rate_hz": 250, "model_samples": 2250, "patch": 75, "leads": 12,
        "width": 768, "depth": 12, "heads": 12, "mlp": 3072, "feat_dim": 768, "num_labels": 5}
    assert CFG["width"] // program.HEAD_DIM == CFG["heads"]
    assert roofline.param_count(CFG) == 85_152_773


def test_the_window_counts_st_mem_operations():
    import torch

    cell, cfg, traffic = run.cell_files(BENCH, CELL)
    cfg.update(OVERRIDES["config"])
    traffic.update(OVERRIDES["traffic"])
    load = closed_st_mem.Load(cfg, traffic, 3000000019, "cpu")
    load.setup()
    w = drive.Window(Spans())
    with torch.no_grad():
        load.window(0.2, w, lambda: None)
    assert w.records == 16 * w.attempted > 0 and w.launched == [8, 8] * w.attempted
    assert w.flops == roofline_st_mem.forward_flops(cfg, w.records)
    assert closed_st_mem.closed.roofline is roofline  # the CNN's yardstick is back


def test_a_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["metrics"]["records_per_s"]["value"] > 0


def _sep_in_mean(monkeypatch):
    monkeypatch.setattr(program.STMEM, "pool", lambda self, h: h.mean(dim=1))


def _block_skipped(monkeypatch):
    real, calls = program.Block.forward, []

    def forward(self, h, dtype):
        calls.append(1)  # blocks run in order, so every last block of a forward is skipped
        return h if len(calls) % SMALL["depth"] == 0 else real(self, h, dtype)

    monkeypatch.setattr(program.Block, "forward", forward)


@pytest.mark.parametrize("fault", [_sep_in_mean, _block_skipped], ids=["sep_in_mean", "skip"])
def test_a_planted_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = _run()
    assert not res["correct"], res["checks"]


def test_layer_norm_gains_are_drawn_near_one():
    import torch

    w = closed_st_mem.layer_norm_gains(
        {"norm.weight": torch.zeros(4096), "blocks.0.norm2.weight": torch.zeros(4096),
         "head.weight": torch.zeros(5, 8)}, 1, "cpu")
    for k in ("norm.weight", "blocks.0.norm2.weight"):
        assert abs(float(w[k].mean()) - 1.0) < 0.01 and 0.09 < float(w[k].std()) < 0.11
    assert not w["head.weight"].any()


def test_forward_flops_at_the_published_widths():
    block = 2 * 384 * (768 * 2304 + 768 ** 2 + 2 * 768 * 3072) + 4 * 384 ** 2 * 768
    hand = 2 * 12 * 30 * 75 * 768 + 12 * block + 2 * 768 * 5
    assert hand == 70_707_113_472
    assert roofline_st_mem.forward_flops(CFG, 1) == hand
    assert roofline_st_mem.forward_flops(CFG, 512) == 512 * hand
    assert roofline.param_count(CFG) == 85_152_773


def test_attention_counts_and_bound():
    assert roofline_st_mem.attention_flops(CFG, 2) == 2 * 4 * 384 ** 2 * 768
    assert roofline_st_mem.attention_bytes(CFG, 2, 2) == 2 * 4 * 384 * 768 * 2
    # at bf16 one block's attention is bound by its bytes
    b = roofline_st_mem.attention_bound_s(CFG, 512, 2)
    assert b == pytest.approx(512 * 4 * 384 * 768 * 2 / roofline.PEAK_BYTES)
    assert b > roofline_st_mem.attention_flops(CFG, 512) / roofline.PEAK_FLOPS


def _ctx(by_kernel):
    spans = Spans()
    spans.offset = 0
    w = drive.Window(spans, t0=0, t1=1000)
    red = Reduced(1e-6, 0.0, by_kernel, {}, [])
    return run.Context(CFG, {"predictor": {"precision": "default"}}, w, red, frozenset(),
                       frozenset(), 0.0)


BY_KERNEL = {"flash_fwd_kernel": (24, 0.012), "nvjet_gemm": (96, 0.036),
             "Memcpy HtoD (Pinned -> Device)": (2, 0.5)}


@pytest.mark.parametrize("reader", [attn_us, attn_roofline], ids=lambda r: r.__name__)
def test_readers_read_nothing_without_spans(reader, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert reader.read(_ctx(BY_KERNEL)) is None


def test_readers_on_a_window_with_spans(monkeypatch):
    # two chunks of 512 rows, each an encoder span holding 12 attention spans
    spans = [profiling.Span("st_mem.encoder", 200 * c, 200 * c + 190, 100 + c, 0, 100 + c, 1,
                            {"rows": 512, "tokens": 512 * 384}) for c in range(2)]
    spans += [profiling.Span("st_mem.attention", 10 * i, 10 * i + 5, i + 1, 100 + i // 12,
                             100 + i // 12, 1, {"rows": 512, "tokens": 512 * 384, "heads": 12})
              for i in range(24)]
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    ctx = _ctx(BY_KERNEL)
    assert attn_us.read(ctx) == pytest.approx(1e6 * 0.012 / 1024)  # 12 ms over 1,024 records
    bound = 24 * roofline_st_mem.attention_bound_s(CFG, 512, 2)
    assert attn_roofline.read(ctx) == pytest.approx(100.0 * bound / 0.012)
    assert attn_us.read(_ctx({"nvjet_gemm": (1, 0.001)})) is None  # no attention kernel
