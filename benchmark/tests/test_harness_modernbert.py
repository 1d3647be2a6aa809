"""The modernbert_fit kind (`detext-modernbert-base.fe-fit-long`) on the CPU
at a tiny ModernBERT (hidden 64, 4 layers — 0 and 3 global —, 4 heads,
intermediate 96, local_attention 8; documents of 4–42 positions; 16 steps
of 8 rows): the program passes; the TF32 control, the bfloat16 control and
every fault planted in the reference fail a number, and so do faults
planted in the program; a program without the encoder stops in set-up;
the counted work against a brute-force count of the window's pairs and a
hand count; the readers on a hand-made trace and in a traced run."""
import json
import time

import numpy as np
import pytest
import torch

from benchmark import harness as h
from benchmark import run
from benchmark.compare import judge
from benchmark.costs import bound_s
from benchmark.costs import modernbert as costs

CELL = "detext-modernbert-base.fe-fit-long"
TINY = {"train_rows": 128, "valid_rows": 32, "len_median": 12, "len_lo": 2,
        "len_hi": 40, "token_ids": 1100}
TINY_CFG = {"hidden_size": 64, "num_hidden_layers": 4,
            "num_attention_heads": 4, "intermediate_size": 96,
            "local_attention": 8, "vocab_size": 1200,
            "max_position_embeddings": 64, "max_len": 42, "batch_size": 8,
            "initializer_range": 0.1,
            "cls_token_id": 1101, "sep_token_id": 1102,
            "pad_token_id": 1103,
            "special_ids": {"[UNK]": 1100, "[CLS]": 1101, "[SEP]": 1102,
                            "[PAD]": 1103, "[MASK]": 1104}}
METRICS = ("mfu.modernbert", "idle_share.modernbert",
           "tower_step_roofline.modernbert",
           "tower_full_attention_roofline.modernbert",
           "tower_window_attention_roofline.modernbert",
           "tower_adam_ms_per_step.modernbert")
_CELL = h.cell


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def tiny_cell(name: str) -> dict:
    c = _CELL(name)
    if name == CELL:
        c.update(TINY)
        c["cfg"].update(TINY_CFG)
    return c


def _run(monkeypatch, traced=False, seed=2 ** 31 + 13):
    monkeypatch.setattr(h, "cell", tiny_cell)
    m = h.manifest()
    w = next(x for x in m["workloads"] if x["name"] == CELL)
    code, line = run.run_cell(m, w, seed, 0.2, traced, torch.device("cpu"),
                              time.perf_counter())
    assert code == 0
    return json.loads(line)


@pytest.fixture(scope="module")
def checked():
    c = tiny_cell(CELL)
    st = h.kind(c["kind"]).Stage(c, 2 ** 31 + 5, torch.device("cpu"),
                                 h.Spans())
    st.setup()
    st.run_unit()
    st.release()
    return c, st, st.check()


def test_the_program_passes(checked):
    c, st, numbers = checked
    ok, rows = judge(numbers, c["limits"])
    assert ok, rows
    assert st.times["longest_document"] <= 42


def test_the_controls_and_the_reference_faults_fail(checked):
    c, st, _ = checked
    ok, rows = judge(st.control(), c["limits"])
    assert not ok, ("tf32", rows)
    faults = st.faults()
    assert set(faults) == {"bf16_autocast", "window_ignored",
                           "documents_not_separated", "thetas_swapped",
                           "last_layer_skipped", "half_batch",
                           "stop_at_12", "validated_at_start",
                           "state_unchanged"}
    for name, numbers in faults.items():
        ok, rows = judge(numbers, c["limits"])
        assert not ok, (name, rows)


def _window_ignored(monkeypatch):
    from gdmix_tpu_torch.models import deep_tower as m
    attend = m._attend_packed
    monkeypatch.setattr(m, "_attend_packed",
                        lambda q, k, v, off, longest, window: attend(
                            q, k, v, off, longest, -1))


def _last_layer_skipped(monkeypatch):
    from gdmix_tpu_torch.models import deep_tower as m
    forward = m._ModernBertEncoder.forward

    def skipped(self, tokens, mask):
        layers = self.layers
        self.layers = layers[:-1]
        try:
            return forward(self, tokens, mask)
        finally:
            self.layers = layers
    monkeypatch.setattr(m._ModernBertEncoder, "forward", skipped)


def _stopped_early(monkeypatch):
    from gdmix_tpu_torch.models import deep_tower as m
    fit = m.DeepTowerModel._fit_rows

    def early(self, train_t, valid_t, state, max_steps=None):
        return fit(self, train_t, valid_t, state,
                   max_steps=min(max_steps or 12, 12))
    monkeypatch.setattr(m.DeepTowerModel, "_fit_rows", early)


FAULTS = [_window_ignored, _last_layer_skipped, _stopped_early]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    line = _run(monkeypatch)
    assert line["correct"] is False, line["checks"]


def test_a_program_without_the_encoder_stops_in_setup(monkeypatch):
    """The parent's program has no _ModernBertEncoder: set-up raises at
    its first line, before any rows, state or fit."""
    from gdmix_tpu_torch.models import deep_tower as m
    monkeypatch.delattr(m, "_ModernBertEncoder")
    c = tiny_cell(CELL)
    st = h.kind(c["kind"]).Stage(c, 1, torch.device("cpu"), h.Spans())
    with pytest.raises(ImportError):
        st.setup()
    assert not hasattr(st, "train")


@pytest.mark.parametrize("reach", [0, 1, 4, 64])
def test_window_pairs_against_a_brute_force_count(reach):
    lens = [1, 2, 4, 5, 9, 63, 64, 65, 129, 130, 300]
    brute = sum(int((np.abs(np.arange(n)[:, None] - np.arange(n)[None, :])
                     <= reach).sum()) for n in lens)
    assert costs.pairs(lens, reach) == brute
    assert costs.pairs(lens, -1) == sum(n * n for n in lens)


def test_counted_work_by_hand():
    cfg = dict(h.cell(CELL)["cfg"])
    h_, heads, inter = 768, 12, 1152
    # a layer's products a position: Wqkv 768·2,304, Wo 768², Wi 768·2,304
    # and the MLP's Wo 1,152·768, two FLOPs a multiply-add
    per_pos = 2 * (768 * 2304 + 768 ** 2 + 768 * 2304 + 1152 * 768)
    assert per_pos == 2 * (4 * h_ * h_ + 3 * h_ * inter)
    # one document of 200 positions: 8 global layers over 200², 14 local
    # over the ±64 window's pairs
    win = 200 * 129 - 64 * 65
    attn = 4 * 64 * heads * (8 * 200 ** 2 + 14 * win)
    head = 2 * h_ * h_ + 2 * (h_ + 1) * 100 + 2 * 100
    fwd = costs.forward_flops([200], cfg, 100)
    assert fwd == 22 * per_pos * 200 + attn + head
    assert costs.step_flops([200], cfg, 100) == 3 * (fwd - attn) + 3.5 * attn
    f, b = costs.attention_step([200, 10], cfg, "window")
    assert f == 3.5 * 14 * 4 * 64 * heads * (win + 100)
    assert b == 3 * 14 * 4 * 210 * 768 * 4
    f, b = costs.attention_forward([200, 10], cfg, "full")
    assert (f, b) == (8 * 4 * 64 * heads * (200 ** 2 + 100),
                      8 * 4 * 210 * 768 * 4)


class _Stage:
    """What the readers take of a stage: two steps of documents of 40 and
    30 positions at the cell's widths."""

    cfg = h.cell(CELL)["cfg"]
    lens = [np.array([40, 30])] * 2

    def step_work(self):
        return [(costs.step_flops(ls, self.cfg, 100),
                 costs.step_bytes(1000, ls, 3)) for ls in self.lens]

    def attention_least_s(self, kind):
        return sum(bound_s(b, f)[0] for f, b in
                   (costs.attention_step(ls, self.cfg, kind)
                    for ls in self.lens))


def _ctx(ops):
    spans = h.Spans()
    spans.items += [("fit", 1.0, 2.0), ("window", 0.0, 3.0)]
    spans.add("fit.steps", 2)
    return dict(stage=_Stage(), spans=spans, units=1, window_s=3.0,
                trace=dict(ops=[(n, 0, d, s) for n, d, s in ops],
                           busy_s=1.0, window_s=3.0))


def test_the_readers_on_a_hand_made_trace():
    ops = [("gemm", 4000, "tower.forward"), ("gemm", 6000, "tower.backward"),
           ("attn", 1000, "tower.attention.full"),
           ("attn_bwd", 3000, "tower.attention_grad.full"),
           ("attn", 500, "tower.attention.window"),
           ("attn_bwd", 1500, "tower.attention_grad.window"),
           ("adam", 400, "Optimizer.step#Adam.step"),
           ("gather", 100, "tower.step"), ("auc", 900, "tower.validate")]
    ctx = _ctx(ops)
    read = {m: h.reader(m)(ctx) for m in METRICS[2:]}
    st = _Stage()
    step = sum(bound_s(b, f)[0] for f, b in st.step_work())
    assert read["tower_step_roofline.modernbert"] == pytest.approx(
        100 * step / 16500e-9)
    assert read["tower_full_attention_roofline.modernbert"] == \
        pytest.approx(100 * st.attention_least_s("full") / 4000e-9)
    assert read["tower_window_attention_roofline.modernbert"] == \
        pytest.approx(100 * st.attention_least_s("window") / 2000e-9)
    # the fused Adam's 400 ns over the two steps
    assert read["tower_adam_ms_per_step.modernbert"] == pytest.approx(
        1e3 * 400e-9 / 2)
    none = {m: h.reader(m)(_ctx([("auc", 900, "tower.validate")]))
            for m in METRICS[2:]}
    assert none == {m: None for m in METRICS[2:]}


def test_a_traced_cpu_run_reports_what_the_cpu_can(monkeypatch):
    """The manifest gives the cell its six metrics; a traced tiny run on
    the CPU reads mfu from the host clock, and none of the device's."""
    got = {x["name"] for x in h.cell_metrics(h.manifest(), CELL,
                                             "per_layer")}
    assert got == set(METRICS)
    line = _run(monkeypatch, traced=True)
    assert line["correct"] is True, line["checks"]
    assert 0 < line["metrics"]["mfu.modernbert"]["value"]
    assert set(line["metrics"]) == {"mfu.modernbert"}
