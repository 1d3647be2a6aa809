"""The tower_fit kind (`detext-bert-base.fe-fit`) on the CPU at a tiny
BERT (hidden 64, 2 layers, 4 heads, intermediate 256; documents of 16
positions; 16 steps of 8 rows): the program passes; the bfloat16 control
and every fault planted in the program fail a number; the reference's own
faults do too; the counted work against a hand count; the readers of the
program's tower spans on a hand-made trace and in a traced run."""
import json
import time

import pytest
import torch

from benchmark import harness as h
from benchmark import run
from benchmark.compare import judge
from benchmark.costs import tower as costs

CELL = "detext-bert-base.fe-fit"
TINY = {"train_rows": 128, "valid_rows": 32, "len_median": 6, "len_lo": 2,
        "len_hi": 14}
TINY_CFG = {"hidden_size": 64, "num_hidden_layers": 2,
            "num_attention_heads": 4, "intermediate_size": 256,
            "vocab_size": 1200, "max_len": 16, "batch_size": 8}
METRICS = ("mfu.bert", "idle_share.bert", "tower_step_roofline.bert",
           "tower_attention_roofline.bert", "tower_adam_ms_per_step.bert")
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


def _run(monkeypatch, traced=False, seed=2 ** 31 + 11):
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
    st = h.kind(c["kind"]).Stage(c, 2 ** 31 + 3, torch.device("cpu"),
                                 h.Spans())
    st.setup()
    st.run_unit()
    st.release()
    return c, st, st.check()


def test_the_program_passes(checked):
    c, _, numbers = checked
    ok, rows = judge(numbers, c["limits"])
    assert ok, rows


def test_the_bf16_control_and_the_reference_faults_fail(checked):
    c, st, _ = checked
    faults = st.faults()
    assert set(faults) == {"bf16_autocast", "mask_ignored",
                           "last_layer_skipped", "half_batch", "stop_at_12",
                           "validated_at_start", "state_unchanged"}
    for name, numbers in faults.items():
        ok, rows = judge(numbers, c["limits"])
        assert not ok, (name, rows)


def _mask_ignored(monkeypatch):
    from gdmix_tpu_torch.models import deep_tower as m
    attend = m._attend
    monkeypatch.setattr(m, "_attend", lambda q, k, v, ok: attend(
        q, k, v, torch.ones_like(ok)))


def _last_layer_skipped(monkeypatch):
    from gdmix_tpu_torch.models import deep_tower as m
    forward = m._BertEncoder.forward

    def skipped(self, tokens, mask):
        layers = self.layers
        self.layers = layers[:-1]
        try:
            return forward(self, tokens, mask)
        finally:
            self.layers = layers
    monkeypatch.setattr(m._BertEncoder, "forward", skipped)


def _half_batch(monkeypatch):
    """Every step, set-up's too, differentiates the first half of its
    batch and leaves the second half out."""
    from gdmix_tpu_torch.models import deep_tower as m
    step = m.DeepTowerModel._step

    def half(self, opt, rows, idx, ranking):
        return step(self, opt, rows, idx[:len(idx) // 2], ranking)
    monkeypatch.setattr(m.DeepTowerModel, "_step", half)


def _stopped_early(monkeypatch):
    """The timed fit stops after 12 of its 16 steps; set-up's first steps,
    which take at most three, are left as they are."""
    from gdmix_tpu_torch.models import deep_tower as m
    fit = m.DeepTowerModel._fit_rows

    def early(self, train_t, valid_t, state, max_steps=None):
        return fit(self, train_t, valid_t, state,
                   max_steps=min(max_steps or 12, 12))
    monkeypatch.setattr(m.DeepTowerModel, "_fit_rows", early)


def _validated_at_start(monkeypatch):
    """The fit's validation scores are those of its initial state."""
    from gdmix_tpu_torch.models import deep_tower as m
    fit = m.DeepTowerModel._fit_rows

    def at_start(self, train_t, valid_t, state, max_steps=None):
        fit(self, train_t, valid_t, state, max_steps)
        answer = {k: v.clone() for k, v in self.module.state_dict().items()}
        self.module.load_state_dict(state)
        scores = self._score_all(valid_t)
        self.module.load_state_dict(answer)
        return scores
    monkeypatch.setattr(m.DeepTowerModel, "_fit_rows", at_start)


FAULTS = [_mask_ignored, _last_layer_skipped, _half_batch, _stopped_early,
          _validated_at_start]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    line = _run(monkeypatch)
    assert line["correct"] is False, line["checks"]


def test_counted_work_by_hand():
    # BERT-Base, one layer, one row of one real position: Q, K, V and the
    # output 4·768², the FFN 2·768·3,072, two FLOPs a product; attention
    # 4·1·768; the pooler 2·768²
    assert costs.forward_flops([1], 768, 3072, 1, 0) \
        == 2 * (4 * 768 ** 2 + 2 * 768 * 3072) + 4 * 768 + 2 * 768 ** 2
    # rows of 50 and 128 real positions over 12 layers and the 100-unit
    # head: a row's products by its length, attention by its square
    per_pos = 2 * (4 * 768 ** 2 + 2 * 768 * 3072)
    assert per_pos == 14_155_776
    head = 2 * 768 ** 2 + 2 * 769 * 100 + 2 * 100
    assert costs.forward_flops([50, 128], 768, 3072, 12, 100) \
        == 12 * (per_pos * 178 + 4 * 768 * (50 ** 2 + 128 ** 2)) + 2 * head
    # padding is not counted: a step of 256 full rows is ~17.2 TFLOP, of
    # 256 rows of 50 positions under 6.7
    step = costs.step_flops([128] * 256, 768, 3072, 12, 100)
    assert step == 3 * costs.forward_flops([128] * 256, 768, 3072, 12, 100)
    assert 17.1e12 < step < 17.3e12
    assert costs.step_flops([50] * 256, 768, 3072, 12, 100) < 6.7e12
    # attention alone: QKᵀ and PV, 2·len²·h each a row and layer
    assert costs.attention_flops([4, 2], 8, 3) \
        == 2 * 3 * 2 * (16 + 4) * 8
    # Q, K, V, the output (4 B each) and a byte a real key
    assert costs.attention_bytes([4, 2], 8, 3) == 3 * 6 * (4 * 8 * 4 + 1)
    # θ, m and v read and written; a real position's id (8 B) and mask, a
    # row's wide ids and values, label, weight and offset
    assert costs.step_bytes(10, [4, 2], 3) \
        == 240 + 6 * 12 + 2 * (3 * 12 + 12)


class _Stage:
    """What the readers take of a stage: two steps of a one-layer tower."""

    def step_work(self):
        return [(costs.step_flops([4, 3], 8, 16, 1, 2),
                 costs.step_bytes(100, [4, 3], 3))] * 2

    def attention_work(self):
        return costs.attention_flops([4, 3, 4, 2], 8, 1), \
            costs.attention_bytes([4, 3, 4, 2], 8, 1)


def _ctx(ops):
    spans = h.Spans()
    spans.items += [("fit", 1.0, 2.0), ("window", 0.0, 3.0)]
    spans.add("fit.steps", 2)
    return dict(stage=_Stage(), spans=spans, units=1, window_s=3.0,
                trace=dict(ops=[(n, 0, d, s) for n, d, s in ops],
                           busy_s=1.0, window_s=3.0))


def test_the_readers_on_a_hand_made_trace():
    from benchmark import costs as c
    ops = [("gemm", 4000, "tower.forward"), ("gemm", 6000, "tower.backward"),
           ("fmha", 1000, "tower.attention"), ("adam", 400,
                                                "Optimizer.step#Adam.step"),
           ("copy", 100, "tower.adam"), ("gather", 100, "tower.step"),
           ("auc", 900, "tower.validate")]
    ctx = _ctx(ops)
    read = {m: h.reader(m)(ctx) for m in METRICS[2:]}
    step = c.bound_s(costs.step_bytes(100, [4, 3], 3),
                     costs.step_flops([4, 3], 8, 16, 1, 2))[0]
    assert read["tower_step_roofline.bert"] == pytest.approx(
        100 * step * 2 / 11600e-9)
    att = c.bound_s(costs.attention_bytes([4, 3, 4, 2], 8, 1),
                    costs.attention_flops([4, 3, 4, 2], 8, 1))[0]
    assert read["tower_attention_roofline.bert"] == pytest.approx(
        100 * att / 1000e-9)
    assert read["tower_adam_ms_per_step.bert"] == pytest.approx(
        1e3 * 500e-9 / 2)
    # no device operation in the tower's spans: no number
    none = {m: h.reader(m)(_ctx([("auc", 900, "tower.validate")]))
            for m in METRICS[2:]}
    assert none == {m: None for m in METRICS[2:]}


def test_a_traced_cpu_run_reports_what_the_cpu_can(monkeypatch):
    """The manifest gives the cell its five metrics; a traced tiny run on
    the CPU reads mfu from the host clock, and none of the device's (a CPU
    trace holds no device operation)."""
    got = {x["name"] for x in h.cell_metrics(h.manifest(), CELL,
                                             "per_layer")}
    assert got == set(METRICS)
    line = _run(monkeypatch, traced=True)
    assert line["correct"] is True
    assert 0 < line["metrics"]["mfu.bert"]["value"]
    assert set(line["metrics"]) == {"mfu.bert"}
