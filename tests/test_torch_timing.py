"""gdmix_tpu_torch/util/timing.py against gdmix_tpu/util/timing.py: the
phase log line and the resident set (tests/test_util.py:10-18), the
dispatch-latency probe and its class rule, and the torch.profiler trace of
device_profile, on the CPU."""
import glob
import logging
import os

import pytest
import torch

from gdmix_tpu.util import timing as jax_timing
from gdmix_tpu_torch.util import timing


def test_phase_logs(caplog):
    with caplog.at_level(logging.INFO, logger="gdmix_tpu_torch.util.timing"):
        with timing.phase("unit-test-phase"):
            pass
    got = [r.message for r in caplog.records if "unit-test-phase" in r.message]
    assert len(got) == 1
    # the JAX package's line, field for field
    with caplog.at_level(logging.INFO, logger="gdmix_tpu.util.timing"):
        with jax_timing.phase("unit-test-phase"):
            pass
    want = [r.message for r in caplog.records
            if r.name == "gdmix_tpu.util.timing"][-1]
    assert got[0].split(" --- ")[0] == want.split(" --- ")[0]
    assert got[0].split(" --- ")[2].split(":")[0] \
        == want.split(" --- ")[2].split(":")[0]


def test_rss():
    assert timing.rss_gb() > 0
    assert abs(timing.rss_gb() - jax_timing.rss_gb()) < 1.0


def test_dispatch_latency_probe_on_the_cpu():
    lat = timing.measure_dispatch_latency_s("cpu")
    assert 0 < lat < 5e-3
    # probed once a process: the same sample again
    assert timing.measure_dispatch_latency_s("cpu") == lat
    assert timing.nominal_dispatch_latency_s("cpu") == 1e-3


@pytest.mark.parametrize("lat", [1e-5, 4.9e-3, 5e-3, 0.03])
def test_class_rule_equals_jax(monkeypatch, lat):
    """Both packages map one measured latency to the same class."""
    monkeypatch.setattr(jax_timing, "measure_dispatch_latency_s",
                        lambda: lat)
    monkeypatch.setattr(timing, "measure_dispatch_latency_s",
                        lambda device=None: lat)
    assert timing.nominal_dispatch_latency_s("cpu") \
        == jax_timing.nominal_dispatch_latency_s()


def test_latency_probe_needs_a_card_or_the_cpu(monkeypatch):
    """No silent CPU: without a card the probe's default device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        timing.measure_dispatch_latency_s()


def test_device_profile_writes_a_trace(tmp_path, monkeypatch):
    monkeypatch.delenv("GDMIX_TPU_PROFILE", raising=False)
    out = tmp_path / "trace"
    with timing.device_profile(str(out)):
        torch.ones(64).cumsum(0).sum()
    traces = glob.glob(str(out / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        assert '"cat": "cpu_op"' in f.read()
    # GDMIX_TPU_PROFILE names the directory when no log_dir is given
    env_dir = tmp_path / "env"
    monkeypatch.setenv("GDMIX_TPU_PROFILE", str(env_dir))
    with timing.device_profile():
        torch.ones(8).sum()
    assert len(glob.glob(str(env_dir / "*.pt.trace.json"))) == 1


def test_device_profile_is_a_no_op_without_a_directory(tmp_path,
                                                       monkeypatch):
    monkeypatch.delenv("GDMIX_TPU_PROFILE", raising=False)
    monkeypatch.chdir(tmp_path)
    with timing.device_profile():
        assert not torch.autograd.profiler._is_profiler_enabled
        torch.ones(8).sum()
    assert os.listdir(tmp_path) == []
