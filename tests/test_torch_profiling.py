"""The port's stage timer, trace context and console logging against the JAX package's.

``StageTimer`` summaries carry the same keys and accumulate the same items;
``force_materialize`` walks nested structures; ``device_trace`` writes a
trace; the log setup's level and colour switches (``SEMANTICLENS_LOG_LEVEL``,
``NO_COLOR``, ``FORCE_COLOR``, a TTY) decide as the JAX module decides, on
the port's own logger.
"""

import io
import json
import logging

import pytest
import torch

from semanticlens_tpu.utils import StageTimer as JStageTimer
from semanticlens_tpu.utils import log_setup as jlog
from semanticlens_tpu_torch.utils import StageTimer, device_trace, force_materialize
from semanticlens_tpu_torch.utils import log_setup as tlog

torch.set_num_threads(2)


def _run_stages(timer):
    with timer.stage("collect+embed", items=100):
        pass
    with timer.stage("collect+embed", items=50):
        pass
    with timer.stage("scores"):
        pass
    return timer.summary()


def test_stage_timer_summary_matches_jax(caplog):
    with caplog.at_level(logging.INFO, logger="semanticlens_tpu_torch.utils.profiling"):
        port = _run_stages(StageTimer())
    jax_ = _run_stages(JStageTimer())
    assert list(port) == list(jax_) == ["collect+embed", "scores"]
    for name in port:
        assert set(port[name]) == set(jax_[name]), name
        assert port[name]["items"] == jax_[name]["items"]
    assert port["collect+embed"]["items"] == 150
    assert port["collect+embed"]["items_per_sec"] == pytest.approx(150 / port["collect+embed"]["seconds"])
    assert "items_per_sec" not in port["scores"]
    assert "[stage:collect+embed]" in caplog.text


def test_stage_timer_counts_a_stage_that_raises():
    timer = StageTimer()
    with pytest.raises(RuntimeError):
        with timer.stage("boom", items=3):
            raise RuntimeError("stage failed")
    assert timer.summary()["boom"]["items"] == 3


def test_force_materialize_nested_and_device_trace(tmp_path):
    tree = {"a": torch.ones(2, 2), "b": [torch.zeros(3), (torch.arange(4), "not a tensor")], "c": 1.5}
    force_materialize(tree)  # walks dicts, lists and tuples; leaves other values alone
    with device_trace(str(tmp_path)):
        x = torch.ones(64, 64)
        force_materialize((x @ x).sum())
    trace = tmp_path / "trace.json"
    assert trace.exists() and "traceEvents" in json.loads(trace.read_text())


class _Stream(io.StringIO):
    def __init__(self, tty: bool):
        super().__init__()
        self._tty = tty

    def isatty(self):
        return self._tty


@pytest.mark.parametrize("env,tty", [({}, False), ({}, True), ({"NO_COLOR": "1"}, True),
                                     ({"FORCE_COLOR": "1"}, False), ({"NO_COLOR": "1", "FORCE_COLOR": "1"}, True)],
                         ids=["pipe", "tty", "no-color", "force-color", "no-color-wins"])
def test_colour_switches_match_jax(monkeypatch, env, tty):
    for var in ("NO_COLOR", "FORCE_COLOR"):
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    stream = _Stream(tty)
    assert tlog._color_wanted(stream) == jlog._color_wanted(stream) == (tty and "NO_COLOR" not in env
                                                                        or "FORCE_COLOR" in env and "NO_COLOR" not in env)


@pytest.mark.parametrize("env,requested", [(None, "DEBUG"), ("WARNING", "DEBUG"), ("shouty", "DEBUG"),
                                           (None, "error")])
def test_level_resolution_matches_jax(monkeypatch, env, requested):
    if env is None:
        monkeypatch.delenv("SEMANTICLENS_LOG_LEVEL", raising=False)
    else:
        monkeypatch.setenv("SEMANTICLENS_LOG_LEVEL", env)
    assert tlog.resolve_level(requested) == jlog.resolve_level(requested)


def test_setup_configures_the_ports_logger(tmp_path, monkeypatch):
    monkeypatch.delenv("SEMANTICLENS_LOG_LEVEL", raising=False)
    assert tlog.PACKAGE == "semanticlens_tpu_torch"
    log_file = tmp_path / "out.log"
    logger = tlog.setup_colored_logging("DEBUG", str(log_file))
    n_handlers = len(logger.handlers)
    assert logger is logging.getLogger("semanticlens_tpu_torch") and logger.level == logging.DEBUG
    logging.getLogger("semanticlens_tpu_torch.sub").info("hello file")
    for h in logger.handlers:
        h.flush()
    assert "hello file" in log_file.read_text() and "\033[" not in log_file.read_text()
    assert len(tlog.setup_colored_logging("INFO").handlers) == n_handlers - 1  # replaced, not stacked
    record = logging.LogRecord("x", logging.ERROR, __file__, 1, "boom", (), None)
    assert (tlog.ColorFormatter("%(levelname)s %(message)s", use_color=True).format(record)
            == jlog.ColorFormatter("%(levelname)s %(message)s", use_color=True).format(record))
