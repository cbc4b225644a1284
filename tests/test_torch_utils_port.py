"""The port's ``utils/profiler.py`` and ``utils/config.py`` against the JAX
package's (``tests/test_utils.py``'s cases, and both packages' configs on
the same environment).

- ``StepTimer`` fences on a tensor probe (a CPU probe needs no fence) and
  keeps its laps; ``stop`` before ``start`` raises; ``fenced_call`` returns
  the call's result and a time, probing the first tensor leaf or the
  caller's ``probe_of``; ``trace`` writes a Chrome trace holding an
  ``annotate`` span.
- ``FrameworkConfig`` has the JAX fields and defaults; the
  ``FLINK_ML_TPU_*`` overrides (int fields coerced) give both packages the
  same config; ``resolve_cache_dir`` returns the configured path or a
  fresh tmp dir each call.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from flink_ml_tpu.utils import config as JC
from flink_ml_tpu_torch.utils import config as TC
from flink_ml_tpu_torch.utils import profiler as TP


def test_step_timer_laps_and_errors():
    t = TP.StepTimer().start()
    x = torch.ones(64, 64) @ torch.ones(64, 64)
    elapsed = t.stop(probe=x)
    assert elapsed > 0 and t.laps == [elapsed]
    t.start()
    second = t.stop()
    assert t.laps == [elapsed, second]
    with pytest.raises(RuntimeError, match="before start"):
        t.stop()


@pytest.mark.parametrize("result,probe", [
    ((3, {"a": torch.zeros(2)}, torch.ones(1)), "a"),
    ([torch.ones(3)], "first"),
    ({"n": 1, "m": "s"}, None),
])
def test_default_probe_takes_the_first_tensor_leaf(result, probe):
    got = TP._default_probe(result)
    if probe is None:
        assert got is None
    else:
        want = result[1]["a"] if probe == "a" else result[0]
        assert got is want


def test_fenced_call_returns_result_and_seconds():
    seen = []

    def probe_of(result):
        seen.append(result)
        return result["y"]

    out, secs = TP.fenced_call(lambda a, b=1: {"y": a * b}, torch.ones(4),
                               b=3, probe_of=probe_of)
    assert secs > 0 and seen == [out]
    torch.testing.assert_close(out["y"], torch.full((4,), 3.0))
    out, secs = TP.fenced_call(lambda: (np.zeros(2), torch.zeros(2)))
    assert secs > 0 and isinstance(out[1], torch.Tensor)


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    with TP.trace(str(tmp_path / "prof")):
        with TP.annotate("port_span"):
            torch.ones(32, 32) @ torch.ones(32, 32)
    path = tmp_path / "prof" / TP.TRACE_FILE
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "port_span" for e in events)


def test_framework_config_fields_match_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(JC.FrameworkConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(TC.FrameworkConfig)]
    assert tf == jf


ENVS = [
    {},
    {"FLINK_ML_TPU_CHECKPOINT_INTERVAL": "7",
     "FLINK_ML_TPU_COMPUTE_DTYPE": "bfloat16"},
    {"FLINK_ML_TPU_LOG_EVERY_EPOCHS": "3",
     "FLINK_ML_TPU_DATA_CACHE_PATH": "/some/where",
     "FLINK_ML_TPU_AOT_CACHE_PATH": "/aot"},
]


@pytest.mark.parametrize("env", ENVS, ids=["empty", "int_and_str", "paths"])
def test_env_overrides_match_jax(monkeypatch, env):
    for k in list(os.environ):
        if k.startswith("FLINK_ML_TPU_"):
            monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    j = dataclasses.asdict(JC.FrameworkConfig.from_env())
    t = dataclasses.asdict(TC.FrameworkConfig.from_env())
    assert t == j
    base = TC.FrameworkConfig(checkpoint_interval=5)
    jbase = JC.FrameworkConfig(checkpoint_interval=5)
    assert dataclasses.asdict(TC.FrameworkConfig.from_env(base)) == \
        dataclasses.asdict(JC.FrameworkConfig.from_env(jbase))
    if "FLINK_ML_TPU_CHECKPOINT_INTERVAL" in env:
        assert TC.FrameworkConfig.from_env().checkpoint_interval == 7


def test_resolve_cache_dir(tmp_path):
    old = TC.get_config()
    try:
        TC.set_config(TC.FrameworkConfig(data_cache_path=str(tmp_path / "c")))
        path = TC.resolve_cache_dir()
        assert path == str(tmp_path / "c") and os.path.isdir(path)
        TC.set_config(TC.FrameworkConfig())  # fallback: fresh tmp dir
        p1, p2 = TC.resolve_cache_dir(), TC.resolve_cache_dir()
        assert p1 != p2 and os.path.isdir(p1) and os.path.isdir(p2)
        os.rmdir(p1)
        os.rmdir(p2)
    finally:
        TC.set_config(old)
