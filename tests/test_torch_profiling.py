"""The port's ``profiling.py`` against the JAX package's: the training
FLOPs per token of every shipped model config, and ``StepTimer``'s
numbers under the same fake clock, exactly; ``peak_flops`` knows NVIDIA
cards only (989e12 for the H100 SXM, None for anything it does not know,
a CPU device included), and without a peak the timer reports no MFU."""

from pathlib import Path

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from progen_tpu import config as jconfig
from progen_tpu import profiling as jprof
from progen_tpu_torch import ProGenConfig, load_toml_config, profiling

REPO = Path(__file__).resolve().parents[1]
CONFIGS = ("tiny", "default", "base", "long8k", "large")


@pytest.mark.parametrize("name", CONFIGS)
def test_flops_per_token_equals_jax(name):
    path = str(REPO / "configs" / "model" / f"{name}.toml")
    ours = profiling.flops_per_token(
        ProGenConfig.from_dict(load_toml_config(path)))
    theirs = jprof.flops_per_token(
        jconfig.ProGenConfig(**jconfig.load_toml_config(path)))
    assert ours == theirs and ours > 0


def _tick(timer, tokens):
    try:  # a window all excluded divides by zero in both packages
        return timer.tick(tokens)
    except ZeroDivisionError:
        return "ZeroDivisionError"


@settings(max_examples=50, deadline=None, derandomize=True)
@given(ticks=st.lists(st.tuples(st.floats(0.001, 10.0),
                                st.floats(0.0, 0.5),
                                st.integers(1, 10**6)),
                      min_size=1, max_size=12),
       warmup=st.integers(0, 3), chips=st.integers(1, 8))
def test_step_timer_equals_jax_under_a_fake_clock(ticks, warmup, chips):
    now = {"t": 100.0}
    assert jprof.time is profiling.time  # the same clock for both
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(profiling.time, "perf_counter", lambda: now["t"])
        ours = profiling.StepTimer(chips, 123456, 989e12, warmup=warmup)
        theirs = jprof.StepTimer(chips, 123456, 989e12, warmup=warmup)
        for dt, excluded, tokens in ticks:
            now["t"] += dt
            for timer in (ours, theirs):
                timer.exclude(excluded)
            assert _tick(ours, tokens) == _tick(theirs, tokens)


def test_peak_flops_nvidia_only():
    assert profiling.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert profiling.peak_flops("NVIDIA H100 PCIe") == 756e12
    for unknown in ("Tesla Z9", "TPU v5 lite", "v5e"):
        assert profiling.peak_flops(unknown) is None
    assert profiling.peak_flops("cpu") is None
    assert profiling.peak_flops(torch.device("cpu")) is None


def test_no_peak_no_mfu(monkeypatch):
    now = {"t": 0.0}
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: now["t"])
    timer = profiling.StepTimer(1, 1000, None, warmup=0)
    assert timer.tick(10) is None
    now["t"] += 2.0
    timer.exclude(1.0)
    assert timer.tick(100) == {"step_ms": 1000.0,
                               "tokens_per_sec_per_chip": 100.0}
