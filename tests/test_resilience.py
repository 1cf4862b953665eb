"""Failure detection/recovery: device-fault retry + engine state rebuild."""

import numpy as np
import pytest

from raytracer_tpu.utils import resilience


class FakeJaxRuntimeError(Exception):
    pass


# is_device_fault matches on the exception TYPE NAME, so a local class
# named like the real one exercises the same path without a device.
FakeJaxRuntimeError.__name__ = "JaxRuntimeError"


def test_retry_recovers_after_transient_faults():
    calls = []

    @resilience.retry_on_device_fault(retries=3, delay_s=0.0)
    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise FakeJaxRuntimeError(
                "UNAVAILABLE: device worker process crashed or restarted."
            )
        return 42

    assert flaky() == 42
    assert len(calls) == 3


def test_retry_reraises_non_fault_errors():
    @resilience.retry_on_device_fault(retries=3, delay_s=0.0)
    def broken():
        raise ValueError("logic bug")

    with pytest.raises(ValueError):
        broken()


def test_unknown_runtime_error_reraises_immediately(monkeypatch):
    """An XlaRuntimeError whose message matches no _RETRYABLE tag must
    re-raise on the first attempt with zero sleeps — the substring table
    fails CLOSED (see resilience._RETRYABLE maintenance note)."""
    sleeps = []
    monkeypatch.setattr(resilience.time, "sleep", sleeps.append)
    calls = []

    class FakeXla(Exception):
        pass

    FakeXla.__name__ = "XlaRuntimeError"

    @resilience.retry_on_device_fault(retries=3, delay_s=10.0)
    def reworded():
        calls.append(1)
        raise FakeXla("INTERNAL: some future jaxlib wording we don't know")

    with pytest.raises(FakeXla):
        reworded()
    assert len(calls) == 1
    assert sleeps == []


def test_retry_gives_up_after_budget():
    calls = []

    @resilience.retry_on_device_fault(retries=2, delay_s=0.0)
    def always_down():
        calls.append(1)
        raise FakeJaxRuntimeError("UNAVAILABLE: worker gone")

    with pytest.raises(FakeJaxRuntimeError):
        always_down()
    assert len(calls) == 3  # initial + 2 retries


def test_engine_tick_recovers_from_device_fault(monkeypatch):
    """A worker crash mid-frame resets device state (the GL-context-loss
    analog) instead of killing the loop; the next tick renders again."""
    from raytracer_tpu.app.engine import Engine
    from raytracer_tpu.scene import presets

    scene, cam, *_ = presets.get_config("two_sphere", 32, 16)
    eng = Engine(scene, cam, 32, 16, max_depth=2)
    eng.set_paused(False)
    assert eng.tick(0.0)
    before = float(eng.render_state.render_count)
    assert before > 0

    def crash(*a, **k):
        raise FakeJaxRuntimeError(
            "UNAVAILABLE: device worker process crashed or restarted."
        )

    monkeypatch.setattr(eng, "_step_fn", lambda spp: crash)
    assert eng.tick(16.0) is False  # fault absorbed, no render this frame
    assert float(eng.render_state.render_count) == 0  # state rebuilt
    monkeypatch.undo()
    eng._step_cache.clear()
    assert eng.tick(32.0)  # next tick renders again
    assert np.isfinite(eng.framebuffer()).all()
