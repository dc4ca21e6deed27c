"""Profiling idioms: RAII-style timers + device trace hooks.

Replaces the reference's util/timer.h (FunctionTimer prints wall ms on
destruction, timer.cc:79-90; CumulativeFunctionTimer prints mean at exit,
timer.cc:96-113) with context managers, and adds jax.profiler integration
for device traces (the device-side analog of RDTSC, timer.h:30-147).
"""

from __future__ import annotations

import atexit
import contextlib
import time
from typing import Dict, Optional


class FunctionTimer:
    """Context manager printing elapsed wall ms on exit.

    >>> with FunctionTimer("associate"):
    ...     do_work()
    associate took 12.345 ms
    """

    def __init__(self, name: str, printer=print):
        self.name = name
        self.printer = printer
        self.elapsed_ms: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed_ms = (time.perf_counter() - self._t0) * 1e3
        self.printer(f"{self.name} took {self.elapsed_ms:.3f} ms")
        return False


class CumulativeFunctionTimer:
    """Accumulates invocation times; reports mean at exit (or on demand)."""

    _instances: Dict[str, "CumulativeFunctionTimer"] = {}

    def __init__(self, name: str):
        self.name = name
        self.total_s = 0.0
        self.invocations = 0
        CumulativeFunctionTimer._instances[name] = self

    @contextlib.contextmanager
    def scope(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total_s += time.perf_counter() - t0
            self.invocations += 1

    @property
    def mean_ms(self) -> float:
        return (self.total_s / self.invocations * 1e3) if self.invocations else 0.0

    def report(self) -> str:
        return (f"{self.name}: {self.mean_ms:.3f} ms mean over "
                f"{self.invocations} invocations")

    @classmethod
    def report_all(cls, printer=print):
        for t in cls._instances.values():
            if t.invocations:
                printer(t.report())


atexit.register(CumulativeFunctionTimer.report_all)


class RateLoop:
    """Fixed-rate loop helper (reference RateLoop, timer.h/timer.cc):
    sleep so successive Wait() calls are ~1/rate_hz apart."""

    def __init__(self, rate_hz: float):
        self.period = 1.0 / rate_hz
        self._next = time.perf_counter() + self.period

    def wait(self):
        now = time.perf_counter()
        delay = self._next - now
        if delay > 0:
            time.sleep(delay)
        self._next = max(self._next + self.period, time.perf_counter())


@contextlib.contextmanager
def device_trace(name: str):
    """jax.profiler annotation so host spans show up in device traces."""
    import jax.profiler
    with jax.profiler.TraceAnnotation(name):
        yield


@contextlib.contextmanager
def profile_to(log_dir: str):
    """Capture a full device profile (tensorboard-format) for a region."""
    import jax.profiler
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class RateLoop:
    """Fixed-rate loop pacing (reference util/timer.h RateLoop): call
    ``sleep()`` at the end of each pass; it sleeps out the remainder of
    the 1/hz period (and resets the phase after an over-long pass so a
    slow iteration does not cause a burst of catch-up passes).

    The reference's RDTSC cycle counter has no equivalent here by
    design: a raw TSC is meaningless for device-side work — use
    FunctionTimer / jax.profiler scopes instead.
    """

    def __init__(self, hz: float):
        if hz <= 0:
            raise ValueError(f"RateLoop needs hz > 0, got {hz}")
        self.period_s = 1.0 / hz
        self._next = time.perf_counter() + self.period_s

    def sleep(self):
        now = time.perf_counter()
        remaining = self._next - now
        if remaining > 0:
            time.sleep(remaining)
            self._next += self.period_s
        else:
            self._next = now + self.period_s
