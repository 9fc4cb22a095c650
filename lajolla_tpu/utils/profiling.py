"""Wall-clock phase timing + optional device tracing.

The reference exposes a bare Timer printed around parse/render phases
(src/timer.h:10-20, main.cpp:34-42). Here: a context-manager Timer with
the same role, plus an opt-in `device_trace` wrapper around
jax.profiler.trace for capturing XLA timelines (view with TensorBoard or
xprof)."""

import contextlib
import time


class Timer:
    def __init__(self, label=None, report=None):
        self.label = label
        self.report = report
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.time() - self._t0
        if self.report:
            self.report(f"{self.label}: {self.elapsed:.3f}s")
        elif self.label:
            print(f"{self.label}: {self.elapsed:.3f}s")
        return False


@contextlib.contextmanager
def device_trace(log_dir):
    """Capture a device profile of the enclosed region into log_dir."""
    import jax
    with jax.profiler.trace(log_dir):
        yield
