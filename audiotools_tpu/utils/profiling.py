"""Pipeline stage timing + JAX profiler hooks.

The reference has no tracing subsystem (SURVEY.md §5 — its closest
analog is per-job progress instrumentation); this build adds the
two layers SURVEY §5 prescribes:

* ``stage_timer(stages, name)`` — cheap wall-clock accumulators around
  the host pipeline stages (read/qpack/submit/fetch/emit/write), keyed
  by ``ATPU_PROFILE=1``.  Codec pipelines print the split on close so
  device waits are distinguishable from host CPU.
* ``named_scope(name)`` / ``trace(path)`` — ``jax.named_scope`` and
  ``jax.profiler`` wrappers so device programs annotate their op graphs
  per codec stage and whole runs can be captured for TensorBoard
  (``ATPU_JAX_TRACE=<dir>`` captures automatically around encodes).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time


def profiling_enabled():
    return os.environ.get("ATPU_PROFILE", "") not in ("", "0")


class StageTimers:
    """wall-clock + thread-CPU accumulators for named pipeline stages

    thread-safe enough for the encode pipeline's two threads: each
    stage name is only ever timed from one thread, and report() runs
    after join().  Thread CPU (``time.thread_time``) distinguishes a
    stage that BURNS the single core from one merely waiting behind
    it: on the 1-core bench hosts wall times inflate with contention
    while CPU times stay honest."""

    def __init__(self, name):
        self.name = name
        self.totals = {}
        self.cpu = {}
        self.counts = {}
        self.t0 = time.perf_counter()
        self.c0 = time.process_time()

    @contextlib.contextmanager
    def __call__(self, stage):
        start = time.perf_counter()
        cstart = time.thread_time()
        try:
            yield
        finally:
            dt = time.perf_counter() - start
            dc = time.thread_time() - cstart
            self.totals[stage] = self.totals.get(stage, 0.0) + dt
            self.cpu[stage] = self.cpu.get(stage, 0.0) + dc
            self.counts[stage] = self.counts.get(stage, 0) + 1

    def add(self, stage, dt):
        self.totals[stage] = self.totals.get(stage, 0.0) + dt
        self.counts[stage] = self.counts.get(stage, 0) + 1

    def report(self, stream=None, extra=""):
        stream = stream or sys.stderr
        wall = time.perf_counter() - self.t0
        cpu = time.process_time() - self.c0
        lines = ["[ATPU_PROFILE] %s: wall %.1f ms, process CPU "
                 "%.1f ms %s" % (self.name, wall * 1e3, cpu * 1e3,
                                 extra)]
        for stage in sorted(self.totals, key=self.totals.get,
                            reverse=True):
            n = self.counts[stage]
            tot = self.totals[stage] * 1e3
            c = self.cpu.get(stage, 0.0) * 1e3
            lines.append("  %-24s %9.1f ms wall %9.1f ms cpu"
                         "  (%4d calls, %6.2f/%6.2f ms/call)"
                         % (stage, tot, c, n, tot / max(n, 1),
                            c / max(n, 1)))
        print("\n".join(lines), file=stream, flush=True)


class _NullTimers:
    name = None

    @contextlib.contextmanager
    def __call__(self, stage):
        yield

    def add(self, stage, dt):
        pass

    def report(self, stream=None, extra=""):
        pass


_NULL = _NullTimers()


def stage_timer(name):
    """a StageTimers when ATPU_PROFILE is set, else a no-op object"""
    return StageTimers(name) if profiling_enabled() else _NULL


def named_scope(name):
    """jax.named_scope when jax is importable, else a null context

    annotates device op graphs per codec stage (XLA profiles and HLO
    dumps show the stage names)"""
    try:
        import jax
        return jax.named_scope(name)
    except Exception:
        return contextlib.nullcontext()


@contextlib.contextmanager
def trace(label="atpu"):
    """captures a jax.profiler trace around the block when
    ATPU_JAX_TRACE=<dir> is set (view with TensorBoard)"""
    trace_dir = os.environ.get("ATPU_JAX_TRACE", "")
    if not trace_dir:
        yield
        return
    import jax
    with jax.profiler.trace(os.path.join(trace_dir, label)):
        yield
