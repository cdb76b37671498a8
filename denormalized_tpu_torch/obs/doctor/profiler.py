"""On-demand sampling profiler: folded stacks for flamegraphs.

A daemon thread samples ``sys._current_frames()`` at ``hz`` (default
~100), folds each thread's stack into the classic semicolon-joined
``frame;frame;frame`` form (outermost first, prefixed with the thread
name), and counts occurrences — the exact input ``flamegraph.pl`` and
speedscope's "folded" importer consume.

Opt-in and per-query: started/stopped through the doctor HTTP surface
(``POST /queries/<id>/profile/start|stop``) or ``QueryHandle``; the
sampler is process-wide (``_current_frames`` sees every thread) but its
lifetime is tied to the query that asked.  Overhead is the GIL pause of
one frame walk per tick — measured by ``bench.py run_obs_overhead``
(``obs_profiler_ratio``) and documented in docs/observability.md; the
default-off state costs literally nothing.
"""

from __future__ import annotations

import sys
import threading
import time


class SamplingProfiler:
    def __init__(self, hz: float = 100.0, max_stack_depth: int = 64):
        if hz <= 0:
            raise ValueError(f"profiler hz must be > 0, got {hz}")
        self.interval_s = 1.0 / float(hz)
        self.max_stack_depth = int(max_stack_depth)
        self.samples_taken = 0
        self._counts: dict[str, int] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "SamplingProfiler":
        if self.running:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="obs-doctor-profiler"
        )
        self._thread.start()
        return self

    def stop(self) -> int:
        """Stop sampling; returns the number of samples taken."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        with self._lock:
            # the join can time out with the sampler mid-flush; the
            # counter is only coherent with the sample buffer under its
            # lock
            return self.samples_taken

    def _run(self) -> None:
        own = threading.get_ident()
        while not self._stop.wait(self.interval_s):
            self._sample_once(own)

    def _sample_once(self, own_tid: int) -> None:
        names = {t.ident: t.name for t in threading.enumerate()}
        frames = sys._current_frames()
        folded: list[str] = []
        for tid, frame in frames.items():
            if tid == own_tid:
                continue
            stack: list[str] = []
            f = frame
            while f is not None and len(stack) < self.max_stack_depth:
                code = f.f_code
                stack.append(f"{code.co_filename.rsplit('/', 1)[-1]}:"
                             f"{code.co_name}")
                f = f.f_back
            stack.reverse()
            tname = names.get(tid, f"tid-{tid}")
            folded.append(";".join([tname] + stack))
        with self._lock:
            self.samples_taken += 1
            for key in folded:
                self._counts[key] = self._counts.get(key, 0) + 1

    def folded(self) -> str:
        """The folded-stack text: one ``stack count`` line per distinct
        stack, heaviest first."""
        with self._lock:
            items = sorted(
                self._counts.items(), key=lambda kv: kv[1], reverse=True
            )
        return "\n".join(f"{stack} {count}" for stack, count in items)
