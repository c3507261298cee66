"""Execution backends: the scheduler/cluster seam.

The reference abstracts "where tasks run" behind the SCRIPT_TASK_SERVER /
TASK_DRIVER functor seam (lib/base/script_task_server.ml:5-20,
queue_server.ml:6-11) with Local (fork/exec + retry) and SGE (qsub/qstat)
drivers, tested via an in-memory fake (queue_server_test.ml:6-33).

Here the seam is a Backend protocol over Python callables:

* LocalBackend  — in-process bounded scheduler (the ``local`` mode);
* RetryBackend  — wraps a backend with bounded retry + backoff, the role
  of local_interface.ml's 10x/5s retry loop;
* RecordingBackend — the Test_server pattern: records every submission for
  single-process tests of multi-node logic;
* (multi-process runs connect through jax.distributed in
  paramugsy_tpu.runtime.dist — the data plane is device collectives, not
  a task backend.)
"""
from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Callable, Protocol

from paramugsy_tpu.runtime.scheduler import PriorityScheduler


class Backend(Protocol):
    def submit(self, fn: Callable, *args, priority: int = 0, name: str = "") -> Future: ...

    def stop(self) -> None: ...


class LocalBackend:
    def __init__(self, run_size: int = 4):
        self._sched = PriorityScheduler(run_size)

    def submit(self, fn: Callable, *args, priority: int = 0, name: str = "") -> Future:
        return self._sched.submit(fn, *args, priority=priority, name=name)

    def stop(self) -> None:
        self._sched.stop(wait=False)


class RetryBackend:
    """Bounded retry with backoff (local_interface.ml:8-35 semantics)."""

    def __init__(self, inner: Backend, retries: int = 10, backoff_s: float = 5.0):
        self.inner = inner
        self.retries = retries
        self.backoff_s = backoff_s

    def submit(self, fn: Callable, *args, priority: int = 0, name: str = "") -> Future:
        out: Future = Future()

        def attempt(n: int):
            inner_fut = self.inner.submit(fn, *args, priority=priority, name=name)

            def done(f: Future):
                exc = f.exception()
                if exc is None:
                    out.set_result(f.result())
                elif n + 1 < self.retries:
                    t = threading.Timer(self.backoff_s, attempt, args=(n + 1,))
                    t.daemon = True
                    t.start()
                else:
                    out.set_exception(exc)

            inner_fut.add_done_callback(done)

        attempt(0)
        return out

    def stop(self) -> None:
        self.inner.stop()


class RecordingBackend:
    """In-memory fake for tests (the queue_server_test.ml Test_server)."""

    def __init__(self, inner: Backend):
        self.inner = inner
        self.submissions: list[tuple[str, int]] = []
        self.completed: list[str] = []
        self._lock = threading.Lock()

    def submit(self, fn: Callable, *args, priority: int = 0, name: str = "") -> Future:
        with self._lock:
            self.submissions.append((name, priority))
        fut = self.inner.submit(fn, *args, priority=priority, name=name)

        def done(f: Future):
            if f.exception() is None:
                with self._lock:
                    self.completed.append(name)

        fut.add_done_callback(done)
        return fut

    def stop(self) -> None:
        self.inner.stop()
