"""Cancellable background tasks (counterpart of
``sigdigger_tpu/tasks/base.py``, the same classes).

Equivalent of the reference's `CancellableTask` /
`CancellableController` / `MultitaskController` stack (reference
include/Suscan/CancellableTask.h:26-128, Suscan/MultitaskController.cpp):
a task processes data in blocks, reporting progress between blocks and
honoring cancellation; controllers run tasks on worker threads and fan
progress out to listeners.
"""

from __future__ import annotations

import abc
import threading
import traceback
from dataclasses import dataclass
from typing import Any, Callable


@dataclass
class TaskProgress:
    progress: float = 0.0       # 0..1
    status: str = ""
    done: bool = False
    cancelled: bool = False
    error: str | None = None
    result: Any = None


class CancellableTask(abc.ABC):
    """Block-oriented task: ``work()`` advances one block and returns
    True while there is more to do (reference CancellableTask.h:26-75
    work()/cancel() contract)."""

    def __init__(self) -> None:
        self._cancelled = threading.Event()
        self.progress = 0.0
        self.status = ""
        self.result: Any = None

    @abc.abstractmethod
    def work(self) -> bool:
        """Process one block; return True if more work remains."""

    def cancel(self) -> None:
        self._cancelled.set()

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def set_progress(self, progress: float, status: str = "") -> None:
        self.progress = float(progress)
        if status:
            self.status = status

    def run(self, on_progress: Callable[[TaskProgress], None] | None = None
            ) -> TaskProgress:
        """Run to completion synchronously (the worker-thread body)."""
        try:
            while not self.cancelled and self.work():
                if on_progress:
                    on_progress(TaskProgress(self.progress, self.status))
            state = TaskProgress(
                progress=self.progress, status=self.status,
                done=not self.cancelled, cancelled=self.cancelled,
                result=self.result,
            )
        except Exception as e:  # noqa: BLE001 — reported via error signal
            state = TaskProgress(progress=self.progress, status=self.status,
                                 error=f"{e}\n{traceback.format_exc()}")
        if on_progress:
            on_progress(state)
        return state


class TaskController:
    """One worker thread per task (reference CancellableController,
    include/Suscan/CancellableTask.h:77-128)."""

    def __init__(self) -> None:
        self._thread: threading.Thread | None = None
        self._task: CancellableTask | None = None
        self._state: TaskProgress | None = None
        self._done = threading.Event()

    def process(self, task: CancellableTask,
                on_progress: Callable[[TaskProgress], None] | None = None
                ) -> None:
        if self.running:
            raise RuntimeError("controller busy")
        self._task = task
        self._done.clear()
        self._state = None

        def body():
            self._state = task.run(on_progress)
            self._done.set()

        self._thread = threading.Thread(target=body, daemon=True)
        self._thread.start()

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def cancel(self) -> None:
        if self._task is not None:
            self._task.cancel()

    def wait(self, timeout: float | None = None) -> TaskProgress | None:
        self._done.wait(timeout)
        return self._state


class MultitaskController:
    """Registry of concurrent tasks with progress snapshots and
    cancel-all (reference include/Suscan/MultitaskController.h:36-110)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._tasks: dict[int, tuple[str, CancellableTask, TaskController]] = {}
        self._next = 1

    def push(self, title: str, task: CancellableTask) -> int:
        ctl = TaskController()
        with self._lock:
            task_id = self._next
            self._next += 1
            self._tasks[task_id] = (title, task, ctl)
        ctl.process(task)
        return task_id

    def snapshot(self) -> list[dict[str, Any]]:
        with self._lock:
            items = list(self._tasks.items())
        return [
            {"id": tid, "title": title, "progress": task.progress,
             "status": task.status, "running": ctl.running}
            for tid, (title, task, ctl) in items
        ]

    def cancel(self, task_id: int) -> None:
        with self._lock:
            entry = self._tasks.get(task_id)
        if entry:
            entry[1].cancel()

    def cancel_all(self) -> None:
        with self._lock:
            entries = list(self._tasks.values())
        for _, task, _ in entries:
            task.cancel()

    def cleanup(self) -> None:
        with self._lock:
            self._tasks = {tid: e for tid, e in self._tasks.items()
                           if e[2].running}

    def wait_all(self, timeout: float | None = None) -> None:
        with self._lock:
            entries = list(self._tasks.values())
        for _, _, ctl in entries:
            ctl.wait(timeout)
