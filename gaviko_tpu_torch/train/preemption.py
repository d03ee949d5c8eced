"""Preemption-safe training: catch SIGTERM/SIGINT, checkpoint, exit clean.

A copy of ``gaviko_tpu/train/preemption.py`` (pure Python, so the port keeps
its own rather than importing the JAX package). Cloud machines are preempted
with a SIGTERM + grace window (and an interactive run dies to Ctrl-C); the
reference has no recovery story at all (SURVEY.md §5 — its only failure
handling is early stopping). Here the train loop polls
:class:`PreemptionGuard` at every step boundary: on a signal it finishes the
in-flight step, saves the full resume state (params + optimizer + progress,
including the intra-epoch step index), and returns — ``--resume auto`` then
continues from the exact batch after the last completed step.

The guard is a context manager so entry points restore the previous handlers
(pytest installs its own SIGINT handling). Installing handlers is only legal
in the main thread; anywhere else the guard degrades to an inert flag (a
thread-spawned training run keeps working, just without signal capture).
"""

from __future__ import annotations

import logging
import signal
import threading


class PreemptionGuard:
    """Context manager that latches SIGTERM/SIGINT into a poll-able flag.

    The first signal sets ``preempted`` (and logs); a SECOND SIGINT restores
    the default handler and re-raises immediately, so a double Ctrl-C still
    kills a run whose current step is stuck in a long compile.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = tuple(signals)
        self._previous = {}
        self._event = threading.Event()
        self._sigint_count = 0

    @property
    def preempted(self) -> bool:
        return self._event.is_set()

    def _handler(self, signum, frame):
        if signum == signal.SIGINT:
            self._sigint_count += 1
            if self._sigint_count >= 2:
                signal.signal(signal.SIGINT, signal.default_int_handler)
                raise KeyboardInterrupt
        if not self._event.is_set():
            logging.warning(
                "Received %s — finishing the current step, saving resume "
                "state, then exiting (send SIGINT again to abort now).",
                signal.Signals(signum).name,
            )
        self._event.set()

    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is not threading.main_thread():
            return self  # inert: flag never set by signals, still poll-able
        for sig in self._signals:
            try:
                self._previous[sig] = signal.signal(sig, self._handler)
            except (ValueError, OSError):  # exotic hosts without the signal
                pass
        return self

    def __exit__(self, *exc) -> None:
        for sig, prev in self._previous.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._previous.clear()
        return None
