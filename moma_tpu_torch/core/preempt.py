"""Preemption / failure handling: graceful-stop on SIGTERM/SIGINT.

The port's own copy of moma_tpu/core/preempt.py (pure Python, same
names).  Training runs under a GracefulStop guard: on SIGTERM (cluster
preemption) or the first Ctrl-C the flag is set, the epoch loop finishes
the in-flight step, the runner checkpoints full state to `latest` and
exits cleanly, so `--resume` continues from at most one step's loss of
work.  A second SIGINT falls through to the default handler (hard
stop).
"""

from __future__ import annotations

import signal
import threading


class GracefulStop:
    """Context manager installing stop-flag signal handlers.

    Usage:
        with GracefulStop() as stop:
            for epoch in ...:
                state, m = train_one_epoch(..., stop=stop)
                if stop.stopping:
                    ckpt.save("latest", ...); break
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = signals
        self._event = threading.Event()
        self._prev = {}

    @property
    def stopping(self) -> bool:
        return self._event.is_set()

    def _handler(self, signum, frame):
        if self._event.is_set() and signum == signal.SIGINT:
            # second Ctrl-C: restore default behavior and re-raise
            signal.signal(signal.SIGINT, signal.default_int_handler)
            raise KeyboardInterrupt
        print(
            f"[preempt] caught signal {signum}: finishing current step, "
            "checkpointing, then exiting (send SIGINT again to force)",
            flush=True,
        )
        self._event.set()

    def __enter__(self):
        for s in self._signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:
                # not in the main thread (e.g. under pytest-xdist): flag
                # still works via .request(), signals just aren't hooked
                pass
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        return False

    def request(self):
        """Programmatic stop (tests, external watchdogs)."""
        self._event.set()


class _NeverStop:
    stopping = False

    def request(self):  # pragma: no cover - interface parity
        pass


NEVER = _NeverStop()
