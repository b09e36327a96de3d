"""Graceful-shutdown idiom shared by every long-running entrypoint.

Reference counterpart: cmd/cmd.go's signal handling around server Shutdown —
one place defines the contract, every daemon reuses it. Two-phase on purpose:
handlers must be installed BEFORE the serving object boots (a supervisor that
signals the instant it sees the boot line must hit the graceful path, not the
default handler), while the wait happens after.
"""

from __future__ import annotations

import signal
import threading


def shutdown_event() -> threading.Event:
    """Install SIGTERM/SIGINT handlers that set the returned event.
    Event.wait has no handler/pause race (unlike signal.pause)."""
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    return stop


def await_shutdown(stop: threading.Event) -> None:
    """Block until a shutdown signal, then restore default SIGINT so a
    second ^C during a hung teardown still aborts the process (for the
    client role a SIGKILL would leak its kernel mount)."""
    stop.wait()
    signal.signal(signal.SIGINT, signal.SIG_DFL)
