"""Circuit breaker — the access client's hystrix analog.

Reference counterpart: blobstore/access wraps allocator/proxy calls in
hystrix commands (stream_put.go:68 allocFromAllocatorWithHystrix), so a dead
or drowning control-plane dependency fails PUTs FAST instead of stacking
every request behind timeouts. Same contract here: count failures in a
sliding window; past the threshold the circuit OPENS and calls raise
CircuitOpen immediately for a cooldown; after the cooldown ONE probe call is
admitted (half-open) — success closes the circuit, failure re-opens it.
"""

from __future__ import annotations

import threading
import time


class CircuitOpen(Exception):
    """Fail-fast: the wrapped dependency is considered down."""


class CircuitBreaker:
    def __init__(self, name: str = "", failures: int = 5,
                 window: float = 10.0, cooldown: float = 15.0):
        self.name = name
        self.failures = failures
        self.window = window
        self.cooldown = cooldown
        self._lock = threading.Lock()
        self._fail_times: list[float] = []
        self._open_until = 0.0
        self._probing = False

    @property
    def state(self) -> str:
        with self._lock:
            if time.monotonic() < self._open_until:
                return "open"
            return "half-open" if self._open_until else "closed"

    def call(self, fn, *args, **kwargs):
        with self._lock:
            now = time.monotonic()
            if now < self._open_until:
                raise CircuitOpen(
                    f"{self.name or fn.__name__}: circuit open "
                    f"({self._open_until - now:.1f}s left)")
            if self._open_until:  # cooldown elapsed: admit ONE probe
                if self._probing:
                    raise CircuitOpen(f"{self.name}: probe in flight")
                self._probing = True
        done = False
        try:
            result = fn(*args, **kwargs)
            done = True
        except Exception:
            self._record_failure()
            done = True
            raise
        finally:
            if not done:  # BaseException (KeyboardInterrupt, ...) escaped:
                with self._lock:  # the probe slot must not wedge shut
                    self._probing = False
        with self._lock:
            self._fail_times.clear()
            self._open_until = 0.0
            self._probing = False
        return result

    def _record_failure(self) -> None:
        with self._lock:
            now = time.monotonic()
            self._probing = False
            if self._open_until:  # failed probe: straight back to open
                self._open_until = now + self.cooldown
                return
            self._fail_times = [t for t in self._fail_times
                                if now - t < self.window]
            self._fail_times.append(now)
            if len(self._fail_times) >= self.failures:
                self._open_until = now + self.cooldown
