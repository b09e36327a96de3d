"""Token-bucket rate limiting (QoS primitives).

Reference counterparts: master/limiter.go (per-API op limits backed by
golang.org/x/time/rate buckets) and blobstore/access/limiter.go (read/write
bandwidth + concurrency gates on the gateway). One implementation serves both:
a monotonic-clock token bucket plus a keyed registry for per-op / per-client
buckets.
"""

from __future__ import annotations

import time

from chubaofs_tpu_torch.utils.locks import SanitizedLock


class RateLimitExceeded(Exception):
    pass


class TokenBucket:
    """Thread-safe token bucket: `rate` tokens/sec, capacity `burst`.

    acquire() blocks up to `timeout` for tokens (None = forever); try_acquire()
    never blocks. rate <= 0 means unlimited.
    """

    def __init__(self, rate: float, burst: float | None = None):
        self.rate = float(rate)
        self.burst = float(burst if burst is not None else max(rate, 1.0))
        self._tokens = self.burst
        self._last = time.monotonic()
        self._lock = SanitizedLock(name="ratelimit.bucket")

    def _refill_locked(self, now: float) -> None:
        self._tokens = min(self.burst, self._tokens + (now - self._last) * self.rate)
        self._last = now

    def try_acquire(self, n: float = 1.0) -> bool:
        if self.rate <= 0:
            return True
        with self._lock:
            now = time.monotonic()
            self._refill_locked(now)
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def debit(self, n: float = 1.0) -> None:
        """Post-hoc charge: subtract n tokens, allowing the balance to go
        NEGATIVE — the bandwidth-shaping pattern for response bytes whose
        size is only known after the handler ran (a GET's body). Future
        acquires wait until the debt refills; _refill_locked pays it down
        at the configured rate."""
        if self.rate <= 0:
            return
        with self._lock:
            self._refill_locked(time.monotonic())
            self._tokens -= n

    def wait_time(self, n: float = 1.0) -> float:
        """Seconds until n tokens COULD be available (0 when they already
        are) — the Retry-After estimate; no tokens are taken."""
        if self.rate <= 0:
            return 0.0
        with self._lock:
            self._refill_locked(time.monotonic())
            if self._tokens >= n:
                return 0.0
            return (n - self._tokens) / self.rate

    def acquire(self, n: float = 1.0, timeout: float | None = None) -> bool:
        """Take n tokens, sleeping while they accrue; False on timeout."""
        if self.rate <= 0:
            return True
        if n > self.burst:
            return False  # can never accrue n tokens — deny, don't wait
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                now = time.monotonic()
                self._refill_locked(now)
                if self._tokens >= n:
                    self._tokens -= n
                    return True
                wait = (n - self._tokens) / self.rate
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                wait = min(wait, remaining)
            time.sleep(min(wait, 0.05))


class KeyedLimiter:
    """Named buckets (per API op, per client, per volume...).

    rates maps key -> (rate, burst) or rate. Unknown keys pass through
    unlimited unless a `default` rate is given.
    """

    def __init__(self, rates: dict | None = None, default: float = 0.0):
        self._lock = SanitizedLock(name="ratelimit.keyed")
        self._buckets: dict[str, TokenBucket] = {}
        self._rates = dict(rates or {})
        self._default = default

    def _bucket(self, key: str) -> TokenBucket:
        with self._lock:
            b = self._buckets.get(key)
            if b is None:
                spec = self._rates.get(key, self._default)
                rate, burst = spec if isinstance(spec, tuple) else (spec, None)
                b = TokenBucket(rate, burst)
                self._buckets[key] = b
            return b

    def set_rate(self, key: str, rate: float, burst: float | None = None) -> None:
        """Runtime-mutable limits (the reference exposes these via admin API)."""
        with self._lock:
            self._rates[key] = (rate, burst)
            self._buckets.pop(key, None)

    def allow(self, key: str, n: float = 1.0) -> bool:
        return self._bucket(key).try_acquire(n)

    def wait(self, key: str, n: float = 1.0, timeout: float | None = None) -> bool:
        return self._bucket(key).acquire(n, timeout)

    def check(self, key: str, n: float = 1.0) -> None:
        """Raise RateLimitExceeded when the bucket is dry (fail-fast APIs)."""
        if not self.allow(key, n):
            raise RateLimitExceeded(f"rate limit exceeded for {key!r}")
