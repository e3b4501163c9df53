"""Generic retry with exponential backoff + jitter (port of
paddle_tpu/resilience/retry.py).

The HDFS retry loops of Paddle's fleet/utils/fs.py (every hadoop CLI call
is wrapped in ``while retry < max: sleep(sleep_inter)``), made one policy
that FS transfers, the elastic heartbeat and checkpoint staging share.
Defaults come from ``FLAGS_retry_max_attempts`` / ``FLAGS_retry_backoff_base``
and are read at call time, so ``paddle.set_flags`` retunes a live process.

The clock and sleep functions are injectable: the chaos tests drive
exhaustion with a fake clock and check the backoff schedule without
sleeping.
"""
from __future__ import annotations

import functools
import random
import time

__all__ = ["retry", "retry_call", "RetryExhausted"]


class RetryExhausted(RuntimeError):
    """Raised only when a retry loop has no exception to re-raise (cannot
    happen through the public API)."""


def _flag(name, default):
    from ..framework.flags import get_flag
    v = get_flag(name, default)
    return default if v is None else v


def retry_call(fn, *args, max_attempts=None, backoff=None, max_backoff=30.0,
               jitter=0.1, retry_on=(Exception,), timeout=None, sleep=None,
               clock=None, on_retry=None, **kwargs):
    """Call ``fn(*args, **kwargs)`` with up to ``max_attempts`` tries.

    - backoff: base delay; attempt k (1-based) sleeps
      ``backoff * 2**(k-1)`` capped at max_backoff, plus up to ``jitter``
      of it at random (decorrelates retry storms).
    - retry_on: exception classes that trigger a retry; anything else
      propagates at once.
    - timeout: total budget measured with ``clock``; once spent, the last
      exception is re-raised even if attempts remain.
    - sleep/clock: injectable (default time.sleep/time.monotonic).
    - on_retry: callback ``(attempt, exc, delay)`` before each sleep.

    On exhaustion the LAST exception is re-raised unchanged: an FS path
    that keeps timing out surfaces as FSTimeOut, not a wrapper type.
    """
    attempts = int(max_attempts if max_attempts is not None
                   else _flag("FLAGS_retry_max_attempts", 3))
    base = float(backoff if backoff is not None
                 else _flag("FLAGS_retry_backoff_base", 0.5))
    attempts = max(1, attempts)
    _sleep = time.sleep if sleep is None else sleep
    _clock = time.monotonic if clock is None else clock
    start = _clock()
    for attempt in range(1, attempts + 1):
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            if attempt >= attempts:
                raise
            if timeout is not None and _clock() - start >= timeout:
                raise
            delay = min(base * (2.0 ** (attempt - 1)), max_backoff)
            if jitter:
                delay += delay * jitter * random.random()
            if on_retry is not None:
                on_retry(attempt, e, delay)
            _sleep(delay)
    raise RetryExhausted("retry loop exited without a result")  # unreachable


def retry(fn=None, **policy):
    """Decorator form: ``@retry(max_attempts=5, retry_on=(FSTimeOut,))``.
    Omitted policy keywords fall back to the FLAGS_retry_* defaults at
    each call."""
    def deco(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            return retry_call(f, *args, **policy, **kwargs)
        wrapper.__retry_policy__ = dict(policy)
        return wrapper
    if fn is not None:
        return deco(fn)
    return deco
