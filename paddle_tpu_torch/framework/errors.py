"""Typed error taxonomy + enforce helpers (counterpart of
paddle_tpu/framework/errors.py, copied with the same names).

Ref parity: paddle/fluid/platform/errors.h + error_codes.proto (the
PADDLE_ENFORCE_* macros of platform/enforce.h). User-facing errors carry
the op/context in the message.
"""

from __future__ import annotations

__all__ = [
    "PaddleError", "InvalidArgumentError", "NotFoundError",
    "OutOfRangeError", "AlreadyExistsError", "ResourceExhaustedError",
    "PreconditionNotMetError", "PermissionDeniedError", "UnavailableError",
    "FatalError", "UnimplementedError", "ExecutionTimeoutError",
    "enforce", "enforce_eq", "enforce_gt", "enforce_shape",
    "retry_with_backoff",
]


class PaddleError(Exception):
    """Base of the taxonomy (error_codes.proto)."""


class InvalidArgumentError(PaddleError, ValueError):
    pass


class NotFoundError(PaddleError, KeyError):
    pass


class OutOfRangeError(PaddleError, IndexError):
    pass


class AlreadyExistsError(PaddleError):
    pass


class ResourceExhaustedError(PaddleError, MemoryError):
    pass


class PreconditionNotMetError(PaddleError, RuntimeError):
    pass


class PermissionDeniedError(PaddleError):
    pass


class UnavailableError(PaddleError, RuntimeError):
    pass


class FatalError(PaddleError, RuntimeError):
    pass


class UnimplementedError(PaddleError, NotImplementedError):
    pass


class ExecutionTimeoutError(PaddleError, TimeoutError):
    pass


def retry_with_backoff(fn, *, retries=3, base_delay=0.1, max_delay=2.0,
                       exceptions=(OSError,), stat=None, description=""):
    """Run `fn()` retrying on `exceptions` with exponential backoff.

    Shared by checkpoint I/O and the launch bootstrap (transient
    filesystem / port / coordinator failures). `retries` is the number
    of RE-tries after the first attempt; delays are base_delay * 2**k
    capped at max_delay. Each retry bumps monitor counter ``retries``
    (plus ``<stat>`` when given) and warns with `description`, so flaky
    infrastructure is visible instead of silent.
    """
    import time
    import warnings

    from . import monitor

    attempt = 0
    while True:
        try:
            return fn()
        except exceptions as e:
            if attempt >= retries:
                raise
            delay = min(base_delay * (2 ** attempt), max_delay)
            attempt += 1
            monitor.stat_add("retries")
            if stat:
                monitor.stat_add(stat)
            warnings.warn(
                f"{description or 'operation'} failed ({e!r}); retry "
                f"{attempt}/{retries} in {delay:.2f}s")
            time.sleep(delay)


def enforce(cond, message, error_cls=InvalidArgumentError):
    """PADDLE_ENFORCE analogue (platform/enforce.h)."""
    if not cond:
        raise error_cls(message)


def enforce_eq(a, b, message="", error_cls=InvalidArgumentError):
    if a != b:
        raise error_cls(f"expected {a!r} == {b!r}"
                        + (f": {message}" if message else ""))


def enforce_gt(a, b, message="", error_cls=InvalidArgumentError):
    if not a > b:
        raise error_cls(f"expected {a!r} > {b!r}"
                        + (f": {message}" if message else ""))


def enforce_shape(tensor, expected, message=""):
    got = tuple(tensor.shape)
    exp = tuple(expected)
    ok = len(got) == len(exp) and all(
        e in (-1, None) or g == e for g, e in zip(got, exp))
    if not ok:
        raise InvalidArgumentError(
            f"shape mismatch: got {got}, expected {exp}"
            + (f": {message}" if message else ""))
