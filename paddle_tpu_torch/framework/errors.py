"""Typed error taxonomy (port of paddle_tpu/framework/errors.py; reference:
paddle/fluid/platform/error_codes.proto + platform/errors.h + enforce.h).

The reference carries a 13-code enum through every PADDLE_ENFORCE_* macro and
renders "InvalidArgumentError"-style type strings in python tracebacks; the
codes keep the reference's numbering, and ``raise_from_code`` rehydrates the
typed exception for a code.

Each typed error also inherits the closest builtin (ValueError,
FileNotFoundError, NotImplementedError, ...) so idiomatic python call sites
(`except ValueError`) keep working — the reference's pybind layer does the
same mapping for a few codes.
"""
from __future__ import annotations

__all__ = [
    "EnforceNotMet", "InvalidArgumentError", "NotFoundError",
    "OutOfRangeError", "AlreadyExistsError", "ResourceExhaustedError",
    "PreconditionNotMetError", "PermissionDeniedError", "ExecutionTimeoutError",
    "UnimplementedError", "UnavailableError", "FatalError", "ExternalError",
    "InvalidArgument", "NotFound", "OutOfRange", "AlreadyExists",
    "ResourceExhausted", "PreconditionNotMet", "PermissionDenied",
    "ExecutionTimeout", "Unimplemented", "Unavailable", "Fatal", "External",
    "raise_from_code", "code_of",
]


class EnforceNotMet(RuntimeError):
    """Base of all enforce failures (reference EnforceNotMet). `code` follows
    error_codes.proto; `type_str` is the reference's error type string."""
    code = 0
    type_str = "Error"

    def __str__(self):
        base = super().__str__()
        return f"{self.type_str}: {base}" if self.type_str != "Error" else base


class InvalidArgumentError(EnforceNotMet, ValueError):
    code = 1
    type_str = "InvalidArgumentError"


class NotFoundError(EnforceNotMet, FileNotFoundError):
    code = 2
    type_str = "NotFoundError"

    def __init__(self, *args):
        # FileNotFoundError's OSError init eats single-str args into
        # .strerror; keep plain Exception semantics so str(e) is the message
        Exception.__init__(self, *args)


class OutOfRangeError(EnforceNotMet, IndexError):
    code = 3
    type_str = "OutOfRangeError"


class AlreadyExistsError(EnforceNotMet):
    code = 4
    type_str = "AlreadyExistsError"


class ResourceExhaustedError(EnforceNotMet, MemoryError):
    code = 5
    type_str = "ResourceExhaustedError"


class PreconditionNotMetError(EnforceNotMet):
    code = 6
    type_str = "PreconditionNotMetError"


class PermissionDeniedError(EnforceNotMet):
    code = 7
    type_str = "PermissionDeniedError"


class ExecutionTimeoutError(EnforceNotMet, TimeoutError):
    code = 8
    type_str = "ExecutionTimeout"

    def __init__(self, *args):
        Exception.__init__(self, *args)


class UnimplementedError(EnforceNotMet, NotImplementedError):
    code = 9
    type_str = "UnimplementedError"


class UnavailableError(EnforceNotMet):
    code = 10
    type_str = "UnavailableError"


class FatalError(EnforceNotMet):
    code = 11
    type_str = "FatalError"


class ExternalError(EnforceNotMet):
    code = 12
    type_str = "ExternalError"


_BY_CODE = {c.code: c for c in (
    EnforceNotMet, InvalidArgumentError, NotFoundError, OutOfRangeError,
    AlreadyExistsError, ResourceExhaustedError, PreconditionNotMetError,
    PermissionDeniedError, ExecutionTimeoutError, UnimplementedError,
    UnavailableError, FatalError, ExternalError)}


def code_of(exc):
    """Error code of a typed exception (0 for untyped)."""
    return getattr(exc, "code", 0)


def raise_from_code(code, message):
    """Rehydrate the typed exception for an error code."""
    raise _BY_CODE.get(int(code), EnforceNotMet)(message)


# ---- factory helpers (platform::errors::InvalidArgument(...) parity) ----
# The reference builds *error objects* passed to PADDLE_ENFORCE/PADDLE_THROW;
# in python the idiom is `raise errors.InvalidArgument("...")` — each factory
# returns an exception instance so both `raise` and enforce-style use work.

def _factory(cls):
    def make(fmt, *args):
        return cls(fmt % args if args else fmt)
    make.__name__ = cls.type_str or cls.__name__
    make.__doc__ = f"Build a {cls.__name__} (reference errors.h factory)."
    return make


InvalidArgument = _factory(InvalidArgumentError)
NotFound = _factory(NotFoundError)
OutOfRange = _factory(OutOfRangeError)
AlreadyExists = _factory(AlreadyExistsError)
ResourceExhausted = _factory(ResourceExhaustedError)
PreconditionNotMet = _factory(PreconditionNotMetError)
PermissionDenied = _factory(PermissionDeniedError)
ExecutionTimeout = _factory(ExecutionTimeoutError)
Unimplemented = _factory(UnimplementedError)
Unavailable = _factory(UnavailableError)
Fatal = _factory(FatalError)
External = _factory(ExternalError)
