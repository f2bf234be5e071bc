"""Rust-style Result type (port of ``tpusfm/utils/result.py``, host-only).

API parity with the reference's ``Result<T>`` (src/utils/Result.h:24-53:
Ok/Err/unwrap) and the unit type (src/utils/Unit.h).  Python code in this
repo normally raises, but stage boundaries that mirror the reference's
fallible interfaces (service handlers, native ingest) return Results so
callers can branch without try/except."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Generic, TypeVar

T = TypeVar("T")

UNIT = ()  # the unit value (Unit.h parity)


@dataclass(frozen=True)
class Result(Generic[T]):
    _value: T | None
    _error: str | None

    @staticmethod
    def ok(value: T = UNIT) -> "Result[T]":
        return Result(value, None)

    @staticmethod
    def err(message: str) -> "Result[T]":
        return Result(None, message)

    @property
    def is_ok(self) -> bool:
        return self._error is None

    @property
    def is_err(self) -> bool:
        return self._error is not None

    def unwrap(self) -> T:
        """Value or raise (Result.h:38-44 unwrap crash semantics)."""
        if self._error is not None:
            raise RuntimeError(f"unwrap of Err: {self._error}")
        return self._value

    def unwrap_or(self, default: T) -> T:
        return self._value if self._error is None else default

    @property
    def error(self) -> str | None:
        return self._error


def ensure(condition: bool, message: str = "ensure failed") -> None:
    """Hard invariant check (parity: the ensure() crash macro,
    src/common/common.h:13-23 — but raising, not trapping)."""
    if not condition:
        raise AssertionError(message)
