"""Logging with error/warning semantics of the reference's log module.

A copy of ``egg_fluid_simulation_tpu/utils/log.py`` (stdlib only), so that
warnings and errors carry the same text in both packages:

- ``log.error(...)``   -> raises :class:`SimulationError` with an ``[ERROR]``-prefixed
  message including the caller's ``file:line`` (reference ``log.lua:22-30`` captures
  the call site via ``debug.getinfo``).
- ``log.warning(...)`` -> writes an ``[WARNING]``-prefixed message to stderr and
  flushes immediately (reference ``log.lua:41-45``).
- ``log.assert_types(...)`` -> type assertions over (value, expected-type) pairs,
  fatal on mismatch (reference ``log.assert`` at ``log.lua:65-88``).
"""

from __future__ import annotations

import inspect
import numbers
import sys

__all__ = ["SimulationError", "error", "warning", "assert_types"]


class SimulationError(RuntimeError):
    """Fatal simulation-configuration or API-usage error."""


def _call_site(depth: int = 2) -> str:
    """Return 'file:line' of the caller `depth` frames up, or '' if unavailable."""
    frame = inspect.currentframe()
    try:
        for _ in range(depth):
            if frame is None:
                return ""
            frame = frame.f_back
        if frame is None:
            return ""
        return f"{frame.f_code.co_filename}:{frame.f_lineno}"
    finally:
        del frame


def _format(prefix: str, parts) -> str:
    site = _call_site(depth=3)
    where = f"In {site}: " if site else ""
    return prefix + where + "".join(str(p) for p in parts)


def error(*parts) -> None:
    """Raise a fatal error. Analog of reference ``log.error`` (log.lua:51-53)."""
    raise SimulationError(_format("[ERROR]", parts))


def warning(*parts) -> None:
    """Emit a non-fatal warning to stderr, flushed immediately.

    Analog of reference ``log.warning`` (log.lua:58-60): unbuffered stderr so
    the message is visible even if the host process dies right after.
    """
    sys.stderr.write(_format("[WARNING]", parts) + "\n")
    sys.stderr.flush()


_TYPE_MAP = {
    "number": numbers.Real,
    "table": (dict, list, tuple),
    "string": str,
    "boolean": bool,
}


def assert_types(*pairs) -> bool:
    """Assert alternating (value, expected_type) pairs; fatal on mismatch.

    Analog of reference ``log.assert`` (log.lua:65-88). ``expected_type`` may be
    a Python type/tuple of types or one of the reference's Lua type-name strings
    ("number", "table", "string", "boolean").
    """
    if len(pairs) % 2 != 0:
        error("In log.assert_types: number of arguments is not a multiple of 2")
    for i in range(0, len(pairs), 2):
        value, expected = pairs[i], pairs[i + 1]
        py_expected = _TYPE_MAP.get(expected, expected)
        # bool is a Real in Python; the reference distinguishes them.
        if isinstance(value, bool) and py_expected is numbers.Real:
            ok = False
        else:
            ok = isinstance(value, py_expected)
        if not ok:
            name = expected if isinstance(expected, str) else getattr(expected, "__name__", str(expected))
            error(
                "for argument #", i // 2 + 1,
                ": expected `", name,
                "`, got `", type(value).__name__, "`",
            )
            return False
    return True
