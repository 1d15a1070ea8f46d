"""printf-style helpers (reference: include/lama/print.h,
src/print.cpp:75-99). Python f-strings make these near-trivial; kept for
API parity and for the handful of callers that want printf formats."""

from __future__ import annotations

import sys


def format(fmt: str, *args) -> str:   # noqa: A001 — reference name
    """printf-style formatting to a string (print.cpp:88-99)."""
    return fmt % args if args else fmt


def print_(fmt: str, *args, file=None) -> None:
    """printf-style print (print.cpp:75-86)."""
    (file or sys.stdout).write(format(fmt, *args))
    (file or sys.stdout).flush()
