"""The frame's default step: the span that every named step of the port's
frame enters when the caller passes no step hook.

While the torch profiler is off it is one shared null context, so an
untimed frame pays a flag test per span. While ``torch.profiler.profile``
(or ``torch.autograd.profiler.profile``) records, it is a
``record_function`` range of the span's name: the profiled frame's host
timeline carries the program's spans as user annotations, on the clock of
the device's kernel records.
"""
from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()


def no_step(name: str):
    """The default step wrapper: a ``record_function(name)`` range while
    the torch profiler records, else the shared null context."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN
