"""Host-clock stage split of one forward pass, for measurement only.

Modules on the serving path call `mark(name)` where a stage ends: the time
since the previous mark is added to `name`. Outside `recording()` a mark
does nothing but read one global. Inside it, each mark first synchronises
the card, so the split is of device work as well as of host time (and the
recorded pass is slower than an unrecorded one). A `span(name)` inside a
stage takes its own time out of that stage and adds it to `name`.
"""

from __future__ import annotations

import contextlib
import time

import torch

_times: dict[str, float] | None = None
_last = 0.0


def mark(name: str) -> None:
    global _last
    if _times is None:
        return
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    now = time.perf_counter()
    _times[name] = _times.get(name, 0.0) + 1e3 * (now - _last)
    _last = now


@contextlib.contextmanager
def recording():
    """Yields a dict that fills with {stage name: ms} in mark order."""
    global _times, _last
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    _times, _last = {}, time.perf_counter()
    try:
        yield _times
    finally:
        _times = None


@contextlib.contextmanager
def span(name: str):
    """Inside `recording()`, the block's time goes to `name` and not to
    the stage around it; outside, nothing."""
    global _last
    if _times is None:
        yield
        return
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        _times[name] = _times.get(name, 0.0) + 1e3 * dt
        _last += dt
