"""Shared host-side primitives: time, msgpack helpers, exceptions, flags.

A copy of the JAX package's ``utils.py`` with its behaviour unchanged,
except that the msgpack helpers go through the port's own pure-Python
codec (:mod:`opendht_tpu_torch._msgpack`, byte-identical to
``msgpack.packb(use_bin_type=True)``) instead of the ``msgpack`` wheel,
and ``lazy_module`` (used only by the crypto layer, not ported yet) is
left out.

Counterpart of the reference's ``include/opendht/utils.h`` (steady
clock/time_point/duration utils.h:77-114, packMsg/unpackMsg :121-137,
DhtException/SocketException :63-73, WANT4/WANT6 :32-33).  Times here are
plain floats on the monotonic clock — the Python-idiomatic equivalent of
``std::chrono::steady_clock::time_point``.
"""

from __future__ import annotations

import random
import time as _time
from typing import Any

from . import _msgpack

# A time_point far enough in the future to mean "never" (the reference
# uses time_point::max(); a finite sentinel keeps float math safe).
TIME_MAX = float("inf")

#: want flags for dual-stack requests (utils.h:32-33)
WANT4 = 1
WANT6 = 2


def now() -> float:
    """Monotonic 'steady clock' timestamp in seconds."""
    return _time.monotonic()


def wall_now() -> float:
    """Wall-clock timestamp (seconds since epoch) for value `created`
    dates, which cross the network (reference uses system_clock there)."""
    return _time.time()


def uniform_duration(low: float, high: float, rng: random.Random | None = None) -> float:
    """Random duration in [low, high] — jitter for maintenance schedules
    (utils.h:93-107 uniform_duration_distribution)."""
    r = rng.uniform(low, high) if rng is not None else random.uniform(low, high)
    return r


class DhtException(Exception):
    """Base error for DHT operations (utils.h:63-67)."""


class SocketException(DhtException):
    """Network-level failure (utils.h:69-73)."""


def pack_msg(obj: Any) -> bytes:
    """msgpack-encode (packMsg, utils.h:121-126): bytes→bin and str→str,
    matching msgpack-c's defaults."""
    return _msgpack.packb(obj)


def unpack_msg(data: bytes) -> Any:
    """msgpack-decode (unpackMsg, utils.h:128-133): the str family
    decodes to Python str; bin stays bytes."""
    return _msgpack.unpackb(data)


def unpack_stream(data: bytes):
    """Iterate over concatenated msgpack objects."""
    return _msgpack.unpack_stream(data)
