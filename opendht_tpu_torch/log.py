"""Logging subsystem (↔ reference include/opendht/log_enable.h:35-190,
include/opendht/log.h:20-82, src/log.cpp).

The reference's ``Logger`` carries three printf-style streams
(ERR/WARN/DEBUG), an optional per-InfoHash filter that silences
everything not about one key, and pluggable sinks (colored console,
file, syslog).  This module provides the same surface on top of the
stdlib ``logging`` machinery the rest of the package already uses:

- :class:`DhtLogger` — e/w/d streams, per-hash filtering
  (``set_filter``), and sink management (``set_sink_console`` /
  ``set_sink_file`` / ``set_sink_syslog``).
- The filter is a ``logging.Filter`` on the sink handler keyed on the
  ``dht_hash`` record attribute, so it applies to *every* record that
  reaches the sink — core runtime logs included, as long as they tag
  records via ``extra={"dht_hash": ...}`` (the e/w/d streams do this
  with their ``h=`` argument).  When a filter is set, untagged records
  are suppressed, matching the reference's "show only this hash" mode.
- Enabling a sink captures the target logger's level/propagate state
  and ``disable()`` restores it, so an embedding application's own
  logging configuration survives.

A copy of the JAX package's ``log.py`` with its behaviour unchanged; the
default logger is the port's, ``opendht_tpu_torch``.
"""

from __future__ import annotations

import logging
import sys
import time
from typing import Optional

from .infohash import InfoHash

_COLORS = {"ERR": "\x1b[31m", "WARN": "\x1b[33m", "DEBUG": "\x1b[90m"}
_RESET = "\x1b[0m"


class _ColorFormatter(logging.Formatter):
    """Colored console lines (↔ the reference's enableLogging console
    sink with per-level colors, src/log.cpp)."""

    def __init__(self, color: bool):
        super().__init__()
        self.color = color

    def format(self, record: logging.LogRecord) -> str:
        level = {"ERROR": "ERR", "WARNING": "WARN"}.get(
            record.levelname, "DEBUG")
        ts = time.strftime("%H:%M:%S", time.localtime(record.created))
        line = "[%s] %s: %s" % (ts, level, record.getMessage())
        if self.color:
            return _COLORS.get(level, "") + line + _RESET
        return line


class _HashFilter(logging.Filter):
    """Pass everything when unset; with a hash set, pass only records
    tagged with it (↔ Logger::setFilter, log_enable.h:77-90)."""

    def __init__(self):
        super().__init__()
        self.hash: Optional[InfoHash] = None

    def filter(self, record: logging.LogRecord) -> bool:
        if self.hash is None:
            return True
        tag = getattr(record, "dht_hash", None)
        if tag is None:
            return False
        try:
            return InfoHash(tag) == self.hash
        except Exception:
            return False


class DhtLogger:
    """ERR/WARN/DEBUG streams with per-InfoHash filtering
    (log_enable.h:35-190)."""

    def __init__(self, name: str = "opendht_tpu_torch"):
        self._logger = logging.getLogger(name)
        self._filter = _HashFilter()
        self._handler: Optional[logging.Handler] = None
        self._saved_state: "tuple | None" = None

    # ------------------------------------------------------------- streams
    def _emit(self, level: int, fmt: str, args: tuple, h) -> None:
        extra = {"dht_hash": bytes(InfoHash(h))} if h is not None else None
        self._logger.log(level, fmt, *args, extra=extra)

    def e(self, fmt: str, *args, h=None) -> None:
        self._emit(logging.ERROR, fmt, args, h)

    def w(self, fmt: str, *args, h=None) -> None:
        self._emit(logging.WARNING, fmt, args, h)

    def d(self, fmt: str, *args, h=None) -> None:
        self._emit(logging.DEBUG, fmt, args, h)

    # ------------------------------------------------------------ filtering
    def set_filter(self, h: "InfoHash | None") -> None:
        """Only emit messages tagged with this hash; None clears."""
        self._filter.hash = InfoHash(h) if h else None

    # --------------------------------------------------------------- sinks
    def _swap_handler(self, handler: logging.Handler) -> None:
        if self._saved_state is None:
            # first sink: capture the embedding app's configuration
            self._saved_state = (self._logger.level, self._logger.propagate)
            self._logger.setLevel(logging.DEBUG)
            self._logger.propagate = False
        if self._handler is not None:
            self._logger.removeHandler(self._handler)
            self._handler.close()
        handler.addFilter(self._filter)
        self._handler = handler
        self._logger.addHandler(handler)

    def set_sink_console(self, color: Optional[bool] = None) -> None:
        """(↔ log::enableLogging, log.h:20-40)"""
        if color is None:
            color = sys.stderr.isatty()
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(_ColorFormatter(color))
        self._swap_handler(h)

    def set_sink_file(self, path: str) -> None:
        """(↔ log::enableFileLogging, log.h:42-60)"""
        h = logging.FileHandler(path)
        h.setFormatter(_ColorFormatter(False))
        self._swap_handler(h)

    def set_sink_syslog(self, ident: str = "dhtnode") -> None:
        """(↔ OPENDHT_SYSLOG enableSyslog, log.h:62-82)"""
        from logging.handlers import SysLogHandler
        h = SysLogHandler(address="/dev/log")
        h.setFormatter(logging.Formatter(ident + ": %(message)s"))
        self._swap_handler(h)

    def disable(self) -> None:
        """Detach the sink and restore the logger's prior configuration
        (↔ log::disableLogging)."""
        if self._handler is not None:
            self._logger.removeHandler(self._handler)
            self._handler.close()
            self._handler = None
        if self._saved_state is not None:
            level, propagate = self._saved_state
            self._logger.setLevel(level)
            self._logger.propagate = propagate
            self._saved_state = None
