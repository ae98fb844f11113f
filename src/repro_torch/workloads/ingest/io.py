"""Shared I/O helpers for the trace parsers: compression-aware open
(``.xz``/``.gz``/plain, all stdlib) and the streaming file digest the
ingest cache keys on."""
from __future__ import annotations

import gzip
import hashlib
import io
import lzma


class TraceFormatError(ValueError):
    """A trace file that cannot be parsed: wrong/undetectable format,
    truncated binary record, malformed text line, or a stream with no
    memory accesses at all."""


def open_stream(path: str, text: bool = False):
    """Open ``path`` for reading, transparently decompressing by suffix
    (``.xz`` -> lzma, ``.gz`` -> gzip, else plain).  ``text=True`` wraps
    the byte stream for line iteration."""
    if path.endswith(".xz"):
        f = lzma.open(path, "rb")
    elif path.endswith(".gz"):
        f = gzip.open(path, "rb")
    else:
        f = open(path, "rb")
    if text:
        return io.TextIOWrapper(f, encoding="utf-8", errors="replace")
    return f


def file_sha256(path: str, block: int = 1 << 20) -> str:
    """Streaming sha256 of the file AS STORED (compressed bytes): the
    cache key must change when the file does, nothing more."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(block)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()
