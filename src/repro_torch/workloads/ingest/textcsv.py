"""Simple CSV / DynamoRIO-style text trace parser.

One memory access per line, comma- or whitespace-separated.  Two
layouts:

* **Headered** — the first non-comment line names the columns; known
  names (case-insensitive): ``addr``/``address``/``vaddr``,
  ``tid``/``thread``/``thread_id``, ``work``/``instrs``, and ``size``/
  ``op``/``type``/``pc`` (accepted but ignored).  ``addr`` is required.
* **Positional** — no header; columns are ``addr[,tid[,work]]``.

Addresses and integers parse as decimal, or hex with a ``0x`` prefix.
Lines starting with ``#`` and blank lines are skipped.  A row with the
wrong column count or an unparsable field raises
:class:`TraceFormatError` with its line number.

The ``tid`` column is what the ingest pipeline's ``interleave="thread"``
mode consumes — this is the one format that can carry real per-thread
streams (e.g. a DynamoRIO ``memtrace`` post-processed to csv).
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.workloads.ingest.io import TraceFormatError, open_stream

#: header-name -> canonical column (None: accepted, ignored)
_NAMES = {
    "addr": "addr", "address": "addr", "vaddr": "addr",
    "tid": "tid", "thread": "tid", "thread_id": "tid",
    "work": "work", "instrs": "work",
    "size": None, "op": None, "type": None, "pc": None,
}
_POSITIONAL = ("addr", "tid", "work")

Block = Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]


def _split(line: str) -> List[str]:
    if "," in line:
        return [t.strip() for t in line.split(",")]
    return line.split()


def _to_int(token: str, path: str, lineno: int) -> int:
    try:
        if token.lower().startswith("0x"):
            return int(token, 16)
        return int(token, 10)
    except ValueError:
        raise TraceFormatError(
            f"{path}:{lineno}: bad integer field {token!r}") from None


def parse_blocks(path: str, block_lines: int = 1 << 15) -> Iterator[Block]:
    """Yield ``(addr, work, tid)`` blocks; ``tid`` is None when the
    file has no thread column."""
    cols: Optional[List[str]] = None
    addrs: List[int] = []
    works: List[int] = []
    tids: List[int] = []
    have_tid = False

    def flush() -> Block:
        block = (np.asarray(addrs, np.int64),
                 np.asarray(works, np.int64),
                 np.asarray(tids, np.int64) if have_tid else None)
        addrs.clear(), works.clear(), tids.clear()
        return block

    with open_stream(path, text=True) as f:
        for lineno, line in enumerate(f, 1):
            s = line.strip()
            if not s or s.startswith("#"):
                continue
            tokens = _split(s)
            if cols is None:                    # first data line: sniff
                lowered = [t.lower() for t in tokens]
                if any(t in _NAMES for t in lowered):
                    cols = []
                    for t in lowered:
                        if t not in _NAMES:
                            raise TraceFormatError(
                                f"{path}:{lineno}: unknown column "
                                f"{t!r} (known: {sorted(_NAMES)})")
                        cols.append(_NAMES[t] or "_")
                    if "addr" not in cols:
                        raise TraceFormatError(
                            f"{path}:{lineno}: header has no addr column")
                    have_tid = "tid" in cols
                    continue                    # header consumed
                cols = list(_POSITIONAL[:len(tokens)])
                if not cols or len(tokens) > len(_POSITIONAL):
                    raise TraceFormatError(
                        f"{path}:{lineno}: expected 1-3 positional "
                        f"columns (addr[,tid[,work]]), got {len(tokens)}")
                have_tid = "tid" in cols
                # fall through: this line is data
            if len(tokens) != len(cols):
                raise TraceFormatError(
                    f"{path}:{lineno}: expected {len(cols)} fields, "
                    f"got {len(tokens)}")
            row = {c: _to_int(t, path, lineno)
                   for c, t in zip(cols, tokens) if c != "_"}
            addrs.append(row["addr"])
            works.append(row.get("work", 0))
            if have_tid:
                tids.append(row["tid"])
            if len(addrs) >= block_lines:
                yield flush()
    if addrs:
        yield flush()
