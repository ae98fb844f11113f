"""Valgrind lackey (``--trace-mem=yes``) text trace parser.

Lackey emits one line per event::

    I  04000047,3        instruction fetch (column 0!)
     L 04e2b848,8        data load
     S 04e2b850,4        data store
     M 0421dcd0,4        modify (load+store to one address)

``I`` lines count as non-memory work for the following access; ``L``,
``S`` and ``M`` each contribute one memory access at their (hex, no
``0x`` prefix) address.  Valgrind banner lines (``==pid==``) and blank
lines are skipped.  Anything else raises :class:`TraceFormatError`
with the offending line number — a corrupt or mis-identified file must
not silently parse as an empty trace.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from repro_torch.workloads.ingest.io import TraceFormatError, open_stream

Block = Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]


def parse_blocks(path: str, block_lines: int = 1 << 15) -> Iterator[Block]:
    """Yield ``(addr, work, tid)`` blocks; ``tid`` is always None
    (lackey interleaves threads into one stream)."""
    addrs, works = [], []
    work = 0
    with open_stream(path, text=True) as f:
        for lineno, line in enumerate(f, 1):
            s = line.strip()
            if not s or s.startswith("=="):
                continue
            if line.startswith("I"):           # instruction fetch
                work += 1
                continue
            kind, _, body = s.partition(" ")
            if kind not in ("L", "S", "M") or not body:
                raise TraceFormatError(
                    f"{path}:{lineno}: unrecognized lackey line "
                    f"{line.rstrip()!r}")
            token = body.strip().split(",", 1)[0]
            try:
                addr = int(token, 16)
            except ValueError:
                raise TraceFormatError(
                    f"{path}:{lineno}: bad lackey address "
                    f"{token!r}") from None
            addrs.append(addr)
            works.append(work)
            work = 0
            if len(addrs) >= block_lines:
                yield (np.asarray(addrs, np.int64),
                       np.asarray(works, np.int64), None)
                addrs, works = [], []
    if addrs:
        yield (np.asarray(addrs, np.int64),
               np.asarray(works, np.int64), None)
