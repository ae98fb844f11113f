"""ChampSim binary trace parser.

ChampSim traces are a flat stream of fixed 64-byte records (the
``trace_instr_format_t`` of the ChampSim tracer: ip, branch flags,
2 destination + 4 source register ids, 2 destination + 4 source memory
addresses), usually xz- or gzip-compressed.  A zero memory slot means
"no access"; a record may carry up to six.

The parser is fully vectorized: records are ``np.frombuffer``-viewed
through a structured dtype block by block, memory slots are extracted
in record order (sources before destinations, matching the tracer's
operand order), and the ``work`` of each access — the number of
non-memory instructions retired since the previous memory access — is
derived from the gaps between memory-carrying records.  Only the first
access of a record carries its gap; same-record accesses are
back-to-back (work 0).

A trailing partial record raises :class:`TraceFormatError` — a
truncated download must fail loudly, not silently shorten the trace.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from repro_torch.workloads.ingest.io import TraceFormatError, open_stream

NUM_INSTR_DESTINATIONS = 2
NUM_INSTR_SOURCES = 4

RECORD_DTYPE = np.dtype([
    ("ip", "<u8"),
    ("is_branch", "u1"),
    ("branch_taken", "u1"),
    ("dst_reg", "u1", (NUM_INSTR_DESTINATIONS,)),
    ("src_reg", "u1", (NUM_INSTR_SOURCES,)),
    ("dst_mem", "<u8", (NUM_INSTR_DESTINATIONS,)),
    ("src_mem", "<u8", (NUM_INSTR_SOURCES,)),
])
RECORD_BYTES = RECORD_DTYPE.itemsize
assert RECORD_BYTES == 64

#: user-space mask: kernel/sign-extended addresses are folded positive
#: so the int64 view downstream never sees a negative address
_ADDR_MASK = np.uint64((1 << 63) - 1)

Block = Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]


def parse_blocks(path: str, block_records: int = 1 << 16
                 ) -> Iterator[Block]:
    """Yield ``(addr, work, tid)`` blocks; ``tid`` is always None
    (ChampSim traces are single-threaded — interleaving happens in the
    ingest pipeline)."""
    pending_work = 0
    offset = 0
    with open_stream(path) as f:
        while True:
            raw = f.read(RECORD_BYTES * block_records)
            if not raw:
                break
            # decompressors may return short reads mid-stream: top up to
            # a whole number of records before viewing
            need = (-len(raw)) % RECORD_BYTES
            while need:
                more = f.read(need)
                if not more:
                    raise TraceFormatError(
                        f"{path}: truncated ChampSim record at byte "
                        f"{offset + len(raw)} (stream is not a multiple "
                        f"of {RECORD_BYTES} bytes)")
                raw += more
                need = (-len(raw)) % RECORD_BYTES
            offset += len(raw)
            rec = np.frombuffer(raw, RECORD_DTYPE)

            mem = np.concatenate([rec["src_mem"], rec["dst_mem"]], axis=1)
            mask = mem != 0
            has_mem = mask.any(axis=1)
            pos = np.flatnonzero(has_mem)
            if pos.size == 0:
                pending_work += len(rec)
                continue
            # gap of silent (no-memory) records before each memory record
            prev = np.concatenate([[-1], pos[:-1]])
            gap = pos - prev - 1
            gap[0] += pending_work
            pending_work = int(len(rec) - 1 - pos[-1])

            rows, cols = np.nonzero(mask)      # row-major: record order
            addr = (mem[rows, cols] & _ADDR_MASK).astype(np.int64)
            work = np.zeros(rows.size, np.int64)
            work[np.searchsorted(rows, pos)] = gap
            yield addr, work, None
