"""The least device time the served analytics need, and the chip's peaks.

A request's least time is the bytes its analytics must move through device
memory over the card's memory bandwidth: every rule edge, word-table
entry and (for per-file kinds) per-file root entry read once, as an
int32 child and an int32 count, and every answer written once.  The
sizes are the grammar's own, never a kernel's launch shape, so a later
change that replaces or removes a kernel leaves the count as it is.  The
analytics do no arithmetic worth a compute bound (integer-valued float
adds), so the bytes bound them.

Each kind's module in ``kinds/`` says which of these its traversal reads.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks(device_name: str) -> Optional[dict]:
    """The published peaks of a card by its ``torch.cuda`` name; None for
    a card the table does not hold (the roofline reader then reads
    nothing)."""
    return json.loads(PEAKS.read_text()).get(device_name)


def grammar_sizes(ga) -> dict:
    """The sizes of a compressed partition that the byte counts use."""
    return {"rules": int(ga.num_rules), "edges": int(len(ga.edge_child)),
            "word_table": int(len(ga.tw_word)),
            "file_edges": int(len(ga.fedge_child)),
            "file_words": int(len(ga.fword_word)),
            "body": int(len(ga.body)), "files": int(ga.num_files),
            "vocab": int(ga.vocab_size)}


def top_down_bytes(s: dict) -> int:
    """One top-down traversal and the word tables it scatters."""
    return 8 * (s["edges"] + s["word_table"])


def per_file_bytes(s: dict) -> int:
    """A per-file traversal: the top-down reads plus each file's root
    edges and words."""
    return top_down_bytes(s) + 8 * (s["file_edges"] + s["file_words"])


def sequence_bytes(s: dict) -> int:
    """The rule weights' traversal and every symbol of the rule bodies,
    which the windows across rule boundaries are read from."""
    return 8 * s["edges"] + 4 * s["body"]
