"""On-disk compressed corpus: grammar arrays + metadata, single .npz.

The port of the JAX package's ``data/store.py`` (the same file format: a
corpus saved by one package loads in the other).  The corpus is stored
*compressed* (the grammar), never as raw tokens; analytics never
decompress, and reads are window expansions (``grammar.expand_range``).

Ingestion: a corpus is mutable through :meth:`CompressedCorpus.
append_files` — Sequitur is online, so appended files extend the live
grammar without recompressing what is already stored, and the result is
bit-identical to a from-scratch build of the concatenated file list.
Every mutation bumps the monotonically increasing ``epoch``; every derived
memo on the store (traversal weights) is stamped with the epoch it was
computed at and is recomputed on mismatch, so a stale grammar can never be
served.  Memo keys carry the device, so a CPU result never serves a CUDA
call.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import GrammarArrays, IncrementalSequitur, flatten
from repro_torch.core.grammar import StaleGrammarError, expand_range
from repro_torch.core.traversal import per_file_weights as _per_file_weights
from repro_torch.core.traversal import top_down_weights as _top_down_weights
from repro_torch.kernels._common import resolve_device
from repro_torch.obs import global_registry

__all__ = ["CompressedCorpus", "StaleGrammarError"]


def _count_memo(result: str) -> None:
    """Memo traffic on the epoch-stamped derived-artifact cache: ``hit``
    (stamp current), ``stale`` (entry predates an append — recomputed),
    ``miss`` (first build)."""
    global_registry().counter(
        "repro_store_memo_lookups_total",
        "epoch-stamped memo lookups on CompressedCorpus (weights) by "
        "result", ("result",)).labels(result).inc()


_META_FIELDS = ("vocab_size", "num_files", "num_rules", "num_levels")
# Every GrammarArrays field that is not scalar metadata is a numpy array.
_ARRAY_FIELDS = tuple(f.name for f in dataclasses.fields(GrammarArrays)
                      if f.name not in _META_FIELDS)


@dataclass
class CompressedCorpus:
    ga: GrammarArrays
    file_starts: np.ndarray     # [F] global terminal offset of each file
    file_lens: np.ndarray       # [F]
    # mutation counter: bumped by every append_files.  Derived memos carry
    # the epoch they were computed at; a mismatch means the grammar changed
    # underneath them.
    epoch: int = 0
    # memoized traversal weights, entries stored as (epoch, value) and
    # checked on every read, so a post-append stale hit is impossible
    _weights_cache: Dict = field(default_factory=dict, repr=False,
                                 compare=False)
    # live Sequitur state backing append_files.  build() keeps it; a
    # corpus loaded from disk rebuilds it on first append by replaying the
    # stored stream (Sequitur is online, so the replayed state is
    # bit-identical to the one the original build held).
    _sq: Optional[IncrementalSequitur] = field(default=None, repr=False,
                                               compare=False)

    # ------------------------------------------------------------ build --
    @classmethod
    def build(cls, files: List[np.ndarray], vocab_size: int
              ) -> "CompressedCorpus":
        inc = IncrementalSequitur(vocab_size)
        inc.append_files(files)
        ga = flatten(inc.export(), vocab_size, inc.n_files)
        lens = np.array([len(f) for f in files], np.int64)
        # +1 per preceding splitter
        starts = np.zeros(inc.n_files, np.int64)
        np.cumsum(lens[:-1] + 1, out=starts[1:])
        return cls(ga=ga, file_starts=starts, file_lens=lens, _sq=inc)

    # ----------------------------------------------------------- ingest --
    def _live_sequitur(self) -> IncrementalSequitur:
        """The live compressor state.  After :meth:`load` (no state on
        disk) it is rebuilt by replaying every stored file through a fresh
        :class:`IncrementalSequitur` — the operation sequence the original
        build ran, so any grammar appended onto it stays bit-identical to
        never having snapshotted.  Paid once, only by stores that resume
        ingesting after a load."""
        if self._sq is None:
            inc = IncrementalSequitur(int(self.ga.vocab_size))
            for fid in range(len(self.file_lens)):
                inc.append_file(self.window(fid, 0,
                                            int(self.file_lens[fid])))
            self._sq = inc
        return self._sq

    def append_files(self, files: Sequence[np.ndarray]
                     ) -> "CompressedCorpus":
        """Absorb ``files`` into the live grammar (incremental Sequitur).

        The re-exported arrays are bit-identical to
        ``CompressedCorpus.build(old_files + files)``.  Bumps ``epoch``
        (invalidating every derived memo) and returns ``self``.  An empty
        ``files`` list is a no-op and does NOT bump the epoch.
        """
        files = [np.asarray(f, np.int64) for f in files]
        if not files:
            return self
        inc = self._live_sequitur()
        inc.append_files(files)
        self.ga = flatten(inc.export(), inc.vocab_size, inc.n_files)
        lens = np.array([len(f) for f in files], np.int64)
        prev_end = (int(self.file_starts[-1]) + int(self.file_lens[-1]) + 1
                    if len(self.file_lens) else 0)
        starts = prev_end + np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(lens[:-1] + 1)])
        self.file_starts = np.concatenate(
            [self.file_starts.astype(np.int64), starts])
        self.file_lens = np.concatenate(
            [self.file_lens.astype(np.int64), lens])
        self.epoch += 1
        self._weights_cache.clear()
        reg = global_registry()
        reg.counter("repro_store_appends_total",
                    "append_files epoch bumps").inc()
        reg.counter("repro_store_append_files_total",
                    "files absorbed by append_files").inc(len(files))
        return self

    def check_epoch(self, epoch: int) -> None:
        """Raise :class:`StaleGrammarError` unless ``epoch`` is current —
        the guard derived artifacts (packs, plans, external indexes) call
        before serving on behalf of this corpus."""
        if int(epoch) != self.epoch:
            raise StaleGrammarError(
                f"corpus is at epoch {self.epoch} but the derived artifact "
                f"was built at epoch {int(epoch)} — rebuild it "
                f"(append_files mutated the grammar)")

    # --------------------------------------------------------------- io --
    def save(self, path: str) -> None:
        arrays = {name: getattr(self.ga, name) for name in _ARRAY_FIELDS}
        arrays["file_starts"] = self.file_starts
        arrays["file_lens"] = self.file_lens
        meta = {name: int(getattr(self.ga, name)) for name in _META_FIELDS}
        # corpus-level metadata rides the same JSON blob under a reserved
        # key: a snapshot taken mid-ingest restores at the same epoch
        meta["_corpus_epoch"] = int(self.epoch)
        tmp = path + ".tmp.npz"
        np.savez_compressed(tmp, _meta=json.dumps(meta), **arrays)
        os.replace(tmp, path)  # atomic publish

    @classmethod
    def load(cls, path: str) -> "CompressedCorpus":
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["_meta"]))
            epoch = int(meta.pop("_corpus_epoch", 0))
            kw = {name: z[name] for name in _ARRAY_FIELDS}
            kw.update(meta)
            ga = GrammarArrays(**kw)
            return cls(ga=ga, file_starts=z["file_starts"],
                       file_lens=z["file_lens"], epoch=epoch)

    # ------------------------------------------------------------ reads --
    @property
    def total_tokens(self) -> int:
        return int(self.file_lens.sum())

    def window(self, file_id: int, offset: int, length: int) -> np.ndarray:
        """Expand `length` word tokens of file `file_id` from `offset`,
        clamped to the file end (no decompression outside the window).

        ``offset`` must lie inside the file (``0 <= offset <= file_len``;
        the == edge yields an empty window); anything else raises.
        """
        if not 0 <= int(file_id) < len(self.file_lens):
            raise IndexError(f"file_id {file_id} out of range "
                             f"[0, {len(self.file_lens)})")
        offset, length = int(offset), int(length)
        if length < 0:
            raise ValueError(f"window length must be >= 0, got {length}")
        flen = int(self.file_lens[file_id])
        if not 0 <= offset <= flen:
            raise ValueError(f"offset {offset} outside file {file_id} "
                             f"(length {flen})")
        start = int(self.file_starts[file_id]) + offset
        return expand_range(self.ga, start, min(length, flen - offset))

    def global_window(self, offset: int, length: int) -> np.ndarray:
        """Expand from the concatenated corpus stream (splitters included —
        callers use them as document separators).  ``offset`` must lie
        inside the stream; ``length`` is clamped to the stream end."""
        offset, length = int(offset), int(length)
        if length < 0:
            raise ValueError(f"window length must be >= 0, got {length}")
        total = int(self.ga.exp_len[0])     # root expansion: whole stream
        if not 0 <= offset <= total:
            raise ValueError(f"offset {offset} outside the corpus stream "
                             f"(length {total})")
        return expand_range(self.ga, offset, min(length, total - offset))

    # ------------------------------------------------- memoized traversal --
    def _memo(self, key, build: Callable[[], object]):
        """Epoch-stamped memo: entries are ``(epoch, value)`` and a hit
        only counts when its stamp matches the current epoch.  A stale
        entry is recomputed in place — it can never be returned, even if
        the cache was not cleared on append."""
        hit = self._weights_cache.get(key)
        if hit is not None and hit[0] == self.epoch:
            _count_memo("hit")
            return hit[1]
        _count_memo("stale" if hit is not None else "miss")
        value = build()
        self._weights_cache[key] = (self.epoch, value)
        return value

    def top_down_weights(self, method: str = "frontier", device=None):
        """Per-rule occurrence weights on ``device`` (the card unless
        ``"cpu"``), memoized per (method, device)."""
        dev = resolve_device(device)
        return self._memo(("top_down", method, str(dev)),
                          lambda: _top_down_weights(self.ga, method=method,
                                                    device=dev))

    def per_file_weights(self, method: str = "frontier", device=None):
        """Per-(rule, file) occurrence weights, memoized per (method,
        device)."""
        dev = resolve_device(device)
        return self._memo(("per_file", method, str(dev)),
                          lambda: _per_file_weights(self.ga, method=method,
                                                    device=dev))

    def cached_weight_keys(self):
        return tuple(sorted(self._weights_cache))

    def clear_weight_cache(self) -> None:
        self._weights_cache.clear()

    def stats(self) -> dict:
        return {
            "epoch": int(self.epoch),
            "files": int(self.ga.num_files),
            "rules": int(self.ga.num_rules),
            "vocab": int(self.ga.vocab_size),
            "tokens": self.total_tokens,
            "grammar_symbols": int(self.ga.body.shape[0]),
            "compression_ratio": float(self.ga.compression_ratio()),
            "dag_depth": int(self.ga.num_levels),
        }
