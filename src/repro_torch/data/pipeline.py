"""Deterministic sharded batch pipeline over the compressed store, the
port of the JAX package's ``data/pipeline.py`` (host numpy, its own copy:
the port imports nothing of that package).  Batches are bit-equal to the
JAX package's for the same corpus, seed, step and shard.

Design constraints for 1000+-node fleets:

* **Stateless sampling** — the content of batch ``step`` is a pure function
  of ``(seed, step, shard)``.  Restart after a failure resumes *exactly*
  (no data-order drift), and elastic re-sharding (changing data-parallel
  degree) re-partitions the same global stream deterministically.
* **No decompression** — windows are expanded straight out of the grammar
  (``expand_range``); the raw corpus never materializes.
* **Host prefetch** — a background thread keeps ``prefetch`` batches ahead,
  overlapping grammar expansion with device compute.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np

from .store import CompressedCorpus


@dataclass(frozen=True)
class PipelineState:
    """Everything needed to resume the stream: goes into checkpoints."""
    seed: int
    step: int
    global_batch: int
    seq_len: int

    def advance(self, n: int = 1) -> "PipelineState":
        return PipelineState(self.seed, self.step + n, self.global_batch,
                             self.seq_len)


class BatchPipeline:
    """Yields (tokens, labels) int32 [local_batch, seq_len] shards.

    ``shard``/``num_shards`` split the global batch across data-parallel
    hosts; every shard draws from the same deterministic global stream.
    """

    def __init__(self, corpus: CompressedCorpus, *, global_batch: int,
                 seq_len: int, seed: int = 0, shard: int = 0,
                 num_shards: int = 1, start_step: int = 0,
                 prefetch: int = 2) -> None:
        if global_batch % num_shards:
            raise ValueError("global_batch must divide by num_shards")
        self.corpus = corpus
        self.state = PipelineState(seed, start_step, global_batch, seq_len)
        self.shard = shard
        self.num_shards = num_shards
        self.local_batch = global_batch // num_shards
        self.prefetch = prefetch
        self._q: "queue.Queue[Tuple[int, np.ndarray, np.ndarray]]" = \
            queue.Queue(maxsize=max(prefetch, 1))
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # --------------------------------------------------------- sampling --
    def _sample_batch(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        st = self.state
        rng = np.random.default_rng(
            np.random.SeedSequence([st.seed, step]))
        total = self.corpus.total_tokens
        need = st.seq_len + 1
        # global sample offsets for the WHOLE batch; take our shard's rows
        # (identical across shards -> no communication needed to agree)
        n_files = len(self.corpus.file_lens)
        probs = self.corpus.file_lens / max(total, 1)
        files = rng.choice(n_files, size=st.global_batch, p=probs)
        toks = np.zeros((st.global_batch, need), np.int64)
        for i, f in enumerate(files):
            flen = int(self.corpus.file_lens[f])
            if flen <= need:
                w = self.corpus.window(int(f), 0, flen)
                reps = int(np.ceil(need / max(len(w), 1)))
                toks[i] = np.tile(w, reps)[:need]
            else:
                off = int(rng.integers(0, flen - need))
                toks[i] = self.corpus.window(int(f), off, need)
        lo = self.shard * self.local_batch
        hi = lo + self.local_batch
        x = toks[lo:hi, :-1].astype(np.int32)
        y = toks[lo:hi, 1:].astype(np.int32)
        return x, y

    # --------------------------------------------------------- iterator --
    def _worker(self) -> None:
        step = self.state.step
        while not self._stop.is_set():
            batch = self._sample_batch(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, *batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        if self.prefetch > 0:
            self._stop.clear()
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
            try:
                while True:
                    step, x, y = self._q.get()
                    self.state = PipelineState(
                        self.state.seed, step + 1, self.state.global_batch,
                        self.state.seq_len)
                    yield x, y
            finally:
                self._stop.set()
        else:
            while True:
                x, y = self._sample_batch(self.state.step)
                self.state = self.state.advance()
                yield x, y

    def batch_at(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        """Pure access for tests / exact-resume verification."""
        return self._sample_batch(step)

    def close(self) -> None:
        self._stop.set()
