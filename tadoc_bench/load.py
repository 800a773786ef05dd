"""The one traffic generator: turns a mix file into the requests of a run.

A mix (``traffic/<name>.json``) is data only.  Its keys:

``kinds``        ``{kind: weight}``: the shares of the kinds, as whole
                 numbers;
``params``       ``{kind: {...}}``: the kind's query parameters (``l`` for
                 ``sequence_count``).

One client sends its next request when the last has returned (a closed
loop); each request asks its kind of every partition at once (one
``AnalyticsServer.run``).  Every seed gets the same amount of work: the
requests come in blocks that each hold every kind in its weight's count,
in a seeded order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

#: One query of a request: (partition index, kind, parameters).
Item = Tuple[int, str, Tuple[Tuple[str, object], ...]]


@dataclass
class Request:
    items: List[Item]
    # filled in by the harness
    start: float = float("nan")
    end: float = float("nan")
    error: Optional[str] = None
    out_bytes: int = 0
    span: object = None                  # the server's spans (traced)

    @property
    def kind(self) -> str:
        return self.items[0][1]


class Traffic:
    """The requests of one run of a mix over ``n_partitions`` partitions."""

    def __init__(self, mix: dict, n_partitions: int, seed: int):
        self.mix = mix
        self.n = n_partitions
        self.seed = seed
        self.kinds = list(mix["kinds"])
        self.weights = [int(mix["kinds"][k]) for k in self.kinds]
        #: requests a block
        self.block = sum(self.weights)

    def items(self, kind: str, partitions: Sequence[int]) -> List[Item]:
        params = tuple(sorted(
            self.mix.get("params", {}).get(kind, {}).items()))
        return [(p, kind, params) for p in partitions]

    def closed(self) -> Iterator[Request]:
        """Endless blocks; each holds every kind ``weight`` times, in a
        seeded order."""
        rng = np.random.default_rng(np.random.SeedSequence(
            [self.seed, 0x7AD0C, 2]))
        block = [k for k, w in zip(self.kinds, self.weights)
                 for _ in range(w)]
        everyone = list(range(self.n))
        while True:
            for j in rng.permutation(len(block)):
                yield Request(self.items(block[j], everyone))
