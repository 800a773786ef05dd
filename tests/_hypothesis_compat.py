"""Optional-``hypothesis`` shim for the property-based test modules.

``hypothesis`` is a dev-only dependency; the tier-1 suite must collect and
pass without it.  When it is installed we re-export the real ``given`` /
``example`` / ``settings`` / ``strategies``.  When it is absent we fall back
to a small, deterministic fixed-example harness: each ``@given(...)`` test
becomes a ``pytest.mark.parametrize`` over ``FALLBACK_EXAMPLES`` samples
drawn from a seeded generator (first sample is the boundary/minimal draw of
every strategy, the rest are random), after the examples pinned with
``@example(...)`` (written below ``@given``), so a pinned failure shows there
too.  Coverage is weaker than real hypothesis but the tests still execute
the exact same assertions.

Only the strategy surface the test suite uses is implemented:
``st.integers(lo, hi)`` and ``st.lists(elem, min_size=, max_size=)``.
"""

from __future__ import annotations

try:  # pragma: no cover - exercised implicitly by which branch imports
    from hypothesis import (example, given, settings,  # noqa: F401
                            strategies as st)

    HAVE_HYPOTHESIS = True
except ImportError:
    import inspect

    import numpy as np
    import pytest

    HAVE_HYPOTHESIS = False
    FALLBACK_EXAMPLES = 5
    _SEED = 20260801

    class _IntStrategy:
        def __init__(self, lo, hi):
            self.lo, self.hi = int(lo), int(hi)

        def example(self, rng, boundary=False):
            if boundary:
                return self.lo
            return int(rng.integers(self.lo, self.hi + 1))

    class _ListStrategy:
        def __init__(self, elem, min_size=0, max_size=10):
            self.elem = elem
            self.min_size, self.max_size = int(min_size), int(max_size)

        def example(self, rng, boundary=False):
            if boundary:
                return [self.elem.example(rng, boundary=True)
                        for _ in range(self.min_size)]
            n = int(rng.integers(self.min_size, self.max_size + 1))
            return [self.elem.example(rng) for _ in range(n)]

    class _Strategies:
        @staticmethod
        def integers(min_value, max_value):
            return _IntStrategy(min_value, max_value)

        @staticmethod
        def lists(elem, min_size=0, max_size=10):
            return _ListStrategy(elem, min_size=min_size, max_size=max_size)

    st = _Strategies()

    def settings(*_args, **_kwargs):
        def deco(fn):
            return fn
        return deco

    def example(*args, **kwargs):
        def deco(fn):
            pinned = inspect.signature(fn).bind(*args, **kwargs).args
            fn._hc_pinned = [pinned] + getattr(fn, "_hc_pinned", [])
            return fn
        return deco

    def given(*strategies):
        def deco(fn):
            rng = np.random.default_rng(_SEED)
            pinned = getattr(fn, "_hc_pinned", [])
            examples = pinned + [
                tuple(s.example(rng, boundary=(i == 0)) for s in strategies)
                for i in range(FALLBACK_EXAMPLES)
            ]
            ids = ([f"pinned{i}" for i in range(len(pinned))]
                   + [f"ex{i}" for i in range(FALLBACK_EXAMPLES)])

            @pytest.mark.parametrize("_hc_example", examples, ids=ids)
            def wrapper(_hc_example):
                return fn(*_hc_example)

            wrapper.__name__ = fn.__name__
            wrapper.__doc__ = fn.__doc__
            return wrapper
        return deco
