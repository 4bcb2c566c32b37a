"""No-recompilation guard -- the analog of the reference's allocation
sanitizer.

The reference proves solve() is malloc-free by failing on any Eigen heap
allocation inside a guarded region (ref: src/internal/memoryChecks.cpp:5-24,
used at tests/GoldfarbIdnaniSolverTest.cpp:114-116). Under XLA the equivalent
performance contract is *no retracing / no recompilation*: once a padded
shape is compiled, solving any number of problems of that shape must reuse
the executable. This guard asserts exactly that.
"""
from __future__ import annotations

import contextlib

__all__ = ["no_retrace"]


@contextlib.contextmanager
def no_retrace(*jitted_fns):
    """Context manager asserting the given jitted functions are not traced
    again inside the block::

        f = jax.jit(solve, static_argnames=("opt",))
        f(pb0, opt)                   # warm up
        with no_retrace(f):
            for pb in batch:          # same padded shape
                f(pb, opt)            # must hit the cache

    Raises AssertionError if any function's compilation-cache size grew.
    """
    before = [fn._cache_size() for fn in jitted_fns]
    yield
    after = [fn._cache_size() for fn in jitted_fns]
    for fn, b, a in zip(jitted_fns, before, after):
        if a != b:
            raise AssertionError(
                f"{getattr(fn, '__name__', fn)!r} retraced inside a "
                f"no_retrace block: cache grew {b} -> {a} (shape or static "
                f"argument changed)"
            )
