"""API-stability annotations.

Analog of the reference's ``common`` module, whose single component is the
``@Experimental`` Java annotation marking unstable API (reference:
common/src/main/scala/io/prediction/annotation/Experimental.java:1). In
Python the same contract is a decorator that tags the object (tooling and
docs can introspect ``__pio_experimental__``); ``deprecated`` additionally
warns once per call site, matching the reference's scattered
``@deprecated`` Scala annotations (e.g. LBatchView.scala:28).

Copied from ``predictionio_tpu/annotation.py``; the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import functools
import warnings
from typing import Any, Callable, TypeVar

T = TypeVar("T")

__all__ = ["experimental", "deprecated"]


def experimental(obj: T) -> T:
    """Mark a class/function as unstable API (may change or vanish)."""
    obj.__pio_experimental__ = True  # type: ignore[attr-defined]
    doc = getattr(obj, "__doc__", None) or ""
    try:
        obj.__doc__ = "(Experimental API)\n\n" + doc
    except AttributeError:
        pass
    return obj


def deprecated(reason: str = "") -> Callable[[T], T]:
    """Mark a class/function as deprecated; emits DeprecationWarning."""

    def wrap(obj: Any):
        obj.__pio_deprecated__ = reason or True
        if isinstance(obj, type):
            orig_init = obj.__init__

            @functools.wraps(orig_init)
            def init(self, *a, **kw):
                warnings.warn(
                    f"{obj.__name__} is deprecated" + (f": {reason}" if reason else ""),
                    DeprecationWarning, stacklevel=2,
                )
                orig_init(self, *a, **kw)

            obj.__init__ = init
            return obj

        @functools.wraps(obj)
        def fn(*a, **kw):
            warnings.warn(
                f"{obj.__name__} is deprecated" + (f": {reason}" if reason else ""),
                DeprecationWarning, stacklevel=2,
            )
            return obj(*a, **kw)

        return fn

    return wrap
