"""Debug-printing mixin for metric/config objects (a copy of
``ccvm_tpu/ccvmplotlib/utils/mixins.py``).

Same behaviour as the reference's mixin
(``ccvm_simulators/ccvmplotlib/utils/mixins.py``): ``str(obj)`` shows the
public, non-callable, non-None attributes as a plain dict.
"""

from __future__ import annotations


class StrDictMixIn:
    """``__str__`` renders the instance's public data attributes."""

    def __str__(self) -> str:
        shown = {
            name: value
            for name, value in vars(self).items()
            if not name.startswith("_")
            and value is not None
            and not callable(value)
        }
        return str(shown)
