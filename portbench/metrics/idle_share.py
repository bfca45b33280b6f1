"""idle_share of a cell of the kind its name ends in (``portbench/yardstick/readers.py``)."""

from portbench.yardstick.readers import idle_share as read  # noqa: F401
