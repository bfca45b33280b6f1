"""mfu of a cell of the kind its name ends in (``portbench/yardstick/readers.py``)."""

from portbench.yardstick.readers import mfu as read  # noqa: F401
