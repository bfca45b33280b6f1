"""host_ms of a cell of the kind its name ends in (``portbench/yardstick/readers.py``)."""

from portbench.yardstick.readers import host_ms as read  # noqa: F401
