"""peak_gib of a cell of the kind its name ends in (``portbench/yardstick/readers.py``)."""

from portbench.yardstick.readers import peak_gib as read  # noqa: F401
