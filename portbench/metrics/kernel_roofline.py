"""kernel_roofline of a cell of the kind its name ends in (``portbench/yardstick/readers.py``)."""

from portbench.yardstick.readers import kernel_roofline as read  # noqa: F401
