"""device_ms.decoder: the device ms launched inside Group-Free 3D's decoder
span (``votenet.gf.decoder``) a forward, in the profiled stretch
(``portbench/yardstick/spans.py``)."""

from portbench.yardstick.spans import device_ms


def read(obs, kind):
    return device_ms(obs, kind, "gf.decoder")
