"""span_ms.decoder: the median host ms of Group-Free 3D's decoder span
(``votenet.gf.decoder``) in the stretch recorded without the profiler
(``portbench/yardstick/spans.py``)."""

from portbench.yardstick.spans import span_ms


def read(obs, kind):
    return span_ms(obs, kind, "gf.decoder")
