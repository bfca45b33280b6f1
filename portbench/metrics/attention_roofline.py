"""attention_roofline: % , the attention kernel's least time in the traced
stretch (``attention_bound_ms`` a unit, ``yardstick/gf_bounds.py``, times the
units traced) over its device time there (``kernel_s["attention"]``, the
kernel found by its own name)."""


def read(obs, kind):
    tr = obs.get("trace")
    if obs.get("kind") != kind or not tr or not tr.get("units"):
        return None
    spent = tr.get("kernel_s", {}).get("attention", 0.0)
    least = obs.get("attention_bound_ms")
    if spent <= 0 or not least:
        return None
    return 100.0 * least * 1e-3 * tr["units"] / spent
