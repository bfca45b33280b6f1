"""The end-to-end statistic: a rate over all the work and all the seconds
of the window."""


def rate(work: float, seconds: float) -> float:
    """Work done in the window over the window's seconds."""
    return work / seconds
