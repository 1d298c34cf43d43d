"""The median of every step of the traced window, timed at the client."""

from portbench.stats import percentile


def read(run):
    return percentile(run.steps, 50)
