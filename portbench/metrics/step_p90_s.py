"""The 90th percentile of every step of the window, each timed at the
client from its ``POST /step`` to its reply."""

from portbench.stats import percentile


def read(run):
    return percentile(run.steps, 90)
