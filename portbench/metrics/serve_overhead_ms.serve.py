"""Mean milliseconds a served step spends outside the session's own
``InteractiveSession.step`` (timed in the server, ended by a wait for the
card): HTTP, JSON and base64 on the wire."""

from portbench.stats import mean


def read(run):
    n = min(len(run.steps), len(run.session_steps))
    if not n:
        return None
    return 1e3 * mean([c - s for c, s in zip(run.steps[:n], run.session_steps[:n])])
