"""The share of the profiled slice (units around a chunk boundary) in
which no kernel ran: 1 - union of kernel intervals / wall seconds, in %."""


def read(run):
    t = run.trace
    if not t or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
