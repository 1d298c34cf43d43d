"""K1's share of its roofline in the profiled slice: the least time of
the marked attention calls (each call's operations over its allowed pairs
at the bf16 peak, or its bytes at the memory bandwidth, whichever is
larger) over the device time of the kernels they launched, in %."""


def read(run):
    t = run.trace
    if not t or not t.get("attention_device_s") or not run.attention_bound_s:
        return None
    return 100.0 * run.attention_bound_s / t["attention_device_s"]
