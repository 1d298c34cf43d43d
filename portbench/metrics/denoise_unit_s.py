"""Mean seconds of a unit's denoise (the pipeline's ``denoise_unit``
phase, each ended by a wait for the card) over the traced window."""


def read(run):
    ph = (run.phases or {}).get("denoise_unit")
    if not ph or not ph["count"]:
        return None
    return ph["total_s"] / ph["count"]
