"""Milliseconds of the VAE's decode a delivered frame: the pipeline's
``stream_decode``, ``prime`` and ``vae_decode`` phases (each ended by a
wait for the card) over the traced window's frames."""


def read(run):
    phases = run.phases or {}
    total = sum(phases.get(k, {}).get("total_s", 0.0)
                for k in ("stream_decode", "prime", "vae_decode"))
    if not total or not run.frames:
        return None
    return 1e3 * total / run.frames
