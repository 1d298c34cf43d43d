"""The whole step's share of the card's bf16 peak: the model operations of
the work the traced window completed (every MMDiT forward that ran, the
attention over its allowed pairs; every VAE encode, decode window and
priming; int8 products counted as their float originals), over the
window's seconds at the peak, in %."""


def read(run):
    if not run.ops or not run.window_s:
        return None
    return 100.0 * run.ops / (run.window_s * run.peaks["bf16_flops"])
