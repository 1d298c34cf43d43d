"""Plain tensor functions: layers, resampling, RoPE, block noise, causal conv
and the packed masked attention (the only op with a hand-written kernel)."""
