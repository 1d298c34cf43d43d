"""MMDiT denoiser, causal video VAE and the flow-matching schedule."""
