"""Multi-card inference over torch.distributed: the mesh, the collectives,
the MMDiT's tensor-parallel split and the VAE's context parallelism."""
