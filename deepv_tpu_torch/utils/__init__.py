"""Phase timing and the CUDA kernel build helper."""
