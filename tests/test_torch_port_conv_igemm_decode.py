"""The port's VAE decode stream with the implicit-GEMM conv (K2) against
deepv_tpu's, on the CPU: the 1-frame init and cont windows with their
caches and the chunk-boundary priming (``_dec_prime_warm``), at the
128-multiple config of tests/test_torch_port_conv_igemm.py, with its
tolerance (a multiple of deepv_tpu's own igemm-vs-XLA gap on the same
inputs). A file of its own so that the interpreted reference's compile time
falls on another worker than the encode's.
"""

import pytest
import torch

from test_torch_port_conv_igemm import check_stream_part, stream_outputs

torch.set_num_threads(1)

DECODE_PARTS = ("decode_init", "decode_cont", "prime")


@pytest.fixture(scope="module")
def decode_stream():
    return stream_outputs(DECODE_PARTS)


@pytest.mark.parametrize("part", DECODE_PARTS)
def test_vae_decode_igemm_matches_deepv_tpu(decode_stream, part):
    check_stream_part(decode_stream, part)
