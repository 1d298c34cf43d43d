"""deepv_tpu_torch — the PyTorch/CUDA port of deepv_tpu for one NVIDIA H100.

deepv_tpu (beside this package) is the JAX/Pallas rebuild of DeepVerse, a 4D
autoregressive world model: one image plus a text or game-pad action prompt
is rolled out, chunk by chunk, into RGB video, disparity and camera raymaps
by a pyramid flow-matching MMDiT over a causal video VAE. This package runs
the same rollout in PyTorch. It imports ``torch`` and never ``jax`` or
anything of ``deepv_tpu``; the modules it needs from there are copied.

Layout mirrors deepv_tpu so each counterpart is easy to find:
  - run.py, io/      : CLI, random/numpy weights, text embeds, video export
  - pipeline.py      : chunked AR rollout, CFG, priming, history retrieval
  - models/          : MMDiT, causal video VAE, flow-match scheduler
  - ops/             : plain tensor functions; ``ops/attention.py`` wraps the
                       hand-written Hopper kernel in ``csrc/attention.cu``
  - utils/           : phase timer, kernel build helper

Entry points run on the card unless the caller passes ``device="cpu"``;
on the CPU the attention wrapper takes its plain PyTorch version.
"""

__version__ = "0.1.0"
