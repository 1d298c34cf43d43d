"""Plain PyTorch reference of DeepVerse's rollout pieces.

The benchmark's yardstick for ``correct``: the MMDiT forward, the pyramid
flow-matching unit, the causal VAE's streamed and primed decode and its
encode, written from the published architecture with ``torch`` and
``numpy`` alone. Nothing here imports the measured program or the JAX
package; every weight is drawn again from the run's seed
(``params.make_params``).
"""
