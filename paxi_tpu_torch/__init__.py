"""paxi_tpu_torch: the lock-step Multi-Paxos simulation on PyTorch and CUDA.

A port of the JAX package ``paxi_tpu`` for an NVIDIA H100, held bit for bit
against it on the same seed.  Entry points (``sim.make_run``,
``sim.simulate``, and ``python -m paxi_tpu_torch``'s subcommands) run on
the card unless the caller passes ``device="cpu"`` (``-device cpu``).  The
package imports neither ``jax`` nor ``paxi_tpu``.
"""
