"""PyTorch/CUDA port of the serving stack for NVIDIA Hopper.

The package stands beside the JAX reference (``repro``) and imports
nothing of it. This slice serves dense decoders through the
continuous-batching engine on the paged KV pool; the two attention
kernels on that path are hand-written CUDA (``kernels/csrc``).
"""
