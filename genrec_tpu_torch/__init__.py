"""PyTorch / CUDA port of genrec-tpu for NVIDIA Hopper (H100).

The JAX package ``genrec_tpu`` stays the reference; this package is its
counterpart, module for module, under the same paths and names. It imports
``torch`` and numpy and nothing of ``jax`` or ``genrec_tpu``: what it needs
from the reference's framework-free modules is copied here.

Every Pallas kernel of the reference on a ported path is a hand-written
CUDA kernel here (``csrc/``), built with ``nvcc`` at first use into
``_build/`` and bound with ``ctypes`` (``ops/_build.py``). Each kernel has a
plain PyTorch version beside it, used only for tensors that lie on the CPU;
for a CUDA tensor the wrapper launches the kernel or raises.

Ported so far: TIGER trie-constrained serving (``serving/model_fn.py``
``tiger_model_fn``), with the fused T5 attention forward
(``ops/t5_attention.py``) as its kernel.
"""
