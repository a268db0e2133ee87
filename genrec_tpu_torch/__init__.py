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

Ported so far: TIGER serving and training (``serving/model_fn.py``
``tiger_model_fn``, ``pipelines/tiger_pipeline.py``) with the fused T5
attention forward and backward (``ops/t5_attention.py``), and the SASRec
family on one device (``pipelines/sasrec_pipeline.py``, ``sasrec_model_fn``,
the long-context ``models/sasrec_large.py``) with the flash attention forward
and backward (``ops/attention.py``) as its kernels; RQ-VAE, TIGER-prefix and
DenseT5; the app that serves them: the CLI (``cli.py``, run as
``python -m genrec_tpu_torch.cli``), the backend (``backend/``) and the
serving surface (``serving/``); and the distributed layer on
``torch.distributed`` (``parallel/``, ``ops/embedding.py``,
``ops/ring_attention.py``): the five pipelines train data-parallel under
a process group, and ``SASRecLarge``'s table is row-sharded.
"""
