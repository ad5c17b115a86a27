"""det_sam2_tpu_torch: the PyTorch / CUDA port of det_sam2_tpu for the H100.

The JAX package ``det_sam2_tpu`` is the reference; this package mirrors its
module names (configs, convert, modeling/*, ops/*, state, track) and imports
nothing of it. Its Pallas TPU kernels are hand-written CUDA C++ under
``csrc/``, built at first use (see ``ops/attention.py``).
"""
