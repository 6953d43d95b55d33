"""instant_nvr_tpu_torch — the PyTorch + CUDA port of ``instant_nvr_tpu``.

The JAX package beside it stays the reference.  This package imports
``torch`` and never ``jax``; it mirrors the JAX package's module paths
(``instant_nvr_tpu/ops/knn.py`` <-> ``instant_nvr_tpu_torch/ops/knn.py``)
and keeps its tensor layouts at every public function, so the parity tests
(``tests/test_torch_*.py``) compare like with like.

Ported: the render path (``python -m instant_nvr_tpu_torch.run``), the
training run with its data layer, loop and patch-LPIPS step (``python -m
instant_nvr_tpu_torch.train_net``) and the on-card self-check
(``tools/cuda_selfcheck``).  Every TPU kernel of the JAX package
is a hand-written CUDA kernel under ``csrc/``.
"""
import torch as _torch

__version__ = "0.1.0"

# On the CPU, torch's exp and log call MKL's vector math library, which
# picks its kernels for the CPU at its first call.  When that first call is
# torch's exp split over OpenMP threads, a thread that enters while another
# is still picking runs MKL's AVX2 enhanced-performance exp (about 11
# correct bits: up to 1.5e-4 relative error) over its whole slice, where
# torch asks for the high-accuracy one (within an ulp); later calls are
# right.  One call on the importing thread makes the choice first.
_torch.exp(_torch.zeros(16))
