"""instant_nvr_tpu_torch — the PyTorch + CUDA port of ``instant_nvr_tpu``.

The JAX package beside it stays the reference.  This package imports
``torch`` and never ``jax``; it mirrors the JAX package's module paths
(``instant_nvr_tpu/ops/knn.py`` <-> ``instant_nvr_tpu_torch/ops/knn.py``)
and keeps its tensor layouts at every public function, so the parity tests
(``tests/test_torch_*.py``) compare like with like.

Ported so far: the forward render path (``renderer.inb_renderer.render_rays``
with ``train=False`` and the chunked eval renderer in ``eval.runner``).  Its
one TPU kernel, the fused KNN blend, is a hand-written CUDA kernel
(``csrc/knn_blend.cu``).  ``python -m instant_nvr_tpu_torch.run`` is the
entry point.
"""

__version__ = "0.1.0"
