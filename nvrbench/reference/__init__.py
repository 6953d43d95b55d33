"""The benchmark's plain reference: a frozen copy of the port's plain
PyTorch route (``instant_nvr_tpu_torch`` as of the benchmark's first
version), with the package's layout and its imports kept relative to this
copy.

It holds the model (``models/``), the renderer, the losses and the train
step with its optimizer (``train/``), and the data layer that builds an
item from the subject's files (``datasets/``).  Against the program it
differs where the program calls what this copy cannot: the hand-written
KNN and scatter kernels run their plain versions here on every device
(``ops/knn.py``, ``ops/scatter.py``), rays' near and far are numpy
(``ops/ray.py:get_near_far_np``) where the program calls its host library,
and PNGs are read by ``zlib`` alone.  It imports nothing of the program
and takes nothing the program made: the harness hands it the subject's
files, the seeds and the initial weights it drew itself.
"""
