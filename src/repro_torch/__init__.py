"""PyTorch/CUDA port of the cuMF reproduction, for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing
of it (nor of JAX).  Module and function names follow the reference so
each counterpart is easy to find:

- ``backend``          device and kernel-mode selection;
- ``sparse``           padded-ELL layouts and synthetic ratings (numpy);
- ``kernels``          plain torch versions, the hand-written CUDA kernels
                       (``csrc/``), their ctypes wrappers and ``ops``;
- ``core``             the objective and the in-core MO-ALS driver;
- ``sgd``              CuMF_SGD blocking, the batch-Hogwild epoch driver
                       and the ALS->SGD hybrid;
- ``training``         the learning-rate schedule;
- ``checkpoint``       the checkpoint store and manager (the reference's
                       on-disk layout).

Entry points run on the card unless the caller passes ``device="cpu"``;
without a GPU they raise instead of falling back.
"""
