"""PyTorch/CUDA port of the cuMF reproduction, for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing
of it (nor of JAX).  Module and function names follow the reference so
each counterpart is easy to find:

- ``backend``          device and kernel-mode selection;
- ``sparse``           padded-ELL layouts and synthetic ratings (numpy);
- ``kernels``          plain torch versions, the hand-written CUDA kernels
                       (``csrc/``), their ctypes wrappers, ``ops`` and the
                       kernels' shared-memory budgets;
- ``core``             the objective, the in-core MO-ALS driver and the
                       eq. (8) partition planner;
- ``sgd``              CuMF_SGD blocking, the batch-Hogwild epoch driver
                       and the ALS->SGD hybrid;
- ``training``         the learning-rate schedule;
- ``checkpoint``       the checkpoint store and manager (the reference's
                       on-disk layout);
- ``obs``              span tracing, metrics, Chrome-trace export and the
                       plan-vs-actual ledger (the reference's schema);
- ``data``             the host->device prefetcher (pinned staging, a
                       side CUDA stream);
- ``outofcore``        out-of-core streaming ALS and SGD: rating store,
                       wave schedule, runtime and wave drivers, on one
                       device or on a mesh;
- ``launch``           meshes of cells (one device each, cells may share
                       a card);
- ``distributed``      SU-ALS over a mesh, the reduce-scatter collectives
                       and the topology-aware host reduction.

Entry points run on the card unless the caller passes ``device="cpu"``;
without a GPU they raise instead of falling back.
"""
