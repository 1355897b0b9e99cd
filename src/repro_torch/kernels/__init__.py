"""Plain torch versions (``ref``), the hand-written CUDA kernels
(``csrc/``, built by ``build``, wrapped by ``hermitian`` and
``batch_solve``) and the dispatching ``ops``."""
