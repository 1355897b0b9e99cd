"""The benchmark's yardstick for the PyTorch/CUDA port of cuMF.

Everything here belongs to the benchmark, not to the program under test:
the rating generator (:mod:`.data`), the frozen peaks (:mod:`.peaks`), the
work counts (:mod:`.work`), the plain reference and the comparison that
decides ``correct`` (:mod:`.reference`), the measured window
(:mod:`.window`), the device-clock spans and the profiler's reduction
(:mod:`.devtrace`), the lookup of configurations, traffic mixes, limits
and per-layer metric readers by name (:mod:`.registry`), and one driver
per solver of a traffic mix (:mod:`.als_cell`, :mod:`.sgd_cell`).
Nothing here imports JAX or the JAX package; :mod:`.reference` imports
nothing of the program either.
"""
