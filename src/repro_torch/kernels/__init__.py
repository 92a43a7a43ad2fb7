"""Hand-written CUDA kernels for Hopper, one package each: ``csrc/*.cu``
(the kernel), ``ops.py`` (the wrapper and its launch count) and ``ref.py``
(the plain torch version).  ``_build`` compiles them at first use."""
