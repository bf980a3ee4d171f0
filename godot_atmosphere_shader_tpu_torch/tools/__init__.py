"""Command-line harnesses of the port: the GPU gate (``gpu_checks``) and the
banded sampler's fidelity on the demo frame (``measure_band_fidelity``),
twins of the JAX package's ``tools/tpu_checks.py`` and
``tools/measure_band_fidelity.py``."""
