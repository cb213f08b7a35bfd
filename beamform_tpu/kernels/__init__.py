"""Hand-written kernels and the small-matrix algebra of the main path.

``gsc_sample`` is the one hand-written kernel: the GSC per-sample adaptive
stage as a Pallas program lowered through Triton for NVIDIA GPUs.
Everything else here is plain JAX that XLA compiles for any backend.
"""
