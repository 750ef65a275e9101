"""repro_torch — the PyTorch + CUDA (Hopper) port of ``repro``'s
one-device sketching path: Philox Omega draws, the fused sketch kernels,
the Nystrom pair and the one-pass streaming sketch.  It imports torch and
never jax nor the reference package."""
__version__ = "0.1.0"
