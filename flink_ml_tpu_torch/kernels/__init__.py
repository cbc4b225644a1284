"""Hand-written CUDA kernels for Hopper (``csrc/``) and their build
(:mod:`.build`)."""
