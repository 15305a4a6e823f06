"""Hand-written CUDA kernels for Hopper and their plain versions.

K1 ``deform_pair.deform_pair_forward`` and K5
``nerf_level.nerf_level_forward`` launch ``csrc/*.cu`` kernels for CUDA
tensors and run their plain tensor versions for CPU tensors. Importing
this package builds nothing; ``_build`` compiles at the first launch.
"""
