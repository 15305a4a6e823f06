"""Hand-written CUDA kernels for Hopper and their plain versions.

Each wrapper (K1 ``deform_pair.deform_pair_forward``, K5
``nerf_level.nerf_level_forward`` and the rest, K1-K15) launches a
``csrc/*.cu`` kernel for CUDA tensors and runs its plain tensor version for
CPU tensors. In bfloat16 the layer products run on the tensor cores
(``wgmma``, ``csrc/wgmma.cuh``: K1, K5 and the other MLP kernels), in
float32 on the CUDA cores. Importing this package builds nothing;
``_build`` compiles at the first launch.
"""
