"""Counterparts of the JAX package's ``tools/`` experiments whose Pallas
kernels have Hopper kernels in the port: ``exp_gather`` (X1-X3) and
``exp_pair2`` (X4-X6). Each experiment's ``main()`` runs on the card and
times each case with ``utils.device.cuda_ms`` as below."""

# launches per timed run and timed runs per case, as the JAX tools' scans
LAUNCHES = 30
RUNS = 3
