"""Command-line entry points (counterpart of ``sahs_tpu/cli``)."""
