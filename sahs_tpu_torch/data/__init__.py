"""See the package docstring of sahs_tpu_torch."""
