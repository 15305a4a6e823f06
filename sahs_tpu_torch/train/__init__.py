"""Stage-I training (counterpart of ``sahs_tpu/train``)."""
