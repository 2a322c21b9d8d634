"""Utilities of the port (counterpart of ``lcgp_tpu/utils``)."""
