"""Host utilities of the port (counterpart of ``sigdigger_tpu/utils``)."""
