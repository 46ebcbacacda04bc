"""Offline tasks of the port (counterpart of ``sigdigger_tpu/tasks``):
so far the PSD backend the estimators use."""
