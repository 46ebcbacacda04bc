"""The package version (``sigdigger_tpu/version.py``'s)."""

__version__ = "0.1.0"
