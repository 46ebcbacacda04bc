"""Host utilities of the port (counterpart of ``sigdigger_tpu/utils``)."""


def largest_divisor(n: int, limit: int) -> int:
    """The largest divisor of ``n`` that is at most ``limit``."""
    d = min(n, limit)
    while n % d:
        d -= 1
    return d
