"""recovery_roofline: the recovery bank's bound over the traced time of the
kernels launched from its host call (the ``recovery`` span), a block
(:func:`sdbench.roofline_session.span_share`)."""

from sdbench import roofline_session


def read(ctx):
    return roofline_session.span_share(ctx, "recovery")
