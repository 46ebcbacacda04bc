"""raw_bank_roofline: the raw bank's bound over the traced time of the
kernels launched from its host call (the ``raw`` span), a block
(:func:`sdbench.roofline_session.span_share`)."""

from sdbench import roofline_session


def read(ctx):
    return roofline_session.span_share(ctx, "raw")
