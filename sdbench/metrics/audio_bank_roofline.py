"""audio_bank_roofline: the audio bank's bound over the traced time of the
kernels launched from its host call (the ``audio`` span), a block
(:func:`sdbench.roofline_session.span_share`)."""

from sdbench import roofline_session


def read(ctx):
    return roofline_session.span_share(ctx, "audio")
