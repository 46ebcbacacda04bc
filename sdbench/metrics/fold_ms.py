"""fold_ms: host ms a block in the PSD's unpermute and float64 EMA fold
(``rx.fold``); a mean over the traced blocks of the window."""

from sdbench import program_spans


def read(ctx):
    return program_spans.ms_a_block(ctx, "rx.fold")
