"""The yardstick's roofline counts for a ``session`` configuration, frozen
here so that a change to the program cannot move them.

Each count is the work the cell's open inspectors need, computed from the
configuration's shapes and its mix: the audio bank over the audio lanes,
the raw bank over the digital and power lanes (the power lanes read only
their block power), the recovery bank, the squeeze and the side
compactor over the digital lanes, the pack over the audio lanes and the
status rows, and the PSD over the block's frames.  The banks run at
their full slot width, idle slots included; counting those slots would
let a later change that skips them push a share past 100%, so they are
not counted.  Each input is read once and each output written once;
a channelize product counts as three TF32 passes on the tensor cores,
everything else on the CUDA cores at the float32 peak (the peaks and
:func:`bound_ms` of :mod:`sdbench.roofline`).  The elementwise counts
are floors: a transcendental counts one operation.
"""

from __future__ import annotations

from sdbench import session_mix
from sdbench.roofline import TC_PASSES, bound_ms, psd_xw_ms


def bounds_ms(cfg: dict) -> dict[str, float]:
    """Least ms a block of each kernel of the session takes."""
    a = cfg["assumed"]
    lanes = session_mix.lanes(cfg)
    la, ld, lp = (len(lanes[k]) for k in ("audio", "digital", "power"))
    lr = ld + lp
    m, k = cfg["block_out"], a["taps"]
    da, ka, ka2 = cfg["audio_decim"], a["audio_taps"], a["audio_fir_taps"]
    ma = m // da
    md = m // cfg["symbol_group"]
    tiles = m // min(a["m_tile"], m)
    xw = 2 * m * k * 2                      # the int16 packed windows
    mf = min(a["mf_taps"], 6 * 8 + 1)       # the RRC taps at 8 sps
    strobes = m // 8
    raw = bound_ms(
        ops=m * lr * (6 + 2 + 3),           # rotate, cos/sin, |y|^2
        nbytes=(xw + 2 * k * lr * 4 + (1 + tiles) * lr * 4
                + 2 * m * ld * 4 + lr * 4),
        tf32_ops=TC_PASSES * 8 * m * k * lr)
    audio = bound_ms(
        # rotate, cos/sin, |y| and its power, the discriminator and its
        # arctangent, the hang walk; the decimating and the lane's FIR
        ops=(m * la * (6 + 2 + 4 + 6 + 10 + 8)
             + 2 * ka * ma * la + 2 * ka2 * ma * la),
        nbytes=(xw + 2 * k * la * 4 + 2 * tiles * la * 4
                + (2 + 2 * (ka - 1) + 2 * (ka2 - 1) + 2 + 3) * la * 4 * 2
                + ka2 * la * 4 + ma * la * 4),
        tf32_ops=TC_PASSES * 8 * m * k * la)
    rows = 16 + 2 * (a["mf_taps"] - 1) + 4 * a["eq_taps"]
    recovery = bound_ms(
        # the carrier loop and detectors, the matched filter, the clock,
        # and the equalizer's update at each strobe
        ops=m * ld * (40 + 4 * mf + 25) + strobes * ld * 12 * a["eq_taps"],
        nbytes=2 * m * ld * 4 + 3 * m * ld * 4 + 2 * rows * ld * 4
        + mf * ld * 4)
    squeeze = bound_ms(ops=3 * m * ld,
                       nbytes=3 * m * ld * 4 + 3 * md * ld * 4)
    pack = bound_ms(ops=2 * ma * la + 12 * lr,
                    nbytes=ma * la * (4 + 2) + 2 * la * 4 + 6 * la * 2)
    compact = bound_ms(ops=2 * 3 * md * ld,
                       nbytes=3 * md * ld * (4 + 2))
    psd = psd_xw_ms(cfg["window_size"],
                    m * cfg["decimation"] // cfg["window_size"], 2, ema=True)
    return {"raw": raw, "audio": audio, "recovery": recovery,
            "squeeze": squeeze, "pack": pack, "compact": compact,
            "psd": psd}


def span_share(ctx, span: str) -> float | None:
    """% of a traced run's kernel time launched from the host call
    ``span`` that the call's bound (``ctx.bounds_ms[span]``, a block)
    accounts for; None where the run traced no such call."""
    runs = ctx.trace.get("span_counts", {}).get(span, 0)
    t = ctx.trace.get("kernel_s_by_span", {}).get(span)
    if not runs or not t or span not in ctx.bounds_ms:
        return None
    return 100.0 * ctx.bounds_ms[span] * 1e-3 * runs / t
