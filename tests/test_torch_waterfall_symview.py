"""The port's ``Waterfall``, palettes (``utils/waterfall.py``,
``utils/palette.py``) and ``SymView`` (``utils/symview.py``) against the
reference's, on the cases of ``tests/test_waterfall.py`` and
``tests/test_views.py``'s SymView tests, on the CPU.  These are the same
host numpy operations on both sides: every image, PNG byte, text and
guess must be equal.
"""

from __future__ import annotations

import numpy as np
import pytest

from sigdigger_tpu.utils.palette import DEFAULT_PALETTES as REF_PALETTES
from sigdigger_tpu.utils.symview import SymView as RefSymView
from sigdigger_tpu.utils.waterfall import Waterfall as RefWaterfall
from sigdigger_tpu_torch.utils.palette import DEFAULT_PALETTES, Palette
from sigdigger_tpu_torch.utils.symview import SymView
from sigdigger_tpu_torch.utils.waterfall import Waterfall


def test_palettes_match_reference():
    assert list(DEFAULT_PALETTES) == list(REF_PALETTES)
    for name, pal in DEFAULT_PALETTES.items():
        np.testing.assert_array_equal(pal.gradient,
                                      REF_PALETTES[name].gradient)
        assert Palette.from_dict(pal.to_dict()).stops == pal.stops
        assert pal.lookup(0.5) == REF_PALETTES[name].lookup(0.5)
    with pytest.raises(ValueError):
        Palette("empty", [])


def test_waterfall_rows_rolloff_and_png(tmp_path):
    ours, ref = (Waterfall(bins=64, max_rows=10),
                 RefWaterfall(bins=64, max_rows=10))
    np.testing.assert_array_equal(ours.to_rgb(), ref.to_rgb())  # empty
    rng = np.random.default_rng(1)
    for i in range(25):
        psd = np.full(64, 1e-9) * rng.uniform(0.5, 2.0, 64)
        psd[i % 64] = 1.0 + i
        ours.feed(psd)
        ref.feed(psd)
    assert ours.rows == ref.rows == 10
    np.testing.assert_array_equal(ours.to_rgb(), ref.to_rgb())
    assert ours.png_bytes() == ref.png_bytes()
    ours.save_png(str(tmp_path / "a.png"))
    ref.save_png(str(tmp_path / "b.png"))
    assert (tmp_path / "a.png").read_bytes() == \
        (tmp_path / "b.png").read_bytes()


@pytest.mark.parametrize("bps, width, offset", [(2, 4, 0), (1, 10, 5),
                                                (3, 7, 2)])
def test_symview_raster_text_and_bits(tmp_path, bps, width, offset):
    rng = np.random.default_rng(bps)
    syms = rng.integers(0, 1 << bps, 500)
    ours, ref = SymView(bits_per_symbol=bps), RefSymView(bits_per_symbol=bps)
    for sv in (ours, ref):
        sv.feed(syms[:200])
        sv.feed(syms[200:])
        sv.width, sv.offset = width, offset
    assert len(ours) == len(ref) == 500
    np.testing.assert_array_equal(ours.to_rgb(), ref.to_rgb())
    np.testing.assert_array_equal(ours.to_rgb(max_rows=3),
                                  ref.to_rgb(max_rows=3))
    np.testing.assert_array_equal(ours.to_bits(), ref.to_bits())
    ours.save_text(str(tmp_path / "a.txt"))
    ref.save_text(str(tmp_path / "b.txt"))
    assert (tmp_path / "a.txt").read_text() == \
        (tmp_path / "b.txt").read_text()
    ours.save_png(str(tmp_path / "a.png"))
    ref.save_png(str(tmp_path / "b.png"))
    assert (tmp_path / "a.png").read_bytes() == \
        (tmp_path / "b.png").read_bytes()
    ours.clear()
    assert len(ours) == 0


def test_symview_autofit_and_cap():
    rng = np.random.default_rng(0)
    stream = np.tile(rng.integers(0, 2, 37), 80)
    ours, ref = SymView(1), RefSymView(1)
    ours.feed(stream)
    ref.feed(stream)
    assert ours.autofit() == ref.autofit() == 37
    short = SymView(1)
    short.feed(stream[:10])
    assert short.guess_width() is None and short.autofit() == 64
    capped = SymView(1, max_symbols=100)
    capped.feed(stream)
    np.testing.assert_array_equal(capped._syms, stream[-100:])
