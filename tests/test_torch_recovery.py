"""The port's recovery bank (``kernels/recovery.py``) against the
reference's ``RecoveryBank`` in interpret mode, on the scenarios of
``tests/test_kernel_recovery.py``, ``test_kernel_psk.py`` and
``test_kernel_digital.py``.

Tolerance scheme, with its reason.  The carrier loop, the Gardner
``t <= 0`` decision and the CMA update feed back, and the two sides
differ by one-ulp steps: XLA's CPU backend fuses some multiply-adds
into FMAs and has its own cos, sin and rsqrt.  So, per lane:

- up to the first sample whose strobe differs, every symbol within
  2e-3 of the reference's (symbols are O(1); measured at most 5e-5 on
  locked lanes over 4096 samples);
- after it, statistics: the strobe count within ±1, ``period_estimate``
  within 1%, the tail's 4th-power (QPSK) or 2nd-power (BPSK)
  concentration within 0.02 of the reference's, and the FSK and ASK
  bimodality checks of ``tests/test_kernel_recovery.py:140-150``.

Every lane carries a signal of its kind or zeros: on noise alone an
unlocked Costas loop is chaotic and no bound of this kind holds.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sigdigger_tpu.kernels.recovery import RecoveryBank as RefBank
from sigdigger_tpu.kernels.recovery import (
    RecoveryBankConfig as RefBankConfig,
)
from sigdigger_tpu_torch.dsp.filters import rrc_taps
from sigdigger_tpu_torch.kernels import recovery
from sigdigger_tpu_torch.kernels.recovery import (
    KIND_ASK,
    KIND_FSK,
    KIND_PSK,
    PARAM_ROWS,
    RecoveryBank,
    RecoveryBankConfig,
    strobe_agreement,
)

TOL_SYM = 2e-3


def make_psk(nsym, sps, order=4, f_off=0.0, seed=0, span=6):
    rng = np.random.default_rng(seed)
    syms = rng.integers(0, order, nsym)
    n = int(round(nsym * sps))
    up = np.zeros(n, np.complex64)
    pos = np.round(np.arange(nsym) * sps).astype(int)
    up[pos[pos < n]] = np.exp(1j * (2 * np.pi * syms / order))[pos < n]
    bb = np.convolve(up, rrc_taps(sps, span=span, rolloff=0.35))[:n]
    k = np.arange(n)
    return (bb * np.exp(2j * np.pi * f_off * k)).astype(np.complex64), syms


def fsk(n, sps, seed):
    bits = np.random.default_rng(seed).integers(0, 2, n // sps + 1)
    inst = (2 * bits - 1).repeat(sps)[:n] * 0.1 * np.pi
    return np.exp(1j * np.cumsum(inst)).astype(np.complex64), bits


def ask(n, sps, seed):
    bits = np.random.default_rng(seed).integers(0, 2, n // sps + 1)
    return (0.4 + 0.6 * bits).repeat(sps)[:n].astype(np.complex64), bits


def conc(sym, strobe, power):
    got = sym[strobe]
    tail = got[len(got) // 2:]
    return float(np.abs(np.mean(np.exp(1j * np.angle(tail ** power)))))


def make_pair(n_channels, block_len, confs, ref_m_tile=0):
    ref = RefBank(RefBankConfig(n_channels=n_channels, block_len=block_len,
                                channel_tile=n_channels,
                                m_tile=ref_m_tile), interpret=True)
    ours = RecoveryBank(RecoveryBankConfig(n_channels=n_channels,
                                           block_len=block_len),
                        device="cpu")
    for c, kw in confs.items():
        ref.configure_channel(c, **kw)
        ours.configure_channel(c, **kw)
    return ref, ours


def run(bank, y, block_len):
    out = [bank.feed(y[i:i + block_len]) for i in range(0, len(y), block_len)]
    return (np.concatenate([o[0] for o in out]),
            np.concatenate([o[1] for o in out]))


def assert_agree(ours, ref, lanes, powers=None, period=True):
    """The tolerance scheme of the module docstring, on ``lanes``;
    ``powers`` maps a lane to its concentration power (4 QPSK, 2
    BPSK)."""
    (so, to), (sr, tr), bank_o, bank_r = ours[:2], ref[:2], ours[2], ref[2]
    assert so.dtype == np.complex64 and to.dtype == bool
    assert so.shape == sr.shape and to.shape == tr.shape
    ag = strobe_agreement(so, to, sr, tr)
    for c in lanes:
        assert ag["max_err"][c] <= TOL_SYM, (c, ag["max_err"][c])
        assert abs(int(ag["count_a"][c]) - int(ag["count_b"][c])) <= 1, c
    if period:
        po, pr = bank_o.period_estimate, np.asarray(bank_r.period_estimate)
        assert np.all(np.abs(po[lanes] - pr[lanes]) <= 0.01 * pr[lanes])
    for c, power in (powers or {}).items():
        assert abs(conc(so[:, c], to[:, c], power)
                   - conc(sr[:, c], tr[:, c], power)) <= 0.02, c
    return ag


MIXED = {
    0: dict(kind=KIND_PSK, sps=4.0, order=4, loop_bw=0.005,
            clock_gain=0.08),
    1: dict(kind=KIND_PSK, sps=8.0, order=2, loop_bw=0.005,
            clock_gain=0.08),
    2: dict(kind=KIND_FSK, sps=8.0, clock_gain=0.08, use_mf=False),
    3: dict(kind=KIND_ASK, sps=8.0, clock_gain=0.08, use_mf=False),
    4: dict(kind=KIND_PSK, sps=4.0, order=8, eq_enabled=True),
    5: dict(kind=KIND_FSK, sps=8.0, quad_demod=False, fsk_phase=0.3),
    6: dict(kind=KIND_ASK, sps=8.0, pll=True),
    7: dict(kind=KIND_PSK, sps=4.0, manual_clock=True, clock_phase=0.25),
    8: dict(kind=KIND_PSK, sps=4.0, running=False),
    9: dict(kind=KIND_PSK, sps=4.0, eq_enabled=True, eq_locked=True),
}


def mixed_input(n, c):
    y = np.zeros((n, c), np.complex64)
    y[:, 0] = make_psk(n // 4, 4.0, 4, 0.002, 1)[0][:n]
    y[:, 1] = make_psk(n // 8, 8.0, 2, -0.001, 2)[0][:n]
    y[:, 2] = fsk(n, 8, 3)[0]
    y[:, 3] = ask(n, 8, 4)[0]
    y[:, 4] = make_psk(n // 4, 4.0, 8, 0.001, 5)[0][:n]
    y[:, 5] = fsk(n, 8, 6)[0]
    y[:, 6] = ask(n, 8, 7)[0] * np.exp(2j * np.pi * 0.001 * np.arange(n))
    y[:, 7] = make_psk(n // 4, 4.0, 4, 0.0, 8)[0][:n]
    y[:, 8] = y[:, 7]
    y[:, 9] = make_psk(n // 4, 4.0, 4, 0.001, 9)[0][:n]
    return y


def test_mixed_kinds_per_channel():
    """Every kind and option at once, each lane with its own
    configuration (test_kernel_recovery.py:87-150, widened); lanes
    10.. are left unconfigured and fed zeros."""
    n, c, bl = 4096, 16, 512
    ref, ours = make_pair(c, bl, MIXED)
    y = mixed_input(n, c)
    so, to = run(ours, y, bl)
    sr, tr = run(ref, y, bl)
    assert_agree((so, to, ours), (sr, tr, ref), lanes=list(range(10)),
                 powers={0: 4, 1: 2, 7: 4, 9: 4})
    # the reference test's own checks, on the port
    assert conc(so[:, 0], to[:, 0], 4) > 0.9
    assert abs(ours.period_estimate[0] - 4.0) < 0.2
    assert conc(so[:, 1], to[:, 1], 2) > 0.9
    assert abs(ours.period_estimate[1] - 8.0) < 0.4
    got = np.real(so[:, 2][to[:, 2]])
    tail = got[len(got) // 2:]
    assert np.mean(np.abs(np.abs(tail) - 0.1) < 0.03) > 0.9
    got = np.real(so[:, 3][to[:, 3]])
    tail = got[len(got) // 2:]
    assert np.std(np.abs(tail)) < np.std(tail)
    assert not to[:, 8].any() and np.all(so[:, 8] == 0)   # running=False
    assert np.all(np.abs(so[:, 10:]) < 1e-3)              # zeros in


def test_qpsk_recovery():
    """test_kernel_psk.py: QPSK at sps 4 with a carrier offset (512
    symbols, half the original's)."""
    conf = {c: dict(kind=KIND_PSK, sps=4.0, order=4, loop_bw=0.005,
                    clock_gain=0.08) for c in range(8)}
    ref, ours = make_pair(8, 512, conf)
    x, _ = make_psk(512, 4, f_off=0.002, span=8)
    y = np.tile(x[:, None], (1, 8))
    so, to = run(ours, y, 512)
    sr, tr = run(ref, y, 512)
    assert_agree((so, to, ours), (sr, tr, ref), lanes=list(range(8)),
                 powers={0: 4, 7: 4})
    assert np.allclose(ours.period_estimate, 4.0, atol=0.1)
    for c in (0, 7):
        assert to[:, c].sum() > 512 * 0.95
        assert conc(so[:, c], to[:, c], 4) > 0.9


@pytest.mark.parametrize("kind", ["fsk", "ask"])
def test_fsk_ask_recovery(kind):
    """test_kernel_digital.py: FSK two-tone and ASK OOK at sps 8 (256
    bits, half the original's)."""
    k = {"fsk": KIND_FSK, "ask": KIND_ASK}[kind]
    conf = {c: dict(kind=k, sps=8.0, clock_gain=0.05, use_mf=False)
            for c in range(8)}
    ref, ours = make_pair(8, 512, conf)
    rng = np.random.default_rng(0 if kind == "fsk" else 1)
    bits = rng.integers(0, 2, 256)
    if kind == "fsk":
        x = np.exp(1j * np.cumsum(np.repeat((bits * 2 - 1) * 0.1 * np.pi,
                                            8))).astype(np.complex64)
    else:
        x = np.repeat(bits.astype(np.float32), 8).astype(np.complex64)
    y = np.tile(x[:, None], (1, 8))
    so, to = run(ours, y, 512)
    sr, tr = run(ref, y, 512)
    assert_agree((so, to, ours), (sr, tr, ref), lanes=list(range(8)))
    got = np.real(so[:, 3][to[:, 3]])
    n = len(got)
    tail = got[n // 2:]
    if kind == "fsk":
        assert abs(n - 256) < 15
        want = (bits * 2 - 1)[-n:][n // 2:n // 2 + len(tail)]
        assert np.mean(np.sign(tail) == want[:len(tail)]) > 0.95
        assert np.allclose(ours.period_estimate, 8.0, atol=0.2)
    else:
        want = bits[-n:][n // 2:n // 2 + len(tail)]
        assert np.mean((tail > 0).astype(int) == want[:len(tail)]) > 0.9


def test_one_pass_equals_reference_time_tiles():
    """The reference's time tiles only carry state: its bank at m_tile
    128 and at m_tile 1024 and the port's one pass over the block give
    the same numbers (the reference's two to float32 rounding, the port
    within the tolerance scheme)."""
    conf = {c: MIXED[c] for c in range(8)}
    ref_a, ours = make_pair(16, 1024, conf, ref_m_tile=128)
    ref_b, _ = make_pair(16, 1024, conf, ref_m_tile=1024)
    assert (ref_a.cfg.m_tile, ref_b.cfg.m_tile) == (128, 1024)
    y = mixed_input(2048, 16)
    sa, ta = run(ref_a, y, 1024)
    sb, tb = run(ref_b, y, 1024)
    assert np.array_equal(ta, tb)
    assert np.abs(sa - sb).max() <= 1e-5
    so, to = run(ours, y, 1024)
    assert_agree((so, to, ours), (sa, ta, ref_a), lanes=list(range(8)))


@pytest.mark.parametrize("kind", ["psk", "fsk_mf"])
def test_streaming_split_equals_one_shot(kind):
    """Four blocks of 256 and one of 1024 through the port give the same
    numbers bit for bit: the block boundary only carries state."""
    if kind == "psk":
        conf = {c: dict(kind=KIND_PSK, sps=4.0, order=4) for c in range(8)}
        x = make_psk(512, 4.0, seed=3)[0][:1024]
    else:
        conf = {c: dict(kind=KIND_FSK, sps=4.0, use_mf=True)
                for c in range(8)}
        rng = np.random.default_rng(2)
        x = (rng.standard_normal(1024) + 1j * rng.standard_normal(1024)
             ).astype(np.complex64)
    y = np.tile(x[:, None], (1, 8))
    _, split = make_pair(8, 256, conf)
    _, whole = make_pair(8, 1024, conf)
    s1, t1 = run(split, y, 256)
    s2, t2 = run(whole, y, 1024)
    assert np.array_equal(s1, s2) and np.array_equal(t1, t2)
    assert np.array_equal(split.state.numpy(), whole.state.numpy())


def test_state_carries_across_from_reference():
    """Two blocks on the reference, its state rows into the port, block
    3 on both: the state layout is the same."""
    ref, ours = make_pair(16, 512, MIXED)
    y = mixed_input(1536, 16)
    run(ref, y[:1024], 512)
    ours.state = np.array(ref.state)
    so, to = run(ours, y[1024:], 512)
    sr, tr = run(ref, y[1024:], 512)
    assert_agree((so, to, ours), (sr, tr, ref), lanes=list(range(10)))


def test_configuration_matches_reference():
    """Parameter rows, MF taps and initial state after every
    configure_channel key, deferred or not, and after a reset."""
    ref, ours = make_pair(16, 256, MIXED)
    for bank in (ref, ours):
        bank.begin_defer()
        bank.configure_channel(11, kind=KIND_FSK, sps=6.0, mf_rolloff=0.5)
        bank.configure_channel(12, kind=KIND_PSK, order=8, sps=3.0,
                               loop_bw=0.01, clock_phase=1.75)
        bank.end_defer()
        bank.configure_channel(13, kind=KIND_ASK, pll=True, eq_rate=2e-3,
                               eq_locked=False, reset_state=False)
    rows = ours.param_rows()
    for name in PARAM_ROWS:
        assert np.array_equal(rows[name], np.asarray(ref.consts[name])[0]), \
            name
        i = PARAM_ROWS.index(name)
        assert np.array_equal(ours.consts["params"][i].numpy(), rows[name])
    assert np.array_equal(ours.consts["mf"].numpy(),
                          np.asarray(ref.consts["mf"]))
    assert np.array_equal(ours.state, ref.state)
    assert ours.STATE_ROWS == ref.STATE_ROWS == 16 + 2 * 63 + 4 * 5
    with pytest.raises(ValueError):
        ours.configure_channel(0, sps=1.5)
    with pytest.raises(ValueError):
        ours.configure_channel(0, order=3)


def test_kernel_reference_is_the_banks_call():
    """recovery_kernel on a CPU tensor is the plain version, and it
    returns fresh state, leaving the input state untouched."""
    ref, ours = make_pair(16, 256, MIXED)
    y = mixed_input(256, 16)
    state = torch.as_tensor(ours.state).clone()
    before = state.clone()
    args = (torch.from_numpy(np.ascontiguousarray(y.real)),
            torch.from_numpy(np.ascontiguousarray(y.imag)), state,
            ours.consts["params"], ours.consts["mf"], ours.params)
    a = recovery.recovery_kernel(*args)
    b = recovery.recovery_kernel_reference(*args)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert torch.equal(state, before) and a[3] is not state


def _launch_args(c=24, m=100, k=64, keq=5):
    bank = RecoveryBank(RecoveryBankConfig(n_channels=c, block_len=m,
                                           mf_taps_max=k, eq_taps=keq),
                        device="cpu")
    y = torch.zeros((m, c))
    return [y, y.clone(), torch.as_tensor(bank.state).clone(),
            bank.consts["params"], bank.consts["mf"], bank.params]


# what the CUDA kernel refuses, held on the CPU: (name, edit of the args)
BAD_LAUNCHES = {
    "keq_0": lambda a: a.__setitem__(5, recovery.RecoveryParams(
        k=64, keq=0, adc=a[5].adc, one_m_adc=a[5].one_m_adc)),
    "keq_9": lambda a: a.__setitem__(5, recovery.RecoveryParams(
        k=64, keq=9, adc=a[5].adc, one_m_adc=a[5].one_m_adc)),
    "no_rows": lambda a: (a.__setitem__(0, a[0][:0]),
                          a.__setitem__(1, a[1][:0])),
    "state_height": lambda a: a.__setitem__(2, a[2][:-1].contiguous()),
    "float64_plane": lambda a: a.__setitem__(1, a[1].double()),
    "strided_plane": lambda a: a.__setitem__(
        0, a[0].t().contiguous().t()),
    "taps_rows": lambda a: a.__setitem__(4, a[4][:-1].contiguous()),
    "params_lanes": lambda a: a.__setitem__(3, a[3][:, :-1].contiguous()),
}


@pytest.mark.parametrize("name", list(BAD_LAUNCHES))
def test_launch_checks_refuse_what_the_kernel_cannot_take(name):
    args = _launch_args()
    assert recovery.check_launch(*args) == (100, 24)
    BAD_LAUNCHES[name](args)
    with pytest.raises(ValueError):
        recovery.check_launch(*args)


@pytest.mark.parametrize("keq", [1, 8])
@pytest.mark.parametrize("k", [1, 64, 100])
def test_launch_checks_take_any_lanes_rows_taps_and_keq(k, keq):
    """Ragged lane counts, rows not a multiple of the kernel's chunk,
    K = 1 and keq at both ends pass; K past the shared memory does not."""
    c, m = 100, recovery.REC_CHUNK + 37
    p = recovery.RecoveryParams(k=k, keq=keq, adc=0.9995, one_m_adc=5e-4)
    rows = 16 + 2 * (k - 1) + 4 * keq
    y = torch.zeros((m, c))
    args = (y, y, torch.zeros((rows, c)), torch.zeros((len(PARAM_ROWS), c)),
            torch.zeros((k, c)))
    assert recovery.check_launch(*args, p) == (m, c)
    big = recovery.RecoveryParams(k=600, keq=keq, adc=0.9995,
                                  one_m_adc=5e-4)
    assert recovery.recovery_smem_bytes(600) > recovery.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        recovery.check_launch(y, y, torch.zeros((16 + 2 * 599 + 4 * keq, c)),
                              args[3], torch.zeros((600, c)), big)


def test_shared_memory_of_a_block():
    """The fused kernel's layout (csrc/recovery.cu): y, mf and the FSK
    detector double-buffered over a chunk of rows, ext with its K-1 row
    tail double-buffered, the strobe queue and the taps, for REC_LANES
    lanes."""
    lanes, t = recovery.REC_LANES, recovery.REC_CHUNK
    for k in (1, 49, 64):
        floats = (4 * t * lanes + 4 * t * lanes + 4 * (k - 1 + t) * lanes
                  + 2 * t * lanes + k * lanes
                  + 6 * t * lanes + 2 * lanes)    # strobe queue
        assert recovery.recovery_smem_bytes(k) == 4 * floats + 16
    assert recovery.recovery_smem_bytes(64) < 104 * 1024
