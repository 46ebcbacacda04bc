"""The port stands alone: it imports neither JAX nor sigdigger_tpu."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "sigdigger_tpu_torch")

MODULES = [
    "sigdigger_tpu_torch",
    "sigdigger_tpu_torch.backend",
    "sigdigger_tpu_torch.types",
    "sigdigger_tpu_torch.config",
    "sigdigger_tpu_torch.profiles",
    "sigdigger_tpu_torch.native",
    "sigdigger_tpu_torch.sources",
    "sigdigger_tpu_torch.sources.base",
    "sigdigger_tpu_torch.sources.file",
    "sigdigger_tpu_torch.sources.synth",
    "sigdigger_tpu_torch.sources.tonegen",
    "sigdigger_tpu_torch.sources.registry",
    "sigdigger_tpu_torch.sources.stdin_src",
    "sigdigger_tpu_torch.io",
    "sigdigger_tpu_torch.io.wav",
    "sigdigger_tpu_torch.io.mat",
    "sigdigger_tpu_torch.io.cbor",
    "sigdigger_tpu_torch.io.suscan_wire",
    "sigdigger_tpu_torch.io.remote_analyzer",
    "sigdigger_tpu_torch.io.remote",
    "sigdigger_tpu_torch.io.webspectrum",
    "sigdigger_tpu_torch.io.datasaver",
    "sigdigger_tpu_torch.io.forwarder",
    "sigdigger_tpu_torch.io.rmsviewer",
    "sigdigger_tpu_torch.audio",
    "sigdigger_tpu_torch.audio.playback",
    "sigdigger_tpu_torch.audio.alsa",
    "sigdigger_tpu_torch.audio.portaudio",
    "sigdigger_tpu_torch.utils",
    "sigdigger_tpu_torch.utils.logger",
    "sigdigger_tpu_torch.utils.waterfall",
    "sigdigger_tpu_torch.utils.palette",
    "sigdigger_tpu_torch.utils.symview",
    "sigdigger_tpu_torch.utils.views",
    "sigdigger_tpu_torch.utils.globalprop",
    "sigdigger_tpu_torch.orbit",
    "sigdigger_tpu_torch.orbit.tle",
    "sigdigger_tpu_torch.orbit.sgp4",
    "sigdigger_tpu_torch.library",
    "sigdigger_tpu_torch.tasks",
    "sigdigger_tpu_torch.tasks.psdutil",
    "sigdigger_tpu_torch.tasks.base",
    "sigdigger_tpu_torch.tasks.transforms",
    "sigdigger_tpu_torch.tasks.sampler",
    "sigdigger_tpu_torch.tasks.carrier",
    "sigdigger_tpu_torch.tasks.doppler",
    "sigdigger_tpu_torch.tasks.export",
    "sigdigger_tpu_torch.tasks.tle",
    "sigdigger_tpu_torch.dsp",
    "sigdigger_tpu_torch.dsp.window",
    "sigdigger_tpu_torch.dsp.filters",
    "sigdigger_tpu_torch.dsp.pll",
    "sigdigger_tpu_torch.dsp.clock",
    "sigdigger_tpu_torch.dsp.decider",
    "sigdigger_tpu_torch.dsp.equalizer",
    "sigdigger_tpu_torch.dsp.iir",
    "sigdigger_tpu_torch.dsp.snr",
    "sigdigger_tpu_torch.dsp.ncqo",
    "sigdigger_tpu_torch.dsp.quad",
    "sigdigger_tpu_torch.dsp.resample",
    "sigdigger_tpu_torch.dsp.agc",
    "sigdigger_tpu_torch.dsp.spectrum",
    "sigdigger_tpu_torch.dsp.channelizer",
    "sigdigger_tpu_torch.dsp.tv",
    "sigdigger_tpu_torch.inspectors",
    "sigdigger_tpu_torch.inspectors.base",
    "sigdigger_tpu_torch.inspectors.audio",
    "sigdigger_tpu_torch.inspectors.digital",
    "sigdigger_tpu_torch.inspectors.simple",
    "sigdigger_tpu_torch.kernels",
    "sigdigger_tpu_torch.kernels._build",
    "sigdigger_tpu_torch.kernels.ops",
    "sigdigger_tpu_torch.kernels.audio",
    "sigdigger_tpu_torch.kernels.channelizer",
    "sigdigger_tpu_torch.kernels.fft",
    "sigdigger_tpu_torch.kernels.channelizer2",
    "sigdigger_tpu_torch.kernels.rawbank",
    "sigdigger_tpu_torch.kernels.recovery",
    "sigdigger_tpu_torch.kernels.compact",
    "sigdigger_tpu_torch.kernels.stage_variants",
    "sigdigger_tpu_torch.kernels.psd_phases",
    "sigdigger_tpu_torch.kernels.symsqueeze",
    "sigdigger_tpu_torch.kernels.tcsplit",
    "sigdigger_tpu_torch.kernels.drainpack",
    "sigdigger_tpu_torch.kernels.tvline",
    "sigdigger_tpu_torch.kernels.equalizer",
    "sigdigger_tpu_torch.kernels.sass_report",
    "sigdigger_tpu_torch.receiver",
    "sigdigger_tpu_torch.analyzer",
    "sigdigger_tpu_torch.analyzer.messages",
    "sigdigger_tpu_torch.analyzer.detector",
    "sigdigger_tpu_torch.analyzer.estimators",
    "sigdigger_tpu_torch.analyzer.engine",
    "sigdigger_tpu_torch.analyzer.demap",
    "sigdigger_tpu_torch.analyzer.kernel_engine",
    "sigdigger_tpu_torch.analyzer.checkpoint",
    "sigdigger_tpu_torch.analyzer.tracker",
    "sigdigger_tpu_torch.analyzer.mediator",
    "sigdigger_tpu_torch.analyzer.sweep",
    "sigdigger_tpu_torch.pipeline",
    "sigdigger_tpu_torch.app",
    "sigdigger_tpu_torch.cli",
    "sigdigger_tpu_torch.__main__",
    "sigdigger_tpu_torch.parallel",
    "sigdigger_tpu_torch.parallel.banks",
    "sigdigger_tpu_torch.parallel.timebanks",
    "sigdigger_tpu_torch.parallel.sharding",
    "sigdigger_tpu_torch.parallel.distributed",
    "sigdigger_tpu_torch.device",
    "sigdigger_tpu_torch.plugin",
    "sigdigger_tpu_torch.version",
    "sigdigger_tpu_torch.sources.soapy",
    "sigdigger_tpu_torch.utils.averager",
    "sigdigger_tpu_torch.utils.compile_cache",
    "sigdigger_tpu_torch.utils.profiling",
    "sigdigger_tpu_torch.utils.roofline",
    "sigdigger_tpu_torch.utils.waveform",
]

_FORBIDDEN = ("jax", "sigdigger_tpu")


def _forbidden(name: str) -> bool:
    # whole module names: `sigdigger_tpu_torch` is not `sigdigger_tpu`
    return any(name == f or name.startswith(f + ".") for f in _FORBIDDEN)


def _sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_every_module_imports_without_jax_or_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "import sigdigger_tpu_torch as p\n"
        "assert p.KernelReceiver.__module__ == 'sigdigger_tpu_torch.receiver'\n"
        "assert p.KernelAnalyzer.__module__ == "
        "'sigdigger_tpu_torch.analyzer.kernel_engine'\n"
        "assert p.Analyzer.__module__ == 'sigdigger_tpu_torch.analyzer.engine'\n"
        "assert p.MessageKind.__module__ == "
        "'sigdigger_tpu_torch.analyzer.messages'\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'sigdigger_tpu' or "
        "m.startswith('sigdigger_tpu.'))\n"
        "print('BAD', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_every_package_module_is_listed():
    found = set()
    for f in _sources():
        rel = os.path.relpath(f, ROOT)
        if rel == "chip_smoke.py":
            continue
        mod = rel[:-3].replace(os.sep, ".")
        found.add(mod[:-len(".__init__")] if mod.endswith(".__init__")
                  else mod)
    assert found == set(MODULES)


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_import_statement_names_jax_or_reference(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    assert not [n for n in names if _forbidden(n)], names


def test_forbidden_match_is_by_whole_name():
    assert _forbidden("jax.numpy") and _forbidden("sigdigger_tpu.native")
    assert not _forbidden("sigdigger_tpu_torch.native")
    assert not _forbidden("jaxtyping")


def test_every_reference_module_has_a_counterpart():
    """Every ``sigdigger_tpu/**.py`` has a module of the same path in the
    port; the reference's ``native/__init__.py`` (a package of one
    module) is the port's ``native.py``."""
    ref = os.path.join(ROOT, "sigdigger_tpu")
    renamed = {"sigdigger_tpu_torch.native.__init__":
               "sigdigger_tpu_torch.native"}
    missing = []
    for d, _, names in os.walk(ref):
        for n in names:
            if not n.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(d, n), ref)[:-3]
            mod = "sigdigger_tpu_torch." + rel.replace(os.sep, ".")
            mod = renamed.get(mod, mod)
            if mod.endswith(".__init__"):
                mod = mod[:-len(".__init__")]
            if mod not in MODULES:
                missing.append(mod)
    assert not missing, missing
