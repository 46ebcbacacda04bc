"""Typed key-value configuration — the `suscan_config_t` equivalent.

The reference engine configures every inspector through a typed,
namespaced key-value store round-tripped over `setInspectorConfig`
(reference Suscan/Config.cpp; key inventory extracted from
Default/GenericInspector/InspectorCtl/*.cpp and
Default/Audio/AudioProcessor.cpp:251-269 — see SURVEY.md §5.6).
That key contract *is* the public API of the demodulator chains, so the
port keeps it verbatim (counterpart of ``sigdigger_tpu/config.py``): the
same keys, types and defaults drive the kernel banks.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Iterator, Mapping


@dataclass(frozen=True)
class ConfigField:
    name: str
    type: type       # bool, int, float, str
    default: Any
    desc: str = ""


class ConfigSchema:
    """A set of typed fields, keyed by namespaced name (e.g. ``agc.enabled``)."""

    def __init__(self, fields: list[ConfigField] | None = None) -> None:
        self._fields: dict[str, ConfigField] = {}
        for f in fields or []:
            self.add(f)

    def add(self, f: ConfigField) -> None:
        self._fields[f.name] = f

    def merge(self, other: "ConfigSchema") -> "ConfigSchema":
        out = ConfigSchema(list(self._fields.values()))
        for f in other._fields.values():
            out.add(f)
        return out

    def __contains__(self, name: str) -> bool:
        return name in self._fields

    def __getitem__(self, name: str) -> ConfigField:
        return self._fields[name]

    def __iter__(self) -> Iterator[ConfigField]:
        return iter(self._fields.values())

    def instantiate(self) -> "Config":
        return Config(self)


class Config:
    """A typed key-value store validated against a :class:`ConfigSchema`.

    Mirrors `suscan_config_t` get/set semantics (reference
    Suscan/Config.cpp): unknown keys raise, values are coerced to the
    field type, and `asDict`/JSON round-trips replace suscan's XML
    serialization (reference Suscan/Object.cpp).
    """

    def __init__(self, schema: ConfigSchema, values: Mapping[str, Any] | None = None):
        self._schema = schema
        self._values: dict[str, Any] = {f.name: f.default for f in schema}
        for k, v in (values or {}).items():
            self.set(k, v)

    @property
    def schema(self) -> ConfigSchema:
        return self._schema

    def get(self, name: str) -> Any:
        if name not in self._schema:
            raise KeyError(f"unknown config key: {name!r}")
        return self._values[name]

    def set(self, name: str, value: Any) -> None:
        if name not in self._schema:
            raise KeyError(f"unknown config key: {name!r}")
        f = self._schema[name]
        if f.type is bool and not isinstance(value, bool):
            if isinstance(value, str):
                value = value.lower() in ("1", "true", "yes", "on")
            else:
                value = bool(value)
        elif f.type is int and not isinstance(value, int):
            value = int(value)
        elif f.type is float:
            value = float(value)
        elif f.type is str:
            value = str(value)
        self._values[name] = value

    def update(self, values: Mapping[str, Any]) -> None:
        for k, v in values.items():
            self.set(k, v)

    def as_dict(self) -> dict[str, Any]:
        return dict(self._values)

    def to_json(self) -> str:
        return json.dumps(self._values, sort_keys=True)

    @classmethod
    def from_json(cls, schema: ConfigSchema, text: str) -> "Config":
        return cls(schema, json.loads(text))

    def copy(self) -> "Config":
        return Config(self._schema, self._values)

    def __getitem__(self, name: str) -> Any:
        return self.get(name)

    def __setitem__(self, name: str, value: Any) -> None:
        self.set(name, value)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Config) and other._values == self._values

    def __repr__(self) -> str:
        return f"Config({self._values!r})"


# ---------------------------------------------------------------------------
# The suscan inspector config-key contract (SURVEY.md §5.6).
# Defaults follow the reference panels (Default/GenericInspector/InspectorCtl).
# ---------------------------------------------------------------------------

GAIN_CONTROL_SCHEMA = ConfigSchema([
    # GainControl.cpp: manual gain vs AGC with time constant
    ConfigField("agc.enabled", bool, True, "automatic gain control on"),
    ConfigField("agc.gain", float, 1.0, "manual gain when AGC off"),
    ConfigField("agc.ts", float, 100.0, "AGC time scale (symbol periods)"),
])

AFC_SCHEMA = ConfigSchema([
    # AfcControl.cpp: carrier recovery (Costas order = 2^bits-per-symbol)
    ConfigField("afc.bits-per-symbol", int, 1, "costas order = 1<<bps"),
    ConfigField("afc.costas-order", int, 0, "explicit costas order (0=auto)"),
    ConfigField("afc.loop-bw", float, 0.01, "loop bandwidth, fraction of rate"),
    ConfigField("afc.offset", float, 0.0, "manual carrier offset (Hz)"),
])

ASK_SCHEMA = ConfigSchema([
    # AskControl.cpp
    ConfigField("ask.bits-per-symbol", int, 1, "amplitude levels = 1<<bps"),
    ConfigField("ask.channel", int, 0, "component: 0=amplitude"),
    ConfigField("ask.loop-bw", float, 0.01, "PLL loop bandwidth"),
    ConfigField("ask.offset", float, 0.0, "carrier offset (Hz)"),
    ConfigField("ask.use-pll", bool, True, "enable PLL carrier tracking"),
])

FSK_SCHEMA = ConfigSchema([
    # FskControl.cpp
    ConfigField("fsk.bits-per-symbol", int, 1, "tones = 1<<bps"),
    ConfigField("fsk.phase", float, 0.0, "demod phase offset"),
    ConfigField("fsk.quad-demod", bool, True, "use quadrature discriminator"),
])

CLOCK_SCHEMA = ConfigSchema([
    # ClockRecovery.cpp: type 0 = manual (fixed baud), 1 = Gardner
    ConfigField("clock.baud", float, 9600.0, "symbol rate (Hz)"),
    ConfigField("clock.gain", float, 1e-2, "Gardner loop gain"),
    ConfigField("clock.phase", float, 0.0, "initial sampling phase [0,1)"),
    ConfigField("clock.running", bool, True, "clock recovery enabled"),
    ConfigField("clock.type", int, 1, "0=manual interval, 1=Gardner"),
])

MF_SCHEMA = ConfigSchema([
    # MfControl.cpp: matched filter; type 0 = none, 1 = RRC
    ConfigField("mf.type", int, 1, "0=none, 1=root raised cosine"),
    ConfigField("mf.roll-off", float, 0.35, "RRC roll-off factor"),
])

EQUALIZER_SCHEMA = ConfigSchema([
    # EqualizerControl.cpp: CMA equalizer
    ConfigField("equalizer.type", int, 0, "0=disabled, 1=CMA"),
    ConfigField("equalizer.rate", float, 1e-3, "adaptation rate"),
    ConfigField("equalizer.locked", bool, False, "freeze adaptation"),
])

AUDIO_SCHEMA = ConfigSchema([
    # AudioProcessor.cpp:251-269 config push
    ConfigField("audio.cutoff", float, 15000.0, "audio LPF cutoff (Hz)"),
    ConfigField("audio.volume", float, 1.0, "linear output gain"),
    ConfigField("audio.sample-rate", int, 44100, "output rate (Hz)"),
    ConfigField("audio.demodulator", int, 1, "0=disabled,1=AM,2=FM,3=USB,4=LSB,5=RAW"),
    ConfigField("audio.squelch", bool, False, "squelch enabled"),
    ConfigField("audio.squelch-level", float, 0.0, "squelch threshold (power)"),
])

POWER_SCHEMA = ConfigSchema([
    # RMSInspector.cpp:40-80 integration config
    ConfigField("power.integrate-samples", int, 1, "samples per RMS point"),
])

# Inspector class name → config schema, as the engine registers them
# (reference class names at Default/Inspection/InspToolWidget.cpp:932-950).
PSK_INSPECTOR_SCHEMA = (
    GAIN_CONTROL_SCHEMA.merge(AFC_SCHEMA).merge(MF_SCHEMA)
    .merge(EQUALIZER_SCHEMA).merge(CLOCK_SCHEMA)
)
FSK_INSPECTOR_SCHEMA = (
    GAIN_CONTROL_SCHEMA.merge(FSK_SCHEMA).merge(MF_SCHEMA).merge(CLOCK_SCHEMA)
)
ASK_INSPECTOR_SCHEMA = (
    GAIN_CONTROL_SCHEMA.merge(ASK_SCHEMA).merge(MF_SCHEMA).merge(CLOCK_SCHEMA)
)
AUDIO_INSPECTOR_SCHEMA = GAIN_CONTROL_SCHEMA.merge(AUDIO_SCHEMA)
RAW_INSPECTOR_SCHEMA = GAIN_CONTROL_SCHEMA
POWER_INSPECTOR_SCHEMA = POWER_SCHEMA

INSPECTOR_SCHEMAS: dict[str, ConfigSchema] = {
    "psk": PSK_INSPECTOR_SCHEMA,
    "fsk": FSK_INSPECTOR_SCHEMA,
    "ask": ASK_INSPECTOR_SCHEMA,
    "audio": AUDIO_INSPECTOR_SCHEMA,
    "raw": RAW_INSPECTOR_SCHEMA,
    "power": POWER_INSPECTOR_SCHEMA,
}
