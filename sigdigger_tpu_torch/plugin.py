"""Plugin + feature-factory framework (counterpart of
``sigdigger_tpu/plugin.py``): a plugin registers into the port's
sources, inspectors, audio players and device facade.

The reference loads `.so` plugins at startup which register feature
factories with the Singleton (reference include/Suscan/PluginSupport.h:
46-80; factory families at include/Suscan/Library.h:405-436; the
default plugin registers at Default/Registration.cpp:38-68).  The
Python-native equivalent: plugins are modules (or files in a plugin
directory) exposing ``plugin_entry(registry)``, and the factory families
map to the extension points a headless analyzer actually has:

- source types        (``register_source``)
- inspector classes   (``register_inspector``)
- audio players       (``register_player``)
- device discoverers  (``register_discoverer``)
- task types          (named CancellableTask constructors)
- tool commands       (CLI subcommand factories)
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import sys
from dataclasses import dataclass
from typing import Any, Callable


@dataclass
class PluginInfo:
    name: str
    version: str = "0.0"
    description: str = ""
    path: str = ""
    error: str | None = None
    loaded: bool = False


class PluginRegistry:
    """Registration surface handed to `plugin_entry` — mirrors the
    factory families the reference Singleton owns."""

    def __init__(self) -> None:
        self.tools: dict[str, Callable[..., Any]] = {}
        self.tasks: dict[str, Callable[..., Any]] = {}
        self._factories: dict[str, dict[str, Any]] = {}

    # the five-ish factory families
    def register_source(self, type_name: str, ctor) -> None:
        from sigdigger_tpu_torch.sources import register_source

        register_source(type_name, ctor)

    def register_inspector(self, cls) -> None:
        from sigdigger_tpu_torch.inspectors import register_inspector

        register_inspector(cls)

    def register_player(self, name: str, ctor) -> None:
        from sigdigger_tpu_torch.audio.playback import register_player

        register_player(name, ctor)

    def register_discoverer(self, fn) -> None:
        from sigdigger_tpu_torch.device import DeviceFacade

        DeviceFacade.instance().register_discoverer(fn)

    def register_task(self, name: str, ctor) -> None:
        self.tasks[name] = ctor

    def register_tool(self, name: str, fn) -> None:
        self.tools[name] = fn

    def register_factory(self, family: str, name: str, obj: Any) -> None:
        """Generic factory table for families this core doesn't know."""
        self._factories.setdefault(family, {})[name] = obj

    def factories(self, family: str) -> dict[str, Any]:
        return dict(self._factories.get(family, {}))


class PluginLoader:
    """Loads plugins from module names and plugin directories."""

    def __init__(self, registry: PluginRegistry | None = None) -> None:
        self.registry = registry or PluginRegistry()
        self.plugins: list[PluginInfo] = []

    def load_module(self, module_name: str) -> PluginInfo:
        info = PluginInfo(name=module_name)
        try:
            mod = importlib.import_module(module_name)
            self._enter(mod, info)
        except Exception as e:  # noqa: BLE001 — a bad plugin must not
            info.error = str(e)  # kill startup (reference behavior)
        self.plugins.append(info)
        return info

    def load_file(self, path: str) -> PluginInfo:
        name = os.path.splitext(os.path.basename(path))[0]
        info = PluginInfo(name=name, path=path)
        try:
            spec = importlib.util.spec_from_file_location(
                f"sigdigger_plugin_{name}", path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[spec.name] = mod
            spec.loader.exec_module(mod)
            self._enter(mod, info)
        except Exception as e:  # noqa: BLE001
            info.error = str(e)
        self.plugins.append(info)
        return info

    def load_directory(self, path: str) -> list[PluginInfo]:
        """Load every ``*.py`` in a plugin dir (≙ dlopen of *.so at
        reference App/Loader.cpp init_plugins)."""
        out = []
        if not os.path.isdir(path):
            return out
        for fn in sorted(os.listdir(path)):
            if fn.endswith(".py") and not fn.startswith("_"):
                out.append(self.load_file(os.path.join(path, fn)))
        return out

    def _enter(self, mod, info: PluginInfo) -> None:
        entry = getattr(mod, "plugin_entry", None)
        if entry is None:
            raise AttributeError("plugin has no plugin_entry(registry)")
        entry(self.registry)
        info.version = getattr(mod, "PLUGIN_VERSION", "0.0")
        info.description = getattr(mod, "PLUGIN_DESCRIPTION", "")
        info.loaded = True
