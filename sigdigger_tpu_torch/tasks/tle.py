"""TLE downloader task (counterpart of ``sigdigger_tpu/tasks/tle.py``).

reference Tasks/TLEDownloaderTask.cpp (libcurl fetch →
`Singleton::registerTLE`).  Uses urllib with a bounded timeout; in
air-gapped environments the fetch fails gracefully and `file://` paths
/ local files still work.
"""

from __future__ import annotations

import urllib.request

from sigdigger_tpu_torch.library import Library
from sigdigger_tpu_torch.tasks.base import CancellableTask


class TLEDownloaderTask(CancellableTask):
    def __init__(self, url: str, library: Library | None = None,
                 timeout: float = 15.0) -> None:
        super().__init__()
        self.url = url
        self.library = library
        self.timeout = timeout

    def work(self) -> bool:
        self.set_progress(0.1, f"fetching {self.url}")
        if "://" not in self.url or self.url.startswith("file://"):
            path = self.url.replace("file://", "")
            with open(path) as f:
                text = f.read()
        else:
            with urllib.request.urlopen(self.url,
                                        timeout=self.timeout) as r:
                text = r.read().decode("utf-8", errors="replace")
        lib = self.library or Library.instance()
        count = lib.register_tle(text)
        self.result = count
        self.set_progress(1.0, f"registered {count} TLEs")
        return False
