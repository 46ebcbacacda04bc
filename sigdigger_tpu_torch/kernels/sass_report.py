"""What nvcc made of a kernel source: registers, stack frame and spills
(``-Xptxas -v``), the SASS instructions that touch local memory and the
tensor-core ``HGMMA`` instructions, per kernel.

    python -m sigdigger_tpu_torch.kernels.sass_report csrc/recovery.cu ...

Each source compiles with the port's flags (``_build.NVCC_FLAGS`` and the
file's ``EXTRA_FLAGS``) into a cubin in a temporary directory; each
kernel's line gives its registers, stack frame and spill bytes, and the
counts of ``LDL``/``STL`` (local loads and stores), of ``HGMMA``
(warpgroup tensor-core products) and of all instructions in its SASS
(``cuobjdump -sass``).  A kernel whose loop keeps an array in local
memory shows a stack frame and ``LDL``/``STL`` there; a tensor-core
stage shows its ``HGMMA`` count.  Needs ``nvcc`` and ``cuobjdump``.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile

from sigdigger_tpu_torch.kernels import _build


def _tool(name: str) -> str:
    return os.path.join(os.path.dirname(_build.nvcc_path()), name)


def report(src: str) -> list[dict]:
    """One dict per kernel of ``src``: name, registers, stack, spill
    stores and loads (bytes), LDL, STL and HGMMA counts and SASS
    length."""
    stem = os.path.basename(src)[:-3]
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared",)]
    flags = [f for f in flags if f not in ("-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, f"{stem}.cubin")
        built = subprocess.run(
            [_build.nvcc_path(), *flags, *_build.EXTRA_FLAGS.get(stem, []),
             "-cubin", "-I", os.path.dirname(os.path.abspath(src)), "-o",
             cubin, src], capture_output=True, text=True, check=True)
        sass = subprocess.run([_tool("cuobjdump"), "-sass", cubin],
                              capture_output=True, text=True,
                              check=True).stdout
    kernels: dict[str, dict] = {}
    name = None
    for line in (built.stdout + built.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            kernels[name] = {"kernel": name}
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            kernels[name].update(stack=int(m.group(1)),
                                 spill_st=int(m.group(2)),
                                 spill_ld=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            kernels[name]["registers"] = int(m.group(1))
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels.setdefault(name, {"kernel": name}).update(
                ldl=0, stl=0, hgmma=0, instructions=0)
            continue
        if name and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            k = kernels[name]
            k["instructions"] += 1
            k["ldl"] += bool(re.search(r"\bLDL\b", line))
            k["stl"] += bool(re.search(r"\bSTL\b", line))
            k["hgmma"] += bool(re.search(r"\bHGMMA\b", line))
    return list(kernels.values())


def main(argv: list[str]) -> int:
    for src in argv:
        for k in report(src):
            print(f"{os.path.basename(src)} {k}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
