#!/usr/bin/env python3
"""Registers, shared memory and spills of every CUDA kernel of the PyTorch
port, as ``ptxas -v`` reports them.

    python3 tools/torch_ptxas_report.py

Compiles each ``incubator_mxnet_tpu_torch/csrc/<name>.cu`` of
``ops/_build.SOURCES`` to an object file (in a temporary directory, with
the package's own ``nvcc`` flags less ``-shared``) and prints one line per
kernel instantiation. Needs ``nvcc``; no card.
"""

from __future__ import annotations

import pathlib
import re
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from incubator_mxnet_tpu_torch.ops import _build  # noqa: E402


def report(name: str, tmp: str) -> list:
    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    cmd = [_build.nvcc_path(), *flags, "-Xptxas", "-v", "-c", "-o",
           f"{tmp}/{name}.o", str(_build.CSRC / f"{name}.cu")]
    out = subprocess.run(cmd, capture_output=True, text=True, check=True)
    rows, func = [], None
    for line in (out.stdout + out.stderr).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            func = m.group(1)
        if func and ("Used" in line or "spill" in line):
            rows.append((func, line.strip()))
    return rows


def main() -> int:
    with tempfile.TemporaryDirectory() as tmp:
        for name in _build.SOURCES:
            for func, line in report(name, tmp):
                print(f"{name}.cu {func}: {line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
