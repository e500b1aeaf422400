#!/usr/bin/env python3
"""Registers, shared memory and spills of every CUDA kernel of the PyTorch
port, as ``ptxas -v`` reports them.

    python3 tools/torch_ptxas_report.py [name ...]

Compiles each ``incubator_mxnet_tpu_torch/csrc/<name>.cu`` of
``ops/_build.SOURCES`` (or of the names given) to an object file (in a temporary directory, with
the package's own ``nvcc`` flags less ``-shared``) and prints one line per
kernel instantiation, and any warning of a performance loss (wgmma
serialized). Where ``cuobjdump`` is found (beside ``nvcc``, or on
PATH), each kernel's line also counts the tensor-core (``HGMMA``, from
``wgmma``) and TMA (``UTMALDG``) instructions of its SASS: nonzero counts
show a kernel runs on the tensor cores and loads through TMA. Needs
``nvcc``; no card.
"""

from __future__ import annotations

import pathlib
import re
import shutil
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
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit "
                           f"{out.returncode}):\n{out.stdout}{out.stderr}")
    rows, func = [], None
    for line in (out.stdout + out.stderr).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            func = m.group(1)
        if func and ("Used" in line or "spill" in line
                     or "Performance Loss" in line):
            rows.append((func, line.strip()))
    return rows


#: SASS instructions counted per kernel
SASS_OPS = ("HGMMA", "UTMALDG")


def cuobjdump_path():
    """``cuobjdump`` beside ``nvcc``, else on PATH, else None."""
    cand = pathlib.Path(_build.nvcc_path()).with_name("cuobjdump")
    if cand.is_file():
        return str(cand)
    return shutil.which("cuobjdump")


def sass_counts(obj: str, tool: str) -> dict:
    """{kernel: {op: count}} over the SASS of the object file ``obj``."""
    out = subprocess.run([tool, "-sass", obj], capture_output=True,
                         text=True, check=True).stdout
    counts, func = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func = m.group(1)
            counts[func] = dict.fromkeys(SASS_OPS, 0)
        elif func:
            for op in SASS_OPS:
                if re.search(rf"\b{op}\b", line):
                    counts[func][op] += 1
    return counts


def main(argv=None) -> int:
    names = sys.argv[1:] if argv is None else argv
    tool = cuobjdump_path()
    with tempfile.TemporaryDirectory() as tmp:
        for name in names or _build.SOURCES:
            rows = report(name, tmp)
            sass = sass_counts(f"{tmp}/{name}.o", tool) if tool else {}
            for func, line in rows:
                ops = sass.get(func)
                extra = "" if ops is None else " | SASS " + ", ".join(
                    f"{op} {n}" for op, n in ops.items())
                if "Used" in line:
                    line += extra
                print(f"{name}.cu {func}: {line}")
        if tool is None:
            print("cuobjdump not found: no SASS counts")
    return 0


if __name__ == "__main__":
    sys.exit(main())
