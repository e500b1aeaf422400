#!/usr/bin/env python3
"""The fp32 flash backward (K5 dq, K6 dk/dv of
``incubator_mxnet_tpu_torch/csrc/flash_bwd_f32.cu``) against the SIMT
kernels and SDPA, and against builds of the same source with other
compile-time choices, on the same inputs in one process; with
``--phases`` also the cycles per phase of the fp32 forward (K4 of
``csrc/flash_fwd_f32.cu``).

    python3 tools/torch_flash_f32_times.py [--variant NAME=FLAGS ...]
                                           [--cases head|all] [--phases]

Each ``--variant`` compiles the source again with the package's own
``nvcc`` flags plus ``FLAGS`` (space-separated, e.g.
``regs128=-maxrregcount=128``; a first flag ending in ``.cu`` names
another copy of the source, e.g. ``old=build/flash_bwd_f32.cu`` with its
headers beside it) into a temporary directory and runs its entry points
in place of the package's library. At each fp32 case of
``chip_smoke.BWD_CASES`` (``head``: the GPT training shape only) every
build is held against the plain version (1e-4 of max|plain|) and timed
(CUDA-graph replay, ``chip_smoke.device_ms``) in turns, the package's
build first and last (base, variants, variants reversed, base), beside
the SIMT kernels, SDPA's whole backward (boolean mask and, where it
agrees, ``is_causal``) and the operations bound.

``--phases`` also builds an instrumented copy of the package's source in
which thread 0 of every block reads ``clock64()`` at the phase boundaries
of its loop, and prints the mean cycles per block of each phase at each
case: ``setup`` (offsets, row statistics), ``wait_first`` (the first
stage and the tiles loaded once), per tile ``fetch`` (the next stage's
loads), ``scores`` (S and dP), ``softmax`` (p and dS into shared memory,
and the barrier after), ``products`` (dQ, or dV and dK), ``wait`` (the
next stage and the barrier after), and ``tail`` (the epilogue). The forward's copy
(``flash_fwd_f32.cu``, launched by name on the same q, k, v with the
lse) has the same phases: ``scores`` is S = Q.K^T, ``softmax`` the row
max, the exponentials and P into shared memory (to the ``__syncwarp``),
``products`` the rescale and O += P.V; its line also gives the forward's
time beside the SIMT kernel's. Needs ``nvcc`` and a card.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from incubator_mxnet_tpu_torch.ops import _build  # noqa: E402
from incubator_mxnet_tpu_torch.ops import flash_attention as fa  # noqa: E402


def build_variant(name: str, flags: list, tmp: str):
    """(dq, dkv) entry points of flash_bwd_f32.cu built with ``flags``; a
    first flag ending in ``.cu`` names another copy of the source (its
    headers beside it), relative to the repository's root."""
    src = _build.CSRC / "flash_bwd_f32.cu"
    if flags and flags[0].endswith(".cu"):
        src, flags = ROOT / flags[0], flags[1:]
    out = f"{tmp}/libflash_bwd_f32_{name}.so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-Xptxas", "-v",
           "-o", out, str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {name}:\n"
                           f"{res.stdout}{res.stderr}")
    for line in (res.stdout + res.stderr).splitlines():   # ptxas -v
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print(f"variant {name}: {line.strip()}", flush=True)
    lib = ctypes.CDLL(out)
    p, i = ctypes.c_void_p, ctypes.c_int
    tail = [i, i, i, i, i, ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_float, i, i, p]
    dq, dkv = lib.mxtpu_flash_bwd_dq_f32, lib.mxtpu_flash_bwd_dkv_f32
    dq.argtypes = [p] * 8 + tail
    dkv.argtypes = [p] * 9 + tail
    dq.restype = dkv.restype = i
    return dq, dkv


PHASES = ("setup", "wait_first", "fetch", "scores", "softmax", "products",
          "wait", "tail")

_PROBES = r'''
__device__ unsigned long long g_phase[2][10];
#define TSTART long long t_last = clock64(); long long t_acc[8] = {}; \
    int t_tiles = 0;
#define TMARK(i) do { long long t_now = clock64(); \
    t_acc[i] += t_now - t_last; t_last = t_now; } while (0)
#define TFLUSH(k) do { for (int q = 0; q < 8; ++q) \
    atomicAdd(&g_phase[k][q], (unsigned long long)t_acc[q]); \
    atomicAdd(&g_phase[k][8], 1ull); \
    atomicAdd(&g_phase[k][9], (unsigned long long)t_tiles); } while (0)
'''

_READERS = r'''
extern "C" int phase_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
}
extern "C" int phase_reset() {
  unsigned long long z[20] = {0};
  return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(g_phase));
}
'''


def _sub(text, old, new):
    if old not in text:
        raise RuntimeError(f"the kernel source changed: no {old.strip()!r}")
    return text.replace(old, new, 1)


def instrumented_source() -> str:
    """flash_bwd_f32.cu with the phase probes in both kernels (slot 0: dq,
    1: dk/dv)."""
    src = (_build.CSRC / "flash_bwd_f32.cu").read_text()
    src = _sub(src, '#include "flash_tc.cuh"',
               '#include "flash_tc.cuh"\n' + _PROBES)
    i5 = src.index("flash_bwd_dq_f32_kernel(")
    i6 = src.index("flash_bwd_dkv_f32_kernel(")
    i7 = src.index("// host: launches")
    bodies = []
    for slot, body, scores, sync, prod, end in (
            (0, src[i5:i6], "    scores<D>(qs, kt, gs, vt, oa, ob, s, dp);\n",
             "    __syncthreads();  // dS complete\n",
             "    products<D, false>(dss, kt, nullptr, nullptr, oa, xl, acc, "
             "unused);\n", "sdq.t, ra, Tq - q0, (D / 8) * wc + lx);\n"),
            (1, src[i6:i7], "    scores<D>(ks, qt, vs, gt, oa, ob, s, dp);\n",
             "    __syncthreads();  // P^T and dS^T complete\n",
             "    products<D, true>(pts, gt, dts, qt, oa, xl, dva, dka);\n",
             "sdv.t, ra, (int)rows, cb);\n")):
        tid = ("  const int tid = threadIdx.x, warp = tid >> 5, lane = tid "
               "& 31;\n")
        body = _sub(body, tid, tid + "  TSTART\n")
        first = "  if (ntiles > 0) {\n    fetch(0, std::true_type{});\n" \
            "    wait(0);\n  }\n"
        body = _sub(body, first, "  TMARK(0);\n" + first + "  TMARK(1);\n")
        nxt = "      fetch(it + 1, std::false_type{});\n"
        body = _sub(body, nxt, nxt + "    TMARK(2);\n")
        body = _sub(body, scores, scores + "    TMARK(3);\n")
        body = _sub(body, sync, sync + "    TMARK(4);\n")
        body = _sub(body, prod, prod + "    TMARK(5);\n")
        wait = "    if (it + 1 < ntiles) wait(it + 1);"
        i = body.index(wait)
        j = body.index("\n", i) + 1
        body = body[:j] + "    TMARK(6);\n    ++t_tiles;\n" + body[j:]
        body = _sub(body, end, end + "  TMARK(7);\n  if (tid == 0) "
                    f"TFLUSH({slot});\n")
        bodies.append(body)
    return src[:i5] + bodies[0] + bodies[1] + src[i7:] + _READERS


def instrumented_fwd_source() -> str:
    """flash_fwd_f32.cu with the phase probes in its kernel (slot 0)."""
    src = (_build.CSRC / "flash_fwd_f32.cu").read_text()
    src = _sub(src, '#include "flash_tc.cuh"',
               '#include "flash_tc.cuh"\n' + _PROBES)
    tid = "  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n"
    src = _sub(src, tid, tid + "  TSTART\n")
    first = "  if (ntiles > 0) {\n    fetch(0, std::true_type{});\n" \
        "    wait(0);\n  }\n"
    src = _sub(src, first, "  TMARK(0);\n" + first + "  TMARK(1);\n")
    nxt = "      fetch(it + 1, std::false_type{});\n"
    src = _sub(src, nxt, nxt + "    TMARK(2);\n")
    soft = "    // the online softmax in registers;"
    src = _sub(src, soft, "    TMARK(3);\n" + soft)
    sync = "    __syncwarp();  // the warp's P rows complete\n"
    src = _sub(src, sync, sync + "    TMARK(4);\n")
    nxt_wait = "    // the next stage has landed, and every warp is done"
    src = _sub(src, nxt_wait, "    TMARK(5);\n" + nxt_wait)
    wait = "    if (it + 1 < ntiles) wait(it + 1);\n"
    src = _sub(src, wait, wait + "    TMARK(6);\n    ++t_tiles;\n")
    end = "          l > 0.f ? (mrow[i] + log2f(l)) * kLn2 : -INFINITY;\n  }\n"
    src = _sub(src, end, end + "  TMARK(7);\n  if (tid == 0) TFLUSH(0);\n")
    return src + _READERS


def _compile(tmp: str, name: str, text: str):
    cu, so = f"{tmp}/{name}.cu", f"{tmp}/{name}.so"
    pathlib.Path(cu).write_text(text)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", so, cu], check=True)
    return ctypes.CDLL(so)


def build_phases(tmp: str):
    """The instrumented libraries (backward, forward), their entry points
    typed like the package's."""
    lib = _compile(tmp, "flash_bwd_f32_phases", instrumented_source())
    base = fa._bwd_kernels("f32")
    fns = (lib.mxtpu_flash_bwd_dq_f32, lib.mxtpu_flash_bwd_dkv_f32)
    for fn, ref in zip(fns, base):
        fn.argtypes, fn.restype = ref.argtypes, ref.restype
    flib = _compile(tmp, "flash_fwd_f32_phases", instrumented_fwd_source())
    fwd, ref = flib.mxtpu_flash_fwd_f32, fa._fwd_kernel("f32")
    fwd.argtypes, fwd.restype = ref.argtypes, ref.restype
    return lib, fns, flib, fwd


def _print_row(case, label, vals):
    blocks = max(1, vals[8])
    print(f"{case} fp32 {label} phases: {vals[8]} blocks, "
          f"{vals[9] / blocks:.2f} tiles per block; mean cycles per "
          "block " + ", ".join(f"{ph}={vals[i] / blocks:.0f}"
                               for i, ph in enumerate(PHASES)), flush=True)


def print_fwd_phases(flib, fwd, case, q, k, v, lens, kw):
    """One launch of the instrumented forward, then the forward's f32 and
    SIMT times on the same inputs."""
    buf = (ctypes.c_ulonglong * 20)()
    saved = fa._fwd_fns["f32"]
    fa._fwd_fns["f32"] = fwd
    try:
        fa.flash_attention(q, k, v, lens, route="f32", return_lse=True, **kw)
        torch.cuda.synchronize()
        flib.phase_reset()
        fa.flash_attention(q, k, v, lens, route="f32", return_lse=True, **kw)
        torch.cuda.synchronize()
        flib.phase_read(buf)
        _print_row(case, "fwd", list(buf)[:10])
    finally:
        fa._fwd_fns["f32"] = saved
    times = {r: cs.device_ms(lambda: fa.flash_attention(
        q, k, v, lens, route=r, return_lse=True, **kw))
        for r in ("f32", "simt")}
    print(f"{case} fp32 fwd: f32 {times['f32']:.5f} ms; simt "
          f"{times['simt']:.5f}", flush=True)


def print_phases(lib, fns, case, call, kw):
    """One launch of each instrumented kernel on ``call``: mean cycles per
    block and phase."""
    buf = (ctypes.c_ulonglong * 20)()
    saved = fa._bwd_fns["f32"]
    fa._bwd_fns["f32"] = fns
    try:
        for slot, label, run in ((0, "dq", fa.flash_bwd_dq),
                                 (1, "dkv", fa.flash_bwd_dkv)):
            run(*call, route="f32", **kw)
            torch.cuda.synchronize()
            lib.phase_reset()
            run(*call, route="f32", **kw)
            torch.cuda.synchronize()
            lib.phase_read(buf)
            _print_row(case, label, list(buf)[10 * slot:10 * slot + 10])
    finally:
        fa._bwd_fns["f32"] = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=FLAGS: another build of the source")
    ap.add_argument("--cases", choices=("head", "all"), default="head")
    ap.add_argument("--phases", action="store_true",
                    help="also the cycles per phase (clock64)")
    args = ap.parse_args(argv)
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    builds = {"base": fa._bwd_kernels("f32")}
    with tempfile.TemporaryDirectory() as tmp:
        for spec in args.variant:
            name, _, flags = spec.partition("=")
            builds[name] = build_variant(name, flags.split(), tmp)
        phases = build_phases(tmp) if args.phases else None
        names = list(builds)
        order = names + names[::-1]
        cases = [c for c in cs.BWD_CASES
                 if args.cases == "all" or c[0] == cs.BWD_HEAD]
        rs = np.random.RandomState(7)
        h = 12
        for case, b, tq, tk, d, causal, cache_offset, lengths in cases:
            if d not in (64, 128):
                continue
            q, k, v, g = (torch.from_numpy(rs.randn(b, h, t, d).astype(
                np.float32)).to(dev) for t in (tq, tk, tk, tq))
            lens = None if lengths is None else \
                torch.tensor(lengths, dtype=torch.int32, device=dev)
            kw = dict(causal=causal, cache_offset=cache_offset)
            out, lse = fa.flash_attention(q, k, v, lens, return_lse=True,
                                          **kw)
            delta = (g * out).sum(-1)
            call = (q, k, v, lens, lse, delta, g)
            want = fa.flash_attention_bwd_reference(*call, **kw)
            valid = cs._valid_mask(b, tq, tk, lens, causal, cache_offset,
                                   dev)
            times = {n: {"dq": [], "dkv": []} for n in names}
            for n in names:
                fa._bwd_fns["f32"] = builds[n]
                cs._bwd_errs(f"{case} {n}", fa.flash_attention_bwd(
                    *call, route="f32", **kw), want, valid, 1e-4)
            for n in order:
                fa._bwd_fns["f32"] = builds[n]
                times[n]["dq"].append(cs.device_ms(
                    lambda: fa.flash_bwd_dq(*call, route="f32", **kw)))
                times[n]["dkv"].append(cs.device_ms(
                    lambda: fa.flash_bwd_dkv(*call, route="f32", **kw)))
            fa._bwd_fns["f32"] = builds["base"]
            if phases is not None:
                print_phases(*phases[:2], case, call, kw)
                print_fwd_phases(*phases[2:], case, q, k, v, lens, kw)
            simt = {kernel: cs.device_ms(
                lambda: launch(*call, route="simt", **kw))
                for kernel, launch in (("dq", fa.flash_bwd_dq),
                                       ("dkv", fa.flash_bwd_dkv))}
            sdpa = cs._sdpa_bwd_ms(q, k, v, g, valid)
            sdpa_causal = cs._sdpa_bwd_ms(q, k, v, g, valid, causal=True) \
                if causal and lens is None and tq == tk else None
            for kernel in ("dq", "dkv"):
                bound, by = cs.attention_bwd_bound(kernel, b, h, tq, tk, d,
                                                   torch.float32, valid)
                runs = "; ".join(
                    f"{n} " + " ".join(f"{t:.5f}" for t in times[n][kernel])
                    for n in names)
                print(f"{case} fp32 {kernel}: {runs} ms; simt "
                      f"{simt[kernel]:.5f}; bound {bound:.5f} ({by})",
                      flush=True)
            total = {n: min(times[n]["dq"]) + min(times[n]["dkv"])
                     for n in names}
            print(f"{case} fp32 dq + dkv (best of each): " + ", ".join(
                f"{n} {t:.5f}" for n, t in total.items())
                + f" ms; simt {simt['dq'] + simt['dkv']:.5f}; SDPA whole "
                f"backward {sdpa:.5f} (mask)" + (
                    "" if sdpa_causal is None else
                    f", {sdpa_causal:.5f} (is_causal)"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
