#!/usr/bin/env python3
"""Where K7's redesigned ``softmax_ce_fwd`` and ``scale`` spend their time.

    python3 tools/torch_rtc_designs.py [--seed 0]

Needs a card. Prints one line per measurement and one JSON line:

* ``softmax_ce_fwd`` at (2048, 50257), resident rows: the kernel of
  ``csrc/rtc/softmax_ce.cu`` compiled with thread 0 of each block stamping
  ``%globaltimer`` at the end of each phase (set-up and the partial quads;
  the bulk copies and the max; the max's reduction; the exponentials and
  their sum; the write pass), the mean microseconds of each phase over the
  blocks, and the probe's device time (stamps included), with ``req`` 1
  (write) and 2 (add).
* ``scale`` over 163,037,184 floats, the kernel of ``csrc/rtc/scale.cu``
  as ``scale_plan`` launches it (one 1024-float tile a block) and on a
  grid of one wave of resident blocks (8 blocks of 256 threads a SM, the
  kernel's grid-stride loop walking the rest), beside ``torch.mul``; and
  over a view at an offset of one float into a new array (x and y at two
  alignment phases), beside ``torch.mul`` on the view.
* the registers and local-memory (spill) bytes a thread of the compiled
  ``softmax_ce_fwd<float>`` and ``scale``.

Device times as ``chip_smoke.device_ms`` takes them (CUDA-graph replay).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

PHASES = ("setup", "copies_and_max", "max_reduce", "exp_and_sum", "write")
STAMP = r'''
__device__ __forceinline__ unsigned long long phase_timer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(k) \
  if (clk && threadIdx.x == 0) clk[(long long)blockIdx.x * 6 + (k)] = \
      phase_timer();
'''
PROBE = r'''
extern "C" __global__ void __launch_bounds__(1024)
probe(const float *x, float *y, int row_size, int req,
      unsigned long long *clk) {
  __shared__ float slots[32];
  __shared__ unsigned long long bars[ROW_CHUNKS];
  extern __shared__ __align__(16) float4 row4[];
  softmax_resident(x + (long long)blockIdx.x * row_size,
                   y + (long long)blockIdx.x * row_size, row_size, req,
                   slots, bars, row4, clk);
}
'''


def _once(text, old, new):
    if text.count(old) != 1:
        raise RuntimeError(f"softmax_ce.cu changed: {old!r} is not there "
                           "once; update the probe's anchors")
    return text.replace(old, new)


def probe_source():
    """softmax_ce.cu with phase stamps in its resident branch and a
    ``probe`` kernel that runs that branch alone."""
    src = (ROOT / "incubator_mxnet_tpu_torch" / "csrc" / "rtc"
           / "softmax_ce.cu").read_text()
    src = _once(src, "float4 *row4) {", "float4 *row4,\n"
                "unsigned long long *clk) {\n  STAMP(0)")
    src = _once(src, "  __syncthreads();                         // barriers"
                " and end quads ready\n",
                "  __syncthreads();\n  STAMP(1)\n")
    src = _once(src, "  m = block_reduce<true>(m, slots);\n",
                "  STAMP(2)\n  m = block_reduce<true>(m, slots);\n"
                "  STAMP(3)\n")
    src = _once(src, "  const float r = 1.f / block_reduce<false>(s, slots);"
                "\n  if (phase_of(yr) == px) {",
                "  const float r = 1.f / block_reduce<false>(s, slots);\n"
                "  STAMP(4)\n  if (phase_of(yr) == px) {")
    src = _once(src, "    for (int i = tid; i < n; i += nt) put(yr + i, "
                "row[i + px] * r, req);\n  }\n}\n",
                "    for (int i = tid; i < n; i += nt) put(yr + i, "
                "row[i + px] * r, req);\n  }\n  STAMP(5)\n}\n")
    src = _once(src, "slots, bars, row4);", "slots, bars, row4, nullptr);")
    return STAMP + src + PROBE


def registers(kernel, device_index=0):
    """(registers a thread, local-memory bytes a thread: spills) of an
    ``mx.rtc`` kernel loaded on the device (``cuFuncGetAttribute``)."""
    import ctypes

    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuFuncGetAttribute.argtypes = [ctypes.POINTER(ctypes.c_int),
                                       ctypes.c_int, ctypes.c_void_p]
    fn = kernel._functions[device_index]
    out = []
    for attr in (4, 3):        # CU_FUNC_ATTRIBUTE_NUM_REGS, LOCAL_SIZE_BYTES
        v = ctypes.c_int()
        if lib.cuFuncGetAttribute(ctypes.byref(v), attr, fn) != 0:
            raise RuntimeError("cuFuncGetAttribute failed")
        out.append(v.value)
    return tuple(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_rtc_designs: no CUDA device", file=sys.stderr)
        return 2
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.ndarray import NDArray
    from incubator_mxnet_tpu_torch.ops import rtc_kernels as rk

    dev, ctx = torch.device("cuda", 0), mx.gpu(0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    out = {"card": cs.card_line(), "softmax_ce_fwd": {}, "scale": {}}
    print(out["card"], flush=True)

    n_rows, vocab = 2048, 50257
    x = NDArray(4 * torch.randn(n_rows, vocab, generator=gen, device=dev))
    y = NDArray(torch.zeros(n_rows, vocab, device=dev))
    y0 = torch.rand(n_rows, vocab, generator=gen, device=dev)
    want = rk.softmax_ce_fwd_reference(x.as_torch())
    plan = rk.softmax_ce_fwd_plan(vocab, rk.smem_optin(dev))
    clk = NDArray(torch.zeros(n_rows * 6, dtype=torch.int64, device=dev))
    module = mx.rtc.CudaModule(probe_source())
    k = module.get_kernel("probe", "const float *x, float *y, "
                          "int row_size, int req, int64_t *clk")
    for req in (1, 2):
        def launch(c=None, req=req):
            k.launch([x, y, vocab, req, c if c is not None else clk],
                     ctx, (n_rows, 1, 1), (plan.threads, 1, 1),
                     shared_mem=plan.shared_bytes)
        y.as_torch().copy_(y0)
        launch()
        torch.cuda.synchronize()
        ref = want if req == 1 else y0 + want
        rel = cs._max_rel_err(y.as_torch(), ref)
        if rel > cs.RTC_FWD_RTOL:
            raise AssertionError(f"probe req {req}: {rel}")
        t = clk.as_torch().view(n_rows, 6).cpu().numpy()
        phases = np.diff(t, axis=1).mean(0) / 1e3
        ms = cs.device_ms(launch)
        row = dict(ms=ms, block_us=float((t[:, 5] - t[:, 0]).mean()
                                         / 1e3),
                   phases_us=dict(zip(PHASES, map(float, phases))))
        out["softmax_ce_fwd"][f"req{req}"] = row
        print(f"softmax_ce_fwd ({n_rows}, {vocab}) req {req}: "
              f"{ms:.5f} ms; a block {row['block_us']:.2f} us: "
              + ", ".join(f"{p} {v:.2f}" for p, v in zip(PHASES, phases)),
              flush=True)
    del x, y, y0, want, clk

    n = 163_037_184
    buf = torch.randn(n + 1, generator=gen, device=dev)
    x, y = NDArray(buf[:n]), NDArray(torch.empty(n, device=dev))
    k = rk.kernel("scale")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan_grid, block = rk.scale_plan(n)
    for label, grid in (("one_tile_a_block", plan_grid),
                        ("one_wave", (sms * 8, 1, 1))):
        def launch(grid=grid):
            k.launch([x, y, 0.5, n], ctx, grid, block)
        launch()
        torch.cuda.synchronize()
        if not torch.equal(y.as_torch(), x.as_torch() * 0.5):
            raise AssertionError(f"scale {label} differs from x * 0.5")
        out["scale"][label] = dict(grid=grid[0], ms=cs.device_ms(launch))
    out["scale"]["torch_mul"] = cs.device_ms(lambda: torch.mul(x.as_torch(),
                                                               0.5))
    xv = NDArray(buf[1:n])
    out["scale"]["view1_new_out"] = cs.device_ms(lambda: rk.scale(xv, 0.5))
    out["scale"]["view1_torch_mul"] = cs.device_ms(
        lambda: torch.mul(xv.as_torch(), 0.5))
    rk.softmax_ce_fwd(NDArray(buf[:8].view(2, 4)), NDArray(
        torch.empty(2, 4, device=dev)))               # loads the kernel
    for name in ("softmax_ce_fwd", "scale"):
        regs, local = registers(rk.kernel(name))
        out[f"{name}_registers"] = dict(registers=regs, local_bytes=local)
        print(f"{rk.KERNELS[name].lookup}: {regs} registers a thread, "
              f"{local} bytes of local memory (spills)", flush=True)
    print("scale (163037184): " + ", ".join(
        f"{k} {v['ms']:.5f} ms ({v['grid']} blocks)" if isinstance(v, dict)
        else f"{k} {v:.5f} ms" for k, v in out["scale"].items()), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
