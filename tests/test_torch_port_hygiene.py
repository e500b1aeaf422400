"""Port hygiene: the PyTorch package stands alone.

It imports neither ``jax`` nor any module of the JAX package; its default
device is the card and never a silent CPU; on the CPU no CUDA kernel is
ever launched (their plain versions run instead), neither by serving nor
by training, for the GPT decoder and the fused ResNet alike.
"""

import ast
import math
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch.parallel import collect_params as tensors_of
from incubator_mxnet_tpu_torch import serving
from incubator_mxnet_tpu_torch.gluon.model_zoo import get_gpt, load_jax_params
from incubator_mxnet_tpu_torch.ops import flash_attention as fa
from incubator_mxnet_tpu_torch.ops import fused_conv as fc

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "incubator_mxnet_tpu_torch"


def test_import_pulls_in_no_jax_and_no_jax_package():
    code = ("import sys, incubator_mxnet_tpu_torch, "
            "incubator_mxnet_tpu_torch.serving, "
            "incubator_mxnet_tpu_torch.serving.server, "
            "incubator_mxnet_tpu_torch.serving.batcher, "
            "incubator_mxnet_tpu_torch.serving.executor_cache, "
            "incubator_mxnet_tpu_torch.serving.metrics, "
            "incubator_mxnet_tpu_torch.gluon.model_zoo.gpt, "
            "incubator_mxnet_tpu_torch.autograd, "
            "incubator_mxnet_tpu_torch.gluon.loss, "
            "incubator_mxnet_tpu_torch.gluon.trainer, "
            "incubator_mxnet_tpu_torch.lr_scheduler, "
            "incubator_mxnet_tpu_torch.optimizer, "
            "incubator_mxnet_tpu_torch.parallel.spmd, "
            "incubator_mxnet_tpu_torch.parallel.superstep, "
            "incubator_mxnet_tpu_torch.ops.launches, "
            "incubator_mxnet_tpu_torch.ops.fused_conv, "
            "incubator_mxnet_tpu_torch.gluon.model_zoo.vision.fused_resnet, "
            "incubator_mxnet_tpu_torch.gluon.model_zoo.vision.resnet, "
            "incubator_mxnet_tpu_torch.gluon.model_zoo.vision.alexnet, "
            "incubator_mxnet_tpu_torch.gluon.model_zoo.vision.vgg, "
            "incubator_mxnet_tpu_torch.gluon.model_zoo.vision.squeezenet, "
            "incubator_mxnet_tpu_torch.gluon.model_zoo.vision.densenet, "
            "incubator_mxnet_tpu_torch.gluon.model_zoo.vision.mobilenet, "
            "incubator_mxnet_tpu_torch.gluon.model_zoo.vision.inception, "
            "incubator_mxnet_tpu_torch.gluon.contrib.nn, "
            "incubator_mxnet_tpu_torch.gluon.utils, "
            "incubator_mxnet_tpu_torch.gluon.nn.basic_layers, "
            "incubator_mxnet_tpu_torch.gluon.nn.conv_layers, "
            "incubator_mxnet_tpu_torch.initializer, "
            "incubator_mxnet_tpu_torch.ops.nn, "
            "incubator_mxnet_tpu_torch.ops.misc, "
            "incubator_mxnet_tpu_torch.ops.more, "
            "incubator_mxnet_tpu_torch.ops.random_ops, "
            "incubator_mxnet_tpu_torch.ops.optimizer_ops, "
            "incubator_mxnet_tpu_torch.random, "
            "incubator_mxnet_tpu_torch.ndarray, "
            "incubator_mxnet_tpu_torch.operator, "
            "incubator_mxnet_tpu_torch.rtc, "
            "incubator_mxnet_tpu_torch.ops._nvrtc, "
            "incubator_mxnet_tpu_torch.ops.rtc_kernels, "
            "incubator_mxnet_tpu_torch.models, "
            "incubator_mxnet_tpu_torch.models.transformer, "
            "incubator_mxnet_tpu_torch.ops.numpy_ops, "
            "incubator_mxnet_tpu_torch.ops.fft_ops, "
            "incubator_mxnet_tpu_torch.ops.linalg, "
            "incubator_mxnet_tpu_torch.numpy, "
            "incubator_mxnet_tpu_torch.numpy.linalg, "
            "incubator_mxnet_tpu_torch.numpy.fft, "
            "incubator_mxnet_tpu_torch.numpy.random, "
            "incubator_mxnet_tpu_torch.numpy_extension, "
            "incubator_mxnet_tpu_torch.gluon.parameter, "
            "incubator_mxnet_tpu_torch.gluon.block, "
            "incubator_mxnet_tpu_torch.symbol, "
            "incubator_mxnet_tpu_torch.symbol.symbol, "
            "incubator_mxnet_tpu_torch.executor, "
            "incubator_mxnet_tpu_torch.contrib, "
            "incubator_mxnet_tpu_torch.contrib.control_flow, "
            "incubator_mxnet_tpu_torch.amp, "
            "incubator_mxnet_tpu_torch.amp.amp, "
            "incubator_mxnet_tpu_torch.amp.lists, "
            "incubator_mxnet_tpu_torch.amp.loss_scaler, "
            "incubator_mxnet_tpu_torch.ops.detection, "
            "incubator_mxnet_tpu_torch.models.ssd\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib')) "
            "or m == 'incubator_mxnet_tpu' "
            "or m.startswith('incubator_mxnet_tpu.'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def test_sources_import_no_jax_and_no_jax_package():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 10
    for name in ("ndarray/__init__.py", "ndarray/ndarray.py", "operator.py",
                 "rtc.py", "ops/_nvrtc.py", "ops/rtc_kernels.py",
                 "ops/registry.py", "ops/tensor.py", "ops/nn.py",
                 "ops/misc.py", "ops/more.py", "ops/random_ops.py",
                 "ops/optimizer_ops.py", "random.py",
                 "gluon/nn/conv_layers.py", "gluon/nn/basic_layers.py",
                 "gluon/model_zoo/vision/resnet.py", "initializer.py",
                 "parallel/superstep.py", "ops/launches.py",
                 "models/__init__.py", "models/transformer.py",
                 "serving/server.py", "serving/batcher.py",
                 "serving/executor_cache.py", "serving/metrics.py",
                 "serving/registry.py", "serving/artifacts.py",
                 "ops/numpy_ops.py", "ops/fft_ops.py", "ops/linalg.py",
                 "numpy/__init__.py", "numpy/linalg.py", "numpy/fft.py",
                 "numpy/random.py", "numpy_extension/__init__.py",
                 "ndarray/sparse.py", "gluon/nn/activations.py",
                 "gluon/loss.py", "optimizer/optimizer.py",
                 "gluon/trainer.py", "autograd.py", "gluon/utils.py",
                 "gluon/contrib/__init__.py", "gluon/contrib/nn.py",
                 "gluon/model_zoo/vision/_zoo.py",
                 "gluon/model_zoo/vision/alexnet.py",
                 "gluon/model_zoo/vision/vgg.py",
                 "gluon/model_zoo/vision/squeezenet.py",
                 "gluon/model_zoo/vision/densenet.py",
                 "gluon/model_zoo/vision/mobilenet.py",
                 "gluon/model_zoo/vision/inception.py"):
        assert PKG / name in files, name
    for f in files + [ROOT / "chip_smoke.py"]:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib"), f"{f}: imports {mod}"
            # mind the shared prefix: incubator_mxnet_tpu_torch is fine
            assert top != "incubator_mxnet_tpu", f"{f}: imports {mod}"
    # the package never even names the JAX package (its docs say "the JAX
    # package's ops/..."): no name that could turn into an import
    for f in files + sorted(PKG.rglob("*.cu")):
        for i, line in enumerate(f.read_text().splitlines(), 1):
            for part in line.split("incubator_mxnet_tpu")[1:]:
                assert part.startswith("_torch"), f"{f}:{i}: {line.strip()}"


def test_numpy_ops_never_copy_an_operand_to_the_host():
    """``ops/numpy_ops.py`` computes the dynamic-shape ops on the operand's
    device: no ``.numpy()``, ``.cpu()``, ``.tolist()`` or ``.item()`` on a
    tensor, and no ``np.asarray``/``np.array`` (the module does not even
    import numpy)."""
    for name in ("ops/numpy_ops.py", "ops/fft_ops.py", "ops/linalg.py"):
        tree = ast.parse((PKG / name).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and isinstance(node.func,
                                                         ast.Attribute):
                assert node.func.attr not in ("numpy", "cpu", "tolist",
                                              "item", "asarray"), \
                    f"{name}:{node.lineno}: .{node.func.attr}()"
        assert "numpy" not in set(_imported_modules(PKG / name)), name


def test_sparse_storage_never_copies_an_operand_to_the_host():
    """``ndarray/sparse.py`` keeps data, indices and indptr on the
    operand's device: no ``.cpu()``, ``.numpy()``, ``.tolist()`` or
    ``.item()`` on a tensor, no ``np.asarray``/``np.array`` (the module
    does not import numpy); the sizes that depend on the data come from
    device ops (``torch.unique``, boolean masks)."""
    name = "ndarray/sparse.py"
    tree = ast.parse((PKG / name).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute):
            assert node.func.attr not in ("numpy", "cpu", "tolist", "item",
                                          "asarray", "array"), \
                f"{name}:{node.lineno}: .{node.func.attr}()"
    assert "numpy" not in set(_imported_modules(PKG / name))


def test_default_device_is_the_card_never_a_silent_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    assert mx.current_context() == mx.gpu(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mx.gpu().torch_device()
    net = get_gpt("gpt_decoder_tiny", vocab_size=17, units=32, num_layers=1,
                  max_length=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        net.initialize("xavier")
    from incubator_mxnet_tpu_torch.gluon.model_zoo import get_model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model("resnet18_v1").initialize("xavier")   # deferred shapes
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_jax_params(net, {}, ctx=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mx.nd.array([1.0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mx.nd.zeros((2,))
    net.initialize("xavier", ctx=mx.cpu())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.DecodeSession(net, max_slots=1, max_len=16,
                              prefill_buckets=(8,))
    with mx.cpu():                       # an explicit CPU default is honored
        assert mx.current_context() == mx.cpu()
        sess = serving.DecodeSession(net, max_slots=1, max_len=16,
                                     prefill_buckets=(8,))
        sess.close()


def test_cpu_path_never_launches_the_kernel():
    mx.random.seed(1)
    net = get_gpt("gpt_decoder_tiny", vocab_size=17, units=32, num_layers=1,
                  max_length=16).initialize("xavier", ctx=mx.cpu())
    fa.flash_fwd_launches = 0
    with serving.DecodeSession(net, ctx=mx.cpu(), max_slots=2, max_len=16,
                               prefill_buckets=(8,)) as sess:
        got = sess.generate(np.arange(1, 6), max_new_tokens=4)
    assert len(got) == 4
    assert fa.flash_fwd_launches == 0


def test_cpu_training_never_launches_a_kernel():
    mx.random.seed(2)
    net = get_gpt("gpt_decoder_tiny", vocab_size=17, units=32, num_layers=1,
                  max_length=16).initialize("xavier", ctx=mx.cpu())
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    x = torch.from_numpy(np.random.RandomState(0).randint(0, 17, (2, 9)))
    y = x.float()
    fa.flash_fwd_launches = fa.flash_bwd_dq_launches = 0
    fa.flash_bwd_dkv_launches = 0
    st = mx.parallel.SPMDTrainer(net, lambda lg, lb: ce(lg, lb).mean(),
                                 "adam", {"learning_rate": 1e-3})
    assert torch.isfinite(st.step(x, y))
    tr = mx.gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": .1})
    with mx.autograd.record():
        loss = ce(net(x), y)
    mx.autograd.backward(loss)
    tr.step(2)
    assert tensors_of(net)["head.weight"].grad is not None
    assert (fa.flash_fwd_launches, fa.flash_bwd_dq_launches,
            fa.flash_bwd_dkv_launches) == (0, 0, 0)


def test_kernel_build_is_content_addressed():
    """The library name hashes the source and flags, so an edited source
    rebuilds and nothing is built at import."""
    from incubator_mxnet_tpu_torch.ops import _build

    path = _build.lib_path("flash_fwd")
    assert path.parent == ROOT / "build" / "kernels"
    assert path.name.startswith("libflash_fwd-") and path.suffix == ".so"
    assert (_build.CSRC / "flash_fwd.cu").exists()
    assert set(_build.SOURCES) == {p.stem for p in _build.CSRC.glob("*.cu")}
    assert set(_build.SOURCES) == {"flash_fwd", "flash_fwd_tc",
                                   "flash_fwd_f32", "flash_fwd_split",
                                   "flash_bwd", "flash_bwd_f32",
                                   "flash_bwd_tc", "fused_conv", "conv_bwd",
                                   "conv_bwd_f32", "conv_bwd_tc",
                                   "fused_conv_f32", "fused_conv_tc"}
    assert not fa._fwd_fns or torch.cuda.is_available()
    assert not fa._bwd_fns or torch.cuda.is_available()
    assert not fc._fns or torch.cuda.is_available()


def test_kernel_build_hash_covers_the_shared_header(tmp_path, monkeypatch):
    """The conv kernels include ``csrc/conv_common.cuh``: editing it must
    rename their libraries (and the flash kernels' too, whose hash covers
    the same headers)."""
    import shutil

    from incubator_mxnet_tpu_torch.ops import _build

    for f in _build.CSRC.iterdir():
        if f.is_file():                  # csrc/rtc/ holds the NVRTC sources
            shutil.copy(f, tmp_path / f.name)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build.lib_path(n) for n in _build.SOURCES}
    assert before == {n: _build.lib_path(n) for n in _build.SOURCES}
    header = tmp_path / "conv_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.lib_path(n) for n in _build.SOURCES}
    assert all(before[n] != after[n] for n in _build.SOURCES)
    assert {p.parent for p in after.values()} == {ROOT / "build" / "kernels"}


def test_cpu_resnet_path_never_launches_a_kernel():
    """Eval, an ``SPMDTrainer`` step and an eager ``gluon.Trainer`` step
    of a small fused ResNet on the CPU: the conv kernels' counters stay 0
    (the plain versions ran)."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import (
        FusedResNetV1)

    mx.random.seed(3)
    net = FusedResNetV1([1, 1, 1, 1], [8, 16, 32, 64, 128],
                        classes=5).initialize("xavier", ctx=mx.cpu())
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.rand(2, 3, 32, 32).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 5, (2,)).astype(np.float32))
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    fc.fused_conv_launches = fc.conv_bwd_dx_launches = 0
    fc.conv_bwd_dw_launches = 0
    with mx.autograd.pause():
        assert torch.isfinite(net(x)).all()
    st = mx.parallel.SPMDTrainer(net, lambda lg, lb: ce(lg, lb).mean(),
                                 "sgd", {"learning_rate": 0.1})
    assert torch.isfinite(st.step(x, y))
    tr = mx.gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": .1})
    with mx.autograd.record():
        loss = ce(net(x), y)
    mx.autograd.backward(loss)
    tr.step(2)
    assert tensors_of(net)["conv0_weight"].grad is not None
    assert (fc.fused_conv_launches, fc.conv_bwd_dx_launches,
            fc.conv_bwd_dw_launches) == (0, 0, 0)


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_refuses_to_run_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert _chip_smoke().main([]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_chip_smoke_alone_exits_2_and_prints_no_result(tmp_path):
    """Run from a directory that holds ``chip_smoke.py`` and nothing else of
    the repo (a card faked present), the port does not import: the script
    says so and exits 2, with nothing on its standard output."""
    import os
    import shutil

    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    code = ("import sys, torch; torch.cuda.is_available = lambda: True; "
            "sys.path.insert(0, '.'); import chip_smoke; "
            "sys.exit(chip_smoke.main([]))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 2 and out.stdout == "", out.stderr
    assert "not importable" in out.stderr


def test_chip_smoke_bound_counts_only_the_keys_the_data_reaches():
    cs = _chip_smoke()
    lens = torch.tensor([3, 10, 0])
    valid = cs._valid_mask(3, 1, 16, lens, True, True, torch.device("cpu"))
    assert valid.shape == (3, 1, 1, 16)
    assert valid.sum().item() == 13           # decode row t attends [0, t]
    h, d = 12, 64
    ms, by = cs.attention_bound(3, h, 1, 16, d, torch.float32, valid, False)
    # q read + o written, K and V only for the 13 cached keys, fp32
    nbytes = (3 * h * d * 2 + 13 * h * d * 2) * 4
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / cs.HBM_BYTES_PER_S * 1e3)
    causal = cs._valid_mask(1, 256, 256, None, True, False,
                            torch.device("cpu"))
    assert causal.sum().item() == 256 * 257 // 2
    ms, by = cs.attention_bound(1, h, 256, 256, d, torch.float32, causal,
                                False)
    assert by == "operations"
    assert ms == pytest.approx(4 * d * h * 256 * 257 / 2 / 67e12 * 1e3)


def test_chip_smoke_backward_bound_counts_pairs_and_quoted_figures():
    cs = _chip_smoke()
    dev = torch.device("cpu")
    valid = cs._valid_mask(8, 256, 256, None, True, False, dev)
    h, d = 12, 64
    assert valid.sum().item() * h == 3_158_016     # attended pairs
    fig = {}
    for dtype in (torch.float32, torch.bfloat16):
        for kernel in ("dq", "dkv"):
            fig[kernel, dtype] = cs.attention_bwd_bound(
                kernel, 8, h, 256, 256, d, dtype, valid)
    # fp32: bound by operations at 67 TFLOP/s, 6*D and 8*D per pair
    assert fig["dq", torch.float32] == (
        pytest.approx(6 * d * 3_158_016 / 67e12 * 1e3), "operations")
    assert fig["dkv", torch.float32] == (
        pytest.approx(8 * d * 3_158_016 / 67e12 * 1e3), "operations")
    assert fig["dq", torch.float32][0] == pytest.approx(0.0181, abs=1e-4)
    assert fig["dkv", torch.float32][0] == pytest.approx(0.0241, abs=1e-4)
    # bf16: bound by bytes at 3.35 TB/s; dq moves q, g, k, v, dq and the
    # two fp32 row statistics, dk/dv one tensor more
    plane, rows = 8 * h * 256 * d * 2, 8 * h * 256 * 4
    for kernel, planes, mb, us in (("dq", 5, 15.9, 4.75),
                                   ("dkv", 6, 19.1, 5.69)):
        ms, by = fig[kernel, torch.bfloat16]
        nbytes = planes * plane + 2 * rows
        assert by == "bytes" and nbytes / 1e6 == pytest.approx(mb, abs=0.05)
        assert ms == pytest.approx(nbytes / cs.HBM_BYTES_PER_S * 1e3)
        assert ms * 1e3 == pytest.approx(us, abs=0.01)
    # data-dependent: an empty batch entry and unreached keys move nothing
    lens = torch.tensor([3, 0])
    valid = cs._valid_mask(2, 4, 16, lens, False, False, dev)
    ms, by = cs.attention_bwd_bound("dkv", 2, 1, 4, 16, 32, torch.float32,
                                    valid)
    # inputs: 4 reached rows of q, g (+ lse, delta), 3 reached keys of k, v;
    # outputs: dk, dv in full
    nbytes = (4 * 32 * 2 + 4 * 2 + 3 * 32 * 2 + 2 * 16 * 32 * 2) * 4
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / cs.HBM_BYTES_PER_S * 1e3)


def test_chip_smoke_kernel_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.kernel_phase`` at small shapes on the CPU (the plain
    versions run, so the route check is recorded instead of made): every
    case, the GPT's head-split views among them, passes its gates in fp32
    and bf16, names the route the rule gives its shape, and holds the SIMT
    kernel to the plain version and times it beside every other route, in
    a row of its own."""
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "device_ms", lambda fn, **k: (fn(), 0.0)[1])
    monkeypatch.setattr(cs, "call_ms", lambda fn, **k: (fn(), 0.0)[1])
    checks = []
    monkeypatch.setattr(cs, "_check_fwd_route",
                        lambda label, before, now, expect:
                        checks.append((label, expect)))
    cases = [("prefill", 1, 20, 20, 64, True, False, None, False),
             ("decode", 3, 1, 40, 64, True, True, (3, 40, 17), False),
             (cs.GPT_VIEWS, 2, 40, 40, 64, True, False, None, True),
             ("offset_T16_D128", 2, 16, 40, 128, True, True, (40, 16), True),
             ("tq_gt_tk_D32", 1, 30, 8, 32, True, False, None, True)]
    rows = cs.kernel_phase(0, torch.device("cpu"), cases, h=2)
    # (fp32 route, bf16 route) by the rule: a prompt of 20 or 16 rows
    # stays on SIMT in fp32, the 40-row views take f32
    want = {"prefill": ("simt", "tc"), "decode": ("split", "split"),
            cs.GPT_VIEWS: ("f32", "tc"),
            "offset_T16_D128": ("simt", "tc"),
            "tq_gt_tk_D32": ("simt", "simt")}
    main = [(c, dt, route) for c, pair in want.items()
            for dt, route in zip(("fp32", "bf16"), pair)]
    expanded = [row for c, dt, route in main
                for row in [(c, dt, route)] + ([(c, dt, "simt")]
                                               if route != "simt" else [])]
    assert [(r["case"], r["dtype"], r["route"]) for r in rows] == expanded
    assert checks == [(f"{c} {dt}", route) for c, dt, route in main]
    for r in rows:
        assert r["max_abs_err"] == 0 and r["lse_err"] == 0
        assert (r["simt_ms"] is None) == (r["route"] == "simt")
        assert r["simt_max_abs_err"] == (None if r["route"] == "simt"
                                         else 0)
        assert (r["library_causal_ms"] is None) == \
            (r["case"] not in ("prefill", cs.GPT_VIEWS))
        assert r["bound_ms"] > 0 and r["lse_tol"] <= cs.LSE_TOL
    # the card's case list: the forward's own, the GPT views and every
    # backward shape not among them
    names = [c[0] for c in cs.fwd_cases()]
    assert names[:len(cs.FWD_CASES) + 1] == \
        [c[0] for c in cs.FWD_CASES] + [cs.GPT_VIEWS]
    shapes = {c[1:8] for c in cs.fwd_cases()}
    assert all(c[1:] in shapes for c in cs.BWD_CASES)
    assert {"causal_D128_B2_T512", "cache_offset_B4_T16x512",
            "tq_gt_tk_causal_B2_T256x64", "prefill_causal_B1_T16"} <= \
        set(names)


def test_chip_smoke_backward_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.backward_kernel_phase`` at small shapes on the CPU (the
    plain versions run, so the route check is recorded instead of made):
    every fp32 row names ``"f32"`` or ``"simt"`` as the rule gives its
    head dim, bf16 rows ``"tc"`` or ``"simt"``; each row off the SIMT route
    carries ``simt_ms`` and has a SIMT row of its own beside it, held to
    the same gates; every gate passes on the plain versions."""
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "device_ms", lambda fn, **k: (fn(), 0.0)[1])
    monkeypatch.setattr(cs, "call_ms", lambda fn, **k: (fn(), 0.0)[1])
    checks = []
    monkeypatch.setattr(cs, "_check_bwd_route",
                        lambda label, before, now, expect:
                        checks.append((label, expect)))
    cases = [("causal_D64", 1, 20, 20, 64, True, False, None),
             ("lengths_len0_D128", 2, 9, 30, 128, False, False, (30, 0)),
             ("offset_D32", 2, 4, 24, 32, True, True, (24, 9)),
             ("tq_gt_tk_D64", 1, 30, 8, 64, True, False, None)]
    rows = cs.backward_kernel_phase(0, torch.device("cpu"), cases, h=2)
    want = {"causal_D64": ("f32", "tc"), "lengths_len0_D128": ("f32", "tc"),
            "offset_D32": ("simt", "simt"), "tq_gt_tk_D64": ("f32", "tc")}
    assert checks == [(f"{c} {dt}", r) for c, pair in want.items()
                      for dt, r in zip(("fp32", "bf16"), pair)]
    for c, pair in want.items():
        for dt, route in zip(("fp32", "bf16"), pair):
            for kernel in ("flash_bwd_dq", "flash_bwd_dkv"):
                got = [r for r in rows if (r["case"], r["dtype"],
                                           r["kernel"]) == (c, dt, kernel)]
                # the SIMT row first, then the routed one
                assert [r["route"] for r in got] == \
                    (["simt"] if route == "simt" else ["simt", route])
                assert got[-1]["simt_ms"] == (None if route == "simt"
                                              else 0.0)
                assert all(r["max_abs_err"] == 0 and r["bound_ms"] > 0
                           for r in got)
                assert (got[-1]["library_causal_ms"] is None) == \
                    (c != "causal_D64")
    assert cs.bwd_route_expected(64, torch.float32) == "f32"
    assert cs.bwd_route_expected(128, torch.bfloat16) == "tc"
    assert cs.bwd_route_expected(32, torch.float32) == "simt"


def test_chip_smoke_backward_route_check_names_the_route_taken():
    """``_check_bwd_route`` passes one launch of each kernel on the route
    it expects and raises on another route, on two, or on none."""
    cs = _chip_smoke()
    before = dict.fromkeys(cs.ROUTE_COUNTERS, 0)

    def after(*taken):
        now = dict(before)
        for kernel, route in taken:
            now[f"{kernel}_{route}"] += 1
        return now

    both = [("flash_bwd_dq", "f32"), ("flash_bwd_dkv", "f32")]
    cs._check_bwd_route("x", before, after(*both), "f32")
    for bad in (after(("flash_bwd_dq", "f32"), ("flash_bwd_dkv", "simt")),
                after(*both, ("flash_bwd_dq", "simt")),
                after(("flash_bwd_dq", "f32"))):
        with pytest.raises(AssertionError, match="not f32"):
            cs._check_bwd_route("x", before, bad, "f32")


def test_chip_smoke_decode_routes_follow_the_prefill_buckets():
    """Serving in fp32: 12 split launches a decode step, and 12 a prefill
    on the route its bucket's Tq takes: SIMT up to 32 rows (the 16-token
    bucket), f32 from ``FWD_F32_MIN_TQ`` (the 64-token bucket)."""
    cs = _chip_smoke()
    buckets = (16, 64)
    got = cs.decode_routes(buckets, [1, 16, 17, 48], steps=5)
    assert got == {"tc": 0, "f32": 12 * 2, "split": 12 * 5, "simt": 12 * 2}
    assert cs.decode_routes((1, 16), [1], steps=2) == \
        {"tc": 0, "f32": 0, "split": 12 * 3, "simt": 0}


def test_chip_smoke_prefill_times_rehearse_on_the_cpu(monkeypatch):
    """``chip_smoke.prefill_times`` on a tiny GPT's session on the CPU:
    each bucket's prefill through the session's cache equals the eager
    ``_prefill_apply`` at two true lengths, and a row a bucket comes back
    with the bucket's K4 route (nothing recorded: the CPU captures
    nothing)."""
    cs = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    mx.random.seed(2)
    net = get_gpt("gpt_decoder_tiny", vocab_size=31, units=32, num_layers=2,
                  max_length=64, dropout=0.0).initialize("xavier",
                                                         ctx=mx.cpu())
    with serving.DecodeSession(net, ctx=mx.cpu(), max_slots=2, max_len=64,
                               prefill_buckets=(16, 64)) as sess:
        sess.warmup()
        rows = cs.prefill_times(sess, "cpu", 31, reps=2)
    assert set(rows) == {16, 64}
    assert [rows[b]["route"] for b in (16, 64)] == ["simt", "f32"]
    assert all(r["recorded"] == {} and r["graph_ms"] > 0
               for r in rows.values())


def test_chip_smoke_resnet_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.resnet_phase`` on a small fused ResNet on the CPU (the
    plain versions run, so no launch is counted): every check of the phase
    passes and the launch windows expect 52-style counts from the net's
    own structure."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import (
        FusedResNetV1)

    cs = _chip_smoke()
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)
    windows = []
    monkeypatch.setattr(cs, "_check_launches",
                        lambda label, got, *want: windows.append((got, want)))
    mx.random.seed(0)
    net = FusedResNetV1([1, 2, 1, 1], [8, 16, 32, 64, 128],
                        classes=10).initialize("xavier", ctx=mx.cpu())
    out = cs.resnet_phase(0, "cpu", net, mx.cpu(), hw=32,
                          batches=(4, 2, 4, (4,)))
    assert out["per_pass"] == cs.convs_per_pass(net) == 5 * 3 + 4
    assert (out["oracle"]["n_trainable"], out["oracle"]["n_running_stats"]) \
        == (62, 40)
    assert out["oracle"]["worst"] <= cs.GRAD_RTOL and out["eval_err"] == 0
    assert out["learning_losses"][-1] < 0.95 * out["learning_losses"][0]
    assert out["bf16_gate"]["worst"] <= cs.BF16_GRAD_RTOL
    assert out["bf16_learning_losses"][-1] < \
        0.95 * out["bf16_learning_losses"][0]
    zero = {k: 0 for k in cs.CONV_KERNELS}
    routes = {(k, r): 0 for k in cs.ROUTED for r in cs.CONV_ROUTES[k]}
    fp32 = cs.conv_routes_expected(torch.float32)
    assert fp32 == {"fused_conv": "f32", "conv_bwd_dx": "f32",
                    "conv_bwd_dw": "f32"}
    assert windows == [(zero, (19, 1, 1, routes, fp32)),
                       (zero, (19, 1, 0, routes, fp32)),
                       (zero, (19, 1, 0, routes, "tc")),
                       (zero, (19, 1, 0, routes, "simt")),
                       (zero, (19, 2, 0, routes, fp32)),
                       (zero, (19, 12, 12, routes, fp32)),
                       (zero, (19, 1, 1, routes, "tc")),
                       (zero, (19, 18, 18, routes, "tc"))]
    gate = out["bf16_fwd_gate"]
    assert gate["n_running_stats"] == 40
    # on the CPU both routes are the plain version: the same distances
    assert gate["tc"] == gate["simt"] and gate["tc"]["logits"] > 0


def test_chip_smoke_model_server_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.model_server_phase`` on a small fused ResNet on the CPU
    (the cache runs the eager apply there, nothing is captured, no kernel
    launches): the gates pass (each bucket's rows equal the eager forward
    of the padded batch, the served rows their own B=1 forwards and the
    plain versions, the backpressure burst and the drain, the bf16 logits
    the fp32 forward on the same bf16-rounded inputs), the launch windows
    expect K1 once a conv a batch on the f32 then the tensor-core route,
    and the open loop gives a row per rate, batched and unbatched."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import (
        FusedResNetV1)

    cs = _chip_smoke()
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("max_memory_allocated", "memory_allocated",
                 "memory_reserved"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    windows = []
    monkeypatch.setattr(cs, "_check_launches",
                        lambda label, got, *want: windows.append((got, want)))
    mx.random.seed(0)
    net = FusedResNetV1([1, 1, 1, 1], [16, 32, 64, 128, 256],
                        classes=10).initialize("xavier", ctx=mx.cpu())
    out = cs.model_server_phase(0, "cpu", net, mx.cpu(), hw=64,
                                buckets=(1, 2, 4), requests=6, clients=3,
                                rates={"fp32": (40.0,), "bf16": (40.0,)},
                                rate_s=0.3)
    per_pass = cs.convs_per_pass(net)
    assert out["per_pass"] == per_pass == 16
    zero = {k: 0 for k in cs.CONV_KERNELS}
    routes = {(k, r): 0 for k in cs.ROUTED for r in cs.CONV_ROUTES[k]}
    assert [w[0] for w in windows] == [zero, zero]
    assert [w[1][:3] + w[1][4:] for w in windows] == [
        (per_pass, out["fp32"]["batches"], 0, dict.fromkeys(cs.ROUTED,
                                                            "f32")),
        (per_pass, out["bf16"]["batches"], 0, dict.fromkeys(cs.ROUTED,
                                                            "tc"))]
    assert all(w[1][3] == routes for w in windows)
    for dt in ("fp32", "bf16"):
        assert 1 <= out[dt]["batches"] <= 6 and out[dt]["captures"] == 0
        assert set(out[dt]["bucket_ms"]) == {1, 2, 4}
        (row,) = out[dt]["open_loop"]
        assert row["rate"] == 40.0
        assert row["batched"]["completed"] > 0
        assert row["unbatched"]["completed"] > 0
    assert out["fp32"]["row_err"] <= cs.SERVER_ROW_RTOL
    assert out["fp32"]["plain_err"] <= cs.TOLS[torch.float32]
    # on the CPU both routes are the plain version
    assert out["bf16"]["gate"] > 0
    assert out["bf16"]["ratio"] <= 1 + cs.FWD_GATE_SLACK


def test_chip_smoke_registry_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.registry_phase`` on a small fused ResNet and a tiny GPT
    on the CPU (eager executables, no kernel launches, no card memory):
    the budget fits two models of three, the LRU idle model goes, the one
    in flight stays, a re-admission serves its first residency's rows,
    the hot-swap under open-loop traffic gives every batch exactly one
    version and every request after the publish version 1, a replay after
    it equals the eager forward on the new weights, the decode streams
    follow each version's oracle and a deferred publish lands at the next
    admission. The artifact warm start (new processes on the card) is left
    out here."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo import get_gpt
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import (
        FusedResNetV1)

    cs = _chip_smoke()
    windows = []
    monkeypatch.setattr(cs, "_check_launches",
                        lambda label, got, *want: windows.append(label))

    def make_resnet(seed):
        mx.random.seed(seed)
        return FusedResNetV1([1, 1, 1, 1], [16, 32, 64, 128, 256],
                             classes=10).initialize("xavier", ctx=mx.cpu())

    def make_gpt(seed):
        mx.random.seed(seed)
        return get_gpt("gpt_decoder_tiny", vocab_size=61, units=32,
                       num_layers=2, max_length=256, dropout=0.0).initialize(
                           "xavier", ctx=mx.cpu())

    out = cs.registry_phase(0, "cpu", mx.cpu(), make_resnet, make_gpt,
                            hw=32, buckets=(1, 2, 4), rate=40.0, rate_s=0.6,
                            n_images=12, gpt_kw=dict(max_slots=2,
                                                     max_len=256),
                            prompt_lens=(5, 9, 20), new_tokens=4,
                            long_tokens=120, clients=3, warm_start=False)
    assert windows == ["registry fp32 traffic", "registry bf16 traffic",
                       "registry fp32 swap traffic"]
    assert [e[0] for e in out["evictions"]][:2] == ["resnet_fp32",
                                                    "resnet_bf16"]
    assert out["evictions"][1][2] == ["gpt"]
    sw = out["swap"]
    assert sw["requests"] > 0 and 0 < sw["v1_rows"] <= sw["requests"]
    assert out["budget"] < sum(out["sizes"].values())
    assert out["stats"]["evictions"] >= 2 and out["stats"]["swaps"] == 3
    assert "warm_start" not in out


def test_chip_smoke_unfused_resnet_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.unfused_resnet_phase`` on a small zoo ResNet and a fused
    one of the same architecture, on the CPU: the weights map across
    (``zoo_to_fused``), the parity, learning and bench-row checks pass,
    and every launch window expects 0 fused conv launches; then
    ``chip_smoke.mlp_phase`` at a small batch."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision

    cs = _chip_smoke()
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)
    windows = []
    monkeypatch.setattr(cs, "_check_launches",
                        lambda label, got, *want: windows.append((got, want)))
    layers, channels = [1, 1, 1, 1], [8, 16, 32, 64, 128]
    mx.random.seed(0)
    net = vision.ResNetV1(vision.BottleneckV1, layers, channels,
                          classes=10).initialize("xavier", ctx=mx.cpu())
    with mx.autograd.pause():
        net(torch.zeros(2, 3, 64, 64))
    fused = vision.FusedResNetV1(layers, channels, classes=10).initialize(
        "xavier", ctx=mx.cpu())
    out = cs.unfused_resnet_phase(0, "cpu", net, fused, mx.cpu(), hw=64,
                                  batches=(2, 4, 4))
    parity = out["parity"]
    assert (parity["n_trainable"], parity["n_running_stats"]) == (53, 34)
    assert parity["grad_worst"] <= cs.UNFUSED_GRAD_RTOL
    assert max(parity["loss_err"], parity["stats_worst"],
               parity["eval_logits_err"]) <= cs.UNFUSED_TOL
    assert out["learning_losses"][-1] < 0.95 * out["learning_losses"][0]
    assert set(out["bench"]) == {"nchw", "channels_last"}
    zero = {k: 0 for k in cs.CONV_KERNELS}
    routes = {(k, r): 0 for k in cs.ROUTED for r in cs.CONV_ROUTES[k]}
    assert windows == [(zero, (0, 6, 6, routes, "f32")),
                       (zero, (0, 16, 16, routes, "tc"))]
    assert net.output.weight.dtype == torch.bfloat16
    mlp = cs.mlp_phase(0, "cpu", mx.cpu())
    assert mlp["learning_losses"][-1] < 0.95 * mlp["learning_losses"][0]
    assert mlp["batch"] == 8192 and mlp["images_s"] > 0


def test_chip_smoke_bert_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.bert_phase`` on a small BERT (2 layers, 2 heads of 64)
    on the CPU: the oracle, eval, float lengths, padding independence,
    learning, eager steps, ``invoke_op`` and the bf16 gate pass, the three
    bench rows run, and each launch window expects 12-style counts from
    the net's own layers (recorded here: the CPU launches no kernel)."""
    from incubator_mxnet_tpu_torch.models import get_bert

    cs = _chip_smoke()
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)
    windows = []
    monkeypatch.setattr(cs, "_check_flash_launches",
                        lambda label, got, routes, want, want_routes:
                        windows.append((want, {k: v for k, v in
                                               want_routes.items() if v})))
    mx.random.seed(0)
    net = get_bert("bert_12_768_12", vocab_size=97, units=128,
                   hidden_size=256, num_layers=2, num_heads=2,
                   max_length=64, dropout=0.0,
                   attention_impl="pallas").initialize("xavier",
                                                       ctx=mx.cpu())
    # T=40: fp32 forwards on f32 from FWD_F32_MIN_TQ (33) query rows
    out = cs.bert_phase(0, "cpu", net, mx.cpu(), sizes=(4, 40, 4))
    assert out["grad_worst_rel"] <= cs.GRAD_RTOL
    assert out["eval_worst_rel"] <= cs.BERT_EVAL_RTOL
    assert out["float_lengths_equal"] and out["padding_equal"]
    assert out["learning_losses"][-1] < 0.95 * out["learning_losses"][0]
    assert out["bf16_grad_worst_rel"] <= cs.BF16_GRAD_RTOL
    assert set(out["rows"]) == {"pallas", "xla", "pallas_mixed_lengths"}
    assert out["rows"]["pallas_mixed_lengths"]["valid_length"][:2] == \
        [40, 1]
    assert all(r["sequences_s"] > 0 for r in out["rows"].values())
    fwd, bwd = ("flash_fwd_f32", ("flash_bwd_dq_f32", "flash_bwd_dkv_f32"))
    tc = ("flash_fwd_tc", "flash_bwd_dq_tc", "flash_bwd_dkv_tc")
    # 13 fp32 training passes (oracle, 10 learning steps, 2 eager steps)
    # and 3 forwards (eval, float lengths, padding), 2 layers each
    assert windows[0] == ({"flash_fwd": 32, "flash_bwd_dq": 26,
                           "flash_bwd_dkv": 26},
                          {fwd: 32, bwd[0]: 26, bwd[1]: 26})
    assert windows[1] == ({"flash_fwd": 4, "flash_bwd_dq": 2,
                           "flash_bwd_dkv": 2},
                          {tc[0]: 4, tc[1]: 2, tc[2]: 2})
    # each bench row: 3 warmup, 10 timed and 1 profiled step
    row = dict.fromkeys(cs.COUNTERS, 28)
    assert windows[2:] == [(row, dict.fromkeys(tc, 28)),
                           (dict.fromkeys(cs.COUNTERS, 0), {}),
                           (row, dict.fromkeys(tc, 28))]
    assert cs.bert_lengths(0, 24, 128)[:2].tolist() == [128, 1]
    assert all(1 <= n <= 128 for n in cs.bert_lengths(0, 24, 128))


def test_no_k7_launch_falls_back_to_a_plain_function():
    """``mx.rtc`` and the kernels it launches catch nothing: a launch that
    cannot happen raises. The only handler in the NVRTC bindings skips a
    library file that does not load, on to the next place to look."""
    for name in ("rtc.py", "ops/rtc_kernels.py", "operator.py"):
        tree = ast.parse((PKG / name).read_text())
        handlers = [n for n in ast.walk(tree)
                    if isinstance(n, ast.ExceptHandler)]
        assert not handlers, f"{name}:{handlers[0].lineno}"
    tree = ast.parse((PKG / "ops" / "_nvrtc.py").read_text())
    handlers = [n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)]
    assert len(handlers) == 1
    assert ast.unparse(handlers[0].type) == "OSError"
    assert [type(b) for b in handlers[0].body] == [ast.Continue]


def test_chip_smoke_imperative_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.imperative_phase`` on a small GPT on the CPU (the plain
    versions run, so no launch is counted): the oracle, the learning check,
    the rtc kernels' rows and the bit-for-bit invoke checks all pass, and
    the launch window expects one launch of each rtc kernel of the program,
    one softmax_ce_fwd/bwd per imperative step and a flash launch per
    layer per pass."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo import get_gpt

    from incubator_mxnet_tpu_torch.ops import rtc_kernels

    cs = _chip_smoke()
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)
    monkeypatch.setattr(cs, "device_ms", lambda fn, **k: (fn(), 0.0)[1])
    # an H100's opt-in shared memory a block, for the printed plans
    monkeypatch.setattr(rtc_kernels, "smem_optin", lambda dev: 232_448)
    windows = []
    monkeypatch.setattr(cs, "_check_imperative_launches",
                        lambda *a: windows.append(a))
    mx.random.seed(0)
    net = get_gpt("gpt_decoder_tiny", vocab_size=97, units=64, num_layers=2,
                  max_length=16, dropout=0.0).initialize("xavier",
                                                         ctx=mx.cpu())
    small = ("3x3_small_pro", 2, 8, 8, 8, 8, 3, 1, 1, "pro")
    out = cs.imperative_phase(0, "cpu", net, mx.cpu(), b=2, flat=1000,
                              lr=1e-2, conv_case=small,
                              softmax_shapes=((2, 60001), (5, 7), (3, 41)))
    assert out["n_params"] == 29
    assert out["grad_worst_rel"] <= cs.IMPERATIVE_GRAD_RTOL
    assert out["learning_losses"][-1] < 0.95 * out["learning_losses"][0]
    assert (out["rtc_steps"], out["passes"]) == (9, 10)
    zero = {k: 0 for k in cs.RTC_KERNELS}
    want = dict(scale=1, saxpy=1, first_row=1, softmax_ce_fwd=9,
                softmax_ce_bwd=9)
    # on the CPU no kernel launches: every count 0, against 2 layers x 10
    # passes at T=16, K4 on simt (16 rows) and K5/K6 on f32; at T=256 K4
    # would take f32
    routes = cs.training_routes(10, 0, layers=2, t=16, d=net.head_dim)
    assert routes["flash_bwd_dq_f32"] == routes["flash_fwd_simt"] == 20
    assert cs.training_routes(10, 0, layers=2)["flash_fwd_f32"] == 20
    assert windows == [(zero, want, {k: 0 for k in cs.COUNTERS}, 2 * 10,
                        dict.fromkeys(cs.ROUTE_COUNTERS, 0), routes)]
    rows = out["rows"]
    assert list(rows) == list(cs.RTC_KERNELS)
    assert rows["softmax_ce_fwd"]["max_rel_err"] <= cs.RTC_FWD_RTOL
    assert all(r["max_abs_err"] == 0 == r["max_rel_err"]
               for n, r in rows.items() if n != "softmax_ce_fwd")
    assert all(isinstance(r["library_ms"], float) for r in rows.values())
    assert rows["scale"]["shape"] == [1000]
    assert rows["softmax_ce_bwd"]["shape"] == [32, 97]
    assert rows["softmax_ce_fwd"]["plan"]["resident"]
    # K7's cases beside the path: each held to its tolerance, with its plan
    cases = {c["case"]: c for c in out["rtc_cases"]}
    assert list(cases) == [
        "softmax_ce_fwd_write_2x60001", "softmax_ce_fwd_write_5x7",
        "softmax_ce_fwd_write_3x41", "softmax_ce_fwd_add_32x97",
        "scale_view1_new_out", "scale_view1_view_out",
        "scale_view3_new_out", "scale_view3_view_out",
        "saxpy_view1_mixed", "saxpy_view1_view_out", "saxpy_view3_mixed",
        "saxpy_view3_view_out"]
    assert [c["plan"]["resident"] for c in out["rtc_cases"][:4]] == [
        False, True, True, True]
    assert all(c["max_rel_err"] <= c["rel_tol"] for c in cases.values())
    assert all(c["max_abs_err"] == 0 for c in cases.values()
               if c["name"] in ("scale", "saxpy"))
    for name in ("scale", "saxpy"):
        assert [c["shape"] for c in cases.values()
                if c["name"] == name] == [[997]] * 4
    assert [(c["offset_a"], c["offset_b"], c["offset_out"])
            for c in cases.values() if c["name"] == "saxpy"] == [
        (1, 0, 0), (1, 1, 1), (3, 0, 0), (3, 3, 3)]
    assert cases["softmax_ce_fwd_add_32x97"]["library_ms"] is None
    assert cases["softmax_ce_fwd_add_32x97"]["bound_ms"] == pytest.approx(
        3 * 32 * 97 * 4 / cs.HBM_BYTES_PER_S * 1e3)


def test_chip_smoke_nd_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.nd_phase`` on a small GPT on the CPU (the plain
    versions run, so no launch is counted): the mx.nd step's loss and its
    29 gradients against the gluon step's, the learning check with dropout,
    the launch window expecting a flash launch per layer per pass on the
    fp32 routes, the timing and the profile, then every op case of
    ``ND_CASES`` (here the CPU against itself) and Dropout's statistics."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo import get_gpt

    cs = _chip_smoke()
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    windows = []
    monkeypatch.setattr(cs, "_check_nd_launches",
                        lambda *a: windows.append(a))
    mx.random.seed(0)
    net = get_gpt("gpt_decoder_tiny", vocab_size=97, units=64, num_layers=2,
                  max_length=16, dropout=0.0).initialize("xavier",
                                                         ctx=mx.cpu())
    out = cs.nd_phase(0, "cpu", net, mx.cpu(), b=2, lr=1e-2, reps=2)
    assert out["n_params"] == 29
    assert out["grad_worst_rel"] <= cs.IMPERATIVE_GRAD_RTOL
    assert abs(out["loss"] - out["ref_loss"]) <= 1e-5 * out["ref_loss"]
    assert out["learning_losses"][-1] < 0.95 * out["learning_losses"][0]
    assert out["passes"] == 7
    # on the CPU no kernel launches: every count 0, against 2 layers x 7
    # passes, K4 on simt at T=16 and K5/K6 on f32
    assert windows == [({k: 0 for k in cs.COUNTERS},
                        dict.fromkeys(cs.ROUTE_COUNTERS, 0),
                        {k: 2 * 7 for k in cs.COUNTERS},
                        cs.training_routes(7, 0, layers=2, t=16,
                                           d=net.head_dim))]
    assert sum(f["cases"] for f in out["families"].values()) == len(
        cs.ND_CASES)
    assert all(f["worst"] == 0.0 for f in out["families"].values())


def test_chip_smoke_np_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.np_phase`` on a small GPT on the CPU (the plain
    versions run, so no launch is counted): the mx.np step's loss and its
    29 gradients against the gluon step's, ``clip_by_global_norm`` over
    them, the learning check, the launch window expecting a flash launch
    per layer per pass on the fp32 routes, the timing and the profile,
    then every case of ``NP_CASES`` (here the CPU against itself) and the
    dynamic-shape ops' results on the device."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo import get_gpt

    cs = _chip_smoke()
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    windows = []
    monkeypatch.setattr(cs, "_check_flash_launches",
                        lambda label, *a: windows.append(a))
    mx.random.seed(0)
    net = get_gpt("gpt_decoder_tiny", vocab_size=97, units=64, num_layers=2,
                  max_length=16, dropout=0.0).initialize("xavier",
                                                         ctx=mx.cpu())
    out = cs.np_phase(0, "cpu", net, mx.cpu(), b=2, lr=1e-2, reps=2)
    assert out["n_params"] == 29
    assert out["grad_worst_rel"] <= cs.GRAD_RTOL
    assert abs(out["loss"] - out["ref_loss"]) <= 1e-5 * out["ref_loss"]
    assert out["learning_losses"][-1] < 0.95 * out["learning_losses"][0]
    assert out["passes"] == 6 and out["clip_err"] <= 1e-6
    assert windows == [({k: 0 for k in cs.COUNTERS},
                        dict.fromkeys(cs.ROUTE_COUNTERS, 0),
                        {k: 2 * 6 for k in cs.COUNTERS},
                        cs.training_routes(6, 0, layers=2, t=16,
                                           d=net.head_dim))]
    assert sum(f["cases"] for f in out["families"].values()) == len(
        cs.NP_CASES)
    assert all(f["worst"] == 0.0 for f in out["families"].values())


def test_chip_smoke_nd_1x_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.nd1x_phase`` on a small BERT (2 layers, 2 heads of 32)
    on the CPU (the plain versions run, so no launch is counted): the 1.x
    step's loss and 47 gradients against the gluon pass's, both against
    fp64, the update seen by the gluon forward, the learning check, the
    launch windows expecting a flash launch per layer in the gluon pass, a
    K4 a layer in the gluon forward after the update and none in the 1.x
    steps, the timing and the profile, then every case of
    ``MORE_CASES`` and ``UPDATE_CASES`` (here the CPU against itself), the
    update wrappers' in-place rule, the samplers' statistics and the state
    replay."""
    from incubator_mxnet_tpu_torch.models import get_bert

    cs = _chip_smoke()
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    windows = []
    monkeypatch.setattr(cs, "_check_flash_launches",
                        lambda label, got, routes, want, want_routes:
                        windows.append((got, want, {k: v for k, v in
                                                    want_routes.items()
                                                    if v})))
    mx.random.seed(0)
    net = get_bert("bert_12_768_12", vocab_size=97, units=64,
                   hidden_size=128, num_layers=2, num_heads=2,
                   max_length=64, dropout=0.0,
                   attention_impl="pallas").initialize("xavier",
                                                       ctx=mx.cpu())
    out = cs.nd1x_phase(0, "cpu", net, mx.cpu(), sizes=(4, 40), reps=2,
                        n_draws=2**14)
    assert out["n_params"] == 47
    assert out["grad_worst_rel"] <= cs.GRAD_RTOL
    assert abs(out["loss"] - out["ref_loss"]) <= \
        cs.BERT_EVAL_RTOL * out["ref_loss"]
    assert len(out["learning_losses"]) == 10
    assert out["learning_losses"][-1] < 0.95 * out["learning_losses"][0]
    # on the CPU no kernel launches: every count 0, against a launch of
    # K4, K5 and K6 a layer on f32 in the gluon pass, none in the 1.x steps
    zeros = dict.fromkeys(cs.COUNTERS, 0)
    gluon_routes = {k: v for k, v in cs.training_routes(
        1, 0, layers=2, t=40, d=32).items() if v}
    fwd = "flash_fwd_" + cs.fwd_route_expected(40, 32, torch.float32)
    assert windows == [(zeros, dict.fromkeys(cs.COUNTERS, 2), gluon_routes),
                       (zeros, dict(zeros, flash_fwd=2), {fwd: 2}),
                       (zeros, zeros, {})]
    assert out["fp64_worst_rel"]["1.x"] <= cs.GRAD_RTOL
    assert sum(f["cases"] for f in out["families"].values()) == len(
        cs.MORE_CASES) + len(cs.UPDATE_CASES)
    assert all(f["worst"] == 0.0 for f in out["families"].values())
    assert out["wrappers"] == 14 and len(out["samplers"]) == 23
    assert all(z <= 5.0 for *_, z in out["samplers"].values())
    assert all(out[k] > 0 for k in ("step_ms", "pallas_step_ms",
                                    "xla_step_ms"))


def test_chip_smoke_sparse_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.sparse_phase`` on a small BERT (2 layers, 2 heads of
    32, vocab 1000) and a csr of 4096 features on the CPU (the plain
    versions run, so no launch is counted): the row-sparse word
    embedding's gradient against the dense run's, the lazy update against
    its plain version, untouched rows, the fallback and each step's
    descent; the csr
    classifier's products against scipy; every case of ``SPARSE_CASES``,
    ``LAYER_CASES``, ``LOSS_CASES`` and ``REPAIR_CASES`` (here the CPU
    against itself)."""
    from incubator_mxnet_tpu_torch.models import get_bert

    cs = _chip_smoke()
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    windows = []
    monkeypatch.setattr(cs, "_check_flash_launches",
                        lambda label, got, routes, want, want_routes:
                        windows.append((got, want, {k: v for k, v in
                                                    want_routes.items()
                                                    if v})))
    mx.random.seed(0)
    net = get_bert("bert_12_768_12", vocab_size=1000, units=64,
                   hidden_size=128, num_layers=2, num_heads=2,
                   max_length=64, dropout=0.0,
                   attention_impl="pallas").initialize("xavier",
                                                       ctx=mx.cpu())
    out = cs.sparse_phase(0, "cpu", net, mx.cpu(), sizes=(4, 24),
                          csr_rows=512, csr_features=4096)
    bert = out["bert"]
    assert bert["grad_rows_worst_rel"] <= cs.GRAD_RTOL
    assert bert["grad_worst_rel"] <= cs.GRAD_RTOL
    assert bert["param_worst_rel"] <= cs.GRAD_RTOL
    assert bert["lazy_worst_rel"] <= cs.LAZY_RTOL
    assert 0 < bert["untouched_rows"] < 1000
    assert all(a < v for v, a in zip(bert["losses"], bert["losses_after"]))
    # on the CPU no kernel launches: every count 0, against a launch of
    # K4, K5 and K6 a layer a pass on f32 (6 passes and 3 forwards)
    routes = cs.training_routes(6, 0, layers=2, t=24, d=32)
    routes["flash_fwd_" + cs.fwd_route_expected(24, 32, torch.float32)] += 6
    assert windows == [(dict.fromkeys(cs.COUNTERS, 0),
                        {"flash_fwd": 18, "flash_bwd_dq": 12,
                         "flash_bwd_dkv": 12},
                        {k: v for k, v in routes.items() if v})]
    csr = out["csr"]
    assert csr["products_worst_rel"] <= cs.CSR_RTOL
    assert csr["losses"][-1] < csr["losses"][0] and csr["nnz"] == 512 * 15
    cases = (cs.SPARSE_CASES, cs.LAYER_CASES, cs.LOSS_CASES,
             cs.REPAIR_CASES)
    assert sum(f["cases"] for f in out["families"].values()) == sum(
        len(t) for t in cases)
    assert set(out["families"]) == {"storage", "arith", "dot", "autograd",
                                    "embedding", "optimizer", "layers",
                                    "losses", "repairs"}
    assert all(f["worst"] == 0.0 for f in out["families"].values())
    assert len(cs.LAYER_CASES) >= 14 and len(cs.LOSS_CASES) >= 11


def test_chip_smoke_vision_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.vision_phase`` on the CPU at small sizes: two models of
    the zoo at 64x64 (``squeezenet1.1`` against its pinned inventory, and
    ``mobilenetv3_small``) through the parity check against a CPU copy,
    the learning check with ``split_and_load`` and ``clip_global_norm``,
    the timed steps and the profile; ``gpt_clip_phase`` on a 2-layer GPT
    (the norm, the scaling and the parameters against the plain version's,
    NaN and inf, the launch window expecting a flash launch per layer per
    pass on the fp32 routes); then two ``VISION_CASES`` and every case of
    ``UTILS_CASES`` and ``CONTRIB_CASES`` (here the CPU against itself)."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo import get_gpt

    cs = _chip_smoke()
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)
    windows = []
    monkeypatch.setattr(cs, "_check_flash_launches",
                        lambda label, *a: windows.append(a))
    # the CPU's small batch of 64x64 images learns at its own rates
    monkeypatch.setattr(cs, "VISION_LR", {"squeezenet1.1": 0.3,
                                          "mobilenetv3_small": 0.3})
    mx.random.seed(0)
    gpt = get_gpt("gpt_decoder_tiny", vocab_size=97, units=64, num_layers=2,
                  max_length=16, dropout=0.0).initialize("xavier",
                                                         ctx=mx.cpu())
    models = {"squeezenet1.1": (64, cs.VISION_MODELS["squeezenet1.1"][1]),
              "mobilenetv3_small": (64, None)}
    cases = ([("squeezenet1.0", 64, 2), ("mobilenet0.25", 64, 2)],
             cs.UTILS_CASES + cs.CONTRIB_CASES)
    # small ops: one intra-op thread (beside other test processes torch's
    # thread team waits on its descheduled members)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = cs.vision_phase(0, "cpu", mx.cpu(), models=models, gpt=gpt,
                              cases=cases, batches=(2, 4), gpt_b=2)
    finally:
        torch.set_num_threads(threads)
    for name, row in out["models"].items():
        assert row["losses"][-1] < 0.95 * row["losses"][0], name
        assert row["parity"]["eval_err"] <= cs.VISION_EVAL_RTOL
        assert row["parity"]["grad_worst"] <= cs.GRAD_RTOL
        assert row["images_s"] > 0 and row["batch"] == 4
    assert out["models"]["squeezenet1.1"]["inventory"] == (
        1_235_496, 52, 0, 26)
    clip = out["clip"]
    assert len(clip["steps"]) == 3 and clip["n_grads"] == 29
    for step in clip["steps"]:
        assert step["syncs"] == 0 and step["scale"] < 1.0
        assert max(step["norm_err"], step["grad_err"],
                   step["param_err"]) <= cs.CLIP_RTOL
    assert windows == [({k: 0 for k in cs.COUNTERS},
                        dict.fromkeys(cs.ROUTE_COUNTERS, 0),
                        {k: 2 * 3 for k in cs.COUNTERS},
                        cs.training_routes(3, 0, layers=2, t=16,
                                           d=gpt.head_dim))]
    assert out["vision_cases"]["cases"] == 2
    assert out["vision_cases"]["eval_worst"] == 0.0
    assert sum(f["cases"] for f in out["families"].values()) == len(
        cs.UTILS_CASES) + len(cs.CONTRIB_CASES)
    assert all(f["worst"] == 0.0 for f in out["families"].values())
    assert len(cs.VISION_CASES) == 36


def test_chip_smoke_softmax_gate_catches_flushed_probabilities():
    """The softmax_ce_fwd gate is relative per probability: at 4*randn
    logits over a GPT-2 row most probabilities are below 1e-6, and a
    kernel that flushed them to 0 fails it (an absolute 1e-6 would pass)."""
    cs = _chip_smoke()
    gen = torch.Generator().manual_seed(0)
    want = torch.softmax(4 * torch.randn(4, 50257, generator=gen), -1)
    flushed = torch.where(want < 1e-6, torch.zeros_like(want), want)
    assert (flushed - want).abs().max().item() < 1e-6
    assert cs._max_rel_err(flushed, want) == 1.0 > cs.RTC_FWD_RTOL
    rounded = want * (1 + 2 ** -23)
    assert 0 < cs._max_rel_err(rounded, want) <= cs.RTC_FWD_RTOL
    zero = torch.zeros(3)
    assert cs._max_rel_err(zero, zero) == 0.0
    assert cs._max_rel_err(torch.ones(3), zero) == math.inf


def test_chip_smoke_rtc_bounds_are_the_quoted_figures():
    cs = _chip_smoke()
    for name, shape, gbytes, ms in (
            ("scale", (cs.RTC_FLAT,), 1.304, 0.389),
            ("saxpy", (cs.RTC_FLAT,), 1.956, 0.584),
            ("softmax_ce_fwd", (2048, 50257), 0.8234, 0.246),
            ("softmax_ce_bwd", (2048, 50257), 0.8234, 0.246)):
        got_ms, by = cs.rtc_bound(name, shape)
        assert by == "bytes"
        assert got_ms * cs.HBM_BYTES_PER_S / 1e12 == pytest.approx(
            gbytes, abs=5e-4)
        assert got_ms == pytest.approx(ms, abs=5e-4)
    ms, by = cs.rtc_bound("first_row", (50257, 768))
    assert by == "bytes" and ms == pytest.approx(2 * 768 * 4 / 3.35e9)


def test_chip_smoke_graph_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.graph_phase`` on the CPU at small sizes (a 2-layer GPT
    and a 2-layer BERT with dropout, small ResNets of both kinds, K=2):
    every row's ``run_superstep`` equals K eager steps bit for bit (on the
    CPU the same body runs K times), the gluon SuperStep's fused path
    equals its eager one, and each row expects the launches its model
    makes a step on the card, by counter and by CUDA function in the
    profiles (recorded here: the CPU launches no kernel)."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision

    cs = _chip_smoke()
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("max_memory_allocated", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)

    class Event:
        def __init__(self, **kw):
            pass

        def record(self):
            pass

        def elapsed_time(self, other):
            return 1.0

    monkeypatch.setattr(torch.cuda, "Event", Event)
    checks, profiled = [], []
    monkeypatch.setattr(cs, "_check_graph_launches",
                        lambda label, got, want: checks.append((label, got,
                                                                want)))
    monkeypatch.setattr(cs, "_check_profiled",
                        lambda label, rows, kernels, steps: profiled.append(
                            (label, kernels, steps)))
    layers = ([1, 1, 1, 1], [16, 32, 64, 128, 256])
    rows = cs.graph_phase(0, "cpu", mx.cpu(), mlp_b=32,
                          gpt=("gpt_decoder_117m", 97, 2, 64,
                               {"units": 128, "num_layers": 2,
                                "num_heads": 2}),
                          bert=("bert_12_768_12", 97, 2, 40,
                                {"units": 128, "hidden_size": 256,
                                 "num_layers": 2, "num_heads": 2}),
                          resnet_b=2, hw=64, resnet_layers=layers, k=2)
    assert set(rows) == {"mlp", "mlp_gluon_superstep", "gpt", "bert",
                         "resnet50_fused", "resnet50_unfused",
                         "fresh_thread"}
    for name in ("mlp", "gpt", "bert", "resnet50_fused",
                 "resnet50_unfused"):
        assert rows[name]["k"] == 2 and rows[name]["graph_ms"] > 0
        assert rows[name]["per_step"] == {}         # no kernel on the CPU
        assert rows[name]["launches"] == {}
    per_pass = cs.convs_per_pass(vision.FusedResNetV1(*layers, classes=10))
    assert rows["resnet50_fused"]["per_pass"] == per_pass > 0
    assert [c[0] for c in checks] == ["mlp", "gpt", "bert",
                                      "resnet50_fused", "resnet50_unfused"]
    flash = {f"{k}{r}": 2 for k in ("flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv") for r in ("", "_tc")}
    conv = {f"{k}{r}": per_pass for k in cs.CONV_KERNELS
            for r in ("", "_tc")}
    assert [c[2] for c in checks] == [
        {}, flash, flash, conv, {k: 0 for k in cs.CONV_KERNELS}]
    # the profiler's count of each kernel's CUDA function, K a step, in
    # the eager window and in the graph window of the GPT and fused rows
    fk = {f"{k}_tc_kernel": 2 for k in ("flash_fwd", "flash_bwd_dq",
                                        "flash_bwd_dkv")}
    ck = {f"{k}_tc_kernel": per_pass for k in cs.CONV_KERNELS}
    assert profiled == [("gpt eager window", fk, 2),
                        ("gpt graph window", fk, 2),
                        ("bert eager window", fk, 2),
                        ("bert graph window", fk, 2),
                        ("resnet50_fused eager window", ck, 2),
                        ("resnet50_fused graph window", ck, 2)]
    assert rows["mlp_gluon_superstep"]["k"] == 2


def _superstep_pair(dropout=0.3):
    from incubator_mxnet_tpu_torch import gluon
    from incubator_mxnet_tpu_torch.gluon import nn

    mx.random.seed(3)
    net = nn.HybridSequential()
    net.add(nn.Dense(16, in_units=8, activation="relu"), nn.Dropout(dropout),
            nn.Dense(4, in_units=16))
    net.initialize("xavier", ctx=mx.cpu())
    rs = np.random.RandomState(0)
    win = [rs.rand(3, 16, 8).astype(np.float32),
           rs.randint(0, 4, (3, 16)).astype(np.float32)]
    return net, gluon.loss.SoftmaxCrossEntropyLoss(), win


@pytest.mark.parametrize("engine", ["spmd", "gluon"])
def test_a_failing_capture_never_turns_into_the_eager_loop(monkeypatch,
                                                           engine):
    """With the path choice saying "graph" (as on a card) and the capture
    helper failing after a draw, ``run_superstep``/``run_window`` raise;
    no eager step runs, and the parameters, the optimizer's counts and
    the generator are as they were."""
    from incubator_mxnet_tpu_torch import gluon, parallel
    from incubator_mxnet_tpu_torch import random as prandom
    from incubator_mxnet_tpu_torch.parallel import superstep

    net, ce, win = _superstep_pair()
    gen = prandom.generator(mx.cpu())
    if engine == "spmd":
        eng = parallel.SPMDTrainer(net, ce, "sgd", {"learning_rate": 0.1})
        params = eng.params
        run = eng.run_superstep
        monkeypatch.setattr(eng, "step", lambda *a: pytest.fail(
            "the eager loop ran"))
    else:
        tr = gluon.Trainer(net.collect_params(), "adam")
        eng = tr.superstep(net, ce, window=3)
        params = dict(net.named_parameters())
        run = eng.run_window
        monkeypatch.setattr(eng, "_eager_window", lambda *a: pytest.fail(
            "the eager loop ran"))
        monkeypatch.setattr(tr, "step", lambda *a: pytest.fail(
            "the eager loop ran"))
    before = {n: p.detach().clone() for n, p in params.items()}
    state = gen.get_state()
    fa0 = fa.flash_fwd_launches

    def broken_capture(body, k, state, device, **kw):
        torch.rand(64, generator=gen)
        raise RuntimeError("capture failed")

    monkeypatch.setattr(superstep, "step_path", lambda device: "graph")
    monkeypatch.setattr(superstep, "capture_steps", broken_capture)
    with pytest.raises(RuntimeError, match="capture failed"):
        run(*win)
    assert torch.equal(gen.get_state(), state)
    assert fa.flash_fwd_launches == fa0
    for n, p in params.items():
        assert torch.equal(p.detach(), before[n]), n
    if engine == "gluon":
        assert eng.dispatch_count == 0
        assert tr._optimizer._index_update_count == {}
        assert tr._optimizer.num_update == 0


def _hybrid_phase_args(cs):
    """The hybrid phase's nets at small sizes on the CPU: a 2-layer GPT
    and ``resnet18_v1`` (10 classes, 32x32)."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo import get_gpt, vision

    mx.random.seed(0)
    gpt = get_gpt("gpt_decoder_tiny", vocab_size=97, units=64, num_layers=2,
                  max_length=16, dropout=0.0).initialize("xavier",
                                                         ctx=mx.cpu())
    resnet = vision.resnet18_v1(classes=10)
    resnet.initialize("xavier", ctx=mx.cpu())
    resnet(mx.nd.zeros((1, 3, 32, 32), ctx=mx.cpu()))
    return gpt, resnet, dict(hw=32, b=2, t=16, attention=(2, 16, 32, 2),
                             control=(2, 16, 6, 5, 3), buckets=(1, 2),
                             requests=6, threads=3, timed=False)


def test_chip_smoke_hybrid_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.hybrid_phase`` on the CPU at small sizes (a 2-layer
    GPT in fp32 then bf16, ``resnet18_v1`` at 32x32, the attention block
    at 32 units, the control flow at 16): the hybridized forward and the
    recorded step against eager (eager here: the CPU captures nothing),
    the trainer over the ParameterDict, the export of the ResNet with its
    statistics as auxiliary states and ``from_exported`` serving every
    request, the attention graph and the control flow against their
    unrolled forms. Then each check fails when its output is perturbed."""
    from incubator_mxnet_tpu_torch import contrib, gluon
    from incubator_mxnet_tpu_torch.gluon import block as gblock

    cs = _chip_smoke()
    gpt, resnet, kw = _hybrid_phase_args(cs)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = cs.hybrid_phase(0, "cpu", mx.cpu(), gpt, resnet, **kw)
        for name in ("fp32", "bf16"):
            row = out["gpt"][name]
            assert row["captures"] == row["pairs"] == 0
            assert row["forward_bit_equal"]
            assert row["grads_bit_equal"] == row["n_grads"] == 29
        assert len(out["gpt"]["fp32"]["trainer_losses"]) == 1
        assert out["gpt"]["fp32"]["trainer_params"] == 29
        assert out["resnet"]["aux"] == 2 * 20
        assert out["resnet"]["buckets"] == [1, 2]
        assert out["resnet"]["row_err"] <= cs.SERVE_RTOL
        assert out["attention"]["ops"][-3:] == ["flash_attention",
                                                "transpose", "reshape"]
        assert set(out["control"]) == {"foreach", "while_loop", "cond"}
        assert out["flash_routes"]["flash_fwd_f32"] == 0  # the CPU
        # a perturbed output fails its check
        forward = gluon.SymbolBlock.forward
        monkeypatch.setattr(
            gluon.SymbolBlock, "forward",
            lambda self, *a: forward(self, *a) * (1 + 1e-3))
        with pytest.raises(AssertionError, match="exported"):
            cs.export_attention_part(0, "cpu", mx.cpu(),
                                     *kw["attention"])
        monkeypatch.undo()
        foreach = contrib.foreach
        monkeypatch.setattr(
            contrib, "foreach",
            lambda *a, **k: (lambda o, h: (o * 1.001, h))(*foreach(*a, **k)))
        with pytest.raises(AssertionError, match="foreach"):
            cs.control_flow_part(0, "cpu", mx.cpu(), *kw["control"])
        monkeypatch.undo()
        call = gblock.HybridBlock._call
        monkeypatch.setattr(
            gblock.HybridBlock, "_call",
            lambda self, *a, **k: (lambda o: o * 1.01 if self._active
                                   and self is gpt else o)(
                                       call(self, *a, **k)))
        with pytest.raises(AssertionError, match="hybridized GPT"):
            cs.hybrid_gpt_part(0, "cpu", gpt, mx.cpu(), torch.bfloat16, 2,
                               16, timed=False)
    finally:
        torch.set_num_threads(threads)


def test_chip_smoke_ssd_amp_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.ssd_amp_phase`` on the CPU at a small batch: the fp16
    flash checks at small shapes (plain versions here), the AMP step of a
    2-layer GPT against its CPU copy, the bf16 Adam steps under
    ``init_trainer``/``scale_loss`` with a falling loss, the fp16 step and
    the injected overflow, ``multi_precision`` Adam and LAMB, the nine
    optimizers (here CPU against CPU), the SPMDTrainer optax rules,
    SSD-300 at B=1 (eager, the window, the AMP route, detection) and the
    14 detection ops. Then a perturbed detection result and a perturbed
    AMP cast each fail their check."""
    from incubator_mxnet_tpu_torch import amp
    from incubator_mxnet_tpu_torch.ops import detection as det

    cs = _chip_smoke()
    monkeypatch.setattr(cs, "device_ms", lambda fn, **k: (fn(), 0.0)[1])
    monkeypatch.setattr(cs, "_sdpa_bwd_ms", lambda *a, **k: 0.0)
    mx.random.seed(0)
    gpt = get_gpt("gpt_decoder_tiny", vocab_size=97, units=64, num_layers=2,
                  max_length=16, dropout=0.0).initialize("xavier",
                                                         ctx=mx.cpu())
    cases = [("train_causal_B2_T64", 2, 64, 64, 64, True, False, None),
             ("bert_lengths_B3_T32", 3, 32, 32, 64, False, False, "bert"),
             ("decode_S2_Tk64", 2, 1, 64, 64, True, True, (64, 9))]
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = cs.ssd_amp_phase(0, "cpu", mx.cpu(), gpt, gpt_b=2, gpt_t=16,
                               ssd_b=1, ssd_k=2, fp16_cases=cases,
                               timed=False)
        assert [r["kernel"] for r in out["fp16"]] == [
            "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_fwd",
            "flash_bwd_dq", "flash_bwd_dkv", "flash_fwd"]
        assert out["amp"]["losses"][-1] < out["amp"]["losses"][0]
        assert out["amp"]["overflow_scale"] == out["amp"]["fp16_scale"] / 2
        assert set(out["multi_precision"]) == {"adam", "lamb"}
        assert len([k for k in out["optimizers"] if k != "sgld_noise"]) \
            == len(cs.OPT_RULES)
        assert set(out["spmd_optax"]) == {"lamb", "rmsprop", "adagrad"}
        assert out["ssd"]["anchors"] == 8732
        assert out["ssd"]["amp_losses"][-1] < out["ssd"]["amp_losses"][0]
        assert len(out["detection"]) == 14
        # a detection result perturbed on one side fails its check
        real = det.box_nms
        calls = []

        def once(*a, **k):
            calls.append(1)
            got = real(*a, **k)
            return got + 1e-3 if len(calls) == 1 else got

        monkeypatch.setattr(det, "box_nms", once)
        with pytest.raises(AssertionError, match="detection box_nms"):
            cs.detection_checks(0, torch.device("cpu"))
        monkeypatch.undo()
        monkeypatch.setattr(cs, "device_ms", lambda fn, **k: (fn(), 0.0)[1])
        # an AMP policy that casts the target ops to fp32 fails the phase
        dtype_of = amp.AmpPolicy.dtype_of
        monkeypatch.setattr(
            amp.AmpPolicy, "dtype_of",
            lambda self, name, *a: torch.float32 if name in self.target_ops
            else dtype_of(self, name, *a))
        with pytest.raises(AssertionError, match="amp: logits"):
            cs.gpt_amp_part(0, "cpu", gpt, mx.cpu(), 2, 16, 1, timed=False)
    finally:
        torch.set_num_threads(threads)
