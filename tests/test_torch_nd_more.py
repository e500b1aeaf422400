"""Port parity: the JAX package's ``ops/more.py`` through ``mx.nd``.

The per-parameter samplers, the image ops (``mx.nd.image``), LRN,
softmin, the masked softmaxes, identity, ``stop_gradient_op``, ``add_n``,
``argmax_channel``, ``Crop``, ``im2col``/``col2im``, ``Correlation``,
``DeformableConvolution``, ``CTCLoss``, the interleaved transformer
matmuls, the shape and index stragglers, ``SVMOutput`` and the contrib ops.
Every case of ``chip_smoke.MORE_CASES`` of those families (numpy inputs
from a seed, the table ``chip_smoke.py`` also runs on the card against the
port on the CPU) goes through the JAX package's ``mx.nd`` and the port's,
the port on the CPU, with the gradient of ``sum(out * w)`` where the case
names inputs to differentiate. Tolerances: ``chip_smoke.ND_TOL`` (1e-5
relative, 1e-6 absolute: fp32 in another order of operations); indices,
crops, flips, im2col/col2im on integer values and the index ops bit for
bit; ``CTC_FAR`` (5e-3 absolute) for the gradient of an alignment that
cannot be made, a difference of path costs near 1e5, where fp32 steps by
0.0078. Each trap where the reference's answer is not PyTorch's default
is a test of its own. The samplers are held by their statistics in
``tests/test_torch_nd_random.py``.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.ops import registry as jregistry

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch.ops import registry

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()
FAMILIES = ("image", "nn", "layout", "vision", "ctc", "attention", "shape",
            "contrib")
CASES = {c.id: c for c in cs.MORE_CASES if c.family in FAMILIES}

# the JAX package's ops/more.py (its alias block came in earlier): 46 ops
MORE_OPS = [
    "AdaptiveAvgPooling2D", "BatchNormWithReLU", "CTCLoss", "Correlation",
    "Crop", "DeformableConvolution", "LRN", "SVMOutput", "add_n",
    "arange_like", "argmax_channel", "broadcast_like",
    "choose_element_0index", "col2im", "div_sqrt_dim", "fill_element_0index",
    "gradientmultiplier", "identity", "im2col", "image_crop",
    "image_flip_left_right", "image_flip_top_bottom", "image_normalize",
    "image_random_flip_left_right", "image_resize", "image_to_tensor",
    "index_copy", "interleaved_matmul_encdec_qk",
    "interleaved_matmul_encdec_valatt", "interleaved_matmul_selfatt_qk",
    "interleaved_matmul_selfatt_valatt", "masked_log_softmax",
    "masked_softmax", "nan_to_num", "quadratic", "requantize",
    "reshape_like", "sample_exponential", "sample_gamma",
    "sample_negative_binomial", "sample_normal", "sample_poisson",
    "sample_uniform", "softmin", "sparse_retain_rows", "stop_gradient_op"]
RANDOM_OPS = [
    "random_bernoulli", "random_exponential", "random_gamma",
    "random_generalized_negative_binomial", "random_negative_binomial",
    "random_normal", "random_pdf_dirichlet", "random_pdf_exponential",
    "random_pdf_gamma", "random_pdf_generalized_negative_binomial",
    "random_pdf_negative_binomial", "random_pdf_normal",
    "random_pdf_poisson", "random_pdf_uniform", "random_poisson",
    "random_randint", "random_uniform", "sample_multinomial", "shuffle"]
OPTIMIZER_OPS = [
    "adam_update", "adamw_update", "all_finite", "amp_cast",
    "amp_multicast", "ftml_update", "ftrl_update", "lamb_update_phase1",
    "lamb_update_phase2", "mp_lamb_update_phase1", "mp_lamb_update_phase2",
    "mp_nag_mom_update", "mp_sgd_mom_update", "mp_sgd_update",
    "multi_all_finite", "multi_lars", "multi_mp_sgd_mom_update",
    "multi_mp_sgd_update", "multi_sgd_mom_update", "multi_sgd_update",
    "multi_sum_sq", "nag_mom_update", "preloaded_multi_mp_sgd_mom_update",
    "preloaded_multi_mp_sgd_update", "preloaded_multi_sgd_mom_update",
    "preloaded_multi_sgd_update", "reset_arrays", "rmsprop_update",
    "rmspropalex_update", "sgd_mom_update", "sgd_update", "signsgd_update",
    "signum_update"]
# the ops the samplers' statistics hold (test_torch_nd_random.py)
BY_STATISTICS = {
    "random_uniform", "random_normal", "random_gamma", "random_exponential",
    "random_poisson", "random_bernoulli", "random_randint",
    "random_negative_binomial", "random_generalized_negative_binomial",
    "sample_uniform", "sample_normal", "sample_gamma", "sample_exponential",
    "sample_poisson", "sample_negative_binomial", "sample_multinomial",
    "shuffle", "image_random_flip_left_right"}

# the names of the reference's mx.nd that this slice's ops back
SLICE_ND_NAMES = [
    "CTCLoss", "Correlation", "Crop", "DeformableConvolution",
    "ElementWiseSum", "LRN", "SVMOutput", "adam_update", "adamw_update",
    "add_n", "all_finite", "amp_cast", "amp_multicast", "arange_like",
    "argmax_channel", "broadcast_like", "choose_element_0index", "col2im",
    "contrib", "ctc_loss", "fill_element_0index", "ftml_update",
    "ftrl_update", "identity", "im2col", "image", "index_copy",
    "interleaved_matmul_encdec_qk", "interleaved_matmul_encdec_valatt",
    "interleaved_matmul_selfatt_qk", "interleaved_matmul_selfatt_valatt",
    "lamb_update_phase1", "lamb_update_phase2", "masked_log_softmax",
    "masked_softmax", "mp_nag_mom_update", "mp_sgd_mom_update",
    "mp_sgd_update", "multi_all_finite", "multi_sgd_mom_update",
    "multi_sgd_update", "multi_sum_sq", "nag_mom_update", "nan_to_num",
    "normal", "random", "random_normal", "random_pdf_dirichlet",
    "random_pdf_exponential", "random_pdf_gamma",
    "random_pdf_generalized_negative_binomial",
    "random_pdf_negative_binomial", "random_pdf_normal",
    "random_pdf_poisson", "random_pdf_uniform", "random_uniform",
    "reset_arrays", "reshape_like", "rmsprop_update", "rmspropalex_update",
    "sample_exponential", "sample_gamma", "sample_multinomial",
    "sample_negative_binomial", "sample_normal", "sample_poisson",
    "sample_uniform", "sgd_mom_update", "sgd_update", "shuffle",
    "signsgd_update", "signum_update", "softmin", "sparse_retain_rows",
    "stop_gradient_op", "uniform"]
SLICE_SUBMODULE_NAMES = {
    "random": ["bernoulli", "categorical", "exponential", "gamma",
               "multinomial", "normal", "poisson", "randint", "shuffle",
               "uniform"],
    "image": ["crop", "flip_left_right", "flip_top_bottom", "normalize",
              "random_flip_left_right", "resize", "to_tensor"],
    "contrib": ["AdaptiveAvgPooling2D", "BatchNormWithReLU",
                "BilinearResize2D", "DeformableConvolution", "ROIAlign",
                "SparseEmbedding", "arange_like", "ctc_loss", "div_sqrt_dim",
                "gradientmultiplier", "index_array", "index_copy",
                "quadratic", "requantize"]}


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with mx.cpu():
        yield


def _reference(case):
    return cs.run_nd_case(jmx, case, raw_array_kwargs=True)


@pytest.mark.parametrize("case", list(CASES.values()), ids=list(CASES))
def test_more_op_matches_jax(case):
    cs.check_nd_case(case, cs.run_nd_case(mx, case), _reference(case))


def test_trap_ctc_impossible_alignment_is_finite():
    case = CASES["CTCLoss_impossible"]
    for loss in (cs.run_nd_case(mx, case)[0], _reference(case)[0]):
        assert np.all(np.isfinite(loss))
        # log(0) is optax's -1e5: about 1e5 where the labels cannot align
        assert 1e5 < loss[2] < 1.001e5 and loss[:2].max() < 100
    # PyTorch's own CTC gives inf there
    data = torch.from_numpy(cs._CTC).log_softmax(-1)
    assert torch.isinf(F.ctc_loss(
        data[:4, 2:], torch.tensor([[2, 2, 2, 2, 4]]), torch.tensor([4]),
        torch.tensor([5]), reduction="none"))[0]


def test_trap_ctc_feasible_matches_pytorch_ctc():
    case = CASES["ctc_loss_lengths"]
    got = cs.run_nd_case(mx, case)[0]
    data = torch.from_numpy(cs._CTC).log_softmax(-1)
    labels = torch.from_numpy(np.where(cs._CTC_LABELS < 0, 0,
                                       cs._CTC_LABELS)).long()
    want = F.ctc_loss(data, labels, torch.tensor([6, 5, 6]),
                      torch.tensor([2, 3, 1]), reduction="none")
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5)


@pytest.mark.parametrize("name", ["masked_softmax_empty_row",
                                  "masked_log_softmax_empty_row"])
def test_trap_fully_masked_row(name):
    empty = 0.0 if name.startswith("masked_softmax") else -np.inf
    for out, grad in (cs.run_nd_case(mx, CASES[name]),
                      _reference(CASES[name])):
        assert np.all(out[1] == empty)
        assert np.all(np.isfinite(grad)) and np.all(grad[1] == 0)
        # a masked position of a partial row gets no gradient either
        assert grad[0, 2] == 0 and grad[2, 1:].tolist() == [0, 0, 0]


def test_trap_resize_downscale_is_antialiased():
    got = cs.run_nd_case(mx, CASES["resize_down_antialiased"])[0]
    plain = F.interpolate(torch.from_numpy(cs._HWC).permute(2, 0, 1)[None],
                          size=(4, 4), mode="bilinear", align_corners=False)
    assert np.abs(got - plain[0].permute(1, 2, 0).numpy()).max() > 0.05


def test_trap_resize_nearest_has_half_pixel_centres():
    got = cs.run_nd_case(mx, CASES["resize_nearest"])[0]
    legacy = F.interpolate(torch.from_numpy(cs._NHWC).permute(0, 3, 1, 2),
                           size=(3, 4), mode="nearest")
    assert not np.array_equal(got, legacy.permute(0, 2, 3, 1).numpy())


def test_trap_random_flip_is_one_coin_for_the_batch():
    imgs = cs._NHWC
    for pkg in (mx, jmx):
        x = pkg.nd.array(imgs)
        flips = 0
        for _ in range(200):
            got = pkg.nd.image.random_flip_left_right(x).asnumpy()
            if np.array_equal(got, imgs[:, :, ::-1]):
                flips += 1
            else:
                np.testing.assert_array_equal(got, imgs)
        assert abs(flips - 100) <= 5 * np.sqrt(50), (pkg.__name__, flips)


def test_trap_sample_uniform_is_the_per_parameter_sampler():
    for reg in (registry, jregistry):
        op = reg.get("sample_uniform")
        assert op.fn.__module__.endswith("ops.more") and op.needs_rng
        assert reg.get("sample_normal").fn.__module__.endswith("ops.more")
        assert reg.get("gamma").name == "gamma"          # the unary Γ
        assert reg.get("gamma_sample").name == "random_gamma"
    for pkg in (mx, jmx):
        out = pkg.nd.sample_uniform(pkg.nd.array([0.0, 10.0]),
                                    pkg.nd.array([1.0, 11.0]), shape=(3,))
        got = out.asnumpy()
        assert got.shape == (2, 3) and (got[0] < 1).all() \
            and (got[1] >= 10).all()


def test_trap_correlation_reads_neither_kernel_size_nor_stride1():
    case = CASES["Correlation_ignores_kernel_size"]
    plain = case._replace(kwargs=dict(max_displacement=1))
    np.testing.assert_array_equal(cs.run_nd_case(mx, case)[0],
                                  cs.run_nd_case(mx, plain)[0])


def test_trap_custom_backwards_ignore_or_scale_the_head():
    x = cs._X
    for pkg in (mx, jmx):
        nd = pkg.nd
        a = nd.array(x)
        a.attach_grad()
        with pkg.autograd.record():
            y = nd.contrib.gradientmultiplier(a, scalar=-0.5) * 3.0
        y.backward()
        np.testing.assert_allclose(a.grad.asnumpy(), np.full_like(x, -1.5))
        grads = []
        for head in (1.0, 7.0):
            b = nd.array(x)
            b.attach_grad()
            with pkg.autograd.record():
                z = nd.SVMOutput(b, nd.array([1.0, 3.0, 0.0]), margin=0.5) \
                    * head
            z.backward()
            grads.append(b.grad.asnumpy())
        # SVMOutput's backward is the hinge gradient whatever the head's
        np.testing.assert_array_equal(grads[0], grads[1])
        assert grads[0][0, 1] < 0 and grads[0].sum() == 0


def test_trap_return_types():
    arr = mx.nd.array(cs._NCHW)
    assert mx.nd.argmax_channel(arr).dtype == np.float32
    img = mx.nd.array(np.full((4, 5, 3), 255, np.uint8), dtype="uint8")
    chw = mx.nd.image.to_tensor(img)
    assert chw.dtype == np.float32 and chw.shape == (3, 4, 5)
    np.testing.assert_array_equal(chw.asnumpy(), 1.0)


def test_make_loss_stays_the_misc_op():
    # the port's MakeLoss is ops/misc.py's op (ROADMAP.md section 3)
    assert registry.get("MakeLoss").fn.__module__.endswith("ops.misc")


def test_every_slice_op_is_registered_and_covered():
    assert len(MORE_OPS) == len(set(MORE_OPS)) == 46
    assert len(RANDOM_OPS) == 19 and len(OPTIMIZER_OPS) == 33
    slice_ops = set(MORE_OPS + RANDOM_OPS + OPTIMIZER_OPS)
    assert len(slice_ops) == 98
    assert slice_ops <= set(registry.list_ops())
    assert slice_ops <= set(jregistry.list_ops())
    for name in slice_ops:
        assert registry.get(name).needs_rng == jregistry.get(name).needs_rng
        assert registry.get(name).differentiable == \
            jregistry.get(name).differentiable, name
    covered = set(BY_STATISTICS)
    for case in list(cs.MORE_CASES) + list(cs.UPDATE_CASES):
        name = case.name[3:] if case.name.startswith("op:") else \
            cs._nd_fn(mx, case.name).__name__
        covered.add(registry.get(name).name)
    covered.add("reset_arrays")         # test_torch_nd_update.py, in place
    assert slice_ops <= covered, sorted(slice_ops - covered)


def test_mx_nd_has_every_name_the_slice_backs():
    assert set(SLICE_ND_NAMES) <= set(dir(jmx.nd))
    assert [n for n in SLICE_ND_NAMES if not hasattr(mx.nd, n)] == []
    for sub, names in SLICE_SUBMODULE_NAMES.items():
        assert set(names) <= set(dir(getattr(jmx.nd, sub))), sub
        assert [n for n in names
                if not hasattr(getattr(mx.nd, sub), n)] == [], sub
    assert len(SLICE_SUBMODULE_NAMES["contrib"]) == 14
    assert mx.nd.random.gamma.__name__ == "gamma_sample"
    assert mx.nd.gamma.__name__ == "gamma"
    assert mx.nd.BlockGrad is mx.nd.stop_gradient
