"""AMP op lists (reference ``python/mxnet/amp/lists/symbol_fp16.py``).

The port's own copy of the JAX package's ``amp/lists.py``: the same op
names and classes (the port's registered ops and ``mx.nd`` methods carry
the reference's names). Three classes, reference semantics:
- ``TARGET_DTYPE_OPS``: run in the low-precision dtype (the matrix products);
- ``FP32_OPS``: always fp32 (numerically sensitive);
- ``WIDEST_TYPE_CASTS``: run in the widest dtype among inputs.

With bfloat16 (fp32's exponent range) loss scaling is optional; with
float16 the loss scaler (``loss_scaler.py``) keeps small gradients from
flushing to zero.
"""

TARGET_DTYPE_OPS = [
    "FullyConnected", "Convolution", "Deconvolution", "dot", "batch_dot",
    "matmul", "scaled_dot_product_attention", "linalg_gemm2",
]

FP32_OPS = [
    "softmax", "log_softmax", "softmax_cross_entropy", "SoftmaxOutput",
    "BatchNorm", "LayerNorm", "InstanceNorm", "GroupNorm", "RMSNorm",
    "L2Normalization", "norm", "mean", "sum", "exp", "log", "erf",
    "erfinv", "logsumexp", "cumsum",
]

# [(op_name, param_name, [values])]: run fp32 only when the attribute takes
# one of the listed values (reference CONDITIONAL_FP32_FUNCS — e.g.
# softrelu activation overflows exp() in fp16)
CONDITIONAL_FP32_OPS = [
    ("Activation", "act_type", ["softrelu"]),
]

WIDEST_TYPE_CASTS = [
    "add", "subtract", "multiply", "divide", "broadcast_add",
    "broadcast_sub", "broadcast_mul", "broadcast_div", "concat", "stack",
    "where", "maximum", "minimum",
]
