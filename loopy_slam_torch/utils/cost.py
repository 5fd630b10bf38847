"""FLOP and byte count of the device work a piece of the port runs: the
port's counterpart of XLA's cost analysis (HloCostAnalysis), which the JAX
package's LoopySLAM.roofline reads.

    with CostCounter() as cc:
        ...   # forward, backward: any tensor work
    cc.flops, cc.transcendentals, cc.bytes

CostCounter is a TorchDispatchMode: it sees every aten op that runs while
it is active, autograd's backward included (the engine carries the mode
over to the backward thread it runs CUDA work on), and adds, from shapes
and dtypes alone (no device read, no sync), with XLA's conventions:

  * products (mm, bmm, addmm, baddbmm, mv, dot: what linear, matmul and
    einsum reach the dispatcher as): 2*M*N*K flops, also summed in
    `products`; addmm and baddbmm add one flop per output element for
    their bias term;
  * elementwise arithmetic, compares and selects: 1 flop per output
    element; exp, log, sigmoid, tanh, pow, sqrt, rsqrt, sin, cos, erf,
    softplus and the like: 1 transcendental per output element instead
    (logaddexp 2: an exp and a log); a dtype conversion 1 flop per
    element (XLA's convert); a draw from a random generator 1 flop per
    element;
  * reductions (sum, mean, amax, ...) and scans (cumsum, cumprod): 1 flop
    per input element; sorts n*ceil(log2 n) (XLA's HandleSort);
  * gathers, scatters, index_select, index_add_, cat, copies and fills:
    0 flops;
  * views, reshapes, expand, detach and other metadata ops: nothing.

Bytes: numel * itemsize of each tensor input plus each output, op by op,
as eager PyTorch runs them (XLA counts a fusion's operands and outputs
only, so its bytes are lower for the same function). An in-place op's
tensor is read and written; a gather counts twice its output plus its
indices and a scatter three times its updates plus its indices (XLA's
conventions: neither reads the whole table); a fill or a factory writes
its output only; copy_ reads its source and writes its destination.

Work that no dispatch mode sees is reported by its caller through
`report` (ops/knn.query: the k-NN kernel, launched through ctypes;
models/track_render: the tracker's render kernels); the
caller runs its plain version `uncounted`, so that the CPU count and the
card's agree. Host work (numpy) is not device work and is not counted.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_flatten

_PRODUCTS = {"mm", "bmm", "addmm", "baddbmm", "mv", "addmv", "dot"}
# transcendentals per output element (XLA's split of exp, log, pow, ...)
_TRANSCENDENTAL = {
    "exp": 1, "exp2": 1, "expm1": 1, "log": 1, "log1p": 1, "log2": 1,
    "log10": 1, "sigmoid": 1, "tanh": 1, "pow": 1, "sqrt": 1, "rsqrt": 1,
    "sin": 1, "cos": 1, "tan": 1, "asin": 1, "acos": 1, "atan": 1,
    "atan2": 1, "sinh": 1, "cosh": 1, "asinh": 1, "acosh": 1, "atanh": 1,
    "erf": 1, "erfc": 1, "erfinv": 1, "softplus": 1, "logit": 1,
    "log_sigmoid_forward": 1, "xlogy": 1, "logaddexp": 2, "logaddexp2": 2}
# flops per output element of elementwise ops that do several operations
_COMPOUND = {"addcmul": 2, "addcdiv": 2, "lerp": 2, "sigmoid_backward": 3,
             "tanh_backward": 3, "softplus_backward": 3, "hypot": 3}
# softplus_backward also takes an exp of its input
_COMPOUND_TRANSCENDENTAL = {"softplus_backward": 1}
_POINTWISE = {
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "sign", "sgn",
    "reciprocal", "square", "floor", "ceil", "round", "trunc", "frac",
    "remainder", "fmod", "floor_divide", "maximum", "minimum", "fmax",
    "fmin", "clamp", "clamp_min", "clamp_max", "where", "masked_fill",
    "eq", "ne", "lt", "le", "gt", "ge", "logical_and", "logical_or",
    "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "bitwise_left_shift",
    "bitwise_right_shift", "__and__", "__or__", "__xor__", "__lshift__",
    "__rshift__", "relu", "threshold", "threshold_backward", "isnan",
    "isinf", "signbit", "nan_to_num", "copysign", "heaviside"}
_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "aminmax", "argmax",
    "argmin", "prod", "all", "any", "norm", "linalg_vector_norm", "var",
    "std", "var_mean", "std_mean", "logsumexp", "count_nonzero", "nansum",
    "equal"}
_SCANS = {"cumsum", "cumprod", "logcumsumexp", "cummax", "cummin"}
_SORTS = {"sort", "argsort", "topk", "kthvalue", "median", "nanmedian",
          "msort", "mode", "unique", "_unique", "_unique2",
          "unique_consecutive", "unique_dim"}
_GATHERS = {"index", "index_select", "gather", "embedding", "take",
            "masked_select"}
_SCATTERS = {"index_put", "_index_put_impl", "index_add", "index_copy",
             "scatter", "scatter_add", "scatter_reduce", "index_reduce",
             "masked_scatter", "index_fill", "put"}
# zero flops, inputs read and outputs written (the *_backward ones put a
# view's gradient into zeros of the base's shape)
_COPIES = {"clone", "cat", "stack", "repeat", "flip", "roll", "tril",
           "triu", "constant_pad_nd", "select_backward", "slice_backward",
           "diagonal_backward", "unfold_backward", "select_scatter",
           "slice_scatter", "diagonal_scatter", "as_strided_scatter"}
# zero flops, outputs written only
_FILLS = {"fill", "zero", "zeros", "zeros_like", "ones", "ones_like", "full",
          "full_like", "new_zeros", "new_ones", "new_full", "scalar_tensor",
          "arange", "linspace", "eye"}
_RANDOM = {"randn", "randn_like", "rand", "rand_like", "randint",
           "randint_like", "randperm", "normal", "uniform", "bernoulli",
           "random", "multinomial", "exponential"}
# nothing moved, nothing computed
_META = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "lift_fresh", "_local_scalar_dense", "detach",
         "alias", "set", "resize", "record_stream", "is_nonzero",
         "is_same_size", "_has_compatible_shallow_copy_type", "sym_size",
         "sym_stride", "sym_numel", "sym_storage_offset", "_reshape_alias",
         "_unsafe_view"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _kind(func) -> tuple:
    """(kind, base name, in place) of an aten op overload."""
    name = func.name().split("::")[-1].split(".")[0]
    inplace = name.endswith("_") and not name.endswith("__")
    base = name[:-1] if inplace else name
    tags = set(func.tags)
    if base in _PRODUCTS:
        kind = "product"
    elif func.is_view or base in _META:
        kind = "meta"
    elif base == "copy":
        kind = "copy_"
    elif base == "_to_copy":
        kind = "convert"
    elif base in _GATHERS:
        kind = "gather"
    elif base in _SCATTERS:
        kind = "scatter"
    elif base in _COPIES:
        kind = "copy"
    elif base in _FILLS:
        kind = "fill"
    elif base in _RANDOM:
        kind = "random"
    elif base in _TRANSCENDENTAL or base in _COMPOUND:
        kind = "pointwise"
    elif base in _SCANS:
        kind = "scan"
    elif base in _SORTS:
        kind = "sort"
    elif base in _REDUCTIONS or torch.Tag.reduction in tags:
        kind = "reduction"
    elif base in _POINTWISE or torch.Tag.pointwise in tags:
        kind = "pointwise"
    else:
        kind = "other"
    return kind, base, inplace


class CostCounter(TorchDispatchMode):
    """Sums flops, transcendentals and bytes over the aten ops that run
    while it is active (see the module's docstring for the conventions).
    `products` holds the products' share of flops; `reported` the work
    callers reported by kind ({kind: [flops, bytes]}); `unclassified` the
    names of ops that fell under no rule (their bytes are counted, their
    flops are not)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.transcendentals = 0
        self.bytes = 0
        self.products = 0
        self.reported: Dict[str, List[int]] = {}
        self.unclassified: set = set()
        self._paused = 0
        self._kinds: Dict[object, tuple] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._paused:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        k = self._kinds.get(func)
        if k is None:
            k = self._kinds[func] = _kind(func)
        kind, base, inplace = k
        if kind == "meta":
            return
        ins = _tensors((args, {n: v for n, v in kwargs.items()
                               if n != "out"}))
        outs = _tensors(out)
        flops = trans = 0
        nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        n_out = sum(t.numel() for t in outs)
        if kind == "product":
            a, b = args[-2], args[-1]  # mm(a, b); addmm(c, a, b); ...
            prod = 2 * a.numel() * b.shape[-1] if b.dim() > 1 \
                else 2 * a.numel()
            flops = prod + (n_out if base in ("addmm", "baddbmm",
                                              "addmv") else 0)
            self.products += prod
        elif kind == "pointwise":
            trans = _TRANSCENDENTAL.get(base, 0) * n_out \
                + _COMPOUND_TRANSCENDENTAL.get(base, 0) * n_out
            if base not in _TRANSCENDENTAL:
                flops = _COMPOUND.get(base, 1) * n_out
            elif base == "logaddexp":
                flops = n_out
        elif kind in ("reduction", "scan"):
            flops = ins[0].numel() if ins else 0
        elif kind == "sort":
            n = ins[0].numel() if ins else 0
            flops = n * max(math.ceil(math.log2(n)), 1) if n > 1 else 0
        elif kind == "convert":
            if ins and outs and ins[0].dtype != outs[0].dtype:
                flops = n_out
        elif kind == "random":
            flops = n_out
            nbytes = sum(map(_nbytes, outs))
        elif kind == "fill":
            nbytes = sum(map(_nbytes, outs))
        elif kind == "copy_":
            nbytes = 2 * _nbytes(outs[0]) if outs else 0
        elif kind == "gather":
            nbytes = 2 * sum(map(_nbytes, outs)) + sum(map(_nbytes, ins[1:]))
        elif kind == "scatter":
            updates = ins[-1] if len(ins) > 1 else None
            idx = ins[1:-1] if len(ins) > 2 else []
            nbytes = (3 * (_nbytes(updates) if updates is not None else 0)
                      + sum(map(_nbytes, idx)))
            if not inplace:  # the out-of-place form copies the whole table
                nbytes += _nbytes(ins[0]) + sum(map(_nbytes, outs))
        elif kind == "other":
            self.unclassified.add(base)
        self.flops += flops
        self.transcendentals += trans
        self.bytes += nbytes

    def add(self, kind: str, flops: int, nbytes: int,
            transcendentals: int = 0, products: int = 0):
        """Count work no dispatch mode sees (a kernel launched outside
        PyTorch's dispatcher) under `kind`; `products` is the share of
        `flops` in matrix products."""
        self.flops += flops
        self.bytes += nbytes
        self.transcendentals += transcendentals
        self.products += products
        row = self.reported.setdefault(kind, [0, 0])
        row[0] += flops
        row[1] += nbytes

    @contextlib.contextmanager
    def paused(self):
        """Stop counting inside the block."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1


def active() -> List[CostCounter]:
    """The CostCounters active on this thread."""
    return [m for m in _get_current_dispatch_mode_stack()
            if isinstance(m, CostCounter)]


def report(kind: str, flops: int, nbytes: int, transcendentals: int = 0,
           products: int = 0) -> None:
    """Add work no dispatch mode sees to every active counter."""
    for c in active():
        c.add(kind, flops, nbytes, transcendentals, products)


@contextlib.contextmanager
def uncounted():
    """Pause every active counter inside the block (a kernel's plain
    version, whose work its caller reports as the kernel's)."""
    with contextlib.ExitStack() as stack:
        for c in active():
            stack.enter_context(c.paused())
        yield
