"""The density compiler: any log density of the model DSL as a CUDA functor
that K3 and K4 run (the counterpart of ``binf_tpu/ops/pallas/
tile_interpreter.py::eval_jaxpr_lanes`` and ``binf_tpu/ops/pallas/
fused_potential.py::tile_potential_from_scalar``).

The JAX package traces a log density to a jaxpr and evaluates it, op by op,
inside its Pallas kernels.  Here :func:`compile_density` traces the negated
density over flat positions (``pack_template``'s order) with
``make_fx(functionalize(grad_and_value(...)), tracing_mode="fake")``: one
aten graph that holds the potential and its gradient, the data lifted into
constants.  It then

- folds every node that does not depend on the position into a constant,
  and packs the constants into one float32 operand buffer (integers as
  their bit patterns), whose offsets become literals of the emitted code;
  Python scalars of the graph become literals too;
- lowers each remaining node to C++ over a chain's per-thread values of
  static shape: an elementwise node or a reduction's output of at most
  ``SCALARS`` elements becomes that many scalars, an elementwise or
  index-remapping node of more is evaluated where it is used, and a
  reduction is a nest over its terms (unrolled in the text up to
  ``UNROLL`` a dimension).  Reductions over the same terms that do not
  depend on each other share one nest, so ``sum(log_prob(data,
  f(theta)))`` and its gradient (the mv of the backward pass) are one loop
  over the data rows with scalar temporaries: no per-chain buffer of n
  rows exists, and a row's temporaries die with its iteration;
- counts the float operations of one evaluation (for the kernels' bound).

The result is a header (``CompiledDensity.source``) defining a functor
``binf::Traced_<key>`` on ``csrc/traced_density.cuh``; ``_build`` compiles
it into K3's and K4's units of one shape.  The key hashes the emitted text,
which depends on the graph, its shapes and its literals but not on the
data: a new data set of the same shapes reuses the built unit.  The same
schedule is emitted a second time as the group form K7 runs
(``TracedGroup_<key>``, ``group_source``, following the one-lane text in
the same header): every thread of a chain's group of warps calls it, the
outermost runtime loop of each float sum, max or min nest (the data rows)
strides over the group's threads, the partials meet in the group's sums
(``grp.sum``/``grp.max``/``grp.min``: the same bits in every thread), and
everything else is computed in every thread; rank 0 writes the gradient
before the group's barrier.  The one-lane text, and so the key, does not
depend on the group form.

Past ``MAX_D`` coordinates (up to ``MAX_D_WIDE``) the header holds the wide
form alone (``TracedWide_<key>``, ``CompiledDensity.wide``): the one-lane
functor's unrolled scalars and per-thread copies of the position do not
fit a thread there.  It is the group form with the position read from the
group's shared buffer where it is used, loops past ``WIDE_UNROLL`` strided
over the group, and the gradient one runtime loop over the coordinates
strided the same way (each thread writes its own of ``gs``).  K3's and
K4's wide branches run it a group of W warps a chain
(``csrc/fused_wide.cuh``: one warp up to 256 coordinates, up to 8 past
them) and K7 a group of warps a chain; its key hashes its own text.

Op scope (parity with the JAX interpreter's ``_ELEMENTWISE`` and
``_RULES``): elementwise arithmetic, comparisons, logical ops, ``where``,
``clamp``, casts (integer casts have no gradient, as in aten), the
transcendentals the DSL uses with their backward ops (``exp``, ``log``,
``log1p``, ``expm1``, ``lgamma``, ``digamma``, ``erf``, ``erfc``,
``sigmoid``, ``tanh``, ``softplus`` through its decomposition,
``polygamma`` of order 0 and 1, ...);
views, ``expand``, slices and selects and their backward ops, ``cat``,
``stack``, ``constant_pad_nd``, ``flip``, ``diagonal``; reductions (sum,
prod, amax/amin, max/min, any/all, ``logsumexp``, argmax/argmin); ``mv``,
``mm``, ``dot``, ``bmm``; ``index`` and ``gather`` with per-chain indices,
``index_put`` with and without accumulation, ``scatter``,
``scatter_add``; ``arange``; ``sort``; ``cumsum``, ``cumprod``,
``logcumsumexp``, ``cummax`` and ``cummin`` (values and indices, aten's
order; their backward is the scatter_add aten traces).  A Python loop
unrolls in the trace (the counterpart of ``scan``) and ``torch.where``
takes the place of ``cond``.  Anything else (``linalg`` ops, ``topk``,
random ops) is refused with :class:`UnsupportedOpError` naming the op, as
is data-dependent control flow, a graph past ``NODE_CAP`` nodes and a
position past ``MAX_D_WIDE`` coordinates, and a ``torch.autograd.Function``
(functionalization has no rule for it).  The router sends a refused
density to the eager path, as the JAX router sends one that is not
tile-compilable to XLA.

:func:`build_host_library` compiles emitted functors with ``g++`` through
``csrc/host_compat.h``, so their arithmetic is checked on a machine with no
card: the group form on a group of host threads meeting at a barrier.
"""

from __future__ import annotations

import ctypes
import hashlib
import heapq
import math
import operator
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["CompiledDensity", "UnsupportedOpError", "build_host_library", "compile_density",
           "host_eval"]

_GROUP_COMBS = ("sum", "max", "min")  # the reductions a group combines exactly
SCALARS = 8  # elements an elementwise node or a reduction's output keeps in scalars
UNROLL = 32  # extents the emitted text unrolls (sorts and scans of up to this many in scalars)
UNROLL_BUDGET = 128  # loop-body copies a nest unrolls in the emitted text
MAX_D = 32  # coordinates of the one-lane functor and its group form
# coordinates of the wide form (past MAX_D): K3's and K4's wide branches
# keep three buffers of D floats a chain in shared memory beside the
# operands, a chain a group of up to 8 warps (16 coordinates a thread at
# 4,096); the JAX package fuses up to d_pad + c_tot = 3,531 floats
# (binf_tpu/samplers/auto.py::_data_heavy at a 128-lane tile)
MAX_D_WIDE = 4096
WIDE_UNROLL = 8  # extents the wide form unrolls: a longer loop strides over the group
WIDE_UNROLL_BUDGET = 16
NODE_CAP = 4096  # position-dependent nodes of a graph (bounds nvcc's time)
LINE_CAP = 60000  # emitted lines
CSRC = Path(__file__).resolve().parents[2] / "csrc"


class UnsupportedOpError(NotImplementedError):
    """The compiler refuses this density before anything is built: an op
    with no lowering rule (named), data-dependent control flow, a graph
    past ``NODE_CAP`` nodes, or a position past ``MAX_D_WIDE`` coordinates."""


class CompiledDensity(NamedTuple):
    """A traced density's functor: ``source``, the header defining
    ``binf::<name>`` (``name`` is ``Traced_<key>``), the one-lane entry
    K3 and K4 take; ``operands``, the float32 constant buffer (CPU);
    ``flops``, float operations of one evaluation of U and grad U;
    ``nodes``, the graph's position-dependent nodes; ``lines``, the
    emitted lines; ``trace_ms``, the trace's and the lowering's wall
    milliseconds; ``ops``, the aten ops the graph holds.  The group form
    K7 takes, ``binf::<group_name>`` (``TracedGroup_<key>``, deriving from
    the one-lane functor), is ``group_source``, which follows ``source``
    in the same header (``header``); ``group_rows`` is the largest extent
    of a loop it strides over the group's threads (0: none, every thread
    computes everything).  Past ``MAX_D`` coordinates (``wide``) the group
    entry is the wide form, ``TracedWide_<key>``, and ``source`` holds only
    the base functor (the operands)."""

    D: int
    key: str
    name: str
    source: str
    operands: torch.Tensor
    flops: int
    nodes: int
    lines: int
    trace_ms: float
    ops: tuple
    group_name: str = ""
    group_source: str = ""
    group_rows: int = 0

    @property
    def header(self) -> str:
        """Both entries: the text of the header the units force-include."""
        return self.source + self.group_source

    @property
    def wide(self) -> bool:
        """Past ``MAX_D`` coordinates: the header holds the base functor
        (``name``, the operands) and the wide form (``group_name``,
        ``TracedWide_<key>``), which K3's and K4's wide branches and K7
        take; no one-lane entry."""
        return self.D > MAX_D

    @property
    def kernel_name(self) -> str:
        """The functor K3's and K4's units of this density take."""
        return self.group_name if self.wide else self.name


# -- tracing -----------------------------------------------------------------------

_DECOMPOSE = ("softplus", "softplus_backward", "mean", "index_select", "unbind", "masked_fill",
              "roll", "repeat", "index_add", "xlogy", "special_ndtr", "logaddexp",
              "split_with_sizes", "split", "var", "std", "var_mean", "std_mean", "addmm",
              "addmv", "baddbmm", "_log_softmax", "_softmax", "_log_softmax_backward_data",
              "_softmax_backward_data", "log_sigmoid_forward", "log_sigmoid_backward",
              "linalg_vector_norm", "norm", "logit", "logit_backward", "hypot",
              "threshold_backward", "nan_to_num", "mse_loss", "narrow", "diagonal_backward",
              "silu", "silu_backward", "elu", "elu_backward", "leaky_relu",
              "leaky_relu_backward", "hardtanh", "hardtanh_backward", "special_log_ndtr",
              "log10", "log2", "trace", "expand_as", "new_full", "fill", "sgn",
              "_unsafe_index", "take")
_decomp_table = None


def _decompositions():
    global _decomp_table
    if _decomp_table is None:
        from torch._decomp import get_decompositions

        aten = torch.ops.aten
        _decomp_table = get_decompositions([getattr(aten, n) for n in _DECOMPOSE
                                            if hasattr(aten, n)])
    return _decomp_table


def _trace(logdensity_fn, spec, D: int, device):
    """The graph of the negated density's value and gradient, traced once
    with the position on ``device``.  Data-dependent control flow or a
    data-dependent output refuses the density; any other failure of the
    trace raises as it is."""
    from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                               DynamicOutputShapeException)
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.fx.experimental.symbolic_shapes import GuardOnDataDependentSymNode

    from binf_tpu_torch.ops.kernels.fused_potential import unpack_draws

    def neg(q):
        return -logdensity_fn(unpack_draws(q, spec))

    fn = torch.func.functionalize(torch.func.grad_and_value(neg))
    q0 = torch.zeros(D, dtype=torch.float32, device=device)
    try:
        return make_fx(fn, tracing_mode="fake", _allow_non_fake_inputs=True,
                       decomposition_table=_decompositions())(q0)
    except GuardOnDataDependentSymNode as e:
        raise UnsupportedOpError(
            "data-dependent control flow: a Python branch on a traced value "
            f"({str(e).splitlines()[0]}); write it with torch.where") from None
    except (DataDependentOutputException, DynamicOutputShapeException) as e:
        raise UnsupportedOpError(f"data-dependent output in the trace: "
                                 f"{str(e).splitlines()[0]}") from None
    except RuntimeError as e:
        # a torch.autograd.Function (a kernel's own backward, as the
        # chromatin restraints' pairwise kernel has) cannot be functionalized
        if "custom_function_call" not in str(e):
            raise
        raise UnsupportedOpError("no lowering rule for a torch.autograd.Function in the "
                                 f"density ({str(e).splitlines()[0]})") from None


# -- the graph ----------------------------------------------------------------------


def _dt(dtype) -> str:
    if dtype == torch.bool:
        return "b"
    if dtype.is_floating_point:
        return "f"
    if dtype.is_complex:
        raise UnsupportedOpError(f"complex values ({dtype})")
    return "i"


_CT = {"f": "float", "i": "int", "b": "bool"}


class _Node:
    __slots__ = ("i", "op", "args", "shape", "dtype", "fx", "kind", "val", "const", "data",
                 "outs", "outs_val")

    def __init__(self, i, op, args, shape, dtype, fx):
        self.i, self.op, self.args, self.shape, self.dtype, self.fx = i, op, args, shape, dtype, fx
        self.kind = None
        self.val = None
        self.const = None  # the folded value (a real tensor), for constants
        self.data = False  # a constant that depends on the data (not a literal)
        self.outs = None  # a tuple op's output nodes
        self.outs_val = None  # and their (kind, value) once emitted

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


def _tensor_args(args):
    for a in args:
        if isinstance(a, _Node):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from _tensor_args(a)


def _op_name(target) -> str:
    if target is operator.getitem:
        return "getitem"
    if isinstance(target, torch._ops.OpOverload):
        return f"{target._schema.name.split('::')[-1]}.{target._overloadname}"
    raise UnsupportedOpError(f"no lowering rule for {target}")


def _normalized(fxn, mapping):
    """The node's arguments in schema order, defaults filled in, graph
    nodes replaced by ``mapping``'s."""

    def conv(v):
        if isinstance(v, torch.fx.Node):
            return mapping[v]
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        return v

    if fxn.target is operator.getitem:
        return [conv(a) for a in fxn.args]
    out = []
    for k, a in enumerate(fxn.target._schema.arguments):
        if k < len(fxn.args):
            v = fxn.args[k]
        elif a.name in fxn.kwargs:
            v = fxn.kwargs[a.name]
        elif a.has_default_value():
            v = a.default_value
        else:
            v = None
        out.append(conv(v))
    return out


_FACTORIES = {"zeros.default", "ones.default", "full.default", "empty.memory_format",
              "scalar_tensor.default", "arange.default", "arange.start", "arange.start_step",
              "zeros_like.default", "ones_like.default", "full_like.default",
              "empty_like.default", "new_zeros.default", "new_ones.default", "new_empty.default",
              "new_full.default", "linspace.default", "eye.default", "empty_strided.default"}
_GROWING = {"expand.default"}


def _meta(fxn):
    v = fxn.meta.get("val")
    if isinstance(v, (tuple, list)):
        return None, None
    if v is None or not isinstance(v, torch.Tensor):
        raise UnsupportedOpError(f"{fxn.target}: no tensor value in the trace")
    if not all(isinstance(s, int) for s in v.shape):
        raise UnsupportedOpError(f"data-dependent shape: {fxn.target} gives {tuple(v.shape)}")
    return tuple(v.shape), _dt(v.dtype)


def _build_graph(gm):
    """The traced graph as ``_Node``\\ s, constants folded: ``(nodes, q,
    (grad, value))``."""
    nodes, mapping = [], {}
    q = outputs = None
    for fxn in gm.graph.nodes:
        if fxn.op == "placeholder":
            shape, dt = _meta(fxn)
            n = _Node(len(nodes), "input", [], shape, dt, fxn)
            n.kind = "input"
            q = n
        elif fxn.op == "get_attr":
            t = getattr(gm, fxn.target).detach()
            n = _Node(len(nodes), "const", [], tuple(t.shape), _dt(t.dtype), fxn)
            n.const, n.data = t, True
        elif fxn.op == "call_function":
            op = _op_name(fxn.target)
            args = _normalized(fxn, mapping)
            shape, dt = _meta(fxn)
            n = _Node(len(nodes), op, args, shape, dt, fxn)
            _fold(n, fxn, mapping)
        elif fxn.op == "output":
            grad, value = fxn.args[0]
            outputs = (mapping[grad], mapping[value])
            continue
        else:
            raise UnsupportedOpError(f"graph node {fxn.op}")
        nodes.append(n)
        mapping[fxn] = n
    for n in nodes:
        if n.op == "getitem" and n.const is None:
            src = n.args[0]
            if src.outs is None:
                src.outs = {}
            src.outs[n.args[1]] = n
    return nodes, q, outputs


def _fold(n, fxn, mapping):
    """Evaluate ``n`` now if it does not depend on the position (its
    inputs are constants, or it is a factory, which reads only shapes)."""
    ins = list(_tensor_args(n.args))
    factory = n.op in _FACTORIES
    if not factory and not all(a.const is not None for a in ins):
        return
    if (n.op in _GROWING or n.op in _VIEWS) and any(a.data for a in ins):
        return  # a view of the data, not a copy in the operand buffer

    def real(v):
        if isinstance(v, torch.fx.Node):
            a = mapping[v]
            if a.const is None:  # a factory's shape argument
                m = v.meta["val"]
                return torch.zeros(m.shape, dtype=m.dtype, device=m.device)
            return a.const
        if isinstance(v, (list, tuple)):
            return type(v)(real(x) for x in v)
        return v

    with torch.no_grad():
        out = fxn.target(*real(fxn.args), **{k: real(v) for k, v in fxn.kwargs.items()})
    if n.op in ("empty_like.default", "new_empty.default", "empty.memory_format",
                "empty_strided.default"):
        out = torch.zeros_like(out)
    if isinstance(out, torch.Tensor):
        out = out.detach()
    n.const = out
    n.data = (not factory) and any(a.data for a in ins)


# -- literals and index arithmetic ------------------------------------------------------


def _lit(v, dt: str) -> str:
    if dt == "b":
        return "true" if bool(v) else "false"
    if dt == "i":
        v = int(v)
        if not -2**31 <= v < 2**31:
            raise UnsupportedOpError(f"integer {v} past int32")
        return str(v)
    f = float(np.float32(v))
    if math.isnan(f):
        return "NAN"
    if math.isinf(f):
        return "INFINITY" if f > 0 else "(-INFINITY)"
    s = float.hex(f) + "f"
    return f"({s})" if f < 0 or s.startswith("-") else s


def _iadd(a, b):
    if isinstance(a, int) and isinstance(b, int):
        return a + b
    if a == 0:
        return b
    if b == 0:
        return a
    return f"({a} + {b})"


def _imul(a, k: int):
    if isinstance(a, int):
        return a * k
    if k == 0:
        return 0
    if k == 1:
        return a
    return f"({a} * {k})"


def _idiv(a, k: int):
    if isinstance(a, int):
        return a // k
    return a if k == 1 else f"({a} / {k})"


def _imod(a, k: int):
    if isinstance(a, int):
        return a % k
    return 0 if k == 1 else f"({a} % {k})"


def _strides(shape):
    out, s = [], 1
    for d in reversed(shape):
        out.append(s)
        s *= d
    return out[::-1]


def _lin(idx, shape):
    flat = 0
    for i, s in zip(idx, _strides(shape)):
        flat = _iadd(flat, _imul(i, s))
    return flat


def _unravel(flat, shape):
    out = []
    for d, (s, n) in enumerate(zip(_strides(shape), shape)):
        v = _idiv(flat, s)
        out.append(v if d == 0 else _imod(v, n))
    return out


def _reshape_map(idx, out_shape, in_shape):
    """Index of a reshaped tensor's element ``idx`` in its input."""
    o = [(i, s) for i, s in zip(idx, out_shape) if s != 1]
    nz = [k for k, s in enumerate(in_shape) if s != 1]
    res = [0] * len(in_shape)
    oi = ii = 0
    while oi < len(o) and ii < len(nz):
        og, ig = [oi], [ii]
        po, pi = o[oi][1], in_shape[nz[ii]]
        oi, ii = oi + 1, ii + 1
        while po != pi:
            if po < pi:
                po *= o[oi][1]
                og.append(oi)
                oi += 1
            else:
                pi *= in_shape[nz[ii]]
                ig.append(ii)
                ii += 1
        if len(og) == 1 and len(ig) == 1:
            res[nz[ig[0]]] = o[og[0]][0]
        else:
            flat = _lin([o[j][0] for j in og], [o[j][1] for j in og])
            for j, s in zip(ig, _unravel(flat, [in_shape[nz[j]] for j in ig])):
                res[nz[j]] = s
    return tuple(res)


def _bcast_idx(idx, shape):
    """``idx`` of a broadcast result, read in an input of ``shape``."""
    off = len(idx) - len(shape)
    return tuple(0 if s == 1 else idx[k + off] for k, s in enumerate(shape))


def _dim(d, ndim):
    return d + ndim if d < 0 else d


def _bounds(start, end, size):
    start = 0 if start is None else start
    end = size if end is None else end
    if start < 0:
        start += size
    if end < 0:
        end += size
    return min(max(start, 0), size), min(max(end, 0), size)


# -- op tables ---------------------------------------------------------------------------

# elementwise unary ops: (float form, int form or None)
_UNARY = {
    "neg.default": ("(-{0})", "(-{0})"), "abs.default": ("fabsf({0})", "abs({0})"),
    "exp.default": ("expf({0})", None), "exp2.default": ("exp2f({0})", None),
    "expm1.default": ("expm1f({0})", None), "log.default": ("logf({0})", None),
    "log1p.default": ("log1pf({0})", None), "sqrt.default": ("sqrtf({0})", None),
    "rsqrt.default": ("(1.0f / sqrtf({0}))", None),
    "reciprocal.default": ("(1.0f / {0})", None), "sin.default": ("sinf({0})", None),
    "cos.default": ("cosf({0})", None), "tan.default": ("tanf({0})", None),
    "sinh.default": ("sinhf({0})", None), "cosh.default": ("coshf({0})", None),
    "tanh.default": ("tanhf({0})", None), "asin.default": ("asinf({0})", None),
    "acos.default": ("acosf({0})", None), "atan.default": ("atanf({0})", None),
    "asinh.default": ("asinhf({0})", None), "acosh.default": ("acoshf({0})", None),
    "atanh.default": ("atanhf({0})", None), "sigmoid.default": ("traced::sigmoid({0})", None),
    "erf.default": ("erff({0})", None), "erfc.default": ("erfcf({0})", None),
    "lgamma.default": ("lgammaf({0})", None), "digamma.default": ("traced::digamma({0})", None),
    "cbrt.default": ("cbrtf({0})", None),
    "floor.default": ("floorf({0})", "{0}"), "ceil.default": ("ceilf({0})", "{0}"),
    "round.default": ("rintf({0})", "{0}"), "trunc.default": ("truncf({0})", "{0}"),
    "frac.default": ("({0} - truncf({0}))", None),
    "sign.default": ("traced::sign({0})", "traced::sign({0})"),
    "sgn.default": ("traced::sign({0})", "traced::sign({0})"),
    "square.default": ("({0} * {0})", "({0} * {0})"),
    "relu.default": ("traced::maximum({0}, 0.0f)", "traced::maximum({0}, 0)"),
}
# float -> bool tests
_TESTS = {"isnan.default": "isnan({0})", "isinf.default": "isinf({0})",
          "isfinite.default": "isfinite({0})", "isposinf.default": "({0} == INFINITY)",
          "isneginf.default": "({0} == -INFINITY)", "signbit.default": "signbit({0})"}
_CMP = {"eq": "==", "ne": "!=", "lt": "<", "le": "<=", "gt": ">", "ge": ">="}
_LOGIC = {"logical_and.default": "&&", "logical_or.default": "||", "logical_xor.default": "!="}
_BITWISE = {"bitwise_and": "&", "bitwise_or": "|", "bitwise_xor": "^"}

_VIEWS = {"view.default", "_unsafe_view.default", "reshape.default", "unsqueeze.default",
          "squeeze.dim", "squeeze.dims", "squeeze.default", "expand.default",
          "permute.default", "t.default", "transpose.int", "slice.Tensor", "select.int",
          "alias.default", "clone.default", "lift_fresh_copy.default", "detach.default",
          "flip.default", "diagonal.default", "view_copy.default", "_reshape_alias.default"}
_PIECEWISE = {"cat.default", "stack.default", "constant_pad_nd.default",
              "slice_backward.default", "select_backward.default", "slice_scatter.default",
              "select_scatter.default", "copy.default"}
_STACKS = {"cat.default", "stack.default"}
_GATHERS = {"index.Tensor", "gather.default"}
_SCATTERS = {"index_put.default", "scatter.src", "scatter.value", "scatter_add.default"}
_SEQ = {"cumsum.default", "cumprod.default", "logcumsumexp.default"}
_TUPLES = {"sort.default", "sort.stable", "max.dim", "min.dim", "cummax.default",
           "cummin.default"}
_REDUCE = {"sum.default": "sum", "sum.dim_IntList": "sum", "prod.default": "prod",
           "prod.dim_int": "prod", "amax.default": "max", "amin.default": "min",
           "max.default": "max", "min.default": "min", "any.default": "any",
           "any.dim": "any", "any.dims": "any", "all.default": "all", "all.dim": "all",
           "all.dims": "all", "logsumexp.default": "lse", "argmax.default": "argmax",
           "argmin.default": "argmin", "max.dim": "argmax", "min.dim": "argmin",
           "mv.default": "sum", "mm.default": "sum", "dot.default": "sum", "bmm.default": "sum"}
_CONTRACT = {"mv.default", "mm.default", "dot.default", "bmm.default"}


def _is_ew(op: str) -> bool:
    base = op.split(".")[0]
    return (op in _UNARY or op in _TESTS or base in _CMP or op in _LOGIC or base in _BITWISE
            or base in ("add", "sub", "rsub", "mul", "div", "true_divide", "pow", "atan2",
                        "maximum", "minimum", "fmax", "fmin", "fmod", "remainder",
                        "floor_divide", "copysign", "where", "clamp", "clamp_min",
                        "clamp_max", "_to_copy", "sigmoid_backward", "tanh_backward",
                        "logical_not", "bitwise_not", "lerp", "polygamma"))


def _supported(op: str) -> bool:
    return (_is_ew(op) or op in _VIEWS or op in _PIECEWISE or op in _GATHERS or op in _SCATTERS
            or op in _SEQ or op in _TUPLES or op in _REDUCE or op == "getitem")


# -- the emitter -------------------------------------------------------------------------


class _Emitter:
    """The C++ text of one functor's ``value_and_grad`` body: lines, the
    memo of values already computed in each open scope (by node and index,
    and by expression), and the float operations counted so far (each
    statement times the trips of the loops around it)."""

    def __init__(self, group: bool = False, wide: bool = False):
        self.lines: list[str] = []
        self.ind = 2
        self.scopes: list[dict] = [{}]
        self.mult = [1]
        self.flops = 0
        self.ctr = 0
        # the group form: split the outermost runtime loop of a reduction
        # nest over the group's threads, where no split loop or branch
        # encloses it (there the threads' paths part)
        self.group = group
        self.no_split = 0
        self.split_rows = 0  # the largest extent a split loop strides
        # the wide form (a group form past MAX_D): the position read where
        # it is used from the group's shared qs, shorter loops unrolled
        self.wide = wide
        self.unroll, self.budget = ((WIDE_UNROLL, WIDE_UNROLL_BUDGET) if wide
                                    else (UNROLL, UNROLL_BUDGET))

    # -- text
    def fresh(self, p: str) -> str:
        self.ctr += 1
        return f"{p}{self.ctr}"

    def line(self, s: str) -> None:
        self.lines.append("  " * self.ind + s)
        if len(self.lines) > LINE_CAP:
            raise UnsupportedOpError(f"the emitted functor passes {LINE_CAP} lines")

    def count(self, k: int = 1) -> None:
        self.flops += self.mult[-1] * k

    def push(self, trips: int = 1) -> None:
        self.scopes.append({})
        self.mult.append(self.mult[-1] * trips)
        self.ind += 1

    def pop(self) -> None:
        self.scopes.pop()
        self.mult.pop()
        self.ind -= 1

    def memo(self, key):
        for sc in reversed(self.scopes):
            if key in sc:
                return sc[key]
        return None

    def tmp(self, dt: str, expr: str) -> str:
        """``expr`` as a name (a new constant unless it is one)."""
        if _simple(expr):
            return expr
        key = ("e", dt, expr)  # the same expression in a visible scope: its value
        name = self.memo(key)
        if name is None:
            name = self.fresh("v")
            self.line(f"const {_CT[dt]} {name} = {expr};")
            self.scopes[-1][key] = name
        return name

    def var(self, dt: str, init: str) -> str:
        name = self.fresh("a")
        self.line(f"{_CT[dt]} {name} = {init};")
        return name

    # -- element access
    def elem(self, n: _Node, idx) -> str:
        idx = tuple(idx)
        k = n.kind
        if k == "splat":
            return n.val
        if k == "input":
            return f"{'qs' if self.wide else 'q'}[{_lin(idx, n.shape)}]"
        key = (n.i, idx)
        got = self.memo(key)
        if got is not None:
            return got
        if k == "const":
            off = _iadd(n.val, _lin(idx, n.shape))
            load = f"c[{off}]"
            expr = {"f": load, "i": f"traced::bits({load})", "b": f"({load} != 0.0f)"}[n.dtype]
            out = self.tmp(n.dtype, expr)
        elif k == "scal":
            flat = _lin(idx, n.shape)
            if isinstance(flat, int):
                return n.val[flat]
            ix = self.tmp("i", flat)
            out = n.val[-1]
            for j in range(len(n.val) - 2, -1, -1):
                out = f"({ix} == {j} ? {n.val[j]} : {out})"
            out = self.tmp(n.dtype, out)
        elif k == "arr":
            out = self.tmp(n.dtype, f"{n.val}[{_lin(idx, n.shape)}]")
        elif k == "lazy":
            out = self.tmp(n.dtype, self.rule(n, idx))
        else:
            raise AssertionError(f"{n.op}: {k} read before it was emitted")
        self.scopes[-1][key] = out
        return out

    def arg(self, n: _Node, pos: int, idx, want: str) -> str:
        """Argument ``pos`` of ``n`` at output index ``idx`` (broadcast),
        as a ``want`` value (a literal for a Python scalar)."""
        a = n.args[pos]
        if isinstance(a, _Node):
            v = self.elem(a, _bcast_idx(idx, a.shape))
            if a.dtype != want and want == "f":
                return f"(float)({v})"
            if a.dtype == "f" and want == "i":
                return f"(int)({v})"
            return v
        if a is None:
            raise UnsupportedOpError(f"{n.op}: missing argument {pos}")
        if isinstance(a, float) and want != "f" and not a.is_integer():
            want = "f"
        return _lit(a, want)

    # -- lowering rules of the lazy and elementwise nodes
    def rule(self, n: _Node, idx) -> str:
        op = n.op
        if _is_ew(op):
            return self.ew(n, idx)
        if op in _VIEWS:
            return self.view(n, idx)
        if op in _PIECEWISE:
            return self.piecewise(n, idx)
        if op == "index.Tensor":
            x, indices = n.args[0], n.args[1]
            return self.elem(x, self.adv_index(x.shape, indices, idx))
        if op == "gather.default":
            x, dim, index = n.args[0], _dim(n.args[1], len(n.shape)), n.args[2]
            src = list(idx)
            src[dim] = self.wrap(self.elem(index, idx), x.shape[dim])
            return self.elem(x, src)
        if op in _REDUCE:
            return self.reduce_element(n, idx)
        raise AssertionError(op)

    def ew(self, n: _Node, idx) -> str:
        op, dt = n.op, n.dtype
        base, over = op.split(".", 1) if "." in op else (op, "")
        ins = [a for a in n.args if isinstance(a, _Node)]
        work = "f" if dt == "f" or any(a.dtype == "f" for a in ins) else (
            "i" if dt == "i" or any(a.dtype == "i" for a in ins) else "b")
        if op not in ("_to_copy.default",):
            self.count(1 if work == "f" else 0)
        A = lambda pos, want=None: self.arg(n, pos, idx, want or dt)  # noqa: E731
        if op in _UNARY:
            f_form, i_form = _UNARY[op]
            if dt != "f":
                if i_form is None:
                    raise UnsupportedOpError(f"{op} on integers")
                return i_form.format(A(0))
            return f_form.format(A(0, "f"))
        if op in _TESTS:
            a = n.args[0]
            if a.dtype != "f":
                return "false" if op != "isfinite.default" else "true"
            return _TESTS[op].format(A(0, "f"))
        if base in _CMP:
            return f"({A(0, work)} {_CMP[base]} {A(1, work)})"
        if op in _LOGIC:
            return f"(bool({A(0, 'b')}) {_LOGIC[op]} bool({A(1, 'b')}))"
        if op == "logical_not.default":
            return f"(!{A(0, n.args[0].dtype)})"
        if base == "bitwise_not":
            return f"(!{A(0)})" if dt == "b" else f"(~{A(0)})"
        if base in _BITWISE:
            return f"({A(0)} {_BITWISE[base]} {A(1)})"
        if op == "_to_copy.default":
            a = n.args[0]
            v = self.elem(a, _bcast_idx(idx, a.shape))
            if a.dtype == dt:
                return v
            if dt == "b":
                return f"({v} != 0)"
            return f"(float)({v})" if dt == "f" else f"(int)({v})"
        if base in ("add", "sub"):
            alpha = n.args[2] if len(n.args) > 2 and n.args[2] is not None else 1
            b = A(1) if alpha == 1 else f"({_lit(alpha, dt)} * {A(1)})"
            return f"({A(0)} {'+' if base == 'add' else '-'} {b})"
        if base == "rsub":
            alpha = n.args[2] if len(n.args) > 2 and n.args[2] is not None else 1
            a = A(0) if alpha == 1 else f"({_lit(alpha, dt)} * {A(0)})"
            return f"({A(1)} - {a})"
        if base == "mul":
            a, b = A(0), A(1)
            one = _lit(1, dt)
            return a if b == one else b if a == one else f"({a} * {b})"
        if base in ("div", "true_divide"):
            mode = n.args[2] if over.endswith("_mode") else None
            if mode is None:
                return f"({A(0, 'f')} / {A(1, 'f')})"
            if dt == "f":
                fn = "floorf" if mode == "floor" else "truncf"
                return f"{fn}({A(0)} / {A(1)})"
            return (f"traced::floordiv({A(0)}, {A(1)})" if mode == "floor"
                    else f"({A(0)} / {A(1)})")
        if base == "floor_divide":
            return (f"floorf({A(0)} / {A(1)})" if dt == "f"
                    else f"traced::floordiv({A(0)}, {A(1)})")
        if base == "remainder":
            return f"traced::remainder({A(0)}, {A(1)})"
        if base == "fmod":
            return f"fmodf({A(0)}, {A(1)})" if dt == "f" else f"({A(0)} % {A(1)})"
        if base == "pow":
            return self.pow(n, idx)
        if base in ("atan2", "copysign", "fmax", "fmin"):
            return f"{base}f({A(0, 'f')}, {A(1, 'f')})"
        if base in ("maximum", "minimum"):
            return f"traced::{base}({A(0)}, {A(1)})"
        if base == "where":
            return f"({A(0, 'b')} ? {A(1)} : {A(2)})"
        if base in ("clamp", "clamp_min", "clamp_max"):
            x = A(0)
            lo = n.args[1] if base != "clamp_max" else None
            hi = n.args[2] if base == "clamp" else (n.args[1] if base == "clamp_max" else None)
            if lo is not None:
                x = f"traced::maximum({x}, {A(1)})"
            if hi is not None:
                x = f"traced::minimum({x}, {A(2 if base == 'clamp' else 1)})"
            return x
        if op == "sigmoid_backward.default":
            g, y = A(0), A(1)
            return f"({g} * ((1.0f - {y}) * {y}))"
        if op == "tanh_backward.default":
            g, y = A(0), A(1)
            return f"({g} * (1.0f - {y} * {y}))"
        if base == "polygamma":
            order = int(n.args[0])
            if order not in (0, 1):
                raise UnsupportedOpError(f"no lowering rule for aten.polygamma of order {order}")
            fn = "traced::digamma" if order == 0 else "traced::trigamma"
            return f"{fn}({self.arg(n, 1, idx, 'f')})"
        if base == "lerp":
            s, e = A(0), A(1)
            return f"({s} + {A(2)} * ({e} - {s}))"
        raise UnsupportedOpError(f"no lowering rule for aten.{op}")

    def pow(self, n: _Node, idx) -> str:
        dt = n.dtype
        b, e = n.args[0], n.args[1]
        if n.op == "pow.Scalar":
            return f"powf({_lit(b, 'f')}, {self.arg(n, 1, idx, 'f')})"
        x = self.arg(n, 0, idx, dt)
        if isinstance(e, _Node):
            return f"powf({x}, {self.arg(n, 1, idx, 'f')})"
        e = float(e)
        forms = {0.0: "1", 1.0: "{0}", 2.0: "({0} * {0})", 3.0: "({0} * {0} * {0})"}
        if e in forms:
            out = forms[e].format(x)
            return ("1.0f" if dt == "f" else "1") if out == "1" else out
        if dt != "f":
            raise UnsupportedOpError(f"integer power {e}")
        return {0.5: f"sqrtf({x})", -1.0: f"(1.0f / {x})", -0.5: f"(1.0f / sqrtf({x}))",
                -2.0: f"(1.0f / ({x} * {x}))"}.get(e, f"powf({x}, {_lit(e, 'f')})")

    def view(self, n: _Node, idx) -> str:
        op, x = n.op, n.args[0]
        idx = list(idx)
        if op in ("view.default", "_unsafe_view.default", "reshape.default", "view_copy.default",
                  "_reshape_alias.default", "unsqueeze.default", "squeeze.dim", "squeeze.dims",
                  "squeeze.default"):
            src = _reshape_map(idx, n.shape, x.shape)
        elif op == "expand.default":
            src = _bcast_idx(idx, x.shape)
        elif op == "permute.default":
            dims = [_dim(d, len(n.shape)) for d in n.args[1]]
            src = [0] * len(dims)
            for k, d in enumerate(dims):
                src[d] = idx[k]
        elif op == "t.default":
            src = idx[::-1]
        elif op == "transpose.int":
            a, b = _dim(n.args[1], len(n.shape)), _dim(n.args[2], len(n.shape))
            src = list(idx)
            src[a], src[b] = idx[b], idx[a]
        elif op == "slice.Tensor":
            dim = _dim(n.args[1], len(x.shape))
            start, _ = _bounds(n.args[2], n.args[3], x.shape[dim])
            src = list(idx)
            src[dim] = _iadd(start, _imul(idx[dim], n.args[4] or 1))
        elif op == "select.int":
            dim = _dim(n.args[1], len(x.shape))
            i = n.args[2] + x.shape[dim] if n.args[2] < 0 else n.args[2]
            src = idx[:dim] + [i] + idx[dim:]
        elif op == "flip.default":
            src = list(idx)
            for d in n.args[1]:
                d = _dim(d, len(n.shape))
                src[d] = (n.shape[d] - 1 - idx[d] if isinstance(idx[d], int)
                          else f"({n.shape[d] - 1} - {idx[d]})")
        elif op == "diagonal.default":
            off, d1, d2 = n.args[1], _dim(n.args[2], len(x.shape)), _dim(n.args[3], len(x.shape))
            rest, i = idx[:-1], idx[-1]
            src, r = [], iter(rest)
            for d in range(len(x.shape)):
                if d == d1:
                    src.append(_iadd(i, max(-off, 0)))
                elif d == d2:
                    src.append(_iadd(i, max(off, 0)))
                else:
                    src.append(next(r))
        else:  # alias, clone, lift_fresh_copy, detach
            src = idx
        return self.elem(x, src)

    def cond_and(self, parts) -> bool | str:
        out = []
        for p in parts:
            if p is False:
                return False
            if p is not True:
                out.append(p)
        return True if not out else "(" + " && ".join(out) + ")"

    def branch(self, dt: str, cases, default) -> str:
        """The value of the first case whose condition holds: ``cases`` are
        ``(condition, thunk)`` with a Python bool or a C++ condition,
        ``default`` a thunk."""
        live = []
        for cond, thunk in cases:
            if cond is False:
                continue
            if cond is True:
                default = thunk
                break
            live.append((cond, thunk))
        if not live:
            return default()
        name = self.fresh("b")
        self.line(f"{_CT[dt]} {name};")
        self.no_split += 1
        for k, (cond, thunk) in enumerate(live):
            self.line(f"{'if' if k == 0 else '} else if'} ({cond}) {{")
            self.push()
            self.line(f"{name} = {thunk()};")
            self.pop()
        self.line("} else {")
        self.push()
        self.line(f"{name} = {default()};")
        self.pop()
        self.line("}")
        self.no_split -= 1
        return name

    @staticmethod
    def lt(a, b) -> bool | str:
        if isinstance(a, int) and isinstance(b, int):
            return a < b
        return f"({a} < {b})"

    @staticmethod
    def ge(a, b) -> bool | str:
        if isinstance(a, int) and isinstance(b, int):
            return a >= b
        return f"({a} >= {b})"

    @staticmethod
    def eq(a, b) -> bool | str:
        if isinstance(a, int) and isinstance(b, int):
            return a == b
        return f"({a} == {b})"

    def piecewise(self, n: _Node, idx) -> str:
        op, dt = n.op, n.dtype
        idx = list(idx)
        if op == "copy.default":
            return self.arg(n, 1, idx, dt)
        if op in ("cat.default", "stack.default"):
            parts = [t for t in n.args[0] if t.numel > 0 or op == "stack.default"]
            dim = _dim(n.args[1], len(n.shape))
            cases, at = [], 0
            for t in parts:
                if op == "cat.default":
                    size, local = t.shape[dim], idx[:dim] + [_iadd(idx[dim], -at)] + idx[dim + 1:]
                else:
                    size, local = 1, idx[:dim] + idx[dim + 1:]
                cases.append((self.lt(idx[dim], at + size),
                              lambda t=t, local=local: self.cast(t, local, dt)))
                at += size
            return self.branch(dt, cases[:-1], cases[-1][1])
        if op == "constant_pad_nd.default":
            x, pad, value = n.args[0], n.args[1], n.args[2] or 0
            src, conds = list(idx), []
            for k in range(len(pad) // 2):
                d = len(n.shape) - 1 - k
                lo = pad[2 * k]
                src[d] = _iadd(idx[d], -lo)
                conds += [self.ge(src[d], 0), self.lt(src[d], x.shape[d])]
            return self.branch(dt, [(self.cond_and(conds), lambda: self.cast(x, src, dt))],
                               lambda: _lit(value, dt))
        if op in ("slice_backward.default", "slice_scatter.default"):
            if op == "slice_backward.default":
                g, dim, start, end, step, base = (n.args[0], n.args[2], n.args[3], n.args[4],
                                                  n.args[5], None)
            else:
                base, g, dim, start, end, step = n.args[:6]
            dim = _dim(dim, len(n.shape))
            start, _ = _bounds(start, end, n.shape[dim])
            step = step or 1
            j = _iadd(idx[dim], -start)
            conds = [self.ge(j, 0), self.lt(_idiv(j, step) if isinstance(j, int) else
                                          f"({j} / {step})", g.shape[dim])]
            if step != 1:
                conds.append(self.eq(_imod(j, step), 0))
            src = idx[:dim] + [_idiv(j, step)] + idx[dim + 1:]
            other = ((lambda: _lit(0, dt)) if base is None
                     else (lambda: self.cast(base, idx, dt)))
            return self.branch(dt, [(self.cond_and(conds), lambda: self.cast(g, src, dt))], other)
        if op in ("select_backward.default", "select_scatter.default"):
            if op == "select_backward.default":
                g, dim, index, base = n.args[0], n.args[2], n.args[3], None
            else:
                base, g, dim, index = n.args[:4]
            dim = _dim(dim, len(n.shape))
            index = index + n.shape[dim] if index < 0 else index
            src = idx[:dim] + idx[dim + 1:]
            other = ((lambda: _lit(0, dt)) if base is None
                     else (lambda: self.cast(base, idx, dt)))
            return self.branch(dt, [(self.eq(idx[dim], index), lambda: self.cast(g, src, dt))],
                               other)
        raise AssertionError(op)

    def cast(self, t: _Node, idx, dt: str) -> str:
        v = self.elem(t, _bcast_idx(list(idx), t.shape))
        if t.dtype == dt:
            return v
        return f"({_CT[dt]})({v})"

    def wrap(self, v: str, size: int):
        if v.lstrip("-").isdigit():
            i = int(v)
            return i + size if i < 0 else i
        return self.tmp("i", f"traced::wrap({v}, {size})")

    def adv_index(self, shape, indices, idx):
        """The element of a tensor of ``shape`` that advanced indexing with
        ``indices`` (index tensors or None) puts at ``idx``."""
        idx = list(idx)
        pos = [k for k, t in enumerate(indices) if t is not None]
        tens = [indices[k] for k in pos]
        for t in tens:
            if t.dtype == "b":
                raise UnsupportedOpError("indexing by a boolean mask (a data-dependent shape)")
        B = list(torch.broadcast_shapes(*[t.shape for t in tens]))
        nb = len(B)
        if pos == list(range(pos[0], pos[-1] + 1)):
            b_idx = idx[pos[0]:pos[0] + nb]
            rest = idx[:pos[0]] + idx[pos[0] + nb:]
        else:
            b_idx, rest = idx[:nb], idx[nb:]
        out, r = [], iter(rest)
        for k in range(len(shape)):
            if k < len(indices) and indices[k] is not None:
                t = indices[k]
                out.append(self.wrap(self.elem(t, _bcast_idx(b_idx, t.shape)), shape[k]))
            else:
                out.append(next(r))
        return out

    # -- loops
    def plan(self, ext) -> list[str]:
        plan, p = ["rt"] * len(ext), 1
        for d in reversed(range(len(ext))):
            if ext[d] <= self.unroll and p * ext[d] <= self.budget:
                plan[d] = "py"
                p *= ext[d]
        return plan

    def nest(self, ext, body, split: bool = False) -> bool:
        """``body(idx)`` over every index of ``ext``: small dimensions
        unrolled in the text, the others C++ loops.  With ``split`` (the
        group form, outside any split loop or branch) the outermost C++
        loop strides from the thread's rank by the group's size; returns
        whether it did, so that the caller combines its partials."""
        plan = self.plan(ext)
        split = split and self.group and not self.no_split and "rt" in plan

        def rec(d, idx, inside):
            if d == len(ext):
                body(tuple(idx))
                return
            if plan[d] == "py":
                for j in range(ext[d]):
                    rec(d + 1, idx + [j], inside)
                return
            v = self.fresh("i")
            if split and not inside:
                self.line(f"for (int {v} = grp.r; {v} < {ext[d]}; {v} += grp.T) {{")
                self.split_rows = max(self.split_rows, ext[d])
                self.no_split += 1
            else:
                self.line(f"for (int {v} = 0; {v} < {ext[d]}; ++{v}) {{")
            self.push(ext[d])
            rec(d + 1, idx + [v], inside or split)
            self.pop()
            if split and not inside:
                self.no_split -= 1
            self.line("}")

        rec(0, [], False)
        return split

    def combine(self, comb: str, acc: str) -> None:
        """The group's partials of a split reduction into every thread."""
        self.line(f"{acc} = grp.{comb}({acc});")

    # -- reductions
    def red_spec(self, n: _Node):
        """``(comb, R, term(o, r), value dtype)`` of a reduction or
        contraction: the terms over the index space ``R`` whose
        combination is the output's element ``o``."""
        op = n.op
        comb = _REDUCE[op]
        if op in _CONTRACT:
            a, b = n.args[0], n.args[1]
            k = a.shape[-1]
            if op == "mv.default":
                def term(o, r):
                    return self.mul(a, (o[0], r[0]), b, (r[0],))
            elif op == "mm.default":
                def term(o, r):
                    return self.mul(a, (o[0], r[0]), b, (r[0], o[1]))
            elif op == "dot.default":
                def term(o, r):
                    return self.mul(a, (r[0],), b, (r[0],))
            else:
                def term(o, r):
                    return self.mul(a, (o[0], o[1], r[0]), b, (o[0], r[0], o[2]))
            return comb, [k], term, n.dtype
        x = n.args[0]
        nd = len(x.shape)
        dims, keep = None, False
        if op in ("sum.dim_IntList", "any.dims", "all.dims", "amax.default", "amin.default",
                  "logsumexp.default"):
            dims, keep = n.args[1], bool(n.args[2])
        elif op in ("prod.dim_int", "any.dim", "all.dim", "max.dim", "min.dim",
                    "argmax.default", "argmin.default"):
            dims, keep = n.args[1], bool(n.args[2])
            dims = None if dims is None else [dims]
        if dims is None or len(dims) == 0:
            dims = list(range(nd))
        dims = sorted({_dim(d, nd) for d in dims}) if nd else []
        R = [x.shape[d] for d in dims]

        def term(o, r):
            src, oi, ri = [], iter(o), iter(r)
            for d in range(nd):
                if d in dims:
                    src.append(next(ri))
                    if keep:
                        next(oi)
                else:
                    src.append(next(oi))
            return self.elem(x, src)

        return comb, R, term, x.dtype

    def mul(self, a, ia, b, ib) -> str:
        self.count(2)
        return f"({self.elem(a, ia)} * {self.elem(b, ib)})"

    def reduce_loop(self, R, items) -> None:
        """One loop nest over ``R`` that updates every item ``(comb, term,
        o, accs, vdt)``; ``accs`` are declared here (argmax/argmin: value
        and index)."""
        inits = {"sum": "0", "prod": "1", "max": "-INF", "min": "INF", "any": "false",
                 "all": "true", "argmax": "-INF", "argmin": "INF"}
        for comb, _, _, accs, vdt in items:
            init = inits[comb]
            if init in ("0", "1"):
                init = _lit(int(init), vdt if vdt != "b" else "i")
            elif "INF" in init:
                init = ("(-INFINITY)" if init[0] == "-" else "INFINITY") if vdt == "f" else (
                    "(-2147483647 - 1)" if init[0] == "-" else "2147483647")
            accs.append(self.var(vdt if comb not in ("sum", "prod") or vdt != "b" else "i", init))
            if comb in ("argmax", "argmin"):
                accs.append(self.var("i", "0"))

        def body(r):
            flat = _lin(r, R)
            for comb, term, o, accs, vdt in items:
                v = term(o, r)
                self.count(1 if vdt == "f" else 0)
                a = accs[0]
                if comb == "sum":
                    self.line(f"{a} += {v};")
                elif comb == "prod":
                    self.line(f"{a} *= {v};")
                elif comb in ("max", "min"):
                    self.line(f"{a} = traced::{comb}imum({a}, {v});")
                elif comb == "any":
                    self.line(f"{a} = {a} || {v};")
                elif comb == "all":
                    self.line(f"{a} = {a} && {v};")
                else:
                    test = "above" if comb == "argmax" else "below"
                    self.line(f"if (traced::{test}({v}, {a})) {{ {a} = {v}; {accs[1]} = {flat}; }}")

        # the group combines float sums, maxima and minima exactly as K7's
        # group sums do; any other reduction stays whole in every thread
        exact = all(comb in _GROUP_COMBS and vdt == "f" for comb, _, _, _, vdt in items)
        if self.nest(R, body, split=exact):
            for comb, _, _, accs, _ in items:
                self.combine(comb, accs[0])

    def lse(self, term, R, o) -> str:
        """aten's logsumexp of the terms: the shift by the maximum, then
        the sum of exponentials."""
        m = self.var("f", "(-INFINITY)")

        def mx(r):
            self.count(1)
            self.line(f"{m} = traced::maximum({m}, {term(o, r)});")

        if self.nest(R, mx, split=True):
            self.combine("max", m)
        sh = self.tmp("f", f"traced::lse_shift({m})")
        s = self.var("f", "0.0f")

        def add(r):
            self.count(3)
            self.line(f"{s} += expf({term(o, r)} - {sh});")

        if self.nest(R, add, split=True):
            self.combine("sum", s)
        self.count(2)
        return self.tmp("f", f"(logf({s}) + {sh})")

    def reduce_element(self, n: _Node, o) -> str:
        """Element ``o`` of a reduction, its terms looped here."""
        comb, R, term, vdt = self.red_spec(n)
        if comb == "lse":
            return self.lse(term, R, o)
        accs: list[str] = []
        self.reduce_loop(R, [(comb, term, tuple(o), accs, vdt)])
        return accs[1] if n.op in ("argmax.default", "argmin.default") else accs[0]

    # -- materialised nodes
    def out_indices(self, shape):
        return [tuple(_unravel(j, shape)) for j in range(math.prod(shape))]

    def emit(self, n: _Node) -> None:
        op = n.op
        if op == "getitem":
            src = n.args[0]
            n.kind, n.val = src.outs_val[n.args[1]]
            return
        if n.kind == "scal":
            if op in _REDUCE:
                self.emit_reduce_scal([n])
            elif op in _SEQ:
                self.emit_seq(n)
            else:
                n.val = [self.tmp(n.dtype, self.rule(n, o)) for o in self.out_indices(n.shape)]
            return
        if n.kind == "arr":
            if op in _SCATTERS:
                self.emit_scatter(n)
            elif op in _SEQ:
                self.emit_seq(n)
            elif op in _STACKS:
                self.emit_stack(n)
            else:
                self.emit_arr(n, lambda o: self.reduce_element(n, o))
            return
        if n.kind == "tuple":
            self.emit_tuple(n)
            return
        raise AssertionError(f"{op}: {n.kind}")

    def declare_arr(self, dt: str, size: int) -> str:
        name = self.fresh("t")
        self.line(f"{_CT[dt]} {name}[{size}];")
        return name

    def emit_arr(self, n, value) -> None:
        name = self.declare_arr(n.dtype, n.numel)

        def body(o):
            self.line(f"{name}[{_lin(o, n.shape)}] = {value(o)};")

        self.nest(list(n.shape), body)
        n.val = name

    def emit_stack(self, n: _Node) -> None:
        """A cat or stack into an array, part by part (each part's elements
        written where they land)."""
        name = self.declare_arr(n.dtype, n.numel)
        dim = _dim(n.args[1], len(n.shape))
        at = 0
        for t in n.args[0]:
            for idx in self.out_indices(t.shape):
                dst = list(idx)
                if n.op == "stack.default":
                    dst.insert(dim, at)
                else:
                    dst[dim] += at
                self.line(f"{name}[{_lin(dst, n.shape)}] = {self.cast(t, idx, n.dtype)};")
            at += 1 if n.op == "stack.default" else (t.shape[dim] if t.numel else 0)
        n.val = name

    def emit_reduce_scal(self, group) -> None:
        """Small-output reductions with one loop domain: one nest."""
        items, owners = [], []
        for n in group:
            comb, R, term, vdt = self.red_spec(n)
            if comb == "lse":
                n.val = [self.lse(term, R, o) for o in self.out_indices(n.shape)]
                continue
            for o in self.out_indices(n.shape):
                accs: list[str] = []
                items.append((comb, term, o, accs, vdt))
                owners.append((n, accs))
        if items:
            self.reduce_loop(R, items)
        for n in group:
            if n.val is None:
                pick = 1 if n.op in ("argmax.default", "argmin.default") else 0
                n.val = [accs[pick] for m, accs in owners if m is n]

    def emit_tuple(self, n: _Node) -> None:
        outs = n.outs or {}
        if n.op in ("cummax.default", "cummin.default"):
            self.emit_cum_extreme(n)
            return
        if n.op in ("max.dim", "min.dim"):
            vals, idxs = outs.get(0), outs.get(1)
            ref = vals or idxs
            shape = ref.shape
            comb, R, term, vdt = self.red_spec(n)
            if math.prod(shape) <= UNROLL:
                vs, ix = [], []
                for o in self.out_indices(shape):
                    accs: list[str] = []
                    self.reduce_loop(R, [(comb, term, o, accs, vdt)])
                    vs.append(accs[0])
                    ix.append(accs[1])
                n.outs_val = {0: ("scal", vs), 1: ("scal", ix)}
            else:
                va, ia = self.declare_arr(vdt, math.prod(shape)), self.declare_arr("i",
                                                                                   math.prod(shape))

                def body(o):
                    accs: list[str] = []
                    self.reduce_loop(R, [(comb, term, o, accs, vdt)])
                    flat = _lin(o, shape)
                    self.line(f"{va}[{flat}] = {accs[0]}; {ia}[{flat}] = {accs[1]};")

                self.nest(list(shape), body)
                n.outs_val = {0: ("arr", va), 1: ("arr", ia)}
            return
        # sort: values and their original indices along dim
        x = n.args[0]
        if n.op == "sort.stable":
            dim, desc = n.args[2], bool(n.args[3])
        else:
            dim, desc = n.args[1], bool(n.args[2])
        nd = len(x.shape)
        dim = _dim(dim, nd) if nd else 0
        L = x.shape[dim] if nd else 1
        rows = [o for o in self.out_indices(tuple(s for d, s in enumerate(x.shape) if d != dim))]
        desc_lit = "true" if desc else "false"
        if x.numel <= UNROLL:
            vals = [None] * x.numel
            idxs = [None] * x.numel
            for row in rows:
                at = [tuple(row[:dim]) + (j,) + tuple(row[dim:]) for j in range(L)]
                sv = [self.var(x.dtype, self.elem(x, a)) for a in at]
                si = [self.var("i", str(j)) for j in range(L)]
                for rnd in range(L):
                    for j in range(rnd % 2, L - 1, 2):
                        self.count(2)
                        self.line(f"traced::cswap({sv[j]}, {si[j]}, {sv[j + 1]}, {si[j + 1]}, "
                                  f"{desc_lit});")
                for j, a in enumerate(at):
                    flat = _lin(a, x.shape) if nd else 0
                    vals[flat], idxs[flat] = sv[j], si[j]
            n.outs_val = {0: ("scal", vals), 1: ("scal", idxs)}
            return
        va, ia = self.declare_arr(x.dtype, x.numel), self.declare_arr("i", x.numel)
        stride = _strides(x.shape)[dim] if nd else 1

        def body(row):
            start = _lin(tuple(row[:dim]) + (0,) + tuple(row[dim:]), x.shape)
            jv = self.fresh("i")
            self.line(f"for (int {jv} = 0; {jv} < {L}; ++{jv}) {{")
            self.push(L)
            at = tuple(row[:dim]) + (jv,) + tuple(row[dim:])
            flat = _lin(at, x.shape)
            self.line(f"{va}[{flat}] = {self.elem(x, at)}; {ia}[{flat}] = {jv};")
            self.pop()
            self.line("}")
            a, v, p, k = self.fresh("i"), self.fresh("s"), self.fresh("p"), self.fresh("k")
            self.line(f"for (int {a} = 1; {a} < {L}; ++{a}) {{")
            self.push(L)
            self.count(2 * L)
            el = lambda j: f"{_iadd(start, f'({j}) * {stride}')}"  # noqa: E731
            self.line(f"const {_CT[x.dtype]} {v} = {va}[{el(a)}]; const int {p} = {ia}[{el(a)}];")
            self.line(f"int {k} = {a} - 1;")
            self.line(f"while ({k} >= 0 && traced::sort_after({va}[{el(k)}], {ia}[{el(k)}], {v}, "
                      f"{p}, {desc_lit})) {{")
            self.line(f"  {va}[{el(k + ' + 1')}] = {va}[{el(k)}]; "
                      f"{ia}[{el(k + ' + 1')}] = {ia}[{el(k)}]; --{k};")
            self.line("}")
            self.line(f"{va}[{el(k + ' + 1')}] = {v}; {ia}[{el(k + ' + 1')}] = {p};")
            self.pop()
            self.line("}")

        if len(rows) > UNROLL * 4:
            raise UnsupportedOpError(f"sort of {len(rows)} rows of {L}")
        for row in rows:
            body(list(row))
        n.outs_val = {0: ("arr", va), 1: ("arr", ia)}

    def emit_cum_extreme(self, n: _Node) -> None:
        """cummax, cummin along one dimension: values and indices as aten
        computes them (a later equal value, or any NaN, takes the place,
        ``traced::cum_takes``); their backward is the scatter_add aten's
        ``cummaxmin_backward`` traces to."""
        x = n.args[0]
        nd = len(x.shape)
        dim = _dim(n.args[1], nd) if nd else 0
        L = x.shape[dim] if nd else 1
        dt = x.dtype
        kind = "true" if n.op == "cummax.default" else "false"
        rest = tuple(s for d, s in enumerate(x.shape) if d != dim)

        def at(row, j):
            return tuple(row[:dim]) + (j,) + tuple(row[dim:]) if nd else ()

        if x.numel <= UNROLL:
            vals, idxs = [None] * max(x.numel, 1), [None] * max(x.numel, 1)
            for row in self.out_indices(rest):
                out = ix = None
                for j in range(L):
                    v = self.elem(x, at(row, j))
                    if out is None:
                        out, ix = self.tmp(dt, v), "0"
                    else:
                        self.count(1 if dt == "f" else 0)
                        take = self.tmp("b", f"traced::cum_takes({v}, {out}, {kind})")
                        out = self.tmp(dt, f"({take} ? {v} : {out})")
                        ix = self.tmp("i", f"({take} ? {j} : {ix})")
                    flat = _lin(at(row, j), x.shape) if nd else 0
                    vals[flat], idxs[flat] = out, ix
            n.outs_val = {0: ("scal", vals), 1: ("scal", idxs)}
            return
        va, ia = self.declare_arr(dt, x.numel), self.declare_arr("i", x.numel)

        def body(row):
            row = list(row)
            first = _lin(at(row, 0), x.shape)
            out = self.var(dt, self.elem(x, at(row, 0)))
            ix = self.var("i", "0")
            self.line(f"{va}[{first}] = {out}; {ia}[{first}] = {ix};")
            jv = self.fresh("i")
            self.line(f"for (int {jv} = 1; {jv} < {L}; ++{jv}) {{")
            self.push(L - 1)
            self.count(1 if dt == "f" else 0)
            v = self.elem(x, at(row, jv))
            self.line(f"if (traced::cum_takes({v}, {out}, {kind})) {{ {out} = {v}; {ix} = {jv}; }}")
            flat = _lin(at(row, jv), x.shape)
            self.line(f"{va}[{flat}] = {out}; {ia}[{flat}] = {ix};")
            self.pop()
            self.line("}")

        self.nest(list(rest), body)
        n.outs_val = {0: ("arr", va), 1: ("arr", ia)}

    def emit_seq(self, n: _Node) -> None:
        """cumsum, cumprod, logcumsumexp along one dimension."""
        x, dim = n.args[0], n.args[1]
        nd = len(n.shape)
        dim = _dim(dim, nd) if nd else 0
        L = n.shape[dim] if nd else 1
        dt = n.dtype
        rest = tuple(s for d, s in enumerate(n.shape) if d != dim)
        kind = n.op.split(".")[0]

        def step(acc, v):
            if kind == "cumsum":
                self.count(1)
                return f"({acc} + {v})"
            if kind == "cumprod":
                self.count(1)
                return f"({acc} * {v})"
            self.count(4)
            return f"traced::log_add_exp({acc}, {v})"

        def at(row, j):
            return tuple(row[:dim]) + (j,) + tuple(row[dim:]) if nd else ()

        if n.kind == "scal":
            vals = [None] * n.numel
            for row in self.out_indices(rest):
                acc = None
                for j in range(L):
                    v = self.cast(x, at(row, j), dt)
                    acc = v if acc is None else self.tmp(dt, step(acc, v))
                    vals[_lin(at(row, j), n.shape) if nd else 0] = acc
            n.val = vals
            return
        name = self.declare_arr(dt, n.numel)

        def body(row):
            first = self.cast(x, at(row, 0), dt)
            acc = self.var(dt, first)
            self.line(f"{name}[{_lin(at(row, 0), n.shape)}] = {acc};")
            jv = self.fresh("i")
            self.line(f"for (int {jv} = 1; {jv} < {L}; ++{jv}) {{")
            self.push(L - 1)
            self.line(f"{acc} = {step(acc, self.cast(x, at(row, jv), dt))};")
            self.line(f"{name}[{_lin(at(row, jv), n.shape)}] = {acc};")
            self.pop()
            self.line("}")

        self.nest(list(rest), lambda r: body(list(r)))
        n.val = name

    def emit_scatter(self, n: _Node) -> None:
        op, dt = n.op, n.dtype
        base = n.args[0]
        name = self.declare_arr(dt, n.numel)

        def copy(o):
            self.line(f"{name}[{_lin(o, n.shape)}] = {self.cast(base, o, dt)};")

        self.nest(list(n.shape), copy)
        if op == "index_put.default":
            indices, values, accumulate = n.args[1], n.args[2], bool(n.args[3])
            pos = [k for k, t in enumerate(indices) if t is not None]
            B = list(torch.broadcast_shapes(*[indices[k].shape for k in pos]))
            rest = [s for k, s in enumerate(n.shape) if k >= len(indices) or indices[k] is None]
            if pos == list(range(pos[0], pos[-1] + 1)):
                vshape = rest[:pos[0]] + B + rest[pos[0]:]
            else:
                vshape = B + rest

            def put(o):
                tgt = self.adv_index(n.shape, indices, o)
                v = self.cast(values, _bcast_idx(list(o), values.shape), dt)
                self.count(1 if accumulate and dt == "f" else 0)
                self.line(f"{name}[{_lin(tgt, n.shape)}] {'+=' if accumulate else '='} {v};")

            self.nest(vshape, put)
        else:
            dim, index = _dim(n.args[1], len(n.shape)), n.args[2]
            add = op == "scatter_add.default"

            def put(o):
                tgt = list(o)
                tgt[dim] = self.wrap(self.elem(index, o), n.shape[dim])
                v = (_lit(n.args[3], dt) if op == "scatter.value"
                     else self.cast(n.args[3], o, dt))
                self.count(1 if add and dt == "f" else 0)
                self.line(f"{name}[{_lin(tgt, n.shape)}] {'+=' if add else '='} {v};")

            self.nest(list(index.shape), put)
        n.val = name


def _simple(expr: str) -> bool:
    return expr.replace("_", "").isalnum() or expr.startswith(("q[", "qs[")) \
        and expr.count("[") == 1 or _is_literal(expr)


def _is_literal(expr: str) -> bool:
    e = expr.strip("()")
    if e in ("true", "false", "NAN", "INFINITY", "-INFINITY"):
        return True
    try:
        float.fromhex(e[:-1]) if e.endswith("f") and "0x" in e else int(e)
        return True
    except ValueError:
        return False


# -- classification and scheduling -------------------------------------------------------


def _classify(n: _Node) -> str:
    op = n.op
    if op == "getitem":
        return "alias"
    if op in _TUPLES:
        return "tuple"
    if op in _VIEWS or op in _PIECEWISE or op in _GATHERS:
        return "lazy"
    if _is_ew(op):
        return "lazy" if n.numel > SCALARS else "scal"
    if op in _REDUCE:
        R = 1
        x = n.args[0]
        if op in _CONTRACT:
            R = x.shape[-1]
        else:
            R = x.numel // max(n.numel, 1)
        if n.numel > SCALARS:
            return "lazy" if R <= UNROLL else "arr"
        return "scal"
    if op in _SEQ:
        return "scal" if n.numel <= UNROLL else "arr"
    if op in _SCATTERS:
        return "arr"
    raise UnsupportedOpError(f"no lowering rule for aten.{op}")


def _lower(nodes, q, outputs, D):
    grad, value = outputs
    # live nodes: those the outputs reach
    live, stack = set(), [grad, value]
    while stack:
        n = stack.pop()
        if n.i in live:
            continue
        live.add(n.i)
        if n.const is None:
            stack.extend(_tensor_args(n.args))
            if n.outs:
                stack.extend(n.outs.values())
    nodes = [n for n in nodes if n.i in live]
    unsupported = sorted({n.op for n in nodes if n.const is None and n.kind != "input"
                          and not _supported(n.op)})
    if unsupported:
        raise UnsupportedOpError("no lowering rule for " + ", ".join(f"aten.{o}"
                                                                       for o in unsupported))
    work = [n for n in nodes if n.const is None and n.kind != "input"]
    if len(work) > NODE_CAP:
        raise UnsupportedOpError(f"the graph has {len(work)} position-dependent nodes, past the "
                                 f"{NODE_CAP} the compiler takes")
    # constants: literals, or the operand buffer
    chunks, offsets, at = [], {}, 0
    for n in nodes:
        if n.const is None:
            continue
        t = n.const
        if isinstance(t, (tuple, list)):
            continue
        flat = t.detach().reshape(-1).cpu()
        if n.numel == 0:
            raise UnsupportedOpError("an empty constant")
        if not n.data and bool((flat == flat[0]).all()) or (
                n.dtype == "f" and not n.data and bool(torch.isnan(flat).all())):
            n.kind, n.val = "splat", _lit(flat[0].item(), n.dtype)
            continue
        key = n.fx.target if n.op == "const" else ("node", n.i)
        if key not in offsets:
            if n.dtype == "f":
                vals = flat.to(torch.float32)
            elif n.dtype == "i":
                if flat.numel() and (int(flat.min()) < -2**31 or int(flat.max()) >= 2**31):
                    raise UnsupportedOpError("an integer constant past int32")
                vals = flat.to(torch.int32).view(torch.float32)
            else:
                vals = flat.to(torch.float32)
            offsets[key] = at
            chunks.append(vals)
            at += vals.numel()
        n.kind, n.val = "const", offsets[key]
    operands = torch.cat(chunks) if chunks else torch.zeros(1)
    for n in nodes:
        if n.const is None and n.kind != "input":
            n.kind = _classify(n)
    if grad.dtype != "f" or value.dtype != "f" or grad.shape != (D,) or value.shape != ():
        raise UnsupportedOpError("the log density is not a float scalar of the position")
    # emission sets the nodes' values; the group form starts from this state
    state = [(n, n.kind, n.val, n.outs_val) for n in nodes]
    wide = D > MAX_D
    em = None if wide else _schedule(_Emitter(), nodes, grad, value, D)
    for n, kind, val, outs_val in state:
        n.kind, n.val, n.outs_val = kind, val, outs_val
        # a cat or stack of scalars (an unrolled recursion's states) is an
        # array in the group form: a split loop reads it at a runtime index,
        # where the lazy form is a branch a part (nvcc takes minutes on a
        # 64-way branch in a loop it cannot unroll)
        if kind == "lazy" and n.op in _STACKS and all(
                isinstance(t, _Node) and t.numel <= SCALARS for t in n.args[0]):
            n.kind = "arr"
    group = _schedule(_Emitter(group=True, wide=wide), nodes, grad, value, D)
    return em, group, operands, len(work), sorted({n.op for n in work})


def _schedule(em: _Emitter, nodes, grad, value, D) -> _Emitter:
    """Emit the value and gradient of ``nodes`` into ``em``: the one-lane
    body (``g[j] = ...; return U;``) or, for a group emitter, the group
    form's, whose threads all compute every value outside the split loops
    and whose rank 0 writes the gradient before the group's barrier."""
    # the materialised nodes, their materialised inputs (through the lazy ones)
    md: dict[int, frozenset] = {}
    mat = []
    for n in nodes:
        if n.kind in ("const", "splat", "input"):
            md[n.i] = frozenset()
            continue
        ins = frozenset().union(*[md[a.i] for a in _tensor_args(n.args)])
        if n.kind == "lazy":
            md[n.i] = ins
        else:
            md[n.i] = frozenset([n.i])
            mat.append((n, ins - {n.i}))
    by_i = {n.i: n for n in nodes}
    pending = {n.i: len(deps) for n, deps in mat}
    users: dict[int, list] = {}
    for n, deps in mat:
        for d in deps:
            users.setdefault(d, []).append(n.i)

    def sink_key(n):
        """Reductions to a few scalars over the same terms share one nest."""
        if n.kind != "scal" or n.op not in _REDUCE or _REDUCE[n.op] == "lse":
            return None
        return tuple(em.red_spec(n)[1])

    keys = {n.i: sink_key(n) for n, _ in mat}
    ready_plain, ready_sinks = [], {}

    def release(i):
        if keys[i] is None:
            heapq.heappush(ready_plain, i)
        else:
            ready_sinks.setdefault(keys[i], []).append(i)

    for n, deps in mat:
        if not deps:
            release(n.i)
    done = 0
    while ready_plain or ready_sinks:
        if ready_plain:
            group = [heapq.heappop(ready_plain)]
            em.emit(by_i[group[0]])
        else:
            key = min(ready_sinks, key=lambda k: min(ready_sinks[k]))
            group = sorted(ready_sinks.pop(key))
            em.emit_reduce_scal([by_i[i] for i in group])
        for i in group:
            done += 1
            for u in users.get(i, ()):
                pending[u] -= 1
                if pending[u] == 0:
                    release(u)
    if done != len(mat):
        raise AssertionError("the schedule left nodes behind")
    if em.wide:
        # the gradient a coordinate a thread, strided over the group
        u = em.elem(value, ())

        def put(k):
            em.line(f"gs[{k[0]}] = {em.elem(grad, k)};")

        em.nest([D], put, split=True)
        em.line("grp.sync();")
        em.line(f"return {u};")
        return em
    outs = [em.elem(grad, (j,)) for j in range(D)]
    if not em.group:
        for j, v in enumerate(outs):
            em.line(f"g[{j}] = {v};")
        em.line(f"return {em.elem(value, ())};")
        return em
    u = em.elem(value, ())
    em.line("if (grp.r == 0) {")
    for j, v in enumerate(outs):
        em.line(f"  gs[{j}] = {v};")
    em.line("}")
    em.line("grp.sync();")
    em.line(f"return {u};")
    return em


_TEMPLATE = """\
// Generated by binf_tpu_torch/ops/kernels/density_compiler.py from the aten
// graph of a log density's value and gradient: {nodes} position-dependent
// nodes, {flops} float operations an evaluation, {nf} operand floats.
// Ops: {ops}.
#pragma once

#include "traced_density.cuh"

namespace binf {{

struct {name} : TracedDensity<{D}, {nf}> {{
  static constexpr long long kFlops = {flops};

  __host__ __device__ __forceinline__ float value_and_grad(const float (&q)[{D}],
                                                           float (&g)[{D}]) const {{
    const float* __restrict__ c = this->c;
    (void)c;
{body}
  }}
}};
BINF_TRACED_DEVICE({name})

}}  // namespace binf
"""


_GROUP_TEMPLATE = """\

// The group form, K7's entry: every thread of a chain's group calls it,
// after the group's barrier that follows the writes of the position qs,
// which the group shares with the gradient gs.  The outermost runtime loop
// of each float sum, max or min nest strides over the group's threads
// ({rows} terms at most) and the partials meet in grp.sum / grp.max /
// grp.min, the same bits in every thread; everything else (nests the text
// unrolls, other reductions, sorts and scans) is computed in every thread.
// Rank 0 writes gs before the group's barrier.
namespace binf {{

struct {gname} : {name} {{
  static constexpr int kGroupRows = {rows};

  template <class Group>
  __device__ __forceinline__ float value_and_grad(const float* __restrict__ qs,
                                                  float* __restrict__ gs,
                                                  const Group& grp) const {{
    const float* __restrict__ c = this->c;
    (void)c;
    float q[{D}];
    for (int k = 0; k < {D}; ++k) q[k] = qs[k];
{body}
  }}
}};

}}  // namespace binf
"""


_WIDE_TEMPLATE = """\
// Generated by binf_tpu_torch/ops/kernels/density_compiler.py from the aten
// graph of a log density's value and gradient: {nodes} position-dependent
// nodes, {flops} float operations an evaluation, {nf} operand floats.
// Ops: {ops}.
// {D} coordinates, past the one-lane functor's {narrow}: the wide form alone.
#pragma once

#include "traced_density.cuh"

namespace binf {{

struct {name} : TracedDensity<{D}, {nf}> {{
  static constexpr long long kFlops = {flops};
}};

// The wide form, the entry of K3's and K4's wide branches and of K7 (each
// a group of warps a chain): every thread of the chain's group
// calls it after the group's barrier that follows the writes of the
// position qs (shared memory), which it reads where it uses it.  The
// outermost runtime loop of each float sum, max or min nest strides over
// the group's threads ({rows} terms at most) and the partials meet in
// grp.sum / grp.max / grp.min, the same bits in every thread; the gradient
// is one loop over the coordinates, strided the same way, each thread
// writing its own of gs; everything else is computed in every thread.  It
// ends at the group's barrier.
struct {gname} : {name} {{
  static constexpr bool kWide = true;
  static constexpr int kGroupRows = {rows};

  template <class Group>
  __device__ __forceinline__ float value_and_grad(const float* __restrict__ qs,
                                                  float* __restrict__ gs,
                                                  const Group& grp) const {{
    const float* __restrict__ c = this->c;
    (void)c;
{body}
  }}
}};
BINF_TRACED_WIDE({gname})

}}  // namespace binf
"""


def compile_density(logdensity_fn, template: dict) -> CompiledDensity:
    """Trace ``logdensity_fn`` (a log density over position dicts shaped
    like ``template``, traced on the template's device, where its data must
    lie) and lower its potential and gradient to a functor.  Raises
    :class:`UnsupportedOpError` for what the compiler refuses, and any
    other failure of the trace as it is; no CUDA is needed (``_build``
    compiles the source)."""
    from binf_tpu_torch.ops.kernels.fused_potential import pack_template

    t0 = time.perf_counter()
    spec = pack_template(template)
    D = sum(size for _, _, size in spec)
    if D == 0:
        raise UnsupportedOpError("the position has no coordinates")
    if D > MAX_D_WIDE:
        raise UnsupportedOpError(f"the position has {D} coordinates; a traced functor takes "
                                 f"at most {MAX_D_WIDE} (no CUDA functor runs it)")
    gm = _trace(logdensity_fn, spec, D, torch.as_tensor(next(iter(template.values()))).device)
    nodes, q, outputs = _build_graph(gm)
    em, group, operands, n_nodes, ops = _lower(nodes, q, outputs, D)
    if em is None:
        return _wide(D, group, operands, n_nodes, ops, t0)
    body = "\n".join(em.lines)
    src = _TEMPLATE.format(nodes=n_nodes, flops=em.flops, nf=operands.numel(),
                           ops=", ".join(ops) or "none", name="@NAME@", D=D, body=body)
    key = hashlib.sha256(src.encode()).hexdigest()[:16]
    name, gname = f"Traced_{key}", f"TracedGroup_{key}"
    gsrc = _GROUP_TEMPLATE.format(gname=gname, name=name, rows=group.split_rows, D=D,
                                  body="\n".join(group.lines))
    return CompiledDensity(D, key, name, src.replace("@NAME@", name), operands.contiguous(),
                           em.flops, n_nodes, src.count("\n") + 1,
                           (time.perf_counter() - t0) * 1e3, tuple(ops), gname, gsrc,
                           group.split_rows)


def _wide(D, em, operands, n_nodes, ops, t0) -> CompiledDensity:
    """The header of a position past ``MAX_D``: the base functor (the
    operands) and the wide form, keyed by the hash of both texts."""
    src = _WIDE_TEMPLATE.format(nodes=n_nodes, flops=em.flops, nf=operands.numel(),
                                ops=", ".join(ops) or "none", D=D, narrow=MAX_D,
                                name="@NAME@", gname="@GNAME@", rows=em.split_rows,
                                body="\n".join(em.lines))
    key = hashlib.sha256(src.encode()).hexdigest()[:16]
    name, gname = f"Traced_{key}", f"TracedWide_{key}"
    src = src.replace("@GNAME@", gname).replace("@NAME@", name)
    base, wide = src.split("\n// The wide form", 1)
    return CompiledDensity(D, key, name, base + "\n", operands.contiguous(), em.flops, n_nodes,
                           src.count("\n") + 1, (time.perf_counter() - t0) * 1e3, tuple(ops),
                           gname, "// The wide form" + wide, em.split_rows)


# -- the host build ---------------------------------------------------------------------

_HOST_EVAL_ONE = """\
extern "C" int binf_host_eval_{key}(const float* c, const float* q, int n, float* U,
                                    float* g) {{
  binf::{name} dens;
  dens.c = c;
  for (int i = 0; i < n; ++i) {{
    float x[{D}], gx[{D}];
    for (int k = 0; k < {D}; ++k) x[k] = q[(long)i * {D} + k];
    U[i] = dens.value_and_grad(x, gx);
    for (int k = 0; k < {D}; ++k) g[(long)i * {D} + k] = gx[k];
  }}
  return 0;
}}
"""

# a wide form has no one-lane entry: its group form on one host thread
_HOST_EVAL_ONE_WIDE = """\
extern "C" int binf_host_eval_{key}(const float* c, const float* q, int n, float* U,
                                    float* g) {{
  return binf_host_group_eval_{key}(c, q, n, U, g, 1);
}}
"""

_HOST_EVAL = """\
// The group form on T host threads; returns how many (position, thread)
// pairs gave U bits other than rank 0's.
extern "C" int binf_host_group_eval_{key}(const float* c, const float* q, int n, float* U,
                                          float* g, int T) {{
  binf::{gname} dens;
  dens.c = c;
  BinfHostGroupShared shared(T);
  std::vector<float> us((size_t)n * T);
  std::vector<std::thread> threads;
  for (int r = 0; r < T; ++r)
    threads.emplace_back([&, r] {{
      const BinfHostGroup grp{{r, T, &shared}};
      for (int i = 0; i < n; ++i)
        us[(size_t)i * T + r] = dens.value_and_grad(q + (long)i * {D}, g + (long)i * {D}, grp);
    }});
  for (auto& t : threads) t.join();
  int differ = 0;
  for (int i = 0; i < n; ++i) {{
    U[i] = us[(size_t)i * T];
    for (int r = 1; r < T; ++r) differ += memcmp(&us[(size_t)i * T + r], &U[i], sizeof(float)) != 0;
  }}
  return differ;
}}
"""


def build_host_library(compiled, out_dir) -> ctypes.CDLL:
    """Compile the functors of ``compiled`` (``CompiledDensity``\\ s) as host
    C++ with ``g++`` into one shared library under ``out_dir``, each with an
    entry point ``binf_host_eval_<key>`` (:func:`host_eval`)."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host build of traced functors needs it")
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    seen, parts = set(), ['#include "host_compat.h"', '#include "traced_density.cuh"',
                          "#include <thread>"]
    for cd in compiled:
        if cd.key in seen:
            continue
        seen.add(cd.key)
        parts.append(cd.header.replace("#pragma once\n", ""))
        parts.append(_HOST_EVAL.format(key=cd.key, gname=cd.group_name, D=cd.D))
        parts.append((_HOST_EVAL_ONE_WIDE if cd.wide else _HOST_EVAL_ONE).format(
            key=cd.key, name=cd.name, D=cd.D))
    text = "\n".join(parts)
    tag = hashlib.sha256(text.encode()).hexdigest()[:12]
    src, lib = out_dir / f"traced_{tag}.cpp", out_dir / f"libtraced_{tag}.so"
    if not lib.exists():
        src.write_text(text)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-pthread", "-w", "-I",
                               str(CSRC), "-o", str(tmp), str(src)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {src}:\n{proc.stderr[-4000:]}")
        os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))


def host_eval(lib: ctypes.CDLL, cd: CompiledDensity, q,
              threads: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """``(U (n,), grad U (n, D))`` of the host-built functor at ``q (n,
    D)``: the one-lane entry, or with ``threads`` the group form on a
    group of that many host threads (raises if any thread's U differs
    from rank 0's in a bit)."""
    q = np.ascontiguousarray(np.asarray(q, np.float32).reshape(-1, cd.D))
    ops = np.ascontiguousarray(cd.operands.numpy().astype(np.float32))
    U = np.empty(q.shape[0], np.float32)
    g = np.empty_like(q)
    P = ctypes.POINTER(ctypes.c_float)
    args = [ops.ctypes.data_as(P), q.ctypes.data_as(P), q.shape[0], U.ctypes.data_as(P),
            g.ctypes.data_as(P)]
    if threads is None:
        fn = getattr(lib, f"binf_host_eval_{cd.key}")
        fn.argtypes = [P, P, ctypes.c_int, P, P]
        fn(*args)
        return U, g
    fn = getattr(lib, f"binf_host_group_eval_{cd.key}")
    fn.argtypes = [P, P, ctypes.c_int, P, P, ctypes.c_int]
    differ = fn(*args, threads)
    if differ:
        raise AssertionError(f"the group form on {threads} threads: {differ} (position, "
                             "thread) pairs gave U bits other than rank 0's")
    return U, g
