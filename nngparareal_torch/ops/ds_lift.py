"""Automatic double-single lifting of the port's f64 torch vector fields.

Port of ``nngparareal_tpu/ops/ds_lift.py``. ``ds_lift(f)`` turns a field
``f(t, u) -> du`` written in f64 torch ops into its compensated-f32 twin
``f_ds(t, (uh, ul)) -> (kh, kl)``. The JAX package traces ``f`` to a
jaxpr and re-interprets each primitive; eager torch has no trace, so here
the state goes through ``f`` as a ``DSPair``: a (hi, lo) pair whose
Python operators and ``__torch_function__`` apply the same rules as the
JAX interpreter's ``_apply_ds``:

* ``+ - * /`` are ``ds_add``, ``ds_sub``, ``ds_mul`` and ``ds_div`` (the
  pair's operand order is the expression's); a Python-float or f64
  tensor constant is split into a full (hi, lo) pair first
  (``_split_host``), so ``c * x`` is ``ds_mul``, not ``ds_mul_f32``;
* ``x ** k`` for an integer k is ``_pow_ds``'s binary exponentiation
  (a negative k divides 1 by it); any other exponent raises;
* ``torch.sin`` and ``torch.cos`` are ``ds_sin`` and ``ds_cos``;
* the structural operations (indexing, ``reshape``, ``torch.roll``,
  ``torch.stack``, ``torch.cat``, ``torch.where``) act on both halves
  alike; ``torch.empty_like``, ``ones_like`` and ``zeros_like`` make
  pairs, and ``out=`` writes both halves of a pair;
* comparisons subtract in ds and compare hi + lo with 0; ``maximum``,
  ``minimum`` and ``abs`` follow the JAX rules (the hi words decide,
  the lo words break a tie).

Any other torch function raises ``NotImplementedError`` naming it, so a
field that cannot hold the ds floor fails loudly: DiffReact's
``torch.matmul`` is the one shipped case, as JAX's ``dot_general`` is.

Time stays f64 and is handed to the field as it is (the fields are
autonomous; a field that reads t gets it split into a pair where it meets
the state).
"""

import functools
import operator

import numpy as np
import torch

from nngparareal_torch.ops import ds32


class DSPair:
    """A (hi, lo) f32 pair flowing through an f64 torch field."""

    __slots__ = ("hi", "lo")

    def __init__(self, hi, lo):
        self.hi = hi
        self.lo = lo

    # --- what the fields read of a tensor ---

    @property
    def shape(self):
        return self.hi.shape

    @property
    def device(self):
        return self.hi.device

    def __getitem__(self, idx):
        return DSPair(self.hi[idx], self.lo[idx])

    def reshape(self, *shape):
        return DSPair(self.hi.reshape(*shape), self.lo.reshape(*shape))

    def to(self, dtype):
        """f64 keeps the pair (it already carries ~48 bits); any other
        type collapses it to hi + lo in that type."""
        if dtype == torch.float64:
            return self
        return (self.hi + self.lo).to(dtype)

    # --- arithmetic ---

    def __add__(self, other):
        return _binary("add", self, other)

    def __radd__(self, other):
        return _binary("add", other, self)

    def __sub__(self, other):
        return _binary("sub", self, other)

    def __rsub__(self, other):
        return _binary("sub", other, self)

    def __mul__(self, other):
        return _binary("mul", self, other)

    def __rmul__(self, other):
        return _binary("mul", other, self)

    def __truediv__(self, other):
        return _binary("div", self, other)

    def __rtruediv__(self, other):
        return _binary("div", other, self)

    def __neg__(self):
        return DSPair(-self.hi, -self.lo)

    def __abs__(self):
        return _abs(self)

    def __pow__(self, exponent):
        return _pow(self, exponent)

    def __matmul__(self, other):
        raise _no_rule("matmul")

    def __rmatmul__(self, other):
        raise _no_rule("matmul")

    def __gt__(self, other):
        return _compare(operator.gt, self, other)

    def __lt__(self, other):
        return _compare(operator.lt, self, other)

    def __ge__(self, other):
        return _compare(operator.ge, self, other)

    def __le__(self, other):
        return _compare(operator.le, self, other)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        rule = _TORCH_RULES.get(getattr(func, "__name__", None))
        if rule is None:
            raise _no_rule(getattr(func, "__name__", repr(func)))
        out = kwargs.pop("out", None)
        res = rule(*args, **kwargs)
        if out is None:
            return res
        res = _to_ds(res, out)
        out.hi.copy_(res.hi)
        out.lo.copy_(res.lo)
        return out


def _no_rule(name):
    return NotImplementedError(
        f"ds_lift: '{name}' has no double-single rule; add one in "
        "nngparareal_torch/ops/ds_lift.py or give this system a "
        "hand-written ds field")


@functools.lru_cache(maxsize=None)
def _const_pair(value, device):
    hi = np.float32(value)
    lo = np.float32(value - float(hi))
    return (torch.tensor(float(hi), dtype=torch.float32, device=device),
            torch.tensor(float(lo), dtype=torch.float32, device=device))


def _split_host(x, device):
    """The exact ds split of a Python number, or of an f64 (or f32)
    tensor, on ``device``."""
    if isinstance(x, torch.Tensor):
        return DSPair(*ds32.ds_from_f64(x.to(device=device,
                                             dtype=torch.float64)))
    hi, lo = _const_pair(float(x), torch.device(device))
    return DSPair(hi, lo)


def _to_ds(x, like):
    """``x`` as a pair on the device of the pair ``like``."""
    if isinstance(x, DSPair):
        return x
    return _split_host(x, like.device)


_OPS = {"add": ds32.ds_add, "sub": ds32.ds_sub, "mul": ds32.ds_mul,
        "div": ds32.ds_div}


def _binary(name, a, b):
    like = a if isinstance(a, DSPair) else b
    a, b = _to_ds(a, like), _to_ds(b, like)
    return DSPair(*_OPS[name](a.hi, a.lo, b.hi, b.lo))


def _pow_ds(x, y):
    """x**y for a non-negative integer y by binary exponentiation."""
    if y == 0:
        return _split_host(torch.ones(x.shape, dtype=torch.float64),
                           x.device)
    acc = None
    base = x
    while y:
        if y & 1:
            acc = base if acc is None else DSPair(
                *ds32.ds_mul(acc.hi, acc.lo, base.hi, base.lo))
        y >>= 1
        if y:
            base = DSPair(*ds32.ds_mul(base.hi, base.lo, base.hi, base.lo))
    return acc


def _pow(x, exponent):
    if isinstance(exponent, DSPair):
        exponent = exponent.hi + exponent.lo
    e = np.asarray(exponent.cpu() if isinstance(exponent, torch.Tensor)
                   else exponent)
    if e.ndim != 0 or float(e) != int(float(e)):
        raise NotImplementedError(
            "ds_lift: non-integer pow exponent cannot hold ds accuracy")
    y = int(float(e))
    if y < 0:
        base = _pow_ds(x, -y)
        one = _split_host(1.0, x.device)
        return DSPair(*ds32.ds_div(one.hi, one.lo, base.hi, base.lo))
    return _pow_ds(x, y)


def _compare(op, a, b):
    like = a if isinstance(a, DSPair) else b
    a, b = _to_ds(a, like), _to_ds(b, like)
    d_hi, d_lo = ds32.ds_sub(a.hi, a.lo, b.hi, b.lo)
    d = d_hi + d_lo
    return op(d, torch.zeros_like(d))


def _extremum(a, b, take_max):
    like = a if isinstance(a, DSPair) else b
    a, b = _to_ds(a, like), _to_ds(b, like)
    take_a = (a.hi > b.hi) if take_max else (a.hi < b.hi)
    tie = (a.lo > b.lo) if take_max else (a.lo < b.lo)
    take_a = torch.where(a.hi == b.hi, tie, take_a)
    return DSPair(torch.where(take_a, a.hi, b.hi),
                  torch.where(take_a, a.lo, b.lo))


def _abs(x):
    flip = x.hi < 0
    return DSPair(torch.where(flip, -x.hi, x.hi), torch.where(flip, -x.lo,
                                                              x.lo))


def _pairs(seq):
    like = next(x for x in seq if isinstance(x, DSPair))
    return [_to_ds(x, like) for x in seq]


def _stack(tensors, dim=0):
    vals = _pairs(tensors)
    return DSPair(torch.stack([v.hi for v in vals], dim=dim),
                  torch.stack([v.lo for v in vals], dim=dim))


def _cat(tensors, dim=0):
    vals = _pairs(tensors)
    return DSPair(torch.cat([v.hi for v in vals], dim=dim),
                  torch.cat([v.lo for v in vals], dim=dim))


def _roll(x, shifts, dims=None):
    return DSPair(torch.roll(x.hi, shifts, dims), torch.roll(x.lo, shifts,
                                                             dims))


def _where(cond, a, b):
    like = a if isinstance(a, DSPair) else b
    a, b = _to_ds(a, like), _to_ds(b, like)
    return DSPair(torch.where(cond, a.hi, b.hi), torch.where(cond, a.lo,
                                                             b.lo))


def _like(make_hi, make_lo):
    def rule(x, **kwargs):
        kwargs.pop("dtype", None)
        return DSPair(make_hi(x.hi, **kwargs), make_lo(x.lo, **kwargs))

    return rule


def _unary(fn):
    def rule(x):
        return DSPair(*fn(x.hi, x.lo))

    return rule


def _arith(name):
    def rule(a, b):
        return _binary(name, a, b)

    return rule


_TORCH_RULES = {
    "add": _arith("add"), "sub": _arith("sub"), "mul": _arith("mul"),
    "div": _arith("div"), "neg": operator.neg, "pow": _pow,
    "sin": _unary(ds32.ds_sin), "cos": _unary(ds32.ds_cos), "abs": _abs,
    "maximum": lambda a, b: _extremum(a, b, True),
    "minimum": lambda a, b: _extremum(a, b, False),
    "stack": _stack, "cat": _cat, "roll": _roll, "where": _where,
    "empty_like": _like(torch.empty_like, torch.empty_like),
    "zeros_like": _like(torch.zeros_like, torch.zeros_like),
    "ones_like": _like(torch.ones_like, torch.zeros_like),
    # a tensor's own operators with a pair on their right
    "__add__": _arith("add"), "__radd__": lambda a, b: _binary("add", b, a),
    "__sub__": _arith("sub"), "__rsub__": lambda a, b: _binary("sub", b, a),
    "__mul__": _arith("mul"), "__rmul__": lambda a, b: _binary("mul", b, a),
    "__truediv__": _arith("div"),
    "__rtruediv__": lambda a, b: _binary("div", b, a),
}


def ds_lift(f):
    """Lift ``f(t, u) -> du`` (f64 torch) to ``f_ds(t, (uh, ul)) ->
    (kh, kl)``: the same expression evaluated on the pair."""

    def f_ds(t, u_pair):
        uh, ul = u_pair
        pair = DSPair(uh, ul)
        out = _to_ds(f(t, pair), pair)
        return out.hi, out.lo

    f_ds.lifted_from = f
    return f_ds
