"""The cases of the tensor API's parity checks, shared by
tests/test_torch_tensor_ops.py (the port against the reference on the
host) and chip_smoke.py's tensor_api lane (the port on the card against
the port on the host).

A case calls a package ``P`` (paddle_tpu or paddle_tpu_torch) on tensors
made with ``P.to_tensor`` from fixed numpy arrays. ``post`` maps the
outputs (as numpy arrays) to what is compared, where the raw outputs are
not comparable: the signs of a decomposition's factors, or a random
draw's values (then its shape, dtype and the properties its distribution
guarantees). This module imports neither package and no JAX.
"""
import numpy as np

_R = np.random.RandomState(0)


def _f(*shape, lo=None, hi=None):
    a = _R.randn(*shape).astype("float32")
    if lo is not None:
        a = (lo + (hi - lo) * _R.rand(*shape)).astype("float32")
    return a


def _i(*shape, lo=0, hi=10):
    return _R.randint(lo, hi, shape).astype("int64")


def _spd(n):
    a = _R.randn(n, n).astype("float32")
    return (a @ a.T + n * np.eye(n)).astype("float32")


class Case:
    """One call: ``fn(P, *tensors)``; the id's part before "-" names the
    function it covers."""

    def __init__(self, cid, fn, arrays, post=None, tol=None, oracle=None):
        self.id, self.fn, self.arrays = cid, fn, arrays
        self.post = post
        self.tol = tol or {}
        # numpy's result, for a case the reference cannot run
        self.oracle = oracle

    @property
    def function(self):
        return self.id.split("-")[0]


CASES = []


def case(cid, fn, *arrays, post=None, tol=None, oracle=None):
    CASES.append(Case(cid, fn, list(arrays), post, tol, oracle))


X = _f(3, 4)
Y = _f(3, 4)
POS = _f(3, 4, lo=0.2, hi=2.0)
UNIT = _f(3, 4, lo=-0.9, hi=0.9)
I1 = _i(3, 4, lo=1, hi=20)
I2 = _i(3, 4, lo=1, hi=20)
B1 = _R.rand(3, 4) > 0.5
B2 = _R.rand(3, 4) > 0.5
A4 = _f(4, 4)
SPD = _spd(4)
X3 = _f(2, 3, 4)
LOOSE = {"rtol": 1e-4, "atol": 1e-5}

# -- the cases that tests/test_tensor_ops.py:11-216 and :273-307 hold ---------
case("add", lambda P, x, y: P.add(x, y), X, Y)
case("add-broadcast", lambda P, x, y: P.add(x, y), X, _f(4))
case("multiply", lambda P, x, y: P.multiply(x, y), X, POS)
case("divide", lambda P, x, y: P.divide(x, y), X, POS)
case("subtract", lambda P, x, y: P.subtract(x, y), X, POS)
case("pow", lambda P, x, y: P.pow(x, y), POS, POS)
case("maximum", lambda P, x, y: P.maximum(x, y), X, Y)
case("minimum", lambda P, x, y: P.minimum(x, y), X, Y)
case("clip", lambda P, x: P.clip(x, -0.5, 0.5), X)
case("sum", lambda P, x: P.sum(x), X3)
case("sum-axis", lambda P, x: P.sum(x, axis=1), X3)
case("mean", lambda P, x: P.mean(x, axis=[0, 2], keepdim=True), X3)
case("max", lambda P, x: P.max(x, axis=0), X)
case("min", lambda P, x: P.min(x, axis=1), X)
case("prod", lambda P, x: P.prod(x, axis=1), X)
case("cumsum", lambda P, x: P.cumsum(x, axis=1), X)
case("logsumexp", lambda P, x: P.logsumexp(x, axis=1), X)
case("matmul", lambda P, x, y: P.matmul(x, y), A4, _f(4, 5))
case("matmul-transpose_x", lambda P, x, y: P.matmul(x, y, transpose_x=True),
     _f(4, 3), _f(4, 5))
case("bmm", lambda P, x, y: P.bmm(x, y), _f(2, 3, 4), _f(2, 4, 5))
case("einsum", lambda P, x, y: P.einsum("bij,bjk->bik", x, y), _f(2, 3, 4),
     _f(2, 4, 5))
case("reshape", lambda P, x: P.reshape(x, [6, 4]), X3)
case("transpose", lambda P, x: P.transpose(x, [2, 0, 1]), X3)
case("concat", lambda P, x, y: P.concat([x, y], axis=0), X, Y)
case("stack", lambda P, x, y: P.stack([x, y], axis=1), X, Y)
case("split", lambda P, x: P.split(x, 2, axis=1), X)
case("split-sections", lambda P, x: P.split(x, [1, -1, 2], axis=1), X)
case("gather", lambda P, x, i: P.gather(x, i), _f(5, 3),
     np.array([0, 2, 4]))
case("scatter", lambda P, x, i, u: P.scatter(x, i, u), _f(5, 3),
     np.array([1, 3]), _f(2, 3))
case("scatter-accumulate",
     lambda P, x, i, u: P.scatter(x, i, u, overwrite=False), _f(5, 3),
     np.array([1, 3, 1]), _f(3, 3))
case("squeeze", lambda P, x: P.squeeze(x), _f(1, 3, 1))
case("unsqueeze", lambda P, x: P.unsqueeze(x, 0), _f(1, 3, 1))
case("tile", lambda P, x: P.tile(x, [2, 1]), _f(2, 3))
case("flip", lambda P, x: P.flip(x, [0]), _f(2, 3))
case("where", lambda P, c, x, y: P.where(c, x, y), _R.rand(3, 3) > 0.5,
     _f(3, 3), _f(3, 3))
case("cast", lambda P, x: P.cast(x, "int32"), X * 3)
case("cast-bfloat16", lambda P, x: P.cast(P.cast(x, "bfloat16"), "float32"),
     X)
case("cast-int64", lambda P, x: P.cast(x, "int64"), X * 3)
case("argmax", lambda P, x: P.argmax(x, axis=1), _f(3, 5))
case("topk", lambda P, x: P.topk(x, 2, axis=1), _f(3, 5))
case("sort", lambda P, x: P.sort(x, axis=1, descending=True), _f(3, 5))
case("unique", lambda P, x: P.unique(x), np.array([3, 1, 2, 1, 3]))
case("nonzero", lambda P, x: P.nonzero(x), np.array([0, 1, 0, 2]))
case("to_tensor-int64", lambda P, x: P.to_tensor(x), np.array([1, 2, 3]))
case("to_tensor-float64", lambda P, x: P.to_tensor(x, dtype="float64"),
     np.array([1.0, 2.5]))
case("zeros-int64", lambda P: P.zeros([2], dtype="int64"))
case("arange-int64", lambda P: P.arange(4, dtype="int64"))

# -- attribute -------------------------------------------------------------------
case("shape", lambda P, x: P.shape(x), X3)
case("rank", lambda P, x: P.rank(x), X3)
case("is_floating_point", lambda P, x, i: [P.is_floating_point(x),
                                           P.is_floating_point(i)], X, I1)
case("is_integer_tensor", lambda P, x, i: [P.is_integer_tensor(x),
                                           P.is_integer_tensor(i)], X, I1)
case("is_complex_tensor", lambda P, x: P.is_complex_tensor(x), X)

# -- creation ------------------------------------------------------------------
case("to_tensor", lambda P: P.to_tensor([[1.5, 2.0], [3.0, 4.0]]))
case("zeros", lambda P: P.zeros([2, 3]))
case("ones", lambda P: P.ones((2, 3), dtype="int32"))
case("full", lambda P: P.full([2, 2], 7))
case("full-float", lambda P: P.full([2, 2], 0.5))
case("empty", lambda P: P.empty([2, 3]))
case("zeros_like", lambda P, x: P.zeros_like(x), X)
case("ones_like", lambda P, x: P.ones_like(x, dtype="int32"), X)
case("full_like", lambda P, x: P.full_like(x, 2.5), X)
case("empty_like", lambda P, x: P.empty_like(x), X)
case("arange", lambda P: P.arange(1, 10, 2))
case("arange-float", lambda P: P.arange(0.0, 1.0, 0.25))
case("linspace", lambda P: P.linspace(0.0, 1.0, 5))
case("eye", lambda P: P.eye(3, 4))
case("diag", lambda P, x: P.diag(x, offset=1), _f(3))
case("diag-padding", lambda P, x: P.diag(x, padding_value=2.0), _f(3))
case("diag-matrix", lambda P, x: P.diag(x), A4)
case("diagflat", lambda P, x: P.diagflat(x, offset=-1), _f(2, 2))
case("tril", lambda P, x: P.tril(x, 1), A4)
case("triu", lambda P, x: P.triu(x, -1), A4)
case("tril_indices", lambda P: P.tril_indices(4, 3, 0))
case("meshgrid", lambda P, x, y: P.meshgrid(x, y), _f(3), _f(2))
case("assign", lambda P, x: P.assign(x), X)
case("clone", lambda P, x: P.clone(x), X)
case("complex", lambda P, x, y: P.complex(x, y), X, Y)

# -- math: unary -----------------------------------------------------------------
for _name, _x in [
        ("exp", X), ("expm1", X), ("log", POS), ("log2", POS), ("log10", POS),
        ("log1p", POS), ("sqrt", POS), ("rsqrt", POS), ("square", X),
        ("reciprocal", POS), ("abs", X), ("sign", X), ("neg", X),
        ("floor", X * 3), ("ceil", X * 3), ("round", X * 3), ("trunc", X * 3),
        ("frac", X * 3), ("sin", X), ("cos", X), ("tan", UNIT), ("asin", UNIT),
        ("acos", UNIT), ("atan", X), ("sinh", X), ("cosh", X), ("tanh", X),
        ("asinh", X), ("acosh", POS + 1.0), ("atanh", UNIT), ("erf", X),
        ("erfinv", UNIT), ("sigmoid", X), ("digamma", POS), ("lgamma", POS),
        ("angle", X), ("conj", X), ("real", X), ("imag", X),
        ("isnan", X), ("isinf", X), ("isfinite", X)]:
    case(_name, lambda P, x, _n=_name: getattr(P, _n)(x), _x)
case("sign-int", lambda P, x: P.sign(x), _i(5, lo=-3, hi=3))
case("abs-int", lambda P, x: P.abs(x), _i(5, lo=-3, hi=3))

# -- math: binary ----------------------------------------------------------------
for _name, _x, _y in [
        ("floor_divide", I1, I2), ("mod", X * 3, POS), ("remainder", I1, I2),
        ("floor_mod", X * 3, POS), ("fmax", X, Y), ("fmin", X, Y),
        ("atan2", X, Y), ("logaddexp", X, Y), ("hypot", X, Y),
        ("inner", X, Y), ("outer", _f(3), _f(4)), ("kron", _f(2, 2), _f(2, 3)),
        ("gcd", I1, I2), ("lcm", I1, I2), ("heaviside", X, Y),
        ("nextafter", X, Y), ("copysign", X, Y)]:
    case(_name, lambda P, x, y, _n=_name: getattr(P, _n)(x, y), _x, _y)
case("add-scalar", lambda P, x: P.add(x, 2.0), X)
case("floor_divide-float", lambda P, x, y: P.floor_divide(x, y), X * 3, POS)
case("divide-int", lambda P, x, y: P.divide(x, y), I1, I2)
case("pow-scalar", lambda P, x: P.pow(x, 2.0), X)

# -- math: the rest --------------------------------------------------------------
case("scale", lambda P, x: P.scale(x, 2.0, 0.5), X)
case("scale-before", lambda P, x: P.scale(x, 2.0, 0.5,
                                          bias_after_scale=False), X)
case("multiplex", lambda P, a, b, i: P.multiplex([a, b], i), X, Y,
     np.array([[0], [1], [1]]))
case("lerp", lambda P, x, y: P.lerp(x, y, 0.3), X, Y)
case("lerp-tensor", lambda P, x, y, w: P.lerp(x, y, w), X, Y, POS)
case("stanh", lambda P, x: P.stanh(x), X)
case("rad2deg", lambda P, x: P.rad2deg(x), X)
case("deg2rad", lambda P, x: P.deg2rad(x), X * 90)
case("nan_to_num", lambda P, x: P.nan_to_num(x, nan=1.0, posinf=9.0),
     np.array([np.nan, np.inf, -np.inf, 1.0], "float32"))
case("sum-int", lambda P, x: P.sum(x, axis=0), I1)
case("sum-dtype", lambda P, x: P.sum(x, dtype="float32"), I1)
case("prod-all", lambda P, x: P.prod(x), POS)
case("nansum", lambda P, x: P.nansum(x, axis=1),
     np.array([[1.0, np.nan], [2.0, 3.0]], "float32"))
case("nanmean", lambda P, x: P.nanmean(x, axis=1),
     np.array([[1.0, np.nan], [2.0, 3.0]], "float32"))
case("max-all", lambda P, x: P.max(x), X)
case("amax", lambda P, x: P.amax(x, axis=[0, 1]), X3)
case("amin", lambda P, x: P.amin(x, axis=-1, keepdim=True), X3)
case("logsumexp-all", lambda P, x: P.logsumexp(x), X)
case("all", lambda P, x: P.all(x, axis=1), B1)
case("any", lambda P, x: P.any(x), B1)
case("count_nonzero", lambda P, x: P.count_nonzero(x, axis=1), I1 % 3)
case("cumsum-flat", lambda P, x: P.cumsum(x), X)
case("cumsum-int", lambda P, x: P.cumsum(x, axis=0), I1)
case("cumprod", lambda P, x: P.cumprod(x, dim=1), POS)
case("cummax", lambda P, x: P.cummax(x, axis=1), np.array(
    [[1, 3, 3, 2, 5], [4, 4, 1, 6, 6]], "float32"))
case("cummin", lambda P, x: P.cummin(x, axis=0), _i(5, 3).astype("float32"))
case("diff", lambda P, x: P.diff(x, axis=1), X)
case("trace", lambda P, x: P.trace(x, offset=1), A4)
case("addmm", lambda P, i, x, y: P.addmm(i, x, y, beta=0.5, alpha=2.0),
     _f(3, 5), _f(3, 4), _f(4, 5))
case("increment", lambda P, x: P.increment(x, 2.0), _f(1))
case("vander", lambda P, x: P.vander(x, 4), _f(3))
case("frexp", lambda P, x: P.frexp(x), X * 10)
case("ldexp", lambda P, x, y: P.ldexp(x, y), X, _i(3, 4, lo=-3, hi=3))
case("add_n", lambda P, x, y: P.add_n([x, y, x]), X, Y)
case("tensordot", lambda P, x, y: P.tensordot(x, y, axes=1), _f(3, 4),
     _f(4, 5))
case("tensordot-lists", lambda P, x, y: P.tensordot(x, y, axes=[[1], [0]]),
     _f(3, 4), _f(4, 5))
case("diagonal", lambda P, x: P.diagonal(x, 1, 1, 2), _f(2, 3, 4))
case("broadcast_shape", lambda P: P.broadcast_shape([3, 1], [1, 4]))
case("shard_index", lambda P, x: P.shard_index(x, 20, 2, 1), I1)

# -- logic -----------------------------------------------------------------------
for _name in ("equal", "not_equal", "greater_than", "greater_equal",
              "less_than", "less_equal"):
    case(_name, lambda P, x, y, _n=_name: getattr(P, _n)(x, y), I1 % 4,
         I2 % 4)
for _name in ("logical_and", "logical_or", "logical_xor"):
    case(_name, lambda P, x, y, _n=_name: getattr(P, _n)(x, y), B1, B2)
for _name in ("bitwise_and", "bitwise_or", "bitwise_xor"):
    case(_name, lambda P, x, y, _n=_name: getattr(P, _n)(x, y), I1, I2)
case("equal-scalar", lambda P, x: P.equal(x, 3), I1 % 4)
case("logical_not", lambda P, x: P.logical_not(x), B1)
case("bitwise_not", lambda P, x: P.bitwise_not(x), I1)
case("equal_all", lambda P, x, y: [P.equal_all(x, x), P.equal_all(x, y)],
     X, Y)
case("allclose", lambda P, x: P.allclose(x, x + 1e-7), X)
case("isclose", lambda P, x, y: P.isclose(x, y), X, np.where(B1, X, Y))
case("is_tensor", lambda P, x: [P.is_tensor(x), P.is_tensor(1.0)], X)
case("is_empty", lambda P, x, y: [P.is_empty(x), P.is_empty(y)], X,
     np.zeros((0, 3), "float32"))
case("where-nonzero", lambda P, c: P.where(c), B1)

# -- manipulation ----------------------------------------------------------------
case("reshape_", lambda P, x: P.reshape_(x, [4, 6]), X3)
case("flatten", lambda P, x: P.flatten(x, 1), X3)
case("squeeze-axis", lambda P, x: P.squeeze(x, axis=[0, 1]), _f(1, 3, 1))
case("unsqueeze-list", lambda P, x: P.unsqueeze(x, [0, -1]), X)
case("moveaxis", lambda P, x: P.moveaxis(x, 0, 2), X3)
case("swapaxes", lambda P, x: P.swapaxes(x, 0, 2), X3)
case("unstack", lambda P, x: P.unstack(x, axis=1), X)
case("chunk", lambda P, x: P.chunk(x, 2, axis=1), X)
case("expand", lambda P, x: P.expand(x, [2, 3, -1]), _f(3, 1))
case("expand_as", lambda P, x, y: P.expand_as(x, y), _f(1, 4), X)
case("broadcast_to", lambda P, x: P.broadcast_to(x, [3, 4]), _f(4))
case("broadcast_tensors", lambda P, x, y: P.broadcast_tensors([x, y]),
     _f(3, 1), _f(1, 4))
case("rot90", lambda P, x: P.rot90(x, 1, [0, 1]), X)
case("roll", lambda P, x: P.roll(x, 2, axis=1), X)
case("roll-flat", lambda P, x: P.roll(x, -3), X)
case("gather-axis", lambda P, x, i: P.gather(x, i, axis=1), X,
     np.array([3, 0]))
case("gather_nd", lambda P, x, i: P.gather_nd(x, i), X3,
     np.array([[0, 1], [1, 2]]))
case("take_along_axis", lambda P, x, i: P.take_along_axis(x, i, 1), X,
     _i(3, 2, hi=4))
case("put_along_axis", lambda P, x, i: P.put_along_axis(x, i, 9.0, 1), X,
     np.array([[0], [2], [3]]))
case("put_along_axis-add",
     lambda P, x, i, v: P.put_along_axis(x, i, v, 1, reduce="add"), X,
     np.array([[0], [2], [3]]), _f(3, 1))
case("put_along_axis-mul",
     lambda P, x, i, v: P.put_along_axis(x, i, v, 1, reduce="multiply"), X,
     np.array([[0], [2], [3]]), _f(3, 1))
case("scatter_nd_add", lambda P, x, i, u: P.scatter_nd_add(x, i, u), X,
     np.array([[0, 1], [2, 3], [0, 1]]), _f(3))
case("scatter_nd", lambda P, i, u: P.scatter_nd(i, u, [3, 4]),
     np.array([[0, 1], [2, 3]]), _f(2))
case("index_select", lambda P, x, i: P.index_select(x, i, axis=0), X,
     np.array([2, 0]))
case("index_sample", lambda P, x, i: P.index_sample(x, i), X,
     _i(3, 2, hi=4))
case("slice", lambda P, x: P.slice(x, [0, 1], [1, -3], [3, 100]), X)
case("strided_slice",
     lambda P, x: P.strided_slice(x, [1], [3], [0], [-2]), X)
case("strided_slice-forward",
     lambda P, x: P.strided_slice(x, [0, 1], [0, 1], [3, 4], [2, 2]), X)
case("unbind", lambda P, x: P.unbind(x, axis=0), X)
case("unique-all", lambda P, x: P.unique(x, return_index=True,
                                         return_inverse=True,
                                         return_counts=True),
     np.array([4, 1, 4, 2, 1, 7]))
case("unique-axis", lambda P, x: P.unique(x, axis=0),
     np.array([[1, 2], [0, 1], [1, 2]]))
case("unique_consecutive",
     lambda P, x: P.unique_consecutive(x, return_inverse=True,
                                       return_counts=True),
     np.array([1, 1, 2, 2, 2, 3, 1, 1]))
case("masked_select", lambda P, x, m: P.masked_select(x, m), X, B1)
case("masked_fill", lambda P, x, m: P.masked_fill(x, m, -1.0), X, B1)
case("pad", lambda P, x: P.pad(x, [1, 2, 0, 1]), _f(1, 2, 3, 4))
case("pad-reflect", lambda P, x: P.pad(x, [1, 1], mode="reflect"),
     _f(1, 2, 5))
case("crop", lambda P, x: P.crop(x, [2, 2], [1, 1]), X)
case("repeat_interleave", lambda P, x: P.repeat_interleave(x, 2, axis=0), X)
case("as_complex", lambda P, x: P.as_complex(x), _f(3, 2))
case("as_real", lambda P, x, y: P.as_real(P.complex(x, y)), X, Y)
case("reverse", lambda P, x: P.reverse(x, [1]), X)
case("squeeze_", lambda P, x: P.squeeze_(x, 0), _f(1, 3))
case("unsqueeze_", lambda P, x: P.unsqueeze_(x, 1), _f(2, 3))
case("scatter_", lambda P, x, i, u: P.scatter_(x, i, u), _f(5, 3),
     np.array([0, 4]), _f(2, 3))

# -- linalg ----------------------------------------------------------------------
case("dot", lambda P, x, y: P.dot(x, y), _f(4), _f(4))
case("mm", lambda P, x, y: P.mm(x, y), _f(3, 4), _f(4, 2))
case("mv", lambda P, x, v: P.mv(x, v), _f(3, 4), _f(4))
case("t", lambda P, x: P.t(x), X)
case("norm", lambda P, x: P.norm(x), X)
case("norm-axis", lambda P, x: P.norm(x, p=1, axis=1), X)
case("norm-inf", lambda P, x: P.norm(x, p=float("inf"), axis=[0, 1]), X)
case("dist", lambda P, x, y: P.dist(x, y, p=3), X, Y)
case("cross", lambda P, x, y: P.cross(x, y), _f(3, 2), _f(3, 2))
case("cholesky", lambda P, x: P.cholesky(x), SPD, tol=LOOSE)
case("inverse", lambda P, x: P.inverse(x), SPD, tol=LOOSE)
case("inv", lambda P, x: P.inv(x), SPD, tol=LOOSE)
case("pinv", lambda P, x: P.pinv(x), _f(4, 3), tol=LOOSE)
case("solve", lambda P, x, y: P.solve(x, y), SPD, _f(4, 2), tol=LOOSE)
case("triangular_solve",
     lambda P, x, y: P.triangular_solve(x, y, upper=True, transpose=True),
     np.triu(SPD), _f(4, 2), tol=LOOSE)
case("cholesky_solve", lambda P, y, c: P.cholesky_solve(y, c), _f(4, 2),
     np.linalg.cholesky(SPD).astype("float32"), tol=LOOSE)
case("lstsq", lambda P, x, y: P.lstsq(x, y), _f(5, 3), _f(5, 2),
     tol=LOOSE)
case("qr", lambda P, x: P.qr(x), _f(4, 3),
     post=lambda a, out: [out[0] @ out[1], np.abs(out[1])], tol=LOOSE)
case("svd", lambda P, x: P.svd(x), _f(4, 3),
     post=lambda a, out: [out[1], out[0] @ np.diag(out[1]) @ out[2]],
     tol=LOOSE)
case("eig", lambda P, x: P.eig(x), SPD,
     post=lambda a, out: [np.sort(out[0].real),
                          np.abs(a[0] @ out[1] - out[1] * out[0]).max()
                          < 1e-3], tol=LOOSE)
case("eigh", lambda P, x: P.eigh(x), SPD,
     post=lambda a, out: [out[0], out[1] @ np.diag(out[0]) @ out[1].T],
     tol=LOOSE)
case("eigvals", lambda P, x: P.eigvals(x), SPD,
     post=lambda a, out: np.sort(out.real), tol=LOOSE)
case("eigvalsh", lambda P, x: P.eigvalsh(x), SPD, tol=LOOSE)
case("matrix_power", lambda P, x: P.matrix_power(x, 3), A4, tol=LOOSE)
case("matrix_rank", lambda P, x: P.matrix_rank(x), _f(4, 2) @ _f(2, 4))
case("slogdet", lambda P, x: P.slogdet(x), SPD, tol=LOOSE)
case("det", lambda P, x: P.det(x), A4, tol=LOOSE)
case("multi_dot", lambda P, x, y, z: P.multi_dot([x, y, z]), _f(3, 4),
     _f(4, 5), _f(5, 2))
case("histogram", lambda P, x: P.histogram(x, bins=5, min=-2, max=2), X)
case("bincount", lambda P, x: P.bincount(x, minlength=12), I1.reshape(-1))
case("corrcoef", lambda P, x: P.corrcoef(x), X)
case("cov", lambda P, x: P.cov(x, rowvar=False), X)
case("lu", lambda P, x: P.lu(x), A4, tol=LOOSE)
case("lu_unpack", lambda P, x: P.lu_unpack(*P.lu(x)), A4,
     post=lambda a, out: [out[0] @ out[1] @ out[2]], tol=LOOSE)
case("householder_product",
     lambda P, x, t: P.householder_product(x, t), _f(4, 3), _f(3),
     tol=LOOSE)
case("cond", lambda P, x: P.cond(x), SPD, tol=LOOSE)

# -- search ----------------------------------------------------------------------
case("argmin", lambda P, x: P.argmin(x, axis=0, keepdim=True), X)
case("argmax-flat", lambda P, x: P.argmax(x), X)
case("argsort", lambda P, x: P.argsort(x, axis=1, descending=True),
     _i(3, 5, hi=3),
     oracle=lambda x: np.argsort(-x, axis=1, kind="stable").astype("int32"))
case("topk-smallest", lambda P, x: P.topk(x, 2, axis=0, largest=False), X)
case("nonzero-tuple", lambda P, x: P.nonzero(x, as_tuple=True), I1 % 2)
case("index_of_max", lambda P, x: P.index_of_max(x), X)
case("searchsorted", lambda P, s, v: P.searchsorted(s, v, right=True),
     np.array([1.0, 2.0, 2.0, 5.0], "float32"),
     np.array([2.0, 0.5, 6.0], "float32"))
case("masked_select-search", lambda P, x, m: P.masked_select(x, m), Y, B2)
case("kthvalue", lambda P, x: P.kthvalue(x, 2, axis=1), X,
     oracle=lambda x: [np.sort(x, axis=1)[:, 1], np.argsort(
         x, axis=1, kind="stable")[:, 1].astype("int32")])
case("mode", lambda P, x: P.mode(x, axis=1),
     np.array([[1, 2, 2, 3, 3], [4, 4, 1, 1, 0]], "float32"))
case("bucketize", lambda P, x, s: P.bucketize(x, s),
     np.array([2.0, 0.5, 6.0], "float32"),
     np.array([1.0, 2.0, 5.0], "float32"))

# -- stat ------------------------------------------------------------------------
case("var", lambda P, x: P.var(x, axis=1), X)
case("std", lambda P, x: P.std(x, unbiased=False), X)
case("median", lambda P, x: P.median(x, axis=1), X)
case("median-all", lambda P, x: P.median(x), X)
case("quantile", lambda P, x: P.quantile(x, 0.3, axis=0), X)
case("quantile-list", lambda P, x: P.quantile(x, [0.25, 0.75], axis=1), X)
case("numel", lambda P, x: P.numel(x), X3)


# -- random: shapes, dtypes and what the distributions guarantee -----------------
def _between(lo, hi):
    return lambda a, out: [list(out.shape), out.dtype.name,
                           bool(((out >= lo) & (out < hi)).all())]


def _finite(a, out):
    return [list(out.shape), out.dtype.name, bool(np.isfinite(out).all())]


case("rand", lambda P: P.rand([3, 4]), post=_between(0.0, 1.0))
case("randn", lambda P: P.randn([3, 4]), post=_finite)
case("standard_normal", lambda P: P.standard_normal([2, 5]), post=_finite)
case("normal", lambda P: P.normal(1.0, 2.0, [3, 3]), post=_finite)
case("uniform", lambda P: P.uniform([4, 4], min=-2.0, max=3.0),
     post=_between(-2.0, 3.0))
case("randint", lambda P: P.randint(2, 9, [3, 5]), post=_between(2, 9))
case("randint_like", lambda P, x: P.randint_like(x, 0, 4), I1,
     post=_between(0, 4))
case("randperm", lambda P: P.randperm(7),
     post=lambda a, out: [out.dtype.name, sorted(out.tolist())])
case("multinomial", lambda P, x: P.multinomial(x, 2), np.array(
    [[0.2, 0.3, 0.5], [0.6, 0.4, 0.0]], "float32"),
     post=lambda a, out: [list(out.shape), out.dtype.name,
                          bool((out[1] < 2).all()),
                          bool((out[:, 0] != out[:, 1]).all())])
case("bernoulli", lambda P, x: P.bernoulli(x), np.full((4, 4), 0.5, "f4"),
     post=lambda a, out: [list(out.shape),
                          bool(np.isin(out, [0.0, 1.0]).all())])
case("poisson", lambda P, x: P.poisson(x), np.full((3, 3), 4.0, "f4"),
     post=lambda a, out: [list(out.shape),
                          bool((out >= 0).all() and (out == np.round(out))
                               .all())])
case("exponential_", lambda P, x: P.exponential_(x, 2.0), _f(3, 3),
     post=lambda a, out: [list(out.shape), bool((out > 0).all())])


def test_case_ids_are_unique():
    ids = [c.id for c in CASES]
    assert len(ids) == len(set(ids)), sorted(i for i in ids
                                             if ids.count(i) > 1)
