"""paddle.jit.to_static (port of paddle_tpu/jit/to_static.py): a program
cache whose programs, on the card, are CUDA graphs of the whole call.

The reference runs one eager discovery pass per input signature, then
compiles the function into one XLA program and runs that on every later
call. Here a program is a ``torch.cuda.CUDAGraph``:

- Key: ``_sig_of(args)``, ``_sig_of(kwargs)``, grad mode and the
  degenerate-weight guard's generation (ops/_param_guard.py); a tensor's
  signature is its shape, dtype, device and whether it requires grad.
- Discovery: the first ``_discovery_passes()`` calls of a key (1, or 2
  under PADDLE_TPU_TWO_PASS_DISCOVERY=1) run the Python body eagerly, on
  the side stream the capture uses. They create what a step creates once
  (optimizer accumulators and masters, the guard's verdicts, the kernel
  libraries, cuBLAS's handles) and note the explicit random generators
  the step draws from (core/random.py) and, on the card, where its
  recomputed regions draw (``RerunPlan``).
- Build: on CUDA inputs the next call copies its tensor arguments into
  static buffers and captures the body as a graph, in one memory pool
  shared by the function's programs and with those generators (and the
  recomputed regions' planned states, synced before every replay)
  registered, then replays it once, so that N calls make N updates as
  eagerly. The capture is ``thread_local``: another thread (the fit
  loop's input prefetcher) may pin, allocate and copy meanwhile. Every
  later call copies its arguments into the static buffers
  and replays. A capture that fails (a host sync, a copy from the host, a
  draw from a CPU generator) raises, naming the function: nothing falls
  back to eager.
- Outer gradients, as in the reference: discovery counts the
  leaf-accumulating backward passes the body runs (``Tensor.backward``,
  ``torch.autograd.backward``; ``torch.autograd.grad`` is part of a
  forward and is not counted).

  * A body that runs its own backward (a train step): called with grad
    enabled, its floating outputs get a grad node whose backward raises
    the reference's error, on the host and on the card alike.
  * A body that runs none, called with grad enabled: discovery walks the
    outputs' ``grad_fn`` graph to the ``AccumulateGrad`` nodes it reaches
    (the closed-over parameters; the tensor arguments are inputs of their
    own). On the card the build then captures the forward and, with
    ``torch.autograd.grad`` over the differentiable outputs, the backward
    as a second graph in the same pool, behind one autograd Function (as
    ``torch.cuda.make_graphed_callables`` does): a replay returns outputs
    whose backward replays the second graph and adds into ``.grad`` as
    eager autograd does. Both graphs share the function's buffers, so a
    backward runs once, for the function's most recent call; any later
    call of the function in between makes it raise.
- Outputs: copies of the graph's output tensors, which the next replay
  overwrites (``run_steps`` returns them stacked, with no autograd
  history).
- CPU inputs (the host tests): keys, stages and counters are the same,
  and a built program runs the Python body; there are no CPU graphs.

A program holds the addresses of what its body touched: parameters,
optimizer state, the lr tensor, a GradScaler's state. Updating those in
place (optimizer steps, ``set_state_dict``, ``set_lr``, a scheduler,
``load_numpy_state_dict``) is seen by the next replay; replacing them
(``Module.to``, a new optimizer) needs a new function.
``FLAGS_compiled_step=0`` or ``enable_to_static(False)`` runs every call
eagerly, the debug and parity oracle.
"""
from __future__ import annotations

import contextlib
import functools
import os
import threading

import torch
from torch.autograd.function import once_differentiable

from ..core.random import (RerunPlan, collect_generators, play_reruns,
                           record_reruns)
from ..framework.flags import get_flag
from ..ops import _param_guard

__all__ = ["to_static", "StaticFunction", "InputSpec", "enable_to_static",
           "in_static_step"]

# how deep the calling thread is inside to_static programs' steps
_depth = threading.local()


def in_static_step():
    """Whether the calling thread runs inside a to_static step (its
    discovery pass, its capture or, on the host, its built program)."""
    return getattr(_depth, "n", 0) > 0


@contextlib.contextmanager
def _static_step():
    _depth.n = getattr(_depth, "n", 0) + 1
    try:
        yield
    finally:
        _depth.n -= 1


class InputSpec:
    """paddle.static.InputSpec: the shape and dtype of an input."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.name = name


def _sig_of(value):
    if isinstance(value, torch.Tensor):
        return ("T", tuple(value.shape), str(value.dtype), str(value.device),
                value.requires_grad)
    if isinstance(value, (list, tuple)):
        return (type(value).__name__, tuple(_sig_of(v) for v in value))
    if isinstance(value, dict):
        return ("dict", tuple(sorted((k, _sig_of(v))
                                     for k, v in value.items())))
    return ("py", value if isinstance(value, (int, float, str, bool,
                                              type(None)))
            else str(type(value)))


def _sig_of_step(value):
    """The signature of one step of a ``run_steps`` argument: a tensor's
    drops the leading steps axis."""
    if isinstance(value, torch.Tensor):
        return ("T", tuple(value.shape[1:]), str(value.dtype),
                str(value.device), value.requires_grad)
    if isinstance(value, (list, tuple)):
        return (type(value).__name__, tuple(_sig_of_step(v) for v in value))
    if isinstance(value, dict):
        return ("dict", tuple(sorted((k, _sig_of_step(v))
                                     for k, v in value.items())))
    return _sig_of(value)


def _flatten_tensors(obj, out):
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _flatten_tensors(v, out)
    elif isinstance(obj, dict):
        for k in sorted(obj):
            _flatten_tensors(obj[k], out)
    return out


def _replace_tensors(obj, leaves):
    """``obj`` with its tensors, in ``_flatten_tensors`` order, replaced by
    the next items of the iterator ``leaves``."""
    if isinstance(obj, torch.Tensor):
        return next(leaves)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_replace_tensors(v, leaves) for v in obj)
    if isinstance(obj, dict):
        new = {k: _replace_tensors(obj[k], leaves) for k in sorted(obj)}
        return {k: new[k] for k in obj}
    return obj


def _discovery_passes():
    """1 (default), or 2 under PADDLE_TPU_TWO_PASS_DISCOVERY=1."""
    return 2 if os.environ.get("PADDLE_TPU_TWO_PASS_DISCOVERY") == "1" else 1


def _cuda_device(leaves):
    return next((t.device for t in leaves if t.is_cuda), None)


# leaf-accumulating backward passes run while a discovery pass counts them
_backward_runs = [0]


@contextlib.contextmanager
def _counting_backwards():
    """Count into ``_backward_runs`` the ``torch.autograd.backward`` calls
    (``Tensor.backward`` makes one) that the block makes: the reference's
    ``backward_run_counter``. Nested blocks share the outer count."""
    real = torch.autograd.backward
    if getattr(real, "_counts_backwards", False):
        yield
        return

    @functools.wraps(real)
    def counted(*args, **kwargs):
        _backward_runs[0] += 1
        return real(*args, **kwargs)
    counted._counts_backwards = True
    torch.autograd.backward = counted
    try:
        yield
    finally:
        torch.autograd.backward = real


def _reached_leaves(outs, arg_tensors):
    """The leaves requiring grad that the outputs' ``grad_fn`` graph
    reaches (its ``AccumulateGrad`` nodes), in the order of a depth-first
    walk, leaving out the tensor arguments and whatever lies behind a
    non-leaf argument: those are inputs of the call."""
    taken = {id(t) for t in arg_tensors}
    behind_args = [t.grad_fn for t in arg_tensors if t.grad_fn is not None]
    seen, leaves = set(behind_args), []
    todo = [t.grad_fn for t in outs if t.grad_fn is not None]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        var = getattr(node, "variable", None)
        if var is not None:
            if id(var) not in taken:
                taken.add(id(var))
                leaves.append(var)
            continue
        todo.extend(n for n, _ in node.next_functions)
    return leaves


_OUTER_GRAD_ERROR = (
    "cannot differentiate through the output of a to_static function that "
    "runs its own backward(): outer gradient flow is disabled for compiled "
    "train-step programs. Split the function so the internally-optimized "
    "part and the externally-differentiated part are separate to_static "
    "functions.")


class _OuterGradRefused(torch.autograd.Function):
    """The grad node of a self-backward program's outputs: its backward
    raises the reference's error."""

    @staticmethod
    def forward(ctx, token, *outs):
        return tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(_OUTER_GRAD_ERROR)


def _refuse_outer_grad(out):
    """``out`` with each floating tensor behind an ``_OuterGradRefused``
    node."""
    flat = _flatten_tensors(out, [])
    floating = [t for t in flat if t.is_floating_point()]
    if not floating:
        return out
    token = torch.empty(0, requires_grad=True)
    refused = iter(_OuterGradRefused.apply(token, *floating))
    return _replace_tensors(out, iter([next(refused) if t.is_floating_point()
                                       else t for t in flat]))


class _GraphedCall(torch.autograd.Function):
    """A replayed forward graph on the tape: the inputs are the call's
    differentiable tensor arguments and the program's leaves, the outputs
    copies of the graph's outputs; the backward copies the incoming grads
    into the backward graph's static buffers and replays it."""

    @staticmethod
    def forward(ctx, fn, prog, *inputs):
        ctx.fn, ctx.prog, ctx.replay = fn, prog, fn._replays
        outs = [t.clone() for t in _flatten_tensors(prog.static_out, [])]
        ctx.mark_non_differentiable(*[o for o, d in zip(outs, prog.diff_out)
                                      if not d])
        return tuple(outs)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        fn, prog = ctx.fn, ctx.prog
        if ctx.replay != fn._replays:
            raise RuntimeError(
                f"to_static: the captured backward of {fn._name()} runs "
                f"once, for the function's most recent call: its graphs "
                f"share their buffers, and the function ran again (or this "
                f"backward already ran) since this call")
        fn._replays += 1
        diff = [g for g, d in zip(grads, prog.diff_out) if d]
        for dst, g in zip(prog.grad_out, diff):
            if g is None:
                dst.zero_()
            else:
                dst.copy_(g)
        prog.bwd_graph.replay()
        wanted = ctx.needs_input_grad[2:]
        return (None, None, *[g.clone() if g is not None and w else None
                              for g, w in zip(prog.grad_in, wanted)])


class _Program:
    __slots__ = ("stage", "built", "hits", "generators", "reruns",
                 "internal_backward", "leaves", "graph", "static_in",
                 "static_out", "diff_out", "bwd_graph", "grad_out", "grad_in")

    def __init__(self):
        self.stage = 0          # discovery passes run
        self.built = False      # captured (CUDA) or past discovery (CPU)
        self.hits = 0           # calls that found the program built
        self.generators = set()
        self.reruns = None      # the recomputed regions' RerunPlan (card)
        self.internal_backward = False  # the body runs its own backward
        self.leaves = []        # the leaves requiring grad it reaches
        self.graph = None
        self.static_in = None   # the static copies of the tensor arguments
        self.static_out = None  # the graph's outputs
        self.diff_out = None    # which outputs are differentiable
        self.bwd_graph = None   # the captured backward (outer grad flow)
        self.grad_out = None    # its static incoming grads
        self.grad_in = None     # its grads of the differentiable inputs


class StaticFunction:
    """A function decorated by ``to_static``: a cache of programs, one per
    input signature (module docstring)."""

    # the global switch (the reference's ProgramTranslator.enable)
    _default_enabled = True

    def __init__(self, fn, input_spec=None, build_strategy=None):
        functools.update_wrapper(self, fn)
        self._fn = fn
        self._input_spec = input_spec
        self._programs = {}
        self._enabled = True
        self._pool = None     # the graph memory pool of all programs
        self._stream = None   # the side stream of discovery and capture
        self._replays = 0     # graph replays, which overwrite the buffers

    def __get__(self, instance, owner):
        if instance is None:
            return self
        # one bound function, with its own programs, per instance: programs
        # hold the instance's parameters
        cache_name = f"__static_fn_{id(self)}"
        bound = instance.__dict__.get(cache_name)
        if bound is None:
            bound = StaticFunction(self._fn.__get__(instance, owner),
                                   self._input_spec)
            bound._enabled = self._enabled
            instance.__dict__[cache_name] = bound
        return bound

    @property
    def programs(self):
        return self._programs

    def _name(self):
        return getattr(self._fn, "__qualname__", repr(self._fn))

    def _active(self):
        return (self._enabled and StaticFunction._default_enabled
                and bool(get_flag("FLAGS_compiled_step", True)))

    def _key(self, args_sig, kwargs_sig):
        return (args_sig, kwargs_sig, torch.is_grad_enabled(),
                _param_guard.generation())

    def __call__(self, *args, **kwargs):
        if not self._active():
            return self._fn(*args, **kwargs)
        return self._call(self._key(_sig_of(args), _sig_of(kwargs)), args,
                          kwargs)

    def _call(self, key, args, kwargs):
        """One call under ``key``. Outputs of a graph are copies of its
        static buffers (the next replay overwrites those), on the tape of
        the captured backward where the program has one."""
        out, prog, static = self._step(key, args, kwargs)
        if static:
            if prog.bwd_graph is not None:
                leaves = _flatten_tensors((args, kwargs), [])
                inputs = [t for t, s in zip(leaves, prog.static_in)
                          if s.requires_grad] + prog.leaves
                copies = iter(_GraphedCall.apply(self, prog, *inputs))
            else:
                copies = iter([t.clone()
                               for t in _flatten_tensors(out, [])])
            out = _replace_tensors(out, copies)
        if prog.internal_backward and torch.is_grad_enabled():
            out = _refuse_outer_grad(out)
        return out

    def _step(self, key, args, kwargs):
        """One call of the program under ``key``: a discovery pass, a build
        and replay, or a replay. Returns (outputs, the program, whether the
        outputs are the graph's static buffers)."""
        with _static_step():
            return self._step_in(key, args, kwargs)

    def _step_in(self, key, args, kwargs):
        prog = self._programs.get(key)
        if prog is None or prog.stage < _discovery_passes():
            return (*self._discover(key, prog, args, kwargs), False)
        leaves = _flatten_tensors((args, kwargs), [])
        if prog.built:
            prog.hits += 1
        else:
            self._build(prog, args, kwargs, leaves)
        if prog.graph is None:
            return self._fn(*args, **kwargs), prog, False
        with torch.no_grad():
            for dst, src in zip(prog.static_in, leaves):
                dst.copy_(src)
        if prog.reruns is not None:
            prog.reruns.sync()
        prog.graph.replay()
        self._replays += 1
        return prog.static_out, prog, True

    def _side_stream(self, device):
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return self._stream

    def _discover(self, key, prog, args, kwargs):
        prog = prog or _Program()
        arg_tensors = _flatten_tensors((args, kwargs), [])
        device = _cuda_device(arg_tensors)
        runs = _backward_runs[0]
        with collect_generators(prog.generators), _counting_backwards():
            if device is None:
                out = self._fn(*args, **kwargs)
            else:
                prog.reruns = RerunPlan(device)
                side = self._side_stream(device)
                current = torch.cuda.current_stream(device)
                side.wait_stream(current)
                with torch.cuda.stream(side), record_reruns(prog.reruns):
                    out = self._fn(*args, **kwargs)
                current.wait_stream(side)
                for t in _flatten_tensors(out, []):
                    if t.is_cuda:
                        t.record_stream(current)
        prog.internal_backward = _backward_runs[0] > runs
        prog.leaves = []
        if torch.is_grad_enabled() and not prog.internal_backward:
            prog.leaves = _reached_leaves(_flatten_tensors(out, []),
                                          arg_tensors)
        prog.stage += 1
        self._cache_program(key, prog)
        return out, prog

    def _build(self, prog, args, kwargs, leaves):
        device = _cuda_device(leaves)
        if device is None:
            prog.built = True
            return
        name = self._name()
        graph = torch.cuda.CUDAGraph()
        for gen in prog.generators:
            if gen.device.type != "cuda" or \
                    gen is torch.cuda.default_generators[gen.device.index or 0]:
                continue
            if not hasattr(graph, "register_generator_state"):
                raise RuntimeError(
                    f"to_static: {name} draws from an explicit CUDA "
                    f"generator, which this torch cannot register with a "
                    f"CUDA graph; use the default generator")
            graph.register_generator_state(gen)
        prog.reruns.register(graph)
        # outer grad flow: a body that runs no backward of its own, called
        # with grad enabled, whose outputs depend on something that
        # requires grad, gets its backward captured too
        outer = torch.is_grad_enabled() and not prog.internal_backward
        static_in = [t.detach().clone().requires_grad_(outer
                                                       and t.requires_grad)
                     for t in leaves]
        diff_in = [t for t in static_in if t.requires_grad] + prog.leaves
        s_args, s_kwargs = _replace_tensors((args, kwargs), iter(static_in))
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        side = self._side_stream(device)
        bwd_graph = grad_out = grad_in = None
        try:
            with torch.cuda.device(device), play_reruns(prog.reruns), \
                    torch.cuda.graph(graph, pool=self._pool, stream=side,
                                     capture_error_mode="thread_local"):
                out = self._fn(*s_args, **s_kwargs)
            outs = _flatten_tensors(out, [])
            diff_out = [t.requires_grad for t in outs]
            if outer and diff_in and any(diff_out):
                grad_out = [torch.empty_like(t)
                            for t, d in zip(outs, diff_out) if d]
                bwd_graph = torch.cuda.CUDAGraph()
                prog.reruns.register(bwd_graph)
                with torch.cuda.device(device), torch.cuda.graph(
                        bwd_graph, pool=self._pool, stream=side,
                        capture_error_mode="thread_local"):
                    grad_in = torch.autograd.grad(
                        [t for t, d in zip(outs, diff_out) if d], diff_in,
                        grad_out, allow_unused=True)
        except Exception as err:
            raise RuntimeError(
                f"to_static: capturing {name} as a CUDA graph failed: a "
                f"captured step may not sync with the host, copy from the "
                f"host or draw from a CPU generator ({type(err).__name__}: "
                f"{err})") from err
        # a failed capture leaves the program unbuilt: the next call
        # captures again (and raises again), it never runs eagerly
        prog.built = True
        prog.graph = graph
        prog.static_in = static_in
        prog.static_out = _replace_tensors(out, iter([
            t.detach() for t in outs]))
        prog.diff_out = diff_out
        prog.bwd_graph, prog.grad_out, prog.grad_in = (bwd_graph, grad_out,
                                                       grad_in)

    def _cache_program(self, key, prog):
        """Insert under the FLAGS_max_cached_programs bound, evicting the
        oldest program (its signature builds anew on its next call)."""
        self._programs[key] = prog
        cap = int(get_flag("FLAGS_max_cached_programs", 64) or 0)
        if cap > 0:
            while len(self._programs) > cap:
                oldest = next(iter(self._programs))
                if oldest == key:
                    break
                del self._programs[oldest]

    def run_steps(self, *args, **kwargs):
        """K steps: every tensor argument carries a leading axis of the same
        length K, and step i gets slice i (Python values stay fixed). The
        steps go through the same programs as single calls, so once built
        each is one replay with its slice copied into the static buffers.
        Returns the outputs stacked on a leading K axis (no autograd
        history)."""
        leaves = _flatten_tensors((args, kwargs), [])
        if not leaves:
            raise ValueError("run_steps needs at least one tensor argument "
                             "with a leading steps axis")
        ks = {t.shape[0] if t.dim() else None for t in leaves}
        if len(ks) != 1 or None in ks:
            raise ValueError(
                f"run_steps: all tensor args must share the same leading "
                f"steps-axis length; got lengths {sorted(map(str, ks))}")
        k = ks.pop()
        if k == 0:
            raise ValueError("run_steps: leading steps axis is empty (K=0)")
        active = self._active()
        key = self._key(_sig_of_step(args), _sig_of_step(kwargs))
        tree, stacked = None, None
        for i in range(k):
            a_i, kw_i = _replace_tensors((args, kwargs),
                                         iter([t[i] for t in leaves]))
            if active:
                out = self._step(key, a_i, kw_i)[0]
            else:
                out = self._fn(*a_i, **kw_i)
            outs = _flatten_tensors(out, [])
            if stacked is None:
                tree = out
                stacked = [torch.empty((k, *t.shape), dtype=t.dtype,
                                       device=t.device) for t in outs]
            for dst, src in zip(stacked, outs):
                dst[i].copy_(src.detach())
        return _replace_tensors(tree, iter(stacked))


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, **kwargs):
    """Decorate a function (or a Layer, whose forward is wrapped); usable
    bare (``@to_static``) or with arguments (``@to_static(input_spec=...)``).
    """

    def decorate(fn):
        if isinstance(fn, torch.nn.Module):
            fn.forward = StaticFunction(type(fn).forward.__get__(fn),
                                        input_spec)
            return fn
        return StaticFunction(fn, input_spec, build_strategy)

    if function is not None:
        return decorate(function)
    return decorate


def enable_to_static(enable=True):
    """paddle.jit.enable_to_static: False runs every to_static function
    eagerly."""
    StaticFunction._default_enabled = bool(enable)
