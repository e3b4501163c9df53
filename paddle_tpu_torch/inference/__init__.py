"""paddle.inference: Config, Predictor and its tensor handles (port of
paddle_tpu/inference/__init__.py).

Reference: paddle/fluid/inference (`AnalysisPredictor`, analysis_config.cc,
``ZeroCopyRun``). The reference's predictor keeps one ``jax.jit`` of the
model per input signature; here, on the card, a program is one CUDA graph
per signature (``jit/inference_graph.py``), captured under
``torch.inference_mode`` with static input buffers:

- Device: ``Config`` defaults to the card (``enable_use_gpu``'s device id,
  cuda:0); ``disable_gpu()`` asks for the host, where the plain forward
  runs (there are no CPU graphs). A predictor that did not ask for the
  host raises where no card is visible. The predictor moves
  ``set_layer``'s layer to that device and calls ``eval()``.
- Precision: under ``enable_low_precision(DataType.BFLOAT16)`` the float
  parameters and buffers are cast once, when a signature's entry is built,
  and float inputs on every call; integer inputs (token ids) stay as they
  are. Outputs come back as numpy arrays; numpy has no bfloat16, so a
  bfloat16 output is returned widened to float32 (exact), where the
  reference returns an ml_dtypes array.
- The cache: ``_jit_cache`` is keyed by the caller's signature, the
  ``((shape, dtype), ...)`` of the arrays as given, before any cast: the
  keys ``serving.BucketedExecutor`` builds, so its LRU eviction drops the
  entry and with it the graph and its memory pool. (The reference keys
  after its bf16 cast, so for float inputs under bf16 that eviction never
  matches: ROADMAP C-ref-5, not mirrored.) ``clone()`` and
  ``PredictorPool`` share the cache: replicas replay the same graphs, one
  at a time under each graph's lock.

Model sources: ``set_layer(layer)`` and ``set_jit_model(prefix,
factory)`` (a ``jit.save`` artifact bound to a layer the factory builds).
Serialized programs — ``set_exported_model``, ``save_predictor_model``,
``convert_to_mixed_precision``, the reference's StableHLO artifacts —
raise ``NotImplementedError``: they come with ``torch.export`` (ROADMAP
A12).
"""
from __future__ import annotations

import json
import os
import re
import threading
import warnings

import numpy as np
import torch

from ..core.device import CUDAPlace, resolve_device
from ..framework.errors import InvalidArgumentError, OutOfRangeError
from ..framework.io_utils import tensor_from_numpy

__all__ = [
    "Config", "Predictor", "Tensor", "create_predictor", "PredictorPool",
    "save_predictor_model", "get_version", "PlaceType", "DataType",
    "convert_to_mixed_precision",
    "PrecisionType", "get_trt_compile_version", "get_trt_runtime_version",
    "get_num_bytes_of_data_type",
]

_SERIALIZED = ("serialized inference programs (the reference's StableHLO "
               "export) are not ported yet; they come with torch.export "
               "(ROADMAP A12)")


def get_version():
    return "paddle_tpu_torch-inference-1.0"


class PlaceType:
    """analysis_config place enum parity (kCPU/kGPU → host/card)."""
    CPU = 0
    GPU = 1
    TPU = 1          # the reference's accelerator alias
    UNK = -1


class DataType:
    FLOAT32 = 0
    INT64 = 1
    INT32 = 2
    UINT8 = 3
    INT8 = 4
    FLOAT16 = 5
    BFLOAT16 = 6


_NP_OF = {
    DataType.FLOAT32: "float32", DataType.INT64: "int64",
    DataType.INT32: "int32", DataType.UINT8: "uint8", DataType.INT8: "int8",
    DataType.FLOAT16: "float16", DataType.BFLOAT16: "bfloat16",
}


class Config:
    """analysis_config.cc parity at the API level. Switches of subsystems
    the port does not have (TensorRT, MKLDNN) are accepted and warn."""

    def __init__(self, prog_file=None, params_file=None):
        self.prog_file = prog_file
        self.params_file = params_file
        self._use_device = PlaceType.GPU
        self._device_id = 0
        self._ir_optim = True
        self._memory_optim = True
        self._precision = DataType.FLOAT32
        self._threads = 1
        self._exported = None     # path of a serialized program
        self._jit_prefix = None   # path of a paddle.jit.save artifact
        self._layer = None        # directly-supplied python Layer
        self._input_spec = None

    # -- device ---------------------------------------------------------------
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._use_device = PlaceType.GPU
        self._device_id = device_id

    enable_use_tpu = enable_use_gpu

    def disable_gpu(self):
        self._use_device = PlaceType.CPU

    def use_gpu(self):
        return self._use_device == PlaceType.GPU

    def gpu_device_id(self):
        return self._device_id

    def _torch_device(self):
        """The torch.device predictors of this config run on; the card
        raises where none is visible."""
        if self._use_device == PlaceType.CPU:
            return torch.device("cpu")
        return resolve_device(CUDAPlace(self._device_id))

    # -- graph optimization ----------------------------------------------------
    def switch_ir_optim(self, x=True):
        self._ir_optim = bool(x)

    def ir_optim(self):
        return self._ir_optim

    def enable_memory_optim(self, x=True):
        self._memory_optim = bool(x)

    def enable_mkldnn(self):
        warnings.warn("enable_mkldnn is a no-op: the host path runs "
                      "PyTorch's CPU kernels", stacklevel=2)

    def enable_tensorrt_engine(self, workspace_size=1 << 30, max_batch_size=1,
                               min_subgraph_size=3, precision_mode=None,
                               use_static=False, use_calib_mode=False):
        # no TensorRT subgraphs: the whole call is one CUDA graph. The
        # precision is accepted in either enum spelling (DataType / the
        # analysis_config PrecisionType the real API uses)
        low = (DataType.FLOAT16, DataType.BFLOAT16,
               PrecisionType.Half, PrecisionType.Bfloat16)
        if precision_mode in low:
            self._precision = DataType.BFLOAT16
            warnings.warn(
                "enable_tensorrt_engine: no TensorRT subgraphs (the whole "
                "call is one CUDA graph) — only the precision request is "
                "honored (running bf16)", stacklevel=2)
        else:
            warnings.warn(
                "enable_tensorrt_engine is a no-op: the whole call is one "
                "CUDA graph", stacklevel=2)

    def set_cpu_math_library_num_threads(self, n):
        self._threads = int(n)

    def enable_low_precision(self, dtype=DataType.BFLOAT16):
        """Run the whole computation in bf16 (the tensor cores' type)."""
        self._precision = dtype

    # -- model sources ---------------------------------------------------------
    def set_model(self, prog_file, params_file=None):
        self.prog_file = prog_file
        self.params_file = params_file

    def set_exported_model(self, path):
        self._exported = path

    def set_jit_model(self, prefix, layer_factory=None):
        self._jit_prefix = prefix
        self._layer = layer_factory

    def set_layer(self, layer, input_spec=None):
        self._layer = layer
        self._input_spec = input_spec

    def summary(self):
        return json.dumps({
            "place": "gpu" if self._use_device else "cpu",
            "ir_optim": self._ir_optim,
            "memory_optim": self._memory_optim,
            "precision": self._precision,
            "model": self._exported or self._jit_prefix or self.prog_file,
        }, indent=2)


class Tensor:
    """Zero-copy input/output handle (ZeroCopyTensor parity). Input handles
    stage a host array; output handles read the last run's outputs."""

    def __init__(self, name, predictor, is_input):
        self.name = name
        self._p = predictor
        self._is_input = is_input
        self._host = None

    # -- input side ------------------------------------------------------------
    def reshape(self, shape):
        if self._host is None:
            # pre-staging allocation (ZeroCopyTensor::Reshape before copy)
            self._host = np.zeros(shape, "float32")
            return
        if self._host.size != int(np.prod(shape)):
            # silently replacing staged data with zeros here served garbage;
            # a size-changing reshape must be an explicit re-stage
            raise InvalidArgumentError(
                f"Tensor '{self.name}': reshape to {list(shape)} "
                f"({int(np.prod(shape))} elements) does not match the "
                f"staged data's {self._host.size} elements; call "
                "copy_from_cpu with the new array instead")
        self._host = self._host.reshape(shape)

    def copy_from_cpu(self, arr):
        if not self._is_input:
            raise RuntimeError("copy_from_cpu on an output handle")
        self._host = np.ascontiguousarray(arr)

    def share_external_data(self, arr):
        self.copy_from_cpu(np.asarray(arr))

    # -- output side -----------------------------------------------------------
    def copy_to_cpu(self):
        if self._is_input:
            return np.asarray(self._host)
        return np.asarray(self._p._outputs[self.name])

    def to_numpy(self):
        return self.copy_to_cpu()

    def shape(self):
        v = self._host if self._is_input else self._p._outputs.get(self.name)
        return list(np.asarray(v).shape) if v is not None else []

    def type(self):
        v = self._host if self._is_input else self._p._outputs.get(self.name)
        if v is None:
            return DataType.FLOAT32
        rev = {v2: k for k, v2 in _NP_OF.items()}
        return rev.get(str(np.asarray(v).dtype), DataType.FLOAT32)


def _signature(arrays):
    """The caller's ((shape, dtype), ...), BucketedExecutor's key."""
    return tuple((tuple(np.asarray(a).shape), str(np.asarray(a).dtype))
                 for a in arrays)


def _to_numpy(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class _LayerProgram:
    """One cache entry: the layer's forward at one input signature. Under
    bf16 it holds the parameters and buffers cast once; on the card it
    holds the captured graph."""

    def __init__(self, layer, arrays, bf16, device):
        self._layer = layer
        self._bf16 = bf16
        self._device = device
        self._state = None
        if bf16:
            self._state = {k: v.to(torch.bfloat16) if v.is_floating_point()
                           else v for k, v in layer.state_dict().items()}
        self.graph = None
        if device.type == "cuda":
            from ..jit.inference_graph import InferenceGraph
            self.graph = InferenceGraph(
                self._forward, self._inputs(arrays),
                name=f"Predictor[{type(layer).__name__}]")

    def _forward(self, *xs):
        if self._state is None:
            out = self._layer(*xs)
        else:
            out = torch.func.functional_call(self._layer, self._state, xs)
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)

    def _inputs(self, arrays):
        xs = [tensor_from_numpy(a) for a in arrays]
        if self._bf16:
            xs = [x.to(torch.bfloat16) if x.is_floating_point() else x
                  for x in xs]
        return [x.to(self._device) for x in xs]

    def run(self, arrays):
        if self.graph is not None:
            # the copy into the static buffers casts float inputs to bf16
            outs = self.graph.run([tensor_from_numpy(a) for a in arrays])
        else:
            with torch.inference_mode():
                outs = self._forward(*self._inputs(arrays))
        return [_to_numpy(o) for o in outs]


class Predictor:
    """AnalysisPredictor parity over a cache of programs, one per input
    signature (module docstring). Model sources: an in-memory Layer
    (``set_layer``), or a ``paddle.jit.save`` artifact bound to a layer
    its factory builds (``set_jit_model(prefix, factory)``)."""

    def __init__(self, config: Config):
        self._cfg = config
        self.device = config._torch_device()
        self._compiled = None       # callable: (list[np]) -> list[np]
        self._input_names = []
        self._output_names = []
        self._inputs = {}
        self._outputs = {}
        self._run_count = 0
        self._load()

    # -- loading ---------------------------------------------------------------
    def _load(self):
        cfg = self._cfg
        if cfg._exported:
            raise NotImplementedError(f"set_exported_model: {_SERIALIZED}")
        if cfg._layer is not None and cfg._jit_prefix:
            from ..jit.save_load import load as jit_load
            tl = jit_load(cfg._jit_prefix)
            layer = (cfg._layer if isinstance(cfg._layer, torch.nn.Module)
                     else cfg._layer())
            tl.bind(layer)
            self._init_from_layer(layer)
        elif cfg._layer is not None:
            self._init_from_layer(cfg._layer)
        elif cfg._jit_prefix:
            raise ValueError(
                "set_jit_model(prefix) needs a layer factory: the jit.save "
                "artifact stores weights + metadata, not code — pass "
                "set_jit_model(prefix, LayerClass) so the predictor can "
                "re-instantiate the model")
        elif cfg.prog_file and os.path.exists(
                str(cfg.prog_file) + ".stablehlo"):
            raise NotImplementedError(f"{cfg.prog_file}: {_SERIALIZED}")
        elif cfg.prog_file:
            raise ValueError(
                "inference.Config points at a ProgramDesc artifact without a "
                "layer; use set_jit_model(prefix, factory) or set_layer")
        else:
            raise ValueError("inference.Config has no model source")

    def _init_from_layer(self, layer):
        layer.to(self.device)
        layer.eval()
        spec = self._cfg._input_spec
        if spec:
            self._input_names = [
                getattr(s, "name", None) or f"x{i}"
                for i, s in enumerate(spec)]
        self._layer_obj = layer
        self._jit_cache = {}
        # shared with clones, like the cache: one capture per signature
        self._cache_lock = threading.Lock()
        bf16 = self._cfg._precision == DataType.BFLOAT16

        def run_fn(host_arrays):
            sig = _signature(host_arrays)
            prog = self._jit_cache.get(sig)
            if prog is None:
                with self._cache_lock:
                    prog = self._jit_cache.get(sig)
                    if prog is None:
                        prog = _LayerProgram(layer, host_arrays, bf16,
                                             self.device)
                        self._jit_cache[sig] = prog
            return prog.run(host_arrays)
        self._compiled = run_fn

    # -- io handles ------------------------------------------------------------
    def get_input_names(self):
        return list(self._input_names) if self._input_names else \
            [f"x{i}" for i in range(max(1, len(self._inputs)))]

    def get_output_names(self):
        return list(self._output_names) if self._output_names else \
            sorted(self._outputs)

    def get_input_handle(self, name):
        h = self._inputs.get(name)
        if h is None:
            h = Tensor(name, self, is_input=True)
            self._inputs[name] = h
        return h

    def get_output_handle(self, name):
        return Tensor(name, self, is_input=False)

    # -- run -------------------------------------------------------------------
    def run(self, inputs=None):
        """ZeroCopyRun parity. With `inputs` (list of np arrays) runs
        directly and returns np arrays (the Predictor.run list API)."""
        if inputs is not None:
            arrs = [np.asarray(a) for a in inputs]
        else:
            names = self._input_names or _natural_sorted(self._inputs)
            arrs = []
            for n in names:
                h = self._inputs.get(n)
                if h is None or h._host is None:
                    raise RuntimeError(f"input '{n}' not set; call "
                                       "get_input_handle(name).copy_from_cpu")
                arrs.append(h._host)
        outs = self._compiled(arrs)
        names = self._output_names or [f"out{i}" for i in range(len(outs))]
        self._output_names = names
        self._outputs = dict(zip(names, outs))
        self._run_count += 1
        return list(outs) if inputs is not None else True

    def try_shrink_memory(self):
        """Return the card's cached, unused memory to the driver."""
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def clear_intermediate_tensor(self):
        self._outputs = {}

    def clone(self):
        p = Predictor(self._cfg)
        # share the program cache: a cloned predictor serving the same
        # model must not capture a second graph
        if hasattr(self, "_jit_cache"):
            p._jit_cache = self._jit_cache
            p._cache_lock = self._cache_lock
        return p


def _natural_sorted(names):
    """Sort input names numerically where they carry a numeric suffix so the
    auto-generated x0..x10 handles keep positional order past 10 inputs."""
    def key(n):
        m = re.match(r"^(.*?)(\d+)$", n)
        return (m.group(1), int(m.group(2))) if m else (n, -1)
    return sorted(names, key=key)


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)


class PredictorPool:
    """paddle_infer::services::PredictorPool parity — N predictors sharing
    one program cache (clone() shares it)."""

    def __init__(self, config: Config, size=1):
        if int(size) < 1:
            raise InvalidArgumentError(
                f"PredictorPool size must be >= 1, got {size}")
        self._preds = [Predictor(config)]
        for _ in range(int(size) - 1):
            self._preds.append(self._preds[0].clone())

    def __len__(self):
        return len(self._preds)

    def retrieve(self, idx):
        if not 0 <= int(idx) < len(self._preds):
            raise OutOfRangeError(
                f"PredictorPool.retrieve({idx}): pool has "
                f"{len(self._preds)} predictors (valid: 0.."
                f"{len(self._preds) - 1})")
        return self._preds[int(idx)]


def save_predictor_model(path_prefix, fn, example_args, input_names=None,
                         output_names=None, platforms=None):
    """The reference exports a serialized StableHLO program; not ported."""
    raise NotImplementedError(f"save_predictor_model: {_SERIALIZED}")


def convert_to_mixed_precision(src_prefix, dst_prefix, mixed_precision="bf16",
                               backend=None, black_list=None):
    """The reference rewrites a saved program's parameters; not ported."""
    raise NotImplementedError(f"convert_to_mixed_precision: {_SERIALIZED}")


class PrecisionType:
    """analysis_config precision enum parity."""
    Float32 = 0
    Half = 1
    Int8 = 2
    Bfloat16 = 3


def get_trt_compile_version():
    """TensorRT is not part of this stack."""
    return (0, 0, 0)


def get_trt_runtime_version():
    return (0, 0, 0)


def get_num_bytes_of_data_type(dtype):
    """Accepts a DataType enum value or a dtype name string (PaddleDType
    parity); bfloat16 is 2 bytes."""
    if isinstance(dtype, int):
        name = _NP_OF[dtype]
    else:
        name = str(dtype)
    return 2 if name == "bfloat16" else int(np.dtype(name).itemsize)
