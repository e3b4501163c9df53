"""The port's wire codec (paddle_tpu_torch/distributed/wire.py) against the
reference's (paddle_tpu/distributed/wire.py): the same bytes for the same
objects, each package decoding the other's frames, the same HMAC under
one secret and a tampered frame refused by both, the depth and size
limits, and the generation, model-version, trace and stream stamps in
both directions. A bf16 array travels as the reference's ml_dtypes array
on one side and as a torch.bfloat16 tensor on the other."""
import socket
import struct

import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.distributed import wire as ref
from paddle_tpu_torch.distributed import wire as pt

RNG = np.random.RandomState(0)
F32 = RNG.randn(3, 4).astype("float32")
I64 = np.arange(-5, 7, dtype="int64").reshape(2, 6)
BF16 = RNG.randn(2, 5).astype("float32")

OBJECTS = {
    "none_bools": [None, True, False],
    "ints": [0, -1, 2 ** 40, -2 ** 63, 2 ** 63 - 1],
    "bigints": [2 ** 64, -2 ** 100, 10 ** 30],
    "floats": [0.0, -3.5, 1e300, float("inf")],
    "str_bytes": ["", "hello", "日本語", b"", b"\x00\xff", bytearray(b"ab")],
    "nesting": {"cmd": "push", "t": (1, [2, {"k": (None, b"z")}]),
                1: "int-key", (2, 3): "tuple-key"},
    "numpy_scalars": {"i": np.int32(5), "f": np.float64(2.5),
                      "b": np.bool_(True)},
    "f32": F32,
    "i64": I64,
    "zero_dim": np.asarray(7, dtype="int64"),
    "empty": np.zeros((0, 3), dtype="float32"),
    "frame": {"src": 1, "tag": ["p2p", 3], "payload": {"w": F32,
                                                       "ids": I64}},
}


def _port_value(obj):
    """The port's counterpart of a reference value: numeric arrays as
    tensors (a tensor travels as its ndarray)."""
    if isinstance(obj, np.ndarray) and obj.ndim:
        return torch.from_numpy(obj.copy())
    if isinstance(obj, dict):
        return {k: _port_value(v) for k, v in obj.items()}
    return obj


@pytest.mark.parametrize("name", sorted(OBJECTS))
def test_same_bytes_for_the_same_objects(name):
    obj = OBJECTS[name]
    assert pt.encode(obj) == ref.encode(obj)
    assert pt.encode(_port_value(obj)) == ref.encode(obj)


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        a = a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    if isinstance(b, torch.Tensor):
        b = b.float().numpy() if b.dtype == torch.bfloat16 else b.numpy()
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype.name == "bfloat16":
            a = a.astype("float32")
        if b.dtype.name == "bfloat16":
            b = b.astype("float32")
        return a.dtype == b.dtype and a.shape == b.shape and \
            np.array_equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(
            _equal(x, y) for x, y in zip(a, b))
    return a == b and type(a) is type(b)


@pytest.mark.parametrize("name", sorted(OBJECTS))
def test_each_package_decodes_the_others_frames(name):
    obj = OBJECTS[name]
    want = ref.decode(ref.encode(obj))
    assert _equal(pt.decode(ref.encode(obj)), want)
    assert _equal(ref.decode(pt.encode(_port_value(obj))), want)


def test_bf16_tensor_is_the_references_ml_dtypes_array():
    r = BF16.astype(ml_dtypes.bfloat16)
    t = torch.from_numpy(BF16).bfloat16()
    assert pt.encode(t) == ref.encode(r)
    assert pt.encode({"w": [t]}) == ref.encode({"w": [r]})
    # the port decodes the reference's frame to a bf16 tensor, no
    # ml_dtypes needed, and the reference the port's to its array
    got = pt.decode(ref.encode(r))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
    assert torch.equal(got, t)
    back = ref.decode(pt.encode(t))
    assert back.dtype == r.dtype
    np.testing.assert_array_equal(back.view(np.int16),
                                  r.view(np.int16))


def test_bf16_decode_needs_no_ml_dtypes():
    import subprocess
    import sys
    code = ("import sys\n"
            "sys.modules['ml_dtypes'] = None\n"
            "import torch\n"
            "from paddle_tpu_torch.distributed import wire\n"
            "t = torch.tensor([[1.5, -2.25]], dtype=torch.bfloat16)\n"
            "got = wire.decode(wire.encode({'t': t}))['t']\n"
            "assert got.dtype == torch.bfloat16 and torch.equal(got, t)\n"
            "print('ok')\n")
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "ok" in r.stdout, r.stderr


def _frames(codec, obj, monkeypatch, secret):
    if secret is None:
        monkeypatch.delenv("PADDLE_TPU_WIRE_SECRET", raising=False)
    else:
        monkeypatch.setenv("PADDLE_TPU_WIRE_SECRET", secret)
    a, b = socket.socketpair()
    try:
        codec.send_frame(a, obj, timeout=5)
        a.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            c = b.recv(1 << 16)
            if not c:
                return b"".join(chunks)
            chunks.append(c)
    finally:
        a.close()
        b.close()


def _recv(codec, raw, timeout=5):
    a, b = socket.socketpair()
    try:
        a.sendall(raw)
        a.shutdown(socket.SHUT_WR)
        return codec.recv_frame(b, timeout=timeout)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("secret", [None, "s3cret"])
def test_framed_bytes_and_hmac_match_the_reference(secret, monkeypatch):
    obj = OBJECTS["frame"]
    raw_pt = _frames(pt, _port_value(obj), monkeypatch, secret)
    raw_ref = _frames(ref, obj, monkeypatch, secret)
    assert raw_pt == raw_ref
    n, maclen = struct.unpack("<QB", raw_pt[:9])
    assert maclen == (0 if secret is None else 32)
    assert _equal(_recv(pt, raw_ref), ref.decode(ref.encode(obj)))
    assert _equal(_recv(ref, raw_pt), ref.decode(ref.encode(obj)))


def test_a_tampered_frame_is_refused_by_both(monkeypatch):
    raw = bytearray(_frames(pt, {"x": 1, "y": "payload"}, monkeypatch,
                            "k1"))
    raw[-1] ^= 0x01
    for codec in (pt, ref):
        with pytest.raises(codec.FrameError, match="HMAC"):
            _recv(codec, bytes(raw))
    # and a frame signed under another secret
    other = _frames(ref, {"x": 1}, monkeypatch, "k2")
    monkeypatch.setenv("PADDLE_TPU_WIRE_SECRET", "k1")
    for codec in (pt, ref):
        with pytest.raises(codec.FrameError, match="HMAC"):
            _recv(codec, other)


def test_depth_and_size_limits_give_frame_error(monkeypatch):
    deep = []
    for _ in range(80):
        deep = [deep]
    for codec in (pt, ref):
        with pytest.raises(codec.FrameError, match="too deep"):
            codec.encode(deep)
    # a hand-made frame 80 lists deep
    frame = b"".join(b"l" + struct.pack("<Q", 1) for _ in range(80)) + b"N"
    for codec in (pt, ref):
        with pytest.raises(codec.FrameError, match="too deep"):
            codec.decode(frame)
    monkeypatch.delenv("PADDLE_TPU_WIRE_SECRET", raising=False)
    huge = struct.pack("<QB", (1 << 33) + 1, 0)
    for codec in (pt, ref):
        with pytest.raises(codec.FrameError, match="too large"):
            _recv(codec, huge)
    for bad in (b"", b"z", b"i\x01", ref.encode({"x": 1})[:-1],
                ref.encode({"x": 1}) + b"junk"):
        for codec in (pt, ref):
            with pytest.raises(codec.FrameError):
                codec.decode(bad)


@pytest.mark.parametrize("shape,nraw,match", [
    ((-1,), 8, "negative array dim"),
    ((2, 2), 8, "size mismatch"),
    ((2 ** 31, 2 ** 31), 8, "size mismatch")])
def test_array_header_validation(shape, nraw, match):
    frame = (b"a" + struct.pack("<B", 3) + b"<f8"
             + struct.pack("<B", len(shape))
             + struct.pack(f"<{len(shape)}q", *shape)
             + struct.pack("<Q", nraw) + b"\x00" * nraw)
    with pytest.raises(pt.FrameError, match=match):
        pt.decode(frame)


def test_stamps_cross_both_ways():
    for stamp_with, read_with in ((pt, ref), (ref, pt)):
        f = stamp_with.stamp_generation({"src": 0}, generation=4)
        f = stamp_with.stamp_model_version(f, "v7")
        f = stamp_with.stamp_trace(f, ("trace-a", 12))
        f = stamp_with.stamp_stream(f, 0, end=True)
        back = read_with.decode(stamp_with.encode(f))
        assert read_with.frame_generation(back) == 4
        assert read_with.frame_model_version(back) == "v7"
        assert read_with.frame_trace(back) == ("trace-a", 12)
        assert read_with.frame_stream_seq(back) == 0
        assert read_with.frame_stream_end(back) is True
        assert read_with.StreamReader().feed(back) == (0, True)
    # generation 0 stamps nothing: an unfenced process sends the same bytes
    assert pt.encode(pt.stamp_generation({"a": 1}, generation=0)) == \
        ref.encode({"a": 1})


def test_stream_reader_tears_on_gap_and_generation():
    r = pt.StreamReader()
    assert r.feed(pt.stamp_stream({"gen": 2}, 0)) == (0, False)
    with pytest.raises(pt.FrameError, match="expected seq 1"):
        r.feed(pt.stamp_stream({"gen": 2}, 2))
    r = pt.StreamReader(generation=2)
    with pytest.raises(pt.FrameError, match="generation fence"):
        r.feed(pt.stamp_stream({"gen": 3}, 0))
    with pytest.raises(pt.FrameError, match="unstamped"):
        pt.StreamReader().feed({"x": 1})


def test_idle_timeout_before_a_frame_and_frame_error_mid_frame():
    a, b = socket.socketpair()
    try:
        with pytest.raises(pt.IdleTimeout):
            pt.recv_frame(b, timeout=0.05, idle_ok=True)
        a.sendall(struct.pack("<QB", 10, 0) + b"abc")
        with pytest.raises(pt.FrameError, match="mid-frame"):
            pt.recv_frame(b, timeout=0.05, idle_ok=True)
    finally:
        a.close()
        b.close()
