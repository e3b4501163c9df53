"""Non-executable wire format for the port's TCP transports (port of
paddle_tpu/distributed/wire.py).

The reference's brpc/protobuf frames become a tiny tag-based binary codec
that can only construct plain data (None/bool/int/float/str/bytes/list/
tuple/dict/array): decoding a peer's bytes never runs code. The port
writes the same bytes as the reference for the same objects, so each
package reads the other's frames.

A ``torch.Tensor`` travels as its ndarray. The accelerator dtypes numpy
lacks travel by name with their raw words (a bf16 tensor as
``"bfloat16"`` and its 16-bit words, as the reference sends an ml_dtypes
array); they decode to torch tensors of that dtype, without ml_dtypes,
which the port does not need. Every other array decodes to an ndarray, as
in the reference.

Optional integrity: set PADDLE_TPU_WIRE_SECRET on every process and each
frame carries an HMAC-SHA256 that receivers verify before decoding.
"""
from __future__ import annotations

import hashlib
import hmac
import os
import struct

import numpy as np
import torch

from ..resilience.faults import maybe_inject

__all__ = ["encode", "decode", "send_frame", "recv_frame", "FrameError",
           "IdleTimeout", "stamp_generation", "frame_generation",
           "stamp_model_version", "frame_model_version",
           "stamp_trace", "frame_trace",
           "stamp_stream", "frame_stream_seq", "frame_stream_end",
           "StreamReader"]

_MAX_FRAME = 1 << 33  # 8 GiB sanity bound
_MAX_DEPTH = 64


def _io_timeout():
    """Default deadline for one framed read/write. Env wins; falls back to
    FLAGS_collective_timeout so a dead peer can't pin a reader forever."""
    v = os.environ.get("PADDLE_TPU_WIRE_TIMEOUT")
    if v is not None:
        return float(v) or None  # 0 disables (tests, trusted local pipes)
    from ..framework.flags import get_flag
    return float(get_flag("FLAGS_collective_timeout", 300.0))


class FrameError(ValueError):
    pass


class IdleTimeout(TimeoutError):
    """recv_frame timed out with ZERO bytes consumed: the stream is still
    framed and a reader loop may keep waiting. A timeout after partial
    consumption raises FrameError instead: the stream lost sync and the
    connection must be dropped."""


def _secret():
    s = os.environ.get("PADDLE_TPU_WIRE_SECRET")
    return s.encode() if s else None


# accelerator dtypes (ml_dtypes' numpy kind 'V'), carried by name
_ML_DTYPES = ("bfloat16", "float8_e4m3fn", "float8_e5m2", "float8_e4m3",
              "float8_e3m4", "float8_e4m3b11fnuz", "float8_e5m2fnuz",
              "float8_e4m3fnuz", "float4_e2m1fn", "int4", "uint4")
# the ones torch holds, by the name on the wire, with the integer type
# of their raw words
_TORCH_NAMED = {"bfloat16": (torch.bfloat16, torch.int16)}
for _name in ("float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz",
              "float8_e5m2fnuz"):
    if hasattr(torch, _name):
        _TORCH_NAMED[_name] = (getattr(torch, _name), torch.uint8)
_NAME_OF_TORCH = {dt: name for name, (dt, _) in _TORCH_NAMED.items()}


# -- codec -------------------------------------------------------------------

def _enc_raw(dt, shape, raw, out):
    out.append(b"a" + struct.pack("<B", len(dt)) + dt
               + struct.pack("<B", len(shape))
               + struct.pack(f"<{len(shape)}q", *shape)
               + struct.pack("<Q", len(raw)) + raw)


def _enc_tensor(t, out, depth):
    t = t.detach().cpu().contiguous()
    name = _NAME_OF_TORCH.get(t.dtype)
    if name is not None:
        words = t.view(_TORCH_NAMED[name][1]).numpy()
        _enc_raw(name.encode(), tuple(t.shape), words.tobytes(), out)
        return
    try:
        arr = t.numpy()
    except TypeError:
        raise FrameError(f"unsupported tensor dtype {t.dtype}") from None
    _enc(arr, out, depth)


def _enc(obj, out, depth=0):
    if depth > _MAX_DEPTH:
        raise FrameError("structure too deep")
    if obj is None:
        out.append(b"N")
    elif obj is True:
        out.append(b"T")
    elif obj is False:
        out.append(b"F")
    elif isinstance(obj, (np.integer,)):
        _enc(int(obj), out, depth)
    elif isinstance(obj, (np.floating,)):
        _enc(float(obj), out, depth)
    elif isinstance(obj, np.bool_):
        _enc(bool(obj), out, depth)
    elif isinstance(obj, int):
        try:
            out.append(b"i" + struct.pack("<q", obj))
        except struct.error:  # bigint
            s = str(obj).encode()
            out.append(b"I" + struct.pack("<I", len(s)) + s)
    elif isinstance(obj, float):
        out.append(b"f" + struct.pack("<d", obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out.append(b"s" + struct.pack("<Q", len(b)) + b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        out.append(b"b" + struct.pack("<Q", len(b)) + b)
    elif isinstance(obj, (list, tuple)):
        out.append((b"l" if isinstance(obj, list) else b"t")
                   + struct.pack("<Q", len(obj)))
        for it in obj:
            _enc(it, out, depth + 1)
    elif isinstance(obj, dict):
        out.append(b"d" + struct.pack("<Q", len(obj)))
        for k, v in obj.items():
            _enc(k, out, depth + 1)
            _enc(v, out, depth + 1)
    elif isinstance(obj, np.ndarray):
        if obj.dtype.kind in "biufc":
            dt = obj.dtype.str.encode()
        elif obj.dtype.name in _ML_DTYPES:  # an ml_dtypes array (kind 'V')
            dt = obj.dtype.name.encode()
        else:
            raise FrameError(f"unsupported array dtype {obj.dtype}")
        arr = np.ascontiguousarray(obj)
        _enc_raw(dt, arr.shape, arr.tobytes(), out)
    elif isinstance(obj, torch.Tensor):
        _enc_tensor(obj, out, depth)
    else:
        # anything array-like with __array__ goes as ndarray
        a = np.asarray(obj)
        if a.dtype.kind in "biufc":
            _enc(a, out, depth)
        else:
            raise FrameError(f"unserializable type {type(obj).__name__}")


def encode(obj) -> bytes:
    out = []
    _enc(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.off = 0

    def take(self, n):
        if self.off + n > len(self.buf):
            raise FrameError("truncated frame")
        v = self.buf[self.off:self.off + n]
        self.off += n
        return v

    def unpack(self, fmt):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))


def _dec_array(r):
    (dtn,) = r.unpack("<B")
    name = bytes(r.take(dtn)).decode(errors="replace")
    named = name in _ML_DTYPES
    if named:
        if name not in _TORCH_NAMED:
            raise FrameError(f"array dtype {name} has no torch dtype")
        dt, word = _TORCH_NAMED[name]
        itemsize = torch.empty((), dtype=word).element_size()
    else:
        try:
            dt = np.dtype(name)
        except (TypeError, ValueError) as e:
            raise FrameError(f"bad array dtype: {e}") from None
        if dt.kind not in "biufc":
            raise FrameError(f"disallowed array dtype {dt}")
        itemsize = dt.itemsize
    (ndim,) = r.unpack("<B")
    shape = r.unpack(f"<{ndim}q") if ndim else ()
    # signed shape fields: a corrupt or hostile frame can carry negative
    # dims or a count that disagrees with the payload length
    if any(d < 0 for d in shape):
        raise FrameError(f"negative array dim in {shape}")
    (nraw,) = r.unpack("<Q")
    count = 1
    for d in shape:
        count *= d
    if count * itemsize != nraw:
        raise FrameError(
            f"array payload size mismatch: shape {tuple(shape)} x {name} "
            f"needs {count * itemsize} bytes, frame has {nraw}")
    raw = r.take(nraw)
    if named:
        words = np.frombuffer(raw, dtype=f"<i{itemsize}" if itemsize == 2
                              else np.uint8).reshape(shape).copy()
        return torch.from_numpy(words).view(dt)
    return np.frombuffer(raw, dtype=dt).reshape(shape).copy()


def _dec(r, depth=0):
    if depth > _MAX_DEPTH:
        raise FrameError("structure too deep")
    tag = bytes(r.take(1))
    if tag == b"N":
        return None
    if tag == b"T":
        return True
    if tag == b"F":
        return False
    if tag == b"i":
        return r.unpack("<q")[0]
    if tag == b"I":
        (n,) = r.unpack("<I")
        return int(bytes(r.take(n)).decode())
    if tag == b"f":
        return r.unpack("<d")[0]
    if tag == b"s":
        (n,) = r.unpack("<Q")
        return bytes(r.take(n)).decode("utf-8")
    if tag == b"b":
        (n,) = r.unpack("<Q")
        return bytes(r.take(n))
    if tag in (b"l", b"t"):
        (n,) = r.unpack("<Q")
        items = [_dec(r, depth + 1) for _ in range(n)]
        return items if tag == b"l" else tuple(items)
    if tag == b"d":
        (n,) = r.unpack("<Q")
        out = {}
        for _ in range(n):
            k = _dec(r, depth + 1)
            out[k] = _dec(r, depth + 1)
        return out
    if tag == b"a":
        return _dec_array(r)
    raise FrameError(f"bad tag {tag!r}")


def decode(buf):
    r = _Reader(buf)
    obj = _dec(r)
    if r.off != len(r.buf):
        raise FrameError("trailing bytes in frame")
    return obj


# -- framed socket IO --------------------------------------------------------

def _recv_exact(sock, n, idle_ok=False):
    chunks = []
    got = 0
    while got < n:
        try:
            c = sock.recv(min(n - got, 1 << 20))
        except TimeoutError:
            if idle_ok and got == 0:
                raise IdleTimeout("no frame within socket timeout") from None
            # a partial frame and a timeout: the stream lost sync, and the
            # only safe recovery is dropping the connection
            raise FrameError(
                f"socket timed out mid-frame ({got}/{n} bytes)") from None
        if not c:
            raise ConnectionError("peer closed")
        chunks.append(c)
        got += len(c)
    return b"".join(chunks)


def _mac(payload):
    secret = _secret()
    return hmac.new(secret, payload, hashlib.sha256).digest() if secret \
        else b""


def _verified(mac, payload):
    secret = _secret()
    if secret:
        want = hmac.new(secret, payload, hashlib.sha256).digest()
        if not hmac.compare_digest(mac, want):
            raise FrameError("HMAC verification failed")
    return decode(payload)


def send_frame(sock, obj, timeout=...):
    """Send one frame. timeout: seconds for the whole sendall (None =
    block forever; default from PADDLE_TPU_WIRE_TIMEOUT /
    FLAGS_collective_timeout): a dead peer with a full TCP buffer must not
    hang the sender."""
    maybe_inject("wire.send_frame", ConnectionError)
    if timeout is ...:
        timeout = _io_timeout()
    if timeout is not None:
        sock.settimeout(timeout)
    payload = encode(obj)
    mac = _mac(payload)
    sock.sendall(struct.pack("<QB", len(payload), len(mac)) + mac + payload)


def recv_frame(sock, timeout=..., idle_ok=False):
    """Receive one frame. timeout bounds every read (None = block forever;
    default as in send_frame). With idle_ok=True a timeout BEFORE the
    first header byte raises IdleTimeout (reader loops keep waiting); a
    timeout mid-frame always raises FrameError (drop the socket)."""
    maybe_inject("wire.recv_frame", ConnectionError)
    if timeout is ...:
        timeout = _io_timeout()
    if timeout is not None:
        sock.settimeout(timeout)
    n, maclen = struct.unpack("<QB", _recv_exact(sock, 9, idle_ok=idle_ok))
    if n > _MAX_FRAME:
        raise FrameError(f"frame too large ({n})")
    mac = _recv_exact(sock, maclen) if maclen else b""
    return _verified(mac, _recv_exact(sock, n))


def read_frame_from(rfile):
    """recv_frame over a buffered file object (a socketserver handler);
    None at a clean or torn end of stream."""
    head = rfile.read(9)
    if len(head) < 9:
        return None
    n, maclen = struct.unpack("<QB", head)
    if n > _MAX_FRAME:
        raise FrameError(f"frame too large ({n})")
    mac = rfile.read(maclen) if maclen else b""
    payload = rfile.read(n)
    if len(payload) < n:
        return None
    return _verified(mac, payload)


# -- generation fencing (resilience/recovery.py) -----------------------------

def stamp_generation(frame, generation=None):
    """Stamp the collective generation into an outgoing frame dict.

    Generation 0, a process that never rendezvoused, stamps nothing, so
    jobs without recovery keep producing the same bytes. The stamp rides
    inside the frame dict: peers that predate the fence ignore the key.
    """
    if generation is None:
        from ..resilience.recovery import current_generation
        generation = current_generation()
    if generation and isinstance(frame, dict):
        frame["gen"] = int(generation)
    return frame


def frame_generation(frame):
    """The generation stamped into a received frame (0 when unstamped or
    mangled: an unfenced peer reads as generation 0)."""
    if isinstance(frame, dict):
        try:
            return int(frame.get("gen", 0) or 0)
        except (TypeError, ValueError):
            return 0
    return 0


# -- model-version stamping (serving rollouts) -------------------------------

def stamp_model_version(frame, version):
    """Stamp the serving model version into an outgoing reply frame dict
    (nothing for None, so servers without rollouts send the same bytes)."""
    if version is not None and isinstance(frame, dict):
        frame["model_version"] = version
    return frame


def frame_model_version(frame):
    """The model version stamped into a received frame, or None."""
    if isinstance(frame, dict):
        v = frame.get("model_version")
        if isinstance(v, (int, float, str)):
            return v
    return None


# -- trace-context stamping (request tracing) --------------------------------

def stamp_trace(frame, ctx):
    """Stamp ``(trace_id, span_id)`` into an outgoing frame dict (nothing
    for None)."""
    if ctx is not None and isinstance(frame, dict):
        tid, sid = ctx
        if isinstance(tid, str):
            frame["trace"] = [tid, int(sid)]
    return frame


def frame_trace(frame):
    """``(trace_id, parent_span_id)`` of a received frame, or None when
    unstamped or mangled."""
    if isinstance(frame, dict):
        v = frame.get("trace")
        if (isinstance(v, (list, tuple)) and len(v) == 2
                and isinstance(v[0], str)
                and isinstance(v[1], int)
                and not isinstance(v[1], bool)):
            return (v[0], v[1])
    return None


# -- streaming replies --------------------------------------------------------

def stamp_stream(frame, seq, end=False):
    """Stamp a multi-frame reply: a contiguous 0-based ``stream_seq`` and
    ``stream_end`` on the final frame."""
    if isinstance(frame, dict):
        frame["stream_seq"] = int(seq)
        if end:
            frame["stream_end"] = True
    return frame


def frame_stream_seq(frame):
    """The stream sequence number of a received frame, or None."""
    if isinstance(frame, dict):
        v = frame.get("stream_seq")
        if isinstance(v, bool):
            return None
        if isinstance(v, (int, float)):
            return int(v)
    return None


def frame_stream_end(frame):
    """True when the frame carries the end-of-stream marker."""
    return bool(isinstance(frame, dict) and frame.get("stream_end"))


class StreamReader:
    """Per-stream reassembly check: frames must arrive with contiguous
    sequence numbers from 0 and stop at the end marker; a gap, a
    regression, an unstamped frame or a frame after the end raises
    :class:`FrameError`. Generation-fenced: the first frame's generation
    (or ``generation=``) pins the stream, and a frame stamped otherwise
    tears it."""

    __slots__ = ("next_seq", "ended", "generation")

    def __init__(self, generation=None):
        self.next_seq = 0
        self.ended = False
        self.generation = None if generation is None else int(generation)

    def feed(self, frame):
        """Validate one frame; returns ``(seq, end)``."""
        if self.ended:
            raise FrameError("torn stream: frame after end-of-stream marker")
        seq = frame_stream_seq(frame)
        if seq is None:
            raise FrameError("torn stream: unstamped frame inside a stream")
        gen = frame_generation(frame)
        if self.generation is None:
            self.generation = gen
        elif gen != self.generation:
            raise FrameError(
                f"torn stream: generation fence (stream pinned to "
                f"generation {self.generation}, frame stamped {gen})")
        if seq != self.next_seq:
            raise FrameError(
                f"torn stream: expected seq {self.next_seq}, got {seq}")
        self.next_seq = seq + 1
        end = frame_stream_end(frame)
        self.ended = end
        return seq, end
