"""Serving over the wire: the port's SocketFrontend and InferenceClient
against the reference's, on the host.

- the reference's TestSocketServing cases (tests/test_serving.py) on the
  port: a round trip, eight concurrent clients, a shed that comes back as
  the typed ``ServerOverloaded``, the client's backoff absorbing it, a
  malformed frame answered with a typed error;
- one codec: the reference's client against the port's frontend and the
  port's client against the reference's give the replies each package
  gives itself, HMAC-checked frames included;
- the generate stream: one frame per token, contiguous ``stream_seq`` from
  0, the end marker on the terminal frame with the whole token list, the
  tokens those of a colocated decode run; a torn stream (a gap, or a peer
  that hangs up) raises with ``tokens_delivered``; disaggregated
  prefill/decode streams over the same protocol;
- results that are tensors (bf16 included) are copied to the host before
  they are framed;
- the slice: a 2-layer, width-64 BERT classifier served by both packages
  behind SocketFrontend (the port's weights carried from the reference's
  with ``load_numpy_state_dict``), then rolled to a second committed
  manifest; every reply equals the reference's reply for the same version
  within f32 tolerance (SLICE_TOL) and carries that version.

Threaded servers on the real clock with sub-second bounded waits; fake
clocks where a case drives a decode engine by hand.
"""
import socket
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as ref_paddle
import paddle_tpu.inference as ref_infer
import paddle_tpu.serving as ref_serving
from paddle_tpu.distributed import wire as ref_wire
from paddle_tpu.resilience import faults as ref_faults
from paddle_tpu.resilience import recovery as ref_recovery
from paddle_tpu.resilience import snapshot as ref_snapshot
from paddle_tpu.text.models.bert import BertConfig as RefBertConfig
from paddle_tpu.text.models.bert import \
    BertForSequenceClassification as RefBert

import paddle_tpu_torch as pt
import paddle_tpu_torch.inference as port_infer
import paddle_tpu_torch.serving as serving
from paddle_tpu_torch.core import device as port_device
from paddle_tpu_torch.distributed import wire
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.resilience import recovery as port_recovery
from paddle_tpu_torch.resilience import snapshot as port_snapshot
from paddle_tpu_torch.serving import (InferenceClient, InferenceServer,
                                      ServerOverloaded, ServingConfig,
                                      SocketFrontend)
from paddle_tpu_torch.serving.decode import (CompiledDecodeBackend,
                                             DecodeConfig, DecodeEngine)
from paddle_tpu_torch.text.models import (BertConfig,
                                          BertForSequenceClassification)

torch.set_num_threads(1)

# the slice's replies against the reference's, both f32 on the host
SLICE_TOL = dict(rtol=1e-4, atol=1e-5)
SLICE_CFG = dict(vocab_size=120, hidden_size=64, num_layers=2, num_heads=4,
                 intermediate_size=128, max_position=64, dropout=0.0)
SLICE_SEQ = 16
# version 2: version 1 plus Gaussian noise of this fraction of each
# parameter's std (keeps the golden gate's drift under its 1.0 default)
SLICE_NOISE = 0.05


class FakePredictor:
    """Doubles input[0]."""

    def run(self, arrays):
        return [np.asarray(arrays[0]) * 2.0]


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_ARTIFACTS_DIR", str(tmp_path / "art"))
    before = port_device._current
    pt.set_device("cpu")
    faults.reset()
    ref_faults.reset()
    yield
    faults.reset()
    ref_faults.reset()
    port_device._current = before


def started(mod, predictor=FakePredictor, **kw):
    cfg = mod.ServingConfig(max_batch_size=4, replicas=2, batch_wait=0.005,
                            **kw)
    srv = mod.InferenceServer(lambda i: predictor(), cfg)
    srv.start()
    return srv, mod.SocketFrontend(srv)


@pytest.fixture()
def served():
    srv, fe = started(serving)
    yield srv, fe
    fe.close()
    srv.stop()


# -- the reference's TestSocketServing, on the port ---------------------------

class TestSocketServing:
    def test_roundtrip(self, served):
        srv, fe = served
        with InferenceClient(fe.address) as cli:
            x = np.arange(6, dtype="float32").reshape(2, 3)
            [out] = cli.infer([x], timeout=10.0)
            np.testing.assert_allclose(out, x * 2.0)

    def test_concurrent_clients(self, served):
        srv, fe = served
        outs = {}
        errs = []

        def one(k):
            try:
                with InferenceClient(fe.address) as cli:
                    [o] = cli.infer([np.full((1, 3), k, "float32")],
                                    timeout=10.0)
                    outs[k] = o
            except Exception as e:   # collected, not swallowed
                errs.append(e)

        threads = [threading.Thread(target=one, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=15)
        assert not errs
        assert len(outs) == 8
        for k, o in outs.items():
            np.testing.assert_allclose(o, k * 2.0)
        assert srv.metrics.get("completed") == 8

    def test_shed_roundtrips_as_typed_overloaded(self, served):
        srv, fe = served
        faults.configure("serving.enqueue:#1")
        with InferenceClient(fe.address, retries=0) as cli:
            with pytest.raises(ServerOverloaded):
                cli.infer([np.ones((1, 3), "float32")], timeout=10.0)

    def test_shed_retried_by_client_backoff(self, served):
        srv, fe = served
        faults.configure("serving.enqueue:#1")
        waits = []
        with InferenceClient(fe.address, sleep=waits.append) as cli:
            [out] = cli.infer([np.ones((1, 3), "float32")], timeout=10.0)
        np.testing.assert_allclose(out, 2.0)
        assert len(waits) == 1 and waits[0] >= 0.0

    def test_malformed_frame_gets_error_reply(self, served):
        srv, fe = served
        with socket.create_connection(fe.address, timeout=5) as s:
            wire.send_frame(s, {"id": 1, "not_inputs": []})
            reply = wire.recv_frame(s, timeout=5)
        assert reply["error_type"] == "ValueError"
        assert "inputs" in reply["error"]


def test_backoff_delay_honours_retry_after_like_the_reference():
    import random
    got = []
    for mod in (ref_serving, serving):
        cli = mod.InferenceClient(("127.0.0.1", 1), rng=random.Random(3))
        got.append([cli.backoff_delay(a, ra) for a in range(6)
                    for ra in (None, 0.01, 0.3)])
    assert got[1] == got[0]
    assert all(d >= 0.3 for d in got[1][2::3])


# -- one codec: either client against either frontend ------------------------

def _replies(client_mod, address, rows):
    with client_mod.InferenceClient(address) as cli:
        return [cli.infer([r], timeout=10.0)[0] for r in rows]


@pytest.mark.parametrize("client_pkg,frontend_pkg", [
    ("paddle_tpu", "paddle_tpu_torch"), ("paddle_tpu_torch", "paddle_tpu")])
def test_client_and_frontend_pair_across_packages(client_pkg, frontend_pkg):
    mods = {"paddle_tpu": ref_serving, "paddle_tpu_torch": serving}
    rows = [np.random.RandomState(k).randn(1, 3).astype("float32")
            for k in range(5)]
    srv, fe = started(mods[frontend_pkg])
    try:
        across = _replies(mods[client_pkg], fe.address, rows)
        own = _replies(mods[frontend_pkg], fe.address, rows)
    finally:
        fe.close()
        srv.stop()
    for a, b, r in zip(across, own, rows):
        assert isinstance(a, np.ndarray) and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, r * 2.0)


def test_hmac_frames_across_packages(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_WIRE_SECRET", "s3cret")
    srv, fe = started(serving)
    try:
        rows = [np.ones((1, 3), "float32")]
        assert np.array_equal(_replies(ref_serving, fe.address, rows)[0],
                              rows[0] * 2.0)
        # a peer without the secret sends unsigned frames: the frontend
        # drops the connection rather than decode them
        monkeypatch.setattr(ref_wire, "_secret", lambda: None)
        with socket.create_connection(fe.address, timeout=5) as s:
            ref_wire.send_frame(s, {"id": 1, "inputs": rows})
            with pytest.raises((ref_wire.FrameError, ConnectionError,
                                OSError)):
                ref_wire.recv_frame(s, timeout=5)
    finally:
        fe.close()
        srv.stop()


def test_tensor_results_are_framed_as_host_values():
    class TensorPredictor:
        def run(self, arrays):
            x = torch.from_numpy(np.asarray(arrays[0]))
            return [x * 2.0, (x * 3.0).to(torch.bfloat16)]

    srv, fe = started(serving, predictor=TensorPredictor)
    try:
        with InferenceClient(fe.address) as cli:
            f32, bf16 = cli.infer([np.full((2, 3), 1.5, "float32")],
                                  timeout=10.0)
        with ref_serving.InferenceClient(fe.address) as cli:
            _, ref_bf16 = cli.infer([np.full((2, 3), 1.5, "float32")],
                                    timeout=10.0)
    finally:
        fe.close()
        srv.stop()
    assert isinstance(f32, np.ndarray) and np.all(f32 == 3.0)
    assert isinstance(bf16, torch.Tensor) and bf16.dtype == torch.bfloat16
    assert torch.all(bf16.float() == 4.5)
    # the reference reads the same bf16 words as its ml_dtypes array
    assert str(ref_bf16.dtype) == "bfloat16"
    assert np.all(np.asarray(ref_bf16, np.float32) == 4.5)


# -- the generate stream -------------------------------------------------------

GEN = 6


def colocated(prompt, n=GEN):
    clock = FakeClock()
    eng = DecodeEngine(CompiledDecodeBackend(device="cpu"),
                       DecodeConfig(max_new_tokens=n), clock=clock)
    s = eng.join(list(prompt))
    for _ in range(1000):
        if s.done:
            break
        eng.step()
        clock.advance(0.01)
    assert s.done and s.error is None
    return list(s.tokens)


@pytest.fixture()
def generating():
    srv = InferenceServer(lambda i: FakePredictor(),
                          ServingConfig(max_batch_size=4, replicas=1,
                                        batch_wait=0.002))
    srv.attach_decode(CompiledDecodeBackend(device="cpu"),
                      DecodeConfig(max_new_tokens=GEN))
    srv.start()
    fe = SocketFrontend(srv)
    yield srv, fe
    fe.close()
    srv.stop()


def test_generate_stream_frames_are_sequenced_and_terminated(generating):
    srv, fe = generating
    prompt = [3, 1, 4, 1, 5]
    with socket.create_connection(fe.address, timeout=10) as s:
        wire.send_frame(s, {"op": "generate", "id": "g1",
                            "prompt": np.asarray(prompt, np.int64)})
        frames = []
        while True:
            f = wire.recv_frame(s, timeout=10)
            frames.append(f)
            if wire.frame_stream_end(f):
                break
    seqs = [wire.frame_stream_seq(f) for f in frames]
    assert seqs == list(range(len(frames)))
    tokens = [f["token"] for f in frames[:-1]]
    assert tokens == colocated(prompt)
    assert frames[-1]["tokens"] == tokens and "token" not in frames[-1]
    assert not any(wire.frame_stream_end(f) for f in frames[:-1])


@pytest.mark.parametrize("client_mod", [serving, ref_serving],
                         ids=["port_client", "reference_client"])
def test_client_generate_streams_the_colocated_tokens(generating,
                                                      client_mod):
    srv, fe = generating
    with client_mod.InferenceClient(fe.address) as cli:
        got = list(cli.generate([2, 7, 1, 8], timeout=10.0))
    assert got == colocated([2, 7, 1, 8])


def _fake_stream_server(frames, hang_up=True):
    """A listener that answers one generate frame with ``frames`` and then
    hangs up (a stream torn under the client), or, with ``hang_up``
    False, holds the connection until the client closes it."""
    lsn = socket.socket()
    lsn.bind(("127.0.0.1", 0))
    lsn.listen(1)

    def serve():
        conn, _ = lsn.accept()
        with conn:
            wire.recv_frame(conn, timeout=10)
            for f in frames:
                wire.send_frame(conn, f)
            if not hang_up:
                conn.settimeout(10)
                try:
                    conn.recv(1)       # b"" once the client closes
                except OSError:
                    pass
        lsn.close()
    t = threading.Thread(target=serve, daemon=True)
    t.start()
    return lsn.getsockname(), t


@pytest.mark.parametrize("case", ["hang_up", "gap"])
def test_torn_stream_carries_tokens_delivered(case):
    tok = [wire.stamp_stream({"id": "g", "token": t}, i)
           for i, t in enumerate([11, 12, 13])]
    if case == "gap":
        frames = [tok[0], tok[2]]     # seq 0 then seq 2
        want, err = [11], wire.FrameError
    else:
        frames = tok[:2]
        want, err = [11, 12], (wire.FrameError, ConnectionError, OSError)
    addr, t = _fake_stream_server(frames)
    got = []
    with InferenceClient(addr) as cli:
        with pytest.raises(err) as info:
            for token in cli.generate([1, 2], timeout=5.0):
                got.append(token)
    t.join(timeout=10)
    assert got == want
    assert info.value.tokens_delivered == len(want)


def test_typed_error_frame_ends_the_stream_with_its_hint():
    frames = [wire.stamp_stream({"id": "g", "token": 5}, 0),
              wire.stamp_stream({"id": "g", "error": "full",
                                 "error_type": "ServerOverloaded",
                                 "retry_after": 0.25}, 1, end=True)]
    addr, t = _fake_stream_server(frames, hang_up=False)
    got = []
    with InferenceClient(addr) as cli:
        with pytest.raises(ServerOverloaded) as info:
            for token in cli.generate([1], timeout=5.0):
                got.append(token)
    t.join(timeout=10)
    assert got == [5]
    assert info.value.retry_after == 0.25
    assert info.value.tokens_delivered == 1


def test_disaggregated_generation_streams_over_the_socket():
    """With disagg attached and no colocated engine, a generate frame goes
    through the prefill class, the KV handoff and the decode class; the
    client sees the colocated engine's tokens."""
    from paddle_tpu_torch.serving.disagg import DisaggConfig
    srv = InferenceServer(lambda i: FakePredictor(),
                          ServingConfig(max_batch_size=2, replicas=1,
                                        batch_wait=0.002))
    ctl = srv.attach_disagg(config=DisaggConfig(
        prefill_replicas=1, decode_replicas=2, max_new_tokens=GEN))
    srv.start()
    fe = SocketFrontend(srv)
    try:
        with InferenceClient(fe.address) as cli:
            streams = [list(cli.generate(p, timeout=10.0))
                       for p in ([1, 2, 3, 4, 5], list(range(40)))]
    finally:
        fe.close()
        srv.stop()
    assert streams == [colocated([1, 2, 3, 4, 5]), colocated(range(40))]
    assert ctl.stats()["migrations"] == 2
    assert ctl.leaked_blocks() == 0


# -- the slice: a small BERT served and rolled in both packages ---------------

def _slice_weights():
    """The launch weights (a seeded reference BERT's) and two versions, each
    the one before plus SLICE_NOISE x each parameter's std of noise."""
    ref_paddle.seed(0)
    model = RefBert(RefBertConfig(**SLICE_CFG), num_classes=2)
    weights = [{k: np.asarray(v._val) for k, v in model.state_dict().items()}]
    rng = np.random.RandomState(1)
    for _ in range(2):
        weights.append({k: (a + SLICE_NOISE * (a.std() or 1.0)
                            * rng.randn(*a.shape)).astype(a.dtype)
                        if a.dtype.kind == "f" else a
                        for k, a in weights[-1].items()})
    return weights


def _ref_predictor(arrays):
    model = RefBert(RefBertConfig(**SLICE_CFG), num_classes=2)
    model.set_state_dict({k: ref_paddle.to_tensor(v)
                          for k, v in arrays.items()})
    model.eval()
    cfg = ref_infer.Config()
    cfg.set_layer(model)
    return ref_infer.create_predictor(cfg)


def _port_predictor(arrays):
    model = BertForSequenceClassification(BertConfig(**SLICE_CFG),
                                          num_classes=2, device="cpu")
    pt.load_numpy_state_dict(model, arrays)
    model.eval()
    cfg = port_infer.Config()
    cfg.disable_gpu()
    cfg.set_layer(model)
    return port_infer.create_predictor(cfg)


SLICE = {"paddle_tpu": (ref_serving, ref_snapshot, ref_recovery,
                        _ref_predictor),
         "paddle_tpu_torch": (serving, port_snapshot, port_recovery,
                              _port_predictor)}


def served_and_rolled(name, tmp_path, weights, rows):
    """Launch on ``weights[0]`` (unversioned), answer ``rows`` over the
    socket; commit each later version as the next manifest, wait for its
    roll, answer them again. Returns [(version, logits)] per reply, in
    order."""
    mod, snap, rec, make = SLICE[name]
    root = str(tmp_path / name)
    ckpt = snap.AsyncCheckpointer(root, keep=3, background=False)
    srv = mod.InferenceServer(
        lambda i: make(weights[0]),
        mod.ServingConfig(max_batch_size=2, replicas=2, batch_wait=0.002))
    rc = srv.attach_rollout(
        root, lambda path, idx: make(snap.load_manifest_blob(path)["model"]),
        goldens=[[rows[0]]],
        config=mod.RolloutConfig(poll_interval=0.05, drain_timeout=5.0),
        journal=rec.RecoveryJournal(job_id="slice",
                                    dir=str(tmp_path / name / "journal")))
    srv.start()
    fe = mod.SocketFrontend(srv)
    out = []
    try:
        with mod.InferenceClient(fe.address) as cli:
            for version, arrays in enumerate(weights):
                if version:
                    ckpt.save({"model.pdparams": (arrays, "model")})
                    t0 = time.monotonic()
                    while rc.version != version or rc.active():
                        assert time.monotonic() - t0 < 60, rc.describe()
                        time.sleep(0.02)  # blocking-ok: poll interval, deadline above
                for r in rows:
                    [logits] = cli.infer([r], timeout=30.0)
                    out.append((cli.last_model_version, logits))
    finally:
        fe.close()
        srv.stop()
    events = [e["event"] for e in rc.journal.entries()]
    assert events == ["rollout_started", "rollout_canary_passed",
                      "rollout_completed"] * (len(weights) - 1), events
    return out


def test_slice_bert_served_and_rolled_matches_reference(tmp_path):
    weights = _slice_weights()
    rng = np.random.RandomState(5)
    rows = [rng.randint(0, SLICE_CFG["vocab_size"], (1, SLICE_SEQ))
            .astype("int64") for _ in range(3)]
    ref = served_and_rolled("paddle_tpu", tmp_path, weights, rows)
    port = served_and_rolled("paddle_tpu_torch", tmp_path, weights, rows)
    assert [v for v, _ in port] == [v for v, _ in ref] == \
        [None] * 3 + [1] * 3 + [2] * 3
    for (_, got), (_, want) in zip(port, ref):
        np.testing.assert_allclose(np.asarray(got, np.float32),
                                   np.asarray(want, np.float32), **SLICE_TOL)
    # the versions answer differently: the stamp is not decorative
    for i in range(6):
        assert not np.allclose(port[i][1], port[i + 3][1], **SLICE_TOL)
