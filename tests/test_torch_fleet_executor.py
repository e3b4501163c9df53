"""FleetExecutor of the PyTorch/CUDA port against the JAX reference (the
cases of the reference's tests/test_fleet_executor.py): each graph runs
through both packages' executors on the same feeds and the outputs, the
calls and the flow control are compared: a three-stage pipeline, the
credit protocol's backpressure, a diamond graph, a timeout, an actor's
error, a second run, and messages routed to another process over TCP
(numpy and torch payloads, a client of each package against a bus of
the other)."""
import time

import numpy as np
import pytest
import torch

import paddle_tpu.distributed.fleet_executor as rfe

import paddle_tpu_torch.distributed.fleet_executor as pfe
from paddle_tpu_torch.distributed.launch_utils import find_free_ports
from paddle_tpu_torch.framework.errors import FatalError

PKGS = {"ref": rfe, "port": pfe}


def _chain(mod, fns, buffer_size=2):
    nodes = [mod.TaskNode(name, fn=fn, buffer_size=buffer_size)
             for name, fn in fns]
    for a, b in zip(nodes, nodes[1:]):
        a.add_downstream_task(b.task_id)
        b.add_upstream_task(a.task_id)
    return nodes


def test_three_stage_pipeline_dataflow_equals_the_reference():
    out = {}
    for name, mod in PKGS.items():
        calls = {"s1": 0, "s2": 0, "s3": 0}

        def stage(n, f, calls=calls):
            def fn(x):
                calls[n] += 1
                return f(x)
            return fn
        nodes = _chain(mod, [("s1", stage("s1", lambda x: x + 1)),
                             ("s2", stage("s2", lambda x: x * 2)),
                             ("s3", stage("s3", lambda x: x - 3))])
        res = mod.FleetExecutor(nodes).run([1, 2, 3, 4], timeout=30)
        out[name] = (sorted(res), calls)
    assert out["port"] == out["ref"]
    assert out["port"][0] == sorted(((np.array([1, 2, 3, 4]) + 1) * 2
                                     - 3).tolist())
    assert out["port"][1] == {"s1": 4, "s2": 4, "s3": 4}


def test_micro_batches_keep_their_order_through_a_chain():
    for mod in PKGS.values():
        nodes = _chain(mod, [("a", lambda x: x * 3), ("b", lambda x: x + 1)])
        assert mod.FleetExecutor(nodes).run(list(range(6))) == \
            [3 * i + 1 for i in range(6)]


@pytest.mark.parametrize("buffer_size", [1, 2])
def test_backpressure_bounds_the_producer(buffer_size):
    """A slow consumer holds the fast producer to buffer_size payloads in
    flight (+1 running), in both packages."""
    out = {}
    for name, mod in PKGS.items():
        inflight = {"max": 0, "cur": 0}

        def produce(x, inflight=inflight):
            inflight["cur"] += 1
            inflight["max"] = max(inflight["max"], inflight["cur"])
            return x

        def consume(x, inflight=inflight):
            # blocking-ok: the slow consumer is the fixture
            time.sleep(0.02)
            inflight["cur"] -= 1
            return x
        nodes = _chain(mod, [("p", produce), ("c", consume)],
                       buffer_size=buffer_size)
        res = mod.FleetExecutor(nodes).run(list(range(8)), timeout=30)
        out[name] = (sorted(res), inflight["max"] <= buffer_size + 1)
    assert out["port"] == out["ref"] == (list(range(8)), True)


def test_diamond_dag_joins_inputs():
    out = {}
    for name, mod in PKGS.items():
        ta = mod.TaskNode("a", fn=lambda x: x + 1)
        tb = mod.TaskNode("b", fn=lambda x: x * 10)
        tc = mod.TaskNode("c", fn=lambda d: d["a"] + d["b"])
        ta.add_downstream_task("c")
        tb.add_downstream_task("c")
        tc.add_upstream_task("a")
        tc.add_upstream_task("b")
        out[name] = sorted(mod.FleetExecutor([ta, tb, tc]).run([1, 2],
                                                               timeout=30))
    assert out["port"] == out["ref"] == [12, 23]


def test_timeout_raises():
    for mod in PKGS.values():
        t1 = mod.TaskNode("blocked", fn=lambda x: x)
        t1.add_upstream_task("never")
        t2 = mod.TaskNode("never", fn=lambda x: x)
        t2.add_downstream_task("blocked")
        t2.add_upstream_task("ghost")   # an upstream that never fires
        fe = mod.FleetExecutor([t1, t2])
        ghost = mod.TaskNode("ghost")
        fe.carrier.add_interceptor(
            mod.ComputeInterceptor("ghost", ghost, fe.carrier))
        fe.carrier._all_tasks.discard("ghost")
        with pytest.raises(TimeoutError, match="did not finish"):
            fe.run([1], timeout=0.5)


def test_an_actor_error_surfaces_from_run():
    def bad(x):
        raise ValueError(f"stage failed on {x}")
    for mod in PKGS.values():
        nodes = _chain(mod, [("ok", lambda x: x), ("bad", bad)])
        with pytest.raises(Exception, match="stage failed") as info:
            mod.FleetExecutor(nodes).run([1], timeout=30)
        assert type(info.value).__name__ == "FatalError"
    with pytest.raises(FatalError):
        pfe.FleetExecutor(_chain(pfe, [("bad", bad)])).run([1], timeout=30)


def test_run_twice():
    for mod in PKGS.values():
        fe = mod.FleetExecutor([mod.TaskNode("inc", fn=lambda x: x + 1)])
        assert sorted(fe.run([1, 2, 3])) == [2, 3, 4]
        assert sorted(fe.run([10, 20])) == [11, 21]


def test_torch_payloads_pass_in_the_process_as_they_are():
    x = torch.arange(6.0).reshape(2, 3)
    nodes = _chain(pfe, [("a", lambda t: t * 2), ("b", lambda t: t + 1)])
    (out,) = pfe.FleetExecutor(nodes).run([x])
    assert torch.equal(out, x * 2 + 1)


def _receiver(mod, rank, task, addr):
    bus = mod.MessageBus(rank=rank)
    carrier = mod.Carrier(rank=rank, message_bus=bus)
    got = []

    class Recorder(mod.ComputeInterceptor):
        def handle(self, msg):
            if msg["message_type"] == "DATA_IS_READY":
                got.append(msg["payload"])
                self.carrier.notify_task_done(self.node.task_id)

    rec = Recorder(task, mod.TaskNode(task, rank=rank, max_run_times=1),
                   carrier)
    carrier.add_interceptor(rec)
    bus.serve(addr)
    rec.start()
    return bus, carrier, rec, got


@pytest.mark.parametrize("sender,receiver,payload", [
    (s, r, p) for s, r in (("port", "port"), ("ref", "port"),
                           ("port", "ref"))
    for p in ("dict", "numpy", "torch") if not (s == "ref" and p == "torch")])
def test_tcp_routing_between_processes(sender, receiver, payload):
    """A torch tensor crosses as its ndarray (the reference's bus sends
    none)."""
    port = find_free_ports(1)[0]
    addr = f"127.0.0.1:{port}"
    smod, rmod = PKGS[sender], PKGS[receiver]
    bus_b, carrier_b, rec, got = _receiver(rmod, 1, "recv_task", addr)
    value = {"dict": {"x": 42, "y": [1.5, "a"]},
             "numpy": np.arange(6, dtype=np.float32).reshape(2, 3),
             "torch": torch.arange(6, dtype=torch.float32).reshape(2, 3)
             }[payload]
    try:
        bus_a = smod.MessageBus(rank=0, addr_table={1: addr})
        bus_a.route("recv_task", 1)
        bus_a.send(smod.InterceptorMessage.make(
            "src", "recv_task", "DATA_IS_READY", value))
        carrier_b.wait(timeout=10)
    finally:
        bus_b.shutdown()
        rec.enqueue(rmod.InterceptorMessage.make(-1, "recv_task", "STOP"))
    if payload == "dict":
        assert got == [{"x": 42, "y": [1.5, "a"]}]
    else:
        assert isinstance(got[0], np.ndarray)
        np.testing.assert_array_equal(got[0], np.arange(6).reshape(2, 3))


def test_two_executors_route_a_pipeline_across_ranks():
    """Stage a on rank 0, stage b on rank 1 (its own bus and carrier, as
    another process would hold), micro-batches flowing over TCP both
    ways: DATA_IS_READY forward, DATA_IS_USELESS back."""
    p0, p1 = find_free_ports(2)
    table = {0: f"127.0.0.1:{p0}", 1: f"127.0.0.1:{p1}"}
    a = pfe.TaskNode("a", rank=0, fn=lambda x: x + 1)
    b = pfe.TaskNode("b", rank=1, fn=lambda x: x * 10)
    a.add_downstream_task("b")
    b.add_upstream_task("a")
    # rank 1: b's interceptor, its results sent back to rank 0's sink
    bus1 = pfe.MessageBus(rank=1, addr_table=table)
    carrier1 = pfe.Carrier(rank=1, message_bus=bus1)
    b.add_downstream_task("__sink__")
    b.max_run_times = 3
    carrier1.add_interceptor(pfe.ComputeInterceptor("b", b, carrier1))
    bus1.route("a", 0)
    bus1.route("__sink__", 0)
    bus1.serve(table[1])
    carrier1.start()
    fe = pfe.FleetExecutor([a, b], rank=0, addr_table=table)
    fe.carrier.bus.serve(table[0])
    try:
        out = fe.run([1, 2, 3], timeout=30)
        carrier1.wait(timeout=10)
    finally:
        carrier1.stop()
        bus1.shutdown()
    assert sorted(out) == [20, 30, 40]
