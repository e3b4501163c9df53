"""Launcher topology + process management (port of
paddle_tpu/distributed/launch_utils.py).

Paddle's fleet/launch_utils.py: Cluster/Pod/Trainer topology
(launch_utils.py:62, 272), free-port picking, start_local_trainers (:468),
watch_local_trainers (:578), and the supervised relaunch of a failed rank.
The unit of launch is one process per rank (``--nproc_per_node`` of them
on this host), each with the reference's environment contract:
PADDLE_TRAINER_ID, PADDLE_CURRENT_ENDPOINT, PADDLE_TRAINERS_NUM,
PADDLE_TRAINER_ENDPOINTS, and PADDLE_COORDINATOR_ADDR (rank 0's endpoint),
which ``distributed.env.init_parallel_env`` reads.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

from ..framework.errors import FatalError

__all__ = ["Trainer", "Pod", "Cluster", "find_free_ports",
           "get_cluster", "get_cluster_from_args", "start_local_trainers",
           "watch_local_trainers", "supervise_local_trainers",
           "terminate_local_procs", "TrainerProc"]


class Trainer:
    def __init__(self, rank, endpoint, accelerators=None):
        self.rank = rank
        self.endpoint = endpoint
        self.accelerators = accelerators or []

    def __str__(self):
        return f"Trainer(rank={self.rank}, endpoint={self.endpoint})"


class Pod:
    """One node's worth of trainers (launch_utils.py:272)."""

    def __init__(self, idx, addr):
        self.rank = idx
        self.addr = addr
        self.trainers = []

    def trainers_num(self):
        return len(self.trainers)

    def get_visible_accelerators(self):
        return ",".join(str(a) for t in self.trainers
                        for a in t.accelerators)


class Cluster:
    def __init__(self):
        self.pods = []
        self.job_server = None

    def trainers_nranks(self):
        return sum(p.trainers_num() for p in self.pods)

    def trainers_endpoints(self):
        return [t.endpoint for p in self.pods for t in p.trainers]

    def pods_endpoints(self):
        return [p.addr for p in self.pods]

    def get_pod_by_id(self, idx):
        for p in self.pods:
            if p.rank == idx:
                return p
        return None

    def __str__(self):
        return (f"Cluster(nranks={self.trainers_nranks()}, "
                f"endpoints={self.trainers_endpoints()})")


def find_free_ports(num):
    """Reserve `num` distinct free TCP ports on localhost."""
    socks, ports = [], []
    try:
        for _ in range(num):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", 0))
            socks.append(s)
            ports.append(s.getsockname()[1])
    finally:
        for s in socks:
            s.close()
    return ports


def get_cluster(node_ips, node_ip, trainer_endpoints, accelerators_per_proc):
    """launch_utils.py:62 get_cluster parity."""
    cluster = Cluster()
    rank = 0
    for pod_idx, ip in enumerate(node_ips):
        pod = Pod(pod_idx, ip)
        for local_idx, ep in enumerate(trainer_endpoints[pod_idx]):
            accel = accelerators_per_proc[local_idx] \
                if local_idx < len(accelerators_per_proc) else []
            pod.trainers.append(Trainer(rank, ep, accel))
            rank += 1
        cluster.pods.append(pod)
    pod = cluster.get_pod_by_id(node_ips.index(node_ip))
    return cluster, pod


def get_cluster_from_args(ips="127.0.0.1", nproc_per_node=1,
                          current_ip=None, start_port=None):
    node_ips = [ip.strip() for ip in ips.split(",") if ip.strip()]
    current_ip = current_ip or node_ips[0]
    eps = []
    if len(node_ips) == 1 and start_port is None:
        # single node: random free ports (reference launch_utils free-port
        # picking) — safe because no other host needs to predict them
        ports_per_node = [find_free_ports(nproc_per_node)]
    else:
        # multi-node: the endpoint table must be IDENTICAL on every host, so
        # ports are deterministic (start_port, default 6070) — free-port
        # randomness would desync PADDLE_TRAINER_ENDPOINTS across hosts
        base = start_port or 6070
        ports_per_node = [[base + i for i in range(nproc_per_node)]
                          for _ in node_ips]
    for ip, ports in zip(node_ips, ports_per_node):
        eps.append([f"{ip}:{p}" for p in ports])
    accel = [[i] for i in range(nproc_per_node)]
    return get_cluster(node_ips, current_ip, eps, accel)


class TrainerProc:
    def __init__(self, proc, rank, log_fn, cmd):
        self.proc = proc
        self.rank = rank
        self.log_fn = log_fn
        self.cmd = cmd


def _trainer_env(cluster, pod, trainer, extra_env=None):
    eps = cluster.trainers_endpoints()
    env = dict(os.environ)
    env.update({
        "PADDLE_TRAINER_ID": str(trainer.rank),
        "PADDLE_CURRENT_ENDPOINT": trainer.endpoint,
        "PADDLE_TRAINERS_NUM": str(cluster.trainers_nranks()),
        "PADDLE_TRAINER_ENDPOINTS": ",".join(eps),
        # the process group's coordinator (read by init_parallel_env)
        "PADDLE_COORDINATOR_ADDR": eps[0],
        "JAX_PROCESS_ID": str(trainer.rank),
        "JAX_NUM_PROCESSES": str(cluster.trainers_nranks()),
        # reference env contract for spawned trainers (launch_utils.py:470
        # parity), not a registry flag — flag-ok: env name, not a read
        "FLAGS_selected_accelerators": ",".join(
            str(a) for a in trainer.accelerators),
    })
    env.update(extra_env or {})
    return env


def _launch_one(cluster, pod, trainer, idx, training_script,
                training_script_args=(), log_dir=None, envs=None,
                generation=0):
    """Spawn one trainer subprocess. `generation` > 0 marks a supervised
    RELAUNCH: PADDLE_TPU_GENERATION seeds the child's ElasticManager as a
    FLOOR for its rendezvous proposals, so it proposes a generation above
    every incarnation the launcher has seen and converges with the
    survivors through the store. It is NOT the child's frame-stamping
    generation, which is only adopted from an agreed rendezvous."""
    env = _trainer_env(cluster, pod, trainer, envs)
    if generation:
        env["PADDLE_TPU_GENERATION"] = str(int(generation))
    cmd = [sys.executable, "-u", training_script,
           *map(str, training_script_args)]
    fn = None
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        fn = open(os.path.join(log_dir, f"workerlog.{idx}"), "a")
    proc = subprocess.Popen(cmd, env=env, stdout=fn or None,
                            stderr=subprocess.STDOUT if fn else None)
    return TrainerProc(proc, trainer.rank, fn, cmd)


def start_local_trainers(cluster, pod, training_script,
                         training_script_args=(), log_dir=None,
                         envs=None):
    """launch_utils.py:468 parity: one subprocess per local trainer with the
    rank env set; stdout/err tee'd to log_dir/workerlog.N."""
    return [_launch_one(cluster, pod, t, idx, training_script,
                        training_script_args, log_dir=log_dir, envs=envs)
            for idx, t in enumerate(pod.trainers)]


def terminate_local_procs(procs, timeout=15):
    for tp in procs:
        if tp.proc.poll() is None:
            tp.proc.terminate()
    deadline = time.time() + timeout
    for tp in procs:
        if tp.proc.poll() is None:
            try:
                tp.proc.wait(max(deadline - time.time(), 0.1))
            except subprocess.TimeoutExpired:
                tp.proc.kill()
        if tp.log_fn:
            tp.log_fn.close()
            tp.log_fn = None


def _flight_recorder_hint(rank, n=3):
    """Tail of the failed rank's flight-recorder dump (if it left one in the
    artifacts dir), so the launcher's error names the suspect collective.
    Full cross-rank diagnosis: tools/flight_recorder_diff.py <artifacts>."""
    import json
    try:
        from ..resilience.recorder import dump_path_for_rank
        with open(dump_path_for_rank(rank)) as f:
            data = json.load(f)
    except (ImportError, OSError, ValueError):
        return ""
    entries = data.get("entries", [])[-n:]
    if not entries:
        return ""
    ops = ", ".join(f"{e.get('op')}#{e.get('seq')}[{e.get('status')}]"
                    for e in entries)
    return (f" | rank {rank} flight recorder tail ({data.get('reason')}): "
            f"{ops} — run tools/flight_recorder_diff.py on the artifacts "
            "dir to find the first divergent collective")


def supervise_local_trainers(cluster, pod, training_script,
                             training_script_args=(), log_dir=None,
                             envs=None, max_restarts=None,
                             poll_interval=0.5, journal=None, sleep=None):
    """Supervised relaunch loop: restart ONLY failed workers.

    Paddle's elastic manager relaunches the whole local pod on any
    failure; here a worker that exits non-zero is relaunched in place (same
    rank, same endpoint) with ``PADDLE_TPU_GENERATION`` bumped — a floor
    for the replacement's rendezvous proposals — so it joins the
    survivors' re-rendezvoused group rather than forcing a full-job
    teardown. Every restart's cause — exit code, the failed rank's
    flight-recorder tail, the generation handed to the replacement — is
    recorded in the per-job recovery journal (``PADDLE_TPU_ARTIFACTS_DIR``).
    When the shared restart budget (default ``FLAGS_recovery_max_restarts``)
    is spent, the remaining workers are terminated and the journal records
    the exhaustion. A worker that exits with the quarantine code (117 —
    failed preflight KAT or named by SDC consensus) is terminal for its
    rank: journaled, not relaunched, and not charged to the restart budget.
    Returns per-rank exit codes once every rank exited (0 or quarantined).
    """
    if max_restarts is None:
        from ..framework.flags import get_flag
        max_restarts = int(get_flag("FLAGS_recovery_max_restarts", 3))
    if journal is None:
        from ..resilience.recovery import get_journal
        journal = get_journal()
    _sleep = sleep or time.sleep
    generation = int(os.environ.get("PADDLE_TPU_GENERATION", "0") or 0)
    procs = []
    slots = {}  # rank -> (trainer, local idx) for in-place relaunch
    for idx, t in enumerate(pod.trainers):
        procs.append(_launch_one(cluster, pod, t, idx, training_script,
                                 training_script_args, log_dir=log_dir,
                                 envs=envs))
        slots[t.rank] = (t, idx)
    alive = list(procs)
    codes = {}
    restarts = 0
    try:
        while alive:
            for tp in list(alive):
                ret = tp.proc.poll()
                if ret is None:
                    continue
                alive.remove(tp)
                if tp.log_fn:
                    tp.log_fn.close()
                    tp.log_fn = None
                if ret == 0:
                    codes[tp.rank] = 0
                    continue
                from ..resilience.health import QUARANTINE_EXIT_CODE
                if ret == QUARANTINE_EXIT_CODE:
                    # the worker condemned its own hardware (failed KAT /
                    # named by SDC consensus): relaunching on the same host
                    # would just fail the next preflight, so the rank stays
                    # down — without burning the restart budget the healthy
                    # ranks may still need — and the survivors' rendezvous
                    # proceeds scaled-in without it
                    codes[tp.rank] = ret
                    journal.record("quarantined", rank=tp.rank, code=ret,
                                   cause="worker exited quarantined "
                                         f"(code {ret}); not relaunching")
                    continue
                restarts += 1
                hint = _flight_recorder_hint(tp.rank)
                if restarts > max_restarts:
                    journal.record("recovery_exhausted", rank=tp.rank,
                                   code=ret, restarts=restarts - 1,
                                   cause=f"exit code {ret}{hint}")
                    raise FatalError(
                        f"trainer rank {tp.rank} exited with code {ret} "
                        f"and the restart budget ({max_restarts}) is spent"
                        f"{hint} | recovery journal: {journal.path}")
                generation += 1
                journal.record("worker_restart", rank=tp.rank, code=ret,
                               restart=restarts, generation=generation,
                               cause=f"exit code {ret}{hint}")
                t, idx = slots[tp.rank]
                ntp = _launch_one(cluster, pod, t, idx, training_script,
                                  training_script_args, log_dir=log_dir,
                                  envs=envs, generation=generation)
                procs.append(ntp)
                alive.append(ntp)
            if alive:
                _sleep(poll_interval)
    except (RuntimeError, KeyboardInterrupt):
        terminate_local_procs(procs)
        raise
    return [codes[t.rank] for t in pod.trainers]


def watch_local_trainers(procs, nranks=None, poll_interval=0.5):
    """launch_utils.py:578 parity: block until all trainers exit cleanly or
    one fails (then terminate the rest). Returns the list of exit codes."""
    alive = list(procs)
    try:
        while alive:
            for tp in list(alive):
                ret = tp.proc.poll()
                if ret is None:
                    continue
                alive.remove(tp)
                if ret != 0:
                    raise FatalError(
                        f"trainer rank {tp.rank} exited with code {ret} "
                        f"(cmd: {' '.join(tp.cmd)})"
                        f"{_flight_recorder_hint(tp.rank)}")
            time.sleep(poll_interval)
    except (RuntimeError, KeyboardInterrupt):
        terminate_local_procs(procs)
        raise
    for tp in procs:
        if tp.log_fn:
            tp.log_fn.close()
            tp.log_fn = None
    return [tp.proc.returncode for tp in procs]
