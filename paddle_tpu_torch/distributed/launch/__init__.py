"""`python -m paddle_tpu_torch.distributed.launch`: the multi-process job
launcher (port of paddle_tpu/distributed/launch/__init__.py).

Paddle's fleet/launch.py:456 (collective mode :281): builds the cluster
topology from the arguments, starts one trainer process a rank with the
rank environment, watches them, and either relaunches the whole job
(``--elastic_retries``) or only a failed rank (``--max_restarts``, with
PADDLE_TPU_GENERATION bumped and each restart journalled). A single
launcher injects one generated PADDLE_TPU_WIRE_SECRET into every trainer
(unless one is set), so the p2p frames carry an HMAC. The trainers run on
the card; ``--cpu_sim`` hides the cards from them (CUDA_VISIBLE_DEVICES
empty), so each runs on the host over gloo.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from ..launch_utils import (
    get_cluster_from_args, start_local_trainers, supervise_local_trainers,
    terminate_local_procs, watch_local_trainers,
)

__all__ = ["launch", "main"]


def _parse_args(argv):
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="launch a multi-process (per-host) distributed job")
    p.add_argument("--ips", type=str, default="127.0.0.1",
                   help="comma-separated host ips (reference --ips)")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="processes (ranks) per node")
    p.add_argument("--log_dir", type=str, default=None,
                   help="per-rank workerlog.N directory")
    p.add_argument("--start_port", type=int, default=None)
    p.add_argument("--elastic_retries", type=int, default=0,
                   help="whole-job relaunch attempts on failure "
                        "(elastic-lite)")
    p.add_argument("--max_restarts", type=int, default=0,
                   help="per-worker supervised restarts: relaunch ONLY the "
                        "failed rank (with PADDLE_TPU_GENERATION bumped) "
                        "instead of tearing down the job; restart causes "
                        "land in the recovery journal")
    p.add_argument("--cpu_sim", action="store_true",
                   help="run the trainers on the host: hide the cards "
                        "from them (CUDA_VISIBLE_DEVICES empty)")
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def launch(argv=None):
    args = _parse_args(argv if argv is not None else sys.argv[1:])
    attempts = args.elastic_retries + 1
    last_err = None
    # wire-channel authentication: a job whose ranks this launcher owns
    # gets one generated HMAC secret injected into every trainer unless the
    # operator set one (an empty string counts as unset, as in wire.py)
    wire_secret = os.environ.get("PADDLE_TPU_WIRE_SECRET") or None
    # multi-host = more than one ip: with a single ip (loopback OR a real
    # address) this launcher owns every rank and one generated secret
    # reaches them all through the child env
    multi_host = len([ip for ip in args.ips.split(",") if ip.strip()]) > 1
    if wire_secret is None:
        if multi_host:
            # can't auto-generate here: each host runs its own launcher and
            # independently generated secrets would reject each other's
            # frames — the operator must distribute one
            print("[launch] WARNING: multi-host job without "
                  "PADDLE_TPU_WIRE_SECRET — p2p/PS wire frames run "
                  "unauthenticated. Set the same secret on every host.",
                  file=sys.stderr)
        else:
            # single launcher owns every rank: children inherit one secret
            import secrets
            wire_secret = secrets.token_hex(32)
    for attempt in range(attempts):
        cluster, pod = get_cluster_from_args(
            ips=args.ips, nproc_per_node=args.nproc_per_node,
            start_port=args.start_port)
        envs = {}
        if wire_secret is not None:
            envs["PADDLE_TPU_WIRE_SECRET"] = wire_secret
        if args.cpu_sim:
            envs["CUDA_VISIBLE_DEVICES"] = ""
        if args.max_restarts > 0:
            # supervised mode: per-worker relaunch inside one job attempt;
            # --elastic_retries still wraps it for whole-job do-overs
            try:
                return supervise_local_trainers(
                    cluster, pod, args.training_script,
                    args.training_script_args, log_dir=args.log_dir,
                    envs=envs, max_restarts=args.max_restarts)
            except RuntimeError as e:
                last_err = e
                if attempt + 1 < attempts:
                    print(f"[launch] attempt {attempt + 1} failed ({e}); "
                          f"relaunching", file=sys.stderr)
                    time.sleep(1.0)
                continue
        procs = start_local_trainers(
            cluster, pod, args.training_script,
            args.training_script_args, log_dir=args.log_dir, envs=envs)
        try:
            codes = watch_local_trainers(procs)
            return codes
        except RuntimeError as e:
            last_err = e
            if attempt + 1 < attempts:
                print(f"[launch] attempt {attempt + 1} failed ({e}); "
                      f"relaunching", file=sys.stderr)
                time.sleep(1.0)
            continue
        except KeyboardInterrupt:
            terminate_local_procs(procs)
            raise
    raise last_err


def main():
    launch()
