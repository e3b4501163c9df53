"""Elastic training manager (port of
paddle_tpu/distributed/fleet/elastic.py).

Paddle's fleet/elastic/manager.py:125-240: nodes register in etcd with TTL
leases; the manager watches membership, rewrites PADDLE_TRAINER_ENDPOINTS
on scale-in/out, and relaunches trainers. etcd is a pluggable Store: the
default FileStore (a shared directory) keeps the TTL-lease semantics with
mtime heartbeats, in the reference's on-disk layout (one JSON file a key,
the key percent-encoded), so both packages read one store. Scale events
surface as ElasticStatus transitions; ``watch`` drives a relaunch loop.

The generation rendezvous (``rendezvous``) also tells
``distributed.env`` where the next process group forms: a
``torch.distributed.FileStore`` a generation under the FileStore's
directory (``_torch_pg/<job>``), which outlives any one rank.
"""
from __future__ import annotations

import json
import os
import threading
import time
from urllib.parse import quote

from ...resilience.faults import maybe_inject
from ...resilience.retry import retry_call
from .fs import ExecuteError

__all__ = ["ElasticStatus", "FileStore", "ElasticManager"]


def _encode_key(key):
    """Injective, prefix-preserving filename encoding. Percent-encoding
    every reserved byte per character means distinct keys can never map to
    the same filename ("job/node.1" vs a literal "job_node.1") and
    ``alive_values`` prefix matching on encoded names matches exactly the
    keys under the raw prefix."""
    return quote(key, safe="")


class ElasticStatus:
    COMPLETED = "completed"
    ERROR = "error"
    HOLD = "hold"      # waiting for np to settle
    RESTART = "restart"
    EXIT = "exit"


class FileStore:
    """TTL-lease key/value store over a shared directory."""

    def __init__(self, root, ttl=10.0):
        self.root = root
        self.ttl = ttl
        os.makedirs(root, exist_ok=True)

    def _path(self, key):
        return os.path.join(self.root, _encode_key(key))

    def put(self, key, value):
        maybe_inject("store.put", ExecuteError)
        # atomic: a reader that races the write must see the old value or
        # the new one, never a torn JSON prefix (os.replace is atomic on
        # POSIX; over NFS it is the best available approximation)
        p = self._path(key)
        # per thread too: managers of several ranks may share a process
        tmp = f"{p}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w") as f:
            json.dump(value, f)
        os.replace(tmp, p)

    def refresh(self, key):
        maybe_inject("store.heartbeat", ExecuteError)
        p = self._path(key)
        try:
            os.utime(p, None)
        except FileNotFoundError:
            pass

    def get(self, key):
        """None for missing, expired, deleted-mid-read, or torn values —
        a store hiccup must read as 'lease lapsed', not crash the
        heartbeat/watch loop."""
        p = self._path(key)
        try:
            if time.time() - os.path.getmtime(p) > self.ttl:
                return None  # lease expired
            with open(p) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def alive_values(self, prefix, ttl=None):
        """Values of all non-expired keys under prefix. Keys deleted between
        listdir and open, and torn writes, count as expired. ``ttl``
        overrides the store lease for this scan — quarantine markers live on
        FLAGS_quarantine_ttl, far past the node-lease TTL."""
        ttl = self.ttl if ttl is None else ttl
        out = []
        enc_prefix = _encode_key(prefix)
        for name in sorted(os.listdir(self.root)):
            if not name.startswith(enc_prefix) or ".tmp." in name:
                continue
            p = os.path.join(self.root, name)
            try:
                if time.time() - os.path.getmtime(p) <= ttl:
                    with open(p) as f:
                        out.append(json.load(f))
            except (FileNotFoundError, json.JSONDecodeError):
                continue
        return out

    def delete(self, key):
        """Idempotent: two ranks may race to clear the same key (e.g. both
        survivors wiping a dead rank's unhealthy marker) — losing the race
        must not raise."""
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def gc_tmp(self, max_age=None):
        """Garbage-collect orphaned ``*.tmp.<pid>`` staging files left by
        writers that died mid-``put``. Only files older than the TTL (or
        ``max_age``) are removed — a young tmp file may be an in-flight
        write about to be os.replace'd. Returns the removed names."""
        maybe_inject("store.gc", ExecuteError)
        max_age = self.ttl if max_age is None else max_age
        removed = []
        for name in os.listdir(self.root):
            if ".tmp." not in name:
                continue
            p = os.path.join(self.root, name)
            try:
                if time.time() - os.path.getmtime(p) > max_age:
                    os.remove(p)
                    removed.append(name)
            except FileNotFoundError:
                continue  # a concurrent gc (or the writer) won the race
        return removed


class ElasticManager:
    """manager.py:125 parity over a Store."""

    def __init__(self, store, job_id, np_min=1, np_max=None, rank=0,
                 endpoint="127.0.0.1:0", heartbeat_interval=1.0,
                 clock=None, sleep=None):
        self.store = store
        self.job_id = job_id
        self.np_min = np_min
        self.np_max = np_max or np_min
        self.rank = rank
        self.endpoint = endpoint
        self.heartbeat_interval = heartbeat_interval
        self._key = f"{job_id}/node.{rank}"
        self._registered = False
        self._last_np = None
        # HOLD is a latched state, not just a return value: recovering to
        # the SAME np as before the dip must still emit RESTART (the group
        # composition changed even if the count didn't)
        self._held = False
        # PADDLE_TPU_GENERATION (set by the launcher on a supervised
        # relaunch) is a FLOOR for rendezvous proposals only — never the
        # frame-stamping generation. A relaunched child whose launcher
        # counter ran ahead of the store-agreed generation then proposes
        # high at rendezvous (survivors converge up through the store)
        # instead of stamping frames above its peers' generation, which
        # would make healthy survivors latch themselves stale.
        self._generation = int(
            os.environ.get("PADDLE_TPU_GENERATION", "0") or 0)
        # injectable for fake-clock chaos tests (zero real sleeps)
        self._clock = clock
        self._sleep_fn = sleep

    def _now(self):
        return self._clock() if self._clock is not None else time.monotonic()

    def _sleep(self, dt):
        (self._sleep_fn or time.sleep)(dt)

    # -- registration / heartbeat ------------------------------------------
    def register(self):
        retry_call(self.store.put, self._key,
                   {"rank": self.rank, "endpoint": self.endpoint,
                    "ts": time.time()},
                   retry_on=(ExecuteError, OSError),
                   max_backoff=self.ttl_guard())
        self._registered = True
        self._last_np = self.np()
        # hang diagnostics: when the watchdog expires a section on this
        # rank, it writes an unhealthy.<rank> key so the manager (and every
        # peer) can name the stuck rank instead of just seeing a hang
        from ...resilience import watchdog as _watchdog
        _watchdog.set_health_marker(self.mark_unhealthy)

    def heartbeat(self):
        """Lease refresh with retry: a transient store hiccup (NFS blip, GCS
        5xx) must not let the TTL lapse and trigger a spurious scale-in."""
        if not self._registered:
            self.register()
        retry_call(self.store.refresh, self._key,
                   retry_on=(ExecuteError, OSError),
                   max_backoff=self.ttl_guard())

    def ttl_guard(self):
        """Cap a single retry backoff below the lease TTL so the retry loop
        itself cannot expire the lease it is trying to keep alive."""
        ttl = getattr(self.store, "ttl", None)
        return max(float(ttl) / 4.0, 0.25) if ttl else 2.0

    def exit(self):
        if self._registered:
            self.store.delete(self._key)
            self._registered = False

    # -- health ------------------------------------------------------------
    def mark_unhealthy(self, section="", info=None):
        """Record this rank as unhealthy (watchdog expiry, hang detection).
        Best-effort: the marker runs on the failure path and must never
        mask the original diagnosis."""
        payload = {"rank": self.rank, "endpoint": self.endpoint,
                   "section": section, "ts": time.time()}
        payload.update(info or {})
        try:
            self.store.put(f"{self.job_id}/unhealthy.{self.rank}", payload)
        except Exception:
            pass

    def unhealthy_nodes(self):
        return self.store.alive_values(f"{self.job_id}/unhealthy.")

    def quarantine_ttl(self):
        from ...framework.flags import get_flag
        return float(get_flag("FLAGS_quarantine_ttl", 3600.0) or 3600.0)

    def mark_quarantined(self, reason="", info=None):
        """Record a durable health verdict against this rank (failed
        preflight KAT, named by SDC consensus, opt-in straggler).

        A TTL'd superset of ``mark_unhealthy``: unhealthy markers are wiped
        when a new group forms, but a quarantine marker *survives*
        re-rendezvous — the rank stays excluded until the marker ages past
        ``FLAGS_quarantine_ttl`` (a repaired/replaced host rejoins then).
        Written with retry: this is the one store write whose loss readmits
        a known-bad host."""
        payload = {"rank": self.rank, "endpoint": self.endpoint,
                   "reason": reason, "ts": time.time()}
        payload.update(info or {})
        retry_call(self.store.put,
                   f"{self.job_id}/quarantined.{self.rank}", payload,
                   retry_on=(ExecuteError, OSError),
                   max_backoff=self.ttl_guard())

    def quarantined_nodes(self):
        prefix = f"{self.job_id}/quarantined."
        try:
            return self.store.alive_values(prefix, ttl=self.quarantine_ttl())
        except TypeError:
            # a custom store without the per-scan ttl override: quarantine
            # then lives on the store's own lease
            return self.store.alive_values(prefix)

    def is_quarantined(self, rank=None):
        rank = self.rank if rank is None else int(rank)
        return any(int(q.get("rank", -1)) == rank
                   for q in self.quarantined_nodes())

    # -- membership --------------------------------------------------------
    def alive_nodes(self):
        return self.store.alive_values(f"{self.job_id}/node.")

    def np(self):
        return len(self.alive_nodes())

    def endpoints(self):
        nodes = sorted(self.alive_nodes(), key=lambda v: v["rank"])
        return [v["endpoint"] for v in nodes]

    # -- watch loop --------------------------------------------------------
    def _transition(self, cur):
        """Shared HOLD/RESTART/ok state machine for poll() and watch().

        HOLD latches: while below np_min the count keeps tracking (so a
        recovery to the SAME np as before the dip is still a membership
        change), and the first poll back at/above np_min emits RESTART
        unconditionally.
        """
        if cur < self.np_min:
            self._held = True
            self._last_np = cur
            return ElasticStatus.HOLD
        if self._held:
            self._held = False
            self._last_np = cur
            return ElasticStatus.RESTART
        if self._last_np is not None and cur != self._last_np:
            self._last_np = cur
            return ElasticStatus.RESTART
        self._last_np = cur
        return "ok"

    def poll(self):
        """One membership check → HOLD (below np_min) / RESTART (membership
        changed) / "ok" (steady state). manager.py watch-step parity."""
        self.heartbeat()
        return self._transition(self.np())

    def watch(self, until=None, on_restart=None):
        """Heartbeat + watch membership until `until()` returns True.
        Calls on_restart(new_np) on scale events; returns final status.

        Each iteration runs under a watchdog section: a store that blocks
        (NFS stall, GCS outage) dumps diagnostics and fails this loop with
        DistributedTimeout instead of silently wedging the relaunch logic.
        """
        from ...resilience.watchdog import watch_section
        while True:
            with watch_section("elastic.watch"):
                self.heartbeat()
                cur = self.np()
            if self._transition(cur) == ElasticStatus.RESTART:
                if on_restart:
                    on_restart(cur)
                return ElasticStatus.RESTART
            if until and until():
                return ElasticStatus.COMPLETED
            self._sleep(self.heartbeat_interval)

    # -- generation-fenced rendezvous --------------------------------------
    def _gen_key(self):
        return f"{self.job_id}/gen"

    def announce(self, gen):
        """Publish this rank's arrival at generation ``gen`` (TTL-leased
        like the node key, so a rank that dies mid-rendezvous ages out)."""
        self.store.put(
            f"{self.job_id}/rdzv.{gen}/rank.{self.rank}",
            {"rank": self.rank, "endpoint": self.endpoint,
             "gen": int(gen), "ts": time.time()})

    def rendezvous(self, timeout=None, poll_interval=None):
        """Agree on the next collective generation through the store and
        gather the new group. Returns ``(generation, endpoints)`` with
        endpoints sorted by rank.

        A participant joins the stored generation when it is a round still
        open (proposed, its group not yet gathered) above every generation
        it has seen; otherwise it proposes ``max(stored, last seen) + 1``.
        It adopts the highest proposal it observes, so concurrent survivors
        converge on one generation, and ranks that arrive one after the
        other (a survivor, then a relaunched replacement) meet at one
        generation above the last gathered round, whichever comes first.
        A gathered round is marked closed in the store (an extra key the
        reference's readers ignore). The wait runs until ``np_max`` ranks
        arrive; at ``timeout`` it proceeds scaled-in if at least ``np_min``
        arrived (the caller reshards via ``load_hybrid_checkpoint`` /
        ``reshard_model``), else raises ``RendezvousTimeout``.
        """
        maybe_inject("recovery.rendezvous", ExecuteError)
        from ...resilience.recovery import RendezvousTimeout, set_generation
        if timeout is None:
            from ...framework.flags import get_flag
            timeout = float(get_flag("FLAGS_recovery_rendezvous_timeout",
                                     300.0))
        interval = poll_interval if poll_interval is not None \
            else min(self.heartbeat_interval, 1.0)
        if hasattr(self.store, "gc_tmp"):
            try:
                self.store.gc_tmp()
            except Exception:
                pass  # housekeeping must never block recovery
        if not self._registered:
            self.register()
        # a rank that reached rendezvous is alive: clear its own stale
        # unhealthy marker so the new group doesn't re-diagnose old news
        self.store.delete(f"{self.job_id}/unhealthy.{self.rank}")
        # quarantine is the opposite: durable. A rank that failed its KAT
        # or was named by SDC consensus must not talk its way back into the
        # group just by showing up — it exits (SystemExit 117) and stays
        # out until its marker ages past FLAGS_quarantine_ttl.
        mine = [q for q in self.quarantined_nodes()
                if int(q.get("rank", -1)) == self.rank]
        if mine:
            from ...resilience.health import Quarantined
            raise Quarantined(self.rank,
                              reason=mine[0].get("reason", "")
                              or "quarantined marker present at rendezvous")
        rec = self.store.get(self._gen_key()) or {}
        stored = int(rec.get("gen", 0))
        if stored > self._generation and not rec.get("closed"):
            gen = stored  # an open round above ours: join it
        else:
            gen = max(stored, self._generation) + 1
            self.store.put(self._gen_key(), {"gen": gen})
        start = self._now()
        while True:
            rec = self.store.get(self._gen_key()) or {}
            stored = int(rec.get("gen", 0))
            if stored > gen:
                gen = stored
            elif stored < gen:
                # a slow proposer's read-then-put can regress the agreed key
                # after others already adopted a higher generation; ranks at
                # the higher generation would otherwise never re-publish, so
                # subgroups could settle at different generations and EACH
                # proceed scaled-in at np_min — split-brain. Re-publish the
                # maximum until the store converges.
                self.store.put(self._gen_key(), {"gen": gen})
            # re-announce every poll: the arrival record is TTL-leased, and
            # with real settings (ttl << rendezvous timeout) a waiting
            # rank's record would age out mid-wait, undercounting the group
            # exactly when the scaled-in np_min decision needs it
            self.announce(gen)
            # re-read quarantine each poll: a rank can be condemned while
            # we wait, and counting it toward np_max/np_min would let a
            # known-bad host back into the agreed group
            bad = {int(q.get("rank", -1)) for q in self.quarantined_nodes()}
            arrived = [a for a in
                       self.store.alive_values(f"{self.job_id}/rdzv.{gen}/")
                       if int(a.get("rank", -1)) not in bad]
            if len(arrived) >= self.np_max:
                break
            if self._now() - start >= timeout:
                if len(arrived) >= self.np_min:
                    break  # proceed scaled-in at the ranks that showed up
                raise RendezvousTimeout(gen, len(arrived), self.np_min,
                                        timeout)
            self.heartbeat()
            self._sleep(interval)
        rec = self.store.get(self._gen_key()) or {}
        if int(rec.get("gen", 0)) <= gen:
            self.store.put(self._gen_key(), {"gen": gen, "closed": True})
        # the agreed group starts with a clean bill of health: markers from
        # the dead incarnation would otherwise re-trigger recovery until
        # their TTL lapses (delete is idempotent — every survivor may wipe).
        # quarantined.<rank> markers are deliberately NOT wiped — they must
        # outlive the re-rendezvous they caused.
        for u in self.unhealthy_nodes():
            self.store.delete(f"{self.job_id}/unhealthy.{u.get('rank')}")
        self._generation = gen
        self._last_np = len(arrived)
        self._held = False
        set_generation(gen)
        root = getattr(self.store, "root", None)
        if root is not None:
            from .. import env
            env.set_rendezvous(gen, os.path.join(
                root, "_torch_pg", _encode_key(self.job_id)))
        nodes = sorted(arrived, key=lambda v: v["rank"])
        return gen, [v["endpoint"] for v in nodes]
