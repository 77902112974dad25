"""Self-healing control plane: the FleetSupervisor.

The FleetRouter is deliberately REACTIVE: its watchdog detects death
(stale heartbeats, wedges, socket EOF), remigrates in-flight work, and
sends synthetic ping probes so idle breakers earn their half-open
recovery — but it never *decides* anything.  A dead replica stays dead
until someone calls ``restart()``; a saturated fleet sheds typed
errors until someone adds capacity.  Those decisions are POLICY, and
policy lives here, in a loop an operator can read top to bottom::

    FleetSupervisor.tick()
        1. RESURRECT   every dead replica gets restart(wait=False);
                       respawn backoff and the crash-loop cap are the
                       router's contract and are RESPECTED, not bypassed
                       — a replica owing backoff is retried next tick,
                       a crash-looping one is left for the operator
        2. SCALE UP    sustained pressure spawns a replica from
                       `spec_factory`, up to FleetConfig.max_replicas.
                       Pressure is measured PER CLASS on a role-split
                       fleet: the prefill class reads queue depth and
                       TTFT EWMA (admission latency IS prefill
                       latency), the decode class reads queue depth
                       and decode slot occupancy (active streams /
                       max_decode_slots) — a fleet drowning in long
                       decodes spawns decode capacity, not another
                       prefill replica, and vice versa.  Each class
                       keeps its own sustain counter; `spec_factory`
                       receives the pressured class via a `role`
                       keyword when its signature accepts one.
        3. SCALE DOWN  a sustained idle fleet (every replica idle for
                       `idle_ticks` consecutive ticks) drains ONE
                       supervisor-spawned replica per tick, down to
                       FleetConfig.min_replicas — only its own spawns:
                       the operator's configured fleet is never shrunk

``tick()`` is synchronous and deterministic (tests drive it directly);
``start()`` runs it on a background thread every ``interval_s`` — the
production shape.  All accounting lands in the fleet.* registry:
supervisor_restart_total, autoscale_spawned/drained, replica_count.

Docs: docs/SERVING.md "Cross-host fleet".
"""
import inspect
import threading

from .admission import ServingError

__all__ = ["FleetSupervisor", "SupervisorConfig"]


class SupervisorConfig:
    """Control-plane policy knobs.

    interval_s: background tick period (start()).
    scale_up_queue_depth: mean queued requests per serving replica at
        or above which a tick counts as PRESSURE.
    scale_up_ttft_s: measured TTFT EWMA (worst serving replica) at or
        above which a tick counts as pressure (None = disabled).  A
        prefill-class signal: TTFT is what prefill capacity buys.
    scale_up_slot_occupancy: decode slot occupancy (active streams /
        max_decode_slots, worst serving replica) at or above which a
        tick counts as pressure (None = disabled).  A decode-class
        signal: a replica with every decode slot seated sheds the
        next admission even with an empty queue.
    sustain_ticks: consecutive pressure ticks (per class) before ONE
        replica is spawned for that class (a single burst must not
        double the fleet).
    idle_ticks: consecutive fully-idle ticks before ONE spawned
        replica is drained.
    """

    def __init__(self, interval_s=0.25, scale_up_queue_depth=4.0,
                 scale_up_ttft_s=None, scale_up_slot_occupancy=None,
                 sustain_ticks=3, idle_ticks=8):
        if float(interval_s) <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.interval_s = float(interval_s)
        if float(scale_up_queue_depth) <= 0:
            raise ValueError(f"scale_up_queue_depth must be > 0, got "
                             f"{scale_up_queue_depth}")
        self.scale_up_queue_depth = float(scale_up_queue_depth)
        if scale_up_ttft_s is not None and float(scale_up_ttft_s) <= 0:
            raise ValueError(f"scale_up_ttft_s must be > 0 or None, "
                             f"got {scale_up_ttft_s}")
        self.scale_up_ttft_s = (None if scale_up_ttft_s is None
                                else float(scale_up_ttft_s))
        if scale_up_slot_occupancy is not None and not (
                0.0 < float(scale_up_slot_occupancy) <= 1.0):
            raise ValueError(f"scale_up_slot_occupancy must be in "
                             f"(0, 1] or None, got "
                             f"{scale_up_slot_occupancy}")
        self.scale_up_slot_occupancy = (
            None if scale_up_slot_occupancy is None
            else float(scale_up_slot_occupancy))
        for knob, val in (("sustain_ticks", sustain_ticks),
                          ("idle_ticks", idle_ticks)):
            if int(val) < 1:
                raise ValueError(f"{knob} must be >= 1, got {val}")
        self.sustain_ticks = int(sustain_ticks)
        self.idle_ticks = int(idle_ticks)


class FleetSupervisor:
    """The decision loop over one FleetRouter.

    `spec_factory(index) -> ReplicaSpec` builds the spec for the
    index-th supervisor-spawned replica (None disables autoscaling
    up — the supervisor still resurrects and drains).  The supervisor
    only ever REMOVES replicas it spawned itself."""

    def __init__(self, router, spec_factory=None, config=None):
        self.router = router
        self.spec_factory = spec_factory
        self.config = config or SupervisorConfig()
        self._spawned = []          # names, spawn order (LIFO drain)
        self._spawn_seq = 0
        self._pressure_ticks = {}   # class -> consecutive hits
        self._idle_ticks = 0
        self._lock = threading.Lock()   # one tick at a time
        self._stop = threading.Event()
        self._thread = None

    # ---------------------------- policy ----------------------------
    def _survey(self):
        """One read of the fleet: (serving replica count, dead names,
        per-class signal dict, all idle).  Classes: on a role-split
        fleet, "prefill" and "decode" — a mixed replica contributes to
        BOTH (it does both jobs); on a homogeneous fleet, one "mixed"
        class (the pre-split behavior, one sustain counter).  Each
        class entry carries queue depths, TTFT EWMAs, and decode slot
        occupancies.  Reads cached transport state only — no RPCs on
        the policy path."""
        serving, dead, idle = 0, [], True
        reps = list(self.router._replicas.values())
        split = any(r.role in ("prefill", "decode") for r in reps
                    if r.state == "serving")
        stats = {}
        for rep in reps:
            if rep.state == "dead":
                dead.append(rep.name)
                continue
            if rep.state != "serving":
                continue
            serving += 1
            try:
                info = rep.transport.load_info()
            except ServingError:
                continue
            if not info.get("idle", True) or info["queue_depth"]:
                idle = False
            slots = getattr(rep, "_describe", {}).get("max_decode_slots")
            classes = (("mixed",) if not split
                       else (("prefill", "decode")
                             if rep.role == "mixed" else (rep.role,)))
            for cls in classes:
                s = stats.setdefault(
                    cls, {"depths": [], "ewmas": [], "occ": []})
                s["depths"].append(info["queue_depth"])
                if rep.ttft_ewma is not None:
                    s["ewmas"].append(rep.ttft_ewma)
                if slots:
                    s["occ"].append(info["active"] / slots)
        return serving, dead, stats, idle

    def _resurrect(self, dead):
        """restart(wait=False) every dead replica, respecting the
        router's respawn discipline: backoff still owed → retry next
        tick; crash-loop cap hit → leave it for the operator (the
        typed error names reset_respawn as the override)."""
        healed = 0
        for name in dead:
            try:
                self.router.restart(name, wait=False)
            except (ServingError, KeyError):
                continue   # backoff owed / crash loop / raced a remove
            self.router.metrics.count_supervisor_restart()
            healed += 1
        return healed

    def _class_pressure(self, cls, s):
        """One class's pressure verdict from its survey signals.
        Queue depth presses every class; TTFT EWMA presses prefill
        (and mixed); decode slot occupancy presses decode (and
        mixed)."""
        cfg = self.config
        depths = s["depths"]
        mean_depth = (sum(depths) / len(depths)) if depths else 0.0
        if mean_depth >= cfg.scale_up_queue_depth:
            return True
        if cls != "decode" and cfg.scale_up_ttft_s is not None \
                and max(s["ewmas"], default=0.0) >= cfg.scale_up_ttft_s:
            return True
        return (cls != "prefill"
                and cfg.scale_up_slot_occupancy is not None
                and max(s["occ"], default=0.0)
                >= cfg.scale_up_slot_occupancy)

    def _make_spec(self, seq, role):
        """Build the spec for one spawn, passing the pressured class
        through to factories that accept a `role` keyword — a role-
        split fleet scales the class that is actually starved.  Plain
        `factory(seq)` factories keep working unchanged."""
        if role != "mixed":
            try:
                params = inspect.signature(
                    self.spec_factory).parameters
            except (TypeError, ValueError):
                params = {}
            if "role" in params or any(
                    p.kind is inspect.Parameter.VAR_KEYWORD
                    for p in params.values()):
                return self.spec_factory(seq, role=role)
        return self.spec_factory(seq)

    def _scale_up(self, serving, role="mixed"):
        cap = self.router.config.max_replicas
        if self.spec_factory is None or cap is None or serving >= cap:
            return False
        spec = self._make_spec(self._spawn_seq, role)
        try:
            name = self.router.add_replica(spec)
        except (ServingError, ValueError):
            return False
        self._spawn_seq += 1
        self._spawned.append(name)
        self.router.metrics.count_autoscale(up=True)
        return True

    def _scale_down(self, serving):
        if not self._spawned \
                or serving <= self.router.config.min_replicas:
            return False
        name = self._spawned.pop()   # LIFO: newest spawn drains first
        try:
            self.router.remove_replica(name)
        except (ServingError, KeyError):
            return False
        self.router.metrics.count_autoscale(up=False)
        return True

    def tick(self):
        """One deterministic control-plane pass.  Returns a dict of
        the actions taken — the test/introspection surface."""
        with self._lock:
            serving, dead, stats, idle = self._survey()
            healed = self._resurrect(dead)
            spawned = drained = False
            pressured = {cls: self._class_pressure(cls, s)
                         for cls, s in stats.items()}
            # a class that left the fleet (role split appeared or
            # vanished) forgets its streak
            for cls in [c for c in self._pressure_ticks
                        if c not in pressured]:
                del self._pressure_ticks[cls]
            for cls, hit in pressured.items():
                self._pressure_ticks[cls] = \
                    self._pressure_ticks.get(cls, 0) + 1 if hit else 0
            if any(pressured.values()):
                self._idle_ticks = 0
            elif idle and not dead:
                self._idle_ticks += 1
            else:
                self._idle_ticks = 0
            for cls in ("mixed", "prefill", "decode"):
                if self._pressure_ticks.get(cls, 0) \
                        >= self.config.sustain_ticks:
                    if self._scale_up(serving + (1 if spawned else 0),
                                      role=cls):
                        spawned = True
                        self._pressure_ticks[cls] = 0
            if not spawned \
                    and self._idle_ticks >= self.config.idle_ticks:
                drained = self._scale_down(serving)
                if drained:
                    self._idle_ticks = 0
            depths = [d for s in stats.values() for d in s["depths"]]
            ewmas = [e for s in stats.values() for e in s["ewmas"]]
            return {"healed": healed, "spawned": spawned,
                    "drained": drained, "serving": serving,
                    "mean_queue_depth": round(
                        (sum(depths) / len(depths)) if depths else 0.0,
                        3),
                    "worst_ttft_s": round(max(ewmas, default=0.0), 4),
                    "pressure": pressured,
                    "idle": idle}

    # --------------------------- lifecycle --------------------------
    def start(self):
        """Run tick() on a background thread every interval_s."""
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="fleet-supervisor", daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.config.interval_s):
            try:
                self.tick()
            except Exception:   # noqa: BLE001 — the control plane
                pass            # must outlive any single bad tick

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
