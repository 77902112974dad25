"""Monitor gauges: named int/float counters in a process-local,
thread-safe registry (``StatRegistry``).  Readers snapshot via
stats()/get."""
import threading
import time


class Stat:
    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name, value=0):
        self.name = name
        self._value = value
        self._lock = threading.Lock()

    def increase(self, v=1):
        with self._lock:
            self._value += v
            return self._value

    def decrease(self, v=1):
        return self.increase(-v)

    def reset(self):
        with self._lock:
            self._value = 0

    def set(self, v):
        """Gauge semantics: overwrite instead of accumulate, atomically
        under the same lock increase() takes."""
        with self._lock:
            self._value = v
            return self._value

    def get(self):
        with self._lock:
            return self._value


class StatRegistry:
    """Named stats, created on first use (singleton via instance())."""

    _instance = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self._stats = {}
        self._lock = threading.Lock()

    @classmethod
    def instance(cls):
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def get_stat(self, name):
        with self._lock:
            st = self._stats.get(name)
            if st is None:
                st = Stat(name)
                self._stats[name] = st
            return st

    def stats(self):
        """Snapshot: {name: value}."""
        with self._lock:
            items = list(self._stats.items())
        return {n: s.get() for n, s in items}

    def reset_all(self):
        with self._lock:
            items = list(self._stats.values())
        for s in items:
            s.reset()

    def stats_snapshot(self, prefix=None):
        """A sorted ``{"ts": unix seconds, "stats": {name: value}}`` dict
        of the registry, optionally filtered to names starting with
        `prefix` (e.g. "generation." or "fleet.")."""
        stats = self.stats()
        if prefix:
            stats = {k: v for k, v in stats.items() if k.startswith(prefix)}
        return {"ts": round(time.time(), 3),
                "stats": dict(sorted(stats.items()))}
