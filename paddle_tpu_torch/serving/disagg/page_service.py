"""FleetPrefixIndex: fleet-level prefix/page bookkeeping.

The parameter-server split (PAPER.md L5): BOOKKEEPING is centralized —
one small index in the router mapping prefix chain hashes to the
replicas that measurably hold them — while page BYTES move
point-to-point on demand (GenerationEngine.export_prefix_pages →
import_prefix_pages), never through a shared store.

Each replica's cache emits ``("add"|"drop", chain_hash)`` deltas at the
exact trie transitions (register_prefix / _drop_node / flush —
kv_cache.take_prefix_deltas), piggybacked on stats or heartbeat frames,
so the index tracks what each prefix index ACTUALLY holds instead of
guessing from a stable hash.  Routing looks up the deepest chain of a
prompt's leading full pages; when the holder is not the chosen replica,
the router moves the run's bytes so ANY replica adopts pages it never
prefilled (docs/SERVING.md "Disaggregated fleet").

A chain hash collision can at worst misroute or skip one adoption —
adoption and admission both re-verify against literal tokens
(kv_cache.page_chain_hash documents the containment).
"""
from ...generation.kv_cache import (compact_prefix_deltas,
                                    page_chain_hash)

# delta-log net-op collapse, re-exported for transport/heartbeat
# accumulators: an add→drop churn nets to its last op per chain
compact_deltas = compact_prefix_deltas


def page_chain_hashes(tokens, page_size):
    """Chain hashes of every leading FULL page of `tokens`:
    ``out[i]`` identifies the prefix ``tokens[:(i+1) * page_size]``.
    Must mirror register_prefix's incremental hashing exactly — both
    call kv_cache.page_chain_hash page by page."""
    out = []
    h = 0
    for i in range(len(tokens) // page_size):
        h = page_chain_hash(
            h, tokens[i * page_size:(i + 1) * page_size])
        out.append(h)
    return out


class FleetPrefixIndex:
    """chain_hash -> {replica_name: recency} — which replicas hold
    which cached prefix runs, by measurement.  Not thread-safe on its
    own; the FleetRouter mutates it under its routing lock."""

    def __init__(self):
        self._holders = {}
        self._clock = 0
        self.compactions = 0       # compact() sweeps that dropped work
        self.chains_compacted = 0  # dead-holder chains swept, total

    def _tick(self):
        self._clock += 1
        return self._clock

    def apply(self, name, deltas):
        """Ingest one replica's drained register/evict deltas."""
        for op, chain in deltas:
            if op == "add":
                self._holders.setdefault(chain, {})[name] = self._tick()
            elif op == "drop":
                holders = self._holders.get(chain)
                if holders is not None:
                    holders.pop(name, None)
                    if not holders:
                        del self._holders[chain]

    def drop_replica(self, name):
        """Forget everything `name` held — drain, restart, or death
        invalidates its whole index at once."""
        for chain in [c for c, h in self._holders.items() if name in h]:
            holders = self._holders[chain]
            del holders[name]
            if not holders:
                del self._holders[chain]

    def holders_of(self, chain):
        """Replica names holding `chain` right now (a set copy)."""
        return set(self._holders.get(chain, ()))

    def lookup(self, tokens, page_size, names=None):
        """The DEEPEST registered chain matching a prefix of `tokens`,
        held by a replica in `names` (None = any): returns
        ``(holder_name, matched_tokens, chain_hash)`` or None.  Ties
        between holders break to the most recently registered — the
        replica whose copy is warmest."""
        hashes = page_chain_hashes(tokens, page_size)
        for depth in range(len(hashes), 0, -1):
            holders = self._holders.get(hashes[depth - 1])
            if not holders:
                continue
            pool = [n for n in holders if names is None or n in names]
            if pool:
                best = max(pool, key=lambda n: holders[n])
                return best, depth * page_size, hashes[depth - 1]
        return None

    def compact(self, live):
        """Week-long-uptime memory bound: drop every holder entry not
        in `live` (replica names currently serving) and every chain
        left with no live holder.  drop_replica already handles clean
        deaths; this sweep is the belt-and-braces GC the router's
        watchdog runs so renames, missed death paths, and long
        add/drop churn can never grow the index without bound.
        Returns the number of chains dropped."""
        live = set(live)
        dropped = 0
        for chain in list(self._holders):
            holders = self._holders[chain]
            for name in [n for n in holders if n not in live]:
                del holders[name]
            if not holders:
                del self._holders[chain]
                dropped += 1
        if dropped:
            self.compactions += 1
            self.chains_compacted += dropped
        return dropped

    def chains_held(self, name=None):
        """Registered chain count (fleet-wide, or one replica's) — the
        stats_snapshot gauge."""
        if name is None:
            return len(self._holders)
        return sum(1 for h in self._holders.values() if name in h)
