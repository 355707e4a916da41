"""Host-side KV page management: the page pool allocator and the prefix cache.

Counterpart of ``deepspeed_tpu/serving/paging.py`` (numpy only; the port
keeps its own copy). The serving step never sees this module: it consumes
the result, per-slot page-table int32 vectors and a copy-on-write source
vector.

- :class:`PagePool` — refcounted free-list over ``num_pages`` physical
  page ids. A page is *live* while any slot or prefix-cache entry holds a
  reference; ``free + live == num_pages`` is the leak invariant the
  scheduler asserts after every tick.
- :class:`PrefixCache` — chained-hash map from token prefixes to pages a
  finished request left behind. Full pages chain with
  ``crc32(block_bytes, prev_hash)``; the partial tail page is stored with
  its valid-token run. Matches verify actual token equality (hash
  collisions degrade to misses, never to wrong KV). Entries hold one pool
  reference each and are evicted LRU under pool pressure. Its host-tier
  methods serve KV tiering, which waits with ``HostPageStore``,
  ``PageSpiller`` and the page export/import of the fleet handoff (ROADMAP
  A4, A9): with no spiller attached they are never reached.

Sharing is read-only: a slot whose write frontier lands inside a shared
page never writes it in place — the scheduler allocates a fresh page and
the step copies the shared page's KV into it before the chunk write
(copy-on-write).
"""

from __future__ import annotations

import zlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def chain_hash(prev: int, block) -> int:
    """Chained block hash: crc32 of the token block seeded by the previous
    link, so a page's key commits to the ENTIRE prefix before it (KV at a
    position depends on every earlier token)."""
    return zlib.crc32(np.asarray(block, np.int32).tobytes(), prev)


def chain_hashes(tokens, page_size: int) -> List[int]:
    """The chained hash of every FULL page-sized block of ``tokens``, in
    order. Because each link commits to the whole prefix before it, these
    keys are globally comparable: two caches (on two replicas) holding the
    same chain hash hold KV for the same token prefix — modulo crc32
    collisions, which every consumer must let degrade to misses (the
    router's index may mis-route on one; the replica's token-verified
    ``match`` then treats it as a miss, never as wrong KV)."""
    toks = np.asarray(tokens, np.int32).reshape(-1)
    ps = int(page_size)
    out: List[int] = []
    h = 0
    for i in range(toks.size // ps):
        h = chain_hash(h, toks[i * ps: (i + 1) * ps])
        out.append(h)
    return out


def longest_chain_walk(token_block_hashes, contains) -> int:
    """The ONE definition of "longest matching block chain": the length of
    the leading run of ``token_block_hashes`` for which ``contains(hash)``
    holds. Shared by :meth:`PrefixCache.longest_chain` (the replica-local
    cache view) and the fleet router's :class:`GlobalPrefixIndex` (the
    event-maintained cross-replica mirror), so routing and matching agree
    on what "longest chain" means. Accepts any iterable and consumes only
    up to the first miss — ``match`` feeds it a lazy hash generator, so a
    cold cache never pays for hashing a whole long prompt. Hash-presence
    only — callers that hand out KV must still verify token equality."""
    n = 0
    for h in token_block_hashes:
        if not contains(h):
            break
        n += 1
    return n



# ----------------------------------------------------- tiered host spill
# staging-buffer width of KV tiering: host pages promoted back per step
# (the scheduler's promotion planner reads it; tiering is not ported yet)
STAGE_SLOTS = 2


class PagePool:
    """Refcounted physical-page allocator (host side, O(1) ops)."""

    def __init__(self, num_pages: int):
        if num_pages < 1:
            raise ValueError(f"PagePool needs >= 1 page, got {num_pages}")
        self.num_pages = int(num_pages)
        self.refcount = np.zeros(self.num_pages, np.int64)
        self._free: List[int] = list(range(self.num_pages - 1, -1, -1))

    def alloc(self) -> Optional[int]:
        """One fresh page with refcount 1, or None when exhausted."""
        if not self._free:
            return None
        page = self._free.pop()
        self.refcount[page] = 1
        return page

    def incref(self, page: int) -> None:
        if self.refcount[page] <= 0:
            raise AssertionError(f"incref on dead page {page}")
        self.refcount[page] += 1

    def decref(self, page: int) -> None:
        if self.refcount[page] <= 0:
            raise AssertionError(f"decref on dead page {page}")
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            self._free.append(page)

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def live_count(self) -> int:
        return int((self.refcount > 0).sum())

    def check_leaks(self, expected: Optional[Dict[int, int]] = None) -> None:
        """The leak invariant: ``free + live == num_pages``, and (when the
        caller supplies its own view) the pool's refcounts match the
        references the scheduler believes exist, page for page."""
        if self.free_count + self.live_count != self.num_pages:
            raise AssertionError(
                f"page leak: free {self.free_count} + live "
                f"{self.live_count} != num_pages {self.num_pages}"
            )
        if expected is not None:
            mine = {
                int(p): int(self.refcount[p])
                for p in np.nonzero(self.refcount)[0]
            }
            if mine != expected:
                raise AssertionError(
                    f"page refcount drift: pool {mine} != holders {expected}"
                )


class PrefixCache:
    """Token-prefix → shared KV pages, refcounted through a PagePool.

    Full pages key on the chain hash of all tokens up to and including the
    page; the partial tail keys on (chain hash so far, tail token run).
    ``match`` walks a prompt greedily and returns the shared pages plus
    how many tokens they cover; the caller caps the hit (a request must
    always feed at least its final prompt token to sample) and increfs.
    """

    def __init__(self, pool: PagePool, page_size: int, spiller=None):
        self.pool = pool
        self.page_size = int(page_size)
        # full pages: chain_hash -> (page, block_tuple); tails:
        # chain_hash -> [(tail_tuple, page), ...]. One LRU order over both
        # (key -> ("full"|"tail", chain_hash, page, tokens_tuple)).
        self._full: "OrderedDict[int, Tuple[int, Tuple[int, ...]]]" = (
            OrderedDict()
        )
        self._tails: Dict[int, List[Tuple[Tuple[int, ...], int]]] = {}
        self._lru: "OrderedDict[Tuple, None]" = OrderedDict()
        # cache-event listener: ``listener(event, kind, chain_hash, page)``
        # with event in {"insert", "evict"} and kind in {"full", "tail",
        # "host"}. The fleet router's GlobalPrefixIndex subscribes here to
        # mirror each replica's full-page chain keys (HBM- and host-tier)
        # without polling; None (the default) is the zero-overhead
        # single-engine path.
        self.listener = None
        # ---- host tier: evicted FULL chains demote to the
        # spiller's HostPageStore instead of dropping. chain_hash ->
        # (store_key, block); its own LRU; pins protect keys whose
        # promotion a slot is waiting on from host-tier eviction.
        self.spiller = spiller
        self._host_full: Dict[int, Tuple[int, Tuple[int, ...]]] = {}
        self._host_lru: "OrderedDict[int, None]" = OrderedDict()
        self._host_pins: Dict[int, int] = {}

    def _emit(self, event: str, kind: str, h: int, page: int) -> None:
        if self.listener is not None:
            self.listener(event, kind, h, page)

    def __len__(self) -> int:
        return len(self._lru)

    @property
    def held_pages(self) -> List[int]:
        return [key[2] for key in self._lru]

    # ---------------------------------------------------------------- match
    def longest_chain(self, token_block_hashes) -> int:
        """Public longest-matching-block-chain lookup: how many leading
        chained-crc32 FULL-page keys (:func:`chain_hashes`, or any lazy
        iterable of them — only the matched prefix is ever consumed) this
        cache holds. Hash-presence only — a crc32 collision can overstate
        the depth, which is exactly why :meth:`match` re-verifies token
        equality before handing out pages (collisions degrade to misses,
        never to wrong KV). Used by the scheduler's match path and by the
        fleet router's global index (the same :func:`longest_chain_walk`
        over its event-maintained per-replica mirror)."""
        return longest_chain_walk(token_block_hashes,
                                  self._full.__contains__)

    def match(self, prompt: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached prefix of ``prompt``: (pages, covered_tokens).
        Pages are NOT incref'd — the caller takes references for the ones
        it keeps. The hash walk is :meth:`longest_chain` over a LAZY
        chain-hash generator (a miss at block i stops hashing — a cold
        cache costs one crc32, not one per prompt page); token equality
        is then verified block-for-block (hash collisions shrink the
        match — a miss, never wrong KV)."""
        toks = [int(t) for t in np.asarray(prompt).reshape(-1)]
        ps = self.page_size
        hashes: List[int] = []

        def lazy_hashes():
            h = 0
            for i in range(len(toks) // ps):
                h = chain_hash(h, toks[i * ps: (i + 1) * ps])
                hashes.append(h)
                yield h

        depth = self.longest_chain(lazy_hashes())
        pages: List[int] = []
        covered = 0
        h = 0
        for i in range(depth):
            block = tuple(toks[covered: covered + ps])
            nh = hashes[i]
            entry = self._full[nh]
            if entry[1] != block:
                break  # crc32 collision: stop the walk — a miss
            pages.append(entry[0])
            self._lru.move_to_end(("full", nh, entry[0], block))
            covered += ps
            h = nh
        # partial tail: use the stored run's leading tokens that match the
        # remaining prompt (KV beyond the match is never attendable — the
        # joining slot's frontier stops at the match)
        rest = toks[covered:]
        best: Tuple[int, Tuple[Tuple[int, ...], int]] = (0, None)
        for tail, page in self._tails.get(h, ()):
            n = 0
            for a, b in zip(tail, rest):
                if a != b:
                    break
                n += 1
            if n > best[0]:
                best = (n, (tail, page))
        if best[0] > 0:
            tail, page = best[1]
            pages.append(page)
            self._lru.move_to_end(("tail", h, page, tail))
            covered += best[0]
        return pages, covered

    # --------------------------------------------------------------- insert
    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Publish a finished request's pages for reuse. ``tokens`` is the
        run whose KV the pages hold (prompt + generated-but-last);
        ``pages`` the physical pages covering it in order. Each entry the
        cache keeps takes ONE pool reference; duplicates of existing
        entries are skipped (the caller's own references are its business).
        Returns the number of entries inserted."""
        toks = [int(t) for t in np.asarray(tokens).reshape(-1)]
        ps = self.page_size
        inserted = 0
        h = 0
        full = len(toks) // ps
        for i in range(full):
            block = tuple(toks[i * ps: (i + 1) * ps])
            nh = chain_hash(h, block)
            if nh not in self._full:
                self._full[nh] = (int(pages[i]), block)
                self._lru[("full", nh, int(pages[i]), block)] = None
                self.pool.incref(int(pages[i]))
                self._emit("insert", "full", nh, int(pages[i]))
                inserted += 1
            # ALSO register the full page's run for partial matching: a
            # prompt diverging mid-page (the shared-system-prompt shape)
            # still shares this page's leading tokens, copy-on-write at
            # the divergence point
            inserted += self._add_tail(h, block, int(pages[i]))
            h = nh
        tail = tuple(toks[full * ps:])
        if tail and full < len(pages):
            inserted += self._add_tail(h, tail, int(pages[full]))
        return inserted

    def _add_tail(self, h: int, run: Tuple[int, ...], page: int) -> int:
        runs = self._tails.setdefault(h, [])
        if any(existing == run for existing, _ in runs):
            return 0
        runs.append((run, page))
        self._lru[("tail", h, page, run)] = None
        self.pool.incref(page)
        self._emit("insert", "tail", h, page)
        return 1

    # --------------------------------------------------------------- evict
    def evict_lru(self) -> bool:
        """Evict the least-recently-used entry (its pool reference with
        it). With a spiller attached, FULL chain entries DEMOTE to the
        host tier (codec-compressed at rest) instead of vanishing — a
        later match promotes them back; tails and collisions still drop.
        Returns False when the cache is empty."""
        if not self._lru:
            return False
        key, _ = self._lru.popitem(last=False)
        kind, h, page, toks = key
        if kind == "full":
            self._full.pop(h, None)
            if self.spiller is not None and h not in self._host_full:
                self._demote_full(h, page, toks)
        else:
            runs = self._tails.get(h, [])
            self._tails[h] = [r for r in runs if r != (toks, page)]
            if not self._tails[h]:
                del self._tails[h]
        self.pool.decref(page)
        self._emit("evict", kind, h, page)
        return True

    # ----------------------------------------------------------- host tier
    def _demote_full(self, h: int, page: int,
                     block: Tuple[int, ...]) -> Optional[int]:
        """Demote one evicted full page to the host tier. On a full
        store, unpinned host-LRU chains make room first; a still-full
        store falls back to the plain drop (demotion failure is atomic —
        :meth:`PageSpiller.demote` mutates nothing on None)."""
        skey = self.spiller.demote(page)
        while skey is None and self._evict_host_lru():
            skey = self.spiller.demote(page)
        if skey is not None:
            self._host_full[h] = (skey, block)
            self._host_lru[h] = None
            self._emit("insert", "host", h, -1)
        return skey

    def _evict_host_lru(self) -> bool:
        """Drop the oldest UNPINNED host-tier chain (pinned keys have a
        slot's promotion in flight — never yank those)."""
        for h in list(self._host_lru):
            skey, _block = self._host_full[h]
            if self._host_pins.get(skey, 0) == 0:
                del self._host_lru[h]
                del self._host_full[h]
                self.spiller.drop(skey)
                self._emit("evict", "host", h, -1)
                return True
        return False

    def host_chain(self, tokens: Sequence[int], start: int,
                   max_pages: int) -> List[Tuple[int, int]]:
        """Continue a chain walk into the host tier: from page-aligned
        token offset ``start``, the leading run of full blocks whose
        chained hash has a host-resident entry — token-verified, like
        :meth:`match` (collisions degrade to misses). Returns
        ``[(store_key, chain_hash)]`` per matched block; the caller pins
        each key (:meth:`pin_host`) until its promotion lands."""
        if self.spiller is None or start % self.page_size != 0:
            return []
        toks = [int(t) for t in np.asarray(tokens).reshape(-1)]
        ps = self.page_size
        h = 0
        for i in range(start // ps):
            h = chain_hash(h, toks[i * ps: (i + 1) * ps])
        out: List[Tuple[int, int]] = []
        pos = start
        while len(out) < max_pages and pos + ps <= len(toks):
            block = tuple(toks[pos: pos + ps])
            nh = chain_hash(h, block)
            ent = self._host_full.get(nh)
            if ent is None or ent[1] != block:
                break
            out.append((ent[0], nh))
            self._host_lru.move_to_end(nh)
            h = nh
            pos += ps
        return out

    def pin_host(self, key: int) -> None:
        self._host_pins[key] = self._host_pins.get(key, 0) + 1

    def unpin_host(self, key: int) -> None:
        n = self._host_pins.get(key, 0) - 1
        if n <= 0:
            self._host_pins.pop(key, None)
        else:
            self._host_pins[key] = n

    @property
    def host_keys(self) -> List[int]:
        return [skey for skey, _block in self._host_full.values()]

    @property
    def host_entries(self) -> int:
        return len(self._host_full)

    def clear(self) -> None:
        while self.evict_lru():
            pass
        # the LRU drain above DEMOTES full chains when tiered — now drop
        # the host tier too (pins should be empty at clear time; a pinned
        # key here is a scheduler lifecycle bug surfaced by the store)
        for h in list(self._host_lru):
            skey, _block = self._host_full.pop(h)
            del self._host_lru[h]
            self.spiller.drop(skey)
            self._emit("evict", "host", h, -1)
