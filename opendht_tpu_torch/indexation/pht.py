"""PHT — Prefix Hash Tree: a distributed trie over the DHT for prefix and
multi-dimensional (z-curve) indexing.

Behavioral port of the reference implementation (reference:
include/opendht/indexation/pht.h:49-533, src/indexation/pht.cpp):

- :class:`Prefix` — bit-string with optional per-bit "known" flags; node
  labels in the trie.  ``hash()`` = H(content ‖ size&0xFF) (pht.h:123-127).
- :class:`Cache` — local trie of recently-seen PHT nodes with 5-minute
  expiry, used to pick a good starting depth (pht.cpp:61-146).
- :class:`IndexEntry` — {prefix, (hash, value-id)} payload stored at leaf
  nodes, tagged by ``user_type`` (pht.h:267-286).
- :class:`Pht` — ``lookup`` does a binary search over prefix lengths,
  probing "canary" values that mark live trie nodes (pht.cpp:150-297);
  ``insert`` walks to the leaf, splits when a node holds
  MAX_NODE_ENTRY_COUNT entries (pht.cpp:330-378,516-528), refreshes
  canaries up the path (pht.cpp:299-328), and re-inserts deeper when a
  leaf later splits (checkPhtUpdate, pht.cpp:487-514).
- multi-field keys are linearized by bit-interleaving (z-curve) padded
  fields (pht.cpp:380-456).

The port's copy of the JAX package's ``indexation/pht.py``, behaviour
unchanged: it runs over any DHT surface (the port's ``Dht``,
``SecureDht`` or ``DhtRunner``, proxied or not), and its entries are
packed by the port's own msgpack codec.
"""

from __future__ import annotations

import logging
import random
import time as _time
from typing import Callable, Dict, List, Optional, Tuple

from ..infohash import InfoHash
from ..core.value import Value
from ..utils import pack_msg, unpack_msg

log = logging.getLogger("opendht_tpu_torch.pht")

MAX_NODE_ENTRY_COUNT = 16          # pht.h:297
CACHE_MAX_ELEMENT = 1024           # pht.h:383
CACHE_NODE_EXPIRE_TIME = 5 * 60.0  # pht.h:384
INDEX_PREFIX = "index.pht."        # pht.h:292
USER_DATA_EXPIRATION = 10 * 60.0   # IndexEntry::TYPE = USER_DATA


class Prefix:
    """A trie-node label: ``size`` bits of ``content`` with optional
    per-bit flags (0 bit = "unknown", used by z-curve keys)."""

    __slots__ = ("size", "content", "flags")

    def __init__(self, content: bytes = b"", flags: bytes = b"",
                 size: Optional[int] = None):
        self.content = bytes(content)
        self.flags = bytes(flags)
        self.size = len(self.content) * 8 if size is None else int(size)

    @classmethod
    def from_hash(cls, h: InfoHash) -> "Prefix":
        return cls(bytes(h))

    # -- accessors ---------------------------------------------------------
    def _bit(self, blob: bytes, pos: int) -> bool:
        if pos >= len(self.content) * 8:
            raise IndexError("pos larger than prefix size")
        return bool((blob[pos // 8] >> (7 - (pos % 8))) & 1)

    def is_content_bit_active(self, pos: int) -> bool:
        return self._bit(self.content, pos)

    def is_flag_active(self, pos: int) -> bool:
        """Unknown-flag check; empty flags = everything known
        (pht.h:93-100; note the reference indexes flags per *byte* in
        common_bits — we keep that behavior there)."""
        return not self.flags or self._bit(self.flags, pos)

    # -- derivation --------------------------------------------------------
    def get_prefix(self, length: int) -> "Prefix":
        """First ``length`` bits (negative = size + length)
        (pht.h:70-89)."""
        if length < 0:
            length += self.size
        if length < 0 or length > len(self.content) * 8:
            raise IndexError("len larger than prefix size")
        nbytes, rem = length // 8, length % 8
        content = bytearray(self.content[:nbytes])
        flags = bytearray(self.flags[:nbytes]) if self.flags else bytearray()
        if rem:
            content.append(self.content[nbytes] & (0xFF << (8 - rem)))
            if self.flags:
                flags.append(self.flags[nbytes] & (0xFF << (8 - rem)))
        return Prefix(bytes(content), bytes(flags), length)

    def get_full_size(self) -> "Prefix":
        return Prefix(self.content, self.flags, len(self.content) * 8)

    def get_sibling(self) -> "Prefix":
        """Same label with the last bit swapped (pht.h:111-121)."""
        p = Prefix(self.content, self.flags, self.size)
        if self.size:
            p.swap_content_bit(self.size - 1)
        return p

    def swap_content_bit(self, bit: int) -> None:
        """Flip bit ``bit`` in the MSB-first numbering used everywhere
        else here.  (The reference's swapBit (pht.h:252-259) uses an
        off-by-one convention internally inconsistent with its own
        isActiveBit; we keep one consistent numbering instead.)"""
        b = bytearray(self.content)
        if bit >= len(b) * 8:
            raise IndexError("bit larger than prefix size")
        b[bit // 8] ^= 1 << (7 - bit % 8)
        self.content = bytes(b)

    def add_padding_content(self, size: int) -> None:
        """Zero-pad to ``size`` bytes, marking the first pad bit so padded
        keys of different lengths stay distinct (pht.h:215-227)."""
        b = bytearray(self.content)
        while len(b) < size:
            b.append(0)
        if self.size < len(b) * 8:
            b[self.size // 8] ^= 1 << (7 - self.size % 8)
        self.content = bytes(b)

    def update_flags(self) -> None:
        """Mark the first ``size`` bits known, the padding unknown
        (pht.h:185-199)."""
        flags = bytearray(self.flags)
        csize = self.size - len(flags) * 8
        while csize >= 8:
            flags.append(0xFF)
            csize -= 8
        if csize > 0:
            flags.append((0xFF << (8 - csize)) & 0xFF)
        while len(flags) < len(self.content):
            flags.append(0xFF)
        self.flags = bytes(flags)

    # -- hashing / compare -------------------------------------------------
    def hash(self) -> InfoHash:
        """DHT key of this trie node (pht.h:123-127)."""
        return InfoHash.get(self.content + bytes([self.size & 0xFF]))

    @staticmethod
    def common_bits(p1: "Prefix", p2: "Prefix") -> int:
        """Longest common prefix in bits, never exceeding either size
        (pht.h:129-162; the reference mixes bit/byte units here — this is
        the corrected semantics, only used for inexact-match ranking)."""
        longest_bits = min(p1.size, p2.size)
        nbytes = min(len(p1.content), len(p2.content),
                     (longest_bits + 7) // 8)
        i = 0
        while i < nbytes:
            if (p1.content[i] != p2.content[i]
                    or not p1.is_flag_active(i)
                    or not p2.is_flag_active(i)):
                break
            i += 1
        if i == nbytes:
            return longest_bits
        x = p1.content[i] ^ p2.content[i]
        if x == 0:
            return min(8 * i, longest_bits)   # flag, not content, differed
        j = 0
        while not (x & 0x80):
            x = (x << 1) & 0xFF
            j += 1
        return min(8 * i + j, longest_bits)

    def __eq__(self, other):
        return (isinstance(other, Prefix) and self.size == other.size
                and self.content == other.content)

    def __hash__(self):
        return hash((self.size, self.content))

    def to_string(self) -> str:
        bits = "".join(
            str(int(self.is_content_bit_active(i))) for i in range(self.size))
        return f"Prefix({bits})"

    __repr__ = to_string


class _CacheNode:
    __slots__ = ("last_reply", "parent", "children")

    def __init__(self, parent=None):
        self.last_reply = 0.0
        self.parent = parent
        self.children: Dict[bool, "_CacheNode"] = {}


class Cache:
    """Local trie of recently-confirmed PHT nodes (pht.cpp:61-146)."""

    def __init__(self, clock: Callable[[], float] = _time.monotonic):
        self._clock = clock
        self._root: Optional[_CacheNode] = None
        self._leaves: List[Tuple[float, _CacheNode]] = []

    def _expire(self, now: float, max_extra: int = 0) -> None:
        while self._leaves and (
                self._leaves[0][0] + CACHE_NODE_EXPIRE_TIME < now
                or len(self._leaves) > CACHE_MAX_ELEMENT - max_extra):
            _, leaf = self._leaves.pop(0)
            # prune the branch upward while childless
            node = leaf
            while node is not None and not node.children:
                parent = node.parent
                if parent is not None:
                    for k, v in list(parent.children.items()):
                        if v is node:
                            del parent.children[k]
                elif node is self._root:
                    self._root = None
                node = parent

    def insert(self, p: Prefix) -> None:
        now = self._clock()
        self._expire(now, max_extra=1)
        if self._root is None:
            self._root = _CacheNode()
        node = self._root
        node.last_reply = now
        for i in range(p.size):
            bit = p.is_content_bit_active(i)
            child = node.children.get(bit)
            if child is None:
                child = _CacheNode(parent=node)
                node.children[bit] = child
            node = child
            node.last_reply = now
        self._leaves.append((now, node))

    def lookup(self, p: Prefix) -> int:
        """Deepest known depth along ``p``; -1 when nothing cached
        (pht.cpp:110-146)."""
        now = self._clock()
        self._expire(now)
        pos = -1
        node = self._root
        last: Optional[_CacheNode] = None
        while node is not None:
            pos += 1
            if pos >= len(p.content) * 8:
                break
            last = node
            node.last_reply = now
            node = node.children.get(p.is_content_bit_active(pos))
        if pos >= 0 and last is not None:
            self._leaves.append((now, last))
        return pos


class IndexEntry:
    """Leaf payload: the full linearized key + the indexed (hash, vid)
    (pht.h:267-286)."""

    __slots__ = ("prefix", "value", "name")

    def __init__(self, prefix: bytes = b"",
                 value: Tuple[InfoHash, int] = (InfoHash(), 0),
                 name: str = ""):
        self.prefix = bytes(prefix)
        self.value = (InfoHash(value[0]), int(value[1]))
        self.name = name

    def pack(self) -> Value:
        v = Value(pack_msg({"prefix": self.prefix,
                            "value": [bytes(self.value[0]), self.value[1]]}))
        v.user_type = self.name
        # deterministic id: re-inserting the same entry (e.g. after a leaf
        # split) refreshes the stored value instead of accumulating
        # duplicates (the reference leaves random ids and relies on value
        # expiry; dedup keeps hot trie nodes small)
        digest = InfoHash.get(self.prefix + bytes(self.value[0])
                              + self.value[1].to_bytes(8, "big"))
        v.id = int.from_bytes(bytes(digest)[:8], "big") or 1
        return v

    @classmethod
    def unpack(cls, v: Value) -> "IndexEntry":
        m = unpack_msg(v.data)
        h, vid = m["value"][0], m["value"][1]
        return cls(bytes(m["prefix"]), (InfoHash(bytes(h)), int(vid)),
                   v.user_type)


class Pht:
    """A named distributed prefix-hash-tree index over a DhtRunner-like
    node (anything with get/put/listen/cancel_listen)."""

    def __init__(self, name: str, key_spec: Dict[str, int], dht,
                 rng: Optional[random.Random] = None):
        self.name = INDEX_PREFIX + name
        self.canary = self.name + ".canary"
        self.key_spec = dict(key_spec)
        self.dht = dht
        self.cache = Cache()
        self._rng = rng or random.Random()

    # ------------------------------------------------------------- keys
    def valid_key(self, key: Dict[str, bytes]) -> bool:
        """(pht.h:508-517)"""
        if set(key) != set(self.key_spec):
            return False
        return all(len(v) <= self.key_spec[k] for k, v in key.items())

    def linearize(self, key: Dict[str, bytes]) -> Prefix:
        """Pad each field to max-spec+1 bytes, mark pad bits unknown,
        z-curve interleave (pht.cpp:433-456)."""
        if not self.valid_key(key):
            raise ValueError("Key does not match the PHT key spec.")
        max_len = max(self.key_spec.values()) + 1
        parts = []
        for field in sorted(key):                 # Key is an ordered map
            p = Prefix(key[field])
            p.add_padding_content(max_len)
            p.update_flags()
            parts.append(p)
        return self.zcurve(parts)

    @staticmethod
    def zcurve(parts: List[Prefix]) -> Prefix:
        """Bit-interleave contents and flags of equal-size prefixes
        (pht.cpp:380-431)."""
        if len(parts) == 1:
            return parts[0]
        nbits = len(parts[0].content) * 8
        content = bytearray((nbits * len(parts) + 7) // 8)
        flags = bytearray(len(content))
        out = 0
        for i in range(nbits):
            for p in parts:
                if p.is_content_bit_active(i):
                    content[out // 8] |= 1 << (7 - out % 8)
                if p._bit(p.flags, i):
                    flags[out // 8] |= 1 << (7 - out % 8)
                out += 1
        return Prefix(bytes(content), bytes(flags), out)

    # ------------------------------------------------------------ lookup
    def _pht_filter(self, v: Value) -> bool:
        return v.user_type.startswith(self.name)

    def lookup(self, key: Dict[str, bytes], cb=None, done_cb=None,
               exact_match: bool = True) -> None:
        """Find the leaf for ``key``; cb(values, prefix) once found
        (pht.cpp:299-327)."""
        prefix = self.linearize(key)
        state = {"lo": 0, "hi": prefix.size,
                 "max_common": 0 if not exact_match else None}
        vals: List[IndexEntry] = []

        def on_leaf(entries: List[IndexEntry], p: Prefix):
            if cb:
                cb([e.value for e in entries], p)

        self._lookup_step(prefix, state, vals, on_leaf, done_cb,
                          start=self.cache.lookup(prefix))

    def _lookup_step(self, p: Prefix, state: dict, vals: List[IndexEntry],
                     cb, done_cb, start: int = -1,
                     all_values: bool = False) -> None:
        """One binary-search step: probe depth mid and mid+1 for canaries
        (pht.cpp:150-297)."""
        lo, hi = state["lo"], state["hi"]
        if lo > hi:
            if done_cb:
                done_cb(True)
            return
        mid = start if start >= 0 else (lo + hi) // 2
        first = {"done": False, "is_pht": False, "ok": True}
        second = {"done": False, "is_pht": False, "ok": True}
        if mid >= p.size - 1:
            second["done"] = True

        def on_value(v: Value, res: dict) -> None:
            if v.user_type == self.canary:
                res["is_pht"] = True
                return
            try:
                entry = IndexEntry.unpack(v)
            except Exception:
                return
            if any(e.value == entry.value for e in vals):
                return
            if state["max_common"] is not None:    # inexact match
                common = Prefix.common_bits(p, Prefix(entry.prefix))
                if not vals or common > state["max_common"]:
                    vals.clear()
                    vals.append(entry)
                    state["max_common"] = common
                elif common == state["max_common"]:
                    vals.append(entry)
            elif all_values or entry.prefix == p.content:
                vals.append(entry)

        def on_done():
            if not (first["ok"] and second["ok"]):
                if done_cb:
                    done_cb(False)
                return
            is_leaf = first["is_pht"] and not second["is_pht"]
            if is_leaf or state["lo"] > state["hi"]:
                to_insert = p.get_prefix(mid)
                self.cache.insert(to_insert)
                if cb:
                    if (not vals and state["max_common"] is not None
                            and mid > 0):
                        # inexact: descend the sibling subtree
                        sibling = p.get_prefix(mid).get_sibling() \
                                   .get_full_size()
                        state["lo"] = mid
                        state["hi"] = sibling.size
                        self._lookup_step(sibling, state, vals, cb,
                                          done_cb, all_values=all_values)
                    cb(vals, to_insert)
                if done_cb:
                    done_cb(True)
            elif first["is_pht"]:
                state["lo"] = mid + 1
                self._lookup_step(p, state, vals, cb, done_cb,
                                  all_values=all_values)
            else:
                if done_cb:
                    done_cb(False)

        def get_done_first(ok, _nodes=None):
            if not ok:
                first["done"] = True
                first["ok"] = False
                if second["done"]:
                    on_done()
                return
            if not first["is_pht"]:
                # not a PHT node: go shallower; the second probe is
                # abandoned (its completion must not fire on_done, so
                # first stays not-done — pht.cpp:252-262)
                state["hi"] = mid - 1
                self._lookup_step(p, state, vals, cb, done_cb,
                                  all_values=all_values)
            else:
                first["done"] = True
                if second["done"]:
                    on_done()

        def get_done_second(ok, _nodes=None):
            second["done"] = True
            if not ok:
                second["ok"] = False
            if first["done"]:
                on_done()

        def on_values(res):
            def cb(values: List[Value]) -> bool:
                for v in values:
                    on_value(v, res)
                return True
            return cb

        self.dht.get(p.get_prefix(mid).hash(), on_values(first),
                     get_done_first, self._pht_filter)
        if mid < p.size - 1:
            self.dht.get(p.get_prefix(mid + 1).hash(), on_values(second),
                         get_done_second, self._pht_filter)

    # ------------------------------------------------------------ insert
    def insert(self, key: Dict[str, bytes], value: Tuple[InfoHash, int],
               done_cb=None) -> None:
        """Index ``value`` under ``key`` (pht.h:346-360)."""
        p = self.linearize(key)
        entry = IndexEntry(p.content, value, self.name)
        self._insert(p, entry, {"lo": 0, "hi": p.size, "max_common": None},
                     _time.monotonic(), True, done_cb)

    def _insert(self, kp: Prefix, entry: IndexEntry, state: dict,
                time_p: float, check_split: bool, done_cb=None) -> None:
        """(pht.cpp:330-378)"""
        if time_p + USER_DATA_EXPIRATION < _time.monotonic():
            return
        vals: List[IndexEntry] = []
        final = {"prefix": None}

        def on_leaf(entries: List[IndexEntry], p: Prefix):
            final["prefix"] = p

        def real_insert(p: Prefix, e: IndexEntry):
            self.update_canary(p)
            self._check_pht_update(p, e, time_p)
            self.cache.insert(p)
            v = e.pack()
            self.dht.put(p.hash(), v,
                         (lambda ok, ns=None: done_cb(ok)) if done_cb
                         else None)

        def on_done(ok):
            if not ok:
                if done_cb:
                    done_cb(False)
                return
            fp = final["prefix"] or kp.get_prefix(0)
            if not check_split or fp.size == kp.size:
                real_insert(fp, entry)
            elif len(vals) < MAX_NODE_ENTRY_COUNT:
                self._get_real_prefix(fp, entry, real_insert)
            else:
                self._split(fp, vals, entry, real_insert)

        self._lookup_step(kp, state, vals, on_leaf, on_done,
                          start=self.cache.lookup(kp), all_values=True)

    def update_canary(self, p: Prefix) -> None:
        """Refresh this node's canary, its sibling's, and probabilistically
        the parents' (pht.cpp:299-328)."""
        # fixed id: repeated canary refreshes extend the same value's
        # lifetime instead of piling up distinct values at hot trie nodes
        v = Value(b"\xc0", value_id=1)
        v.user_type = self.canary

        def bubble(ok, _nodes=None):
            if p.size and self._rng.random() < 0.5:
                self.update_canary(p.get_prefix(-1))

        self.dht.put(p.hash(), v, bubble)
        if p.size:
            v2 = Value(b"\xc0", value_id=1)
            v2.user_type = self.canary
            self.dht.put(p.get_sibling().hash(), v2)

    def _get_real_prefix(self, p: Prefix, entry: IndexEntry,
                         end_cb) -> None:
        """Merge check: if parent+this+sibling hold < MAX entries, insert
        at the parent (pht.cpp:458-512)."""
        if p.size == 0:
            end_cb(p, entry)
            return
        parent = p.get_prefix(-1)
        counter = {"entries": 0, "ended": 0}

        def count(values: List[Value]) -> bool:
            counter["entries"] += sum(
                1 for v in values if v.user_type != self.canary)
            return True

        def on_done(ok, _nodes=None):
            counter["ended"] += 1
            if counter["ended"] == 3:
                if counter["entries"] < MAX_NODE_ENTRY_COUNT:
                    end_cb(parent, entry)
                else:
                    end_cb(p, entry)

        for target in (parent, p, p.get_sibling()):
            self.dht.get(target.hash(), count, on_done, self._pht_filter)

    def _check_pht_update(self, p: Prefix, entry: IndexEntry,
                          time_p: float) -> None:
        """Listen one level deeper: if a canary later appears there, the
        leaf split and our entry must be re-inserted deeper
        (pht.cpp:487-514)."""
        full = Prefix(entry.prefix)
        if p.size >= len(full.content) * 8:
            return
        next_prefix = full.get_prefix(p.size + 1)
        token_box = {}

        def on_values(values: List[Value], expired: bool = False) -> bool:
            if expired:
                return True
            for v in values:
                if v.user_type == self.canary:
                    self._insert(full, entry,
                                 {"lo": 0, "hi": full.size,
                                  "max_common": None},
                                 time_p, False, None)
                    tok = token_box.get("token")
                    if tok:
                        self.dht.cancel_listen(next_prefix.hash(), tok)
                    return False
            return True

        tok = self.dht.listen(next_prefix.hash(), on_values,
                              self._pht_filter)

        def record(t) -> None:
            # no live subscription: None = shed at ingest admission
            # (ingest backpressure), 0 = the callback consumed local
            # values and stopped.  Either way the insert itself already
            # completed — only the split watch degrades, so record
            # nothing rather than a bogus token
            if t:
                token_box["token"] = t
            else:
                log.debug("pht: no split-watch subscription for %s (%s)",
                          next_prefix.to_string(),
                          "shed" if t is None else "satisfied locally")

        if hasattr(tok, "add_done_callback"):
            # DhtRunner backend: listen returns a Future resolving to
            # the runner token (0 = shed) — never block the insert path
            tok.add_done_callback(
                lambda f: record(0 if f.exception() else f.result()))
        else:
            record(tok)

    @staticmethod
    def find_split_location(compared: Prefix,
                            vals: List[IndexEntry]) -> int:
        """First bit where ``compared`` diverges from every stored entry
        (pht.h:482-489)."""
        for i in range(len(compared.content) * 8 - 1):
            for e in vals:
                if (Prefix(e.prefix).is_content_bit_active(i)
                        != compared.is_content_bit_active(i)):
                    return i + 1
        return len(compared.content) * 8 - 1

    def _split(self, insert: Prefix, vals: List[IndexEntry],
               entry: IndexEntry, end_cb) -> None:
        """(pht.cpp:516-528)"""
        full = Prefix(entry.prefix)
        loc = self.find_split_location(full, vals)
        prefix_to_insert = full.get_prefix(loc)
        while loc != insert.size - 1 and loc > 0:
            self.update_canary(full.get_prefix(loc))
            loc -= 1
        end_cb(prefix_to_insert, entry)
