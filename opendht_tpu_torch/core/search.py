"""Batched iterative Kademlia lookup engine — the port of the JAX
package's ``core/search.py``.

The reference resolves each ``get()`` with a sequential state machine:
``Dht::searchStep`` (src/dht.cpp:561-654) keeps a sorted set of ≤ 14
candidates per target (``Search::insertNode``, src/search.h:636-722),
keeps α requests in flight, merges every reply's nodes back into the
set, and is done when the first k = 8 candidates have all replied
(``isSynced``, src/search.h:734-747).  Here the whole population of Q
concurrent lookups advances together, one round at a time: select the
next α unqueried candidates of every search, resolve all Q·α simulated
replies against the sorted node table with ONE fused gather, merge them
back with two sorts.

State (fixed shapes; "no candidate" = node -1; distances are key
tensors, ``ops/ids.py``):

    cand_node [Q, S]   int32   sorted-table row of each candidate
    cand_l    NL×[Q, S] int32  distance limb planes (the sort key)
    queried   [Q, S]   int32   request sent (= replied in this model)
    hops      [Q]      int32   rounds taken until convergence
    done      [Q]      bool

Network model (as in the JAX package): node x, asked for target t,
answers with k rows drawn from the prefix block sharing
``commonBits(x, t) + 1`` leading bits with t, or, when that block holds
fewer than k rows, the k rows of its slice of the α·k-wide window
around t's sorted position.  Replies are a counter hash of (seed, round,
global query id, slot), so runs are reproducible and a query's stream
does not depend on the others in its wave.

What the port does differently, and why the outputs stay bit-identical
to the JAX package's (``tests/test_torch_search.py``):

- *uint32 arithmetic.*  torch has no uint32 ``>>`` or products mod 2^32.
  ``_mix32`` and the reply counter run in int64 on the raw bits, masked
  to 32 bits; each product splits the constant in 16-bit halves
  (:func:`_mul32`) so no int64 product overflows.  ``_increment`` adds
  in int64 on unsigned values, so its carry test stays ``s == 0``.
  Prefix masks act on raw bits (un-flip, mask, re-flip), and
  ``_lut_block_bounds`` shifts the unsigned limb ``key + 2^31``.
- *The α-selection's fill.*  The masked max of ``cand_l[0]`` fills with
  the key of 0 (``FLIP``) under a signed max, so an unselected slot
  reads distance 0 and ``clz32`` gives 32, as in the JAX package.
- *The merge's sorts.*  The first sort's keys are every column, so any
  exact sort gives the same order: the port packs them into 64-bit keys
  (two stable passes at ``state_limbs=2``, four at 5).  The second sort
  only moves the rows the dedupe invalidated behind the rest, whose
  order it keeps; the port does that as one stable sort on the invalid
  flag.  Rows it sends to the tail are masked, as in the JAX package.
- *``lax.while_loop`` → a host loop.*  The loop condition reads
  ``all(done)``: one device→host sync per round.  A done row is a fixed
  point of the round, so the trajectory does not depend on when the
  loop stops.
- *``lax.cond``.*  ``_guarded_lower_bound``'s tier is a property of the
  table: decided once per call on the host (one sync before the loop).
  Its inner ``cond(any(eq64))`` always computes the correction, whose
  result is masked by ``eq64`` anyway: no sync.
- *Survivor compaction.*  ``jnp.nonzero(size=C, fill_value=0)`` is
  ``torch.nonzero`` cut or zero-padded to C (a sync).

The table-sharded twins (``tp_`` / ``dp_simulate_lookups``) live in
``parallel/sharded.py``.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from .. import telemetry, tracing
from .._device import resolve_device
from ..ops.ids import (FLIP, ID_BITS, KEY_MAX, N_LIMBS, as_keys, clz32,
                       common_bits, ids_to_bytes, xor_ids)
from ..ops.radix import prefix_masks
from ..ops.sorted_table import (_lex_lt, _lower_bound, _lut_bits,
                                build_prefix_lut, default_lut_bits,
                                fused_gather_planar, lut_budget_steps)
from ..ops.xor_topk import lexsort

ALPHA = 4            # in-flight requests per search (dht.h:321)
SEARCH_NODES = 14    # candidate set size (dht.h:308)
TARGET_NODES = 8     # convergence set (routing_table.h:26)

_I32 = torch.int32
_I64 = torch.int64
_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x·c mod 2^32 for int64 ``x`` in [0, 2^32) and 0 ≤ c < 2^32.  The
    constant goes in as two 16-bit halves, so no partial product leaves
    the int64 range (x·c itself may exceed 2^63)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """Counter-based uint32 hash (splitmix-style) for reply sampling.
    ``x``: int tensor of uint32 values (int64) or raw bits (int32) →
    int64 in [0, 2^32)."""
    x = x.to(_I64) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def _reply_counter(round_no: int, q_total: int, qidx: torch.Tensor,
                   alpha: int, k: int, seed_u: int) -> torch.Tensor:
    """``(((round·q_total + q)·α + a)·k + j) ^ seed`` mod 2^32 for every
    (query, slot a, entry j): int64 [W, α, k]."""
    dev = qidx.device
    ai = torch.arange(alpha, dtype=_I64, device=dev)[None, :, None]
    ji = torch.arange(k, dtype=_I64, device=dev)[None, None, :]
    c = (((round_no * q_total) & _M32)
         + (qidx.to(_I64) & _M32)[:, None, None]) & _M32
    c = (_mul32(c, alpha & _M32) + ai) & _M32
    c = (_mul32(c, k & _M32) + ji) & _M32
    return c ^ seed_u


def _increment(u: torch.Tensor) -> torch.Tensor:
    """160-bit +1 over [..., 5] limbs held as unsigned values in int64
    (wraps to zero).  On unsigned values the carry test is ``s == 0``
    (it would be ``s == FLIP`` on keys)."""
    out = []
    carry = torch.ones(u.shape[:-1], dtype=_I64, device=u.device)
    for i in range(N_LIMBS - 1, -1, -1):
        s = (u[..., i] + carry) & _M32
        carry = ((s == 0) & (carry == 1)).to(_I64)
        out.append(s)
    return torch.stack(out[::-1], dim=-1)


def _prefix_block_bounds(lower, n: int, targets, prefix_len):
    """[lo, ub) sorted-row range of ids sharing ``prefix_len`` leading
    bits with each target (key tensor [..., 5]); ``lower``: [M, 5] keys →
    [M] lower-bound rows.  Both edges go through one ``lower`` call."""
    masks = prefix_masks(prefix_len)                        # raw bits
    p_lo = (targets ^ FLIP) & masks
    p_hi_inc = _increment((p_lo | ~masks).to(_I64) & _M32)
    both = torch.cat([(p_lo ^ FLIP).reshape(-1, N_LIMBS),
                      (p_hi_inc - (1 << 31)).to(_I32).reshape(-1, N_LIMBS)])
    pos = lower(both)
    M = both.shape[0] // 2
    lo = pos[:M].reshape(targets.shape[:-1])
    ub = pos[M:].reshape(targets.shape[:-1])
    # an all-ones p_hi wraps to zero on increment: the block runs to n
    wrapped = (p_hi_inc == 0).all(dim=-1)
    return lo, torch.where(wrapped, n, ub)


def _lut_block_bounds(lut, t0, prefix_len):
    """[lo, ub) sorted-row range of ids sharing ``prefix_len`` leading
    bits with targets whose first limb key is ``t0`` — two reads of the
    prefix LUT, no search.  Exact up to the LUT width; deeper prefixes
    clamp to their LUT bucket (see the JAX package's docstring)."""
    bits = _lut_bits(lut)
    shift = bits - prefix_len.clamp(0, bits).to(_I64)
    top = (t0.to(_I64) + (1 << 31)) >> (32 - bits)     # unsigned top bits
    pfx = (top >> shift) << shift
    edges = torch.stack([pfx, pfx + (torch.ones_like(shift) << shift)])
    g = lut[edges]
    return g[0], g[1]


def _guarded_lower_bound(sorted_ids, n: int, lut):
    """Positioning closure ``lower(flat [M, 5]) → [M]``: the 64-bit LUT
    search plus one exact correction when every LUT bucket fits the
    in-bucket budget and no two adjacent valid rows share their top 64
    bits; the full-limb LUT search when only the first holds; the
    full-depth search otherwise.  The tier is a property of the table,
    decided here once (one device→host sync) instead of by ``lax.cond``
    at every call."""
    N = sorted_ids.shape[0]
    steps = lut_budget_steps(N, _lut_bits(lut))
    lut_ok = (lut[1:] - lut[:-1]).max() <= (1 << min(steps - 1, 30))
    if N > 1:
        adj_valid = torch.arange(1, N, device=sorted_ids.device) < n
        s0, s1 = sorted_ids[:, 0], sorted_ids[:, 1]
        tie64 = ((s0[1:] == s0[:-1]) & (s1[1:] == s1[:-1])
                 & adj_valid).any()
    else:
        tie64 = torch.zeros((), dtype=torch.bool, device=sorted_ids.device)
    lut_ok, tie64 = torch.stack([lut_ok, tie64]).tolist()

    def fast(q):
        lb = _lower_bound(sorted_ids, q, n, lut=lut, lut_steps=None,
                          limbs=2)
        # row[lb] < q only when the row's top 64 bits equal the probe's;
        # the JAX package fetches limbs 2..4 only when some row does
        # (lax.cond), the port always does and masks by eq64
        g = sorted_ids[lb.clamp(0, N - 1).long()]
        eq64 = (g[:, 0] == q[:, 0]) & (g[:, 1] == q[:, 1]) & (lb < n)
        lt = _lex_lt([g[:, l] for l in range(2, N_LIMBS)],
                     [q[:, l] for l in range(2, N_LIMBS)], N_LIMBS - 2)
        return torch.clamp(lb + (eq64 & lt).to(_I32), max=n)

    if lut_ok and not tie64:
        return fast
    if lut_ok:
        return lambda q: _lower_bound(sorted_ids, q, n, lut=lut,
                                      lut_steps=None)
    return lambda q: _lower_bound(sorted_ids, q, n)


class _StageClock:
    """One wave's host time by stage, on one ``time.perf_counter`` clock.

    :meth:`to` ends the open stage and starts the next at ONE reading:
    the time since the previous reading goes to the stage that was open,
    and the ``torch.profiler`` annotation ``search.<stage>`` is left and
    entered at that same point.  So the stages partition the wave's host
    time with nothing left over, and each idle stretch of a device trace
    lies under the stage that the histograms charge it to.
    :meth:`label` annotates a part of the open stage whose time stays
    the stage's (the bootstrap's gather and merge).

    ``seconds``: host seconds per stage entered.  ``rounds``: one
    ``[start, launch_s, sync_s]`` per loop iteration — from its
    ``select`` to the end of its ``done`` (issuing the round), then the
    ``sync`` read right after it (0 when the loop stops on its round
    cap instead).  ``syncs``: the wave's host syncs, one added at each
    by the code that makes it.  ``timed=False`` (the registry disabled)
    keeps the annotations and reads no clock."""

    def __init__(self, timed: bool = True):
        self.timed = timed
        self.seconds: dict = {}
        self.rounds: list = []
        self.syncs = 0
        self.stage = None
        self.t = 0.0                  # the last reading
        self._tail = False            # the open stage follows a "done"
        self._ann: list = []          # open annotations, innermost last

    def to(self, stage) -> None:
        """End the open stage and start ``stage`` (None: stop)."""
        if stage == self.stage:
            return
        while self._ann:
            self._ann.pop().__exit__(None, None, None)
        if self.timed:
            now = time.perf_counter()
            prev = self.stage
            if prev is not None:
                dt = now - self.t
                self.seconds[prev] += dt
                if prev == "done":
                    self.rounds[-1][1] = now - self.rounds[-1][0]
                elif prev == "sync" and self._tail:
                    self.rounds[-1][2] = dt
            self._tail = prev == "done"
            if stage is not None:
                self.seconds.setdefault(stage, 0.0)
                if stage == "select":
                    self.rounds.append([now, 0.0, 0.0])
            self.t = now
        self.stage = stage
        if stage is not None:
            self.label(stage)

    def label(self, name: str) -> None:
        """Annotate what follows, inside the open stage, as
        ``search.<name>``; its time stays the stage's."""
        if len(self._ann) > 1:
            self._ann.pop().__exit__(None, None, None)
        ann = record_function("search." + name)
        ann.__enter__()
        self._ann.append(ann)


def _merge_order(inv, d_l, node, nq):
    """Row order of the merge's first sort, by (inv, d_0..d_{NL-1}, node,
    1-queried).  Every column is a key, so any exact sort gives this
    order; the fields (as unsigned 32-bit values) are packed two per
    int64 key, from the least significant end, and sorted with chained
    stable passes."""
    fields = ([inv.to(_I64)] + [d.to(_I64) + (1 << 31) for d in d_l]
              + [(node.to(_I64) + 1) * 2 + nq])
    keys = []
    while fields:
        lo = fields.pop()
        if fields:
            lo = (fields.pop() - (1 << 31)) * (1 << 32) + lo
        keys.append(lo)
    return lexsort(keys[::-1], dim=1)


def _lookup_engine(gather_planar, lower, n, targets, q_index, q_total,
                   seed_u, *, k, alpha, search_nodes, max_hops,
                   state_limbs: int = N_LIMBS,
                   compact_after: "int | None" = None,
                   compact_cap: int = 0,
                   block_bounds=None, clock: "_StageClock | None" = None):
    """The iterative-lookup state machine, abstracted over table access.

    All access to the sorted node table goes through injected
    primitives, the seam a sharded engine plugs into:

      gather_planar(rows [...], limbs) -> ``limbs`` key planes shaped
          like ``rows``; lanes of rows out of [0, n) may hold anything
          (every caller masks them).
      lower(flat [M, 5]) -> [M] int32 lower-bound rows.
      block_bounds(t0, prefix_len) -> (lo, ub) prefix-block edges, or
          None for the exact search through ``lower``.

    ``n``: valid rows (a host int).  ``targets`` [Q, 5] keys;
    ``q_index`` [Q] each query's GLOBAL index and ``q_total`` the global
    batch size — the reply streams key on them, so a query gives the
    same result in any wave or sub-batch.  ``seed_u``: the seed as a
    uint32 value.  ``state_limbs`` 5 (exact order) or 2 (rank by the top
    64 distance bits; identical unless two candidates tie on them).
    ``compact_after``/``compact_cap``: survivor compaction after that
    many rounds (bit-identical to the plain loop, see the JAX package).

    ``clock``: the wave's :class:`_StageClock`, which the engine moves
    through ``prepare`` (the targets' positions, the state's fills),
    ``bootstrap``, per loop iteration ``select``, ``reply``, ``gather``,
    ``merge``, ``done`` and the ``sync`` read of the loop condition,
    ``compact`` around a survivor compaction, and ``finish`` (the
    closing gathers), counting its reads of device values in
    ``clock.syncs``.  None: an untimed clock of its own, for the
    profiler's labels alone.
    """
    own = clock is None
    if own:
        clock = _StageClock(timed=False)
    clock.to("prepare")
    Q = targets.shape[0]
    S = search_nodes
    R = alpha * k            # reply entries merged per round
    NL = state_limbs
    dev = targets.device
    n = int(n)
    empty = n <= 0
    slot = (torch.arange(alpha, dtype=_I64, device=dev)[:, None] * k
            + torch.arange(k, dtype=_I64, device=dev)[None, :])   # [α, k]

    pos_t_full = lower(targets)                        # [Q], fallback replies

    def reply_gather(tgt, pt, qidx, x_rows, round_no, x_d0=None):
        """Simulated answers of the α queried nodes of each search:
        x_rows [W, α] (-1 = no request) → reply rows [W, R].  ``x_d0``:
        the queried peers' raw top distance bits, carried from the
        candidate state (None: gather them, as the bootstrap does)."""
        W = tgt.shape[0]
        if block_bounds is not None:
            if x_d0 is None:
                x_d0 = gather_planar(x_rows, 1)[0] ^ tgt[:, 0:1]
            b = clz32(x_d0)                       # clz32(0) == 32
            lo, ub = block_bounds(tgt[:, 0:1], b + 1)
        else:
            x = torch.stack(gather_planar(x_rows, N_LIMBS), dim=-1)
            b = common_bits(x, tgt[:, None, :])
            lo, ub = _prefix_block_bounds(
                lower, n, tgt[:, None, :].expand(-1, x_rows.shape[1], -1),
                (b + 1).clamp(0, ID_BITS))
        size = (ub - lo).clamp(min=0)                                 # [W,α]
        h = _mix32(_reply_counter(round_no, q_total, qidx, alpha, k,
                                  seed_u))                          # [W,α,k]
        blk = lo[..., None] + (h % size[..., None].clamp(min=1)).to(_I32)
        # block too small: the slot's k-slice of the α·k-wide window
        # straddling the target's position
        base = torch.clamp(pt[:, None, None] - R // 2, min=0).clamp(
            max=max(n - R, 0))
        fb = (base + slot).clamp(0, max(n - 1, 0)).to(_I32)
        rows = torch.where(size[..., None] >= k, blk, fb)
        rows = torch.where((x_rows >= 0)[..., None], rows, -1)
        return rows.reshape(W, R)

    def merge(tgt, cand_node, cand_l, queried, new_rows, mark):
        """Insert replies, dedupe by node, keep the S closest
        (↔ Search::insertNode, src/search.h:636-722).  ``mark``: the
        clock's ``to`` in the loop, its ``label`` in the bootstrap."""
        W = tgt.shape[0]
        mark("gather")
        new_l = gather_planar(new_rows, NL)
        mark("merge")
        node = torch.cat([cand_node, new_rows], dim=1)         # [W, S+R]
        inv = node < 0
        d_l = [torch.where(inv, KEY_MAX, torch.cat(
            [cand_l[l], xor_ids(new_l[l], tgt[:, l:l + 1])], dim=1))
            for l in range(NL)]
        qd = torch.cat([queried, torch.zeros((W, R), dtype=_I32,
                                             device=dev)], dim=1)
        # order by (invalid, dist, node, not-queried): among copies of a
        # node the queried one comes first
        perm = _merge_order(inv, d_l, node, 1 - qd)
        inv_s = torch.gather(inv, 1, perm)
        node_s = torch.gather(node, 1, perm)
        qd_s = torch.gather(qd, 1, perm)
        d_s = [torch.gather(d, 1, perm) for d in d_l]
        # dedupe: copies of a node are adjacent (same distance)
        dup = torch.cat([torch.zeros((W, 1), dtype=torch.bool, device=dev),
                         (node_s[:, 1:] == node_s[:, :-1])
                         & (node_s[:, 1:] >= 0)], dim=1)
        inv2 = (inv_s | dup).to(_I32)
        # the JAX package's second sort: the rows still valid keep their
        # order, the rest go behind them (and are masked)
        keep = torch.sort(inv2, dim=1, stable=True).indices[:, :S]
        present = torch.gather(inv2, 1, keep) == 0
        node_f = torch.where(present, torch.gather(node_s, 1, keep), -1)
        d_f = [torch.where(present, torch.gather(d, 1, keep), KEY_MAX)
               for d in d_s]
        qd_f = torch.where(present, torch.gather(qd_s, 1, keep), 0)
        return node_f, d_f, qd_f

    # -- bootstrap: one pseudo-random bootstrap peer per search ----------
    boot = torch.full((Q, alpha), -1, dtype=_I32, device=dev)
    if not empty:
        boot[:, 0] = (_mix32((q_index.to(_I64) & _M32) ^ seed_u)
                      % max(n, 1)).to(_I32)
    cand_node = torch.full((Q, S), -1, dtype=_I32, device=dev)
    cand_l = [torch.full((Q, S), KEY_MAX, dtype=_I32, device=dev)
              for _ in range(NL)]
    queried = torch.zeros((Q, S), dtype=_I32, device=dev)
    clock.to("bootstrap")
    first = reply_gather(targets, pos_t_full, q_index, boot, 0)
    cand_node, cand_l, queried = merge(targets, cand_node, cand_l, queried,
                                       first, clock.label)

    def synced(cand_node, queried):
        """First min(k, #candidates) candidates all answered
        (↔ isSynced, search.h:734-747)."""
        present = cand_node[:, :k] >= 0
        return (~present | (queried[:, :k] > 0)).all(dim=1) \
            & present.any(dim=1)

    def make_body(tgt, pt, qidx):
        def body(state):
            cand_node, cand_l, queried, hops, done, round_no = state
            clock.to("select")
            # the closest α unqueried candidates of each active search
            # (↔ searchSendGetValues, src/dht.cpp:628-639)
            can = (cand_node >= 0) & (queried == 0) & ~done[:, None]
            rank = torch.cumsum(can.to(_I32), dim=1, dtype=_I32)
            sel = can & (rank <= alpha)
            picks = [sel & (rank == j + 1) for j in range(alpha)]
            x_rows = torch.stack(
                [torch.where(p, cand_node, -1).amax(dim=1) for p in picks],
                dim=1)
            x_d0 = None
            if block_bounds is not None:
                # the picked peers' top distance limb rides the same
                # masked maxima; fill = the key of distance 0, so an
                # unpicked slot reads raw 0 (clz32 = 32), as in JAX
                x_d0 = torch.stack([torch.where(p, cand_l[0], FLIP)
                                    .amax(dim=1) for p in picks],
                                   dim=1) ^ FLIP
            queried = torch.where(sel, 1, queried)
            clock.to("reply")
            new_rows = reply_gather(tgt, pt, qidx, x_rows, round_no + 1,
                                    x_d0)
            cand_node, cand_l, queried = merge(tgt, cand_node, cand_l,
                                               queried, new_rows, clock.to)
            clock.to("done")
            now_done = synced(cand_node, queried)
            stalled = ~((cand_node >= 0) & (queried == 0)).any(dim=1)
            sent = sel.any(dim=1)
            # a stalling round sends nothing and costs no hop
            hops = torch.where(~done & sent, hops + 1, hops)
            done = done | now_done | stalled
            return cand_node, cand_l, queried, hops, done, round_no + 1
        return body

    def all_done(done):
        # lax.while_loop's condition: one device→host read per round
        clock.to("sync")
        clock.syncs += 1
        return bool(done.all())

    def run(body, state, stop_round):
        while state[5] < stop_round and not all_done(state[4]):
            state = body(state)
        return state

    body_full = make_body(targets, pos_t_full, q_index)
    done0 = synced(cand_node, queried) | empty
    state = (cand_node, cand_l, queried,
             torch.zeros((Q,), dtype=_I32, device=dev), done0, 0)

    if compact_after is None:
        cand_node, cand_l, queried, hops, done, _ = run(body_full, state,
                                                         max_hops)
    else:
        cut = min(compact_after, max_hops)
        cand_node, cand_l, queried, hops, done, rnd = run(body_full, state,
                                                           cut)
        # pack the survivors into a cap-wide sub-batch, padded with row 0
        clock.to("compact")
        C = compact_cap or max(1, Q // 2)
        alive = torch.nonzero(~done).reshape(-1)[:C]
        clock.syncs += 1
        sel_rows = torch.zeros(C, dtype=_I64, device=dev)
        sel_rows[:alive.numel()] = alive
        live = (~done)[sel_rows]

        def sub(a):
            return a[sel_rows]

        body_sub = make_body(sub(targets), sub(pos_t_full), sub(q_index))
        cn2, cl2, qd2, hp2, dn2, _ = run(
            body_sub, (sub(cand_node), [sub(cl) for cl in cand_l],
                       sub(queried), sub(hops), ~live, rnd), max_hops)
        # scatter back.  Fill rows repeat row 0: live, they ran row 0's
        # own trajectory; done, they write row 0's values back.  Either
        # way every write to a repeated index carries the same values, so
        # index_put_ with duplicate indices is deterministic.
        clock.to("compact")
        lv = live[:, None]
        cand_node[sel_rows] = torch.where(lv, cn2, sub(cand_node))
        for cl, c2 in zip(cand_l, cl2):
            cl[sel_rows] = torch.where(lv, c2, sub(cl))
        queried[sel_rows] = torch.where(lv, qd2, sub(queried))
        hops[sel_rows] = torch.where(live, hp2, sub(hops))
        done[sel_rows] = torch.where(live, dn2, sub(done))
        # safety net for cap overflow, resuming AT THE CUT round so the
        # overflow rows replay the streams the plain loop gives them
        # (zero rounds when the cap held)
        cand_node, cand_l, queried, hops, done, _ = run(
            body_full, (cand_node, cand_l, queried, hops, done, rnd),
            max_hops)

    clock.to("finish")
    nodes_k = cand_node[:, :k].contiguous()
    if NL == N_LIMBS:
        dist = torch.stack([cl[:, :k] for cl in cand_l], dim=-1)
    else:
        # the full distances from the final node ids, in one gather
        id_l = gather_planar(nodes_k, N_LIMBS)
        dist = torch.stack(
            [torch.where(nodes_k >= 0, xor_ids(id_l[l], targets[:, l:l + 1]),
                         KEY_MAX) for l in range(N_LIMBS)], dim=-1)
    converged = synced(cand_node, queried)
    if empty:
        converged = torch.zeros_like(converged)
    if own:
        clock.to(None)
    return {"nodes": nodes_k, "dist": dist, "hops": hops,
            "converged": converged}


def table_primitives(sorted_ids, n_valid, lut, block_mode: str = "lut"):
    """The single-device ``(gather_planar, lower, block_bounds)`` of
    :func:`_lookup_engine` over a sorted key table and its prefix LUT."""
    if block_mode not in ("lut", "exact"):
        raise ValueError(f"block_mode must be 'lut' or 'exact', "
                         f"got {block_mode!r}")

    def gather_planar(rows, limbs=N_LIMBS):
        return fused_gather_planar(sorted_ids, rows, limbs)

    block_bounds = None
    if block_mode == "lut":
        def block_bounds(t0, prefix_len):
            return _lut_block_bounds(lut, t0, prefix_len)
    return (gather_planar, _guarded_lower_bound(sorted_ids, int(n_valid),
                                                lut), block_bounds)


def _simulate_lookups(sorted_ids, n_valid, targets, *, seed: int = 0,
                      k: int = TARGET_NODES, alpha: int = ALPHA,
                      search_nodes: int = SEARCH_NODES, max_hops: int = 48,
                      lut=None, state_limbs: int = N_LIMBS,
                      compact_after: "int | None" = None,
                      compact_cap: int = 0, block_mode: str = "lut",
                      clock: "_StageClock | None" = None):
    """Core of :func:`simulate_lookups` on key tensors of one device.
    ``clock``: as in :func:`_lookup_engine`; the prefix table's build
    and the positioning tier's decision (one read) are ``prepare``."""
    own = clock is None
    if own:
        clock = _StageClock(timed=False)
    clock.to("prepare")
    if lut is None:
        lut = build_prefix_lut(sorted_ids, n_valid,
                               bits=default_lut_bits(sorted_ids.shape[0]))
    gather_planar, lower, block_bounds = table_primitives(
        sorted_ids, n_valid, lut, block_mode)
    clock.syncs += 1                    # _guarded_lower_bound's tier
    Q = targets.shape[0]
    out = _lookup_engine(
        gather_planar, lower, int(n_valid), targets,
        torch.arange(Q, dtype=_I32, device=targets.device), Q, seed & _M32,
        k=k, alpha=alpha, search_nodes=search_nodes, max_hops=max_hops,
        state_limbs=state_limbs, compact_after=compact_after,
        compact_cap=compact_cap, block_bounds=block_bounds, clock=clock)
    if own:
        clock.to(None)
    return out


_TRACE_MAX_ROUND_SPANS = 64


def record_wave(out, elapsed_s: float, wave_width: int, *,
                mode: str = "single", mesh_t: int = 1,
                clock: "_StageClock | None" = None) -> None:
    """Feed one finished search wave into the telemetry registry
    (``dht_search_wave_seconds``, ``dht_search_wave_width``,
    ``dht_search_hops``, and ``dht_search_round_seconds`` = wave time /
    deepest hop count) and the waterfall's device stage (split
    compile-vs-execute per launch shape, mode x width); when a trace
    context is active, record one ``dht.search.wave`` span carrying the
    kernel ledger's device-cost attributes (``profiling.wave_attrs``,
    empty until the ledger is computed; ``mesh_t`` = the table shards a
    tp wave ran over).

    With the wave's stage ``clock`` (open in its ``record`` stage, which
    this call ends): one ``dht_search_stage_seconds{stage}`` observation
    per stage entered, ``dht_search_rounds_total`` (loop iterations,
    stalled ones included) and ``dht_search_host_syncs_total``; and
    under a trace context one ``dht.search.round`` child per iteration
    (the first 64), each at its measured start and duration with
    ``launch_s`` and ``sync_s``, the clock's readings moved to the
    tracer's ``time.time`` by one offset taken here.  Without a clock
    (the tp wave) no stage series and no round spans.
    Host-side only: the wave ran before this call."""
    reg = telemetry.get_registry()
    reg.histogram("dht_search_wave_seconds", mode=mode).observe(elapsed_s)
    reg.histogram("dht_search_wave_width", mode=mode).observe(wave_width)
    hops = out["hops"].cpu().numpy()
    if clock is not None:
        clock.syncs += 1
    reg.histogram("dht_search_hops", mode=mode).observe_many(hops)
    rounds = int(hops.max()) if hops.size else 0
    if rounds > 0:
        reg.histogram("dht_search_round_seconds", mode=mode).observe(
            elapsed_s / rounds)
    tr = tracing.get_tracer()
    ctx = tracing.current()
    # the search wave IS the device stage of every op it carries: feed
    # the waterfall the same timed span, the first launch of each shape
    # as device_compile (the port builds its kernels at first use)
    from .. import waterfall
    wf = waterfall.get_profiler()
    if wf.enabled:
        key = ("search", mode, int(wave_width))
        stage = ("device_compile" if wf.first_launch(key)
                 else "device_wait")
        wf.observe(stage, elapsed_s,
                   exemplar=tracing.current_trace_hex())
    if tr.enabled and ctx is not None:
        if clock is None:
            start = time.time() - elapsed_s
        else:
            off = time.time() - time.perf_counter()
            start = clock.t + off - elapsed_s
        from .. import profiling
        cost = profiling.wave_attrs(int(wave_width), rounds, elapsed_s,
                                    mode=mode, mesh_t=mesh_t)
        wave_ctx = tr.record("dht.search.wave", start, elapsed_s,
                             parent=ctx, mode=mode, width=int(wave_width),
                             rounds=rounds, **cost)
        if wave_ctx is not None and clock is not None:
            for i, (t0, launch_s, sync_s) in enumerate(
                    clock.rounds[:_TRACE_MAX_ROUND_SPANS]):
                tr.record("dht.search.round", t0 + off, launch_s + sync_s,
                          parent=wave_ctx, mode=mode, round=i,
                          launch_s=launch_s, sync_s=sync_s)
    if clock is not None:
        clock.to(None)
        for stage, s in clock.seconds.items():
            reg.histogram("dht_search_stage_seconds", mode=mode,
                          stage=stage).observe(s)
        reg.counter("dht_search_rounds_total", mode=mode).inc(
            len(clock.rounds))
        reg.counter("dht_search_host_syncs_total", mode=mode).inc(
            clock.syncs)


def _host_uploads(dev, *xs) -> int:
    """Host→card copies that moving ``xs`` to ``dev`` makes: each blocks
    the host until the card's stream has drained (a pageable copy)."""
    if dev.type != "cuda":
        return 0
    return sum(1 for x in xs if x is not None
               and not (isinstance(x, torch.Tensor) and x.is_cuda))


def simulate_lookups(sorted_ids, n_valid, targets, *, device=None, **kw):
    """Run Q iterative lookups to convergence.

    Args:
      sorted_ids: [N, 5] lexicographically sorted network ids, a key
                  tensor or uint32 numpy (node identity = sorted row).
      n_valid:    number of real rows of ``sorted_ids``.
      targets:    [Q, 5] lookup keys, a key tensor or uint32 numpy.
      device:     where the engine runs; None = the CUDA card (raises
                  without one).
      seed, k, alpha, search_nodes, max_hops, lut, state_limbs,
      compact_after, compact_cap, block_mode: as in the JAX package.

    Returns a dict of tensors on the device: ``nodes`` [Q, k] int32
    sorted rows (-1 none), ``dist`` [Q, k, 5] distance keys
    (``ops.ids.from_keys`` gives the JAX package's uint32), ``hops``
    [Q] int32, ``converged`` [Q] bool.

    Stage clock: with the registry enabled, one :class:`_StageClock`
    times the call from end to end, in stages that partition it:
    ``upload`` (the inputs to the device), the engine's (``prepare`` to
    ``finish``, which ends with a device synchronize on the card) and
    ``record`` (:func:`record_wave`).  The wave's time,
    ``dht_search_wave_seconds``, is the stages from ``prepare`` to
    ``finish``.  Each stage is a ``torch.profiler`` annotation
    ``search.<stage>`` too; with the registry disabled only those remain:
    no clock is read, no series written.  Host-side only: results are
    bit-identical with telemetry on or off.
    """
    dev = resolve_device(device)
    reg = telemetry.get_registry()
    clock = _StageClock(timed=reg.enabled)
    clock.to("upload")
    clock.syncs += _host_uploads(dev, sorted_ids, targets, kw.get("lut"))
    sorted_ids, targets = as_keys(sorted_ids, dev), as_keys(targets, dev)
    if kw.get("lut") is not None:
        kw["lut"] = kw["lut"].to(dev)
    out = _simulate_lookups(sorted_ids, n_valid, targets, clock=clock, **kw)
    if not reg.enabled:
        clock.to(None)
        return out
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        clock.syncs += 1
    clock.to("record")
    elapsed = sum(clock.seconds.values()) - clock.seconds["upload"]
    record_wave(out, elapsed, targets.shape[0], mode="single", clock=clock)
    return out


# ---------------------------------------------------------------------------
# Scalar reference (oracle for hop-count parity): the same network model
# in sequential python, one lookup at a time — a copy of the JAX
# package's, pure numpy.
# ---------------------------------------------------------------------------

def scalar_lookup(sorted_ids_np: np.ndarray, n: int, target_np: np.ndarray,
                  *, seed: int = 0, k: int = TARGET_NODES, alpha: int = ALPHA,
                  search_nodes: int = SEARCH_NODES, max_hops: int = 48,
                  rng=None):
    """Sequential lookup with the same candidate-set/α/convergence
    semantics and the same network reply model as simulate_lookups (reply
    sampling is random rather than counter-hashed, so parity is
    statistical, not bitwise).  ``sorted_ids_np`` and ``target_np`` are
    uint32 numpy.  Returns (nodes, hops, converged)."""
    if rng is None:
        rng = np.random.default_rng(seed)

    def row_int(i):
        return int.from_bytes(ids_to_bytes(sorted_ids_np[i]).tobytes(), "big")

    t_int = int.from_bytes(ids_to_bytes(target_np).tobytes(), "big")

    def lower_bound(v: int) -> int:
        lo, hi = 0, n
        while lo < hi:
            mid = (lo + hi) // 2
            if row_int(mid) < v:
                lo = mid + 1
            else:
                hi = mid
        return lo

    pos_t = lower_bound(t_int)

    def reply(x_row: int) -> list:
        x_int = row_int(x_row)
        cb = 160 - (x_int ^ t_int).bit_length() if x_int != t_int else 160
        plen = min(cb + 1, 160)
        mask = ((1 << plen) - 1) << (160 - plen) if plen else 0
        p_lo = t_int & mask
        p_hi = p_lo | ((1 << (160 - plen)) - 1)
        lo = lower_bound(p_lo)
        ub = lower_bound(p_hi + 1)
        size = ub - lo
        if size >= k:
            return [lo + int(v) for v in rng.integers(0, size, k)]
        R = alpha * k
        base = min(max(pos_t - R // 2, 0), max(n - R, 0))
        j = int(rng.integers(0, alpha))          # this peer's window slice
        return [min(base + j * k + jj, n - 1) for jj in range(k)]

    # candidate set: list of (dist, row, queried, replied)
    cands: dict[int, list] = {}

    def insert(row):
        if row in cands:
            return
        cands[row] = [row_int(row) ^ t_int, row, False, False]

    boot = int(rng.integers(0, n))
    for r in reply(boot):
        insert(r)

    hops = 0
    while hops < max_hops:
        ordered = sorted(cands.values())[:search_nodes]
        cands = {c[1]: c for c in ordered}
        topk = ordered[:k]
        if topk and all(c[3] for c in topk):
            return [c[1] for c in topk], hops, True
        to_query = [c for c in ordered if not c[2]][:alpha]
        if not to_query:
            return [c[1] for c in topk], hops, False
        hops += 1
        for c in to_query:
            c[2] = c[3] = True
            for r in reply(c[1]):
                insert(r)
    ordered = sorted(cands.values())[:k]
    return [c[1] for c in ordered], hops, False
