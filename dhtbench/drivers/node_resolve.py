"""Closed loop of batched closest-node resolves on a node's table, with
``depth`` batches in flight: each batch's targets go to
``core/table.py`` ``NodeTable.find_closest_launch`` as host uint32 ids,
and ``PendingLookup.consume`` brings rows and distances back to the host.

The table is ``nodes`` uniform ids loaded with ``NodeTable.bulk_load`` at
a fixed ``now``.  With ``inserts`` / ``removes`` above zero, every batch
is preceded by a round of churn: that many fresh ids ``bulk_load``-ed,
then that many ids live before the round ``remove``-d, drawn from the
seed.  The check computes the exact k XOR-closest ids live at each
captured call (``reference/topk.py``) and compares every answer of the
call by its distances, and a sample of its answers by their rows.

Controls (``--control``), each judged in the program's place:
``rank32``, the k closest live ids ranked by the top 32 bits of the
distance alone (a one-limb select), ties in sorted order; and
``stale_table``, the exact answers over the ids live one round earlier.
"""

from __future__ import annotations

import collections
import time

import numpy as np

from dhtbench.reference import inputs
from dhtbench.reference.topk import exact_topk

CONTROLS = (None, "rank32", "stale_table")
NEVER = np.iinfo(np.int64).max


class Driver:
    def __init__(self, params: dict, seed: int, device, control=None):
        if control not in CONTROLS:
            raise ValueError(f"node_resolve has no control {control!r}")
        self.p = params
        self.seed = seed
        self.device = device
        self.control = control
        self.next_call = 0
        self.first_window_call = None
        self.kept: list = []

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from opendht_tpu_torch.core.table import NodeTable
        from opendht_tpu_torch.infohash import InfoHash
        from opendht_tpu_torch.ops import ids as IK
        from dhtbench.window import Window
        p = self.p
        rng = inputs.stream(self.seed, inputs.TABLE)
        ids = inputs.uniform_ids(rng, p["nodes"])
        me = IK.ids_to_bytes(inputs.uniform_ids(rng, 1))[0].tobytes()
        self.table = NodeTable(InfoHash(me), device=self.device)
        self.table.bulk_load(ids, now=p["now"])
        # every id the table held at any call: its limbs, the round it
        # came in (-1 at set-up) and the round it left; ``held`` of them
        # in use, the arrays grown by doubling (no copy per round)
        self.ids = ids
        self.came = np.full(len(ids), -1, dtype=np.int64)
        self.left = np.full(len(ids), NEVER, dtype=np.int64)
        self.held = len(ids)
        self.live = np.arange(len(ids), dtype=np.int64)
        self.mutations = inputs.stream(self.seed, inputs.MUTATIONS)
        self.run(Window(), calls=p["warm_calls"])

    # ------------------------------------------------------------- calls
    def _churn(self, win, call: int) -> None:
        """One round: ``inserts`` fresh ids in, ``removes`` ids that were
        live before the round out."""
        from opendht_tpu_torch.infohash import InfoHash
        from opendht_tpu_torch.ops import ids as IK
        p = self.p
        fresh = inputs.uniform_ids(self.mutations, p["inserts"])
        pos = self.mutations.choice(len(self.live), p["removes"],
                                    replace=False)
        gone = self.live[pos]
        hashes = [InfoHash(b.tobytes())
                  for b in IK.ids_to_bytes(self.ids[gone])]
        with win.span("mutate"):
            self.table.bulk_load(fresh, now=p["now"])
            for h in hashes:
                self.table.remove(h)
        self.left[gone] = call
        first, self.held = self.held, self.held + len(fresh)
        if self.held > len(self.ids):
            grow = len(self.ids)
            self.ids = np.concatenate([self.ids, np.zeros_like(self.ids)])
            self.came = np.concatenate([self.came, np.zeros(grow, np.int64)])
            self.left = np.concatenate([self.left,
                                        np.full(grow, NEVER, np.int64)])
        self.ids[first:self.held] = fresh
        self.came[first:self.held] = call
        # drop the removed positions: the tail's survivors fill the holes,
        # the fresh ids take the tail
        keep = len(self.live) - len(pos)
        tail = np.arange(keep, len(self.live))
        self.live[pos[pos < keep]] = self.live[tail[~np.isin(tail, pos)]]
        new = np.arange(first, self.held)
        if len(new) == len(pos):
            self.live[keep:] = new
        else:
            self.live = np.concatenate([self.live[:keep], new])

    def _consume(self, win, call: int, handoff: float, pending) -> None:
        p = self.p
        with win.span("consume"):
            rows, dist = pending.consume()
        win.call(handoff, len(rows), len(rows))
        if win.capture and (call == self.first_window_call or inputs.captured(
                self.seed, call, p["capture_every"])):
            # rows are slab rows, reused after a removal: read the ids of
            # a sample of them now, while they still hold this call's ids
            sample = np.sort(inputs.stream(self.seed, inputs.CAPTURE, call)
                             .choice(len(rows), min(p["rows_sample"],
                                                    len(rows)),
                                     replace=False))
            held = self.table.ids_of_rows(rows[sample])
            raw = b"".join(bytes(h) if h is not None else b"\xff" * 20
                           for h in held)
            row_ids = np.frombuffer(raw, dtype=">u4").astype(
                np.uint32).reshape(len(sample), -1, 5)
            self.kept.append((call, dist, sample, row_ids))

    def run(self, win, *, until=None, calls=None) -> None:
        """Calls until ``until`` (``time.perf_counter``) or ``calls``
        calls, ``depth`` in flight; then drains."""
        p = self.p
        if win.capture and self.first_window_call is None:
            self.first_window_call = self.next_call
        flight = collections.deque()
        done = 0
        while (calls is None or done < calls) and \
                (until is None or time.perf_counter() < until):
            call = self.next_call
            self.next_call += 1
            done += 1
            if p["inserts"] or p["removes"]:
                self._churn(win, call)
            targets, _ = inputs.call_targets(self.seed, call, p["batch"])
            handoff = time.perf_counter()
            with win.span("launch"):
                pending = self.table.find_closest_launch(
                    targets, k=p["k"], now=p["now"])
            flight.append((call, handoff, pending))
            if len(flight) >= p["depth"]:
                self._consume(win, *flight.popleft())
        while flight:
            self._consume(win, *flight.popleft())

    # ------------------------------------------------------------- check
    def release(self) -> None:
        del self.table

    def _live_at(self, call: int) -> np.ndarray:
        h = self.held
        return self.ids[:h][(self.came[:h] <= call) & (self.left[:h] > call)]

    def verify(self) -> tuple:
        """(numbers compared, what was compared)."""
        p = self.p
        wrong = compared = 0
        for call, dist, sample, row_ids in self.kept:
            targets, _ = inputs.call_targets(self.seed, call, p["batch"])
            want = exact_topk(self._live_at(call), targets, p["k"],
                              self.device)
            if self.control is not None:
                stale = self.control == "stale_table"
                got = exact_topk(self._live_at(call - stale), targets,
                                 p["k"], self.device,
                                 limbs=1 if self.control == "rank32" else 5)
                row_ids = got[sample]
            else:
                got = dist ^ targets[:, None, :]
            bad = ~(got == want).all(axis=(1, 2))
            bad[sample] |= ~(row_ids == want[sample]).all(axis=(1, 2))
            wrong += int(bad.sum())
            compared += len(targets)
        return ({"wrong_answers": (wrong, 0)},
                f"{compared} answers of {len(self.kept)} calls against the "
                "exact k closest live ids")

