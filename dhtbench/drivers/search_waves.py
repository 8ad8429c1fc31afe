"""Closed loop of iterative-lookup waves: each wave's targets go to
``core/search.py`` ``simulate_lookups`` as host uint32 ids, and its
answers (nodes, distances, hops, converged) come back to the host before
the next wave is handed over.

The network is ``nodes`` uniform ids drawn on the device from the seed,
sorted by the program's ``sort_table`` with its prefix table
(``build_prefix_lut`` at the configuration's ``lut_bits``) once in
set-up.  The check runs the plain model (``reference/search_model.py``)
over every lookup of the captured waves.

Controls (``--control``): ``lut16`` serves the waves with a 16-bit prefix
table, a coarser reply model than the configuration states.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from dhtbench.reference import inputs, search_model
from dhtbench.reference.topk import lexsort_rows


class Driver:
    def __init__(self, params: dict, seed: int, device, control=None):
        if control not in (None, "lut16"):
            raise ValueError(f"search_waves has no control {control!r}")
        self.p = params
        self.seed = seed
        self.device = device
        self.program_lut_bits = 16 if control == "lut16" else params["lut_bits"]
        self.next_call = 0
        self.first_window_call = None
        self.kept: list = []

    def setup(self) -> None:
        from opendht_tpu_torch.ops import sorted_table as ST
        draw = inputs.network_draw(self.seed, self.p["nodes"], self.device)
        self.sorted_ids, _perm, n_valid = ST.sort_table(draw)
        del draw, _perm
        self.n_valid = int(n_valid)
        self.lut = ST.build_prefix_lut(self.sorted_ids, self.n_valid,
                                       bits=self.program_lut_bits)
        from dhtbench.window import Window
        self.run(Window(), calls=self.p["warm_calls"])

    def _wave(self, win, call: int) -> None:
        from opendht_tpu_torch.core.search import simulate_lookups
        from opendht_tpu_torch.ops.ids import from_keys
        p = self.p
        targets, reply_seed = inputs.call_targets(self.seed, call, p["wave"])
        handoff = time.perf_counter()
        with win.span("wave"):
            out = simulate_lookups(
                self.sorted_ids, self.n_valid, targets, device=self.device,
                seed=reply_seed, k=p["k"], alpha=p["alpha"],
                search_nodes=p["search_nodes"], max_hops=p["max_hops"],
                lut=self.lut, state_limbs=p["state_limbs"])
            got = {"nodes": out["nodes"].cpu().numpy(),
                   "hops": out["hops"].cpu().numpy(),
                   "converged": out["converged"].cpu().numpy(),
                   "dist": from_keys(out["dist"])}
        win.call(handoff, len(targets), int(got["converged"].sum()))
        if win.capture and (call == self.first_window_call or inputs.captured(
                self.seed, call, p["capture_every"])):
            self.kept.append((call, got))

    def run(self, win, *, until=None, calls=None) -> None:
        """Waves back to back until ``until`` (``time.perf_counter``) or
        for ``calls`` waves."""
        if win.capture and self.first_window_call is None:
            self.first_window_call = self.next_call
        done = 0
        while (calls is None or done < calls) and \
                (until is None or time.perf_counter() < until):
            self._wave(win, self.next_call)
            self.next_call += 1
            done += 1

    def release(self) -> None:
        del self.sorted_ids, self.lut

    def verify(self) -> tuple:
        """(numbers compared, what was compared)."""
        p = self.p
        dev = self.device
        ids = inputs.draw_to_u64(inputs.network_draw(self.seed, p["nodes"],
                                                     dev))
        s = ids[lexsort_rows(ids)]
        del ids
        table = search_model.prefix_table(s, p["lut_bits"])
        wrong = compared = 0
        for call, got in self.kept:
            targets, reply_seed = inputs.call_targets(self.seed, call,
                                                      p["wave"])
            ref = search_model.lookups(
                s, table, p["lut_bits"],
                torch.from_numpy(targets.astype(np.int64)).to(dev),
                reply_seed, alpha=p["alpha"], k=p["k"],
                search_nodes=p["search_nodes"], max_hops=p["max_hops"],
                rank_limbs=p["state_limbs"])
            bad = np.zeros(len(targets), dtype=bool)
            for key, g in got.items():
                r = ref[key].cpu().numpy()
                same = g.astype(np.int64) == r.astype(np.int64)
                bad |= ~same.reshape(len(targets), -1).all(axis=1)
            wrong += int(bad.sum())
            compared += len(targets)
        return ({"wrong_lookups": (wrong, 0)},
                f"{compared} lookups of {len(self.kept)} waves against "
                "the plain model")
