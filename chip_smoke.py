#!/usr/bin/env python3
"""Drive the torch port (opendht_tpu_torch) on one CUDA card.

    python3 chip_smoke.py                 # the full run on the card
    python3 chip_smoke.py --cpu --n 20000 --q 512 \
        --search-n 20000 --search-q 256 --search-waves 2 \
        --serve-n 20000 --serve-q 64 --serve-gets 200 \
        --scale-n 20000 --scale-q 256 --swarm-n 2048       # rehearsal

Phases, one JSON line each:

1. device  — torch's device name and nvidia-smi's name and power limit;
             fails without a card.
2. build   — both CUDA kernels (opendht_tpu_torch/csrc/*.cu) built with
             nvcc for sm_90a; build seconds and ptxas register counts.
3. parity  — (printed after main, whose inputs it reuses) each kernel
             against its plain torch version on the card, bit
             for bit: window_select at k ∈ {1,8,14,16,21} on edge-case rows
             (bounds 0, 1, 191, 192, full ties, all-ones distances), with
             a row_index (many queries on one row, the first and last
             rows) at k ∈ {1,8,16,21}, and on the main path's own
             (expanded, j); lex_topk_select at W ∈ {32,128,256,1024},
             k ∈ {8,16} with invalid rows and exhaustion, and on the main
             path's own windows.  Then the id functions of
             opendht_tpu_torch.ops (popcount32, ctz32, lex_eq, lex_cmp,
             xor_cmp) on ID_PAIRS pairs of the main path's query keys,
             on the device, equal to a numpy oracle of the JAX package's
             semantics.
4. main    — NodeTable(device="cuda").bulk_load(1,000,000 seeded ids), then
             find_closest on 131,072 seeded targets at k=16 and k=8, then
             lookup_topk(expanded=None, window=128, k=16) on the same
             snapshot, with both kernels' launch counts zeroed just before
             and read just after; results checked against the port's exact
             xor_topk on 256 rows and a numpy oracle on 32 rows.
5. timing  — CUDA-event medians (≥ 5 reps after warm-up) of each kernel,
             its plain version and the plain fast3 select at the main
             path's shape, window_select on pre-gathered rows and the
             expanded[j] row gather alone (what reading in place removes),
             and host-clock medians of the whole calls.
6. profile — torch.profiler over one find_closest k=16 call: device time
             by kernel and copy, and the device's busy share of the call.
7. memory  — the peak device memory one find_closest k=16 call allocates
             beyond what was allocated before it (the snapshot's expansion
             already built); fails unless it is below the Q·970·4 bytes that
             gathered [Q, 970] rows alone would take.
8. search  — BASELINE config 3: 10,000,000 seeded ids sorted on the card
             with the LUT at default_lut_bits (24), then 16 waves of
             65,536 seeded targets through simulate_lookups at α=3, k=8,
             state_limbs=2 (1,048,576 lookups).  Checks: wave 0 equals
             the same engine on the CPU for its first 512 rows (same
             global query ids and batch size); state_limbs=5 gives the
             same wave; the three tests/goldens/search_engine.json hashes
             on the card; recall ≥ 0.95 against xor_topk on 256 rows;
             every lookup converged.  Reports hops, the wave time (CUDA
             events, waves in turn), lookups/s, rounds and ms per round,
             the host-clock time of all waves, the sort+LUT time, the
             engine's host syncs per wave, and a torch.profiler pass over
             one wave by round stage (search.select / reply / gather /
             merge / done / sync) and by op.
9. maintenance — BASELINE config 4: maintenance_sweep over 10,000,000
             seeded ids with seeded reply times (a quarter never replied)
             equal to a numpy oracle (np.bincount, np.maximum.at in
             float32), every refresh target in its bucket; CUDA-event
             median of the sweep.  (--search-n sizes both phases.)
10. churn  — BASELINE config 6: 10,000,000 seeded ids sorted on the card
             with the LUT (24 bits) and the 2-plane stride-64 expansion;
             512 evictions + 512 inserts per round into a 65,536-row
             delta, advanced 64 rounds (half the compaction cycle); one
             round = tombstone-word scatter, delta slab update, delta
             sort / 2-plane stride-16 and stride-64 expansions / LUT, and
             churn_lookup_topk (fast2, planes=2, lut_steps=0, d_cap=4096)
             over 131,072 seeded targets at k=8, repair included.  CUDA
             events: the round, the static fast2 lookup on the same table,
             expanded_topk(select="kernel") on the 5-plane expansion, one
             compaction (sort, 2-plane expansion, LUT of live base ∪
             delta); host-clock mutation prep per round; derived sustained
             lookups/s = Q / (round + prep + compaction / 128), mutations/s
             and churny/static; a profile of one round by stage
             (churn.absorb / delta_build / base / delta / merge /
             fallback).  Checks: on 256 seeded queries the fast3 churn
             lookup equals xor_topk over live base ∪ delta (distances and
             encodings) and fast2's encodings equal fast3's; 64 queries in
             a fully tombstoned stretch all fall back and come out exact;
             merge pack 16 equals pack 1; and at table level 1,000,000
             ids through 8 batches of bulk_load / insert / on_expired /
             remove that cross the delta and tombstone limits, with
             find_closest through the churn view equal to a table rebuilt
             from the same host state after every batch and at least one
             background compaction swapped.  (--churn-* flags size it.)
11. serve  — the serving node (runtime.Dht with its msgpack net engine,
             live searches and ingest waves) on the card.  BASELINE
             config 1: a v4-only Dht on a virtual clock with a transport
             that swallows every datagram, 10,000 seeded ids bulk-loaded
             (default_rng(1)), warmup(), then 1,000 Dht.get on the seeded
             keys at the default ingest knobs (fill 64, deadline 2 ms,
             depth 2), the scheduler pumped after each get; reports the
             host time from the first get to the last wave scattered,
             gets/s, the waves, their occupancy and stream span (CUDA
             events around each wave's launch, host enqueue gaps
             included), the lookups per route (snapshot = window_select,
             churn view), and the same gets once more under
             torch.profiler: device ms, kernels and copies per wave.
             Checks: every get's first 14 candidates equal a numpy exact
             top-14; depth 1, batching off and the traced run give the
             same sets; in the depth-1 run, with the virtual clock
             advanced 6 s (a few searches end by expiry) and the node
             then shut down, every done_cb fired once.  The live node
             (benchmarks/live_node_scale.py's shape): 1,000,000 seeded
             ids (default_rng(11)), a Dht over a real localhost UDP
             socket served from a thread, a client NetworkEngine sending
             --serve-q (256; cut from 512, PERF.md §4) alternating
             find / get requests, SERVE_WINDOW of them
             unanswered at a time, in two halves, a peer joining a
             near-empty bucket between them (so the first half runs
             through the snapshot, the second through the churn view);
             after each half 8 more requests served one server step at a
             time under torch.profiler (device ms, kernels and copies per
             step); reports bulk-load s, requests/s, p50 / p99 latency,
             the routes; checks every nodes4 against a numpy exact top-8
             over the reachable rows.
             Then a forced snapshot() and find_closest_nodes_batched on
             4,096 seeded targets (warm, then timed): lookups/s, every row
             exact.  window_select at the serving shapes (Q=1 k=8, Q=64
             k=14, Q=4096 k=8) against its plain version, with times and
             byte bounds.  Fails on any ingest wave failure or ERROR
             record of the port's loggers.  (--serve-* flags size it.)
12. runner — the runner layer on the card: one DhtRunner (its receive,
             DHT and bootstrap threads over the native C++ datagram
             engine, which must carry the traffic) with
             Config(max_req_per_sec=1_000_000), serving the serve
             phase's live node and burst (live_node_data): on its DHT
             thread, as a posted op, the ids bulk-loaded at loopback
             addresses and warmup() run again.  A client NetworkEngine
             (is_client) sends the alternating find / get requests,
             SERVE_WINDOW of them unanswered at a time, all through the
             snapshot, and window_select's launches must be at least
             their count.  Then a peer joins a near-empty bucket on the
             DHT thread and half as many requests more go through the
             churn view; then a background compaction is started on the
             DHT thread and 8 more requests are served while the node
             installs it there.  Every nodes4 equals a numpy exact top-8
             over the reachable rows (read on the DHT thread); each run
             reports requests/s, p50 / p99 latency, the node's
             per-packet step and pumps and the lookups per route.  Then
             a filtered get_sync (``Where("WHERE id=…")``) and an
             unfiltered one on the node, of WHERE_IDS values stored
             there: the filtered answer must be the unfiltered one's
             value of that id, and on the card window_select must launch
             for their resolve.  Then three more runners on the card,
             made and fed through the package's top-level names
             (``opendht_tpu_torch.DhtRunner``, ``.InfoHash``, ``.Value``,
             ``.Where``), bootstrap to each other: put_sync / get_sync of
             RUNNER_VALUES values across them, one value of WHERE_IDS
             put by each and a filtered get_sync of another's from each
             (exact), and one listen round-trip.  Fails on any ERROR
             record of the port's loggers, ingest wave failure,
             "dropping packet with high delay" warning, datagram sent
             off loopback, ``cryptography`` / ``argon2`` in
             sys.modules, or runner
             thread left alive after every runner is joined.
             (--serve-n / --serve-q size it with the serve phase.)
13. proxy  — the periphery in front of the live node, on the card, in
             a process of its own (as a server runs: none of the earlier
             phases' heap or metrics series): a DhtRunner
             (Config(max_req_per_sec=1_000_000), the JAX defaults
             otherwise) holding live_node_data's ids (--serve-n) on its
             DHT thread, each row answering on loopback through a
             PeerFarm process (row i at 127.1.0.0 + i, one socket,
             replies sent from the row's address), and a
             DhtProxyServer(runner, port=0) in front; once the node is
             loaded the start-up heap is frozen (gc.freeze), and the
             dhtnode child's ledger (e) has finished before any traffic.
             (b) REST traffic with PROXY_WINDOW requests in flight over
             --proxy-keys keys near the node's id:
             PROXY_STREAMS LISTEN streams attached first, a POST to every
             key and a second to each listened key, GET /{hash} and GET
             /{hash}/{value_id} of every key, OPTIONS and STATS /; every
             REST get equal to the node's direct get (value ids and
             packed bytes), every stream told of its two puts once, GET
             /stats carrying the port ledger's dht_kernel_* gauges, GET
             /profile's open bounds naming the device; requests/s,
             latency by route, window_select launches and the device
             events of a proxied get (torch.profiler).  (c) A second
             runner on the card started with RunnerConfig(proxy_server=)
             puts, gets and listens through the proxy, then swaps to UDP
             and back: its listener told of each put once, get_status
             following the backend.  (d) A PHT index (key spec name: 4,
             kind: 1) over that proxied runner inserts --pht-entries
             entries one after another, past MAX_NODE_ENTRY_COUNT
             (leaves split); once it has settled every entry is looked up
             exactly and PROXY_PHT_PREFIX_LOOKUPS inexactly, each answer
             equal to a host model (the linearized keys rebuilt with
             plain bit operations).  (e) ``python -X importtime -m
             opendht_tpu_torch.tools.dhtnode`` as a child process (on the
             card, without --cpu; --cpu only in the rehearsal), started
             with the phase: ``kernels``, then ``b`` to the node, ``p``,
             ``g``, ``stats``, ``q``; its kernels lines name all 16
             ledger specs on the device, its put reaches the node, and
             its import list holds no jax, jaxlib or opendht_tpu module.
             Fails on any ERROR record, ingest wave failure, plane gone
             dark, datagram off loopback or thread left alive, and on
             the card on any packet the node dropped for its delay.
             Its record's dht_threads (PumpTimes) times the runners'
             DHT-thread work, scheduler jobs and garbage collections,
             with the stacks of what ran past 0.2 s.
14. planes — the node's planes (keyspace sketch, hot-value cache,
             listener table) on the card; the serve and runner phases
             run them too, since they are the port's defaults.  First
             the planes' device programs alone (plain torch, not TPU
             kernels): listener_match at S=64 and L = 1,024, 100,000 and
             1,000,000 rows (each held to match_host over 4,096-row
             chunks; its peak extra memory), cache_probe at Q=64 C=64
             and sketch_update / sketch_query at Q=64 and sketch_decay
             (each held to its numpy mirror): CUDA-event medians,
             launches and copies per call (torch.profiler), bounds.
             Then the live node's 1,000,000 ids (live_node_data) at the
             JAX defaults but the keyspace's hot share (PLANES_HOT_SHARE;
             and max_req_per_sec, as in the serve phase) on a virtual
             clock: a client engine puts one value on each of
             --planes-keys keys (500: cut from 10,000 to keep the full
             run under 540 s, PERF.md §4) over loopback (keys near the
             node's id, so its
             announce's too-far check stores them), PLANES_WINDOW
             unanswered at a time; 20 virtual s later --planes-gets
             (2,048; cut from 4,096, PERF.md §4) Dht.get over
             those keys drawn from a seeded Zipf(0.99) (YCSB workload
             C), spread over 4 virtual s (one per virtual ms for
             more than 4,000), then the scheduler pumped through
             three observatory ticks (2 s).  Checks: cache hits > 0;
             every get's values equal the same stream on the same node
             with the cache disabled; the sketch and histogram equal a
             numpy count-min (hash_columns_host, float32 decays) of
             every id the observatory was handed, cell for cell;
             window_select launched on the misses.  Per-wave cost of 4
             waves of 64 misses, planes on / off / off / on on the same
             node (torch.profiler: device ms, kernels, copies).  Then
             1,024 listened keys (the table's capacity) plus 64 that
             overflow, and 8 waves of 64 stored puts, half on them: every
             notification delivered once, per listener in the order of a
             listen_batching="off" run, listener_match launched.  Fails
             on any ERROR record, ingest wave failure or plane gone dark.
             (--planes-keys / --planes-gets size it, --serve-n the node.)

15. scale  — scale-out on the card: the t-sharded table on a virtual
             mesh of t shards on cuda:0 (parallel/), the mesh/layout
             resolve and the resharder.  (a) BASELINE config 5's
             one-chip form, not cut: 64,000,000 ids from
             np.random.default_rng(6) (the port cannot draw JAX's
             PRNGKey(6) stream) sorted on the card,
             expand_table_chunked(chunks=8, limbs=2), the LUT at
             default_lut_bits(N), expanded_topk(select="fast2",
             planes=2, lut_steps=0, k=8) over 65,536 queries: ms per call
             as the slope of 4- and 32-call chains (CUDA events),
             lookups/s, the certified fraction and peak memory; 256
             sampled queries held to an exact xor_topk scan.  (b) The
             merge model: select_topk over [65,536, n_t·8] at n_t = 2, 4,
             8 (CUDA-event medians), wire bytes n_t·8·24 per query.  (c)
             sharded_sort_table → sharded_expand_table →
             sharded_window_lookup over the same 64M ids at t = 2, 4, 8,
             expanded (window_select per shard) and window
             (lex_topk_select per shard) routes, each equal to the
             unsharded lookup_topk: ms per call, kernel launches per call
             (one per shard), the profiler's kernels and device ms; both
             kernels held to their plain versions on shard 0's inputs at
             t=8.  (d) tp_simulate_lookups at t=4 over --search-n ids, one
             wave of --search-q targets at config 3's settings, equal to
             simulate_lookups; both waves' ms.  (e) the live node's
             table (--serve-n ids): NodeTable.find_closest(mesh=,
             layout=) on 1,024 targets with a hot reshard layout, one
             wave launched before the swap and one after, both equal to
             the unsharded answer; the rows each shard rescans; a Dht
             with resolve_mesh_t=2 on one card logs and serves
             unsharded; the default node's resharder swapping in virtual
             mode launches no kernel and no copy (profiler).
             (--scale-n / --scale-q size (a)-(c).)

16. ledger — the kernel cost ledger (opendht_tpu_torch/profiling.py)
             on the card: KernelLedger.compute() and .measure() of all 16
             canonical specs (launches dispatched and the CUDA kernels
             and copies one call issues, device ms as the median CUDA-
             event span, the byte bound and its roofline share against
             the h100 peaks row, peak temporaries); fails unless every
             CPU-deterministic field (shape, argument / output bytes,
             byte bound, operations model) equals
             opendht_tpu_torch/perf_budgets.json, every spec was timed
             and its device events captured, and perf_gate passes
             against this ledger (launches printed beside the CPU
             budget, not gated; peak temporaries a soft warning).  The
             ledger is written as ledger.json into the smoke-record
             directory.  Both kernels' launches by the lookup
             specs join the kernels line.  Then the live node's table
             (live_node_data, --serve-n) in a Dht: Q=1 resolves through
             the snapshot and, after a join, through the churn view,
             under torch.profiler: device kernels and copies per call
             split by the aten op that launched them, the top ten by
             count and by device time, and the ops dispatched.
17. swarm  — ops/swarm.py's storm (benchmarks/exp_chaos_r18.py's full
             arc): --swarm-n nodes (50,000), 64 keys, sweep 32, 22
             ticks, seed 5, repub_every 2 on the card: host ms per tick
             p50 / p99, per-tick device ms, kernels and copies, peak
             device memory, and per tick the active phases, n_alive,
             lookup_success, replica_coverage, model_err and the
             verdict; fails unless tick 0 is healthy, the cut degrades,
             the end is healthy (lookup success and coverage >= 0.95)
             and the arc replays identically under its seed (the replay
             is the profiled run).  Then a 4,096-node, 48-key arc of 8
             ticks on the card and through the numpy oracle
             (swarm_step_host) on the same drawn bits: every state
             array, metric and probe equal.  The storm's tick p50 is
             written as swarm_storm.json into the smoke-record directory.
18. bench  — python -m opendht_tpu_torch.bench once at --n x --q: its
             JSON line (lookups/s by the chain slope, certified share,
             exactness against the full scan, the scalar baseline),
             written as bench.json into the smoke-record directory; then
             perf_gate's soft timing ceilings over that directory
             (warnings, never a failure).
19. monitor — (run after proxy, in a process of its own, as the proxy
             phase is) the monitor, the scenario harness and the
             assemblers on the card.  (a) DhtNetwork(--monitor-runners,
             16; cut from 32, PERF.md §4) on the card with
             Config(max_req_per_sec=1_000_000), each runner behind a
             DhtProxyServer(port=0); the cluster connects.  (b)
             --monitor-keys (256) puts of distinct seeded keys, each
             through a random node, then a quarter of them got from
             another node, MONITOR_WINDOW unanswered at a time (an
             operation the overloaded one-process cluster lost is sent
             again, at most twice, and counted); every get returns its
             put's value id and bytes.  (c) dhtmon.run_checks over the
             endpoints and the runners (require_ready, min_success,
             min_coverage, since over GET /history, one max_peer_fail
             and one max_stage check): the coverage probe resolves every
             stored key in one call through the device snapshot
             (window_select launched, counted), its closest-8 lists equal
             a numpy XOR scan of the census and its held counts a host
             recount; the probe alone is timed and profiled; ``python -m
             opendht_tpu_torch.tools.dhtmon --require-ready --json`` as a
             child.  (d) a chaos LinkRule dropping one directed link
             (its source first pings its destination and waits for the
             answer, so that an earlier expiry does not leave the
             destination expired in the source's table), 16 gets driven
             over it at once: assemble_wiremap over every GET
             /peers ranks it first by fail_ratio among the edges that
             dhtmon's max_peer_fail gate reads (those past
             PeersConfig.min_signal_events requests); assemble_timeline over
             every node's history bundle; the benchmark (-t gets) and
             pingpong CLIs as children started with the phase (on the
             card; --cpu only in the rehearsal), each exiting 0 and
             loading no JAX module.  Then two nodes shut down: with more
             than 8 nodes left, min_coverage=1.0 reports a violation and
             the mean coverage falls.  On the card the cluster must be
             healthy as run (no violation) and the dropped link the
             worst edge; the rehearsal reports both.
20. cluster — (run after monitor, in a process of its own) the cluster
             tools on the card.  --cluster-children (4) subprocess
             clusters (testing/subproc_cluster.py) of --cluster-nodes (8)
             nodes each, started at once, each child on the card: 32
             nodes, dhtcluster's default.  Children 1-3 and a parent
             DhtRunner bootstrap into child 0.  Per child: seconds from
             spawn to its launch reply, its card memory (by pid where
             nvidia-smi lists it, else the card's use before and after)
             and the JAX libraries in its /proc/<pid>/maps (none).
             --cluster-keys (65) distinct seeded keys put through the
             children round-robin (one parent thread per child) and got
             through the next child, each equal to its put; puts/s.  A
             Scanner crawl from the parent runner finds every child's
             node and nothing else but the parent (the port's scanner
             splits its crawl; the JAX copy's stops after one probe,
             ROADMAP C.3).  The census: the closest 8 of every key over
             the 33 ids in one NodeTable call through the device snapshot
             (window_select), equal to a numpy scan, timed, then again
             under the profiler; both calls' launches counted (the
             children's warm-up launches, one a child, are in other
             processes and not counted).  Child
             0 SIGKILLed: every key put through it got back from the
             others.  network_monitor over the survivors (8 keys, 2
             rounds, exit 0).  DhtHttpServer over the parent runner: a
             form POST read back by GET.  Where network namespaces can be
             made, NetnsClusterNet with two namespaced clusters of 4 on
             the card, a put in one got from the other ("unavailable"
             otherwise).  Every child exits, no thread is left.
21. smokes — (only when --phases names it: a call of its own, not part
             of the full run, PERF.md §4) the thirteen smokes of
             opendht_tpu_torch/testing (ledger, health, history,
             waterfall, peer, keyspace, cache, listener, ingest,
             pipeline, pipeline_util, reshard and chaos; --smokes picks
             some) on the card, in a process of its own, which builds
             the native engine and measures one CUDA context's MiB
             (nvidia-smi before and after it makes its own).  Two
             passes, each a fresh child process a smoke (the metrics
             registry and the tracer are process-wide), SMOKES_PARALLEL
             at a time, the longest first.  (a) plain: ``python -m
             opendht_tpu_torch.testing.<name>``, as a user runs it;
             per smoke its exit code, seconds, last line (the smoke's
             OK line) and the JAX libraries its /proc/<pid>/maps showed
             while it ran.  (b) profiled: the smoke's main() under
             torch.profiler's CUDA activity (smoke_child; a smoke of
             SMOKES_SELF_PROFILED, which profiles itself, reports its
             ledger's device events of one call of each spec); per
             smoke its exit code, device kernels, copies and ms, the
             select kernels' launches, the allocator's peak, the JAX
             libraries and modules loaded, and the port's ERROR,
             dark-plane and delayed-packet records.  A smoke's card MiB
             is the context's plus its allocator peak.  Fails on a
             child of either pass that exits nonzero or whose last line
             is not the smoke's, a traceback in a plain child's output,
             an ERROR record, a plane gone dark (DARK_MARKS) or JAX
             loaded; a smoke whose nodes launched no kernel is named,
             not failed (a 3-node table resolves on the host).  Each
             child's output is kept in smokes/<name>.<pass>.out and
             .err in the smoke-record directory.
22. hops   — (run after search, in a process of its own: a 2,048-node
             net adds ~66,000 series to the process's metrics registry)
             tests/test_hop_parity.py's acceptance checks on the card: a
             VirtualNet() of --hops-n (2,048) nodes with its tables on
             the card, converged by seed_converged, and HOPS_LOOKUPS (6)
             cold-start gets by fresh observers bootstrapped from one
             seed node, under one seeded os.urandom / random stream
             (SeededStreams).  Checks: every get completes; live depth
             + 1 within one round of the batched simulator's p50
             (simulate_lookups on the card, α=4, k=8: HOPS_SIM_TARGETS
             (512) targets over a table of the net's size, both from
             np.random.default_rng(3)),
             which may not undercut it by more than half a round; the
             recall median of the true closest 8 ≥ 7.  Prints the
             hops, recalls and virtual seconds, the simulator's p50 and
             p95 beside the search phase's 10M-id p50 (α=3), the card's
             MiB (the allocator's, with the net alive, its peak, and
             nvidia-smi's) and the seconds of each leg.
23. hops_ladder — (only when --phases names it: a call of its own) the
             hops phase's checks, and one more, at --hops-n and at
             --hops-ladder (8,192, 16,384 and 32,768 nodes, the JAX
             test's slow tier), one line a size: the same gets on a
             VirtualNet(device="cpu") built in turn in the same process
             give the same hops, recall and first 8 ids (this leg left
             the full run when it printed the ok line past 620 s).
24. soak   — (only when --phases names it: a call of its own)
             tests/test_soak.py's cluster soak on the card: SOAK_STABLE
             (4) runners and a churner (DhtRunner().run(0) on the card)
             under puts, gets, three standing listeners and a churn every
             max(8, secs/6) s for --soak-secs (60) wall seconds.  The
             test's checks (work done, listeners fired, reassembly
             buffers drained, no listener record left after cancel,
             scheduler heaps < 1,500 + 20 a put, RSS growth after
             warm-up < 120 MiB + 0.25 a put) and one of the card: the
             allocator's bytes, sampled once a second after warm-up, in
             the last third at most the first third's maximum +
             SOAK_CUDA_SLACK (16 MiB).  Also no ERROR record and no
             plane gone dark; prints RSS, allocated bytes, the heaps and
             the packets dropped for their delay.

The smoke-record directory is $OPENDHT_TPU_SMOKE_RECORD_DIR, else
build/smoke_records beside this script: ``python -m
opendht_tpu_torch.perf_gate --records DIR`` reads it.

Then the kernels line ({"kernels": [...]}) and, last, the ok line.  Any
failure raises (nonzero exit, no ok line).  Without a card it exits
nonzero before any result; ``--cpu`` rehearses every phase on the host
with the plain versions and also ends without the ok line, as does a
partial run (``--phases`` with a comma-separated list of late phases,
e.g. ``--phases ledger,swarm``: phases 1-7, then only those).  The
full run (``--phases all``, the default) runs every late phase but
those of CALL_OF_ITS_OWN (smokes, hops_ladder, soak), which run only
when named.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import logging
import os
import random
import re
import socket
import statistics
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
OPS_PER_S = 67e12              # H100 SXM 32-bit rate outside the tensor cores

# Requests the serve phase's live-node client keeps unanswered.  The
# client engine resends a request unanswered for 1 s and gives up after
# 3 attempts, and the node answers one packet per server step, tens of
# ms each (PERF.md §5): benchmarks/live_node_scale.py's all-at-once
# burst of 512 would expire at the client before the node reached it.
SERVE_WINDOW = 4
# values put and got across the runner phase's small cluster
RUNNER_VALUES = 64
# value ids stored under one key for the runner phase's filtered gets
# (``Where("WHERE id=…")``): on the live node, and one put by each runner
# of the small cluster
WHERE_IDS = (11, 12, 13)
# the phases after main, in their order; --phases picks some of them
LATE_PHASES = ("search", "hops", "maintenance", "churn", "serve", "runner",
               "proxy", "monitor", "cluster", "planes", "scale", "ledger",
               "swarm", "bench", "smokes", "hops_ladder", "soak")
# late phases that the full run leaves out: each runs only when --phases
# names it, in a call of its own (the full run's time, PERF.md §4)
CALL_OF_ITS_OWN = ("smokes", "hops_ladder", "soak")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def max_abs_err(a, b) -> int:
    import torch
    require(a.shape == b.shape, f"shapes {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


# pairs of the main path's query keys that the parity phase's id
# functions run on
ID_PAIRS = 4096


def id_function_parity(keys, self_key) -> dict:
    """``popcount32``, ``ctz32``, ``lex_eq``, ``lex_cmp`` and ``xor_cmp``
    of ``opendht_tpu_torch.ops`` on the device against a numpy oracle of
    the JAX package's semantics (``opendht_tpu/ops/ids.py``): pairs
    (keys[i], keys[i-1]), every 16th pair made equal; the bit functions
    on the pairs' raw XOR bits and the ids' own.  Returns the counts of
    each outcome and the mismatches per function."""
    import torch
    from opendht_tpu_torch import ops as O
    a = keys
    b = torch.roll(keys, 1, 0).clone()
    b[::16] = a[::16]
    raw = torch.cat([(a ^ b).reshape(-1), (a ^ O.ids.FLIP).reshape(-1)])
    got = {"popcount32": O.popcount32(raw), "ctz32": O.ctz32(raw),
           "lex_eq": O.lex_eq(a, b), "lex_cmp": O.lex_cmp(a, b),
           "xor_cmp": O.xor_cmp(self_key, a, b)}
    got = {k: v.cpu().numpy() for k, v in got.items()}
    ua, ub, us = O.from_keys(a), O.from_keys(b), O.from_keys(self_key)
    x = O.from_keys(raw ^ O.ids.FLIP)             # the raw bits as uint32
    bits = (x[:, None] >> np.arange(32, dtype=np.uint32)) & 1

    def cmp(p, q):                                # memcmp of limb rows
        d = p != q
        first = d.argmax(axis=-1)[:, None]
        lt = np.take_along_axis(p, first, -1) < np.take_along_axis(q, first,
                                                                   -1)
        return np.where(d.any(-1), np.where(lt[:, 0], -1, 1), 0)
    want = {"popcount32": bits.sum(-1),
            "ctz32": np.where(x == 0, 32, bits.argmax(-1)),
            "lex_eq": (ua == ub).all(-1), "lex_cmp": cmp(ua, ub),
            "xor_cmp": cmp(ua ^ us, ub ^ us)}
    mismatches = {k: int((got[k] != want[k]).sum()) for k in want}
    return {"pairs": int(a.shape[0]), "bit_patterns": int(x.shape[0]),
            "equal_pairs": int(want["lex_eq"].sum()),
            "zero_patterns": int((x == 0).sum()),
            "lex_cmp": {str(v): int((want["lex_cmp"] == v).sum())
                        for v in (-1, 0, 1)},
            "xor_cmp": {str(v): int((want["xor_cmp"] == v).sum())
                        for v in (-1, 0, 1)},
            "popcount32_sum": int(want["popcount32"].sum()),
            "mismatches": mismatches}


def median_ms(fn, *, reps: int = 7, inner: int = 1, warmup: int = 2,
              cuda: bool = True) -> float:
    """Median per-call time of ``fn``: CUDA events around ``inner`` calls
    (host clock with a synchronize on the CPU rehearsal)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if cuda:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(inner):
                fn()
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1) / inner)
        else:
            s = time.perf_counter()
            for _ in range(inner):
                fn()
            times.append((time.perf_counter() - s) * 1e3 / inner)
    return statistics.median(times)


DEVICE_TOTALS = ("device_ms", "kernels", "copies")


def device_totals(prof, cuda: bool, per: int = 1) -> dict:
    """profiling.device_totals of a torch.profiler run on the card (its
    kernels, copies and fills per ``per``, the top ten by device time,
    the stage labels apart); "not measured" on the host."""
    if not cuda:
        return dict.fromkeys(DEVICE_TOTALS + ("top", "stages"),
                             "not measured")
    from opendht_tpu_torch import profiling
    return profiling.device_totals(prof, per)


def smoke_record(name: str, doc: dict) -> str:
    """Write ``doc`` as ``<name>.json`` into the smoke-record directory
    (module docstring), which perf_gate's soft checks read."""
    d = os.environ["OPENDHT_TPU_SMOKE_RECORD_DIR"]
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, name + ".json")
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    return path


def host_median_ms(fn, *, reps: int = 5, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        s = time.perf_counter()
        fn()
        times.append((time.perf_counter() - s) * 1e3)
    return statistics.median(times)


def edge_window_inputs(rng, Q):
    """Random expanded rows with bounds 0, 1, 191, 192 and random, full
    160-bit ties, valid lanes at all-ones distance, ties on limb 0 alone
    across all lanes, and ties on limbs 0..3 between the two candidates
    of one thread (lanes L and L+32) (uint32 numpy; Q >= 224)."""
    rows = rng.integers(0, 2**32, size=(Q, 5 * 194), dtype=np.uint32)
    q8 = rng.integers(0, 2**32, size=(Q, 8), dtype=np.uint32)
    b = rng.integers(0, 193, size=Q).astype(np.int32)
    b[:4] = (0, 1, 191, 192)
    planes = rows.reshape(Q, 5, 194)
    planes[4:64] = planes[4:64, :, :1]              # one id in every lane
    planes[64:128, :, 1:40] = planes[64:128, :, 1:2]
    b[4:128] = 192
    planes[128:160, :, 1:4] = ~q8[128:160, :5, None]
    planes[160:192, 0, 1:] = planes[160:192, 0, 1:2]
    planes[192:224, :4, 33:65] = planes[192:224, :4, 1:33]
    b[160:224] = 192
    return rows, q8, np.repeat(b[:, None], 8, axis=1)


def row_index_inputs(rng, q8_rows, b_rows, Q):
    """Queries on rows of the edge table: a quarter on one full-tie row,
    64 each on the first and last rows, the rest random.  Half take their
    row's own query limbs and bounds (so all-ones rows stay all-ones);
    four take bounds 0, 1, 191, 192 (uint32 / int32 numpy)."""
    NB = q8_rows.shape[0]
    ri = rng.integers(0, NB, size=Q).astype(np.int32)
    ri[:Q // 4] = 5
    ri[Q // 4:Q // 4 + 64] = 0
    ri[Q // 4 + 64:Q // 4 + 128] = NB - 1
    q8 = rng.integers(0, 2**32, size=(Q, 8), dtype=np.uint32)
    b = np.repeat(rng.integers(0, 193, size=Q).astype(np.int32)[:, None], 8,
                  axis=1)
    own = rng.random(Q) < 0.5
    q8[own], b[own] = q8_rows[ri[own]], b_rows[ri[own]]
    b[Q // 2:Q // 2 + 4] = np.array([0, 1, 191, 192], np.int32)[:, None]
    return ri, q8, b


def edge_lex_inputs(rng, Q, W):
    """Distances with duplicate ids, exhaustion, rows with nothing valid,
    random invalid masks, ties on limb 0 alone, and ties on limbs 0..3
    between positions p and p+32 (one thread's two candidates, W >= 64);
    Q >= 384."""
    q = rng.integers(0, 2**32, size=(Q, 5), dtype=np.uint32)
    t = rng.integers(0, 2**32, size=(Q, W, 5), dtype=np.uint32)
    t[:64] = t[:64, :1]                             # duplicate ids
    t[256:320, :, 0] = t[256:320, :1, 0]
    if W >= 64:
        t[320:384, 32:64, :4] = t[320:384, :32, :4]
    inv = np.zeros((Q, W), np.int32)
    inv[64:128, 5:] = 1                             # exhaustion after 5
    inv[128:160] = 1                                # nothing valid
    inv[160:256] = rng.integers(0, 2, size=(96, W))
    return q[:, None, :] ^ t, inv


CONFIG3 = dict(alpha=3, k=8, state_limbs=2)     # BASELINE.json config 3
OUT_KEYS = ("nodes", "hops", "converged", "dist")
GOLDENS = Path(__file__).resolve().parent / "tests" / "goldens" \
    / "search_engine.json"


def outputs_np(out) -> dict:
    """simulate_lookups' tensors as the JAX package's numpy arrays."""
    from opendht_tpu_torch.ops.ids import from_keys
    return {key: (from_keys(out[key]) if key == "dist"
                  else out[key].cpu().numpy()) for key in OUT_KEYS}


def same_outputs(a: dict, b: dict) -> bool:
    return all(np.array_equal(a[key], b[key]) for key in OUT_KEYS)


def golden_hashes(dev) -> dict:
    """sha256 of the engine's outputs in the three modes of
    tests/goldens/search_engine.json, run on ``dev``."""
    from opendht_tpu_torch.core.search import simulate_lookups
    from opendht_tpu_torch.ops.ids import to_keys
    from opendht_tpu_torch.ops.sorted_table import sort_table
    rng = np.random.default_rng(1234)
    ids = rng.integers(0, 2**32, size=(4096, 5), dtype=np.uint32)
    targets = to_keys(rng.integers(0, 2**32, size=(96, 5), dtype=np.uint32),
                      dev)
    s, _, n = sort_table(to_keys(ids, dev))
    hashes = {}
    for tag, kw in (("lut_l5", {}), ("lut_l2", {"state_limbs": 2}),
                    ("exact_l5", {"block_mode": "exact"})):
        out = outputs_np(simulate_lookups(s, n, targets, seed=99,
                                          device=dev, **kw))
        h = hashlib.sha256()
        for key in OUT_KEYS:
            h.update(np.ascontiguousarray(out[key]).tobytes())
        hashes[tag] = h.hexdigest()
    return hashes


def search_phase(args, dev, card, sync) -> dict:
    """BASELINE config 3: ``--search-waves`` waves of ``--search-q``
    lookups at α=3, k=8, state_limbs=2 against ``--search-n`` seeded ids
    sorted on the device, with the LUT at default_lut_bits(N); checks,
    timing and a per-round profile (see the module docstring).  Returns
    its hops' p50 and p95 and its table's size."""
    import torch
    from opendht_tpu_torch.core import search as SE
    from opendht_tpu_torch.ops import ids as IK
    from opendht_tpu_torch.ops import sorted_table as ST
    from opendht_tpu_torch.ops.xor_topk import xor_topk
    cuda = dev.type == "cuda"
    N, Q, W = args.search_n, args.search_q, args.search_waves
    rng = np.random.default_rng(args.seed + 3)
    ids = IK.to_keys(rng.integers(0, 2**32, size=(N, 5), dtype=np.uint32),
                     dev)
    targets = IK.to_keys(rng.integers(0, 2**32, size=(W, Q, 5),
                                      dtype=np.uint32), dev)
    sync()
    t0 = time.perf_counter()
    sorted_ids, _perm, n_valid = ST.sort_table(ids)
    bits = ST.default_lut_bits(N)
    lut = ST.build_prefix_lut(sorted_ids, n_valid, bits=bits)
    sync()
    sort_lut_s = time.perf_counter() - t0
    del ids, _perm
    n = int(n_valid)
    kw = dict(CONFIG3, lut=lut, seed=args.seed)

    def wave(w, **extra):
        return SE.simulate_lookups(sorted_ids, n, targets[w], device=dev,
                                   **{**kw, **extra})

    t0 = time.perf_counter()
    outs = [wave(w) for w in range(W)]
    sync()
    all_waves_s = time.perf_counter() - t0
    outs = [outputs_np(o) for o in outs]
    hops = np.concatenate([o["hops"] for o in outs])
    converged = np.concatenate([o["converged"] for o in outs])

    # (a) the card's wave 0 == the same engine on the CPU, first rows:
    # same table and LUT, same global query ids and batch size
    rows = min(512, Q)
    gp, lower, bb = SE.table_primitives(sorted_ids.cpu(), n, lut.cpu())
    ref = outputs_np(SE._lookup_engine(
        gp, lower, n, targets[0, :rows].cpu(),
        torch.arange(rows, dtype=torch.int32), Q, args.seed & 0xFFFFFFFF,
        k=CONFIG3["k"], alpha=CONFIG3["alpha"],
        search_nodes=SE.SEARCH_NODES, max_hops=48,
        state_limbs=CONFIG3["state_limbs"], block_bounds=bb))
    require(same_outputs({k: v[:rows] for k, v in outs[0].items()}, ref),
            f"wave 0 on the device == the CPU engine on its first {rows} "
            "rows")
    # (b) state_limbs=2 == state_limbs=5
    require(same_outputs(outs[0], outputs_np(wave(0, state_limbs=5))),
            "state_limbs=2 == state_limbs=5 on wave 0")
    # (c) the committed reply-stream goldens, run on the device
    with open(GOLDENS) as f:
        gold = json.load(f)
    hashes = golden_hashes(dev)
    require(all(hashes[t] == gold[t]["sha256"] for t in hashes),
            "the three search_engine.json goldens on the device")
    # (d) recall against the exact xor_topk
    nr = min(256, Q)
    _, ei = xor_topk(targets[0, :nr], sorted_ids, k=8,
                     tile=ST.scan_tile(N, nr),
                     valid=torch.arange(N, device=dev) < n)
    ei = ei.cpu().numpy()
    recall = float(np.mean([len(set(outs[0]["nodes"][i]) & set(ei[i])) / 8
                            for i in range(nr)]))
    require(recall >= 0.95, f"recall {recall} >= 0.95 against xor_topk")
    # (e) every lookup converged
    require(bool(converged.all()), "every lookup converged")

    # timing: the whole call, the waves in turn (CUDA events)
    turn = iter(range(10**9))
    wave_ms = median_ms(lambda: wave(next(turn) % W), reps=5, warmup=1,
                        cuda=cuda)
    syncs = "not measured"
    if cuda:
        # the engine's own device→host syncs in one wave
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                SE._simulate_lookups(sorted_ids, n, targets[0], **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = sum("synchroniz" in str(w.message) for w in caught)

    # one wave under the profiler: time by round stage and by op
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        s = time.perf_counter()
        wave(min(1, W - 1))
        sync()
        wall_ms = (time.perf_counter() - s) * 1e3
    ka = prof.key_averages()

    def ms(e, self_only=False):
        if cuda:
            return (e.self_device_time_total if self_only
                    else e.device_time_total) / 1e3
        return (e.self_cpu_time_total if self_only
                else e.cpu_time_total) / 1e3

    stages = {e.key: {"calls": e.count, "ms": ms(e)} for e in ka
              if e.key.startswith("search.")
              and e.device_type != torch.autograd.DeviceType.CUDA}
    rounds = stages.get("search.select", {}).get("calls", 0)
    kern = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith(("search.", "dht_"))]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    ops = sorted((e for e in ka if e.key.startswith("aten::")),
                 key=lambda e: ms(e, True), reverse=True)[:12]
    emit({"phase": "search", **card, "config": "BASELINE.json config 3",
          "n": N, "q": Q, "waves": W, "lookups": W * Q, **CONFIG3,
          "lut_bits": bits, "sort_and_lut_s": sort_lut_s,
          "all_waves_host_s": all_waves_s, "wave_ms": wave_ms,
          "lookups_per_s": Q / wave_ms * 1e3,
          "hops_p50": float(np.percentile(hops, 50)),
          "hops_p95": float(np.percentile(hops, 95)),
          "hops_max": int(hops.max()), "rounds_per_wave": rounds,
          "ms_per_round": wave_ms / rounds if rounds else None,
          "host_syncs_per_wave": syncs,
          "checks": {"cpu_rows_identical": rows, "state_limbs_2_eq_5": True,
                     "goldens": list(hashes), "recall": recall,
                     "recall_rows": nr,
                     "converged": int(converged.sum())},
          "profile": {"wall_ms": wall_ms,
                      "device_ms": dev_ms if cuda else "not measured",
                      "device_busy_share": (dev_ms / wall_ms if cuda
                                            else "not measured"),
                      "time": "device" if cuda else "host (rehearsal)",
                      "note": "wall_ms includes the profiler's overhead",
                      "stages": stages,
                      "top_ops": [{"name": e.key, "calls": e.count,
                                   "self_ms": ms(e, True)} for e in ops]}})
    return {"n": N, "alpha": CONFIG3["alpha"], "k": CONFIG3["k"],
            "p50": float(np.percentile(hops, 50)),
            "p95": float(np.percentile(hops, 95))}


def clz32_np(x: np.ndarray) -> np.ndarray:
    n = np.zeros(x.shape, np.int32)
    for s in (16, 8, 4, 2, 1):
        top = x < np.uint32(1 << (32 - s))
        n += np.where(top, s, 0).astype(np.int32)
        x = np.where(top, x << np.uint32(s), x)
    return np.where(x == 0, 32, n)


def common_bits_np(me: np.ndarray, ids: np.ndarray) -> np.ndarray:
    x = ids ^ me
    out = np.full(x.shape[:-1], 160, np.int32)
    prev_zero = np.ones(x.shape[:-1], bool)
    for i in range(5):
        first = prev_zero & (x[..., i] != 0)
        out = np.where(first, 32 * i + clz32_np(x[..., i]), out)
        prev_zero &= x[..., i] == 0
    return out


def maintenance_phase(args, dev, card) -> None:
    """BASELINE config 4: the bucket-maintenance sweep over
    ``--search-n`` seeded ids (2 % invalid, a quarter never replied)
    against a numpy oracle."""
    import torch
    from opendht_tpu_torch.ops import ids as IK
    from opendht_tpu_torch.ops import radix
    N = args.search_n
    rng = np.random.default_rng(args.seed + 4)
    me = rng.integers(0, 2**32, size=5, dtype=np.uint32)
    ids_np = rng.integers(0, 2**32, size=(N, 5), dtype=np.uint32)
    valid_np = rng.random(N) > 0.02
    now, age = 1.7e9, 600.0
    last_np = now - rng.uniform(0, 1200, size=N)
    last_np[rng.random(N) < 0.25] = 0.0                  # never replied
    me_k, ids_k = IK.to_keys(me, dev), IK.to_keys(ids_np, dev)
    valid_t = torch.from_numpy(valid_np).to(dev)
    last_t = torch.from_numpy(last_np).to(dev)          # float64, as held
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def sweep():
        return radix.maintenance_sweep(me_k, ids_k, valid_t, last_t, now,
                                       age, gen, device=dev)

    counts, last, stale, targets = sweep()
    b = np.minimum(common_bits_np(me, ids_np), 159)
    want_counts = np.bincount(b[valid_np], minlength=160)
    lr = last_np.astype(np.float32)
    m = valid_np & (lr > 0)
    want_last = np.full(160, -np.inf, np.float32)
    np.maximum.at(want_last, b[m], lr[m])
    want_stale = (want_counts > 0) & (want_last < np.float32(now)
                                      - np.float32(age))
    require(np.array_equal(counts.cpu().numpy(), want_counts),
            "sweep counts == np.bincount")
    require(np.array_equal(last.cpu().numpy(), want_last),
            "sweep last == np.maximum.at in float32")
    require(np.array_equal(stale.cpu().numpy(), want_stale),
            "sweep stale == the numpy oracle")
    require(np.array_equal(common_bits_np(me, IK.from_keys(targets)),
                           np.arange(160)), "every target in its bucket")
    sweep_ms = median_ms(sweep, reps=5, cuda=dev.type == "cuda")
    nbytes = N * (5 * 4 + 1 + 8)         # ids, valid, float64 reply times
    emit({"phase": "maintenance", **card, "config": "BASELINE.json config 4",
          "n": N, "sweep_ms": sweep_ms, "bytes": nbytes,
          "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
          "occupied": int((want_counts > 0).sum()),
          "stale": int(want_stale.sum()),
          "checks": ["counts", "last", "stale", "targets in bucket"]})


CONFIG6 = dict(k=8, select="fast2", lut_steps=0, planes=2, d_cap=4096)


class ChurnState:
    """The host side of BASELINE config 6's churn rounds
    (benchmarks/baseline_configs.py:539-579 with a numpy generator): a
    tombstone mask over the base's sorted positions and an append-only
    delta slab.  Each round evicts ``e`` distinct live positions and
    appends ``e`` fresh ids."""

    def __init__(self, nv: int, n: int, dcap: int, e: int, seed: int):
        self.rng = np.random.default_rng(seed)
        self.nv, self.e = nv, e
        self.tomb = np.zeros((n + 31) // 32, np.uint32)
        self.live = np.zeros(n, bool)
        self.live[:nv] = True
        self.delta = np.zeros((dcap, 5), np.uint32)
        self.n_delta = 0

    def round(self):
        """One round's mutations on the host; returns (word indices [E]
        padded by repetition, their post-round values, new ids [E,5],
        first delta slot)."""
        picks: list = []
        seen: set = set()
        while len(picks) < self.e:
            for c in self.rng.integers(0, self.nv, size=2 * self.e):
                c = int(c)
                if self.live[c] and c not in seen:
                    seen.add(c)
                    picks.append(c)
                    if len(picks) == self.e:
                        break
        pos = np.array(picks, np.int64)
        self.live[pos] = False
        np.bitwise_or.at(self.tomb, pos >> 5,
                         np.uint32(1) << (pos & 31).astype(np.uint32))
        w = np.unique(pos >> 5)
        widx = np.full(self.e, w[-1], np.int64)
        widx[:len(w)] = w
        new_ids = self.rng.integers(0, 2**32, size=(self.e, 5),
                                    dtype=np.uint32)
        nd0 = self.n_delta
        self.delta[nd0:nd0 + self.e] = new_ids
        self.n_delta = nd0 + self.e
        return widx, self.tomb[widx], new_ids, nd0


def churn_table_check(args, dev, sync) -> dict:
    """NodeTable level: ``--churn-table-n`` ids bulk-loaded on the
    device, then 8 batches of mutations through bulk_load / insert /
    on_expired / remove that together cross the delta limit and the
    tombstone limit; after each batch find_closest through the churn view
    equals find_closest on a table rebuilt from the same host state."""
    from opendht_tpu_torch import InfoHash, NodeTable, convert, tracing
    from opendht_tpu_torch.core import table as CT
    from opendht_tpu_torch.ops import ids as IK
    rng = np.random.default_rng(args.seed + 60)
    n0 = args.churn_table_n
    tomb_limit = max(CT.TOMB_MIN, n0 // CT.TOMB_FRAC)
    per_batch = tomb_limit // 3 + 1          # crosses within 3-4 batches
    bulk_per = 100                           # bulk loads that fit the delta
    ins_per = CT.DELTA_CAP * 2 // 5 + 1      # inserts overflow it at batch 3
    self_id = InfoHash(rng.integers(0, 256, size=20, dtype=np.uint8)
                       .tobytes())
    table = NodeTable(self_id, k=1 << 30, capacity=n0,
                      device=None if dev.type == "cuda" else "cpu")
    table.bulk_load(rng.integers(0, 2**32, size=(n0, 5), dtype=np.uint32),
                    now=1.0)
    table.snapshot(now=1.0)
    targets = rng.integers(0, 2**32, size=(args.churn_q, 5), dtype=np.uint32)
    swaps0 = len(tracing.get_tracer().events(name="table_churn_swap"))
    batches = []
    for b in range(8):
        fresh = rng.integers(0, 2**32, size=(bulk_per + ins_per, 5),
                             dtype=np.uint32)
        table.bulk_load(fresh[:bulk_per], now=2.0 + b)
        for row in IK.ids_to_bytes(fresh[bulk_per:]):
            table.insert(InfoHash(row.tobytes()), None, 2.0 + b, confirm=2)
        live = np.nonzero(table._valid & ~table._expired)[0]
        pick = rng.choice(live, size=per_batch, replace=False)
        raw = IK.ids_to_bytes(table._ids[pick])
        for i, r in enumerate(raw):
            h = InfoHash(r.tobytes())
            if i % 4:
                table.on_expired(h)
            else:
                table.remove(h)
        pending = table._pending_base is not None
        sync()
        t0 = time.perf_counter()
        got = table.find_closest(targets, now=20.0)
        churn_s = time.perf_counter() - t0
        state = {name: getattr(table, "_" + name)
                 for name in convert.SLAB_COLUMNS + ("bucket_count",)}
        ref = convert.node_table_from_numpy(
            bytes(self_id), state, device=None if dev.type == "cuda"
            else "cpu", k=table.k)
        sync()
        t0 = time.perf_counter()
        ref.snapshot(now=20.0)
        want = ref.find_closest(targets, now=20.0)
        rebuilt_s = time.perf_counter() - t0
        require(np.array_equal(got[0], want[0])
                and np.array_equal(got[1], want[1]),
                f"churn view find_closest == rebuilt table, batch {b}")
        batches.append({"batch": b, "churn_pending": table.churn_pending,
                        "compaction_pending_after_mutations": pending,
                        "compactions": table.compactions,
                        "find_closest_churn_s": churn_s,
                        "rebuild_and_find_closest_s": rebuilt_s})
        del ref
    swaps = len(tracing.get_tracer().events(name="table_churn_swap")) - swaps0
    require(swaps >= 1 and any(b["compaction_pending_after_mutations"]
                               for b in batches),
            "a background compaction was dispatched and swapped")
    return {"table_n": n0, "q": args.churn_q, "tomb_limit": tomb_limit,
            "evictions_per_batch": per_batch, "bulk_loaded_per_batch":
            bulk_per, "inserts_per_batch": ins_per, "swaps": swaps,
            "compactions": table.compactions, "batches": batches}


def churn_phase(args, dev, card, sync) -> None:
    """BASELINE config 6 (benchmarks/baseline_configs.py:472-710):
    ``--churn-n`` seeded ids sorted on the device with their LUT and
    2-plane stride-64 expansion; ``--churn-e`` evictions and inserts per
    round into a delta of ``--churn-dcap`` rows, advanced half a
    compaction cycle; one round served with fast2 / planes=2 /
    lut_steps=0 and a stride-16 delta with a stride-64 rescue.  Timing,
    derived throughput, a per-stage profile and the checks of the module
    docstring."""
    import torch
    from torch.profiler import record_function
    from opendht_tpu_torch.ops import ids as IK
    from opendht_tpu_torch.ops import sorted_table as ST
    from opendht_tpu_torch.ops.xor_topk import xor_topk
    cuda = dev.type == "cuda"
    N, Q, DCAP, E = args.churn_n, args.churn_q, args.churn_dcap, args.churn_e
    require(2 * E <= DCAP, "2·E <= delta capacity")
    k = CONFIG6["k"]
    rng = np.random.default_rng(args.seed + 6)
    ids = IK.to_keys(rng.integers(0, 2**32, size=(N, 5), dtype=np.uint32),
                     dev)
    queries = IK.to_keys(rng.integers(0, 2**32, size=(Q, 5),
                                      dtype=np.uint32), dev)
    sorted_ids, _perm, n_valid = ST.sort_table(ids)
    del ids, _perm
    expanded = ST.expand_table(sorted_ids, limbs=2)
    lut_bits = ST.default_lut_bits(N)
    lut = ST.build_prefix_lut(sorted_ids, n_valid, bits=lut_bits)
    nv = int(n_valid)
    d_bits = ST.default_lut_bits(DCAP)

    host = ChurnState(nv, N, DCAP, E, args.seed + 7)
    warm = max(2, min(max(4, (DCAP // E) // 2), DCAP // E))
    t0 = time.perf_counter()
    for _ in range(warm - 1):
        host.round()
    host_prep_ms = (time.perf_counter() - t0) * 1e3 / (warm - 1)
    widx, wval, new_ids, nd0 = host.round()
    widx = torch.from_numpy(widx).to(dev)
    wval = ST.tomb_tensor(wval, dev)
    new_ids = IK.to_keys(new_ids, dev)
    tomb_base = ST.tomb_tensor(host.tomb, dev)
    dslab = IK.to_keys(host.delta, dev)
    nd_after = host.n_delta

    def delta_tables(slab, strides=((16, 2), (64, 2))):
        dvalid = torch.arange(DCAP, device=dev) < nd_after
        ds, _dp, dnv = ST.sort_table(slab, dvalid)
        exps = [ST.expand_table(ds, stride=s, limbs=l) for s, l in strides]
        return ds, exps, ST.build_prefix_lut(ds, dnv, bits=d_bits)

    def round_body():
        """One round: the tombstone-word scatter and the delta slab update
        (values precomputed, so rounds repeat identically), the delta's
        sort / expansion / LUT and the churn lookup, repair included."""
        with record_function("churn.absorb"):
            tomb = tomb_base.clone()
            tomb[widx] = wval
            slab = dslab.clone()
            slab[nd0:nd0 + E] = new_ids
        with record_function("churn.delta_build"):
            ds, (de, dew), dlut = delta_tables(slab)
        return ST.churn_lookup_topk(sorted_ids, expanded, nv, tomb, ds, de,
                                    nd_after, queries, lut=lut, d_lut=dlut,
                                    d_exp_wide=dew, **CONFIG6)

    _, enc_round, cert = round_body()
    require(tuple(enc_round.shape) == (Q, k) and bool(cert.all()),
            "a churn round returns [Q, k] certified encodings")
    round_ms = median_ms(round_body, reps=7, cuda=cuda)
    static_ms = median_ms(lambda: ST.expanded_topk(
        sorted_ids, expanded, nv, queries, k=k, select="fast2", lut=lut,
        lut_steps=0, planes=2), reps=7, cuda=cuda)
    exp5 = ST.expand_table(sorted_ids)
    kernel_ms = median_ms(lambda: ST.expanded_topk(
        sorted_ids, exp5, nv, queries, k=k, select="kernel", lut=lut,
        lut_steps=0), reps=7, cuda=cuda)
    # flags of the round before its repair (outside the timed calls)
    ds, (de, dew), dlut = delta_tables(dslab)
    launch = ST.churn_lookup_launch(sorted_ids, expanded, nv, tomb_base, ds,
                                    de, nd_after, queries, lut=lut,
                                    d_lut=dlut, d_exp_wide=dew, **CONFIG6)
    flags = launch.flags.cpu()
    repaired = {"base_uncertified": int(((flags & 1) != 0).sum()),
                "delta_uncertified": int(((flags & 2) != 0).sum()),
                "merge_ties": int(((flags & 4) != 0).sum())}

    def compact():
        live = (torch.arange(N, device=dev) < nv) \
            & ~ST.unpack_tomb_bits(tomb_base, N)
        cat = torch.cat([sorted_ids, dslab])
        cval = torch.cat([live, torch.arange(DCAP, device=dev) < nd_after])
        s2, _p2, nv2 = ST.sort_table(cat, cval)
        return (s2, ST.expand_table(s2, limbs=2),
                ST.build_prefix_lut(s2, nv2, bits=lut_bits))

    compact_ms = median_ms(compact, reps=3, warmup=1, cuda=cuda)
    rounds_per_compaction = max(1, DCAP // E)
    syncs = "not measured"
    if cuda:
        # device→host syncs of one round (by design: the flag read)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                round_body()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        sites = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
                 if "synchroniz" in str(w.message)]
        syncs = {"count": len(sites), "sites": sites}

    # profile of one round by stage
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=acts) as prof:
        s = time.perf_counter()
        round_body()
        sync()
        wall_ms = (time.perf_counter() - s) * 1e3
    ka = prof.key_averages()
    dtime = (lambda e: e.device_time_total / 1e3) if cuda \
        else (lambda e: e.cpu_time_total / 1e3)
    stages = {e.key: {"calls": e.count, "ms": dtime(e)} for e in ka
              if e.key.startswith("churn.")
              and e.device_type != torch.autograd.DeviceType.CUDA}
    kern = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("churn.")]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    ops = sorted((e for e in ka if e.key.startswith("aten::")),
                 key=lambda e: (e.self_device_time_total if cuda
                                else e.self_cpu_time_total), reverse=True)[:10]

    # checks at the advanced state (tombstones and delta as served)
    nq = min(256, Q)
    qs = IK.to_keys(rng.integers(0, 2**32, size=(nq, 5), dtype=np.uint32),
                    dev)
    ds5, (de5,), dlut5 = delta_tables(dslab, ((32, 5),))
    dist3, enc3, _ = ST.churn_lookup_topk(sorted_ids, exp5, nv, tomb_base,
                                          ds5, de5, nd_after, qs, lut=lut,
                                          d_lut=dlut5, k=k, select="fast3")
    _, enc2, _ = ST.churn_lookup_topk(sorted_ids, expanded, nv, tomb_base, ds,
                                      de, nd_after, qs, lut=lut, d_lut=dlut,
                                      d_exp_wide=dew, **CONFIG6)
    live_np = torch.from_numpy(host.live).to(dev)
    cat = torch.cat([sorted_ids, ds])
    cval = torch.cat([live_np, torch.arange(DCAP, device=dev) < nd_after])
    d_ref, i_ref = xor_topk(qs, cat, k=k, tile=ST.scan_tile(N + DCAP, nq),
                            valid=cval)
    require(torch.equal(dist3, d_ref) and torch.equal(enc3, i_ref),
            "fast3 churn lookup == xor_topk over live base ∪ delta")
    require(torch.equal(enc2, enc3), "fast2 encodings == fast3's")
    # tomb-heavy: every row of a stretch of windows dead
    lo = nv // 3
    heavy_np = host.tomb.copy()
    heavy_live = host.live.copy()
    heavy_live[lo:lo + 4096] = False
    pos = np.arange(lo, lo + 4096)
    np.bitwise_or.at(heavy_np, pos >> 5,
                     np.uint32(1) << (pos & 31).astype(np.uint32))
    heavy = ST.tomb_tensor(heavy_np, dev)
    qh = sorted_ids[lo + 512:lo + 3584:48][:64].clone()  # windows all dead
    qh[:, 4] ^= 1
    hl = ST.churn_lookup_launch(sorted_ids, expanded, nv, heavy, ds, de,
                                nd_after, qh, lut=lut, d_lut=dlut,
                                d_exp_wide=dew, **CONFIG6)
    heavy_rows = int(((hl.flags.cpu() & 1) != 0).sum())
    _, enc_h, _ = ST.churn_lookup_finish(hl)
    cval_h = torch.cat([torch.from_numpy(heavy_live).to(dev),
                        torch.arange(DCAP, device=dev) < nd_after])
    _, ih_ref = xor_topk(qh, cat, k=k, tile=ST.scan_tile(N + DCAP, 64),
                         valid=cval_h)
    require(heavy_rows == qh.shape[0] and torch.equal(enc_h, ih_ref),
            "tomb-heavy windows fall back and come out exact")
    # pack 16 == pack 1
    _, enc_p16, _ = ST.churn_lookup_topk(
        sorted_ids, expanded, nv, tomb_base, ds, de, nd_after, queries,
        lut=lut, d_lut=dlut, d_exp_wide=dew, merge_pack=16, **CONFIG6)
    d3_16, e3_16, _ = ST.churn_lookup_topk(sorted_ids, exp5, nv, tomb_base,
                                           ds5, de5, nd_after, qs, lut=lut,
                                           d_lut=dlut5, k=k, select="fast3",
                                           merge_pack=16)
    require(torch.equal(enc_p16, enc_round) and torch.equal(e3_16, enc3)
            and torch.equal(d3_16, dist3), "merge pack 16 == pack 1")
    del exp5, de5
    table = churn_table_check(args, dev, sync)

    denom_ms = round_ms + host_prep_ms + compact_ms / rounds_per_compaction
    sustained = Q / denom_ms * 1e3
    static = Q / static_ms * 1e3
    emit({"phase": "churn", **card, "config": "BASELINE.json config 6",
          "n": N, "q": Q, "delta_cap": DCAP, "e": E, "warm_rounds": warm,
          "n_delta": nd_after, "tombstones": int(nv - host.live.sum()),
          "lut_bits": lut_bits, **CONFIG6,
          "round_ms": round_ms, "static_fast2_ms": static_ms,
          "kernel_select_5plane_ms": kernel_ms, "compact_ms": compact_ms,
          "host_prep_ms": host_prep_ms,
          "rounds_per_compaction": rounds_per_compaction,
          "host_syncs_per_round": syncs,
          "sustained_lookups_per_s": sustained,
          "mutations_per_s": 2 * E / denom_ms * 1e3,
          "static_lookups_per_s": static,
          "churny_over_static": sustained / static,
          "rows_repaired_in_round": repaired,
          "checks": {"fast3_eq_xor_topk_rows": nq, "fast2_eq_fast3": True,
                     "tomb_heavy_rows": heavy_rows,
                     "pack16_eq_pack1_rows": Q + nq},
          "table": table,
          "profile": {"wall_ms": wall_ms,
                      "device_ms": dev_ms if cuda else "not measured",
                      "device_busy_share": (dev_ms / wall_ms if cuda
                                            else "not measured"),
                      "time": "device" if cuda else "host (rehearsal)",
                      "note": "wall_ms includes the profiler's overhead",
                      "stages": stages,
                      "top_ops": [{"name": e.key, "calls": e.count,
                                   "self_ms": (e.self_device_time_total
                                               if cuda else
                                               e.self_cpu_time_total) / 1e3}
                                  for e in ops]}})


def exact_topk_np(ids: np.ndarray, targets: np.ndarray, k: int) -> np.ndarray:
    """Exact XOR top-k of ``ids`` (uint32 [N,5]) for each target ([Q,5]),
    in numpy: ids sorted once; for each target the longest prefix p of
    its limb 0 whose id range (contiguous in sorted order) still holds
    ≥ k ids — every id outside that range differs from the target within
    the first p bits, so it is farther than every id inside — then a
    lexsort of that range.  Returns the ids [Q, min(k, N), 5]."""
    s = ids[np.lexsort(ids.T[::-1])]
    s0 = s[:, 0]
    t0 = targets[:, 0].astype(np.uint64)
    kk = min(k, len(s))
    lo = np.zeros(len(targets), np.int64)
    hi = np.full(len(targets), len(s), np.int64)
    for p in range(1, 33):
        mask = np.uint64((0xFFFFFFFF << (32 - p)) & 0xFFFFFFFF)
        base = (t0 & mask).astype(np.uint32)
        top = (t0 | (~mask & np.uint64(0xFFFFFFFF))).astype(np.uint32)
        plo = np.searchsorted(s0, base, side="left")
        phi = np.searchsorted(s0, top, side="right")
        ok = (phi - plo) >= kk
        lo = np.where(ok, plo, lo)
        hi = np.where(ok, phi, hi)
    out = np.empty((len(targets), kk, 5), np.uint32)
    for i, t in enumerate(targets):
        c = s[lo[i]:hi[i]]
        d = c ^ t
        out[i] = c[np.lexsort((d[:, 4], d[:, 3], d[:, 2], d[:, 1],
                               d[:, 0]))[:kk]]
    return out


def _near_id(me: bytes, bits: int, salt: bytes) -> bytes:
    """An id sharing exactly ``bits`` leading bits with ``me`` (its bucket
    is near-empty in a random table)."""
    import hashlib
    raw = bytearray(hashlib.sha1(salt).digest())
    for i in range(bits + 1):
        byte, m = i // 8, 0x80 >> (i % 8)
        want = me[byte] & m if i < bits else (~me[byte]) & m
        raw[byte] = (raw[byte] & ~m) | want
    return bytes(raw)


#: what a plane logs when it goes dark (its device failed): the keyspace
#: observatory, the hot-value cache and the listener table disable
#: themselves instead of failing the node
DARK_MARKS = ("observatory disabled", "cache disabled",
              "batched delivery disabled", "going dark", "; disabling")


class PortRecords(logging.Handler):
    """While open: the ERROR records of the port's loggers, the runner's
    warnings that it dropped a packet for its delay, and any record of
    a plane going dark."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.errors, self.delay_drops, self.dark = [], [], []
        self.drop_threads = []          # (thread ident, delay s) per drop

    def emit(self, record):
        msg = self.format(record)
        if any(m in msg for m in DARK_MARKS):
            self.dark.append(msg)
        if record.levelno >= logging.ERROR:
            self.errors.append(msg)
        elif "dropping packet with high delay" in msg:
            self.delay_drops.append(msg)
            self.drop_threads.append((record.thread, record.args[0]
                                      if record.args else None))

    def __enter__(self):
        logging.getLogger("opendht_tpu_torch").addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger("opendht_tpu_torch").removeHandler(self)


class PumpTimes:
    """Until closed: the DHT-thread work of the runners added, timed —
    each op posted to a runner and each ``periodic`` call of its node —
    and the interpreter's garbage collections, with every piece over
    ``slow_s`` kept (runner or collection, what, seconds, when), so a
    packet dropped for its delay can be traced to what held the thread.
    Every 50 ms a sampler reads the stack of each piece running (where
    the busy time goes, and for pieces past ``slow_s`` their own stacks)
    and notes when it was itself held off past ``slow_s``, with what the
    threads were running then; ``report`` lists those seen most."""

    def __init__(self, slow_s: float = 0.2):
        import collections
        self.runners, self.slow_s = {}, slow_s
        self.t0 = time.perf_counter()
        self.slow, self.totals = [], {}
        self.gc = {"collections": [0, 0, 0], "s": [0.0, 0.0, 0.0],
                   "max_s": [0.0, 0.0, 0.0], "frozen": gc.get_freeze_count()}
        self._gc_t = None
        self._busy = {}             # thread ident -> (start, runner, what)
        self.stacks = collections.Counter()
        self.stalls = []            # the sampler's late wake-ups
        self.busy_profile = collections.Counter()
        self.jobs = {}              # scheduler job -> [runs, s, max s]
        self._stop = threading.Event()
        self._sampler = threading.Thread(target=self._sample,
                                         name="pump-sampler", daemon=True)
        gc.callbacks.append(self._on_gc)
        self._sampler.start()

    @staticmethod
    def _stack(frame, depth: int) -> tuple:
        import traceback
        return tuple(f"{os.path.basename(f.filename)}:{f.lineno} {f.name}"
                     for f in traceback.extract_stack(frame)[-depth:])

    #: innermost functions of a thread that waits (holds no lock)
    IDLE = {"wait", "select", "poll", "_wait_for_tstate_lock", "accept",
            "readinto", "recv_into", "recvfrom", "sleep", "_sample", "get",
            "readline", "read", "wait_for", "_worker", "acquire"}

    def _sample(self):
        import traceback
        last = time.perf_counter()
        while not self._stop.wait(0.05):
            now, frames = time.perf_counter(), sys._current_frames()
            late, last = now - last - 0.05, now
            if late > self.slow_s:
                # the sampler was held off: list what every thread that
                # is not waiting was running when it got back
                names = {t.ident: t.name for t in threading.enumerate()}
                self.stalls.append({
                    "late_s": late, "at_s": now - self.t0, "threads": {
                        f"{names.get(i, i)}": list(self._stack(f, 4))
                        for i, f in frames.items()
                        if f.f_code.co_name not in self.IDLE}})
            for ident, (t, name, what) in list(self._busy.items()):
                if ident in frames:
                    # where the thread's busy time goes: its innermost
                    # frames in the port's package
                    own = [f"{os.path.basename(f.filename)}:{f.name}"
                           for f in traceback.extract_stack(frames[ident])
                           if "opendht_tpu_torch" in f.filename]
                    self.busy_profile[(name,) + tuple(own[-3:])] += 1
                if ident in frames and now - t >= self.slow_s:
                    self.stacks[(name, what)
                                + self._stack(frames[ident], 10)] += 1

    def _on_gc(self, phase, info):
        if phase == "start":
            self._gc_t = time.perf_counter()
            return
        if self._gc_t is None:
            return
        s, g = time.perf_counter() - self._gc_t, info["generation"]
        self._gc_t = None
        self.gc["collections"][g] += 1
        self.gc["s"][g] += s
        self.gc["max_s"][g] = max(self.gc["max_s"][g], s)
        if s > self.slow_s:
            self.slow.append({"runner": "gc", "what": f"generation {g}",
                              "s": s, "at_s": time.perf_counter() - self.t0})

    def close(self):
        self._stop.set()
        self._sampler.join()
        if self._on_gc in gc.callbacks:
            gc.callbacks.remove(self._on_gc)
        self.gc["tracked_at_close"] = len(gc.get_objects())

    def _timed(self, name, what, fn, *a, **kw):
        ident = threading.get_ident()
        t = time.perf_counter()
        self._busy[ident] = (t, name, what)
        try:
            return fn(*a, **kw)
        finally:
            self._busy.pop(ident, None)
            s = time.perf_counter() - t
            tot = self.totals.setdefault(name, {
                "ops": 0, "ops_s": 0.0, "periodic": 0, "periodic_s": 0.0})
            kind = "periodic" if what == "periodic" else "ops"
            tot[kind] += 1
            tot[kind + "_s"] += s
            if s > self.slow_s:
                self.slow.append({"runner": name, "what": what, "s": s,
                                  "at_s": time.perf_counter() - self.t0})

    def add(self, name, runner):
        """Time ``runner``'s posted ops and its node's periodic calls."""
        post, dht = runner._post, runner._dht
        periodic = dht.periodic

        def timed_post(op, prio=False):
            what = getattr(op, "__qualname__", repr(op))
            return post(lambda active: self._timed(name, what, op, active),
                        prio)

        def timed_periodic(*a, **kw):
            return self._timed(name, "periodic", periodic, *a, **kw)
        runner._post = timed_post
        dht.periodic = timed_periodic
        self.runners[name] = runner
        # the node's scheduler jobs (each re-adds itself: wrapped then)
        sched = dht.scheduler
        add = sched.add

        def timed_add(t, func):
            if getattr(func, "_pump_timed", False):
                return add(t, func)
            what = f"{name} {getattr(func, '__qualname__', repr(func))}"

            def job():
                t0 = time.perf_counter()
                try:
                    return func()
                finally:
                    s = time.perf_counter() - t0
                    j = self.jobs.setdefault(what, [0, 0.0, 0.0])
                    j[0] += 1
                    j[1] += s
                    j[2] = max(j[2], s)
            job._pump_timed = True
            return add(t, job)
        sched.add = timed_add

    def report(self, drop_threads) -> dict:
        """The totals, the slowest pieces and the drops by runner."""
        by_ident = {r._dht_thread.ident: n for n, r in self.runners.items()
                    if r._dht_thread is not None}
        drops = {}
        for ident, delay in drop_threads:
            d = drops.setdefault(by_ident.get(ident, "other"),
                                 {"n": 0, "max_delay_s": 0.0})
            d["n"] += 1
            d["max_delay_s"] = max(d["max_delay_s"], delay or 0.0)
        slow = sorted(self.slow, key=lambda p: -p["s"])
        return {"totals": self.totals, "gc": self.gc,
                "slow_over_s": self.slow_s, "n_slow": len(slow),
                "slowest": slow[:12], "drops": drops,
                "slow_stacks": [{"samples": n, "runner": k[0],
                                 "what": k[1], "stack": list(k[2:])}
                                for k, n in self.stacks.most_common(6)],
                "sampler_stalls": sorted(self.stalls,
                                         key=lambda p: -p["late_s"])[:8],
                "busy_profile": [{"samples": n, "where": list(k)} for k, n
                                 in self.busy_profile.most_common(12)],
                "jobs": {k: {"runs": v[0], "s": v[1], "max_s": v[2]}
                         for k, v in sorted(self.jobs.items(),
                                            key=lambda kv: -kv[1][1])[:12]}}


class LookupRoutes:
    """While open: every lookup of the node, with its route (snapshot or
    churn view), Q and k and, on the card, its stream span (CUDA events
    around the launch: its kernels and the host's enqueue gaps between
    them), through the one seam both routes share."""

    def __init__(self, cuda: bool, sync):
        self.cuda, self.sync = cuda, sync
        self._lookups, self._originals = [], {}

    def __enter__(self):
        import torch
        from opendht_tpu_torch.core import table as CT
        for cls, route in ((CT.Snapshot, "snapshot"),
                           (CT.ChurnView, "churn")):
            orig = self._originals[cls] = cls.lookup_launch

            def counted(view, queries, *, _orig=orig, _route=route, **kw):
                ev = None
                if self.cuda:
                    ev = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                out = _orig(view, queries, **kw)
                if ev is not None:
                    ev[1].record()
                self._lookups.append({"route": _route,
                                      "q": int(queries.shape[0]),
                                      "k": int(kw.get("k", 8)), "ev": ev})
                return out
            cls.lookup_launch = counted
        return self

    def __exit__(self, *exc):
        for cls, orig in self._originals.items():
            cls.lookup_launch = orig

    def take(self) -> list:
        """The lookups since the last take, with their spans.  Another
        thread may add lookups meanwhile: those taken were all recorded
        before the sync."""
        out = self._lookups[:]
        del self._lookups[:len(out)]
        self.sync()
        for lk in out:
            ev = lk.pop("ev")
            lk["stream_ms"] = ev[0].elapsed_time(ev[1]) if ev else None
        return out

    @staticmethod
    def routes(lks) -> dict:
        return {r: sum(1 for lk in lks if lk["route"] == r)
                for r in ("snapshot", "churn")}


def client_engine(csock, name: str, node_id, port: int):
    """A client NetworkEngine on ``csock`` and the node at 127.0.0.1:port
    it asks.  A client (is_client): a non-client requester is offered to
    the node's own searches, which then query it, and a bare engine
    answers without a write token — for which the node blacklists its
    address (Dht._on_get_values_done), silently dropping the rest of a
    burst."""
    from opendht_tpu_torch.infohash import InfoHash
    from opendht_tpu_torch.net.engine import EngineCallbacks, NetworkEngine
    from opendht_tpu_torch.scheduler import Scheduler
    from opendht_tpu_torch.sockaddr import SockAddr
    ceng = NetworkEngine(InfoHash.get(name), 0,
                         lambda data, dst: csock.sendto(
                             data, (str(dst.ip), dst.port)) and 0,
                         Scheduler(), EngineCallbacks(), is_client=True)
    peer = ceng.cache.get_node(node_id, SockAddr("127.0.0.1", port),
                               time.monotonic(), confirm=True)
    return ceng, peer


def send_request(ceng, peer, i: int, target, on_done, on_expired=None):
    """Request i: a get when i is even, a find when it is odd."""
    from opendht_tpu_torch.core.value import Query
    if i % 2:
        ceng.send_find_node(peer, target, want=1, on_done=on_done,
                            on_expired=on_expired)
    else:
        ceng.send_get_values(peer, target, Query(), want=1, on_done=on_done,
                             on_expired=on_expired)


def client_burst(ceng, peer, csock, targets: list, lo: int, hi: int,
                 timeout_s: float) -> dict:
    """Requests lo..hi-1 (to targets[i]) with at most SERVE_WINDOW of
    them unanswered at a time, until every one is answered, one expires
    at the client or ``timeout_s`` passes.  Returns the answers by
    request, the sorted latencies (s), the expired requests and the wall
    time (s)."""
    import select
    from opendht_tpu_torch.sockaddr import SockAddr
    sent, answers, expired = {}, {}, []
    t0 = time.perf_counter()
    deadline = time.monotonic() + timeout_s
    nxt = lo
    while len(answers) < hi - lo and time.monotonic() < deadline \
            and not expired:
        # a request is stamped with the engine's clock, which only a
        # run() moves: left at the previous burst's end, a request sent
        # after a pause looks a second overdue at the next run() and is
        # sent twice, doubling the node's first pump
        ceng.scheduler.sync_time()
        while nxt < hi and nxt - lo - len(answers) < SERVE_WINDOW:
            i = nxt
            nxt += 1
            sent[i] = time.perf_counter()
            send_request(ceng, peer, i, targets[i],
                         lambda r, a, _i=i: answers.__setitem__(
                             _i, (time.perf_counter(), a)),
                         lambda r, over, _i=i: over and expired.append(_i))
        ceng.scheduler.run()
        r, _, _ = select.select([csock], [], [], 0.005)
        if r:
            data, addr = csock.recvfrom(64 * 1024)
            ceng.process_message(data, SockAddr(addr[0], addr[1]))
    return {"answers": {i: a for i, (_, a) in answers.items()},
            "lat": sorted(t - sent[i] for i, (t, _) in answers.items()),
            "expired": expired, "wall_s": time.perf_counter() - t0}


def require_exact(answers: list, live: np.ndarray, targets_np: np.ndarray,
                  what: str) -> None:
    """Every answer's nodes4 == a numpy exact top-8 over ``live`` (the
    node's reachable rows)."""
    from opendht_tpu_torch.ops import ids as IK
    want = exact_topk_np(live, targets_np, 8)
    for i, a in enumerate(answers):
        require([bytes(n.id) for n in a.nodes4]
                == [r.tobytes() for r in IK.ids_to_bytes(want[i])],
                f"{what}: request {i}'s nodes4 == numpy top-8")


def latency_ms(lat: list) -> dict:
    """p50 / p99 / max in ms of sorted latencies in s."""
    return {"p50": 1e3 * lat[len(lat) // 2],
            "p99": 1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))],
            "max": 1e3 * lat[-1]}


def live_node_data(args):
    """The live node of the serve and runner phases: its seeded ids
    (--serve-n), the targets of its burst (--serve-q) and the generator
    they came from."""
    rng = np.random.default_rng(11)
    ids = rng.integers(0, 2**32, size=(args.serve_n, 5), dtype=np.uint32)
    targets = rng.integers(0, 2**32, size=(args.serve_q, 5), dtype=np.uint32)
    return rng, ids, targets


def serve_phase(args, dev, card, sync) -> int:
    """The serving node (see the module docstring, phase 11).  Returns
    the window_select launches of the phase's three counted runs."""
    import contextlib
    import select
    import socket
    import threading
    import torch
    from torch.profiler import ProfilerActivity, profile
    from opendht_tpu_torch import telemetry
    from opendht_tpu_torch.core import table as CT
    from opendht_tpu_torch.infohash import InfoHash
    from opendht_tpu_torch.ops import ids as IK
    from opendht_tpu_torch.ops import sorted_table as ST
    from opendht_tpu_torch.ops.window_select import (window_select,
                                                      window_select_plain)
    from opendht_tpu_torch.runtime import Config, Dht
    from opendht_tpu_torch.runtime.live_search import SEARCH_NODES
    from opendht_tpu_torch.scheduler import Scheduler
    from opendht_tpu_torch.sockaddr import SockAddr

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    device = None if cuda else "cpu"
    AF = socket.AF_INET
    reg = telemetry.get_registry()
    failures0 = reg.counter("dht_ingest_wave_failures_total").value

    with PortRecords() as records, LookupRoutes(cuda, sync) as lookups:
        # ---- config 1: 1,000 Dht.get over a 10,000-row table ---------
        rng = np.random.default_rng(1)
        n1, g = 10_000, args.serve_gets
        ids1 = rng.integers(0, 2**32, size=(n1, 5), dtype=np.uint32)
        keys_np = rng.integers(0, 2**32, size=(g, 5), dtype=np.uint32)
        keys = [InfoHash(r.tobytes()) for r in IK.ids_to_bytes(keys_np)]
        want1 = exact_topk_np(ids1, keys_np, SEARCH_NODES)
        want1 = [[r.tobytes() for r in IK.ids_to_bytes(w)] for w in want1]
        me1 = InfoHash(rng.integers(0, 256, size=20, dtype=np.uint8)
                       .tobytes())

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])

        def config1(expire: bool, traced: bool = False, **cfg) -> dict:
            """One run of the 1,000 gets; ``traced`` runs the gets under
            torch.profiler (its wall time then carries the profiler's
            overhead)."""
            clock = {"t": 0.0}
            dht = Dht(lambda data, addr: 0, Config(node_id=me1, **cfg),
                      Scheduler(clock=lambda: clock["t"]), has_v6=False,
                      device=device)
            dht.tables[AF].bulk_load(ids1, 0.0,
                                     addrs=SockAddr("127.0.0.2", 4567))
            dht.warmup()
            first = {}
            orig_insert = dht._refill_insert

            def refill_insert(sr, nodes):
                first.setdefault(bytes(sr.id),
                                 [bytes(n.id) for n in nodes])
                return orig_insert(sr, nodes)
            dht._refill_insert = refill_insert
            done = [0] * g
            lookups.take()
            window_select.launches = 0
            sync()
            with (profile(activities=acts) if traced
                  else contextlib.nullcontext()) as prof:
                t0 = time.perf_counter()
                for i, key in enumerate(keys):
                    dht.get(key, done_cb=lambda ok, ns, _i=i:
                            done.__setitem__(_i, done[_i] + 1))
                    dht.periodic(None, None)
                while len(first) < g:    # the last partial wave's deadline
                    clock["t"] += 0.0005
                    dht.periodic(None, None)
                sync()
                wall_s = time.perf_counter() - t0
            launches = window_select.launches
            lks = lookups.take()
            res = {"first": first, "wall_s": wall_s, "launches": launches,
                   "lookups": lks, "waves": dht.wave_builder.waves}
            if traced:
                res["device"] = device_totals(prof, cuda)
                res["per_wave"] = device_totals(prof, cuda, max(1, len(lks)))
            if expire:
                # no peer answers: candidates expire after 3 attempts ×
                # MAX_RESPONSE_TIME and a few searches end by expiry
                # (tests/test_torch_dht.py holds which gets end in
                # these 6 virtual s to the JAX node's, at depth 1 on
                # the same table and keys: at depth 2 a wave scatters
                # when the card is done in real time, so on a virtual
                # clock the expiries would follow the host's speed).
                # Then shut the node down, which ends every search
                # still running: done_cb fires once either way.
                t0 = time.perf_counter()
                while clock["t"] < 6.0:
                    clock["t"] += 0.25
                    dht.periodic(None, None)
                res["done_by_expiry"] = [i for i, n in enumerate(done) if n]
                dht.shutdown()
                res["expire_host_s"] = time.perf_counter() - t0
                res["done"] = list(done)
                lookups.take()
            return res

        c2 = config1(False)
        c1 = config1(True, ingest_pipeline_depth=1)
        coff = config1(False, ingest_batching="off")
        ctr = config1(False, traced=True)
        firsts = [[c2["first"].get(bytes(k)) for k in keys]]
        require(firsts[0] == want1,
                "config 1: every get's first 14 candidates == numpy top-14")
        require(all([c["first"].get(bytes(k)) for k in keys] == firsts[0]
                    for c in (c1, coff, ctr)),
                "config 1: depth 1 == depth 2 == batching off")
        require(all(n == 1 for n in c1["done"]),
                "config 1: every get's done_cb fired exactly once")
        waves = c2["lookups"]
        occ = [lk["q"] for lk in waves]
        span_ms = [lk["stream_ms"] for lk in waves
                   if lk["stream_ms"] is not None]
        tw, tdev = len(ctr["lookups"]), ctr["device"]
        cfg1 = {
            "n": n1, "gets": g, "waves": len(waves),
            "wave_occupancy": {"mean": float(np.mean(occ)), "min": min(occ),
                               "max": max(occ)},
            "wave_stream_span_ms": ({"median": statistics.median(span_ms),
                                     "max": max(span_ms),
                                     "sum": sum(span_ms)}
                                    if span_ms else "not measured"),
            # the same gets under torch.profiler: device time is that of
            # the kernels and copies alone
            "traced": {"waves": tw, "wall_s": ctr["wall_s"],
                       **{k: tdev[k] for k in DEVICE_TOTALS},
                       "per_wave": ctr["per_wave"],
                       "device_busy_share": (
                           tdev["device_ms"] / (1e3 * ctr["wall_s"])
                           if cuda else "not measured"),
                       "note": "wall_s includes the profiler's overhead"},
            "first_get_to_last_wave_s": c2["wall_s"],
            "gets_per_s": g / c2["wall_s"],
            "routes": LookupRoutes.routes(waves),
            "window_select_launches": c2["launches"],
            "depth1": {"wall_s": c1["wall_s"], "waves": len(c1["lookups"]),
                       "routes": LookupRoutes.routes(c1["lookups"])},
            "batching_off": {"wall_s": coff["wall_s"],
                             "lookups": len(coff["lookups"]),
                             "routes": LookupRoutes.routes(coff["lookups"])},
            "done_cbs": {"by_search_expiry_in_6_virtual_s":
                         len(c1["done_by_expiry"]),
                         "by_expiry_gets": c1["done_by_expiry"],
                         "by_shutdown": g - len(c1["done_by_expiry"]),
                         "run": "depth 1", "host_s": c1["expire_host_s"]}}
        print(json.dumps({"serve_config1": cfg1}), file=sys.stderr,
              flush=True)
        if cuda:
            require(c2["launches"] >= 1 and c1["launches"] >= 1
                    and coff["launches"] >= 1,
                    "config 1 launched window_select through Dht")

        # ---- the live node: 1,000,000 rows, a burst over UDP ---------
        ln = args.serve_n
        rng, ids, targets_np = live_node_data(args)
        ssock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        ssock.bind(("127.0.0.1", 0))
        ssock.setblocking(False)
        csock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        csock.bind(("127.0.0.1", 0))
        csock.setblocking(False)
        client = csock.getsockname()

        def server_send(data, dst):
            # the loaded peers exist only in the table: datagrams to
            # them are dropped here, only the client is answered
            if (str(dst.ip), dst.port) == client:
                ssock.sendto(data, client)
            return 0

        dht = Dht(server_send, Config(max_req_per_sec=1_000_000),
                  has_v6=False, device=device)
        table = dht.tables[AF]
        t0 = time.perf_counter()
        table.bulk_load(ids, dht.scheduler.time(),
                        addrs=SockAddr("127.0.0.2", 4567))
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        dht.warmup()
        sync()
        warmup_s = time.perf_counter() - t0
        require(len(table) > CT.HOST_SCAN_MAX_ROWS, "past the host scan")

        steps = []      # (host s of one periodic call, had a packet)

        def serve(stop):
            while not stop.is_set():
                r, _, _ = select.select([ssock], [], [], 0.01)
                t0 = time.perf_counter()
                if r:
                    data, addr = ssock.recvfrom(64 * 1024)
                    dht.periodic(data, SockAddr(addr[0], addr[1]))
                else:
                    dht.periodic(None, None)
                steps.append((time.perf_counter() - t0, bool(r)))

        ceng, peer = client_engine(csock, "serve-client", dht.myid,
                                   ssock.getsockname()[1])
        targets = [InfoHash(r.tobytes())
                   for r in IK.ids_to_bytes(targets_np)]

        def check_exact(answers: list, tg_np, what: str) -> int:
            """Every answer against the rows reachable now; returns
            their count."""
            live = table._ids[table.reachable_mask(0.0)]
            require_exact(answers, live, tg_np, f"live node: {what}")
            return len(live)

        def burst(lo: int, hi: int) -> dict:
            """Requests lo..hi-1 from the client, served by a thread."""
            stop = threading.Event()
            th = threading.Thread(target=serve, args=(stop,), daemon=True)
            th.start()
            try:
                b = client_burst(ceng, peer, csock, targets, lo, hi, 120)
            finally:
                stop.set()
                th.join()
            stats = dht.engine.in_stats
            # the slowest steps with their index in the burst's steps
            slow = sorted(((d, p, s) for s, (d, p) in enumerate(steps)),
                          reverse=True)[:5]
            pkt = sorted(d for d, p in steps if p)
            steps.clear()
            answers, wall = b["answers"], b["wall_s"]
            require(len(answers) == hi - lo,
                    f"live node: {len(answers)}/{hi - lo} answered in "
                    f"{wall:.1f} s, {len(b['expired'])} expired at the "
                    f"client, server saw {stats.find} find / {stats.get} "
                    f"get; slowest server steps {slow}; errors: "
                    f"{records.errors[:2]}")
            lks = lookups.take()
            rows = check_exact([answers[i] for i in range(lo, hi)],
                               targets_np[lo:hi], "burst")
            return {"requests": hi - lo, "wall_s": wall, "lat": b["lat"],
                    "routes": LookupRoutes.routes(lks), "lookups": lks,
                    "table_rows": rows,
                    "server_packet_step_ms": {
                        "p50": 1e3 * pkt[len(pkt) // 2],
                        "max": 1e3 * pkt[-1]} if pkt else None,
                    "slowest_server_steps_ms_packet_index": [
                        [1e3 * d, p, s] for d, p, s in slow]}

        def traced(seed: int, n: int, b: dict) -> dict:
            """n more requests (targets from default_rng(seed)), each
            served in this thread by dht.periodic under torch.profiler:
            the device time, kernels and copies per server step, beside
            the step's host time; every answer exact.  The burst ``b``
            before it gets its device busy share estimated as the
            traced steps' device ms per step × its requests over its
            wall time."""
            tg_np = np.random.default_rng(seed).integers(
                0, 2**32, size=(n, 5), dtype=np.uint32)
            answers, walls = {}, []
            with profile(activities=acts) as prof:
                for i, raw in enumerate(IK.ids_to_bytes(tg_np)):
                    send_request(ceng, peer, i, InfoHash(raw.tobytes()),
                                 lambda r, a, _i=i: answers.__setitem__(_i, a))
                    end = time.monotonic() + 10
                    while i not in answers and time.monotonic() < end:
                        ready, _, _ = select.select([ssock, csock], [], [],
                                                    0.05)
                        if ssock in ready:
                            data, addr = ssock.recvfrom(64 * 1024)
                            t0 = time.perf_counter()
                            dht.periodic(data, SockAddr(addr[0], addr[1]))
                            sync()
                            walls.append(time.perf_counter() - t0)
                        if csock in ready:
                            data, addr = csock.recvfrom(64 * 1024)
                            ceng.process_message(data,
                                                 SockAddr(addr[0], addr[1]))
            require(len(answers) == n,
                    f"live node: {len(answers)}/{n} traced requests answered")
            check_exact([answers[i] for i in range(n)], tg_np, "traced")
            lks = lookups.take()
            dev = device_totals(prof, cuda)
            ns = len(walls)
            per = device_totals(prof, cuda, ns)
            walls.sort()
            return {"requests": n, "server_steps": ns,
                    "routes": LookupRoutes.routes(lks),
                    "step_ms": {"p50": 1e3 * walls[ns // 2],
                                "max": 1e3 * walls[-1]},
                    **{k: dev[k] for k in DEVICE_TOTALS}, "per_step": per,
                    "device_busy_share_of_steps": (
                        dev["device_ms"] / (1e3 * sum(walls))
                        if cuda else "not measured"),
                    "burst_device_busy_share_est": (
                        per["device_ms"] * b["requests"]
                        / (1e3 * b["wall_s"]) if cuda else "not measured"),
                    "note": "step_ms includes the profiler's overhead"}

        lookups.take()
        window_select.launches = 0
        try:
            half = args.serve_q // 2
            b1 = burst(0, half)
            t1 = traced(12, 8, b1)
            # a peer joins a near-empty bucket between the halves: churn
            # pending, so the second half is served by the churn view
            dht.insert_node(InfoHash(_near_id(bytes(dht.myid), 30,
                                              b"serve-join")),
                            SockAddr("127.0.0.3", 4567))
            pending = table.churn_pending
            b2 = burst(half, args.serve_q)
            t2 = traced(13, 8, b2)
        finally:
            ssock.close()
            csock.close()
        live_launches = window_select.launches
        lat = sorted(b1["lat"] + b2["lat"])
        per_req = [lk["stream_ms"] for lk in b1["lookups"] + b2["lookups"]
                   if lk["q"] == 1 and lk["stream_ms"] is not None]
        half_keys = ("routes", "wall_s", "table_rows", "server_packet_step_ms",
                     "slowest_server_steps_ms_packet_index")
        live_out = {
            "n": ln, "bulk_load_s": load_s, "warmup_s": warmup_s,
            "requests": args.serve_q, "window": SERVE_WINDOW,
            "requests_per_s": args.serve_q / (b1["wall_s"] + b2["wall_s"]),
            "latency_ms": latency_ms(lat),
            "first_half": {k: b1[k] for k in half_keys},
            "traced_after_first_half": t1,
            "churn_pending_after_join": pending,
            "second_half": {k: b2[k] for k in half_keys},
            "traced_after_second_half": t2,
            "per_request_lookup_stream_span_ms": (
                {"median": statistics.median(per_req), "max": max(per_req)}
                if per_req else "not measured"),
            "window_select_launches": live_launches}
        require(b2["routes"]["churn"] >= 1, "the churn view served")
        print(json.dumps({"serve_live_node": live_out}), file=sys.stderr,
              flush=True)

        # ---- the batched resolve after a forced snapshot -------------
        table.snapshot()
        require(table.churn_pending == 0, "snapshot folded the churn")
        wave_np = rng.integers(0, 2**32, size=(4096, 5), dtype=np.uint32)
        wave = [InfoHash(r.tobytes()) for r in IK.ids_to_bytes(wave_np)]
        dht.find_closest_nodes_batched(wave, AF)          # warm
        lookups.take()
        window_select.launches = 0
        sync()
        t0 = time.perf_counter()
        res = dht.find_closest_nodes_batched(wave, AF)
        sync()
        batched_s = time.perf_counter() - t0
        batched_launches = window_select.launches
        blks = lookups.take()
        live = table._ids[table.reachable_mask(0.0)]
        want = exact_topk_np(live, wave_np, 8)
        for i in range(len(wave)):
            require([bytes(n.id) for n in res[i]]
                     == [r.tobytes() for r in IK.ids_to_bytes(want[i])],
                    f"batched resolve row {i} == numpy top-8")
        if cuda:
            require(live_launches >= 1, "the live node launched "
                    "window_select through Dht")
            require(batched_launches >= 1, "the batched resolve launched "
                    "window_select")
        batched = {"q": 4096, "s": batched_s,
                   "lookups_per_s": 4096 / batched_s,
                   "routes": LookupRoutes.routes(blks),
                   "stream_span_ms": blks[0]["stream_ms"] if blks else None,
                   "window_select_launches": batched_launches}

        # ---- window_select at the serving shapes, against its plain --
        snap = table._snap
        shapes = {}
        err = 0
        for q, k in ((1, 8), (64, SEARCH_NODES), (4096, 8)):
            qk = IK.to_keys(wave_np[:q], dev)
            j, start = ST.expanded_window(snap.sorted_ids, snap._expanded,
                                          snap.n_valid, qk)
            q8 = torch.nn.functional.pad(qk, (0, 3))
            bounds = torch.clamp(snap.n_valid - start, 0, 192)[:, None] \
                .expand(-1, 8).contiguous()
            got = window_select(snap._expanded, q8, bounds, k=k, row_index=j)
            sync()
            want_k = window_select_plain(snap._expanded, q8, bounds, k=k,
                                         row_index=j)
            e = max_abs_err(got, want_k)
            err = max(err, e)
            # the rows the queries read (each distinct row once), the
            # row indices, queries8, bounds and the [q, 128] output
            rows_read = int(torch.unique(j).numel())
            nbytes = rows_read * 970 * 4 + q * (1 + 8 + 8 + 128) * 4
            ops = q * (5 * 192 + 10 * 192 + k * (10 * 6 + 64))
            shapes[f"q{q}_k{k}"] = {
                "ms": median_ms(lambda: window_select(
                    snap._expanded, q8, bounds, k=k, row_index=j),
                    inner=20, cuda=cuda),
                "plain_ms": median_ms(lambda: window_select_plain(
                    snap._expanded, q8, bounds, k=k, row_index=j),
                    reps=5, cuda=cuda),
                "bytes": nbytes, "ops": ops,
                "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                                ops / OPS_PER_S) * 1e3,
                "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                             >= ops / OPS_PER_S else "operations"),
                "library_ms": None, "max_abs_err": e}
        require(err == 0, "window_select at the serving shapes == plain")

    failures = reg.counter("dht_ingest_wave_failures_total").value - failures0
    phase_s = time.perf_counter() - t_phase
    emit({"phase": "serve", **card,
          "config1": cfg1, "live_node": live_out, "batched_resolve": batched,
          "window_select_serving_shapes": shapes,
          "ingest_wave_failures": failures,
          "error_records": len(records.errors),
          "planes_dark_records": len(records.dark), "phase_s": phase_s})
    require(failures == 0, "no ingest wave failed")
    require(not records.dark, "no plane went dark: "
            + "; ".join(records.dark[:3]))
    require(not records.errors, "no ERROR record from the port's loggers: "
            + "; ".join(records.errors[:3]))
    return c2["launches"] + live_launches + batched_launches, err


def _pump_stats(pumps) -> dict:
    """The DHT thread's pumps that found packets queued: their count,
    host ms (p50, max) and packets per pump (mean, max)."""
    busy = [(d, n) for d, n in pumps if n]
    if not busy:
        return {"pumps": len(pumps), "with_packets": 0}
    ms = sorted(1e3 * d for d, _ in busy)
    return {"pumps": len(pumps), "with_packets": len(busy),
            "ms_p50": ms[len(ms) // 2], "ms_max": ms[-1],
            "packets_mean": sum(n for _, n in busy) / len(busy),
            "packets_max": max(n for _, n in busy)}


def runner_phase(args, dev, card, sync) -> int:
    """The runner layer (see the module docstring, phase 12) on the
    serve phase's live node and burst.  Returns the window_select
    launches of its requests."""
    import concurrent.futures
    import ipaddress
    import socket
    import threading
    import opendht_tpu_torch as o
    from opendht_tpu_torch import telemetry
    from opendht_tpu_torch.core import table as CT
    from opendht_tpu_torch.infohash import InfoHash
    from opendht_tpu_torch.ops import ids as IK
    from opendht_tpu_torch.ops.window_select import window_select
    from opendht_tpu_torch.runtime import Config, DhtRunner, RunnerConfig
    from opendht_tpu_torch.sockaddr import SockAddr

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    device = None if cuda else "cpu"
    AF = socket.AF_INET
    reg = telemetry.get_registry()
    failures0 = reg.counter("dht_ingest_wave_failures_total").value
    sent = {"loopback": 0, "off_loopback": []}

    def watch_sends(r):
        """Count every datagram the runner's native engine sends."""
        udp = r._udp
        orig = udp.send

        def send(data, addr, _orig=orig):
            if ipaddress.ip_address(addr[0]).is_loopback:
                sent["loopback"] += 1
            else:
                sent["off_loopback"].append(addr)
            return _orig(data, addr)
        udp.send = send

    runners = []
    csock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    with PortRecords() as records, LookupRoutes(cuda, sync) as lookups:
        try:
            # ---- the node: a runner on the card, its native engine ----
            node = DhtRunner()
            runners.append(node)
            t0 = time.perf_counter()
            node.run(0, RunnerConfig(
                dht_config=Config(max_req_per_sec=1_000_000)), device=device)
            run_s = time.perf_counter() - t0
            require(node._udp is not None, "the runner's native engine "
                    "carries the traffic (not the Python-socket fallback)")
            watch_sends(node)

            def on_dht(fn, timeout: float = 120):
                """fn(dht) run on the DHT thread as a posted op; its
                result, or its exception raised here."""
                fut = concurrent.futures.Future()

                def op(dht):
                    try:
                        fut.set_result(fn(dht))
                    except Exception as e:       # raised below
                        fut.set_exception(e)
                node._post(op, prio=True)
                return fut.result(timeout)

            # ---- the table, loaded on the DHT thread -------------------
            ln, q = args.serve_n, args.serve_q
            _, ids, targets_np = live_node_data(args)

            def load(dht):
                table = dht.tables[AF]
                s = time.perf_counter()
                # the loaded peers exist only in the table: the node's
                # own maintenance sends to their loopback address
                table.bulk_load(ids, dht.scheduler.time(),
                                addrs=SockAddr("127.0.0.2", 4567))
                load_s = time.perf_counter() - s
                s = time.perf_counter()
                dht.warmup()
                sync()
                return {"rows": len(table), "bulk_load_s": load_s,
                        "warmup_s": time.perf_counter() - s,
                        "thread": threading.current_thread().name}
            load_out = on_dht(load, 600)
            require(load_out["rows"] == ln and ln > CT.HOST_SCAN_MAX_ROWS,
                    f"{ln} rows loaded past the host scan")
            require(load_out["thread"] == "dht", "the table loaded on the "
                    "DHT thread")

            def reachable(dht):
                t = dht.tables[AF]
                return t._ids[t.reachable_mask(0.0)].copy()

            # per packet: the host time of the node's Dht.periodic
            steps = []
            inner = node._dht._dht
            inner_periodic = inner.periodic

            def timed_periodic(data, addr):
                s = time.perf_counter()
                out = inner_periodic(data, addr)
                if data:
                    steps.append(time.perf_counter() - s)
                return out
            inner.periodic = timed_periodic
            # per pump of the DHT thread (ops, every queued packet,
            # status): its host time and the packets it found queued
            pumps = []
            node_loop = node._loop

            def timed_loop():
                n = len(node._rcv)
                s = time.perf_counter()
                out = node_loop()
                pumps.append((time.perf_counter() - s, n))
                return out
            node._loop = timed_loop

            # ---- the client's requests, in three runs ------------------
            csock.bind(("127.0.0.1", 0))
            csock.setblocking(False)
            ceng, peer = client_engine(
                csock, "runner-client", InfoHash(bytes(node.get_node_id())),
                node.get_bound_port())

            def burst(tg_np, what: str) -> dict:
                """A request to each target of ``tg_np``, every answer
                exact; its requests/s, latency, the node's steps and
                pumps, the lookups per route and window_select's
                launches."""
                tg = [InfoHash(r.tobytes()) for r in IK.ids_to_bytes(tg_np)]
                n = len(tg)
                lookups.take()
                steps.clear()
                pumps.clear()
                window_select.launches = 0
                b = client_burst(ceng, peer, csock, tg, 0, n, 300)
                launched = window_select.launches
                pkt = sorted(steps)
                require(len(b["answers"]) == n,
                        f"runner {what}: {len(b['answers'])}/{n} answered "
                        f"in {b['wall_s']:.1f} s, {len(b['expired'])} "
                        f"expired at the client; errors: "
                        f"{records.errors[:2]}; delay drops: "
                        f"{len(records.delay_drops)}")
                routes = LookupRoutes.routes(lookups.take())
                # every answer against the rows reachable now, read on
                # the DHT thread
                require_exact([b["answers"][i] for i in range(n)],
                              on_dht(reachable), tg_np, f"runner {what}")
                return {
                    "requests": n, "exact": n, "wall_s": b["wall_s"],
                    "requests_per_s": n / b["wall_s"],
                    "latency_ms": latency_ms(b["lat"]),
                    "node_packet_step_ms": ({"p50": 1e3 * pkt[len(pkt) // 2],
                                             "max": 1e3 * pkt[-1],
                                             "packets": len(pkt)}
                                            if pkt else None),
                    "dht_thread_pumps": _pump_stats(pumps),
                    "routes": routes, "window_select_launches": launched}

            # the burst: every request through the snapshot
            burst_out = {"window": SERVE_WINDOW,
                         **burst(targets_np, "burst")}
            launches = burst_out["window_select_launches"]
            require(burst_out["routes"]["snapshot"] >= q,
                    f"the snapshot served the burst: {burst_out['routes']}")
            if cuda:
                require(launches >= q, f"window_select launched {launches} "
                        f"times on the runner's path for {q} requests")
            print(json.dumps({"runner_burst": burst_out}), file=sys.stderr,
                  flush=True)

            # a peer joins a near-empty bucket, on the DHT thread: churn
            # pending, so the next q/2 requests take the churn view
            def join(dht):
                dht.insert_node(InfoHash(_near_id(bytes(dht.myid), 30,
                                                  b"runner-join")),
                                SockAddr("127.0.0.3", 4567))
                return dht.tables[AF].churn_pending
            pending = on_dht(join)
            require(pending >= 1, "the joined peer is pending churn")
            churn_out = {"churn_pending_after_join": pending,
                         **burst(np.random.default_rng(15).integers(
                             0, 2**32, size=(q // 2, 5), dtype=np.uint32),
                             "churn")}
            launches += churn_out["window_select_launches"]
            require(churn_out["routes"]["churn"] >= q // 2,
                    f"the churn view served: {churn_out['routes']}")
            print(json.dumps({"runner_churn": churn_out}), file=sys.stderr,
                  flush=True)

            # a background compaction started on the DHT thread: its side
            # stream sorts while the churn view serves, and the node's
            # view() installs it there
            def compact(dht):
                t = dht.tables[AF]
                c = t.compactions
                t._start_compaction()
                return {"compactions": c,
                        "started": t._pending_base is not None}
            before = on_dht(compact)
            require(before["started"], "a compaction started")
            compaction_out = burst(np.random.default_rng(14).integers(
                0, 2**32, size=(2 * SERVE_WINDOW, 5), dtype=np.uint32),
                "across the compaction")
            launches += compaction_out["window_select_launches"]
            after = on_dht(lambda dht: {
                "compactions": dht.tables[AF].compactions,
                "installed": dht.tables[AF]._pending_base is None})
            require(after["installed"]
                    and after["compactions"] == before["compactions"] + 1,
                    f"the DHT thread installed the compaction: {after}")
            compaction_out["compactions"] = after["compactions"]
            node._loop = node_loop
            inner.periodic = inner_periodic

            # ---- a filtered get on the node, through the public names:
            # WHERE_IDS stored on the node, one filtered and one
            # unfiltered get_sync in flight together; their search
            # resolves on the 1M rows (no loaded peer answers, so each
            # get ends when its candidates expire)
            wkey = o.InfoHash.get("runner-where")
            wid = WHERE_IDS[1]

            def store(dht):
                now = dht._dht.scheduler.time()
                return [dht._dht.storage_store(
                    wkey, o.Value(b"where %d" % i, value_id=i), now)
                    for i in WHERE_IDS]
            require(all(on_dht(store)), "the node stored WHERE_IDS")
            lookups.take()
            window_select.launches = 0
            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(2) as pool:
                filtered = pool.submit(node.get_sync, wkey,
                                       where=o.Where(f"WHERE id={wid}"))
                unfiltered = pool.submit(node.get_sync, wkey)
                filtered, unfiltered = filtered.result(), unfiltered.result()
            where_s = time.perf_counter() - t0
            where_launches = window_select.launches
            where_routes = LookupRoutes.routes(lookups.take())
            launches += where_launches
            require(sorted(v.id for v in unfiltered) == list(WHERE_IDS),
                    f"the node's unfiltered get: "
                    f"{sorted(v.id for v in unfiltered)}")
            require([(v.id, v.data) for v in filtered]
                    == [(v.id, v.data) for v in unfiltered if v.id == wid]
                    == [(wid, b"where %d" % wid)],
                    f"the node's filtered get: {filtered}")
            require(sum(where_routes.values()) >= 1,
                    f"the node's gets resolved on its table: {where_routes}")
            if cuda:
                require(where_launches >= 1, "window_select launched for the "
                        "node's filtered get")
            where_out = {"key_values": len(WHERE_IDS), "where": f"id={wid}",
                         "filtered": len(filtered),
                         "unfiltered": len(unfiltered), "exact": True,
                         "routes": where_routes,
                         "window_select_launches": where_launches,
                         "s": where_s}

            # ---- a small cluster: three more runners on the card -------
            small = []
            for _ in range(3):
                r = o.DhtRunner()
                runners.append(r)
                small.append(r)
                r.run(0, device=device)
                require(r._udp is not None, "a small runner's native engine")
                watch_sends(r)
            for r in small[1:]:
                r.bootstrap("127.0.0.1", small[0].get_bound_port())
            t0 = time.perf_counter()
            end = time.monotonic() + 60
            while time.monotonic() < end and not all(
                    r.get_status().name == "CONNECTED" for r in small):
                time.sleep(0.05)
            connect_s = time.perf_counter() - t0
            require(all(r.get_status().name == "CONNECTED" for r in small),
                    "the three runners connected")
            heard = []
            lkey = o.InfoHash.get("runner-phase-listen")
            tok = small[2].listen(lkey, lambda vals, exp: heard.extend(
                v.data for v in vals if not exp) or True)
            require(tok.result(30) >= 1, "listen registered")
            t0 = time.perf_counter()
            for i in range(RUNNER_VALUES):
                require(small[i % 3].put_sync(
                    o.InfoHash.get(f"runner-value-{i}"),
                    o.Value(b"value %d" % i), timeout=30), f"put_sync {i}")
            put_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            for i in range(RUNNER_VALUES):
                got = small[(i + 1) % 3].get_sync(
                    o.InfoHash.get(f"runner-value-{i}"), timeout=30)
                require([v.data for v in got] == [b"value %d" % i],
                        f"get_sync {i} found the value put on another "
                        "runner")
            get_s = time.perf_counter() - t0
            # one value a runner under one key, and a filtered get of
            # another runner's value from each
            skey = o.InfoHash.get("runner-where-cluster")
            t0 = time.perf_counter()
            for r, i in zip(small, WHERE_IDS):
                require(r.put_sync(skey, o.Value(b"where %d" % i, value_id=i),
                                   timeout=30), f"put_sync of id {i}")
            for n, r in enumerate(small):
                i = WHERE_IDS[(n + 1) % 3]
                got = r.get_sync(skey, timeout=30,
                                 where=o.Where(f"WHERE id={i}"))
                require([(v.id, v.data) for v in got]
                        == [(i, b"where %d" % i)],
                        f"filtered get_sync of id {i}: {got}")
            where_cluster_s = time.perf_counter() - t0
            small[0].put(lkey, o.Value(b"heard"))
            end = time.monotonic() + 30
            while time.monotonic() < end and b"heard" not in heard:
                time.sleep(0.05)
            require(heard == [b"heard"], "the listener heard the remote put")
            cluster_out = {"runners": 3, "connect_s": connect_s,
                           "values": RUNNER_VALUES, "put_sync_s": put_s,
                           "get_sync_s": get_s, "listen": "heard",
                           "filtered_gets": len(small), "filtered_exact": True,
                           "filtered_s": where_cluster_s,
                           "names": "opendht_tpu_torch.{DhtRunner,InfoHash,"
                                    "Value,Where}"}
        finally:
            csock.close()
            for r in runners:
                r.join()

    alive = [t.name for t in threading.enumerate() if t.name.startswith("dht")]
    failures = reg.counter("dht_ingest_wave_failures_total").value - failures0
    crypto_mods = sorted(m for m in sys.modules
                         if m.split(".")[0] in ("cryptography", "argon2"))
    emit({"phase": "runner", **card, "native_engine": True,
          "run_s": run_s, "load": load_out, "burst": burst_out,
          "churn": churn_out, "across_compaction": compaction_out,
          "where_get": where_out, "cluster": cluster_out,
          "ingest_wave_failures": failures,
          "error_records": len(records.errors),
          "planes_dark_records": len(records.dark),
          "delay_drops": len(records.delay_drops),
          "datagrams_sent": {"loopback": sent["loopback"],
                             "off_loopback": len(sent["off_loopback"])},
          "crypto_modules": crypto_mods, "live_runner_threads": alive,
          "phase_s": time.perf_counter() - t_phase})
    require(failures == 0, "no ingest wave failed")
    require(not records.errors, "no ERROR record from the port's loggers: "
            + "; ".join(records.errors[:3]))
    require(not records.delay_drops, "no packet dropped for its delay")
    require(not records.dark, "no plane went dark: "
            + "; ".join(records.dark[:3]))
    require(not sent["off_loopback"], "every datagram stayed on loopback: "
            f"{sent['off_loopback'][:3]}")
    require(not crypto_mods, f"no crypto wheel imported: {crypto_mods}")
    require(not alive, f"every runner thread joined: {alive}")
    return launches


# ---- the proxy phase (phase 13) ----------------------------------------
# LISTEN streams among the proxy phase's REST keys (--proxy-keys), the
# REST requests its client keeps in flight, and the PHT's inexact
# lookups.  The PHT is one index, its inserts one after another: two
# indexes over one DHT share their trie nodes' keys (Prefix.hash leaves
# the index name out) and both write canary value id 1 there, so one
# replaces the other's canary (ROADMAP C.3)
PROXY_STREAMS = 16
PROXY_WINDOW = 4
PROXY_PHT_PREFIX_LOOKUPS = 32
# the REPL script the dhtnode child reads after "kernels" and "b", its
# key ({key}) near the node's id so the node is among its storers
DHTNODE_SCRIPT = ("p {key} child payload", "g {key}", "stats", "q")
# the first farm address: row i of the live node answers at this + i
FARM_BASE = (127 << 24) | (1 << 16)


class PeerFarm:
    """Every row of the live node's table, answering on loopback from a
    process of its own (so its protocol work never holds the node's
    interpreter lock).

    Row i's address is 127.1.0.0 + i (the whole 127/8 is local on
    Linux) at one UDP port; one socket bound to every address receives
    each request with its destination (IP_PKTINFO), a NetworkEngine
    answers it as row i (its id set to row i's before each datagram: no
    closer nodes, a write token, every announce and listen acknowledged)
    and the reply leaves from row i's address.  So the node's own
    searches, announces and listens over its rows complete as in a live
    network, instead of expiring at rows that never answer.  The farm
    draws the rows itself (live_node_data, --serve-n)."""

    def __init__(self, args):
        require(args.serve_n < (1 << 24) - (1 << 16),
                "farm addresses fit 127/8")
        self.n = args.serve_n
        code = ("import sys; sys.path.insert(0, %r); import chip_smoke; "
                "chip_smoke.farm_serve(%d)"
                % (str(Path(__file__).resolve().parent), args.serve_n))
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
        self.proc = subprocess.Popen([sys.executable, "-c", code],
                                     stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, text=True,
                                     env=env)

    def ready(self) -> list:
        """Wait for the farm's port; every row's address."""
        import ipaddress
        from opendht_tpu_torch.sockaddr import SockAddr
        line = self.proc.stdout.readline()
        require(line.startswith("{"), f"the farm started: {line!r}")
        self.port = json.loads(line)["port"]
        # one address per row, built without parsing strings
        addrs = []
        for i in range(self.n):
            a = SockAddr.__new__(SockAddr)
            a._ip = ipaddress.IPv4Address(FARM_BASE + i)
            a._port = self.port
            addrs.append(a)
        return addrs

    def stop(self) -> dict:
        """End the farm; its request and error counts."""
        try:
            out, _ = self.proc.communicate("", timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            return {"requests": None, "errors": ["did not stop"]}
        lines = [l for l in out.splitlines() if l.startswith("{")]
        return json.loads(lines[-1]) if lines else {
            "requests": None, "errors": ["no report"]}


def farm_serve(n: int) -> None:
    """The PeerFarm process: print the port, answer until stdin closes,
    print the requests answered and the errors met."""
    import select
    import struct
    from types import SimpleNamespace
    from opendht_tpu_torch.infohash import InfoHash
    from opendht_tpu_torch.net.engine import (EngineCallbacks, NetworkEngine,
                                              RequestAnswer)
    from opendht_tpu_torch.ops import ids as IK
    from opendht_tpu_torch.scheduler import Scheduler
    from opendht_tpu_torch.sockaddr import SockAddr
    _, ids, _ = live_node_data(SimpleNamespace(serve_n=n, serve_q=1))
    raw = IK.ids_to_bytes(ids)
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setsockopt(socket.IPPROTO_IP, socket.IP_PKTINFO, 1)
    sock.bind(("0.0.0.0", 0))
    src = [b""]

    def send(data: bytes, dst) -> int:
        anc = [(socket.IPPROTO_IP, socket.IP_PKTINFO,
                struct.pack("I4s4s", 0, src[0], bytes(4)))]
        sock.sendmsg([data], anc, 0, (str(dst.ip), dst.port))
        return 0
    token = b"farm"
    eng = NetworkEngine(InfoHash(bytes(20)), 0, send, Scheduler(),
                        EngineCallbacks(
                            on_find_node=lambda n_, t, w:
                                RequestAnswer(ntoken=token),
                            on_get_values=lambda n_, h, w, q:
                                RequestAnswer(ntoken=token)),
                        max_req_per_sec=10**9)
    print(json.dumps({"port": sock.getsockname()[1]}), flush=True)
    requests, errors = 0, []
    while True:
        r = select.select([sock, sys.stdin], [], [], 1.0)[0]
        if sys.stdin in r and not sys.stdin.read(1):
            break
        if sock not in r:
            continue
        try:
            data, anc, _flags, addr = sock.recvmsg(65536, 256)
            dst = next(c[8:12] for lvl, typ, c in anc
                       if lvl == socket.IPPROTO_IP
                       and typ == socket.IP_PKTINFO)
            row = int.from_bytes(dst, "big") - FARM_BASE
            if not 0 <= row < len(raw):
                continue
            src[0] = dst
            eng.myid = InfoHash(raw[row].tobytes())
            eng.process_message(data, SockAddr(addr[0], addr[1]))
            requests += 1
        except Exception as e:                 # reported to the phase
            errors.append(repr(e))
    sock.close()
    print(json.dumps({"requests": requests, "errors": errors[:5],
                      "n_errors": len(errors)}), flush=True)


def _pht_linear(key: dict, spec: dict) -> bytes:
    """The PHT's linearized key, rebuilt on the host (reference
    pht.cpp:380-456): each field zero-padded to max(spec)+1 bytes with
    the first pad bit set, the fields (by name) bit-interleaved."""
    width = max(spec.values()) + 1
    fields = []
    for name in sorted(key):
        b = bytearray(key[name]) + bytes(width - len(key[name]))
        pad = 8 * len(key[name])
        b[pad // 8] ^= 0x80 >> (pad % 8)
        fields.append(int.from_bytes(bytes(b), "big"))
    nbits, out = 8 * width, 0
    for i in range(nbits):
        for f in fields:
            out = (out << 1) | ((f >> (nbits - 1 - i)) & 1)
    return out.to_bytes(nbits * len(fields) // 8, "big")


def _common_bits(a: bytes, b: bytes) -> int:
    x = int.from_bytes(a, "big") ^ int.from_bytes(b, "big")
    return 8 * len(a) - x.bit_length()


def rest_call(port: int, method: str, path: str, body=None):
    """One HTTP request to the proxy at 127.0.0.1:port: its status, body,
    latency (s) and headers."""
    import http.client
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    data = json.dumps(body).encode() if body is not None else None
    s = time.perf_counter()
    c.request(method, path, body=data,
              headers={"Content-Type": "application/json"} if data else {})
    r = c.getresponse()
    out = r.read()
    lat = time.perf_counter() - s
    headers = dict(r.getheaders())
    c.close()
    return r.status, out, lat, headers


class ListenStream:
    """A LISTEN /{hash} stream read on its own thread: every value line
    (heartbeats apart) as JSON."""

    def __init__(self, port: int, key_hex: str):
        import http.client
        import threading
        self.values, self.error = [], None
        self._c = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        self._c.request("LISTEN", "/" + key_hex)
        self._sock = self._c.sock
        self._r = self._c.getresponse()
        require(self._r.status == 200, f"LISTEN /{key_hex}: "
                f"{self._r.status}")
        self._t = threading.Thread(target=self._read, daemon=True)
        self._t.start()

    def _read(self) -> None:
        buf = b""
        try:
            while True:
                chunk = self._r.read1(65536)
                if not chunk:
                    return
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    obj = json.loads(line) if line.strip() else {}
                    if "id" in obj:
                        self.values.append(obj)
        except Exception as e:         # closed by close(), else reported
            self.error = e

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._c.close()
        self._t.join(5)


def _wait(pred, timeout: float = 60.0, step: float = 0.02) -> bool:
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(step)
    return pred()


def _listening(runner, key, n: int = 1) -> bool:
    """``runner`` holds ``n`` listener records on ``key``."""
    with runner._listeners_lock:
        recs = list(runner._listeners.values())
    return sum(1 for r in recs if bytes(r["key"]) == bytes(key)) >= n


def imported_modules(path: str) -> list:
    """The modules a ``python -X importtime`` child listed on its stderr
    (written to ``path``)."""
    return [l.split("|")[-1].strip() for l in
            Path(path).read_text().splitlines()
            if l.startswith("import time:")]


def jax_modules(mods) -> list:
    return sorted({m for m in mods
                   if m.split(".")[0] in ("jax", "jaxlib", "opendht_tpu")})


def phase_in_child(name: str, args, card):
    """Run the late phase ``name`` (proxy, monitor, cluster, smokes, hops,
    hops_ladder, soak) in a process of its own, as a server runs: a
    fresh interpreter, heap and metrics registry, none of what the
    earlier phases left (their nodes' per-peer series alone are ~22,000,
    and each history tick of a node walks every series on its thread).  Passes its output lines on;
    returns its window_select launches (the smokes, hop and soak phases:
    both select kernels', by name)."""
    here = str(Path(__file__).resolve().parent)
    code = ("import sys; sys.path.insert(0, %r); import chip_smoke; "
            "sys.exit(chip_smoke.phase_child())" % here)
    proc = subprocess.Popen([sys.executable, "-c", code, name,
                             json.dumps(vars(args)), json.dumps(card)],
                            stdout=subprocess.PIPE, text=True, cwd=here)
    launched = None
    for line in proc.stdout:
        if line.startswith('{"child_launches"'):
            launched = json.loads(line)["child_launches"]
        else:
            print(line, end="", flush=True)
    rc = proc.wait()
    require(rc == 0 and launched is not None,
            f"the {name} phase's process exited {rc}")
    return launched


def phase_child() -> int:
    """A late phase's process (see phase_in_child): argv holds the
    phase's name, the script's arguments and the card record, as JSON."""
    import torch
    phase = {"proxy": proxy_phase, "monitor": monitor_phase,
             "cluster": cluster_phase, "smokes": smokes_phase,
             "hops": hops_phase, "hops_ladder": hops_ladder_phase,
             "soak": soak_phase}[sys.argv[1]]
    args = argparse.Namespace(**json.loads(sys.argv[2]))
    card = json.loads(sys.argv[3])
    if args.cpu:
        torch.set_num_threads(2)
    dev = torch.device("cpu" if args.cpu else "cuda")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()
    launched = phase(args, dev, card, sync)
    print(json.dumps({"child_launches": launched}), flush=True)
    return 0


def proxy_phase(args, dev, card, sync) -> int:
    """The periphery (see the module docstring, phase 13): the REST
    proxy, the runner's proxy swap, the PHT and the dhtnode tool in
    front of the live node.  Returns the window_select launches of its
    proxied requests."""
    import concurrent.futures
    import ipaddress
    import random
    import threading
    from torch.profiler import ProfilerActivity, profile
    from opendht_tpu_torch import profiling, telemetry
    from opendht_tpu_torch.core import table as CT
    from opendht_tpu_torch.core.value import Value
    from opendht_tpu_torch.indexation.pht import MAX_NODE_ENTRY_COUNT, Pht
    from opendht_tpu_torch.infohash import InfoHash
    from opendht_tpu_torch.ops.window_select import window_select
    from opendht_tpu_torch.proxy import (DhtProxyServer, value_from_json,
                                         value_to_json)
    from opendht_tpu_torch.runtime import Config, DhtRunner, RunnerConfig

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    device = None if cuda else "cpu"
    AF = socket.AF_INET
    reg = telemetry.get_registry()
    failures0 = reg.counter("dht_ingest_wave_failures_total").value
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    record_dir = os.environ["OPENDHT_TPU_SMOKE_RECORD_DIR"]
    os.makedirs(record_dir, exist_ok=True)
    legs = {}

    # ---- (e), started first: the dhtnode tool as a child process ------
    # on the card unless this is the rehearsal; -X importtime lists every
    # module it imports (on its stderr, into the record directory); its
    # first command, the ledger, runs while the legs below do
    child_out = os.path.join(record_dir, "proxy_dhtnode.out")
    child_err = os.path.join(record_dir, "proxy_dhtnode.importtime")
    env = dict(os.environ)
    if not cuda:
        env["OMP_NUM_THREADS"] = "2"
    with open(child_out, "w") as fo, open(child_err, "w") as fe:
        child = subprocess.Popen(
            [sys.executable, "-u", "-X", "importtime", "-m",
             "opendht_tpu_torch.tools.dhtnode"] + ([] if cuda else ["--cpu"]),
            stdin=subprocess.PIPE, stdout=fo, stderr=fe, text=True,
            cwd=str(Path(__file__).resolve().parent), env=env)
    child.stdin.write("kernels\n")
    child.stdin.flush()

    sent = {"loopback": 0, "off_loopback": []}
    runners, streams, farm, server = [], [], None, None
    pool = concurrent.futures.ThreadPoolExecutor(PROXY_WINDOW)
    led = profiling.get_ledger()
    pumps = None
    try:
        with PortRecords() as records, LookupRoutes(cuda, sync) as lookups:
            # ---- (a) the live node behind its proxy, its rows a farm --
            t0 = time.perf_counter()
            farm = PeerFarm(args)           # starts while the node does
            node = DhtRunner()
            runners.append(node)
            node.run(0, RunnerConfig(
                dht_config=Config(max_req_per_sec=1_000_000)), device=device)
            require(node._udp is not None, "the node's native engine")
            udp_send = node._udp.send

            def send(data, addr):
                if ipaddress.ip_address(addr[0]).is_loopback:
                    sent["loopback"] += 1
                else:
                    sent["off_loopback"].append(addr)
                return udp_send(data, addr)
            node._udp.send = send
            _, ids, _ = live_node_data(args)
            addrs = farm.ready()
            farm_s = time.perf_counter() - t0
            loaded = concurrent.futures.Future()

            def load(dht):
                try:
                    dht.tables[AF].bulk_load(ids, dht.scheduler.time(),
                                             addrs=addrs)
                    dht.warmup()
                    sync()
                    loaded.set_result(len(dht.tables[AF]))
                except Exception as e:
                    loaded.set_exception(e)
            node._post(load, prio=True)
            rows = loaded.result(600)
            # the table keeps its rows' addresses compact: these objects
            # would otherwise stay for the cyclic collector to walk
            addrs = None
            # the start-up heap (the interpreter, torch, what the earlier
            # phases left) goes out of the collector's reach, as a server
            # freezes it once it is up: a full collection then walks only
            # what serving allocates, not the whole heap on the node's
            # thread
            gc.collect()
            gc.freeze()
            pumps = PumpTimes()
            pumps.add("node", node)
            pumps.gc["threads_at_start"] = sorted(
                t.name for t in threading.enumerate())
            pumps.gc["series_at_start"] = sum(
                len(v) for v in reg.snapshot().values()
                if isinstance(v, dict))
            require(rows == args.serve_n > CT.HOST_SCAN_MAX_ROWS,
                    f"{rows} rows loaded past the host scan")
            server = DhtProxyServer(node, port=0)
            spec = "127.0.0.1:%d" % server.port
            # the ledger's two lookup specs, so /stats has its gauges
            led.compute(["find_closest_nodes_batched", "wave_builder_lookup"],
                        device=dev)
            child.stdin.write("b 127.0.0.1:%d\n" % node.get_bound_port())
            child.stdin.flush()
            legs["setup_s"] = time.perf_counter() - t0
            # the child's first command, its ledger, runs on the card: the
            # node's traffic below waits for it, to have the card alone
            t0 = time.perf_counter()
            require(_wait(lambda: re.search(r"^\d+ kernels on ", Path(
                child_out).read_text(), re.M), timeout=300, step=0.25),
                "the dhtnode child's ledger: " + Path(child_out).read_text(
                )[-400:])
            legs["child_ledger_wait_s"] = time.perf_counter() - t0
            me = bytes(node.get_node_id())
            n_keys = max(PROXY_STREAMS, args.proxy_keys)
            keys = [InfoHash(k) for k in _near_keys(me, n_keys, 23)]
            lat = {}

            def timed(route, method, path, body=None):
                st, out, s, hdr = rest_call(server.port, method, path, body)
                lat.setdefault(route, []).append(s)
                return st, out, hdr

            # ---- (b) REST traffic on loopback --------------------------
            t0 = time.perf_counter()
            lookups.take()
            window_select.launches = 0
            st, _, hdr = timed("OPTIONS", "OPTIONS", "/" + keys[0].hex())
            require(st == 200 and "LISTEN" in hdr.get(
                "Access-Control-Allow-Methods", ""), "OPTIONS: CORS")
            for k in keys[:PROXY_STREAMS]:
                streams.append(ListenStream(server.port, k.hex()))
            require(_wait(lambda: all(_listening(node, k)
                                      for k in keys[:PROXY_STREAMS])),
                    "every LISTEN stream attached on the node")

            def post(i, vid, data):
                v = Value(data, value_id=vid)
                st, out, _ = timed("POST", "POST", "/" + keys[i].hex(),
                                   value_to_json(v))
                require(st == 200 and json.loads(out)["id"] == str(vid),
                        f"POST /{keys[i].hex()}: {st} {out[:200]}")

            t_rest = time.perf_counter()
            list(pool.map(lambda i: post(i, 1000 + i, b"proxy %d" % i),
                          range(n_keys)))
            list(pool.map(lambda i: post(i, 5000 + i, b"again %d" % i),
                          range(PROXY_STREAMS)))

            def rest_get(i):
                st, out, _ = timed("GET", "GET", "/" + keys[i].hex())
                require(st == 200, f"GET /{keys[i].hex()}: {st}")
                return sorted((v.id, v.get_packed()) for v in
                              (value_from_json(json.loads(l))
                               for l in out.splitlines() if l.strip()))

            def rest_get_vid(i):
                st, out, _ = timed("GET_vid", "GET", "/%s/%d"
                                   % (keys[i].hex(), 1000 + i))
                got = [json.loads(l) for l in out.splitlines() if l.strip()]
                require(st == 200 and [o["id"] for o in got]
                        == [str(1000 + i)], f"GET /{keys[i].hex()}/"
                        f"{1000 + i}: {st} {got}")
            rest_vals = list(pool.map(rest_get, range(n_keys)))
            list(pool.map(rest_get_vid, range(n_keys)))
            st, out, _ = timed("STATS", "STATS", "/")
            require(st == 200 and {"putCount", "listenCount", "nodeInfo"}
                    <= set(json.loads(out)), "STATS /")
            rest_wall = time.perf_counter() - t_rest
            launched = window_select.launches
            routes = LookupRoutes.routes(lookups.take())

            # each REST get against the node's direct get of the key
            def direct(i):
                return sorted((v.id, v.get_packed()) for v in
                              node.get_sync(keys[i], timeout=120))
            direct_vals = list(pool.map(direct, range(n_keys)))
            for i in range(n_keys):
                want = [1000 + i] + ([5000 + i] if i < PROXY_STREAMS else [])
                require([vid for vid, _ in rest_vals[i]] == want,
                        f"GET /{keys[i].hex()} holds the ids put: "
                        f"{rest_vals[i]}")
                require(rest_vals[i] == direct_vals[i], f"REST get {i} == "
                        "the node's direct get (ids and bytes)")
            for i, s in enumerate(streams):
                require(_wait(lambda: len(s.values) >= 2), f"stream {i}")
            time.sleep(0.2)
            for i, s in enumerate(streams):
                require([o["id"] for o in s.values]
                        == [str(1000 + i), str(5000 + i)],
                        f"LISTEN stream {i} heard each put once: "
                        f"{[o['id'] for o in s.values]}")
            # /stats and /profile serve the port's planes
            st, out, _ = timed("GET_stats", "GET", "/stats")
            kernel_gauges = {}
            for line in out.decode().splitlines():
                if line.startswith("dht_kernel_"):
                    name, val = line.rsplit(" ", 1)
                    kernel_gauges[name] = float(val)
            require(st == 200 and any(v > 0 for v in kernel_gauges.values()),
                    "GET /stats carries dht_kernel_* gauges")
            st, out, _ = timed("GET_profile", "GET", "/profile")
            ob = json.loads(out).get("open_bounds") or {}
            require(st == 200 and ob.get("platform") == dev.type
                    and ob.get("status") == ("candidate" if cuda
                                             else "unsettled"),
                    f"GET /profile's open bounds name the device: "
                    f"{ob.get('platform')} {ob.get('status')}")
            st, out, _ = timed("GET_listeners", "GET", "/listeners")
            require(st == 200 and json.loads(out)["enabled"], "/listeners")
            for route in ("keyspace", "reshard", "cache"):
                st, out, _ = timed("GET_" + route, "GET", "/" + route)
                require(st == 200 and "enabled" in json.loads(out),
                        f"GET /{route}")
            # device events of proxied gets
            sync()
            with profile(activities=acts) as prof:
                for i in range(8):
                    rest_call(server.port, "GET", "/" + keys[i].hex())
                sync()
            n_req = sum(len(v) for v in lat.values())
            legs["rest"] = {
                "requests": n_req, "wall_s": rest_wall,
                "requests_per_s": n_req / rest_wall, "window": PROXY_WINDOW,
                "latency_ms": {r: latency_ms(sorted(v))
                               for r, v in lat.items()},
                "equal_to_direct_get": n_keys,
                "listen_streams": {"streams": len(streams),
                                   "values_each": 2},
                "window_select_launches": launched, "routes": routes,
                "kernel_gauges": len(kernel_gauges),
                "open_bounds": {"platform": ob["platform"],
                                "status": ob["status"]},
                # read once the node has stopped: the profile's parse
                # holds the interpreter lock for most of a second
                "device_per_proxied_get": None,
                "delay_drops": len(records.delay_drops),
                "seconds": time.perf_counter() - t0}
            if cuda:
                require(launched >= 1, "window_select launched on the "
                        "proxied requests")
            proxied_gets = prof
            print(json.dumps({"proxy_rest": legs["rest"]}), file=sys.stderr,
                  flush=True)

            # ---- (c) the proxy swap -------------------------------------
            t0 = time.perf_counter()
            c = DhtRunner()
            runners.append(c)
            c.run(0, RunnerConfig(proxy_server=spec), device=device)
            pumps.add("client", c)
            require(_wait(lambda: c.use_proxy), "started proxied")
            c.bootstrap("127.0.0.1", node.get_bound_port())
            skeys = [InfoHash(k) for k in _near_keys(me, 2, 29)]
            heard = []
            c.listen(skeys[0], lambda vals, exp: heard.extend(
                (v.id, v.data) for v in vals if not exp) or True
                ).result(60)
            require(_wait(lambda: _listening(node, skeys[0])),
                    "the proxied listen attached")
            require(c.put_sync(skeys[1], Value(b"put through the proxy",
                                               value_id=71), timeout=60),
                    "a put through the proxy")
            require([(v.id, v.data) for v in c.get_sync(skeys[1],
                                                        timeout=60)]
                    == [(71, b"put through the proxy")],
                    "a get through the proxy")
            require(_wait(lambda: c.get_status() is
                          c._proxy_dht.get_status()
                          and c.get_status().name == "CONNECTED"),
                    "get_status follows the proxy")
            puts = []

            def put_heard(i):
                v = (900 + i, b"swap put %d" % i)
                puts.append(v)
                require(node.put_sync(skeys[0], Value(v[1], value_id=v[0]),
                                      timeout=60), f"swap put {i}")
                require(_wait(lambda: heard[-1:] == [v]),
                        f"swap put {i} heard: {heard}")
            put_heard(0)
            statuses = []
            for i, proxy in enumerate((None, spec), 1):
                c.enable_proxy(proxy)
                require(_wait(lambda: c.use_proxy is bool(proxy)),
                        f"swap {i} took")
                if proxy:
                    require(_wait(lambda: _listening(node, skeys[0])),
                            "the listener re-attached through the proxy")
                    require(c.get_status() is c._proxy_dht.get_status(),
                            "get_status follows the proxy again")
                else:
                    require(c._proxy_dht is None and _wait(
                        lambda: c.get_status().name == "CONNECTED"),
                        "back on UDP, connected")
                    # the proxy's LISTEN handler drops the old stream at
                    # its next heartbeat
                    require(_wait(lambda: not _listening(node, skeys[0])),
                            "the proxied listen detached")
                    require(c.get_status() is max((c.status4, c.status6),
                                                  key=lambda s: s.value),
                            "get_status follows the UDP node")
                statuses.append((c.use_proxy, c.get_status().name))
                put_heard(i)
            time.sleep(0.5)
            require(heard == puts, f"each swap put heard once: {heard}")
            legs["swap"] = {"swaps": 2, "puts_heard_once": len(puts),
                            "statuses": statuses,
                            "delay_drops": len(records.delay_drops),
                            "seconds": time.perf_counter() - t0}

            # ---- (d) the PHT over the proxied runner --------------------
            t0 = time.perf_counter()
            kspec = {"name": 4, "kind": 1}
            n_pht = max(MAX_NODE_ENTRY_COUNT + 1, args.pht_entries)
            prng = np.random.default_rng(31)
            pht = Pht("proxy-phase", kspec, c, rng=random.Random(31))
            host = {}                       # linearized key -> values
            entries = []
            for j in range(n_pht):
                key = {"name": prng.integers(0, 256, 4, np.uint8).tobytes(),
                       "kind": bytes([int(prng.integers(0, 4))])}
                val = (InfoHash.get("pht-%d" % j), j + 1)
                entries.append((key, val))
                host.setdefault(_pht_linear(key, kspec), set()).add(
                    (bytes(val[0]), val[1]))

            def sync_op(start, timeout=120):
                fut = concurrent.futures.Future()
                start(lambda *a: fut.done() or fut.set_result(a))
                return fut.result(timeout)
            for key, val in entries:
                ok, = sync_op(lambda cb: pht.insert(key, val, cb))
                require(ok, f"PHT insert {key}")
            insert_s = time.perf_counter() - t0
            # a leaf split re-inserts the entries already stored there
            # from split watches (listens one level deeper), after the
            # insert that split it returned: look up once the index has
            # settled, no proxied request for a second
            t1, last = time.perf_counter(), -1
            while server.stats.total_requests != last:
                last = server.stats.total_requests
                time.sleep(1.0)
                require(time.perf_counter() - t1 < 120,
                        "the PHT settled within 120 s")
            settle_s = time.perf_counter() - t1

            def lookup(key, exact):
                got = set()
                ok, = sync_op(lambda cb: pht.lookup(
                    key, lambda vals, p: got.update(
                        (bytes(h), v) for h, v in vals), cb,
                    exact_match=exact))
                require(ok, f"PHT lookup {key}")
                return got

            def exact(e):
                got = lookup(e[0], True)
                require(got == host[_pht_linear(e[0], kspec)],
                        f"PHT exact lookup {e[0]}: {got}")

            def inexact(n):
                # an entry's key with its last name byte changed, held to
                # the entries sharing the most leading bits with it
                key = dict(entries[n][0])
                key["name"] = key["name"][:3] + bytes([key["name"][3] ^ 1])
                lin = _pht_linear(key, kspec)
                best = max(_common_bits(lin, k) for k in host)
                want = set().union(*(v for k, v in host.items()
                                     if _common_bits(lin, k) == best))
                got = lookup(key, False)
                require(got == want, f"PHT prefix lookup {n}: {got} "
                        f"!= {want}")
            t1 = time.perf_counter()
            list(pool.map(exact, entries))
            list(pool.map(inexact, range(min(PROXY_PHT_PREFIX_LOOKUPS,
                                             n_pht))))
            legs["pht"] = {
                "entries": n_pht, "key_spec": kspec,
                "exact_lookups": n_pht,
                "prefix_lookups": min(PROXY_PHT_PREFIX_LOOKUPS, n_pht),
                "insert_s": insert_s, "settle_s": settle_s,
                "inserts_per_s": n_pht / insert_s,
                "lookups_s": time.perf_counter() - t1,
                "delay_drops": len(records.delay_drops),
                "seconds": time.perf_counter() - t0}
            print(json.dumps({"proxy_pht": legs["pht"]}), file=sys.stderr,
                  flush=True)

            # ---- (e) the dhtnode child: the rest of its script ----------
            t0 = time.perf_counter()
            try:
                ckey = InfoHash(_near_keys(me, 1, 37)[0])
                child.communicate("\n".join(DHTNODE_SCRIPT).format(
                    key=ckey.hex()) + "\n", timeout=300)
            except subprocess.TimeoutExpired:
                child.kill()
                child.wait()
                raise RuntimeError("chip_smoke: the dhtnode child did not "
                                   "finish its script")
            out_text = Path(child_out).read_text()
            imported = imported_modules(child_err)
            bad = jax_modules(imported)
            specs = profiling.KERNEL_SPECS
            named = [n for n in specs
                     if re.search(r"^%s\s+\d+\s" % n, out_text, re.M)]
            require(child.returncode == 0, f"dhtnode exited "
                    f"{child.returncode}: {out_text[-400:]}")
            require(not bad, f"the dhtnode child loaded no JAX: {bad}")
            require(len(imported) > 100 and "opendht_tpu_torch.tools.common"
                    in imported, "the child's import list was read")
            require(len(named) == len(specs) == 16, f"dhtnode kernels named "
                    f"{len(named)} of the 16 ledger specs")
            require("16 kernels on %s" % dev.type in out_text,
                    "the child's ledger ran on the device")
            require("Put: True" in out_text and "Get: 1 value(s)" in out_text
                    and "child payload" in out_text,
                    "the child's put and get: " + out_text[-600:])
            require('dht_kernel_launches{kernel=\\"swarm_step\\"}'
                    in out_text, "the child's stats carry its ledger")
            require([v.data for v in node.get_sync(ckey, timeout=60)]
                    == [b"child payload"], "the child's put reached the node")
            legs["health_transitions"] = [
                {"runner": name, **b["transition"]}
                for name, r in (("node", node), ("client", c))
                for b in r.get_bundles() if "transition" in b]
            legs["dhtnode"] = {"device": dev.type, "kernels_named":
                               len(named), "jax_modules": bad,
                               "modules_imported": len(imported),
                               "wait_s": time.perf_counter() - t0}
    finally:
        for s in streams:
            s.close()
        pool.shutdown()
        if child.poll() is None:
            child.kill()
            child.wait()
        for r in reversed(runners):
            r.join()
        if server is not None:
            server.stop()
        farm_report = farm.stop() if farm is not None else {}
        led.clear()
        if pumps is not None:
            pumps.close()
        gc.unfreeze()
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith(("dht", "proxy", "farm"))]
    failures = reg.counter("dht_ingest_wave_failures_total").value - failures0
    pumps.gc["series_at_end"] = sum(len(v) for v in reg.snapshot().values()
                                    if isinstance(v, dict))
    legs["rest"]["device_per_proxied_get"] = device_totals(proxied_gets,
                                                           cuda, per=8)
    emit({"phase": "proxy", **card, "rows": rows, "farm": {
              "requests": farm_report.get("requests"),
              "errors": farm_report.get("n_errors"), "ready_s": farm_s},
          **legs, "ingest_wave_failures": failures,
          "error_records": len(records.errors),
          "delay_drops": len(records.delay_drops),
          "dht_threads": pumps.report(records.drop_threads),
          "planes_dark_records": len(records.dark),
          "datagrams_sent": {"loopback": sent["loopback"],
                             "off_loopback": len(sent["off_loopback"])},
          "live_threads": alive,
          "phase_s": time.perf_counter() - t_phase})
    require(farm_report.get("n_errors") == 0 and farm_report["requests"],
            f"the farm answered every datagram: {farm_report}")
    require(failures == 0, "no ingest wave failed")
    require(not records.errors, "no ERROR record from the port's loggers: "
            + "; ".join(records.errors[:3]))
    if cuda:
        # the node's DHT thread keeps up on the card's host; a rehearsal
        # beside other busy processes reports its lag, it does not fail
        require(not records.delay_drops, "no packet dropped for its delay")
    require(not records.dark, "no plane went dark: "
            + "; ".join(records.dark[:3]))
    require(not sent["off_loopback"], "every datagram stayed on loopback")
    require(not alive, f"every runner, proxy and farm thread joined: {alive}")
    return legs["rest"]["window_select_launches"]


# ---- the monitor phase (phase 19) --------------------------------------
# Puts and gets the monitor phase's cluster keeps unanswered, and the
# keys it drives from one node towards the peer behind the dropped link:
# a window's worth, all in flight before A's first request to B expires
# (that expiry marks B expired in A's table and A sends it nothing more).
MONITOR_WINDOW = 16
MONITOR_LINK_KEYS = MONITOR_WINDOW


def drop_link(net, ia: int, ib: int, seed: int,
              timeout: float = 30.0) -> dict:
    """Drop the directed link from ``net.nodes[ia]`` (A) to
    ``net.nodes[ib]`` (B) with a chaos LinkRule, drive
    MONITOR_LINK_KEYS gets from A towards B's id at once, and wait until
    at least 3 of A's requests to B have expired; then lift the rule.
    Returns A's peer record of B (``get_peers``) and B's status in A's
    ledger before and after the ping below.

    A pings B and waits for the answer before the link drops: one
    request of A's to B that the loaded earlier traffic let expire marks
    B expired in A's table, A's searches skip an expired node, and
    nothing B sends clears the mark while A's replies are dropped, so
    without the ping A may send B nothing to expire."""
    from opendht_tpu_torch import chaos
    from opendht_tpu_torch.infohash import InfoHash

    a, b = net.nodes[ia], net.nodes[ib]
    b_hex = str(b.get_node_id())

    def a_to_b() -> dict:
        return next((p for p in a.get_peers().get("peers", [])
                     if p["id"] == b_hex), None) or {}
    before = a_to_b().get("status")
    pong, answered = threading.Event(), []
    a._ping(("127.0.0.1", b.get_bound_port()),
            lambda ok: (answered.append(ok), pong.set()))
    require(pong.wait(timeout) and answered[0],
            f"B answered A's ping before the drop: {a_to_b()}")
    pinged = a_to_b().get("status")
    net.arm(chaos.FaultPlan([chaos.Phase("drop", 0.0, None, rules=[
        chaos.LinkRule(name="drop", src="a", dst="b", loss=1.0)])],
        seed=seed), groups={ia: "a", ib: "b"})
    try:
        b_id = bytes(b.get_node_id())
        events = [threading.Event() for _ in range(MONITOR_LINK_KEYS)]
        for i, ev in enumerate(events):
            a.get(InfoHash(_near_id(b_id, 150, b"link-%d" % i)),
                  lambda vals: True, lambda ok, ns, _ev=ev: _ev.set())
        for ev in events:
            require(ev.wait(120), "a get towards B finished")
        require(_wait(lambda: a_to_b().get("expired", 0) >= 3, timeout),
                f"A's requests to B expired: {a_to_b()}")
    finally:
        net.disarm()
    return {"record": a_to_b(), "status_before_ping": before,
            "status_after_ping": pinged}


def closest_np(ids: np.ndarray, key: bytes, k: int) -> list:
    """The ``k`` rows of ``ids`` (uint8 [N, 20]) XOR-closest to ``key``,
    by a plain numpy scan."""
    d = ids ^ np.frombuffer(key, np.uint8)
    return list(np.lexsort(d.T[::-1])[:k])


def monitor_phase(args, dev, card, sync) -> int:
    """The monitor, the scenario harness and the assemblers (see the
    module docstring, phase 19).  Returns the window_select launches of
    the coverage probe's resolves."""
    import threading
    from torch.profiler import ProfilerActivity, profile
    from opendht_tpu_torch.core.value import Value
    from opendht_tpu_torch.infohash import InfoHash
    from opendht_tpu_torch.ops.window_select import window_select
    from opendht_tpu_torch.peers import PeersConfig
    from opendht_tpu_torch.proxy import DhtProxyServer
    from opendht_tpu_torch.runtime import Config
    from opendht_tpu_torch.testing import DhtNetwork
    from opendht_tpu_torch.testing import health_monitor as hm
    from opendht_tpu_torch.testing import timeline_assembler as ta
    from opendht_tpu_torch.testing import wiremap_assembler as wma
    from opendht_tpu_torch.tools import dhtmon

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    device = None if cuda else "cpu"
    n, n_keys = args.monitor_runners, args.monitor_keys
    n_gets = n_keys // 4
    here = str(Path(__file__).resolve().parent)
    record_dir = os.environ["OPENDHT_TPU_SMOKE_RECORD_DIR"]
    os.makedirs(record_dir, exist_ok=True)
    env = dict(os.environ)
    if not cuda:
        env["OMP_NUM_THREADS"] = "2"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    legs, spawned = {}, []

    def spawn(name: str, argv: list, device_flag: bool = True):
        """A harness CLI as a child, on the card unless this is the
        rehearsal (``--cpu``, for a CLI with a device); -X importtime
        lists its modules on its stderr."""
        fo = open(os.path.join(record_dir, f"monitor_{name}.out"), "w")
        fe = open(os.path.join(record_dir, f"monitor_{name}.importtime"),
                  "w")
        proc = subprocess.Popen(
            [sys.executable, "-u", "-X", "importtime", "-m"] + argv
            + ([] if cuda or not device_flag else ["--cpu"]),
            stdout=fo, stderr=fe, text=True,
            cwd=here, env=env)
        fo.close()
        fe.close()
        spawned.append(proc)
        return proc

    def finish(name: str, proc, timeout: float = 300.0,
               rcs=(0,)) -> dict:
        """Wait for a child; its rc (one of ``rcs``), its JSON line and
        its JAX modules."""
        try:
            proc.wait(timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise RuntimeError(f"chip_smoke: the {name} child did not "
                               "finish")
        out = Path(record_dir, f"monitor_{name}.out").read_text()
        mods = imported_modules(os.path.join(
            record_dir, f"monitor_{name}.importtime"))
        require(proc.returncode in rcs, f"the {name} child exited "
                f"{proc.returncode}: {out[-400:]}")
        require(len(mods) > 50 and "torch" in mods,
                f"the {name} child's import list was read")
        lines = [l for l in out.splitlines() if l.startswith("{")]
        return {"rc": proc.returncode, "jax_modules": jax_modules(mods),
                "doc": json.loads(lines[-1]) if lines else None}

    # ---- (d), started first: the harness CLIs as children --------------
    t_children = time.perf_counter()
    children = {
        "benchmark": spawn("benchmark", [
            "opendht_tpu_torch.testing.benchmark", "-t", "gets", "-n",
            str(n), "-r", "1", "-g", "16", "--seed", str(args.seed)]),
        "pingpong": spawn("pingpong", ["opendht_tpu_torch.testing.pingpong",
                                       "-n", "20"])}

    net, proxies = None, []
    gate = threading.BoundedSemaphore(MONITOR_WINDOW)
    try:
        with PortRecords() as records, LookupRoutes(cuda, sync) as lookups:
            # ---- (a) the cluster, each runner behind its proxy ---------
            t0 = time.perf_counter()
            # every runner shares the loopback address: the per-IP quota
            # a deployment applies to one peer would throttle them all
            net = DhtNetwork(n, config=Config(max_req_per_sec=1_000_000),
                             seed=args.seed, device=device)
            proxies = [DhtProxyServer(r, port=0) for r in net.nodes]
            by_runner = dict(zip(map(id, net.nodes), proxies))
            require(net.wait_connected(60), "the cluster connected")
            legs["setup_s"] = time.perf_counter() - t0
            eps = ["127.0.0.1:%d" % p.port for p in proxies]

            # ---- (b) traffic: puts through random nodes, then gets -----
            rng = np.random.default_rng(args.seed + 19)
            raw = rng.integers(0, 256, size=(n_keys, 20), dtype=np.uint8)
            keys = [InfoHash(raw[i].tobytes()) for i in range(n_keys)]
            require(len({bytes(k) for k in keys}) == n_keys,
                    "distinct keys")
            putter = rng.integers(0, n, size=n_keys)
            want = {i: (i + 1, b"monitor value %d" % i)
                    for i in range(n_keys)}

            def windowed(calls) -> list:
                """Run ``calls`` (each taking a done callback), at most
                MONITOR_WINDOW unanswered at a time; their results."""
                results = [None] * len(calls)
                events = [threading.Event() for _ in calls]
                for i, call in enumerate(calls):
                    gate.acquire()

                    def done(res, _i=i):
                        results[_i] = res
                        events[_i].set()
                        gate.release()
                    call(done)
                for e in events:
                    require(e.wait(120), "an operation finished")
                return results

            def put(i):
                return lambda done: net.nodes[putter[i]].put(
                    keys[i], Value(want[i][1], value_id=want[i][0]),
                    lambda ok, ns: done(ok))

            # an operation whose datagrams the loaded one-process cluster
            # dropped (the runner drops packets queued past 0.5 s) is
            # sent again, as a client would, at most twice; the retries
            # are reported
            t0 = time.perf_counter()
            oks = windowed([put(i) for i in range(n_keys)])
            failed = [i for i in range(n_keys) if not oks[i]]
            retried = {"puts": len(failed), "gets": 0}
            for _ in range(2):
                if failed:
                    oks = windowed([put(i) for i in failed])
                    failed = [i for i, ok in zip(failed, oks) if not ok]
            legs["put_s"] = time.perf_counter() - t0
            require(not failed, f"{len(failed)} puts failed three times")
            getter = (putter[:n_gets] + 1
                      + rng.integers(0, n - 1, size=n_gets)) % n
            got = [[] for _ in range(n_gets)]

            def get(i):
                got[i] = []
                return lambda done: net.nodes[getter[i]].get(
                    keys[i], lambda vals: got[i].extend(
                        (v.id, v.data) for v in vals) or True,
                    lambda ok, ns: done(ok))
            t0 = time.perf_counter()
            windowed([get(i) for i in range(n_gets)])
            missed = [i for i in range(n_gets) if got[i] != [want[i]]]
            retried["gets"] = len(missed)
            for _ in range(2):
                if missed:
                    windowed([get(i) for i in missed])
                    missed = [i for i in missed if got[i] != [want[i]]]
            legs["get_s"] = time.perf_counter() - t0
            equal = sum(1 for i in range(n_gets) if got[i] == [want[i]])
            require(equal == n_gets, f"{n_gets - equal} of {n_gets} gets "
                    "did not return their put's value id and bytes")
            legs["traffic"] = {
                "puts": n_keys, "gets": n_gets, "equal_gets": equal,
                "window": MONITOR_WINDOW, "retried": retried,
                "puts_per_s": n_keys / legs["put_s"],
                "gets_per_s": n_gets / legs["get_s"],
                "getter_is_putter": int((getter == putter[:n_gets]).sum())}
            require(legs["traffic"]["getter_is_putter"] == 0,
                    "every get came from another node than its putter")
            lookups.take()

            # ---- (c) dhtmon with the coverage probe on the device ------
            # the CLI as a child, its imports overlapping the legs below
            # (the CLI scrapes over HTTP and has no device to choose)
            t_cli = time.perf_counter()
            cli = spawn("dhtmon", ["opendht_tpu_torch.tools.dhtmon",
                                   "--nodes", ",".join(eps),
                                   "--require-ready", "--json"],
                        device_flag=False)
            probed = []
            closest_ids = hm.closest_ids

            def recorded(table, ks, **kw):
                out = closest_ids(table, ks, **kw)
                probed.append((list(ks), out))
                return out
            hm.closest_ids = recorded
            since = time.perf_counter() - t_phase + 60.0
            checks = dict(require_ready=True, min_success=0.99,
                          min_coverage=0.95, sample_max=n_keys, k=8,
                          since=since, max_peer_fail=0.5,
                          max_stage={"queue_wait": 5.0}, device=device)
            try:
                t0 = time.perf_counter()
                window_select.launches = 0
                violations, doc = dhtmon.run_checks(eps, runners=net.nodes,
                                                    **checks)
                sync()
                launched = window_select.launches
                legs["dhtmon_s"] = time.perf_counter() - t0
            finally:
                hm.closest_ids = closest_ids
            probe_lookups = lookups.take()
            cov = doc["replica_coverage"]
            # the verdict is checked once the phase line is out, so that
            # an unhealthy cluster still reports what the other legs saw
            unhealthy = None
            if violations:
                unhealthy = {"violations": violations,
                             "health": hm.scrape_node(eps[0])["health"]}
            require(cov["keys"] == n_keys and len(probed) == 1
                    and len(probed[0][0]) == n_keys,
                    f"the probe resolved all {n_keys} keys in one call")
            require([lk["q"] for lk in probe_lookups
                     if lk["route"] == "snapshot"] == [n_keys],
                    f"the probe took the device snapshot: {probe_lookups}")
            if cuda:
                require(launched >= 1, "the probe launched window_select")
            # exact: the probe's closest-8 lists against a numpy XOR scan
            # of the census, its held counts against a host recount
            census = np.frombuffer(b"".join(bytes(r.get_node_id())
                                            for r in net.nodes),
                                   np.uint8).reshape(n, 20)
            node_hex = [str(r.get_node_id()) for r in net.nodes]
            held = hm.stored_keys(net.nodes)
            per_key = {p["key"]: p for p in cov["per_key"]}
            mismatched = 0
            for key, ids in zip(*probed[0]):
                exact = [node_hex[j] for j in closest_np(census, bytes(key),
                                                         8)]
                p = per_key[key.hex()]
                if [str(i) for i in ids] != exact or (
                        p["expected"], p["held"]) != (
                        8, sum(1 for h in exact if h in held[key])):
                    mismatched += 1
            require(mismatched == 0, f"{mismatched} keys' closest-8 or held "
                    "counts differ from the numpy scan and recount")
            # the probe alone, timed and traced
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                hm.replica_coverage(net.nodes, sample_max=n_keys, k=8,
                                    device=device)
                sync()
                probe_ms = (time.perf_counter() - t0) * 1e3
            lookups.take()
            legs["dhtmon"] = {
                "violations": violations, "window_select_launches": launched,
                "keys": cov["keys"], "mean_coverage": cov["mean_coverage"],
                "min_coverage": cov["min_coverage"],
                "closest8_equal_numpy": n_keys - mismatched,
                "lookup_success": doc["lookup_success"],
                "window_source": doc["window_source"],
                "peer_fail_max": doc["peer_fail"]["max"],
                "queue_wait_p95": doc["stages"]["worst"]["queue_wait"]["p95"],
                "not_ready": [s["endpoint"] for s in doc["nodes"]
                              if not s["ready"]],
                "unhealthy": unhealthy,
                "probe_ms": probe_ms,
                "probe_device": device_totals(prof, cuda)}

            # the CLI's report, before the link drops: the 16 gets that
            # the drop leg lets expire count in the process-wide
            # dht_ops_total series that every node's get-availability
            # SLO reads, and a scrape after them found all 16 nodes
            # unhealthy
            cli_out = finish("dhtmon", cli, rcs=(0, 1))
            require(cli_out["doc"] is not None
                    and len(cli_out["doc"]["nodes"]) == n
                    and (cli_out["rc"] == 1) == bool(
                        cli_out["doc"]["violations"]),
                    f"the dhtmon CLI's report: {cli_out['doc']}")
            require(not cli_out["jax_modules"], "the dhtmon child loaded no "
                    f"JAX: {cli_out['jax_modules']}")
            if cuda:
                require(cli_out["rc"] == 0, "the dhtmon CLI exited 0: "
                        f"{cli_out['doc']['violations']}")
            legs["dhtmon_cli"] = {"rc": cli_out["rc"], "nodes": n,
                                  "jax_modules": cli_out["jax_modules"],
                                  "s": time.perf_counter() - t_cli}

            # ---- (d) one directed link dropped: the wire map finds it --
            t0 = time.perf_counter()
            ia, ib = (int(i) for i in rng.choice(np.arange(1, n), 2,
                                                 replace=False))
            a, b = net.nodes[ia], net.nodes[ib]
            dropped = drop_link(net, ia, ib, args.seed)
            docs = [wma.scrape_peers(ep) for ep in eps]
            require(all(d is not None for d in docs), "every GET /peers")
            wm = wma.assemble_wiremap(docs)
            # the edges dhtmon's max_peer_fail gate reads: a link's fail
            # ratio is published once it has carried min_signal_events
            # requests. Dropping A -> B also drops A's replies, so B's
            # few requests to A fail too; below that floor they are no
            # signal to the gate, and none to this ranking
            floor = PeersConfig.min_signal_events
            every = wma.rank_edges(wm, "fail_ratio")
            ranked = [e for e in every if e.get("sent", 0) >= floor]
            worst = ranked[0] if ranked else None
            found = worst is not None and (worst["src"], worst["dst"]) == (
                str(a.get_node_id()), str(b.get_node_id()))
            require(not wm["violations"], f"wire map: {wm['violations']}")
            legs["wiremap"] = {
                "edges": len(wm["edges"]), "nodes": len(wm["nodes"]),
                "b_in_a_before_ping": dropped["status_before_ping"],
                "b_in_a_after_ping": dropped["status_after_ping"],
                "a_to_b": {k: dropped["record"].get(k) for k in (
                    "sent", "completed", "expired", "attempt_timeouts")},
                "signal_floor": floor,
                "edges_below_floor": len(every) - len(ranked),
                "worst_is_the_dropped_link": found,
                "top": [(e["src"][:8], e["dst"][:8], e["fail_ratio"],
                         e.get("sent"))
                        for e in ranked[:4]],
                "top_below_floor": [(e["src"][:8], e["dst"][:8],
                                     e["fail_ratio"], e.get("sent"))
                                    for e in every[:4]
                                    if e.get("sent", 0) < floor],
                "worst": ({"src": worst["src"][:16],
                           "dst": worst["dst"][:16],
                           "fail_ratio": worst["fail_ratio"],
                           "expired": worst.get("expired")}
                          if worst is not None else None),
                "next_fail_ratio": (ranked[1]["fail_ratio"]
                                    if len(ranked) > 1 else None),
                "s": time.perf_counter() - t0}

            # the timeline over every node's history bundle
            t0 = time.perf_counter()
            tl = ta.assemble_timeline([r.dump_bundle() for r in net.nodes])
            require(len(tl["nodes"]) == n and not tl["violations"]
                    and tl["frames"], f"the timeline: {len(tl['nodes'])} "
                    f"nodes, violations {tl['violations'][:3]}")
            legs["timeline"] = {"nodes": len(tl["nodes"]),
                                "frames": len(tl["frames"]),
                                "events": len(tl["events"]),
                                "violations": tl["violations"],
                                "s": time.perf_counter() - t0}

            # ---- (c) again: two nodes removed, coverage must fall -------
            t0 = time.perf_counter()
            for _ in range(2):
                before = set(map(id, net.nodes))
                net.shutdown_node()
                gone = before - set(map(id, net.nodes))
                for g in gone:
                    by_runner.pop(g).stop()
            window_select.launches = 0
            v2, doc2 = dhtmon.run_checks(runners=net.nodes, min_coverage=1.0,
                                         sample_max=n_keys, k=8,
                                         device=device)
            sync()
            launched += window_select.launches
            cov2 = doc2["replica_coverage"]
            if len(net.nodes) > 8:
                # with more than k=8 nodes left, the closest 8 of some
                # keys now take in nodes that never held them; with 8 or
                # fewer every node is among every key's closest 8
                require(any("replica coverage" in v for v in v2)
                        and cov2["mean_coverage"] < cov["mean_coverage"],
                        f"two nodes removed: coverage "
                        f"{cov2['mean_coverage']} (was "
                        f"{cov['mean_coverage']}), violations {v2}")
            legs["removal"] = {"nodes": len(net.nodes), "violations": v2,
                               "mean_coverage": cov2["mean_coverage"],
                               "keys": cov2["keys"],
                               "s": time.perf_counter() - t0}
            lookups.take()

            # ---- (d) the harness CLIs' children -------------------------
            for name, proc in children.items():
                res = finish(name, proc)
                require(not res["jax_modules"], f"the {name} child loaded "
                        f"no JAX: {res['jax_modules']}")
                legs[name] = res
            require(legs["benchmark"]["doc"]["count"] == 16,
                    f"benchmark: {legs['benchmark']['doc']}")
            require(legs["pingpong"]["doc"]["count"] >= 1,
                    f"pingpong: {legs['pingpong']['doc']}")
            legs["children_s"] = time.perf_counter() - t_children
    finally:
        for proc in spawned:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for p in proxies:
            p.stop()
        if net is not None:
            net.shutdown()
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith(("dht", "proxy"))]
    emit({"phase": "monitor", **card, "runners": n, "keys": n_keys,
          **legs, "error_records": len(records.errors),
          "delay_drops": len(records.delay_drops),
          "planes_dark_records": len(records.dark), "live_threads": alive,
          "phase_s": time.perf_counter() - t_phase})
    if cuda:
        # the verdict and the worst link depend on the cluster keeping
        # up with its traffic: on the card they must hold; a rehearsal
        # beside other busy processes reports them
        require(legs["dhtmon"]["unhealthy"] is None, "dhtmon: the "
                f"cluster is healthy as run: {legs['dhtmon']['unhealthy']}")
        require(legs["wiremap"]["worst_is_the_dropped_link"], "the dropped "
                f"link is the worst edge: {legs['wiremap']['top']}")
    require(not records.errors, "no ERROR record from the port's loggers: "
            + "; ".join(records.errors[:3]))
    require(not records.dark, "no plane went dark: "
            + "; ".join(records.dark[:3]))
    require(not alive, f"every runner and proxy thread joined: {alive}")
    return launched


# ---- the cluster phase (phase 20) --------------------------------------
# The RPC limit of the cluster phase's children: above the 30 s a child's
# own put_sync / get_sync may wait on a search past a killed child.
CLUSTER_RPC_S = 120.0
# Keys the cluster phase's monitor probes a round, and its rounds.
CLUSTER_MONITOR_KEYS = 8
CLUSTER_MONITOR_ROUNDS = 2


def card_used_mib() -> int:
    """The card's memory in use, MiB, as nvidia-smi reads it."""
    return int(subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])


def card_memory() -> dict:
    """The card's memory in use (MiB) and each compute process's, by pid,
    as nvidia-smi lists them (a container may list no pid)."""
    used = card_used_mib()
    apps = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    by_pid = {}
    for line in apps.splitlines():
        pid, _, mib = line.partition(",")
        if pid.strip().isdigit() and mib.strip().isdigit():
            by_pid[int(pid)] = int(mib)
    return {"used_mib": used, "by_pid": by_pid}


def jax_libraries(pid: int) -> list:
    """The JAX libraries mapped into process ``pid`` (/proc/<pid>/maps)."""
    return sorted({l.split()[-1] for l in
                   Path(f"/proc/{pid}/maps").read_text().splitlines()
                   if re.search(r"/(jax|jaxlib|libtpu)[/_.-]", l)})


def cluster_phase(args, dev, card, sync) -> int:
    """The cluster tools (see the module docstring, phase 20).  Returns
    the window_select launches of the census's two calls."""
    import contextlib
    import io
    import urllib.parse
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor
    import torch
    from torch.profiler import ProfilerActivity, profile
    from opendht_tpu_torch.infohash import InfoHash
    from opendht_tpu_torch.ops.window_select import window_select
    from opendht_tpu_torch.runtime.config import NodeStatus
    from opendht_tpu_torch.runtime.runner import DhtRunner
    from opendht_tpu_torch.testing import health_monitor as hm
    from opendht_tpu_torch.testing import netns_net, network_monitor
    from opendht_tpu_torch.testing.http_server import DhtHttpServer
    from opendht_tpu_torch.testing.scanner import Scanner
    from opendht_tpu_torch.testing.subproc_cluster import ClusterSubProcess

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    device = None if cuda else "cpu"
    C, per, n_keys = (args.cluster_children, args.cluster_nodes,
                      args.cluster_keys)
    require(C >= 2 and per >= 1 and n_keys > 64, "the cluster phase needs "
            "two children and more than 64 keys (the census's device route)")
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    legs, children, runner, http, launched = {}, [], None, None, 0
    pool = ThreadPoolExecutor(max_workers=C)

    def each(fn, items) -> list:
        """``fn`` over ``items``, one parent thread each (an RPC blocks)."""
        return list(pool.map(fn, items))

    try:
        with PortRecords() as records, \
                LookupRoutes(cuda, sync) as lookups:
            # ---- 1. the children, started at once -----------------------
            if cuda:
                # this process's own context first: the card's memory
                # before and after the children's start differs by theirs
                torch.zeros(1, device=dev)
                sync()
            mem0 = card_memory() if cuda else None
            t0 = time.perf_counter()
            spawn_t = []
            for _ in range(C):
                spawn_t.append(time.perf_counter())
                children.append(ClusterSubProcess(timeout=CLUSTER_RPC_S,
                                                  device=device))
            if cuda:
                # a process's first profiler session starts CUPTI (6.4 s
                # on the card's host): pay it while the children boot
                with profile(activities=acts):
                    pass

            def launch(i):
                children[i].launch(per)
                return time.perf_counter() - spawn_t[i]
            start_s = each(launch, range(C))
            legs["start_s"] = time.perf_counter() - t0
            mem1 = card_memory() if cuda else None
            t0 = time.perf_counter()
            seed = ("127.0.0.1", children[0].ports[0])
            each(lambda c: c.bootstrap(*seed), children[1:])
            runner = DhtRunner()
            runner.run(0, device=device)
            runner.bootstrap(*seed)
            require(_wait(lambda: runner.get_status()
                          is NodeStatus.CONNECTED, 30),
                    "the parent runner connected")
            legs["connect_s"] = time.perf_counter() - t0
            pids = [c.proc.pid for c in children]
            legs["children"] = [{
                "pid": pid, "start_s": s, "nodes": len(c.ports),
                "card_mib": (mem1["by_pid"].get(pid, "not listed")
                             if cuda else "not measured"),
                "jax_libraries": jax_libraries(pid)}
                for pid, s, c in zip(pids, start_s, children)]
            legs["card_memory"] = (
                {"used_before_mib": mem0["used_mib"],
                 "used_after_mib": mem1["used_mib"],
                 "per_child_mib": (mem1["used_mib"] - mem0["used_mib"]) / C,
                 "pids_listed": sum(p in mem1["by_pid"] for p in pids)}
                if cuda else "not measured")
            require(all(len(c.ports) == per for c in children),
                    f"every child launched {per} nodes")
            require(not any(ch["jax_libraries"] for ch in legs["children"]),
                    "no child mapped a JAX library: "
                    f"{[ch['jax_libraries'] for ch in legs['children']]}")

            # ---- 2. traffic: puts round-robin, gets through the next ----
            rng = np.random.default_rng(args.seed + 20)
            raw = rng.integers(0, 256, size=(n_keys, 20), dtype=np.uint8)
            keys = [raw[i].tobytes() for i in range(n_keys)]
            require(len(set(keys)) == n_keys, "distinct keys")
            want = [b"cluster value %d" % i for i in range(n_keys)]

            def puts(ci):
                return [children[ci].put(keys[i], want[i])
                        for i in range(ci, n_keys, C)]
            t0 = time.perf_counter()
            stored = sum(sum(r) for r in each(puts, range(C)))
            put_s = time.perf_counter() - t0
            got = [None] * n_keys

            def gets(ci):
                for i in range(ci, n_keys, C):
                    got[i] = children[(ci + 1) % C].get(keys[i])
            t0 = time.perf_counter()
            each(gets, range(C))
            get_s = time.perf_counter() - t0
            equal = sum(got[i] == [want[i]] for i in range(n_keys))
            legs["traffic"] = {
                "puts": n_keys, "stored": stored, "equal_gets": equal,
                "put_s": put_s, "get_s": get_s,
                "puts_per_s": n_keys / put_s, "gets_per_s": n_keys / get_s,
                "threads": C}
            require(stored == n_keys, f"{n_keys - stored} puts not stored")
            require(equal == n_keys, f"{n_keys - equal} of {n_keys} gets "
                    "differ from their put")

            # ---- 3. the crawl from the parent runner --------------------
            # it must find every child's node, and nothing outside the
            # cluster but the parent itself
            t0 = time.perf_counter()
            ids = {i for c in children for i in c.node_ids()}
            me = bytes(runner.get_node_id())
            sc = Scanner(runner)
            sc.scan(timeout=60.0)
            found = {bytes(e.get_id()) for e in sc.all_nodes}
            summary = sc.summary()
            legs["crawl"] = {
                "probes": sc.probes, "found": len(found), "ids": len(ids),
                "found_self": me in found, "missing": len(ids - found),
                "extra": len(found - ids - {me}), "geo": summary["geo"],
                "s": time.perf_counter() - t0}
            require(len(ids) == C * per, "the children's ids are distinct")
            require(ids <= found <= ids | {me},
                    f"the crawl equals the children's ids: {legs['crawl']}")

            # ---- 4. the census: closest 8 of every key, one device call -
            t_census = time.perf_counter()
            census_ids = sorted(ids | {me})
            now = time.monotonic()
            table = hm.census_table([(InfoHash(i), None) for i in census_ids],
                                    now, device=device)
            hkeys = [InfoHash(k) for k in keys]
            lookups.take()
            window_select.launches = 0
            t0 = time.perf_counter()
            closest = hm.closest_ids(table, hkeys, k=8, now=now,
                                     device=device)
            sync()
            host_ms = (time.perf_counter() - t0) * 1e3
            launched = window_select.launches
            routes = lookups.take()
            require([lk["q"] for lk in routes if lk["route"] == "snapshot"]
                    == [n_keys], f"the census took the snapshot: {routes}")
            if cuda:
                require(launched >= 1, "the census launched window_select")
            census_np = np.frombuffer(b"".join(census_ids),
                                      np.uint8).reshape(-1, 20)
            exact = sum([bytes(h) for h in closest[q]]
                        == [census_ids[j] for j in
                            closest_np(census_np, keys[q], 8)]
                        for q in range(n_keys))
            with profile(activities=acts) as prof:
                hm.closest_ids(table, hkeys, k=8, now=now, device=device)
                sync()
            lookups.take()
            launched = window_select.launches
            legs["census"] = {
                "ids": len(census_ids), "keys": n_keys, "k": 8,
                "closest8_equal_numpy": exact, "route": routes[0]["route"],
                "stream_ms": routes[0]["stream_ms"],
                "window_select_launches": launched, "host_ms": host_ms,
                "device": device_totals(prof, cuda),
                "s": time.perf_counter() - t_census}
            require(exact == n_keys, f"{n_keys - exact} closest-8 lists "
                    "differ from the numpy scan")

            # ---- 5. kill child 0: its keys from the survivors -----------
            t0 = time.perf_counter()
            children[0].kill()
            victims = list(range(0, n_keys, C))
            back = {}

            def survivors_get(si):
                for i in victims[si::C - 1]:
                    back[i] = children[1 + si].get(keys[i])
            each(survivors_get, range(C - 1))
            kept = sum(back[i] == [want[i]] for i in victims)
            legs["kill"] = {"killed_pid": pids[0],
                            "rc": children[0].proc.returncode,
                            "keys": len(victims), "got_back": kept,
                            "s": time.perf_counter() - t0}
            require(kept == len(victims), f"{len(victims) - kept} of the "
                    "killed child's keys were not got back")

            # ---- 6. network_monitor over the survivors -------------------
            t0 = time.perf_counter()
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                mon_rc = network_monitor.main(
                    ["-b", "127.0.0.1:%d" % children[1].ports[0],
                     "-n", str(CLUSTER_MONITOR_KEYS), "--rounds",
                     str(CLUSTER_MONITOR_ROUNDS), "-p", "0", "-t", "30"]
                    + ([] if cuda else ["--cpu"]))
            rounds = [re.search(r"in ([0-9.]+) \| round-trip p50=([0-9.]+)s"
                                r" p95=([0-9.]+)s", l)
                      for l in out.getvalue().splitlines()]
            rounds = [tuple(map(float, m.groups())) for m in rounds if m]
            legs["monitor"] = {
                "rc": mon_rc, "keys": CLUSTER_MONITOR_KEYS,
                "rounds": [{"s": r[0], "p50_s": r[1], "p95_s": r[2]}
                           for r in rounds],
                "s": time.perf_counter() - t0}
            require(mon_rc == 0 and len(rounds) == CLUSTER_MONITOR_ROUNDS,
                    f"the monitor's rounds: {out.getvalue()[-400:]}")

            # ---- 7. the HTTP front over the parent runner ----------------
            t0 = time.perf_counter()
            http = DhtHttpServer(runner, http_port=0)
            base = "http://127.0.0.1:%d/cluster-http-key" % http.port
            body = urllib.parse.urlencode({"data": "over http",
                                           "id": "77"}).encode()
            with urllib.request.urlopen(base, data=body, timeout=60) as r:
                posted = json.loads(r.read())
            with urllib.request.urlopen(base, timeout=60) as r:
                read = json.loads(r.read())
            legs["http"] = {"post": posted, "get": read,
                            "equal": read == {"4d": {"base64":
                                                     "b3ZlciBodHRw"}},
                            "s": time.perf_counter() - t0}
            require(posted == {"success": True} and legs["http"]["equal"],
                    f"the HTTP round trip: {posted} {read}")

            # ---- 8. two clusters in network namespaces, where possible ---
            legs["netns"] = "unavailable"
            if netns_net.netns_available():
                t0 = time.perf_counter()
                seed_node = DhtRunner()
                seed_node.run(0, device=device)
                net = netns_net.NetnsClusterNet(device=device)
                try:
                    a = net.add_cluster(4, timeout=CLUSTER_RPC_S)
                    b = net.add_cluster(4, timeout=CLUSTER_RPC_S)
                    port = seed_node.get_bound_port()
                    a.bootstrap(net.gateway_addr(0), port)
                    b.bootstrap(net.gateway_addr(1), port)
                    nkey = bytes(InfoHash.get("cluster-netns-%d" % args.seed))
                    ok = a.put(nkey, b"across namespaces")
                    vals = b.get(nkey)
                finally:
                    net.close()
                    seed_node.join()
                legs["netns"] = {"namespaces": 2, "nodes_each": 4,
                                 "stored": ok,
                                 "equal": vals == [b"across namespaces"],
                                 "s": time.perf_counter() - t0}
                require(ok and legs["netns"]["equal"],
                        f"the netns put / get: {ok} {vals}")

            # ---- 9. shut down ---------------------------------------------
            t0 = time.perf_counter()
            legs["msgs"] = each(lambda c: c.stats()["msgs"], children[1:])
            each(lambda c: c.quit(), children[1:])
            graceful = sum(c.proc.returncode == 0 for c in children[1:])
            legs["shutdown"] = {"graceful": graceful, "killed": 1,
                                "s": time.perf_counter() - t0}
    finally:
        t0 = time.perf_counter()
        pool.shutdown(wait=True)
        for c in children:
            if c.proc.poll() is None:
                c.kill()
        if http is not None:
            http.stop()
        if runner is not None:
            runner.join()
        legs["teardown_s"] = time.perf_counter() - t0
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith(("dht", "proxy"))]
    exited = [c.proc.returncode for c in children]
    emit({"phase": "cluster", **card, "children_n": C,
          "nodes_per_child": per, "nodes": C * per, "keys": n_keys, **legs,
          "children_exited": exited, "error_records": len(records.errors),
          "delay_drops": len(records.delay_drops), "live_threads": alive,
          "phase_s": time.perf_counter() - t_phase})
    require(not records.errors, "no ERROR record from the port's loggers: "
            + "; ".join(records.errors[:3]))
    require(None not in exited, "every child exited")
    require(not alive, f"every runner and HTTP thread joined: {alive}")
    return launched


# The smokes phase's smokes (opendht_tpu_torch/testing/<name>.py), the
# longest first (their times on the card, PERF.md §5), so that the last
# to start are short.
SMOKES = ("peer_smoke", "listener_smoke", "keyspace_smoke", "cache_smoke",
          "waterfall_smoke", "reshard_smoke", "pipeline_util_smoke",
          "history_smoke", "health_smoke", "pipeline_smoke", "ingest_smoke",
          "ledger_smoke", "chaos_smoke")
# Smoke children at once (PERF.md §4).
SMOKES_PARALLEL = 6
# Smokes that run torch.profiler themselves (the cost ledger profiles
# each spec's calls), which a second session around them would stop.
SMOKES_SELF_PROFILED = ("ledger_smoke",)
# A smoke child's limit.
SMOKE_CHILD_S = 240.0


def smoke_child(name: str, cuda: bool) -> int:
    """The smokes phase's profiled child: the smoke ``name``'s main() on
    the card (or with --cpu) under torch.profiler's CUDA activity, the
    port's log records watched.  Prints the smoke's own output, then its
    record as the last line."""
    import importlib
    import traceback
    import torch
    from torch.profiler import ProfilerActivity, profile
    from opendht_tpu_torch.ops.lex_select import lex_topk_select
    from opendht_tpu_torch.ops.window_select import window_select
    if not cuda:
        torch.set_num_threads(2)      # tiny shapes
    smoke = importlib.import_module("opendht_tpu_torch.testing." + name)
    prof = (profile(activities=[ProfilerActivity.CUDA])
            if cuda and name not in SMOKES_SELF_PROFILED else None)
    t0 = time.perf_counter()
    with PortRecords() as records:
        if prof is not None:
            prof.__enter__()
        try:
            rc = smoke.main([] if cuda else ["--cpu"])
        except BaseException:
            traceback.print_exc()
            rc = 1
        if prof is not None:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
    smoke_s = time.perf_counter() - t0
    if prof is not None or not cuda:
        dev = device_totals(prof, cuda)
        del dev["top"], dev["stages"]
    else:
        # the ledger's own profile: one call of each spec it computed
        from opendht_tpu_torch import profiling
        ent = [e for e in profiling.get_ledger().compute(
            smoke.SMOKE_KERNELS, device="cuda").values() if "error" not in e]
        dev = {"kernels": sum(e["device_kernels"] or 0 for e in ent),
               "copies": sum(e["device_copies"] or 0 for e in ent),
               "device_ms": sum(e["kernel_ms"] or 0.0 for e in ent),
               "source": "the ledger's profile, one call of each spec"}
    print(json.dumps({"smoke_child": {
        "rc": rc, "smoke_s": smoke_s, "device": dev,
        "launches": {"window_select": window_select.launches,
                     "lex_topk_select": lex_topk_select.launches},
        "peak_reserved_mib": (torch.cuda.max_memory_reserved() / 2**20
                              if cuda else "not measured"),
        "jax_libraries": jax_libraries(os.getpid()),
        "jax_modules": jax_modules(sys.modules),
        "error_records": records.errors[:3],
        "n_error_records": len(records.errors), "dark": records.dark[:3],
        "delay_drops": len(records.delay_drops)}}), flush=True)
    return 0


def run_smokes(cmds: dict, parallel: int, logs: Path, tag: str,
               env: dict) -> dict:
    """Run each command of ``cmds`` (smoke -> argv), a child process
    each, at most ``parallel`` at once in their order, each within
    SMOKE_CHILD_S, its output in ``logs``/<smoke>.<tag>.out and .err.
    Returns per smoke its exit code ("timeout" past the limit), seconds,
    output lines and the JAX libraries its maps showed while it ran."""
    here = Path(__file__).resolve().parent
    todo, live, done = list(cmds), {}, {}
    while todo or live:
        while todo and len(live) < parallel:
            name = todo.pop(0)
            out, err = (logs / f"{name}.{tag}{ext}" for ext in (".out",
                                                              ".err"))
            with open(out, "w") as o, open(err, "w") as e:
                proc = subprocess.Popen(cmds[name], stdout=o, stderr=e,
                                        cwd=here, env=env)
            live[name] = (proc, time.perf_counter(), set(), out, err)
        time.sleep(0.5)
        for name, (proc, t0, jax, out, err) in list(live.items()):
            if proc.poll() is None:
                try:
                    jax.update(jax_libraries(proc.pid))
                except OSError:             # it has just exited
                    pass
                if time.perf_counter() - t0 < SMOKE_CHILD_S:
                    continue
                proc.kill()
            rc = proc.wait()
            del live[name]
            done[name] = {
                "exit": "timeout" if rc == -9 else rc,
                "wall_s": time.perf_counter() - t0,
                "stdout": out.read_text().splitlines(),
                "stderr": err.read_text().splitlines(),
                "jax_libraries": sorted(jax)}
    return done


def smokes_phase(args, dev, card, sync) -> dict:
    """The smokes (see the module docstring, phase 21).  Returns both
    select kernels' launches in the profiled pass's children."""
    import torch
    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    names = args.smokes.split(",")
    require(set(names) <= set(SMOKES) and names,
            f"--smokes names smokes of {SMOKES}: {names}")
    names = [n for n in SMOKES if n in names]
    logs = Path(os.environ["OPENDHT_TPU_SMOKE_RECORD_DIR"]) / "smokes"
    logs.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ)
    context_mib = used0 = "not measured"
    if cuda:
        # the native engine, built before any child starts
        from opendht_tpu_torch.native import available
        available()
        used0 = card_used_mib()
        torch.zeros(1, device=dev)
        sync()
        context_mib = card_used_mib() - used0
    else:
        env["OMP_NUM_THREADS"] = "2"              # tiny shapes
    here = str(Path(__file__).resolve().parent)
    passes = {
        "plain": {n: [sys.executable, "-m", "opendht_tpu_torch.testing."
                      + n] + ([] if cuda else ["--cpu"]) for n in names},
        "profiled": {n: [sys.executable, "-c",
                         "import sys; sys.path.insert(0, %r); import "
                         "chip_smoke; sys.exit(chip_smoke.smoke_child(%r, "
                         "%r))" % (here, n, cuda)] for n in names}}
    got, pass_s = {}, {}
    for tag, cmds in passes.items():
        t0 = time.perf_counter()
        got[tag] = run_smokes(cmds, SMOKES_PARALLEL, logs, tag, env)
        pass_s[tag] = time.perf_counter() - t0

    def dark(run):
        return [ln for ln in run["stdout"] + run["stderr"]
                if any(m in ln for m in DARK_MARKS)][:3]

    done = []
    for n in names:
        plain, prof = got["plain"][n], got["profiled"][n]
        rec = (json.loads(prof["stdout"].pop())["smoke_child"]
               if prof["stdout"] and prof["stdout"][-1].startswith(
                   '{"smoke_child"') else {})
        d = {"smoke": n,
             "exit": plain["exit"], "wall_s": plain["wall_s"],
             "last_line": plain["stdout"][-1] if plain["stdout"] else None,
             "tracebacks": sum("Traceback" in ln for ln in plain["stderr"]),
             "delay_drops": sum("dropping packet with high delay" in ln
                                for ln in plain["stderr"]),
             "profiled": {"exit": prof["exit"], "wall_s": prof["wall_s"],
                          "last_line": (prof["stdout"][-1]
                                        if prof["stdout"] else None),
                          **rec},
             "card_mib": (context_mib + rec["peak_reserved_mib"]
                          if cuda and rec else "not measured"),
             "jax_libraries": sorted(set(plain["jax_libraries"])
                                     | set(prof["jax_libraries"])),
             "dark_lines": dark(plain) + dark(prof)}
        d["ok"] = all(r["exit"] == 0 and r["last_line"] is not None
                      and r["last_line"].startswith(n)
                      for r in (d, d["profiled"])) and rec.get("rc") == 0
        if not d["ok"]:
            d["stderr_tail"] = {"plain": plain["stderr"][-12:],
                                "profiled": prof["stderr"][-12:]}
        done.append(d)
    failed = [d["smoke"] for d in done if not d["ok"]]
    erring = [d["smoke"] for d in done if d["tracebacks"]
              or d["profiled"].get("n_error_records")]
    darkened = [d["smoke"] for d in done
                if d["dark_lines"] or d["profiled"].get("dark")]
    jaxed = [d["smoke"] for d in done if d["jax_libraries"]
             or d["profiled"].get("jax_modules")]
    quiet = [d["smoke"] for d in done if cuda and "device" in d["profiled"]
             and not d["profiled"]["device"]["kernels"]]
    launches = {k: sum(d["profiled"].get("launches", {}).get(k, 0)
                       for d in done)
                for k in ("window_select", "lex_topk_select")}
    emit({"phase": "smokes", **card, "smokes_n": len(done),
          "parallel": SMOKES_PARALLEL, "pass_s": pass_s, "context_mib": context_mib,
          "card_used_mib": ({"before": used0, "after": card_used_mib()}
                            if cuda else "not measured"),
          "smokes": done, "failed": failed, "with_error_records": erring,
          "dark": darkened, "jax_loaded": jaxed,
          "no_device_kernels": quiet, "launches": launches,
          "logs": str(logs), "phase_s": time.perf_counter() - t_phase})
    require(not failed, f"every smoke passed both passes: {failed} did not")
    require(not erring, f"no traceback or ERROR record: {erring}")
    require(not darkened, f"no plane went dark: {darkened}")
    require(not jaxed, f"no smoke loaded JAX: {jaxed}")
    return launches


# ---- the hop phases (phases 22-23) and the soak (phase 24) --------------
# cold-start gets of the hops phase and of each hops_ladder point (the
# JAX acceptance test's at-scale count, tests/test_hop_parity.py)
HOPS_LOOKUPS = 6
# lookups of the batched simulator beside them (the test's sim_hops)
HOPS_SIM_TARGETS = 512
# the seed of the patched os.urandom stream and of random, each net
HOPS_STREAM_SEED = 11
# the soak's stable runners (tests/test_soak.py N_STABLE), and how far
# the card's allocated bytes in the soak's last third may pass its first
SOAK_STABLE = 4
SOAK_CUDA_SLACK = 16 * 2**20


class SeededStreams:
    """While open: ``random`` seeded, and ``os.urandom`` and
    ``random._urandom`` (which ``secrets``, and so a node's random id,
    draws through) one seeded stream, so nets built in turn get the same
    node ids and write tokens."""

    def __enter__(self):
        self._saved = (os.urandom, random._urandom)
        random.seed(HOPS_STREAM_SEED)
        rng = random.Random(HOPS_STREAM_SEED ^ 0x5EED)

        def urandom(n):
            return bytes(rng.getrandbits(8) for _ in range(n))
        os.urandom = random._urandom = urandom
        return self

    def __exit__(self, *exc):
        os.urandom, random._urandom = self._saved


def live_cold_start(n_nodes: int, n_lookups: int, device,
                    seed: int = 7) -> dict:
    """tests/test_hop_parity.py's cold start on the port, seeded
    convergence: ``n_nodes`` nodes of a ``VirtualNet(device=)`` get their
    converged tables from ``seed_converged``, then ``n_lookups`` fresh
    observers, each bootstrapped from the first node only, get a target
    of ``random.Random(seed)`` at once.  Per get: its discovery depth
    (``current_hops``), its recall of the true closest 8 and the first 8
    ids it found.  Under :class:`SeededStreams` (the port's modules are
    imported first: a first import draws from the streams), so two runs
    on two devices build the same nodes.  The collector is off
    meanwhile: its full passes over the growing net took ~27 % of a
    2,048-node run on the host, and the caller collects once the net is
    dropped."""
    from opendht_tpu_torch.infohash import InfoHash
    from opendht_tpu_torch.testing import VirtualNet
    rng = random.Random(seed)
    t0 = time.perf_counter()
    gc.disable()
    try:
        with SeededStreams():
            net = VirtualNet(device=device)
            seed_node = net.add_node()
            for _ in range(n_nodes - 1):
                net.add_node()
            net.seed_converged()
            build_s = time.perf_counter() - t0
            ids = np.stack([np.frombuffer(bytes(d.get_node_id()),
                                          np.uint8)
                            for d in net.nodes.values()])
            lookups = []
            for _ in range(n_lookups):
                obs = net.add_node()
                net.bootstrap_node(obs, seed_node)
                target = InfoHash(bytes(rng.getrandbits(8)
                                        for _ in range(20)))
                done, t_get = {}, net.clock
                obs.get(target, lambda vals: True,
                        lambda ok, ns: done.update(ok=ok, t=net.clock))
                require(net.run(60, lambda: "ok" in done),
                        f"a cold-start get over {n_nodes} nodes completed")
                sr = obs._searches_of(socket.AF_INET).get(target)
                hops = sr.current_hops()
                require(hops is not None, "a candidate of the get replied")
                x = (ids ^ np.frombuffer(bytes(target), np.uint8)) \
                    .view(">u4").reshape(-1, 5)
                true8 = {ids[i].tobytes()
                         for i in np.lexsort(x.T[::-1])[:8]}
                found = [bytes(sn.node.id) for sn in sr.nodes[:8]]
                lookups.append({"hops": hops, "ok": done["ok"],
                                "recall": len(set(found) & true8),
                                "found": [f.hex() for f in found],
                                "virtual_s": round(done["t"] - t_get, 9)})
                net.remove_node(obs)
    finally:
        gc.enable()
    return {"lookups": lookups, "net": net, "build_s": build_s,
            "s": time.perf_counter() - t0}


def sim_hops(n_nodes: int, n_lookups: int, dev, sync, seed: int = 3) -> dict:
    """The batched engine (α = 4, k = 8) on ``dev`` over a table and
    targets of ``np.random.default_rng(seed)``: the hop counts."""
    from opendht_tpu_torch.core.search import simulate_lookups
    from opendht_tpu_torch.ops import ids as IK
    from opendht_tpu_torch.ops.sorted_table import sort_table
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 2**32, size=(n_nodes, 5), dtype=np.uint32)
    targets = rng.integers(0, 2**32, size=(n_lookups, 5), dtype=np.uint32)
    t0 = time.perf_counter()
    sorted_ids, _perm, n_valid = sort_table(IK.to_keys(table, dev))
    out = simulate_lookups(sorted_ids, n_valid, IK.to_keys(targets, dev),
                           device=dev)
    hops = out["hops"].cpu().numpy()
    sync()
    require(bool(out["converged"].all()), "every simulated lookup converged")
    return {"n": n_nodes, "targets": n_lookups,
            "p50": float(np.median(hops)),
            "p95": float(np.percentile(hops, 95)), "max": int(hops.max()),
            "host_ms": (time.perf_counter() - t0) * 1e3}


def hops_point(n_nodes: int, dev, sync, cpu_twin: bool = True) -> dict:
    """One size of the hop checks: the cold start on ``dev``, the
    simulator beside it and, with ``cpu_twin``, the same gets on a CPU
    net (see the module docstring, phases 22-23)."""
    import torch
    cuda = dev.type == "cuda"
    if cuda:
        sync()
        torch.cuda.reset_peak_memory_stats()
        alloc0 = torch.cuda.memory_allocated()
    run = live_cold_start(n_nodes, HOPS_LOOKUPS, dev)
    mem = "not measured"
    if cuda:
        sync()
        mem = {"allocated_mib": (torch.cuda.memory_allocated() - alloc0)
               / 2**20,
               "peak_mib": (torch.cuda.max_memory_allocated() - alloc0)
               / 2**20,
               "card_used_mib": card_used_mib()}
    del run["net"]
    gc.collect()
    live = run.pop("lookups")
    hops, recall = [g["hops"] for g in live], [g["recall"] for g in live]
    sim = sim_hops(n_nodes, HOPS_SIM_TARGETS, dev, sync)
    rounds = float(np.median(hops)) + 1           # depth → query rounds
    rec = {"n": n_nodes, "lookups": len(live), "hops": hops,
           "recall": recall, "virtual_s": [g["virtual_s"] for g in live],
           "every_get_ok": all(g["ok"] for g in live),
           "live_rounds_p50": rounds, "sim": sim,
           "build_s": run["build_s"], "live_s": run["s"], "card_mib": mem,
           "cpu_twin": "in the hops_ladder call"}
    require(abs(sim["p50"] - rounds) <= 1.0,
            f"N={n_nodes}: sim p50 {sim['p50']} within 1 of live rounds "
            f"{rounds} ({hops})")
    require(sim["p50"] >= rounds - 0.5,
            f"N={n_nodes}: the simulator does not undercut live rounds")
    require(float(np.median(recall)) >= 7,
            f"N={n_nodes}: recall median >= 7 ({recall})")
    if cpu_twin:
        t0 = time.perf_counter()
        cpu = live_cold_start(n_nodes, HOPS_LOOKUPS, torch.device("cpu"))
        del cpu["net"]
        gc.collect()
        same = [(g["hops"], g["recall"], g["found"]) for g in live] == [
            (g["hops"], g["recall"], g["found"]) for g in cpu["lookups"]]
        rec["cpu_twin"] = {"equal": same, "s": time.perf_counter() - t0,
                           "hops": [g["hops"] for g in cpu["lookups"]]}
        require(same, f"N={n_nodes}: the gets on a CPU net gave the same "
                f"hops, recall and found ids: {rec['cpu_twin']['hops']} vs "
                f"{hops}")
    return rec


def _select_launches() -> dict:
    from opendht_tpu_torch.ops.lex_select import lex_topk_select
    from opendht_tpu_torch.ops.window_select import window_select
    return {"window_select": window_select.launches,
            "lex_topk_select": lex_topk_select.launches}


def _zero_select_launches() -> None:
    from opendht_tpu_torch.ops.lex_select import lex_topk_select
    from opendht_tpu_torch.ops.window_select import window_select
    window_select.launches = lex_topk_select.launches = 0


def hops_phase(args, dev, card, sync) -> dict:
    """Hop parity on the card (see the module docstring, phase 22).
    Returns the select kernels' launches."""
    t_phase = time.perf_counter()
    _zero_select_launches()
    # the CPU net's leg runs in the hops_ladder call: the full run with
    # it printed the ok line at 632 s on an H100 80GB HBM3 at 700 W,
    # past the 620 s it may take
    rec = hops_point(args.hops_n, dev, sync, cpu_twin=False)
    launches = _select_launches()
    emit({"phase": "hops", **card, **rec,
          "search_phase_hops": args.search_hops or "not run in this call",
          "launches": launches, "phase_s": time.perf_counter() - t_phase})
    return launches


def hops_ladder_phase(args, dev, card, sync) -> dict:
    """The hop checks with the CPU net's leg at the hops phase's size and
    at the JAX test's slow sizes (see the module docstring, phase 23),
    one line a size.  Returns the select kernels' launches."""
    _zero_select_launches()
    for n in [args.hops_n] + [int(s) for s in args.hops_ladder.split(",")]:
        t0 = time.perf_counter()
        rec = hops_point(n, dev, sync)
        emit({"phase": "hops_ladder", **card, **rec,
              "point_s": time.perf_counter() - t0})
    return _select_launches()


def _rss_mib() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return 0.0


def soak_phase(args, dev, card, sync) -> dict:
    """tests/test_soak.py's cluster soak on the card (see the module
    docstring, phase 24).  Returns the select kernels' launches."""
    import torch
    from opendht_tpu_torch.core.value import Value
    from opendht_tpu_torch.infohash import InfoHash
    from opendht_tpu_torch.runtime.config import NodeStatus
    from opendht_tpu_torch.runtime.runner import DhtRunner
    import concurrent.futures
    cuda = dev.type == "cuda"
    secs = args.soak_secs
    t_phase = time.perf_counter()
    _zero_select_launches()
    runners = []

    def spawn(bootstrap_port=None):
        r = DhtRunner()
        r.run(0, device=dev)
        if bootstrap_port:
            r.bootstrap("127.0.0.1", bootstrap_port)
        runners.append(r)
        return r

    def heap(r):
        return len(r._dht._dht.scheduler._heap)

    stats = {"puts": 0, "gets": 0, "listen_hits": 0, "churned": 0,
             "get_misses": 0, "op_timeouts": 0}
    alloc = []                           # (s since the soak began, bytes)
    stop = threading.Event()
    rss0, sched_max = None, 0
    with PortRecords() as records:
        try:
            hub = spawn()
            for _ in range(SOAK_STABLE - 1):
                spawn(hub.get_bound_port())
            require(_wait(lambda: all(r.get_status() is NodeStatus.CONNECTED
                                      for r in runners[1:]), 30),
                    "the soak cluster connected")
            listen_keys = [InfoHash.get(f"soak-listen-{i}") for i in range(3)]
            tokens = [runners[1].listen(key, lambda vals, exp: (
                stats.__setitem__("listen_hits",
                                  stats["listen_hits"] + len(vals)) or True))
                for key in listen_keys]
            churner = spawn(hub.get_bound_port())
            rng = np.random.default_rng(17)
            put_keys = []
            gc.collect()
            start = time.monotonic()
            warm_end = start + min(10.0, secs * 0.25)
            t_end = start + secs
            next_churn = start + max(8.0, secs / 6)

            def sample():
                # the card's allocated bytes once a second from warm-up on
                while not stop.wait(1.0):
                    if time.monotonic() >= warm_end:
                        alloc.append((time.monotonic() - start,
                                      torch.cuda.memory_allocated()))
            sampler = threading.Thread(target=sample, daemon=True)
            if cuda:
                sampler.start()
            i = 0
            while time.monotonic() < t_end:
                i += 1
                key = (listen_keys[i % 3] if i % 5 == 0
                       else InfoHash.get(f"soak-{i}"))
                src = runners[1 + (i % (len(runners) - 1))]
                try:
                    if src.put_sync(key, Value(b"soak-%d" % i), timeout=20.0):
                        stats["puts"] += 1
                        put_keys.append(key)
                except (TimeoutError, concurrent.futures.TimeoutError):
                    stats["op_timeouts"] += 1
                if put_keys and i % 3 == 0:
                    k = put_keys[int(rng.integers(0, len(put_keys)))]
                    try:
                        vals = hub.get_sync(k, timeout=20.0)
                        stats["gets"] += 1
                        stats["get_misses"] += not vals
                    except (TimeoutError, concurrent.futures.TimeoutError):
                        stats["op_timeouts"] += 1
                if time.monotonic() >= next_churn:
                    churner.join()
                    runners.remove(churner)
                    churner = spawn(hub.get_bound_port())
                    stats["churned"] += 1
                    next_churn = time.monotonic() + max(8.0, secs / 6)
                if time.monotonic() >= warm_end:
                    if rss0 is None:
                        gc.collect()
                        rss0 = _rss_mib()
                    sched_max = max(sched_max, *(heap(r) for r in runners))
            stop.set()
            if cuda:
                sampler.join()
            for key, tok in zip(listen_keys, tokens):
                runners[1].cancel_listen(key, tok)
            time.sleep(2.0)
            gc.collect()
            rss_end = _rss_mib()
            drained = [_wait(lambda d=r._dht._dht: len(d.engine._partials)
                             == 0, 15.0) for r in runners]
            listeners_left = len(runners[1]._listeners)
            heaps = [heap(r) for r in runners]
        finally:
            stop.set()
            for r in runners:
                try:
                    r.join()
                except Exception:
                    pass
    growth = rss_end - rss0 if rss0 else 0.0
    rss_limit = 120.0 + 0.25 * stats["puts"]
    sched_limit = 1500 + 20 * stats["puts"]
    third = len(alloc) // 3
    first = max((b for _, b in alloc[:third]), default=0)
    last = max((b for _, b in alloc[-third:]), default=0) if third else 0
    emit({"phase": "soak", **card, "secs": secs,
          "nodes": len(runners), **stats,
          "rss_mib": {"after_warmup": rss0, "end": rss_end,
                      "growth": growth, "limit": rss_limit},
          "sched_heap": {"max": sched_max, "limit": sched_limit,
                         "end": heaps},
          "partials_drained": all(drained), "listeners_left": listeners_left,
          "cuda_allocated": ({"samples": len(alloc),
                              "first_third_max": first,
                              "last_third_max": last,
                              "bound": first + SOAK_CUDA_SLACK,
                              "min": min(b for _, b in alloc),
                              "max": max(b for _, b in alloc),
                              # every fifth sample: (s, bytes)
                              "series": [(round(t, 1), b)
                                         for t, b in alloc[::5]]}
                             if cuda and alloc else "not measured"),
          "delay_drops": len(records.delay_drops),
          "error_records": len(records.errors), "dark": records.dark[:3],
          "launches": _select_launches(),
          "phase_s": time.perf_counter() - t_phase})
    require(stats["puts"] > 0 and stats["gets"] > 0,
            f"the soak did work: {stats}")
    require(stats["listen_hits"] > 0, "the standing listeners fired")
    require(all(drained), "every engine's reassembly buffer drained")
    require(listeners_left == 0, "no listener record left after cancel")
    require(sched_max < sched_limit,
            f"scheduler heaps bounded: max {sched_max} over "
            f"{stats['puts']} puts")
    require(growth < rss_limit, f"RSS grew {growth:.1f} MiB (limit "
            f"{rss_limit:.0f})")
    require(not records.errors and not records.dark,
            "no ERROR record and no plane gone dark")
    if cuda:
        require(third >= 3, f"{len(alloc)} allocation samples after warm-up")
        require(last <= first + SOAK_CUDA_SLACK,
                f"the card's allocated bytes did not climb: last third "
                f"max {last}, first third max {first}")
    return _select_launches()


# Requests the planes phase's put client keeps unanswered (the node
# answers one per server step; its retry timer is 1 s).
PLANES_WINDOW = 16
# The planes phase's keyspace hot rule: the share of the window's traffic
# a key needs to turn hot.  The JAX default is 0.125; the hottest key of
# a Zipf(0.99) stream over 10,000 keys draws 1 / H(10,000, 0.99) ~ 9.8 %
# of it, so at the default no key of YCSB workload C ever turns hot.
PLANES_HOT_SHARE = 0.02


class Counted:
    """While open: the calls of ``module.name`` (a plane's device
    program, as the plane module holds it), counted."""

    def __init__(self, module, name: str):
        self.module, self.name, self.calls = module, name, 0

    def __enter__(self):
        self._orig = orig = getattr(self.module, self.name)

        def counted(*a, **kw):
            self.calls += 1
            return orig(*a, **kw)
        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self._orig)


class SketchEvents:
    """While open: every update of the keyspace sketch (its ids, as
    uint32 numpy) and every decay (its factor), in order, from the
    module the observatory calls them through."""

    def __init__(self):
        self.events = []

    def __enter__(self):
        import torch
        from opendht_tpu_torch import keyspace
        from opendht_tpu_torch.ops import ids as IK
        sk = self.sk = keyspace.sk
        self._orig = (sk.sketch_update, sk.sketch_decay)
        upd, dec = self._orig

        def update(sketch, hist, ids):
            a = (IK.from_keys(ids) if isinstance(ids, torch.Tensor)
                 else np.asarray(ids, np.uint32))
            self.events.append(("update", a.reshape(-1, 5).copy()))
            return upd(sketch, hist, ids)

        def decay(sketch, hist, factor):
            self.events.append(("decay", factor))
            return dec(sketch, hist, factor)
        sk.sketch_update, sk.sketch_decay = update, decay
        return self

    def __exit__(self, *exc):
        self.sk.sketch_update, self.sk.sketch_decay = self._orig

    def count_min(self, depth: int, width: int):
        """The numpy count-min of the recorded events:
        ``hash_columns_host`` columns, top-byte bins, float32 decays."""
        from opendht_tpu_torch.ops.sketch import hash_columns_host
        sk = np.zeros((depth, width), np.int64)
        hist = np.zeros(256, np.int64)
        for kind, x in self.events:
            if kind == "update":
                cols = hash_columns_host(x, depth, width)
                for d in range(depth):
                    np.add.at(sk[d], cols[:, d], 1)
                np.add.at(hist, x[:, 0] >> 24, 1)
            else:
                f = np.float32(x)
                sk = np.floor(sk.astype(np.float32) * f).astype(np.int64)
                hist = np.floor(hist.astype(np.float32) * f).astype(np.int64)
        return sk, hist


def _near_keys(me: bytes, n: int, seed: int) -> list:
    """n distinct seeded keys sharing their first 48 bits with ``me``:
    the node is closer to each than any row of a random table, so it
    stores their announces (the announce's too-far check)."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, size=(n, 20), dtype=np.uint8)
    raw[:, :6] = np.frombuffer(me[:6], np.uint8)
    keys = sorted({r.tobytes() for r in raw})
    require(len(keys) == n, "distinct near keys")
    return [keys[i] for i in rng.permutation(n)]


def plane_op_timings(rng, dev, cuda, sync, l_max: int) -> dict:
    """The planes' device programs alone at their serving shapes: CUDA
    events (median of 7 after warm-up), launches and copies per call
    (torch.profiler over 10 calls), the bytes and operations bound, and
    each result held to its numpy mirror; listener_match's peak extra
    memory at L = 1,024, 100,000 and 1,000,000 rows (those up to
    ``l_max``, the live node's rows, and ``l_max`` itself).  Not TPU
    kernels: plain torch."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from opendht_tpu_torch.ops import ids as IK
    from opendht_tpu_torch.ops import sketch as SK
    from opendht_tpu_torch.ops.cache_probe import cache_probe, probe_host
    from opendht_tpu_torch.ops.listener_match import (listener_match,
                                                       match_host)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])

    def measure(fn, nbytes: int, ops: int) -> dict:
        out = {"ms": median_ms(fn, reps=7, inner=10, cuda=cuda)}
        with profile(activities=acts) as prof:
            for _ in range(10):
                fn()
            sync()
        tot = device_totals(prof, cuda, 10)
        out.update({"launches_per_call": tot["kernels"],
                    "copies_per_call": tot["copies"],
                    "device_ms_per_call": tot["device_ms"],
                    "bytes": nbytes, "ops": ops,
                    "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                                    ops / OPS_PER_S) * 1e3,
                    "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                                 >= ops / OPS_PER_S else "operations")})
        return out

    res = {}
    S = 64
    for L in sorted({min(L, l_max) for L in (1024, 100_000, 1_000_000)}):
        table = rng.integers(0, 2**32, size=(L, 5), dtype=np.uint32)
        valid = rng.random(L) < 0.9
        stored = rng.integers(0, 2**32, size=(S, 5), dtype=np.uint32)
        # half the wave on table rows, within the first 4,096 and past
        stored[:S // 2] = table[rng.integers(0, L, size=S // 2)]
        stored[0] = table[L - 1]
        tk, vk, sk = (IK.to_keys(table, dev), torch.from_numpy(valid).to(dev),
                      IK.to_keys(stored, dev))
        hit, slot = listener_match(tk, vk, sk)
        sync()
        # match_host over 4,096 rows at a time; the first chunk with a
        # hit holds the lowest matching row
        want_hit = np.zeros(S, bool)
        want_slot = np.full(S, -1, np.int32)
        for lo in range(0, L, 4096):
            h, s_ = match_host(table[lo:lo + 4096], valid[lo:lo + 4096],
                               stored)
            new = h & ~want_hit
            want_slot[new] = s_[new] + lo
            want_hit |= h
        require(np.array_equal(hit.cpu().numpy(), want_hit)
                and np.array_equal(slot.cpu().numpy(), want_slot),
                f"listener_match at L={L} == match_host over 4,096-row "
                "chunks")
        peak = "not measured"
        if cuda:
            sync()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            listener_match(tk, vk, sk)
            sync()
            peak = torch.cuda.max_memory_allocated() - base
        res[f"listener_match_S64_L{L}"] = {
            **measure(lambda: listener_match(tk, vk, sk),
                      L * 21 + S * 20 + S * 5, 11 * S * L),
            "hits": int(want_hit.sum()), "peak_extra_bytes": peak}
        del tk, vk, sk
    Q = C = 64
    cid = rng.integers(0, 2**32, size=(C, 5), dtype=np.uint32)
    cval = rng.random(C) < 0.8
    tg = rng.integers(0, 2**32, size=(Q, 5), dtype=np.uint32)
    tg[:16] = cid[:16]
    ck, cv, tk = (IK.to_keys(cid, dev), torch.from_numpy(cval).to(dev),
                  IK.to_keys(tg, dev))
    got = cache_probe(ck, cv, tk)
    want = probe_host(cid, cval, tg)
    require(all(np.array_equal(g.cpu().numpy(), w)
                for g, w in zip(got, want)),
            "cache_probe at Q=64, C=64 == probe_host")
    res["cache_probe_Q64_C64"] = measure(lambda: cache_probe(ck, cv, tk),
                                         C * 21 + Q * 20 + Q * 5,
                                         11 * Q * C)
    ids = rng.integers(0, 2**32, size=(Q, 5), dtype=np.uint32)
    ik = IK.to_keys(ids, dev)
    s0, h0 = SK.sketch_init(device=dev)
    SK.sketch_update(s0, h0, ik)
    cols = SK.hash_columns_host(ids)
    want_s = np.zeros((4, 2048), np.int64)
    for d in range(4):
        np.add.at(want_s[d], cols[:, d], 1)
    require(np.array_equal(s0.cpu().numpy(), want_s)
            and np.array_equal(h0.cpu().numpy(),
                               np.bincount(ids[:, 0] >> 24, minlength=256)),
            "sketch_update at Q=64 == a numpy count-min")
    # the mix: ~60 int64 operations per (id, row) and the scatter
    res["sketch_update_Q64"] = measure(
        lambda: SK.sketch_update(s0, h0, ik),
        Q * 20 + 2 * (4 * 2048 + 256) * 4, Q * 4 * 60)
    res["sketch_query_Q64"] = measure(lambda: SK.sketch_query(s0, ik),
                                      Q * 20 + 4 * 2048 * 4 + Q * 4,
                                      Q * 4 * 60)
    res["sketch_decay"] = measure(lambda: SK.sketch_decay(s0, h0, 0.5),
                                  2 * 2 * (4 * 2048 + 256) * 4,
                                  3 * (4 * 2048 + 256))
    return res


def planes_phase(args, dev, card, sync) -> int:
    """The node's planes (see the module docstring, phase 14).  Returns
    the window_select launches of its counted runs."""
    import select
    import socket
    import torch
    from torch.profiler import ProfilerActivity, profile
    from opendht_tpu_torch import hotcache as HC
    from opendht_tpu_torch import listeners as LS
    from opendht_tpu_torch import telemetry
    from opendht_tpu_torch.core import table as CT
    from opendht_tpu_torch.core.value import Query, Value
    from opendht_tpu_torch.hotcache import HotCacheConfig, HotValueCache
    from opendht_tpu_torch.infohash import InfoHash
    from opendht_tpu_torch.keyspace import KeyspaceConfig, KeyspaceObservatory
    from opendht_tpu_torch.listeners import ListenerTable
    from opendht_tpu_torch.ops.window_select import window_select
    from opendht_tpu_torch.runtime import Config, Dht
    from opendht_tpu_torch.scheduler import Scheduler
    from opendht_tpu_torch.sockaddr import SockAddr

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    device = None if cuda else "cpu"
    AF = socket.AF_INET
    reg = telemetry.get_registry()
    failures0 = reg.counter("dht_ingest_wave_failures_total").value
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    out = {}
    with PortRecords() as records, LookupRoutes(cuda, sync) as lookups:
        # ---- the planes' device programs alone ------------------------
        t0 = time.perf_counter()
        out["ops"] = plane_op_timings(np.random.default_rng(args.seed + 7),
                                      dev, cuda, sync, args.serve_n)
        out["ops_s"] = time.perf_counter() - t0

        # ---- the node: the live node's 1M rows at the JAX defaults ----
        # every sketch update and decay from here on is recorded
        sketch_ev = SketchEvents().__enter__()
        _, ids, _ = live_node_data(args)
        clock = {"t": 0.0}
        ssock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        ssock.bind(("127.0.0.1", 0))
        ssock.setblocking(False)
        csock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        csock.bind(("127.0.0.1", 0))
        csock.setblocking(False)
        client = csock.getsockname()

        def server_send(data, dst):
            # the loaded peers exist only in the table: only the client
            # is answered
            if (str(dst.ip), dst.port) == client:
                ssock.sendto(data, client)
            return 0

        dht = Dht(server_send, Config(
            max_req_per_sec=1_000_000,
            keyspace=KeyspaceConfig(hot_share=PLANES_HOT_SHARE)),
            Scheduler(clock=lambda: clock["t"]), has_v6=False, device=device)
        table = dht.tables[AF]
        t0 = time.perf_counter()
        table.bulk_load(ids, 0.0, addrs=SockAddr("127.0.0.2", 4567))
        dht.warmup()
        sync()
        load_s = time.perf_counter() - t0
        require(len(table) > CT.HOST_SCAN_MAX_ROWS, "past the host scan")
        ceng, peer = client_engine(csock, "planes-client", dht.myid,
                                   ssock.getsockname()[1])

        def pump_node() -> int:
            """Every datagram queued at the node, one virtual ms each."""
            n = 0
            while True:
                try:
                    data, addr = ssock.recvfrom(64 * 1024)
                except BlockingIOError:
                    return n
                clock["t"] += 0.001
                dht.periodic(data, SockAddr(addr[0], addr[1]))
                n += 1

        def pump_client(wait: float) -> None:
            ceng.scheduler.run()
            r, _, _ = select.select([csock], [], [], wait)
            while r:
                data, addr = csock.recvfrom(64 * 1024)
                ceng.process_message(data, SockAddr(addr[0], addr[1]))
                r, _, _ = select.select([csock], [], [], 0)

        def advance(to: float, step: float = 0.01) -> None:
            while clock["t"] < to:
                clock["t"] = min(to, clock["t"] + step)
                dht.periodic(None, None)

        nk, ng = args.planes_keys, args.planes_gets
        keys = [InfoHash(k) for k in _near_keys(bytes(dht.myid), nk, 21)]
        try:
            # ---- a client puts one value on each key over loopback ---
            tok = {}
            ceng.send_get_values(peer, keys[0], Query(), want=1,
                                 on_done=lambda r, a: tok.setdefault(
                                     "t", a.ntoken))
            end = time.monotonic() + 10
            while "t" not in tok and time.monotonic() < end:
                pump_node()
                pump_client(0.005)
            require(tok.get("t"), "the node handed the client a write token")
            acked, expired = set(), []
            sent_at, lat = {}, []
            nxt = 0
            t0 = time.perf_counter()
            lookups.take()
            end = time.monotonic() + 1200
            while len(acked) < nk and not expired \
                    and time.monotonic() < end:
                while nxt < nk and nxt - len(acked) < PLANES_WINDOW:
                    i = nxt
                    nxt += 1
                    sent_at[i] = time.perf_counter()
                    ceng.send_announce_value(
                        peer, keys[i], Value(b"planes value %d" % i,
                                             value_id=i + 1), None, tok["t"],
                        on_done=lambda r, a, _i=i: (
                            acked.add(_i),
                            lat.append(time.perf_counter() - sent_at[_i])),
                        on_expired=lambda r, over, _i=i: over
                        and expired.append(_i))
                pump_client(0)
                if not pump_node():
                    pump_client(0.002)
            put_s = time.perf_counter() - t0
            require(len(acked) == nk and not expired,
                    f"{len(acked)}/{nk} puts acknowledged, {len(expired)} "
                    f"expired at the client, in {put_s:.1f} s")
            stored = sum(1 for k in keys if dht.get_local(k))
            require(stored == nk, f"{stored}/{nk} keys stored on the node")
            put_lookups = LookupRoutes.routes(lookups.take())
            lat.sort()
            out["puts"] = {"keys": nk, "window": PLANES_WINDOW,
                           "s": put_s, "puts_per_s": nk / put_s,
                           "latency_ms": latency_ms(lat),
                           "virtual_s": clock["t"],
                           "announce_lookups": put_lookups}
            # the stored keys' window decays before the gets
            advance(clock["t"] + 20.0, 0.05)

            # ---- a Zipf(0.99) get stream over the keys ---------------
            zr = np.random.default_rng(args.seed + 31)
            p = 1.0 / np.arange(1, nk + 1) ** 0.99
            ranks = zr.choice(nk, size=ng, p=p / p.sum())
            stream = [keys[r] for r in ranks]
            got_on = [[] for _ in range(ng)]
            done_on = [0] * ng
            c_probe = Counted(HC, "cache_probe")
            window_select.launches = 0
            lookups.take()
            t_get0 = clock["t"]
            # one get per virtual ms, a shorter stream spread over 4 s
            gap = max(0.001, 4.0 / ng)
            t0 = time.perf_counter()
            with c_probe:
                for i, k in enumerate(stream):
                    dht.get(k, lambda v, _i=i: got_on[_i].extend(v) or True,
                            lambda ok, ns, _i=i: done_on.__setitem__(
                                _i, done_on[_i] + 1))
                    clock["t"] += gap
                    dht.periodic(None, None)
                # through at least three observatory ticks past the gets
                advance(t_get0 + ng * gap + 4.5)
                sync()
            get_s = time.perf_counter() - t0
            get_launches = window_select.launches
            get_lks = lookups.take()
            cache_on = dht.hotcache.snapshot()
            ks_snap = dht.keyspace.snapshot()
            # the sketch and histogram against their numpy count-min
            want_s, want_h = sketch_ev.count_min(4, 2048)
            got_s = dht.keyspace._sketch.cpu().numpy()
            got_h = dht.keyspace._hist.cpu().numpy()
            sketch_equal = (np.array_equal(got_s, want_s)
                            and np.array_equal(got_h, want_h))
            n_updates = sum(1 for e in sketch_ev.events if e[0] == "update")
            n_observed = sum(len(e[1]) for e in sketch_ev.events
                             if e[0] == "update")
            n_decays = len(sketch_ev.events) - n_updates
        finally:
            sketch_ev.__exit__(None, None, None)
        require(sketch_equal, "the sketch and histogram == a numpy count-min "
                "of the same observed ids, cell for cell")
        require(cache_on["hits"] > 0, f"cache hits > 0 ({cache_on}; top "
                f"{ks_snap['top'][:3]}, observed {ks_snap['observed_total']}"
                f", waves {len(get_lks)}, keyspace on {dht.keyspace.enabled})")
        if cuda:
            require(get_launches >= 1, "window_select launched on the "
                    "get stream's misses")
        hot = ks_snap["hot_keys"]
        out["gets"] = {
            "gets": ng, "distinct_keys": int(len(set(ranks))),
            "s": get_s, "virtual_s": clock["t"] - t_get0,
            "waves": len(get_lks), "routes": LookupRoutes.routes(get_lks),
            "window_select_launches": get_launches,
            "cache_probe_calls": c_probe.calls,
            "cache": {k: cache_on[k] for k in (
                "occupancy", "hits", "misses", "admissions", "evictions",
                "invalidations", "hit_ratio")},
            "hot_keys": len(hot), "hot_share_rule": PLANES_HOT_SHARE,
            "top": [{k: t[k] for k in ("estimate", "share", "hot")}
                    for t in ks_snap["top"]],
            "replica_k_hottest": (dht._replica_k(InfoHash(bytes.fromhex(
                hot[0]))) if hot else None),
            "sketch": {"updates": n_updates, "ids_observed": n_observed,
                       "decays": n_decays, "equal_to_numpy": sketch_equal},
            "imbalance": ks_snap["shards"]["imbalance"]}

        # ---- the same stream, the same node state, cache off ---------
        cache = dht.hotcache
        dht.hotcache = HotValueCache(HotCacheConfig(enabled=False),
                                     clock=dht.scheduler.time)
        got_off = [[] for _ in range(ng)]
        t0 = time.perf_counter()
        for i, k in enumerate(stream):
            dht.get(k, lambda v, _i=i: got_off[_i].extend(v) or True)
            dht.periodic(None, None)
        advance(clock["t"] + 0.01, 0.001)
        sync()
        off_s = time.perf_counter() - t0
        dht.hotcache = cache

        def vals(g):
            return [(v.id, bytes(v.data)) for v in g]
        mismatch = [i for i in range(ng) if vals(got_on[i]) != vals(got_off[i])]
        require(not mismatch, f"gets {mismatch[:5]} gave other values with "
                "the cache off")
        require(all(len(g) == 1 for g in got_on), "every get found its value")
        out["gets"]["cache_off_replay"] = {"s": off_s, "equal": True}
        lookups.take()

        # ---- per-wave cost, planes on against off -------------------
        # the same node with its planes, then with disabled ones in
        # their place, in turns; waves of 64 gets on keys nobody stored
        # (cache misses: the lookup runs in both)
        on_planes = (dht.keyspace, cache, dht.listener_table)
        off_planes = (KeyspaceObservatory(KeyspaceConfig(enabled=False)),
                      HotValueCache(HotCacheConfig(enabled=False)),
                      ListenerTable(batching="off"))
        wr = np.random.default_rng(args.seed + 41)
        per_wave = {}
        for label in ("on", "off", "off_2", "on_2"):
            dht.keyspace, dht.hotcache, dht.listener_table = (
                on_planes if label.startswith("on") else off_planes)
            waves = [[InfoHash(r.tobytes()) for r in wr.integers(
                0, 256, size=(64, 20), dtype=np.uint8)] for _ in range(4)]
            sync()
            window_select.launches = 0
            t0 = time.perf_counter()
            with profile(activities=acts) as prof:
                for tg in waves:
                    for k in tg:
                        dht.get(k, lambda v: True)
                    clock["t"] += 0.003          # past the deadline
                    dht.periodic(None, None)
                for _ in range(2):               # drain the last wave
                    clock["t"] += 0.003
                    dht.periodic(None, None)
                sync()
            wall = time.perf_counter() - t0
            lks = lookups.take()
            per = device_totals(prof, cuda, len(waves))
            per_wave[label] = {"waves": len(waves), "lookups": len(lks),
                               "host_ms_per_wave": 1e3 * wall / len(waves),
                               "window_select_launches":
                                   window_select.launches,
                               **{k: per[k] for k in DEVICE_TOTALS},
                               "top": per["top"][:5]}
        dht.keyspace, dht.hotcache, dht.listener_table = on_planes
        out["per_wave"] = per_wave

        # ---- listeners: capacity + overflow, waves of stored puts ---
        lt_on = dht.listener_table
        cap = lt_on.cfg.capacity
        heard = {}
        tokens = {}

        def listener(i):
            return lambda v, exp: heard.setdefault(i, []).extend(
                (x.id, exp) for x in v) or True
        lsnap0 = None
        results = {}
        for run in ("on", "off"):
            if run == "off":
                dht.listener_table = ListenerTable(
                    batching="off", clock=dht.scheduler.time)
            heard.clear()
            # fresh keys per run (a listen registered on a key with
            # values is handed them at once)
            lkeys = [InfoHash(k) for k in _near_keys(
                bytes(dht.myid), cap + 64, 51 if run == "on" else 52)]
            for i, k in enumerate(lkeys):
                tokens[i] = dht.listen(k, listener(i))
            advance(clock["t"] + 0.05, 0.005)
            if run == "on":
                lsnap0 = dht.listener_table.snapshot()
            pr = np.random.default_rng(61)
            puts = []
            base = 10_000_000 if run == "on" else 20_000_000
            c_match = Counted(LS, "listener_match")
            t0 = time.perf_counter()
            with c_match:
                for wave in range(8):
                    for j in range(64):
                        # half on listened keys (overflow ones among
                        # them), half on keys nobody listens to
                        li = (int(pr.integers(0, len(lkeys)))
                              if j % 2 == 0 else -1)
                        k = lkeys[li] if li >= 0 else InfoHash(
                            pr.integers(0, 256, 20, dtype=np.uint8)
                            .tobytes())
                        vid = base + len(puts)
                        puts.append(li)
                        dht.storage_store(k, Value(b"l%d" % vid,
                                                   value_id=vid),
                                          clock["t"])
                    advance(clock["t"] + 0.02, 0.002)
                sync()
            ls_s = time.perf_counter() - t0
            want = {}
            for n, li in enumerate(puts):
                if li >= 0:
                    want.setdefault(li, []).append(n)
            got = {i: [vid - base for vid, exp in v if not exp]
                   for i, v in heard.items()}
            results[run] = {"got": got, "want": want, "s": ls_s,
                            "matches": c_match.calls,
                            "snap": dht.listener_table.snapshot()}
            for i, k in enumerate(lkeys):
                dht.cancel_listen(k, tokens[i])
            advance(clock["t"] + 0.05, 0.005)
        dht.listener_table = lt_on
        on_r, off_r = results["on"], results["off"]
        require(on_r["got"] == on_r["want"],
                "every notification delivered once, batching on")
        require(off_r["got"] == off_r["want"],
                "every notification delivered once, batching off")
        require(on_r["got"] == off_r["got"], "per listener, batching on "
                "delivers in the off path's order")
        require(lsnap0["occupancy"] == cap and lsnap0["overflow"] == 64,
                f"{cap} listened keys on the table, 64 overflowing "
                f"({lsnap0})")
        require(on_r["matches"] >= 1, "listener_match launched")
        out["listeners"] = {
            "listened_keys": cap + 64, "capacity": cap,
            "overflow": lsnap0["overflow"], "stored_puts": 8 * 64,
            "notifications": sum(len(v) for v in on_r["want"].values()),
            "listener_match_calls": on_r["matches"],
            "on_s": on_r["s"], "off_s": off_r["s"],
            "table_after": {k: on_r["snap"][k] for k in (
                "matches", "misses", "flushes", "deliveries",
                "values_delivered", "lag_p95_s")}}
        out["planes_enabled"] = {"keyspace": dht.keyspace.enabled,
                                 "cache": dht.hotcache.enabled,
                                 "listeners": dht.listener_table.enabled}
        require(all(out["planes_enabled"].values()), "no plane went dark "
                f"({out['planes_enabled']})")
        ssock.close()
        csock.close()

    failures = reg.counter("dht_ingest_wave_failures_total").value - failures0
    emit({"phase": "planes", **card, "n": len(table), "load_s": load_s,
          **out, "ingest_wave_failures": failures,
          "error_records": len(records.errors),
          "planes_dark_records": len(records.dark),
          "phase_s": time.perf_counter() - t_phase})
    require(failures == 0, "no ingest wave failed")
    require(not records.errors, "no ERROR record from the port's loggers: "
            + "; ".join(records.errors[:3]))
    require(not records.dark, "no plane went dark: "
            + "; ".join(records.dark[:3]))
    return get_launches + sum(v["window_select_launches"]
                              for v in per_wave.values())


# ---------------------------------------------------------------------------
# 14. scale
# ---------------------------------------------------------------------------

def slope_ms(fn, *, r1: int = 4, r2: int = 32, cuda: bool = True) -> float:
    """Per-call time as the slope of back-to-back call chains: CUDA events
    around r1 and r2 calls, (t(r2) - t(r1)) / (r2 - r1), so constant
    costs cancel (bench.py's chain_slope method).  Host clock with a
    synchronize on the CPU rehearsal."""
    import torch
    fn()

    def chain(r):
        if not cuda:
            s = time.perf_counter()
            for _ in range(r):
                fn()
            return (time.perf_counter() - s) * 1e3
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(r):
            fn()
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1)
    return (chain(r2) - chain(r1)) / (r2 - r1)


def exact_topk_rows(sorted_ids, n: int, queries, k: int) -> np.ndarray:
    """Exact k XOR-closest sorted rows of each query, through ``xor_topk``
    over a superset of the answer: the rows whose top distance limb is at
    most the k-th smallest top limb (every row of the exact top-k is
    among them).  One query at a time, so a 64M-row table never meets a
    [Q, N] buffer."""
    import torch
    from opendht_tpu_torch.ops.ids import FLIP
    from opendht_tpu_torch.ops.xor_topk import xor_topk
    col0 = sorted_ids[:n, 0].contiguous()
    out = []
    for q in queries:
        d0 = col0 ^ (q[0] ^ FLIP)          # key of each row's top limb
        thr = torch.topk(d0, k, largest=False).values.max()
        cand = torch.nonzero(d0 <= thr).reshape(-1)
        _, i = xor_topk(q[None], sorted_ids[cand], k=k)
        out.append(cand[i[0].long()])
    return torch.stack(out).cpu().numpy()


def scale_phase(args, dev, card, sync) -> dict:
    """Scale-out on the card (see the module docstring, phase 15).
    Returns each kernel's launches in the phase's counted runs and its
    max_abs_err against its plain version on this path's inputs."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from opendht_tpu_torch import NodeTable, InfoHash
    from opendht_tpu_torch import parallel as PL
    from opendht_tpu_torch.core import search as SE
    from opendht_tpu_torch.ops import ids as IK
    from opendht_tpu_torch.ops import sorted_table as ST
    from opendht_tpu_torch.ops.lex_select import (lex_topk_select,
                                                   lex_topk_select_plain)
    from opendht_tpu_torch.ops.window_select import (window_select,
                                                      window_select_plain)
    from opendht_tpu_torch.ops.xor_topk import select_topk
    from opendht_tpu_torch.parallel.partition import solve_shard_edges
    from opendht_tpu_torch.reshard import ReshardConfig, ReshardLayout
    from opendht_tpu_torch.runtime import Config, Dht
    cuda = dev.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])

    def timed(fn, **kw):
        # the host rehearsal times each call once: its times are no
        # device metric, and the rehearsal must stay short
        return median_ms(fn, cuda=cuda, **(kw if cuda else
                                           {"reps": 1, "warmup": 0}))
    N, Q, K = args.scale_n, args.scale_q, 8
    launches = {"window_select": 0, "lex_topk_select": 0}
    rec = {"phase": "scale", **card, "n": N, "q": Q, "k": K}
    if cuda:
        sync()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()

    # (a) BASELINE config 5, one-chip form: 64M ids sorted, the 2-plane
    # expansion built in 8 chunks, the LUT, fast2 over 65,536 queries
    rng = np.random.default_rng(6)
    t0 = time.perf_counter()
    table = IK.to_keys(rng.integers(0, 2**32, size=(N, 5), dtype=np.uint32),
                       dev)
    qk = IK.to_keys(rng.integers(0, 2**32, size=(Q, 5), dtype=np.uint32),
                    dev)
    sync()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sorted_ids, perm, n_valid = ST.sort_table(table)
    n = int(n_valid)
    sync()
    sort_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    exp2 = ST.expand_table_chunked(sorted_ids, chunks=8, limbs=2)
    lut = ST.build_prefix_lut(sorted_ids, n, bits=ST.default_lut_bits(N))
    sync()
    expand_s = time.perf_counter() - t0

    def config5():
        return ST.expanded_topk(sorted_ids, exp2, n, qk, k=K, select="fast2",
                                lut=lut, lut_steps=0, planes=2)
    _, idx5, cert5 = config5()
    c5_ms = slope_ms(config5, cuda=cuda, **({} if cuda else
                                            {"r1": 1, "r2": 2}))
    peak5 = (torch.cuda.max_memory_allocated() - mem0) if cuda \
        else "not measured"
    sample = np.sort(rng.choice(Q, size=min(256, Q), replace=False))
    want = exact_topk_rows(sorted_ids, n, qk[torch.from_numpy(sample)
                                             .to(dev)], K)
    got = idx5[torch.from_numpy(sample).to(dev)].cpu().numpy()
    c_s = cert5[torch.from_numpy(sample).to(dev)].cpu().numpy()
    require(np.array_equal(got[c_s], want[c_s]),
            "config 5: every certified sampled row == the exact scan")
    rec["config5"] = {
        "ms": c5_ms, "lookups_per_s": Q / (c5_ms / 1e3),
        "certified_fraction": float(cert5.float().mean()),
        "sample_exact": int(c_s.sum()), "sample": int(len(sample)),
        "sample_uncertified_differing": int(
            (~(got == want).all(axis=1) & ~c_s).sum()),
        "peak_bytes": peak5,
        "ids_bytes": N * 20, "expansion_bytes": exp2.numel() * 4,
        "seconds": {"generate_and_upload": gen_s, "sort": sort_s,
                    "expand_and_lut": expand_s},
        # fast2 over a 2-plane row: the sort keys read per query
        "bytes": Q * (2 * ST._EROW * 4 + 5 * 4 + K * 4),
        "method": "slope of 4- and 32-call chains, CUDA events"}
    del exp2, lut, idx5, cert5

    # (b) the merge model: the [Q, n_t·k] re-sort of the per-shard winners
    merge = {}
    for n_t in (2, 4, 8):
        g = torch.Generator(device=dev).manual_seed(60 + n_t)
        cd = torch.randint(-2**31, 2**31 - 1, (Q, n_t * K, 5),
                           dtype=torch.int32, device=dev, generator=g)
        ci = torch.randint(0, N, (Q, n_t * K), dtype=torch.int32,
                           device=dev, generator=g)
        inv = torch.zeros_like(ci)
        merge[n_t] = {"ms": timed(lambda: select_topk(cd, ci, inv, K)),
                      "wire_bytes_per_query": n_t * K * 24}
        del cd, ci, inv
    rec["merge_model"] = merge

    # (c) the sharded resolve on a virtual mesh of t shards on this
    # device, both routes, each == the unsharded lookup_topk
    ref_d, ref_i, _ = ST.lookup_topk(sorted_ids, n, qk, k=K, window=128)
    ref_rows = torch.where(ref_i >= 0, perm[ref_i.clamp(min=0).long()], -1)
    unsharded_ms = timed(
        lambda: ST.lookup_topk(sorted_ids, n, qk, k=K, window=128), reps=5)
    del sorted_ids, perm
    mesh_rec = {}
    err = {"window_select": 0, "lex_topk_select": 0}
    for t in (2, 4, 8):
        mesh = PL.make_mesh(t, q=1, t=t, devices=dev)
        sync()
        t0 = time.perf_counter()
        ps, pp, pn = PL.sharded_sort_table(mesh, table)
        px, plut = PL.sharded_expand_table(
            mesh, ps, pn, bits=ST.default_lut_bits(N // t))
        sync()
        build_s = time.perf_counter() - t0
        routes = {}
        for route, kw, kern in (
                ("expanded", dict(expanded=px, lut=plut), window_select),
                ("window", dict(window=128), lex_topk_select)):
            def call(kw=kw):
                return PL.sharded_window_lookup(mesh, qk, ps, pp, pn, k=K,
                                                **kw)
            launch = PL.sharded_window_launch(mesh, qk, ps, pp, pn, k=K,
                                              **kw)
            unc = sum(int((~o[2]).sum()) for o in launch.outs[0])
            launch.finish()
            window_select.launches = 0
            lex_topk_select.launches = 0
            d, r = call()
            sync()
            per_call = kern.launches
            launches[kern.__name__] += per_call
            require(torch.equal(d, ref_d) and torch.equal(r, ref_rows),
                    f"t={t} {route}: sharded == unsharded lookup_topk")
            if cuda:
                require(per_call == t, f"t={t} {route}: one "
                        f"{kern.__name__} launch per shard ({per_call})")
            with profile(activities=acts) as prof:
                call()
                sync()
            routes[route] = {"ms": timed(call, reps=5),
                             "kernel_launches_per_call": per_call,
                             "uncertified_rows": unc,
                             **device_totals(prof, cuda)}
        mesh_rec[t] = {"build_s": build_s, **routes}
        if t == 8:
            # the kernels against their plain versions on shard 0's own
            # inputs at this path's shapes
            s0, x0 = ps.shard(0, 0), px.shard(0, 0)
            n0 = pn.shard(0, 0)[0]
            j, start = ST.expanded_window(s0, x0, n0, qk,
                                          lut=plut.shard(0, 0)[0])
            q8 = torch.nn.functional.pad(qk, (0, 3))
            bounds = torch.clamp(n0 - start, 0, 192)[:, None] \
                .expand(-1, 8).contiguous()
            got = window_select(x0, q8, bounds, k=K, row_index=j)
            sync()
            err["window_select"] = max_abs_err(got, window_select_plain(
                x0, q8, bounds, k=K, row_index=j))
            dist_w, inv_w, _, _ = ST.window_candidates(s0, n0, qk,
                                                       window=128)
            got = lex_topk_select(dist_w, inv_w, k=K)
            sync()
            err["lex_topk_select"] = max_abs_err(got, lex_topk_select_plain(
                dist_w, inv_w, k=K))
            del j, start, q8, bounds, dist_w, inv_w, got
        del ps, pp, pn, px, plut
    require(err["window_select"] == 0 and err["lex_topk_select"] == 0,
            "the kernels == their plain versions on a shard's inputs")
    rec["virtual_mesh"] = {**mesh_rec, "unsharded_window_ms": unsharded_ms,
                           "max_abs_err": err}
    del table, ref_d, ref_i, ref_rows

    # (d) the table-parallel engine at t=4 over config 3's table, one
    # wave, == simulate_lookups
    rng3 = np.random.default_rng(args.seed + 3)
    ids3 = IK.to_keys(rng3.integers(0, 2**32, size=(args.search_n, 5),
                                    dtype=np.uint32), dev)
    tgt3 = IK.to_keys(rng3.integers(0, 2**32, size=(args.search_q, 5),
                                    dtype=np.uint32), dev)
    s3, _p3, nv3 = ST.sort_table(ids3)
    del ids3, _p3
    n3 = int(nv3)
    lut3 = ST.build_prefix_lut(s3, n3, bits=ST.default_lut_bits(s3.shape[0]))
    mesh4 = PL.make_mesh(4, q=1, t=4, devices=dev)
    state = PL.shard_table_state(mesh4, s3, n3)

    def tp_wave():
        return PL.tp_simulate_lookups(mesh4, targets=tgt3, state=state,
                                      seed=args.seed, **CONFIG3)

    def single_wave():
        return SE.simulate_lookups(s3, n3, tgt3, device=dev, lut=lut3,
                                   seed=args.seed, **CONFIG3)
    require(same_outputs(outputs_np(tp_wave()), outputs_np(single_wave())),
            "tp_simulate_lookups (t=4) == simulate_lookups")
    rec["tp_engine"] = {
        "n": args.search_n, "q": args.search_q, "t": 4,
        "wave_ms": timed(tp_wave, reps=3, warmup=1),
        "unsharded_wave_ms": timed(single_wave, reps=3, warmup=1),
        "state_bytes_per_shard": state.table_bytes_per_shard()}
    del s3, lut3, state, tgt3

    # (e) the node's mesh/layout resolve on the live node's table, a
    # layout swap between launch and consume
    rng_l, ids_l, _ = live_node_data(args)
    nt = NodeTable(InfoHash(bytes(20)), device=dev)
    nt.bulk_load(ids_l, now=0.0)
    snap = nt.snapshot(0.0)
    # 1,024 targets: each shard rescans the ~3/4 of them outside its range
    tq = rng_l.integers(0, 2**32, size=(min(1024, Q), 5), dtype=np.uint32)
    want_rows, want_dist = nt.find_closest(tq, k=K, now=0.0)
    loads = np.zeros(256, np.int64)
    loads[:32] = 1000                     # traffic on the low 1/8 ring
    lay = ReshardLayout(gen=1, t=4,
                        edges=tuple(float(e) for e in solve_shard_edges(
                            loads, 4, load_weight=0.9)),
                        bin_loads=loads, load_weight=0.9)
    lex_topk_select.launches = 0
    pl_a = nt.find_closest_launch(tq, k=K, now=0.0, mesh=mesh4)
    placed_a = snap._tp_state[2]
    pl_b = nt.find_closest_launch(tq, k=K, now=0.0, mesh=mesh4, layout=lay)
    swapped = snap._tp_state[2] is not placed_a
    ra, rb = pl_a.consume(), pl_b.consume()
    sync()
    layout_launches = lex_topk_select.launches
    launches["lex_topk_select"] += layout_launches
    if cuda:
        require(layout_launches == 2 * 4, "one lex_topk_select launch per "
                f"shard of each wave ({layout_launches})")
    require(swapped, "the layout rebuilt the snapshot's shards")
    for name, (r, d) in (("in flight", ra), ("after swap", rb)):
        require(np.array_equal(r, want_rows) and np.array_equal(d, want_dist),
                f"layout resolve ({name}) == unsharded find_closest")
    bnd = snap.reshard_boundary_rows(lay, 4)
    unc = {}
    for name, layout in (("uniform", None), ("layout", lay)):
        placed, _ = snap._shard_state(mesh4, layout)
        probe = PL.sharded_window_launch(
            mesh4, IK.to_keys(tq, dev), placed["sorted_ids"],
            placed["perm"], placed["n_valid"], k=K)
        unc[name] = [int((~o[2]).sum()) for o in probe.outs[0]]
        probe.finish()
    rec["node_layout"] = {
        # rows each shard rescans exactly (a query outside a shard's
        # range fails that shard's window certificate)
        "uncertified_rows_per_shard": unc,
        "rows": len(ids_l), "q": len(tq),
        "boundary_rows": [int(b) for b in bnd],
        "uniform_rows": [-(-snap.n_valid * i // 4) for i in range(1, 4)],
        "lex_topk_select_launches": layout_launches,
        "ms": timed(lambda: nt.find_closest(tq, k=K, now=0.0, mesh=mesh4,
                                            layout=lay), reps=3, warmup=1),
        "unsharded_ms": timed(lambda: nt.find_closest(tq, k=K, now=0.0),
                              reps=3, warmup=1)}
    del nt, snap

    # a node asking for a 2-shard resolve: on one card it logs and
    # serves unsharded, as the JAX node does with too few devices
    class Warnings(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.msgs = []

        def emit(self, record):
            self.msgs.append(record.getMessage())
    wh = Warnings()
    logging.getLogger("opendht_tpu_torch").addHandler(wh)
    try:
        dkw = {} if cuda else {"device": "cpu"}
        d2 = Dht(lambda data, addr: 0, Config(resolve_mesh_t=2), **dkw)
        m2 = d2.resolve_mesh()
        cards = torch.cuda.device_count() if cuda else 0
        if cuda and cards < 2:
            require(m2 is None and any("serving the unsharded resolve path"
                                       in m for m in wh.msgs),
                    "resolve_mesh_t=2 on one card logs and serves "
                    "unsharded")
        ids_d = ids_l[:8192]
        from opendht_tpu_torch.sockaddr import SockAddr
        d2.tables[socket.AF_INET].bulk_load(
            ids_d, d2.scheduler.time(), addrs=SockAddr("127.0.0.2", 4567))
        tg = [InfoHash(b.tobytes()) for b in IK.ids_to_bytes(tq[:128])]
        res = d2.find_closest_nodes_batched(tg, socket.AF_INET, K)
        require(len(res) == len(tg) and all(len(x) == K for x in res),
                "the resolve_mesh_t=2 node answers")
        # the default node's resharder: a swap in virtual mode (no mesh)
        # launches nothing on the device
        dd = Dht(lambda data, addr: 0, Config(reshard=ReshardConfig(
            sustain=0.0, min_interval=0.0)), **dkw)
        dd.keyspace.imbalance = lambda: 3.0
        with profile(activities=acts) as prof:
            tick = dd.reshard.tick()
            sync()
        require(tick["action"] == "swap" and tick["mode"] == "virtual",
                "the default node's resharder swaps in virtual mode")
        tick_dev = device_totals(prof, cuda)
        if cuda:
            require(tick_dev["kernels"] == 0 and tick_dev["copies"] == 0,
                    "a virtual-mode resharder tick launches nothing")
    finally:
        logging.getLogger("opendht_tpu_torch").removeHandler(wh)
    rec["resolve_mesh_t2"] = {"mesh": None if m2 is None else m2.shape,
                              "cards": cards,
                              "shard_t": d2.last_resolve_shard_t,
                              "warnings": [m for m in wh.msgs
                                           if "resolve" in m]}
    rec["reshard_tick"] = {"result": {k: v for k, v in tick.items()
                                      if k != "imbalance_after"},
                           "device_kernels": tick_dev["kernels"],
                           "device_copies": tick_dev["copies"]}
    rec["launches"] = dict(launches)
    emit(rec)
    return launches, err


# ------------------------------------- cost ledger, swarm and bench twin
def op_launch_split(prof) -> dict:
    """Device kernels and copies of a profiled window split by the aten op
    that launched them (the profiler links each device event to its
    launching op), with the top ten by count and by device time.  Events
    launched outside any aten op (the hand kernels' ctypes launches)
    count as ``unattributed``."""
    from collections import Counter
    import torch
    count, dev_us = Counter(), Counter()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        ks = getattr(e, "kernels", None) or []
        if ks and not getattr(e, "is_user_annotation", False):
            count[e.name] += len(ks)
            dev_us[e.name] += sum(k.duration for k in ks)
    total = device_totals(prof, True)
    launched = total["kernels"] + total["copies"]
    return {"device_events": launched, "kernels": total["kernels"],
            "copies": total["copies"], "device_ms": total["device_ms"],
            "attributed": sum(count.values()),
            "unattributed": launched - sum(count.values()),
            "ops": len(count),
            "top_by_count": [[n, c, dev_us[n] / 1e3]
                             for n, c in count.most_common(10)],
            "top_by_device_ms": [[n, count[n], us / 1e3] for n, us in
                                 dev_us.most_common(10)]}


def ledger_phase(args, dev, card, sync) -> dict:
    """The kernel cost ledger on the card (module docstring, phase 16):
    every spec computed and measured, its CPU-deterministic fields held
    to the port's budgets, the gate run against this ledger, and the
    live node's Q=1 resolves split by op.  Returns the kernel launches
    the phase counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from opendht_tpu_torch import perf_gate, profiling
    from opendht_tpu_torch.infohash import InfoHash
    from opendht_tpu_torch.ops import ids as IK
    from opendht_tpu_torch.ops.lex_select import lex_topk_select
    from opendht_tpu_torch.ops.window_select import window_select
    from opendht_tpu_torch.runtime import Config, Dht
    from opendht_tpu_torch.sockaddr import SockAddr

    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    window_select.launches = lex_topk_select.launches = 0
    led = profiling.KernelLedger()
    comp = led.compute(device=dev)
    meas = led.measure(device=dev) if cuda else comp
    launches = {"window_select": window_select.launches,
                "lex_topk_select": lex_topk_select.launches}
    bad = {n: e["error"] for n, e in meas.items() if "error" in e}
    require(not bad, f"ledger specs failed on the device: {bad}")
    if cuda:
        # measure() raises where it cannot time a spec; a spec whose
        # window the profiler left empty carries None
        untimed = [n for n, e in meas.items()
                   if e.get("device_ms") is None or not e.get("roofline")
                   or e.get("peak_temp_bytes") is None
                   or e.get("device_kernels") is None]
        require(not untimed, f"ledger specs without a device time, a "
                f"roofline, a peak or captured device events: {untimed}")
    budgets = perf_gate._load_budgets(perf_gate.BUDGETS)
    rows, drift = {}, []
    for name, e in meas.items():
        b = budgets["kernels"][name]
        for f in profiling.DETERMINISTIC_FIELDS:
            if e[f] != b[f]:
                drift.append(f"{name}.{f}: device {e[f]} vs budget {b[f]}")
        rl = e.get("roofline") or {}
        rows[name] = {
            "launches_dispatched": e["launches"],
            "launches_cpu_budget": b["launches"],
            "device_kernels": e.get("device_kernels", "not measured"),
            "device_copies": e.get("device_copies", "not measured"),
            "kernel_ms": e.get("kernel_ms", "not measured"),
            "device_ms": e.get("device_ms", "not measured"),
            "bytes_bound": e["bytes_bound"], "flops_model": e["flops_model"],
            "bound_ms": rl.get("bound_ms", "not measured"),
            "bound_by": rl.get("bound", "not measured"),
            "hbm_pct_of_peak": rl.get("hbm_pct_of_peak", "not measured"),
            "peak_key": rl.get("peak_key", "not measured"),
            "peak_temp_bytes": e.get("peak_temp_bytes", "not measured"),
            "top_kernels": e.get("device_top", "not measured")}
    fails, warns = perf_gate.gate(budgets, meas)
    record = smoke_record("ledger", meas)
    emit({"phase": "ledger", **card, "specs": rows, "record": record,
          "cuda_kernel_launches": launches, "gate_failures": fails,
          "gate_warnings": warns,
          "peaks": profiling.platform_peaks(dev) if cuda else "not measured",
          "seconds": time.perf_counter() - t_phase})
    require(not drift, f"ledger fields differ from the budgets: {drift}")
    require(not fails, f"perf_gate against the device ledger: {fails}")
    if cuda:
        require(launches["window_select"] >= 1
                and launches["lex_topk_select"] >= 1,
                "the ledger's lookup specs launched both kernels")

    # ---- C.2.1: the live node's Q=1 resolves split by op -------------
    AF = socket.AF_INET
    _rng, ids, targets_np = live_node_data(args)
    dht = Dht(lambda d, a: 0, Config(max_req_per_sec=1_000_000),
              has_v6=False, device=None if cuda else "cpu")
    table = dht.tables[AF]
    table.bulk_load(ids, dht.scheduler.time(),
                    addrs=SockAddr("127.0.0.2", 4567))
    dht.warmup()
    sync()
    targets = [InfoHash(r.tobytes()) for r in IK.ids_to_bytes(targets_np)]
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    reps = 4

    def resolve_split(route: str, first: int) -> dict:
        tg = targets[first:first + reps + 1]
        dht.find_closest_nodes_batched([tg[0]], AF)          # warm
        sync()
        counted = profiling.count_call(
            lambda: dht.find_closest_nodes_batched([tg[1]], AF), (), {},
            dev, by_caller=True)
        counted.pop("_out")
        walls = []
        with profile(activities=acts) as prof:
            for t in tg[1:]:
                t0 = time.perf_counter()
                dht.find_closest_nodes_batched([t], AF)
                sync()
                walls.append((time.perf_counter() - t0) * 1e3)
        out = {"route": route, "calls": reps, "host_ms_per_call": walls,
               "dispatched_ops_per_call": counted["launches"],
               "dispatched_top": sorted(counted["launches_by_op"].items(),
                                        key=lambda kv: -kv[1])[:10],
               "dispatched_by_function": list(
                   counted["launches_by_caller"].items())[:12]}
        if cuda:
            split = op_launch_split(prof)
            out.update({"per_call_device_events":
                        split["device_events"] / reps,
                        "per_call_device_ms": split["device_ms"] / reps,
                        "split": split})
        return out

    snap = resolve_split("snapshot", 0)
    require(table.churn_pending == 0, "the first resolves ran on the "
            "snapshot")
    dht.insert_node(InfoHash(_near_id(bytes(dht.myid), 30, b"ledger-join")),
                    SockAddr("127.0.0.3", 4567))
    require(table.churn_pending > 0, "a join left churn pending")
    churn = resolve_split("churn view", reps + 1)
    emit({"phase": "ledger_q1_split", **card, "rows": len(table),
          "snapshot": snap, "churn": churn,
          "seconds": time.perf_counter() - t_phase})
    return launches


def storm_plan():
    """benchmarks/exp_chaos_r18.py's arc: a join/leave storm, a refill,
    then an ASYMMETRIC partition (g0 -> g1 blocked) that heals when its
    phase ends."""
    from opendht_tpu_torch import chaos
    return chaos.FaultPlan([
        chaos.Phase("storm", start=1.0, duration=3.0,
                    storm=chaos.Storm(leave_rate=0.10, join_rate=0.10)),
        chaos.Phase("refill", start=4.0, duration=3.0,
                    storm=chaos.Storm(join_rate=0.5)),
        chaos.Phase("split", start=8.0, duration=6.0,
                    partition=chaos.Partition(block=[("g0", "g1")])),
    ], seed=3)


def swarm_phase(args, dev, card, sync) -> None:
    """The device swarm (module docstring, phase 17): the storm arc at
    --swarm-n nodes, its replay, and the small arc against the numpy
    oracle."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from opendht_tpu_torch.ops import swarm

    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    S, K, M, T = args.swarm_n, 64, 32, 22

    def arc(traced: bool):
        sim = swarm.SwarmSim(storm_plan(), n_nodes=S, n_keys=K, n_groups=2,
                             seed=5, sweep_sample=M, repub_every=2,
                             device=dev)
        sync()
        rows, ticks = [], []
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        prof = profile(activities=acts) if traced else None
        if prof is not None:
            prof.__enter__()
        try:
            for _ in range(T):
                phases = ",".join(p.name for p in
                                  sim.plan.phases_at(sim.t)) or "-"
                t0 = time.perf_counter()
                m = sim.tick()
                sync()
                ticks.append((time.perf_counter() - t0) * 1e3)
                m.update(sim.probe())
                m["phases"] = phases
                rows.append(m)
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        return sim, rows, ticks, prof

    if cuda:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    sim, rows, ticks, _ = arc(False)
    peak = (torch.cuda.max_memory_allocated() - base if cuda
            else "not measured")
    # the acceptance arc: healthy, degraded under the cut, healed
    require(rows[0]["verdict"] == "healthy", f"swarm tick 0: {rows[0]}")
    require(any(r["verdict"] != "healthy" for r in rows[9:13]),
            "the partition degraded the invariants")
    last = rows[-1]
    require(last["verdict"] == "healthy" and last["lookup_success"] >= 0.95
            and last["replica_coverage"] >= 0.95, f"swarm healed: {last}")
    require(sum(r["n_leave"] for r in rows) > 0
            and sum(r["n_join"] for r in rows) > 0, "storms churned")
    # the replay: same seed, same strip, under the profiler
    sim2, rows2, ticks2, prof = arc(True)
    require(rows2 == rows, "the swarm arc replays identically under its "
            "seed")
    st1, st2 = swarm.state_to_numpy(sim.state), swarm.state_to_numpy(
        sim2.state)
    for k in swarm.STATE_KEYS:
        require(np.array_equal(st1[k], st2[k]), f"replayed state {k}")
    per_tick = device_totals(prof, cuda, T)
    ts = sorted(ticks)
    emit({"phase": "swarm", **card, "nodes": S, "keys": K, "sweep": M,
          "ticks": T, "seed": 5, "repub_every": 2,
          "tick_ms": {"p50": ts[T // 2], "p99": ts[min(T - 1,
                                                        int(0.99 * T))],
                      "all": ticks},
          "replay_tick_ms_under_profiler": ticks2,
          "per_tick": {k: per_tick[k] for k in DEVICE_TOTALS},
          "per_tick_top": per_tick["top"],
          "peak_device_bytes": peak,
          "strip": [{k: r[k] for k in ("phases", "n_alive", "n_leave",
                                       "n_join", "lookup_success",
                                       "replica_coverage", "model_err",
                                       "verdict")} for r in rows],
          "replayed_identically": True,
          "record": smoke_record("swarm_storm", {
              "tick_ms_p50": ts[T // 2], "nodes": S, "ticks": T,
              "device": card})})

    # the small arc: the device step against the numpy oracle, tick by
    # tick, on the same drawn bits
    kw = dict(n_nodes=4096, n_keys=48, n_groups=2, seed=5, sweep_sample=M,
              repub_every=2)
    d = swarm.SwarmSim(storm_plan(), device=dev, **kw)
    h = swarm.SwarmSim(storm_plan(), device=dev, oracle=True, **kw)
    for t in range(8):
        md, mh = d.tick(), h.tick()
        require(md == mh, f"oracle arc tick {t}: {md} vs {mh}")
        sd = swarm.state_to_numpy(d.state)
        for k in swarm.STATE_KEYS:
            require(np.array_equal(sd[k], h.state[k]),
                    f"oracle arc tick {t}: state {k}")
        require(d.probe() == h.probe(), f"oracle arc tick {t}: probes")
    emit({"phase": "swarm_oracle", **card, "nodes": 4096, "keys": 48,
          "ticks": 8, "equal": True,
          "seconds": time.perf_counter() - t_phase})


def bench_phase(args, dev, card) -> None:
    """The bench twin once (module docstring, phase 18)."""
    from opendht_tpu_torch import bench
    out = bench.measure(dev, N=args.n, Q=args.q,
                        samples=5 if dev.type == "cuda" else 1)
    emit({"phase": "bench", **out})
    require(out["exact"], "bench: the cascade's rows equal the full scan")
    # the soft wall-clock ceilings over this run's records: warnings only
    from opendht_tpu_torch import perf_gate
    warns: list = []
    perf_gate.check_timing(perf_gate._load_budgets(perf_gate.BUDGETS),
                           os.environ["OPENDHT_TPU_SMOKE_RECORD_DIR"], warns)
    emit({"phase": "timing_gate",
          "records": os.environ["OPENDHT_TPU_SMOKE_RECORD_DIR"],
          "warnings": warns})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000, help="table ids")
    ap.add_argument("--q", type=int, default=131_072, help="targets")
    ap.add_argument("--search-n", type=int, default=10_000_000,
                    help="ids of the search and maintenance phases")
    ap.add_argument("--search-q", type=int, default=65_536,
                    help="lookups per search wave")
    ap.add_argument("--search-waves", type=int, default=16)
    ap.add_argument("--churn-n", type=int, default=10_000_000,
                    help="base ids of the churn phase")
    ap.add_argument("--churn-q", type=int, default=131_072,
                    help="lookups per churn round")
    ap.add_argument("--churn-dcap", type=int, default=65_536,
                    help="delta slab capacity of the churn rounds")
    ap.add_argument("--churn-e", type=int, default=512,
                    help="evictions and inserts per churn round")
    ap.add_argument("--churn-table-n", type=int, default=1_000_000,
                    help="ids of the churn phase's NodeTable check")
    ap.add_argument("--serve-n", type=int, default=1_000_000,
                    help="rows of the live node (serve and runner phases)")
    ap.add_argument("--serve-q", type=int, default=256,
                    help="requests of the live node's burst (serve and "
                         "runner phases)")
    ap.add_argument("--serve-gets", type=int, default=1000,
                    help="Dht.get calls of the serve phase's config 1")
    ap.add_argument("--proxy-keys", type=int, default=64,
                    help="keys the proxy phase posts and gets over REST")
    ap.add_argument("--pht-entries", type=int, default=16,
                    help="entries the proxy phase's PHT index inserts")
    ap.add_argument("--monitor-runners", type=int, default=16,
                    help="DhtRunners of the monitor phase's cluster")
    ap.add_argument("--monitor-keys", type=int, default=256,
                    help="keys the monitor phase puts (a quarter got back) "
                         "and probes")
    ap.add_argument("--cluster-children", type=int, default=4,
                    help="child processes of the cluster phase")
    ap.add_argument("--cluster-nodes", type=int, default=8,
                    help="nodes in each child of the cluster phase")
    ap.add_argument("--cluster-keys", type=int, default=65,
                    help="keys the cluster phase puts, gets and resolves "
                         "(more than 64: the census's device route; 128 "
                         "cut to 65 for the full run's time)")
    ap.add_argument("--planes-keys", type=int, default=500,
                    help="keys the planes phase's client puts")
    ap.add_argument("--planes-gets", type=int, default=2048,
                    help="Dht.get calls of the planes phase's Zipf stream")
    ap.add_argument("--scale-n", type=int, default=64_000_000,
                    help="ids of the scale phase's config 5 table")
    ap.add_argument("--scale-q", type=int, default=65_536,
                    help="queries of the scale phase's lookups")
    ap.add_argument("--swarm-n", type=int, default=50_000,
                    help="nodes of the swarm phase's storm arc")
    ap.add_argument("--hops-n", type=int, default=2048,
                    help="nodes of the hops phase's virtual net")
    ap.add_argument("--hops-ladder", default="8192,16384,32768",
                    help="comma-separated net sizes of the hops_ladder call")
    ap.add_argument("--soak-secs", type=float, default=60.0,
                    help="wall seconds of the soak call's load")
    ap.add_argument("--smokes", default=",".join(SMOKES),
                    help="comma-separated smokes of the smokes phase "
                         "(default: all " + str(len(SMOKES)) + ")")
    ap.add_argument("--phases", default="all",
                    help="'all', or a comma-separated list of late phases "
                         "(" + ", ".join(LATE_PHASES) + ") to run after "
                         "the device, build, parity and main phases; "
                         "'all' leaves out " + ", ".join(CALL_OF_ITS_OWN))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the host with the plain versions "
                         "(never prints the ok line)")
    args = ap.parse_args(argv)
    wanted = set(args.phases.split(","))
    if wanted - set(LATE_PHASES) - {"all"}:
        ap.error(f"unknown phases {sorted(wanted - set(LATE_PHASES))}")

    def late(name: str) -> bool:
        return name in wanted or ("all" in wanted
                                  and name not in CALL_OF_ITS_OWN)

    import torch
    # -- 1. device ---------------------------------------------------------
    if not args.cpu and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if args.cpu:
        # the rehearsal's shapes are tiny: two intra-op threads run it
        # about as fast as all cores alone, and beside other busy torch
        # processes (a test suite's workers) all-core OpenMP pools spin
        # against each other and slow it twenty-fold
        torch.set_num_threads(2)
        dev, kind, smi = torch.device("cpu"), "cpu (rehearsal)", "not measured"
    else:
        dev, kind, smi = (torch.device("cuda"), torch.cuda.get_device_name(0),
                          nvidia_smi_line())
    print(smi, flush=True)
    card = {"card": kind, "nvidia_smi": smi}
    emit({"phase": "device", **card, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "count": torch.cuda.device_count() if not args.cpu else 0})

    from opendht_tpu_torch import NodeTable, InfoHash
    from opendht_tpu_torch.ops import _build
    from opendht_tpu_torch.ops import ids as IK
    from opendht_tpu_torch.ops import sorted_table as ST
    from opendht_tpu_torch.ops.lex_select import (lex_topk_select,
                                                   lex_topk_select_plain)
    from opendht_tpu_torch.ops.window_select import (window_select,
                                                      window_select_plain)
    from opendht_tpu_torch.ops.xor_topk import xor_topk

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    # -- 2. build ----------------------------------------------------------
    if not args.cpu:
        t0 = time.perf_counter()
        libs = _build.build_all()
        build_s = time.perf_counter() - t0
        ptxas = [line.strip() for p in libs
                 for line in p.with_suffix(".log").read_text().splitlines()
                 if "registers" in line or "Compiling entry" in line]
        emit({"phase": "build", "seconds": build_s,
              "libraries": [p.name for p in libs], "ptxas": ptxas})

    # -- 3. parity ---------------------------------------------------------
    rng = np.random.default_rng(args.seed)
    err = {"window_select": 0, "lex_topk_select": 0}
    checked = {"window_select": [], "lex_topk_select": []}
    rows_np, q8_np, b_np = edge_window_inputs(rng, 4096)
    wr, wq, wb = (IK.to_keys(rows_np, dev), IK.to_keys(q8_np, dev),
                  torch.from_numpy(b_np).to(dev))
    for k in (1, 8, 14, 16, 21):
        got = window_select(wr, wq, wb, k=k)
        sync()
        want = window_select_plain(wr, wq, wb, k=k)
        e = max_abs_err(got, want)
        err["window_select"] = max(err["window_select"], e)
        checked["window_select"].append({"Q": 4096, "k": k, "err": e})
    ri_np, rq_np, rb_np = row_index_inputs(rng, q8_np, b_np, 8192)
    ri, rq, rb = (torch.from_numpy(ri_np).to(dev), IK.to_keys(rq_np, dev),
                  torch.from_numpy(rb_np).to(dev))
    for k in (1, 8, 16, 21):
        got = window_select(wr, rq, rb, k=k, row_index=ri)
        sync()
        want = window_select_plain(wr, rq, rb, k=k, row_index=ri)
        e = max_abs_err(got, want)
        err["window_select"] = max(err["window_select"], e)
        checked["window_select"].append({"Q": 8192, "NB": 4096, "k": k,
                                         "row_index": True, "err": e})
    for W in (32, 128, 256, 1024):
        dist_np, inv_np = edge_lex_inputs(rng, 1024, W)
        d, i = IK.to_keys(dist_np, dev), torch.from_numpy(inv_np).to(dev)
        for k in (8, 16):
            got = lex_topk_select(d, i, k=k)
            sync()
            e = max_abs_err(got, lex_topk_select_plain(d, i, k=k))
            err["lex_topk_select"] = max(err["lex_topk_select"], e)
            checked["lex_topk_select"].append({"Q": 1024, "W": W, "k": k,
                                               "err": e})

    # -- 4. main path ------------------------------------------------------
    ids = rng.integers(0, 2**32, size=(args.n, 5), dtype=np.uint32)
    targets = rng.integers(0, 2**32, size=(args.q, 5), dtype=np.uint32)
    self_id = InfoHash(rng.integers(0, 256, size=20, dtype=np.uint8).tobytes())
    t0 = time.perf_counter()
    table = NodeTable(self_id, device=None if not args.cpu else "cpu")
    table.bulk_load(ids, now=0.0)
    snap = table.snapshot(now=0.0)
    sync()
    load_s = time.perf_counter() - t0
    require(args.n > 4096 and args.q > 64, "the card path needs > 4096 rows "
            "and > 64 targets")

    window_select.launches = 0
    lex_topk_select.launches = 0
    t0 = time.perf_counter()
    r16, d16 = table.find_closest(targets, k=16, now=0.0)
    t_fc16 = time.perf_counter() - t0
    ws_after_fc = window_select.launches
    r8, d8 = table.find_closest(targets, k=8, now=0.0)
    qk = IK.to_keys(targets, dev)
    t0 = time.perf_counter()
    wd, wi, wc = ST.lookup_topk(snap.sorted_ids, snap.n_valid, qk, k=16,
                                window=128, expanded=None)
    sync()
    t_lk = time.perf_counter() - t0
    launches = {"window_select": window_select.launches,
                "lex_topk_select": lex_topk_select.launches}
    if not args.cpu:
        require(ws_after_fc >= 1, "find_closest launched window_select")
        require(launches["lex_topk_select"] >= 1,
                "lookup_topk(expanded=None) launched lex_topk_select")

    # exactness: the port's xor_topk on 256 rows, numpy on 32 rows
    valid_rows = torch.arange(snap.sorted_ids.shape[0], device=dev) \
        < snap.n_valid
    perm_np = snap.perm.cpu().numpy()
    for k, rows, dist in ((16, r16, d16), (8, r8, d8)):
        require(rows.shape == (args.q, k) and dist.shape == (args.q, k, 5),
                "find_closest shapes")
        require(((rows >= 0) & (rows < table.capacity)).all()
                and table._valid[rows].all(), "rows are live slab rows")
        ed, ei = xor_topk(qk[:256], snap.sorted_ids, k=k,
                          tile=ST.scan_tile(args.n, 256), valid=valid_rows)
        ei = ei.cpu().numpy()
        require(np.array_equal(perm_np[ei], rows[:256]),
                f"find_closest k={k} rows == xor_topk")
        require(np.array_equal(IK.from_keys(ed), dist[:256]),
                f"find_closest k={k} dist == xor_topk")
        for qi in range(32):
            dd = ids ^ targets[qi]
            cut = np.partition(dd[:, 0], k - 1)[k - 1]
            cand = np.nonzero(dd[:, 0] <= cut)[0]
            c = dd[cand]
            order = cand[np.lexsort((c[:, 4], c[:, 3], c[:, 2], c[:, 1],
                                     c[:, 0]))[:k]]
            require(np.array_equal(table._ids[rows[qi]], ids[order]),
                    f"find_closest k={k} query {qi} == numpy oracle")
    ed, ei = xor_topk(qk[:256], snap.sorted_ids, k=16,
                      tile=ST.scan_tile(args.n, 256), valid=valid_rows)
    require(torch.equal(ei, wi[:256]) and torch.equal(ed, wd[:256]),
            "lookup_topk(expanded=None) == xor_topk")
    require(bool(wc.all()), "lookup_topk certified every row after fallback")
    # uncertified rows before the fallback (outside the counted run)
    uncert = {}
    for name, k in (("expanded_k16", 16), ("expanded_k8", 8)):
        _, _, c = ST.expanded_topk(snap.sorted_ids, snap._expanded,
                                   snap.n_valid, qk, k=k, select="kernel")
        uncert[name] = int((~c).sum())
    _, _, c = ST.window_topk(snap.sorted_ids, snap.n_valid, qk, k=16,
                             window=128, select="kernel")
    uncert["window128_k16"] = int((~c).sum())
    emit({"phase": "main", **card, "n": args.n, "q": args.q,
          "load_and_snapshot_s": load_s, "find_closest_k16_first_s": t_fc16,
          "lookup_topk_window_first_s": t_lk, "launches": launches,
          "uncertified": uncert, "exact_rows_checked": {"xor_topk": 256,
                                                        "numpy": 32}})

    # main-path parity: the kernels on the main path's own inputs
    expanded = snap._expanded
    j, start = ST.expanded_window(snap.sorted_ids, expanded, snap.n_valid,
                                  qk)
    q8 = torch.nn.functional.pad(qk, (0, 3))
    bounds = torch.clamp(snap.n_valid - start, 0, 192)[:, None] \
        .expand(-1, 8).contiguous()
    for k in (16, 8):
        got = window_select(expanded, q8, bounds, k=k, row_index=j)
        sync()
        e = max_abs_err(got, window_select_plain(expanded, q8, bounds, k=k,
                                                 row_index=j))
        err["window_select"] = max(err["window_select"], e)
        checked["window_select"].append({"Q": args.q, "k": k, "err": e,
                                         "row_index": True,
                                         "main_path": True})
    rows_t = expanded[j]      # gathered rows: timing comparison only
    dist_w, inv_w, _, _ = ST.window_candidates(snap.sorted_ids, snap.n_valid,
                                               qk, window=128)
    for k in (16, 8):
        got = lex_topk_select(dist_w, inv_w, k=k)
        sync()
        e = max_abs_err(got, lex_topk_select_plain(dist_w, inv_w, k=k))
        err["lex_topk_select"] = max(err["lex_topk_select"], e)
        checked["lex_topk_select"].append({"Q": args.q, "W": 128, "k": k,
                                           "err": e, "main_path": True})
    # the id functions on the main path's own query keys
    t0 = time.perf_counter()
    id_parity = id_function_parity(
        qk[:ID_PAIRS], IK.to_keys(IK.ids_from_hashes([self_id]), dev))
    id_parity["s"] = time.perf_counter() - t0
    emit({"phase": "parity", **card, "max_abs_err": err, "cases": checked,
          "id_functions": id_parity,
          "tolerance": "bit-identical (integer outputs)"})
    require(err["window_select"] == 0 and err["lex_topk_select"] == 0,
            "kernels bit-identical to their plain versions")
    require(not any(id_parity["mismatches"].values()),
            f"id functions equal the numpy oracle: {id_parity['mismatches']}")

    # -- 5. timing ---------------------------------------------------------
    cuda = dev.type == "cuda"
    Q = args.q
    timing = {}
    NB = expanded.shape[0]
    for k in (16, 8):
        timing[f"window_select_k{k}"] = {
            "ms": median_ms(lambda: window_select(expanded, q8, bounds, k=k,
                                                  row_index=j),
                            inner=5, cuda=cuda),
            "plain_ms": median_ms(
                lambda: window_select_plain(expanded, q8, bounds, k=k,
                                            row_index=j),
                reps=5, cuda=cuda),
            # the same kernel on rows gathered first (row_index=None)
            "gathered_rows_ms": median_ms(
                lambda: window_select(rows_t, q8, bounds, k=k),
                inner=5, cuda=cuda),
            "fast3_select_ms": median_ms(
                lambda: ST.expanded_select(expanded, j, qk, start,
                                           snap.n_valid, k=k,
                                           select="fast3"),
                reps=5, cuda=cuda),
            "kernel_select_ms": median_ms(
                lambda: ST.expanded_select(expanded, j, qk, start,
                                           snap.n_valid, k=k,
                                           select="kernel"),
                inner=5, cuda=cuda),
            # the table once, plus row_index, queries8, bounds and out
            "bytes": NB * 970 * 4 + Q * (1 + 8 + 8 + 128) * 4,
            # context, not the bound: every query's row read on its own
            "row_read_bytes": Q * 970 * 4,
            # XORs, the local-best scans (~10 ops per 5-limb compare) and
            # per round the winner's rescan plus ~2 warp-wide operations
            "ops": Q * (5 * 192 + 10 * 192 + k * (10 * 6 + 64))}
        timing[f"lex_topk_select_k{k}"] = {
            "ms": median_ms(lambda: lex_topk_select(dist_w, inv_w, k=k),
                            inner=5, cuda=cuda),
            "plain_ms": median_ms(
                lambda: lex_topk_select_plain(dist_w, inv_w, k=k),
                reps=5, cuda=cuda),
            "bytes": Q * 128 * (5 * 4 + 4) + Q * k * 4,
            "ops": Q * (10 * 128 + k * (10 * 4 + 64))}
        timing[f"find_closest_k{k}_ms"] = host_median_ms(
            lambda: table.find_closest(targets, k=k, now=0.0))
    # what reading rows in place removes from the main path
    timing["row_gather_ms"] = median_ms(lambda: expanded[j], inner=5,
                                        cuda=cuda)
    for name in ("window_select", "lex_topk_select"):
        timing[f"{name}_k16_over_k8"] = (timing[f"{name}_k16"]["ms"]
                                         / timing[f"{name}_k8"]["ms"])
    timing["lookup_topk_window128_k16_ms"] = host_median_ms(
        lambda: (ST.lookup_topk(snap.sorted_ids, snap.n_valid, qk, k=16,
                                window=128, expanded=None), sync()))
    for v in timing.values():
        if isinstance(v, dict):
            v["bound_ms"] = max(v["bytes"] / HBM_BYTES_PER_S,
                                v["ops"] / OPS_PER_S) * 1e3
            v["bound_by"] = ("bytes" if v["bytes"] / HBM_BYTES_PER_S
                             >= v["ops"] / OPS_PER_S else "operations")
    emit({"phase": "timing", **card, "q": Q, "n": args.n, "timing": timing})

    # where one find_closest call spends its time (device kernels by name)
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        s = time.perf_counter()
        table.find_closest(targets, k=16, now=0.0)
        wall_ms = (time.perf_counter() - s) * 1e3
    # device-side events only (kernels and copies): the aten ops that
    # launched them carry the same time again
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in ev)
    top = sorted(ev, key=lambda e: e.self_device_time_total, reverse=True)
    emit({"phase": "profile", **card, "call": "find_closest k=16",
          "wall_ms": wall_ms, "device_ms": dev_us / 1e3,
          "device_busy_share": dev_us / 1e3 / wall_ms,
          "note": "wall_ms includes the profiler's own overhead",
          "top_device": [{"name": e.key[:80], "calls": e.count,
                          "device_ms": e.self_device_time_total / 1e3}
                         for e in top[:12]]})

    # -- 7. memory ---------------------------------------------------------
    del rows_t
    gathered_bytes = Q * 970 * 4
    peak_extra = "not measured"
    if cuda:
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        table.find_closest(targets, k=16, now=0.0)
        sync()
        peak_extra = torch.cuda.max_memory_allocated() - base
    emit({"phase": "memory", **card, "call": "find_closest k=16", "q": Q,
          "peak_extra_bytes": peak_extra,
          "gathered_rows_bytes": gathered_bytes})
    if cuda:
        require(peak_extra < gathered_bytes,
                f"find_closest k=16 allocated {peak_extra} B at peak, not "
                f"below the {gathered_bytes} B of gathered rows")

    # the search phase's 10M-id hops, printed beside the hops phase's
    args.search_hops = None
    if late("search"):
        args.search_hops = search_phase(args, dev, card, sync)
    if late("hops"):
        # a process of its own: a 2,048-node net adds ~66,000 series to
        # the metrics registry that the later nodes' ticks walk
        for name, n in phase_in_child("hops", args, card).items():
            launches[name] += n
    if late("maintenance"):
        maintenance_phase(args, dev, card)
    if late("churn"):
        churn_phase(args, dev, card, sync)
    if late("serve"):
        # the serve phase's own path: its window_select launches join
        # the main path's in the kernels line
        serve_launches, serve_err = serve_phase(args, dev, card, sync)
        launches["window_select"] += serve_launches
        err["window_select"] = max(err["window_select"], serve_err)
    if late("runner"):
        # the runner's path: its window_select launches join too
        launches["window_select"] += runner_phase(args, dev, card, sync)
    os.environ.setdefault("OPENDHT_TPU_SMOKE_RECORD_DIR", str(
        Path(__file__).resolve().parent / "build" / "smoke_records"))
    if late("proxy"):
        # the proxied requests resolve on the live node: their
        # window_select launches join too
        launches["window_select"] += phase_in_child("proxy", args, card)
    if late("monitor"):
        # the coverage probe's resolves launch window_select
        launches["window_select"] += phase_in_child("monitor", args, card)
    if late("cluster"):
        # the census over the subprocess cluster launches window_select
        launches["window_select"] += phase_in_child("cluster", args, card)
    if late("planes"):
        # the planes phase's misses launch window_select too
        launches["window_select"] += planes_phase(args, dev, card, sync)
    if late("scale"):
        # the sharded resolve launches both kernels once per shard
        scale_launches, scale_err = scale_phase(args, dev, card, sync)
        for name in launches:
            launches[name] += scale_launches[name]
            err[name] = max(err[name], scale_err[name])
    if late("ledger"):
        # the ledger's lookup specs launch both kernels
        for name, n in ledger_phase(args, dev, card, sync).items():
            launches[name] += n
    if late("swarm"):
        swarm_phase(args, dev, card, sync)
    if late("bench"):
        bench_phase(args, dev, card)
    for name in CALL_OF_ITS_OWN:
        if late(name):
            # the smoke children's, the ladder's and the soak's select
            # kernel launches join the count
            for kernel, n in phase_in_child(name, args, card).items():
                launches[kernel] += n

    kernels = []
    for name, src_line in (("window_select",
                            "opendht_tpu/ops/pallas_window_topk.py:99"),
                           ("lex_topk_select",
                            "opendht_tpu/ops/pallas_select.py:79")):
        t = timing[f"{name}_k16"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "opendht_tpu_torch/csrc/select_kernels.cu",
            "replaces": src_line, "launches": launches[name],
            "max_abs_err": err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    if args.cpu or "all" not in wanted:
        print("chip_smoke: CPU rehearsal or partial run finished; not a "
              "full chip run", file=sys.stderr)
        return 3
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
