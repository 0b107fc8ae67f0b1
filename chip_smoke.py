"""GPU smoke run of the PyTorch + CUDA port (cfk_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass:

1. build   — compile the fifteen CUDA kernels from cfk_tpu_torch/csrc (one
             nvcc per source, in parallel) and the host ingest library
             (``csrc/host/cfk_native.cpp``, the host C++ compiler; the phase
             fails if it does not load — nothing runs on the numpy route);
2. main    — train explicit ALS-WR with ``train_als`` at the Netflix Prize
             shape (480,189 users x 17,770 movies x 100,480,507 synthetic
             ratings, seed 0), tiled layout (accum movie half + dense-stream
             user half), rank 64, lambda 0.05, float32, 3 iterations, the
             fused epilogue (K1-K3); the "data:" line gives the generate,
             group_by (the host library's counting sort of both sides'
             keys) and block seconds, and the counting sort of the
             100,480,507 movie keys is held to numpy's stable argsort
             (order, count, start equal); every
             kernel's launch counter is zeroed just before and read just
             after, and each must be > 0; factors must be finite and the
             train RMSE below the ratings' standard deviation;
3. kernels — each kernel against its plain PyTorch version on the card at
             main-path shapes (K1: the movie half's E = 17,770 accumulated
             Grams at k = 64 with their real counts, and count-scaled random
             Grams at k = 128, then at k = 128 below one wave — E = 1 and
             E = 203 (a split implicit chunk), the kernel's device time
             (torch.profiler) beside the bound, which there reads as a
             floor no latency reaches — and twice on the
             full batch (bit-equal); K2, K3: the middle chunk of the full-shape
             dataset at k = 64 and the chunk holding the half's largest
             segment, each with its work-unit plan and launched twice — the
             two launches must be bit-equal; the trained factors as the
             table throughout), with its time, the plain
             version's time, a one-call library yardstick where one exists
             and the card's bound for the same work;
3b. binv   — the block-inverse solve path (the port of the prototype
             ``scripts/exp_binv.py``, ``cfk_tpu_torch.scripts.exp_binv``):
             with the launch counts of ``binv_solve_reg`` and ``binv_inv``
             zeroed just before and read just after (each > 0), both routes
             once at the prototype's default shape — k = 128, E = 5,248
             (``--e 5344`` rounded down to a tile multiple), its rank-k/8
             Grams plus λ·max(n, 1)·I from numpy seed 0 — the fused kernel
             (``binv_solve_reg``) and the Schur route (batched float32
             products above n = 32, ``binv_inv`` on the 32 x 32 blocks);
             each held to its plain version (TOL "binv_solve_reg") and to
             a float64 ``numpy.linalg.solve`` (TOL "binv_float64"), beside
             two controls (the plain solve unrefined, which must read above
             the tolerance, and with TF32 products), with max |Ax − b|, the
             relative x error, ms beside K1 and ``torch.linalg.solve`` on the same
             batch and the bound (K1's error against float64 is held to
             twice the column-at-a-time solve's, TOL "reg_solve_float64");
             then ``binv_solve_reg`` on the main path's
             E = 17,770 accumulated movie Grams at k = 64 against K1's x;
             matrix mode at k = 128 on 59,047 count-scaled Grams with one
             shared SPD ridge YᵀY + λI (the ML-25M movie and user counts)
             against K1's matrix mode, its plain version and
             ``torch.linalg.solve``; ``binv_inv`` alone at n = 16 and 32
             against its plain version and ``torch.linalg.inv``; the two
             kernels' ptxas registers and spills and their CTAs per SM
             (the occupancy calculator); and
             ``python -m cfk_tpu_torch.scripts.exp_binv`` (both modes) as a
             subprocess, exit 0;
4. breakdown — where one iteration's time goes (measurement, no checks):
             each kernel's device time per chunk beside the chunk's live
             rows, the rows of its largest segment, its work units and
             split segments, and the summed bound, and a torch.profiler
             pass over one iteration;
4b. split  — the split epilogue (``fused_epilogue=False``) on the same
             dataset from the main run's initial factors: ``train_als`` for 2
             iterations (accum half: K2 + the ridge add + ``gauss_solve``;
             dense half: the split Gram ``gram_tiles_dense_gather`` + K1 per
             chunk), the launch counts of those four zeroed before and read
             after (each > 0), s/iter, each half's ms, the train RMSE guard;
             the first movie half against the fused route's from the same
             start (TOL, and bit-equal: the same float32 ridge add and the
             same Cholesky code, K1's) and the first user half from the same
             movie factors (bit-equal: the same Gram sums and the same ridge
             + Cholesky code); then the split Gram on the middle dense chunk
             and ``gauss_solve`` on the movie half's E = 17,770 accumulated
             Grams with their ridge (launched twice: bit-equal) against
             their plain versions, with times, bounds and library times;
4c. gather — the materialized-stream schedule (``in_kernel_gather=False``)
             on the same dataset: ``train_als`` from the main run's start,
             2 fused iterations (accum half: K5 + ``gram_tiles`` per chunk,
             K1; dense half: K5 + ``gram_solve_tiles_dense`` per chunk) and
             2 split (``gram_tiles`` + ``gauss_solve``;
             ``gram_tiles_dense`` + K1), each with its launch counts zeroed
             before and read after (the stream kernels and K5 > 0; K2, K3,
             K6 and ``gram_tiles_dense_gather`` = 0), s/iter beside the
             gather-on runs', the train RMSE guard; the first movie and
             user halves with the gather off against on from the same start,
             fused and split (bit-equal by design; held to TOL) and each
             half's device ms; then ``gram_tiles`` on the middle accum chunk
             and ``gram_solve_tiles_dense`` and ``gram_tiles_dense`` on the
             middle dense chunk (its real carry) against their plain
             versions and their gather siblings, with times and bounds, and
             both stream kernels' time on every chunk beside its largest
             segment;
4d. rank256 — explicit ALS-WR above the fused kernels' rank cap (128) on
             the same dataset: ``train_als`` at rank 256, λ 0.05, default
             knobs, 2 iterations — every chunk takes the split schedule, as
             in the JAX package (accum half: K2 per chunk, the ridge add,
             ``batched_spd_solve``, PyTorch's batched Cholesky, on the
             17,770 accumulated Grams; dense half: the split dense Gram per
             chunk, the ridge add and ``batched_spd_solve``) — then 1
             iteration with the gather off (K5 + rows 5 and 4); launch
             counts zeroed before each run and read after (the split Grams
             > 0; K1, K3, K6, rows 6, 7, 11, 12 = 0), s/iter, peak memory,
             the train RMSE guard; the first movie half with the gather off
             against on (bit-equal) and against a float64 solve of the same
             Grams plus their ridge (TOL "float64_r256"); rows 2 and 5 on
             the middle accum chunk and rows 9 and 4 on the middle dense
             chunk (its real carry) at k = 256 against their plain versions
             (TOL "gram_r256"), each twin bit-equal to its sibling, with ms
             and bound (the kernels line's ``k256``); the Cholesky route's
             ms on the movie accumulator and on the middle dense chunk's
             Grams; each half's device ms and a profiler pass over one
             iteration;
4e. segment — the segment layout (flat sorted runs in 16,384-rating
             chunks, ``Dataset.from_coo(layout="segment")`` of the main
             phase's ratings) at the same shape, rank 64, λ 0.05: 2
             iterations of ``train_als`` from the tiled run's u0 (each
             chunk's Gram through K2 on one-row tiles — its staged work-unit
             plan, the carry folded in — then K1): K2's and K1's launch
             counts zeroed before and read after must each equal the chunks
             of the two iterations; the train RMSE guard; the first movie
             half against the tiled run's first movie half from the same u0
             (TOL "segment_first_half": the same normal equations, float32
             sums in another order) and against itself run again
             (bit-equal); K2 on the middle chunk of each half against its
             plain version (TOL), launched twice (bit-equal), ms beside the
             plain version's, the bound and the ``index_add_`` route it
             replaced; s/iter, the device time and idle share of a
             profiled window (each half's first 1,024 chunks, scaled to the
             iteration's chunks), chunks and Ec per half, peak memory and
             block-build seconds;
4f. quant — quantized training (``ALSConfig.table_dtype``, ``dtype``) on the
             main phase's tiled blocks, rank 64, λ 0.05: 2 iterations of
             ``train_als`` each from the tiled run's u0 (seed 0) at float32,
             with a bf16 gather table, an int8 one (the per-row scale
             folded into the weights) and bf16 factor storage; launch counts
             zeroed before and read after (K1-K3 > 0), the train RMSE of
             each against the float32 run's (ratios ≤ 1.01, 1.10, 1.01:
             the JAX package's contract on its planted fixture), s/iter and
             the device time of one profiled iteration each; then, on the
             trained factors quantized to bf16 and to int8, K2 and K6 on the
             middle accum chunk, K3 and row 9 on the middle dense chunk (the
             carry its previous chunks hand it), K5 on each chunk's operands
             and rows 4-7 on K5's stream (bf16 for the bf16 table, float32
             for int8), each launched twice (bit-equal), held to its plain
             version at TOL and each stream twin to its gather sibling (bit-
             equal), with ms and the bound at 2 B or 1 B a table element
             (an int8 row's scale rides in the weights the kernel reads)
             and, for bf16 operands, the Gram's products at the tensor
             cores' bf16 rate (the kernels line's ``ms_bf16``/``ms_int8``,
             ``bound_ms_bf16``/``bound_ms_int8``); and the first movie and
             user halves with the gather off against on from u0 at each
             table dtype (bit-equal);
4g. pipeline — the chunk pipeline (``ALSConfig.overlap``) on the main
             phase's dataset, rank 64, 3 iterations from the seeded init:
             the fused, split, gather-off fused and gather-off split
             schedules, each trained with overlap on and ``capture=True``
             (iteration 1 eager, iterations 2-3 replays of one captured
             iteration; with the gather off K5 writes each chunk's stream
             on a side stream) and off (the serial loop), every launch
             counter zeroed before each run: the factors bit-equal
             (``torch.equal``); the counters of the captured run (its
             eager iteration 1) plus two replays of the launches its
             capture recorded equal to the serial run's counters, and the
             graph holding one kernel node of each recorded launch's
             kernel (``ops.pipeline.replay_launches``, read from the
             libcuda); the route each configuration takes by default
             (``pipeline_route``: prefetched, since capture is opt-in);
             s/iter on and off, the capture and instantiation seconds and
             the graph's pool; then one eager iteration (off) and one replay
             of a captured iteration (on) profiled (``device_timeline``:
             CUDA activity alone; the union of kernel intervals a call,
             the idle share, whether CUPTI reports the kernels inside the
             replay, the graph's node count, and with the gather off the
             ms K5 ran while the Gram kernels ran).  The segment (4e,
             2 iterations) and rank-256 (4d, 2 iterations) cases, both
             bit-equal, run in their phases, the pipeline phase's report
             holds them, and those phases read their launch counts from
             the serial run;
4h. resilience — ``cfk_tpu_torch.resilience`` at the Netflix shape on the
             main phase's blocks, rank 64, λ 0.05, its seeded u0, 3
             iterations through ``models.als.train_loop`` (``train_als``'s
             routing) on blocks uploaded once: the sentinel every
             iteration on against off (the probe folded into a device
             word), in turns, s/iter each, the factors bit-equal; a
             checkpoint every iteration, the synchronous writer against
             the async one (pinned ``non_blocking`` snapshots), in turns,
             s/iter and the loop's checkpoint seconds, every step's crc32
             equal and the factors bit-equal to the fault-free run's; NaN
             rows before iteration 2 — trip, rollback, replay — ending
             bit-equal to the fault-free run, with the recovery's seconds
             beside the same plan's clean stepped run; the captured route
             (``capture=True``, only the sentinel armed) at λ = 0, whose
             singular users trip the probe inside the captured iteration:
             the run is replayed through the eager loop and the ladder
             (``max_recoveries`` 8) ends it, bit-equal to the same plan on
             the eager stepped loop; SIGTERM before iteration 2 of 4 under
             a ``PreemptionGuard``: step 3 committed, the resume bit-equal
             to the uninterrupted run;
4i. stream — streaming fold-in (``cfk_tpu_torch.streaming``) on the main
             phase's dataset and trained rank-64 model: ``StreamState`` of
             the 100,480,507 ratings (its seconds); 16,384 seeded updates
             (users and movies drawn from the dataset's raw ids, ratings
             1-5, 64 new users) produced into a ``FileBroker`` (fsync on, 4
             partitions); a session with ``batch_records`` 256 (16 batches
             of at most 1,024 records), ``foldin_layout="auto"`` (the
             tiled fold-in: K2 + K1), the sentinel every batch, async
             commits, ``keep_last_n`` 2 — with K1's and K2's counts zeroed
             just before and read just after (each > 0), updates/s, p50 and
             max batch seconds, the seconds of stage, foldin_solve,
             health_check and commit, peak device memory, the fold-in's
             kernel ms (torch.profiler, one batch); every touched row
             within TOL "reg_solve" of ``fold_in_rows`` on the CPU (the
             plain versions) on the same neighbor lists and movie factors,
             every untouched row equal to the base model's; a crash after 8
             batches resumed from the store, and a ``FlakyTransport``
             (duplicate 3, reorder 5, drop 7) delivery, each crc-equal to
             the clean run; a ``ServeEngine`` attached to the clean session
             answering a top-100 for 64 touched users through K4 (its count
             recorded) with ids equal to an engine built from the committed
             step; the padded fold-in (K1, its count recorded) of 256 users
             of a 1,000,000-rating synthetic set against its plain version;
5. serve   — top-K serving at the repo's serving configuration (``bench.py
             --serve``: 162,541 users x 59,047 movies, the ML-25M shape,
             rank 128, K = 100, tile_m 2048, seen lists at the ML-25M mean;
             factors and seen CSR from ``serve_factors``/``serve_seen_csr``,
             seed 0): exact mode at batches 16, 64, 256 with an f32 table,
             bf16 and int8 tables at 256, two-stage at 256 (1024 clusters).
             Per configuration K4's count is zeroed, ``ServeEngine.topk`` and
             an open-loop run through ``RecommendServer`` (70% of the
             measured capacity, 256 requests) drive it, and the count must be
             > 0; then K4 on that batch's own arguments against its plain
             version (f32 and int8 tables exactly — values and ids bit
             for bit; bf16 within TOL), exact-mode ids against the dense
             route, no [B, M]
             allocation during a K4 call, times (the whole call, each of
             its two launches from torch.profiler, the bound — for a bf16
             table at the tensor cores' bf16 rate — and the library's), and
             two-stage recall@100 vs the same engine's exact scan (>= 0.95,
             no fallback); then K = 2,000 (above the two-launch route's
             1,024) at B = 256 through ``ServeEngine.topk`` with the f32 and
             the int8 table: the large-K route's three launches counted
             (zeroed just before, read just after; the two-launch route's
             held at 0), its answer exactly the plain version's (values
             and ids) and the engine's, each launch's device ms beside the
             call's, the bound and ``torch.topk(addmm)``; then K4 at rank
             600 (above the earlier kernel's 512 cap) against its plain
             version on a small random table, every table kind;
5b. fleet  — the replicated serving fleet (``cfk_tpu_torch.serving.fleet``)
             at the serve shape (exact, f32 table, k = 100, tile_m 2048; the
             serve phase's factors and a seen CSR over the phase's users,
             seed 2): the port's broker (``BrokerProcess``, memory-only, on
             localhost), a ``ServeFleet`` of 2 replicas over one shared
             ``TcpBrokerClient`` with a ``DeltaStreamTamper`` hiding the
             delta frame at offset 3, the store seeded; a closed burst of
             2,048 user-keyed requests measures the fleet's capacity, then
             8 open-loop waves of 1,024 Zipf users at 70% of it
             (``FLEET``); before wave 3 a ``DeltaPublisher`` ships 8 commits
             of 1,024 touched users (after wave 3 both replicas have
             detected the gap and resynced, and their ``table_crc`` equals a
             fresh engine's that applied every commit); after wave 4
             ``kill_replica(0)`` and a probe for a victim user (the failover
             gap); before wave 5 a retrain epoch, which the survivor builds
             and prewarms on a background thread and flips.  Every request
             answered (a retriable rejection re-sent), zero timeouts, every
             answer stamped; every answer from wave 4 on held to the oracle
             engine of its epoch stamp (``compare_topk``, TOL
             "topk_scores": no mixed-epoch table); K4 launched on each
             replica's thread (the wrapper's own counts, under its lock and
             per launching thread, two a call; the kernels line's
             ``fleet_launches``) and two captured launches of each held to
             its plain version (``compare_topk``, TOL "topk_scores";
             bit-equality recorded); QPS, p50/p99, shed, retries, mean
             batch, the failover gap, the resync and rollover seconds, the
             card's timeline (device ms, idle share) over the burst and
             over wave 2 with both replicas serving, and ``engine.topk``
             alone at B = 256 outside the fleet printed; the phase within
             60 s;
5c. shards — sharded training and serving (``cfk_tpu_torch.parallel``)
             on two ranks sharing the card (``make_mesh(2)``: gloo, every
             exchange staged through pinned host memory — a check of the
             per-rank launches and the protocol at full width, not a
             multi-card measurement): the ML-25M shape (162,541 users x
             59,047 movies x 25,000,095 synthetic ratings, seed 0), rank
             64, λ 0.05, tiled, 2 iterations of ``train_als_sharded`` with
             ``exchange="ring"`` (both halves ring-built: K2 on each visit's
             rotated block, K1 at the end) and ``"auto"`` (as the builder's
             memory rule picks per half at this shape), each from the
             one-rank ``train_als`` run's init, held to that run (max|Δ| of
             both tables within 1e-3 of max|x|, |ΔRMSE| ≤ 1e-4), and
             ``"hier_ring"`` with ``ici_group=1`` bit-equal to ``ring``; on
             rank 0 one ring visit's K2 Grams and K1 on them against their
             plain versions (TOL); ``serve_topk_sharded`` at the serve
             shape (rank 128, f32, B = 256, K = 100, tile_m 2048), its
             table placed on the ranks once, bit-equal to one-rank K4 on
             the card.  The ranks spawn while the host generates and
             builds, and one untimed ring iteration warms them before the
             timed runs.  Per-rank K1/K2/K3/K4 launches
             (zeroed before, read after; the kernels line's ``shards``),
             s/iter per exchange, the staged bytes a half-iteration and the
             card's idle share over one profiled iteration of both ranks,
             under the label "2 ranks on one card, exchanges staged through
             host";
6. implicit — implicit-feedback training at the repo's implicit
             configuration (``bench.py`` ``ials_row``/``ialspp_row``: the
             ML-25M shape, 162,541 users x 59,047 movies x 25,000,095
             synthetic interactions, seed 0, rank 128, lambda 0.1, alpha 40,
             nothing cut), 3 iterations each from one fixed u0 through
             ``train_ials`` (one call per iteration, each warm-started from
             the last): (a) iALS, tiled (accum movie half: K2 weighted + K1
             matrix mode; dense-stream user half: K3 weighted + matrix),
             49,152-entry chunks; (b) iALS, bucketed (chunk_elems 524,288),
             every width class through K6; (c) iALS++, bucketed, b = 32, one
             sweep (K5 + K1 at k = 32); (d) (a) split, 2 iterations (the
             accum half's blocked Schur solve: ``gauss_solve_multi`` +
             ``gauss_solve`` on 59,047 movie systems; the dense half: the
             split Gram weighted + K1 matrix mode); (e) iALS on the tiled
             stream mode (``dense_stream=False``; the user half through K6
             with multi-tile segments and the carry), 2 iterations fused
             and 1 split (K2 weighted + K1 matrix mode).  Launch counts
             zeroed before and read after each run; the implicit objective
             (without the dense U·Mᵀ) must fall every iteration; (d) and (e)
             must agree with (a) on the first movie half's factors and on the
             scores of each iteration; (a)'s and (b)'s first movie halves
             solve the same normal equations as a float64 solve (checked on
             the five widest and five random movies) and must agree with it
             and with each other, and their scores on the observed entries
             must agree every iteration; then K5, K6 and K1-K3 in their
             implicit modes against their plain versions on a middle bucket
             / chunk (K6 launched twice: bit-equal), with times and bounds,
             per-half and per-width-class times (summed over the classes;
             the head class, one 1.2M-row movie, reported apart) and
             a profiler pass over one iteration of each run;
             ``gauss_solve_multi`` against its plain version and
             ``torch.linalg.solve`` at the Schur shape (k = 64, m = 65, A₁₁
             read in place from the [E, 128, 128] batch), then
             ``gauss_solve`` on the Schur complement S it leads to (59,047
             systems, k = 64) against its plain version and
             ``torch.linalg.solve``, each launched twice (bit-equal), and
             the error of x₂ against a float64 solve of the full S and of
             the whole system, beside the plain Gauss-Jordan's and the
             symmetrized (S + Sᵀ)/2's;
6b. gather_ml25m — (a), (b) and (e) with ``in_kernel_gather=False`` for one
             iteration each from the same u0 on the implicit phase's
             datasets (rows 5 and 7; ``gram_solve_tiles`` per width class;
             rows 5 and 6), launch counts as in 4c, each held to its
             gather-on run's first iteration (first movie half and scores,
             TOL; bit-equality reported; (b) profiled over one more
             iteration: row 6's device time an iteration); ``gram_solve_tiles``
             on (b)'s middle width class against its plain version and K6;
6c. split_ml25m — (b) and (c) with ``fused_epilogue=False`` for one
             iteration each from the same u0 on the implicit phase's
             bucketed dataset: (b) each width class's (A, b) through K2, K1
             matrix mode solving it (K6 and ``gram_solve_tiles`` must launch
             0 times); (c) the sweeps' b x b solves through the ridge add
             and ``gauss_solve`` (K1 0 times); each held to its fused run's
             first iteration (first movie half and scores, TOL), with its
             s/iter beside the fused run's and a profiler pass over one
             split iteration beside the fused one's;
6d. implicit_r256 — one warm-started ``train_ials`` call of (a) at rank
             256 on the implicit phase's tiled blocks (weighted K2 and the
             split dense Gram in matrix mode, YᵀY + λI added in place before
             ``batched_spd_solve``): launch counts, the objective must fall,
             the first movie half against ``first_half_reference`` on the
             five widest and five random movies;
6f. quant_ml25m — iALS (b) with an int8 gather table, one ``train_ials``
             call from the implicit phase's u0: K6 launched, the objective
             falls below the start's, beside (b)'s float32 first iteration;
             then (b)'s gather-off half-steps (K5 + row 6 per width class)
             for one iteration from u0, walked whole (one piece a
             class) and in the blocks' ``chunk_rows`` pieces: the two
             bit-equal, the peak device memory of each, the largest K5
             stream of each;
6e. segment_ml25m — one warm-started ``train_ials`` call from the implicit
             phase's u0 on the segment layout of its ML-25M ratings (rank
             128, K1 in matrix mode once a chunk): K1's launch count equals
             the chunks, the objective falls, and the first movie half is
             held to ``first_half_reference`` (float64) on the five widest
             and five random movies at TOL "first_half_factors"; s/iter,
             device time and idle share, chunks, Ec, peak memory, build s;
6g. pipeline_ml25m — as 4g on the implicit phase's datasets from its u0:
             iALS (a) tiled, (b) bucketed, (c) iALS++ bucketed (b = 32),
             (e) the stream mode, 3 iterations each, on and off;
6h. resilience_ml25m — one iALS (b) call (2 iterations, the sentinel every
             iteration) from the implicit phase's u0 with NaN rows before
             iteration 1 against its fault-free call: one trip, one
             rollback, the factors bit-equal;
7. small   — ``train_als`` on small padded, tiled (dense stream, and the
             stream mode fused and split) and bucketed datasets (ALS and
             ALS++) and ``train_ials`` on small tiled and bucketed ones (iALS
             and iALS++), and the gather-off dense stream and stream modes
             (fused and split) and iALS bucketed, kernels on the card
             against the plain versions on the CPU;
8. cli     — the CLI verbs as subprocesses, the independent ones at once:
             ``python -m cfk_tpu_torch train --layout auto
             --checkpoint-dir`` on a small Netflix-format file (padded is
             chosen), then ``recommend``, ``predict``, ``evaluate`` on
             predict's CSV (the train MSE again) and ``serve`` (every
             request answered); ``train --layout padded --rank 256`` and
             ``train --layout segment`` on the card and the CPU (MSEs
             within 1e-3 of each other); ``train --dataset-cache DIR``
             twice on the card (the second run hits the cache and
             checkpoints bit-equal factors); ``train --profile-dir D
             --trace-dir D --metrics-jsonl F`` on the card (the Chrome
             traces parse, ``validate_span_tree`` accepts the host trace,
             the JSONL lines parse); ``train --checkpoint-dir
             --checkpoint-every 100 --keep-last-n 2`` for 3,000 iterations
             sent SIGTERM after its first step: exit 0 within 30 s with a
             final step committed, the same command again resumes to the
             end (every kept step verifies); ``stream --produce-csv``
             then ``stream`` until it drains, the same command again
             (resumes, no new batch), ``stream --follow`` sent SIGTERM
             after its first commit (exit 0, cursor committed; the re-run
             ends crc-equal to the drained run); ``train
             --checkpoint-journal DIR --journal-partitions 2`` then
             ``recommend --checkpoint-journal DIR`` (the same output as the
             ``--checkpoint-dir`` chain's); ``python -m
             cfk_tpu_torch.scripts.chaos_lab --device cuda`` on the padded,
             tiled, bucketed and segment layouts (seventeen of its
             scenarios — the stream ones on each layout, ``quantized_table``,
             ``stream_poison_batch`` and the five serving ones once — each
             fired, detected, recovered) beside its ``worker_kill`` (two
             ranks on the card, one SIGKILLed; the restart crc-equal);
             ``train --shards 2 --exchange ring`` against one-rank
             ``train`` (MSE within 1e-4) and ``run 2 …`` against ``run 1
             …``, at once; ``serve --replicas 2`` (the
             in-memory load generator: every request answered); the broker
             chain: ``broker --port 0 --data-dir``, ``topics create``,
             ``produce --append``, ``train --data tcp://…/ratings
             --checkpoint-journal tcp://…`` (the journal chain's MSE),
             ``stream --produce-csv`` and ``stream --updates tcp://…``
             (crc-equal to the FileBroker stream chain), ``topics list``,
             and ``serve --broker tcp://… --replicas 2`` in the
             background, whose fleet answers a client's 8 requests and
             exits 0 on SIGINT; then
             ``train --implicit --algorithm ials++ --eval-ranking 10`` on a
             small planted MovieLens-format file, whose Recall@10 and MPR
             on the card must equal the CPU run's.

``python3 chip_smoke.py --phases segment,resilience,cli`` runs a subset (a
development aid; the build, and the main or implicit phase a chosen phase
needs, run too); it ends with ``{"ok": false, "subset": [...],
"subset_passed": true}`` in place of the full run's last line.
The build phase keeps every library's ptxas report (registers, shared
memory, spills) in the JSON report.  Prints the card's name and power
limit, a ``{"kernels": [...]}`` line (K1's row also carries its E = 1 and
E = 203 times and bounds), and,
as its last line, ``{"ok": true, "device": {...}}``.  Exits non-zero without
that line if there is no CUDA device or any phase fails.  Details go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import time
import traceback
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12  # H100 SXM FP32 outside the tensor cores
# H100 SXM dense bf16 on the tensor cores: the rate for products of bf16
# operands (K4's bf16 table; the Gram kernels' bf16 rows, which still run
# FP32 FMAs), every other operation held to FP32.
BF16_TC_FLOPS_PER_S = 989e12
NETFLIX = dict(num_users=480_189, num_movies=17_770, nnz=100_480_507)
RANK, LAM, ITERS = 64, 0.05, 3
# Kernel vs plain, max |difference| over max |plain|: float32 on both sides
# in different summation orders.  Gram sums 1e-4; solves 1e-3 (the Cholesky
# solves of systems with condition numbers up to ~1e3 amplify the rounding).
# K4: scores within 1e-5 of the largest |score|, ids equal except at
# near-ties (``compare_topk``) — float32 dot products in another order.
# K5: one load and at most one float32 multiply per element, so kernel and
# plain version are bit-equal (tolerance 0).  K6: as K3.  The implicit runs'
# first movie half solves YᵀY + Σ α·r·f fᵀ + λI from the same u0 in (a), in
# (b) and in float64 on the host's copy (for the widest and some random
# movies): float32 sums of up to a million rows, whose error the condition
# number (~4e2) amplifies, so factors agree within 1e-3 of the row's
# largest |factor|.  Every later half solves against its own run's factors,
# so (a) and (b) are then held by what they predict: the scores u·m on the
# observed entries agree within 1e-3 of the largest |score|.  The same two
# tolerances hold the split and stream runs (d), (e) to (a).  The split
# Gram: as K2 (1e-4).  Rows 11 and 12 (K1's Cholesky without the ridge)
# against their plain version, the reference's Gauss-Jordan elimination: as
# K1 (1e-3).  The split explicit run's first movie half solves the fused
# run's normal equations with the same float32 ridge add and the same
# Cholesky: 1e-3 of the largest |factor|, as K1, and bit-equal (checked).
# On the Schur complement, x₂ against a float64 solve of the full S: at
# most 4 times the plain Gauss-Jordan's error plus 4 float32 ulps of
# max|x₂| (as tests/test_torch_spd_solve.py: an order that rounds no
# worse).
# The stream kernels (rows 4-7) against their plain versions: as their
# gather siblings (Gram sums 1e-4, solves 1e-3).  The gather-off runs'
# first halves against the gather-on ones from the same start: the same
# float32 operations in the same order, so bit-equal by design (reported);
# held, as every cross-route agreement here, to the split tolerance.
# The block-inverse solve (binv_solve_reg) against its plain recursion and
# K1 on the main path's movie Grams and on the implicit-shaped matrix-mode
# batch, and binv_inv against its plain recursion: as K1 (1e-3).  On the
# prototype's own inputs (rank-k/8 Grams held up by λ·n, condition numbers
# up to 4.5e3 at k = 128) the float32 algorithm itself — an explicit
# inverse and one float32 refinement step — ends 2.6e-3 of max|x| from a
# float64 solve (its plain version, on the CPU and on the card; K1's
# Cholesky 6e-5), so both routes are held there to the float64 solve at
# 1e-2 ("binv_float64") and to their plain version at 1e-3 as everywhere
# else.  Two controls show that 1e-3 has teeth there: the plain solve
# without its refinement step ends 2.5e-2 of max|x| from the refined one
# (checked above 1e-3 on every run), and with its inverse rounded to
# bfloat16 5.7e-3 (the CPU, the same inputs); the card's TF32 products are
# reported beside them.
# K4 with an f32 or int8 table at the serve configurations: exact (values
# and ids, tolerance 0) — an int8 row is dequantized code by code before the
# f32 products, so both kinds sum Σ (code·scale)·u in the plain version's
# order (bf16, the tensor cores' sums, stays at "topk_scores").
# Above rank 128 (phase 4d): the four split Gram kernels against their plain
# versions at 1e-5 ("gram_r256"); the first movie half against a float64
# solve of the same float32 Grams at 1e-4 of max|x| ("float64_r256": the
# float32 Cholesky alone).  Implicit (a)'s first movie half at rank 256
# against ``first_half_reference`` (Grams and solve in float64) stays at
# "first_half_factors" (1e-3): on a small ML-25M-shaped case (3,000 users,
# 400 movies, 60,000 interactions, U(0, 1) u0, α 40) the JAX package's own
# float32 route ends 3e-4–6.5e-4 from that reference and the port's CPU
# route 2e-5–1.3e-4 — the float32 Gram sums of up to a million rows,
# amplified by the systems' condition numbers, which grow with k.
TOL = {"reg_solve": 1e-3, "gram_gather": 1e-4, "gram_solve_dense": 1e-3,
       "topk_scores": 1e-5, "gather_rows": 0.0, "gram_solve_gather": 1e-3,
       "gram_tiles_dense_gather": 1e-4, "gauss_solve": 1e-3,
       "gauss_solve_multi": 1e-3, "gram_tiles": 1e-4,
       "gram_solve_tiles": 1e-3, "gram_tiles_dense": 1e-4,
       "gram_solve_tiles_dense": 1e-3, "split_first_half": 1e-3,
       "first_half_factors": 1e-3, "scores": 1e-3,
       "binv_solve_reg": 1e-3, "binv_inv": 1e-3, "binv_float64": 1e-2,
       "reg_solve_float64": 2 * 6.17e-5, "topk_exact": 0.0,
       "gram_r256": 1e-5, "float64_r256": 1e-4,
       "segment_first_half": 1e-3}
# K1's relative x error against float64 on the binv phase's inputs (k = 128,
# condition numbers to 4.5e3) when it factored one column at a time
# (NVIDIA H100 80GB HBM3, 700 W): the blocked solve is held to twice it
# ("reg_solve_float64"), an order that rounds no worse.
K1_FLOAT64_ERR_COLUMN_ORDER = 6.17e-5
REPLACES = {
    "reg_solve": "cfk_tpu/ops/pallas/solve_kernel.py:287",
    "gram_gather": "cfk_tpu/ops/pallas/gram_kernel.py:1422",
    "gram_solve_dense": "cfk_tpu/ops/pallas/gram_kernel.py:1764",
    "topk_scores": "cfk_tpu/serving/topk_kernel.py:215",
    "gather_rows": "cfk_tpu/ops/pallas/gram_kernel.py:1929",
    "gram_solve_gather": "cfk_tpu/ops/pallas/gram_kernel.py:1526",
    "gram_tiles_dense_gather": "cfk_tpu/ops/pallas/gram_kernel.py:1653",
    "gauss_solve": "cfk_tpu/ops/pallas/solve_kernel.py:529",
    "gauss_solve_multi": "cfk_tpu/ops/pallas/solve_kernel.py:495",
    "gram_tiles_dense": "cfk_tpu/ops/pallas/gram_kernel.py:310",
    "gram_tiles": "cfk_tpu/ops/pallas/gram_kernel.py:427",
    "gram_solve_tiles": "cfk_tpu/ops/pallas/gram_kernel.py:787",
    "gram_solve_tiles_dense": "cfk_tpu/ops/pallas/gram_kernel.py:920",
    "binv_solve_reg": "scripts/exp_binv.py:154",
    "binv_inv": "scripts/exp_binv.py:271",
    # K4's route for k_top above 1,024: three more launches of its source
    "topk_scores_large_k": "cfk_tpu/serving/topk_kernel.py:215",
}
SOURCES = {"topk_scores_large_k": "cfk_tpu_torch/csrc/topk_scores.cu"}
# Fields of the kernels line beyond the contract's: K1 below one wave; the
# split Grams at rank 256 (phase 4d, ``k256``: its launches, ms, bound);
# rows 2-10 on quantized tables (phase 4f: ms and bound at a bf16 and an
# int8 table).
QUANT_FIELDS = ("ms_bf16", "bound_ms_bf16", "bound_by_bf16", "ms_int8",
                "bound_ms_int8", "bound_by_int8")
LINE_EXTRA = {"gauss_solve": ("ms_schur", "bound_ms_schur",
                              "library_ms_schur"),
              **{name: QUANT_FIELDS for name in (
                  "gram_solve_dense", "gram_solve_tiles",
                  "gram_solve_tiles_dense", "gram_solve_gather",
                  "gather_rows")},
              **{name: ("k256",) + QUANT_FIELDS for name in (
                  "gram_tiles", "gram_tiles_dense",
                  "gram_tiles_dense_gather")},
              "gram_gather": ("k256",) + QUANT_FIELDS + ("segment",),
              "topk_scores": ("configs",),
              "topk_scores_large_k": ("configs",),
              "binv_solve_reg": ("ctas_per_sm", "ms_k64", "bound_ms_k64",
                                 "library_ms_k64", "ms_matrix",
                                 "bound_ms_matrix", "library_ms_matrix"),
              "binv_inv": ("ctas_per_sm", "ms_n16", "bound_ms_n16",
                           "library_ms_n16"),
              "reg_solve": ("ms_k128_e1", "bound_ms_k128_e1", "ms_k128_e203",
                            "bound_ms_k128_e203", "launches_segment",
                            "launches_segment_implicit", "foldin",
                            "foldin_padded")}
# The stream phase's launches and device ms of the kernels fold-in reaches.
LINE_EXTRA["gram_gather"] += ("foldin",)
LINE_EXTRA["topk_scores"] += ("foldin",)
# The fleet phase's K4 launches: the wrapper's own counts on every thread.
LINE_EXTRA["topk_scores"] += ("fleet_launches",)
# The shards phase's launches on each rank (per process: never summed).
for _name in ("reg_solve", "gram_gather", "gram_solve_dense", "topk_scores"):
    LINE_EXTRA[_name] += ("shards",)
# scripts/exp_binv.py's defaults (main :187-212): k = 128, --e 334·16
# rounded down to a multiple of the 128-system tile, λ = 0.05; the main
# path's movie Grams at k = 64; matrix mode at the ML-25M movie count.
BINV = dict(k=128, e=(334 * 16 // 128) * 128, lam=0.05, matrix_e=59_047)
# The serve phase's batch above the two-launch K4 route's k_top cap (1,024):
# B = 256 of the serve pool through ServeEngine.topk, f32 and int8 tables.
LARGE_K = dict(k=2_000, batch=256, table_dtypes=("float32", "int8"))
SPLIT_ITERS = 2
# Phase 4d: explicit ALS-WR at rank 256 on the main phase's Netflix blocks,
# default knobs (every chunk takes the split schedule above 128), then the
# same with the gather off; and one call of implicit (a) at rank 256 on the
# implicit phase's ML-25M blocks.  Nothing is cut.
R256 = dict(rank=256, iterations=2, gather_off_iterations=1)
GATHER_OFF_ITERS = 2  # the gather-off runs, fused and split
# Phase 4e: the segment layout of the main phase's ratings at the CLI's
# default chunk budget (2^20 cells: 16,384-rating chunks, the JAX package's
# budget for its [C, k, k] segment-sum Gram); 2 iterations; the profiler
# traces a steady window of
# the first 1,024 chunks of each half (the whole iteration's ≈ 250,000
# launches take the profiler about a minute to aggregate).
SEGMENT = dict(chunk_elems=1 << 20, iterations=2, profile_chunks=1024)
# Phase 4f: the quantized runs on the main phase's blocks (2 iterations
# each) and the RMSE ratio each is held to against the float32 run's (the
# JAX package's contract, tests/test_quant_table.py:185-200).
QUANT = dict(iterations=2, rmse_ratio={"table_bfloat16": 1.01,
                                       "table_int8": 1.10,
                                       "dtype_bfloat16": 1.01})
# The pipeline phases: each run with overlap on and every route captured
# (``capture=True``: iteration 1 eager, the rest replays of one captured
# iteration) and off (the serial loop) from the
# same start, 3 iterations at the Netflix and ML-25M shapes; the segment
# and rank-256 cases (2 iterations) ride in their own phases.
PIPELINE = dict(iterations=3)
# Phase 4h: resilience at the Netflix shape on the main phase's blocks, 3
# iterations (4 for the preemption case); the captured-route trip's ladder
# may climb past the default 4 rungs (λ from 0: 1e-4, split, 1e-3 and gj,
# then ×10 a rung).
RESILIENCE = dict(iterations=3, max_recoveries=8)
# Phase 4i: the stream phase's log (16,384 updates, 64 of them by new
# users, 4 partitions), its micro-batches (256 records a partition), the
# crashed run's batches, the freshness check's users and K, and the padded
# fold-in's synthetic set (below the padded layout's 2M-rating scale) and
# touched users.
STREAM = dict(updates=16_384, new_users=64, partitions=4, batch_records=256,
              seed=5, crash_after=8, serve_users=64, k=100,
              padded_shape=dict(num_users=20_000, num_movies=2_000,
                                nnz=1_000_000), padded_users=256)
# Phase 8: the chaos lab's layouts on the card; the CLI's preemption run
# (SIGTERM arrives after its first committed step, every 100 iterations)
# and the grace window its exit must fit in.
LAYOUTS_CHAOS = ("padded", "tiled", "bucketed", "segment")
CLI_PREEMPT = dict(iterations=3000, every=100, grace_s=30.0)
# The shards phase: the ML-25M ratings at the main path's rank and λ, two
# ranks sharing the card; the serve shape for the sharded top-K.
SHARDS = dict(ranks=2, iterations=2, chunk_elems=1 << 20,
              ring_accum_max=1 << 17, budget_s=90.0)
SHARDS_LABEL = "2 ranks on one card, exchanges staged through host"
# The CLI phase's subprocesses run at once on the machine's few cores: two
# PyTorch threads each, so the CPU runs do not oversubscribe them.
CLI_ENV = dict(os.environ, OMP_NUM_THREADS="2")
# bench.py's implicit rows (bench.py:448-503): the ML-25M shape at rank 128.
ML25M = dict(num_users=162_541, num_movies=59_047, nnz=25_000_095)
IMPLICIT = dict(rank=128, lam=0.1, alpha=40.0, iterations=3,
                tiled_chunk=49_152, bucketed_chunk=524_288, block_size=32,
                split_iterations=2, stream_iterations=2)
# bench.py --serve's configuration (bench.py:3236-3262).
SERVE = dict(num_users=162_541, num_movies=59_047, nnz=25_000_095,
             rank=128, k=100, tile_m=2048, requests=256, clusters=1024)
# The fleet phase at the serve shape: two replicas over the port's broker,
# 8 waves of 1,024 user-keyed requests at 70% of the capacity a closed
# burst of 2,048 measures first; 8 commits of 1,024 touched users with the
# delta frame at offset 3 hidden; replica 0 killed after wave 4; the retrain
# epoch announced before wave 5; the card's timeline profiled over wave 2.
FLEET = dict(replicas=2, waves=8, wave_requests=1024, burst=2048, load=0.7,
             commits=8, touched=1024, hidden_offset=3, kill_after_wave=4,
             epoch_before_wave=5, max_batch=256, profile_wave=2,
             budget_s=60.0)
SERVE_CONFIGS = (("exact", "float32", 16), ("exact", "float32", 64),
                 ("exact", "float32", 256), ("exact", "bfloat16", 256),
                 ("exact", "int8", 256), ("two_stage", "float32", 256))


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def profiled_wave(run) -> tuple[dict, dict]:
    """``run()`` (one fleet wave) under ``device_timeline``: its result and
    the card's timeline over the wave's wall time (every replica thread's
    kernels; ``kernels`` 0 when CUPTI missed the session).  A profiler that
    fails before the wave ran leaves the wave to run unprofiled."""
    box: list = []
    timeline = device_timeline(lambda: box.append(run()), 1)
    return (box[0] if box else run()), timeline


def fleet_wave(client, users, rate_qps: float, k: int,
               timeout_s: float = 60.0) -> dict:
    """One open-loop wave through a fleet: request i is sent at ``i /
    rate_qps`` (latency counted from that scheduled time); a retriable
    rejection is re-sent at once under a new req_id; a request still
    unanswered ``timeout_s`` after the last send is a timeout.  Returns the
    final (user, response) pairs in send order, their latencies, the wall
    s, the rejections, the re-sends and the timeouts."""
    import numpy as np

    users = np.asarray(users, np.int64)
    sched: dict[int, tuple[int, float]] = {}  # req_id -> (index, scheduled)
    final: dict[int, object] = {}
    lat: dict[int, float] = {}
    rejections = resent = 0

    def drain():
        nonlocal rejections, resent
        for resp in client.poll_responses():
            got = sched.pop(resp.req_id, None)
            if got is None:
                continue  # a duplicate of an answered request
            i, t = got
            if resp.retriable:
                rejections += 1
                sched[client.request(int(users[i]), k)] = (i, t)
                client.flush()
                resent += 1
                continue
            final[i] = resp
            lat[i] = (time.perf_counter() - t) * 1e3

    t0 = time.perf_counter()
    for i, user in enumerate(users):
        t = t0 + i / rate_qps
        while time.perf_counter() < t:
            drain()
            time.sleep(min(max(t - time.perf_counter(), 0.0), 0.0005))
        sched[client.request(int(user), k)] = (i, t)
        client.flush()
    deadline = time.perf_counter() + timeout_s
    while sched and time.perf_counter() < deadline:
        drain()
        if sched:
            time.sleep(0.0005)
    wall = time.perf_counter() - t0
    order = sorted(final)
    return dict(pairs=[(int(users[i]), final[i]) for i in order],
                lat_ms=[lat[i] for i in order], wall_s=wall,
                rejections=rejections, resent=resent, timeouts=len(sched),
                requests=int(users.shape[0]))


def time_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn`` over ``reps`` calls after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


PROFILE_ATTEMPTS = 4  # fresh profiler sessions before a kernel counts unseen


def kernels_ms(fn, reps: int, *kernels: str) -> dict[str, float]:
    """Device ms per call of the kernels whose names hold each of
    ``kernels``, from one torch.profiler session over ``reps`` calls after
    one warm-up: for launches so short that back-to-back calls would time
    the host's launch path, not the card.  A session that records none of
    a kernel's launches (one on the H100 once recorded no pass-2 launch of
    K4, which every call makes, right after a session that recorded its
    pass 1) is traced again in a fresh one, up to ``PROFILE_ATTEMPTS``
    sessions; a kernel no session sees raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = prof.key_averages()
        us = {k: sum(e.self_device_time_total for e in rows if k in e.key)
              for k in kernels}
        missed = [k for k, v in us.items() if v <= 0]
        if not missed:
            return {k: v / 1e3 / reps for k, v in us.items()}
        log(f"profiler session {attempt}/{PROFILE_ATTEMPTS} recorded no "
            f"{', '.join(missed)}")
        time.sleep(0.5)
    raise RuntimeError(f"the profiler saw no {', '.join(missed)} on the card "
                       f"in {PROFILE_ATTEMPTS} sessions")


def kernel_ms(fn, reps: int, kernel: str) -> float:
    """``kernels_ms`` of one kernel."""
    return kernels_ms(fn, reps, kernel)[kernel]


def bound(bytes_moved: float, flops: float,
          flops_per_s: float = FP32_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_usage(text: str) -> list[dict]:
    """Each function of an ``nvcc -Xptxas=-v`` report (kernels and the
    device functions they call): its (mangled) name, stack frame and spill
    bytes, and a kernel's registers."""
    out = []
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            out.append(dict(function=m.group(1)))
        elif out and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes "
                                     r"spill stores, (\d+) bytes spill "
                                     r"loads", line)):
            out[-1].update(stack_frame=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        elif out and (m := re.search(r"Used (\d+) registers", line)):
            out[-1]["registers"] = int(m.group(1))
    return out


def rel_err(got, want) -> tuple[float, float]:
    diff = float((got - want).abs().max())
    return diff, diff / max(float(want.abs().max()), 1e-30)


def reg_solve_work(e: int, k: int) -> tuple[float, float]:
    """(bytes, flops) of K1 on e systems: read A's lower triangle (A is
    symmetric: the solve needs no more), b and the counts once, write x;
    Cholesky k³/3 + two triangular solves 2k² + ridge k."""
    return (4 * e * (k * (k + 1) // 2 + 2 * k + 1),
            e * (k ** 3 / 3 + 2 * k * k + k))


def gram_gather_work(table, args) -> tuple[float, float, dict]:
    """(bytes, flops, counts) of K2 on one chunk: the distinct table rows the
    live entries reference, nb/wt/rt/seg once, (A, b) written once; k² + 3k
    flops per live row — what the function needs: the symmetric Gram's
    k(k+1)/2 multiply-adds and b's k (the kernel computes the full Gram)."""
    import torch

    f, k = table.shape
    nb = args["nb"].long()
    live = (nb < f) & (args["wt"] != 0)
    n_live = int(live.sum())
    rows = int(torch.unique(nb[live]).numel())
    s = args["num_segments"]
    return (4 * (rows * k + 3 * nb.numel() + args["seg"].numel()
                 + s * (k * k + k)),
            n_live * (k * k + 3 * k),
            dict(chunk_rows=nb.numel(), live_rows=n_live,
                 distinct_table_rows=rows, segments=s))


def gram_solve_dense_work(table, args) -> tuple[float, float, dict]:
    """(bytes, flops, counts) of K3 on one chunk: the distinct table rows,
    nb/rt/meta/reg once, x and the carry pair; k² + 3k flops per live row
    inside a tile window (symmetric Gram + b, as for K2) plus k³/3 + 2k² + k
    per segment solve."""
    import torch

    f, k = table.shape
    t, nt, ng, bg = (args[n] for n in ("tile_rows", "num_tiles",
                                         "num_groups", "block_rows"))
    meta = args["meta"].long()
    lo, hi = meta[ng + nt:ng + 2 * nt], meta[ng + 2 * nt:ng + 3 * nt]
    absrow = meta[:ng].repeat_interleave(nt // ng) * bg + meta[ng:ng + nt]
    r = torch.arange(t, device=meta.device)
    in_win = (r[None, :] >= lo[:, None]) & (r[None, :] < hi[:, None])
    nb = args["nb"].long()
    n_win = int((nb[(absrow[:, None] + r[None, :])[in_win]] < f).sum())
    rows = int(torch.unique(nb[nb < f]).numel())
    s = args["num_segments"]
    return (4 * (rows * k + nb.numel() + nt * t + meta.numel() + s
                 + s * k + 2 * (k * k + k)),
            n_win * (k * k + 3 * k) + s * (k ** 3 / 3 + 2 * k * k + k),
            dict(chunk_rows=nb.numel(), window_rows=n_win,
                 distinct_table_rows=rows, segments=s))


def gram_tiles_dense_gather_work(table, args) -> tuple[float, float, dict]:
    """(bytes, flops, counts) of the split dense Gram on one chunk: as K3's
    Gram (the distinct table rows, nb/rt/meta once, k² + 3k flops per live
    window row), with the S·(k² + k) floats of (A, b) written in place of
    K3's ridge counts, x and carry row, and no solves."""
    nbytes, _, counts = gram_solve_dense_work(table, args)
    k = table.shape[1]
    s = args["num_segments"]
    nbytes += 4 * (s * (k * k + k) - s - s * k - (k * k + k))
    return nbytes, counts["window_rows"] * (k * k + 3 * k), counts


def with_plan(args: dict, blk: dict, c: int) -> dict:
    """Chunk c's kernel operands with the work-unit plan the device upload
    staged for it, as the half-steps pass it."""
    from cfk_tpu_torch.ops.kernels.gram_units import chunk_plan

    return dict(args, units=chunk_plan(blk, c))


def class_plan(rows: int, width: int, dev):
    """A width class's work-unit plan (one tile per entity), as the
    bucketed device upload stages it."""
    import torch

    from cfk_tpu_torch.ops.kernels.gram_units import (
        chunk_plan, derive_tile_units, stage_plans)

    seg = torch.arange(rows, dtype=torch.int32)
    return chunk_plan(stage_plans(derive_tile_units(seg[None], width, rows),
                                  dev), 0)


def largest_tile_segments(blk, statics) -> "np.ndarray":
    """Rows of each accum chunk's largest real segment (its tiles x T; the
    trash segment Ec left out)."""
    import numpy as np
    import torch

    from cfk_tpu_torch.ops.tiled import accum_chunk

    e_c, t = statics[4], statics[2]
    return np.array([
        int(torch.bincount(accum_chunk(blk, statics, c)["seg"],
                           minlength=e_c + 1)[:e_c].max()) * t
        for c in range(statics[0])])


def largest_window_segments(blk, statics) -> "np.ndarray":
    """Window rows of each dense chunk's largest segment."""
    import numpy as np
    import torch

    from cfk_tpu_torch.ops.tiled import dense_chunk

    _, _, _, _, nt, ng, _ = statics
    out = []
    for c in range(statics[0]):
        meta = dense_chunk(blk, statics, c)["meta"].long()
        win = meta[ng + 2 * nt:ng + 3 * nt] - meta[ng + nt:ng + 2 * nt]
        out.append(int(torch.bincount(meta[ng + 3 * nt:],
                                      weights=win.double()).max()))
    return np.array(out)


def gauss_work(e: int, k: int, m: int) -> tuple[float, float]:
    """(bytes, flops) of e k x k SPD systems with m right-hand sides: A's
    lower triangle (all the Cholesky needs, as for K1) and B read once, X
    written once; the least work is a Cholesky (k³/3) and its triangular
    solves (2k² per right-hand side)."""
    return (4 * e * (k * (k + 1) // 2 + 2 * k * m),
            e * (k ** 3 / 3 + 2 * k * k * m))


def binv_macs(n: int) -> float:
    """Multiply-adds of the block recursion inverting one n x n system:
    five m x m x m products a Schur level (P, S, P·S⁻¹, B11, B21) and a
    Gauss-Jordan leaf's n steps over n rows of 2n columns."""
    if n <= 16:
        return 2.0 * n ** 3
    m = n // 2
    return 5.0 * m ** 3 + 2 * binv_macs(m)


def binv_solve_work(e: int, k: int, reg_mode: str) -> tuple[float, float]:
    """(bytes, flops) of binv_solve_reg on e systems: A, b and the ridge
    (counts, or one [k,k] matrix) read once, x written once; the recursion
    and the three matrix-vector products (x = Bb, r = b − A'x, x + Br)."""
    reg = 4 * e if reg_mode == "diag" else 4 * k * k
    return (4 * e * (k * k + 2 * k) + reg,
            2.0 * e * (binv_macs(k) + 3 * k * k))


def binv_inv_work(e: int, n: int) -> tuple[float, float]:
    """(bytes, flops) of binv_inv on e systems: A read once, A⁻¹ written
    once; the recursion's multiply-adds."""
    return 8.0 * e * n * n, 2.0 * e * binv_macs(n)


def topk_scores_work(args, kw, n: int) -> tuple[float, float, dict]:
    """(bytes, flops, counts) of K4 on one batch of ``n`` real users: only
    the live table rows (global id ``row_offset + row`` below ``num_movies``
    — padding rows cannot change the result) at the table's row bytes
    (``serve_batch_cost``: the int8 scale included), the [n, k] batch in, the
    [n, K] result out and the batch's real seen entries (in-tile columns
    below ``tile_m``) once each; 2·n·rows·k flops."""
    from cfk_tpu_torch.utils.roofline import serve_batch_cost

    _, table, _, seen = args
    m_pad, rank = table.shape
    live = min(max(kw["num_movies"] - kw.get("row_offset", 0), 0), m_pad)
    td = {"torch.float32": "float32", "torch.bfloat16": "bfloat16",
          "torch.int8": "int8"}[str(table.dtype)]
    cost = serve_batch_cost(live, rank, n, kw["k_top"], table_dtype=td,
                            m_pad=live)
    seen_cells = 0 if seen is None else int((seen[:, :n] < kw["tile_m"]).sum())
    return (cost.hbm_bytes + 4 * seen_cells, cost.model_flops,
            dict(live_rows=live, padded_rows=m_pad, seen_cells=seen_cells))


def gather_rows_work(table, nb, wt) -> tuple[float, float, dict]:
    """(bytes, flops, counts) of K5: the distinct table rows the live
    entries (index inside the table, weight not 0) reference, read once; nb
    and wt (8 B per entry); the [C, k] output written once; one multiply
    per element."""
    import torch

    f, k = table.shape
    c = nb.numel()
    idx = nb.long()
    live = (idx >= 0) & (idx < f) & (wt != 0)
    rows = int(torch.unique(idx[live]).numel())
    return (4 * rows * k + 8 * c + 4 * c * k, c * k,
            dict(entries=c, live_entries=int(live.sum()),
                 distinct_table_rows=rows))


def gram_solve_gather_work(table, args, reg_mode) -> tuple[float, float, dict]:
    """(bytes, flops, counts) of K6 on one call: the distinct table rows of
    the live entries, nb/wt/rt/seg and the ridge read once, x and the carry
    row written once; k² + 3k flops per live row (symmetric Gram + b) and
    k³/3 + 2k² + k per solve of a segment that owns a live row (a segment
    with none solves to 0 and needs no work)."""
    import torch

    f, k = table.shape
    nb = args["nb"].long()
    t = args["tile_rows"]
    live = (nb >= 0) & (nb < f) & (args["wt"] != 0)
    n_live = int(live.sum())
    rows = int(torch.unique(nb[live]).numel())
    s = args["num_segments"]
    nt = args["seg"].numel()
    solved = int(torch.unique(args["seg"].long()[
        torch.nonzero(live).flatten() // t]).numel())
    reg_elems = k * k if reg_mode == "matrix" else s
    return (4 * (rows * k + 3 * nb.numel() + nt + reg_elems + s * k
                 + k * k + k),
            n_live * (k * k + 3 * k) + solved * (k ** 3 / 3 + 2 * k * k + k),
            dict(entries=nb.numel(), live_entries=n_live,
                 distinct_table_rows=rows, segments=s, solved_segments=solved))


def stream_gram_work(g, args, reg_mode=None) -> tuple[float, float, dict]:
    """(bytes, flops, counts) of ``gram_tiles`` (``reg_mode`` None) or
    ``gram_solve_tiles`` on one chunk's stream: the [C, k] stream read once
    (C·k·4 contiguous bytes, its padding rows too: the function cannot
    tell them apart without reading them), rt and seg once, (A, b) — or x,
    the ridge and the carry row — once; k² + 3k flops per nonzero row
    (symmetric Gram + b) and, solving, k³/3 + 2k² + k per segment that owns
    one (as K2 and K6)."""
    import torch

    c, k = g.shape
    s, t = args["num_segments"], args["tile_rows"]
    nt = args["seg"].numel()
    live = (g != 0).any(1)
    n_live = int(live.sum())
    nbytes = 4 * (c * k + c + nt)
    flops = n_live * (k * k + 3 * k)
    counts = dict(entries=c, live_rows=n_live, segments=s)
    if reg_mode is None:
        nbytes += 4 * s * (k * k + k)
    else:
        solved = int(torch.unique(args["seg"].long()[
            torch.nonzero(live).flatten() // t]).numel())
        nbytes += 4 * ((k * k if reg_mode == "matrix" else s) + s * k
                       + k * k + k)
        flops += solved * (k ** 3 / 3 + 2 * k * k + k)
        counts["solved_segments"] = solved
    return nbytes, flops, counts


def stream_dense_work(g, args, reg_mode=None) -> tuple[float, float, dict]:
    """(bytes, flops, counts) of ``gram_tiles_dense`` (``reg_mode`` None) or
    ``gram_solve_tiles_dense`` on one dense chunk's stream: the [C, k]
    stream once (C·k·4 contiguous bytes), rt [NT·T] and meta once, (A, b) —
    or x, the ridge and the carry row — once; k² + 3k flops per nonzero
    row inside a tile window and, solving, k³/3 + 2k² + k per segment (as
    row 9 and K3)."""
    import torch

    c, k = g.shape
    t, nt, ng, bg = (args[n] for n in ("tile_rows", "num_tiles",
                                         "num_groups", "block_rows"))
    meta = args["meta"].long()
    lo, hi = meta[ng + nt:ng + 2 * nt], meta[ng + 2 * nt:ng + 3 * nt]
    absrow = meta[:ng].repeat_interleave(nt // ng) * bg + meta[ng:ng + nt]
    r = torch.arange(t, device=meta.device)
    in_win = (r[None, :] >= lo[:, None]) & (r[None, :] < hi[:, None])
    rows = (absrow[:, None] + r[None, :])[in_win]
    n_live = int((g[rows] != 0).any(1).sum())
    s = args["num_segments"]
    nbytes = 4 * (c * k + nt * t + meta.numel())
    flops = n_live * (k * k + 3 * k)
    if reg_mode is None:
        nbytes += 4 * s * (k * k + k)
    else:
        nbytes += 4 * ((k * k if reg_mode == "matrix" else s) + s * k
                       + k * k + k)
        flops += s * (k ** 3 / 3 + 2 * k * k + k)
    return nbytes, flops, dict(chunk_rows=c, window_rows=int(rows.numel()),
                               live_window_rows=n_live, segments=s)


def quant_bound(work, td: str, k: int, *, gram_rows: str | None = None,
                stream=None, out=None, weights: int = 0) -> tuple[float, str]:
    """(ms, "bytes" or "operations") of a work function's float32 count at
    table dtype ``td``.  Bytes: each distinct table row read as k elements
    of its size (2 B bf16, 1 B int8 — an int8 row's scale is already folded
    into the weights, so the kernel reads no scale); a stream read at its
    element size; K5's output (``out``) written at its; plus ``weights``
    float32 weights the float32 call does not read (the int8 dense chunk's
    folded scale stream).  Operations: the Gram's k² + 3k a row
    (``counts[gram_rows]`` rows) at the peak for the operands' type — the
    bf16 tensor cores for bf16 rows, FP32 otherwise (an int8 row times its
    float32 weight is float32) — and the rest (solves, K5's multiplies) at
    FP32."""
    import torch

    nbytes, flops, counts = work
    size = {"float32": 4, "bfloat16": 2, "int8": 1}[td]
    if stream is not None:
        nbytes -= stream.shape[0] * k * (4 - stream.element_size())
    else:
        nbytes -= counts["distinct_table_rows"] * k * (4 - size)
    if out is not None:
        nbytes -= counts["entries"] * k * (
            4 - torch.empty((), dtype=out).element_size())
    nbytes += 4 * weights
    gram = counts[gram_rows] * (k * k + 3 * k) if gram_rows else 0.0
    rate = BF16_TC_FLOPS_PER_S if td == "bfloat16" else FP32_FLOPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (gram / rate + (flops - gram) / FP32_FLOPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def implicit_objective(u, m, users, movies, rating, lam, alpha,
                       chunk=1 << 21) -> float:
    """Hu et al.'s objective Σ_all w·(p − s)² + λ(‖U‖² + ‖M‖²) without the
    dense U·Mᵀ: Σ_all s² = tr(UᵀU·MᵀM), plus Σ over the observed entries of
    (1 + α·r)(1 − s)² − s², all in float64 (the two large terms cancel)."""
    u, m = u.double(), m.double()
    total = float(((u.T @ u) * (m.T @ m)).sum())
    for lo in range(0, users.numel(), chunk):
        s = (u[users[lo:lo + chunk]] * m[movies[lo:lo + chunk]]).sum(1)
        c = 1.0 + alpha * rating[lo:lo + chunk].double()
        total += float((c * (1.0 - s) ** 2 - s ** 2).sum())
    return total + lam * float(u.pow(2).sum() + m.pow(2).sum())


def planted_implicit_csv(path, users=2000, movies=400, nnz=40_000,
                         seed=0) -> None:
    """A planted non-negative factor model as a MovieLens CSV: positive
    rank-4 factors, strengths u·m plus noise clipped above zero, and each
    (user, movie) cell interacted with probability ∝ (u·m)⁴, so that a
    ranking metric has structure to find."""
    import numpy as np

    rng = np.random.default_rng(seed)
    u = np.abs(rng.standard_normal((users, 4))) + 0.1
    m = np.abs(rng.standard_normal((movies, 4))) + 0.1
    s = u @ m.T
    p = (s ** 4).ravel()
    cell = rng.choice(users * movies, size=nnz, replace=False, p=p / p.sum())
    ui, mi = cell // movies, cell % movies
    r = np.maximum(s[ui, mi] + 0.05 * rng.standard_normal(nnz), 0.05)
    with open(path, "w") as f:
        f.write("userId,movieId,rating,timestamp\n")
        f.writelines(f"{a + 1},{b + 1},{x:.3f},0\n"
                     for a, b, x in zip(ui, mi, r))


def score_rel_err(a, b, users, movies, chunk=1 << 21) -> float:
    """max |u_a·m_a − u_b·m_b| over the observed (user, movie) entries,
    over the largest |u_b·m_b|."""
    diff = top = 0.0
    for lo in range(0, users.numel(), chunk):
        u_i, m_i = users[lo:lo + chunk], movies[lo:lo + chunk]
        sa = (a[0][u_i] * a[1][m_i]).sum(1)
        sb = (b[0][u_i] * b[1][m_i]).sum(1)
        diff = max(diff, float((sa - sb).abs().max()))
        top = max(top, float(sb.abs().max()))
    return diff / max(top, 1e-30)


def first_half_reference(u0, movies, users, rating, rows, lam, alpha):
    """The first movie half's solutions for the dense movie ``rows``, in
    float64 on the device: x = (YᵀY + Σ α·r·y yᵀ + λI)⁻¹ Σ (1 + α·r)·y
    over each movie's observed entries, Y = u0."""
    import torch

    y = torch.as_tensor(u0, device="cuda", dtype=torch.float64)
    ridge = y.T @ y + lam * torch.eye(y.shape[1], dtype=torch.float64,
                                      device=y.device)
    out = []
    for row in rows:
        sel = torch.nonzero(movies == row).flatten()
        f = y[users[sel].long()]
        r = rating[sel].double()
        a = ridge + (f * (alpha * r)[:, None]).T @ f
        out.append(torch.linalg.solve(a, f.T @ (1.0 + alpha * r)))
    return torch.stack(out)


def ridge_condition(factors, lam) -> float:
    """Condition number of FᵀF + λI (float64), the shared part of every
    implicit normal matrix solved against ``factors``."""
    import torch

    f = factors.double()
    w = torch.linalg.eigvalsh(f.T @ f + lam * torch.eye(
        f.shape[1], dtype=torch.float64, device=f.device))
    return float(w[-1] / w[0])


def profile_calls(fn, n: int, *, cpu: bool = True,
                  warm: bool = True) -> dict:
    """Where ``n`` calls of ``fn`` spend their time (measurement only):
    host wall ms per call, device-busy ms per call from torch.profiler's
    kernel rows, the idle share, and the top device rows.  ``cpu=False``
    traces the device alone (the segment phases launch ≈ 20 small ops a
    chunk over thousands of chunks, whose host events would take minutes
    to aggregate); ``warm=False`` skips the warm-up call where the caller
    just ran ``fn``'s work.  Returns ``{"error": ...}`` if the profiler
    cannot trace the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        if warm:
            fn()
        torch.cuda.synchronize()
        activities = [ProfilerActivity.CUDA]
        if cpu:
            activities.insert(0, ProfilerActivity.CPU)
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
        rows = []
        for evt in prof.key_averages():
            dev_us = getattr(evt, "self_device_time_total", 0) or 0
            if dev_us > 0 and not evt.key.startswith("aten::"):
                rows.append((evt.key[:60], dev_us / 1e3 / n, evt.count / n))
        rows.sort(key=lambda r: -r[1])
        busy = sum(r[1] for r in rows)
        return dict(wall_ms=wall_ms, device_busy_ms=busy,
                    idle_share=1 - busy / wall_ms, top=rows[:8])
    except Exception:  # measurement only: keep the smoke's verdict
        return {"error": traceback.format_exc()[-400:]}


def _merged(intervals):
    """The union of [start, end) intervals as sorted disjoint intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(intervals, merged) -> float:
    """Summed overlap of ``intervals`` with the disjoint ``merged`` ones."""
    total = 0.0
    for a, b in intervals:
        for c, d in merged:
            if c >= b:
                break
            total += max(0.0, min(b, d) - max(a, c))
    return total


def device_timeline(fn, n: int = 1) -> dict:
    """Where ``n`` calls of ``fn`` spend the card's time (measurement only),
    from torch.profiler's CUDA activity alone (CUPTI; no host events, so the
    profiler adds no host work to an eager route's launches): the wall ms a
    call (host clock, ending in a sync), ``device_ms`` a call (the union of
    the kernel, memcpy and memset intervals: two streams' overlap counted
    once), the idle share, the kernels counted (for a replay: whether
    CUPTI reports the kernels inside a CUDA graph), the streams seen, the
    top kernels by time, and the ms K5 (``gather_rows``) ran while another
    stream's kernels ran.  ``{"error": ...}`` if the profiler
    cannot trace the card."""
    import os
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in (
            "kernel", "gpu_memcpy", "gpu_memset")]
        spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in dev]
        busy = sum(b - a for a, b in _merged(spans)) / 1e3 / n
        by_name: dict = {}
        for e in dev:
            key = e["name"][:60]
            by_name[key] = by_name.get(key, 0.0) + float(e["dur"]) / 1e3 / n
        k5 = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get(
            "args", {}).get("stream")) for e in dev
            if "gather_rows" in e["name"]]
        k5_overlap = 0.0
        for stream in {s for _, _, s in k5}:
            others = _merged([sp for sp, e in zip(spans, dev)
                              if e.get("args", {}).get("stream") != stream])
            k5_overlap += _overlap([(a, b) for a, b, s in k5 if s == stream],
                                   others)
        return dict(
            wall_ms=wall_ms, device_ms=busy, idle_share=1 - busy / wall_ms,
            kernels=sum(e.get("cat") == "kernel" for e in dev) / n,
            streams=sorted({str(e.get("args", {}).get("stream"))
                            for e in dev}),
            k5_ms=sum(b - a for a, b, _ in k5) / 1e3 / n,
            k5_overlap_ms=k5_overlap / 1e3 / n,
            top=sorted(by_name.items(), key=lambda kv: -kv[1])[:6])
    except Exception:  # measurement only: keep the smoke's verdict
        return {"error": traceback.format_exc()[-400:]}


def graph_nodes(graph) -> int | None:
    """The node count of a captured graph (libcuda's ``cuGraphGetNodes``
    on ``raw_cuda_graph()``), None where it cannot be read."""
    import ctypes

    try:
        lib = ctypes.CDLL("libcuda.so.1")
        n = ctypes.c_size_t(0)
        rc = lib.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()),
                                 None, ctypes.byref(n))
        return int(n.value) if rc == 0 else None
    except (OSError, AttributeError, RuntimeError):
        return None


def dense_route(args, kw):
    """The library yardstick for K4's arguments: [B, M_pad] 0/−inf mask
    bias for padding and seen rows, the operands as K4 scores them
    (dequantized table, u rounded to bf16 for a bf16 table), and the two
    calls ``torch.topk(torch.addmm(bias, u, tableᵀ), K)`` — which write the
    [B, M_pad] matrix K4 never does."""
    import torch

    from cfk_tpu_torch.ops.quant import dequantize_table
    from cfk_tpu_torch.serving.topk_kernel import serve_compute_dtype

    u, table, scale, seen = args
    b, m_pad, tile_m = u.shape[0], table.shape[0], kw["tile_m"]
    bias = torch.zeros((b, m_pad + 1), device=u.device)
    gid = kw.get("row_offset", 0) + torch.arange(m_pad, device=u.device)
    bias[:, :m_pad].masked_fill_((gid >= kw["num_movies"])[None, :],
                                 float("-inf"))
    if seen is not None:
        c = seen.long()
        col = torch.where(
            c < tile_m,
            c + tile_m * torch.arange(c.shape[0], device=u.device)[:, None,
                                                                   None],
            m_pad)
        bias.scatter_(1, col.permute(1, 0, 2).reshape(b, -1),
                      float("-inf"))
    bias = bias[:, :m_pad].contiguous()
    uf = u.to(serve_compute_dtype(table.dtype)).float()
    tf = dequantize_table(table, scale).float()

    def call(k_top=kw["k_top"]):
        return torch.topk(torch.addmm(bias, uf, tf.T), k_top, dim=1)

    return call


def shard_kernel_check(group, view, table_rows, lam: float):
    """Run on every rank of the shards phase's mesh; on rank 0: one ring
    visit's K2 Grams — the middle chunk of the slice rank 0 holds first
    (its own), against its own block of ``table_rows`` — and K1 on the
    visit's segments with their real counts, each against its plain
    version on the same operands (launched twice: bit-equal), with their
    ms (CUDA events over 20 launches).  Other ranks return None."""
    import torch

    from cfk_tpu_torch.models.als import as_tensor
    from cfk_tpu_torch.ops.kernels.gram_kernel import (
        gram_gather, gram_gather_plain)
    from cfk_tpu_torch.ops.kernels.gram_units import chunk_plan
    from cfk_tpu_torch.ops.kernels.solve_kernel import (
        reg_solve, reg_solve_plain)
    from cfk_tpu_torch.ops.tiled import accum_chunk
    from cfk_tpu_torch.parallel.spmd import _side_to_device

    if group.rank != 0:
        return None
    dev = group.device
    blk, chunks, e = _side_to_device("tiled_ring", view, 0, dev,
                                     weighted=False)
    statics = tuple(chunks[2:])
    nc, e_c = statics[0], statics[-1]
    c = (blk["slice_starts"][0] + blk["slice_starts"][1]) // 2
    table = as_tensor(table_rows, dev)
    args = dict(accum_chunk(blk, statics, c), units=chunk_plan(blk, c))
    a, b = gram_gather(table, **args)
    a2, b2 = gram_gather(table, **args)
    ap, bp = gram_gather_plain(table, **args)
    ent = blk["chunk_entity"].view(nc, e_c)[c].long()
    cnt = torch.cat([blk["count"], blk["count"].new_zeros(1)])[ent]
    x = reg_solve(a[:e_c].clone(), b[:e_c].clone(), cnt, lam=lam)
    x2 = reg_solve(a[:e_c].clone(), b[:e_c].clone(), cnt, lam=lam)
    xp = reg_solve_plain(a[:e_c].clone(), b[:e_c].clone(), cnt, lam=lam)
    return dict(
        chunk=int(c), live_segments=int((ent < e).sum()),
        k2_rel_err=max(rel_err(a, ap)[1], rel_err(b, bp)[1]),
        k2_bit_equal=bool(torch.equal(a, a2) and torch.equal(b, b2)),
        k1_rel_err=rel_err(x, xp)[1], k1_bit_equal=bool(torch.equal(x, x2)),
        k2_ms=time_ms(lambda: gram_gather(table, **args), 20),
        k1_ms=time_ms(lambda: reg_solve(a[:e_c], b[:e_c], cnt, lam=lam),
                      20))


def profiled_rank(group, fn, *args, **kw):
    """``fn(group, *args, **kw)`` under torch.profiler (CUDA activity):
    (its result, this rank's kernel / memcpy / memset intervals in µs on
    the host's wall clock, so the ranks' intervals merge into the card's
    timeline)."""
    import os
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn(group, *args, **kw)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    base = float(trace.get("baseTimeNanoseconds", 0)) / 1e3
    spans = [(e["cat"], base + float(e["ts"]),
              base + float(e["ts"]) + float(e["dur"]))
             for e in trace["traceEvents"] if e.get("ph") == "X"
             and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    return out, spans


class Smoke:
    def __init__(self):
        self.failures: list[str] = []
        self.report: dict = {}
        self.kernels: dict[str, dict] = {}

    def phase(self, name, fn, *args):
        log(f"phase {name} ...")
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except Exception:  # a failed phase fails the run, after the others
            self.failures.append(f"{name}: {traceback.format_exc()}")
            log(f"phase {name} FAILED:\n{traceback.format_exc()}")
            return None
        log(f"phase {name} done in {time.perf_counter() - t0:.1f} s")
        self.report.setdefault("phase_s", {})[name] = time.perf_counter() - t0
        return out

    def check(self, ok: bool, what: str) -> None:
        if not ok:
            self.failures.append(what)
            log(f"CHECK FAILED: {what}")

    # -- phases -------------------------------------------------------------

    def build(self):
        from cfk_tpu_torch import _build
        from cfk_tpu_torch.data import _native
        from cfk_tpu_torch.transport.tcp import build_broker

        t0 = time.perf_counter()
        _native.load_library()  # raises if the host library cannot be built
        self.check(_native.available(), "host ingest library did not load")
        host_s = time.perf_counter() - t0
        log(f"host library {_build.host_library_path()} ({host_s:.1f} s)")
        self.report["host_library"] = dict(
            path=str(_build.host_library_path()), build_s=host_s)
        t0 = time.perf_counter()
        broker = build_broker()  # raises with the compiler's output
        self.report["broker"] = dict(path=broker,
                                     build_s=time.perf_counter() - t0)
        log(f"broker {broker} ({self.report['broker']['build_s']:.1f} s)")
        t0 = time.perf_counter()
        paths = _build.build_all()
        self.report["build_s"] = time.perf_counter() - t0
        self.report["ptxas"] = {}
        for name in paths:
            text = (_build.BUILD_DIR / f"{name}.ptxas.txt").read_text()
            self.report["ptxas"][name] = text
            log(text.strip().replace("\n", " | ")[-600:])

    def main_path(self):
        import numpy as np
        import torch

        from cfk_tpu_torch import ALSConfig, Dataset, train_als
        from cfk_tpu_torch.data.synthetic import synthetic_netflix_coo
        from cfk_tpu_torch.eval.metrics import mse_rmse_from_model
        from cfk_tpu_torch.models.als import _tiled_device_setup
        from cfk_tpu_torch.ops.kernels.gram_kernel import (
            gram_gather, gram_solve_dense)
        from cfk_tpu_torch.ops.kernels.solve_kernel import reg_solve
        from cfk_tpu_torch.ops.tiled import tiled_half_step

        t0 = time.perf_counter()
        coo = synthetic_netflix_coo(**NETFLIX, seed=0)
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ds = Dataset.from_coo(coo, layout="tiled", chunk_elems=1 << 20,
                              dense_stream=True)
        build_s = time.perf_counter() - t0
        mb, ub = ds.movie_blocks, ds.user_blocks
        group_s, group_check = self.group_by_check(ds)
        log(f"data: generate {gen_s:.1f} s, group_by {group_s:.2f} s (both "
            f"sides, host library), blocks {build_s:.1f} s; movie "
            f"{mb.mode} {mb.statics} slices={mb.num_slices}, user {ub.mode} "
            f"{ub.statics}; movie keys vs numpy's stable argsort: "
            f"{group_check}")
        self.check(mb.mode == "accum" and ub.mode == "dstream",
                   f"layout modes {mb.mode}/{ub.mode} != accum/dstream")
        config = ALSConfig(rank=RANK, lam=LAM, num_iterations=ITERS,
                           seed=0, layout="tiled")
        dev = torch.device("cuda")
        torch.cuda.reset_peak_memory_stats()
        for fn in (reg_solve, gram_gather, gram_solve_dense):
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = train_als(ds, config, device=dev)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches
                    for fn in (reg_solve, gram_gather, gram_solve_dense)}
        peak = torch.cuda.max_memory_allocated()
        for name, n in launches.items():
            self.check(n > 0, f"main path launched {name} {n} times")
        u, m = model.user_factors, model.movie_factors
        self.check(tuple(u.shape) == (NETFLIX["num_users"], RANK)
                   and tuple(m.shape) == (NETFLIX["num_movies"], RANK),
                   f"factor shapes {tuple(u.shape)} {tuple(m.shape)}")
        self.check(bool(torch.isfinite(u).all() and torch.isfinite(m).all()),
                   "non-finite factors")
        mse, rmse = mse_rmse_from_model(model, ds)
        std = float(np.std(coo.rating.astype(np.float64)))
        self.check(rmse < std, f"train RMSE {rmse} >= rating std {std}")
        # Where one iteration's time goes: each half alone, device-timed.
        blk_m, blk_u, kw = _tiled_device_setup(ds, dev)
        half_ms = {
            "movie_accum": time_ms(lambda: tiled_half_step(
                u, blk_m, kw["m_chunks"], kw["m_entities"], LAM), 1),
            "user_dstream": time_ms(lambda: tiled_half_step(
                m, blk_u, kw["u_chunks"], kw["u_entities"], LAM), 1),
        }
        self.report["main"] = dict(
            shape=NETFLIX, rank=RANK, lam=LAM, iterations=ITERS,
            generate_s=gen_s, blocks_s=build_s, group_by_s=group_s,
            group_by_vs_numpy=group_check, train_s=train_s,
            s_per_iter=train_s / ITERS, half_ms=half_ms, train_mse=mse,
            train_rmse=rmse, rating_std=std, peak_device_bytes=peak,
            launches=launches,
            launches_per_iter={k: v / ITERS for k, v in launches.items()},
            movie_statics=list(mb.statics), user_statics=list(ub.statics),
            movie_slices=mb.num_slices,
        )
        log(f"main: {train_s / ITERS:.3f} s/iter, halves {half_ms} ms, RMSE "
            f"{rmse:.4f} (rating std {std:.4f}), peak {peak / 2**30:.2f} GiB,"
            f" launches {launches}")
        for name, n in launches.items():
            self.kernels.setdefault(name, {})["launches"] = n
        return ds, model, blk_m, blk_u

    def group_by_check(self, ds):
        """The host library's counting sort on the full-size keys: seconds
        for both sides' keys, then the movie keys against numpy's stable
        argsort (order, count and start must be equal)."""
        import numpy as np

        from cfk_tpu_torch.data import _native
        from cfk_tpu_torch.data.blocks import group_by_dense_numpy

        d = ds.coo_dense
        nm, nu = ds.movie_map.num_entities, ds.user_map.num_entities
        t0 = time.perf_counter()
        got = _native.group_by(d.movie_raw, nm)
        _native.group_by(d.user_raw, nu)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = group_by_dense_numpy(d.movie_raw, nm)
        numpy_s = time.perf_counter() - t0
        equal = all(a.dtype == b.dtype and np.array_equal(a, b)
                    for a, b in zip(got, want))
        self.check(equal, "native group_by of the movie keys differs from "
                   "numpy's stable argsort")
        return native_s, dict(equal=equal, numpy_movie_keys_s=numpy_s,
                              keys=int(d.movie_raw.shape[0]))

    def breakdown(self, ds, model, blk_m, blk_u):
        """Where one iteration's time goes (measurement only, no checks):
        each kernel's device time per chunk beside the chunk's live rows,
        the rows of its largest segment (before the work-unit split, one
        CTA walked each segment, so that one was the chunk's critical
        path) and its units and split segments, and a torch.profiler pass
        over one iteration summed by kernel."""
        import numpy as np
        import torch
        from torch.profiler import ProfilerActivity, profile

        from cfk_tpu_torch.ops.kernels.gram_kernel import (
            gram_gather, gram_solve_dense)
        from cfk_tpu_torch.ops.tiled import (
            accum_chunk, dense_chunk, tiled_half_step)

        u, m = model.user_factors, model.movie_factors

        def chunk_ms(calls):
            events = []
            for call in calls:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                call()
                end.record()
                events.append((start, end))
            torch.cuda.synchronize()
            return np.array([s.elapsed_time(e) for s, e in events])

        st_m = ds.movie_blocks.statics
        args_m = [with_plan(accum_chunk(blk_m, st_m, c), blk_m, c)
                  for c in range(st_m[0])]
        ms_m = chunk_ms([lambda a=a: gram_gather(u, **a) for a in args_m])
        st_u = ds.user_blocks.statics
        args_u = [with_plan(dense_chunk(blk_u, st_u, c), blk_u, c)
                  for c in range(st_u[0])]
        for a in args_u:
            a.pop("cin")
        ms_u = chunk_ms([lambda a=a: gram_solve_dense(m, **a, lam=LAM)
                         for a in args_u])

        def summary(ms, big, args, work, live_key):
            work = [work(a) for a in args]
            live = np.array([w[2][live_key] for w in work])
            units = np.array([int((a["units"].units[:, 0] >= 0).sum())
                              for a in args])
            split = np.array([int((a["units"].splits >= 0).sum())
                              for a in args])
            order = np.argsort(ms)
            return dict(total_ms=float(ms.sum()), min_ms=float(ms.min()),
                        median_ms=float(np.median(ms)), max_ms=float(ms.max()),
                        bound_ms=float(sum(bound(b, f)[0]
                                           for b, f, _ in work)),
                        ns_per_live_row=float(np.median(ms / live) * 1e6),
                        ns_per_row_of_largest_segment=float(
                            np.median(ms / np.maximum(big, 1)) * 1e6),
                        corr_ms_vs_live_rows=float(
                            np.corrcoef(ms, live)[0, 1]),
                        corr_ms_vs_largest_segment=float(
                            np.corrcoef(ms, big)[0, 1]),
                        units_per_chunk=[int(units.min()),
                                         float(units.mean()),
                                         int(units.max())],
                        split_segments_per_chunk=[int(split.min()),
                                                  float(split.mean()),
                                                  int(split.max())],
                        slowest=[dict(ms=float(ms[i]), live_rows=int(live[i]),
                                      largest_segment=int(big[i]),
                                      units=int(units[i]),
                                      split_segments=int(split[i]))
                                 for i in order[-3:]])

        self.report["chunks"] = dict(
            gram_gather=summary(ms_m, largest_tile_segments(blk_m, st_m),
                                args_m, lambda a: gram_gather_work(u, a),
                                "live_rows"),
            gram_solve_dense=summary(
                ms_u, largest_window_segments(blk_u, st_u), args_u,
                lambda a: gram_solve_dense_work(m, a), "window_rows"))
        log(f"per-chunk kernel time vs live rows and largest segment: "
            f"{self.report['chunks']}")
        kw = dict(m_chunks=("tiled", "accum") + st_m,
                  u_chunks=("tiled", "dstream") + st_u)
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                m1 = tiled_half_step(u, blk_m, kw["m_chunks"],
                                     ds.movie_blocks.padded_entities, LAM)
                tiled_half_step(m1, blk_u, kw["u_chunks"],
                                ds.user_blocks.padded_entities, LAM)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            rows = []
            for evt in prof.key_averages():
                dev_us = getattr(evt, "self_device_time_total", 0) or 0
                # aten:: rows repeat the device time of their own kernels
                if dev_us > 0 and not evt.key.startswith("aten::"):
                    rows.append((evt.key[:60], dev_us / 1e3, evt.count))
            rows.sort(key=lambda r: -r[1])
            busy = sum(r[1] for r in rows)
            self.report["profile"] = dict(
                wall_ms=wall_ms, device_busy_ms=busy,
                idle_share=1 - busy / wall_ms if wall_ms else None,
                top=rows[:12])
            log(f"profile of one iteration: {self.report['profile']}")
        except Exception:  # measurement only: keep the smoke's verdict
            log(f"profiler unavailable: {traceback.format_exc()}")

    def kernel_checks(self, ds, model, blk_m, blk_u):
        import numpy as np
        import torch

        from cfk_tpu_torch.ops.kernels.gram_kernel import (
            gram_gather, gram_gather_plain, gram_solve_dense,
            gram_solve_dense_plain)
        from cfk_tpu_torch.ops.kernels.solve_kernel import (
            add_ridge_plain, reg_solve, reg_solve_plain)
        from cfk_tpu_torch.ops.tiled import accum_chunk, accum_grams, dense_chunk

        dev = torch.device("cuda")
        k = RANK
        u, m = model.user_factors, model.movie_factors
        # K1 at k = 64 on the main path's own operands: the movie half's
        # accumulated Grams of the trained U table (what the next iteration
        # solves) with the real counts.  At k = 128, random Grams of 2k rows
        # scaled by the same counts, so the Gram outweighs the λ·n ridge.
        counts = blk_m["count"]
        a64, b64 = accum_grams(u, blk_m, ds.movie_blocks.padded_entities,
                               statics=ds.movie_blocks.statics)
        gen = torch.Generator(device=dev).manual_seed(128)
        x = torch.randn((counts.shape[0], 256, 128), generator=gen, device=dev)
        a128 = torch.einsum("enk,enl->ekl", x, x) * (
            counts.clamp_min(1).float() / 256)[:, None, None]
        b128 = torch.randn((counts.shape[0], 128), generator=gen, device=dev)
        del x
        for kk, a, b in ((64, a64, b64), (128, a128, b128)):
            e = a.shape[0]
            got = reg_solve(a, b, counts, lam=LAM)
            torch.cuda.synchronize()
            want = reg_solve_plain(a, b, counts, lam=LAM)
            err, rel = rel_err(got, want)
            ms = time_ms(lambda: reg_solve(a, b, counts, lam=LAM), 20)
            plain_ms = time_ms(lambda: reg_solve_plain(a, b, counts, lam=LAM), 5)
            lib_ms = time_ms(lambda: torch.linalg.solve(
                add_ridge_plain(a, counts, lam=LAM, reg_mode="diag"), b), 5)
            b_ms, by = bound(*reg_solve_work(e, kk))
            row = dict(max_abs_err=err, rel_err=rel, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=b_ms, bound_by=by, e=e, k=kk,
                       operands="main path accum Grams" if kk == k
                       else "count-scaled random Grams")
            self.report.setdefault("reg_solve", {})[f"k{kk}"] = row
            log(f"K1 reg_solve k={kk}: {row}")
            self.check(rel < TOL["reg_solve"],
                       f"reg_solve k={kk} rel err {rel} >= {TOL['reg_solve']}")
            if kk == k:
                self.kernels.setdefault("reg_solve", {}).update(row)
            del got, want
        # K1 at k = 128 below one wave of CTAs: one system (the latency of
        # one solve) and 203 (a split implicit chunk's share of 162,541
        # users over 801 chunks), the kernel's device time beside its
        # bound, which at these sizes reads as a floor no latency reaches
        # (wall_ms: back-to-back calls, the host's launch path included);
        # then two launches on the full batch, which must be bit-equal (no
        # atomics, one order).
        lat = {}
        for e in (1, 203):
            ae, be, ce = a128[:e], b128[:e], counts[:e]
            b_ms, by = bound(*reg_solve_work(e, 128))
            lat[f"ms_k128_e{e}"] = kernel_ms(
                lambda: reg_solve(ae, be, ce, lam=LAM), 200,
                "reg_solve_kernel")
            lat[f"wall_ms_k128_e{e}"] = time_ms(
                lambda: reg_solve(ae, be, ce, lam=LAM), 200)
            lat[f"bound_ms_k128_e{e}"] = b_ms
        again = [reg_solve(a128, b128, counts, lam=LAM) for _ in range(2)]
        torch.cuda.synchronize()
        lat["two_launches_bit_equal"] = torch.equal(*again)
        self.report["reg_solve"]["k128_below_one_wave"] = lat
        self.kernels["reg_solve"].update(lat)
        log(f"K1 reg_solve k=128 below one wave: {lat}")
        self.check(lat["two_launches_bit_equal"],
                   "reg_solve k=128: two launches differ")
        del a64, b64, a128, b128, a, b, again

        def dense_args(c):
            """Dense chunk c's K3 operands with the carry the real previous
            chunk hands it (the plain chain over chunks 0 .. c-1)."""
            a0 = torch.zeros((k, k), device=dev)
            b0 = torch.zeros((k,), device=dev)
            for ci in range(c):
                prev = dense_chunk(blk_u, st_u, ci)
                cin = prev.pop("cin")
                _, a0, b0 = gram_solve_dense_plain(m, **prev, lam=LAM,
                                                   carry=(a0, b0, cin))
            args = with_plan(dense_chunk(blk_u, st_u, c), blk_u, c)
            cin = args.pop("cin")
            return dict(args, lam=LAM, carry=(a0, b0, cin))

        # K2: the middle accum chunk of the movie half, the trained U table,
        # and the chunk holding the half's largest segment.  K3: the middle
        # dense chunk of the user half, the trained M table, and the chunk
        # holding its largest segment, each with the carry the real previous
        # chunk hands it.  Each run twice: the work-unit split sums a
        # segment's partials in unit order, so two launches give the same
        # bits (checked).
        st_m, st_u = ds.movie_blocks.statics, ds.user_blocks.statics
        big_m = int(np.argmax(largest_tile_segments(blk_m, st_m)))
        big_u = int(np.argmax(largest_window_segments(blk_u, st_u)))
        k2 = ("gram_gather", gram_gather, gram_gather_plain, gram_gather_work,
              lambda c: (u, with_plan(accum_chunk(blk_m, st_m, c), blk_m,
                                      c)))
        k3 = ("gram_solve_dense", gram_solve_dense, gram_solve_dense_plain,
              gram_solve_dense_work, lambda c: (m, dense_args(c)))
        for where, c, (name, fn, plain, work, args_of) in (
                ("middle", st_m[0] // 2, k2), ("largest", big_m, k2),
                ("middle", st_u[0] // 2, k3), ("largest", big_u, k3)):
            table, args = args_of(c)
            got = fn(table, **args)
            again = fn(table, **args)
            torch.cuda.synchronize()
            want = plain(table, **args)
            errs = [rel_err(g, w) for g, w in zip(got, want)]
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            ms = time_ms(lambda: fn(table, **args), 10)
            plain_ms = time_ms(lambda: plain(table, **args), 3)
            nbytes, flops, counts = work(table, args)
            b_ms, by = bound(nbytes, flops)
            units = args["units"]
            row = dict(max_abs_err=max(x[0] for x in errs),
                       rel_err=max(x[1] for x in errs), ms=ms,
                       plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                       bound_by=by, chunk=c, two_launches_bit_equal=same,
                       units=int((units.units[:, 0] >= 0).sum()),
                       split_segments=int((units.splits >= 0).sum()),
                       **counts)
            if where == "middle":
                self.kernels.setdefault(name, {}).update(row)
            self.report.setdefault("kernel_chunks", {})[
                f"{name}_{where}"] = row
            log(f"{name} on the {where}-segment chunk {c}: {row}")
            self.check(row["rel_err"] < TOL[name],
                       f"{name} chunk {c} rel err {row['rel_err']}")
            self.check(same, f"{name} chunk {c}: two launches differ")
            del got, again, want

    def binv(self, ds, model, blk_m, blk_u):
        """The block-inverse solve path (phase 3b of the module docstring):
        the prototype's default shape through both routes as the path's
        run, then each kernel against its plain version, K1, a float64
        solve and the library call at the shapes the path and the training
        halves give it."""
        import numpy as np
        import torch

        from cfk_tpu_torch import _build
        from cfk_tpu_torch.ops.kernels.binv_kernel import (
            binv_inv, binv_inv_plain, binv_solve_reg, binv_solve_reg_plain,
            ctas_per_sm)
        from cfk_tpu_torch.ops.kernels.solve_kernel import (
            add_ridge_plain, reg_solve)
        from cfk_tpu_torch.ops.tiled import accum_grams
        from cfk_tpu_torch.scripts.exp_binv import (
            float64_check, make_inputs, xla_binv_solve_reg)

        dev = torch.device("cuda")
        c = BINV
        k, e, lam = c["k"], c["e"], c["lam"]
        a_np, b_np, cnt_np = make_inputs(k, e)
        a, b, cnt = (torch.as_tensor(x, device=dev)
                     for x in (a_np, b_np, cnt_np))
        routes = {
            "fused": lambda: binv_solve_reg(a, b, cnt, lam=lam),
            "xla": lambda: xla_binv_solve_reg(a, b, cnt, lam=lam)}
        # -- the path: both routes once, launch counts zeroed before ------
        for fn in (binv_solve_reg, binv_inv):
            fn.launches = 0
        torch.cuda.synchronize()
        got = {mode: run() for mode, run in routes.items()}
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches
                    for fn in (binv_solve_reg, binv_inv)}
        for name, n in launches.items():
            self.check(n > 0, f"binv path launched {name} {n} times")
            self.kernels.setdefault(name, {})["launches"] = n
        report = dict(k=k, e=e, lam=lam, launches=launches, ptxas={
            name: ptxas_usage((_build.BUILD_DIR / f"{name}.ptxas.txt")
                              .read_text())
            for name in ("binv_solve_reg", "binv_inv")})
        log(f"binv ptxas: {report['ptxas']}")
        plain = binv_solve_reg_plain(a, b, cnt, lam=lam)
        a_reg = add_ridge_plain(a, cnt, lam=lam, reg_mode="diag")
        k1_x = reg_solve(a, b, cnt, lam=lam)
        for mode, x in got.items():
            resid, rel64 = float64_check(a_np, b_np, cnt_np, x.cpu().numpy(),
                                         lam)
            row = dict(max_abs_resid=resid, rel_err_vs_float64=rel64,
                       rel_err_vs_plain=rel_err(x, plain)[1],
                       rel_err_vs_reg_solve=rel_err(x, k1_x)[1],
                       ms=time_ms(routes[mode], 10))
            report[mode] = row
            log(f"binv {mode} k={k} E={e}: {row}")
            self.check(rel64 < TOL["binv_float64"],
                       f"binv {mode}: rel_err_vs_float64 {rel64}")
            self.check(row["rel_err_vs_plain"] < TOL["binv_solve_reg"],
                       f"binv {mode}: rel_err_vs_plain "
                       f"{row['rel_err_vs_plain']}")
        # Controls: what a kernel that dropped the refinement step, or took
        # its products in TF32, would read against the plain version.
        a_inv = binv_inv_plain(a_reg)
        unrefined = (a_inv @ b[..., None])[..., 0]
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            plain_tf32 = binv_solve_reg_plain(a, b, cnt, lam=lam)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        report["control_rel_err_vs_plain"] = dict(
            unrefined=rel_err(unrefined, plain)[1],
            tf32_products=rel_err(plain_tf32, plain)[1])
        log(f"binv controls vs plain: {report['control_rel_err_vs_plain']}")
        self.check(report["control_rel_err_vs_plain"]["unrefined"]
                   > TOL["binv_solve_reg"],
                   "binv control: the unrefined solve is within "
                   f"{TOL['binv_solve_reg']} of the refined one")
        del a_inv, unrefined, plain_tf32
        k1_64 = float64_check(a_np, b_np, cnt_np, k1_x.cpu().numpy(), lam)
        report["plain_rel_err_vs_float64"] = float64_check(
            a_np, b_np, cnt_np, plain.cpu().numpy(), lam)[1]
        log(f"K1 rel x err vs float64 at k={k}: {k1_64[1]:.4g} (the "
            f"column-at-a-time Cholesky: {K1_FLOAT64_ERR_COLUMN_ORDER:.4g})")
        self.check(k1_64[1] <= TOL["reg_solve_float64"],
                   f"reg_solve k={k}: rel_err_vs_float64 {k1_64[1]} > "
                   f"{TOL['reg_solve_float64']}")
        nbytes, flops = binv_solve_work(e, k, "diag")
        b_ms, by = bound(nbytes, flops)
        row = dict(max_abs_err=rel_err(got["fused"], plain)[0],
                   rel_err=rel_err(got["fused"], plain)[1],
                   ms=report["fused"]["ms"],
                   plain_ms=time_ms(lambda: binv_solve_reg_plain(
                       a, b, cnt, lam=lam), 3),
                   library_ms=time_ms(lambda: torch.linalg.solve(a_reg, b), 5),
                   bound_ms=b_ms, bound_by=by, e=e, k=k,
                   ctas_per_sm=ctas_per_sm("binv_solve_reg", k),
                   reg_solve_ms=time_ms(lambda: reg_solve(a, b, cnt, lam=lam),
                                        10),
                   reg_solve_rel_err_vs_float64=k1_64[1],
                   reg_solve_rel_err_vs_float64_column_order=(
                       K1_FLOAT64_ERR_COLUMN_ORDER),
                   operands="exp_binv default inputs (seed 0)")
        self.kernels["binv_solve_reg"].update(row)
        report["binv_solve_reg_k128"] = row
        log(f"binv_solve_reg (row 14) k={k} E={e}: {row}")
        # binv_inv alone on the Schur route's leaf operands (the ridged
        # A11 blocks) at n = 32 (its shape on the route) and n = 16.
        for n in (16, 32):
            blk = a_reg[:, :n, :n].contiguous()
            inv = binv_inv(blk)
            torch.cuda.synchronize()
            want = binv_inv_plain(blk)
            err, rel = rel_err(inv, want)
            nbytes, flops = binv_inv_work(e, n)
            b_ms, by = bound(nbytes, flops)
            row = dict(max_abs_err=err, rel_err=rel,
                       ms=time_ms(lambda: binv_inv(blk), 20),
                       plain_ms=time_ms(lambda: binv_inv_plain(blk), 3),
                       library_ms=time_ms(lambda: torch.linalg.inv(blk), 5),
                       bound_ms=b_ms, bound_by=by, e=e, n=n,
                       ctas_per_sm=ctas_per_sm("binv_inv", n))
            report[f"binv_inv_n{n}"] = row
            log(f"binv_inv (row 15) n={n} E={e}: {row}")
            self.check(rel < TOL["binv_inv"],
                       f"binv_inv n={n} rel err {rel}")
            if n == 32:
                self.kernels["binv_inv"].update(row)
            else:
                self.kernels["binv_inv"].update(
                    {f"{key}_n{n}": row[key]
                     for key in ("ms", "bound_ms", "library_ms")})
        del a, b, cnt, a_reg, plain, got, k1_x
        # Row 14 on the main path's own batch: the movie half's accumulated
        # Grams of the trained U table with their counts, at k = 64 — the
        # systems K1 solves there.
        u = model.user_factors
        counts = blk_m["count"]
        a64, b64 = accum_grams(u, blk_m, ds.movie_blocks.padded_entities,
                               statics=ds.movie_blocks.statics)
        x = binv_solve_reg(a64, b64, counts, lam=LAM)
        k1_x = reg_solve(a64, b64, counts, lam=LAM)
        torch.cuda.synchronize()
        nbytes, flops = binv_solve_work(a64.shape[0], a64.shape[1], "diag")
        row = dict(e=a64.shape[0], k=a64.shape[1],
                   rel_err_vs_reg_solve=rel_err(x, k1_x)[1],
                   rel_err_vs_plain=rel_err(x, binv_solve_reg_plain(
                       a64, b64, counts, lam=LAM))[1],
                   ms=time_ms(lambda: binv_solve_reg(a64, b64, counts,
                                                     lam=LAM), 20),
                   reg_solve_ms=time_ms(lambda: reg_solve(a64, b64, counts,
                                                          lam=LAM), 20),
                   library_ms=time_ms(lambda: torch.linalg.solve(
                       add_ridge_plain(a64, counts, lam=LAM,
                                       reg_mode="diag"), b64), 5),
                   bound_ms=bound(nbytes, flops)[0],
                   bound_by=bound(nbytes, flops)[1],
                   ctas_per_sm=ctas_per_sm("binv_solve_reg", a64.shape[1]))
        report["main_path_k64"] = row
        self.kernels["binv_solve_reg"].update(
            {f"{key}_k64": row[key] for key in ("ms", "bound_ms",
                                                 "library_ms")})
        log(f"binv_solve_reg (row 14) on the main path's movie Grams: {row}")
        for what in ("rel_err_vs_reg_solve", "rel_err_vs_plain"):
            self.check(row[what] < TOL["binv_solve_reg"],
                       f"binv_solve_reg k=64 main path: {what} {row[what]}")
        del a64, b64, x, k1_x
        # Matrix mode at k = 128 on 59,047 systems shaped as the implicit
        # movie half's (the ML-25M movie count, 3.9 GB of A, built in
        # slices): an observed part α·(n/64)·XᵀX, X [64, k] ~ U(0, 1), n
        # in [1, 400) from seed 1, and the shared ridge YᵀY + λI over
        # 162,541 rows Y ~ U(0, 1) (the implicit phase's u0 and λ).
        em = c["matrix_e"]
        gen = torch.Generator(device=dev).manual_seed(1)
        cnt_m = torch.randint(1, 400, (em,), generator=gen, device=dev)
        am = torch.empty((em, k, k), device=dev)
        for lo in range(0, em, 8192):
            xs = torch.rand((min(8192, em - lo), 64, k), generator=gen,
                            device=dev)
            torch.matmul(xs.transpose(1, 2), xs,
                         out=am[lo:lo + xs.shape[0]])
            am[lo:lo + xs.shape[0]] *= (
                IMPLICIT["alpha"] * cnt_m[lo:lo + xs.shape[0]].float()
                / 64)[:, None, None]
        del xs
        bm = torch.rand((em, k), generator=gen, device=dev) * 100
        y = torch.rand((ML25M["num_users"], k), generator=gen, device=dev)
        rm = y.T @ y + IMPLICIT["lam"] * torch.eye(k, device=dev)
        del y
        x = binv_solve_reg(am, bm, rm, reg_mode="matrix")
        k1_x = reg_solve(am, bm, rm, reg_mode="matrix")
        torch.cuda.synchronize()
        nbytes, flops = binv_solve_work(em, k, "matrix")
        row = dict(e=em, k=k, rel_err_vs_reg_solve=rel_err(x, k1_x)[1],
                   ms=time_ms(lambda: binv_solve_reg(
                       am, bm, rm, reg_mode="matrix"), 3),
                   reg_solve_ms=time_ms(lambda: reg_solve(
                       am, bm, rm, reg_mode="matrix"), 3),
                   bound_ms=bound(nbytes, flops)[0],
                   bound_by=bound(nbytes, flops)[1])
        del k1_x
        row["library_ms"] = time_ms(lambda: torch.linalg.solve(
            add_ridge_plain(am, rm, lam=0.0, reg_mode="matrix"), bm), 2)
        self.kernels["binv_solve_reg"].update(
            {f"{key}_matrix": row[key] for key in ("ms", "bound_ms",
                                                    "library_ms")})
        row["rel_err_vs_plain"] = rel_err(x, binv_solve_reg_plain(
            am, bm, rm, reg_mode="matrix"))[1]
        report["matrix_k128"] = row
        log(f"binv_solve_reg (row 14) matrix mode k={k} E={em}: {row}")
        for what in ("rel_err_vs_reg_solve", "rel_err_vs_plain"):
            self.check(row[what] < TOL["binv_solve_reg"],
                       f"binv_solve_reg matrix k=128: {what} {row[what]}")
        del am, bm, x
        torch.cuda.empty_cache()
        # The port's script as a user runs it, on the card.
        for argv in ((), ("--mode", "fused")):
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "cfk_tpu_torch.scripts.exp_binv",
                 *argv], cwd=ROOT, capture_output=True, text=True,
                timeout=300)
            log(f"exp_binv {' '.join(argv) or '(defaults)'}: exit "
                f"{r.returncode} in {time.perf_counter() - t0:.1f} s:\n"
                f"{r.stdout.strip()}\n{r.stderr.strip()[-2000:]}")
            report[f"script{'_'.join(argv)}"] = dict(
                returncode=r.returncode, stdout=r.stdout)
            self.check(r.returncode == 0,
                       f"python -m cfk_tpu_torch.scripts.exp_binv {argv} "
                       f"exited {r.returncode}")
        self.report["binv"] = report

    def split(self, ds, model, blk_m, blk_u):
        """The split epilogue on the main path's dataset (phase 4b of the
        module docstring)."""
        import numpy as np
        import torch

        from cfk_tpu_torch import ALSConfig, train_als
        from cfk_tpu_torch.eval.metrics import mse_rmse_from_model
        from cfk_tpu_torch.models.als import init_user_factors
        from cfk_tpu_torch.ops.kernels.gram_kernel import (
            gram_gather, gram_solve_dense, gram_tiles_dense_gather,
            gram_tiles_dense_gather_plain)
        from cfk_tpu_torch.ops.kernels.solve_kernel import (
            gauss_solve, gauss_solve_multi, gauss_solve_plain, reg_solve)
        from cfk_tpu_torch.ops.tiled import (
            accum_grams, dense_chunk, tiled_half_step)

        dev = torch.device("cuda")
        k = RANK
        kernels = (gram_gather, gram_tiles_dense_gather, reg_solve,
                   gauss_solve, gauss_solve_multi, gram_solve_dense)
        config = ALSConfig(rank=RANK, lam=LAM, num_iterations=SPLIT_ITERS,
                           seed=0, layout="tiled", fused_epilogue=False)
        # -- the split path: train_als from the main run's initial factors --
        for fn in kernels:
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        split_model = train_als(ds, config, device=dev)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in kernels}
        for name in ("gram_gather", "gram_tiles_dense_gather", "reg_solve",
                     "gauss_solve"):
            self.check(launches[name] > 0,
                       f"split path launched {name} {launches[name]} times")
        self.check(launches["gram_solve_dense"] == 0
                   and launches["gauss_solve_multi"] == 0,
                   f"split path at rank {k} ran a fused dense chunk or the "
                   f"blocked solve: {launches}")
        u, m = split_model.user_factors, split_model.movie_factors
        self.check(bool(torch.isfinite(u).all() and torch.isfinite(m).all()),
                   "split: non-finite factors")
        mse, rmse = mse_rmse_from_model(split_model, ds)
        std = float(np.std(ds.coo_dense.rating.astype(np.float64)))
        self.check(rmse < std, f"split: train RMSE {rmse} >= rating std {std}")
        del split_model, u, m
        # -- the first halves, fused against split, from the same start ------
        em = ds.movie_blocks.padded_entities
        eu = ds.user_blocks.padded_entities
        mc = ("tiled", "accum") + ds.movie_blocks.statics
        uc = ("tiled", "dstream") + ds.user_blocks.statics
        u0, _ = init_user_factors(ds, blk_u, config, dev, None)
        m_f = tiled_half_step(u0, blk_m, mc, em, LAM)
        m_s = tiled_half_step(u0, blk_m, mc, em, LAM, fused_epilogue=False)
        u_f = tiled_half_step(m_f, blk_u, uc, eu, LAM)
        u_s = tiled_half_step(m_f, blk_u, uc, eu, LAM, fused_epilogue=False)
        movie_err, user_err = rel_err(m_s, m_f), rel_err(u_s, u_f)
        movie_equal = bool(torch.equal(m_s, m_f))
        user_equal = bool(torch.equal(u_s, u_f))
        self.check(movie_err[1] < TOL["split_first_half"],
                   f"split: first movie half differs from fused by "
                   f"{movie_err[1]}")
        self.check(movie_equal, "split: first movie half not bit-equal to "
                   f"the fused one (max abs diff {movie_err[0]})")
        self.check(user_err[1] < TOL["split_first_half"],
                   f"split: first user half differs from fused by "
                   f"{user_err[1]}")
        movie = functools.partial(tiled_half_step, u0, blk_m, mc, em, LAM,
                                  fused_epilogue=False)
        user = functools.partial(tiled_half_step, m_f, blk_u, uc, eu, LAM,
                                 fused_epilogue=False)
        half_ms = {"movie_accum_split": time_ms(movie, 1),
                   "user_dstream_split": time_ms(user, 1)}
        profile = profile_calls(lambda: (movie(), user()), 1)
        del u0, m_f, m_s, u_f, u_s, movie, user
        self.report["split"] = dict(
            iterations=SPLIT_ITERS, train_s=train_s,
            s_per_iter=train_s / SPLIT_ITERS, half_ms=half_ms,
            train_mse=mse, train_rmse=rmse, launches=launches,
            launches_per_iter={n: v / SPLIT_ITERS
                               for n, v in launches.items()},
            first_movie_half_vs_fused=movie_err,
            first_movie_half_bit_equal=movie_equal,
            first_user_half_vs_fused=user_err,
            first_user_half_bit_equal=user_equal, profile=profile)
        log(f"split: {self.report['split']}")

        # The split Gram on the middle dense chunk (the trained M table, the
        # carry the real previous chunks hand it), as K3 is checked.
        mt = model.movie_factors
        st = ds.user_blocks.statics
        mid = st[0] // 2
        a0 = torch.zeros((k, k), device=dev)
        b0 = torch.zeros((k,), device=dev)
        for ci in range(mid + 1):
            args = with_plan(dense_chunk(blk_u, st, ci), blk_u, ci)
            cin, lseg = args.pop("cin"), args.pop("lseg")
            args.pop("reg")
            carry = (a0, b0, cin)
            if ci < mid:
                a, b = gram_tiles_dense_gather(mt, **args, carry=carry)
                a0 = a.index_select(0, lseg.long())[0]
                b0 = b.index_select(0, lseg.long())[0]
        got = gram_tiles_dense_gather(mt, **args, carry=carry)
        torch.cuda.synchronize()
        want = gram_tiles_dense_gather_plain(mt, **args, carry=carry)
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        nbytes, flops, counts = gram_tiles_dense_gather_work(mt, args)
        b_ms, by = bound(nbytes, flops)
        row = dict(
            max_abs_err=max(e[0] for e in errs),
            rel_err=max(e[1] for e in errs),
            ms=time_ms(lambda: gram_tiles_dense_gather(mt, **args,
                                                       carry=carry), 10),
            plain_ms=time_ms(lambda: gram_tiles_dense_gather_plain(
                mt, **args, carry=carry), 3),
            library_ms=None, bound_ms=b_ms, bound_by=by,
            launches=launches["gram_tiles_dense_gather"], chunk=mid,
            **counts)
        self.kernels["gram_tiles_dense_gather"] = row
        log(f"gram_tiles_dense_gather: {row}")
        self.check(row["rel_err"] < TOL["gram_tiles_dense_gather"],
                   f"gram_tiles_dense_gather rel err {row['rel_err']}")
        del got, want

        # Row 11 on the movie half's accumulated Grams of the trained U
        # table with their ridge λ·max(n, 1): the accum half's split solve.
        a, b = accum_grams(model.user_factors, blk_m, em,
                           statics=ds.movie_blocks.statics)
        ridge = LAM * blk_m["count"].to(torch.float32).clamp_min(1.0)
        a.diagonal(dim1=-2, dim2=-1).add_(ridge[:, None])
        al, bl = a.permute(1, 2, 0), b.T  # batch-last views, as dispatched
        got = gauss_solve(al, bl)
        again = gauss_solve(al, bl)
        torch.cuda.synchronize()
        want = gauss_solve_plain(al, bl)
        err, rel = rel_err(got, want)
        b_ms, by = bound(*gauss_work(em, k, 1))
        row = dict(max_abs_err=err, rel_err=rel,
                   bit_equal_twice=bool(torch.equal(got, again)),
                   ms=time_ms(lambda: gauss_solve(al, bl), 20),
                   plain_ms=time_ms(lambda: gauss_solve_plain(al, bl), 3),
                   library_ms=time_ms(lambda: torch.linalg.solve(a, b), 5),
                   bound_ms=b_ms, bound_by=by,
                   launches=launches["gauss_solve"], e=em, k=k, m=1)
        self.kernels["gauss_solve"] = row
        log(f"gauss_solve: {row}")
        self.check(rel < TOL["gauss_solve"], f"gauss_solve rel err {rel}")
        self.check(row["bit_equal_twice"],
                   "gauss_solve: two launches differ")

    def gather(self, ds, model, blk_m, blk_u):
        """The materialized-stream schedule on the main path's dataset
        (phase 4c of the module docstring)."""
        import numpy as np
        import torch

        from cfk_tpu_torch import ALSConfig, train_als
        from cfk_tpu_torch.eval.metrics import mse_rmse_from_model
        from cfk_tpu_torch.models.als import init_user_factors
        from cfk_tpu_torch.ops.kernels import gram_kernel as gk
        from cfk_tpu_torch.ops.kernels.solve_kernel import (
            gauss_solve, reg_solve)
        from cfk_tpu_torch.ops.tiled import (
            accum_chunk, dense_chunk, tiled_half_step)

        dev = torch.device("cuda")
        k = RANK
        kernels = (gk.gather_rows, gk.gram_gather, gk.gram_solve_dense,
                   gk.gram_solve_gather, gk.gram_tiles_dense_gather,
                   gk.gram_tiles, gk.gram_solve_tiles, gk.gram_tiles_dense,
                   gk.gram_solve_tiles_dense, reg_solve, gauss_solve)
        gather_kernels = ("gram_gather", "gram_solve_dense",
                          "gram_solve_gather", "gram_tiles_dense_gather")
        needed = {"fused": ("gather_rows", "gram_tiles",
                            "gram_solve_tiles_dense", "reg_solve"),
                  "split": ("gather_rows", "gram_tiles", "gram_tiles_dense",
                            "reg_solve", "gauss_solve")}
        report = dict(on_s_per_iter=dict(
            fused=self.report["main"]["s_per_iter"],
            split=self.report.get("split", {}).get("s_per_iter")))
        # -- the main path with the gather off: train_als, fused and split --
        for sched, fused in (("fused", None), ("split", False)):
            iters = GATHER_OFF_ITERS
            config = ALSConfig(rank=RANK, lam=LAM, num_iterations=iters,
                               seed=0, layout="tiled", fused_epilogue=fused,
                               in_kernel_gather=False)
            for fn in kernels:
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            off = train_als(ds, config, device=dev)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            launches = {fn.__name__: fn.launches for fn in kernels}
            for name in needed[sched]:
                self.check(launches[name] > 0, f"gather off ({sched}) "
                           f"launched {name} {launches[name]} times")
            self.check(all(launches[n] == 0 for n in gather_kernels),
                       f"gather off ({sched}) launched a gather kernel: "
                       f"{launches}")
            self.check(bool(torch.isfinite(off.user_factors).all()
                            and torch.isfinite(off.movie_factors).all()),
                       f"gather off ({sched}): non-finite factors")
            _, rmse = mse_rmse_from_model(off, ds)
            std = float(np.std(ds.coo_dense.rating.astype(np.float64)))
            self.check(rmse < std, f"gather off ({sched}): train RMSE "
                       f"{rmse} >= rating std {std}")
            report[sched] = dict(
                iterations=iters, train_s=train_s, s_per_iter=train_s / iters,
                train_rmse=rmse, launches=launches,
                launches_per_iter={n: v / iters for n, v in launches.items()})
            for name in ("gram_tiles", "gram_tiles_dense",
                         "gram_solve_tiles_dense"):
                row = self.kernels.setdefault(name, {})
                row["launches"] = row.get("launches", 0) + launches[name]
            del off
        # -- the first halves, gather on against off, from the main start --
        em = ds.movie_blocks.padded_entities
        eu = ds.user_blocks.padded_entities
        mc = ("tiled", "accum") + ds.movie_blocks.statics
        uc = ("tiled", "dstream") + ds.user_blocks.statics
        u0, _ = init_user_factors(ds, blk_u, ALSConfig(rank=RANK, seed=0),
                                  dev, None)

        def timed(fn):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            return out, start.elapsed_time(end)

        halves, half_ms = {}, {}
        for sched, fused in (("fused", None), ("split", False)):
            out = {}
            for side, fixed_of, blk, chunks, ents in (
                    ("movie", lambda: u0, blk_m, mc, em),
                    ("user", lambda: out["movie", True], blk_u, uc, eu)):
                for on in (True, False):
                    out[side, on], half_ms[f"{side}_{sched}_"
                                           f"{'on' if on else 'off'}"] = \
                        timed(lambda: tiled_half_step(
                            fixed_of(), blk, chunks, ents, LAM,
                            fused_epilogue=fused,
                            in_kernel_gather=None if on else False))
            halves[sched] = {side: dict(
                rel_err=rel_err(out[side, False], out[side, True])[1],
                bit_equal=bool(torch.equal(out[side, False],
                                           out[side, True])))
                for side in ("movie", "user")}
            for side, v in halves[sched].items():
                self.check(v["rel_err"] < TOL["split_first_half"],
                           f"gather off ({sched}): first {side} half "
                           f"differs from gather on by {v['rel_err']}")
            del out
        report.update(first_halves_off_vs_on=halves, half_ms=half_ms)
        log(f"gather (Netflix): {report}")

        # -- rows 5, 7, 4 on the main path's chunks, the trained factors --
        u, m = model.user_factors, model.movie_factors
        st = ds.movie_blocks.statics
        args = with_plan(accum_chunk(blk_m, st, st[0] // 2), blk_m,
                         st[0] // 2)
        nb, wt = args.pop("nb"), args.pop("wt")
        g = gk.gather_rows(u, nb, wt)
        got = gk.gram_tiles(g, **args)
        sibling = gk.gram_gather(u, nb, wt, **args)
        torch.cuda.synchronize()
        want = gk.gram_tiles_plain(g, **args)
        errs = [rel_err(x, w) for x, w in zip(got, want)]
        nbytes, flops, counts = stream_gram_work(g, args)
        b_ms, by = bound(nbytes, flops)
        row = dict(max_abs_err=max(e[0] for e in errs),
                   rel_err=max(e[1] for e in errs),
                   equal_to_gram_gather=all(torch.equal(x, y) for x, y in
                                            zip(got, sibling)),
                   ms=time_ms(lambda: gk.gram_tiles(g, **args), 10),
                   plain_ms=time_ms(lambda: gk.gram_tiles_plain(g, **args),
                                    3),
                   gather_rows_ms=time_ms(lambda: gk.gather_rows(u, nb, wt),
                                          10),
                   library_ms=None, bound_ms=b_ms, bound_by=by, **counts)
        self.kernels["gram_tiles"].update(row)
        log(f"gram_tiles (row 5): {row}")
        self.check(row["rel_err"] < TOL["gram_tiles"],
                   f"gram_tiles rel err {row['rel_err']}")
        del g, got, sibling, want
        # Rows 7 and 4 on the middle dense chunk, with the carry the real
        # previous chunks hand it (as K3 and row 9 are checked).
        st = ds.user_blocks.statics
        mid = st[0] // 2
        a0 = torch.zeros((k, k), device=dev)
        b0 = torch.zeros((k,), device=dev)
        for ci in range(mid + 1):
            args = with_plan(dense_chunk(blk_u, st, ci), blk_u, ci)
            cin = args.pop("cin")
            nb, wt = args.pop("nb"), args.pop("wt")
            g = gk.gather_rows(m, nb, wt)
            carry = (a0, b0, cin)
            if ci < mid:
                _, a0, b0 = gk.gram_solve_tiles_dense(g, **args, lam=LAM,
                                                      carry=carry)
        gram_args = {n: v for n, v in args.items() if n not in ("reg",
                                                                "lseg")}
        for name, fn, plain, sib, kw, work in (
                ("gram_solve_tiles_dense", gk.gram_solve_tiles_dense,
                 gk.gram_solve_tiles_dense_plain, gk.gram_solve_dense,
                 dict(args, lam=LAM), "diag"),
                ("gram_tiles_dense", gk.gram_tiles_dense,
                 gk.gram_tiles_dense_plain, gk.gram_tiles_dense_gather,
                 gram_args, None)):
            got = fn(g, **kw, carry=carry)
            sibling = sib(m, nb, wt, **kw, carry=carry)
            torch.cuda.synchronize()
            want = plain(g, **kw, carry=carry)
            errs = [rel_err(x, w) for x, w in zip(got, want)]
            nbytes, flops, counts = stream_dense_work(g, kw, work)
            b_ms, by = bound(nbytes, flops)
            row = dict(
                max_abs_err=max(e[0] for e in errs),
                rel_err=max(e[1] for e in errs),
                equal_to_gather_sibling=all(torch.equal(x, y) for x, y in
                                            zip(got, sibling)),
                ms=time_ms(lambda: fn(g, **kw, carry=carry), 10),
                plain_ms=time_ms(lambda: plain(g, **kw, carry=carry), 3),
                library_ms=None, bound_ms=b_ms, bound_by=by, chunk=mid,
                **counts)
            self.kernels[name].update(row)
            log(f"{name}: {row}")
            self.check(row["rel_err"] < TOL[name],
                       f"{name} rel err {row['rel_err']}")
            del got, sibling, want
        del g
        # Where the time goes: rows 5 and 7 per chunk of the trained
        # factors beside the rows of each chunk's largest segment (one CTA
        # walks each segment), as the breakdown phase reads K2 and K3.
        report["chunks"] = self.stream_chunk_times(ds, u, m, blk_m, blk_u)
        log(f"gather (Netflix) per-chunk stream kernel times: "
            f"{report['chunks']}")
        self.report["gather"] = report

    def stream_chunk_times(self, ds, u, m, blk_m, blk_u):
        """Device ms of row 5 on every accum chunk and of row 7 on every
        dense chunk (each chunk's stream written first, outside the
        timing), with ns per row of the chunk's largest segment."""
        import numpy as np
        import torch

        from cfk_tpu_torch.ops.kernels import gram_kernel as gk
        from cfk_tpu_torch.ops.tiled import accum_chunk, dense_chunk

        def ms_of(call):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            return start, end

        st_m = ds.movie_blocks.statics
        events, big_m, work_m = [], [], []
        for c in range(st_m[0]):
            a = with_plan(accum_chunk(blk_m, st_m, c), blk_m, c)
            g = gk.gather_rows(u, a.pop("nb"), a.pop("wt"))
            events.append(ms_of(lambda: gk.gram_tiles(g, **a)))
            big_m.append(int(torch.bincount(a["seg"], minlength=st_m[4] + 1)
                             [:st_m[4]].max()) * st_m[2])
            work_m.append(stream_gram_work(g, a)[:2])
        torch.cuda.synchronize()
        ms_m = np.array([s.elapsed_time(e) for s, e in events])
        st_u = ds.user_blocks.statics
        _, _, _, t, nt, ng, _ = st_u
        events, big_u, work_u = [], [], []
        for c in range(st_u[0]):
            a = with_plan(dense_chunk(blk_u, st_u, c), blk_u, c)
            a.pop("cin")
            g = gk.gather_rows(m, a.pop("nb"), a.pop("wt"))
            events.append(ms_of(lambda: gk.gram_solve_tiles_dense(
                g, **a, lam=LAM)))
            meta = a["meta"].long()
            win = meta[ng + 2 * nt:ng + 3 * nt] - meta[ng + nt:ng + 2 * nt]
            big_u.append(int(torch.bincount(meta[ng + 3 * nt:],
                                            weights=win.double()).max()))
            work_u.append(stream_dense_work(g, a, "diag")[:2])
        torch.cuda.synchronize()
        ms_u = np.array([s.elapsed_time(e) for s, e in events])

        def summary(ms, big, work):
            big = np.array(big)
            return dict(total_ms=float(ms.sum()), median_ms=float(
                np.median(ms)), max_ms=float(ms.max()),
                bound_ms=float(sum(bound(b, f)[0] for b, f in work)),
                ns_per_row_of_largest_segment=float(
                    np.median(ms / np.maximum(big, 1)) * 1e6),
                corr_ms_vs_largest_segment=float(np.corrcoef(ms, big)[0, 1]))

        return dict(gram_tiles=summary(ms_m, big_m, work_m),
                    gram_solve_tiles_dense=summary(ms_u, big_u, work_u))

    def rank256(self, ds, model, blk_m, blk_u):
        """ALS-WR above the fused kernels' cap on the main path's dataset
        (phase 4d of the module docstring)."""
        import numpy as np
        import torch

        from cfk_tpu_torch import ALSConfig, train_als
        from cfk_tpu_torch.eval.metrics import mse_rmse_from_model
        from cfk_tpu_torch.models.als import init_user_factors
        from cfk_tpu_torch.ops.kernels import gram_kernel as gk
        from cfk_tpu_torch.ops.kernels.solve_kernel import (
            gauss_solve, gauss_solve_multi, reg_solve)
        from cfk_tpu_torch.ops.solve import batched_spd_solve
        from cfk_tpu_torch.ops.tiled import (
            accum_chunk, accum_grams, dense_chunk, tiled_half_step)

        dev = torch.device("cuda")
        k = R256["rank"]
        grams = (gk.gram_gather, gk.gram_tiles_dense_gather, gk.gram_tiles,
                 gk.gram_tiles_dense, gk.gather_rows)
        refused = (reg_solve, gk.gram_solve_dense, gk.gram_solve_gather,
                   gk.gram_solve_tiles, gk.gram_solve_tiles_dense,
                   gauss_solve, gauss_solve_multi)
        std = float(np.std(ds.coo_dense.rating.astype(np.float64)))
        report = dict(rank=k, lam=LAM, linalg_library=str(
            torch.backends.cuda.preferred_linalg_library()))
        launches = {}
        # -- the path: train_als at rank 256, gather on, then off -----------
        for name, gather, iters, needed in (
                ("gather_on", None, R256["iterations"],
                 ("gram_gather", "gram_tiles_dense_gather")),
                ("gather_off", False, R256["gather_off_iterations"],
                 ("gather_rows", "gram_tiles", "gram_tiles_dense"))):
            config = ALSConfig(rank=k, lam=LAM, num_iterations=iters,
                               seed=0, layout="tiled",
                               in_kernel_gather=gather)
            if name == "gather_on":
                # The path with overlap on (captured: cholesky_ex and the
                # cuBLAS triangular solves included) and off, bit-equal;
                # the counts are the serial run's, every launch through its
                # wrapper (its default route makes the same calls).
                run = self.pipeline_case("rank256", ds, config, None,
                                         implicit=False,
                                         timeline=False)[False]
                off = self.report["pipeline"]["rank256"]["off"]
                train_s, peak = off["train_s"], off["peak_device_bytes"]
                n = {fn.__name__: off["launches"].get(fn.__name__, 0)
                     for fn in grams + refused}
            else:
                torch.cuda.reset_peak_memory_stats()
                for fn in grams + refused:
                    fn.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run = train_als(ds, config, device=dev)
                torch.cuda.synchronize()
                train_s = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated()
                n = {fn.__name__: fn.launches for fn in grams + refused}
            launches[name] = n
            for kname in n:
                want_some = kname in needed
                self.check((n[kname] > 0) == want_some,
                           f"rank256 {name}: {kname} launched {n[kname]} "
                           f"times")
            u, m = run.user_factors, run.movie_factors
            self.check(tuple(u.shape) == (NETFLIX["num_users"], k)
                       and tuple(m.shape) == (NETFLIX["num_movies"], k)
                       and bool(torch.isfinite(u).all()
                                and torch.isfinite(m).all()),
                       f"rank256 {name}: factors {tuple(u.shape)} "
                       f"{tuple(m.shape)} or non-finite")
            mse, rmse = mse_rmse_from_model(run, ds)
            # One iteration does not yet reach the guard at this rank (RMSE
            # 1.511 against a 1.414 std on an H100, PERF.md §6): the
            # gather-off run is held to the gather-on one by its first movie
            # half, bit for bit, below.
            if iters > 1:
                self.check(rmse < std, f"rank256 {name}: train RMSE {rmse} "
                           f">= rating std {std}")
            report[name] = dict(
                iterations=iters, train_s=train_s, s_per_iter=train_s / iters,
                train_mse=mse, train_rmse=rmse, rating_std=std, launches=n,
                launches_per_iter={key: v / iters for key, v in n.items()},
                peak_device_bytes=peak)
            log(f"rank256 {name}: {report[name]}")
            del run, u, m
        torch.cuda.empty_cache()
        # -- the first movie half: gather off against on, and float64 --------
        em = ds.movie_blocks.padded_entities
        eu = ds.user_blocks.padded_entities
        st_m, st_u = ds.movie_blocks.statics, ds.user_blocks.statics
        mc, uc = ("tiled", "accum") + st_m, ("tiled", "dstream") + st_u
        u0, _ = init_user_factors(ds, blk_u, ALSConfig(rank=k, seed=0), dev,
                                  None)
        m_on = tiled_half_step(u0, blk_m, mc, em, LAM)
        m_off = tiled_half_step(u0, blk_m, mc, em, LAM, in_kernel_gather=False)
        report["first_movie_half_gather_off_bit_equal"] = bool(
            torch.equal(m_on, m_off))
        self.check(report["first_movie_half_gather_off_bit_equal"],
                   f"rank256: gather-off first movie half differs from "
                   f"gather-on by {rel_err(m_off, m_on)}")
        del m_off
        a, b = accum_grams(u0, blk_m, em, statics=st_m)
        ridge = LAM * blk_m["count"].to(torch.float32).clamp_min(1.0)
        a.diagonal(dim1=-2, dim2=-1).add_(ridge[:, None])  # as the half does
        diff = top = 0.0
        for lo in range(0, em, 2048):
            x64 = torch.linalg.solve(a[lo:lo + 2048].double(),
                                     b[lo:lo + 2048].double())
            diff = max(diff, float((m_on[lo:lo + 2048].double()
                                    - x64).abs().max()))
            top = max(top, float(x64.abs().max()))
        report["first_movie_half_vs_float64"] = diff / top
        self.check(diff / top < TOL["float64_r256"],
                   f"rank256: first movie half vs float64 {diff / top}")
        # -- the Cholesky route on the path's two batch shapes ---------------
        chol = dict(movie_systems=em, movie_ms=time_ms(
            lambda: batched_spd_solve(a, b), 3))
        del a, b
        torch.cuda.empty_cache()
        # -- the four split Gram kernels at k = 256, middle chunks -----------
        mid = st_m[0] // 2
        args = with_plan(accum_chunk(blk_m, st_m, mid), blk_m, mid)
        g = gk.gather_rows(u0, args["nb"], args["wt"])
        rest = {n: v for n, v in args.items() if n not in ("nb", "wt")}
        cases = {"gram_gather": (lambda: gk.gram_gather(u0, **args),
                                 lambda: gk.gram_gather_plain(u0, **args),
                                 gram_gather_work(u0, args)),
                 "gram_tiles": (lambda: gk.gram_tiles(g, **rest),
                                lambda: gk.gram_tiles_plain(g, **rest),
                                stream_gram_work(g, rest))}
        self.split_grams_r256(cases, mid, launches, "gram_gather")
        del g, cases
        mid = st_u[0] // 2
        a0 = torch.zeros((k, k), device=dev)
        b0 = torch.zeros((k,), device=dev)
        for ci in range(mid + 1):
            args = with_plan(dense_chunk(blk_u, st_u, ci), blk_u, ci)
            cin, lseg = args.pop("cin"), args.pop("lseg")
            reg = args.pop("reg")
            carry = (a0, b0, cin)
            if ci < mid:
                a, b = gk.gram_tiles_dense_gather(m_on, **args, carry=carry)
                a0 = a.index_select(0, lseg.long())[0]
                b0 = b.index_select(0, lseg.long())[0]
                del a, b
        g = gk.gather_rows(m_on, args["nb"], args["wt"])
        rest = {n: v for n, v in args.items() if n not in ("nb", "wt")}
        cases = {"gram_tiles_dense_gather": (
                     lambda: gk.gram_tiles_dense_gather(m_on, **args,
                                                        carry=carry),
                     lambda: gk.gram_tiles_dense_gather_plain(m_on, **args,
                                                              carry=carry),
                     gram_tiles_dense_gather_work(m_on, args)),
                 "gram_tiles_dense": (
                     lambda: gk.gram_tiles_dense(g, **rest, carry=carry),
                     lambda: gk.gram_tiles_dense_plain(g, **rest,
                                                       carry=carry),
                     stream_dense_work(g, rest))}
        a, b = self.split_grams_r256(cases, mid, launches,
                                     "gram_tiles_dense_gather")
        del g, cases
        a.diagonal(dim1=-2, dim2=-1).add_(
            (LAM * reg.to(torch.float32).clamp_min(1.0))[:, None])
        chol.update(dense_chunk_systems=int(a.shape[0]), dense_chunk_ms=(
            time_ms(lambda: batched_spd_solve(a, b), 3)))
        report["cholesky"] = chol
        log(f"rank256 Cholesky route ({report['linalg_library']}): {chol}")
        del a, b
        torch.cuda.empty_cache()
        # -- where one iteration's time goes --------------------------------
        movie = functools.partial(tiled_half_step, u0, blk_m, mc, em, LAM)
        user = functools.partial(tiled_half_step, m_on, blk_u, uc, eu, LAM)
        report["half_ms"] = {"movie_accum": time_ms(movie, 1),
                             "user_dstream": time_ms(user, 1)}
        report["profile"] = profile_calls(lambda: (movie(), user()), 1)
        log(f"rank256 halves {report['half_ms']} ms, profile of one "
            f"iteration: {report['profile']}")
        del movie, user, u0, m_on
        self.report["rank256"] = report

    def split_grams_r256(self, cases, chunk, launches, sibling):
        """Each split Gram kernel of ``cases`` (name → kernel call, plain
        call, (bytes, flops, counts)) at rank 256 against its plain version
        (TOL "gram_r256"), its stream twin bit-equal to the gather
        ``sibling``, with ms and bound: the kernels line's ``k256``.
        Returns the sibling's (A, b)."""
        import torch

        out = {}
        for name, (call, plain, (nbytes, flops, counts)) in cases.items():
            got = out[name] = call()
            torch.cuda.synchronize()
            want = plain()
            errs = [rel_err(x, y) for x, y in zip(got, want)]
            del want
            b_ms, by = bound(nbytes, flops)
            run = "gather_on" if name in ("gram_gather",
                                          "gram_tiles_dense_gather") \
                else "gather_off"
            row = dict(launches=launches[run][name],
                       max_abs_err=max(e[0] for e in errs),
                       rel_err=max(e[1] for e in errs), ms=time_ms(call, 5),
                       plain_ms=time_ms(plain, 2), bound_ms=b_ms,
                       bound_by=by, library_ms=None, chunk=chunk, **counts)
            if name != sibling:
                row["bit_equal_to_gather_sibling"] = all(
                    torch.equal(x, y) for x, y in zip(got, out[sibling]))
                self.check(row["bit_equal_to_gather_sibling"],
                           f"rank256: {name} not bit-equal to {sibling}")
            self.kernels.setdefault(name, {})["k256"] = row
            log(f"rank256 {name}: {row}")
            self.check(row["rel_err"] < TOL["gram_r256"],
                       f"rank256: {name} rel err {row['rel_err']}")
        return out[sibling]

    def segment(self, ds, model, blk_m, blk_u):
        """Phase 4e: explicit ALS-WR on the segment layout of the main
        phase's ratings (see the module doc)."""
        import numpy as np
        import torch

        from cfk_tpu_torch import ALSConfig, Dataset, train_als
        from cfk_tpu_torch.eval.metrics import mse_rmse_from_model
        from cfk_tpu_torch.models.als import (
            _segment_device_setup,
            init_user_factors,
        )
        from cfk_tpu_torch.ops.kernels.solve_kernel import reg_solve
        from cfk_tpu_torch.ops.solve import als_half_step_segment
        from cfk_tpu_torch.ops.tiled import tiled_half_step

        c = SEGMENT
        t0 = time.perf_counter()
        sds = Dataset.from_coo(ds.coo_dense, layout="segment",
                               chunk_elems=c["chunk_elems"])
        build_s = time.perf_counter() - t0
        smb, sub = sds.movie_blocks, sds.user_blocks
        log(f"segment data: blocks {build_s:.1f} s; movie {smb.statics} "
            f"({int(smb.carry_in.sum())} carried chunks), user "
            f"{sub.statics}")
        dev = torch.device("cuda")
        cfg = ALSConfig(rank=RANK, lam=LAM, num_iterations=c["iterations"],
                        seed=0, layout="segment")
        # The path with overlap on (captured) and off (the pipeline case),
        # bit-equal: each chunk's Gram is K2 on one-row tiles, whose work
        # units sum every segment in one order.  The counts are the serial
        # run's, whose every launch goes through its wrapper (the segment
        # layout is not captured by default, and its default route makes
        # the serial run's calls).
        smodel = self.pipeline_case("segment", sds, cfg, None,
                                    implicit=False, timeline=False)[False]
        run = self.report["pipeline"]["segment"]["off"]
        train_s, peak = run["train_s"], run["peak_device_bytes"]
        launches = run["launches"].get("reg_solve", 0)
        k2_launches = run["launches"].get("gram_gather", 0)
        chunks = c["iterations"] * (smb.num_chunks + sub.num_chunks)
        self.check(launches == chunks == k2_launches,
                   f"segment: K1 launched {launches} times, K2 "
                   f"{k2_launches}, {chunks} chunks")
        u, m = smodel.user_factors, smodel.movie_factors
        self.check(bool(torch.isfinite(u).all() and torch.isfinite(m).all()),
                   "segment: non-finite factors")
        mse, rmse = mse_rmse_from_model(smodel, sds)
        std = float(np.std(ds.coo_dense.rating.astype(np.float64)))
        self.check(rmse < std, f"segment: train RMSE {rmse} >= std {std}")
        # The first movie half from the tiled run's u0 (the same seed, the
        # same rating sums and counts), on both layouts.
        u0, _ = init_user_factors(sds, None, cfg, dev, None)
        mb = ds.movie_blocks
        tiled_first = tiled_half_step(u0, blk_m, ("tiled", mb.mode)
                                      + mb.statics, mb.padded_entities, LAM)
        sblk_m, sblk_u, kw = _segment_device_setup(sds, dev)
        seg_first = als_half_step_segment(u0, sblk_m, kw["m_chunks"],
                                          kw["m_entities"], LAM)
        first = rel_err(seg_first, tiled_first)[1]
        self.check(first < TOL["segment_first_half"],
                   f"segment: first movie half differs from the tiled "
                   f"run's by {first}")
        # The same calls again: two runs of one half give the same bits.
        again = als_half_step_segment(u0, sblk_m, kw["m_chunks"],
                                      kw["m_entities"], LAM)
        twice = dict(bit_equal=bool(torch.equal(again, seg_first)),
                     max_rel_diff=rel_err(again, seg_first)[1])
        self.report["pipeline"]["segment"]["first_half_twice"] = twice
        log(f"segment: the first movie half twice: {twice}")
        self.check(twice["bit_equal"], f"segment: the first movie half run "
                   f"twice differs by {twice['max_rel_diff']}")
        del tiled_first, seg_first, again
        k2_rows = self.segment_k2_checks(smodel, sds, sblk_m, sblk_u)
        win = [(min(c["profile_chunks"], st[0]),) + st[1:]
               for st in (kw["m_chunks"], kw["u_chunks"])]
        movie = functools.partial(als_half_step_segment, u, sblk_m, win[0],
                                  kw["m_entities"], LAM)
        user = functools.partial(als_half_step_segment, m, sblk_u, win[1],
                                 kw["u_entities"], LAM)
        t0 = time.perf_counter()
        prof = profile_calls(lambda: (movie(), user()), 1, cpu=False,
                             warm=False)
        prof["profile_s"] = time.perf_counter() - t0
        prof["window_chunks"] = win[0][0] + win[1][0]
        if "device_busy_ms" in prof:
            prof["device_ms_per_iter"] = (
                prof["device_busy_ms"] * (smb.num_chunks + sub.num_chunks)
                / prof["window_chunks"])
        self.report["segment"] = dict(
            chunk_elems=c["chunk_elems"], iterations=c["iterations"],
            blocks_s=build_s, train_s=train_s,
            s_per_iter=train_s / c["iterations"], train_mse=mse,
            train_rmse=rmse, rating_std=std, peak_device_bytes=peak,
            k1_launches=launches, chunks_per_half=dict(
                movie=smb.num_chunks, user=sub.num_chunks),
            chunk_cap=smb.chunk_cap, ec=dict(movie=smb.chunk_entities,
                                             user=sub.chunk_entities),
            carried_chunks=dict(movie=int(smb.carry_in.sum()),
                                user=int(sub.carry_in.sum())),
            first_movie_half_vs_tiled=first, first_half_twice=twice,
            k2_launches=k2_launches, k2_chunks=k2_rows, profile=prof)
        self.kernels.setdefault("reg_solve", {})["launches_segment"] = \
            launches
        self.kernels.setdefault("gram_gather", {})["segment"] = dict(
            k2_rows["movie_middle"], launches=k2_launches)
        log(f"segment: {self.report['segment']}")

    def segment_k2_checks(self, model, sds, sblk_m, sblk_u):
        """K2 on the middle chunk of each segment half (one-row tiles owned
        by ``seg_rel``, its staged plan, the carry of the chunk before it —
        that chunk's raw last segment): against its plain version (TOL
        "gram_gather"), launched twice (bit-equal), ms beside the plain
        version's, the bound and the route it replaced (the per-entry outer
        products summed by ``index_add_``, ``index_add_route_ms``)."""
        import torch

        from cfk_tpu_torch.ops.kernels.gram_kernel import (
            gram_gather, gram_gather_plain)
        from cfk_tpu_torch.ops.kernels.gram_units import chunk_plan

        rows = {}
        for side, blocks, blk, table in (
                ("movie", sds.movie_blocks, sblk_m, model.user_factors),
                ("user", sds.user_blocks, sblk_u, model.movie_factors)):
            nc, cap, e_c = blocks.statics
            c = nc // 2

            def run_args(ci, carry=None):
                sl = slice(ci * cap, (ci + 1) * cap)
                mk = blk["mask"][sl]
                return dict(nb=blk["neighbor_idx"][sl], wt=mk,
                            rt=blk["rating"][sl] * mk, seg=blk["seg_rel"][sl],
                            num_segments=e_c + 1, tile_rows=1, carry=carry,
                            units=chunk_plan(blk, ci))

            pa, pb = gram_gather_plain(table, **run_args(c - 1))
            last = int(blocks.last_seg[c - 1])
            args = run_args(c, (pa[last].contiguous(), pb[last].contiguous(),
                                blk["carry_in"][c:c + 1]))
            got = gram_gather(table, **args)
            again = gram_gather(table, **args)
            torch.cuda.synchronize()
            want = gram_gather_plain(table, **args)
            errs = [rel_err(g, w) for g, w in zip(got, want)]
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            ms = time_ms(lambda: gram_gather(table, **args), 10)
            plain_ms = time_ms(lambda: gram_gather_plain(table, **args), 3)

            def index_add_route():
                f = table[args["nb"].long()] * args["wt"][:, None]
                return f.new_zeros((e_c + 1, f.shape[1], f.shape[1])) \
                    .index_add_(0, args["seg"], f[:, :, None] * f[:, None, :])

            old_ms = time_ms(index_add_route, 3)
            nbytes, flops, counts = gram_gather_work(table, args)
            b_ms, by = bound(nbytes, flops)
            row = dict(max_abs_err=max(x[0] for x in errs),
                       rel_err=max(x[1] for x in errs), ms=ms,
                       plain_ms=plain_ms, library_ms=None,
                       index_add_route_ms=old_ms, bound_ms=b_ms, bound_by=by,
                       chunk=c, two_launches_bit_equal=same,
                       units=int((args["units"].units[:, 0] >= 0).sum()),
                       split_segments=int((args["units"].splits >= 0).sum()),
                       **counts)
            rows[f"{side}_middle"] = row
            log(f"segment K2 on the {side} half's chunk {c}: {row}")
            self.check(row["rel_err"] < TOL["gram_gather"],
                       f"segment K2 {side} chunk {c} rel err "
                       f"{row['rel_err']}")
            self.check(same, f"segment K2 {side} chunk {c}: two launches "
                       "differ")
            del got, again, want, pa, pb
        return rows

    def segment_implicit(self, ds_t, ds_b, ds_s, u0, m0, runs):
        """Phase 6e: one warm-started iALS call on the segment layout of the
        implicit phase's ratings (see the module doc)."""
        import numpy as np
        import torch

        from cfk_tpu_torch import Dataset
        from cfk_tpu_torch.models.als import _segment_device_setup
        from cfk_tpu_torch.models.ials import IALSConfig, train_ials
        from cfk_tpu_torch.ops.kernels.gram_kernel import gram_gather
        from cfk_tpu_torch.ops.kernels.solve_kernel import reg_solve
        from cfk_tpu_torch.ops.solve import ials_half_step_segment

        c = IMPLICIT
        t0 = time.perf_counter()
        sds = Dataset.from_coo(ds_t.coo_dense, layout="segment",
                               chunk_elems=SEGMENT["chunk_elems"])
        build_s = time.perf_counter() - t0
        smb, sub = sds.movie_blocks, sds.user_blocks
        dev = torch.device("cuda")
        cfg = IALSConfig(rank=c["rank"], lam=c["lam"], alpha=c["alpha"],
                         num_iterations=1, layout="segment")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reg_solve.launches = gram_gather.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = train_ials(sds, cfg, device=dev, warm_start=(u0, m0))
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        launches, k2_launches = reg_solve.launches, gram_gather.launches
        peak = torch.cuda.max_memory_allocated()
        chunks = smb.num_chunks + sub.num_chunks
        self.check(launches == chunks == k2_launches, f"segment_ml25m: K1 "
                   f"launched {launches} times, K2 {k2_launches}, {chunks} "
                   "chunks")
        u, m = model.user_factors, model.movie_factors
        self.check(bool(torch.isfinite(u).all() and torch.isfinite(m).all()),
                   "segment_ml25m: non-finite factors")
        d = ds_t.coo_dense
        obs = [torch.as_tensor(x, device=dev) for x in (
            d.user_raw.astype(np.int32), d.movie_raw.astype(np.int32),
            d.rating)]
        j0 = implicit_objective(torch.as_tensor(u0, device=dev),
                                torch.as_tensor(m0, device=dev), *obs,
                                c["lam"], c["alpha"])
        j1 = implicit_objective(u, m, *obs, c["lam"], c["alpha"])
        self.check(j1 < j0, f"segment_ml25m: objective {j0} -> {j1}")
        nm = ML25M["num_movies"]
        count = torch.bincount(obs[1].long(), minlength=nm)
        sample = torch.cat([torch.topk(count, 5).indices, torch.as_tensor(
            np.random.default_rng(0).choice(nm, 5, replace=False),
            device=dev)])
        ref = first_half_reference(u0, obs[1], obs[0], obs[2], sample,
                                   c["lam"], c["alpha"])
        got = m[sample].double()
        vs64 = ((got - ref).abs().amax(1) / ref.abs().amax(1)).tolist()
        self.check(max(vs64) < TOL["first_half_factors"],
                   f"segment_ml25m: first movie half vs float64 {vs64}")
        del obs
        sblk_m, sblk_u, kw = _segment_device_setup(sds, dev)
        half = functools.partial(ials_half_step_segment, lam=c["lam"],
                                 alpha=c["alpha"])
        t0 = time.perf_counter()
        prof = profile_calls(lambda: (
            half(u, sblk_m, kw["m_chunks"], kw["m_entities"]),
            half(m, sblk_u, kw["u_chunks"], kw["u_entities"])), 1,
            cpu=False, warm=False)
        prof["profile_s"] = time.perf_counter() - t0
        self.report["segment_ml25m"] = dict(
            blocks_s=build_s, call_s=call_s, objective=[j0, j1],
            peak_device_bytes=peak, k1_launches=launches,
            k2_launches=k2_launches,
            chunks_per_half=dict(movie=smb.num_chunks, user=sub.num_chunks),
            chunk_cap=smb.chunk_cap, ec=dict(movie=smb.chunk_entities,
                                             user=sub.chunk_entities),
            first_half_vs_float64=dict(movies=sample.tolist(), rel=vs64),
            profile=prof)
        self.kernels.setdefault("reg_solve", {})[
            "launches_segment_implicit"] = launches
        log(f"segment_ml25m: {self.report['segment_ml25m']}")

    def quant(self, ds, model, blk_m, blk_u):
        """Phase 4f: quantized training on the main phase's blocks (see the
        module doc)."""
        import torch

        from cfk_tpu_torch import ALSConfig, train_als
        from cfk_tpu_torch.eval.metrics import mse_rmse_from_model
        from cfk_tpu_torch.models.als import init_user_factors
        from cfk_tpu_torch.ops.kernels import gram_kernel as gk
        from cfk_tpu_torch.ops.kernels.solve_kernel import reg_solve
        from cfk_tpu_torch.ops.tiled import tiled_half_step

        c = QUANT
        dev = torch.device("cuda")
        kernels = (gk.gather_rows, gk.gram_gather, gk.gram_solve_dense,
                   gk.gram_tiles_dense_gather, gk.gram_solve_gather,
                   gk.gram_tiles, gk.gram_solve_tiles, gk.gram_tiles_dense,
                   gk.gram_solve_tiles_dense, reg_solve)
        mb, ub = ds.movie_blocks, ds.user_blocks
        mc, uc = (("tiled", b.mode) + b.statics for b in (mb, ub))
        em, eu = mb.padded_entities, ub.padded_entities
        report = {}
        for name, kw in (("float32", {}),
                         ("table_bfloat16", dict(table_dtype="bfloat16")),
                         ("table_int8", dict(table_dtype="int8")),
                         ("dtype_bfloat16", dict(dtype="bfloat16"))):
            cfg = ALSConfig(rank=RANK, lam=LAM,
                            num_iterations=c["iterations"], seed=0,
                            layout="tiled", **kw)
            for fn in kernels:
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run = train_als(ds, cfg, device=dev)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            launches = {fn.__name__: fn.launches for fn in kernels}
            for kname in ("reg_solve", "gram_gather", "gram_solve_dense"):
                self.check(launches[kname] > 0, f"quant {name}: {kname} "
                           f"launched {launches[kname]} times")
            u, m = run.user_factors, run.movie_factors
            self.check(bool(torch.isfinite(u).all()
                            and torch.isfinite(m).all()),
                       f"quant {name}: non-finite factors")
            _, rmse = mse_rmse_from_model(run, ds)
            td = kw.get("table_dtype", "float32")
            movie = functools.partial(tiled_half_step, u, blk_m, mc, em, LAM,
                                      table_dtype=td)
            user = functools.partial(tiled_half_step, m, blk_u, uc, eu, LAM,
                                     table_dtype=td)
            report[name] = dict(
                iterations=c["iterations"], train_s=train_s,
                s_per_iter=train_s / c["iterations"], train_rmse=rmse,
                factor_dtype=str(u.dtype), launches=launches,
                profile=profile_calls(lambda: (movie(), user()), 1))
            log(f"quant {name}: {report[name]}")
            del run, u, m, movie, user
        for name, limit in c["rmse_ratio"].items():
            ratio = (report[name]["train_rmse"]
                     / report["float32"]["train_rmse"])
            report[name]["rmse_ratio_vs_float32"] = ratio
            self.check(ratio <= limit, f"quant {name}: train RMSE ratio "
                       f"{ratio} > {limit}")
        # The first halves with the gather off against on, from u0.
        u0, _ = init_user_factors(ds, blk_u, ALSConfig(rank=RANK, seed=0),
                                  dev, None)
        halves = {}
        for td in ("bfloat16", "int8"):
            out = {}
            for on in (True, False):
                knob = None if on else False
                out["movie", on] = tiled_half_step(
                    u0, blk_m, mc, em, LAM, table_dtype=td,
                    in_kernel_gather=knob)
                out["user", on] = tiled_half_step(
                    out["movie", True], blk_u, uc, eu, LAM, table_dtype=td,
                    in_kernel_gather=knob)
            halves[td] = {side: bool(torch.equal(out[side, True],
                                                 out[side, False]))
                          for side in ("movie", "user")}
            for side, same in halves[td].items():
                self.check(same, f"quant {td}: first {side} half with the "
                           "gather off differs from on")
            del out
        report["first_halves_off_bit_equal_on"] = halves
        log(f"quant first halves, gather off vs on bit-equal: {halves}")
        report["kernels"] = self.quant_kernel_checks(ds, model, blk_m, blk_u)
        self.report["quant"] = report

    def quant_kernel_checks(self, ds, model, blk_m, blk_u):
        """Rows 2-10 on the trained factors quantized to bf16 and to int8,
        and in float32 on the same operands for comparison: the middle
        accum chunk (K2, K6, K5, rows 5 and 6) and the middle dense chunk
        (K3, row 9, K5, rows 4 and 7, with the carry its previous chunks
        hand it), each launched twice, held to its plain version and each
        stream twin to its gather sibling; ms beside the bound at the
        table's element size (phase 4f)."""
        import torch

        from cfk_tpu_torch.ops.kernels import gram_kernel as gk
        from cfk_tpu_torch.ops.quant import fold_scale, quantize_table
        from cfk_tpu_torch.ops.tiled import accum_chunk, dense_chunk

        dev = torch.device("cuda")
        k = RANK
        u, m = model.user_factors, model.movie_factors
        st_m, st_u = ds.movie_blocks.statics, ds.user_blocks.statics
        mid_m, mid_u = st_m[0] // 2, st_u[0] // 2
        out = {}

        def check(name, td, fn, plain, bound_, sibling=None):
            got, again = fn(), fn()
            torch.cuda.synchronize()
            want = plain()
            got_t, again_t, want_t = (x if isinstance(x, tuple) else (x,)
                                      for x in (got, again, want))
            errs = [rel_err(x.float(), w.float())
                    for x, w in zip(got_t, want_t)]
            b_ms, by = bound_
            row = dict(max_abs_err=max(e[0] for e in errs),
                       rel_err=max(e[1] for e in errs),
                       two_launches_bit_equal=all(
                           torch.equal(x, y) for x, y in zip(got_t, again_t)),
                       ms=time_ms(fn, 10), plain_ms=time_ms(plain, 2),
                       bound_ms=b_ms, bound_by=by)
            if sibling is not None:
                row["equal_to_gather_sibling"] = all(
                    torch.equal(x, y) for x, y in zip(got_t, sibling))
                self.check(row["equal_to_gather_sibling"],
                           f"quant {td} {name}: differs from its sibling")
            out.setdefault(name, {})[td] = row
            if td != "float32":
                short = "bf16" if td == "bfloat16" else td
                self.kernels.setdefault(name, {}).update({
                    f"ms_{short}": row["ms"], f"bound_ms_{short}": b_ms,
                    f"bound_by_{short}": by})
            log(f"quant {td} {name}: {row}")
            self.check(row["rel_err"] <= TOL[name],
                       f"quant {td} {name}: rel err {row['rel_err']}")
            self.check(row["two_launches_bit_equal"],
                       f"quant {td} {name}: two launches differ")
            return got_t

        for td in ("float32", "bfloat16", "int8"):
            data_u, scale_u = quantize_table(u, td)
            data_m, scale_m = quantize_table(m, td)
            # The middle accum chunk: K2, K5, row 5; K6 and row 6 with the
            # chunk's rows per segment as the diag ridge's counts.
            a = with_plan(accum_chunk(blk_m, st_m, mid_m), blk_m, mid_m)
            nb, wt = a.pop("nb"), a.pop("wt")
            wt = fold_scale(wt, scale_u, nb)
            full = dict(a, nb=nb, wt=wt)
            gram = check("gram_gather", td,
                         lambda: gk.gram_gather(data_u, nb, wt, **a),
                         lambda: gk.gram_gather_plain(data_u, nb, wt, **a),
                         quant_bound(gram_gather_work(data_u, full), td, k,
                                     gram_rows="live_rows"))
            g = check("gather_rows", td,
                      lambda: gk.gather_rows(data_u, nb, wt),
                      lambda: gk.gather_rows_plain(data_u, nb, wt),
                      quant_bound(gather_rows_work(data_u, nb, wt), td, k,
                                 out=gk.stream_dtype(data_u)))[0]
            check("gram_tiles", td, lambda: gk.gram_tiles(g, **a),
                  lambda: gk.gram_tiles_plain(g, **a),
                  quant_bound(stream_gram_work(g, a), td, k,
                              gram_rows="live_rows", stream=g),
                  sibling=gram)
            s = a["num_segments"]
            rows = (torch.bincount(a["seg"].long(), minlength=s)
                    * a["tile_rows"]).to(torch.int32)
            sa = dict(a, reg=rows, lseg=s - 2, lam=LAM)
            solved = check(
                "gram_solve_gather", td,
                lambda: gk.gram_solve_gather(data_u, nb, wt, **sa),
                lambda: gk.gram_solve_gather_plain(data_u, nb, wt, **sa),
                quant_bound(gram_solve_gather_work(
                    data_u, dict(sa, nb=nb, wt=wt), "diag"), td, k,
                    gram_rows="live_entries"))
            check("gram_solve_tiles", td,
                  lambda: gk.gram_solve_tiles(g, **sa),
                  lambda: gk.gram_solve_tiles_plain(g, **sa),
                  quant_bound(stream_gram_work(g, sa, "diag"), td, k,
                              gram_rows="live_rows", stream=g),
                  sibling=solved)
            del g, gram, solved
            # The middle dense chunk with its real carry (K3 on the
            # quantized table over the chunks before it); explicit ALS has
            # unit weights, an int8 chunk its bare scale stream.
            a0 = torch.zeros((k, k), device=dev)
            b0 = torch.zeros((k,), device=dev)
            for ci in range(mid_u + 1):
                d = with_plan(dense_chunk(blk_u, st_u, ci), blk_u, ci)
                cin, nb, wt = d.pop("cin"), d.pop("nb"), d.pop("wt")
                if scale_m is not None:
                    wt = fold_scale(torch.ones(nb.shape, device=dev),
                                    scale_m, nb)
                carry = (a0, b0, cin)
                if ci < mid_u:
                    _, a0, b0 = gk.gram_solve_dense(data_m, nb, wt, **d,
                                                    lam=LAM, carry=carry)
            dg = {n: v for n, v in d.items() if n not in ("reg", "lseg")}
            # An int8 chunk's bare scale stream: weights the f32 call lacks.
            extra_wt = 0 if wt is None else nb.numel()
            solved = check(
                "gram_solve_dense", td,
                lambda: gk.gram_solve_dense(data_m, nb, wt, **d, lam=LAM,
                                            carry=carry),
                lambda: gk.gram_solve_dense_plain(data_m, nb, wt, **d,
                                                  lam=LAM, carry=carry),
                quant_bound(gram_solve_dense_work(data_m, dict(d, nb=nb)),
                            td, k, gram_rows="window_rows",
                            weights=extra_wt))
            gram = check(
                "gram_tiles_dense_gather", td,
                lambda: gk.gram_tiles_dense_gather(data_m, nb, wt, **dg,
                                                   carry=carry),
                lambda: gk.gram_tiles_dense_gather_plain(
                    data_m, nb, wt, **dg, carry=carry),
                quant_bound(gram_tiles_dense_gather_work(
                    data_m, dict(d, nb=nb)), td, k, gram_rows="window_rows",
                    weights=extra_wt))
            g = gk.gather_rows(data_m, nb, wt)
            check("gram_tiles_dense", td,
                  lambda: gk.gram_tiles_dense(g, **dg, carry=carry),
                  lambda: gk.gram_tiles_dense_plain(g, **dg, carry=carry),
                  quant_bound(stream_dense_work(g, dg), td, k,
                              gram_rows="live_window_rows", stream=g),
                  sibling=gram)
            check("gram_solve_tiles_dense", td,
                  lambda: gk.gram_solve_tiles_dense(g, **d, lam=LAM,
                                                    carry=carry),
                  lambda: gk.gram_solve_tiles_dense_plain(
                      g, **d, lam=LAM, carry=carry),
                  quant_bound(stream_dense_work(g, d, "diag"), td, k,
                              gram_rows="live_window_rows", stream=g),
                  sibling=solved)
            del g, gram, solved, data_u, data_m
        return out

    def quant_implicit(self, ds_t, ds_b, ds_s, u0, m0, runs):
        """Phase 6f: iALS (b) with an int8 table, and (b)'s gather-off
        half-steps walked whole and in ``chunk_rows`` pieces (see the
        module doc)."""
        import numpy as np
        import torch

        from cfk_tpu_torch.models.als import _bucketed_to_device
        from cfk_tpu_torch.models.ials import IALSConfig, train_ials
        from cfk_tpu_torch.ops import bucketed
        from cfk_tpu_torch.ops.kernels import gram_kernel as gk
        from cfk_tpu_torch.ops.solve import ials_half_step_bucketed

        c = IMPLICIT
        dev = torch.device("cuda")
        k = c["rank"]
        d = ds_t.coo_dense
        obs = [torch.as_tensor(x, device=dev) for x in (
            d.user_raw.astype(np.int32), d.movie_raw.astype(np.int32),
            d.rating)]
        j0 = self.report["implicit"]["objective_init"]
        cfg = IALSConfig(rank=k, lam=c["lam"], alpha=c["alpha"],
                         num_iterations=1, layout="bucketed",
                         table_dtype="int8")
        gk.gram_solve_gather.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = train_ials(ds_b, cfg, device=dev, warm_start=(u0, m0))
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        launches = gk.gram_solve_gather.launches
        obj = implicit_objective(model.user_factors, model.movie_factors,
                                 *obs, c["lam"], c["alpha"])
        f32 = self.report["implicit"]["ials_bucketed"]["objective"][0]
        report = dict(int8_call_s=call_s, int8_k6_launches=launches,
                      objective_init=j0, int8_objective=obj,
                      float32_objective=f32,
                      int8_vs_float32_objective=obj / f32,
                      int8_scores_vs_float32=score_rel_err(
                          (model.user_factors, model.movie_factors),
                          runs["ials_bucketed"][0], obs[0], obs[1]))
        self.check(launches > 0, f"quant_ml25m int8 (b): K6 launched "
                   f"{launches} times")
        self.check(obj < j0, f"quant_ml25m int8 (b): objective {obj} did "
                   f"not fall below the start's {j0}")
        del model
        # (b)'s gather-off iteration from u0, each width class walked whole
        # (one piece a class) and in the blocks' chunk_rows pieces.
        mtrees, mchunks = _bucketed_to_device(ds_b.movie_blocks, dev)
        utrees, uchunks = _bucketed_to_device(ds_b.user_blocks, dev)
        streams = []
        real = bucketed.gather_rows

        def spy(table, nb, wt=None, out_dtype=None, out=None):
            streams.append(nb.numel())
            return real(table, nb, wt, out_dtype, out)

        walks = {}
        bucketed.gather_rows = spy
        try:
            for walk, (cm, cu) in (("whole", (None, None)),
                                   ("chunk_rows", (mchunks, uchunks))):
                streams.clear()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                mv = ials_half_step_bucketed(
                    torch.as_tensor(u0, device=dev), mtrees,
                    ds_b.movie_blocks.padded_entities, c["lam"], c["alpha"],
                    chunk_rows=cm, in_kernel_gather=False)
                us = ials_half_step_bucketed(
                    mv, utrees, ds_b.user_blocks.padded_entities, c["lam"],
                    c["alpha"], chunk_rows=cu, in_kernel_gather=False)
                torch.cuda.synchronize()
                walks[walk] = dict(
                    s=time.perf_counter() - t0, factors=(us, mv),
                    peak_device_bytes=torch.cuda.max_memory_allocated() - base,
                    k5_launches=len(streams),
                    largest_stream_bytes=max(streams) * k * 4)
        finally:
            bucketed.gather_rows = real
        same = all(torch.equal(x, y) for x, y in zip(
            walks["whole"].pop("factors"), walks["chunk_rows"].pop("factors")))
        report.update(gather_off_walks=walks, gather_off_bit_equal=same)
        self.check(same, "quant_ml25m: (b) gather off, chunk_rows pieces "
                   "differ from whole classes")
        log(f"quant_ml25m: {report}")
        self.report["quant_ml25m"] = report

    def serve(self):
        import numpy as np
        import torch

        from cfk_tpu_torch.data.synthetic import serve_factors, serve_seen_csr
        from cfk_tpu_torch.serving import (
            RecommendServer,
            ServeClient,
            ServeEngine,
            default_two_stage_params,
            ensure_serve_topics,
            recall_at_k,
            run_open_loop,
            warm_serve_programs,
            zipf_user_rows,
        )
        from cfk_tpu_torch.serving import engine as engine_mod
        from cfk_tpu_torch.serving import twostage as twostage_mod
        from cfk_tpu_torch.serving.topk_kernel import (
            topk_scores,
            topk_scores_plain,
        )
        from cfk_tpu_torch.transport.broker import InMemoryBroker

        sys.path.insert(0, str(ROOT / "tests"))
        from _torch_topk import compare_topk

        s = SERVE
        nu, nm, k = s["num_users"], s["num_movies"], s["k"]
        t0 = time.perf_counter()
        # bench.py run_serve's seeds at --seed 0: traffic 3, pool 1, data 2
        traffic = zipf_user_rows(nu, s["requests"], seed=3)
        pool = np.concatenate([zipf_user_rows(nu, 4096, seed=1), traffic])
        rng = np.random.default_rng(2)
        u, m = serve_factors(nu, nm, s["rank"], rng)
        seen, indptr = serve_seen_csr(nu, nm, s["nnz"], pool, rng)
        _, probe = default_two_stage_params(nm, clusters=s["clusters"])
        self.report["serve_setup"] = dict(
            generate_s=time.perf_counter() - t0, seen_cells=int(indptr[-1]),
            probe_clusters=probe, **s)
        # Record K4's arguments inside engine.topk: the parity, memory and
        # timing checks below run K4 on exactly what the engine gave it.
        captured = {}

        def recording(*a, **kw):
            captured["call"] = (a, kw)
            return topk_scores(*a, **kw)

        engine_mod.topk_scores = twostage_mod.topk_scores = recording
        engines, rows, launches_total = {}, [], 0
        try:
            for mode, td, b in SERVE_CONFIGS:
                key = (mode, td)
                if key not in engines:
                    t1 = time.perf_counter()
                    engines[key] = ServeEngine(
                        u, m, num_users=nu, num_movies=nm, seen_movies=seen,
                        seen_indptr=indptr, table_dtype=td,
                        tile_m=s["tile_m"], serve_mode=mode,
                        clusters=s["clusters"] if mode == "two_stage" else None,
                        probe_clusters=probe if mode == "two_stage" else None,
                        device="cuda")
                    warm = engines[key].prewarm(k, max_batch=256,
                                                user_rows=pool)
                    log(f"serve engine {key}: built + prewarmed in "
                        f"{time.perf_counter() - t1:.1f} s ({warm})")
                eng = engines[key]
                qrows = pool[:b]
                # -- the main path: engine + request server, counted --------
                topk_scores.launches = 0
                vals, ids = eng.topk(qrows, k)
                call = captured["call"]
                scan = dict(eng.last_scan)
                times = []
                for _ in range(5):
                    t1 = time.perf_counter()
                    eng.topk(qrows, k)
                    times.append(time.perf_counter() - t1)
                batch_s = min(times)
                broker = InMemoryBroker()
                ensure_serve_topics(broker)
                server = RecommendServer(eng, broker, max_batch=b)
                client = ServeClient(broker)
                warm_serve_programs(client, server, pool, k, b)
                report = run_open_loop(
                    client, rate_qps=max(0.7 * b / batch_s, 1.0),
                    num_requests=s["requests"], user_rows=traffic, k=k,
                    server=server, drive_server=True)
                launches = topk_scores.launches
                launches_total += launches
                name = f"{mode}/{td}/B{b}"
                self.check(launches > 0, f"serve {name}: K4 launched "
                           f"{launches} times")
                self.check(report.answered == report.num_requests,
                           f"serve {name}: answered {report.answered} of "
                           f"{report.num_requests}")
                self.check(bool(np.isfinite(vals).all())
                           and vals.shape == (b, k) and (ids >= 0).all(),
                           f"serve {name}: non-finite or short results")
                # -- K4 against its plain version on the same arguments -----
                a, kw = call
                got = topk_scores(*a, **kw)
                torch.cuda.synchronize()
                want = topk_scores_plain(*a, **kw)
                ext = topk_scores_plain(*a, **dict(kw, k_top=k + 1))
                exact = td in ("float32", "int8")
                par = compare_topk(*got, *want, ext[0], tol=TOL[
                    "topk_exact" if exact else "topk_scores"])
                if exact:
                    par["ok"] &= bool(torch.equal(got[0], want[0])
                                      and torch.equal(got[1], want[1]))
                self.check(par["ok"], f"serve {name}: K4 vs plain {par}")
                row = dict(mode=mode, table_dtype=td, batch=b,
                           k4_rows=int(a[1].shape[0]),
                           seen_width=0 if a[3] is None else int(a[3].shape[2]),
                           max_abs_err=par["max_abs_err"],
                           rel_err=par["rel_err"],
                           id_mismatches_vs_plain=par["id_mismatches"])
                dense = dense_route(a, kw)
                if mode == "exact":  # the engine's ids against the dense route
                    dv, di = dense(k + 1)
                    dr = compare_topk(vals, ids, dv[:, :k], di[:, :k], dv,
                                      tol=TOL["topk_scores"])
                    row["id_mismatches_vs_dense"] = dr["id_mismatches"]
                    self.check(dr["ok"], f"serve {name}: engine vs dense {dr}")
                # -- no [B, M] score matrix during one K4 call --------------
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                topk_scores(*a, **kw)
                torch.cuda.synchronize()
                growth = torch.cuda.max_memory_allocated() - base
                dense_bytes = b * a[1].shape[0] * 4
                row.update(k4_alloc_bytes=growth, dense_bytes=dense_bytes)
                self.check(growth < dense_bytes, f"serve {name}: K4 allocated "
                           f"{growth} B >= B·M_pad·4 = {dense_bytes}")
                # -- times and the bound ------------------------------------
                nbytes, flops, counts = topk_scores_work(a, kw, b)
                b_ms, by = bound(nbytes, flops, BF16_TC_FLOPS_PER_S
                                 if td == "bfloat16" else FP32_FLOPS_PER_S)
                row.update(**counts)
                passes = kernels_ms(lambda: topk_scores(*a, **kw), 20,
                                    "topk_partial_kernel", "topk_merge_kernel")
                row.update(
                    pass1_ms=passes["topk_partial_kernel"],
                    pass2_ms=passes["topk_merge_kernel"],
                    ms=time_ms(lambda: topk_scores(*a, **kw), 20),
                    plain_ms=time_ms(lambda: topk_scores_plain(*a, **kw), 3),
                    library_ms=time_ms(dense, 10), bound_ms=b_ms, bound_by=by,
                    launches=launches, engine_batch_ms=batch_s * 1e3,
                    capacity_qps=b / batch_s, open_loop=report.as_row(),
                    bytes_scanned_per_batch=scan["bytes_scanned_per_batch"])
                if mode == "two_stage":
                    self.check(scan["serve_mode"] == "two_stage",
                               f"serve {name}: ran {scan['serve_mode']}")
                    _, oracle = eng.topk(qrows, k, force_exact=True)
                    recall = recall_at_k(ids, oracle)
                    row.update(
                        recall_at_k=recall,
                        fallbacks=eng.two_stage_fallbacks,
                        shortlist_rows=scan.get("shortlist_rows"),
                        shortlist_rows_padded=scan.get(
                            "shortlist_rows_padded"),
                        exact_bytes_scanned_per_batch=eng.last_scan[
                            "bytes_scanned_per_batch"])
                    self.check(recall >= 0.95 and eng.two_stage_fallbacks == 0,
                               f"serve {name}: recall@{k} {recall}, "
                               f"{eng.two_stage_fallbacks} fallbacks")
                if b == 256 and td == "float32":
                    row["profile"] = profile_calls(lambda: eng.topk(qrows, k),
                                                   5)
                log(f"serve {name}: {row}")
                rows.append(row)
            self.serve_large_k(engines, pool, captured)
        finally:
            engine_mod.topk_scores = twostage_mod.topk_scores = topk_scores
        self.report["serve"] = rows
        head = next(r for r in rows if (r["mode"], r["table_dtype"],
                                        r["batch"]) == ("exact", "float32",
                                                        256))
        self.kernels.setdefault("topk_scores", {}).update(
            {key: head[key] for key in ("ms", "plain_ms", "library_ms",
                                        "bound_ms", "bound_by")},
            launches=launches_total,
            max_abs_err=max(r["max_abs_err"] for r in rows),
            configs=[{"config": f"{r['mode']}/{r['table_dtype']}/B{r['batch']}",
                      **{key: r[key] for key in (
                          "ms", "pass1_ms", "pass2_ms", "bound_ms",
                          "bound_by", "library_ms")}} for r in rows])
        # -- K4 above the earlier kernel's rank cap (512), every table kind --
        from cfk_tpu_torch.ops.quant import quantize_table

        rng = np.random.default_rng(600)
        ut = torch.as_tensor(rng.standard_normal((40, 600), np.float32),
                             device="cuda")
        tbl = torch.as_tensor(rng.standard_normal((1536, 600), np.float32),
                              device="cuda")
        high = {}
        for td in ("float32", "bfloat16", "int8"):
            data, sc = quantize_table(tbl, td)
            kw = dict(k_top=k, num_movies=1500, tile_m=256)
            got = topk_scores(ut, data, sc, None, **kw)
            torch.cuda.synchronize()
            want = topk_scores_plain(ut, data, sc, None, **kw)
            ext = topk_scores_plain(ut, data, sc, None, **dict(kw, k_top=k + 1))
            par = compare_topk(*got, *want, ext[0], tol=TOL["topk_scores"])
            high[td] = par
            self.check(par["ok"], f"serve: K4 at rank 600 ({td}) vs plain "
                       f"{par}")
        self.report["serve_rank600"] = high
        log(f"serve: K4 at rank 600 vs plain {high}")

    def serve_large_k(self, engines, pool, captured):
        """K above the two-launch K4 route's cap (``LARGE_K``): one batch
        through ``ServeEngine.topk`` per table kind, the three large-K
        launches counted (zeroed just before, read just after) and the
        two-launch route's held at 0; K4's recorded arguments through the
        wrapper again, exactly equal (values and ids) to
        ``topk_scores_plain`` and to the engine's answer; each launch's
        device ms beside the whole call's, the plain version, the bound and
        ``torch.topk(addmm)`` at the same K.  The route writes a [B, M_pad]
        key workspace by design, so the serve configurations' no-score-
        matrix check does not apply to it."""
        import numpy as np
        import torch

        from cfk_tpu_torch.serving.topk_kernel import (
            topk_scores, topk_scores_large_k, topk_scores_plain)

        k, b = LARGE_K["k"], LARGE_K["batch"]
        rows = []
        for td in LARGE_K["table_dtypes"]:
            eng = engines[("exact", td)]
            name = f"exact/{td}/B{b}/K{k}"
            topk_scores.launches = topk_scores_large_k.launches = 0
            vals, ids = eng.topk(pool[:b], k)
            launches = topk_scores_large_k.launches
            self.check(launches == 3 and topk_scores.launches == 0,
                       f"serve {name}: {launches} large-K launches, "
                       f"{topk_scores.launches} two-launch ones")
            a, kw = captured["call"]
            got = topk_scores(*a, **kw)
            torch.cuda.synchronize()
            want = topk_scores_plain(*a, **kw)
            exact = bool(torch.equal(got[0], want[0])
                         and torch.equal(got[1], want[1]))
            self.check(exact, f"serve {name}: K4 not equal to plain")
            self.check(vals.shape == (b, k) and bool(np.isfinite(vals).all())
                       and np.array_equal(vals, want[0][:b].cpu().numpy())
                       and np.array_equal(ids, want[1][:b].cpu().numpy()),
                       f"serve {name}: the engine's answer is not the plain "
                       "version's")
            call = lambda: topk_scores(*a, **kw)  # noqa: E731
            nbytes, flops, counts = topk_scores_work(a, kw, b)
            b_ms, by = bound(nbytes, flops)
            dense = dense_route(a, kw)
            parts = kernels_ms(call, 10, "topk_partial_kernel",
                               "topk_select_kernel", "topk_sort_kernel")
            row = dict(config=name, launches=launches,
                       max_abs_err=float((got[0] - want[0]).abs().max()),
                       ms=time_ms(call, 10),
                       score_ms=parts["topk_partial_kernel"],
                       select_ms=parts["topk_select_kernel"],
                       sort_ms=parts["topk_sort_kernel"],
                       plain_ms=time_ms(lambda: topk_scores_plain(*a, **kw),
                                        2),
                       library_ms=time_ms(lambda: dense(k), 5),
                       bound_ms=b_ms, bound_by=by, **counts)
            log(f"serve {name}: {row}")
            rows.append(row)
        head = rows[0]
        self.kernels["topk_scores_large_k"] = dict(
            {key: head[key] for key in ("ms", "plain_ms", "library_ms",
                                        "bound_ms", "bound_by")},
            launches=sum(r["launches"] for r in rows),
            max_abs_err=max(r["max_abs_err"] for r in rows),
            configs=[{key: r[key] for key in (
                "config", "ms", "score_ms", "select_ms", "sort_ms",
                "bound_ms", "bound_by", "library_ms")} for r in rows])
        self.report["serve_large_k"] = rows

    def fleet(self):
        """The replicated serving fleet at the serve shape (module doc,
        phase 5b).  K4's launches of the driven run are the wrapper's own
        counts (taken under its lock, per launching thread), zeroed just
        before the first request and read after the fleet stops; they go
        to the kernels line as ``fleet_launches``, beside the serve
        phase's ``launches``."""
        import threading

        import numpy as np
        import torch

        from cfk_tpu_torch.data.synthetic import serve_factors, serve_seen_csr
        from cfk_tpu_torch.resilience.faults import DeltaStreamTamper
        from cfk_tpu_torch.serving import (
            DELTAS_TOPIC,
            DeltaPublisher,
            ServeClient,
            ServeEngine,
            ServeFleet,
            table_crc,
            zipf_user_rows,
        )
        from cfk_tpu_torch.serving import engine as engine_mod
        from cfk_tpu_torch.serving.topk_kernel import (
            reset_launches,
            topk_scores,
            topk_scores_large_k,
            topk_scores_plain,
        )
        from cfk_tpu_torch.transport.tcp import BrokerProcess, TcpBrokerClient

        sys.path.insert(0, str(ROOT / "tests"))
        from _torch_topk import compare_topk

        s, f = SERVE, FLEET
        nu, nm, k, rank = s["num_users"], s["num_movies"], s["k"], s["rank"]
        t_phase = time.perf_counter()
        nreq = f["waves"] * f["wave_requests"]
        traffic = zipf_user_rows(nu, nreq, seed=4)
        burst = zipf_user_rows(nu, f["burst"], seed=5)
        rng = np.random.default_rng(2)
        u, m = serve_factors(nu, nm, rank, rng)
        seen, indptr = serve_seen_csr(
            nu, nm, s["nnz"], np.concatenate([
                zipf_user_rows(nu, 4096, seed=1), traffic, burst]), rng)
        crng = np.random.default_rng(6)
        hot_users = np.unique(traffic)
        commits = []
        for _ in range(f["commits"]):
            rows = np.unique(np.concatenate([
                crng.choice(hot_users, min(512, hot_users.size),
                            replace=False),
                crng.integers(0, nu, f["touched"])]))[: f["touched"]]
            commits.append({
                "touched_rows": rows.tolist(),
                "rows": (u[rows] + crng.standard_normal(
                    (rows.size, rank), dtype=np.float32) * 0.05),
                "cells": [], "retrain": False, "num_users": nu})
        u2 = u + rng.standard_normal(u.shape, dtype=np.float32) * 0.05
        m2 = m + rng.standard_normal(m.shape, dtype=np.float32) * 0.05
        gen_s = time.perf_counter() - t_phase

        def engine(uf, mf):
            return ServeEngine(uf, mf, num_users=nu, num_movies=nm,
                               seen_movies=seen, seen_indptr=indptr,
                               table_dtype="float32", tile_m=s["tile_m"],
                               serve_mode="exact", device="cuda")

        lock = threading.Lock()
        calls: dict[str, int] = {}  # K4 calls a thread, against its launches
        captured: dict[str, list] = {}

        def recording(*a, **kw):
            out = topk_scores(*a, **kw)
            name = threading.current_thread().name
            with lock:
                calls[name] = calls.get(name, 0) + 1
                if name.startswith("cfk-replica") and len(
                        captured.setdefault(name, [])) < 2:
                    captured[name].append((a, kw, out))
            return out

        out: dict = dict(generate_s=gen_s, seen_cells=int(indptr[-1]),
                         **f)
        engine_mod.topk_scores = recording
        bp = BrokerProcess()
        clients = []
        fleet = None
        try:
            def connect():
                clients.append(TcpBrokerClient("127.0.0.1", bp.port))
                return clients[-1]

            t0 = time.perf_counter()
            tampered = DeltaStreamTamper(connect(), topic=DELTAS_TOPIC,
                                         hide=[f["hidden_offset"]])
            fleet = ServeFleet(lambda i: engine(u, m), tampered,
                               replicas=f["replicas"],
                               max_batch=f["max_batch"], prewarm_k=k)
            fleet.seed_store(u, m, num_users=nu)
            fleet.prewarm(k, max_batch=f["max_batch"])
            pub = DeltaPublisher(connect(), fleet.store)
            client = ServeClient(connect(), route_by_user=True)
            out["fleet_build_s"] = time.perf_counter() - t0
            oracle0 = engine(u, m)
            oracle1 = engine(u2, m2)
            fleet.start()
            with lock:
                calls.clear()
                captured.clear()
            reset_launches()
            # -- capacity: a closed burst, as fast as the client sends ------
            b, out["burst_profile"] = profiled_wave(
                lambda: fleet_wave(client, burst, float("inf"), k))
            self.check(b["timeouts"] == 0 and len(b["pairs"]) == f["burst"],
                       f"fleet: burst answered {len(b['pairs'])} of "
                       f"{f['burst']}, {b['timeouts']} timeouts")
            capacity = len(b["pairs"]) / b["wall_s"]
            rate = f["load"] * capacity
            out.update(capacity_qps=capacity, rate_qps=rate)
            log(f"fleet: capacity {capacity:.0f} qps (burst of "
                f"{f['burst']} in {b['wall_s']:.2f} s); waves at "
                f"{rate:.0f} qps")
            waves, crc = [], {}
            for w in range(1, f["waves"] + 1):
                if w == 3:
                    for ev in commits:
                        pub.on_commit(ev)
                        oracle0.on_commit(ev)
                if w == f["kill_after_wave"] + 1:
                    t_kill = time.perf_counter()
                    fleet.kill_replica(0)
                    victim = int(next(x for x in traffic if x % 2 == 0))
                    probe = client.ask([victim], k, timeout_s=30)
                    out["failover_gap_s"] = time.perf_counter() - t_kill
                    self.check(not next(iter(probe.values())).error,
                               "fleet: the victim's probe was refused")
                if w == f["epoch_before_wave"]:
                    pub.on_commit({"retrain": True, "user_factors": u2,
                                   "movie_factors": m2, "num_users": nu})
                users = traffic[(w - 1) * f["wave_requests"]:
                                w * f["wave_requests"]]
                if w == f["profile_wave"]:
                    res, out["wave_profile"] = profiled_wave(
                        lambda: fleet_wave(client, users, rate, k))
                else:
                    res = fleet_wave(client, users, rate, k)
                waves.append(res)
                log(f"fleet wave {w}: {len(res['pairs'])}/{res['requests']}"
                    f" answered in {res['wall_s']:.2f} s, p50 "
                    f"{np.percentile(res['lat_ms'], 50):.2f} ms, p99 "
                    f"{np.percentile(res['lat_ms'], 99):.2f} ms, "
                    f"{res['rejections']} rejected, {res['timeouts']} "
                    "timeouts")
                if w == 3:  # the gap's resync has converged on both
                    deadline = time.perf_counter() + 20
                    want = table_crc(oracle0)
                    while time.perf_counter() < deadline and any(
                            table_crc(r.engine) != want
                            for r in fleet.replicas):
                        time.sleep(0.05)
                    crc = {r.index: table_crc(r.engine) == want
                           for r in fleet.replicas}
            # the rollover may still be building: wait for its flip
            heir = fleet.replicas[1]
            deadline = time.perf_counter() + 30
            while heir.rollovers == 0 and time.perf_counter() < deadline:
                time.sleep(0.05)
            counters = fleet.counters()
            fleet.stop()
            fleet_launches = topk_scores.launches
            by_thread = dict(topk_scores.launches_by_thread)
            large_k = topk_scores_large_k.launches
            with lock:  # the oracles below call K4 on this thread
                k4_calls = dict(calls)
            # -- checks -----------------------------------------------------
            all_pairs = [p for wv in waves for p in wv["pairs"]]
            lat = np.concatenate([wv["lat_ms"] for wv in waves])
            wall = sum(wv["wall_s"] for wv in waves)
            timeouts = sum(wv["timeouts"] for wv in waves)
            self.check(len(all_pairs) == nreq and timeouts == 0,
                       f"fleet: answered {len(all_pairs)} of {nreq}, "
                       f"{timeouts} timeouts")
            self.check(all(not r.error for _, r in all_pairs),
                       "fleet: a request was answered with an error")
            self.check(all(r.staleness >= 0 for _, r in all_pairs),
                       "fleet: a response without a staleness stamp")
            gaps = [r.gaps_detected for r in fleet.replicas]
            resyncs = [r.resyncs for r in fleet.replicas]
            self.check(all(g >= 1 for g in gaps) and all(
                x >= 1 for x in resyncs) and all(crc.values()),
                f"fleet: gaps {gaps}, resyncs {resyncs}, crc equal {crc}")
            self.check(counters["failovers"] == 1
                       and not fleet.replicas[0].alive,
                       f"fleet: failover {counters}")
            late = [p for wv in waves[f["kill_after_wave"]:]
                    for p in wv["pairs"]]
            victim_late = sum(1 for user, _ in late if user % 2 == 0)
            self.check(victim_late > 0, "fleet: no victim user answered "
                       "after the kill")
            self.check(heir.rollovers == 1 and heir.engine.epoch == 1,
                       f"fleet: rollover {heir.rollovers}, epoch "
                       f"{heir.engine.epoch}")
            # every answer after the commits converged against the oracle
            # of the epoch it is stamped with: no mixed-epoch table
            checked = [p for wv in waves[3:] for p in wv["pairs"]]
            epochs = {0: [], 1: []}
            for user, resp in checked:
                epochs.setdefault(int(resp.epoch), []).append((user, resp))
            self.check(set(epochs) == {0, 1} and epochs[1],
                       f"fleet: epochs served {sorted(epochs)}")
            mixed = 0
            worst = 0.0
            for e, pairs in epochs.items():
                oracle = oracle0 if e == 0 else oracle1
                for lo in range(0, len(pairs), 256):
                    part = pairs[lo:lo + 256]
                    rows = np.asarray([x for x, _ in part], np.int64)
                    ov, oi = oracle.topk(rows, k + 1)
                    gv = np.stack([r.scores for _, r in part])
                    gi = np.stack([r.movie_rows for _, r in part])
                    par = compare_topk(gv, gi, ov[:, :k], oi[:, :k], ov,
                                       tol=TOL["topk_scores"])
                    worst = max(worst, par["rel_err"])
                    if not par["ok"]:
                        mixed += len(part)
            self.check(mixed == 0, f"fleet: {mixed} answers match no "
                       "oracle of their epoch stamp")
            # K4 on each replica's thread (the wrapper's counts), every
            # launch through the engine's call, and against plain
            per_replica = {name: n for name, n in by_thread.items()
                           if name.startswith("cfk-replica")}
            self.check(len(per_replica) == f["replicas"] and all(
                n > 0 for n in per_replica.values()),
                f"fleet: K4 launches by thread {by_thread}")
            self.check(sum(by_thread.values()) == fleet_launches
                       and large_k == 0 and by_thread == {
                           name: 2 * n for name, n in k4_calls.items()},
                       f"fleet: K4 launches {by_thread} (total "
                       f"{fleet_launches}, large-K {large_k}) against two "
                       f"a call {k4_calls}")
            plain = {}
            for name, recorded in captured.items():
                for a, kw, (gv, gi) in recorded:
                    want = topk_scores_plain(*a, **kw)
                    ext = topk_scores_plain(*a, **dict(kw,
                                                       k_top=kw["k_top"] + 1))
                    # the batch is whatever the open loop coalesced (K4
                    # is bit-exact only at the serve phase's 16, 64, 256)
                    par = compare_topk(gv, gi, *want, ext[0],
                                       tol=TOL["topk_scores"])
                    par.update(batch=int(a[0].shape[0]),
                               bit_equal=bool(torch.equal(gv, want[0])
                                              and torch.equal(gi, want[1])))
                    plain.setdefault(name, []).append(par)
                    self.check(par["ok"], f"fleet: K4 vs plain on {name} "
                               f"{par}")
            self.check(set(plain) == set(per_replica),
                       f"fleet: K4 held to plain on {sorted(plain)} of "
                       f"{sorted(per_replica)}")
            # engine.topk alone at B = max_batch, outside the fleet (no
            # poll, decode, staleness lookup, encode or flush)
            eng = heir.engine
            rows = traffic[: f["max_batch"]]
            for _ in range(PROFILE_ATTEMPTS):  # CUPTI may miss a session
                engine_b = device_timeline(lambda: eng.topk(rows, k), 5)
                if engine_b.get("kernels", 0) >= 2:  # K4's two a call
                    break
            out.update(
                requests=nreq, answered=len(all_pairs), timeouts=timeouts,
                qps=len(all_pairs) / wall, wall_s=wall,
                p50_ms=float(np.percentile(lat, 50)),
                p99_ms=float(np.percentile(lat, 99)),
                max_ms=float(lat.max()),
                shed=counters["shed"],
                client_rejections=sum(wv["rejections"] for wv in waves),
                client_retries=sum(wv["resent"] for wv in waves),
                batches=counters["batches"],
                mean_batch=counters["served"] / max(counters["batches"], 1),
                counters=counters, gaps_detected=gaps, resyncs=resyncs,
                resync_s=[r.resync_s for r in fleet.replicas],
                crc_equal_after_resync=crc,
                rollover=heir.rollover_times,
                epochs_served={e: len(v) for e, v in epochs.items()},
                oracle_rel_err=worst, victim_answers_after_kill=victim_late,
                k4_launches=by_thread, k4_calls=k4_calls,
                fleet_launches=fleet_launches, k4_vs_plain=plain,
                engine_topk_profile=engine_b,
                waves=[{key: wv[key] for key in (
                    "requests", "wall_s", "rejections", "resent", "timeouts")}
                    | {"answered": len(wv["pairs"]),
                       "p50_ms": float(np.percentile(wv["lat_ms"], 50)),
                       "p99_ms": float(np.percentile(wv["lat_ms"], 99))}
                    for wv in waves])
            log(f"fleet: {out['qps']:.0f} qps, p50 {out['p50_ms']:.2f} ms, "
                f"p99 {out['p99_ms']:.2f} ms, shed {out['shed']}, client "
                f"retries {out['client_retries']}")
            log(f"fleet: failover gap {out.get('failover_gap_s')} s, resync "
                f"{out['resync_s']} s, rollover {out['rollover']}")
            for name in ("burst_profile", "wave_profile"):
                log(f"fleet: device timeline of the {name[:-8]} "
                    f"(both replicas, mean batch {out['mean_batch']:.1f}): "
                    f"{out.get(name)}")
            log(f"fleet: engine.topk alone at B = {f['max_batch']}, outside "
                f"the fleet: {engine_b}")
            self.kernels.setdefault("topk_scores", {})[
                "fleet_launches"] = fleet_launches
        finally:
            engine_mod.topk_scores = topk_scores
            if fleet is not None:
                fleet.stop()
            for c in clients:
                try:
                    c.close(flush=False)
                except OSError:
                    pass
            bp.terminate()
        out["phase_s"] = time.perf_counter() - t_phase
        self.check(out["phase_s"] <= f["budget_s"],
                   f"fleet: the phase took {out['phase_s']:.1f} s, over its "
                   f"{f['budget_s']} s budget")
        self.report["fleet"] = out


    def shards(self):
        """Sharded training and serving on two ranks sharing the card (the
        module doc, phase 5c); its ratings are kept for the implicit phase
        (the same seed and shape).  Every number it prints is labelled
        ``SHARDS_LABEL``: the exchanges are staged through host memory, so
        none of them is a multi-card exchange."""
        import concurrent.futures

        from cfk_tpu_torch.parallel.mesh import make_mesh

        c, sv = SHARDS, SERVE
        label = f"{SHARDS_LABEL}; {card_line()}"
        t_phase = time.perf_counter()
        # The ranks spawn (import torch, reach the card, join the group)
        # while this process generates, builds and trains one rank.
        spawner = concurrent.futures.ThreadPoolExecutor(1)
        mesh_f = spawner.submit(make_mesh, c["ranks"], "cuda")
        spawner.shutdown(wait=False)
        try:
            self._shards(c, sv, label, t_phase, mesh_f)
        finally:
            # close() is idempotent: a mesh the phase never reached is
            # stopped here too.
            if mesh_f.exception() is None:
                mesh_f.result().close()

    def _shards(self, c, sv, label, t_phase, mesh_f):
        import concurrent.futures

        import numpy as np
        import torch

        from cfk_tpu_torch import ALSConfig, Dataset, train_als
        from cfk_tpu_torch.data.synthetic import (
            serve_factors, synthetic_netflix_coo)
        from cfk_tpu_torch.eval.metrics import mse_rmse_from_model
        from cfk_tpu_torch.parallel import spmd
        from cfk_tpu_torch.serving.engine import pad_table
        from cfk_tpu_torch.serving.topk_kernel import topk_scores
        from cfk_tpu_torch.telemetry.metrics import Metrics

        t0 = time.perf_counter()
        coo = synthetic_netflix_coo(**ML25M, seed=0)
        self.ml25m_coo = coo  # the implicit phase's ratings: generated once
        gen_s = time.perf_counter() - t0
        build = dict(layout="tiled", chunk_elems=c["chunk_elems"])
        t0 = time.perf_counter()
        # The three builds on threads: the host library's group-by and much
        # of numpy run without the interpreter lock.
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            ds1, ds_ring, ds_auto = pool.map(lambda kw: Dataset.from_coo(
                coo, **build, **kw), (
                dict(dense_stream=True),
                dict(num_shards=c["ranks"], ring=True, ring_warn=False,
                     accum_max_entities=c["ring_accum_max"]),
                dict(num_shards=c["ranks"], ring="auto", dense_stream=True)))
        blocks_s = time.perf_counter() - t0
        del coo
        log(f"shards data: generate {gen_s:.1f} s, three tiled builds "
            f"{blocks_s:.1f} s; auto picked movie ring="
            f"{ds_auto.movie_blocks.ring} ({ds_auto.movie_blocks.mode}), "
            f"user ring={ds_auto.user_blocks.ring} "
            f"({ds_auto.user_blocks.mode})")
        cfg = dict(rank=RANK, lam=LAM, num_iterations=c["iterations"],
                   layout="tiled")
        t0 = time.perf_counter()
        one = train_als(ds1, ALSConfig(**cfg), device="cuda")
        one_s = time.perf_counter() - t0
        u1, m1 = (torch.as_tensor(x) for x in one.host_factors())
        _, rmse1 = mse_rmse_from_model(one, ds1)
        nu, nm = one.num_users, one.num_movies
        out = dict(label=label, generate_s=gen_s, blocks_s=blocks_s,
                   one_rank=dict(s=one_s, rmse=rmse1), runs={})
        launches_by_run = {}
        t0 = time.perf_counter()
        mesh = mesh_f.result()
        out["mesh_wait_s"] = time.perf_counter() - t0
        with mesh:
            out["placement"] = mesh.description
            log(f"shards mesh: {mesh.description} ({label})")
            self.check(mesh.backend == ("nccl" if torch.cuda.device_count()
                                        >= c["ranks"] else "gloo"),
                       f"shards backend {mesh.backend}")
            models = {}
            # One untimed ring iteration: each rank's first kernel loads
            # and launches, so the timed runs below compare exchanges warm.
            t0 = time.perf_counter()
            spmd.train_als_sharded(
                ds_ring, ALSConfig(num_shards=c["ranks"], exchange="ring",
                                   **dict(cfg, num_iterations=1)), mesh)
            out["warmup_s"] = time.perf_counter() - t0
            log(f"shards mesh waited {out['mesh_wait_s']:.1f} s after the "
                f"builds; warm-up ring iteration {out['warmup_s']:.1f} s")
            for name, ds, extra in (
                    ("ring", ds_ring, dict(exchange="ring")),
                    ("auto", ds_auto, dict(exchange="auto")),
                    ("hier_ring", ds_ring, dict(exchange="hier_ring",
                                                ici_group=1))):
                mesh.run(spmd.reset_kernel_launches)
                metrics = Metrics()
                t0 = time.perf_counter()
                model = spmd.train_als_sharded(
                    ds, ALSConfig(num_shards=c["ranks"], **cfg, **extra),
                    mesh, metrics=metrics)
                wall = time.perf_counter() - t0
                launches = mesh.run(spmd.kernel_launches)
                launches_by_run[name] = launches
                models[name] = model
                _, rmse = mse_rmse_from_model(dataclasses.replace(
                    model, user_factors=model.user_factors.cuda(),
                    movie_factors=model.movie_factors.cuda()), ds)
                errs = (rel_err(model.user_factors[:nu].float(), u1[:nu])[1],
                        rel_err(model.movie_factors[:nm].float(), m1[:nm])[1])
                staged = model.pipeline["staged_bytes"]
                row = dict(
                    wall_s=wall, s_per_iter=metrics.phases["train"]
                    / c["iterations"], rmse=rmse, rel_err_u=errs[0],
                    rel_err_m=errs[1], exchange=model.pipeline["reason"],
                    staged_bytes_per_half=staged / (2 * c["iterations"]),
                    launches=launches)
                out["runs"][name] = row
                log(f"shards {name}: {row['s_per_iter']:.3f} s/iter, "
                    f"rmse {rmse:.6f} (one rank {rmse1:.6f}), max|Δ| u "
                    f"{errs[0]:.2e} m {errs[1]:.2e}, staged "
                    f"{row['staged_bytes_per_half'] / 1e6:.2f} MB a "
                    f"half-iteration on rank 0, launches {launches} "
                    f"({label})")
                if name != "hier_ring":
                    self.check(max(errs) <= 1e-3 and abs(rmse - rmse1)
                               <= 1e-4, f"shards {name} vs one rank: "
                               f"max|Δ| {errs}, rmse {rmse} vs {rmse1}")
                need = ("reg_solve", "gram_gather") + (
                    ("gram_solve_dense",) if name == "auto"
                    and ds_auto.user_blocks.mode == "dstream" else ())
                for k in need:
                    self.check(all(x[k] > 0 for x in launches),
                               f"shards {name}: {k} launched "
                               f"{[x[k] for x in launches]} on the ranks")
            self.check(
                torch.equal(models["ring"].user_factors,
                            models["hier_ring"].user_factors)
                and torch.equal(models["ring"].movie_factors,
                                models["hier_ring"].movie_factors),
                "shards hier_ring (ici_group=1) not bit-equal to ring")
            # Rank 0's own ring visit: K2 on its slice's middle chunk
            # against its block of the trained users; K1 on the visit.
            s = c["ranks"]
            rows = ds_ring.user_blocks.padded_entities // s
            u_ring = models["ring"].user_factors
            payloads = [(spmd.shard_view(ds_ring.movie_blocks, r, s),
                         u_ring[r * rows:(r + 1) * rows])
                        for r in range(s)]
            probe = mesh.run(shard_kernel_check, per_rank=payloads,
                             lam=LAM)[0]
            out["rank0_kernels"] = probe
            log(f"shards rank 0 ring visit: {probe} ({label})")
            self.check(probe["k2_rel_err"] <= TOL["gram_gather"]
                       and probe["k1_rel_err"] <= TOL["reg_solve"]
                       and probe["k2_bit_equal"] and probe["k1_bit_equal"],
                       f"shards rank 0 K2/K1 vs plain: {probe}")
            # One profiled iteration of both ranks: the card's idle share.
            one_iter = ALSConfig(num_shards=s, exchange="ring",
                                 **dict(cfg, num_iterations=1))
            pay, kw = spmd.sharded_payloads(ds_ring, one_iter, s,
                                            model="als")
            prof = mesh.run(profiled_rank, spmd._rank_train, per_rank=pay,
                            **kw)
            spans = [sp for _, sp in prof for sp in sp]
            kernels = [(a, b) for cat, a, b in spans if cat == "kernel"]
            lo, hi = min(a for a, _ in kernels), max(b for _, b in kernels)
            busy = sum(b - a for a, b in _merged(
                [(max(a, lo), min(b, hi)) for _, a, b in spans
                 if b > lo and a < hi]))
            out["timeline"] = dict(window_ms=(hi - lo) / 1e3,
                                   busy_ms=busy / 1e3,
                                   idle_share=1 - busy / (hi - lo),
                                   kernels=len(kernels))
            log(f"shards one ring iteration, both ranks: "
                f"{out['timeline']} ({label})")
            # Sharded serving at the serve shape: K4 per rank at its row
            # offset, one gather, the merge — against one-rank K4.
            rng = np.random.default_rng(2)
            su, sm = serve_factors(sv["num_users"], sv["num_movies"],
                                   sv["rank"], rng)
            table = torch.as_tensor(pad_table(sm, sv["tile_m"], s))
            batch = torch.as_tensor(su[:SERVE["requests"]])
            kw4 = dict(k_top=sv["k"], num_movies=sv["num_movies"],
                       tile_m=sv["tile_m"])
            v1, i1 = topk_scores(batch.cuda(), table.cuda(), None, None,
                                 **kw4)
            # The table's slices go to the ranks once; each call then
            # ships only the batch.
            t0 = time.perf_counter()
            placed = spmd.place_table_sharded(mesh, table, None,
                                              tile_m=sv["tile_m"],
                                              name="smoke")
            place_s = time.perf_counter() - t0
            mesh.run(spmd.reset_kernel_launches)
            calls = []
            for _ in range(3):
                t0 = time.perf_counter()
                v2, i2 = spmd.serve_topk_sharded(mesh, batch, placed, None,
                                                 None, **kw4)
                calls.append(time.perf_counter() - t0)
                equal = bool(torch.equal(v2, v1.cpu()) and
                             torch.equal(i2, i1.cpu()))
                if not equal:
                    break
            k4 = mesh.run(spmd.kernel_launches)
            launches_by_run["serve"] = k4
            out["serve"] = dict(bit_equal=equal, place_s=place_s,
                                call_s=calls,
                                launches=[x["topk_scores"] for x in k4])
            log(f"shards serve_topk_sharded B={SERVE['requests']}: bit-"
                f"equal {equal}, the table placed on the ranks in "
                f"{place_s:.3f} s, then {', '.join(f'{x:.4f}' for x in calls)}"
                f" s a call (host round trip to the ranks included), K4 "
                f"launches {out['serve']['launches']} ({label})")
            self.check(equal, "shards serve_topk_sharded not bit-equal to "
                       "one-rank K4")
            self.check(all(x["topk_scores"] > 0 for x in k4),
                       f"shards serve: K4 launches {k4}")
        for name in ("reg_solve", "gram_gather", "gram_solve_dense",
                     "topk_scores"):
            self.kernels.setdefault(name, {})["shards"] = {
                run: [x[name] for x in per_rank]
                for run, per_rank in launches_by_run.items()}
        out["phase_s"] = time.perf_counter() - t_phase
        log(f"shards phase {out['phase_s']:.1f} s (budget "
            f"{c['budget_s']:.0f} s)")
        self.report["shards"] = out

    def implicit(self):
        import numpy as np
        import torch

        from cfk_tpu_torch import Dataset
        from cfk_tpu_torch.data.synthetic import synthetic_netflix_coo
        from cfk_tpu_torch.models.als import device_setup
        from cfk_tpu_torch.models.ials import IALSConfig, _ials_half, train_ials
        from cfk_tpu_torch.ops.kernels.gram_kernel import (
            gather_rows, gram_gather, gram_solve_dense, gram_solve_gather,
            gram_tiles_dense_gather)
        from cfk_tpu_torch.ops.kernels.solve_kernel import (
            gauss_solve, gauss_solve_multi, reg_solve)
        from cfk_tpu_torch.utils.roofline import bucketed_gather_rows

        c = IMPLICIT
        kernels = (reg_solve, gram_gather, gram_solve_dense, gather_rows,
                   gram_solve_gather, gram_tiles_dense_gather, gauss_solve,
                   gauss_solve_multi)
        t0 = time.perf_counter()
        coo = getattr(self, "ml25m_coo", None)
        if coo is None:
            coo = synthetic_netflix_coo(**ML25M, seed=0)
        self.ml25m_coo = None
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ds_t = Dataset.from_coo(coo, layout="tiled",
                                chunk_elems=c["tiled_chunk"],
                                dense_stream=True)
        tiled_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ds_b = Dataset.from_coo(coo, layout="bucketed",
                                chunk_elems=c["bucketed_chunk"])
        bucketed_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ds_s = Dataset.from_coo(coo, layout="tiled",
                                chunk_elems=c["tiled_chunk"])
        stream_s = time.perf_counter() - t0
        del coo
        mb, ub = ds_t.movie_blocks, ds_t.user_blocks
        log(f"implicit data: generate {gen_s:.1f} s, tiled blocks "
            f"{tiled_s:.1f} s (movie {mb.mode} {mb.statics}, user {ub.mode} "
            f"{ub.statics}), bucketed blocks {bucketed_s:.1f} s (widths "
            f"movie {[b.width for b in ds_b.movie_blocks.buckets]}, user "
            f"{[b.width for b in ds_b.user_blocks.buckets]})")
        self.check(mb.mode == "accum" and ub.mode == "dstream",
                   f"implicit tiled modes {mb.mode}/{ub.mode}")
        ss = ds_s.user_blocks
        log(f"implicit stream blocks {stream_s:.1f} s (user {ss.mode} "
            f"{ss.statics}, {int(ss.carry_in.sum())} carried chunks)")
        self.check(ds_s.movie_blocks.mode == "accum" and ss.mode == "stream"
                   and ss.carry_in.sum() > 0,
                   f"implicit stream modes {ds_s.movie_blocks.mode}/{ss.mode}")
        dev = torch.device("cuda")
        nu, nm, k = ML25M["num_users"], ML25M["num_movies"], c["rank"]
        u0 = np.random.default_rng(0).random((nu, k), dtype=np.float32)
        m0 = np.zeros((nm, k), np.float32)
        d = ds_t.coo_dense
        obs = [torch.as_tensor(x, device=dev) for x in (
            d.user_raw.astype(np.int32), d.movie_raw.astype(np.int32),
            d.rating)]

        def objective(u, m):
            return implicit_objective(u, m, *obs, c["lam"], c["alpha"])

        j0 = objective(torch.as_tensor(u0, device=dev),
                       torch.as_tensor(m0, device=dev))
        runs, report = {}, dict(
            shape=ML25M, generate_s=gen_s, tiled_blocks_s=tiled_s,
            bucketed_blocks_s=bucketed_s, stream_blocks_s=stream_s,
            objective_init=j0, **c)
        split = ("gram_gather", "reg_solve", "gauss_solve",
                 "gauss_solve_multi")
        needed = {"ials_tiled": ("reg_solve", "gram_gather",
                                 "gram_solve_dense"),
                  "ials_bucketed": ("gram_solve_gather",),
                  "ialspp_bucketed": ("gather_rows", "reg_solve"),
                  "ials_tiled_split": split + ("gram_tiles_dense_gather",),
                  "ials_stream": ("gram_gather", "reg_solve",
                                  "gram_solve_gather"),
                  "ials_stream_split": split}
        for name, ds, layout, algorithm, fused, iters in (
                ("ials_tiled", ds_t, "tiled", "als", None, c["iterations"]),
                ("ials_bucketed", ds_b, "bucketed", "als", None,
                 c["iterations"]),
                ("ialspp_bucketed", ds_b, "bucketed", "ials++", None,
                 c["iterations"]),
                ("ials_tiled_split", ds_t, "tiled", "als", False,
                 c["split_iterations"]),
                ("ials_stream", ds_s, "tiled", "als", None,
                 c["stream_iterations"]),
                ("ials_stream_split", ds_s, "tiled", "als", False, 1)):
            cfg = IALSConfig(rank=k, lam=c["lam"], alpha=c["alpha"],
                             num_iterations=1, layout=layout,
                             algorithm=algorithm, block_size=c["block_size"],
                             fused_epilogue=fused)
            # -- the main path: train_ials, one call per iteration ----------
            for fn in kernels:
                fn.launches = 0
            torch.cuda.synchronize()
            state, traj, call_s = (u0, m0), [], []
            for _ in range(iters):
                t1 = time.perf_counter()
                model = train_ials(ds, cfg, device=dev, warm_start=state)
                torch.cuda.synchronize()
                call_s.append(time.perf_counter() - t1)
                state = (model.user_factors, model.movie_factors)
                traj.append(state)
            launches = {fn.__name__: fn.launches for fn in kernels}
            for kname in needed[name]:
                self.check(launches[kname] > 0,
                           f"implicit {name}: {kname} launched "
                           f"{launches[kname]} times")
            u, m = state
            self.check(bool(torch.isfinite(u).all() and torch.isfinite(m).all()),
                       f"implicit {name}: non-finite factors")
            objs = [objective(*st) for st in traj]
            self.check(all(a > b for a, b in zip([j0] + objs, objs)),
                       f"implicit {name}: objective did not fall every "
                       f"iteration: {[j0] + objs}")
            runs[name] = traj
            report[name] = dict(
                s_per_iter=float(np.mean(call_s)), call_s=call_s,
                objective=objs, launches=launches,
                launches_per_iter={key: v / iters
                                   for key, v in launches.items()})
            if layout == "bucketed":
                # Every padded cell of every width class gathers a k-float
                # row once per iteration (once per sweep for iALS++): the
                # iteration's gather-byte floor at the card's HBM rate.
                rows = bucketed_gather_rows(ds.movie_blocks, ds.user_blocks)
                report[name].update(
                    gather_rows_per_iter=rows,
                    gather_bound_ms_per_iter=bound(rows * k * 4, 0)[0])
            log(f"implicit {name}: {report[name]}")
        # (a) and (b): the same normal equations from the same u0 (TOL).
        agree = []
        for i, (st_a, st_b) in enumerate(zip(runs["ials_tiled"],
                                             runs["ials_bucketed"])):
            ja = report["ials_tiled"]["objective"][i]
            jb = report["ials_bucketed"]["objective"][i]
            agree.append(dict(
                movie_factors=rel_err(st_a[1], st_b[1])[1],
                user_factors=rel_err(st_a[0], st_b[0])[1],
                scores=score_rel_err(st_a, st_b, obs[0], obs[1]),
                objective=abs(ja - jb) / jb,
                cond_user_ridge=ridge_condition(st_b[0], c["lam"]),
                cond_movie_ridge=ridge_condition(st_b[1], c["lam"])))
        report["cond_u0_ridge"] = ridge_condition(
            torch.as_tensor(u0, device=dev), c["lam"])
        report["tiled_vs_bucketed"] = agree
        log(f"implicit tiled vs bucketed, per iteration: {agree}; "
            f"cond(u0ᵀu0 + λI) {report['cond_u0_ridge']:.4g}")
        self.check(agree[0]["movie_factors"] < TOL["first_half_factors"],
                   "implicit tiled vs bucketed: first movie half differs by "
                   f"{agree[0]['movie_factors']}")
        # Both first movie halves against float64: the five widest movies
        # (a million rows and more in one segment) and five random ones.
        count = torch.bincount(obs[1].long(), minlength=nm)
        sample = torch.cat([torch.topk(count, 5).indices, torch.as_tensor(
            np.random.default_rng(0).choice(nm, 5, replace=False),
            device=dev)])
        ref = first_half_reference(u0, obs[1], obs[0], obs[2], sample,
                                   c["lam"], c["alpha"])
        vs64 = {}
        for name in ("ials_tiled", "ials_bucketed"):
            got = runs[name][0][1][sample].double()
            vs64[name] = ((got - ref).abs().amax(1)
                          / ref.abs().amax(1)).tolist()
        report["first_half_vs_float64"] = dict(
            movies=sample.tolist(), interactions=count[sample].tolist(),
            **vs64)
        log(f"implicit first movie half vs float64: "
            f"{report['first_half_vs_float64']}")
        self.check(max(max(v) for v in vs64.values())
                   < TOL["first_half_factors"],
                   f"implicit first movie half vs float64: {vs64}")
        self.check(all(a["scores"] < TOL["scores"] for a in agree),
                   f"implicit tiled vs bucketed scores differ: {agree}")
        # (d) and (e) against (a): the first movie half and every iteration's
        # scores on the observed entries.
        for name in ("ials_tiled_split", "ials_stream", "ials_stream_split"):
            ref = runs["ials_tiled"]
            first = rel_err(runs[name][0][1], ref[0][1])[1]
            scores = [score_rel_err(st, ref[i], obs[0], obs[1])
                      for i, st in enumerate(runs[name])]
            report[name].update(first_movie_half_vs_tiled=first,
                                scores_vs_tiled=scores)
            log(f"implicit {name} vs ials_tiled: first movie half {first}, "
                f"scores {scores}")
            self.check(first < TOL["first_half_factors"],
                       f"implicit {name}: first movie half differs from "
                       f"ials_tiled by {first}")
            self.check(all(x < TOL["scores"] for x in scores),
                       f"implicit {name}: scores differ from ials_tiled: "
                       f"{scores}")
        del obs
        self.report["implicit"] = report
        self.kernels.setdefault("gather_rows", {})["launches"] = \
            report["ialspp_bucketed"]["launches"]["gather_rows"]
        self.kernels.setdefault("gram_solve_gather", {})["launches"] = \
            report["ials_bucketed"]["launches"]["gram_solve_gather"]
        self.kernels.setdefault("gauss_solve_multi", {})["launches"] = \
            report["ials_tiled_split"]["launches"]["gauss_solve_multi"]
        # Where an iteration's time goes (measurement only): each half of
        # (a) alone, and a profiler pass over one iteration of each run.
        blocks, staged = {}, {}
        for name, ds, algorithm, fused in (
                ("ials_tiled", ds_t, "als", None),
                ("ials_bucketed", ds_b, "als", None),
                ("ialspp_bucketed", ds_b, "ials++", None),
                ("ials_tiled_split", ds_t, "als", False),
                ("ials_stream", ds_s, "als", None),
                ("ials_stream_split", ds_s, "als", False)):
            cfg = IALSConfig(rank=k, lam=c["lam"], alpha=c["alpha"],
                             layout="auto", algorithm=algorithm,
                             block_size=c["block_size"])
            if id(ds) not in staged:
                staged[id(ds)] = device_setup(ds, cfg, dev, weighted=True)
            mblk, ublk, kw, _ = blocks[name] = staged[id(ds)]
            half = functools.partial(
                _ials_half, lam=c["lam"], alpha=c["alpha"], solver="auto",
                algorithm=algorithm, block_size=c["block_size"],
                fused_epilogue=fused)
            u_i, m_i = runs[name][-1]
            movie = functools.partial(half, u_i, mblk, chunks=kw["m_chunks"],
                                      entities=kw["m_entities"], x_prev=m_i)
            user = functools.partial(half, m_i, ublk, chunks=kw["u_chunks"],
                                     entities=kw["u_entities"], x_prev=u_i)
            if name == "ials_tiled":
                report["half_ms"] = {"movie_accum": time_ms(movie, 1),
                                     "user_dstream": time_ms(user, 1)}
            report[name]["profile"] = profile_calls(
                lambda: (movie(), user()), 1)
            log(f"implicit {name} profile of one iteration: "
                f"{report[name]['profile']}")
        log(f"implicit tiled halves {report['half_ms']} ms")
        self.implicit_kernel_checks(ds_t, ds_b, blocks["ials_tiled"], runs,
                                    report)
        return ds_t, ds_b, ds_s, u0, m0, runs

    def implicit_r256(self, ds_t, ds_b, ds_s, u0, m0, runs):
        """Implicit (a) above the fused kernels' cap (phase 6d of the
        module docstring): one warm-started ``train_ials`` call at rank 256
        on the implicit phase's tiled ML-25M blocks."""
        import numpy as np
        import torch

        from cfk_tpu_torch.models.ials import IALSConfig, train_ials
        from cfk_tpu_torch.ops.kernels import gram_kernel as gk
        from cfk_tpu_torch.ops.kernels.solve_kernel import (
            gauss_solve, gauss_solve_multi, reg_solve)

        c, k = IMPLICIT, R256["rank"]
        dev = torch.device("cuda")
        nu, nm = ML25M["num_users"], ML25M["num_movies"]
        u0 = np.random.default_rng(0).random((nu, k), dtype=np.float32)
        m0 = np.zeros((nm, k), np.float32)
        d = ds_t.coo_dense
        obs = [torch.as_tensor(x, device=dev) for x in (
            d.user_raw.astype(np.int32), d.movie_raw.astype(np.int32),
            d.rating)]
        kernels = (gk.gram_gather, gk.gram_tiles_dense_gather, reg_solve,
                   gk.gram_solve_dense, gauss_solve, gauss_solve_multi)
        cfg = IALSConfig(rank=k, lam=c["lam"], alpha=c["alpha"],
                         num_iterations=1, layout="tiled")
        torch.cuda.reset_peak_memory_stats()
        for fn in kernels:
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = train_ials(ds_t, cfg, device=dev, warm_start=(u0, m0))
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        n = {fn.__name__: fn.launches for fn in kernels}
        for kname, v in n.items():
            self.check((v > 0) == (kname in ("gram_gather",
                                              "gram_tiles_dense_gather")),
                       f"implicit_r256: {kname} launched {v} times")
        u, m = model.user_factors, model.movie_factors
        self.check(bool(torch.isfinite(u).all() and torch.isfinite(m).all()),
                   "implicit_r256: non-finite factors")
        j0 = implicit_objective(torch.as_tensor(u0, device=dev),
                                torch.as_tensor(m0, device=dev), *obs,
                                c["lam"], c["alpha"])
        j1 = implicit_objective(u, m, *obs, c["lam"], c["alpha"])
        self.check(j1 < j0, f"implicit_r256: objective {j0} -> {j1}")
        count = torch.bincount(obs[1].long(), minlength=nm)
        sample = torch.cat([torch.topk(count, 5).indices, torch.as_tensor(
            np.random.default_rng(0).choice(nm, 5, replace=False),
            device=dev)])
        ref = first_half_reference(u0, obs[1], obs[0], obs[2], sample,
                                   c["lam"], c["alpha"])
        vs64 = ((m[sample].double() - ref).abs().amax(1)
                / ref.abs().amax(1)).tolist()
        self.check(max(vs64) < TOL["first_half_factors"],
                   f"implicit_r256: first movie half vs float64 {vs64}")
        self.report["implicit_r256"] = dict(
            rank=k, call_s=call_s, launches=n, objective=[j0, j1],
            first_half_vs_float64=dict(movies=sample.tolist(),
                                       interactions=count[sample].tolist(),
                                       rel_err=vs64),
            peak_device_bytes=torch.cuda.max_memory_allocated())
        log(f"implicit_r256: {self.report['implicit_r256']}")

    def gather_implicit(self, ds_t, ds_b, ds_s, u0, m0, runs):
        """The materialized-stream schedule at the ML-25M shape (phase 6b of
        the module docstring): (a), (b) and (e) for one iteration each from
        the implicit phase's u0 on its datasets, held to their gather-on
        runs' first iteration; row 6 on (b)'s middle width class."""
        import numpy as np
        import torch

        from cfk_tpu_torch.models.ials import IALSConfig, train_ials
        from cfk_tpu_torch.ops.bucketed import ials_reparam
        from cfk_tpu_torch.ops.kernels import gram_kernel as gk
        from cfk_tpu_torch.ops.kernels.solve_kernel import reg_solve
        from cfk_tpu_torch.ops.solve import global_gram_blocked, implicit_reg

        c = IMPLICIT
        dev = torch.device("cuda")
        k = c["rank"]
        kernels = (gk.gather_rows, gk.gram_gather, gk.gram_solve_dense,
                   gk.gram_solve_gather, gk.gram_tiles_dense_gather,
                   gk.gram_tiles, gk.gram_solve_tiles, gk.gram_tiles_dense,
                   gk.gram_solve_tiles_dense, reg_solve)
        gather_kernels = ("gram_gather", "gram_solve_dense",
                          "gram_solve_gather", "gram_tiles_dense_gather")
        d = ds_t.coo_dense
        obs = [torch.as_tensor(x, device=dev) for x in (
            d.user_raw.astype(np.int32), d.movie_raw.astype(np.int32))]
        report, row6 = {}, 0
        on_report = self.report["implicit"]
        for name, ds, layout, needed in (
                ("ials_tiled", ds_t, "tiled",
                 ("gather_rows", "gram_tiles", "gram_solve_tiles_dense",
                  "reg_solve")),
                ("ials_bucketed", ds_b, "bucketed",
                 ("gather_rows", "gram_solve_tiles")),
                ("ials_stream", ds_s, "tiled",
                 ("gather_rows", "gram_tiles", "gram_solve_tiles",
                  "reg_solve"))):
            cfg = IALSConfig(rank=k, lam=c["lam"], alpha=c["alpha"],
                             num_iterations=1, layout=layout,
                             in_kernel_gather=False)
            for fn in kernels:
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = train_ials(ds, cfg, device=dev, warm_start=(u0, m0))
            torch.cuda.synchronize()
            call_s = time.perf_counter() - t0
            launches = {fn.__name__: fn.launches for fn in kernels}
            for kname in needed:
                self.check(launches[kname] > 0,
                           f"gather off {name}: {kname} launched "
                           f"{launches[kname]} times")
            self.check(all(launches[n] == 0 for n in gather_kernels),
                       f"gather off {name} launched a gather kernel: "
                       f"{launches}")
            row6 += launches["gram_solve_tiles"]
            off = (model.user_factors, model.movie_factors)
            on = runs[name][0]
            first = rel_err(off[1], on[1])[1]
            scores = score_rel_err(off, on, obs[0], obs[1])
            report[name] = dict(
                call_s=call_s, on_call_s=on_report[name]["call_s"],
                launches=launches, first_movie_half_vs_on=first,
                user_factors_vs_on=rel_err(off[0], on[0])[1],
                scores_vs_on=scores,
                bit_equal=bool(torch.equal(off[0], on[0])
                               and torch.equal(off[1], on[1])))
            if name == "ials_bucketed":  # row 6's device time an iteration
                report[name]["profile"] = profile_calls(
                    lambda: train_ials(ds, cfg, device=dev,
                                       warm_start=(u0, m0)), 1)
            log(f"gather off {name}: {report[name]}")
            self.check(first < TOL["first_half_factors"],
                       f"gather off {name}: first movie half differs from "
                       f"gather on by {first}")
            self.check(scores < TOL["scores"],
                       f"gather off {name}: scores differ from gather on "
                       f"by {scores}")
            del model, off
        del obs
        self.kernels.setdefault("gram_solve_tiles", {})["launches"] = row6
        # Row 6 on the middle width class of (b)'s user half, its final
        # gather-on factors (K6's operands in the implicit phase).
        m_b = runs["ials_bucketed"][-1][1]
        reg_b = implicit_reg(global_gram_blocked(m_b), c["lam"])
        buckets = ds_b.user_blocks.buckets
        bk = buckets[len(buckets) // 2]
        nb = torch.as_tensor(bk.neighbor_idx, device=dev).reshape(-1)
        wt, rt_b = ials_reparam(torch.as_tensor(bk.rating, device=dev),
                                torch.as_tensor(bk.mask, device=dev),
                                c["alpha"])
        rows, width = bk.neighbor_idx.shape
        wt = wt.reshape(-1).contiguous()
        args = dict(rt=rt_b.reshape(-1).contiguous(),
                    seg=torch.arange(rows, dtype=torch.int32, device=dev),
                    reg=reg_b, lseg=rows - 1, num_segments=rows,
                    tile_rows=width, reg_mode="matrix",
                    units=class_plan(rows, width, dev))
        g = gk.gather_rows(m_b, nb, wt)
        got = gk.gram_solve_tiles(g, **args)
        sibling = gk.gram_solve_gather(m_b, nb, wt, **args)
        torch.cuda.synchronize()
        want = gk.gram_solve_tiles_plain(g, **args)
        errs = [rel_err(x, w) for x, w in zip(got, want)]
        nbytes, flops, counts = stream_gram_work(g, args, "matrix")
        b_ms, by = bound(nbytes, flops)
        row = dict(max_abs_err=max(e[0] for e in errs),
                   rel_err=max(e[1] for e in errs),
                   equal_to_gram_solve_gather=all(
                       torch.equal(x, y) for x, y in zip(got, sibling)),
                   ms=time_ms(lambda: gk.gram_solve_tiles(g, **args), 10),
                   plain_ms=time_ms(lambda: gk.gram_solve_tiles_plain(
                       g, **args), 3),
                   gram_solve_gather_ms=time_ms(
                       lambda: gk.gram_solve_gather(m_b, nb, wt, **args), 10),
                   library_ms=None, bound_ms=b_ms, bound_by=by, width=width,
                   rows=rows, **counts)
        self.kernels["gram_solve_tiles"].update(row)
        log(f"gram_solve_tiles (row 6): {row}")
        self.check(row["rel_err"] < TOL["gram_solve_tiles"],
                   f"gram_solve_tiles rel err {row['rel_err']}")
        self.report["gather_ml25m"] = report

    def split_implicit(self, ds_t, ds_b, ds_s, u0, m0, runs):
        """The split epilogue on the bucketed layout and in the sweeps at
        the ML-25M shape (phase 6c of the module docstring): (b) and (c)
        with ``fused_epilogue=False`` for one iteration each from the
        implicit phase's u0, held to their fused runs' first iteration."""
        import numpy as np
        import torch

        from cfk_tpu_torch.models.als import device_setup
        from cfk_tpu_torch.models.ials import IALSConfig, _ials_half, train_ials
        from cfk_tpu_torch.ops.kernels import gram_kernel as gk
        from cfk_tpu_torch.ops.kernels.solve_kernel import (
            gauss_solve, gauss_solve_multi, reg_solve)

        c = IMPLICIT
        dev = torch.device("cuda")
        k = c["rank"]
        kernels = (gk.gram_gather, gk.gram_tiles, gk.gather_rows,
                   gk.gram_solve_gather, gk.gram_solve_tiles, reg_solve,
                   gauss_solve, gauss_solve_multi)
        d = ds_t.coo_dense
        obs = [torch.as_tensor(x, device=dev) for x in (
            d.user_raw.astype(np.int32), d.movie_raw.astype(np.int32))]
        report, staged = {}, None
        on_report = self.report["implicit"]
        for name, algorithm, needed, idle in (
                ("ials_bucketed", "als", ("gram_gather", "reg_solve"),
                 ("gram_solve_gather", "gram_solve_tiles", "gauss_solve")),
                ("ialspp_bucketed", "ials++", ("gather_rows", "gauss_solve"),
                 ("reg_solve", "gram_solve_gather"))):
            cfg = IALSConfig(rank=k, lam=c["lam"], alpha=c["alpha"],
                             num_iterations=1, layout="bucketed",
                             algorithm=algorithm, block_size=c["block_size"],
                             fused_epilogue=False)
            for fn in kernels:
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = train_ials(ds_b, cfg, device=dev, warm_start=(u0, m0))
            torch.cuda.synchronize()
            call_s = time.perf_counter() - t0
            launches = {fn.__name__: fn.launches for fn in kernels}
            for kname in needed:
                self.check(launches[kname] > 0,
                           f"split {name}: {kname} launched "
                           f"{launches[kname]} times")
            for kname in idle:
                self.check(launches[kname] == 0,
                           f"split {name}: {kname} launched "
                           f"{launches[kname]} times (must be 0)")
            split = (model.user_factors, model.movie_factors)
            fused = runs[name][0]
            first = rel_err(split[1], fused[1])[1]
            scores = score_rel_err(split, fused, obs[0], obs[1])
            report[name] = dict(
                call_s=call_s, fused_call_s=on_report[name]["call_s"][0],
                fused_s_per_iter=on_report[name]["s_per_iter"],
                launches=launches, first_movie_half_vs_fused=first,
                user_factors_vs_fused=rel_err(split[0], fused[0])[1],
                bit_equal_to_fused=bool(torch.equal(split[0], fused[0])
                                        and torch.equal(split[1], fused[1])),
                scores_vs_fused=scores)
            # Where the split iteration's device time goes (measurement
            # only), beside the implicit phase's profile of the fused run.
            if staged is None:
                staged = device_setup(ds_b, cfg, dev, weighted=True)
            mblk, ublk, kw, _ = staged
            half = functools.partial(
                _ials_half, lam=c["lam"], alpha=c["alpha"], solver="auto",
                algorithm=algorithm, block_size=c["block_size"],
                fused_epilogue=False)
            u_i, m_i = split
            report[name]["profile"] = profile_calls(lambda: (
                half(u_i, mblk, chunks=kw["m_chunks"],
                     entities=kw["m_entities"], x_prev=m_i),
                half(m_i, ublk, chunks=kw["u_chunks"],
                     entities=kw["u_entities"], x_prev=u_i)), 1)
            report[name]["fused_profile"] = on_report[name].get("profile")
            log(f"split {name}: {report[name]}")
            self.check(first < TOL["first_half_factors"],
                       f"split {name}: first movie half differs from the "
                       f"fused run by {first}")
            self.check(scores < TOL["scores"],
                       f"split {name}: scores differ from the fused run by "
                       f"{scores}")
            del model, split, u_i, m_i
        del obs, staged
        self.report["split_ml25m"] = report

    def implicit_kernel_checks(self, ds_t, ds_b, blocks, runs, report):
        """K5, K6 and K1-K3 in their implicit modes against their plain
        versions on a middle bucket / chunk of the implicit runs, with
        times, bounds and yardsticks; K6's time per width class."""
        import torch

        from cfk_tpu_torch.ops.bucketed import bucket_gram_solve, ials_reparam
        from cfk_tpu_torch.ops.kernels.gram_kernel import (
            gather_rows, gather_rows_plain, gram_gather, gram_gather_plain,
            gram_solve_dense, gram_solve_dense_plain, gram_solve_gather,
            gram_solve_gather_plain)
        from cfk_tpu_torch.ops.kernels.solve_kernel import (
            GJ_MAX_RANK, gauss_jordan_plain, gauss_solve, gauss_solve_multi,
            gauss_solve_plain, reg_solve, reg_solve_plain)
        from cfk_tpu_torch.ops.solve import (
            global_gram, global_gram_blocked, implicit_reg)
        from cfk_tpu_torch.ops.tiled import (
            accum_chunk, accum_grams, dense_chunk, ials_tiled_weights)

        c = IMPLICIT
        dev = torch.device("cuda")
        lam, alpha, k = c["lam"], c["alpha"], c["rank"]
        modes = {}

        def timed(row, fn, plain, library=None):
            row.update(ms=time_ms(fn, 10), plain_ms=time_ms(plain, 3),
                       library_ms=None if library is None
                       else time_ms(library, 3))
            return row

        # K6: the middle width class of (b)'s user half, its final factors.
        u_b, m_b = runs["ials_bucketed"][-1]
        reg_b = implicit_reg(global_gram_blocked(m_b), lam)
        buckets = ds_b.user_blocks.buckets
        bk = buckets[len(buckets) // 2]
        nb = torch.as_tensor(bk.neighbor_idx, device=dev)
        mk = torch.as_tensor(bk.mask, device=dev)
        rt = torch.as_tensor(bk.rating, device=dev)
        wt, rt_b = ials_reparam(rt, mk, alpha)
        rows, width = nb.shape
        args = dict(nb=nb.reshape(-1), wt=wt.reshape(-1).contiguous(),
                    rt=rt_b.reshape(-1).contiguous(),
                    seg=torch.arange(rows, dtype=torch.int32, device=dev),
                    reg=reg_b, lseg=rows - 1, num_segments=rows,
                    tile_rows=width, reg_mode="matrix",
                    units=class_plan(rows, width, dev))
        got = gram_solve_gather(m_b, **args)
        again = gram_solve_gather(m_b, **args)
        torch.cuda.synchronize()
        want = gram_solve_gather_plain(m_b, **args)
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        nbytes, flops, counts = gram_solve_gather_work(m_b, args, "matrix")
        b_ms, by = bound(nbytes, flops)
        row = timed(dict(max_abs_err=max(e[0] for e in errs),
                         rel_err=max(e[1] for e in errs), bound_ms=b_ms,
                         bound_by=by, width=width, rows=rows,
                         two_launches_bit_equal=all(
                             torch.equal(x, y) for x, y in zip(got, again)),
                         **counts),
                    lambda: gram_solve_gather(m_b, **args),
                    lambda: gram_solve_gather_plain(m_b, **args))
        self.kernels["gram_solve_gather"].update(row)
        log(f"K6 gram_solve_gather: {row}")
        self.check(row["rel_err"] < TOL["gram_solve_gather"],
                   f"gram_solve_gather rel err {row['rel_err']}")
        self.check(row["two_launches_bit_equal"],
                   "gram_solve_gather: two launches differ")
        del got, again, want
        # K6's time per width class, both halves of (b) (one launch each,
        # with the work-unit plan the device upload stages for the class).
        per_class = {}
        for side, blocks_b, table in (("movie", ds_b.movie_blocks, u_b),
                                      ("user", ds_b.user_blocks, m_b)):
            reg = implicit_reg(global_gram_blocked(table), lam)
            out = []
            for b in blocks_b.buckets:
                nb_c = torch.as_tensor(b.neighbor_idx, device=dev)
                mk_c = torch.as_tensor(b.mask, device=dev)
                w_c, r_c = ials_reparam(torch.as_tensor(b.rating, device=dev),
                                        mk_c, alpha)
                rows_c = int(nb_c.shape[0])
                plan = class_plan(rows_c, b.width, dev)
                ms = time_ms(lambda: bucket_gram_solve(
                    table, nb_c, w_c, r_c, reg, lam=0.0, reg_mode="matrix",
                    units=plan), 1)
                out.append(dict(width=b.width, rows=rows_c,
                                live=int(b.count.sum()),
                                max_live=int(b.count.max()), ms=ms,
                                units=int(plan.units.shape[0]),
                                split_segments=int(plan.splits.shape[0])))
            per_class[side] = out
        report["k6_ms_per_width_class"] = per_class
        report["k6_ms_summed_over_classes"] = sum(
            r["ms"] for rows_c in per_class.values() for r in rows_c)
        log(f"K6 ms per width class: {per_class}; summed "
            f"{report['k6_ms_summed_over_classes']:.3f} ms")
        # The head class: the widest movie class (one Zipf-head movie).
        report["k6_head_class"] = max(per_class["movie"],
                                      key=lambda r: r["width"])
        log(f"K6 head class: {report['k6_head_class']}")

        # K5: the middle width class of (c)'s user half (its first piece).
        u_c, m_c = runs["ialspp_bucketed"][-1]
        piece = bk.chunk_rows or rows
        nb5 = nb[:piece].reshape(-1)
        wt5 = mk[:piece].reshape(-1).contiguous()
        got = gather_rows(m_c, nb5, wt5)
        torch.cuda.synchronize()
        want = gather_rows_plain(m_c, nb5, wt5)
        err, rel = rel_err(got, want)
        idx = nb5.long()
        nbytes, flops, counts = gather_rows_work(m_c, nb5, wt5)
        b_ms, by = bound(nbytes, flops)
        row = timed(dict(max_abs_err=err, rel_err=rel, bound_ms=b_ms,
                         bound_by=by, width=width, rows=piece, **counts),
                    lambda: gather_rows(m_c, nb5, wt5),
                    lambda: gather_rows_plain(m_c, nb5, wt5),
                    lambda: m_c.index_select(0, idx) * wt5[:, None])
        self.kernels["gather_rows"].update(row)
        log(f"K5 gather_rows: {row}")
        self.check(err <= TOL["gather_rows"],
                   f"gather_rows differs from plain by {err}")
        del got, want, nb5, wt5, idx

        # K2 weighted and K1 matrix mode: (a)'s movie (accum) half.
        u_a, m_a = runs["ials_tiled"][-1]
        mblk, ublk, kw = blocks[:3]
        st_m = kw["m_chunks"][2:]
        blk_mw = ials_tiled_weights(mblk, "accum", alpha)
        args = with_plan(accum_chunk(blk_mw, st_m, st_m[0] // 2), blk_mw,
                         st_m[0] // 2)
        got = gram_gather(u_a, **args)
        torch.cuda.synchronize()
        want = gram_gather_plain(u_a, **args)
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        nbytes, flops, counts = gram_gather_work(u_a, args)
        b_ms, by = bound(nbytes, flops)
        modes["gram_gather_weighted"] = timed(
            dict(max_abs_err=max(e[0] for e in errs),
                 rel_err=max(e[1] for e in errs), bound_ms=b_ms, bound_by=by,
                 **counts),
            lambda: gram_gather(u_a, **args),
            lambda: gram_gather_plain(u_a, **args))
        self.check(modes["gram_gather_weighted"]["rel_err"]
                   < TOL["gram_gather"], "K2 weighted vs plain: "
                   f"{modes['gram_gather_weighted']['rel_err']}")
        a, b = accum_grams(u_a, blk_mw, kw["m_entities"], statics=st_m)
        reg_a = implicit_reg(global_gram(u_a), lam)
        got = reg_solve(a, b, reg_a, reg_mode="matrix")
        torch.cuda.synchronize()
        want = reg_solve_plain(a, b, reg_a, reg_mode="matrix")
        err, rel = rel_err(got, want)
        b_ms, by = bound(*reg_solve_work(a.shape[0], k))
        modes["reg_solve_matrix"] = timed(
            dict(max_abs_err=err, rel_err=rel, bound_ms=b_ms, bound_by=by,
                 e=a.shape[0], k=k),
            lambda: reg_solve(a, b, reg_a, reg_mode="matrix"),
            lambda: reg_solve_plain(a, b, reg_a, reg_mode="matrix"),
            lambda: torch.linalg.solve(a + reg_a, b))
        self.check(rel < TOL["reg_solve"], f"K1 matrix mode rel err {rel}")
        del got, want
        # Row 12 at the Schur shape: the blocked solve's first step,
        # Y = A₁₁⁻¹[A₁₂ | b₁], on these systems with their ridge (k = 64,
        # m = 65), A₁₁ read in place from the [E, 128, 128] batch as the
        # blocked solve hands it over.
        a.add_(reg_a)
        k1 = GJ_MAX_RANK
        k2 = k - k1
        rhs = torch.cat([a[:, :k1, k1:], b[:, :k1, None]], dim=2)
        e = a.shape[0]
        al, rl = a[:, :k1, :k1].permute(1, 2, 0), rhs.permute(1, 2, 0)
        got = gauss_solve_multi(al, rl)
        again = gauss_solve_multi(al, rl)
        torch.cuda.synchronize()
        want = gauss_jordan_plain(al, rl)
        err, rel = rel_err(got, want)
        twice = bool(torch.equal(got, again))
        del again, want
        b_ms, by = bound(*gauss_work(e, k1, k1 + 1))
        self.kernels.setdefault("gauss_solve_multi", {}).update(timed(
            dict(max_abs_err=err, rel_err=rel, bit_equal_twice=twice,
                 bound_ms=b_ms, bound_by=by, e=e, k=k1, m=k1 + 1),
            lambda: gauss_solve_multi(al, rl),
            lambda: gauss_jordan_plain(al, rl),
            lambda: torch.linalg.solve(a[:, :k1, :k1], rhs)))
        log(f"gauss_solve_multi: {self.kernels['gauss_solve_multi']}")
        self.check(rel < TOL["gauss_solve_multi"],
                   f"gauss_solve_multi rel err {rel}")
        self.check(twice, "gauss_solve_multi: two launches differ")
        # Row 11 on the Schur complement S = A₂₂ − A₂₁·Y₁₂ and its
        # right-hand side, formed as the blocked solve forms them (float32
        # products: S is symmetric only to its last bits, and the kernel
        # reads its lower triangle), against the plain Gauss-Jordan on the
        # full S and x₂ against a float64 solve of the full S.
        y = got.permute(2, 0, 1)
        y12, y1 = y[:, :, :k2], y[:, :, k2]
        sc = a[:, k1:, k1:] - a[:, k1:, :k1] @ y12
        r2 = b[:, k1:] - (a[:, k1:, :k1] @ y1[:, :, None])[:, :, 0]
        # x₂ of a float64 solve of the whole system: what S's float32
        # rounding (both triangles) and the solve's together miss.
        x_true = torch.cat([
            torch.linalg.solve(a[lo:lo + 8192].double(),
                               b[lo:lo + 8192].double())[:, k1:]
            for lo in range(0, e, 8192)]).T
        del a, b, rhs, al, rl, got, y, y12, y1
        sl, r2l = sc.permute(1, 2, 0), r2.T
        x2 = gauss_solve(sl, r2l)
        again = gauss_solve(sl, r2l)
        torch.cuda.synchronize()
        want = gauss_solve_plain(sl, r2l)
        x64 = torch.linalg.solve(sc.double(), r2.double()).T
        sym = gauss_solve(((sc + sc.transpose(1, 2)) / 2).permute(1, 2, 0),
                          r2l)

        def rel64(x, ref=x64):
            return float((x.double() - ref).abs().max() / ref.abs().max())

        err, rel = rel_err(x2, want)
        b_ms, by = bound(*gauss_work(e, k2, 1))
        schur = timed(dict(
            e=e, k=k2, max_abs_err=err, rel_err=rel,
            bit_equal_twice=bool(torch.equal(x2, again)),
            asymmetry=float((sc - sc.transpose(1, 2)).abs().max()
                            / sc.abs().max()),
            x2_rel_err_float64=rel64(x2),
            x2_rel_err_float64_gauss_jordan=rel64(want),
            x2_rel_err_float64_symmetrized=rel64(sym),
            x2_rel_err_whole_float64=rel64(x2, x_true),
            x2_rel_err_whole_float64_gauss_jordan=rel64(want, x_true),
            x2_rel_err_whole_float64_symmetrized=rel64(sym, x_true),
            bound_ms=b_ms, bound_by=by),
            lambda: gauss_solve(sl, r2l), lambda: gauss_solve_plain(sl, r2l),
            lambda: torch.linalg.solve(sc, r2))
        del x2, again, want, x64, x_true, sym
        report["gauss_solve_schur"] = schur
        self.kernels.setdefault("gauss_solve", {}).update(
            ms_schur=schur["ms"], bound_ms_schur=b_ms,
            library_ms_schur=schur["library_ms"])
        log(f"gauss_solve on the Schur complement: {schur}")
        self.check(rel < TOL["gauss_solve"],
                   f"gauss_solve on S rel err {rel}")
        self.check(schur["bit_equal_twice"],
                   "gauss_solve on S: two launches differ")
        self.check(schur["x2_rel_err_float64"]
                   <= 4 * schur["x2_rel_err_float64_gauss_jordan"]
                   + 4 * 2.0 ** -24,
                   f"gauss_solve on S: x2 vs float64 "
                   f"{schur['x2_rel_err_float64']}, Gauss-Jordan's "
                   f"{schur['x2_rel_err_float64_gauss_jordan']}")
        del sc, r2, sl, r2l
        # K3 weighted + matrix: (a)'s middle dense chunk, with its carry
        # threaded from the last chunk that starts a fresh segment.
        st_u = kw["u_chunks"][2:]
        cap = st_u[1]
        blk_uw = ials_tiled_weights(ublk, "dstream", alpha)
        reg_u = implicit_reg(global_gram(m_a), lam)
        mid = st_u[0] // 2
        cin_all = blk_uw["carry_in"].cpu()
        start = max(j for j in range(mid + 1) if j == 0 or cin_all[j] == 0)
        a0 = torch.zeros((k, k), device=dev)
        b0 = torch.zeros((k,), device=dev)
        for ci in range(start, mid + 1):
            args = with_plan(dense_chunk(blk_uw, st_u, ci), blk_uw, ci)
            cin = args.pop("cin")
            args.update(wt=blk_uw["aweight_dense"][ci * cap:(ci + 1) * cap],
                        reg=reg_u)
            carry = (a0, b0, cin)
            if ci < mid:
                _, a0, b0 = gram_solve_dense(m_a, **args, lam=0.0,
                                             reg_mode="matrix", carry=carry)
        got = gram_solve_dense(m_a, **args, lam=0.0, reg_mode="matrix",
                               carry=carry)
        torch.cuda.synchronize()
        want = gram_solve_dense_plain(m_a, **args, lam=0.0, reg_mode="matrix",
                                      carry=carry)
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        nbytes, flops, counts = gram_solve_dense_work(m_a, args)
        b_ms, by = bound(nbytes, flops)
        modes["gram_solve_dense_weighted_matrix"] = timed(
            dict(max_abs_err=max(e[0] for e in errs),
                 rel_err=max(e[1] for e in errs), bound_ms=b_ms, bound_by=by,
                 chunk=mid, carry_from=start, **counts),
            lambda: gram_solve_dense(m_a, **args, lam=0.0, reg_mode="matrix",
                                     carry=carry),
            lambda: gram_solve_dense_plain(m_a, **args, lam=0.0,
                                           reg_mode="matrix", carry=carry))
        self.check(modes["gram_solve_dense_weighted_matrix"]["rel_err"]
                   < TOL["gram_solve_dense"], "K3 weighted+matrix vs plain: "
                   f"{modes['gram_solve_dense_weighted_matrix']['rel_err']}")
        report["kernel_modes"] = modes
        log(f"K1-K3 implicit modes: {modes}")

    def pipeline_case(self, name, ds, config, warm_start, *, implicit,
                      tol=None, timeline=True):
        """One pipeline case: ``config`` trained with overlap on and every
        iteration after the first captured (``capture=True``), and with
        overlap off, from ``warm_start`` (None: the config's seeded init),
        every launch counter zeroed before each run; the factors bit-equal
        (or within ``tol`` of the largest |factor|); the captured run's
        counters (its eager iteration 1) plus the replays of what its
        capture recorded equal to the serial run's counters, and the graph
        holding one node of each recorded launch's kernel
        (``replay_launches``); the route the configuration takes by
        default; s/iter, capture and instantiation seconds, the graph's
        pool; with ``timeline``, one eager iteration (overlap off) and one
        replay of a captured iteration profiled (``device_timeline``).
        Returns the two models, keyed by overlap."""
        import dataclasses

        import torch

        from cfk_tpu_torch.models.als import (
            als_steps, base_overrides, pipeline_route, train_als)
        from cfk_tpu_torch.models.ials import ials_steps, train_ials
        from cfk_tpu_torch.ops.pipeline import (
            CapturedStep, launch_counters, replay_launches)

        dev = torch.device("cuda")
        train = train_ials if implicit else train_als
        iters = config.num_iterations
        out = dict(iterations=iters, route_default=pipeline_route(
            config, dev), card=card_line())
        models = {}
        for overlap in (True, False):
            cfg = dataclasses.replace(config, overlap=overlap,
                                      capture=overlap)
            for fn in launch_counters():
                fn.launches = 0
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = train(ds, cfg, device=dev, warm_start=warm_start)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            models[overlap] = model
            out["on" if overlap else "off"] = dict(
                train_s=train_s, s_per_iter=train_s / iters,
                peak_device_bytes=torch.cuda.max_memory_allocated(),
                launches={fn.__name__: fn.launches
                          for fn in launch_counters()},
                **model.pipeline)
        on, off = models[True], models[False]
        pairs = ((on.user_factors, off.user_factors),
                 (on.movie_factors, off.movie_factors))
        out["bit_equal"] = all(torch.equal(a, b) for a, b in pairs)
        out["max_rel_diff"] = max(rel_err(a.float(), b.float())[1]
                                  for a, b in pairs)
        finite = all(bool(torch.isfinite(a).all()) for pair in pairs
                     for a in pair)
        self.check(finite, f"pipeline {name}: non-finite factors")
        if tol is None:
            self.check(out["bit_equal"], f"pipeline {name}: overlap on and "
                       f"off differ by {out['max_rel_diff']}")
        else:
            self.check(out["max_rel_diff"] <= tol, f"pipeline {name}: "
                       f"overlap on and off differ by {out['max_rel_diff']} "
                       f"> {tol}")
        # A replay runs no wrapper: the captured run counts iteration 1,
        # and its graph must hold every launch its capture recorded.
        rec = out["on"].get("launches_per_replay") or {}
        names = set(out["on"]["launches"]) | set(out["off"]["launches"])
        out["on"]["launches_with_replays"] = {
            n: out["on"]["launches"][n] + (iters - 1) * rec.get(n, 0)
            for n in names}
        self.check(bool(rec) and out["on"]["launches_with_replays"]
                   == out["off"]["launches"],
                   f"pipeline {name}: iteration 1 + replays of the recorded "
                   f"launches {out['on']['launches_with_replays']} != the "
                   f"serial run's {out['off']['launches']}")
        replays = replay_launches(out["on"])
        out["on"]["replay_launches"] = replays
        self.check(bool(replays) and all(
            calls == nodes for calls, nodes in replays.values()),
            f"pipeline {name}: the graph's kernel nodes against the "
            f"recorded launches: {replays}")
        self.check(out["on"]["route"] == "captured"
                   and out["off"]["route"] == "serial",
                   f"pipeline {name}: routes {out['on']['route']}/"
                   f"{out['off']['route']}")
        if timeline:
            steps = ials_steps if implicit else als_steps

            def make(cfg):
                make_step, u, m = steps(ds, cfg, dev, warm_start)
                return make_step(base_overrides(cfg)), u, m

            step, u, m = make(dataclasses.replace(config, overlap=False))
            state = step((u, m), None)
            out["off"]["timeline"] = device_timeline(
                lambda: step(state, None))
            del step, state, u, m
            step, u, m = make(config)
            captured = CapturedStep(step)
            state = captured.run((u, m), 2)
            out["on"]["timeline"] = device_timeline(captured.graph.replay)
            out["on"]["graph_nodes"] = graph_nodes(captured.graph)
            out["on"]["profiled_capture"] = captured.stats
            # Does CUPTI report the kernels inside a replay?  (Their count
            # is the eager iteration's, up to the pipelined walks' own
            # scatters: the bucketed walk scatters each piece.)
            out["replay_kernels_reported"] = bool(
                out["on"]["timeline"].get("kernels"))
            del step, state, u, m, captured
            torch.cuda.empty_cache()
        out["on"]["launches"] = {k: v for k, v in out["on"]["launches"]
                                 .items() if v}
        out["off"]["launches"] = {k: v for k, v in out["off"]["launches"]
                                  .items() if v}
        self.report.setdefault("pipeline", {})[name] = out
        log(f"pipeline {name}: {out}")
        return models

    def pipeline(self, ds, model, blk_m, blk_u):
        """The chunk pipeline at the Netflix shape (phase 4g): the dense
        stream, rank 64, 3 iterations, fused, split, and the gather off
        fused and split (K5 on the side stream)."""
        from cfk_tpu_torch import ALSConfig

        for name, knobs in (
                ("netflix_fused", {}),
                ("netflix_split", dict(fused_epilogue=False)),
                ("netflix_gather_off", dict(in_kernel_gather=False)),
                ("netflix_gather_off_split", dict(in_kernel_gather=False,
                                                  fused_epilogue=False))):
            config = ALSConfig(rank=RANK, lam=LAM,
                               num_iterations=PIPELINE["iterations"], seed=0,
                               layout="tiled", **knobs)
            self.pipeline_case(name, ds, config, None, implicit=False)

    def pipeline_implicit(self, ds_t, ds_b, ds_s, u0, m0, runs):
        """The chunk pipeline at the ML-25M shape (phase 6g): iALS (a)
        tiled, (b) bucketed, (c) iALS++ bucketed (b = 32) and (e) the
        stream mode, 3 iterations each from the implicit phase's u0."""
        from cfk_tpu_torch.models.ials import IALSConfig

        c = IMPLICIT
        for name, ds, layout, algorithm in (
                ("ials_tiled", ds_t, "tiled", "als"),
                ("ials_bucketed", ds_b, "bucketed", "als"),
                ("ialspp_bucketed", ds_b, "bucketed", "ials++"),
                ("ials_stream", ds_s, "tiled", "als")):
            config = IALSConfig(rank=c["rank"], lam=c["lam"],
                                alpha=c["alpha"],
                                num_iterations=PIPELINE["iterations"],
                                layout=layout, algorithm=algorithm,
                                block_size=c["block_size"])
            self.pipeline_case(name, ds, config, (u0, m0), implicit=True)

    def resilience(self, ds, model, blk_m, blk_u):
        """Phase 4h: resilience at the Netflix shape (see the module doc) —
        the main phase's tiled blocks, rank 64, its seeded u0, through
        ``models.als.train_loop`` (``train_als``'s routing) on blocks
        uploaded once."""
        import dataclasses
        import tempfile
        import warnings

        import torch

        from cfk_tpu_torch import ALSConfig
        from cfk_tpu_torch.models.als import als_steps, train_loop
        from cfk_tpu_torch.resilience.faults import (
            FactorCorruption, FaultInjector, PreemptAt)
        from cfk_tpu_torch.resilience.preempt import PreemptionGuard
        from cfk_tpu_torch.telemetry import Metrics
        from cfk_tpu_torch.transport.checkpoint import CheckpointManager

        dev = torch.device("cuda")
        c = RESILIENCE
        base = ALSConfig(rank=RANK, lam=LAM, num_iterations=c["iterations"],
                         seed=0, layout="tiled")
        make_step, u0, m0 = als_steps(ds, base, dev, None)
        report = dict(card=card_line(), iterations=c["iterations"])

        def run(cfg, **kw):
            metrics = kw.pop("metrics", Metrics())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with warnings.catch_warnings():
                # The expected trip, degrade and preemption warnings: the
                # metrics carry them.
                warnings.simplefilter("ignore")
                u, m, rec = train_loop(ds, cfg, dev, make_step, u0, m0,
                                       model="als", metrics=metrics, **kw)
            torch.cuda.synchronize()
            return u, m, rec, time.perf_counter() - t0, metrics

        def same(a, b):
            return bool(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))

        # (a) The sentinel every iteration, on against off (the probe folded
        # into a device word on the prefetched route), in turns.
        health = dataclasses.replace(base, health_check_every=1)
        run(base)  # warm: the first run's one-time costs stay out of (a)
        times = {"off": [], "on": []}
        out = {}
        for name in ("off", "on", "on", "off"):
            u, m, rec, sec, _ = run(base if name == "off" else health)
            times[name].append(sec / c["iterations"])
            out[name] = (u, m, rec)
        free = out["off"]
        equal = same(out["on"], free)
        report["health_probe"] = dict(
            s_per_iter_off=times["off"], s_per_iter_on=times["on"],
            bit_equal=equal, route=out["on"][2]["route"],
            health=out["on"][2].get("health"))
        self.check(equal and out["on"][2].get("health") == "healthy",
                   f"resilience: health on against off {report['health_probe']}")
        del out
        # (b) A checkpoint every iteration, the synchronous writer against
        # the async one (the eager stepped loop): the saved steps' crc32s
        # equal, the final factors equal to the fault-free run's.
        ck = {}
        for name, async_write in (("sync", False), ("async", True),
                                  ("async", True), ("sync", False)):
            with tempfile.TemporaryDirectory() as d:
                mgr = CheckpointManager(d, async_write=async_write)
                u, m, rec, sec, metrics = run(base, checkpoint_manager=mgr)
                crcs = {it: mgr._manifest(it)["crc32"]
                        for it in mgr.iterations()}
            ck.setdefault(name, dict(s_per_iter=[], loop_checkpoint_s=[]))
            ck[name]["s_per_iter"].append(sec / c["iterations"])
            ck[name]["loop_checkpoint_s"].append(
                metrics.phases.get("checkpoint", 0.0))
            ck[name]["crc32"] = crcs
            ck[name]["equal_to_fault_free"] = same((u, m), free)
            ck[name]["route"] = rec["route"]
        ck["step_bytes"] = 4 * (u0.numel() + m0.numel())
        ck["crc_equal"] = ck["sync"]["crc32"] == ck["async"]["crc32"]
        report["checkpoint"] = ck
        self.check(ck["crc_equal"] and ck["sync"]["equal_to_fault_free"]
                   and ck["async"]["equal_to_fault_free"]
                   and len(ck["async"]["crc32"]) == c["iterations"],
                   f"resilience: checkpoints {ck}")
        # (c) NaN rows before iteration 2 (the stepped loop, the sentinel
        # every iteration): trip, rollback to the last-good device copy,
        # replay — ending bit-equal to the fault-free run; the recovery's
        # seconds beside the same plan's stepped run with no fault.
        _, _, _, clean_s, _ = run(health, fault_injector=FaultInjector())
        inj = FaultInjector(FactorCorruption(iteration=2))
        u, m, rec, fault_s, metrics = run(health, fault_injector=inj)
        nan = dict(fired=inj.fired,
                   trips=metrics.counters.get("health_trips", 0),
                   rollbacks=metrics.counters.get("rollbacks", 0),
                   notes=dict(metrics.notes), bit_equal=same((u, m), free),
                   stepped_s=clean_s, faulted_s=fault_s,
                   recovery_s=fault_s - clean_s, route=rec["route"])
        report["nan_trip"] = nan
        self.check(nan["fired"] == 1 and nan["trips"] == 1
                   and nan["rollbacks"] == 1 and nan["bit_equal"],
                   f"resilience: NaN trip {nan}")
        # (d) The captured route (capture=True, only the sentinel armed):
        # λ = 0 leaves users with fewer ratings than the rank singular, so
        # the probe in the captured iteration trips; the run is replayed
        # through the eager loop from u0 and the ladder's λ bumps end it —
        # bit-equal to the same plan on the eager stepped loop from the
        # start.  The equality is the captured route's: a fault injector
        # would itself send the run to the eager loop.
        cap_cfg = dataclasses.replace(health, lam=0.0, capture=True,
                                      max_recoveries=c["max_recoveries"])
        u, m, rec, cap_s, cap_metrics = run(cap_cfg)
        su, sm, _, step_s, step_metrics = run(
            cap_cfg, fault_injector=FaultInjector())
        captured = dict(
            fused_loop_trip=cap_metrics.notes.get("fused_loop_trip"),
            notes=dict(cap_metrics.notes), route=rec["route"],
            reason=rec["reason"],
            trips=cap_metrics.counters.get("health_trips", 0),
            stepped_trips=step_metrics.counters.get("health_trips", 0),
            escalation_level=cap_metrics.gauges.get("escalation_level"),
            degraded=cap_metrics.gauges.get("degraded", 0),
            finite=bool(torch.isfinite(u).all() and torch.isfinite(m).all()),
            bit_equal=same((u, m), (su, sm)), captured_s=cap_s,
            stepped_s=step_s,
            discarded_s=cap_metrics.phases.get("train_discarded"))
        report["captured_trip"] = captured
        self.check(captured["fused_loop_trip"] is not None
                   and captured["trips"] == captured["stepped_trips"] >= 1
                   and captured["bit_equal"] and captured["finite"],
                   f"resilience: captured-route trip {captured}")
        del su, sm
        # (e) SIGTERM before iteration 2 of 4 under a PreemptionGuard: step
        # 3 committed, then the resume ends bit-equal to the uninterrupted
        # run.
        pre_cfg = dataclasses.replace(base, num_iterations=4)
        full = run(pre_cfg)[:2]
        with tempfile.TemporaryDirectory() as d:
            metrics = Metrics()
            inj = FaultInjector(PreemptAt(iteration=2))
            with PreemptionGuard() as guard:
                run(pre_cfg, checkpoint_manager=CheckpointManager(d),
                    fault_injector=inj, preemption_guard=guard,
                    metrics=metrics)
            mgr = CheckpointManager(d)
            committed = mgr.latest_valid_iteration()
            u, m, rec, resume_s, _ = run(pre_cfg, checkpoint_manager=mgr)
        pre = dict(fired=inj.fired, signal=guard.signal_name,
                   committed=committed, note=metrics.notes.get("preempted"),
                   resume_s=resume_s, bit_equal=same((u, m), full))
        report["preemption"] = pre
        self.check(pre["fired"] == 1 and committed == 3 and pre["bit_equal"],
                   f"resilience: preemption {pre}")
        self.report["resilience"] = report
        log(f"resilience: {report}")

    def stream(self, ds, model, blk_m, blk_u):
        """Phase 4i: streaming fold-in at the Netflix shape (see the module
        doc) — the main phase's dataset and trained model, rank 64."""
        import tempfile
        import zlib

        import numpy as np
        import torch

        from cfk_tpu_torch import ALSConfig
        from cfk_tpu_torch.data.blocks import RatingsIndex
        from cfk_tpu_torch.data.synthetic import synthetic_netflix_coo
        from cfk_tpu_torch.models.als import _tiled_to_device
        from cfk_tpu_torch.ops.kernels.gram_kernel import gram_gather
        from cfk_tpu_torch.ops.kernels.solve_kernel import reg_solve
        from cfk_tpu_torch.ops.tiled import accum_chunk
        from cfk_tpu_torch.resilience.faults import FlakyPlan, FlakyTransport
        from cfk_tpu_torch.resilience.loop import drain_checkpoints
        from cfk_tpu_torch.serving import ServeEngine, engine_from_model
        from cfk_tpu_torch.serving.topk_kernel import topk_scores
        from cfk_tpu_torch.streaming import (
            StreamConfig, StreamProducer, StreamSession, StreamState,
            fold_in_rows)
        from cfk_tpu_torch.streaming.foldin import tiled_blocks
        from cfk_tpu_torch.transport import CheckpointManager, FileBroker

        c = STREAM
        dev = torch.device("cuda")
        report = dict(card=card_line(), updates=c["updates"],
                      partitions=c["partitions"],
                      batch_records=c["batch_records"])
        t0 = time.perf_counter()
        StreamState(ds)
        report["state_s"] = time.perf_counter() - t0
        # The log: seeded raw ids of the dataset, ratings 1-5, the new
        # users' updates spread through it; fsync'd appends, 4 partitions.
        rng = np.random.default_rng(c["seed"])
        n_new = c["new_users"]
        users = np.concatenate([
            rng.choice(ds.user_map.raw_ids, c["updates"] - n_new),
            int(ds.user_map.raw_ids.max()) + 1 + np.arange(n_new)])
        users = users[rng.permutation(users.shape[0])]
        movies = rng.choice(ds.movie_map.raw_ids, c["updates"])
        ratings = rng.integers(1, 6, c["updates"]).astype(np.float32)
        tmp = tempfile.TemporaryDirectory()
        root = Path(tmp.name)
        broker = FileBroker(str(root / "log"), fsync=True)
        t0 = time.perf_counter()
        StreamProducer(broker, num_partitions=c["partitions"]).send_many(
            users, movies, ratings)
        report["produce_s"] = time.perf_counter() - t0
        config = ALSConfig(rank=RANK, lam=LAM, num_iterations=ITERS, seed=0,
                           layout="tiled", health_check_every=1)

        def session(name, transport, **kw):
            return StreamSession(
                ds, config, transport,
                CheckpointManager(str(root / name), keep_last_n=2),
                stream=StreamConfig(batch_records=c["batch_records"]),
                device=dev, **kw)

        def drain(sess, max_batches=None):
            """Step through the batches (each one's seconds), then drain
            the async writer (its seconds)."""
            secs = []
            while max_batches is None or len(secs) < max_batches:
                t0 = time.perf_counter()
                if sess.step() is None:
                    break
                secs.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            drain_checkpoints(sess.manager)
            return secs, time.perf_counter() - t0

        def crc(sess):
            return zlib.crc32(sess.user_factors.tobytes())

        # (a) The clean run, an engine attached; K1's and K2's counts
        # zeroed just before and read just after.
        for fn in (reg_solve, gram_gather):
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        clean = session("clean", broker, base_model=model)
        init_s = time.perf_counter() - t0
        eng = engine_from_model(model, None)
        eng.attach_session(clean)
        secs, drain_s = drain(clean)
        launches = {fn.__name__: fn.launches for fn in (reg_solve, gram_gather)}
        peak = torch.cuda.max_memory_allocated()
        phases = {k: clean.metrics.phases.get(k, 0.0) for k in (
            "stage", "foldin_solve", "health_check", "commit")}
        run = dict(
            batches=len(secs), session_init_s=init_s, batch_s=secs,
            p50_batch_s=float(np.median(secs)) if secs else None,
            max_batch_s=max(secs) if secs else None, drain_s=drain_s,
            updates_per_s=c["updates"] / (sum(secs) + drain_s),
            phase_s=phases, peak_device_bytes=peak, launches=launches,
            counters=dict(clean.metrics.counters),
            touched_users=len(clean.state._delta),
            users=clean.state.num_users, layout=clean._layout)
        report["run"] = run
        log(f"stream: {len(secs)} batches, {run['updates_per_s']:.0f} "
            f"updates/s, p50 {run['p50_batch_s']:.3f} s max "
            f"{run['max_batch_s']:.3f} s, phases {phases}, drain "
            f"{drain_s:.2f} s, peak {peak / 2**30:.2f} GiB, launches "
            f"{launches} ({report['card']})")
        self.check(len(secs) >= c["updates"] // (c["batch_records"]
                                                 * c["partitions"])
                   and clean.backlog() == 0 and clean._layout == "tiled",
                   f"stream: the clean run {run}")
        for name, n in launches.items():
            self.check(n > 0, f"stream: fold-in launched {name} {n} times")
        # Parity: every touched row against the plain versions on the same
        # neighbor lists and movie factors; untouched rows as the base's.
        u_clean = clean.user_factors.copy()
        touched = np.asarray(sorted(clean.state._delta), np.int64)
        nd = [clean.state.neighbors(int(r)) for r in touched]
        m_cpu = clean.movie_factors.cpu()
        lam = clean._overrides.lam
        t0 = time.perf_counter()
        want = fold_in_rows(m_cpu, nd, lam=lam, layout="tiled")
        plain_s = time.perf_counter() - t0
        diff, rel = rel_err(torch.from_numpy(u_clean[touched]),
                            torch.from_numpy(want))
        base_u = model.user_factors.float().cpu().numpy()
        untouched = np.setdiff1d(np.arange(base_u.shape[0]), touched)
        untouched_equal = bool(np.array_equal(u_clean[untouched],
                                              base_u[untouched]))
        report["parity"] = dict(rows=int(touched.shape[0]), max_abs=diff,
                                rel=rel, tol=TOL["reg_solve"],
                                plain_s=plain_s,
                                untouched_equal=untouched_equal)
        self.check(rel <= TOL["reg_solve"] and untouched_equal,
                   f"stream: fold-in vs plain {report['parity']}")
        # The fold-in's kernels on one batch-sized set of touched users
        # (device ms per call, torch.profiler), beside the plain versions.
        batch = nd[: c["batch_records"] * c["partitions"]]
        rows_b = sum(mv.shape[0] for mv, _ in batch)
        # K2's work on this batch: gram_gather_work over the chunks the
        # fold-in stages, and its reduce kernel's time where a plan splits
        # a segment across units.
        m_dev = clean.movie_factors
        bb = tiled_blocks(batch, int(m_dev.shape[0]))
        self.check(bb.mode == "accum", f"stream: fold-in blocks {bb.mode}")
        blk_b = _tiled_to_device(bb, dev, int(m_dev.shape[0]))
        args_b = [with_plan(accum_chunk(blk_b, bb.statics, ch), blk_b, ch)
                  for ch in range(bb.statics[0])]
        work = [gram_gather_work(m_dev, a) for a in args_b]
        splits = sum(int((a["units"].splits >= 0).sum()) for a in args_b)
        del blk_b, args_b
        call = lambda: fold_in_rows(m_dev, batch,  # noqa: E731
                                    lam=lam, layout="tiled")
        k2_names = ("gram_kernel",) + (("gram_reduce_kernel",) if splits
                                       else ())
        k_ms = kernels_ms(call, 3, *k2_names, "reg_solve_kernel")
        k2_ms = sum(k_ms[n] for n in k2_names)
        wall_ms = time_ms(call, 3)
        t0 = time.perf_counter()
        fold_in_rows(m_cpu, batch, lam=lam, layout="tiled")
        plain_ms = (time.perf_counter() - t0) * 1e3
        k2_bound = bound(sum(w[0] for w in work), sum(w[1] for w in work))
        k1_bound = bound(*reg_solve_work(len(batch), RANK))
        self.kernels.setdefault("gram_gather", {})["foldin"] = dict(
            launches=launches["gram_gather"], users=len(batch),
            ratings=rows_b, chunks=len(work), split_segments=splits,
            distinct_table_rows=sum(w[2]["distinct_table_rows"]
                                    for w in work),
            ms=k2_ms, bound_ms=k2_bound[0], bound_by=k2_bound[1],
            call_ms=wall_ms, plain_call_ms=plain_ms)
        self.kernels.setdefault("reg_solve", {})["foldin"] = dict(
            launches=launches["reg_solve"], users=len(batch),
            ms=k_ms["reg_solve_kernel"], bound_ms=k1_bound[0],
            bound_by=k1_bound[1])
        report["batch_kernels"] = dict(k_ms, k2_ms=k2_ms, call_ms=wall_ms,
                                       plain_call_ms=plain_ms,
                                       users=len(batch), ratings=rows_b)
        # (b) Serving freshness: the attached engine's top-100 for 64
        # touched users against an engine built from the committed step.
        rows = touched[: c["serve_users"]]
        topk_scores.launches = 0
        _, ids_hot = eng.topk(rows, c["k"], exclude_seen=False)
        k4 = topk_scores.launches
        st = CheckpointManager(str(root / "clean")).restore()
        fresh = ServeEngine(st.user_factors, st.movie_factors,
                            num_users=clean.state.num_users,
                            num_movies=ds.movie_map.num_entities, device=dev)
        _, ids_fresh = fresh.topk(rows, c["k"], exclude_seen=False)
        k4_ms = time_ms(lambda: eng.topk(rows, c["k"], exclude_seen=False),
                        5)
        serve = dict(users=int(rows.shape[0]), k=c["k"], launches=k4,
                     ids_equal=bool(np.array_equal(ids_hot, ids_fresh)),
                     invalidations=eng.invalidations, call_ms=k4_ms,
                     committed_step=st.iteration)
        self.kernels.setdefault("topk_scores", {})["foldin"] = dict(
            launches=k4, users=int(rows.shape[0]), k=c["k"], call_ms=k4_ms)
        report["serve"] = serve
        self.check(serve["ids_equal"] and k4 > 0,
                   f"stream: attached engine vs fresh {serve}")
        del eng, fresh, st
        # (c) A crash after 8 batches, resumed from the store.
        crash = session("crash", broker, base_model=model)
        drain(crash, c["crash_after"])
        del crash
        t0 = time.perf_counter()
        resumed = session("crash", broker)
        resume_s = time.perf_counter() - t0
        resumed_from = resumed.stream_step
        secs_r, _ = drain(resumed)
        report["crash_replay"] = dict(
            resumed_from=resumed_from, resume_s=resume_s,
            replayed_updates=resumed.metrics.counters.get(
                "replayed_updates", 0), batches_after=len(secs_r),
            crc_equal=crc(resumed) == crc(clean))
        self.check(resumed_from == c["crash_after"]
                   and report["crash_replay"]["crc_equal"],
                   f"stream: crash replay {report['crash_replay']}")
        del resumed
        # (d) Duplicated, reordered and dropped delivery.
        flaky = FlakyTransport(broker, FlakyPlan(duplicate=3, reorder=5,
                                                 drop=7, seed=1))
        fs = session("flaky", flaky, base_model=model)
        secs_f, _ = drain(fs)
        report["flaky"] = dict(
            duplicated=flaky.duplicated, reordered=flaky.reordered,
            dropped=flaky.dropped, batches=len(secs_f),
            run_s=sum(secs_f), crc_equal=crc(fs) == crc(clean),
            duplicates_dropped=fs.metrics.counters.get(
                "delivery_duplicates", 0),
            gap_repolls=fs.metrics.counters.get("delivery_gap_repolls", 0))
        self.check(bool(flaky.duplicated and flaky.reordered
                        and flaky.dropped)
                   and report["flaky"]["crc_equal"],
                   f"stream: delivery faults {report['flaky']}")
        del fs, clean
        broker.close()
        tmp.cleanup()
        # (e) The padded fold-in (K1) at the padded layout's scale: 256
        # touched users of a 1,000,000-rating synthetic set, seeded movie
        # factors, against its plain version.
        pidx = RatingsIndex.from_coo(synthetic_netflix_coo(
            **c["padded_shape"], seed=3))
        pstate = StreamState(pidx)
        prow = rng.choice(pstate.num_users, c["padded_users"], replace=False)
        pnd = [pstate.neighbors(int(r)) for r in prow]
        m_np = np.random.default_rng(c["seed"]).standard_normal(
            (pidx.movie_map.num_entities, RANK)).astype(np.float32)
        m_dev = torch.as_tensor(m_np, device=dev)
        reg_solve.launches = 0
        got = fold_in_rows(m_dev, pnd, lam=LAM, layout="padded")
        k1_padded = reg_solve.launches
        want = fold_in_rows(torch.from_numpy(m_np), pnd, lam=LAM,
                            layout="padded")
        pdiff, prel = rel_err(torch.from_numpy(got), torch.from_numpy(want))
        width = max(mv.shape[0] for mv, _ in pnd)
        padded = dict(users=len(pnd), width=int(width), launches=k1_padded,
                      max_abs=pdiff, rel=prel,
                      call_ms=time_ms(lambda: fold_in_rows(
                          m_dev, pnd, lam=LAM, layout="padded"), 3),
                      k1_ms=kernel_ms(lambda: fold_in_rows(
                          m_dev, pnd, lam=LAM, layout="padded"), 3,
                          "reg_solve_kernel"))
        self.kernels["reg_solve"]["foldin_padded"] = padded
        report["padded"] = padded
        self.check(k1_padded > 0 and prel <= TOL["reg_solve"],
                   f"stream: padded fold-in {padded}")
        self.report["stream"] = report
        log(f"stream: {report}")

    def resilience_implicit(self, ds_t, ds_b, ds_s, u0, m0, runs):
        """Phase 6h: one iALS (b) call at the ML-25M shape (the implicit
        phase's bucketed blocks and u0) with NaN rows before iteration 1
        and the sentinel every iteration, against its fault-free call:
        bit-equal."""
        import warnings

        import torch

        from cfk_tpu_torch.models.ials import IALSConfig, ials_steps
        from cfk_tpu_torch.models.als import train_loop
        from cfk_tpu_torch.resilience.faults import (
            FactorCorruption, FaultInjector)
        from cfk_tpu_torch.telemetry import Metrics

        c = IMPLICIT
        dev = torch.device("cuda")
        cfg = IALSConfig(rank=c["rank"], lam=c["lam"], alpha=c["alpha"],
                         num_iterations=2, layout="bucketed",
                         health_check_every=1)
        make_step, u, m = ials_steps(ds_b, cfg, dev, (u0, m0))
        out = {}
        for name, inj in (("fault_free", None),
                          ("nan", FaultInjector(FactorCorruption(1)))):
            metrics = Metrics()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                fu, fm, rec = train_loop(ds_b, cfg, dev, make_step, u, m,
                                         model="ials", metrics=metrics,
                                         fault_injector=inj)
            torch.cuda.synchronize()
            out[name] = dict(factors=(fu, fm), s=time.perf_counter() - t0,
                             route=rec["route"],
                             trips=metrics.counters.get("health_trips", 0),
                             rollbacks=metrics.counters.get("rollbacks", 0))
        a, b = out["fault_free"].pop("factors"), out["nan"].pop("factors")
        out["bit_equal"] = bool(torch.equal(a[0], b[0])
                                and torch.equal(a[1], b[1]))
        out["card"] = card_line()
        self.report["resilience_ml25m"] = out
        log(f"resilience_ml25m: {out}")
        self.check(out["bit_equal"] and out["nan"]["trips"] == 1
                   and out["nan"]["rollbacks"] == 1,
                   f"resilience_ml25m: {out}")

    def small_parity(self):
        import numpy as np
        import torch

        from cfk_tpu_torch import ALSConfig, Dataset, train_als
        from cfk_tpu_torch.data.synthetic import synthetic_netflix_coo
        from cfk_tpu_torch.models.ials import IALSConfig, train_ials

        coo = synthetic_netflix_coo(3000, 400, 60_000, seed=1)
        rng = np.random.default_rng(0)
        u0 = rng.random((3000, 16)).astype(np.float32)
        out = {}
        stream = dict(chunk_elems=2048, tile_rows=16, accum_max_entities=1000)
        tiled = dict(stream, dense_stream=True)
        bucketed = dict(chunk_elems=4096)
        for name, layout, kw, model, algorithm, fused, gather in (
                ("padded", "padded", {}, "als", "als", None, None),
                ("tiled", "tiled", tiled, "als", "als", None, None),
                ("stream", "tiled", stream, "als", "als", None, None),
                ("stream_split", "tiled", stream, "als", "als", False, None),
                ("bucketed", "bucketed", bucketed, "als", "als", None, None),
                ("alspp_bucketed", "bucketed", bucketed, "als", "als++",
                 None, None),
                ("ials_tiled", "tiled", tiled, "ials", "als", None, None),
                ("ials_bucketed", "bucketed", bucketed, "ials", "als", None,
                 None),
                ("ialspp_bucketed", "bucketed", bucketed, "ials", "ials++",
                 None, None),
                ("tiled_gather_off", "tiled", tiled, "als", "als", None,
                 False),
                ("tiled_split_gather_off", "tiled", tiled, "als", "als",
                 False, False),
                ("stream_gather_off", "tiled", stream, "als", "als", None,
                 False),
                ("stream_split_gather_off", "tiled", stream, "als", "als",
                 False, False),
                ("ials_bucketed_gather_off", "bucketed", bucketed, "ials",
                 "als", None, False)):
            ds = Dataset.from_coo(coo, layout=layout, **kw)
            common = dict(rank=16, num_iterations=3, layout=layout,
                          algorithm=algorithm, block_size=8,
                          fused_epilogue=fused, in_kernel_gather=gather)
            cfg, trainer = ((ALSConfig(**common), train_als) if model == "als"
                            else (IALSConfig(alpha=2.0, **common),
                                  train_ials))
            seed = (u0[:ds.user_map.num_entities],
                    np.zeros((ds.movie_map.num_entities, 16), np.float32))
            got = trainer(ds, cfg, device="cuda", warm_start=seed)
            want = trainer(ds, cfg, device="cpu", warm_start=seed)
            pg, pw = got.predict_dense(), want.predict_dense()
            rel = float(np.abs(pg - pw).max() / np.abs(pw).max())
            out[name] = rel
            self.check(rel < 1e-3, f"small {name}: kernels vs plain {rel}")
        self.report["small_parity_rel"] = out
        log(f"small parity (kernels on the card vs plain on the CPU): {out}")

    def cli_telemetry(self, work, data) -> dict:
        """``train --profile-dir D --trace-dir D --metrics-jsonl F`` on the
        card: the torch.profiler trace and the host span trace parse (the
        device trace with kernel records), ``validate_span_tree`` accepts
        the host trace, and every JSONL line parses."""
        import tempfile

        from cfk_tpu_torch.telemetry import validate_span_tree

        # The traces (tens of MB) go to a directory deleted after the check.
        tmp = tempfile.TemporaryDirectory()
        d = Path(tmp.name)
        jsonl = d / "metrics.jsonl"
        out = subprocess.run(
            [sys.executable, "-m", "cfk_tpu_torch", "train", "--data",
             str(data), "--rank", "8", "--iterations", "3", "--layout",
             "tiled", "--chunk-elems", str(1 << 16), "--device", "cuda",
             "--output", "none", "--profile-dir", str(d), "--trace-dir",
             str(d), "--metrics-jsonl", str(jsonl), "--metrics-interval-s",
             "0.2"], cwd=ROOT, capture_output=True, text=True, timeout=300,
            env=CLI_ENV)
        log(f"cli train --profile-dir/--trace-dir/--metrics-jsonl "
            f"rc={out.returncode}: {out.stdout.strip()} | "
            f"{out.stderr.strip()[-300:]}")
        self.check(out.returncode == 0, "cli train with telemetry failed")
        report = {}
        try:
            (dev_trace,) = d.glob("cfk_device_trace_*.json")
            (host_trace,) = d.glob("cfk_host_trace_*.json")
            dev_events = json.loads(dev_trace.read_text())["traceEvents"]
            host_events = json.loads(host_trace.read_text())["traceEvents"]
            spans = validate_span_tree(host_events)
            lines = [json.loads(x) for x in jsonl.read_text().splitlines()]
            report = dict(
                device_trace_events=len(dev_events),
                device_kernels=sum(e.get("cat") == "kernel"
                                   for e in dev_events),
                host_spans=sorted({e["name"] for e in host_events
                                   if e.get("ph") == "X"}),
                host_span_tree=spans, jsonl_lines=len(lines),
                route=[ln for ln in out.stderr.splitlines()
                       if ln.startswith("# pipeline")])
            self.check(report["device_kernels"] > 0 and lines
                       and "train/fused_loop" in report["host_spans"],
                       f"cli telemetry: {report}")
        except (ValueError, KeyError, OSError) as e:
            self.check(False, f"cli telemetry files: {type(e).__name__}: {e}")
        finally:
            tmp.cleanup()
        log(f"cli telemetry: {report}")
        return report

    def cli_stream_checks(self, res, fields) -> dict:
        """The cli phase's stream and journal chains: the drained run, the
        resume that finds nothing to do, the SIGTERM'd follower and its
        re-run (crc-equal to the drained run), and ``recommend`` from the
        journal (the ``--checkpoint-dir`` chain's output)."""
        out = {}
        st = res["stream"]
        first, again = st["first"], st["again"]
        for name in ("produce", "first", "again"):
            self.check(st[name].returncode == 0, f"cli stream {name} failed")
        f1, f2 = fields(first), fields(again)
        out["drained"] = dict(step_crc=st["step_crc"],
                              stream_step=f1.get("g.stream_step"),
                              commits=f1.get("ctr.stream_commits"),
                              rmse=f1.get("g.rmse"))
        out["again"] = dict(stream_step=f2.get("g.stream_step"),
                            commits=f2.get("ctr.stream_commits"),
                            replayed=f2.get("ctr.replayed_updates"))
        self.check(f1.get("g.backlog") == "0"
                   and f2.get("g.stream_step") == f1.get("g.stream_step")
                   and "ctr.stream_commits" not in f2,
                   f"cli stream resume: {out}")
        fo = res["stream_follow"]
        out["follow"] = {k: v for k, v in fo.items() if k != "again"}
        self.check(fo["produce_rc"] == 0 and fo["rc"] == 0
                   and fo["preempted"] and fo["committed_step"] >= 1
                   and fo["again"].returncode == 0
                   and fo["step_crc"] is not None
                   and fo["step_crc"] == st["step_crc"],
                   f"cli stream --follow SIGTERM: {out['follow']}")
        jr = res["journal"]
        main = res["main"]
        self.check(jr["train"].returncode == 0
                   and jr["recommend"].returncode == 0,
                   "cli train/recommend --checkpoint-journal failed")
        same = ("recommend" in main and jr["recommend"].stdout
                == main["recommend"].stdout)
        out["journal_recommend_equal"] = same
        self.check(same, "cli recommend --checkpoint-journal differs from "
                   "--checkpoint-dir")
        log(f"cli stream/journal: {out}")
        return out

    def cli_broker_checks(self, res, fields) -> dict:
        """The cli phase's broker chain: every verb exit 0; ``train --data
        tcp://`` prints the journal chain's MSE (the same flags on the
        file); the stream over the broker ends crc-equal to the stream
        chain's over a FileBroker; ``topics list`` names the topics; the
        broker-fed fleet answered every request and exited 0 on SIGINT."""
        bc = res["broker"]
        self.check("error" not in bc, f"cli broker chain: {bc.get('error')}")
        if "error" in bc:
            return bc
        for name in ("create", "produce", "train", "stream_produce",
                     "stream", "list"):
            self.check(bc[name].returncode == 0, f"cli broker chain: {name} "
                       f"rc {bc[name].returncode}")
        mse_tcp = fields(bc["train"]).get("mse")
        mse_file = fields(res["journal"]["train"]).get("mse")
        self.check(mse_tcp is not None and mse_tcp == mse_file,
                   f"cli train --data tcp:// MSE {mse_tcp} != the file's "
                   f"{mse_file}")
        self.check(bc["stream_crc"] is not None
                   and bc["stream_crc"] == res["stream"]["step_crc"],
                   f"cli stream --updates tcp:// {bc['stream_crc']} != the "
                   f"FileBroker stream's {res['stream']['step_crc']}")
        listed = bc["list"].stdout
        self.check("ratings\tpartitions=4" in listed
                   and "rating-updates\tpartitions=2" in listed
                   and "checkpoint-commits" in listed,
                   f"cli topics list: {listed[-400:]}")
        answers = bc.get("fleet_answers") or []
        self.check(len(answers) == 8 and all(
            n == 5 and not e for n, e, _ in answers),
            f"cli serve --broker --replicas 2 answers {answers}")
        self.check(bc.get("fleet_rc") == 0
                   and "fleet served" in bc.get("fleet_err", ""),
                   f"cli serve --broker --replicas 2 rc {bc.get('fleet_rc')}"
                   f": {bc.get('fleet_err')}")
        out = dict(train_mse=mse_tcp, file_mse=mse_file,
                   stream_crc=bc["stream_crc"], fleet_answers=answers,
                   fleet_rc=bc.get("fleet_rc"), broker_rc=bc["broker_rc"],
                   fleet_err=bc.get("fleet_err"), topics=listed[-800:])
        log(f"cli broker chain: {out}")
        return out

    def cli(self):
        """Phase 8 (see the module doc): the CLI verbs as subprocesses, the
        independent ones concurrently — one chain a thread (train, then the
        serving verbs over its checkpoint; the two dataset-cache runs; the
        preemption and resume of a checkpointed run) beside the card/CPU
        pairs, the telemetry run and the chaos lab; every check after they
        all end."""
        import concurrent.futures

        import numpy as np

        from cfk_tpu_torch.data.synthetic import synthetic_netflix_coo
        from cfk_tpu_torch.transport.checkpoint import CheckpointManager

        work = OUT_DIR / "smoke_cli"
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True, exist_ok=True)
        coo = synthetic_netflix_coo(2000, 300, 40_000, seed=2)
        data = work / "ratings.txt"
        with open(data, "w") as f:
            for mid in np.unique(coo.movie_raw):
                f.write(f"{mid}:\n")
                sel = coo.movie_raw == mid
                for uid, r in zip(coo.user_raw[sel], coo.rating[sel]):
                    f.write(f"{uid},{int(r)},2005-01-01\n")
        ml = work / "implicit.csv"
        planted_implicit_csv(ml)
        preds = work / "predictions.csv"
        ckpt = work / "checkpoints"
        users = [str(x) for x in np.unique(coo.user_raw)[:3]]
        serving = ["--checkpoint-dir", str(ckpt), "--data", str(data),
                   "--device", "cuda"]

        def cli(*argv, timeout=300):
            out = subprocess.run([sys.executable, "-m", "cfk_tpu_torch",
                                  *map(str, argv)], cwd=ROOT,
                                 capture_output=True, text=True,
                                 timeout=timeout, env=CLI_ENV)
            log(f"cli {' '.join(map(str, argv[:1] + argv[-2:]))} "
                f"rc={out.returncode}: {out.stdout.strip()[-300:]} | "
                f"{out.stderr.strip()[-300:]}")
            return out

        def fields(out):
            return dict(kv.split("=", 1) for kv in out.stdout.split()
                        if "=" in kv)

        def main_chain():
            train = cli("train", "--data", data, "--layout", "auto",
                        "--rank", 8, "--iterations", 3, "--device", "cuda",
                        "--output", preds, "--checkpoint-dir", ckpt)
            if train.returncode != 0:
                return dict(train=train)
            preds2 = work / "predictions_from_checkpoint.csv"
            with concurrent.futures.ThreadPoolExecutor(5) as pool:
                jobs = dict(
                    evaluate=pool.submit(cli, "evaluate", data, preds),
                    recommend=pool.submit(cli, "recommend", "--users",
                                          ",".join(users), "-k", 5,
                                          *serving),
                    predict=pool.submit(cli, "predict", "--output", preds2,
                                        *serving),
                    serve=pool.submit(cli, "serve", "-k", 10, "--tile-m", 64,
                                      "--max-batch", 32,
                                      "--loadgen-requests", 128,
                                      "--loadgen-qps", 400, *serving),
                    serve_fleet=pool.submit(
                        cli, "serve", "-k", 10, "--tile-m", 64,
                        "--max-batch", 32, "--loadgen-requests", 128,
                        "--loadgen-qps", 400, "--replicas", 2, *serving))
                out = {k: v.result() for k, v in jobs.items()}
            out["train"] = train
            out["evaluate2"] = cli("evaluate", data, preds2)
            return out

        def cache_chain():
            shutil.rmtree(work / "dataset_cache", ignore_errors=True)
            runs = []
            for i in range(2):
                runs.append(cli("train", "--data", data, "--rank", 8,
                                "--iterations", 2, "--device", "cuda",
                                "--output", "none", "--dataset-cache",
                                work / "dataset_cache", "--checkpoint-dir",
                                work / f"cache_ckpt{i}"))
            return runs

        def preempt_chain():
            """``train --checkpoint-dir`` with the guard armed (the
            default), SIGTERM once its first step is committed: exit 0
            inside the grace window with a final checkpoint; the same
            command again resumes and finishes (every step verifies)."""
            ck = work / "preempt_ckpt"
            argv = [sys.executable, "-m", "cfk_tpu_torch", "train",
                    "--data", str(data), "--rank", "8", "--iterations",
                    str(CLI_PREEMPT["iterations"]), "--layout", "tiled",
                    "--chunk-elems", str(1 << 14), "--device", "cuda",
                    "--output", "none", "--checkpoint-dir", str(ck),
                    "--checkpoint-every", str(CLI_PREEMPT["every"]),
                    "--keep-last-n", "2"]
            p = subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True,
                                 env=CLI_ENV)
            deadline = time.time() + 240
            while time.time() < deadline and p.poll() is None and not (
                    ck.exists() and any(ck.glob("step_*/manifest.json"))):
                time.sleep(0.05)
            t0 = time.perf_counter()
            p.send_signal(15)
            out, err = p.communicate(timeout=120)
            exit_s = time.perf_counter() - t0
            mgr = CheckpointManager(str(ck))
            at = mgr.latest_valid_iteration()
            again = subprocess.run(argv, cwd=ROOT, capture_output=True,
                                   text=True, timeout=300, env=CLI_ENV)
            for it in mgr.iterations():
                mgr.verify(it)
            return dict(rc=p.returncode, exit_after_signal_s=exit_s,
                        preempted="preempted (SIGTERM)" in err,
                        committed_at=at, resume_rc=again.returncode,
                        resumed_to=mgr.latest_valid_iteration(),
                        kept=mgr.iterations(), err=err[-300:])

        # The stream verb's log: 2,000 updates of the file's users and
        # movies (seed 3) and 8 by new users, 2 partitions.
        rng = np.random.default_rng(3)
        updates = work / "updates.csv"
        with open(updates, "w") as f:
            for uid, mid, r in zip(
                    np.concatenate([rng.choice(np.unique(coo.user_raw), 2000),
                                    10**7 + np.arange(8)]),
                    rng.choice(np.unique(coo.movie_raw), 2008),
                    rng.integers(1, 6, 2008)):
                f.write(f"{uid},{mid},{r}\n")

        def stream_args(name):
            return ["stream", "--data", data, "--updates",
                    work / f"{name}_log", "--stream-dir",
                    work / f"{name}_dir", "--rank", 8, "--iterations", 3,
                    "--batch-records", 64, "--device", "cuda"]

        def stream_crc(name):
            st = CheckpointManager(str(work / f"{name}_dir")).restore()
            return st.iteration, zlib.crc32(np.ascontiguousarray(
                st.user_factors).tobytes())

        def stream_chain():
            """``stream --produce-csv``, ``stream`` until it drains, then
            the same command again (resumes, no new batch)."""
            argv = stream_args("stream")
            prod = cli(*argv, "--produce-csv", updates, "--partitions", 2)
            first = cli(*argv)
            again = cli(*argv)
            return dict(produce=prod, first=first, again=again,
                        step_crc=stream_crc("stream")
                        if first.returncode == 0 else None)

        def stream_follow_chain():
            """``stream --follow`` sent SIGTERM after its first commit past
            the bootstrap: exit 0 with the cursor committed; the same
            command without --follow then drains the log."""
            argv = stream_args("follow")
            prod = cli(*argv, "--produce-csv", updates, "--partitions", 2)
            p = subprocess.Popen(
                [sys.executable, "-m", "cfk_tpu_torch",
                 *map(str, argv), "--follow"], cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=CLI_ENV)
            sd = work / "follow_dir"
            deadline = time.time() + 240
            while time.time() < deadline and p.poll() is None and not (
                    sd.exists() and any(sd.glob("step_*/manifest.json"))
                    and any(int(x.parent.name[5:]) > 0
                            for x in sd.glob("step_*/manifest.json"))):
                time.sleep(0.05)
            p.send_signal(15)
            out, err = p.communicate(timeout=120)
            committed = CheckpointManager(str(sd)).restore()
            again = cli(*argv)
            return dict(produce_rc=prod.returncode, rc=p.returncode,
                        preempted="preempted (SIGTERM)" in err,
                        committed_step=committed.iteration,
                        committed_offsets=committed.meta.get("offsets"),
                        again=again, err=err[-300:],
                        step_crc=stream_crc("follow")
                        if again.returncode == 0 else None)

        def journal_chain():
            """``train --checkpoint-journal DIR --journal-partitions 2``
            (the main chain's train flags), then ``recommend
            --checkpoint-journal DIR`` for the main chain's users."""
            jd = work / "journal"
            train = cli("train", "--data", data, "--layout", "auto",
                        "--rank", 8, "--iterations", 3, "--device", "cuda",
                        "--output", "none", "--checkpoint-journal", jd,
                        "--journal-partitions", 2)
            rec = cli("recommend", "--users", ",".join(users), "-k", 5,
                      "--checkpoint-journal", jd, "--data", data,
                      "--device", "cuda")
            return dict(train=train, recommend=rec)

        def broker_fleet(url):
            """``serve --broker URL --replicas 2`` from the broker's journal
            in the background until its fleet is up; a client's 8
            requests; SIGINT."""
            import select

            from cfk_tpu_torch.serving import ServeClient
            from cfk_tpu_torch.transport.tcp import TcpBrokerClient

            out = {}
            sv = subprocess.Popen(
                [sys.executable, "-m", "cfk_tpu_torch", "serve",
                 "--checkpoint-journal", url, "--data", str(data),
                 "--broker", url, "--replicas", "2", "-k", "5",
                 "--tile-m", "64", "--metrics-port", "0", "--device",
                 "cuda"], cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, env=CLI_ENV)
            err = []
            deadline = time.time() + 240
            while time.time() < deadline and sv.poll() is None:
                ready, _, _ = select.select([sv.stderr], [], [], 1.0)
                if ready:
                    err.append(sv.stderr.readline())
                    if "serving fleet" in err[-1]:
                        break
            try:
                with TcpBrokerClient("127.0.0.1",
                                     int(url.rsplit(":", 1)[1])) as c:
                    got = ServeClient(c, route_by_user=True).ask(
                        list(range(8)), 5, timeout_s=60)
                out["fleet_answers"] = [(len(r.movie_rows), r.error, r.epoch)
                                        for r in got.values()]
            finally:
                sv.send_signal(2)  # SIGINT: the fleet stops, exit 0
                _, rest = sv.communicate(timeout=60)
            out["fleet_rc"] = sv.returncode
            out["fleet_err"] = ("".join(err) + rest)[-600:]
            return out

        def broker_chain():
            """The port's broker as ``broker --port 0 --data-dir``:
            ``topics create``, ``produce --append`` of the phase's ratings;
            then, beside each other, ``train --data tcp://…/ratings
            --checkpoint-journal tcp://…`` (the journal chain's flags)
            followed by ``serve --broker --replicas 2`` from the broker's
            journal in the background (a client's requests are answered,
            SIGINT, exit 0), and ``stream --produce-csv`` then ``stream
            --updates tcp://…`` (the stream chain's flags); last, ``topics
            list``."""
            import select

            out = {}
            bk = subprocess.Popen(
                [sys.executable, "-m", "cfk_tpu_torch", "broker", "--port",
                 "0", "--data-dir", str(work / "broker_data")], cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=CLI_ENV)
            try:
                ready, _, _ = select.select([bk.stdout], [], [], 60)
                line = bk.stdout.readline() if ready else ""
                if "LISTENING" not in line:
                    return dict(error=f"broker did not start: {line!r}")
                url = f"tcp://127.0.0.1:{int(line.split()[-1])}"
                out["create"] = cli("topics", "create", "--broker",
                                    f"{url}/ratings", "--partitions", 4)
                out["produce"] = cli("produce", "--broker", f"{url}/ratings",
                                     "--data", data, "--append")
                sargs = ["stream", "--data", data, "--updates", url,
                         "--stream-dir", work / "tcp_stream_dir", "--rank",
                         8, "--iterations", 3, "--batch-records", 64,
                         "--device", "cuda"]

                def stream_part():
                    out["stream_produce"] = cli(*sargs, "--produce-csv",
                                                updates, "--partitions", 2)
                    out["stream"] = cli(*sargs)
                    out["stream_crc"] = (stream_crc("tcp_stream")
                                         if out["stream"].returncode == 0
                                         else None)

                def serve_part():
                    out["train"] = cli(
                        "train", "--data", f"{url}/ratings", "--layout",
                        "auto", "--rank", 8, "--iterations", 3, "--device",
                        "cuda", "--output", "none", "--checkpoint-journal",
                        url, "--journal-partitions", 2)
                    out.update(broker_fleet(url))

                with concurrent.futures.ThreadPoolExecutor(2) as both:
                    for job in [both.submit(stream_part),
                                both.submit(serve_part)]:
                        job.result()
                out["list"] = cli("topics", "list", "--broker", url)
            finally:
                bk.send_signal(2)
                try:
                    bk.communicate(timeout=30)
                except subprocess.TimeoutExpired:
                    bk.kill()
                    bk.communicate()
                out["broker_rc"] = bk.returncode
            return out

        def shards_chain():
            """``train --shards 2 --exchange ring`` (two ranks sharing the
            card) beside one-rank ``train`` on the same file, and ``run``
            with NUM_PARTITIONS 2 and 1 (in a scratch directory: ``run``
            writes its prediction CSV under the working directory)."""
            common = ("--data", data, "--rank", 8, "--iterations", 3,
                      "--device", "cuda", "--output", "none")
            nm = len(np.unique(coo.movie_raw))
            nu = len(np.unique(coo.user_raw))

            def run(parts):
                return subprocess.run(
                    [sys.executable, "-m", "cfk_tpu_torch", "run",
                     str(parts), "8", "0.05", "3", str(data), str(nm),
                     str(nu), "--device", "cuda"], cwd=work / f"run{parts}",
                    capture_output=True, text=True, timeout=300,
                    env=dict(CLI_ENV, PYTHONPATH=str(ROOT)))

            for parts in (1, 2):
                (work / f"run{parts}").mkdir(exist_ok=True)
            with concurrent.futures.ThreadPoolExecutor(4) as both:
                jobs = dict(one=both.submit(cli, "train", *common),
                            two=both.submit(cli, "train", *common,
                                            "--shards", 2, "--exchange",
                                            "ring"),
                            run1=both.submit(run, 1),
                            run2=both.submit(run, 2))
                return {k: v.result() for k, v in jobs.items()}

        def chaos(*scenario):
            """The chaos lab on the card: ``scenario`` (default: every
            one but ``worker_kill``, whose four processes run as a chain
            of their own beside it)."""
            from cfk_tpu_torch.scripts.chaos_lab import SCENARIOS

            names = scenario or [x for x in SCENARIOS if x != "worker_kill"]
            out = subprocess.run(
                [sys.executable, "-m", "cfk_tpu_torch.scripts.chaos_lab",
                 "--device", "cuda", "--layout", *LAYOUTS_CHAOS,
                 "--scenario", *names], cwd=ROOT,
                capture_output=True, text=True, timeout=600, env=CLI_ENV)
            rows = [json.loads(x) for x in out.stdout.splitlines()
                    if x.startswith("{")]
            return dict(rc=out.returncode, summary=rows[-1] if rows else None,
                        rows=rows[:-1], stderr=out.stderr[-500:])

        pairs = {("rank256", d): ("--layout", "padded", "--rank", 256)
                 for d in ("cuda", "cpu")}
        pairs.update({("segment", d): ("--layout", "segment", "--rank", 8,
                                       "--chunk-elems", 64 * 4096)
                      for d in ("cuda", "cpu")})
        chain_s = {}

        def timed(key, fn, *argv):
            """``fn(*argv)``, its wall seconds kept in ``chain_s``: the
            longest chain sets the phase's time."""
            t = time.perf_counter()
            try:
                return fn(*argv)
            finally:
                chain_s[str(key)] = time.perf_counter() - t

        with concurrent.futures.ThreadPoolExecutor(16) as pool:
            t0 = time.perf_counter()
            calls = {
                "main": (main_chain,),
                "cache": (cache_chain,),
                "preempt": (preempt_chain,),
                "chaos": (chaos,),
                "worker_kill": (chaos, "worker_kill"),
                "telemetry": (self.cli_telemetry, work, data),
                "stream": (stream_chain,),
                "stream_follow": (stream_follow_chain,),
                "journal": (journal_chain,),
                "broker": (broker_chain,),
                "shards": (shards_chain,),
                **{("pair",) + key: (
                    cli, "train", "--data", data, *extra, "--iterations", 2,
                    "--device", key[1], "--output", "none")
                   for key, extra in pairs.items()},
                **{("implicit", d): (
                    cli, "train", "--data", ml, "--format", "movielens",
                    "--implicit", "--algorithm", "ials++", "--rank", 16,
                    "--block-size", 8, "--iterations", 5, "--eval-ranking",
                    10, "--output", "none", "--device", d)
                   for d in ("cuda", "cpu")},
            }
            jobs = {key: pool.submit(timed, key, *call)
                    for key, call in calls.items()}
            res = {k: v.result() for k, v in jobs.items()}
            wall_s = time.perf_counter() - t0
        log("cli chains, wall s: " + ", ".join(
            f"{k} {v:.1f}" for k, v in sorted(chain_s.items(),
                                               key=lambda kv: -kv[1])))
        # The main chain: train (auto picks padded), evaluate its CSV (the
        # train MSE again), recommend, predict from the checkpoint and
        # evaluate that CSV, serve (every request answered).
        main = res["main"]
        train = main["train"]
        self.check(train.returncode == 0, "cli train failed")
        self.check(len(main) > 1, "cli serving verbs skipped: train failed")
        mse_train = float(fields(train).get("mse", "nan"))
        self.check(fields(train).get("layout") == "padded",
                   f"cli auto layout {fields(train).get('layout')} != padded")
        mse_eval = mse_pred = float("nan")
        row = {}
        if len(main) > 1:
            for verb in ("evaluate", "recommend", "predict", "serve",
                         "serve_fleet", "evaluate2"):
                self.check(main[verb].returncode == 0, f"cli {verb} failed")
            mse_eval = float(main["evaluate"].stdout.split("MSE:")[1].split()[0])
            self.check(abs(mse_eval - mse_train) <= 1e-4 * mse_train,
                       f"evaluate MSE {mse_eval} != train MSE {mse_train}")
            self.check([ln.split("\t")[0] for ln in
                        main["recommend"].stdout.strip().splitlines()]
                       == users, "cli recommend: wrong users")
            mse_pred = float(main["evaluate2"].stdout.split("MSE:")[1]
                             .split()[0])
            self.check(abs(mse_pred - mse_train) <= 1e-4 * mse_train,
                       f"predict CSV MSE {mse_pred} != train MSE {mse_train}")
            row = json.loads(main["serve"].stdout.strip().splitlines()[-1])
            self.check(row["answered"] == row["requests"] == 128,
                       f"cli serve answered {row['answered']} of "
                       f"{row['requests']}")
            frow = json.loads(
                main["serve_fleet"].stdout.strip().splitlines()[-1])
            row["replicas_2"] = frow
            self.check(frow["answered"] == frow["requests"] == 128
                       and frow["replicas"] == 2,
                       f"cli serve --replicas 2: {frow}")
        # Above the fused kernels' cap: rank 256 on the padded layout (the
        # split schedule's ridge add and Cholesky); and the segment layout
        # (K2 and K1 a chunk); the card against the CPU.
        card_cpu = {}
        for (_, name, device), out in ((k, v) for k, v in res.items()
                                       if k[0] == "pair"):
            self.check(out.returncode == 0,
                       f"cli train {name} ({device}) failed")
            card_cpu.setdefault(name, {})[device] = float(
                fields(out).get("mse", "nan"))
        for name, mses in card_cpu.items():
            got, want = mses["cuda"], mses["cpu"]
            self.check(abs(got - want) <= 1e-3 * want,
                       f"cli train {name}: card MSE {got} vs CPU {want}")
        # --dataset-cache: the second run loads the first run's blocks and
        # checkpoints the same factors, bit for bit.
        cache_runs = res["cache"]
        for i, out in enumerate(cache_runs):
            hit = "# dataset cache hit" in out.stderr
            self.check(out.returncode == 0 and hit == (i == 1),
                       f"cli train --dataset-cache run {i + 1}: rc "
                       f"{out.returncode}, cache hit {hit}")
        cache_equal = False
        if all(out.returncode == 0 for out in cache_runs):
            a, b = (CheckpointManager(str(work / f"cache_ckpt{i}")).restore()
                    for i in range(2))
            cache_equal = bool(np.array_equal(a.user_factors, b.user_factors)
                               and np.array_equal(a.movie_factors,
                                                  b.movie_factors))
        self.check(cache_equal, "cli --dataset-cache: factors of the cached "
                   "run differ from the building run's")
        # Implicit: iALS++ with leave-one-out ranking, card vs CPU.  Recall@10
        # may differ by a near-tie flip of a held-out item or two (float32
        # in other orders on the two devices); MPR averages over all.
        ranking = {}
        for d in ("cuda", "cpu"):
            out = res[("implicit", d)]
            self.check(out.returncode == 0,
                       f"cli train --implicit ({d}) failed")
            f = fields(out)
            ranking[d] = (float(f.get("recall_at_10", "nan")),
                          float(f.get("mpr", "nan")))
        (rg, mg), (rc, mc) = ranking["cuda"], ranking["cpu"]
        self.check(abs(rg - rc) <= 0.01 and abs(mg - mc) <= 1e-3,
                   f"cli implicit ranking card {ranking['cuda']} vs CPU "
                   f"{ranking['cpu']}")
        self.check(mg < 0.4, f"cli implicit MPR {mg} not below chance")
        # train --shards 2 --exchange ring: the one-rank MSE (the same
        # init: drawn at the real entity count); run NUM_PARTITIONS=2: the
        # NUM_PARTITIONS=1 MSE.
        sh = res["shards"]
        shard_mse = {}
        for key in ("one", "two"):
            self.check(sh[key].returncode == 0, f"cli train shards {key} "
                       f"failed: {sh[key].stderr[-300:]}")
            shard_mse[key] = float(fields(sh[key]).get("mse", "nan"))
        for key in ("run1", "run2"):
            self.check(sh[key].returncode == 0, f"cli {key} failed: "
                       f"{sh[key].stderr[-300:]}")
            shard_mse[key] = float(
                (sh[key].stdout.split("MSE:")[1:] or ["nan"])[0].split()[0])
        log(f"cli shards: {shard_mse} ({SHARDS_LABEL})")
        self.check(abs(shard_mse["two"] - shard_mse["one"])
                   <= 1e-4 * shard_mse["one"],
                   f"cli train --shards 2 MSE {shard_mse['two']} vs one "
                   f"rank {shard_mse['one']}")
        self.check(abs(shard_mse["run2"] - shard_mse["run1"])
                   <= 1e-4 * shard_mse["run1"],
                   f"cli run NUM_PARTITIONS=2 MSE {shard_mse['run2']} vs 1 "
                   f"{shard_mse['run1']}")
        pre = res["preempt"]
        log(f"cli train --checkpoint-dir, SIGTERM and resume: {pre}")
        self.check(pre["rc"] == 0 and pre["preempted"]
                   and pre["exit_after_signal_s"] < CLI_PREEMPT["grace_s"]
                   and pre["committed_at"] is not None
                   and pre["committed_at"] < CLI_PREEMPT["iterations"]
                   and pre["resume_rc"] == 0
                   and pre["resumed_to"] == CLI_PREEMPT["iterations"]
                   and len(pre["kept"]) <= 2,
                   f"cli preemption: {pre}")
        stream_out = self.cli_stream_checks(res, fields)
        stream_out["broker"] = self.cli_broker_checks(res, fields)
        chaos_out = res["chaos"]
        for key in ("chaos", "worker_kill"):
            out = res[key]
            log(f"chaos_lab --device cuda ({key}): rc={out['rc']} "
                f"{out['summary']}")
            self.check(out["rc"] == 0 and out["summary"] is not None
                       and out["summary"]["chaos_lab"] == "pass",
                       f"chaos_lab --device cuda ({key}): {out['summary']} "
                       f"{out['stderr']}")
        chaos_out["worker_kill"] = res["worker_kill"]
        self.report.setdefault("resilience", {})["chaos_lab"] = chaos_out
        self.report["cli"] = dict(train=train.stdout.strip(),
                                  shards_mse=shard_mse,
                                  wall_s=wall_s, chain_s=chain_s,
                                  telemetry=res["telemetry"],
                                  rank256_mse=card_cpu.get("rank256"),
                                  segment_mse=card_cpu.get("segment"),
                                  dataset_cache_bit_equal=cache_equal,
                                  evaluate_mse=mse_eval,
                                  predict_mse=mse_pred, serve=row,
                                  implicit_ranking=ranking,
                                  preemption=pre, stream=stream_out)


MAIN_PHASES = ("kernels", "binv", "breakdown", "split", "gather", "rank256",
               "segment", "quant", "pipeline", "resilience", "stream")
IMPLICIT_PHASES = ("gather_ml25m", "split_ml25m", "implicit_r256",
                   "segment_ml25m", "quant_ml25m", "pipeline_ml25m",
                   "resilience_ml25m")
PHASES = ("main",) + MAIN_PHASES + ("serve", "fleet", "shards",
                                   "implicit") \
    + IMPLICIT_PHASES + ("small", "cli")


def main(argv=None) -> int:
    import argparse

    import torch

    p = argparse.ArgumentParser(description="GPU smoke run of the port.")
    p.add_argument("--phases", default=None, help="comma-separated phases "
                   "to run (a development aid: the build always runs, and "
                   "the main or implicit phase when a phase needs its "
                   "data); default: every phase")
    args = p.parse_args(argv)
    chosen = set(PHASES if args.phases is None else args.phases.split(","))
    if chosen - set(PHASES):
        p.error(f"unknown phases {sorted(chosen - set(PHASES))}; choose "
                f"from {PHASES}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    import cfk_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke = Smoke()
    t_start = time.perf_counter()
    smoke.phase("build", smoke.build)
    built = not smoke.failures

    def run(name, *args):
        if name in chosen:
            smoke.phase(name, getattr(smoke, PHASE_METHODS.get(name, name)),
                        *args)
            torch.cuda.empty_cache()

    if built and chosen & {"main", *MAIN_PHASES}:
        main_out = smoke.phase("main", smoke.main_path)
        if main_out is not None:
            for name in MAIN_PHASES:
                run(name, *main_out)
        del main_out
        torch.cuda.empty_cache()
    if built:
        run("serve")
        run("fleet")
        run("shards")
        if chosen & {"implicit", *IMPLICIT_PHASES}:
            implicit_out = smoke.phase("implicit", smoke.implicit)
            if implicit_out is not None:
                for name in IMPLICIT_PHASES:
                    run(name, *implicit_out)
            del implicit_out
            torch.cuda.empty_cache()
    run("small")
    run("cli")
    smoke.report["total_s"] = time.perf_counter() - t_start
    smoke.report["card"] = card
    kernels = []
    for name in REPLACES:
        row = smoke.kernels.get(name, {})
        kernels.append({
            "name": name, "route": "cuda",
            "source": SOURCES.get(name, f"cfk_tpu_torch/csrc/{name}.cu"),
            "replaces": REPLACES[name],
            **{key: row.get(key) for key in (
                "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms") + LINE_EXTRA.get(name, ())},
        })
    smoke.report["kernels"] = kernels
    smoke.report["failures"] = smoke.failures
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(smoke.report,
                                                         indent=1))
    if smoke.failures:
        log(f"{len(smoke.failures)} failure(s):")
        for f in smoke.failures:
            print(f, file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": kernels}))
    if chosen != set(PHASES):
        # A subset held only some kernels against their plain versions: it
        # never prints the line a full run ends with.
        print(json.dumps({"ok": False, "subset": sorted(chosen),
                          "subset_passed": True}))
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# The Smoke method of each phase whose name differs from it.
PHASE_METHODS = {"kernels": "kernel_checks", "gather_ml25m": "gather_implicit",
                 "split_ml25m": "split_implicit",
                 "segment_ml25m": "segment_implicit",
                 "quant_ml25m": "quant_implicit",
                 "pipeline_ml25m": "pipeline_implicit",
                 "resilience_ml25m": "resilience_implicit",
                 "small": "small_parity"}


if __name__ == "__main__":
    sys.exit(main())
