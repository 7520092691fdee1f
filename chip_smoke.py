#!/usr/bin/env python3
"""Drive the PyTorch port's ALS train (dense, windowed, scatter) and
serve paths, the storage-backed train → deploy → query loop, the grid
evaluation over the same storage, the fleet evaluation and ``tune`` with
their shard children, the Universal Recommender's self-cleaning, the
Event Server feeding train →
deploy, the same over the storage daemon through its outage (the
write-ahead spill, the breaker, the replay), the sharded event store
over three storage daemons (partitioned reads, a successor failover, a
partial outage), the parquetfs and postgres event stores with parquet
export/import and log shipping, the replicated event store
(segment shipping, WAL frames, a fenced failover, fold-in from a
follower), the online fold-in of live events into the served model, and
the model lifecycle (train jobs, checkpoints, warm starts, versions,
their children's push telemetry),
item properties with the similar-product and e-commerce templates, the
Universal Recommender's train and serve path, the classification
and regression templates, the query server's canary rollout,
deadlines, fault points and pipelined batching, and the monitoring
plane with the operator servers and the durable TSDB tier, on one CUDA
card.

    python3 chip_smoke.py

Phases, in order; any failure prints what failed and exits non-zero:

1. device   needs CUDA; prints the card's name and power limit
            (nvidia-smi) and turns TF32 off.
2. build    compiles every ``predictionio_tpu_torch/ops/csrc/*.cu`` into
            ``build/kernels/`` (one nvcc per source, all started
            together) and loads the libraries.
3. sweep    the fused score+top-k kernel against its plain PyTorch
            version on the card, at the ML-20M item slab: f32/bf16/int8,
            no mask / packed bits / row list, unscaled and scaled,
            B in {1, 8, 64}, k in {1, 10, 128, 1024, n_items}, a fully
            masked row, crafted cross-chunk ties on integer-valued
            factors, and B=1 vs B=64 bit-identity. Each call must take
            the route its k names (the two-launch select route up to
            k = 1,024, the chunk sort above); indices and values must be
            equal (the kernel and the plain version do the same rounded
            operations).
4. data     ML-20M-shaped ratings from SEED with numpy: 138,493 users x
            26,744 items, 20,000,263 unique pairs with skewed degrees
            anchored on ML-20M's published counts (users 20 to 9,254
            ratings, items up to 67,310), half-star ratings 0.5-5.0 (so
            staging picks int8 storage with scale 2).
5. dense    the dense ALS row/col pass kernels against their plain
            versions on the card: implicit and explicit, signed ratings,
            scale in {1, 2, 10}, K in {1, 8, 10, 32} at 2048 x 256, and
            the full ML-20M slab (139,264 x 26,880 int8, K = 10 and 32,
            implicit). Per element
            |kernel - plain| <= 1e-5 * S, S the same pass over the
            absolute terms; a second launch must give the same bits.
6. train    the main path: ``ALSAlgorithm.train`` on the phase-4 data at
            the template defaults with 5 iterations. Both pass kernels
            must launch once per iteration, every factor must be finite,
            and the same train through the plain passes on the card, from
            the same seeded init, must correlate > 0.9999 (users and
            items). Prints gate, staging, densify and per-iteration
            seconds, all from the one main-path call.
7. serve    the trained factors, through ``to_bytes`` and
            ``convert.load_jax_als_blob`` (as ``console train`` then
            ``console deploy`` would), served by the port's
            ``QueryServer`` on the card; 16 client threads send 500
            ``POST /queries.json`` (some with blacklists or whitelists).
            Every answer must equal the plain version's on the CPU;
            kernel launches, and those of its select route, must equal
            device batches.
8. times    CUDA-event medians: top-k at B in {1, 64}, k=128, per dtype
            (kernel, its route, its launches per call as the profiler
            counts them, which must equal the route's, and its time on
            the card by kernel, plain,
            ``torch.topk(q @ itf.T)`` as a yardstick the port never
            calls, bound); the dense passes at the ML-20M slab,
            K = 10 (kernel, plain, the port's two-matmul ``ops.dense``
            pass on the same R in bf16 storage as the yardstick, bound),
            and the kernel again on a uniform R with as many ratings and
            on an all-zero R; both passes the same way at K = 32.
            The dense and windowed times run with the profiler off (as
            the train loops call the passes: nested, unsynchronized),
            then the main-path kernel once more through it, its median
            beside devprof's mean device ms a call (phase 26).
9. loop     the zero-to-aha loop at ML-1M's width, over storage under
            ``build/loop/`` (sqlite events and metadata, model files, named
            by ``PIO_FS_BASEDIR`` and the ``PIO_STORAGE_*`` variables):
            1,000,209 ``rate`` events from LOOP_SEED (6,040 users x 3,706
            movies, unique pairs with degrees anchored on ML-1M's counts,
            integer ratings 1-5, distinct times) as JSON lines; ``console
            app new``, ``import`` and ``train --engine-json`` (the
            recommendation template's defaults: rank 10, 20 iterations,
            implicit, f32 serving) in this process; then ``console deploy
            --engine-json`` in a process of its own on the card, and 16
            client threads send 500 ``POST /queries.json`` (20 % with
            blacklists, 10 % with whitelists), then 20 queries for
            unknown users go one at a time. The
            instance must be COMPLETED with an ALSModel in its MODELDATA
            blob; the frame read back must hold exactly the generated
            triples; the train must stage StagedDenseTrain and launch each
            pass kernel once per iteration; the factors must be finite and
            correlate > 0.9999 with a direct ``ALSAlgorithm.train`` on the
            generated arrays on the card; every answer must equal the plain
            top-k on the CPU over the blob's factors; the deploy's
            ``GET /`` kernel launches must equal its batches over the 500,
            and the unknown users' queries must launch none. Prints the
            import, read, prepare, train and persist seconds (the
            instance's stage timings), deploy to ready, p50/p99 and qps,
            each line with the card's name and power limit.
9b. segments the loop's ML-1M events again, over segmentfs events (the
            JAX defaults: SEAL_EVENTS 8192, FSYNC 1), docfs metadata and
            localfs models under ``build/segments/``: no sqlite file. (a)
            ``console app new`` and ``import`` of the loop's
            ``events.jsonl`` in this process, the sealer left to seal the
            import, then ``status``: its segmentfs line shows sealed
            segments and all 1,000,209 rows, none dead. (b) ``train
            --engine-json`` with the loop's params reading through the data
            view's segment branch (one miss, no npz file): the frame holds
            exactly the generated (user, item, rating, time) rows, and the
            store's columnar frame of entity partition 0 of 4
            (``EventQuery.shard``) equals ``EventFrame.from_events(
            store.find(q))`` of that partition bit for bit; each
            pass kernel launches once an iteration, and both are held to
            their plain versions on the train's int8 R at K = 10 (1e-5 S);
            the factors correlate > 0.9999 with the loop's. (c) In process
            against the train's store (the sealer's poll stretched to 3,600
            s so that the tail stays a tail): ``SegmentStager`` on cuda:0,
            20,000 new ratings of known users and items inserted, the
            retrain (a data view hit and a store cache hit; launches again
            one a pass and iteration), the stager again: the sealed prefix
            reused, only the tail's 240,000 bytes copied, every staged
            tensor equal to the frame's column and the prefix unchanged;
            the store closed and a cold read of a fresh store equal to the
            retrain's frame. (d) ``eventserver`` in a process of its own on
            the JAX cadence: 4 writers batch-POST 20,000 more ratings with
            their own ids, the server SIGKILLed once a third of the batches
            are acknowledged and restarted on its port, every unacknowledged
            batch resent; ``POST /segments/seal``, ``GET /segments/stats``,
            ``POST /segments/compact`` answer the JAX server's keys and add
            up; then, the server stopped, ``find_since`` from 0 in pages
            gives each revision once, 1,040,209 distinct ids, every
            acknowledged and resent event as posted. (e) ``deploy
            --engine-json`` in its own process on the card and 500 queries
            from 16 clients: every answer the plain top-k on the CPU, each
            batch one scored top-k launch on the select route. Prints the
            import's s and events/s, the status line, the reads, stager and
            Event Server figures, each line with the card's name and power
            limit.
9c. replication  phase 9b's store (1,040,209 sealed rows) replicated:
            two follower storage daemons in this process over
            ``segmentfs-replica`` PATHs under ``build/replication/``, and
            ``python -m predictionio_tpu_torch.data.api.storage_server``
            in a process of its own as the primary over 9b's event PATH
            (PIO_REPL_FOLLOWERS both, MIN_ACKS 1, ship interval 0.05 s,
            epoch 1, SEAL_EVENTS 2,000). (a) The initial sync: each
            follower's segments carry the primary's content hashes, both
            reach its revision, and follower A's ``find_frame`` is
            bit-equal to the PATH's frame read before the daemon opened
            it. (b) A ``QueryServer`` in this process on 9b's retrain,
            reading its instance and model through a control storage
            (9b's docfs and localfs, events in a sqlite file of its own),
            with an ``OnlineConsumer`` over ``ReplicaReadStorage(control,
            follower A)`` (``name`` online/<app>/replica-a,
            ``from_latest``); 4 writers insert 12,000 ratings of 1,000 new
            users (12 ML-1M movies each, from REPLICATION_SEED) in batches
            of 50 through a ``remote`` storage on the primary; one
            acknowledged batch is read back on A after
            ``wait_for_revision`` through the remote client, the primary's
            ``/metrics`` shows ``replication_ship_total`` of kind wal and
            segment, ``replication_lag`` answers through the client. (c)
            The primary SIGKILLed once a third is acknowledged; both
            followers stand at once through ``elect_and_promote`` (peers:
            the other and the dead primary) over the control store's
            records: one winner at generation 2, role primary, epoch 2;
            every acknowledged id on it once (``find_since`` from the head
            before the writes), every row it holds one the dead primary
            wrote (its PATH opened in this process, the WAL replayed); the
            winner takes a write; a ``SegmentShipper`` of epoch 2 brings
            the loser to its head at epoch 2; an epoch-1 frame is refused
            by both (``replication_fenced_total`` >= 1). (d) The consumer
            drained: events consumed and folded equal the live events past
            its start, every fold on cuda:0, no fold error; a second
            consumer of the same name consumes 0; 500 queries from 16
            clients for folded and known users: each the plain top-k on
            the CPU over the served factors, one ``recommend_select`` a
            device batch by the route and by the profiler, the served slab
            held to the plain version. Prints the sync seconds, bytes and
            MB/s, the failover seconds, the consumer's catch-up, p50/p99
            and qps, each line with the card's name and power limit.
10. eval    ``pio eval`` over the loop's storage and app, in this process
            on the card: ``console eval run`` of EvalML1M over EvalGrid,
            the recommendation template's tuning example (5 folds,
            eval_num 10, goal threshold 4.0, Precision@10; rank {10, 20}
            x iterations {20, 40} x lambda {0.01, 0.1}, implicit, f32
            serving; best.json under ``build/loop/``). Each fold trains
            ~800,000 edges, so the gate takes the windowed path. The
            instance must be EVALCOMPLETED in sqlite with the one-liner,
            HTML, JSON of 8 scores, ``grid_points`` 8, and best.json
            written; ``train_grid`` must run once a fold and stage
            StagedWindowedTrain once a fold, no serial train; the
            block_partials and combine kernels must launch 2 x the
            iterations of every point of every fold (2,400 each), the
            scored top-k once a (fold, point) on its select route (40);
            every factor finite; on fold 0 each point's factors bit-equal
            to a serial ``ALSAlgorithm.train`` of its params on the card,
            the answers of points 0 and 4 (rank 10 and 20) equal to the
            plain top-k on the CPU over their factors, and every point's
            Precision@10 equal to the metric recomputed on the host from
            its answers. Then, with ``PIO_DENSE_ALS=1``, the engine's
            ``batch_eval`` of the same grid on fold 0 (``fold_indices``,
            counts from 0 around it) must stage StagedDenseTrain (int8)
            once, launch each dense pass kernel 240 times and the scored
            top-k 8, no windowed pass, and give each point's factors
            bit-equal to a serial forced-dense ``ALSAlgorithm.train``.
            Last, at each rank of the grid (10, 20), block_partials with
            the combine on fold 0's two staged windowed plans and the row
            and col passes on the staged int8 R are held to their plain
            versions as phases 5 and 16 hold them. Prints read_eval,
            staging and ``train_grid`` seconds per fold,
            ``batch_predict`` seconds per model, metric seconds,
            eval_wall_sec, each point's score and the best point, each
            line with the card's name and power limit.
10b. fleet eval  phase 10's grid as a fleet evaluation over the loop's
            storage, with its shard children on the card. (a) ``console
            eval run`` of an EvalSpec (the template's variant reading
            through the data view, EVAL_GRID's axes in its order, 5 folds,
            the template's Precision@10 by its class) with
            ``--local-workers 5``: one grid group, so 5 shard
            jobs (one a fold), each child on the card with 2 x the
            iterations of all 8 points of block_partials and of the
            combine, one select a point, no dense pass (its log's launch
            line); every point's combined score within 1e-5 of phase 10's
            MetricEvaluator score, the same winner; ``eval list``, ``eval
            status`` and an ``AdminServer``'s ``GET /evals/<run>``
            (``EvalDriver.status``). (b) ``console tune`` with folds 0 over the
            space that (a)'s winner and worst point span (2 points here):
            one shard of all folds, its scores and winner (a)'s,
            the winner parked as engine ml1m-tune's preset; a periodic
            train job of (a)'s worst point through ``jobs worker --once``,
            then its next run, which carries the preset and the run's
            marker, in a child on the card: the winner's params trained,
            a dense pass an iteration, its version linked to the run; the
            dashboard's fleet-evaluation panel shows both runs and the
            link. (c) The offline prior: the preset's model live behind a
            ``QueryServer`` on the card, a canary of the worst point's
            model, linked to a completed one-point run with (a)'s score
            for it: the bake stretched 2x; with ``PIO_TUNE_PRIOR=0``
            unchanged. The phase's jobs, versions, rollout records and
            preset are then purged. (d) The UR configuration's buys and
            views of its first 1,000 of 3,000 users (phase 21's generator,
            from UR_SEED, in a memory store of their own) with 2,000 items' ``$set``/``$unset``/``$delete``
            histories, 5,000 exact duplicates and 3,000 events 90 days
            before the window: ``URDataSource``'s event window cleans them,
            and its counters and surviving buys and views equal a plain
            numpy cleaning's, the items' properties unchanged; the UR
            trained on the card on the cleaned store holds its tables to
            a card train on the plainly cleaned events (the LLR bar of
            phase 22), and 64 queries, one masked select launch, equal
            the plain version on the CPU. Prints the runs' and shards'
            seconds, the jobs', the bakes and the cleaning's, each line
            with the card's name and power limit.
11. lifecycle the model lifecycle over the loop's storage and app, with
            the train job's child on the card: ``jobs submit`` of the
            template's variant with checkpoint_every 5 (reading through
            the data view, which phase 10b filled) and ``jobs worker
            --once`` (job 1): completed at attempt 1, its instance
            COMPLETED with no ``ckpt:`` blob left, version v1 ``trained``
            with the job's id, the child's log showing 4 segments each
            staged StagedDenseTrain (int8) and 20 + 20 dense pass
            launches, v1's factors bit-equal to an uninterrupted
            ``ALSAlgorithm.train`` of the same data in this process.
            ``train_als_checkpointed`` killed after 2 segments, then
            resumed: a checkpoint at iteration 10, 10 + 10 launches of
            each pass a run, factors bit-equal, the checkpoint cleared.
            ``models promote`` v1; ``console import`` of 10,000 new
            ``rate`` events from LIFECYCLE_SEED (200 new users x 20
            movies, 100 new movies x 30 users, 300 users x 10 movies they
            had not rated); job 2 with warm_start: v2's parent v1, ``models
            show`` its lineage, the log's warm start from v1, its factors
            bit-equal to a train from ``warm_start_factors`` of v1 and
            unequal to a cold one. Job 3 (job 2's variant, a checkpoint
            every 2 iterations: ten segments) under an in-process
            ``TrainScheduler``: its child (found by its spec path in
            /proc, as ``pgrep -f`` finds it) SIGKILLed once its first
            checkpoint is saved; completed at attempt 2 with one version,
            the killed attempt's instance not COMPLETED and its checkpoint
            left (the JAX package's retry does not resume either). The
            row and col passes on the R after the delta, at rank 10,
            held to their plain versions. Job 3's instance served in
            this process (``latest_completed_runtime``): 200 queries
            from 8 threads (new users and movies among them), each equal
            to the plain top-k on the CPU, top-k launches equal to
            batches, all on the select route. ``models gc --keep 1``
            keeps v1 and v3, ``jobs gc --keep 2`` jobs 2 and 3. Push
            telemetry: a port ``Dashboard`` in this process (no scrape
            targets, ``PIO_PUSH_INGEST=1``, a ``PIO_PUSH_TOKEN``, a
            monitor of its own) is the children's ``PIO_PUSH_URL``
            (``PIO_PUSH_INTERVAL_S`` 0.25): each job's child pushes a
            devprof report with ``push_status`` devprof true, whose
            ``als.train_dense`` covers as many iterations (its work over
            one iteration's) as the child's launch line has row and col
            passes (20 + 20 for job 1), in one call a segment; job 1's
            ``train.*`` spans on the dashboard's ``/debug/traces?fleet=1``
            (no poll); a ``telemetry_last_push_age_seconds{instance}`` for
            each child. Job 3's first attempt pushes into a refusing
            ingest (``PIO_PUSH_INGEST`` unset), and is killed once its
            spool took its first segment's report; with the ingest back,
            the in-process scheduler ships that spool after the kill,
            every payload once and before the retry's first push, and
            the spool directory is gone; a push with a wrong token 403.
            The children import this checkout through PYTHONPATH. Prints
            each job's queue wait, worker and stage seconds and
            segments, from its log the child's start and each segment's
            set-up and run seconds, the kill to the retry's claim, the
            kill/resume seconds, query p50/p99/qps, each line with the
            card's name and power limit.
12. ingest  the reference's quick start through the Event Server, over
            the loop's storage, at ML-100K's shape: 100,000 ``rate``
            events from INGEST_SEED (943 users x 1,682 movies, unique
            pairs with degrees anchored on ML-100K's counts, integer
            ratings 1-5, distinct times). ``console app new ml100k`` must
            print an access key; ``accesskey new --events rate`` and
            ``channel new ml100k holdout`` follow. ``console eventserver``
            runs in a process of its own; four writer threads POST 99,800
            events as 1,996 ``/batch/events.json`` requests of 50 and the
            last 200 one by one (timed: events/s, p50/p99 of each kind).
            Then 50 events to the holdout channel, 10 POSTed and deleted
            (``DELETE /events/<id>.json``, then a 404), 5 ``buy`` events
            with the rate-only key (403 each in the batch's 200), a wrong
            key (401) and a batch of 51 (400); 100 sampled events read
            back by id, 20 sampled users' events read back in time order,
            the holdout channel read back whole. ``train --engine-json``
            (template defaults) here: its frame must hold exactly the
            100,000 generated triples, one StagedWindowedTrain staged,
            block_partials and the combine each launched 2 x 20 times, no
            dense pass, the factors finite and correlated > 0.9999 with a
            direct ``ALSAlgorithm.train`` on the generated arrays, and
            block_partials with the combine held to their plain versions
            on the train's two plans. ``deploy --engine-json`` in its own
            process on the card then takes 500 queries from 16 threads:
            scored top-k launches equal its batches, all on the select
            route, and every answer equals the plain top-k on the CPU.
            Prints events/s, the POST latencies, the train's stages,
            deploy to ready and query p50/p99/qps, each line with the
            card's name and power limit.
12b. remote the same quick start over the storage daemon, through its
            outage, under ``build/remote/``: ``console storageserver`` in
            a process of its own over sqlite and model files there; every
            other process reaches it through a ``remote`` source (app new
            and train here, ``console eventserver`` with ``PIO_WAL_DIR``
            there, deploy; the breaker's cooldown 2 s). (b) Four writers
            POST a seeded 30,000 of phase 12's 100,000 events in batches
            of 50; the daemon is
            SIGKILLed once a third
            of the POSTs are answered and restarted on its port over the
            same files once two thirds are. Every event is answered 201
            or 202 (none 5xx); while it is down the Event Server's
            ``/metrics`` reads the events breaker at 1 (open) and
            ``event_wal_pending`` above 0; after the restart the WAL
            drains to 0, ``event_wal_replayed_total`` equals the 202s,
            the breaker's transitions hold open, half_open and closed,
            and the daemon's sqlite file holds every acknowledged id
            once, 30,000 in all (the app is read through the daemon's
            paged ``find`` once, by (d)'s train). (c)
            ``event.insert:error:1.0`` through ``POST /debug/faults`` for
            120 ``buy`` events: each a 202 with a walId; cleared, each
            replayed and read back once. (d) ``train --engine-json`` over
            the daemon: its frame equal column for column to the frame
            read directly from the daemon's sqlite file (the same train
            run there), block_partials and the combine launched 2 x 20
            times, held to their plain versions on its plans, the factors
            bit-equal to the direct train's. (e) ``deploy --engine-json``
            over the daemon in its own process on the card, 500 queries
            from 16 threads: top-k launches equal its batches, all on the
            select route, every answer the plain top-k on the CPU.
            Prints kill to the first 202, restart to drained, the ingest
            events/s beside phase 12's, the reads' seconds, p50/p99/qps,
            each line with the card's name and power limit. The phase
            stops its children on any failure and deletes its WAL.
12c. sharded phase 12's 100,000 events over a ``sharded`` source of three
            ``console storageserver`` daemons (each over its own sqlite
            file under ``build/sharded/``) at REPLICAS=2; metadata and
            models on one unsharded local source. (a) ``console import``:
            each daemon, asked through a plain ``remote`` source, holds
            its home events and its predecessor's copies exactly, 200,000
            rows in all. (b) ``shard=(i, 3)`` reads through the sharded
            store: each moves daemon i's ``storage_rpc_total`` finds and
            no other's, the three are disjoint and their union is the
            file's events. (c) ``console status`` prints three ``OK
            shard`` lines; a train (windowed: block_partials and the
            combine 2 x 20 times); a ``QueryServer`` on its instance here
            and a consumer at each shard stream's head; daemon 1
            SIGKILLed: ``status`` exits 1 naming shard 1, and the same
            train reads through the successor failover: its frame equal
            and its factors bit-equal to the first's, the kernels held to
            their plain versions on its plans. (d) ``console eventserver``
            over the source, daemon 1 still down: 10,000 new ratings of
            1,000 new users from 4 writers, each answered 201 where its
            home shard is up and 503 "storage shard unavailable" where
            not; daemon 1 restarted on its file and the 503s re-POSTed
            until each is a 201; every event once on its home. (e) The
            consumer folds (d)'s events from the three shard streams,
            each once, on the card; a second consumer at its persisted
            cursor consumes none; 500 queries from 16 threads: every
            answer the plain top-k on the CPU, top-k launches equal the
            batches by the route and by devprof, the served slab held to
            the plain select. Each line has the card's name and power
            limit; the phase stops its children on any failure.
12d. backends phase 12's 100,000 events over the parquetfs and the
            postgres event stores. (a) ``console export --format parquet``
            of the app from the loop's sqlite file and ``console import``
            of the file into an app whose EVENTDATA is a parquetfs source
            (metadata in sqlite, models in files, under
            ``build/backends/``), both children, running beside (b); a
            ``train --engine-json`` over it here: block_partials and the
            combine 2 x 20 times and no dense pass, the staged plan held to
            the plain versions, the frame the generated triples, and,
            where it equals phase 12's sqlite frame column for column (it
            prints whether), the factors bit-equal to phase 12's train;
            ``deploy --log-url`` to a collector in this process answers
            500 queries from 16 threads: one select a batch by the route
            and by the child's ``/debug/profile``, every answer the plain
            top-k on the CPU, and after its Ctrl-C the collector holds the
            JAX ``RemoteLogHandler`` fields, one access record a query
            with its trace id. (b) A plain ``type=postgres`` source fails
            with the named driver error (or a connect error where a driver
            imports; it prints which); then every repository on one
            postgres source whose client is ``_PGClient(conn=...)`` over
            ``tests/fake_pg.py`` (sqlite 3.35 or newer, printed): ``app
            new``, the 100,000 events read from the loop's file through
            ``insert_batch``, a train here (the checks of (a); its read in
            11 keyset pages of ``FIND_PAGE``), ``console status`` listing
            the train's engine manifest, and a ``QueryServer`` here with
            ``log_url`` answering 500 queries (the checks of (a), devprof
            in this process). Prints each part's seconds with the card's
            name and power limit.
13. online the online fold-in over phase 12's app and instance: the
            variant's newest COMPLETED runtime built here on the card
            (``latest_completed_runtime``) behind a ``QueryServer`` in this
            process, a consumer attached (``attach_online``, ticks of 0.2
            s, from the latest revision), ``console eventserver`` again.
            From ONLINE_SEED, 4 writers POST 7,800 events in batches of 50
            in a random order: 200 new users x 20 ``rate`` events on
            existing movies, 300 users x 5 movies they had not rated, 200
            new movies x 10 raters (I_p grows from 1,792 to 1,920, past the
            pad headroom, and the item solves carry over ticks of 64) and
            300 ``$set`` user events, while 4 threads query known users (a
            query every 50 ms each) and one the 20 sampled new users
            (one every 20 ms). The cursor must reach the
            store's latest revision with no pending item within 60 s;
            ``events_consumed`` must equal the events POSTed,
            ``events_folded`` the relevant ones, ``users_folded`` and
            ``items_folded`` cover the 500 users and 200 movies, and every
            new row be non-zero. Events POSTed after ``POST
            /online/pause`` stay unfolded until ``/online/resume``. Then
            500 queries from 16 threads (the 200 new users among them):
            scored top-k launches equal batches, all on the select route,
            every answer equal to the plain top-k on the CPU over the
            served factors, every new user's non-empty. A fresh consumer
            resumes at the persisted cursor with an idle first tick and
            the counters unchanged. Every ``fold_in_rows`` call is re-run
            on the CPU (rtol = atol = 1e-4); ``stage_serving`` must not run
            during the ticks; the served f32 state, and an int8 staging of
            the trained factors replayed through the same row publishes,
            must be bit-equal to a restage of the served factors;
            ``recommend_select`` on both slabs equals its plain version at
            B in {1, 64}, k in {10, 128}. Prints tick seconds, the fold's
            ms on the card a call, publish ms a tick, event-to-served
            seconds and query p50/p99/qps while folding and after, each
            line with the card's name and power limit.
14. templates  item properties and two more templates over phase 9's
            app (1,010,209 ``rate`` events after phase 11's delta), from
            TEMPLATES_SEED, through one ``console import``: a ``$set`` of
            1-3 of ML-1M's 18 genres as ``categories`` for each of the
            3,806 movies, later ``$unset`` on 200 and ``$delete`` on 50,
            like/dislike on 150,000 sampled rated pairs (>= 4 stars a
            like, <= 2 a dislike), and an ``unavailableItems`` list of
            100 movies; ``aggregate_properties`` must give back exactly
            those categories. The similar-product ``multi`` variant (the
            rate events as views, ``als`` and ``like`` at the template
            defaults, ``sum`` serving): ``train --engine-json`` here must
            launch the dense passes 20 + 20 (``als``, 1 M edges) and
            block_partials and the combine 40 + 40 (``like``, windowed),
            block_partials held to its plain version on the like plans;
            ``deploy`` in its own process on the card takes 500 baskets
            from 16 threads (1-5 movies, 20 % blacklists, 10 %
            whitelists, 20 of unknown ids only): top-k launches, all on
            the select route, equal 2 x the baskets with a known movie;
            every answer equals the plain selector on the CPU over the
            same factors, per algorithm and summed, its scores within
            1e-5 of ``normed @ mean(normed[known])``; unknown baskets
            answer empty. The e-commerce template (``unseen_only``, seen
            events rate and view): the dense passes 20 + 20, the model's
            categories those imported; then 5 ``view`` events for each of
            20 users the model does not know; ``deploy`` on the card
            takes 500 queries (30 % categories, 10 % whitelists, 20 %
            blacklists, the 20 viewers, 5 users with no events), then a
            second ``unavailableItems`` list of 100 other movies and 50
            more queries: every answer equals a brute force here over the
            persisted factors and the store's events (a stable sort of
            the user's scores or of the view basis's cosine over the
            allowed items; scores within 1e-6 relative, items as sets
            inside tie groups), holds no seen, unavailable (the list
            current at the query), blacklisted or basis movie, and only
            movies of a wanted category; no top-k kernel launches (the
            JAX package ranks on the host here too). The recommendation
            template with ``read_item_categories`` and ``use_data_view``:
            ``train`` twice, the second read a DataView hit with the
            factors bit-equal; 100 category queries through the deployed
            runtime on the card, one select launch each, each equal to
            the plain top-k on the CPU. Prints each template's read,
            train and persist seconds, deploy to ready, query p50/p99/qps
            and launches, each line with the card's name and power limit.
15. data25  MovieLens-25M-shaped ratings from SEED25, as phase 4: 162,541
            users x 59,047 items, 25,000,095 unique pairs (users 20 to
            32,202 ratings, items up to 81,491); the dense gate must refuse
            them for the byte budget alone (int8 R 9,688,842,240 B > 9e9).
            Builds both windowed plans and prints their block counts.
16. windowed the windowed pass kernels (block_partials and the combine,
            through ``ops.windowed.windowed_gram_b``) against their plain
            versions on the card: K in {1, 8, 10, 32}, implicit and
            explicit weights, signed ratings, padding slots with local ids
            past both ends of [0, S), a block of 1,024 slots on one row,
            unsorted ids, an all-padding plan, and both full ML-25M plans
            at K = 10. Per element within 1e-5 * S, bit-equal on relaunch.
17. windowed train  ``ALSAlgorithm.train`` on the phase-15 data at the
            template defaults with 5 iterations: the staging must be
            StagedWindowedTrain, each kernel must launch once per
            half-step, factors finite, a second run from the same staging
            bit-equal, and the train through the plain windowed pass on
            the card must correlate > 0.9999. Then the factors go through
            the npz blob to ``recommend_serving``: 16 queries, each equal
            to the plain top-k.
18. scatter a rank-48 train (100,000 ratings, 2 iterations) through
            ``ALSAlgorithm.train`` on the card and on the CPU from the same
            seed: within rtol = atol = 1e-4 (no kernel of its own).
19. windowed times  CUDA-event medians per ML-25M side, K = 10: the
            block_partials kernel, its plain version, a gather + outer
            product + ``index_add_`` yardstick the port never calls, the
            bound; the combine kernel, its plain version, its bound; then
            block_partials at K = 32 on the users plan (kernel, plain,
            bound; no yardstick), and the partials kernel's ptxas
            registers, shared memory and CTAs an SM at K = 10 and 32.
20. ur sweep  the precomputed-score selector (``fused_masked_topk``)
            against its plain version on the card: I_p in {1,024 (below
            one 4,096-column select segment), 12,416 (a short last
            segment), 100,096} with dead pads, B in {1, 8, 64}, k in {1,
            10, 64, 1,023, 1,024 (the select route's limit), 1,025 (the
            sort route), n_items}, no mask / bit words / row lists of 8
            and 64, a fully masked row, an all-zero row, equal maxima on
            both sides of every chunk and segment boundary. Each call must
            take the route its k names; indices and values must be equal.
21. ur data the repo's UR configuration (``bench.py:bench_ur_framework``
            at full size) from UR_SEED: 3,000 users, 100,000 items, one buy
            per item plus 30 buys per user on zipf(1.3) items, and 30
            views per user from their own stream, into the port's
            ``MemoryEventStore``.
22. ur train ``URDataSource.read_training`` and ``URAlgorithm.train`` on
            the card at the template defaults (50 correlators, 100 query
            events): every table finite, and equal to the same block train
            on the CPU for three blocks of 256 items per indicator (the
            first, a middle and the last)
            within the LLR tolerance (atol = 16 eps N ln N; indices equal
            outside tie groups). A row where the card and the host CPU
            disagree beyond it (a host with a poor float32 ``log``) is
            held instead to the float64 LLR of the same counts, at the
            same atol, its indices as sets inside tie groups; the row is
            reported as disputed. Prints read, indicator build, counts
            and LLR + top-n seconds.
23. ur serve the card-trained model behind the port's ``QueryServer``;
            16 client threads send 500 UR queries (mostly exclude_seen,
            20 % blacklists, unknown users, view-only users added after
            the train). Every answer must equal ``_predict_batch`` on a
            CPU copy of the model; masked kernel launches, and those of
            its select route, must equal device batches.
24. ur times CUDA-event medians at I_p = 100,096, k = 64, bit words, B in
            {1, 64}: the kernel (its launches per call, which must equal
            its route's, and its time on the card alone, both by
            ``torch.profiler``), its plain version,
            ``torch.topk`` over
            ``torch.where(mask, NEG_INF, scores)`` as a yardstick the port
            never calls, the bound, and the history scoring outside it.
            Then batch invariance on the card: 64 real users' rows of
            ``history_scores`` at B = 64 bit-equal to each user scored
            alone, the masked select's values and indices likewise, and
            the UR's answers through ``batch_predict`` to 64 queries equal
            to each query answered alone, scores bit for bit.
25. classify the classification and regression templates (no kernel of
            the five runs here; their models are torch ops). (a) UCI
            Covertype's shape from CLASSIFY_SEED: 581,012 cells in the 7
            published class counts, 10 integer quantitative columns per
            class within the published ranges (the signed one shifted to
            be non-negative) and 4 + 40 one-hot columns; 90 / 10 split.
            Naive Bayes (λ 1), logistic regression (200 steps, lr 0.5, l2
            1e-4) and the forest (20 trees, depth 6, 32 bins, 7 features
            a node) on the card, each three times: the same bits on
            relaunch and with TF32 allowed for the process. NB's arrays
            within rtol 1e-5 of the same train on the CPU, LR's weights
            within rtol 1e-4, atol 1e-5·max|w|; the first 2 trees regrown
            on the CPU from the card's draws equal; every held-out
            accuracy above the 0.4876 majority rate. (b)
            YearPredictionMSD's shape from REGRESS_SEED: 515,345 x 90, a
            year target linear in the features plus noise (1922-2011),
            the published split (463,715 train). Ridge (l2 1e-6) on the
            card, three times as in (a); weights within rtol 1e-3 of a
            float64 numpy ridge, test RMSE within 0.1 % of its; the l2
            grid {1e-6, 1e-3, 1e-1} equal to its per-point trains (rtol
            1e-4). (c) Through storage under ``build/classify/``: the
            first 12,000 cells and 6,000 songs as ``$set`` events
            (``console import``), read back exactly by the trains'
            ``aggregate_properties``; the classification variant
            (``randomforest``, ``logreg``, ``naive``; FirstServing) and
            ridge trained by ``train --engine-json`` and served by
            ``deploy`` processes on the card: 500 queries each from 16
            threads. Every classification answer equals the forest's
            predict on a CPU copy of the persisted model, and the other
            two models' ``batch_predict`` on the card equals their CPU
            copies' (outside top-two score margins of 1e-4); regression
            queries half bare arrays, half ``{"features": [...]}``, each
            a bare number within 2 ulp of the persisted model's predict,
            and 10 malformed ones each a 400. ``run_evaluation`` (5
            folds) of an NB λ grid {0.5, 1, 2, 4} and an LR grid of 3
            (lr, l2) points over the cells and an l2 grid over the songs:
            one ``train_grid`` a fold, no per-point train, each fold's
            grid models equal to per-point trains at the JAX package's
            bars. Prints each train's host and CUDA-event seconds and
            accuracy, import, read, train, persist, deploy to ready,
            p50/p99/qps and eval_wall_sec, each line with the card's name
            and power limit.
26. observe the port's observability of the main path, on the earlier
            phases' state (``PIO_DEVPROF_STRICT=1`` for the whole run: a
            call the profiler cannot time fails its phase). (a) The
            device profiler's in-process report: every executable of
            the dense and windowed trains, the ALS and UR serves and the
            classify phase present with calls and device seconds > 0,
            no timing error, raw MFU and raw memory-roof fraction <= 1.05
            for each (a higher one means a wrong work count), the
            platform this card; ``als.train_dense``'s flops in phase 6
            obs.costs' per-iteration count x the iterations; devprof's
            mean device ms a call beside the dense and windowed times
            phases' CUDA-event medians, within a factor of 2. (b) Each
            in-process phase's card-busy share: the profiler's device
            seconds over the phase's wall. (c) A ``QueryServer`` on
            phase 6's factors in this process: a 2 s ``POST
            /debug/profile/capture`` under 4 clients' load must run its
            window on the dispatcher's thread and write a
            ``torch.profiler`` trace with ``recommend_select``'s kernels
            in it; then 8 threads send 200 queries, each with its own
            ``X-Request-ID``: ``GET /metrics`` parses as Prometheus text,
            counts the 200 and one ``batch_padding_ratio`` sample a
            device batch, and its allocated-bytes gauge equals
            ``torch.cuda.memory_allocated()``; ``GET /debug/profile``
            lists ``als.recommend_serving`` with one call a device batch
            and a select-route launch each, against the card's peak
            table row; ``GET /debug/traces?trace_id=`` returns a query's
            ``server.request`` span and the ``batch.device_dispatch`` span
            of the batch that carried it; 20 answers equal the plain
            version's on the CPU. Then the host ms a
            ``recommend_serving`` call at B = 1 and 64 with the profiler
            on and off (200 calls each): the wrapper's cost.
27. rollout the query server's canary rollout and resilience at ML-20M
            width, on phase 6's factors (A) and its plain-pass train's (B),
            over storage under ``build/rollout/``: instances A, B, C (A's
            factors) and D (B's) persisted as ``run_train`` persists one (no
            train), versions registered, A promoted. (a) A's runtime built
            on the card, served at continuous/4, continuous/1 and
            windowed/1: the same 500 bodies from 16 clients each time, every
            answer equal to the plain version's on the CPU, select launches
            = launches = device batches; p50/p99/qps and devprof's device
            ms a batch per mode. Then one server (defaults: continuous, depth
            4; ``PIO_FAULTS_ADMIN=1``) and canaries with window 5 s, interval
            0.25 s, min_requests 50, bake 4 s, each candidate built before 16
            clients start querying back to back: (b) a shadow canary of C at
            0.5 agrees on every one of >= 50 mirrors and is promoted, every
            client answer 200 and A's; (c) ``dispatch.device@candidate:error:1.0``
            through ``POST /debug/faults``, a canary of B at 0.1: rolled back,
            B ``rolled_back``, every live-routed answer 200 and the live
            factors', then the fault cleared; (d) D at 0.25, promoted:
            candidate-routed answers D's, live-routed C's, D's after the
            swap, and ``torch.cuda.memory_allocated()`` after a
            ``gc.collect()`` back within half a runtime's staged bytes of the
            pre-canary figure; (e) a canary with bake 600 s survives a
            restart (same version, same ``started_wall``) and ``console
            rollout abort`` ends it; (f) 100 queries with ``X-PIO-Deadline:
            0``: 503 + ``Retry-After``, ``queries_shed_total{reason=
            "deadline"}`` +100, no launch; a 50 ms deadline under a 200 ms
            ``dispatch.device`` delay a 503 within 150 ms, the next query 200
            and D's; (g) an Event Server in this process over the same
            storage: 50 queries with feedback give 50 ``predict`` events of
            ``pio_pr`` with their queries and answers, an event POST with
            ``X-PIO-Deadline: 0`` a 503 and no row; (h) the phase's top-k
            launches outside the builds = select launches = the device
            batches the servers booked (live, candidate and shadow). Prints
            each figure, the verdict times, the shed latency, the phase's
            wall and card-busy share, each line with the card's name and
            power limit.
28. monitor the monitoring plane and the operator servers at ML-20M width,
            on phase 6's factors, over storage under ``build/monitor/``.
            (a) A ``QueryServer`` on the card, an Event Server and an
            ``AdminServer`` in this process, all three attached to the
            process monitor, whose sampler and SLO engine run every
            0.25 s with the latency SLO ``query_p250`` (objective 0.99,
            250 ms, windows 2 s and 6 s, burn 2, for 0.5 s, resolve 1 s)
            and an exec notifier appending each alert to a file; ``console
            dashboard`` in a process of its own scraping the three every
            0.5 s, collecting their traces, with an ``up`` SLO
            ``event_up`` on the Event Server, and a durable TSDB tier
            under ``build/monitor/tsdb`` (WAL flush 0.25 s, seal 2 s,
            checkpoint every 2,000 points). (b) 500 queries from 16
            clients: 20 answers equal the plain version's on the CPU,
            nothing firing; ``/debug/tsdb``'s increase of 200s on
            ``/queries.json`` exactly 500, its latest
            ``devprof_invocations_total`` devprof's report and its
            allocated bytes ``torch.cuda.memory_allocated()``; the rate
            of ``devprof_device_seconds_total`` over 5 s, read during the
            traffic, within one tick's share of devprof's own device
            seconds over the same window (devprof snapshotted at the
            sampler's two points the rate spans). Then the dashboard
            child is SIGKILLed and started again on the same directory
            and targets: ``/debug/tsdb`` reports ``durable`` with replayed
            points and its pre-kill query 200s.
            (c) ``dispatch.device:delay:1.0:0.4`` through ``POST
            /debug/faults`` under 8 clients: ``query_p250`` pending, then
            firing, one firing notification with the JAX notifier's keys;
            cleared: resolved, one resolve notification; ``console alerts``
            prints ``GET /alerts``' states. (e) A query with its own
            ``X-Request-ID`` sent during the delay: the dashboard's
            ``/debug/traces?fleet=1&trace_id=`` holds its
            ``server.request`` and ``batch.device_dispatch`` spans. (d)
            The dashboard's ``up`` is 1 for the three; the Event Server
            stopped, ``up{instance="event"}`` reads 0 within two scrape
            intervals and ``event_up`` fires. (f) The admin server's
            ``/models``, ``/jobs``, ``/online`` and ``/rollout`` equal
            ``console models list``, ``jobs list``, ``online cursors`` and
            ``rollout status`` over the same storage, ``/evals`` (no run)
            ``eval list``; ``/tenants`` 404 not ported yet. Durable: the
            dashboard's increase of the query server's ``/queries.json``
            200s over the whole phase equals the query server's own count
            less the first scraped value (the warm query's 1) and its
            own TSDB's increase (no phantom reset at the restart);
            ``devprof_device_seconds_total{instance="query"}`` never falls;
            a sealed raw block; ``console tsdb`` and the dashboard's
            durable panel list the tiers. (g) The
            phase's top-k launches
            = select launches = the device batches the query server
            booked. (h) Every server stopped and the dashboard child
            exited 0 on SIGINT: no sampler, engine, scraper or collector
            thread left. A copy of the dashboard's directory, its WAL
            sealed, compacted with ``now`` pinned 10 min past the phase:
            a 5m tier whose increase of the query 200s over the buckets it
            spans equals the raw tier's (and the device seconds'). Prints
            each figure, the alert times, the phase's wall and card-busy
            share, each line with the card's name and power limit.
29. report  one ``{"kernels": [...]}`` line, then the device line last.

Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import datetime
import gc
import http.client
import io
import json
import math
import os
import queue
import re
import shlex
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import threading
import time
import traceback
import uuid
from pathlib import Path

import numpy as np
import torch

try:
    from predictionio_tpu_torch import convert
    from predictionio_tpu_torch.core.base import RuntimeContext
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.api.server import EventServer, EventServerConfig
    from predictionio_tpu_torch.data.storage.base import (
        AccessKey,
        App,
        EngineInstance,
        EventQuery,
        Model,
        shard_of,
    )
    from predictionio_tpu_torch.controller import (
        EngineParams,
        EngineParamsGenerator,
        Evaluation,
        MetricEvaluator,
        deserialize_models,
        resolve_engine,
        serialize_models,
    )
    from predictionio_tpu_torch.controller.params import params_to_json
    from predictionio_tpu_torch.data.storage.registry import (
        SourceConfig,
        Storage,
        StorageConfig,
    )
    from predictionio_tpu_torch.data.store.bimap import BiMap
    from predictionio_tpu_torch.data.store.event_store import EventStoreFacade
    from predictionio_tpu_torch.data.view import DataView
    from predictionio_tpu_torch.engines.ecommerce.engine import (
        ECommAlgorithmParams as ECommParams,
    )
    from predictionio_tpu_torch.engines.recommendation.engine import (
        ALSAlgorithm,
        ALSAlgorithmParams,
        ALSModel,
        DataSourceParams,
        PrecisionAtK,
        Query,
        RecommendationDataSource,
        RecommendationEngine,
        TrainingData,
    )
    from predictionio_tpu_torch.engines.similarproduct.engine import (
        ALSSimilarAlgorithm as SimilarAlgorithm,
        ALSSimilarParams as SimilarParams,
        LikeAlgorithm,
        Query as SimilarQuery,
        SumScoreServing,
    )
    from predictionio_tpu_torch.engines.universal.engine import (
        DataSourceParams as URDataSourceParams,
        Query as URQuery,
        URAlgorithm,
        URAlgorithmParams,
        URDataSource,
        URModel,
    )
    from predictionio_tpu_torch.engines.classification.engine import (
        Accuracy,
        ClassificationDataSource,
        ClassificationEngine,
        DataSourceParams as ClassifyDataSourceParams,
        LogisticRegressionAlgorithm,
        LogisticRegressionParams,
        NaiveBayesAlgorithm,
        NaiveBayesParams,
        Query as ClassifyQuery,
    )
    from predictionio_tpu_torch.engines.regression.engine import (
        DataSourceParams as RegressDataSourceParams,
        MeanSquareError,
        RegressionDataSource,
        RegressionEngine,
        RidgeAlgorithm,
        RidgeParams,
    )
    from predictionio_tpu_torch.models import als, cco, classify, forest, linreg
    from predictionio_tpu_torch.obs import costs, devprof
    from predictionio_tpu_torch.obs.spans import get_default_recorder
    from predictionio_tpu_torch.workflow.evaluation import run_evaluation
    from predictionio_tpu_torch.online import (
        OnlineConsumer,
        OnlineConsumerConfig,
        ServerApplyHost,
    )
    from predictionio_tpu_torch.deploy.registry import LifecycleRecordStore, ModelRegistry
    from predictionio_tpu_torch.evalfleet import EvalDriver, EvalRecordStore, PresetStore
    from predictionio_tpu_torch.data.aggregator import aggregate_properties
    from predictionio_tpu_torch.obs import monitor as obs_monitor
    from predictionio_tpu_torch.obs.monitor import (
        AlertNotifier,
        SLOSpec,
        get_monitor,
        parse_prometheus_text,
    )
    from predictionio_tpu_torch.obs.monitor import push as obs_push
    from predictionio_tpu_torch.obs.monitor.compact import Compactor
    from predictionio_tpu_torch.obs.monitor.durable import TIER_BUCKETS, DurableTSDB
    from predictionio_tpu_torch.obs.monitor import THREAD_NAMES as MONITOR_THREAD_NAMES
    from predictionio_tpu_torch.online.consumer import CURSOR_ENTITY
    from predictionio_tpu_torch.tools.admin import AdminServer
    from predictionio_tpu_torch.deploy.rollout import sticky_candidate
    from predictionio_tpu_torch.resilience import faults
    from predictionio_tpu_torch.deploy.scheduler import (
        JobQueue,
        SchedulerConfig,
        TrainScheduler,
    )
    from predictionio_tpu_torch.ops import _build, dense
    from predictionio_tpu_torch.ops import dense_fused as df
    from predictionio_tpu_torch.ops import recommend as rec
    from predictionio_tpu_torch.ops import windowed as win
    from predictionio_tpu_torch.ops import windowed_fused as wf
    from predictionio_tpu_torch.tools import console
    from predictionio_tpu_torch.workflow.checkpoint import (
        CheckpointManager,
        train_als_checkpointed,
    )
    from predictionio_tpu_torch.workflow import core as wcore
    from predictionio_tpu_torch.workflow.core import stage_timings
    from predictionio_tpu_torch.data.storage import segmentfs
    from predictionio_tpu_torch.data.storage.base import StorageError
    from predictionio_tpu_torch.data.storage.replication import (
        FollowerLink,
        ReplicaReadStorage,
        ReplicationConfig,
        SegmentShipper,
        elect_and_promote,
    )
    from predictionio_tpu_torch.data.api.storage_server import StorageServer
    from predictionio_tpu_torch.obs.registry import get_default_registry
    from predictionio_tpu_torch.data.store.columnar import EventFrame
    from predictionio_tpu_torch.parallel.loader import SegmentStager
    from predictionio_tpu_torch.workflow.server import (
        QueryServer,
        QueryServerConfig,
        _to_jsonable,
        build_runtime,
        latest_completed_runtime,
    )
except ImportError as exc:  # run outside a checkout of the repository
    _IMPORT_ERROR: ImportError | None = exc
else:
    _IMPORT_ERROR = None

SEED = 20
N_USERS, N_ITEMS, RANK = 138_493, 26_744, 10  # ML-20M
N_EDGES = 20_000_263  # ML-20M's unique (user, item) ratings
# fewest and most ratings of a user and of an item in ML-20M
USER_DEGREES, ITEM_DEGREES = (20, 9_254), (1, 67_310)
TRAIN_ITERATIONS = 5
K_LADDER = (1, 10, 128, 1024, N_ITEMS)
N_QUERIES, N_CLIENTS = 500, 16
# published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and
# operations/s per operand type (f32 on CUDA cores, bf16/int8 tensor cores)
HBM_BPS = 3.35e12
PEAK_OPS = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}
TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
SOURCE = "predictionio_tpu_torch/ops/csrc/recommend_topk.cu"
REPLACES = "predictionio_tpu/ops/recommend_pallas.py:412"
DENSE_SOURCE = "predictionio_tpu_torch/ops/csrc/dense_pass.cu"
DENSE_REPLACES = {"row": "predictionio_tpu/ops/dense_pallas.py:122",
                  "col": "predictionio_tpu/ops/dense_pallas.py:175"}
SEED25 = 25
N25_USERS, N25_ITEMS = 162_541, 59_047  # ML-25M's users and rated movies
N25_EDGES = 25_000_095  # ML-25M's ratings
USER25_DEGREES, ITEM25_DEGREES = (20, 32_202), (1, 81_491)
WINDOWED_SOURCE = "predictionio_tpu_torch/ops/csrc/windowed_pass.cu"
WINDOWED_REPLACES = "predictionio_tpu/ops/windowed_pallas.py:68"
SCATTER_USERS, SCATTER_ITEMS, SCATTER_EDGES, SCATTER_RANK = 3_000, 2_000, 100_000, 48
UR_SEED = 13
UR_APP = "urbench"
UR_USERS, UR_ITEMS = 3_000, 100_000  # bench.py:bench_ur_framework at full size
UR_PER_USER, UR_ZIPF = 30, 1.3  # buys (and views) per user on zipf(1.3) items
UR_CORRELATORS, UR_QUERY_EVENTS = 50, 100  # template defaults
UR_T0 = datetime.datetime(2024, 1, 1, tzinfo=datetime.timezone.utc)
UR_NEW_USERS = 50  # view-only users added after the train
# (I_p, n_items): below one select segment, a short last segment, the UR
# catalog (not a multiple of the segment either)
UR_SWEEP_WIDTHS = ((1_024, 1_000), (12_416, 12_345), (100_096, 100_000))
# up to the select route's limit, and the first k above it
UR_K_LADDER = (1, 10, 64, 1_023, 1_024, 1_025)
# the first, a middle and the last 256 items
UR_CPU_BLOCKS, UR_CPU_BLOCK_ROWS = (0, 49_920, 99_744), 256
UR_TIMES_K = 64
MASKED_REPLACES = "predictionio_tpu/ops/recommend_pallas.py:468"
LOOP_SEED = 1
LOOP_USERS, LOOP_ITEMS = 6_040, 3_706  # ML-1M's users and rated movies
LOOP_EDGES = 1_000_209  # ML-1M's ratings
# fewest and most ratings of a user and of a movie in ML-1M
LOOP_USER_DEGREES, LOOP_ITEM_DEGREES = (20, 2_314), (1, 3_428)
LOOP_APP = "ml1m"
LOOP_T0_MS = 956_703_932_000  # ML-1M's first rating time, epoch ms
LOOP_UNKNOWN_USERS = 20  # queries for users with no events, after the 500
# the recommendation template's tuning example over the loop's app
EVAL_FOLDS, EVAL_NUM, EVAL_THRESHOLD, EVAL_PRECISION_K = 5, 10, 4.0, 10
EVAL_GRID = tuple((rank, iterations, lam) for rank in (10, 20)
                  for iterations in (20, 40) for lam in (0.01, 0.1))
EVAL_HELD_POINTS = (0, 4)  # rank 10 and rank 20: answers held to the CPU's
INGEST_SEED = 100
INGEST_USERS, INGEST_ITEMS = 943, 1_682  # ML-100K's users and movies
INGEST_EDGES = 100_000  # ML-100K's ratings
# fewest and most ratings of a user and of a movie in ML-100K
INGEST_USER_DEGREES, INGEST_ITEM_DEGREES = (20, 737), (1, 583)
INGEST_APP = "ml100k"
INGEST_T0_MS = 874_724_710_000  # ML-100K's first rating time, epoch ms
INGEST_WRITERS, INGEST_BATCH, INGEST_SINGLES = 4, 50, 200
INGEST_HOLDOUT, INGEST_DELETED, INGEST_REFUSED = 50, 10, 5
INGEST_READ_IDS, INGEST_READ_USERS = 100, 20
ONLINE_SEED = 14
ONLINE_NEW_USERS, ONLINE_NEW_USER_EVENTS = 200, 20  # new users x rate events
ONLINE_OLD_USERS, ONLINE_OLD_USER_EVENTS = 300, 5  # existing users x new ratings
ONLINE_NEW_ITEMS, ONLINE_NEW_ITEM_EVENTS = 200, 10  # new items x raters
ONLINE_SETS = 300  # $set user events: irrelevant traffic
ONLINE_TICK_S, ONLINE_WAIT_S = 0.2, 60.0
ONLINE_PAUSED, ONLINE_SAMPLED = 50, 20  # events POSTed while paused; users timed
# the query load while folding is N_CLIENTS clients sending back to back,
# as every serve phase does; the sampled new users' poll, one query a period
ONLINE_SAMPLE_PERIOD_S = 0.02
LIFECYCLE_SEED = 15
LIFECYCLE_ENGINE = "ml1m-lc"
LIFECYCLE_CHECKPOINT_EVERY = 5
# job 3's cadence: ten 2-iteration segments, so that its train is still
# running once its first segment's report is spooled and it is killed
# (at 5, the whole train can end inside one push period)
LIFECYCLE_CRASH_CHECKPOINT_EVERY = 2
LIFECYCLE_NEW_USERS, LIFECYCLE_NEW_USER_RATINGS = 200, 20  # on existing movies
LIFECYCLE_NEW_ITEMS, LIFECYCLE_NEW_ITEM_RATINGS = 100, 30  # by existing users
LIFECYCLE_OLD_USERS, LIFECYCLE_OLD_USER_RATINGS = 300, 10  # new pairs
LIFECYCLE_QUERIES, LIFECYCLE_CLIENTS = 200, 8
# push telemetry: the children's spool-and-ship period (short enough that
# job 3's killed attempt spooled its first segment's devprof report), and
# the ingest's secret
LIFECYCLE_PUSH_INTERVAL_S = 0.25
LIFECYCLE_PUSH_TOKEN = "chip-smoke-push-secret"
TEMPLATES_SEED = 16
# ML-1M's 18 genres (its README); each movie gets 1-3 as "categories"
ML1M_GENRES = ("Action", "Adventure", "Animation", "Children's", "Comedy", "Crime",
               "Documentary", "Drama", "Fantasy", "Film-Noir", "Horror", "Musical",
               "Mystery", "Romance", "Sci-Fi", "Thriller", "War", "Western")
TEMPLATES_UNSET, TEMPLATES_DELETE = 200, 50  # movies whose categories go
TEMPLATES_LIKES = 150_000  # rated pairs sampled: >= 4 stars a like, <= 2 a dislike
TEMPLATES_UNAVAILABLE = 100  # movies in each unavailableItems list
TEMPLATES_UNKNOWN_BASKETS = 20  # baskets of unknown ids only, among the 500
TEMPLATES_NEW_VIEWERS, TEMPLATES_NEW_VIEWS = 20, 5  # users only the store knows
TEMPLATES_NO_EVENT_USERS = 5
TEMPLATES_AFTER_QUERIES = 50  # e-commerce queries after the second list
TEMPLATES_CATEGORY_QUERIES = 100  # the recommendation template's
TEMPLATES_T0_MS = LOOP_T0_MS + 1000 * (LOOP_EDGES + 100_000)  # after phase 11's delta
CLASSIFY_SEED, REGRESS_SEED = 17, 18
# UCI Covertype: 581,012 cells, its 7 cover types' published counts, 10
# quantitative columns (name, published min and max; the generated
# data's mean per cover type and spread, chosen here: multinomial naive
# Bayes reads a row's proportions, so the two distances to roads and to
# fire points tell the two largest cover types apart), then 4
# wilderness-area and 40 soil-type one-hot columns
COVTYPE_COUNTS = (211_840, 283_301, 35_754, 2_747, 9_493, 17_367, 20_510)
COVTYPE_LABELS = ("spruce_fir", "lodgepole_pine", "ponderosa_pine", "cottonwood_willow",
                  "aspen", "douglas_fir", "krummholz")
COVTYPE_QUANT = (
    ("elevation", 1859, 3858, (3130, 2920, 2390, 2225, 2790, 2420, 3360), 150),
    ("aspect", 0, 360, (157, 153, 176, 138, 140, 180, 153), 100),
    ("slope", 0, 66, (13, 13, 20, 18, 16, 19, 14), 7),
    ("horizontal_distance_to_hydrology", 0, 1397, (270, 279, 211, 101, 213, 209, 357), 200),
    ("vertical_distance_to_hydrology", -173, 601, (43, 46, 63, 40, 51, 66, 70), 55),
    ("horizontal_distance_to_roadways", 0, 7117, (3000, 1600, 900, 700, 1300, 1000, 2800),
     500),
    ("hillshade_9am", 0, 254, (211, 213, 201, 223, 223, 193, 217), 25),
    ("hillshade_noon", 0, 254, (224, 225, 216, 221, 219, 209, 220), 18),
    ("hillshade_3pm", 0, 254, (143, 142, 140, 111, 121, 148, 134), 37),
    ("horizontal_distance_to_fire_points", 0, 7173, (1500, 2800, 900, 800, 1600, 1100, 2100),
     500),
)
COVTYPE_ATTRS = (tuple(q[0] for q in COVTYPE_QUANT)
                 + tuple(f"wilderness_area_{i}" for i in range(1, 5))
                 + tuple(f"soil_type_{i}" for i in range(1, 41)))
# the template defaults: naive Bayes' λ, logistic regression's steps, rate
# and l2, the forest's trees, depth, bins and seed (7 features a node: the
# "auto" round(sqrt(54)))
NB_LAMBDA, LR_ITERATIONS, LR_RATE, LR_L2 = 1.0, 200, 0.5, 1e-4
RF_TREES, RF_DEPTH, RF_BINS, RF_SEED, RF_REGROWN = 20, 6, 32, 42, 2
# YearPredictionMSD: 515,345 songs x 90 timbre features (12 averages, 78
# covariances), years 1922-2011, the published split (first 463,715 train)
YEAR_ROWS, YEAR_TRAIN, YEAR_SPAN = 515_345, 463_715, (1922, 2011)
YEAR_ATTRS = (tuple(f"timbre_avg_{i}" for i in range(1, 13))
              + tuple(f"timbre_cov_{i}" for i in range(1, 79)))
RIDGE_L2, RIDGE_GRID = 1e-6, (1e-6, 1e-3, 1e-1)
# the store path: entities cut to fit the script's time limit
CLASSIFY_ENTITIES, REGRESS_ENTITIES, CLASSIFY_FOLDS = 12_000, 6_000, 5
NB_GRID = (0.5, 1.0, 2.0, 4.0)
LR_GRID = ((0.5, 1e-4), (0.3, 1e-3), (0.8, 1e-2))  # (lr, l2)
CLASSIFY_T0_MS = 1_262_304_000_000  # 2010-01-01, epoch ms
OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"
LOOP_DIR = Path(__file__).resolve().parent / "build" / "loop"
CLASSIFY_DIR = Path(__file__).resolve().parent / "build" / "classify"
REMOTE_DIR = Path(__file__).resolve().parent / "build" / "remote"
REMOTE_KILL_AT, REMOTE_RESTART_AT = 1 / 3, 2 / 3  # of the ingest's POSTs answered
REMOTE_FAULT_SINGLES, REMOTE_FAULT_BATCHES = 20, 2  # the event.insert burst's POSTs
REMOTE_ENGINE, REMOTE_DIRECT_ENGINE = "ml100k-remote", "ml100k-direct"
REMOTE_POLL_S, REMOTE_DRAIN_S = 0.1, 300.0
REMOTE_EVENTS = 30_000  # of phase 12's 100,000 events: the seeded sample 12b posts
REMOTE_BREAKER_COOLDOWN_S = 2.0  # the remote source's breaker: a probe 2 s after it opens


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------


def phase_device(report, shared):
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    report["nvidia_smi"] = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report["device"] = torch.cuda.get_device_name(0)
    report["torch"] = torch.__version__
    report["cuda"] = torch.version.cuda
    # the host's CPU: the CPU plain versions' float32 math differs between
    # hosts (the UR train's CPU check is held to a tolerance that assumes
    # a log within a few ulps): torch's vectorized log against the
    # correctly rounded one at the UR's sizes
    xs = torch.arange(2900, 3100, dtype=torch.float32)
    want = torch.tensor([math.log(x) for x in xs.tolist()], dtype=torch.float64)
    ulp = (torch.log(xs).double() - want).abs() / (2.0 ** -21)  # ulps of [4, 8)
    report["host_cpu"] = {"capability": torch.backends.cpu.get_cpu_capability(),
                          "model": _cpu_model(), "cores": os.cpu_count(),
                          "log_max_ulp": float(ulp.max())}
    print(f"[device] {report['device']} | {report['nvidia_smi']} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | host CPU "
          f"{report['host_cpu']['model']} ({report['host_cpu']['cores']} cores, torch "
          f"{report['host_cpu']['capability']}, float32 log within "
          f"{report['host_cpu']['log_max_ulp']:.2f} ulp)", flush=True)


def _cpu_model():
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


def phase_build(report, shared):
    t0 = time.perf_counter()
    paths = _build.build()
    rec._kernel_lib()
    df._kernel_lib()
    wf._kernel_lib()
    report["build_s"] = time.perf_counter() - t0
    report["build_log"] = {
        n: [ln for ln in log.splitlines() if "ptxas" in ln]
        for n, log in _build.BUILD_LOGS.items()
    }
    print(f"[build] {len(paths)} source(s) in {report['build_s']:.2f} s: "
          f"{', '.join(sorted(paths))}", flush=True)
    for n, lines in report["build_log"].items():
        for ln in lines:
            if "registers" in ln or "Compiling entry" in ln:
                print(f"[build] {n}: {ln.strip()}", flush=True)


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain version on the card
# ---------------------------------------------------------------------------


def _slab(rng, dtype, integer=False):
    """(q (64, K), itf (I_p, K)) on the card, with int8 scales."""
    i_p = rec.pad_items(N_ITEMS)
    if integer:
        uf = rng.integers(-2, 3, (64, RANK)).astype(np.float32)
        itf = rng.integers(-2, 3, (N_ITEMS, RANK)).astype(np.float32)
    else:
        uf = (rng.standard_normal((64, RANK)) / np.sqrt(RANK)).astype(np.float32)
        itf = (rng.standard_normal((N_ITEMS, RANK)) / np.sqrt(RANK)).astype(np.float32)
    qs = isc = None
    if dtype == "int8":
        uq, us = rec.quantize_rows_np(uf)
        iq, iscale = rec.quantize_rows_np(itf)
        uf, itf = uq, iq
        qs = torch.from_numpy(np.ascontiguousarray(us[:, None])).cuda()
        isc_np = np.ones((1, i_p), np.float32)
        isc_np[0, :N_ITEMS] = iscale
        isc = torch.from_numpy(isc_np).cuda()
    items = np.zeros((i_p, RANK), itf.dtype)
    items[:N_ITEMS] = itf
    q = torch.from_numpy(uf).cuda().to(TORCH_DT[dtype])
    it = torch.from_numpy(items).cuda().to(TORCH_DT[dtype])
    return q, it, qs, isc


def _masks(rng, b, i_p):
    mask = rng.random((b, N_ITEMS)) < 0.3
    mask[0] = True  # a fully masked row
    bits = torch.from_numpy(rec.pack_mask_np(mask, i_p)).cuda()
    rows = np.full((b, 16), -1, np.int32)
    rows[:, :12] = rng.integers(0, N_ITEMS, (b, 12))
    rows[0, 12] = i_p + 5  # out of range: inert
    return {None: (None, None), "bits": (bits, None),
            "rows": (None, torch.from_numpy(rows).cuda())}


def _compare(args, k, tally, label):
    route = rec.topk_route(k)
    before = rec.ROUTE_LAUNCHES[route]
    kv, ki = rec.fused_recommend_topk(*args, k=k, n_items=N_ITEMS)
    pv, pi = rec.fused_recommend_topk_plain(*args, k=k, n_items=N_ITEMS)
    torch.cuda.synchronize()
    check(rec.ROUTE_LAUNCHES[route] == before + 1,
          f"{label}: not launched on the {route} route")
    check(torch.equal(ki, pi), f"{label}: indices differ from the plain version")
    check(torch.equal(kv, pv), f"{label}: values differ from the plain version")
    tally["max_abs_err"] = max(tally["max_abs_err"],
                               float((kv - pv).abs().max()))
    tally["cases"] += 1
    tally["routes"][route] += 1
    return kv, ki


def phase_sweep(report, shared):
    rng = np.random.default_rng(SEED)
    i_p = rec.pad_items(N_ITEMS)
    tally = {"cases": 0, "max_abs_err": 0.0, "routes": {"select": 0, "sort": 0}}
    t0 = time.perf_counter()
    for dtype in ("f32", "bf16", "int8"):
        q64, itf, qs8, isc8 = _slab(rng, dtype)
        if dtype == "int8":
            try:
                rec.fused_recommend_topk(q64, itf, k=5, n_items=N_ITEMS)
            except ValueError:
                pass
            else:
                raise PhaseError("int8 without scales did not raise")
        cos_q = torch.from_numpy(
            rng.uniform(0.5, 2.0, (64, 1)).astype(np.float32)).cuda()
        cos_i = torch.from_numpy(
            rng.uniform(0.5, 2.0, (1, i_p)).astype(np.float32)).cuda()
        scalings = {"int8": [(qs8, isc8)],
                    "f32": [(None, None), (cos_q, cos_i)],
                    "bf16": [(None, None), (cos_q, cos_i)]}[dtype]
        for qs, isc in scalings:
            for b in (1, 8, 64):
                masks = _masks(rng, b, i_p)
                for kind, (bits, rows) in masks.items():
                    args = (q64[:b].contiguous(), itf,
                            None if qs is None else qs[:b].contiguous(), isc,
                            bits, rows)
                    for k in K_LADDER:
                        label = (f"{dtype} scaled={qs is not None} mask={kind} "
                                 f"B={b} k={k}")
                        kv, ki = _compare(args, k, tally, label)
                        if kind == "bits":  # row 0 is fully masked
                            n = min(k, N_ITEMS)
                            check(bool((kv[0, :n] == rec.NEG_INF).all())
                                  and torch.equal(ki[0, :n].cpu(),
                                                  torch.arange(n, dtype=torch.int32)),
                                  f"{label}: fully masked row")
        # batch invariance: row 0 alone equals row 0 of the B=64 batch
        sc = scalings[-1]
        one = rec.fused_recommend_topk(
            q64[:1].contiguous(), itf,
            None if sc[0] is None else sc[0][:1].contiguous(), sc[1],
            k=128, n_items=N_ITEMS)
        full = rec.fused_recommend_topk(q64, itf, sc[0], sc[1], k=128,
                                        n_items=N_ITEMS)
        torch.cuda.synchronize()
        check(torch.equal(one[0][0], full[0][0]) and torch.equal(one[1][0], full[1][0]),
              f"{dtype}: B=1 row differs from row 0 at B=64")
    # crafted cross-chunk ties: integer factors in [-2, 2] make every
    # score an exact small integer, so thousands of items tie across
    # chunks and the order is decided by the index alone
    for dtype in ("f32", "bf16"):
        q64, itf, _, _ = _slab(rng, dtype, integer=True)
        for k in (128, 1024, N_ITEMS):
            _compare((q64, itf, None, None, None, None), k, tally,
                     f"ties {dtype} k={k}")
    report["sweep"] = dict(tally, seconds=time.perf_counter() - t0)
    print(f"[sweep] {tally['cases']} cases ({tally['routes']['select']} on the "
          f"select route, {tally['routes']['sort']} on the sort route), indices "
          f"and values equal in all, max |kernel - plain| "
          f"{tally['max_abs_err']:.3g}, {report['sweep']['seconds']:.1f} s",
          flush=True)


# ---------------------------------------------------------------------------
# phase 4: ML-20M-width ratings
# ---------------------------------------------------------------------------


def _degree_targets(n, total, lo, hi):
    """n integer degrees summing to `total`, each in [lo, hi]: lo plus
    the lognormal quantiles exp(mu + sigma * z_k), z_k the normal
    quantile of (k + 1/2) / n, with mu and sigma set so that the largest
    is hi and the sum is total."""
    inv = statistics.NormalDist().inv_cdf
    z = np.array([inv((k + 0.5) / n) for k in range(n)])
    span, target = hi - lo, (total - n * lo) / n  # the lognormal part's max, mean
    low, high = 0.0, 20.0  # sigma: the mean falls as sigma grows
    for _ in range(100):
        sigma = (low + high) / 2
        if span * np.exp(sigma * (z - z[-1])).mean() > target:
            low = sigma
        else:
            high = sigma
    d = lo + span * np.exp(sigma * (z - z[-1]))
    base = np.floor(d).astype(np.int64)
    extra = total - int(base.sum())  # largest remainders take one more
    base[np.argsort(base - d)[:extra]] += 1
    return base


def _pairs_with_degrees(rng, d_user, d_item, max_rounds=500):
    """Unique (user, item) pairs, as keys user * n_items + item, in which
    user u has exactly d_user[u] items and item i exactly d_item[i]
    users: the configuration model (item stubs shuffled against user
    stubs), then each repeated pair swaps items with a random other pair
    where both new pairs are new, which keeps every degree."""
    n_users, n_items = len(d_user), len(d_item)
    u = np.repeat(np.arange(n_users, dtype=np.int64), d_user)
    it = rng.permutation(np.repeat(np.arange(n_items, dtype=np.int64), d_item))
    key = u * n_items + it
    order = np.argsort(key, kind="stable")
    sorted_key = key[order]
    same = sorted_key[1:] == sorted_key[:-1]
    repeat = np.zeros(len(key), bool)
    repeat[order[1:]] = same
    pending = np.flatnonzero(repeat)  # edges whose pair an earlier edge holds
    # the pairs held: the sorted initial set, less `removed`, plus `added`
    # (both sorted, disjoint from it and small), so that a round costs
    # O(pending) and not a rewrite of the whole set
    base = sorted_key[np.concatenate(([True], ~same))]  # np.unique(key), one sort
    added = removed = np.zeros(0, np.int64)
    del order, repeat, sorted_key, same

    def held(keys, table):
        if not len(table):
            return np.zeros(len(keys), bool)
        # the keys searched in sorted order: the same positions, found
        # along nearby paths of the table (random probes of a table of
        # tens of millions of keys miss the cache at every step)
        order = np.argsort(keys)
        pos = np.empty(len(keys), np.intp)
        pos[order] = np.searchsorted(table, keys[order])
        return table[np.minimum(pos, len(table) - 1)] == keys

    def present(keys):
        return (held(keys, base) & ~held(keys, removed)) | held(keys, added)

    def put(table, keys):  # sorted union with sorted keys not in table
        return np.insert(table, np.searchsorted(table, keys), keys)

    def drop(table, keys):  # table less keys, all in it
        return np.delete(table, np.searchsorted(table, keys))

    for rounds in range(1, max_rounds + 1):
        if not len(pending):
            return np.sort(u * n_items + it), rounds - 1
        partner = rng.integers(0, len(key), len(pending))
        p_key = u[partner] * n_items + it[partner]
        new_a = u[pending] * n_items + it[partner]  # the repeated pair's user
        new_b = u[partner] * n_items + it[pending]  # the partner's user
        ok = ~present(new_a) & ~present(new_b) & (new_a != new_b)
        # a partner must hold its pair alone and take part in one swap
        ok &= ~held(p_key, np.sort(u[pending] * n_items + it[pending]))
        _, first, count = np.unique(partner, return_index=True, return_counts=True)
        once = np.zeros(len(pending), bool)
        once[first[count == 1]] = True
        ok &= once
        new = np.concatenate([new_a[ok], new_b[ok]])
        _, inv, count = np.unique(new, return_inverse=True, return_counts=True)
        clash = (count[inv] > 1).reshape(2, -1).any(axis=0)
        idx = np.flatnonzero(ok)[~clash]
        a, b = pending[idx], partner[idx]
        gone = np.sort(p_key[idx])
        was_added = held(gone, added)
        added = drop(added, gone[was_added])
        removed = put(removed, gone[~was_added])
        new = np.sort(np.concatenate([new_a[idx], new_b[idx]]))
        was_removed = held(new, removed)
        removed = drop(removed, new[was_removed])
        added = put(added, new[~was_removed])
        it[a], it[b] = it[b], it[a].copy()
        keep = np.ones(len(pending), bool)
        keep[idx] = False
        pending = pending[keep]
    raise PhaseError(f"{len(pending)} repeated pairs left after {max_rounds} rounds")


def phase_data(report, shared):
    """ML-20M's shape from SEED: N_EDGES unique (user, item) pairs with
    ML-20M's skewed degrees, half-star ratings 0.5-5.0 drawn uniformly.

    Degrees are lognormal quantiles anchored on ML-20M's published
    counts (GroupLens ML-20M README: 138,493 users, 20,000,263 ratings,
    every user has at least 20; the most-rated movie, Pulp Fiction, has
    67,310 ratings and the most active user 9,254): users 20 + a
    lognormal part with mean 144.4 and top 9,254, items 1 + a lognormal
    part with mean 747.8 and top 67,310. Both sequences are shuffled
    over the ids, as ML-20M's ids are not in order of activity, and the
    pairs hold both exactly."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    d_user = rng.permutation(_degree_targets(N_USERS, N_EDGES, *USER_DEGREES))
    d_item = rng.permutation(_degree_targets(N_ITEMS, N_EDGES, *ITEM_DEGREES))
    keys, rounds = _pairs_with_degrees(rng, d_user, d_item)
    check(len(keys) == N_EDGES, f"{len(keys)} unique pairs drawn, not {N_EDGES}")
    rows = (keys // N_ITEMS).astype(np.int32)
    cols = (keys % N_ITEMS).astype(np.int32)
    del keys
    vals = (rng.integers(1, 11, N_EDGES) / 2.0).astype(np.float32)
    check(dense.int8_scale(vals) == 2.0, "half-star ratings must stage as int8, s=2")
    shared["coo"] = (rows, cols, vals)
    u_deg = np.bincount(rows, minlength=N_USERS)
    i_deg = np.bincount(cols, minlength=N_ITEMS)
    check(np.array_equal(u_deg, d_user) and np.array_equal(i_deg, d_item),
          "degrees differ from their targets")
    report["data"] = {
        "users": N_USERS, "items": N_ITEMS, "edges": N_EDGES,
        "user_degree": {"min": int(u_deg.min()), "median": float(np.median(u_deg)),
                        "max": int(u_deg.max())},
        "item_degree": {"min": int(i_deg.min()), "median": float(np.median(i_deg)),
                        "max": int(i_deg.max())},
        "swap_rounds": rounds, "seconds": time.perf_counter() - t0,
    }
    d = report["data"]
    print(f"[data] {N_USERS} users x {N_ITEMS} items, {N_EDGES} unique "
          f"ratings, ML-20M-skewed degrees: users min/median/max "
          f"{d['user_degree']['min']}/{d['user_degree']['median']:.0f}/"
          f"{d['user_degree']['max']}, items min/median/max "
          f"{d['item_degree']['min']}/{d['item_degree']['median']:.0f}/"
          f"{d['item_degree']['max']}; {rounds} swap rounds, "
          f"{d['seconds']:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 5: dense pass kernels vs plain versions on the card
# ---------------------------------------------------------------------------


def _within(got, want, mag, label, tally, prefix=""):
    """A kernel output against its plain version: finite, and per element
    within 1e-5 * S (S the same sums over the absolute terms); keeps the
    largest error and error / bar in `tally`."""
    check(bool(torch.isfinite(got).all()), f"{label}: not finite")
    err = (got - want).abs()
    ratio = float((err / (1e-5 * mag).clamp_min(1e-30)).max())
    check(bool((err <= 1e-5 * mag).all()),
          f"{label}: |kernel - plain| beyond 1e-5*S (ratio {ratio:.3g})")
    tally[prefix + "max_abs_err"] = max(tally[prefix + "max_abs_err"], float(err.max()))
    tally[prefix + "max_ratio"] = max(tally[prefix + "max_ratio"], ratio)


def _dense_compare(r, x, ascale, implicit, which, tally, label, prefix=""):
    fn = df.fused_row_pass if which == "row" else df.fused_col_pass
    plain = df.fused_row_pass_plain if which == "row" else df.fused_col_pass_plain
    kb, kc = fn(r, x, ascale, implicit=implicit)
    kb2, kc2 = fn(r, x, ascale, implicit=implicit)
    pb, pc = plain(r, x, ascale, implicit=implicit)
    sb, sc = plain(r, x, ascale, implicit=implicit, magnitude=True)
    torch.cuda.synchronize()
    check(torch.equal(kb, kb2) and torch.equal(kc, kc2),
          f"{label}: a second launch gave other bits")
    for got, want, mag, what in ((kb, pb, sb, "b"), (kc, pc, sc, "corr")):
        _within(got, want, mag, f"{label} {what}", tally[which])
        if prefix:
            _within(got, want, mag, f"{label} {what}", tally[which], prefix)
    tally[which]["cases"] += 1


def _small_ratings(rng, scale, n_rows=2048, n_cols=256, density=0.05):
    """Signed ratings on the scale's grid (integers, halves, tenths in
    [-5, 5], no zeros), densified on the card as int8 round(r * s)."""
    mask = rng.random((n_rows, n_cols)) < density
    rows, cols = np.nonzero(mask)
    steps = rng.integers(1, int(5 * scale) + 1, len(rows))
    vals = (steps / scale * rng.choice([-1.0, 1.0], len(rows))).astype(np.float32)
    return dense.densify(
        torch.from_numpy(rows).cuda(), torch.from_numpy(cols).cuda(),
        torch.from_numpy(vals).cuda(), n_rows_p=n_rows, n_cols_p=n_cols,
        dense_dtype="int8", scale=scale)


def phase_dense(report, shared):
    rng = np.random.default_rng(SEED + 2)
    t0 = time.perf_counter()
    tally = {w: {"cases": 0, "max_abs_err": 0.0, "max_ratio": 0.0,
                 "slab_max_abs_err": 0.0, "slab_max_ratio": 0.0}
             for w in ("row", "col")}
    for scale in (1.0, 2.0, 10.0):
        r = _small_ratings(rng, scale)
        for implicit in (True, False):
            # alpha 1.7: 1 + a*q exercises the weights' bf16 rounding
            ascale = float(np.float32(1.7 / scale if implicit else 1.0 / scale))
            for k in (1, 8, 10, 32):
                for which in ("row", "col"):
                    n_side = r.shape[1] if which == "row" else r.shape[0]
                    x = torch.from_numpy((rng.standard_normal((n_side, k))
                                          / np.sqrt(k)).astype(np.float32)).cuda()
                    _dense_compare(r, x, ascale, implicit, which, tally,
                                   f"{which} implicit={implicit} s={scale} K={k}")
    # the full ML-20M slab, as staging lays it out
    rows, cols, vals = shared["coo"]
    n_u_p = -(-N_USERS // dense.ROW_BLOCK) * dense.ROW_BLOCK
    n_i_p = -(-N_ITEMS // dense.COL_PAD) * dense.COL_PAD
    r = dense.densify(
        torch.from_numpy(rows).cuda().long(), torch.from_numpy(cols).cuda().long(),
        torch.from_numpy(vals).cuda(), n_rows_p=n_u_p, n_cols_p=n_i_p,
        dense_dtype="int8", scale=2.0)
    shared["slab"] = r
    ascale = float(np.float32(1.0 / 2.0))  # alpha 1.0 / s 2
    for which, n_side in (("row", n_i_p), ("col", n_u_p)):
        x = torch.from_numpy((rng.standard_normal((n_side, RANK))
                              / np.sqrt(RANK)).astype(np.float32)).cuda()
        _dense_compare(r, x, ascale, True, which, tally,
                       f"ML-20M slab {n_u_p}x{n_i_p} {which}", "slab_")
    # both passes at the widest rank: their outputs split over column blocks
    for which, n_side in (("row", n_i_p), ("col", n_u_p)):
        x = torch.from_numpy((rng.standard_normal((n_side, df.MAX_RANK))
                              / np.sqrt(df.MAX_RANK)).astype(np.float32)).cuda()
        _dense_compare(r, x, ascale, True, which, tally,
                       f"ML-20M slab {n_u_p}x{n_i_p} {which} K={df.MAX_RANK}",
                       "slab_")
    del x
    report["dense_sweep"] = dict(tally, seconds=time.perf_counter() - t0)
    for w in ("row", "col"):
        t = tally[w]
        print(f"[dense] {w} pass: {t['cases']} cases within 1e-5*S, second "
              f"launch bit-equal in all; max |kernel - plain| "
              f"{t['max_abs_err']:.3g}, largest |kernel - plain| / (1e-5*S) "
              f"{t['max_ratio']:.3g} (on the ML-20M slab at K = {RANK} and "
              f"{df.MAX_RANK}: {t['slab_max_ratio']:.3g})", flush=True)


# ---------------------------------------------------------------------------
# phase 6: the main path, trained
# ---------------------------------------------------------------------------


class _PlainPasses:
    """Route the dense half-step through the plain pass versions (on the
    card) for the comparison train; restores the wrappers on exit."""

    def __enter__(self):
        self.saved = (df.fused_row_pass, df.fused_col_pass)
        df.fused_row_pass = df.fused_row_pass_plain
        df.fused_col_pass = df.fused_col_pass_plain

    def __exit__(self, *exc):
        df.fused_row_pass, df.fused_col_pass = self.saved


class _Spy:
    """`owner.name` wrapped while the block runs: each call's seconds,
    positional arguments and result, in call order. Around a main-path
    run it times a step (the dense gate) and keeps what a step built (the
    staged train), so that neither runs a second time for the breakdown
    and the plain comparison."""

    def __init__(self, owner, name):
        self.owner, self.name, self.calls = owner, name, []

    def __enter__(self):
        self.fn = getattr(self.owner, self.name)

        def spy(*args, **kwargs):
            t0 = time.perf_counter()
            out = self.fn(*args, **kwargs)
            self.calls.append((time.perf_counter() - t0, args, out))
            return out

        setattr(self.owner, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.fn)


def _corr(a, b):
    return float(np.corrcoef(np.ravel(a), np.ravel(b))[0, 1])


def phase_train(report, shared):
    rows, cols, vals = shared["coo"]
    td = TrainingData(
        rows=rows, cols=cols, vals=vals, n_users=N_USERS, n_items=N_ITEMS,
        user_vocab=BiMap({f"u{n}": n for n in range(N_USERS)}),
        item_vocab=BiMap({f"i{n}": n for n in range(N_ITEMS)}),
    )
    td.sanity_check()
    params = ALSAlgorithmParams(num_iterations=TRAIN_ITERATIONS)  # template defaults
    df.PASS_LAUNCHES.update(row=0, col=0)  # every count to 0 just before the main path
    prof0 = _exec_totals("als.train_dense")
    with _Spy(als, "dense_eligible") as gate, _Spy(als, "stage_dense") as stage:
        t0 = time.perf_counter()
        model = ALSAlgorithm(params).train(RuntimeContext(), td)
        train_s = time.perf_counter() - t0
    prof1 = _exec_totals("als.train_dense")
    launches = dict(df.PASS_LAUNCHES)
    f = model.factors
    check(launches["row"] == launches["col"] == TRAIN_ITERATIONS,
          f"pass kernel launches {launches} != one row and one col pass "
          f"per iteration ({TRAIN_ITERATIONS})")
    check(f.user_factors.shape == (N_USERS, RANK)
          and f.item_factors.shape == (N_ITEMS, RANK), "factor shapes")
    check(bool(np.isfinite(f.user_factors).all()
               and np.isfinite(f.item_factors).all()), "non-finite factors")
    shared["factors"] = f
    del model

    # breakdown and the plain comparison, from the main path's staging
    [(gate_s, _, _)], [(_, _, staged)] = gate.calls, stage.calls
    del gate, stage
    check(staged.dense_dtype == "int8" and staged.static_kwargs["scale"] == 2.0,
          "staging did not pick int8, s=2")
    # the profiler's count of the main path's train: one call, and the
    # per-iteration work of obs.costs times the iterations
    kw = staged.static_kwargs
    per_iter = costs.dense_train_iteration(*staged.device_args[0].shape, kw["rank"],
                                           kw["cg_iterations"], "int8", kw["implicit"])
    d_inv, d_sec, d_flops, d_bytes = (b - a for a, b in zip(prof0, prof1))
    want_flops = per_iter.flops * TRAIN_ITERATIONS
    check(d_inv == 1 and d_sec > 0, f"als.train_dense: {d_inv} profiled calls, "
          f"{d_sec} device s in the main path's train")
    check(abs(d_flops - want_flops) <= 1e-9 * want_flops,
          f"als.train_dense flops {d_flops} != obs.costs' {per_iter.flops} an "
          f"iteration x {TRAIN_ITERATIONS}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    uf, itf = staged.factors(*staged.run())
    run_s = time.perf_counter() - t0
    prof2 = _exec_totals("als.train_dense")
    check(np.array_equal(uf, f.user_factors) and np.array_equal(itf, f.item_factors),
          "a second kernel train from the same seed gave other factors")
    with _PlainPasses():
        t0 = time.perf_counter()
        puf, pitf = staged.factors(*staged.run())
        plain_s = time.perf_counter() - t0
    host_prep_s, densify_s = staged.host_prep_sec, staged.transfer_sec
    del staged
    # the plain-pass train's factors: phase 27's second model
    shared["plain_factors"] = dataclasses.replace(f, user_factors=puf, item_factors=pitf)
    cu, ci = _corr(f.user_factors, puf), _corr(f.item_factors, pitf)
    du = float(np.abs(f.user_factors - puf).max())
    di = float(np.abs(f.item_factors - pitf).max())
    check(cu > 0.9999 and ci > 0.9999,
          f"kernel vs plain train: corrcoef users {cu}, items {ci}")
    report["train"] = {
        "iterations": TRAIN_ITERATIONS, "rank": RANK, "edges": N_EDGES,
        "main_path_s": train_s, "launches": launches, "gate_s": gate_s,
        "staging_s": host_prep_s + densify_s,
        "host_prep_s": host_prep_s, "densify_s": densify_s,
        "per_iteration_s": run_s / TRAIN_ITERATIONS,
        "plain_per_iteration_s": plain_s / TRAIN_ITERATIONS,
        "corr_users": cu, "corr_items": ci,
        "max_abs_diff_users": du, "max_abs_diff_items": di,
        "devprof": {"calls": d_inv, "device_s": d_sec, "flops": d_flops,
                    "bytes": d_bytes, "flops_per_iteration": per_iter.flops,
                    "rerun_device_s": prof2[1] - prof1[1]},
    }
    t = report["train"]
    print(f"[train] ALSAlgorithm.train at ML-20M width ({N_EDGES} ratings, rank "
          f"{RANK}, {TRAIN_ITERATIONS} iterations, int8 s=2): {train_s:.2f} s "
          f"end to end; pass kernel launches row {launches['row']} col "
          f"{launches['col']}; gate (dense_eligible) {gate_s:.2f} s, staging "
          f"{t['staging_s']:.2f} s (host prep "
          f"{t['host_prep_s']:.2f} s, copy + densify {t['densify_s']:.3f} s), "
          f"{t['per_iteration_s']:.4f} s per iteration (plain passes "
          f"{t['plain_per_iteration_s']:.4f} s); vs the plain-pass train: "
          f"corrcoef users {cu:.8f} items {ci:.8f}, max |diff| users "
          f"{du:.3g} items {di:.3g}; devprof: als.train_dense {d_sec:.4f} device s "
          f"({d_sec / train_s:.1%} of the train's wall), {d_flops:.4g} flops = obs.costs "
          f"x {TRAIN_ITERATIONS}; the rerun {prof2[1] - prof1[1]:.4f} device s against "
          f"{run_s:.4f} s host", flush=True)


# ---------------------------------------------------------------------------
# phase 7: the trained factors, served
# ---------------------------------------------------------------------------


def _queries(rng, n_users):
    qs = []
    for _ in range(N_QUERIES):
        q = {"user": f"u{int(rng.integers(n_users))}",
             "num": int(rng.choice([5, 10, 20, 50, 200]))}
        r = rng.random()
        if r < 0.2:
            q["blacklist"] = [f"i{int(x)}" for x in
                              rng.integers(0, N_ITEMS, int(rng.integers(3, 11)))]
        elif r < 0.3:
            q["whitelist"] = [f"i{int(x)}" for x in rng.integers(0, N_ITEMS, 50)]
        qs.append(q)
    return qs


def _client(port, bodies, out, lock):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        for n, body in bodies:
            t0 = time.perf_counter()
            conn.request("POST", "/queries.json", body=json.dumps(body),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            payload = resp.read()
            dt = time.perf_counter() - t0
            with lock:
                out[n] = (resp.status, json.loads(payload), dt)
    finally:
        conn.close()


def _profiled_calls(port, name):
    """A server's device-profiler invocations of `name` (its GET
    /debug/profile)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", "/debug/profile")
        rows = json.loads(conn.getresponse().read())["executables"]
    finally:
        conn.close()
    return sum(r["invocations"] for r in rows if r["name"] == name)


def _status(port):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", "/")
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def phase_serve(report, shared):
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    trained = shared["factors"]  # phase 6's ALSFactors
    blob = trained.to_bytes()  # what ``console train`` writes
    factors = convert.load_jax_als_blob(blob)  # what ``console deploy`` reads
    check(np.array_equal(factors.item_factors, trained.item_factors)
          and np.array_equal(factors.user_factors, trained.user_factors),
          "blob round trip")
    check(factors.user_vocab.to_dict() == trained.user_vocab.to_dict(),
          "blob round trip: user ids")
    setup_s = time.perf_counter() - t0
    params = ALSAlgorithmParams(rank=RANK)
    server = QueryServer(
        ALSAlgorithm(params), ALSModel(factors),
        QueryServerConfig(ip="127.0.0.1", port=0),
    )
    t0 = time.perf_counter()
    port = server.start()  # warms up: stages the slab, runs the ladder
    warm_s = time.perf_counter() - t0
    try:
        queries = _queries(rng, N_USERS)
        before = _status(port)
        out: dict = {}
        lock = threading.Lock()
        work = list(enumerate(queries))
        threads = [threading.Thread(target=_client,
                                    args=(port, work[c::N_CLIENTS], out, lock))
                   for c in range(N_CLIENTS)]
        rec.LAUNCHES = 0  # every count to 0 just before the main path
        rec.ROUTE_LAUNCHES.update(select=0, sort=0)
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = rec.LAUNCHES
        routes = dict(rec.ROUTE_LAUNCHES)
        check(not any(t.is_alive() for t in threads), "clients hung")
        after = _status(port)
        batches = after["batches"] - before["batches"]
        batch_s = (after["batch_predict_seconds"]
                   - before["batch_predict_seconds"])
    finally:
        server.stop()
    check(server._thread is None, "server thread not joined")
    check(len(out) == N_QUERIES, f"{len(out)} of {N_QUERIES} answered")
    # the plain version on the CPU from the same factors
    cpu_model = ALSModel(factors, device="cpu")
    cpu_alg = ALSAlgorithm(params)
    for n, q in enumerate(queries):
        status, body, _ = out[n]
        check(status == 200, f"query {n}: HTTP {status} {body}")
        expected = _to_jsonable(cpu_alg.predict(cpu_model, Query(**q)))
        check(body == expected, f"query {n} ({q}) differs from the CPU plain version")
        if "whitelist" not in q:
            check(len(body["item_scores"]) == q["num"], f"query {n}: length")
    lat = sorted(v[2] for v in out.values())
    check(launches > 0, "the main path launched no kernel")
    check(launches == batches,
          f"kernel launches {launches} != device batches {batches}")
    check(routes["select"] == batches,
          f"select-route launches {routes['select']} != device batches {batches}")
    report["serve"] = {
        "setup_s": setup_s, "warmup_s": warm_s, "wall_s": wall,
        "qps": N_QUERIES / wall,
        "p50_ms": 1e3 * lat[len(lat) // 2],
        "p99_ms": 1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        "batches": batches, "launches": launches, "route_launches": routes,
        "mean_batch": N_QUERIES / batches,
        "batch_predict_ms": 1e3 * batch_s / batches,
        "requests": after["requests"] - before["requests"],
    }
    s = report["serve"]
    print(f"[serve] {N_QUERIES} queries from {N_CLIENTS} clients, all equal to "
          f"the CPU plain version: p50 {s['p50_ms']:.3f} ms, p99 "
          f"{s['p99_ms']:.3f} ms, {s['qps']:.1f} qps, {batches} batches "
          f"(mean {s['mean_batch']:.2f} queries, {s['batch_predict_ms']:.3f} "
          f"ms of batch_predict each), kernel launches {launches} "
          f"({routes['select']} select route, {routes['sort']} sort route); "
          f"warmup {warm_s:.2f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 8: times
# ---------------------------------------------------------------------------


def _exec_totals(name):
    """(invocations, device s, flops, bytes) the profiler has for `name`."""
    row = devprof.get_profiler().executable(name) or {}
    return (row.get("invocations", 0), row.get("device_seconds", 0.0),
            row.get("flops_total", 0.0), row.get("bytes_total", 0.0))


@contextlib.contextmanager
def _devprof_env(flag):
    """PIO_DEVPROF set to `flag` for the block. The times phases time the
    kernels with the profiler off, as the train loops run them (nested
    calls pass through the wrapper), and once more through it."""
    old = os.environ.get("PIO_DEVPROF")
    os.environ["PIO_DEVPROF"] = flag
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("PIO_DEVPROF", None)
        else:
            os.environ["PIO_DEVPROF"] = old


def _with_devprof_ms(name, timed):
    """`timed()`'s result with the profiler on and the profiler's mean
    device ms a call of `name` over it."""
    a = _exec_totals(name)
    with _devprof_env("1"):
        out = timed()
    b = _exec_totals(name)
    calls = b[0] - a[0]
    check(calls > 0, f"{name}: no profiled call in a times phase")
    return out, 1e3 * (b[1] - a[1]) / calls


def _time_ms(fn, iters, repeats=5):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        per.append(a.elapsed_time(b) / iters)
    return statistics.median(per)


def _device_ms(fn, launches, calls=20):
    """Time on the card per call (torch.profiler), without the host's
    share of `_time_ms`: the sum, each kernel's by name, the kernels the
    profiler saw launched per call, and the sessions taken. Late in a
    long process a session now and then loses device records (none, or
    27 of 40 seen), so one that saw other than `launches` a call is taken
    again, up to five sessions; the caller holds the last one's count to
    `launches`."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for sessions in range(1, 6):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_time_total]
        if sum(e.count for e in events) == launches * calls:
            break
    per: dict = {}
    for e in events:  # the name alone: no namespace, template or parameters
        name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
        name = name.split("<")[0].split()[-1].split("::")[-1]
        per[name] = per.get(name, 0.0) + e.device_time_total / calls / 1e3
    return sum(per.values()), per, sum(e.count for e in events) / calls, sessions


def _launches_per_call(i_p, k):
    """CUDA launches in one call of either top-k selector on the card: the
    segment and row passes, or pass 1, the merge levels and the emit."""
    if rec.topk_route(k) == "select":
        return 2
    return len(rec.merge_levels(i_p, k)) + 1


def _bound(dtype, b, i_p, k, scaled):
    """The scored top-k's least time: `obs.costs.topk`'s bytes over HBM
    against its products at the slab type's peak (the scales' at f32's),
    the work the device profiler counts for the serving verbs."""
    secs, by = costs.topk(b, i_p, RANK, k, dtype, scaled).bound(HBM_BPS, PEAK_OPS)
    return 1e3 * secs, by


def phase_times(report, shared):
    rng = np.random.default_rng(SEED + 1)
    i_p = rec.pad_items(N_ITEMS)
    rows = []
    for dtype in ("f32", "bf16", "int8"):
        q64, itf, qs8, isc8 = _slab(rng, dtype)
        lib_it = itf.float() if dtype == "int8" else itf
        for b in (1, 64):
            q = q64[:b].contiguous()
            qs = None if qs8 is None else qs8[:b].contiguous()
            args = (q, itf, qs, isc8)
            lib_q = q.float() if dtype == "int8" else q
            kernel = _time_ms(
                lambda: rec.fused_recommend_topk(*args, k=128, n_items=N_ITEMS), 50)
            device, split, seen, sessions = _device_ms(
                lambda: rec.fused_recommend_topk(*args, k=128, n_items=N_ITEMS),
                _launches_per_call(i_p, 128))
            check(seen == _launches_per_call(i_p, 128),
                  f"{dtype} B={b}: the profiler saw {seen:g} launches a call, "
                  f"the {rec.topk_route(128)} route makes "
                  f"{_launches_per_call(i_p, 128)}")
            plain = _time_ms(
                lambda: rec.fused_recommend_topk_plain(
                    *args, None, None, k=128, n_items=N_ITEMS), 10)
            library = _time_ms(
                lambda: torch.topk(lib_q @ lib_it.T, 128, dim=1), 50)
            bound, by = _bound(dtype, b, i_p, 128, dtype == "int8")
            rows.append({"dtype": dtype, "B": b, "k": 128, "ms": kernel,
                         "device_ms": device, "device_split_ms": split,
                         "route": rec.topk_route(128),
                         "launches_per_call": seen, "profiler_sessions": sessions,
                         "plain_ms": plain, "library_ms": library,
                         "bound_ms": bound, "bound_by": by})
            print(f"[times] {dtype} B={b} k=128: kernel {kernel:.4f} ms "
                  f"({rec.topk_route(128)} route, {seen:g} launches per call "
                  f"in profiler session {sessions}; "
                  f"{device:.4f} ms of it on the "
                  f"card: {', '.join(f'{n} {t:.4f}' for n, t in split.items())}), "
                  f"plain {plain:.4f} ms, torch.topk(q@itf.T) {library:.4f} ms, "
                  f"bound {bound:.5f} ms ({by})", flush=True)
    report["times"] = rows


def _dense_bound(n_rows, n_cols, k, which):
    """Least time for one pass (`obs.costs.dense_pass`, the profiler's
    count): R read once, the factor input read once, both outputs (K +
    K^2 columns) written once, over HBM; or the dense-equivalent
    products at the bf16 tensor-core peak, 2*n_r*n_c*(K + K(K+1)/2)
    operations: corr is symmetric, so only its pairs i <= j need a
    product."""
    secs, by = costs.dense_pass(n_rows, n_cols, k, which).bound(HBM_BPS, PEAK_OPS)
    return 1e3 * secs, by


def _uniform_slab(like):
    """R of the main path's shape, on its device, with the same expected
    number of ratings (half-stars, stored x2) at one density everywhere:
    the load the skewed data is compared with."""
    dev = like.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    density = N_EDGES / (N_USERS * N_ITEMS)
    r = torch.zeros_like(like)
    for s in range(0, N_USERS, dense.ROW_BLOCK):
        e = min(s + dense.ROW_BLOCK, N_USERS)
        live = torch.rand((e - s, N_ITEMS), generator=gen, device=dev) < density
        q = torch.randint(1, 11, (e - s, N_ITEMS), generator=gen, device=dev,
                          dtype=torch.int8)
        r[s:e, :N_ITEMS] = q * live
    return r


def phase_dense_times(report, shared):
    with _devprof_env("0"):
        _dense_times(report, shared)


def _dense_times(report, shared):
    rng = np.random.default_rng(SEED + 3)
    r = shared.pop("slab")  # the main path's ratings
    n_rows, n_cols = r.shape
    ru = _uniform_slab(r)
    report["uniform_slab_ratings"] = int(torch.count_nonzero(ru))
    # the yardstick's storage: the same ratings as bf16 (r = q / 2, exact)
    r16 = torch.empty((n_rows, n_cols), dtype=torch.bfloat16, device=r.device)
    for s in range(0, n_rows, dense.ROW_BLOCK):
        r16[s : s + dense.ROW_BLOCK] = (r[s : s + dense.ROW_BLOCK].float() / 2.0
                                        ).to(torch.bfloat16)
    r0 = torch.zeros_like(r)
    ascale = float(np.float32(1.0 / 2.0))
    rows = []
    for which, n_side in (("row", n_cols), ("col", n_rows)):
        x = torch.from_numpy((rng.standard_normal((n_side, RANK))
                              / np.sqrt(RANK)).astype(np.float32)).cuda()
        fn = df.fused_row_pass if which == "row" else df.fused_col_pass
        plain = df.fused_row_pass_plain if which == "row" else df.fused_col_pass_plain
        lib = dense.dense_row_pass if which == "row" else dense.dense_col_pass
        kernel = _time_ms(lambda: fn(r, x, ascale, implicit=True), 5, repeats=5)
        profiled, devprof_ms = _with_devprof_ms(
            f"ops.dense_{which}_pass",
            lambda: _time_ms(lambda: fn(r, x, ascale, implicit=True), 5, repeats=5))
        uniform = _time_ms(lambda: fn(ru, x, ascale, implicit=True), 5, repeats=5)
        # the same pass over an all-zero R: every cell is multiplied all
        # the same, so it times like the others (a diagnostic, not a yardstick)
        zero = _time_ms(lambda: fn(r0, x, ascale, implicit=True), 5, repeats=5)
        plain_ms = _time_ms(lambda: plain(r, x, ascale, implicit=True), 1, repeats=3)
        library = _time_ms(lambda: lib(r16, x, implicit=True, alpha=1.0),
                           1, repeats=3)
        bound, by = _dense_bound(n_rows, n_cols, RANK, which)
        rows.append({"pass": which, "n_rows": n_rows, "n_cols": n_cols, "K": RANK,
                     "ms": kernel, "profiled_ms": profiled, "devprof_ms": devprof_ms,
                     "uniform_ms": uniform, "zero_r_ms": zero,
                     "plain_ms": plain_ms,
                     "library_ms": library,
                     "bound_ms": bound, "bound_by": by})
        print(f"[times] dense {which} pass {n_rows}x{n_cols} int8, K={RANK}: "
              f"kernel {kernel:.4f} ms (through the profiler {profiled:.4f} ms, devprof's "
              f"mean a call {devprof_ms:.4f} ms) "
              f"on the main path's skewed R (uniform R "
              f"{uniform:.4f} ms, all-zero R {zero:.4f} ms), plain "
              f"{plain_ms:.4f} ms, ops.dense "
              f"two-matmul on bf16 R {library:.4f} ms, bound {bound:.4f} ms "
              f"({by})", flush=True)
    # both passes at the widest rank: eight column blocks, R read by each
    k = df.MAX_RANK
    wide_rows = []
    for which, n_side in (("row", n_cols), ("col", n_rows)):
        x = torch.from_numpy((rng.standard_normal((n_side, k))
                              / np.sqrt(k)).astype(np.float32)).cuda()
        fn = df.fused_row_pass if which == "row" else df.fused_col_pass
        plain = df.fused_row_pass_plain if which == "row" else df.fused_col_pass_plain
        lib = dense.dense_row_pass if which == "row" else dense.dense_col_pass
        wide = {name: _time_ms(lambda: fn(rr, x, ascale, implicit=True), 3, repeats=3)
                for name, rr in (("ms", r), ("uniform_ms", ru), ("zero_r_ms", r0))}
        plain_ms = _time_ms(lambda: plain(r, x, ascale, implicit=True), 1, repeats=1)
        library = _time_ms(lambda: lib(r16, x, implicit=True, alpha=1.0), 1, repeats=1)
        bound, by = _dense_bound(n_rows, n_cols, k, which)
        wide_rows.append({
            "pass": which, **wide, "K": k, "n_rows": n_rows, "n_cols": n_cols,
            "column_blocks": df.operand_column_blocks(k), "plain_ms": plain_ms,
            "library_ms": library, "bound_ms": bound, "bound_by": by})
        print(f"[times] dense {which} pass {n_rows}x{n_cols} int8, K={k} "
              f"({df.operand_column_blocks(k)} column blocks): kernel {wide['ms']:.4f} ms "
              f"on the skewed R (uniform R {wide['uniform_ms']:.4f} ms, all-zero R "
              f"{wide['zero_r_ms']:.4f} ms), plain {plain_ms:.4f} ms, ops.dense "
              f"two-matmul on bf16 R {library:.4f} ms, bound {bound:.4f} ms ({by})",
              flush=True)
    report["dense_times_wide"] = wide_rows
    del r16, r, r0, ru, x
    report["dense_times"] = rows
    shared.pop("coo")  # the ML-20M ratings are done with
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 9: the storage-backed loop, app new -> import -> train -> deploy
# ---------------------------------------------------------------------------


def _ratings_data(rng, n_users, n_items, n_edges, user_degrees, item_degrees, t0_ms):
    """`n_edges` unique (user, item) pairs whose degrees are lognormal
    quantiles anchored on a MovieLens set's published counts (fewest and
    most ratings of a user and of an item), shuffled over the ids;
    integer ratings 1-5; distinct event times a second apart from
    `t0_ms`, in a random order."""
    d_user = rng.permutation(_degree_targets(n_users, n_edges, *user_degrees))
    d_item = rng.permutation(_degree_targets(n_items, n_edges, *item_degrees))
    keys, _ = _pairs_with_degrees(rng, d_user, d_item)
    check(len(keys) == n_edges, f"{len(keys)} unique pairs drawn, not {n_edges}")
    users = (keys // n_items).astype(np.int64)
    items = (keys % n_items).astype(np.int64)
    ratings = rng.integers(1, 6, n_edges)
    times = t0_ms + 1000 * rng.permutation(n_edges).astype(np.int64)
    return users, items, ratings, times


def _loop_data(rng):
    """ML-1M's shape (GroupLens ML-1M README: 6,040 users, 3,706 rated
    movies, 1,000,209 ratings, every user with at least 20; the most
    active user has 2,314 ratings and the most rated movie 3,428)."""
    return _ratings_data(rng, LOOP_USERS, LOOP_ITEMS, LOOP_EDGES, LOOP_USER_DEGREES,
                         LOOP_ITEM_DEGREES, LOOP_T0_MS)


def _write_events(path, users, items, ratings, times):
    """The ratings as `pio import` JSON lines, in a shuffled order."""
    stamps = np.datetime_as_string(times.astype("datetime64[ms]"), unit="ms")
    with open(path, "w") as f:
        for n in np.random.default_rng(LOOP_SEED + 1).permutation(len(users)):
            f.write(
                f'{{"event":"rate","entityType":"user","entityId":"u{users[n]}",'
                f'"targetEntityType":"item","targetEntityId":"i{items[n]}",'
                f'"properties":{{"rating":{ratings[n]}}},"eventTime":"{stamps[n]}Z"}}\n'
            )


def _ids(vocab, prefix):
    """A vocabulary of ids prefix + n as an array: index → n."""
    out = np.empty(len(vocab), np.int64)
    for key, idx in vocab.items():
        out[idx] = int(key[len(prefix):])
    return out


def _loop_queries(rng, n_users=LOOP_USERS, n_items=LOOP_ITEMS, unknown=LOOP_UNKNOWN_USERS):
    """N_QUERIES for known users (20 % with blacklists, 10 % with
    whitelists), then `unknown` for users with no events."""
    qs = []
    for _ in range(N_QUERIES):
        q = {"user": f"u{int(rng.integers(n_users))}",
             "num": int(rng.choice([5, 10, 20, 50, 200]))}
        r = rng.random()
        if r < 0.2:
            q["blacklist"] = [f"i{int(x)}" for x in
                              rng.integers(0, n_items, int(rng.integers(3, 11)))]
        elif r < 0.3:
            q["whitelist"] = [f"i{int(x)}" for x in rng.integers(0, n_items, 50)]
        qs.append(q)
    return qs + [{"user": f"u{n_users + n}", "num": 10} for n in range(unknown)]


class _Console:
    """A console command that serves (`deploy`, `eventserver`) in a
    process of its own, as an operator starts it; stopped (and killed if
    it must be) on exit."""

    BANNER = re.compile(r"(?:^serving .* on |Event Server is listening at http://"
                        r"|Dashboard is listening at http://"
                        r"|Storage server is listening at http://)[^\s:]+:(\d+)")

    def __init__(self, args, log_path, env=None):
        self.log = open(log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.tools.console", *args],
            cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
            stderr=self.log, text=True, env=env,
        )
        self.lines: queue.Queue = queue.Queue()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.put(line)

    def port(self, timeout):
        """The port from the serving banner, once the server is up."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                line = self.lines.get(timeout=1.0)
            except queue.Empty:
                check(self.proc.poll() is None,
                      f"{self.proc.args[3]} exited with {self.proc.returncode}; "
                      f"see {self.log.name}")
                continue
            m = self.BANNER.search(line)
            if m:
                return int(m.group(1))
        raise PhaseError(f"{self.proc.args[3]} not serving after {timeout} s; "
                         f"see {self.log.name}")

    def interrupt(self, timeout=30.0):
        """Ctrl-C, as an operator stops it; returns its exit code."""
        self.proc.send_signal(signal.SIGINT)
        try:
            return self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            raise PhaseError(f"{self.proc.args[3]} did not stop within {timeout} s "
                             f"of SIGINT; see {self.log.name}") from None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=30)
        self.log.close()


def _store_env(store):
    """sqlite events and metadata and model files under `store`, as
    PIO_FS_BASEDIR and the PIO_STORAGE_* variables name them."""
    return {"PIO_FS_BASEDIR": str(store),
            "PIO_STORAGE_SOURCES_LOOPDB_TYPE": "sqlite",
            "PIO_STORAGE_SOURCES_LOOPDB_PATH": str(store / "pio.db"),
            "PIO_STORAGE_SOURCES_LOOPFS_TYPE": "localfs",
            "PIO_STORAGE_SOURCES_LOOPFS_PATH": str(store),
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "LOOPDB",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "LOOPDB",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "LOOPFS"}


class _loop_storage:
    """The loop's storage under ``build/loop/store`` (sqlite events and
    metadata, model files), or under `store`, named by PIO_FS_BASEDIR and
    the PIO_STORAGE_* variables while the block runs; or the variables
    `env` while it runs."""

    def __init__(self, store=None, env=None):
        self.store = LOOP_DIR / "store" if store is None else store
        self.env = env

    def __enter__(self):
        env = self.env if self.env is not None else _store_env(self.store)
        self.saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_loop(report, shared):
    """The zero-to-aha loop at ML-1M's width: `console app new`, `import`
    and `train --engine-json` in this process, then `deploy
    --engine-json` in its own process on the card, and 500 queries."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(LOOP_SEED)
    t0 = time.perf_counter()
    users, items, ratings, times = _loop_data(rng)
    shutil.rmtree(LOOP_DIR, ignore_errors=True)
    LOOP_DIR.mkdir(parents=True)
    events_path = LOOP_DIR / "events.jsonl"
    _write_events(events_path, users, items, ratings, times)
    data_s = time.perf_counter() - t0
    (LOOP_DIR / "store").mkdir()
    with _loop_storage():
        factors = _loop_run(report, users, items, ratings, events_path, data_s)
    shared["loop"] = (users, items, ratings)  # the lifecycle phase's base
    shared["loop_times"], shared["loop_factors"] = times, factors  # the segments phase's
    report["loop"]["phase_s"] = time.perf_counter() - t_phase
    loop = report["loop"]
    smi = report["nvidia_smi"]
    print(f"[loop] {smi} | ML-1M-shaped {LOOP_EDGES} ratings: import "
          f"{loop['import_s']:.2f} s, read {loop['stages']['read']:.2f} s, prepare "
          f"{loop['stages']['prepare']:.4f} s, train {loop['stages']['train']:.2f} s, "
          f"persist {loop['stages']['persist']:.4f} s", flush=True)
    print(f"[loop] {smi} | deploy to ready {loop['deploy_ready_s']:.2f} s; "
          f"{N_QUERIES} queries from {N_CLIENTS} clients: p50 {loop['p50_ms']:.3f} ms, "
          f"p99 {loop['p99_ms']:.3f} ms, {loop['qps']:.1f} qps; phase "
          f"{loop['phase_s']:.1f} s", flush=True)


def _loop_run(report, users, items, ratings, events_path, data_s):
    check(console.main(["app", "new", LOOP_APP]) == 0, "app new")
    t0 = time.perf_counter()
    check(console.main(["import", "--app", LOOP_APP, "--input", str(events_path)]) == 0,
          "import")
    import_s = time.perf_counter() - t0
    engine_json = LOOP_DIR / "engine.json"
    engine_json.write_text(json.dumps({
        "id": "ml1m-als",
        "engineFactory": "predictionio_tpu_torch.engines.recommendation.RecommendationEngine",
        "datasource": {"params": {"app_name": LOOP_APP, "event_names": ["rate"]}},
        "algorithms": [{"name": "als", "params": {}}],  # the template's defaults
    }))
    frames = []
    frame_of = RecommendationDataSource._frame

    def kept_frame(self, ctx):
        frames.append(frame_of(self, ctx))
        return frames[-1]

    RecommendationDataSource._frame = kept_frame
    df.PASS_LAUNCHES.update(row=0, col=0)  # every count to 0 just before the main path
    try:
        with _Spy(als, "stage_dense") as stage:
            t0 = time.perf_counter()
            rc = console.main(["train", "--engine-json", str(engine_json)])
            train_wall_s = time.perf_counter() - t0
    finally:
        RecommendationDataSource._frame = frame_of
    launches = dict(df.PASS_LAUNCHES)
    check(rc == 0, "train --engine-json")
    storage = Storage()
    [inst] = storage.get_meta_data_engine_instances().get_all()
    check(inst.status == "COMPLETED", f"instance {inst.status}")
    stages = stage_timings(inst)
    params = ALSAlgorithmParams()
    check(launches["row"] == launches["col"] == params.num_iterations,
          f"pass kernel launches {launches} != one row and one col pass per "
          f"iteration ({params.num_iterations})")
    staged = [out for *_, out in stage.calls]
    check(len(staged) == 1, f"the train staged a dense train {len(staged)} times")
    staged_dtype = staged[0].dense_dtype
    del stage, staged
    [model] = deserialize_models(storage.get_model_data_models().get(inst.id).models)
    check(type(model) is ALSModel, f"MODELDATA holds {type(model).__name__}")
    f = model.factors
    check(f.user_factors.shape == (LOOP_USERS, RANK)
          and f.item_factors.shape == (LOOP_ITEMS, RANK), "factor shapes")
    check(bool(np.isfinite(f.user_factors).all() and np.isfinite(f.item_factors).all()),
          "non-finite factors")

    # the frame read back holds exactly the generated triples
    [frame] = frames
    check(len(frame) == LOOP_EDGES, f"{len(frame)} events read back")
    uid, iid = _ids(frame.entity_vocab, "u"), _ids(frame.target_vocab, "i")
    key = uid[frame.entity_idx] * LOOP_ITEMS + iid[frame.target_idx]
    order, want = np.argsort(key), np.argsort(users * LOOP_ITEMS + items)
    check(np.array_equal(key[order], (users * LOOP_ITEMS + items)[want])
          and np.array_equal(frame.value[order], ratings[want].astype(np.float32)),
          "the frame read back differs from the generated (user, item, rating) triples")
    del frames, frame

    # a direct ALSAlgorithm.train on the generated arrays, in the same
    # vocabularies, on the card
    urow = np.empty(LOOP_USERS, np.int64)
    urow[uid] = np.arange(len(uid))
    irow = np.empty(LOOP_ITEMS, np.int64)
    irow[iid] = np.arange(len(iid))
    td = TrainingData(rows=urow[users].astype(np.int32), cols=irow[items].astype(np.int32),
                      vals=ratings.astype(np.float32), n_users=LOOP_USERS,
                      n_items=LOOP_ITEMS, user_vocab=f.user_vocab, item_vocab=f.item_vocab)
    direct = ALSAlgorithm(params).train(RuntimeContext(), td).factors
    cu = _corr(f.user_factors, direct.user_factors)
    ci = _corr(f.item_factors, direct.item_factors)
    diff = max(float(np.abs(f.user_factors - direct.user_factors).max()),
               float(np.abs(f.item_factors - direct.item_factors).max()))
    check(cu > 0.9999 and ci > 0.9999,
          f"the loop's factors vs a direct train: corrcoef users {cu}, items {ci}")
    del direct, td

    # deploy in its own process, then 500 queries from 16 threads and,
    # one at a time, the unknown users' (a batch with no known user makes
    # no device call, so they go alone, after the launch count is read)
    rng = np.random.default_rng(LOOP_SEED + 2)
    queries = _loop_queries(rng)
    t0 = time.perf_counter()
    with _Console(["deploy", "--engine-json", str(engine_json), "--ip", "127.0.0.1",
                   "--port", "0"], LOOP_DIR / "deploy.log") as dep:
        port = dep.port(timeout=300)
        before = _status(port)
        ready_s = time.perf_counter() - t0
        out: dict = {}
        lock = threading.Lock()
        work = list(enumerate(queries[:N_QUERIES]))
        threads = [threading.Thread(target=_client, args=(port, work[c::N_CLIENTS], out, lock))
                   for c in range(N_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads), "clients hung")
        after = _status(port)
        _client(port, list(enumerate(queries))[N_QUERIES:], out, lock)
        last = _status(port)
    check(dep.proc.returncode is not None, "deploy still running")
    check(before["engine_instance"] == inst.id, "deploy serves another instance")
    check(after["device"] == "cuda:0", f"deploy serves on {after['device']}")
    check(len(out) == len(queries), f"{len(out)} of {len(queries)} answered")
    batches = after["batches"] - before["batches"]
    served_launches = after["kernel_launches"] - before["kernel_launches"]
    check(batches > 0 and served_launches == batches,
          f"deploy kernel launches {served_launches} != its batches {batches}")
    check(last["kernel_launches"] == after["kernel_launches"]
          and last["batches"] - after["batches"] == LOOP_UNKNOWN_USERS,
          "an unknown user's query launched a kernel")
    # the plain top-k on the CPU over the blob's factors
    model.bind_device("cpu")
    cpu_alg = ALSAlgorithm(params)
    for n, q in enumerate(queries):
        status, body, _ = out[n]
        check(status == 200, f"query {n}: HTTP {status} {body}")
        expected = _to_jsonable(cpu_alg.predict(model, Query(**q)))
        check(body == expected, f"query {n} ({q}) differs from the CPU plain top-k")
    lat = sorted(out[n][2] for n in range(N_QUERIES))
    report["loop"] = {
        "users": LOOP_USERS, "items": LOOP_ITEMS, "events": LOOP_EDGES,
        "data_s": data_s, "import_s": import_s, "train_wall_s": train_wall_s,
        "stages": stages, "staging": "StagedDenseTrain", "dense_dtype": staged_dtype,
        "launches": {**launches, "serve_topk": served_launches},
        "corr_users": cu, "corr_items": ci, "max_abs_diff_direct": diff,
        "deploy_ready_s": ready_s,
        "wall_s": wall, "qps": N_QUERIES / wall,
        "p50_ms": 1e3 * lat[len(lat) // 2],
        "p99_ms": 1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        "batches": batches, "mean_batch": N_QUERIES / batches,
        "batch_predict_ms": 1e3 * (after["batch_predict_seconds"]
                                   - before["batch_predict_seconds"]) / batches,
        "nvidia_smi": report["nvidia_smi"],
    }
    return f


# ---------------------------------------------------------------------------
# phase 9b: the loop over segmentfs events and docfs metadata
# ---------------------------------------------------------------------------


SEGMENTS_DIR = Path(__file__).resolve().parent / "build" / "segments"
SEGMENTS_SEED = 24
SEGMENTS_APP = "ml1m-seg"
SEGMENTS_ENGINE = "ml1m-seg-als"
SEGMENTS_TAIL = 20_000  # (c): new ratings inserted in process after the train
SEGMENTS_POSTED = 20_000  # (d): new ratings POSTed to the Event Server
SEGMENTS_WRITERS = 4
SEGMENTS_BATCH = 50  # the Event Server's batch limit
SEGMENTS_KILL_AT = 1 / 3  # the share of (d)'s batches acknowledged before the SIGKILL
SEGMENTS_PAGE = 100_000  # find_since's page in (d)'s read-back
SEGMENTS_ROW_SHARDS = 4  # (b): the row path is held on one of these entity partitions


def _segments_env(sealer_s="0.25"):
    """segmentfs events (the JAX defaults: SEAL_EVENTS 8192, FSYNC 1;
    the sealer's poll `sealer_s`), docfs metadata and localfs models
    under SEGMENTS_DIR: a storage with no sqlite file."""
    base = {"PIO_FS_BASEDIR": str(SEGMENTS_DIR)}
    for name, kind, sub in (("SEGEV", "segmentfs", "events"), ("SEGMETA", "docfs", "meta"),
                            ("SEGFS", "localfs", "models")):
        base[f"PIO_STORAGE_SOURCES_{name}_TYPE"] = kind
        base[f"PIO_STORAGE_SOURCES_{name}_PATH"] = str(SEGMENTS_DIR / sub)
    base.update({"PIO_STORAGE_SOURCES_SEGEV_SEAL_EVENTS": "8192",
                 "PIO_STORAGE_SOURCES_SEGEV_FSYNC": "1",
                 "PIO_STORAGE_SOURCES_SEGEV_SEAL_INTERVAL_S": str(sealer_s),
                 "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SEGMETA",
                 "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SEGEV",
                 "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "SEGFS"})
    return base


class _SegmentStores:
    """Every segmentfs store this process opens while the block runs, in
    `opened`: one writer process a PATH, so the phase closes each (its
    sealer stopped, its tail sealed, the writer lock released) before a
    child opens the PATH, and none is left polling in later phases."""

    def __enter__(self):
        self.opened, self.init = [], segmentfs.SegmentFSEventStore.__init__
        opened, init = self.opened, self.init

        def recording(store, *args, **kwargs):
            init(store, *args, **kwargs)
            opened.append(store)

        segmentfs.SegmentFSEventStore.__init__ = recording
        return self

    def close(self):
        while self.opened:
            self.opened.pop().close()

    def __exit__(self, *exc):
        segmentfs.SegmentFSEventStore.__init__ = self.init
        self.close()


def _segments_ratings(rng, users, items, times):
    """SEGMENTS_TAIL + SEGMENTS_POSTED new (user, item) pairs of the
    loop's users and items, integer ratings 1-5, distinct times after the
    loop's last."""
    n = SEGMENTS_TAIL + SEGMENTS_POSTED
    have = users * LOOP_ITEMS + items
    draw = np.unique(rng.integers(0, LOOP_USERS * LOOP_ITEMS, 3 * n))
    draw = rng.permutation(draw[~np.isin(draw, have)])[:n]
    check(len(draw) == n, f"{len(draw)} new pairs drawn, not {n}")
    t = int(times.max()) + 1000 * (1 + np.arange(n, dtype=np.int64))
    return draw // LOOP_ITEMS, draw % LOOP_ITEMS, rng.integers(1, 6, n), t


def _same_frame(a, b):
    """Two EventFrames bit for bit: columns, dtypes, vocabularies, types."""
    cols = ("event_code", "entity_idx", "target_idx", "time_ms", "value")
    return (all(getattr(a, c).dtype == getattr(b, c).dtype
                and getattr(a, c).tobytes() == getattr(b, c).tobytes() for c in cols)
            and all(getattr(a, v).to_dict() == getattr(b, v).to_dict()
                    for v in ("event_vocab", "entity_vocab", "target_vocab"))
            and (a.entity_type, a.target_entity_type) == (b.entity_type, b.target_entity_type))


def _frame_rows_equal(frame, users, items, ratings, times):
    """The frame holds exactly the (user, item, rating, time) rows given,
    compared sorted as the loop compares its read-back."""
    uid, iid = _ids(frame.entity_vocab, "u"), _ids(frame.target_vocab, "i")
    key = uid[frame.entity_idx] * LOOP_ITEMS + iid[frame.target_idx]
    got, want = np.argsort(key), np.argsort(users * LOOP_ITEMS + items)
    return (len(frame) == len(users)
            and np.array_equal(key[got], (users * LOOP_ITEMS + items)[want])
            and np.array_equal(frame.value[got], ratings[want].astype(np.float32))
            and np.array_equal(frame.time_ms[got], times[want]))


def _aligned_corr(f, g):
    """corrcoef of two ALS factor sets over the same ids, row for row by
    their vocabularies."""
    out = []
    for fx, gx, fv, gv in ((f.user_factors, g.user_factors, f.user_vocab, g.user_vocab),
                           (f.item_factors, g.item_factors, f.item_vocab, g.item_vocab)):
        fmap = fv.to_dict()
        rows = np.asarray([gv(k) for k in sorted(fmap, key=fmap.get)])
        out.append(_corr(fx, gx[rows]))
    return out


def _staged_equal(staged, frame, label):
    torch.cuda.synchronize()
    for name in ("entity_idx", "target_idx", "value"):
        t = staged[name]
        check(t.device.type == "cuda", f"{label}: {name} staged on {t.device}")
        check(t.cpu().numpy().tobytes() == np.asarray(getattr(frame, name)).tobytes(),
              f"{label}: staged {name} differs from the frame's column")
    check(float(staged["valid"].sum()) == len(frame), f"{label}: valid mask")


def phase_segments(report, shared):
    """The loop's ML-1M events over segmentfs events, docfs metadata and
    localfs models under build/segments/: import, train through the data
    view's segment branch, a tail in process with the stager on the card,
    the Event Server SIGKILLed mid-ingest, deploy and 500 queries."""
    t_phase = time.perf_counter()
    users, items, ratings = shared["loop"]
    times = shared["loop_times"]
    check((LOOP_DIR / "events.jsonl").exists(), "the loop's events.jsonl is missing")
    new = _segments_ratings(np.random.default_rng(SEGMENTS_SEED), users, items, times)
    shutil.rmtree(SEGMENTS_DIR, ignore_errors=True)
    SEGMENTS_DIR.mkdir(parents=True)
    seg = report["segments"] = {"nvidia_smi": report["nvidia_smi"]}
    with _SegmentStores() as stores:
        with _loop_storage(env=_segments_env()):
            app_id, key = _segments_import(seg, stores)
        # (b)-(c) in this process: the sealer's poll stretched so that
        # (c)'s tail stays a tail through the retrain and the stager
        with _loop_storage(env=_segments_env(sealer_s=3600)):
            run = _segments_train(seg, stores, app_id, (users, items, ratings, times),
                                  shared["loop_factors"])
            _segments_tail(seg, stores, app_id, run, [a[:SEGMENTS_TAIL] for a in new],
                           (users, items, ratings, times))
        with _loop_storage(env=_segments_env()):
            handoff = _segments_event_server(seg, stores, app_id, key,
                                             [a[SEGMENTS_TAIL:] for a in new])
            served = _deploy_queries(run["engine_json"], SEGMENTS_DIR / "deploy.log",
                                     run["retrain"], run["model"], ALSAlgorithmParams(),
                                     np.random.default_rng(SEGMENTS_SEED + 2),
                                     LOOP_USERS, LOOP_ITEMS)
    shared["segments"] = {**handoff, "app_id": app_id, "query": run["query"],
                          "instance": run["retrain"].id}
    seg["launches"]["serve_topk"] = served.pop("served")
    seg["launches"]["serve_select"] = served.pop("select")
    seg.update(served)
    seg["phase_s"] = time.perf_counter() - t_phase
    smi = report["nvidia_smi"]
    print(f"[segments] {smi} | import of {LOOP_EDGES} events {seg['import_s']:.2f} s "
          f"({LOOP_EDGES / seg['import_s']:.1f} events/s), sealed by the sealer "
          f"{seg['seal_wait_s']:.2f} s later; {seg['status_line']}", flush=True)
    print(f"[segments] {smi} | train: read {seg['stages']['read']:.3f} s (data view "
          f"miss), train {seg['stages']['train']:.3f} s, row path of partition 0 of "
          f"{SEGMENTS_ROW_SHARDS} {seg['row_path_s']:.2f} s; retrain after {SEGMENTS_TAIL} tail events: read "
          f"{seg['retrain_stages']['read']:.3f} s (hit), train "
          f"{seg['retrain_stages']['train']:.3f} s; cold read "
          f"{seg['cold_read_s']:.3f} s; launches row {seg['launches']['row']}, col "
          f"{seg['launches']['col']}; corrcoef vs the loop users "
          f"{seg['corr_users']:.8f} items {seg['corr_items']:.8f}", flush=True)
    print(f"[segments] {smi} | stager on cuda:0: {seg['stager'][0]} in "
          f"{seg['stage_s'][0]:.3f} s, then {seg['stager'][1]} in "
          f"{seg['stage_s'][1]:.3f} s", flush=True)
    es = seg["event_server"]
    print(f"[segments] {smi} | Event Server: {SEGMENTS_POSTED} events from "
          f"{SEGMENTS_WRITERS} writers, SIGKILLed after {es['acked_before_kill']} of "
          f"{es['batches']} batches, restarted in {es['restart_s']:.2f} s, "
          f"{es['resent']} batches resent; seal {es['seal']}, compact {es['compact']}, "
          f"stats {es['stats']}; find_since read {es['find_since_events']} events in "
          f"{es['find_since_s']:.2f} s, each revision once", flush=True)
    print(f"[segments] {smi} | deploy to ready {seg['deploy_ready_s']:.2f} s; "
          f"{N_QUERIES} queries from {N_CLIENTS} clients: p50 {seg['p50_ms']:.3f} ms, "
          f"p99 {seg['p99_ms']:.3f} ms, {seg['qps']:.1f} qps, top-k launches "
          f"{seg['launches']['serve_topk']} in {seg['batches']} batches (select "
          f"{seg['launches']['serve_select']}); phase {seg['phase_s']:.1f} s", flush=True)


def _segments_import(seg, stores):
    """(a) `app new` and `import` of the loop's file in this process, the
    sealer left to seal the import's tail, then `status`."""
    rc, text = _console_out(["app", "new", SEGMENTS_APP])
    m = re.search(r"App created: ID=(\d+).*\n\[INFO\] Access key: (\S+)", text)
    check(rc == 0 and m is not None, "app new printed no app id and access key")
    app_id, key = int(m.group(1)), m.group(2)
    stores.close()
    t0 = time.perf_counter()
    check(console.main(["import", "--app", SEGMENTS_APP, "--input",
                        str(LOOP_DIR / "events.jsonl")]) == 0, "import")
    seg["import_s"] = time.perf_counter() - t0
    [store] = stores.opened
    t0 = time.perf_counter()
    while store.segment_stats(app_id)["tail_rows"]:
        check(time.perf_counter() - t0 < 300, "the sealer left the import's tail unsealed")
        time.sleep(0.05)
    seg["seal_wait_s"] = time.perf_counter() - t0
    seg["after_import"] = store.segment_stats(app_id)
    stores.close()
    rc, text = _console_out(["status"])
    stores.close()
    line = re.search(rf"\[INFO\]   segmentfs app {app_id} \({SEGMENTS_APP}\): (\d+) "
                     r"segment\(s\), (\d+) sealed \+ (\d+) tail row\(s\), (\d+) dead, "
                     r"rev (\d+)", text)
    check(rc == 0 and line is not None, "status printed no segmentfs line for the app")
    n_seg, sealed, tail, dead, rev = map(int, line.groups())
    check(n_seg >= 1 and sealed + tail == LOOP_EDGES and dead == 0 and rev == LOOP_EDGES,
          f"status: {line.group(0)} (rows lost, or none sealed)")
    seg["status_line"] = line.group(0).strip()
    return app_id, key


def _segments_train(seg, stores, app_id, loop_rows, loop_factors):
    """(b) `train --engine-json` (the loop's params, reading through the
    data view) in this process; its store is kept open for (c)."""
    engine_json = SEGMENTS_DIR / "engine.json"
    variant = {
        "id": SEGMENTS_ENGINE,
        "engineFactory": "predictionio_tpu_torch.engines.recommendation.RecommendationEngine",
        "datasource": {"params": {"app_name": SEGMENTS_APP, "event_names": ["rate"],
                                  "use_data_view": True}},
        "algorithms": [{"name": "als", "params": {}}],  # the template's defaults
    }
    engine_json.write_text(json.dumps(variant))
    frames = []
    frame_of = RecommendationDataSource._frame

    def kept_frame(self, ctx):
        frames.append(frame_of(self, ctx))
        return frames[-1]

    RecommendationDataSource._frame = kept_frame
    DataView.stats.update(hits=0, misses=0)
    df.PASS_LAUNCHES.update(row=0, col=0)  # every count to 0 just before the main path
    try:
        with _Spy(als, "stage_dense") as stage, _Spy(wcore, "run_train") as run:
            rc = console.main(["train", "--engine-json", str(engine_json)])
    finally:
        RecommendationDataSource._frame = frame_of
    launches = dict(df.PASS_LAUNCHES)
    check(rc == 0, "train --engine-json")
    [(_, (storage, *_), inst)] = run.calls
    [store] = stores.opened
    check(storage.get_events() is store, "the train read another store")
    check(inst.status == "COMPLETED", f"instance {inst.status}")
    check(DataView.stats == {"hits": 0, "misses": 1}
          and store.frame_cache_stats == {"hits": 0, "misses": 1},
          f"data view {DataView.stats}, store cache {store.frame_cache_stats}: not one miss")
    check(not (SEGMENTS_DIR / "view").exists(), "the data view wrote npz files")
    params = ALSAlgorithmParams()
    check(launches["row"] == launches["col"] == params.num_iterations,
          f"pass kernel launches {launches} != one row and one col pass per iteration")
    staged = [out for *_, out in stage.calls]
    check(len(staged) == 1, f"the train staged a dense train {len(staged)} times")
    [frame] = frames
    # the columnar read is the row path's, bit for bit, on one of
    # SEGMENTS_ROW_SHARDS partitions (sealed segments and the tail alike)
    q = EventQuery(app_id=app_id, entity_type="user", target_entity_type="item",
                   event_names=["rate"])
    q_part = dataclasses.replace(q, shard=(0, SEGMENTS_ROW_SHARDS))
    t0 = time.perf_counter()
    ref = EventFrame.from_events(store.find(q_part), value_prop="rating", default_value=1.0)
    seg["row_path_s"] = time.perf_counter() - t0
    part = store.find_frame(q_part, value_prop="rating", default_value=1.0)
    check(len(ref) > 0 and _same_frame(part, ref),
          "the columnar frame of partition 0 differs from from_events(find(q))")
    del ref, part
    check(_frame_rows_equal(frame, *loop_rows),
          "the frame differs from the generated (user, item, rating, time) rows")
    [model] = deserialize_models(storage.get_model_data_models().get(inst.id).models)
    check(type(model) is ALSModel, f"MODELDATA holds {type(model).__name__}")
    check(_finite(model.factors), "non-finite factors")
    cu, ci = _aligned_corr(model.factors, loop_factors)
    check(cu > 0.9999 and ci > 0.9999,
          f"the factors vs the loop's (sqlite) train: corrcoef users {cu}, items {ci}")
    held = {w: {"cases": 0, "max_abs_err": 0.0, "max_ratio": 0.0} for w in ("row", "col")}
    _dense_held(staged[0], RANK, np.random.default_rng(SEGMENTS_SEED + 1), held,
                "segments ML-1M")
    seg.update({"stages": stage_timings(inst), "launches": launches, "held": held,
                "dense_dtype": staged[0].dense_dtype, "corr_users": cu, "corr_items": ci})
    return {"storage": storage, "store": store, "variant": variant, "query": q,
            "engine_json": engine_json, "frame": frame}


def _segments_tail(seg, stores, app_id, run, new, loop_rows):
    """(c) In process, against the train's store: the stager on cuda:0,
    a tail of SEGMENTS_TAIL new ratings, the retrain (a data view hit),
    the stager again (only the tail copied), then the store closed and a
    cold read by a fresh store."""
    storage, store, q = run["storage"], run["store"], run["query"]
    stager = SegmentStager("cuda:0")
    stats, stage_s = [], []
    t0 = time.perf_counter()
    frame1, staged1 = stager.stage(store, q, value_prop="rating", default_value=1.0)
    torch.cuda.synchronize()
    stage_s.append(time.perf_counter() - t0)
    stats.append(dict(stager.stats))
    check(stats[0] == {"sealed_restage": 1, "sealed_reuse": 0,
                       "bytes_staged": 12 * LOOP_EDGES}, f"the first stage: {stats[0]}")
    _staged_equal(staged1, frame1, "stage 1")
    users, items, ratings, times = new
    stamps = times.astype("datetime64[ms]").astype(object)
    tail = [Event(event="rate", entity_type="user", entity_id=f"u{u}",
                  target_entity_type="item", target_entity_id=f"i{i}",
                  properties={"rating": int(r)},
                  event_time=t.replace(tzinfo=datetime.timezone.utc),
                  event_id=f"tail-{n:05d}")
            for n, (u, i, r, t) in enumerate(zip(users.tolist(), items.tolist(),
                                                 ratings.tolist(), stamps))]
    t0 = time.perf_counter()
    check(len(store.insert_batch(tail, app_id)) == SEGMENTS_TAIL, "tail insert")
    seg["tail_insert_s"] = time.perf_counter() - t0
    check(store.segment_stats(app_id)["tail_rows"] == SEGMENTS_TAIL, "the tail was sealed")
    # the retrain: in process, the same storage and store
    frames = []
    frame_of = RecommendationDataSource._frame

    def kept_frame(self, ctx):
        frames.append(frame_of(self, ctx))
        return frames[-1]

    hits = (DataView.stats["hits"], store.frame_cache_stats["hits"])
    RecommendationDataSource._frame = kept_frame
    df.PASS_LAUNCHES.update(row=0, col=0)  # every count to 0 just before the main path
    try:
        inst = wcore.run_train(storage, run["variant"])
    finally:
        RecommendationDataSource._frame = frame_of
    for which, n in df.PASS_LAUNCHES.items():
        seg["launches"][which] += n
    check(df.PASS_LAUNCHES["row"] == df.PASS_LAUNCHES["col"]
          == ALSAlgorithmParams().num_iterations, f"retrain launches {df.PASS_LAUNCHES}")
    check(inst.status == "COMPLETED", f"retrain instance {inst.status}")
    check(DataView.stats["hits"] == hits[0] + 1 and store.frame_cache_stats["hits"] > hits[1],
          f"the retrain missed: data view {DataView.stats}, store {store.frame_cache_stats}")
    [frame] = frames
    check(_frame_rows_equal(frame, *(np.concatenate([a, b]) for a, b in zip(loop_rows, new))),
          "the retrain's frame differs from the generated rows and the tail")
    t0 = time.perf_counter()
    frame2, staged2 = stager.stage(store, q, value_prop="rating", default_value=1.0)
    torch.cuda.synchronize()
    stage_s.append(time.perf_counter() - t0)
    stats.append(dict(stager.stats))
    check(stats[1] == {"sealed_restage": 1, "sealed_reuse": 1,
                       "bytes_staged": 12 * (LOOP_EDGES + SEGMENTS_TAIL)},
          f"the second stage copied more than the tail: {stats[1]}")
    _staged_equal(staged2, frame2, "stage 2")
    for name in ("entity_idx", "target_idx", "value"):
        check(torch.equal(staged2[name][:LOOP_EDGES], staged1[name]),
              f"the sealed prefix's {name} moved under tail-only growth")
    del staged1, staged2, frame1, frame2
    [model] = deserialize_models(storage.get_model_data_models().get(inst.id).models)
    check(_finite(model.factors), "non-finite factors after the retrain")
    store.close()  # seals the tail; releases the PATH for the children
    stores.opened.remove(store)
    fresh = Storage().get_events()
    t0 = time.perf_counter()
    cold = fresh.find_frame(q, value_prop="rating", default_value=1.0)
    seg["cold_read_s"] = time.perf_counter() - t0
    check(_same_frame(frame, cold), "the retrain's frame differs from a cold read")
    stores.close()
    seg.update({"stager": stats, "stage_s": stage_s,
                "retrain_stages": stage_timings(inst)})
    run.update(retrain=inst, model=model)


def _segments_event_server(seg, stores, app_id, key, new):
    """(d) `eventserver` in a process of its own over the PATH: four
    writers batch-POST SEGMENTS_POSTED events with their own ids; the
    server is SIGKILLed a third of the way in and restarted on its port;
    each writer resends every batch not acknowledged. Then seal, stats
    and compact over HTTP, the server stopped, and a find_since read."""
    users, items, ratings, times = new
    stamps = np.datetime_as_string(times.astype("datetime64[ms]"), unit="ms")
    events = [{"event": "rate", "entityType": "user", "entityId": f"u{u}",
               "targetEntityType": "item", "targetEntityId": f"i{i}",
               "properties": {"rating": int(r)}, "eventTime": f"{t}Z",
               "eventId": f"posted-{n:05d}"}
              for n, (u, i, r, t) in enumerate(zip(users.tolist(), items.tolist(),
                                                   ratings.tolist(), stamps))]
    batches = [events[n:n + SEGMENTS_BATCH] for n in range(0, len(events), SEGMENTS_BATCH)]
    lock, restarted = threading.Lock(), threading.Event()
    acked: list = []
    resent: list = []
    errors: list = []

    def writer(port, mine):
        """POST each batch; one that fails on the wire (the server
        killed) waits for the restart and goes again."""
        try:
            for b in mine:
                while True:
                    try:
                        status, body = _call(port, "POST",
                                             f"/batch/events.json?accessKey={key}", batches[b])
                    except (OSError, http.client.HTTPException):
                        with lock:
                            resent.append(b)
                        check(restarted.wait(timeout=300), "the Event Server was not restarted")
                        continue
                    check(status == 200 and all(r.get("status") == 201 for r in body),
                          f"batch POST: HTTP {status} {str(body)[:200]}")
                    with lock:
                        acked.append(b)
                    break
        except Exception as e:  # noqa: BLE001 — fails the phase below
            errors.append(e)

    t0 = time.perf_counter()
    with _Console(["eventserver", "--ip", "127.0.0.1", "--port", "0"],
                  SEGMENTS_DIR / "eventserver.log") as es:
        port = es.port(timeout=120)
        threads = [threading.Thread(target=writer, args=(port, range(w, len(batches),
                                                                      SEGMENTS_WRITERS)))
                   for w in range(SEGMENTS_WRITERS)]
        for t in threads:
            t.start()
        while len(acked) < SEGMENTS_KILL_AT * len(batches):
            check(not errors and time.perf_counter() - t0 < 300, f"ingest stalled: {errors}")
            time.sleep(0.005)
        es.proc.kill()  # SIGKILL
        es.proc.wait(timeout=30)
        with lock:
            before_kill = set(acked)
    t_kill = time.perf_counter()
    with _Console(["eventserver", "--ip", "127.0.0.1", "--port", str(port)],
                  SEGMENTS_DIR / "eventserver_restarted.log") as es:
        check(es.port(timeout=120) == port, "restarted on another port")
        restart_s = time.perf_counter() - t_kill
        restarted.set()
        for t in threads:
            t.join(timeout=600)
        check(not any(t.is_alive() for t in threads) and not errors,
              f"writers: {errors or 'hung'}")
        ingest_s = time.perf_counter() - t0
        check(sorted(acked) == list(range(len(batches))), "a batch was never acknowledged")
        # the segment surface, as the JAX server answers it. The server's
        # sealer runs meanwhile (a seal it has in hand makes ours answer
        # 0), so the tail is waited out before the compaction, and every
        # answer must keep each live row: sealed - dead + tail
        ops = {}

        def segments_call(name, method, path):
            status, body = _call(port, method, f"{path}?accessKey={key}")
            check(status == 200, f"{method} {path}: HTTP {status} {body}")
            ops[name] = body

        want_n = LOOP_EDGES + SEGMENTS_TAIL + SEGMENTS_POSTED
        segments_call("stats_before", "GET", "/segments/stats")
        segments_call("seal", "POST", "/segments/seal")
        t_seal = time.perf_counter()
        while True:
            segments_call("stats_sealed", "GET", "/segments/stats")
            if not ops["stats_sealed"]["tail_rows"]:
                break
            check(time.perf_counter() - t_seal < 60, f"the tail stayed unsealed: {ops}")
            time.sleep(0.05)
        segments_call("compact", "POST", "/segments/compact")
        segments_call("stats", "GET", "/segments/stats")
        keys = {"segments", "sealed_rows", "dead_rows", "tail_rows", "max_revision",
                "tombstones"}
        stats = [ops[k] for k in ("stats_before", "stats_sealed", "stats")]
        check(set(ops["seal"]) == {"sealedRows"} and set(ops["compact"]) == {"segmentsMerged"}
              and all(set(st) == keys for st in stats), f"segment answers {ops}")
        check(0 <= ops["seal"]["sealedRows"] <= ops["stats_before"]["tail_rows"]
              and ops["compact"]["segmentsMerged"] >= 0
              and ops["stats"]["segments"] <= ops["stats_sealed"]["segments"]
              - ops["compact"]["segmentsMerged"]
              and all(st["sealed_rows"] - st["dead_rows"] + st["tail_rows"] == want_n
                      for st in stats),
              f"seal and compaction do not add up: {ops}")
        check(es.interrupt() == 0, "eventserver did not stop on SIGINT")
    # each revision once from 0, the acknowledged and resent ids once each
    fresh = Storage().get_events()
    t0 = time.perf_counter()
    cursor, n_read, ids, got = 0, 0, set(), {}
    while True:
        page = fresh.find_since(app_id, cursor, limit=SEGMENTS_PAGE)
        if not page:
            break
        revs = [e.revision for e in page]
        check(revs[0] > cursor and all(a < b for a, b in zip(revs, revs[1:])),
              "find_since gave a revision twice or out of order")
        cursor = revs[-1]
        n_read += len(page)
        ids.update(e.event_id for e in page)
        got.update((e.event_id, (e.entity_id, e.target_entity_id, e.properties["rating"]))
                   for e in page if e.event_id.startswith("posted-"))
    find_since_s = time.perf_counter() - t0
    check(n_read == len(ids) == want_n, f"find_since read {n_read} events, {len(ids)} ids, "
                                        f"not {want_n}")
    for b in sorted(before_kill) + sorted(set(resent)):
        for e in batches[b]:
            check(got.get(e["eventId"]) == (e["entityId"], e["targetEntityId"],
                                            e["properties"]["rating"]),
                  f"acknowledged event {e['eventId']} missing or changed")
    check(cursor == fresh.latest_revision(app_id), "the cursor stopped short of the head")
    final = fresh.segment_stats(app_id)
    # phase 9c's reference: this PATH's frame, read before its daemon opens it
    frame = fresh.find_frame(EventQuery(app_id=app_id, entity_type="user",
                                        target_entity_type="item", event_names=["rate"]),
                             value_prop="rating", default_value=1.0)
    stores.close()
    seg["event_server"] = {
        "batches": len(batches), "acked_before_kill": len(before_kill),
        "resent": len(set(resent)), "restart_s": restart_s, "ingest_s": ingest_s,
        "seal": ops["seal"], "compact": ops["compact"], "stats": ops["stats"],
        "stats_before": ops["stats_before"], "final": final,
        "find_since_events": n_read, "find_since_s": find_since_s,
    }
    return {"frame": frame, "head": cursor, "t_end_ms": int(times.max())}


# ---------------------------------------------------------------------------
# phase 9c: the replicated event store over phase 9b's segmentfs store
# ---------------------------------------------------------------------------

REPLICATION_DIR = Path(__file__).resolve().parent / "build" / "replication"
REPLICATION_SEED = 26
REPL_NEW_USERS, REPL_USER_RATINGS = 1_000, 12  # (b): new users, ML-1M movies each
REPL_WRITERS, REPL_BATCH = 4, 50
REPL_KILL_AT = 1 / 3  # the share of (b)'s events acknowledged before the SIGKILL
REPL_SEAL_EVENTS = 2_000  # the primary's seal size: segments ship as well as frames
REPL_WAIT_S = 120.0  # each wait's own deadline
_LISTENING = re.compile(r"storage server listening on [^\s:]+:(\d+)")


def _storage_of(sources, repositories):
    """A Storage of its own from `sources` {name: (type, settings)}: no
    process variable takes part."""
    env = {}
    for name, (kind, settings) in sources.items():
        env[f"PIO_STORAGE_SOURCES_{name}_TYPE"] = kind
        env.update({f"PIO_STORAGE_SOURCES_{name}_{k}": v for k, v in settings.items()})
    env.update({f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": s for r, s in repositories.items()})
    return Storage(StorageConfig.from_env(env))


def _follower_storage(name):
    """A follower's storage: its events a segmentfs-replica store under
    REPLICATION_DIR/<name> (never sealed locally), no other repository."""
    return _storage_of({"REP": ("segmentfs-replica", {"PATH": str(REPLICATION_DIR / name),
                                                      "SEAL_INTERVAL_S": "3600"}),
                        "MEM": ("memory", {})},
                       {"METADATA": "MEM", "EVENTDATA": "REP", "MODELDATA": "MEM"})


def _control_storage():
    """Phase 9b's metadata (docfs) and models (localfs), with events (the
    lifecycle records: cursors, election bids) in a sqlite file of their
    own under REPLICATION_DIR: nothing of it opens 9b's event PATH."""
    return _storage_of({"SEGMETA": ("docfs", {"PATH": str(SEGMENTS_DIR / "meta")}),
                        "SEGFS": ("localfs", {"PATH": str(SEGMENTS_DIR / "models")}),
                        "CTL": ("sqlite", {"PATH": str(REPLICATION_DIR / "control.db")})},
                       {"METADATA": "SEGMETA", "EVENTDATA": "CTL", "MODELDATA": "SEGFS"})


def _remote_events(port):
    """The events DAO of the storage daemon on `port`."""
    return _storage_of({"RMT": ("remote", {"HOST": "127.0.0.1", "PORT": str(port),
                                           "RETRY_ATTEMPTS": "2",
                                           "RETRY_BASE_DELAY": "0.01"})},
                       {"METADATA": "RMT", "EVENTDATA": "RMT",
                        "MODELDATA": "RMT"}).get_events()


class _PrimaryDaemon:
    """`python -m predictionio_tpu_torch.data.api.storage_server` over
    phase 9b's event PATH, its shipper on (PIO_REPL_*), in a process of
    its own; SIGKILLed by the phase, killed on exit if it still runs."""

    def __init__(self, followers):
        root = Path(__file__).resolve().parent
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("PIO_STORAGE_", "PIO_REPL_"))}
        env["PYTHONPATH"] = os.pathsep.join(
            [str(root)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        env.update({"PIO_STORAGE_SOURCES_SEGEV_TYPE": "segmentfs",
                    "PIO_STORAGE_SOURCES_SEGEV_PATH": str(SEGMENTS_DIR / "events"),
                    "PIO_STORAGE_SOURCES_SEGEV_SEAL_EVENTS": str(REPL_SEAL_EVENTS),
                    "PIO_STORAGE_SOURCES_SEGEV_FSYNC": "1",
                    "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
                    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
                    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SEGEV",
                    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
                    "PIO_REPL_FOLLOWERS": ",".join(f"127.0.0.1:{p}" for p in followers),
                    "PIO_REPL_MIN_ACKS": "1", "PIO_REPL_SHIP_INTERVAL_S": "0.05",
                    "PIO_REPL_EPOCH": "1"})
        self.log_path = REPLICATION_DIR / "primary.log"
        self.log = open(self.log_path, "w")
        self.t_start = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.data.api.storage_server",
             "--host", "127.0.0.1", "--port", "0"],
            env=env, cwd=root, stdout=self.log, stderr=subprocess.STDOUT)

    def port(self, timeout=REPL_WAIT_S):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            m = _LISTENING.search(self.log_path.read_text())
            if m:
                return int(m.group(1))
            check(self.proc.poll() is None, f"the primary daemon exited: "
                                            f"{self.log_path.read_text()[-2000:]}")
            time.sleep(0.05)
        raise PhaseError("the primary daemon never listened")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=30)
        self.log.close()


def _wait_until(pred, what, timeout=REPL_WAIT_S, poll=0.02):
    deadline = time.monotonic() + timeout
    while not pred():
        check(time.monotonic() < deadline, f"{what} within {timeout} s")
        time.sleep(poll)
    return time.perf_counter()


def _replication_events(rng, users_n, t0_ms):
    """(b)'s traffic: REPL_NEW_USERS new users, each rating
    REPL_USER_RATINGS distinct ML-1M movies 1-5, in a random order a
    second apart after `t0_ms`, with their own ids."""
    rows = [(users_n + u, int(i), int(rng.integers(1, 6)))
            for u in range(REPL_NEW_USERS)
            for i in rng.choice(LOOP_ITEMS, REPL_USER_RATINGS, replace=False)]
    order = rng.permutation(len(rows)).tolist()
    return [Event(event="rate", entity_type="user", entity_id=f"u{rows[j][0]}",
                  target_entity_type="item", target_entity_id=f"i{rows[j][1]}",
                  properties={"rating": rows[j][2]},
                  event_time=datetime.datetime.fromtimestamp(
                      (t0_ms + 1000 * n) / 1e3, datetime.timezone.utc),
                  event_id=f"repl-{n:05d}")
            for n, j in enumerate(order)]


def _fields(e):
    return (e.event_id, e.entity_id, e.target_entity_id, e.properties.get("rating"))


def phase_replication(report, shared):
    """Phase 9c: phase 9b's store replicated to two followers in this
    process by a primary daemon, serving and fold-in from a follower,
    the primary SIGKILLed mid-ingest, a fenced failover, exactly-once."""
    t_phase = time.perf_counter()
    sg = shared["segments"]
    shutil.rmtree(REPLICATION_DIR, ignore_errors=True)
    REPLICATION_DIR.mkdir(parents=True)
    smi = report["nvidia_smi"]
    rp = report["replication"] = {"nvidia_smi": smi}
    fstores, daemons = {}, {}
    try:
        for name in ("a", "b"):
            st = _follower_storage(name)
            fstores[name] = st.get_events()
            fstores[name].init_app(sg["app_id"])
            daemons[name] = StorageServer(st, host="127.0.0.1", port=0).start()
        ports = {n: d.port for n, d in daemons.items()}
        with _PrimaryDaemon([ports["a"], ports["b"]]) as primary:
            _replication_run(rp, sg, primary, fstores, ports)
    finally:
        for d in daemons.values():
            d.shutdown()
        for s in fstores.values():
            s.close()
    rp["phase_s"] = time.perf_counter() - t_phase
    a, b, c, d = rp["a"], rp["b"], rp["c"], rp["d"]
    print(f"[replication] {smi} | (a) {a['rows']} sealed rows in {a['segments']} segments "
          f"synced to both followers in {a['sync_s']:.2f} s: "
          f"replication_ship_bytes_total {a['ship_bytes']:.0f} ({a['mb_s']:.1f} MB/s); "
          f"content hashes equal; follower A's frame bit-equal to the primary's", flush=True)
    print(f"[replication] {smi} | (b) {b['acked']} of {b['events']} events acknowledged "
          f"(MIN_ACKS 1) from {REPL_WRITERS} writers before the SIGKILL; read-your-writes on "
          f"A in {b['ryw_s']:.3f} s; ships {b['ships']}", flush=True)
    print(f"[replication] {smi} | (c) failover: kill to promoted {c['promote_s']:.3f} s "
          f"(winner {c['winner']} at epoch {c['epoch']}), to the loser caught up "
          f"{c['caught_up_s']:.3f} s; every acked id once on the winner; the dead primary "
          f"wrote every row the winner holds ({c['dead_rows']} rows past the head); zombie "
          f"frame fenced on both (replication_fenced_total {c['fenced']:.0f})", flush=True)
    print(f"[replication] {smi} | (d) consumer on A: {d['consumed']} events consumed "
          f"once, {d['folded']} folded on cuda:0, caught up {d['caught_up_s']:.3f} s after "
          f"the kill; a restarted consumer consumed 0; {N_QUERIES} queries from "
          f"{N_CLIENTS} clients: p50 {d['p50_ms']:.3f} ms, p99 {d['p99_ms']:.3f} ms, "
          f"{d['qps']:.1f} qps, {d['batches']} batches, top-k launches "
          f"{rp['launches']['topk']} (select {rp['launches']['select']}, profiler "
          f"{d['profiled']}); every answer the CPU plain top-k's; phase {rp['phase_s']:.1f} s",
          flush=True)


def _replication_run(rp, sg, primary, fstores, ports):
    app_id, q = sg["app_id"], sg["query"]
    store_a, store_b = fstores["a"], fstores["b"]
    # (a) the primary takes 9b's PATH; the initial sync ships its segments
    t0 = primary.t_start
    pport = primary.port()
    premote = _remote_events(pport)
    head0 = premote.latest_revision(app_id)
    check(head0 == sg["head"], f"the primary opened at revision {head0}, not {sg['head']}")
    # the shipper syncs A, then B: A's frame is read while B syncs
    t_a = _wait_until(lambda: store_a.latest_revision(app_id) == head0,
                      f"follower a caught up with revision {head0}")
    frame = store_a.find_frame(q, value_prop="rating", default_value=1.0)
    check(_same_frame(frame, sg["frame"]),
          "follower A's frame differs from the primary's, read before the daemon started")
    del frame
    t_b = _wait_until(lambda: store_b.latest_revision(app_id) == head0,
                      f"follower b caught up with revision {head0}")
    sync_s = max(t_a, t_b) - t0
    m = _prometheus(_get(pport, "/metrics")[1])
    ship_bytes = m.get(("replication_ship_bytes_total", ""), 0.0)
    seg_dir = SEGMENTS_DIR / "events" / f"app_{app_id}"
    want = {}
    for p in sorted(seg_dir.glob("seg-*")):
        want[p.name] = json.loads((p / "footer.json").read_text())["content_hash"]
    for n, s in fstores.items():
        got = {p.name: segmentfs.segment_content_hash(str(p))
               for p in sorted((Path(s.base) / f"app_{app_id}").glob("seg-*"))}
        check(got == want, f"follower {n}'s segments {got} differ from the primary's {want}")
        check(s.segment_stats(app_id)["tail_rows"] == 0, f"follower {n} holds a tail")
    rows = store_a.segment_stats(app_id)["sealed_rows"]
    rp["a"] = {"sync_s": sync_s, "sync_a_s": t_a - t0, "ship_bytes": ship_bytes,
               "mb_s": ship_bytes / 1e6 / sync_s, "segments": len(want), "rows": rows,
               "head": head0}

    # (b) a query server on 9b's retrain, its consumer on follower A
    ctl = _control_storage()
    inst = ctl.get_meta_data_engine_instances().get(sg["instance"])
    runtime = build_runtime(ctl, inst)
    model0 = runtime.models[0]
    check(str(model0.device) == "cuda:0", f"the model is on {model0.device}")
    events = _replication_events(np.random.default_rng(REPLICATION_SEED), LOOP_USERS,
                                 sg["t_end_ms"] + 1000)
    batches = [events[n:n + REPL_BATCH] for n in range(0, len(events), REPL_BATCH)]
    fold_devices = []
    fold_of = als.fold_in_rows

    def fold(fixed, edges, params, device=None):
        fold_devices.append(str(device))
        return fold_of(fixed, edges, params, device=device)

    rec.LAUNCHES = 0  # every count to 0 just before the main path
    rec.ROUTE_LAUNCHES.update(select=0, sort=0)
    srv = QueryServer(runtime=runtime, storage=ctl,
                      config=QueryServerConfig(ip="127.0.0.1", port=0))
    port = srv.start()
    als.fold_in_rows = fold
    name = f"online/{app_id}/replica-a"
    try:
        consumer = OnlineConsumer(ReplicaReadStorage(ctl, store_a, [app_id]),
                                  ServerApplyHost(srv), app_id,
                                  OnlineConsumerConfig(tick_s=ONLINE_TICK_S, name=name,
                                                       from_latest=True))
        check(consumer.cursor == {"0": head0}, f"the consumer starts at {consumer.cursor}")
        srv.attach_online(app_id, consumer=consumer)
        rp["b"], acked, t_kill = _replication_writes(premote, primary, ports, app_id, batches,
                                                     pport)
        rp["c"] = _replication_failover(fstores, ports, pport, app_id, head0, acked, batches,
                                        t_kill)
        rp["d"] = _replication_serve(srv, port, consumer, store_a, ctl, app_id, head0,
                                     t_kill, name)
    finally:
        als.fold_in_rows = fold_of
        srv.stop()
    rp["launches"] = {"topk": rp["d"].pop("topk"), "select": rp["d"].pop("select")}
    check(fold_devices and set(fold_devices) == {"cuda:0"},
          f"folds ran on {sorted(set(fold_devices))}")
    rp["d"]["folds"] = len(fold_devices)
    tally = {"cases": 0, "max_abs_err": 0.0}
    _select_held(srv.runtime.models[0]._serving_state, np.random.default_rng(REPLICATION_SEED),
                 tally, "replication slab")
    rp["held"] = tally


def _replication_writes(premote, primary, ports, app_id, batches, pport):
    """(b) REPL_WRITERS threads insert the batches through the primary's
    events DAO (batch 0 from this thread: read-your-writes on A); the
    primary SIGKILLed once REPL_KILL_AT of the events are acknowledged.
    Returns the figures, the acknowledged ids and the kill's time."""
    lock, stop = threading.Lock(), threading.Event()
    acked: list = []
    errors: list = []

    def writer(mine):
        store = _remote_events(pport)
        for b in mine:
            if stop.is_set():
                return
            try:
                ids = store.insert_batch(batches[b], app_id)
            except Exception as e:  # noqa: BLE001 — the primary is gone, or under-replicated
                errors.append(repr(e))
                return
            if ids != [e.event_id for e in batches[b]]:
                errors.append(f"batch {b} acknowledged as ids {ids[:3]}")
                return
            with lock:
                acked.extend(ids)

    threads = [threading.Thread(target=writer, args=(range(1 + w, len(batches), REPL_WRITERS),))
               for w in range(REPL_WRITERS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    # read-your-writes: an acknowledged batch, then A's watermark, then A
    ids0 = premote.insert_batch(batches[0], app_id)
    with lock:
        acked.extend(ids0)
    rev = premote.latest_revision(app_id)
    a_remote = _remote_events(ports["a"])
    t_ryw = time.perf_counter()
    check(a_remote.wait_for_revision(app_id, rev, timeout_s=30.0),
          f"follower A did not reach revision {rev}")
    ryw_s = time.perf_counter() - t_ryw
    for e in batches[0]:
        got = a_remote.get(e.event_id, app_id)
        check(got is not None and _fields(got) == _fields(e),
              f"follower A lacks acknowledged event {e.event_id}")
    lag = a_remote.replication_lag(app_id)
    check(set(lag) == {"watermark", "head", "lag", "epoch", "role"} and lag["epoch"] == 1
          and lag["role"] == "replica", f"replication_lag through the client: {lag}")
    n_events = sum(map(len, batches))
    _wait_until(lambda: len(acked) >= REPL_KILL_AT * n_events or errors,
                f"{REPL_KILL_AT:.2f} of the events acknowledged")
    check(not errors, f"a write failed before the kill: {errors[:3]}")
    m = _prometheus(_get(pport, "/metrics")[1])
    ships = {k: m.get(("replication_ship_total", f'{{kind="{k}"}}'), 0.0)
             for k in ("wal", "segment")}
    check(ships["wal"] > 0 and ships["segment"] > 0,
          f"the primary's /metrics shows replication_ship_total {ships}")
    primary.proc.kill()  # SIGKILL, the writers still writing
    t_kill = time.perf_counter()
    primary.proc.wait(timeout=30)
    stop.set()
    for t in threads:
        t.join(timeout=REPL_WAIT_S)
    check(not any(t.is_alive() for t in threads), "a writer hung after the kill")
    with lock:
        acked = list(acked)
    return ({"events": n_events, "acked": len(acked), "write_s": t_kill - t0,
             "ryw_s": ryw_s, "ryw_revision": rev, "lag": lag, "ships": ships},
            acked, t_kill)


def _replication_failover(fstores, ports, pport, app_id, head0, acked, batches, t_kill):
    """(c) Both followers stand at once through `elect_and_promote`
    (peers: the other follower and the dead primary); the checks on the
    winner, the dead primary's own rows, the winner's write, the loser's
    catch-up at epoch 2, the zombie frame."""
    records = LifecycleRecordStore(_control_storage())
    links = {n: FollowerLink(f"127.0.0.1:{p}", timeout_s=30.0) for n, p in ports.items()}
    dead = FollowerLink(f"127.0.0.1:{pport}", timeout_s=5.0)
    results, barrier = {}, threading.Barrier(2)

    def stand(name, other):
        barrier.wait()
        results[name] = elect_and_promote(records, fstores[name], f"replica-{name}",
                                          peers=[links[other], dead], settle_s=0.3)

    threads = [threading.Thread(target=stand, args=a) for a in (("a", "b"), ("b", "a"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=REPL_WAIT_S)
    check(not any(t.is_alive() for t in threads), "an election hung")
    t_promoted = time.perf_counter()
    winners = [n for n, g in results.items() if g is not None]
    check(len(winners) == 1, f"not one winner: {results}")
    wname = winners[0]
    lname = "b" if wname == "a" else "a"
    winner, loser = fstores[wname], fstores[lname]
    check(results[wname] == 2 and winner.role == "primary" and winner.epoch == 2,
          f"the winner: generation {results[wname]}, role {winner.role}, epoch {winner.epoch}")
    # every acknowledged id once, read from the head before the writes
    after = winner.find_since(app_id, head0)
    ids = [e.event_id for e in after]
    check(len(ids) == len(set(ids)), "the winner holds an event twice")
    sent = {e.event_id: _fields(e) for b in batches for e in b}
    missing = set(acked) - set(ids)
    check(not missing, f"{len(missing)} acknowledged events lost, e.g. {sorted(missing)[:3]}")
    check(all(_fields(e) == sent.get(e.event_id) for e in after),
          "the winner holds an event that no writer sent as stored")
    # the dead primary's PATH, opened in this process (its WAL replays):
    # every row the winner holds past the head is the primary's own
    dead_store = segmentfs.SegmentFSEventStore({"PATH": str(SEGMENTS_DIR / "events"),
                                                "SEAL_INTERVAL_S": "3600"})
    try:
        wrote = {e.revision: _fields(e) for e in dead_store.find_since(app_id, head0)}
    finally:
        dead_store.close()
    check(all(wrote.get(e.revision) == _fields(e) for e in after),
          "the winner holds a row the dead primary never wrote")
    # the winner takes a write; a shipper of epoch 2 brings the loser to it
    winner.insert_batch([Event(event="rate", entity_type="user", entity_id=f"u{LOOP_USERS}",
                               target_entity_type="item", target_entity_id="i1",
                               properties={"rating": 5}, event_id="post-failover")], app_id)
    sh2 = SegmentShipper(winner, ReplicationConfig(followers=(f"127.0.0.1:{ports[lname]}",),
                                                   timeout_s=30.0), epoch=2)

    def caught_up():
        sh2.pass_once()
        return (loser.latest_revision(app_id) == winner.latest_revision(app_id)
                and loser.replication_lag(app_id)["lag"] == 0)

    t_caught = _wait_until(caught_up, "the loser caught up with the winner", poll=0.05)
    check(loser.epoch == 2, f"the loser's epoch {loser.epoch} after the epoch-2 frames")
    check([e.event_id for e in loser.find_since(app_id, head0)]
          == [e.event_id for e in winner.find_since(app_id, head0)],
          "the loser's events past the head differ from the winner's")
    # a zombie's epoch-1 frame: the winner refuses frames, the loser fences
    zombie = (app_id, None, 1, 0, [1], [["z", "rate", "user", "z", "item", "i1", {}, 0, None,
                                          None, 0]], 1)
    for store, want in ((winner, "promoted"), (loser, "fenced")):
        try:
            store.replication_apply_wal(*zombie)
        except StorageError as e:
            check(want in str(e), f"the zombie frame refused with {e}")
        else:
            raise PhaseError(f"a zombie frame was applied ({want})")
    fenced = _prometheus(get_default_registry().render()).get(("replication_fenced_total", ""),
                                                              0.0)
    check(fenced >= 1, f"replication_fenced_total {fenced}")
    return {"winner": wname, "epoch": winner.epoch, "promote_s": t_promoted - t_kill,
            "caught_up_s": t_caught - t_kill, "acked_on_winner": len(acked),
            "dead_rows": len(wrote), "winner_rows": len(after), "fenced": fenced}


def _replication_serve(srv, port, consumer, store_a, ctl, app_id, head0, t_kill, name):
    """(d) The consumer drained on A, exactly once; a second consumer of
    the same name consumes nothing; 500 queries for folded and known
    users, each the plain top-k on the CPU, one select a device batch."""
    t_caught = _wait_until(
        lambda: (consumer.cursor.get("0", 0) == store_a.latest_revision(app_id)
                 and not consumer.foldin.pending_items),
        "the consumer on A caught up")
    srv.online.stop()
    check(consumer.stopped(), "the consumer did not stop")
    live = store_a.find_since(app_id, head0)
    c = dict(consumer.counters)
    check(c["events_consumed"] == len(live),
          f"events_consumed {c['events_consumed']} != {len(live)} live events past the start")
    check(c["events_folded"] == len(live),
          f"events_folded {c['events_folded']} != {len(live)}: {consumer.status()}")
    check(consumer.status()["last_error"] is None, f"a fold failed: {consumer.status()}")
    again = OnlineConsumer(ReplicaReadStorage(ctl, store_a, [app_id]), ServerApplyHost(srv),
                           app_id, OnlineConsumerConfig(tick_s=3600, name=name,
                                                        from_latest=True))
    check(again.cursor == consumer.cursor and again.tick() == {"idle": "no new events"}
          and again.counters == c, f"a restarted consumer: {again.cursor} {again.counters}")
    model = srv.runtime.models[0]
    check(str(model.device) == "cuda:0", f"the folded model is on {model.device}")
    f = model.factors
    folded = sorted({e.entity_id for e in live})
    check(all(f.user_vocab.contains(u) for u in folded), "a folded user is not served")
    rng = np.random.default_rng(REPLICATION_SEED + 1)
    picks = rng.choice(folded, N_QUERIES // 2, replace=False).tolist()
    queries = ([{"user": u, "num": int(rng.choice([5, 10, 20, 50]))} for u in picks]
               + [{"user": f"u{int(u)}", "num": int(rng.choice([5, 10, 20, 50]))}
                  for u in rng.integers(0, LOOP_USERS, N_QUERIES - len(picks))])
    queries = [queries[n] for n in rng.permutation(len(queries)).tolist()]
    st0, prof0 = _status(port), _exec_totals("als.recommend_serving")
    l0, s0 = rec.LAUNCHES, rec.ROUTE_LAUNCHES["select"]
    out, lock = {}, threading.Lock()
    work = list(enumerate(queries))
    threads = [threading.Thread(target=_client, args=(port, work[k::N_CLIENTS], out, lock))
               for k in range(N_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "clients hung")
    st1, prof1 = _status(port), _exec_totals("als.recommend_serving")
    batches = st1["batches"] - st0["batches"]
    served, select = rec.LAUNCHES - l0, rec.ROUTE_LAUNCHES["select"] - s0
    profiled = prof1[0] - prof0[0]
    check(batches > 0 and served == select == batches == profiled
          and st1["kernel_launches"] - st0["kernel_launches"] == batches,
          f"top-k launches {served} (select {select}, profiler {profiled}) != batches {batches}")
    check(srv.runtime.models[0] is model, "the model changed during the queries")
    cpu_model = ALSModel(f, device="cpu")
    cpu_alg = ALSAlgorithm(ALSAlgorithmParams())
    for n, qy in enumerate(queries):
        status, body, _ = out[n]
        check(status == 200, f"query {n}: HTTP {status} {body}")
        check(body == _to_jsonable(cpu_alg.predict(cpu_model, Query(**qy))),
              f"query {n} ({qy}) differs from the CPU plain top-k")
    lat = [out[n][2] for n in range(len(queries))]
    return {"consumed": c["events_consumed"], "folded": c["events_folded"],
            "users_folded": c["users_folded"], "caught_up_s": t_caught - t_kill,
            "p50_ms": _pct(lat, 0.5), "p99_ms": _pct(lat, 0.99), "qps": len(queries) / wall,
            "batches": batches, "profiled": profiled, "topk": rec.LAUNCHES,
            "select": rec.ROUTE_LAUNCHES["select"]}


# ---------------------------------------------------------------------------
# phase 10: pio eval over the loop's storage
# ---------------------------------------------------------------------------


def _eval_params():
    """The tuning grid's EngineParams, in EVAL_GRID's order."""
    ds = ("", DataSourceParams(app_name=LOOP_APP, event_names=("rate",),
                               eval_k=EVAL_FOLDS, goal_threshold=EVAL_THRESHOLD,
                               eval_num=EVAL_NUM))
    return [EngineParams(data_source_params=ds, algorithm_params_list=(("als", ALSAlgorithmParams(
        rank=rank, num_iterations=iterations, lambda_=lam)),))
        for rank, iterations, lam in EVAL_GRID]


if _IMPORT_ERROR is None:
    class EvalML1M(Evaluation):
        """What `console eval run` loads by its import path."""

        engine = RecommendationEngine().apply()
        metric = PrecisionAtK(k=EVAL_PRECISION_K)
        output_path = str(LOOP_DIR / "best.json")

    class EvalGrid(EngineParamsGenerator):
        engine_params_list = _eval_params()


def _bit_equal(a, b):
    return (np.array_equal(a.user_factors, b.user_factors)
            and np.array_equal(a.item_factors, b.item_factors))


def _finite(f):
    return bool(np.isfinite(f.user_factors).all() and np.isfinite(f.item_factors).all())


def phase_eval(report, shared):
    """`console eval run` over the loop's storage on the card, then the
    checks on fold 0 and the forced-dense grid."""
    t_phase = time.perf_counter()
    n_points = len(EVAL_GRID)
    spies = [_Spy(RecommendationDataSource, "read_eval"), _Spy(als, "stage_windowed"),
             _Spy(als, "stage_dense"), _Spy(als, "train_grid"), _Spy(als, "train"),
             _Spy(ALSAlgorithm, "batch_predict"), _Spy(MetricEvaluator, "evaluate")]
    reads, staged_w, staged_d, grids, serial, predicts, metrics = spies
    with _loop_storage():
        with contextlib.ExitStack() as stack:
            for spy in spies:
                stack.enter_context(spy)
            rec.LAUNCHES = 0  # every count to 0 just before the main path
            rec.ROUTE_LAUNCHES.update(select=0, sort=0)
            wf.BLOCK_LAUNCHES.update(partials=0, combine=0)
            df.PASS_LAUNCHES.update(row=0, col=0)
            rc = console.main(["eval", "run", f"{__name__}.EvalML1M", f"{__name__}.EvalGrid"])
            launches = {"topk": rec.LAUNCHES, "topk_select": rec.ROUTE_LAUNCHES["select"],
                        **wf.BLOCK_LAUNCHES, **df.PASS_LAUNCHES}
        check(rc == 0, f"eval run exited {rc}")
        [row] = Storage().get_meta_data_evaluation_instances().get_all()
    check(row.status == "EVALCOMPLETED", f"evaluation instance {row.status}")
    check(bool(row.evaluator_results and row.evaluator_results_html),
          "the instance lacks the one-liner or the HTML")
    result = json.loads(row.evaluator_results_json)
    scores = [s["score"] for s in result["scores"]]
    check(len(scores) == n_points and row.env.get("grid_points") == str(n_points),
          f"{len(scores)} scores, grid_points {row.env.get('grid_points')}")
    best_path = Path(EvalML1M.output_path)
    check(best_path.is_file()
          and json.loads(best_path.read_text()) == result["bestEngineParams"],
          "best.json missing or not the instance's best engine params")

    # the grid path: one train_grid and one windowed staging a fold
    check(len(grids.calls) == EVAL_FOLDS, f"train_grid ran {len(grids.calls)} times")
    check(len(staged_w.calls) == EVAL_FOLDS and not staged_d.calls
          and all(isinstance(out, als.StagedWindowedTrain) for *_, out in staged_w.calls),
          f"stagings: {len(staged_w.calls)} windowed, {len(staged_d.calls)} dense")
    check(not serial.calls, f"{len(serial.calls)} grid points trained serially")
    iterations = sum(it for _, it, _ in EVAL_GRID)
    want = EVAL_FOLDS * 2 * iterations
    check(launches["partials"] == launches["combine"] == want,
          f"windowed launches {launches} != 2 x iterations x folds ({want})")
    check(launches["topk"] == launches["topk_select"] == EVAL_FOLDS * n_points,
          f"top-k launches {launches} != one select a (fold, point)")
    check(launches["row"] == launches["col"] == 0, "a dense pass ran on the windowed route")
    check(all(_finite(f) for *_, out in grids.calls for f in out), "non-finite factors")
    [(read_s, _, folds)] = reads.calls
    answers = [out for *_, out in predicts.calls]  # fold-major, point-minor
    check(len(answers) == EVAL_FOLDS * n_points, f"{len(answers)} batch predicts")
    check(all(args[2].device == torch.device("cuda:0") for _, args, _ in predicts.calls),
          "a grid model is not on the card")

    # every point's Precision@k, recomputed on the host from its answers
    for i in range(n_points):
        per = []
        for f, (_, _, qa) in enumerate(folds):
            preds = dict(answers[f * n_points + i])
            for qx, (_, actual) in enumerate(qa):
                if actual.items:
                    top = {s.item for s in preds[qx].item_scores[:EVAL_PRECISION_K]}
                    per.append(len(top & set(actual.items)) / EVAL_PRECISION_K)
        check(float(np.mean(per)) == scores[i],
              f"point {i}: Precision@{EVAL_PRECISION_K} {scores[i]} != {np.mean(per)} "
              "recomputed from its answers")

    # fold 0: each point bit-equal to a serial train; the answers of
    # point 0 (rank 10) and point 4 (rank 20) equal to the plain top-k
    # on the CPU over the same factors
    td0 = folds[0][0]
    grid0 = grids.calls[0][2]
    ctx = RuntimeContext()
    for n, ((rank, it, lam), got) in enumerate(zip(EVAL_GRID, grid0)):
        ref = ALSAlgorithm(ALSAlgorithmParams(rank=rank, num_iterations=it, lambda_=lam)
                           ).train(ctx, td0).factors
        check(_bit_equal(got, ref), f"fold 0 point {n}: train_grid != a serial train")
    queries0 = predicts.calls[0][1][3]
    for n in EVAL_HELD_POINTS:
        cpu = ALSAlgorithm(ALSAlgorithmParams(rank=EVAL_GRID[n][0])).batch_predict(
            None, ALSModel(grid0[n], device="cpu"), queries0)
        check(cpu == answers[n],
              f"fold 0 point {n}: answers differ from the plain top-k on the CPU")

    dense_run = _eval_dense(td0)
    held = _eval_kernels_held(staged_w.calls[0][2], dense_run["staged"])

    smi = report["nvidia_smi"]
    staging_s = [t for t, *_ in staged_w.calls]
    grid_s = [t for t, *_ in grids.calls]
    predict_s = [t for t, *_ in predicts.calls]
    ev = report["eval"] = {
        "folds": EVAL_FOLDS, "grid": EVAL_GRID, "precision_k": EVAL_PRECISION_K,
        "train_edges": [len(td.rows) for td, _, _ in folds],
        "queries": [len(qa) for _, _, qa in folds],
        "read_eval_s": read_s, "staging_s": staging_s,
        "staging_host_prep_s": [out.host_prep_sec for *_, out in staged_w.calls],
        "train_grid_s": grid_s, "batch_predict_s": predict_s,
        "metric_s": metrics.calls[0][0], "eval_wall_sec": float(row.env["eval_wall_sec"]),
        "scores": scores, "best_index": result["bestIndex"], "best_score": result["bestScore"],
        "instance": row.id, "launches": launches,
        "dense": {k: v for k, v in dense_run.items() if k != "staged"},
        "held": held,
        "phase_s": time.perf_counter() - t_phase, "nvidia_smi": smi,
    }
    print(f"[eval] {smi} | {EVAL_FOLDS} folds of ~{ev['train_edges'][0]} training edges, "
          f"{min(ev['queries'])}-{max(ev['queries'])} queries a fold: read_eval "
          f"{read_s:.2f} s", flush=True)
    print(f"[eval] {smi} | staging s per fold "
          f"{', '.join(f'{t:.3f}' for t in staging_s)}; train_grid s per fold (staging "
          f"included) {', '.join(f'{t:.3f}' for t in grid_s)}", flush=True)
    print(f"[eval] {smi} | batch_predict s per model: min {min(predict_s):.4f}, median "
          f"{statistics.median(predict_s):.4f}, max {max(predict_s):.4f} "
          f"({len(predict_s)} models); metric {ev['metric_s']:.3f} s; eval_wall_sec "
          f"{ev['eval_wall_sec']:.3f}", flush=True)
    for (rank, it, lam), score in zip(EVAL_GRID, scores):
        print(f"[eval] {smi} | rank {rank}, iterations {it}, lambda {lam}: "
              f"Precision@{EVAL_PRECISION_K} {score}", flush=True)
    rank, it, lam = EVAL_GRID[ev["best_index"]]
    dn = ev["dense"]
    print(f"[eval] {smi} | best: point {ev['best_index']} (rank {rank}, iterations {it}, "
          f"lambda {lam}), {ev['best_score']}; forced-dense batch_eval of fold 0 "
          f"{dn['batch_eval_s']:.2f} s (read_eval {dn['read_eval_s']:.2f} s, train_grid "
          f"{dn['train_grid_s']:.2f} s, staging {dn['staging_s']:.3f} s); phase "
          f"{ev['phase_s']:.1f} s", flush=True)
    w, d = held["windowed"], held["dense"]
    print(f"[eval] at the eval's shapes (fold 0, K = {held['ranks']}): block_partials + "
          f"combine {w['cases']} cases, largest |kernel - plain| / (1e-5*S) "
          f"{w['max_ratio']:.3g} / combined {w['combined_max_ratio']:.3g}; row pass "
          f"{d['row']['cases']} and col pass {d['col']['cases']} cases on the staged int8 "
          f"R {held['dense_r']}, {d['row']['max_ratio']:.3g} / {d['col']['max_ratio']:.3g}; "
          f"scored top-k answers of points {list(EVAL_HELD_POINTS)} equal to the CPU's",
          flush=True)


def _eval_dense(td0):
    """The forced-dense grid through the engine: `batch_eval` of the
    tuning grid on fold 0 (`fold_indices`) with PIO_DENSE_ALS=1, counts
    from 0 around it; then the checks on its staging, launches, factors
    (each bit-equal to a serial forced-dense `ALSAlgorithm.train`) and
    answers."""
    n_points = len(EVAL_GRID)
    saved = os.environ.get("PIO_DENSE_ALS")
    os.environ["PIO_DENSE_ALS"] = "1"
    try:
        with _loop_storage(), contextlib.ExitStack() as stack:
            sd, sw, grids, reads = (stack.enter_context(_Spy(owner, name)) for owner, name in (
                (als, "stage_dense"), (als, "stage_windowed"), (als, "train_grid"),
                (RecommendationDataSource, "read_eval")))
            ctx = RuntimeContext(storage=Storage(), mode="eval")
            rec.LAUNCHES = 0  # every count to 0 just before the main path
            rec.ROUTE_LAUNCHES.update(select=0, sort=0)
            wf.BLOCK_LAUNCHES.update(partials=0, combine=0)
            df.PASS_LAUNCHES.update(row=0, col=0)
            t0 = time.perf_counter()
            out = EvalML1M.engine.batch_eval(ctx, EvalGrid.engine_params_list,
                                             fold_indices=[0])
            batch_s = time.perf_counter() - t0
            launches = {"topk": rec.LAUNCHES, "topk_select": rec.ROUTE_LAUNCHES["select"],
                        **wf.BLOCK_LAUNCHES, **df.PASS_LAUNCHES}
        check(len(sd.calls) == 1 and not sw.calls and sd.calls[0][2].dense_dtype == "int8",
              f"dense grid stagings: {len(sd.calls)} dense, {len(sw.calls)} windowed")
        check(len(grids.calls) == 1, f"dense train_grid ran {len(grids.calls)} times")
        iterations = sum(it for _, it, _ in EVAL_GRID)
        check(launches["row"] == launches["col"] == iterations,
              f"dense pass launches {launches} != {iterations}")
        check(launches["partials"] == launches["combine"] == 0,
              "a windowed pass ran on the dense route")
        check(launches["topk"] == launches["topk_select"] == n_points,
              f"dense top-k launches {launches} != one select a point")
        check([ep for ep, _ in out] == list(EvalGrid.engine_params_list)
              and all([ei.fold for ei, _ in sets] == [0] for _, sets in out),
              "the dense batch_eval did not answer fold 0 for every point")
        td = reads.calls[0][2][0][0]
        check(all(np.array_equal(getattr(td, a), getattr(td0, a))
                  for a in ("rows", "cols", "vals")), "fold 0 read twice differs")
        check(all(np.isfinite(s.score) for _, sets in out for _, qpa in sets
                  for _, p, _ in qpa for s in p.item_scores), "non-finite dense scores")
        ctx = RuntimeContext()
        for n, ((rank, it, lam), got) in enumerate(zip(EVAL_GRID, grids.calls[0][2])):
            check(_finite(got), f"dense point {n}: non-finite factors")
            ref = ALSAlgorithm(ALSAlgorithmParams(rank=rank, num_iterations=it, lambda_=lam)
                               ).train(ctx, td0).factors
            check(_bit_equal(got, ref), f"dense point {n}: train_grid != a serial train")
    finally:
        if saved is None:
            os.environ.pop("PIO_DENSE_ALS", None)
        else:
            os.environ["PIO_DENSE_ALS"] = saved
    return {"staged": sd.calls[0][2], "staging_s": sd.calls[0][0],
            "read_eval_s": reads.calls[0][0], "train_grid_s": grids.calls[0][0],
            "batch_eval_s": batch_s, "launches": launches}


def _eval_kernels_held(staged_w, staged_d):
    """block_partials with the combine on fold 0's two windowed plans, and
    the row and col passes on the forced-dense grid's staged int8 R, at
    each rank of the grid, held to their plain versions on the card as
    phases 5 and 16 hold them (the scored top-k is held by the answers)."""
    rng = np.random.default_rng(SEED + 10)
    ranks = sorted({rank for rank, _, _ in EVAL_GRID})
    w_tally = {"cases": 0, "max_abs_err": 0.0, "max_ratio": 0.0,
               "combined_max_abs_err": 0.0, "combined_max_ratio": 0.0}
    d_tally = {w: {"cases": 0, "max_abs_err": 0.0, "max_ratio": 0.0} for w in ("row", "col")}
    for k in ranks:
        _windowed_held(staged_w, k, rng, w_tally, "eval fold 0")
        _dense_held(staged_d, k, rng, d_tally, "eval fold 0")
    return {"ranks": ranks, "windowed": w_tally, "dense": d_tally,
            "dense_r": list(staged_d.device_args[0].shape)}


def _dense_held(staged_d, k, rng, tally, label):
    """The row and col passes on a staged dense train's R, with random
    factors of rank `k` and the train's own weights, held to their plain
    versions on the card (`_dense_compare`)."""
    r, kw = staged_d.device_args[0], staged_d.static_kwargs
    ascale = float(np.float32(kw["alpha"] / kw["scale"] if kw["implicit"]
                              else 1.0 / kw["scale"]))
    for which, n_side in (("row", r.shape[1]), ("col", r.shape[0])):
        x = torch.from_numpy((rng.standard_normal((n_side, k))
                              / np.sqrt(k)).astype(np.float32)).cuda()
        _dense_compare(r, x, ascale, kw["implicit"], which, tally,
                       f"{label} {staged_d.dense_dtype} R {tuple(r.shape)} {which} K={k}")


def _windowed_held(staged_w, k, rng, tally, label):
    """block_partials with the combine on a staged windowed train's two
    plans, with random factors of rank `k`, held to their plain versions
    on the card (`_windowed_compare`)."""
    args, kw = staged_w.device_args, staged_w.static_kwargs
    sides = (("users", args[0:5], kw["n_item_windows"], kw["n_user_windows"]),
             ("items", args[5:10], kw["n_user_windows"], kw["n_item_windows"]))
    for name, (src, val, ok, loc, bwin), src_windows, n_windows in sides:
        w_b, w_g = _implicit_weights(val, ok, kw["alpha"])
        f = torch.from_numpy((rng.standard_normal((src_windows * win.WINDOW_ROWS, k))
                              / np.sqrt(k)).astype(np.float32)).cuda()
        _windowed_compare((f, src, w_b.contiguous(), w_g.contiguous(), loc), bwin,
                          n_windows, tally, f"{label} {name} plan K={k}")


# ---------------------------------------------------------------------------
# phase 11: the model lifecycle over the loop's storage
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 10b: the fleet evaluation, `tune`, the offline prior, UR self-cleaning
# ---------------------------------------------------------------------------


FLEET_ENGINE, TUNE_ENGINE = "ml1m-fleet", "ml1m-tune"
FLEET_WORKERS = 5  # one a fold shard: the five children in one wave
FLEET_FACTORY = "predictionio_tpu_torch.engines.recommendation.RecommendationEngine"
FLEET_METRIC = {"class": "predictionio_tpu_torch.engines.recommendation.engine.PrecisionAtK",
                "params": {"k": EVAL_PRECISION_K}}
FLEET_BAKE_S = 60.0  # the canary's asked bake in (c); the prior doubles it
UR_CLEAN_PROPERTY_ITEMS = 2_000  # items given $set/$unset/$delete histories
UR_CLEAN_DUPLICATES, UR_CLEAN_OLD = 5_000, 3_000  # copies; events past the window
UR_CLEAN_QUERIES = 64
UR_CLEAN_USERS = 1_000  # (d)'s store: the buys and views of the first 1,000 of the 3,000 users
_SHARD_LAUNCHES = re.compile(
    r"kernel launches: dense row (\d+), col (\d+); windowed partials (\d+), combine "
    r"(\d+); top-k (\d+) \(select (\d+), sort (\d+)\) on (\S+)")


def _children_import_this_checkout():
    """Job children run `python -m predictionio_tpu_torch...`: they import
    this checkout wherever the script was started from."""
    root = str(Path(__file__).resolve().parent)
    paths = [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    if root not in paths:
        os.environ["PYTHONPATH"] = os.pathsep.join([root] + paths)


def _als_variant(engine, rank, iterations, lam, **datasource):
    """The template's variant at one point; its children read the loop's
    events through the data view (`use_data_view`): the first child
    folds the store into the view's npz, the others load that frame."""
    return {"id": engine, "engineFactory": FLEET_FACTORY,
            "datasource": {"params": {"app_name": LOOP_APP, "event_names": ["rate"],
                                      "use_data_view": True, **datasource}},
            "algorithms": [{"name": "als", "params": {
                "rank": rank, "num_iterations": iterations, "lambda_": lam}}]}


def _fleet_spec(engine, folds, points=EVAL_GRID):
    """Phase 10's grid as an EvalSpec: its read_eval params (and the data
    view, whose frame is the store's), the axes that span `points` in
    EVAL_GRID's order, Precision@k by the template's own metric class."""
    return {"variant": _als_variant(engine, *EVAL_GRID[0], eval_k=EVAL_FOLDS,
                                    goal_threshold=EVAL_THRESHOLD, eval_num=EVAL_NUM),
            "axes": [{"path": f"algorithms.0.params.{name}",
                      "values": sorted({p[n] for p in points})}
                     for n, name in enumerate(("rank", "num_iterations", "lambda_"))],
            "metric": FLEET_METRIC, "folds": folds}


def _spec_points(points):
    """The grid an EvalSpec of `points` runs: the product of its axes, in
    the spec's order (EVAL_GRID's own for all of it)."""
    axes = [sorted({p[n] for p in points}) for n in range(3)]
    return [(r, it, lam) for r in axes[0] for it in axes[1] for lam in axes[2]]


def _shard_launches(queue, run, grid=EVAL_GRID):
    """Each shard job of `run` (over `grid`): completed, and the kernel
    launches its child's log names, on the card; returns {job id:
    counts}."""
    out = {}
    for job_id, meta in run.shards.items():
        job = queue.get(job_id)
        check(job is not None and job.kind == "eval" and job.status == "completed",
              f"shard {job_id}: {job and (job.kind, job.status, job.last_error)}")
        m = _SHARD_LAUNCHES.search(_job_log(job, job.attempt))
        check(m is not None, f"shard {job_id}: no launch line in its log")
        *counts, device = m.groups()
        check(device == "cuda:0", f"shard {job_id} ran on {device}, not the card")
        row, col, partials, combine, topk, select, sort = map(int, counts)
        points = meta["point_indices"]
        folds = EVAL_FOLDS if meta["fold"] is None else 1  # a fold, or all of them
        want_pass = folds * 2 * sum(grid[i][1] for i in points)
        check(partials == combine == want_pass and row == col == 0,
              f"shard {job_id}: launches row/col {row}/{col}, partials/combine "
              f"{partials}/{combine} != 2 x iterations x folds ({want_pass}) on the "
              "windowed route")
        check(topk == select == folds * len(points) and sort == 0,
              f"shard {job_id}: top-k {topk} (select {select}, sort {sort}) != one "
              f"select a (fold, point) ({folds * len(points)})")
        wall = (datetime.datetime.fromisoformat(job.finished_at)
                - datetime.datetime.fromisoformat(job.started_at)).total_seconds()
        out[job_id] = {"worker": job.worker_id, "attempt": job.attempt,
                       "partials": partials, "combine": combine, "topk": topk,
                       "select": select, "wall_s": wall}
    return out


def phase_fleet_eval(report, shared):
    """Phase 10b: phase 10's grid as a fleet evaluation over the loop's
    storage (shard children on the card), `tune` and its preset retrain,
    the offline prior, and the UR's self-cleaning."""
    t_phase = time.perf_counter()
    _children_import_this_checkout()
    fl: dict = {}
    parts, t0 = {}, time.perf_counter()

    def part(name):
        nonlocal t0
        parts[name], t0 = time.perf_counter() - t0, time.perf_counter()

    with _loop_storage():
        storage = Storage()
        queue = JobQueue(storage)
        fl["a"] = _fleet_run(report, storage, queue)
        part("a")
        fl["b"] = _fleet_tune(report, storage, queue, fl["a"])
        part("b")
        fl["c"] = _fleet_prior(storage, fl["b"])
        part("c")
        _fleet_cleanup(storage, queue)
        part("cleanup")
    fl["d"] = _ur_self_cleaning()
    part("d")
    fl["parts_s"] = parts
    fl["phase_s"] = time.perf_counter() - t_phase
    fl["nvidia_smi"] = smi = report["nvidia_smi"]
    report["fleet_eval"] = fl
    a, b, c, d = fl["a"], fl["b"], fl["c"], fl["d"]
    print(f"[fleet eval] {smi} | (a) eval run {a['run']}: {a['points']} points, "
          f"{a['groups']} group x {a['folds']} folds = {len(a['shards'])} shard children "
          f"on the card under {FLEET_WORKERS} local workers in {a['wall_s']:.2f} s (shard "
          f"s {', '.join(f'{v['wall_s']:.2f}' for v in a['shards'].values())}); every "
          f"point within {a['max_abs_diff']:.3g} of phase 10's MetricEvaluator, winner "
          f"point {a['winner']}; launches partials/combine {a['launches']['partials']}/"
          f"{a['launches']['combine']}, select {a['launches']['topk']}", flush=True)
    print(f"[fleet eval] {smi} | (b) tune run {b['run']}: {b['points']} points (the space "
          f"of (a)'s winner and worst point), 1 shard of all folds in "
          f"{b['wall_s']:.2f} s, winner point {b['winner']} parked; periodic job {b['job_a']} "
          f"trained point {b['point_a']} in {b['job_a_s']:.2f} s, its next run "
          f"{b['job_n']} the preset in {b['job_n_s']:.2f} s (dense launches "
          f"{b['launches_n']['row']}/{b['launches_n']['col']}), version {b['version_n']} "
          f"linked to the run; the dashboard shows both", flush=True)
    print(f"[fleet eval] {smi} | (c) offline prior: candidate {c['candidate']} "
          f"({c['candidate_score']:.6g}) below live {c['live']} ({c['live_score']:.6g}): "
          f"bake {c['bake_stretched']:g} s for {FLEET_BAKE_S:g} asked; with "
          f"PIO_TUNE_PRIOR=0 {c['bake_off']:g} s", flush=True)
    print(f"[fleet eval] {smi} | (d) UR self-cleaning of {d['events']} events: "
          f"{d['counters']} in {d['clean_s']:.2f} s (as the plain numpy cleaning "
          f"predicts); tables of the card train on the cleaned store vs on the plainly "
          f"cleaned events: max |dv| {d['max_abs_diff']:.3g}, {d['index_mismatches']} "
          f"index mismatches (atol {d['atol']:.3g}); {UR_CLEAN_QUERIES} queries through "
          f"masked_select ({d['launches']} launches) equal to the plain version; phase "
          f"{fl['phase_s']:.1f} s (s by part: "
          f"{', '.join(f'{k} {v:.2f}' for k, v in fl['parts_s'].items())})", flush=True)


def _fleet_run(report, storage, queue):
    """(a) `eval run spec.json --local-workers 5`: every point's score held
    to phase 10's MetricEvaluator score (1e-5), the same winner, each
    shard child's launches; `eval list`, `eval status`, GET /evals/<run>."""
    spec_path = LOOP_DIR / "fleet_spec.json"
    spec_path.write_text(json.dumps(_fleet_spec(FLEET_ENGINE, EVAL_FOLDS)))
    t0 = time.perf_counter()
    rc, out = _console_out(["eval", "run", str(spec_path), "--local-workers",
                            str(FLEET_WORKERS), "--timeout", "900"])
    wall = time.perf_counter() - t0
    check(rc == 0, f"eval run exited {rc}")
    run_id = re.search(r"eval-[0-9a-f]{12}", out).group()
    driver = EvalDriver(storage)
    run = driver.records.get_run(run_id)
    check(run.status == "completed" and run.num_points == len(EVAL_GRID)
          and run.num_groups == 1 and run.num_folds == EVAL_FOLDS
          and len(run.shards) == run.num_groups * EVAL_FOLDS,
          f"run {run_id}: {run.status}, {run.num_points} points, {run.num_groups} groups, "
          f"{len(run.shards)} shards ({run.last_error})")
    scores = driver.scores(run)
    check([tuple(s["params"]["algorithms"][0]["params"][k] for k in
                 ("rank", "num_iterations", "lambda_")) for s in scores] == list(EVAL_GRID),
          "the fleet's points are not phase 10's grid in its order")
    ev = report["eval"]
    diffs = [abs(s["score"] - want) for s, want in zip(scores, ev["scores"])]
    check(all(s["complete"] for s in scores) and max(diffs) <= 1e-5,
          f"fleet scores {[s['score'] for s in scores]} vs MetricEvaluator "
          f"{ev['scores']}: largest difference {max(diffs):.3g} > 1e-5")
    check(run.winner_index == ev["best_index"],
          f"fleet winner {run.winner_index} != MetricEvaluator's {ev['best_index']}")
    shards = _shard_launches(queue, run)
    launches = {k: sum(v[k] for v in shards.values())
                for k in ("partials", "combine", "topk")}
    n_it = sum(it for _, it, _ in EVAL_GRID)
    check(launches["partials"] == EVAL_FOLDS * 2 * n_it
          and launches["topk"] == EVAL_FOLDS * len(EVAL_GRID),
          f"fleet launches {launches}")
    rc, listing = _console_out(["eval", "list", "--status", "completed"])
    check(rc == 0 and run_id in listing, f"eval list lacks {run_id}")
    rc, status_out = _console_out(["eval", "status", run_id])
    check(rc == 0 and f"progress   {len(EVAL_GRID)}/{len(EVAL_GRID)} points" in status_out
          and status_out.count("completed") == 1 + len(run.shards),
          "eval status does not show every point and shard done")
    admin = AdminServer(storage, ip="127.0.0.1", port=0)
    port = admin.start()
    try:
        code, body = _call(port, "GET", f"/evals/{run_id}")
        code_all, listing_body = _call(port, "GET", "/evals")
    finally:
        admin.stop()
    check(code == 200 and body == json.loads(json.dumps(driver.status(run_id))),
          f"GET /evals/{run_id}: {code}, not the eval driver's status")
    check(code_all == 200 and run_id in [r["id"] for r in listing_body], "GET /evals")
    return {"run": run_id, "points": run.num_points, "groups": run.num_groups,
            "folds": run.num_folds, "wall_s": wall, "scores": [s["score"] for s in scores],
            "max_abs_diff": max(diffs), "winner": run.winner_index,
            "winner_score": run.winner_score, "shards": shards, "launches": launches,
            "workers": sorted({v["worker"] for v in shards.values()})}


def _fleet_tune(report, storage, queue, a):
    """(b) `tune` with folds 0 (one shard of all folds) over the space
    that (a)'s winner and worst point span: its scores (a)'s, its winner
    (a)'s and parked as ml1m-tune's preset; a periodic job of the worst
    point trains, its next run trains the preset in a child on the card
    and links its version to the run; the dashboard's panel shows the run
    and the link."""
    worst = int(np.argmin(a["scores"]))
    check(worst != a["winner"], "the grid has no point worse than its winner")
    span = [EVAL_GRID[a["winner"]], EVAL_GRID[worst]]
    grid = _spec_points(span)
    spec_path = LOOP_DIR / "tune_spec.json"
    spec_path.write_text(json.dumps(_fleet_spec(TUNE_ENGINE, 0, span)))
    t0 = time.perf_counter()
    rc, out = _console_out(["tune", str(spec_path), "--local-workers", "1",
                            "--timeout", "900"])
    wall = time.perf_counter() - t0
    check(rc == 0, f"tune exited {rc}")
    run_id = re.search(r"eval-[0-9a-f]{12}", out).group()
    records = EvalRecordStore(storage)
    run = records.get_run(run_id)
    check(run.status == "completed" and len(run.shards) == 1 and run.num_folds == 1
          and run.num_points == len(grid),
          f"tune run {run_id}: {run.status}, {len(run.shards)} shards, {run.num_points} points")
    shards = _shard_launches(queue, run, grid)
    scores = EvalDriver(storage).scores(run)
    check([tuple(s["params"]["algorithms"][0]["params"][k] for k in
                 ("rank", "num_iterations", "lambda_")) for s in scores] == grid,
          "the tune's points are not the spanned space in EVAL_GRID's order")
    tuned = [s["score"] for s in scores]
    want = [a["scores"][EVAL_GRID.index(p)] for p in grid]
    check(max(abs(x - y) for x, y in zip(tuned, want)) <= 1e-5
          and grid[run.winner_index] == EVAL_GRID[a["winner"]],
          f"tune scores {tuned} / winner {grid[run.winner_index]} differ from (a)'s "
          f"{want} / {EVAL_GRID[a['winner']]}")
    preset = PresetStore(storage).get(TUNE_ENGINE)
    check(preset is not None and preset.run_id == run_id
          and preset.params == run.winner_params, f"preset {preset}")
    # a periodic retrain of the engine, at (a)'s worst point
    variant_a = LOOP_DIR / "tune_periodic.json"
    variant_a.write_text(json.dumps(_als_variant(TUNE_ENGINE, *EVAL_GRID[worst])))
    rc, out = _console_out(["jobs", "submit", "--variant", str(variant_a),
                            "--period", "3600"])
    check(rc == 0, f"jobs submit exited {rc}")
    job_a_id = re.search(r"job-[0-9a-f]{12}", out).group()
    t0 = time.perf_counter()
    rc, out = _console_out(["jobs", "worker", "--once", "--log-dir", str(LOOP_DIR / "jobs")])
    job_a_s = time.perf_counter() - t0
    check(rc == 0 and "ran 1 pending job(s)" in out, f"jobs worker exited {rc}: {out}")
    job_a, _inst_a, version_a = _finished_job(storage, job_a_id, 1)
    [nxt] = [j for j in queue.list(status="queued") if j.engine_id == TUNE_ENGINE]
    check(nxt.variant.get("evalRun") == run_id
          and nxt.variant["algorithms"] == run.winner_params["algorithms"]
          and nxt.not_before > time.time() + 3000,
          f"the next periodic run does not carry the preset: {nxt.variant}")
    queue.update(nxt.id, not_before=0.0)  # its period, elapsed
    t0 = time.perf_counter()
    rc, out = _console_out(["jobs", "worker", "--once", "--log-dir", str(LOOP_DIR / "jobs")])
    job_n_s = time.perf_counter() - t0
    check(rc == 0 and "ran 1 pending job(s)" in out, f"jobs worker exited {rc}: {out}")
    job_n, inst_n, version_n = _finished_job(storage, nxt.id, 1)
    launches_n, _segments, _dtype = _job_launches(job_n, 1)
    rank, iterations, lam = grid[run.winner_index]
    check(launches_n[:2] == (iterations, iterations) and launches_n[2:] == (0, 0),
          f"the preset retrain's launches {launches_n} != {iterations} a pass")
    trained = json.loads(inst_n.algorithms_params)[0]["params"]
    check((trained["rank"], trained["num_iterations"], trained["lambda_"])
          == (rank, iterations, lam), f"the preset retrain trained {trained}")
    linked = records.get_run(run_id)
    check(version_n.id in linked.links and linked.winner_model_version == version_n.id
          and linked.links[version_n.id]["job_id"] == nxt.id,
          f"run {run_id} links {linked.links}")
    from predictionio_tpu_torch.tools.dashboard import Dashboard

    dash = Dashboard(storage, ip="127.0.0.1", port=0)
    port = dash.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/")
        page = conn.getresponse().read().decode()
        conn.close()
    finally:
        dash.stop()
    panel = page[page.index("<h1>Fleet evaluations</h1>"):page.index("<h1>Tenants</h1>")]
    check(run_id in panel and version_n.id in panel and a["run"] in panel,
          "the dashboard's fleet-evaluation panel lacks the runs or the lineage link")
    return {"run": run_id, "wall_s": wall, "winner": EVAL_GRID.index(grid[run.winner_index]),
            "points": len(grid), "shards": shards,
            "launches": {k: sum(v[k] for v in shards.values())
                         for k in ("partials", "combine", "topk")},
            "point_a": worst, "job_a": job_a_id, "job_a_s": job_a_s,
            "version_a": version_a.id, "instance_a": job_a.instance_id,
            "launches_a": dict(zip(("row", "col", "partials", "combine"),
                                   _job_launches(job_a, 1)[0])),
            "job_n": nxt.id, "job_n_s": job_n_s, "version_n": version_n.id,
            "instance_n": inst_n.id,
            "launches_n": dict(zip(("row", "col", "partials", "combine"), launches_n)),
            "score_a": a["scores"][worst], "score_n": run.winner_score,
            "metric_header": run.metric_header}


def _fleet_prior(storage, b):
    """(c) The offline prior through a canary on a query server of the
    preset's model (live): a candidate of (b)'s worst point, linked to a
    completed one-point run with that point's score from (a), gets its
    bake doubled (PIO_TUNE_STRICT_BAKE's default); with PIO_TUNE_PRIOR=0
    it keeps the bake it asked for."""
    registry = ModelRegistry(storage)
    registry.promote(b["version_n"])
    records = EvalRecordStore(storage)
    low = records.create_run(TUNE_ENGINE, {"metric": FLEET_METRIC}, 1, 1, 1,
                             b["metric_header"])
    records.update_run(low.id, status="completed", finished_at=time.time(),
                       winner_index=0, winner_score=b["score_a"])
    inst_a = storage.get_meta_data_engine_instances().get(b["instance_a"])
    inst_n = storage.get_meta_data_engine_instances().get(b["instance_n"])
    server = QueryServer(runtime=build_runtime(storage, inst_n), storage=storage,
                         config=QueryServerConfig(ip="127.0.0.1", port=0))
    port = server.start()
    bakes, candidates = [], []
    saved = os.environ.get("PIO_TUNE_PRIOR")
    try:
        for prior in ("1", "0"):
            os.environ["PIO_TUNE_PRIOR"] = prior
            candidate = registry.register(inst_a)  # a fresh trained version
            candidates.append(candidate.id)
            records.link_model_version(low.id, candidate.id)
            code, body = _call(port, "POST", "/rollout/start", {
                "version": candidate.id, "fraction": 0.1, "bake_s": FLEET_BAKE_S})
            check(code == 200, f"rollout start: {code} {body}")
            code, status = _call(port, "GET", "/rollout/status")
            bakes.append(status["config"]["bake_s"])
            code, body = _call(port, "POST", "/rollout/abort", {"reason": "prior check"})
            check(code == 200, f"rollout abort: {code} {body}")
    finally:
        if saved is None:
            os.environ.pop("PIO_TUNE_PRIOR", None)
        else:
            os.environ["PIO_TUNE_PRIOR"] = saved
        server.stop()
    check(b["score_a"] < b["score_n"] and bakes == [2 * FLEET_BAKE_S, FLEET_BAKE_S],
          f"bakes {bakes} (candidate {b['score_a']}, live {b['score_n']})")
    return {"candidate": candidates[0], "candidates": candidates,
            "candidate_score": b["score_a"],
            "live": b["version_n"], "live_score": b["score_n"],
            "bake_stretched": bakes[0], "bake_off": bakes[1], "low_run": low.id}


def _fleet_cleanup(storage, queue):
    """The phase's jobs, versions, rollout records and preset go, so that
    the lifecycle phase's queue and registry checks see only their own."""
    for job in queue.list():
        if job.engine_id in (FLEET_ENGINE, TUNE_ENGINE):
            queue.purge(job.id)
    records = LifecycleRecordStore(storage)
    for v in ModelRegistry(storage).list(engine_id=TUNE_ENGINE):
        records.purge("pio_model_version", v.id)
    for scope in list(records.fold("pio_rollout")):
        if scope.startswith(TUNE_ENGINE):
            records.purge("pio_rollout", scope)
    PresetStore(storage).clear(TUNE_ENGINE)


def _ur_dirt(rng, n_base):
    """Dirt for the UR configuration's events, from `rng`: $set/$unset/
    $delete histories of UR_CLEAN_PROPERTY_ITEMS items (1-4 events each,
    equal times among them), UR_CLEAN_DUPLICATES exact copies of base
    events after them, UR_CLEAN_OLD buys and views 90 days before UR_T0.
    Returns (special events, duplicate base indices, old (event, user,
    item) rows)."""
    special = []
    items = rng.choice(UR_ITEMS, UR_CLEAN_PROPERTY_ITEMS, replace=False)
    for n, item in enumerate(items.tolist()):
        for k in range(int(rng.integers(1, 5))):
            kind = ("$set", "$set", "$unset", "$delete")[int(rng.integers(4))]
            props = ({} if kind == "$delete" else
                     {"price": None} if kind == "$unset" else
                     {"category": f"c{int(rng.integers(20))}",
                      "price": int(rng.integers(1, 500))})
            special.append(Event(
                event=kind, entity_type="item", entity_id=f"i{item}", properties=props,
                event_time=UR_T0 + datetime.timedelta(milliseconds=n_base + 2 * n + k // 2),
                event_id=f"p{n:05d}{k}"))
    dups = rng.integers(0, n_base, UR_CLEAN_DUPLICATES)
    old = [(("buy", "view")[int(rng.integers(2))], int(rng.integers(UR_USERS)),
            int(rng.integers(UR_ITEMS))) for _ in range(UR_CLEAN_OLD)]
    return special, dups, old


def _ur_self_cleaning():
    """(d) The UR configuration's buys and views of its first
    UR_CLEAN_USERS users (phase 21's, from UR_SEED, in a store of their
    own) with dirt added, cleaned by `URDataSource`'s
    event window, then trained on the card: the counters and survivors
    against a plain numpy cleaning, the tables against a card train on
    the plainly cleaned events, and answers through masked_select
    against the plain version."""
    t0 = time.perf_counter()
    buy_users, buy_items, view_users, view_items = _ur_arrays()
    buys, views = buy_users < UR_CLEAN_USERS, view_users < UR_CLEAN_USERS
    rows = _ur_rows(buy_users[buys], buy_items[buys], view_users[views], view_items[views])
    n_base = len(rows)
    special, dups, old = _ur_dirt(np.random.default_rng(UR_SEED + 7), n_base)
    events = [Event(event=e, entity_type="user", entity_id=f"u{u}",
                    target_entity_type="item", target_entity_id=f"i{i}",
                    event_time=UR_T0 + datetime.timedelta(milliseconds=n),
                    event_id=f"e{n:08d}") for n, (e, u, i) in enumerate(rows)]
    first_dup = n_base + 2 * UR_CLEAN_PROPERTY_ITEMS + 10
    events += [Event(event=events[j].event, entity_type="user",
                     entity_id=events[j].entity_id, target_entity_type="item",
                     target_entity_id=events[j].target_entity_id,
                     event_time=UR_T0 + datetime.timedelta(milliseconds=first_dup + k),
                     event_id=f"d{k:07d}") for k, j in enumerate(dups.tolist())]
    events += [Event(event=e, entity_type="user", entity_id=f"u{u}",
                     target_entity_type="item", target_entity_id=f"i{i}",
                     event_time=UR_T0 - datetime.timedelta(days=90, milliseconds=k),
                     event_id=f"o{k:07d}") for k, (e, u, i) in enumerate(old)]
    storage, app_id = _ur_store()
    storage.get_events().insert_batch(events + special, app_id)
    build_s = time.perf_counter() - t0

    # the plain numpy cleaning of the same events
    now = datetime.datetime.now(datetime.timezone.utc)
    days = (now - UR_T0).days + 30
    cutoff_ms = ((now - datetime.timedelta(days=days)) - UR_T0).total_seconds() * 1e3
    code = np.array([e.event == "view" for e in events], np.int64)
    user = np.array([int(e.entity_id[1:]) for e in events], np.int64)
    item = np.array([int(e.target_entity_id[1:]) for e in events], np.int64)
    t_ms = np.array([(e.event_time - UR_T0).total_seconds() * 1e3 for e in events])
    check(len(np.unique(t_ms)) == len(events), "event times are not distinct")
    order = np.argsort(t_ms, kind="stable")
    key = (code * UR_USERS + user) * UR_ITEMS + item
    _, first = np.unique(key[order], return_index=True)
    keep = np.zeros(len(events), bool)
    keep[order[first]] = True
    aged = keep & (t_ms < cutoff_ms)
    survivors = keep & ~aged
    per_item = np.unique([e.entity_id for e in special], return_counts=True)[1]
    want = {"compacted": int(per_item[per_item > 1].sum()),
            "deduplicated": int(len(events) - len(first)), "aged_out": int(aged.sum())}
    props_before = aggregate_properties(special)

    window = {"duration": f"{days} days", "remove_duplicates": True,
              "compress_properties": True}
    source = URDataSource(URDataSourceParams(UR_APP, ("buy", "view"), event_window=window))
    ctx = RuntimeContext(storage=storage)
    t0 = time.perf_counter()
    counters = source.clean_persisted_events(ctx)
    clean_s = time.perf_counter() - t0
    check(counters == want, f"self-cleaning counters {counters} != the plain cleaning's {want}")
    left = list(storage.get_events().find(EventQuery(app_id=app_id)))
    regular = {e.event_id for e in left if not e.event.startswith("$")}
    check(regular == {events[n].event_id for n in np.flatnonzero(survivors)},
          "the surviving buys and views are not the plain cleaning's")
    props_after = aggregate_properties(e for e in left if e.event.startswith("$"))
    check({k: v.to_dict() for k, v in props_after.items()}
          == {k: v.to_dict() for k, v in props_before.items()}
          and sum(e.event.startswith("$") for e in left) <= len(per_item),
          "the compaction changed an item's properties or left a history")
    check(source.clean_persisted_events(ctx) == dict.fromkeys(want, 0),
          "a second clean found more to do")

    # the card train on the cleaned store, and on the plainly cleaned events
    params = URAlgorithmParams(app_name=UR_APP)
    model = URAlgorithm(params).train(ctx, source.read_training(ctx))
    plain_storage, plain_app = _ur_store()
    plain_storage.get_events().insert_batch(
        [events[n] for n in np.flatnonzero(survivors)], plain_app)
    plain_ctx = RuntimeContext(storage=plain_storage)
    plain_td = URDataSource(URDataSourceParams(UR_APP, ("buy", "view"))).read_training(plain_ctx)
    plain = URAlgorithm(params).train(plain_ctx, plain_td)
    check(model.device.type == "cuda" and plain.device.type == "cuda",
          f"the UR models are on {model.device} and {plain.device}")
    check(model.item_vocab.to_dict() == plain.item_vocab.to_dict(), "item vocabularies differ")
    dv_max, bad_all = 0.0, 0
    for m, p in zip(model.indicator_models, plain.indicator_models):
        check(m.target_vocab.to_dict() == p.target_vocab.to_dict(), f"{m.name}: vocabularies")
        dv, bad, atol, _ = _correlators_close((p.correlator_scores, p.correlator_idx),
                                              (m.correlator_scores, m.correlator_idx),
                                              plain_td.n_users)
        check(dv <= atol and bad == 0, f"{m.name}: tables beyond the LLR bar ({dv}, {bad})")
        dv_max, bad_all = max(dv_max, dv), bad_all + bad

    # a few queries on the card through masked_select, held to the plain version
    qrng = np.random.default_rng(UR_SEED + 8)
    queries = [URQuery(user=f"u{int(u)}", num=int(qrng.choice([5, 10, 50])),
                       exclude_seen=bool(qrng.random() < 0.9))
               for u in qrng.integers(0, UR_CLEAN_USERS, UR_CLEAN_QUERIES)]
    algo = URAlgorithm(params)
    rec.MASKED_LAUNCHES = 0  # counts from 0 around the served queries
    rec.MASKED_ROUTE_LAUNCHES.update(select=0, sort=0)
    got = algo._predict_batch(RuntimeContext(storage=storage, mode="serve"), model, queries)
    launches, select = rec.MASKED_LAUNCHES, rec.MASKED_ROUTE_LAUNCHES["select"]
    cpu_model = URModel(model.item_vocab, model.indicator_models, model.primary_indicator,
                        device="cpu")
    want_answers = algo._predict_batch(RuntimeContext(storage=storage, mode="serve",
                                                      device="cpu"), cpu_model, queries)
    check([_to_jsonable(p) for p in got] == [_to_jsonable(p) for p in want_answers],
          "the cleaned UR's answers differ from the plain version on the CPU")
    check(launches == select == 1 and sum(bool(p.item_scores) for p in got) > 0,
          f"masked launches {launches} (select {select}) for one batch")
    return {"events": len(events) + len(special), "build_s": build_s, "clean_s": clean_s,
            "counters": counters, "max_abs_diff": dv_max, "index_mismatches": bad_all,
            "atol": atol, "launches": launches, "select": select,
            "items": len(model.item_vocab), "users": plain_td.n_users}


def _lifecycle_variant(**als_params):
    return {"id": LIFECYCLE_ENGINE,
            "engineFactory": "predictionio_tpu_torch.engines.recommendation."
                             "RecommendationEngine",
            # the data view: a child reads the frame phase 10b's eval
            # children cached, or the one job 2's read (after the delta)
            # cached for job 3's attempts, instead of the whole app
            "datasource": {"params": {"app_name": LOOP_APP, "event_names": ["rate"],
                                      "use_data_view": True}},
            "algorithms": [{"name": "als", "params": {
                "checkpoint_every": LIFECYCLE_CHECKPOINT_EVERY, **als_params}}]}


def _lifecycle_delta(rng, users, items):
    """The new `rate` events as (user ids, item ids, ratings, times): new
    users on existing movies, new movies by existing users, and existing
    users on movies they had not rated; no pair repeats one in the app."""
    have = set((users * LOOP_ITEMS + items).tolist())
    du, di = [], []
    for n in range(LIFECYCLE_NEW_USERS):
        for i in rng.choice(LOOP_ITEMS, LIFECYCLE_NEW_USER_RATINGS, replace=False):
            du.append(f"u{LOOP_USERS + n}")
            di.append(f"i{i}")
    for n in range(LIFECYCLE_NEW_ITEMS):
        for u in rng.choice(LOOP_USERS, LIFECYCLE_NEW_ITEM_RATINGS, replace=False):
            du.append(f"u{u}")
            di.append(f"i{LOOP_ITEMS + n}")
    for u in rng.choice(LOOP_USERS, LIFECYCLE_OLD_USERS, replace=False):
        fresh = [i for i in rng.permutation(LOOP_ITEMS) if u * LOOP_ITEMS + i not in have]
        for i in fresh[:LIFECYCLE_OLD_USER_RATINGS]:
            du.append(f"u{u}")
            di.append(f"i{i}")
    n = len(du)
    t0 = LOOP_T0_MS + 1000 * (LOOP_EDGES + 1)  # after every loop rating
    return du, di, rng.integers(1, 6, n), t0 + 1000 * rng.permutation(n)


def _job_sections(job):
    """A job's log by attempt: {attempt: (spawned at, its text)}; the
    supervisor writes each attempt's header, with the UTC time, just
    before it spawns the child."""
    text = Path(job.log_path).read_text(errors="replace")
    parts = re.split(r"^--- attempt (\d+) \((\S+)\) ---$", text, flags=re.M)
    return {int(a): (datetime.datetime.fromisoformat(t), body)
            for a, t, body in zip(parts[1::3], parts[2::3], parts[3::3])}


def _job_log(job, attempt):
    """One attempt's section of a job's log."""
    sections = _job_sections(job)
    check(attempt in sections, f"job {job.id}: no attempt {attempt} in its log")
    return sections[attempt][1]


def _log_lines(section):
    """The child's logging lines of a log section as (UTC time, message);
    the child stamps them in local time to the millisecond."""
    out = []
    for m in re.finditer(r"^(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3}) \w+ \S+: (.*)$",
                         section, flags=re.M):
        local = datetime.datetime.strptime(m.group(1), "%Y-%m-%d %H:%M:%S,%f")
        out.append((local.astimezone(datetime.timezone.utc), m.group(2)))
    return out


def _log_figures(job, attempt, inst):
    """From one attempt's log, on the host's clock: the child's start
    (its spawn to its first log line, which follows the read, less the
    instance's read seconds), and for each segment its set-up (the log
    line before its `staged` line to that line: the dense gate and the
    staging) and its run (the `staged` line to the next line: the
    segment's iterations and its checkpoint save)."""
    spawned, section = _job_sections(job)[attempt]
    lines = _log_lines(section)
    check(bool(lines), f"job {job.id}: no timed lines in attempt {attempt}'s log")
    first = (lines[0][0] - spawned).total_seconds()
    setup, run = [], []
    for n, (t, msg) in enumerate(lines):
        if msg.startswith("ALS train staged") and 0 < n < len(lines) - 1:
            setup.append((t - lines[n - 1][0]).total_seconds())
            run.append((lines[n + 1][0] - t).total_seconds())
    return {"spawn_to_first_line_s": first,
            "child_start_s": first - stage_timings(inst)["read"],
            "segment_setup_s": setup, "segment_run_s": run}


def _job_launches(job, attempt):
    """(row, col, partials, combine) launches the attempt's child wrote,
    and how many segments it staged, each a StagedDenseTrain."""
    section = _job_log(job, attempt)
    m = re.search(r"kernel launches: dense row (\d+), col (\d+); windowed partials "
                  r"(\d+), combine (\d+)", section)
    check(m is not None, f"job {job.id}: no launch line in its log")
    staged = re.findall(r"ALS train staged (\w+) \((\w+) R\)", section)
    check(bool(staged) and all(c == "StagedDenseTrain" for c, _ in staged),
          f"job {job.id}: staged {staged}, not StagedDenseTrain")
    return tuple(int(x) for x in m.groups()), len(staged), staged[0][1]


def _job_times(job, inst):
    wait = (datetime.datetime.fromisoformat(job.started_at)
            - datetime.datetime.fromisoformat(job.created_at)).total_seconds()
    wall = (datetime.datetime.fromisoformat(job.finished_at)
            - datetime.datetime.fromisoformat(job.started_at)).total_seconds()
    return {"queue_wait_s": wait, "started_to_finished_s": wall,
            "stages": stage_timings(inst)}


def _pids_naming(marker):
    """The pids of the processes whose command line names `marker`, as
    an operator would find a job's child (`pgrep -f`)."""
    pids = []
    for d in Path("/proc").iterdir():
        if d.name.isdigit():
            try:
                cmdline = (d / "cmdline").read_bytes()
            except OSError:
                continue  # ended meanwhile
            if marker.encode() in cmdline:
                pids.append(int(d.name))
    return pids


def _blob_factors(storage, instance_id):
    [model] = deserialize_models(storage.get_model_data_models().get(instance_id).models)
    check(type(model) is ALSModel, f"MODELDATA {instance_id} holds {type(model).__name__}")
    return model


def _run_job(storage, variant_path, attempts=1):
    """`jobs submit` then `jobs worker --once` (the child on the card):
    the finished job, its instance and version, and the worker's seconds."""
    rc, out = _console_out(["jobs", "submit", "--variant", str(variant_path)])
    check(rc == 0, f"jobs submit exited {rc}")
    job_id = re.search(r"job-[0-9a-f]{12}", out).group()
    t0 = time.perf_counter()
    rc, out = _console_out(["jobs", "worker", "--once", "--log-dir",
                            str(LOOP_DIR / "jobs")])
    worker_s = time.perf_counter() - t0
    check(rc == 0 and "ran 1 pending job(s)" in out, f"jobs worker exited {rc}: {out}")
    return _finished_job(storage, job_id, attempts) + (worker_s,)


def _finished_job(storage, job_id, attempts):
    job = JobQueue(storage).get(job_id)
    check(job.status == "completed" and job.attempt == attempts,
          f"job {job_id}: {job.status} at attempt {job.attempt} ({job.last_error})")
    inst = storage.get_meta_data_engine_instances().get(job.instance_id)
    check(inst is not None and inst.status == "COMPLETED",
          f"job {job_id}: instance {inst and inst.status}")
    check(storage.get_model_data_models().get(f"ckpt:{inst.id}") is None,
          f"job {job_id}: checkpoint ckpt:{inst.id} left behind")
    version = ModelRegistry(storage).get(job.model_version)
    check(version is not None and version.status == "trained"
          and version.job_id == job_id and version.instance_id == inst.id,
          f"job {job_id}: version {version}")
    return job, inst, version


def _als_params(p):
    return als.ALSParams(rank=p.rank, iterations=p.num_iterations, lambda_=p.lambda_,
                         alpha=p.alpha, implicit_prefs=p.implicit_prefs,
                         cg_iterations=p.cg_iterations, seed=p.seed)


def _train_arrays(td):
    return (td.rows, td.cols, td.vals, td.n_users, td.n_items)


class _PushSink:
    """Phase 11's push ingest: a port ``Dashboard`` in this process with no
    scrape targets, ``PIO_PUSH_INGEST=1`` and a ``PIO_PUSH_TOKEN``, over a
    monitor of its own (the process monitor is put back on exit). Its URL
    goes to the job children through ``PIO_PUSH_URL``. Every payload the
    route ingests is recorded: (instance, job id, sampled_at, arrival), and
    every ship of a spool from this process (the scheduler's): (spool, its
    payload files, how many shipped). `hold` makes those ships wait."""

    ENV = ("PIO_PUSH_URL", "PIO_PUSH_TOKEN", "PIO_PUSH_INTERVAL_S", "PIO_PUSH_INGEST")

    def __init__(self, storage):
        from predictionio_tpu_torch.tools.dashboard import Dashboard

        self.saved_env = {k: os.environ.get(k) for k in self.ENV}
        self.saved_monitor, self.orig_ingest = obs_monitor._monitor, obs_push.ingest
        self.orig_ship = obs_push.ship_spool
        self.received: list = []
        self.ships: list = []
        self.lock = threading.Lock()
        self.hold = threading.Event()
        self.hold.set()
        obs_monitor._monitor = self.monitor = obs_monitor.Monitor()

        def ingest(payload, monitor=None, now=None, token=None):
            out = self.orig_ingest(payload, monitor, now, token)
            with self.lock:
                self.received.append((out["instance"], payload.get("job_id"),
                                      payload.get("sampled_at"), time.time()))
            return out

        def ship_spool(spool_dir, url, *args, **kwargs):
            check(self.hold.wait(timeout=120), "a spool ship held for 120 s")
            files = sorted(p.name for p in Path(spool_dir).glob("*.json"))
            n = self.orig_ship(spool_dir, url, *args, **kwargs)
            with self.lock:
                self.ships.append((str(spool_dir), files, n))
            return n

        obs_push.ingest, obs_push.ship_spool = ingest, ship_spool
        os.environ.update(PIO_PUSH_INGEST="1", PIO_PUSH_TOKEN=LIFECYCLE_PUSH_TOKEN,
                          PIO_PUSH_INTERVAL_S=str(LIFECYCLE_PUSH_INTERVAL_S))
        self.dash = Dashboard(storage, ip="127.0.0.1", port=0, monitor_targets="")
        self.port = self.dash.start()
        os.environ["PIO_PUSH_URL"] = f"http://127.0.0.1:{self.port}"

    def close(self):
        self.dash.stop()
        self.hold.set()
        obs_push.ingest, obs_push.ship_spool = self.orig_ingest, self.orig_ship
        obs_monitor._monitor = self.saved_monitor
        for k, v in self.saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def instances(self, job_id):
        with self.lock:
            return sorted({r[0] for r in self.received if r[1] == job_id})

    def arrivals(self, instance):
        with self.lock:
            return [r[3] for r in self.received if r[0] == instance]

    def post(self, payload, token):
        """POST a payload to the route with `token` as its push token."""
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=30)
        try:
            conn.request("POST", obs_push.PUSH_ROUTE, body=json.dumps(payload),
                         headers={"Content-Type": "application/json",
                                  obs_push.TOKEN_HEADER: token})
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read().decode() or "null")
        finally:
            conn.close()


def _spooled_train_report(spool, seen):
    """True once a payload new to `seen` in the spool carries a devprof
    report with a finished call of the dense train (the child's first
    segment). Polled often, a new file is one the child has just renamed
    into place: it is then shipping (into the refusing ingest), not
    writing, so a kill leaves no torn spool file."""
    for f in sorted(Path(spool).glob("*.json")) if Path(spool).is_dir() else ():
        if f.name in seen:
            continue
        seen.add(f.name)
        try:
            payload = json.loads(f.read_text())
        except (OSError, ValueError):
            continue  # shipped (and unlinked) meanwhile
        rows = (payload.get("devprof") or {}).get("executables") or []
        if any(r.get("name") == "als.train_dense" and r.get("invocations", 0) >= 1
               for r in rows):
            return True
    return False


def _push_refusals(port):
    """POST /telemetry/push requests the dashboard answered 403, from its
    /metrics."""
    return _own_count(port, match={"path": "/telemetry/push", "status": "403"})


def _pushed_train(sink, instance):
    """The pushed devprof report's dense train: (calls, iterations), the
    iterations its work total over one iteration's (each iteration is one
    row and one col pass launch)."""
    rep = sink.monitor.push_reports.get(instance) or {}
    row = {r["name"]: r for r in rep.get("executables", [])}.get("als.train_dense")
    check(row is not None and row["flops_per_call"] > 0,
          f"{instance}: the pushed devprof report has no als.train_dense")
    return row["invocations"], round(row["flops_total"] / row["flops_per_call"], 6)


def _lifecycle_push_checks(sink, jobs, killed, smi):
    """Phase 11's push gates: each job's children pushed a devprof report
    whose dense train matches its launch line, job 1's train spans are on
    the dashboard, each child has a push-age series; the killed attempt's
    spool shipped once by the scheduler, before the retry pushed; a wrong
    token 403."""
    mon = sink.monitor
    status = {r["instance"]: r for r in mon.push_status()}
    out = {}
    for name, (job, launches, segments) in jobs.items():
        insts = sink.instances(job.id)
        want = 2 if name == "job3" else 1
        check(len(insts) == want, f"{name}: pushes from {insts}, not {want} child(ren)")
        for inst in insts:
            check(status.get(inst, {}).get("devprof") is True,
                  f"{name}: push_status of {inst} is {status.get(inst)}")
            series = _tsdb(sink.port, name="telemetry_last_push_age_seconds",
                           labels=f"instance:{inst}")["series"]
            check(len(series) == 1 and series[0]["points"],
                  f"{name}: no telemetry_last_push_age_seconds{{instance={inst}}}")
        done = [i for i in insts if i != killed["instance"]]
        calls, iterations = _pushed_train(sink, done[0])
        check(calls == segments and iterations == launches[0] == launches[1],
              f"{name}: the pushed report's als.train_dense {calls} calls over {iterations} "
              f"iterations; the launch line row {launches[0]}, col {launches[1]}, "
              f"{segments} segments")
        out[name] = {"instances": insts, "calls": calls, "iterations": iterations,
                     "payloads": {i: len(sink.arrivals(i)) for i in insts}}
    # job 1's train.* spans, assembled by the dashboard's collector
    job1_inst = jobs["job1"][0].instance_id
    status_code, body = _call(sink.port, "GET", "/debug/traces?fleet=1&limit=0")
    check(status_code == 200 and body["collector"]["polls"] == 0,
          f"/debug/traces?fleet=1: {status_code} {body.get('collector')}")
    names = set()
    for t in body["traces"]:
        if t["root"] != "train":
            continue
        _, tr = _call(sink.port, "GET", f"/debug/traces?fleet=1&trace_id={t['trace_id']}")
        spans = tr.get("spans", [])
        if any(sp["name"] == "train" and sp["attrs"].get("instance_id") == job1_inst
               for sp in spans):
            names = {sp["name"] for sp in spans}
            break
    stages = {"train", "train.read", "train.prepare", "train.train", "train.persist"}
    check(stages <= names, f"job 1's pushed train spans on the dashboard: {sorted(names)}")
    # the killed attempt: nothing of it arrived while the ingest refused;
    # its spool shipped by the scheduler once the ingest was back, every
    # payload once, all before the retry's first push
    with sink.lock:
        keys = [(r[0], r[2]) for r in sink.received]
        ships = [(files, n) for spool, files, n in sink.ships
                 if spool == str(killed["spool"])]
    check(len(keys) == len(set(keys)), "a pushed payload was ingested twice")
    arrived = sink.arrivals(killed["instance"])
    retry = [i for i in out["job3"]["instances"] if i != killed["instance"]][0]
    check(arrived and min(arrived) > killed["at"] and max(arrived) < min(sink.arrivals(retry)),
          f"the killed attempt's {len(arrived)} payload(s) did not all arrive after the "
          "ingest came back and before the retry's first push")
    check(ships and ships[0][1] == len(ships[0][0]) == len(arrived),
          f"the scheduler's first ship of the orphaned spool: {ships[:1]}; "
          f"{len(arrived)} payload(s) of the killed attempt arrived")
    late = arrived
    calls, iterations = _pushed_train(sink, killed["instance"])
    check(1 <= calls < jobs["job3"][2], f"the killed attempt's report: {calls} train calls")
    check(not killed["spool"].exists() and killed["orphans_after"] == 0,
          f"the spool {killed['spool']} left, or {killed['orphans_after']} shipped again")
    bad, answer = sink.post({"v": 1, "instance": "chip-smoke", "series": [], "spans": []},
                            "not-the-token")
    check(bad == 403, f"a push with a wrong token: {bad} {answer}")
    out["killed"] = {"instance": killed["instance"], "shipped_after_kill": len(late),
                     "report_calls": calls, "report_iterations": iterations,
                     "refused_403": killed["refused"]}
    out["job1_spans"] = sorted(names)
    out["wrong_token"] = bad
    print(f"[lifecycle] {smi} | push: a Dashboard in this process (no scrape targets, "
          f"PIO_PUSH_INGEST=1, a token) took {len(keys)} payloads from the job children "
          f"(every {LIFECYCLE_PUSH_INTERVAL_S} s and at exit), none twice, no poll; "
          + "; ".join(f"{n}: {len(d['instances'])} child(ren), devprof als.train_dense "
                      f"{d['calls']} calls over {d['iterations']:g} iterations = its launch "
                      "line" for n, d in out.items() if n in jobs)
          + f"; job 1's spans {sorted(names)}", flush=True)
    print(f"[lifecycle] {smi} | push: job 3's first attempt pushed into a refusing ingest "
          f"({killed['refused']} POSTs answered 403) and was SIGKILLed once it had spooled "
          f"its first segment's report; the scheduler shipped its spool ({len(late)} "
          f"payloads, report {calls} train call(s), {iterations:g} iterations) before the "
          f"retry's first push, the spool is gone and a sweep shipped nothing again; a "
          f"wrong token {bad}", flush=True)
    return out


def phase_lifecycle(report, shared):
    """Phase 11: train jobs through the queue and its worker (the child on
    the card), checkpointed and warm-started, a kill and resume, a worker
    crash, promotion, serving of the newest instance and GC."""
    t_phase = time.perf_counter()
    _children_import_this_checkout()
    users, items, _ratings = shared["loop"]
    params = ALSAlgorithmParams()
    ap = _als_params(params)
    jobs_dir = LOOP_DIR / "jobs"
    v1_path, v2_path = LOOP_DIR / "lifecycle.json", LOOP_DIR / "lifecycle_warm.json"
    v3_path = LOOP_DIR / "lifecycle_crash.json"
    v1_path.write_text(json.dumps(_lifecycle_variant()))
    v2_path.write_text(json.dumps(_lifecycle_variant(warm_start=True)))
    v3_path.write_text(json.dumps(_lifecycle_variant(
        warm_start=True, checkpoint_every=LIFECYCLE_CRASH_CHECKPOINT_EVERY)))
    # the in-process reads go through the data view, as the children's do
    # (phase 10b and job 2 fill it), not through a whole scan of the app
    ds = RecommendationDataSource(DataSourceParams(app_name=LOOP_APP, event_names=("rate",),
                                                   use_data_view=True))
    lc: dict = {"checkpoint_every": LIFECYCLE_CHECKPOINT_EVERY}
    with _loop_storage(), contextlib.ExitStack() as stack:
        storage = Storage()
        registry = ModelRegistry(storage)
        sink = _PushSink(storage)
        stack.callback(sink.close)

        # 1. a checkpointed cold train through the queue
        job1, inst1, v1, worker1_s = _run_job(storage, v1_path)
        launches1, segments1, dtype1 = _job_launches(job1, 1)
        it = params.num_iterations
        check(launches1[:2] == (it, it) and launches1[2:] == (0, 0),
              f"job 1 launches {launches1} != one row and col pass an iteration ({it})")
        check(segments1 == it // LIFECYCLE_CHECKPOINT_EVERY,
              f"job 1 staged {segments1} segments")
        check("checkpoint saved at iteration 15" in _job_log(job1, 1),
              "job 1 saved no checkpoint at iteration 15")
        f1 = _blob_factors(storage, inst1.id).factors
        t0 = time.perf_counter()
        td1 = ds.read_training(RuntimeContext(storage=storage))
        read_s = time.perf_counter() - t0
        with _Spy(als, "stage_dense") as dense_spy, _Spy(als, "stage_windowed") as win_spy:
            full = ALSAlgorithm(params).train(RuntimeContext(), td1).factors
            check(_bit_equal(f1, full), "job 1's checkpointed factors differ from an "
                  "uninterrupted ALSAlgorithm.train of the same data on the card")

            # 2. kill after two segments, resume from the checkpoint
            manager = CheckpointManager(storage, "lifecycle-kill-resume")

            class Killed(RuntimeError):
                pass

            def kill_after_two(done):
                if done == 2 * LIFECYCLE_CHECKPOINT_EVERY:
                    raise Killed(done)

            vocabs = dict(user_vocab=td1.user_vocab, item_vocab=td1.item_vocab)
            df.PASS_LAUNCHES.update(row=0, col=0)
            t0 = time.perf_counter()
            try:
                train_als_checkpointed(*_train_arrays(td1), ap, manager,
                                       LIFECYCLE_CHECKPOINT_EVERY, on_segment=kill_after_two,
                                       **vocabs)
                raise PhaseError("the killed train ran to its end")
            except Killed:
                pass
            killed_s = time.perf_counter() - t0
            killed_launches = dict(df.PASS_LAUNCHES)
            saved = manager.load()
            check(saved is not None and saved[0] == 2 * LIFECYCLE_CHECKPOINT_EVERY,
                  f"checkpoint after the kill: {saved and saved[0]}")
            df.PASS_LAUNCHES.update(row=0, col=0)
            t0 = time.perf_counter()
            resumed = train_als_checkpointed(*_train_arrays(td1), ap, manager,
                                             LIFECYCLE_CHECKPOINT_EVERY, **vocabs)
            resume_s = time.perf_counter() - t0
            resume_launches = dict(df.PASS_LAUNCHES)
            half = it - 2 * LIFECYCLE_CHECKPOINT_EVERY
            check(killed_launches == {"row": it - half, "col": it - half}
                  and resume_launches == {"row": half, "col": half},
                  f"kill/resume launches {killed_launches}, {resume_launches}")
            check(_bit_equal(resumed, full), "the resumed factors differ from the "
                  "uninterrupted train's")
            check(manager.load() is None, "the resumed train left its checkpoint")
            del td1, full, resumed

            # 3. promote v1
            rc, out = _console_out(["models", "promote", v1.id])
            check(rc == 0 and registry.get(v1.id).status == "live", f"promote: {out}")
            rc, out = _console_out(["models", "list"])
            check(f"{v1.id} [live]" in out, "models list does not show v1 live")

            # 4. the delta through console import
            rng = np.random.default_rng(LIFECYCLE_SEED)
            du, di, dr, dt_ms = _lifecycle_delta(rng, users, items)
            stamps = np.datetime_as_string(dt_ms.astype("datetime64[ms]"), unit="ms")
            delta_path = LOOP_DIR / "lifecycle_delta.jsonl"
            with open(delta_path, "w") as f:
                for n in range(len(du)):
                    f.write(json.dumps({
                        "event": "rate", "entityType": "user", "entityId": du[n],
                        "targetEntityType": "item", "targetEntityId": di[n],
                        "properties": {"rating": int(dr[n])},
                        "eventTime": f"{stamps[n]}Z"}) + "\n")
            t0 = time.perf_counter()
            rc, _ = _console_out(["import", "--app", LOOP_APP, "--input", str(delta_path)])
            import_s = time.perf_counter() - t0
            check(rc == 0, "import of the delta")

            # 5. a warm-started checkpointed train
            job2, inst2, v2, worker2_s = _run_job(storage, v2_path)
            launches2, segments2, dtype2 = _job_launches(job2, 1)
            check(launches2 == (it, it, 0, 0) and segments2 == segments1,
                  f"job 2 launches {launches2}, {segments2} segments")
            check(f"warm-starting train from live version {v1.id}" in _job_log(job2, 1),
                  "job 2's log shows no warm start from v1")
            check(v2.parent_version == v1.id, f"v2's parent {v2.parent_version}")
            rc, out = _console_out(["models", "show", v2.id])
            check(f"lineage: {v2.id} <- {v1.id}" in out, "models show v2: no lineage")
            td2 = ds.read_training(RuntimeContext(storage=storage))
            check(len(td2.rows) == LOOP_EDGES + len(du), f"{len(td2.rows)} edges after "
                  "the delta: a pair repeated")
            f2 = _blob_factors(storage, inst2.id).factors
            init = als.warm_start_factors(f1, td2.user_vocab, td2.item_vocab, ap)
            vocabs = dict(user_vocab=td2.user_vocab, item_vocab=td2.item_vocab)
            warm = als.train(*_train_arrays(td2), ap, init_factors=init, **vocabs)
            cold = als.train(*_train_arrays(td2), ap, **vocabs)
            check(_bit_equal(f2, warm), "job 2's factors differ from an in-process "
                  "train from warm_start_factors(v1)")
            check(not np.array_equal(f2.user_factors, cold.user_factors)
                  and not np.array_equal(f2.item_factors, cold.item_factors),
                  "job 2's factors equal a cold train's: no warm start")
            warm_vs_cold = max(float(np.abs(f2.user_factors - cold.user_factors).max()),
                               float(np.abs(f2.item_factors - cold.item_factors).max()))
            del td2, warm, cold, init
        check(not win_spy.calls and all(isinstance(out, als.StagedDenseTrain)
                                        for *_, out in dense_spy.calls)
              and len(dense_spy.calls) == 1 + segments1 + 2,
              f"in-process stagings: {len(dense_spy.calls)} dense, "
              f"{len(win_spy.calls)} windowed")
        # the passes on the R after the delta (the cold train's staging),
        # at the path's rank, held to their plain versions
        held = {w: {"cases": 0, "max_abs_err": 0.0, "max_ratio": 0.0} for w in ("row", "col")}
        staged_post = dense_spy.calls[-1][2]
        _dense_held(staged_post, ap.rank, np.random.default_rng(LIFECYCLE_SEED + 1), held,
                    "lifecycle after the delta")
        lc["held"] = {"dense": held, "dense_r": list(staged_post.device_args[0].shape),
                      "dense_dtype": staged_post.dense_dtype, "rank": ap.rank}
        del dense_spy, staged_post

        # 6. a worker crash: the child killed once the train started. The
        # push ingest refuses its first attempt (an ingest outage), so the
        # child's payloads stay in its spool; the ingest is back just before
        # the kill, and the scheduler ships the orphaned spool
        rc, out = _console_out(["jobs", "submit", "--variant", str(v3_path)])
        job3_id = re.search(r"job-[0-9a-f]{12}", out).group()
        sched = TrainScheduler(storage, SchedulerConfig(log_dir=str(jobs_dir)))
        queue = JobQueue(storage)
        spool3, spooled = jobs_dir / f"{job3_id}.spool", set()
        t0 = time.perf_counter()
        os.environ.pop("PIO_PUSH_INGEST")
        sched.start()
        try:
            killed_pid = None
            deadline = time.monotonic() + 300
            while killed_pid is None and time.monotonic() < deadline:
                job3 = queue.get(job3_id)
                fresh = _spooled_train_report(spool3, spooled)
                # killed once its first segment's checkpoint is saved and
                # its spool has just taken that segment's devprof report
                if (fresh and job3.status == "running" and job3.log_path
                        and "checkpoint saved at iteration" in Path(
                            job3.log_path).read_text(errors="replace")):
                    [killed_pid] = _pids_naming(f"{job3_id}.spec.json")
                    # the scheduler's ship of the orphaned spool waits for
                    # the ingest to come back, after the child is gone and
                    # its last POST (if one was on the wire) refused
                    sink.hold.clear()
                    os.kill(killed_pid, signal.SIGKILL)
                    killed_at = datetime.datetime.now(datetime.timezone.utc)
                    _wait_for(lambda: not _pids_naming(f"{job3_id}.spec.json"), 30,
                              "job 3's killed child to be reaped")
                    time.sleep(0.2)
                    refused = _push_refusals(sink.port)
                    os.environ["PIO_PUSH_INGEST"] = "1"
                    killed_wall = time.time()
                    sink.hold.set()
                time.sleep(0.02)
            check(killed_pid is not None, "job 3's train never started")
            while time.monotonic() < deadline:
                if queue.get(job3_id).status in ("completed", "failed"):
                    break
                time.sleep(0.2)
        finally:
            os.environ["PIO_PUSH_INGEST"] = "1"
            sink.hold.set()
            sched.stop()
        crash_s = time.perf_counter() - t0
        killed_push = {"instance": f"{socket.gethostname()}:{killed_pid}", "at": killed_wall,
                       "spool": spool3, "refused": refused,
                       "orphans_after": sched.ship_orphan_spools()}
        job3, inst3, v3 = _finished_job(storage, job3_id, attempts=2)
        kill_to_claim = (datetime.datetime.fromisoformat(job3.started_at)
                         - killed_at).total_seconds()
        launches3, segments3, _ = _job_launches(job3, 2)
        check(launches3 == (it, it, 0, 0) and segments3 == it // LIFECYCLE_CRASH_CHECKPOINT_EVERY,
              f"job 3 launches {launches3} in {segments3} segments")
        mine = [v.id for v in registry.list() if v.job_id == job3_id]
        check(mine == [v3.id], f"job 3 registered {mine}")
        lc_insts = [i for i in storage.get_meta_data_engine_instances().get_all()
                    if i.engine_id == LIFECYCLE_ENGINE]
        killed = [i for i in lc_insts if i.id not in (inst1.id, inst2.id, inst3.id)]
        check(len(killed) == 1 and killed[0].status != "COMPLETED",
              f"the killed attempt's instances: {[(i.id, i.status) for i in killed]}")
        # a reference quirk, kept: the retry trained afresh under a new
        # instance, and nothing clears the killed attempt's checkpoint
        check(storage.get_model_data_models().get(f"ckpt:{killed[0].id}") is not None,
              "the killed attempt's checkpoint is gone")

        # 7. serve the newest COMPLETED instance
        runtime = latest_completed_runtime(storage, LIFECYCLE_ENGINE, "0", LIFECYCLE_ENGINE)
        check(runtime.instance.id == inst3.id, "the runtime serves another instance")
        serve = _lifecycle_serve(runtime, storage, inst3.id, rng)

        # each version carries its job child's device profile: one
        # als.train_dense call a segment, on this card
        lc["devprof"] = {}
        for name, v, seg in (("job1", v1, segments1), ("job2", v2, segments2),
                             ("job3", v3, segments3)):
            prof = registry.get(v.id).devprof or {}
            rows = {r["name"]: r for r in prof.get("executables", [])}
            td_row = rows.get("als.train_dense")
            check(td_row is not None and td_row["invocations"] == seg
                  and td_row["device_seconds"] > 0,
                  f"{name}'s version devprof: als.train_dense {td_row and td_row['invocations']}"
                  f" calls for {seg} segments")
            kind = (prof.get("platform") or {}).get("device_kind")
            check(kind == torch.cuda.get_device_name(0),
                  f"{name}'s version devprof ran on {kind!r}")
            check(all(r["timing_errors"] == 0 for r in rows.values()),
                  f"{name}'s version devprof has timing errors")
            lc["devprof"][name] = {"executables": sorted(rows),
                                   "train_dense_calls": td_row["invocations"],
                                   "train_dense_device_s": td_row["device_seconds"],
                                   "train_dense_mfu_raw": td_row.get("mfu_raw")}

        lc["push"] = _lifecycle_push_checks(
            sink, {"job1": (job1, launches1, segments1), "job2": (job2, launches2, segments2),
                   "job3": (job3, launches3, segments3)}, killed_push, report["nvidia_smi"])

        # 8. GC
        rc, out = _console_out(["models", "gc", "--keep", "1"])
        check(rc == 0 and {v.id for v in registry.list()} == {v1.id, v3.id},
              f"models gc --keep 1 left {[v.id for v in registry.list()]}")
        rc, out = _console_out(["jobs", "gc", "--keep", "2"])
        check(rc == 0 and {j.id for j in queue.list()} == {job2.id, job3.id},
              f"jobs gc --keep 2 left {[j.id for j in queue.list()]}")

    smi = report["nvidia_smi"]
    jobs = {"job1": (job1, inst1, worker1_s, launches1, segments1),
            "job2": (job2, inst2, worker2_s, launches2, segments2),
            "job3": (job3, inst3, crash_s, launches3, segments3)}
    lc.update({
        "delta_events": len(du), "import_s": import_s, "read_training_s": read_s,
        "dense_dtype": [dtype1, dtype2],
        "jobs": {k: {**_job_times(j, i), **_log_figures(j, j.attempt, i), "worker_s": w,
                     "launches": list(la), "segments": sg, "attempt": j.attempt}
                 for k, (j, i, w, la, sg) in jobs.items()},
        "kill_to_retry_claim_s": kill_to_claim,
        "kill_s": killed_s, "resume_s": resume_s,
        "kill_resume_launches": {"row": killed_launches["row"] + resume_launches["row"],
                                 "col": killed_launches["col"] + resume_launches["col"]},
        "warm_vs_cold_max_abs": warm_vs_cold, "killed_instance": killed[0].status,
        "versions": [v1.id, v2.id, v3.id], "serve": serve,
        "launches": {"row": sum(j[3][0] for j in jobs.values()),
                     "col": sum(j[3][1] for j in jobs.values()),
                     "serve_topk": serve["launches"]},
        "nvidia_smi": smi,
    })
    lc["phase_s"] = time.perf_counter() - t_phase
    report["lifecycle"] = lc
    for name, j in lc["jobs"].items():
        st = j["stages"]
        print(f"[lifecycle] {smi} | {name} (attempt {j['attempt']}): queue wait "
              f"{j['queue_wait_s']:.3f} s, worker {j['worker_s']:.2f} s (started to "
              f"finished {j['started_to_finished_s']:.2f} s), read {st['read']:.2f} s, "
              f"train {st['train']:.3f} s, persist {st['persist']:.4f} s; "
              f"{j['segments']} segments, dense launches row/col "
              f"{j['launches'][0]}/{j['launches'][1]}; from its log: child start "
              f"{j['child_start_s']:.3f} s (spawn to first line {j['spawn_to_first_line_s']:.3f}"
              f" s, less the read), segment set-up (gate + staging) s "
              f"{[round(x, 3) for x in j['segment_setup_s']]}, segment run (iterations + "
              f"checkpoint) s {[round(x, 3) for x in j['segment_run_s']]}", flush=True)
    print(f"[lifecycle] {smi} | in-process kill after 2 segments {killed_s:.3f} s, resume "
          f"{resume_s:.3f} s (bit-equal to the uninterrupted train); warm vs cold max "
          f"|diff| {warm_vs_cold:.4g}; delta {len(du)} events imported in {import_s:.2f} s; "
          f"job 3's killed attempt left its instance {killed[0].status} and its "
          f"checkpoint; kill to the retry's claim {kill_to_claim:.3f} s", flush=True)
    for name, d in lc["devprof"].items():
        print(f"[lifecycle] {smi} | {name}'s version devprof: als.train_dense "
              f"{d['train_dense_calls']} calls (one a segment), "
              f"{d['train_dense_device_s']:.4f} device s, raw MFU "
              f"{d['train_dense_mfu_raw']}; executables {d['executables']}", flush=True)
    h = lc["held"]
    print(f"[lifecycle] {smi} | dense passes on the post-delta {h['dense_dtype']} R "
          f"{h['dense_r']} at K={h['rank']} vs plain: max |kernel - plain| row "
          f"{h['dense']['row']['max_abs_err']:.3g} (ratio {h['dense']['row']['max_ratio']:.3g}), "
          f"col {h['dense']['col']['max_abs_err']:.3g} "
          f"(ratio {h['dense']['col']['max_ratio']:.3g})", flush=True)
    print(f"[lifecycle] {smi} | {LIFECYCLE_QUERIES} queries from {LIFECYCLE_CLIENTS} "
          f"clients on job 3's instance: p50 {serve['p50_ms']:.3f} ms, p99 "
          f"{serve['p99_ms']:.3f} ms, {serve['qps']:.1f} qps, top-k launches "
          f"{serve['launches']} in {serve['batches']} batches; phase {lc['phase_s']:.1f} s",
          flush=True)


def _lifecycle_queries(rng):
    qs = []
    for _ in range(LIFECYCLE_QUERIES):
        r = rng.random()
        user = (f"u{LOOP_USERS + int(rng.integers(LIFECYCLE_NEW_USERS))}" if r < 0.3
                else f"u{int(rng.integers(LOOP_USERS))}")
        q = {"user": user, "num": int(rng.choice([5, 10, 20, 50]))}
        r = rng.random()
        pool = LOOP_ITEMS + LIFECYCLE_NEW_ITEMS
        if r < 0.15:
            q["blacklist"] = [f"i{int(x)}" for x in rng.integers(0, pool, 8)]
        elif r < 0.3:
            q["whitelist"] = ([f"i{LOOP_ITEMS + int(x)}" for x in
                               rng.integers(0, LIFECYCLE_NEW_ITEMS, 10)]
                              + [f"i{int(x)}" for x in rng.integers(0, LOOP_ITEMS, 20)])
        qs.append(q)
    return qs


def _lifecycle_serve(runtime, storage, instance_id, rng):
    """The runtime behind a QueryServer in this process; the queries from
    LIFECYCLE_CLIENTS threads; every answer held to the plain top-k on
    the CPU over the blob's factors."""
    queries = _lifecycle_queries(rng)
    srv = QueryServer(runtime=runtime, storage=storage,
                      config=QueryServerConfig(ip="127.0.0.1", port=0))
    port = srv.start()
    try:
        before = _status(port)
        select0 = rec.ROUTE_LAUNCHES["select"]
        out: dict = {}
        lock = threading.Lock()
        work = list(enumerate(queries))
        threads = [threading.Thread(target=_client, args=(port, work[c::LIFECYCLE_CLIENTS],
                                                          out, lock))
                   for c in range(LIFECYCLE_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads), "clients hung")
        after = _status(port)
        select = rec.ROUTE_LAUNCHES["select"] - select0
    finally:
        srv.stop()
    check(after["device"] == "cuda:0", f"serves on {after['device']}")
    batches = after["batches"] - before["batches"]
    launches = after["kernel_launches"] - before["kernel_launches"]
    check(batches > 0 and launches == batches == select,
          f"top-k launches {launches} (select {select}) != batches {batches}")
    model = _blob_factors(storage, instance_id)
    model.bind_device("cpu")
    cpu_alg = ALSAlgorithm(ALSAlgorithmParams())
    for n, q in enumerate(queries):
        status, body, _ = out[n]
        check(status == 200, f"query {n}: HTTP {status} {body}")
        check(body == _to_jsonable(cpu_alg.predict(model, Query(**q))),
              f"query {n} ({q}) differs from the CPU plain top-k")
    lat = sorted(out[n][2] for n in range(len(queries)))
    return {"queries": len(queries), "batches": batches, "launches": launches,
            "wall_s": wall, "qps": len(queries) / wall,
            "p50_ms": 1e3 * lat[len(lat) // 2],
            "p99_ms": 1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))]}


# ---------------------------------------------------------------------------
# phase 12: the Event Server feeding train -> deploy at ML-100K's shape
# ---------------------------------------------------------------------------


def _rate_json(users, items, ratings, times):
    """The ratings as the Event Server's JSON objects, in array order."""
    stamps = np.datetime_as_string(times.astype("datetime64[ms]"), unit="ms")
    return [{"event": "rate", "entityType": "user", "entityId": f"u{u}",
             "targetEntityType": "item", "targetEntityId": f"i{i}",
             "properties": {"rating": int(r)}, "eventTime": f"{t}Z"}
            for u, i, r, t in zip(users.tolist(), items.tolist(), ratings.tolist(), stamps)]


def _post_work(port, work, out, lock):
    """POST each (n, path, body text) of `work` on one keep-alive
    connection; out[n] = (status, parsed body, seconds, host time of the
    answer)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        for n, path, body in work:
            t0 = time.perf_counter()
            conn.request("POST", path, body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            payload = resp.read()
            t1 = time.perf_counter()
            with lock:
                out[n] = (resp.status, json.loads(payload), t1 - t0, t1)
    finally:
        conn.close()


def _call(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _pct(seconds, q):
    s = sorted(seconds)
    return 1e3 * s[min(len(s) - 1, int(q * len(s)))]


def _console_out(argv):
    """console.main(argv)'s exit code and what it printed (echoed); an
    exit by SystemExit (an operator error, a bad argument) fails the
    phase with its message."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = console.main(argv)
    except SystemExit as e:
        raise PhaseError(f"console {' '.join(argv)}: {e.code}") from None
    finally:
        print(buf.getvalue(), end="", flush=True)
    return rc, buf.getvalue()


def phase_ingest(report, shared):
    """The reference's quick start over the loop's storage: `console app
    new`, a second key and a channel, `console eventserver` in a process
    of its own, ML-100K's events POSTed by four writers, the checks and
    read-backs, then `train --engine-json` here and `deploy
    --engine-json` in its own process on the card, and 500 queries."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(INGEST_SEED)
    users, items, ratings, times = _ratings_data(
        rng, INGEST_USERS, INGEST_ITEMS, INGEST_EDGES, INGEST_USER_DEGREES,
        INGEST_ITEM_DEGREES, INGEST_T0_MS)
    events = _rate_json(users, items, ratings, times)
    shared["ingest"] = (users, items, ratings)  # the online phase's base
    shared["ingest_events"] = events  # the remote phase posts them again
    with _loop_storage():
        rc, out = _console_out(["app", "new", INGEST_APP])
        key = re.search(r"^\[INFO\] Access key: (\S+)$", out, re.M)
        check(rc == 0 and key is not None, "app new printed no access key")
        key = key.group(1)
        rc, out = _console_out(["accesskey", "new", INGEST_APP, "--events", "rate"])
        rate_key = re.search(r"Access key created: (\S+)", out)
        check(rc == 0 and rate_key is not None, "accesskey new --events rate")
        rate_key = rate_key.group(1)
        check(_console_out(["channel", "new", INGEST_APP, "holdout"])[0] == 0,
              "channel new")
        with _Console(["eventserver", "--ip", "127.0.0.1", "--port", "0"],
                      LOOP_DIR / "eventserver.log") as es:
            port = es.port(timeout=120)
            ingest = _ingest_posts(port, key, events, rng)
            ids = ingest.pop("ids")
            for k in ("first_202", "outage", "spilled"):
                ingest.pop(k)
            checks = _ingest_checks(port, key, rate_key, events, ids, users, times, rng)
        check(es.proc.returncode is not None, "eventserver still running")
        report["ingest"] = {**ingest, "checks": checks}
        _ingest_train_deploy(report, shared, users, items, ratings)
    ing = report["ingest"]
    ing["phase_s"] = time.perf_counter() - t_phase
    smi = report["nvidia_smi"]
    print(f"[ingest] {smi} | {INGEST_EDGES} ML-100K-shaped events from {INGEST_WRITERS} "
          f"writers ({ing['batch_posts']} batch POSTs of {INGEST_BATCH}, "
          f"{INGEST_SINGLES} single POSTs): {ing['ingest_s']:.2f} s, "
          f"{ing['events_per_s']:.1f} events/s", flush=True)
    print(f"[ingest] {smi} | batch POST p50 {ing['batch_p50_ms']:.3f} ms, p99 "
          f"{ing['batch_p99_ms']:.3f} ms; single POST p50 {ing['single_p50_ms']:.3f} ms, "
          f"p99 {ing['single_p99_ms']:.3f} ms", flush=True)
    st = ing["stages"]
    print(f"[ingest] {smi} | train: read {st['read']:.3f} s, prepare {st['prepare']:.4f} s, "
          f"train {st['train']:.3f} s, persist {st['persist']:.4f} s; launches "
          f"block_partials {ing['launches']['partials']}, combine "
          f"{ing['launches']['combine']}; corrcoef vs a direct train users "
          f"{ing['corr_users']:.8f} items {ing['corr_items']:.8f}", flush=True)
    print(f"[ingest] {smi} | deploy to ready {ing['deploy_ready_s']:.2f} s; {N_QUERIES} "
          f"queries from {N_CLIENTS} clients: p50 {ing['p50_ms']:.3f} ms, p99 "
          f"{ing['p99_ms']:.3f} ms, {ing['qps']:.1f} qps, scored top-k launches "
          f"{ing['launches']['serve_topk']} in {ing['batches']} batches (select "
          f"{ing['launches']['serve_select']}); phase {ing['phase_s']:.1f} s", flush=True)


def _ingest_posts(port, key, events, rng, outage=None):
    """The timed ingest: the events in a shuffled order, all but the last
    INGEST_SINGLES as /batch/events.json POSTs of INGEST_BATCH, those one
    by one, dealt round-robin to INGEST_WRITERS threads (batches first);
    every event must come back 201, or 201 or 202 (spilled) when
    `outage(out, n_posts)` runs beside the writers (it returns once they
    are done). Returns the times, each event's id (a 202 names the id it
    will be stored under beside its walId), the 202s and the first 202's
    host time."""
    order = rng.permutation(len(events))
    n_batched = len(events) - INGEST_SINGLES
    work = []
    for b in range(0, n_batched, INGEST_BATCH):
        chunk = order[b:b + INGEST_BATCH]
        work.append((chunk, f"/batch/events.json?accessKey={key}",
                     json.dumps([events[n] for n in chunk])))
    n_batches = len(work)
    work += [([n], f"/events.json?accessKey={key}", json.dumps(events[n]))
             for n in order[n_batched:]]
    jobs = [(j, path, body) for j, (_, path, body) in enumerate(work)]
    deal = [jobs[w:n_batches:INGEST_WRITERS] + jobs[n_batches + w::INGEST_WRITERS]
            for w in range(INGEST_WRITERS)]
    out: dict = {}
    lock = threading.Lock()
    threads = [threading.Thread(target=_post_work, args=(port, d, out, lock)) for d in deal]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    seen = outage(out, len(work), threads) if outage is not None else None
    for t in threads:
        t.join(timeout=900)
    check(not any(t.is_alive() for t in threads), "ingest writers hung")
    check(len(out) == len(work), f"{len(out)} of {len(work)} POSTs answered")
    wall = max(answer[3] for answer in out.values()) - t0  # to the last answer
    ok = (201, 202) if outage is not None else (201,)
    ids = np.empty(len(events), object)
    spilled, t_spilled = 0, []
    for j, (chunk, _, _) in enumerate(work):
        status, body, _, t_answer = out[j]
        rows = body if j < n_batches else [body]
        statuses = [r["status"] for r in body] if j < n_batches else [status]
        check((status == 200 if j < n_batches else True) and len(statuses) == len(chunk)
              and all(st in ok for st in statuses),
              f"{'batch' if j < n_batches else 'single'} POST {j}: HTTP {status} "
              f"{str(body)[:200]}")
        ids[chunk] = [r["eventId"] for r in rows]  # a 202's too: the id it is stored under
        n202 = statuses.count(202)
        spilled += n202
        if n202:
            t_spilled.append(t_answer)
    check(len(set(ids)) == len(events), "event ids are not unique")
    batch_s = [out[j][2] for j in range(n_batches)]
    single_s = [out[j][2] for j in range(n_batches, len(work))]
    return {"events": len(events), "writers": INGEST_WRITERS, "batch_posts": n_batches,
            "single_posts": len(single_s), "ingest_s": wall,
            "events_per_s": len(events) / wall, "spilled": spilled,
            "batch_p50_ms": _pct(batch_s, 0.5), "batch_p99_ms": _pct(batch_s, 0.99),
            "single_p50_ms": _pct(single_s, 0.5), "single_p99_ms": _pct(single_s, 0.99),
            "ids": ids, "first_202": min(t_spilled) if t_spilled else None, "outage": seen}


def _ingest_checks(port, key, rate_key, events, ids, users, times, rng):
    """After the timed ingest: a channel's events, deleted events, refused
    events and requests, then the read-backs; none of the extra events
    may reach the train's read of the default channel."""
    t0 = time.perf_counter()
    k = f"accessKey={key}"
    first = INGEST_T0_MS - 10_000_000  # before every generated event
    extra = [{**events[n], "eventTime": _ms_iso(first + 1000 * j)}
             for j, n in enumerate(rng.choice(len(events), INGEST_HOLDOUT + INGEST_DELETED,
                                              replace=False))]
    holdout, doomed = extra[:INGEST_HOLDOUT], extra[INGEST_HOLDOUT:]
    status, body = _call(port, "POST", f"/batch/events.json?{k}&channel=holdout", holdout)
    check(status == 200 and [r["status"] for r in body] == [201] * INGEST_HOLDOUT,
          f"holdout batch: HTTP {status} {str(body)[:200]}")
    holdout_ids = {r["eventId"] for r in body}
    for ev in doomed:
        status, body = _call(port, "POST", f"/events.json?{k}", ev)
        check(status == 201, f"POST of an event to delete: HTTP {status} {body}")
        eid = body["eventId"]
        check(_call(port, "DELETE", f"/events/{eid}.json?{k}") == (200, {"message": "Found"}),
              f"DELETE /events/{eid}.json")
        check(_call(port, "GET", f"/events/{eid}.json?{k}")[0] == 404,
              f"GET /events/{eid}.json after its delete")
    buys = [{**events[n], "event": "buy", "properties": {}} for n in range(INGEST_REFUSED)]
    status, body = _call(port, "POST", f"/batch/events.json?accessKey={rate_key}", buys)
    check(status == 200 and [r["status"] for r in body] == [403] * INGEST_REFUSED,
          f"buy events with the rate-only key: HTTP {status} {body}")
    check(_call(port, "POST", "/events.json?accessKey=wrong", events[0])[0] == 401,
          "a wrong key was not refused 401")
    status, body = _call(port, "POST", f"/batch/events.json?{k}", events[:INGEST_BATCH + 1])
    check(status == 400, f"a batch of {INGEST_BATCH + 1}: HTTP {status}")

    # read-backs: sampled ids, sampled users' histories, the channel
    for n in rng.choice(len(events), INGEST_READ_IDS, replace=False).tolist():
        status, body = _call(port, "GET", f"/events/{ids[n]}.json?{k}")
        got = {a: v for a, v in body.items() if a not in ("creationTime", "revision")}
        check(status == 200 and got == {**events[n], "eventId": ids[n]},
              f"GET /events/{ids[n]}.json: {status} {body}")
    for u in rng.choice(INGEST_USERS, INGEST_READ_USERS, replace=False).tolist():
        status, body = _call(port, "GET", f"/events.json?{k}&entityType=user"
                                          f"&entityId=u{u}&limit=-1")
        mine = np.flatnonzero(users == u)
        mine = mine[np.argsort(times[mine])]
        want = [{**events[n], "eventId": ids[n]} for n in mine.tolist()]
        got = [{a: v for a, v in e.items() if a not in ("creationTime", "revision")}
               for e in body] if status == 200 else body
        check(got == want, f"user u{u}'s events read back differ from the posted ones")
    status, body = _call(port, "GET", f"/events.json?{k}&channel=holdout&limit=-1")
    check(status == 200 and len(body) == INGEST_HOLDOUT
          and {e["eventId"] for e in body} == holdout_ids,
          f"the holdout channel holds {len(body) if status == 200 else status}")
    return {"holdout": INGEST_HOLDOUT, "deleted": INGEST_DELETED,
            "refused_403": INGEST_REFUSED, "read_ids": INGEST_READ_IDS,
            "read_users": INGEST_READ_USERS, "seconds": time.perf_counter() - t0}


def _ms_iso(ms):
    return f"{np.datetime_as_string(np.datetime64(int(ms), 'ms'), unit='ms')}Z"


def _ingest_train_deploy(report, shared, users, items, ratings):
    """`train --engine-json` over the ingested app, the checks of its
    frame, staging, launches and factors, the kernels held at its plans'
    shapes; then the deploy and its 500 queries. Its frame and factors
    stay in `shared` for phase 12d's trains over other stores."""
    engine_json = LOOP_DIR / "engine_ml100k.json"
    engine_json.write_text(json.dumps({
        "id": "ml100k-als",
        "engineFactory": "predictionio_tpu_torch.engines.recommendation.RecommendationEngine",
        "datasource": {"params": {"app_name": INGEST_APP, "event_names": ["rate"]}},
        "algorithms": [{"name": "als", "params": {}}],  # the template's defaults
    }))
    frames = []
    frame_of = RecommendationDataSource._frame

    def kept_frame(self, ctx):
        frames.append(frame_of(self, ctx))
        return frames[-1]

    RecommendationDataSource._frame = kept_frame
    wf.BLOCK_LAUNCHES.update(partials=0, combine=0)  # every count to 0 just before
    df.PASS_LAUNCHES.update(row=0, col=0)
    try:
        with _Spy(als, "stage_windowed") as stage:
            rc = console.main(["train", "--engine-json", str(engine_json)])
    finally:
        RecommendationDataSource._frame = frame_of
    launches = {**wf.BLOCK_LAUNCHES, **df.PASS_LAUNCHES}
    check(rc == 0, "train --engine-json")
    storage = Storage()
    [inst] = [i for i in storage.get_meta_data_engine_instances().get_all()
              if i.engine_id == "ml100k-als"]
    check(inst.status == "COMPLETED", f"instance {inst.status}")
    params = ALSAlgorithmParams()
    want = 2 * params.num_iterations
    check(launches["partials"] == launches["combine"] == want,
          f"windowed launches {launches} != 2 x iterations ({want})")
    check(launches["row"] == launches["col"] == 0, "a dense pass ran")
    staged = [out for *_, out in stage.calls]
    check(len(staged) == 1 and isinstance(staged[0], als.StagedWindowedTrain),
          f"the train staged {len(staged)} windowed trains")
    [model] = deserialize_models(storage.get_model_data_models().get(inst.id).models)
    check(type(model) is ALSModel, f"MODELDATA holds {type(model).__name__}")
    f = model.factors
    check(f.user_factors.shape == (INGEST_USERS, RANK)
          and f.item_factors.shape == (INGEST_ITEMS, RANK), "factor shapes")
    check(_finite(f), "non-finite factors")

    # the frame holds exactly the generated triples: no holdout, deleted
    # or refused event
    [frame] = frames
    check(len(frame) == INGEST_EDGES, f"{len(frame)} events read back")
    uid, iid = _ids(frame.entity_vocab, "u"), _ids(frame.target_vocab, "i")
    key = uid[frame.entity_idx] * INGEST_ITEMS + iid[frame.target_idx]
    order, gen = np.argsort(key), np.argsort(users * INGEST_ITEMS + items)
    check(np.array_equal(key[order], (users * INGEST_ITEMS + items)[gen])
          and np.array_equal(frame.value[order], ratings[gen].astype(np.float32)),
          "the frame read back differs from the generated (user, item, rating) triples")
    shared["ingest_train"] = {"frame": frame, "factors": f}
    del frames, frame

    urow = np.empty(INGEST_USERS, np.int64)
    urow[uid] = np.arange(len(uid))
    irow = np.empty(INGEST_ITEMS, np.int64)
    irow[iid] = np.arange(len(iid))
    td = TrainingData(rows=urow[users].astype(np.int32), cols=irow[items].astype(np.int32),
                      vals=ratings.astype(np.float32), n_users=INGEST_USERS,
                      n_items=INGEST_ITEMS, user_vocab=f.user_vocab, item_vocab=f.item_vocab)
    direct = ALSAlgorithm(params).train(RuntimeContext(), td).factors
    cu = _corr(f.user_factors, direct.user_factors)
    ci = _corr(f.item_factors, direct.item_factors)
    check(cu > 0.9999 and ci > 0.9999,
          f"the ingested app's factors vs a direct train: corrcoef users {cu}, items {ci}")
    del direct, td
    held = {"cases": 0, "max_abs_err": 0.0, "max_ratio": 0.0,
            "combined_max_abs_err": 0.0, "combined_max_ratio": 0.0}
    _windowed_held(staged[0], RANK, np.random.default_rng(INGEST_SEED + 1), held,
                   "ingest plan")
    del staged, stage

    served = _deploy_queries(engine_json, LOOP_DIR / "deploy_ml100k.log", inst, model,
                             params, np.random.default_rng(INGEST_SEED + 2))
    report["ingest"].update({
        "stages": stage_timings(inst), "staging": "StagedWindowedTrain",
        "launches": {**launches, "serve_topk": served.pop("served"),
                     "serve_select": served.pop("select")},
        "corr_users": cu, "corr_items": ci, "held": held, **served,
        "nvidia_smi": report["nvidia_smi"],
    })


def _deploy_queries(engine_json, log_path, inst, model, params, rng,
                    n_users=INGEST_USERS, n_items=INGEST_ITEMS, extra_args=(),
                    profiled=False):
    """`deploy --engine-json` (and `extra_args`) in a process of its own on
    the card, 500 queries of the app's users (ML-100K's by default) from
    N_CLIENTS threads: the deploy serves `inst`, its scored top-k launches
    equal its batches, all on the select route (`profiled`: and so do its
    device profiler's `als.recommend_serving` calls, read from its
    `/debug/profile`, and the deploy is stopped by Ctrl-C, as an operator
    stops it), and every answer equals the plain top-k on the CPU over
    `model`'s factors."""
    queries = _loop_queries(rng, n_users, n_items, unknown=0)
    t0 = time.perf_counter()
    with _Console(["deploy", "--engine-json", str(engine_json), "--ip", "127.0.0.1",
                   "--port", "0", *extra_args], log_path) as dep:
        port = dep.port(timeout=300)
        before = _status(port)
        if profiled:
            before["profiled"] = _profiled_calls(port, "als.recommend_serving")
        ready_s = time.perf_counter() - t0
        out: dict = {}
        lock = threading.Lock()
        work = list(enumerate(queries))
        threads = [threading.Thread(target=_client, args=(port, work[c::N_CLIENTS], out, lock))
                   for c in range(N_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads), "clients hung")
        after = _status(port)
        if profiled:
            after["profiled"] = _profiled_calls(port, "als.recommend_serving")
            check(dep.interrupt() == 0, f"deploy exited {dep.proc.returncode} on Ctrl-C")
    check(dep.proc.returncode is not None, "deploy still running")
    check(before["engine_instance"] == inst.id, "deploy serves another instance")
    check(after["device"] == "cuda:0", f"deploy serves on {after['device']}")
    check(len(out) == len(queries), f"{len(out)} of {len(queries)} answered")
    batches = after["batches"] - before["batches"]
    served = after["kernel_launches"] - before["kernel_launches"]
    select = after["select_launches"] - before["select_launches"]
    check(batches > 0 and served == select == batches,
          f"deploy top-k launches {served} (select {select}) != its batches {batches}")
    check(not profiled or after["profiled"] - before["profiled"] == batches,
          f"the deploy's profiler counted {after.get('profiled')} recommend_serving calls "
          f"for {batches} batches")
    model.bind_device("cpu")
    cpu_alg = ALSAlgorithm(params)
    for n, q in enumerate(queries):
        status, body, _ = out[n]
        check(status == 200, f"query {n}: HTTP {status} {body}")
        check(body == _to_jsonable(cpu_alg.predict(model, Query(**q))),
              f"query {n} ({q}) differs from the CPU plain top-k")
    lat = [out[n][2] for n in range(len(queries))]
    return {"deploy_ready_s": ready_s, "wall_s": wall, "qps": len(queries) / wall,
            "p50_ms": _pct(lat, 0.5), "p99_ms": _pct(lat, 0.99), "served": served,
            "select": select, "batches": batches, "mean_batch": len(queries) / batches,
            "batch_predict_ms": 1e3 * (after["batch_predict_seconds"]
                                       - before["batch_predict_seconds"]) / batches,
            **({"profiled": after["profiled"] - before["profiled"]} if profiled else {})}


# ---------------------------------------------------------------------------
# phase 13b: the main path over the storage daemon, through its outage
# ---------------------------------------------------------------------------


def _remote_env(port):
    """Every repository through the storage daemon on `port`."""
    return {"PIO_FS_BASEDIR": str(REMOTE_DIR / "client"),
            "PIO_STORAGE_SOURCES_PIOREMOTE_TYPE": "remote",
            "PIO_STORAGE_SOURCES_PIOREMOTE_HOST": "127.0.0.1",
            "PIO_STORAGE_SOURCES_PIOREMOTE_PORT": str(port),
            "PIO_STORAGE_SOURCES_PIOREMOTE_BREAKER_COOLDOWN": str(REMOTE_BREAKER_COOLDOWN_S),
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "PIOREMOTE",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "PIOREMOTE",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "PIOREMOTE"}


class _StorageDaemon:
    """`console storageserver` over sqlite and model files under `store`
    (phase 12b's by default), in a process of its own, its logs under
    `log_dir`; SIGKILLed and restarted on its port over the same files.
    `spawn` starts the process and `wait` reads its port, so that several
    daemons start at once."""

    def __init__(self, store=None, log_dir=None, name="storageserver"):
        self.console, self.port, self.starts = None, 0, 0
        self.store = REMOTE_DIR / "store" if store is None else store
        self.log_dir = REMOTE_DIR if log_dir is None else log_dir
        self.name = name

    def spawn(self):
        self.close()
        self.starts += 1
        env = {k: v for k, v in os.environ.items() if not k.startswith("PIO_STORAGE_")}
        env.update(_store_env(self.store))
        self.console = _Console(["storageserver", "--ip", "127.0.0.1", "--port", str(self.port)],
                                self.log_dir / f"{self.name}{self.starts}.log", env=env)

    def wait(self):
        port = self.console.port(timeout=60)
        check(self.port in (0, port), f"the daemon came back on {port}, not {self.port}")
        self.port = port
        return time.perf_counter()

    def start(self):
        self.spawn()
        return self.wait()

    def kill(self):
        self.console.proc.kill()
        self.console.proc.wait(timeout=30)
        return time.perf_counter()

    def close(self):
        if self.console is not None:
            self.console.__exit__(None, None, None)
            self.console = None


def _es_metrics(port):
    """The Event Server's outage series: the events breaker's state, its
    transitions by state, the WAL's pending, spilled and replayed."""
    status, text = _get(port, "/metrics")
    check(status == 200, f"Event Server /metrics: HTTP {status}")
    samples = _prometheus(text)

    def total(name, **labels):
        want = [f'{k}="{v}"' for k, v in labels.items()]
        return sum(v for (n, lbl), v in samples.items()
                   if n == name and all(w in lbl for w in want))

    return {"state": total("resilience_breaker_state", dao="events"),
            "transitions": {st: total("resilience_breaker_transitions_total", dao="events",
                                      state=st) for st in ("open", "half_open", "closed")},
            "pending": total("event_wal_pending"),
            "spilled": total("event_wal_spilled_total"),
            "replayed": total("event_wal_replayed_total")}


def _wal_settled(es_port, what, timeout=60.0):
    """The Event Server's WAL series once a replay pass has ended: nothing
    pending and the replayed counter at the spilled one. A pass acks its
    chunks as they land and adds them to the counter when it returns, so
    a read between the two sees pending 0 with the counter short of it."""
    t0 = time.monotonic()
    while True:
        m = _es_metrics(es_port)
        if m["pending"] == 0 and m["replayed"] == m["spilled"]:
            return m
        check(time.monotonic() - t0 < timeout,
              f"{what}: pending {m['pending']:g}, replayed {m['replayed']:g}, spilled "
              f"{m['spilled']:g} after {timeout} s")
        time.sleep(REMOTE_POLL_S)


def _remote_outage(daemon, es_port):
    """The outage beside the writers: SIGKILL the daemon once a third of
    the POSTs are answered, read the Event Server's breaker and WAL while
    it is down, restart it on its port once two thirds are, and read the
    WAL until it has drained (the last time its pending reached 0)."""
    def run(out, n_posts, threads):
        seen = {"breaker_open": False, "pending_max": 0.0, "outage_polls": 0}
        t_kill = t_restart = t_drained = None
        while True:
            alive = any(t.is_alive() for t in threads)
            n = len(out)
            if t_kill is None:
                if n >= n_posts * REMOTE_KILL_AT:
                    t_kill = daemon.kill()
                    seen["posts_at_kill"] = n
                elif alive:
                    time.sleep(0.01)
                    continue
            m = _es_metrics(es_port)
            if t_restart is None:
                seen["outage_polls"] += 1
                seen["breaker_open"] |= m["state"] == 1.0
                seen["pending_max"] = max(seen["pending_max"], m["pending"])
                if n >= n_posts * REMOTE_RESTART_AT or not alive:
                    t_restart = daemon.start()
                    seen["posts_at_restart"] = n
            elif m["pending"] == 0:
                t_drained = t_drained or time.perf_counter()
                if not alive:
                    break
            else:
                t_drained = None
            check(t_restart is None or time.perf_counter() - t_restart < REMOTE_DRAIN_S,
                  f"the WAL still holds {m['pending']:g} events {REMOTE_DRAIN_S} s after "
                  "the daemon's restart")
            time.sleep(REMOTE_POLL_S)
        return {**seen, "t_kill": t_kill, "t_restart": t_restart, "t_drained": t_drained}
    return run


def _frames_equal(got, want):
    """Column for column: codes, rows, times, values and vocabularies."""
    return (len(got) == len(want)
            and all(np.array_equal(getattr(got, c), getattr(want, c))
                    for c in ("event_code", "entity_idx", "target_idx", "time_ms", "value"))
            and all(getattr(got, v).to_dict() == getattr(want, v).to_dict()
                    for v in ("event_vocab", "entity_vocab", "target_vocab")))


def _variant(engine_id, path):
    path.write_text(json.dumps({
        "id": engine_id,
        "engineFactory": "predictionio_tpu_torch.engines.recommendation.RecommendationEngine",
        "datasource": {"params": {"app_name": INGEST_APP, "event_names": ["rate"]}},
        "algorithms": [{"name": "als", "params": {}}],  # the template's defaults
    }))
    return path


def _train_variant(engine_json, engine_id, frames):
    """`console train --engine-json` here over the storage the environment
    names; its instance, its model and the frame its read gave."""
    frame_of = RecommendationDataSource._frame

    def kept_frame(self, ctx):
        frames.append(frame_of(self, ctx))
        return frames[-1]

    RecommendationDataSource._frame = kept_frame
    try:
        rc = console.main(["train", "--engine-json", str(engine_json)])
    finally:
        RecommendationDataSource._frame = frame_of
    check(rc == 0, f"train --engine-json {engine_json.name}")
    storage = Storage()
    [inst] = [i for i in storage.get_meta_data_engine_instances().get_all()
              if i.engine_id == engine_id]
    check(inst.status == "COMPLETED", f"{engine_id}'s instance {inst.status}")
    [model] = deserialize_models(storage.get_model_data_models().get(inst.id).models)
    check(type(model) is ALSModel, f"{engine_id}'s MODELDATA holds {type(model).__name__}")
    return inst, model


def phase_remote(report, shared):
    """The main path over the storage daemon (the JDBC role): ML-100K's
    events POSTed through an Event Server whose every repository is the
    daemon, which is SIGKILLed mid-ingest and restarted on its port (the
    WAL spill, the breaker, the replay); the ``event.insert`` fault; then
    train and deploy over the daemon, held to the same train over the
    daemon's sqlite file read directly."""
    t_phase = time.perf_counter()
    smi = report["nvidia_smi"]
    pick = np.sort(np.random.default_rng(INGEST_SEED + 12).choice(
        INGEST_EDGES, REMOTE_EVENTS, replace=False))
    users, items, ratings = (a[pick] for a in shared["ingest"])
    events = [shared["ingest_events"][n] for n in pick.tolist()]
    rng = np.random.default_rng(INGEST_SEED + 10)
    shutil.rmtree(REMOTE_DIR, ignore_errors=True)
    (REMOTE_DIR / "store").mkdir(parents=True)
    wal_dir = REMOTE_DIR / "wal"
    daemon = _StorageDaemon()
    rm: dict = {}
    with contextlib.ExitStack() as stack:
        stack.callback(daemon.close)  # a failed phase leaves no daemon on the port
        t0 = time.perf_counter()
        daemon.start()
        rm["daemon_start_s"] = time.perf_counter() - t0
        stack.enter_context(_loop_storage(env=_remote_env(daemon.port)))
        rc, out = _console_out(["app", "new", INGEST_APP])
        key = re.search(r"^\[INFO\] Access key: (\S+)$", out, re.M)
        check(rc == 0 and key is not None, "app new over the daemon printed no access key")
        key = key.group(1)
        es_env = dict(os.environ, PIO_WAL_DIR=str(wal_dir), PIO_FAULTS_ADMIN="1")
        es = stack.enter_context(_Console(["eventserver", "--ip", "127.0.0.1", "--port", "0"],
                                          REMOTE_DIR / "eventserver.log", env=es_env))
        es_port = es.port(timeout=120)
        ingest = _ingest_posts(es_port, key, events, rng, _remote_outage(daemon, es_port))
        rm["outage"] = _remote_ingest_checks(ingest, es_port, daemon, smi)
        rm["ingest"] = {k: v for k, v in ingest.items() if k not in ("ids", "outage")}
        rm["fault"] = _remote_fault(es_port, key, ingest["spilled"], rng, smi)
        es.interrupt()
        rm["train"] = _remote_train(report, users, items, ratings, smi)
        rm["serve"] = _deploy_queries(
            REMOTE_DIR / "engine_remote.json", REMOTE_DIR / "deploy.log",
            rm["train"].pop("inst"), rm["train"].pop("model"), ALSAlgorithmParams(),
            np.random.default_rng(INGEST_SEED + 2))
    check(daemon.console is None, "the daemon is still running")
    shutil.rmtree(wal_dir, ignore_errors=True)
    sv = rm["serve"]
    rm["launches"] = {**rm["train"]["launches"], "serve_topk": sv.pop("served"),
                      "serve_select": sv.pop("select")}
    rm["phase_s"] = time.perf_counter() - t_phase
    rm["nvidia_smi"] = smi
    report["remote"] = rm
    print(f"[remote] {smi} | deploy over the daemon: ready in {sv['deploy_ready_s']:.2f} s; "
          f"{N_QUERIES} queries from {N_CLIENTS} clients: p50 {sv['p50_ms']:.3f} ms, p99 "
          f"{sv['p99_ms']:.3f} ms, {sv['qps']:.1f} qps, scored top-k launches "
          f"{rm['launches']['serve_topk']} in {sv['batches']} batches (select "
          f"{rm['launches']['serve_select']}), every answer the CPU plain top-k's; phase "
          f"{rm['phase_s']:.1f} s", flush=True)


def _remote_ingest_checks(ingest, es_port, daemon, smi):
    """(b): no event lost or doubled across the killed daemon; the breaker
    opened, and closed through its probe; the WAL drained, replaying as
    many events as were answered 202."""
    seen = ingest["outage"]
    check(seen["breaker_open"], "the events breaker never read 1 (open) while the daemon "
          f"was down ({seen['outage_polls']} polls)")
    check(seen["pending_max"] > 0, "event_wal_pending never rose while the daemon was down")
    check(ingest["spilled"] > 0 and ingest["first_202"] is not None, "no POST answered 202")
    m = _wal_settled(es_port, "the WAL after the outage")
    check(m["pending"] == 0 and m["replayed"] == m["spilled"] == ingest["spilled"],
          f"the WAL: pending {m['pending']:g}, replayed {m['replayed']:g}, spilled "
          f"{m['spilled']:g}; {ingest['spilled']} events answered 202")
    check(all(m["transitions"][st] >= 1 for st in ("open", "half_open", "closed")),
          f"the events breaker's transitions {m['transitions']}")
    # read back from the daemon's sqlite file: the app is read through the
    # daemon's paged find once, by the train in (d), whose frame is held
    # to this file's and to the generated triples
    with _loop_storage(REMOTE_DIR / "store"):
        storage = Storage()
        app_id = storage.get_meta_data_apps().get_by_name(INGEST_APP).id
        stored = [e.event_id for e in storage.get_events().find(EventQuery(app_id=app_id))]
    check(len(stored) == len(set(stored)) == REMOTE_EVENTS
          and set(stored) == set(ingest["ids"]),
          f"read back from the daemon's file: {len(stored)} events, {len(set(stored))} ids, "
          f"{len(set(stored) ^ set(ingest['ids']))} differ from the {REMOTE_EVENTS} acknowledged")
    out = {"spilled": ingest["spilled"], "replayed": m["replayed"],
           "pending_max": seen["pending_max"], "transitions": m["transitions"],
           "posts_at_kill": seen["posts_at_kill"], "posts_at_restart": seen["posts_at_restart"],
           "kill_to_first_202_s": ingest["first_202"] - seen["t_kill"],
           "outage_s": seen["t_restart"] - seen["t_kill"],
           "restart_to_drained_s": seen["t_drained"] - seen["t_restart"],
           "daemon_starts": daemon.starts, "read_back": len(stored)}
    print(f"[remote] {smi} | {REMOTE_EVENTS} ML-100K-shaped events from {INGEST_WRITERS} writers "
          f"through the Event Server over the daemon: {ingest['ingest_s']:.2f} s, "
          f"{ingest['events_per_s']:.1f} events/s (phase 12, direct: see its line); daemon "
          f"SIGKILLed after {seen['posts_at_kill']} POSTs, down "
          f"{out['outage_s']:.2f} s, restarted after {seen['posts_at_restart']}", flush=True)
    print(f"[remote] {smi} | kill to the first 202 {out['kill_to_first_202_s']:.3f} s; "
          f"{out['spilled']} events answered 202 (WAL pending up to {out['pending_max']:g}, "
          f"the events breaker read open), restart to drained "
          f"{out['restart_to_drained_s']:.2f} s, replayed {out['replayed']:g}; breaker "
          f"transitions {out['transitions']}; read back from the daemon's sqlite file: "
          f"{len(stored)} events, every acknowledged id once", flush=True)
    return out


def _remote_fault(es_port, key, spilled, rng, smi):
    """(c): `event.insert:error:1.0` through the fault admin route for a
    burst of buy events: each a 202 with a walId; cleared, each replayed
    and read back once."""
    t0 = time.perf_counter()
    status, body = _call(es_port, "POST", "/debug/faults", {"set": "event.insert:error:1.0"})
    check(status == 200 and [f["point"] for f in body["faults"]] == ["event.insert"],
          f"fault admin: {status} {body}")
    n = REMOTE_FAULT_SINGLES + REMOTE_FAULT_BATCHES * INGEST_BATCH
    buys = [{"event": "buy", "entityType": "user", "entityId": f"u{int(u)}",
             "targetEntityType": "item", "targetEntityId": f"i{int(i)}"}
            for u, i in zip(rng.integers(0, INGEST_USERS, n), rng.integers(0, INGEST_ITEMS, n))]
    acked = []
    for ev in buys[:REMOTE_FAULT_SINGLES]:
        status, body = _call(es_port, "POST", f"/events.json?accessKey={key}", ev)
        check(status == 202 and body.get("walId"), f"a POST under the fault: {status} {body}")
        acked.append(body["eventId"])
    for b in range(REMOTE_FAULT_SINGLES, n, INGEST_BATCH):
        status, body = _call(es_port, "POST", f"/batch/events.json?accessKey={key}",
                             buys[b:b + INGEST_BATCH])
        check(status == 200 and all(r["status"] == 202 and r.get("walId") for r in body),
              f"a batch under the fault: {status} {str(body)[:200]}")
        acked += [r["eventId"] for r in body]
    check(_call(es_port, "POST", "/debug/faults", {"clear": True}) == (200, {"faults": []}),
          "the fault was not cleared")
    m = _wal_settled(es_port, "the fault burst's replay")
    check(m["replayed"] == m["spilled"] == spilled + n,
          f"after the burst: replayed {m['replayed']:g}, spilled {m['spilled']:g}, "
          f"not {spilled + n}")
    storage = Storage()
    app_id = storage.get_meta_data_apps().get_by_name(INGEST_APP).id
    got = [e.event_id for e in storage.get_events().find(
        EventQuery(app_id=app_id, event_names=["buy"]))]
    check(len(got) == len(set(got)) == n and set(got) == set(acked),
          f"the burst read back: {len(got)} buy events, {len(set(got) ^ set(acked))} ids "
          f"differ from the {n} acknowledged")
    print(f"[remote] {smi} | (c) event.insert:error:1.0 through POST /debug/faults: {n} events "
          f"({REMOTE_FAULT_SINGLES} single, {REMOTE_FAULT_BATCHES} batches) each a 202 with a "
          f"walId; cleared, replayed and read back once each; "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return {"events": n, "seconds": time.perf_counter() - t0}


def _remote_train(report, users, items, ratings, smi):
    """(d): `train --engine-json` over the daemon, its frame column for
    column the one read directly from the daemon's sqlite file, the
    windowed kernels launched as phase 12's train launches them and held
    to their plain versions on its plans, its factors bit-equal to the
    same train over the direct store."""
    remote_json = _variant(REMOTE_ENGINE, REMOTE_DIR / "engine_remote.json")
    direct_json = _variant(REMOTE_DIRECT_ENGINE, REMOTE_DIR / "engine_direct.json")
    frames: list = []
    wf.BLOCK_LAUNCHES.update(partials=0, combine=0)  # every count to 0 just before
    df.PASS_LAUNCHES.update(row=0, col=0)
    with _Spy(als, "stage_windowed") as stage:
        inst, model = _train_variant(remote_json, REMOTE_ENGINE, frames)
    launches = {**wf.BLOCK_LAUNCHES, **df.PASS_LAUNCHES}
    params = ALSAlgorithmParams()
    want = 2 * params.num_iterations
    check(launches["partials"] == launches["combine"] == want
          and launches["row"] == launches["col"] == 0,
          f"the train over the daemon launched {launches}, not {want} windowed passes")
    staged = [out for *_, out in stage.calls]
    check(len(staged) == 1 and isinstance(staged[0], als.StagedWindowedTrain),
          f"the train over the daemon staged {len(staged)} windowed trains")
    with _loop_storage(REMOTE_DIR / "store"):
        inst_d, model_d = _train_variant(direct_json, REMOTE_DIRECT_ENGINE, frames)
    remote_frame, direct_frame = frames
    check(len(remote_frame) == REMOTE_EVENTS and _frames_equal(remote_frame, direct_frame),
          "the frame read through the daemon differs from the one read from its sqlite file")
    uid, iid = _ids(remote_frame.entity_vocab, "u"), _ids(remote_frame.target_vocab, "i")
    key = uid[remote_frame.entity_idx] * INGEST_ITEMS + iid[remote_frame.target_idx]
    order, gen = np.argsort(key), np.argsort(users * INGEST_ITEMS + items)
    check(np.array_equal(key[order], (users * INGEST_ITEMS + items)[gen])
          and np.array_equal(remote_frame.value[order], ratings[gen].astype(np.float32)),
          "the frame read through the daemon differs from the generated triples")
    f, fd = model.factors, model_d.factors
    check(_finite(f) and f.user_factors.shape == (INGEST_USERS, RANK), "factors")
    check(np.array_equal(f.user_factors, fd.user_factors)
          and np.array_equal(f.item_factors, fd.item_factors)
          and f.user_vocab.to_dict() == fd.user_vocab.to_dict()
          and f.item_vocab.to_dict() == fd.item_vocab.to_dict(),
          "the factors trained over the daemon are not bit-equal to the direct store's")
    held = {"cases": 0, "max_abs_err": 0.0, "max_ratio": 0.0,
            "combined_max_abs_err": 0.0, "combined_max_ratio": 0.0}
    _windowed_held(staged[0], RANK, np.random.default_rng(INGEST_SEED + 11), held,
                   "remote plan")
    st, std = stage_timings(inst), stage_timings(inst_d)
    print(f"[remote] {smi} | (d) train over the daemon: read {st['read']:.3f} s (direct from "
          f"its sqlite file {std['read']:.3f} s), train {st['train']:.3f} s, persist "
          f"{st['persist']:.4f} s; the frames equal column for column; launches "
          f"block_partials {launches['partials']}, combine {launches['combine']}, held to "
          f"the plain versions (max |err| {held['max_abs_err']:.3g}); factors bit-equal to "
          "the direct store's train", flush=True)
    return {"stages": st, "direct_stages": std, "launches": launches, "held": held,
            "inst": inst, "model": model}


# ---------------------------------------------------------------------------
# phase 12c: the sharded event store over three storage daemons
# ---------------------------------------------------------------------------


SHARDED_DIR = Path(__file__).resolve().parent / "build" / "sharded"
SHARDED_N, SHARDED_REPLICAS = 3, 2  # three daemons, each event on its home and successor
SHARDED_KILLED = 1  # the shard whose daemon (c) SIGKILLs
SHARDED_SEED = 27
SHARDED_NEW_USERS, SHARDED_USER_RATINGS = 1_000, 10  # (d): 10,000 new ratings
SHARDED_ENGINES = ("ml100k-sharded", "ml100k-sharded-failover")
SHARDED_RETRY_ROUNDS = 40  # (d): re-POSTs of the 503s after the restart, 0.25 s apart
SHARDED_WAIT_S = 120.0


def _sharded_env(ports):
    """EVENTDATA a `sharded` source over the daemons on `ports` at
    SHARDED_REPLICAS; METADATA and MODELDATA on one unsharded local source
    (sqlite and model files under SHARDED_DIR/meta)."""
    meta = SHARDED_DIR / "meta"
    return {"PIO_FS_BASEDIR": str(meta),
            "PIO_STORAGE_SOURCES_SHARDS_TYPE": "sharded",
            "PIO_STORAGE_SOURCES_SHARDS_SHARDS": ",".join(f"127.0.0.1:{p}" for p in ports),
            "PIO_STORAGE_SOURCES_SHARDS_REPLICAS": str(SHARDED_REPLICAS),
            # a shard's bulk write carries a third of the import in one RPC
            "PIO_STORAGE_SOURCES_SHARDS_TIMEOUT": "120",
            # the restarted daemon's breaker probes after half a second
            "PIO_STORAGE_SOURCES_SHARDS_BREAKER_COOLDOWN": "0.5",
            "PIO_STORAGE_SOURCES_META_TYPE": "sqlite",
            "PIO_STORAGE_SOURCES_META_PATH": str(meta / "pio.db"),
            "PIO_STORAGE_SOURCES_MODELS_TYPE": "localfs",
            "PIO_STORAGE_SOURCES_MODELS_PATH": str(meta),
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SHARDS",
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "META",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MODELS"}


def _rpc_finds(port):
    """The daemon's storage_rpc_total{dao="events",method="find"}."""
    status, text = _get(port, "/metrics")
    check(status == 200, f"daemon :{port} /metrics: HTTP {status}")
    return sum(v for (n, lbl), v in _prometheus(text).items()
               if n == "storage_rpc_total" and 'dao="events"' in lbl
               and 'method="find"' in lbl)


def _rating_keys(events):
    """(user * INGEST_ITEMS + item, rating) arrays of rate events, sorted
    by key."""
    key = np.fromiter((int(e.entity_id[1:]) * INGEST_ITEMS + int(e.target_entity_id[1:])
                       for e in events), np.int64, count=len(events))
    val = np.fromiter((e.properties.get("rating") for e in events), np.float64,
                      count=len(events))
    order = np.argsort(key, kind="stable")
    return key[order], val[order]


def _console_err(argv):
    """console.main(argv)'s exit code, stdout and stderr (echoed)."""
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = console.main(argv)
    finally:
        print(out.getvalue(), end="", flush=True)
        print(err.getvalue(), end="", file=sys.stderr, flush=True)
    return rc, out.getvalue(), err.getvalue()


def phase_sharded(report, shared):
    """Phase 12c: phase 12's ML-100K events over a `sharded` source of
    three `console storageserver` daemons at REPLICAS=2: the import, the
    partitioned reads, the self-check, a daemon SIGKILLed and the train
    through the successor failover, a partial outage through the Event
    Server, the fold-in over the per-shard streams and 500 queries."""
    t_phase = time.perf_counter()
    smi = report["nvidia_smi"]
    users, items, ratings = shared["ingest"]
    shutil.rmtree(SHARDED_DIR, ignore_errors=True)
    (SHARDED_DIR / "meta").mkdir(parents=True)
    daemons = [_StorageDaemon(SHARDED_DIR / f"shard{i}", SHARDED_DIR, f"shard{i}-")
               for i in range(SHARDED_N)]
    home_of_user = np.array([shard_of(f"u{u}", SHARDED_N)
                             for u in range(INGEST_USERS + SHARDED_NEW_USERS)])
    home = home_of_user[users]
    want = {}  # shard → its home events' sorted (key, rating)
    for i in range(SHARDED_N):
        k = users[home == i] * INGEST_ITEMS + items[home == i]
        order = np.argsort(k, kind="stable")
        want[i] = (k[order], ratings[home == i][order].astype(np.float64))
    sh: dict = {"nvidia_smi": smi}
    with contextlib.ExitStack() as stack:
        for d in daemons:
            d.store.mkdir(parents=True)
            stack.callback(d.close)  # a failed phase leaves no daemon running
        t0 = time.perf_counter()
        for d in daemons:  # the three start at once
            d.spawn()
        for d in daemons:
            d.wait()
        sh["daemons_start_s"] = time.perf_counter() - t0
        ports = [d.port for d in daemons]
        stack.enter_context(_loop_storage(env=_sharded_env(ports)))
        app_id, key = _sharded_import(sh, shared["ingest_events"], ports, want)
        _sharded_reads(sh, app_id, ports, want)
        _sharded_failover(sh, stack, app_id, ports, daemons, users, items, ratings)
        _sharded_outage(sh, stack, app_id, key, ports, daemons, home_of_user)
        _sharded_serve(sh, app_id)
    check(all(d.console is None for d in daemons), "a daemon is still running")
    sh["phase_s"] = time.perf_counter() - t_phase
    report["sharded"] = sh
    a, b, c, d, e = sh["a"], sh["b"], sh["c"], sh["d"], sh["e"]
    print(f"[sharded] {smi} | (a) {INGEST_EDGES} ML-100K events imported through a sharded "
          f"source of {SHARDED_N} daemons at REPLICAS={SHARDED_REPLICAS} in "
          f"{a['import_s']:.2f} s ({INGEST_EDGES / a['import_s']:.1f} events/s); the daemons "
          f"hold {a['rows']} rows (home + copies {a['held']}), each its predecessor's copies "
          f"exactly (read through plain remote sources in {a['copies_read_s']:.2f} s)",
          flush=True)
    print(f"[sharded] {smi} | (b) shard=(i, {SHARDED_N}) reads: {b['rows']} events in "
          f"{b['read_s']} s, each answered by daemon i alone (storage_rpc_total finds "
          f"{b['finds']}), disjoint, their union the file's {INGEST_EDGES}", flush=True)
    print(f"[sharded] {smi} | (c) status: {SHARDED_N} OK shard lines; shard {SHARDED_KILLED} "
          f"SIGKILLed: status exit {c['status_rc']}, naming it; train before the kill: read "
          f"{c['before']['read']:.3f} s, train {c['before']['train']:.3f} s; through the "
          f"failover: read {c['after']['read']:.3f} s, train {c['after']['train']:.3f} s; "
          f"frames equal, factors bit-equal; launches block_partials {c['launches']['partials']}"
          f", combine {c['launches']['combine']}, held to the plain versions (max |err| "
          f"{c['held']['max_abs_err']:.3g})", flush=True)
    print(f"[sharded] {smi} | (d) {d['events']} new ratings from {INGEST_WRITERS} writers with "
          f"shard {SHARDED_KILLED} down: {d['ingest_s']:.2f} s, {d['n201']} answered 201 and "
          f"{d['n503']} 503 by position; restarted in {d['restart_s']:.2f} s, the 503s "
          f"re-POSTed in {d['retry_rounds']} rounds ({d['retry_s']:.2f} s), every event once on "
          f"its home", flush=True)
    print(f"[sharded] {smi} | (e) consumer over {SHARDED_N} shard streams: {e['consumed']} "
          f"events consumed and {e['folded']} folded once on cuda:0 in {e['ticks']} ticks "
          f"({e['fold_s']:.2f} s); {N_QUERIES} queries from {N_CLIENTS} clients: p50 "
          f"{e['p50_ms']:.3f} ms, p99 {e['p99_ms']:.3f} ms, {e['qps']:.1f} qps, {e['batches']} "
          f"batches, top-k launches {sh['launches']['serve_topk']} (select "
          f"{sh['launches']['serve_select']}, profiler {e['profiled']}); every answer the CPU "
          f"plain top-k's; phase {sh['phase_s']:.1f} s", flush=True)


def _sharded_import(sh, events, ports, want):
    """(a) `app new` and `import` into the sharded source; each daemon,
    asked through a plain remote source, holds its home events and its
    predecessor's copies exactly, 2 x INGEST_EDGES rows in all."""
    rc, out = _console_out(["app", "new", INGEST_APP])
    key = re.search(r"^\[INFO\] Access key: (\S+)$", out, re.M)
    check(rc == 0 and key is not None, "app new over the sharded source printed no access key")
    path = SHARDED_DIR / "events.jsonl"
    path.write_text("".join(json.dumps(e) + "\n" for e in events))
    t0 = time.perf_counter()
    check(console.main(["import", "--app", INGEST_APP, "--input", str(path)]) == 0,
          "import into the sharded source")
    import_s = time.perf_counter() - t0
    app_id = Storage().get_meta_data_apps().get_by_name(INGEST_APP).id
    def copies_of(i):  # daemon i's rows and its predecessor's copies, through it
        direct = _remote_events(ports[i])
        return (int(direct.data_signature(app_id).split(":")[0]), list(direct.find(
            EventQuery(app_id=app_id, shard=((i - 1) % SHARDED_N, SHARDED_N)))))

    held, t0 = [], time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(SHARDED_N) as pool:  # the daemons at once
        answers = list(pool.map(copies_of, range(SHARDED_N)))
    for i, (rows, copies) in enumerate(answers):
        prev = (i - 1) % SHARDED_N
        k, v = _rating_keys(copies)
        check(np.array_equal(k, want[prev][0]) and np.array_equal(v, want[prev][1]),
              f"daemon {i}'s copies differ from shard {prev}'s events in the file")
        check(rows == len(want[i][0]) + len(want[prev][0]),
              f"daemon {i} holds {rows} rows, not its {len(want[i][0])} home events and "
              f"{len(want[prev][0])} copies")
        held.append(rows)
    check(sum(held) == SHARDED_REPLICAS * INGEST_EDGES, f"the daemons hold {held}")
    sh["a"] = {"import_s": import_s, "rows": sum(held), "held": held,
               "copies_read_s": time.perf_counter() - t0}
    return app_id, key.group(1)


def _sharded_reads(sh, app_id, ports, want):
    """(b) shard=(i, N) through the sharded store: each answered by
    daemon i alone, disjoint, their union the file's events."""
    store = Storage().get_events()
    check(type(store).__name__ == "ShardedEventStore" and store.n_shards == SHARDED_N
          and store.replicas == SHARDED_REPLICAS,
          f"EVENTDATA is {type(store).__name__}, not a {SHARDED_N}-shard sharded store")
    ids, finds, secs, rows = set(), [], [], 0
    for i in range(SHARDED_N):
        before = [_rpc_finds(p) for p in ports]
        t0 = time.perf_counter()
        part = list(store.find(EventQuery(app_id=app_id, shard=(i, SHARDED_N))))
        secs.append(round(time.perf_counter() - t0, 3))
        moved = [_rpc_finds(p) - b for p, b in zip(ports, before)]
        check(moved[i] > 0 and all(m == 0 for j, m in enumerate(moved) if j != i),
              f"shard=({i}, {SHARDED_N}) moved the daemons' find counts by {moved}")
        finds.append(moved)
        k, v = _rating_keys(part)
        check(np.array_equal(k, want[i][0]) and np.array_equal(v, want[i][1]),
              f"shard=({i}, {SHARDED_N}) differs from shard {i}'s events in the file")
        part_ids = {e.event_id for e in part}
        check(len(part_ids) == len(part) and not part_ids & ids,
              f"shard {i}'s read repeats an id or meets another shard's")
        ids |= part_ids
        rows += len(part)
    check(rows == len(ids) == INGEST_EDGES, f"the shard reads hold {rows} events")
    sh["b"] = {"rows": rows, "read_s": secs, "finds": finds}


def _sharded_status(ports, down=None):
    """`console status`: one OK line a shard, or exit 1 naming `down`."""
    rc, out, err = _console_err(["status"])
    for i, port in enumerate(ports):
        line = f"shard {i} @ 127.0.0.1:{port}"
        if i == down:
            check(f"DOWN {line}" in err, f"status did not name shard {i} down: {err[-500:]}")
        else:
            check(f"OK {line}" in (out if down is None else err),
                  f"status printed no OK line for shard {i}")
    if down is None:
        check(rc == 0, f"status exited {rc} with every daemon up")
    else:
        check(rc == 1 and f"event store shards down: {down} (127.0.0.1:{ports[down]})" in err,
              f"status exited {rc} with shard {down} down: {err[-500:]}")
    return rc


def _sharded_train(engine_id, frames):
    """`train --engine-json` over the sharded source: its instance, model,
    stage timings, windowed launches and staged train."""
    engine_json = _variant(engine_id, SHARDED_DIR / f"engine_{engine_id}.json")
    wf.BLOCK_LAUNCHES.update(partials=0, combine=0)  # every count to 0 just before
    df.PASS_LAUNCHES.update(row=0, col=0)
    with _Spy(als, "stage_windowed") as stage:
        inst, model = _train_variant(engine_json, engine_id, frames)
    launches = {**wf.BLOCK_LAUNCHES, **df.PASS_LAUNCHES}
    want = 2 * ALSAlgorithmParams().num_iterations
    check(launches["partials"] == launches["combine"] == want
          and launches["row"] == launches["col"] == 0,
          f"the train over the sharded source launched {launches}, not {want} windowed passes")
    staged = [out for *_, out in stage.calls]
    check(len(staged) == 1 and isinstance(staged[0], als.StagedWindowedTrain),
          f"the train staged {len(staged)} windowed trains")
    return inst, model, launches, staged[0]


def _sharded_failover(sh, stack, app_id, ports, daemons, users, items, ratings):
    """(c) status with every daemon up; a train; the query server and its
    consumer (cursors at each stream's head); shard SHARDED_KILLED
    SIGKILLed; status fails naming it; the same train through the
    successor failover: frames equal, factors bit-equal, kernels held."""
    _sharded_status(ports)
    frames: list = []
    inst_a, model_a, la, _ = _sharded_train(SHARDED_ENGINES[0], frames)
    frame = frames[0]
    check(len(frame) == INGEST_EDGES, f"the train read {len(frame)} events")
    uid, iid = _ids(frame.entity_vocab, "u"), _ids(frame.target_vocab, "i")
    key = uid[frame.entity_idx] * INGEST_ITEMS + iid[frame.target_idx]
    order, gen = np.argsort(key), np.argsort(users * INGEST_ITEMS + items)
    check(np.array_equal(key[order], (users * INGEST_ITEMS + items)[gen])
          and np.array_equal(frame.value[order], ratings[gen].astype(np.float32)),
          "the frame read through the sharded source differs from the generated triples")
    # the query server on the first train, its consumer seeded at every
    # stream's head before the kill
    storage = Storage()
    runtime = build_runtime(storage, inst_a)
    check(str(runtime.models[0].device) == "cuda:0",
          f"the model is on {runtime.models[0].device}")
    rec.LAUNCHES = 0  # every count to 0 just before the main path's serving
    rec.ROUTE_LAUNCHES.update(select=0, sort=0)
    srv = QueryServer(runtime=runtime, storage=storage,
                      config=QueryServerConfig(ip="127.0.0.1", port=0))
    sh["port"] = srv.start()
    stack.callback(srv.stop)
    consumer = OnlineConsumer(storage, ServerApplyHost(srv), app_id,
                              OnlineConsumerConfig(tick_s=3600, from_latest=True))
    check(sorted(consumer.cursor) == [f"shard{i}" for i in range(SHARDED_N)],
          f"the consumer's cursor {consumer.cursor} is not one a shard stream")
    sh["srv"], sh["consumer"], sh["cursor0"] = srv, consumer, dict(consumer.cursor)
    t_kill = daemons[SHARDED_KILLED].kill()
    rc = _sharded_status(ports, down=SHARDED_KILLED)
    inst_b, model_b, lb, staged_b = _sharded_train(SHARDED_ENGINES[1], frames)
    check(_frames_equal(frames[1], frames[0]),
          "the frame read through the failover differs from the one read before the kill")
    fa, fb = model_a.factors, model_b.factors
    check(_finite(fb) and _bit_equal(fa, fb) and fa.user_vocab.to_dict() == fb.user_vocab.to_dict()
          and fa.item_vocab.to_dict() == fb.item_vocab.to_dict(),
          "the factors trained through the failover are not bit-equal to those before the kill")
    held = {"cases": 0, "max_abs_err": 0.0, "max_ratio": 0.0,
            "combined_max_abs_err": 0.0, "combined_max_ratio": 0.0}
    _windowed_held(staged_b, RANK, np.random.default_rng(SHARDED_SEED), held, "sharded plan")
    sh["c"] = {"status_rc": rc, "before": stage_timings(inst_a), "after": stage_timings(inst_b),
               "launches": {k: la[k] + lb[k] for k in la}, "held": held,
               "kill_to_trained_s": time.perf_counter() - t_kill}


def _sharded_events(rng):
    """(d)'s traffic: SHARDED_NEW_USERS new users, each rating
    SHARDED_USER_RATINGS distinct ML-100K movies 1-5, in a random order
    a second apart after every earlier time, as Event Server JSON."""
    rows = [(INGEST_USERS + u, int(i), int(rng.integers(1, 6)))
            for u in range(SHARDED_NEW_USERS)
            for i in rng.choice(INGEST_ITEMS, SHARDED_USER_RATINGS, replace=False)]
    t0 = INGEST_T0_MS + 1000 * (INGEST_EDGES + 50_000)
    return [{"event": "rate", "entityType": "user", "entityId": f"u{rows[j][0]}",
             "targetEntityType": "item", "targetEntityId": f"i{rows[j][1]}",
             "properties": {"rating": rows[j][2]}, "eventTime": _ms_iso(t0 + 1000 * n)}
            for n, j in enumerate(rng.permutation(len(rows)).tolist())], t0


def _post_all(port, key, bodies):
    """Batches of INGEST_BATCH of `bodies` from INGEST_WRITERS threads:
    each body's (status, answer) by position, and the wall seconds."""
    work = [(j, f"/batch/events.json?accessKey={key}",
             json.dumps(bodies[b:b + INGEST_BATCH]))
            for j, b in enumerate(range(0, len(bodies), INGEST_BATCH))]
    out: dict = {}
    lock = threading.Lock()
    threads = [threading.Thread(target=_post_work, args=(port, work[w::INGEST_WRITERS], out,
                                                         lock))
               for w in range(INGEST_WRITERS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(not any(t.is_alive() for t in threads), "writers hung")
    answers = []
    for j in range(len(work)):
        status, body, _, _ = out[j]
        check(status == 200, f"batch POST {j}: HTTP {status} {str(body)[:200]}")
        answers += body
    check(len(answers) == len(bodies), f"{len(answers)} answers for {len(bodies)} events")
    return answers, time.perf_counter() - t0


def _sharded_outage(sh, stack, app_id, key, ports, daemons, home_of_user):
    """(d) `eventserver` over the sharded source with shard SHARDED_KILLED
    still down: new ratings from INGEST_WRITERS writers, 201 where the
    home shard is up and 503 where it is down, by position; the daemon
    restarted on its file and the 503s re-POSTed; every event once on its
    home."""
    events, t0_ms = _sharded_events(np.random.default_rng(SHARDED_SEED))
    es = stack.enter_context(_Console(["eventserver", "--ip", "127.0.0.1", "--port", "0"],
                                      SHARDED_DIR / "eventserver.log"))
    es_port = es.port(timeout=120)
    homes = [int(home_of_user[int(e["entityId"][1:])]) for e in events]
    answers, ingest_s = _post_all(es_port, key, events)
    for n, (a, h) in enumerate(zip(answers, homes)):
        check((a["status"], a.get("message")) == (
            (503, "storage shard unavailable") if h == SHARDED_KILLED else (201, None)),
            f"event {n} (home shard {h}) answered {a}")
    ids = {n: a["eventId"] for n, a in enumerate(answers) if a["status"] == 201}
    t0 = time.perf_counter()
    daemons[SHARDED_KILLED].start()
    restart_s = time.perf_counter() - t0
    pending, rounds, t0 = [n for n, h in enumerate(homes) if h == SHARDED_KILLED], 0, \
        time.perf_counter()
    while pending:
        check(rounds < SHARDED_RETRY_ROUNDS, f"{len(pending)} events still refused after "
                                              f"{rounds} rounds of re-POSTs")
        if rounds:
            time.sleep(0.25)
        rounds += 1
        again, _ = _post_all(es_port, key, [events[n] for n in pending])
        left = []
        for n, a in zip(pending, again):
            check(a["status"] in (201, 503), f"a re-POST of event {n} answered {a}")
            if a["status"] == 201:
                ids[n] = a["eventId"]
            else:
                left.append(n)
        pending = left
    retry_s = time.perf_counter() - t0
    check(es.interrupt() is not None, "eventserver did not stop")
    since = datetime.datetime.fromtimestamp(t0_ms / 1e3, datetime.timezone.utc)
    for i, port in enumerate(ports):
        got = [e.event_id for e in _remote_events(port).find(
            EventQuery(app_id=app_id, start_time=since, shard=(i, SHARDED_N)))]
        mine = {ids[n] for n, h in enumerate(homes) if h == i}
        check(len(got) == len(set(got)) == len(mine) and set(got) == mine,
              f"shard {i} holds {len(got)} of (d)'s events ({len(set(got) ^ mine)} differ "
              f"from the {len(mine)} answered 201 for it)")
    n503 = sum(h == SHARDED_KILLED for h in homes)
    sh["d"] = {"events": len(events), "ingest_s": ingest_s, "n201": len(events) - n503,
               "n503": n503, "restart_s": restart_s, "retry_rounds": rounds,
               "retry_s": retry_s}


def _sharded_serve(sh, app_id):
    """(e) The consumer over the per-shard streams folds (d)'s events
    once each; a second consumer at its persisted cursor consumes none;
    500 queries for folded and known users, each the plain top-k on the
    CPU, one select a device batch by the route and by devprof."""
    srv, consumer, port = sh.pop("srv"), sh.pop("consumer"), sh.pop("port")
    n_events = sh["d"]["events"]
    fold_devices = []
    fold_of = als.fold_in_rows

    def fold(fixed, edges, params, device=None):
        fold_devices.append(str(device))
        return fold_of(fixed, edges, params, device=device)

    als.fold_in_rows = fold
    t0, ticks = time.perf_counter(), 0
    try:
        while True:
            check(time.perf_counter() - t0 < SHARDED_WAIT_S, f"the consumer did not drain (d) "
                                                            f"within {SHARDED_WAIT_S} s")
            out = consumer.tick()
            ticks += 1
            if "idle" in out and not consumer.foldin.pending_items:
                break
    finally:
        als.fold_in_rows = fold_of
    fold_s = time.perf_counter() - t0
    c = dict(consumer.counters)
    check(c["events_consumed"] == c["events_folded"] == n_events,
          f"the consumer consumed {c['events_consumed']} and folded {c['events_folded']} of "
          f"{n_events} events")
    check(c["users_folded"] >= SHARDED_NEW_USERS and consumer.status()["last_error"] is None,
          f"the consumer: {consumer.status()}")
    check(fold_devices and set(fold_devices) == {"cuda:0"},
          f"folds ran on {sorted(set(fold_devices))}")
    storage = Storage()
    again = OnlineConsumer(storage, ServerApplyHost(srv), app_id,
                           OnlineConsumerConfig(tick_s=3600, from_latest=True))
    check(again.cursor == consumer.cursor and again.tick() == {"idle": "no new events"}
          and again.counters == c, f"a restarted consumer: {again.cursor} {again.counters}")
    model = srv.runtime.models[0]
    check(str(model.device) == "cuda:0", f"the folded model is on {model.device}")
    f = model.factors
    new = [f"u{INGEST_USERS + u}" for u in range(SHARDED_NEW_USERS)]
    check(all(f.user_vocab.contains(u) for u in new), "a folded user is not served")
    rng = np.random.default_rng(SHARDED_SEED + 1)
    picks = rng.choice(new, N_QUERIES // 2, replace=False).tolist()
    queries = ([{"user": u, "num": int(rng.choice([5, 10, 20, 50]))} for u in picks]
               + [{"user": f"u{int(u)}", "num": int(rng.choice([5, 10, 20, 50]))}
                  for u in rng.integers(0, INGEST_USERS, N_QUERIES - len(picks))])
    queries = [queries[n] for n in rng.permutation(len(queries)).tolist()]
    st0, prof0 = _status(port), _exec_totals("als.recommend_serving")
    l0, s0 = rec.LAUNCHES, rec.ROUTE_LAUNCHES["select"]
    out, wall = _serve_load(port, queries)
    st1, prof1 = _status(port), _exec_totals("als.recommend_serving")
    batches = st1["batches"] - st0["batches"]
    served, select = rec.LAUNCHES - l0, rec.ROUTE_LAUNCHES["select"] - s0
    profiled = prof1[0] - prof0[0]
    check(batches > 0 and served == select == batches == profiled
          and st1["kernel_launches"] - st0["kernel_launches"] == batches,
          f"top-k launches {served} (select {select}, profiler {profiled}) != batches {batches}")
    check(srv.runtime.models[0] is model, "the model changed during the queries")
    cpu_model = ALSModel(f, device="cpu")
    cpu_alg = ALSAlgorithm(ALSAlgorithmParams())
    for n, qy in enumerate(queries):
        check(out[n][1] == _to_jsonable(cpu_alg.predict(cpu_model, Query(**qy))),
              f"query {n} ({qy}) differs from the CPU plain top-k")
    tally = {"cases": 0, "max_abs_err": 0.0}
    _select_held(model._serving_state, rng, tally, "sharded slab")
    sh["launches"] = {**sh["c"]["launches"], "serve_topk": served, "serve_select": select}
    sh["e"] = {"consumed": c["events_consumed"], "folded": c["events_folded"],
               "users_folded": c["users_folded"], "ticks": ticks, "fold_s": fold_s,
               "cursor": dict(consumer.cursor), **_latency(out, wall, len(queries)),
               "batches": batches, "profiled": profiled, "held": tally}


# ---------------------------------------------------------------------------
# phase 12d: the parquetfs and postgres event stores
# ---------------------------------------------------------------------------


BACKENDS_DIR = Path(__file__).resolve().parent / "build" / "backends"
BACKENDS_SEED = 28
PARQUET_ENGINE, POSTGRES_ENGINE = "ml100k-parquetfs", "ml100k-postgres"
LOG_FIELDS = ("ts", "level", "logger", "message")  # the JAX RemoteLogHandler's


def _parquetfs_env():
    """EVENTDATA a parquetfs source; metadata in sqlite and models in files
    beside it, under build/backends/parquetfs/."""
    d = BACKENDS_DIR / "parquetfs"
    return {"PIO_FS_BASEDIR": str(d),
            "PIO_STORAGE_SOURCES_PQMETA_TYPE": "sqlite",
            "PIO_STORAGE_SOURCES_PQMETA_PATH": str(d / "pio.db"),
            "PIO_STORAGE_SOURCES_PQEVENTS_TYPE": "parquetfs",
            "PIO_STORAGE_SOURCES_PQEVENTS_PATH": str(d / "events"),
            "PIO_STORAGE_SOURCES_PQFS_TYPE": "localfs",
            "PIO_STORAGE_SOURCES_PQFS_PATH": str(d),
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "PQMETA",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "PQEVENTS",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "PQFS"}


def _postgres_config(port):
    """Every repository on one postgres source at 127.0.0.1:`port`."""
    return StorageConfig(
        sources={"PGSQL": SourceConfig("PGSQL", "postgres", {
            "HOST": "127.0.0.1", "PORT": str(port), "DBNAME": "pio"})},
        repositories={"METADATA": "PGSQL", "EVENTDATA": "PGSQL", "MODELDATA": "PGSQL"})


def _console_child(argv, env, log_path):
    """`console argv` in a process of its own over `env` (this process's
    PIO_STORAGE_* variables left out): its exit code, its output and its
    seconds."""
    full = {k: v for k, v in os.environ.items() if not k.startswith("PIO_STORAGE_")}
    full.update(env)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "predictionio_tpu_torch.tools.console", *argv],
                         cwd=Path(__file__).resolve().parent, env=full, capture_output=True,
                         text=True, timeout=600)
    log_path.write_text(out.stdout + out.stderr)
    return out.returncode, out.stdout, time.perf_counter() - t0


class _LogCollector:
    """A `--log-url` collector in this process: the JSON lines POSTed to
    it, with each POST's content type."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.records: list = []
        self.types: set = set()
        lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                rows = [json.loads(x) for x in body.decode().splitlines() if x.strip()]
                with lock:
                    outer.records.extend(rows)
                    outer.types.add(self.headers.get("Content-Type"))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.server.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}/logs"

    def close(self):
        self.server.shutdown()
        self.server.server_close()

    def checked(self, n_queries, label):
        """The records shipped by a server that answered `n_queries`
        queries and stopped: each has the JAX fields; the access log holds
        one 200 a query, each record with its request's trace id."""
        recs = list(self.records)
        check(recs and all(all(k in r for k in LOG_FIELDS) for r in recs),
              f"{label}: shipped records lack the RemoteLogHandler fields: {recs[:2]}")
        check(self.types == {"application/x-ndjson"}, f"{label}: POSTed as {self.types}")
        access = [r for r in recs if r["logger"] == "predictionio_tpu_torch.access"]
        lines = [json.loads(r["message"]) for r in access]
        queries = [a for a in lines if a["path"] == "/queries.json"]
        check(len(queries) == n_queries and {a["status"] for a in queries} == {200},
              f"{label}: {len(queries)} query access records shipped for {n_queries}")
        check(all(r.get("trace_id") == a["trace_id"] and a["trace_id"]
                  for r, a in zip(access, lines)), f"{label}: a record without its trace id")
        return {"records": len(recs), "access": len(access), "queries": len(queries)}


def _triples_equal(frame, users, items, ratings):
    uid, iid = _ids(frame.entity_vocab, "u"), _ids(frame.target_vocab, "i")
    key = uid[frame.entity_idx] * INGEST_ITEMS + iid[frame.target_idx]
    order, gen = np.argsort(key), np.argsort(users * INGEST_ITEMS + items)
    return (len(frame) == INGEST_EDGES
            and np.array_equal(key[order], (users * INGEST_ITEMS + items)[gen])
            and np.array_equal(frame.value[order], ratings[gen].astype(np.float32)))


def _backend_train_checks(label, launches, stage, frame, model, shared, seed):
    """The checks of a train over a backend: the windowed kernels 2 x
    iterations and no dense pass, one staged windowed train held to the
    plain versions, the frame the generated triples, and the factors
    bit-equal to phase 12's sqlite train where the frame equals its frame
    column for column (printed either way)."""
    want = 2 * ALSAlgorithmParams().num_iterations
    check(launches["partials"] == launches["combine"] == want
          and launches["row"] == launches["col"] == 0,
          f"{label}: the train launched {launches}, not {want} windowed passes")
    staged = [out for *_, out in stage.calls]
    check(len(staged) == 1 and isinstance(staged[0], als.StagedWindowedTrain),
          f"{label}: the train staged {len(staged)} windowed trains")
    users, items, ratings = shared["ingest"]
    check(_triples_equal(frame, users, items, ratings),
          f"{label}: the frame differs from the generated (user, item, rating) triples")
    f = model.factors
    check(_finite(f) and f.user_factors.shape == (INGEST_USERS, RANK)
          and f.item_factors.shape == (INGEST_ITEMS, RANK), f"{label}: factors")
    base = shared["ingest_train"]
    same_frame = _frames_equal(frame, base["frame"])
    bit_equal = (np.array_equal(f.user_factors, base["factors"].user_factors)
                 and np.array_equal(f.item_factors, base["factors"].item_factors)
                 and f.user_vocab.to_dict() == base["factors"].user_vocab.to_dict()
                 and f.item_vocab.to_dict() == base["factors"].item_vocab.to_dict())
    check(bit_equal or not same_frame,
          f"{label}: the frame equals phase 12's sqlite frame but the factors differ")
    held = {"cases": 0, "max_abs_err": 0.0, "max_ratio": 0.0,
            "combined_max_abs_err": 0.0, "combined_max_ratio": 0.0}
    _windowed_held(staged[0], RANK, np.random.default_rng(seed), held, f"{label} plan")
    return {"launches": launches, "held": held, "same_frame": same_frame,
            "bit_equal": bit_equal}


def phase_backends(report, shared):
    """Phase 12d: phase 12's ML-100K events over the parquetfs and the
    postgres event stores, each feeding a windowed train and a deploy on
    the card, with the parquet export/import, log shipping to a collector
    and the engine manifests."""
    t_phase = time.perf_counter()
    smi = report["nvidia_smi"]
    shutil.rmtree(BACKENDS_DIR, ignore_errors=True)
    (BACKENDS_DIR / "parquetfs").mkdir(parents=True)
    bk: dict = {"nvidia_smi": smi}
    collector = _LogCollector()
    try:
        # (a)'s export and import children run beside (b), which reads
        # the loop's sqlite file itself and runs in this process
        with _loop_storage(env=_parquetfs_env()):
            rc, text = _console_out(["app", "new", INGEST_APP])
        check(rc == 0 and "Access key: " in text, "app new over parquetfs")
        children = _Background(_backends_export_import)
        bk["postgres"] = _backends_postgres(report, shared, collector)
        collector.records.clear()
        bk["parquetfs"] = _backends_parquetfs(report, shared, collector.url, children.result())
        bk["parquetfs"]["shipped"] = collector.checked(N_QUERIES, "parquetfs deploy")
    finally:
        collector.close()
    pq, pg = bk["parquetfs"], bk["postgres"]
    bk["launches"] = {k: pq["train"]["launches"][k] + pg["train"]["launches"][k]
                      for k in ("partials", "combine", "row", "col")}
    bk["launches"].update(serve_topk=pq["serve"]["served"] + pg["serve"]["served"],
                          serve_select=pq["serve"]["select"] + pg["serve"]["select"])
    bk["held"] = {"max_abs_err": max(pq["train"]["held"]["max_abs_err"],
                                     pg["train"]["held"]["max_abs_err"])}
    bk["phase_s"] = time.perf_counter() - t_phase
    report["backends"] = bk
    print(f"[backends] {smi} | phase 12d {bk['phase_s']:.1f} s: parquetfs "
          f"{pq['phase_s']:.1f} s, postgres {pg['phase_s']:.1f} s; launches "
          f"block_partials {bk['launches']['partials']}, combine {bk['launches']['combine']}, "
          f"scored top-k {bk['launches']['serve_topk']} (select "
          f"{bk['launches']['serve_select']})", flush=True)


class _Background:
    """`fn()` on a thread of its own; `result()` joins it and returns its
    value, or raises what it raised."""

    def __init__(self, fn):
        self.value, self.error = None, None

        def run():
            try:
                self.value = fn()
            except BaseException as e:  # noqa: BLE001 — raised again by result()
                self.error = e

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def result(self, timeout=900):
        self.thread.join(timeout)
        check(not self.thread.is_alive(), f"a background step ran past {timeout} s")
        if self.error is not None:
            raise self.error
        return self.value


def _backends_export_import():
    """(a)'s console children: `export --format parquet` of phase 12's app
    from the loop's sqlite store, then `import` of the file (its .parquet
    suffix names the codec) into the parquetfs app."""
    path = BACKENDS_DIR / "ml100k.parquet"
    out: dict = {}
    rc, text, out["export_s"] = _console_child(
        ["export", "--app", INGEST_APP, "--output", str(path), "--format", "parquet"],
        _store_env(LOOP_DIR / "store"), BACKENDS_DIR / "export.log")
    check(rc == 0 and f"Exported {INGEST_EDGES} events" in text, f"export: {rc} {text}")
    rc, text, out["import_s"] = _console_child(
        ["import", "--app", INGEST_APP, "--input", str(path)], _parquetfs_env(),
        BACKENDS_DIR / "import.log")
    check(rc == 0 and f"Imported {INGEST_EDGES} events" in text, f"import: {rc} {text}")
    return out


def _backends_parquetfs(report, shared, log_url, children):
    """(a) Over the parquetfs app that `children` (the export and import
    children) filled: `train --engine-json` here; `deploy --log-url` in
    its own process and 500 queries."""
    smi = report["nvidia_smi"]
    t0 = time.perf_counter()
    out: dict = dict(children)
    env = _parquetfs_env()
    with _loop_storage(env=env):
        segs = sorted((BACKENDS_DIR / "parquetfs" / "events").glob("app_*/seg-*.parquet"))
        check(segs, "the import wrote no parquet segment")
        out["segments"] = len(segs)
        engine_json = _variant(PARQUET_ENGINE, BACKENDS_DIR / "engine_parquetfs.json")
        frames: list = []
        wf.BLOCK_LAUNCHES.update(partials=0, combine=0)  # every count to 0 just before
        df.PASS_LAUNCHES.update(row=0, col=0)
        with _Spy(als, "stage_windowed") as stage:
            inst, model = _train_variant(engine_json, PARQUET_ENGINE, frames)
        launches = {**wf.BLOCK_LAUNCHES, **df.PASS_LAUNCHES}
        out["stages"] = stage_timings(inst)
        out["train"] = _backend_train_checks("parquetfs", launches, stage, frames[0], model,
                                             shared, BACKENDS_SEED)
        del frames, stage
        out["serve"] = _deploy_queries(
            engine_json, BACKENDS_DIR / "deploy_parquetfs.log", inst, model,
            ALSAlgorithmParams(), np.random.default_rng(BACKENDS_SEED + 1),
            extra_args=("--log-url", log_url), profiled=True)
    out["phase_s"] = time.perf_counter() - t0
    st, sv, tr = out["stages"], out["serve"], out["train"]
    print(f"[backends] {smi} | (a) parquetfs: export {out['export_s']:.2f} s, import "
          f"{out['import_s']:.2f} s ({out['segments']} segment(s)), both console children "
          f"beside (b); "
          f"train read {st['read']:.3f} s, train {st['train']:.3f} s; the frame equals phase "
          f"12's sqlite frame column for column: {tr['same_frame']}; factors bit-equal to "
          f"its train: {tr['bit_equal']}; launches block_partials {tr['launches']['partials']}, "
          f"combine {tr['launches']['combine']}, held to the plain versions (max |err| "
          f"{tr['held']['max_abs_err']:.3g})", flush=True)
    print(f"[backends] {smi} | (a) deploy --log-url: ready in {sv['deploy_ready_s']:.2f} s; "
          f"{N_QUERIES} queries from {N_CLIENTS} clients: p50 {sv['p50_ms']:.3f} ms, p99 "
          f"{sv['p99_ms']:.3f} ms, {sv['qps']:.1f} qps, scored top-k launches {sv['served']} "
          f"in {sv['batches']} batches (select {sv['select']}, profiler {sv['profiled']}), "
          f"every answer the CPU plain top-k's; part after the children "
          f"{out['phase_s']:.1f} s", flush=True)
    return out


def _backends_postgres(report, shared, collector):
    """(b) Every repository on one postgres source whose client is
    `_PGClient(conn=...)` over the sqlite-backed fake driver of
    tests/fake_pg.py (the host has no postgres server): the named driver
    error of a plain source first; `app new`, phase 12's 100,000 events
    (read from the loop's sqlite file, ids and times as stored) through
    `insert_batch`, a train here (its read through keyset pages),
    `status` listing its engine manifest, and a query server here with
    `--log-url`'s config answering 500 queries."""
    import sqlite3

    from predictionio_tpu_torch.data.storage import postgres as pgmod

    tests_dir = str(Path(__file__).resolve().parent / "tests")
    if tests_dir not in sys.path:
        sys.path.insert(0, tests_dir)
    import fake_pg

    smi = report["nvidia_smi"]
    t0 = time.perf_counter()
    out: dict = {"sqlite_version": sqlite3.sqlite_version}
    check(sqlite3.sqlite_version_info >= (3, 35),
          f"the fake driver needs sqlite >= 3.35 (RETURNING, ON CONFLICT); this host has "
          f"{sqlite3.sqlite_version}")
    with socket.socket() as sock:  # a local port with no server behind it
        sock.bind(("127.0.0.1", 0))
        free = sock.getsockname()[1]
    try:
        Storage(_postgres_config(free)).get_meta_data_apps()
        raise PhaseError("a plain postgres source with no server connected")
    except StorageError as e:
        out["plain_source"] = str(e)
    check("psycopg2 or pg8000" in out["plain_source"] or "cannot connect" in out["plain_source"],
          f"a plain postgres source failed with {out['plain_source']!r}")
    which = ("named driver error" if "psycopg2 or pg8000" in out["plain_source"]
             else "connect error")
    storage = Storage(_postgres_config(free))
    client = storage._clients["PGSQL"] = pgmod._PGClient(conn=fake_pg.connect())
    pages = []
    query_of = client.query

    def counted(sql, params=()):
        if "ORDER BY eventTime ASC, id ASC LIMIT" in sql:
            pages.append(len(sql))
        return query_of(sql, params)

    client.query = counted
    app, _ = console.common.create_app(storage, INGEST_APP)
    t1 = time.perf_counter()
    loop = Storage(StorageConfig.from_env(_store_env(LOOP_DIR / "store")))
    loop_app = loop.get_meta_data_apps().get_by_name(INGEST_APP)
    events = list(loop.get_events().find(EventQuery(app_id=loop_app.id)))
    check(len(events) == INGEST_EDGES, f"{len(events)} events read from the loop's store")
    del loop
    out["decode_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    storage.get_events().insert_batch(events, app.id)
    out["insert_s"] = time.perf_counter() - t1
    check(storage.get_events().latest_revision(app.id) == INGEST_EDGES,
          "the postgres store's revision after the insert")
    del events
    variant = json.loads(_variant(POSTGRES_ENGINE,
                                  BACKENDS_DIR / "engine_postgres.json").read_text())
    frames: list = []
    frame_of = RecommendationDataSource._frame

    def kept_frame(self, ctx):
        frames.append(frame_of(self, ctx))
        return frames[-1]

    RecommendationDataSource._frame = kept_frame
    wf.BLOCK_LAUNCHES.update(partials=0, combine=0)  # every count to 0 just before
    df.PASS_LAUNCHES.update(row=0, col=0)
    pages.clear()
    try:
        with _Spy(als, "stage_windowed") as stage:
            inst = wcore.run_train(storage, variant)
    finally:
        RecommendationDataSource._frame = frame_of
    launches = {**wf.BLOCK_LAUNCHES, **df.PASS_LAUNCHES}
    out["pages"] = len(pages)
    check(inst.status == "COMPLETED", f"the train over postgres: {inst.status}")
    check(out["pages"] == INGEST_EDGES // pgmod.PostgresEventStore.FIND_PAGE + 1,
          f"the train's read took {out['pages']} keyset pages")
    [model] = deserialize_models(storage.get_model_data_models().get(inst.id).models)
    check(type(model) is ALSModel, f"the postgres MODELDATA holds {type(model).__name__}")
    out["stages"] = stage_timings(inst)
    out["train"] = _backend_train_checks("postgres", launches, stage, frames[0], model,
                                         shared, BACKENDS_SEED + 2)
    del frames, stage
    # `console status` over the same source lists the registered manifest
    make_storage = console.Storage
    console.Storage = lambda: storage
    try:
        rc, text = _console_out(["status"])
    finally:
        console.Storage = make_storage
    line = re.search(rf"^\[INFO\]   {POSTGRES_ENGINE} v0: "
                     r"predictionio_tpu_torch\.engines\.recommendation\.RecommendationEngine",
                     text, re.M)
    check(rc == 0 and "OK PostgresEventStore" in text and line is not None,
          "status over postgres lists no engine manifest of the train")
    out["manifest_line"] = line.group(0)
    out["serve"] = _backends_serve(storage, inst, model, collector)
    out["phase_s"] = time.perf_counter() - t0
    st, sv, tr = out["stages"], out["serve"], out["train"]
    print(f"[backends] {smi} | (b) postgres: a plain source fails with the {which} "
          f"({out['plain_source']}); over tests/fake_pg.py on sqlite {out['sqlite_version']}: "
          f"{INGEST_EDGES} events read from the loop's store in {out['decode_s']:.2f} s, "
          f"insert_batch "
          f"{out['insert_s']:.2f} s; train read {st['read']:.3f} s in {out['pages']} keyset "
          f"pages of {pgmod.PostgresEventStore.FIND_PAGE}, train {st['train']:.3f} s; the "
          f"frame equals phase 12's sqlite frame column for column: {tr['same_frame']}; "
          f"factors bit-equal to its train: {tr['bit_equal']}; launches block_partials "
          f"{tr['launches']['partials']}, combine {tr['launches']['combine']}, held to the "
          f"plain versions (max |err| {tr['held']['max_abs_err']:.3g}); status: "
          f"{out['manifest_line'].strip()}", flush=True)
    print(f"[backends] {smi} | (b) query server with log_url: {N_QUERIES} queries from "
          f"{N_CLIENTS} clients: p50 {sv['p50_ms']:.3f} ms, p99 {sv['p99_ms']:.3f} ms, "
          f"{sv['qps']:.1f} qps, scored top-k launches {sv['served']} in {sv['batches']} "
          f"batches (select {sv['select']}, profiler {sv['profiled']}), every answer the "
          f"CPU plain top-k's; {sv['shipped']['records']} records shipped; part "
          f"{out['phase_s']:.1f} s", flush=True)
    return out


def _backends_serve(storage, inst, model, collector):
    """A QueryServer here on the postgres instance, shipping its log to the
    collector: 500 queries, one select a device batch by the route and by
    devprof, every answer the plain top-k on the CPU."""
    runtime = latest_completed_runtime(storage, POSTGRES_ENGINE, "0", POSTGRES_ENGINE)
    check(runtime.instance.id == inst.id, "the runtime serves another instance")
    import logging

    pkg_logger = logging.getLogger("predictionio_tpu_torch")
    level = pkg_logger.level  # the shipper lowers it to INFO; later phases get it back
    srv = QueryServer(runtime=runtime, storage=storage, config=QueryServerConfig(
        ip="127.0.0.1", port=0, log_url=collector.url))
    port = srv.start()
    try:
        served_model = srv.runtime.models[0]
        check(str(served_model.device) == "cuda:0",
              f"the postgres model serves on {served_model.device}")
        queries = _loop_queries(np.random.default_rng(BACKENDS_SEED + 3), INGEST_USERS,
                                INGEST_ITEMS, unknown=0)
        st0, prof0 = _status(port), _exec_totals("als.recommend_serving")
        l0, s0 = rec.LAUNCHES, rec.ROUTE_LAUNCHES["select"]
        answers, wall = _serve_load(port, queries)
        st1, prof1 = _status(port), _exec_totals("als.recommend_serving")
    finally:
        srv.stop()  # the shipper flushes what it holds
        pkg_logger.setLevel(level)
    batches = st1["batches"] - st0["batches"]
    served, select = rec.LAUNCHES - l0, rec.ROUTE_LAUNCHES["select"] - s0
    profiled = prof1[0] - prof0[0]
    check(batches > 0 and served == select == batches == profiled
          and st1["kernel_launches"] - st0["kernel_launches"] == batches,
          f"top-k launches {served} (select {select}, profiler {profiled}) != batches {batches}")
    cpu_model = ALSModel(model.factors, device="cpu")
    cpu_alg = ALSAlgorithm(ALSAlgorithmParams())
    for n, q in enumerate(queries):
        check(answers[n][1] == _to_jsonable(cpu_alg.predict(cpu_model, Query(**q))),
              f"query {n} ({q}) differs from the CPU plain top-k")
    return {**_latency(answers, wall, len(queries)), "batches": batches, "served": served,
            "select": select, "profiled": profiled,
            "shipped": collector.checked(len(queries), "postgres query server")}


# ---------------------------------------------------------------------------
# phase 13: online fold-in over the ingested app
# ---------------------------------------------------------------------------


def _online_traffic(rng, users, items):
    """The online phase's events as the Event Server's JSON objects, in a
    random order a second apart after every phase-12 time, and which
    users and items they touch: ONLINE_NEW_USERS new users rating
    existing items, ONLINE_OLD_USERS users rating items they had not
    rated, ONLINE_NEW_ITEMS new items rated by existing users, and
    ONLINE_SETS `$set` user events (irrelevant to the fold)."""
    rated = set((users * INGEST_ITEMS + items).tolist())
    rows = []  # (user, item, rating) or (user, None, None) for a $set
    new_users = INGEST_USERS + np.arange(ONLINE_NEW_USERS)
    for u in new_users.tolist():
        for i in rng.choice(INGEST_ITEMS, ONLINE_NEW_USER_EVENTS, replace=False).tolist():
            rows.append((u, i, int(rng.integers(1, 6))))
    old_users = rng.choice(INGEST_USERS, ONLINE_OLD_USERS, replace=False)
    for u in old_users.tolist():
        fresh = [i for i in rng.permutation(INGEST_ITEMS).tolist()
                 if u * INGEST_ITEMS + i not in rated][:ONLINE_OLD_USER_EVENTS]
        rows += [(u, i, int(rng.integers(1, 6))) for i in fresh]
    new_items = INGEST_ITEMS + np.arange(ONLINE_NEW_ITEMS)
    for i in new_items.tolist():
        for u in rng.choice(INGEST_USERS, ONLINE_NEW_ITEM_EVENTS, replace=False).tolist():
            rows.append((u, i, int(rng.integers(1, 6))))
    rows += [(int(u), None, None) for u in rng.integers(0, INGEST_USERS, ONLINE_SETS)]
    order = rng.permutation(len(rows))
    t0 = INGEST_T0_MS + 1000 * (INGEST_EDGES + 10_000)
    events = []
    for n, j in enumerate(order.tolist()):
        u, i, r = rows[j]
        if i is None:
            ev = {"event": "$set", "entityType": "user", "entityId": f"u{u}",
                  "properties": {"plan": "pro"}}
        else:
            ev = {"event": "rate", "entityType": "user", "entityId": f"u{u}",
                  "targetEntityType": "item", "targetEntityId": f"i{i}",
                  "properties": {"rating": r}}
        events.append({**ev, "eventTime": _ms_iso(t0 + 1000 * n)})
    return events, new_users, old_users, new_items


class _OnlineSpies:
    """While the block runs: every `als.fold_in_rows` call recorded (its
    inputs, output, host wall ms, and the CUDA-event ms of its solve
    `als._fold_in` alone), every `als.serving_publish_rows` call recorded
    (its rows, input and output states, host ms to a synchronize), and
    `als.stage_serving` calls counted."""

    def __init__(self):
        self.folds, self.publishes, self.stagings = [], [], 0
        self.fold_of, self.publish_of = als.fold_in_rows, als.serving_publish_rows
        self.stage_of, self.solve_of = als.stage_serving, als._fold_in
        self.solve_events: list = []

    def solve(self, *args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.solve_of(*args, **kw)
        end.record()
        self.solve_events.append((start, end))
        return out

    def fold(self, fixed, edges, params, device=None):
        fixed_in = np.array(fixed, np.float32, copy=True)
        edges_in = [list(r) for r in edges]
        self.solve_events.clear()
        t0 = time.perf_counter()
        out = self.fold_of(fixed, edges, params, device=device)  # returns on the host
        host_ms = 1e3 * (time.perf_counter() - t0)
        [(start, end)] = self.solve_events
        end.synchronize()
        self.folds.append((fixed_in, edges_in, params, out.copy(), host_ms,
                           start.elapsed_time(end)))
        return out

    def publish(self, serving, *args, **kw):
        t0 = time.perf_counter()
        out = self.publish_of(serving, *args, **kw)
        torch.cuda.synchronize()
        self.publishes.append((serving, out, args, kw, time.perf_counter() - t0))
        return out

    def stage(self, *args, **kw):
        self.stagings += 1
        return self.stage_of(*args, **kw)

    def __enter__(self):
        als.fold_in_rows, als.serving_publish_rows = self.fold, self.publish
        als.stage_serving, als._fold_in = self.stage, self.solve
        return self

    def __exit__(self, *exc):
        als.fold_in_rows, als.serving_publish_rows = self.fold_of, self.publish_of
        als.stage_serving, als._fold_in = self.stage_of, self.solve_of


class _TimedTicks:
    """The consumer's ticks: each one's seconds and the cursor it left,
    with the host time it ended."""

    def __init__(self, consumer):
        self.ticks, self.tick_of = [], consumer.tick
        consumer.tick = self

    def __call__(self):
        t0 = time.perf_counter()
        out = self.tick_of()
        t1 = time.perf_counter()
        self.ticks.append((t1 - t0, t1, dict(out), self.tick_of.__self__.cursor.get("0", 0)))
        return out


def _post_batches(port, key, events, t_out):
    """`events` as /batch/events.json POSTs of INGEST_BATCH, dealt
    round-robin to INGEST_WRITERS threads; every event must come back
    201. t_out[b] = the host time batch b was acknowledged."""
    batches = [events[b:b + INGEST_BATCH] for b in range(0, len(events), INGEST_BATCH)]
    work = [(b, f"/batch/events.json?accessKey={key}", json.dumps(body))
            for b, body in enumerate(batches)]
    out: dict = {}
    lock = threading.Lock()
    threads = [threading.Thread(target=_post_work, args=(port, work[w::INGEST_WRITERS], out, lock))
               for w in range(INGEST_WRITERS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    check(not any(t.is_alive() for t in threads), "online writers hung")
    check(len(out) == len(batches), f"{len(out)} of {len(batches)} POSTs answered")
    for b, body in enumerate(batches):
        status, res, *_ = out[b]
        check(status == 200 and [r["status"] for r in res] == [201] * len(body),
              f"online batch POST {b}: HTTP {status} {str(res)[:200]}")
    t_out.update({b: out[b][3] for b in out})
    return batches


class _QueryLoad:
    """N_CLIENTS threads, each sending POST /queries.json for a random
    known user as soon as its last answer came, until stopped; each
    latency kept."""

    def __init__(self, port, rng, n_threads=N_CLIENTS):
        self.port, self.stop_event, self.lat = port, threading.Event(), []
        self.errors: list = []
        self.lock = threading.Lock()
        seeds = rng.integers(0, 2**31, n_threads)
        self.threads = [threading.Thread(target=self._run, args=(int(s),)) for s in seeds]

    def _run(self, seed):
        rng = np.random.default_rng(seed)
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=60)
        try:
            while not self.stop_event.is_set():
                body = json.dumps({"user": f"u{int(rng.integers(INGEST_USERS))}", "num": 10})
                t0 = time.perf_counter()
                conn.request("POST", "/queries.json", body=body,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                payload = resp.read()
                with self.lock:
                    self.lat.append(time.perf_counter() - t0)
                    if resp.status != 200:
                        self.errors.append((resp.status, payload[:200]))
        finally:
            conn.close()

    def __enter__(self):
        self.t0 = time.perf_counter()
        for t in self.threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self.stop_event.set()
        for t in self.threads:
            t.join(timeout=60)
        self.wall = time.perf_counter() - self.t0
        check(not any(t.is_alive() for t in self.threads), "query load hung")


class _Sampler(threading.Thread):
    """Queries the sampled new users one after another, one every
    ONLINE_SAMPLE_PERIOD_S, until stopped: (user, consumer cursor read
    before the query, receipt time, answer non-empty) for each."""

    def __init__(self, port, consumer, users):
        super().__init__(daemon=True)
        self.port, self.consumer, self.users = port, consumer, users
        self.stop_event, self.seen, self.rounds = threading.Event(), [], 0

    def run(self):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=60)
        try:
            while not self.stop_event.is_set():
                for u in self.users:
                    time.sleep(ONLINE_SAMPLE_PERIOD_S)
                    cursor = self.consumer.cursor.get("0", 0)
                    conn.request("POST", "/queries.json",
                                 body=json.dumps({"user": f"u{u}", "num": 10}),
                                 headers={"Content-Type": "application/json"})
                    body = json.loads(conn.getresponse().read())
                    self.seen.append((u, cursor, time.perf_counter(),
                                      bool(body.get("item_scores"))))
                self.rounds += 1
        finally:
            conn.close()


def _wait_caught_up(consumer, store, app_id, ticks, what, timeout=ONLINE_WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        latest = store.latest_revision(app_id)
        if consumer.cursor.get("0", 0) == latest and not consumer.foldin.pending_items:
            return latest
        time.sleep(0.02)
    secs = [round(t[0], 3) for t in ticks.ticks]
    raise PhaseError(f"{what}: the consumer's cursor {consumer.cursor} did not reach "
                     f"revision {store.latest_revision(app_id)} with no pending item "
                     f"({len(consumer.foldin.pending_items)}) within {timeout} s; "
                     f"{len(secs)} ticks, seconds {secs[-30:]}, last "
                     f"{ticks.ticks[-1][2] if ticks.ticks else None}")


def _select_held(sv, rng, tally, label):
    """recommend_select on the staged slab against its plain version at
    B in {1, 64} and k in {10, 128}: indices and values equal."""
    int8 = sv.dtype == "int8"
    for b in (1, 64):
        rows = torch.from_numpy(rng.choice(sv.n_users, b, replace=False)).to(sv.device)
        args = (sv.users[rows].contiguous(), sv.items,
                sv.user_scale[rows].contiguous() if int8 else None,
                sv.item_scale if int8 else None, None, None)
        for k in (10, 128):
            before = rec.ROUTE_LAUNCHES["select"]
            kv, ki = rec.fused_recommend_topk(*args, k=k, n_items=sv.n_items)
            pv, pi = rec.fused_recommend_topk_plain(*args, k=k, n_items=sv.n_items)
            torch.cuda.synchronize()
            case = f"{label} B={b} k={k}"
            check(rec.ROUTE_LAUNCHES["select"] == before + 1, f"{case}: not on the select route")
            check(torch.equal(ki, pi) and torch.equal(kv, pv),
                  f"{case}: differs from the plain version")
            tally["cases"] += 1
            tally["max_abs_err"] = max(tally["max_abs_err"], float((kv - pv).abs().max()))


def _states_equal(a, b):
    return a.n_items == b.n_items and a.dtype == b.dtype and all(
        (x is None and y is None) or (x is not None and y is not None and x.dtype == y.dtype
                                      and x.shape == y.shape and torch.equal(x, y))
        for x, y in ((a.users, b.users), (a.items, b.items), (a.user_scale, b.user_scale),
                     (a.item_scale, b.item_scale), (a.item_inv_norm, b.item_inv_norm)))


def phase_online(report, shared):
    """Phase 13: the online fold-in over phase 12's app and instance: a
    QueryServer in this process on its newest COMPLETED runtime, a
    consumer attached, the Event Server again, the traffic, the checks."""
    t_phase = time.perf_counter()
    users, items, _ratings = shared["ingest"]
    rng = np.random.default_rng(ONLINE_SEED)
    events, new_users, old_users, new_items = _online_traffic(rng, users, items)
    n_relevant = sum(e["event"] == "rate" for e in events)
    with _loop_storage():
        storage = Storage()
        store = storage.get_events()
        app = storage.get_meta_data_apps().get_by_name(INGEST_APP)
        [key] = [k.key for k in storage.get_meta_data_access_keys().get_by_app_id(app.id)
                 if not k.events]
        [inst] = [i for i in storage.get_meta_data_engine_instances().get_all()
                  if i.engine_id == "ml100k-als"]
        t0 = time.perf_counter()
        runtime = latest_completed_runtime(storage, inst.engine_id, inst.engine_version,
                                           inst.engine_variant)
        runtime_s = time.perf_counter() - t0
        check(runtime.instance.id == inst.id, "the runtime serves another instance")
        base = runtime.models[0].factors
        with _Console(["eventserver", "--ip", "127.0.0.1", "--port", "0"],
                      LOOP_DIR / "eventserver_online.log") as es, _OnlineSpies() as spies:
            es_port = es.port(timeout=120)
            rec.LAUNCHES = 0  # every count to 0 just before the main path
            rec.ROUTE_LAUNCHES.update(select=0, sort=0)
            srv = QueryServer(runtime=runtime, storage=storage,
                              config=QueryServerConfig(ip="127.0.0.1", port=0))
            port = srv.start()
            try:
                consumer = OnlineConsumer(storage, ServerApplyHost(srv), app.id,
                                          OnlineConsumerConfig(tick_s=ONLINE_TICK_S,
                                                               from_latest=True))
                ticks = _TimedTicks(consumer)
                srv.attach_online(app.id, consumer=consumer)
                out = _online_run(srv, port, es_port, key, app.id, store, consumer, ticks,
                                  events, new_users, old_users, new_items, n_relevant,
                                  base, rng)
            finally:
                srv.stop()
            launches = {"topk": rec.LAUNCHES, "select": rec.ROUTE_LAUNCHES["select"]}
            stagings = spies.stagings
        check(es.proc.returncode is not None, "eventserver still running")
    check(launches["topk"] > 0 and launches["topk"] == launches["select"],
          f"online top-k launches {launches}: not all on the select route")
    check(stagings == 0, f"stage_serving ran {stagings} times during the ticks")
    model = out.pop("model")
    report["online"] = {**out, "launches": launches, "runtime_s": runtime_s,
                        "nvidia_smi": report["nvidia_smi"]}
    _online_held(report["online"], spies, base, model, rng)
    on = report["online"]
    on["phase_s"] = time.perf_counter() - t_phase
    smi = report["nvidia_smi"]
    tk, fo, pu = on["tick_s"], on["fold_ms"], on["publish_ms"]
    print(f"[online] {smi} | {on['events']} events ({n_relevant} relevant) from "
          f"{INGEST_WRITERS} writers, {on['ticks']} folding ticks of {ONLINE_TICK_S} s: tick "
          f"p50 {tk['p50']:.4f} s, p99 {tk['p99']:.4f} s, max {tk['max']:.4f} s", flush=True)
    busy = ("not measured (no device records)" if fo["device_busy_ms"] is None else
            f"{fo['device_busy_ms']:.4f} ms in {fo['device_activities']:.0f} activities")
    print(f"[online] {smi} | fold_in_rows: {fo['calls']} calls, host wall (packing, copies, "
          f"solve, fetch) p50 {fo['host_p50']:.3f} ms, max {fo['host_max']:.3f} ms; its solve "
          f"_fold_in (CUDA events, first launch to last kernel's end) p50 "
          f"{fo['solve_p50']:.3f} ms, max {fo['solve_max']:.3f} ms; the largest fold "
          f"({fo['device_rows']} rows, {fo['device_edges']} edges) busies the card {busy} "
          f"(torch.profiler, kernels and copies); publish a tick p50 {pu['p50']:.3f} ms, "
          f"max {pu['max']:.3f} ms; CPU re-run max |card - cpu| {on['fold_max_abs_err']:.3g}",
          flush=True)
    print(f"[online] {smi} | event to served: last POST acknowledged to cursor at the "
          f"latest revision {on['caught_up_s']:.3f} s; {ONLINE_SAMPLED} sampled new users, "
          f"POST acknowledged to their own answer p50 {on['user_served_s']['p50']:.3f} s, "
          f"max {on['user_served_s']['max']:.3f} s", flush=True)
    print(f"[online] {smi} | queries while folding ({N_CLIENTS} clients back to back): p50 {on['folding']['p50_ms']:.3f} ms, p99 "
          f"{on['folding']['p99_ms']:.3f} ms, {on['folding']['qps']:.1f} qps; after: p50 "
          f"{on['after']['p50_ms']:.3f} ms, p99 {on['after']['p99_ms']:.3f} ms, "
          f"{on['after']['qps']:.1f} qps; top-k launches {launches['topk']} (select "
          f"{launches['select']}); phase {on['phase_s']:.1f} s", flush=True)


def _pctl(xs, q):
    s = sorted(xs)
    return s[min(len(s) - 1, int(q * len(s)))]


def _online_run(srv, port, es_port, key, app_id, store, consumer, ticks, events,
                new_users, old_users, new_items, n_relevant, base, rng):
    """The traffic under a query load, the catch-up, the pause, the 500
    queries and the restart; returns the phase's figures and the model
    served at the end."""
    sampled = rng.choice(new_users, ONLINE_SAMPLED, replace=False).tolist()
    start_rev = consumer.cursor.get("0", 0)
    acks: dict = {}
    sampler = _Sampler(port, consumer, sampled)
    sampler.start()
    with _QueryLoad(port, rng) as load:
        batches = _post_batches(es_port, key, events, acks)
        t_last_ack = max(acks.values())
        latest = _wait_caught_up(consumer, store, app_id, ticks, "the traffic")
    rounds = sampler.rounds  # two more rounds: each user read after the catch-up
    deadline = time.monotonic() + 30
    while sampler.rounds < rounds + 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    sampler.stop_event.set()
    sampler.join(timeout=60)
    check(not sampler.is_alive(), "sampler hung")
    check(not load.errors, f"queries failed while folding: {load.errors[:3]}")
    check(latest - start_rev == len(events), f"{latest - start_rev} revisions for "
          f"{len(events)} events")
    c = consumer.counters
    check(c["events_consumed"] == len(events), f"events_consumed {c['events_consumed']} != "
          f"{len(events)} POSTed")
    check(c["events_folded"] == n_relevant, f"events_folded {c['events_folded']} != "
          f"{n_relevant} relevant")
    n_users_touched = ONLINE_NEW_USERS + ONLINE_OLD_USERS
    check(c["users_folded"] >= n_users_touched and c["items_folded"] >= ONLINE_NEW_ITEMS,
          f"users_folded {c['users_folded']} / items_folded {c['items_folded']} below "
          f"{n_users_touched} / {ONLINE_NEW_ITEMS}")
    model = srv.runtime.models[0]
    f = model.factors
    check(f.user_factors.shape == (INGEST_USERS + ONLINE_NEW_USERS, RANK)
          and f.item_factors.shape == (INGEST_ITEMS + ONLINE_NEW_ITEMS, RANK),
          f"folded factor shapes {f.user_factors.shape} {f.item_factors.shape}")
    check(_finite(f), "non-finite folded factors")
    urow = [f.user_vocab(f"u{u}") for u in new_users.tolist()]
    irow = [f.item_vocab(f"i{i}") for i in new_items.tolist()]
    check(bool(np.abs(f.user_factors[urow]).sum(axis=1).all())
          and bool(np.abs(f.item_factors[irow]).sum(axis=1).all()),
          "a new user or item kept a zero factor row")
    orow = [f.user_vocab(f"u{u}") for u in old_users.tolist()]
    check(bool((f.user_factors[orow] != base.user_factors[orow]).any(axis=1).all()),
          "an existing user's new ratings left its factor row as trained")
    # per sampled user: its last batch's ack to its first answer read
    # after the cursor passed its last event
    last_rev = {u: max(e.revision for e in store.find(EventQuery(
        app_id=app_id, entity_id=f"u{u}"))) for u in sampled}
    served_s = []
    for u in sampled:
        t_ack = max(acks[b] for b, body in enumerate(batches)
                    if any(e["entityId"] == f"u{u}" for e in body))
        hits = [t for v, cur, t, ok in sampler.seen if v == u and ok and cur >= last_rev[u]]
        check(hits, f"sampled new user u{u} was never served its fold")
        served_s.append(min(hits) - t_ack)
    caught = [t for _s, t, _o, cur in ticks.ticks if cur >= latest]
    fold_ticks = [s for s, _t, o, _c in ticks.ticks if o.get("stats")]
    figures = {
        "events": len(events), "relevant": n_relevant, "counters": dict(c),
        "ticks": len(fold_ticks),
        "tick_s": {"p50": _pctl(fold_ticks, 0.5), "p99": _pctl(fold_ticks, 0.99),
                   "max": max(fold_ticks)},
        "caught_up_s": min(caught) - t_last_ack,
        "user_served_s": {"p50": _pctl(served_s, 0.5), "max": max(served_s),
                          "sampler_rounds": len(sampler.seen) / len(sampled)},
        "folding": {"queries": len(load.lat), "p50_ms": 1e3 * _pctl(load.lat, 0.5),
                    "p99_ms": 1e3 * _pctl(load.lat, 0.99), "qps": len(load.lat) / load.wall},
    }

    # pause: POSTed events stay unfolded until the resume
    status, st = _call(port, "POST", "/online/pause", {"reason": "chip smoke"})
    check(status == 200 and st["paused"] == "chip smoke", f"/online/pause: {status} {st}")
    held = _online_paused_events(rng)
    before = (dict(consumer.counters), dict(consumer.cursor))
    _post_batches(es_port, key, held, {})
    time.sleep(5 * ONLINE_TICK_S)
    check((dict(consumer.counters), dict(consumer.cursor)) == before,
          "events were folded while paused")
    status, st = _call(port, "POST", "/online/resume", {})
    check(status == 200 and st["paused"] is None, f"/online/resume: {status} {st}")
    _wait_caught_up(consumer, store, app_id, ticks, "the resume")
    check(consumer.counters["events_consumed"] == before[0]["events_consumed"] + ONLINE_PAUSED
          and consumer.counters["events_folded"] == before[0]["events_folded"] + ONLINE_PAUSED,
          f"after the resume: {consumer.counters} (before {before[0]})")
    model = srv.runtime.models[0]

    # 500 queries, the new users among them
    queries = ([{"user": f"u{u}", "num": 10} for u in new_users.tolist()]
               + [{"user": f"u{int(u)}", "num": int(rng.choice([5, 10, 20, 50]))}
                  for u in rng.integers(0, INGEST_USERS, N_QUERIES - ONLINE_NEW_USERS)])
    queries = [queries[n] for n in rng.permutation(len(queries)).tolist()]
    st0 = _status(port)
    out: dict = {}
    lock = threading.Lock()
    work = list(enumerate(queries))
    threads = [threading.Thread(target=_client, args=(port, work[c::N_CLIENTS], out, lock))
               for c in range(N_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "clients hung")
    st1 = _status(port)
    check(srv.runtime.models[0] is model, "the model changed during the 500 queries")
    batches_n = st1["batches"] - st0["batches"]
    served = st1["kernel_launches"] - st0["kernel_launches"]
    select = st1["select_launches"] - st0["select_launches"]
    check(batches_n > 0 and served == select == batches_n,
          f"top-k launches {served} (select {select}) != batches {batches_n}")
    new_ids = {f"u{u}" for u in new_users.tolist()}
    for n, q in enumerate(queries):
        status, body, _ = out[n]
        check(status == 200, f"query {n}: HTTP {status} {body}")
        check(q["user"] not in new_ids or body["item_scores"],
              f"new user {q['user']} got an empty answer")
    lat = [out[n][2] for n in range(len(queries))]
    figures["after"] = {"p50_ms": 1e3 * _pctl(lat, 0.5), "p99_ms": 1e3 * _pctl(lat, 0.99),
                        "qps": len(queries) / wall, "batches": batches_n,
                        "launches": served}
    figures["answers"] = [(q, out[n][1]) for n, q in enumerate(queries)]

    # a fresh consumer resumes at the persisted cursor
    counters, cursor = dict(consumer.counters), dict(consumer.cursor)
    srv.online.stop()
    fresh = srv.attach_online(app_id, OnlineConsumerConfig(tick_s=60, from_latest=True))
    fresh.stop()
    check(fresh is not consumer and fresh.cursor == cursor,
          f"a fresh consumer starts at {fresh.cursor}, not {cursor}")
    check(fresh.tick() == {"idle": "no new events"} and fresh.counters == counters,
          f"the fresh consumer's first tick was not idle: {fresh.counters}")
    return {**figures, "model": model}


def _fold_device_ms(spies):
    """The largest recorded fold re-run on the card under torch.profiler:
    the card's busy ms a call (kernels and copies summed) and the device
    activities a call; None when no session saw device records."""
    from torch.profiler import ProfilerActivity, profile

    fixed, edges, params, *_ = max(spies.folds, key=lambda f: sum(map(len, f[1])))
    fx = torch.from_numpy(fixed).cuda()
    spies.fold_of(fx, edges, params, device="cuda")
    torch.cuda.synchronize()
    calls, busy, acts = 5, None, None
    for _session in range(3):  # a late session may lose its device records
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                spies.fold_of(fx, edges, params, device="cuda")
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_time_total]
        if events:
            busy = sum(e.device_time_total for e in events) / calls / 1e3
            acts = sum(e.count for e in events) / calls
            break
    return {"device_rows": len(edges), "device_edges": sum(map(len, edges)),
            "device_busy_ms": busy, "device_activities": acts}


def _online_paused_events(rng):
    """ONLINE_PAUSED new ratings by existing users (after every earlier
    time), for the pause check."""
    t0 = INGEST_T0_MS + 1000 * (INGEST_EDGES + 30_000)
    return [{"event": "rate", "entityType": "user", "entityId": f"u{int(u)}",
             "targetEntityType": "item", "targetEntityId": f"i{int(i)}",
             "properties": {"rating": int(r)}, "eventTime": _ms_iso(t0 + 1000 * n)}
            for n, (u, i, r) in enumerate(zip(rng.integers(0, INGEST_USERS, ONLINE_PAUSED),
                                              rng.integers(0, INGEST_ITEMS, ONLINE_PAUSED),
                                              rng.integers(1, 6, ONLINE_PAUSED)))]


def _online_held(on, spies, base, model, rng):
    """After the run: the 500 answers against the plain top-k on the CPU
    over the served factors, each fold re-run on the CPU, the published
    f32 slab and an int8 replay of the same publishes bit-equal to a
    restage, recommend_select held to its plain version on both."""
    cpu_model = ALSModel(model.factors, device="cpu")
    cpu_alg = ALSAlgorithm(ALSAlgorithmParams())
    for n, (q, body) in enumerate(on.pop("answers")):
        check(body == _to_jsonable(cpu_alg.predict(cpu_model, Query(**q))),
              f"query {n} ({q}) differs from the CPU plain top-k")
    err = 0.0
    for fixed, edges, params, got, *_ms in spies.folds:
        cpu = spies.fold_of(fixed, edges, params, device="cpu")
        check(np.allclose(got, cpu, rtol=1e-4, atol=1e-4),
              f"fold_in_rows on the card vs the CPU: max |diff| {np.abs(got - cpu).max()}")
        err = max(err, float(np.abs(got - cpu).max()))
    on["fold_max_abs_err"] = err
    host_ms = [f[4] for f in spies.folds]
    solve_ms = [f[5] for f in spies.folds]
    on["fold_ms"] = {"calls": len(host_ms), "host_p50": _pctl(host_ms, 0.5),
                     "host_max": max(host_ms), "solve_p50": _pctl(solve_ms, 0.5),
                     "solve_max": max(solve_ms), **_fold_device_ms(spies)}
    pub_ms = [1e3 * s for *_, s in spies.publishes]
    on["publish_ms"] = {"calls": len(pub_ms), "p50": _pctl(pub_ms, 0.5), "max": max(pub_ms)}
    # the publishes form one chain from the staged baseline to the served state
    for (_a, prev_out, *_), (nxt_in, *_) in zip(spies.publishes, spies.publishes[1:]):
        check(nxt_in is prev_out, "a publish started off a state that never served")
    check(spies.publishes[-1][1] is model._serving_state, "the served state is not the "
          "last publish's")
    sv = model._serving_state
    check(_states_equal(sv, spies.stage_of(model.factors, "f32", device=sv.device)),
          "the published f32 state differs from a restage of its factors")
    sv8 = spies.stage_of(base, "int8", device=sv.device)
    for _in, _out, args, kw, _s in spies.publishes:
        sv8 = spies.publish_of(sv8, *args, **kw)
    check(_states_equal(sv8, spies.stage_of(model.factors, "int8", device=sv.device)),
          "the int8 replay of the publishes differs from a restage")
    check(sv.items.shape[0] == rec.pad_items(INGEST_ITEMS + ONLINE_NEW_ITEMS)
          and rec.pad_items(INGEST_ITEMS) < sv.items.shape[0],
          f"the slab did not grow past its pad headroom: {sv.items.shape}")
    tally = {"cases": 0, "max_abs_err": 0.0}
    _select_held(sv, rng, tally, "online f32 slab")
    _select_held(sv8, rng, tally, "online int8 slab")
    on["held"] = tally


# ---------------------------------------------------------------------------
# phase 14: item properties, the similar-product and e-commerce templates
# ---------------------------------------------------------------------------


def _templates_data(rng, users, items, ratings):
    """The phase's events as JSON lines and its ground truth: a `$set` of
    1-3 genres for every movie, later `$unset`s and `$delete`s, like /
    dislike events on a sample of phase 9's rated pairs (>= 4 stars a
    like, <= 2 a dislike), and the first `unavailableItems` list."""
    n_movies = LOOP_ITEMS + LIFECYCLE_NEW_ITEMS
    cats = {f"i{m}": sorted(ML1M_GENRES[g] for g in rng.choice(
        len(ML1M_GENRES), int(rng.integers(1, 4)), replace=False)) for m in range(n_movies)}
    gone = rng.choice(n_movies, TEMPLATES_UNSET + TEMPLATES_DELETE, replace=False)
    unset, deleted = gone[:TEMPLATES_UNSET], gone[TEMPLATES_UNSET:]
    pick = rng.choice(len(users), TEMPLATES_LIKES, replace=False)
    stars = ratings[pick]
    keep = stars != 3
    likes = [("like" if s >= 4 else "dislike", f"u{u}", f"i{i}")
             for u, i, s in zip(users[pick][keep], items[pick][keep], stars[keep])]
    lists = rng.choice(n_movies, 2 * TEMPLATES_UNAVAILABLE, replace=False)
    first = [f"i{m}" for m in lists[:TEMPLATES_UNAVAILABLE]]
    second = [f"i{m}" for m in lists[TEMPLATES_UNAVAILABLE:]]
    lines, t = [], TEMPLATES_T0_MS

    def add(ev, etype, eid, props, target=None):
        nonlocal t
        d = {"event": ev, "entityType": etype, "entityId": eid, "properties": props,
             "eventTime": _ms_iso(t)}
        if target is not None:
            d.update(targetEntityType="item", targetEntityId=target)
        lines.append(json.dumps(d))
        t += 1000

    for m, c in cats.items():
        add("$set", "item", m, {"categories": c})
    for m in unset:
        add("$unset", "item", f"i{m}", {"categories": None})
    for m in deleted:
        add("$delete", "item", f"i{m}", {})
    for ev, u, i in likes:
        add(ev, "user", u, {}, target=i)
    add("$set", "constraint", "unavailableItems", {"items": first})
    truth = {m: frozenset(c) for m, c in cats.items()}
    for m in gone:
        truth[f"i{m}"] = frozenset()
    return lines, t, truth, likes, first, second


def _engine_json(name, body, directory=None):
    path = (LOOP_DIR if directory is None else directory) / f"engine_{name}.json"
    path.write_text(json.dumps({"id": name, **body}))
    return path


def _instance(storage, engine_id):
    """The engine's newest instance, which must be COMPLETED."""
    insts = [i for i in storage.get_meta_data_engine_instances().get_all()
             if i.engine_id == engine_id]
    inst = max(insts, key=lambda i: i.start_time)
    check(inst.status == "COMPLETED", f"{engine_id}: instance {inst.status}")
    return inst


def _serve_load(port, queries):
    """The queries from N_CLIENTS threads: {n: (status, body, seconds)} and
    the wall seconds."""
    out: dict = {}
    lock = threading.Lock()
    work = list(enumerate(queries))
    threads = [threading.Thread(target=_client, args=(port, work[c::N_CLIENTS], out, lock))
               for c in range(N_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "clients hung")
    check(len(out) == len(queries), f"{len(out)} of {len(queries)} answered")
    for n in range(len(queries)):
        check(out[n][0] == 200, f"query {n}: HTTP {out[n][0]} {out[n][1]}")
    return out, wall


def _latency(out, wall, n):
    lat = [out[k][2] for k in range(n)]
    return {"queries": n, "wall_s": wall, "qps": n / wall,
            "p50_ms": _pct(lat, 0.5), "p99_ms": _pct(lat, 0.99)}


def phase_templates(report, shared):
    """Item properties and the two templates over the loop's ML-1M app:
    the properties and likes imported, the similar-product `multi`
    variant and the e-commerce template trained by `console train` and
    served by `console deploy` on the card, then the recommendation
    template with item categories through the data view."""
    t_phase = time.perf_counter()
    users, items, ratings = shared["loop"]
    rng = np.random.default_rng(TEMPLATES_SEED)
    lines, t_end, truth, likes, first, second = _templates_data(rng, users, items, ratings)
    events_path = LOOP_DIR / "templates.jsonl"
    events_path.write_text("\n".join(lines) + "\n")
    out = report["templates"] = {"nvidia_smi": report["nvidia_smi"], "likes": len(likes)}
    with _loop_storage():
        t0 = time.perf_counter()
        check(console.main(["import", "--app", LOOP_APP, "--input", str(events_path)]) == 0,
              "import of the properties and likes")
        out["import_s"] = time.perf_counter() - t0
        storage = Storage()
        app_id = storage.get_meta_data_apps().get_by_name(LOOP_APP).id
        events = storage.get_events()
        props = events.aggregate_properties(app_id, "item")
        got = {m: frozenset(p.get_opt("categories", list) or []) for m, p in props.items()}
        check(len(props) == len(truth) - TEMPLATES_DELETE
              and all(got.get(m, frozenset()) == c for m, c in truth.items()),
              "aggregate_properties differs from the imported $set/$unset/$delete")
        out["similar"] = _similar_run(storage, rng)
        out["ecommerce"] = _ecommerce_run(storage, rng, truth, first, second, t_end)
        out["recommendation"] = _categories_run(storage, rng, truth)
    out["phase_s"] = time.perf_counter() - t_phase
    smi = report["nvidia_smi"]
    for name in ("similar", "ecommerce", "recommendation"):
        r = out[name]
        st = r["stages"]
        print(f"[templates] {smi} | {name}: read {st['read']:.2f} s, train "
              f"{st['train']:.2f} s, persist {st['persist']:.4f} s; launches "
              f"{r['launches']}", flush=True)
        if "p50_ms" in r:
            print(f"[templates] {smi} | {name}: deploy to ready {r['deploy_ready_s']:.2f} s; "
                  f"{r['queries']} queries from {N_CLIENTS} clients: p50 {r['p50_ms']:.3f} ms, "
                  f"p99 {r['p99_ms']:.3f} ms, {r['qps']:.1f} qps", flush=True)
    rr = out["recommendation"]
    print(f"[templates] {smi} | recommendation with categories and the data view: read "
          f"{rr['reads'][0]:.2f} s (miss), then {rr['reads'][1]:.2f} s (hit), "
          f"{rr['queries']} category queries on the card in {rr['serve_s']:.3f} s; "
          f"import {out['import_s']:.2f} s; phase {out['phase_s']:.1f} s", flush=True)


def _similar_queries(rng):
    """N_QUERIES baskets of 1-5 movies (20 % with blacklists, 10 % with
    whitelists), TEMPLATES_UNKNOWN_BASKETS of them of unknown ids only."""
    qs = []
    n_movies = LOOP_ITEMS + LIFECYCLE_NEW_ITEMS
    unknown = set(rng.choice(N_QUERIES, min(N_QUERIES, TEMPLATES_UNKNOWN_BASKETS),
                             replace=False).tolist())
    for n in range(N_QUERIES):
        if n in unknown:
            qs.append({"items": [f"x{n}", "nope"], "num": 10})
            continue
        q = {"items": [f"i{int(m)}" for m in rng.integers(0, n_movies, int(rng.integers(1, 6)))],
             "num": int(rng.choice([5, 10, 20, 50]))}
        r = rng.random()
        if r < 0.2:
            q["blacklist"] = [f"i{int(x)}" for x in
                              rng.integers(0, n_movies, int(rng.integers(3, 11)))]
        elif r < 0.3:
            q["whitelist"] = [f"i{int(x)}" for x in rng.integers(0, n_movies, 50)]
        qs.append(q)
    return qs


def _similar_run(storage, rng):
    """The `multi` variant (`als` on the rate events as views, `like` on
    the likes, `sum` serving): trained here, deployed in a process of
    its own, 500 baskets; each answer held to the plain selector on the
    CPU over the same factors, per algorithm and summed."""
    engine_json = _engine_json("ml1m-sim", {
        "engineFactory": "predictionio_tpu_torch.engines.similarproduct.SimilarProductEngine",
        "datasource": {"params": {"app_name": LOOP_APP, "view_event": "rate"}},
        "algorithms": [{"name": "als", "params": {}}, {"name": "like", "params": {}}],
        "serving": {"name": "sum"},
    })
    df.PASS_LAUNCHES.update(row=0, col=0)  # every count to 0 just before the main path
    wf.BLOCK_LAUNCHES.update(partials=0, combine=0)
    with _Spy(als, "stage_windowed") as stage:
        rc = console.main(["train", "--engine-json", str(engine_json)])
    launches = {**df.PASS_LAUNCHES, **wf.BLOCK_LAUNCHES}
    check(rc == 0, "similar-product train --engine-json")
    inst = _instance(storage, "ml1m-sim")
    iters = SimilarParams().num_iterations
    check(launches == {"row": iters, "col": iters, "partials": 2 * iters,
                       "combine": 2 * iters},
          f"similar-product train launches {launches}: want the dense passes once an "
          f"iteration (als) and the windowed pass twice (like)")
    staged = [o for *_, o in stage.calls]
    check(len(staged) == 1, f"{len(staged)} windowed stagings, want the like train's one")
    held = {"cases": 0, "max_abs_err": 0.0, "max_ratio": 0.0,
            "combined_max_abs_err": 0.0, "combined_max_ratio": 0.0}
    _windowed_held(staged[0], RANK, np.random.default_rng(TEMPLATES_SEED + 1), held,
                   "like plan")
    del staged, stage
    models = deserialize_models(storage.get_model_data_models().get(inst.id).models)
    check([type(m).__name__ for m in models] == ["SimilarModel", "SimilarModel"],
          f"MODELDATA holds {[type(m).__name__ for m in models]}")
    for m in models:
        check(_finite(m.factors), "non-finite factors")
        check(m.factors.item_factors.shape == (LOOP_ITEMS + LIFECYCLE_NEW_ITEMS, RANK),
              f"item factors {m.factors.item_factors.shape}")

    queries = _similar_queries(rng)
    t0 = time.perf_counter()
    with _Console(["deploy", "--engine-json", str(engine_json), "--ip", "127.0.0.1",
                   "--port", "0"], LOOP_DIR / "deploy_sim.log") as dep:
        port = dep.port(timeout=300)
        before = _status(port)
        ready_s = time.perf_counter() - t0
        answers, wall = _serve_load(port, queries)
        after = _status(port)
    check(before["engine_instance"] == inst.id, "deploy serves another instance")
    check(after["device"] == "cuda:0", f"deploy serves on {after['device']}")
    vocab = models[0].factors.item_vocab
    known = sum(any(vocab.get(i) is not None for i in q["items"]) for q in queries)
    served = after["kernel_launches"] - before["kernel_launches"]
    select = after["select_launches"] - before["select_launches"]
    check(served == select == 2 * known,
          f"deploy top-k launches {served} (select {select}) != 2 x {known} baskets "
          f"with a known movie")

    # the plain selector on the CPU over the same item slabs
    algs = [SimilarAlgorithm(SimilarParams()), LikeAlgorithm(SimilarParams())]
    for m in models:
        m.bind_device("cpu")
        m.host_ranked = lambda: False  # the card's route, through the plain version
    max_host = 0.0
    for n, q in enumerate(queries):
        sq = SimilarQuery(**q)
        preds = [a.predict(m, sq) for a, m in zip(algs, models)]
        want = _to_jsonable(SumScoreServing().serve(sq, preds))
        check(answers[n][1] == want, f"basket {n} ({q}) differs from the plain top-k on the CPU")
        rows = [vocab.get(i) for i in q["items"] if vocab.get(i) is not None]
        if not rows:
            check(answers[n][1] == {"item_scores": []}, f"basket {n} of unknown ids answered")
            continue
        for m, p in zip(models, preds):
            normed = m.normed_item_factors()
            host = normed @ normed[rows].mean(axis=0)
            for s in p.item_scores:
                max_host = max(max_host, abs(s.score - float(host[vocab.get(s.item)])))
    check(max_host <= 1e-5, f"scores {max_host} from the host formula normed @ mean")
    return {"stages": stage_timings(inst), "launches": {**launches, "serve_topk": served,
                                                         "serve_select": select},
            "baskets_known": known, "held": held, "max_abs_from_host_formula": max_host,
            "deploy_ready_s": ready_s, "batches": after["batches"] - before["batches"],
            **_latency(answers, wall, len(queries))}


def _seen_by_user(storage):
    """user id → the item ids of their rate and view events, from one
    columnar read of the store."""
    frame = EventStoreFacade(storage).find_frame(
        LOOP_APP, entity_type="user", target_entity_type="item",
        event_names=["rate", "view"])
    inv_u, inv_i = frame.entity_vocab.inverse(), frame.target_vocab.inverse()
    order = np.argsort(frame.entity_idx, kind="stable")
    ent, tgt = frame.entity_idx[order], frame.target_idx[order]
    starts = np.flatnonzero(np.r_[True, ent[1:] != ent[:-1]])
    ends = np.r_[starts[1:], len(ent)]
    return {inv_u(int(ent[a])): {inv_i(int(x)) for x in tgt[a:b]}
            for a, b in zip(starts, ends)}


def _ecommerce_queries(rng, n, viewers):
    """`n` queries in a random order: one for each of `viewers`, one for
    each of TEMPLATES_NO_EVENT_USERS users with no events, the rest for
    users the model knows; 30 % with categories, 10 % with whitelists,
    20 % with blacklists, drawn apart."""
    n_movies = LOOP_ITEMS + LIFECYCLE_NEW_ITEMS
    qs = []
    for k in range(n):
        if k < len(viewers):
            user = viewers[k]
        elif k < len(viewers) + TEMPLATES_NO_EVENT_USERS:
            user = f"nobody{k}"
        else:
            user = f"u{int(rng.integers(LOOP_USERS + LIFECYCLE_NEW_USERS))}"
        q = {"user": user, "num": int(rng.choice([5, 10, 20, 50]))}
        if rng.random() < 0.3:
            q["categories"] = [str(g) for g in rng.choice(ML1M_GENRES, int(rng.integers(1, 3)),
                                                         replace=False)]
        if rng.random() < 0.1:
            q["whitelist"] = [f"i{int(x)}" for x in rng.integers(0, n_movies, 50)]
        if rng.random() < 0.2:
            q["blacklist"] = [f"i{int(x)}" for x in
                              rng.integers(0, n_movies, int(rng.integers(3, 11)))]
        qs.append(q)
    order = rng.permutation(n)
    return [qs[k] for k in order]


def _ecommerce_expected(q, f, normed, truth, seen, basis, unavailable):
    """The brute force: the scores of every item for the query's user
    (its factor row, or the cosine to its view basis), a full stable sort
    over the items every filter allows. (scores, ordered item rows)."""
    vocab, n_items = f.item_vocab, f.item_factors.shape[0]
    inv = vocab.inverse()
    allowed = np.ones(n_items, bool)
    if q.get("categories"):
        wanted = set(q["categories"])
        allowed &= np.array([bool(truth[inv(r)] & wanted) for r in range(n_items)])
    if "whitelist" in q:
        listed = np.zeros(n_items, bool)
        listed[[vocab.get(i) for i in q["whitelist"] if vocab.get(i) is not None]] = True
        allowed &= listed
    for it in list(q.get("blacklist", [])) + list(unavailable) + list(seen):
        if vocab.get(it) is not None:
            allowed[vocab.get(it)] = False
    row = f.user_vocab.get(q["user"])
    if row is not None:
        scores = f.item_factors @ f.user_factors[row]
    elif basis:
        rows = [vocab.get(i) for i in basis]
        scores = normed @ normed[rows].mean(axis=0)
        allowed[rows] = False
    else:
        return None, np.zeros(0, np.int64)
    cand = np.flatnonzero(allowed)
    return scores, cand[np.argsort(-scores[cand], kind="stable")][:q["num"]]


def _same_topn(body, scores, want, vocab, label, rtol=1e-6):
    """The answer's items and scores against the brute force: scores
    within `rtol` (of the largest), items equal outside groups of scores
    within it and as sets inside them."""
    got = [(s["item"], s["score"]) for s in body["item_scores"]]
    check(len(got) == len(want), f"{label}: {len(got)} items, want {len(want)}")
    if not got:
        return
    tol = rtol * max(1e-30, float(np.abs(scores[want]).max()))
    ws = scores[want]
    gs = np.array([s for _, s in got])
    check(np.all(np.abs(gs - ws) <= tol), f"{label}: scores off by "
          f"{float(np.abs(gs - ws).max())}")
    for (item, s) in got:
        check(abs(float(scores[vocab.get(item)]) - s) <= tol,
              f"{label}: {item} scored {s}, brute force {scores[vocab.get(item)]}")
    inv = vocab.inverse()
    cut = float(ws[-1])
    g_set = {i for i, s in got if s > cut + tol}
    w_set = {inv(int(r)) for r, s in zip(want, ws) if s > cut + tol}
    check(g_set == w_set, f"{label}: items above the cut differ")
    for n in range(1, len(got)):
        check(gs[n] <= gs[n - 1] + tol, f"{label}: not sorted")


def _ecommerce_run(storage, rng, truth, first, second, t_end):
    """The e-commerce template: trained here, then view events of users
    the model does not know, a deploy in a process of its own, 500
    queries, a second unavailable list and 50 more; each answer held to
    the brute force over the persisted factors and the store's events."""
    engine_json = _engine_json("ml1m-ec", {
        "engineFactory": "predictionio_tpu_torch.engines.ecommerce.ECommerceEngine",
        "datasource": {"params": {"app_name": LOOP_APP}},
        "algorithms": [{"name": "ecomm", "params": {
            "app_name": LOOP_APP, "unseen_only": True, "seen_events": ["rate", "view"]}}],
    })
    df.PASS_LAUNCHES.update(row=0, col=0)
    wf.BLOCK_LAUNCHES.update(partials=0, combine=0)
    rc = console.main(["train", "--engine-json", str(engine_json)])
    launches = {**df.PASS_LAUNCHES, **wf.BLOCK_LAUNCHES}
    check(rc == 0, "e-commerce train --engine-json")
    inst = _instance(storage, "ml1m-ec")
    iters = ECommParams(app_name=LOOP_APP).num_iterations
    check(launches == {"row": iters, "col": iters, "partials": 0, "combine": 0},
          f"e-commerce train launches {launches}: want the dense passes once an iteration")
    [model] = deserialize_models(storage.get_model_data_models().get(inst.id).models)
    check(type(model).__name__ == "ECommModel", f"MODELDATA holds {type(model).__name__}")
    f = model.factors
    check(_finite(f), "non-finite factors")
    inv = f.item_vocab.inverse()
    check(all(model.item_categories[r] == truth[inv(r)] for r in range(len(f.item_vocab))),
          "the model's item categories differ from the imported properties")

    # users the model does not know, with views in the store
    viewers = [f"v{n}" for n in range(TEMPLATES_NEW_VIEWERS)]
    n_movies = LOOP_ITEMS + LIFECYCLE_NEW_ITEMS
    views, lines, t = {}, [], t_end
    for v in viewers:
        views[v] = [f"i{int(m)}" for m in rng.choice(n_movies, TEMPLATES_NEW_VIEWS,
                                                      replace=False)]
        for it in views[v]:
            lines.append(json.dumps({"event": "view", "entityType": "user", "entityId": v,
                                     "targetEntityType": "item", "targetEntityId": it,
                                     "eventTime": _ms_iso(t)}))
            t += 1000
    views_path = LOOP_DIR / "templates_views.jsonl"
    views_path.write_text("\n".join(lines) + "\n")
    check(console.main(["import", "--app", LOOP_APP, "--input", str(views_path)]) == 0,
          "import of the new users' views")
    seen = _seen_by_user(storage)
    check(all(seen[v] == set(views[v]) for v in viewers), "the new users' views read back")

    queries = _ecommerce_queries(rng, N_QUERIES, viewers)
    later = _ecommerce_queries(rng, TEMPLATES_AFTER_QUERIES, [])
    app_id = storage.get_meta_data_apps().get_by_name(LOOP_APP).id
    t0 = time.perf_counter()
    with _Console(["deploy", "--engine-json", str(engine_json), "--ip", "127.0.0.1",
                   "--port", "0"], LOOP_DIR / "deploy_ec.log") as dep:
        port = dep.port(timeout=300)
        before = _status(port)
        ready_s = time.perf_counter() - t0
        answers, wall = _serve_load(port, queries)
        mid = _status(port)
        storage.get_events().insert(Event(
            event="$set", entity_type="constraint", entity_id="unavailableItems",
            properties={"items": second},
            event_time=datetime.datetime.fromtimestamp(t / 1000, datetime.timezone.utc)),
            app_id)
        after_answers, _ = _serve_load(port, later)
        after = _status(port)
    check(before["engine_instance"] == inst.id, "deploy serves another instance")
    check(after["device"] == "cuda:0", f"deploy serves on {after['device']}")
    check(after["kernel_launches"] == before["kernel_launches"],
          "an e-commerce query launched a top-k kernel (its ranking is the host's)")

    normed = f.item_factors / (np.linalg.norm(f.item_factors, axis=-1, keepdims=True) + 1e-9)
    filtered = {"categories": 0, "seen": 0, "basis": 0, "empty": 0}
    for batch, unavailable, qs in ((answers, first, queries), (after_answers, second, later)):
        for n, q in enumerate(qs):
            body = batch[n][1]
            user_seen = seen.get(q["user"], set())
            basis = views.get(q["user"], [])
            scores, want = _ecommerce_expected(q, f, normed, truth, user_seen, basis,
                                               unavailable)
            label = f"e-commerce query {n} ({q['user']})"
            if scores is None:
                check(body == {"item_scores": []}, f"{label}: answered with no events")
                filtered["empty"] += 1
                continue
            _same_topn(body, scores, want, f.item_vocab, label)
            items = {s["item"] for s in body["item_scores"]}
            check(not items & (set(unavailable) | set(q.get("blacklist", [])) | user_seen
                               | set(basis)), f"{label}: a filtered item answered")
            if q.get("categories"):
                check(all(truth[i] & set(q["categories"]) for i in items),
                      f"{label}: an item without a wanted category")
                filtered["categories"] += 1
            filtered["seen"] += bool(user_seen)
            filtered["basis"] += bool(basis) and f.user_vocab.get(q["user"]) is None
    check(filtered["basis"] == TEMPLATES_NEW_VIEWERS
          and filtered["empty"] == 2 * TEMPLATES_NO_EVENT_USERS,
          f"query kinds served: {filtered}")
    return {"stages": stage_timings(inst), "launches": {**launches, "serve_topk": 0},
            "filtered": filtered, "deploy_ready_s": ready_s,
            "batches": mid["batches"] - before["batches"],
            "batch_predict_ms": 1e3 * (mid["batch_predict_seconds"]
                                       - before["batch_predict_seconds"])
            / max(1, mid["batches"] - before["batches"]),
            **_latency(answers, wall, len(queries))}


def _categories_run(storage, rng, truth):
    """The recommendation template with item categories through the data
    view: `console train` twice (the second read a DataView hit, the
    factors bit-equal), then category queries through the deployed
    runtime on the card, each equal to the plain top-k on the CPU."""
    engine_json = _engine_json("ml1m-cat", {
        "engineFactory": "predictionio_tpu_torch.engines.recommendation.RecommendationEngine",
        "datasource": {"params": {"app_name": LOOP_APP, "event_names": ["rate"],
                                  "read_item_categories": True, "use_data_view": True}},
        "algorithms": [{"name": "als", "params": {}}],
    })
    df.PASS_LAUNCHES.update(row=0, col=0)
    wf.BLOCK_LAUNCHES.update(partials=0, combine=0)
    DataView.stats.update(hits=0, misses=0)
    insts, stats = [], []
    for _ in range(2):
        check(console.main(["train", "--engine-json", str(engine_json)]) == 0,
              "recommendation train --engine-json")
        insts.append(_instance(storage, "ml1m-cat"))
        stats.append(dict(DataView.stats))
    launches = {**df.PASS_LAUNCHES, **wf.BLOCK_LAUNCHES}
    check(stats == [{"hits": 0, "misses": 1}, {"hits": 1, "misses": 1}],
          f"DataView {stats}: the second read must be a hit")
    iters = ALSAlgorithmParams().num_iterations
    check(launches == {"row": 2 * iters, "col": 2 * iters, "partials": 0, "combine": 0},
          f"recommendation trains' launches {launches}")
    a, b = (_blob_factors(storage, i.id) for i in insts)
    check(_bit_equal(a.factors, b.factors),
          "the train from the cached frame differs from the first")
    inv = a.factors.item_vocab.inverse()
    check(all(a.item_categories[r] == truth[inv(r)] for r in range(len(a.factors.item_vocab))),
          "the model's item categories differ from the imported properties")
    runtime = latest_completed_runtime(storage, "ml1m-cat", "0", "ml1m-cat")
    alg, model = runtime.algorithms[0], runtime.models[0]
    check(str(model.device) == "cuda:0", f"the runtime serves on {model.device}")
    queries = []
    for _ in range(TEMPLATES_CATEGORY_QUERIES):
        q = {"user": f"u{int(rng.integers(LOOP_USERS))}", "num": int(rng.choice([5, 10, 50])),
             "categories": [str(g) for g in rng.choice(ML1M_GENRES, int(rng.integers(1, 3)),
                                                       replace=False)]}
        queries.append(q)
    launches0, select0 = rec.LAUNCHES, rec.ROUTE_LAUNCHES["select"]
    t0 = time.perf_counter()
    served = [_to_jsonable(alg.predict(model, Query(**q))) for q in queries]
    serve_s = time.perf_counter() - t0
    topk = rec.LAUNCHES - launches0
    select = rec.ROUTE_LAUNCHES["select"] - select0
    check(topk == select == len(queries), f"category queries launched {topk} (select "
          f"{select}), want one each")
    b.bind_device("cpu")
    cpu_alg = ALSAlgorithm(ALSAlgorithmParams())
    for n, q in enumerate(queries):
        check(served[n] == _to_jsonable(cpu_alg.predict(b, Query(**q))),
              f"category query {n} ({q}) differs from the CPU plain top-k")
        check(all(truth[s["item"]] & set(q["categories"]) for s in served[n]["item_scores"]),
              f"category query {n}: an item without a wanted category")
    return {"stages": stage_timings(insts[1]),
            "reads": [stage_timings(i)["read"] for i in insts],
            "data_view": stats[-1], "launches": {**launches, "serve_topk": topk},
            "queries": len(queries), "serve_s": serve_s}


# ---------------------------------------------------------------------------
# phase 15: ML-25M-width ratings, the windowed path's configuration
# ---------------------------------------------------------------------------


def _plan_side(dst, src, vals, n_dst):
    """The per-slot arrays of one side's windowed plan, as staging lays
    them out: (src, vals, ok, local) as (n_blocks_p, B_E), block_window."""
    order = np.argsort(dst, kind="stable")
    plan = win.plan_windows(dst[order], n_dst)

    def flat(a):
        return a.reshape(plan.n_blocks_p, -1)

    return plan, (flat(plan.take(src[order])), flat(plan.take(vals[order])),
                  flat(plan.chunked_valid()), flat(plan.chunked_local()),
                  plan.block_window)


def phase_data25(report, shared):
    """MovieLens-25M's shape from SEED25: N25_EDGES unique (user, item)
    pairs with its skewed degrees, half-star ratings 0.5-5.0 drawn
    uniformly, as in phase 4.

    Anchors: 162,541 users, 59,047 rated movies and 25,000,095 ratings,
    every user with at least 20 (GroupLens ML-25M README); the most
    active user's 32,202 ratings and the most-rated movie's 81,491
    (Forrest Gump) are counts of ``ratings.csv`` as commonly reported,
    not figures of the README. Its dense int8 R (163,840 x 59,136 =
    9,688,842,240 bytes) is over the dense budget, so the gate sends it
    to the windowed path."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED25)
    d_user = rng.permutation(_degree_targets(N25_USERS, N25_EDGES, *USER25_DEGREES))
    d_item = rng.permutation(_degree_targets(N25_ITEMS, N25_EDGES, *ITEM25_DEGREES))
    keys, rounds = _pairs_with_degrees(rng, d_user, d_item)
    check(len(keys) == N25_EDGES, f"{len(keys)} unique pairs drawn, not {N25_EDGES}")
    rows = (keys // N25_ITEMS).astype(np.int32)
    cols = (keys % N25_ITEMS).astype(np.int32)
    del keys
    vals = (rng.integers(1, 11, N25_EDGES) / 2.0).astype(np.float32)
    u_deg = np.bincount(rows, minlength=N25_USERS)
    i_deg = np.bincount(cols, minlength=N25_ITEMS)
    check(np.array_equal(u_deg, d_user) and np.array_equal(i_deg, d_item),
          "degrees differ from their targets")
    gen_s = time.perf_counter() - t0
    # the gate: every condition before the byte budget holds, the budget
    # does not, so dense_eligible is False because of the budget
    params = als.ALSParams(rank=RANK)
    nbytes = als.dense_matrix_bytes(N25_USERS, N25_ITEMS, "int8")
    check(nbytes > als.DENSE_DEFAULT_BYTES,
          f"dense int8 R of {nbytes} bytes is not over the budget")
    check(len(rows) >= als.DENSE_AUTO_MIN_EDGES and RANK <= als.GRAM_SOLVER_MAX_RANK
          and dense.int8_scale(vals) == 2.0, "a gate condition before the budget fails")
    t0 = time.perf_counter()
    eligible = als.dense_eligible(rows, cols, vals, N25_USERS, N25_ITEMS, params)
    gate_s = time.perf_counter() - t0
    check(not eligible, "the dense gate accepted ML-25M's width")
    t0 = time.perf_counter()
    plans = {"users": _plan_side(rows, cols, vals, N25_USERS),
             "items": _plan_side(cols, rows, vals, N25_ITEMS)}
    plan_s = time.perf_counter() - t0
    shared["coo25"] = (rows, cols, vals)
    shared["plans25"] = plans
    report["data25"] = {
        "users": N25_USERS, "items": N25_ITEMS, "edges": N25_EDGES,
        "user_degree": {"min": int(u_deg.min()), "median": float(np.median(u_deg)),
                        "max": int(u_deg.max())},
        "item_degree": {"min": int(i_deg.min()), "median": float(np.median(i_deg)),
                        "max": int(i_deg.max())},
        "dense_int8_bytes": nbytes, "gate_s": gate_s,
        "plans": {side: {"n_blocks": p.n_blocks, "n_blocks_p": p.n_blocks_p,
                         "n_windows": p.n_windows, "slots": p.n_blocks_p * win.BLOCK_EDGES}
                  for side, (p, _) in plans.items()},
        "swap_rounds": rounds, "generate_s": gen_s, "plan_s": plan_s,
    }
    d = report["data25"]
    pu, pi = d["plans"]["users"], d["plans"]["items"]
    print(f"[data25] {N25_USERS} users x {N25_ITEMS} items, {N25_EDGES} unique "
          f"ratings, ML-25M-skewed degrees: users min/median/max "
          f"{d['user_degree']['min']}/{d['user_degree']['median']:.0f}/"
          f"{d['user_degree']['max']}, items min/median/max "
          f"{d['item_degree']['min']}/{d['item_degree']['median']:.0f}/"
          f"{d['item_degree']['max']}; {rounds} swap rounds, {gen_s:.1f} s; dense "
          f"int8 R {nbytes} B > budget {als.DENSE_DEFAULT_BYTES} B, so "
          f"dense_eligible False ({gate_s:.3f} s); plans: users {pu['n_blocks']} "
          f"blocks ({pu['n_blocks_p']} padded, {pu['n_windows']} windows), items "
          f"{pi['n_blocks']} ({pi['n_blocks_p']}, {pi['n_windows']}), "
          f"{plan_s:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 16: the windowed pass kernels vs their plain versions on the card
# ---------------------------------------------------------------------------


def _implicit_weights(v, ok, alpha=1.0):
    conf = 1.0 + alpha * torch.abs(v)
    return conf * (v > 0).float() * ok, (conf - 1.0) * ok


def _windowed_compare(args, bwin, n_windows, tally, label):
    """block_partials, then the whole windowed_gram_b (with the combine),
    kernel vs plain on the card: within 1e-5*S elementwise, S the same
    pass over the absolute terms; a second launch gives the same bits."""
    kb, kg = wf.block_partials(*args)
    kb2, kg2 = wf.block_partials(*args)
    pb, pg = wf.block_partials_plain(*args)
    sb, sg = wf.block_partials_plain(*args, magnitude=True)
    torch.cuda.synchronize()
    check(torch.equal(kb, kb2) and torch.equal(kg, kg2),
          f"{label}: a second block_partials launch gave other bits")
    _within(kb, pb, sb, f"{label} partials b", tally)
    _within(kg, pg, sg, f"{label} partials gram", tally)
    del kb, kg, kb2, kg2
    b1, g1 = win.windowed_gram_b(*args, bwin, n_windows)
    b2, g2 = win.windowed_gram_b(*args, bwin, n_windows)
    cb, cg = wf.combine_windows_plain(pb, pg, bwin, n_windows)
    del pb, pg
    mb, mg = wf.combine_windows_plain(sb, sg, bwin, n_windows)
    del sb, sg
    torch.cuda.synchronize()
    check(torch.equal(b1, b2) and torch.equal(g1, g2),
          f"{label}: a second windowed_gram_b gave other bits")
    _within(b1, cb, mb, f"{label} gram_b b", tally, "combined_")
    _within(g1, cg, mg, f"{label} gram_b gram", tally, "combined_")
    tally["cases"] += 1


def _synthetic_plan(rng, k, implicit, n_src=2000, n_dst=5000, n_edges=200_000):
    """A planned random edge list with signed half-star ratings, on the
    card; half the padding slots get a local id past S."""
    dst = np.sort(rng.integers(0, n_dst, n_edges)).astype(np.int32)
    src = rng.integers(0, n_src, n_edges).astype(np.int32)
    vals = (rng.integers(1, 11, n_edges) / 2.0
            * rng.choice([-1.0, 1.0], n_edges)).astype(np.float32)
    plan, (s, v, ok, loc, bwin) = _plan_side(dst, src, vals, n_dst)
    loc = loc.copy()
    loc[(ok == 0) & (np.arange(loc.shape[1]) % 2 == 0)] = win.WINDOW_ROWS + 3
    return _side_on_card(rng, (s, v, ok, loc, bwin), n_src, k, implicit) + (
        plan.n_windows,)


def _side_on_card(rng, side, n_src, k, implicit):
    """(factors, src, w_b, w_g, local), block_window on the card, for one
    plan side with the half-step's weights (alpha 1.0)."""
    s, v, ok, loc, bwin = (torch.from_numpy(np.ascontiguousarray(a)).cuda()
                           for a in side)
    if implicit:
        w_b, w_g = _implicit_weights(v, ok)
    else:
        w_b, w_g = v * ok, ok.clone()
    f = torch.from_numpy((rng.standard_normal((n_src, k)) / np.sqrt(k))
                         .astype(np.float32)).cuda()
    return (f, s, w_b.contiguous(), w_g.contiguous(), loc), bwin


def phase_windowed(report, shared):
    rng = np.random.default_rng(SEED + 4)
    t0 = time.perf_counter()
    tally = {"cases": 0, "max_abs_err": 0.0, "max_ratio": 0.0,
             "combined_max_abs_err": 0.0, "combined_max_ratio": 0.0}
    for k in (1, 8, 10, 32):
        for implicit in (True, False):
            args, bwin, n_windows = _synthetic_plan(rng, k, implicit)
            _windowed_compare(args, bwin, n_windows, tally,
                              f"K={k} implicit={implicit}")
    # one block whose 1,024 slots all go to one row, beside a sorted one
    # and one whose ids run backwards (the flush adds into written rows)
    f = torch.from_numpy(rng.standard_normal((300, RANK)).astype(np.float32)).cuda()
    src = torch.from_numpy(rng.integers(0, 300, (3, 1024)).astype(np.int32)).cuda()
    w = torch.from_numpy(rng.uniform(0.5, 5.0, (3, 1024)).astype(np.float32)).cuda()
    local = np.stack([np.full(1024, 42), np.sort(rng.integers(0, 128, 1024)),
                      127 - np.arange(1024) % 128]).astype(np.int32)
    _windowed_compare((f, src, w, w, torch.from_numpy(local).cuda()),
                      torch.tensor([0, 0, 1], dtype=torch.int32).cuda(), 2,
                      tally, "one-row block")
    # an all-padding plan: every output is zero
    plan = win.plan_windows(np.zeros(0, np.int32), 1000)
    side = (plan.take(np.zeros(0, np.int32)).reshape(plan.n_blocks_p, -1),
            plan.take(np.zeros(0, np.float32)).reshape(plan.n_blocks_p, -1),
            plan.chunked_valid().reshape(plan.n_blocks_p, -1),
            plan.chunked_local().reshape(plan.n_blocks_p, -1), plan.block_window)
    args, bwin = _side_on_card(rng, side, 50, RANK, True)
    _windowed_compare(args, bwin, plan.n_windows, tally, "all-padding plan")
    b, g = win.windowed_gram_b(*args, bwin, plan.n_windows)
    check(not b.any() and not g.any(), "all-padding plan: nonzero output")
    # both full ML-25M plans at K = 10, as the train stages them
    for name, (p, side) in shared["plans25"].items():
        n_src = N25_ITEMS if name == "users" else N25_USERS
        args, bwin = _side_on_card(rng, side, n_src, RANK, True)
        _windowed_compare(args, bwin, p.n_windows, tally, f"ML-25M {name} plan")
        del args, bwin
    torch.cuda.empty_cache()
    report["windowed_sweep"] = dict(tally, seconds=time.perf_counter() - t0)
    print(f"[windowed] {tally['cases']} cases within 1e-5*S and bit-equal on "
          f"relaunch (block_partials and the whole windowed_gram_b): max "
          f"|kernel - plain| partials {tally['max_abs_err']:.3g} (ratio "
          f"{tally['max_ratio']:.3g}), combined {tally['combined_max_abs_err']:.3g} "
          f"(ratio {tally['combined_max_ratio']:.3g}); "
          f"{report['windowed_sweep']['seconds']:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 17: the windowed path, trained through ALSAlgorithm.train
# ---------------------------------------------------------------------------


class _PlainWindowed:
    """Route the windowed pass through the plain versions (on the card)
    for the comparison train; restores the wrappers on exit."""

    def __enter__(self):
        self.saved = (wf.block_partials, wf.combine_windows)
        wf.block_partials = wf.block_partials_plain
        wf.combine_windows = wf.combine_windows_plain

    def __exit__(self, *exc):
        wf.block_partials, wf.combine_windows = self.saved


def phase_windowed_train(report, shared):
    rows, cols, vals = shared["coo25"]
    td = TrainingData(
        rows=rows, cols=cols, vals=vals, n_users=N25_USERS, n_items=N25_ITEMS,
        user_vocab=BiMap({f"u{n}": n for n in range(N25_USERS)}),
        item_vocab=BiMap({f"i{n}": n for n in range(N25_ITEMS)}),
    )
    td.sanity_check()
    params = ALSAlgorithmParams(num_iterations=TRAIN_ITERATIONS)  # template defaults
    wf.BLOCK_LAUNCHES.update(partials=0, combine=0)  # counts to 0 just before
    df.PASS_LAUNCHES.update(row=0, col=0)
    with _Spy(als, "dense_eligible") as gate, _Spy(als, "stage_windowed") as stage:
        t0 = time.perf_counter()
        model = ALSAlgorithm(params).train(RuntimeContext(), td)
        train_s = time.perf_counter() - t0
    launches = dict(wf.BLOCK_LAUNCHES)
    dense_launches = dict(df.PASS_LAUNCHES)
    f = model.factors
    del model
    [(gate_s, _, _)], [(_, _, staged)] = gate.calls, stage.calls
    del gate, stage
    check(isinstance(staged, als.StagedWindowedTrain),
          f"the train staged {type(staged).__name__}, not StagedWindowedTrain")
    want = 2 * TRAIN_ITERATIONS  # one pass and one combine per half-step
    check(launches == {"partials": want, "combine": want},
          f"windowed kernel launches {launches} != {want} each (one per half-step)")
    check(dense_launches == {"row": 0, "col": 0}, "a dense pass kernel launched")
    check(f.user_factors.shape == (N25_USERS, RANK)
          and f.item_factors.shape == (N25_ITEMS, RANK), "factor shapes")
    check(bool(np.isfinite(f.user_factors).all()
               and np.isfinite(f.item_factors).all()), "non-finite factors")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    uf, itf = staged.factors(*staged.run())
    run_s = time.perf_counter() - t0
    check(np.array_equal(uf, f.user_factors) and np.array_equal(itf, f.item_factors),
          "a second kernel train from the same staging gave other bits")
    with _PlainWindowed():
        t0 = time.perf_counter()
        puf, pitf = staged.factors(*staged.run())
        plain_s = time.perf_counter() - t0
    cu, ci = _corr(f.user_factors, puf), _corr(f.item_factors, pitf)
    du = float(np.abs(f.user_factors - puf).max())
    di = float(np.abs(f.item_factors - pitf).max())
    check(cu > 0.9999 and ci > 0.9999,
          f"kernel vs plain train: corrcoef users {cu}, items {ci}")
    host_prep_s, transfer_s = staged.host_prep_sec, staged.transfer_sec
    del staged
    torch.cuda.empty_cache()

    # train → deploy: the blob ``console train`` writes, loaded as
    # ``console deploy`` loads it, served; each answer equals the plain top-k
    factors = convert.load_jax_als_blob(f.to_bytes())
    check(np.array_equal(factors.user_factors, f.user_factors)
          and np.array_equal(factors.item_factors, f.item_factors), "blob round trip")
    sv = als.stage_serving(factors)
    users = np.random.default_rng(SEED25).integers(0, N25_USERS, 16)
    scores, idx = als.recommend_serving(sv, users, 20)
    q = sv.users[torch.from_numpy(users).cuda()]
    pv, pi = rec.fused_recommend_topk_plain(q, sv.items, None, None, None, None,
                                            k=20, n_items=sv.n_items)
    check(np.array_equal(idx, pi.cpu().numpy()) and np.array_equal(scores, pv.cpu().numpy()),
          "served top-k differs from the plain top-k")
    del sv
    report["windowed_train"] = {
        "iterations": TRAIN_ITERATIONS, "rank": RANK, "edges": N25_EDGES,
        "main_path_s": train_s, "launches": launches, "gate_s": gate_s,
        "host_prep_s": host_prep_s, "transfer_s": transfer_s,
        "per_iteration_s": run_s / TRAIN_ITERATIONS,
        "plain_per_iteration_s": plain_s / TRAIN_ITERATIONS,
        "corr_users": cu, "corr_items": ci,
        "max_abs_diff_users": du, "max_abs_diff_items": di,
        "served_queries": len(users),
    }
    t = report["windowed_train"]
    print(f"[windowed train] ALSAlgorithm.train at ML-25M width ({N25_EDGES} "
          f"ratings, rank {RANK}, {TRAIN_ITERATIONS} iterations): {train_s:.2f} s "
          f"end to end on StagedWindowedTrain; launches block_partials "
          f"{launches['partials']} combine {launches['combine']}; gate "
          f"{t['gate_s']:.3f} s, host prep (argsorts, plans) {host_prep_s:.2f} s, "
          f"transfer {transfer_s:.3f} s, {t['per_iteration_s']:.4f} s per "
          f"iteration (plain pass {t['plain_per_iteration_s']:.4f} s); second run "
          f"bit-equal; vs the plain-pass train: corrcoef users {cu:.8f} items "
          f"{ci:.8f}, max |diff| users {du:.3g} items {di:.3g}; {len(users)} "
          f"served queries equal the plain top-k", flush=True)


# ---------------------------------------------------------------------------
# phase 18: the rank > 32 scatter path on the card
# ---------------------------------------------------------------------------


def phase_scatter(report, shared):
    """A small train at rank 48 through ALSAlgorithm.train, on the card
    and on the CPU from the same seeded start: the scatter path has no
    kernel of its own (gathers and index_add_), so this shows that it
    runs on cuda and agrees with the CPU to the CPU tests' bar."""
    rng = np.random.default_rng(SEED + 5)
    rows = rng.integers(0, SCATTER_USERS, SCATTER_EDGES).astype(np.int32)
    cols = rng.integers(0, SCATTER_ITEMS, SCATTER_EDGES).astype(np.int32)
    vals = (rng.integers(1, 11, SCATTER_EDGES) / 2.0).astype(np.float32)
    td = TrainingData(
        rows=rows, cols=cols, vals=vals, n_users=SCATTER_USERS,
        n_items=SCATTER_ITEMS,
        user_vocab=BiMap({f"u{n}": n for n in range(SCATTER_USERS)}),
        item_vocab=BiMap({f"i{n}": n for n in range(SCATTER_ITEMS)}),
    )
    params = ALSAlgorithmParams(rank=SCATTER_RANK, num_iterations=2)
    taken = []
    scatter = als._train_scatter

    def spy(*args, **kwargs):
        taken.append(kwargs.get("device"))
        return scatter(*args, **kwargs)

    before = (dict(wf.BLOCK_LAUNCHES), dict(df.PASS_LAUNCHES))
    als._train_scatter = spy
    try:
        t0 = time.perf_counter()
        card = ALSAlgorithm(params).train(RuntimeContext(), td)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        host = ALSAlgorithm(params).train(RuntimeContext(device="cpu"), td)
        cpu_s = time.perf_counter() - t0
    finally:
        als._train_scatter = scatter
    check(taken == [None, "cpu"], f"the scatter path ran {len(taken)} of 2 trains")
    check(before == (dict(wf.BLOCK_LAUNCHES), dict(df.PASS_LAUNCHES)),
          "a pass kernel launched on the scatter path")
    diffs = {}
    for side in ("user_factors", "item_factors"):
        got, want = getattr(card.factors, side), getattr(host.factors, side)
        check(got.shape == want.shape and bool(np.isfinite(got).all()),
              f"scatter {side}: shape or finiteness")
        check(np.allclose(got, want, rtol=1e-4, atol=1e-4),
              f"scatter {side}: card vs CPU beyond rtol = atol = 1e-4 (max "
              f"|diff| {float(np.abs(got - want).max()):.3g})")
        diffs[side] = float(np.abs(got - want).max())
    check(card.device.type == "cuda", f"the model is on {card.device}")
    report["scatter"] = {"users": SCATTER_USERS, "items": SCATTER_ITEMS,
                         "edges": SCATTER_EDGES, "rank": SCATTER_RANK,
                         "iterations": 2, "card_s": card_s, "cpu_s": cpu_s,
                         "max_abs_diff": diffs}
    print(f"[scatter] rank {SCATTER_RANK}, {SCATTER_EDGES} ratings, 2 iterations "
          f"through ALSAlgorithm.train on cuda ({card_s:.2f} s) and on the CPU "
          f"({cpu_s:.2f} s) from the same seed: max |diff| users "
          f"{diffs['user_factors']:.3g} items {diffs['item_factors']:.3g}", flush=True)


# ---------------------------------------------------------------------------
# phase 19: windowed pass times
# ---------------------------------------------------------------------------


def _windowed_bound(slots, n_src, n_blocks_p, n_windows, edges, k):
    """Least time for block_partials (`obs.costs.block_partials`): the
    four per-slot arrays and the factors read once, the partials written
    once, over HBM; or 2 f32 operations per term, 2*E*(K+K^2), at the
    f32 peak, E this plan's real edges. Returns it with the bytes-bound
    of the combine (`obs.costs.combine_windows`): the partials and block
    ids read once, the window sums written once (its adds are far
    fewer)."""
    secs, by = costs.block_partials(slots, n_src, n_blocks_p, win.WINDOW_ROWS, k,
                                    edges).bound(HBM_BPS, PEAK_OPS)
    combine = costs.combine_windows(n_blocks_p, win.WINDOW_ROWS, n_windows, k).bytes
    return 1e3 * secs, by, 1e3 * combine / HBM_BPS


def phase_windowed_times(report, shared):
    with _devprof_env("0"):
        _windowed_times(report, shared)


def _windowed_times(report, shared):
    rng = np.random.default_rng(SEED + 6)
    rows_out = []
    for name, (p, side) in shared.pop("plans25").items():
        n_src = N25_ITEMS if name == "users" else N25_USERS
        n_dst = N25_USERS if name == "users" else N25_ITEMS
        args, bwin = _side_on_card(rng, side, n_src, RANK, True)
        f, src, w_b, w_g, loc = args
        kernel = _time_ms(lambda: wf.block_partials(*args), 5)
        profiled, devprof_ms = _with_devprof_ms(
            "ops.windowed_block_partials", lambda: _time_ms(lambda: wf.block_partials(*args), 5))
        pb, pg = wf.block_partials(*args)
        combine = _time_ms(lambda: wf.combine_windows(pb, pg, bwin, p.n_windows), 5)
        plain = _time_ms(lambda: wf.block_partials_plain(*args), 1, repeats=3)
        combine_plain = _time_ms(
            lambda: wf.combine_windows_plain(pb, pg, bwin, p.n_windows), 1, repeats=3)
        del pb, pg
        # the yardstick: one gather, the outer products, and index_add_
        # into the (N, K + K^2) sums, over the real edges only
        keep = side[2].reshape(-1) > 0
        dst_e = torch.from_numpy(
            (np.repeat(side[4], win.BLOCK_EDGES) * win.WINDOW_ROWS
             + side[3].reshape(-1))[keep].astype(np.int64)).cuda()
        src_e = src.reshape(-1)[torch.from_numpy(keep).cuda()].long()
        wb_e = w_b.reshape(-1)[torch.from_numpy(keep).cuda()]
        wg_e = w_g.reshape(-1)[torch.from_numpy(keep).cuda()]
        edges = int(keep.sum())

        def library():
            y = f[src_e]
            payload = torch.cat(
                [y * wb_e[:, None],
                 (y[:, :, None] * y[:, None, :]).reshape(edges, RANK * RANK)
                 * wg_e[:, None]], dim=1)
            return torch.zeros((p.n_rows_padded, RANK + RANK * RANK),
                               device=f.device).index_add_(0, dst_e, payload)

        library_ms = _time_ms(library, 1, repeats=3)
        del dst_e, src_e, wb_e, wg_e, args, f, src, w_b, w_g, loc
        torch.cuda.empty_cache()
        bound, by, combine_bound = _windowed_bound(
            p.n_blocks_p * win.BLOCK_EDGES, n_src, p.n_blocks_p, p.n_windows,
            edges, RANK)
        rows_out.append({
            "side": name, "n_dst": n_dst, "n_blocks": p.n_blocks,
            "n_blocks_p": p.n_blocks_p, "n_windows": p.n_windows, "edges": edges,
            "K": RANK, "ms": kernel, "profiled_ms": profiled, "devprof_ms": devprof_ms,
            "plain_ms": plain,
            "library_ms": library_ms,
            "bound_ms": bound, "bound_by": by, "combine_ms": combine,
            "combine_plain_ms": combine_plain, "combine_bound_ms": combine_bound,
        })
        print(f"[times] windowed {name} side ({p.n_blocks_p} blocks, {edges} "
              f"ratings, K={RANK}): block_partials kernel {kernel:.4f} ms (through the "
              f"profiler {profiled:.4f} ms, devprof's mean a call {devprof_ms:.4f} ms), plain "
              f"{plain:.4f} ms, gather + outer + index_add_ {library_ms:.4f} ms, "
              f"bound {bound:.4f} ms ({by}); combine kernel {combine:.4f} ms, plain "
              f"{combine_plain:.4f} ms, bound {combine_bound:.4f} ms (bytes)",
              flush=True)
        if name == "users":
            rows_out.append(_partials_at_max_rank(rng, p, side, n_src, edges))
    report["windowed_times"] = rows_out
    dev = torch.device("cuda:0")
    report["partials_launch"] = {
        "ptxas": _ptxas_registers("windowed_pass", "partials_kernel"),
        **{f"K={k}": wf.partials_plan(k, win.WINDOW_ROWS, dev)
           for k in (RANK, wf.MAX_RANK)}}
    for key, val in report["partials_launch"].items():
        print(f"[times] partials_kernel {key}: {val}", flush=True)


def _ptxas_registers(source, kernel):
    """The `ptxas -v` register lines of `kernel`'s instantiations in
    `source`'s build (empty where this process did not build it)."""
    lines = _build.BUILD_LOGS.get(source, "").splitlines()
    return [next((x.strip() for x in lines[n + 1:] if "registers" in x), "")
            for n, ln in enumerate(lines)
            if "Compiling entry" in ln and kernel in ln]


def _partials_at_max_rank(rng, p, side, n_src, edges):
    """block_partials at K = wf.MAX_RANK on one plan (five warps of
    tiles, a block's rows cut into groups): kernel, plain, bound. No
    yardstick: its (E, K + K^2) payload would take ~106 GB."""
    k = wf.MAX_RANK
    args, _ = _side_on_card(rng, side, n_src, k, True)
    kernel = _time_ms(lambda: wf.block_partials(*args), 3)
    plain = _time_ms(lambda: wf.block_partials_plain(*args), 1, repeats=3)
    del args
    torch.cuda.empty_cache()
    bound, by, _ = _windowed_bound(p.n_blocks_p * win.BLOCK_EDGES, n_src,
                                   p.n_blocks_p, p.n_windows, edges, k)
    row = {"side": "users", "K": k, "n_blocks_p": p.n_blocks_p, "edges": edges,
           "ms": kernel, "plain_ms": plain, "library_ms": None,
           "bound_ms": bound, "bound_by": by}
    print(f"[times] windowed users side, K={k}: block_partials kernel "
          f"{kernel:.4f} ms, plain {plain:.4f} ms, bound {bound:.4f} ms ({by}); "
          f"no yardstick (its payload would take ~106 GB)", flush=True)
    return row


# ---------------------------------------------------------------------------
# phases 20-24: the Universal Recommender (CCO train, history scoring,
# the masked top-k kernel)
# ---------------------------------------------------------------------------


def _ur_scores(rng, b, i_p, n_items):
    """(B, I_p) f32 scores shaped like UR history sums: most items 0,
    the rest LLR sums; half the rows on a quarter-step grid (exact ties
    everywhere), equal maxima on both sides of every 1,024-column chunk
    boundary and every 4,096-column select segment boundary, an all-zero
    last row, dead pads past n_items."""
    s = np.where(rng.random((b, i_p)) < 0.7, 0.0,
                 rng.gamma(2.0, 8.0, (b, i_p))).astype(np.float32)
    s[::2] = np.round(s[::2] * 4) / 4
    edges = np.union1d(np.arange(rec._CHUNK, n_items, rec._CHUNK),
                       np.arange(rec.SELECT_SEGMENT, n_items, rec.SELECT_SEGMENT))
    s[:, edges - 1] = s[:, edges] = 1e4
    s[-1, :n_items] = 0.0
    s[:, n_items:] = rng.standard_normal((b, i_p - n_items))
    return torch.from_numpy(s).cuda()


def _ur_masks(rng, b, i_p, n_items):
    mask = rng.random((b, n_items)) < 0.2
    mask[0] = True  # a fully masked row
    out = {None: (None, None),
           "bits": (torch.from_numpy(rec.pack_mask_np(mask, i_p)).cuda(), None)}
    for width in (8, 64):
        rows = np.full((b, width), -1, np.int32)
        rows[:, : width - 2] = rng.integers(0, n_items, (b, width - 2))
        rows[:, 0] = rec._CHUNK - 1  # a crafted maximum
        rows[0, -1] = i_p + 9  # out of range: inert
        out[f"rows{width}"] = (None, torch.from_numpy(rows).cuda())
    return out


def phase_ur_sweep(report, shared):
    rng = np.random.default_rng(UR_SEED)
    tally = {"cases": 0, "max_abs_err": 0.0, "routes": {"select": 0, "sort": 0}}
    t0 = time.perf_counter()
    for i_p, n_items in UR_SWEEP_WIDTHS:
        check(rec.pad_items(n_items) == i_p, f"pad_items({n_items}) != {i_p}")
        for b in (1, 8, 64):
            scores = _ur_scores(rng, b, i_p, n_items)
            for kind, (bits, rows) in _ur_masks(rng, b, i_p, n_items).items():
                for k in sorted({kk for kk in UR_K_LADDER + (n_items,) if kk <= i_p}):
                    label = f"masked I_p={i_p} B={b} mask={kind} k={k}"
                    route = rec.topk_route(k)
                    before = rec.MASKED_ROUTE_LAUNCHES[route]
                    kv, ki = rec.fused_masked_topk(scores, bits, rows, k=k,
                                                   n_items=n_items)
                    pv, pi = rec.fused_masked_topk_plain(scores, bits, rows, k=k,
                                                         n_items=n_items)
                    torch.cuda.synchronize()
                    check(rec.MASKED_ROUTE_LAUNCHES[route] == before + 1,
                          f"{label}: not launched on the {route} route")
                    check(torch.equal(ki, pi), f"{label}: indices differ")
                    check(torch.equal(kv, pv), f"{label}: values differ")
                    tally["max_abs_err"] = max(tally["max_abs_err"],
                                               float((kv - pv).abs().max()))
                    if kind == "bits":  # row 0 is fully masked
                        n = min(k, n_items)
                        check(bool((kv[0, :n] == rec.NEG_INF).all()),
                              f"{label}: fully masked row")
                    tally["cases"] += 1
                    tally["routes"][route] += 1
    report["ur_sweep"] = dict(tally, seconds=time.perf_counter() - t0)
    print(f"[ur sweep] {tally['cases']} cases of fused_masked_topk (I_p "
          f"{', '.join(str(w) for w, _ in UR_SWEEP_WIDTHS)}; B 1/8/64; no mask, "
          f"bit words, row lists of 8 and 64; k {', '.join(map(str, UR_K_LADDER))} "
          f"and n_items; {tally['routes']['select']} on the select route, "
          f"{tally['routes']['sort']} on the sort route): indices and "
          f"values equal to the plain version in all, "
          f"{report['ur_sweep']['seconds']:.1f} s", flush=True)


def phase_ur_data(report, shared):
    """The repo's UR configuration (bench.py:bench_ur_framework at full
    size): 3,000 users, a 100,000-item catalog, one buy per item (full
    coverage) and 30 buys per user on item zipf(1.3) % 100,000; plus a
    secondary view indicator, 30 views per user drawn the same way from
    its own stream. Loaded into the port's MemoryEventStore."""
    t0 = time.perf_counter()
    buy_users, buy_items, view_users, view_items = _ur_arrays()
    rows = _ur_rows(buy_users, buy_items, view_users, view_items)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    storage, app_id = _ur_store()
    _ur_insert(storage, app_id, [(e, f"u{u}", f"i{i}") for e, u, i in rows], 0)
    load_s = time.perf_counter() - t0
    shared["ur"] = {"storage": storage, "app_id": app_id, "n_events": len(rows)}
    report["ur_data"] = {
        "users": UR_USERS, "items": UR_ITEMS, "buys": int(len(buy_users)),
        "views": int(len(view_users)),
        "distinct_bought": int(len(np.unique(buy_items))),
        "distinct_viewed": int(len(np.unique(view_items))),
        "generate_s": gen_s, "load_s": load_s,
    }
    d = report["ur_data"]
    print(f"[ur data] {UR_USERS} users, {UR_ITEMS} items: {d['buys']} buys "
          f"({d['distinct_bought']} items), {d['views']} views "
          f"({d['distinct_viewed']} items), zipf({UR_ZIPF}); generated in "
          f"{gen_s:.2f} s, {len(rows)} events into MemoryEventStore in "
          f"{load_s:.2f} s", flush=True)


def _ur_arrays():
    """The UR configuration's (buy users, buy items, view users, view
    items) from UR_SEED."""
    rng = np.random.default_rng(UR_SEED)
    buy_users = np.concatenate([rng.integers(0, UR_USERS, UR_ITEMS),
                                np.repeat(np.arange(UR_USERS), UR_PER_USER)])
    buy_items = np.concatenate([np.arange(UR_ITEMS),
                                rng.zipf(UR_ZIPF, UR_USERS * UR_PER_USER) % UR_ITEMS])
    vrng = np.random.default_rng(UR_SEED + 1)
    view_users = np.repeat(np.arange(UR_USERS), UR_PER_USER)
    view_items = vrng.zipf(UR_ZIPF, UR_USERS * UR_PER_USER) % UR_ITEMS
    return buy_users, buy_items, view_users, view_items


def _ur_rows(buy_users, buy_items, view_users, view_items):
    return ([("buy", u, i) for u, i in zip(buy_users.tolist(), buy_items.tolist())]
            + [("view", u, i) for u, i in zip(view_users.tolist(), view_items.tolist())])


def _ur_store():
    """A fresh memory store holding the UR app: (storage, app id)."""
    storage = Storage(StorageConfig.memory())
    app_id = storage.get_meta_data_apps().insert(App(0, UR_APP))
    storage.get_events().init_app(app_id)
    return storage, app_id


def _ur_insert(storage, app_id, rows, first):
    """(event, user, item) rows as events with explicit times and ids."""
    t0 = UR_T0
    storage.get_events().insert_batch([
        Event(event=e, entity_type="user", entity_id=u,
              target_entity_type="item", target_entity_id=t,
              event_time=t0 + datetime.timedelta(milliseconds=first + n),
              event_id=f"e{first + n:08d}")
        for n, (e, u, t) in enumerate(rows)
    ], app_id)


class _TimedCco:
    """Around the main-path train: time cco's indicator build, count
    products and LLR + top-n (each call synchronised), restored on exit."""

    NAMES = ("edges_to_indicator", "cooccurrence_counts", "llr_topn")

    def __enter__(self):
        self.saved = {n: getattr(cco, n) for n in self.NAMES}
        self.seconds = dict.fromkeys(self.NAMES, 0.0)
        self.calls = dict.fromkeys(self.NAMES, 0)

        def timed(name, fn):
            def run(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                self.seconds[name] += time.perf_counter() - t0
                self.calls[name] += 1
                return out
            return run

        for n, fn in self.saved.items():
            setattr(cco, n, timed(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(cco, n, fn)


def _llr_atol(n_users):
    """The LLR tolerance: 16 eps N ln N."""
    return 16 * float(np.finfo(np.float32).eps) * n_users * np.log(n_users)


def _row_mismatches(rv, ri, gi, atol):
    """Index mismatches of one CCO row outside tie groups: indices exactly
    except in runs of values (the reference's) within atol of each other
    or of 0, and in the run reaching the list's end."""
    bad, start, n = 0, 0, len(rv)
    while start < n:
        end = start + 1
        while end < n and abs(rv[end] - rv[end - 1]) <= atol:
            end += 1
        if rv[start] > atol and end < n:
            bad += sorted(ri[start:end]) != sorted(gi[start:end])
        start = end
    return bad


def _correlators_close(ref, got, n_users):
    """(max |dv|, index mismatches outside tie groups, atol, the worst
    (row, position)) of two CCO tables under the LLR tolerance atol =
    16 eps N ln N: values position by position, indices as
    `_row_mismatches` compares them."""
    (rv, ri), (gv, gi) = ref, got
    atol = _llr_atol(n_users)
    diff = np.abs(rv - gv)
    dv = float(diff.max())
    worst = np.unravel_index(int(diff.argmax()), diff.shape)
    bad = sum(_row_mismatches(rv[row], ri[row], gi[row], atol) for row in range(rv.shape[0]))
    return dv, bad, atol, worst


def _llr_f64_row(p, s, item, n_users, top_n, exclude_diagonal):
    """One item's correlator row in float64 from the 0/1 CPU matrices,
    masked and ordered as `cco.llr_topn` does it (pairs that never
    co-occur and the diagonal at NEG_INF, value descending then index
    ascending, index -1 where the value is not > 0)."""
    # the counts are integers below 2^24: exact in float32, then widened
    k11 = (p[:, item] @ s).double().numpy()
    k12 = float(p[:, item].sum()) - k11
    k21 = s.sum(dim=0).double().numpy() - k11
    k22 = n_users - k11 - k12 - k21

    def xl(x):
        x = np.asarray(x, np.float64)
        return np.where(x > 0, x * np.log(np.where(x > 0, x, 1.0)), 0.0)

    llr = 2.0 * (xl(k11) + xl(k12) + xl(k21) + xl(k22) - xl(k11 + k12) - xl(k21 + k22)
                 - xl(k11 + k21) - xl(k12 + k22) + xl(float(n_users)))
    llr = np.maximum(llr, 0.0)
    masked = float(np.float32(cco.NEG_INF))  # as the float32 tables hold it
    llr[k11 <= 0] = masked
    if exclude_diagonal:
        llr[item] = masked
    order = np.lexsort((np.arange(len(llr)), -llr))[:top_n]
    v = llr[order]
    return v, np.where(v > 0.0, order, -1)


def _hold_ur_block(p_cpu, s_cpu, lo, cpu, card, n_users, exclude_diagonal):
    """One block of a card-trained CCO table held to the same block
    trained on the host CPU in float32, row by row, at the LLR tolerance.
    Where the card and the CPU disagree on a row beyond it (a host whose
    float32 log is worse than the card's), the float64 LLR of the same
    counts decides: the card's row is held to it at the same atol, its
    indices as sets inside tie groups. Returns (max |card - CPU| over the
    rows they agree on, index mismatches there, the disputed rows)."""
    (cv, ci), (gv, gi) = cpu, card
    atol = _llr_atol(n_users)
    agreed_dv, disputed = 0.0, []
    for r in range(cv.shape[0]):
        dv = float(np.abs(cv[r] - gv[r]).max())
        if dv <= atol and _row_mismatches(cv[r], ci[r], gi[r], atol) == 0:
            agreed_dv = max(agreed_dv, dv)
            continue
        fv, fi = _llr_f64_row(p_cpu, s_cpu, lo + r, n_users, cv.shape[1], exclude_diagonal)
        card_dv = float(np.abs(fv - gv[r]).max())
        card_bad = _row_mismatches(fv, fi, gi[r], atol)
        row = {"item": lo + r, "card_vs_cpu": dv, "card_vs_f64": card_dv,
               "cpu_vs_f64": float(np.abs(fv - cv[r]).max()),
               "card_index_mismatches_vs_f64": card_bad,
               "cpu_index_mismatches_vs_f64": _row_mismatches(fv, fi, ci[r], atol)}
        check(card_dv <= atol and card_bad == 0,
              f"item {lo + r}: the card's correlators are off the float64 LLR ({row}, "
              f"atol {atol:.4g})")
        disputed.append(row)
    return agreed_dv, disputed


def phase_ur_train(report, shared):
    ur = shared["ur"]
    ctx = RuntimeContext(storage=ur["storage"])  # the first CUDA device
    t0 = time.perf_counter()
    td = URDataSource(URDataSourceParams(UR_APP, ("buy", "view"))).read_training(ctx)
    read_s = time.perf_counter() - t0
    td.sanity_check()
    params = URAlgorithmParams(app_name=UR_APP)  # template defaults
    check(params.max_correlators_per_item == UR_CORRELATORS
          and params.max_query_events == UR_QUERY_EVENTS, "template defaults")
    torch.cuda.reset_peak_memory_stats()
    with _TimedCco() as timed:
        t0 = time.perf_counter()
        model = URAlgorithm(params).train(ctx, td)
        train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(model.device.type == "cuda", f"the model is on {model.device}")
    n_items = len(model.item_vocab)
    check(n_items == UR_ITEMS, f"{n_items} items in the model, not {UR_ITEMS}")
    tables = {}
    for m in model.indicator_models:
        check(m.correlator_scores.shape == (n_items, UR_CORRELATORS)
              and m.correlator_idx.shape == (n_items, UR_CORRELATORS),
              f"{m.name}: table shape")
        check(bool(np.isfinite(m.correlator_scores).all()), f"{m.name}: not finite")
        live = m.correlator_idx >= 0
        check(bool((m.correlator_scores[live] > 0).all())
              and int(m.correlator_idx.max()) < len(m.target_vocab),
              f"{m.name}: a live correlator with LLR <= 0 or out of range")
        tables[m.name] = {"targets": len(m.target_vocab),
                          "items_with_correlators": int(live.any(axis=1).sum()),
                          "correlators": int(live.sum())}
    # the same train on the CPU, for UR_CPU_BLOCKS item blocks of each
    # indicator (a whole CPU train of 2 x 6e13 operations would not fit
    # the run's time), through the same block function at the same offsets
    t0 = time.perf_counter()
    primary = td.indicators[0]
    p_cpu = cco.edges_to_indicator(primary.rows, primary.cols, td.n_users,
                                   n_items, device="cpu")
    compare = {}
    for ind, m in zip(td.indicators, model.indicator_models):
        s_cpu = (p_cpu if ind.name == primary.name else cco.edges_to_indicator(
            ind.rows, ind.cols, td.n_users, len(ind.target_vocab), device="cpu"))
        worst = {"max_abs_diff": 0.0, "rows": 0, "disputed": []}
        atol = _llr_atol(td.n_users)
        for lo in UR_CPU_BLOCKS:
            hi = lo + UR_CPU_BLOCK_ROWS
            v, i = cco._cco_topn(p_cpu[:, lo:hi], s_cpu, td.n_users, lo,
                                 top_n=UR_CORRELATORS,
                                 exclude_diagonal=ind.name == primary.name)
            dv, disputed = _hold_ur_block(
                p_cpu, s_cpu, lo, (v.numpy(), i.numpy()),
                (m.correlator_scores[lo:hi], m.correlator_idx[lo:hi]), td.n_users,
                exclude_diagonal=ind.name == primary.name)
            worst["max_abs_diff"] = max(worst["max_abs_diff"], dv)
            worst["disputed"] += disputed
            worst["rows"] += hi - lo
        compare[ind.name] = worst
    cpu_s = time.perf_counter() - t0
    del p_cpu, s_cpu
    ur["model"] = model
    report["ur_train"] = {
        "read_s": read_s, "train_s": train_s,
        "indicator_build_s": timed.seconds["edges_to_indicator"],
        "counts_s": timed.seconds["cooccurrence_counts"],
        "llr_topn_s": timed.seconds["llr_topn"], "calls": timed.calls,
        "peak_device_bytes": peak, "tables": tables, "cpu_check": compare,
        "cpu_check_s": cpu_s, "llr_atol": atol,
    }
    t = report["ur_train"]
    print(f"[ur train] URDataSource.read_training {read_s:.2f} s, "
          f"URAlgorithm.train on cuda {train_s:.2f} s (indicator build "
          f"{t['indicator_build_s']:.3f} s, counts {t['counts_s']:.3f} s in "
          f"{timed.calls['cooccurrence_counts']} block products, LLR + top-n "
          f"{t['llr_topn_s']:.3f} s), peak {peak / 2**30:.2f} GiB; tables "
          f"{tables}; vs the CPU on {len(UR_CPU_BLOCKS)} blocks of "
          f"{UR_CPU_BLOCK_ROWS} items each: {compare} (atol {atol:.4g}), "
          f"{cpu_s:.1f} s", flush=True)


def _ur_queries(rng, new_users):
    qs = []
    for _ in range(N_QUERIES):
        r = rng.random()
        if r < 0.1:
            user = f"ghost{int(rng.integers(1000))}"  # unknown to the store
        elif r < 0.2:
            user = new_users[int(rng.integers(len(new_users)))]
        else:
            user = f"u{int(rng.integers(UR_USERS))}"
        q = {"user": user, "num": int(rng.choice([5, 10, 20, 50])),
             "exclude_seen": bool(rng.random() < 0.9)}
        if rng.random() < 0.2:
            q["blacklist"] = [f"i{int(x)}" for x in
                              rng.zipf(UR_ZIPF, int(rng.integers(3, 11))) % UR_ITEMS]
        qs.append(q)
    return qs


def phase_ur_serve(report, shared):
    ur = shared["ur"]
    storage, model = ur["storage"], ur["model"]
    rng = np.random.default_rng(UR_SEED + 2)
    # view-only users, added after the train
    new_users = [f"new{n}" for n in range(UR_NEW_USERS)]
    view_targets = list(model.indicator_models[1].target_vocab)
    rows = [("view", u, view_targets[int(j)]) for u in new_users
            for j in rng.integers(0, len(view_targets), 10)]
    _ur_insert(storage, ur["app_id"], rows, ur["n_events"])
    params = URAlgorithmParams(app_name=UR_APP)
    algo = URAlgorithm(params)
    algo.set_serving_context(RuntimeContext(storage=storage, mode="serve"))
    server = QueryServer(algo, model, QueryServerConfig(ip="127.0.0.1", port=0))
    t0 = time.perf_counter()
    port = server.start()  # warms up: stages the tables, runs the ladder
    warm_s = time.perf_counter() - t0
    try:
        queries = _ur_queries(rng, new_users)
        before = _status(port)
        out: dict = {}
        lock = threading.Lock()
        work = list(enumerate(queries))
        threads = [threading.Thread(target=_client,
                                    args=(port, work[c::N_CLIENTS], out, lock))
                   for c in range(N_CLIENTS)]
        als_before = rec.LAUNCHES
        rec.MASKED_LAUNCHES = 0  # every count to 0 just before the main path
        rec.MASKED_ROUTE_LAUNCHES.update(select=0, sort=0)
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = rec.MASKED_LAUNCHES
        routes = dict(rec.MASKED_ROUTE_LAUNCHES)
        check(not any(t.is_alive() for t in threads), "clients hung")
        after = _status(port)
        batches = after["batches"] - before["batches"]
        batch_s = after["batch_predict_seconds"] - before["batch_predict_seconds"]
    finally:
        server.stop()
    check(server._thread is None, "server thread not joined")
    check(len(out) == N_QUERIES, f"{len(out)} of {N_QUERIES} answered")
    check(rec.LAUNCHES == als_before, "the ALS top-k kernel launched on the UR path")
    # the plain versions on the CPU, from the same tables and store
    t0 = time.perf_counter()
    cpu_model = URModel(model.item_vocab, model.indicator_models,
                        model.primary_indicator, device="cpu")
    cpu_ctx = RuntimeContext(storage=storage, mode="serve", device="cpu")
    expected = []
    for lo in range(0, N_QUERIES, 64):
        chunk = [URQuery(**q) for q in queries[lo:lo + 64]]
        expected.extend(_to_jsonable(p) for p in algo._predict_batch(
            cpu_ctx, cpu_model, chunk))
    cpu_s = time.perf_counter() - t0
    empty = 0
    for n, q in enumerate(queries):
        status, body, _ = out[n]
        check(status == 200, f"query {n}: HTTP {status} {body}")
        check(body == expected[n], f"query {n} ({q}) differs from the CPU plain version")
        empty += not body["item_scores"]
        if q["user"].startswith("ghost"):
            check(not body["item_scores"], f"query {n}: an unknown user got items")
    check(empty < N_QUERIES // 2, f"{empty} of {N_QUERIES} answers are empty")
    check(launches > 0, "the UR path launched no masked top-k kernel")
    check(launches == batches,
          f"masked kernel launches {launches} != device batches {batches}")
    check(routes["select"] == batches,
          f"select-route launches {routes['select']} != device batches {batches}")
    lat = sorted(v[2] for v in out.values())
    report["ur_serve"] = {
        "warmup_s": warm_s, "wall_s": wall, "qps": N_QUERIES / wall,
        "p50_ms": 1e3 * lat[len(lat) // 2],
        "p99_ms": 1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        "batches": batches, "launches": launches, "route_launches": routes,
        "mean_batch": N_QUERIES / batches,
        "batch_predict_ms": 1e3 * batch_s / batches,
        "empty_answers": empty, "cpu_check_s": cpu_s,
    }
    s = report["ur_serve"]
    print(f"[ur serve] {N_QUERIES} UR queries from {N_CLIENTS} clients ("
          f"{UR_NEW_USERS} view-only users added after the train, unknown users, "
          f"blacklists), all equal to the CPU plain version: p50 "
          f"{s['p50_ms']:.3f} ms, p99 {s['p99_ms']:.3f} ms, {s['qps']:.1f} qps, "
          f"{batches} batches (mean {s['mean_batch']:.2f} queries, "
          f"{s['batch_predict_ms']:.3f} ms of batch_predict each), masked kernel "
          f"launches {launches} ({routes['select']} select route, "
          f"{routes['sort']} sort route); {empty} empty answers; warmup {warm_s:.2f} s, "
          f"CPU check {cpu_s:.1f} s", flush=True)


def phase_ur_times(report, shared):
    ur = shared.pop("ur")
    model = ur["model"]
    rng = np.random.default_rng(UR_SEED + 3)
    n_items = len(model.item_vocab)
    i_p = rec.pad_items(n_items)
    tables = model.device_tables()
    idx_t = tuple(t[0] for t in tables)
    sc_t = tuple(t[1] for t in tables)
    j_sizes = tuple(t[2] for t in tables)
    rows = []
    for b in (1, 64):
        # histories of real users, read as the engine reads them
        users = [f"u{int(u)}" for u in rng.integers(0, UR_USERS, b)]
        algo = URAlgorithm(URAlgorithmParams(app_name=UR_APP))
        ctx = RuntimeContext(storage=ur["storage"], mode="serve")
        hists = []
        for m in model.indicator_models:
            h = np.full((b, UR_QUERY_EVENTS), -1, np.int32)
            for qi, hist in enumerate(algo._user_histories(ctx, users, m.name,
                                                           m.target_vocab)):
                h[qi, : len(hist)] = hist[:UR_QUERY_EVENTS]
            hists.append(torch.from_numpy(h).cuda())
        hists = tuple(hists)
        scores = cco.history_scores(idx_t, sc_t, hists, j_sizes, i_p)
        mask = rng.random((b, n_items)) < 0.001
        bits = torch.from_numpy(rec.pack_mask_np(mask, i_p)).cuda()
        dense_mask = rec.unpack_mask(bits, i_p)
        k = UR_TIMES_K
        kernel = _time_ms(lambda: rec.fused_masked_topk(scores, bits, k=k,
                                                        n_items=n_items), 50)
        device, split, seen, sessions = _device_ms(lambda: rec.fused_masked_topk(
            scores, bits, k=k, n_items=n_items), _launches_per_call(i_p, k))
        check(seen == _launches_per_call(i_p, k),
              f"B={b}: the profiler saw {seen:g} launches a call, the "
              f"{rec.topk_route(k)} route makes {_launches_per_call(i_p, k)}")
        plain = _time_ms(lambda: rec.fused_masked_topk_plain(
            scores, bits, None, k=k, n_items=n_items), 10)
        library = _time_ms(lambda: torch.topk(
            torch.where(dense_mask, rec.NEG_INF, scores), k, dim=1), 50)
        scoring = _time_ms(lambda: cco.history_scores(idx_t, sc_t, hists, j_sizes,
                                                      i_p), 10)
        bound = 1e3 * costs.masked_topk(b, i_p, k).bytes / HBM_BPS
        rows.append({"B": b, "I_p": i_p, "k": k, "mask": "bits", "ms": kernel,
                     "device_ms": device, "device_split_ms": split,
                     "route": rec.topk_route(k), "launches_per_call": seen,
                     "profiler_sessions": sessions,
                     "plain_ms": plain, "library_ms": library, "bound_ms": bound,
                     "bound_by": "bytes", "history_scoring_ms": scoring})
        print(f"[ur times] fused_masked_topk B={b} I_p={i_p} k={k} bit words: "
              f"kernel {kernel:.4f} ms ({rec.topk_route(k)} route, {seen:g} "
              f"launches per call in profiler session {sessions}; {device:.4f} ms of it on the card: "
              f"{', '.join(f'{n} {t:.4f}' for n, t in split.items())}), plain "
              f"{plain:.4f} ms, "
              f"torch.topk(where(mask)) {library:.4f} ms, bound {bound:.5f} ms "
              f"(bytes); history scoring (gather + chain, outside the kernel) "
              f"{scoring:.4f} ms", flush=True)
    report["ur_times"] = rows
    report["ur_batch_invariance"] = _ur_batch_invariance(
        ur, model, (idx_t, sc_t, j_sizes, i_p), hists, bits, users)
    del model, tables
    torch.cuda.empty_cache()


def _ur_batch_invariance(ur, model, tables, hists, bits, users):
    """On the card, as phase 3 holds the ALS selector: each of 64 real
    users' rows of `history_scores` at B = 64 bit-equal to the user
    scored alone (B = 1), the masked select's values and indices of the
    batch equal to each row's alone, and the UR's answers through
    `batch_predict` to 64 queries in one batch equal to each query
    answered alone, scores bit for bit."""
    idx_t, sc_t, j_sizes, i_p = tables
    n_items = len(model.item_vocab)
    full = cco.history_scores(idx_t, sc_t, hists, j_sizes, i_p)
    vals, idx = rec.fused_masked_topk(full, bits, k=UR_TIMES_K, n_items=n_items)
    for b in range(full.shape[0]):
        one = cco.history_scores(idx_t, sc_t, tuple(h[b:b + 1] for h in hists), j_sizes, i_p)
        check(torch.equal(one[0], full[b]),
              f"history_scores: user {b}'s row at B=64 differs from B=1")
        v1, i1 = rec.fused_masked_topk(one, bits[b:b + 1], k=UR_TIMES_K, n_items=n_items)
        check(torch.equal(v1[0], vals[b]) and torch.equal(i1[0], idx[b]),
              f"masked select: user {b}'s answer at B=64 differs from B=1")
    algo = URAlgorithm(URAlgorithmParams(app_name=UR_APP))
    algo.set_serving_context(RuntimeContext(storage=ur["storage"], mode="serve"))
    queries = [URQuery(user=u, num=1 + n % 20, exclude_seen=n % 3 != 0)
               for n, u in enumerate(users)]
    batch = algo.batch_predict(None, model, list(enumerate(queries)))
    same = sum(
        [(s.item, s.score) for s in got.item_scores]
        == [(s.item, s.score) for s in algo.batch_predict(None, model, [(0, q)])[0][1].item_scores]
        for (_, got), q in zip(batch, queries))
    check(same == len(queries), f"UR answers: {len(queries) - same} of {len(queries)} "
          "differ between B=64 and B=1")
    print(f"[ur times] batch invariance on the card: history_scores, the masked select and "
          f"the served answers of {len(queries)} users at B=64 equal to B=1 bit for bit",
          flush=True)
    return {"users": len(queries), "bit_equal": True}


# ---------------------------------------------------------------------------
# phase 25: the classification and regression templates
# ---------------------------------------------------------------------------


def _covtype(rng):
    """UCI Covertype's shape from `rng`: the 7 cover types in their
    published counts, shuffled; 10 integer quantitative columns drawn per
    cover type and clipped to their published ranges (the signed vertical
    distance shifted by 173 to be non-negative, so that multinomial naive
    Bayes applies); one wilderness area of 4 and one soil type of 40 per
    cell, from per-cover-type Dirichlet draws. (N, 54) f32 and (N,) int32."""
    y = np.repeat(np.arange(len(COVTYPE_COUNTS)), COVTYPE_COUNTS)
    rng.shuffle(y)
    n = len(y)
    x = np.zeros((n, len(COVTYPE_ATTRS)), np.float32)
    for j, (_name, lo, hi, means, spread) in enumerate(COVTYPE_QUANT):
        col = np.asarray(means, np.float64)[y] + spread * rng.standard_normal(n)
        x[:, j] = np.clip(np.round(col), lo, hi)
    x[:, 4] += 173.0
    for start, width, conc in ((10, 4, 1.0), (14, 40, 0.3)):
        cum = np.cumsum(rng.dirichlet(np.full(width, conc), size=len(COVTYPE_COUNTS)), axis=1)
        pick = np.minimum((rng.random(n)[:, None] > cum[y]).sum(1), width - 1)
        x[np.arange(n), start + pick] = 1.0
    return x, y.astype(np.int32)


def _year_msd(rng):
    """YearPredictionMSD's shape from `rng`: 515,345 x 90 features (means
    and spreads drawn per column) and a year target linear in them plus
    noise, rounded and clipped to 1922-2011. (N, 90) f32, (N,) f32."""
    d = len(YEAR_ATTRS)
    mean = np.r_[rng.uniform(-50, 50, 12), rng.uniform(-200, 200, d - 12)]
    spread = np.r_[rng.uniform(5, 50, 12), rng.uniform(10, 300, d - 12)]
    z = rng.standard_normal((YEAR_ROWS, d), dtype=np.float32)
    x = (mean + spread * z).astype(np.float32)
    beta = rng.choice([-1.0, 1.0], d) * rng.uniform(0.5, 1.5, d) * 8.0 / np.sqrt(d)
    year = 1998.0 + z @ beta + 6.0 * rng.standard_normal(YEAR_ROWS)
    return x, np.clip(np.round(year), *YEAR_SPAN).astype(np.float32)


def _ridge_f64(x, y, l2):
    """Ridge with an intercept in float64 numpy: (weights, intercept)."""
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    mu, ybar = x64.mean(axis=0), y64.mean()
    xc = x64 - mu
    w = np.linalg.solve(xc.T @ xc + l2 * len(x) * np.eye(x.shape[1]), xc.T @ (y64 - ybar))
    return w, ybar - mu @ w


def _timed(fn):
    """fn() on the card: (its result, host seconds, CUDA-event seconds)."""
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, a.elapsed_time(b) / 1e3


@contextlib.contextmanager
def _tf32_allowed():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _same_bits(name, train, arrays):
    """`train()` on the card, timed; then again, and again with TF32
    allowed for the process: each must give the first train's bits (the
    modules turn TF32 off themselves, and sum in a fixed order)."""
    model, host_s, card_s = _timed(train)
    again = train()
    with _tf32_allowed():
        tf32 = train()
    for other, how in ((again, "relaunch"), (tf32, "TF32 allowed")):
        for key, value in arrays(model).items():
            check(np.array_equal(value, arrays(other)[key]),
                  f"{name}: {key} differs on {how}")
    return model, {"host_s": host_s, "card_s": card_s}


def _lr_close(got, want, what):
    bar = 1e-4 * np.abs(want) + 1e-5 * np.abs(want).max()
    err = float(np.max(np.abs(got - want) - bar))
    check(err <= 0, f"{what}: weights past rtol 1e-4, atol 1e-5 max|w| by {err}")


def _classify_trains(out, x, y):
    """(a) The three models at the template defaults on Covertype's shape,
    on the card: bits on relaunch and with TF32 allowed, the CPU's naive
    Bayes and logistic regression, two trees regrown on the CPU from the
    card's draws, and held-out accuracy above the majority rate."""
    n_tr = int(0.9 * len(x))
    xtr, ytr, xte, yte = x[:n_tr], y[:n_tr], x[n_tr:], y[n_tr:]
    majority = max(COVTYPE_COUNTS) / sum(COVTYPE_COUNTS)
    n_cls = len(COVTYPE_COUNTS)
    res = out["trains"] = {"train_rows": n_tr, "held_out": len(xte), "majority": majority}

    def nb_train(device=None):
        return classify.train_naive_bayes(xtr, ytr, n_cls, NB_LAMBDA, device=device)

    nb, res["naive"] = _same_bits("naive Bayes", nb_train, lambda m: {
        "log_prior": m.log_prior, "log_likelihood": m.log_likelihood})
    t0 = time.perf_counter()
    nb_cpu = nb_train("cpu")
    res["naive"]["cpu_s"] = time.perf_counter() - t0
    for key in ("log_prior", "log_likelihood"):
        got, want = getattr(nb, key), getattr(nb_cpu, key)
        check(np.allclose(got, want, rtol=1e-5, atol=0), f"naive Bayes {key}: card vs CPU")
        res["naive"][f"{key}_max_rel"] = float(np.max(np.abs(got - want) / np.abs(want)))

    def lr_train(device=None):
        return classify.train_logistic_regression(
            xtr, ytr, n_cls, iterations=LR_ITERATIONS, lr=LR_RATE, l2=LR_L2, device=device)

    lr, res["logreg"] = _same_bits("logistic regression", lr_train,
                                   lambda m: {"weights": m.weights})
    t0 = time.perf_counter()
    lr_cpu = lr_train("cpu")
    res["logreg"]["cpu_s"] = time.perf_counter() - t0
    _lr_close(lr.weights, lr_cpu.weights, "logistic regression card vs CPU")
    res["logreg"]["max_abs_diff"] = float(np.abs(lr.weights - lr_cpu.weights).max())

    def rf_train(device=None):
        return forest.train_random_forest(xtr, ytr, n_cls, n_trees=RF_TREES,
                                          max_depth=RF_DEPTH, n_bins=RF_BINS, seed=RF_SEED,
                                          device=device)

    with _Spy(forest, "draw_forest") as draws:
        rf, res["randomforest"] = _same_bits("random forest", rf_train, lambda m: {
            "features": m.features, "routes_f": m.routes_f, "routes_t": m.routes_t,
            "leaf_proba": m.leaf_proba})
    boot, uniforms = draws.calls[0][2]
    t0 = time.perf_counter()
    xbin = torch.from_numpy(forest.binize(xtr, rf.bin_edges).astype(np.int64))
    regrown = forest.grow_forest(
        xbin, torch.from_numpy(ytr.astype(np.int64)), boot[:RF_REGROWN].cpu(),
        [None if u is None else u[:RF_REGROWN].cpu() for u in uniforms], n_classes=n_cls,
        n_bins=RF_BINS, feat_per_node=forest.feat_per_node_of(x.shape[1], None),
        min_child_weight=1.0)
    res["randomforest"]["cpu_regrow_s"] = time.perf_counter() - t0
    for key, got in zip(("features", "routes_f", "routes_t", "leaf_proba"), regrown):
        check(np.array_equal(got.numpy(), getattr(rf, key)[:RF_REGROWN]),
              f"random forest: {key} of the first {RF_REGROWN} trees regrown on the CPU "
              f"from the card's draws differ")
    for name, model in (("naive", nb), ("logreg", lr), ("randomforest", rf)):
        acc = float((model.predict(xte) == yte).mean())
        res[name]["accuracy"] = acc
        check(acc > majority, f"{name}: held-out accuracy {acc} <= majority {majority}")
    res["randomforest"]["internal_nodes"] = int((rf.features >= 0).sum())


def _regress_trains(out, x, y):
    """(b) Ridge at YearPredictionMSD's shape and published split on the
    card: bits on relaunch and with TF32 allowed, the weights against a
    float64 ridge, the test RMSE, and the l2 grid against its per-point
    trains."""
    xtr, ytr, xte, yte = x[:YEAR_TRAIN], y[:YEAR_TRAIN], x[YEAR_TRAIN:], y[YEAR_TRAIN:]
    res = out["ridge"] = {"train_rows": len(xtr), "test_rows": len(xte)}

    def train(device=None, l2=RIDGE_L2):
        return linreg.train_linear_regression(xtr, ytr, l2=l2, device=device)

    model, timing = _same_bits("ridge", train, lambda m: {
        "weights": m.weights, "intercept": np.float64(m.intercept)})
    res.update(timing)
    t0 = time.perf_counter()
    w64, b64 = _ridge_f64(xtr, ytr, RIDGE_L2)
    res["f64_s"] = time.perf_counter() - t0
    rel = np.abs(model.weights - w64) / np.abs(w64)
    res["weights_max_rel"] = float(rel.max())
    check(rel.max() <= 1e-3, f"ridge weights {rel.max()} from the float64 ridge")
    rmse = float(np.sqrt(np.mean((model.predict(xte).astype(np.float64) - yte) ** 2)))
    rmse64 = float(np.sqrt(np.mean((xte.astype(np.float64) @ w64 + b64 - yte) ** 2)))
    res.update(rmse=rmse, rmse_f64=rmse64, intercept=model.intercept, intercept_f64=b64)
    check(abs(rmse / rmse64 - 1) <= 1e-3, f"test RMSE {rmse} against the float64 {rmse64}")
    grid = linreg.train_linear_regression_grid(xtr, ytr, RIDGE_GRID)
    for l2, g in zip(RIDGE_GRID, grid):
        ref = train(l2=l2)
        check(np.allclose(g.weights, ref.weights, rtol=1e-4, atol=0)
              and abs(g.intercept - ref.intercept) <= 1e-4 * abs(ref.intercept),
              f"ridge grid point l2={l2} differs from its own train")


def _set_events(path, etype, prefix, attrs, x, target_attr, targets):
    """One `$set` a row: the row's attributes and its target, as JSON
    lines."""
    with open(path, "w") as f:
        for i, (row, target) in enumerate(zip(x.tolist(), targets)):
            props = dict(zip(attrs, row))
            props[target_attr] = target
            f.write(json.dumps({"event": "$set", "entityType": etype,
                                "entityId": f"{prefix}{i:06d}", "properties": props,
                                "eventTime": _ms_iso(CLASSIFY_T0_MS + 1000 * i)}) + "\n")


def _import_and_train(app, events_path, engine_json, source_cls):
    """`app new`, `import` and `train --engine-json` here: the import
    seconds and the training data the DataSource read."""
    check(console.main(["app", "new", app]) == 0, f"app new {app}")
    t0 = time.perf_counter()
    check(console.main(["import", "--app", app, "--input", str(events_path)]) == 0,
          f"import into {app}")
    import_s = time.perf_counter() - t0
    with _Spy(source_cls, "read_training") as read:
        check(console.main(["train", "--engine-json", str(engine_json)]) == 0,
              f"train --engine-json {engine_json.name}")
    return import_s, read.calls[0][2]


def _deploy(engine_json, log_name, queries, malformed=()):
    """`deploy --engine-json` in a process of its own on the card, the
    queries from N_CLIENTS threads, then the malformed ones one by one."""
    t0 = time.perf_counter()
    with _Console(["deploy", "--engine-json", str(engine_json), "--ip", "127.0.0.1",
                   "--port", "0"], CLASSIFY_DIR / log_name) as dep:
        port = dep.port(timeout=300)
        before = _status(port)
        ready_s = time.perf_counter() - t0
        answers, wall = _serve_load(port, queries)
        refused = [_call(port, "POST", "/queries.json", body) for body in malformed]
        after = _status(port)
    return answers, refused, before, after, {"deploy_ready_s": ready_s,
                                             **_latency(answers, wall, len(queries))}


def _grid_eval(storage, evaluation, eps, algo_cls, held):
    """`run_evaluation` of a grid on the card through `_batch_eval_grid`:
    one `train_grid` a fold with every point, no per-point train; then
    each fold's grid models held to per-point trains on the fold's data."""
    with _Spy(algo_cls, "train_grid") as grid, _Spy(algo_cls, "train") as serial:
        inst, result = run_evaluation(storage, evaluation, eps)
    check(inst.status == "EVALCOMPLETED", f"{algo_cls.__name__} evaluation {inst.status}")
    check(len(grid.calls) == CLASSIFY_FOLDS and not serial.calls,
          f"{algo_cls.__name__}: {len(grid.calls)} train_grid calls and "
          f"{len(serial.calls)} trains for {CLASSIFY_FOLDS} folds")
    for _s, (_self, ctx, pd, params_list), models in grid.calls:
        check(len(models) == len(eps), "a train_grid call short of the grid")
        for p, m in zip(params_list, models):
            held(m.model, algo_cls(p).train(ctx, pd).model, p)
    return {"eval_wall_sec": float(inst.env["eval_wall_sec"]),
            "scores": [s.score for s in result.engine_params_scores],
            "best": result.best_index}


def _nb_held(got, want, p):
    for key in ("log_prior", "log_likelihood"):
        check(np.allclose(getattr(got, key), getattr(want, key), rtol=1e-5, atol=0),
              f"NB grid point {p}: {key} differs from its own train")


def _lr_held(got, want, p):
    _lr_close(got.weights, want.weights, f"LR grid point {p} against its own train")


def _ridge_held(got, want, p):
    check(np.allclose(got.weights, want.weights, rtol=1e-4, atol=0)
          and abs(got.intercept - want.intercept) <= 1e-3 * abs(want.intercept),
          f"ridge grid point {p} differs from its own train")


def _labels_near_ties(model, x):
    """Rows whose top-two scores (CPU) lie within 1e-4: their label may
    differ between devices."""
    s = np.sort(model.predict_scores(x), axis=-1)
    return s[:, -1] - s[:, -2] <= 1e-4


def _classify_store(out, x, y, xq):
    """(c) Covertype rows as `$set` events through `console import`, the
    three-algorithm variant trained and deployed, 500 queries, and the
    NB and LR grids through `pio eval`."""
    n = CLASSIFY_ENTITIES
    res = out["store_classify"] = {"entities": n}
    events = CLASSIFY_DIR / "covtype.jsonl"
    labels = [COVTYPE_LABELS[c] for c in y[:n]]
    _set_events(events, "cell", "c", COVTYPE_ATTRS, x[:n], "cover_type", labels)
    ds = {"app_name": "covtype", "entity_type": "cell", "attrs": list(COVTYPE_ATTRS),
          "label_attr": "cover_type"}
    engine_json = _engine_json("covtype", {
        "engineFactory":
        "predictionio_tpu_torch.engines.classification.ClassificationEngine",
        "datasource": {"params": ds},
        "algorithms": [{"name": "randomforest", "params": {}}, {"name": "logreg", "params": {}},
                       {"name": "naive", "params": {}}]}, CLASSIFY_DIR)
    res["import_s"], td = _import_and_train("covtype", events, engine_json,
                                            ClassificationDataSource)
    vocab = td.label_vocab
    check(np.array_equal(td.features, x[:n])
          and [vocab[c] for c in td.labels] == labels,
          "aggregate_properties differs from the imported $set events")
    storage = Storage()
    inst = _instance(storage, "covtype")
    res["stages"] = stage_timings(inst)
    blob = storage.get_model_data_models().get(inst.id).models
    models = deserialize_models(blob)
    check([type(m).__name__ for m in models] == ["RFModel", "LRModel", "NBModel"],
          f"MODELDATA holds {[type(m).__name__ for m in models]}")
    answers, _, before, after, res["serve"] = _deploy(
        engine_json, "deploy_covtype.log", [{"features": r} for r in xq.tolist()])
    check(before["engine_instance"] == inst.id, "deploy serves another instance")
    check(after["device"] == "cuda:0", f"deploy serves on {after['device']}")
    rf = models[0]
    rf.bind_device("cpu")
    want = [vocab[c] for c in rf.model.predict(xq)]
    for k, label in enumerate(want):
        check(answers[k][1] == {"label": label},
              f"query {k}: {answers[k][1]} != the forest's {label} on the CPU")
    queries = list(enumerate(ClassifyQuery(r) for r in xq.tolist()))
    ties = {}
    for i, algo in ((1, LogisticRegressionAlgorithm(LogisticRegressionParams())),
                    (2, NaiveBayesAlgorithm(NaiveBayesParams()))):
        card, cpu = deserialize_models(blob)[i], deserialize_models(blob)[i]
        card.bind_device("cuda:0")
        cpu.bind_device("cpu")
        near = _labels_near_ties(cpu.model, xq)
        got = [p.label for _, p in algo.batch_predict(None, card, queries)]
        wanted = [p.label for _, p in algo.batch_predict(None, cpu, queries)]
        check(all(g == w for g, w, t in zip(got, wanted, near) if not t),
              f"{type(algo).__name__}: batch_predict on the card differs from its CPU copy")
        ties[type(algo).__name__] = int(near.sum())
    res["near_ties"] = ties

    class CovtypeEval(Evaluation):
        engine = ClassificationEngine().apply()
        metric = Accuracy()

    dsp = ClassifyDataSourceParams(**{**ds, "attrs": tuple(COVTYPE_ATTRS)},
                                   eval_k=CLASSIFY_FOLDS)
    res["eval_nb"] = _grid_eval(storage, CovtypeEval(), [
        EngineParams(data_source_params=("", dsp),
                     algorithm_params_list=(("naive", NaiveBayesParams(lambda_=lam)),))
        for lam in NB_GRID], NaiveBayesAlgorithm, _nb_held)
    res["eval_lr"] = _grid_eval(storage, CovtypeEval(), [
        EngineParams(data_source_params=("", dsp), algorithm_params_list=((
            "logreg", LogisticRegressionParams(lr=lr, l2=l2)),))
        for lr, l2 in LR_GRID], LogisticRegressionAlgorithm, _lr_held)


def _regress_store(out, x, y, xq):
    """(c) YearPredictionMSD rows as `$set` events, ridge trained and
    deployed: 500 queries, half bare arrays, and 10 malformed; then the
    l2 grid through `pio eval`."""
    n = REGRESS_ENTITIES
    res = out["store_regress"] = {"entities": n}
    events = CLASSIFY_DIR / "year.jsonl"
    _set_events(events, "song", "s", YEAR_ATTRS, x[:n], "year", y[:n].tolist())
    ds = {"app_name": "year", "entity_type": "song", "attrs": list(YEAR_ATTRS),
          "target_attr": "year"}
    engine_json = _engine_json("year", {
        "engineFactory":
        "predictionio_tpu_torch.engines.regression.RegressionEngine",
        "datasource": {"params": ds},
        "algorithms": [{"name": "ridge", "params": {"l2": RIDGE_L2}}]}, CLASSIFY_DIR)
    res["import_s"], td = _import_and_train("year", events, engine_json, RegressionDataSource)
    check(np.array_equal(td.features, x[:n]) and np.array_equal(td.targets, y[:n]),
          "aggregate_properties differs from the imported $set events")
    storage = Storage()
    inst = _instance(storage, "year")
    res["stages"] = stage_timings(inst)
    [model] = deserialize_models(storage.get_model_data_models().get(inst.id).models)
    rows = xq.tolist()
    bodies = [r if k % 2 else {"features": r} for k, r in enumerate(rows)]
    malformed = [{"x": rows[0]}, "text", 7, None, [1.0, "a"] + rows[0][2:],
                 {"features": 3}, [1.0, None] + rows[0][2:], [rows[0]], rows[0][:-1], {}]
    answers, refused, before, _, res["serve"] = _deploy(
        engine_json, "deploy_year.log", bodies, malformed)
    check(before["engine_instance"] == inst.id, "deploy serves another instance")
    for body, (status, reply) in zip(malformed, refused):
        check(status == 400, f"malformed query {body!r:.60}: HTTP {status} {reply}")
    want = model.model.predict(xq)
    ulps = 0.0
    for k, w in enumerate(want):
        got = answers[k][1]
        check(isinstance(got, float), f"query {k}: {got!r} is not a bare number")
        ulps = max(ulps, abs(got - float(w)) / float(np.spacing(np.float32(w))))
    res["max_ulps_from_predict"] = ulps
    check(ulps <= 2, f"answers {ulps} ulp from the persisted model's predict")

    class YearEval(Evaluation):
        engine = RegressionEngine().apply()
        metric = MeanSquareError()

    dsp = RegressDataSourceParams(**{**ds, "attrs": tuple(YEAR_ATTRS)}, eval_k=CLASSIFY_FOLDS)
    res["eval_ridge"] = _grid_eval(storage, YearEval(), [
        EngineParams(data_source_params=("", dsp),
                     algorithm_params_list=(("ridge", RidgeParams(l2=l2)),))
        for l2 in RIDGE_GRID], RidgeAlgorithm, _ridge_held)


def phase_classify(report, shared):
    """The classification and regression templates: Covertype-shaped and
    YearPredictionMSD-shaped trains at full width on the card, then both
    templates through storage, deploy and `pio eval`."""
    t_phase = time.perf_counter()
    out = report["classify"] = {"nvidia_smi": report["nvidia_smi"]}
    t0 = time.perf_counter()
    x, y = _covtype(np.random.default_rng(CLASSIFY_SEED))
    xr, yr = _year_msd(np.random.default_rng(REGRESS_SEED))
    out["data_s"] = time.perf_counter() - t0
    _classify_trains(out, x, y)
    _regress_trains(out, xr, yr)
    shutil.rmtree(CLASSIFY_DIR, ignore_errors=True)
    (CLASSIFY_DIR / "store").mkdir(parents=True)
    rng = np.random.default_rng(CLASSIFY_SEED + 1)
    with _loop_storage(CLASSIFY_DIR / "store"):
        _classify_store(out, x, y, x[rng.choice(np.arange(int(0.9 * len(x)), len(x)),
                                                N_QUERIES, replace=False)])
        _regress_store(out, xr, yr, xr[YEAR_TRAIN + rng.choice(YEAR_ROWS - YEAR_TRAIN,
                                                               N_QUERIES, replace=False)])
    out["phase_s"] = time.perf_counter() - t_phase
    smi = report["nvidia_smi"]
    tr = out["trains"]
    for name in ("naive", "logreg", "randomforest"):
        r = tr[name]
        print(f"[classify] {smi} | Covertype-shaped {tr['train_rows']} rows, {name}: train "
              f"{r['host_s']:.3f} s ({r['card_s']:.3f} s by CUDA events), held-out accuracy "
              f"{r['accuracy']:.4f} (majority {tr['majority']:.4f})", flush=True)
    rg = out["ridge"]
    print(f"[classify] {smi} | YearPredictionMSD-shaped {rg['train_rows']} x "
          f"{len(YEAR_ATTRS)}, ridge: train {rg['host_s']:.3f} s ({rg['card_s']:.3f} s by "
          f"CUDA events), weights within {rg['weights_max_rel']:.2e} of float64, test RMSE "
          f"{rg['rmse']:.4f} (float64 {rg['rmse_f64']:.4f})", flush=True)
    for key in ("store_classify", "store_regress"):
        r = out[key]
        st, sv = r["stages"], r["serve"]
        print(f"[classify] {smi} | {key[6:]}: {r['entities']} entities, import "
              f"{r['import_s']:.2f} s, read {st['read']:.2f} s, train {st['train']:.2f} s, "
              f"persist {st['persist']:.4f} s; deploy to ready {sv['deploy_ready_s']:.2f} s; "
              f"{sv['queries']} queries from {N_CLIENTS} clients: p50 {sv['p50_ms']:.3f} ms, "
              f"p99 {sv['p99_ms']:.3f} ms, {sv['qps']:.1f} qps", flush=True)
    for key, name in (("store_classify", "eval_nb"), ("store_classify", "eval_lr"),
                      ("store_regress", "eval_ridge")):
        ev = out[key][name]
        print(f"[classify] {smi} | {name}: {CLASSIFY_FOLDS} folds x {len(ev['scores'])} "
              f"points, eval_wall_sec {ev['eval_wall_sec']:.3f}, scores "
              f"{[round(s, 5) for s in ev['scores']]}, best {ev['best']}", flush=True)
    print(f"[classify] {smi} | phase {out['phase_s']:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 26: observe
# ---------------------------------------------------------------------------

OBSERVE_QUERIES, OBSERVE_CLIENTS = 200, 8
OBSERVE_CAPTURE_S = 2.0
OBSERVE_OVERHEAD_CALLS = 200
OBSERVE_MAX_RATIO = 1.05
# the in-process device functions of the dense and windowed trains, the
# ALS and UR serves and the classify phase
OBSERVE_EXECUTABLES = (
    "als.train_dense", "ops.densify", "ops.dense_row_pass", "ops.dense_col_pass",
    "als.train_windowed", "ops.windowed_block_partials", "als.recommend_serving",
    "cco.topn", "cco.batch_score_topk", "classify.nb_train", "classify.lr_train",
    "forest.train", "linreg.normal_eq_terms",
)
_PROM_LINE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)$')


def _prometheus(text):
    """{(name, labels): value} of an exposition document; every line must
    be a comment or a sample."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _PROM_LINE.match(line)
        check(m is not None, f"/metrics line is not Prometheus text: {line!r}")
        out[(m.group(1), m.group(2) or "")] = float(m.group(3))
    return out


def _get(port, path, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("GET", path, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def _observe_load(port, stop, users, out):
    """One client's back-to-back queries until `stop` is set."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    n = 0
    try:
        while not stop.is_set():
            conn.request("POST", "/queries.json",
                         body=json.dumps({"user": users[n % len(users)], "num": 10}),
                         headers={"Content-Type": "application/json"})
            conn.getresponse().read()
            n += 1
    finally:
        conn.close()
        out.append(n)


def _observe_clients(port, bodies, out, lock):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        for n, rid, body in bodies:
            conn.request("POST", "/queries.json", body=json.dumps(body),
                         headers={"Content-Type": "application/json", "X-Request-ID": rid})
            resp = conn.getresponse()
            payload = json.loads(resp.read())
            with lock:
                out[n] = (resp.status, payload, resp.getheader("X-Request-ID"))
    finally:
        conn.close()


def _observe_report(report, smi):
    """(a): the in-process report against the checks above."""
    rep = devprof.report()
    rows = {r["name"]: r for r in rep["executables"]}
    check(rows, "the device profiler's report is empty after the card phases")
    kind = torch.cuda.get_device_name(0)
    check(rep["platform"]["device_kind"] == kind and rep["platform"]["peak_source"] == "table",
          f"the report's platform {rep['platform']} is not this card's table row")
    key = kind.lower()
    check(devprof.PEAK_TABLE.get(key) == (PEAK_OPS["bf16"], HBM_BPS)
          and devprof.PEAK_DTYPE_TABLE[key] == {"f32": PEAK_OPS["f32"],
                                                "int8": PEAK_OPS["int8"]},
          "devprof's peak row differs from the bounds' peaks")
    missing = [n for n in OBSERVE_EXECUTABLES if n not in rows]
    check(not missing, f"executables missing from the report: {missing}")
    out = {}
    for name, r in sorted(rows.items()):
        check(r["invocations"] > 0 and r["device_seconds"] > 0,
              f"{name}: {r['invocations']} calls, {r['device_seconds']} device s")
        check(r["timing_errors"] == 0, f"{name}: {r['timing_errors']} timing errors "
              f"({r.get('last_error')})")
        for ratio in ("mfu_raw", "hbm_fraction_of_roof_raw"):
            check(r.get(ratio, 0.0) <= OBSERVE_MAX_RATIO,
                  f"{name}: raw {ratio} {r.get(ratio)} > {OBSERVE_MAX_RATIO}: its work "
                  f"count is wrong")
        out[name] = {k: r.get(k) for k in (
            "invocations", "device_seconds", "flops_total", "bytes_total", "dtype",
            "mfu_raw", "hbm_fraction_of_roof_raw", "compile_seconds", "temp_bytes",
            "signatures")}
        print(f"[observe] {smi} | {name}: {r['invocations']} calls, "
              f"{r['device_seconds']:.4f} device s ({1e3 * r['device_seconds'] / r['invocations']:.4f}"
              f" ms a call), {r['flops_total']:.4g} flops, {r['bytes_total']:.4g} B, "
              f"{r.get('dtype', 'bf16')}, raw MFU {r.get('mfu_raw', 0.0):.4g}, raw memory "
              f"roof {r.get('hbm_fraction_of_roof_raw', 0.0):.4g}", flush=True)
    tr = report["train"]["devprof"]
    print(f"[observe] {smi} | phase 6's als.train_dense: {tr['flops']:.6g} flops = "
          f"{tr['flops_per_iteration']:.6g} (obs.costs, an iteration) x {TRAIN_ITERATIONS}",
          flush=True)
    pairs = [(f"dense {r['pass']} pass", r["profiled_ms"], r["devprof_ms"])
             for r in report["dense_times"]]
    pairs += [(f"block_partials {r['side']}", r["profiled_ms"], r["devprof_ms"])
              for r in report["windowed_times"] if "devprof_ms" in r]
    for what, median, mean in pairs:
        check(0.5 <= mean / median <= 2.0, f"{what}: devprof's mean {mean:.4f} ms a call "
              f"against the CUDA-event median {median:.4f} ms")
        print(f"[observe] {smi} | {what}: devprof mean {mean:.4f} ms a call, CUDA-event "
              f"median {median:.4f} ms (ratio {mean / median:.3f})", flush=True)
    return {"executables": out, "times_vs_devprof": pairs, "platform": rep["platform"],
            "padding": rep["padding"], "totals": rep["totals"]}


def _observe_overhead(model, smi):
    """Host ms a `recommend_serving` call at B = 1 and 64, profiler on and off."""
    sv = model.serving_state()
    rng = np.random.default_rng(SEED + 26)
    out = {}
    for b in (1, 64):
        rows = rng.integers(0, N_USERS, b)
        for flag in ("1", "0"):
            os.environ["PIO_DEVPROF"] = flag
            try:
                for _ in range(5):
                    als.recommend_serving(sv, rows, 64)
                t0 = time.perf_counter()
                for _ in range(OBSERVE_OVERHEAD_CALLS):
                    als.recommend_serving(sv, rows, 64)
                out[f"B={b} devprof={flag}"] = (
                    1e3 * (time.perf_counter() - t0) / OBSERVE_OVERHEAD_CALLS)
            finally:
                os.environ["PIO_DEVPROF"] = "1"
        print(f"[observe] {smi} | recommend_serving B={b} k=64, host ms a call over "
              f"{OBSERVE_OVERHEAD_CALLS}: profiler on {out[f'B={b} devprof=1']:.4f}, off "
              f"{out[f'B={b} devprof=0']:.4f} (wrapper "
              f"{out[f'B={b} devprof=1'] - out[f'B={b} devprof=0']:+.4f})", flush=True)
    return out


def phase_observe(report, shared):
    t_phase = time.perf_counter()
    smi = report["nvidia_smi"]
    ob = {"report": _observe_report(report, smi)}
    # (b) the card-busy share of each in-process phase so far
    ob["busy"] = report["busy"]
    for name, b in report["busy"].items():
        print(f"[observe] {smi} | phase {name}: {b['device_s']:.3f} card s (this process's "
              f"profiled calls on the card) of {b['wall_s']:.2f} s wall, busy {b['share']:.1%}",
              flush=True)

    # (c) a query server on phase 6's factors, in this process
    factors = shared["factors"]
    model = ALSModel(factors)
    recorder = get_default_recorder()
    sample_rate = recorder.sample_rate
    recorder.sample_rate = 1.0  # every query's trace is kept
    capture_dir = Path(__file__).resolve().parent / "build" / "observe_capture"
    shutil.rmtree(capture_dir, ignore_errors=True)
    os.environ["PIO_PROFILE_CAPTURE_DIR"] = str(capture_dir)
    server = QueryServer(ALSAlgorithm(ALSAlgorithmParams(rank=RANK)), model,
                         QueryServerConfig(ip="127.0.0.1", port=0))
    port = server.start()
    try:
        # the capture first, under load; the server opens and closes its
        # window on the dispatcher's thread, whose kernel records CUPTI
        # keeps (another thread's it drops for stretches of a long process)
        users = [f"u{int(u)}" for u in np.random.default_rng(SEED + 27).integers(0, N_USERS, 512)]
        stop, counts = threading.Event(), []
        load = [threading.Thread(target=_observe_load, args=(port, stop, users[c::4], counts))
                for c in range(4)]
        for t in load:
            t.start()
        time.sleep(0.2)
        status, body = _call(port, "POST", "/debug/profile/capture",
                             {"seconds": OBSERVE_CAPTURE_S})
        stop.set()
        for t in load:
            t.join(timeout=120)
        check(status == 200, f"profile capture: {status} {body}")
        check(body["thread"] == "query-batcher",
              f"the capture's window ran on {body['thread']}, not the dispatcher's thread")
        select = {n: c for n, c in body["kernels"].items() if "select_kernel" in n}
        check(body["device_events"] > 0 and select,
              f"the capture's trace holds {body['device_events']} device records, "
              f"select kernels {select}")
        ob["capture"] = {"trace": body["trace"], "device_events": body["device_events"],
                         "select_kernels": select, "load_queries": sum(counts),
                         "thread": body["thread"]}
        print(f"[observe] {smi} | {OBSERVE_CAPTURE_S:g} s torch.profiler capture on the "
              f"{body['thread']} thread under "
              f"{sum(counts)} queries from 4 clients: {body['device_events']} device "
              f"records, recommend_select's {select}", flush=True)

        # 200 queries with their own request ids
        rng = np.random.default_rng(SEED + 28)
        bodies = [(n, f"observe-{n:04d}", {"user": f"u{int(rng.integers(N_USERS))}",
                                           "num": int(rng.choice([5, 10, 20]))})
                  for n in range(OBSERVE_QUERIES)]
        _, text0 = _get(port, "/metrics")
        m0 = _prometheus(text0)
        st0, prof0 = _status(port), _exec_totals("als.recommend_serving")
        sel0 = rec.ROUTE_LAUNCHES["select"]
        out, lock = {}, threading.Lock()
        clients = [threading.Thread(target=_observe_clients,
                                    args=(port, bodies[c::OBSERVE_CLIENTS], out, lock))
                   for c in range(OBSERVE_CLIENTS)]
        t0 = time.perf_counter()
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        check(len(out) == OBSERVE_QUERIES and all(
            v[0] == 200 and v[2] == bodies[n][1] for n, v in out.items()),
            "a query failed or came back without its X-Request-ID")
        st1, prof1 = _status(port), _exec_totals("als.recommend_serving")
        batches = st1["batches"] - st0["batches"]
        selects = rec.ROUTE_LAUNCHES["select"] - sel0
        a0 = torch.cuda.memory_allocated()
        status, text1 = _get(port, "/metrics")
        a1 = torch.cuda.memory_allocated()
        m1 = _prometheus(text1)
        req_key = ("http_requests_total",
                   '{server="query",method="POST",path="/queries.json",status="200"}')
        served = m1.get(req_key, 0) - m0.get(req_key, 0)
        pad_key = ("batch_padding_ratio_count", "")
        pads = m1.get(pad_key, 0) - m0.get(pad_key, 0)
        gauge = m1.get(("cuda_memory_allocated_bytes", ""))
        check(status == 200 and served == OBSERVE_QUERIES,
              f"/metrics counts {served} of the {OBSERVE_QUERIES} queries")
        check(pads == batches, f"batch_padding_ratio counts {pads} batches, the server "
              f"{batches}")
        check(gauge is not None and min(a0, a1) <= gauge <= max(a0, a1),
              f"cuda_memory_allocated_bytes {gauge} outside [{a0}, {a1}]")
        status, text = _get(port, "/debug/profile")
        prof = json.loads(text)
        rs = next((r for r in prof["executables"] if r["name"] == "als.recommend_serving"), None)
        calls = prof1[0] - prof0[0]
        check(status == 200 and rs is not None and calls == batches == selects,
              f"/debug/profile: recommend_serving {calls} calls, {batches} device batches, "
              f"{selects} select launches")
        check(prof["platform"]["peak_source"] == "table"
              and prof["platform"]["device_kind"] == torch.cuda.get_device_name(0),
              f"/debug/profile platform {prof['platform']}")
        traced = {}
        for n in (0, OBSERVE_QUERIES // 2, OBSERVE_QUERIES - 1):
            rid = bodies[n][1]
            status, text = _get(port, f"/debug/traces?trace_id={rid}")
            check(status == 200, f"/debug/traces?trace_id={rid}: {status}")
            spans = json.loads(text)["spans"]
            names = [sp["name"] for sp in spans]
            dispatch = [sp for sp in spans if sp["name"] == "batch.device_dispatch"]
            check("server.request" in names and len(dispatch) == 1
                  and dispatch[0]["attrs"]["batch_size"] >= 1,
                  f"trace {rid} spans {names}")
            traced[rid] = names
        cpu_model, cpu_alg = ALSModel(factors, device="cpu"), ALSAlgorithm(
            ALSAlgorithmParams(rank=RANK))
        for n in range(0, OBSERVE_QUERIES, OBSERVE_QUERIES // 20):
            want = _to_jsonable(cpu_alg.predict(cpu_model, Query(**bodies[n][2])))
            check(out[n][1] == want, f"observe query {n} differs from the CPU plain version")
        lat = _exec_totals("als.recommend_serving")
        ob["server"] = {
            "queries": OBSERVE_QUERIES, "wall_s": wall, "qps": OBSERVE_QUERIES / wall,
            "batches": batches, "select_launches": selects, "metrics_requests": served,
            "padding_samples": pads, "allocated_gauge": gauge, "allocated": [a0, a1],
            "recommend_serving_device_ms": 1e3 * (prof1[1] - prof0[1]) / max(calls, 1),
            "traces": traced, "profile_calls_total": lat[0],
        }
        print(f"[observe] {smi} | {OBSERVE_QUERIES} queries from {OBSERVE_CLIENTS} clients "
              f"in {wall:.3f} s: {batches} device batches = {calls} profiled "
              f"recommend_serving calls = {selects} select launches "
              f"({ob['server']['recommend_serving_device_ms']:.4f} device ms a call); "
              f"/metrics: {served:g} requests, {pads:g} padding samples, allocated "
              f"{gauge:.0f} B (torch {a0}..{a1}); traces of {len(traced)} requests hold "
              f"server.request and their batch's device span", flush=True)
    finally:
        server.stop()
        recorder.sample_rate = sample_rate
        os.environ.pop("PIO_PROFILE_CAPTURE_DIR", None)
    check(server._thread is None, "server thread not joined")
    ob["overhead_ms"] = _observe_overhead(model, smi)
    ob["phase_s"] = time.perf_counter() - t_phase
    report["observe"] = ob
    print(f"[observe] {smi} | phase {ob['phase_s']:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 27: rollout
# ---------------------------------------------------------------------------

ROLLOUT_DIR = Path(__file__).resolve().parent / "build" / "rollout"
ROLLOUT_ENGINE = "ml20m-rollout"
ROLLOUT_FACTORY = "predictionio_tpu_torch.engines.recommendation.RecommendationEngine"
ROLLOUT_FEEDBACK_APP = "ml20m-feedback"
# the verdict knobs of every canary of the phase
ROLLOUT_KNOBS = {"window_s": 5.0, "interval_s": 0.25, "min_requests": 50, "bake_s": 4.0}
ROLLOUT_MODES = (("continuous", 4), ("continuous", 1), ("windowed", 1))
ROLLOUT_SHADOW_FRACTION = 0.5
ROLLOUT_FAULTED_FRACTION = 0.1
ROLLOUT_HEALTHY_FRACTION = 0.25
ROLLOUT_SHED, ROLLOUT_FEEDBACK = 100, 50
ROLLOUT_SHED_DEADLINE_MS, ROLLOUT_DELAY_S, ROLLOUT_SHED_BAR_S = 50, 0.2, 0.15
ROLLOUT_POLL_S = 0.05


def _rollout_persist(storage, factors):
    """A COMPLETED instance of the recommendation template at rank 10
    holding `factors`, persisted as ``run_train`` persists one
    (``make_serializable_models`` → ``serialize_models`` → the MODELDATA
    blob); no train runs."""
    engine = resolve_engine(RecommendationEngine)
    variant = {"id": ROLLOUT_ENGINE, "engineFactory": ROLLOUT_FACTORY,
               "datasource": {"params": {"app_name": ROLLOUT_ENGINE}},
               "algorithms": [{"name": "als", "params": {"rank": RANK}}]}
    ep = engine.params_from_variant_json(variant)

    def stage(pair):
        name, params = pair
        return json.dumps({"name": name, "params": json.loads(params_to_json(params))},
                          sort_keys=True)

    now = datetime.datetime.now(datetime.timezone.utc)
    inst = EngineInstance(
        id=str(uuid.uuid4()), status="COMPLETED", start_time=now, end_time=now,
        engine_id=ROLLOUT_ENGINE, engine_version="0", engine_variant=ROLLOUT_ENGINE,
        engine_factory=ROLLOUT_FACTORY, data_source_params=stage(ep.data_source_params),
        preparator_params=stage(ep.preparator_params),
        algorithms_params=json.dumps([{"name": n, "params": json.loads(params_to_json(p))}
                                      for n, p in ep.algorithm_params_list]),
        serving_params=stage(ep.serving_params))
    inst.id = storage.get_meta_data_engine_instances().insert(inst)
    ctx = RuntimeContext(storage=storage, device="cpu")
    persisted = engine.make_serializable_models(
        ctx, [ALSModel(factors, device="cpu")], ep, inst.id)
    storage.get_model_data_models().insert(Model(id=inst.id, models=serialize_models(persisted)))
    return inst


def _rollout_client(port, work, stop, out, lock):
    """Back-to-back POSTs of (n, body bytes) from `work`, cycling until
    `stop` is set (once through when it is None), on one keep-alive
    connection; out gets (n, status, parsed body, t sent, t answered)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        i = 0
        while True:
            if stop is None and i == len(work):
                break
            if stop is not None and stop.is_set():
                break
            n, body = work[i % len(work)]
            i += 1
            t0 = time.perf_counter()
            conn.request("POST", "/queries.json", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            payload = json.loads(resp.read())
            with lock:
                out.append((n, resp.status, payload, t0, time.perf_counter()))
    finally:
        conn.close()


def _rollout_load(port, bodies, stop=None):
    """N_CLIENTS clients over `bodies` (each body once when `stop` is
    None, else cycling until it is set); returns (results, the threads)."""
    out, lock = [], threading.Lock()
    work = list(enumerate(bodies))
    threads = [threading.Thread(target=_rollout_client,
                                args=(port, work[c::N_CLIENTS], stop, out, lock))
               for c in range(N_CLIENTS)]
    for t in threads:
        t.start()
    return out, threads


def _joined(threads):
    for t in threads:
        t.join(timeout=600)
    check(not any(t.is_alive() for t in threads), "rollout clients hung")


def _launch_counts():
    return rec.LAUNCHES, rec.ROUTE_LAUNCHES["select"]


class _Quiet:
    """Counts the launches of a block that runs with no client traffic
    (a runtime's build and its warmup ladder): they are no booked
    device batch of a server."""

    def __init__(self):
        self.launches = self.selects = 0

    @contextlib.contextmanager
    def block(self):
        a = _launch_counts()
        yield
        b = _launch_counts()
        self.launches += b[0] - a[0]
        self.selects += b[1] - a[1]


def _rollout_start(port, quiet, version, **knobs):
    """POST /rollout/start with no traffic; returns (status body, the
    monotonic time it returned)."""
    with quiet.block():
        status, body = _call(port, "POST", "/rollout/start",
                             {"version": version.id, **ROLLOUT_KNOBS, **knobs})
    check(status == 200 and body["state"] == "canary",
          f"rollout start of {version.id}: {status} {body}")
    return body, time.monotonic()


def _await_state(port, want, t_start, timeout=60.0):
    """Poll /rollout/status until its state is `want`; returns (status,
    seconds from the start to the poll that saw it)."""
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        status, st = _call(port, "GET", "/rollout/status")
        if st["state"] == want:
            return st, time.monotonic() - t_start
        check(st["state"] == "canary", f"rollout ended {st['state']}, not {want}: "
              f"{st.get('reason')}")
        time.sleep(ROLLOUT_POLL_S)
    raise PhaseError(f"rollout did not reach {want} within {timeout} s")


def _staged_bytes(model):
    sv = model.serving_state()
    return sum(t.numel() * t.element_size() for t in vars(sv).values()
               if isinstance(t, torch.Tensor))


def _lat(results):
    lat = sorted(r[4] - r[3] for r in results)
    return 1e3 * lat[len(lat) // 2], 1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))]


def phase_rollout(report, shared):
    t_phase, p_phase = time.perf_counter(), devprof.snapshot()
    smi = report["nvidia_smi"]
    shutil.rmtree(ROLLOUT_DIR, ignore_errors=True)
    (ROLLOUT_DIR / "store").mkdir(parents=True)
    a_f, b_f = shared["factors"], shared["plain_factors"]  # phase 6: kernels, plain passes
    rng = np.random.default_rng(SEED + 270)
    queries = _queries(rng, N_USERS)
    bodies = [json.dumps(q).encode() for q in queries]
    cpu_alg = ALSAlgorithm(ALSAlgorithmParams(rank=RANK))
    want = {}
    for name, f in (("a", a_f), ("b", b_f)):
        cpu_model = ALSModel(f, device="cpu")
        want[name] = [_to_jsonable(cpu_alg.predict(cpu_model, Query(**q))) for q in queries]
    ro = {"queries": len(queries), "clients": N_CLIENTS, "knobs": ROLLOUT_KNOBS}
    quiet, booked = _Quiet(), {}
    l0 = _launch_counts()
    saved_admin = os.environ.get("PIO_FAULTS_ADMIN")
    os.environ["PIO_FAULTS_ADMIN"] = "1"
    try:
        with _loop_storage(ROLLOUT_DIR / "store"):
            storage = Storage()
            registry = ModelRegistry(storage)
            t0 = time.perf_counter()
            inst = {n: _rollout_persist(storage, f)
                    for n, f in (("A", a_f), ("B", b_f), ("C", a_f), ("D", b_f))}
            ro["persist_s"] = time.perf_counter() - t0
            va, vb, vc = (registry.register(inst[n]) for n in "ABC")
            registry.promote(va.id)
            with quiet.block():
                t0 = time.perf_counter()
                runtime_a = build_runtime(storage, inst["A"])
                ro["build_s"] = time.perf_counter() - t0
            check(str(runtime_a.models[0].device).startswith("cuda"),
                  f"the live runtime is on {runtime_a.models[0].device}")
            ro["modes"] = _rollout_modes(runtime_a, storage, bodies, want["a"], booked, smi)
            del runtime_a
            with quiet.block():
                server = QueryServer(runtime=build_runtime(storage, inst["A"]),
                                     storage=storage,
                                     config=QueryServerConfig(ip="127.0.0.1", port=0))
                port = server.start()
            try:
                ro["shadow"] = _rollout_shadow(server, port, quiet, vc, bodies, want, smi)
                ro["faulted"] = _rollout_faulted(server, port, quiet, registry, vb, bodies,
                                                 want, smi)
                vd = registry.register(inst["D"])
                ro["healthy"] = _rollout_healthy(server, port, quiet, registry, vd, bodies,
                                                 want, smi)
                ve = registry.register(inst["C"])
                start, _ = _rollout_start(port, quiet, ve, bake_s=600.0,
                                          fraction=ROLLOUT_FAULTED_FRACTION)
            finally:
                booked["main"] = server.status()["batches"]
                server.stop()
            check(server._thread is None, "server thread not joined")
            del server
            ro["restart"], restarted = _rollout_restart(storage, inst["D"], quiet, ve,
                                                        start, registry, smi)
            try:
                port = restarted.port
                ro["shed"] = _rollout_shed(restarted, port, want["b"], queries, smi)
                ro["feedback"] = _rollout_feedback(storage, restarted, bodies, queries,
                                                   inst["D"], booked, smi)
            finally:
                booked["restarted"] = restarted.status()["batches"]
                restarted.stop()
    finally:
        if saved_admin is None:
            os.environ.pop("PIO_FAULTS_ADMIN", None)
        else:
            os.environ["PIO_FAULTS_ADMIN"] = saved_admin
        faults.clear()
    l1 = _launch_counts()
    launches = l1[0] - l0[0] - quiet.launches
    selects = l1[1] - l0[1] - quiet.selects
    batches = sum(booked.values())
    check(launches > 0 and launches == selects == batches,
          f"rollout: {launches} top-k launches, {selects} on the select route, outside "
          f"the builds' {quiet.launches}; the servers booked {batches} device batches "
          f"({booked})")
    ro["launches"] = launches
    ro["select_launches"] = selects
    ro["booked_batches"] = booked
    ro["build_launches"] = quiet.launches
    wall = time.perf_counter() - t_phase
    busy = devprof.snapshot().card_seconds - p_phase.card_seconds
    ro["phase_s"], ro["device_s"] = wall, busy
    report["rollout"] = ro
    print(f"[rollout] {smi} | {launches} top-k launches = {selects} select launches = "
          f"{batches} device batches booked by the servers (live, candidate and shadow; "
          f"{quiet.launches} more in the builds' warmups); phase {wall:.1f} s, "
          f"{busy:.3f} card s, busy {busy / wall:.1%}", flush=True)


def _drained(server, idle_s=0.2, timeout=30.0):
    """Wait until the server's dispatcher has had no group in flight and
    nothing queued for `idle_s` (the last shadow mirrors included)."""
    d, quiet_since = server.dispatcher, None
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        with d._active_cond:
            busy = d._active or not d._queue.empty()
        now = time.monotonic()
        if busy:
            quiet_since = None
        elif quiet_since is None:
            quiet_since = now
        elif now - quiet_since >= idle_s:
            return
        time.sleep(0.01)
    raise PhaseError("the dispatcher did not drain")


def _rollout_modes(runtime, storage, bodies, want, booked, smi):
    """(a): the same bodies under each batching mode, on one runtime."""
    out = {}
    for batching, depth in ROLLOUT_MODES:
        name = f"{batching}/{depth}"
        srv = QueryServer(runtime=runtime, storage=storage, config=QueryServerConfig(
            ip="127.0.0.1", port=0, batching=batching, pipeline_depth=depth))
        port = srv.start()
        try:
            a, prof0 = _launch_counts(), _exec_totals("als.recommend_serving")
            t0 = time.perf_counter()
            res, threads = _rollout_load(port, bodies)
            _joined(threads)
            wall = time.perf_counter() - t0
            b, prof1 = _launch_counts(), _exec_totals("als.recommend_serving")
            batches = srv.status()["batches"]
        finally:
            booked[name] = srv.status()["batches"]
            srv.stop()
        check(len(res) == len(bodies), f"{name}: {len(res)} of {len(bodies)} answered")
        for n, status, body, _, _ in res:
            check(status == 200 and body == want[n],
                  f"{name}: query {n} answered {status}, not the CPU plain version's")
        check(b[0] - a[0] == b[1] - a[1] == batches,
              f"{name}: {b[0] - a[0]} launches, {b[1] - a[1]} select, {batches} batches")
        calls = prof1[0] - prof0[0]
        p50, p99 = _lat(res)
        out[name] = {"p50_ms": p50, "p99_ms": p99, "qps": len(bodies) / wall,
                     "wall_s": wall, "batches": batches, "mean_batch": len(bodies) / batches,
                     "devprof_calls": calls,
                     "devprof_ms_per_batch": 1e3 * (prof1[1] - prof0[1]) / max(calls, 1)}
        o = out[name]
        print(f"[rollout] {smi} | (a) {name}: {len(bodies)} queries from {N_CLIENTS} "
              f"clients, all equal to the CPU plain version: p50 {p50:.3f} ms, p99 "
              f"{p99:.3f} ms, {o['qps']:.1f} qps, {batches} batches (mean "
              f"{o['mean_batch']:.2f}) = launches = select launches; devprof "
              f"{o['devprof_ms_per_batch']:.4f} device ms a batch over {calls} calls",
              flush=True)
    ratio = (out["continuous/4"]["devprof_ms_per_batch"]
             / out["continuous/1"]["devprof_ms_per_batch"])
    out["devprof_depth4_over_depth1"] = ratio
    print(f"[rollout] {smi} | (a) devprof device ms a batch, depth 4 over depth 1: "
          f"{ratio:.3f}", flush=True)
    return out


def _check_answers(results, fraction, bodies, live, cand, what, t_switch=None,
                   faulted=False):
    """Each answer against the plain answers of the runtime its body
    routes to: candidate-routed ones `cand`'s (None: none routes there,
    as in shadow mode), live-routed ones `live`'s; once `t_switch` passed
    (a promote seen), live-routed answers may only be `cand`'s. With
    `faulted`, a candidate-routed query may also answer the injected
    fault's 500 or, routed after the rollback detached the candidate,
    live's (one in flight across the detach keeps the runtime it was read
    against, and answers the candidate's)."""
    routed = {"live": 0, "candidate": 0, "injected": 0}
    for n, status, body, t_sent, _ in results:
        to_cand = cand is not None and sticky_candidate(bodies[n], fraction)
        if to_cand and faulted and status == 500:
            check("injected error fault" in body.get("message", ""),
                  f"{what}: query {n}: 500 {body}")
            routed["injected"] += 1
            continue
        check(status == 200, f"{what}: query {n} answered {status} {body}")
        if to_cand:
            check(body == cand[n] or (faulted and body == live[n]),
                  f"{what}: candidate-routed query {n} is not the candidate's plain answer")
            routed["candidate"] += 1
        elif t_switch is not None and t_sent > t_switch:
            check(body == cand[n], f"{what}: query {n} after the promote is not the "
                  "new live runtime's plain answer")
            routed["live"] += 1
        else:
            check(body == live[n] or (t_switch is not None and body == cand[n]),
                  f"{what}: live-routed query {n} is not the live runtime's plain answer")
            routed["live"] += 1
    return routed


def _rollout_shadow(server, port, quiet, vc, bodies, want, smi):
    """(b): a shadow canary of C (A's factors) agrees on every mirror and
    is promoted; every client answer is A's."""
    st0, t_start = _rollout_start(port, quiet, vc, shadow=True,
                                  fraction=ROLLOUT_SHADOW_FRACTION)
    check(str(server.candidate.models[0].device).startswith("cuda"),
          f"the candidate is on {server.candidate.models[0].device}")
    stop = threading.Event()
    res, threads = _rollout_load(port, bodies, stop)
    try:
        st, took = _await_state(port, "promoted", t_start)
    finally:
        stop.set()
        _joined(threads)
    _drained(server)
    _check_answers(res, ROLLOUT_SHADOW_FRACTION, bodies, want["a"], None, "(b) shadow")
    cand = st["candidate"]
    check(cand.get("shadow_count", 0) >= ROLLOUT_KNOBS["min_requests"]
          and cand.get("agreement") == 1.0,
          f"(b) shadow: agreement {cand.get('agreement')} over {cand.get('shadow_count')} "
          "mirrors")
    check(ModelRegistry(server.storage).get(vc.id).status == "live", "(b) C not live")
    p50, p99 = _lat(res)
    out = {"start_to_promote_s": took, "mirrors": cand["shadow_count"],
           "agreement": cand["agreement"], "answers": len(res), "p50_ms": p50,
           "p99_ms": p99, "reason": st["reason"]}
    print(f"[rollout] {smi} | (b) shadow canary of C at {ROLLOUT_SHADOW_FRACTION:g}: "
          f"agreement {cand['agreement']} over {cand['shadow_count']} mirrors, promoted "
          f"{took:.2f} s after the start ({st['reason']}); {len(res)} client answers all "
          f"200 and A's, p50 {p50:.3f} ms p99 {p99:.3f} ms", flush=True)
    return out


def _rollout_faulted(server, port, quiet, registry, vb, bodies, want, smi):
    """(c): B with dispatch.device@candidate failing: rolled back, live
    answers all 200 and the live factors' plain answers."""
    status, body = _call(port, "POST", "/debug/faults",
                         {"set": "dispatch.device@candidate:error:1.0"})
    check(status == 200 and body["faults"][0]["scope"] == "candidate",
          f"(c) POST /debug/faults: {status} {body}")
    st0, t_start = _rollout_start(port, quiet, vb, fraction=ROLLOUT_FAULTED_FRACTION)
    stop = threading.Event()
    res, threads = _rollout_load(port, bodies, stop)
    try:
        st, took = _await_state(port, "rolled_back", t_start)
        time.sleep(0.3)  # traffic across the detach
    finally:
        stop.set()
        _joined(threads)
    _drained(server)
    routed = _check_answers(res, ROLLOUT_FAULTED_FRACTION, bodies, want["a"], want["b"],
                            "(c) faulted", faulted=True)
    check(routed["injected"] >= ROLLOUT_KNOBS["min_requests"] and "error-rate" in st["reason"],
          f"(c) faulted: {routed} ({st['reason']})")
    check(registry.get(vb.id).status == "rolled_back",
          f"(c) B is {registry.get(vb.id).status}, not rolled_back")
    status, body = _call(port, "POST", "/debug/faults", {"clear": True})
    check(status == 200 and body["faults"] == [], f"(c) fault clear: {status} {body}")
    out = {"start_to_rollback_s": took, "reason": st["reason"], **routed,
           "candidate_window": st["candidate"]}
    print(f"[rollout] {smi} | (c) canary of B with dispatch.device@candidate:error:1.0 at "
          f"{ROLLOUT_FAULTED_FRACTION:g}: rolled back {took:.2f} s after the start "
          f"({st['reason']}); {routed['live']} live-routed answers all 200 and the live "
          f"factors', {routed['injected']} candidate-routed 500s, {routed['candidate']} "
          "candidate-routed 200s (in flight across the detach, or after it)", flush=True)
    return out


def _rollout_healthy(server, port, quiet, registry, vd, bodies, want, smi):
    """(d): B's factors as D at 0.25, promoted; memory back after it."""
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    staged = _staged_bytes(server.runtime.models[0])
    st0, t_start = _rollout_start(port, quiet, vd, fraction=ROLLOUT_HEALTHY_FRACTION)
    check(str(server.candidate.models[0].device).startswith("cuda"),
          f"the candidate is on {server.candidate.models[0].device}")
    stop = threading.Event()
    res, threads = _rollout_load(port, bodies, stop)
    try:
        st, took = _await_state(port, "promoted", t_start)
        t_seen = time.perf_counter()
        time.sleep(0.3)  # traffic across the swap
    finally:
        stop.set()
        _joined(threads)
    _drained(server)
    routed = _check_answers(res, ROLLOUT_HEALTHY_FRACTION, bodies, want["a"], want["b"],
                            "(d) healthy", t_switch=t_seen)
    check(registry.get(vd.id).status == "live", f"(d) D is {registry.get(vd.id).status}")
    check(server.runtime.instance.id == vd.instance_id and server.candidate is None,
          "(d) the server does not serve D")
    after_res, threads = _rollout_load(port, bodies[:100])
    _joined(threads)
    _drained(server)
    for n, status, body, _, _ in after_res:
        check(status == 200 and body == want["b"][n], f"(d) after the promote, query {n}")
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    check(after - before < staged / 2,
          f"(d) allocated {after} B after the promote, {before} B before the canary: "
          f"one runtime stages {staged} B, the old runtime leaked")
    out = {"start_to_promote_s": took, "reason": st["reason"], **routed,
           "allocated_before": before, "allocated_after": after, "staged_bytes": staged}
    print(f"[rollout] {smi} | (d) canary of D (B's factors) at {ROLLOUT_HEALTHY_FRACTION:g}: "
          f"promoted {took:.2f} s after the start ({st['reason']}); {routed['candidate']} "
          f"candidate-routed answers D's, {routed['live']} live-routed C's (D's after the "
          f"swap); cuda allocated {before} B before, {after} B after (a runtime stages "
          f"{staged} B)", flush=True)
    return out


def _rollout_restart(storage, inst_live, quiet, ve, start, registry, smi):
    """(e): the canary of E survives a restart, then console aborts it."""
    with quiet.block():
        t0 = time.perf_counter()
        srv = QueryServer(runtime=build_runtime(storage, inst_live), storage=storage,
                          config=QueryServerConfig(ip="127.0.0.1", port=0))
        port = srv.start()  # re-adopts the canary: builds E
        restart_s = time.perf_counter() - t0
    status, st = _call(port, "GET", "/rollout/status")
    check(st["state"] == "canary" and st["version"]["id"] == ve.id
          and st["started_wall"] == start["started_wall"],
          f"(e) after the restart: {st['state']} {st['version']['id']} started "
          f"{st.get('started_wall')}, not canary {ve.id} started {start['started_wall']}")
    check(str(srv.candidate.models[0].device).startswith("cuda"),
          f"the re-adopted candidate is on {srv.candidate.models[0].device}")
    rc, text = _console_out(["rollout", "abort", "--url", f"http://127.0.0.1:{port}"])
    check(rc == 0 and "[INFO] rollout state: aborted" in text, f"(e) console abort: {text}")
    check(registry.get(ve.id).status == "rolled_back" and srv.candidate is None,
          "(e) the abort left the candidate")
    out = {"restart_s": restart_s, "started_wall": st["started_wall"],
           "elapsed_at_restart_s": st["elapsed_s"]}
    print(f"[rollout] {smi} | (e) restart mid-canary: the new server re-adopted E in "
          f"canary, started_wall {st['started_wall']:.3f} as before ({st['elapsed_s']} s "
          f"into a 600 s bake), build + start {restart_s:.2f} s; console rollout abort: "
          "aborted", flush=True)
    return out, srv


def _rollout_shed(srv, port, want, queries, smi):
    """(f): expired deadlines shed before the device; a 50 ms budget
    under a 200 ms device delay is a 503 within 150 ms."""
    def shed_count():
        return _prometheus(_get(port, "/metrics")[1]).get(
            ("queries_shed_total", '{reason="deadline"}'), 0.0)

    c0, a = shed_count(), _launch_counts()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        for n in range(ROLLOUT_SHED):
            conn.request("POST", "/queries.json", body=json.dumps(queries[n]),
                         headers={"Content-Type": "application/json",
                                  "X-PIO-Deadline": "0"})
            resp = conn.getresponse()
            resp.read()
            check(resp.status == 503 and resp.getheader("Retry-After") == "1",
                  f"(f) deadline 0: {resp.status}")
    finally:
        conn.close()
    c1, b = shed_count(), _launch_counts()
    check(c1 - c0 == ROLLOUT_SHED and b == a,
          f"(f) shed counter +{c1 - c0}, launches {a} -> {b}")
    status, body = _call(port, "POST", "/debug/faults",
                         {"set": f"dispatch.device:delay:1.0:{ROLLOUT_DELAY_S}"})
    check(status == 200, f"(f) delay fault: {status} {body}")
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/queries.json", body=json.dumps(queries[0]),
                     headers={"Content-Type": "application/json",
                              "X-PIO-Deadline": str(ROLLOUT_SHED_DEADLINE_MS)})
        resp = conn.getresponse()
        resp.read()
        shed_s = time.perf_counter() - t0
        check(resp.status == 503 and shed_s <= ROLLOUT_SHED_BAR_S,
              f"(f) {ROLLOUT_SHED_DEADLINE_MS} ms deadline under a {ROLLOUT_DELAY_S} s delay: "
              f"{resp.status} after {shed_s:.3f} s")
        conn.request("POST", "/queries.json", body=json.dumps(queries[1]),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        check(resp.status == 200 and body == want[1], f"(f) the next query: {resp.status}")
    finally:
        conn.close()
    status, body = _call(port, "POST", "/debug/faults", {"clear": True})
    check(status == 200 and body["faults"] == [], "(f) fault clear")
    out = {"shed": ROLLOUT_SHED, "shed_latency_s": shed_s}
    print(f"[rollout] {smi} | (f) {ROLLOUT_SHED} queries with X-PIO-Deadline 0: 503 + "
          f"Retry-After each, queries_shed_total{{reason=\"deadline\"}} +{c1 - c0:g}, no "
          f"launch; a {ROLLOUT_SHED_DEADLINE_MS} ms deadline under a {ROLLOUT_DELAY_S:g} s "
          f"dispatch.device delay: 503 in {1e3 * shed_s:.1f} ms; the next query 200",
          flush=True)
    return out


def _rollout_feedback(storage, live, bodies, queries, inst_live, booked, smi):
    """(g): feedback events in the port's Event Server over the same
    storage; an expired event POST is shed and stores nothing."""
    app_id = storage.get_meta_data_apps().insert(App(id=0, name=ROLLOUT_FEEDBACK_APP))
    storage.get_events().init_app(app_id)
    key = storage.get_meta_data_access_keys().insert(AccessKey(key="", app_id=app_id))
    es = EventServer(storage, EventServerConfig(ip="127.0.0.1", port=0, wal_dir=None))
    es_port = es.start()
    try:
        fb = QueryServer(runtime=live.runtime, storage=storage, config=QueryServerConfig(
            ip="127.0.0.1", port=0, feedback=True,
            event_server_url=f"http://127.0.0.1:{es_port}", access_key=key))
        port = fb.start()
        try:
            res, threads = _rollout_load(port, bodies[:ROLLOUT_FEEDBACK])
            _joined(threads)
        finally:
            booked["feedback"] = fb.status()["batches"]
            fb.stop()  # joins the feedback POSTs
        events = list(storage.get_events().find(EventQuery(app_id=app_id)))
        conn = http.client.HTTPConnection("127.0.0.1", es_port, timeout=60)
        try:
            conn.request("POST", f"/events.json?accessKey={key}", body=json.dumps(
                {"event": "view", "entityType": "user", "entityId": "u1"}),
                headers={"Content-Type": "application/json", "X-PIO-Deadline": "0"})
            resp = conn.getresponse()
            resp.read()
            shed = resp.status
        finally:
            conn.close()
        after = list(storage.get_events().find(EventQuery(app_id=app_id)))
    finally:
        es.stop()
    got = sorted(json.dumps([e.event, e.entity_type, e.entity_id, e.pr_id, e.properties],
                            sort_keys=True) for e in events)
    wanted = sorted(json.dumps(["predict", "pio_pr", inst_live.id, inst_live.id,
                                {"query": queries[n], "prediction": body}], sort_keys=True)
                    for n, status, body, _, _ in res if status == 200)
    check(len(res) == ROLLOUT_FEEDBACK and len(wanted) == ROLLOUT_FEEDBACK and got == wanted,
          f"(g) {len(events)} feedback events for {len(res)} answers")
    check(shed == 503 and len(after) == len(events),
          f"(g) the expired event POST: {shed}, {len(after) - len(events)} rows")
    print(f"[rollout] {smi} | (g) {ROLLOUT_FEEDBACK} queries with feedback: "
          f"{len(events)} predict events of pio_pr in the Event Server, each with its "
          f"query and answer; an event POST with X-PIO-Deadline 0: {shed}, no row",
          flush=True)
    return {"events": len(events), "shed_status": shed}

MONITOR_DIR = Path(__file__).resolve().parent / "build" / "monitor"
MONITOR_ENGINE = "ml20m-monitor"
MONITOR_TICK_S, MONITOR_SCRAPE_S = 0.25, 0.5  # sampler and SLO engine; fleet scrape
MONITOR_CHECKED = 20  # quiet answers held to the CPU plain version's
MONITOR_ALERT_CLIENTS = 8
MONITOR_RATE_S = 5.0  # the window of the device-seconds rate read during (b)
MONITOR_FAULT = "dispatch.device:delay:1.0:0.4"  # every device batch 400 ms late
# the latency SLO of the query server (0.25 s is a request-histogram edge)
MONITOR_SLO = {"name": "query_p250", "kind": "latency", "objective": 0.99,
               "threshold_ms": 250.0, "fast_window_s": 2.0, "window_s": 6.0,
               "burn_threshold": 2.0, "for_s": 0.5, "resolve_s": 1.0}
# the dashboard's SLO on the Event Server's scrape target
MONITOR_EVENT_SLO = {"name": "event_up", "kind": "up", "instance": "event",
                     "objective": 0.9, "fast_window_s": 1.0, "window_s": 2.0,
                     "burn_threshold": 2.0}
# an alert notification's keys in the JAX package (obs/monitor/slo.py
# AlertStatus.to_dict, plus the transition); the evidence keys are optional
NOTIFY_KEYS = frozenset({"slo", "state", "since", "fast_burn", "slow_burn", "fast_samples",
                         "burn_threshold", "error_budget", "transitions", "last_eval",
                         "pairs", "spec", "transition"})
NOTIFY_EVIDENCE = frozenset({"exemplars", "fleet_traces"})
# the exec alert sink: appends the alert JSON it reads on stdin to a file
MONITOR_SINK = "import sys; open(sys.argv[1], 'a').write(sys.stdin.read() + '\\n')"
# the dashboard child's durable tier: a WAL flush every tick, a segment
# sealed into a raw block every 2 s, a checkpoint every 2,000 points; its
# own compactor idle for the phase (the compaction runs on a copy here)
MONITOR_TSDB_ENV = {"PIO_TSDB_FLUSH_S": "0.25", "PIO_TSDB_SEAL_AGE_S": "2",
                    "PIO_TSDB_CKPT_POINTS": "2000", "PIO_TSDB_COMPACT_S": "3600"}
MONITOR_QUERY_200 = {"instance": "query", "path": "/queries.json", "status": "200"}


def _wait_for(pred, timeout, what, poll=0.05):
    """Poll `pred()` until it returns a truthy value; returns (value,
    seconds waited)."""
    t0 = time.monotonic()
    while True:
        got = pred()
        if got:
            return got, time.monotonic() - t0
        if time.monotonic() - t0 > timeout:
            raise PhaseError(f"{what}: not within {timeout} s")
        time.sleep(poll)


def _tsdb(port, **qs):
    from urllib.parse import urlencode

    status, body = _call(port, "GET", "/debug/tsdb?" + urlencode(qs))
    check(status == 200 and body.get("enabled"), f"/debug/tsdb?{qs}: {status} {body}")
    return body


def _latest(port, name, labels=""):
    """The newest (t, value) across the series of `name` matching `labels`
    (k:v,...) in a server's TSDB, None without one."""
    rows = _tsdb(port, name=name, labels=labels)["series"] if labels else _tsdb(
        port, name=name)["series"]
    pts = [tuple(p) for r in rows for p in r["points"][-1:]]
    return max(pts) if pts else None


def _monitor_clients(port, bodies, n_clients, stop=None):
    out, lock = [], threading.Lock()
    work = list(enumerate(bodies))
    threads = [threading.Thread(target=_rollout_client,
                                args=(port, work[c::n_clients], stop, out, lock))
               for c in range(n_clients)]
    for t in threads:
        t.start()
    return out, threads


def _monitor_seed(storage):
    """What the admin server lists: a live and a trained version, a
    queued train job, an online consumer's cursor record."""
    now = datetime.datetime.now(datetime.timezone.utc)
    registry, versions = ModelRegistry(storage), []
    for _ in range(2):
        inst = EngineInstance(
            id=str(uuid.uuid4()), status="COMPLETED", start_time=now, end_time=now,
            engine_id=MONITOR_ENGINE, engine_version="0", engine_variant=MONITOR_ENGINE,
            engine_factory=ROLLOUT_FACTORY,
            algorithms_params=json.dumps([{"name": "als", "params": {"rank": RANK}}]))
        inst.id = storage.get_meta_data_engine_instances().insert(inst)
        versions.append(registry.register(inst))
    registry.promote(versions[0].id)
    job = JobQueue(storage).submit({"id": MONITOR_ENGINE, "engineFactory": ROLLOUT_FACTORY,
                                    "datasource": {"params": {"app_name": MONITOR_ENGINE}}})
    LifecycleRecordStore(storage).append(CURSOR_ENTITY, "server:monitor", {
        "cursor": {"0": 500}, "events_consumed": 500, "events_folded": 480,
        "users_folded": 120, "items_folded": 3, "ticks": 40, "app_id": 1})
    return versions, job


def phase_monitor(report, shared):
    t_phase, p_phase = time.perf_counter(), devprof.snapshot()
    smi = report["nvidia_smi"]
    shutil.rmtree(MONITOR_DIR, ignore_errors=True)
    (MONITOR_DIR / "store").mkdir(parents=True)
    factors = shared["factors"]  # phase 6: ML-20M width
    rng = np.random.default_rng(SEED + 280)
    queries = _queries(rng, N_USERS)
    bodies = [json.dumps(q).encode() for q in queries]
    cpu_alg = ALSAlgorithm(ALSAlgorithmParams(rank=RANK))
    cpu_model = ALSModel(factors, device="cpu")
    want = [_to_jsonable(cpu_alg.predict(cpu_model, Query(**q)))
            for q in queries[:MONITOR_CHECKED]]
    mon = get_monitor()
    saved = (mon.sampler_interval_s, mon.slo_interval_s, list(mon._slos), mon.notifier)
    sink = MONITOR_DIR / "alerts.jsonl"
    mo: dict = {"tick_s": MONITOR_TICK_S, "scrape_s": MONITOR_SCRAPE_S, "slo": MONITOR_SLO,
                "event_slo": MONITOR_EVENT_SLO, "fault": MONITOR_FAULT}
    quiet, l0 = _Quiet(), _launch_counts()
    saved_admin = os.environ.get("PIO_FAULTS_ADMIN")
    os.environ["PIO_FAULTS_ADMIN"] = "1"
    servers, dash, booked = [], None, 0
    try:
        # (a) the servers, the monitor's settings and the dashboard child
        mon.sampler_interval_s = mon.slo_interval_s = MONITOR_TICK_S
        mon.notifier = AlertNotifier(exec_cmd=" ".join(
            shlex.quote(a) for a in (sys.executable, "-c", MONITOR_SINK, str(sink))))
        with _loop_storage(MONITOR_DIR / "store"):
            storage = Storage()
            seeded = _monitor_seed(storage)
            with quiet.block():
                model = ALSModel(factors)
                qsrv = QueryServer(ALSAlgorithm(ALSAlgorithmParams(rank=RANK)), model,
                                   QueryServerConfig(ip="127.0.0.1", port=0))
                qport = qsrv.start()
            servers.append(qsrv)
            check(str(model.device).startswith("cuda"), f"the model is on {model.device}")
            esrv = EventServer(storage, EventServerConfig(ip="127.0.0.1", port=0, wal_dir=None))
            eport = esrv.start()
            servers.append(esrv)
            asrv = AdminServer(storage, ip="127.0.0.1", port=0)
            aport = asrv.start()
            servers.append(asrv)
            check(mon.attached_count == 3,
                  f"the monitor has {mon.attached_count} servers attached, not 3")
            mon.set_slos([SLOSpec.from_dict(MONITOR_SLO)])
            check(mon.engine is not None and mon.engine.interval_s == MONITOR_TICK_S
                  and mon._sampler.interval_s == MONITOR_TICK_S,
                  "the monitor's sampler and SLO engine do not run at the phase's tick")
            root = Path(__file__).resolve().parent
            env = dict(os.environ, PIO_TRACE_COLLECT="1",
                       PIO_TSDB_DIR=str(MONITOR_DIR / "tsdb"), **MONITOR_TSDB_ENV,
                       PIO_MONITOR_TARGETS=",".join(
                           f"{n}=http://127.0.0.1:{p}" for n, p in
                           (("query", qport), ("event", eport), ("admin", aport))),
                       PIO_SCRAPE_INTERVAL_S=str(MONITOR_SCRAPE_S),
                       PIO_SLOS=json.dumps([MONITOR_EVENT_SLO]),
                       PIO_SLO_INTERVAL_S=str(MONITOR_TICK_S),
                       PIO_TSDB_INTERVAL_S=str(MONITOR_TICK_S),
                       PYTHONPATH=os.pathsep.join(
                           [str(root)] + ([os.environ["PYTHONPATH"]]
                                          if os.environ.get("PYTHONPATH") else [])))
            t0, t_dash = time.perf_counter(), time.time()
            dash = _Console(["dashboard", "--ip", "127.0.0.1", "--port", "0"],
                            MONITOR_DIR / "dashboard.log", env=env)
            dport = dash.port(timeout=60)
            mo["dashboard_start_s"] = time.perf_counter() - t0
            print(f"[monitor] {smi} | (a) query server, Event Server and admin server in "
                  f"this process, {mon.attached_count} attached to the monitor (sampler and "
                  f"SLO engine every {MONITOR_TICK_S} s); dashboard child serving in "
                  f"{mo['dashboard_start_s']:.2f} s, scraping the three every "
                  f"{MONITOR_SCRAPE_S} s", flush=True)
            mo["quiet"] = _monitor_quiet(qport, queries, bodies, want, smi)
            dash, dport, mo["restart"] = _monitor_restart(dash, dport, env, smi)
            mo["alert"] = _monitor_alert(qport, bodies, sink, smi)
            mo["traces"] = _monitor_traces(dport, mo["alert"]["trace_id"], smi)
            mo["fleet"] = _monitor_fleet(dport, esrv, smi)
            mo["admin"] = _monitor_admin(aport, qport, seeded, smi)
            mo["durable"] = _monitor_durable(dport, qport, t_dash, mo["quiet"]["t_one"], smi)
            booked = qsrv.status()["batches"]
    finally:
        if saved_admin is None:
            os.environ.pop("PIO_FAULTS_ADMIN", None)
        else:
            os.environ["PIO_FAULTS_ADMIN"] = saved_admin
        faults.clear()
        for srv in servers:
            srv.stop()
        rc = None
        if dash is not None:
            try:
                rc = dash.interrupt()
            finally:
                dash.__exit__(None, None, None)
        mon.sampler_interval_s, mon.slo_interval_s = saved[0], saved[1]
        mon.set_slos(saved[2])
        mon.notifier = saved[3]
    # (g) every launch of the phase is a device batch the server booked
    l1 = _launch_counts()
    launches = l1[0] - l0[0] - quiet.launches
    selects = l1[1] - l0[1] - quiet.selects
    check(launches > 0 and launches == selects == booked,
          f"monitor: {launches} top-k launches, {selects} on the select route, outside the "
          f"build's {quiet.launches}; the query server booked {booked} device batches")
    mo.update(launches=launches, select_launches=selects, booked_batches=booked,
              build_launches=quiet.launches)
    print(f"[monitor] {smi} | (g) {launches} top-k launches = {selects} select launches = "
          f"{booked} device batches booked by the query server ({quiet.launches} more in "
          "the build's warmup)", flush=True)
    # (h) the clean shutdown
    check(rc == 0, f"the dashboard child exited with {rc}")
    mo["compacted"] = _monitor_compact(mo["durable"], smi)
    left = sorted(t.name for t in threading.enumerate() if t.name in MONITOR_THREAD_NAMES)
    check(not left and mon.attached_count == 0,
          f"after every server stopped: monitor threads {left}, "
          f"{mon.attached_count} servers attached")
    wall = time.perf_counter() - t_phase
    busy = devprof.snapshot().card_seconds - p_phase.card_seconds
    mo["phase_s"], mo["device_s"] = wall, busy
    report["monitor"] = mo
    print(f"[monitor] {smi} | (h) every server stopped, the dashboard child exited 0, no "
          f"{'/'.join(MONITOR_THREAD_NAMES)} thread left; phase {wall:.1f} s, {busy:.3f} card s, "
          f"busy {busy / wall:.1%}", flush=True)


def _own_count(port, name="http_requests_total", match=None):
    """A server's own counter, summed over the children of `name` whose
    labels hold `match`, from its /metrics text."""
    want = {k: v for k, v in (match or {}).items() if k != "instance"}
    return sum(value for fam_name, labels, value in
               parse_prometheus_text(_get(port, "/metrics")[1])
               if fam_name == name and all(labels.get(k) == v for k, v in want.items()))


def _monitor_restart(dash, dport, env, smi):
    """After (b): the dashboard child SIGKILLed and started again on the
    same durable directory and targets; it replays its history."""
    before = _tsdb(dport, name="http_requests_total",
                   labels=",".join(f"{k}:{v}" for k, v in MONITOR_QUERY_200.items()))
    check(before["series"] and before["series"][0]["points"],
          "the dashboard scraped no 200s of the query server before the restart")
    t_kill = time.time()
    dash.proc.kill()
    dash.proc.wait(timeout=30)
    dash.__exit__(None, None, None)
    t0 = time.perf_counter()
    dash = _Console(["dashboard", "--ip", "127.0.0.1", "--port", "0"],
                    MONITOR_DIR / "dashboard_restarted.log", env=env)
    try:
        dport = dash.port(timeout=60)
        start_s = time.perf_counter() - t0
        durable = _tsdb(dport)["durable"]
        check(durable["replayed_points"] > 0 and durable["replayed_series"] > 0,
              f"the restarted dashboard replayed {durable['replayed_points']} points")
        kept = _tsdb(dport, name="http_requests_total", labels=",".join(
            f"{k}:{v}" for k, v in MONITOR_QUERY_200.items()))["series"]
        check(kept and kept[0]["points"] and kept[0]["points"][0][0] < t_kill,
              "the restarted dashboard has no query 200s from before the kill")
    except BaseException:
        dash.__exit__(None, None, None)  # the phase's own stop no longer reaches it
        raise
    out = {"restart_s": start_s, "replayed_points": durable["replayed_points"],
           "replayed_series": durable["replayed_series"],
           "ckpt_seeded_points": durable["ckpt_seeded_points"],
           "raw_blocks_at_restart": durable["tiers"]["raw"]["blocks"],
           "wal_segments_at_restart": durable["wal"]["segments"]}
    print(f"[monitor] {smi} | the dashboard child SIGKILLed after (b) and started again on "
          f"its durable directory in {start_s:.2f} s: replayed {out['replayed_points']} "
          f"points of {out['replayed_series']} series ({out['ckpt_seeded_points']} from "
          f"its checkpoint; {out['raw_blocks_at_restart']} raw blocks, "
          f"{out['wal_segments_at_restart']} WAL segments)", flush=True)
    return dash, dport, out


def _monitor_durable(dport, qport, t_dash, t_one, smi):
    """The dashboard's history across the restart: its increase of the
    query server's /queries.json 200s over the whole phase equals the
    query server's own count less the series' first scraped value (the
    warm query's 1, (b)), and the query server's own TSDB's increase from
    that point on; devprof_device_seconds_total{instance="query"} never
    falls; sealed raw blocks; console tsdb and the durable panel list the
    tiers."""
    labels = ",".join(f"{k}:{v}" for k, v in MONITOR_QUERY_200.items())
    own = _own_count(qport, match=MONITOR_QUERY_200)

    def caught_up():
        pt = _latest(dport, "http_requests_total", labels)
        return pt if pt and pt[1] == own else None

    _wait_for(caught_up, 10, "the dashboard's scrape of the query server's last 200")
    window = time.time() - t_dash + 1.0
    series = _tsdb(dport, name="http_requests_total", labels=labels,
                   window_s=str(window))["series"]
    check(len(series) == 1, f"{len(series)} query 200 series on the dashboard")
    first = series[0]["points"][0][1]
    inc = _tsdb(dport, name="http_requests_total", labels=labels, agg="increase",
                window_s=str(window))["value"]
    own_inc = _tsdb(qport, name="http_requests_total",
                    labels="server:query,path:/queries.json,status:200", agg="increase",
                    window_s=str(time.time() - t_one - MONITOR_TICK_S / 5))["value"]
    check(first == 1.0 and inc == own - first == own_inc,
          f"the dashboard's increase of query 200s over the phase {inc}, the query server's "
          f"own count {own} less the first scraped value {first}, its own TSDB's {own_inc}")
    dev = _tsdb(dport, name="devprof_device_seconds_total", labels="instance:query",
                window_s=str(window))["series"]
    pts = dev[0]["points"] if len(dev) == 1 else []
    falls = [(a, b) for a, b in zip(pts, pts[1:]) if b[1] < a[1]]
    check(len(pts) > 2 and not falls,
          f"devprof_device_seconds_total{{instance=query}}: {len(pts)} points, falls {falls[:3]}")
    durable = _tsdb(dport)["durable"]
    tiers = durable["tiers"]
    check(tiers["raw"]["blocks"] >= 1, f"no sealed raw block: {tiers}")

    def blocks_now():
        return {t: st["blocks"] for t, st in _tsdb(dport)["durable"]["tiers"].items()}

    def listed_alike(listed, before, after):
        # the child seals a raw block every 2 s meanwhile: each count
        # lies between the dashboard's reads just before and just after
        return (set(listed) == set(before) == set(after)
                and all(before[t] <= int(listed[t]) <= after[t] for t in before))

    before = blocks_now()
    buf = io.StringIO()  # the listing of every series is long: echo the tiers only
    with contextlib.redirect_stdout(buf):
        rc = console.main(["tsdb", "query", "--url", f"http://127.0.0.1:{dport}"])
    after = blocks_now()
    text = buf.getvalue()
    print("".join(line for line in text.splitlines(keepends=True)
                  if "durable tier at" in line or "   tier " in line), end="", flush=True)
    listed = dict(re.findall(r"\[INFO\]   tier (\w+): (\d+) block", text))
    check(rc == 0 and "durable tier at" in text and listed_alike(listed, before, after),
          f"console tsdb listed the tiers {listed}, the dashboard {before} then {after}")
    before = blocks_now()
    status, page = _get(dport, "/")
    after = blocks_now()
    panel = page[page.find("<h2>Durable tiers</h2>"):page.find("</table>",
                                                               page.find("<h2>Durable tiers</h2>"))]
    shown = dict(re.findall(r"<tr><td>(\w+)</td><td>(\d+)</td>", panel))
    check(status == 200 and "<h2>Durable tiers</h2>" in page
          and listed_alike(shown, before, after),
          f"the dashboard's durable panel lists {shown}, /debug/tsdb {before} then {after}")
    out = {"dir": durable["dir"], "window_s": window, "increase_200": inc, "own_count": own,
           "first_scraped": first, "own_tsdb_increase": own_inc,
           "device_seconds_points": len(pts), "tiers": tiers, "wal": durable["wal"],
           "labels": dict(MONITOR_QUERY_200)}
    print(f"[monitor] {smi} | durable: over the whole phase ({window:.1f} s, across the "
          f"restart) the dashboard's increase of the query server's /queries.json 200s "
          f"{inc:g} = its own count {own:g} less the first scraped {first:g} = its own TSDB's "
          f"{own_inc:g}; devprof_device_seconds_total{{instance=\"query\"}} never fell over "
          f"{len(pts)} points; tiers {{{', '.join(f'{t}: {st['blocks']} blocks' for t, st in tiers.items())}}}"
          f", listed alike by console tsdb and the durable panel", flush=True)
    return out


def _monitor_compact(durable, smi):
    """The dashboard's directory, copied once its child stopped: its WAL
    sealed into raw blocks, then `Compactor.run_once` with `now` past the
    phase writes the 5m tier, whose increase of the query 200s and of the
    device seconds over the buckets it spans equals the raw tier's."""
    copy = MONITOR_DIR / "tsdb_copy"
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(durable["dir"], copy)
    db = DurableTSDB(str(copy), flush_interval_s=9999.0, seal_age_s=9999.0, ckpt_points=0)
    try:
        db.flush_once(seal=True)
        t_end = time.time()
        t0 = time.perf_counter()
        res = Compactor(db, interval_s=9999.0, grace_s=0.0).run_once(now=t_end + 600.0)
        compact_s = time.perf_counter() - t0
        st = {t: db.tiers[t].stats() for t in ("raw", "5m", "1h")}
        check(res["buckets"] > 0 and st["5m"]["blocks"] >= 1,
              f"the compaction wrote {res} ({st['5m']['blocks']} 5m blocks)")
        bucket = TIER_BUCKETS["5m"]
        rows = {}
        for name, match in (("http_requests_total", durable["labels"]),
                            ("devprof_device_seconds_total", {"instance": "query"})):
            [s] = db.matching(name, match)
            key = (s.name, s.labels)
            lo = math.floor(st["raw"]["min_t"] / bucket) * bucket
            hi = (math.floor(st["raw"]["max_t"] / bucket) + 1) * bucket
            raw, _ = db._disk_increase(key, lo, hi, hi - lo, tier="raw")
            five, _ = db._disk_increase(key, lo, hi, hi - lo, tier="5m")
            # the request counter's integer steps sum exactly; the device
            # seconds' float steps sum bucket by bucket in another order
            same = (five == raw if name == "http_requests_total"
                    else math.isclose(five, raw, rel_tol=1e-12))
            check(same and raw > 0, f"{name}: the 5m tier's increase {five} != the raw "
                                    f"tier's {raw} over [{lo}, {hi})")
            rows[name] = {"raw": raw, "5m": five, "buckets": int((hi - lo) // bucket)}
        check(rows["http_requests_total"]["raw"] == durable["increase_200"],
              f"the copy's raw increase {rows['http_requests_total']['raw']} != the "
              f"dashboard's {durable['increase_200']}")
    finally:
        db.stop()
    out = {"now": t_end + 600.0, "buckets": res["buckets"], "tiers": st, "increase": rows,
           "compact_s": compact_s}
    print(f"[monitor] {smi} | compaction of a copy of the dashboard's directory, now pinned "
          f"10 min past the phase: {res['buckets']} 5m/1h buckets in {compact_s:.3f} s; over "
          f"the {rows['http_requests_total']['buckets']} 5m bucket(s) it spans the 5m tier's "
          f"increase equals the raw tier's: query 200s {rows['http_requests_total']['5m']:g}, "
          f"device seconds {rows['devprof_device_seconds_total']['5m']:.6f}", flush=True)
    return out


RATE_EXPR = f"rate(devprof_device_seconds_total[{MONITOR_RATE_S:g}s])"


@contextlib.contextmanager
def _sampler_ticks(sampler, ticks):
    """Record (point time, devprof device seconds just before the
    sampler's read, just after) at every sampler tick while the block
    runs: devprof's own counter at the TSDB's point times."""
    orig = sampler.sample_once

    def sample_once(now=None):
        now = time.time() if now is None else now
        before = devprof.snapshot().device_seconds
        written = orig(now=now)
        ticks.append((now, before, devprof.snapshot().device_seconds))
        return written

    sampler.sample_once = sample_once
    try:
        yield ticks
    finally:
        del sampler.sample_once  # the class's method again


def _window_rate(points, now, drop):
    """The TSDB's rate over MONITOR_RATE_S at `now` (tsdb.series_increase
    over the window, from the last point before it, divided by the
    window) on the points a reader at `now` sees: those at or before it,
    less the `drop` newest (a tick stamped but not yet written); with
    the two points it spans."""
    vis = [p for p in points if p[0] <= now]
    vis = vis[:len(vis) - drop]
    inwin = [p for p in vis if p[0] >= now - MONITOR_RATE_S]
    if not inwin:
        return None
    start = vis[len(vis) - len(inwin) - 1] if len(vis) > len(inwin) else inwin[0]
    return (inwin[-1][1] - start[1]) / MONITOR_RATE_S, start[0], inwin[-1][0]


def _rate_over_one_window(tsdb, rate, t_a, t_b, ticks):
    """The TSDB's rate and devprof's own device seconds over one window.
    The route evaluated the rate at some `now` in [t_a, t_b], on the
    points written by then; the same rate recomputed here from the
    series' points (the route's arithmetic, held to the JAX TSDB's by
    tests/test_torch_monitor.py) at t_a or t_b names the two sampler
    points it spans. devprof's snapshots at those two ticks bracket the
    TSDB's values, so the rate must lie in the bracket, and within one
    tick's share (the most the card did in one tick, over the window) of
    the bracket's middle."""
    found = [w for series in tsdb.matching("devprof_device_seconds_total")
             for now in (t_b, t_a) for drop in (0, 1)
             for w in [_window_rate(tsdb.points(series), now, drop)]
             if w is not None and w[0] == rate]
    check(rate is not None and found,
          f"(b) the route's rate {rate} is the TSDB's rate at neither {t_a} nor {t_b}")
    _, t_start, t_last = found[0]
    at = {round(k[0], 6): k for k in ticks}
    check(round(t_start, 6) in at and round(t_last, 6) in at,
          f"(b) the window's points {t_start:.3f}, {t_last:.3f} are not recorded ticks "
          f"({len(ticks)} recorded, {ticks[0][0] if ticks else 0:.3f} to "
          f"{ticks[-1][0] if ticks else 0:.3f})")
    (tb, b0, b1), (tl, l0, l1) = at[round(t_start, 6)], at[round(t_last, 6)]
    lo, hi = (l0 - b1) / MONITOR_RATE_S, (l1 - b0) / MONITOR_RATE_S
    mid = (lo + hi) / 2
    inside = [k for k in ticks if tb <= k[0] <= tl]
    share = max((b[2] - a[1] for a, b in zip(inside, inside[1:])), default=0.0) / MONITOR_RATE_S
    check(lo - 1e-12 <= rate <= hi + 1e-12 and abs(rate - mid) <= share + 1e-12,
          f"(b) rate {rate} vs devprof over the same window {lo}-{hi} (one tick's share "
          f"{share})")
    return {"window_points": (tb, tl), "devprof_rate": mid, "devprof_rate_lo": lo,
            "devprof_rate_hi": hi, "rate_difference": abs(rate - mid), "tick_share": share,
            "sampler_ticks": len(ticks)}


def _monitor_quiet(qport, queries, bodies, want, smi):
    """(b): 500 queries from 16 clients, no fault: answers, no alert, the
    TSDB's request counter, device and memory series."""
    lbl = "server:query,path:/queries.json,status:200"
    status, body = _call(qport, "POST", "/queries.json", queries[0])
    check(status == 200, f"warm query: {status} {body}")
    # the series (shared with earlier phases' query servers, whose counts
    # it holds) reads 1 before the traffic: the increase over a window
    # that starts after that point and before the traffic counts the
    # traffic alone
    (t_one, _), _ = _wait_for(
        lambda: (lambda pt: pt if pt and pt[1] == 1.0 else None)(
            _latest(qport, "http_requests_total", lbl)),
        10, "the warm query's 200 in the TSDB")
    ticks = []
    with _sampler_ticks(get_monitor()._sampler, ticks):
        # the card idle for the window before the traffic (the build and
        # the warm query before it), every tick of it recorded: the rate
        # read during the traffic spans a point from before it
        time.sleep(MONITOR_RATE_S + 2 * MONITOR_TICK_S)
        p0, t0 = devprof.snapshot(), time.perf_counter()
        res, threads = _monitor_clients(qport, bodies, N_CLIENTS)
        while (any(t.is_alive() for t in threads)
               and time.perf_counter() - t0 < MONITOR_TICK_S + 0.05):
            time.sleep(0.01)
        during = any(t.is_alive() for t in threads)
        t_a = time.time()
        rate_rows = _tsdb(qport, expr=RATE_EXPR)["result"]
        t_b = time.time()
        p1, t1 = devprof.snapshot(), time.perf_counter()
        _joined(threads)
    wall = time.perf_counter() - t0
    check(len(res) == len(bodies), f"(b) {len(res)} of {len(bodies)} answered")
    by_n = {n: (st, body) for n, st, body, _, _ in res}
    check(all(st == 200 for st, _ in by_n.values()), "(b) a quiet query failed")
    for n in range(MONITOR_CHECKED):
        check(by_n[n][1] == want[n], f"(b) query {n} is not the CPU plain version's answer")
    status, alerts = _call(qport, "GET", "/alerts")
    check(status == 200 and alerts["firing"] == [], f"(b) firing after quiet traffic: {alerts}")
    t_end = time.time()
    _wait_for(lambda: (_latest(qport, "http_requests_total", lbl) or (0, 0))[0]
              >= t_end + 2 * MONITOR_TICK_S, 10, "two sampler ticks after the traffic")
    inc = _tsdb(qport, name="http_requests_total", labels=lbl, agg="increase",
                window_s=str(time.time() - t_one - MONITOR_TICK_S / 5))["value"]
    check(inc == len(bodies), f"(b) the TSDB's increase of 200s on /queries.json is {inc}, "
          f"not {len(bodies)}")
    inv = _latest(qport, "devprof_invocations_total")[1]
    rep_inv = devprof.report()["totals"]["invocations"]
    check(inv == rep_inv, f"(b) devprof_invocations_total {inv} != devprof's report {rep_inv}")
    (alloc,), _ = _wait_for(
        lambda: (lambda v: (v,) if v == torch.cuda.memory_allocated() else None)(
            _latest(qport, "cuda_memory_allocated_bytes")[1]), 2.0,
        "the TSDB's allocated bytes equal to torch.cuda.memory_allocated()")
    rate = rate_rows[0]["value"] if rate_rows else None
    one = _rate_over_one_window(get_monitor().tsdb, rate, t_a, t_b, ticks)
    busy = (p1.device_seconds - p0.device_seconds) / (t1 - t0)
    out = {"queries": len(bodies), "clients": N_CLIENTS, "wall_s": wall,
           "qps": len(bodies) / wall, "increase_200": inc, "t_one": t_one, "devprof_invocations": inv,
           "allocated_bytes": alloc, "rate_device_seconds_5s": rate,
           "rate_read_during_traffic": during, "devprof_busy_share": busy, **one}
    print(f"[monitor] {smi} | (b) {len(bodies)} queries from {N_CLIENTS} clients in "
          f"{wall:.2f} s ({out['qps']:.1f} qps), {MONITOR_CHECKED} answers equal to the CPU "
          "plain version's, nothing firing", flush=True)
    print(f"[monitor] {smi} | (b) /debug/tsdb: increase of 200s on /queries.json {inc:g} "
          f"(exactly {len(bodies)}); devprof_invocations_total {inv:g} = devprof's report; "
          f"cuda_memory_allocated_bytes {alloc:g} = torch.cuda.memory_allocated()", flush=True)
    print(f"[monitor] {smi} | (b) {RATE_EXPR} read {'during' if during else 'just after'} "
          f"the traffic: {rate}; devprof's own device seconds over the same window (its "
          f"snapshots at the sampler's points {one['window_points'][0]:.3f} and "
          f"{one['window_points'][1]:.3f}), a second: {one['devprof_rate']:.6f} "
          f"(bracket {one['devprof_rate_lo']:.6f}-{one['devprof_rate_hi']:.6f}), "
          f"|difference| {one['rate_difference']:.3g} <= one tick's share "
          f"{one['tick_share']:.3g}; devprof's busy share over the traffic so far: "
          f"{busy:.2%}", flush=True)
    return out


def _alert_states(qport):
    status, body = _call(qport, "GET", "/alerts")
    check(status == 200, f"/alerts: {status} {body}")
    return {r["slo"]: r["state"] for r in body["slos"]}, body


def _monitor_alert(qport, bodies, sink, smi):
    """(c): a 400 ms device delay under 8 clients: query_p250 pending,
    firing, one firing notification; cleared: resolved, one resolve
    notification; console alerts agrees with GET /alerts. The tagged slow
    query of (e) goes out during the delay."""
    name = MONITOR_SLO["name"]
    status, body = _call(qport, "POST", "/debug/faults", {"set": MONITOR_FAULT})
    check(status == 200 and body["faults"] and body["faults"][0]["mode"] == "delay",
          f"(c) POST /debug/faults: {status} {body}")
    t_fault = time.monotonic()
    stop = threading.Event()
    res, threads = _monitor_clients(qport, bodies, MONITOR_ALERT_CLIENTS, stop)
    trace_id = f"monitor-slow-{uuid.uuid4().hex[:8]}"
    try:
        conn = http.client.HTTPConnection("127.0.0.1", qport, timeout=60)
        t0 = time.perf_counter()
        conn.request("POST", "/queries.json", body=bodies[1],
                     headers={"Content-Type": "application/json", "X-Request-ID": trace_id})
        resp = conn.getresponse()
        resp.read()
        slow_s = time.perf_counter() - t0
        conn.close()
        check(resp.status == 200 and slow_s >= 0.4,
              f"(e) the tagged query: {resp.status} in {slow_s:.3f} s")
        seen: dict = {}

        def state_is(want_state):
            states, _ = _alert_states(qport)
            seen.setdefault(states[name], time.monotonic())
            return states[name] == want_state

        _wait_for(lambda: state_is("firing"), 30, f"(c) {name} firing")
        check("pending" in seen and seen["pending"] <= seen["firing"],
              f"(c) {name} did not go pending before firing: {seen}")
        to_pending, to_firing = seen["pending"] - t_fault, seen["firing"] - t_fault

        def lines():
            return [json.loads(x) for x in sink.read_text().splitlines()] \
                if sink.exists() else []

        _wait_for(lambda: any(r["transition"] == "pending->firing" for r in lines()), 15,
                  "(c) the firing notification")
        status, body = _call(qport, "POST", "/debug/faults", {"clear": True})
        check(status == 200 and body["faults"] == [], f"(c) clearing: {status} {body}")
        t_clear = time.monotonic()
        seen.clear()
        _wait_for(lambda: state_is("resolved"), 60, f"(c) {name} resolved")
        to_resolved = seen["resolved"] - t_clear
    finally:
        stop.set()
        _joined(threads)
    _wait_for(lambda: any(r["transition"] == "firing->resolved" for r in lines()), 15,
              "(c) the resolve notification")
    rows = [r for r in lines() if r["slo"] == name]
    check([r["transition"] for r in rows] == ["pending->firing", "firing->resolved"],
          f"(c) the sink holds {[r['transition'] for r in rows]}")
    for r in rows:
        keys = set(r)
        check(NOTIFY_KEYS <= keys <= NOTIFY_KEYS | NOTIFY_EVIDENCE,
              f"(c) a notification's keys {sorted(keys)} are not the JAX notifier's")
    check(all(st == 200 for _, st, _, _, _ in res), "(c) a query under the delay failed")
    states, payload = _alert_states(qport)
    rc, text = _console_out(["alerts", "list", "--url", f"http://127.0.0.1:{qport}"])
    printed = dict(re.findall(r"\[INFO\]   (\S+): (\S+)  fast=", text))
    check(rc == 0 and printed == states, f"(c) console alerts {printed} != GET /alerts {states}")
    check(payload["firing"] == [] and states[name] == "resolved",
          f"(c) after the clear: {payload['firing']}")
    out = {"queries": len(res), "clients": MONITOR_ALERT_CLIENTS,
           "fault_to_pending_s": to_pending, "fault_to_firing_s": to_firing,
           "clear_to_resolved_s": to_resolved, "notifications": len(rows),
           "firing_keys": sorted(rows[0]), "trace_id": trace_id, "tagged_query_s": slow_s}
    print(f"[monitor] {smi} | (c) {MONITOR_FAULT} under {MONITOR_ALERT_CLIENTS} clients: "
          f"{name} pending {to_pending:.2f} s and firing {to_firing:.2f} s after the fault "
          f"was set; resolved {to_resolved:.2f} s after it was cleared; {len(res)} queries "
          "all 200", flush=True)
    print(f"[monitor] {smi} | (c) the exec sink got one firing and one resolve "
          f"notification, keys the JAX notifier's ({len(rows[0])} in the firing one); "
          f"console alerts list printed GET /alerts' states {states}", flush=True)
    return out


def _monitor_traces(dport, trace_id, smi):
    """(e): the dashboard's collector stitched the tagged slow query."""
    def spans():
        status, body = _call(dport, "GET", f"/debug/traces?fleet=1&trace_id={trace_id}")
        names = {s["name"] for s in body.get("spans", [])} if status == 200 else set()
        return names if {"server.request", "batch.device_dispatch"} <= names else None

    names, waited = _wait_for(spans, 20, "(e) the tagged query's trace on the dashboard")
    status, body = _call(dport, "GET", "/debug/traces?fleet=1&limit=0")
    row = next((t for t in body["traces"] if t["trace_id"] == trace_id), {})
    out = {"trace_id": trace_id, "spans": sorted(names), "kept": row.get("kept"),
           "duration_ms": row.get("duration_ms"), "collector": body.get("collector")}
    print(f"[monitor] {smi} | (e) the dashboard's /debug/traces?fleet=1&trace_id={trace_id}: "
          f"{', '.join(sorted(names))} (kept {row.get('kept')}, "
          f"{row.get('duration_ms')} ms), found {waited:.2f} s after the check began",
          flush=True)
    return out


def _monitor_fleet(dport, esrv, smi):
    """(d): up 1 for the three targets; the Event Server stopped, its up 0
    within two scrape intervals and event_up firing on the dashboard."""
    def all_up():
        status, body = _call(dport, "GET", "/debug/tsdb?name=up")
        latest = {r["labels"]["instance"]: r["points"][-1][1]
                  for r in body.get("series", []) if r["points"]}
        return latest if latest == {"query": 1.0, "event": 1.0, "admin": 1.0} else None

    ups, _ = _wait_for(all_up, 15, "(d) up 1 for the three targets")
    esrv.stop()
    t_stop, t_stop_wall = time.monotonic(), time.time()

    def event_down():
        pt = _latest(dport, "up", "instance:event")
        return pt if pt and pt[0] > t_stop_wall and pt[1] == 0.0 else None

    _, to_down = _wait_for(event_down, 10, "(d) up{instance=\"event\"} 0")
    check(to_down <= 2 * MONITOR_SCRAPE_S,
          f"(d) up{{instance=\"event\"}} read 0 {to_down:.2f} s after the stop, more than "
          f"two scrape intervals")

    def event_up_firing():
        status, body = _call(dport, "GET", "/alerts")
        return "event_up" in body.get("firing", [])

    _wait_for(event_up_firing, 15, "(d) event_up firing on the dashboard")
    to_firing = time.monotonic() - t_stop
    out = {"up": ups, "stop_to_up0_s": to_down, "stop_to_event_up_firing_s": to_firing}
    print(f"[monitor] {smi} | (d) the dashboard's up: {ups}; the Event Server stopped: "
          f"up{{instance=\"event\"}} 0 after {to_down:.2f} s (scrape every "
          f"{MONITOR_SCRAPE_S} s), event_up firing after {to_firing:.2f} s", flush=True)
    return out


def _monitor_admin(aport, qport, seeded, smi):
    """(f): the admin server's JSON routes against the console's listings
    over the same storage; the routes not ported."""
    versions, job = seeded

    def rows(text):
        return set(re.findall(r"\[INFO\]   (\S+) \[(\w+)\]", text))

    _, models = _call(aport, "GET", "/models")
    rc, text = _console_out(["models", "list"])
    check(rc == 0 and {(v["id"], v["status"]) for v in models} == rows(text)
          and len(models) == len(versions), f"(f) /models {models} vs console {text}")
    _, jobs = _call(aport, "GET", "/jobs")
    rc, text = _console_out(["jobs", "list"])
    check(rc == 0 and {(j["id"], j["status"]) for j in jobs} == rows(text)
          and [j["id"] for j in jobs] == [job.id], f"(f) /jobs {jobs} vs console {text}")
    _, online = _call(aport, "GET", "/online")
    rc, text = _console_out(["online", "cursors"])
    printed = re.findall(r"\[INFO\] (\S+):\n\[INFO\]   cursor: (.*)\n", text)
    check(rc == 0 and [(c["cursor_id"], str(c["cursor"])) for c in online["consumers"]]
          == printed, f"(f) /online {online} vs console {text}")
    _, rollout = _call(aport, "GET", "/rollout")
    rc, text = _console_out(["rollout", "status", "--url", f"http://127.0.0.1:{qport}"])
    live = {v for v, st in rows(_console_out(["models", "list"])[1]) if st == "live"}
    check(rc == 0 and "rollout state: none" in text and rollout["canary"] == []
          and {v["id"] for v in rollout["live"]} == live == {versions[0].id},
          f"(f) /rollout {rollout} vs console {text}")
    _, evals = _call(aport, "GET", "/evals")
    rc, text = _console_out(["eval", "list"])
    check(rc == 0 and evals == [] and len(text.splitlines()) == 1,
          f"(f) /evals {evals} vs console {text}")
    refused = {}
    status, body = _call(aport, "GET", "/tenants")
    check(status == 404 and "not ported yet" in body["message"],
          f"(f) /tenants: {status} {body}")
    refused["/tenants"] = body["message"]
    print(f"[monitor] {smi} | (f) the admin server's /models ({len(models)}), /jobs "
          f"({len(jobs)}), /online ({len(online['consumers'])}), /rollout and /evals "
          "equal console models list, jobs list, online cursors, rollout status and eval "
          "list over the same storage; /tenants 404 not ported yet", flush=True)
    return {"models": len(models), "jobs": len(jobs), "consumers": len(online["consumers"]),
            "refused": refused}


def main() -> int:
    if _IMPORT_ERROR is not None:
        print(f"chip_smoke: the port is not importable here ({_IMPORT_ERROR}); "
              "run from a checkout of the repository", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    report: dict = {"busy": {}}
    shared: dict = {}
    # a call the device profiler cannot time fails its phase (and this
    # process's children inherit it)
    os.environ["PIO_DEVPROF_STRICT"] = "1"
    # the Event Server children's write-ahead logs stay in the checkout
    os.environ["PIO_WAL_DIR"] = str(Path(__file__).resolve().parent / "build" / "wal")
    # the card's host runs Python with PYTHONDONTWRITEBYTECODE and its
    # torch ships no bytecode, so every child compiled torch's sources
    # anew (~11 s an `import torch`): the children write their bytecode
    # under build/pycache in the checkout once and read it after
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = str(Path(__file__).resolve().parent / "build" / "pycache")
    t_start = time.perf_counter()
    for name, phase in (("device", phase_device), ("build", phase_build),
                        ("sweep", phase_sweep), ("data", phase_data),
                        ("dense", phase_dense), ("train", phase_train),
                        ("serve", phase_serve), ("times", phase_times),
                        ("dense times", phase_dense_times),
                        ("loop", phase_loop), ("segments", phase_segments),
                        ("replication", phase_replication),
                        ("eval", phase_eval),
                        ("fleet eval", phase_fleet_eval),
                        ("lifecycle", phase_lifecycle),
                        ("ingest", phase_ingest), ("remote", phase_remote),
                        ("sharded", phase_sharded), ("backends", phase_backends),
                        ("online", phase_online),
                        ("templates", phase_templates),
                        ("data25", phase_data25), ("windowed", phase_windowed),
                        ("windowed train", phase_windowed_train),
                        ("scatter", phase_scatter),
                        ("windowed times", phase_windowed_times),
                        ("ur sweep", phase_ur_sweep), ("ur data", phase_ur_data),
                        ("ur train", phase_ur_train), ("ur serve", phase_ur_serve),
                        ("ur times", phase_ur_times), ("classify", phase_classify),
                        ("observe", phase_observe), ("rollout", phase_rollout),
                        ("monitor", phase_monitor)):
        p0, t0 = devprof.snapshot(), time.perf_counter()
        try:
            phase(report, shared)
        except Exception:  # noqa: BLE001 — report the phase, then fail
            traceback.print_exc()
            print(f"FAILED phase {name}", flush=True)
            return 1
        wall = time.perf_counter() - t0
        busy_s = devprof.snapshot().card_seconds - p0.card_seconds
        report["busy"][name] = {"wall_s": wall, "device_s": busy_s, "share": busy_s / wall}
    report["seconds"] = time.perf_counter() - t_start
    main_row = next(r for r in report["times"]
                    if r["dtype"] == "f32" and r["B"] == 64)
    ev = report["eval"]["launches"]  # console eval run
    evd = report["eval"]["dense"]["launches"]  # Engine.batch_eval, forced dense
    held = report["eval"]["held"]  # the eval's shapes against the plain versions
    ing = report["ingest"]["launches"]  # the Event Server's app: train, deploy
    lc = report["lifecycle"]["launches"]  # the train jobs' children and the deploy
    lckr = report["lifecycle"]["kill_resume_launches"]  # in process, both runs
    tpl = report["templates"]  # the similar-product deploy; the other templates
    sim, tml = tpl["similar"]["launches"], [tpl["ecommerce"]["launches"],
                                          tpl["recommendation"]["launches"]]
    rmt = report["remote"]["launches"]  # over the storage daemon: train, deploy
    shd = report["sharded"]["launches"]  # the sharded source: two trains, the served queries
    bkl = report["backends"]["launches"]  # parquetfs and postgres: two trains, two deploys
    fle = report["fleet_eval"]  # the shard children of (a) and (b), its jobs, (d)
    fl_shards = [fle["a"]["launches"], fle["b"]["launches"]]
    fl_jobs = [fle["b"]["launches_a"], fle["b"]["launches_n"]]
    sgl = report["segments"]["launches"]  # segmentfs: train, retrain, deploy
    paths = {  # each main path's launches, counted from 0 around it
        "fused_recommend_topk": {"serve": report["serve"]["launches"],
                                 "loop": report["loop"]["launches"]["serve_topk"],
                                 "segments": sgl["serve_topk"],
                                 "replication": report["replication"]["launches"]["topk"],
                                 "eval": ev["topk"], "eval dense": evd["topk"],
                                 "ingest": ing["serve_topk"], "remote": rmt["serve_topk"],
                                 "sharded": shd["serve_topk"],
                                 "backends": bkl["serve_topk"],
                                 "lifecycle": lc["serve_topk"],
                                 "online": report["online"]["launches"]["topk"],
                                 "similar": sim["serve_topk"],
                                 "templates": tml[1]["serve_topk"],
                                 "rollout": report["rollout"]["launches"],
                                 "monitor": report["monitor"]["launches"],
                                 "fleet eval shards": sum(x["topk"] for x in fl_shards)},
        **{which: {"train": report["train"]["launches"][which],
                   "loop": report["loop"]["launches"][which],
                   "segments": sgl[which], "eval dense": evd[which], "lifecycle jobs": lc[which],
                   "lifecycle kill/resume": lckr[which], "similar": sim[which],
                   "templates": sum(t[which] for t in tml),
                   "fleet eval jobs": sum(j[which] for j in fl_jobs)}
            for which in ("row", "col")},
        "block_partials": {"windowed train": report["windowed_train"]["launches"]["partials"],
                           "eval": ev["partials"], "ingest": ing["partials"],
                           "remote": rmt["partials"], "sharded": shd["partials"],
                           "backends": bkl["partials"],
                           "similar": sim["partials"],
                           "templates": sum(t["partials"] for t in tml),
                           "fleet eval shards": sum(x["partials"] for x in fl_shards)},
        "combine": {"windowed train": report["windowed_train"]["launches"]["combine"],
                    "eval": ev["combine"], "ingest": ing["combine"], "remote": rmt["combine"],
                    "sharded": shd["combine"], "backends": bkl["combine"],
                    "similar": sim["combine"], "templates": sum(t["combine"] for t in tml),
                    "fleet eval shards": sum(x["combine"] for x in fl_shards)},
        "fused_masked_topk": {"ur serve": report["ur_serve"]["launches"],
                              "fleet eval ur": fle["d"]["launches"]},
    }
    kernels = [{
        "name": "fused_recommend_topk", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": sum(paths["fused_recommend_topk"].values()),
        "launches_by_path": paths["fused_recommend_topk"],
        "max_abs_err": max(report["sweep"]["max_abs_err"],
                           report["sharded"]["e"]["held"]["max_abs_err"]),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"], "device_ms": main_row["device_ms"],
        "topk_route": main_row["route"],
        "launches_per_call": main_row["launches_per_call"],
    }]
    for row in report["dense_times"]:
        which = row["pass"]
        kernels.append({
            "name": f"fused_{which}_pass", "route": "cuda",
            "source": DENSE_SOURCE, "replaces": DENSE_REPLACES[which],
            "launches": sum(paths[which].values()), "launches_by_path": paths[which],
            "max_abs_err": max(report["dense_sweep"][which]["max_abs_err"],
                               held["dense"][which]["max_abs_err"],
                               report["segments"]["held"][which]["max_abs_err"],
                               report["lifecycle"]["held"]["dense"][which]["max_abs_err"]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
    users_side = report["windowed_times"][0]  # the users half-step's call
    kernels.append({
        "name": "block_partials", "route": "cuda", "source": WINDOWED_SOURCE,
        "replaces": WINDOWED_REPLACES,
        "launches": sum(paths["block_partials"].values()),
        "launches_by_path": paths["block_partials"],
        "max_abs_err": max(report["windowed_sweep"]["max_abs_err"],
                           held["windowed"]["max_abs_err"],
                           report["ingest"]["held"]["max_abs_err"],
                           report["remote"]["train"]["held"]["max_abs_err"],
                           report["sharded"]["c"]["held"]["max_abs_err"],
                           report["backends"]["held"]["max_abs_err"],
                           tpl["similar"]["held"]["max_abs_err"]),
        "ms": users_side["ms"], "plain_ms": users_side["plain_ms"],
        "bound_ms": users_side["bound_ms"], "bound_by": users_side["bound_by"],
        "library_ms": users_side["library_ms"],
        "combine_ms": users_side["combine_ms"],
        "combine_launches": sum(paths["combine"].values()),
    })
    ur_row = next(r for r in report["ur_times"] if r["B"] == 64)
    kernels.append({
        "name": "fused_masked_topk", "route": "cuda", "source": SOURCE,
        "replaces": MASKED_REPLACES, "launches": sum(paths["fused_masked_topk"].values()),
        "launches_by_path": paths["fused_masked_topk"],
        "max_abs_err": report["ur_sweep"]["max_abs_err"],
        "ms": ur_row["ms"], "plain_ms": ur_row["plain_ms"],
        "bound_ms": ur_row["bound_ms"], "bound_by": ur_row["bound_by"],
        "library_ms": ur_row["library_ms"],
    })
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(f"[done] {report['seconds']:.1f} s", flush=True)
    print(report["nvidia_smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
