#!/usr/bin/env python3
"""Drive the PyTorch port's ALS train (dense, windowed, scatter) and
serve paths, the storage-backed train → deploy → query loop, the grid
evaluation over the same storage, the Event Server feeding train →
deploy, the online fold-in of live events into the served model, and
the model lifecycle (train jobs, checkpoints, warm starts, versions),
item properties with the similar-product and e-commerce templates, the
Universal Recommender's train and serve path, and the classification
and regression templates, on one CUDA card.

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
11. lifecycle the model lifecycle over the loop's storage and app, with
            the train job's child on the card: ``jobs submit`` of the
            template's variant with checkpoint_every 5 and ``jobs worker
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
            unequal to a cold one. Job 3 under an in-process
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
            keeps v1 and v3, ``jobs gc --keep 2`` jobs 2 and 3. The
            children import this checkout through PYTHONPATH. Prints
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
            on the CPU for three blocks of 1,024 items per indicator
            within the LLR tolerance (atol = 16 eps N ln N; indices equal
            outside tie groups). Prints read, indicator build, counts and
            LLR + top-n seconds.
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
            first 60,000 cells and 30,000 songs as ``$set`` events
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
27. report  one ``{"kernels": [...]}`` line, then the device line last.

Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import datetime
import http.client
import io
import json
import os
import queue
import re
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

import numpy as np
import torch

try:
    from predictionio_tpu_torch import convert
    from predictionio_tpu_torch.core.base import RuntimeContext
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage.base import App, EventQuery
    from predictionio_tpu_torch.controller import (
        EngineParams,
        EngineParamsGenerator,
        Evaluation,
        MetricEvaluator,
        deserialize_models,
    )
    from predictionio_tpu_torch.data.storage.registry import Storage, StorageConfig
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
    from predictionio_tpu_torch.deploy.registry import ModelRegistry
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
    from predictionio_tpu_torch.workflow.core import stage_timings
    from predictionio_tpu_torch.workflow.server import (
        QueryServer,
        QueryServerConfig,
        _to_jsonable,
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
UR_CPU_BLOCKS, UR_CPU_BLOCK_ROWS = (0, 49_920, 98_976), 1_024
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
LIFECYCLE_NEW_USERS, LIFECYCLE_NEW_USER_RATINGS = 200, 20  # on existing movies
LIFECYCLE_NEW_ITEMS, LIFECYCLE_NEW_ITEM_RATINGS = 100, 30  # by existing users
LIFECYCLE_OLD_USERS, LIFECYCLE_OLD_USER_RATINGS = 300, 10  # new pairs
LIFECYCLE_QUERIES, LIFECYCLE_CLIENTS = 200, 8
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
CLASSIFY_ENTITIES, REGRESS_ENTITIES, CLASSIFY_FOLDS = 60_000, 30_000, 5
NB_GRID = (0.5, 1.0, 2.0, 4.0)
LR_GRID = ((0.5, 1e-4), (0.3, 1e-3), (0.8, 1e-2))  # (lr, l2)
CLASSIFY_T0_MS = 1_262_304_000_000  # 2010-01-01, epoch ms
OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"
LOOP_DIR = Path(__file__).resolve().parent / "build" / "loop"
CLASSIFY_DIR = Path(__file__).resolve().parent / "build" / "classify"


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
    print(f"[device] {report['device']} | {report['nvidia_smi']} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)


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
    repeat = np.zeros(len(key), bool)
    repeat[order[1:]] = key[order[1:]] == key[order[:-1]]
    pending = np.flatnonzero(repeat)  # edges whose pair an earlier edge holds
    # the pairs held: the sorted initial set, less `removed`, plus `added`
    # (both sorted, disjoint from it and small), so that a round costs
    # O(pending) and not a rewrite of the whole set
    base = np.unique(key)
    added = removed = np.zeros(0, np.int64)
    del order, repeat

    def held(keys, table):
        if not len(table):
            return np.zeros(len(keys), bool)
        pos = np.searchsorted(table, keys)
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

    BANNER = re.compile(r"(?:^serving .* on |Event Server is listening at http://)"
                        r"[^\s:]+:(\d+)")

    def __init__(self, args, log_path):
        self.log = open(log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.tools.console", *args],
            cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
            stderr=self.log, text=True,
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


class _loop_storage:
    """The loop's storage under ``build/loop/store`` (sqlite events and
    metadata, model files), or under `store`, named by PIO_FS_BASEDIR and
    the PIO_STORAGE_* variables while the block runs."""

    def __init__(self, store=None):
        self.store = LOOP_DIR / "store" if store is None else store

    def __enter__(self):
        store = self.store
        env = {"PIO_FS_BASEDIR": str(store),
               "PIO_STORAGE_SOURCES_LOOPDB_TYPE": "sqlite",
               "PIO_STORAGE_SOURCES_LOOPDB_PATH": str(store / "pio.db"),
               "PIO_STORAGE_SOURCES_LOOPFS_TYPE": "localfs",
               "PIO_STORAGE_SOURCES_LOOPFS_PATH": str(store),
               "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "LOOPDB",
               "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "LOOPDB",
               "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "LOOPFS"}
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
        _loop_run(report, users, items, ratings, events_path, data_s)
    shared["loop"] = (users, items, ratings)  # the lifecycle phase's base
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


def _lifecycle_variant(**als_params):
    return {"id": LIFECYCLE_ENGINE,
            "engineFactory": "predictionio_tpu_torch.engines.recommendation."
                             "RecommendationEngine",
            "datasource": {"params": {"app_name": LOOP_APP, "event_names": ["rate"]}},
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


def phase_lifecycle(report, shared):
    """Phase 11: train jobs through the queue and its worker (the child on
    the card), checkpointed and warm-started, a kill and resume, a worker
    crash, promotion, serving of the newest instance and GC."""
    t_phase = time.perf_counter()
    # the job children run `python -m predictionio_tpu_torch.deploy.worker`:
    # they import this checkout wherever the script was started from
    os.environ["PYTHONPATH"] = os.pathsep.join(
        filter(None, (str(Path(__file__).resolve().parent), os.environ.get("PYTHONPATH"))))
    users, items, _ratings = shared["loop"]
    params = ALSAlgorithmParams()
    ap = _als_params(params)
    jobs_dir = LOOP_DIR / "jobs"
    v1_path, v2_path = LOOP_DIR / "lifecycle.json", LOOP_DIR / "lifecycle_warm.json"
    v1_path.write_text(json.dumps(_lifecycle_variant()))
    v2_path.write_text(json.dumps(_lifecycle_variant(warm_start=True)))
    ds = RecommendationDataSource(DataSourceParams(app_name=LOOP_APP, event_names=("rate",)))
    lc: dict = {"checkpoint_every": LIFECYCLE_CHECKPOINT_EVERY}
    with _loop_storage():
        storage = Storage()
        registry = ModelRegistry(storage)

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

        # 6. a worker crash: the child killed once the train started
        rc, out = _console_out(["jobs", "submit", "--variant", str(v2_path)])
        job3_id = re.search(r"job-[0-9a-f]{12}", out).group()
        sched = TrainScheduler(storage, SchedulerConfig(log_dir=str(jobs_dir)))
        queue = JobQueue(storage)
        t0 = time.perf_counter()
        sched.start()
        try:
            killed_pid = None
            deadline = time.monotonic() + 300
            while killed_pid is None and time.monotonic() < deadline:
                job3 = queue.get(job3_id)
                # killed once its first segment's checkpoint is saved
                if (job3.status == "running" and job3.log_path
                        and "checkpoint saved at iteration" in Path(
                            job3.log_path).read_text(errors="replace")):
                    [killed_pid] = _pids_naming(f"{job3_id}.spec.json")
                    os.kill(killed_pid, signal.SIGKILL)
                    killed_at = datetime.datetime.now(datetime.timezone.utc)
                time.sleep(0.02)
            check(killed_pid is not None, "job 3's train never started")
            while time.monotonic() < deadline:
                if queue.get(job3_id).status in ("completed", "failed"):
                    break
                time.sleep(0.2)
        finally:
            sched.stop()
        crash_s = time.perf_counter() - t0
        job3, inst3, v3 = _finished_job(storage, job3_id, attempts=2)
        kill_to_claim = (datetime.datetime.fromisoformat(job3.started_at)
                         - killed_at).total_seconds()
        launches3, segments3, _ = _job_launches(job3, 2)
        check(launches3 == (it, it, 0, 0), f"job 3 launches {launches3}")
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
            checks = _ingest_checks(port, key, rate_key, events, ids, users, times, rng)
        check(es.proc.returncode is not None, "eventserver still running")
        report["ingest"] = {**ingest, "checks": checks}
        _ingest_train_deploy(report, users, items, ratings)
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


def _ingest_posts(port, key, events, rng):
    """The timed ingest: the events in a shuffled order, all but the last
    INGEST_SINGLES as /batch/events.json POSTs of INGEST_BATCH, those one
    by one, dealt round-robin to INGEST_WRITERS threads (batches first);
    every event must come back 201. Returns the times and each event's
    id."""
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
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "ingest writers hung")
    check(len(out) == len(work), f"{len(out)} of {len(work)} POSTs answered")
    ids = np.empty(len(events), object)
    for j, (chunk, _, _) in enumerate(work):
        status, body, *_ = out[j]
        if j < n_batches:
            check(status == 200 and [r["status"] for r in body] == [201] * len(chunk),
                  f"batch POST {j}: HTTP {status} {str(body)[:200]}")
            ids[chunk] = [r["eventId"] for r in body]
        else:
            check(status == 201, f"single POST {j}: HTTP {status} {body}")
            ids[chunk[0]] = body["eventId"]
    check(len(set(ids)) == len(events), "event ids are not unique")
    batch_s = [out[j][2] for j in range(n_batches)]
    single_s = [out[j][2] for j in range(n_batches, len(work))]
    return {"events": len(events), "writers": INGEST_WRITERS, "batch_posts": n_batches,
            "single_posts": len(single_s), "ingest_s": wall,
            "events_per_s": len(events) / wall,
            "batch_p50_ms": _pct(batch_s, 0.5), "batch_p99_ms": _pct(batch_s, 0.99),
            "single_p50_ms": _pct(single_s, 0.5), "single_p99_ms": _pct(single_s, 0.99),
            "ids": ids}


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


def _ingest_train_deploy(report, users, items, ratings):
    """`train --engine-json` over the ingested app, the checks of its
    frame, staging, launches and factors, the kernels held at its plans'
    shapes; then the deploy and its 500 queries."""
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

    rng = np.random.default_rng(INGEST_SEED + 2)
    queries = _loop_queries(rng, INGEST_USERS, INGEST_ITEMS, unknown=0)
    t0 = time.perf_counter()
    with _Console(["deploy", "--engine-json", str(engine_json), "--ip", "127.0.0.1",
                   "--port", "0"], LOOP_DIR / "deploy_ml100k.log") as dep:
        port = dep.port(timeout=300)
        before = _status(port)
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
    check(dep.proc.returncode is not None, "deploy still running")
    check(before["engine_instance"] == inst.id, "deploy serves another instance")
    check(after["device"] == "cuda:0", f"deploy serves on {after['device']}")
    check(len(out) == len(queries), f"{len(out)} of {len(queries)} answered")
    batches = after["batches"] - before["batches"]
    served = after["kernel_launches"] - before["kernel_launches"]
    select = after["select_launches"] - before["select_launches"]
    check(batches > 0 and served == select == batches,
          f"deploy top-k launches {served} (select {select}) != its batches {batches}")
    model.bind_device("cpu")
    cpu_alg = ALSAlgorithm(params)
    for n, q in enumerate(queries):
        status, body, _ = out[n]
        check(status == 200, f"query {n}: HTTP {status} {body}")
        check(body == _to_jsonable(cpu_alg.predict(model, Query(**q))),
              f"query {n} ({q}) differs from the CPU plain top-k")
    lat = [out[n][2] for n in range(len(queries))]
    report["ingest"].update({
        "stages": stage_timings(inst), "staging": "StagedWindowedTrain",
        "launches": {**launches, "serve_topk": served, "serve_select": select},
        "corr_users": cu, "corr_items": ci, "held": held,
        "deploy_ready_s": ready_s, "wall_s": wall, "qps": len(queries) / wall,
        "p50_ms": _pct(lat, 0.5), "p99_ms": _pct(lat, 0.99),
        "batches": batches, "mean_batch": len(queries) / batches,
        "batch_predict_ms": 1e3 * (after["batch_predict_seconds"]
                                   - before["batch_predict_seconds"]) / batches,
        "nvidia_smi": report["nvidia_smi"],
    })


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
    rng = np.random.default_rng(UR_SEED)
    buy_users = np.concatenate([rng.integers(0, UR_USERS, UR_ITEMS),
                                np.repeat(np.arange(UR_USERS), UR_PER_USER)])
    buy_items = np.concatenate([np.arange(UR_ITEMS),
                                rng.zipf(UR_ZIPF, UR_USERS * UR_PER_USER) % UR_ITEMS])
    vrng = np.random.default_rng(UR_SEED + 1)
    view_users = np.repeat(np.arange(UR_USERS), UR_PER_USER)
    view_items = vrng.zipf(UR_ZIPF, UR_USERS * UR_PER_USER) % UR_ITEMS
    rows = ([("buy", u, i) for u, i in zip(buy_users.tolist(), buy_items.tolist())]
            + [("view", u, i) for u, i in zip(view_users.tolist(), view_items.tolist())])
    storage = Storage(StorageConfig.memory())
    app_id = storage.get_meta_data_apps().insert(App(0, UR_APP))
    storage.get_events().init_app(app_id)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
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


def _correlators_close(ref, got, n_users):
    """(max |dv|, index mismatches outside tie groups, atol, the worst
    (row, position)) of two CCO tables under the LLR tolerance atol =
    16 eps N ln N: values position by position; indices exactly except
    in runs of values within atol of each other or of 0, and in the run
    reaching the list's end."""
    (rv, ri), (gv, gi) = ref, got
    atol = 16 * float(np.finfo(np.float32).eps) * n_users * np.log(n_users)
    diff = np.abs(rv - gv)
    dv = float(diff.max())
    worst = np.unravel_index(int(diff.argmax()), diff.shape)
    bad = 0
    n = rv.shape[1]
    for row in range(rv.shape[0]):
        v = rv[row]
        start = 0
        while start < n:
            end = start + 1
            while end < n and abs(v[end] - v[end - 1]) <= atol:
                end += 1
            if v[start] > atol and end < n:
                bad += sorted(ri[row, start:end]) != sorted(gi[row, start:end])
            start = end
    return dv, bad, atol, worst


def _llr_f64(p, s, item, thing, n_users):
    """The LLR of one (item, thing) pair in float64 from the 0/1 CPU
    matrices: the reference a card/CPU disagreement is judged by."""
    k11 = float((p[:, item] * s[:, thing]).sum())
    k12 = float(p[:, item].sum()) - k11
    k21 = float(s[:, thing].sum()) - k11
    k22 = n_users - k11 - k12 - k21

    def xl(x):
        return x * np.log(x) if x > 0 else 0.0

    llr = 2 * (xl(k11) + xl(k12) + xl(k21) + xl(k22) - xl(k11 + k12)
               - xl(k21 + k22) - xl(k11 + k21) - xl(k12 + k22) + xl(n_users))
    return max(llr, 0.0), (k11, k12, k21, k22)


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
        worst = {"max_abs_diff": 0.0, "index_mismatches": 0, "rows": 0}
        for lo in UR_CPU_BLOCKS:
            hi = lo + UR_CPU_BLOCK_ROWS
            v, i = cco._cco_topn(p_cpu[:, lo:hi], s_cpu, td.n_users, lo,
                                 top_n=UR_CORRELATORS,
                                 exclude_diagonal=ind.name == primary.name)
            cpu_v, cpu_i = v.numpy(), i.numpy()
            dv, bad, atol, (r, t) = _correlators_close(
                (cpu_v, cpu_i),
                (m.correlator_scores[lo:hi], m.correlator_idx[lo:hi]), td.n_users)
            if dv > worst["max_abs_diff"]:
                card_j = int(m.correlator_idx[lo + r, t])
                cpu_j = int(cpu_i[r, t])
                worst["worst"] = {
                    "item": lo + int(r), "position": int(t),
                    "card": [float(m.correlator_scores[lo + r, t]), card_j],
                    "cpu": [float(cpu_v[r, t]), cpu_j],
                    "f64_card_pair": _llr_f64(p_cpu, s_cpu, lo + int(r), card_j,
                                              td.n_users) if card_j >= 0 else None,
                    "f64_cpu_pair": _llr_f64(p_cpu, s_cpu, lo + int(r), cpu_j,
                                             td.n_users) if cpu_j >= 0 else None,
                }
            worst["max_abs_diff"] = max(worst["max_abs_diff"], dv)
            worst["index_mismatches"] += bad
            worst["rows"] += hi - lo
        check(worst["max_abs_diff"] <= atol and worst["index_mismatches"] == 0,
              f"{ind.name}: card vs CPU beyond the LLR tolerance ({worst}, atol "
              f"{atol:.4g})")
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
    del model, tables
    torch.cuda.empty_cache()


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
    t_start = time.perf_counter()
    for name, phase in (("device", phase_device), ("build", phase_build),
                        ("sweep", phase_sweep), ("data", phase_data),
                        ("dense", phase_dense), ("train", phase_train),
                        ("serve", phase_serve), ("times", phase_times),
                        ("dense times", phase_dense_times),
                        ("loop", phase_loop), ("eval", phase_eval),
                        ("lifecycle", phase_lifecycle),
                        ("ingest", phase_ingest), ("online", phase_online),
                        ("templates", phase_templates),
                        ("data25", phase_data25), ("windowed", phase_windowed),
                        ("windowed train", phase_windowed_train),
                        ("scatter", phase_scatter),
                        ("windowed times", phase_windowed_times),
                        ("ur sweep", phase_ur_sweep), ("ur data", phase_ur_data),
                        ("ur train", phase_ur_train), ("ur serve", phase_ur_serve),
                        ("ur times", phase_ur_times), ("classify", phase_classify),
                        ("observe", phase_observe)):
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
    paths = {  # each main path's launches, counted from 0 around it
        "fused_recommend_topk": {"serve": report["serve"]["launches"],
                                 "loop": report["loop"]["launches"]["serve_topk"],
                                 "eval": ev["topk"], "eval dense": evd["topk"],
                                 "ingest": ing["serve_topk"],
                                 "lifecycle": lc["serve_topk"],
                                 "online": report["online"]["launches"]["topk"],
                                 "similar": sim["serve_topk"],
                                 "templates": tml[1]["serve_topk"]},
        **{which: {"train": report["train"]["launches"][which],
                   "loop": report["loop"]["launches"][which],
                   "eval dense": evd[which], "lifecycle jobs": lc[which],
                   "lifecycle kill/resume": lckr[which], "similar": sim[which],
                   "templates": sum(t[which] for t in tml)} for which in ("row", "col")},
        "block_partials": {"windowed train": report["windowed_train"]["launches"]["partials"],
                           "eval": ev["partials"], "ingest": ing["partials"],
                           "similar": sim["partials"],
                           "templates": sum(t["partials"] for t in tml)},
        "combine": {"windowed train": report["windowed_train"]["launches"]["combine"],
                    "eval": ev["combine"], "ingest": ing["combine"],
                    "similar": sim["combine"], "templates": sum(t["combine"] for t in tml)},
        "fused_masked_topk": {"ur serve": report["ur_serve"]["launches"]},
    }
    kernels = [{
        "name": "fused_recommend_topk", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": sum(paths["fused_recommend_topk"].values()),
        "launches_by_path": paths["fused_recommend_topk"],
        "max_abs_err": report["sweep"]["max_abs_err"],
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
