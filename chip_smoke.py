#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and hold its kernels to their plain versions.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --only-scoring   # phases 1-4 and 9, then the scoring split
    python3 chip_smoke.py --only-lifecycle # build, then phase 14
    python3 chip_smoke.py --only-fleet     # build, then phase 15
    python3 chip_smoke.py --only-autoscaler # build, then phase 16
    python3 chip_smoke.py --only-challengers # phase 17 (no kernel to build)
    python3 chip_smoke.py --only-portfolio # build, then phase 18 and the full book
    python3 chip_smoke.py --only-search    # build, then 5b's joint launches and the bucket's jobs
    python3 chip_smoke.py --only-mesh      # build, then phase 19 (the card named four times)
    python3 chip_smoke.py --only-tools     # build, then phases 15-16 and 20 (the operator's layer)
    python3 chip_smoke.py --full-protocol  # build, then phase 8b at the defaults

Phases, each of which must pass:

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the port from ``csrc/`` (one ``nvcc`` per
   source, all started together; the ``-Xptxas=-v`` report goes to stderr);
3. kernel vs plain: `fused_score` (the ``score_forest`` kernel) against
   `fused_score_reference` on the same seeded rows of the committed 300-tree
   depth-7 model, at the /predict buckets 1, 8, 64 with SHAP and the bulk
   buckets 256, 4096 without: margins bitwise equal (to the plain version
   on the card and on the CPU, and across two calls), prob within 1e-6,
   phis within 1e-5 (and bitwise across two calls), ``base + sum(phis)``
   within 1e-4 of the margin; then
   each bucket's time per call (CUDA events, after warm-up), the plain
   version's time and the least time the card could take (``bound_ms``);
4. serving: the port's `ScorerService` on ``cuda`` behind its HTTP server
   answers 32 concurrent ``/predict`` requests (coalesced by the
   micro-batcher), one ``/predict_bulk_csv`` and one
   ``/feature_importance_bulk``; responses are checked against the plain
   version on the CPU, and the kernel's launch count over the phase must be
   one per micro-batch, per bulk chunk and per startup warm-up bucket;
5. training, at the full width of the model the repo serves (300 trees of
   depth 7, 255 bins, the 20 serving features, subsample and colsample 0.8,
   ``scale_pos_weight`` 3.767) on 1.84M seeded training rows and 460k held
   out (the 80/20 split of the ~2.3M-row LendingClub table):
   a. binning on the card equals binning on the CPU, bit for bit;
   b. the ``gradient_histogram`` kernel against its plain version at every
      histogram shape of the first tree (level 0 direct, levels 1-6
      sibling-subtracted, and the direct level-6 call): cover bit-equal, g
      and h of each node within 1e-5 of that node's largest |value| in the
      channel, two launches bit-equal, and at level 6 subtracted the rows in
      a random order bit-equal; active rows, kernel, plain, library (three
      ``torch.bincount``) and bound times per shape; then the search's job
      axis at the protocol's largest bucket: the 15 (candidate, fold) jobs
      of the reference-default search's depth-9, 100-tree bucket (5
      candidates x 3 folds, each fold at weight 0) on the same rows, the
      first tree's joint launches (``gradient_histogram_jobs``) at level 0
      direct, levels 4 and 8 sibling-subtracted and level 8 direct, each
      bit-equal to 15 single launches and to itself twice, its cover
      bit-equal to the plain version and g and h of each (job, node) within
      1e-5 of its largest |value|; active (job, row) pairs, the joint
      launch's, the 15 single launches', plain, library (one weighted
      ``torch.bincount`` per channel over (job, node, feature, bin) keys) and
      bound times per shape;
   c. ``GBDTClassifier.fit`` through the kernel (the main path): wall time,
      one launch per tree level, held-out AUC; a second fit of the level
      loop on the same bins, with CUDA events around each histogram launch,
      gives the same forest bit for bit and the time inside the launches; a
      fit with the plain histogram on the card grows tree 0 with the same
      splits and lands within 0.002 of its held-out AUC;
   d. the trained forest is saved as the ``.npz`` artifact, and the port's
      `ScorerService` on ``cuda`` serves it: 16 concurrent ``/predict`` (with
      SHAP) and one bulk CSV, checked against the plain scorer on the CPU;
   e. the first 10 trees of the level loop under ``torch.profiler``: the
      card's busy time, the histogram's part of it, its idle share and the
      kernel launches per tree;
6. the raw path, at the full width of the raw LendingClub table (146
   columns) and its scale (2.3M loans), ``today`` pinned:
   a. a 200,000-loan frame (seed 0) tokenized on the host and ingested on
      the card and on the CPU: the same `CleanReport` and `FeaturePlan`
      (medians within ``LOG_RTOL``), integer, categorical, one-hot,
      indicator and label columns bitwise equal, log1p-derived columns
      within ``LOG_RTOL``, bins of the columns log1p does not touch equal,
      the hashed split's masks equal;
   b. the main path: ``synthetic_lendingclub_frame(2_300_000, seed=0)``,
      `tokenize_raw_frame` on the host, `run_device_ingest` on the card,
      `drop_training_leakage`, the 20 serving features and the hashed
      split, then `GBDTClassifier.fit` with the committed configuration and
      the split's ``scale_pos_weight`` through the histogram kernel (300 x 7
      launches); rows, host and card seconds, peak card memory, held-out
      AUC and the classification report;
   c. the forest published with its `FeaturePlan` and served on the card:
      `ScorerService.predict_raw` on 64 raw rows of the table, each that
      survived cleaning bitwise equal to its ingested row, plus a payload
      with a missing numeric, an unknown grade and a missing hardship
      status; `fused_score` launches counted over the calls; then the
      kernel against its plain version on the trained forest at
      ``predict_raw``'s shape (one row, margin only): each matched row's
      kernel margin equals `fused_score_reference`'s on the card, bit for
      bit, and its prob, which is the response's, is within 1e-6;
   d. a SHAP launch made to fail on that service: ``/predict`` over HTTP
      answers 200, degraded, with the margin-only launch's probability,
      within 1e-6 of the plain version's;
7. the scoring split: at each bucket of phase 3 and each precision (f32,
   bf16, int8), the device time per call of the walk kernel
   (``shap_kernel`` or ``walk_kernel``) and of ``score_finalize_kernel``,
   from ``torch.profiler`` (last, as the profiler slows later launches),
   with the calls whose records the profiler kept;
8. the training protocol, `run_pipeline` from the raw table to a published
   artifact at full width (146 raw columns, 104 tree features after the
   leakage drop), ``today`` pinned; it runs before phase 7:
   a. card against CPU: one 50,000-loan frame through `run_pipeline` on
      the card and on the CPU under a cut profile whose candidates draw no
      row or column samples (`CHECK_PROFILE`): the same selected features,
      candidates, folds and best params, every CV job's AUC and the
      held-out AUC within 1e-4;
   b. the main path: phase 6's 2.3M-loan frame through `run_pipeline` with
      the reference CLI's quick profile (RFE in steps of 20 with a 20-tree
      depth-3 selector, a 4 x 2 search in ``"auto"`` chunks, so successive
      halving; rows and width not cut) into a store: the cleaned, tree and
      nn tables written as CSV and a manifest per stage (the seconds and
      bytes of the tables are printed), the halving report (rungs, chunk,
      survivors), seconds and histogram launches of each stage (each
      launch count as the stage's fits make them: one per tree level of a
      fit, of an RFE refit, and of a search bucket's jobs together, which
      boost in whole chunks up to the last rung of its candidate boosted
      furthest), the
      selected features, every candidate's mean CV AUC, the best params, CV
      and held-out AUC and peak card memory; ``metrics.json`` with the
      reference's keys, the artifact reloaded bit for bit, and 16 raw rows
      through `ScorerService.predict_raw` on it (margins bitwise equal to
      `fused_score_reference` on the same card tensor, prob within 1e-6);
      then the first tree's histograms, kernel against plain as in 5b, at
      the default RFE selector's shape (64 bins, the 104 features, depth
      6) and at a depth-9 candidate's (255 bins, the 20 selected features,
      up to K = 256 nodes);
9. the quantized forests, at the committed model's full width; it runs
   right after phase 4:
   a. the forest packed at bf16 and at int8 on the card and on the CPU,
      each through the publish gate (``pack_forest(check=True)``): the same
      table hash and tree records, and `quantization_report` on the card
      (the kernel) equal to the CPU's (the plain version) in its margin
      fields, its prob field within 1e-7; each precision's record bytes per
      tree;
   b. as phase 3, at each precision: the kernel against the plain version
      on phase 3's rows at the five buckets, margins bitwise (on the card,
      on the CPU, across two calls), then ms, plain ms and ``bound_ms``
      (the bytes of the quantized records and tables);
   c. as phase 4, a `ScorerService` at ``forest_precision="int8"`` on the
      card: ``/readyz`` reports ``int8`` and the table hash, responses
      match the plain int8 scorer on the CPU, and the launches are the
      warm-ups, the gate's two and one per micro-batch and bulk chunk.

10. the protocol's resumable, halving path, right after 8b, on its
    columns and its store:
    a. the quick search again on 8b's selected training columns and
       ``scale_pos_weight``, with halving and exhaustive: each survivor's
       split scores bitwise the exhaustive run's, the halving run bitwise
       8b's search, its chunk and rungs those the cost model and ladder
       give at this row count (26 and 75/150/300 at ~1.8M rows); wall
       seconds, launches (one per tree level of a bucket's jobs together)
       and joint launches of both, and the histogram's device ms per
       level over the first chunk of the winner's bucket, its jobs in one
       joint launch a level (CUDA events);
    b. `run_pipeline(raw=None, resume=True)` on 8b's store: ``clean``,
       ``engineer``, ``rfe`` and ``search`` restored, the refit's forest
       and held-out AUC bitwise 8b's; then, after
       ``PipelineCheckpoint.invalidate("search")``, the search rerun with
       results, artifact and selection bitwise 8b's; seconds to validate
       the manifests, to restore the tree CSV and of each run; 4 raw rows
       served by the resumed artifact (one launch each);
    c. card against CPU at 20,000 loans (cut from 8a's 50,000 for time,
       PR 16): RFECV of the quick
       selector (``support_``, ``ranking_`` equal, scores within 1e-6) and
       a search in chunks of 12 trees whose candidates draw nothing (the
       same halving report and winner, scores within 1e-4).

11. the observability of both main paths (`telemetry/`):
    a. right after phase 4, phase 4's traffic to the committed model on
       the card plus 4 bursts of 64 /predict held into one 64-row batch
       each; ``/metrics`` parsed with the port's `parse_exposition`: the
       ``score_forest`` programs' dispatches equal the
       ``fused_score.launches`` delta over the phase, their CUDA-event
       seconds are above 0, and the 64-row SHAP bucket's device ms per
       dispatch is printed beside phase 3's; ``cobalt_device_mem_bytes``
       present and `device_info`'s ``bytes_limit`` equal to
       ``mem_get_info``'s total; ``/debug/trace`` holds ``serve.dispatch``
       spans, ``/debug/slowest`` requests with their phases, ``/slo``
       answers, ``X-Request-ID`` is echoed and minted;
    b. on 8b's run: ``cobalt_pipeline_stage_seconds`` observed once per
       stage, equal to ``result.timings``; ``pipeline.run`` with every
       stage as a child span; the histogram programs' dispatches equal
       8b's ``hist_launches`` (``rfe`` at the selector's 64 bins,
       ``search`` at 255), their event seconds beside the stages';
    c. the training CLI in a subprocess at 200,000 loans with
       ``--ledger-out`` and ``--trace-out``: the ledger loads, its program
       table has the histogram programs with dispatches, event seconds
       and the H100 roofline estimate and every ``ingest.*`` step of the
       device ingest with dispatches and event seconds, and the trace
       parses;
    d. 10,000 recorded dispatches timed on the host (µs each), and that
       times 5c's launches as a share of 5c's fit wall.

12. the serving contract past the happy path, right after phase 9, each
    part on its own `ScorerService` on the card behind the HTTP server,
    over a temporary store holding the committed model (A), the same
    forest cut to its first 150 trees (B) and a poisoned ``.npz``:
    a. admission: 32 concurrent /predict against ``max_in_flight=4`` (the
       batcher held, so exactly 4 are admitted) and 40 at once against 50
       requests/s with a burst of 8 (on a held service clock; one more
       admitted once 30 ms of it passed): every answer 200 or a typed 429
       with ``Retry-After``, the counts equal to
       ``cobalt_admission_admitted_total`` and
       ``cobalt_admission_shed_total{gate}``, one launch per micro-batch;
    b. the score cache: 16 distinct payloads, then the same 16 respelled
       (aliases, ints and floats, key order): 16 hits, no launch and no
       program dispatch, the bodies bit for bit; ms per hit and per miss;
    c. hot reload under load: 8 client threads send /predict with 64 fixed
       rows for 1 s, then for about 3 s more while 10 ``POST /admin/reload``
       swap A -> B -> A ... and one to the poisoned key rolls back (500
       ``reload_failed``):
       every answer is its row's probability under A or B bit for bit (the
       kernel's, scored directly first), every micro-batch (the request
       ids of its ``serve.microbatch_dispatch`` span) is all A or all B,
       requests sent after a swap returned get the new model, a payload
       cached under A answers with B's probability after a swap, the
       launches are the micro-batches plus each candidate's warm-up and
       smoke launches, and ``cobalt_device_mem_bytes`` after the swaps is
       within one model's bytes of its value before; reload wall seconds
       and the requests' p50/p99 during the swaps and in the first second;
    d. the watchdog: the worker killed (a `BaseException` raised in Python
       before the launch) holding a batch of 8 queued /predict: 8 typed 500
       ``worker_dead``, one restart in
       ``cobalt_microbatch_worker_restarts_total`` and ``/readyz``, and the
       next /predict scored on the card with its row's kernel bits;
    e. the breaker: every store read failing, three reloads roll back and
       the fourth answers 503 ``circuit_open`` with ``Retry-After`` without
       reading; the store back and 0.5 s passed, the reload swaps and the
       breaker walked open -> half_open -> closed; /predict 200 throughout.

13. the data layer's remaining paths (``today`` pinned; no step falls back:
    the native reader is built with ``g++`` beside the kernels and read with
    ``engine="native"``):
    a. right after phase 6, 6a's 200,000-loan frame through the host path
       (`clean_raw_frame`, `prepare_cleaned_frame`, `engineer_features` on
       the card) against `run_device_ingest` on the card: the same
       `CleanReport` and `FeaturePlan` (but its ``asof``; medians within
       ``LOG_RTOL``), tree and nn columns bitwise except the log1p-derived
       ones (within ``LOG_RTOL``), the same labels; and the host path's
       engineering on the card against the CPU's, alike;
    b. 6b's 2.3M-loan frame through the host path on the card, once: the
       seconds of clean, prepare and engineer beside 6b's tokenize and card
       ingest seconds, rows and peak card memory; its tree table held to
       6b's as in 13a;
    c. after phase 10b, 8b's stored cleaned, tree and nn tables read with
       the native reader (seconds and MB/s of each); the first eighth of
       the cleaned and tree tables (cut at a row boundary outside quotes;
       cut from the whole tables for time in PR 16: those codec reads took
       109 s) read with the native reader and with `csv_to_frame` (equal
       frames, the codec's seconds and MB/s; the nn table, numeric as the
       tree table is, no longer goes through the codec: that read took
       27-36 s); 10b's restore of the tree table (through `load_frame`, so
       the native reader) in seconds;
    d. after phase 11, ``--pandas-ingest`` end to end: `bootstrap_synthetic`
       writes a 200,000-loan raw table into a `DatasetRegistry`, pulled and
       verified into a store's ``raw_key``; the training CLI in a subprocess
       on the card (``--quick --pandas-ingest``) with histogram launches per
       stage as 8b counts them and equal to its ledger's programs; 16 raw
       rows through `predict_raw` on its artifact, margins bitwise
       `fused_score_reference`'s and prob within 1e-6; then, with the
       ``engineer`` manifest invalidated, ``--resume`` skips ``clean`` only
       and publishes the same forest bit for bit; and 11c's (device-path)
       ledger's ``ingest.*`` program rows, each with dispatches and
       CUDA-event seconds above 0, listed.

14. the continuous-training loop at the committed width (300 trees of
    depth 7, the 20 serving features; each retrain by `tools.retrain` on
    200,000 loans, cut from 2.3M for time), after phase 13, on one
    `ScorerService` on the card with ``canary_enabled`` behind the HTTP
    server, over a temporary store behind a `FaultInjectingStore`, on a
    held service clock; both kernels' launches counted from 0 before it:
    a. `retrain_candidate(..., bootstrap=True)` gives v1 in ``latest``: wall
       seconds, 2,100 histogram launches (one per tree level), and the
       published ``dataset_md5`` equal to the md5 of the matrix and labels
       the fit was given; as the reference's default, it also trains the
       MLP challenger and publishes it as ``gbdt_mlp`` v1 to ``canary``
       (``report["challenger"]``), an `MLPArtifact` whose weights and
       scaler read back onto the card bit for bit;
    b. the service serves the registry's ``latest`` (``model_version``
       ``v1``); v2 (seed + 1) published to ``canary`` and loaded (its
       warm-up launches counted), shown loaded by ``/readyz``; 256 distinct
       /predict in bursts of 16, then ``flush``: each shadow row one
       margin-only launch at bucket 1 (launches = shadowed rows = the
       ``score_forest/f32/1/margin`` program's dispatches), its margin
       bitwise `fused_score_reference`'s on v2's pack on the card and its
       probability within 1e-6 of the plain version's (the host sigmoid of
       the margin, bit for bit); ``POST /admin/promote`` answers 200, later
       answers say ``v2`` and ``cobalt_model_info`` moved;
    c. a label-shuffled v3 shadowed by 128 /predict: ``POST /admin/promote``
       answers 409 ``promotion_rejected`` with the gate's reasons, and
       ``latest`` is unchanged;
    d. ``POST /admin/rollback`` restores v1 (``previous`` = v2); a forced
       promotion of v3, then 5xx driven through ``observe_request`` with
       the clock moved past the SLO cache each time, until the guard
       window rolls back to v1 (``trigger="slo_fast_burn"``);
    e. drift against v1's training sketch: 2,000 rows of a fresh table keep
       every feature's PSI under ``drift_psi_alert`` and the alarm off;
       1,000 rows with ``loan_amnt`` moved past every training value raise
       its PSI over the alert (the others stay under),
       ``cobalt_drift_alarm`` reads 1, and ``on_drift`` fires once, not
       again while in alarm;
    f. the store's reads failing: three reloads 500, the fourth 503; the
       store back and the clock moved, the reload swaps (breaker open ->
       half_open -> closed); ``/events`` holds the 16 events in order
       (reload publishes and rollbacks, the canary's promotes, reject and
       rollbacks, the breaker's transitions), their causes (gate, forced,
       trigger, error, failure count), and each action's log line carries
       its ``event_id``; the trace export's ``journal_event_count`` is the
       journal's; after ``close`` the shipped segments read back through
       `load_events` hold every event;
    g. the bytes the live tensors asked for (``requested_bytes``) equal
       before the cycle, after the automatic rollback and at its end (the
       last canary dropped), and ``cobalt_device_mem_bytes`` within one
       served model's bytes of its value before, as 12c holds it: the gauge
       counts the caching allocator's blocks, and a cached block reused
       unsplit counts more than was asked for.

15. the serving fleet, after phase 14: `ReplicaSet.from_store` with 4
    replicas of the committed model (300 trees, depth 7, F=20, f32) on the
    one card behind the HTTP server, served from a temporary registry's
    ``latest`` with the forest's first half as ``canary`` (every /predict
    shadowed), a 2 s request deadline, the supervisor ticked by hand;
    ``score_forest``'s launches counted from 0 just before it:
    a. ``/readyz`` shows 4 replicas on ``cuda:0``, each on the kernel; 256
       /predict in bursts of 16 and two 4096-row bulk CSVs: the routed
       counts sum to the requests and every replica gets some, the programs'
       dispatches equal the launches and the warm-ups, micro-batches, bulk
       chunks and shadow rows, every launch's margins bitwise the plain
       version's on the CPU;
    b. replica 1's worker killed before its launch (`ChaosPlan.kill_worker`):
       a burst answers 200 throughout, at least one row hedged, the worker
       restarted;
    c. an error storm on replica 2: bursts of 32 until its EWMA quarantines
       it, then a tick drains, rebuilds on the card, smoke-checks, swaps and
       readmits it; its margins bitwise the old replica's; ``/events``
       holds healthy -> degraded -> quarantined -> restarting -> rebuild ->
       swap -> healthy, each chained to its cause;
    d. replica 3 hung before its launch: its callers answer a typed 504
       inside the deadline (the others 200), the queue-age watchdog (or the
       probes) quarantine it and the next tick heals it;
    e. ``POST /admin/quarantine`` of three replicas, the fourth refused 422,
       a bad index 422, the one /predict routed to the routable one, a tick
       heals no manual quarantine, ``/admin/readmit`` of the three, again
       422;
    f. the brownout ladder to rungs 1, 2, 4 and 5: no shadow rows from rung
       1 on, ``degraded: true`` with null SHAP and only margin-only programs
       at rungs 2 and 4, bulk 429 with ``Retry-After`` at 4, everything 429
       at 5; released, full answers and shadows again; the ten steps in the
       journal;
    every /predict answer typed, each 200 the plain version's (prob within
    1e-6, SHAP of 15a-b within 1e-5);
    g. ``requested_bytes`` equal once the fleet is built, after each heal
       (the old replica closed), and back to its start after ``close``;
       ``cobalt_device_mem_bytes`` within the largest served model's
       allocator blocks.
16. the fleet's load control: two replicas of the committed model on the
    card behind the HTTP server (a temporary registry's ``latest``), the
    autoscaler on with a queue-wait high mark of 1 ms, the history sampled
    and the autoscaler ticked by hand on one held clock:
    a. a seeded open-loop flash crowd (20 -> 400 requests/s over 6 s,
       `reliability.TrafficGenerator`) in 0.5 s slices, a sample and a tick
       after each: the fleet grows 2 -> 4, one replica per tick, the second
       only past the 5 s cooldown, each new replica built on ``cuda:0``
       with its warm-up launches and the smoke row and then routed to; the
       first tick's retune publishes (5 ms, 256 rows), after which two
       bursts held under the pause gate coalesce into one 128-row and one
       256-row SHAP launch per replica; every launch's margins (the new
       replicas' and the wide ones') bitwise the plain version's on the CPU;
    b. an SLO engine whose p99/p99.9 objectives (0.1 ms) every round trip
       misses: at the ceiling the ladder engages rungs 1, 2, 3, one per
       tick; then the load clears and it releases one rung per tick, the
       retune back to (2 ms, 64 rows), and after 3 idle ticks past the
       scale-down cooldown the fleet retires to 2 replicas, twice;
    c. ``GET /history`` (the catalog and the /predict p99 series),
       ``GET /dashboard`` (the latency, QPS, queue-depth and memory panels
       drawn), ``/readyz``'s ``autoscaler`` block, ``POST
       /admin/autoscaler`` (pause, resume, status, force 3, force 9 422,
       force 2) and ``/events``: every resize, retune and brownout step in
       order, each with its cause, the scale-ups' admission rescales
       chained to them;
    d. every answer a 200 (no untyped error), prob within 1e-6 and SHAP
       within 1e-5 of the plain version; no scale-up failed;
       ``requested_bytes`` equal once built, after the retirements and
       after the forced resize, and back to its start after ``close``; the
       programs' dispatches equal the launches.

17. the challenger model families, after phase 16, on the reference's
    model benchmark data (``tools/bench_models.py``: 262,144 loans of seed
    13, the host cleaning path, the nn frame without the leakage block, the
    hashed split, NaN as 0; the label-code columns split off for
    FT-Transformer, vocabularies ``len(vocab) + 1``), each family at its
    config's full width (MLP 128/32/16, batch 1024, 30 epochs, patience 5;
    FT-Transformer d_token 64, 3 blocks, 8 heads, ffn x2, dropout 0.1,
    batch 1024, 20 epochs; TabNet 4 steps of width 32, batch 4096, 30
    epochs; logistic regression's 25 Newton steps), no kernel of the port
    on its path (the networks are plain PyTorch, as the reference's are
    plain XLA):
    a. the same seed-0 weights on the card and on the CPU give logits on
       4,096 test rows within 1e-4 (TF32 off);
    b. 3 full-batch epochs on 2,048 rows from one state_dict (dropout 0) on
       the card and on the CPU: losses within 1e-5 relative, parameters
       within 1e-5 (FT's attention key bias and all of TabNet, whose
       gradients are noise or flip with a sparsemax support, within lr per
       update); logistic regression fitted on those rows on both, within
       1e-4 absolute plus relative;
    c. each family fitted on the full training rows: epochs run, fit
       seconds, rows per second and held-out AUC, which must reach 0.90
       (FT-Transformer at 5 epochs and TabNet at 8 in the whole run, cut
       for time, and at their 20 and 30 under ``--only-challengers``);
    d. a second MLP fit of the same seed equals the first bit for bit.

18. the offline portfolio stress path (`scenario`), after phase 17, at the
    committed model's full width (300 trees of depth 7, F=20, f32): a
    synthetic book of 262,144 loans (seed 29, ``tools.score_portfolio``'s
    default) through the host cleaning path (``today`` pinned) to the 20
    serving features, written as a CSV object and read back with
    `load_portfolio`; the committed model published to a temporary
    registry's ``latest`` with a `FeatureSketch` of the book's features as
    its ``feature_sketch``; the README's grid (``installment`` +25/+50/+100
    x ``loan_amnt`` x0.9, so 4 passes over the book) in chunks of 2,048
    rows, each one SHAP launch of ``score_forest`` at the 2048-row bucket:
    a. the uninterrupted sweep: ``python -m
       cobalt_smart_lender_ai_tpu_torch.tools.score_portfolio`` on the card
       over the whole book with ``--ledger-out``, then the port's
       ``tools.obs_report --min-attribution 0.8`` on the ledger (exit 0);
       the ledger's ``score_forest/f32/2048/shap`` dispatches (the tool's
       launches) = its ``cobalt_portfolio_dispatches_total{kind="shap"}``
       = 4 x chunks, finite scores; seconds, rows per second, the
       attribution ratio and the report's blocks;
    b. `PortfolioScorer.from_registry` in this process, the same sweep
       killed after 37 chunks (``fail_after_chunks``) and resumed: each
       run's launches = the engine's dispatches = the program's; every
       chunk's ``scores``, ``phi_sum``, ``base`` and ``n`` equal the
       tool's run's bit for bit; the seconds inside the checkpoint's
       ``advance``;
    c. two 2048-row chunks of the book and ``ScorerService.shap_bulk``'s
       two 4096-row chunks against the plain version on the card (margins
       bitwise, phis within 1e-5, additivity within 1e-4; shap_bulk's phis
       within 1e-5), each SHAP launch's margins equal to the margin-only
       launch's bit for bit; the 2048- and 4096-row SHAP times per launch
       (CUDA events) against their bounds, and the plain call's ms;
    d. (the launches of 18b, counted from 0 before it, are the
       ``kernels`` line's ``portfolio_launches``, the tool's its
       ``portfolio_tool_launches``, shap_bulk's 2 its
       ``shap_bulk_launches``);
    e. under ``--only-portfolio`` only, the sweep again on a book of
       2,300,000 loans: its seconds, rows per second and the seconds inside
       ``advance``;
19. the mesh, the card named four times (`device.mesh_devices`, each entry
    a shard on its own CUDA stream), before the scoring split:
    a. `fit_binned_dp` on a (1, 4) mesh, 50 trees of depth 7 (cut from 300),
       no row sample, on 5's 1.84M rows: one accumulate launch a shard a
       level, one finalize a level (the main path's launches, counted from
       0: the ``kernels`` line's ``gradient_histogram_sharded``); its first
       tree's splits bit for bit the single direct fit's, held-out AUC
       within 1e-4, the max |margin| difference; at levels 0, 4 and 6 of
       that fit's first tree the sharded entry bit for bit one launch, its
       cover bit for bit and g and h within 1e-5 of each node's largest
       |value| against its plain version (the shards' float64 partials), and
       one shard's accumulate launch's ms, the whole sharded call's, the
       one launch's, the plain accumulate's, the library's and the bound
       at the shard's rows;
    b. a CV bucket (2 candidates x 2 folds, 4 trees of depth 6) over a
       (2, 1) mesh bit for bit one device's, over a (2, 2) mesh within
       1e-4 of one device's direct fit;
    c. `MeshPartitioner` bulk SHAP at 4 x 1024 rows bit for bit
       `SingleDevicePartitioner`'s at f32, bf16 and int8, 4 launches a
       dispatch on the ``.../shards=4`` program row;
    d. `ScorerService` with ``bulk_shards=4`` over HTTP answers one
       ``/predict_bulk_csv`` of 5,000 rows with the one-device service's
       probabilities bit for bit, one launch a shard a chunk;
    e. the device ingest of 100,000 loans with four ingest shards gives the
       one-device tables bit for bit;
    f. two processes on the card (this script with ``--mesh-worker``), gloo
       over card tensors: an ``all_reduce``, the (1, 2) global mesh and a
       dp fit (1.84M rows, 5 trees of depth 7) bit for bit the one-process
       fit over the card named twice.
20. the operator's layer, after phase 19 and before the scoring split
    (phase 7), with the build cache bootstrapped at startup
    (`compilecache.bootstrap_compile_cache`, before the first build):
    a. ``tools.train_artifact.main`` at its defaults (130,000 loans of seed
       11, the committed model's configuration: 300 trees of depth 7, 255
       bins, samples 0.8) into a temporary store, on the card: 101,311
       training rows; bin edges bit for bit the committed artifact's in the
       date-free columns log1p does not derive, within 3e-7 in the
       date-free log1p columns (torch's and XLA's float32 log1p differ by
       an ulp), ``earliest_cr_line_days``' difference reported (it counts
       days before the run's date); the test AUC within 0.01 of the
       committed 0.9347 (the card's Philox draws other samples than JAX);
       2,100 histogram launches, equal to the program registry's
       dispatches; host-prep, fit and wall seconds;
    b. the port's HTTP server serves 20a's artifact on the card and
       `ui.core.ApiClient` talks to it: the default form through
       `build_single_payload` to /predict, its waterfall's ``fx`` equal to
       the base value plus the phis and to the plain scorer's margin of the
       row within 1e-5; a 256-row bulk CSV through `coerce_results_frame`,
       4 of its rows through `results_row_payload` back to /predict, each
       probability the bulk row's within 1e-6; `importance_series` of
       /feature_importance_bulk sorted; the admission cap held, the client
       raises `ServiceDegraded` ``shed``;
    c. ``tools.incident_report --require-cause`` over phases 15's and 16's
       journals (a bench-shaped record) exits 0, its report listing a
       quarantine chain with its time to healthy and the resizes;
    d. the build cache's counters: in this process after its startup
       builds 3 misses and 3 builds (a fresh checkout) or 3 hits and no
       build (``_build/`` warm); in 11c's training CLI, a second process,
       no build, at least one hit and the recorded seconds saved;
    e. last (a profiler session slows the launches after it):
       `debug.profile_trace` around 8 warm-up and 16 measured /predict
       micro-batches to 20b's service: the trace parses and holds the
       ``serve.microbatch_dispatch`` spans and the card's records of
       ``shap_kernel<7>`` and ``score_finalize_kernel``;
    ``score_forest``'s launches over 20b-20e, counted from 0 before 20b,
    equal the programs' dispatches (the ``kernels`` line's
    ``operator_launches``; 20a's histogram launches its
    ``train_artifact_launches``).

The script's seconds in all come on a line before ``{"kernels": [...]}``,
which is the line before the last; the last is ``{"ok": true, "device":
{...}}``. Exits non-zero, printing neither, when
CUDA is unavailable or any phase fails. ``--only-scoring`` runs phases 1-4,
9 and 7 (the short loop for work on ``csrc/score_forest.cu``) and prints
neither line; ``--only-lifecycle`` builds and runs phase 14,
``--only-fleet`` phase 15 and ``--only-autoscaler`` phase 16, and print
neither; ``--only-challengers`` runs phase 17 alone (it builds nothing:
no kernel is on its path) and prints neither; ``--only-portfolio`` builds,
then runs phase 18 and its full-book sweep (18e), and prints neither. ``--full-protocol`` builds, then runs phase 8b with the
reference's default `RFEConfig` (104 -> 20 features at step 1, 84 refits of
50 trees) and `TuneConfig` (20 candidates x 3 folds, every candidate to its
full ``n_estimators``) on a new 2.3M-loan frame, and prints neither line.
``--only-mesh`` builds, then runs phase 19 alone, and prints neither.
``--only-tools`` builds, then runs phases 15 and 16 (for their journals)
and phase 20, with the serve CLI's ``--profile-dir`` in a subprocess on
20a's artifact (its /metrics the second process's build counters for 20d,
its trace holding the micro-batch spans and the SHAP kernel), and prints
neither.
``--only-search`` builds, then runs 5b's joint launches and the search
bucket's check (the short loop for work on the job axis), and prints
neither: the reference-default (9, 100) bucket's 15 jobs on phase 5's
1.84M training rows, boosted for `SEARCH_CHUNKS` chunks of
`SEARCH_CHUNK_TREES` trees (cut from 100 for time) with their margins
carried, once jointly (one `fit_binned_jobs` call a chunk: one launch per
tree level for all 15) and once job by job (`fit_binned_resumable`: one
launch per tree level per job); each job's margins and forest chunks
bitwise equal; the seconds and launches of both.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import copy
import dataclasses
import gc
import hashlib
import http.client
import io
import json
import logging
import math
import re
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.error
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime
from pathlib import Path
from typing import Callable

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from cobalt_smart_lender_ai_tpu_torch.config import (
    DataConfig,
    FTTransformerConfig,
    GBDTConfig,
    MeshConfig,
    MLPConfig,
    PipelineConfig,
    ReliabilityConfig,
    RFEConfig,
    ServeConfig,
    TuneConfig,
)
from cobalt_smart_lender_ai_tpu_torch import device as port_device
from cobalt_smart_lender_ai_tpu_torch import native
from cobalt_smart_lender_ai_tpu_torch.compilecache import bootstrap_compile_cache, compile_stats
from cobalt_smart_lender_ai_tpu_torch.data import schema
from cobalt_smart_lender_ai_tpu_torch.data.bootstrap import bootstrap_synthetic
from cobalt_smart_lender_ai_tpu_torch.data.clean import clean_raw_frame
from cobalt_smart_lender_ai_tpu_torch.data.device_pipeline import (
    run_device_ingest,
    tokenize_raw_frame,
    transform_raw_rows,
)
from cobalt_smart_lender_ai_tpu_torch.data.features import (
    FeatureFrame,
    drop_training_leakage,
    engineer_features,
    prepare_cleaned_frame,
)
from cobalt_smart_lender_ai_tpu_torch.data.frame import RawFrame, row_dicts
from cobalt_smart_lender_ai_tpu_torch.data.split import split_mask, train_test_split_hashed
from cobalt_smart_lender_ai_tpu_torch.data.synthetic import synthetic_lendingclub_frame
from cobalt_smart_lender_ai_tpu_torch.debug import profile_trace
from cobalt_smart_lender_ai_tpu_torch.io import (
    DatasetRegistry,
    GBDTArtifact,
    MLPArtifact,
    ModelRegistry,
    ObjectStore,
)
from cobalt_smart_lender_ai_tpu_torch.io.frames import csv_to_frame
from cobalt_smart_lender_ai_tpu_torch.models import (
    MLP,
    FTTransformer,
    FTTransformerClassifier,
    LogisticRegression,
    MLPClassifier,
    TabNet,
    TabNetClassifier,
    TabNetConfig,
    gbdt,
)
from cobalt_smart_lender_ai_tpu_torch.models.ft_transformer import StandardStats
from cobalt_smart_lender_ai_tpu_torch.models.linear import LogisticRegressionParams
from cobalt_smart_lender_ai_tpu_torch.models.nn import MinMaxStats, seeded_generator
from cobalt_smart_lender_ai_tpu_torch.models.train_loop import TrainSettings, fit_binary
from cobalt_smart_lender_ai_tpu_torch.ops import _build
from cobalt_smart_lender_ai_tpu_torch.ops.binning import compute_bin_edges, transform
from cobalt_smart_lender_ai_tpu_torch.ops.histogram import _program as histogram_program
from cobalt_smart_lender_ai_tpu_torch.ops.histogram import (
    gradient_histogram_sharded,
    histogram_accumulate,
    histogram_finalize,
    histogram_partial_reference,
    histogram_scale_state,
    reduce_scale_states,
    gradient_histogram_channels,
    gradient_histogram_jobs,
    gradient_histogram_jobs_reference,
    gradient_histogram_reference,
    histogram_cost,
)
from cobalt_smart_lender_ai_tpu_torch.ops.metrics import binary_classification_report, roc_auc
from cobalt_smart_lender_ai_tpu_torch.ops.score import (
    fused_score,
    fused_score_reference,
    pack_forest,
    quantization_report,
    score_cost,
    tree_table_layout,
)
from cobalt_smart_lender_ai_tpu_torch.parallel.budget import resolve_chunk_trees
from cobalt_smart_lender_ai_tpu_torch.parallel.distributed import (
    DistributedConfig,
    init_distributed,
    make_global_mesh,
)
from cobalt_smart_lender_ai_tpu_torch.parallel.mesh import make_mesh
from cobalt_smart_lender_ai_tpu_torch.parallel.partitioner import (
    MeshPartitioner,
    SingleDevicePartitioner,
    make_partitioner,
)
from cobalt_smart_lender_ai_tpu_torch.parallel.sharded import fit_binned_dp
from cobalt_smart_lender_ai_tpu_torch.parallel.rfe import SELECTOR_BINS, rfe_select
from cobalt_smart_lender_ai_tpu_torch.parallel.tune import (
    _pow2_jobs,
    cross_validate_gbdt,
    halving_ladder,
    randomized_search,
    sample_candidates,
    search_buckets,
    stratified_kfold_masks,
)
from cobalt_smart_lender_ai_tpu_torch.pipeline import (
    STAGES,
    PipelineResult,
    quick_config,
    run_pipeline,
    stage_fingerprints,
)
from cobalt_smart_lender_ai_tpu_torch.reliability import (
    ChaosPlan,
    FaultInjectingStore,
    FaultSpec,
    PipelineCheckpoint,
    TenantPopulation,
    TrafficGenerator,
    shape_by_name,
)
from cobalt_smart_lender_ai_tpu_torch.scenario import (
    PortfolioInterrupted,
    PortfolioScorer,
    ScenarioGrid,
    load_portfolio,
)
from cobalt_smart_lender_ai_tpu_torch.serve.http_asyncio import make_async_server
from cobalt_smart_lender_ai_tpu_torch.serve.replicas import ReplicaSet
from cobalt_smart_lender_ai_tpu_torch.serve.service import ScorerService
from cobalt_smart_lender_ai_tpu_torch.serve.supervisor import HEALTHY, QUARANTINED
from cobalt_smart_lender_ai_tpu_torch.telemetry import (
    FeatureSketch,
    SLOEngine,
    chrome_trace,
    default_objectives,
    default_program_registry,
    default_registry,
    default_tracer,
    device_info,
    load_events,
    load_ledger,
    parse_exposition,
)
from cobalt_smart_lender_ai_tpu_torch.telemetry.programs import (
    ProgramHandle,
    peak_bytes_estimate,
    peak_flops_estimate,
)
from cobalt_smart_lender_ai_tpu_torch.tools import incident_report, obs_report, train_artifact
from cobalt_smart_lender_ai_tpu_torch.tools.retrain import retrain_candidate
from cobalt_smart_lender_ai_tpu_torch.tools.score_portfolio import build_synthetic_portfolio
from cobalt_smart_lender_ai_tpu_torch.ui import core as ui_core

ROOT = Path(__file__).resolve().parent
STORE = ROOT / "artifacts"
MODEL_KEY = ServeConfig.model_key
SEED = 0

#: Published H100 SXM peaks (NVIDIA data sheet), the program registry's:
#: HBM3 bytes/s and FP32 (non-tensor-core) FLOP/s.
HBM_BYTES_PER_S = peak_bytes_estimate("NVIDIA H100")
FP32_FLOP_PER_S = peak_flops_estimate("NVIDIA H100")

TOL_PROB = 1e-6
TOL_PHIS = 1e-5
TOL_ADDITIVITY = 1e-4
#: (rows, with SHAP) of the scoring checks: the /predict micro-batch buckets
#: and two bulk chunk sizes.
BUCKETS = ((1, True), (8, True), (64, True), (256, False), (4096, False))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def seeded_rows(pack, n: int, seed: int = SEED) -> np.ndarray:
    """(n, F) float32 rows straddling the forest's own thresholds (so every
    branch is taken), with about 10% NaN cells (missing directions)."""
    rng = np.random.default_rng(seed)
    thr = pack.thr.cpu().numpy()
    feat = pack.feature.cpu().numpy()
    X = rng.normal(size=(n, pack.n_features)).astype(np.float32)
    for f in range(pack.n_features):
        vals = thr[(feat == f) & np.isfinite(thr)]
        if vals.size:
            jitter = 1.0 + 0.05 * rng.normal(size=n).astype(np.float32)
            X[:, f] = rng.choice(vals, n) * jitter
    X[rng.random(X.shape) < 0.1] = np.nan
    return X


def _bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time of work that moves ``nbytes`` and does ``flops``: the
    larger of bytes over HBM bandwidth and FP32 operations over the FP32
    peak, in ms, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_ms(pack, n_rows: int, with_shap: bool) -> tuple[float, str]:
    """Least time the card could take for one `fused_score` call, from
    `score_cost`'s count of its bytes (each input read once, each output
    written once; the forest at its stored precision) and FP32
    operations."""
    return _bound(*score_cost(n_rows, pack.n_trees, pack.depth, pack.n_features,
                              pack.precision, with_shap))


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(kernel_out, plain_out, with_shap: bool) -> dict:
    """Kernel vs plain on the same inputs; raises on any disagreement."""
    km, kp = kernel_out[0].cpu(), kernel_out[1].cpu()
    pm, pp = plain_out[0].cpu(), plain_out[1].cpu()
    if not torch.equal(km, pm):
        raise AssertionError(
            f"margins differ: max |d| = {float((km - pm).abs().max())}"
        )
    err = {"prob": float((kp - pp).abs().max())}
    if err["prob"] > TOL_PROB:
        raise AssertionError(f"prob differs by {err['prob']} > {TOL_PROB}")
    if with_shap:
        kphi, pphi = kernel_out[2].cpu(), plain_out[2].cpu()
        base = float(kernel_out[3])
        err["phis"] = float((kphi - pphi).abs().max())
        err["additivity"] = float((base + kphi.sum(1) - km).abs().max())
        if not bool(torch.isfinite(kphi).all()) or err["phis"] > TOL_PHIS:
            raise AssertionError(f"phis differ by {err['phis']} > {TOL_PHIS}")
        if err["additivity"] > TOL_ADDITIVITY:
            raise AssertionError(
                f"base + sum(phis) misses the margin by {err['additivity']}"
            )
    return err


def kernel_phase(device: str = "cuda", precision: str = "f32") -> list[dict]:
    """score_forest vs its plain version at the serving buckets, on the
    committed forest packed at ``precision``; returns one record per bucket
    (errors, times, bound). The rows are phase 3's at every precision."""
    art = GBDTArtifact.load(ObjectStore(str(STORE)), MODEL_KEY, device)
    F = len(art.feature_names)
    f32_pack = pack_forest(art.forest, F)
    pack = f32_pack if precision == "f32" else pack_forest(art.forest, F, precision)
    cpu_pack = pack_forest(art.forest.to("cpu"), F, precision)
    records = []
    for bucket, with_shap in BUCKETS:
        Xn = seeded_rows(f32_pack, bucket, SEED + bucket)
        X = torch.from_numpy(Xn).to(device)
        out = fused_score(pack, X, n_features=F, with_shap=with_shap)
        plain = fused_score_reference(pack, X, n_features=F, with_shap=with_shap)
        err = compare(out, plain, with_shap)
        again = fused_score(pack, X, n_features=F, with_shap=with_shap)
        if not torch.equal(out[0], again[0]):
            raise AssertionError(f"bucket {bucket}: two calls give other margins")
        if with_shap and not torch.equal(out[2], again[2]):
            raise AssertionError(f"bucket {bucket}: two calls give other phis")
        # The margins are also the CPU plain version's, bit for bit.
        cpu_margin = fused_score_reference(
            cpu_pack, torch.from_numpy(Xn), n_features=F, with_shap=False
        )[0]
        if not torch.equal(out[0].cpu(), cpu_margin):
            raise AssertionError(f"bucket {bucket}: margins differ from the CPU")
        rec = {"bucket": bucket, "with_shap": with_shap, "precision": precision, **err}
        if device == "cuda":
            kreps = 20 if with_shap else 200
            rec["ms"] = time_ms(
                lambda: fused_score(pack, X, n_features=F, with_shap=with_shap), kreps
            )
            rec["plain_ms"] = time_ms(
                lambda: fused_score_reference(pack, X, n_features=F, with_shap=with_shap),
                3,
                warmup=1,
            )
            rec["bound_ms"], rec["bound_by"] = bound_ms(pack, bucket, with_shap)
        records.append(rec)
    return records


def _post(url: str, body: bytes, content_type: str) -> dict:
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": content_type}, method="POST"
    )
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def _get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


def request_rows(n: int, seed: int = SEED) -> list[dict]:
    """``n`` valid /predict payloads: floats for continuous fields, 0/1 ints
    for the one-hot indicators, aliases for the two names with spaces."""
    rng = np.random.default_rng(seed)
    alias = {v: k for k, v in schema.SERVING_FIELD_ALIASES.items()}
    rows = []
    for _ in range(n):
        row = {}
        for name in schema.SERVING_FEATURES:
            key = alias.get(name, name)
            if name in schema.SERVING_INT_FEATURES:
                row[key] = int(rng.integers(0, 2))
            elif name == "term":
                row[key] = float(rng.choice([36.0, 60.0]))
            else:
                row[key] = float(np.round(rng.uniform(0, 1) * 10 ** rng.integers(0, 5), 3))
        rows.append(row)
    return rows


def serving_phase(
    device: str = "cuda",
    n_requests: int = 32,
    bulk_rows: int = 5000,
    store_root: Path = STORE,
    model_key: str = MODEL_KEY,
    precision: str = "f32",
) -> dict:
    """The port's serving path over HTTP, with the forest packed at
    ``precision``: concurrent /predict, one bulk CSV, one importance
    request. Counts kernel launches over the whole phase: at startup one
    per warmed bucket, plus at bf16 and int8 the publish gate's two (the
    quantized pack's probe rows and its f32 reference's)."""
    store = ObjectStore(str(store_root))
    fused_score.launches = 0
    config = ServeConfig(model_key=model_key, forest_precision=precision)
    service = ScorerService.from_store(store, config, device=device)
    warm = fused_score.launches
    warmed = service._model.warm_buckets
    gate = 0 if precision == "f32" else 2
    if device == "cuda" and warm != len(warmed["shap"]) + len(warmed["margin"]) + gate:
        raise AssertionError(f"{warm} startup launches for the buckets {warmed} and "
                             f"{gate} gate launches")
    server = make_async_server(service, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{server.port}"
    try:
        assert _get(base + "/healthz") == {"status": "ok"}
        rows = request_rows(n_requests)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=n_requests) as pool:
            resps = list(
                pool.map(
                    lambda r: _post(base + "/predict", json.dumps(r).encode(), "application/json"),
                    rows,
                )
            )
        predict_s = time.perf_counter() - t0
        Xb = seeded_rows(service._model.pack, bulk_rows, SEED + 1)
        names = service.feature_names
        lines = [",".join(f'"{n}"' for n in names)]
        lines += [",".join("" if np.isnan(v) else repr(float(v)) for v in r) for r in Xb]
        t0 = time.perf_counter()
        bulk = _post(base + "/predict_bulk_csv", "\n".join(lines).encode(), "text/csv")
        bulk_s = time.perf_counter() - t0
        imp = _post(
            base + "/feature_importance_bulk",
            json.dumps({"data": rows[:2]}).encode(),
            "application/json",
        )
        ready = _get(base + "/readyz")
    finally:
        server.close()
        service.close()
    if (ready["precision"], ready["quant_table"]) != (precision, service._model.pack.table_hash):
        raise AssertionError(f"/readyz reports {ready['precision']} {ready['quant_table']}")
    launches = fused_score.launches
    batches = ready["microbatch"]["batches"]
    bulk_chunks = -(-bulk_rows // service.config.max_batch_rows)
    if device == "cuda" and (launches == 0 or launches - warm != batches + bulk_chunks):
        raise AssertionError(
            f"{launches - warm} launches for {batches} micro-batches and "
            f"{bulk_chunks} bulk chunks: expected one launch each"
        )

    # Check the answers against the plain version on the CPU.
    art = GBDTArtifact.load(store, model_key, "cpu")
    F = len(art.feature_names)
    cpu_pack = pack_forest(art.forest, F, precision)
    Xr = torch.tensor(
        [[float(r[k]) for k in _request_keys()] for r in rows], dtype=torch.float32
    )
    _, prob, phis, base_v = fused_score_reference(cpu_pack, Xr, n_features=F)
    got_prob = torch.tensor([r["prob_default"] for r in resps])
    got_phis = torch.tensor([r["shap_values"] for r in resps])
    err = {
        "predict_prob": float((got_prob - prob).abs().max()),
        "predict_phis": float((got_phis - phis).abs().max()),
        "predict_base": max(abs(r["base_value"] - float(base_v)) for r in resps),
    }
    bulk_prob = fused_score_reference(
        cpu_pack, torch.from_numpy(Xb), n_features=F, with_shap=False
    )[1]
    got_bulk = torch.tensor([p["prob_default"] for p in bulk["predictions"]])
    err["bulk_prob"] = float((got_bulk - bulk_prob).abs().max())
    if max(err["predict_prob"], err["bulk_prob"]) > TOL_PROB:
        raise AssertionError(f"served probabilities disagree: {err}")
    if max(err["predict_phis"], err["predict_base"]) > TOL_PHIS:
        raise AssertionError(f"served SHAP values disagree: {err}")
    if not imp["top_features"] or len(bulk["predictions"]) != bulk_rows:
        raise AssertionError("empty importance or short bulk response")
    return {
        "precision": precision,
        "quant_table": ready["quant_table"],
        "launches": launches,
        "warmup_launches": warm,
        "microbatches": batches,
        "coalesced_rows": ready["microbatch"]["coalesced_rows"],
        "bulk_chunks": bulk_chunks,
        "predict_s": predict_s,
        "bulk_s": bulk_s,
        **err,
    }


def _request_keys() -> list[str]:
    alias = {v: k for k, v in schema.SERVING_FIELD_ALIASES.items()}
    return [alias.get(n, n) for n in schema.SERVING_FEATURES]


#: The quantized precisions of phase 9; the publish gate's prob field on
#: the card against the CPU's (two sigmoids).
QUANTIZED = ("bf16", "int8")
TOL_REPORT_PROB = 1e-7
REPORT_MARGIN_FIELDS = ("mean_abs_margin_delta", "max_abs_margin_delta")
QUANT_ARRAYS = ("thr_q", "leaf_q", "all_left", "thr_affine", "leaf_scale", "leaf_zero", "thr", "leaf")


def quantized_pack_phase(precision: str, device: str = "cuda") -> dict:
    """Phase 9a: the committed forest packed at ``precision`` on the card
    and on the CPU, each through the publish gate (``check=True``): the
    same table hash, stored tables and dequantized values (`QUANT_ARRAYS`;
    the SHAP cover ratios are computed on each device), and the card's
    `quantization_report` (scored by the kernel) equal to the CPU's (the
    plain version) in its margin fields, its prob field within
    `TOL_REPORT_PROB`."""
    art = GBDTArtifact.load(ObjectStore(str(STORE)), MODEL_KEY, device)
    F = len(art.feature_names)
    cpu_forest = art.forest.to("cpu")
    pack = pack_forest(art.forest, F, precision, check=True)
    cpu_pack = pack_forest(cpu_forest, F, precision, check=True)
    differ = [k for k in QUANT_ARRAYS if not torch.equal(getattr(pack, k).cpu(), getattr(cpu_pack, k))]
    if pack.table_hash != cpu_pack.table_hash or differ:
        raise AssertionError(f"{precision}: the card's pack differs from the CPU's in {differ}")
    report = quantization_report(art.forest, pack, F)
    cpu_report = quantization_report(cpu_forest, cpu_pack, F)
    prob_err = abs(report["mean_abs_prob_delta"] - cpu_report["mean_abs_prob_delta"])
    if any(report[k] != cpu_report[k] for k in REPORT_MARGIN_FIELDS) or prob_err > TOL_REPORT_PROB:
        raise AssertionError(f"{precision}: card report {report} != CPU report {cpu_report}")
    if not report["within_tolerance"]:
        raise AssertionError(f"{precision}: outside its tolerance: {report}")
    return {
        "precision": precision,
        "table_hash": pack.table_hash,
        "record_bytes": 4 * tree_table_layout(pack.depth, precision)[1],
        "f32_record_bytes": 4 * tree_table_layout(pack.depth)[1],
        "report_prob_err": prob_err,
        **{k: report[k] for k in (*REPORT_MARGIN_FIELDS, "mean_abs_prob_delta")},
    }


#: Kernels of one `fused_score` call on the card.
SCORE_KERNELS = ("walk_kernel", "shap_kernel", "score_finalize_kernel")
PROFILED_CALLS = 20
#: Profiler sessions tried before `device_ms_by_kernel` gives up.
PROFILE_SESSIONS = 5
#: One-thread spin kernels (``at::cuda::...::spin_kernel``) launched at the
#: start of each profiler session, before the calls it measures, and left
#: out of its times.
LEAD_IN = 8
LEAD_IN_KERNEL = "spin_kernel"


def device_ms_by_kernel(
    fn, calls: int, expect: tuple[str, ...]
) -> tuple[dict[str, float], int]:
    """Device ms per call of each kernel and memset that ``fn`` runs, by
    name, from ``torch.profiler`` over ``calls`` calls after one of warm-up,
    and the fewest calls whose records a kernel of ``expect`` kept.

    A profiler session late in a long run loses the card's records of the
    first few kernels launched in it (17 of 20 scoring calls kept, with the
    first calls' records missing, in every session), so each session starts
    with `LEAD_IN` spin kernels and a synchronize, whose records are left
    out. Each kernel of ``expect`` runs once per call, so its time per call
    is its mean over the records kept, if they cover at least half of
    ``calls``; any other kernel or memset is averaged over the most calls
    a kernel of ``expect`` kept. A session that kept fewer is logged to
    stderr and run again, up to `PROFILE_SESSIONS` sessions, after which
    this raises; one that kept fewer than ``calls``, or fewer than all of
    its lead-in records, is logged too, with where the records lie in the
    session (`_record_spacing`). What a session measures does not depend on
    the sessions before it."""
    fn()
    torch.cuda.synchronize()
    for session in range(1, PROFILE_SESSIONS + 1):
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(LEAD_IN):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        total: dict[str, float] = {}
        seen: dict[str, int] = {}
        lead_in = 0
        for e in prof.key_averages():
            if e.device_time_total > 0 and LEAD_IN_KERNEL in e.key:
                lead_in += e.count
            elif e.device_time_total > 0:
                name = kernel_name(e.key)
                total[name] = total.get(name, 0.0) + e.device_time_total / 1e3
                seen[name] = seen.get(name, 0) + e.count
        if lead_in != LEAD_IN:
            print(f"profiler session {session} kept {lead_in} of {LEAD_IN} lead-in "
                  f"records; {_record_spacing(prof, expect[0], wall_us)}", file=sys.stderr)
        kept = [seen.get(k, 0) for k in expect]
        if 2 * min(kept) >= calls:
            if min(kept) != calls:
                print(f"profiler session {session} kept {seen} of {calls} calls; "
                      f"{_record_spacing(prof, expect[0], wall_us)}", file=sys.stderr)
            return {name: t / (seen[name] if name in expect else max(kept))
                    for name, t in total.items()}, min(kept)
        print(f"profiler session {session} of {PROFILE_SESSIONS} saw {seen}: "
              f"fewer than half of {calls} calls of each of {expect}; "
              f"{_record_spacing(prof, expect[0], wall_us)}", file=sys.stderr)
    raise AssertionError(f"{PROFILE_SESSIONS} profiler sessions missed kernels of {expect}")


def _record_spacing(prof, name: str, wall_us: float) -> str:
    """Where a session's records of kernel ``name`` lie: their span against
    the session's wall time and the gaps between their starts, so that
    calls lost at a session's edges (a short span) tell apart from calls
    lost inside it (a gap of about twice the median)."""
    starts = sorted(
        e.time_range.start for e in prof.events()
        if e.device_type == DeviceType.CUDA and kernel_name(e.name) == name
    )
    if len(starts) < 2:
        return f"{name}: {len(starts)} records in a {wall_us:.0f} us session"
    gaps = np.diff(starts)
    return (f"{name}: {len(starts)} records over {starts[-1] - starts[0]:.0f} us of a "
            f"{wall_us:.0f} us session; gap median {np.median(gaps):.1f} us, "
            f"max {gaps.max():.1f} us after record {int(gaps.argmax())}")


def scoring_split(device: str = "cuda", precision: str = "f32") -> list[dict]:
    """Device ms per call of each kernel of `fused_score` at each bucket of
    `kernel_phase` (its rows, the forest packed at ``precision``), by name,
    from ``torch.profiler`` over `PROFILED_CALLS` calls
    (`device_ms_by_kernel`)."""
    art = GBDTArtifact.load(ObjectStore(str(STORE)), MODEL_KEY, device)
    F = len(art.feature_names)
    f32_pack = pack_forest(art.forest, F)
    pack = f32_pack if precision == "f32" else pack_forest(art.forest, F, precision)
    records = []
    for bucket, with_shap in BUCKETS:
        X = torch.from_numpy(seeded_rows(f32_pack, bucket, SEED + bucket)).to(device)
        walk = "shap_kernel" if with_shap else "walk_kernel"
        ms, kept = device_ms_by_kernel(
            lambda: fused_score(pack, X, n_features=F, with_shap=with_shap),
            PROFILED_CALLS,
            (walk, "score_finalize_kernel"),
        )
        split = {k: v for k, v in ms.items() if k in SCORE_KERNELS}
        records.append({"bucket": bucket, "with_shap": with_shap, "precision": precision,
                        "kept": kept, **split})
    return records


# -- training ------------------------------------------------------------------

#: The committed model's configuration (its artifact header's ``config``).
TRAIN_CONFIG = dict(
    n_estimators=300,
    max_depth=7,
    learning_rate=0.05,
    n_bins=255,
    subsample=0.8,
    colsample_bytree=0.8,
    scale_pos_weight=3.767127752304077,
    seed=42,
)
#: 80/20 split of the ~2.3M-row LendingClub table.
N_TRAIN, N_TEST = 1_840_000, 460_000
#: Columns with ~10% missing cells, as in the LendingClub table.
NAN_COLUMNS = (
    "emp_length_num", "open_il_12m", "open_il_24m", "max_bal_bc",
    "num_rev_accts", "pub_rec_bankruptcies",
)
POSITIVE_RATE = 1.0 / (1.0 + 3.767127752304077)
TOL_HIST = 1e-5
TOL_AUC = 0.002


def training_rows(n: int, seed: int = SEED) -> tuple[np.ndarray, np.ndarray]:
    """``n`` seeded rows of the 20 serving features and a 0/1 label.

    Continuous columns are drawn among the committed model's own bin edges
    (so on the scale its thresholds live on), with 2% jitter; the one-hot
    indicators are 0/1; about 10% of the cells in `NAN_COLUMNS` are NaN. The
    label is drawn from a fixed logistic function of a few columns, with its
    intercept set for a positive rate of 1 / (1 + scale_pos_weight)."""
    rng = np.random.default_rng(seed)
    art = GBDTArtifact.load(ObjectStore(str(STORE)), MODEL_KEY, "cpu")
    names = list(art.feature_names)
    edges = np.asarray(art.bin_edges, dtype=np.float32)
    X = np.empty((n, len(names)), np.float32)
    for f, name in enumerate(names):
        if name in schema.SERVING_INT_FEATURES:
            X[:, f] = rng.random(n, dtype=np.float32) < 0.3
            continue
        finite = edges[f][np.isfinite(edges[f])]
        X[:, f] = rng.choice(finite, n) * (1.0 + 0.02 * rng.standard_normal(n, dtype=np.float32))
        if name in NAN_COLUMNS:
            X[rng.random(n, dtype=np.float32) < 0.1, f] = np.nan

    def z(name: str) -> np.ndarray:
        col = X[:, names.index(name)]
        return np.nan_to_num((col - np.nanmean(col)) / (np.nanstd(col) + 1e-12))

    logit = (
        -1.4 * z("last_fico_range_high")
        + 0.6 * z("term")
        + 0.4 * z("installment")
        + 0.9 * X[:, names.index("grade_E")]
        + 0.3 * z("open_il_12m")
        - 0.3 * z("fico_range_low")
    )
    lo, hi = -20.0, 20.0
    for _ in range(60):  # intercept for the target positive rate
        mid = 0.5 * (lo + hi)
        rate = float(np.mean(1.0 / (1.0 + np.exp(-(logit + mid)))))
        lo, hi = (mid, hi) if rate < POSITIVE_RATE else (lo, mid)
    p = 1.0 / (1.0 + np.exp(-(logit + 0.5 * (lo + hi))))
    y = (rng.random(n) < p).astype(np.float32)
    return X, y


def binning_phase(X_train: torch.Tensor, n_bins: int) -> tuple[object, torch.Tensor]:
    """Edges and bins on the card; raises unless they equal the CPU's."""
    spec = compute_bin_edges(X_train, n_bins)
    bins = transform(spec, X_train)
    Xc = X_train.cpu()
    cpu_spec = compute_bin_edges(Xc, n_bins)
    if not torch.equal(spec.edges.cpu().view(torch.int32), cpu_spec.edges.view(torch.int32)):
        raise AssertionError("bin edges on the card differ from the CPU's")
    if not torch.equal(bins.cpu(), transform(cpu_spec, Xc)):
        raise AssertionError("bins on the card differ from the CPU's")
    return spec, bins


def histogram_bound_ms(bins: torch.Tensor, g, h, w, n_nodes: int, n_bins: int) -> tuple[float, str]:
    """Least time of one histogram pass, counted for this call's data:
    `histogram_cost` at the rows this call finds active (g, h or w
    nonzero), counted on the card."""
    N, F = bins.shape
    active = int(((g != 0) | (h != 0) | (w != 0)).sum())
    return _bound(*histogram_cost(N, F, n_nodes, n_bins, bins.element_size(), active))


def library_histogram(bins, node, g, h, w, n_nodes: int, n_bins: int):
    """One PyTorch call per channel computing the same sums (the yardstick:
    ``torch.bincount`` over the joint (node, feature, bin) index, which is
    built here too). Timed only; the port never calls it."""
    N, F = bins.shape
    feat = torch.arange(F, device=bins.device)
    seg = ((node.long()[:, None] * F + feat) * n_bins + bins.long()).reshape(-1)
    return [
        torch.bincount(seg, weights=v[:, None].expand(N, F).reshape(-1), minlength=n_nodes * F * n_bins)
        for v in (g, h, w)
    ]


def first_tree_calls(bins, y, hp, seed: int, n_bins: int, depth: int) -> list[dict]:
    """The histogram calls of the first tree: level 0 direct and levels
    1..depth-1 sibling-subtracted (the fit's path), plus the direct call of
    the last level (what ``hist_subtract=False`` makes there), each with its
    inputs as the fit makes them."""

    def recorder(into: list[dict]):
        def record(b, node, g, h, w, *, n_nodes, n_bins):
            into.append(dict(node=node.clone(), g=g.clone(), h=h.clone(), w=w.clone(), K=n_nodes))
            return gradient_histogram_channels(b, node, g, h, w, n_nodes=n_nodes, n_bins=n_bins)

        return record

    N, F = bins.shape
    args = (bins, y, torch.ones(N, device=bins.device),
            torch.ones(F, dtype=torch.bool, device=bins.device), hp, seed)
    kw = dict(n_trees_cap=1, depth_cap=depth, n_bins=n_bins)
    subtracted: list[dict] = []
    direct: list[dict] = []
    gbdt.fit_binned_resumable(*args, hist_subtract=True, histogram=recorder(subtracted), **kw)
    gbdt.fit_binned_resumable(*args, hist_subtract=False, histogram=recorder(direct), **kw)
    for i, c in enumerate(subtracted):
        c["label"] = "level 0 direct" if i == 0 else f"level {i} subtracted"
    direct[-1]["label"] = f"level {depth - 1} direct"
    return subtracted + direct[-1:]


def histogram_phase(bins: torch.Tensor, calls: list[dict], n_bins: int) -> list[dict]:
    """Kernel vs plain at each recorded call; returns one record per call.

    At ``level 6 subtracted`` the same rows in a seeded random order must
    give the same bits too (the kernel groups rows by node in no fixed
    order; its integer sums do not depend on it)."""
    records = []
    for c in calls:
        args = (bins, c["node"], c["g"], c["h"], c["w"])
        kw = dict(n_nodes=c["K"], n_bins=n_bins)
        got = torch.stack(gradient_histogram_channels(*args, **kw))
        again = torch.stack(gradient_histogram_channels(*args, **kw))
        ref = gradient_histogram_reference(*args, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{c['label']}: two launches differ")
        if not torch.equal(got[2], ref[2]):
            raise AssertionError(f"{c['label']}: cover differs from the plain version")
        in_range = (c["node"] >= 0) & (c["node"] < c["K"])
        active = in_range & ((c["g"] != 0) | (c["h"] != 0) | (c["w"] != 0))
        rec = {"shape": c["label"], "K": c["K"], "active_rows": int(active.sum()),
               "max_abs_err": 0.0, "max_rel_err": 0.0}
        for ch in (0, 1):
            # Per node: each node's channel against its own largest |value|.
            err = (got[ch] - ref[ch]).abs().amax(dim=(1, 2))
            scale = ref[ch].abs().amax(dim=(1, 2))
            bad = err > TOL_HIST * scale
            if bool(bad.any()):
                k = int(bad.nonzero()[0, 0])
                raise AssertionError(
                    f"{c['label']}: channel {ch} of node {k} off by {float(err[k])} "
                    f"(scale {float(scale[k])})"
                )
            rel = torch.where(scale > 0, err / scale, torch.zeros_like(err))
            rec["max_abs_err"] = max(rec["max_abs_err"], float(err.max()))
            rec["max_rel_err"] = max(rec["max_rel_err"], float(rel.max()))
        rec["bit_equal"] = torch.equal(got, ref)
        if c["label"] == "level 6 subtracted":
            gen = torch.Generator(device=bins.device).manual_seed(SEED)
            perm = torch.randperm(bins.shape[0], generator=gen, device=bins.device)
            shuffled = [a[perm].contiguous() for a in args]
            if not torch.equal(got, torch.stack(gradient_histogram_channels(*shuffled, **kw))):
                raise AssertionError(f"{c['label']}: the rows in another order give other bits")
            rec["row_order_equal"] = True
            del shuffled
        rec["ms"] = time_ms(lambda: gradient_histogram_channels(*args, **kw), 20)
        rec["plain_ms"] = time_ms(lambda: gradient_histogram_reference(*args, **kw), 3, warmup=1)
        rec["library_ms"] = time_ms(lambda: library_histogram(*args, **kw), 3, warmup=1)
        rec["bound_ms"], rec["bound_by"] = histogram_bound_ms(bins, c["g"], c["h"], c["w"], c["K"], n_bins)
        records.append(rec)
    return records


def histogram_line(r: dict, card: str) -> str:
    """One printed line of a `histogram_phase` record."""
    order = f" row_order_equal={r['row_order_equal']}" if "row_order_equal" in r else ""
    return (f"kernel gradient_histogram {r['shape']} (K={r['K']}) active_rows={r['active_rows']} "
            f"ms={r['ms']:.6f} plain_ms={r['plain_ms']:.6f} library_ms={r['library_ms']:.6f} "
            f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) "
            f"max_abs_err={r['max_abs_err']:.3g} max_rel_err={r['max_rel_err']:.3g} "
            f"bit_equal={r['bit_equal']}{order} [{card}]")


class TimedHistogram:
    """A histogram op (the kernel's wrapper, one fit's or the joint one)
    with CUDA events around each call, to sum the device time inside the
    histogram launches of a fit."""

    def __init__(self, op=gradient_histogram_channels):
        self.op = op
        self.events: list[tuple[torch.cuda.Event, torch.cuda.Event]] = []

    def __call__(self, *args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.op(*args, **kw)
        end.record()
        self.events.append((start, end))
        return out

    def total_ms(self) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


def plain_histogram(*args, **kw):
    return tuple(gradient_histogram_reference(*args, **kw))


def fit_with(bins, y, spec, cfg: GBDTConfig, histogram) -> tuple[gbdt.Forest, float]:
    """The level loop of `GBDTClassifier.fit` on bins already made, with
    ``histogram`` as the level's histogram op; returns the forest with its
    float thresholds and the wall seconds of the loop."""
    N, F = bins.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    forest, _ = gbdt.fit_binned_resumable(
        bins, y, torch.ones(N, device=bins.device),
        torch.ones(F, dtype=torch.bool, device=bins.device),
        gbdt.GBDTHyperparams.from_config(cfg), cfg.seed,
        n_trees_cap=cfg.n_estimators, depth_cap=cfg.max_depth, n_bins=cfg.n_bins,
        hist_subtract=cfg.hist_subtract, histogram=histogram,
    )
    torch.cuda.synchronize()
    return gbdt.attach_float_thresholds(forest, spec), time.perf_counter() - t0


#: Kernels of one `gradient_histogram_channels` launch.
HIST_KERNELS = ("count_kernel", "plan_kernel", "scatter_kernel", "hist_kernel", "finalize_kernel")
PROFILED_TREES = 10


def kernel_name(event_name: str) -> str:
    """``void hist_kernel<unsigned char>(...)`` -> ``hist_kernel``."""
    return event_name.split("(")[0].split("<")[0].removeprefix("void ").strip()


def profile_level_loop(bins, y, spec, cfg: GBDTConfig, trees: int = PROFILED_TREES) -> dict:
    """The first ``trees`` trees of the level loop through the kernel, once
    unprofiled (wall seconds) and once under ``torch.profiler``: the card's
    busy time (every kernel, memset and copy it ran, summed: one stream, so
    none overlap), the histogram launches' part of it, and the kernel
    launches the host made per tree. The card's idle share is
    1 - busy / unprofiled wall, with the median wall of three runs (the
    loop waits on the host, whose speed varies). A profiler session slows
    the host's later launches, so this runs after every other timing."""
    short = GBDTConfig(**{**TRAIN_CONFIG, "n_estimators": trees})
    fit_with(bins, y, spec, short, gradient_histogram_channels)  # warm-up
    wall_s = float(np.median([
        fit_with(bins, y, spec, short, gradient_histogram_channels)[1] for _ in range(3)
    ]))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fit_with(bins, y, spec, short, gradient_histogram_channels)
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3
    hist_ms = sum(e.time_range.elapsed_us() for e in device if kernel_name(e.name) in HIST_KERNELS) / 1e3
    launches = sum(1 for e in events if e.name == "cudaLaunchKernel")
    if not busy_ms or not hist_ms or not launches:
        raise AssertionError(f"the profiler saw no work on the card: {busy_ms} ms, {launches} launches")
    return {
        "trees": trees,
        "wall_s": wall_s,
        "device_busy_ms": busy_ms,
        "hist_device_ms": hist_ms,
        "device_idle_share": 1.0 - busy_ms / (wall_s * 1e3),
        "launches_per_tree": launches / trees,
    }


def held_out_auc(forest: gbdt.Forest, X_test: torch.Tensor, y_test: torch.Tensor) -> float:
    return float(roc_auc(y_test, gbdt.predict_margin(forest, X_test)))


def same_tree(a: gbdt.Forest, b: gbdt.Forest, t: int, bins: torch.Tensor) -> dict:
    """Tree ``t`` of two forests: split features and covers equal at every
    node and every training row in the same leaf. Thresholds and missing
    directions may differ only where the node's rows split alike (bins that
    hold none of its rows tie up to subtraction residues)."""
    out = {
        "thr_bin_differs_at": int((a.thr_bin[t] != b.thr_bin[t]).sum()),
        "missing_left_differs_at": int((a.missing_left[t] != b.missing_left[t]).sum()),
    }
    for f in ("feature", "cover"):
        if not torch.equal(getattr(a, f)[t], getattr(b, f)[t]):
            raise AssertionError(f"tree {t}: {f} differs between the kernel and plain fits")
    leaves = [
        gbdt.landed_leaves(
            f.feature[t : t + 1], f.thr_bin[t : t + 1], f.missing_left[t : t + 1],
            f.depth, bins, binned=True,
        )
        for f in (a, b)
    ]
    if not torch.equal(*leaves):
        raise AssertionError(f"tree {t}: training rows land in other leaves")
    return out


# -- the search's job axis (5b's joint launches, --only-search) ------------------

#: The reference-default search's bucket of depth 9 and 100 trees: 5
#: candidates (of `TuneConfig`'s 20 draws, seed 22) x 3 folds, 15 jobs, the
#: protocol's largest.
JOBS_BUCKET = (9, 100)
#: Levels of the bucket's first tree whose joint launches 5b checks (level 0
#: direct, then sibling-subtracted), and the level checked direct too.
JOBS_LEVELS, JOBS_DIRECT_LEVEL = (0, 4, 8), 8
#: --only-search: chunks boosted, and trees a chunk (cut from the bucket's
#: 100 trees for time).
SEARCH_CHUNKS, SEARCH_CHUNK_TREES = 4, 5


def bucket_jobs(y: torch.Tensor, base: GBDTConfig, tune: TuneConfig | None = None) -> dict:
    """The (candidate, fold) jobs of the reference-default search's
    `JOBS_BUCKET` over rows labelled ``y``, as `randomized_search` makes
    them: each job's hyperparameters, seed (``fold_in(seed, cand * K +
    fold)``) and training weight (its fold at 0)."""
    tune = tune or TuneConfig()
    cands = sample_candidates(tune.param_space, tune.n_iter, tune.seed)
    cfgs = [base.replace(**c) for c in cands]
    idxs = next(b for b in search_buckets(cands, base)
                if (cfgs[b[0]].max_depth, cfgs[b[0]].n_estimators) == JOBS_BUCKET)
    K = tune.cv_folds
    val = torch.from_numpy(stratified_kfold_masks(y.cpu().numpy(), K, tune.seed)).to(y.device)
    jobs = [(c, k) for c in idxs for k in range(K)]
    return {
        "candidates": idxs,
        "hps": [gbdt.GBDTHyperparams.from_config(cfgs[c]) for c, _ in jobs],
        "seeds": [gbdt.fold_in(tune.seed, c * K + k) for c, k in jobs],
        "weights": (1.0 - val.float()[[k for _, k in jobs]]).contiguous(),
        "depth": JOBS_BUCKET[0],
    }


def first_tree_job_calls(bins, y, jobs: dict, n_bins: int) -> list[dict]:
    """The joint histogram calls of the bucket's first tree at
    `JOBS_LEVELS` (sibling-subtracted, the search's path) and at
    `JOBS_DIRECT_LEVEL` direct, each with its inputs as `fit_binned_jobs`
    makes them."""

    def recorder(into: list[dict], levels):
        level = iter(range(jobs["depth"]))

        def record(b, node, g, h, w, *, n_nodes, n_bins):
            lvl = next(level)
            if lvl in levels:
                into.append(dict(node=node.clone(), g=g.clone(), h=h.clone(), w=w.clone(),
                                 K=n_nodes, level=lvl))
            return gradient_histogram_jobs(b, node, g, h, w, n_nodes=n_nodes, n_bins=n_bins)

        return record

    F = bins.shape[1]
    args = (bins, y, jobs["weights"], torch.ones(F, dtype=torch.bool, device=bins.device),
            jobs["hps"], jobs["seeds"])
    kw = dict(n_trees_cap=1, depth_cap=jobs["depth"], n_bins=n_bins)
    subtracted: list[dict] = []
    direct: list[dict] = []
    gbdt.fit_binned_jobs(*args, hist_subtract=True, histogram=recorder(subtracted, JOBS_LEVELS), **kw)
    gbdt.fit_binned_jobs(*args, hist_subtract=False, histogram=recorder(direct, (JOBS_DIRECT_LEVEL,)),
                         **kw)
    J = len(jobs["hps"])
    for c in subtracted:
        c["label"] = f"jobs J={J} level {c['level']} " + ("direct" if c["level"] == 0 else "subtracted")
    for c in direct:
        c["label"] = f"jobs J={J} level {c['level']} direct"
    return subtracted + direct


def library_jobs_histogram(bins, node, g, h, w, n_nodes: int, n_bins: int):
    """One weighted ``torch.bincount`` per channel over the joint (job,
    node, feature, bin) index of J jobs, built here too (the yardstick of a
    joint launch). Timed only; the port never calls it."""
    J, N = node.shape
    F = bins.shape[1]
    jobs = torch.arange(J, device=bins.device)[:, None] * n_nodes
    feat = torch.arange(F, device=bins.device)
    seg = (((jobs + node.long())[:, :, None] * F + feat) * n_bins + bins.long()[None]).reshape(-1)
    return [
        torch.bincount(seg, weights=v[:, :, None].expand(J, N, F).reshape(-1),
                       minlength=J * n_nodes * F * n_bins)
        for v in (g, h, w)
    ]


def single_launches(bins, node, g, h, w, n_nodes: int, n_bins: int) -> torch.Tensor:
    """``(3, J, K, F, B)``: one single-job launch per job, stacked."""
    return torch.stack([
        torch.stack(gradient_histogram_channels(bins, node[j], g[j], h[j], w[j], n_nodes=n_nodes,
                                                n_bins=n_bins))
        for j in range(node.shape[0])
    ], dim=1)


def jobs_histogram_phase(bins: torch.Tensor, calls: list[dict], n_bins: int) -> list[dict]:
    """The joint launch at each recorded call: bit-equal to itself twice and
    to the J single launches; its cover bit-equal to the plain version and
    g and h of each (job, node) within `TOL_HIST` of its largest |value|;
    then the active (job, row) pairs, the rows active in any job, and the
    joint, single, plain, library and bound times. Returns one record per
    call."""
    records = []
    for c in calls:
        args = (bins, c["node"], c["g"], c["h"], c["w"])
        kw = dict(n_nodes=c["K"], n_bins=n_bins)
        J, N = c["node"].shape
        got = torch.stack(gradient_histogram_jobs(*args, **kw))
        again = torch.stack(gradient_histogram_jobs(*args, **kw))
        singles = single_launches(*args, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{c['label']}: two joint launches differ")
        if not torch.equal(got, singles):
            raise AssertionError(f"{c['label']}: the joint launch differs from {J} single launches")
        del again, singles
        ref = gradient_histogram_jobs_reference(*args, **kw)
        if not torch.equal(got[2], ref[2]):
            raise AssertionError(f"{c['label']}: cover differs from the plain version")
        rec = {"shape": c["label"], "J": J, "K": c["K"], "max_abs_err": 0.0, "max_rel_err": 0.0,
               "equal_to_single_launches": True}
        for ch in (0, 1):
            err = (got[ch] - ref[ch]).abs().amax(dim=(2, 3))
            scale = ref[ch].abs().amax(dim=(2, 3))
            bad = err > TOL_HIST * scale
            if bool(bad.any()):
                j, k = (int(i) for i in bad.nonzero()[0])
                raise AssertionError(f"{c['label']}: channel {ch} of job {j} node {k} off by "
                                     f"{float(err[j, k])} (scale {float(scale[j, k])})")
            rel = torch.where(scale > 0, err / scale, torch.zeros_like(err))
            rec["max_abs_err"] = max(rec["max_abs_err"], float(err.max()))
            rec["max_rel_err"] = max(rec["max_rel_err"], float(rel.max()))
        rec["bit_equal"] = torch.equal(got, ref)
        del got, ref
        inside = (c["node"] >= 0) & (c["node"] < c["K"])
        live = inside & ((c["g"] != 0) | (c["h"] != 0) | (c["w"] != 0))
        # Active (job, row) pairs, and the rows active in any job: the
        # jobs share the bins, which the function needs once a row.
        active, bin_rows = int(live.sum()), int(live.any(dim=0).sum())
        del live
        rec["active_rows"], rec["bin_rows"] = active, bin_rows
        rec["ms"] = time_ms(lambda: gradient_histogram_jobs(*args, **kw), 10)
        rec["singles_ms"] = time_ms(lambda: single_launches(*args, **kw), 3, warmup=1)
        rec["plain_ms"] = time_ms(lambda: gradient_histogram_jobs_reference(*args, **kw), 2, warmup=1)
        rec["library_ms"] = time_ms(lambda: library_jobs_histogram(*args, **kw), 2, warmup=1)
        rec["bound_ms"], rec["bound_by"] = _bound(*histogram_cost(
            N, bins.shape[1], c["K"], n_bins, bins.element_size(), active, n_jobs=J,
            bin_rows=bin_rows))
        records.append(rec)
    return records


def jobs_histogram_line(r: dict, card: str) -> str:
    """One printed line of a `jobs_histogram_phase` record."""
    return (f"kernel gradient_histogram {r['shape']} (K={r['K']}) active_rows={r['active_rows']} "
            f"bin_rows={r['bin_rows']} ms={r['ms']:.6f} singles_ms={r['singles_ms']:.6f} plain_ms={r['plain_ms']:.6f} "
            f"library_ms={r['library_ms']:.6f} bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) "
            f"max_abs_err={r['max_abs_err']:.3g} max_rel_err={r['max_rel_err']:.3g} "
            f"equal_to_single_launches={r['equal_to_single_launches']} [{card}]")


def job_axis_checks(card: str, bins: torch.Tensor, y: torch.Tensor, n_bins: int) -> tuple[list[dict], dict]:
    """5b's joint launches on phase 5's training rows: the bucket's jobs,
    their first tree's calls, and `jobs_histogram_phase`. Returns the
    records and the jobs."""
    base = GBDTConfig(scale_pos_weight=TRAIN_CONFIG["scale_pos_weight"])
    jobs = bucket_jobs(y, base)
    calls = first_tree_job_calls(bins, y, jobs, n_bins)
    records = jobs_histogram_phase(bins, calls, n_bins)
    del calls
    for r in records:
        print(jobs_histogram_line(r, card))
    return records, jobs


def search_phase(card: str, bins: torch.Tensor, y: torch.Tensor, jobs: dict, n_bins: int) -> dict:
    """``--only-search``: the bucket's jobs for `SEARCH_CHUNKS` chunks of
    `SEARCH_CHUNK_TREES` trees, margins carried, jointly and job by job:
    margins and forest chunks bitwise equal; seconds and launches of
    each."""
    dev = bins.device
    N, F = bins.shape
    J, depth = len(jobs["hps"]), jobs["depth"]
    fm = torch.ones(F, dtype=torch.bool, device=dev)
    kw = dict(n_trees_cap=SEARCH_CHUNK_TREES, depth_cap=depth, n_bins=n_bins)
    out: dict = {"jobs": J, "candidates": jobs["candidates"], "rows": N, "depth": depth,
                 "chunks": SEARCH_CHUNKS, "chunk_trees": SEARCH_CHUNK_TREES}
    offsets = [c * SEARCH_CHUNK_TREES for c in range(SEARCH_CHUNKS)]

    gradient_histogram_channels.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    margins = torch.zeros((J, N), dtype=torch.float32, device=dev)
    joint = []
    for off in offsets:
        forests, margins = gbdt.fit_binned_jobs(
            bins, y, jobs["weights"], fm, jobs["hps"], jobs["seeds"], init_margin=margins,
            tree_offset=off, **kw)
        joint.append(forests)
    torch.cuda.synchronize()
    out["joint_s"] = time.perf_counter() - t0
    out["joint_launches"] = gradient_histogram_channels.launches

    gradient_histogram_channels.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    per_job = []
    for j in range(J):
        margin = torch.zeros(N, dtype=torch.float32, device=dev)
        chunks = []
        for off in offsets:
            forest, margin = gbdt.fit_binned_resumable(
                bins, y, jobs["weights"][j], fm, jobs["hps"][j], jobs["seeds"][j],
                init_margin=margin, tree_offset=off, **kw)
            chunks.append(forest)
        per_job.append((chunks, margin))
    torch.cuda.synchronize()
    out["per_job_s"] = time.perf_counter() - t0
    out["per_job_launches"] = gradient_histogram_channels.launches

    levels = SEARCH_CHUNKS * SEARCH_CHUNK_TREES * depth
    if (out["joint_launches"], out["per_job_launches"]) != (levels, J * levels):
        raise AssertionError(f"launches {out['joint_launches']} joint, {out['per_job_launches']} "
                             f"job by job; expected {levels} and {J * levels}")
    for j, (chunks, margin) in enumerate(per_job):
        if not torch.equal(margin, margins[j]):
            raise AssertionError(f"job {j}: the joint run's margins differ from its own fit's")
        for c, forest in enumerate(chunks):
            if not same_forest(forest, joint[c][j]):
                raise AssertionError(f"job {j}: chunk {c}'s forest differs from its own fit's")
    out["bitwise_equal"] = True
    out["speedup"] = out["per_job_s"] / out["joint_s"]
    print(f"search bucket (--only-search): {json.dumps(out)} [{card}]")
    return out


def training_phase(card: str) -> tuple[list[dict], dict]:
    """Phase 5; returns (histogram records per shape, fit/serve summary)."""
    dev = torch.device("cuda")
    cfg = GBDTConfig(**TRAIN_CONFIG)
    t0 = time.perf_counter()
    Xn, yn = training_rows(N_TRAIN + N_TEST)
    X = torch.from_numpy(Xn).to(dev)
    y = torch.from_numpy(yn).to(dev)
    X_train, X_test, y_train, y_test = X[:N_TRAIN], X[N_TRAIN:], y[:N_TRAIN], y[N_TRAIN:]
    summary = {
        "rows_train": N_TRAIN,
        "rows_test": N_TEST,
        "positive_rate": float(y.mean()),
        "data_s": time.perf_counter() - t0,
    }

    spec, bins = binning_phase(X_train, cfg.n_bins)
    hp = gbdt.GBDTHyperparams.from_config(cfg)
    calls = first_tree_calls(bins, y_train, hp, cfg.seed, cfg.n_bins, cfg.max_depth)
    records = histogram_phase(bins, calls, cfg.n_bins)
    del calls
    for r in records:
        print(histogram_line(r, card))
    summary["job_axis"], _ = job_axis_checks(card, bins, y_train, cfg.n_bins)

    # The main path: the user's entry point, GBDTClassifier.fit (binning
    # included) through the kernel; counts from 0 just before.
    gradient_histogram_channels.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = gbdt.GBDTClassifier(cfg, device="cuda").fit(X_train, y_train)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = gradient_histogram_channels.launches
    expect = cfg.n_estimators * cfg.max_depth
    if launches != expect:
        raise AssertionError(f"{launches} histogram launches in the fit, expected {expect}")
    auc = held_out_auc(model.forest, X_test, y_test)
    summary.update(fit_s=fit_s, hist_launches=launches, held_out_auc=auc,
                   binned_rows=int(bins.shape[0]))
    if not 0.5 < auc <= 1.0:
        raise AssertionError(f"held-out AUC {auc} of the kernel fit")

    # A second fit through the kernel, with CUDA events around each launch:
    # the same forest bit for bit, and the device time inside the histogram.
    timer = TimedHistogram()
    again, summary["fit2_loop_s"] = fit_with(bins, y_train, spec, cfg, timer)
    summary["hist_ms_in_fit2"] = timer.total_ms()
    for f in ("feature", "thr_bin", "thr_float", "missing_left", "gain", "cover", "leaf_value"):
        if not torch.equal(getattr(model.forest, f), getattr(again, f)):
            raise AssertionError(f"two fits on the card differ in {f}")
    del again, timer

    plain, summary["plain_fit_loop_s"] = fit_with(bins, y_train, spec, cfg, plain_histogram)
    summary["plain_held_out_auc"] = held_out_auc(plain, X_test, y_test)
    summary["tree0_vs_plain"] = same_tree(model.forest, plain, 0, bins)
    if abs(summary["plain_held_out_auc"] - auc) > TOL_AUC:
        raise AssertionError(f"plain-histogram fit AUC {summary['plain_held_out_auc']} vs {auc}")
    del plain

    # Publish the kernel-trained forest, then serve it.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_store_") as root:
        key = "models/gbdt/model_tree"
        GBDTArtifact(
            forest=model.forest.to("cpu"),
            feature_names=tuple(schema.SERVING_FEATURES),
            bin_edges=spec.edges.cpu().numpy(),
            config=dict(TRAIN_CONFIG),
            metrics={"test_auc": auc, "train_rows": N_TRAIN, "trained_wall_s": fit_s},
        ).save(ObjectStore(root), key)
        summary["serve"] = serving_phase(
            "cuda", n_requests=16, bulk_rows=5000, store_root=Path(root), model_key=key
        )
    summary["loop_profile"] = profile_level_loop(bins, y_train, spec, cfg)
    return records, summary


# -- the raw path ------------------------------------------------------------------

#: Loans in the raw LendingClub table, and in the card-vs-CPU check.
RAW_ROWS, RAW_CHECK_ROWS = 2_300_000, 200_000
#: Snapshot date of the date -> age features, pinned.
TODAY = datetime(2026, 8, 1)
#: log1p-derived values: torch's log1p on the card and on the CPU may
#: differ in the last bits (a few float32 ulps, as against the reference).
LOG_RTOL = 3e-7
#: Raw rows scored through predict_raw.
RAW_SERVE_ROWS = 64


def _columns_agree(names, A: torch.Tensor, B: torch.Tensor, log_cols: set, what: str) -> None:
    """Bitwise equal (NaN == NaN) outside ``log_cols``, within LOG_RTOL in them."""
    if A.shape != B.shape:
        raise AssertionError(f"{what}: shapes {tuple(A.shape)} and {tuple(B.shape)}")
    both_nan = torch.isnan(A) & torch.isnan(B)
    for j, name in enumerate(names):
        a, b = A[:, j], B[:, j]
        if name in log_cols:
            ok = torch.isclose(a, b, rtol=LOG_RTOL, atol=0.0) | both_nan[:, j]
        else:
            ok = (a == b) | both_nan[:, j]
        if not bool(ok.all()):
            raise AssertionError(f"{what}: column {name!r} differs in {int((~ok).sum())} rows")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def ingest_card_vs_cpu(n_rows: int = RAW_CHECK_ROWS, device: str = "cuda") -> dict:
    """Phase 6a: one tokenized frame ingested on the card and on the CPU."""
    tok = tokenize_raw_frame(synthetic_lendingclub_frame(n_rows, seed=SEED), today=TODAY)
    card = run_device_ingest(tok, device=device)
    cpu = run_device_ingest(tok, device="cpu")
    if dataclasses.asdict(card.report) != dataclasses.asdict(cpu.report):
        raise AssertionError(f"clean reports differ: {card.report} vs {cpu.report}")
    pc, pp = card.plan, cpu.plan
    for f in ("numeric_names", "categorical_vocab", "label_vocab", "log_cols",
              "tree_feature_names", "nn_feature_names", "asof"):
        if getattr(pc, f) != getattr(pp, f):
            raise AssertionError(f"plans differ in {f}")
    log_cols = set(pp.log_cols)
    for name, v in pp.medians.items():
        w = pc.medians[name]
        if (name in log_cols and not np.isclose(w, v, rtol=LOG_RTOL, atol=0.0)) or (
            name not in log_cols and w != v
        ):
            raise AssertionError(f"median of {name}: {w} on the card, {v} on the CPU")
    _columns_agree(pp.tree_feature_names, card.tree.X.cpu(), cpu.tree.X, log_cols, "tree")
    _columns_agree(pp.nn_feature_names, card.nn.X.cpu(), cpu.nn.X, log_cols, "nn")
    if not torch.equal(torch.nan_to_num(card.tree.y.cpu(), nan=-1.0), torch.nan_to_num(cpu.tree.y, nan=-1.0)):
        raise AssertionError("labels differ")
    exact = [j for j, n in enumerate(pp.tree_feature_names) if n not in log_cols]
    if not torch.equal(card.bins.cpu()[:, exact], cpu.bins[:, exact]):
        raise AssertionError("bins of the columns log1p does not touch differ")
    n = cpu.tree.n_rows
    if not torch.equal(split_mask(n, 0.2, 22, device).cpu(), split_mask(n, 0.2, 22, "cpu")):
        raise AssertionError("hashed split masks differ")
    log_bins = [j for j, nm in enumerate(pp.tree_feature_names) if nm in log_cols]
    return {
        "rows_in": tok.n_rows,
        "rows_out": n,
        "tree_features": len(pp.tree_feature_names),
        "exact_columns": len(exact),
        "log1p_bins_equal": torch.equal(card.bins.cpu()[:, log_bins], cpu.bins[:, log_bins]),
    }


def _boom(*args, **kwargs):
    raise RuntimeError("SHAP launch made to fail")


def raw_table(n_rows: int = RAW_ROWS) -> tuple[RawFrame, float]:
    """The seeded raw LendingClub table and the host seconds it took."""
    t0 = time.perf_counter()
    frame = synthetic_lendingclub_frame(n_rows, seed=SEED)
    return frame, time.perf_counter() - t0


def raw_path_phase(
    card: str,
    n_rows: int = RAW_ROWS,
    check_rows: int = RAW_CHECK_ROWS,
    device: str = "cuda",
    frame: RawFrame | None = None,
    keep: dict | None = None,
) -> tuple[dict, dict, tuple]:
    """Phase 6 on ``frame`` (``raw_table(n_rows)`` if None); returns
    (summary, launches of each kernel on this path, the training split of
    all tree features after the leakage drop as ``(X, y, names)`` on the
    host, for phase 8's histogram shapes). ``keep``, when given, receives
    6b's ingest (``report``, ``plan`` and the tree table on the host) for
    phase 13b. ``device="cpu"`` and small row counts rehearse it without a
    card."""
    dev = torch.device(device)
    out: dict = {"card_vs_cpu": ingest_card_vs_cpu(check_rows, device)}

    # b. Raw table -> host tokenize -> card ingest -> split -> fit.
    if frame is None:
        frame, out["generate_s"] = raw_table(n_rows)
    out["raw_columns"] = len(frame.columns)
    picks = np.sort(np.random.default_rng(SEED).choice(frame.n_rows, RAW_SERVE_ROWS, replace=False))
    payloads = row_dicts(frame, picks)
    t0 = time.perf_counter()
    tok = tokenize_raw_frame(frame, today=TODAY)
    out["tokenize_s"] = time.perf_counter() - t0
    out["rows_in"] = tok.n_rows

    gradient_histogram_channels.launches = 0
    fused_score.launches = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    t0 = time.perf_counter()
    res = run_device_ingest(tok, device=dev)
    _sync(dev)
    out["ingest_s"] = time.perf_counter() - t0
    del tok
    out["rows_out"] = res.tree.n_rows
    out["tree_features"] = res.tree.n_features
    out["nn_features"] = res.nn.n_features
    out["report"] = dataclasses.asdict(res.report)
    if keep is not None:
        keep.update(report=res.report, plan=res.plan, tree=FeatureFrame(
            res.tree.feature_names, res.tree.X.cpu(), res.tree.y.cpu()))
    ff = drop_training_leakage(res.tree)
    out["tree_features_after_leakage_drop"] = ff.n_features
    X_all, X_test, y_train, y_test = train_test_split_hashed(ff.X, ff.y)
    train_rows = (X_all.cpu(), y_train.cpu(), ff.feature_names)
    sel = torch.tensor([ff.feature_names.index(n) for n in schema.SERVING_FEATURES], device=dev)
    X_train, X_test = X_all.index_select(1, sel), X_test.index_select(1, sel)
    del X_all
    n_pos = float(y_train.sum())
    spw = (float(X_train.shape[0]) - n_pos) / max(n_pos, 1.0)
    cfg = GBDTConfig(**{**TRAIN_CONFIG, "scale_pos_weight": spw})
    out.update(rows_train=int(X_train.shape[0]), rows_test=int(X_test.shape[0]),
               positive_rate=n_pos / float(X_train.shape[0]), scale_pos_weight=spw)
    _sync(dev)
    t0 = time.perf_counter()
    model = gbdt.GBDTClassifier(cfg, device=dev).fit(X_train, y_train)
    _sync(dev)
    out["fit_s"] = time.perf_counter() - t0
    if dev.type == "cuda":
        out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    hist_launches = gradient_histogram_channels.launches
    if dev.type == "cuda" and hist_launches != cfg.n_estimators * cfg.max_depth:
        raise AssertionError(f"{hist_launches} histogram launches in the raw-path fit")
    margin = gbdt.predict_margin(model.forest, X_test)
    out["held_out_auc"] = float(roc_auc(y_test, margin))
    pred = (torch.sigmoid(margin) >= 0.5).to(torch.int32)
    out["classification_report"] = binary_classification_report(y_test, pred)
    if out["held_out_auc"] < 0.90 and n_rows == RAW_ROWS:
        raise AssertionError(f"held-out AUC {out['held_out_auc']} on the raw path")
    del X_train, X_test, y_train, y_test, ff, margin, pred

    # c. Publish with the plan, serve raw rows on the card.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_raw_") as root:
        key = "models/gbdt/model_tree"
        plan = res.plan
        GBDTArtifact(
            forest=model.forest.to("cpu"),
            feature_names=tuple(schema.SERVING_FEATURES),
            bin_edges=model.bin_spec.edges.cpu().numpy(),
            plan=plan,
            config={**TRAIN_CONFIG, "scale_pos_weight": spw},
            metrics={"test_auc": out["held_out_auc"], "train_rows": out["rows_train"]},
        ).save(ObjectStore(root), key)
        service = ScorerService.from_store(ObjectStore(root), ServeConfig(model_key=key), device=dev)
        try:
            out["serve"] = serve_raw_rows(service, res, payloads, dev)
            out["degraded"] = degraded_predict(service)
        finally:
            service.close()
    launches = {"gradient_histogram": hist_launches, "score_forest": out["serve"]["predict_raw_launches"]}
    print(f"raw_path: {json.dumps(out)} [{card}]")
    return out, launches, train_rows


def serve_raw_rows(service: ScorerService, res, payloads: list[dict], dev: torch.device) -> dict:
    """Phase 6c: predict_raw on the raw rows, each held to its ingested row."""
    plan = res.plan
    tree = res.tree.X
    sel = [plan.tree_feature_names.index(n) for n in schema.SERVING_FEATURES]
    model = service._model
    odd = {"loan_amnt": 10000.0, "term": " 36 months", "int_rate": "11.5%", "grade": "ZZZ",
           "annual_inc": None, "hardship_status": None}
    fused_score.launches = 0
    t0 = time.perf_counter()
    resps = [service.predict_raw(p) for p in payloads + [odd]]
    predict_raw_s = time.perf_counter() - t0
    launches = fused_score.launches
    if dev.type == "cuda" and launches != len(resps):
        raise AssertionError(f"{launches} fused_score launches for {len(resps)} predict_raw calls")
    raw = transform_raw_rows(plan, payloads + [odd], device=dev)
    matched = 0
    matched_rows: list[np.ndarray] = []
    matched_resps: list[dict] = []
    for i, resp in enumerate(resps[:-1]):
        r = raw[i]
        hit = (((tree == r) | (torch.isnan(tree) & torch.isnan(r))).all(dim=1)).nonzero()
        if hit.numel() == 0:
            continue  # dropped by cleaning
        row = tree[int(hit[0, 0])].cpu().numpy()[sel]
        got = np.array([resp["engineered_row"][n] for n in schema.SERVING_FEATURES], np.float32)
        if not np.array_equal(got.view(np.int32), row.view(np.int32)):
            raise AssertionError(f"raw row {i}: engineered row differs from its ingested row")
        matched_rows.append(row)
        matched_resps.append(resp)
        matched += 1
    if matched < 0.9 * len(payloads):
        raise AssertionError(f"only {matched} of {len(payloads)} raw rows found in the ingest")
    err = _margin_only_vs_plain(model, matched_rows, [r["prob_default"] for r in matched_resps])
    names = list(plan.tree_feature_names)
    o = raw[-1].cpu().numpy()
    grade = [j for j, n in enumerate(names) if n.startswith("grade_")]
    fill = names.index(f"hardship_status_{schema.HARDSHIP_FILL}")
    hs = [j for j, n in enumerate(names) if n.startswith("hardship_status_")]
    if not (np.isnan(o[names.index("annual_inc")]) and (o[grade] == 0.0).all()
            and all(o[j] == (1.0 if j == fill else 0.0) for j in hs)):
        raise AssertionError("missing / unknown raw values do not follow training")
    return {"rows": len(resps), "matched": matched, "predict_raw_launches": launches,
            "predict_raw_s": predict_raw_s, "prob_max_abs_err": err}


def _margin_only_vs_plain(model, rows: list[np.ndarray], probs: list[float]) -> float:
    """Each row, one at a time as ``predict_raw`` and a one-row ``/predict``
    score it, through the margin-only launch and through the plain version
    on the same tensor on the model's device: margins bitwise equal, prob
    within `TOL_PROB`, and the response's prob that of the launch. Returns
    the largest prob difference from the plain version."""
    err = 0.0
    for i, (row, prob) in enumerate(zip(rows, probs)):
        x = torch.from_numpy(np.ascontiguousarray(row[None, :], np.float32)).to(model.device)
        k_margin, k_prob = model.margin_fn(x)
        p_margin, p_prob = fused_score_reference(
            model.pack, x, n_features=model.n_features, with_shap=False
        )
        if not torch.equal(k_margin, p_margin):
            raise AssertionError(f"row {i}: kernel margin {k_margin.tolist()} vs plain {p_margin.tolist()}")
        d = float((k_prob - p_prob).abs().max())
        if d > TOL_PROB or prob != float(k_prob[0]):
            raise AssertionError(
                f"row {i}: prob {prob}, kernel {float(k_prob[0])}, plain {float(p_prob[0])}"
            )
        err = max(err, d)
    return err


def degraded_predict(service: ScorerService) -> dict:
    """Phase 6d: the SHAP launch made to fail; /predict over HTTP degrades."""
    service._model.shap_fn = _boom
    server = make_async_server(service, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{server.port}"
    try:
        row = request_rows(1, SEED + 6)[0]
        resp = _post(base + "/predict", json.dumps(row).encode(), "application/json")
        ready = _get(base + "/readyz")
    finally:
        server.close()
    if resp.get("degraded") is not True or resp.get("shap_values") is not None:
        raise AssertionError(f"/predict did not degrade: {resp}")
    model = service._model
    x = model.rows_array([{n: float(row[k]) for n, k in zip(schema.SERVING_FEATURES, _request_keys())}])
    if ready["microbatch"]["degraded_batches"] != 1:
        raise AssertionError(f"readyz after the degraded /predict: {ready['microbatch']}")
    err = _margin_only_vs_plain(model, [x[0]], [resp["prob_default"]])
    return {"prob_default": resp["prob_default"], "prob_max_abs_err": err,
            "degraded_batches": ready["microbatch"]["degraded_batches"]}


# -- the training protocol ---------------------------------------------------------

#: Loans of the card-vs-CPU protocol run (8a), and its profile: RFE 104 -> 62
#: -> 20 with a 10-tree selector, and a 4 x 2 search over depths 3 and 5 whose
#: CPU run takes seconds. Its candidates draw no row or column samples: the
#: card's random generator draws other numbers than the CPU's.
PROTOCOL_CHECK_ROWS = 50_000
CHECK_PROFILE = PipelineConfig(
    rfe=RFEConfig(n_select=20, step=42, n_estimators=10, max_depth=3),
    tune=TuneConfig(
        n_iter=4,
        cv_folds=2,
        param_space={"n_estimators": (10, 20), "max_depth": (3, 5), "learning_rate": (0.1,)},
    ),
)
#: CV and held-out AUC, card against CPU.
TOL_PROTOCOL_AUC = 1e-4
#: Raw rows scored through predict_raw on the pipeline's artifact.
PROTOCOL_SERVE_ROWS = 16
#: The depth of phase 8b's deepest histogram shape: the search's depth-9
#: candidates (K = 256 nodes at the last level).
DEEPEST = 9


def protocol_card_vs_cpu(device: str = "cuda", n_rows: int = PROTOCOL_CHECK_ROWS) -> dict:
    """Phase 8a: `run_pipeline` on one raw frame, on the card and on the CPU."""
    frame = synthetic_lendingclub_frame(n_rows, seed=SEED)
    runs, secs = {}, {}
    for dev in (device, "cpu"):
        t0 = time.perf_counter()
        runs[dev] = run_pipeline(CHECK_PROFILE, raw=frame, device=dev, today=TODAY)
        secs[dev] = time.perf_counter() - t0
    card, cpu = runs[device], runs["cpu"]
    cc, pc = card.search.cv_results_, cpu.search.cv_results_
    if card.selected_features != cpu.selected_features:
        raise AssertionError(f"RFE selected {card.selected_features} on the card, "
                             f"{cpu.selected_features} on the CPU")
    if cc["params"] != pc["params"] or not np.array_equal(cc["val_masks"], pc["val_masks"]):
        raise AssertionError("the search's candidates or folds differ between card and CPU")
    if card.best_params != cpu.best_params:
        raise AssertionError(f"best params {card.best_params} on the card, {cpu.best_params} on the CPU")
    cv_err = float(np.abs(cc["split_test_scores"] - pc["split_test_scores"]).max())
    test_err = abs(card.test_auc - cpu.test_auc)
    if max(cv_err, test_err) > TOL_PROTOCOL_AUC:
        raise AssertionError(f"AUCs differ between card and CPU: CV by {cv_err}, test by {test_err}")
    return {"loans": n_rows, "card_s": secs[device], "cpu_s": secs["cpu"],
            "selected_features": list(card.selected_features), "best_params": card.best_params,
            "cv_auc_max_abs_err": cv_err, "test_auc_abs_err": test_err,
            "test_auc": card.test_auc, "hist_launches": card.hist_launches}


def search_launches(base: GBDTConfig, tune: TuneConfig, search) -> int:
    """Histogram launches of `randomized_search`: one per tree level of
    every tree a bucket's (candidate, fold) jobs boosted together (one
    joint launch for all of them), then of the refit. Under halving a
    candidate's jobs boost whole chunks up to its last rung's budget (capped
    at its ``n_estimators``), ``min(chunk * ceil(scored_at / chunk),
    n_estimators)`` trees from the report's ``scored_at_trees`` and its
    depth's chunk, and a bucket launches for its candidate boosted
    furthest."""
    report = search.cv_results_.get("halving")
    cands = search.cv_results_["params"]
    total = 0
    for idxs in search_buckets(cands, base):
        g = base.replace(**cands[idxs[0]])
        trees = g.n_estimators
        if report is not None:
            chunk = report["chunk_trees"][g.max_depth]
            trees = max(min(chunk * math.ceil(report["scored_at_trees"][c] / chunk), g.n_estimators)
                        for c in idxs)
        total += trees * g.max_depth
    best = base.replace(**search.best_params_)
    return total + best.n_estimators * best.max_depth


def expected_launches(cfg: PipelineConfig, res: PipelineResult, n_features: int) -> dict[str, int]:
    """Histogram launches each stage of `run_pipeline` must make on the card:
    one per tree level of every fit (RFE refits, CV jobs, the refit)."""
    rfe_cfg = cfg.rfe
    n_iters = -(-(n_features - rfe_cfg.n_select) // rfe_cfg.step)
    data = ("host_frontier", "device_ingest") if cfg.data.device_pipeline else ("clean", "engineer")
    return {**dict.fromkeys(data, 0),
            "rfe": n_iters * rfe_cfg.n_estimators * rfe_cfg.max_depth,
            "search": search_launches(cfg.gbdt, cfg.tune, res.search), "eval": 0}


def serve_payloads(store: ObjectStore, key: str, payloads: list[dict], dev: torch.device) -> dict:
    """`ScorerService.predict_raw` on raw payloads with the published
    artifact: one ``score_forest`` launch per row (on the card), each
    prob against the plain version of the margin-only launch."""
    service = ScorerService.from_store(store, ServeConfig(model_key=key), device=dev)
    try:
        fused_score.launches = 0
        resps = [service.predict_raw(p) for p in payloads]
        launches = fused_score.launches
        if dev.type == "cuda" and launches != len(payloads):
            raise AssertionError(f"{launches} fused_score launches for {len(payloads)} rows")
        rows = [np.array([r["engineered_row"][n] for n in service.feature_names], np.float32)
                for r in resps]
        return {"rows": len(resps), "launches": launches,
                "prob_max_abs_err": _margin_only_vs_plain(
                    service._model, rows, [r["prob_default"] for r in resps])}
    finally:
        service.close()


def same_forest(a: gbdt.Forest, b: gbdt.Forest) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f).to(getattr(a, f).device))
               for f in ("feature", "thr_bin", "thr_float", "missing_left", "gain", "cover",
                         "leaf_value"))


def protocol_phase(
    card: str, frame: RawFrame, cfg: PipelineConfig, train_rows: tuple, root: str,
    device: str = "cuda",
) -> tuple[dict, dict, list[dict], PipelineResult, list[dict]]:
    """Phase 8b: the main path, `run_pipeline` from the raw table to a
    published artifact in the store at ``root`` (with its intermediate
    tables and stage manifests), served by `predict_raw`; then the first
    tree's histograms at the protocol's new shapes. Returns (summary,
    launches of each kernel on the path, histogram records, the run's
    result, the raw payloads it served)."""
    dev = torch.device(device)
    picks = np.sort(np.random.default_rng(SEED + 8).choice(frame.n_rows, PROTOCOL_SERVE_ROWS, replace=False))
    payloads = row_dicts(frame, picks)
    out: dict = {}
    store = ObjectStore(root)
    key = cfg.serve.model_key
    gradient_histogram_channels.launches = 0
    fused_score.launches = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    obs = {"stages_before": stage_histogram()}
    hist_before = program_counts("gradient_histogram/")
    t0 = time.perf_counter()
    res = run_pipeline(cfg, raw=frame, store=store, device=dev, today=TODAY)
    out["run_pipeline_s"] = time.perf_counter() - t0
    obs["hist_programs"] = program_delta(hist_before, program_counts("gradient_histogram/"))
    out["joint_launches"] = sum(n for k, (n, _) in obs["hist_programs"].items()
                                if k.startswith("gradient_histogram/J"))
    hist_launches = gradient_histogram_channels.launches
    if dev.type == "cuda":
        out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    n_features = len(train_rows[2])
    expect = expected_launches(cfg, res, n_features)
    if dev.type == "cuda" and (res.hist_launches != expect or hist_launches != sum(expect.values())):
        raise AssertionError(f"histogram launches {res.hist_launches} (total {hist_launches}), "
                             f"expected {expect}")
    report = res.search.cv_results_.get("halving")
    out.update(
        stage_s=res.timings, hist_launches=res.hist_launches, tree_features=n_features,
        selected_features=list(res.selected_features),
        candidates=res.search.cv_results_["params"],
        mean_cv_auc=res.search.cv_results_["mean_test_score"].tolist(),
        best_params=res.best_params, cv_auc=res.cv_auc, test_auc=res.test_auc,
        scale_pos_weight=res.scale_pos_weight, stages_run=list(res.stages_run),
        intermediates=res.intermediates, halving=report,
    )
    if cfg.tune.halving_enabled and cfg.tune.chunk_trees is not None and report is None:
        raise AssertionError("the quick profile's search ran without halving")
    if report is not None:
        print(f"halving rungs (8b): budgets={report['budgets']} chunk={report['chunk_trees']} "
              f"rungs={json.dumps(report['rungs'])} survivors={report['survivors']} "
              f"scored_at_trees={report['scored_at_trees']} [{card}]")
    if res.intermediates:
        sizes = res.intermediates["bytes"]
        print(f"intermediates (8b): {res.intermediates['seconds']:.3f}s to write "
              f"{sum(sizes.values())} bytes ({json.dumps(sizes)}) [{card}]")
    if len(res.selected_features) != cfg.rfe.n_select or not 0.5 < res.test_auc <= 1.0:
        raise AssertionError(f"{len(res.selected_features)} features, test AUC {res.test_auc}")
    metrics = store.get_json(key + ".metrics.json")
    if set(metrics) != {"auc", "classification_report", "best_params"}:
        raise AssertionError(f"metrics.json keys {sorted(metrics)}")
    if store.get_json(key + ".features.json") != list(res.selected_features):
        raise AssertionError("features.json differs from the selected features")
    ckpt = PipelineCheckpoint(store, cfg.reliability.checkpoint_prefix)
    if any(ckpt.load(stage) is None for stage in STAGES):
        raise AssertionError("a stage manifest is missing after the run")
    art = GBDTArtifact.load(store, key, dev)
    if not same_forest(art.forest, res.artifact.forest):
        raise AssertionError("the reloaded artifact differs")
    if art.plan is None or art.feature_names != res.selected_features:
        raise AssertionError("the reloaded artifact lost its plan or its features")
    del art
    out["predict_raw"] = serve_payloads(store, key, payloads, dev)
    score_launches = out["predict_raw"]["launches"]
    records = []  # kernel against plain: on the card only
    if dev.type == "cuda":
        records = protocol_histogram_shapes(train_rows, out["selected_features"],
                                            out["scale_pos_weight"], dev)
    for r in records:
        print(histogram_line(r, card))
    print(f"protocol: {json.dumps(out)} [{card}]")
    out["observability"] = obs  # phase 11b reads it
    return out, {"gradient_histogram": hist_launches, "score_forest": score_launches}, records, res, payloads


def protocol_rows(frame: RawFrame, device: str = "cuda") -> tuple:
    """The training split of every tree feature after the leakage drop, as
    phase 6 makes it, on the host: ``(X, y, names)``."""
    res = run_device_ingest(tokenize_raw_frame(frame, today=TODAY), device=device)
    ff = drop_training_leakage(res.tree)
    X_train, _, y_train, _ = train_test_split_hashed(ff.X, ff.y)
    return X_train.cpu(), y_train.cpu(), ff.feature_names


def protocol_histogram_shapes(train_rows: tuple, selected: list[str], spw: float,
                              dev: torch.device) -> list[dict]:
    """The first tree's histogram calls, kernel against plain (as 5b), at the
    shapes the protocol brings: the default RFE selector's (64 bins, every
    tree feature, depth 6) and a depth-9 search candidate's (255 bins, the
    selected features, up to K = 256 nodes)."""
    X_cpu, y_cpu, names = train_rows
    X, y = X_cpu.to(dev), y_cpu.to(dev)
    rfe_cfg = RFEConfig()
    bins = transform(compute_bin_edges(X, SELECTOR_BINS), X)
    hp = gbdt.GBDTHyperparams.from_config(GBDTConfig(
        n_estimators=rfe_cfg.n_estimators, max_depth=rfe_cfg.max_depth, n_bins=SELECTOR_BINS,
        scale_pos_weight=spw))
    calls = first_tree_calls(bins, y, hp, gbdt.fold_in(rfe_cfg.seed, 0), SELECTOR_BINS,
                             rfe_cfg.max_depth)
    records = [dict(r, shape=f"rfe selector F={bins.shape[1]} B={SELECTOR_BINS} {r['shape']}")
               for r in histogram_phase(bins, calls, SELECTOR_BINS)]
    del bins, calls
    Xs = X.index_select(1, torch.tensor([names.index(n) for n in selected], device=dev))
    del X
    cfg = GBDTConfig(n_estimators=1, max_depth=DEEPEST, scale_pos_weight=spw)
    bins = transform(compute_bin_edges(Xs, cfg.n_bins), Xs)
    calls = first_tree_calls(bins, y, gbdt.GBDTHyperparams.from_config(cfg), cfg.seed,
                             cfg.n_bins, DEEPEST)
    records += [dict(r, shape=f"depth {DEEPEST} F={bins.shape[1]} B={cfg.n_bins} {r['shape']}")
                for r in histogram_phase(bins, calls, cfg.n_bins)]
    return records


# -- the protocol's resumable, halving path (phase 10) ---------------------------------

#: Report keys of the reference's halving search.
HALVING_KEYS = ("eta", "budgets", "rungs", "pruned_candidates", "survivors", "scored_at_trees",
                "dispatches", "chunk_trees")
#: 10c: card against CPU. RFECV's scores (20-tree depth-3 fold fits)
#: within 1e-6; the chunked search's (up to 48 trees of depth 5) within
#: 8a's tolerance: the card's fixed-point histogram sums round otherwise
#: than the CPU's float sums, and over 48 trees the margins drift apart by
#: ulps that reorder a few rows (2.03e-6 measured on the H100).
TOL_RFECV_AUC = 1e-6
#: 10c's loans: cut from 8a's 50,000 for time (its CPU side took 112 s).
SELECTION_CHECK_ROWS = 20_000
#: 10c's search: chunks of 12 trees, candidates that draw nothing.
CHUNKED_TUNE = TuneConfig(
    n_iter=4, cv_folds=2, chunk_trees=12,
    param_space={"n_estimators": (24, 48), "max_depth": (3, 5), "learning_rate": (0.1, 0.3)},
)


def _cv_equal(a: dict, b: dict) -> bool:
    """Two searches' results bitwise equal: candidates, split and mean
    scores, and the halving report."""
    return (a["params"] == b["params"]
            and np.array_equal(a["split_test_scores"], b["split_test_scores"])
            and np.array_equal(a["mean_test_score"], b["mean_test_score"])
            and a.get("halving") == b.get("halving"))


def halving_phase(card: str, train_rows: tuple, cfg: PipelineConfig, res: PipelineResult,
                  device: str = "cuda") -> dict:
    """Phase 10a: the quick profile's search on 8b's selected training
    columns and ``scale_pos_weight``, with halving and exhaustive: each
    survivor's split scores bitwise the exhaustive run's, the halving run
    bitwise 8b's search, the rungs and chunk those the reference's cost
    model and ladder give at this row count; then one chunk of a rung-1 job
    with CUDA events around each histogram launch (on the card)."""
    dev = torch.device(device)
    X_cpu, y_cpu, names = train_rows
    X = X_cpu.index_select(1, torch.tensor([names.index(n) for n in res.selected_features])).to(dev)
    y = y_cpu.to(dev)
    N, F = X.shape
    base = cfg.gbdt.replace(scale_pos_weight=res.scale_pos_weight)
    runs, out = {}, {"rows": N, "features": F}
    for mode, halving in (("halving", True), ("exhaustive", False)):
        tune = dataclasses.replace(cfg.tune, halving_enabled=halving)
        gradient_histogram_channels.launches = 0
        joint_before = program_counts("gradient_histogram/J")
        _sync(dev)
        t0 = time.perf_counter()
        runs[mode] = randomized_search(X, y, base, tune, device=dev)
        _sync(dev)
        out[f"{mode}_s"] = time.perf_counter() - t0
        out[f"{mode}_launches"] = gradient_histogram_channels.launches
        out[f"{mode}_joint_launches"] = sum(
            n for n, _ in program_delta(joint_before, program_counts("gradient_histogram/J")).values())
        expect = search_launches(base, tune, runs[mode])
        if dev.type == "cuda" and out[f"{mode}_launches"] != expect:
            raise AssertionError(f"{mode} search: {out[f'{mode}_launches']} launches, expected {expect}")
    hv, ex = runs["halving"], runs["exhaustive"]
    report = hv.cv_results_.get("halving")
    if report is None or "halving" in ex.cv_results_:
        raise AssertionError("halving did not engage, or engaged in the exhaustive run")
    surv = report["survivors"]
    if not np.array_equal(hv.cv_results_["split_test_scores"][surv], ex.cv_results_["split_test_scores"][surv]):
        raise AssertionError("a survivor's scores differ from the exhaustive run's")
    if not _cv_equal(hv.cv_results_, res.search.cv_results_) or hv.best_params_ != res.best_params:
        raise AssertionError("the halving search differs from 8b's on the same columns")
    # The reference's cost model and ladder at this shape.
    cands = hv.cv_results_["params"]
    K = cfg.tune.cv_folds
    cfgs = [base.replace(**c) for c in cands]
    chunk_of = {}
    for d in sorted({c.max_depth for c in cfgs}):
        groups = [g for g in search_buckets(cands, base) if cfgs[g[0]].max_depth == d]
        cap = max(cfgs[i].n_estimators for g in groups for i in g)
        ck = resolve_chunk_trees(cfg.tune.chunk_trees, n_trees=cap, n_rows=N, n_feats=F,
                                 n_bins=base.n_bins, depth=d, hist_subtract=base.hist_subtract,
                                 n_jobs=max(_pow2_jobs(len(g) * K, 1) for g in groups))
        chunk_of[d] = cap if ck is None else min(ck, cap)
    budgets = halving_ladder(max(c.n_estimators for c in cfgs), len(cands),
                             eta=cfg.tune.halving_eta, min_rungs=cfg.tune.halving_min_rungs)
    if report["chunk_trees"] != chunk_of or report["budgets"] != budgets:
        raise AssertionError(f"rungs {report['budgets']} chunk {report['chunk_trees']}, "
                             f"the cost model gives {budgets} and {chunk_of}")
    out.update(budgets=budgets, chunk_trees=chunk_of, rungs=report["rungs"], survivors=surv,
               scored_at_trees=report["scored_at_trees"], best_params=hv.best_params_,
               exhaustive_best_params=ex.best_params_,
               quick_shape_26_and_75_150_300=(chunk_of == {3: 26} and budgets == [75, 150, 300]))
    if dev.type == "cuda":
        out["rung_hist"] = rung_histogram(X, y, y_cpu, base, cfg.tune, cands.index(hv.best_params_),
                                          chunk_of)
    print(f"halving vs exhaustive (10a): {json.dumps(out)} [{card}]")
    return out


def rung_histogram(X, y, y_cpu, base: GBDTConfig, tune: TuneConfig, best: int, chunk_of: dict) -> dict:
    """The histogram inside a halving rung: the first chunk of candidate
    ``best``'s bucket, all its (candidate, fold) jobs in one joint launch a
    level (the search's path), with CUDA events around each launch; device
    ms per launch at each level."""
    dev = X.device
    F = X.shape[1]
    K = tune.cv_folds
    cands = sample_candidates(tune.param_space, tune.n_iter, tune.seed)
    idxs = next(b for b in search_buckets(cands, base) if best in b)
    jobs = [(c, k) for c in idxs for k in range(K)]
    hps = [gbdt.GBDTHyperparams.from_config(base.replace(**cands[c])) for c, _ in jobs]
    bins = transform(compute_bin_edges(X, base.n_bins), X)
    val = torch.from_numpy(stratified_kfold_masks(y_cpu.numpy(), K, tune.seed)).to(dev).float()
    timer = TimedHistogram(gradient_histogram_jobs)
    depth = hps[0].max_depth
    chunk = chunk_of[depth]
    gbdt.fit_binned_jobs(
        bins, y, (1.0 - val[[k for _, k in jobs]]).contiguous(),
        torch.ones(F, dtype=torch.bool, device=dev), hps,
        [gbdt.fold_in(tune.seed, c * K + k) for c, k in jobs],
        n_trees_cap=chunk, depth_cap=depth, n_bins=base.n_bins, histogram=timer,
    )
    total = timer.total_ms()
    per_call = [s.elapsed_time(e) for s, e in timer.events]
    return {
        "candidates": idxs, "jobs": len(jobs), "trees": chunk, "launches": len(per_call),
        "ms_total": total,
        "ms_per_level": [float(np.mean(per_call[lvl::depth])) for lvl in range(depth)],
    }


def resume_phase(card: str, root: str, cfg: PipelineConfig, res: PipelineResult,
                 payloads: list[dict], device: str = "cuda") -> dict:
    """Phase 10b: resume 8b's run from its store on the card: all stages up
    to the search restored, the refit and the artifact bitwise 8b's; then,
    with the search's manifest invalidated, the search rerun bitwise 8b's;
    then raw rows served by the resumed artifact."""
    dev = torch.device(device)
    store = ObjectStore(root)
    ckpt = PipelineCheckpoint(store, cfg.reliability.checkpoint_prefix)
    out: dict = {}
    fps = stage_fingerprints(cfg)
    t0 = time.perf_counter()
    valid = {stage: ckpt.valid(stage, fps[stage]) for stage in STAGES}
    out["validate_s"] = time.perf_counter() - t0
    if not all(valid.values()):
        raise AssertionError(f"8b's manifests do not validate: {valid}")
    out["tree_csv_bytes"] = ckpt.load("engineer")["pointers"][cfg.data.tree_key]["size"]
    key = cfg.serve.model_key
    best = cfg.gbdt.replace(**res.best_params)
    runs = {}
    for name, skipped, run in (
        ("resume", ("clean", "engineer", "rfe", "search"), ("eval",)),
        ("resume_after_invalidate", ("clean", "engineer", "rfe"), ("search", "eval")),
    ):
        if name == "resume_after_invalidate":
            ckpt.invalidate("search")
        gradient_histogram_channels.launches = 0
        _sync(dev)
        t0 = time.perf_counter()
        r = runs[name] = run_pipeline(cfg, raw=None, store=store, resume=True, device=dev, today=TODAY)
        out[f"{name}_s"] = time.perf_counter() - t0
        out[f"{name}_stage_s"] = r.timings
        out[f"{name}_launches"] = gradient_histogram_channels.launches
        if r.stages_skipped != skipped or r.stages_run != run:
            raise AssertionError(f"{name}: ran {r.stages_run}, skipped {r.stages_skipped}")
        if not same_forest(r.artifact.forest, res.artifact.forest) or r.test_auc != res.test_auc:
            raise AssertionError(f"{name}: the artifact or test AUC differs from 8b's")
        if r.selected_features != res.selected_features or r.best_params != res.best_params:
            raise AssertionError(f"{name}: the selection or the best params differ from 8b's")
    refit = best.n_estimators * best.max_depth
    rerun = search_launches(cfg.gbdt.replace(scale_pos_weight=res.scale_pos_weight), cfg.tune, res.search)
    if dev.type == "cuda" and (out["resume_launches"], out["resume_after_invalidate_launches"]) != (refit, rerun):
        raise AssertionError(f"resumed runs made {out['resume_launches']} and "
                             f"{out['resume_after_invalidate_launches']} launches, not {refit} and {rerun}")
    # The first resume's "restore" stage is the read of the tree CSV:
    # fetched and verified against its pointer, parsed, moved to the card.
    out["read_tree_csv_s"] = runs["resume"].timings["restore"]
    if not _cv_equal(runs["resume_after_invalidate"].search.cv_results_, res.search.cv_results_):
        raise AssertionError("the rerun search's results differ from 8b's")
    if not GBDTArtifact.load(store, key, dev).forest.leaf_value.equal(res.artifact.forest.leaf_value.to(dev)):
        raise AssertionError("the stored artifact differs from 8b's")
    out["predict_raw"] = serve_payloads(store, key, payloads[:4], dev)
    print(f"resume (10b): {json.dumps(out)} [{card}]")
    return out


def selection_card_vs_cpu(card: str, n_rows: int = PROTOCOL_CHECK_ROWS, device: str = "cuda") -> dict:
    """Phase 10c: RFECV and a chunked halving search on the card and on the
    CPU, on 8a's frame. Nothing draws at random (the quick selector;
    candidates with subsample = colsample = 1)."""
    X, y, _ = protocol_rows(synthetic_lendingclub_frame(n_rows, seed=SEED), device)
    n_pos = float(y.sum())
    rfe_cfg = dataclasses.replace(quick_config().rfe, scale_pos_weight=(len(y) - n_pos) / n_pos)
    out: dict = {"rows": int(X.shape[0]), "features": int(X.shape[1])}
    sel, secs = {}, {}
    for dev in (device, "cpu"):
        t0 = time.perf_counter()
        sel[dev] = rfe_select(X, y, rfe_cfg, cv_folds=3, device=dev)
        secs[dev] = time.perf_counter() - t0
    card_r, cpu_r = sel[device], sel["cpu"]
    if not (np.array_equal(card_r.support_, cpu_r.support_) and np.array_equal(card_r.ranking_, cpu_r.ranking_)):
        raise AssertionError("RFECV selects other features on the card")
    if sorted(card_r.cv_scores_) != sorted(cpu_r.cv_scores_):
        raise AssertionError("RFECV scored other feature counts on the card")
    rfecv_err = max(abs(card_r.cv_scores_[n] - cpu_r.cv_scores_[n]) for n in cpu_r.cv_scores_)
    out.update(rfecv_card_s=secs[device], rfecv_cpu_s=secs["cpu"], rfecv_cv_scores=cpu_r.cv_scores_,
               rfecv_n_features=cpu_r.n_features_, rfecv_max_abs_err=rfecv_err)
    Xs = X[:, torch.from_numpy(np.flatnonzero(cpu_r.support_))]
    search = {}
    for dev in (device, "cpu"):
        t0 = time.perf_counter()
        search[dev] = randomized_search(Xs, y, GBDTConfig(), CHUNKED_TUNE, device=dev)
        secs[dev] = time.perf_counter() - t0
    card_s, cpu_s = search[device].cv_results_, search["cpu"].cv_results_
    if "halving" not in cpu_s or any(card_s["halving"][k] != cpu_s["halving"][k] for k in HALVING_KEYS):
        raise AssertionError("the halving reports differ between card and CPU")
    search_err = float(np.abs(card_s["split_test_scores"] - cpu_s["split_test_scores"]).max())
    if search[device].best_params_ != search["cpu"].best_params_:
        raise AssertionError("the halving search picked another winner on the card")
    out.update(search_card_s=secs[device], search_cpu_s=secs["cpu"], halving=cpu_s["halving"],
               best_params=search["cpu"].best_params_, search_max_abs_err=search_err)
    if rfecv_err > TOL_RFECV_AUC or search_err > TOL_PROTOCOL_AUC:
        raise AssertionError(f"card and CPU scores differ: RFECV by {rfecv_err}, search by {search_err}")
    print(f"selection card_vs_cpu (10c): {json.dumps(out)} [{card}]")
    return out


def quantized_phase(card: str) -> tuple[list[dict], dict]:
    """Phase 9: the bf16 and int8 packs (9a), the kernel against the plain
    version at every bucket on phase 3's rows (9b), and an int8 service
    over HTTP (9c). Prints each record; returns the kernel records and the
    service's."""
    records = []
    for precision in QUANTIZED:
        print(f"quantized pack: {json.dumps(quantized_pack_phase(precision))} [{card}]")
        for r in kernel_phase("cuda", precision):
            records.append(r)
            print(f"kernel score_forest precision={precision} bucket={r['bucket']} "
                  f"shap={r['with_shap']} ms={r['ms']:.6f} plain_ms={r['plain_ms']:.6f} "
                  f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) "
                  f"err={ {k: r[k] for k in ('prob', 'phis', 'additivity') if k in r} } "
                  f"[{card}]")
    serving = serving_phase("cuda", precision="int8")
    print(f"serving: {json.dumps(serving)} [{card}]")
    return records, serving


# -- observability (phase 11) -----------------------------------------------------

#: Bursts of 64 concurrent /predict, each held into one 64-row batch (11a).
BURSTS_64 = 4
#: Rows of the training CLI's run in 11c.
CLI_ROWS = 200_000
#: The device ingest's programs every device-path run records (the
#: reference's names; ``binning`` is its one-device form).
INGEST_STEPS = {"null_stats", "row_compact", "fill", "dedupe", "vocab_census", "stats",
                "assemble", "binning"}
#: Recorded dispatches timed on the host in 11d.
OVERHEAD_DISPATCHES = 10_000


def program_counts(prefix: str) -> dict[str, tuple[int, float]]:
    """``{program: (dispatches, dispatch seconds)}`` of the programs whose
    name starts with ``prefix`` (their finished events resolved)."""
    return {
        r["name"]: (r["dispatches"], r["dispatch_seconds"])
        for r in default_program_registry().table()
        if r["name"].startswith(prefix)
    }


def program_delta(before: dict, after: dict) -> dict[str, tuple[int, float]]:
    """Dispatches and seconds each program added between two counts."""
    out = {}
    for name, (n, sec) in after.items():
        n0, s0 = before.get(name, (0, 0.0))
        if n != n0:
            out[name] = (n - n0, sec - s0)
    return out


def _label_samples(fams: dict, family: str, label: str) -> dict[str, float]:
    """``{label value: value}`` of a `parse_exposition` family."""
    out = {}
    for key, value in fams.get(family, {}).get("samples", {}).items():
        for part in key.split("|")[1:]:
            name, _, v = part.partition("=")
            if name == label:
                out[v] = value
    return out


def _get_with_id(url: str, request_id: str | None) -> tuple[int, dict, bytes]:
    headers = {} if request_id is None else {"X-Request-ID": request_id}
    with urllib.request.urlopen(urllib.request.Request(url, headers=headers), timeout=60) as resp:
        return resp.status, dict(resp.headers), resp.read()


def observability_serving_phase(card: str, kernel_records: list[dict], device: str = "cuda") -> dict:
    """Phase 11a: phase 4's traffic (32 concurrent /predict, a 5,000-row
    bulk CSV, an importance request) to the committed model on the card,
    then `BURSTS_64` bursts of 64 concurrent /predict held into one 64-row
    batch each; ``/metrics`` scraped and parsed with the port's
    `parse_exposition`: the ``score_forest`` programs' dispatches sum to
    the ``fused_score.launches`` delta over the phase and their event
    seconds are above 0; the mean device ms per dispatch at the 64-row SHAP
    bucket beside phase 3's CUDA-event ms there; ``cobalt_device_mem_bytes``
    present, ``bytes_limit`` equal to ``mem_get_info``'s total;
    ``/debug/trace``, ``/debug/slowest``, ``/slo`` and ``X-Request-ID``.
    On ``device="cpu"`` the plain version's programs are read, and no
    launch is counted."""
    cuda = device == "cuda"
    entry = "score_forest/" if cuda else "score_forest_plain/"
    fused_score.launches = 0
    before = program_counts(entry)
    service = ScorerService.from_store(ObjectStore(str(STORE)), ServeConfig(), device=device)
    server = make_async_server(service, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{server.port}"
    out: dict = {}
    try:
        rows = request_rows(32)
        with ThreadPoolExecutor(max_workers=64) as pool:
            list(pool.map(lambda r: _post(base + "/predict", json.dumps(r).encode(),
                                          "application/json"), rows))
            Xb = seeded_rows(service._model.pack, 5000, SEED + 1)
            lines = [",".join(f'"{n}"' for n in service.feature_names)]
            lines += [",".join("" if np.isnan(v) else repr(float(v)) for v in r) for r in Xb]
            _post(base + "/predict_bulk_csv", "\n".join(lines).encode(), "text/csv")
            _post(base + "/feature_importance_bulk", json.dumps({"data": rows[:2]}).encode(),
                  "application/json")
            # Distinct rows per burst: a repeated payload is a score-cache
            # hit, which never queues. 64 in flight is the admission cap.
            for b in range(BURSTS_64):
                burst = request_rows(64, SEED + 11 + b)
                with service.batcher.pause():
                    futs = [pool.submit(_post, base + "/predict", json.dumps(r).encode(),
                                        "application/json") for r in burst]
                    while service.batcher.queue_depth() < len(burst):
                        time.sleep(0.001)
                [f.result() for f in futs]
        status, headers, text = _get_with_id(base + "/metrics", "chip-smoke-11a")
        if status != 200 or headers.get("X-Request-ID") != "chip-smoke-11a":
            raise AssertionError(f"/metrics answered {status} with X-Request-ID "
                                 f"{headers.get('X-Request-ID')!r}")
        fams = parse_exposition(text.decode())
        _, minted, _ = _get_with_id(base + "/healthz", None)
        if not minted.get("X-Request-ID"):
            raise AssertionError("no X-Request-ID minted for a request without one")
        trace = json.loads(_get_with_id(base + "/debug/trace", None)[2])
        slowest = json.loads(_get_with_id(base + "/debug/slowest", None)[2])["slowest"]
        slo = json.loads(_get_with_id(base + "/slo", None)[2])
    finally:
        server.close()
        service.close()
    launches = fused_score.launches
    dispatches = _label_samples(fams, "cobalt_program_dispatches_total", "program")
    seconds = _label_samples(fams, "cobalt_program_dispatch_seconds_total", "program")
    scraped = {k: (int(dispatches[k]), seconds[k]) for k in dispatches if k.startswith(entry)}
    delta = program_delta(before, scraped)
    n_disp = sum(n for n, _ in delta.values())
    if cuda and (n_disp != launches or launches == 0):
        raise AssertionError(f"score_forest programs dispatched {n_disp} times, "
                             f"fused_score.launches rose by {launches}: {delta}")
    if not all(sec > 0 for _, sec in delta.values()):
        raise AssertionError(f"a score_forest program has no event seconds: {delta}")
    n64, s64 = delta[entry + "f32/64/shap"]
    out["score_forest_dispatches"] = n_disp
    out["score_forest_programs"] = {k: {"dispatches": n, "seconds": sec} for k, (n, sec) in delta.items()}
    out["ms_per_dispatch_64_shap"] = s64 / n64 * 1e3
    out["phase3_ms_64_shap"] = next(r["ms"] for r in kernel_records if r["bucket"] == 64)
    mem = _label_samples(fams, "cobalt_device_mem_bytes", "device")
    if cuda:
        limit = device_info()[0]["memory_stats"]["bytes_limit"]
        total = torch.cuda.mem_get_info(0)[1]
        if not mem.get("cuda:0", 0) > 0 or limit != total:
            raise AssertionError(f"cobalt_device_mem_bytes {mem}, bytes_limit {limit} vs "
                                 f"mem_get_info {total}")
        out["bytes_limit"] = limit
    elif set(mem) != {"cpu"}:
        raise AssertionError(f"cobalt_device_mem_bytes on the CPU: {mem}")
    out["device_mem_bytes"] = mem
    dispatch_spans = [e for e in trace["traceEvents"] if e.get("name") == "serve.dispatch"]
    if not dispatch_spans:
        raise AssertionError("/debug/trace holds no serve.dispatch span")
    if not slowest or not all("dispatch" in r["phases_ms"] for r in slowest if r["route"] == "/predict"):
        raise AssertionError(f"/debug/slowest lists no request with its phases: {slowest[:2]}")
    if not slo.get("objectives"):
        raise AssertionError(f"/slo answered {slo}")
    out["trace_dispatch_spans"] = len(dispatch_spans)
    out["slowest"] = [{"route": r["route"], "duration_ms": r["duration_ms"],
                       "phases_ms": r["phases_ms"]} for r in slowest[:3]]
    print(f"observability serving (11a): score_forest dispatches {n_disp} = launches {launches}; "
          f"64-row SHAP bucket {out['ms_per_dispatch_64_shap']:.6f} ms per dispatch (CUDA events "
          f"in the registry, {n64} dispatches) vs phase 3 {out['phase3_ms_64_shap']:.6f} ms "
          f"[{card}]")
    return out


def stage_histogram() -> dict[str, tuple[int, float]]:
    """``{stage: (count, sum)}`` of ``cobalt_pipeline_stage_seconds``."""
    fam = default_registry().snapshot().get("cobalt_pipeline_stage_seconds", {})
    return {s["labels"]["stage"]: (s["count"], s["sum"]) for s in fam.get("samples", [])}


def observability_protocol(card: str, res: PipelineResult, obs: dict, cfg: PipelineConfig) -> dict:
    """Phase 11b, on 8b's run: ``cobalt_pipeline_stage_seconds`` observed
    once per stage, equal to ``result.timings`` to the snapshot's rounding;
    the tracer's last ``pipeline.run`` span with every stage as a child; the
    histogram programs' dispatches over the run equal to its
    ``hist_launches``, split into ``rfe`` (the selector's bins) and
    ``search`` (the model's), their event seconds beside the stages'."""
    hist = {k: (c - obs["stages_before"].get(k, (0, 0.0))[0],
                sm - obs["stages_before"].get(k, (0, 0.0))[1])
            for k, (c, sm) in stage_histogram().items()}
    for stage, sec in res.timings.items():
        count, total = hist.get(stage, (0, 0.0))
        if count != 1 or abs(total - round(sec, 6)) > 2e-6:
            raise AssertionError(f"stage {stage}: {count} observations summing {total}, timing {sec}")
    spans = default_tracer().export()
    run = [sp for sp in spans if sp["name"] == "pipeline.run"][-1]
    children = {sp["name"] for sp in spans if sp["parent_id"] == run["span_id"]}
    if children != {f"pipeline.{s}" for s in res.timings}:
        raise AssertionError(f"pipeline.run's children {sorted(children)}, stages {list(res.timings)}")
    delta = obs["hist_programs"]
    by_stage = {"rfe": SELECTOR_BINS, "search": cfg.gbdt.n_bins}
    split = {}
    for stage, n_bins in by_stage.items():
        rows = [v for k, v in delta.items() if k.endswith(f"xB{n_bins}")]
        split[stage] = (sum(n for n, _ in rows), sum(sec for _, sec in rows))
    total = sum(n for n, _ in delta.values())
    if total != sum(res.hist_launches.values()) or any(
        split[st][0] != res.hist_launches[st] for st in split
    ):
        raise AssertionError(f"histogram programs {delta} against hist_launches {res.hist_launches}")
    out = {
        "hist_dispatches": total,
        "hist_programs": {k: {"dispatches": n, "seconds": sec} for k, (n, sec) in delta.items()},
    }
    for stage, (n, sec) in split.items():
        out[f"{stage}_hist_s"] = sec
        out[f"{stage}_stage_s"] = res.timings[stage]
        print(f"observability protocol (11b): {stage} stage {res.timings[stage]:.3f}s, of it "
              f"{sec:.3f}s inside {n} histogram launches (CUDA events; "
              f"{100 * sec / res.timings[stage]:.1f}%) [{card}]")
    return out


def observability_cli(card: str, root: str, n_rows: int = CLI_ROWS) -> dict:
    """Phase 11c: the training CLI in a subprocess with ``--ledger-out``
    and ``--trace-out``: the ledger loads with `load_ledger`, its program
    table holds the histogram programs with dispatches, event seconds and
    the H100 roofline estimate, and the trace parses."""
    ledger_path, trace_path = f"{root}/ledger.json", f"{root}/trace.json"
    cmd = [sys.executable, "-m", "cobalt_smart_lender_ai_tpu_torch.pipeline", "--quick",
           "--synthetic-rows", str(n_rows), "--ledger-out", ledger_path, "--trace-out", trace_path]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the training CLI exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    ledger = load_ledger(ledger_path)
    hist = [p for p in ledger["programs"] if p["name"].startswith("gradient_histogram/")]
    if not hist or not all(p["dispatches"] > 0 and p["dispatch_seconds"] > 0
                           and p["roofline_utilization"] is not None for p in hist):
        raise AssertionError(f"the ledger's histogram programs: {hist}")
    ingest = [p for p in ledger["programs"] if p["name"].startswith("ingest.")]
    steps = {p["name"].split(".", 1)[1].split("[", 1)[0] for p in ingest}
    if not INGEST_STEPS <= steps or not all(
        p["kind"] == "ingest" and p["dispatches"] > 0 and p["dispatch_seconds"] > 0 for p in ingest
    ):
        raise AssertionError(f"the ledger's ingest programs: {ingest}")
    with open(trace_path) as fh:
        trace = json.load(fh)
    names = {e["name"] for e in trace["traceEvents"]}
    if "pipeline.run" not in names:
        raise AssertionError(f"the trace file holds {sorted(names)}")
    out = {
        "rows": n_rows,
        "wall_s": wall,
        "stages": ledger["stages"],
        "programs": [{k: p[k] for k in ("name", "dispatches", "dispatch_seconds", "bound_seconds",
                                        "roofline_utilization")} for p in hist],
        "devices": ledger["env"]["devices"],
        "ingest_programs": [{k: p[k] for k in ("name", "dispatches", "dispatch_seconds")}
                            for p in ingest],
        # The build cache's counters in that second process (read by 20d).
        "compile": ledger["compile"],
    }
    print(f"observability cli (11c): {json.dumps(out)} [{card}]")
    return out


def recording_overhead(card: str, fit_s: float, fit_launches: int) -> dict:
    """Phase 11d: host µs of `OVERHEAD_DISPATCHES` recorded dispatches
    with no kernel between the events (what the histogram wrapper adds to
    a launch: the handle lookup, two event records, the cost count and the
    pool's resolution of finished pairs; the wrapper fetched the current
    stream before), on a handle of its own; that times 5c's launches, as a
    share of 5c's fit wall."""
    dev = torch.device("cuda", torch.cuda.current_device())
    own = ProgramHandle("overhead", "kernel", {})
    stream = torch.cuda.current_stream(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(OVERHEAD_DISPATCHES):
        histogram_program(20, 255, dev)
        pair = own.start(stream)
        flops, nbytes = histogram_cost(1_840_000, 20, 64, 255, 1)
        own.stop(pair, stream, rows=1_840_000, flops=flops, nbytes=nbytes)
    us = (time.perf_counter() - t0) / OVERHEAD_DISPATCHES * 1e6
    torch.cuda.synchronize()
    if own.resolved()[0] != OVERHEAD_DISPATCHES:
        raise AssertionError("the overhead handle lost dispatches")
    out = {"us_per_dispatch": us, "fit_launches": fit_launches,
           "fit_added_ms": us * fit_launches / 1e3, "fit_s": fit_s,
           "fit_share": us * fit_launches / 1e6 / fit_s}
    print(f"observability overhead (11d): {us:.3f} us per recorded dispatch; x {fit_launches} "
          f"launches = {out['fit_added_ms']:.3f} ms, {100 * out['fit_share']:.3f}% of 5c's "
          f"{fit_s:.3f}s fit [{card}]")
    return out


# -- the serving contract past the happy path (phase 12) ---------------------------

#: Artifact B of 12c: the committed forest cut to its first trees.
B_KEY = "models/gbdt/model_tree_first150"
B_TREES = 150
POISON_KEY = "models/poison"
#: Client threads and successful swaps of 12c, the pause between swaps
#: that stretches the load to about 3 s, and the load's first second with
#: no swap (the latency to compare with).
SWAP_CLIENTS = 8
SWAPS = 10
SWAP_GAP_S = 0.25
STEADY_S = 1.0
#: How often 12c copies the newest spans out of the tracer's ring.
SPAN_POLL_S = 0.025


def _call(url: str, body: bytes | None = None, request_id: str | None = None) -> tuple:
    """``(status, headers, JSON body)`` of one GET (no body) or POST, error
    statuses included."""
    headers = {"Content-Type": "application/json"}
    if request_id is not None:
        headers["X-Request-ID"] = request_id
    req = urllib.request.Request(url, data=body, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _burst(port: int, bodies: list[bytes], timed: bool = False) -> list[tuple]:
    """POST every body to /predict at once: one connection each, opened
    first, then every request sent past one barrier. ``(status, headers,
    JSON body)`` per body, in order; with ``timed`` also each request's
    wall seconds."""
    conns = [http.client.HTTPConnection("127.0.0.1", port, timeout=120) for _ in bodies]
    for c in conns:
        c.connect()
    barrier = threading.Barrier(len(bodies))

    def send(i: int) -> tuple:
        barrier.wait()
        t0 = time.perf_counter()
        conns[i].request("POST", "/predict", bodies[i], {"Content-Type": "application/json"})
        r = conns[i].getresponse()
        out = (r.status, dict(r.getheaders()), json.loads(r.read()))
        return (*out, time.perf_counter() - t0) if timed else out

    try:
        with ThreadPoolExecutor(max_workers=len(bodies)) as pool:
            return list(pool.map(send, range(len(bodies))))
    finally:
        for c in conns:
            c.close()


def _respelled(payload: dict) -> dict:
    """The same application spelled otherwise: the underscored field names
    for the two aliases, ints as floats and integral floats as ints, keys
    in reverse order."""
    field = {v: k for k, v in schema.SERVING_FIELD_ALIASES.items()}
    out = {}
    for key, value in reversed(list(payload.items())):
        if isinstance(value, int):
            value = float(value)
        elif float(value).is_integer():
            value = int(value)
        out[schema.SERVING_FIELD_ALIASES.get(key, key) if key in field else key] = value
    return out


def hardening_store(root: Path, device: str = "cuda") -> tuple[ObjectStore, dict]:
    """A temporary store with the committed model (A) under its own key,
    the same forest cut to its first `B_TREES` trees (B) and a poisoned
    ``.npz``; returns the store and ``{key: forest on device}``."""
    store = ObjectStore(str(root))
    art = GBDTArtifact.load(ObjectStore(str(STORE)), MODEL_KEY, "cpu")
    art.save(store, MODEL_KEY)
    forest = art.forest
    cut = dataclasses.replace(forest, **{
        f.name: getattr(forest, f.name)[:B_TREES]
        for f in dataclasses.fields(forest) if f.name != "depth"
    })
    dataclasses.replace(art, forest=cut).save(store, B_KEY)
    store.put_bytes(POISON_KEY + ".npz", b"\x00poisoned")
    return store, {MODEL_KEY: forest.to(device), B_KEY: cut.to(device)}


def _kernel_probs(forest, rows: list[dict]) -> np.ndarray:
    """P(default) of each request row by one `fused_score` launch with SHAP
    on the forest's device, as a micro-batch scores it."""
    F = len(schema.SERVING_FEATURES)
    X = torch.tensor([[float(r[k]) for k in _request_keys()] for r in rows],
                     dtype=torch.float32, device=forest.device)
    return fused_score(pack_forest(forest, F), X, n_features=F)[1].cpu().numpy()


def _same_prob(got: float, want, device: str) -> bool:
    """Bit for bit on the card, whose sigmoid does not depend on a row's
    batch; within `TOL_PROB` for the plain version on the CPU, whose
    vectorised and scalar sigmoid paths may differ in the last bit."""
    return got == float(want) if device == "cuda" else abs(got - float(want)) <= TOL_PROB


def _metric(fams: dict, family: str, **labels) -> float:
    key = family + "".join(f"|{k}={v}" for k, v in sorted(labels.items()))
    return fams[family]["samples"][key]


def _scrape(base: str) -> dict:
    status, _, text = _get_with_id(base + "/metrics", None)
    if status != 200:
        raise AssertionError(f"/metrics answered {status}")
    return parse_exposition(text.decode())


class _HeldClock:
    """A service clock that moves only when told to: 12a's rate gate sees
    its 40 requests arrive at one instant, as the token bucket's arithmetic
    would on a burst that took no time."""

    def __init__(self):
        self.now = time.monotonic()

    def __call__(self) -> float:
        return self.now


def _serve(store: ObjectStore, device: str, clock=time.monotonic, **kw):
    """A service (with any `ServeConfig` fields, ``reliability=`` a dict of
    `ReliabilityConfig` fields) and its server."""
    rel = ReliabilityConfig(**kw.pop("reliability", {}))
    service = ScorerService.from_store(
        store, ServeConfig(reliability=rel, **kw), device=device, clock=clock
    )
    server = make_async_server(service, "127.0.0.1", 0)
    return service, server, f"http://127.0.0.1:{server.port}"


def admission_check(store: ObjectStore, device: str = "cuda") -> dict:
    """12a: 32 concurrent /predict against an in-flight cap of 4 (the
    batcher held, so the 4 admitted keep their slots), and 40 at once
    against 50 requests/s with a burst of 8 (on a held service clock, then
    one more after 30 ms of it): every answer 200 or a typed 429 with
    ``Retry-After``, the counts equal to the admission families, one launch
    per micro-batch."""
    out = {}
    for gate, rel, n in (("capacity", {"max_in_flight": 4}, 32),
                         ("rate", {"rate_limit_rps": 50.0, "rate_limit_burst": 8}, 40)):
        clock = _HeldClock()
        service, server, base = _serve(
            store, device, clock=clock if gate == "rate" else time.monotonic, reliability=rel
        )
        try:
            bodies = [json.dumps(r).encode() for r in request_rows(n, SEED + 120 + n)]
            launches, batches = fused_score.launches, service.batcher.batches
            if gate == "capacity":
                with ThreadPoolExecutor(max_workers=1) as pool, service.batcher.pause():
                    fut = pool.submit(_burst, server.port, bodies)
                    while service.admission.stats()["shed_capacity"] < n - 4:
                        time.sleep(0.001)
                answers = fut.result()
            else:
                answers = _burst(server.port, bodies)
                clock.now += 1.5 / rel["rate_limit_rps"]  # one token back, not two
                answers.append(_call(base + "/predict", json.dumps(request_rows(1, SEED + 99)[0])
                                     .encode()))
            fams = _scrape(base)
            batches = service.batcher.batches - batches
            launches = fused_score.launches - launches
        finally:
            server.close()
            service.close()
        ok = [a for a in answers if a[0] == 200]
        shed = [a for a in answers if a[0] == 429]
        if len(ok) + len(shed) != len(answers) or (gate == "rate" and answers[-1][0] != 200):
            raise AssertionError(f"12a {gate}: statuses {sorted({a[0] for a in answers})}")
        for _, headers, body in shed:
            if body.get("error") != "shed" or int(headers.get("Retry-After", 0)) < 1:
                raise AssertionError(f"12a {gate}: an untyped 429 {body} {headers}")
        admitted = _metric(fams, "cobalt_admission_admitted_total")
        shed_n = _metric(fams, "cobalt_admission_shed_total", gate=gate)
        if (len(ok), len(shed)) != (admitted, shed_n):
            raise AssertionError(f"12a {gate}: {len(ok)} 200s and {len(shed)} 429s, the families "
                                 f"{admitted} admitted and {shed_n} shed")
        if len(shed) != n - (4 if gate == "capacity" else 8):
            raise AssertionError(f"12a {gate}: {len(shed)} of {n} shed")
        if device == "cuda" and launches != batches:
            raise AssertionError(f"12a {gate}: {launches} launches for {batches} micro-batches")
        out[gate] = {"ok": len(ok), "shed": len(shed), "batches": batches, "launches": launches,
                     "retry_after": sorted({h["Retry-After"] for _, h, _ in shed})}
    return out


def cache_check(store: ObjectStore, device: str = "cuda") -> dict:
    """12b: 16 distinct payloads, then the same 16 respelled (aliases, ints
    and floats, key order): the second pass is 16 hits that launch nothing
    and dispatch no program, with the first pass's bodies bit for bit."""
    service, server, base = _serve(store, device)
    entry = "score_forest/" if device == "cuda" else "score_forest_plain/"
    try:
        rows = request_rows(16, SEED + 140)
        miss_ms, hit_ms, first, second = [], [], [], []
        for r in rows:
            t0 = time.perf_counter()
            first.append(_call(base + "/predict", json.dumps(r).encode()))
            miss_ms.append((time.perf_counter() - t0) * 1e3)
        launches, programs = fused_score.launches, program_counts(entry)
        for r in rows:
            t0 = time.perf_counter()
            second.append(_call(base + "/predict", json.dumps(_respelled(r)).encode()))
            hit_ms.append((time.perf_counter() - t0) * 1e3)
        added = fused_score.launches - launches
        dispatched = program_delta(programs, program_counts(entry))
        ready = _call(base + "/readyz")[2]
    finally:
        server.close()
        service.close()
    if any(a[0] != 200 for a in first + second):
        raise AssertionError(f"12b: statuses {[a[0] for a in first + second]}")
    if added or dispatched:
        raise AssertionError(f"12b: the cached pass launched {added} times, programs {dispatched}")
    if [a[2] for a in second] != [a[2] for a in first]:
        raise AssertionError("12b: a cached body differs from its first answer")
    cache = ready["score_cache"]
    if (cache["hits"], cache["misses"], cache["entries"]) != (16, 16, 16):
        raise AssertionError(f"12b: /readyz score_cache {cache}")
    return {"hits": cache["hits"], "misses": cache["misses"],
            "miss_ms_p50": float(np.median(miss_ms)), "hit_ms_p50": float(np.median(hit_ms)),
            "hit_ms_max": max(hit_ms)}


def _model_bytes(model) -> int:
    """Bytes of the tensors that one served model holds: its pack and its
    forest."""
    seen, total = set(), 0
    for obj in (model.pack, model.artifact.forest):
        for f in dataclasses.fields(obj):
            t = getattr(obj, f.name)
            if isinstance(t, torch.Tensor) and t.data_ptr() not in seen:
                seen.add(t.data_ptr())
                total += t.numel() * t.element_size()
    return total


def _model_block_bytes(model) -> int:
    """Bytes of the caching allocator's blocks that hold one served model's
    tensors (its pack and its forest): what ``cobalt_device_mem_bytes``
    counts for it, a block being at least the bytes asked for."""
    ptrs = set()
    for obj in (model.pack, model.artifact.forest):
        for f in dataclasses.fields(obj):
            t = getattr(obj, f.name)
            if isinstance(t, torch.Tensor) and t.is_cuda:
                ptrs.add(t.data_ptr())
    blocks = {}
    for seg in torch.cuda.memory_snapshot():
        addr = seg["address"]
        for b in seg["blocks"]:
            if b["state"] == "active_allocated" and any(addr <= p < addr + b["size"] for p in ptrs):
                blocks[addr] = b["size"]
            addr += b["size"]
    return sum(blocks.values())


def _live_bytes(base: str) -> float:
    """``cobalt_device_mem_bytes`` of the card, scraped once the card is
    idle and the garbage collected (the services of earlier phases are
    freed when the collector breaks their cycles, not when they close)."""
    gc.collect()
    torch.cuda.synchronize()
    return _label_samples(_scrape(base), "cobalt_device_mem_bytes", "device")["cuda:0"]


def reload_check(card: str, store: ObjectStore, forests: dict, device: str = "cuda") -> dict:
    """12c: `SWAP_CLIENTS` threads send /predict with 64 fixed rows for
    `STEADY_S`, then for about 3 s more while `SWAPS` reloads over HTTP
    swap A -> B -> A ... and one reload of the poisoned key rolls back. Every 200 carries its row's
    probability under A or B bit for bit (the kernel's, scored directly
    first), every micro-batch (its ``serve.microbatch_dispatch`` span's
    request ids) is all A or all B, every request sent after a swap
    returned and answered before the next began has the new model's bits,
    the launches are the micro-batches plus each candidate's warm-up and
    smoke launches, and the card's live bytes after the swaps are within
    one model of those before."""
    rows = request_rows(64, SEED + 160)
    bodies = [json.dumps(r).encode() for r in rows]
    ref = {MODEL_KEY: _kernel_probs(forests[MODEL_KEY], rows),
           B_KEY: _kernel_probs(forests[B_KEY], rows)}
    if np.abs(ref[MODEL_KEY] - ref[B_KEY]).min() <= 2 * TOL_PROB:
        raise AssertionError("12c: a probe row scores the same under A and B")
    cuda = device == "cuda"
    service, server, base = _serve(store, device)
    try:
        # A payload cached under A answers with B's probability after a swap.
        first = _call(base + "/predict", bodies[0])[2]["prob_default"]
        again = _call(base + "/predict", bodies[0])[2]["prob_default"]
        swap = _call(base + "/admin/reload", json.dumps({"model_key": B_KEY}).encode())
        after = _call(base + "/predict", bodies[0])[2]["prob_default"]
        back = _call(base + "/admin/reload", json.dumps({"model_key": MODEL_KEY}).encode())
        a0, b0 = ref[MODEL_KEY][0], ref[B_KEY][0]
        if not (_same_prob(first, a0, device) and again == first and _same_prob(after, b0, device)
                and (swap[0], back[0]) == (200, 200)):
            raise AssertionError(f"12c: cached A {first} {again}, after the swap {after}; "
                                 f"reloads {swap[0]} {back[0]}")
        mem_before = _live_bytes(base) if cuda else 0.0
        one_model = _model_bytes(service._model)
        launches, batches = fused_score.launches, service.batcher.batches
        stop, clients_done = threading.Event(), threading.Event()
        answers: list = []
        spans: dict = {}
        lock = threading.Lock()

        def client(t: int) -> None:
            i = 0
            while not stop.is_set():
                j = (t * 7 + i) % len(rows)
                rid = f"12c-{t}-{i}"
                t0 = time.perf_counter()
                status, _, body = _call(base + "/predict", bodies[j], rid)
                t1 = time.perf_counter()
                with lock:
                    answers.append((rid, j, t0, t1, status, body.get("prob_default")))
                i += 1

        def poll() -> None:
            while True:
                done = clients_done.is_set()
                for s in default_tracer().export(limit=1024):
                    if s["name"] == "serve.microbatch_dispatch":
                        spans[s["span_id"]] = s["attrs"].get("request_ids", [])
                if done:
                    return
                time.sleep(SPAN_POLL_S)

        epochs, poisoned, reload_s = [], None, []
        with ThreadPoolExecutor(max_workers=SWAP_CLIENTS + 1) as pool:
            poller = pool.submit(poll)
            clients = [pool.submit(client, t) for t in range(SWAP_CLIENTS)]
            time.sleep(STEADY_S)
            key = MODEL_KEY
            for k in range(SWAPS):
                if k == SWAPS // 2:
                    poisoned = _call(base + "/admin/reload",
                                     json.dumps({"model_key": POISON_KEY}).encode())
                key = B_KEY if key == MODEL_KEY else MODEL_KEY
                t0 = time.perf_counter()
                status, _, body = _call(base + "/admin/reload", json.dumps({"model_key": key}).encode())
                t1 = time.perf_counter()
                if status != 200:
                    raise AssertionError(f"12c: reload {k} answered {status} {body}")
                epochs.append((t0, t1, key))
                reload_s.append(t1 - t0)
                time.sleep(SWAP_GAP_S)
            stop.set()
            for c in clients:
                c.result()
            clients_done.set()
            poller.result()
        batches = service.batcher.batches - batches
        launches = fused_score.launches - launches
        warm = service._model.warm_buckets
        per_candidate = len(warm["shap"]) + len(warm["margin"]) + 1
        ready = _call(base + "/readyz")[2]
        gc.collect()
        mem_after = _live_bytes(base) if cuda else 0.0
    finally:
        server.close()
        service.close()
    if poisoned is None or (poisoned[0], poisoned[2].get("error")) != (500, "reload_failed"):
        raise AssertionError(f"12c: the poisoned reload answered {poisoned}")
    if any(a[4] != 200 for a in answers):
        raise AssertionError(f"12c: statuses {sorted({a[4] for a in answers})}")
    model_of = {}
    for rid, j, t0, t1, _, prob in answers:
        which = [k for k in ref if _same_prob(prob, ref[k][j], device)]
        if not which:
            raise AssertionError(f"12c: request {rid} row {j} answered {prob!r}, neither A "
                                 f"{ref[MODEL_KEY][j]!r} nor B {ref[B_KEY][j]!r}")
        model_of[rid] = which[0]
    for e, (_, end, key) in enumerate(epochs):
        nxt = epochs[e + 1][0] if e + 1 < len(epochs) else math.inf
        stale = [rid for rid, j, t0, t1, _, _ in answers
                 if t0 >= end and t1 <= nxt and model_of[rid] != key]
        if stale:
            raise AssertionError(f"12c: {len(stale)} requests after swap {e} answered by the "
                                 f"old model, e.g. {stale[:3]}")
    ours = {rid for rid, *_ in answers}
    mixed = [ids for ids in spans.values()
             if len({model_of[i] for i in ids if i in ours}) > 1]
    traced = sum(1 for ids in spans.values() if any(i in ours for i in ids))
    if mixed:
        raise AssertionError(f"12c: {len(mixed)} micro-batches mixed models, e.g. {mixed[0]}")
    if traced != batches:
        raise AssertionError(f"12c: {traced} traced micro-batches of ours, {batches} run")
    if cuda and launches != batches + SWAPS * per_candidate:
        raise AssertionError(f"12c: {launches} launches for {batches} micro-batches and {SWAPS} "
                             f"candidates of {per_candidate} warm-up and smoke launches")
    if abs(mem_after - mem_before) > one_model:
        raise AssertionError(f"12c: {mem_before} live bytes before the swaps, {mem_after} after "
                             f"(one model is {one_model})")
    first_swap = epochs[0][0]
    steady = np.array([(t1 - t0) * 1e3 for _, _, t0, t1, _, _ in answers if t1 < first_swap])
    lat = np.array([(t1 - t0) * 1e3 for _, _, t0, t1, _, _ in answers if t0 >= first_swap])
    out = {
        "requests": len(answers),
        "micro_batches": batches,
        "launches": launches,
        "swaps": SWAPS,
        "reload_s_mean": float(np.mean(reload_s)),
        "reload_s_max": float(np.max(reload_s)),
        "p50_ms": float(np.percentile(lat, 50)),
        "p99_ms": float(np.percentile(lat, 99)),
        "steady_requests": len(steady),
        "steady_p50_ms": float(np.percentile(steady, 50)),
        "steady_p99_ms": float(np.percentile(steady, 99)),
        "hits": ready["score_cache"]["hits"],
        "device_mem_bytes_before": mem_before,
        "device_mem_bytes_after": mem_after,
        "one_model_bytes": one_model,
    }
    print(f"hardening reload (12c): {SWAPS} swaps under {SWAP_CLIENTS} clients, reload wall "
          f"{out['reload_s_mean']:.4f} s mean {out['reload_s_max']:.4f} s max; /predict p50 "
          f"{out['p50_ms']:.3f} ms p99 {out['p99_ms']:.3f} ms over the {len(lat)} requests sent "
          f"during the swaps, {out['steady_p50_ms']:.3f} / {out['steady_p99_ms']:.3f} ms over "
          f"the {len(steady)} answered before the first ({batches} micro-batches, "
          f"{out['hits']} cache hits in all) [{card}]")
    return out


class _WorkerKilled(BaseException):
    """Raised once on the micro-batch worker, around a launch: not an
    `Exception`, so the per-batch containment does not catch it."""


def watchdog_check(store: ObjectStore, device: str = "cuda") -> dict:
    """12d: the worker dies holding a batch of 8 queued /predict (killed in
    Python before the launch): all 8 answer the typed 500 ``worker_dead``,
    one restart is counted in the family and ``/readyz``, and the next
    /predict scores on the card with the bits the kernel gives its row."""
    service, server, base = _serve(store, device)
    try:
        rows = request_rows(8, SEED + 180)
        want = _kernel_probs(service._model.artifact.forest, rows)
        batcher = service.batcher
        real = batcher._dispatch
        died: list = []

        def dispatch(batch):
            if not died:
                died.append(len(batch))
                raise _WorkerKilled("micro-batch worker killed before its launch")
            return real(batch)

        with ThreadPoolExecutor(max_workers=8) as pool:
            with batcher.pause():
                futs = [pool.submit(_call, base + "/predict", json.dumps(r).encode()) for r in rows]
                while batcher.queue_depth() < 8:
                    time.sleep(0.001)
                batcher._dispatch = dispatch
            answers = [f.result() for f in futs]
        launches = fused_score.launches
        status, _, body = _call(base + "/predict", json.dumps(rows[0]).encode())
        launches = fused_score.launches - launches
        fams = _scrape(base)
        ready = _call(base + "/readyz")[2]
    finally:
        server.close()
        service.close()
    if died != [8] or [(a[0], a[2].get("error")) for a in answers] != [(500, "worker_dead")] * 8:
        raise AssertionError(f"12d: died holding {died}, answers {[(a[0], a[2]) for a in answers]}")
    restarts = _metric(fams, "cobalt_microbatch_worker_restarts_total")
    dead = _metric(fams, "cobalt_microbatch_worker_dead_total")
    if (restarts, dead, ready["microbatch"]["worker_restarts"]) != (1, 8, 1):
        raise AssertionError(f"12d: restarts {restarts}, dead {dead}, /readyz {ready['microbatch']}")
    if status != 200 or not _same_prob(body["prob_default"], want[0], device) or (
            device == "cuda" and launches != 1):
        raise AssertionError(f"12d: after the restart {status}, {launches} launches, "
                             f"{body.get('prob_default')!r} against the kernel's {want}")
    return {"worker_dead": 8, "restarts": 1, "next_launches": launches}


def breaker_check(store: ObjectStore, device: str = "cuda") -> dict:
    """12e: every read of the store fails: three reloads roll back, the
    fourth answers 503 ``circuit_open`` with ``Retry-After`` and no read;
    the store back and the reset time passed, the next reload swaps, and
    the breaker has walked open -> half_open -> closed. /predict answers
    200 between each step."""
    flaky = FaultInjectingStore(store, faults={})
    service, server, base = _serve(
        flaky, device, reliability={"breaker_failure_threshold": 3, "breaker_reset_s": 0.5}
    )
    rows = iter(request_rows(6, SEED + 200))
    predicts, reloads = [], []

    def step(body: bytes = b"{}") -> None:
        reloads.append(_call(base + "/admin/reload", body))
        predicts.append(_call(base + "/predict", json.dumps(next(rows)).encode())[0])

    try:
        flaky.faults["get"] = FaultSpec(rate=1.0)
        for _ in range(3):
            step()
        gets = flaky.calls["get"]
        step()
        untouched = flaky.calls["get"] == gets
        del flaky.faults["get"]
        time.sleep(0.55)
        step()
        transitions = list(service.store_breaker.transitions)
        state = service.store_breaker.state
    finally:
        server.close()
        service.close()
    shapes = [(s, b.get("error")) for s, _, b in reloads]
    want = [(500, "reload_failed")] * 3 + [(503, "circuit_open"), (200, None)]
    if shapes != want or not untouched or "Retry-After" not in reloads[3][1]:
        raise AssertionError(f"12e: reloads {shapes}, store read while open: {not untouched}, "
                             f"headers {reloads[3][1]}")
    if transitions != ["open", "half_open", "closed"] or state != "closed" or predicts != [200] * 5:
        raise AssertionError(f"12e: transitions {transitions}, state {state}, /predict {predicts}")
    return {"reloads": shapes, "transitions": transitions, "retry_after": reloads[3][1]["Retry-After"]}


def hardening_phase(card: str, device: str = "cuda") -> dict:
    """Phase 12: admission, the score cache, hot reload under load, the
    watchdog and the store's breaker, each on its own service on the card,
    over HTTP, against a temporary store holding A, B and a poisoned
    object. ``launches`` counts the kernel's launches over the phase."""
    t0 = time.perf_counter()
    # The phase answers hundreds of 429s and 500s by design: one warning
    # line each would flood stderr.
    http_log = logging.getLogger("cobalt.serve.http_asyncio")
    level = http_log.level
    http_log.setLevel(logging.ERROR)
    fused_score.launches = 0
    try:
        out = _hardening(card, device)
    finally:
        http_log.setLevel(level)
    out["launches"] = fused_score.launches
    out["phase_s"] = time.perf_counter() - t0
    print(f"hardening (12): {json.dumps(out)} [{card}]")
    print(f"hardening cache (12b): per hit {out['cache']['hit_ms_p50']:.3f} ms p50 against "
          f"{out['cache']['miss_ms_p50']:.3f} ms per miss over HTTP [{card}]")
    return out


def _hardening(card: str, device: str) -> dict:
    with tempfile.TemporaryDirectory(prefix="chip_smoke_hardening_") as root:
        store, forests = hardening_store(Path(root), device)
        out = {"admission": admission_check(store, device), "cache": cache_check(store, device)}
        out["reload"] = reload_check(card, store, forests, device)
        out["watchdog"] = watchdog_check(store, device)
        out["breaker"] = breaker_check(store, device)
    return out


# -- the data layer's remaining paths (phase 13) -----------------------------------


def _same_engineering(a: tuple, b: tuple, what: str) -> None:
    """Two runs of the engineering stage, each ``(report, plan, tree, nn)``:
    the same report and plan (medians within ``LOG_RTOL`` for log1p-derived
    columns, bitwise otherwise), tree and nn columns bitwise equal except the
    log1p-derived ones (within ``LOG_RTOL``), the same labels."""
    (ra, pa, ta, na), (rb, pb, tb, nb) = a, b
    if dataclasses.asdict(ra) != dataclasses.asdict(rb):
        raise AssertionError(f"{what}: clean reports differ: {ra} vs {rb}")
    for f in ("numeric_names", "categorical_vocab", "label_vocab", "log_cols",
              "tree_feature_names", "nn_feature_names", "asof"):
        if getattr(pa, f) != getattr(pb, f):
            raise AssertionError(f"{what}: plans differ in {f}")
    log_cols = set(pa.log_cols)
    for name, v in pa.medians.items():
        w = pb.medians[name]
        if (name in log_cols and not np.isclose(w, v, rtol=LOG_RTOL, atol=0.0)) or (
            name not in log_cols and w != v
        ):
            raise AssertionError(f"{what}: median of {name}: {v} and {w}")
    for fa, fb, kind in ((ta, tb, "tree"), (na, nb, "nn")):
        if fa is None or fb is None:
            continue
        _columns_agree(fa.feature_names, fa.X.cpu(), fb.X.cpu(), log_cols, f"{what} {kind}")
        if not torch.equal(torch.nan_to_num(fa.y.cpu(), nan=-1.0), torch.nan_to_num(fb.y.cpu(), nan=-1.0)):
            raise AssertionError(f"{what}: labels differ")


def host_path(frame: RawFrame, dev: torch.device) -> tuple[tuple, dict]:
    """`clean_raw_frame` -> `prepare_cleaned_frame` -> `engineer_features`
    on ``dev``: ``((report, plan, tree, nn), seconds of each step)``."""
    seconds = {}
    t0 = time.perf_counter()
    cleaned, report = clean_raw_frame(frame)
    seconds["clean_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    prepared = prepare_cleaned_frame(cleaned, today=TODAY)
    seconds["prepare_s"] = time.perf_counter() - t0
    del cleaned
    _sync(dev)
    t0 = time.perf_counter()
    tree, nn, plan = engineer_features(prepared, device=dev)
    _sync(dev)
    seconds["engineer_s"] = time.perf_counter() - t0
    return (report, plan, tree, nn), seconds


def host_path_card_checks(card: str, n_rows: int = RAW_CHECK_ROWS, device: str = "cuda") -> dict:
    """Phase 13a: 6a's frame through the host path with its numerics on
    the card, against `run_device_ingest` on the card and against the host
    path on the CPU."""
    dev = torch.device(device)
    frame = synthetic_lendingclub_frame(n_rows, seed=SEED)
    card_run, seconds = host_path(frame, dev)
    res = run_device_ingest(tokenize_raw_frame(frame, today=TODAY), device=dev)
    ingest = (res.report, dataclasses.replace(res.plan, asof=None), res.tree, res.nn)
    _same_engineering(card_run, ingest, "host path against the device ingest")
    del res, ingest
    report, plan, _, _ = card_run
    cpu_tree, cpu_nn, cpu_plan = engineer_features(
        prepare_cleaned_frame(clean_raw_frame(frame)[0], today=TODAY), device="cpu")
    _same_engineering(card_run, (report, cpu_plan, cpu_tree, cpu_nn), "host path card against cpu")
    out = {"rows_in": frame.n_rows, "rows_out": card_run[2].n_rows,
           "tree_features": len(plan.tree_feature_names), **seconds}
    print(f"host path (13a): {json.dumps(out)} [{card}]")
    return out


def host_path_at_scale(card: str, frame: RawFrame, raw: dict, kept: dict, device: str = "cuda") -> dict:
    """Phase 13b: 6b's frame through the host path on the card, once: each
    step's seconds beside 6b's tokenize (``host_frontier``) and card ingest
    (``device_ingest``) seconds, the rows and the peak card memory; the tree
    table held to 6b's as in 13a."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    run, seconds = host_path(frame, dev)
    report, plan, tree, _ = run
    out = {"rows_in": frame.n_rows, "rows_out": tree.n_rows, **seconds,
           "host_path_s": sum(seconds.values()),
           "device_path_host_frontier_s": raw["tokenize_s"], "device_path_device_ingest_s": raw["ingest_s"]}
    if dev.type == "cuda":
        out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    _same_engineering((report, plan, tree, None),
                      (kept["report"], dataclasses.replace(kept["plan"], asof=None), kept["tree"], None),
                      "host path against 6b's ingest")
    print(f"host path at scale (13b): {json.dumps(out)} [{card}]")
    return out


def _frames_equal(ref: RawFrame, got: RawFrame, what: str) -> None:
    """The same columns, dtypes (``U`` by kind), values bit for bit and
    missing masks."""
    if got.columns != ref.columns or got.n_rows != ref.n_rows:
        raise AssertionError(f"{what}: columns or rows differ")
    for name in ref.columns:
        a, b = ref[name], got[name]
        if a.dtype.kind == "U":
            same = (b.dtype.kind == "U" and np.array_equal(a, b)
                    and np.array_equal(ref.missing(name), got.missing(name)))
        else:
            same = a.dtype == b.dtype and np.array_equal(a.view(np.int64), b.view(np.int64))
        if not same:
            raise AssertionError(f"{what}: column {name!r} differs")


#: The 8b tables 13c also reads with the codec: the nn table is numeric as
#: the tree table is, so its codec read (27-36 s) checks nothing the tree
#: table's does not; the native reader still reads and times it.
CODEC_CHECKED = ("cleaned", "tree")
#: 13c compares the two readers on this fraction of each checked table's
#: bytes, cut at a row boundary (the whole tables' codec reads took 109 s).
CODEC_CHECK_FRACTION = 1 / 8


def csv_prefix(data: bytes, fraction: float) -> bytes:
    """The rows of a CSV that start in its first ``fraction`` of bytes: cut
    after a newline that no quoted field holds (an even count of ``"``
    before it; RFC 4180 doubles a quote inside a field)."""
    cut = data.rfind(b"\n", 0, max(1, int(len(data) * fraction)))
    while cut > 0 and data.count(b'"', 0, cut) % 2:
        cut = data.rfind(b"\n", 0, cut)
    if cut <= 0:
        raise AssertionError("no row boundary in the table's prefix")
    return data[: cut + 1]


def native_reader_phase(card: str, root: str, cfg: PipelineConfig, resumed: dict) -> dict:
    """Phase 13c: 8b's stored cleaned, tree and nn tables read with the
    native reader (seconds and MB/s of each), the first rows of the cleaned
    and tree tables (`CODEC_CHECK_FRACTION` of their bytes) also with
    `csv_to_frame` (equal frames, its seconds and MB/s); and 10b's restore
    of the tree table through `load_frame`."""
    store = ObjectStore(root)
    out = {}
    for name, key in (("cleaned", cfg.data.cleaned_key), ("tree", cfg.data.tree_key),
                      ("nn", cfg.data.nn_key)):
        data = store.get_bytes(key)
        t0 = time.perf_counter()
        got = native.read_csv(data, engine="native")
        native_s = time.perf_counter() - t0
        mb = len(data) / 1e6
        out[name] = {"bytes": len(data), "rows": got.n_rows, "columns": len(got.columns),
                     "native_s": native_s, "native_mb_per_s": mb / native_s}
        if name in CODEC_CHECKED:
            head = csv_prefix(data, CODEC_CHECK_FRACTION)
            t0 = time.perf_counter()
            ref = csv_to_frame(head)
            frames_s = time.perf_counter() - t0
            _frames_equal(ref, native.read_csv(head, engine="native"), f"{name} table's first rows")
            out[name].update(checked_rows=ref.n_rows, checked_bytes=len(head), csv_to_frame_s=frames_s,
                             csv_to_frame_mb_per_s=len(head) / 1e6 / frames_s)
            del ref, head
        del data, got
        gc.collect()
    out["resume_restore_s"] = resumed["read_tree_csv_s"]
    print(f"native reader (13c): {json.dumps(out)} [{card}]")
    return out


def _cli(root: str, device: torch.device, *args: str) -> dict:
    """``--quick --pandas-ingest`` through the training CLI in a subprocess
    on ``device``: its printed summary."""
    cmd = [sys.executable, "-m", "cobalt_smart_lender_ai_tpu_torch.pipeline", "--store", root,
           "--quick", "--pandas-ingest", "--device", device.type, *args]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"the training CLI exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    return ast.literal_eval(proc.stdout.strip().splitlines()[-1])


def pandas_ingest_phase(card: str, root: str, cli: dict, n_rows: int = CLI_ROWS,
                        device: str = "cuda") -> dict:
    """Phase 13d: ``--pandas-ingest`` end to end. `bootstrap_synthetic`
    writes the raw table into a `DatasetRegistry`, pulled and verified into
    the store's ``raw_key``; the CLI trains on it (histogram launches per
    stage as 8b counts them, equal to the ledger's programs) and publishes;
    16 raw rows through `predict_raw` held to the plain version; then with
    the ``engineer`` manifest invalidated ``--resume`` restores the cleaned
    table (``stages_skipped == ("clean",)``) and publishes the same forest
    bit for bit. Lists 11c's ``ingest.*`` program rows (a device-path run)."""
    dev = torch.device(device)
    store = ObjectStore(root)
    cfg = dataclasses.replace(quick_config(), data=DataConfig(device_pipeline=False))
    key = cfg.serve.model_key
    registry = DatasetRegistry(store)
    out: dict = {"rows": n_rows}
    t0 = time.perf_counter()
    path = bootstrap_synthetic(Path(root) / "workspace", registry, n_rows=n_rows, seed=SEED)
    out["bootstrap_s"] = time.perf_counter() - t0
    pin = registry.pin(path.name)
    data = registry.pull(path.name)
    if not registry.verify(path.name) or data != path.read_bytes():
        raise AssertionError("the pinned raw table does not verify")
    store.put_bytes(cfg.data.raw_key, data)
    out["pin"] = dataclasses.asdict(pin)

    ledger_path = f"{root}/pandas_ingest_ledger.json"
    t0 = time.perf_counter()
    first = _cli(root, dev, "--ledger-out", ledger_path)
    out["cli_s"] = time.perf_counter() - t0
    if first["stages_run"] != ("clean", "engineer", "rfe", "search", "eval"):
        raise AssertionError(f"the host-path run ran {first['stages_run']}")
    ledger = load_ledger(ledger_path)
    art = GBDTArtifact.load(store, key, "cpu")
    n_features = len([n for n in art.plan.tree_feature_names if n not in schema.TRAIN_LEAKAGE_COLS])
    halving = ledger.get("search_halving")
    if halving is not None:  # JSON keyed the chunks by str(depth)
        halving = {**halving, "chunk_trees": {int(d): c for d, c in halving["chunk_trees"].items()}}
    search = types.SimpleNamespace(
        cv_results_={"params": sample_candidates(cfg.tune.param_space, cfg.tune.n_iter, cfg.tune.seed),
                     "halving": halving},
        best_params_=first["best_params"],
    )
    expect = expected_launches(cfg, types.SimpleNamespace(search=search), n_features)
    hist = sum(p["dispatches"] for p in ledger["programs"] if p["name"].startswith("gradient_histogram/"))
    if dev.type == "cuda" and (first["hist_launches"] != expect or hist != sum(expect.values())):
        raise AssertionError(f"histogram launches {first['hist_launches']} ({hist} in the ledger), "
                             f"expected {expect}")
    out.update(stage_s=first["timings"], hist_launches=first["hist_launches"],
               test_auc=first["test_auc"], cv_auc=first["cv_auc"], best_params=first["best_params"])
    frame = native.read_csv(data, engine="native")
    picks = np.sort(np.random.default_rng(SEED + 13).choice(frame.n_rows, PROTOCOL_SERVE_ROWS, replace=False))
    out["predict_raw"] = serve_payloads(store, key, row_dicts(frame, picks), dev)
    del frame, data

    PipelineCheckpoint(store, cfg.reliability.checkpoint_prefix).invalidate("engineer")
    t0 = time.perf_counter()
    resumed = _cli(root, dev, "--resume")
    out["resume_s"] = time.perf_counter() - t0
    if resumed["stages_skipped"] != ("clean",):
        raise AssertionError(f"the resume skipped {resumed['stages_skipped']}")
    if not same_forest(art.forest, GBDTArtifact.load(store, key, "cpu").forest):
        raise AssertionError("the resumed run published another forest")
    out.update(resume_stage_s=resumed["timings"], resume_hist_launches=resumed["hist_launches"],
               stages_skipped=list(resumed["stages_skipped"]))
    out["ingest_programs"] = cli["ingest_programs"]
    print(f"pandas ingest (13d): {json.dumps(out)} [{card}]")
    for p in cli["ingest_programs"]:
        print(f"ingest program (11c's device-path ledger): {p['name']} dispatches={p['dispatches']} "
              f"event_s={p['dispatch_seconds']:.6f} [{card}]")
    return out


# -- the continuous-training loop (phase 14) ----------------------------------------

#: Loans a retrain trains on: 6a's, 11c's and 13d's size, cut from 2.3M for
#: time; the model keeps the committed width (300 trees of depth 7, the 20
#: serving features).
LIFECYCLE_ROWS = 200_000
LIFECYCLE_TREES = 300
LIFECYCLE_DEPTH = 7
#: /predict requests shadowed through the good candidate (16 bursts of 16,
#: coalesced by the micro-batcher) and through the degraded one.
SHADOW_BURSTS = 16
BURST = 16
DEGRADED_REQUESTS = 128
#: Drift: unshifted rows of a fresh table, then rows with ``loan_amnt``
#: moved past every training value; the alarm is judged from
#: `DRIFT_MIN_SAMPLES` live rows on.
DRIFT_FRAME_ROWS = 6_000
DRIFT_UNSHIFTED = 2000
DRIFT_SHIFTED = 1000
DRIFT_MIN_SAMPLES = 1000
DRIFT_FEATURE = "loan_amnt"
#: The guard window's burn: each driven 5xx one step of the service clock
#: past the SLO engine's 0.25 s cache.
BURN_STEP_S = 0.5
LIFECYCLE_CONFIG = dict(
    canary_enabled=True,
    drift_min_samples=DRIFT_MIN_SAMPLES,
    # The guard window reacts to availability only: latency objectives this
    # loose cannot burn on the host's HTTP latency.
    slo_p99_ms=10_000.0,
    slo_p999_ms=10_000.0,
)


class _LogLines(logging.Handler):
    """The structured log lines written under ``cobalt`` while attached."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines: list[dict] = []

    def emit(self, record: logging.LogRecord) -> None:
        try:
            self.lines.append(json.loads(record.getMessage()))
        except ValueError:
            pass


def _fit_md5s() -> tuple[list, object]:
    """Wrap `GBDTClassifier.fit` to keep the md5 of each matrix and label
    vector it is given, as `tools.retrain` fingerprints them; returns the
    list and the original method."""
    seen, real = [], gbdt.GBDTClassifier.fit

    def fit(self, X, y, *args, **kw):
        Xn = X.cpu().numpy() if isinstance(X, torch.Tensor) else np.asarray(X)
        seen.append(hashlib.md5(np.ascontiguousarray(Xn, np.float32).tobytes()
                                + np.ascontiguousarray(y, np.float32).tobytes()).hexdigest())
        return real(self, X, y, *args, **kw)

    gbdt.GBDTClassifier.fit = fit
    return seen, real


def _retrain(store: ObjectStore, seed: int, device: str, challenger: bool = False, **kw) -> dict:
    """One `retrain_candidate` at the committed width, with its wall
    seconds, its histogram launches and the md5 of the matrix its fit saw
    held to the published ``dataset_md5``. With ``challenger`` it also
    trains the MLP challenger, as the reference's default does: published
    as ``gbdt_mlp`` v1 to ``canary``, an `MLPArtifact` that reads back onto
    ``device`` with the fitted weights and scaler bit for bit."""
    seen, real = _fit_md5s()
    fitted, real_mlp_fit = [], MLPClassifier.fit

    def mlp_fit(self, *args, **kwargs):
        fitted.append(self)
        return real_mlp_fit(self, *args, **kwargs)

    MLPClassifier.fit = mlp_fit
    hist0 = gradient_histogram_channels.launches
    t0 = time.perf_counter()
    try:
        report = retrain_candidate(store, rows=LIFECYCLE_ROWS, seed=seed, n_estimators=LIFECYCLE_TREES,
                                   max_depth=LIFECYCLE_DEPTH, train_mlp=challenger, device=device, **kw)
    finally:
        gbdt.GBDTClassifier.fit = real
        MLPClassifier.fit = real_mlp_fit
    report["retrain_s"] = time.perf_counter() - t0
    if challenger:
        registry = ModelRegistry(store)
        ch = report.get("challenger", {})
        record = registry.record("gbdt_mlp", 1)
        if (len(fitted) != 1 or ch.get("model") != "gbdt_mlp" or ch.get("version") != 1
                or registry.channel("gbdt_mlp", "canary")["version"] != 1
                or record.kind != "MLPArtifact" or not registry.verify("gbdt_mlp", 1)):
            raise AssertionError(f"14a: the challenger {ch}, record {record.to_json()}")
        art = MLPArtifact.load(store, ch["key"], device)
        mlp = fitted[0]
        state = mlp.module.state_dict()
        if (art.state_dict.keys() != state.keys()
                or not all(torch.equal(art.state_dict[k], v) for k, v in state.items())
                or not np.array_equal(art.scaler_low, mlp.scaler.low.cpu().numpy())
                or not np.array_equal(art.scaler_range, mlp.scaler.range_.cpu().numpy())
                or art.hidden_sizes != (32, 16) or art.metrics != {"test_auc": ch["test_auc"]}):
            raise AssertionError("14a: the challenger's MLPArtifact does not read back bit for bit")
        report["challenger"]["epochs_run"] = len(mlp.history["loss"])
        report["challenger"]["round_trip"] = "bitwise"
    report["hist_launches"] = gradient_histogram_channels.launches - hist0
    if seen != [report["dataset_md5"]]:
        raise AssertionError(f"14a: dataset_md5 {report['dataset_md5']} is not the fit's matrix's {seen}")
    if device == "cuda" and report["hist_launches"] != LIFECYCLE_TREES * LIFECYCLE_DEPTH:
        raise AssertionError(f"14a: {report['hist_launches']} histogram launches, expected "
                             f"{LIFECYCLE_TREES * LIFECYCLE_DEPTH} (one per tree level)")
    return report


def _drift_rows(device: str) -> list[dict]:
    """Rows of a fresh synthetic table through the host path on ``device``:
    the 20 serving features by name, NaN cells kept (a tap takes them)."""
    cleaned, _ = clean_raw_frame(synthetic_lendingclub_frame(DRIFT_FRAME_ROWS, seed=SEED + 3))
    # today unpinned, as `tools.retrain` prepares its tables: the date
    # features then share the training sketch's reference day
    tree, _, _ = engineer_features(prepare_cleaned_frame(cleaned), device=device)
    X = drop_training_leakage(tree).select(schema.SERVING_FEATURES).X.cpu().numpy()
    del tree
    return [dict(zip(schema.SERVING_FEATURES, map(float, x))) for x in X]


def _tap(service: ScorerService, rows: list[dict]) -> None:
    """Hand ``rows`` to the canary's tap in pieces its queue holds."""
    for start in range(0, len(rows), 256):
        for row in rows[start : start + 256]:
            service.canary.tap(row, 0.5, None)
        if not service.canary.flush(timeout_s=60.0):
            raise AssertionError("14e: the shadow queue did not drain")


def _predict_all(port: int, bodies: list[bytes], version: str, what: str) -> list[float]:
    """POST the bodies in bursts of `BURST`; every answer 200 from
    ``version`` with no canary field. The probabilities, in order."""
    probs = []
    for start in range(0, len(bodies), BURST):
        for status, _, body in _burst(port, bodies[start : start + BURST]):
            if status != 200 or body.get("model_version") != version or "canary" in json.dumps(body):
                raise AssertionError(f"{what}: /predict answered {status} {body}")
            probs.append(body["prob_default"])
    return probs


def lifecycle_phase(card: str, device: str = "cuda") -> dict:
    """Phase 14: the continuous-training loop at the committed width, on the
    card, over a temporary store behind a `FaultInjectingStore` (no fault
    until 14f). Both kernels' launches are counted from 0 just before it."""
    gradient_histogram_channels.launches = 0
    fused_score.launches = 0
    logs = _LogLines()
    cobalt_log = logging.getLogger("cobalt")
    level = cobalt_log.level
    cobalt_log.setLevel(logging.INFO)
    cobalt_log.addHandler(logs)
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_lifecycle_") as root:
            out = _lifecycle(card, ObjectStore(root), logs, device)
    finally:
        cobalt_log.removeHandler(logs)
        cobalt_log.setLevel(level)
    out["launches"] = {"score_forest": fused_score.launches,
                       "gradient_histogram": gradient_histogram_channels.launches}
    out["phase_s"] = time.perf_counter() - t0
    print(f"lifecycle (14): {json.dumps(out)} [{card}]")
    return out


def _lifecycle(card: str, inner: ObjectStore, logs: _LogLines, device: str) -> dict:
    out: dict = {}
    dev = torch.device(device)
    kernel = "score_forest" if dev.type == "cuda" else "plain"
    entry = "score_forest/" if dev.type == "cuda" else "score_forest_plain/"

    def mem(base: str) -> tuple:
        """``cobalt_device_mem_bytes`` once the card is idle, and the bytes
        its live tensors asked for (the allocator's blocks, which the gauge
        counts, can be larger when a cached block is reused unsplit); no
        card on a CPU rehearsal."""
        gc.collect()
        if dev.type != "cuda":
            return None, None
        return _live_bytes(base), torch.cuda.memory_stats(dev)["requested_bytes.all.current"]

    registry = ModelRegistry(inner)
    # 14a: the first champion, bootstrapped into `latest`.
    v1 = _retrain(inner, SEED, device, challenger=True, bootstrap=True)
    if registry.channel("gbdt", "latest")["version"] != 1 or not registry.verify("gbdt", 1):
        raise AssertionError(f"14a: bootstrap left {registry.channel('gbdt', 'latest')}")
    out["retrain_v1"] = {k: v1[k] for k in ("retrain_s", "hist_launches", "test_auc", "dataset_md5",
                                            "challenger")}

    # 14b: served from the store's `latest` channel, a good candidate shadowed.
    flaky = FaultInjectingStore(inner, faults={})
    clock = _HeldClock()
    alarms: list[dict] = []
    service = ScorerService.from_store(
        flaky,
        ServeConfig(reliability=ReliabilityConfig(breaker_failure_threshold=3, breaker_reset_s=0.5),
                    **LIFECYCLE_CONFIG),
        device=device, clock=clock, enable_canary=False,
    )
    service.enable_canary(on_drift=alarms.append)
    server = make_async_server(service, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{server.port}"
    try:
        if service.model_info["version"] != "v1" or service._model.kernel != kernel:
            raise AssertionError(f"14b: serving {service.model_info} on {service._model.kernel}")
        mem_before = mem(base)
        _predict_all(server.port, [json.dumps(r).encode() for r in request_rows(BURST, SEED + 400)],
                     "v1", "14b")
        v2 = _retrain(inner, SEED + 1, device)
        out["retrain_v2_s"] = v2["retrain_s"]
        launches = fused_score.launches
        t1 = time.perf_counter()
        service.canary.refresh()
        out["canary_load_s"] = time.perf_counter() - t1
        out["canary_load_launches"] = fused_score.launches - launches
        ready = _call(base + "/readyz")[2]
        canary = ready["canary"]
        if not canary["loaded"] or canary["canary"]["version"] != 2:
            raise AssertionError(f"14b: /readyz canary block {canary}")
        model = service.canary._canary_model
        if model.kernel != kernel or model.device.type != dev.type:
            raise AssertionError(f"14b: the canary scores on {model.kernel} on {model.device}")
        shadows: list[tuple] = []
        margin_fn = model.margin_fn

        def recorded(X):
            margin, prob = margin_fn(X)
            shadows.append((X.clone(), margin.clone()))
            return margin, prob

        model.margin_fn = recorded
        bodies = [json.dumps(r).encode() for r in request_rows(SHADOW_BURSTS * BURST, SEED + 401)]
        shadow0 = int(service.canary._m_shadow.value)
        programs0 = program_counts(entry)
        launches = fused_score.launches
        champ = _predict_all(server.port, bodies, "v1", "14b")
        if not service.canary.flush(timeout_s=60.0):
            raise AssertionError("14b: the shadow queue did not drain")
        _sync(dev)
        shadowed = int(service.canary._m_shadow.value) - shadow0
        margin1 = program_delta(programs0, program_counts(entry)).get(
            entry + "f32/1/margin", (0, 0.0))[0]
        window = list(service.canary._window)
        if not (shadowed == len(bodies) == len(shadows) == margin1 == len(window)):
            raise AssertionError(f"14b: {len(bodies)} requests, {shadowed} shadowed, {len(shadows)} "
                                 f"shadow calls, {margin1} margin launches at bucket 1, "
                                 f"{len(window)} in the window")
        X = torch.cat([x for x, _ in shadows])
        got = torch.cat([m for _, m in shadows])
        ref_margin, ref_prob = fused_score_reference(model.pack, X, n_features=X.shape[1],
                                                     with_shap=False)
        if not torch.equal(got, ref_margin):
            raise AssertionError("14b: a shadow margin differs from the plain version's")
        shadow_probs = np.array([w[1] for w in window])
        prob_err = float(np.abs(shadow_probs - ref_prob.cpu().numpy().astype(np.float64)).max())
        host = np.array([float(1.0 / (1.0 + np.exp(-float(m)))) for m in got.cpu().numpy()])
        if prob_err > TOL_PROB or not np.array_equal(shadow_probs, host):
            raise AssertionError(f"14b: shadow prob error {prob_err}")
        if sorted(w[0] for w in window) != sorted(champ):
            raise AssertionError("14b: the window's champion probabilities are not the responses'")
        out["shadow"] = {"requests": len(bodies), "shadowed": shadowed, "launches": margin1,
                         "margin_max_abs_err": float((got - ref_margin).abs().max()),
                         "prob_max_abs_err": prob_err,
                         "launches_over_traffic": fused_score.launches - launches}
        del shadows, X, got, ref_margin, ref_prob
        model.margin_fn = margin_fn
        del model, margin_fn
        t1 = time.perf_counter()
        status, _, body = _call(base + "/admin/promote", b"{}")
        out["promote_s"] = time.perf_counter() - t1
        if status != 200 or body["promoted_version"] != 2:
            raise AssertionError(f"14b: promote answered {status} {body}")
        out["gate_v2"] = body["gate"]["checks"]
        _predict_all(server.port, [json.dumps(r).encode() for r in request_rows(BURST, SEED + 402)],
                     "v2", "14b")
        info = _label_samples(_scrape(base), "cobalt_model_info", "version")
        if info.get("v2") != 1.0 or info.get("v1") != 0.0:
            raise AssertionError(f"14b: cobalt_model_info {info}")

        # 14c: a label-shuffled candidate, shadowed and rejected.
        v3 = _retrain(inner, SEED + 2, device, degrade=True)
        out["retrain_v3_s"] = v3["retrain_s"]
        service.canary.refresh()
        _predict_all(server.port,
                     [json.dumps(r).encode() for r in request_rows(DEGRADED_REQUESTS, SEED + 403)],
                     "v2", "14c")
        service.canary.flush(timeout_s=60.0)
        status, _, body = _call(base + "/admin/promote", b"{}")
        reasons = body.get("report", {}).get("reasons", [])
        if status != 409 or body.get("error") != "promotion_rejected" or not reasons:
            raise AssertionError(f"14c: promote answered {status} {body}")
        if registry.channel("gbdt", "latest")["version"] != 2:
            raise AssertionError("14c: a rejected promotion moved `latest`")
        out["rejected"] = {"reasons": reasons, "checks": body["report"]["checks"]}

        # 14d: a manual rollback, then a forced promotion the guard window rolls back.
        t1 = time.perf_counter()
        status, _, body = _call(base + "/admin/rollback", json.dumps({"reason": "drill"}).encode())
        out["rollback_s"] = time.perf_counter() - t1
        if status != 200 or body["restored_version"] != 1 or registry.channel(
                "gbdt", "previous")["version"] != 2:
            raise AssertionError(f"14d: rollback answered {status} {body}")
        status, _, body = _call(base + "/admin/promote", json.dumps({"force": True}).encode())
        if status != 200 or body["promoted_version"] != 3:
            raise AssertionError(f"14d: forced promote answered {status} {body}")
        t1 = time.perf_counter()
        burns = 0
        while service.model_info["version"] != "v1" and burns < 50:
            clock.now += BURN_STEP_S
            service.observe_request("/predict", 500, 0.001, code="internal")
            burns += 1
        out["auto_rollback"] = {"errors_driven": burns, "s": time.perf_counter() - t1}
        latest = registry.channel("gbdt", "latest")
        last = service.canary.status().get("last_promotion", {})
        if latest["version"] != 1 or latest.get("rolled_back_from") != 3 or last.get(
                "trigger") != "slo_fast_burn":
            raise AssertionError(f"14d: after {burns} 5xx, latest {latest}, last {last}")
        mem_rollback = mem(base)

        # 14e: drift against v1's training sketch.
        rows = _drift_rows(device)
        fired = len(alarms)
        _tap(service, rows[:DRIFT_UNSHIFTED])
        calm = service.drift_report()
        if calm["alarm"] or len(alarms) != fired or calm["n_live"] != DRIFT_UNSHIFTED:
            raise AssertionError(f"14e: unshifted rows raised the alarm: {calm}")
        shifted = [dict(r, **{DRIFT_FEATURE: r[DRIFT_FEATURE] + 1e9}) for r in
                   rows[DRIFT_UNSHIFTED : DRIFT_UNSHIFTED + DRIFT_SHIFTED]]
        _tap(service, shifted)
        hot = _call(base + "/drift")[2]
        others = max(v for k, v in hot["features"].items() if k != DRIFT_FEATURE)
        alarm_gauge = _metric(_scrape(base), "cobalt_drift_alarm")
        if (not hot["alarm"] or hot["features"][DRIFT_FEATURE] <= hot["threshold"]
                or others > hot["threshold"] or alarm_gauge != 1.0 or len(alarms) != fired + 1):
            raise AssertionError(f"14e: drift {hot}, gauge {alarm_gauge}, hook {len(alarms) - fired}")
        _tap(service, shifted[:256])
        if len(alarms) != fired + 1:
            raise AssertionError("14e: the drift hook fired again while in alarm")
        out["drift"] = {"unshifted_max_psi": calm["max_psi"], DRIFT_FEATURE: hot["features"][DRIFT_FEATURE],
                        "others_max_psi": others, "hook_calls": len(alarms) - fired}
        del rows, shifted

        # 14f: the breaker on a store whose reads fail, then the journal.
        flaky.faults["get"] = FaultSpec(rate=1.0)
        reloads = [_call(base + "/admin/reload", b"{}")[0] for _ in range(4)]
        del flaky.faults["get"]
        clock.now += 1.0
        reloads.append(_call(base + "/admin/reload", b"{}")[0])
        transitions = list(service.store_breaker.transitions)
        if reloads != [500, 500, 500, 503, 200] or transitions != ["open", "half_open", "closed"]:
            raise AssertionError(f"14f: reloads {reloads}, breaker {transitions}")
        status, _, body = _call(base + "/events")
        evs = body["events"]
        got = [(e["component"], e["kind"], e["model"]) for e in evs]
        key = {n: f"models/gbdt/v{n}" for n in (1, 2, 3)}
        want = [("reload", "publish", key[2]), ("canary", "promote", "v2"),
                ("canary", "reject", "v3"),
                ("reload", "publish", key[1]), ("canary", "rollback", "v1"),
                ("reload", "publish", key[3]), ("canary", "promote", "v3"),
                ("reload", "publish", key[1]), ("canary", "rollback", "v1"),
                ("reload", "rollback", key[1]), ("reload", "rollback", key[1]),
                ("breaker", "open", None), ("reload", "rollback", key[1]),
                ("breaker", "half_open", None), ("breaker", "close", None),
                ("reload", "publish", key[1])]
        if status != 200 or got != want or body["count"] != len(want):
            raise AssertionError(f"14f: /events {status} {got}")
        causes = (evs[2]["payload"]["reasons"] == evs[2]["cause"]["gate"]["reasons"]
                  and evs[6]["cause"]["forced"] is True
                  and evs[8]["cause"]["trigger"] == "slo_fast_burn"
                  and evs[9]["cause"]["error"].startswith("InjectedFault")
                  and evs[11]["cause"]["consecutive_failures"] == 3)
        logged = {(line.get("event"), line.get("event_id")) for line in logs.lines}
        stamped = [(name, evs[i]["event_id"]) for i, name in (
            (0, "model_reload"), (1, "canary_promoted"), (2, "canary_promotion_rejected"),
            (4, "model_rollback"), (8, "model_rollback"), (9, "model_reload"))]
        missing = [s for s in stamped if s not in logged]
        if not causes or missing:
            raise AssertionError(f"14f: causes linked {causes}, log lines without their event id {missing}")
        trace = chrome_trace(default_tracer(), counters={}, journal=service.journal)
        if not trace["otherData"]["journal_event_count"] == len(service.journal.events()) == len(want):
            raise AssertionError(f"14f: trace journal count {trace['otherData']['journal_event_count']}")
        mem_after = mem(base)
        out["device_mem_bytes"] = {"before": mem_before[0], "after_rollback": mem_rollback[0],
                                   "end": mem_after[0]}
        out["requested_bytes"] = {"before": mem_before[1], "after_rollback": mem_rollback[1],
                                  "end": mem_after[1]}
        # No tensor outlives the cycle: the bytes asked for are exact. The
        # gauge counts the allocator's blocks, which depend on what its
        # cache held when each tensor was made: held, as 12c holds it,
        # within one served model's bytes.
        slack = _model_bytes(service._model)
        if dev.type == "cuda" and (
                not (mem_before[1] == mem_rollback[1] == mem_after[1])
                or max(abs(v - mem_before[0]) for v in (mem_rollback[0], mem_after[0])) > slack):
            raise AssertionError(f"14g: cobalt_device_mem_bytes {out['device_mem_bytes']} (slack "
                                 f"{slack}), requested bytes {out['requested_bytes']}")
        out["events"] = len(evs)
        out["gate_errors"] = int(service.canary._m_errors.value)
    finally:
        server.close()
        service.close()
    shipped = load_events(inner)
    if [e["event_id"] for e in shipped] != [e["event_id"] for e in evs]:
        raise AssertionError(f"14f: {len(shipped)} events read back from the store, {len(evs)} journaled")
    out["shipped_events"] = len(shipped)
    out["breaker"] = {"reloads": reloads, "transitions": transitions}
    return out


#: Phase 15: the serving fleet. Four replicas of the committed model on the
#: one card behind the HTTP server, its registry's ``latest`` channel served
#: and a canary (the same forest cut to its first half) shadowing.
FLEET_REPLICAS = 4
FLEET_REQUESTS = 256
FLEET_BURST = 16
FLEET_BULK_ROWS = 4096
FLEET_BULKS = 2
FLEET_STORM_BURST = 32
FLEET_STORM_BURSTS = 20
FLEET_DEADLINE_S = 2.0
FLEET_CONFIG = dict(
    replicas=FLEET_REPLICAS,
    brownout_max_level=5,
    canary_enabled=True,
    request_deadline_s=FLEET_DEADLINE_S,
    score_cache_size=0,  # every request reaches a replica
    # The loop starts with the server but never ticks on its own: the phase
    # ticks by hand, so each drill's supervision is one known pass.
    supervisor_probe_interval_s=3600.0,
    supervisor_probe_deadline_s=0.5,
    supervisor_probe_failures=2,
    supervisor_queue_age_limit_s=1.0,
    supervisor_drain_timeout_s=1.0,
    replica_close_timeout_s=2.0,
)


def _cut(art: GBDTArtifact, trees: int) -> GBDTArtifact:
    forest = art.forest
    return dataclasses.replace(art, forest=dataclasses.replace(forest, **{
        f.name: getattr(forest, f.name)[:trees] for f in dataclasses.fields(forest) if f.name != "depth"
    }))


def fleet_store(root: str, trees: int | None = None) -> tuple[ObjectStore, GBDTArtifact]:
    """A temporary store whose model registry serves the committed model
    (cut to its first ``trees`` for a CPU rehearsal) as ``latest`` and its
    first half as ``canary``."""
    store = ObjectStore(root)
    art = GBDTArtifact.load(ObjectStore(str(STORE)), MODEL_KEY, "cpu")
    if trees is not None:
        art = _cut(art, trees)
    registry = ModelRegistry(store)
    registry.publish("gbdt", art, channel="latest")
    registry.publish("gbdt", _cut(art, max(1, art.forest.n_trees // 2)), channel="canary")
    return store, art


def _bulk_call(base: str, csv_bytes: bytes) -> tuple:
    req = urllib.request.Request(base + "/predict_bulk_csv", data=csv_bytes,
                                 headers={"Content-Type": "text/csv"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _untyped(status: int, body: dict) -> bool:
    """An error answer without a typed code, or a 500 other than the
    watchdog's ``worker_dead``."""
    return status >= 400 and ("error" not in body or (status == 500 and body["error"] != "worker_dead"))


def _record_margins(model, records: list) -> Callable[[], None]:
    """Wrap a replica model's two scoring callables to keep each launch's
    rows and margins (the worker threads append; the GIL orders them).
    Returns the function that puts the originals back."""
    real = {attr: getattr(model, attr) for attr in ("shap_fn", "margin_fn")}
    for attr, fn in real.items():
        if fn is None:
            continue

        def call(X, fn=fn):
            out = fn(X)
            records.append((X.clone(), out[0].clone()))
            return out

        setattr(model, attr, call)

    def restore() -> None:
        for attr, fn in real.items():
            setattr(model, attr, fn)

    return restore


def _requested(dev: torch.device) -> int | None:
    """The bytes the card's live tensors asked for, once the collector ran
    (None on the CPU); empty before the process's first allocation."""
    gc.collect()
    if dev.type != "cuda":
        return None
    torch.cuda.synchronize(dev)
    return torch.cuda.memory_stats(dev).get("requested_bytes.all.current", 0)


def _join_threads(prefix: str, timeout: float = 30.0) -> None:
    for t in threading.enumerate():
        if t.name.startswith(prefix):
            t.join(timeout=timeout)


def fleet_phase(card: str, device: str = "cuda", trees: int | None = None) -> dict:
    """Phase 15: the serving fleet on the card, counted from 0 just before
    it. ``trees`` cuts the model for a CPU rehearsal."""
    fused_score.launches = 0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as root:
        out = _fleet(card, root, device, trees)
    out["launches"] = fused_score.launches
    out["phase_s"] = time.perf_counter() - t0
    print(f"fleet (15): {json.dumps({k: v for k, v in out.items() if k != 'journal'})} [{card}]")
    return out


def _fleet(card: str, root: str, device: str, trees: int | None) -> dict:
    out: dict = {}
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    entry = "score_forest/" if cuda else "score_forest_plain/"
    store, art = fleet_store(root, trees)
    F = len(art.feature_names)
    cpu_pack = pack_forest(art.forest, F)
    mem0 = _requested(dev)
    programs0 = program_counts(entry)
    t1 = time.perf_counter()
    fleet = ReplicaSet.from_store(store, ServeConfig(**FLEET_CONFIG), device=device)
    out["build_s"] = time.perf_counter() - t1
    server = make_async_server(fleet, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{server.port}"
    records: list = []
    answers: list = []  # (payload, status, body) of every /predict answered
    plans: list = []
    try:
        can = fleet.canary
        warm = sum(len(r._model.warm_buckets["shap"]) + len(r._model.warm_buckets["margin"])
                   for r in fleet.replicas)
        warm += len(can._canary_model.warm_buckets["shap"]) + len(can._canary_model.warm_buckets["margin"])
        if cuda and fused_score.launches != warm:
            raise AssertionError(f"15a: {fused_score.launches} startup launches, {warm} warm-up buckets")
        out["warmup_launches"] = warm
        mem1 = (_live_bytes(base), _requested(dev)) if cuda else (None, None)

        # 15a: four replicas on the one card, then traffic.
        status, _, ready = _call(base + "/readyz")
        devices = ready["replica_devices"]
        if (status != 200 or ready["replicas"] != FLEET_REPLICAS or len(set(devices)) != 1
                or (cuda and devices[0] != "cuda:0") or not fleet.supervisor.running
                or any(p["kernel"] != ("score_forest" if cuda else "plain") for p in ready["per_replica"])):
            raise AssertionError(f"15a: /readyz {status} {devices} {ready['supervisor']}")
        restores = [_record_margins(r._model, records) for r in fleet.replicas]
        batches0 = sum(r.batcher.batches for r in fleet.replicas)
        shadow0 = int(can._m_shadow.value)
        launches0 = fused_score.launches
        programs1 = program_counts(entry)
        payloads = request_rows(FLEET_REQUESTS, SEED + 500)
        t1 = time.perf_counter()
        for start in range(0, FLEET_REQUESTS, FLEET_BURST):
            chunk = payloads[start : start + FLEET_BURST]
            for p, (s, _, body) in zip(chunk, _burst(server.port, [json.dumps(p).encode() for p in chunk])):
                answers.append((p, s, body))
        out["predict_s"] = time.perf_counter() - t1
        Xb = seeded_rows(fleet.replicas[0]._model.pack, FLEET_BULK_ROWS, SEED + 501)
        lines = [",".join(f'"{n}"' for n in fleet.feature_names)]
        lines += [",".join("" if np.isnan(v) else repr(float(v)) for v in r) for r in Xb]
        bulk_csv = "\n".join(lines).encode()
        bulks = []
        t1 = time.perf_counter()
        for _ in range(FLEET_BULKS):
            bulks.append(_bulk_call(base, bulk_csv))
        out["bulk_s"] = time.perf_counter() - t1
        if not can.flush(timeout_s=60.0):
            raise AssertionError("15a: the canary's shadow queue did not drain")
        _sync(dev)
        routed = [int(fleet._m_routed.labels(replica=str(i)).value) for i in range(FLEET_REPLICAS)]
        batches = sum(r.batcher.batches for r in fleet.replicas) - batches0
        shadowed = int(can._m_shadow.value) - shadow0
        dispatched = sum(n for n, _ in program_delta(programs1, program_counts(entry)).values())
        launched = fused_score.launches - launches0
        chunks = FLEET_BULKS * -(-FLEET_BULK_ROWS // fleet.config.max_batch_rows)
        if (sum(routed) != FLEET_REQUESTS + FLEET_BULKS or min(routed) == 0
                or any(s != 200 for s, _, _ in bulks) or any(s != 200 for _, s, _ in answers)
                or dispatched != batches + chunks + shadowed
                or (cuda and launched != dispatched) or shadowed != FLEET_REQUESTS):
            raise AssertionError(f"15a: routed {routed}, {batches} micro-batches, {chunks} bulk chunks, "
                                 f"{shadowed} shadows, {dispatched} dispatches, {launched} launches")
        out["traffic"] = {"routed": routed, "microbatches": batches, "bulk_chunks": chunks,
                          "shadows": shadowed, "launches": launched, "dispatches": dispatched}
        # every margin bitwise the plain version's on the CPU
        for X, margin in records:
            ref = fused_score_reference(cpu_pack, X.cpu(), n_features=F, with_shap=False)[0]
            if not torch.equal(margin.cpu(), ref):
                raise AssertionError(f"15a: a launch of {X.shape[0]} rows differs from the plain margins")
        out["margin_launches_checked"] = len(records)
        del X, margin
        for restore in restores:
            restore()
        del restores, restore
        bulk_ref = fused_score_reference(cpu_pack, torch.from_numpy(Xb), n_features=F, with_shap=False)[1]
        bulk_err = max(float((torch.tensor([r["prob_default"] for r in b["predictions"]])
                              - bulk_ref).abs().max()) for _, _, b in bulks)
        records.clear()

        # 15b: replica 1's worker killed; the hedge rescues its rows.
        plan = ChaosPlan(seed=SEED, registry=fleet.registry).inject(fleet)
        plans.append(plan)
        plan.kill_worker(replica=1)
        restarts0 = fleet.replicas[1].batcher.stats()["worker_restarts"]
        chunk = request_rows(FLEET_BURST, SEED + 502)
        got = _burst(server.port, [json.dumps(p).encode() for p in chunk])
        answers += [(p, s, body) for p, (s, _, body) in zip(chunk, got)]
        hedged = int(fleet._m_hedges.labels(outcome="rescued").value)
        stats = fleet.replicas[1].batcher.stats()
        if (plan.events["kill"] != 1 or hedged < 1 or stats["worker_restarts"] != restarts0 + 1
                or not stats["worker_alive"] or any(s != 200 for s, _, _ in got)):
            raise AssertionError(f"15b: {plan.events}, {hedged} hedges, {stats}, "
                                 f"{[s for s, _, _ in got]}")
        plan.release()
        out["kill"] = {"hedges": hedged, "worker_restarts": stats["worker_restarts"]}

        # 15c: an error storm on replica 2, quarantined by its EWMA, healed.
        Xc = torch.from_numpy(seeded_rows(cpu_pack, 64, SEED + 503)).to(dev)
        old = fleet.replicas[2]
        old_margin = old._model.margin_fn(Xc)[0].clone()
        plan = ChaosPlan(seed=SEED + 1, registry=fleet.registry).inject(fleet)
        plans.append(plan)
        plan.error_storm(replica=2, rate=1.0)
        storm = 0
        while fleet.replica_health[2].state != QUARANTINED and storm < FLEET_STORM_BURSTS:
            chunk = request_rows(FLEET_STORM_BURST, SEED + 600 + storm)
            got = _burst(server.port, [json.dumps(p).encode() for p in chunk])
            answers += [(p, s, body) for p, (s, _, body) in zip(chunk, got)]
            storm += 1
        if fleet.replica_health[2].state != QUARANTINED or any(s != 200 for _, s, _ in answers):
            raise AssertionError(f"15c: after {storm} bursts replica 2 is {fleet.replica_health[2].state}")
        t1 = time.perf_counter()
        summary = fleet.supervisor.tick()
        out["heal_tick_s"] = time.perf_counter() - t1
        plan.release()
        new = fleet.replicas[2]
        new_margin = new._model.margin_fn(Xc)[0]
        if summary["healed"] != 1 or new is old or not torch.equal(new_margin, old_margin):
            raise AssertionError(f"15c: tick {summary}, rebuilt {new is not old}, margins equal "
                                 f"{torch.equal(new_margin, old_margin)}")
        del old, new, old_margin, new_margin, Xc
        summary = fleet.supervisor.tick()
        # (a replica whose killed batch failed several rows in 15b may still
        # be degraded: routable, its EWMA decaying with its successes)
        if (summary["probed"] != FLEET_REPLICAS or fleet.replica_health[2].state != HEALTHY
                or not all(h.routable for h in fleet.replica_health)):
            raise AssertionError(f"15c: after the heal {summary}, {[h.state for h in fleet.replica_health]}")
        _join_threads("replica-reaper-")
        mem2 = (_live_bytes(base), _requested(dev)) if cuda else (None, None)
        status, _, body = _call(base + "/events?component=supervisor")
        evs = [e for e in body["events"] if e["replica"] == 2]
        walk = [(e["kind"], e["payload"].get("to")) for e in evs]
        want = [("transition", "degraded"), ("transition", "quarantined"), ("transition", "restarting"),
                ("rebuild", None), ("swap", None), ("transition", "healthy")]
        chained = (evs[2]["cause_id"] == evs[1]["event_id"] == evs[3]["cause_id"]
                   and evs[4]["cause_id"] == evs[3]["event_id"] and evs[5]["cause_id"] == evs[4]["event_id"]
                   and evs[1]["cause"]["error_ewma"] >= fleet.config.supervisor_quarantine_ewma
                   and evs[3]["payload"]["outcome"] == "ok") if walk == want else False
        if status != 200 or walk != want or not chained:
            raise AssertionError(f"15c: /events {walk}, causes chained {chained}")
        out["storm"] = {"bursts": storm, "errors": plan.events["error"],
                        "hedges": int(fleet._m_hedges.labels(outcome="rescued").value),
                        "heal_s": fleet.supervisor._m_heal_s.labels(replica="2").value}

        # 15d: replica 3 hangs before its launch; the watchdog quarantines it.
        plan = ChaosPlan(seed=SEED + 2, registry=fleet.registry).inject(fleet)
        plans.append(plan)
        plan.hang_dispatch(replica=3, hang_s=60.0)
        chunk = request_rows(FLEET_BURST, SEED + 504)
        got = _burst(server.port, [json.dumps(p).encode() for p in chunk], timed=True)
        answers += [(p, s, body) for p, (s, _, body, _) in zip(chunk, got)]
        late = [sec for s, _, body, sec in got if s == 504 and sec > FLEET_DEADLINE_S + 1.0]
        typed = all(s == 200 or (s == 504 and body.get("error") == "deadline_exceeded")
                    for s, _, body, _ in got)
        ticks = []
        while fleet.replica_health[3].state != QUARANTINED and len(ticks) < 4:
            ticks.append(fleet.supervisor.tick())
            if fleet.replica_health[3].state != QUARANTINED:
                time.sleep(fleet.config.supervisor_queue_age_limit_s)
        reason = fleet.replica_health[3].reason or ""
        if (plan.events["hang"] != 1 or not typed or late or fleet.replica_health[3].state != QUARANTINED
                or not reason.startswith(("queue head stalled", "2 consecutive smoke probes"))):
            raise AssertionError(f"15d: answers {[s for s, _, _, _ in got]}, late {late}, ticks {ticks}, "
                                 f"replica 3 {fleet.replica_health[3].state} ({reason})")
        healed = fleet.supervisor.tick()
        plan.release()  # the wedged worker wakes; its rows expired, it launches nothing
        _join_threads("replica-reaper-")
        if (healed["healed"] != 1 or fleet.replica_health[3].state != HEALTHY
                or not all(h.routable for h in fleet.replica_health)):
            raise AssertionError(f"15d: heal tick {healed}")
        mem3 = (_live_bytes(base), _requested(dev)) if cuda else (None, None)
        out["hang"] = {"answers": sorted({s for s, _, _, _ in got}), "504": sum(s == 504 for s, _, _, _ in got),
                       "max_504_s": max([sec for s, _, _, sec in got if s == 504], default=0.0),
                       "ticks_to_quarantine": len(ticks), "reason": reason,
                       "heal_s": fleet.supervisor._m_heal_s.labels(replica="3").value}

        # 15e: the admin plane over HTTP.
        admin = [_call(base + "/admin/quarantine", json.dumps({"replica": i, "reason": "drill"}).encode())
                 for i in range(FLEET_REPLICAS)]
        admin.append(_call(base + "/admin/quarantine", json.dumps({"replica": 99}).encode()))
        routed0 = [int(fleet._m_routed.labels(replica=str(i)).value) for i in range(FLEET_REPLICAS)]
        lone = request_rows(1, SEED + 505)[0]
        lone_status, _, body = _call(base + "/predict", json.dumps(lone).encode())
        answers.append((lone, lone_status, body))
        routed1 = [int(fleet._m_routed.labels(replica=str(i)).value) for i in range(FLEET_REPLICAS)]
        manual_tick = fleet.supervisor.tick()
        admin += [_call(base + "/admin/readmit", json.dumps({"replica": i}).encode()) for i in range(3)]
        admin.append(_call(base + "/admin/readmit", json.dumps({"replica": 0}).encode()))
        codes = [(s, b.get("error")) for s, _, b in admin]
        if (codes != [(200, None)] * 3 + [(422, "invalid_input")] * 2 + [(200, None)] * 3
                + [(422, "invalid_input")] or "last routable" not in admin[3][2]["detail"]
                or [b - a for a, b in zip(routed0, routed1)] != [0, 0, 0, 1] or lone_status != 200
                or manual_tick["healed"] != 0):
            raise AssertionError(f"15e: {codes}, routed {routed0} -> {routed1}, tick {manual_tick}")
        out["admin"] = codes

        # 15f: the brownout ladder, rung by rung, then released.
        ladder = {}
        for level in range(1, 6):
            fleet.brownout.engage("chip_smoke drill")
            if level == 3:
                continue
            shadow0 = int(can._m_shadow.value)
            programs1 = program_counts(entry)
            chunk = request_rows(FLEET_BURST, SEED + 510 + level)
            got = _burst(server.port, [json.dumps(p).encode() for p in chunk])
            answers += [(p, s, body) for p, (s, _, body) in zip(chunk, got)]
            bulk = _bulk_call(base, bulk_csv) if level >= 4 else (None, {}, {})
            can.flush(timeout_s=60.0)
            moved = sorted(program_delta(programs1, program_counts(entry)))
            statuses = sorted({s for s, _, _ in got})
            degraded = all(b.get("degraded") is True and b.get("shap_values") is None for s, _, b in got
                           if s == 200)
            ladder[level] = {"statuses": statuses, "shadows": int(can._m_shadow.value) - shadow0,
                             "programs": moved, "bulk": bulk[0], "retry_after": bulk[1].get("Retry-After")}
            ok = ladder[level]["shadows"] == 0
            if level in (2, 4):
                ok = ok and statuses == [200] and degraded and all(m.endswith("/margin") for m in moved)
            if level == 4:
                ok = ok and bulk[0] == 429 and bulk[2].get("error") == "shed" and bulk[1].get("Retry-After")
            if level == 5:
                ok = ok and statuses == [429] and bulk[0] == 429 and not moved
                ok = ok and all(h.get("Retry-After") for _, h, _ in got)
            if level == 1:
                ok = ok and statuses == [200] and all(b["shap_values"] is not None for _, _, b in got)
            if not ok:
                raise AssertionError(f"15f: rung {level}: {ladder[level]}")
        while fleet.brownout.release("chip_smoke drill"):
            pass
        shadow0 = int(can._m_shadow.value)
        chunk = request_rows(FLEET_BURST, SEED + 520)
        got = _burst(server.port, [json.dumps(p).encode() for p in chunk])
        answers += [(p, s, body) for p, (s, _, body) in zip(chunk, got)]
        can.flush(timeout_s=60.0)
        steps = [(e["payload"]["direction"], e["payload"]["level"])
                 for e in _call(base + "/events?component=autoscaler")[2]["events"]]
        full = all(s == 200 and b["shap_values"] is not None and "degraded" not in b for s, _, b in got)
        if (not full or int(can._m_shadow.value) - shadow0 != FLEET_BURST
                or steps != [("engage", i) for i in range(1, 6)] + [("release", i) for i in range(4, -1, -1)]):
            raise AssertionError(f"15f: after the release full {full}, steps {steps}")
        out["brownout"] = ladder

        # Every answer: typed, and each 200 the plain version's on the CPU.
        untyped = sum(_untyped(s, b) for _, s, b in answers)
        served = [(p, b) for p, s, b in answers if s == 200]
        Xr = torch.tensor([[float(p[k]) for k in _request_keys()] for p, _ in served], dtype=torch.float32)
        ref_prob = fused_score_reference(cpu_pack, Xr, n_features=F, with_shap=False)[1]
        got_prob = torch.tensor([b["prob_default"] for _, b in served])
        full_rows = [i for i, (_, b) in enumerate(served) if b["shap_values"] is not None]
        shap_rows = full_rows[: FLEET_REQUESTS + FLEET_BURST]
        _, _, ref_phis, _ = fused_score_reference(cpu_pack, Xr[shap_rows], n_features=F)
        got_phis = torch.tensor([served[i][1]["shap_values"] for i in shap_rows])
        errors = {"prob": float((got_prob - ref_prob).abs().max()),
                  "phis": float((got_phis - ref_phis).abs().max()), "bulk_prob": bulk_err}
        if untyped or max(errors["prob"], errors["bulk_prob"]) > TOL_PROB or errors["phis"] > TOL_PHIS:
            raise AssertionError(f"15: {untyped} untyped errors, {errors}")
        out["answers"] = {"requests": len(answers), "served": len(served), "untyped": untyped,
                          "shap_checked": len(shap_rows)}
        out["errors"] = errors
        dispatched = sum(n for n, _ in program_delta(programs0, program_counts(entry)).values())
        if cuda and dispatched != fused_score.launches:
            raise AssertionError(f"15: {fused_score.launches} launches, {dispatched} program dispatches")
        out["dispatches"] = dispatched
        blocks = [_model_block_bytes(r._model) for r in fleet.replicas] if cuda else [0]
        out["model_block_bytes"] = blocks
        slack = max(blocks)
    finally:
        for plan in plans:
            plan.release()
        server.close()
        out["journal"] = fleet.events()  # for 20c's incident report
        t1 = time.perf_counter()
        fleet.close()
        out["close_s"] = time.perf_counter() - t1
    del fleet, server, can, records, answers, served, plans
    _join_threads("replica-")
    mem4 = _requested(dev)
    out["requested_bytes"] = {"before": mem0, "built": mem1[1], "after_storm_heal": mem2[1],
                              "after_hang_heal": mem3[1], "closed": mem4}
    out["device_mem_bytes"] = {"built": mem1[0], "after_storm_heal": mem2[0], "after_hang_heal": mem3[0]}
    # The bytes asked for are exact; the gauge counts the allocator's blocks
    # (a cached block reused unsplit counts more than was asked for), held
    # within one served model's blocks, as 12c and 14g hold it.
    if cuda and (not (mem1[1] == mem2[1] == mem3[1]) or mem4 != mem0
                 or max(abs(v - mem1[0]) for v in (mem2[0], mem3[0])) > slack):
        raise AssertionError(f"15g: requested bytes {out['requested_bytes']}, cobalt_device_mem_bytes "
                             f"{out['device_mem_bytes']} (slack {slack})")
    return out


#: Phase 16: the fleet's load control. Two replicas of the committed model on
#: the one card behind the HTTP server (its registry's ``latest`` channel),
#: the autoscaler on. Its loop, the history sampler and the supervisor start
#: with the server but never run on their own: the phase samples the history
#: and ticks the autoscaler by hand, on one held clock that the fleet and its
#: history share.
AUTOSCALER_CONFIG = dict(
    replicas=2,
    autoscaler_enabled=True,
    autoscaler_min_replicas=2,
    autoscaler_max_replicas=4,
    # the 2 ms coalescing window alone makes any burst busy
    autoscaler_queue_wait_high_ms=1.0,
    autoscaler_interval_s=3600.0,
    history_interval_s=3600.0,
    # one point per sample (the held clock steps 1 s); the finest ring spans
    # the queue-wait window (4 x history_interval_s), so the signal reads
    # each slice's own p95
    history_tiers=((1.0, 14_400), (60.0, 240)),
    supervisor_probe_interval_s=3600.0,
    canary_enabled=True,  # serve the registry's latest channel (no canary is published)
    score_cache_size=0,  # every request reaches a replica
    # room for 16a's bursts under the pause gate: 256 in flight per replica
    reliability=ReliabilityConfig(max_in_flight=256),
    # 16a's busy signal is the queue wait alone; 16b tightens the objectives
    slo_p99_ms=10_000.0,
    slo_p999_ms=10_000.0,
)
#: 16a's open-loop schedule, fired in slices with a sample and a tick after
#: each, from a pool of client threads.
AUTOSCALER_TRAFFIC = dict(base_rps=20.0, peak_rps=400.0, duration_s=6.0)
AUTOSCALER_SLICE_S = 0.5
AUTOSCALER_CLIENTS = 64
#: Rows per replica of 16a's two bursts under the pause gate, after the busy
#: retune: one 128-row and one 256-row SHAP launch on each replica.
AUTOSCALER_WIDE_ROWS = (80, 150)
#: 16b: the /predict burst before each burning tick, and the objectives'
#: latency (ms) every HTTP round trip misses.
AUTOSCALER_BURN_BURST = 32
AUTOSCALER_TIGHT_SLO_MS = 0.1
#: The held clock's step between samples, and its jump once load clears
#: (past the SLO engine's longest window and four history intervals).
AUTOSCALER_STEP_S = 1.0
AUTOSCALER_CLEAR_S = 4 * 3600.0 + 1.0
#: The dashboard panels 16c needs with a drawn line.
AUTOSCALER_PANELS = ("Latency quantiles (s)", "QPS (req/s)", "Queue depth", "Device / host memory (bytes)")


def _open_loop(base: str, arrivals: list, t0: float, pool: ThreadPoolExecutor) -> list[tuple]:
    """POST each arrival's payload to /predict at its time (``arrival.t -
    t0`` seconds after the call) from the pool; ``(payload, status, body)``
    each."""
    start = time.perf_counter()

    def fire(a) -> tuple:
        delay = a.t - t0 - (time.perf_counter() - start)
        if delay > 0:
            time.sleep(delay)
        status, _, body = _call(base + "/predict", json.dumps(a.payload).encode())
        return a.payload, status, body

    return list(pool.map(fire, arrivals))


def _paused_burst(fleet: ReplicaSet, port: int, bodies: list[bytes]) -> list[tuple]:
    """`_burst` with every replica's batcher held under its pause gate until
    all the requests are queued, so each replica's share goes out as one
    batch."""
    got: list = []
    with contextlib.ExitStack() as gates:
        for rep in fleet.replicas:
            gates.enter_context(rep.batcher.pause())
        sender = threading.Thread(target=lambda: got.extend(_burst(port, bodies)), daemon=True)
        sender.start()
        give_up = time.monotonic() + 60.0
        while sum(rep.batcher.queue_depth() for rep in fleet.replicas) < len(bodies):
            if time.monotonic() > give_up or not sender.is_alive():
                raise AssertionError("16a: the burst did not queue under the pause gate")
            time.sleep(0.005)
    sender.join(timeout=120)
    return got


def _knob_set(fleet: ReplicaSet) -> list[tuple]:
    """Each replica's coalescing window (ms) and batch rows."""
    return [(rep.batcher._max_wait_s * 1000.0, rep.batcher._max_rows) for rep in fleet.replicas]


def autoscaler_phase(card: str, device: str = "cuda", trees: int | None = None) -> dict:
    """Phase 16: the fleet's load control on the card, counted from 0 just
    before it. ``trees`` cuts the model for a CPU rehearsal."""
    fused_score.launches = 0
    t0 = time.perf_counter()
    logs = _LogLines()
    cobalt_log = logging.getLogger("cobalt")
    level = cobalt_log.level
    cobalt_log.setLevel(logging.INFO)
    cobalt_log.addHandler(logs)
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_autoscaler_") as root:
            out = _autoscaler(card, root, device, trees)
    finally:
        cobalt_log.removeHandler(logs)
        cobalt_log.setLevel(level)
    failed = [line for line in logs.lines if line.get("event") == "autoscaler_scale_up_failed"]
    if failed:
        raise AssertionError(f"16: scale-ups failed on the card: {failed}")
    out["launches"] = fused_score.launches
    out["phase_s"] = time.perf_counter() - t0
    if device == "cuda":  # after the count: these launches only time the kernel
        out["wide_buckets"] = wide_bucket_times(card)
    print(f"autoscaler (16): {json.dumps({k: v for k, v in out.items() if k != 'journal'})} [{card}]")
    return out


def wide_bucket_times(card: str) -> list[dict]:
    """The 128- and 256-row SHAP buckets the busy retune makes the batcher
    launch, on seeded rows of the committed model: kernel vs plain (margins
    bitwise, prob, SHAP), the kernel's ms per call (CUDA events after
    warm-up), the plain version's and the bound."""
    art = GBDTArtifact.load(ObjectStore(str(STORE)), MODEL_KEY, "cuda")
    F = len(art.feature_names)
    pack = pack_forest(art.forest, F)
    out = []
    for rows in (128, 256):
        X = torch.from_numpy(seeded_rows(pack, rows, SEED + 730 + rows)).cuda()
        err = compare(fused_score(pack, X, n_features=F), fused_score_reference(pack, X, n_features=F), True)
        ms = time_ms(lambda: fused_score(pack, X, n_features=F), reps=50)
        plain = time_ms(lambda: fused_score_reference(pack, X, n_features=F), reps=3, warmup=1)
        bound, by = bound_ms(pack, rows, True)
        out.append({"bucket": rows, "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by, **err})
        print(f"kernel score_forest bucket={rows} shap=True (16, the busy retune's bucket) ms={ms:.6f} "
              f"plain_ms={plain:.6f} bound_ms={bound:.6f} ({by}) err={err} [{card}]")
    return out


def _autoscaler(card: str, root: str, device: str, trees: int | None) -> dict:
    out: dict = {}
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    entry = "score_forest/" if cuda else "score_forest_plain/"
    kernel = "score_forest" if cuda else "plain"
    store = ObjectStore(root)
    art = GBDTArtifact.load(ObjectStore(str(STORE)), MODEL_KEY, "cpu")
    if trees is not None:
        art = _cut(art, trees)
    ModelRegistry(store).publish("gbdt", art, channel="latest")
    F = len(art.feature_names)
    cpu_pack = pack_forest(art.forest, F)
    keys = _request_keys()
    tenants = TenantPopulation(
        keys, [k for k, n in zip(keys, schema.SERVING_FEATURES) if n in schema.SERVING_INT_FEATURES],
        base_rows=request_rows(16, SEED + 700), seed=0,
    )
    schedule = TrafficGenerator(shape_by_name("flash_crowd", 0), tenants=tenants, seed=0,
                                mix={"single": 1.0}, **AUTOSCALER_TRAFFIC).schedule()
    clock = _HeldClock()
    clock.now = 1000.0  # whole seconds: cooldown arithmetic stays exact

    def step(s: float = AUTOSCALER_STEP_S) -> None:
        clock.now += s

    mem0 = _requested(dev)
    programs0 = program_counts(entry)
    t1 = time.perf_counter()
    fleet = ReplicaSet.from_store(store, ServeConfig(**AUTOSCALER_CONFIG), device=device, clock=clock)
    out["build_s"] = time.perf_counter() - t1
    # The history samples on the held clock too, so its queue-wait window
    # and the autoscaler's cooldowns read one time.
    fleet.history._clock = clock
    scaler = fleet.autoscaler
    server = make_async_server(fleet, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{server.port}"
    answers: list = []  # (payload, status, body) of every /predict answered
    records: list = []  # (rows, margins) of every launch while 16a runs
    ticks: list = []
    try:
        mem_built = _requested(dev)
        if (not scaler.running or not fleet.history._thread or len(fleet.replicas) != 2
                or any(r._model.kernel != kernel for r in fleet.replicas)):
            raise AssertionError("16: the fleet did not start its autoscaler and history on the card")
        restores = [_record_margins(r._model, records) for r in fleet.replicas]

        def tick(phase: str) -> dict:
            launches0 = fused_score.launches
            n0 = len(fleet.replicas)
            t2 = time.perf_counter()
            summary = scaler.tick()
            seconds = time.perf_counter() - t2
            ticks.append((phase, summary["actions"], round(seconds, 4),
                          summary["signals"]["queue_wait_p95_ms"], summary["signals"]["fast_burn"]))
            if "scale_up" in summary["actions"]:
                new = fleet.replicas[-1]
                warm = len(new._model.warm_buckets["shap"]) + len(new._model.warm_buckets["margin"])
                built = fused_score.launches - launches0
                if (len(fleet.replicas) != n0 + 1 or new.device != fleet.replicas[0].device
                        or (cuda and (new.device != torch.device("cuda", 0) or built != warm + 1))
                        or new._model.kernel != kernel):
                    raise AssertionError(f"{phase}: scale-up to {len(fleet.replicas)} on {new.device}, "
                                         f"{built} launches for {warm} warm-ups and the smoke row")
                out.setdefault("scale_up_s", []).append(seconds)
                out.setdefault("scale_up_launches", []).append(built)
                restores.append(_record_margins(new._model, records))
            return summary

        # 16a: the flash crowd, open loop, a sample and a tick after each slice.
        slices = int(math.ceil(AUTOSCALER_TRAFFIC["duration_s"] / AUTOSCALER_SLICE_S))
        wide = {}
        fleet.history.sample_once()  # the baseline the first slice's deltas count from
        t1 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=AUTOSCALER_CLIENTS) as pool:
            for k in range(slices):
                lo, hi = k * AUTOSCALER_SLICE_S, (k + 1) * AUTOSCALER_SLICE_S
                answers += _open_loop(base, [a for a in schedule if lo <= a.t < hi], lo, pool)
                step()
                fleet.history.sample_once()
                tick("16a")
                if k == 0:
                    # the busy retune is published: bursts now coalesce past 64 rows
                    cfg = fleet.config
                    busy = (cfg.autoscaler_busy_wait_ms, cfg.autoscaler_busy_max_rows)
                    if _knob_set(fleet) != [busy] * len(fleet.replicas):
                        raise AssertionError(f"16a: retune published {_knob_set(fleet)}, ticks {ticks}")
                    programs1 = program_counts(entry)
                    for rows in AUTOSCALER_WIDE_ROWS:
                        bodies = request_rows(rows * len(fleet.replicas), SEED + 710 + rows)
                        got = _paused_burst(fleet, server.port, [json.dumps(p).encode() for p in bodies])
                        answers += [(p, s, b) for p, (s, _, b) in zip(bodies, got)]
                    wide = {n: d for n, (d, _) in program_delta(programs1, program_counts(entry)).items()}
        out["flash_crowd"] = {"arrivals": len(schedule), "s": time.perf_counter() - t1}
        want = [["scale_up", "retune:busy"]] + [[]] * 4 + [["scale_up"]] + [[]] * (slices - 6)
        if [a for _, a, _, _, _ in ticks] != want or len(fleet.replicas) != 4:
            raise AssertionError(f"16a: ticks {ticks}, {len(fleet.replicas)} replicas")
        if any(qw is None or qw < fleet.config.autoscaler_queue_wait_high_ms or burn for _, _, _, qw, burn in ticks):
            raise AssertionError(f"16a: a tick read no queue-wait busy signal, or a burn: {ticks}")
        n_rep = 3  # the replicas the two bursts went to
        want_wide = {f"{entry}f32/128/shap": n_rep, f"{entry}f32/256/shap": n_rep}
        if {k: v for k, v in wide.items() if k in want_wide} != want_wide:
            raise AssertionError(f"16a: the wide bursts dispatched {wide}")
        out["wide_programs"] = wide
        routed = [int(fleet._m_routed.labels(replica=str(i)).value) for i in range(4)]
        if min(routed) == 0:
            raise AssertionError(f"16a: routed {routed}")
        out["routed"] = routed
        # every launch's margins bitwise the plain version's on the CPU, the
        # new replicas' and the 128/256-row ones included
        for restore in restores:
            restore()
        del restores, restore
        sizes = sorted({X.shape[0] for X, _ in records})
        for X, margin in records:
            ref = fused_score_reference(cpu_pack, X.cpu(), n_features=F, with_shap=False)[0]
            if not torch.equal(margin.cpu(), ref):
                raise AssertionError(f"16a: a launch of {X.shape[0]} rows differs from the plain margins")
        if 128 not in sizes or 256 not in sizes:
            raise AssertionError(f"16a: launches of {sizes} rows")
        out["margin_launches_checked"] = len(records)
        del X, margin
        records.clear()

        # 16b: objectives every round trip misses; at the ceiling the ladder
        # engages rungs 1-3, one per tick, then releases as the load clears.
        tight = dataclasses.replace(fleet.config, slo_p99_ms=AUTOSCALER_TIGHT_SLO_MS,
                                    slo_p999_ms=AUTOSCALER_TIGHT_SLO_MS)
        fleet.slo = SLOEngine(fleet.registry, default_objectives(tight), clock=clock,
                              windows_s=tight.slo_windows_s, fast_burn_threshold=tight.slo_fast_burn_threshold)
        n_ticks = len(ticks)
        for rung in range(1, 4):
            chunk = request_rows(AUTOSCALER_BURN_BURST, SEED + 720 + rung)
            got = _burst(server.port, [json.dumps(p).encode() for p in chunk])
            answers += [(p, s, b) for p, (s, _, b) in zip(chunk, got)]
            # the burst before the third tick runs at rung 2: no SHAP
            if all(b.get("degraded") is True for _, _, b in got) != (rung == 3):
                raise AssertionError(f"16b: the burst at rung {rung - 1} answered {got[0][2]}")
            step()
            fleet.history.sample_once()
            tick("16b")
        step(AUTOSCALER_CLEAR_S)
        fleet.history.sample_once()
        tick("16b")
        knobs_idle = _knob_set(fleet)
        for _ in range(5):
            step()
            tick("16b")
        step(fleet.config.autoscaler_scale_down_cooldown_s)
        for _ in range(4):
            step()
            tick("16b")
        rungs = ["brownout:no_canary", "brownout:no_shap", "brownout:wide_batch"]
        want = ([[r] for r in rungs] + [["brownout_release:no_shap", "retune:idle"],
                ["brownout_release:no_canary"], ["brownout_release:healthy"], [], [], ["scale_down"]]
                + [[], [], ["scale_down"], []])
        if [a for _, a, _, _, _ in ticks[n_ticks:]] != want or len(fleet.replicas) != 2:
            raise AssertionError(f"16b: ticks {ticks[n_ticks:]}, {len(fleet.replicas)} replicas")
        if knobs_idle != [(fleet.config.microbatch_max_wait_ms, fleet.config.microbatch_max_rows)] * 4:
            raise AssertionError(f"16b: the idle retune published {knobs_idle}")
        _join_threads("replica-retire-")
        mem_retired = _requested(dev)

        # 16c: the history, the dashboard, /readyz and the operator plane.
        series = "cobalt_request_latency_seconds:p99|route=/predict|status=200"
        s1, _, catalog = _call(base + "/history")
        s2, _, hist = _call(base + "/history?series=" + urllib.parse.quote(series))
        with urllib.request.urlopen(base + "/dashboard", timeout=60) as resp:
            s3, ctype, html = resp.status, resp.headers.get("Content-Type", ""), resp.read().decode()
        panels = {title: ("<polyline" in html.split(f"<h2>{title}</h2>", 1)[-1].split("</section>", 1)[0])
                  for title in AUTOSCALER_PANELS}
        wait_series = [n for n in catalog["series"]
                       if n.startswith("cobalt_microbatch_coalesce_wait_seconds:p95|replica=")]
        if (s1 != 200 or s2 != 200 or s3 != 200 or series not in catalog["series"] or len(hist["points"]) < 2
                or not ctype.startswith("text/html") or not all(panels.values()) or len(wait_series) < 4):
            raise AssertionError(f"16c: /history {s1} {s2} ({len(hist.get('points', []))} points), "
                                 f"/dashboard {s3} {panels}, queue-wait series {wait_series}")
        out["history"] = {"series": len(catalog["series"]), "p99_points": len(hist["points"]),
                          "tiers": catalog["tiers"]}
        if cuda:
            # Every registry publishes the process's device gauge, and the
            # merge sums gauges: the fleet series is (replicas + 1) x the
            # card's bytes, as in the reference; each replica's is the gauge.
            gauge = "cobalt_device_mem_bytes|device=cuda:0"
            last = [fleet.history.query(gauge + sfx)["points"][-1][1]
                    for sfx in ["", *(f"|replica={i}" for i in range(4))]]
            if len(set(last[1:])) != 1 or last[0] != 5 * last[1]:
                raise AssertionError(f"16c: device memory series {last}")
            out["device_mem_series"] = {"fleet": last[0], "per_replica": last[1]}
        status, _, ready = _call(base + "/readyz")
        block = ready["autoscaler"]
        if (status != 200 or not block["enabled"] or not block["running"] or block["replicas"] != 2
                or (block["min_replicas"], block["max_replicas"]) != (2, 4) or block["brownout"]["level"] != 0):
            raise AssertionError(f"16c: /readyz {status} {block}")

        def admin(body: dict) -> tuple:
            s, _, b = _call(base + "/admin/autoscaler", json.dumps(body).encode())
            return s, b

        plane = [admin({"action": "pause"})]
        paused_tick = scaler.tick()
        plane += [admin({"action": "resume"}), admin({"action": "status"})]
        launches0 = fused_score.launches
        plane.append(admin({"action": "force", "replicas": 3}))
        forced_launches = fused_score.launches - launches0
        plane += [admin({"action": "force", "replicas": 9}), admin({"action": "force", "replicas": 2})]
        codes = [(s, b.get("status") or b.get("error")) for s, b in plane]
        if (codes != [(200, "paused"), (200, "resumed"), (200, None), (200, "ok"), (422, "invalid_input"),
                      (200, "ok")] or paused_tick != {"status": "paused"} or plane[3][1]["steps"] != ["up"]
                or plane[5][1]["steps"] != ["down"] or len(fleet.replicas) != 2):
            raise AssertionError(f"16c: /admin/autoscaler {plane}, paused tick {paused_tick}")
        out["admin"] = codes
        out["forced_scale_up_launches"] = forced_launches
        _join_threads("replica-retire-")
        mem_forced = _requested(dev)
        status, _, body = _call(base + "/events?component=autoscaler&limit=1000")
        evs = body["events"]
        walk = [(e["kind"], e["payload"].get("direction") or e["payload"].get("profile"),
                 e["payload"].get("level")) for e in evs]
        want = ([("resize", "up", None), ("retune", "busy", None), ("resize", "up", None)]
                + [("brownout", "engage", i) for i in (1, 2, 3)]
                + [("brownout", "release", 2), ("retune", "idle", None), ("brownout", "release", 1),
                   ("brownout", "release", 0), ("resize", "down", None), ("resize", "down", None),
                   ("resize", "up", None), ("resize", "down", None)])
        _, _, adm = _call(base + "/events?component=admission&kind=rescale&limit=1000")
        ups = {e["event_id"] for e in evs if e["kind"] == "resize" and e["payload"]["direction"] == "up"}
        chained = {e["cause_id"] for e in adm["events"] if e["cause"].get("trigger") == "replica_added"}
        if (status != 200 or walk != want or not all(isinstance(e["cause"], dict) and e["cause"] for e in evs)
                or chained != ups or not all(e["cause"]["fast_burn"] for e in evs if e["payload"].get("direction") == "engage")):
            raise AssertionError(f"16c: /events {walk}, causes chained {chained} vs {ups}")
        out["events"] = len(evs)
        out["resizes"] = sum(kind == "resize" for kind, _, _ in walk)
        ok, _ = fleet.ready()
        if not ok:
            raise AssertionError("16c: the fleet is not ready at the end")
        dispatched = sum(n for n, _ in program_delta(programs0, program_counts(entry)).values())
    finally:
        server.close()
        out["journal"] = fleet.events()  # for 20c's incident report
        t1 = time.perf_counter()
        fleet.close()
        out["close_s"] = time.perf_counter() - t1
    del fleet, scaler, server, records
    _join_threads("replica-")
    mem_closed = _requested(dev)
    out["ticks"] = ticks
    out["requested_bytes"] = {"before": mem0, "built": mem_built, "retired": mem_retired,
                              "forced": mem_forced, "closed": mem_closed}
    if cuda and (not mem_built == mem_retired == mem_forced or mem_closed != mem0):
        raise AssertionError(f"16d: requested bytes {out['requested_bytes']}")

    # 16d: every answer typed, each 200 the plain version's; dispatches = launches.
    statuses = sorted({s for _, s, _ in answers})
    untyped = sum(_untyped(s, b) for _, s, b in answers)
    served = [(p, b) for p, s, b in answers if s == 200]
    pack = pack_forest(art.forest.to(dev), F)
    Xr = torch.tensor([[float(p[k]) for k in keys] for p, _ in served], dtype=torch.float32)
    errors = {"prob": 0.0, "phis": 0.0}
    for start in range(0, len(served), 256):
        X = Xr[start : start + 256].to(dev)
        _, prob, phis, _ = fused_score_reference(pack, X, n_features=F)
        chunk = served[start : start + 256]
        got = torch.tensor([b["prob_default"] for _, b in chunk])
        errors["prob"] = max(errors["prob"], float((got - prob.cpu()).abs().max()))
        rows = [i for i, (_, b) in enumerate(chunk) if b["shap_values"] is not None]
        if rows:
            got = torch.tensor([chunk[i][1]["shap_values"] for i in rows])
            errors["phis"] = max(errors["phis"], float((got - phis.cpu()[rows]).abs().max()))
    del pack, X, prob, phis
    shap_answers = sum(b["shap_values"] is not None for _, b in served)
    if statuses != [200] or untyped or errors["prob"] > TOL_PROB or errors["phis"] > TOL_PHIS:
        raise AssertionError(f"16d: statuses {statuses}, {untyped} untyped, errors {errors}")
    if cuda and dispatched != fused_score.launches:
        raise AssertionError(f"16d: {fused_score.launches} launches, {dispatched} program dispatches")
    out["answers"] = {"requests": len(answers), "served": len(served), "with_shap": shap_answers,
                      "untyped": untyped}
    out["errors"] = errors
    out["dispatches"] = dispatched
    return out


# -- the challenger model families (phase 17) -----------------------------------------

#: The reference's model benchmark setup (``tools/bench_models.py``): 262,144
#: loans (seed 13), the host cleaning path, the nn frame without the
#: leakage block, the hashed 80/20 split, NaN as 0.
CHALLENGER_ROWS = 262_144
CHALLENGER_SEED = 13
#: (a) logits card vs CPU on these test rows, the same weights.
CHALLENGER_CHECK_ROWS = 4096
TOL_CHALLENGER_LOGITS = 1e-4
#: (b) full-batch epochs on these rows from one state_dict, card vs CPU,
#: dropout 0: losses within 1e-5 relative; parameters within 1e-5 (the CPU
#: tests' tolerance against the JAX package), but where a gradient is noise
#: or flips, held within lr per update (Adam scales any gradient
#: difference to a step of up to lr): FT's key bias (softmax does not
#: depend on it, so its gradient is rounding noise) and all of TabNet (a
#: score at a row's sparsemax threshold enters the support on one device
#: and not on the other, which moves the attentive layer and, through the
#: mask, the feature transformers' weights on that column).

CHALLENGER_TRAIN_ROWS = 2048
CHALLENGER_TRAIN_EPOCHS = 3
TOL_CHALLENGER_LOSS = 1e-5
TOL_CHALLENGER_PARAMS = 1e-5
#: LogisticRegression has no epochs: its 25 Newton steps on the card and on
#: the CPU are held as the CPU tests hold it to the JAX package's (1e-4
#: absolute plus 1e-4 relative: the standardisation means of dollar columns
#: are ~1e5, where a float32 ulp is ~0.008).
TOL_CHALLENGER_LOGREG = 1e-4
#: (c) a floor that catches a broken model and claims no quality.
CHALLENGER_AUC_FLOOR = 0.90
#: FT-Transformer's epochs in the whole run, cut from its config's 20 for
#: time (at 20 it stopped early after 9, in 34.7 s); ``--only-challengers``
#: runs the config's.
CHALLENGER_FT_EPOCHS: int | None = 5
#: TabNet's epochs in the whole run, cut from its config's 30 for time (30
#: took 30.2 s, AUC 0.953 on the H100; 8, one dispatch of epochs, gave AUC
#: 0.963 on the CPU); ``--only-challengers`` runs the config's.
CHALLENGER_TABNET_EPOCHS: int | None = 8


def challenger_data(device: str = "cuda", n_rows: int = CHALLENGER_ROWS) -> dict:
    """The nn frame of the reference's model benchmark on ``device``: train
    and test matrices (NaN as 0), the label-code columns split off for
    FT-Transformer with vocabulary sizes ``len(vocab) + 1`` (code
    ``len(vocab)`` is missing)."""
    dev = torch.device(device)
    t0 = time.perf_counter()
    cleaned, _ = clean_raw_frame(synthetic_lendingclub_frame(n_rows, seed=CHALLENGER_SEED))
    _, nn, plan = engineer_features(prepare_cleaned_frame(cleaned, today=TODAY), device=dev)
    del cleaned
    nn = drop_training_leakage(nn)
    Xtr, Xte, ytr, yte = train_test_split_hashed(nn.X, nn.y)
    Xtr, Xte = torch.nan_to_num(Xtr, nan=0.0), torch.nan_to_num(Xte, nan=0.0)
    names = list(nn.feature_names)
    cat = [i for i, n in enumerate(names) if n in plan.categorical_vocab]
    num = [i for i in range(len(names)) if i not in cat]
    _sync(dev)
    return {
        "Xtr": Xtr, "Xte": Xte, "ytr": ytr, "yte": yte, "num": num, "cat": cat,
        "vocab": tuple(len(plan.categorical_vocab[names[i]]) + 1 for i in cat),
        "features": len(names), "prep_s": time.perf_counter() - t0,
    }


def _same_weights(family: str, data: dict, dropout: float | None = None):
    """One neural family's module at its config's widths with its seed-0
    initial weights, made on the CPU (``dropout`` overrides FT's)."""
    F, num, vocab = data["features"], data["num"], data["vocab"]
    gen = seeded_generator(0)
    if family == "mlp":
        cfg = MLPConfig()
        module = MLP(F, tuple(cfg.hidden_sizes), generator=gen)
    elif family == "ft_transformer":
        cfg = FTTransformerConfig()
        module = FTTransformer(len(num), vocab, d_token=cfg.d_token, n_blocks=cfg.n_blocks,
                               n_heads=cfg.n_heads, ffn_mult=cfg.ffn_mult,
                               dropout=cfg.dropout if dropout is None else dropout, generator=gen)
    else:
        cfg = TabNetConfig()
        module = TabNet(F, cfg.n_steps, cfg.width, cfg.gamma, generator=gen)
    return module


def _family_inputs(family: str, X: torch.Tensor, data: dict):
    """The module's inputs for rows ``X`` of the nn frame: min-max scaled
    (MLP), standardised numerics and clamped codes (FT), standardised
    (TabNet), with the training rows' statistics."""
    Xtr = data["Xtr"]
    if family == "mlp":
        return MinMaxStats.fit(Xtr)(X)
    if family == "tabnet":
        return StandardStats.fit(Xtr)(X)
    num, cat = data["num"], data["cat"]
    caps = torch.tensor(data["vocab"], device=X.device) - 1
    codes = torch.minimum(X[:, cat].long().clamp_min(0), caps)
    return StandardStats.fit(Xtr[:, num])(X[:, num]), codes


def _apply(family: str, module, lam: float = TabNetConfig.lambda_sparse):
    if family == "ft_transformer":
        return lambda b, gen: module(b[0], b[1], gen)
    if family == "tabnet":
        def tabnet(b, gen):
            logit, entropy, _ = module(b)
            return logit, lam * entropy

        return tabnet
    return lambda b, gen: module(b)


def _to(batch, dev):
    return tuple(t.to(dev) for t in batch) if isinstance(batch, tuple) else batch.to(dev)


def _settings(family: str, y: torch.Tensor) -> TrainSettings:
    """The family's training regime (as its classifier builds it: balanced
    class weights but for TabNet) in one batch of ``y``'s rows for
    ``CHALLENGER_TRAIN_EPOCHS`` epochs."""
    rows, n_pos = int(y.shape[0]), float(y.sum())
    pos_weight = 1.0 if family == "tabnet" else (rows - n_pos) / max(n_pos, 1.0)
    if family == "mlp":
        c = MLPConfig()
        kw = dict(learning_rate=c.learning_rate, lr_decay_rate=c.lr_decay_rate,
                  lr_decay_steps=c.lr_decay_steps, weight_decay=c.weight_decay, l2=c.l2)
    elif family == "ft_transformer":
        c = FTTransformerConfig()
        kw = dict(learning_rate=c.learning_rate, weight_decay=c.weight_decay)
    else:
        kw = dict(learning_rate=TabNetConfig().learning_rate)
    return TrainSettings(batch_size=rows, epochs=CHALLENGER_TRAIN_EPOCHS, pos_weight=pos_weight, **kw)


def challenger_card_vs_cpu(family: str, data: dict, device: str = "cuda") -> dict:
    """(a) and (b) of one neural family: logits of the same weights on the
    card and the CPU; then full-batch epochs from one state_dict on each
    (dropout 0), their losses and parameters."""
    dev = torch.device(device)
    out: dict = {}
    cpu_model = _same_weights(family, data).eval()
    card_model = copy.deepcopy(cpu_model).to(dev).eval()
    X = data["Xte"][:CHALLENGER_CHECK_ROWS]
    inputs = _family_inputs(family, X, data)
    with torch.no_grad():
        got = _apply(family, card_model)(_to(inputs, dev), None)
        want = torch.cat([  # the CPU in chunks: attention holds (rows, heads, tokens, tokens)
            _logits_of(_apply(family, cpu_model)(_to(_rows_of(inputs, s, s + 1024), "cpu"), None))
            for s in range(0, X.shape[0], 1024)])
    out["logits_max_abs_err"] = float((_logits_of(got).cpu() - want).abs().max())
    if out["logits_max_abs_err"] > TOL_CHALLENGER_LOGITS:
        raise AssertionError(f"17a {family}: card logits differ from the CPU's by "
                             f"{out['logits_max_abs_err']}")
    del got, want
    cpu_model = _same_weights(family, data, dropout=0.0)
    card_model = copy.deepcopy(cpu_model).to(dev)
    n = CHALLENGER_TRAIN_ROWS
    rows = _family_inputs(family, data["Xtr"][:n], data)
    y = data["ytr"][:n]
    settings = _settings(family, y)
    hist = {}
    for where, model in (("cpu", cpu_model), ("card", card_model)):
        d = dev if where == "card" else torch.device("cpu")
        hist[where] = fit_binary(model, _to(rows, d), y.to(d), settings, apply_fn=_apply(family, model))
    losses = np.array(hist["card"]["loss"]), np.array(hist["cpu"]["loss"])
    out["loss_max_rel_err"] = float(np.max(np.abs(losses[0] - losses[1]) / np.abs(losses[1])))
    errs = {}
    cpu_state = cpu_model.state_dict()
    for key, value in card_model.state_dict().items():
        errs[key] = float((value.cpu() - cpu_state[key]).abs().max())
    attentive = [k for k in errs if _attentive(family, k)]
    out["params_max_abs_err"] = max((v for k, v in errs.items() if k not in attentive), default=None)
    out["attentive_max_abs_err"] = max((errs[k] for k in attentive), default=None)
    out["largest_param_errs"] = dict(sorted(errs.items(), key=lambda kv: -kv[1])[:4])
    attentive_tol = settings.learning_rate * CHALLENGER_TRAIN_EPOCHS
    if (len(losses[0]) != CHALLENGER_TRAIN_EPOCHS or out["loss_max_rel_err"] > TOL_CHALLENGER_LOSS
            or (out["params_max_abs_err"] or 0.0) > TOL_CHALLENGER_PARAMS
            or any(errs[k] > attentive_tol for k in attentive)):
        raise AssertionError(f"17b {family}: card vs CPU training {out}, losses {losses}")
    return out


def _attentive(family: str, key: str) -> bool:
    """The parameters held within lr per update: FT's attention key bias,
    and every TabNet parameter (a support flip in an attentive transformer
    changes the masked inputs of the feature transformers too)."""
    if family == "ft_transformer":
        return key.endswith("attn.key.bias")
    return family == "tabnet"


def _logits_of(out):
    return out[0] if isinstance(out, tuple) else out


def _rows_of(batch, start: int, stop: int):
    return tuple(t[start:stop] for t in batch) if isinstance(batch, tuple) else batch[start:stop]


def _fit_record(family: str, model, fit_s: float, train_rows: int, data: dict, logits, card: str) -> dict:
    auc = float(roc_auc(data["yte"], logits))
    epochs = len(model.history["loss"]) if getattr(model, "history", None) else None
    out = {"fit_s": fit_s, "epochs_run": epochs, "train_rows": train_rows, "test_auc": auc,
           "rows_per_s": None if epochs is None else epochs * train_rows / fit_s}
    print(f"challenger {family} fit (17c): {json.dumps(out)} [{card}]", flush=True)
    if not auc >= CHALLENGER_AUC_FLOOR:
        raise AssertionError(f"17c {family}: held-out AUC {auc} under {CHALLENGER_AUC_FLOOR}")
    return out


def challenger_phase(card: str, device: str = "cuda", n_rows: int = CHALLENGER_ROWS,
                     ft_epochs: int | None = None, tabnet_epochs: int | None = None) -> dict:
    """Phase 17: the MLP, FT-Transformer, TabNet and logistic regression at
    their full widths on the reference's model benchmark data: (a) logits
    card vs CPU on the same weights, (b) card vs CPU training, (c) the fit
    on the full training rows (epochs, seconds, rows per second, held-out
    AUC at least 0.90), (d) two MLP fits of one seed bitwise equal."""
    dev = torch.device(device)
    t_phase = time.perf_counter()
    data = challenger_data(device, n_rows)
    out: dict = {"rows": n_rows, "features": data["features"], "train_rows": int(data["Xtr"].shape[0]),
                 "test_rows": int(data["Xte"].shape[0]), "vocab": list(data["vocab"]),
                 "prep_s": data["prep_s"]}
    Xtr, ytr, Xte = data["Xtr"], data["ytr"], data["Xte"]
    num, cat = data["num"], data["cat"]
    n_fit = int(Xtr.shape[0] - int(split_mask(int(Xtr.shape[0]), 0.1, 0, dev).sum()))

    def timed(fn):
        _sync(dev)
        t0 = time.perf_counter()
        result = fn()
        _sync(dev)
        return result, time.perf_counter() - t0

    for family in ("mlp", "ft_transformer", "tabnet"):
        out[family] = challenger_card_vs_cpu(family, data, device)
        print(f"challenger {family} card vs cpu (17a-b): {json.dumps(out[family])} [{card}]", flush=True)
    mlp, fit_s = timed(lambda: MLPClassifier(MLPConfig(), device=dev).fit(Xtr, ytr))
    out["mlp"]["fit"] = _fit_record("mlp", mlp, fit_s, n_fit, data, mlp.predict_logits(Xte), card)
    again, fit_s = timed(lambda: MLPClassifier(MLPConfig(), device=dev).fit(Xtr, ytr))
    same = again.history == mlp.history and all(
        torch.equal(a, b) for a, b in zip(mlp.module.state_dict().values(),
                                          again.module.state_dict().values()))
    out["mlp"]["second_fit_s"] = fit_s
    out["mlp"]["bitwise_reproducible"] = same
    if not same:
        raise AssertionError("17d: two MLP fits of one seed on the card differ")
    del mlp, again
    ft_cfg = FTTransformerConfig() if ft_epochs is None else FTTransformerConfig(epochs=ft_epochs)
    if ft_cfg.epochs != FTTransformerConfig.epochs:
        out["cut"] = {"ft_transformer_epochs": [ft_cfg.epochs, FTTransformerConfig.epochs]}
        print(f"challenger ft_transformer: {ft_cfg.epochs} epochs, cut from {FTTransformerConfig.epochs} "
              f"for time (--only-challengers runs {FTTransformerConfig.epochs}) [{card}]", flush=True)
    ft, fit_s = timed(lambda: FTTransformerClassifier(data["vocab"], ft_cfg, device=dev).fit(
        Xtr[:, num], Xtr[:, cat], ytr))
    out["ft_transformer"]["fit"] = _fit_record(
        "ft_transformer", ft, fit_s, n_fit, data, ft.predict_logits(Xte[:, num], Xte[:, cat]), card)
    out["ft_transformer"]["fit"]["epochs"] = ft_cfg.epochs
    del ft
    tab_cfg = TabNetConfig() if tabnet_epochs is None else TabNetConfig(epochs=tabnet_epochs)
    if tab_cfg.epochs != TabNetConfig.epochs:
        out.setdefault("cut", {})["tabnet_epochs"] = [tab_cfg.epochs, TabNetConfig.epochs]
        print(f"challenger tabnet: {tab_cfg.epochs} epochs, cut from {TabNetConfig.epochs} "
              f"for time (--only-challengers runs {TabNetConfig.epochs}) [{card}]", flush=True)
    tab, fit_s = timed(lambda: TabNetClassifier(tab_cfg, device=dev).fit(Xtr, ytr))
    out["tabnet"]["fit"] = _fit_record("tabnet", tab, fit_s, int(Xtr.shape[0]), data, tab.predict_logits(Xte), card)
    out["tabnet"]["fit"]["epochs"] = tab_cfg.epochs
    del tab
    lr, fit_s = timed(lambda: LogisticRegression(device=dev).fit(Xtr, ytr))
    cpu_lr = LogisticRegression(device="cpu")
    cpu_lr.params = LogisticRegressionParams(**{k: v.cpu() for k, v in lr.params.state_dict().items()})
    X = Xte[:CHALLENGER_CHECK_ROWS]
    logits_err = float((lr.decision_function(X).cpu() - cpu_lr.decision_function(X.cpu())).abs().max())
    n = CHALLENGER_TRAIN_ROWS
    small_card = LogisticRegression(device=dev).fit(Xtr[:n], ytr[:n])
    small_cpu = LogisticRegression(device="cpu").fit(Xtr[:n].cpu(), ytr[:n].cpu())
    fit_err = max(float(((a.cpu() - b).abs() / (1.0 + b.abs())).max()) for a, b in zip(
        small_card.params.state_dict().values(), small_cpu.params.state_dict().values()))
    out["logistic"] = {"logits_max_abs_err": logits_err, "params_max_err": fit_err}
    if logits_err > TOL_CHALLENGER_LOGITS or fit_err > TOL_CHALLENGER_LOGREG:
        raise AssertionError(f"17a/b logistic: card vs CPU {out['logistic']}")
    out["logistic"]["fit"] = _fit_record("logistic", lr, fit_s, int(Xtr.shape[0]), data,
                                         lr.decision_function(Xte), card)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"challengers (17): {json.dumps(out)} [{card}]")
    return out


PORTFOLIO_LOANS = 262_144
PORTFOLIO_SEED = 29
#: ``--only-portfolio``'s full book: the sweep again at the raw table's scale.
PORTFOLIO_FULL_LOANS = 2_300_000
PORTFOLIO_KEY = "portfolios/book.csv"
PORTFOLIO_CHUNK = 2048
#: The README's stress example: rate shocks on ``installment`` times a
#: ``loan_amnt`` haircut; with the baseline, 4 passes over the book.
PORTFOLIO_GRID = {"name": "readme", "axes": [
    {"feature": "installment", "op": "add", "values": [25.0, 50.0, 100.0]},
    {"feature": "loan_amnt", "op": "mul", "values": [0.9]}]}
PORTFOLIO_KILL_AFTER = 37
#: Rows of the two ``shap_bulk`` chunks at its 4096-row bucket.
PORTFOLIO_BULK_ROWS = 2 * 4096
PORTFOLIO_MIN_ATTRIBUTION = 0.8


def _chunk_arrays(store: ObjectStore, run_id: str) -> dict[str, dict]:
    prefix = f"scenario_runs/{run_id}/chunks/"
    return {k[len(prefix):]: store.load_arrays(k) for k in sorted(store.list(prefix)) if k.endswith(".npz")}


def _portfolio_counts(dev: torch.device) -> tuple[int, float, float, dict]:
    """Kernel launches, the engine's SHAP dispatches and their seconds, and
    the scoring programs' (dispatches, seconds)."""
    reg = default_registry()
    fam = reg.counter("cobalt_portfolio_dispatches_total", "", ("kind",))
    seconds = reg.histogram("cobalt_portfolio_dispatch_seconds", "", ("kind",))
    return (fused_score.launches, fam.labels("shap").value, seconds.labels("shap").sum,
            program_counts(_score_programs(dev)))


def _score_programs(dev: torch.device) -> str:
    """The scoring programs' name prefix: the kernel's on the card, the
    plain version's on the CPU (which counts no launch)."""
    return "score_forest/" if dev.type == "cuda" else "score_forest_plain/"


def _timed_advance(scorer: PortfolioScorer) -> list[float]:
    """Wrap the scorer's checkpoint ``advance`` to collect its seconds."""
    seconds: list[float] = []
    advance = scorer._ckpt.advance

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return advance(*args, **kwargs)
        finally:
            seconds.append(time.perf_counter() - t0)

    scorer._ckpt.advance = timed
    return seconds


def _bucket_vs_plain(pack, X: np.ndarray) -> tuple[dict, tuple]:
    """One SHAP launch over ``X`` (a full bucket) against the plain version
    on the card (margins bitwise, phis within ``TOL_PHIS``, additivity), its
    margins against the margin-only launch's bit for bit; the errors and
    the plain call's ms (one call, synchronised), and the plain output."""
    F = pack.n_features
    Xd = torch.from_numpy(np.ascontiguousarray(X)).to(pack.device)
    out = fused_score(pack, Xd, n_features=F, with_shap=True)
    margin_only = fused_score(pack, Xd, n_features=F, with_shap=False)[0]
    _sync(pack.device)
    t0 = time.perf_counter()
    plain = fused_score_reference(pack, Xd, n_features=F, with_shap=True)
    _sync(pack.device)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = compare(out, plain, True)
    if not torch.equal(out[0], margin_only):
        raise AssertionError(f"18c: the {X.shape[0]}-row SHAP launch's margins differ from the "
                             "margin-only launch's")
    return {**err, "plain_ms": plain_ms}, plain


def portfolio_sweep(store: ObjectStore, X: np.ndarray, run_id: str, dev: torch.device, **run) -> dict:
    """One `PortfolioScorer.from_registry` sweep of ``X`` under the README
    grid on ``dev``: its report, seconds, launches, dispatches and
    programs, and the seconds inside the checkpoint's ``advance``."""
    grid = ScenarioGrid.from_json(PORTFOLIO_GRID)
    scorer = PortfolioScorer.from_registry(store, chunk_rows=PORTFOLIO_CHUNK, device=dev)
    advance_s = _timed_advance(scorer)
    launches0, disp0, disp_s0, progs0 = _portfolio_counts(dev)
    t0 = time.perf_counter()
    try:
        report = scorer.run(X, grid, run_id=run_id, **run)
    except PortfolioInterrupted as exc:
        report = {"interrupted": exc.items_done}
    _sync(dev)
    wall_s = time.perf_counter() - t0
    launches1, disp1, disp_s1, progs1 = _portfolio_counts(dev)
    bucket = f"{_score_programs(dev)}f32/{PORTFOLIO_CHUNK}/shap"
    programs = program_delta(progs0, progs1)
    # The sweep's seconds: the chunks' dispatches (upload, launch, copies
    # back; the kernel's CUDA-event seconds inside them), the checkpoint's
    # advance, and the rest (the scenario's copy, the npz write, the reduce).
    out = {"report": report, "wall_s": wall_s, "launches": launches1 - launches0,
           "dispatches": int(disp1 - disp0), "programs": programs,
           "dispatch_s": disp_s1 - disp_s0, "kernel_s": programs.get(bucket, (0, 0.0))[1],
           "advance_s": sum(advance_s), "advances": len(advance_s),
           "last_advance_s": advance_s[-1] if advance_s else None}
    if dev.type != "cuda":
        out["launches"] = out["dispatches"]  # the plain version launches nothing
    if not (out["launches"] == out["dispatches"] == out["programs"].get(bucket, (0,))[0]
            and set(out["programs"]) == {bucket}):
        raise AssertionError(f"18 {run_id}: launches {out['launches']}, dispatches "
                             f"{out['dispatches']}, programs {out['programs']}")
    return out


def _ledger_value(doc: dict, family: str, kind: str) -> float:
    """A counter's value (a histogram's sum) at ``kind`` in a run ledger."""
    for sample in doc["metrics"].get(family, {}).get("samples", []):
        if sample["labels"].get("kind") == kind:
            return sample.get("value", sample.get("sum"))
    return 0.0


def portfolio_tool(root: str, n_chunks: int, ledger: str, dev: torch.device) -> dict:
    """18a: ``tools.score_portfolio`` through ``python -m`` on ``dev``, the
    uninterrupted sweep of the whole book under the README grid with
    ``--ledger-out``, then the port's ``tools.obs_report --min-attribution
    0.8`` on its ledger. Its launches are the ledger's program dispatches
    (the subprocess's own count), which must equal the engine's dispatches
    and the chunks."""
    grid = Path(root) / "grid.json"
    grid.write_text(json.dumps(PORTFOLIO_GRID))
    cmd = [sys.executable, "-m", "cobalt_smart_lender_ai_tpu_torch.tools.score_portfolio",
           "--store", root, "--portfolio", PORTFOLIO_KEY, "--scenarios", str(grid),
           "--run-id", "whole", "--ledger-out", ledger, "--device", dev.type]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    tool_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"18a: score_portfolio exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    # The report's command line, in this process (a second interpreter would
    # add its start-up to the phase and test nothing more).
    stdout, stderr = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr):
        rc = obs_report.main([ledger, "--min-attribution", str(PORTFOLIO_MIN_ATTRIBUTION)])
    doc = load_ledger(ledger)
    attribution = doc["dispatch_attribution"]
    if rc != 0 or "## Dispatch attribution" not in stdout.getvalue():
        raise AssertionError(f"18a: obs_report exited {rc} on the ledger "
                             f"{attribution}:\n{stderr.getvalue()[-2000:]}")
    programs = {p["name"]: p["dispatches"] for p in doc["programs"]}
    chunks = summary["chunks_scored"]
    dispatches = _ledger_value(doc, "cobalt_portfolio_dispatches_total", "shap")
    if not (programs == {f"{_score_programs(dev)}f32/{PORTFOLIO_CHUNK}/shap": chunks}
            and chunks == dispatches == 4 * n_chunks):
        raise AssertionError(f"18a: the ledger's programs {programs}, {dispatches} dispatches, "
                             f"{chunks} chunks scored of {4 * n_chunks}")
    programs_s = {p["name"]: p["dispatch_seconds"] for p in doc["programs"]}
    return {"tool_s": tool_s, "summary": summary, "attribution": attribution,
            "stages": doc["stages"], "launches": chunks,
            "dispatch_s": _ledger_value(doc, "cobalt_portfolio_dispatch_seconds", "shap"),
            "kernel_s": sum(programs_s.values())}


def portfolio_phase(card: str, device: str = "cuda", n_loans: int = PORTFOLIO_LOANS,
                    full_loans: int | None = None, trees: int | None = None) -> dict:
    """Phase 18: the offline portfolio stress path on the card (see the
    module docstring). On ``device="cpu"``, a rehearsal (``n_loans`` and
    the model's ``trees`` cut), the same checks but the launch counts and
    the times."""
    dev = torch.device(device)
    t_phase = time.perf_counter()
    out: dict = {"loans": n_loans}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_portfolio_") as root:
        store = ObjectStore(root)
        t0 = time.perf_counter()
        out["rows"] = build_synthetic_portfolio(store, PORTFOLIO_KEY, n_loans, PORTFOLIO_SEED, dev,
                                                today=TODAY)
        X, meta = load_portfolio(store, PORTFOLIO_KEY, schema.SERVING_FEATURES)
        if X.shape != (out["rows"], len(schema.SERVING_FEATURES)):
            raise AssertionError(f"18: the book reads back as {X.shape}")
        sketch = FeatureSketch.from_data(X, schema.SERVING_FEATURES, bins=10)
        art = GBDTArtifact.load(ObjectStore(str(STORE)), MODEL_KEY, dev)
        if trees is not None:
            art = _cut(art, trees)
        mv = ModelRegistry(store).publish("gbdt", art, channel="latest", provenance={
            "dataset": f"synthetic_lendingclub_frame(rows={n_loans}, seed={PORTFOLIO_SEED})",
            "feature_sketch": sketch.to_json()})
        out["book_s"] = time.perf_counter() - t0
        steps = out["steps_s"] = {"book": out["book_s"]}
        print(f"portfolio book (18): {n_loans} loans -> {out['rows']} rows after cleaning in "
              f"{out['book_s']:.1f}s [{card}]", flush=True)
        # (a) the uninterrupted sweep: the tool through python -m, and
        # obs_report's attribution gate on its ledger.
        n_chunks = math.ceil(out["rows"] / PORTFOLIO_CHUNK)
        t0 = time.perf_counter()
        tool = out["tool"] = portfolio_tool(root, n_chunks, str(Path(root) / "ledger.json"), dev)
        report = store.get_json(tool["summary"]["report_key"])
        if report["n_chunks"] != n_chunks or report["resume"]["chunks_scored"] != 4 * n_chunks:
            raise AssertionError(f"18a: {report['resume']} for {n_chunks} chunks x 4")
        if not all(np.isfinite(store.load_array(k)).all() for k in report["keys"]["scores"].values()):
            raise AssertionError("18a: non-finite scores")
        out["sweep"] = {"tool_s": tool["tool_s"], "launches": tool["launches"],
                        "dispatch_s": tool["dispatch_s"], "kernel_s": tool["kernel_s"],
                        "attribution": tool["attribution"]["ratio"], "stages": tool["stages"],
                        "rows_per_s": report["telemetry"]["rows_per_second"]}
        out["report"] = {
            "n_chunks": n_chunks, "padded_rows": report["padded_rows"],
            "baseline_mean_pd": report["baseline"]["mean_pd"], "band_counts": report["baseline"]["band_counts"],
            "scenarios": [{"id": b["id"], "mean_pd": b["mean_pd"], "downgraded": b["migration"]["downgraded"],
                           "ood": b["drift"]["ood_features"], "top": b["shap_top"][0]["feature"]}
                          for b in report["scenarios"]]}
        print(f"portfolio sweep (18a, the tool): {json.dumps(out['sweep'])} {json.dumps(out['report'])} "
              f"[{card}]", flush=True)
        steps["sweep"] = time.perf_counter() - t0
        # (b) killed after 37 chunks and resumed in this process, the
        # launches counted from 0: every chunk bitwise the tool's run's.
        t0 = time.perf_counter()
        fused_score.launches = 0
        killed = portfolio_sweep(store, X, "kill", dev, fail_after_chunks=PORTFOLIO_KILL_AFTER)
        resumed = portfolio_sweep(store, X, "kill", dev, resume=True)
        if (killed["report"] != {"interrupted": PORTFOLIO_KILL_AFTER}
                or resumed["report"]["resume"]["chunks_resumed"] != PORTFOLIO_KILL_AFTER
                or killed["launches"] + resumed["launches"] != 4 * n_chunks):
            raise AssertionError(f"18b: killed {killed['report']}, resumed {resumed['report']['resume']}")
        a, b = _chunk_arrays(store, "whole"), _chunk_arrays(store, "kill")
        if list(a) != list(b) or len(a) != 4 * n_chunks:
            raise AssertionError("18b: the resumed run's chunks are not the whole run's")
        for key in a:
            for name in ("scores", "phi_sum", "base", "n"):
                if not np.array_equal(a[key][name], b[key][name]):
                    raise AssertionError(f"18b: {key} {name} differs after the resume")
        swept = killed["launches"] + resumed["launches"]
        # The wrapper's count read after 18b (the plain version counts none).
        out["launches"] = fused_score.launches if dev.type == "cuda" else swept
        if out["launches"] != swept:
            raise AssertionError(f"18b: {out['launches']} launches, the sweeps' {swept}")
        out["resume"] = {"killed_launches": killed["launches"], "resumed_launches": resumed["launches"],
                         "wall_s": killed["wall_s"] + resumed["wall_s"],
                         "dispatch_s": killed["dispatch_s"] + resumed["dispatch_s"],
                         "kernel_s": killed["kernel_s"] + resumed["kernel_s"],
                         "advance_s": killed["advance_s"] + resumed["advance_s"],
                         "last_advance_s": resumed["last_advance_s"], "bitwise": True}
        print(f"portfolio kill and resume (18b): {json.dumps(out['resume'])} [{card}]", flush=True)
        steps["kill_resume"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        # (c) two chunks of each bucket against the plain version, on the card.
        scorer_pack = pack_forest(art.forest, len(schema.SERVING_FEATURES))
        n = PORTFOLIO_CHUNK
        checks = [_bucket_vs_plain(scorer_pack, X[i * n:(i + 1) * n])[0] for i in (0, n_chunks - 2)]
        service = ScorerService.from_store(store, ServeConfig(model_key=mv.key, microbatch_enabled=False),
                                           device=dev)
        try:
            rows = X[:PORTFOLIO_BULK_ROWS]
            prefix = _score_programs(dev)
            launches0, progs0 = fused_score.launches, program_counts(prefix)
            phis, base = service.shap_bulk(rows)
            _sync(dev)
            bulk_programs = program_delta(progs0, program_counts(prefix))
            bulk_dispatches = bulk_programs.get(f"{prefix}f32/4096/shap", (0,))[0]
            out["shap_bulk_launches"] = fused_score.launches - launches0 if dev.type == "cuda" else bulk_dispatches
            if out["shap_bulk_launches"] != 2 or bulk_dispatches != 2:
                raise AssertionError(f"18c: shap_bulk made {out['shap_bulk_launches']} launches {bulk_programs}")
            pack = service._model.pack
            bulk_checks = []
            for lo in (0, 4096):
                rec, ref = _bucket_vs_plain(pack, rows[lo:lo + 4096])
                bulk_checks.append(rec)
                err = float(np.abs(phis[lo:lo + 4096] - ref[2].cpu().numpy()).max())
                if err > TOL_PHIS or abs(base - float(ref[3])) > TOL_PHIS:
                    raise AssertionError(f"18c: shap_bulk's phis differ from the plain version's by {err}")
                bulk_checks[-1]["shap_bulk_phis"] = err
        finally:
            service.close()
        out["buckets"] = {}
        for bucket, recs in ((2048, checks), (4096, bulk_checks)):
            Xb = torch.from_numpy(np.ascontiguousarray(X[:bucket])).to(dev)
            ms = None
            if dev.type == "cuda":
                ms = time_ms(lambda: fused_score(scorer_pack, Xb, n_features=Xb.shape[1], with_shap=True), 10)
            bound, by = bound_ms(scorer_pack, bucket, True)
            out["buckets"][bucket] = {
                "ms": ms, "bound_ms": bound, "bound_by": by, "ms_over_bound": ms and ms / bound,
                "plain_ms": min(r["plain_ms"] for r in recs),
                "phis": max(r["phis"] for r in recs), "prob": max(r["prob"] for r in recs),
                "additivity": max(r["additivity"] for r in recs)}
            print(f"kernel score_forest bucket={bucket} shap=True (18c, portfolio) "
                  f"{json.dumps(out['buckets'][bucket])} [{card}]", flush=True)
        steps["checks"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if full_loans:
            out["full_book"] = portfolio_full_book(card, full_loans, dev)
    steps["rest"] = time.perf_counter() - t0  # 18e and removing the store
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"portfolio steps (18, s): {json.dumps(steps)} [{card}]", flush=True)
    return out


def portfolio_full_book(card: str, n_loans: int, dev: torch.device) -> dict:
    """``--only-portfolio``'s sweep at the raw table's scale: the book, the
    README grid, its seconds, rows per second and the seconds inside the
    checkpoint's ``advance`` (the manifest is rewritten whole after every
    chunk)."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_portfolio_full_") as root:
        store = ObjectStore(root)
        t0 = time.perf_counter()
        rows = build_synthetic_portfolio(store, PORTFOLIO_KEY, n_loans, PORTFOLIO_SEED, dev, today=TODAY)
        X, _ = load_portfolio(store, PORTFOLIO_KEY, schema.SERVING_FEATURES)
        art = GBDTArtifact.load(ObjectStore(str(STORE)), MODEL_KEY, dev)
        ModelRegistry(store).publish("gbdt", art, channel="latest", provenance={
            "feature_sketch": FeatureSketch.from_data(X, schema.SERVING_FEATURES, bins=10).to_json()})
        book_s = time.perf_counter() - t0
        sweep = portfolio_sweep(store, X, "full", dev)
        report = sweep["report"]
        manifest = store.get_bytes("checkpoints/portfolio/full.json")
        out = {"loans": n_loans, "rows": rows, "book_s": book_s, "n_chunks": report["n_chunks"],
               "launches": sweep["launches"], "wall_s": sweep["wall_s"],
               "rows_per_s": 4 * rows / sweep["wall_s"], "dispatch_s": sweep["dispatch_s"],
               "kernel_s": sweep["kernel_s"], "advance_s": sweep["advance_s"],
               "advances": sweep["advances"], "last_advance_s": sweep["last_advance_s"],
               "manifest_bytes": len(manifest), "stages": report["stages"]}
    print(f"portfolio full book (18e): {json.dumps(out)} [{card}]", flush=True)
    return out


# -- phase 19: the mesh, the card named four times ---------------------------------

#: The mesh's shards: the one card named this many times, each on its stream.
MESH_SHARDS = 4
#: 19a: the dp fit, cut from 300 trees for time; no row sample (a dp shard
#: draws its own), so its first tree is the single direct fit's.
MESH_TREES, MESH_DEPTH = 50, 7
MESH_LEVELS = (0, 4, 6)
TOL_MESH_AUC = 1e-4
#: 19b: one CV bucket of 2 candidates x 2 folds, 4 trees of depth 6 in
#: chunks of 2, on 5's 1.84M rows.
MESH_CV_TREES, MESH_CV_DEPTH, MESH_CV_CHUNK = 4, 6, 2
TOL_MESH_CV = 1e-4
#: 19c: rows a shard of one bulk SHAP dispatch.
MESH_SHAP_ROWS = 1024
#: 19d: rows of the bulk CSV.
MESH_BULK_ROWS = 5000
#: 19e: loans of the sharded ingest.
MESH_INGEST_ROWS = 100_000
#: 19f: the two processes' fit on 5's 1.84M rows at the main path's depth
#: (the exponent the shards agree on is set by all of them), 5 trees.
MESH_DIST_ROWS, MESH_DIST_TREES, MESH_DIST_DEPTH = N_TRAIN, 5, TRAIN_CONFIG["max_depth"]
MESH_WORKER_TIMEOUT_S = 180


@contextlib.contextmanager
def card_named(n: int):
    """`device.mesh_devices` lists the card ``n`` times while inside: the
    stand-in for a host with ``n`` cards (each entry one shard, on its own
    stream)."""
    saved = port_device.mesh_devices
    card = torch.device("cuda", torch.cuda.current_device())
    port_device.mesh_devices = lambda device="cuda": [card] * n
    try:
        yield [card] * n
    finally:
        port_device.mesh_devices = saved


def _direct_level_inputs(bins, y, hp, seed: int, depth: int, n_bins: int) -> dict[int, dict]:
    """The first tree's direct histogram inputs at `MESH_LEVELS`, as the
    single direct fit makes them."""
    calls: list[dict] = []

    def record(b, node, g, h, w, *, n_nodes, n_bins):
        calls.append(dict(node=node.clone(), g=g.clone(), h=h.clone(), w=w.clone(), K=n_nodes))
        return gradient_histogram_channels(b, node, g, h, w, n_nodes=n_nodes, n_bins=n_bins)

    N, F = bins.shape
    gbdt.fit_binned_resumable(bins, y, torch.ones(N, device=bins.device),
                              torch.ones(F, dtype=torch.bool, device=bins.device), hp, seed,
                              n_trees_cap=1, depth_cap=depth, n_bins=n_bins,
                              hist_subtract=False, histogram=record)
    return {level: calls[level] for level in MESH_LEVELS}


def sharded_histogram_records(bins: torch.Tensor, calls: dict[int, dict], mesh, n_bins: int) -> list[dict]:
    """19a's histogram levels: the sharded entry over the mesh's shards
    against one launch over all rows (bit for bit) and against its plain
    version (the shards' float64 partials summed: cover bit for bit, g and
    h within `TOL_HIST` of each node's largest |value|), the whole sharded
    call's and one shard's accumulate launch's ms beside the one launch's,
    the plain accumulate's (`histogram_partial_reference`), the library's
    (three ``torch.bincount``) and the bound at the shard's rows."""
    N = bins.shape[0]
    dp = mesh.row_shards(0, N)
    records = []
    for level, c in calls.items():
        K = c["K"]
        one_args = (bins, c["node"], c["g"], c["h"], c["w"])
        one = torch.stack(gradient_histogram_channels(*one_args, n_nodes=K, n_bins=n_bins))
        parts = [(bins[a:b], c["node"][None, a:b].contiguous(), c["g"][None, a:b].contiguous(),
                  c["h"][None, a:b].contiguous(), c["w"][None, a:b].contiguous())
                 for a, b in dp.bounds]
        kw = dict(n_nodes=K, n_bins=n_bins, n_rows=N, run=dp.run)
        got = torch.stack(gradient_histogram_sharded(parts, **kw))[:, 0]
        torch.cuda.synchronize()
        if not torch.equal(got, one):
            raise AssertionError(f"19a level {level}: the sharded entry differs from one launch")
        # The plain version of the same sharded call: each shard's float64
        # partials, summed, rounded once; cover bit for bit, g and h of each
        # node within TOL_HIST of its largest |value|, as in 5b.
        plain = sum(histogram_partial_reference(*p, n_nodes=K, n_bins=n_bins) for p in parts)
        plain = plain.to(torch.float32).reshape(got.shape)
        if not torch.equal(got[2], plain[2]):
            raise AssertionError(f"19a level {level}: the sharded cover differs from the plain version")
        err = 0.0
        for ch in (0, 1):
            node_err = (got[ch] - plain[ch]).abs().amax(dim=(1, 2))
            scale = plain[ch].abs().amax(dim=(1, 2))
            if bool((node_err > TOL_HIST * scale).any()):
                raise AssertionError(f"19a level {level}: channel {ch} off the plain version")
            err = max(err, float(node_err.max()))
        agreed = reduce_scale_states([histogram_scale_state(*p[2:]) for p in parts], bins.device)
        acc_kw = dict(n_nodes=K, n_bins=n_bins, scale_rows=N)
        shard = parts[0]
        b0, g0, h0, w0 = shard[0], shard[2][0], shard[3][0], shard[4][0]
        rec = {"level": level, "K": K, "shards": len(parts), "shard_rows": int(b0.shape[0]),
               "bit_equal": True, "max_abs_err": err,
               "one_launch_ms": time_ms(lambda: gradient_histogram_channels(*one_args, n_nodes=K,
                                                                           n_bins=n_bins), 20),
               "call_ms": time_ms(lambda: gradient_histogram_sharded(parts, **kw), 20),
               "ms": time_ms(lambda: histogram_accumulate(*shard, agreed, **acc_kw), 20),
               "plain_ms": time_ms(lambda: histogram_partial_reference(*shard, n_nodes=K,
                                                                        n_bins=n_bins), 3, warmup=1),
               "library_ms": time_ms(lambda: library_histogram(b0, shard[1][0], g0, h0, w0, K,
                                                               n_bins), 3, warmup=1)}
        rec["bound_ms"], rec["bound_by"] = histogram_bound_ms(b0, g0, h0, w0, K, n_bins)
        records.append(rec)
    return records


def mesh_fit_check(card: str, bins, y, X_test, y_test, spec) -> dict:
    """19a: `fit_binned_dp` over the card named `MESH_SHARDS` times against
    the single direct fit: the first tree's splits bit for bit, held-out
    AUC within `TOL_MESH_AUC`, the max |margin| difference; the launches of
    the main path (the dp fit, counted from 0): one accumulate launch a
    shard a level, one finalize a level, no one-launch histogram."""
    cfg = GBDTConfig(**{**TRAIN_CONFIG, "n_estimators": MESH_TREES, "max_depth": MESH_DEPTH,
                        "subsample": 1.0})
    hp = gbdt.GBDTHyperparams.from_config(cfg)
    kw = dict(n_trees_cap=MESH_TREES, depth_cap=MESH_DEPTH, n_bins=cfg.n_bins)
    mesh = make_mesh(MeshConfig(), devices=[torch.device("cuda")] * MESH_SHARDS)
    one = make_mesh(MeshConfig(), devices=[torch.device("cuda")])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single = fit_binned_dp(one, bins, y, None, None, hp, cfg.seed, hist_subtract=False, **kw)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    for counter in (gradient_histogram_channels, histogram_scale_state, histogram_accumulate,
                    histogram_finalize):
        counter.launches = 0
    t0 = time.perf_counter()
    dp_forest = fit_binned_dp(mesh, bins, y, None, None, hp, cfg.seed, **kw)
    torch.cuda.synchronize()
    dp_s = time.perf_counter() - t0
    launches = {"accumulate": histogram_accumulate.launches, "state": histogram_scale_state.launches,
                "finalize": histogram_finalize.launches, "one_launch": gradient_histogram_channels.launches}
    levels = MESH_TREES * MESH_DEPTH
    want = {"accumulate": MESH_SHARDS * levels, "state": MESH_SHARDS * levels, "finalize": levels,
            "one_launch": 0}
    if launches != want:
        raise AssertionError(f"19a: dp fit launches {launches}, expected {want}")
    for f in ("feature", "thr_bin", "missing_left"):
        if not torch.equal(getattr(dp_forest, f)[0], getattr(single, f)[0]):
            raise AssertionError(f"19a: the dp fit's first tree differs from the direct fit in {f}")
    same_trees = sum(
        all(torch.equal(getattr(dp_forest, f)[t], getattr(single, f)[t])
            for f in ("feature", "thr_bin", "missing_left"))
        for t in range(MESH_TREES)
    )
    f_dp = gbdt.attach_float_thresholds(dp_forest, spec)
    f_one = gbdt.attach_float_thresholds(single, spec)
    auc_dp, auc_one = held_out_auc(f_dp, X_test, y_test), held_out_auc(f_one, X_test, y_test)
    margin_diff = float((gbdt.predict_margin(f_dp, X_test) - gbdt.predict_margin(f_one, X_test)).abs().max())
    if abs(auc_dp - auc_one) > TOL_MESH_AUC:
        raise AssertionError(f"19a: dp AUC {auc_dp} vs direct {auc_one}")
    calls = _direct_level_inputs(bins, y, hp, cfg.seed, MESH_DEPTH, cfg.n_bins)
    return {"trees": MESH_TREES, "depth": MESH_DEPTH, "shards": MESH_SHARDS,
            "single_direct_s": single_s, "dp_s": dp_s, "launches": launches,
            "first_tree_equal": True, "trees_with_equal_splits": same_trees,
            "auc_dp": auc_dp, "auc_direct": auc_one, "auc_diff": abs(auc_dp - auc_one),
            "max_abs_margin_diff": margin_diff,
            "histogram": sharded_histogram_records(bins, calls, mesh, cfg.n_bins)}


def tune_cv(bins, y, hps, val, **kw) -> np.ndarray:
    """19b's CV bucket: `cross_validate_gbdt` of ``hps`` on the folds ``val``."""
    return cross_validate_gbdt(bins, y, hps, val, SEED, **kw)


def mesh_search_check(bins, y) -> dict:
    """19b: one CV bucket over a (2, 1) mesh (its jobs split over hp) bit
    for bit the single device's, and over a (2, 2) mesh (rows over dp too)
    within `TOL_MESH_CV` of the single device's direct fit."""
    base = GBDTConfig(**{**TRAIN_CONFIG, "n_estimators": MESH_CV_TREES, "max_depth": MESH_CV_DEPTH,
                         "subsample": 1.0})
    hps = [gbdt.GBDTHyperparams.from_config(base.replace(colsample_bytree=cs, learning_rate=lr))
           for cs, lr in ((0.8, 0.1), (1.0, 0.3))]
    val = torch.from_numpy(stratified_kfold_masks(y.cpu().numpy(), 2, SEED)).to(bins.device)
    kw = dict(n_bins=base.n_bins, chunk_trees=MESH_CV_CHUNK)
    cuda = torch.device("cuda")
    out = {"jobs": len(hps) * 2, "trees": MESH_CV_TREES, "depth": MESH_CV_DEPTH}
    t0 = time.perf_counter()
    single = tune_cv(bins, y, hps, val, **kw)
    out["single_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hp2 = tune_cv(bins, y, hps, val, mesh=make_mesh(MeshConfig(hp=2), devices=[cuda] * 2), **kw)
    out["hp_s"] = time.perf_counter() - t0
    if not np.array_equal(single, hp2):
        raise AssertionError(f"19b: the (2, 1) mesh's scores {hp2} differ from one device's {single}")
    direct = tune_cv(bins, y, hps, val, hist_subtract=False, **kw)
    t0 = time.perf_counter()
    m22 = tune_cv(bins, y, hps, val, mesh=make_mesh(MeshConfig(hp=2), devices=[cuda] * 4), **kw)
    out["hp_dp_s"] = time.perf_counter() - t0
    out["hp_dp_max_abs_diff"] = float(np.abs(m22 - direct).max())
    if out["hp_dp_max_abs_diff"] > TOL_MESH_CV:
        raise AssertionError(f"19b: the (2, 2) mesh's scores {m22} vs the direct fit's {direct}")
    out["hp_bitwise"] = True
    return out


def mesh_partitioner_check() -> dict:
    """19c: `MeshPartitioner` over the card named `MESH_SHARDS` times, bulk
    SHAP at `MESH_SHARDS` x `MESH_SHAP_ROWS` rows, bit for bit
    `SingleDevicePartitioner`'s at f32, bf16 and int8 (margins, prob, phis,
    base), one launch a shard a dispatch, on the mesh's program row."""
    art = GBDTArtifact.load(ObjectStore(str(STORE)), MODEL_KEY, "cuda")
    F = len(art.feature_names)
    rows = MESH_SHARDS * MESH_SHAP_ROWS
    single = SingleDevicePartitioner("cuda")
    mesh = MeshPartitioner([torch.device("cuda")] * MESH_SHARDS)
    out: dict = {"rows": rows, "shards": MESH_SHARDS}
    for precision in ("f32", *QUANTIZED):
        pack = pack_forest(art.forest, F, precision)
        X = torch.from_numpy(seeded_rows(pack, rows)).cuda()
        one_fn = single.compile_fused(pack, F, rows, with_shap=True)
        mesh_fn = mesh.compile_fused(pack, F, rows, with_shap=True)
        want = one_fn(X)
        before = fused_score.launches
        dispatches = 2
        got = [mesh_fn(X) for _ in range(dispatches)]
        torch.cuda.synchronize()
        launches = fused_score.launches - before
        if launches != MESH_SHARDS * dispatches:
            raise AssertionError(f"19c {precision}: {launches} launches for {dispatches} dispatches")
        for g in got:
            for k in range(3):
                if not torch.equal(g[k], want[k]):
                    raise AssertionError(f"19c {precision}: output {k} differs from one device's")
            if float(g[3]) != float(want[3]):
                raise AssertionError(f"19c {precision}: base differs")
        row = default_program_registry().table()
        name = f"score_forest/{precision}/{MESH_SHAP_ROWS}/shap/shards={MESH_SHARDS}"
        prog = next(r for r in row if r["name"] == name)
        out[precision] = {
            "launches": launches, "dispatches": dispatches, "bitwise": True,
            "program": name, "program_dispatches": prog["dispatches"], "program_shards": prog["shards"],
            "single_ms": time_ms(lambda: one_fn(X), 5),
            "mesh_ms": time_ms(lambda: mesh_fn(X), 5),
        }
    return out


def mesh_service_check(card_devices) -> dict:
    """19d: `ScorerService(bulk_shards=MESH_SHARDS)` over HTTP answers
    ``/predict_bulk_csv``: one launch a shard a chunk, its probabilities
    the one-device service's bit for bit, ``/readyz`` reporting the mesh."""
    store = ObjectStore(str(STORE))
    out = {}
    results = {}
    for shards in (1, MESH_SHARDS):
        service = ScorerService.from_store(store, ServeConfig(bulk_shards=shards), device="cuda")
        server = make_async_server(service, "127.0.0.1", 0)
        base = f"http://127.0.0.1:{server.port}"
        try:
            Xb = seeded_rows(service._model.pack, MESH_BULK_ROWS, SEED + 9)
            names = service.feature_names
            lines = [",".join(f'"{n}"' for n in names)]
            lines += [",".join("" if np.isnan(v) else repr(float(v)) for v in r) for r in Xb]
            before = fused_score.launches
            t0 = time.perf_counter()
            bulk = _post(base + "/predict_bulk_csv", "\n".join(lines).encode(), "text/csv")
            bulk_s = time.perf_counter() - t0
            launches = fused_score.launches - before
            ready = _get(base + "/readyz")
        finally:
            server.close()
            service.close()
        step = ServeConfig().max_batch_rows * shards
        chunks = -(-MESH_BULK_ROWS // step)
        if launches != shards * chunks:
            raise AssertionError(f"19d: {launches} launches for {chunks} chunks of {shards} shards")
        if ready["bulk"]["shards"] != shards:
            raise AssertionError(f"19d: /readyz reports {ready['bulk']}")
        results[shards] = [r["prob_default"] for r in bulk["predictions"]]
        out[f"shards_{shards}"] = {"launches": launches, "chunks": chunks, "bulk_s": bulk_s,
                                   "readyz_bulk": ready["bulk"]}
    if results[1] != results[MESH_SHARDS]:
        raise AssertionError("19d: the mesh service's bulk probabilities differ from one device's")
    out["bitwise"] = True
    return out


def mesh_ingest_check() -> dict:
    """19e: the device ingest with ``ingest_shards = MESH_SHARDS`` (its
    feature assembly and bin transform over the mesh) gives the one-device
    tables bit for bit."""
    tok = tokenize_raw_frame(synthetic_lendingclub_frame(MESH_INGEST_ROWS, seed=SEED), today=TODAY)
    t0 = time.perf_counter()
    one = run_device_ingest(tok, device="cuda")
    _sync(torch.device("cuda"))
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    four = run_device_ingest(tok, device="cuda", partitioner=make_partitioner(
        MESH_SHARDS, device="cuda"))
    _sync(torch.device("cuda"))
    four_s = time.perf_counter() - t0
    pairs = {"tree": (one.tree.X, four.tree.X), "nn": (one.nn.X, four.nn.X), "y": (one.tree.y, four.tree.y),
             "bins": (one.bins, four.bins), "edges": (one.bin_spec.edges, four.bin_spec.edges)}
    for name, (a, b) in pairs.items():
        if a.dtype.is_floating_point:
            same = torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
        else:
            same = torch.equal(a, b)
        if not same:
            raise AssertionError(f"19e: the sharded ingest's {name} differs from one device's")
    if one.plan != four.plan or one.tree.feature_names != four.tree.feature_names:
        raise AssertionError("19e: the sharded ingest's plan or names differ")
    return {"loans": MESH_INGEST_ROWS, "rows_out": int(one.tree.X.shape[0]), "one_s": one_s,
            "sharded_s": four_s, "bitwise": True}


def _mesh_dist_data():
    Xn, yn = training_rows(MESH_DIST_ROWS, seed=SEED + 19)
    X = torch.from_numpy(Xn).cuda()
    bins = transform(compute_bin_edges(X, 255), X)
    hp = gbdt.GBDTHyperparams.from_config(GBDTConfig(**{
        **TRAIN_CONFIG, "n_estimators": MESH_DIST_TREES, "max_depth": MESH_DIST_DEPTH}))
    return bins, torch.from_numpy(yn).cuda(), hp


def _mesh_dist_fit(mesh):
    bins, y, hp = _mesh_dist_data()
    return fit_binned_dp(mesh, bins, y, None, None, hp, SEED, n_trees_cap=MESH_DIST_TREES,
                         depth_cap=MESH_DIST_DEPTH, n_bins=255)


DIST_FIELDS = ("feature", "thr_bin", "missing_left", "gain", "cover", "leaf_value")


def mesh_worker(rank: int, port: int, out: str) -> int:
    """One of 19f's two processes on the card: the gloo bootstrap (NCCL
    takes one rank a card), an ``all_reduce`` of a card tensor, the global
    (1, 2) mesh and its dp fit; the forest goes to ``out``."""
    cfg = DistributedConfig(f"127.0.0.1:{port}", 2, rank)
    if not init_distributed(cfg, device="cuda", backend="gloo", timeout_s=MESH_WORKER_TIMEOUT_S):
        raise AssertionError("19f: no process group")
    t = torch.tensor([rank + 1.0], device="cuda")
    torch.distributed.all_reduce(t)
    mesh = make_global_mesh(MeshConfig(), devices=["cuda"])
    forest = _mesh_dist_fit(mesh)
    np.savez(out, all_reduce=t.cpu().numpy(), shape=np.asarray(list(mesh.shape.values())),
             **{f: getattr(forest, f).cpu().numpy() for f in DIST_FIELDS})
    torch.distributed.destroy_process_group()
    return 0


def mesh_distributed_check() -> dict:
    """19f: two processes on the card (this script with ``--mesh-worker``),
    gloo over card tensors: each holds one shard of a (1, 2) global mesh,
    and their dp fit equals the one-process fit over the card named twice,
    bit for bit. Each process has a time limit; one left alive is killed."""
    with socket_port() as port, tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        outs = [str(Path(tmp) / f"rank{r}.npz") for r in range(2)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--mesh-worker",
                                   str(r), str(port), outs[r]],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                 for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=MESH_WORKER_TIMEOUT_S)[0].decode(errors="replace"))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        workers_s = time.perf_counter() - t0
        if any(p.returncode != 0 for p in procs):
            raise AssertionError("19f: a worker failed:\n" + "\n".join(x[-3000:] for x in logs))
        docs = [np.load(o) for o in outs]
        want = _mesh_dist_fit(make_mesh(MeshConfig(), devices=[torch.device("cuda")] * 2))
        for doc in docs:
            if float(doc["all_reduce"][0]) != 3.0 or doc["shape"].tolist() != [1, 2]:
                raise AssertionError(f"19f: all_reduce {doc['all_reduce']}, mesh {doc['shape']}")
            for f in DIST_FIELDS:
                if not np.array_equal(doc[f], getattr(want, f).cpu().numpy()):
                    raise AssertionError(f"19f: the two-process fit's {f} differs from one process's")
    return {"processes": 2, "backend": "gloo", "tensors": "cuda", "rows": MESH_DIST_ROWS,
            "trees": MESH_DIST_TREES, "depth": MESH_DIST_DEPTH, "workers_s": workers_s, "bitwise": True}


@contextlib.contextmanager
def socket_port():
    """A free localhost port (closed again before the workers bind it)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    yield port


def mesh_phase(card: str) -> dict:
    """Phase 19: the mesh on the card named `MESH_SHARDS` times (19a-f)."""
    t_phase = time.perf_counter()
    cfg = GBDTConfig(**TRAIN_CONFIG)
    Xn, yn = training_rows(N_TRAIN + N_TEST)
    X_train = torch.from_numpy(Xn[:N_TRAIN]).cuda()
    y_train = torch.from_numpy(yn[:N_TRAIN]).cuda()
    X_test = torch.from_numpy(Xn[N_TRAIN:]).cuda()
    y_test = torch.from_numpy(yn[N_TRAIN:]).cuda()
    del Xn, yn
    spec = compute_bin_edges(X_train, cfg.n_bins)
    bins = transform(spec, X_train)
    del X_train
    out: dict = {}
    steps: dict[str, float] = {}
    t0 = time.perf_counter()
    out["fit"] = mesh_fit_check(card, bins, y_train, X_test, y_test, spec)
    steps["19a"] = time.perf_counter() - t0
    for r in out["fit"]["histogram"]:
        print(f"kernel gradient_histogram_sharded level {r['level']} (K={r['K']}, {r['shards']} shards "
              f"of {r['shard_rows']} rows) ms={r['ms']:.6f} call_ms={r['call_ms']:.6f} "
              f"one_launch_ms={r['one_launch_ms']:.6f} plain_ms={r['plain_ms']:.6f} "
              f"library_ms={r['library_ms']:.6f} bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) "
              f"max_abs_err={r['max_abs_err']:.3g} bit_equal={r['bit_equal']} [{card}]")
    t0 = time.perf_counter()
    out["search"] = mesh_search_check(bins, y_train)
    steps["19b"] = time.perf_counter() - t0
    del bins, y_train, X_test, y_test
    with card_named(MESH_SHARDS) as devs:
        t0 = time.perf_counter()
        out["partitioner"] = mesh_partitioner_check()
        steps["19c"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["service"] = mesh_service_check(devs)
        steps["19d"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["ingest"] = mesh_ingest_check()
        steps["19e"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["distributed"] = mesh_distributed_check()
    steps["19f"] = time.perf_counter() - t0
    out["steps_s"] = steps
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"mesh (19): {json.dumps(out)} [{card}]")
    return out


# -- phase 20: the operator's layer ----------------------------------------------------------

#: `tools.train_artifact`'s defaults, and what the committed artifact says of them.
ARTIFACT_ROWS = 130_000
ARTIFACT_TRAIN_ROWS = 101_311
ARTIFACT_AUC = 0.9347
TOL_ARTIFACT_AUC = 0.01
#: The column that counts days before the run's date: its bin edges move with it.
DATE_COLUMN = "earliest_cr_line_days"
#: 20b: the bulk CSV's rows, the rows sent back to /predict, the held admission slots.
UI_BULK_ROWS = 256
UI_ROW_PAYLOADS = 4
UI_ADMISSION_CAP = 8
TOL_WATERFALL = 1e-5
#: 20e: /predict micro-batches inside the profiler session: the warm-ups
#: (whose records a session may lose) first, then the measured ones.
PROFILE_WARMUPS = 8
PROFILE_BATCHES = 16
#: The three libraries the script builds at startup: two nvcc, one g++.
STARTUP_LIBRARIES = 3


def _edge_checks(got: np.ndarray, want: np.ndarray) -> dict:
    """Per-column agreement of two (F, B) bin-edge tables: the date-free
    columns log1p does not derive bit for bit, the date-free log1p columns
    within ``LOG_RTOL`` (torch's and XLA's float32 log1p differ by an ulp),
    and the date column's largest difference (it moves with the run's date)."""
    out = {"bitwise": [], "log_rtol": [], "date_max_abs_diff": None}
    for col, name in enumerate(schema.SERVING_FEATURES):
        a, b = got[col].astype(np.float64), want[col].astype(np.float64)
        if name == DATE_COLUMN:
            finite = np.isfinite(a) & np.isfinite(b)
            out["date_max_abs_diff"] = float(np.abs(a[finite] - b[finite]).max()) if finite.any() else 0.0
        elif name in schema.LOG_COLS:
            same_inf = np.array_equal(np.isfinite(a), np.isfinite(b)) and np.array_equal(a[~np.isfinite(a)], b[~np.isfinite(b)])
            finite = np.isfinite(a)
            if not same_inf or not np.all(np.abs(a[finite] - b[finite]) <= LOG_RTOL * np.abs(b[finite])):
                raise AssertionError(f"20a: {name}'s bin edges differ from the committed artifact's")
            out["log_rtol"].append(name)
        else:
            if got[col].tobytes() != want[col].tobytes():
                raise AssertionError(f"20a: {name}'s bin edges are not the committed artifact's bits")
            out["bitwise"].append(name)
    return out


def train_artifact_phase(card: str, root: str, device: str = "cuda", rows: int = ARTIFACT_ROWS) -> dict:
    """20a: ``tools.train_artifact.main`` at its defaults into a temporary
    store: 101,311 training rows, the committed artifact's bin edges (bit
    for bit in the date-free columns log1p does not derive), its test AUC
    within 0.01, and one histogram launch per tree level (300 x 7), equal to
    the program registry's dispatches. ``rows`` cuts it for a CPU rehearsal."""
    gradient_histogram_channels.launches = 0
    programs0 = program_counts("gradient_histogram/")
    t0 = time.perf_counter()
    run = train_artifact.main(["--rows", str(rows), "--out", root, "--device", device])
    wall = time.perf_counter() - t0
    launches = gradient_histogram_channels.launches
    dispatched = sum(n for n, _ in program_delta(programs0, program_counts("gradient_histogram/")).values())
    art = run["artifact"]
    header = json.loads(bytes(np.load(Path(root) / f"{MODEL_KEY}.npz")["__header__"]).decode())
    committed = json.loads(bytes(np.load(STORE / f"{MODEL_KEY}.npz")["__header__"]).decode())
    edges = _edge_checks(np.load(Path(root) / f"{MODEL_KEY}.npz")["bin_edges"],
                         np.load(STORE / f"{MODEL_KEY}.npz")["bin_edges"]) if rows == ARTIFACT_ROWS else None
    out = {
        "rows": rows,
        "train_rows": art.metrics["train_rows"],
        "test_auc": run["test_auc"],
        "committed_auc": committed["metrics"]["test_auc"],
        "launches": launches,
        "dispatches": dispatched,
        "host_prep_s": run["prep_s"],
        "fit_s": run["fit_s"],
        "tool_wall_s": run["wall_s"],
        "wall_s": wall,
        "edges": edges,
    }
    trees, depth = art.config["n_estimators"], art.config["max_depth"]
    if (list(header["config"]) != list(committed["config"]) or list(header["metrics"]) != list(committed["metrics"])
            or (device == "cuda" and not launches == dispatched == trees * depth)):
        raise AssertionError(f"20a: {out}, header {header['config']} {header['metrics']}")
    if rows == ARTIFACT_ROWS and (out["train_rows"] != ARTIFACT_TRAIN_ROWS
                                  or abs(out["test_auc"] - ARTIFACT_AUC) > TOL_ARTIFACT_AUC):
        raise AssertionError(f"20a: {out}")
    print(f"train_artifact (20a): {json.dumps(out)} [{card}]")
    return out


def _bulk_csv(rows: list[dict]) -> bytes:
    """``request_rows`` payloads as a CSV of the canonical feature names."""
    alias = {v: k for k, v in schema.SERVING_FIELD_ALIASES.items()}
    lines = [",".join(f'"{n}"' for n in schema.SERVING_FEATURES)]
    lines += [",".join(repr(r[alias.get(n, n)]) for n in schema.SERVING_FEATURES) for r in rows]
    return "\n".join(lines).encode()


def ui_phase(card: str, root: str, device: str = "cuda") -> tuple[dict, ScorerService, object]:
    """20b: the port's HTTP server serves 20a's artifact and `ui.core`'s
    client talks to it: the default form through `build_single_payload` to
    /predict, its waterfall's ``fx`` the response's base value plus its
    phis and the plain scorer's margin of the row within 1e-5; a 256-row
    bulk CSV through `coerce_results_frame`, 4 of its rows sent back
    through `results_row_payload` to /predict, each probability the bulk
    row's within 1e-6; the importances through `importance_series`, sorted;
    with the admission cap held, `ServiceDegraded` ``shed``. Returns the
    service and its server, open, for 20e."""
    store = ObjectStore(root)
    cfg = ServeConfig(reliability=ReliabilityConfig(max_in_flight=UI_ADMISSION_CAP))
    service = ScorerService.from_store(store, cfg, device=device)
    server = make_async_server(service, "127.0.0.1", 0)
    client = ui_core.ApiClient(f"http://127.0.0.1:{server.port}")
    cpu = GBDTArtifact.load(store, MODEL_KEY, "cpu")
    out: dict = {}
    numeric = {f: d for f, _, d in ui_core.NUMERIC_INPUTS}
    payload = ui_core.build_single_payload(numeric, {}, "No_Hardship")
    resp = client.predict(payload)
    wf = ui_core.build_waterfall(resp, max_display=10)
    row = torch.tensor([[float(payload[n]) for n in schema.SERVING_FEATURES]], dtype=torch.float32)
    margin = float(gbdt.predict_margin(cpu.forest, row)[0])
    out["waterfall"] = {"fx": wf.fx, "base_plus_phis": resp["base_value"] + sum(resp["shap_values"]),
                        "margin": margin, "bars": len(wf.items)}
    if (abs(wf.fx - out["waterfall"]["base_plus_phis"]) > TOL_WATERFALL
            or abs(wf.fx - margin) > TOL_WATERFALL or len(wf.items) != 10):
        raise AssertionError(f"20b: the waterfall {out['waterfall']}")
    rows = request_rows(UI_BULK_ROWS, SEED + 20)
    records = client.predict_bulk_csv("book.csv", _bulk_csv(rows))
    frame = ui_core.coerce_results_frame(records)
    if ui_core.frame_rows(frame) != UI_BULK_ROWS or frame["prob_default"].dtype != np.float64:
        raise AssertionError(f"20b: {ui_core.frame_rows(frame)} bulk rows")
    errs = []
    for idx in range(UI_ROW_PAYLOADS):
        back = client.predict(ui_core.results_row_payload(frame, idx))
        errs.append(abs(back["prob_default"] - frame["prob_default"][idx]))
    out["row_prob_max_abs_err"] = max(errs)
    if out["row_prob_max_abs_err"] > TOL_PROB:
        raise AssertionError(f"20b: row payloads' probabilities {errs}")
    imp = ui_core.importance_series(client.feature_importance_bulk(records))
    values = [v for _, v in imp]
    if not imp or values != sorted(values, reverse=True):
        raise AssertionError(f"20b: importances {imp}")
    out["importance_top"] = imp[0][0]
    sleeps: list[float] = []
    shed_client = ui_core.ApiClient(client.base_url, retries=2, sleep=sleeps.append)
    with contextlib.ExitStack() as held:
        for _ in range(UI_ADMISSION_CAP):
            held.enter_context(service.admission.admit())
        try:
            shed_client.predict(payload)
            raise AssertionError("20b: /predict scored past the admission cap")
        except ui_core.ServiceDegraded as e:
            out["shed"] = {"reason": e.reason, "retry_after_s": e.retry_after_s, "sleeps": sleeps}
    if out["shed"]["reason"] != "shed" or len(sleeps) != 1:
        raise AssertionError(f"20b: {out['shed']}")
    print(f"ui (20b): {json.dumps(out)} [{card}]")
    return out, service, server


def incident_phase(card: str, journal: list[dict], root: str) -> dict:
    """20c: ``tools.incident_report --require-cause`` over the journals
    phases 15 and 16 wrote, as a bench-shaped record: exit 0, at least one
    quarantine chain with its time to healthy and at least one resize."""
    bench, report = f"{root}/journal.json", f"{root}/incident.md"
    with open(bench, "w") as fh:
        json.dump({"events": {"journal": journal}}, fh)
    code = incident_report.main(["--bench", bench, "--require-cause", "--out", report])
    text = Path(report).read_text()
    fired = dict(re.findall(r"^\| (\S+) \| (\d+) \|$", text, flags=re.M))
    out = {
        "exit": code,
        "events": len(journal),
        "incidents": text.count("### Incident "),
        "healed_chains": text.count("- time to healthy: **"),
        "quarantines": sum((e["component"], e["kind"], (e.get("payload") or {}).get("to"))
                           == ("supervisor", "transition", "quarantined") for e in journal),
        "resizes": int(fired.get("autoscaler.resize", 0)),
        "orphans": int(re.search(r"orphans \(no cause, no cause_id\): (\d+)", text).group(1)),
    }
    if code != 0 or out["healed_chains"] < 1 or out["resizes"] < 1:
        raise AssertionError(f"20c: {out}\n{text[:4000]}")
    print(f"incident_report (20c): {json.dumps(out)} [{card}]")
    return out


def compile_phase(card: str, startup: dict, second: dict, second_of: str) -> dict:
    """20d: the build cache's counters. In this process after its startup
    builds, one of two states: fresh (3 misses, 3 builds, 0 hits: a
    checkout with nothing built) or warm (3 hits, 0 builds: ``_build/``
    holds all three, built by this host's compilers, as the key records).
    A mix fails: it would mean a library kept from elsewhere. In a second process
    (11c's training CLI, whose ledger is read; or under ``--only-tools`` the
    serve CLI's /metrics): nothing built, at least one hit, seconds saved."""
    hits, misses, builds = (int(startup[k]) for k in ("cache_hits", "cache_misses", "backend_compiles"))
    fresh = (misses, builds, hits) == (STARTUP_LIBRARIES, STARTUP_LIBRARIES, 0)
    warm = (hits, builds) == (STARTUP_LIBRARIES, 0)
    out = {"startup": startup, "startup_state": "fresh" if fresh else "warm",
           "second": second, "second_process": second_of}
    if not (fresh or warm):
        raise AssertionError(f"20d: this process's build counters {startup}")
    if second["backend_compiles"] != 0 or second["cache_hits"] < 1 or second["cache_saved_seconds"] <= 0:
        raise AssertionError(f"20d: the second process ({second_of}) {second}")
    print(f"compile cache (20d): {json.dumps(out)} [{card}]")
    return out


def _trace_events(log_dir: str) -> list[dict]:
    files = sorted(Path(log_dir).glob("*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"profile_trace wrote {files}")
    return json.loads(files[0].read_text())["traceEvents"]


def _trace_summary(events: list[dict]) -> dict:
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    return {
        "microbatch_spans": sum(e.get("name") == "serve.microbatch_dispatch" for e in events),
        "shap_kernel": sum("shap_kernel<7>" in k for k in kernels),
        "finalize_kernel": sum("score_finalize_kernel" in k for k in kernels),
        "device_records": len(kernels),
    }


def profile_phase(card: str, service: ScorerService, server, root: str, device: str = "cuda") -> dict:
    """20e: `debug.profile_trace` around 8 warm-up and 16 measured /predict
    micro-batches to 20b's service: the trace parses and holds the
    ``serve.microbatch_dispatch`` spans and the card's records of
    ``shap_kernel<7>`` and ``score_finalize_kernel``."""
    client = ui_core.ApiClient(f"http://127.0.0.1:{server.port}")
    rows = request_rows(PROFILE_WARMUPS + PROFILE_BATCHES, SEED + 21)
    t0 = time.perf_counter()
    with profile_trace(f"{root}/trace", device=device):
        for r in rows:
            client.predict(r)
        if device == "cuda":
            torch.cuda.synchronize()
    out = {"session_s": time.perf_counter() - t0, **_trace_summary(_trace_events(f"{root}/trace"))}
    if out["microbatch_spans"] < PROFILE_BATCHES or (
            device == "cuda" and (out["shap_kernel"] < 1 or out["finalize_kernel"] < 1)):
        raise AssertionError(f"20e: the trace holds {out}")
    print(f"profile_trace (20e): {json.dumps(out)} [{card}]")
    return out


def serve_cli_profile(card: str, root: str) -> dict:
    """Under ``--only-tools``: the serve CLI with ``--profile-dir`` in a
    subprocess on the card, 24 /predict, ``/metrics`` read (its
    ``cobalt_compile_*``: the second process's build counters), stopped
    with SIGINT: the trace it writes holds the micro-batch spans and the
    SHAP kernel."""
    import signal

    with socket_port() as port:
        pass
    trace = f"{root}/cli_trace"
    proc = subprocess.Popen(
        [sys.executable, "-m", "cobalt_smart_lender_ai_tpu_torch.serve", "--store", root, "--host",
         "127.0.0.1", "--port", str(port), "--profile-dir", trace],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 300
        while True:
            if proc.poll() is not None or time.monotonic() > deadline:
                raise AssertionError(f"the serve CLI did not start: {proc.communicate()[1][-4000:]}")
            try:
                if _call(base + "/healthz")[0] == 200:
                    break
            except OSError:
                time.sleep(0.5)
        client = ui_core.ApiClient(base)
        for r in request_rows(PROFILE_WARMUPS + PROFILE_BATCHES, SEED + 22):
            client.predict(r)
        fams = _scrape(base)
        proc.send_signal(signal.SIGINT)
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"the serve CLI exited {proc.returncode}: {err[-4000:]}")
    metric = {k: sum(fams.get(f, {}).get("samples", {}).values()) for k, f in (
        ("backend_compiles", "cobalt_compile_total"), ("cache_hits", "cobalt_compile_cache_hits_total"),
        ("cache_misses", "cobalt_compile_cache_misses_total"),
        ("cache_saved_seconds", "cobalt_compile_cache_saved_seconds_total"))}
    out = {"compile": metric, **_trace_summary(_trace_events(trace))}
    if out["microbatch_spans"] < PROFILE_BATCHES or out["shap_kernel"] < 1:
        raise AssertionError(f"20e (CLI): the trace holds {out}")
    print(f"serve CLI --profile-dir (20e): {json.dumps(out)} [{card}]")
    return out


def operator_phase(card: str, journal: list[dict], startup_compile: dict, cli: dict | None = None,
                   device: str = "cuda", rows: int = ARTIFACT_ROWS) -> dict:
    """Phase 20, the operator's layer: 20a-20e (20e last: a profiler
    session slows the launches after it). ``cli`` is 11c's result (its
    ledger's ``compile`` block); without it (``--only-tools``) the serve
    CLI runs in a subprocess with ``--profile-dir`` and its /metrics give
    the second process's counters."""
    t0 = time.perf_counter()
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_operator_") as root:
        out["train_artifact"] = train_artifact_phase(card, root, device, rows)
        fused_score.launches = 0
        programs0 = program_counts("score_forest/")
        ui, service, server = ui_phase(card, root, device)
        out["ui"] = ui
        try:
            out["ui_launches"] = fused_score.launches
            out["incident"] = incident_phase(card, journal, root)
            if cli is not None:
                second, second_of = {k: cli["compile"][k] for k in ("backend_compiles", "cache_hits",
                                     "cache_misses", "cache_saved_seconds")}, "11c's training CLI"
            else:
                out["serve_cli"] = serve_cli_profile(card, root)
                second, second_of = out["serve_cli"]["compile"], "the serve CLI"
            out["compile"] = compile_phase(card, startup_compile, second, second_of)
            out["profile"] = profile_phase(card, service, server, root, device)
        finally:
            server.close()
            service.close()
        out["launches"] = fused_score.launches
        dispatched = sum(n for n, _ in program_delta(programs0, program_counts("score_forest/")).values())
        if device == "cuda" and dispatched != out["launches"]:
            raise AssertionError(f"20b/20e: {out['launches']} launches, {dispatched} program dispatches")
        out["dispatches"] = dispatched
    out["phase_s"] = time.perf_counter() - t0
    print(f"operator phase (20): {out['phase_s']:.1f}s, train_artifact host prep "
          f"{out['train_artifact']['host_prep_s']:.1f}s, fit {out['train_artifact']['fit_s']:.1f}s, "
          f"wall {out['train_artifact']['wall_s']:.1f}s [{card}]")
    return out


def print_scoring_split(card: str) -> None:
    for precision in ("f32", *QUANTIZED):
        for r in scoring_split("cuda", precision):
            kernels = " ".join(f"{k}={r[k]:.6f}" for k in SCORE_KERNELS if k in r)
            print(f"split score_forest precision={precision} bucket={r['bucket']} "
                  f"shap={r['with_shap']} (device ms per call, {r['kept']} of "
                  f"{PROFILED_CALLS} calls kept) {kernels} [{card}]")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument(
        "--only-scoring",
        action="store_true",
        help="run phases 1-4, 9 and the scoring split only; print no ok line",
    )
    mode.add_argument(
        "--only-lifecycle",
        action="store_true",
        help="build, then run phase 14 (the continuous-training loop) only; print no ok line",
    )
    mode.add_argument(
        "--only-fleet",
        action="store_true",
        help="build, then run phase 15 (the serving fleet) only; print no ok line",
    )
    mode.add_argument(
        "--only-autoscaler",
        action="store_true",
        help="build, then run phase 16 (the fleet's load control) only; print no ok line",
    )
    mode.add_argument(
        "--only-challengers",
        action="store_true",
        help="run phase 17 (the challenger model families) only, FT-Transformer at its "
        "config's epochs; print no ok line",
    )
    mode.add_argument(
        "--only-portfolio",
        action="store_true",
        help="build, then run phase 18 (the portfolio stress path) and its sweep of the full "
        "book (2.3M loans); print no ok line",
    )
    mode.add_argument(
        "--only-search",
        action="store_true",
        help="build, then run 5b's joint launches and the reference-default (9, 100) search "
        "bucket's 15 jobs jointly and job by job; print no ok line",
    )
    mode.add_argument(
        "--only-mesh",
        action="store_true",
        help="build, then run phase 19 (the mesh: the card named four times) only; print no ok line",
    )
    mode.add_argument(
        "--only-tools",
        action="store_true",
        help="build, then run phases 15 and 16 (for their journals) and phase 20 (the operator's "
        "layer) with the serve CLI's --profile-dir in a subprocess; print no ok line",
    )
    mode.add_argument("--mesh-worker", nargs=3, metavar=("RANK", "PORT", "OUT"),
                      help=argparse.SUPPRESS)
    mode.add_argument(
        "--full-protocol",
        action="store_true",
        help="build, then run phase 8b with the reference's default RFE (104 -> 20 "
        "features at step 1) and 20 x 3 search; print no ok line",
    )
    args = parser.parse_args()
    # The training protocol's stage and progress lines, on stderr.
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    if args.mesh_worker:
        rank, port, out = args.mesh_worker
        return mesh_worker(int(rank), int(port), out)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain version in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    t_start = t0 = time.perf_counter()
    if args.only_challengers:
        challenger_phase(card)
        print(f"chip_smoke --only-challengers: {time.perf_counter() - t_start:.1f}s [{card}]")
        return 0
    kernels_built = ["score_forest", "gradient_histogram"]
    bootstrap_compile_cache()  # the build cache, and its counters, before the first build
    with ThreadPoolExecutor(max_workers=len(kernels_built) + 1) as pool:
        reader = pool.submit(native._build)  # g++, beside the nvcc builds
        list(pool.map(_build.build, kernels_built))  # one nvcc each, together
        reader.result()
    for name in kernels_built:
        _build.load(name)
    if not native.native_available():
        raise RuntimeError("the native csv reader does not load")
    print(f"build: {', '.join(k + '.cu' for k in kernels_built)}, csv_reader.cc in "
          f"{time.perf_counter() - t0:.1f}s (in parallel)")
    for name in kernels_built:
        print(_build.build_log.get(name, f"{name}: library was already built"), file=sys.stderr)
    startup_compile = compile_stats()
    print(f"build cache: {json.dumps(startup_compile)} [{card}]")

    if args.only_lifecycle:
        lifecycle_phase(card)
        print(f"chip_smoke --only-lifecycle: {time.perf_counter() - t_start:.1f}s [{card}]")
        return 0
    if args.only_fleet:
        fleet_phase(card)
        print(f"chip_smoke --only-fleet: {time.perf_counter() - t_start:.1f}s [{card}]")
        return 0
    if args.only_autoscaler:
        autoscaler = autoscaler_phase(card)
        print(f"autoscaler phase (16): {autoscaler['phase_s']:.1f}s, {autoscaler['launches']} launches, "
              f"{autoscaler['resizes']} resizes [{card}]")
        print(f"chip_smoke --only-autoscaler: {time.perf_counter() - t_start:.1f}s [{card}]")
        return 0

    if args.only_portfolio:
        portfolio = portfolio_phase(card, full_loans=PORTFOLIO_FULL_LOANS)
        print(f"portfolio phase (18): {portfolio['phase_s']:.1f}s, {portfolio['launches']} launches "
              f"[{card}]")
        print(f"chip_smoke --only-portfolio: {time.perf_counter() - t_start:.1f}s [{card}]")
        return 0

    if args.only_tools:
        fleet = fleet_phase(card)
        autoscaler = autoscaler_phase(card)
        operator_phase(card, fleet["journal"] + autoscaler["journal"], startup_compile)
        print(f"chip_smoke --only-tools: {time.perf_counter() - t_start:.1f}s [{card}]")
        return 0

    if args.only_mesh:
        mesh = mesh_phase(card)
        print(f"mesh phase (19): {mesh['phase_s']:.1f}s [{card}]")
        print(f"chip_smoke --only-mesh: {time.perf_counter() - t_start:.1f}s [{card}]")
        return 0

    if args.only_search:
        cfg = GBDTConfig(**TRAIN_CONFIG)
        Xn, yn = training_rows(N_TRAIN + N_TEST)
        X_train = torch.from_numpy(Xn[:N_TRAIN]).cuda()
        y_train = torch.from_numpy(yn[:N_TRAIN]).cuda()
        del Xn, yn
        _, bins = binning_phase(X_train, cfg.n_bins)
        del X_train
        _, jobs = job_axis_checks(card, bins, y_train, cfg.n_bins)
        search_phase(card, bins, y_train, jobs, cfg.n_bins)
        print(f"chip_smoke --only-search: {time.perf_counter() - t_start:.1f}s [{card}]")
        return 0

    if args.full_protocol:
        frame, generate_s = raw_table()
        print(f"raw table: {frame.n_rows} loans generated in {generate_s:.1f}s [{card}]")
        t0 = time.perf_counter()
        cfg = PipelineConfig()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_protocol_") as root:
            protocol, _, _, res, _ = protocol_phase(card, frame, cfg, protocol_rows(frame), root)
        observability_protocol(card, res, protocol.pop("observability"), cfg)
        print(f"full protocol phase: {time.perf_counter() - t0:.1f}s [{card}]")
        return 0

    records = kernel_phase("cuda")
    for r in records:
        print(f"kernel score_forest bucket={r['bucket']} shap={r['with_shap']} "
              f"ms={r['ms']:.6f} plain_ms={r['plain_ms']:.6f} "
              f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) "
              f"err={ {k: r[k] for k in ('prob', 'phis', 'additivity') if k in r} } "
              f"[{card}]")
    serving = serving_phase("cuda")
    print(f"serving: {json.dumps(serving)} [{card}]")
    observed = {"serving": observability_serving_phase(card, records)}
    quantized_records, quantized_serving = quantized_phase(card)
    if args.only_scoring:
        print_scoring_split(card)
        return 0
    hardening = hardening_phase(card)
    t0 = time.perf_counter()
    hist_records, training = training_phase(card)
    training["phase_s"] = time.perf_counter() - t0
    print(f"training: {json.dumps(training)} [{card}]")
    frame, generate_s = raw_table()
    print(f"raw table: {frame.n_rows} loans generated in {generate_s:.1f}s [{card}]")
    t0 = time.perf_counter()
    kept: dict = {}
    raw, raw_launches, train_rows = raw_path_phase(card, frame=frame, keep=kept)
    print(f"raw_path phase: {time.perf_counter() - t0:.1f}s [{card}]")
    # Phase 13a-b, on 6a's and 6b's frames.
    t13 = time.perf_counter()
    data_layer = {"host_path": host_path_card_checks(card),
                  "host_path_at_scale": host_path_at_scale(card, frame, raw, kept)}
    del kept
    phase13_s = time.perf_counter() - t13
    # Phase 8 runs before phase 7: a profiler session slows later launches.
    t0 = time.perf_counter()
    check = protocol_card_vs_cpu()
    print(f"protocol card_vs_cpu: {json.dumps(check)} [{card}]")
    quick = quick_config()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_protocol_") as root:
        protocol, protocol_launches, protocol_hist, res, payloads = protocol_phase(
            card, frame, quick, train_rows, root
        )
        observed["protocol"] = observability_protocol(card, res, protocol.pop("observability"), quick)
        del frame
        print(f"protocol phase: {time.perf_counter() - t0:.1f}s [{card}]")
        # Phase 10, on 8b's columns and store.
        t0 = time.perf_counter()
        halving = halving_phase(card, train_rows, quick, res)
        del train_rows
        resumed = resume_phase(card, root, quick, res, payloads)
        del res
        t13 = time.perf_counter()  # phase 13c, on 8b's store
        data_layer["native_reader"] = native_reader_phase(card, root, quick, resumed)
        phase13_s += time.perf_counter() - t13
    selection_card_vs_cpu(card, n_rows=SELECTION_CHECK_ROWS)
    print(f"halving and resume phase: {time.perf_counter() - t0:.1f}s [{card}]")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as root:
        observed["cli"] = observability_cli(card, root)
    observed["overhead"] = recording_overhead(card, training["fit_s"], training["hist_launches"])
    print(f"observability phase: {time.perf_counter() - t0:.1f}s [{card}]")
    t13 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pandas_ingest_") as root:
        data_layer["pandas_ingest"] = pandas_ingest_phase(card, root, observed["cli"])
    phase13_s += time.perf_counter() - t13
    print(f"data layer phase (13): {phase13_s:.1f}s [{card}]")
    lifecycle = lifecycle_phase(card)
    print(f"lifecycle phase (14): {lifecycle['phase_s']:.1f}s [{card}]")
    fleet = fleet_phase(card)
    print(f"fleet phase (15): {fleet['phase_s']:.1f}s, {fleet['launches']} launches [{card}]")
    autoscaler = autoscaler_phase(card)
    print(f"autoscaler phase (16): {autoscaler['phase_s']:.1f}s, {autoscaler['launches']} launches, "
          f"{autoscaler['resizes']} resizes [{card}]")
    challengers = challenger_phase(card, ft_epochs=CHALLENGER_FT_EPOCHS,
                                   tabnet_epochs=CHALLENGER_TABNET_EPOCHS)
    portfolio = portfolio_phase(card)
    print(f"portfolio phase (18): {portfolio['phase_s']:.1f}s, {portfolio['launches']} launches, "
          f"{portfolio['rows']} rows x 4 passes at {portfolio['sweep']['rows_per_s']:.0f} rows/s "
          f"[{card}]")
    mesh = mesh_phase(card)
    print(f"mesh phase (19): {mesh['phase_s']:.1f}s [{card}]")
    operator = operator_phase(card, fleet.pop("journal") + autoscaler.pop("journal"), startup_compile,
                              cli=observed["cli"])
    print_scoring_split(card)

    main_rec = next(r for r in records if r["bucket"] == 64)
    hist_main = next(r for r in hist_records if r["shape"] == "level 6 subtracted")
    job_records = training["job_axis"]
    joint_main = next(r for r in job_records if r["shape"].endswith(f"level {JOBS_LEVELS[-1]} subtracted"))
    sharded_main = next(r for r in mesh["fit"]["histogram"] if r["level"] == MESH_LEVELS[-1])
    kernels = [
        {
            "name": "score_forest",
            "route": "cuda",
            "source": "cobalt_smart_lender_ai_tpu_torch/csrc/score_forest.cu",
            "replaces": "cobalt_smart_lender_ai_tpu/ops/score_pallas.py:408",
            "launches": serving["launches"],
            "raw_path_launches": raw_launches["score_forest"],
            "protocol_launches": protocol_launches["score_forest"],
            "resume_launches": resumed["predict_raw"]["launches"],
            "precisions": ["f32", *QUANTIZED],
            "quantized_launches": quantized_serving["launches"],
            "hardening_launches": hardening["launches"],
            "pandas_ingest_launches": data_layer["pandas_ingest"]["predict_raw"]["launches"],
            "lifecycle_launches": lifecycle["launches"]["score_forest"],
            "fleet_launches": fleet["launches"],
            "autoscaler_launches": autoscaler["launches"],
            "portfolio_launches": portfolio["launches"],
            "portfolio_tool_launches": portfolio["tool"]["launches"],
            "shap_bulk_launches": portfolio["shap_bulk_launches"],
            "mesh_shap_launches": sum(mesh["partitioner"][p]["launches"] for p in ("f32", *QUANTIZED)),
            "mesh_bulk_launches": mesh["service"][f"shards_{MESH_SHARDS}"]["launches"],
            "operator_launches": operator["launches"],
            "portfolio_ms": {str(b): r["ms"] for b, r in portfolio["buckets"].items()},
            "portfolio_bound_ms": {str(b): r["bound_ms"] for b, r in portfolio["buckets"].items()},
            "max_abs_err": max(
                [max(r.get("prob", 0.0), r.get("phis", 0.0)) for r in records + quantized_records]
                + list(fleet["errors"].values()) + list(autoscaler["errors"].values())
                + [max(r["prob"], r["phis"]) for r in portfolio["buckets"].values()]
                + [operator["ui"]["row_prob_max_abs_err"]]
                + [lifecycle["shadow"]["prob_max_abs_err"], lifecycle["shadow"]["margin_max_abs_err"],
                   raw["serve"]["prob_max_abs_err"], raw["degraded"]["prob_max_abs_err"],
                   protocol["predict_raw"]["prob_max_abs_err"],
                   resumed["predict_raw"]["prob_max_abs_err"],
                   data_layer["pandas_ingest"]["predict_raw"]["prob_max_abs_err"],
                   quantized_serving["predict_prob"], quantized_serving["predict_phis"],
                   quantized_serving["bulk_prob"]]
            ),
            "ms": main_rec["ms"],
            "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"],
            "bound_by": main_rec["bound_by"],
            "library_ms": None,
        },
        {
            "name": "gradient_histogram",
            "route": "cuda",
            "source": "cobalt_smart_lender_ai_tpu_torch/csrc/gradient_histogram.cu",
            "replaces": "cobalt_smart_lender_ai_tpu/ops/hist_pallas.py:51",
            "launches": training["hist_launches"],
            "raw_path_launches": raw_launches["gradient_histogram"],
            "protocol_launches": protocol_launches["gradient_histogram"],
            "halving_launches": halving["halving_launches"],
            "exhaustive_launches": halving["exhaustive_launches"],
            "resume_launches": resumed["resume_launches"] + resumed["resume_after_invalidate_launches"],
            "pandas_ingest_launches": sum(data_layer["pandas_ingest"]["hist_launches"].values())
            + sum(data_layer["pandas_ingest"]["resume_hist_launches"].values()),
            "lifecycle_launches": lifecycle["launches"]["gradient_histogram"],
            "train_artifact_launches": operator["train_artifact"]["launches"],
            "protocol_joint_launches": protocol["joint_launches"],
            "halving_joint_launches": halving["halving_joint_launches"],
            "exhaustive_joint_launches": halving["exhaustive_joint_launches"],
            "joint": {k: joint_main[k] for k in ("shape", "J", "K", "active_rows", "bin_rows", "ms",
                                                  "singles_ms",
                                                  "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "max_abs_err": max(r["max_abs_err"] for r in hist_records + protocol_hist + job_records),
            "ms": hist_main["ms"],
            "plain_ms": hist_main["plain_ms"],
            "bound_ms": hist_main["bound_ms"],
            "bound_by": hist_main["bound_by"],
            "library_ms": hist_main["library_ms"],
        },
        {
            "name": "gradient_histogram_sharded",
            "route": "cuda",
            "source": "cobalt_smart_lender_ai_tpu_torch/csrc/gradient_histogram.cu",
            "replaces": "cobalt_smart_lender_ai_tpu/ops/hist_pallas.py:51",
            "launches": mesh["fit"]["launches"]["accumulate"],
            "state_launches": mesh["fit"]["launches"]["state"],
            "finalize_launches": mesh["fit"]["launches"]["finalize"],
            "shards": MESH_SHARDS,
            "levels": {str(r["level"]): {k: r[k] for k in ("K", "shard_rows", "ms", "call_ms",
                                                           "one_launch_ms", "plain_ms", "library_ms",
                                                           "bound_ms", "bound_by")}
                       for r in mesh["fit"]["histogram"]},
            "max_abs_err": max(r["max_abs_err"] for r in mesh["fit"]["histogram"]),
            "ms": sharded_main["ms"],
            "plain_ms": sharded_main["plain_ms"],
            "bound_ms": sharded_main["bound_ms"],
            "bound_by": sharded_main["bound_by"],
            "library_ms": sharded_main["library_ms"],
        },
    ]
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f}s in all, phase 17 (challengers) "
          f"{challengers['phase_s']:.1f}s, phase 18 (portfolio) {portfolio['phase_s']:.1f}s and "
          f"phase 20 (operator) {operator['phase_s']:.1f}s of it [{card}]")
    print(json.dumps({"kernels": kernels}))
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
